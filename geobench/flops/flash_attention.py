"""Operations and bytes of one causal flash-attention call at ``(B, T,
H, Dh)``: the kernel table's rules (``chip_smoke.py`` ``flash_costs``,
copied).  The products run over the ``T (T + 1) / 2`` visible pairs of
each (batch, head): two in the forward (``Q Kᵀ``, ``P V``), five in the
backward; each input byte is read once and each output byte written
once, with the f32 row statistics.
"""

from __future__ import annotations


def costs(B: int, T: int, H: int, Dh: int, itemsize: int = 2) -> dict:
    """``{"fwd": (ops, bytes), "bwd": (ops, bytes)}`` of one call."""
    n = B * T * H * Dh
    pairs = B * H * T * (T + 1) // 2
    rows = B * H * T * 4
    return {"fwd": (2 * 2 * Dh * pairs, 4 * n * itemsize + rows),
            "bwd": (5 * 2 * Dh * pairs, 8 * n * itemsize + rows)}
