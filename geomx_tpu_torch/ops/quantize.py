"""WAN codec kernels: 2-bit quantize with residual feedback, 2-bit
dequantize, and the fused DGC momentum update.

Each function here is a dispatcher: a CUDA tensor goes to a hand
kernel — 2-bit quantize and dequantize to the CUDA C++ kernels of
:mod:`geomx_tpu_torch.ops.kernels.quantize_cuda`, the DGC update to the
Triton kernel of :mod:`geomx_tpu_torch.ops.kernels.quantize_triton` —
and a CPU tensor to the plain PyTorch version beside it (``*_ref``).
There is no fallback between them: a CUDA tensor launches its kernel or
raises.

Two packings of the 2-bit codes exist, chosen by ``layout``:

- ``"strided"`` is the on-chip layout of the JAX package's Pallas kernel
  (``geomx_tpu/ops/quantize.py``, wire tag ``"2bit-tpu"``).  The input is
  padded to a multiple of 128×1024 elements; inside each block of 128
  rows of 1024 lanes, packed byte row ``j`` holds the codes of rows
  ``j``, ``j+32``, ``j+64`` and ``j+96`` (low bits first).  Its residual
  is ``r - where(pos, t, 0) + where(neg, t, 0)``, which turns a ``-0.0``
  residual into ``+0.0``.
- ``"consecutive"`` is the wire ``"2bit"`` frame of the host codecs
  (``compression/codecs.py``) and of the device codec stage: four
  consecutive codes per byte, low bits first, ``ceil(n/4)`` bytes.  Its
  residual keeps every untouched element's exact bits, ``-0.0``
  included.

Codes: 1 means ``+t``, 2 means ``-t``, 0 means zero.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from geomx_tpu_torch.ops.kernels import quantize_cuda, quantize_triton

LANES = 1024            # lanes of one row of the strided layout
QROWS = 128             # rows of one strided block
STRIDE_BLOCK = QROWS * LANES   # elements of one strided block
QUARTER = STRIDE_BLOCK // 4    # packed bytes of one strided block
LAYOUTS = ("strided", "consecutive")


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown 2-bit layout {layout!r} {LAYOUTS}")


def _f32(x: float) -> float:
    """A Python float holding exactly the f32 value of ``x``: every
    scalar the codecs apply is the f32 the JAX and numpy paths use."""
    return float(np.float32(x))


def strided_padded_len(n: int) -> int:
    """Elements after padding to whole strided blocks."""
    return -(-n // STRIDE_BLOCK) * STRIDE_BLOCK


def packed_len(n: int, layout: str) -> int:
    """Bytes of the packed codes of an ``n``-element tensor."""
    _check_layout(layout)
    if layout == "strided":
        return strided_padded_len(n) // 4
    return (n + 3) // 4


# ---- plain PyTorch versions (any device) ----------------------------------

def _pack4(q: torch.Tensor) -> torch.Tensor:
    """[..., 4, m] uint8 codes → [..., m] bytes, code i in bits 2i."""
    return (q[..., 0, :] | (q[..., 1, :] << 2) | (q[..., 2, :] << 4)
            | (q[..., 3, :] << 6))


def quantize_2bit_ref(grad: torch.Tensor, residual: torch.Tensor,
                      threshold: float = 0.5,
                      layout: str = "consecutive"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r += g``; code 1 where ``r > t``, 2 where ``r < -t``; the emitted
    ``±t`` leaves the residual.  Returns ``(packed uint8, new residual
    f32 [n])``; the inputs are not modified."""
    _check_layout(layout)
    t = _f32(threshold)
    n = grad.numel()
    r = residual.reshape(-1).float() + grad.reshape(-1).float()
    pos = r > t
    neg = r < -t
    q = torch.zeros(n, dtype=torch.uint8, device=r.device)
    q.masked_fill_(pos, 1)
    q.masked_fill_(neg, 2)
    if layout == "strided":
        zero = torch.zeros((), dtype=torch.float32, device=r.device)
        tt = torch.full((), t, dtype=torch.float32, device=r.device)
        newr = (r - torch.where(pos, tt, zero)) + torch.where(neg, tt, zero)
        pad = strided_padded_len(n)
        qp = torch.nn.functional.pad(q, (0, pad - n))
        packed = _pack4(qp.view(-1, 4, QUARTER)).reshape(-1)
    else:
        newr = torch.where(pos, r - t, torch.where(neg, r + t, r))
        qp = torch.nn.functional.pad(q, (0, (-n) % 4))
        packed = _pack4(qp.view(-1, 4).t())
    return packed, newr


def dequantize_2bit_ref(packed: torch.Tensor, n: int,
                        threshold: float = 0.5,
                        layout: str = "consecutive") -> torch.Tensor:
    """Codes back to ``{+t, -t, 0}`` as f32 ``[n]``."""
    if packed.numel() < packed_len(n, layout):
        raise ValueError(f"packed holds {packed.numel()} bytes, "
                         f"{packed_len(n, layout)} needed for {n} "
                         f"elements ({layout})")
    t = _f32(threshold)
    b = packed.reshape(-1).to(torch.uint8)
    codes = torch.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3])
    if layout == "strided":
        q = codes.view(4, -1, QUARTER).transpose(0, 1).reshape(-1)[:n]
    else:
        q = codes.t().reshape(-1)[:n]
    out = torch.zeros(n, dtype=torch.float32, device=b.device)
    out.masked_fill_(q == 1, t)
    out.masked_fill_(q == 2, -t)
    return out


def dgc_update_ref(velocity: torch.Tensor, accum: torch.Tensor,
                   grad: torch.Tensor, momentum: float = 0.9
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DGC momentum correction: ``v = m·v + g; u = u + v`` (two rounded
    operations, never one fused multiply-add).  Returns ``(v, u)``."""
    v = velocity.reshape(-1).float() * _f32(momentum) + grad.reshape(-1).float()
    return v, accum.reshape(-1).float() + v


# ---- dispatchers -----------------------------------------------------------

def _route(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "kernel"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no codec kernel for device {t.device}")


# The codec stage calls these once per key per party, where the host's
# share of a call is most of its cost: a CUDA tensor goes straight to the
# wrapper, which checks the layout and the tensors and passes the
# threshold through ctypes as an f32 (rounded as np.float32 rounds it).

def quantize_2bit(grad: torch.Tensor, residual: torch.Tensor,
                  threshold: float = 0.5, layout: str = "consecutive"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    if grad.is_cuda:
        return quantize_cuda.quantize_2bit(grad, residual, threshold, layout)
    _route(grad)
    return quantize_2bit_ref(grad, residual, threshold, layout)


def dequantize_2bit(packed: torch.Tensor, n: int, threshold: float = 0.5,
                    layout: str = "consecutive") -> torch.Tensor:
    if packed.is_cuda:
        return quantize_cuda.dequantize_2bit(packed, int(n), threshold,
                                             layout)
    _route(packed)
    return dequantize_2bit_ref(packed, n, threshold, layout)


def dgc_update(velocity: torch.Tensor, accum: torch.Tensor,
               grad: torch.Tensor, momentum: float = 0.9
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    if _route(grad) == "kernel":
        return quantize_triton.dgc_update(velocity, accum, grad,
                                          _f32(momentum))
    return dgc_update_ref(velocity, accum, grad, momentum)
