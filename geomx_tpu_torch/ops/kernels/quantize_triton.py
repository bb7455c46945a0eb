"""Triton kernels for the WAN codec stage on Hopper.

Three kernels, each a port of a Pallas kernel of the JAX package
(``geomx_tpu/ops/quantize.py``):

- ``_quant_kernel`` replaces ``_quant_kernel`` (``quantize.py:39``,
  reached through ``quantize_2bit_tpu``): ``r += g``, 2-bit codes, the
  emitted ``±t`` leaves the residual, four codes packed per byte;
- ``_dequant_kernel`` replaces ``_dequant_kernel`` (``quantize.py:105``,
  ``dequantize_2bit_tpu``): codes back to ``{+t, -t, 0}``;
- ``_dgc_kernel`` replaces ``_dgc_kernel`` (``quantize.py:147``,
  ``dgc_update_tpu``): ``v = m·v + g; u = u + v``.

What bounds them on an H100: memory bytes.  Each is one elementwise pass
with no reuse — quantize moves 12.25 bytes an element (read g and r,
write r, a quarter byte of codes), dequantize 4.25, DGC 20 — and does a
handful of f32 operations an element, far below the card's ~20
operations per byte break-even for f32 arithmetic.  The design therefore
only makes every byte move once: one program per 1024 packed bytes
(4096 elements), the four codes of one byte computed from a [bytes, 4]
tile in registers and OR-ed together with a row sum, so the packed byte
is written once and no intermediate goes back to device memory.  The
TPU's 128-row blocks and sublane packing do not carry over; the strided
layout survives only as an index map, so its packed bytes still match
the Pallas kernel bit for bit.  Tuning (vector widths, persistent
programs) is later work.

The layout is a ``tl.constexpr``: each layout compiles to its own
kernel.  ``triton`` is imported, and the kernels built, at the first
launch — never when this module is imported — so the CPU tests can
import it.  Each wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

BLOCK_BYTES = 1024   # packed bytes per program (4096 elements)
BLOCK_ELEMS = 4096   # elements per program of the DGC kernel

# launches per kernel, bumped only where a kernel is launched
LAUNCHES: Dict[str, int] = {"quantize_2bit": 0, "dequantize_2bit": 0,
                            "dgc_update": 0}
# guards the counters, the first build and each launch (a launch only
# enqueues, so holding it costs microseconds)
_mu = threading.Lock()
_kernels = None

KERNEL_CACHE = Path(__file__).resolve().parents[2] / ".kernel_cache"


def reset_launches() -> None:
    with _mu:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    with _mu:
        return dict(LAUNCHES)


def _build():
    """Define the @triton.jit kernels (compiled at their first launch,
    into ``TRITON_CACHE_DIR``, by default the package's
    ``.kernel_cache/``)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(KERNEL_CACHE))
    import triton
    import triton.language as tl

    @triton.jit
    def _quant_kernel(g_ptr, r_ptr, packed_ptr, r_out_ptr, n, n_bytes, t,
                      STRIDED: tl.constexpr, BLOCK_B: tl.constexpr):
        byte = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
        lane = tl.arange(0, 4)
        if STRIDED:
            # byte p of 128-row block b = p // 32768 holds rows j, j+32,
            # j+64, j+96 of that block: element b·131072 + lane·32768 +
            # (p mod 32768)
            elem = ((byte // 32768)[:, None] * 131072
                    + lane[None, :] * 32768 + (byte % 32768)[:, None])
        else:
            elem = byte[:, None] * 4 + lane[None, :]
        live = elem < n
        r = (tl.load(r_ptr + elem, mask=live, other=0.0)
             + tl.load(g_ptr + elem, mask=live, other=0.0))
        pos = r > t
        neg = r < -t
        q = tl.where(pos, 1, tl.where(neg, 2, 0))
        if STRIDED:
            # the Pallas form: an untouched -0.0 comes out +0.0
            newr = (r - tl.where(pos, t, 0.0)) + tl.where(neg, t, 0.0)
        else:
            # the wire codec's form: untouched elements keep their bits
            newr = tl.where(pos, r - t, tl.where(neg, r + t, r))
        tl.store(r_out_ptr + elem, newr, mask=live)
        packed = tl.sum(q << (lane[None, :] * 2), axis=1)
        tl.store(packed_ptr + byte, packed.to(tl.uint8), mask=byte < n_bytes)

    @triton.jit
    def _dequant_kernel(packed_ptr, out_ptr, n, n_bytes, t,
                        STRIDED: tl.constexpr, BLOCK_B: tl.constexpr):
        byte = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
        lane = tl.arange(0, 4)
        b = tl.load(packed_ptr + byte, mask=byte < n_bytes, other=0)
        q = (b.to(tl.int32)[:, None] >> (lane[None, :] * 2)) & 3
        val = tl.where(q == 1, t, tl.where(q == 2, -t, 0.0))
        if STRIDED:
            elem = ((byte // 32768)[:, None] * 131072
                    + lane[None, :] * 32768 + (byte % 32768)[:, None])
        else:
            elem = byte[:, None] * 4 + lane[None, :]
        tl.store(out_ptr + elem, val, mask=elem < n)

    @triton.jit
    def _dgc_kernel(v_ptr, u_ptr, g_ptr, v_out_ptr, u_out_ptr, n, m,
                    BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        live = offs < n
        v = (m * tl.load(v_ptr + offs, mask=live, other=0.0)
             + tl.load(g_ptr + offs, mask=live, other=0.0))
        tl.store(v_out_ptr + offs, v, mask=live)
        tl.store(u_out_ptr + offs,
                 tl.load(u_ptr + offs, mask=live, other=0.0) + v, mask=live)

    return triton, _quant_kernel, _dequant_kernel, _dgc_kernel


def _get():
    global _kernels
    if _kernels is None:
        with _mu:
            if _kernels is None:
                _kernels = _build()
    return _kernels


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int,
           device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
    if not t.is_contiguous() or t.dim() != 1:
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")


def _strided(layout: str) -> bool:
    if layout not in ("strided", "consecutive"):
        raise ValueError(f"unknown 2-bit layout {layout!r}")
    return layout == "strided"


def _packed_len(n: int, strided: bool) -> int:
    if strided:
        return -(-n // 131072) * 131072 // 4
    return (n + 3) // 4


def quantize_2bit(grad: torch.Tensor, residual: torch.Tensor,
                  threshold: float, layout: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the 2-bit quantize kernel: returns ``(packed uint8, new
    residual f32 [n])`` in ``layout`` (``strided``|``consecutive``)."""
    strided = _strided(layout)
    n = grad.numel()
    _check("grad", grad, torch.float32, n, grad.device)
    _check("residual", residual, torch.float32, n, grad.device)
    n_bytes = _packed_len(n, strided)
    packed = torch.empty(n_bytes, dtype=torch.uint8, device=grad.device)
    new_r = torch.empty_like(residual)
    if n_bytes == 0:
        return packed, new_r
    triton, quant, _, _ = _get()
    grid = (triton.cdiv(n_bytes, BLOCK_BYTES),)
    with _mu:  # server lanes launch from several threads
        quant[grid](grad, residual, packed, new_r, n, n_bytes, threshold,
                    STRIDED=strided, BLOCK_B=BLOCK_BYTES)
        LAUNCHES["quantize_2bit"] += 1
    return packed, new_r


def dequantize_2bit(packed: torch.Tensor, n: int, threshold: float,
                    layout: str) -> torch.Tensor:
    """Launch the 2-bit dequantize kernel: f32 ``[n]``."""
    strided = _strided(layout)
    need = _packed_len(n, strided)
    if packed.numel() < need:
        raise ValueError(f"packed holds {packed.numel()} bytes, "
                         f"{need} needed for {n} elements ({layout})")
    _check("packed", packed, torch.uint8, packed.numel(), packed.device)
    out = torch.empty(n, dtype=torch.float32, device=packed.device)
    if n == 0:
        return out
    triton, _, dequant, _ = _get()
    grid = (triton.cdiv(need, BLOCK_BYTES),)
    with _mu:
        dequant[grid](packed, out, n, need, threshold,
                      STRIDED=strided, BLOCK_B=BLOCK_BYTES)
        LAUNCHES["dequantize_2bit"] += 1
    return out


def dgc_update(velocity: torch.Tensor, accum: torch.Tensor,
               grad: torch.Tensor, momentum: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused DGC kernel: returns the new ``(v, u)``.  The
    multiply and the add are rounded separately (no FMA contraction,
    ``enable_fp_fusion=False``), as the plain version and the JAX
    reference compute them."""
    n = grad.numel()
    _check("grad", grad, torch.float32, n, grad.device)
    _check("velocity", velocity, torch.float32, n, grad.device)
    _check("accum", accum, torch.float32, n, grad.device)
    v_out = torch.empty_like(velocity)
    u_out = torch.empty_like(accum)
    if n == 0:
        return v_out, u_out
    triton, _, _, dgc = _get()
    grid = (triton.cdiv(n, BLOCK_ELEMS),)
    with _mu:
        dgc[grid](velocity, accum, grad, v_out, u_out, n, momentum,
                  BLOCK=BLOCK_ELEMS, enable_fp_fusion=False)
        LAUNCHES["dgc_update"] += 1
    return v_out, u_out
