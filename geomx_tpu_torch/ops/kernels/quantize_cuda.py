"""ctypes binding of the CUDA 2-bit quantize and dequantize kernels and
the DGC momentum update (``geomx_tpu_torch/csrc/quantize.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` at the first launch
into ``geomx_tpu_torch/.kernel_cache/libquantize.so`` by
:class:`geomx_tpu_torch.utils.build.NvccLibrary` (under a file lock,
rebuilt when the source is newer); nothing is built or loaded when this
module is imported, so the CPU tests can import it.

At the codec stage's key sizes a call costs more on the host than on
the card, so each wrapper takes the flash wrapper's short path
(``ops/kernels/flash_attention.py``): one combined test of cheap
attribute reads per operand accepts what the kernels take (f32 or
uint8, CUDA, 1-D, contiguous, one length, one card), and only an
operand it refuses is examined further, so that the error names what
is wrong (all of this before the library is loaded); then
``torch.empty_like`` / ``new_empty`` for the outputs (the DGC update
writes into the caller's ``out`` instead when given one), the current
stream's raw handle
(``torch._C._cuda_getCurrentRawStream``: ``torch.cuda.current_stream``
builds a ``Stream`` object each call), one ``ctypes`` call (which
releases the GIL and rounds the threshold or the momentum to f32, as
``np.float32`` does), one hold of the counters' lock, and a
``RuntimeError`` if the launch reports a CUDA error.  No lock is held
across the launch: launches on one stream are thread-safe; only the
launch counters in :data:`LAUNCHES` are guarded.  The kernels take
views at any 4-byte offset (a scalar path when a pointer is off a
16-byte boundary); the inputs must be contiguous 1-D tensors.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from geomx_tpu_torch.ops.kernels.flash_attention import KERNEL_CACHE, PKG
from geomx_tpu_torch.utils.build import NvccLibrary

STRIDE_BLOCK = 131072   # elements of one block of the strided layout
QUARTER = 32768         # its packed bytes
_F32, _U8 = torch.float32, torch.uint8

LAUNCHES: Dict[str, int] = {"quantize_2bit": 0, "dequantize_2bit": 0,
                            "dgc_update": 0}
_mu = threading.Lock()


def reset_launches() -> None:
    with _mu:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    with _mu:
        return dict(LAUNCHES)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.geo_quantize_2bit.argtypes = [p, p, p, p, ll, f, i, i, p]
    lib.geo_quantize_2bit.restype = i
    lib.geo_dequantize_2bit.argtypes = [p, p, ll, f, i, i, p]
    lib.geo_dequantize_2bit.restype = i
    lib.geo_dgc_update.argtypes = [p, p, p, p, p, ll, f, i, p]
    lib.geo_dgc_update.restype = i


LIB = NvccLibrary(PKG / "csrc" / "quantize.cu",
                  KERNEL_CACHE / "libquantize.so", _bind)


_LAYOUTS = {"consecutive": 0, "strided": 1}


def _layout(layout: str) -> int:
    """1 for ``strided``, 0 for ``consecutive``."""
    strided = _LAYOUTS.get(layout)
    if strided is None:
        raise ValueError(f"unknown 2-bit layout {layout!r}")
    return strided


def _packed_len(n: int, strided: int) -> int:
    return -(-n // STRIDE_BLOCK) * QUARTER if strided else (n + 3) // 4


def _check_f32(*named: Tuple[str, torch.Tensor]) -> Tuple[int, int]:
    """(card index, n) of ``(name, tensor)`` pairs the kernels take: f32,
    contiguous and 1-D, of one length, on one device; the index is -1
    off CUDA, which :func:`_need_cuda` refuses.  One combined test
    accepts a tensor; only a tensor it refuses is examined, so that the
    error names what is wrong."""
    first_name, first = named[0]
    n = first.shape[0] if first.dim() == 1 else -1
    index = first.get_device()
    for name, t in named:
        if (t.dtype is _F32 and t.dim() == 1 and t.is_contiguous()
                and t.shape[0] == n and t.get_device() == index):
            continue
        if t.dtype is not _F32:
            raise TypeError(f"{name} must be float32 (got {t.dtype})")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} elements, "
                             f"{first_name} {n}")
        raise ValueError(f"{name} is on {t.device}, {first_name} on "
                         f"{first.device}: CUDA tensors on one device "
                         f"expected")
    return index, n


def _need_cuda(index: int, t: torch.Tensor) -> None:
    if index < 0:
        raise ValueError(f"the kernels take CUDA tensors (got {t.device})")


def _refuse_overlap(named: Tuple[Tuple[str, torch.Tensor], ...],
                    n: int) -> None:
    """Refuse a DGC output (the last two of the five ``(name, tensor)``
    pairs: velocity, accum, grad, v_out, u_out, each ``n`` contiguous
    f32) that shares a byte with an input other than its own input at
    the same address, or with the other output."""
    p = [t.data_ptr() for _, t in named]
    for o in (3, 4):
        for i in range(o):
            if abs(p[o] - p[i]) < 4 * n and not (i == o - 3 and p[o] == p[i]):
                raise ValueError(f"{named[o][0]} overlaps {named[i][0]}")


def _check_codes(packed: torch.Tensor, n: int, strided: int) -> int:
    """The card index of a code buffer the kernel takes for ``n``
    elements; as in :func:`_check_f32`, one combined test accepts."""
    need = _packed_len(n, strided)
    if (packed.dtype is _U8 and packed.dim() == 1 and packed.is_contiguous()
            and n >= 0 and packed.shape[0] >= need and packed.is_cuda):
        return packed.get_device()
    if packed.dtype is not _U8:
        raise TypeError(f"packed must be uint8 (got {packed.dtype})")
    if packed.dim() != 1 or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous 1-D tensor")
    if n < 0 or packed.shape[0] < need:
        raise ValueError(f"packed holds {packed.shape[0]} bytes, {need} "
                         f"needed for {n} elements")
    raise ValueError(f"packed must be a CUDA tensor (got {packed.device})")


def quantize_2bit(grad: torch.Tensor, residual: torch.Tensor,
                  threshold: float, layout: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the 2-bit quantize kernel: returns ``(packed uint8, new
    residual f32 [n])`` in ``layout`` (``strided``|``consecutive``);
    the kernel compares with the f32 nearest ``threshold``."""
    strided = _layout(layout)
    index, n = _check_f32(("grad", grad), ("residual", residual))
    _need_cuda(index, grad)
    packed = grad.new_empty(_packed_len(n, strided), dtype=_U8)
    new_r = torch.empty_like(residual)
    if n == 0:
        return packed, new_r
    rc = LIB.load().geo_quantize_2bit(
        grad.data_ptr(), residual.data_ptr(), packed.data_ptr(),
        new_r.data_ptr(), n, threshold, strided, index,
        torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"2-bit quantize launch failed: CUDA error {rc}")
    with _mu:
        LAUNCHES["quantize_2bit"] += 1
    return packed, new_r


def dequantize_2bit(packed: torch.Tensor, n: int, threshold: float,
                    layout: str) -> torch.Tensor:
    """Launch the 2-bit dequantize kernel: f32 ``[n]``."""
    strided = _layout(layout)
    index = _check_codes(packed, n, strided)
    out = packed.new_empty(n, dtype=_F32)
    if n == 0:
        return out
    rc = LIB.load().geo_dequantize_2bit(
        packed.data_ptr(), out.data_ptr(), n, threshold, strided, index,
        torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"2-bit dequantize launch failed: CUDA error "
                           f"{rc}")
    with _mu:
        LAUNCHES["dequantize_2bit"] += 1
    return out


def dgc_update(velocity: torch.Tensor, accum: torch.Tensor,
               grad: torch.Tensor, momentum: float,
               out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the DGC update: ``v = m·v + g; u = u + v``, the product and
    each sum rounded on its own, with ``m`` the f32 nearest ``momentum``.
    Returns ``(v, u)``, new tensors or ``out = (v_out, u_out)``; an
    output may be its own input (``out=(velocity, accum)`` updates in
    place) and overlaps nothing else."""
    named = (("velocity", velocity), ("accum", accum), ("grad", grad))
    if out is not None:
        named += (("v_out", out[0]), ("u_out", out[1]))
    index, n = _check_f32(*named)
    if out is not None:
        _refuse_overlap(named, n)
    _need_cuda(index, velocity)
    v_out, u_out = out or (torch.empty_like(velocity),
                           torch.empty_like(accum))
    if n == 0:
        return v_out, u_out
    rc = LIB.load().geo_dgc_update(
        velocity.data_ptr(), accum.data_ptr(), grad.data_ptr(),
        v_out.data_ptr(), u_out.data_ptr(), n, momentum, index,
        torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"DGC update launch failed: CUDA error {rc}")
    with _mu:
        LAUNCHES["dgc_update"] += 1
    return v_out, u_out
