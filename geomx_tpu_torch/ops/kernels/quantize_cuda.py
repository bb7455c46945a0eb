"""ctypes binding of the CUDA 2-bit quantize and dequantize kernels
(``geomx_tpu_torch/csrc/quantize.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` at the first launch
into ``geomx_tpu_torch/.kernel_cache/libquantize.so`` by
:class:`geomx_tpu_torch.utils.build.NvccLibrary` (under a file lock,
rebuilt when the source is newer); nothing is built or loaded when this
module is imported, so the CPU tests can import it.

At the codec stage's key sizes a call costs more on the host than on
the card, so each wrapper does the least host work that still refuses
bad input: the layout, dtype, shape, contiguity and device checks (all
before the library is loaded), ``torch.empty`` for the outputs, the
current stream's raw handle (``torch._C._cuda_getCurrentRawStream``, as
PyTorch's own Triton launchers take it: ``torch.cuda.current_stream``
builds a ``Stream`` object each call), one ``ctypes`` call (which
releases the GIL and rounds the threshold to f32), and a
``RuntimeError`` if the launch reports a CUDA error.  No lock is
held across the launch: launches on one stream are thread-safe; only
the launch counters in :data:`LAUNCHES` are guarded.  The kernels take
views at any 4-byte offset (a scalar path when a pointer is off a
16-byte boundary); the inputs must be contiguous 1-D tensors.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from geomx_tpu_torch.ops.kernels.flash_attention import KERNEL_CACHE, PKG
from geomx_tpu_torch.utils.build import NvccLibrary

STRIDE_BLOCK = 131072   # elements of one block of the strided layout
QUARTER = 32768         # its packed bytes
_F32, _U8 = torch.float32, torch.uint8

LAUNCHES: Dict[str, int] = {"quantize_2bit": 0, "dequantize_2bit": 0}
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


LIB = NvccLibrary(PKG / "csrc" / "quantize.cu",
                  KERNEL_CACHE / "libquantize.so", _bind)


def _layout(layout: str) -> int:
    """1 for ``strided``, 0 for ``consecutive``."""
    if layout == "consecutive":
        return 0
    if layout == "strided":
        return 1
    raise ValueError(f"unknown 2-bit layout {layout!r}")


def _packed_len(n: int, strided: int) -> int:
    return -(-n // STRIDE_BLOCK) * QUARTER if strided else (n + 3) // 4


def _check_pair(grad: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.device, int]:
    """(device, n) of a gradient and residual the kernel takes."""
    if grad.dtype is not _F32 or residual.dtype is not _F32:
        raise TypeError(f"grad and residual must be float32 (got "
                        f"{grad.dtype}, {residual.dtype})")
    if (grad.dim() != 1 or residual.dim() != 1
            or not grad.is_contiguous() or not residual.is_contiguous()):
        raise ValueError("grad and residual must be contiguous 1-D tensors")
    n = grad.shape[0]
    if residual.shape[0] != n:
        raise ValueError(f"residual has {residual.shape[0]} elements, "
                         f"grad {n}")
    dev = grad.device
    if dev.type != "cuda" or residual.device != dev:
        raise ValueError(f"grad and residual must be CUDA tensors on one "
                         f"device (got {dev}, {residual.device})")
    return dev, n


def _check_codes(packed: torch.Tensor, n: int, strided: int
                 ) -> torch.device:
    """The device of a code buffer the kernel takes for ``n`` elements."""
    if packed.dtype is not _U8:
        raise TypeError(f"packed must be uint8 (got {packed.dtype})")
    if packed.dim() != 1 or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous 1-D tensor")
    need = _packed_len(n, strided)
    if n < 0 or packed.shape[0] < need:
        raise ValueError(f"packed holds {packed.shape[0]} bytes, {need} "
                         f"needed for {n} elements")
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"packed must be a CUDA tensor (got {dev})")
    return dev


def quantize_2bit(grad: torch.Tensor, residual: torch.Tensor,
                  threshold: float, layout: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the 2-bit quantize kernel: returns ``(packed uint8, new
    residual f32 [n])`` in ``layout`` (``strided``|``consecutive``);
    the kernel compares with the f32 nearest ``threshold``."""
    strided = _layout(layout)
    dev, n = _check_pair(grad, residual)
    packed = torch.empty(_packed_len(n, strided), dtype=_U8, device=dev)
    new_r = torch.empty(n, dtype=_F32, device=dev)
    if n == 0:
        return packed, new_r
    rc = LIB.load().geo_quantize_2bit(
        grad.data_ptr(), residual.data_ptr(), packed.data_ptr(),
        new_r.data_ptr(), n, threshold, strided, dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"2-bit quantize launch failed: CUDA error {rc}")
    with _mu:
        LAUNCHES["quantize_2bit"] += 1
    return packed, new_r


def dequantize_2bit(packed: torch.Tensor, n: int, threshold: float,
                    layout: str) -> torch.Tensor:
    """Launch the 2-bit dequantize kernel: f32 ``[n]``."""
    strided = _layout(layout)
    dev = _check_codes(packed, n, strided)
    out = torch.empty(n, dtype=_F32, device=dev)
    if n == 0:
        return out
    rc = LIB.load().geo_dequantize_2bit(
        packed.data_ptr(), out.data_ptr(), n, threshold, strided, dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"2-bit dequantize launch failed: CUDA error "
                           f"{rc}")
    with _mu:
        LAUNCHES["dequantize_2bit"] += 1
    return out
