"""ctypes binding of the CUDA block-attention kernel
(``geomx_tpu_torch/csrc/block_attention.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` at the first launch
into ``geomx_tpu_torch/.kernel_cache/libblock_attention.so`` by
:class:`geomx_tpu_torch.utils.build.NvccLibrary` (under a file lock,
rebuilt when the source or a ``csrc/*.cuh`` header is newer); nothing is
built or loaded when this module is imported, so the CPU tests can
import it.

:func:`block_attn_fwd` checks device, dtype, shape and layout,
allocates ``m``, ``l`` and ``o`` with ``torch.empty``, launches on the
current stream, raises if the launch reports a CUDA error, and counts
the launch in :data:`LAUNCHES` (``block_attn_fwd`` for the bf16 kernel,
``block_attn_fwd_f32`` for the f32 one).  Both dtypes are read through
TMA maps built from the tensors' strides, so a strided view (a ring
shard ``x[:, r*t:(r+1)*t]``) is taken as it is: its last dimension must
be contiguous, its other strides multiples of 16 bytes and its first
element 16-byte aligned.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Tuple

import torch

from geomx_tpu_torch.ops.kernels.flash_attention import (
    DTYPES, HEAD_DIMS, KERNEL_CACHE, PKG)
from geomx_tpu_torch.utils.build import NvccLibrary

LAUNCHES: Dict[str, int] = {"block_attn_fwd": 0, "block_attn_fwd_f32": 0}
_mu = threading.Lock()


def reset_launches() -> None:
    with _mu:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    with _mu:
        return dict(LAUNCHES)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.geo_block_attn_fwd.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i,
                                       p, i, i, i, f, p]
    lib.geo_block_attn_fwd.restype = i


# built with nvcc at the first launch; LIB.log keeps what ptxas said
LIB = NvccLibrary(PKG / "csrc" / "block_attention.cu",
                  KERNEL_CACHE / "libblock_attention.so", _bind)


def _check(name: str, t: torch.Tensor, q: torch.Tensor, T: int) -> None:
    B, _, H, D = q.shape
    if tuple(t.shape) != (B, T, H, D):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{(B, T, H, D)}")
    if t.dtype != q.dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {q.dtype}")
    _check_tma_layout(name, t)


def _check_tma_layout(name: str, t: torch.Tensor) -> None:
    """What a TMA map of a [B, T, H, D] tensor needs."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous "
                         f"(strides {t.stride()})")
    if any(s * t.element_size() % 16 for s in t.stride()[:3]):
        raise ValueError(f"{name}: strides {t.stride()} are not all "
                         f"multiples of 16 bytes")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (got "
                         f"address {t.data_ptr():#x})")


def block_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   offs: Tuple[int, int], causal: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One partial attention block on the card: ``(m [B,Tq,H], l
    [B,Tq,H], o [B,Tq,H,D])``, all f32, contiguous and unnormalised, for
    q ``[B,Tq,H,D]`` and k/v ``[B,Tk,H,D]`` whose first tokens sit at
    the global positions ``offs = (q_off, k_off)``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, T, H, D] (got "
                         f"{tuple(q.shape)}, {tuple(k.shape)})")
    if q.dtype not in DTYPES:
        raise TypeError(f"block attention takes float32 or bfloat16 "
                        f"(got {q.dtype})")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported {HEAD_DIMS}")
    if B * H >= 65536:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535")
    if Tk == 0:
        raise ValueError("k and v hold no keys (Tk = 0)")
    _check("q", q, q, Tq)
    _check("k", k, q, Tk)
    _check("v", v, q, Tk)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got "
                             f"{t.device})")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{q.device}")
    q_off, k_off = (int(x) for x in offs)
    m = torch.empty((B, Tq, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    o = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return m, l, o
    lib = LIB.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in t.stride()[:3]))
    with _mu:
        rc = lib.geo_block_attn_fwd(
            DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            m.data_ptr(), l.data_ptr(), o.data_ptr(), B, H, Tq, Tk, strides,
            q_off, k_off, int(bool(causal)), 1.0 / math.sqrt(D), stream)
        if rc != 0:
            raise RuntimeError(f"block attention launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES["block_attn_fwd" if q.dtype == torch.bfloat16
                 else "block_attn_fwd_f32"] += 1
    return m, l, o
