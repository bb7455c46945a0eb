"""ctypes binding of the CUDA flash-attention kernels
(``geomx_tpu_torch/csrc/flash_attention.cu``).

The source (and ``csrc/hopper_tiles.cuh``, which it includes) is
compiled with ``nvcc`` for ``sm_90a`` at the first launch into
``geomx_tpu_torch/.kernel_cache/libflash_attention.so`` (rebuilt when
the source or a ``csrc/*.cuh`` header is newer), under a file lock and
into a temporary name moved onto the library
(:class:`geomx_tpu_torch.utils.build.NvccLibrary`), so concurrent first
launches build once.  ``nvcc`` is found through
``CUDA_HOME``, ``PATH`` or the toolkit's default prefix; without it the
first launch raises.  Nothing is built or loaded when this module is
imported, so the CPU tests can import it.

Two launchers, each counting its launches in :data:`LAUNCHES` (the f32
kernels under the name with ``_f32``):

- :func:`flash_fwd` runs the forward kernel: ``(o, lse)``;
- :func:`flash_bwd` runs the three backward kernels (delta, dK/dV, dQ)
  in one call: ``(dq, dk, dv)``.

Each wrapper checks device, dtype, shape, contiguity and 16-byte
alignment (every kernel but ``delta`` reads through TMA), allocates
every output with ``torch.empty``, launches on the current stream and
raises if the launch reports a CUDA error.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from geomx_tpu_torch.utils.build import NvccLibrary

PKG = Path(__file__).resolve().parents[2]
KERNEL_CACHE = PKG / ".kernel_cache"
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_f32": 0,
                            "flash_bwd": 0, "flash_bwd_f32": 0}
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
    lib.geo_flash_fwd.argtypes = [i, i, p, p, p, p, p, i, i, i, ll, ll, ll,
                                  f, p]
    lib.geo_flash_fwd.restype = i
    lib.geo_flash_bwd.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, i, i,
                                  i, ll, ll, ll, f, p]
    lib.geo_flash_bwd.restype = i


# built with nvcc at the first launch; LIB.log keeps what ptxas said
LIB = NvccLibrary(PKG / "csrc" / "flash_attention.cu",
                  KERNEL_CACHE / "libflash_attention.so", _bind)


def library() -> ctypes.CDLL:
    """The kernels' library: built with nvcc if missing or older than
    the source or a header beside it, loaded once per process."""
    return LIB.load()


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {like.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous [B, T, H, Dh]")


def _check_q(q: torch.Tensor) -> Tuple[int, int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, Dh] (got {tuple(q.shape)})")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16 "
                        f"(got {q.dtype})")
    B, T, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported {HEAD_DIMS}")
    if B * H >= 65536:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535")
    _check("q", q, q)
    return B, T, H, D


def _check_aligned(*ts: torch.Tensor) -> None:
    """TMA's tensor maps need 16-byte aligned bases."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{t.dtype} flash attention reads through TMA "
                             f"and needs 16-byte aligned tensors (got "
                             f"address {t.data_ptr():#x})")


def _name(what: str, q: torch.Tensor) -> str:
    return what if q.dtype == torch.bfloat16 else what + "_f32"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward on the card: ``o`` [B, T, H, Dh] in q's
    dtype and ``lse`` f32 [B, H, T] (log-sum-exp of the scaled scores)."""
    B, T, H, D = _check_q(q)
    _check("k", k, q)
    _check("v", v, q)
    _check_aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = library()
    sb, st, sh, _ = q.stride()
    with _mu:
        rc = lib.geo_flash_fwd(DTYPES[q.dtype], D, q.data_ptr(),
                               k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               lse.data_ptr(), B, H, T, sb, st, sh,
                               float(sm_scale), _stream(q))
        _raise_on(rc, "flash forward")
        LAUNCHES[_name("flash_fwd", q)] += 1
    return o, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention backward on the card: ``(dq, dk, dv)`` in q's
    dtype, from the forward's ``o`` and ``lse`` and the output grad."""
    B, T, H, D = _check_q(q)
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        _check(name, t, q)
    want = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _check("lse", lse, want)
    _check_aligned(q, k, v, o, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty_like(want)
    lib = library()
    sb, st, sh, _ = q.stride()
    with _mu:
        rc = lib.geo_flash_bwd(DTYPES[q.dtype], D, q.data_ptr(),
                               k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), B, H, T,
                               sb, st, sh, float(sm_scale), _stream(q))
        _raise_on(rc, "flash backward")
        LAUNCHES[_name("flash_bwd", q)] += 1
    return dq, dk, dv
