"""ctypes binding of the CUDA flash-attention kernels
(``geomx_tpu_torch/csrc/flash_attention.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` at the first launch
into ``geomx_tpu_torch/.kernel_cache/libflash_attention.so`` (rebuilt
when the source is newer), under a file lock and into a temporary name
moved onto the library (:func:`geomx_tpu_torch.utils.build.locked_build`),
so concurrent first launches build once.  ``nvcc`` is found through
``CUDA_HOME``, ``PATH`` or the toolkit's default prefix; without it the
first launch raises.  Nothing is built or loaded when this module is
imported, so the CPU tests can import it.

Two launchers, each counting its launches in :data:`LAUNCHES`:

- :func:`flash_fwd` runs the forward kernel: ``(o, lse)``;
- :func:`flash_bwd` runs the three backward kernels (delta, dK/dV, dQ)
  in one call: ``(dq, dk, dv)``.

Each wrapper checks device, dtype, shape and contiguity, allocates every
output with ``torch.empty``, launches on the current stream and raises
if the launch reports a CUDA error.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from geomx_tpu_torch.utils.build import locked_build

PKG = Path(__file__).resolve().parents[2]
SOURCE = PKG / "csrc" / "flash_attention.cu"
KERNEL_CACHE = PKG / ".kernel_cache"
LIBRARY = KERNEL_CACHE / "libflash_attention.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd": 0}
_mu = threading.Lock()
_lib = None
# what ptxas said of each kernel (registers, shared memory, spills)
BUILD_LOG = ""


def reset_launches() -> None:
    with _mu:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    with _mu:
        return dict(LAUNCHES)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default prefix; raises RuntimeError when none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the flash-attention kernels cannot be built")


def _stale() -> bool:
    try:
        return LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime
    except FileNotFoundError:
        return True


def _compile(out: str) -> None:
    global BUILD_LOG
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", out, str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    BUILD_LOG = res.stderr


def library() -> ctypes.CDLL:
    """The kernels' library: built with nvcc if missing or older than
    the source, loaded once per process."""
    global _lib
    if _lib is None:
        with _mu:
            if _lib is None:
                locked_build(str(LIBRARY), _stale, _compile)
                lib = ctypes.CDLL(str(LIBRARY))
                p, i, ll, f = (ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_float)
                lib.geo_flash_fwd.argtypes = [i, i, p, p, p, p, p, i, i, i,
                                              ll, ll, ll, f, p]
                lib.geo_flash_fwd.restype = i
                lib.geo_flash_bwd.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                              p, p, i, i, i, ll, ll, ll, f, p]
                lib.geo_flash_bwd.restype = i
                _lib = lib
    return _lib


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
        LAUNCHES["flash_fwd"] += 1
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
        LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv
