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
- :func:`flash_bwd` runs the backward in one call: ``(dq, dk, dv)``.
  In bf16 that is the delta pass (which also zeroes an f32 dQ scratch),
  one kernel that forms dK, dV and each key tile's dQ and adds the dQ
  into the scratch, and the pass that rounds dQ to bf16; in f32 the
  delta pass, the dK/dV kernel and the dQ kernel.  When the caller
  asks (``ordered=True``: ``Config.deterministic`` through
  ``ops.flash_attention.fixed_order_backward``) or while
  ``torch.are_deterministic_algorithms_enabled()``, the bf16 kernel adds
  the dQ partials in ascending key tiles (counted under
  ``flash_bwd_ordered``), so that two runs give the same bits; otherwise
  the order of those f32 adds varies from run to run.

The launch path is short, because at the LM's shape a call costs more on
the host than on the card (``examples/time_flash_launch.py``): one pass
of checks (device, dtype, shape, contiguity and the 16-byte alignment
TMA needs), ``torch.empty`` for the outputs (and one f32 scratch in the
backward), the current stream's raw handle, one ``ctypes`` call, and a ``RuntimeError`` if the launch
reports a CUDA error.  No lock is held across the launch; only the
launch counters are guarded.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from geomx_tpu_torch.utils.build import NvccLibrary

PKG = Path(__file__).resolve().parents[2]
KERNEL_CACHE = PKG / ".kernel_cache"
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_f32": 0,
                            "flash_bwd": 0, "flash_bwd_ordered": 0,
                            "flash_bwd_f32": 0}
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
    lib.geo_flash_fwd.argtypes = [i, i, p, p, p, p, p, i, i, i, f, p]
    lib.geo_flash_fwd.restype = i
    lib.geo_flash_bwd.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, p, p,
                                  i, i, i, f, p]
    lib.geo_flash_bwd.restype = i
    lib.geo_flash_host_pieces.argtypes = [i, i, p, i, i, i, i,
                                          ctypes.POINTER(ctypes.c_double)]
    lib.geo_flash_host_pieces.restype = i


# built with nvcc at the first launch; LIB.log keeps what ptxas said
LIB = NvccLibrary(PKG / "csrc" / "flash_attention.cu",
                  KERNEL_CACHE / "libflash_attention.so", _bind)


def library() -> ctypes.CDLL:
    """The kernels' library: built with nvcc if missing or older than
    the source or a header beside it, loaded once per process."""
    return LIB.load()


def _check(q: torch.Tensor, named: Tuple[Tuple[str, torch.Tensor], ...]
           ) -> Tuple[Tuple[int, int, int, int], List[int]]:
    """``(B, T, H, Dh)`` of ``q`` and the addresses of q and the named
    tensors, after one pass over them: q's rank, dtype, head dim and
    grid; then each tensor's device, dtype, shape, contiguity and (TMA's)
    16-byte alignment."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, Dh] (got {tuple(q.shape)})")
    dtype = q.dtype
    if dtype not in DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16 "
                        f"(got {dtype})")
    shape = q.shape
    B, T, H, D = shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported {HEAD_DIMS}")
    if B * H >= 65536:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535")
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor (got {q.device})")
    dev = q.device
    ptrs = []
    for name, t in (("q", q),) + named:
        if t is not q and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}"
                             if t.is_cuda else f"{name} must be a CUDA "
                             f"tensor (got {t.device})")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [B, T, H, Dh]")
        ptr = t.data_ptr()
        if ptr % 16:
            raise ValueError(f"{dtype} flash attention reads through TMA "
                             f"and needs 16-byte aligned tensors (got "
                             f"address {ptr:#x})")
        ptrs.append(ptr)
    return (B, T, H, D), ptrs


def _check_lse(lse: torch.Tensor, q: torch.Tensor, B: int, H: int,
               T: int) -> None:
    if lse.device != q.device:
        raise ValueError(f"lse is on {lse.device}, expected {q.device}")
    if lse.dtype != _F32:
        raise TypeError(f"lse is {lse.dtype}, expected torch.float32")
    if lse.shape != (B, H, T):
        raise ValueError(f"lse has shape {tuple(lse.shape)}, expected "
                         f"{(B, H, T)}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous [B, H, T]")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _count(name: str) -> None:
    with _mu:
        LAUNCHES[name] += 1


def _raw_stream(index: int) -> int:
    """The current stream's handle (``torch.cuda.current_stream`` builds
    a ``Stream`` object each call)."""
    return torch._C._cuda_getCurrentRawStream(index)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward on the card: ``o`` [B, T, H, Dh] in q's
    dtype and ``lse`` f32 [B, H, T] (log-sum-exp of the scaled scores)."""
    (B, T, H, D), (pq, pk, pv) = _check(q, (("k", k), ("v", v)))
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=_F32, device=q.device)
    if B * T * H == 0:
        return o, lse
    f32 = q.dtype is _F32
    rc = library().geo_flash_fwd(
        0 if f32 else 1, D, pq, pk, pv, o.data_ptr(), lse.data_ptr(), B, H,
        T, sm_scale, _raw_stream(q.get_device()))
    _raise_on(rc, "flash forward")
    _count("flash_fwd_f32" if f32 else "flash_fwd")
    return o, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              sm_scale: float, ordered: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention backward on the card: ``(dq, dk, dv)`` in q's
    dtype, from the forward's ``o`` and ``lse`` and the output grad.  In
    bf16 dQ is summed over the key tiles in an f32 scratch (zeroed by the
    delta pass) and rounded once by a last pass; in ascending key tiles
    when ``ordered`` or while PyTorch's deterministic switch is on."""
    (B, T, H, D), ptrs = _check(q, (("k", k), ("v", v), ("o", o),
                                    ("do", do)))
    _check_lse(lse, q, B, H, T)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if B * T * H == 0:
        return dq, dk, dv
    # one 4-byte scratch: dQ's f32 sum (bf16 only; 16-byte aligned at its
    # start), delta f32 [B, H, T], and on the fixed-order path the int32
    # turns of each (b*h, 64-query step, consumer warpgroup)
    f32 = q.dtype is _F32
    ordered = not f32 and (ordered
                           or torch.are_deterministic_algorithms_enabled())
    n_acc = 0 if f32 else B * T * H * D
    n_turns = B * H * -(-T // 64) * 2 if ordered else 0
    scratch = torch.empty(n_acc + B * H * T + n_turns, dtype=_F32,
                          device=q.device)
    base = scratch.data_ptr()
    rc = library().geo_flash_bwd(
        0 if f32 else 1, D, *ptrs, lse.data_ptr(), base + 4 * n_acc,
        None if f32 else base,
        base + 4 * (n_acc + B * H * T) if ordered else None, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, T, sm_scale,
        _raw_stream(q.get_device()))
    _raise_on(rc, "flash backward")
    _count("flash_bwd_f32" if f32 else
           "flash_bwd_ordered" if ordered else "flash_bwd")
    return dq, dk, dv
