"""Where the host time of one flash-attention call goes, on one CUDA card.

    python -m geomx_tpu_torch.examples.time_flash_launch
        [--shape 8,128,6,64] [--calls 2000]

At the flagship LM's shape, (B, T, H, Dh) = (8, 128, 6, 64), a flash
call costs more on the host than on the card.  For ``flash_fwd`` and
``flash_bwd`` of ``ops/kernels/flash_attention.py``, in f32 and bf16,
this script times with ``time.perf_counter`` over ``--calls`` calls back
to back (three rounds, the median kept) the whole call and each piece of
it: the merged checks, the allocations, the current stream's raw handle
(and ``torch.cuda.current_stream``'s, which the wrapper no longer
calls), the counter under its lock, and the ``ctypes`` call alone
(outputs made beforehand).  Inside the library,
``geo_flash_host_pieces`` times with the host clock one tensor map
encoded, ``cudaFuncSetAttribute``, ``cudaGetDevice`` and
``cudaGetLastError``.  Each piece runs alone in its own loop, so the
pieces need not add up to the whole.

Then CUDA-event times in turns (kernel, SDPA, SDPA, kernel) of the
forward and the backward: the yardstick is
``scaled_dot_product_attention`` on the same tensors in [B, H, T, Dh]
(its backward by ``torch.autograd.grad``).  Writes
``chiprun_out/flash_launch.json`` (under the current directory) and
prints the card's name and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROUNDS = 3
C_PIECES = ("tensor map encoded", "cudaFuncSetAttribute", "cudaGetDevice",
            "cudaGetLastError")


def _host_us(fn, calls: int) -> float:
    """Median over ``ROUNDS`` of the host time (µs) of one call of
    ``fn``, from ``calls`` calls back to back, the card drained before
    and after each round."""
    import torch

    for _ in range(20):
        fn()
    out = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(out)


def _event_ms(fn, calls: int) -> float:
    """CUDA-event time (ms) of one call, over ``calls`` calls."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _in_turns(first, second, calls: int) -> tuple:
    """Event times (ms) of two functions run first, second, second,
    first: the mean of each one's two runs."""
    a1 = _event_ms(first, calls)
    b1 = _event_ms(second, calls)
    b2 = _event_ms(second, calls)
    a2 = _event_ms(first, calls)
    return (a1 + a2) / 2, (b1 + b2) / 2


def pieces(q, k, v, o, lse, do, scale) -> dict:
    """{function: {piece: callable}} of one forward and one backward."""
    import torch

    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    lib = FK.library()
    B, T, H, D = q.shape
    dt = FK.DTYPES[q.dtype]
    stream = FK._raw_stream(q.get_device())
    o2, lse2 = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bf16 = q.dtype == torch.bfloat16
    n_acc = q.numel() if bf16 else 0
    scratch = torch.empty(n_acc + B * H * T, dtype=torch.float32,
                          device=q.device)
    base = scratch.data_ptr()

    def fwd_ctypes():
        return lib.geo_flash_fwd(dt, D, q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), o2.data_ptr(),
                                 lse2.data_ptr(), B, H, T, scale, stream)

    def bwd_ctypes():
        return lib.geo_flash_bwd(dt, D, q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), o.data_ptr(), do.data_ptr(),
                                 lse.data_ptr(), base + 4 * n_acc,
                                 base if bf16 else None, None,
                                 dq.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), B, H, T,
                                 scale, stream)

    common = {
        "stream handle": lambda: FK._raw_stream(q.get_device()),
        "stream object": lambda: torch.cuda.current_stream(
            q.device).cuda_stream,
        "lock and counter": lambda: FK._count("flash_fwd"),
    }
    return {
        "flash_fwd": {
            "whole call": lambda: FK.flash_fwd(q, k, v, scale),
            "checks": lambda: FK._check(q, (("k", k), ("v", v))),
            "allocations": lambda: (
                torch.empty_like(q),
                torch.empty(B, H, T, dtype=torch.float32, device=q.device)),
            **common,
            "ctypes call": fwd_ctypes,
        },
        "flash_bwd": {
            "whole call": lambda: FK.flash_bwd(q, k, v, o, lse, do, scale),
            "checks": lambda: (FK._check(q, (("k", k), ("v", v), ("o", o),
                                             ("do", do))),
                               FK._check_lse(lse, q, B, H, T)),
            "allocations": lambda: (
                [torch.empty_like(q) for _ in range(3)],
                torch.empty(n_acc + B * H * T, dtype=torch.float32,
                            device=q.device)),
            **common,
            "ctypes call": bwd_ctypes,
        },
    }


def c_pieces(q, reps: int) -> dict:
    """The library's own host clock over its pieces (µs each)."""
    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    B, T, H, D = q.shape
    us = (ctypes.c_double * len(C_PIECES))()
    rc = FK.library().geo_flash_host_pieces(
        FK.DTYPES[q.dtype], D, q.data_ptr(), B, H, T, reps, us)
    FK._raise_on(rc, "host pieces")
    return dict(zip(C_PIECES, list(us)))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="8,128,6,64")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    if not torch.cuda.is_available():
        print("time_flash_launch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    shape = tuple(int(x) for x in args.shape.split(","))
    out = {"nvidia_smi": smi, "shape": list(shape), "calls": args.calls,
           "rounds": ROUNDS, "by_dtype": {}}
    for dt in ("float32", "bfloat16"):
        rng = np.random.default_rng(sum(shape))
        q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                        .astype(np.float32))
                       .to(dev, getattr(torch, dt)) for _ in range(4))
        scale = 1.0 / math.sqrt(shape[-1])
        o, lse = FK.flash_fwd(q, k, v, scale)
        rec = out["by_dtype"][dt] = {"library_us": c_pieces(q, 1000)}
        print(f"{dt} library pieces (us): " + "; ".join(
            f"{p} {t:.3f}" for p, t in rec["library_us"].items()),
            flush=True)
        for fn_name, parts in pieces(q, k, v, o, lse, do, scale).items():
            host = {p: _host_us(f, args.calls) for p, f in parts.items()}
            rec[fn_name] = {"host_us": host}
            print(f"{dt} {fn_name} host us: " + "; ".join(
                f"{p} {t:.2f}" for p, t in host.items()), flush=True)
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        sdo = do.transpose(1, 2).contiguous()
        calls = {
            "flash_fwd": (lambda: FK.flash_fwd(q, k, v, scale),
                          lambda: F.scaled_dot_product_attention(
                              sq, sk, sv, is_causal=True)),
            "flash_bwd": (lambda: FK.flash_bwd(q, k, v, o, lse, do, scale),
                          lambda: torch.autograd.grad(
                              so, (sq, sk, sv), sdo, retain_graph=True)),
        }
        for fn_name, (kern, sdpa) in calls.items():
            ms, sdpa_ms = _in_turns(kern, sdpa, args.calls)
            rec[fn_name]["event_ms"] = {"kernel": ms, "sdpa": sdpa_ms}
            print(f"{dt} {fn_name} events in turns: kernel {ms:.4f} ms, "
                  f"sdpa {sdpa_ms:.4f} ms", flush=True)
        del q, k, v, do, o, lse, sq, sk, sv, so, sdo
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_launch.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
