"""Where the host time of one 2-bit codec call goes, on one CUDA card.

    python -m geomx_tpu_torch.examples.time_codec_launch [--routes triton,cuda]
        [--sizes 384,401408] [--calls 10000]

At the codec stage's key sizes a quantize or dequantize call costs more
on the host than on the card.  For each route this script times the
whole call and each piece of it with ``time.perf_counter`` over
``--calls`` back-to-back calls (three rounds, the median kept), on
tensors on the card, in the consecutive layout:

- ``triton`` — the Triton kernels of ``ops/kernels/quantize_triton.py``
  as the dispatcher reached them before the CUDA kernels took their
  place (now a yardstick no path reaches): the dispatcher's layout
  check, route and f32 rounding of the threshold; the wrapper's tensor
  checks; the two ``torch.empty`` calls; Triton's launcher (argument
  specialisation, cache lookup, grid) with outputs made beforehand; the
  lock and launch counter;
- ``cuda`` — the CUDA kernels of ``csrc/quantize.cu`` through
  ``ops/kernels/quantize_cuda.py``: the dispatcher's route test, the
  wrapper's checks, the allocations, the current stream's raw handle
  (and, beside it, ``torch.cuda.current_stream(dev).cuda_stream``, which
  the wrapper does not call), the ``ctypes`` call alone (outputs made
  beforehand) and the counter.

Each piece runs alone in its own loop, so the pieces need not add up to
the whole; the sum is printed beside it.  The whole call is also timed
with CUDA events over the same loop.  Writes
``chiprun_out/codec_launch.json`` (under the current directory) and
prints the card's name and power limit.  Needs a CUDA card (and
``triton`` or ``nvcc`` for the route it times).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

THRESHOLD = 0.5
LAYOUT = "consecutive"
ROUNDS = 3


def _host_us(fn, calls: int) -> float:
    """Median over ``ROUNDS`` of the host time (µs) of one call of
    ``fn``, from ``calls`` calls back to back, the card drained before
    and after each round."""
    import torch

    for _ in range(50):
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


def _event_us(fn, calls: int) -> float:
    """CUDA-event time (µs) of one call, over ``calls`` calls."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def triton_pieces(g, r, packed, n: int) -> dict:
    """{function: {piece: callable}} of the Triton route."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_triton as K

    t = Q._f32(THRESHOLD)
    nb = K._packed_len(n, False)
    K.quantize_2bit(g, r, t, LAYOUT)          # builds the kernels
    K.dequantize_2bit(packed, n, t, LAYOUT)
    triton, quant, dequant, _ = K._get()
    p_out = torch.empty(nb, dtype=torch.uint8, device=g.device)
    r_out = torch.empty_like(r)
    d_out = torch.empty(n, dtype=torch.float32, device=g.device)
    grid = (triton.cdiv(nb, K.BLOCK_BYTES),)

    def dispatch():
        Q._check_layout(LAYOUT)
        Q._route(g)
        Q._f32(THRESHOLD)

    def lock_count(name):
        def fn():
            with K._mu:
                K.LAUNCHES[name] += 1
        return fn

    return {
        "quantize_2bit": {
            "whole call": lambda: (Q._check_layout(LAYOUT), Q._route(g),
                                   K.quantize_2bit(g, r, Q._f32(THRESHOLD),
                                                   LAYOUT)),
            "wrapper": lambda: K.quantize_2bit(g, r, t, LAYOUT),
            "dispatcher checks": dispatch,
            "tensor checks": lambda: (
                K._strided(LAYOUT),
                K._check("grad", g, torch.float32, n, g.device),
                K._check("residual", r, torch.float32, n, g.device),
                K._packed_len(n, False)),
            "allocations": lambda: (
                torch.empty(nb, dtype=torch.uint8, device=g.device),
                torch.empty_like(r)),
            "launcher": lambda: quant[(triton.cdiv(nb, K.BLOCK_BYTES),)](
                g, r, p_out, r_out, n, nb, t, STRIDED=False,
                BLOCK_B=K.BLOCK_BYTES),
            "lock and counter": lock_count("quantize_2bit"),
        },
        "dequantize_2bit": {
            "whole call": lambda: (Q._check_layout(LAYOUT), Q._route(packed),
                                   K.dequantize_2bit(packed, n,
                                                     Q._f32(THRESHOLD),
                                                     LAYOUT)),
            "wrapper": lambda: K.dequantize_2bit(packed, n, t, LAYOUT),
            "dispatcher checks": dispatch,
            "tensor checks": lambda: (
                K._strided(LAYOUT), K._packed_len(n, False),
                packed.numel(),
                K._check("packed", packed, torch.uint8, packed.numel(),
                         packed.device)),
            "allocations": lambda: torch.empty(n, dtype=torch.float32,
                                               device=g.device),
            "launcher": lambda: dequant[grid](
                packed, d_out, n, nb, t, STRIDED=False,
                BLOCK_B=K.BLOCK_BYTES),
            "lock and counter": lock_count("dequantize_2bit"),
        },
    }


def cuda_pieces(g, r, packed, n: int) -> dict:
    """{function: {piece: callable}} of the CUDA route."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    t = Q._f32(THRESHOLD)
    lib = C.LIB.load()
    nb = (n + 3) // 4
    p_out = torch.empty(nb, dtype=torch.uint8, device=g.device)
    r_out = torch.empty_like(r)
    d_out = torch.empty(n, dtype=torch.float32, device=g.device)
    dev = g.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def count(name):
        def fn():
            with C._mu:
                C.LAUNCHES[name] += 1
        return fn

    return {
        "quantize_2bit": {
            "whole call": lambda: Q.quantize_2bit(g, r, THRESHOLD, LAYOUT),
            "wrapper": lambda: C.quantize_2bit(g, r, t, LAYOUT),
            "dispatcher checks": lambda: g.is_cuda,
            "tensor checks": lambda: (C._layout(LAYOUT),
                                      C._check_pair(g, r)),
            "allocations": lambda: (
                torch.empty(nb, dtype=torch.uint8, device=dev),
                torch.empty(n, dtype=torch.float32, device=dev)),
            "stream handle": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index),
            "stream object": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "ctypes call": lambda: lib.geo_quantize_2bit(
                g.data_ptr(), r.data_ptr(), p_out.data_ptr(),
                r_out.data_ptr(), n, t, 0, dev.index, stream),
            "lock and counter": count("quantize_2bit"),
        },
        "dequantize_2bit": {
            "whole call": lambda: Q.dequantize_2bit(packed, n, THRESHOLD,
                                                    LAYOUT),
            "wrapper": lambda: C.dequantize_2bit(packed, n, t, LAYOUT),
            "dispatcher checks": lambda: packed.is_cuda,
            "tensor checks": lambda: (C._layout(LAYOUT),
                                      C._check_codes(packed, n, False)),
            "allocations": lambda: torch.empty(n, dtype=torch.float32,
                                               device=dev),
            "stream handle": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index),
            "stream object": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "ctypes call": lambda: lib.geo_dequantize_2bit(
                packed.data_ptr(), d_out.data_ptr(), n, t, 0, dev.index,
                stream),
            "lock and counter": count("dequantize_2bit"),
        },
    }


ROUTES = {"triton": triton_pieces, "cuda": cuda_pieces}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--routes", default="triton,cuda")
    ap.add_argument("--sizes", default="384,401408")
    ap.add_argument("--calls", type=int, default=10_000)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_codec_launch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    routes = args.routes.split(",")
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"nvidia_smi": smi, "calls": args.calls, "rounds": ROUNDS,
           "layout": LAYOUT, "by_size": {}}
    for n in (int(s) for s in args.sizes.split(",")):
        rng = np.random.default_rng(n)
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 0.4).to(dev)
        r = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 0.2).to(dev)
        packed = torch.from_numpy(rng.integers(0, 256, (n + 3) // 4)
                                  .astype(np.uint8)).to(dev)
        rec = out["by_size"][str(n)] = {}
        for route in routes:
            pieces = ROUTES[route](g, r, packed, n)
            for fn_name, parts in pieces.items():
                host = {p: _host_us(f, args.calls) for p, f in parts.items()}
                ev = _event_us(parts["whole call"], args.calls)
                rest = sum(v for p, v in host.items()
                           if p not in ("whole call", "wrapper",
                                        "stream object"))
                rec[f"{route} {fn_name}"] = {
                    "host_us": host, "event_us_whole_call": ev,
                    "sum_of_pieces_us": rest}
                print(f"n={n} {route} {fn_name}: whole call "
                      f"{host['whole call']:.2f} us host, {ev:.2f} us "
                      f"events; " + "; ".join(
                          f"{p} {v:.2f}" for p, v in host.items()
                          if p != "whole call")
                      + f" (pieces sum {rest:.2f})", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "codec_launch.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
