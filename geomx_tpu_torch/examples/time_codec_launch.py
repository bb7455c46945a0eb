"""Where the host time of one codec kernel call goes, on one CUDA card.

    python -m geomx_tpu_torch.examples.time_codec_launch
        [--sizes 384,401408] [--calls 10000]

At the codec stage's key sizes a quantize, dequantize or DGC update
call costs more on the host than on the card.  This script times the
whole call and each piece of it with ``time.perf_counter`` over
``--calls`` back-to-back calls (three rounds, the median kept), on
tensors on the card, for the CUDA kernels of ``csrc/quantize.cu``
through ``ops/kernels/quantize_cuda.py`` (quantize and dequantize in
the consecutive layout; the DGC update out of place, and in place as
the codec stage calls it, ``out`` = its inputs): the dispatcher's route
test, the wrapper's checks (for the DGC update in place also the
overlap checks), the allocations, the current stream's raw handle (and,
beside it, ``torch.cuda.current_stream(dev).cuda_stream``, which the
wrapper does not call), the ``ctypes`` call alone (outputs made
beforehand) and the counter.

Each piece runs alone in its own loop, so the pieces need not add up to
the whole; the sum is printed beside it.  The whole call is also timed
with CUDA events over the same loop.  Writes
``chiprun_out/codec_launch.json`` (under the current directory) and
prints the card's name and power limit.  Needs a CUDA card and ``nvcc``.
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
MOMENTUM = 0.9
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


def cuda_pieces(g, r, packed, n: int) -> dict:
    """{function: {piece: callable}} of the CUDA kernels."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    t = Q._f32(THRESHOLD)
    lib = C.LIB.load()
    nb = (n + 3) // 4
    p_out = torch.empty(nb, dtype=torch.uint8, device=g.device)
    r_out = torch.empty_like(r)
    d_out = torch.empty(n, dtype=torch.float32, device=g.device)
    m = Q._f32(MOMENTUM)
    v = r * 3.0
    v_out, u_out = torch.empty_like(v), torch.empty_like(r)
    vi, ui = v.clone(), r.clone()     # updated in place, call after call
    named = (("velocity", vi), ("accum", ui), ("grad", g), ("v_out", vi),
             ("u_out", ui))
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
        "dgc_update": {
            "whole call": lambda: Q.dgc_update(v, r, g, MOMENTUM),
            "wrapper": lambda: C.dgc_update(v, r, g, m),
            "dispatcher checks": lambda: g.is_cuda,
            "tensor checks": lambda: C._check_f32(
                ("velocity", v), ("accum", r), ("grad", g)),
            "allocations": lambda: (
                torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.float32, device=dev)),
            "stream handle": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index),
            "ctypes call": lambda: lib.geo_dgc_update(
                v.data_ptr(), r.data_ptr(), g.data_ptr(), v_out.data_ptr(),
                u_out.data_ptr(), n, m, dev.index, stream),
            "lock and counter": count("dgc_update"),
        },
        "dgc_update in place": {
            "whole call": lambda: Q.dgc_update(vi, ui, g, MOMENTUM,
                                               out=(vi, ui)),
            "wrapper": lambda: C.dgc_update(vi, ui, g, m, out=(vi, ui)),
            "dispatcher checks": lambda: g.is_cuda,
            "tensor checks": lambda: C._check_f32(*named),
            "overlap checks": lambda: C._refuse_overlap(named, n),
            "stream handle": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index),
            "ctypes call": lambda: lib.geo_dgc_update(
                vi.data_ptr(), ui.data_ptr(), g.data_ptr(), vi.data_ptr(),
                ui.data_ptr(), n, m, dev.index, stream),
            "lock and counter": count("dgc_update"),
        },
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
        for fn_name, parts in cuda_pieces(g, r, packed, n).items():
            host = {p: _host_us(f, args.calls) for p, f in parts.items()}
            ev = _event_us(parts["whole call"], args.calls)
            rest = sum(v for p, v in host.items()
                       if p not in ("whole call", "wrapper",
                                    "stream object"))
            rec[fn_name] = {"host_us": host, "event_us_whole_call": ev,
                            "sum_of_pieces_us": rest}
            print(f"n={n} {fn_name}: whole call {host['whole call']:.2f} us "
                  f"host, {ev:.2f} us events; " + "; ".join(
                      f"{p} {v:.2f}" for p, v in host.items()
                      if p != "whole call")
                  + f" (pieces sum {rest:.2f})", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "codec_launch.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
