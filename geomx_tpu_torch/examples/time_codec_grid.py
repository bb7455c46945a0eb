"""The CUDA 2-bit quantize and dequantize under other grid shapes, on one
CUDA card.

    python -m geomx_tpu_torch.examples.time_codec_grid [--variants 8,8:always,65536]

``csrc/quantize.cu`` sizes its grid to the work, one thread an item, at
most ``BLOCKS_PER_SM`` blocks an SM while the call's bytes fit in L2
(and past L2 too if ``CAP_PAST_L2``).  This script builds copies of the
source with other values of the two constants (``--variants``, each
``BLOCKS_PER_SM`` or ``BLOCKS_PER_SM:always``; 65536 blocks an SM
leaves the grid uncapped) into the kernel cache, holds each
copy bitwise against the plain versions, and reports each copy's device
time a call (``torch.profiler``, 10 calls) of the consecutive-layout
quantize and dequantize on aligned tensors at 401,408, 3,145,728 and
50,000,000 elements, the copies in the order given and then reversed.
Writes ``chiprun_out/codec_grid.json`` (under the current directory) and
prints the card's name and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

SIZES = (401_408, 3_145_728, 50_000_000)
THRESHOLD = 0.5
HBM_BYTES_PER_S = 3.35e12


def variant(blocks: int, always: bool):
    """An ``NvccLibrary`` of ``csrc/quantize.cu`` with the two constants
    set."""
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C
    from geomx_tpu_torch.utils.build import NvccLibrary

    src = Path(C.LIB.source)
    text = src.read_text()
    for decl, val in (("int BLOCKS_PER_SM", str(blocks)),
                      ("bool CAP_PAST_L2", "true" if always else "false")):
        text, hits = re.subn(rf"constexpr {decl} = \w+;",
                             f"constexpr {decl} = {val};", text)
        if hits != 1:
            raise RuntimeError(f"{decl} not found once in {src}")
    d = C.KERNEL_CACHE / f"grid_b{blocks}_{'always' if always else 'l2'}"
    d.mkdir(parents=True, exist_ok=True)
    (d / src.name).write_text(text)
    return NvccLibrary(d / src.name, d / "libquantize.so", C._bind)


def _device_ms(fn, calls: int = 10) -> float:
    """Device time (ms) a call of the kernels ``fn`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e3 / calls


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="8,8:always,65536")
    args = ap.parse_args(argv)
    import torch

    from geomx_tpu_torch.ops import quantize as Q

    VARIANTS = {v: (int(v.split(":")[0]), v.endswith(":always"))
                for v in args.variants.split(",")}

    if not torch.cuda.is_available():
        print("time_codec_grid: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    libs = {}
    for name, (blocks, always) in VARIANTS.items():
        lib = variant(blocks, always)
        lib.load()
        libs[name] = lib._lib
    out = {"nvidia_smi": smi, "variants": {k: list(v) for k, v in
                                           VARIANTS.items()},
           "device_ms": {}}
    for n in SIZES:
        rng = np.random.default_rng(n)
        g = torch.from_numpy((rng.standard_normal(n) * 0.4)
                             .astype(np.float32)).to(dev)
        r = torch.from_numpy((rng.standard_normal(n) * 0.2)
                             .astype(np.float32)).to(dev)
        ref_p, ref_r = Q.quantize_2bit_ref(g, r, THRESHOLD, "consecutive")
        ref_d = Q.dequantize_2bit_ref(ref_p, n, THRESHOLD, "consecutive")
        p = torch.empty_like(ref_p)
        r_out = torch.empty_like(r)
        d = torch.empty_like(r)

        def quant(lib):
            return lambda: lib.geo_quantize_2bit(
                g.data_ptr(), r.data_ptr(), p.data_ptr(), r_out.data_ptr(),
                n, THRESHOLD, 0, dev.index, stream)

        def dequant(lib):
            return lambda: lib.geo_dequantize_2bit(
                ref_p.data_ptr(), d.data_ptr(), n, THRESHOLD, 0, dev.index,
                stream)

        rec = out["device_ms"][str(n)] = {}
        order = list(VARIANTS) + list(reversed(VARIANTS))
        for name in order:
            lib = libs[name]
            assert quant(lib)() == 0 and dequant(lib)() == 0
            torch.cuda.synchronize()
            assert torch.equal(p, ref_p) and torch.equal(
                r_out.view(torch.int32), ref_r.view(torch.int32)), name
            assert torch.equal(d.view(torch.int32),
                               ref_d.view(torch.int32)), name
            for fn, mk in (("quantize_2bit", quant),
                           ("dequantize_2bit", dequant)):
                ms = _device_ms(mk(lib))
                rec.setdefault(name, {}).setdefault(fn, []).append(ms)
        for name, fns in rec.items():
            nbytes = {"quantize_2bit": 12 * n + (n + 3) // 4,
                      "dequantize_2bit": 4 * n + (n + 3) // 4}
            print(f"n={n} {name}: " + "; ".join(
                f"{fn} " + ", ".join(f"{t:.5f}" for t in ts) + " ms ("
                + ", ".join(f"{100 * nbytes[fn] / HBM_BYTES_PER_S / (t * 1e-3):.1f}"
                            for t in ts) + " % of 3.35 TB/s)"
                for fn, ts in fns.items()), flush=True)
        del g, r, ref_p, ref_r, ref_d, p, r_out, d
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "codec_grid.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
