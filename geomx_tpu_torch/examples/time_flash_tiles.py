"""The bf16 flash kernels with one and with two consumer warpgroups, at
the shapes the port runs them, on one CUDA card.

    python -m geomx_tpu_torch.examples.time_flash_tiles

The launchers in ``csrc/flash_attention.cu`` choose the tile height by
the grid (``two_warpgroups``).  This script builds two copies of that
source into the kernel cache, one whose rule always answers one
consumer warpgroup (64-row tiles) and one that always answers two
(128-row tiles), holds each against the plain versions, and reports at
each shape the CUDA-event time of a forward and of a backward call (50
calls) and the device time by kernel (``torch.profiler`` over 10 calls),
in the order one, two, two, one.  Writes
``chiprun_out/flash_tiles.json`` (under the current directory) and
prints the card's name and power limit.  Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# (B, T, H, Dh): the flagship LM's, the MFU config's, and T off the
# 128-row tile with few (b, h)
SHAPES = ((8, 128, 6, 64), (4, 2048, 16, 128), (1, 2047, 2, 128))
ORDER = (1, 2, 2, 1)
_RULE = re.compile(r"bool two_warpgroups\(int B, int H, int n\) \{\n"
                   r".*?\n\}", re.S)


def variant(nwg: int):
    """An ``NvccLibrary`` of the flash source whose launchers always take
    ``nwg`` consumer warpgroups."""
    from geomx_tpu_torch.ops.kernels import flash_attention as FK
    from geomx_tpu_torch.utils.build import NvccLibrary

    src = Path(FK.LIB.source)
    text, hits = _RULE.subn(
        "bool two_warpgroups(int, int, int) { return "
        f"{'true' if nwg == 2 else 'false'}; }}", src.read_text())
    if hits != 1:
        raise RuntimeError(f"two_warpgroups not found once in {src}")
    d = FK.KERNEL_CACHE / f"tiles_nwg{nwg}"
    d.mkdir(parents=True, exist_ok=True)
    for h in src.parent.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    (d / src.name).write_text(text)
    return NvccLibrary(d / src.name, d / "libflash_attention.so", FK._bind)


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """Device time (ms) a call of each kernel, over ``calls`` calls; only
    the device's own entries count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CPU and evt.self_device_time_total:
            out[evt.key] = (out.get(evt.key, 0.0)
                            + evt.self_device_time_total / 1e3 / calls)
    return out


def _rel_l2(got, ref) -> float:
    return float((got.double() - ref.double()).norm()
                 / ref.double().norm())


def measure(shape) -> dict:
    """Each variant at ``shape`` in bf16, in :data:`ORDER`."""
    import torch

    from geomx_tpu_torch.ops import flash_attention as FA
    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    rng = np.random.default_rng(sum(shape))
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
        .to("cuda", torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(shape[-1])
    ro, rlse = FA.flash_attention_ref(q, k, v, scale)
    refs = FA.flash_attention_bwd_ref(q, k, v, ro, rlse, do, scale)
    runs = []
    for nwg in ORDER:
        FK.LIB = LIBS[nwg]
        o, lse = FK.flash_fwd(q, k, v, scale)
        grads = FK.flash_bwd(q, k, v, o, lse, do, scale)
        rel = {n: _rel_l2(g, r) for n, g, r in zip(
            ("o", "lse", "dq", "dk", "dv"), (o, lse, *grads),
            (ro, rlse, *refs))}
        if max(rel.values()) > 1e-2:
            raise AssertionError(f"{shape} nwg={nwg}: rel L2 {rel}")
        rec = {
            "nwg": nwg, "rel_l2": rel,
            "fwd_ms": _time_ms(lambda: FK.flash_fwd(q, k, v, scale), 50),
            "bwd_ms": _time_ms(lambda: FK.flash_bwd(q, k, v, o, lse, do,
                                                    scale), 50),
            "fwd_device_ms": _device_ms_by_kernel(
                lambda: FK.flash_fwd(q, k, v, scale)),
            "bwd_device_ms": _device_ms_by_kernel(
                lambda: FK.flash_bwd(q, k, v, o, lse, do, scale)),
        }
        runs.append(rec)
        print(f"{shape} nwg={nwg}: fwd {rec['fwd_ms']:.4f} ms, bwd "
              f"{rec['bwd_ms']:.4f} ms (events); device fwd "
              f"{sum(rec['fwd_device_ms'].values()):.4f} ms, bwd "
              + "; ".join(f"{n.split('<')[0]} {t:.4f}"
                          for n, t in rec["bwd_device_ms"].items())
              + f" ms; worst rel L2 {max(rel.values()):.2e}", flush=True)
    return {"shape": list(shape), "runs": runs}


LIBS: dict = {}


def main() -> int:
    import torch

    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    if not torch.cuda.is_available():
        print("time_flash_tiles: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    default = FK.LIB
    LIBS.update({nwg: variant(nwg) for nwg in (1, 2)})
    with ThreadPoolExecutor(max_workers=2) as pool:   # nvcc in parallel
        list(pool.map(lambda lib: lib.load(), LIBS.values()))
    try:
        report = {"nvidia_smi": smi,
                  "by_shape": [measure(s) for s in SHAPES]}
    finally:
        FK.LIB = default
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_tiles.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
