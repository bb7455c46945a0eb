"""The bf16 flash and block-attention kernels with one and with two
consumer warpgroups, at the shapes the port runs them, on one CUDA card.

    python -m geomx_tpu_torch.examples.time_flash_tiles [--kernels flash,block]

The launchers in ``csrc/flash_attention.cu`` and
``csrc/block_attention.cu`` choose the tile height by the grid
(``two_warpgroups`` in ``csrc/hopper_tiles.cuh``).  This script builds
two copies of each source into the kernel cache, one whose rule always
answers one consumer warpgroup (64-row tiles) and one that always
answers two (128-row tiles), holds each against the plain versions, and
reports, in the order one, two, two, one: for flash at each shape the
CUDA-event time of a forward and of a backward call (50 calls) and the
device time by kernel (``torch.profiler`` over 10 calls); for the block
kernel at the MFU config's ring hop the same for one call in each hop
geometry.  Writes
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
# (B, T, H, D) of the MFU config's ring hop at sp = 4, and its geometries
BLOCK_SHAPE = (4, 512, 16, 128)
BLOCK_GEOMETRIES = {"below": (512, 0), "diagonal": (0, 0), "above": (0, 512)}
ORDER = (1, 2, 2, 1)
_RULE = re.compile(r"inline bool two_warpgroups\(int B, int H, int n\) "
                   r"\{\n.*?\n\}", re.S)


def variant(mod, nwg: int):
    """An ``NvccLibrary`` of the source of kernel module ``mod`` (its
    ``LIB``), built beside a copy of the headers whose rule always takes
    ``nwg`` consumer warpgroups."""
    from geomx_tpu_torch.utils.build import NvccLibrary

    src = Path(mod.LIB.source)
    d = mod.KERNEL_CACHE / f"tiles_{src.stem}_nwg{nwg}"
    d.mkdir(parents=True, exist_ok=True)
    hits = 0
    for h in src.parent.glob("*.cuh"):
        text, n = _RULE.subn(
            "inline bool two_warpgroups(int, int, int) { return "
            f"{'true' if nwg == 2 else 'false'}; }}", h.read_text())
        (d / h.name).write_text(text)
        hits += n
    if hits != 1:
        raise RuntimeError(f"two_warpgroups not found once in the headers "
                           f"beside {src}")
    shutil.copy(src, d / src.name)
    return NvccLibrary(d / src.name, d / Path(mod.LIB.library).name,
                       mod._bind)


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
        FK.LIB = LIBS["flash", nwg]
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


def measure_block() -> dict:
    """Each block-kernel variant at :data:`BLOCK_SHAPE` in bf16, in
    :data:`ORDER`, in each of :data:`BLOCK_GEOMETRIES`."""
    import torch

    from geomx_tpu_torch.ops import block_attention as BA
    from geomx_tpu_torch.ops.kernels import block_attention as KB

    rng = np.random.default_rng(sum(BLOCK_SHAPE))
    q, k, v = (torch.from_numpy(
        rng.standard_normal(BLOCK_SHAPE).astype(np.float32))
        .to("cuda", torch.bfloat16) for _ in range(3))
    refs = {g: BA.block_attention_ref(q, k, v, offs, True)
            for g, offs in BLOCK_GEOMETRIES.items()}
    runs = []
    for nwg in ORDER:
        KB.LIB = LIBS["block", nwg]
        rec = {"nwg": nwg}
        for geo, offs in BLOCK_GEOMETRIES.items():
            m, l, o = KB.block_attn_fwd(q, k, v, offs, True)
            rm, rl, ro = refs[geo]
            live = rm > -1e29                  # m of a fully masked row
            rel = max(_rel_l2(l, rl), _rel_l2(o, ro),
                      _rel_l2(m[live], rm[live]) if live.any() else 0.0)
            if rel > 1e-2:
                raise AssertionError(f"block {geo} nwg={nwg}: rel L2 {rel}")
            fn = (lambda offs=offs: KB.block_attn_fwd(q, k, v, offs, True))
            rec[geo] = {"rel_l2": rel, "ms": _time_ms(fn, 50),
                        "device_ms": _device_ms_by_kernel(fn)}
            print(f"block {BLOCK_SHAPE} {geo} nwg={nwg}: {rec[geo]['ms']:.4f}"
                  f" ms (events); device "
                  f"{sum(rec[geo]['device_ms'].values()):.4f} ms; worst rel "
                  f"L2 {rel:.2e}", flush=True)
        runs.append(rec)
    return {"shape": list(BLOCK_SHAPE), "runs": runs}


LIBS: dict = {}


def main(argv=None) -> int:
    import argparse

    import torch

    from geomx_tpu_torch.ops.kernels import block_attention as KB
    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="flash,block",
                    help="comma-separated: flash, block")
    kernels = ap.parse_args(argv).kernels.split(",")
    mods = {"flash": FK, "block": KB}
    if not torch.cuda.is_available():
        print("time_flash_tiles: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    defaults = {name: mods[name].LIB for name in kernels}
    LIBS.update({(name, nwg): variant(mods[name], nwg)
                 for name in kernels for nwg in (1, 2)})
    with ThreadPoolExecutor(max_workers=len(LIBS)) as pool:   # nvcc at once
        list(pool.map(lambda lib: lib.load(), LIBS.values()))
    report = {"nvidia_smi": smi}
    try:
        if "flash" in kernels:
            report["by_shape"] = [measure(s) for s in SHAPES]
        if "block" in kernels:
            report["block"] = measure_block()
    finally:
        for name, lib in defaults.items():
            mods[name].LIB = lib
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_tiles.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
