"""Where the time of a geo-round goes on the card.

Runs the workload's ``train`` (:mod:`geomx_tpu_torch.examples.cnn`, or
:mod:`geomx_tpu_torch.examples.lm` at the flagship LM's full width with
flash attention in bf16) once to build the kernels and warm the
libraries, then at a short and a long step count,
each twice: once plain (wall time from ``train``'s own ``seconds``) and
once under ``torch.profiler`` (device time by kernel).  Every figure is
the long run minus the short one, divided by the difference in steps,
so set-up, the first barrier and shutdown cancel and what is left is a
steady-state step.  Reports wall time per step, device time by kernel
and by group (worker compute, the 2-bit codec kernels, the DGC update,
BSC's top-k, optimizer and merge arithmetic, flash attention,
host↔device copies), and the device's
idle share
(1 − device time / wall time, both per steady step; device time above
wall time is an error, not a zero).

    python -m geomx_tpu_torch.examples.profile_georound --compression 2bit
    python -m geomx_tpu_torch.examples.profile_georound --compression bsc \\
        --steps 40
    python -m geomx_tpu_torch.examples.profile_georound --workload lm \\
        --steps 13 --short-steps 3

Writes the report to
``chiprun_out/profile_<workload>_<compression>.json``
(under the current directory) and prints a summary.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the kernels of csrc/quantize.cu, by their (demangled) names
CODEC_KERNELS = ("quant_consecutive", "quant_strided")   # also dequant_*
DGC_KERNELS = ("dgc_update<",)
FLASH_KERNELS = ("fwd_f32_tc_kernel<", "delta_kernel<",
                 "dkdv_f32_tc_kernel<", "dq_f32_tc_kernel<", "fwd_tc_kernel<",
                 "dkdv_tc_kernel<", "dq_tc_kernel<")
# the flagship LM (training.build_flagship_lm's widths), as chip_smoke.py
# drives it
LM_FLAGS = ["--vocab", "8192", "--d-model", "384", "--layers", "4",
            "--heads", "6", "--d-ff", "1536", "--seq", "128",
            "--attn-impl", "flash", "--compute-dtype", "bfloat16",
            "--lr", "3e-3"]


def _group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in DGC_KERNELS):
        return "dgc_update"
    if any(k in name for k in CODEC_KERNELS):
        return "codec_kernels"
    if any(k in name for k in FLASH_KERNELS):
        return "flash_attention"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(s in low for s in ("conv", "gemm", "cutlass", "sm80", "sm90",
                              "nvjet", "gemv", "splitk",
                              "wgrad", "dgrad", "cudnn", "xmma", "nhwc",
                              "max_pool", "softmax", "nll", "relu",
                              "gelu", "embedding", "index")):
        return "worker_compute"
    if "topk" in low or "sort" in low or "radix" in low:
        return "bsc_topk"
    return "elementwise_other"


def _device_us(evt) -> float:
    """The device time of a kernel's or copy's entry; 0 for a CPU op's,
    which carries the time of the kernels it launched and would count
    them twice."""
    from torch.autograd import DeviceType

    if evt.device_type == DeviceType.CPU:
        return 0.0
    return float(evt.self_device_time_total)


def _example(a):
    from geomx_tpu_torch.examples import cnn, lm

    return {"cnn": cnn, "lm": lm}[a.workload]


def _train_args(a, steps: int):
    flags = (["--workers", "2", *LM_FLAGS] if a.workload == "lm"
             else ["--lr", "0.001"])
    return _example(a).build_parser().parse_args(
        ["--compression", a.compression, "--steps", str(steps),
         "--batch", str(a.batch), "--optimizer", "adam", *flags])


def _run(a, steps: int) -> tuple:
    """(wall seconds of a plain run, device µs by kernel of a profiled
    run, WAN bytes sent) at ``steps`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    train = _example(a).train
    args = _train_args(a, steps)
    plain = train(args, log=lambda *_: None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train(args, log=lambda *_: None)
        torch.cuda.synchronize()
    by_kernel: dict = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    return plain["seconds"], by_kernel, plain["wan"]["wan_send_bytes"]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="cnn", choices=["cnn", "lm"])
    ap.add_argument("--compression", default="2bit",
                    choices=["none", "fp16", "2bit", "bsc", "mpq"])
    ap.add_argument("--steps", type=int, default=30,
                    help="steps of the long run")
    ap.add_argument("--short-steps", type=int, default=5,
                    help="steps of the short run subtracted from it")
    ap.add_argument("--batch", type=int, default=None,
                    help="per worker (default: 32 for the CNN, 8 for "
                         "the LM)")
    a = ap.parse_args(argv)
    if a.batch is None:
        a.batch = 8 if a.workload == "lm" else 32
    if a.steps <= a.short_steps:
        ap.error("--steps must exceed --short-steps")
    if not torch.cuda.is_available():
        print("profile_georound: no CUDA device", file=sys.stderr)
        return 2
    _example(a).train(_train_args(a, a.short_steps),
                      log=lambda *_: None)  # warm up
    wall_s, dev_s, wan_s = _run(a, a.short_steps)
    wall_l, dev_l, wan_l = _run(a, a.steps)
    d = a.steps - a.short_steps
    wall = (wall_l - wall_s) / d                       # s per steady step
    by_kernel = {k: (dev_l.get(k, 0.0) - dev_s.get(k, 0.0)) / d
                 for k in set(dev_l) | set(dev_s)}     # µs per step
    groups: dict = {}
    for name, us in by_kernel.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + us
    device = sum(by_kernel.values()) / 1e6             # s per steady step
    if not 0.0 < device <= wall:
        raise RuntimeError(
            f"device time per step {device * 1e3:.3f} ms against wall "
            f"{wall * 1e3:.3f} ms: the difference of the two runs is not "
            "a steady step (raise --steps)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    report = {
        "nvidia_smi": smi, "workload": a.workload,
        "compression": a.compression,
        "steps": a.steps, "short_steps": a.short_steps, "batch": a.batch,
        "wall_s": {"short": wall_s, "long": wall_l},
        "wall_ms_per_step": wall * 1e3,
        "device_ms_per_step": device * 1e3,
        "device_idle_share": 1.0 - device / wall,
        "groups_ms_per_step": {g: us / 1e3
                               for g, us in sorted(groups.items())},
        "top_kernels_ms_per_step": {
            k: us / 1e3 for k, us in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:15]},
        "wan_bytes_per_step": (wan_l - wan_s) / d,
    }
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out",
                        f"profile_{a.workload}_{a.compression}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in (
        "nvidia_smi", "workload", "compression", "wall_ms_per_step",
        "device_ms_per_step", "device_idle_share", "groups_ms_per_step",
        "wan_bytes_per_step")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
