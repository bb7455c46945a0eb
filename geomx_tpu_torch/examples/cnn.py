"""Geo-distributed CNN training on PyTorch — the port's counterpart of
the JAX package's ``examples/cnn.py``.

Runs the full HiPS topology (parties × workers + global tier) in one
process over the in-proc fabric, one thread per worker, FSA sync.  The
merge lanes, the global optimizer and the WAN codec stage run on the
torch backend of ``--device`` (CUDA unless ``--device cpu``); 2-bit and
BSC push compression run the CUDA C++ codec kernels on CUDA.

Examples:
    python -m geomx_tpu_torch.examples.cnn --parties 2 --workers 2 --steps 20
    python -m geomx_tpu_torch.examples.cnn --compression 2bit
    python -m geomx_tpu_torch.examples.cnn --compression bsc --bsc-ratio 0.01
    python -m geomx_tpu_torch.examples.cnn --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--workers", type=int, default=2,
                    help="workers per party")
    ap.add_argument("--global-servers", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--optimizer", default="adam",
                    choices=["sgd", "nag", "adam"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "fp16", "2bit", "bsc", "mpq"])
    ap.add_argument("--bsc-ratio", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (default) or cpu")
    return ap


def train(args, log=print) -> dict:
    """Run one training job; returns ``{"histories", "params", "sim_stats",
    "wan", "seconds"}``.  The Simulation is shut down before returning."""
    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import ShardedIterator, synthetic_classification
    from geomx_tpu_torch.examples.common import run_georound
    from geomx_tpu_torch.models import create_model_state

    dev = resolve_device(args.device)
    x, y = synthetic_classification(n=4096, seed=args.seed)
    _, params, grad_fn = create_model_state(
        "cnn", args.seed, input_shape=(1, 28, 28, 1), device=dev)
    return run_georound(
        args, dev, params, grad_fn,
        lambda widx, num_all: ShardedIterator(x, y, args.batch, widx,
                                              num_all, seed=args.seed),
        log)


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    out = train(args)
    hist = out["histories"]
    final_acc = np.mean([hist[k][-1][1] for k in hist])
    print(f"final mean acc {final_acc:.3f}; WAN bytes/step "
          f"{out['wan']['wan_send_bytes'] / max(args.steps, 1):.0f}; "
          f"{args.steps / out['seconds']:.2f} steps/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
