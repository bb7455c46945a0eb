"""Geo-distributed CNN training on PyTorch — the port's counterpart of
the JAX package's ``examples/cnn.py``, with its flags.

Runs the full HiPS topology (parties × workers + global tier) in one
process over the in-proc fabric, one thread per worker: FSA or mixed
sync, HFA or ESync, P3, TSEngine and DGT as the JAX example sets them.
Worker compute, the merge lanes, the global optimizer (or, under HFA,
the milestone delta) and the WAN codec stage run on ``--device`` (CUDA
unless ``--device cpu``); 2-bit and BSC push compression run the CUDA
C++ codec kernels on CUDA.

Examples:
    python -m geomx_tpu_torch.examples.cnn --parties 2 --workers 2 --steps 20
    python -m geomx_tpu_torch.examples.cnn --compression bsc --bsc-ratio 0.01
    python -m geomx_tpu_torch.examples.cnn --sync mixed --optimizer dcasgd
    python -m geomx_tpu_torch.examples.cnn --hfa --hfa-k2 4
    python -m geomx_tpu_torch.examples.cnn --esync --steps 4
    python -m geomx_tpu_torch.examples.cnn --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from geomx_tpu_torch.models import MODEL_REGISTRY


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
                    choices=["sgd", "nag", "adam", "dcasgd"],
                    help="the global tier's optimizer; dcasgd (delay-"
                         "compensated async SGD) has no device optimizer and "
                         "runs on the server's host, as in the JAX package")
    ap.add_argument("--model", default="cnn", choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--sync", default="fsa", choices=["fsa", "mixed"],
                    help="fsa = both tiers sync; mixed = async global tier")
    ap.add_argument("--compression", default="none",
                    choices=["none", "fp16", "2bit", "bsc", "mpq"])
    ap.add_argument("--bsc-ratio", type=float, default=0.01)
    ap.add_argument("--p3", action="store_true",
                    help="priority-based parameter propagation (sliced "
                         "sends + piggybacked pulls)")
    ap.add_argument("--tsengine", action="store_true",
                    help="TSEngine overlay dissemination (intra-party)")
    ap.add_argument("--tsengine-inter", action="store_true",
                    help="TSEngine WAN overlay (global servers -> local "
                         "servers replaces the FSA pull-down)")
    ap.add_argument("--tsengine-inter-push", action="store_true",
                    help="TSEngine WAN push overlay: local servers "
                         "pair-merge before one elected server pushes up "
                         "(implies --tsengine-inter)")
    ap.add_argument("--dgt", type=int, default=0, choices=[0, 1, 2, 3],
                    help="DGT transport mode (1=lossy channels, 2=reliable, "
                         "3=reliable+4bit requant)")
    ap.add_argument("--hfa", action="store_true",
                    help="hierarchical frequency aggregation: local Adam "
                         "steps, weights averaged in the party every k1 "
                         "steps and across the WAN every k2 party syncs")
    ap.add_argument("--hfa-k1", type=int, default=2,
                    help="local steps between party syncs")
    ap.add_argument("--hfa-k2", type=int, default=2,
                    help="party syncs between WAN syncs")
    ap.add_argument("--esync", action="store_true",
                    help="ESync straggler balancing: the party's state "
                         "server assigns per-worker local step counts "
                         "(implies HFA-style weight exchange; --steps "
                         "counts sync rounds)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="train from a record-IO dataset file (written on "
                         "first use from the synthetic data) through the "
                         "record reader, augmentation and threaded "
                         "prefetch")
    ap.add_argument("--mnist", metavar="DIR", default=None,
                    help="train on MNIST idx files from DIR (train-images-"
                         "idx3-ubyte[.gz] etc.); prints the held-out t10k "
                         "accuracy at the end when the test files are "
                         "there")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (default) or cpu")
    return ap


def config_fields(args) -> dict:
    """The ``Config`` fields the flags set, as the JAX example sets
    them."""
    return dict(
        use_hfa=args.hfa or args.esync,
        hfa_k2=args.hfa_k2,
        enable_p3=args.p3,
        p3_slice_elems=50_000,
        enable_intra_ts=args.tsengine,
        enable_inter_ts=args.tsengine_inter or args.tsengine_inter_push,
        enable_inter_ts_push=args.tsengine_inter_push,
        enable_dgt=args.dgt,
    )


def _mnist_file(root: str, stem: str) -> Optional[str]:
    for name in (stem, stem + ".gz", stem.replace("-idx", ".idx"),
                 stem.replace("-idx", ".idx") + ".gz"):
        p = Path(root) / name
        if p.exists():
            return str(p)
    return None


def _read_mnist(root: str, split: str):
    """``(x f32 [N, 28, 28, 1] in [0, 1], y int32)`` of an MNIST split
    (``train`` or ``t10k``), or None if its files are missing."""
    from geomx_tpu_torch.data import MNISTIter

    ti = _mnist_file(root, f"{split}-images-idx3-ubyte")
    tl = _mnist_file(root, f"{split}-labels-idx1-ubyte")
    if ti is None or tl is None:
        return None
    x = MNISTIter._read_idx(ti).astype(np.float32) / 255.0
    if x.ndim == 3:
        x = x[..., None]
    return x, MNISTIter._read_idx(tl).astype(np.int32)


def train(args, log=print) -> dict:
    """Run one training job; returns ``{"histories", "params",
    "final_params", "sim_stats", "wan", "seconds"}``, and
    ``"t10k_accuracy"`` under ``--mnist`` when the test files are there.
    The Simulation is shut down before returning."""
    import torch

    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import ShardedIterator, synthetic_classification
    from geomx_tpu_torch.examples.common import run_georound
    from geomx_tpu_torch.models import create_model_state

    if args.mnist and args.record:
        raise ValueError("--mnist and --record are mutually exclusive")
    dev = resolve_device(args.device)
    if args.mnist:
        # decoded once and shared by every worker thread
        train_set = _read_mnist(args.mnist, "train")
        if train_set is None:
            raise FileNotFoundError(
                f"--mnist {args.mnist}: train idx files not found")
        x, y = train_set
    else:
        x, y = synthetic_classification(n=4096, seed=args.seed)
    if args.record and not Path(args.record).exists():
        from geomx_tpu_torch.data import write_array_dataset

        write_array_dataset(args.record, x, y)
        log(f"wrote record dataset: {args.record}")
    model, params, grad_fn = create_model_state(
        args.model, args.seed, input_shape=(1, 28, 28, 1), device=dev)

    def make_iter(widx, num_all):
        if args.record:
            from geomx_tpu_torch.data import (AugmentIter, PrefetchIter,
                                              RecordDatasetIter)

            return PrefetchIter(AugmentIter(
                RecordDatasetIter(args.record, args.batch, widx, num_all,
                                  seed=args.seed),
                flip=True, seed=args.seed + widx))
        return ShardedIterator(x, y, args.batch, widx, num_all,
                               seed=args.seed)

    out = run_georound(
        args, dev, params, grad_fn, make_iter, log,
        fsa=args.sync == "fsa",
        loop="esync" if args.esync else "hfa" if args.hfa else "plain",
        hfa_k1=args.hfa_k1, config_fields=config_fields(args))
    test_set = _read_mnist(args.mnist, "t10k") if args.mnist else None
    if test_set is not None and out["params"] is not None:
        tx, ty = test_set
        with torch.no_grad():
            logits = model.apply(out["params"],
                                 torch.as_tensor(tx[:2048], device=dev))
        out["t10k_accuracy"] = float(np.mean(
            logits.argmax(-1).cpu().numpy() == ty[:2048]))
    return out


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    out = train(args)
    hist = out["histories"]
    final_acc = np.mean([hist[k][-1][1] for k in hist])
    print(f"final mean acc {final_acc:.3f}; WAN bytes/step "
          f"{out['wan']['wan_send_bytes'] / max(args.steps, 1):.0f}; "
          f"{args.steps / out['seconds']:.2f} steps/s")
    if "t10k_accuracy" in out:
        print(f"MNIST t10k accuracy (2048 held-out): "
              f"{out['t10k_accuracy']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
