"""Geo-distributed language-model training on PyTorch — the port's
counterpart of the JAX package's ``examples/lm.py``.

The flagship transformer (``models/transformer.py``) trains through the
full HiPS topology (parties × workers + global tier) in one process
over the in-proc fabric, one thread per worker.  Worker compute, the
merge lanes, the global optimizer and the WAN codec stage run on
``--device`` (CUDA unless ``--device cpu``); ``--attn-impl flash`` runs
attention on the hand CUDA flash-attention kernels, 2-bit and BSC push
compression the CUDA C++ codec kernels.  ``--moe-top-k K`` makes every
2nd layer a top-k routed MoE of ``--experts`` experts, trained with the
load-balancing aux loss.

Examples:
    python -m geomx_tpu_torch.examples.lm --parties 2 --workers 2 --steps 20
    python -m geomx_tpu_torch.examples.lm --attn-impl flash \\
        --compute-dtype bfloat16 --compression 2bit
    python -m geomx_tpu_torch.examples.lm --moe-top-k 2 --experts 4
    python -m geomx_tpu_torch.examples.lm --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--workers", type=int, default=1,
                    help="workers per party")
    ap.add_argument("--global-servers", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=256)
    ap.add_argument("--moe-top-k", type=int, default=0,
                    help=">0 turns every 2nd layer into a top-k routed "
                         "MoE (parallel/moe.py)")
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adam",
                    choices=["sgd", "adam", "dcasgd"])
    ap.add_argument("--sync", default="fsa", choices=["fsa", "mixed"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "fp16", "2bit", "bsc", "mpq"])
    ap.add_argument("--bsc-ratio", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", default="fast",
                    choices=["dense", "fast", "flash"],
                    help="single-device attention (TransformerConfig."
                         "attn_impl)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="activation dtype (params stay float32)")
    return ap


def train(args, log=print, make_iter=None) -> dict:
    """Run one training job; returns ``{"histories", "params",
    "n_params", "cfg", "sim_stats", "wan", "seconds"}`` (``cfg``: the
    ``TransformerConfig`` trained).  ``make_iter(widx, num_workers)``
    replaces each worker's batches (default: its shard of the synthetic
    token chain).  The Simulation is shut down before returning."""
    import torch

    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import TokenIterator, synthetic_lm
    from geomx_tpu_torch.examples.common import run_georound
    from geomx_tpu_torch.models.transformer import (
        TransformerConfig, create_lm_state)

    dev = resolve_device(args.device)
    use_moe = args.moe_top_k > 0
    mcfg = TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers, d_ff=args.d_ff, max_seq=args.seq,
        moe_every=2 if use_moe else 0, n_experts=args.experts,
        moe_top_k=args.moe_top_k,
        compute_dtype=getattr(torch, args.compute_dtype),
        attn_impl=args.attn_impl)
    params, grad_fn = create_lm_state(mcfg, seed=args.seed, device=dev)
    tokens = synthetic_lm(n=2048, seq=args.seq, vocab=args.vocab,
                          seed=args.seed)
    if make_iter is None:
        def make_iter(widx, num_all):
            return TokenIterator(tokens, args.batch, widx, num_all,
                                 seed=args.seed)
    out = run_georound(
        args, dev, params, grad_fn, make_iter, log, fsa=args.sync == "fsa",
        step_log_fmt="step {step:4d}  loss {loss:.4f}  next-tok acc "
                     "{acc:.3f}")
    out["n_params"] = sum(t.numel() for t in params.values())
    out["cfg"] = mcfg
    return out


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    out = train(args)
    hist = out["histories"]
    first = np.mean([h[0][0] for h in hist.values()])
    last = np.mean([h[-1][0] for h in hist.values()])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"(uniform = {np.log(args.vocab):.2f}); WAN bytes/step "
          f"{out['wan']['wan_send_bytes'] / max(args.steps, 1):.0f}; "
          f"{args.steps / out['seconds']:.2f} steps/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
