"""Geo-distributed CNN training on PyTorch — the port's counterpart of
the JAX package's ``examples/cnn.py``.

Runs the full HiPS topology (parties × workers + global tier) in one
process over the in-proc fabric, one thread per worker, FSA sync.  The
merge lanes, the global optimizer and the WAN codec stage run on the
torch backend of ``--device`` (CUDA unless ``--device cpu``); 2-bit and
BSC push compression run the Triton codec kernels on CUDA.

Examples:
    python -m geomx_tpu_torch.examples.cnn --parties 2 --workers 2 --steps 20
    python -m geomx_tpu_torch.examples.cnn --compression 2bit
    python -m geomx_tpu_torch.examples.cnn --compression bsc --bsc-ratio 0.01
    python -m geomx_tpu_torch.examples.cnn --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
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
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import ShardedIterator, synthetic_classification
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.models import create_model_state
    from geomx_tpu_torch.training import run_worker

    dev = resolve_device(args.device)
    cfg = Config(
        topology=Topology(num_parties=args.parties,
                          workers_per_party=args.workers,
                          num_global_servers=args.global_servers),
        sync_global_mode=True,
        compression=args.compression,
        bsc_ratio=args.bsc_ratio,
        merge_backend="torch:cpu" if dev.type == "cpu" else "torch",
    )
    x, y = synthetic_classification(n=4096, seed=args.seed)
    num_all = cfg.topology.num_workers_total
    _, params, grad_fn = create_model_state(
        "cnn", args.seed, input_shape=(1, 28, 28, 1), device=dev)

    sim = Simulation(cfg)
    histories = {}
    final: dict = {}
    errors = []
    lock = threading.Lock()
    t_start = time.perf_counter()

    def worker_main(party, rank, widx):
        try:
            kv = sim.worker(party, rank)
            if rank == 0:
                # rank 0 of each party configures its party's server;
                # one worker ships the optimizer to the global tier
                if party == 0:
                    kv.set_optimizer({"type": args.optimizer,
                                      "lr": args.lr})
                if args.compression != "none":
                    kv.set_gradient_compression(
                        {"type": args.compression,
                         "ratio": args.bsc_ratio})
            kv.barrier()
            it = ShardedIterator(x, y, args.batch, widx, num_all,
                                 seed=args.seed)
            t0 = time.perf_counter()

            def step_log(step, loss, acc):
                if rank == 0 and party == 0:
                    log(f"step {step:4d}  loss {loss:.4f}  acc {acc:.3f}  "
                        f"({time.perf_counter() - t0:.2f}s)")

            outp: dict = {}
            hist = run_worker(kv, params, grad_fn, it, args.steps,
                              log_fn=step_log, params_out=outp)
            with lock:
                histories[(party, rank)] = hist
                if widx == 0:
                    final["params"] = outp.get("params")
        except BaseException as e:  # surfaced after join, not swallowed
            with lock:
                errors.append(e)

    threads = []
    widx = 0
    for p in range(args.parties):
        for r in range(args.workers):
            t = threading.Thread(target=worker_main, args=(p, r, widx),
                                 daemon=True)
            t.start()
            threads.append(t)
            widx += 1
    try:
        for t in threads:
            t.join()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t_start
        if errors:
            raise errors[0]
        stats = {"local": [ls.stats() for ls in sim.local_servers],
                 "global": [gs.stats() for gs in sim.global_servers]}
        wan = sim.wan_bytes()
    finally:
        sim.shutdown()
    return {"histories": histories, "params": final.get("params"),
            "sim_stats": stats, "wan": wan, "seconds": seconds}


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
