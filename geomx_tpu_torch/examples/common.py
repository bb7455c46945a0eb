"""The in-process geo-round both examples drive: every worker of the
topology in its own thread over the in-proc fabric, FSA or mixed sync,
the merge lanes, global optimizer and codec stage on the worker
device's torch backend."""

from __future__ import annotations

import threading
import time
from typing import Callable


def run_georound(args, dev, params, grad_fn, make_iter: Callable,
                 log: Callable, fsa: bool = True,
                 step_log_fmt: str = "step {step:4d}  loss {loss:.4f}  "
                                     "acc {acc:.3f}") -> dict:
    """Train ``args.steps`` steps on ``args.parties`` × ``args.workers``
    workers plus ``args.global_servers`` global servers.  Rank 0 of party
    0 ships ``args.optimizer``/``args.lr`` to the global tier, rank 0 of
    each party sets ``args.compression`` on its server.
    ``make_iter(widx, num_workers)`` gives a worker's batches; worker
    (0, 0) logs each step through ``log`` with ``step_log_fmt``.

    Returns ``{"histories", "params", "sim_stats", "wan", "seconds"}``
    (``params``: worker 0's final weights).  The Simulation is shut down
    before returning; a worker's exception is raised here."""
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.training import run_worker

    cfg = Config(
        topology=Topology(num_parties=args.parties,
                          workers_per_party=args.workers,
                          num_global_servers=args.global_servers),
        sync_global_mode=fsa,
        compression=args.compression,
        bsc_ratio=args.bsc_ratio,
        merge_backend="torch:cpu" if dev.type == "cpu" else "torch",
    )
    num_all = cfg.topology.num_workers_total
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
            t0 = time.perf_counter()

            def step_log(step, loss, acc):
                if rank == 0 and party == 0:
                    log(step_log_fmt.format(step=step, loss=loss, acc=acc)
                        + f"  ({time.perf_counter() - t0:.2f}s)")

            outp: dict = {}
            hist = run_worker(kv, params, grad_fn,
                              make_iter(widx, num_all), args.steps,
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
