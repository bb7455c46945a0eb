"""The in-process geo-round both examples drive: every worker of the
topology in its own thread over the in-proc fabric, FSA or mixed sync,
the plain, HFA or ESync worker loop, the merge lanes, global optimizer
and codec stage on the worker device's torch backend."""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

LOOPS = ("plain", "hfa", "esync")


def run_georound(args, dev, params, grad_fn, make_iter: Callable,
                 log: Callable, fsa: bool = True,
                 step_log_fmt: str = "step {step:4d}  loss {loss:.4f}  "
                                     "acc {acc:.3f}",
                 loop: str = "plain", hfa_k1: int = 2,
                 config_fields: Optional[dict] = None) -> dict:
    """Train on ``args.parties`` × ``args.workers`` workers plus
    ``args.global_servers`` global servers: ``args.steps`` steps of the
    ``loop`` — ``plain`` (gradients pushed every step), ``hfa`` (``hfa_k1``
    local steps a weight sync) or ``esync`` (``args.steps`` sync rounds,
    local steps a round as the state server plans them); both of the latter
    need ``use_hfa`` in ``config_fields``, the further ``Config`` fields.
    Rank 0 of party 0 ships ``args.optimizer``/``args.lr`` to the global
    tier, rank 0 of each party sets ``args.compression`` on its server.
    ``make_iter(widx, num_workers)`` gives a worker's batches (closed
    after the loop if it has ``close``); worker (0, 0) logs each step
    through ``log`` with ``step_log_fmt``.

    Returns ``{"histories", "params", "final_params", "sim_stats", "wan",
    "seconds"}`` (``params``: worker 0's final weights; ``final_params``:
    every worker's, by (party, rank)).  The Simulation is shut down
    before returning; a worker's exception is raised here."""
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.training import (run_worker, run_worker_esync,
                                          run_worker_hfa)

    if loop not in LOOPS:
        raise ValueError(f"loop {loop!r} not in {LOOPS}")
    cfg = Config(
        topology=Topology(num_parties=args.parties,
                          workers_per_party=args.workers,
                          num_global_servers=args.global_servers),
        sync_global_mode=fsa,
        compression=args.compression,
        bsc_ratio=args.bsc_ratio,
        merge_backend="torch:cpu" if dev.type == "cpu" else "torch",
        **(config_fields or {}),
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
            it = make_iter(widx, num_all)
            try:
                if loop == "esync":
                    hist = run_worker_esync(
                        kv, params, grad_fn, it, args.steps,
                        log_fn=step_log, params_out=outp)
                elif loop == "hfa":
                    hist = run_worker_hfa(kv, params, grad_fn, it,
                                          args.steps, k1=hfa_k1,
                                          log_fn=step_log, params_out=outp)
                else:
                    hist = run_worker(kv, params, grad_fn, it, args.steps,
                                      log_fn=step_log, params_out=outp)
            finally:
                if hasattr(it, "close"):
                    it.close()
            with lock:
                histories[(party, rank)] = hist
                final[(party, rank)] = outp.get("params")
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
    return {"histories": histories, "params": final.get((0, 0)),
            "final_params": final, "sim_stats": stats, "wan": wan,
            "seconds": seconds}
