"""Distributed-tracing demo — the port's counterpart of the JAX
package's ``scripts/run_trace_demo.sh``.

A short in-proc HiPS simulation (2 parties × 2 workers, 1 global
server) with ``trace_sample_every=1`` trains the demo CNN (8 × 8 × 1
inputs) for 4 steps, the CNN on ``--device`` and the servers' merge,
optimizer and codec stages on the torch backend there.  Asserts what
the JAX script asserts: the merged trace is non-empty, spans from at
least the worker, server and global-server roles, no span's parent is
missing, and the critical-path report names a dominant stage in every
round.  Prints the report and writes ``geomx_trace.json`` (for
chrome://tracing or https://ui.perfetto.dev) and
``geomx_trace_report.json`` into ``--out``.

    python -m geomx_tpu_torch.examples.trace_demo --device cpu --out DIR
    python -m geomx_tpu_torch.examples.trace_demo          # on the card
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading

STEPS = 4


def run(device: str, out_dir: str, steps: int = STEPS) -> dict:
    """Run the demo; returns ``{"events", "roles", "rounds", "report",
    "report_text"}`` after its assertions hold."""
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import ShardedIterator, synthetic_classification
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.models import create_cnn_state
    from geomx_tpu_torch.training import run_worker

    dev = resolve_device(device)
    backend = "torch:cpu" if dev.type == "cpu" else "torch"
    os.makedirs(out_dir, exist_ok=True)
    sim = Simulation(Config(topology=Topology(num_parties=2,
                                              workers_per_party=2),
                            trace_sample_every=1, merge_backend=backend))
    try:
        ws = sim.all_workers()
        ws[0].set_optimizer({"type": "sgd", "lr": 0.05})
        x, y = synthetic_classification(n=256, shape=(8, 8, 1), seed=0)
        _, params, grad_fn = create_cnn_state(
            seed=0, input_shape=(1, 8, 8, 1), compute_dtype=torch.float32,
            device=dev)
        ths = [threading.Thread(target=run_worker, args=(
            kv, params, grad_fn,
            ShardedIterator(x, y, 16, i, len(ws)), steps),
            kwargs={"barrier_init": False}) for i, kv in enumerate(ws)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(240)
        assert not any(t.is_alive() for t in ths), "training hung"

        n = sim.flush_traces()
        assert n > 0, "merged trace is EMPTY"
        trace = sim.dump_trace(os.path.join(out_dir, "geomx_trace.json"))
        evs = trace["traceEvents"]
        roles = {e["pid"].split(":")[0] for e in evs}
        assert {"worker", "server", "global_server"} <= roles, roles
        ids = {e["args"]["span"] for e in evs}
        dangling = [e for e in evs
                    if e["args"]["parent"] and e["args"]["parent"] not in ids]
        assert not dangling, f"{len(dangling)} dangling parent edges"
        report = sim.trace_report()
        assert report["rounds"], "critical-path report has no rounds"
        for r in report["rounds"]:
            assert r["dominant_stage"], r
        with open(os.path.join(out_dir, "geomx_trace_report.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
        text = sim.trace_collector.report_text()
        return {"events": len(evs), "roles": sorted(roles),
                "rounds": len(report["rounds"]), "report": report,
                "report_text": text}
    finally:
        sim.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.environ.get("GEOMX_TRACE_DIR") or None,
                    help="artifact directory (default: GEOMX_TRACE_DIR, "
                         "else a new temporary directory)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    out_dir = args.out or tempfile.mkdtemp(prefix="geomx_trace_demo_")
    rec = run(args.device, out_dir, args.steps)
    print(rec["report_text"])
    print(f"OK: {rec['events']} events across {len(rec['roles'])} roles, "
          f"{rec['rounds']} rounds -> {out_dir}/geomx_trace.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
