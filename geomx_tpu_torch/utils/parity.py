"""Long-horizon convergence-parity harness — the port of the JAX
package's ``utils/parity.py``.

The acceptance criterion for every WAN feature is "the accuracy curve
matches vanilla" over full training runs.  This module trains the SAME
model, data and seed through the two-tier stack under each feature
config for a long horizon (default 200 steps) and reports the FINAL
held-out accuracy per config, with its WAN bytes; ``run_parity_matrix``
attaches each config's delta against vanilla.  Worker compute, the merge
lanes, the global optimizer and the codec stage run on ``device`` (CUDA
unless ``"cpu"``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from geomx_tpu_torch.models import create_cnn_state

#: the acceptance matrix: every WAN feature the reference ships a
#: run_*.sh for, at its long-horizon-meaningful setting.  ``eps`` is the
#: allowed FINAL-accuracy shortfall vs the vanilla run (absolute):
#: numerically-tight codecs get a tight bound, sparsifying/stale ones a
#: loose-but-real one (they must still genuinely converge).
PARITY_CONFIGS: Dict[str, dict] = {
    "vanilla": {"eps": 0.0},
    "fp16": {"compression": {"type": "fp16"}, "eps": 0.05},
    "2bit": {"compression": {"type": "2bit", "threshold": 0.05},
             "eps": 0.20},
    # ratio 0.10 not the reference's 0.01: top-k must be meaningful vs
    # the ~102k-param demo model (same reasoning as the r4 oracle)
    "bsc": {"compression": {"type": "bsc", "ratio": 0.10}, "eps": 0.15},
    "mpq": {"compression": {"type": "mpq", "ratio": 0.10,
                            "size_bound": 2_000}, "eps": 0.15},
    # HFA runs LOCAL optimizers between syncs and lets the two parties'
    # replicas drift for k1*k2=16 steps between WAN syncs: at this scale
    # (2 parties, noise-1.5 task) the measured staleness cost is large
    # and real — ~0.26 final accuracy vs vanilla for a 16x WAN-round
    # saving (r5 measurement; this IS the staleness cost the scaling
    # roofline's HFA column is annotated with).  The gate bounds it at
    # 0.35: regressions that break convergence outright still fail, the
    # honest cost passes and stays visible in the bench parity block.
    "hfa_k2_8": {"hfa_k1": 2, "config": {"use_hfa": True, "hfa_k2": 8},
                 "eps": 0.35},
    # ESync syncs every round (staleness is bounded by the plan, not by
    # k2), and measured within +-0.07 of vanilla at equal step budget
    "esync": {"esync": True, "config": {"use_hfa": True}, "eps": 0.15},
    "dgt_mode1_30loss": {
        "config": {"enable_dgt": 1, "dgt_block_size": 256, "dgt_k": 0.3,
                   "dgt_udp_channels": 2},
        "fault": {"channel_drop_rate": 0.3, "seed": 3}, "eps": 0.15},
    # scheduling overlays are numerically EXACT (they reorder delivery,
    # not arithmetic): tight ε pins that the relay/piggyback paths stay
    # loss-free over a long horizon, not just in unit tests
    "p3": {"config": {"enable_p3": True, "p3_slice_elems": 20_000},
           "eps": 0.05},
    "ts_inter": {"config": {"enable_inter_ts": True}, "eps": 0.10},
}


def run_parity_config(name: str, steps: int = 200,
                      spec: Optional[dict] = None, device=None) -> dict:
    """Train one config through the 2-party × 1-worker HiPS stack for
    ``steps`` worker steps; returns the final held-out accuracy (the
    lower of the two workers'), the mean loss of the last 5 steps, the
    first loss, the steps run and the WAN bytes sent.

    2 parties so every WAN mechanism under test crosses the inter-party
    tier it was built for; 1 worker per party keeps a 200-step run
    affordable.  Geometry, seeds and the eval split are identical across
    configs — the ONLY variable is the feature flag.
    """
    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import ShardedIterator, synthetic_classification
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.training import (run_worker, run_worker_esync,
                                          run_worker_hfa)

    dev = resolve_device(device)
    spec = dict(PARITY_CONFIGS[name] if spec is None else spec)
    fault = None
    if "fault" in spec:
        from geomx_tpu_torch.transport.van import FaultPolicy

        fault = FaultPolicy(**spec["fault"])
    cfg = Config(topology=Topology(num_parties=2, workers_per_party=1),
                 merge_backend="torch:cpu" if dev.type == "cpu" else "torch",
                 **spec.get("config", {}))
    sim = Simulation(cfg, fault=fault) if fault else Simulation(cfg)
    try:
        # noise 1.5 (vs the 0.35 default): the default task saturates
        # at 1.0 held-out accuracy within ~40 steps, which would make
        # every parity delta vacuously zero
        x, y = synthetic_classification(n=768, shape=(12, 12, 1),
                                        noise=1.5, seed=1)
        x_tr, y_tr = x[:512], y[:512]
        x_ev, y_ev = x[512:], y[512:]   # held-out eval split
        model, params, grad_fn = create_cnn_state(
            0, input_shape=(1, 12, 12, 1), device=dev)

        finals = {}
        hists = {}
        errors = []
        lock = threading.Lock()

        def worker_main(widx):
            try:
                kv = sim.worker(widx, 0)
                if widx == 0:
                    if spec.get("hfa_k1") is None and not spec.get("esync"):
                        kv.set_optimizer({"type": "adam", "lr": 0.01})
                    if "compression" in spec:
                        kv.set_gradient_compression(spec["compression"])
                kv.barrier()
                it = ShardedIterator(x_tr, y_tr, 16, widx, 2, seed=2)
                out: dict = {}
                if spec.get("esync"):
                    # ESync counts sync ROUNDS; with homogeneous workers
                    # the planner assigns ~1 local step per round, so
                    # rounds ≈ steps keeps the step budget comparable
                    hist = run_worker_esync(
                        kv, params, grad_fn, it, rounds=steps,
                        max_local_steps=8, params_out=out)
                elif spec.get("hfa_k1") is not None:
                    hist = run_worker_hfa(kv, params, grad_fn, it,
                                          steps, k1=spec["hfa_k1"],
                                          params_out=out)
                else:
                    hist = run_worker(kv, params, grad_fn, it,
                                      steps, params_out=out)
                with torch.no_grad():
                    logits = model.apply(out["params"],
                                         torch.as_tensor(x_ev, device=dev))
                acc = float(np.mean(logits.argmax(-1).cpu().numpy()
                                    == y_ev))
                with lock:
                    finals[widx] = acc
                    hists[widx] = hist
            except Exception as e:  # noqa: BLE001 — surfaced below
                with lock:
                    errors.append((widx, repr(e)))

        threads = [threading.Thread(target=worker_main, args=(i,),
                                    daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errors:
            raise RuntimeError(f"{name}: worker failed: {errors}")
        if len(finals) != 2:
            raise RuntimeError(f"{name}: a worker hung")
        hist0 = hists[0]
        return {
            "final_accuracy": round(min(finals.values()), 4),
            "final_loss": round(float(np.mean([h[0] for h in
                                               hist0[-5:]])), 4),
            "first_loss": round(float(hist0[0][0]), 4),
            "steps": len(hist0),
            "wan_send_bytes": sim.wan_bytes()["wan_send_bytes"],
        }
    finally:
        sim.shutdown()


def run_parity_matrix(steps: int = 200, names=None,
                      device=None) -> Dict[str, dict]:
    """Run every config (vanilla first) on ``device``; attach each
    config's final-accuracy delta against vanilla and its ``eps``.  A
    config that fails carries ``{"error": ...}`` instead of voiding the
    matrix."""
    from geomx_tpu_torch.core.platform import resolve_device

    device = resolve_device(device)    # no card: raise before any config
    names = list(PARITY_CONFIGS if names is None else names)
    if "vanilla" in names:  # vanilla first: everything is relative to it
        names.remove("vanilla")
        names.insert(0, "vanilla")
    out: Dict[str, dict] = {}
    for name in names:
        try:
            out[name] = run_parity_config(name, steps=steps, device=device)
        except Exception as e:  # noqa: BLE001 — one config must not
            out[name] = {"error": repr(e)[:200]}  # void the matrix
        if name != "vanilla" and "final_accuracy" in out.get(name, {}) \
                and "final_accuracy" in out.get("vanilla", {}):
            out[name]["accuracy_delta_vs_vanilla"] = round(
                out[name]["final_accuracy"]
                - out["vanilla"]["final_accuracy"], 4)
            out[name]["eps"] = PARITY_CONFIGS[name]["eps"]
    return out
