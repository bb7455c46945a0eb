"""How torch rounds the device Adam's square root and division, against
numpy (IEEE round to nearest), on the host and on a card.

Counts the f32 values of one seeded input (1,000,000 values in [0, 100))
whose result differs from numpy's: ``sqrt`` on each device, division by
a host scalar and by a 0-dim tensor on the device, and the port's
``_sqrt_rn_`` / ``_div_rn``; then runs the device Adam for 5 rounds of 4
pushers against ``optim.server_opt.Adam`` (the JAX suite's contract
case) and says whether weights and moments are bitwise equal.  On a
card::

    python -m geomx_tpu_torch.examples.rounding_check

Writes ``chiprun_out/rounding_check.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np


def _diffs(got, want) -> int:
    return int((np.asarray(got).view(np.int32)
                != np.asarray(want).view(np.int32)).sum())


def check(device: str) -> dict:
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore.backend import NumpyBackend
    from geomx_tpu_torch.kvstore.torch_backend import (TorchBackend,
                                                       _div_rn, _sqrt_rn_)
    from geomx_tpu_torch.optim import make_optimizer

    x = np.random.default_rng(1).random(1_000_000).astype(np.float32) * 100
    t = torch.from_numpy(x).to(device)
    c = np.float32(0.75)
    out = {
        "torch_sqrt": _diffs(t.sqrt().cpu().numpy(), np.sqrt(x)),
        "port_sqrt_rn": _diffs(_sqrt_rn_(t.clone()).cpu().numpy(),
                               np.sqrt(x)),
        "torch_div_host_scalar": _diffs((t / float(c)).cpu().numpy(), x / c),
        "torch_div_0dim_device": _diffs(
            (t / torch.tensor(c, device=device)).cpu().numpy(), x / c),
        "port_div_rn": _diffs(_div_rn(t, 0.75).cpu().numpy(), x / c)}
    spec = {"type": "adam", "lr": 0.25, "beta1": 0.5, "beta2": 0.5,
            "eps": 1.0}
    rng = np.random.default_rng(0)
    rounds = [[rng.integers(1, 9, 2048).astype(np.float32)
               for _ in range(4)] for _ in range(5)]
    cfg = Config(topology=Topology())
    be, ref = TorchBackend(cfg, device=device), NumpyBackend(cfg)
    dev, opt = be.make_device_optimizer(dict(spec)), make_optimizer(dict(spec))
    raw = w = np.zeros(2048, np.float32)
    for grads in rounds:
        acc, hacc = (b.seed(grads[0].copy(), donated=True, key=0)
                     for b in (be, ref))
        for g in grads[1:]:
            acc, hacc = be.accumulate(acc, g.copy()), ref.accumulate(
                hacc, g.copy())
        raw = dev.step(0, raw, acc, 0.25)
        w = opt.update_scaled(0, w, ref.materialize(hacc), 0.25)
    mom = dev.export_state().state[0]
    out["adam_bitwise"] = (raw.host().tobytes() == w.tobytes() and all(
        mom[k].tobytes() == opt.state[0][k].tobytes() for k in ("m", "v")))
    return out


def main() -> int:
    import torch

    res = {"cpu": check("cpu")}
    if torch.cuda.is_available():
        res["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        res["cuda"] = check("cuda")
    print(json.dumps(res))
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "rounding_check.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
