"""Time the flagship LM's single-device training step on one CUDA card.

    python -m geomx_tpu_torch.examples.time_lm_step [--steps 50]
        [--attn-impl flash] [--rounds 3]

Builds ``training.build_flagship_lm`` (vocab 8192, d 384, 6 heads, 4
layers, d_ff 1536, seq 128, bf16 compute) and times
``make_lm_grad_fn(cfg)`` — one forward and backward with no mesh, the
step every worker of the LM geo-round runs — on a batch of 8, warm:
``--rounds`` rounds of ``--steps`` steps back to back, each round timed
with CUDA events and with the host clock, the median kept.  Prints the
card's name and power limit and one JSON line.  Run it under two trees
(``PYTHONPATH``) in one call to compare them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


def main(argv=None) -> dict:
    import torch

    from geomx_tpu_torch.models.transformer import make_lm_grad_fn
    from geomx_tpu_torch.training import build_flagship_lm

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--attn-impl", default="flash")
    a = ap.parse_args(argv)
    # raises RuntimeError without CUDA
    cfg, params, _, _, data = build_flagship_lm(attn_impl=a.attn_impl)
    grad_fn = make_lm_grad_fn(cfg)
    tokens = data[:8]
    for _ in range(3):
        grad_fn(params, tokens)
    torch.cuda.synchronize()
    event_ms, wall_ms = [], []
    for _ in range(a.rounds):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(a.steps):
            grad_fn(params, tokens)
        end.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3 / a.steps)
        event_ms.append(start.elapsed_time(end) / a.steps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    report = {"attn_impl": a.attn_impl, "steps": a.steps,
              "event_ms_a_step": statistics.median(event_ms),
              "wall_ms_a_step": statistics.median(wall_ms),
              "event_ms_by_round": event_ms, "wall_ms_by_round": wall_ms,
              "nvidia_smi": smi}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
