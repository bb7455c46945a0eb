"""A tiny checkout for the CPU tests: the repository's manifest with its
configurations and cells swapped for small ones of the same families and
traffic, written under a temporary root."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

LM = {"name": "tiny-lm", "family": "transformer",
      "model": {"vocab": 128, "d_model": 32, "n_heads": 4, "n_layers": 2,
                "d_ff": 64, "max_seq": 32, "attn_impl": "flash",
                "compute_dtype": "bfloat16"},
      "inputs": {"kind": "tokens", "seq": 32, "vocab": 128, "order": 0.85},
      "batch_per_worker": 4, "reference_rows": 2}
_BASE = {"topology": {"parties": 2, "workers_per_party": 2,
                      "global_servers": 1},
         "global_optimizer": {"type": "adam", "lr": 0.001},
         "check_steps": 3, "warm_steps": 1, "trace_rounds": 2}
# limits from the tiny cells' own readings on the CPU (bf16 against the
# f32 reference, seeds 11, 12345, 2**31 + 11): at these sizes the pull's
# sampled top-k turns bf16 rounding into large gaps on the leaves it
# pulls, so that limit is wide; the faults read far above them
CELLS = {
    "t-fsa-mpq": ("tiny-lm", dict(
        _BASE, loop="fsa", compression={"type": "mpq", "size_bound": 1000,
                                        "ratio": 0.05, "momentum": 0.9},
        limits={"loss_gap": 0.002, "grad_norm_gap": 0.03,
                "change_gap": 0.1, "change_gap_sampled": 0.6,
                "grad_diff": 0.06})),
    "t-hfa": ("tiny-lm", dict(
        _BASE, loop="hfa", hfa_k1=2, hfa_k2=2, compression={"type": "none"},
        local_optimizer={"type": "adam", "lr": 0.001}, check_steps=4,
        warm_steps=0, trace_rounds=4,
        limits={"loss_gap": 0.002, "grad_norm_gap": 0.03,
                "change_gap": 0.03, "grad_diff": 0.06})),
}


def write(root: str, cells=None) -> str:
    """Write the tiny checkout's manifest, configurations and cells under
    ``root``; returns ``root``."""
    cells = CELLS if cells is None else cells
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"] = []
    man["workloads"] = []
    os.makedirs(os.path.join(root, "geobench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "geobench", "workloads"), exist_ok=True)
    for cfg in (LM,):
        path = f"geobench/configs/{cfg['name']}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        man["configs"].append({"name": cfg["name"], "source": "test",
                               "file": path, "reduced": [], "why": "test"})
    for name, (config, cell) in cells.items():
        with open(os.path.join(root, "geobench", "workloads",
                               f"{name}.json"), "w") as f:
            json.dump(cell, f)
        man["workloads"].append({"name": name, "config": config,
                                 "traffic": name, "chips": 1,
                                 "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


def cell(name: str, root: str, **edits):
    """The tiny cell ``name`` (edits applied to its cell file) as a
    :class:`geobench.spec.Cell`."""
    from geobench.spec import load

    cells = copy.deepcopy(CELLS)
    cells[name][1].update(edits)
    write(root, cells)
    return load(name, root)
