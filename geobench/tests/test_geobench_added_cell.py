"""A later change adds a configuration, a cell and a per-layer metric by
adding files and manifest entries alone.  This test copies the harness
into a temporary checkout, adds them there without touching a copied
file, and runs the new cell from that checkout (on the CPU, past the
look for a card)."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from geobench.tests import tiny

REPO = tiny.REPO

PROBE = '''"""Test metric: the window's rounds."""


def read(run):
    return float(run.result["rounds"]) or None
'''

CODE = """
import argparse, json, sys, torch
sys.path.insert(0, {root!r})
sys.path.append({repo!r})       # the program; the harness is the copy's
from geobench import run
assert run.__file__.startswith({root!r})
for trace in (0, 1):
    args = argparse.Namespace(workload="t-added", seed=7, seconds=0.3,
                              trace=trace)
    assert run.run(args, torch.device("cpu"), {root!r}) == 0
"""


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "geobench")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_a_cell_added_as_files_runs(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "geobench"),
                    os.path.join(root, "geobench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    before = _digest(root)

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    cfg = dict(tiny.LM, name="tiny-added")
    with open(os.path.join(root, "geobench", "configs",
                           "tiny-added.json"), "w") as f:
        json.dump(cfg, f)
    cell = dict(tiny.CELLS["t-fsa-mpq"][1])
    with open(os.path.join(root, "geobench", "workloads",
                           "t-added.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(root, "geobench", "metrics",
                           "window_rounds.py"), "w") as f:
        f.write(PROBE)
    man["configs"].append({"name": "tiny-added", "source": "test",
                           "file": "geobench/configs/tiny-added.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "t-added", "config": "tiny-added",
                             "traffic": "added", "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        m.get("workloads", []).append("t-added")
    man["per_layer"].append({"name": "window_rounds", "unit": "rounds",
                             "better": "higher", "source": "host_clock",
                             "layer": "worker loop", "moves":
                             "samples_per_s", "workloads": ["t-added"]})
    for m in man["per_layer"]:
        if m["name"] == "sync_wait_ms":
            m["workloads"].append("t-added")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)

    code = CODE.format(root=root, repo=REPO)
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 2
    assert set(lines[0]["metrics"]) == {"samples_per_s", "step_p90_ms",
                                        "wan_bytes_per_sample", "setup_s"}
    assert set(lines[1]["metrics"]) >= {"window_rounds", "sync_wait_ms"}
    assert lines[0]["correct"] is True
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
