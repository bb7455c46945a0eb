"""On the card: one short run of each cell of the manifest, as the
benchmark's command runs it.  Skips where there is no CUDA card.

    python -m pytest -m cuda geobench/tests/test_geobench_card.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from geobench.tests import tiny


def _cells():
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _cells())
def test_cell_runs_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "geobench/run.py", "--workload",
                          name, "--seed", "2147483647", "--seconds", "3",
                          "--trace", "0"], cwd=tiny.REPO, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
