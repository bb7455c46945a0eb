"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell ``<name>`` of the manifest's ``workloads`` is the file
``geobench/workloads/<name>.json`` of the checkout: its traffic (the sync
loop, the codec, the optimizers, the topology, how many steps the
correctness check follows and how many warm the window) and the limits
of its correctness numbers.  Its configuration is the manifest's
``configs`` entry it names, whose ``file`` holds the model's sizes, its
family (``families/<family>.py`` builds it in the port) and its inputs.
A per-layer metric ``<name>`` is the reader ``metrics/<name>.py``.
Adding a cell, a configuration or a metric adds files and manifest
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with everything the harness reads."""

    def __init__(self, manifest: dict, name: str, root: str):
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if name not in by_name:
            raise KeyError(f"workload {name!r} is not in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        self.name = name
        self.entry = by_name[name]
        self.root = root
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.cell = load_json(os.path.join(
            root, os.path.basename(HERE), "workloads", f"{name}.json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def batch(self) -> int:
        return int(self.cell.get("batch_per_worker",
                                 self.config["batch_per_worker"]))


def load(name: str, root: str) -> Cell:
    """The cell ``name`` of the checkout at ``root``."""
    return Cell(load_json(os.path.join(root, "BENCHMARK.json")), name, root)


def reader(metric: str):
    """The reader module of a per-layer metric: ``read(run) -> float or
    None``."""
    return importlib.import_module(f"geobench.metrics.{metric}")
