"""Per-phase step timing: the reference examples' ``Measure`` report
(ref: examples/utils.py:120-192 — each training phase timed per
iteration, dumped as a JSON report) so perf regressions between rounds
are attributable to a phase, not just a slower total.

``Measure`` is handed to the worker loop, which brackets its phases
(grad compute / push / pull-wait); ``report()`` gives per-phase
aggregates and ``dump()`` writes the JSON artifact.  Cross-node
aggregation (the reference's aggregate-stats table,
ref: src/profiler/aggregate_stats.cc) merges reports or profiler stats
from many nodes into one table.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, List


class Measure:
    def __init__(self):
        self._mu = threading.Lock()
        self._durs: Dict[str, List[float]] = {}
        self._step_t0: float | None = None
        self.steps = 0

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._mu:
                self._durs.setdefault(name, []).append(dt)

    def step_start(self):
        self._step_t0 = time.perf_counter()

    def step_end(self):
        if self._step_t0 is not None:
            with self._mu:
                self._durs.setdefault("step", []).append(
                    time.perf_counter() - self._step_t0)
            self.steps += 1
            self._step_t0 = None

    def report(self) -> dict:
        """Per-phase {count, total_s, mean_s, max_s} (ref: the per-phase
        rows of examples/utils.py's report)."""
        with self._mu:
            out = {}
            for name, ds in self._durs.items():
                out[name] = {
                    "count": len(ds),
                    "total_s": round(sum(ds), 6),
                    "mean_s": round(sum(ds) / len(ds), 6),
                    "max_s": round(max(ds), 6),
                }
            return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump({"steps": self.steps, "phases": self.report()}, f,
                      indent=2)


def aggregate_reports(reports: Dict[str, dict]) -> dict:
    """Merge per-node phase reports into one cluster table
    (ref: aggregate_stats.cc — one row per op/phase across devices):
    {phase: {count, total_s, mean_s, max_s, max_node}}."""
    agg: Dict[str, dict] = {}
    for node, report in reports.items():
        phases = report.get("phases", report)
        for name, row in phases.items():
            a = agg.setdefault(name, {"count": 0, "total_s": 0.0,
                                      "max_s": 0.0, "max_node": None})
            a["count"] += row["count"]
            a["total_s"] = round(a["total_s"] + row["total_s"], 6)
            if row["max_s"] >= a["max_s"]:
                a["max_s"] = row["max_s"]
                a["max_node"] = node
    for a in agg.values():
        a["mean_s"] = round(a["total_s"] / max(1, a["count"]), 6)
    return agg
