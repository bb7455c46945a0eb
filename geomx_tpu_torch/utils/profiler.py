"""Span profiler with Chrome-trace export and remote control.

Mirrors the reference profiler capabilities used by the distributed layer
(ref: src/profiler/profiler.h:256-304 Chrome-trace JSON dump;
python/mxnet/profiler.py), including GeoMX's remote-control feature: a
worker can configure / start / pause / dump the profiler **on servers**
via command messages (ref: KVStore::SetServerProfilerCommand
include/mxnet/kvstore.h:442, kvstore_dist.h:200-205; server side
ProcessServerProfilerCommands kvstore_dist_server.h:409-456, dumping to
rank-prefixed filenames).

On TPU the op-level timeline belongs to XLA's own profiler
(jax.profiler.trace); this one covers the host-side runtime — kvstore
handlers, codec time, WAN round-trips — which is what the reference's
server profiles showed.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class Profiler:
    def __init__(self, process_name: str = "geomx"):
        self.process_name = process_name
        self._events: List[dict] = []
        self._counters: Dict[str, float] = {}
        self._mu = threading.Lock()
        self.running = False
        self._t0 = time.perf_counter()
        # monotonic twin of _t0: the distributed tracer (geomx_tpu_torch/trace)
        # records into THIS buffer with profiler-relative ts but ships
        # absolute monotonic stamps for cross-node merging
        self.t0_mono = time.monotonic()

    # ---- control (ref: MXSetProfilerState / MXProfilePause) -----------------
    def configure(self, process_name: Optional[str] = None):
        if process_name:
            self.process_name = process_name

    def start(self):
        self.running = True

    def pause(self):
        self.running = False

    def reset(self):
        with self._mu:
            self._events.clear()
            self._counters.clear()

    # ---- recording ----------------------------------------------------------
    @contextmanager
    def span(self, name: str, category: str = "runtime"):
        if not self.running:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._mu:
                self._events.append({
                    "name": name, "cat": category, "ph": "X",
                    "ts": (t0 - self._t0) * 1e6,
                    "dur": (t1 - t0) * 1e6,
                    "pid": self.process_name,
                    "tid": threading.current_thread().name,
                })

    def add_event(self, ev: dict) -> None:
        """Append one pre-built Chrome-trace event (the distributed
        tracer's entry point — shares this buffer instead of keeping its
        own, so the remote-profiler dump and the merged distributed
        trace can never drift apart).  Not gated on ``running``: the
        tracer has its own gate (round sampling)."""
        with self._mu:
            self._events.append(ev)

    def events(self) -> List[dict]:
        """A copy of the buffer's event list (the dicts are shared)."""
        with self._mu:
            return list(self._events)

    def count(self, name: str, value: float = 1.0):
        if not self.running:
            return
        with self._mu:
            self._counters[name] = self._counters.get(name, 0.0) + value

    # ---- export (Chrome trace JSON, ref: profiler.h DumpProfile) ------------
    def dump(self, path: str):
        with self._mu:
            events = list(self._events)
            counters = dict(self._counters)
        for name, v in counters.items():
            events.append({
                "name": name, "ph": "C", "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": self.process_name, "args": {"value": v},
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    def aggregate(self) -> dict:
        """Per-span-name aggregate table (ref: the reference's aggregate
        statistics, src/profiler/aggregate_stats.cc — one row per op
        name: count/total/min/max/mean), in microseconds."""
        with self._mu:
            rows: Dict[str, dict] = {}
            for e in self._events:
                if e.get("ph") != "X":
                    continue
                r = rows.setdefault(e["name"], {
                    "count": 0, "total_us": 0.0,
                    "min_us": float("inf"), "max_us": 0.0,
                })
                r["count"] += 1
                r["total_us"] += e["dur"]
                r["min_us"] = min(r["min_us"], e["dur"])
                r["max_us"] = max(r["max_us"], e["dur"])
        for r in rows.values():
            r["avg_us"] = r["total_us"] / r["count"]
        return rows

    def stats(self) -> dict:
        agg = self.aggregate()  # outside _mu (aggregate takes it)
        with self._mu:
            return {
                "num_events": len(self._events),
                "counters": dict(self._counters),
                "aggregate": agg,
            }


_profilers: Dict[str, Profiler] = {}
_mu = threading.Lock()


def get_profiler(name: str = "geomx") -> Profiler:
    with _mu:
        p = _profilers.get(name)
        if p is None:
            p = _profilers[name] = Profiler(name)
        return p
