"""Scheduler-side metrics collector: ring-buffered per-node series.

Runs on the global scheduler next to (and sharing a telemetry endpoint
with) PR 3's trace collector.  Each ``Ctrl.METRICS_REPORT`` frame is
appended to the sender's bounded ring; derived reads are pull-based:

- :meth:`rate` — boot-fenced delta rates over the ring (a warm-booted
  node's counter reset truncates the ring instead of producing a
  negative rate that looks like a collapse);
- :meth:`latest_stats` — freshest QUERY_STATS-style sample per server,
  which the adaptive-WAN controller consumes instead of issuing its own
  QUERY_STATS sweeps when the pump cadence already covers it;
- :meth:`trace_counter_events` — perfetto counter-track ("ph": "C")
  events that merge into the trace collector's clock-corrected timeline
  (registered as an ``extra_event_sources`` hook, so ``dump_trace``
  interleaves round spans with the metric curves behind them);
- :meth:`prometheus_text` — Prometheus-style text exposition of the
  freshest sample per node (never-set gauges are NaN-fenced out).
"""

from __future__ import annotations

import collections
import math
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from geomx_tpu_torch.utils.metrics import system_counter

# the default counter tracks merged into the trace timeline: the round
# pipeline's load-bearing series (bytes moved, rounds completed, policy
# epoch) plus the failure-detector inputs
DEFAULT_TRACKS = ("wan_send_bytes", "wan_push_rounds", "key_rounds",
                  "replication_lag_s", "heartbeat_rtt_s", "policy_epoch")


class MetricsCollector:
    """One per deployment, on the global scheduler's postoffice."""

    def __init__(self, postoffice, config=None, trace_collector=None,
                 tracks: Tuple[str, ...] = DEFAULT_TRACKS):
        from geomx_tpu_torch.kvstore.common import Ctrl
        from geomx_tpu_torch.obs.endpoint import get_endpoint

        self.po = postoffice
        self.node = str(postoffice.node)
        self.config = config or postoffice.config
        self.window = max(8, int(getattr(self.config, "obs_window", 256)))
        self.tracks = tuple(tracks)
        self.trace_collector = trace_collector
        self._mu = threading.Lock()
        self._rings: Dict[str, collections.deque] = {}
        self._boots: Dict[str, int] = {}
        self._offsets: Dict[str, Dict[str, float]] = {}
        self.node_restarts: Dict[str, int] = {}
        self.reports_received = 0
        self._reports_counter = system_counter(f"{self.node}.obs_reports")
        self._restart_counter = system_counter(
            f"{self.node}.obs_node_restarts")
        self._endpoint = get_endpoint(postoffice).acquire()
        self._endpoint.route(Ctrl.METRICS_REPORT, self._on_report)
        if trace_collector is not None:
            trace_collector.extra_event_sources.append(
                self.trace_counter_events)

    def _on_report(self, msg):
        body = msg.body if isinstance(msg.body, dict) else {}
        self.ingest(body)

    def ingest(self, body: dict) -> None:
        node = str(body.get("node", "?"))
        t_recv = time.monotonic()
        with self._mu:
            ring = self._rings.setdefault(
                node, collections.deque(maxlen=self.window))
            boot = int(body.get("boot", 0) or 0)
            prev = self._boots.get(node)
            if boot and prev is not None and prev != boot:
                # warm-booted replacement at the same identity: its
                # zeroed counters are a new life, not a rate collapse —
                # fence the ring so no delta spans the restart
                ring.clear()
                self.node_restarts[node] = self.node_restarts.get(node, 0) + 1
                self._restart_counter.inc()
            if boot:
                self._boots[node] = boot
            ring.append({
                "t": float(body.get("t_mono", t_recv)),
                "t_recv": t_recv,
                "boot": boot,
                "seq": int(body.get("seq", 0) or 0),
                "uptime_s": float(body.get("uptime_s", 0.0) or 0.0),
                "metrics": dict(body.get("metrics") or {}),
                "stats": dict(body.get("stats") or {}),
            })
            offs = body.get("offsets")
            if offs:
                self._offsets[node] = {str(k): float(v)
                                       for k, v in offs.items()}
            self.reports_received += 1
        self._reports_counter.inc()

    # ---- series access ------------------------------------------------------
    def nodes(self) -> List[str]:
        with self._mu:
            return sorted(self._rings)

    def latest(self, node: str) -> Optional[dict]:
        with self._mu:
            ring = self._rings.get(str(node))
            return dict(ring[-1]) if ring else None

    def latest_stats(self, node: str,
                     max_age_s: Optional[float] = None) -> Optional[dict]:
        """Freshest stats dict for ``node`` (None when absent or staler
        than ``max_age_s`` by local receive time) — the controller's
        QUERY_STATS substitute."""
        with self._mu:
            ring = self._rings.get(str(node))
            if not ring:
                return None
            s = ring[-1]
            if (max_age_s is not None
                    and time.monotonic() - s["t_recv"] > max_age_s):
                return None
            return dict(s["stats"])

    @staticmethod
    def _get(sample: dict, node: str, key: str):
        """Value of ``key`` in one sample: stats first, then the
        registry (bare suffix or full dotted name)."""
        v = sample["stats"].get(key)
        if v is not None:
            return v
        m = sample["metrics"]
        return m.get(f"{node}.{key}", m.get(key))

    def value(self, node: str, key: str):
        s = self.latest(node)
        return None if s is None else self._get(s, str(node), key)

    def series(self, node: str, key: str) -> List[Tuple[float, float]]:
        """(t_mono, value) pairs over the ring (sender clock)."""
        node = str(node)
        with self._mu:
            ring = list(self._rings.get(node) or ())
        out = []
        for s in ring:
            v = self._get(s, node, key)
            if isinstance(v, (int, float)) and math.isfinite(v):
                out.append((s["t"], float(v)))
        return out

    def rate(self, node: str, key: str,
             lookback_s: Optional[float] = None) -> Optional[float]:
        """Δvalue/Δt over the ring (or its trailing ``lookback_s``);
        None with < 2 samples.  Boot fencing happens at ingest, so a
        restart can never produce a negative counter rate here."""
        pts = self.series(node, key)
        if lookback_s is not None and pts:
            t1 = pts[-1][0]
            pts = [p for p in pts if t1 - p[0] <= lookback_s]
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def sample_age_s(self, node: str,
                     now: Optional[float] = None) -> Optional[float]:
        """Local seconds since ``node``'s last report (collection
        freshness — a dead node's series goes stale before any counter
        says so)."""
        with self._mu:
            ring = self._rings.get(str(node))
            if not ring:
                return None
            t = ring[-1]["t_recv"]
        return (now if now is not None else time.monotonic()) - t

    # ---- perfetto counter tracks --------------------------------------------
    def trace_counter_events(self) -> List[dict]:
        """Counter-track events for the trace collector's merged
        timeline: one "C"-phase event per (sample, tracked key), on the
        sender's monotonic clock — the collector rebases them with the
        same per-node offsets as the spans."""
        with self._mu:
            rings = {n: list(r) for n, r in self._rings.items()}
        out = []
        for node, ring in rings.items():
            for s in ring:
                t_us = s["t"] * 1e6
                for key in self.tracks:
                    v = self._get(s, node, key)
                    if not (isinstance(v, (int, float))
                            and not isinstance(v, bool)
                            and math.isfinite(v)):
                        continue
                    out.append({
                        "name": f"metric.{key}", "cat": "metrics",
                        "ph": "C", "ts": t_us, "dur": 0.0,
                        "pid": node, "tid": "metrics",
                        "args": {key: float(v), "t_mono_us": t_us,
                                 "trace_id": 0, "span": 0, "parent": 0},
                    })
        return out

    # ---- text exposition ----------------------------------------------------
    @staticmethod
    def _prom_name(name: str) -> str:
        return "geomx_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)

    def prometheus_text(self) -> str:
        """Prometheus-style text exposition of the freshest sample per
        node.  Registry names become ``geomx_<suffix>{node="..."}``;
        non-finite values (never-set gauges) and non-numeric stats are
        fenced out — the dump is always parseable."""
        with self._mu:
            latest = {n: r[-1] for n, r in self._rings.items() if r}
        lines = ["# GeoMX system metrics (freshest sample per node)"]
        for node in sorted(latest):
            s = latest[node]
            rows = {}
            for name, v in s["metrics"].items():
                family = name.split(".", 1)[1] if name.startswith(
                    f"{node}.") else name
                rows[self._prom_name(family)] = v
            for name, v in s["stats"].items():
                rows[self._prom_name(name)] = v
            for fam in sorted(rows):
                v = rows[fam]
                if isinstance(v, bool):
                    v = int(v)
                if not isinstance(v, (int, float)) or not math.isfinite(v):
                    continue  # strings / NaN never reach the exposition
                lines.append(f'{fam}{{node="{node}"}} {v:g}')
        return "\n".join(lines) + "\n"

    def stop(self):
        if self.trace_collector is not None:
            try:
                self.trace_collector.extra_event_sources.remove(
                    self.trace_counter_events)
            except ValueError:
                pass
        self._endpoint.release()
