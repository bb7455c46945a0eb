"""Per-node time-series metrics pump.

One ``MetricsPump`` per node samples the process-global system-metrics
registry (this node's ``<node>.*`` prefix), the van byte ledgers, and —
for server roles — the same stats dict the node answers
``Ctrl.QUERY_STATS`` with, then fire-and-forget ships the sample as a
``Ctrl.METRICS_REPORT`` frame to the ``MetricsCollector`` on the global
scheduler (modeled on PR 3's TRACE_REPORT path: no response slot, so a
dead collector never blocks anything; local servers are dual-homed, so
the frame rides the existing WAN link).

Every sample carries the sender's ``boot`` incarnation nonce and
``uptime_s`` so the collector can tell a warm-booted replacement's
zeroed counters from a genuine rate collapse, plus the sender's
heartbeat-RTT clock offsets so the series merge onto the same
clock-corrected timeline the trace collector uses.

Disabled path (``Config.enable_obs = False``, the default): no pump is
constructed anywhere — zero threads, zero frames, zero per-step work.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from geomx_tpu_torch.utils.metrics import system_snapshot


def _json_clean(d: dict) -> dict:
    """NaN fence at the serialization boundary: NaN/Inf are invalid
    JSON and poison any dump that includes them — drop those entries
    (a never-set gauge simply doesn't ship)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, float) and not math.isfinite(v):
            continue
        out[k] = v
    return out


class MetricsPump:
    """Sampler + shipper for one node; ``interval <= 0`` runs no thread
    (tests and ``Simulation.pump_metrics`` drive :meth:`ship`)."""

    def __init__(self, postoffice, config=None,
                 stats_fn: Optional[Callable[[], dict]] = None,
                 collector=None):
        self.po = postoffice
        self.node = str(postoffice.node)
        self.config = config or postoffice.config
        self.stats_fn = stats_fn
        self._collector = collector  # in-proc shortcut (same node)
        self.seq = 0
        self.shipped = 0
        self.ship_errors = 0
        self._stop = threading.Event()
        self._ticker = None
        if self.config.obs_interval_s > 0:
            # timer-wheel entry on a reactor fabric, sleep-loop thread
            # otherwise (transport/reactor.py) — same ship cadence
            from geomx_tpu_torch.transport.reactor import Periodic

            self._ticker = Periodic(
                self.config.obs_interval_s, self._tick,
                name=f"metrics-pump-{self.node}",
                reactor=getattr(postoffice.van.fabric, "reactor", None))

    def _tick(self):
        if self._stop.is_set():
            return
        try:
            self.ship()
        except Exception:  # a sweep error must not kill the loop
            import logging

            logging.getLogger(__name__).exception(
                "%s: metrics pump sweep failed", self.node)

    # ---- sampling -----------------------------------------------------------
    def sample(self) -> dict:
        """One report body: registry values under this node's prefix
        (the global scheduler additionally carries the node-less
        ``global_shard*`` series its monitors emit), van ledgers, and
        the role's QUERY_STATS-style stats."""
        from geomx_tpu_torch.core.config import Role

        now = time.monotonic()
        fl = getattr(self.po, "flight", None)
        if fl is not None:
            # refresh the flight recorder's pressure gauges (lock wait /
            # lane depth / send-queue depth / codec backlog) so the
            # registry slice below ships current readings — the pump IS
            # the recorder's periodic sampler when no dedicated
            # flight_sample_s thread runs
            fl.sample_pressure()
        metrics = system_snapshot(prefix=f"{self.node}.", skip_unset=True)
        if self.po.node.role is Role.GLOBAL_SCHEDULER:
            metrics.update(system_snapshot(prefix="global_shard",
                                           skip_unset=True))
        van = self.po.van
        stats = {
            "wan_send_bytes": van.wan_send_bytes,
            "wan_recv_bytes": van.wan_recv_bytes,
            "send_bytes": van.send_bytes,
            "recv_bytes": van.recv_bytes,
        }
        if self.stats_fn is not None:
            try:
                stats.update(self.stats_fn())
            except Exception:  # a mid-stop role must not kill the pump
                pass
        self.seq += 1
        return {
            "node": self.node,
            "seq": self.seq,
            "boot": van.boot,
            "t_mono": now,
            "uptime_s": self.po.uptime_s(),
            "metrics": _json_clean(metrics),
            "stats": _json_clean(stats),
            "offsets": self.po.clock_offsets(),
        }

    # ---- shipping -----------------------------------------------------------
    def ship(self) -> bool:
        """Sample + fire-and-forget ship to the collector; False when
        the scheduler is unreachable (the next interval retries — a
        missed sample is just a gap in the series)."""
        body = self.sample()
        if self._collector is not None:
            self._collector.ingest(body)
            self.shipped += 1
            return True
        from geomx_tpu_torch.kvstore.common import APP_PS, Ctrl
        from geomx_tpu_torch.trace import context as _tctx
        from geomx_tpu_torch.transport.message import Domain, Message

        with _tctx.suppressed():  # telemetry traffic never traces itself
            try:
                self.po.van.send(Message(
                    recipient=self.po.topology.global_scheduler(),
                    domain=Domain.GLOBAL, app_id=APP_PS, customer_id=0,
                    request=True, cmd=int(Ctrl.METRICS_REPORT), body=body))
            except (KeyError, OSError):
                self.ship_errors += 1
                return False
        self.shipped += 1
        return True

    def stop(self):
        self._stop.set()
        if self._ticker is not None:
            self._ticker.stop()
