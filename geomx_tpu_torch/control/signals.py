"""Sliding-window WAN signal estimators.

Everything here derives from observability the system already ships —
no new probes on any data path:

- **goodput / byte rate** — deltas of the per-codec ``wan_bytes_*``
  counters the vans mirror into the system-metrics registry (PR 3), or,
  cross-process, the ``wan_send_bytes`` totals each local server reports
  via ``Ctrl.QUERY_STATS``.
- **round rate** — deltas of the local servers' ``wan_push_rounds``
  counter (one per WAN push-up batch), the controller's primary "is the
  pipeline keeping up" signal: ``round_time ≈ Δt / Δrounds``.
- **RTT** — the heartbeat echo RTT gauges (``Postoffice.heartbeat_rtts``,
  reported back through QUERY_STATS as ``hb_rtt_s``).
- **dominant stage / straggler party** — the trace collector's per-round
  critical-path report, when tracing is on.  The policy engine uses it
  as a veto: if rounds are slow but the dominant stage is compute
  (local/global merge), more WAN compression cannot help.

The estimator is deliberately pull-based (the controller calls
:meth:`ingest` with whatever stats it sampled); it holds no locks shared
with any data path.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, Optional, Tuple


@dataclasses.dataclass
class WanSignals:
    """One fused observation the policy engine decides on."""

    t: float                          # monotonic sample time
    round_time_s: Optional[float]     # Δt/Δrounds of the slowest party
    #                                   (None until a round completed in
    #                                   the window)
    goodput_bps: Optional[float]      # WAN bytes/s over the window
    wan_bytes_rate: Dict[str, float]  # per-codec-tag bytes/s
    rtt_s: Optional[float]            # worst heartbeat RTT across servers
    dominant_stage: Optional[str]     # from the critical-path report
    straggler_party: Optional[str]    # party of the dominant stage's
    #                                   worst node
    rounds_total: int                 # cumulative WAN rounds observed


class _Window:
    """Fixed-length window of (t, value) samples with delta-rate math."""

    def __init__(self, n: int):
        self._q: Deque[Tuple[float, float]] = collections.deque(maxlen=n)

    def push(self, t: float, v: float) -> None:
        self._q.append((t, v))

    def rate(self) -> Optional[float]:
        """(last - first) / elapsed over the window (None if < 2 samples
        or no time elapsed)."""
        if len(self._q) < 2:
            return None
        (t0, v0), (t1, v1) = self._q[0], self._q[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def delta(self) -> Optional[Tuple[float, float]]:
        """(Δvalue, Δt) across the window."""
        if len(self._q) < 2:
            return None
        (t0, v0), (t1, v1) = self._q[0], self._q[-1]
        return v1 - v0, t1 - t0


class SignalEstimator:
    def __init__(self, window: int = 8):
        self.window = max(2, int(window))
        self._rounds: Dict[str, _Window] = {}    # per local server
        self._bytes: Dict[str, _Window] = {}     # per codec tag
        self._rtt: Dict[str, float] = {}
        self._boots: Dict[str, int] = {}
        self._rounds_total = 0

    # ---- ingestion ----------------------------------------------------------
    def ingest(self, now: float, server_stats: Dict[str, dict],
               report: Optional[dict] = None) -> WanSignals:
        """Fold one sampling sweep into the windows and return the fused
        observation.  ``server_stats`` maps local-server node string ->
        its QUERY_STATS body; ``report`` is an optional critical-path
        report (``TraceCollector.critical_path()``)."""
        total_rounds = 0
        for node, stats in server_stats.items():
            # boot fence: a warm-booted replacement reports from zero —
            # restart this node's windows so the reset neither reads as
            # "no rounds completing" (Δ <= 0 forever against the old
            # totals) nor as a goodput collapse
            boot = int(stats.get("boot", 0) or 0)
            if boot and self._boots.get(node, boot) != boot:
                self._rounds.pop(node, None)
                self._bytes.pop(node, None)
                self._rtt.pop(node, None)
            if boot:
                self._boots[node] = boot
            r = float(stats.get("wan_push_rounds", 0) or 0)
            total_rounds += int(r)
            self._rounds.setdefault(node, _Window(self.window)).push(now, r)
            self._bytes.setdefault(node, _Window(self.window)).push(
                now, float(stats.get("wan_send_bytes", 0) or 0))
            rtt = stats.get("hb_rtt_s")
            if rtt is not None and not math.isnan(float(rtt)):
                self._rtt[node] = float(rtt)
        self._rounds_total = total_rounds
        return WanSignals(
            t=now,
            round_time_s=self._round_time(),
            goodput_bps=self._goodput(),
            wan_bytes_rate=self._per_codec_rates(server_stats),
            rtt_s=max(self._rtt.values()) if self._rtt else None,
            dominant_stage=self._dominant(report),
            straggler_party=self._straggler(report),
            rounds_total=total_rounds,
        )

    # ---- derived signals ----------------------------------------------------
    def _round_time(self) -> Optional[float]:
        """Per-party round time = Δt/Δrounds; the deployment's effective
        round time is the SLOWEST party's (the FSA round gates on it)."""
        worst = None
        for w in self._rounds.values():
            d = w.delta()
            if d is None:
                continue
            d_rounds, dt = d
            if d_rounds <= 0:
                continue  # no round completed in the window — no sample
            rt = dt / d_rounds
            worst = rt if worst is None else max(worst, rt)
        return worst

    def _goodput(self) -> Optional[float]:
        total = None
        for w in self._bytes.values():
            r = w.rate()
            if r is None:
                continue
            total = r if total is None else total + r
        return total

    @staticmethod
    def _per_codec_rates(server_stats: Dict[str, dict]) -> Dict[str, float]:
        """Instantaneous per-codec-tag byte ledger from the in-process
        metrics registry (best-effort: empty cross-process, where only
        the QUERY_STATS totals are visible)."""
        try:
            from geomx_tpu_torch.utils.metrics import system_snapshot
        except Exception:  # pragma: no cover
            return {}
        out: Dict[str, float] = {}
        for k, v in system_snapshot().items():
            if ".wan_bytes_" in k:
                tag = k.rsplit(".wan_bytes_", 1)[1]
                out[tag] = out.get(tag, 0.0) + float(v)
        return out

    @staticmethod
    def _last_round(report: Optional[dict]) -> Optional[dict]:
        if not report:
            return None
        rounds = report.get("rounds") or ()
        return rounds[-1] if rounds else None

    def _dominant(self, report: Optional[dict]) -> Optional[str]:
        r = self._last_round(report)
        return r.get("dominant_stage") if r else None

    def _straggler(self, report: Optional[dict]) -> Optional[str]:
        r = self._last_round(report)
        if not r:
            return None
        st = (r.get("stages") or {}).get(r.get("dominant_stage") or "", {})
        return st.get("straggler_party")
