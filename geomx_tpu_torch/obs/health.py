"""SLO health engine: rule evaluation over the collected series.

Pull-based like the adaptive-WAN controller: each :meth:`tick` sweeps
the ``MetricsCollector`` rings (and, when tracing is on, the trace
collector's critical-path report) through a fixed rule set and emits
structured alert records on STATE TRANSITIONS only — one record when a
rule starts firing for a subject, one when it recovers.  Every record
lands four independent ways:

- appended to ``HealthEngine.alerts`` (and the JSONL alert log when
  ``Config.obs_alert_log`` names one);
- registry counters (``<gsched>.health_alerts`` / ``health_recoveries``
  + a per-rule counter);
- a ``health.alert`` trace instant, so alerts interleave with the PR 3
  merged timeline exactly like failover/eviction control events;
- one stdout line per transition (``health ALERT ...`` /
  ``health RECOVERED ...``) the chaos scripts assert on.

Rules (thresholds are ``Config.obs_*`` knobs):

- **round_stall** — a global shard completed no key-round within
  ``max(obs_stall_min_s, obs_stall_factor x rolling-median gap)``;
  progress is tracked per (node, boot) so a promoted standby's first
  completed round is the recovery signal.
- **replication_lag** — a shard's hot-standby lag gauge exceeds
  ``obs_repl_lag_s``.
- **shard_imbalance** — the critical-path report's slowest shard is
  busy more than ``obs_imbalance_factor`` x the mean of its peers.
- **goodput_collapse** — a party's WAN byte rate fell below
  ``obs_goodput_frac`` x its rolling peak while its rounds are still
  progressing (a throttled-not-idle link).
- **rtt_outlier** — a node's heartbeat RTT exceeds ``obs_rtt_s`` or
  8x the fleet median.
- **fence_spike** — fenced/evicted/rejected event counters for one
  node grew by more than ``obs_fence_spike`` within the ring window.
- **replica_staleness** — a serve replica's reported local-copy age
  exceeds the configured read bound (``Config.serve_staleness_s``):
  its refresh loop is falling behind, so reads are parking instead of
  being answered (the serving tier's SLO; geomx_tpu_torch/serve).
- **churn_storm** — membership transitions (graceful leaves, kills,
  joins — injected by the churn orchestrator or organic) exceed
  ``obs_churn_storm`` within the window, or the orchestrator's
  survivor gauge reaches its min-survivor floor (the next departure
  stalls training; docs/deployment.md "Elasticity & preemption").
- **serve_overload** — a serve replica's admission-control shed rate
  (explicit RETRY_AFTER refusals, geomx_tpu_torch/serve) is sustained above
  ``obs_shed_rate`` per second over the collector window: the tier is
  degrading by design, but it needs capacity (docs/serving.md
  "Serving plane").
- **replica_flap** — the replica autoscaler counted direction
  reversals inside its cooldown (``autoscale_flaps``) past
  ``obs_replica_flap`` within the window: the scaling signals are
  oscillating faster than the hysteresis can follow — widen the
  deadband or lengthen the cooldown.
- **net_partition** — some monitor's ``quarantined_nodes`` gauge is
  nonzero: a node/party is heartbeat-dead but an indirect probe still
  hears it, so it was folded out REVERSIBLY instead of evicted
  (docs/deployment.md "Partition tolerance").  Training is running
  degraded; the alert recovers when the partition heals (or escalates
  into eviction/fold events, which page through fence_spike /
  churn_storm instead).
"""

from __future__ import annotations

import collections
import json
import math
import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

from geomx_tpu_torch.trace.collector import _shard_of
from geomx_tpu_torch.utils.metrics import system_counter

# counters summed by the fence_spike rule (stats keys and/or registry
# suffixes — whatever the node ships)
_FENCE_KEYS = ("eviction_fenced_pushes", "fenced_rejects",
               "policy_fenced_pushes", "rejected_compr_tags",
               "evicted_workers", "worker_evictions")

RULES = ("round_stall", "replication_lag", "shard_imbalance",
         "goodput_collapse", "rtt_outlier", "fence_spike",
         "replica_staleness", "churn_storm", "serve_overload",
         "replica_flap", "net_partition", "data_corruption")

# counters summed per node by the data_corruption rule: every reject
# the integrity plane produces (wire checksum mismatches, poisoned
# gradient pushes, corrupt checkpoint/replication snapshots) plus the
# quarantines they escalated into — a repeat offender shows up as a
# sustained per-node rate here long before training loss moves
_INTEGRITY_KEYS = ("integrity_wire_rejects", "integrity_wire_nacks",
                   "integrity_poison_rejects", "integrity_ckpt_rejects",
                   "integrity_codec_rejects", "poison_quarantines")

# membership-transition counters summed by the churn_storm rule: the
# churn orchestrator's injected-event family (registered on the global
# scheduler by chaos/churn.py) plus the organic server-side counters,
# so a storm pages whether it was scripted or real
_CHURN_KEYS = ("churn_notices", "churn_graceful_leaves",
               "churn_ungraceful_kills", "churn_joins",
               "churn_replica_kills",
               "left_workers", "evicted_workers", "joined_workers")


def _json_safe(obj):
    """NaN-fenced copy (invalid-JSON floats become None)."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


class HealthEngine:
    """One per deployment, beside the MetricsCollector on the global
    scheduler.  ``Config.obs_interval_s <= 0`` runs no sweep thread —
    tests drive :meth:`tick` deterministically."""

    def __init__(self, collector, config=None, trace_collector=None):
        from geomx_tpu_torch.trace.recorder import get_tracer

        self.collector = collector
        self.config = config or collector.config
        self.trace_collector = trace_collector
        self.node = collector.node
        cfg = self.config
        self.stall_factor = float(getattr(cfg, "obs_stall_factor", 4.0))
        self.stall_min_s = float(getattr(cfg, "obs_stall_min_s", 2.0))
        self.repl_lag_s = float(getattr(cfg, "obs_repl_lag_s", 60.0))
        self.rtt_s = float(getattr(cfg, "obs_rtt_s", 1.0))
        self.goodput_frac = float(getattr(cfg, "obs_goodput_frac", 0.1))
        self.fence_spike = int(getattr(cfg, "obs_fence_spike", 8))
        self.imbalance_factor = float(
            getattr(cfg, "obs_imbalance_factor", 4.0))
        self.shed_rate = float(getattr(cfg, "obs_shed_rate", 2.0))
        self.replica_flap = int(getattr(cfg, "obs_replica_flap", 2))
        self.alert_log = str(getattr(cfg, "obs_alert_log", "") or "")
        self._mu = threading.Lock()
        self.active: Dict[Tuple[str, str], dict] = {}
        self.alerts: List[dict] = []      # transition history, bounded
        self._cap = 4096
        # round_stall bookkeeping: per shard subject, the last seen
        # (boot, value) per reporting node + progress times + gaps
        self._stall: Dict[str, dict] = {}
        self._peak_rate: Dict[str, float] = {}
        self._tr = get_tracer(self.node)
        self._alert_counter = system_counter(f"{self.node}.health_alerts")
        self._recovery_counter = system_counter(
            f"{self.node}.health_recoveries")
        self._rule_counters = {r: system_counter(
            f"{self.node}.health_{r}_alerts") for r in RULES}
        self._stop = threading.Event()
        self._thread = None
        # flight-recorder incident trigger: each FIRING transition
        # broadcasts Control.FLIGHT_DUMP so EVERY node snapshots the
        # same incident window (obs/flight.py); the counter keys the
        # incident ids so two transitions never collide on one file.
        # Per-(rule, subject) cooldown: the FIRST firing captures the
        # evidence; a flapping rule re-firing inside the window must
        # not flood the dump dir with near-identical snapshots
        self._flight_incidents = 0
        self._flight_last: Dict[Tuple[str, str], float] = {}
        self._flight_cooldown = float(
            getattr(cfg, "obs_flight_cooldown_s", 60.0))
        if getattr(cfg, "obs_interval_s", 0) > 0:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"health-engine-{self.node}")
            self._thread.start()

    def _run(self):
        while not self._stop.wait(self.config.obs_interval_s):
            try:
                self.tick()
            except Exception:  # a sweep error must not kill the loop
                import logging

                logging.getLogger(__name__).exception(
                    "%s: health sweep failed", self.node)

    # ---- evaluation ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation sweep; returns the NEW transition records
        (alerts + recoveries) it produced.  ``now`` is injectable for
        deterministic tests."""
        now = time.monotonic() if now is None else now
        records = []
        for rule in (self._rule_round_stall, self._rule_replication_lag,
                     self._rule_shard_imbalance, self._rule_goodput_collapse,
                     self._rule_rtt_outlier, self._rule_fence_spike,
                     self._rule_replica_staleness, self._rule_churn_storm,
                     self._rule_serve_overload, self._rule_replica_flap,
                     self._rule_net_partition,
                     self._rule_data_corruption):
            try:
                records.extend(rule(now))
            except Exception:  # one broken rule must not mute the rest
                import logging

                logging.getLogger(__name__).exception(
                    "%s: health rule %s failed", self.node, rule.__name__)
        return records

    def active_alerts(self) -> List[dict]:
        with self._mu:
            return [dict(a) for a in self.active.values()]

    # ---- state machine ------------------------------------------------------
    def _set_state(self, rule: str, subject: str, firing: bool, now: float,
                   severity: str = "warn", message: str = "",
                   **data) -> Optional[dict]:
        key = (rule, subject)
        with self._mu:
            cur = self.active.get(key)
            if firing and cur is None:
                rec = {"rule": rule, "subject": subject, "state": "firing",
                       "severity": severity, "t": time.time(),
                       "t_mono": now, "message": message,
                       "data": _json_safe(data)}
                self.active[key] = rec
            elif not firing and cur is not None:
                del self.active[key]
                rec = {"rule": rule, "subject": subject,
                       "state": "recovered", "severity": cur["severity"],
                       "t": time.time(), "t_mono": now,
                       "firing_for_s": round(now - cur["t_mono"], 3),
                       "message": message or "condition cleared",
                       "data": _json_safe(data)}
            else:
                return None
        self._emit(rec)
        return rec

    def _emit(self, rec: dict) -> None:
        firing = rec["state"] == "firing"
        if firing:
            # snapshot the incident window BEFORE anything else: every
            # node's flight ring dumps under one incident id, and the
            # alert record carries the dump paths (obs/flight.py)
            flight = self._request_flight_dump(rec)
            if flight is not None:
                rec.setdefault("data", {})["flight"] = flight
        with self._mu:
            self.alerts.append(rec)
            del self.alerts[:-self._cap]
        if firing:
            self._alert_counter.inc()
            self._rule_counters[rec["rule"]].inc()
        else:
            self._recovery_counter.inc()
        # alerts land on the merged trace timeline like failover events
        self._tr.instant("health.alert", rule=rec["rule"],
                         subject=rec["subject"], state=rec["state"],
                         severity=rec["severity"])
        print(f"{self.node}: health "
              f"{'ALERT' if firing else 'RECOVERED'} {rec['rule']} "
              f"{rec['subject']} — {rec['message']}", flush=True)
        if self.alert_log:
            try:
                with open(self.alert_log, "a") as f:
                    f.write(json.dumps(rec, allow_nan=False) + "\n")
            except (OSError, ValueError):
                pass  # the log is best-effort; registry/stdout remain

    def _request_flight_dump(self, rec: dict) -> Optional[dict]:
        """Broadcast ``Control.FLIGHT_DUMP`` for one firing transition:
        exactly one incident id per transition, so every node dumps
        exactly once per alert (the per-node recorders dedup
        rebroadcasts by the id).  Returns the info dict the alert
        record carries (None when the recorder plane or GEOMX_OBS_DIR
        is off)."""
        import os

        po = self.collector.po
        if getattr(po, "flight", None) is None:
            return None
        out_dir = os.environ.get("GEOMX_OBS_DIR", "")
        if not out_dir:
            return None
        from geomx_tpu_torch.obs.flight import broadcast_flight_dump

        key = (rec["rule"], rec["subject"])
        now = rec["t_mono"]
        with self._mu:
            last = self._flight_last.get(key)
            if (last is not None and self._flight_cooldown > 0
                    and now - last < self._flight_cooldown):
                return None  # flapping: the first firing has the window
            self._flight_last[key] = now
            self._flight_incidents += 1
            n = self._flight_incidents
        subject = "".join(c if c.isalnum() else "_"
                          for c in str(rec["subject"]))
        incident = f"{rec['rule']}-{subject}-{n}"
        try:
            paths = broadcast_flight_dump(po, out_dir, incident,
                                          rule=rec["rule"],
                                          subject=rec["subject"])
        except Exception:  # the dump trigger must never mute the alert
            return None
        return {"incident": incident, "dir": out_dir, "paths": paths}

    # ---- rules --------------------------------------------------------------
    def _rule_round_stall(self, now: float) -> List[dict]:
        out = []
        topo = self.collector.po.topology
        nodes = self.collector.nodes()
        for k in range(topo.num_global_servers):
            subject = f"shard:{k}"
            st = self._stall.setdefault(subject, {
                "v": {}, "t_prog": None,
                "gaps": collections.deque(maxlen=32)})
            progressed = False
            for node in nodes:
                if _shard_of(node) != k:
                    continue
                sample = self.collector.latest(node)
                if sample is None:
                    continue
                v = self.collector._get(sample, node, "key_rounds")
                if not isinstance(v, (int, float)):
                    continue
                boot = sample.get("boot", 0)
                prev = st["v"].get(node)
                st["v"][node] = (boot, v)
                # progress only counts within one boot: a restarted
                # holder's zeroed counter re-baselines instead of
                # masking (or faking) progress
                if prev is not None and prev[0] == boot and v > prev[1]:
                    progressed = True
            if progressed:
                if st["t_prog"] is not None:
                    st["gaps"].append(now - st["t_prog"])
                st["t_prog"] = now
            if st["t_prog"] is None:
                continue  # this shard never completed a round yet
            med = statistics.median(st["gaps"]) if st["gaps"] else 0.0
            limit = max(self.stall_min_s, self.stall_factor * med)
            stalled = now - st["t_prog"]
            rec = self._set_state(
                "round_stall", subject, stalled > limit, now,
                severity="critical",
                message=(f"no key-round completed in {stalled:.2f}s "
                         f"(limit {limit:.2f}s)" if stalled > limit
                         else f"round completed after {stalled:.2f}s"),
                stalled_for_s=round(stalled, 3), limit_s=round(limit, 3))
            if rec:
                out.append(rec)
        return out

    def _rule_replication_lag(self, now: float) -> List[dict]:
        out = []
        for node in self.collector.nodes():
            v = self.collector.value(node, "replication_lag_s")
            if not isinstance(v, (int, float)):
                continue
            rec = self._set_state(
                "replication_lag", node, v > self.repl_lag_s, now,
                message=f"standby lag {v:.1f}s (ceiling "
                        f"{self.repl_lag_s:.0f}s)",
                lag_s=round(float(v), 3), ceiling_s=self.repl_lag_s)
            if rec:
                out.append(rec)
        return out

    def _rule_shard_imbalance(self, now: float) -> List[dict]:
        if self.trace_collector is None:
            return []
        try:
            rounds = self.trace_collector.critical_path().get("rounds") or ()
        except Exception:
            return []
        if not rounds:
            return []
        by_shard = rounds[-1].get("by_shard") or {}
        if len(by_shard) < 2:
            return []
        slowest = max(by_shard, key=by_shard.get)
        others = [v for s, v in by_shard.items() if s != slowest]
        mean = sum(others) / len(others)
        firing = mean > 0 and by_shard[slowest] > self.imbalance_factor * mean
        out = []
        for s in by_shard:
            rec = self._set_state(
                "shard_imbalance", f"shard:{s}",
                firing and s == slowest, now,
                message=f"shard busy {by_shard[s] / 1e3:.1f}ms vs peer "
                        f"mean {mean / 1e3:.1f}ms",
                busy_us=by_shard[s], peer_mean_us=mean)
            if rec:
                out.append(rec)
        return out

    def _rule_goodput_collapse(self, now: float) -> List[dict]:
        out = []
        for node in self.collector.nodes():
            if not node.startswith("server:"):
                continue  # WAN senders only (the local servers)
            rate = self.collector.rate(node, "wan_send_bytes")
            if rate is None:
                continue
            peak = self._peak_rate.get(node, 0.0)
            self._peak_rate[node] = max(peak, rate)
            rounds_rate = self.collector.rate(node, "wan_push_rounds")
            firing = (peak > 0 and rate < self.goodput_frac * peak
                      and bool(rounds_rate) and rounds_rate > 0)
            rec = self._set_state(
                "goodput_collapse", node, firing, now,
                message=f"WAN goodput {rate / 1e6:.2f} MB/s vs peak "
                        f"{max(peak, rate) / 1e6:.2f} MB/s",
                goodput_bps=rate, peak_bps=max(peak, rate))
            if rec:
                out.append(rec)
        return out

    def _rule_rtt_outlier(self, now: float) -> List[dict]:
        rtts = {}
        for node in self.collector.nodes():
            v = self.collector.value(node, "heartbeat_rtt_s")
            if isinstance(v, (int, float)) and math.isfinite(v):
                rtts[node] = float(v)
        med = statistics.median(rtts.values()) if len(rtts) >= 3 else None
        out = []
        for node, v in rtts.items():
            firing = v > self.rtt_s or (
                med is not None and v > 8 * max(med, 1e-3))
            rec = self._set_state(
                "rtt_outlier", node, firing, now,
                message=f"heartbeat RTT {v * 1e3:.1f}ms "
                        + (f"(fleet median {med * 1e3:.1f}ms)"
                           if med is not None else
                           f"(ceiling {self.rtt_s:.2f}s)"),
                rtt_s=v, median_s=med)
            if rec:
                out.append(rec)
        return out

    def _rule_fence_spike(self, now: float) -> List[dict]:
        out = []
        for node in self.collector.nodes():
            total = 0.0
            seen = False
            for key in _FENCE_KEYS:
                pts = self.collector.series(node, key)
                if len(pts) >= 2:
                    seen = True
                    total += pts[-1][1] - pts[0][1]
            if not seen:
                continue
            rec = self._set_state(
                "fence_spike", node, total > self.fence_spike, now,
                message=f"{total:.0f} fenced/evicted events in the "
                        f"window (threshold {self.fence_spike})",
                events=total, threshold=self.fence_spike)
            if rec:
                out.append(rec)
        return out

    def _rule_data_corruption(self, now: float) -> List[dict]:
        """Sustained integrity rejects from one node mean its data path
        is rotting — a flaky NIC corrupting frames, a worker emitting
        NaN gradients, a disk eating checkpoint generations.  Any
        single reject is survivable by design (checksum → NACK resend,
        poison → zeroed + typed error, corrupt snapshot → previous
        generation); this rule pages when the RATE says the fault is
        chronic, naming the offender the quarantine machinery is
        already throttling."""
        bound = int(getattr(self.config, "obs_corruption_events", 8))
        out = []
        for node in self.collector.nodes():
            total = 0.0
            quarantines = 0.0
            seen = False
            for key in _INTEGRITY_KEYS:
                pts = self.collector.series(node, key)
                if len(pts) >= 2:
                    seen = True
                    delta = pts[-1][1] - pts[0][1]
                    total += delta
                    if key == "poison_quarantines":
                        quarantines += delta
            if not seen:
                continue
            rec = self._set_state(
                "data_corruption", node, total > bound, now,
                severity="critical" if quarantines else "warn",
                message=f"{total:.0f} integrity rejects in the window "
                        f"(threshold {bound}"
                        + (f", {quarantines:.0f} quarantines)"
                           if quarantines else ")"),
                events=total, quarantines=quarantines, threshold=bound)
            if rec:
                out.append(rec)
        return out

    def _rule_churn_storm(self, now: float) -> List[dict]:
        """Elastic membership under churn is NORMAL (docs/deployment.md
        "Elasticity & preemption") — but a membership-transition RATE
        past ``obs_churn_storm`` per collector window means the fleet
        is thrashing (preemption wave, flapping autoscaler), and a
        survivor count at the churn plan's min-survivor floor means the
        next departure stalls training.  Two subjects: ``cluster``
        (event rate) and ``survivor_floor`` (the orchestrator's
        ``churn_survivors`` / ``churn_min_survivors`` gauges)."""
        bound = int(getattr(self.config, "obs_churn_storm", 16))
        out = []
        total = 0.0
        seen = False
        for node in self.collector.nodes():
            for key in _CHURN_KEYS:
                pts = self.collector.series(node, key)
                if len(pts) >= 2:
                    seen = True
                    total += pts[-1][1] - pts[0][1]
        if seen:
            rec = self._set_state(
                "churn_storm", "cluster", total > bound, now,
                message=f"{total:.0f} membership transitions in the "
                        f"window (threshold {bound})",
                events=total, threshold=bound)
            if rec:
                out.append(rec)
        # min-survivor floor: gauges shipped by the churn orchestrator
        # (absent outside orchestrated runs — nothing to judge then)
        survivors = floor = None
        for node in self.collector.nodes():
            s = self.collector.value(node, "churn_survivors")
            f = self.collector.value(node, "churn_min_survivors")
            if isinstance(s, (int, float)) and isinstance(f, (int, float)):
                survivors, floor = float(s), float(f)
                break
        if survivors is not None and floor is not None and floor > 0:
            firing = survivors <= floor + 1
            rec = self._set_state(
                "churn_storm", "survivor_floor", firing, now,
                severity="critical",
                message=(f"{survivors:.0f} survivors at the churn "
                         f"plan's floor ({floor:.0f}) — the next "
                         "departure stalls training" if firing else
                         f"{survivors:.0f} survivors, clear of the "
                         f"floor ({floor:.0f})"),
                survivors=survivors, floor=floor)
            if rec:
                out.append(rec)
        return out

    def _rule_serve_overload(self, now: float) -> List[dict]:
        """A sustained admission-control shed rate is the serving
        plane's capacity alarm: the replica is protecting its latency
        by refusing reads (the intended degradation), but the refusals
        are landing on real clients — add capacity or raise the
        budget (docs/serving.md)."""
        out = []
        for node in self.collector.nodes():
            if not node.startswith("replica:"):
                continue
            rate = self.collector.rate(node, "serve_sheds")
            if rate is None:
                continue
            rec = self._set_state(
                "serve_overload", node, rate > self.shed_rate, now,
                message=(f"shedding {rate:.1f} reads/s with RETRY_AFTER "
                         f"(threshold {self.shed_rate:.1f}/s)"
                         if rate > self.shed_rate else
                         f"shed rate {rate:.1f}/s, back under the "
                         f"threshold ({self.shed_rate:.1f}/s)"),
                shed_rate=round(float(rate), 3),
                threshold=self.shed_rate)
            if rec:
                out.append(rec)
        return out

    def _rule_replica_flap(self, now: float) -> List[dict]:
        """Autoscaler direction reversals inside cooldown
        (``autoscale_flaps``, shipped by the global scheduler's own
        pump): the scaling signals oscillate faster than the
        hysteresis can follow — the actuated sequence stays stable
        (cooldown blocks the reversal), but the operator should widen
        the deadband or lengthen the cooldown."""
        total = 0.0
        seen = False
        for node in self.collector.nodes():
            pts = self.collector.series(node, "autoscale_flaps")
            if len(pts) >= 2:
                seen = True
                total += pts[-1][1] - pts[0][1]
        if not seen:
            return []
        rec = self._set_state(
            "replica_flap", "autoscaler",
            total >= self.replica_flap, now,
            message=f"{total:.0f} suppressed direction reversals in "
                    f"the window (threshold {self.replica_flap})",
            reversals=total, threshold=self.replica_flap)
        return [rec] if rec else []

    def _rule_net_partition(self, now: float) -> List[dict]:
        """A nonzero ``quarantined_nodes`` gauge (shipped by the party
        schedulers' worker monitors and the global scheduler's recovery
        monitor) means the quarantine-not-evict machinery is holding a
        suspect in limbo: heartbeats expired but an indirect probe
        still hears it.  Degraded but self-healing — the alert clears
        on heal (unquarantine) or when the escalation paths (eviction /
        party fold) take over."""
        total = 0.0
        seen = False
        for node in self.collector.nodes():
            v = self.collector.value(node, "quarantined_nodes")
            if isinstance(v, (int, float)) and math.isfinite(v):
                seen = True
                total += float(v)
        if not seen:
            return []
        rec = self._set_state(
            "net_partition", "cluster", total > 0, now,
            message=(f"{total:.0f} node(s)/part(ies) quarantined — "
                     "heartbeat-dead but probe-alive; training runs "
                     "degraded until the partition heals" if total > 0
                     else "all quarantines lifted"),
            quarantined=total)
        return [rec] if rec else []

    def _rule_replica_staleness(self, now: float) -> List[dict]:
        out = []
        bound = float(getattr(self.config, "serve_staleness_s", 5.0))
        for node in self.collector.nodes():
            if not node.startswith("replica:"):
                continue
            v = self.collector.value(node, "staleness_s")
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                continue  # never refreshed yet: nothing to judge
            rec = self._set_state(
                "replica_staleness", node, v > bound, now,
                message=f"local model copy {v:.2f}s old (read bound "
                        f"{bound:.2f}s — reads are parking)"
                if v > bound else
                f"local copy {v:.2f}s old, back under the bound",
                staleness_s=round(float(v), 3), bound_s=bound)
            if rec:
                out.append(rec)
        return out

    def stop(self):
        self._stop.set()
