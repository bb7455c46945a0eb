"""Epoch-fenced WAN reconfiguration controller (global scheduler).

The controller closes the loop PR 3 left open: it samples the signal
estimators, asks the hysteresis policy engine for a decision, and
actuates it with a two-phase, epoch-fenced broadcast of
``Ctrl.SET_WAN_POLICY {epoch, compression}``:

1. **receivers first** — every global server adopts the new policy
   immediately (decode parameters + a rebuilt pull compressor whose
   tracked views are invalidated through the existing version-handshake
   path, so subscribers resync dense on their next pull);
2. **senders second** — every local server stores the policy as
   *pending* and applies it atomically at its next WAN round boundary
   (a round's whole push batch is always encoded under one epoch).

Gradient pushes carry ``Message.policy_epoch``; a receiver on a
different epoch fences the payload with a **retryable** error that also
carries its current policy, and the sender re-encodes the stashed raw
gradients under that policy and retries — so a broadcast lost to either
side never corrupts a merge and never wedges a round (see
docs/adaptive-wan.md for the full protocol walk-through).

Every decision is (a) counted/gauged in the system-metrics registry
(``<gsched>.wan_policy_*``), (b) stamped as a trace instant
(``wanpolicy.decision``) so it lands on the PR 3 merged timeline, and
(c) printed — three independent ways to audit what the loop did.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from geomx_tpu_torch.core.config import Config, Role
from geomx_tpu_torch.control.policy import Decision, WanPolicyEngine
from geomx_tpu_torch.control.signals import SignalEstimator
from geomx_tpu_torch.kvstore.common import APP_PS, Ctrl
from geomx_tpu_torch.ps import Postoffice
from geomx_tpu_torch.ps.kv_app import _App
from geomx_tpu_torch.trace.recorder import get_tracer
from geomx_tpu_torch.transport.message import Domain, Message
from geomx_tpu_torch.utils.metrics import system_counter, system_gauge

# customer id for the controller's command endpoint on the scheduler's
# postoffice (the TraceCollector owns customer 0 when tracing is on;
# responses route by exact (app, customer), so they never collide)
_CTRL_CUSTOMER = 96


class _CmdEndpoint(_App):
    """Command-channel-only app: sends Ctrl.* requests, collects
    replies.  Never sees data traffic."""

    def _process(self, msg: Message):
        if not msg.push and not msg.pull:
            self._handle_command(msg)
        # a stray data message at the controller endpoint is dropped

    def rpc(self, recipient, head, body=None, timeout: float = 3.0,
            domain: Domain = Domain.GLOBAL) -> Optional[dict]:
        """One command round trip; None on timeout (peer down — the
        next sweep retries, same contract as the eviction monitors)."""
        ts = self.send_cmd(recipient, head, body=body, domain=domain,
                           wait=False)
        try:
            self.customer.wait(ts, timeout=timeout)
        except TimeoutError:
            return None
        reply = self.cmd_response(ts)
        return reply if isinstance(reply, dict) else {}


class AdaptiveWanController:
    """One per deployment, on the global scheduler's postoffice."""

    def __init__(self, postoffice: Postoffice,
                 config: Optional[Config] = None, collector=None,
                 metrics=None):
        assert postoffice.node.role is Role.GLOBAL_SCHEDULER, \
            "the adaptive WAN controller runs on the global scheduler"
        self.po = postoffice
        self.config = config or postoffice.config
        self.topology = postoffice.topology
        self.collector = collector  # TraceCollector (optional)
        self.metrics = metrics      # MetricsCollector (optional): when
        #                             the telemetry plane already pumps
        #                             QUERY_STATS-equivalent samples on
        #                             an interval, the controller reads
        #                             those instead of issuing its own
        #                             per-server QUERY_STATS sweeps
        self.metrics_samples = 0    # sweeps served from collected series
        cfg = self.config
        base = self._base_compression(cfg)
        self.engine = WanPolicyEngine(
            base,
            inter_ts=cfg.enable_inter_ts, hfa=cfg.use_hfa,
            budget_s=cfg.adapt_round_budget_s,
            deadband=cfg.adapt_deadband,
            cooldown_s=cfg.adapt_cooldown_s,
        )
        self.signals = SignalEstimator(window=cfg.adapt_window)
        self.epoch = 0
        self._mu = threading.Lock()
        self._acked: Dict[str, int] = {}   # server -> last acked epoch
        self._tr = get_tracer(str(postoffice.node))
        self._epoch_gauge = system_gauge(f"{postoffice.node}.wan_policy_epoch")
        self._epoch_gauge.set(0)
        self._counters = {a: system_counter(
            f"{postoffice.node}.wan_policy_{a}s")
            for a in ("downshift", "upshift", "manual")}
        self.refused = 0   # servers that rejected a policy (constraint)
        # global-tier failover / key-range reassignment: a promoted
        # standby (or a drain's merge target) replaces the old holder in
        # the broadcast target set.  ShardTargets is the shared
        # NEW_PRIMARY tracker every shard-addressing component uses (the
        # failover monitor self-delivers its broadcasts so this hook
        # fires even though both live on the same postoffice);
        # _broadcast_missing then reaches the new node
        from geomx_tpu_torch.kvstore.replication import ShardTargets

        self._shard_targets = ShardTargets(postoffice)
        self._app = _CmdEndpoint(APP_PS, _CTRL_CUSTOMER, postoffice)
        self._stop = threading.Event()
        self._thread = None
        if cfg.adapt_interval_s > 0:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"adaptive-wan-{postoffice.node}")
            self._thread.start()

    @staticmethod
    def _base_compression(cfg: Config) -> dict:
        base = {"type": cfg.compression or "none",
                "ratio": cfg.bsc_ratio,
                "momentum": cfg.bsc_momentum,
                "sample_rate": cfg.bsc_sample_rate,
                "threshold": cfg.twobit_threshold}
        if base["type"] == "mpq":
            base["size_bound"] = cfg.mpq_size_bound
        return base

    # ---- sampling loop ------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.config.adapt_interval_s):
            try:
                self.tick()
            except Exception:  # a sweep error must not kill the loop
                import logging

                logging.getLogger(__name__).exception(
                    "%s: adaptive-WAN sweep failed", self.po.node)

    def tick(self) -> Optional[Decision]:
        """One control iteration: sample -> decide -> actuate.  Also the
        deterministic entry point tests drive directly
        (``adapt_interval_s=0`` runs no sweep thread)."""
        stats = self._sample_servers()
        report = None
        if self.collector is not None:
            try:
                report = self.collector.critical_path()
            except Exception:  # pragma: no cover - collector mid-stop
                report = None
        sig = self.signals.ingest(time.monotonic(), stats, report)
        decision = self.engine.observe(sig)
        if decision is not None:
            self._actuate(decision)
        else:
            # re-deliver the current policy to any server that has not
            # acked it (it was down / unreachable at decision time) —
            # this is what bounds how long a fence-retry loop can last
            self._broadcast_missing()
        return decision

    def _sample_servers(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        max_age = max(2.0 * self.config.adapt_interval_s,
                      2.0 * getattr(self.config, "obs_interval_s", 0.0),
                      2.0)
        for s in self.topology.servers():
            if self.metrics is not None:
                # collected-series fast path: the pump's sample IS the
                # QUERY_STATS body, so a fresh ring entry replaces one
                # RPC round trip per server per sweep
                stats = self.metrics.latest_stats(str(s), max_age_s=max_age)
                if stats is not None:
                    out[str(s)] = stats
                    self.metrics_samples += 1
                    continue
            reply = self._app.rpc(s, Ctrl.QUERY_STATS, timeout=2.0)
            if reply is not None:
                out[str(s)] = reply
        return out

    # ---- actuation ----------------------------------------------------------
    def set_policy(self, compression: dict,
                   reason: str = "manual") -> Decision:
        """Manual override (``Simulation.set_wan_policy`` / operators):
        validated against the same constraint predicate as automatic
        decisions, then broadcast under a fresh epoch."""
        from geomx_tpu_torch.compression.codecs import compression_allowed

        ok, why = compression_allowed(
            compression.get("type", "none"),
            inter_ts=self.config.enable_inter_ts, hfa=self.config.use_hfa)
        if not ok:
            raise ValueError(why)
        d = self.engine.force(dict(compression), reason=reason)
        self._actuate(d)
        return d

    def _actuate(self, decision: Decision):
        with self._mu:
            self.epoch += 1
            epoch = self.epoch
        self._epoch_gauge.set(epoch)
        self._counters.get(decision.action,
                           self._counters["manual"]).inc()
        # the decision lands on the PR 3 merged timeline even when no
        # sampled round is open (traceless instant, like failover events)
        self._tr.instant(
            "wanpolicy.decision", epoch=epoch, action=decision.action,
            codec=decision.compression.get("type"),
            reason=decision.reason,
            round_time_s=decision.round_time_s,
            budget_s=decision.budget_s)
        print(f"{self.po.node}: WAN policy epoch {epoch} "
              f"[{decision.action}] -> {decision.compression} "
              f"({decision.reason})", flush=True)
        self._broadcast(epoch, decision.compression)

    def _policy_body(self, epoch: int, compression: dict) -> dict:
        body = {"epoch": epoch, "compression": dict(compression)}
        # fill codec knobs from config so every server sees a complete
        # parameter set (same defaulting as set_gradient_compression)
        defaults = {"ratio": self.config.bsc_ratio,
                    "momentum": self.config.bsc_momentum,
                    "sample_rate": self.config.bsc_sample_rate,
                    "threshold": self.config.twobit_threshold,
                    "size_bound": self.config.mpq_size_bound}
        body["compression"] = {**defaults, **body["compression"]}
        return body

    def _targets(self) -> List:
        """Receivers FIRST (the CURRENT holder of every global shard —
        failover- and reassignment-aware — adopts immediately), then the
        senders (local servers, apply at their next round boundary) —
        the ordering that makes an in-flight old-epoch push the rare
        case rather than the common one.  One policy epoch covers every
        shard: the broadcast walks all holders under the same epoch
        number, so cross-shard pushes of one round can never straddle
        two codecs."""
        return (self._shard_targets.global_servers()
                + list(self.topology.servers()))

    def _broadcast(self, epoch: int, compression: dict):
        body = self._policy_body(epoch, compression)
        with self._mu:
            self._current_body = body
        for node in self._targets():
            reply = self._app.rpc(node, Ctrl.SET_WAN_POLICY,
                                  body=dict(body), timeout=3.0)
            with self._mu:
                if reply is None:
                    continue  # down — _broadcast_missing retries
                if "error" in reply:
                    # a constraint the server enforces that we missed
                    # (should be impossible: same predicate both ends)
                    self.refused += 1
                    import logging

                    logging.getLogger(__name__).error(
                        "%s refused WAN policy epoch %d: %s",
                        node, epoch, reply["error"])
                else:
                    self._acked[str(node)] = epoch

    def _broadcast_missing(self):
        targets = self._targets()  # outside _mu (it locks internally)
        with self._mu:
            epoch = self.epoch
            body = getattr(self, "_current_body", None)
            missing = [n for n in targets
                       if self._acked.get(str(n), 0) < epoch]
        if not body or epoch == 0 or not missing:
            return
        for node in missing:
            reply = self._app.rpc(node, Ctrl.SET_WAN_POLICY,
                                  body=dict(body), timeout=2.0)
            if reply is not None and "error" not in reply:
                with self._mu:
                    self._acked[str(node)] = epoch

    # ---- introspection ------------------------------------------------------
    def status(self) -> dict:
        with self._mu:
            return {
                "epoch": self.epoch,
                "compression": self.engine.current,
                "budget_s": self.engine.budget_s,
                "decisions": len(self.engine.decisions),
                "vetoes": self.engine.vetoes,
                "acked": dict(self._acked),
            }

    def stop(self):
        self._stop.set()
        self._app.stop()
