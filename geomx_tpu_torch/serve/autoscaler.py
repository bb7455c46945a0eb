"""Replica autoscaler: telemetry-driven elastic serve capacity.

The serving tier's capacity was static (PR 8: ``--replicas K`` forever).
:class:`ReplicaAutoscaler` closes the loop on the global scheduler, the
same shape as the PR 4 ``WanPolicyEngine``: sample the telemetry
plane's per-replica series (``serve_qps`` / shed rate / ``serve_p99_ms``
/ staleness), decide with **deadband + patience + cooldown** hysteresis,
and actuate through the machinery the tier already has:

- **scale down** is reversible retirement: ``Ctrl.SERVE_SCALE
  {active: False}`` tells the replica to pause its refresh loop and
  shed reads with the explicit RETRY_AFTER signal (the balancer routes
  away within one view refresh), then the shard holders get
  ``Control.EVICT {subscriber_prune}`` — the PR 8 eviction actuation —
  so the retired copy's tracked pull views stop pinning a full model;
- **scale up** prefers reactivating a retired-but-live replica
  (``SERVE_SCALE {active: True}``: its next refresh resyncs DENSE,
  exactly the eviction→rejoin heal), and otherwise asks the harness's
  ``spawn`` callback to start replica rank K (a real deployment maps
  this to its process manager; ``Simulation`` maps it to
  ``restart_replica``) — the :class:`~geomx_tpu_torch.serve.monitor.
  ReplicaMonitor` then observes the heartbeats exactly as it would any
  operator-started replica.

Hysteresis discipline: scale-up needs ``serve_scale_patience``
consecutive overloaded sweeps, scale-down twice that (shrinking is the
risky direction), and any action freezes decisions for
``serve_scale_cooldown_s``.  A desired direction that REVERSES the last
action inside its cooldown is counted (``autoscale_flaps`` — the
``replica_flap`` health rule pages on it) but never executed, so the
actuated sequence can never flap faster than the cooldown.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from geomx_tpu_torch.core.config import Config, Role
from geomx_tpu_torch.kvstore.common import Ctrl
from geomx_tpu_torch.ps import Postoffice
from geomx_tpu_torch.ps.kv_app import _App
from geomx_tpu_torch.trace.recorder import get_tracer
from geomx_tpu_torch.transport.message import Control, Domain, Message
from geomx_tpu_torch.utils.metrics import system_counter, system_gauge

# customer id for the autoscaler's command endpoint on the scheduler's
# postoffice (the adaptive-WAN controller owns 96; responses route by
# exact (app, customer), so they never collide)
_SCALE_CUSTOMER = 97


class _CmdEndpoint(_App):
    """Command-channel-only app: sends Ctrl.* requests, collects
    replies.  Never sees data traffic."""

    def _process(self, msg: Message):
        if not msg.push and not msg.pull:
            self._handle_command(msg)

    def rpc(self, recipient, head, body=None, timeout: float = 3.0,
            domain: Domain = Domain.GLOBAL) -> Optional[dict]:
        ts = self.send_cmd(recipient, head, body=body, domain=domain,
                           wait=False)
        try:
            self.customer.wait(ts, timeout=timeout)
        except TimeoutError:
            return None
        reply = self.cmd_response(ts)
        return reply if isinstance(reply, dict) else {}


class ReplicaAutoscaler:
    """One per deployment, on the global scheduler's postoffice.
    ``serve_scale_interval_s <= 0`` runs no sweep thread — tests (and
    the bench soak) drive :meth:`tick` deterministically."""

    def __init__(self, postoffice: Postoffice,
                 config: Optional[Config] = None, collector=None,
                 spawn: Optional[Callable[[int], None]] = None,
                 retire_cb: Optional[Callable[[int], None]] = None):
        assert postoffice.node.role is Role.GLOBAL_SCHEDULER, \
            "the replica autoscaler runs on the global scheduler"
        from geomx_tpu_torch.kvstore.replication import ShardTargets

        self.po = postoffice
        self.config = config or postoffice.config
        self.collector = collector
        self.spawn = spawn          # start replica rank K (cold)
        self.retire_cb = retire_cb  # optional host reclaim after retire
        self.topology = postoffice.topology
        cfg = self.config
        self.min_replicas = int(cfg.serve_min_replicas)
        self.max_replicas = int(cfg.serve_max_replicas
                                or self.topology.num_replicas)
        self.max_replicas = min(self.max_replicas,
                                self.topology.num_replicas)
        self.cooldown_s = float(cfg.serve_scale_cooldown_s)
        self.patience = max(1, int(cfg.serve_scale_patience))
        self.target_qps = float(cfg.serve_target_qps)
        self.p99_ms = float(cfg.serve_scale_p99_ms)
        self.bound_s = float(cfg.serve_staleness_s)
        # rate reads look back a bounded window (not the whole ring):
        # a shed burst from minutes ago must not read as CURRENT
        # overload for as long as the ring remembers it
        self.lookback_s = max(5.0, 3.0 * float(cfg.serve_scale_interval_s))
        self._shards = ShardTargets(postoffice)
        self._cmd = _CmdEndpoint(0, _SCALE_CUSTOMER, postoffice)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._evict_replies: Dict[str, dict] = {}
        postoffice.add_control_hook(self._on_control)
        self._retired: set = set()   # ranks we scaled down (reversible)
        self._over = 0
        self._under = 0
        self._last_action = -float("inf")
        self._last_dir = 0
        self._flap_marked = False
        self.decisions: List[dict] = []  # audit trail
        self.flaps = 0
        n = str(postoffice.node)
        self._c_ups = system_counter(f"{n}.autoscale_ups")
        self._c_downs = system_counter(f"{n}.autoscale_downs")
        self._c_flaps = system_counter(f"{n}.autoscale_flaps")
        self._g_desired = system_gauge(f"{n}.serve_desired_replicas")
        self._g_active = system_gauge(f"{n}.serve_active_replicas")
        self._tr = get_tracer(n)
        self._stop = threading.Event()
        self._thread = None
        iv = float(cfg.serve_scale_interval_s)
        if iv > 0:
            self._thread = threading.Thread(
                target=self._run, args=(iv,), daemon=True,
                name=f"replica-autoscaler-{postoffice.node}")
            self._thread.start()

    def _run(self, interval: float):
        while not self._stop.wait(interval):
            try:
                self.tick()
            except Exception:  # a sweep error must not kill the loop
                import logging

                logging.getLogger(__name__).exception(
                    "%s: autoscaler sweep failed", self.po.node)

    # ---- membership view -----------------------------------------------------
    def _on_control(self, msg: Message) -> bool:
        """Token-matched EVICT replies for the subscriber-prune RPC
        (observe-only: the recovery/replica monitors on this node see
        their own tokens)."""
        if msg.control is Control.EVICT and not msg.request:
            b = msg.body if isinstance(msg.body, dict) else {}
            token = b.get("token")
            if isinstance(token, str) and token.startswith("autoscale#"):
                with self._cv:
                    self._evict_replies[token] = b
                    while len(self._evict_replies) > 256:
                        self._evict_replies.pop(
                            next(iter(self._evict_replies)))
                    self._cv.notify_all()
                return True
        return False

    def live_ranks(self) -> List[int]:
        """Replica ranks currently alive: heartbeat freshness when
        heartbeats run, else collector visibility, else the whole
        plan (nothing to judge by)."""
        topo = self.topology
        ranks = list(range(topo.num_replicas))
        if self.config.heartbeat_interval_s > 0:
            info, epoch = self.po.heartbeat_info()
            now = time.monotonic()
            out = []
            for r in ranks:
                s = str(topo.replica(r))
                t, _boot = info.get(s, (None, 0))
                age = now - (t if t is not None else epoch)
                if age <= self.config.heartbeat_timeout_s:
                    out.append(r)
            return out
        if self.collector is not None:
            seen = [r for r in ranks
                    if self.collector.latest(str(topo.replica(r)))
                    is not None]
            if seen:
                return seen
        return ranks

    def active_ranks(self) -> List[int]:
        return [r for r in self.live_ranks() if r not in self._retired]

    # ---- signals -------------------------------------------------------------
    def _signals(self, active: List[int]) -> dict:
        out = {"qps": None, "shed_rate": None, "p99_ms": None,
               "staleness_worst_s": None}
        if self.collector is None or not active:
            return out
        qps = shed = 0.0
        saw_rate = False
        p99: Optional[float] = None
        stale: Optional[float] = None
        for r in active:
            node = str(self.topology.replica(r))
            v = self.collector.rate(node, "serve_pulls",
                                    lookback_s=self.lookback_s)
            if v is not None:
                qps += max(0.0, v)
                saw_rate = True
            v = self.collector.rate(node, "serve_sheds",
                                    lookback_s=self.lookback_s)
            if v is not None:
                shed += max(0.0, v)
                saw_rate = True
            st = self.collector.latest_stats(node) or {}
            v = st.get("serve_p99_ms")
            if isinstance(v, (int, float)):
                p99 = max(p99 or 0.0, float(v))
            v = st.get("staleness_s")
            if isinstance(v, (int, float)):
                stale = max(stale or 0.0, float(v))
        if saw_rate:
            out["qps"] = qps
            out["shed_rate"] = shed
        out["p99_ms"] = p99
        out["staleness_worst_s"] = stale
        return out

    def _direction(self, sig: dict, n_active: int) -> int:
        """+1 = overloaded (grow), -1 = idle (shrink), 0 = in band."""
        shed = sig.get("shed_rate")
        if shed is not None and shed > 0.0:
            return +1
        p99 = sig.get("p99_ms")
        if self.p99_ms > 0 and isinstance(p99, (int, float)) \
                and p99 > self.p99_ms:
            return +1
        stale = sig.get("staleness_worst_s")
        if isinstance(stale, (int, float)) and stale > self.bound_s:
            return +1
        qps = sig.get("qps")
        if self.target_qps > 0 and qps is not None and n_active > 0:
            if qps / n_active > self.target_qps:
                return +1
            # shrink only when the load would STILL sit comfortably
            # under target after losing one replica (the deadband: no
            # thrash at the boundary)
            if qps / max(n_active - 1, 1) < 0.5 * self.target_qps:
                return -1
        return 0

    # ---- decision loop -------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One sweep: sample -> hysteresis -> at most one scaling
        action.  Returns the decision record (also appended to
        ``decisions``) or None."""
        now = time.monotonic() if now is None else now
        live = self.live_ranks()
        active = [r for r in live if r not in self._retired]
        n = len(active)
        self._g_active.set(float(n))
        self._g_desired.set(float(n))
        sig = self._signals(active)
        want = self._direction(sig, n)
        if want > 0:
            self._over += 1
            self._under = 0
        elif want < 0:
            self._under += 1
            self._over = 0
        else:
            self._over = self._under = 0
        if now - self._last_action < self.cooldown_s:
            # cooling down: keep counting, never act — and count an
            # attempted direction REVERSAL (the flap the health rule
            # pages on) exactly once per cooldown window
            if (want != 0 and self._last_dir != 0
                    and want != self._last_dir
                    and not self._flap_marked):
                self._flap_marked = True
                self.flaps += 1
                self._c_flaps.inc()
            return None
        if self._over >= self.patience and n < self.max_replicas:
            return self._act(+1, live, active, sig, now)
        # shrinking needs twice the patience: the risky direction is
        # the one that gives capacity back
        if self._under >= 2 * self.patience and n > self.min_replicas:
            return self._act(-1, live, active, sig, now)
        return None

    def _act(self, direction: int, live: List[int], active: List[int],
             sig: dict, now: float) -> Optional[dict]:
        if direction > 0:
            rank, how = self._scale_up(live, active)
        else:
            rank, how = self._scale_down(active)
        if rank is None:
            return None
        self._over = self._under = 0
        self._last_action = now
        self._last_dir = direction
        self._flap_marked = False
        (self._c_ups if direction > 0 else self._c_downs).inc()
        n_after = len(active) + direction
        self._g_desired.set(float(n_after))
        rec = {
            "action": "scale_up" if direction > 0 else "scale_down",
            "replica": rank, "how": how, "active_after": n_after,
            "t_mono": now, "signals": dict(sig),
        }
        self.decisions.append(rec)
        del self.decisions[:-256]
        self._tr.instant("autoscale.decision", action=rec["action"],
                         replica=rank, active=n_after)
        print(f"{self.po.node}: autoscale {rec['action']} replica:"
              f"{rank} via {how} (active={n_after}, "
              f"qps={sig.get('qps')}, shed={sig.get('shed_rate')}, "
              f"p99={sig.get('p99_ms')})", flush=True)
        return rec

    # ---- actuation -----------------------------------------------------------
    def _scale_up(self, live: List[int], active: List[int]):
        # prefer reactivating a retired-but-live replica: one
        # SERVE_SCALE round trip and a dense resync, no cold start
        for r in sorted(self._retired):
            if r in live:
                reply = self._cmd.rpc(self.topology.replica(r),
                                      Ctrl.SERVE_SCALE,
                                      body={"active": True})
                if reply is not None and reply.get("ok"):
                    self._retired.discard(r)
                    return r, "reactivate"
        if self.spawn is not None:
            for r in range(self.topology.num_replicas):
                if r not in live:
                    self._retired.discard(r)
                    try:
                        self.spawn(r)
                    except Exception:
                        import logging

                        logging.getLogger(__name__).exception(
                            "%s: replica spawn(%d) failed",
                            self.po.node, r)
                        return None, ""
                    return r, "spawn"
        return None, ""

    def _scale_down(self, active: List[int]):
        if not active:
            return None, ""
        r = max(active)  # keep the low ranks stable
        reply = self._cmd.rpc(self.topology.replica(r), Ctrl.SERVE_SCALE,
                              body={"active": False})
        if reply is None or not reply.get("ok"):
            return None, ""  # unreachable: the monitor's eviction path
            #                  owns a genuinely dead replica
        self._retired.add(r)
        self._prune_views(r)
        if self.retire_cb is not None:
            try:
                self.retire_cb(r)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "%s: retire_cb(%d) failed", self.po.node, r)
        return r, "retire"

    def _prune_views(self, rank: int):
        """Free the retired replica's tracked pull views at every shard
        holder — the same ``EVICT {subscriber_prune}`` actuation the
        ReplicaMonitor fires for a dead replica, so a retired copy
        stops pinning one full model per shard."""
        replica_s = str(self.topology.replica(rank))
        for gs in self._shards.global_servers():
            token = f"autoscale#{uuid.uuid4().hex[:8]}"
            try:
                self.po.van.send(Message(
                    recipient=gs, control=Control.EVICT,
                    domain=Domain.GLOBAL, request=True,
                    body={"action": "subscriber_prune",
                          "node": replica_s, "token": token}))
            except (KeyError, OSError):
                continue  # shard mid-failover; the monitor's eviction
                #           path re-prunes if the replica later dies
            with self._cv:
                self._cv.wait_for(lambda: token in self._evict_replies,
                                  timeout=2.0)
                self._evict_replies.pop(token, None)

    # ---- observability -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "active_replicas": len(self.active_ranks()),
            "live_replicas": len(self.live_ranks()),
            "retired": sorted(self._retired),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "scale_ups": self._c_ups.value,
            "scale_downs": self._c_downs.value,
            "flaps": self.flaps,
            "decisions": len(self.decisions),
        }

    def stop(self):
        self._stop.set()
        self._cmd.stop()
