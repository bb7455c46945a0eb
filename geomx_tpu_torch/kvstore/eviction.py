"""Crash-tolerant membership: the failure detector ACTUATES.

PR 1 gave the heartbeat table its first consumer at the global tier
(``GlobalFailoverMonitor`` → hot-standby promotion).  The two lower HiPS
tiers still dead-waited on crashes: a worker that died without a graceful
leave left every mid-flight aggregation round and every FSA barrier
stalled forever, and a dead local server took its whole party offline.
The reference leaves worker/server recovery as a TODO (ref: van.cc:224);
production PS designs treat membership churn as the common case
(PAPERS.md: "TensorFlow: A system for large-scale machine learning").

- :class:`WorkerEvictionMonitor` (one per party scheduler): a worker
  whose heartbeats expire past ``Config.heartbeat_timeout_s`` is turned
  into a synthesized FORCED LEAVE — ``Control.EVICT`` to the party
  server, which reuses the graceful-leave fold (lower per-round targets,
  complete rounds the fold made decidable, rebroadcast membership) — and
  is dropped from the scheduler's barrier accounting
  (``Postoffice.exclude_node``) so barriers already waiting release to
  the survivor set.  The eviction carries the worker's last observed
  ``boot`` incarnation; the party server FENCES later pushes from the
  evicted identity (zombie resume or silent restart) until it rejoins
  through the dynamic-join door with a fresh rank, which also readmits
  it to barriers.
- :class:`LocalServerRecoveryMonitor` (global scheduler): a dead local
  server folds its party OUT of mid-flight global rounds
  (``EVICT {party_fold}`` to every global server — the graceful
  party-leave fold, but reversible) so the WAN root keeps making
  progress on the surviving parties.  When heartbeats resume (a
  replacement process, or a revived zombie whose replica is now stale)
  the monitor drives recovery: ``Control.REJOIN`` makes the local server
  warm-boot by pulling the full model state from the global servers,
  the party folds back into subsequent rounds (``EVICT {party_unfold}``),
  and the party's workers are told to replay their un-ACKed requests at
  the revived server (``KVWorker.retarget`` with old == new — the PR 1
  replay machinery).

Both monitors are sweep loops over ``Postoffice.heartbeat_info`` and run
only when heartbeats are on (``Config.heartbeat_interval_s > 0``) and
``Config.enable_eviction`` is true.  False positives are safe by
construction: an evicted-but-alive worker has its pushes fenced (no
count corruption) and rejoins for a fresh rank; a folded-but-alive party
warm-boots (idempotent — the pull just refreshes its replica) and folds
back in.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Dict, Optional

from geomx_tpu_torch.core.config import NodeId, Role
from geomx_tpu_torch.ps import Postoffice
from geomx_tpu_torch.trace.recorder import get_tracer
from geomx_tpu_torch.transport.message import Control, Domain, Message
from geomx_tpu_torch.utils.metrics import system_counter, system_gauge

_LOG = logging.getLogger(__name__)


class _HeartbeatActuator:
    """Shared skeleton of the two monitors: a sweep thread over the
    scheduler's heartbeat table plus a token-matched retried-RPC helper
    (mirrors ``GlobalFailoverMonitor._rpc_promote``)."""

    def __init__(self, postoffice: Postoffice,
                 check_interval_s: Optional[float] = None):
        self.po = postoffice
        self.topology = postoffice.topology
        cfg = postoffice.config
        self._timeout = cfg.heartbeat_timeout_s
        self._interval = (
            check_interval_s if check_interval_s is not None
            else (cfg.eviction_check_interval_s
                  or max(cfg.heartbeat_interval_s, 0.05)))
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._replies: Dict[str, dict] = {}
        self._stop = threading.Event()
        postoffice.add_control_hook(self._on_control)
        # one timer-wheel entry on the shared reactor when the fabric
        # rides one (lightweight / reactor transport); a dedicated
        # sleep-loop thread otherwise — identical sweep cadence
        from geomx_tpu_torch.transport.reactor import Periodic

        self._ticker = Periodic(
            self._interval, self._sweep,
            name=f"{type(self).__name__}-{postoffice.node}",
            reactor=getattr(postoffice.van.fabric, "reactor", None))

    def _sweep(self):
        if self._stop.is_set() or not self.po.config.enable_eviction:
            return
        try:
            self._check()
        except Exception:  # a sweep error must not kill the detector
            _LOG.exception("%s: membership sweep failed", self.po.node)

    def _check(self):  # pragma: no cover - subclass hook
        raise NotImplementedError

    def _on_control(self, msg: Message) -> bool:
        if (msg.control in (Control.EVICT, Control.REJOIN,
                            Control.PROBE_INDIRECT)
                and not msg.request):
            body = msg.body if isinstance(msg.body, dict) else {}
            token = body.get("token")
            if token is not None:
                with self._cv:
                    self._replies[token] = body
                    # unclaimed tokens (a reply that outlived its RPC's
                    # patience) must not accumulate forever
                    while len(self._replies) > 512:
                        self._replies.pop(next(iter(self._replies)))
                    self._cv.notify_all()
                return True
        return self._on_extra(msg)

    def _on_extra(self, msg: Message) -> bool:
        return False

    def _rpc(self, target: NodeId, control: Control, body: dict,
             domain: Domain, attempts: int = 5,
             per_try_s: float = 2.0) -> Optional[dict]:
        """Send ``control`` to ``target`` until a token-matched reply
        arrives; None after ``attempts`` tries (peer down)."""
        token = f"{self.po.node}#{uuid.uuid4().hex[:8]}"
        body = dict(body)
        body["token"] = token
        for _ in range(attempts):
            if self._stop.is_set():
                return None
            try:
                self.po.van.send(Message(
                    recipient=target, control=control, domain=domain,
                    request=True, body=dict(body)))
            except (KeyError, OSError):
                pass  # peer not dialable yet — retry
            with self._cv:
                if self._cv.wait_for(lambda: token in self._replies,
                                     timeout=per_try_s):
                    return self._replies.pop(token)
        return None

    def _probe_any_alive(self, suspect: str, relays, domain: Domain) -> bool:
        """SWIM-style indirect probe: ask up to ``Config.probe_indirect_k``
        relays (in the given order — put the relay that shares the
        suspect's LAN first) to ping the suspect on this monitor's
        behalf.  True the moment any relay hears a pong — the suspect
        is PARTITIONED from this monitor, not dead.  One attempt per
        relay: an unreachable relay is itself evidence for a real
        outage, and the sweep re-probes next tick anyway."""
        cfg = self.po.config
        timeout = float(cfg.probe_timeout_s)
        for peer in list(relays)[:int(cfg.probe_indirect_k)]:
            reply = self._rpc(peer, Control.PROBE_INDIRECT,
                              {"suspect": str(suspect), "timeout": timeout},
                              domain, attempts=1, per_try_s=timeout + 1.0)
            if reply is not None and reply.get("alive"):
                return True
        return False

    @staticmethod
    def _age(info: dict, node_s: str, baseline: float, now: float) -> float:
        last = info.get(node_s, (None, 0))[0]
        return now - (last if last is not None else baseline)

    def stop(self):
        self._stop.set()
        self._ticker.stop()


class WorkerEvictionMonitor(_HeartbeatActuator):
    """Party-scheduler detector/actuator for dead workers.

    Tracks the party's live member set from the server's membership
    broadcasts (so out-of-plan dynamic joiners are covered too), sweeps
    the heartbeat table, and turns an expired member into a forced
    leave + barrier exclusion.  A member that rejoins (named again by a
    membership broadcast) is readmitted.
    """

    def __init__(self, postoffice: Postoffice,
                 check_interval_s: Optional[float] = None):
        assert postoffice.node.role is Role.SCHEDULER
        self.party = postoffice.node.party
        now0 = time.monotonic()
        self._members = {str(w) for w in
                         postoffice.topology.workers(self.party)}
        # first-expected stamp per member: a joiner announced by a
        # broadcast gets its grace period from the announcement, not from
        # this scheduler's start epoch (which may be far in the past)
        self._baseline: Dict[str, float] = {n: now0 for n in self._members}
        self._evicted: Dict[str, int] = {}  # node -> boot at eviction
        self._evicting: set = set()
        # graceful-drain hold (Control.PREEMPT_NOTICE {event:
        # "draining"}): a noticed member gets the drain window to flush
        # and leave before heartbeat expiry may evict it — the notice
        # WINS the race against its own expiry.  node -> hold deadline.
        self._noticed: Dict[str, float] = {}
        self.notice_holds = 0
        self.evictions = 0
        # partition tolerance (Config.enable_partition_mode): members
        # whose heartbeats expired but whose indirect probes still
        # answered — folded out REVERSIBLY (incarnation not fenced),
        # re-probed every sweep, readmitted the moment heartbeats
        # resume, escalated to the legacy eviction once the probes go
        # dark too.  node -> boot at quarantine.
        self._quarantined: Dict[str, int] = {}
        self.quarantines = 0
        self._counter = system_counter(
            f"{postoffice.node}.worker_evictions")
        self._q_counter = system_counter(
            f"{postoffice.node}.partition_quarantines")
        self._q_gauge = system_gauge(
            f"{postoffice.node}.quarantined_nodes")
        super().__init__(postoffice, check_interval_s)

    def _on_extra(self, msg: Message) -> bool:
        if (msg.control is Control.PREEMPT_NOTICE and not msg.request
                and isinstance(msg.body, dict)
                and msg.body.get("event") == "draining"):
            node_s = str(msg.body.get("node", msg.sender))
            # the drain window plus a grace beat: the leave RPC that
            # ENDS the drain lands a moment after the window closes,
            # and the hold must outlive it or the race re-opens
            hold = getattr(self.po.config, "preempt_drain_s", 30.0) + 1.0
            with self._mu:
                self._noticed[node_s] = time.monotonic() + hold
                self.notice_holds += 1
            return True
        if (msg.control is Control.ADD_NODE and not msg.request
                and isinstance(msg.body, dict)
                and msg.body.get("event") == "membership"):
            members = set(msg.body.get("members") or ())
            now = time.monotonic()
            readmit = []
            with self._mu:
                for n in members - self._members:
                    self._baseline[n] = now
                # members that disappeared WITHOUT an eviction left
                # gracefully (leave_party / the preempt drain): drop
                # them from barrier accounting too, or an FSA barrier
                # already waiting would ride out its full timeout for a
                # member that promised never to enter
                departed = [n for n in self._members - members
                            if n not in self._evicted]
                self._members = members
                for n in departed:
                    self._noticed.pop(n, None)
                for n in list(self._evicted):
                    if n in members:  # rejoined through the join door
                        del self._evicted[n]
                        readmit.append(n)
                readmit.extend(n for n in members if n not in readmit)
            for n in departed:
                self.po.exclude_node(n)
            for n in readmit:
                self.po.readmit_node(n)
        return False  # never consumed: the TS schedulers track it too

    def _check(self):
        info, epoch = self.po.heartbeat_info()
        now = time.monotonic()
        with self._mu:
            # expired holds fall back to the normal eviction path (a
            # notice whose drain never finished is just a crash)
            for n, dl in list(self._noticed.items()):
                if dl <= now:
                    del self._noticed[n]
            candidates = [n for n in sorted(self._members)
                          if n not in self._evicted
                          and n not in self._evicting
                          and n not in self._noticed
                          and n not in self._quarantined]
            quarantined = dict(self._quarantined)
            baselines = dict(self._baseline)
        for n in candidates:
            if NodeId.parse(n).role is not Role.WORKER:
                continue  # the local server is the global monitor's job
            if self._age(info, n, baselines.get(n, epoch),
                         now) <= self._timeout:
                continue
            boot = info.get(n, (None, 0))[1]
            self._suspect(n, boot)
        for n, boot in sorted(quarantined.items()):
            if self._age(info, n, baselines.get(n, epoch),
                         now) <= self._timeout:
                # the partition healed — heartbeats are flowing again
                self._unquarantine(n)
            elif not self._probe_any_alive(n, self._relays_for(n),
                                           Domain.LOCAL):
                # the probes went dark too: the partition became (or
                # always was, and the path just died) a crash —
                # escalate to the legacy eviction, fence and all
                with self._mu:
                    self._quarantined.pop(n, None)
                self._q_gauge.set(len(self._quarantined))
                self._evict(n, boot)

    def _relays_for(self, suspect: str):
        """Probe relays for a suspect worker: the party server first
        (it shares the suspect's LAN, so a cut that only severed the
        worker↔scheduler path still hears it), then live siblings."""
        with self._mu:
            sibs = [n for n in sorted(self._members)
                    if n != suspect and n not in self._evicted
                    and n not in self._quarantined]
        return ([self.topology.server(self.party)]
                + [NodeId.parse(n) for n in sibs])

    def _suspect(self, node_s: str, boot: int):
        """Heartbeats expired: dead, or just unreachable from here?
        Partition mode asks k peers before deciding; off (default), the
        legacy expire→evict path runs untouched."""
        if (self.po.config.enable_partition_mode
                and self._probe_any_alive(node_s, self._relays_for(node_s),
                                          Domain.LOCAL)):
            self._quarantine(node_s, boot)
        else:
            self._evict(node_s, boot)

    def _quarantine(self, node_s: str, boot: int):
        with self._mu:
            self._evicting.add(node_s)
        try:
            # barrier liveness FIRST, exactly like the eviction path:
            # survivors blocked on the unreachable member release now
            self.po.exclude_node(node_s)
            reply = self._rpc(
                self.topology.server(self.party), Control.EVICT,
                {"action": "quarantine", "node": node_s, "boot": boot},
                Domain.LOCAL)
            if reply is None:
                return  # server unreachable — the next sweep retries
            with self._mu:
                self._quarantined[node_s] = boot
                self.quarantines += 1
            self._q_counter.inc()
            self._q_gauge.set(len(self._quarantined))
            get_tracer(str(self.po.node)).instant(
                "quarantine.worker", node=node_s, boot=boot)
            if self.po.flight is not None:
                from geomx_tpu_torch.obs.flight import FlightEv

                self.po.flight.record(FlightEv.NETFAULT, d=boot,
                                      peer=node_s,
                                      note="netfault_quarantine")
            print(f"{self.po.node}: quarantined {node_s} (heartbeats "
                  "expired but an indirect probe still hears it) — "
                  "folded out reversibly, incarnation NOT fenced",
                  flush=True)
        finally:
            with self._mu:
                self._evicting.discard(node_s)

    def _unquarantine(self, node_s: str):
        with self._mu:
            self._evicting.add(node_s)
        try:
            reply = self._rpc(
                self.topology.server(self.party), Control.EVICT,
                {"action": "unquarantine", "node": node_s}, Domain.LOCAL)
            if reply is None:
                return  # server unreachable — the next sweep retries
            with self._mu:
                self._quarantined.pop(node_s, None)
            self._q_gauge.set(len(self._quarantined))
            self.po.readmit_node(node_s)
            get_tracer(str(self.po.node)).instant(
                "quarantine.worker_heal", node=node_s)
            if self.po.flight is not None:
                from geomx_tpu_torch.obs.flight import FlightEv

                self.po.flight.record(FlightEv.NETFAULT, peer=node_s,
                                      note="netfault_unquarantine")
            print(f"{self.po.node}: {node_s} healed — heartbeats "
                  "resumed, quarantine lifted and membership restored",
                  flush=True)
        finally:
            with self._mu:
                self._evicting.discard(node_s)

    def _evict(self, node_s: str, boot: int):
        with self._mu:
            self._evicting.add(node_s)
        try:
            # barrier liveness FIRST: survivors blocked on the corpse
            # release now, not after the server RPC's retries
            self.po.exclude_node(node_s)
            reply = self._rpc(
                self.topology.server(self.party), Control.EVICT,
                {"node": node_s, "boot": boot}, Domain.LOCAL)
            if reply is None:
                return  # server unreachable — the next sweep retries
            with self._mu:
                self._evicted[node_s] = boot
                self.evictions += 1
            self._counter.inc()
            # control events land on the shared trace timeline (traceless
            # instants) so a flaky soak's dump shows WHEN the actuation
            # fired relative to the stalled round
            get_tracer(str(self.po.node)).instant(
                "evict.worker", node=node_s, boot=boot)
            if self.po.flight is not None:
                from geomx_tpu_torch.obs.flight import FlightEv

                self.po.flight.record(FlightEv.EVICT, d=boot,
                                      peer=node_s, note="worker_evict")
            print(f"{self.po.node}: evicted {node_s} (heartbeat expired, "
                  f"boot={boot}) — rounds and barriers fold to the "
                  "survivor set", flush=True)
        finally:
            with self._mu:
                self._evicting.discard(node_s)


class LocalServerRecoveryMonitor(_HeartbeatActuator):
    """Global-scheduler detector/actuator for dead local servers.

    Fold-out keeps the WAN root making progress while a party is dark;
    fold-back-in runs only after the replacement warm-booted, so global
    rounds never wait on a party that cannot push yet.
    """

    def __init__(self, postoffice: Postoffice,
                 check_interval_s: Optional[float] = None):
        assert postoffice.node.role is Role.GLOBAL_SCHEDULER
        # failover/reassignment-aware addressing: a party fold/unfold
        # after a shard failed over must reach the shard's CURRENT
        # holder, not the dead plan primary (a fold RPC the promoted
        # standby never hears would leave its round targets wrong and
        # stall every key of that shard)
        from geomx_tpu_torch.kvstore.replication import ShardTargets

        self._shards = ShardTargets(postoffice)
        self._folded: Dict[int, int] = {}  # party -> boot at fold
        # parties whose local server DRAINED proactively (preempt
        # notice) but whose old incarnation is still heartbeating its
        # way to death: recovery must wait for the death (heartbeat
        # expiry) or a NEW boot before warm-booting anyone, or it would
        # unfold the party back in mid-drain
        self._pending_death: set = set()
        self._busy: set = set()
        self.party_folds = 0
        self.party_unfolds = 0
        self.preempt_folds = 0
        # partition tolerance (Config.enable_partition_mode): parties
        # whose local server stopped heartbeating but still answers an
        # indirect probe.  Folded out at the shards (the fold is already
        # reversible and unfenced at this tier), but tracked HERE as
        # quarantined: the heal path asks for a catch-up rejoin instead
        # of a dense warm boot, the console shows QUARANTINED, and the
        # fold only becomes final once the probes go dark too.
        # party -> boot at quarantine.
        self._quarantined: Dict[int, int] = {}
        self.party_quarantines = 0
        self._fold_counter = system_counter(
            f"{postoffice.node}.party_folds")
        self._unfold_counter = system_counter(
            f"{postoffice.node}.party_unfolds")
        self._preempt_counter = system_counter(
            f"{postoffice.node}.preempt_folds")
        self._q_counter = system_counter(
            f"{postoffice.node}.partition_quarantines")
        self._q_gauge = system_gauge(
            f"{postoffice.node}.quarantined_nodes")
        super().__init__(postoffice, check_interval_s)

    def _on_extra(self, msg: Message) -> bool:
        """A drained local server already handed its fold to the global
        tier (Control.PREEMPT_NOTICE {event: "server_drained"}): record
        the fold with its boot incarnation so the replacement's resumed
        heartbeats drive the normal rejoin, without this monitor
        re-folding (the server-side fold is idempotent anyway)."""
        if (msg.control is not Control.PREEMPT_NOTICE or msg.request
                or not isinstance(msg.body, dict)
                or msg.body.get("event") != "server_drained"):
            return False
        party = int(msg.body.get("party", -1))
        if not 0 <= party < self.topology.num_parties:
            return True
        boot = int(msg.body.get("boot", 0))
        with self._mu:
            already = party in self._folded
            self._folded[party] = boot
            self._pending_death.add(party)
        if not already:
            self.preempt_folds += 1
            self._preempt_counter.inc()
            get_tracer(str(self.po.node)).instant(
                "preempt.party_fold", party=party,
                node=str(msg.body.get("node")))
            if self.po.flight is not None:
                from geomx_tpu_torch.obs.flight import FlightEv

                self.po.flight.record(FlightEv.FOLD, b=party, d=boot,
                                      peer=str(msg.body.get("node")),
                                      note="preempt_fold")
            print(f"{self.po.node}: party {party} drained on preempt "
                  "notice — fold recorded, rejoin arms when a "
                  "replacement heartbeats", flush=True)
        return True

    def _check(self):
        info, epoch = self.po.heartbeat_info()
        now = time.monotonic()
        for p in range(self.topology.num_parties):
            node_s = str(self.topology.server(p))
            age = self._age(info, node_s, epoch, now)
            with self._mu:
                if p in self._busy:
                    continue
                folded = p in self._folded
                pending = p in self._pending_death
                boot_at_fold = self._folded.get(p, 0)
                quarantined = p in self._quarantined
                boot_at_q = self._quarantined.get(p, 0)
            if quarantined:
                if age <= self._timeout:
                    # the partition healed: heartbeats resumed — drive
                    # the catch-up rejoin (the server decides catch-up
                    # vs dense from its own accumulated state)
                    self._spawn(p, self._recover_quarantined, p)
                else:
                    self._spawn(p, self._requarantine_or_fold, p,
                                boot_at_q)
                continue
            if not folded and age > self._timeout:
                boot = info.get(node_s, (None, 0))[1]
                self._spawn(p, self._suspect_party, p, boot)
            elif folded and pending and age > self._timeout:
                # the noticed incarnation finally died — from here the
                # next resumed heartbeat is a replacement to recover
                with self._mu:
                    self._pending_death.discard(p)
            elif folded and age <= self._timeout:
                boot_now = info.get(node_s, (None, 0))[1]
                if pending and boot_now == boot_at_fold:
                    continue  # the draining incarnation still breathes
                with self._mu:
                    self._pending_death.discard(p)
                # heartbeats resumed: a replacement process (new boot) or
                # a revived zombie (same boot, stale replica) — both
                # warm-boot before the party folds back in
                self._spawn(p, self._recover, p)

    def _spawn(self, party: int, fn, *args):
        """One action in flight per party; actions block on RPC retries,
        so they must not stall the detection sweep for other parties."""
        with self._mu:
            if party in self._busy:
                return
            self._busy.add(party)

        def run():
            try:
                fn(*args)
            except Exception:
                _LOG.exception("%s: recovery action for party %d failed",
                               self.po.node, party)
            finally:
                with self._mu:
                    self._busy.discard(party)

        threading.Thread(target=run, daemon=True,
                         name=f"party-recovery-{self.po.node}-p{party}"
                         ).start()

    def _fold(self, party: int, boot: int):
        node_s = str(self.topology.server(party))
        for gs in self._shards.global_servers():
            self._rpc(gs, Control.EVICT,
                      {"action": "party_fold", "node": node_s},
                      Domain.GLOBAL)
        with self._mu:
            self._folded[party] = boot
        self.party_folds += 1
        self._fold_counter.inc()
        get_tracer(str(self.po.node)).instant(
            "evict.party_fold", party=party, node=node_s)
        if self.po.flight is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            self.po.flight.record(FlightEv.FOLD, b=party, d=boot,
                                  peer=node_s, note="party_fold")
        print(f"{self.po.node}: folded party {party} out of global "
              f"rounds ({node_s} heartbeat expired) — the WAN root "
              "continues on the survivor parties", flush=True)

    # ---- partition-tolerant party quarantine (enable_partition_mode) ----
    def _party_relays(self, party: int):
        """Probe relays for a suspect local server: the suspect party's
        OWN scheduler first (it shares the suspect's LAN — the relay a
        WAN-uplink blackhole cannot cut), then the other parties'
        servers and the global shards (alternate WAN paths)."""
        t = self.topology
        relays = [t.scheduler(party)]
        relays += [t.server(q) for q in range(t.num_parties) if q != party]
        relays += list(self._shards.global_servers())
        return relays

    def _suspect_party(self, party: int, boot: int):
        """Heartbeats expired: partition mode probes before folding for
        good; off (default), the legacy expire→fold path is untouched."""
        if (self.po.config.enable_partition_mode
                and self._probe_any_alive(
                    str(self.topology.server(party)),
                    self._party_relays(party), Domain.GLOBAL)):
            self._quarantine_party(party, boot)
        else:
            self._fold(party, boot)

    def _quarantine_party(self, party: int, boot: int):
        node_s = str(self.topology.server(party))
        # the same reversible fold the crash path uses — global rounds
        # close on the survivors — but tracked as QUARANTINED: nothing
        # is fenced, and the heal path prefers a catch-up rejoin
        for gs in self._shards.global_servers():
            self._rpc(gs, Control.EVICT,
                      {"action": "party_fold", "node": node_s},
                      Domain.GLOBAL)
        with self._mu:
            self._quarantined[party] = boot
            self.party_quarantines += 1
        self._q_counter.inc()
        self._q_gauge.set(len(self._quarantined))
        get_tracer(str(self.po.node)).instant(
            "quarantine.party", party=party, node=node_s)
        if self.po.flight is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            self.po.flight.record(FlightEv.NETFAULT, a=party, d=boot,
                                  peer=node_s,
                                  note="netfault_quarantine")
        print(f"{self.po.node}: quarantined party {party} ({node_s} "
              "heartbeats expired but an indirect probe still hears "
              "it) — folded out reversibly, catch-up rejoin armed",
              flush=True)

    def _requarantine_or_fold(self, party: int, boot: int):
        """Still dark: re-probe.  Alive somewhere → stay quarantined
        (the partition persists).  Probes dark too → the partition
        became a crash: the fold goes final and the legacy dense
        recovery takes over when something heartbeats again."""
        if self._probe_any_alive(str(self.topology.server(party)),
                                 self._party_relays(party), Domain.GLOBAL):
            return
        node_s = str(self.topology.server(party))
        with self._mu:
            self._quarantined.pop(party, None)
            self._folded[party] = boot
        self._q_gauge.set(len(self._quarantined))
        self.party_folds += 1
        self._fold_counter.inc()
        get_tracer(str(self.po.node)).instant(
            "evict.party_fold", party=party, node=node_s)
        if self.po.flight is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            self.po.flight.record(FlightEv.FOLD, b=party, d=boot,
                                  peer=node_s, note="party_fold")
        print(f"{self.po.node}: party {party} quarantine escalated to a "
              f"fold ({node_s} stopped answering indirect probes too)",
              flush=True)

    def _recover_quarantined(self, party: int):
        node = self.topology.server(party)
        # 1. catch-up rejoin: the healed server ships its accumulated
        #    degraded-round delta (or falls back to a dense warm boot
        #    past the bound — ITS call; the reply says which)
        reply = self._rpc(node, Control.REJOIN, {"mode": "catchup"},
                          Domain.GLOBAL, attempts=8, per_try_s=5.0)
        if reply is None or not reply.get("ok"):
            return  # not ready yet — the next sweep retries
        # 2. the party counts toward global rounds again
        for gs in self._shards.global_servers():
            self._rpc(gs, Control.EVICT,
                      {"action": "party_unfold", "node": str(node)},
                      Domain.GLOBAL)
        # 3. the party's workers replay their un-ACKed requests NOW
        for w in self.topology.workers(party):
            try:
                self.po.van.send(Message(
                    recipient=w, control=Control.REJOIN,
                    domain=Domain.GLOBAL, request=False,
                    body={"event": "server_back", "server": str(node)}))
            except (KeyError, OSError):
                pass  # a dead worker is the party monitor's business
        with self._mu:
            self._quarantined.pop(party, None)
        self._q_gauge.set(len(self._quarantined))
        self.party_unfolds += 1
        self._unfold_counter.inc()
        mode = reply.get("mode", "dense")
        get_tracer(str(self.po.node)).instant(
            "quarantine.party_heal", party=party, mode=mode,
            keys=int(reply.get("keys", 0)))
        if self.po.flight is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            self.po.flight.record(FlightEv.NETFAULT, a=party,
                                  c=int(reply.get("keys", 0)),
                                  peer=str(node),
                                  note="netfault_unquarantine")
        print(f"{self.po.node}: party {party} healed — {node} rejoined "
              f"via {mode} ({reply.get('keys', 0)} keys) and folded "
              "back into global rounds", flush=True)

    def _recover(self, party: int):
        node = self.topology.server(party)
        # 1. warm boot: the local server pulls the full model state from
        #    the global tier (Control.REJOIN; the server replies once the
        #    pull landed).  Generous retries — the pull itself takes time
        reply = self._rpc(node, Control.REJOIN, {}, Domain.GLOBAL,
                          attempts=8, per_try_s=5.0)
        if reply is None or not reply.get("ok"):
            return  # not ready yet — the next sweep retries
        # 2. the party counts toward global rounds again
        for gs in self._shards.global_servers():
            self._rpc(gs, Control.EVICT,
                      {"action": "party_unfold", "node": str(node)},
                      Domain.GLOBAL)
        # 3. the party's workers replay their un-ACKed requests at the
        #    revived server NOW instead of waiting out the retry backoff
        for w in self.topology.workers(party):
            try:
                self.po.van.send(Message(
                    recipient=w, control=Control.REJOIN,
                    domain=Domain.GLOBAL, request=False,
                    body={"event": "server_back", "server": str(node)}))
            except (KeyError, OSError):
                pass  # a dead worker is the party monitor's business
        with self._mu:
            self._folded.pop(party, None)
        self.party_unfolds += 1
        self._unfold_counter.inc()
        get_tracer(str(self.po.node)).instant(
            "recover.party_unfold", party=party,
            warm_booted_keys=int(reply.get("keys", 0)))
        if self.po.flight is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            self.po.flight.record(FlightEv.UNFOLD, b=party,
                                  c=int(reply.get("keys", 0)),
                                  peer=str(node), note="party_unfold")
        print(f"{self.po.node}: party {party} recovered — {node} "
              f"warm-booted {reply.get('keys', 0)} keys and folded back "
              "into global rounds", flush=True)
