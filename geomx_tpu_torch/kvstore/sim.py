"""Single-process simulation of a full HiPS deployment.

The reference tests multi-node behavior by launching 12 OS processes on
localhost (ref: scripts/cpu/run_vanilla_hips.sh;
docs/source/pseudo-distributed-deployment.rst:1-16).  We stand the same
topology up as threads over the in-proc fabric — every role, both
domains, programmable WAN loss/latency — in one Python process, which is
what tests and the ``--simulate`` mode of the examples use.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from geomx_tpu_torch.core.config import Config, NodeId, Topology
from geomx_tpu_torch.kvstore.client import WorkerKVStore
from geomx_tpu_torch.kvstore.server import GlobalServer, LocalServer
from geomx_tpu_torch.ps import Postoffice
from geomx_tpu_torch.transport.van import FaultPolicy, InProcFabric


class Simulation:
    def __init__(self, config: Config, fault: Optional[FaultPolicy] = None,
                 lightweight: Optional[bool] = None):
        import threading

        from geomx_tpu_torch.transport.reactor import Reactor, resolve_transport

        self._join_mu = threading.Lock()
        self.config = config
        self.topology = config.topology
        # lightweight-party mode: all in-process nodes share the
        # per-process Reactor — van recv / customer handler threads
        # become serial dispatch channels on the shared pool, heartbeat
        # / resend / monitor loops land on the timer wheel, and server
        # merge lanes run inline (server_shards forced to 1) — so an
        # O(100)-party topology runs O(reactor loops + handler pool)
        # threads instead of O(nodes).  On by Config.lightweight /
        # GEOMX_LIGHTWEIGHT, by the explicit constructor arg, or
        # whenever the process transport is "reactor" (GEOMX_TRANSPORT
        # — the knob the parity suites are shaken under).
        if lightweight is None:
            lightweight = bool(getattr(config, "lightweight", False)
                               or resolve_transport(config) == "reactor")
        self.lightweight = bool(lightweight)
        if self.lightweight and not config.lightweight:
            # components read the flag off the config (merge-lane
            # sizing, resolve_server_shards) — flip it before any node
            # is constructed
            config.lightweight = True
        self.reactor = Reactor.shared() if self.lightweight else None
        self.fabric = InProcFabric(fault=fault, config=config,
                                   reactor=self.reactor,
                                   lightweight=self.lightweight)
        self.offices: Dict[str, Postoffice] = {}
        # distributed tracing (geomx_tpu_torch/trace): collector on the global
        # scheduler, a reporter per node.  Constructed BEFORE the other
        # postoffices start so no TRACE_REPORT can beat the collector's
        # customer registration.
        self.trace_collector = None
        gsched = str(self.topology.global_scheduler())
        for n in self.topology.all_nodes():
            po = Postoffice(n, self.topology, self.fabric, config)
            if config.trace_sample_every > 0 and str(n) == gsched:
                from geomx_tpu_torch.trace import get_collector

                self.trace_collector = get_collector(po)
            po.start()
            self.offices[str(n)] = po
            self._attach_tracer(po, fresh=True)
        # cluster telemetry plane (geomx_tpu_torch/obs): collector + health
        # engine on the global scheduler, constructed BEFORE any pump so
        # no METRICS_REPORT can beat the endpoint registration
        self.metrics_collector = None
        self.health = None
        self.metrics_pumps: Dict[str, "MetricsPump"] = {}
        if config.enable_obs:
            from geomx_tpu_torch.obs import HealthEngine, MetricsCollector

            self.metrics_collector = MetricsCollector(
                self.offices[gsched], config,
                trace_collector=self.trace_collector)
            self.health = HealthEngine(
                self.metrics_collector, config,
                trace_collector=self.trace_collector)
        self.ts_schedulers = []
        if config.enable_intra_ts:
            from geomx_tpu_torch.sched.ts_push import TsPushScheduler
            from geomx_tpu_torch.sched.tsengine import TsScheduler

            for p in range(self.topology.num_parties):
                sched_po = self.offices[str(self.topology.scheduler(p))]
                self.ts_schedulers.append(TsScheduler(
                    sched_po,
                    members=self.topology.workers(p),
                    greed_rate=config.ts_max_greed_rate,
                ))
                TsPushScheduler(sched_po,
                                num_workers=self.topology.workers_per_party)
        if config.enable_inter_ts:
            from geomx_tpu_torch.sched.tsengine import TsScheduler

            gsched_po = self.offices[str(self.topology.global_scheduler())]
            self.ts_schedulers.append(TsScheduler(
                gsched_po,
                members=self.topology.servers(),
                greed_rate=config.ts_max_greed_rate,
            ))
            if config.enable_inter_ts_push:
                from geomx_tpu_torch.sched.ts_push import TsPushScheduler

                TsPushScheduler(
                    gsched_po,
                    num_workers=self.topology.num_global_workers)
        self.local_servers: List[LocalServer] = [
            LocalServer(self.offices[str(self.topology.server(p))], config)
            for p in range(self.topology.num_parties)
        ]
        # standbys FIRST: a primary with a standby configured ships a
        # baseline replication snapshot at startup, and the standby must
        # exist to receive it
        self.standby_globals: List[GlobalServer] = [
            GlobalServer(self.offices[str(sb)], config, standby=True)
            for sb in self.topology.standby_globals()
        ]
        self.global_servers: List[GlobalServer] = [
            GlobalServer(self.offices[str(gs)], config)
            for gs in self.topology.global_servers()
        ]
        self.failover_monitor = None
        if (self.topology.num_standby_globals
                and config.heartbeat_interval_s > 0):
            from geomx_tpu_torch.kvstore.replication import GlobalFailoverMonitor

            self.failover_monitor = GlobalFailoverMonitor(
                self.offices[str(self.topology.global_scheduler())])
        # read-serving replica tier (geomx_tpu_torch/serve): replicas after
        # the global servers they subscribe to; the monitor (eviction +
        # subscriber prune) only with heartbeats on.  num_replicas == 0
        # (the default) constructs nothing — no threads, no endpoints.
        self.replicas: List["ModelReplica"] = []
        self.replica_monitor = None
        self.replica_autoscaler = None
        self._serve_clients: List = []
        if self.topology.num_replicas:
            from geomx_tpu_torch.serve import ModelReplica

            self.replicas = [
                ModelReplica(self.offices[str(r)], config)
                for r in self.topology.replicas()
            ]
            if config.heartbeat_interval_s > 0 and config.enable_eviction:
                from geomx_tpu_torch.serve import ReplicaMonitor

                self.replica_monitor = ReplicaMonitor(
                    self.offices[str(self.topology.global_scheduler())])
            if config.serve_autoscale:
                # elastic serve capacity (geomx_tpu_torch/serve/autoscaler):
                # decisions read the telemetry plane, scale-down retires
                # over the wire, scale-up revives through the same path
                # a restarted --role replica:K process takes
                from geomx_tpu_torch.serve import ReplicaAutoscaler

                self.replica_autoscaler = ReplicaAutoscaler(
                    self.offices[gsched], config,
                    collector=self.metrics_collector,
                    spawn=self.restart_replica)
        self.workers: Dict[str, WorkerKVStore] = {}
        for p in range(self.topology.num_parties):
            for w in self.topology.workers(p):
                self.workers[str(w)] = WorkerKVStore(self.offices[str(w)], config)
        self.master: Optional["MasterWorker"] = None
        mw = self.topology.master_worker()
        if mw is not None:
            from geomx_tpu_torch.kvstore.client import MasterWorker

            self.master = MasterWorker(self.offices[str(mw)], config)
        # crash-tolerant membership (kvstore/eviction.py): when
        # heartbeats are on, each party scheduler evicts dead workers
        # and the global scheduler folds/recovers dead local servers
        self.eviction_monitors = []
        self.recovery_monitor = None
        if config.heartbeat_interval_s > 0 and config.enable_eviction:
            from geomx_tpu_torch.kvstore.eviction import (
                LocalServerRecoveryMonitor, WorkerEvictionMonitor)

            for p in range(self.topology.num_parties):
                self.eviction_monitors.append(WorkerEvictionMonitor(
                    self.offices[str(self.topology.scheduler(p))]))
            self.recovery_monitor = LocalServerRecoveryMonitor(
                self.offices[str(self.topology.global_scheduler())])
        # adaptive WAN control plane (geomx_tpu_torch/control): closed-loop
        # codec/ratio retuning on the global scheduler.  With
        # adapt_interval_s == 0 no sweep thread runs — tests drive
        # wan_controller.tick() deterministically.
        self.wan_controller = None
        if config.adaptive_wan:
            from geomx_tpu_torch.control import AdaptiveWanController

            self.wan_controller = AdaptiveWanController(
                self.offices[str(self.topology.global_scheduler())],
                config, collector=self.trace_collector,
                metrics=self.metrics_collector)
        # per-node metrics pumps (telemetry plane): server roles ship
        # their QUERY_STATS-equivalent stats dict, everyone ships their
        # registry slice; frames ride the wire like every other node's
        # traffic (the gsched's own pump short-circuits in-proc)
        if config.enable_obs:
            from geomx_tpu_torch.obs import MetricsPump

            stats_fns = {str(ls.po.node): ls.stats
                         for ls in self.local_servers}
            stats_fns.update({str(gs.po.node): gs.stats for gs in
                              self.global_servers + self.standby_globals})
            stats_fns.update({str(r.po.node): r.stats
                              for r in self.replicas})
            for s, po in self.offices.items():
                self.metrics_pumps[s] = MetricsPump(
                    po, config, stats_fn=stats_fns.get(s),
                    collector=(self.metrics_collector
                               if s == gsched else None))
        # live cluster-state console: always on (costs nothing until
        # queried); Simulation.cluster_state() and the Ctrl.CLUSTER_STATE
        # wire query share compose()
        from geomx_tpu_torch.obs import ClusterStateService

        self.state_service = ClusterStateService(
            self.offices[gsched], config,
            failover_monitor=self.failover_monitor,
            recovery_monitor=self.recovery_monitor,
            wan_controller=self.wan_controller,
            collector=self.metrics_collector,
            health=self.health)

    def _attach_tracer(self, po: Postoffice, fresh: bool = False) -> None:
        """Bind the node's tracer to its (possibly replacement)
        postoffice so completed spans batch-ship to the collector.
        ``fresh`` (deployment construction) drops spans left over from a
        previous Simulation reusing the same node names — their
        round-derived trace ids would collide with this run's."""
        if self.config.trace_sample_every <= 0:
            return
        from geomx_tpu_torch.trace import get_tracer

        tr = get_tracer(str(po.node))
        if fresh:
            tr.reset()
        tr.batch_events = self.config.trace_batch_events
        tr.attach(po)

    def flush_traces(self, timeout: float = 5.0) -> int:
        """Ship every node's pending spans and wait for the collector's
        event count to settle; returns the number of collected events."""
        if self.trace_collector is None:
            return 0
        from geomx_tpu_torch.trace import get_tracer

        import time as _time

        for s in self.offices:
            get_tracer(s).flush()
        deadline = _time.monotonic() + timeout
        last = -1
        while _time.monotonic() < deadline:
            cur = len(self.trace_collector.merged_events())
            if cur == last:
                break
            last = cur
            _time.sleep(0.05)
        return last

    def dump_trace(self, path: str) -> dict:
        """Merged cross-node Chrome-trace JSON (see docs/tracing.md)."""
        assert self.trace_collector is not None, \
            "tracing off: set Config.trace_sample_every"
        self.flush_traces()
        return self.trace_collector.dump(path)

    def trace_report(self) -> dict:
        """Per-round critical-path report from the collector."""
        assert self.trace_collector is not None, \
            "tracing off: set Config.trace_sample_every"
        self.flush_traces()
        return self.trace_collector.critical_path()

    def pump_metrics(self, timeout: float = 5.0) -> int:
        """Ship one sample from every node's pump and wait for the
        collector to have ingested them; returns reports_received.
        The deterministic driver for ``obs_interval_s == 0`` tests."""
        assert self.metrics_collector is not None, \
            "telemetry off: set Config.enable_obs"
        import time as _time

        before = self.metrics_collector.reports_received
        sent = sum(1 for p in self.metrics_pumps.values() if p.ship())
        deadline = _time.monotonic() + timeout
        while (_time.monotonic() < deadline
               and self.metrics_collector.reports_received < before + sent):
            # a killed node's ship() can claim success into a dead van —
            # settle on "no growth" rather than the exact count
            cur = self.metrics_collector.reports_received
            _time.sleep(0.02)
            if self.metrics_collector.reports_received == cur >= before:
                _time.sleep(0.05)
                if self.metrics_collector.reports_received == cur:
                    break
        return self.metrics_collector.reports_received

    def dump_flight(self, out_dir: str,
                    incident: Optional[str] = None) -> List[str]:
        """Snapshot every LIVE node's flight-recorder ring to
        ``out_dir`` (killed nodes' vans are dead, so — like a real
        SIGKILL — they leave no dump; the postmortem assembler treats
        that absence as the finding).  ``incident=None`` is the
        exit-style dump (repeatable, overwrites); a named incident
        dumps at most once per node.  Returns the written paths."""
        paths = []
        for po in self.offices.values():
            fl = po.flight
            if fl is None or po.van.killed or not po._started:
                continue
            p = fl.dump(out_dir, incident=incident)
            if p:
                paths.append(p)
        return paths

    def cluster_state(self) -> dict:
        """The merged live cluster state (same composition the
        Ctrl.CLUSTER_STATE wire query and ``python -m geomx_tpu_torch.status``
        render — see docs/observability.md)."""
        return self.state_service.compose()

    def worker(self, party: int, rank: int) -> WorkerKVStore:
        return self.workers[str(NodeId.parse(f"worker:{rank}@p{party}"))]

    def add_worker(self, party: int) -> WorkerKVStore:
        """Dynamically join a NEW worker to a running party (ref:
        ADD_NODE van.cc:41-112): stand up its postoffice on the live
        fabric, register with the party server, and return the client.
        The server folds it into each key's count at the next fresh
        round; the caller still has to init/pull its replica and start
        pushing (see WorkerKVStore.join_party).

        The out-of-plan NODE ID is chosen here, before the server sees
        the join (in a real deployment the operator picks it, e.g.
        ``--role worker:2@p0``); concurrent add_worker calls serialize
        the pick so two joiners can't collide on one id — the server's
        rank assignment itself is already lock-serialized."""
        with self._join_mu:
            rank = sum(1 for w in self.workers.values()
                       if w.party == party)
            n = NodeId.parse(f"worker:{rank}@p{party}")
            po = Postoffice(n, self.topology, self.fabric, self.config)
            po.start()
            self.offices[str(n)] = po
            kv = WorkerKVStore(po, self.config)
            self.workers[str(n)] = kv
            self._attach_tracer(po)
        kv.join_party()
        return kv

    def all_workers(self) -> List[WorkerKVStore]:
        return [self.workers[str(w)] for w in self.topology.all_workers()]

    # ---- targeted fault injection ---------------------------------------
    def _stamp_netfault(self, note: str, target, extra: int = 0):
        """Every injected cut/heal lands in the global scheduler's
        flight ring (FlightEv.NETFAULT) — postmortems separate INJECTED
        partitions from organic silence the same way CHURN events
        separate injected kills from crashes."""
        po = self.offices.get(str(self.topology.global_scheduler()))
        fl = getattr(po, "flight", None) if po is not None else None
        if fl is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            fl.record(FlightEv.NETFAULT, a=extra,
                      peer=None if target is None else str(target),
                      note=note)

    def partition(self, a, b="*", symmetric: bool = True):
        """Cut the link a→b (both directions unless ``symmetric=False``)
        at the fabric, CONTROL TRAFFIC INCLUDED — heartbeats starve, so
        the failure detectors actually fire.  ``a``/``b`` are NodeIds or
        node strings; ``"*"`` wildcards.  ``partition(gs)`` with a
        single argument isolates exactly that node's links — what the
        shard-failure and split-brain soaks use instead of approximating
        with a global drop_rate."""
        from geomx_tpu_torch.utils.metrics import system_counter

        self.fabric.fault.partition(str(a), str(b), symmetric=symmetric)
        gsched = str(self.topology.global_scheduler())
        system_counter(f"{gsched}.partition_cuts").inc()
        self._stamp_netfault("netfault_cut", a)

    def heal(self, a=None, b=None, symmetric: bool = True):
        """Undo :meth:`partition` cuts (all of them with no args;
        ``symmetric=False`` restores only the a→b direction)."""
        from geomx_tpu_torch.utils.metrics import system_counter

        self.fabric.fault.heal(None if a is None else str(a),
                               None if b is None else str(b),
                               symmetric=symmetric)
        gsched = str(self.topology.global_scheduler())
        system_counter(f"{gsched}.partition_heals").inc()
        self._stamp_netfault("netfault_heal", a)

    def _wan_peers_of(self, party: int) -> List[str]:
        """The WAN-side endpoints of one party's local server: the
        global tier plus every OTHER party's server (inter-party TS
        relays) — everything a region-scoped blackhole must cut while
        leaving the party's own LAN intact."""
        t = self.topology
        peers = [str(t.global_scheduler())]
        peers += [str(n) for n in t.global_servers()]
        peers += [str(n) for n in t.standby_globals()]
        peers += [str(t.server(p)) for p in range(t.num_parties)
                  if p != party]
        return peers

    def partition_party(self, party: int, symmetric: bool = True):
        """Region outage: blackhole ``party``'s WAN uplink (its local
        server ↔ the global tier and every other party) while the
        party-internal LAN keeps working — workers keep pushing, the
        server keeps merging, only the up-stream goes dark.  This is
        the partition-tolerance soak's primary fault (ROADMAP item 5's
        "blackhole a whole region")."""
        srv = str(self.topology.server(party))
        self.fabric.fault.blackhole(srv, self._wan_peers_of(party),
                                    symmetric=symmetric)
        from geomx_tpu_torch.utils.metrics import system_counter

        gsched = str(self.topology.global_scheduler())
        system_counter(f"{gsched}.partition_cuts").inc()
        self._stamp_netfault("netfault_cut", srv, extra=party)

    def heal_party(self, party: int):
        """Undo :meth:`partition_party` — both directions of every WAN
        pair come back at once (a real uplink heal)."""
        srv = str(self.topology.server(party))
        for p in self._wan_peers_of(party):
            self.fabric.fault.heal(srv, p)
        from geomx_tpu_torch.utils.metrics import system_counter

        gsched = str(self.topology.global_scheduler())
        system_counter(f"{gsched}.partition_heals").inc()
        self._stamp_netfault("netfault_heal", srv, extra=party)

    def corrupt_link(self, a, b="*", rate: float = 1.0,
                     mode: str = "bitflip", seed: int = 0):
        """Seeded in-flight payload corruption on the link a→b: each
        data frame is serialized, damaged (single seeded bit flip or a
        seeded truncation — a deterministic per-rule tape) and decoded
        back at the fabric, the rot a flaky NIC/switch buffer inflicts
        on a real WAN.  The wire checksums (GEOMX_INTEGRITY_WIRE)
        detect it and the NACK fast-resend recovers; with the flag off
        the fabric's ``corrupt_delivered`` ledger counts how much
        damage would have reached the merge silently."""
        self.fabric.fault.corrupt(str(a), str(b), rate=rate, mode=mode,
                                  seed=seed)
        from geomx_tpu_torch.utils.metrics import system_counter

        gsched = str(self.topology.global_scheduler())
        system_counter(f"{gsched}.corruption_cuts").inc()
        self._stamp_netfault("netfault_corrupt", a)

    def heal_corrupt(self, a=None, b=None):
        """Undo :meth:`corrupt_link` rules (all of them with no args)."""
        self.fabric.fault.heal_corrupt(None if a is None else str(a),
                                       None if b is None else str(b))
        from geomx_tpu_torch.utils.metrics import system_counter

        gsched = str(self.topology.global_scheduler())
        system_counter(f"{gsched}.corruption_heals").inc()
        self._stamp_netfault("netfault_corrupt_heal", a)

    def set_duplicate_rate(self, rate: float):
        """Message-duplication injection: each data message is
        re-delivered (a copy, ahead of the original) with probability
        ``rate`` — the at-least-once failure mode the replay-dedup
        windows must absorb."""
        self.fabric.fault.duplicate_rate = float(rate)

    def kill_global_server(self, rank: int = 0) -> GlobalServer:
        """Thread-level kill of a primary global server (SIGKILL-free):
        stop its postoffice — the van's receive loop and heartbeat
        thread die, so it processes nothing further and the global
        scheduler's dead-node table names it after the heartbeat
        timeout.  The failover smoke test's kill switch."""
        gs = self.global_servers[rank]
        gs.po.stop()
        return gs

    def kill_worker(self, party: int, rank: int) -> WorkerKVStore:
        """Thread-level SIGKILL of a worker: its van neither receives
        nor transmits (``Van.kill``), its heartbeat and client retry
        loop die, and NO leave message is sent — recovery is the party
        scheduler's eviction monitor's job.  ``kv.po.start()`` later
        revives the same incarnation as a ZOMBIE (same boot nonce) whose
        pushes the server fences until it rejoins."""
        kv = self.worker(party, rank)
        kv.worker._retry_stop.set()
        kv.po.van.kill()
        kv.po.stop()
        return kv

    def kill_local_server(self, party: int) -> LocalServer:
        """Thread-level SIGKILL of a party's local server: no leave, no
        checkpoint, the WAN up-link stops replaying.  The global
        scheduler's recovery monitor folds the party out of global
        rounds; ``restart_local_server`` brings up the replacement."""
        ls = self.local_servers[party]
        ls.up._retry_stop.set()
        ls.po.van.kill()
        ls.po.stop()
        return ls

    def _notice_rpc(self, sender_po: Postoffice, target, domain,
                    timeout: float):
        """Send Control.PREEMPT_NOTICE from ``sender_po`` and wait for
        the token-matched drain reply.  Returns the reply body plus the
        measured notice→drained latency, or None on timeout."""
        import threading
        import time as _time
        import uuid

        from geomx_tpu_torch.transport.message import Control, Message

        assert self.config.enable_preempt, \
            "preempt notices off: set Config.enable_preempt"
        token = f"{sender_po.node}#{uuid.uuid4().hex[:8]}"
        cv = threading.Condition()
        reply: dict = {}

        def hook(msg) -> bool:
            b = msg.body if isinstance(msg.body, dict) else {}
            if (msg.control is Control.PREEMPT_NOTICE and not msg.request
                    and b.get("token") == token):
                with cv:
                    reply.update(b)
                    cv.notify_all()
                return True
            return False

        sender_po.add_control_hook(hook)
        t0 = _time.monotonic()
        try:
            sender_po.van.send(Message(
                recipient=target, control=Control.PREEMPT_NOTICE,
                domain=domain, request=True, body={"token": token}))
            with cv:
                if not cv.wait_for(lambda: bool(reply), timeout=timeout):
                    return None
        finally:
            sender_po.remove_control_hook(hook)
        out = dict(reply)
        out["latency_s"] = round(_time.monotonic() - t0, 4)
        return out

    def notice_worker(self, party: int, rank: int,
                      timeout: float = 30.0) -> Optional[dict]:
        """Deliver a spot-preemption notice to a worker over the wire
        (what a real preemption-notice daemon or SIGTERM mapping does):
        the worker finishes its in-flight step, flushes un-ACKed
        pushes, and leaves the party gracefully — the server folds it
        out immediately, no heartbeat-expiry stall.  Returns the drain
        reply ({ok, drain_s, latency_s}); the latency is the
        notice→member-folded reading the drain-latency acceptance
        judges.  Requires ``Config.enable_preempt``."""
        from geomx_tpu_torch.transport.message import Domain

        sched = self.offices[str(self.topology.scheduler(party))]
        target = NodeId.parse(f"worker:{rank}@p{party}")
        return self._notice_rpc(sched, target, Domain.LOCAL, timeout)

    def notice_local_server(self, party: int,
                            timeout: float = 30.0) -> Optional[dict]:
        """Deliver a spot-preemption notice to a party's local server:
        it drains its WAN round, hands the party fold to the global
        tier proactively, and arms the recovery monitor's rejoin path
        for the replacement.  Requires ``Config.enable_preempt``."""
        from geomx_tpu_torch.transport.message import Domain

        gsched = self.offices[str(self.topology.global_scheduler())]
        return self._notice_rpc(gsched, self.topology.server(party),
                                Domain.GLOBAL, timeout)

    def kill_replica(self, rank: int = 0) -> "ModelReplica":
        """Thread-level SIGKILL of a serve replica: its van neither
        receives nor transmits, its heartbeat and refresh pulls die —
        the replica monitor evicts it (subscriber views pruned at every
        shard) after the heartbeat timeout."""
        rep = self.replicas[rank]
        rep._stop.set()
        rep._wake.set()
        rep.up._retry_stop.set()
        rep.po.van.kill()
        rep.po.stop()
        return rep

    def restart_replica(self, rank: int) -> "ModelReplica":
        """Stand up a REPLACEMENT replica process (fresh postoffice,
        new boot incarnation, empty store — what a relaunched ``--role
        replica:K`` has).  Its first refresh pulls dense; the monitor
        logs the rejoin when its heartbeats resume."""
        from geomx_tpu_torch.serve import ModelReplica

        n = self.topology.replica(rank)
        po = Postoffice(n, self.topology, self.fabric, self.config)
        rep = ModelReplica(po, self.config)
        po.start()
        self.offices[str(n)] = po
        self.replicas[rank] = rep
        self._attach_tracer(po)
        if self.config.enable_obs:
            from geomx_tpu_torch.obs import MetricsPump

            old = self.metrics_pumps.pop(str(n), None)
            if old is not None:
                old.stop()
            self.metrics_pumps[str(n)] = MetricsPump(
                po, self.config, stats_fn=rep.stats)
        return rep

    def serve_balancer(self, replicas=None,
                       seed: int = 0) -> "ServeBalancer":
        """An out-of-plan balanced read frontend over the replica set
        (the wire path an inference frontend uses with the serving
        plane on).  Heartbeats off — a passive querier has no
        scheduler slot to ping."""
        import dataclasses

        from geomx_tpu_torch.serve import ServeBalancer

        with self._join_mu:
            n = NodeId.parse(
                f"master_worker:{700 + len(self._serve_clients)}")
            cfg = dataclasses.replace(self.config,
                                      heartbeat_interval_s=0.0)
            po = Postoffice(n, self.topology, self.fabric, cfg)
            po.start()
            lb = ServeBalancer(po, cfg, replicas=replicas, seed=seed)
            self._serve_clients.append((lb, po))
        return lb

    def serve_client(self, replica_rank: int = 0) -> "ReplicaClient":
        """An out-of-plan read client against one replica (the wire
        path an inference frontend uses).  Heartbeats off — a passive
        querier has no scheduler slot to ping."""
        import dataclasses

        from geomx_tpu_torch.serve import ReplicaClient

        # serialize id assignment: concurrent reader threads creating
        # clients must not collide on one out-of-plan node id
        with self._join_mu:
            n = NodeId.parse(
                f"master_worker:{700 + len(self._serve_clients)}")
            cfg = dataclasses.replace(self.config,
                                      heartbeat_interval_s=0.0)
            po = Postoffice(n, self.topology, self.fabric, cfg)
            po.start()
            client = ReplicaClient(po, cfg, replica=replica_rank)
            self._serve_clients.append((client, po))
        return client

    def reassign_shard(self, rank: int, target=None,
                       reason: str = "sim reassignment") -> bool:
        """Live key-range reassignment: move global shard ``rank``'s
        range onto ``target`` (its standby by default, or any live
        global server for a drain) through the epoch-fenced handoff
        protocol (``GlobalFailoverMonitor.reassign``).  Blocks until the
        handoff completed and the retarget broadcast went out."""
        if self.failover_monitor is None:
            from geomx_tpu_torch.kvstore.replication import GlobalFailoverMonitor

            self.failover_monitor = GlobalFailoverMonitor(
                self.offices[str(self.topology.global_scheduler())])
            self.state_service.failover_monitor = self.failover_monitor
        t = None
        if target is not None:
            t = (target if isinstance(target, NodeId)
                 else NodeId.parse(str(target)))
        return self.failover_monitor.reassign(rank, t, reason=reason)

    def restart_local_server(self, party: int) -> LocalServer:
        """Stand up a REPLACEMENT local-server process for the party:
        fresh postoffice (new boot incarnation), empty store — exactly
        what a relaunched ``--role server:0@pK`` has.  The recovery
        monitor detects the resumed heartbeats, drives the warm-boot
        pull from the global tier, folds the party back in, and tells
        the workers to replay their un-ACKed requests."""
        n = self.topology.server(party)
        po = Postoffice(n, self.topology, self.fabric, self.config)
        ls = LocalServer(po, self.config)
        po.start()
        self.offices[str(n)] = po
        self.local_servers[party] = ls
        self._attach_tracer(po)
        if self.config.enable_obs:
            # the replacement ships under the same node name but a new
            # boot nonce — the collector fences its ring on the switch
            from geomx_tpu_torch.obs import MetricsPump

            old = self.metrics_pumps.pop(str(n), None)
            if old is not None:
                old.stop()
            self.metrics_pumps[str(n)] = MetricsPump(
                po, self.config, stats_fn=ls.stats)
        return ls

    def set_wan_policy(self, compression: dict,
                       reason: str = "manual override") -> dict:
        """Manual override of the adaptive WAN policy: broadcast
        ``compression`` (e.g. ``{"type": "2bit"}``) under a fresh epoch
        through the same two-phase, fence-checked protocol the
        controller's automatic decisions use.  Requires
        ``Config.adaptive_wan``."""
        assert self.wan_controller is not None, \
            "adaptive WAN off: set Config.adaptive_wan"
        d = self.wan_controller.set_policy(compression, reason=reason)
        return {"epoch": self.wan_controller.epoch,
                "compression": d.compression}

    def process_threads(self) -> int:
        """Live OS threads in this process right now — the scaling
        reading ``bench.py --child parties`` records: O(nodes) under
        the thread-per-endpoint harness, O(1) under lightweight mode."""
        import threading

        return threading.active_count()

    def wan_bytes(self) -> dict:
        """Total WAN traffic (tier-2 links) across the deployment."""
        send = sum(ls.po.van.wan_send_bytes for ls in self.local_servers)
        send += sum(gs.po.van.wan_send_bytes for gs in self.global_servers)
        recv = sum(ls.po.van.wan_recv_bytes for ls in self.local_servers)
        recv += sum(gs.po.van.wan_recv_bytes for gs in self.global_servers)
        return {"wan_send_bytes": send, "wan_recv_bytes": recv}

    def shutdown(self):
        for p in self.metrics_pumps.values():
            p.stop()
        if self.health is not None:
            self.health.stop()
        self.state_service.stop()
        if self.metrics_collector is not None:
            self.metrics_collector.stop()
        if self.wan_controller is not None:
            self.wan_controller.stop()
        if self.trace_collector is not None:
            self.trace_collector.stop()
        if self.failover_monitor is not None:
            self.failover_monitor.stop()
        for m in self.eviction_monitors:
            m.stop()
        if self.recovery_monitor is not None:
            self.recovery_monitor.stop()
        if self.replica_monitor is not None:
            self.replica_monitor.stop()
        if self.replica_autoscaler is not None:
            self.replica_autoscaler.stop()
        for client, po in self._serve_clients:
            client.stop()
            po.stop()
        for rep in self.replicas:
            rep.stop()
        if self.master is not None:
            self.master.stop()
        for w in self.workers.values():
            w.stop()
        for s in self.local_servers:
            s.stop()
        for s in self.global_servers + self.standby_globals:
            s.stop()
        for po in self.offices.values():
            po.stop()
        self.fabric.shutdown()
