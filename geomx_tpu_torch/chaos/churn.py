"""Churn orchestrator: seeded, scripted spot-instance churn.

Production geo-distributed fleets run on preemptible capacity where
departure is the NORMAL case (the TensorFlow paper, PAPERS.md, makes
tolerating routinely-preempted workers a first-class requirement).
This module drives that case on purpose: a :class:`ChurnPlan` (seeded
Poisson arrival/departure rates, notice-vs-kill mix, min-survivor
floors, per-phase schedules) is pre-sampled into a deterministic event
tape, and :class:`ChurnOrchestrator` executes it against a live
``Simulation`` through the SAME paths a real fleet uses:

- graceful departure → ``Simulation.notice_worker`` (the
  ``Control.PREEMPT_NOTICE`` drain: flush, leave, immediate fold) then
  the host reclaim (``kill_worker``);
- ungraceful departure → ``kill_worker`` alone (the PR 2 heartbeat
  eviction path recovers);
- arrival → ``Simulation.add_worker`` + the harness's ``spawn``
  callback (dynamic join);
- local-server preemption → ``kill_local_server`` + a scheduled
  ``restart_local_server`` (fold → warm boot → unfold);
- serve-replica preemption → ``kill_replica`` + a scheduled
  ``restart_replica`` (eviction → view prune → dense-resync rejoin —
  the serving-plane soak's churn axis, ISSUE 15);
- region outage → ``Simulation.partition_party`` + a scheduled
  ``heal_party`` (WAN uplink dark, processes alive — the
  quarantine-not-evict axis; scripted standalone fault tapes live in
  geomx_tpu_torch/chaos/netfault.py).

Every injected event is stamped into the global scheduler's flight
recorder (``FlightEv.CHURN``) and counted in the registry family
``churn_{notices,graceful_leaves,ungraceful_kills,joins,replica_kills,
outages,stall_rounds}``
so a postmortem can attribute a stall to an injected fault vs an
organic one, and the health engine's ``churn_storm`` rule can page on
transition rate / survivor floor (obs/health.py).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from geomx_tpu_torch.utils.metrics import system_counter, system_gauge


@dataclasses.dataclass(frozen=True)
class ChurnPhase:
    """One phase of the plan: independent Poisson processes for worker
    departures, worker joins, and local-server preemptions over
    ``duration_s`` seconds."""

    duration_s: float
    departure_rate: float = 0.0   # worker departures per second
    join_rate: float = 0.0        # worker joins per second
    notice_fraction: float = 1.0  # P(a departure gets a preempt notice)
    server_kill_rate: float = 0.0  # local-server preemptions per second
    server_restart_s: float = 2.0  # replacement delay after a server kill
    replica_kill_rate: float = 0.0  # serve-replica preemptions per
    #                                 second (the serving-plane soak's
    #                                 churn axis, ISSUE 15)
    replica_restart_s: float = 2.0  # replacement delay after a replica
    #                                 kill (fresh boot, empty store —
    #                                 first refresh resyncs dense)
    outage_rate: float = 0.0        # region (party WAN-uplink) outages
    #                                 per second — the link-level fault
    #                                 axis (partition, not crash): the
    #                                 party's processes stay up, its WAN
    #                                 links go dark, and the detectors
    #                                 must QUARANTINE instead of evict
    outage_duration_s: float = 5.0  # how long each outage lasts before
    #                                 the uplink heals


@dataclasses.dataclass
class ChurnPlan:
    """Seeded, scripted churn schedule.  ``schedule()`` pre-samples the
    whole event tape — two plans with the same seed and phases produce
    the SAME tape, so a flaky soak reproduces."""

    phases: Tuple[ChurnPhase, ...]
    seed: int = 0
    min_workers_per_party: int = 1  # departure floor (survivors per party)
    max_workers_per_party: int = 4  # join ceiling per party
    min_servers_live: int = 1       # floor on simultaneously-live parties
    min_replicas_live: int = 1      # floor on simultaneously-live serve
    #                                 replicas (a kill that would breach
    #                                 it is skipped, like the worker floor)

    def schedule(self) -> List[Tuple[float, str, ChurnPhase]]:
        """The deterministic event tape: sorted ``(t, kind, phase)``
        triples with ``kind`` in {"depart", "join", "server_kill"}.
        Target picks happen at execution time (they depend on who is
        alive) from a second stream seeded off the same seed."""
        rng = random.Random(self.seed)
        tape: List[Tuple[float, str, ChurnPhase]] = []
        t0 = 0.0
        for ph in self.phases:
            for kind, rate in (("depart", ph.departure_rate),
                               ("join", ph.join_rate),
                               ("server_kill", ph.server_kill_rate),
                               ("replica_kill", ph.replica_kill_rate),
                               ("outage", ph.outage_rate)):
                if rate <= 0:
                    continue
                t = t0
                while True:
                    t += rng.expovariate(rate)
                    if t >= t0 + ph.duration_s:
                        break
                    tape.append((t, kind, ph))
            t0 += ph.duration_s
        tape.sort(key=lambda e: e[0])
        return tape

    @property
    def duration_s(self) -> float:
        return sum(ph.duration_s for ph in self.phases)


class ChurnOrchestrator:
    """Executes a :class:`ChurnPlan` against a live ``Simulation``.

    ``spawn(kv)`` is the harness hook invoked for every joined worker
    (start its training thread); without one, joiners register with the
    party server but never push (legal — their bootstrap pulls serve
    from completed rounds).  ``start()``/``stop()``/``join()`` manage
    the driver thread; ``run()`` executes inline.
    """

    def __init__(self, sim, plan: ChurnPlan,
                 spawn: Optional[Callable] = None,
                 stall_window_s: Optional[float] = None,
                 protect=()):
        self.sim = sim
        self.plan = plan
        self.spawn = spawn
        # nodes never picked for departure (e.g. a soak's loss-parity
        # observer; a real plan would pin on-demand capacity the same way)
        self.protect = {str(n) for n in protect}
        cfg = sim.config
        assert cfg.enable_preempt or all(
            ph.notice_fraction == 0 for ph in plan.phases), \
            "graceful notices need Config.enable_preempt"
        self.node = str(sim.topology.global_scheduler())
        # stall attribution: no global key-round progress for longer
        # than this window counts one churn_stall_rounds (default: the
        # eviction detector's worst honest stall — heartbeat timeout
        # plus a sweep — so only stalls the recovery machinery FAILED
        # to clear are flagged)
        self.stall_window_s = (
            stall_window_s if stall_window_s is not None
            else max(2.0 * cfg.heartbeat_timeout_s, 2.0))
        self._rng = random.Random(plan.seed + 1)  # target-pick stream
        self._tape = plan.schedule()
        self._mu = threading.Lock()
        # live bookkeeping: party -> {rank: kv}; server liveness
        self._alive: Dict[int, Dict[int, object]] = {}
        for p in range(sim.topology.num_parties):
            self._alive[p] = {w.rank: sim.workers[str(w)]
                              for w in sim.topology.workers(p)}
        self._server_live = {p: True
                             for p in range(sim.topology.num_parties)}
        self._replica_live = {r: True
                              for r in range(sim.topology.num_replicas)}
        self._restarts: List[Tuple[float, int]] = []  # (t, party)
        self._replica_restarts: List[Tuple[float, int]] = []  # (t, rank)
        self._outage_heals: List[Tuple[float, int]] = []  # (t, party)
        self._partitioned: Dict[int, bool] = {
            p: False for p in range(sim.topology.num_parties)}
        self.noticed: set = set()      # nodes that got a graceful notice
        self.killed: set = set()       # nodes killed ungracefully
        self.drain_latencies: List[float] = []
        self.events: List[dict] = []   # executed tape (postmortem aid)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._c_notices = system_counter(f"{self.node}.churn_notices")
        self._c_leaves = system_counter(
            f"{self.node}.churn_graceful_leaves")
        self._c_kills = system_counter(
            f"{self.node}.churn_ungraceful_kills")
        self._c_joins = system_counter(f"{self.node}.churn_joins")
        self._c_replica_kills = system_counter(
            f"{self.node}.churn_replica_kills")
        self._c_outages = system_counter(f"{self.node}.churn_outages")
        self._c_stalls = system_counter(
            f"{self.node}.churn_stall_rounds")
        self._g_survivors = system_gauge(f"{self.node}.churn_survivors")
        self._g_floor = system_gauge(
            f"{self.node}.churn_min_survivors")
        self._g_floor.set(plan.min_workers_per_party
                          * sim.topology.num_parties)
        self._update_survivors()

    # ---- lifecycle ----------------------------------------------------------
    def start(self) -> "ChurnOrchestrator":
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"churn-orchestrator-{self.node}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def join(self, timeout: Optional[float] = None):
        if self._thread is not None:
            self._thread.join(timeout)

    def stats(self) -> dict:
        with self._mu:
            return {
                "notices": self._c_notices.value,
                "graceful_leaves": self._c_leaves.value,
                "ungraceful_kills": self._c_kills.value,
                "joins": self._c_joins.value,
                "replica_kills": self._c_replica_kills.value,
                "outages": self._c_outages.value,
                "stall_rounds": self._c_stalls.value,
                "transitions": len(self.events),
                "survivors": self._survivor_count(),
                "drain_latency_s": sorted(self.drain_latencies),
            }

    # ---- execution ----------------------------------------------------------
    def run(self):
        """Execute the tape in real time (plus any scheduled server
        restarts), sampling the stall watchdog between events.  Tape
        times are relative to this call; restart deadlines are absolute
        monotonic stamps."""
        t_start = time.monotonic()
        i = 0
        last_progress = (self._progress(), time.monotonic())
        stalled_since: Optional[float] = None
        while not self._stop.is_set():
            now = time.monotonic()
            for r in [r for r in self._restarts if r[0] <= now]:
                self._restarts.remove(r)
                self._do_server_restart(r[1])
            for r in [r for r in self._replica_restarts if r[0] <= now]:
                self._replica_restarts.remove(r)
                self._do_replica_restart(r[1])
            for r in [r for r in self._outage_heals if r[0] <= now]:
                self._outage_heals.remove(r)
                self._do_outage_heal(r[1])
            deadlines = [r[0] for r in self._restarts]
            deadlines += [r[0] for r in self._replica_restarts]
            deadlines += [r[0] for r in self._outage_heals]
            if i < len(self._tape):
                deadlines.append(t_start + self._tape[i][0])
            if not deadlines:
                break
            wait = min(deadlines) - now
            if wait > 0:
                # stall watchdog rides the waits (<= 4 samples/s)
                if self._stop.wait(min(wait, 0.25)):
                    break
                last_progress, stalled_since = self._watch_stall(
                    last_progress, stalled_since)
                continue
            if (i < len(self._tape)
                    and t_start + self._tape[i][0] <= now):
                _, kind, ph = self._tape[i]
                i += 1
                try:
                    self._execute(kind, ph)
                except Exception:
                    import logging

                    logging.getLogger(__name__).exception(
                        "churn: injected %s failed", kind)
                self._update_survivors()

    def _watch_stall(self, last, stalled_since):
        prog, t_prog = last
        cur = self._progress()
        now = time.monotonic()
        if cur > prog:
            return (cur, now), None
        if now - t_prog > self.stall_window_s and stalled_since is None:
            self._c_stalls.inc()
            self._stamp("churn_stall_round", None,
                        note_extra=int((now - t_prog) * 1e3))
            return (cur, t_prog), now
        return (cur, t_prog), stalled_since

    def _progress(self) -> int:
        """Global-tier round progress (stall watchdog signal)."""
        total = 0
        for gs in getattr(self.sim, "global_servers", []):
            total += int(getattr(gs, "key_rounds", 0))
        return total

    def _survivor_count(self) -> int:
        return sum(len(v) for v in self._alive.values())

    def _update_survivors(self):
        self._g_survivors.set(self._survivor_count())

    def _stamp(self, note: str, target, note_extra: int = 0):
        po = self.sim.offices.get(self.node)
        fl = getattr(po, "flight", None) if po is not None else None
        if fl is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            fl.record(FlightEv.CHURN, a=note_extra,
                      peer=None if target is None else str(target),
                      note=note)
        self.events.append({"t": time.monotonic(), "kind": note,
                            "target": None if target is None
                            else str(target)})

    # ---- the injected events ------------------------------------------------
    def _pick_departure(self):
        with self._mu:
            cands = {}
            for p, ws in self._alive.items():
                if (len(ws) <= self.plan.min_workers_per_party
                        or not self._server_live.get(p)):
                    continue
                ranks = [r for r in sorted(ws)
                         if f"worker:{r}@p{p}" not in self.protect]
                if ranks:
                    cands[p] = ranks
            if not cands:
                return None, None
            p = self._rng.choice(sorted(cands))
            return p, self._rng.choice(cands[p])

    def _execute(self, kind: str, ph: ChurnPhase):
        if kind == "depart":
            p, rank = self._pick_departure()
            if p is None:
                return  # survivor floor: the departure is skipped
            node_s = f"worker:{rank}@p{p}"
            graceful = self._rng.random() < ph.notice_fraction
            if graceful:
                self._c_notices.inc()
                self.noticed.add(node_s)
                self._stamp("churn_notice", node_s)
                reply = self.sim.notice_worker(
                    p, rank, timeout=self.sim.config.preempt_drain_s + 5)
                if reply and reply.get("ok"):
                    self._c_leaves.inc()
                    self.drain_latencies.append(
                        float(reply["latency_s"]))
                    self._stamp("churn_graceful_leave", node_s)
            else:
                self._c_kills.inc()
                self.killed.add(node_s)
                self._stamp("churn_kill", node_s)
            # the host reclaim (for a drained worker this is the
            # preemption landing AFTER the graceful leave — the
            # eviction monitor must stay quiet; for an ungraceful one
            # it IS the fault)
            try:
                self.sim.kill_worker(p, rank)
            except KeyError:
                pass  # already gone
            with self._mu:
                self._alive[p].pop(rank, None)
        elif kind == "join":
            with self._mu:
                parties = [p for p, ws in self._alive.items()
                           if len(ws) < self.plan.max_workers_per_party
                           and self._server_live.get(p)]
            if not parties:
                return
            p = self._rng.choice(parties)
            kv = self.sim.add_worker(p)
            self._c_joins.inc()
            with self._mu:
                self._alive[p][kv.po.node.rank] = kv
            self._stamp("churn_join", kv.po.node)
            if self.spawn is not None:
                self.spawn(kv)
        elif kind == "server_kill":
            with self._mu:
                live = [p for p, up in self._server_live.items() if up]
                if len(live) <= self.plan.min_servers_live:
                    return
                p = self._rng.choice(live)
                self._server_live[p] = False
            self._c_kills.inc()
            self._stamp("churn_server_kill", f"server:0@p{p}")
            self.sim.kill_local_server(p)
            self._restarts.append(
                (time.monotonic() + ph.server_restart_s, p))
        elif kind == "replica_kill":
            with self._mu:
                live = [r for r, up in self._replica_live.items()
                        if up and f"replica:{r}" not in self.protect]
                if len([r for r, up in self._replica_live.items()
                        if up]) <= self.plan.min_replicas_live \
                        or not live:
                    return  # replica floor: the kill is skipped
                r = self._rng.choice(sorted(live))
                self._replica_live[r] = False
            self._c_replica_kills.inc()
            self.killed.add(f"replica:{r}")
            self._stamp("churn_replica_kill", f"replica:{r}")
            self.sim.kill_replica(r)
            self._replica_restarts.append(
                (time.monotonic() + ph.replica_restart_s, r))
        elif kind == "outage":
            # region outage: the party's WAN uplink dies, every process
            # behind it keeps running — the quarantine-not-evict axis.
            # Only parties whose server is UP and not already dark
            # qualify (an outage of a dead server tests nothing).
            with self._mu:
                cands = [p for p, up in self._server_live.items()
                         if up and not self._partitioned[p]]
                if not cands:
                    return
                p = self._rng.choice(sorted(cands))
                self._partitioned[p] = True
            self._c_outages.inc()
            self._stamp("churn_outage", f"server:0@p{p}")
            self.sim.partition_party(p)
            self._outage_heals.append(
                (time.monotonic() + ph.outage_duration_s, p))

    def _do_outage_heal(self, party: int):
        self.sim.heal_party(party)
        with self._mu:
            self._partitioned[party] = False
        self._stamp("churn_outage_heal", f"server:0@p{party}")
        print(f"churn: healed outage of party {party}", flush=True)

    def _do_replica_restart(self, rank: int):
        self.sim.restart_replica(rank)
        with self._mu:
            self._replica_live[rank] = True
        self._stamp("churn_replica_restart", f"replica:{rank}")
        print(f"churn: restarted replica:{rank}", flush=True)

    def _do_server_restart(self, party: int):
        self.sim.restart_local_server(party)
        with self._mu:
            self._server_live[party] = True
        self._stamp("churn_server_restart", f"server:0@p{party}")
        print(f"churn: restarted server:0@p{party}", flush=True)
