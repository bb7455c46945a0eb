"""Global-tier hot-standby replication and automatic failover.

The reference leaves global-tier recovery as an explicit TODO
(ref: van.cc:224); this subsystem closes it with the classic
parameter-server fault-tolerance shape (PAPERS.md: "TensorFlow: A system
for large-scale machine learning" — PS state replication + automatic
recovery):

- ``Replicator`` (runs inside a primary :class:`GlobalServer`): after
  every ``Config.replicate_every`` optimizer updates, snapshot the
  server state (weights + optimizer + sync/compression meta + the
  replay-dedup done-window) and stream it to the shard's hot standby as
  one ``Cmd.REPLICATE`` push — the ``kvstore/checkpoint.py`` slab format
  over the wire instead of disk.  Ships are async (a serialize must not
  stall the merge path) and self-coalescing (a ship in flight defers the
  next snapshot instead of queueing).
- ``GlobalFailoverMonitor`` (runs on the global scheduler): watches the
  postoffice heartbeat/dead-node table; when a primary global server
  misses heartbeats past the timeout it bumps the shard's **term**,
  promotes the standby (``Control.PROMOTE``), and broadcasts
  ``Control.NEW_PRIMARY`` so every local server retargets its WAN
  endpoint and replays un-ACKed requests (``KVWorker.retarget``).
  Replays are exactly-once: the standby was seeded with the primary's
  replay-dedup window, so a request the dead primary applied *and*
  replicated is re-acked, not re-applied; the van boot nonce keeps a
  replayed client distinguishable from a replaced one.
- **Term fencing**: each promotion increments the shard's term.  A
  zombie ex-primary that comes back keeps its stale term; its
  replication pushes are rejected by the promoted standby
  (``fenced_rejects`` counter) and the rejection — or a late
  ``NEW_PRIMARY`` rebroadcast — flips it into a fenced state where it
  refuses data pushes instead of split-braining the store.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

import numpy as np

from geomx_tpu_torch.core.config import NodeId, Role
from geomx_tpu_torch.kvstore.common import APP_PS, Cmd
from geomx_tpu_torch.ps import KVPairs, KVWorker, Postoffice
from geomx_tpu_torch.ps.postoffice import split_range
from geomx_tpu_torch.transport.message import Control, Domain, Message
from geomx_tpu_torch.utils.metrics import system_counter, system_gauge

# customer id of the replication endpoint on a primary global server
# (0 = the KVServer; local servers use 1 for their up-link worker)
REPL_CUSTOMER_ID = 7
# customer id of a draining holder's handoff ship endpoint (key-range
# reassignment; distinct from REPL_CUSTOMER_ID — a primary may be
# replicating to its standby AND draining at once)
HANDOFF_CUSTOMER_ID = 8


class ShardTargets:
    """Failover-aware view of *who currently serves each global shard*.

    The static plan says shard ``k`` is ``global_server:k``, but after a
    promotion (PR 1) or a live key-range reassignment the current holder
    differs.  Every component on a postoffice that must ADDRESS the
    global tier by shard — the recovery monitor's party folds, the
    adaptive-WAN controller's policy broadcasts, operator tooling —
    shares this tracker instead of each re-implementing NEW_PRIMARY
    bookkeeping.  The hook observes only (returns False), so every other
    NEW_PRIMARY consumer on the node still fires."""

    def __init__(self, postoffice: Postoffice):
        self.po = postoffice
        self._mu = threading.Lock()
        self._replaced: dict = {}  # old node str -> new node str
        postoffice.add_control_hook(self._on_new_primary)

    def _on_new_primary(self, msg: Message) -> bool:
        if msg.control is Control.NEW_PRIMARY and not msg.request:
            b = msg.body if isinstance(msg.body, dict) else {}
            if b.get("old") and b.get("new") and b["old"] != b["new"]:
                with self._mu:
                    self._replaced[str(b["old"])] = str(b["new"])
        return False  # observe-only

    def record(self, old, new) -> None:
        """Local fast path for components on the SAME postoffice as the
        failover monitor (its own broadcast loops back eventually, but
        the mapping must be current the moment promote() returns)."""
        old, new = str(old), str(new)
        if old != new:
            with self._mu:
                self._replaced[old] = new

    def resolve(self, node) -> NodeId:
        s = str(node)
        with self._mu:
            for _ in range(8):  # chained failovers resolve transitively
                nxt = self._replaced.get(s)
                if nxt is None:
                    break
                s = nxt
        return NodeId.parse(s)

    def global_servers(self):
        """Current holder of every shard's key range, deduplicated (a
        drain can merge two ranges onto one server) in shard order."""
        out, seen = [], set()
        for n in self.po.topology.global_servers():
            cur = self.resolve(n)
            if str(cur) not in seen:
                seen.add(str(cur))
                out.append(cur)
        return out


class Replicator:
    """Primary-side state streamer toward the shard's hot standby."""

    def __init__(self, gserver, standby: NodeId):
        self.gs = gserver
        self.standby = standby
        self.every = max(1, int(gserver.config.replicate_every))
        self.kw = KVWorker(
            APP_PS, REPL_CUSTOMER_ID, gserver.po,
            targets=[standby], key_ranges=split_range(1),
            domain=Domain.GLOBAL,
        )
        self.seq = 0          # last shipped snapshot number
        self.acked_seq = 0    # last standby-confirmed snapshot
        self.stopped = False  # fenced by a newer primary, or stop()ed
        self._since = 0
        self._busy = False
        self._pending = False
        self._lag = system_gauge(f"{gserver.po.node}.replication_lag_s")
        # per-SHARD twin of the per-node gauge: shard rank k is this
        # node's rank whether it is the plan primary (global_server:k)
        # or its promoted standby (standby_global:k) — bench's shards
        # sweep and the chaos soaks read the shard-keyed series so a
        # failover doesn't break the metric's continuity
        self._shard_lag = system_gauge(
            f"global_shard{gserver.po.node.rank}.replication_lag_s")
        # baseline ship shortly after startup: a primary that dies before
        # its first completed round must still leave the standby with the
        # key set (and a restarted zombie announces itself to the fence)
        threading.Thread(target=self._baseline, daemon=True,
                         name=f"repl-baseline-{gserver.po.node}").start()

    def _baseline(self):
        time.sleep(0.5)  # let the van/fabric finish starting
        with self.gs._mu:
            if self.seq == 0 and not self._busy:
                self.mark_locked(force=True)

    # ---- primary-side hooks -------------------------------------------------
    def mark_locked(self, n_updates: int = 0, force: bool = False):
        """Record updates; snapshot+ship when the cadence is due.  The
        caller holds the GlobalServer's ``_mu`` — the snapshot copies
        happen here (consistent state), serialization and the wire ship
        on a daemon thread (never under the lock)."""
        if self.stopped:
            return
        self._since += n_updates
        if not force and self._since < self.every:
            return
        self._since = 0
        if self._busy:
            # a ship is in flight with an older snapshot — coalesce: ship
            # once more when it completes rather than queueing every round
            self._pending = True
            return
        self._busy = True
        self._spawn_ship_locked()

    def _spawn_ship_locked(self):
        gs = self.gs
        # the optimizer-stage snapshot hook: a device-resident
        # trajectory (kvstore/jax_backend.py DeviceOptimizer) is
        # exported to the numpy pickle format here, so the standby can
        # restore it on either engine; store.items() likewise
        # materializes device-resident weights (a replication ship IS a
        # snapshot event in the zero-D2H steady-state contract)
        store_snap = {k: v.copy() for k, v in gs.store.items()}
        opt_snap = gs._export_opt_locked()
        meta = {
            "sync_mode": gs.sync_mode,
            "compression": dict(gs.compression),
            "recent_done": gs._recent.export_done(),
            "optimizer_configured": gs._optimizer_configured,
        }
        self.seq += 1
        seq, term = self.seq, gs.term
        t_snap = time.monotonic()

        def ship():
            from geomx_tpu_torch.kvstore import checkpoint as ckpt

            blob = np.frombuffer(
                ckpt.dumps_server_state(store_snap, {"optimizer": opt_snap},
                                        meta), dtype=np.uint8)

            def done():
                errs = []
                with self.kw._mu:
                    if self.kw.errors:
                        errs, self.kw.errors[:] = list(self.kw.errors), []
                if any("fenced" in e for e in errs):
                    # a newer primary holds the shard: stop streaming and
                    # flip the owning server into the fenced state so its
                    # data path refuses pushes too (split-brain guard)
                    self.stopped = True
                    self.gs._fence("replication rejected by newer primary")
                else:
                    self.acked_seq = max(self.acked_seq, seq)
                    lag = time.monotonic() - t_snap
                    self._lag.set(lag)
                    self._shard_lag.set(lag)
                with self.gs._mu:
                    self._busy = False
                    if self._pending and not self.stopped:
                        self._pending = False
                        self._busy = True
                        self._spawn_ship_locked()

            try:
                self.kw.zpush(
                    KVPairs(np.array([0], dtype=np.int64), blob,
                            np.array([len(blob)], dtype=np.int64)),
                    cmd=Cmd.REPLICATE,
                    body={"term": term, "seq": seq},
                    on_complete=done, donated=True)
            except Exception:  # never take the server down over replication
                import logging

                logging.getLogger(__name__).exception(
                    "%s: replication ship failed", gs.po.node)
                with self.gs._mu:
                    self._busy = False

        threading.Thread(target=ship, daemon=True,
                         name=f"repl-ship-{gs.po.node}").start()

    def stop(self):
        self.stopped = True
        self.kw.stop()


class GlobalFailoverMonitor:
    """Failure detector + promotion coordinator on the global scheduler.

    Promotion sequence per shard rank ``k`` (requires heartbeats on —
    ``Config.heartbeat_interval_s > 0``):

    1. primary ``global_server:k`` misses heartbeats past
       ``heartbeat_timeout_s`` → the dead-node table names it;
    2. term[k] += 1; ``Control.PROMOTE {term}`` to ``standby_global:k``
       (retried until acknowledged);
    3. ``Control.NEW_PRIMARY {rank, old, new, term}`` broadcast to every
       local server / worker / master — local servers retarget their WAN
       worker and immediately replay un-ACKed requests;
    4. the broadcast repeats while the old primary stays dead, so a
       zombie that restarts later still learns it was deposed and fences
       itself.
    """

    def __init__(self, postoffice: Postoffice,
                 check_interval_s: Optional[float] = None):
        assert postoffice.node.role is Role.GLOBAL_SCHEDULER
        self.po = postoffice
        topo = postoffice.topology
        self.topology = topo
        self._terms = {r: 0 for r in range(topo.num_global_servers)}
        # current holder of each shard's key range (promotion and
        # key-range reassignment both move it); the shared ShardTargets
        # view on this postoffice serves every other component
        self._holders = {r: NodeId(Role.GLOBAL_SERVER, r)
                         for r in range(topo.num_global_servers)}
        self.shard_targets = ShardTargets(postoffice)
        self._promoted: set = set()
        self.reassignments = 0  # completed live key-range handoffs
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._replies: dict = {}  # token -> body
        self.failover_events = 0
        self._counter = system_counter(f"{postoffice.node}.failover_events")
        self._stop = threading.Event()
        self._interval = (check_interval_s if check_interval_s is not None
                          else max(postoffice.config.heartbeat_interval_s,
                                   0.1))
        postoffice.add_control_hook(self._on_control)
        # timer-wheel entry on a reactor fabric, sleep-loop thread
        # otherwise (transport/reactor.py) — same sweep cadence
        from geomx_tpu_torch.transport.reactor import Periodic

        self._ticker = Periodic(
            self._interval, self._tick,
            name=f"failover-monitor-{postoffice.node}",
            reactor=getattr(postoffice.van.fabric, "reactor", None))

    # ---- detection ----------------------------------------------------------
    def _tick(self):
        if self._stop.is_set():
            return
        try:
            dead = set(self.po.dead_nodes())
        except Exception:
            return
        for rank in range(self.topology.num_standby_globals):
            primary = NodeId(Role.GLOBAL_SERVER, rank)
            if rank in self._promoted:
                if str(primary) in dead:
                    # keep fencing: a zombie restarting at any later
                    # point must hear who owns the shard now
                    self._broadcast_new_primary(
                        rank, old=primary, repeats=1)
                continue
            if str(primary) in dead:
                self.promote(rank)

    # ---- promotion ----------------------------------------------------------
    def promote(self, rank: int, reason: str = "heartbeat timeout") -> bool:
        """Promote ``standby_global:rank``.  Also the operator-forced
        entry point (runbook: docs/deployment.md) — callable directly
        with the primary still alive, e.g. for planned maintenance.
        Per-shard: shard ``rank``'s term moves alone; every other
        shard's primary, standby chain and term are untouched."""
        standby = self.topology.standby_for(rank)
        if standby is None or rank in self._promoted:
            return False
        old = self._holders[rank]
        term = self._terms[rank] + 1
        if not self._rpc_promote(standby, term, rank):
            import logging

            logging.getLogger(__name__).warning(
                "%s: standby %s did not acknowledge promotion (term %d)",
                self.po.node, standby, term)
            return False
        self._record_move(rank, old, standby, term)
        self.failover_events += 1
        self._counter.inc()
        system_counter(f"global_shard{rank}.promotions").inc()
        from geomx_tpu_torch.trace.recorder import get_tracer

        # failover lands on the merged trace timeline as a control event
        get_tracer(str(self.po.node)).instant(
            "failover.promoted", rank=rank, term=term, reason=reason)
        if self.po.flight is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            self.po.flight.record(FlightEv.PROMOTE, a=term, b=rank,
                                  peer=standby, note="promote")
        print(f"{self.po.node}: promoted {standby} to primary of shard "
              f"{rank} (term={term}, {reason})", flush=True)
        self._broadcast_new_primary(rank, old=old, repeats=3)
        return True

    def shard_table(self) -> dict:
        """Operator/console view of the shard map: rank ->
        {holder, term, promoted} (the cluster-state service merges this
        with heartbeat freshness and per-shard registry counters)."""
        with self._mu:
            return {r: {"holder": str(self._holders[r]),
                        "term": int(self._terms[r]),
                        "promoted": r in self._promoted}
                    for r in self._holders}

    def _record_move(self, rank: int, old: NodeId, new: NodeId, term: int):
        """Shared bookkeeping for a shard's key range changing hands
        (promotion or reassignment): term, holder, shared resolver, and
        the per-shard registry gauges next to the PR 1 per-node ones."""
        self._terms[rank] = term
        self._holders[rank] = new
        self._promoted.add(rank)
        self.shard_targets.record(old, new)
        system_gauge(f"global_shard{rank}.term").set(term)

    # ---- live key-range reassignment (shard drain) --------------------------
    def reassign(self, rank: int, target: Optional[NodeId] = None,
                 reason: str = "operator reassignment") -> bool:
        """Move shard ``rank``'s key range onto ``target`` — the shard's
        standby by default, or ANY live global server (drain: the old
        holder retires and the target serves both ranges).  Epoch-fenced
        by the shard's term exactly like failover, but exercised with
        the old holder still alive:

        1. term[rank] += 1;
        2. ``Control.HANDOFF {term, target}`` to the current holder —
           it quiesces, ships its final state snapshot (store +
           optimizer + replay-dedup window) straight to the target as a
           ``Cmd.REPLICATE {handoff}`` push, then fences itself and
           silently drops any straggling data requests (to the data
           plane it is now "dead", so the failover replay path applies);
        3. ``Control.NEW_PRIMARY`` broadcast — every local server
           retargets the range and replays its un-ACKed requests at the
           target; the replicated dedup window keeps that exactly-once.
        """
        with self._mu:
            old = self._holders.get(rank)
        if old is None:
            return False
        if target is None:
            target = self.topology.standby_for(rank)
        if target is None or str(target) == str(old):
            return False
        term = self._terms[rank] + 1
        reply = self._rpc(old, Control.HANDOFF,
                          {"term": term, "rank": rank,
                           "target": str(target)},
                          attempts=8, per_try_s=5.0)
        if reply is None or not reply.get("ok"):
            import logging

            logging.getLogger(__name__).warning(
                "%s: shard %d handoff %s -> %s failed (%s)",
                self.po.node, rank, old, target, reply)
            return False
        self._record_move(rank, old, target, term)
        self.reassignments += 1
        system_counter(f"global_shard{rank}.reassignments").inc()
        from geomx_tpu_torch.trace.recorder import get_tracer

        get_tracer(str(self.po.node)).instant(
            "reassign.moved", rank=rank, term=term, old=str(old),
            new=str(target), reason=reason)
        if self.po.flight is not None:
            from geomx_tpu_torch.obs.flight import FlightEv

            self.po.flight.record(FlightEv.HANDOFF, a=term, b=rank,
                                  peer=target, note="reassign")
        print(f"{self.po.node}: reassigned shard {rank} key range "
              f"{old} -> {target} (term={term}, "
              f"{reply.get('keys', 0)} keys, {reason})", flush=True)
        self._broadcast_new_primary(rank, old=old, repeats=3)
        return True

    def _rpc(self, target: NodeId, control: Control, body: dict,
             attempts: int = 5, per_try_s: float = 2.0) -> Optional[dict]:
        """Token-matched retried control RPC (the eviction monitors'
        helper, local to this monitor's reply table)."""
        token = f"{self.po.node}#{uuid.uuid4().hex[:8]}"
        body = dict(body, token=token)
        for _ in range(attempts):
            if self._stop.is_set():
                return None
            try:
                self.po.van.send(Message(
                    recipient=target, control=control,
                    domain=Domain.GLOBAL, request=True, body=dict(body)))
            except (KeyError, OSError):
                pass  # peer not dialable yet — retry
            with self._cv:
                if self._cv.wait_for(lambda: token in self._replies,
                                     timeout=per_try_s):
                    return self._replies.pop(token)
        return None

    def _rpc_promote(self, standby: NodeId, term: int, rank: int,
                     attempts: int = 5, per_try_s: float = 2.0) -> bool:
        token = f"{self.po.node}#{uuid.uuid4().hex[:8]}"
        for _ in range(attempts):
            try:
                self.po.van.send(Message(
                    recipient=standby, control=Control.PROMOTE,
                    domain=Domain.GLOBAL, request=True,
                    body={"term": term, "rank": rank, "token": token}))
            except (KeyError, OSError):
                pass  # standby not dialable yet — retry
            with self._cv:
                if self._cv.wait_for(lambda: token in self._replies,
                                     timeout=per_try_s):
                    return bool(self._replies.pop(token).get("ok"))
        return False

    def _on_control(self, msg: Message) -> bool:
        if (msg.control in (Control.PROMOTE, Control.HANDOFF)
                and not msg.request):
            body = msg.body if isinstance(msg.body, dict) else {}
            with self._cv:
                self._replies[body.get("token")] = body
                self._cv.notify_all()
            return True
        return False

    def _broadcast_new_primary(self, rank: int,
                               old: Optional[NodeId] = None,
                               repeats: int = 1):
        topo = self.topology
        primary = NodeId(Role.GLOBAL_SERVER, rank)
        if old is None:
            old = primary
        body = {"rank": rank, "old": str(old),
                "new": str(self._holders[rank]),
                "term": self._terms[rank]}
        targets = list(topo.servers()) + list(topo.all_workers())
        # serve replicas subscribe to every shard's key range: they must
        # retarget their refresh pulls exactly like the local servers'
        # up-links (geomx_tpu_torch/serve)
        targets += list(topo.replicas())
        mw = topo.master_worker()
        if mw is not None:
            targets.append(mw)
        targets.append(old)    # the zombie / drained-holder fence
        if str(old) != str(primary):
            targets.append(primary)  # a plan-primary zombie too
        # the NEW holder too: a reassignment target that is a standby
        # adopts the promotion from this broadcast (the failover path
        # sends it a direct PROMOTE first; the reassign path relies on
        # the new==me branch of _on_new_primary)
        targets.append(self._holders[rank])
        # self-delivery: components on THIS scheduler's postoffice (the
        # adaptive-WAN controller, ShardTargets consumers) track holders
        # through the same control hook as everyone else — without it a
        # locally-originated broadcast is the one they never hear
        targets.append(self.po.node)
        for i in range(repeats):
            if i:
                time.sleep(0.3)
            for n in targets:
                try:
                    self.po.van.send(Message(
                        recipient=n, control=Control.NEW_PRIMARY,
                        domain=Domain.GLOBAL, request=False,
                        body=dict(body)))
                except (KeyError, OSError):
                    pass  # down peers hear a later rebroadcast

    def stop(self):
        self._stop.set()
        self._ticker.stop()
