"""Postoffice: per-node runtime hub — node table, dispatch, barriers, key ranges.

Mirrors the responsibilities of the reference Postoffice (ref:
ps-lite/include/ps/internal/postoffice.h:35-76, src/postoffice.cc) — role
bookkeeping, node-group membership, scheduler-counted barriers for both the
local and the global domain (ref: postoffice.cc:202-244,
van.cc:259-288 ProcessBarrierCommand), and server key ranges
(ref: postoffice.cc:246-259 GetServerKeyRanges).

Divergence from the reference: node discovery is static (the Topology is
known up front) rather than via ADD_NODE registration; dynamic
join/recovery is layered on top for the TCP fabric (see
transport/heartbeat in the aux subsystem).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

from geomx_tpu_torch.core.config import Config, Group, NodeId, Role, Topology
from geomx_tpu_torch.obs.flight import FlightEv
from geomx_tpu_torch.trace import context as _tctx
from geomx_tpu_torch.transport.message import Control, Domain, Message
from geomx_tpu_torch.transport.van import InProcFabric, Van

# The ps key space. Tensor ids are encoded into this space by the kvstore
# layer; servers own contiguous ranges of it (ref: ps/base.h kMaxKey).
MAX_KEY = 1 << 62


@dataclasses.dataclass(frozen=True)
class KeyRange:
    begin: int  # inclusive
    end: int    # exclusive

    def contains(self, key: int) -> bool:
        return self.begin <= key < self.end


def split_range(n: int, total: int = MAX_KEY) -> List[KeyRange]:
    """Equal partition of the key space across n servers
    (ref: postoffice.cc:246-259)."""
    step = total // n
    out = []
    for i in range(n):
        end = total if i == n - 1 else (i + 1) * step
        out.append(KeyRange(i * step, end))
    return out


class Postoffice:
    """One per node. Owns the Van, routes messages, runs barriers.

    Customers register with (app_id, customer_id); data messages are routed
    to them. Control messages (BARRIER, HEARTBEAT, TS scheduling) are
    handled here or forwarded to registered control hooks.
    """

    def __init__(
        self,
        node: NodeId,
        topology: Topology,
        fabric: InProcFabric,
        config: Optional[Config] = None,
    ):
        self.node = node
        self.topology = topology
        self.config = config or Config()
        if self.config.trace_sample_every > 0:
            # flip the process-wide tracing gate once; everything else
            # (sampling, span recording) keys off per-round contexts
            _tctx.activate()
        self.van = Van(
            node,
            fabric,
            config=self.config,
            use_priority_queue=self.config.enable_p3,
        )
        self.flight = None  # black-box recorder, built below
        self._customers: Dict[Tuple[int, int], "Customer"] = {}
        self._app_owner: Dict[int, "Customer"] = {}
        self._control_hooks: List[Callable[[Message], bool]] = []
        self._lock = threading.Lock()
        # barrier state
        self._barrier_cv = threading.Condition()
        self._barrier_done: Dict[int, bool] = {}
        self._barrier_seq = 0
        # scheduler-side barrier counting: (group_token) -> list of waiters
        self._barrier_waiting: Dict[str, List[Message]] = {}
        # heartbeat bookkeeping (scheduler side: last-seen per node,
        # ref: Van::ProcessHeartbeat van.cc:242-257, UpdateHeartbeat).
        # ``_hb_boots`` records each sender's Van incarnation nonce so the
        # eviction actuator can fence the exact incarnation it declared
        # dead (kvstore/eviction.py)
        self._heartbeats: Dict[str, float] = {}
        self._hb_boots: Dict[str, int] = {}
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_task = None  # reactor timer-wheel entry (reactor mode)
        self._hb_stop = threading.Event()
        self._hb_epoch = 0.0
        self._dead_replies: Dict[int, dict] = {}
        # clock-offset estimation (non-scheduler side): heartbeats carry
        # a send stamp, the scheduler echoes it with its own receive
        # stamp, and the classic RTT/2 estimate gives "scheduler clock
        # minus mine" per scheduler target — what the trace collector
        # uses to merge per-node span timestamps onto one timeline
        self._clock_offsets: Dict[str, float] = {}
        self._hb_rtts: Dict[str, float] = {}
        self._hb_echo_t: Dict[str, float] = {}  # last echo arrival per
        #                                         scheduler (monotonic)
        self._rtt_gauge = None
        self._offset_gauge = None
        self._tracer = None
        # scheduler-side barrier exclusion: members declared dead by the
        # eviction monitor stop counting toward barrier quorums, so FSA
        # degrades to the survivor set instead of timing out
        self._excluded: set = set()
        # SWIM-style indirect-probe relays in flight FROM this node
        # (Control.PROBE_INDIRECT): relay token -> Event set when the
        # suspect's pong lands (kvstore/eviction.py drives these)
        self._probe_pending: Dict[str, threading.Event] = {}
        self._started = False
        # black-box flight recorder (geomx_tpu_torch/obs/flight): DEFAULT ON —
        # a fixed-size per-node event ring tapped by the van (message
        # heads, dedup), this postoffice (barriers), and the server /
        # monitor roles (fences, folds, promotions, rounds); dumps to
        # GEOMX_OBS_DIR on exit / health alert / operator request.
        # Disabled (GEOMX_FLIGHT=0): nothing constructed, every tap is
        # one attribute check.
        if getattr(self.config, "enable_flight", True):
            from geomx_tpu_torch.obs.flight import FlightRecorder

            self.flight = FlightRecorder(str(node), self.config,
                                         postoffice=self)
            self.van.flight = self.flight
            self.add_control_hook(self.flight.on_control)
            self.flight.add_pressure("van_sendq_depth",
                                     self.van._pq.qsize)
            # scheduler pressure: total OS threads in the process (the
            # reading the reactor refactor exists to flatten — O(nodes)
            # under the thread-per-endpoint harness, O(1) under the
            # reactor) and, when this fabric rides the shared reactor,
            # its loop-lag / fd-count health
            self.flight.add_pressure("process_threads",
                                     threading.active_count)
            reactor = getattr(fabric, "reactor", None)
            if reactor is not None:
                self.flight.add_pressure("reactor_loop_lag_ms",
                                         reactor.loop_lag_ms)
                self.flight.add_pressure("reactor_fds", reactor.fd_count)

    # ---- lifecycle ----------------------------------------------------------
    def start(self):
        if not self._started:
            self.van.start(self._dispatch)
            self._started = True
            import time as _time

            self._hb_epoch = _time.monotonic()
            if (self.config.heartbeat_interval_s > 0
                    and not self.node.role.is_scheduler):
                reactor = getattr(self.van.fabric, "reactor", None)
                if reactor is not None:
                    # heartbeat as a timer-wheel entry instead of a
                    # per-node sleep thread (O(100)-party harness)
                    targets = self._heartbeat_targets()
                    self._hb_task = reactor.call_every(
                        self.config.heartbeat_interval_s,
                        lambda: self._heartbeat_tick(targets),
                        name=f"heartbeat-{self.node}")
                    # the thread path pings immediately on start;
                    # call_every first fires after one interval — keep
                    # the first-contact timing identical
                    self._heartbeat_tick(targets)
                else:
                    self._hb_stop = threading.Event()
                    self._hb_thread = threading.Thread(
                        target=self._heartbeat_loop, args=(self._hb_stop,),
                        daemon=True, name=f"heartbeat-{self.node}")
                    self._hb_thread.start()

    def stop(self):
        if self._started:
            if self._hb_task is not None:
                self._hb_task.cancel()
                self._hb_task = None
            if self._hb_thread is not None:
                self._hb_stop.set()
                self._hb_thread.join(timeout=2)
                self._hb_thread = None
            self.van.stop()
            self._started = False
        if self.flight is not None:
            self.flight.stop()

    # ---- registry -----------------------------------------------------------
    def register_customer(self, customer: "Customer", owns_app: bool = False):
        """Register for message routing.

        Responses route by (app_id, customer_id) — back to the exact
        requester.  Requests route to the app *owner* (the serving
        customer), since the request carries the sender's customer_id
        (ref: van.cc ProcessDataMsg routes by app_id on non-worker nodes).
        """
        with self._lock:
            key = (customer.app_id, customer.customer_id)
            if key in self._customers:
                raise ValueError(f"duplicate customer {key} on {self.node}")
            self._customers[key] = customer
            if owns_app:
                if customer.app_id in self._app_owner:
                    raise ValueError(
                        f"duplicate app owner {customer.app_id} on {self.node}"
                    )
                self._app_owner[customer.app_id] = customer

    def add_control_hook(self, hook: Callable[[Message], bool]):
        """Hook receives control messages; return True to consume."""
        with self._lock:
            self._control_hooks.append(hook)

    def remove_control_hook(self, hook: Callable[[Message], bool]):
        """Unregister a hook added by add_control_hook (one-shot RPC
        hooks must not leak — a stale armed hook swallows the reply
        meant for a later call)."""
        with self._lock:
            try:
                self._control_hooks.remove(hook)
            except ValueError:
                pass

    # ---- dispatch -----------------------------------------------------------
    def _heartbeat_targets(self):
        """My scheduler target set.  Local servers are dual-identity and
        ping BOTH their party scheduler and the global scheduler (whose
        dead-node table covers them); workers ping the party scheduler;
        global-tier roles and replicas ping the global scheduler (the
        table makes replicas evictable and their freshness visible)."""
        targets = []
        if self.node.role in (Role.GLOBAL_SERVER, Role.STANDBY_GLOBAL,
                              Role.REPLICA):
            targets.append((self.topology.global_scheduler(), Domain.GLOBAL))
        else:
            targets.append(
                (self.topology.scheduler(self.node.party), Domain.LOCAL))
            if self.node.role is Role.SERVER:
                targets.append(
                    (self.topology.global_scheduler(), Domain.GLOBAL))
        return targets

    def _heartbeat_tick(self, targets):
        """One HEARTBEAT round to my scheduler(s) — the loop body, also
        the reactor timer-wheel entry."""
        import time as _time

        for sched, domain in targets:
            try:
                # the send stamp makes the ping echo-able: the
                # scheduler replies with (echo_t, sched_t) and this
                # node derives RTT + clock offset from the pair
                self.van.send(Message(
                    recipient=sched, control=Control.HEARTBEAT,
                    domain=domain, body={"t": _time.monotonic()}))
            except (KeyError, OSError):
                # scheduler not up yet (startup race on TCP) — a
                # transient failure must not kill the heartbeat loop
                pass

    def _heartbeat_loop(self, stop_ev: threading.Event):
        """Periodic HEARTBEAT thread (ref: van.cc:1128-1140) — the
        legacy-transport path; reactor fabrics schedule
        :meth:`_heartbeat_tick` on the shared timer wheel instead."""
        targets = self._heartbeat_targets()
        while not stop_ev.is_set():
            self._heartbeat_tick(targets)
            stop_ev.wait(self.config.heartbeat_interval_s)

    def dead_nodes(self, timeout_s: Optional[float] = None) -> List[str]:
        """Scheduler-side: nodes whose heartbeat is older than the timeout
        (ref: Postoffice::GetDeadNodes postoffice.cc:284-303)."""
        import time as _time

        assert self.node.role.is_scheduler
        if self.config.heartbeat_interval_s <= 0:
            return []  # feature off: nobody pings, so nobody is "dead"
        timeout_s = timeout_s or self.config.heartbeat_timeout_s
        now = _time.monotonic()
        with self._lock:
            expected = [
                str(n) for n in (
                    self.topology.members(
                        Group.WORKERS | Group.SERVERS, party=self.node.party)
                    if self.node.role is Role.SCHEDULER
                    else self.topology.global_servers() + self.topology.servers()
                )
            ]
            # nodes never heard from count from this scheduler's start
            return [n for n in expected
                    if now - self._heartbeats.get(n, self._hb_epoch) > timeout_s]

    def heartbeat_info(self):
        """Scheduler-side copy of the heartbeat table:
        ``({node: (last_seen_monotonic, boot)}, epoch)`` where ``epoch``
        is this scheduler's start time — the age baseline for nodes never
        heard from.  The eviction monitors (kvstore/eviction.py) sweep
        this instead of :meth:`dead_nodes` because they also watch
        out-of-plan dynamic joiners and need the ``boot`` incarnation to
        fence exactly the corpse they declared dead."""
        with self._lock:
            return ({n: (t, self._hb_boots.get(n, 0))
                     for n, t in self._heartbeats.items()},
                    self._hb_epoch)

    def uptime_s(self) -> float:
        """Seconds since this postoffice started (0.0 before start).
        QUERY_STATS and the metrics pump ship it so collectors can tell
        a warm-booted node's zeroed counters (small uptime, new boot
        nonce) from a genuine rate collapse."""
        if not self._started:
            return 0.0
        import time as _time

        return _time.monotonic() - self._hb_epoch

    def clock_offsets(self) -> Dict[str, float]:
        """Estimated scheduler-clock-minus-mine per scheduler target
        (from heartbeat echoes); {} until a first echo lands — and
        always {} on schedulers, whose clock others measure against."""
        with self._lock:
            return dict(self._clock_offsets)

    def heartbeat_rtts(self) -> Dict[str, float]:
        """Last measured heartbeat RTT per scheduler target."""
        with self._lock:
            return dict(self._hb_rtts)

    def heartbeat_echo_age(self, sched) -> float:
        """Seconds since the last heartbeat ECHO arrived from scheduler
        ``sched`` (age since this postoffice's start when none ever
        did).  The liveness view in the OTHER direction from
        :meth:`dead_nodes`: a non-scheduler node asking "can I still
        hear my scheduler?" — the degraded-mode watchdog's second
        opinion that a silent WAN link is a partition and not merely a
        slow round (kvstore/server.py)."""
        import time as _time

        now = _time.monotonic()
        with self._lock:
            base = self._hb_epoch if self._started else now
            return now - self._hb_echo_t.get(str(sched), base)

    def query_dead_nodes(self, timeout: float = 10.0) -> List[str]:
        """Ask my scheduler for its dead-node list
        (ref: kv.get_num_dead_node kvstore_dist.h:225-234)."""
        if self.node.role.is_scheduler:
            return self.dead_nodes()
        sched, domain = self._my_scheduler()
        return self._query_dead_body(sched, domain, timeout).get("dead", [])

    def _my_scheduler(self):
        sched = (self.topology.global_scheduler()
                 if self.node.role in (Role.GLOBAL_SERVER,
                                       Role.STANDBY_GLOBAL, Role.REPLICA)
                 else self.topology.scheduler(self.node.party))
        domain = (Domain.GLOBAL if sched.role is Role.GLOBAL_SCHEDULER
                  else Domain.LOCAL)
        return sched, domain

    def _query_dead_body(self, sched: NodeId, domain: Domain,
                         timeout: float, barrier_info: Optional[dict] = None,
                         ) -> dict:
        """DEAD_NODES round-trip to ``sched``; optionally asks for the
        entered-member list of one barrier token (the timeout-diagnosis
        path of :meth:`barrier`)."""
        with self._barrier_cv:
            self._barrier_seq += 1
            seq = self._barrier_seq
        self.van.send(Message(
            recipient=sched, control=Control.DEAD_NODES, domain=domain,
            request=True, timestamp=seq,
            body={"barrier": barrier_info} if barrier_info else None))
        with self._barrier_cv:
            ok = self._barrier_cv.wait_for(
                lambda: seq in self._dead_replies, timeout=timeout)
            if not ok:
                raise TimeoutError(f"{self.node}: dead-node query timed out")
            reply = self._dead_replies.pop(seq)
        return reply if isinstance(reply, dict) else {"dead": reply}

    def _dispatch(self, msg: Message):
        if msg.control is Control.DEAD_NODES:
            if msg.request:
                body = {"dead": self.dead_nodes()}
                req_b = msg.body if isinstance(msg.body, dict) else {}
                binfo = req_b.get("barrier")
                if binfo:
                    # barrier diagnosis: who already entered this token
                    token = f"{binfo['group']}@{binfo['party']}"
                    with self._lock:
                        waiting = list(self._barrier_waiting.get(token, ()))
                    body["entered"] = sorted({str(m.sender) for m in waiting})
                self.van.send(msg.reply_to(
                    control=Control.DEAD_NODES, body=body))
            else:
                with self._barrier_cv:
                    self._dead_replies[msg.timestamp] = msg.body
                    self._barrier_cv.notify_all()
            return
        if msg.control is Control.HEARTBEAT:
            import time as _time

            b = msg.body if isinstance(msg.body, dict) else {}
            if "sched_t" in b:
                # echo reply from my scheduler: RTT/2 clock estimate
                now = _time.monotonic()
                rtt = max(0.0, now - float(b["echo_t"]))
                offset = float(b["sched_t"]) - (float(b["echo_t"]) + rtt / 2)
                with self._lock:
                    self._hb_rtts[str(msg.sender)] = rtt
                    self._clock_offsets[str(msg.sender)] = offset
                    self._hb_echo_t[str(msg.sender)] = now
                    if self._rtt_gauge is None:
                        from geomx_tpu_torch.utils.metrics import system_gauge

                        self._rtt_gauge = system_gauge(
                            f"{self.node}.heartbeat_rtt_s")
                        self._offset_gauge = system_gauge(
                            f"{self.node}.clock_offset_s")
                self._rtt_gauge.set(rtt)
                self._offset_gauge.set(offset)
                return
            with self._lock:
                self._heartbeats[str(msg.sender)] = _time.monotonic()
                self._hb_boots[str(msg.sender)] = msg.boot
            if "t" in b:
                try:
                    self.van.send(msg.reply_to(
                        control=Control.HEARTBEAT,
                        body={"echo_t": b["t"],
                              "sched_t": _time.monotonic()}))
                except (KeyError, OSError):
                    pass  # sender vanished between ping and echo
            return
        if msg.control is Control.BARRIER:
            self._handle_barrier(msg)
            return
        if msg.control is Control.ADDR_UPDATE:
            # a replacement node at a new host:port announced itself
            # (ref: re-registration ADD_NODE van.cc:176-193; here the
            # node broadcasts directly since the plan names every peer)
            b = msg.body or {}
            update = getattr(self.van.fabric, "update_address", None)
            if update is not None:
                update(b["node"], (b["host"], int(b["port"])))
            return
        if msg.control is Control.PROBE_INDIRECT:
            if self._handle_probe_indirect(msg):
                return
            # not consumed: a relay's {alive} verdict falls through to
            # the control hooks — the monitor's actuator collects it by
            # token exactly like EVICT/REJOIN replies
        if msg.control is not Control.EMPTY:
            with self._lock:
                hooks = list(self._control_hooks)
            for hook in hooks:
                if hook(msg):
                    return
            return
        if msg.request:
            cust = self._app_owner.get(msg.app_id) or self._customers.get(
                (msg.app_id, msg.customer_id)
            )
        else:
            cust = self._customers.get((msg.app_id, msg.customer_id))
        if cust is None:
            raise KeyError(
                f"{self.node}: no customer ({msg.app_id},{msg.customer_id}) "
                f"request={msg.request} for message from {msg.sender}"
            )
        cust.accept(msg)

    # ---- SWIM-style indirect probes (Control.PROBE_INDIRECT) ---------------
    def _handle_probe_indirect(self, msg: Message) -> bool:
        """Three legs, all stateless beyond ``_probe_pending``:

        * request ``{ping}`` → answer ``{pong}`` inline (pure liveness
          — nothing else is touched, so a quarantined node still pongs);
        * request ``{suspect, timeout}`` → relay a ping to the suspect
          on a short-lived thread (the van send + wait would block the
          dispatch/handler thread — reactor-blocking lint) and reply
          ``{alive, suspect, token}`` to the asking monitor;
        * response ``{pong}`` → complete the pending relay by token.

        Returns False for the one leg it does NOT consume: an ``{alive}``
        relay verdict, which the monitor's control hook collects."""
        b = msg.body if isinstance(msg.body, dict) else {}
        if msg.request and b.get("ping"):
            try:
                self.van.send(msg.reply_to(body={"pong": True,
                                                 "token": b.get("token")}))
            except (KeyError, OSError):
                pass  # asker vanished between ping and pong
            return True
        if msg.request and "suspect" in b:
            t = threading.Thread(
                target=self._relay_probe, args=(msg,),
                name=f"probe-relay-{self.node}", daemon=True)
            t.start()
            return True
        if not msg.request and "pong" in b:
            with self._lock:
                ev = self._probe_pending.get(b.get("token"))
            if ev is not None:
                ev.set()
            return True
        return False

    def _relay_probe(self, msg: Message):
        import uuid

        b = msg.body if isinstance(msg.body, dict) else {}
        timeout = float(b.get("timeout") or self.config.probe_timeout_s)
        token = f"{self.node}#probe-{uuid.uuid4().hex[:8]}"
        ev = threading.Event()
        with self._lock:
            self._probe_pending[token] = ev
        alive = False
        try:
            self.van.send(Message(
                recipient=NodeId.parse(str(b["suspect"])),
                control=Control.PROBE_INDIRECT, domain=msg.domain,
                request=True, body={"ping": True, "token": token}))
            alive = ev.wait(timeout)
        except (KeyError, OSError):
            alive = False  # no route to the suspect = dead from here
        finally:
            with self._lock:
                self._probe_pending.pop(token, None)
        try:
            self.van.send(msg.reply_to(
                body={"alive": bool(alive), "suspect": str(b["suspect"]),
                      "token": b.get("token")}))
        except (KeyError, OSError):
            pass  # the asking monitor vanished mid-probe

    # ---- barriers -----------------------------------------------------------
    def _scheduler_for(self, group: Group) -> NodeId:
        if group & (Group.GLOBAL_SERVERS | Group.GLOBAL_WORKERS | Group.GLOBAL_SCHEDULER):
            return self.topology.global_scheduler()
        assert self.node.party is not None, f"{self.node} has no party for local barrier"
        return self.topology.scheduler(self.node.party)

    def barrier(self, group: Group, timeout: Optional[float] = 60.0):
        """Block until every member of `group` has entered the barrier.

        Counted at the scheduler like the reference (ref: postoffice.cc:202-244).
        The caller must be a member of `group`.
        """
        sched = self._scheduler_for(group)
        # party only scopes local-domain groups; global groups span parties
        is_global = sched.role is Role.GLOBAL_SCHEDULER
        party = None if is_global else self.node.party
        members = self.topology.members(group, party=self.node.party)
        assert self.node in members, f"{self.node} not in barrier group {group}"
        if len(members) <= 1:
            return
        with self._barrier_cv:
            self._barrier_seq += 1
            seq = self._barrier_seq
        domain = Domain.GLOBAL if is_global else Domain.LOCAL
        req = Message(
            recipient=sched, control=Control.BARRIER, domain=domain, request=True,
            body={"group": group.value, "party": party, "seq": seq},
        )
        fl = self.flight
        if fl is not None:
            fl.record(FlightEv.BARRIER_ENTER, a=group.value, b=seq,
                      peer=sched)
        if _tctx.ACTIVE and _tctx.current() is not None:
            # barrier waits inside a sampled round are a first-class
            # critical-path stage (FSA stalls ARE barrier time)
            if self._tracer is None:
                from geomx_tpu_torch.trace.recorder import get_tracer

                self._tracer = get_tracer(str(self.node))
            with self._tracer.span("barrier.wait"):
                self.van.send(req)
                with self._barrier_cv:
                    ok = self._barrier_cv.wait_for(
                        lambda: self._barrier_done.pop(seq, False),
                        timeout=timeout)
        else:
            self.van.send(req)
            with self._barrier_cv:
                ok = self._barrier_cv.wait_for(
                    lambda: self._barrier_done.pop(seq, False),
                    timeout=timeout)
        if fl is not None:
            fl.record(FlightEv.BARRIER_RELEASE if ok
                      else FlightEv.BARRIER_TIMEOUT,
                      a=group.value, b=seq, peer=sched)
        if not ok:
            # diagnosable stall: ask the scheduler who is dead and who
            # never entered this token, so the exception alone names the
            # culprit.  Best-effort — a dead scheduler degrades to the
            # bare message
            detail = ""
            try:
                body = self._query_dead_body(
                    sched, domain,
                    timeout=min(5.0, timeout or 5.0),
                    barrier_info={"group": group.value, "party": party})
                entered = set(body.get("entered", ()))
                missing = sorted(str(m) for m in members
                                 if str(m) not in entered
                                 and m != self.node)
                detail = (f" (scheduler dead-node list: "
                          f"{body.get('dead', [])}; members that never "
                          f"entered: {missing})")
            except Exception:
                pass
            raise TimeoutError(
                f"{self.node}: barrier on {group} timed out{detail}")

    def exclude_node(self, node_s: str):
        """Scheduler-side (eviction actuator): drop a dead member from
        barrier accounting and release every barrier that is now
        satisfied without it — waiting survivors must not ride out the
        full timeout for a corpse that can never enter."""
        assert self.node.role.is_scheduler
        to_release: List[Message] = []
        with self._lock:
            self._excluded.add(node_s)
            for token in list(self._barrier_waiting):
                waiting = self._barrier_waiting[token]
                if len(waiting) >= len(self._alive_members_locked(token)):
                    to_release.extend(self._barrier_waiting.pop(token))
        if to_release and self.flight is not None:
            self.flight.record(FlightEv.BARRIER_RELEASE,
                               c=len(to_release), peer=node_s,
                               note="eviction_release")
        for req in to_release:
            self.van.send(req.reply_to(body={"seq": req.body["seq"]}))

    def readmit_node(self, node_s: str):
        """Inverse of :meth:`exclude_node` — an evicted member rejoined
        (membership broadcast names it again), so it counts toward
        barrier quorums once more."""
        with self._lock:
            self._excluded.discard(node_s)

    def _alive_members_locked(self, token: str) -> List[NodeId]:
        """Barrier quorum for ``token`` minus evicted members (caller
        holds ``_lock``)."""
        gval, pval = token.rsplit("@", 1)
        group = Group(int(gval))
        party = None if pval == "None" else int(pval)
        members = self.topology.members(group, party=party)
        return [m for m in members if str(m) not in self._excluded]

    def _handle_barrier(self, msg: Message):
        if msg.request:
            # scheduler side: count entries for this (group, party);
            # evicted members don't count toward the quorum
            assert self.node.role.is_scheduler, f"{self.node} got barrier request"
            group = Group(msg.body["group"])
            party = msg.body["party"]
            token = f"{group.value}@{party}"
            fl = self.flight
            with self._lock:
                alive = self._alive_members_locked(token)
                waiting = self._barrier_waiting.setdefault(token, [])
                waiting.append(msg)
                entered, quorum = len(waiting), len(alive)
                if entered < quorum:
                    if fl is not None:
                        # the scheduler's view is the forensic one: who
                        # entered, and how many the token still waits on
                        fl.record(FlightEv.BARRIER_ENTER, a=group.value,
                                  b=entered, c=quorum, peer=msg.sender)
                    return
                released = self._barrier_waiting.pop(token)
            if fl is not None:
                fl.record(FlightEv.BARRIER_RELEASE, a=group.value,
                          c=len(released), peer=msg.sender)
            for req in released:
                self.van.send(req.reply_to(body={"seq": req.body["seq"]}))
        else:
            with self._barrier_cv:
                self._barrier_done[msg.body["seq"]] = True
                self._barrier_cv.notify_all()

    # ---- key ranges ---------------------------------------------------------
    def server_key_ranges(self, is_global: bool = False) -> List[KeyRange]:
        """Key ranges of tier-1 (one local server) or tier-2 (M global servers)
        (ref: postoffice.cc:246-259; GetServerKeyRanges(is_global))."""
        if is_global:
            return split_range(self.topology.num_global_servers)
        return split_range(1)

    def server_for_key(self, key: int, is_global: bool = False) -> int:
        ranges = self.server_key_ranges(is_global)
        step = MAX_KEY // len(ranges)
        return min(key // step, len(ranges) - 1)
