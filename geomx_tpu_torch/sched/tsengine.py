"""TSEngine: adaptive overlay scheduling for model dissemination.

Reimplements the reference's TSEngine pull direction (ref: van.cc:1312-1458
ProcessAskPullCommand, kv_app.h:1040-1224 AutoPullUpdate relay,
kvstore_dist_server.h:1368-1384 DefaultAutoPull): instead of every worker
pulling from the server (star topology), the server sends the updated
model to ONE node chosen by the scheduler; each receiver relays it onward
to the next scheduler-chosen node, forming a dissemination chain/tree
tuned by *observed throughput* — senders report the throughput of their
last transfer, the scheduler keeps a matrix ``A[from][to]`` and picks the
next receiver greedily with probability ``min(known_fraction,
MAX_GREED_RATE_TS)``, else uniformly (ε-exploration, ref: van.cc:1312-1386).

Scope: both tiers are wired into the kvstore — intra-party
(enable_intra_ts: party server → workers over the LAN) and inter-party
(enable_inter_ts: global servers → local servers over the WAN, replacing
the FSA pull-down with overlay dissemination).  Round tokens are strings
("node:counter") so concurrent initiators (MultiGPS global servers)
never collide in the scheduler's served-set.

Control plane: Control.ASK_PULL / Control.REPLY / Control.AUTOPULL_REPLY
messages through Postoffice control hooks (ref: new control cmds
message.h:135-136).
"""

from __future__ import annotations

import queue
import random
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from geomx_tpu_torch.core.config import Config, NodeId
from geomx_tpu_torch.ps.postoffice import Postoffice
from geomx_tpu_torch.transport.message import Control, Domain, Message
from geomx_tpu_torch.transport.reactor import Periodic, resolve_reactor_workers

# Lightweight mode runs dissemination jobs on the shared reactor pool,
# and a job PARKS its worker across scheduler/ack round-trips (bounded
# by ts_ask_timeout_s).  Cap how many may park at once to half the pool:
# relays beyond the cap simply stay queued until a slot frees, so the
# reply/ack handler channels can always find a worker — without the cap,
# enough concurrent relays would occupy every worker and stall the very
# replies they are waiting on until timeout.
_DISSEM_SLOTS = threading.BoundedSemaphore(
    max(2, resolve_reactor_workers() // 2))


class TsScheduler:
    """Runs on a scheduler node; answers ASK_PULL with the next receiver.

    Round state: a dissemination round (one model broadcast) is identified
    by ``iter``; each member is served at most once per round (the busy
    vector B1 of the reference, ref: van.h:198-204).
    """

    def __init__(self, postoffice: Postoffice, members: Sequence[NodeId],
                 greed_rate: float = 0.9, seed: int = 0):
        self.po = postoffice
        self.members = [str(m) for m in members]
        self.greed = greed_rate
        self.A: Dict[str, Dict[str, float]] = {}  # A[from][to] = throughput
        # true LRU (recency = last ask touching the round), not
        # insertion order: a long-running round kept alive by asks must
        # not be evicted just because it STARTED first
        self._served: "OrderedDict[str, set]" = OrderedDict()
        self._done: set = set()
        self._done_rounds: list = []
        self._mu = threading.Lock()
        self._rng = random.Random(seed)
        self._member_seq = -1   # last applied membership broadcast stamp
        postoffice.add_control_hook(self._on_control)
        postoffice.add_control_hook(self._on_membership)

    def _on_membership(self, msg: Message) -> bool:
        """Dynamic join/leave: the party server broadcasts the live
        member list (seq-stamped); the overlay's dissemination targets
        must track it — a joiner the scheduler doesn't know never
        receives a relay, a leaver it still knows wedges every round's
        chain on a dead hop (VERDICT r4 item 6: the reference's
        ADD_NODE is uniform, van.cc:41-112)."""
        body = msg.body if isinstance(msg.body, dict) else {}
        if (msg.control is not Control.ADD_NODE or msg.request
                or body.get("event") != "membership"
                or "members" not in body):
            return False
        from geomx_tpu_torch.transport.van import apply_member_addrs

        # the scheduler must be able to DIAL a dynamic joiner (ask
        # replies, and choosing it as a relay target presumes peers can)
        apply_member_addrs(self.po.van.fabric, body.get("addrs"),
                           str(self.po.node))
        seq = body.get("seq")
        with self._mu:
            if seq is not None and seq > self._member_seq:
                self._member_seq = seq
                self.members = [str(m) for m in body["members"]]
            elif seq is None:
                self.members = [str(m) for m in body["members"]]
        # NOT exclusive: hooks stop at the first True, and the push
        # scheduler on this same postoffice consumes the broadcast too
        return False

    def _on_control(self, msg: Message) -> bool:
        if msg.control is not Control.ASK_PULL:
            return False
        body = msg.body or {}
        it = str(body.get("iter", ""))
        sender = str(msg.sender)
        # learn the reported throughput of the asker's last transfer
        last, thr = body.get("last"), body.get("throughput")
        if last is not None and thr is not None:
            self.A.setdefault(sender, {})[last] = float(thr)
        with self._mu:
            if it in self._done:
                # round already fully served — a late relayer's ask must
                # NOT recreate the served-set and re-serve stale data
                receiver = None
            else:
                if it not in self._served and len(self._served) > 1000:
                    # rounds abandoned mid-flight (relay timeout, dead
                    # member) never reach the no-candidates branch — bound
                    # the map by evicting the least-recently-asked round
                    self._served.popitem(last=False)
                served = self._served.setdefault(it, set())
                self._served.move_to_end(it)  # refresh recency
                candidates = [m for m in self.members
                              if m not in served and m != sender]
                if not candidates:
                    receiver = None
                    self._served.pop(it, None)
                    self._done.add(it)
                    self._done_rounds.append(it)
                    if len(self._done_rounds) > 1000:
                        old = self._done_rounds.pop(0)
                        self._done.discard(old)
                        self._served.pop(old, None)
                else:
                    receiver = self._choose(sender, candidates)
                    served.add(receiver)
        self.po.van.send(msg.reply_to(
            control=Control.REPLY, body={"receiver": receiver, "iter": it}))
        return True

    def _choose(self, sender: str, candidates: List[str]) -> str:
        known = self.A.get(sender, {})
        known_frac = len([c for c in candidates if c in known]) / len(candidates)
        if known and self._rng.random() < min(known_frac, self.greed):
            best = max(candidates, key=lambda c: known.get(c, 0.0))
            if known.get(best, 0.0) > 0.0:
                return best
        return self._rng.choice(candidates)


class TsClient:
    """Ask-the-scheduler helper + relay bookkeeping for one node
    (ref: GetReceiver blocking ask van.cc:1474-1504)."""

    def __init__(self, postoffice: Postoffice, scheduler: NodeId,
                 domain: Domain = Domain.LOCAL):
        import queue as _queue

        self.po = postoffice
        self.scheduler = scheduler
        self.domain = domain
        import collections

        self._cv = threading.Condition()
        # set by stop(): a round still waiting on the scheduler or on a
        # relay's ack ends at once (the shared pool that runs it outlives
        # this node, and a process's exit joins that pool)
        self._stopped = False
        self._replies: Dict[int, Optional[str]] = {}
        self._acks: set = set()
        self._ack_order: "collections.deque" = collections.deque()
        self._seq = 0
        postoffice.add_control_hook(self._on_control)
        # dissemination must never run on a customer/handler dispatch
        # lane: the ask/send loop blocks on round-trips, and blocking a
        # handler deadlocks when two nodes relay to each other
        # concurrently.  Lightweight mode folds the job queue onto the
        # reactor timer wheel (a Periodic tick drains it on the worker
        # pool, slot-capped by _DISSEM_SLOTS); the threaded transport
        # keeps the dedicated per-node drain thread.
        self._dq: "_queue.Queue" = _queue.Queue()
        self._dissem_thread = None
        self._dissem_task = None
        fabric = getattr(postoffice.van, "fabric", None)
        reactor = getattr(fabric, "reactor", None)
        if getattr(fabric, "lightweight", False) and reactor is not None:
            self._dissem_task = Periodic(
                0.005, self._drain_dissem,
                name=f"ts-dissem-{postoffice.node}", reactor=reactor)
        else:
            self._dissem_thread = threading.Thread(
                target=self._dissem_loop, daemon=True,
                name=f"ts-dissem-{postoffice.node}")
            self._dissem_thread.start()

    def disseminate_async(self, keys, vals, lens, it: str, cmd: int):
        """Queue a relay round: ask the scheduler for receivers and send
        until the round is fully served (ref: AutoPullUpdate loop
        kv_app.h:1181-1224). Returns immediately."""
        self._dq.put((keys, vals, lens, it, cmd))

    def _dissem_loop(self):
        while True:
            job = self._dq.get()
            if job is None:
                return
            self._run_dissem(job)

    def _drain_dissem(self):
        """One timer-wheel tick: run queued dissemination rounds on this
        pool worker, as long as a park slot is free.  A job left queued
        by slot exhaustion is retried next tick — relays are latency-
        tolerant (the overlay already pipelines hops)."""
        while True:
            if not _DISSEM_SLOTS.acquire(blocking=False):
                return  # pool protection: stay queued, retry next tick
            try:
                try:
                    job = self._dq.get_nowait()
                except queue.Empty:
                    return
                if job is None:
                    continue  # stop() sentinel
                self._run_dissem(job)
            finally:
                _DISSEM_SLOTS.release()

    def _run_dissem(self, job):
        keys, vals, lens, it, cmd = job
        last, thr = None, None
        try:
            while True:
                recv = self.ask_receiver(it, last, thr)
                if recv is None:
                    break
                thr = self.send_model(recv, keys, vals, lens, it, cmd)
                last = str(recv)
        except TimeoutError:  # pragma: no cover - surfaced in logs
            import logging

            logging.getLogger(__name__).warning(
                "%s: TS dissemination round %s aborted", self.po.node, it)

    def stop(self):
        if self._dissem_task is not None:
            self._dissem_task.stop()
            self._dissem_task = None
        self._dq.put(None)
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def _on_control(self, msg: Message) -> bool:
        """A node can host several TsClients (intra + inter overlays):
        scheduler REPLYs are consumed only by the client of that
        scheduler; AUTOPULL_REPLY acks are recorded but NOT consumed so
        every client sees them (the ack key includes the round token,
        which only the initiating client waits on)."""
        if msg.control is Control.REPLY and isinstance(msg.body, dict) \
                and "receiver" in msg.body:
            if msg.sender != self.scheduler:
                return False
            with self._cv:
                self._replies[msg.timestamp] = msg.body["receiver"]
                self._cv.notify_all()
            return True
        if msg.control is Control.AUTOPULL_REPLY:
            # delivery confirmation from a relay receiver
            # (ref: WaitForFinish van.cc:1142-1165)
            key = (str(msg.sender), str(msg.body["iter"]))
            with self._cv:
                self._acks.add(key)
                self._ack_order.append(key)
                # evict oldest unmatched (foreign) acks only — a blanket
                # clear() could wipe an ack a live send_model is awaiting
                while len(self._ack_order) > 10_000:
                    self._acks.discard(self._ack_order.popleft())
                self._cv.notify_all()
            return False
        return False

    def send_model(self, recipient: NodeId, keys, vals, lens, it: str,
                   cmd: int, app_id: int = 0,
                   timeout: Optional[float] = None) -> float:
        """Send a model relay message; block for the receiver's
        AUTOPULL_REPLY; return the observed throughput (bytes/sec)."""
        ack_key = (str(recipient), it)
        with self._cv:
            self._acks.discard(ack_key)
        msg = Message(
            recipient=recipient, domain=self.domain, app_id=app_id,
            customer_id=0, timestamp=-1, request=True, push=True, cmd=cmd,
            keys=keys, vals=vals, lens=lens, body={"iter": it},
        )
        if timeout is None:
            timeout = self.po.config.ts_ask_timeout_s
        nbytes = msg.nbytes
        t0 = time.monotonic()
        self.po.van.send(msg)
        with self._cv:
            ok = self._cv.wait_for(
                lambda: ack_key in self._acks or self._stopped,
                timeout=timeout)
            if not ok or ack_key not in self._acks:
                raise TimeoutError(f"{self.po.node}: TS relay to "
                                   f"{recipient} unacked")
            self._acks.discard(ack_key)
        elapsed = max(time.monotonic() - t0, 1e-9)
        return nbytes / elapsed

    def send_reply(self, to: NodeId, it: str):
        self.po.van.send(Message(
            recipient=to, control=Control.AUTOPULL_REPLY,
            domain=self.domain, body={"iter": it},
        ))

    def ask_receiver(self, it: str, last: Optional[str] = None,
                     throughput: Optional[float] = None,
                     timeout: Optional[float] = None) -> Optional[NodeId]:
        """Blocking: who should I send the round-``it`` model to next?"""
        if timeout is None:
            timeout = self.po.config.ts_ask_timeout_s
        with self._cv:
            self._seq += 1
            seq = self._seq
        self.po.van.send(Message(
            recipient=self.scheduler, control=Control.ASK_PULL,
            domain=self.domain, timestamp=seq,
            body={"iter": it, "last": last, "throughput": throughput},
        ))
        with self._cv:
            ok = self._cv.wait_for(
                lambda: seq in self._replies or self._stopped,
                timeout=timeout)
            if not ok or seq not in self._replies:
                raise TimeoutError(f"{self.po.node}: TS ask_receiver timed out")
            r = self._replies.pop(seq)
        return NodeId.parse(r) if r else None
