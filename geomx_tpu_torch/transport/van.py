"""The Van: message fabric with fault injection and priority scheduling.

The reference Van (ref: ps-lite/src/van.cc, include/ps/internal/van.h:57-128)
owns sockets, receiver threads, a priority send queue (P3), DGT channel
scheduler threads, ACK/resend, and byte accounting.  Here the same
responsibilities are split:

- ``InProcFabric``  — the "network": mailbox per node, programmable loss /
  latency / per-channel drop (the PS_DROP_MSG equivalent, ref:
  van.cc:497-499,871-877), used by tests and single-host simulation of a
  multi-party deployment (the reference tests the same way via
  pseudo-distributed scripts, ref: docs/source/pseudo-distributed-deployment.rst).
- ``TcpFabric`` (transport/tcp.py) — real sockets for multi-host runs,
  wire format v2: scatter-gather sends (payload arrays go out as their
  own iovecs, no frame-assembly copy) and zero-copy receive (decoded
  arrays are np.frombuffer views over the writeable receive buffer,
  flowing into the servers' ``Message.donated`` adopt contract).
- ``Van``           — per-node endpoint: send/recv threads, priority queue
  drain (ref: van.cc:851-860), ACK/resend (ref: resender.h), byte counters
  (ref: van.h:180-181 send_bytes_/recv_bytes_).
"""

from __future__ import annotations

import collections
import heapq
import itertools
import os
import queue
import random
import threading
import time
from typing import Callable, Dict, Optional

import logging

from geomx_tpu_torch.core.config import Config, NodeId
from geomx_tpu_torch.trace import context as _tctx
from geomx_tpu_torch.transport.message import (Control, Domain, Message,
                                         WireCorruption)

_WIRE_LOG = logging.getLogger("geomx.wire")
_wire_bootstrap_lock = threading.Lock()
_wire_bootstrapped = False

_CORRUPT_MODES = ("bitflip", "truncate")


def corrupt_bytes(raw: bytes, rng: random.Random,
                  mode: str = "bitflip") -> bytes:
    """Deterministically damage one serialized frame: flip a single
    seeded bit, or truncate at a seeded offset.  The damage model is
    intentionally minimal — one flipped bit is the HARDEST corruption
    for an application to notice without a checksum, so it is what the
    integrity plane's detection-coverage soak injects."""
    if mode not in _CORRUPT_MODES:
        raise ValueError(f"unknown corrupt mode '{mode}' "
                         f"(one of {_CORRUPT_MODES})")
    if len(raw) < 2:
        return bytes(raw)
    if mode == "truncate":
        return bytes(raw[:rng.randrange(1, len(raw))])
    buf = bytearray(raw)
    buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
    return bytes(buf)


class FaultPolicy:
    """Programmable message loss, latency, link cuts and duplication.

    ``drop_rate`` applies to reliable-channel messages (channel 0);
    ``channel_drop_rate`` to DGT's lossy channels (>=1).  Latency is a
    fixed delay or a callable ``(msg) -> seconds``; WAN (GLOBAL domain)
    latency can be set separately to model the DC/WAN asymmetry.

    ``partition``/``heal`` cut exact links: a cut ``(a, b)`` drops every
    message a→b — CONTROL TRAFFIC INCLUDED (unlike the random
    drop_rate, which spares control messages): a partition must starve
    heartbeats too, or the failure detectors the chaos soaks exercise
    would never fire.  ``"*"`` on either side wildcards, so
    ``partition("global_server:1", "*")`` isolates exactly one shard's
    links instead of approximating with a global drop_rate.

    ``duplicate_rate`` re-delivers a copy of a data message with that
    probability — the at-least-once failure mode real networks and the
    replay machinery produce, injected deterministically (tests assert
    the dedup windows absorb it).
    """

    def __init__(
        self,
        drop_rate: float = 0.0,
        channel_drop_rate: float = 0.0,
        latency_s: float = 0.0,
        wan_latency_s: Optional[float] = None,
        lan_bandwidth_bps: float = 0.0,
        wan_bandwidth_bps: float = 0.0,
        duplicate_rate: float = 0.0,
        seed: int = 0,
    ):
        self.drop_rate = drop_rate
        self.channel_drop_rate = channel_drop_rate
        self.latency_s = latency_s
        self.wan_latency_s = wan_latency_s if wan_latency_s is not None else latency_s
        # bytes/sec uplink capacity per (sender, domain) link; 0 = infinite.
        # Bandwidth serialization is what makes priority scheduling (P3)
        # and contribution-ranked channels (DGT) *measurable* in the sim:
        # with latency alone, concurrent messages never contend
        self.lan_bandwidth_bps = lan_bandwidth_bps
        self.wan_bandwidth_bps = wan_bandwidth_bps
        self.duplicate_rate = duplicate_rate
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # directed link cuts: (sender, recipient) node strings, "*" wild
        self._cuts: set = set()
        self.cut_dropped = 0  # messages eaten by a partition
        # in-flight corruption rules: (sender, recipient) -> [rate, mode,
        # seeded rng], "*" wild on either side.  Each rule owns its own
        # Random so a scripted corruption tape reproduces exactly
        # regardless of what the shared drop/duplicate rng consumed.
        self._corrupt_rules: Dict[tuple, list] = {}

    # ---- targeted partition injection ------------------------------------
    def partition(self, a: str, b: str = "*", symmetric: bool = True):
        """Cut the link a→b (and b→a when ``symmetric``).  ``a``/``b``
        are node strings (``str(NodeId)``) or ``"*"``.  One-way cuts
        (``symmetric=False``) model asymmetric failures: a can still
        hear b while b never hears a."""
        a, b = str(a), str(b)
        with self._lock:
            self._cuts.add((a, b))
            if symmetric:
                self._cuts.add((b, a))

    def heal(self, a: Optional[str] = None, b: Optional[str] = None,
             symmetric: bool = True):
        """Remove cuts.  No arguments heals everything; ``heal(a)``
        heals every cut naming ``a`` on either side; ``heal(a, b)``
        heals that pair — both directions by default, only the a→b
        direction with ``symmetric=False`` (the asymmetric-cut inverse:
        a one-way cut healed one way, or one leg of a full cut restored
        while the other stays dark)."""
        with self._lock:
            if a is None:
                self._cuts.clear()
                return
            a = str(a)
            if b is None:
                self._cuts = {c for c in self._cuts if a not in c}
            else:
                b = str(b)
                self._cuts.discard((a, b))
                if symmetric:
                    self._cuts.discard((b, a))

    def blackhole(self, node: str, peers, symmetric: bool = True):
        """Cut ``node``'s links to every peer in ``peers`` — the party/
        region-scoped blackhole (one WAN uplink dies, the LAN behind it
        keeps working) that a bare wildcard ``partition(node, "*")``
        cannot express without also cutting intra-party traffic."""
        for p in peers:
            self.partition(node, p, symmetric=symmetric)

    # ---- targeted corruption injection -----------------------------------
    def corrupt(self, a: str = "*", b: str = "*", rate: float = 1.0,
                mode: str = "bitflip", seed: int = 0):
        """Damage data frames on the link a→b in flight with probability
        ``rate`` (``mode`` in {"bitflip", "truncate"}).  Control traffic
        is spared — corruption chaos must not eat the very NACKs/ACKs
        that recover from it (a cut already models total link failure).
        Per-rule seeded rng: the same (seed, message sequence) produces
        the same corruption tape."""
        if mode not in _CORRUPT_MODES:
            raise ValueError(f"unknown corrupt mode '{mode}' "
                             f"(one of {_CORRUPT_MODES})")
        a, b = str(a), str(b)
        with self._lock:
            self._corrupt_rules[(a, b)] = [float(rate), mode,
                                           random.Random(seed)]

    def heal_corrupt(self, a: Optional[str] = None,
                     b: Optional[str] = None):
        """Remove corruption rules — same shape as :meth:`heal`."""
        with self._lock:
            if a is None:
                self._corrupt_rules.clear()
                return
            a = str(a)
            if b is None:
                self._corrupt_rules = {k: v
                                       for k, v in self._corrupt_rules.items()
                                       if a not in k}
            else:
                self._corrupt_rules.pop((a, str(b)), None)

    def corruption_roll(self, msg: Message):
        """Roll the seeded dice for ``msg``: ``(mode, rng)`` when this
        frame should be damaged in flight, else None.  Data frames only
        (``Control.EMPTY``) — see :meth:`corrupt`."""
        if not self._corrupt_rules or msg.control is not Control.EMPTY:
            return None
        s, r = str(msg.sender), str(msg.recipient)
        with self._lock:
            for key in ((s, r), (s, "*"), ("*", r), ("*", "*")):
                rule = self._corrupt_rules.get(key)
                if rule is not None:
                    rate, mode, rng = rule
                    if rng.random() < rate:
                        return mode, rng
                    return None
        return None

    def is_cut(self, msg: Message) -> bool:
        if not self._cuts:
            return False
        s, r = str(msg.sender), str(msg.recipient)
        with self._lock:
            return ((s, r) in self._cuts or (s, "*") in self._cuts
                    or ("*", r) in self._cuts)

    def should_duplicate(self, msg: Message) -> bool:
        if self.duplicate_rate <= 0.0 or msg.control is not Control.EMPTY:
            return False
        with self._lock:
            return self._rng.random() < self.duplicate_rate

    def should_drop(self, msg: Message) -> bool:
        if self.is_cut(msg):
            # partitions cut EVERYTHING on the link, heartbeats included
            self.cut_dropped += 1
            return True
        if msg.control is not Control.EMPTY:
            return False  # never randomly drop control traffic in sim
        rate = self.channel_drop_rate if msg.channel >= 1 else self.drop_rate
        if rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < rate

    def latency(self, msg: Message) -> float:
        return self.wan_latency_s if msg.domain is Domain.GLOBAL else self.latency_s

    def bandwidth(self, msg: Message) -> float:
        return (self.wan_bandwidth_bps if msg.domain is Domain.GLOBAL
                else self.lan_bandwidth_bps)

    @classmethod
    def from_config(cls, config: Config, seed: int = 0) -> "FaultPolicy":
        """Honor the PS_DROP_MSG-equivalent knobs (ref: van.cc:497-499)."""
        return cls(drop_rate=config.drop_rate,
                   channel_drop_rate=config.channel_drop_rate, seed=seed)


class _Mailbox:
    """Per-node inbox.  Legacy path: a queue.Queue drained by the Van's
    recv thread.  Lightweight/reactor path: a SerialChannel sink is
    attached (``Van.start``) and ``put`` routes straight into it — same
    FIFO order, dispatched on the shared handler pool instead of a
    dedicated thread.  Fabrics must deliver via :meth:`put` (never
    ``q.put`` directly) so both paths work."""

    def __init__(self):
        self.q: "queue.Queue[Message]" = queue.Queue()
        self._sink = None
        self._mu = threading.Lock()

    def put(self, msg: Message) -> None:
        with self._mu:
            sink = self._sink
            if sink is not None:
                # inside the lock: a concurrent detach must not race a
                # put into a channel being closed
                sink.put(msg)
                return
        self.q.put(msg)

    def attach_sink(self, sink) -> None:
        """Route future (and already-queued) messages into ``sink`` —
        queued backlog first, preserving arrival order."""
        with self._mu:
            while True:
                try:
                    sink.put(self.q.get_nowait())
                except queue.Empty:
                    break
            self._sink = sink

    def detach_sink(self) -> None:
        with self._mu:
            self._sink = None


class InProcFabric:
    """In-process network: one mailbox per node + a delayed-delivery thread.

    ``serial=True`` (or ``Config.deterministic``) is the NaiveEngine
    analog (ref: src/engine/naive_engine.cc — MXNET_ENGINE_TYPE's
    sequential debug engine): one global FIFO queue and ONE dispatcher
    thread process every node's inbound messages in enqueue order, so a
    race reproduces identically run-to-run (given deterministic
    producers).  Latency injection is ignored in serial mode — wall-clock
    reordering would reintroduce the nondeterminism the mode removes."""

    def __init__(
        self,
        fault: Optional[FaultPolicy] = None,
        config: Optional[Config] = None,
        serial: Optional[bool] = None,
        reactor=None,
        lightweight: bool = False,
    ):
        if fault is None:
            fault = FaultPolicy.from_config(config) if config else FaultPolicy()
        self.fault = fault
        self.serial = bool(serial if serial is not None
                           else (config.deterministic if config else False))
        # lightweight-party mode (transport/reactor.py): vans/customers
        # on this fabric dispatch through serial channels on the shared
        # reactor instead of per-node threads, and timer loops (resend,
        # heartbeat, monitors) land on the reactor's timer wheel.
        # Deterministic mode wins: the serial fabric's single dispatcher
        # is already thread-free and globally ordered.
        self.reactor = reactor
        self.lightweight = bool(lightweight) and reactor is not None
        self._boxes: Dict[str, _Mailbox] = {}
        self._lock = threading.Lock()
        self._heap = []  # (due, tiebreak, msg)
        self._tie = itertools.count()
        self._cv = threading.Condition()
        self._stop = False
        self._timer: Optional[threading.Thread] = None
        self._link_free: Dict[tuple, float] = {}  # (sender, domain) -> t
        self.dropped = 0  # observability for loss-injection tests
        self.duplicated = 0  # messages re-delivered by duplicate_rate
        # corruption-injection ledger (chaos soaks assert coverage):
        # injected = frames damaged in flight; detected = checksum caught
        # it (NACK sent when the frame was reliable); dropped = damage
        # broke framing outright (resend timer recovers); delivered =
        # the frame still decoded — with integrity off this is the
        # silent-poison path the plane exists to close.
        self.corrupt_injected = 0
        self.corrupt_detected = 0
        self.corrupt_dropped = 0
        self.corrupt_delivered = 0
        self._integrity_counters: Dict[str, object] = {}
        self._serial_q: "queue.Queue" = queue.Queue()
        self._serial_receivers: Dict[str, Callable[[Message], None]] = {}
        self._serial_thread: Optional[threading.Thread] = None

    # ---- deterministic (serial) mode ------------------------------------
    def set_serial_receiver(self, node: NodeId,
                            cb: Callable[[Message], None]) -> None:
        with self._lock:
            self._serial_receivers[str(node)] = cb
            if self._serial_thread is None:
                self._serial_thread = threading.Thread(
                    target=self._serial_loop, name="fabric-serial",
                    daemon=True)
                self._serial_thread.start()

    def remove_serial_receiver(self, node: NodeId, cb) -> None:
        """Van.stop in serial mode: only remove OUR registration — a
        replacement node may have already re-registered under this id."""
        with self._lock:
            if self._serial_receivers.get(str(node)) is cb:
                del self._serial_receivers[str(node)]

    def _serial_loop(self):
        while True:
            msg = self._serial_q.get()
            if msg is None:
                return
            with self._lock:
                cb = self._serial_receivers.get(str(msg.recipient))
            if cb is None:
                continue  # node stopped/unregistered
            try:
                cb(msg)
            except Exception:  # pragma: no cover
                import traceback

                traceback.print_exc()

    def register(self, node: NodeId) -> _Mailbox:
        with self._lock:
            box = self._boxes.setdefault(str(node), _Mailbox())
        return box

    def deliver(self, msg: Message) -> bool:
        """Route to the recipient mailbox. Returns False if dropped."""
        if self.fault.should_drop(msg):
            self.dropped += 1
            return False
        roll = self.fault.corruption_roll(msg)
        if roll is not None:
            return self._deliver_corrupted(msg, *roll)
        if self.fault.should_duplicate(msg):
            # at-least-once injection: a shallow copy rides the same
            # path (in-proc payloads are by-reference anyway; the copy
            # keeps the two deliveries' mutable header fields apart).
            # The copy is routed FIRST so the duplicate can also arrive
            # ahead of the original — the reordered-duplicate case the
            # dedup windows must absorb.
            import copy

            self.duplicated += 1
            self._route(copy.copy(msg))
        return self._route(msg)

    def _deliver_corrupted(self, msg: Message, mode: str,
                           rng: random.Random) -> bool:
        """Emulate in-flight damage for the by-reference fabric: the
        frame is serialized, corrupted, and re-decoded — exactly what a
        flipped WAN bit does to a real socket.  A checksum-stamped frame
        surfaces as :class:`WireCorruption` (counted + NACKed so the
        sender retransmits NOW); unstamped damage either breaks framing
        (dropped; the resend timer recovers) or decodes anyway — the
        silent-poison delivery the integrity plane exists to close."""
        self.corrupt_injected += 1
        try:
            raw = corrupt_bytes(msg.to_bytes(), rng, mode)
        except Exception:
            return self._route(msg)  # unserializable: deliver clean
        try:
            decoded = Message.from_bytes(bytearray(raw))
        except WireCorruption:
            self.corrupt_detected += 1
            self._count_integrity_reject(str(msg.recipient))
            if msg.msg_sig >= 0 and msg.channel == 0:
                # reliable frame: tell the sender instead of waiting out
                # its resend backoff.  Lossy DGT channels are never
                # resent, so there is nothing to NACK.
                self._route(Message(
                    sender=msg.recipient, recipient=msg.sender,
                    control=Control.NACK, domain=msg.domain,
                    msg_sig=msg.msg_sig, boot=msg.boot))
            return False
        except Exception:
            self.corrupt_dropped += 1
            return False
        self.corrupt_delivered += 1
        return self._route(decoded)

    def _count_integrity_reject(self, node_s: str):
        c = self._integrity_counters.get(node_s)
        if c is None:
            from geomx_tpu_torch.utils.metrics import system_counter

            c = self._integrity_counters.setdefault(
                node_s, system_counter(f"{node_s}.integrity_wire_rejects"))
        c.inc()

    def _route(self, msg: Message) -> bool:
        if self.serial:
            if (msg.control is Control.TERMINATE
                    and msg.sender == msg.recipient):
                return True  # van self-stopper: no recv thread to stop
            self._serial_q.put(msg)
            return True
        delay = self.fault.latency(msg)
        bw = self.fault.bandwidth(msg)
        if bw > 0.0 and msg.control is Control.EMPTY:
            # serialize transmissions on the sender's uplink: the link is
            # busy for nbytes/bw; a message starts transmitting when the
            # link frees.  Delivery = transmission end + propagation
            # latency.  The sender BLOCKS until its transmission ends —
            # the backpressure a real socket applies — so a Van's
            # priority send queue actually reorders: later high-priority
            # messages jump transmissions still queued behind a busy
            # link.  Without blocking, the queue drains instantly and P3
            # ordering can never matter (the round-1 'P3 is inert' gap).
            link = (str(msg.sender), msg.domain)
            now = time.monotonic()
            with self._lock:
                free = self._link_free.get(link, now)
                start = max(now, free)
                end = start + msg.nbytes / bw
                self._link_free[link] = end
            time.sleep(max(0.0, end - now))
        if delay <= 0.0:
            self._put(msg)
        else:
            with self._cv:
                if self._timer is None:
                    self._timer = threading.Thread(
                        target=self._timer_loop, name="fabric-timer", daemon=True
                    )
                    self._timer.start()
                heapq.heappush(self._heap, (time.monotonic() + delay, next(self._tie), msg))
                self._cv.notify()
        return True

    def _put(self, msg: Message):
        with self._lock:
            box = self._boxes.get(str(msg.recipient))
        if box is None:
            raise KeyError(f"no mailbox for {msg.recipient}")
        box.put(msg)

    def _timer_loop(self):
        while True:
            with self._cv:
                while not self._heap and not self._stop:
                    self._cv.wait(timeout=0.5)
                    if self._stop:
                        return
                if self._stop:
                    return
                due, _, msg = self._heap[0]
                now = time.monotonic()
                if due > now:
                    self._cv.wait(timeout=due - now)
                    continue
                heapq.heappop(self._heap)
            try:
                self._put(msg)
            except KeyError:
                # an unregistered recipient must not kill the shared timer
                # thread and stall every other delayed delivery
                logging.getLogger(__name__).warning(
                    "dropping delayed message to unknown node %s", msg.recipient
                )

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._serial_thread is not None:
            self._serial_q.put(None)


def apply_member_addrs(fabric, addrs, self_node: str) -> None:
    """Install out-of-plan members' advertised addresses (the
    membership broadcast's ``addrs`` map) into an address-planned
    fabric.  No-op on fabrics without ``add_address`` (in-proc).  Under
    the TS overlay PEERS relay to a dynamic joiner and the SCHEDULER
    replies to its asks, so every party node needs the slot — not just
    the server the joiner registered with.  Repeated broadcasts are
    harmless: ``update_address`` returns early on an unchanged
    address."""
    add = getattr(fabric, "add_address", None)
    if add is None or not addrs:
        return
    for n, a in addrs.items():
        if n == self_node:
            continue
        try:
            add(n, (a[0], int(a[1])))
        except (TypeError, ValueError, IndexError):
            continue


class Van:
    """Per-node transport endpoint.

    ``send`` either delivers directly or routes through the priority send
    queue (dedicated drain thread, ordered by ``msg.priority`` — ref:
    threadsafe_queue.h:49-58, van.cc:851-860) so that under P3 shallow
    layers jump the line.  A background receive thread dispatches every
    inbound message to the registered receiver callback.
    """

    def __init__(
        self,
        node: NodeId,
        fabric: InProcFabric,
        config: Optional[Config] = None,
        use_priority_queue: bool = False,
    ):
        self.node = node
        self.fabric = fabric
        self.config = config or Config()
        # incarnation nonce: one per Van instance, so a restarted /
        # replaced node (whose Customer timestamps restart at 0) is
        # distinguishable from its predecessor in replay-dedup windows
        # (advisor r1; cf. the reference's lack of one — silent replay
        # misclassification after recovery)
        self.boot = int.from_bytes(os.urandom(6), "little") | 1
        self._box = fabric.register(node)
        self._receiver: Optional[Callable[[Message], None]] = None
        self._recv_thread: Optional[threading.Thread] = None
        self._chan = None  # lightweight-mode serial dispatch channel
        self._resend_task = None  # timer-wheel resend entry
        self._send_thread: Optional[threading.Thread] = None
        self._send_task = None  # timer-wheel priority drain (lightweight)
        self._pq: "queue.PriorityQueue" = queue.PriorityQueue()
        self._pq_tie = itertools.count()
        self.use_priority_queue = use_priority_queue
        # bandwidth-limited fabrics apply backpressure by SLEEPING in
        # deliver(); that must happen on a dedicated drain thread, never
        # on an app/handler thread that may hold server state locks
        # (a server sleeping a full transmission inside its mutex would
        # serialize every party's requests).  P3 additionally wants the
        # drain so its priority queue actually reorders under contention.
        fp = getattr(fabric, "fault", None)
        self._use_send_thread = bool(use_priority_queue or (
            fp is not None and (getattr(fp, "lan_bandwidth_bps", 0)
                                or getattr(fp, "wan_bandwidth_bps", 0))))
        self._running = False
        # simulated process death (tests): stop() leaves app threads able
        # to SEND — the graceful half — but a SIGKILLed process neither
        # receives nor transmits.  kill() sets this; start() (a zombie
        # reviving at its old identity) clears it.
        self.killed = False
        # byte accounting (ref: van.h:180-181); wan_* counts GLOBAL-domain only
        self.send_bytes = 0
        self.recv_bytes = 0
        self.wan_send_bytes = 0
        self.wan_recv_bytes = 0
        # distributed tracing (geomx_tpu_torch/trace): recorder fetched lazily
        # (tracing may activate after this van is built), plus per-codec
        # WAN byte counters mirrored into the system-metrics registry so
        # the tracer's reports and bench.py read the same ledger
        self._tracer = None
        # black-box flight recorder (geomx_tpu_torch/obs/flight): wired by the
        # owning Postoffice when Config.enable_flight (default ON); None
        # = one attribute check per message, nothing recorded
        self.flight = None
        self._wan_codec_counters: Dict[str, object] = {}
        # P3 observability: count priority-queue overtakes (a message
        # dequeued before an earlier-enqueued one — i.e. the queue
        # actually reordered under contention)
        self.pq_overtakes = 0
        self._max_popped_tie = -1
        self._stats_lock = threading.Lock()
        # resender state (ref: resender.h:15-141).  Dedup keys are
        # (sender, sig) so per-sender counters can't collide; the window is
        # bounded like the reference's rotating dedup cache.
        self._resend_timeout = (self.config.resend_timeout_ms or 0) / 1000.0
        # sig -> [msg, last_send_monotonic, num_retry]; backoff & retry cap
        # mirror the reference (ref: resender.h Entry{msg, send, num_retry})
        self._pending_acks: Dict[int, list] = {}
        self._max_retries = 20
        self._seen_sigs: set = set()
        self._seen_order: "collections.deque" = collections.deque()
        self._seen_cap = 100_000
        self._sig_counter = itertools.count(1)
        self._resend_thread: Optional[threading.Thread] = None
        self._nack_counter = None  # lazy integrity_wire_nacks

    # ---- lifecycle ----------------------------------------------------------
    def start(self, receiver: Callable[[Message], None]):
        self._receiver = receiver
        self._running = True
        self.killed = False
        if getattr(self.fabric, "serial", False):
            # deterministic mode: the fabric's single dispatcher calls
            # _handle_inbound in global FIFO order — no recv thread
            self.fabric.set_serial_receiver(self.node, self._handle_inbound)
        elif getattr(self.fabric, "lightweight", False):
            # lightweight-party mode: a serial channel on the shared
            # reactor pool replaces the per-node recv thread — same
            # per-node FIFO order, O(1) threads in node count
            self._chan = self.fabric.reactor.channel(
                self._handle_inbound, name=f"van-{self.node}")
            self._box.attach_sink(self._chan)
        else:
            self._recv_thread = threading.Thread(
                target=self._recv_loop, name=f"van-recv-{self.node}",
                daemon=True
            )
            self._recv_thread.start()
        if self._use_send_thread:
            if getattr(self.fabric, "lightweight", False):
                # timer-wheel drain instead of a per-node priority
                # thread: each tick pops everything queued (highest
                # priority first) and transmits on a pool worker.
                # Periodic skips overlapping ticks, so a bandwidth-
                # shaped deliver() sleep still serializes transmissions
                # exactly as the dedicated drain thread did — and the
                # between-tick dwell is where later high-priority
                # messages overtake queued ones (the P3 reorder window).
                from geomx_tpu_torch.transport.reactor import Periodic

                self._send_task = Periodic(
                    0.002, self._drain_pq,
                    name=f"van-send-{self.node}",
                    reactor=self.fabric.reactor)
            else:
                self._send_thread = threading.Thread(
                    target=self._send_loop, name=f"van-send-{self.node}",
                    daemon=True
                )
                self._send_thread.start()
        if self._resend_timeout > 0:
            reactor = getattr(self.fabric, "reactor", None)
            if reactor is not None:
                # timer-wheel entry instead of a per-node sleep thread
                self._resend_task = reactor.call_every(
                    self._resend_timeout / 2, self._resend_sweep,
                    name=f"van-resend-{self.node}")
            else:
                self._resend_thread = threading.Thread(
                    target=self._resend_loop,
                    name=f"van-resend-{self.node}", daemon=True
                )
                self._resend_thread.start()

    def stop(self):
        if not self._running:
            return  # already stopped (kill() + po.stop() double-call);
            #         a second self-stopper would sit in the mailbox and
            #         instantly kill a revived zombie's receive loop
        self._running = False
        if self._resend_task is not None:
            self._resend_task.cancel()
            self._resend_task = None
        if getattr(self.fabric, "serial", False):
            # unregister so a "killed" node stops processing — without
            # this a deterministic-mode restart test would keep the ghost
            # server merging replayed pushes from its pre-kill store
            remove = getattr(self.fabric, "remove_serial_receiver", None)
            if remove is not None:
                remove(self.node, self._handle_inbound)
        if self._chan is not None:
            # detach FIRST (later arrivals fall into the unread queue —
            # a stopped node processes nothing further), then drop the
            # channel's backlog
            self._box.detach_sink()
            self._chan.close()
            self._chan = None
        else:
            stopper = Message(sender=self.node, recipient=self.node,
                              control=Control.TERMINATE)
            self._box.put(stopper)
        if self._send_task is not None:
            self._send_task.stop()
            self._send_task = None
        if self._use_send_thread:
            self._pq.put((0, next(self._pq_tie), None))
        if self._recv_thread:
            self._recv_thread.join(timeout=5)
            self._recv_thread = None

    def kill(self):
        """Thread-level SIGKILL for tests: stop receiving AND silently
        drop every later send (a dead process transmits nothing — app
        threads that outlive the 'process' must not keep pushing)."""
        self.killed = True
        self.stop()

    # ---- send path ----------------------------------------------------------
    def send(self, msg: Message, priority: Optional[int] = None):
        if self.killed:
            return  # simulated dead process: the wire never sees this
        msg.sender = self.node
        msg.boot = self.boot
        if priority is not None:
            msg.priority = priority
        if _tctx.ACTIVE:
            # automatic context propagation: a message sent from inside a
            # sampled span joins its trace.  A message that already
            # carries a trace (a response, a retransmit, a retarget
            # replay) keeps its ORIGINAL ids — replays show up as extra
            # children of the original round, never as a new trace.
            if msg.trace_id == 0:
                ctx = _tctx.current()
                if ctx is not None:
                    msg.trace_id = ctx.trace_id
                    msg.parent_span_id = ctx.span_id
                    msg.sampled = True
            if msg.trace_id > 0 and msg.span_id == 0:
                msg.span_id = _tctx.new_span_id()
        if self._use_send_thread and msg.control is Control.EMPTY:
            # negative: PriorityQueue pops smallest first, we want highest first
            self._pq.put((-msg.priority, next(self._pq_tie), msg))
        else:
            self._send_now(msg)

    def _send_now(self, msg: Message):
        # lossy-by-design channels (DGT chunks, channel >= 1) are never
        # resent — retransmitting "unimportant" chunks would defeat the
        # best-effort design and leak reassembly buffers
        if (self._resend_timeout > 0 and msg.control is Control.EMPTY
                and msg.channel == 0):
            if msg.msg_sig < 0:
                msg.msg_sig = next(self._sig_counter)
            self._pending_acks[msg.msg_sig] = [msg, time.monotonic(), 0]
        self._account_send(msg)
        self._deliver_guarded(msg)

    def _deliver_guarded(self, msg: Message):
        """Unknown recipients and transient transport failures (TCP connect
        refused during startup races, peer restarts) must not kill sender
        threads (resend loop, priority drain) or crash app threads —
        surface as a log + drop; the resender recovers reliable traffic."""
        try:
            self.fabric.deliver(msg)
        except (KeyError, OSError) as e:
            logging.getLogger(__name__).warning(
                "%s: dropping message to %s (%s)", self.node, msg.recipient, e
            )

    def _account_send(self, msg: Message):
        n = msg.nbytes
        with self._stats_lock:
            self.send_bytes += n
            if msg.domain is Domain.GLOBAL:
                self.wan_send_bytes += n
        fl = self.flight
        if fl is not None:
            fl.msg_send(msg, n)
        if msg.control is Control.EMPTY:
            is_wan = msg.domain is Domain.GLOBAL
            if is_wan:
                # per-codec WAN ledger, keyed by the wire compr tag ("" =
                # vanilla/uncompressed; mpq shows up as the bsc/fp16
                # split it actually chose per message)
                self._wan_codec_counter(msg.compr).inc(n)
            if _tctx.ACTIVE and msg.trace_id > 0:
                # one instant per sampled message, under the MESSAGE's
                # span id: receivers parent their handler spans at it,
                # so every edge of the cross-node chain resolves to a
                # recorded event (LAN hops included)
                self._trace_event("wan.send" if is_wan else "lan.send",
                                  span=msg.span_id,
                                  parent=msg.parent_span_id,
                                  trace_id=msg.trace_id, nbytes=n,
                                  peer=str(msg.recipient))
        if self.config.verbose >= 2:
            self._log_wire("SEND", msg, n)

    def _wan_codec_counter(self, tag: str):
        c = self._wan_codec_counters.get(tag)
        if c is None:
            from geomx_tpu_torch.utils.metrics import system_counter

            c = self._wan_codec_counters.setdefault(tag, system_counter(
                f"{self.node}.wan_bytes_{tag or 'vanilla'}"))
        return c

    def _trace_event(self, name: str, **kw):
        tr = self._tracer
        if tr is None:
            from geomx_tpu_torch.trace.recorder import get_tracer

            tr = self._tracer = get_tracer(str(self.node))
        tr.instant(name, **kw)

    def _log_wire(self, direction: str, msg: Message, nbytes: int):
        """Wire-level message log (ref: PS_VERBOSE >= 2 prints every
        message, van.cc:841-843,880-882).  Ensures the logger actually
        emits: python's last-resort handler drops INFO, and asking for
        verbose wire logs IS the opt-in."""
        global _wire_bootstrapped
        if not _wire_bootstrapped:
            with _wire_bootstrap_lock:
                if not _wire_bootstrapped:
                    # respect handlers the application already attached to
                    # geomx.wire or the root — only bootstrap into a void
                    if (not _WIRE_LOG.handlers
                            and not logging.getLogger().handlers):
                        h = logging.StreamHandler()
                        h.setFormatter(logging.Formatter("%(message)s"))
                        _WIRE_LOG.addHandler(h)
                        # a private handler must not double-emit once the
                        # app later configures the root logger
                        _WIRE_LOG.propagate = False
                    _WIRE_LOG.setLevel(logging.INFO)
                    _wire_bootstrapped = True
        _WIRE_LOG.info(
            "%s %s %s->%s ctrl=%s %s%s%s cmd=%s ts=%s keys=%s %dB",
            direction, msg.domain.name, msg.sender, msg.recipient,
            msg.control.name, "REQ" if msg.request else "rsp",
            " push" if msg.push else "", " pull" if msg.pull else "",
            msg.cmd, msg.timestamp,
            None if msg.keys is None else len(msg.keys), nbytes,
        )

    def _send_loop(self):
        while self._running:
            _, tie, msg = self._pq.get()
            if msg is None:
                return
            if tie < self._max_popped_tie:
                self.pq_overtakes += 1  # enqueued before one already sent
            else:
                self._max_popped_tie = tie
            self._send_now(msg)

    def _drain_pq(self):
        """Lightweight-mode priority drain (one timer-wheel tick): pop
        everything queued right now, highest priority first.  Runs on
        the reactor worker pool; a bandwidth-shaped ``deliver()`` may
        park this worker for the transmission — bounded by the link
        model, and the skipped-tick rule keeps at most one drain
        in flight per van."""
        while self._running:
            try:
                _, tie, msg = self._pq.get_nowait()
            except queue.Empty:
                return
            if msg is None:
                continue  # stop() sentinel from a prior incarnation
            if tie < self._max_popped_tie:
                self.pq_overtakes += 1
            else:
                self._max_popped_tie = tie
            self._send_now(msg)

    # ---- receive path -------------------------------------------------------
    def _recv_loop(self):
        while self._running:
            msg = self._box.q.get()
            if msg.control is Control.TERMINATE and msg.sender == self.node:
                return
            self._handle_inbound(msg)

    def _handle_inbound(self, msg: Message):
        """Process one inbound message: accounting, wire log, ACK/dedup,
        then the registered receiver.  Called from the recv thread, or
        directly by a serial fabric's dispatcher (deterministic mode)."""
        n = msg.nbytes
        with self._stats_lock:
            self.recv_bytes += n
            if msg.domain is Domain.GLOBAL:
                self.wan_recv_bytes += n
        fl = self.flight
        if fl is not None:
            fl.msg_recv(msg, n)
        if (_tctx.ACTIVE and msg.trace_id > 0
                and msg.domain is Domain.GLOBAL
                and msg.control is Control.EMPTY):
            # paired with the sender's wan.send (parent = the message's
            # span id): the collector recovers WAN transit time from the
            # clock-corrected gap between the two instants
            self._trace_event("wan.recv", parent=msg.span_id,
                              trace_id=msg.trace_id, nbytes=n,
                              peer=str(msg.sender))
        if self.config.verbose >= 2:
            self._log_wire("RECV", msg, n)
        if msg.control is Control.ACK:
            self._pending_acks.pop(msg.msg_sig, None)
            return
        if msg.control is Control.NACK:
            # receiver-side integrity verdict: our frame arrived damaged.
            # Retransmit immediately instead of waiting out the resend
            # backoff; the retry budget still applies, so a link that
            # corrupts every copy eventually gives up like a timeout
            # would (the reference resender has no NACK — corruption
            # there IS a timeout).  Duplicate delivery of the resend is
            # absorbed by the receiver's replay-dedup window.
            entry = self._pending_acks.get(msg.msg_sig)
            if entry is not None:
                if self._nack_counter is None:
                    from geomx_tpu_torch.utils.metrics import system_counter

                    self._nack_counter = system_counter(
                        f"{self.node}.integrity_wire_nacks")
                self._nack_counter.inc()
                if fl is not None:
                    from geomx_tpu_torch.obs.flight import FlightEv

                    fl.record(FlightEv.CORRUPT, peer=str(msg.sender),
                              note="wire_nack_resend")
                if entry[2] >= self._max_retries:
                    self._pending_acks.pop(msg.msg_sig, None)
                else:
                    entry[1] = time.monotonic()
                    entry[2] += 1
                    self._account_send(entry[0])
                    self._deliver_guarded(entry[0])
            return
        # ACK + dedup keyed on the *sender's* resender being active (it
        # stamped msg_sig) — never on this receiver's own config.
        if msg.msg_sig >= 0 and msg.control is Control.EMPTY:
            ack = Message(
                sender=self.node, recipient=msg.sender, control=Control.ACK,
                domain=msg.domain, msg_sig=msg.msg_sig,
            )
            self._account_send(ack)
            # guarded: an ACK to a vanished peer must not kill the
            # receive thread
            self._deliver_guarded(ack)
            # boot in the key: a replacement node restarts its sig
            # counter, so without the incarnation its first reliable
            # sends would be suppressed as its predecessor's duplicates
            dedup_key = (str(msg.sender), msg.boot, msg.msg_sig)
            if dedup_key in self._seen_sigs:
                if fl is not None:
                    fl.msg_dedup(msg)
                return  # duplicate suppression (ref: resender.h:60-77)
            self._seen_sigs.add(dedup_key)
            self._seen_order.append(dedup_key)
            if len(self._seen_order) > self._seen_cap:
                self._seen_sigs.discard(self._seen_order.popleft())
        try:
            self._receiver(msg)
        except Exception:  # pragma: no cover - surfaced by tests via logs
            import traceback

            traceback.print_exc()

    def _resend_loop(self):
        while self._running:
            time.sleep(self._resend_timeout / 2)
            self._resend_sweep()

    def _resend_sweep(self):
        """One pass over the un-ACKed window (the resend thread's loop
        body, also the timer-wheel entry in reactor mode)."""
        if not self._running:
            return
        now = time.monotonic()
        for sig, entry in list(self._pending_acks.items()):
            if not self._running:
                return
            msg, last_send, num_retry = entry
            # exponential-ish backoff like the reference:
            # timeout * (1 + num_retry)  (ref: resender.h)
            if now - last_send < self._resend_timeout * (1 + num_retry):
                continue
            if num_retry >= self._max_retries:
                logging.getLogger(__name__).warning(
                    "giving up on message sig=%s to %s after %d retries",
                    sig, msg.recipient, num_retry,
                )
                self._pending_acks.pop(sig, None)
                continue
            entry[1] = now
            entry[2] = num_retry + 1
            self._account_send(msg)  # retransmits are real wire bytes
            self._deliver_guarded(msg)
