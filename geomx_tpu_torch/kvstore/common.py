"""Shared kvstore constants + server concurrency primitives.

The reference multiplexes request types and dtypes into one cmd word via
Cantor pairing (ref: kvstore_dist_server.h:82-104) and sends runtime
control through CommandType (ref: kvstore_dist_server.h:49-52,
kvstore.cc:53-63).  We keep data commands and control heads as two small
enums; dtype travels with the numpy array itself.

This module also hosts the key-sharded merge primitives both server
tiers share (``StripedRLock``, ``ShardExecutor``, ``codec_pool``): the
reference serializes its whole server behind one handler (its engine
pool parallelizes only *inside* each merge,
kvstore_dist_server.h:1277-1296); we stripe the per-key state machines
so pushes touching disjoint keys merge on parallel lanes.
"""

import collections
import enum
import os
import queue
import threading
from typing import Callable, Optional

APP_PS = 0  # the parameter-server app id


def resolve_server_shards(config) -> int:
    """The effective lock-stripe / merge-lane count for a server.

    ``Config.server_shards`` 0 = auto: ``min(8, cpu_count)`` — more
    stripes than cores cannot merge in parallel, they only add lane
    threads.  Deterministic mode forces 1: parallel lanes would break
    the single-global-order guarantee the NaiveEngine analog exists
    for (customers handle inline there, so lane threads would also
    reorder handler side effects run-to-run)."""
    if getattr(config, "deterministic", False):
        return 1
    if getattr(config, "lightweight", False):
        # lightweight-party mode: inline merge lanes (no thread per
        # server) — an O(100)-server topology must not spawn O(100 x
        # lanes) lane threads; cross-server merge parallelism comes
        # from the reactor's shared handler pool instead
        return 1
    n = int(getattr(config, "server_shards", 0) or 0)
    if n <= 0:
        # env fallback even for directly-constructed Configs: lets a
        # whole test suite be shaken under forced sharding
        # (GEOMX_SERVER_SHARDS=8 pytest ...) without threading the knob
        # through every fixture
        n = int(os.environ.get("GEOMX_SERVER_SHARDS", "0") or 0)
    if n <= 0:
        n = min(8, os.cpu_count() or 1)
    return max(1, n)


class StripedRLock:
    """N reentrant lock stripes over the integer key space.

    ``stripe(k)`` guards key ``k``'s per-key state (stripe = ``k % n``);
    entering the object ITSELF acquires every stripe in ascending index
    order — the brief all-stripes barrier that membership folds,
    eviction fences, snapshots and config changes use to keep their
    exact decide-under-lock semantics (PR 1-2) against the striped hot
    path.  With ``n == 1`` both collapse to the single pre-sharding
    server RLock, so the default on a 1-core host is bit-for-bit the
    old behavior.

    Lock-order discipline (deadlock freedom): a thread holding ONE
    stripe must not acquire another stripe or the all-stripes barrier
    (ascending acquisition only protects barrier-vs-barrier).  Holding
    the barrier, any stripe may be re-entered (RLocks).  Leaf locks
    (counters, codec state) may be taken under a stripe but never the
    reverse."""

    __slots__ = ("n", "_stripes")

    def __init__(self, n: int = 1):
        self.n = max(1, int(n))
        self._stripes = [threading.RLock() for _ in range(self.n)]

    def stripe(self, key: int) -> "threading.RLock":
        return self._stripes[int(key) % self.n]

    def __enter__(self):
        for s in self._stripes:
            s.acquire()
        return self

    def __exit__(self, *exc):
        for s in reversed(self._stripes):
            s.release()
        return False

    # RLock-compatible aliases: code that treats the striped lock as a
    # plain lock object (acquire/release pairs) keeps working
    def acquire(self):
        self.__enter__()

    def release(self):
        self.__exit__()


class ShardExecutor:
    """N serial merge lanes keyed by stripe.

    Work submitted for key ``k`` runs on lane ``k % n`` in submission
    order — per-key operations keep their arrival order (the per-key
    FSA stays single-writer), while disjoint keys merge on parallel
    lanes.  ``n <= 1`` runs inline on the caller (the deterministic /
    single-core path: no threads, no reordering, identical to the
    pre-sharding server).

    ``drain()`` quiesces every lane — handler-thread operations whose
    PROGRAM ORDER against earlier pushes matters (overwrite-INIT,
    SET_COMPRESSION, checkpoint save) call it so a queued-but-unstarted
    merge cannot apply after a state change that arrived later.  Never
    call it from a lane thread (it would wait on its own lane)."""

    def __init__(self, n: int = 1, name: str = "merge"):
        self.n = max(1, int(n))
        self.inline = self.n <= 1
        self._qs = []
        if not self.inline:
            for i in range(self.n):
                q: "queue.SimpleQueue" = queue.SimpleQueue()
                self._qs.append(q)
                threading.Thread(target=self._lane, args=(q,),
                                 name=f"{name}-lane-{i}",
                                 daemon=True).start()

    def _lane(self, q: "queue.SimpleQueue"):
        while True:
            fn = q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # pragma: no cover - surfaced via logs
                import traceback

                traceback.print_exc()

    def submit(self, key: int, fn: Callable[[], None]) -> None:
        if self.inline:
            fn()
        else:
            self._qs[int(key) % self.n].put(fn)

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Block until every lane has finished all work submitted
        before this call.  Returns False on timeout (lanes keep
        running; the caller proceeds with best-effort ordering)."""
        if self.inline:
            return True
        evs = []
        for q in self._qs:
            ev = threading.Event()
            q.put(ev.set)
            evs.append(ev)
        ok = True
        for ev in evs:
            ok = ev.wait(timeout) and ok
        return ok

    def depth(self) -> int:
        """Deepest lane backlog right now (0 inline) — the flight
        recorder's ``lane_depth`` pressure reading: a lane that keeps a
        standing queue is the merge hot spot the postmortem names."""
        if self.inline:
            return 0
        return max(q.qsize() for q in self._qs)

    def stop(self):
        if not self.inline:
            for q in self._qs:
                q.put(None)


def make_merge_lanes(config, node, backend=None):
    """Both server tiers construct their stripe lock + merge lanes
    HERE, per merge backend: the lane count starts from
    :func:`resolve_server_shards` and is then capped by the backend's
    ``max_lanes`` (a device-dispatch backend serializes on its stream —
    lanes beyond its cap only contend, they cannot overlap device
    work).  The stripe count always equals the lane count: stripes
    guard the per-key state the lanes mutate, so they cap together.
    Deterministic mode still forces 1 of each (resolve_server_shards),
    whatever the backend."""
    n = resolve_server_shards(config)
    cap = getattr(backend, "max_lanes", None) if backend is not None else None
    if cap:
        n = min(n, max(1, int(cap)))
    mu = StripedRLock(n)
    return mu, ShardExecutor(n, name=f"merge-{node}")


_codec_pool = None
_codec_pool_mu = threading.Lock()


def codec_pool(config=None):
    """The small shared worker pool for per-key codec work (WAN encode
    at round completion, multi-key push decode).  Sized like the native
    merge threads (``server_merge_threads``; 0 = one per core, capped
    at 8) and shared process-wide — codec work is bursty and
    per-round, so one pool serves every server role in the process.
    Returns None when the host resolves to a single lane (1-core
    hosts, explicit ``server_merge_threads=1``): the serial path stays
    the serial path."""
    global _codec_pool
    threads = int(getattr(config, "server_merge_threads", 0) or 0)
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    if threads <= 1:
        return None
    with _codec_pool_mu:
        if _codec_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _codec_pool = ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="geomx-codec")
    return _codec_pool


def codec_pool_depth() -> int:
    """Queued-but-unstarted codec jobs in the shared pool (0 when no
    pool was ever built) — the flight recorder's ``codec_pool_busy``
    pressure reading.  Read-only: never constructs the pool."""
    pool = _codec_pool
    if pool is None:
        return 0
    try:
        return pool._work_queue.qsize()
    except AttributeError:  # executor internals moved (future python)
        return 0


class RecentRequests:
    """Bounded replay-dedup window for push requests.

    Application-level request replay (Config.request_retry_s) can deliver
    the same push twice — once the original, once the retry.  Servers
    consult this window keyed by (sender, app, customer, timestamp):

    - ``check`` returns "new" (first sighting — process it), "pending"
      (already accumulating — drop silently; the parked original will be
      acked), or "done" (already processed+acked — the ACK was lost, so
      re-ack without re-applying).
    - ``mark_done`` flips a request to "done" when its response is sent;
      an optional response body (e.g. an error) is remembered so a
      re-ack carries the same body the lost original did.

    The window is bounded; evicting the oldest entries is safe because
    the retry backoff caps how late a replay can arrive.
    """

    _PENDING = object()

    def __init__(self, cap: int = 8192):
        self._seen: "collections.OrderedDict" = collections.OrderedDict()
        self._cap = cap
        self._mu = threading.Lock()

    @staticmethod
    def _key(msg):
        # boot = sender incarnation nonce: a replaced node's timestamps
        # restart at 0; without it the replacement's fresh requests would
        # be re-acked as replays of its predecessor's (advisor r1)
        return (str(msg.sender), msg.boot, msg.app_id, msg.customer_id,
                msg.timestamp)

    def check(self, msg) -> str:
        k = self._key(msg)
        with self._mu:
            if k in self._seen:
                self._seen.move_to_end(k)
                return ("pending" if self._seen[k] is self._PENDING
                        else "done")
            self._seen[k] = self._PENDING
            while len(self._seen) > self._cap:
                self._seen.popitem(last=False)
        return "new"

    def mark_done(self, msg, body=None) -> None:
        k = self._key(msg)
        with self._mu:
            if k in self._seen:
                self._seen[k] = body

    def done_body(self, msg):
        """The response body recorded at mark_done (None if none)."""
        k = self._key(msg)
        with self._mu:
            v = self._seen.get(k)
            return None if v is self._PENDING else v

    def export_done(self) -> list:
        """Snapshot the DONE entries as [(key, body), ...] — the part of
        the window that travels with a hot-standby replication snapshot.
        A client replaying an un-ACKed request after failover may replay
        one the dead primary already applied AND replicated; the standby
        seeded with this window re-acks it instead of re-applying (the
        exactly-once half of failover replay).  PENDING entries are
        deliberately excluded: their effect is not in the snapshot."""
        with self._mu:
            return [(k, v) for k, v in self._seen.items()
                    if v is not self._PENDING]

    def seed_done(self, entries: list) -> None:
        """Install an exported done-window (standby side, replacing any
        previous seed — each snapshot carries the full window)."""
        with self._mu:
            for k, v in entries:
                self._seen[tuple(k)] = v
                self._seen.move_to_end(tuple(k))
            while len(self._seen) > self._cap:
                self._seen.popitem(last=False)


class Cmd(enum.IntEnum):
    """Data-message commands (ref: RequestType kvstore_dist_server.h:54-56)."""

    DEFAULT = 0       # gradient push / weight pull
    INIT = 1          # initial weight push
    HFA_DELTA = 2     # HFA milestone-delta push (applied additively, no
                      # optimizer — ref: HandleHFAAccumulate
                      # kvstore_dist_server.h:959-972)
    TS_AUTOPULL = 3   # TSEngine overlay model relay (ref: AutoPullUpdate
                      # kv_app.h:1040-1224)
    ROW_SPARSE_PUSH = 4  # embedding-style sparse-row gradient push
                         # (ref: row-sparse paths kvstore_dist.h:628-702)
    ROW_SPARSE_PULL = 5  # pull a subset of rows (ref: PullRowSparse)
    REPLICATE = 6        # primary global server -> hot standby: one
    #                      serialized state snapshot (the checkpoint slab
    #                      format over the wire instead of disk); body
    #                      carries {term, seq} for fencing/ordering
    SERVE_PULL = 7       # read client -> replica (geomx_tpu_torch/serve): pull
    #                      keys from the replica's staleness-bounded
    #                      local model copy; the response body carries
    #                      {staleness_s, version, rounds_at_refresh} so
    #                      readers can assert the bound
    PREDICT = 8          # read client -> replica: run a small forward
    #                      pass (MLP layer chain named by ps keys in the
    #                      body) over the replica's local copy and return
    #                      the logits — inference without ever touching
    #                      the training lanes
    CATCHUP = 9          # healed local server -> global tier: the bounded
    #                      per-key gradient delta its party accumulated
    #                      while QUARANTINED behind a partition (degraded-
    #                      mode rounds).  Rides the WAN push codec; body
    #                      carries {catchup: {rounds, age_s}} so the
    #                      global optimizer can staleness-compensate
    #                      (DC-ASGD) the merge.  Does NOT advance sync
    #                      round accounting — the party was folded out


class Ctrl(enum.IntEnum):
    """Control heads on the command channel (ref: CommandType
    kvstore_dist_server.h:49-52 kController/kSetMultiPrecision/
    kStopServer/kSyncMode/kSetGradientCompression/kSetProfilerParams,
    kvstore.cc:53-63 kSyncGlobalMode)."""

    SET_OPTIMIZER = 10
    SET_SYNC_MODE = 11         # body: {"sync": bool}
    SET_SYNC_GLOBAL_MODE = 12  # body: {"sync": bool}
    SET_COMPRESSION = 13       # body: {"type": "bsc"|"2bit"|"fp16"|"mpq", ...}
    SET_HFA = 14               # body: {"enabled": bool, "k2": int}
    # 15 reserved: STOP_SERVER (the reference's kStopServer) — shutdown
    # rides Control.TERMINATE here, so the head was dead wire surface
    # (wire-protocol audit); the value stays reserved for compatibility
    PROFILER = 16              # body: {"action": "config"|"state"|"pause"|"dump", ...}
    QUERY_STATS = 17           # body: None → reply {"wan_send_bytes": ..., ...}
    CHECKPOINT = 18            # body: {"action": "save"|"load", "path": ...}
    # 19 reserved: DEAD_NODES — the heartbeat-table query rides
    # Control.DEAD_NODES (the transport head); this duplicate command
    # head was never dispatched anywhere (wire-protocol audit)
    ESYNC = 20                 # body: {"worker", "step_s", "comm_s"} →
    #                            reply {"steps": int, "plan": {...}}
    #                            (state server; ref README.md:45 ESync
    #                            "to be integrated" — integrated here)
    LIST_KEYS = 21             # body: None → reply {"keys": [...]}; a
    #                            replacement local server's warm boot asks
    #                            each global shard for its hosted key set
    #                            before pulling the model state
    TRACE_REPORT = 22          # node -> global scheduler (fire-and-forget,
    #                            no response slot): one batch of completed
    #                            trace spans + the sender's heartbeat-RTT
    #                            clock offsets (geomx_tpu_torch/trace/collector)
    SET_WAN_POLICY = 23        # adaptive WAN controller -> servers (both
    #                            tiers): body {"epoch": int, "compression":
    #                            {...}} — global servers (receivers) adopt
    #                            immediately, local servers (senders) at
    #                            their next WAN round boundary; gradient
    #                            pushes then carry Message.policy_epoch and
    #                            cross-epoch payloads are fenced with a
    #                            retryable error (geomx_tpu_torch/control)
    METRICS_REPORT = 24        # node -> global scheduler (fire-and-forget,
    #                            no response slot, same contract as
    #                            TRACE_REPORT): one time-series sample of
    #                            the sender's system-metrics registry +
    #                            QUERY_STATS-style role stats, ring-
    #                            buffered by the MetricsCollector
    #                            (geomx_tpu_torch/obs)
    CLUSTER_STATE = 25         # operator query -> global scheduler: reply
    #                            with the merged live cluster state (shard
    #                            holders/terms, party fold state, per-node
    #                            heartbeat freshness, WAN policy epoch,
    #                            active health alerts — geomx_tpu_torch/obs/state)
    FLIGHT_DUMP = 26           # operator request -> global scheduler
    #                            (python -m geomx_tpu_torch.status
    #                            --dump-flight): snapshot every node's
    #                            flight-recorder ring.  The scheduler
    #                            relays it as a Control.FLIGHT_DUMP
    #                            broadcast under one incident id and
    #                            replies with the dump dir + expected
    #                            per-node paths (geomx_tpu_torch/obs/flight)
    SERVE_SCALE = 27           # replica autoscaler -> serve replica
    #                            (geomx_tpu_torch/serve/autoscaler): body
    #                            {"active": bool}.  False RETIRES the
    #                            replica — its refresh loop pauses and
    #                            reads are answered with an explicit
    #                            RETRY_AFTER shed so the balancer routes
    #                            elsewhere; True reactivates it (the
    #                            next refresh resyncs dense, rejoin
    #                            semantics).  Reply: {"ok", "active"}
