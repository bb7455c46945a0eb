"""Hierarchical Parameter Server: local (tier-1) and global (tier-2) servers.

This replaces the reference's single 2000-line handler class
(ref: src/kvstore/kvstore_dist_server.h) with explicit per-key state
machines, as SURVEY.md §7 mandates.  The FSA data flow it implements
(ref call stack: kvstore_dist_server.h:1213-1366, 899-957, 974-1169):

  worker push ──► LocalServer: accumulate; ack worker immediately
      when all party workers pushed:
        merged gradient ──► zpush to global shards  [WAN]
        all global ACKs  ──► zpull updated weights  [WAN]
        pull response    ──► store; serve parked worker pulls
  worker pull ──► served from store when no round is in flight,
                  else parked (the reference spins on initialized_,
                  ref :1721-1723 — we park event-driven instead)

  GlobalServer: accumulate pushes from local servers; when all
  num_global_workers arrived → run optimizer → respond the parked
  pushes (the ACK is the "update done" signal, ref :1302-1319).
  Async mode (MixedSync): update per push immediately, DCASGD optional
  (ref :1519-1698).

Compression: configured via Ctrl.SET_COMPRESSION like the reference's
kSetGradientCompression; the geomx_tpu_torch.compression codecs apply on the
push-up path (per-key, grouped by codec) and on pull responses
(per-subscriber sparsified deltas / fp16), with unknown types rejected
loudly.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from geomx_tpu_torch.compression.codecs import CodecError
from geomx_tpu_torch.core.config import Config, Group, NodeId, Topology
from geomx_tpu_torch.kvstore.backend import _adopt_or_copy, make_merge_backend
from geomx_tpu_torch.kvstore.common import (APP_PS, Cmd, Ctrl, RecentRequests,
                                      codec_pool, codec_pool_depth,
                                      make_merge_lanes)
from geomx_tpu_torch.native.bindings import accumulate as _native_accumulate
from geomx_tpu_torch.obs.flight import FlightEv, attach_server_pressure
from geomx_tpu_torch.optim import DCASGD, ServerOptimizer, Sgd, make_optimizer
from geomx_tpu_torch.ps import KVPairs, KVServer, KVWorker, Postoffice
from geomx_tpu_torch.ps.postoffice import split_range
from geomx_tpu_torch.trace import context as _tctx
from geomx_tpu_torch.transport.message import Control, Domain, Message


def _ctx_bound(fn):
    """Carry the calling (handler) thread's trace context onto a merge
    lane: a sampled round's merge spans — and the WAN push-up messages
    the lane sends at round completion — must stay children of the
    inbound push, or sharding would sever every cross-node chain.
    Free when tracing is off (returns ``fn`` itself)."""
    if not _tctx.ACTIVE:
        return fn
    ctx = _tctx.current()
    if ctx is None:
        return fn

    def bound():
        prev = _tctx.swap(ctx)
        try:
            fn()
        finally:
            _tctx.restore(prev)

    return bound


def _handle_profiler_cmd(po: Postoffice, msg: Message, server: KVServer):
    """Remote profiler control on a server (ref: GeoMX's
    ProcessServerProfilerCommands kvstore_dist_server.h:409-456 — workers
    configure/start/pause/dump server profilers; dumps are node-prefixed
    like the reference's rank-prefixed filenames)."""
    from geomx_tpu_torch.utils import get_profiler

    p = get_profiler(str(po.node))
    body = msg.body or {}
    action = body.get("action")
    if action == "config":
        p.configure(process_name=body.get("process_name"))
    elif action == "state":
        p.start() if body.get("run") else p.pause()
    elif action == "pause":
        p.pause()
    elif action == "reset":
        p.reset()
    elif action == "dump":
        prefix = body.get("path", "profile")
        safe = str(po.node).replace(":", "_").replace("@", "_")
        p.dump(f"{prefix}.{safe}.json")
    server.reply_cmd(msg, body=p.stats())


def _store_payload(arrs: List[np.ndarray]) -> np.ndarray:
    """Serve stored weights by read-only alias instead of copying.

    In-proc delivery is by reference, so a response must never expose a
    mutable view of live server state.  r3 isolated responses with a
    full copy (~0.27 s per 200 MB response on this single-core host);
    now the server FREEZES the stored array (``writeable=False``) and
    ships it as-is.  The freeze is permanent: every in-place mutation
    path (BSC pull decode is the only one) copies-on-write when it meets
    a frozen array, so any number of in-flight responses may alias the
    frozen buffer safely, and receivers may adopt a frozen payload as
    their own replica without a copy (see ``Message.donated`` for the
    ownership rules of *mutable* payloads)."""
    if len(arrs) == 1 and arrs[0].dtype == np.float32:
        arrs[0].flags.writeable = False  # freeze in place (idempotent)
        return arrs[0]
    # multi-key responses concatenate — the concat IS the isolation
    # copy, so the source arrays stay writeable (freezing them here
    # would buy nothing and force a COW copy on every later in-place
    # decode of those keys).  The sharded LocalServer assembles its
    # multi-key responses per key under each stripe instead of calling
    # this (same one-copy result, tear-safe without the big lock).
    return np.concatenate([np.asarray(a, np.float32) for a in arrs])


class WeightStore(dict):
    """``GlobalServer.store`` — a dict whose raw entries are host
    ndarrays OR device-resident weight handles
    (:class:`geomx_tpu_torch.kvstore.jax_backend.DeviceWeight`, duck-typed by
    "not an ndarray, has .host()").

    Reads through the mapping interface always hand back a host f32
    array: ``store[k]`` / ``.get`` / ``.items()`` materialize a device
    entry on demand (one D2H, cached in the handle until the next
    round close replaces it) — which makes every existing host
    consumer (pull serving, dissemination, checkpoint/replication/
    handoff snapshots, the pull compressor) an explicit
    *materialization event* without touching its code.  Paths that
    must NOT pay a D2H use the raw accessors: ``.values()`` stays raw
    (both entry kinds expose ``.nbytes`` — the stats accounting),
    ``.length(k)`` reads a length without materializing, ``.raw(k)``
    hands the round close the device handle.  Plain host writes
    (``store[k] = arr``) simply replace the handle — the host array
    becomes the truth and the next device round re-adopts it."""

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        if isinstance(v, np.ndarray):
            return v
        return v.host()

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def items(self):
        return [(k, self[k]) for k in self]

    def raw(self, k):
        return dict.__getitem__(self, k)

    def length(self, k) -> int:
        return len(dict.__getitem__(self, k))


def _mutable(arr: np.ndarray) -> np.ndarray:
    """THE gate for in-place mutation of a stored array.

    ``_store_payload`` freezes served arrays permanently
    (``writeable=False``); any path that writes a store entry in place
    must pass it through here first — a frozen array gets a
    copy-on-write, a writeable one passes through.  Writing without
    this gate raises "assignment destination is read-only" at runtime
    (numpy enforces the freeze), so a missed call is loud, but route
    new mutation paths here anyway so the invariant lives in one place.
    Paths that REPLACE a store entry (``store[k] = new_array``, e.g.
    the optimizer result — ``ServerOptimizer.update`` never writes
    ``weight`` in place) need no gate."""
    return arr if arr.flags.writeable else arr.copy()


class _KeyState:
    """Per-ps-key aggregation state on the local server."""

    __slots__ = ("accum", "count", "parked_pulls", "in_flight", "version",
                 "round", "row_sparse", "epoch", "priority", "expected",
                 "completing", "contributors", "hfa_inv")

    def __init__(self):
        self.accum: Optional[np.ndarray] = None
        self.count = 0
        self.parked_pulls: List[Message] = []
        self.in_flight = 0       # rounds between push-up and weights-back.
        #                          A COUNTER, not a bit: back-to-back
        #                          pushes launch overlapping WAN rounds of
        #                          one key, and round r's completion must
        #                          not serve pulls parked behind round r+1
        #                          with stale weights
        self.version = 0         # completed rounds (local or global)
        self.round = 0           # completed aggregation rounds (HFA K2 gate)
        self.row_sparse = False  # merged grad is mostly-zero rows
        self.epoch = 0           # bumped by overwrite-inits: a pull-down
        #                          from before the bump must not clobber
        #                          the restored value of THIS key
        self.expected = None     # workers this key's CURRENT round waits
        #                          for; seeded from the server's join-
        #                          adjusted target at each fresh round
        self.priority = 0        # P3: workers' push priority, inherited by
        #                          this key's WAN push-up and pull-down so
        #                          shallow layers outrank deep ones on the
        #                          server uplinks too (ref: P3_ZPush
        #                          priority propagation kv_app.h:204-259)
        self.contributors: set = set()  # senders in the OPEN round.
        #                          Pulls from NON-contributors are served
        #                          from the last completed round instead
        #                          of parking: a dynamic joiner's
        #                          bootstrap pulls must not wait on
        #                          rounds that can only complete with the
        #                          joiner's own push (advisor r4 high),
        #                          and a lagging worker asking for round
        #                          r while r+1 accumulates wants exactly
        #                          the r weights the store holds
        self.hfa_inv = 0.0       # HFA: Σ num_merge/n_i over this round's
        #                          contributions (each push announces the
        #                          denominator n_i it pre-scaled by).  At
        #                          completion the accumulated Σ w_i/n_i is
        #                          divided by this sum — a convex
        #                          renormalization that keeps the party
        #                          "mean" an actual mean across dynamic
        #                          membership (joiner scaled by new n,
        #                          statics by old n) AND when a leave
        #                          completes a round short (c < n pushes
        #                          would otherwise shrink the weights by
        #                          c/n — catastrophic for weights, unlike
        #                          a scaled gradient)
        self.completing = False  # round completion DECIDED but the
        #                          accumulator not yet taken.  Set under
        #                          _mu at the decision point; both
        #                          completion deciders (push handler,
        #                          leave fold) skip slated keys, so a
        #                          push deciding outside the lock and a
        #                          concurrent leave cannot both run
        #                          _round_complete on one key (the second
        #                          would crash on the taken accumulator)


class LocalServer:
    """Tier-1 aggregator; dual identity: KVServer to its party's workers
    (LOCAL domain) + KVWorker toward the global servers (GLOBAL domain)
    (ref: dual node identity van.h:98, postoffice.cc:40)."""

    def __init__(self, postoffice: Postoffice, config: Optional[Config] = None):
        self.po = postoffice
        self.config = config or postoffice.config
        topo = postoffice.topology
        self.num_workers = topo.workers_per_party
        # dynamic worker join (ref: ADD_NODE van.cc:41-112 — the
        # reference's scheduler assigns ids at runtime; our addressing is
        # plan-based, so the party SERVER owns rank assignment and the
        # aggregation count).  ``_workers_target`` is adopted per key at
        # the next fresh aggregation round (_KeyState.expected), never
        # mid-round.
        self._join_next_rank = topo.workers_per_party
        self._workers_target = self.num_workers
        # out-of-plan members' advertised TCP addresses, rebroadcast so
        # peers/schedulers can dial them (TS relays, ask replies)
        self._member_addrs: Dict[str, tuple] = {}
        # monotone stamp on membership broadcasts: two concurrent
        # join/leave broadcasts can arrive out of order, and the workers'
        # 1/num_workers pre-scale must converge to the LATEST target, not
        # whichever send raced last (advisor r4 low)
        self._membership_seq = 0
        # membership registry, seeded with the STATIC plan's workers so
        # a plan worker can leave too (idempotency: a replayed
        # join/leave must not move the count twice)
        self._members: Dict[str, int] = {
            str(w): w.rank
            for w in topo.workers(postoffice.node.party)}
        # out-of-plan joiners that have not yet pushed ANYTHING: their
        # bootstrap pulls mid-partial-merge are served from the last
        # completed round (parking them behind a round that may need
        # their own push is the advisor-r4 deadlock).  Every OTHER
        # member — plan workers included, whether or not they ever
        # pushed this key directly (under the TS push overlay
        # non-elected workers never do) — PARKS during a TS-merged
        # partial round instead of reading stale (advisor r5, round-5
        # refinement).  GIL-atomic set ops; cleared on first push.
        self._bootstrapping: set = set()
        self.joined_workers = 0  # observability
        self.left_workers = 0
        # heartbeat-driven eviction (kvstore/eviction.py): members the
        # party scheduler declared dead and folded out, mapped to the
        # boot incarnation observed at eviction.  Pushes from an evicted
        # identity are FENCED (error, not accumulated — a zombie's late
        # push would otherwise complete rounds early against the lowered
        # target) until it rejoins through the dynamic-join door, which
        # assigns a fresh rank and lifts the fence.
        self._evicted: Dict[str, int] = {}
        self.evicted_workers = 0
        self.eviction_fenced_pushes = 0
        # gradient hygiene (Config.integrity_push_screen; docs/
        # deployment.md "Data integrity"): every push payload is
        # screened for NaN/Inf (and, under poison_mag_max, magnitude)
        # before it can touch an accumulator.  A poisoned push merges
        # ZERO contribution — it still counts toward round completion,
        # so one faulty worker cannot stall the party barrier — and its
        # sender gets a typed error instead of the ack.  At
        # poison_quarantine_n strikes the sender is folded out through
        # the REVERSIBLE quarantine machinery (rank stashed,
        # incarnation NOT fenced) — quarantine, not eviction: a node
        # whose NaNs came from a transient (bad batch, flaky HBM) heals
        # back in via unquarantine; a truly poisoned one stays folded
        # out without zombie-fence complications.
        self._poison_strikes: Dict[str, int] = {}
        self.integrity_poison_rejects = 0
        self.poison_quarantines = 0
        self.integrity_codec_rejects = 0
        # local-server recovery: REJOIN warm boots served (observability)
        self.warm_boots = 0
        self._rejoin_waiters: List[Message] = []
        self._warm_boot_busy = False
        # graceful preemption drain (Control.PREEMPT_NOTICE): a noticed
        # local server drains its in-flight WAN round, hands its party
        # fold to the global tier proactively (the reversible EVICT
        # fold, so the PR 2 rejoin path brings the replacement back),
        # and tells the recovery monitor the fold already happened.
        # Hook registered only under Config.enable_preempt.
        self.preempt_server_drains = 0
        self.last_drain_s: Optional[float] = None
        self._wan_inflight = 0  # WAN push batches awaiting group acks
        # WAN pull-downs awaiting their answer: the degrade watchdog's
        # other stall (C11: a cut between a batch's acks and its
        # pull-down left nothing in flight, and the party never
        # degraded)
        self._wan_pulls = 0
        self._preempt_waiters: List[Message] = []
        self._preempt_busy = False
        # partition tolerance (Config.enable_partition_mode; docs/
        # deployment.md "Partition tolerance").  Quarantined WORKERS:
        # members the party scheduler folded out reversibly — rank
        # stashed for restore, incarnation NOT fenced.  Quarantined
        # SELF: when this server's own WAN uplink goes dark (a stuck
        # un-ACKed push with no ack progress for the degrade window),
        # it keeps closing party rounds DEGRADED — the merged gradient
        # accumulates into a bounded per-key catch-up delta against
        # FROZEN weights (DC-ASGD compensates the staleness at the
        # merge) — and the heal ships one staleness-stamped Cmd.CATCHUP
        # push instead of discarding the party's progress behind a
        # dense warm boot.
        self._quarantined_members: Dict[str, int] = {}  # node -> rank
        self._partition_mode = bool(self.config.enable_partition_mode)
        self._degraded = False
        self._catchup: Dict[int, np.ndarray] = {}
        self._catchup_rounds = 0
        self._catchup_since: Optional[float] = None
        self._catchup_invalid = False  # HFA rounds push weights, not
        #                                gradients — delta semantics
        #                                break, heal must dense-resync
        self.degraded_rounds = 0
        self.catchup_pushes = 0
        self.catchup_fallbacks = 0
        self._wan_progress_t = time.monotonic()
        self._degrade_window = (
            self.config.partition_degrade_s
            or max(self.config.heartbeat_timeout_s, 1.0))
        self.store: Dict[int, np.ndarray] = {}
        self._keys: Dict[int, _KeyState] = {}
        # key-sharded server state: ``stripe(k)`` guards key k's merge /
        # pull / store entry; ``with self._mu:`` is the all-stripes
        # barrier every membership fold, fence, snapshot and config
        # change takes — their decide-under-lock semantics (PR 1-2) are
        # unchanged.  server_shards=1 (the deterministic default, and
        # the auto default on 1-core hosts) collapses both to the old
        # single server RLock with inline merges.
        # pluggable merge engine for the lanes below (kvstore/backend.py:
        # numpy = the host reference path, jax = staged device merge;
        # deterministic forces numpy).  The lanes themselves are built
        # per-backend — a device backend caps how many can usefully run.
        self._backend = make_merge_backend(self.config,
                                           str(postoffice.node))
        # device-resident WAN codec stage (ISSUE 20): non-None iff the
        # jax backend is active and codec_device resolves on — encode
        # then reads the device merge accumulator directly and the only
        # D2H is the wire-ready compressed payload
        self._codec_stage = self._backend.make_codec_stage(self.config)
        self._mu, self._shards = make_merge_lanes(
            self.config, postoffice.node, self._backend)
        self._ctr_mu = threading.Lock()  # leaf lock for shared counters
        #                                  bumped from parallel lanes
        from geomx_tpu_torch.trace.recorder import get_tracer
        from geomx_tpu_torch.utils import get_profiler

        self._prof = get_profiler(str(postoffice.node))
        self._tr = get_tracer(str(postoffice.node))
        # flight recorder (obs/flight.py): fence/fold/round events +
        # this server's merge-pressure sources; None when disabled
        self._flight = postoffice.flight
        attach_server_pressure(self._flight, self._mu, self._shards)
        if self._flight is not None:
            self._flight.record(FlightEv.MERGE_BACKEND, a=self._mu.n,
                                note=self._backend.name)
        self._recent = RecentRequests()  # replayed-push dedup
        self.server = KVServer(APP_PS, 0, postoffice, self._handle)
        self.server.cmd_handler = self._on_cmd
        postoffice.add_control_hook(self._on_add_node)
        # crash-tolerant membership: forced leaves from the party
        # scheduler's eviction monitor + warm-boot rejoin after a crash
        postoffice.add_control_hook(self._on_evict)
        postoffice.add_control_hook(self._on_rejoin)
        if self.config.enable_preempt:
            postoffice.add_control_hook(self._on_preempt)
        # global-tier failover: the scheduler's NEW_PRIMARY broadcast
        # retargets the up-link and replays un-ACKed WAN requests
        self.failover_events = 0
        self._primary_terms: Dict[int, int] = {}
        postoffice.add_control_hook(self._on_new_primary)
        # warm the axpy-vs-numpy calibration OFF the locked merge path
        from geomx_tpu_torch.native.bindings import calibrate_async

        calibrate_async(self.config.server_merge_threads)
        # the "global worker" half (ref: kvstore_dist_server.h uses the
        # server's own KVWorker toward tier 2)
        self.up = KVWorker(
            APP_PS, 1, postoffice,
            targets=topo.global_servers(),
            key_ranges=split_range(topo.num_global_servers),
            domain=Domain.GLOBAL,
        )
        self.sync_mode = self.config.sync_mode
        # HFA (ref: kvstore_dist_server.h:185-187,1324-1343).  In HFA mode
        # workers push *mean weights* (not gradients); every k2-th round the
        # milestone delta (merged - milestone)/num_global_workers crosses
        # the WAN and is applied additively at tier 2.
        self.hfa_enabled = self.config.use_hfa
        self.hfa_k2 = self.config.hfa_k2
        self._milestone: Dict[int, np.ndarray] = {}
        self._saw_row_sparse = False
        # per-key pull-view version, echoed to the global tier on every
        # pull-down so compressed (BSC) responses can detect a desynced
        # tracked view and resync dense (BroadcastCompressor.compress)
        self._pull_ver: Dict[int, int] = {}
        # per-key weight version of the last APPLIED pull-down ("wv"
        # stamp from GlobalServer._weight_wv); a strictly-older late
        # response is dropped instead of rolling the replica back
        self._weight_ver: Dict[int, int] = {}
        # feature observability (acceptance runs + QUERY_STATS)
        self.hfa_gated_key_rounds = 0  # K2-gated (key, round) pairs
        self.ts_deliveries = 0      # inter-party overlay deliveries adopted
        self.stale_pull_skips = 0   # out-of-order pull responses skipped
        self._esync = None  # EsyncState, lazily built on first Ctrl.ESYNC
        self.compression: dict = {"type": "none"}
        self.push_codec = None  # set by Ctrl.SET_COMPRESSION
        # adaptive WAN control plane (geomx_tpu_torch/control).  This server
        # is the SENDER side of the epoch protocol: SET_WAN_POLICY lands
        # as _policy_pending and is applied atomically at the next WAN
        # round boundary (_push_up_send), every gradient push is stamped
        # with the current epoch, and a receiver's policy fence is
        # answered by re-encoding the stashed raw gradients under the
        # newer policy and retrying.  Off (default): one flag check per
        # round, no stash, no stamping.
        self._adaptive = bool(self.config.adaptive_wan)
        self._policy_epoch = 0
        self._policy_pending: Optional[dict] = None
        self.wan_push_rounds = 0      # WAN push-up batches (controller's
        #                               round-rate signal, via QUERY_STATS)
        self.policy_fence_retries = 0  # fenced pushes re-encoded+retried
        self.policy_drops = 0          # fence retries abandoned (loud)
        if self._adaptive:
            self._policy_stash: Dict[int, dict] = {}  # up-ts -> entry
            self.up.error_handler = self._on_up_error
        # TSEngine intra-party dissemination (ref: DefaultAutoPull
        # kvstore_dist_server.h:1368-1384)
        self.ts_client = None
        self._ts_iter = 0
        if self.config.enable_intra_ts:
            from geomx_tpu_torch.sched.tsengine import TsClient

            self.ts_client = TsClient(
                postoffice, topo.scheduler(postoffice.node.party))
        # inter-party TSEngine: the WAN pull-down is replaced by overlay
        # dissemination from the global servers; this client relays onward
        # to sibling local servers (ref: inter-DC TS — server-side
        # WorkersMerge/AutoPullUpdate, kvstore_dist_server.h:228-310)
        self.ts_inter = None
        if self.config.enable_inter_ts:
            from geomx_tpu_torch.sched.tsengine import TsClient

            self.ts_inter = TsClient(
                postoffice, topo.global_scheduler(), domain=Domain.GLOBAL)
        # inter-party push overlay: pair-merge party gradients over the
        # WAN before one elected server pushes up (ref: global ASK_PUSH
        # van.cc:1254-1310; server-side WorkersMerge :228-310)
        self.ts_push_inter = None
        self._inter_push_round: Dict[int, int] = {}
        if self.config.enable_inter_ts_push:
            import queue as _queue

            from geomx_tpu_torch.sched.ts_push import TsPushWorker

            self.ts_push_inter = TsPushWorker(
                postoffice, topo.global_scheduler(), self.up,
                domain=Domain.GLOBAL)
            # merging blocks on WAN round-trips (ask → maybe wait for a
            # peer's grads); it must run OFF the KVServer handler thread,
            # which processes the incoming relays themselves
            self._merge_q: "_queue.Queue" = _queue.Queue()
            threading.Thread(target=self._inter_merge_loop, daemon=True,
                             name=f"inter-merge-{postoffice.node}").start()
        # WAN-silence watchdog (partition mode only): detects this
        # server's OWN partition — a push-up whose group acks stopped
        # arriving — and flips to degraded-mode rounds so the party
        # keeps training instead of wedging on the dead uplink
        self._degrade_ticker = None
        if self._partition_mode:
            from geomx_tpu_torch.transport.reactor import Periodic

            self._degrade_ticker = Periodic(
                max(self._degrade_window / 4.0, 0.05),
                self._degrade_sweep,
                name=f"degrade-watchdog-{postoffice.node}",
                reactor=getattr(postoffice.van.fabric, "reactor", None))

    # ---- request handling ---------------------------------------------------
    def _handle(self, msg: Message, kvs: Optional[KVPairs], server: KVServer):
        prof = self._prof
        if msg.cmd == Cmd.INIT:
            with prof.span("local.init"):
                self._handle_init(msg, kvs)
        elif msg.cmd == Cmd.ROW_SPARSE_PUSH:
            with prof.span("local.push_rs"):
                self._handle_push_row_sparse(msg, kvs)
        elif msg.cmd == Cmd.ROW_SPARSE_PULL:
            with prof.span("local.pull_rs"):
                self._try_serve_pull(msg)
        elif msg.cmd == Cmd.TS_AUTOPULL:
            with prof.span("local.ts_inter"):
                self._on_inter_ts_delivery(msg, kvs)
        elif self.ts_push_inter is not None and self._is_merge_relay(msg):
            # a peer local server's contribution for the push overlay —
            # routed here because the KVServer owns the PS app id
            self.ts_push_inter._on_merge_msg(msg)
        elif msg.push:
            # the tracer span nests inside the profiler span: same
            # buffer, but the tracer one carries the causal ids and is
            # gated on the round's sampling, not on profiler.running
            with prof.span("local.push"), self._tr.span("local.push"):
                self._handle_push(msg, kvs)
            if prof.running:
                prof.count("push_bytes", float(msg.nbytes))
        elif msg.pull:
            with prof.span("local.pull"), self._tr.span("local.pull"):
                self._handle_pull(msg, kvs)

    def _handle_init(self, msg: Message, kvs: KVPairs):
        # program order vs. the sharded merge: an overwrite-INIT that
        # arrived after earlier pushes must not be applied while those
        # pushes still sit queued on merge lanes (they would merge into
        # the restored state); quiesce the lanes first
        self._shards.drain()
        # replay dedup: a replayed overwrite-init re-applied after
        # training resumed would silently revert the store (plain init
        # replay was idempotent; overwrite replay is destructive)
        state = self._recent.check(msg)
        if state == "pending":
            return
        if state == "done":
            self.server.response(msg, body=self._recent.done_body(msg))
            return
        overwrite = bool(isinstance(msg.body, dict)
                         and msg.body.get("overwrite"))
        with self._mu:
            fresh = []
            for k, v in kvs.slices():
                if k not in self.store or overwrite:
                    self.store[k] = np.array(v, copy=True)
                    self._milestone[k] = np.array(v, copy=True)
                    st = self._keys.setdefault(k, _KeyState())
                    if overwrite:
                        # abort THIS key's in-flight round: drop the
                        # aggregation state, and invalidate any pull-down
                        # still in flight for the old weights (epoch)
                        st.accum = None
                        st.count = 0
                        st.in_flight = 0
                        st.epoch += 1
                        # the global tier rebuilds its pull compressor on
                        # overwrite (tracked vers → 0) with this value as
                        # the INIT base; echo 0 re-enters the
                        # sparse-from-INIT path consistently
                        self._pull_ver[k] = 0
                        self._weight_ver.pop(k, None)
                    fresh.append((k, v))
            # pulls that raced ahead of init can be servable now
            for k, _ in fresh:
                self._drain_parked_locked(self._keys[k])
        if fresh:
            # forward first-seen (or overwritten) inits up; ack the
            # worker once tier 2 has them
            ks = np.array([k for k, _ in fresh], dtype=np.int64)
            vals = np.concatenate([v for _, v in fresh])
            lens = np.array([len(v) for _, v in fresh], dtype=np.int64)
            def ack():
                self._recent.mark_done(msg)
                self.server.response(msg)

            self.up.zpush(
                KVPairs(ks, vals, lens), cmd=Cmd.INIT,
                on_complete=ack,
                body=msg.body if overwrite else None,
            )
        else:
            self._recent.mark_done(msg)
            self.server.response(msg)

    def _on_add_node(self, msg: Message) -> bool:
        """Dynamic worker join (ref: ProcessAddNodeCommandAtScheduler
        van.cc:41-112).  A new worker registers mid-training; the server
        assigns the next free rank and raises the aggregation target,
        which every key adopts at its NEXT fresh round (open rounds'
        targets are raised too, so a racing static push can't complete
        them early).  The joiner's bootstrap pulls are safe because
        pulls from non-contributors are served from the last completed
        round (_try_serve_pull_locked) — they never park behind rounds
        that only the joiner's own push can complete.  Works under the
        intra-party TS overlay (the membership broadcast updates the
        schedulers' member sets) and under HFA (the per-push ``hfa_n``
        denominator lets the round renormalize a mixed-scale weight
        mean; see _KeyState.hfa_inv) — the reference's ADD_NODE is
        likewise uniform across modes (van.cc:41-112)."""
        if msg.control is not Control.ADD_NODE or not msg.request:
            return False
        body = msg.body or {}
        node_s = str(body.get("node", msg.sender))
        if body.get("action") == "leave":
            # graceful leave (the inverse fold): the worker promises no
            # further pushes.  Mid-flight rounds get their target
            # lowered; ones already satisfied complete NOW — they would
            # otherwise stall forever waiting for the leaver.  Honest
            # caveat: counting has no per-worker attribution, so if the
            # leaver HAD contributed to a mid-flight round, one later
            # push leaks into the next round (one stale gradient, the
            # same staleness class the async tier tolerates).
            with self._mu:
                if self._fold_member_out_locked(node_s):
                    self.left_workers += 1
                # replayed leave (or never-joined): idempotent no-op —
                # the reply still carries the current (total, seq) pair
                total = self._workers_target
                seq = self._membership_seq
            self._broadcast_membership()
            # the reply carries the SAME (total, seq) pair as broadcasts
            # — the client applies it through the same stale-guard, so a
            # reply built before a racing membership change cannot roll
            # the pre-scale back after the newer broadcast landed
            self.po.van.send(msg.reply_to(control=Control.ADD_NODE, body={
                "num_workers": total, "seq": seq,
                "token": body.get("token")}))
            return True
        with self._mu:
            # a rejoin through the join door lifts the eviction fence —
            # the node re-enters the count under a FRESH rank (its old
            # membership entry was deleted at eviction), so there is no
            # double count to fear
            self._evicted.pop(node_s, None)
            if node_s in self._members:
                # replayed join (client retry after a lost reply): same
                # rank, no double count
                rank = self._members[node_s]
                total = self._workers_target
                seq = self._membership_seq
            else:
                rank = self._join_next_rank
                self._join_next_rank += 1
                self._workers_target += 1
                self._membership_seq += 1
                self._members[node_s] = rank
                total = self._workers_target
                seq = self._membership_seq
                self.joined_workers += 1
                # until its first push lands, this joiner's pulls are
                # BOOTSTRAP pulls: served from the last completed round
                # even mid-partial-merge (see _try_serve_pull)
                self._bootstrapping.add(node_s)
                # mid-flight rounds must ALSO wait for the joiner: its
                # first pushes land in whatever round is open, and with
                # the old target a static worker's push would complete
                # the round early and leak a contribution forward.  The
                # joiner's own BOOTSTRAP pulls do not park behind those
                # now-waiting rounds — _try_serve_pull_locked serves
                # non-contributors from the last completed round, which
                # is what breaks the advisor-r4 join deadlock (pull
                # before first push).  Honest transition caveat:
                # contributions already in the open round were
                # pre-scaled by the OLD 1/num_workers, the joiner's by
                # the new one, so that single round's applied update is
                # up to (1 + 1/old_n - 1/new_n)x the true mean — the
                # same one-round transient class as the leave-side push
                # leak and async staleness
                for st in self._keys.values():
                    if (st.accum is not None and st.expected
                            and not st.completing):
                        st.expected += 1
        # TCP deployments announce the joiner's bind address alongside;
        # add_address inserts the OUT-OF-PLAN slot (update_address would
        # ignore an unknown node as a stale broadcast, so it is no
        # fallback here).  The address is also recorded for membership
        # broadcasts: under the TS overlay PEERS relay to the joiner and
        # the SCHEDULER replies to its asks, so every party node's
        # fabric needs the out-of-plan slot, not just this server's
        if "host" in body and "node" in body:
            addr = (body["host"], int(body["port"]))
            with self._mu:
                self._member_addrs[str(body["node"])] = addr
            add = getattr(self.po.van.fabric, "add_address", None)
            if add is not None:
                add(body["node"], addr)
        self._broadcast_membership()
        # seq rides the reply for the same reason as on leave replies
        self.po.van.send(msg.reply_to(control=Control.ADD_NODE, body={
            "rank": rank, "num_workers": total, "seq": seq,
            "token": body.get("token")}))
        return True

    def _fold_member_out_locked(self, node_s: str) -> bool:
        """Remove ``node_s`` from the aggregation group and fold
        mid-flight rounds down to the survivor set: lower each open
        round's target, complete rounds the fold made decidable (they
        would otherwise stall forever waiting for the gone member).
        The shared core of graceful leave and heartbeat eviction.
        Caller holds ``_mu``; returns False for a non-member (replayed
        leave / double eviction)."""
        if node_s not in self._members:
            return False
        del self._members[node_s]
        self._member_addrs.pop(node_s, None)
        self._bootstrapping.discard(node_s)
        # ESync planner hygiene: forget the departed worker's step/comm
        # estimates — a slow leaver's stale step_s would otherwise stay
        # in the max reach-time target forever, permanently inflating
        # every survivor's assignment (the fold IS the replan trigger;
        # a joiner is seeded at min_steps until its first report)
        if self._esync is not None:
            self._esync.drop(node_s)
        if self._flight is not None:
            self._flight.record(FlightEv.FOLD, peer=node_s,
                                note="member_fold")
        self._workers_target = max(1, self._workers_target - 1)
        self._membership_seq += 1
        completed = []
        for k, st in self._keys.items():
            if st.accum is not None and st.expected:
                st.expected = max(1, st.expected - 1)
                if st.count >= st.expected and not st.completing:
                    st.completing = True
                    completed.append(k)
        if completed:
            # complete UNDER the lock (RLock re-entry); keys a
            # concurrent push already slated (st.completing) were
            # skipped above — without the flag both paths would
            # run _round_complete for one key and the second
            # would crash on the already-taken accumulator
            self._round_complete(completed)
        return True

    def _on_evict(self, msg: Message) -> bool:
        """Control.EVICT from the party scheduler's eviction monitor: a
        worker's heartbeats expired, so synthesize the leave it never
        sent (same fold as a graceful leave), then FENCE the evicted
        identity — the scheduler recorded the corpse's last ``boot``
        incarnation, and any later push from it (zombie resume, or a
        silent restart that skipped the join door) is rejected with a
        rejoin hint instead of corrupting the lowered round counts.
        ``join_party`` lifts the fence with a fresh rank.  Idempotent."""
        if msg.control is not Control.EVICT or not msg.request:
            return False
        body = msg.body if isinstance(msg.body, dict) else {}
        action = body.get("action")
        if action in ("quarantine", "unquarantine") and "node" in body:
            return self._on_quarantine(msg, body, action)
        if "node" not in body or action:
            return False  # party_fold/unfold belong to the global tier
        node_s = str(body["node"])
        boot = int(body.get("boot", 0))
        with self._mu:
            folded = self._fold_member_out_locked(node_s)
            if folded:
                self.evicted_workers += 1
            self._evicted.setdefault(node_s, boot)
            # a quarantine that escalated to an eviction: the reversible
            # fold already happened, the fence above makes it final
            self._quarantined_members.pop(node_s, None)
            total = self._workers_target
        if folded:
            from geomx_tpu_torch.utils.metrics import system_counter

            system_counter(f"{self.po.node}.evicted_workers").inc()
            print(f"{self.po.node}: evicted {node_s} (forced leave, "
                  f"boot={boot}) — pushes fenced until it rejoins",
                  flush=True)
            self._broadcast_membership()
        self.po.van.send(msg.reply_to(control=Control.EVICT, body={
            "evicted": folded, "num_workers": total,
            "token": body.get("token")}))
        return True

    def _on_quarantine(self, msg: Message, body: dict, action: str) -> bool:
        """Control.EVICT {action: quarantine|unquarantine} from the
        party scheduler's monitor: the member is unreachable from the
        scheduler but an indirect probe still hears it — fold it out of
        round targets REVERSIBLY (its rank is stashed, its incarnation
        is NOT fenced; a LAN-reachable quarantined member's pushes
        still accumulate, at worst completing a lowered-target round
        early) and restore it verbatim when heartbeats resume.
        Idempotent both ways."""
        node_s = str(body["node"])
        with self._mu:
            if action == "quarantine":
                rank = self._members.get(node_s)
                changed = self._fold_member_out_locked(node_s)
                if changed and rank is not None:
                    self._quarantined_members[node_s] = rank
                ok = changed or node_s in self._quarantined_members
            else:
                rank = self._quarantined_members.pop(node_s, None)
                changed = (rank is not None
                           and node_s not in self._members)
                if changed:
                    self._members[node_s] = rank
                    self._workers_target += 1
                    self._membership_seq += 1
                ok = changed or node_s in self._members
            total = self._workers_target
        if changed:
            if self._flight is not None:
                self._flight.record(FlightEv.NETFAULT, peer=node_s,
                                    note=f"member_{action}")
            print(f"{self.po.node}: {action}d {node_s} — "
                  f"{total} workers count toward fresh rounds, "
                  "incarnation not fenced", flush=True)
            self._broadcast_membership()
        self.po.van.send(msg.reply_to(control=Control.EVICT, body={
            "ok": ok, "num_workers": total,
            "token": body.get("token")}))
        return True

    def _fence_evicted_push(self, msg: Message, sender_s: str) -> bool:
        """Reject a push from an evicted identity (caller already passed
        the replay-dedup check, so pre-eviction pushes re-ack normally).
        Returns True when the push was fenced and answered.

        Lock-free fast path: membership transitions are rare, dict
        lookups are GIL-atomic, and a push racing an eviction lands as
        if ordered before or after it either way — only a positive
        sighting re-checks under the barrier (the all-stripes
        acquisition here per push would otherwise re-serialize the
        sharded merge)."""
        if sender_s not in self._evicted or sender_s in self._members:
            return False
        with self._mu:
            if sender_s not in self._evicted or sender_s in self._members:
                return False
            boot = self._evicted[sender_s]
            self.eviction_fenced_pushes += 1
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.eviction_fenced_pushes").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.FENCE, d=boot, peer=sender_s,
                                note="evicted_push")
        err = {"error": f"evicted: {sender_s} was declared dead "
                        f"(boot={boot}) and folded out of the "
                        "aggregation group; rejoin via join_party for a "
                        "fresh rank"}
        self._recent.mark_done(msg, err)
        self.server.response(msg, body=err)
        return True

    def _poison_strike(self, sender_s: str) -> dict:
        """Record one poison strike against ``sender_s``; quarantine it
        (reversible fold, PR-16 machinery) once the strike count
        crosses ``poison_quarantine_n``.  Returns the typed error body
        the push's ack path sends instead of a clean ack."""
        quarantined = False
        with self._mu:
            self.integrity_poison_rejects += 1
            strikes = self._poison_strikes.get(sender_s, 0) + 1
            self._poison_strikes[sender_s] = strikes
            n = self.config.poison_quarantine_n
            if n and strikes >= n and sender_s in self._members:
                rank = self._members.get(sender_s)
                if self._fold_member_out_locked(sender_s):
                    if rank is not None:
                        self._quarantined_members[sender_s] = rank
                    self.poison_quarantines += 1
                    quarantined = True
            quarantined_total = len(self._quarantined_members)
        from geomx_tpu_torch.utils.metrics import system_counter, system_gauge

        system_counter(f"{self.po.node}.integrity_poison_rejects").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.CORRUPT, a=strikes,
                                peer=sender_s, note="poison_push")
        if quarantined:
            system_counter(f"{self.po.node}.poison_quarantines").inc()
            system_gauge(f"{self.po.node}.quarantined_nodes").set(
                quarantined_total)
            if self._flight is not None:
                self._flight.record(FlightEv.CORRUPT, a=strikes,
                                    peer=sender_s,
                                    note="poison_quarantine")
            print(f"{self.po.node}: quarantined {sender_s} after "
                  f"{strikes} poisoned pushes — folded out reversibly, "
                  "unquarantine heals it back in", flush=True)
            self._broadcast_membership()
        return {"error": f"poisoned push rejected: payload failed the "
                         f"finiteness/magnitude screen (strike "
                         f"{strikes}); contribution zeroed"
                         + (", sender quarantined" if quarantined
                            else "")}

    def _screen_push(self, msg: Message, kvs: KVPairs) -> KVPairs:
        """Gradient-hygiene gate on the push ingest path (one fused
        backend reduction; the jax backend syncs a single device
        scalar).  A clean payload passes through untouched; a poisoned
        one is replaced with zeros — zero contribution keeps the sync
        round's completion accounting intact — and the typed error body
        rides to the ack via ``msg._gx_poisoned``."""
        if not self.config.integrity_push_screen:
            return kvs
        if self._backend.screen_finite(kvs.vals,
                                       self.config.poison_mag_max):
            return kvs
        msg._gx_poisoned = self._poison_strike(str(msg.sender))
        return KVPairs(kvs.keys, np.zeros(len(kvs.vals), np.float32),
                       kvs.lens)

    def _on_rejoin(self, msg: Message) -> bool:
        """Control.REJOIN request from the global scheduler's recovery
        monitor: this (replacement or revived) local server must adopt
        the global tier's current model state before its party folds
        back into global rounds.  The pull blocks on WAN round-trips, so
        it runs off the hook thread; the reply is sent on completion —
        the monitor retries until it hears one, and retries while a boot
        is in flight just queue behind it (idempotent)."""
        if msg.control is not Control.REJOIN or not msg.request:
            return False
        with self._mu:
            self._rejoin_waiters.append(msg)
            if self._warm_boot_busy:
                return True
            self._warm_boot_busy = True
        threading.Thread(target=self._warm_boot_thread, daemon=True,
                         name=f"warm-boot-{self.po.node}").start()
        return True

    def _warm_boot_thread(self):
        mode = "dense"
        try:
            n = None
            if self._partition_mode and (self._degraded or self._catchup
                                         or self._catchup_rounds):
                # this process SURVIVED the partition with live state — a
                # bounded catch-up delta re-merges it; a genuinely crashed
                # replacement has neither flag set and dense-boots below
                n = self._ship_catchup()
                if n is not None:
                    mode = "catchup"
            if n is None:
                n = self.warm_boot()
            ok = True
        except Exception:
            import logging

            logging.getLogger(__name__).exception(
                "%s: warm boot failed", self.po.node)
            n, ok = 0, False
        with self._mu:
            waiters, self._rejoin_waiters = self._rejoin_waiters, []
            self._warm_boot_busy = False
        for m in waiters:
            try:
                self.po.van.send(m.reply_to(control=Control.REJOIN, body={
                    "ok": ok, "keys": n, "mode": mode,
                    "token": (m.body or {}).get("token")}))
            except (KeyError, OSError):
                pass  # the monitor re-asks

    def warm_boot(self) -> int:
        """Adopt the global tier's full model state: ask each shard for
        its hosted key set (Ctrl.LIST_KEYS), pull those keys DENSE (a
        fresh replica has no view for a compressed delta to apply to),
        and install them — aborting any stale in-flight aggregation
        state (a revived zombie's open rounds refer to a world that
        moved on).  Returns the number of keys adopted."""
        self._shards.drain()  # stale pre-crash merges must not land on
        #                       the adopted state
        keys = set()
        for gs in list(self.up.targets):
            # retried + timeout-bounded: control commands have no
            # replay layer, and a RELAUNCHED process's first sends can
            # race the peers' stale half-open conns to its dead
            # predecessor — a reply lost to a broken-then-redialed
            # socket would wedge the warm boot (and with it every
            # queued REJOIN) forever.  LIST_KEYS is read-only, so the
            # re-send is harmless; the fresh send also forces the
            # fabric's redial to the live incarnation.
            reply = None
            for _ in range(8):
                ts = self.up.send_cmd(gs, Ctrl.LIST_KEYS,
                                      domain=Domain.GLOBAL, wait=False)
                try:
                    self.up.customer.wait(ts, timeout=2.5)
                    reply = self.up.cmd_response(ts)
                    break
                except TimeoutError:
                    continue
            if reply is None:
                # this shard is dark (mid-failover?) — adopt what the
                # others have; the monitor's next sweep re-warm-boots
                continue
            keys.update(int(k) for k in reply.get("keys", ()))
        got: Dict[int, np.ndarray] = {}
        if keys:
            def adopt(kvs):
                for k, v in kvs.slices():
                    got[int(k)] = np.array(v, dtype=np.float32, copy=True)

            self.up.zpull(sorted(keys), cb=adopt, wait=True,
                          body={"dense": True})
        with self._mu:
            for k, v in got.items():
                self.store[k] = v
                self._milestone[k] = np.array(v, copy=True)
                st = self._keys.setdefault(k, _KeyState())
                st.accum = None
                st.count = 0
                st.in_flight = 0
                st.completing = False
                st.contributors = set()
                st.hfa_inv = 0.0
                st.epoch += 1  # invalidate pre-crash pull-downs
                # the global tier's tracked subscriber view (BSC) no
                # longer matches this replica; -1 never equals a tracked
                # version, so the next compressed pull resyncs dense
                self._pull_ver[k] = -1
                # the global tier may have restarted too — accept any
                # weight-version stamp after a warm boot
                self._weight_ver.pop(k, None)
                self._drain_parked_locked(st)
            self.warm_boots += 1
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.warm_boots").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.WARM_BOOT, a=len(got))
        # re-sync the party's 1/num_workers pre-scale and membership (a
        # replacement process restarted the count at the static plan)
        self._broadcast_membership()
        print(f"{self.po.node}: warm boot adopted {len(got)} keys from "
              "the global tier", flush=True)
        return len(got)

    # ---- degraded-mode rounds & catch-up (partition tolerance) -------------
    def _degrade_sweep(self):
        """Periodic watchdog (partition mode only): a WAN push batch
        whose group acks have made no progress for the degrade window
        means the uplink is dark — switch to degraded rounds instead of
        letting every subsequent party round wedge behind it."""
        if self._degraded or not self._partition_mode:
            return
        with self._ctr_mu:
            inflight = self._wan_inflight + self._wan_pulls
            last = self._wan_progress_t
        if (inflight > 0
                and time.monotonic() - last > self._degrade_window
                and self._wan_heartbeat_silent()):
            self._enter_degraded()

    def _wan_heartbeat_silent(self) -> bool:
        """Second opinion before degrading: a stalled WAN push ack can
        be LEGITIMATE (a sync-mode global round parks this party's push
        until every other party contributes), but a genuinely dark
        uplink also starves this server's own heartbeat echoes from the
        global scheduler — require both before abandoning the round.
        Heartbeats off → no echo evidence either way → the ack stall
        alone decides."""
        if self.config.heartbeat_interval_s <= 0:
            return True
        age = self.po.heartbeat_echo_age(
            self.po.topology.global_scheduler())
        return age > self._degrade_window

    def _enter_degraded(self):
        """Abandon the stuck WAN round(s) and start accumulating.  The
        stuck keys' epochs are bumped FIRST so a late pull-down from the
        abandoned batch (delivered after a partial partition heals)
        cannot clobber weights the degraded rounds moved past; the
        merged-but-unacked push gradients are NOT folded into the
        catch-up delta — the van's replay layer re-delivers the push
        itself once the fabric heals (request_retry_s > 0), and
        double-counting them here would apply them twice."""
        with self._mu:
            if self._degraded:
                return
            self._degraded = True
            self._catchup_since = time.monotonic()
            stuck = [k for k, st in self._keys.items()
                     if st.in_flight > 0]
            for k in stuck:
                self._keys[k].epoch += 1
        while True:
            open_keys = []
            with self._mu:
                open_keys = [k for k in stuck
                             if self._keys[k].in_flight > 0]
            if not open_keys:
                break
            self._finish_round(open_keys)
        with self._ctr_mu:
            self._wan_inflight = 0  # abandoned; the ack-side clamp
            #                         absorbs any late arrivals
            self._wan_pulls = 0
        if self._flight is not None:
            self._flight.record(FlightEv.NETFAULT, a=len(stuck),
                                note="netfault_degraded")
        print(f"{self.po.node}: entered degraded mode — WAN uplink "
              f"silent for {self._degrade_window:.1f}s, party rounds "
              "continue against frozen weights and accumulate a "
              "catch-up delta", flush=True)

    def _host_kvs(self, kvs: KVPairs) -> KVPairs:
        """Materialize a device-resident round for the host fallback
        paths (degraded absorb, anything that does numpy arithmetic on
        the values) — billed by the codec stage as a codec host copy
        so the steady-state zero-host-traffic contract stays auditable.
        The identity for host rounds."""
        if (self._codec_stage is None
                or not self._codec_stage.is_device(kvs.vals)):
            return kvs
        return KVPairs(kvs.keys, self._codec_stage.to_host(kvs.vals),
                       kvs.lens)

    def _make_push_codec(self, body: dict):
        """Build the push codec for a SET_COMPRESSION / WAN-policy body:
        the device family when the codec stage is active (encode reads
        the device accumulator, ships wire-identical frames), else the
        numpy reference.  Both raise ValueError on malformed bodies."""
        from geomx_tpu_torch.compression import make_push_codec

        if self._codec_stage is not None:
            return self._codec_stage.make_push_codec(body)
        return make_push_codec(body)

    def _absorb_degraded_round(self, kvs: KVPairs, keys: List[int]):
        """A party round completed while the WAN uplink is dark: fold
        the merged gradient into the bounded per-key catch-up delta and
        close the round against the frozen weights.  Under HFA the
        push-up carries party-mean WEIGHTS, not a gradient — summing
        those is meaningless, so the accumulator is poisoned and the
        heal falls back to a dense resync."""
        with self._ctr_mu:
            self.degraded_rounds += 1
            self._catchup_rounds += 1
            rounds = self._catchup_rounds
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.degraded_rounds").inc()
        if self.hfa_enabled:
            self._catchup_invalid = True
        else:
            with self._mu:
                for k, v in kvs.slices():
                    k = int(k)
                    prev = self._catchup.get(k)
                    if prev is None:
                        self._catchup[k] = np.array(v, dtype=np.float32,
                                                    copy=True)
                    else:
                        prev += v.astype(np.float32)
        if self._flight is not None:
            self._flight.record(FlightEv.ROUND_COMPLETE, a=len(keys),
                                b=rounds, note="degraded")
        self._finish_round(keys)

    def _ship_catchup(self) -> Optional[int]:
        """Heal path (REJOIN with surviving state): ship the
        accumulated delta as ONE staleness-stamped Cmd.CATCHUP push —
        the global tier merges it through the normal optimizer path
        (DC-ASGD compensates the staleness) — and return the key
        count.  Returns None when the delta is not trustworthy (HFA
        rounds, or more degraded rounds than
        Config.partition_catchup_bound): the caller dense-boots
        instead.  Fresh weights are NOT pulled here; the next normal
        round's pull-down refreshes them as ordinary training traffic,
        which is what keeps the heal cost at a fraction of a dense
        resync."""
        with self._mu:
            delta = self._catchup
            rounds = self._catchup_rounds
            since = self._catchup_since
            invalid = self._catchup_invalid
            self._catchup = {}
            self._catchup_rounds = 0
            self._catchup_since = None
            self._catchup_invalid = False
            self._degraded = False  # cleared BEFORE shipping so the
            #                         catch-up push is not diverted
        if not delta and rounds == 0:
            return 0
        bound = int(self.config.partition_catchup_bound)
        from geomx_tpu_torch.utils.metrics import system_counter

        if invalid or rounds > bound:
            self.catchup_fallbacks += 1
            system_counter(
                f"{self.po.node}.partition_catchup_fallbacks").inc()
            if self._flight is not None:
                self._flight.record(FlightEv.NETFAULT, a=len(delta),
                                    b=rounds,
                                    note="netfault_catchup_fallback")
            why = ("HFA weight-mean rounds" if invalid else
                   f"{rounds} degraded rounds > bound {bound}")
            print(f"{self.po.node}: catch-up delta not trustworthy "
                  f"({why}) — dense resync instead", flush=True)
            return None
        ks = sorted(delta)
        kvs = KVPairs(np.array(ks, dtype=np.int64),
                      np.concatenate([delta[k] for k in ks]),
                      np.array([len(delta[k]) for k in ks],
                               dtype=np.int64))
        age = time.monotonic() - since if since is not None else 0.0
        body = {"catchup": {"rounds": rounds, "age_s": round(age, 3)}}
        groups = self._encode_wan_groups(kvs)
        remaining = [len(groups)]
        done = threading.Event()
        lock = threading.Lock()

        def acked():
            with lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    done.set()

        for tag, pairs in groups.items():
            ks2 = np.array([k for k, _ in pairs], dtype=np.int64)
            vals2 = (pairs[0][1] if len(pairs) == 1
                     else np.concatenate([p for _, p in pairs]))
            lens2 = np.array([len(p) for _, p in pairs], dtype=np.int64)
            self.up.zpush(KVPairs(ks2, vals2, lens2), cmd=Cmd.CATCHUP,
                          on_complete=acked, compr=tag, body=dict(body),
                          donated=True)
        if not done.wait(60.0):
            raise TimeoutError(
                f"{self.po.node}: catch-up push not acked; the "
                "recovery monitor re-asks")
        self.catchup_pushes += 1
        system_counter(f"{self.po.node}.partition_catchup_pushes").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.NETFAULT, a=len(ks), b=rounds,
                                note="netfault_catchup_push")
        print(f"{self.po.node}: healed — shipped catch-up delta "
              f"({len(ks)} keys, {rounds} degraded rounds, "
              f"{age:.1f}s stale); fresh weights ride the next round's "
              "pull-down", flush=True)
        return len(ks)

    def _on_preempt(self, msg: Message) -> bool:
        """Control.PREEMPT_NOTICE request: this local server's host is
        about to be preempted.  Drain off the hook thread (the fold
        RPCs block on WAN round trips); repeat notices queue behind the
        running drain like REJOIN retries do and are answered when it
        finishes."""
        if msg.control is not Control.PREEMPT_NOTICE or not msg.request:
            return False
        with self._mu:
            self._preempt_waiters.append(msg)
            if self._preempt_busy:
                return True
            self._preempt_busy = True
        threading.Thread(target=self._preempt_thread, daemon=True,
                         name=f"preempt-drain-{self.po.node}").start()
        return True

    def _preempt_thread(self):
        try:
            self.preempt_drain()
            ok = True
        except Exception:
            import logging

            logging.getLogger(__name__).exception(
                "%s: preempt drain failed (the eviction path covers "
                "the crash)", self.po.node)
            ok = False
        with self._mu:
            waiters, self._preempt_waiters = self._preempt_waiters, []
            self._preempt_busy = False
        for m in waiters:
            try:
                self.po.van.send(m.reply_to(
                    control=Control.PREEMPT_NOTICE, body={
                        "ok": ok, "drain_s": self.last_drain_s,
                        "node": str(self.po.node),
                        "token": (m.body or {}).get("token")}))
            except (KeyError, OSError):
                pass  # the notifier vanished; the drain still happened

    def preempt_drain(self, timeout: Optional[float] = None) -> float:
        """Graceful spot-preemption drain: let the in-flight WAN push
        round flush its acks, then hand this party's fold to the global
        tier PROACTIVELY (the reversible ``party_fold`` — the same fold
        the recovery monitor would synthesize a heartbeat-timeout
        later) and tell the recovery monitor the fold happened, so the
        replacement's resumed heartbeats drive the normal warm-boot /
        unfold / worker-replay rejoin.  Returns the drain seconds."""
        import uuid

        t0 = time.monotonic()
        budget = timeout if timeout is not None \
            else self.config.preempt_drain_s
        deadline = t0 + budget
        # 1. flush: wait for open WAN push batches to collect their acks
        #    (bounded — a dark global tier must not eat the whole notice)
        while time.monotonic() < deadline:
            with self._ctr_mu:
                inflight = self._wan_inflight
            if inflight <= 0:
                break
            time.sleep(0.02)
        # 2. reversible fold at every shard's CURRENT holder (the
        #    up-link targets track NEW_PRIMARY retargets)
        node_s = str(self.po.node)
        for gs in list(self.up.targets):
            token = f"{node_s}#{uuid.uuid4().hex[:8]}"
            cv = threading.Condition()
            reply: dict = {}

            def hook(m, _token=token, _cv=cv, _reply=reply) -> bool:
                b = m.body if isinstance(m.body, dict) else {}
                if (m.control is Control.EVICT and not m.request
                        and b.get("token") == _token):
                    with _cv:
                        _reply.update(b)
                        _cv.notify_all()
                    return True
                return False

            self.po.add_control_hook(hook)
            try:
                for _ in range(3):
                    try:
                        self.po.van.send(Message(
                            recipient=gs, control=Control.EVICT,
                            domain=Domain.GLOBAL, request=True,
                            body={"action": "party_fold", "node": node_s,
                                  "token": token}))
                    except (KeyError, OSError):
                        pass  # shard dark — the eviction path covers it
                    with cv:
                        if cv.wait_for(lambda: bool(reply), timeout=max(
                                0.1, min(2.0, deadline
                                         - time.monotonic()))):
                            break
            finally:
                self.po.remove_control_hook(hook)
        # 3. arm the rejoin path: the recovery monitor records the fold
        #    (with our boot incarnation) so the REPLACEMENT's resumed
        #    heartbeats trigger warm boot + unfold + worker replay
        try:
            self.po.van.send(Message(
                recipient=self.po.topology.global_scheduler(),
                control=Control.PREEMPT_NOTICE, domain=Domain.GLOBAL,
                request=False,
                body={"event": "server_drained", "node": node_s,
                      "party": self.po.node.party,
                      "boot": self.po.van.boot}))
        except (KeyError, OSError):
            pass  # monitor dark: heartbeat expiry re-folds idempotently
        self.last_drain_s = round(time.monotonic() - t0, 4)
        self.preempt_server_drains += 1
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.preempt_server_drains").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.FOLD,
                                a=int(self.last_drain_s * 1e6),
                                peer=node_s, note="preempt_drain")
        print(f"{self.po.node}: preempt drain complete — party handed "
              f"to the global tier in {self.last_drain_s:.3f}s "
              "(workers park until the replacement rejoins)", flush=True)
        return self.last_drain_s

    def _on_new_primary(self, msg: Message) -> bool:
        """Global-tier failover (Control.NEW_PRIMARY from the global
        scheduler): shard ``rank``'s primary died and its hot standby
        was promoted under ``term``.  Retarget the up-link worker and
        REPLAY its un-ACKed requests against the new primary
        (KVWorker.retarget) — the standby's replicated replay-dedup
        window keeps the replay exactly-once.  Term-guarded per shard:
        rebroadcasts and out-of-order duplicates are no-ops."""
        if msg.control is not Control.NEW_PRIMARY or msg.request:
            return False
        b = msg.body if isinstance(msg.body, dict) else {}
        rank, term = int(b.get("rank", -1)), int(b.get("term", 0))
        with self._mu:
            if term <= self._primary_terms.get(rank, 0):
                return True  # stale or repeated broadcast
            self._primary_terms[rank] = term
        replayed = self.up.retarget(NodeId.parse(b["old"]),
                                    NodeId.parse(b["new"]))
        self.failover_events += 1
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.failover_events").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.PROMOTE, a=term, c=replayed,
                                peer=b.get("new"), note="retarget")
        print(f"{self.po.node}: global shard {rank} failed over to "
              f"{b['new']} (term={term}, replayed={replayed} requests)",
              flush=True)
        return True

    def _broadcast_membership(self):
        """Tell every party worker the new aggregation size — their
        1/num_workers gradient pre-scale must track membership or the
        post-join update stops being a mean (static plan workers +
        joined members).  The (total, seq) pair is read atomically under
        ``_mu``: concurrent join/leave broadcasts may be sent out of
        order, and the client hook drops any stamp older than one it has
        applied, so the pre-scale converges to the server's latest
        target rather than whichever send raced last."""
        with self._mu:
            total = self._workers_target
            seq = self._membership_seq
            extra = list(self._members)
            addrs = {n: list(a) for n, a in self._member_addrs.items()
                     if n in self._members}
        targets = {str(w): w for w in self.po.topology.workers(
            self.po.node.party)}
        for n in extra:
            targets.setdefault(n, NodeId.parse(n))
        # the party scheduler tracks membership too: the TS overlay's
        # dissemination targets and the push-pairing "holder has all"
        # threshold live there (TsScheduler/TsPushScheduler hooks)
        sched = self.po.topology.scheduler(self.po.node.party)
        body = {"event": "membership", "num_workers": total, "seq": seq,
                "members": sorted(extra), "addrs": addrs}
        for n in list(targets.values()) + [sched]:
            try:
                self.po.van.send(Message(
                    recipient=n, control=Control.ADD_NODE,
                    domain=Domain.LOCAL, request=False, body=body))
            except (KeyError, OSError):
                pass  # a down/unknown worker learns on its next join

    def _handle_push(self, msg: Message, kvs: KVPairs):
        state = self._recent.check(msg)
        if state == "pending":
            return  # replay of a push we're still aggregating
        if state == "done":
            # already applied; the ACK (or piggybacked values) was lost
            if msg.pull:
                self._try_serve_pull(msg)
            else:
                self.server.response(msg, body=self._recent.done_body(msg))
            return
        sender_s = str(msg.sender)
        if self._fence_evicted_push(msg, sender_s):
            return  # evicted identity: rejected, told to rejoin
        # first push from a dynamic joiner: it is established now — its
        # later pulls park during partial merges like everyone else's
        self._bootstrapping.discard(sender_s)
        kvs = self._screen_push(msg, kvs)
        # a TS-merged push carries several workers' contributions at once
        # (ref: num_merge counting van.cc:1197-1252)
        num_merge = 1
        if isinstance(msg.body, dict):
            num_merge = int(msg.body.get("num_merge", 1))
        hfa_n = None
        if self.hfa_enabled:
            # each HFA push announces the denominator it pre-scaled its
            # weights by; missing (old client) = assume current target
            hfa_n = float((msg.body or {}).get("hfa_n",
                                               self._workers_target))
        slices = list(kvs.slices())
        if not slices:
            self._recent.mark_done(msg)
            self.server.response(msg)
            return
        # key-sharded merge: each key's accumulate runs on its stripe's
        # serial lane, so per-key arrival order is preserved while
        # pushes touching disjoint keys merge in parallel.  The ack —
        # and any completed rounds — dispatch from whichever lane
        # finishes the message's last slice (ordering vs. the parked
        # piggyback pull is identical to the single-lock path).  With
        # server_shards=1 the lanes are inline and this is bit-for-bit
        # the old serial handler.
        pending = [len(slices)]
        bundles: List[dict] = []
        done_mu = threading.Lock()

        def merge_one(k: int, v: np.ndarray):
            bundle = None
            with self._mu.stripe(k):
                st = self._keys.setdefault(k, _KeyState())
                st.contributors.add(sender_s)
                if hfa_n:
                    st.hfa_inv += num_merge / hfa_n
                if st.accum is None:
                    st.accum = self._backend.seed(v, msg.donated, key=k)
                    # fold joins in at the round boundary
                    st.expected = self._workers_target
                else:
                    st.accum = self._backend.accumulate(st.accum, v)
                st.count += num_merge
                st.priority = msg.priority
                if (self.sync_mode
                        and st.count >= (st.expected or self.num_workers)
                        and not st.completing):
                    # take-at-decide, still under the stripe: detaching
                    # the accumulator AT the decision point closes the
                    # decide→retake window a parallel lane could
                    # otherwise merge the next round's gradient into
                    bundle = self._take_completed_locked(k)
            with done_mu:
                if bundle is not None:
                    bundles.append(bundle)
                pending[0] -= 1
                last = pending[0] == 0
            if last:
                self._push_merged(msg, kvs, bundles)

        for k, v in slices:
            self._shards.submit(k, _ctx_bound(lambda k=k, v=v: merge_one(k, v)))

    def _push_merged(self, msg: Message, kvs: KVPairs,
                     bundles: List[dict]):
        """Post-merge step of one push message, on the lane that
        finished its last slice: ack (or park the piggyback pull), then
        dispatch any rounds the message completed.  Runs with no
        stripes held."""
        poisoned = getattr(msg, "_gx_poisoned", None)
        if not self.sync_mode:
            # async local tier: no rounds — clear the aggregation state
            # FIRST (the accumulate lanes raised st.count, which blocks
            # pull serving), then serve any piggybacked pull from the
            # current store and forward the push upward immediately
            with self._mu:
                for k in kvs.keys:
                    st = self._keys[int(k)]
                    st.accum = None
                    st.count = 0
                    st.in_flight = 0
                    st.completing = False  # no round to complete async
                    st.contributors.clear()
                    st.hfa_inv = 0.0
                if msg.pull and poisoned is None:
                    self._try_serve_pull(msg)
            if poisoned is not None:
                # typed reject in place of the ack (the piggyback pull
                # gets the error too, like a fence); nothing useful to
                # forward — the payload was zeroed
                self._recent.mark_done(msg, poisoned)
                self.server.response(msg, body=poisoned)
                return
            if not msg.pull:
                self._recent.mark_done(msg)
                self.server.response(msg)
            self._push_up(KVPairs(kvs.keys, kvs.vals.astype(np.float32),
                                  kvs.lens))
            return
        if poisoned is not None:
            # sync tier: the zeroed contribution already counted toward
            # the round barrier on the lanes; the sender is told loudly
            # instead of acked (a piggyback pull is NOT parked — the
            # error rides the push response, exactly like a fence)
            self._recent.mark_done(msg, poisoned)
            self.server.response(msg, body=poisoned)
        elif msg.pull:
            # P3 piggyback: the push response carries the updated values
            # once the round completes (ref: server replies with values in
            # the push-response when enable_p3, kvstore_dist_server.h:
            # 1149-1165,1255-1267) — park it like a pull
            k0 = int(msg.keys[0])
            with self._mu.stripe(k0):
                self._keys[k0].parked_pulls.append(msg)
        else:
            # ack the push immediately — workers overlap next layers
            self._recent.mark_done(msg)
            self.server.response(msg)
        if bundles:
            self._dispatch_rounds(bundles)

    def _handle_push_row_sparse(self, msg: Message, kvs: KVPairs):
        """Scatter-accumulate active rows; the merged round rides the
        push-up path, sparsified for the WAN when that is smaller
        (ref: row-sparse server merge kvstore_dist_server.h row_sparse
        handlers).  The client rejects HFA×row-sparse, but guard here too
        — adopting a gradient sum as HFA weights would corrupt training."""
        from geomx_tpu_torch.compression import codecs as codecs_mod
        from geomx_tpu_torch.compression.codecs import unpack_rows

        state = self._recent.check(msg)
        if state == "pending":
            return
        if state == "done":
            self.server.response(msg, body=self._recent.done_body(msg))
            return
        if self._fence_evicted_push(msg, str(msg.sender)):
            return  # evicted identity: rejected, told to rejoin
        if self.hfa_enabled:
            # reject with an error body the client surfaces on wait_all()
            # — a bare ACK would let training silently diverge
            err = {"error": "row-sparse push rejected: server is in HFA mode"}
            self._recent.mark_done(msg, err)
            self.server.response(msg, body=err)
            return
        cols = int(msg.body["rs_cols"])
        key = int(kvs.keys[0])
        try:
            row_ids, rows = unpack_rows(kvs.vals, cols)
            # bounds BEFORE the merge lane: a corrupt negative row id
            # would silently wrap through np.add.at into the wrong row
            with self._mu.stripe(key):
                nrows = (len(self.store[key]) // cols
                         if key in self.store and cols else None)
            if nrows is not None:
                codecs_mod._check_index_bounds(row_ids, nrows, "rows", key)
        except codecs_mod.CodecError as e:
            self.integrity_codec_rejects += 1
            from geomx_tpu_torch.utils.metrics import system_counter

            system_counter(f"{self.po.node}.integrity_codec_rejects").inc()
            if self._flight is not None:
                self._flight.record(FlightEv.CORRUPT, peer=msg.sender,
                                    note="corrupt_codec_payload")
            err = {"error": f"row-sparse push rejected before merge: {e}"}
            self._recent.mark_done(msg, err)
            self.server.response(msg, body=err)
            return
        sender_s = str(msg.sender)
        self._bootstrapping.discard(sender_s)
        self._saw_row_sparse = True
        # gradient hygiene on the unpacked rows only — the packed
        # row-id halves are bit-cast integers and may legitimately look
        # non-finite as floats
        if (self.config.integrity_push_screen
                and not self._backend.screen_finite(
                    rows, self.config.poison_mag_max)):
            msg._gx_poisoned = self._poison_strike(sender_s)
            rows = np.zeros_like(rows)

        # rides the key's merge lane like every other mutation of this
        # key, so row-sparse and dense pushes of one key keep their
        # arrival order under sharding
        def merge_rs():
            if not self.sync_mode:
                # async: no accumulation round — densify once and forward
                with self._mu:
                    st = self._keys.setdefault(key, _KeyState())
                    st.in_flight = 0
                    dense = np.zeros_like(self.store[key], dtype=np.float32)
                    np.add.at(dense.reshape(-1, cols), row_ids, rows)
                    self._drain_parked_locked(st)
                err = getattr(msg, "_gx_poisoned", None)
                self._recent.mark_done(msg, err)
                self.server.response(msg, body=err)
                if err is None:
                    self._push_up(KVPairs(
                        kvs.keys, dense,
                        np.array([len(dense)], np.int64)),
                        rs_keys={key})
                return
            bundle = None
            with self._mu.stripe(key):
                st = self._keys.setdefault(key, _KeyState())
                st.contributors.add(sender_s)
                if st.accum is None:
                    st.accum = np.zeros_like(self.store[key],
                                             dtype=np.float32)
                    st.expected = self._workers_target
                else:
                    # a dense push may have seeded this key on a device
                    # backend; the scatter-add is host-side by design
                    st.accum = self._backend.materialize(st.accum)
                np.add.at(st.accum.reshape(-1, cols), row_ids, rows)
                st.count += 1
                st.row_sparse = True
                if (st.count >= (st.expected or self.num_workers)
                        and not st.completing):
                    bundle = self._take_completed_locked(key)
            err = getattr(msg, "_gx_poisoned", None)
            self._recent.mark_done(msg, err)
            self.server.response(msg, body=err)
            if bundle is not None:
                self._dispatch_rounds([bundle])

        self._shards.submit(key, _ctx_bound(merge_rs))

    def _on_inter_ts_delivery(self, msg: Message, kvs: KVPairs):
        """Updated weights arrived via the WAN overlay instead of a pull
        (inter-party TSEngine): adopt them, confirm delivery, and relay
        onward to sibling local servers.  Under the sync tier a delivery
        IS the round completion, so it finishes the round; under the
        async tier rounds complete via the push ACK instead, and a
        delivery decoupled from any round must only refresh the replica
        — force-finishing would break the intra-party BSP barrier
        (serving parked pulls before every party worker pushed)."""
        it = str(msg.body["iter"])
        with self._mu:
            self.ts_deliveries += 1
            for k, v in kvs.slices():
                # fp16 relay payloads decode back to f32 replicas
                self.store[k] = np.asarray(v, dtype=np.float32).copy()
            if self.config.sync_global_mode:
                self._finish_round([int(k) for k in kvs.keys
                                    if int(k) in self._keys])
        self.ts_inter.send_reply(msg.sender, it)
        self.ts_inter.disseminate_async(msg.keys, msg.vals, msg.lens, it,
                                        Cmd.TS_AUTOPULL)

    def _take_completed_locked(self, k: int) -> dict:
        """Detach key ``k``'s completed round (caller holds stripe(k);
        completion was just decided).  Bumps the round counter, applies
        the HFA convex renormalization — accum = Σ w_i/n_i with
        possibly-mixed n_i (membership transition) or count < n (leave
        completed the round short): dividing by Σ 1/n_i keeps the
        result a weighted MEAN of weight vectors, never
        scale-inflated/shrunk — resets the per-round state, and returns
        the round bundle :meth:`_dispatch_rounds` ships."""
        st = self._keys[k]
        st.round += 1
        gated = self.hfa_enabled and st.round % self.hfa_k2 != 0
        if gated:
            with self._ctr_mu:
                self.hfa_gated_key_rounds += 1
        if (self.hfa_enabled and st.hfa_inv > 0.0
                and abs(st.hfa_inv - 1.0) > 1e-9):
            st.accum = self._backend.scale(st.accum, 1.0 / st.hfa_inv)
        # device-resident handoff (ISSUE 20): when a device push codec
        # will consume this round, skip the host materialization — the
        # encoder reads the device accumulator and the only D2H is the
        # compressed wire payload.  Every path that still needs host
        # bytes is excluded here: HFA (local applies + weight pushes),
        # row-sparse rounds (host-seeded scatter), the inter-TS merge
        # relay, adaptive WAN (raw host stash for fence retries), and a
        # dark uplink (degraded absorb; re-checked race-safely in
        # _push_up_send via _host_kvs).
        keep_device = (self._codec_stage is not None
                       and getattr(self.push_codec, "device", False)
                       and not gated and not st.row_sparse
                       and not self.hfa_enabled
                       and self.ts_push_inter is None
                       and not self._adaptive and not self._degraded
                       and not isinstance(st.accum, np.ndarray))
        v = (self._codec_stage.round_value(st.accum) if keep_device
             else self._backend.materialize(st.accum))
        bundle = {"k": k, "v": v, "gated": gated, "rs": st.row_sparse}
        st.hfa_inv = 0.0
        st.accum = None
        st.count = 0
        st.completing = False  # slate consumed; next round may be
        #                        decided again
        st.contributors = set()
        st.in_flight += 1  # round launched; finish decrements
        st.row_sparse = False  # describes this round only
        return bundle

    def _dispatch_rounds(self, bundles: List[dict]):
        """Ship completed rounds whose accumulators were already
        detached at the decision point.  HFA: each key counts its own
        aggregation rounds; only every k2-th round of a key crosses the
        WAN (ref: kvstore_dist_server.h:1324-1343).  Runs with no
        stripes held (or under the all-stripes barrier on the fold
        path)."""
        bundles = sorted(bundles, key=lambda b: b["k"])
        rs_keys = {b["k"] for b in bundles if b["rs"] and not b["gated"]}

        def pack(bs):
            vs = [b["v"] for b in bs]
            # single-key rounds (the big-tensor regime) hand the
            # accumulator over as-is — concatenate([one]) is a full
            # copy (~0.27 s at 200 MB on this host)
            if len(vs) == 1:
                vals = vs[0]
            elif (self._codec_stage is not None
                  and any(self._codec_stage.is_device(v) for v in vs)):
                # device rounds stay device: np.concatenate would
                # silently round-trip every value through the host
                vals = self._codec_stage.concat(vs)
            else:
                vals = np.concatenate(vs)
            return KVPairs(np.array([b["k"] for b in bs], dtype=np.int64),
                           vals,
                           np.array([len(v) for v in vs], dtype=np.int64))

        local = [b for b in bundles if b["gated"]]
        up = [b for b in bundles if not b["gated"]]
        if local:
            self._apply_local(pack(local))
        if up:
            kvs_up = pack(up)
            if self.hfa_enabled:
                self._push_up_hfa(kvs_up)
            elif rs_keys:
                self._push_up(kvs_up, rs_keys=rs_keys)
            else:
                self._push_up(kvs_up)

    def _round_complete(self, keys: List[int]):
        """Complete rounds already decided for ``keys`` — the
        membership-fold path (caller holds the all-stripes barrier, so
        the per-key takes below just re-enter their stripes)."""
        self._dispatch_rounds(
            [self._take_completed_locked(k) for k in sorted(keys)])

    def _apply_local(self, kvs: KVPairs):
        """HFA off-round: the merged push is already the party-mean weight
        vector (workers push weight/num_workers, ref: examples/cnn_hfa.py) —
        adopt it and serve pulls without touching the WAN."""
        for k, v in kvs.slices():
            with self._mu.stripe(k):
                self.store[k] = np.array(v, copy=True)
        self._finish_round([int(k) for k in kvs.keys])

    @staticmethod
    def _is_merge_relay(msg: Message) -> bool:
        from geomx_tpu_torch.sched.ts_push import TS_PUSH_MERGE_CMD

        return msg.cmd == TS_PUSH_MERGE_CMD

    def _inter_merge_loop(self):
        """Dispatch per-key inter-party merges, each on its own thread.

        Concurrency is load-bearing, not an optimization: parties'
        rounds complete in different key orders, so ANY cap below the
        number of keys in flight can fill with disjoint key sets across
        parties and head-of-line-deadlock (the reason a bounded pool is
        wrong here).  Threads are bounded naturally by the model's key
        count — each key has at most one merge in flight because rounds
        of one key complete serially.  Per-key round tokens route each
        thread's scheduler replies and relays (ref: the per-key ASK_PUSH
        pairing of the global scheduler, van.cc:1254-1310)."""

        def one_key(k: int, v: np.ndarray, rs: bool, token: str):
            res = self.ts_push_inter.merge_push(
                {k: np.asarray(v, np.float32)}, it=token)
            if res is not None:
                # elected (or degraded-to-direct on overlay failure) —
                # push with however many contributions we actually hold;
                # the global server accumulates counts across pushes
                merged, nm = res
                self._push_up_send(
                    KVPairs(np.array([k], dtype=np.int64), merged[k],
                            np.array([len(merged[k])], dtype=np.int64)),
                    frozenset({k}) if rs else frozenset(),
                    {"num_merge": nm})

        while True:
            job = self._merge_q.get()
            if job is None:
                return
            kvs, rs_keys = job
            for k, v in kvs.slices():
                r = self._inter_push_round.get(k, 0) + 1
                self._inter_push_round[k] = r
                threading.Thread(
                    target=one_key, args=(k, v.copy(), k in rs_keys,
                                          f"{k}:{r}"),
                    daemon=True, name=f"inter-merge-{self.po.node}-{k}",
                ).start()

    def _push_up(self, kvs: KVPairs, rs_keys=frozenset()):
        if self.ts_push_inter is not None:
            # hand off to the merge thread (blocking WAN round-trips must
            # not stall the handler thread that feeds the merge relays)
            self._merge_q.put((kvs, rs_keys))
            return
        self._push_up_send(kvs, rs_keys, None)

    def _push_up_send(self, kvs: KVPairs, rs_keys=frozenset(),
                      push_body=None):
        keys = [int(k) for k in kvs.keys]
        if self._degraded:
            # the WAN uplink is dark (partition mode): the round stays
            # in the party — accumulate the merged gradient into the
            # catch-up delta and finish against the frozen weights.
            # A device-resident round materializes here (the absorb is
            # host arithmetic by design; _degraded may have flipped
            # after the round-close decision kept it on device).
            self._absorb_degraded_round(self._host_kvs(kvs), keys)
            return
        if self._prof.running:
            self._prof.count("wan_rounds", 1.0)
        raw = None
        if self._adaptive:
            with self._mu:
                # the WAN round boundary: a pending policy applies HERE,
                # so the whole batch below is encoded under one epoch
                self._apply_policy_locked()
            # stash the raw merged gradients until the round is acked —
            # a receiver's policy fence is answered by re-encoding them
            # under the newer codec (one extra copy per round, paid only
            # with adaptive WAN on)
            raw = {int(k): np.array(v, copy=True) for k, v in kvs.slices()}
        with self._ctr_mu:  # rounds of disjoint keys dispatch from
            self.wan_push_rounds += 1  # parallel lanes
            wan_round = self.wan_push_rounds
            if self._wan_inflight == 0:
                # degrade watchdog: the window opens at the FIRST
                # outstanding batch only — later dispatches piling up
                # behind a dark uplink must not keep resetting it
                self._wan_progress_t = time.monotonic()
            self._wan_inflight += 1  # decremented when the batch's
            #                          groups are all acked (the
            #                          preempt drain waits on zero)
        if self._flight is not None:
            # the WAN round boundary: the stall forensic's "this party
            # pushed up and is now owed a pull-down"
            self._flight.record(FlightEv.ROUND_OPEN, a=wan_round,
                                c=len(keys), note="wan_push")

        with self._mu:
            epochs = {k: self._keys[k].epoch for k in keys
                      if k in self._keys}
            # P3: the WAN hops inherit the workers' per-layer priority
            prio = max((self._keys[k].priority for k in keys
                        if k in self._keys), default=0)

        def pull_down():
            # all global shards applied the update → pull fresh weights
            # (ref: DataHandlePushResponseDefault :941-957).  Under
            # inter-party TS the overlay delivers them instead.
            if self.ts_inter is not None:
                if not self.config.sync_global_mode:
                    # async tier: the overlay disseminates at its own
                    # (rate-limited) pace — finish the round from the
                    # current replica instead of gating on a delivery
                    self._finish_round(keys)
                return
            self.up.zpull(keys, cb=self._wan_pull_opened(epochs),
                          priority=prio, body=self._pull_echo(keys))

        # group keys by wire codec so each message has a uniform payload
        # dtype + compr tag (ref: PushCompressed kvstore_dist.h:530-563)
        groups = self._encode_wan_groups(kvs, rs_keys)
        # P3 piggyback on the WAN tier: combined push_pull saves the
        # per-round ack -> pull-request chain (2 messages + 2 latencies
        # per key per round); the global server replies with the updated
        # values once the round completes.  Not combinable with the
        # inter-TS overlay (which replaces the pull-down entirely),
        # merged pushes (num_merge body), or the adaptive epoch
        # protocol (a fenced piggyback would eat the pull's response
        # slot; the split push + pull path retries cleanly).
        use_piggyback = (self.config.enable_p3 and push_body is None
                         and self.ts_inter is None and not self._adaptive)
        if use_piggyback:
            # the piggybacked round has no separate push-ack chain; the
            # drain's flush reading can't observe it — release now
            with self._ctr_mu:
                self._wan_inflight -= 1
            for tag, pairs in groups.items():
                ks = np.array([k for k, _ in pairs], dtype=np.int64)
                vals = (pairs[0][1] if len(pairs) == 1
                        else np.concatenate([p for _, p in pairs]))
                lens = np.array([len(p) for _, p in pairs], dtype=np.int64)
                self.up.push_pull(
                    KVPairs(ks, vals, lens), cmd=Cmd.DEFAULT,
                    cb=self._wan_pull_opened(epochs),
                    compr=tag, priority=prio, donated=True,
                    body=self._pull_echo([int(k) for k in ks]))
            return

        remaining = [len(groups)]
        lock = threading.Lock()

        def one_group_acked():
            with lock:
                remaining[0] -= 1
                done = remaining[0] == 0
            with self._ctr_mu:
                # every group ack is WAN progress for the degrade
                # watchdog; the clamp absorbs acks from batches a
                # degrade entry already abandoned
                self._wan_progress_t = time.monotonic()
                if done:
                    self._wan_inflight = max(0, self._wan_inflight - 1)
            if done:
                pull_down()

        for tag, pairs in groups.items():
            self._send_wan_group(tag, pairs, one_group_acked, push_body,
                                 prio, rs_keys, raw)

    def _wan_pull_opened(self, epochs: dict):
        """Count a WAN pull-down as outstanding for the degrade watchdog
        (C11); returns its answer's callback, which uncounts it (the
        clamp absorbs answers to pulls a degrade entry abandoned) and
        finishes the round."""
        with self._ctr_mu:
            self._wan_pulls += 1

        def landed(kvs):
            with self._ctr_mu:
                self._wan_pulls = max(0, self._wan_pulls - 1)
                self._wan_progress_t = time.monotonic()
            self._on_pull_down(kvs, epochs)
        return landed

    def _encode_wan_groups(self, kvs: KVPairs,
                           rs_keys=frozenset()) -> Dict[str, list]:
        """Group a push-up batch by wire codec (shared by the round path
        and the adaptive fence-retry re-encode).

        Multi-key batches fan the per-key compress calls across the
        shared codec pool (sized like ``server_merge_threads``) instead
        of encoding serially on the round-completion thread; codec
        SELECTION stays serial (MPQ's pick counters), and per-key codec
        state (residuals, velocities) is key-partitioned so parallel
        keys never share an entry.  Single-key rounds (the big-tensor
        regime) and 1-lane hosts keep the exact serial path."""
        groups: Dict[str, list] = {}
        if self.push_codec is None:
            # uncompressed mode — except row-sparse rounds, whose merged
            # gradient is mostly zeros: ship [values ‖ indices] when
            # that is smaller (the WAN half of the row-sparse path)
            from geomx_tpu_torch.compression.codecs import pack_sparse

            for k, v in kvs.slices():
                if int(k) in rs_keys:
                    idx = np.nonzero(v)[0]
                    if 2 * len(idx) < len(v):
                        groups.setdefault("bsc", []).append(
                            (k, pack_sparse(v[idx], idx)))
                        continue
                groups.setdefault("", []).append((k, v))
            return groups
        from geomx_tpu_torch.compression import MpqSelector

        sel = [(k, v, (self.push_codec.select(len(v))
                       if isinstance(self.push_codec, MpqSelector)
                       else self.push_codec)) for k, v in kvs.slices()]
        pool = codec_pool(self.config) if len(sel) > 1 else None
        with self._tr.span("codec.encode"):
            if pool is None:
                enc = [(k, c.name, c.compress(k, v)) for k, v, c in sel]
            else:
                futs = [pool.submit(c.compress, k, v) for k, v, c in sel]
                enc = [(k, c.name, f.result())
                       for (k, v, c), f in zip(sel, futs)]
        for k, name, payload in enc:
            groups.setdefault(name, []).append((k, payload))
        return groups

    def _send_wan_group(self, tag: str, pairs: list, done_cb,
                        push_body, prio: int, rs_keys, raw,
                        attempts: int = 0):
        """Push one codec group up.  Under adaptive WAN the push is
        stamped with the current policy epoch and stashed so a receiver
        fence can re-encode + retry it; ``done_cb`` fires exactly once —
        on the successful (possibly retried) ack, or on a loudly-logged
        give-up."""
        ks = np.array([k for k, _ in pairs], dtype=np.int64)
        vals = (pairs[0][1] if len(pairs) == 1
                else np.concatenate([p for _, p in pairs]))
        lens = np.array([len(p) for _, p in pairs], dtype=np.int64)
        kvp = KVPairs(ks, vals, lens)
        if not self._adaptive:
            # donated: every push-up payload is server-owned (the round's
            # aggregation buffer, a codec output, or a fresh delta) and
            # never touched again — the receiving tier may adopt it
            self.up.zpush(kvp, cmd=Cmd.DEFAULT, on_complete=done_cb,
                          compr=tag, body=push_body, priority=prio,
                          donated=True)
            return
        # a retried "" (vanilla) payload IS the stashed raw copy — the
        # receiver must not adopt+mutate the buffer a further retry may
        # need, so only first sends donate it
        donate = not (tag == "" and attempts > 0)
        ent = {"raw": {int(k): raw[int(k)] for k, _ in pairs},
               "rs": frozenset(rs_keys), "body": push_body, "prio": prio,
               "done": done_cb, "attempts": attempts, "fenced": False,
               "ts": None}

        def guard():
            # ordering contract: the fence error-handler runs BEFORE the
            # completion fires (same response-processing thread), so
            # "fenced" is authoritative here; a fenced ack means the
            # retry owns done_cb now
            with self._mu:
                fenced = ent["fenced"]
                ent["fenced"] = False
                if not fenced:
                    self._policy_stash.pop(ent["ts"], None)
            if not fenced:
                done_cb()

        # hold the lock across send + stash insert: the response (and
        # with it the fence handler / guard) can race zpush's return,
        # and both take this lock before touching the stash
        with self._mu:
            ts = self.up.zpush(kvp, cmd=Cmd.DEFAULT, on_complete=guard,
                               compr=tag, body=push_body, priority=prio,
                               donated=donate,
                               policy_epoch=self._policy_epoch)
            ent["ts"] = ts
            self._policy_stash[ts] = ent

    # ---- adaptive WAN: policy application + fence retry ---------------------
    def _on_set_wan_policy(self, msg: Message, body: dict):
        """Ctrl.SET_WAN_POLICY from the controller (sender side): store
        as pending; the next WAN round boundary applies it atomically.
        Constraint-gated by the SAME predicate as static config."""
        if not self._adaptive:
            self.server.reply_cmd(msg, body={
                "error": "adaptive WAN is disabled on this server "
                         "(Config.adaptive_wan / --adaptive-wan)"})
            return
        from geomx_tpu_torch.compression import compression_allowed

        comp = dict(body.get("compression") or {})
        ok, why = compression_allowed(
            comp.get("type", "none"),
            inter_ts=self.config.enable_inter_ts, hfa=self.hfa_enabled)
        if not ok:
            self.server.reply_cmd(msg, body={"error": why})
            return
        with self._mu:
            epoch = int(body.get("epoch", 0))
            if epoch > self._policy_epoch and (
                    self._policy_pending is None
                    or epoch > int(self._policy_pending["epoch"])):
                self._policy_pending = {"epoch": epoch,
                                        "compression": comp}
            cur = self._policy_epoch
        self.server.reply_cmd(msg, body={"epoch": cur, "pending": epoch})

    def _apply_policy_locked(self):
        """Install a pending SET_WAN_POLICY (caller holds ``_mu``).
        Replacing the push codec drops its residual/velocity state by
        design — the unsent mass belongs to the old epoch's stream."""
        p = self._policy_pending
        if p is None:
            return
        self._policy_pending = None
        epoch = int(p["epoch"])
        if epoch <= self._policy_epoch:
            return  # stale (an older broadcast raced a fence adoption)
        comp = dict(p["compression"])
        try:
            codec = self._make_push_codec(comp)
        except ValueError:
            import logging

            logging.getLogger(__name__).error(
                "%s: refusing malformed WAN policy %r", self.po.node, comp)
            return
        self.push_codec = codec
        self.compression = comp
        self._policy_epoch = epoch
        from geomx_tpu_torch.utils.metrics import system_gauge

        system_gauge(f"{self.po.node}.wan_policy_epoch").set(epoch)
        self._tr.instant("wanpolicy.apply", epoch=epoch,
                         codec=comp.get("type"))
        print(f"{self.po.node}: WAN policy epoch {epoch} applied at "
              f"round boundary -> {comp.get('type')}", flush=True)

    def _on_up_error(self, msg: Message) -> bool:
        """KVWorker error hook on the up-link: turn a receiver's policy
        fence into re-encode + retry.  Returns True when the error is
        fully handled here (it never reaches ``up.errors``)."""
        b = msg.body if isinstance(msg.body, dict) else {}
        if not b.get("policy_fenced"):
            return False
        retry = None
        with self._mu:
            # self-healing: the fence reply names the receiver's current
            # policy — adopt it NOW (this round must be re-encoded under
            # it anyway) even if the SET_WAN_POLICY broadcast was lost
            ep = int(b.get("policy_epoch", 0))
            comp = b.get("policy")
            adopted = comp is not None and ep > self._policy_epoch
            if adopted:
                self._policy_pending = {"epoch": ep, "compression": comp}
                self._apply_policy_locked()
            ent = self._policy_stash.pop(msg.timestamp, None)
            if ent is not None:
                self.policy_fence_retries += 1
                if ent["attempts"] < self.config.policy_fence_max_retries:
                    ent["fenced"] = True  # guard defers done to the retry
                    retry = ent
                else:
                    # give up LOUDLY: guard fires done_cb so the round
                    # completes; this round's gradient for these keys is
                    # dropped — the same staleness class as an async-tier
                    # lost push, and far better than a wedged FSA round
                    self.policy_drops += 1
                    import logging

                    logging.getLogger(__name__).error(
                        "%s: dropping WAN push after %d policy-fence "
                        "retries (keys %s)", self.po.node,
                        ent["attempts"], sorted(ent["raw"]))
        if ent is None:
            return False  # not ours (already handled / unknown ts)
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.policy_fence_retries").inc()
        if retry is not None:
            if adopted or ep >= self._policy_epoch:
                self._repush_fenced(retry)
            else:
                # the RECEIVER is the stale side (a promoted standby the
                # controller has not reached yet): back off so its
                # rebroadcast can land before the retry budget burns
                t = threading.Timer(0.1 * (retry["attempts"] + 1),
                                    self._repush_fenced, args=(retry,))
                t.daemon = True
                t.start()
        return True

    def _repush_fenced(self, ent: dict):
        """Re-encode a fenced group's stashed raw gradients under the
        (now-adopted) policy and push again.  The new policy may split
        the keys into different codec groups (MPQ), so the original
        ``done`` fires once ALL sub-groups ack."""
        raw = ent["raw"]
        ks = sorted(raw)
        vals = [raw[k] for k in ks]
        kvp = KVPairs(np.array(ks, dtype=np.int64),
                      vals[0] if len(vals) == 1 else np.concatenate(vals),
                      np.array([len(v) for v in vals], dtype=np.int64))
        groups = self._encode_wan_groups(kvp, ent["rs"])
        remaining = [len(groups)]
        lock = threading.Lock()

        def sub_done():
            with lock:
                remaining[0] -= 1
                fire = remaining[0] == 0
            if fire:
                ent["done"]()

        for tag, pairs in groups.items():
            self._send_wan_group(tag, pairs, sub_done, ent["body"],
                                 ent["prio"], ent["rs"], raw,
                                 attempts=ent["attempts"] + 1)

    def _push_up_hfa(self, kvs: KVPairs):
        """K2 round: ship (mean_weights - milestone)/num_global_workers
        (ref: milestone delta :1324-1343).

        The matching pull-down requests full (dense) weights — the local
        store was just replaced by the party mean, so it has diverged from
        any pull-compressor's tracked subscriber view; a sparse delta
        against that view would corrupt the replica."""
        topo = self.po.topology
        ks, vs, ls = [], [], []
        for k, v in kvs.slices():
            with self._mu.stripe(k):
                self.store[k] = np.array(v, copy=True)  # adopt party mean
                delta = (v - self._milestone[k]) / topo.num_global_workers
            ks.append(k); vs.append(delta.astype(np.float32)); ls.append(len(v))
        out = KVPairs(np.array(ks, dtype=np.int64), np.concatenate(vs),
                      np.array(ls, dtype=np.int64))
        keys = [int(k) for k in out.keys]
        with self._mu:
            epochs = {k: self._keys[k].epoch for k in keys
                      if k in self._keys}

        def on_acked():
            self.up.zpull(keys,
                          cb=lambda kvs: self._on_pull_down_hfa(kvs, epochs),
                          cmd=Cmd.HFA_DELTA)

        self.up.zpush(out, cmd=Cmd.HFA_DELTA, on_complete=on_acked)

    def _on_pull_down_hfa(self, kvs: KVPairs, epochs: Optional[dict] = None):
        tags = kvs.tags or {}
        live = []
        for k, v in kvs.slices():
            with self._mu.stripe(k):
                if (epochs is not None and k in self._keys
                        and self._keys[k].epoch != epochs.get(k)):
                    continue  # aborted by a restore
                new_w = self._decode_pull_value(k, v, tags.get(k, ""))
                self.store[k] = new_w
                self._milestone[k] = np.array(new_w, copy=True)
                # the K2 pull bypassed the pull compressor (dense by
                # design), so any BSC tracked view upstream is now stale;
                # -1 can never equal a tracked version, forcing the next
                # compressed pull of this key to resync dense
                self._pull_ver[k] = -1
            live.append(k)
        self._finish_round(live)

    def _pull_echo(self, keys) -> dict:
        """Request body for a pull-down: echo the per-key view versions
        so the global tier's BSC compressor can detect desync."""
        with self._mu:
            return {"pv": {str(int(k)): self._pull_ver.get(int(k), 0)
                           for k in keys}}

    def _decode_pull_value(self, k: int, v: np.ndarray, tag: str) -> np.ndarray:
        """Decode one pull-down slab into the new full weight vector.
        Caller holds stripe(k) (or the all-stripes barrier).
        "bsc" payloads are sparse deltas against
        the current replica (ref: BSC decode :310-336); "f32" is a dense
        resync forced by a view-version mismatch (server or subscriber
        restarted, or a pull response was lost)."""
        from geomx_tpu_torch.compression.codecs import unpack_sparse

        if tag == "bsc":
            vals, idx = unpack_sparse(np.ascontiguousarray(v).view(np.float32))
            # COW gate: the current replica may be frozen (aliased by
            # in-flight responses / adopted from upstream) — the delta
            # must not mutate it under those readers
            w = _mutable(self.store[k])
            w[idx] += vals
            return w
        if tag == "fp16":
            return np.ascontiguousarray(v).view(np.float16).astype(np.float32)
        if tag == "f32":
            arr = np.ascontiguousarray(v).view(np.float32)
            # frozen payload = upstream's immutability promise: adopt the
            # alias instead of copying (every local mutation path COWs)
            return arr if not arr.flags.writeable else arr.copy()
        if v.dtype == np.float32 and not v.flags.writeable:
            return v
        return np.array(v, copy=True)

    def _on_pull_down(self, kvs: KVPairs, epochs: Optional[dict] = None):
        """Updated weights arrived from tier 2 — possibly compressed
        (ref: DataHandlePullResponseDefault :974-1169).  Keys whose
        epoch moved since the round started were checkpoint-restored
        mid-flight: skip them (their round was aborted and their parked
        pulls already drained); the rest finish normally."""
        tags = kvs.tags or {}
        pv = kvs.pv or {}
        wv = kvs.wv or {}
        with self._tr.span("local.pull_down"):
            live = []
            for k, v in kvs.slices():
                with self._mu.stripe(k):
                    if (epochs is not None
                            and k in self._keys
                            and self._keys[k].epoch != epochs.get(k)):
                        continue  # aborted by a restore
                    tag = tags.get(k, "")
                    if k in wv and wv[k] < self._weight_ver.get(k, -1):
                        # overlapping rounds flush their responses with
                        # no stripes held, so round N's response can
                        # arrive AFTER round N+1's (its encode races
                        # the next close — widest when the weight
                        # materializes off-device first).  Applying it
                        # would roll the replica back a round and serve
                        # stale weights to every worker until the next
                        # push; dropping it still finishes the round.
                        # Strictly-older only: an equal stamp is the
                        # same weights (re-applying is idempotent)
                        self.stale_pull_skips += 1
                        live.append(k)
                        continue
                    if k in pv:
                        # overlapping rounds can deliver responses out of
                        # order (van delay/priority queues): a bsc delta is
                        # only valid against the exact view it was encoded
                        # for (ver pv-1), and a dense resync must never be
                        # overwritten by an older response.  Skipping still
                        # finishes the round — the replica stays one round
                        # behind and the next echo mismatch heals it dense.
                        cur = self._pull_ver.get(k, 0)
                        if tag == "bsc" and cur != pv[k] - 1:
                            self.stale_pull_skips += 1
                            live.append(k)
                            continue
                        if tag == "f32" and pv[k] <= cur:
                            self.stale_pull_skips += 1
                            live.append(k)
                            continue
                    self.store[k] = self._decode_pull_value(k, v, tag)
                    if k in pv:
                        self._pull_ver[k] = pv[k]
                    if k in wv:
                        self._weight_ver[k] = wv[k]
                live.append(k)
            self._finish_round(live)

    def _finish_round(self, keys: List[int]):
        """Unblock keys and retry their parked pulls.  Takes each key's
        stripe itself (callers holding the all-stripes barrier just
        re-enter); the retries run with no stripe held — a multi-key
        pull re-acquires stripes in its own key order."""
        to_retry: List[Message] = []
        for k in keys:
            with self._mu.stripe(k):
                st = self._keys[k]
                st.in_flight = max(0, st.in_flight - 1)
                st.version += 1
                to_retry.extend(st.parked_pulls)
                st.parked_pulls.clear()
        for req in to_retry:
            self._try_serve_pull(req)
        if self._flight is not None:
            self._flight.record(FlightEv.ROUND_COMPLETE, a=len(keys),
                                b=self.wan_push_rounds, note="local")
        if self.ts_client is not None:
            # hand fresh weights to the overlay dissemination thread;
            # the per-key astype copies happen under the stripe so a
            # concurrent in-place decode cannot tear them
            ks = sorted(keys)
            vs = []
            for k in ks:
                with self._mu.stripe(k):
                    vs.append(self.store[k].astype(np.float32))
            with self._ctr_mu:
                self._ts_iter += 1
                it = self._ts_iter
            self.ts_client.disseminate_async(
                np.array(ks, dtype=np.int64),
                np.concatenate(vs),
                np.array([len(v) for v in vs], dtype=np.int64),
                f"{self.po.node}:{it}", Cmd.TS_AUTOPULL)

    def _drain_parked_locked(self, st: _KeyState):
        """Caller holds the all-stripes barrier (init / warm-boot /
        async paths)."""
        parked, st.parked_pulls = st.parked_pulls, []
        for req in parked:
            self._try_serve_pull(req)

    def _handle_pull(self, msg: Message, kvs: KVPairs):
        self._try_serve_pull(msg)

    def _try_serve_pull(self, req: Message) -> bool:
        """Serve a pull if every key is initialized and not mid-round,
        else re-park it on the first blocking key (the reference spins on
        initialized_, ref :1721-1723 — we park event-driven).  A multi-key
        pull is re-validated against ALL its keys each time it is retried.
        Takes one stripe at a time (never two); safe to call under the
        all-stripes barrier (re-entry), never under a single OTHER
        stripe."""
        sender_s = str(req.sender)
        for k in req.keys:
            k = int(k)
            with self._mu.stripe(k):
                st = self._keys.get(k)
                if st is None:
                    st = self._keys.setdefault(k, _KeyState())
                # blocked while any WAN round is in flight OR a round this
                # sender CONTRIBUTED to is accumulating: both mean fresher
                # weights than the store's are owed to this puller.  A
                # non-contributor's pull is served from the last completed
                # round instead — a dynamic joiner bootstrapping (pull
                # before first push) must not park behind a round that can
                # only complete with its own push (advisor r4 deadlock),
                # and a worker lagging a round behind wants exactly the
                # store's weights, not the open round's future ones.
                # EXCEPT during a TS-MERGED round (count > distinct senders:
                # some push carried num_merge>1): a KNOWN PARTY MEMBER's
                # contribution may be inside the open accumulator even
                # though it never pushed directly — under the TS push
                # overlay non-elected workers NEVER push directly, so any
                # push-history test would serve them stale forever
                # (advisor r5, round-5 refinement) and party replicas
                # would silently diverge for every partial-merge window.
                # Members park; the round completes without their direct
                # push by construction (their contribution rode the
                # merge tree).  Serve-stale stays for out-of-plan
                # BOOTSTRAP pulls — a joiner that has not pushed anything
                # yet (parking those is the r4 deadlock) — and for plain
                # rounds (count == distinct senders), where the open
                # round still NEEDS this sender's own push.
                blocked = (k not in self.store or st.in_flight > 0
                           or (st.count > 0 and sender_s in st.contributors))
                if (not blocked and st.count > len(st.contributors)
                        and sender_s in self._members
                        and sender_s not in self._bootstrapping):
                    blocked = True
                if blocked:
                    st.parked_pulls.append(req)
                    return False
        if req.cmd == Cmd.ROW_SPARSE_PULL:
            # gather the requested rows only (ref: PullRowSparse).
            # Out-of-range ids are clamped defensively (the client
            # validates; an exception here would swallow the request and
            # hang the puller)
            key = int(req.keys[0])
            row_ids = np.asarray(req.body["rows"], dtype=np.int64)
            cols = int(req.body["rs_cols"])
            from geomx_tpu_torch.compression.codecs import pack_rows

            with self._mu.stripe(key):
                table = self.store[key].reshape(-1, cols)
                row_ids = np.clip(row_ids, 0, len(table) - 1)
                payload = pack_rows(row_ids, table[row_ids])
            self.server.response(req, KVPairs(
                np.array([key], np.int64), payload,
                np.array([len(payload)], np.int64)))
            return True
        ks = [int(k) for k in req.keys]
        if len(ks) == 1:
            # single key: freeze-in-place and serve the alias
            # (_store_payload) — zero-copy, in-place decodes COW
            with self._mu.stripe(ks[0]):
                w = self.store[ks[0]]
                payload = (_store_payload([w]) if w.dtype == np.float32
                           else np.array(w, np.float32))
            ls = [len(payload)]
        else:
            # multi-key: the response concatenates anyway (the isolation
            # copy) — copy each slice under ITS stripe straight into the
            # response buffer.  One total copy, exactly the pre-sharding
            # concat; deliberately NO freeze — freezing here would force
            # a full COW on every later in-place decode of these keys
            # (+0.2 s/round at the 50M flagship), and the under-stripe
            # copy already rules out a torn read.
            ls = []
            for k in ks:
                with self._mu.stripe(k):
                    ls.append(len(self.store[k]))
            payload = np.empty(sum(ls), np.float32)
            off = 0
            for k, ln in zip(ks, ls):
                with self._mu.stripe(k):
                    payload[off:off + ln] = self.store[k]
                off += ln
        # P3 piggybacked pushes park here until the round finishes; record
        # the response so a replay re-serves values instead of re-merging
        self._recent.mark_done(req)
        self.server.response(req, KVPairs(
            np.array(ks, dtype=np.int64), payload,
            np.array(ls, dtype=np.int64)))
        return True

    # ---- control ------------------------------------------------------------
    def _on_cmd(self, msg: Message):
        body = msg.body or {}
        if msg.cmd in (Ctrl.SET_SYNC_MODE, Ctrl.SET_COMPRESSION,
                       Ctrl.SET_HFA):
            # these flip how queued merges would be interpreted; keep
            # the handler-thread program order vs. the merge lanes
            self._shards.drain()
        if msg.cmd == Ctrl.SET_SYNC_MODE:
            self.sync_mode = bool(body["sync"])
        elif msg.cmd == Ctrl.SET_COMPRESSION:
            from geomx_tpu_torch.compression import compression_allowed

            if body == self.compression:
                # idempotent: a mid-training recreation would drop the
                # unsent residual/velocity mass held in the old codec
                self.server.reply_cmd(msg)
                return
            # hfa=False: a static/operator SET_COMPRESSION under HFA is
            # the dense-bypass case (predicate docstring); only runtime
            # POLICY retuning restricts to weight-safe codecs
            ok, why = compression_allowed(
                body.get("type", "none"),
                inter_ts=self.config.enable_inter_ts)
            if not ok:
                self.server.reply_cmd(msg, body={"error": why})
                return
            try:
                self.push_codec = self._make_push_codec(body)
                self.compression = body
            except ValueError as e:
                self.server.reply_cmd(msg, body={"error": str(e)})
                return
        elif msg.cmd == Ctrl.SET_WAN_POLICY:
            self._on_set_wan_policy(msg, body)
            return
        elif msg.cmd == Ctrl.SET_HFA:
            if bool(body["enabled"]) and self._saw_row_sparse:
                self.server.reply_cmd(msg, body={
                    "error": "cannot enable HFA: row-sparse tensors are in "
                             "use (HFA exchanges weights, not gradients)"})
                return
            self.hfa_enabled = bool(body["enabled"])
            self.hfa_k2 = int(body.get("k2", 1))
        elif msg.cmd == Ctrl.QUERY_STATS:
            self.server.reply_cmd(msg, body=self.stats())
            return
        elif msg.cmd == Ctrl.ESYNC:
            # state server (ESync, ref README.md:45 "to be integrated"):
            # record this worker's measured times, reply with its next
            # local-step assignment.  Lazily constructed — ESync is
            # opt-in via the worker loop, no config needed server-side.
            if self._esync is None:
                from geomx_tpu_torch.sched.esync import EsyncState

                # generous server ceiling; the effective cap per worker
                # is the max_steps its own loop reports
                self._esync = EsyncState(max_steps=1024)
            self._esync.report(str(body["worker"]),
                               float(body["step_s"]),
                               float(body["comm_s"]),
                               max_steps=int(body.get("max_steps", 0)))
            plan = self._esync.plan()
            self.server.reply_cmd(msg, body={
                "steps": plan.get(str(body["worker"]),
                                  self._esync.min_steps),
                "plan": plan,
            })
            return
        elif msg.cmd == Ctrl.PROFILER:
            _handle_profiler_cmd(self.po, msg, self.server)
            return
        self.server.reply_cmd(msg)

    def stats(self) -> dict:
        """The QUERY_STATS body — also sampled on an interval by the
        telemetry plane's MetricsPump (geomx_tpu_torch/obs), so the wire
        query and the shipped time series can never disagree."""
        van = self.po.van
        with self._mu:
            # memory accounting (the reference profiler's memory
            # stats, ref: src/profiler/profiler.h:256-304): resident
            # weight replicas + in-flight aggregation buffers
            store_b = sum(a.nbytes for a in self.store.values())
            accum_b = sum(st.accum.nbytes for st in self._keys.values()
                          if st.accum is not None)
        return {
            "wan_send_bytes": van.wan_send_bytes,
            "wan_recv_bytes": van.wan_recv_bytes,
            "send_bytes": van.send_bytes,
            "recv_bytes": van.recv_bytes,
            "store_bytes": store_b,
            "accum_bytes": accum_b,
            "hfa_gated_key_rounds": self.hfa_gated_key_rounds,
            "ts_deliveries": self.ts_deliveries,
            "stale_pull_skips": self.stale_pull_skips,
            # crash-tolerant membership observability
            "evicted_workers": self.evicted_workers,
            "eviction_fenced_pushes": self.eviction_fenced_pushes,
            "warm_boots": self.warm_boots,
            # elastic-membership observability: the churn_storm health
            # rule sums these deltas over its collector window
            "joined_workers": self.joined_workers,
            "left_workers": self.left_workers,
            "preempt_server_drains": self.preempt_server_drains,
            # partition-tolerance observability (quarantine-not-evict)
            "degraded": self._degraded,
            "degraded_rounds": self.degraded_rounds,
            "catchup_pending_rounds": self._catchup_rounds,
            "catchup_pushes": self.catchup_pushes,
            "catchup_fallbacks": self.catchup_fallbacks,
            "quarantined_workers": len(self._quarantined_members),
            # data-integrity observability (gradient hygiene)
            "integrity_poison_rejects": self.integrity_poison_rejects,
            "poison_quarantines": self.poison_quarantines,
            "integrity_codec_rejects": self.integrity_codec_rejects,
            "mpq_bsc_picks": getattr(self.push_codec, "bsc_picks", 0),
            "mpq_fp16_picks": getattr(self.push_codec, "fp16_picks", 0),
            "pq_overtakes": van.pq_overtakes,
            # adaptive-WAN controller signals: round rate + link RTT
            # + this sender's applied policy epoch
            "wan_push_rounds": self.wan_push_rounds,
            "policy_epoch": self._policy_epoch,
            "policy_fence_retries": self.policy_fence_retries,
            "policy_drops": self.policy_drops,
            "hb_rtt_s": max(self.po.heartbeat_rtts().values(),
                            default=None),
            # restart discrimination: a warm-booted replacement's zeroed
            # counters carry a fresh boot nonce + near-zero uptime, so a
            # collector can fence its rate windows instead of reading
            # the reset as a rate collapse
            "uptime_s": self.po.uptime_s(),
            "boot": van.boot,
            # merge backend observability (kvstore/backend.py):
            # merge_backend name + the jax path's merge_device_ms /
            # h2d_bytes, mirrored to the registry for the status console
            **self._merge_stats(),
        }

    def _merge_stats(self) -> dict:
        out = self._backend.stats()
        ms, h2d = out.get("merge_device_ms"), out.get("h2d_bytes")
        if ms is not None:
            from geomx_tpu_torch.utils.metrics import system_gauge

            system_gauge(f"{self.po.node}.merge_device_ms").set(ms)
            system_gauge(f"{self.po.node}.h2d_bytes").set(h2d or 0)
            # device->host traffic + optimizer-stage time: the
            # steady-state zero-D2H contract is audited on these
            system_gauge(f"{self.po.node}.d2h_bytes").set(
                out.get("d2h_bytes") or 0)
            system_gauge(f"{self.po.node}.opt_device_ms").set(
                out.get("opt_device_ms") or 0)
            # codec stage (ISSUE 20): encode kernel time + wire-ready
            # compressed D2H — host_copy auditing rides the same stats
            system_gauge(f"{self.po.node}.codec_device_ms").set(
                out.get("codec_device_ms") or 0)
            system_gauge(f"{self.po.node}.codec_d2h_bytes").set(
                out.get("codec_d2h_bytes") or 0)
        return out

    def leave_global(self, timeout: float = 30.0) -> dict:
        """Gracefully withdraw this PARTY from the global tier (VERDICT
        r4 item 6; beyond the reference — its global membership is
        static and recovery a TODO, van.cc:224).  Call once the party is
        done training (all worker rounds drained): every global server
        lowers num_global_workers at the round boundary, so the
        remaining parties' rounds complete without us instead of
        stalling forever.  Idempotent server-side; retried per global
        server on timeout (lossy-WAN safe)."""
        import uuid

        topo = self.po.topology
        results = {}
        for gs in topo.global_servers():
            token = f"{self.po.node}#{uuid.uuid4().hex[:8]}"
            cv = threading.Condition()
            reply: dict = {}

            def hook(msg, _token=token, _cv=cv, _reply=reply) -> bool:
                b = msg.body if isinstance(msg.body, dict) else {}
                if (msg.control is Control.ADD_NODE and not msg.request
                        and b.get("token") == _token):
                    with _cv:
                        _reply.update(b)
                        _cv.notify_all()
                    return True
                return False

            self.po.add_control_hook(hook)
            try:
                deadline = time.monotonic() + timeout
                for _ in range(3):
                    self.po.van.send(Message(
                        recipient=gs, control=Control.ADD_NODE,
                        domain=Domain.GLOBAL, request=True,
                        body={"action": "party_leave",
                              "node": str(self.po.node), "token": token}))
                    with cv:
                        if cv.wait_for(lambda: bool(reply),
                                       timeout=max(0.1, min(
                                           timeout / 3,
                                           deadline - time.monotonic()))):
                            break
                else:
                    raise TimeoutError(
                        f"{self.po.node}: party_leave to {gs} timed out")
            finally:
                self.po.remove_control_hook(hook)
            results[str(gs)] = dict(reply)
        return results

    def stop(self):
        if self._degrade_ticker is not None:
            self._degrade_ticker.stop()
        if self.ts_client is not None:
            self.ts_client.stop()
        if self.ts_inter is not None:
            self.ts_inter.stop()
        if self.ts_push_inter is not None:
            self._merge_q.put(None)
        self._shards.stop()
        self._backend.stop()
        self.server.stop()
        self.up.stop()


class _GlobalKeyState:
    __slots__ = ("accum", "count", "parked_pushes", "parked_pulls", "ver",
                 "contributors", "deferred")

    def __init__(self):
        self.accum: Optional[np.ndarray] = None
        self.count = 0
        # entries are [msg, set-of-keys-not-yet-updated]; a push is acked
        # when its remaining-set empties
        self.parked_pushes: List[list] = []
        self.parked_pulls: List[Message] = []
        # BSP same-sender fence: senders already merged into the OPEN
        # round; a second plain push from one of them belongs to the
        # NEXT round and waits in ``deferred`` (entries
        # ``(sender, value, parked-push entry, donated)``) until this
        # round closes — see the fence comment in _push_sync.merge_one
        self.contributors: set = set()
        self.deferred: List[tuple] = []
        # weight version: bumped with every store update that produces
        # NEW weights (round close / async push / catch-up merge).
        # Stamped onto pull-down responses ("wv" body) so a subscriber
        # can drop a late response that would roll its replica back —
        # responses to overlapping rounds are flushed with no stripes
        # held and CAN reorder in flight (the encode of round N's
        # response races round N+1's close)
        self.ver = 0


class GlobalServer:
    """Tier-2: owns a shard of the key space, runs the optimizer
    (ref: global-server paths of DataHandleSyncDefault :1302-1319 and the
    async handlers :1519-1698).

    ``standby=True`` runs the same server as a HOT STANDBY: it applies
    ``Cmd.REPLICATE`` state snapshots from its primary and parks any
    regular traffic until the global scheduler promotes it
    (``Control.PROMOTE``).  Promotion carries a **term**; a zombie
    ex-primary keeps its stale term and is fenced — its replication is
    rejected and its data path refuses pushes (see
    kvstore/replication.py for the full protocol)."""

    def __init__(self, postoffice: Postoffice, config: Optional[Config] = None,
                 standby: bool = False):
        self.po = postoffice
        self.config = config or postoffice.config
        topo = postoffice.topology
        self.num_contributors = topo.num_global_workers
        # host ndarrays and/or device-resident weight handles; reads
        # through the mapping interface always materialize to host
        self.store: Dict[int, np.ndarray] = WeightStore()
        self._keys: Dict[int, _GlobalKeyState] = {}
        # key-sharded merge (see LocalServer): stripe(k) guards key k,
        # ``with self._mu:`` is the all-stripes barrier for party
        # folds, failover fences, replication snapshots and policy
        # swaps — their atomicity against the data path is unchanged.
        # Lanes are built per merge backend (kvstore/backend.py).
        self._backend = make_merge_backend(self.config,
                                           str(postoffice.node))
        # device-resident WAN codec stage (ISSUE 20): compressed pushes
        # decode through jitted kernels straight into device arrays the
        # merge lanes seed without re-staging (zero full-tensor host
        # traffic on the push→decode→merge→optimize chain)
        self._codec_stage = self._backend.make_codec_stage(self.config)
        self._mu, self._shards = make_merge_lanes(
            self.config, f"g{postoffice.node}", self._backend)
        self._ack_mu = threading.Lock()  # leaf lock: a parked push's
        #                                  remaining-keys set is shared
        #                                  across stripes
        self._pc_mu = threading.RLock()  # leaf lock: the pull
        #                                  compressor's per-subscriber
        #                                  views/caches are not striped
        self._wv_mu = threading.Lock()   # leaf lock: pairs a store
        #                                  write with its ver bump so a
        #                                  responder snapshots (weights,
        #                                  wv) coherently.  May be taken
        #                                  under a stripe or _pc_mu;
        #                                  takes no lock itself
        # ---- failover state (tentpole PR 1) ----
        self.is_standby = bool(standby)
        self.term = 0              # fencing epoch; bumped by promotion
        self.promotions = 0        # times this node was promoted
        self.fenced_rejects = 0    # stale-term replication pushes refused
        self._fenced = False       # this node was deposed: refuse data
        self._fence_reason = ""
        self._repl_seq = 0         # last applied replication snapshot
        self._parked_standby: List[tuple] = []  # (msg, kvs) pre-promotion
        self._repl = None          # Replicator on a primary with a standby
        # live key-range reassignment (shard drain): once this holder
        # ships its final snapshot to the new holder it DROPS data
        # requests silently — to clients it looks exactly like the dead
        # primary of a failover, so the proven retarget+replay path
        # moves their traffic; the fence answers any control stragglers
        self._draining = False
        self._handoff_kw = None    # lazily-built ship endpoint (one per
        #                            lifetime; Customer ids don't recycle)
        self.drains = 0            # completed handoffs (observability)
        self.merged_handoffs = 0   # key ranges adopted from a drain
        self.key_rounds = 0        # completed (key, round) optimizer
        #                            updates — the telemetry plane's
        #                            per-shard round-progress series
        #                            (a stalled shard stops counting)
        self.optimizer: ServerOptimizer = Sgd()
        self._optimizer_configured = False  # flips on SET_OPTIMIZER; a
        #                                     central-worker deployment
        #                                     gates training on it
        # device-resident optimizer stage (kvstore/jax_backend.py):
        # non-None when the merge backend runs the round close on
        # device — weights+moments stay device-resident, host copies
        # only at serve/checkpoint/handoff events.  ``self.optimizer``
        # stays the host-semantics shell (type tag, DCASGD fallback,
        # the pickle format every snapshot round-trips through)
        self._dev_opt = None
        self.sync_mode = self.config.sync_global_mode
        self.compression: dict = {"type": "none"}
        # a run that never configures an optimizer still closes rounds
        # on device under the jax backend (default Sgd is in the family)
        self._activate_dev_opt_locked()
        self.pull_comp = None  # BroadcastCompressor under bsc/mpq
        self.subscriber_prunes = 0  # departed/evicted subscribers whose
        #                             tracked pull-compressor views were
        #                             freed (each view pins a full model
        #                             copy — the PR 8 leak fix)
        # adaptive WAN (geomx_tpu_torch/control), RECEIVER side: SET_WAN_POLICY
        # adopts the new decode parameters + pull compressor immediately
        # (tracked views invalidated through the version handshake —
        # subscribers resync dense), and gradient pushes stamped with a
        # different epoch are fenced with a retryable error carrying the
        # current policy, so the sender re-encodes instead of this server
        # misdecoding.  Off (default): one flag check per push.
        self._adaptive = bool(self.config.adaptive_wan)
        self._policy_epoch = 0
        self.policy_fenced_pushes = 0
        self.rejected_compr_tags = 0
        self.catchup_merges = 0  # healed-party Cmd.CATCHUP deltas merged
        # gradient hygiene at the WAN tier (Config.integrity_push_screen)
        self._poison_strikes: Dict[str, int] = {}
        self.integrity_poison_rejects = 0
        # verified durable state (GEOMX_INTEGRITY_CKPT): corrupt
        # checkpoint generations / replication snapshots rejected
        self.integrity_ckpt_rejects = 0
        # structurally-corrupt compressed payloads fenced at decode time
        self.integrity_codec_rejects = 0
        # per-endpoint stateful-decoder cache (replaces the process-wide
        # _TWOBIT_DECODERS dict two concurrent Simulations used to share)
        from geomx_tpu_torch.compression import DecoderBank

        self._decoders = DecoderBank()
        self._recent = RecentRequests()  # replayed-push dedup
        # automatic periodic checkpoints (mid-round crash recovery; an
        # improvement over the reference, whose server state is RAM-only)
        self._since_ckpt = 0
        self._ckpt_busy = False
        self._ckpt_pending = False
        from geomx_tpu_torch.trace.recorder import get_tracer
        from geomx_tpu_torch.utils import get_profiler

        self._prof = get_profiler(str(postoffice.node))
        self._tr = get_tracer(str(postoffice.node))
        # flight recorder (obs/flight.py): fence/promotion/round events
        # + this shard's merge-pressure sources; None when disabled
        self._flight = postoffice.flight
        attach_server_pressure(self._flight, self._mu, self._shards)
        if self._flight is not None:
            self._flight.record(FlightEv.MERGE_BACKEND, a=self._mu.n,
                                note=self._backend.name)
        # inter-party TSEngine: after a sync round updates, disseminate
        # the fresh weights to the local servers via the WAN overlay
        # instead of serving N pulls (sync tier only)
        self.ts_inter = None
        self._ts_iter = 0
        # async-tier dissemination is rate-limited: per-push relays would
        # flood the overlay, so fresh weights go out at most once per
        # inter_ts_async_every pushes, covering every key updated since
        # the previous dissemination
        self._ts_async_pushes = 0
        self._ts_async_dirty: set = set()
        if self.config.enable_inter_ts:
            from geomx_tpu_torch.sched.tsengine import TsClient

            self.ts_inter = TsClient(
                postoffice, topo.global_scheduler(), domain=Domain.GLOBAL)
        # parties that announced a graceful leave (idempotency set)
        self._left_parties: set = set()
        # parties folded out REVERSIBLY because their local server died
        # (kvstore/eviction.py LocalServerRecoveryMonitor): same fold as
        # a leave, but a warm-booted replacement folds back in
        self._folded_parties: set = set()
        self.party_folds = 0
        self.party_unfolds = 0
        postoffice.add_control_hook(self._on_add_node)
        postoffice.add_control_hook(self._on_evict)
        postoffice.add_control_hook(self._on_promote)
        postoffice.add_control_hook(self._on_new_primary)
        postoffice.add_control_hook(self._on_handoff)
        self.server = KVServer(APP_PS, 0, postoffice, self._handle)
        self.server.cmd_handler = self._on_cmd
        # the axpy-vs-numpy calibration must never run inside the locked
        # merge path — warm the cached verdict at startup instead
        from geomx_tpu_torch.native.bindings import calibrate_async

        calibrate_async(self.config.server_merge_threads)
        if not self.is_standby:
            sb = topo.standby_for(postoffice.node.rank)
            if sb is not None and str(sb) != str(postoffice.node):
                from geomx_tpu_torch.kvstore.replication import Replicator

                self._repl = Replicator(self, sb)

    def _on_add_node(self, msg: Message) -> bool:
        """Graceful PARTY leave at the global tier (VERDICT r4 item 6).
        The reference's global-tier membership is static and its global
        recovery is a TODO (van.cc:224) — this goes beyond it: a local
        server announces its party will push no more, the aggregation
        target drops at the round boundary, and mid-flight rounds
        already satisfied at the lowered target complete NOW instead of
        stalling forever.  Idempotent by party-server node id."""
        if msg.control is not Control.ADD_NODE or not msg.request:
            return False
        body = msg.body if isinstance(msg.body, dict) else {}
        if body.get("action") != "party_leave":
            return False
        node_s = str(body.get("node", msg.sender))
        with self._mu:
            if node_s not in self._left_parties:
                self._left_parties.add(node_s)
                # a crashed party that leaves gracefully later (odd but
                # possible) must not double-decrement
                already_folded = node_s in self._folded_parties
                self._folded_parties.discard(node_s)
                completed = ([] if already_folded
                             else self._fold_party_out_locked(node_s))
            else:
                completed = []  # replayed leave: no double decrement
            # HFA-mode rounds accumulate milestone DELTAS (additive);
            # everything else accumulates gradients for the optimizer
            to_ack, dissem = self._complete_keys_locked(
                completed, hfa_delta=self.config.use_hfa, dissem_ok=True)
            total = self.num_contributors
        self._flush_completions(to_ack, dissem)
        # a departed party's per-subscriber pull-compressor views are
        # dead weight (one full-model copy each) — free them; if the
        # party somehow pulls again, the no-base handshake resyncs dense
        self._prune_subscriber(node_s)
        self.po.van.send(msg.reply_to(control=Control.ADD_NODE, body={
            "num_global_workers": total, "token": body.get("token")}))
        return True

    def _prune_subscriber(self, node_s: str) -> int:
        """Free one subscriber's tracked pull-compressor views (leaves /
        folds / replica evictions).  Safe on live subscribers — a pruned
        pair's next pull resyncs dense through the version handshake."""
        with self._pc_mu:
            if self.pull_comp is None:
                return 0
            n = self.pull_comp.drop_subscriber(node_s)
        if n:
            self.subscriber_prunes += 1
            from geomx_tpu_torch.utils.metrics import system_counter

            system_counter(f"{self.po.node}.subscriber_prunes").inc()
            print(f"{self.po.node}: pruned {n} tracked pull view(s) of "
                  f"departed subscriber {node_s}", flush=True)
        return n

    def _fold_party_out_locked(self, node_s: str) -> List[int]:
        """Lower the aggregation target by one party; returns the keys
        whose mid-flight rounds the fold made decidable (they would
        otherwise stall forever waiting for the gone party).  Shared by
        the graceful party leave and the reversible crash fold.  Caller
        holds ``_mu`` and runs the returned keys through
        ``_complete_keys_locked``."""
        self.num_contributors = max(1, self.num_contributors - 1)
        completed = [k for k, st in self._keys.items()
                     if st.accum is not None
                     and st.count >= self.num_contributors]
        # drop per-sender optimizer bookkeeping (DCASGD's
        # previous-weight backups) — a departed party's full-model
        # snapshots would otherwise stay pinned in RAM
        for st_opt in self.optimizer.state.values():
            prev = st_opt.get("prev")
            if isinstance(prev, dict):
                prev.pop(node_s, None)
        return completed

    def _on_evict(self, msg: Message) -> bool:
        """Reversible party fold (Control.EVICT from the global
        scheduler's LocalServerRecoveryMonitor): a party whose local
        server died stops counting toward global rounds — the graceful
        party-leave fold, but reversible — and counts again once its
        replacement warm-booted (``party_unfold``).  Idempotent per
        party in both directions."""
        if msg.control is not Control.EVICT or not msg.request:
            return False
        body = msg.body if isinstance(msg.body, dict) else {}
        action = body.get("action")
        if action == "subscriber_prune":
            # the replica monitor (geomx_tpu_torch/serve) declared a serve
            # replica dead: free its tracked pull views.  Idempotent;
            # a revived replica resyncs dense on its next refresh.
            node_s = str(body.get("node", msg.sender))
            pruned = self._prune_subscriber(node_s)
            self.po.van.send(msg.reply_to(control=Control.EVICT, body={
                "pruned": pruned, "token": body.get("token")}))
            return True
        if action not in ("party_fold", "party_unfold"):
            return False
        node_s = str(body.get("node", msg.sender))
        to_ack: List[tuple] = []
        dissem = None
        changed = False
        with self._mu:
            if action == "party_fold":
                if (node_s not in self._folded_parties
                        and node_s not in self._left_parties):
                    self._folded_parties.add(node_s)
                    self.party_folds += 1
                    changed = True
                    completed = self._fold_party_out_locked(node_s)
                    to_ack, dissem = self._complete_keys_locked(
                        completed, hfa_delta=self.config.use_hfa,
                        dissem_ok=True)
            else:  # party_unfold
                if node_s in self._folded_parties:
                    self._folded_parties.discard(node_s)
                    self.num_contributors += 1
                    self.party_unfolds += 1
                    changed = True
            total = self.num_contributors
        if changed:
            from geomx_tpu_torch.utils.metrics import system_counter

            system_counter(f"{self.po.node}.{action}s").inc()
            if self._flight is not None:
                self._flight.record(
                    FlightEv.FOLD if action == "party_fold"
                    else FlightEv.UNFOLD, c=total, peer=node_s,
                    note=action)
            print(f"{self.po.node}: {action} {node_s} "
                  f"(num_global_workers={total})", flush=True)
            if action == "party_fold":
                # the folded party's tracked views are freed too: its
                # warm boot pulls dense and echoes -1, so the resync the
                # handshake forces anyway makes the prune free
                self._prune_subscriber(node_s)
        self._flush_completions(to_ack, dissem)
        self.po.van.send(msg.reply_to(control=Control.EVICT, body={
            "num_global_workers": total, "token": body.get("token")}))
        return True

    def _handle(self, msg: Message, kvs: Optional[KVPairs], server: KVServer):
        prof = self._prof
        if prof.running and msg.push and msg.cmd != Cmd.INIT:
            prof.count("push_bytes", float(msg.nbytes))
        span_name = ("global.init" if msg.cmd == Cmd.INIT
                     else "global.push" if msg.push else "global.pull")
        with prof.span(span_name), self._tr.span(span_name):
            self._handle_inner(msg, kvs, server)

    def _handle_inner(self, msg: Message, kvs: Optional[KVPairs],
                      server: KVServer):
        if msg.cmd == Cmd.REPLICATE:
            self._on_replicate(msg, kvs)
            return
        if self._draining and msg.request and (msg.push or msg.pull):
            # drained holder: to the data plane this node is DEAD — the
            # request is dropped without a response so the sender's
            # replay machinery re-issues it at the new holder after the
            # NEW_PRIMARY retarget (an error reply here would surface as
            # a failure instead of riding the proven failover path)
            return
        if self._fenced and msg.request:
            # deposed ex-primary: accepting pushes here would fork the
            # store from the promoted standby's (split brain) — refuse
            # loudly; retargeted clients never come back anyway
            err = {"error": f"fenced: {self._fence_reason} "
                            f"(term {self.term})", "term": self.term}
            server.response(msg, body=err)
            return
        if self.is_standby and msg.request:
            # replayed traffic can race ahead of the PROMOTE command —
            # park it (bounded; the replay layer re-sends on overflow)
            # and re-dispatch at promotion
            with self._mu:
                if len(self._parked_standby) < 4096:
                    self._parked_standby.append((msg, kvs))
            return
        if msg.cmd == Cmd.INIT:
            # overwrite-INITs must not interleave with merges still
            # queued on lanes from earlier-arrived pushes
            self._shards.drain()
            state = self._recent.check(msg)
            if state == "pending":
                return
            if state == "done":
                server.response(msg, body=self._recent.done_body(msg))
                return
            overwrite = bool(isinstance(msg.body, dict)
                             and msg.body.get("overwrite"))
            stale_acks: List[Message] = []
            with self._mu:
                fresh = False
                for k, v in kvs.slices():
                    if k not in self.store or overwrite:
                        fresh = True
                        self.store[k] = np.array(v, copy=True)
                        st = self._keys.setdefault(k, _GlobalKeyState())
                        if overwrite:
                            # a restore ABORTS in-flight rounds: drop the
                            # aggregation state AND the abandoned
                            # optimizer trajectory (momentum/Adam moments
                            # from the discarded run would drag the
                            # restored weights right back), and ack any
                            # parked pushers so no party wedges waiting
                            # for a round that will never complete
                            st.accum = None
                            st.count = 0
                            self._drop_opt_key_locked(k)
                            for ent in st.parked_pushes:
                                ent[1].discard(k)
                                if not ent[1]:
                                    stale_acks.append(ent[0])
                            st.parked_pushes.clear()
                        # init may race ahead of early pulls (under the
                        # barrier, re-parking inline is lock-safe)
                        for m in self._serve_parked_pulls_locked(int(k)):
                            self._park_pull(m)
                if fresh and overwrite and self.pull_comp is not None:
                    # drop ONLY the overwritten keys' tracked views and
                    # re-seed their INIT bases with the propagated value;
                    # a full compressor rebuild would also re-seed
                    # untouched keys' bases from trained weights that
                    # echo-0 subscribers never held
                    for k, v in kvs.slices():
                        self.pull_comp.invalidate_key(int(k), v)
                elif fresh and self.pull_comp is not None:
                    for k, v in kvs.slices():
                        self.pull_comp.ensure_base(int(k), v)
                if fresh:
                    # force a baseline checkpoint: a crash before the
                    # first periodic one must still restore the key set
                    self._auto_ckpt_locked(force=True)
                    if self._repl is not None:
                        self._repl.mark_locked(force=True)
            for req in stale_acks:
                self._recent.mark_done(req)
                self.server.response(req)
            self._recent.mark_done(msg)
            server.response(msg)
            return
        if msg.push and msg.request and self._reject_bad_push(msg):
            return  # fenced at message-decode time, before any merge
        if msg.push and msg.compr and kvs is not None:
            try:
                kvs = self._decompress_push(msg, kvs)
            except CodecError as e:
                # a truncated / bit-rotted payload that slipped past (or
                # never crossed) the wire checksums: fence the one push,
                # never the merge thread.  Like _reject_bad_push this
                # sits ahead of the replay-dedup window, so the sender's
                # retried re-encode is processed fresh.
                self.integrity_codec_rejects += 1
                from geomx_tpu_torch.utils.metrics import system_counter

                system_counter(
                    f"{self.po.node}.integrity_codec_rejects").inc()
                if self._flight is not None:
                    self._flight.record(FlightEv.CORRUPT, d=msg.boot,
                                        peer=msg.sender,
                                        note="corrupt_codec_payload")
                self.server.response(msg, body={
                    "error": f"corrupt compressed push from {msg.sender} "
                             f"refused before merge: {e}"})
                return
        if msg.push:
            if msg.cmd == Cmd.CATCHUP:
                # partition heal: a quarantined party's bounded degraded-
                # round delta — merged through the optimizer, but NEVER
                # part of sync-round accounting (the party was folded
                # out; survivors' rounds already closed without it)
                self._push_catchup(msg, kvs)
            elif self.sync_mode:
                self._push_sync(msg, kvs)
            else:
                self._push_async(msg, kvs)
        elif msg.pull:
            self._pull(msg, kvs)

    def _reject_bad_push(self, msg: Message) -> bool:
        """Fence a push BEFORE it can reach the merge: (a) a malformed /
        foreign compr tag would raise a bare ValueError deep inside
        ``decompress_payload`` and poison the round — answer with an
        error naming the offending node, tag and policy epoch instead;
        (b) under adaptive WAN, a gradient push whose policy epoch
        differs from this server's current one is refused with a
        RETRYABLE error carrying the current policy, so the sender
        re-encodes rather than this server decoding with the wrong
        parameters.  Deliberately ahead of the replay-dedup window: a
        fenced request is never recorded, so its retried re-encode is
        processed fresh.  Returns True when the push was answered."""
        from geomx_tpu_torch.compression.codecs import KNOWN_PUSH_TAGS

        if msg.compr and msg.compr not in KNOWN_PUSH_TAGS:
            self.rejected_compr_tags += 1
            from geomx_tpu_torch.utils.metrics import system_counter

            system_counter(f"{self.po.node}.rejected_compr_tags").inc()
            if self._flight is not None:
                self._flight.record(FlightEv.FENCE, b=msg.policy_epoch,
                                    d=msg.boot, peer=msg.sender,
                                    note="bad_compr_tag")
            self.server.response(msg, body={
                "error": f"unknown compression tag '{msg.compr}' in push "
                         f"from {msg.sender} (policy epoch "
                         f"{msg.policy_epoch}); payload refused before "
                         "merge", "compr": msg.compr})
            return True
        if (self._adaptive and msg.cmd == Cmd.DEFAULT
                and msg.policy_epoch != self._policy_epoch):
            self.policy_fenced_pushes += 1
            from geomx_tpu_torch.utils.metrics import system_counter

            system_counter(f"{self.po.node}.policy_fenced_pushes").inc()
            with self._mu:
                cur_epoch = self._policy_epoch
                cur_policy = dict(self.compression)
            if self._flight is not None:
                self._flight.record(FlightEv.FENCE, a=msg.policy_epoch,
                                    b=cur_epoch, d=msg.boot,
                                    peer=msg.sender, note="policy_epoch")
            self.server.response(msg, body={
                "error": f"policy epoch fenced: push from {msg.sender} "
                         f"carries epoch {msg.policy_epoch}, server is "
                         f"at {cur_epoch}; re-encode under the current "
                         "policy and retry",
                "policy_fenced": True, "policy_epoch": cur_epoch,
                "policy": cur_policy})
            return True
        return False

    def _screen_push(self, msg: Message, kvs: KVPairs) -> KVPairs:
        """Gradient-hygiene screen at the WAN tier — the belt to the
        local tier's suspenders: a party whose local screen is off, or
        whose merged gradient rotted past the wire checksums, must not
        poison the global model.  A poisoned payload is replaced with
        zeros and tagged via ``msg._gx_poisoned``; the sync path merges
        the zero contribution (the round counts parties — a reject
        without a merge would stall survivors) and the parked ack
        carries the typed error, while the async/catch-up paths reject
        outright.  Party-level quarantine deliberately stays the
        scheduler's call — the ``data_corruption`` health rule surfaces
        repeat offenders; folding out a whole party over NaNs is a far
        bigger hammer than the local tier's single-worker quarantine."""
        if not self.config.integrity_push_screen:
            return kvs
        if self._backend.screen_finite(kvs.vals,
                                       self.config.poison_mag_max):
            return kvs
        sender_s = str(msg.sender)
        self.integrity_poison_rejects += 1  # GIL-atomic, as the fences
        strikes = self._poison_strikes.get(sender_s, 0) + 1
        self._poison_strikes[sender_s] = strikes
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.integrity_poison_rejects").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.CORRUPT, a=strikes,
                                peer=sender_s, note="poison_push")
        msg._gx_poisoned = {
            "error": f"poisoned push rejected at the global tier: "
                     f"payload from {sender_s} failed the finiteness/"
                     f"magnitude screen (strike {strikes}); "
                     "contribution zeroed"}
        return KVPairs(kvs.keys, np.zeros(len(kvs.vals), np.float32),
                       kvs.lens)

    def _decompress_push(self, msg: Message, kvs: KVPairs) -> KVPairs:
        """Decode a compressed gradient push to dense before aggregation
        (ref: BSCDecompress gradient_compression.cc:310-336; fp16/2bit
        decode in the server push handlers).  Multi-key payloads fan
        the per-key decodes across the shared codec pool; this server's
        own ``DecoderBank`` keeps per-endpoint decoder affinity (its
        LRU is internally locked), so epoch-fenced clears stay scoped
        to this endpoint."""
        from geomx_tpu_torch.compression import decompress_payload

        thr = float(self.compression.get("threshold", 0.5))
        pairs = [(int(k), p) for k, p in kvs.slices()]
        lens = []
        for k, _ in pairs:
            with self._mu.stripe(k):
                # raw length — reading through __getitem__ would
                # materialize a device-resident weight just to size the
                # decode buffer
                lens.append(self.store.length(k)
                            if isinstance(self.store, WeightStore)
                            else len(self.store[k]))
        if self._codec_stage is not None:
            # device decode (ISSUE 20): structural gates run host-side
            # on the small compressed buffer (same CodecError fencing),
            # then jitted kernels land each gradient as a device array
            # the merge lanes seed with no re-staging.  Device dispatch
            # serializes anyway, so the host codec pool buys nothing.
            with self._tr.span("codec.decode"):
                vs = [self._codec_stage.decode(msg.compr, k, p, ln, thr)
                      for (k, p), ln in zip(pairs, lens)]
                vals = vs[0] if len(vs) == 1 else self._codec_stage.concat(vs)
            return KVPairs(np.array([k for k, _ in pairs], dtype=np.int64),
                           vals, np.array(lens, dtype=np.int64))
        pool = codec_pool(self.config) if len(pairs) > 1 else None
        with self._tr.span("codec.decode"):
            if pool is None:
                vs = [decompress_payload(msg.compr, k, p, ln, thr,
                                         bank=self._decoders)
                      for (k, p), ln in zip(pairs, lens)]
            else:
                futs = [pool.submit(decompress_payload, msg.compr, k, p,
                                    ln, thr, self._decoders)
                        for (k, p), ln in zip(pairs, lens)]
                vs = [f.result() for f in futs]
        return KVPairs(np.array([k for k, _ in pairs], dtype=np.int64),
                       vs[0] if len(vs) == 1 else np.concatenate(vs),
                       np.array(lens, dtype=np.int64))

    # ---- sync tier ----------------------------------------------------------
    def _push_sync(self, msg: Message, kvs: KVPairs):
        """Accumulate; ack each parked push once ALL of its keys have been
        through an optimizer update (the ACK is the "updated" signal the
        local server waits for before pulling, ref: :1312-1316).

        Keys complete independently (message-granular tracking), so pushes
        with asymmetric key batches cannot deadlock or double-apply."""
        if len(kvs.keys) == 0:
            self.server.response(msg)
            return
        state = self._recent.check(msg)
        if state == "pending":
            return  # replay of a push already in this round's accumulator
        if state == "done":
            # the original ACK was lost — repeat it, same body (an error
            # body must not degrade into a clean ACK on the replay).  A
            # piggybacked push_pull re-serves the values: a bare re-ack
            # would leave the puller waiting forever
            body = self._recent.done_body(msg)
            if body is None and msg.pull:
                self._respond_pull(msg)
            else:
                self.server.response(msg, body=body)
            return
        kvs = self._screen_push(msg, kvs)  # after dedup: retries of a
        #                                    poisoned push don't restrike
        # an inter-TS-merged push carries several parties' contributions
        # (ref: num_merge counting in the global ASK_PUSH path)
        num_merge = 1
        if isinstance(msg.body, dict):
            num_merge = int(msg.body.get("num_merge", 1))
        hfa_delta = msg.cmd == Cmd.HFA_DELTA
        dissem_ok = msg.cmd == Cmd.DEFAULT
        slices = [(int(k), v) for k, v in kvs.slices()]
        entry = [msg, {k for k, _ in slices}]
        # key-sharded merge: each key accumulates — and, the moment its
        # round completes, runs its optimizer update — on its stripe's
        # serial lane.  The message-level finish (ack flush, checkpoint
        # / replication marking, overlay dissemination) runs once, on
        # the lane that clears the last slice.
        pending = [len(slices)]
        acks: List[tuple] = []
        reparks: List[Message] = []
        completed_keys: List[int] = []
        done_mu = threading.Lock()

        # BSP same-sender fence: a party's round-N+1 push can arrive
        # while round N is still open (WAN pushes pipeline ahead of the
        # pull-down, and the first device-codec encode JIT-compiles, so
        # one party's two rounds can outrun another party's first).
        # Counting it would close round N from ONE party's two pushes —
        # the global weights still see every gradient, but that party's
        # pull-down serves a close its peers never reached, rolling its
        # replica a round behind.  Defer it to the next round instead.
        # Pre-merged pushes (num_merge > 1) carry several parties under
        # one sender and HFA deltas are milestone-additive — neither is
        # sender-gated.
        sender_s = str(msg.sender)
        gate = num_merge == 1 and not hfa_delta

        def merge_one(k: int, v: np.ndarray):
            k_acks: List[tuple] = []
            k_reparks: List[Message] = []
            completed = False
            opened = False
            with self._mu.stripe(k):
                st = self._keys.setdefault(k, _GlobalKeyState())
                if (gate and st.accum is not None
                        and sender_s in st.contributors):
                    st.deferred.append((sender_s, v, entry, msg.donated))
                else:
                    if st.accum is None:
                        st.accum = self._backend.seed(v, msg.donated,
                                                      key=k)
                        opened = True
                    else:
                        st.accum = self._backend.accumulate(st.accum, v)
                    st.count += num_merge
                    st.parked_pushes.append(entry)
                    if gate:
                        st.contributors.add(sender_s)
                    if st.count >= self.num_contributors:
                        completed = True
                        self._complete_key_locked(k, hfa_delta, k_acks,
                                                  k_reparks)
            if opened and self._flight is not None:
                # a fresh aggregation round opened for this key — the
                # stall forensic's "who was the round waiting on"
                self._flight.record(FlightEv.ROUND_OPEN, a=k,
                                    peer=msg.sender, note="global")
            with done_mu:
                acks.extend(k_acks)
                reparks.extend(k_reparks)
                if completed:
                    completed_keys.append(k)
                pending[0] -= 1
                last = pending[0] == 0
            if last:
                self._merge_finish(acks, reparks, completed_keys,
                                   dissem_ok)

        for k, v in slices:
            self._shards.submit(k, _ctx_bound(lambda k=k, v=v: merge_one(k, v)))

    def _complete_key_locked(self, k: int, hfa_delta: bool,
                             to_ack: List[tuple],
                             reparks: List[Message]) -> None:
        """One completed key's update (caller holds stripe(k) or the
        all-stripes barrier): optimizer (or additive HFA delta), parked
        push ack collection, parked pull serving.  Appends (request,
        error) pairs whose key sets emptied to ``to_ack`` and pulls
        still blocked on OTHER keys to ``reparks`` — the caller
        re-parks those via :meth:`_park_pull` OUTSIDE this stripe (a
        re-park takes the blocking key's stripe; taking it here would
        break the one-stripe-at-a-time lock order)."""
        st = self._keys[k]
        if k not in self.store:
            # a restarted server without a checkpoint cannot host
            # this key — fail the pushers loudly, don't hang them
            err = {"error": f"key {k} lost across server restart "
                            "(no checkpoint to resume from)"}
            st.accum = None
            st.count = 0
            st.contributors.clear()
            with self._ack_mu:
                for ent in st.parked_pushes:
                    ent[1].discard(k)
                    if not ent[1]:
                        to_ack.append((ent[0], err))
                # fence-deferred pushes never reached parked_pushes —
                # fail them the same way, don't hang their senders
                for _, _, ent, _ in st.deferred:
                    ent[1].discard(k)
                    if not ent[1]:
                        to_ack.append((ent[0], err))
            st.parked_pushes.clear()
            st.deferred.clear()
            return
        with self._tr.span("global.opt"):
            dev = self._dev_opt
            if dev is not None:
                # device-resident round close: the accumulator never
                # leaves the device — one jitted donated update over it
                # (grad+state donated; weights functionally replaced).
                # ZERO D2H here; the store entry becomes a DeviceWeight
                # that host consumers materialize on demand
                raw = self.store.raw(k)
                if hfa_delta:
                    new_w = dev.add_delta(raw, st.accum)
                else:
                    new_w = dev.step(
                        k, raw, st.accum, 1.0 / self.num_contributors)
            else:
                # the weighted mean at round close consumes a HOST
                # array (identity on numpy; device sync + one D2H
                # under jax without the device optimizer stage)
                accum = self._backend.materialize(st.accum)
                if hfa_delta:
                    # milestone deltas come pre-divided by
                    # num_global_workers; apply additively (ref:
                    # HandleHFAAccumulate :959-972)
                    new_w = self.store[k] + accum
                else:
                    # accum is donated: update_scaled may build the new
                    # weights in it, skipping the /num temporary and the
                    # result allocation (big-tensor hot path)
                    new_w = self.optimizer.update_scaled(
                        k, self.store[k], accum,
                        1.0 / self.num_contributors)
            with self._wv_mu:
                self.store[k] = new_w
                st.ver += 1
        st.accum = None
        st.count = 0
        st.contributors.clear()
        with self._ack_mu:
            for ent in st.parked_pushes:
                ent[1].discard(k)
                if not ent[1]:
                    to_ack.append((ent[0], None))
        st.parked_pushes.clear()
        reparks.extend(self._serve_parked_pulls_locked(k))
        if st.deferred:
            # replay pushes the same-sender fence parked for the round
            # that just opened.  An item whose sender is already in the
            # NEW round (two deferred rounds from one party) re-defers;
            # per-sender FIFO is preserved.  A cascade close recurses —
            # depth is bounded by the backlog / num_contributors
            backlog, st.deferred = st.deferred, []
            for item in backlog:
                d_sender, v, ent, donated = item
                if st.accum is not None and d_sender in st.contributors:
                    st.deferred.append(item)
                    continue
                if st.accum is None:
                    st.accum = self._backend.seed(v, donated, key=k)
                else:
                    st.accum = self._backend.accumulate(st.accum, v)
                st.count += 1
                st.parked_pushes.append(ent)
                st.contributors.add(d_sender)
                if st.count >= self.num_contributors:
                    # _merge_finish only counts the outer close
                    self.key_rounds += 1
                    self._complete_key_locked(k, False, to_ack, reparks)

    def _merge_finish(self, to_ack: List[tuple],
                      reparks: List[Message],
                      completed_keys: List[int], dissem_ok: bool):
        """Message-level finish of one sync push, with no stripes held:
        re-park multi-key pulls, mark checkpoint/replication progress
        and build the overlay dissemination under the all-stripes
        barrier (both snapshot cross-key state), then flush acks."""
        for m in reparks:
            self._park_pull(m)
        self.key_rounds += len(completed_keys)  # GIL-atomic int add
        if completed_keys and self._flight is not None:
            self._flight.record(FlightEv.ROUND_COMPLETE,
                                a=len(completed_keys), b=self.key_rounds,
                                note="global")
        dissem = None
        if completed_keys and (
                self._repl is not None or self.ts_inter is not None
                or (self.config.checkpoint_dir
                    and self.config.auto_ckpt_updates)):
            with self._mu:
                self._auto_ckpt_locked(len(completed_keys))
                if self._repl is not None:
                    self._repl.mark_locked(len(completed_keys))
                if self.ts_inter is not None and dissem_ok:
                    dissem = self._build_dissem_locked(sorted(
                        k for k in completed_keys if k in self.store))
        self._flush_completions(to_ack, dissem)

    def _complete_keys_locked(self, completed: List[int],
                              hfa_delta: bool, dissem_ok: bool):
        """Batch completion for the FOLD paths (party leave / crash
        fold / overwrite-INIT): caller holds the all-stripes barrier,
        so the per-key completions just re-enter their stripes and
        still-blocked pulls can re-park immediately.  Returns
        ``(to_ack, dissem)`` for :meth:`_flush_completions` outside the
        lock."""
        to_ack: List[tuple] = []
        reparks: List[Message] = []
        for k in completed:
            self._complete_key_locked(k, hfa_delta, to_ack, reparks)
        for m in reparks:
            self._park_pull(m)
        if completed:
            self.key_rounds += len(completed)
            if self._flight is not None:
                self._flight.record(FlightEv.ROUND_COMPLETE,
                                    a=len(completed), b=self.key_rounds,
                                    note="fold")
            self._auto_ckpt_locked(len(completed))
            if self._repl is not None:
                self._repl.mark_locked(len(completed))
        if self.ts_inter is not None and completed and dissem_ok:
            dissem = self._build_dissem_locked(sorted(
                k for k in completed if k in self.store))
        else:
            dissem = None
        return to_ack, dissem

    def _flush_completions(self, to_ack: List[tuple], dissem):
        for req, err in to_ack:
            if err is None:
                # a poisoned push completed its rounds with a zeroed
                # contribution; its ack is the typed reject, and the
                # piggyback pull (if any) gets the error, not values
                err = getattr(req, "_gx_poisoned", None)
            self._recent.mark_done(req, err)
            if err is None and req.pull:
                # P3 piggyback on the WAN tier: the push response carries
                # the updated values, eliminating the ack -> pull-request
                # chain per key (ref: server replies with values in the
                # push response, kvstore_dist_server.h:1149-1165,1255-1267)
                self._respond_pull(req)
            else:
                self.server.response(req, body=err)
        if dissem is not None:
            self.ts_inter.disseminate_async(*dissem, Cmd.TS_AUTOPULL)

    def _build_dissem_locked(self, ks: List[int]):
        """Assemble one overlay-relay payload for keys ``ks`` (caller
        holds self._mu).  Honors fp16 pull compression on the relay
        (bsc/mpq are rejected at config time — per-subscriber deltas
        don't fit a shared relay payload)."""
        if not ks:
            return None
        self._ts_iter += 1
        dt = (np.float16 if self.compression.get("type") == "fp16"
              else np.float32)
        return (
            np.array(ks, dtype=np.int64),
            np.concatenate([self.store[k].astype(dt) for k in ks]),
            np.array([len(self.store[k]) for k in ks], dtype=np.int64),
            f"{self.po.node}:{self._ts_iter}",
        )

    # ---- async tier (MixedSync, ref :1519-1698) -----------------------------
    def _push_async(self, msg: Message, kvs: KVPairs):
        state = self._recent.check(msg)
        if state == "pending":
            # the original is still being applied — drop silently (a bare
            # ack here would consume the puller's response slot and the
            # real values response would then be discarded as a duplicate)
            return
        if state == "done":
            # the ACK was lost — re-ack without re-applying the gradient
            # (with values again if the original was a piggybacked
            # push_pull)
            body = self._recent.done_body(msg)
            if body is None and msg.pull:
                self._respond_pull(msg)
            else:
                self.server.response(msg, body=body)
            return
        self._screen_push(msg, kvs)
        poisoned = getattr(msg, "_gx_poisoned", None)
        if poisoned is not None:
            # async tier: no round barrier to keep honest — reject
            # outright before any optimizer touch
            self._recent.mark_done(msg, poisoned)
            self.server.response(msg, body=poisoned)
            return
        dissem = None
        with self._mu:
            for k, v in kvs.slices():
                k = int(k)
                grad = self._async_grad(v)
                if self._dev_opt is not None:
                    # async tier on the device stage: one H2D of the
                    # push, jitted update, weights stay device-resident
                    # (DCASGD never constructs a device optimizer — its
                    # per-sender backups are host bookkeeping)
                    new_w = self._dev_opt.step(
                        k, self.store.raw(k), grad, 1.0)
                elif isinstance(self.optimizer, DCASGD):
                    new_w = self.optimizer.update(
                        k, self.store[k], grad, sender=str(msg.sender))
                else:
                    new_w = self.optimizer.update_scaled(
                        k, self.store[k], grad, 1.0)
                with self._wv_mu:
                    self.store[k] = new_w
                    self._keys.setdefault(k, _GlobalKeyState()).ver += 1
            self.key_rounds += len(kvs.keys)
            if self._flight is not None:
                self._flight.record(FlightEv.ROUND_COMPLETE,
                                    a=len(kvs.keys), b=self.key_rounds,
                                    note="async")
            self._auto_ckpt_locked(len(kvs.keys))
            if self._repl is not None:
                self._repl.mark_locked(len(kvs.keys))
            if self.ts_inter is not None and msg.cmd == Cmd.DEFAULT:
                self._ts_async_dirty.update(int(k) for k in kvs.keys)
                self._ts_async_pushes += 1
                if (self._ts_async_pushes
                        >= self.config.inter_ts_async_every):
                    self._ts_async_pushes = 0
                    ks = sorted(self._ts_async_dirty)
                    self._ts_async_dirty.clear()
                    dissem = self._build_dissem_locked(ks)
        self._recent.mark_done(msg)
        if msg.pull:
            self._respond_pull(msg)  # piggybacked push_pull (P3)
        else:
            self.server.response(msg)
        if dissem is not None:
            self.ts_inter.disseminate_async(*dissem, Cmd.TS_AUTOPULL)

    def _async_grad(self, v):
        """One key's pushed gradient as the async / catch-up update takes
        it, private to the update (which may donate it).  A push the
        codec stage decoded is a fresh device tensor owned by this push:
        the device optimizer stage consumes it where it lies, and a HOST
        optimizer engine (DCASGD, which never gets a device stage) gets
        one explicit, billed D2H — never an implicit numpy conversion,
        which a CUDA tensor refuses.  A host push is copied to f32."""
        if self._codec_stage is not None and self._codec_stage.is_device(v):
            return v if self._dev_opt is not None \
                else self._codec_stage.to_host(v)
        return v.astype(np.float32)  # copy: donated below

    def _push_catchup(self, msg: Message, kvs: KVPairs):
        """Merge a healed party's staleness-stamped catch-up delta
        (Cmd.CATCHUP) through the SAME optimizer path as a live async
        push — DC-ASGD's per-sender backup compensates the staleness
        exactly as it would for a slow party — WITHOUT advancing sync-
        round accounting or the timestamp overlay: the quarantined
        party was folded out of those rounds, and replaying it into
        them would stall survivors waiting on a contributor that
        already left.  Bypasses the adaptive policy-epoch fence by
        construction (``_reject_bad_push`` only fences Cmd.DEFAULT):
        the delta was encoded under the healing party's last-known
        policy, and a refusal here would discard the partition's entire
        surviving progress over a codec-parameter quibble."""
        state = self._recent.check(msg)
        if state == "pending":
            return
        if state == "done":
            self.server.response(msg, body=self._recent.done_body(msg))
            return
        self._screen_push(msg, kvs)
        if getattr(msg, "_gx_poisoned", None) is not None:
            # a NaN catch-up delta would poison every key it touches
            # through the optimizer; the healed party re-syncs dense
            # instead (same fallback as an invalidated delta)
            err = msg._gx_poisoned
            self._recent.mark_done(msg, err)
            self.server.response(msg, body=err)
            return
        meta = (msg.body or {}).get("catchup", {}) \
            if isinstance(msg.body, dict) else {}
        rounds = int(meta.get("rounds", 0))
        with self._mu:
            for k, v in kvs.slices():
                k = int(k)
                if k not in self.store:
                    continue  # key retired while the party was dark
                grad = self._async_grad(v)
                if self._dev_opt is not None:
                    new_w = self._dev_opt.step(
                        k, self.store.raw(k), grad, 1.0)
                elif isinstance(self.optimizer, DCASGD):
                    new_w = self.optimizer.update(
                        k, self.store[k], grad, sender=str(msg.sender))
                else:
                    new_w = self.optimizer.update_scaled(
                        k, self.store[k], grad, 1.0)
                with self._wv_mu:
                    self.store[k] = new_w
                    self._keys.setdefault(k, _GlobalKeyState()).ver += 1
            self.catchup_merges += 1
            self._auto_ckpt_locked(len(kvs.keys))
            if self._repl is not None:
                self._repl.mark_locked(len(kvs.keys))
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.partition_catchup_merges").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.NETFAULT, a=len(kvs.keys),
                                b=rounds, peer=msg.sender,
                                note="netfault_catchup_merge")
        print(f"{self.po.node}: merged catch-up delta from "
              f"{msg.sender} ({len(kvs.keys)} keys, {rounds} degraded "
              f"rounds, {meta.get('age_s', 0)}s stale)", flush=True)
        self._recent.mark_done(msg)
        self.server.response(msg)

    # ---- pulls --------------------------------------------------------------
    def _pull(self, msg: Message, kvs: KVPairs):
        self._park_pull(msg)

    def _park_pull(self, m: Message) -> None:
        """Serve a pull, or park it under its first key that is MISSING
        NOW (one stripe at a time).  Re-parking under a missing key
        matters: leaving a pull under an already-present key would
        orphan it — later INITs only rescan their own key's list
        (advisor r1: zpull([a,b]) before INIT of both hung when a and b
        arrived in separate INITs)."""
        for k in m.keys:
            k = int(k)
            with self._mu.stripe(k):
                if k not in self.store:
                    self._keys.setdefault(
                        k, _GlobalKeyState()).parked_pulls.append(m)
                    return
        self._respond_pull(m)

    def _serve_parked_pulls_locked(self, key: int) -> List[Message]:
        """Serve ``key``'s parked pulls that became servable; returns
        the ones still blocked on OTHER keys.  Caller holds stripe(key)
        (or the barrier) and re-parks the returned pulls via
        :meth:`_park_pull` — re-parking takes the blocking key's
        stripe, which must not nest inside this one."""
        st = self._keys.get(key)
        if not st:
            return []
        pending, st.parked_pulls = st.parked_pulls, []
        blocked: List[Message] = []
        for m in pending:
            if all(int(k) in self.store for k in m.keys):
                self._respond_pull(m)
            else:
                blocked.append(m)
        return blocked

    def _respond_pull(self, req: Message):
        # HFA K2 pulls must come back dense: the subscriber's replica just
        # adopted its party mean, so sparse deltas against the tracked
        # view would desync it.  A warm-boot pull (body {"dense": True})
        # is dense for the same reason — the fresh replica has no view
        # for a delta (or an fp16 downgrade) to be safe against
        hfa_pull = req.cmd == Cmd.HFA_DELTA
        dense = hfa_pull or (isinstance(req.body, dict)
                             and bool(req.body.get("dense")))
        if not dense and (self.pull_comp is not None
                          or self.compression.get("type") == "fp16"):
            self._respond_pull_compressed(req)
            return
        ks, vs, ls, wvs = [], [], [], {}
        for k in req.keys:
            k = int(k)
            w, wvs[str(k)] = self._weight_wv(k)
            ks.append(k); vs.append(w); ls.append(len(w))
        self.server.response(req, KVPairs(
            np.array(ks, dtype=np.int64), _store_payload(vs),
            np.array(ls, dtype=np.int64)),
            body={"wv": wvs})

    def _weight_wv(self, k: int):
        """Coherent ``(weights, weight-version)`` snapshot for a
        pull-down response.  Writers pair the store write with the ver
        bump under ``_wv_mu``, so taking it here rules out stamping new
        weights with an old version (or vice versa) — the subscriber's
        roll-back guard (:meth:`LocalServer._on_pull_down`) relies on
        the stamp never under-reporting.  The term rides the high bits:
        a promoted standby restarts per-key counters at 0 but its
        bumped term keeps the stamps monotonic across the failover."""
        with self._wv_mu:
            st = self._keys.get(k)
            return self.store[k], ((self.term << 48)
                                   + (st.ver if st is not None else 0))

    def _respond_pull_compressed(self, req: Message):
        """Pull-direction compression (the second half of Bi-Sparse,
        ref: BSCPullCompress/DefaultStorageResponse :1171-1211).

        One wire format for all compressed pulls: byte-packed payload with
        per-key tags in the response body.  "bsc" keys carry a top-k
        weight-delta against this subscriber's tracked view; "fp16" keys
        (small tensors under MPQ, or everything under plain fp16 —
        ref: README.md:22 fp16 halves both directions) carry half-precision
        weights.
        """
        typ = self.compression.get("type")
        size_bound = (int(self.compression.get("size_bound", 200_000))
                      if typ == "mpq" else 0)
        # _pc_mu: the compressor's per-subscriber tracked views, payload
        # cache and rng are shared across keys — a leaf lock (taken
        # under a stripe or the barrier, never the reverse) keeps them
        # coherent now that pull serving runs outside the big lock
        with self._tr.span("codec.encode"), self._pc_mu:
            self._respond_pull_compressed_inner(req, typ, size_bound)

    def _respond_pull_compressed_inner(self, req: Message, typ,
                                       size_bound: int):
        sender = str(req.sender)
        echo = {}
        if isinstance(req.body, dict):
            echo = req.body.get("pv", {}) or {}
        ks, chunks, ls, tags, pvs, wvs = [], [], [], {}, {}, {}
        for k in req.keys:
            k = int(k)
            w, wvs[str(k)] = self._weight_wv(k)
            if typ == "fp16" or (size_bound and len(w) < size_bound):
                payload = w.astype(np.float16)
                tags[str(k)] = "fp16"
            else:
                # version handshake: mismatched echo (either side
                # restarted, or a lost response) → dense "f32" resync
                # instead of a delta against a desynced view
                payload, tag, ver = self.pull_comp.compress(
                    sender, k, w, echo_ver=int(echo.get(str(k), 0)))
                tags[str(k)] = tag
                pvs[str(k)] = ver
            b = np.ascontiguousarray(payload).view(np.uint8)
            ks.append(k); chunks.append(b); ls.append(len(b))
        self.server.response(
            req,
            KVPairs(np.array(ks, dtype=np.int64), np.concatenate(chunks),
                    np.array(ls, dtype=np.int64)),
            body={"compr": tags, "pv": pvs, "wv": wvs},
        )

    def _on_set_wan_policy(self, msg: Message, body: dict):
        """Ctrl.SET_WAN_POLICY from the controller (receiver side):
        adopt the decode parameters + pull compressor IMMEDIATELY (the
        controller contacts receivers before senders).  The rebuilt
        compressor carries ``trust_init=False`` and its tracked views
        are gone, so every subscriber's next compressed pull resyncs
        dense through the existing version handshake — the coherent
        invalidation the epoch protocol relies on.  Old-epoch pushes
        already merged into an open round stay merged (they were decoded
        under their own epoch's parameters when they arrived); only
        NOT-yet-decoded cross-epoch payloads are fenced."""
        if not self._adaptive:
            self.server.reply_cmd(msg, body={
                "error": "adaptive WAN is disabled on this server "
                         "(Config.adaptive_wan / --adaptive-wan)"})
            return
        from geomx_tpu_torch.compression import (compression_allowed,
                                           make_push_codec)

        comp = dict(body.get("compression") or {})
        ok, why = compression_allowed(
            comp.get("type", "none"),
            inter_ts=self.ts_inter is not None, hfa=self.config.use_hfa)
        if not ok:
            self.server.reply_cmd(msg, body={"error": why})
            return
        try:
            make_push_codec(comp)  # validate before adopting
        except ValueError as e:
            self.server.reply_cmd(msg, body={"error": str(e)})
            return
        applied = False
        with self._mu:
            epoch = int(body.get("epoch", 0))
            if epoch > self._policy_epoch:
                self._policy_epoch = epoch
                # trust_init=False: subscribers hold trained weights,
                # not INIT values — their first pull under the new
                # policy must resync dense, never sparse-from-INIT
                self._apply_compression_locked(comp, trust_init=False)
                # stateful decoders die with the epoch that created them
                self._decoders.clear()
                applied = True
            cur = self._policy_epoch
        if applied:
            from geomx_tpu_torch.utils.metrics import system_gauge

            system_gauge(f"{self.po.node}.wan_policy_epoch").set(cur)
            self._tr.instant("wanpolicy.apply", epoch=cur,
                             codec=comp.get("type"))
            print(f"{self.po.node}: WAN policy epoch {cur} adopted -> "
                  f"{comp.get('type')}", flush=True)
        self.server.reply_cmd(msg, body={"epoch": cur})

    def _apply_compression_locked(self, body: dict, trust_init: bool = True):
        """Install a compression config (caller holds self._mu).

        ``trust_init=False`` (checkpoint restore) builds the pull
        compressor without the sparse-from-INIT fast path: subscribers
        still hold whatever they last pulled, not the restored weights,
        so every pair's first post-restore pull must resync dense."""
        from geomx_tpu_torch.compression import BroadcastCompressor

        self.compression = body
        if body.get("type") in ("bsc", "mpq"):
            pc = BroadcastCompressor(ratio=body.get("ratio", 0.01),
                                     trust_init=trust_init)
            for k, v in self.store.items():
                pc.ensure_base(k, v)
            # publish only after bases are seeded, and under the
            # compressor's own leaf lock — compressed pull serving
            # synchronizes on _pc_mu, not the barrier
            with self._pc_mu:
                self.pull_comp = pc
        else:
            with self._pc_mu:
                self.pull_comp = None

    def _auto_ckpt_locked(self, n_updates: int = 0, force: bool = False):
        """Periodic background checkpoint (caller holds self._mu).

        Snapshots under the lock, serializes on a daemon thread — a
        multi-MB savez must not stall every party's round.  ``force``
        writes immediately (used right after INIT so a crash before the
        first interval still restores the key set)."""
        if not self.config.checkpoint_dir or not self.config.auto_ckpt_updates:
            return
        self._since_ckpt += n_updates
        if not force and self._since_ckpt < self.config.auto_ckpt_updates:
            return
        self._since_ckpt = 0
        if self._ckpt_busy:
            # a write is in flight with an older snapshot — re-snapshot
            # when it finishes (dropping this request could persist a
            # checkpoint that is missing keys INITed during the write)
            self._ckpt_pending = True
            return
        self._spawn_ckpt_write_locked()

    def _spawn_ckpt_write_locked(self):
        self._ckpt_busy = True
        import os

        from geomx_tpu_torch.kvstore import checkpoint as ckpt

        store_snap = {k: v.copy() for k, v in self.store.items()}
        opt_snap = self._export_opt_locked()
        meta = {"sync_mode": self.sync_mode,
                "compression": dict(self.compression)}
        path = os.path.join(self.config.checkpoint_dir,
                            f"global_server_{self.po.node.rank}.npz")

        def write():
            try:
                # N-generation retention (Config.ckpt_generations): the
                # previous checkpoint shifts to path.1 (… path.N-1)
                # BEFORE the new write lands, so a generation that rots
                # on disk still leaves a verified older one for
                # load_checkpoint's fallback scan
                ckpt.rotate_generations(path, self.config.ckpt_generations)
                ckpt.save_server_state(path, store_snap,
                                       {"optimizer": opt_snap}, meta)
            except Exception:  # any failure must not wedge _ckpt_busy —
                # that would silently disable all future auto-checkpoints
                import logging

                logging.getLogger(__name__).exception(
                    "auto-checkpoint to %s failed", path)
            finally:
                with self._mu:
                    self._ckpt_busy = False
                    if self._ckpt_pending:
                        self._ckpt_pending = False
                        self._spawn_ckpt_write_locked()

        threading.Thread(target=write, daemon=True,
                         name=f"auto-ckpt-{self.po.node}").start()

    def _activate_dev_opt_locked(self):
        """(Re)derive the device optimizer stage from the current host
        ``self.optimizer`` (caller holds ``_mu``): when the merge
        backend offers one for this optimizer's spec, import any
        existing per-key trajectory onto the device and hand the state
        ownership over (the host shell keeps hyper-parameters and the
        type tag; single ownership keeps export unambiguous).  Standbys
        defer — every replication snapshot would otherwise re-stage the
        whole state H2D; promotion activates instead."""
        self._dev_opt = None
        if self.is_standby:
            return
        from geomx_tpu_torch.optim import spec_of

        spec = spec_of(self.optimizer)
        if spec is None:
            return  # custom subclass / unsupported: host path
        dev = self._backend.make_device_optimizer(spec)
        if dev is None:
            return
        dev.import_state(self.optimizer)
        self.optimizer.state = {}
        self._dev_opt = dev

    def _export_opt_locked(self) -> ServerOptimizer:
        """THE optimizer-stage snapshot hook (caller holds ``_mu``):
        every path that serializes this server's optimizer — periodic
        checkpoint, Ctrl.CHECKPOINT save, the replication stream, a
        HANDOFF drain — goes through here, so a device-resident
        trajectory is materialized into the equivalent host optimizer
        (numpy pickle format unchanged on the wire/slab) and survives
        failover, reassignment and warm boot on either engine."""
        if self._dev_opt is not None:
            return self._dev_opt.export_state()
        import copy

        return copy.deepcopy(self.optimizer)

    def _drop_opt_key_locked(self, k: int):
        """Discard one key's optimizer trajectory (overwrite-INIT
        restore abort), whichever engine holds it."""
        self.optimizer.state.pop(k, None)
        if self._dev_opt is not None:
            self._dev_opt.drop_key(k)

    def _install_state_locked(self, store: dict, opt: dict, meta: dict):
        """Adopt a full state snapshot (checkpoint restore OR a
        replication snapshot from the primary).  Caller holds ``_mu``."""
        self.store = WeightStore(
            {k: np.array(v) for k, v in store.items()})
        for k in self.store:
            self._keys.setdefault(k, _GlobalKeyState())
        self.optimizer = opt["optimizer"]
        # a restored trajectory re-enters the device stage (no-op on
        # the host path / on a standby, which defers to promotion)
        self._activate_dev_opt_locked()
        # a restored optimizer IS a configured optimizer: central-
        # worker deployments gate training on this flag, and a
        # restarted shard reporting False would wedge them
        self._optimizer_configured = bool(
            meta.get("optimizer_configured", True))
        # resume under the snapshotted config, not whatever this
        # fresh process happened to default to
        self.sync_mode = meta.get("sync_mode", self.sync_mode)
        # trust_init=False: subscribers hold whatever they last
        # pulled, not these restored weights — their first pull after
        # the restore must resync dense (version-echo mismatch)
        self._apply_compression_locked(
            meta.get("compression", self.compression),
            trust_init=False)
        # the primary's replay-dedup done-window rides the snapshot: a
        # client replaying an un-ACKed request the primary already
        # applied AND replicated must be re-acked, never re-applied
        # (the exactly-once half of failover replay)
        rd = meta.get("recent_done")
        if rd:
            self._recent.seed_done(rd)

    def _merge_state_locked(self, store: dict, opt: dict, meta: dict):
        """Adopt a drained shard's key range NEXT TO this server's own
        (key-range reassignment onto a live primary).  Unlike
        :meth:`_install_state_locked` nothing of this server's own shard
        is touched: the shipped keys and their optimizer state are added,
        the drained holder's replay-dedup window is seeded ADDITIVELY
        (so a client replay of a request the old holder already applied
        is re-acked, not re-applied — the same exactly-once contract as
        failover), and pulls parked on the new keys are served.  Caller
        holds ``_mu``."""
        shipped_opt = opt.get("optimizer")
        for k, v in store.items():
            k = int(k)
            self.store[k] = np.array(v)
            st = self._keys.setdefault(k, _GlobalKeyState())
            # any aggregation state this server somehow held for a
            # foreign key is stale by definition
            st.accum = None
            st.count = 0
            if shipped_opt is not None and k in getattr(
                    shipped_opt, "state", {}):
                # per-key optimizer state (momentum/Adam moments) moves
                # with the range; this server's own keys keep theirs
                if self._dev_opt is not None:
                    self._dev_opt.import_key(k, shipped_opt.state[k])
                else:
                    self.optimizer.state[k] = shipped_opt.state[k]
            if self.pull_comp is not None:
                self.pull_comp.ensure_base(k, self.store[k])
            for m in self._serve_parked_pulls_locked(k):
                self._park_pull(m)
        if not self._optimizer_configured and shipped_opt is not None \
                and meta.get("optimizer_configured"):
            # an unconfigured target adopts the drained shard's
            # optimizer wholesale — MultiGPS must never mix a configured
            # shard with a default-SGD one
            self.optimizer = shipped_opt
            self._optimizer_configured = True
            self._activate_dev_opt_locked()
        rd = meta.get("recent_done")
        if rd:
            self._recent.seed_done(rd)
        if self._repl is not None:
            # the adopted range replicates with THIS holder's standby
            # chain from now on — ship a fresh snapshot that includes it
            self._repl.mark_locked(force=True)

    # ---- live key-range reassignment (shard drain) --------------------------
    def _on_handoff(self, msg: Message) -> bool:
        """Control.HANDOFF from the global scheduler: drain this
        holder's key range onto ``body["target"]`` under a bumped term.
        The ship blocks on a WAN round trip, so it runs off the hook
        thread; the scheduler retries until a reply lands (idempotent —
        an already-drained holder re-acks)."""
        if msg.control is not Control.HANDOFF or not msg.request:
            return False
        body = msg.body if isinstance(msg.body, dict) else {}
        term = int(body.get("term", 0))
        target = body.get("target")
        with self._mu:
            if self._draining or self._fenced:
                # replayed (or raced) handoff: the drain already
                # happened — re-ack with the recorded outcome
                self.po.van.send(msg.reply_to(
                    control=Control.HANDOFF,
                    body={"ok": term <= self.term and self.drains > 0,
                          "keys": len(self.store),
                          "token": body.get("token")}))
                return True
            if term <= self.term or target is None:
                self.po.van.send(msg.reply_to(
                    control=Control.HANDOFF,
                    body={"ok": False, "term": self.term,
                          "error": f"stale handoff term {term} <= "
                                   f"{self.term}",
                          "token": body.get("token")}))
                return True
        threading.Thread(
            target=self._drain_thread,
            args=(msg, term, NodeId.parse(str(target))),
            daemon=True, name=f"handoff-{self.po.node}").start()
        return True

    def _drain_thread(self, msg: Message, term: int, target: NodeId):
        from geomx_tpu_torch.kvstore import checkpoint as ckpt
        from geomx_tpu_torch.kvstore.replication import HANDOFF_CUSTOMER_ID

        ok = False
        nkeys = 0
        try:
            # stop the regular replication stream FIRST and wait out any
            # in-flight ship: a pre-quiesce snapshot landing at a standby
            # target AFTER the handoff install would roll it back to a
            # state missing the final rounds
            if self._repl is not None:
                self._repl.stopped = True
                deadline = time.monotonic() + 10
                while self._repl._busy and time.monotonic() < deadline:
                    time.sleep(0.05)
            # program order: merges queued from already-arrived pushes
            # land before the snapshot; requests arriving after the
            # _draining flip below are dropped (clients replay them at
            # the new holder post-retarget)
            self._shards.drain()
            with self._mu:
                self._draining = True
                store_snap = {k: v.copy() for k, v in self.store.items()}
                opt_snap = self._export_opt_locked()
                meta = {
                    "sync_mode": self.sync_mode,
                    "compression": dict(self.compression),
                    "recent_done": self._recent.export_done(),
                    "optimizer_configured": self._optimizer_configured,
                }
                nkeys = len(store_snap)
            blob = np.frombuffer(
                ckpt.dumps_server_state(store_snap, {"optimizer": opt_snap},
                                        meta), dtype=np.uint8)
            if self._handoff_kw is None:
                self._handoff_kw = KVWorker(
                    APP_PS, HANDOFF_CUSTOMER_ID, self.po,
                    targets=[target], key_ranges=split_range(1),
                    domain=Domain.GLOBAL)
            else:
                self._handoff_kw.targets[0] = target
            kw = self._handoff_kw
            kw.zpush(
                KVPairs(np.array([0], dtype=np.int64), blob,
                        np.array([len(blob)], dtype=np.int64)),
                cmd=Cmd.REPLICATE, wait=True, donated=True,
                body={"term": term, "seq": self._repl_seq + 1,
                      "handoff": True})
            with kw._mu:
                errs, kw.errors[:] = list(kw.errors), []
            ok = not errs
            if ok:
                self.drains += 1  # single drain thread per lifetime
                from geomx_tpu_torch.utils.metrics import system_counter

                system_counter(f"{self.po.node}.drains").inc()
                self._tr.instant("reassign.drained", term=term,
                                 target=str(target), keys=nkeys)
                if self._flight is not None:
                    self._flight.record(FlightEv.HANDOFF, a=term,
                                        c=nkeys, peer=target,
                                        note="drained")
                self._fence(f"key range drained to {target}", term)
            else:
                # aborted ship: the range is still ours — resume serving
                # (replication stream included) rather than wedging the
                # shard half-drained
                with self._mu:
                    self._draining = False
                    if self._repl is not None:
                        self._repl.stopped = False
                import logging

                logging.getLogger(__name__).error(
                    "%s: handoff to %s failed (%s); resuming as holder",
                    self.po.node, target, "; ".join(errs))
        except Exception:
            with self._mu:
                self._draining = False
                if self._repl is not None:
                    self._repl.stopped = False
            import logging

            logging.getLogger(__name__).exception(
                "%s: handoff to %s failed; resuming as holder",
                self.po.node, target)
        try:
            self.po.van.send(msg.reply_to(
                control=Control.HANDOFF,
                body={"ok": ok, "keys": nkeys,
                      "token": (msg.body or {}).get("token")}))
        except (KeyError, OSError):
            pass  # the scheduler re-asks; the idempotent re-ack answers

    # ---- hot-standby replication + promotion (kvstore/replication.py) ------
    def _on_replicate(self, msg: Message, kvs: Optional[KVPairs]):
        """Apply one streamed state snapshot from the shard's primary —
        the checkpoint slab format over the wire.  Term-fenced: once a
        newer primary holds the shard, a zombie's stale stream is
        rejected (counted) so it can never roll the store back."""
        state = self._recent.check(msg)
        if state == "pending":
            return
        if state == "done":
            self.server.response(msg, body=self._recent.done_body(msg))
            return
        body = msg.body if isinstance(msg.body, dict) else {}
        term, seq = int(body.get("term", 0)), int(body.get("seq", 0))
        handoff = bool(body.get("handoff"))
        err = None
        with self._mu:
            if term < self.term:
                self.fenced_rejects += 1
                from geomx_tpu_torch.utils.metrics import system_counter

                system_counter(
                    f"{self.po.node}.replication_fenced_rejects").inc()
                if self._flight is not None:
                    self._flight.record(FlightEv.FENCE, a=term, b=self.term,
                                        peer=msg.sender,
                                        note="stale_repl_term")
                err = {"error": f"fenced: stale replication term {term} < "
                                f"{self.term}", "term": self.term}
            elif handoff and kvs is not None:
                # key-range reassignment: the draining holder's final
                # snapshot.  A live primary MERGES the shipped range
                # next to its own (it keeps serving its own shard
                # mid-adopt); a standby target full-installs — both
                # idempotent, so the scheduler's handoff retries are
                # safe.  Ordering vs. our own primary's replication
                # stream is by term: the drain bumped the shipped
                # range's term past anything the old stream carries.
                from geomx_tpu_torch.kvstore import checkpoint as ckpt

                try:
                    store, opt, meta = ckpt.loads_server_state(
                        np.ascontiguousarray(kvs.vals).tobytes())
                except ckpt.CheckpointCorruption as e:
                    err = self._reject_corrupt_snapshot_locked(e, msg)
                else:
                    if self.is_standby:
                        self._install_state_locked(store, opt, meta)
                    else:
                        self._merge_state_locked(store, opt, meta)
                    self.merged_handoffs += 1
                    self._repl_seq = max(self._repl_seq, seq)
            elif seq > self._repl_seq and kvs is not None:
                from geomx_tpu_torch.kvstore import checkpoint as ckpt
                from geomx_tpu_torch.utils.metrics import system_gauge

                try:
                    store, opt, meta = ckpt.loads_server_state(
                        np.ascontiguousarray(kvs.vals).tobytes())
                except ckpt.CheckpointCorruption as e:
                    # the standby KEEPS its previous verified generation
                    # — a rotted stream frame must never replace good
                    # replica state; the primary's next mark re-ships
                    err = self._reject_corrupt_snapshot_locked(e, msg)
                else:
                    self._install_state_locked(store, opt, meta)
                    self._repl_seq = seq
                    system_gauge(
                        f"{self.po.node}.replication_seq").set(seq)
            # else: an out-of-order older snapshot — ack without applying
        self._recent.mark_done(msg, err)
        self.server.response(msg, body=err)

    def _reject_corrupt_snapshot_locked(self, e: Exception,
                                        msg: Message) -> dict:
        """A replication/handoff snapshot failed checkpoint verification
        (caller holds ``_mu``): count it, keep the state we already
        have, and answer with a typed error.  The body deliberately
        avoids the word "fenced" — the primary's Replicator reads
        fence-flavored replies as a deposition signal, and one rotted
        frame must not depose a healthy primary."""
        self.integrity_ckpt_rejects += 1
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.integrity_ckpt_rejects").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.CORRUPT, peer=msg.sender,
                                note="corrupt_snapshot")
        print(f"{self.po.node}: rejected corrupt replication snapshot "
              f"from {msg.sender} ({e}) — keeping previous generation",
              flush=True)
        return {"error": "corrupt replication snapshot rejected "
                         f"({e}); receiver keeps its previous state"}

    def _on_promote(self, msg: Message) -> bool:
        """Control.PROMOTE from the global scheduler: become the shard's
        primary under the given term.  Idempotent per term (the
        scheduler retries until acknowledged)."""
        if msg.control is not Control.PROMOTE or not msg.request:
            return False
        body = msg.body if isinstance(msg.body, dict) else {}
        term = int(body.get("term", 0))
        self._tr.instant("failover.promote", term=term)
        parked: List[tuple] = []
        with self._mu:
            if term > self.term:
                self.term = term
                was_standby, self.is_standby = self.is_standby, False
                self._fenced = False  # a promote supersedes any fence
                self.promotions += 1
                # the replicated trajectory enters the device stage NOW
                # (deferred while standby): the promoted holder resumes
                # the momentum/moments the primary was training with.
                # A live primary promoted as a drain target already runs
                # its stage, which holds the state (the host shell's was
                # handed over): re-deriving it would drop every key's
                # trajectory, its own and the adopted range's alike
                if self._dev_opt is None:
                    self._activate_dev_opt_locked()
                parked, self._parked_standby = self._parked_standby, []
                for k in list(self.store):
                    for m in self._serve_parked_pulls_locked(k):
                        self._park_pull(m)
                from geomx_tpu_torch.utils.metrics import system_counter

                system_counter(f"{self.po.node}.promotions").inc()
                if self._flight is not None:
                    self._flight.record(FlightEv.PROMOTE, a=term,
                                        c=len(self.store),
                                        peer=self.po.node,
                                        note="promoted")
                print(f"{self.po.node}: promoted to primary "
                      f"(term={term}, keys={len(self.store)}, "
                      f"repl_seq={self._repl_seq})", flush=True)
                if was_standby:
                    # where the adopted optimizer state now lives
                    dev = self._dev_opt
                    print(f"{self.po.node}: promoted optimizer state: "
                          + (dev.state_summary() if dev is not None
                             else "opt_device_keys=0"), flush=True)
        self.po.van.send(msg.reply_to(control=Control.PROMOTE, body={
            "ok": not self.is_standby, "term": self.term,
            "keys": len(self.store), "token": body.get("token")}))
        # re-dispatch traffic that raced ahead of the promotion
        for m, kv in parked:
            self._handle_inner(m, kv, self.server)
        return True

    def _on_new_primary(self, msg: Message) -> bool:
        """Control.NEW_PRIMARY broadcast: fence myself if I am the
        deposed ex-primary; adopt the promotion if I am the named new
        primary and the direct PROMOTE was lost."""
        if msg.control is not Control.NEW_PRIMARY or msg.request:
            return False
        b = msg.body if isinstance(msg.body, dict) else {}
        term = int(b.get("term", 0))
        if b.get("old") == str(self.po.node) and term > self.term:
            self._fence(f"deposed by {b.get('new')}", term)
        elif b.get("new") == str(self.po.node) and term > self.term:
            fake = Message(sender=msg.sender, recipient=self.po.node,
                           control=Control.PROMOTE, domain=Domain.GLOBAL,
                           request=True, body={"term": term})
            self._on_promote(fake)
        return True

    def _fence(self, reason: str, term: Optional[int] = None):
        """Flip into the deposed state: stop replicating, refuse data
        requests (split-brain guard for a zombie ex-primary)."""
        with self._mu:
            if term is not None:
                self.term = max(self.term, term)
            if self._fenced:
                return
            self._fenced = True
            self._fence_reason = reason
            if self._repl is not None:
                self._repl.stopped = True
        self._tr.instant("failover.fenced", term=self.term, reason=reason)
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.fenced").inc()
        if self._flight is not None:
            self._flight.record(FlightEv.FENCE, a=self.term,
                                peer=self.po.node, note="deposed")
        print(f"{self.po.node}: fenced — {reason} (term={self.term})",
              flush=True)

    def load_checkpoint(self, path: str):
        """Restore weights + optimizer + config from a checkpoint file and
        drain any pulls that parked while the state was missing.  Used by
        the Ctrl.CHECKPOINT command and launcher crash-recovery
        (GEOMX_CHECKPOINT_DIR)."""
        from geomx_tpu_torch.kvstore import checkpoint as ckpt

        store = opt = meta = None
        last_err: Optional[Exception] = None
        for i, cand in enumerate(ckpt.restore_candidates(path) or [path]):
            try:
                store, opt, meta = ckpt.load_server_state(cand)
                break
            except (ckpt.CheckpointCorruption, OSError) as e:
                # newest generation rotted (or vanished): fall back to
                # the next one that verifies instead of dying on it
                last_err = e
                self.integrity_ckpt_rejects += 1
                from geomx_tpu_torch.utils.metrics import system_counter

                system_counter(
                    f"{self.po.node}.integrity_ckpt_rejects").inc()
                if self._flight is not None:
                    self._flight.record(FlightEv.CORRUPT, a=i,
                                        note="ckpt_fallback")
                print(f"{self.po.node}: checkpoint {cand} failed "
                      f"verification ({e}); trying previous generation",
                      flush=True)
        if store is None:
            raise last_err  # no generation verified — caller surfaces it
        self._shards.drain()  # pre-restore merges must not land on the
        #                       restored state
        with self._mu:
            self._install_state_locked(store, opt, meta)
            for k in list(self.store):
                for m in self._serve_parked_pulls_locked(k):
                    self._park_pull(m)

    # ---- control ------------------------------------------------------------
    def _on_cmd(self, msg: Message):
        body = msg.body or {}
        if msg.cmd in (Ctrl.SET_OPTIMIZER, Ctrl.SET_COMPRESSION,
                       Ctrl.SET_SYNC_GLOBAL_MODE, Ctrl.CHECKPOINT):
            # program order vs. the merge lanes: an optimizer/codec/mode
            # swap (or a checkpoint snapshot) must not interleave with
            # merges queued from earlier-arrived pushes
            self._shards.drain()
        if msg.cmd == Ctrl.SET_OPTIMIZER:
            # ref: master worker pickles the optimizer, executes on the
            # global server (kvstore.py:452-499, kvstore_dist_server.h:357-364)
            with self._mu:
                self.optimizer = make_optimizer(body)
                self._optimizer_configured = True
                self._activate_dev_opt_locked()
        elif msg.cmd == Ctrl.SET_COMPRESSION:
            from geomx_tpu_torch.compression import (compression_allowed,
                                               make_push_codec)

            try:
                make_push_codec(body)  # validate
            except ValueError as e:
                self.server.reply_cmd(msg, body={"error": str(e)})
                return
            # hfa=False for the same reason as the local-server gate:
            # static HFA+bsc is the dense-bypass case
            ok, why = compression_allowed(
                body.get("type", "none"),
                inter_ts=self.ts_inter is not None)
            if not ok:
                self.server.reply_cmd(msg, body={"error": why})
                return
            with self._mu:
                if body == self.compression:
                    # idempotent: every party's rank-0 sends this; a
                    # recreation mid-training would wipe other parties'
                    # tracked subscriber views
                    self.server.reply_cmd(msg)
                    return
                self._apply_compression_locked(body)
        elif msg.cmd == Ctrl.SET_WAN_POLICY:
            self._on_set_wan_policy(msg, body)
            return
        elif msg.cmd == Ctrl.SET_SYNC_GLOBAL_MODE:
            if self.ts_inter is not None and bool(body["sync"]) != self.sync_mode:
                # local servers key their round-completion path off the
                # STATIC config; a runtime flip only we can see would
                # desync the tiers (sync→async would deadlock every
                # party's round on a dissemination that never fires)
                self.server.reply_cmd(msg, body={
                    "error": "cannot switch the global sync mode at "
                             "runtime under inter-TS — set "
                             "sync_global_mode in the static config so "
                             "all roles agree"})
                return
            self.sync_mode = bool(body["sync"])
        elif msg.cmd == Ctrl.QUERY_STATS:
            self.server.reply_cmd(msg, body=self.stats())
            return
        elif msg.cmd == Ctrl.LIST_KEYS:
            # a replacement local server's warm boot — and every serve
            # replica's refresh (geomx_tpu_torch/serve) — asks for the hosted
            # key set before pulling; ``key_rounds`` rides along so
            # replicas can stamp their copy with the round progress it
            # reflects (the version-lag observable)
            with self._mu:
                ks = sorted(int(k) for k in self.store)
                kr = self.key_rounds
            self.server.reply_cmd(msg, body={"keys": ks, "key_rounds": kr})
            return
        elif msg.cmd == Ctrl.PROFILER:
            _handle_profiler_cmd(self.po, msg, self.server)
            return
        elif msg.cmd == Ctrl.CHECKPOINT:
            from geomx_tpu_torch.kvstore import checkpoint as ckpt

            try:
                if body["action"] == "save":
                    # snapshot under the lock, serialize/write outside it —
                    # a multi-GB savez must not stall every party's round
                    with self._mu:
                        store_snap = {k: v.copy() for k, v in self.store.items()}
                        opt_snap = self._export_opt_locked()
                        meta = {"sync_mode": self.sync_mode,
                                "compression": dict(self.compression)}
                    ckpt.rotate_generations(body["path"],
                                            self.config.ckpt_generations)
                    ckpt.save_server_state(
                        body["path"], store_snap,
                        {"optimizer": opt_snap}, meta)
                elif body["action"] == "load":
                    self.load_checkpoint(body["path"])
                self.server.reply_cmd(msg, body={"ok": True})
            except Exception as e:  # surface failures to the caller
                self.server.reply_cmd(msg, body={"error": repr(e)})
            return
        self.server.reply_cmd(msg)

    def stats(self) -> dict:
        """The QUERY_STATS body — also sampled on an interval by the
        telemetry plane's MetricsPump (geomx_tpu_torch/obs)."""
        van = self.po.van
        with self._mu:
            store_b = sum(a.nbytes for a in self.store.values())
            accum_b = sum(st.accum.nbytes for st in self._keys.values()
                          if st.accum is not None)
        with self._pc_mu:
            pv_subs = (len(self.pull_comp.subscribers())
                       if self.pull_comp is not None else 0)
        return {
            "wan_send_bytes": van.wan_send_bytes,
            "wan_recv_bytes": van.wan_recv_bytes,
            "store_bytes": store_b,
            "accum_bytes": accum_b,
            # lets a central-worker deployment confirm configuration
            # landed before training starts (the reference sequences
            # this through the master worker finishing first)
            "optimizer": type(self.optimizer).__name__.lower(),
            "optimizer_configured": self._optimizer_configured,
            # device-resident optimizer stage: which DeviceOptimizer
            # closes rounds ("" = host optimizer), and how many keys'
            # trajectories live on device right now
            **(self._dev_opt.stats() if self._dev_opt is not None
               else {"opt_device": ""}),
            # forced dense resyncs of the BSC pull compressor: a
            # nonzero steady-state rate means the pull direction is
            # degrading to uncompressed (e.g. sustained overlapping
            # rounds of one key) — observability for finding that
            "pull_resyncs": (self.pull_comp.resyncs
                             if self.pull_comp is not None else 0),
            # tracked-view hygiene: distinct subscribers currently
            # pinning a pull-compressor view, and prune events (leaves /
            # folds / replica evictions) — a count that only grows as
            # subscribers churn means the leak is back
            "pull_view_subscribers": pv_subs,
            "subscriber_prunes": self.subscriber_prunes,
            # failover observability: term fencing + replication
            "term": self.term,
            "is_standby": self.is_standby,
            "promotions": self.promotions,
            "fenced_rejects": self.fenced_rejects,
            "replication_seq": self._repl_seq,
            "replication_acked_seq": (self._repl.acked_seq
                                      if self._repl is not None else 0),
            # crash-tolerant membership: reversible party folds
            "party_folds": self.party_folds,
            "party_unfolds": self.party_unfolds,
            "num_global_workers": self.num_contributors,
            # partition heals merged through the optimizer (Cmd.CATCHUP)
            "catchup_merges": self.catchup_merges,
            # data-integrity observability: gradient hygiene + verified
            # durable state (docs/deployment.md "Data integrity")
            "integrity_poison_rejects": self.integrity_poison_rejects,
            "integrity_ckpt_rejects": self.integrity_ckpt_rejects,
            "integrity_codec_rejects": self.integrity_codec_rejects,
            # adaptive WAN: receiver-side epoch + fence observables
            "policy_epoch": self._policy_epoch,
            "policy_fenced_pushes": self.policy_fenced_pushes,
            "rejected_compr_tags": self.rejected_compr_tags,
            # key-range reassignment (shard drain) observables
            "drains": self.drains,
            "merged_handoffs": self.merged_handoffs,
            "draining": self._draining,
            # round progress: completed (key, round) pairs — the health
            # engine's per-shard round-stall input
            "key_rounds": self.key_rounds,
            # restart discrimination (see LocalServer.stats)
            "uptime_s": self.po.uptime_s(),
            "boot": van.boot,
            # merge backend observability (see LocalServer._merge_stats)
            **self._merge_stats(),
        }

    def _merge_stats(self) -> dict:
        out = self._backend.stats()
        ms, h2d = out.get("merge_device_ms"), out.get("h2d_bytes")
        if ms is not None:
            from geomx_tpu_torch.utils.metrics import system_gauge

            system_gauge(f"{self.po.node}.merge_device_ms").set(ms)
            system_gauge(f"{self.po.node}.h2d_bytes").set(h2d or 0)
            # device->host traffic + optimizer-stage time: the
            # steady-state zero-D2H contract is audited on these
            system_gauge(f"{self.po.node}.d2h_bytes").set(
                out.get("d2h_bytes") or 0)
            system_gauge(f"{self.po.node}.opt_device_ms").set(
                out.get("opt_device_ms") or 0)
            # codec stage (ISSUE 20): decode kernel time + wire-ready
            # compressed D2H — host_copy auditing rides the same stats
            system_gauge(f"{self.po.node}.codec_device_ms").set(
                out.get("codec_device_ms") or 0)
            system_gauge(f"{self.po.node}.codec_d2h_bytes").set(
                out.get("codec_d2h_bytes") or 0)
        return out

    def stop(self):
        if self._repl is not None:
            self._repl.stop()
        if self._handoff_kw is not None:
            self._handoff_kw.stop()
        if self.ts_inter is not None:
            self.ts_inter.stop()
        self._shards.stop()
        self._backend.stop()
        self.server.stop()
