"""Role model, topology, and configuration surface.

The reference derives everything from environment variables parsed in
``Postoffice::InitEnvironment`` (ref: ps-lite/src/postoffice.cc:18-58) and a
catalog of feature flags (ref: docs/source/env-var-summary.rst).  We mirror
that surface — every ``DMLC_*`` / ``MXNET_*`` / feature env var has an
equivalent here — but expose it as a typed dataclass so in-process
simulations can construct configs directly without env plumbing.

Topology model (ref: README.md:14, postoffice.cc:32-58): the system is a
set of *parties* (data centers).  Each normal party has one local
scheduler, one local server, and N workers.  The *central party* has the
global scheduler, M global servers, plus its own local tier.  A local
server is simultaneously a SERVER in its party's local domain and a
"global worker" in the WAN domain (ref: van.h:98 dual node identity).

On TPU, one party = one TPU slice: the party's "workers" are the hosts of
the slice, intra-party aggregation lowers to ``jax.lax.psum`` over ICI,
and only the party's local-server process speaks WAN (DCN) to the global
servers.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional


class Role(enum.Enum):
    """Node roles (ref: ps-lite/include/ps/internal/message.h:74; the
    master worker is env-designated, ref: DMLC_ROLE_MASTER_WORKER
    postoffice.cc:32-33)."""

    WORKER = "worker"
    SERVER = "server"                    # local server (tier-1 aggregator)
    SCHEDULER = "scheduler"              # per-party local scheduler
    GLOBAL_SERVER = "global_server"      # tier-2, runs the optimizer
    GLOBAL_SCHEDULER = "global_scheduler"
    STANDBY_GLOBAL = "standby_global"    # hot standby for a global server:
    #                                      receives streamed state snapshots
    #                                      and is promoted by the global
    #                                      scheduler when its primary's
    #                                      heartbeats stop (the reference
    #                                      leaves global recovery as a TODO,
    #                                      van.cc:224)
    MASTER_WORKER = "master_worker"      # central-party control-plane
    #                                      driver: configures optimizer /
    #                                      sync modes / compression, then
    #                                      returns before training (ref:
    #                                      examples/cnn.py:96,
    #                                      DMLC_ENABLE_CENTRAL_WORKER)
    REPLICA = "replica"                  # read-serving model replica
    #                                      (geomx_tpu_torch/serve): subscribes
    #                                      to the global tier with
    #                                      staleness-bounded async pulls
    #                                      and answers high-QPS
    #                                      SERVE_PULL / PREDICT traffic
    #                                      from its local copy — the
    #                                      inference tier the training
    #                                      tree never sees

    @property
    def is_scheduler(self) -> bool:
        return self in (Role.SCHEDULER, Role.GLOBAL_SCHEDULER)


# Node groups for barriers / broadcast targets
# (ref: ps-lite/include/ps/base.h node-group constants).
class Group(enum.Flag):
    NONE = 0
    WORKERS = enum.auto()          # workers of one party
    SERVERS = enum.auto()          # the party's local server
    SCHEDULER = enum.auto()
    GLOBAL_SERVERS = enum.auto()   # all global servers (WAN domain)
    GLOBAL_WORKERS = enum.auto()   # all local servers acting as global workers
    GLOBAL_SCHEDULER = enum.auto()
    ALL_LOCAL = WORKERS | SERVERS | SCHEDULER
    ALL_GLOBAL = GLOBAL_SERVERS | GLOBAL_WORKERS | GLOBAL_SCHEDULER


@dataclasses.dataclass(frozen=True, order=True)
class NodeId:
    """Structured node identity.

    The reference packs identity into integer arithmetic (rank*2+8 etc.,
    ref: ps-lite/include/ps/base.h:36-38, postoffice.h:104-116) and parity
    tests like ``sender % 2 == 1`` scattered through the server (ref:
    kvstore_dist_server.h:471,488).  We use a structured id instead; the
    wire form is its string repr.

    ``party`` is None for WAN-domain-only roles (global scheduler / global
    servers live in the central party but are addressed domain-wide).
    """

    role: Role
    rank: int = 0
    party: Optional[int] = None

    def __str__(self) -> str:
        if self.party is None:
            return f"{self.role.value}:{self.rank}"
        return f"{self.role.value}:{self.rank}@p{self.party}"

    @staticmethod
    def parse(s: str) -> "NodeId":
        party: Optional[int] = None
        if "@p" in s:
            s, p = s.split("@p")
            party = int(p)
        role, rank = s.split(":")
        return NodeId(Role(role), int(rank), party)

    @property
    def is_worker(self) -> bool:
        return self.role is Role.WORKER

    @property
    def is_server(self) -> bool:
        return self.role is Role.SERVER

    @property
    def is_global_server(self) -> bool:
        return self.role is Role.GLOBAL_SERVER


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static cluster shape.

    ref counts: DMLC_NUM_WORKER / DMLC_NUM_SERVER / DMLC_NUM_GLOBAL_SERVER /
    DMLC_NUM_ALL_WORKER (postoffice.cc:18-58).  The reference enforces one
    local server per party (postoffice.cc:55-57); we keep that constraint
    at tier 1 and allow M global servers (MultiGPS, ref: README.md:40).
    """

    num_parties: int = 1
    workers_per_party: int = 1
    num_global_servers: int = 1
    num_standby_globals: int = 0  # hot standbys; standby rank k backs
    #                               global server rank k (promotion swaps
    #                               the node id, the key range is the
    #                               primary's own shard)
    num_replicas: int = 0  # read-serving replica tier (geomx_tpu_torch/serve):
    #                        each replica subscribes to EVERY global
    #                        shard's key range and serves pull/predict
    #                        reads from local memory; 0 (default)
    #                        constructs nothing anywhere
    central_party: int = 0  # which party hosts the global tier
    central_worker: bool = False  # add a dedicated master worker to the
    #                               central party (ref:
    #                               DMLC_ENABLE_CENTRAL_WORKER,
    #                               postoffice.cc:32-33) — a control-
    #                               plane-only node that configures the
    #                               cluster and returns before training

    def __post_init__(self):
        if self.num_parties < 1 or self.workers_per_party < 1:
            raise ValueError("need >=1 party and >=1 worker per party")
        if self.num_global_servers < 1:
            raise ValueError("need >=1 global server")
        if not 0 <= self.num_standby_globals <= self.num_global_servers:
            raise ValueError(
                "num_standby_globals must be in [0, num_global_servers]: "
                "standby rank k is the hot backup of global server rank k")
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")

    # ---- enumeration helpers -------------------------------------------------
    def workers(self, party: int):
        return [NodeId(Role.WORKER, r, party) for r in range(self.workers_per_party)]

    def all_workers(self):
        return [w for p in range(self.num_parties) for w in self.workers(p)]

    def server(self, party: int) -> NodeId:
        return NodeId(Role.SERVER, 0, party)

    def servers(self):
        return [self.server(p) for p in range(self.num_parties)]

    def scheduler(self, party: int) -> NodeId:
        return NodeId(Role.SCHEDULER, 0, party)

    def global_servers(self):
        return [NodeId(Role.GLOBAL_SERVER, r) for r in range(self.num_global_servers)]

    def global_scheduler(self) -> NodeId:
        return NodeId(Role.GLOBAL_SCHEDULER, 0)

    def standby_globals(self):
        return [NodeId(Role.STANDBY_GLOBAL, r)
                for r in range(self.num_standby_globals)]

    def standby_for(self, rank: int) -> Optional[NodeId]:
        """The hot standby backing global server ``rank`` (None if that
        shard has no standby configured)."""
        if rank < self.num_standby_globals:
            return NodeId(Role.STANDBY_GLOBAL, rank)
        return None

    def replica(self, rank: int) -> NodeId:
        return NodeId(Role.REPLICA, rank)

    def replicas(self):
        return [NodeId(Role.REPLICA, r) for r in range(self.num_replicas)]

    def master_worker(self) -> Optional[NodeId]:
        """The central party's control-plane driver, when enabled
        (ref: master worker lives in the central party and drives
        init/optimizer/compression, postoffice.cc:32-33)."""
        if not self.central_worker:
            return None
        return NodeId(Role.MASTER_WORKER, 0, self.central_party)

    def all_nodes(self):
        nodes = []
        for p in range(self.num_parties):
            nodes.append(self.scheduler(p))
            nodes.append(self.server(p))
            nodes.extend(self.workers(p))
        nodes.append(self.global_scheduler())
        nodes.extend(self.global_servers())
        mw = self.master_worker()
        if mw is not None:
            nodes.append(mw)
        # standbys (and replicas after them) LAST: the static TCP port
        # plan indexes this order, and adding either must not renumber
        # any existing node's port
        nodes.extend(self.standby_globals())
        nodes.extend(self.replicas())
        return nodes

    @property
    def num_workers_total(self) -> int:
        """ref: DMLC_NUM_ALL_WORKER."""
        return self.num_parties * self.workers_per_party

    @property
    def num_global_workers(self) -> int:
        """Local servers acting as tier-2 pushers (one per party)."""
        return self.num_parties

    def members(self, group: Group, party: Optional[int] = None):
        """Resolve a Group flag to concrete node ids.

        Local groups (WORKERS/SERVERS/SCHEDULER) require ``party``.
        """
        out = []
        if group & Group.WORKERS:
            assert party is not None
            out += self.workers(party)
        if group & Group.SERVERS:
            assert party is not None
            out.append(self.server(party))
        if group & Group.SCHEDULER:
            assert party is not None
            out.append(self.scheduler(party))
        if group & Group.GLOBAL_WORKERS:
            out += self.servers()
        if group & Group.GLOBAL_SERVERS:
            out += self.global_servers()
        if group & Group.GLOBAL_SCHEDULER:
            out.append(self.global_scheduler())
        return out


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "off", "no")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v is None else float(v)


@dataclasses.dataclass
class Config:
    """Full feature-flag / tuning surface.

    Mirrors the reference env catalog (ref: docs/source/env-var-summary.rst),
    one field per knob.  ``Config.from_env()`` accepts both the GEOMX_*
    names and the reference's legacy names where one exists.
    """

    topology: Topology = dataclasses.field(default_factory=Topology)

    # --- sync modes (ref: kvstore.cc:53-63; kvstore_dist_server.h:1918-1919)
    sync_mode: bool = True          # intra-party tier synchronous
    sync_global_mode: bool = True   # WAN tier synchronous (False = MixedSync)

    # --- HFA (ref: kvstore_dist_server.h:185-187, env MXNET_KVSTORE_USE_HFA/K1/K2)
    use_hfa: bool = False
    hfa_k1: int = 1     # local steps between local syncs (client-side)
    hfa_k2: int = 1     # local syncs between global syncs (server-side gate)

    # --- compression (ref: gradient_compression.h:38-51, examples/cnn_*.py)
    compression: str = "none"       # none | fp16 | 2bit | bsc | mpq
    bsc_ratio: float = 0.01         # Bi-Sparse keep ratio (ref: cnn_bsc.py default)
    bsc_sample_rate: float = 0.005  # threshold sampling rate (ref: gradient_compression.cc:219)
    bsc_momentum: float = 0.9       # momentum correction (ref: gradient_compression.cc:197)
    twobit_threshold: float = 0.5   # pos/neg threshold (ref: gradient_compression.cc:52)
    mpq_size_bound: int = 200_000   # MPQ small/large split (ref: kvstore_dist_server.h:183)

    # --- sharding (ref: kvstore_dist.h:69 MXNET_KVSTORE_BIGARRAY_BOUND)
    bigarray_bound: int = 1_000_000
    # --- horizontal global tier (MultiGPS, ref: README.md:40 /
    # Postoffice::GetServerKeyRanges postoffice.cc:246-259).  The
    # first-class knob for "how many independent global servers shard
    # the key space": 0 = follow topology.num_global_servers.  A
    # positive value (field or GEOMX_GLOBAL_SHARDS) re-shards an
    # UNSHARDED topology (num_global_servers == 1) to M shards, each
    # with its own key range, standby chain and failure domain — a
    # topology constructed with an explicit num_global_servers > 1
    # always wins.  The env fallback mirrors GEOMX_SERVER_SHARDS: a
    # whole test suite can be shaken under a sharded global tier
    # (GEOMX_GLOBAL_SHARDS=2 pytest ...) without threading the knob
    # through every fixture (scripts/run_shard_smoke.sh).
    global_shards: int = 0

    # --- P3 (ref: van.cc:539-549 ENABLE_P3; kvstore_dist.h:763-799)
    enable_p3: bool = False
    p3_slice_elems: int = 0  # 0 → use bigarray_bound as slice size

    # --- TSEngine (ref: kv_app.h:111-112,434-435; van.cc:436-443)
    enable_intra_ts: bool = False
    enable_inter_ts: bool = False
    ts_max_greed_rate: float = 0.9
    # under an async global tier, disseminate at most once per this many
    # pushes (per-push dissemination would flood the WAN overlay)
    inter_ts_async_every: int = 8
    # inter-party push-direction overlay: local servers pair-merge their
    # party gradients over the WAN before one elected server pushes to
    # the global tier (ref: global ASK_PUSH van.cc:1254-1310)
    enable_inter_ts_push: bool = False
    # overlay timeouts (VERDICT r1: previously hard-coded — a wedged
    # overlay stalled a worker 2 minutes before erroring).
    # pair TTL must stay BELOW the ask timeout: a pairing that outlives
    # the partner's patience would merge with a peer that already gave up
    ts_relay_wait_s: float = 120.0   # worker wait on the relay buffer
    ts_ask_timeout_s: float = 30.0   # scheduler ask / merge-wait timeout
    ts_push_pair_ttl_s: float = 25.0

    # --- DGT (ref: kv_app.h:841-850)
    enable_dgt: int = 0           # 0 off; 1 UDP-like lossy; 2 reliable; 3 reliable+requant
    dgt_block_size: int = 4096    # elements per chunk
    dgt_k: float = 0.5            # initial fraction on the reliable channel
    dgt_k_min: float = 0.2
    dgt_adaptive_k: bool = False
    dgt_k_anneal_steps: int = 1000  # pushes over which adaptive k decays
    #                                 k -> k_min (ref: ADAPTIVE_K_FLAG
    #                                 anneals with iteration)
    dgt_udp_channels: int = 3
    dgt_contrib_alpha: float = 0.3

    # --- fault injection / reliability (ref: van.cc:497-533 PS_DROP_MSG, PS_RESEND)
    drop_rate: float = 0.0
    channel_drop_rate: float = 0.0  # loss injection for DGT's lossy
    #                                 channels (>=1) — deterministic loss
    #                                 for tests where real UDP on
    #                                 loopback would rarely drop
    resend_timeout_ms: int = 0    # 0 = resender off

    # --- elastic recovery (improvement over the reference, whose recovery
    # is scheduler id-reassignment only, ref: van.cc:176-193; global-tier
    # recovery is a TODO there, van.cc:224)
    request_retry_s: float = 0.0  # 0 = off; else re-send unanswered
    #                               requests after this many seconds
    #                               (application-level replay; servers
    #                               dedup by (sender, ts))
    retry_backoff_cap: int = 8    # replay backoff multiplier cap: the
    #                               n-th unanswered replay waits
    #                               request_retry_s * min(2**n, cap).
    #                               Chaos soaks tighten it so a killed
    #                               shard's replays land inside the test
    #                               window (GEOMX_RETRY_BACKOFF_CAP)
    retry_jitter: float = 0.1     # random extra fraction [0, jitter)
    #                               added to each replay backoff so a
    #                               whole party's replays don't
    #                               stampede a freshly promoted shard
    #                               in lockstep.  Deterministic mode
    #                               forces 0 (GEOMX_RETRY_JITTER)
    policy_fence_max_retries: int = 5  # adaptive-WAN fence retries per
    #                               push group before the loud drop
    #                               (GEOMX_POLICY_FENCE_MAX_RETRIES)
    checkpoint_dir: str = ""      # where global servers save/resume state
    auto_ckpt_updates: int = 0    # 0 = off; else checkpoint every N
    #                               optimizer updates (key-rounds)
    replicate_every: int = 1      # global-tier hot-standby replication:
    #                               stream a state snapshot to the standby
    #                               every N optimizer updates (key-rounds).
    #                               Only active when the topology has
    #                               standbys; N bounds the state lost on
    #                               failover to the rounds since the last
    #                               shipped snapshot

    # --- event-driven transport core (transport/reactor.py).  "threads"
    # (default) keeps the pre-reactor behavior: recv/send/resend threads
    # per Van, one accept loop + one recv thread PER CONNECTION in the
    # TcpFabric, a sleep-loop thread per monitor/pump.  "reactor" routes
    # every TcpFabric endpoint through a per-process Reactor (a small
    # fixed pool of selector loop threads + one timer wheel) and flips
    # in-proc Simulations into lightweight-party mode (below), so the
    # process runs O(GEOMX_REACTOR_LOOPS + handler pool) threads instead
    # of O(nodes + connections).  "" = follow GEOMX_TRANSPORT (default
    # threads until the reactor path has soaked — scripts/
    # run_reactor_smoke.sh runs the parity suites under it).
    transport: str = ""
    reactor_loops: int = 0  # selector loop threads; 0 = auto
    #                         (GEOMX_REACTOR_LOOPS, min(4, cpus))
    lightweight: bool = False  # lightweight-party mode for the in-proc
    #                            Simulation: all nodes share the process
    #                            Reactor — per-node van-recv / customer
    #                            threads become serial dispatch channels
    #                            on the shared handler pool, heartbeat /
    #                            resend / monitor loops become timer-
    #                            wheel entries, and server merge lanes
    #                            run inline (server_shards forced to 1,
    #                            like deterministic) — so an O(100)-party
    #                            topology fits one host.  Implied by
    #                            transport=reactor for Simulations;
    #                            GEOMX_LIGHTWEIGHT=1 forces it alone.
    # --- misc runtime
    deterministic: bool = False  # NaiveEngine-analog debug mode (ref:
    #                              src/engine/naive_engine.cc,
    #                              MXNET_ENGINE_TYPE): ONE dispatcher
    #                              thread processes every node's inbound
    #                              messages in global FIFO order and
    #                              customers handle inline, so a race
    #                              reproduces identically run-to-run.
    #                              In-proc sim only; latency injection is
    #                              ignored in this mode
    server_merge_threads: int = 0  # native threads per server merge of a
    #                                big tensor (0 = one per core; 1 =
    #                                single-threaded).  Parallelism lives
    #                                INSIDE each merge (native axpy) so
    #                                the per-key state machines stay
    #                                single-writer (ref: engine-pool
    #                                merge, kvstore_dist_server.h:1277-1296).
    #                                Also sizes the shared per-key codec
    #                                pool (parallel WAN encode/decode)
    server_shards: int = 0  # key-sharded server merge: per-key state
    #                         splits into N lock stripes with N serial
    #                         merge lanes, so concurrent pushes touching
    #                         disjoint keys merge in parallel (0 = auto
    #                         min(8, cpus); 1 = the single-lock server).
    #                         Membership folds / eviction fences / round
    #                         completion take an all-stripes barrier, so
    #                         decide-under-lock semantics are unchanged.
    #                         Deterministic mode forces 1 (see
    #                         kvstore.common.resolve_server_shards)
    merge_backend: str = "auto"  # server merge lane engine
    #                              (kvstore/backend.py): "numpy" = the
    #                              host reference path (native threaded
    #                              axpy; bit-identical to the
    #                              pre-backend servers), "jax" = staged
    #                              H2D + jitted donated-argument
    #                              accumulate, party aggregation as
    #                              shard_map+psum over the device mesh,
    #                              "auto" = jax iff an accelerator
    #                              backend is live (TPU/GPU), else
    #                              numpy.  Deterministic mode FORCES
    #                              numpy.  GEOMX_MERGE_BACKEND is
    #                              honored as an env fallback for
    #                              directly-constructed Configs (see
    #                              kvstore.backend.resolve_merge_backend)
    merge_quantized: bool = False  # EQuARX-style rung for the jax
    #                                backend's mesh collective: route
    #                                party aggregation through the int8
    #                                block-quantized psum
    #                                (parallel/quantized_allreduce.py)
    #                                instead of the exact f32 psum.
    #                                Opt-in: bounded quantization error
    #                                per round (docs/merge-backends.md)
    merge_residual: bool = True  # error-feedback residual for the
    #                              quantized rung (EQuARX, PAPERS.md):
    #                              each device slot keeps residual =
    #                              pre-quant minus dequantized and folds
    #                              it into the NEXT round's contribution
    #                              before quantizing, so the int8
    #                              collective is accuracy-neutral over a
    #                              run instead of systematically zeroing
    #                              sub-threshold gradient components.
    #                              Only meaningful with merge_quantized;
    #                              GEOMX_MERGE_RESIDUAL=0 disables (the
    #                              drift-control test does)
    merge_opt_device: bool = True  # device-resident optimizer stage for
    #                                the jax merge backend: SET_OPTIMIZER
    #                                specs the DeviceOptimizer family
    #                                supports (sgd/momentum/nag/adam)
    #                                keep per-key weights + moments on
    #                                device and close each round with
    #                                one jitted donated update — no D2H
    #                                on the hot path; host copies happen
    #                                only at serve/checkpoint/handoff
    #                                events (docs/merge-backends.md).
    #                                No effect under the numpy backend;
    #                                GEOMX_MERGE_OPT_DEVICE=0 keeps the
    #                                jax backend's optimizer on the host
    codec_device: bool = True  # device-resident WAN codec stage for the
    #                            jax merge backend: encode reads the
    #                            device merge accumulator directly
    #                            (jitted top-k / quantize kernels) and
    #                            materializes only the wire-ready
    #                            compressed payload; decode runs jitted
    #                            dequantize/scatter and lands the grads
    #                            straight in device merge buffers via
    #                            seed().  Wire format is bit-identical
    #                            to the numpy codecs (cross-decode
    #                            parity is tested).  No effect under the
    #                            numpy backend; deterministic mode
    #                            forces numpy codecs.
    #                            GEOMX_CODEC_DEVICE=0 keeps the codec
    #                            pass on the host (see
    #                            kvstore.backend.resolve_codec_device)
    heartbeat_interval_s: float = 0.0   # 0 = off
    heartbeat_timeout_s: float = 10.0
    # --- crash-tolerant membership (heartbeat-driven ACTUATION; requires
    # heartbeat_interval_s > 0).  When on, each party scheduler turns an
    # expired worker heartbeat into a synthesized forced leave (rounds and
    # barriers fold to the survivor set; the corpse's later pushes are
    # fenced until it rejoins), and the global scheduler folds a party
    # whose local server died out of global rounds, then warm-boots the
    # replacement and folds the party back in (kvstore/eviction.py)
    enable_eviction: bool = True
    eviction_check_interval_s: float = 0.0  # detector sweep period;
    #                                         0 = follow heartbeat_interval_s
    # --- graceful preemption drain (Control.PREEMPT_NOTICE; see
    # docs/deployment.md "Elasticity & preemption").  Real spot
    # preemptions come with a notice (30 s - 2 min): a noticed worker
    # finishes its in-flight step, flushes un-ACKed pushes and leaves
    # the party gracefully (the server folds it out IMMEDIATELY instead
    # of stalling rounds until heartbeat expiry); a noticed local
    # server drains its WAN round and hands its party fold to the
    # global tier proactively.  launch.py maps SIGTERM onto this path
    # when enabled (SIGKILL stays the ungraceful eviction path).  Off
    # (default): no notice hooks are registered anywhere — the
    # eviction/rejoin machinery behaves exactly as before.
    enable_preempt: bool = False
    preempt_drain_s: float = 30.0  # drain window budget: how long a
    #                                noticed node may spend flushing
    #                                before it leaves anyway, and how
    #                                long the party scheduler holds
    #                                eviction for a draining member
    # --- partition tolerance (Control.PROBE_INDIRECT + Cmd.CATCHUP; see
    # docs/deployment.md "Partition tolerance").  When on, a heartbeat-
    # expired node is not immediately evicted: the monitor asks k peers
    # to relay a SWIM-style indirect probe, and if any peer still hears
    # the suspect it is QUARANTINED — folded out of rounds/barriers
    # reversibly, incarnation NOT fenced — instead of evicted.  A
    # quarantined party's local server keeps closing degraded-mode
    # rounds against a frozen model, accumulating a bounded per-key
    # gradient delta it ships as one staleness-stamped catch-up push on
    # heal (dense warm boot only past the bound).  Off (default): the
    # legacy expire→evict path is untouched — no probes, no new state.
    enable_partition_mode: bool = False
    probe_indirect_k: int = 2       # peers asked to relay each probe
    probe_timeout_s: float = 0.5    # per-relay ping wait at the peer
    partition_catchup_bound: int = 50  # max degraded rounds a catch-up
    #                                    delta may cover before the heal
    #                                    falls back to a dense resync
    #                                    (warm boot); 0 = always dense
    partition_degrade_s: float = 0.0  # WAN-silence window before a
    #                                   local server with stuck un-ACKed
    #                                   pushes enters degraded mode;
    #                                   0 = follow max(heartbeat_
    #                                   timeout_s, 1.0)
    # --- data-integrity plane (docs/deployment.md "Data integrity").
    # integrity_push_screen: servers screen every gradient push for
    # NaN/Inf (and |g| > poison_mag_max when set) BEFORE it merges — a
    # poisoned push is zeroed out of the round (so sync accounting
    # still completes) and answered with a typed error; a sender
    # crossing poison_quarantine_n strikes is QUARANTINED through the
    # reversible fold machinery, never evicted.  The wire-checksum and
    # checkpoint-stamp halves of the plane are process-wide encode
    # decisions and live on env flags read at import
    # (GEOMX_INTEGRITY_WIRE in transport/message.py,
    # GEOMX_INTEGRITY_CKPT in kvstore/checkpoint.py).  All default OFF:
    # flags off is bit-for-bit legacy behavior.
    integrity_push_screen: bool = False
    poison_quarantine_n: int = 3    # strikes before the sender is
    #                                 quarantined (0 = never quarantine,
    #                                 just reject each poisoned push)
    poison_mag_max: float = 0.0     # reject |gradient| above this too;
    #                                 0 = finiteness screen only
    ckpt_generations: int = 1       # on-disk checkpoint generations to
    #                                 retain; restore falls back to the
    #                                 newest one that verifies
    obs_corruption_events: int = 8  # data_corruption health rule: total
    #                                 integrity rejects per node over the
    #                                 collector window before the engine
    #                                 pages
    # --- distributed tracing (geomx_tpu_torch/trace; beyond the reference —
    # its profiler is per-process only).  trace_sample_every = N traces
    # every N-th synchronization round end-to-end: causal spans ride the
    # messages, a collector on the global scheduler merges all nodes'
    # spans into one clock-corrected timeline plus a per-round
    # critical-path report.  0 (default) = off; the disabled hot path is
    # a single flag check per message, no allocation.
    trace_sample_every: int = 0
    trace_dir: str = ""          # launch.py dumps the merged trace +
    #                              critical-path report here at shutdown
    trace_batch_events: int = 256  # spans per TRACE_REPORT batch
    # --- adaptive WAN control plane (geomx_tpu_torch/control; beyond the
    # reference, whose codec/ratio choice is fixed at launch).  When on,
    # a controller on the global scheduler samples per-link goodput /
    # RTT / round-rate signals and retunes the WAN codec tier mid-
    # training via an epoch-fenced Ctrl.SET_WAN_POLICY broadcast (see
    # docs/adaptive-wan.md).  Off (default) = zero new work on any
    # message path beyond a single flag check.
    adaptive_wan: bool = False
    adapt_interval_s: float = 1.0   # controller sampling period; 0 =
    #                                 no sweep thread (manual tick only —
    #                                 what deterministic tests use)
    adapt_round_budget_s: float = 0.0  # target WAN round time; 0 = auto-
    #                                    calibrate to 1.5x the median of
    #                                    the first observation window
    adapt_deadband: float = 0.25    # hysteresis band around the budget:
    #                                 no action while round time is within
    #                                 budget*(1±deadband)
    adapt_cooldown_s: float = 5.0   # min seconds between policy changes
    adapt_window: int = 8           # sliding-window length (samples)
    # --- cluster telemetry plane (geomx_tpu_torch/obs; beyond the reference,
    # whose monitoring is per-process profiler dumps).  When on, every
    # node runs a MetricsPump shipping registry + role-stats samples as
    # METRICS_REPORT frames to a MetricsCollector on the global
    # scheduler, and a HealthEngine evaluates SLO rules (round stall,
    # replication lag, goodput collapse, RTT outliers, fence spikes)
    # over the collected series.  Off (default) = no pump, no collector,
    # no threads, no frames — one flag check at construction time.  The
    # Ctrl.CLUSTER_STATE console is independent of this flag (it costs
    # nothing until queried).  See docs/observability.md.
    enable_obs: bool = False
    obs_interval_s: float = 1.0     # pump/health cadence; 0 = no sweep
    #                                 threads (manual ship()/tick() only —
    #                                 what deterministic tests use)
    obs_window: int = 256           # ring-buffered samples kept per node
    obs_alert_log: str = ""         # JSONL alert/recovery record log path
    obs_stall_factor: float = 4.0   # round-stall: k x rolling-median gap
    obs_stall_min_s: float = 2.0    # round-stall floor (seconds)
    obs_repl_lag_s: float = 60.0    # replication-lag alert ceiling
    obs_rtt_s: float = 1.0          # heartbeat-RTT alert ceiling
    obs_goodput_frac: float = 0.1   # goodput-collapse fraction of peak
    obs_fence_spike: int = 8        # fenced/evicted events per window
    obs_imbalance_factor: float = 4.0  # slowest-shard busy vs peer mean
    obs_churn_storm: int = 16       # churn_storm rule: membership events
    #                                 (leaves+kills+joins, injected or
    #                                 organic) per collector window before
    #                                 the health engine pages; the rule
    #                                 also fires when the churn
    #                                 orchestrator's survivor gauge
    #                                 reaches its min-survivor floor
    obs_flight_cooldown_s: float = 60.0  # min seconds between flight-
    #                                 dump broadcasts for ONE (rule,
    #                                 subject): the first firing
    #                                 captures the incident window; a
    #                                 flapping warn rule must not flood
    #                                 GEOMX_OBS_DIR with a dump per
    #                                 transition.  0 = dump on every
    #                                 firing transition (tests)
    # --- black-box flight recorder (geomx_tpu_torch/obs/flight.py).  DEFAULT
    # ON: every node keeps a fixed-size ring of structured events
    # (message heads, fences, barriers, membership/failover
    # transitions, round open/complete, sampled pressure readings) in
    # preallocated slots — no per-event allocation, <2% round-wall
    # overhead (bench.py flight).  Rings dump to GEOMX_OBS_DIR on
    # process exit/signal, on a HealthEngine alert transition
    # (Control.FLIGHT_DUMP broadcast — every node snapshots the same
    # incident window), and on operator request (python -m
    # geomx_tpu_torch.status --dump-flight); python -m geomx_tpu_torch.obs.postmortem
    # assembles the dumps into one causal timeline.  None = follow
    # GEOMX_FLIGHT (default on); an explicit True/False wins over env.
    # GEOMX_FLIGHT=0 constructs nothing anywhere.
    enable_flight: Optional[bool] = None
    flight_events: int = 4096       # ring capacity (events) per node
    flight_sample_s: float = 0.0    # dedicated pressure-sampler thread
    #                                 cadence; 0 (default) = sample on
    #                                 the metrics-pump cadence and at
    #                                 dump time only (no extra thread)
    # --- read-serving replica tier (geomx_tpu_torch/serve; beyond the
    # reference, which is train-only).  Replicas (Topology.num_replicas /
    # GEOMX_SERVE_REPLICAS / launch.py --replicas) keep a full local copy
    # of the model refreshed by staleness-bounded async pulls from the
    # global tier (BroadcastCompressor sparse deltas + the dense-resync
    # version handshake) and answer Cmd.SERVE_PULL / Cmd.PREDICT read
    # traffic from memory.  A read NEVER sees a copy older than
    # serve_staleness_s: a read arriving while the copy is stale parks
    # until the next refresh lands (or errors after the bound passes
    # again with the global tier unreachable).
    serve_staleness_s: float = 5.0      # the staleness bound (seconds)
    serve_refresh_interval_s: float = 0.5  # refresh cadence; clamped to
    #                                     at most serve_staleness_s / 2;
    #                                     0 = no refresh thread (manual
    #                                     refresh() only — what the
    #                                     deterministic tests drive)
    # --- self-healing serving plane (geomx_tpu_torch/serve: balancer.py /
    # autoscaler.py + replica-side admission control; docs/serving.md
    # "Serving plane").  The TensorFlow-paper posture: degrade by
    # REFUSING work with an explicit retry signal (RETRY_AFTER sheds),
    # never by missing every deadline, and keep capacity elastic.
    serve_max_inflight: int = 0       # replica admission budget: pending
    #                                   reads (queued + parked + batch)
    #                                   past it are answered with an
    #                                   explicit RETRY_AFTER shed error
    #                                   instead of queueing unboundedly.
    #                                   0 (default) = admission control
    #                                   OFF — bit-for-bit the PR 8 path
    serve_retry_after_s: float = 0.05  # suggested backoff carried in
    #                                   shed errors (clients add jitter)
    serve_batch_max: int = 0          # PREDICT batching: aggregate up to
    #                                   this many compatible requests
    #                                   into one forward pass; <=1 = off
    serve_batch_wait_ms: float = 2.0  # batch latency budget: a pending
    #                                   batch flushes after this long
    #                                   even if not full
    serve_lb_refresh_s: float = 1.0   # balancer cluster-state view
    #                                   cache: refreshed at most this
    #                                   often (Ctrl.CLUSTER_STATE query)
    serve_eject_errors: int = 3       # consecutive failures before the
    #                                   balancer ejects a replica from
    #                                   the candidate set
    serve_probe_s: float = 1.0        # half-open probe backoff: an
    #                                   ejected replica gets one trial
    #                                   read after this long
    serve_attempt_timeout_s: float = 1.0  # balancer per-ATTEMPT read
    #                                   timeout: the first failure on a
    #                                   dead target triggers an immediate
    #                                   re-pick instead of burning the
    #                                   caller's whole deadline
    serve_autoscale: bool = False     # ReplicaAutoscaler on the global
    #                                   scheduler (needs enable_obs: it
    #                                   reads the collector's series)
    serve_min_replicas: int = 1       # autoscaler floor (active replicas)
    serve_max_replicas: int = 0       # autoscaler ceiling; 0 = follow
    #                                   topology.num_replicas
    serve_scale_interval_s: float = 0.0  # autoscaler sweep cadence;
    #                                   0 = manual tick() (tests)
    serve_scale_cooldown_s: float = 5.0  # min seconds between scaling
    #                                   actions (the WanPolicyEngine
    #                                   hysteresis discipline)
    serve_scale_patience: int = 2     # consecutive out-of-band sweeps
    #                                   before scaling up (down needs 2x:
    #                                   shrinking is the risky direction)
    serve_target_qps: float = 0.0     # per-replica serve QPS target the
    #                                   autoscaler sizes against; 0 =
    #                                   shed/staleness/p99-driven only
    #                                   (no QPS-based scale-down)
    serve_scale_p99_ms: float = 0.0   # p99 read-latency ceiling that
    #                                   counts as overload; 0 = off
    obs_shed_rate: float = 2.0        # serve_overload health rule:
    #                                   sustained sheds/s per replica
    #                                   over the collector window
    obs_replica_flap: int = 2         # replica_flap health rule:
    #                                   autoscaler direction reversals
    #                                   inside cooldown per window
    verbose: int = 0

    def __post_init__(self):
        # resolve the global-shard count: explicit field, else env
        # (GEOMX_GLOBAL_SHARDS shakes directly-constructed configs too),
        # applied only to an UNSHARDED topology — a test or launcher
        # that spelled out num_global_servers keeps exactly that shape
        shards = int(self.global_shards or 0)
        if shards <= 0:
            shards = _env_int("GEOMX_GLOBAL_SHARDS", 0)
        if shards < 0:
            raise ValueError("global_shards must be >= 0 (0 = follow "
                             "topology.num_global_servers)")
        if shards >= 1 and self.topology.num_global_servers == 1 \
                and shards != self.topology.num_global_servers:
            self.topology = dataclasses.replace(
                self.topology, num_global_servers=shards)
        self.global_shards = self.topology.num_global_servers
        # replica-count env fallback (mirrors GEOMX_GLOBAL_SHARDS): a
        # directly-constructed Config grows a replica tier from
        # GEOMX_SERVE_REPLICAS without threading the knob through every
        # fixture; an explicit topology count wins
        if self.topology.num_replicas == 0:
            reps = _env_int("GEOMX_SERVE_REPLICAS", 0)
            if reps > 0:
                self.topology = dataclasses.replace(
                    self.topology, num_replicas=reps)
        # env overrides for the replay/backoff tuning knobs (the chaos
        # soaks tighten these without editing source; env wins so one
        # shell line covers directly-constructed Configs too)
        self.retry_backoff_cap = _env_int(
            "GEOMX_RETRY_BACKOFF_CAP", self.retry_backoff_cap)
        self.retry_jitter = _env_float(
            "GEOMX_RETRY_JITTER", self.retry_jitter)
        self.policy_fence_max_retries = _env_int(
            "GEOMX_POLICY_FENCE_MAX_RETRIES", self.policy_fence_max_retries)
        # partition-tolerance knobs follow the same env-wins idiom so the
        # chaos soaks and demo scripts reach directly-constructed Configs
        self.enable_partition_mode = _env_bool(
            "GEOMX_PARTITION_MODE", self.enable_partition_mode)
        self.probe_indirect_k = _env_int(
            "GEOMX_PROBE_K", self.probe_indirect_k)
        self.probe_timeout_s = _env_float(
            "GEOMX_PROBE_TIMEOUT_S", self.probe_timeout_s)
        self.partition_catchup_bound = _env_int(
            "GEOMX_PARTITION_CATCHUP_BOUND", self.partition_catchup_bound)
        self.partition_degrade_s = _env_float(
            "GEOMX_PARTITION_DEGRADE_S", self.partition_degrade_s)
        self.integrity_push_screen = _env_bool(
            "GEOMX_INTEGRITY_PUSH_SCREEN", self.integrity_push_screen)
        self.poison_quarantine_n = _env_int(
            "GEOMX_POISON_QUARANTINE_N", self.poison_quarantine_n)
        self.poison_mag_max = _env_float(
            "GEOMX_POISON_MAG_MAX", self.poison_mag_max)
        self.ckpt_generations = _env_int(
            "GEOMX_CKPT_GENERATIONS", self.ckpt_generations)
        self.obs_corruption_events = _env_int(
            "GEOMX_OBS_CORRUPTION_EVENTS", self.obs_corruption_events)
        if self.poison_quarantine_n < 0:
            raise ValueError("poison_quarantine_n must be >= 0 "
                             "(0 = reject poisoned pushes but never "
                             "quarantine the sender)")
        if self.poison_mag_max < 0.0:
            raise ValueError("poison_mag_max must be >= 0 "
                             "(0 = finiteness screen only)")
        if self.ckpt_generations < 1:
            raise ValueError("ckpt_generations must be >= 1")
        if self.probe_indirect_k < 1:
            raise ValueError("probe_indirect_k must be >= 1")
        if self.probe_timeout_s <= 0.0:
            raise ValueError("probe_timeout_s must be > 0")
        if self.partition_catchup_bound < 0:
            raise ValueError(
                "partition_catchup_bound must be >= 0 (0 = always fall "
                "back to a dense resync on heal)")
        if self.partition_degrade_s < 0.0:
            raise ValueError("partition_degrade_s must be >= 0 "
                             "(0 = follow max(heartbeat_timeout_s, 1.0))")
        if self.retry_backoff_cap < 1:
            raise ValueError("retry_backoff_cap must be >= 1")
        if self.retry_jitter < 0.0:
            raise ValueError("retry_jitter must be >= 0")
        if self.policy_fence_max_retries < 0:
            raise ValueError("policy_fence_max_retries must be >= 0")
        if not 0.0 <= self.drop_rate <= 1.0:
            raise ValueError(
                f"drop_rate must be a fraction in [0,1], got {self.drop_rate} "
                "(note: the GEOMX_DROP_MSG / PS_DROP_MSG env vars are percents)"
            )
        if not 0.0 <= self.channel_drop_rate <= 1.0:
            raise ValueError(
                "channel_drop_rate must be a fraction in [0,1], got "
                f"{self.channel_drop_rate} (note: GEOMX_CHANNEL_DROP_MSG "
                "is a percent)"
            )
        if self.inter_ts_async_every < 1:
            raise ValueError("inter_ts_async_every must be >= 1")
        if self.enable_inter_ts_push:
            if not self.enable_inter_ts or not self.sync_global_mode:
                raise ValueError(
                    "enable_inter_ts_push requires enable_inter_ts with a "
                    "synchronous global tier: non-elected servers finish "
                    "their rounds via the pull-direction dissemination")
            if self.use_hfa:
                raise ValueError(
                    "enable_inter_ts_push cannot combine with HFA "
                    "(milestone deltas bypass the merge overlay)")
        if self.enable_p3 and self.enable_intra_ts:
            raise ValueError(
                "enable_p3 and enable_intra_ts are mutually exclusive "
                "accelerations: P3's piggybacked pulls bypass the TS "
                "overlay, and the merge tree bypasses P3's sliced sends")
        # codec × mode compatibility lives in ONE shared predicate (also
        # used by the runtime SET_COMPRESSION/SET_WAN_POLICY gates and
        # the adaptive policy engine), so the rules can't drift.
        # hfa=False here: a STATIC HFA+bsc config is legal — the HFA
        # data path bypasses gradient codecs with dense exchanges (see
        # the predicate's docstring); only runtime RETUNING under HFA is
        # restricted to weight-safe codecs
        from geomx_tpu_torch.compression.codecs import compression_allowed

        ok, reason = compression_allowed(
            self.compression, inter_ts=self.enable_inter_ts)
        if not ok:
            raise ValueError(reason)
        if self.adapt_deadband < 0.0 or self.adapt_deadband >= 1.0:
            raise ValueError("adapt_deadband must be in [0, 1)")
        if self.adapt_window < 2:
            raise ValueError("adapt_window must be >= 2")
        if self.obs_interval_s < 0:
            raise ValueError("obs_interval_s must be >= 0 (0 = manual)")
        # flight recorder: None = follow the env (default ON — the
        # whole point is evidence for failures nobody predicted); an
        # explicitly constructed True/False wins, so GEOMX_FLIGHT=0 can
        # shake the suite without defeating the disabled-path tests
        if self.enable_flight is None:
            self.enable_flight = _env_bool("GEOMX_FLIGHT", True)
        if self.flight_events < 8:
            raise ValueError("flight_events must be >= 8 (the ring must "
                             "hold a useful window)")
        if self.flight_sample_s < 0:
            raise ValueError("flight_sample_s must be >= 0 (0 = sample "
                             "on the pump cadence / at dump time)")
        if self.obs_window < 8:
            raise ValueError("obs_window must be >= 8 (rate math needs "
                             "a real ring)")
        if self.preempt_drain_s <= 0:
            raise ValueError("preempt_drain_s must be > 0 (the graceful "
                             "drain window)")
        if self.obs_churn_storm < 1:
            raise ValueError("obs_churn_storm must be >= 1")
        if self.obs_stall_factor < 1.0 or self.obs_stall_min_s < 0:
            raise ValueError("round-stall thresholds must be "
                             "obs_stall_factor >= 1, obs_stall_min_s >= 0")
        if not 0.0 < self.obs_goodput_frac < 1.0:
            raise ValueError("obs_goodput_frac must be in (0, 1)")
        if self.replicate_every < 1:
            raise ValueError("replicate_every must be >= 1")
        if self.serve_staleness_s <= 0:
            raise ValueError("serve_staleness_s must be > 0 (the replica "
                             "read-staleness bound)")
        if self.serve_refresh_interval_s < 0:
            raise ValueError("serve_refresh_interval_s must be >= 0 "
                             "(0 = manual refresh)")
        if self.serve_max_inflight < 0:
            raise ValueError("serve_max_inflight must be >= 0 "
                             "(0 = admission control off)")
        if self.serve_retry_after_s <= 0:
            raise ValueError("serve_retry_after_s must be > 0 (the shed "
                             "errors carry it as the suggested backoff)")
        if self.serve_batch_max < 0 or self.serve_batch_wait_ms < 0:
            raise ValueError("serve_batch_max and serve_batch_wait_ms "
                             "must be >= 0")
        if self.serve_eject_errors < 1:
            raise ValueError("serve_eject_errors must be >= 1")
        if self.serve_probe_s <= 0 or self.serve_attempt_timeout_s <= 0:
            raise ValueError("serve_probe_s and serve_attempt_timeout_s "
                             "must be > 0")
        if self.serve_lb_refresh_s < 0:
            raise ValueError("serve_lb_refresh_s must be >= 0")
        if self.serve_min_replicas < 1:
            raise ValueError("serve_min_replicas must be >= 1 (the "
                             "serving tier never scales to zero)")
        if self.serve_max_replicas < 0:
            raise ValueError("serve_max_replicas must be >= 0 "
                             "(0 = follow topology.num_replicas)")
        if self.serve_scale_interval_s < 0 \
                or self.serve_scale_cooldown_s < 0:
            raise ValueError("serve_scale_interval_s and "
                             "serve_scale_cooldown_s must be >= 0")
        if self.serve_scale_patience < 1:
            raise ValueError("serve_scale_patience must be >= 1")
        if self.serve_target_qps < 0 or self.serve_scale_p99_ms < 0:
            raise ValueError("serve_target_qps and serve_scale_p99_ms "
                             "must be >= 0 (0 = off)")
        if self.obs_shed_rate <= 0:
            raise ValueError("obs_shed_rate must be > 0")
        if self.obs_replica_flap < 1:
            raise ValueError("obs_replica_flap must be >= 1")
        if self.server_shards < 0:
            raise ValueError("server_shards must be >= 0 (0 = auto)")
        if self.transport not in ("", "threads", "reactor"):
            raise ValueError(
                f"transport must be '', 'threads' or 'reactor', got "
                f"{self.transport!r}")
        if self.reactor_loops < 0:
            raise ValueError("reactor_loops must be >= 0 (0 = auto)")
        # lightweight-mode env fallback (mirrors GEOMX_GLOBAL_SHARDS):
        # directly-constructed Configs go lightweight under
        # GEOMX_LIGHTWEIGHT=1 without threading the knob through fixtures
        if not self.lightweight:
            self.lightweight = _env_bool("GEOMX_LIGHTWEIGHT", False)
        if self.trace_sample_every < 0:
            raise ValueError("trace_sample_every must be >= 0 (0 = off)")
        if self.trace_batch_events < 1:
            raise ValueError("trace_batch_events must be >= 1")
        if self.topology.num_standby_globals and self.request_retry_s <= 0:
            # failover's client-side replay rides the request-retry
            # inflight table; a standby without it would promote cleanly
            # but wedge every round that was in flight at the kill
            self.request_retry_s = 5.0

    @staticmethod
    def from_env() -> "Config":
        topo = Topology(
            num_parties=_env_int("GEOMX_NUM_PARTIES", 1),
            workers_per_party=_env_int(
                "GEOMX_WORKERS_PER_PARTY", _env_int("DMLC_NUM_WORKER", 1)
            ),
            num_global_servers=_env_int(
                "GEOMX_GLOBAL_SHARDS",
                _env_int("GEOMX_NUM_GLOBAL_SERVERS",
                         _env_int("DMLC_NUM_GLOBAL_SERVER", 1)),
            ),
            num_standby_globals=_env_int("GEOMX_NUM_STANDBY_GLOBALS", 0),
            num_replicas=_env_int("GEOMX_SERVE_REPLICAS", 0),
            central_party=_env_int("GEOMX_CENTRAL_PARTY", 0),
            central_worker=_env_bool(
                "GEOMX_ENABLE_CENTRAL_WORKER",
                _env_bool("DMLC_ENABLE_CENTRAL_WORKER"),
            ),
        )
        return Config(
            topology=topo,
            sync_mode=_env_bool("GEOMX_SYNC", True),
            sync_global_mode=_env_bool("GEOMX_SYNC_GLOBAL", True),
            use_hfa=_env_bool("GEOMX_USE_HFA", _env_bool("MXNET_KVSTORE_USE_HFA")),
            hfa_k1=_env_int("GEOMX_HFA_K1", _env_int("MXNET_KVSTORE_HFA_K1", 1)),
            hfa_k2=_env_int("GEOMX_HFA_K2", _env_int("MXNET_KVSTORE_HFA_K2", 1)),
            compression=os.environ.get("GEOMX_COMPRESSION", "none"),
            bsc_ratio=_env_float("GEOMX_BSC_RATIO", 0.01),
            mpq_size_bound=_env_int(
                "GEOMX_MPQ_SIZE_BOUND", _env_int("MXNET_KVSTORE_SIZE_LOWER_BOUND", 200_000)
            ),
            bigarray_bound=_env_int(
                "GEOMX_BIGARRAY_BOUND", _env_int("MXNET_KVSTORE_BIGARRAY_BOUND", 1_000_000)
            ),
            enable_p3=_env_bool("GEOMX_ENABLE_P3", _env_bool("ENABLE_P3")),
            enable_intra_ts=_env_bool("GEOMX_ENABLE_INTRA_TS", _env_bool("ENABLE_INTRA_TS")),
            enable_inter_ts=_env_bool("GEOMX_ENABLE_INTER_TS", _env_bool("ENABLE_INTER_TS")),
            ts_max_greed_rate=_env_float("GEOMX_TS_GREED", _env_float("MAX_GREED_RATE_TS", 0.9)),
            inter_ts_async_every=_env_int("GEOMX_INTER_TS_ASYNC_EVERY", 8),
            enable_inter_ts_push=_env_bool("GEOMX_ENABLE_INTER_TS_PUSH"),
            enable_dgt=_env_int("GEOMX_ENABLE_DGT", _env_int("ENABLE_DGT", 0)),
            dgt_block_size=_env_int("GEOMX_DGT_BLOCK_SIZE", _env_int("DGT_BLOCK_SIZE", 4096)),
            dgt_k=_env_float("GEOMX_DGT_K", _env_float("DMLC_K", 0.5)),
            dgt_k_min=_env_float("GEOMX_DGT_K_MIN", _env_float("DMLC_K_MIN", 0.2)),
            dgt_adaptive_k=_env_bool("GEOMX_DGT_ADAPTIVE", _env_bool("ADAPTIVE_K_FLAG")),
            dgt_k_anneal_steps=_env_int("GEOMX_DGT_K_ANNEAL_STEPS", 1000),
            dgt_udp_channels=_env_int(
                "GEOMX_DGT_CHANNELS", _env_int("DMLC_UDP_CHANNEL_NUM", 3)
            ),
            dgt_contrib_alpha=_env_float(
                "GEOMX_DGT_ALPHA", _env_float("DGT_CONTRIBUTION_ALPHA", 0.3)
            ),
            bsc_sample_rate=_env_float("GEOMX_BSC_SAMPLE_RATE", 0.005),
            bsc_momentum=_env_float("GEOMX_BSC_MOMENTUM", 0.9),
            twobit_threshold=_env_float("GEOMX_2BIT_THRESHOLD", 0.5),
            p3_slice_elems=_env_int("GEOMX_P3_SLICE", 0),
            # both names follow the legacy percent convention (PS_DROP_MSG=10
            # means 10%, ref: van.cc:497-499)
            drop_rate=_env_float("GEOMX_DROP_MSG", _env_float("PS_DROP_MSG", 0.0)) / 100.0,
            channel_drop_rate=_env_float("GEOMX_CHANNEL_DROP_MSG", 0.0) / 100.0,
            resend_timeout_ms=_env_int(
                "GEOMX_RESEND_TIMEOUT_MS",
                _env_int("PS_RESEND_TIMEOUT", 1000) if _env_bool("PS_RESEND") else 0,
            ),
            request_retry_s=_env_float("GEOMX_REQUEST_RETRY_S", 0.0),
            retry_backoff_cap=_env_int("GEOMX_RETRY_BACKOFF_CAP", 8),
            retry_jitter=_env_float("GEOMX_RETRY_JITTER", 0.1),
            policy_fence_max_retries=_env_int(
                "GEOMX_POLICY_FENCE_MAX_RETRIES", 5),
            checkpoint_dir=os.environ.get("GEOMX_CHECKPOINT_DIR", ""),
            auto_ckpt_updates=_env_int("GEOMX_AUTO_CKPT_UPDATES", 0),
            replicate_every=_env_int("GEOMX_REPLICATE_EVERY", 1),
            deterministic=_env_bool(
                "GEOMX_DETERMINISTIC",
                os.environ.get("MXNET_ENGINE_TYPE") == "NaiveEngine",
            ),
            server_merge_threads=_env_int("GEOMX_SERVER_MERGE_THREADS", 0),
            server_shards=_env_int("GEOMX_SERVER_SHARDS", 0),
            transport=os.environ.get("GEOMX_TRANSPORT", ""),
            reactor_loops=_env_int("GEOMX_REACTOR_LOOPS", 0),
            lightweight=_env_bool("GEOMX_LIGHTWEIGHT", False),
            merge_backend=os.environ.get("GEOMX_MERGE_BACKEND", "auto")
            or "auto",
            merge_quantized=_env_bool("GEOMX_MERGE_QUANTIZED"),
            merge_residual=_env_bool("GEOMX_MERGE_RESIDUAL", True),
            merge_opt_device=_env_bool("GEOMX_MERGE_OPT_DEVICE", True),
            codec_device=_env_bool("GEOMX_CODEC_DEVICE", True),
            heartbeat_interval_s=_env_float(
                "GEOMX_HEARTBEAT_INTERVAL", _env_float("PS_HEARTBEAT_INTERVAL", 0.0)
            ),
            heartbeat_timeout_s=_env_float(
                "GEOMX_HEARTBEAT_TIMEOUT", _env_float("PS_HEARTBEAT_TIMEOUT", 10.0)
            ),
            enable_eviction=_env_bool("GEOMX_ENABLE_EVICTION", True),
            eviction_check_interval_s=_env_float(
                "GEOMX_EVICTION_CHECK_INTERVAL", 0.0
            ),
            enable_preempt=_env_bool("GEOMX_PREEMPT_NOTICE"),
            preempt_drain_s=_env_float("GEOMX_PREEMPT_DRAIN_S", 30.0),
            enable_partition_mode=_env_bool("GEOMX_PARTITION_MODE"),
            probe_indirect_k=_env_int("GEOMX_PROBE_K", 2),
            probe_timeout_s=_env_float("GEOMX_PROBE_TIMEOUT_S", 0.5),
            partition_catchup_bound=_env_int(
                "GEOMX_PARTITION_CATCHUP_BOUND", 50),
            partition_degrade_s=_env_float("GEOMX_PARTITION_DEGRADE_S", 0.0),
            integrity_push_screen=_env_bool("GEOMX_INTEGRITY_PUSH_SCREEN"),
            poison_quarantine_n=_env_int("GEOMX_POISON_QUARANTINE_N", 3),
            poison_mag_max=_env_float("GEOMX_POISON_MAG_MAX", 0.0),
            ckpt_generations=_env_int("GEOMX_CKPT_GENERATIONS", 1),
            trace_sample_every=_env_int("GEOMX_TRACE_SAMPLE_EVERY", 0),
            trace_dir=os.environ.get("GEOMX_TRACE_DIR", ""),
            trace_batch_events=_env_int("GEOMX_TRACE_BATCH_EVENTS", 256),
            adaptive_wan=_env_bool("GEOMX_ADAPTIVE_WAN"),
            adapt_interval_s=_env_float("GEOMX_ADAPT_INTERVAL", 1.0),
            adapt_round_budget_s=_env_float("GEOMX_ADAPT_ROUND_BUDGET", 0.0),
            adapt_deadband=_env_float("GEOMX_ADAPT_DEADBAND", 0.25),
            adapt_cooldown_s=_env_float("GEOMX_ADAPT_COOLDOWN", 5.0),
            adapt_window=_env_int("GEOMX_ADAPT_WINDOW", 8),
            enable_obs=_env_bool("GEOMX_OBS"),
            obs_interval_s=_env_float("GEOMX_OBS_INTERVAL", 1.0),
            obs_window=_env_int("GEOMX_OBS_WINDOW", 256),
            obs_alert_log=os.environ.get("GEOMX_OBS_ALERT_LOG", ""),
            obs_stall_factor=_env_float("GEOMX_OBS_STALL_FACTOR", 4.0),
            obs_stall_min_s=_env_float("GEOMX_OBS_STALL_MIN", 2.0),
            obs_repl_lag_s=_env_float("GEOMX_OBS_REPL_LAG", 60.0),
            obs_rtt_s=_env_float("GEOMX_OBS_RTT", 1.0),
            obs_goodput_frac=_env_float("GEOMX_OBS_GOODPUT_FRAC", 0.1),
            obs_fence_spike=_env_int("GEOMX_OBS_FENCE_SPIKE", 8),
            obs_imbalance_factor=_env_float("GEOMX_OBS_IMBALANCE", 4.0),
            obs_churn_storm=_env_int("GEOMX_OBS_CHURN_STORM", 16),
            obs_flight_cooldown_s=_env_float("GEOMX_OBS_FLIGHT_COOLDOWN",
                                             60.0),
            enable_flight=_env_bool("GEOMX_FLIGHT", True),
            flight_events=_env_int("GEOMX_FLIGHT_EVENTS", 4096),
            flight_sample_s=_env_float("GEOMX_FLIGHT_SAMPLE_S", 0.0),
            serve_staleness_s=_env_float("GEOMX_SERVE_STALENESS_S", 5.0),
            serve_refresh_interval_s=_env_float("GEOMX_SERVE_REFRESH_S",
                                                0.5),
            serve_max_inflight=_env_int("GEOMX_SERVE_MAX_INFLIGHT", 0),
            serve_retry_after_s=_env_float("GEOMX_SERVE_RETRY_AFTER_S",
                                           0.05),
            serve_batch_max=_env_int("GEOMX_SERVE_BATCH_MAX", 0),
            serve_batch_wait_ms=_env_float("GEOMX_SERVE_BATCH_WAIT_MS",
                                           2.0),
            serve_lb_refresh_s=_env_float("GEOMX_SERVE_LB_REFRESH_S",
                                          1.0),
            serve_eject_errors=_env_int("GEOMX_SERVE_EJECT_ERRORS", 3),
            serve_probe_s=_env_float("GEOMX_SERVE_PROBE_S", 1.0),
            serve_attempt_timeout_s=_env_float(
                "GEOMX_SERVE_ATTEMPT_TIMEOUT_S", 1.0),
            serve_autoscale=_env_bool("GEOMX_SERVE_AUTOSCALE"),
            serve_min_replicas=_env_int("GEOMX_SERVE_MIN_REPLICAS", 1),
            serve_max_replicas=_env_int("GEOMX_SERVE_MAX_REPLICAS", 0),
            serve_scale_interval_s=_env_float(
                "GEOMX_SERVE_SCALE_INTERVAL_S", 0.0),
            serve_scale_cooldown_s=_env_float(
                "GEOMX_SERVE_SCALE_COOLDOWN_S", 5.0),
            serve_scale_patience=_env_int("GEOMX_SERVE_SCALE_PATIENCE",
                                          2),
            serve_target_qps=_env_float("GEOMX_SERVE_TARGET_QPS", 0.0),
            serve_scale_p99_ms=_env_float("GEOMX_SERVE_SCALE_P99_MS",
                                          0.0),
            obs_shed_rate=_env_float("GEOMX_OBS_SHED_RATE", 2.0),
            obs_replica_flap=_env_int("GEOMX_OBS_REPLICA_FLAP", 2),
            verbose=_env_int("GEOMX_VERBOSE", _env_int("PS_VERBOSE", 0)),
        )
