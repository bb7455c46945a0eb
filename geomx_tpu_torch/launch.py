"""Single-role process entry point for real (multi-process) deployments.

The reference launches one OS process per role with env-var role
injection (ref: 3rdparty/ps-lite/tracker/dmlc_local.py,
scripts/cpu/run_vanilla_hips.sh — 12 processes for 2 parties + central).
This module is the equivalent:

    python -m geomx_tpu_torch.launch --role scheduler:0@p0 --parties 2 --workers 2
    python -m geomx_tpu_torch.launch --role server:0@p0    ...
    python -m geomx_tpu_torch.launch --role worker:0@p0    ...
    python -m geomx_tpu_torch.launch --role global_scheduler:0 ...
    python -m geomx_tpu_torch.launch --role global_server:0 ...

Role/topology can also come from env (GEOMX_ROLE, GEOMX_NUM_PARTIES,
GEOMX_WORKERS_PER_PARTY, GEOMX_NUM_GLOBAL_SERVERS, GEOMX_BASE_PORT,
GEOMX_NODE_HOSTS), mirroring the reference's DMLC_* env surface.
Workers run the demo CNN training; non-worker roles serve until a
TERMINATE control message arrives (sent by worker rank-0 of party 0 once
every party's workers have finished), like the reference's kStopServer
flow.

The port of the JAX package's ``launch.py``: the runtime (roles, TCP
fabric, shutdown, exit observables) is the JAX package's; the worker
workloads compute with PyTorch on ``--device`` (CUDA unless ``--device
cpu``), and servers merge on ``--merge-backend`` (``auto`` = the torch
backend on CUDA; ``numpy`` or ``torch:cpu`` on a host without a card).
Neither default falls back to the host.  Schedulers never touch the
card.  Server roles also print their codec kernels' launch counts.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

from geomx_tpu_torch.core.config import Config, NodeId, Role, Topology
from geomx_tpu_torch.ps import Postoffice
from geomx_tpu_torch.transport.message import Control, Domain, Message
from geomx_tpu_torch.transport.tcp import TcpFabric, default_address_plan

# when this process started: the terminator waits for lagging parties at
# most as long as it took itself (_await_parties)
_STARTED = time.monotonic()


def build_runtime(node: NodeId, config: Config, base_port: int = 9200,
                  hosts=None, advertise=None):
    """Construct the postoffice + role object for one node.

    ``advertise`` = (host, port) overrides this node's planned address —
    a *replacement* node coming up somewhere new (the static plan's slot
    is stale).  The new address is broadcast to every peer after start
    (ref: the scheduler's re-registration broadcast van.cc:176-193;
    plan-based here, so the node announces directly)."""
    if hosts is None:
        import json

        hosts = json.loads(os.environ.get("GEOMX_NODE_HOSTS", "{}"))
    plan = default_address_plan(config.topology, base_port, hosts)
    if advertise is not None:
        plan[str(node)] = advertise
    fabric = TcpFabric(plan, config=config)
    po = Postoffice(node, config.topology, fabric, config)
    stop_ev = threading.Event()
    # distributed tracing: the global scheduler hosts the collector
    # (registered BEFORE po.start so no TRACE_REPORT beats it); every
    # node gets a reporter bound to its postoffice
    po.trace_collector = None
    if config.trace_sample_every > 0:
        from geomx_tpu_torch.trace import get_collector, get_tracer

        if node.role is Role.GLOBAL_SCHEDULER:
            po.trace_collector = get_collector(po)
        tracer = get_tracer(str(node))
        tracer.batch_events = config.trace_batch_events
        tracer.attach(po)

    # the end of the run (_end_of_training): the terminator (party 0's
    # rank-0 worker) collects the parties that reported done and answers
    # each report; a reporting worker notes the terminator's last answer
    po.parties_done = set()
    po.end_cv = threading.Condition()
    po.end_acked = 0.0

    def on_control(msg: Message) -> bool:
        if msg.control is Control.TERMINATE:
            b = msg.body if isinstance(msg.body, dict) else {}
            if "party_done" in b:
                with po.end_cv:
                    po.parties_done.add(int(b["party_done"]))
                    po.end_cv.notify_all()
                try:
                    po.van.send(msg.reply_to(body={"ack": True}))
                except (KeyError, OSError):
                    pass
                return True
            if "ack" in b:
                with po.end_cv:
                    po.end_acked = time.monotonic()
                return True
            if node.role is Role.SCHEDULER:
                # pass the end of the run on to the party's workers,
                # which wait for it (_end_of_training)
                for w in config.topology.workers(node.party):
                    try:
                        po.van.send(Message(recipient=w,
                                            control=Control.TERMINATE,
                                            domain=Domain.LOCAL))
                    except (KeyError, OSError):
                        pass
            stop_ev.set()
            return True
        return False

    po.add_control_hook(on_control)
    po.terminated = stop_ev
    # NOTE: po.start() happens AFTER role construction (and after a
    # restarted global server loads its checkpoint): starting the van
    # first opens a window where replayed pushes reach a server whose
    # store is still empty (observed as KeyError in the stress test's
    # mid-run recovery)

    role_obj = None
    if node.role is Role.SERVER:
        from geomx_tpu_torch.kvstore.server import LocalServer

        role_obj = LocalServer(po, config)
    elif node.role is Role.GLOBAL_SERVER:
        from geomx_tpu_torch.kvstore.server import GlobalServer

        role_obj = GlobalServer(po, config)
        # crash recovery: a restarted global server resumes from its last
        # checkpoint (weights + optimizer + config); load_checkpoint also
        # drains pulls that parked during the restart window
        ckpt_dir = config.checkpoint_dir or os.environ.get(
            "GEOMX_CHECKPOINT_DIR")
        if ckpt_dir:
            path = f"{ckpt_dir}/global_server_{node.rank}.npz"
            if os.path.exists(path):
                role_obj.load_checkpoint(path)
                print(f"{node}: resumed from {path} "
                      f"({len(role_obj.store)} keys)", flush=True)
                # where the restored optimizer state lives
                dev = role_obj._dev_opt
                print(f"{node}: restored optimizer state: "
                      + (dev.state_summary() if dev is not None
                         else "opt_device_keys=0"), flush=True)
    elif node.role is Role.STANDBY_GLOBAL:
        from geomx_tpu_torch.kvstore.server import GlobalServer

        # hot standby (--role standby_global:K): a full GlobalServer that
        # applies the primary's replication stream and serves nothing
        # until the global scheduler promotes it (kvstore/replication.py)
        role_obj = GlobalServer(po, config, standby=True)
    elif node.role is Role.REPLICA:
        from geomx_tpu_torch.serve import ModelReplica

        # read-serving replica (--role replica:K): subscribes to every
        # global shard with staleness-bounded pulls and answers
        # SERVE_PULL/PREDICT read traffic from its local copy
        # (geomx_tpu_torch/serve; docs/serving.md)
        role_obj = ModelReplica(po, config)
    elif node.role is Role.SCHEDULER and config.enable_intra_ts:
        from geomx_tpu_torch.sched.ts_push import TsPushScheduler
        from geomx_tpu_torch.sched.tsengine import TsScheduler

        role_obj = TsScheduler(po, config.topology.workers(node.party),
                               greed_rate=config.ts_max_greed_rate)
        TsPushScheduler(po, num_workers=config.topology.workers_per_party)
    elif node.role is Role.GLOBAL_SCHEDULER and config.enable_inter_ts:
        from geomx_tpu_torch.sched.tsengine import TsScheduler

        role_obj = TsScheduler(po, config.topology.servers(),
                               greed_rate=config.ts_max_greed_rate)
        if config.enable_inter_ts_push:
            from geomx_tpu_torch.sched.ts_push import TsPushScheduler

            TsPushScheduler(
                po, num_workers=config.topology.num_global_workers)
    if (node.role is Role.SCHEDULER and config.heartbeat_interval_s > 0
            and config.enable_eviction):
        # crash-tolerant membership: this party scheduler turns expired
        # worker heartbeats into forced leaves + barrier releases
        from geomx_tpu_torch.kvstore.eviction import WorkerEvictionMonitor

        role_obj = role_obj or WorkerEvictionMonitor(po)
    po.recovery_monitor = None
    po.failover_monitor = None
    if (node.role is Role.GLOBAL_SCHEDULER
            and config.heartbeat_interval_s > 0
            and config.enable_eviction):
        # dead local servers fold their party out of global rounds; a
        # warm-booted replacement folds back in (kvstore/eviction.py)
        from geomx_tpu_torch.kvstore.eviction import LocalServerRecoveryMonitor

        po.recovery_monitor = LocalServerRecoveryMonitor(po)
        role_obj = role_obj or po.recovery_monitor
    po.replica_monitor = None
    if (node.role is Role.GLOBAL_SCHEDULER
            and config.topology.num_replicas
            and config.heartbeat_interval_s > 0
            and config.enable_eviction):
        # serve replicas are evictable members: expired heartbeats prune
        # their tracked pull views at every shard; resumed ones rejoin
        from geomx_tpu_torch.serve import ReplicaMonitor

        po.replica_monitor = ReplicaMonitor(po)
        role_obj = role_obj or po.replica_monitor
    po.replica_autoscaler = None
    if node.role is Role.GLOBAL_SCHEDULER and config.enable_obs:
        # cluster telemetry plane (geomx_tpu_torch/obs): the metrics collector
        # + SLO health engine live here, registered BEFORE po.start so
        # no METRICS_REPORT frame beats the endpoint
        from geomx_tpu_torch.obs import HealthEngine, MetricsCollector

        po.metrics_collector = MetricsCollector(
            po, config, trace_collector=po.trace_collector)
        po.health = HealthEngine(po.metrics_collector, config,
                                 trace_collector=po.trace_collector)
    else:
        po.metrics_collector = None
        po.health = None
    if (node.role is Role.GLOBAL_SCHEDULER and config.serve_autoscale
            and config.topology.num_replicas):
        # elastic serve capacity (geomx_tpu_torch/serve/autoscaler): reads
        # the telemetry collector's per-replica series, retires /
        # reactivates replicas over the wire with hysteresis.  No
        # spawn hook here — an OS deployment's process manager starts
        # cold replicas; reactivation covers the retired-but-live ones
        from geomx_tpu_torch.serve import ReplicaAutoscaler

        po.replica_autoscaler = ReplicaAutoscaler(
            po, config, collector=po.metrics_collector)
        role_obj = role_obj or po.replica_autoscaler
    if node.role is Role.GLOBAL_SCHEDULER and config.adaptive_wan:
        # closed-loop WAN codec autotuning (geomx_tpu_torch/control): the
        # controller samples server stats + the trace report and
        # broadcasts epoch-fenced SET_WAN_POLICY down both tiers
        from geomx_tpu_torch.control import AdaptiveWanController

        po.wan_controller = AdaptiveWanController(
            po, config, collector=po.trace_collector,
            metrics=po.metrics_collector)
        role_obj = role_obj or po.wan_controller
    if (node.role is Role.GLOBAL_SCHEDULER
            and config.topology.num_standby_globals
            and config.heartbeat_interval_s > 0):
        # automatic global-tier failover: the heartbeat-driven failure
        # detector + promotion coordinator lives on this scheduler
        from geomx_tpu_torch.kvstore.replication import GlobalFailoverMonitor

        po.failover_monitor = GlobalFailoverMonitor(po)
        role_obj = role_obj or po.failover_monitor
    if node.role is Role.GLOBAL_SCHEDULER:
        # live cluster-state console (always on — costs nothing until
        # queried): Ctrl.CLUSTER_STATE merges shard holders/terms, party
        # folds, heartbeat freshness, policy epoch and health alerts
        from geomx_tpu_torch.obs import ClusterStateService

        po.state_service = ClusterStateService(
            po, config,
            failover_monitor=po.failover_monitor,
            recovery_monitor=po.recovery_monitor,
            wan_controller=getattr(po, "wan_controller", None),
            collector=po.metrics_collector,
            health=po.health)
        role_obj = role_obj or po.state_service
    if node.role is Role.WORKER:
        from geomx_tpu_torch.kvstore.client import WorkerKVStore

        role_obj = WorkerKVStore(po, config)
    elif node.role is Role.MASTER_WORKER:
        from geomx_tpu_torch.kvstore.client import MasterWorker

        role_obj = MasterWorker(po, config)
    po.start()
    po.metrics_pump = None
    if config.enable_obs:
        # every role ships time-series samples; server roles attach
        # their QUERY_STATS-equivalent stats dict
        from geomx_tpu_torch.kvstore.server import GlobalServer, LocalServer
        from geomx_tpu_torch.obs import MetricsPump
        from geomx_tpu_torch.serve import ModelReplica

        stats_fn = (role_obj.stats
                    if isinstance(role_obj, (LocalServer, GlobalServer,
                                             ModelReplica))
                    else None)
        po.metrics_pump = MetricsPump(
            po, config, stats_fn=stats_fn,
            collector=getattr(po, "metrics_collector", None))
    # scripted link faults (GEOMX_NETFAULT_PLAN): a JSON tape of WAN
    # cuts/heals applied to THIS process's fabric fault policy — the
    # partition demo's in-fabric blackhole (no iptables, no root)
    from geomx_tpu_torch.chaos import install_env_netfaults

    install_env_netfaults(po)
    if advertise is not None:
        announce_address(po, *advertise)
    return po, role_obj, stop_ev


def announce_address(po: Postoffice, host: str, port: int,
                     repeat_s: float = 5.0):
    """Broadcast this node's replacement address to every peer, then
    keep re-broadcasting every ``repeat_s`` from a background thread.

    The repeat is what makes the announcement survive compound
    failures: a peer that was down during (or restarted after) the
    first broadcast rebuilds its plan from the STATIC addresses and
    would otherwise dial the stale slot forever.  Receivers apply
    updates idempotently, so the steady-state cost is a few 64-byte
    messages per period.  Runs off the startup path — a down peer's
    dial retry must not stall role construction."""
    body = {"node": str(po.node), "host": host, "port": port}
    peers = [n for n in po.topology.all_nodes() if str(n) != str(po.node)]

    def broadcast_loop():
        while True:
            for n in peers:
                domain = (Domain.LOCAL
                          if n.party is not None and n.party == po.node.party
                          else Domain.GLOBAL)
                # van swallows delivery errors (down peers get the next
                # round); sends to live peers are no-ops after the first
                po.van.send(Message(recipient=n,
                                    control=Control.ADDR_UPDATE,
                                    domain=domain, body=body))
            time.sleep(repeat_s)

    threading.Thread(target=broadcast_loop, daemon=True,
                     name=f"addr-announce-{po.node}").start()


def shutdown_cluster(po: Postoffice):
    """Broadcast TERMINATE to every non-worker node (worker rank-0 of
    party 0 calls this after training, ref: kStopServer).

    The broadcast is sent twice with a gap: a peer that crashed and
    restarted leaves this node holding a half-closed connection whose
    first send is silently buffered into the void (no error until the
    RST arrives).  By the second round the RST has landed, the send
    raises, and the fabric redials the live incarnation.  TERMINATE is
    idempotent, so the duplicate is harmless."""
    topo = po.topology
    targets = []
    for p in range(topo.num_parties):
        targets.append((topo.server(p), Domain.LOCAL))
        targets.append((topo.scheduler(p), Domain.LOCAL))
    for gs in topo.global_servers():
        targets.append((gs, Domain.GLOBAL))
    for sb in topo.standby_globals():
        targets.append((sb, Domain.GLOBAL))
    for rp in topo.replicas():
        targets.append((rp, Domain.GLOBAL))
    targets.append((topo.global_scheduler(), Domain.GLOBAL))
    for attempt in range(2):
        if attempt:
            time.sleep(0.5)
        for node, domain in targets:
            try:
                po.van.send(Message(recipient=node, control=Control.TERMINATE,
                                    domain=domain))
            except (KeyError, OSError):
                pass


def _end_of_training(po: Postoffice, kv) -> None:
    """After a worker's last step and its party barrier (every worker of
    its party is done): party 0's rank 0, the terminator, ends the run
    (:func:`shutdown_cluster`) once every party has reported done
    (:func:`_await_parties`), so that a party that lags, as parties do
    under ``--sync mixed``, is not cut off mid-round (C13).

    Any other worker reports its party done to the terminator, again
    each 0.5 s, and stays up, when heartbeats are on, until the
    TERMINATE its party scheduler passes on: a worker that exited while
    the run went on would fall silent and be evicted by heartbeat
    expiry (C10).  It leaves without that TERMINATE, saying so, once
    the terminator has not answered a report for three heartbeat
    timeouts (at least 10 s): the terminator has exited, and the
    forwarded TERMINATE was lost with a scheduler."""
    kv.barrier()
    if kv.party == 0 and kv.rank == 0:
        _await_parties(po)
        time.sleep(0.5)  # let the last round drain through the servers
        shutdown_cluster(po)
        return
    term = po.topology.workers(0)[0]
    patience = max(10.0, 3 * po.config.heartbeat_timeout_s)
    started = time.monotonic()
    report = {"party_done": kv.party}
    domain = Domain.LOCAL if kv.party == 0 else Domain.GLOBAL
    while True:
        po.van.send(Message(recipient=term, control=Control.TERMINATE,
                            domain=domain, request=True, body=report))
        if po.terminated.wait(0.5):
            return
        with po.end_cv:
            acked = po.end_acked
        if acked and po.config.heartbeat_interval_s <= 0:
            return  # reported; without heartbeats nothing evicts it
        if time.monotonic() - max(started, acked) > patience:
            print(f"{po.node}: {term} has not answered for "
                  f"{patience:.0f} s; leaving without the end of the run",
                  flush=True)
            return


def _await_parties(po: Postoffice) -> None:
    """The terminator's wait for every party's done report, at most as
    long as this process has run so far (at least 30 s): a party that
    still has not finished then is reported and left behind."""
    want = set(range(po.topology.num_parties)) - {0}
    wait_s = max(30.0, time.monotonic() - _STARTED)
    deadline = time.monotonic() + wait_s
    with po.end_cv:
        while not want <= po.parties_done:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(want - po.parties_done)
                print(f"{po.node}: ending the run after {wait_s:.0f} s "
                      f"without a done report from parties {missing}",
                      flush=True)
                return
            po.end_cv.wait(left)


def _wait_servers_up(kv, timeout: float = 90.0):
    """Ping the party server and every global shard until each answers
    a QUERY_STATS round trip.  Control commands are fire-once (the
    replay layer covers only data traffic), so configuration must not
    race a still-binding server process — with a sharded global tier
    the last shard to bind loses that race reliably."""
    from geomx_tpu_torch.kvstore.common import Ctrl
    from geomx_tpu_torch.transport.message import Domain as _Domain

    deadline = time.monotonic() + timeout
    for i in range(-1, len(kv.po.topology.global_servers())):
        while True:
            # re-resolve the shard's CURRENT holder on every retry: a
            # shard that dies during bring-up answers through its
            # promoted standby once the NEW_PRIMARY broadcast lands
            if i < 0:
                node, domain = kv.po.topology.server(kv.party), _Domain.LOCAL
            else:
                gts = kv.global_targets()
                if i >= len(gts):  # shards merged by a reassignment
                    break
                node, domain = gts[i], _Domain.GLOBAL
            ts = kv.worker.send_cmd(node, Ctrl.QUERY_STATS,
                                    domain=domain, wait=False)
            try:
                kv.worker.customer.wait(ts, timeout=2.0)
                kv.worker.cmd_response(ts)  # drop the stats body
                break
            except TimeoutError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{kv.po.node}: {node} never answered a "
                        "configuration ping")


def _configure_worker(po, kv, args):
    """Shared worker-side setup for every demo workload: either gate on
    the central master worker's configuration or (rank 0) push optimizer
    + compression ourselves, then barrier.  Every workload variant MUST
    route through here — a path that skips it silently trains without
    the requested compression and reintroduces the first-round race
    against the default optimizer."""
    topo = po.topology
    if kv.rank == 0:
        _wait_servers_up(kv)
    if topo.central_worker:
        # central-worker deployment: the MASTER drives configuration
        # (ref: DMLC_ENABLE_CENTRAL_WORKER); workers only gate training
        # on it having landed, so the first round can't race the default
        # optimizer
        from geomx_tpu_torch.kvstore.common import Ctrl
        from geomx_tpu_torch.transport.message import Domain

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            # EVERY shard must be configured — with MultiGPS a partially
            # configured tier would silently mix optimizers across keys
            ok = all((kv.worker.send_cmd(gs, Ctrl.QUERY_STATS,
                                         domain=Domain.GLOBAL) or {}
                      ).get("optimizer_configured")
                     for gs in kv.global_targets())
            if ok:
                break
            time.sleep(0.2)
        else:
            raise TimeoutError("master worker never configured the "
                               "optimizer")
    else:
        if kv.party == 0 and kv.rank == 0:
            kv.set_optimizer({"type": args.optimizer, "lr": 0.01})
        if kv.rank == 0 and args.compression != "none":
            kv.set_gradient_compression({"type": args.compression})
    kv.barrier()


def install_preempt_handler(po, role_obj, stop_ev):
    """Map SIGTERM onto the graceful preemption drain (spot preemptions
    arrive as SIGTERM-with-notice on every major cloud; SIGKILL stays
    the ungraceful path — heartbeat eviction covers it).  A noticed
    WORKER finishes its in-flight step (the training loops poll the
    notice), flushes un-ACKed pushes and leaves the party; a noticed
    LOCAL SERVER drains its WAN round and hands its party fold to the
    global tier; every other role just exits in order.  Installed only
    under ``Config.enable_preempt`` — default-off keeps the legacy
    SIGTERM semantics (flight dump + immediate death)."""
    import signal

    from geomx_tpu_torch.kvstore.client import WorkerKVStore
    from geomx_tpu_torch.kvstore.server import LocalServer

    def handler(signum, frame):
        print(f"{po.node}: SIGTERM → preempt notice (graceful drain; "
              "SIGKILL would take the eviction path)", flush=True)
        if isinstance(role_obj, WorkerKVStore):
            # the demo loop breaks at its next step boundary and the
            # drain thread flushes + leaves; main() then exits normally
            role_obj.begin_drain()
        elif isinstance(role_obj, LocalServer):
            def drain():
                try:
                    role_obj.preempt_drain()
                except Exception:
                    pass  # the eviction path covers a failed drain
                finally:
                    stop_ev.set()

            threading.Thread(target=drain, daemon=True,
                             name=f"preempt-drain-{po.node}").start()
        else:
            stop_ev.set()

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread (library use)


def _drain_if_preempted(po, kv) -> bool:
    """Worker epilogue for the notice path: when the loop broke on a
    preempt notice, wait out the drain (flush + graceful leave) and
    exit WITHOUT the end-of-training barrier or cluster shutdown — the
    survivors keep training.  Returns True when preempted."""
    ev = getattr(kv, "preempt_noticed", None)
    if ev is None or not ev.is_set():
        return False
    kv.finish_drain()
    print(f"{po.node}: preempted — drained and left gracefully "
          f"(drain_s={kv.last_drain_s})", flush=True)
    return True


def _test_step_sleep_s(node) -> float:
    """Per-node artificial per-step delay for acceptance runs that need
    deterministic heterogeneity (the ESync matrix): env
    ``GEOMX_TEST_STEP_SLEEP_MS='{"worker:1@p0": 60}'`` keyed by the
    node's ``str()`` form (``role:rank@party``)."""
    import json

    raw = os.environ.get("GEOMX_TEST_STEP_SLEEP_MS")
    if not raw:
        return 0.0
    try:
        return float(json.loads(raw).get(str(node), 0)) / 1000.0
    except (ValueError, AttributeError, TypeError):
        return 0.0


def _test_poison_steps(node) -> tuple:
    """Per-node poison injection for integrity acceptance runs
    (scripts/run_integrity_demo.sh): env
    ``GEOMX_TEST_POISON_STEPS='{"worker:1@p0": 40}'`` — from that step
    on, this worker's pushed gradients are all-NaN.  Returns
    ``(start_step,)`` or ``()``.  The payload corruption happens at the
    gradient source, so every hop downstream (codec, wire, server
    screen) sees exactly what a diverged or faulty worker produces."""
    import json

    raw = os.environ.get("GEOMX_TEST_POISON_STEPS")
    if not raw:
        return ()
    try:
        start = json.loads(raw).get(str(node))
    except (ValueError, AttributeError, TypeError):
        return ()
    return () if start is None else (int(start),)


def _worker_demo(po, kv, args, join_advertise=None):
    """The reference demo workload (examples/cnn.py) for launcher smoke
    runs: tiny CNN on synthetic data.  ``join_advertise``: this worker
    is an out-of-plan DYNAMIC JOINER — register with the party server
    before training, leave gracefully after, and stay out of the
    cluster's barriers (the static plan doesn't count us)."""
    import torch

    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import ShardedIterator, synthetic_classification
    from geomx_tpu_torch.models import create_cnn_state
    from geomx_tpu_torch.training import run_worker, run_worker_hfa

    joining = join_advertise is not None or args.join
    x, y = synthetic_classification(n=512, shape=(12, 12, 1), seed=0)
    _, params, grad_fn = create_cnn_state(
        seed=0, input_shape=(1, 12, 12, 1),
        device=resolve_device(args.device))
    sleep_s = _test_step_sleep_s(po.node)
    if sleep_s > 0:
        # deterministic pacing for harnesses that must outlive a fault
        # window (run_status_demo.sh) — same knob the ESync matrix uses
        inner = grad_fn

        def grad_fn(p, xb, yb):  # noqa: F811 — deliberate wrap
            time.sleep(sleep_s)
            return inner(p, xb, yb)

    poison_from = _test_poison_steps(po.node)
    if poison_from:
        # integrity-demo byzantine worker: from step N on, every pushed
        # gradient is all-NaN.  The server screen zeroes the merge and
        # answers with a typed rejection; claim those acks so this
        # worker keeps stepping (a real diverged worker wouldn't stop
        # either) instead of raising out of wait_all.
        inner_g = grad_fn
        step_ctr = [0]

        def grad_fn(p, xb, yb):  # noqa: F811 — deliberate wrap
            loss, acc, grads = inner_g(p, xb, yb)
            step, step_ctr[0] = step_ctr[0], step_ctr[0] + 1
            if step >= poison_from[0]:
                grads = {n: torch.full_like(g, float("nan"))
                         for n, g in grads.items()}
            return loss, acc, grads

        prev_handler = kv.worker.error_handler

        def _claim_poison_ack(m, _prev=prev_handler):
            err = str((m.body or {}).get("error", ""))
            if "poisoned push rejected" in err:
                return True
            return bool(_prev is not None and _prev(m))

        kv.worker.error_handler = _claim_poison_ack

    log_fn = None
    if args.log_every > 0:
        # progress lines for harnesses that act mid-training (a kill
        # once some rounds have landed): "<node>: round K loss=L"
        def log_fn(step, loss, acc):
            if (step + 1) % args.log_every == 0:
                print(f"{po.node}: round {step + 1} loss={loss:.4f}",
                      flush=True)

    def train(kv, params, it, steps, barrier_init):
        # HFA servers average WEIGHTS — pushing gradients at them (the
        # pre-r5 --hfa path) silently replaced the model with a mean
        # gradient.  The HFA client loop is the only correct driver.
        if args.hfa:
            return run_worker_hfa(kv, params, grad_fn, it, steps,
                                  k1=args.hfa_k1,
                                  barrier_init=barrier_init, log_fn=log_fn)
        return run_worker(kv, params, grad_fn, it, steps,
                          barrier_init=barrier_init, log_fn=log_fn)
    if joining:
        info = kv.join_party(advertise=join_advertise)
        print(f"{po.node}: joined as rank {info['rank']} "
              f"(num_workers={info['num_workers']})", flush=True)
        # adopt the CLUSTER's current weights before contributing — a
        # gradient computed at our own random init point would fold one
        # garbage step into everyone's mean.  init (no-op server-side)
        # publishes shapes; the pulls fetch the live replica.
        from geomx_tpu_torch.training import (flatten_params,
                                              unflatten_params)

        leaves, treedef = flatten_params(params)
        for tid, leaf in enumerate(leaves):
            kv.init(tid, leaf)
        pulled = [kv.pull_sync(tid) for tid in range(len(leaves))]
        params = unflatten_params(treedef, pulled)
        # shard by the POST-join party size: the static plan's indexing
        # would alias another worker's shard (widx past num_all_workers
        # wraps into a subset of worker 0's slice)
        widx, num_all = int(info["rank"]), int(info["num_workers"])
    else:
        _configure_worker(po, kv, args)
        widx, num_all = kv.party * kv.num_workers + kv.rank, \
            kv.num_all_workers
        # chaos harnesses key their kill timing off this marker: a
        # SIGKILL before configuration completes tests the bring-up
        # race, after it the mid-training failover path
        print(f"{po.node}: configured — training begins", flush=True)
    it = ShardedIterator(x, y, args.batch, widx, num_all)
    hist = train(kv, params, it, args.steps, barrier_init=not joining)
    if _drain_if_preempted(po, kv):
        return
    if joining:
        kv.wait_all()
        kv.leave_party()
        print(f"{po.node}: steps={len(hist)} left cleanly", flush=True)
        return
    print(f"{po.node}: steps={len(hist)} first_loss={hist[0][0]:.4f} "
          f"last_loss={hist[-1][0]:.4f}", flush=True)
    _end_of_training(po, kv)


def _worker_demo_lm(po, kv, args):
    """Flagship LM workload over the real topology (VERDICT r3 item 5):
    the transformer from models/transformer.py at a non-toy size
    (>=10 M params) trained through the two-tier kvstore, printing
    tokens/s and parameter count.  Size via GEOMX_LM_* env overrides."""
    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import TokenIterator
    from geomx_tpu_torch.training import build_flagship_lm, run_worker

    cfg, params, n_params, grad_fn, data = build_flagship_lm(
        device=resolve_device(args.device))
    widx = kv.party * kv.num_workers + kv.rank
    _configure_worker(po, kv, args)
    it = TokenIterator(data, args.batch, widx, kv.num_all_workers)
    stamps = []

    def log(step, _l, _a):
        stamps.append(time.perf_counter())

    hist = run_worker(kv, params, grad_fn, it, args.steps,
                      barrier_init=True, log_fn=log)
    if _drain_if_preempted(po, kv):
        return
    # steady tokens/s excludes the first step (kernel loads + INIT
    # broadcast dominate it; bench.py's lm child splits the same way)
    if len(stamps) > 1:
        steady = (args.batch * cfg.max_seq * (len(stamps) - 1)
                  / max(stamps[-1] - stamps[0], 1e-9))
    else:
        steady = float("nan")
    print(f"{po.node}: steps={len(hist)} first_loss={hist[0][0]:.4f} "
          f"last_loss={hist[-1][0]:.4f} n_params={n_params} "
          f"tokens_per_sec={steady:.1f}", flush=True)
    _end_of_training(po, kv)


# the ESync workload's cap on a worker's local steps a round: the
# planner's own bound (EsyncState.max_steps).  The JAX package's launcher
# caps at 16, sized for a CPU host's tens of milliseconds a step; on the
# card a fast worker's step is a few milliseconds, and a worker slowed by
# 150 ms a step needs ~45 of them to reach the server when the slow one
# does (the acceptance matrix's ESync case on an NVIDIA H100)
ESYNC_MAX_LOCAL_STEPS = 64


def _worker_demo_esync(po, kv, args):
    """ESync acceptance workload: the esync client loop with optional
    injected per-step heterogeneity, printing the per-round (assigned
    steps, reach-server seconds) pairs the matrix asserts on."""
    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import ShardedIterator, synthetic_classification
    from geomx_tpu_torch.models import create_cnn_state
    from geomx_tpu_torch.optim import local
    from geomx_tpu_torch.training import run_worker_esync

    x, y = synthetic_classification(n=2048, shape=(12, 12, 1), seed=0)
    _, params, grad_fn = create_cnn_state(
        seed=0, input_shape=(1, 12, 12, 1),
        device=resolve_device(args.device))
    sleep_s = _test_step_sleep_s(po.node)
    if sleep_s > 0:
        inner = grad_fn

        def grad_fn(p, xb, yb):  # noqa: F811 — deliberate wrap
            time.sleep(sleep_s)
            return inner(p, xb, yb)

    widx = kv.party * kv.num_workers + kv.rank
    _configure_worker(po, kv, args)
    # ShardedIterator samples with replacement — never runs dry, which
    # the esync loop needs (rounds x up-to-max_local_steps batches)
    it = ShardedIterator(x, y, args.batch, widx, kv.num_all_workers)
    # warm up the first-call costs (grad + optimizer update: kernel and
    # allocator warm-up) OUTSIDE the measured loop: round 0's step time
    # seeds the planner's EWMA, and a first-call spike would make every
    # worker look equally slow for the whole short acceptance run
    opt = local.adam(1e-2)
    xb, yb = next(iter(it))
    _loss, _acc, g = grad_fn(params, xb, yb)
    upd, _ = opt.update(g, opt.init(params), params)
    local.apply_updates(params, upd)  # discarded — warmup only
    rounds_info: list = []
    hist = run_worker_esync(kv, params, grad_fn, it, args.steps,
                            optimizer=opt, barrier_init=True,
                            max_local_steps=ESYNC_MAX_LOCAL_STEPS,
                            rounds_out=rounds_info)
    if _drain_if_preempted(po, kv):
        return
    # steps= counts SYNC rounds (the --steps contract); local steps vary
    # per worker by design — that variance is the feature
    print(f"{po.node}: steps={len(rounds_info)} "
          f"first_loss={hist[0][0]:.4f} "
          f"last_loss={hist[-1][0]:.4f} local_steps={len(hist)}",
          flush=True)
    print(f"{po.node}: esync_rounds={rounds_info!r}", flush=True)
    _end_of_training(po, kv)


def _worker_demo_staged(po, kv, args):
    """P3 acceptance workload: a staged MLP through the overlapped loop
    (``overlap.run_worker_overlapped``) — backward pushes deepest stage
    FIRST, so the shallow stages' later, higher-priority pushes must
    overtake queued deep slices in the van's priority queue (the
    observable: ``pq_overtakes`` in this process's exit stats).  Stage
    params carry a large ballast leaf so socket writes outlast the VJP
    chain and the queue actually holds contending messages."""
    import math
    from collections import OrderedDict

    import torch

    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.data import ShardedIterator, synthetic_classification
    from geomx_tpu_torch.overlap import StagedModel, run_worker_overlapped

    dev = resolve_device(args.device)
    dims = [144, 64, 64, 64, 64, 10]
    gen = torch.Generator().manual_seed(0)
    fns, params = [], []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        # sorted keys: the JAX package's tree_flatten order (key ids)
        params.append(OrderedDict(
            b=torch.zeros(dout, device=dev),
            ballast=torch.zeros(256_000, device=dev),
            w=(torch.randn(din, dout, generator=gen)
               / math.sqrt(din)).to(dev)))
        last = i == len(dims) - 2

        def fn(p, x, last=last):
            h = x @ p["w"] + p["b"] + 1e-9 * p["ballast"].sum()
            return h if last else torch.relu(h)

        fns.append(fn)

    def ce(logits, y):
        logp = torch.log_softmax(logits, -1)
        loss = -logp.gather(1, y[:, None].long()).mean()
        return loss, (logits.argmax(-1) == y).float().mean()

    x, y = synthetic_classification(n=512, shape=(12, 12, 1), seed=0)
    x = x.reshape(len(x), -1)
    widx = kv.party * kv.num_workers + kv.rank
    _configure_worker(po, kv, args)
    it = ShardedIterator(x, y, args.batch, widx, kv.num_all_workers)
    model = StagedModel(fns, ce)
    hist = run_worker_overlapped(kv, model, params, it, args.steps)
    print(f"{po.node}: steps={len(hist)} first_loss={hist[0][0]:.4f} "
          f"last_loss={hist[-1][0]:.4f}", flush=True)
    _end_of_training(po, kv)


# ports this process has handed out: clusters started side by side (each
# binds its span only once its processes are up) never share one
_ISSUED_PORTS: set = set()
_ISSUED_MU = threading.Lock()


def free_base_port(span: int = 16) -> int:
    """A base port with ``span`` consecutive ports free to bind, found
    by a bind probe OUTSIDE the kernel's ephemeral range (an ephemeral
    port can be taken by any outgoing connection between the probe and
    the bind), none handed out before by this process."""
    import random
    import socket

    for _ in range(200):
        base = random.randrange(18000, 28000)
        ports = set(range(base, base + span))
        socks = []
        with _ISSUED_MU:
            if ports & _ISSUED_PORTS:
                continue
            try:
                for port in sorted(ports):
                    s = socket.socket()
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    s.bind(("127.0.0.1", port))
                    socks.append(s)
            except OSError:
                continue
            finally:
                for s in socks:
                    s.close()
            _ISSUED_PORTS.update(ports)
            return base
    raise RuntimeError("no free port span found")


class LocalCluster:
    """Local OS processes of one topology, each ``python -m
    geomx_tpu_torch.launch --role ROLE`` with the cluster's common
    arguments, their output read line by line as it comes (so a caller
    can wait for a marker, kill a role and start its replacement while
    the rest trains).  Keys name processes: a role, or any name given
    to :meth:`spawn`; a killed process keeps its output under
    ``KEY#killed<n>``."""

    def __init__(self, common, env=None, cwd=None):
        self.common = list(common)
        self.env, self.cwd = env, cwd
        self.procs = {}
        self.lines = {}
        self._readers = {}
        self._killed = 0
        self.optional = set()

    def spawn(self, key: str, role=None, extra=(), optional=False):
        """Start ``role`` (``key`` by default) with the common arguments
        and ``extra``; its output collects under ``key``.  An
        ``optional`` process is not waited for: :meth:`wait` gives it
        ``grace_s`` once the others have exited."""
        import subprocess

        from geomx_tpu_torch.utils import reaper

        # a session of its own, registered: the role and anything it
        # starts die together, and with the program that started them
        p = reaper.popen(
            [sys.executable, "-m", "geomx_tpu_torch.launch", "--role",
             role or key, *self.common, *extra], what=f"role {key}",
            cwd=self.cwd, env=self.env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines = []

        def read():
            for line in p.stdout:
                lines.append(line)

        reader = threading.Thread(target=read, daemon=True,
                                  name=f"cluster-out-{key}")
        reader.start()
        self.procs[key], self.lines[key] = p, lines
        self._readers[key] = reader
        if optional:
            self.optional.add(key)
        return p

    def output(self, key: str) -> str:
        return "".join(self.lines[key])

    def wait_output(self, key: str, pattern: str, timeout_s: float):
        """The first match of the regex ``pattern`` in ``key``'s output
        within ``timeout_s`` seconds, or None (also once it exited)."""
        import re

        deadline = time.monotonic() + timeout_s
        while True:
            m = re.search(pattern, self.output(key))
            if m or time.monotonic() > deadline:
                return m
            if self.procs[key].poll() is not None:
                self._readers[key].join(5)
                return re.search(pattern, self.output(key))
            time.sleep(0.05)

    def kill(self, key: str) -> str:
        """SIGKILL ``key`` (its process group); its output moves to the
        returned key."""
        from geomx_tpu_torch.utils import reaper

        p = self.procs.pop(key)
        reaper.release(p.pid)
        p.wait()
        self._readers[key].join(5)
        self._killed += 1
        dead = f"{key}#killed{self._killed}"
        self.procs[dead] = p
        self.lines[dead] = self.lines.pop(key)
        self._readers[dead] = self._readers.pop(key)
        return dead

    def wait(self, deadline_s: float, grace_s: float = 15.0) -> dict:
        """Wait until every process has exited or ``deadline_s`` has
        passed (an optional one: ``grace_s`` more once the others have
        exited); a process still running then is killed and reported
        with return code ``None``.  Returns ``{key: (returncode,
        output)}``."""
        deadline = time.monotonic() + deadline_s

        def running(optional):
            return any(p.poll() is None for k, p in self.procs.items()
                       if (k in self.optional) == optional)

        while time.monotonic() < deadline and running(False):
            time.sleep(0.2)
        deadline = min(deadline, time.monotonic() + grace_s)
        while time.monotonic() < deadline and running(True):
            time.sleep(0.2)
        out = {}
        for key, p in self.procs.items():
            rc = p.poll()
            if rc is None:
                p.kill()
                p.wait()
            self._readers[key].join(5)
            out[key] = (rc, self.output(key))
        return out

    def close(self) -> None:
        """Kill every process's group (what a role left behind with it)."""
        from geomx_tpu_torch.utils import reaper

        for p in self.procs.values():
            reaper.release(p.pid)
            p.wait()


def run_local_cluster(parties: int, workers: int, extra_args=(),
                      env=None, deadline_s: float = 180.0,
                      global_servers: int = 1, cwd=None,
                      standby_globals: int = 0, during=None) -> dict:
    """Every role of a ``parties`` × ``workers`` + global-tier topology
    (``global_servers`` shards; ``standby_globals`` hot standbys, rank K
    backing shard K) as local OS processes over loopback TCP (one process
    per role, as ``scripts/run_cluster.sh`` runs the JAX package), on a
    free port span.  ``during(cluster)``, when given, runs once every
    role is started, with the :class:`LocalCluster` (to wait for a
    marker, kill a role, start a replacement or a joiner).  Then waits
    until every process has exited or ``deadline_s`` (counted from the
    start) has passed; a process still running then is killed and
    reported with return code ``None``.  Returns ``{key: (returncode,
    output)}``; no child outlives the call."""
    topo = Topology(num_parties=parties, workers_per_party=workers,
                    num_global_servers=global_servers,
                    num_standby_globals=standby_globals)
    roles = [str(n) for n in topo.all_nodes()]
    base = free_base_port(len(roles))
    cluster = LocalCluster(
        ["--parties", str(parties), "--workers", str(workers),
         "--global-servers", str(global_servers),
         "--standby-globals", str(standby_globals),
         "--base-port", str(base), *extra_args], env=env, cwd=cwd)
    t0 = time.monotonic()
    try:
        for r in roles:
            cluster.spawn(r)
        if during is not None:
            during(cluster)
        return cluster.wait(max(0.0, deadline_s - (time.monotonic() - t0)))
    finally:
        cluster.close()


def _wait_at_gate(node: NodeId, cfg: Config, args) -> None:
    """``--start-gate``: import what the role builds and create its
    device's context (what takes seconds on a card), then wait for the
    gate file; nothing is bound before it opens."""
    import importlib

    import torch

    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.kvstore.backend import resolve_merge_backend

    importlib.import_module("geomx_tpu_torch.kvstore.server")
    if node.role is Role.WORKER:
        torch.zeros(1, device=resolve_device(args.device))
    elif resolve_merge_backend(cfg) == "torch":  # the card's backend
        torch.zeros(1, device=resolve_device(None))
    print(f"{node}: waiting at {args.start_gate}", flush=True)
    while not os.path.exists(args.start_gate):
        time.sleep(0.01)


def _check_device(node: NodeId, cfg: Config, args) -> None:
    """Raise (RuntimeError naming CUDA) when this role needs a card that
    is not there: a worker unless ``--device cpu``, a server whose merge
    backend is the torch backend on CUDA.  Schedulers never touch it."""
    from geomx_tpu_torch.core.platform import resolve_device

    if node.role is Role.WORKER:
        resolve_device(args.device)
    elif node.role in (Role.SERVER, Role.GLOBAL_SERVER,
                       Role.STANDBY_GLOBAL):
        from geomx_tpu_torch.kvstore.backend import resolve_merge_backend

        if resolve_merge_backend(cfg) == "torch":
            resolve_device(None)


def _codec_launches(role_obj) -> str:
    """A server's codec kernel launches in this process (the CUDA
    quantize, dequantize and DGC update), as ``name:count,...``."""
    from geomx_tpu_torch.kvstore.server import GlobalServer, LocalServer
    from geomx_tpu_torch.ops.kernels import quantize_cuda

    if not isinstance(role_obj, (LocalServer, GlobalServer)):
        return ""
    return ",".join(f"{n}:{c}" for n, c in quantize_cuda.launches().items())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default=os.environ.get("GEOMX_ROLE"))
    ap.add_argument("--parties", type=int,
                    default=int(os.environ.get("GEOMX_NUM_PARTIES", "1")))
    ap.add_argument("--workers", type=int,
                    default=int(os.environ.get("GEOMX_WORKERS_PER_PARTY", "1")))
    ap.add_argument("--global-servers", type=int,
                    default=int(os.environ.get("GEOMX_NUM_GLOBAL_SERVERS", "1")))
    ap.add_argument("--global-shards", type=int,
                    default=int(os.environ.get("GEOMX_GLOBAL_SHARDS", "0")),
                    help="shard the global tier horizontally into M "
                         "independent key-range servers (alias of "
                         "--global-servers; wins when both are given). "
                         "Each shard is its own failure domain: run each "
                         "as --role global_server:K, optionally backed "
                         "by --role standby_global:K (per-shard "
                         "failover; see docs/deployment.md)")
    ap.add_argument("--standby-globals", type=int,
                    default=int(os.environ.get("GEOMX_NUM_STANDBY_GLOBALS",
                                               "0")),
                    help="hot standbys for the global tier: standby rank "
                         "K backs global server rank K; run each as "
                         "--role standby_global:K (every process must "
                         "pass the same count — the port plan includes "
                         "the standbys)")
    ap.add_argument("--replicas", type=int,
                    default=int(os.environ.get("GEOMX_SERVE_REPLICAS",
                                               "0")),
                    help="read-serving replica tier: K replicas, each "
                         "holding a staleness-bounded local copy of the "
                         "whole model and answering SERVE_PULL/PREDICT "
                         "reads; run each as --role replica:K (every "
                         "process must pass the same count — the port "
                         "plan includes the replicas; docs/serving.md)")
    ap.add_argument("--serve-staleness", type=float,
                    default=float(os.environ.get("GEOMX_SERVE_STALENESS_S",
                                                 "0") or 0),
                    help="replica read-staleness bound in seconds "
                         "(default Config.serve_staleness_s = 5.0)")
    ap.add_argument("--base-port", type=int,
                    default=int(os.environ.get("GEOMX_BASE_PORT", "9200")))
    ap.add_argument("--advertise", default=os.environ.get("GEOMX_ADVERTISE"),
                    metavar="HOST:PORT",
                    help="replacement node: bind+announce this address "
                         "instead of the static plan's slot")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="worker compute device: cuda (default) or cpu")
    ap.add_argument("--log-every", type=int, default=0, metavar="N",
                    help="harness hook, set by geomx_tpu_torch."
                         "acceptance's failover cases to time the kill "
                         "and compare losses: a CNN worker prints "
                         "'round K loss=L' every N rounds (0 = off)")
    ap.add_argument("--start-gate", default=None, metavar="PATH",
                    help="harness hook, set by geomx_tpu_torch."
                         "acceptance's failover case for its returning "
                         "zombie: load the role's modules and its device, "
                         "then wait for PATH to exist before building the "
                         "runtime")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--workload", default="cnn", choices=["cnn", "lm"],
                    help="worker demo: the reference CNN or the flagship "
                         "transformer LM (>=10M params, GEOMX_LM_* sized)")
    ap.add_argument("--join", action="store_true",
                    help="this worker is OUT-OF-PLAN: register with the "
                         "party server mid-training (ADD_NODE), train, "
                         "then leave gracefully; requires --advertise "
                         "for TCP so peers can dial the new slot")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--hfa", action="store_true")
    ap.add_argument("--hfa-k1", type=int,
                    default=int(os.environ.get("GEOMX_HFA_K1", "2")),
                    help="HFA local steps between weight syncs "
                         "(ref: MXNET_KVSTORE_HFA_K1)")
    ap.add_argument("--esync", action="store_true",
                    help="straggler-balancing local steps (HFA-mode "
                         "servers + per-round step assignment)")
    ap.add_argument("--p3", action="store_true")
    ap.add_argument("--tsengine", action="store_true")
    ap.add_argument("--tsengine-inter", action="store_true")
    ap.add_argument("--tsengine-inter-push", action="store_true")
    ap.add_argument("--sync", default="fsa", choices=["fsa", "mixed"])
    ap.add_argument("--dgt", type=int, default=0, choices=[0, 1, 2, 3])
    ap.add_argument("--central-worker", action="store_true",
                    help="topology includes a dedicated master worker in "
                         "the central party (ref: DMLC_ENABLE_CENTRAL_WORKER)")
    ap.add_argument("--trace-sample-every", type=int,
                    default=int(os.environ.get("GEOMX_TRACE_SAMPLE_EVERY",
                                               "0")),
                    help="distributed tracing: trace every N-th round "
                         "end-to-end (0 = off); the global scheduler "
                         "merges all nodes' spans and writes the timeline "
                         "+ critical-path report to --trace-dir")
    ap.add_argument("--trace-dir",
                    default=os.environ.get("GEOMX_TRACE_DIR", ""))
    ap.add_argument("--obs", action="store_true",
                    help="cluster telemetry plane: per-node metrics "
                         "pumps ship time-series samples to a collector "
                         "+ SLO health engine on the global scheduler; "
                         "query live state with python -m "
                         "geomx_tpu_torch.status (GEOMX_OBS_* tune it; see "
                         "docs/observability.md)")
    ap.add_argument("--obs-interval", type=float,
                    default=float(os.environ.get("GEOMX_OBS_INTERVAL",
                                                 "0") or 0),
                    help="pump/health cadence in seconds (implies --obs "
                         "when > 0)")
    ap.add_argument("--adaptive-wan", action="store_true",
                    help="closed-loop WAN codec autotuning: a controller "
                         "on the global scheduler retunes compression "
                         "mid-training via epoch-fenced SET_WAN_POLICY "
                         "broadcasts (GEOMX_ADAPT_* tune the loop; see "
                         "docs/adaptive-wan.md)")
    ap.add_argument("--server-shards", type=int,
                    default=int(os.environ.get("GEOMX_SERVER_SHARDS", "0")),
                    help="key-sharded server merge: lock stripes + "
                         "serial merge lanes per server (0 = auto "
                         "min(8, cpus); 1 = the single-lock server; "
                         "see docs/perf.md)")
    ap.add_argument("--transport",
                    default=os.environ.get("GEOMX_TRANSPORT", ""),
                    choices=["", "threads", "reactor"],
                    help="transport engine: threads (default) = the "
                         "thread-per-endpoint fabric; reactor = every "
                         "endpoint in the process serviced by a shared "
                         "selector-loop pool + timer wheel "
                         "(GEOMX_REACTOR_LOOPS sizes it; see "
                         "docs/perf.md 'Event-driven transport')")
    ap.add_argument("--merge-backend",
                    default=os.environ.get("GEOMX_MERGE_BACKEND", "auto"),
                    choices=["auto", "numpy", "torch", "torch:cpu"],
                    help="server merge lane engine: numpy = host "
                         "reference path, torch = on-device accumulate, "
                         "optimizer and codec stage on CUDA, torch:cpu = "
                         "the torch backend on the host, auto = torch "
                         "(raises without CUDA; see "
                         "docs/merge-backends.md)")
    ap.add_argument("--optimizer", default="adam",
                    choices=["sgd", "adam", "dcasgd"])
    args = ap.parse_args(argv)
    if not args.role:
        ap.error("--role or GEOMX_ROLE required")
    if (args.esync or args.hfa) and args.workload == "lm":
        # --esync/--hfa force HFA-mode servers (weight averaging); the
        # lm workload pushes GRADIENTS — dispatching it against HFA
        # servers would silently train garbage
        ap.error("--workload lm is mutually exclusive with --esync/--hfa")
    if args.join and (args.esync or args.p3 or args.workload != "cnn"):
        # the KVSTORE layer is join-uniform across every mode —
        # test_join_under_{intra_ts,hfa,p3,esync} prove it — but the
        # p3/esync DEMO workloads (staged MLP / esync loop) have no
        # joiner bootstrap in this launcher, so their flags stay gated
        # here; --hfa and --tsengine joiners run the full flow
        ap.error("--join supports the cnn workload (plain, --hfa or "
                 "--tsengine); p3/esync joins are library-level "
                 "(see tests/test_dynamic_join.py), lm has none")
    if args.join and not args.advertise:
        # without an advertised bind address the out-of-plan node has no
        # slot in the TCP plan and dies with a bare KeyError at bind
        ap.error("--join requires --advertise HOST:PORT")

    node = NodeId.parse(args.role)
    # env supplies the full documented knob surface (drop injection,
    # resend, heartbeats, tuning — docs/env-vars.md); CLI flags override
    cfg = Config.from_env()
    central = (args.central_worker
               or cfg.topology.central_worker
               or node.role is Role.MASTER_WORKER)
    cfg.topology = Topology(num_parties=args.parties,
                            workers_per_party=args.workers,
                            num_global_servers=(args.global_shards
                                                or args.global_servers),
                            num_standby_globals=args.standby_globals,
                            num_replicas=(args.replicas
                                          or cfg.topology.num_replicas),
                            central_worker=central)
    if args.serve_staleness > 0:
        cfg.serve_staleness_s = args.serve_staleness
    if args.transport:
        cfg.transport = args.transport
    cfg.compression = args.compression
    # ESync exchanges weights like HFA — servers must run in HFA mode
    # (ref: examples/cnn.py wires --esync the same way)
    cfg.use_hfa = args.hfa or args.esync or cfg.use_hfa
    cfg.enable_p3 = args.p3 or cfg.enable_p3
    cfg.enable_intra_ts = args.tsengine or cfg.enable_intra_ts
    cfg.enable_inter_ts = (args.tsengine_inter or args.tsengine_inter_push
                           or cfg.enable_inter_ts)
    cfg.enable_inter_ts_push = (args.tsengine_inter_push
                                or cfg.enable_inter_ts_push)
    cfg.sync_global_mode = (args.sync == "fsa") and cfg.sync_global_mode
    cfg.enable_dgt = args.dgt or cfg.enable_dgt
    cfg.trace_sample_every = (args.trace_sample_every
                              or cfg.trace_sample_every)
    cfg.trace_dir = args.trace_dir or cfg.trace_dir
    cfg.adaptive_wan = args.adaptive_wan or cfg.adaptive_wan
    cfg.enable_obs = args.obs or args.obs_interval > 0 or cfg.enable_obs
    if args.obs_interval > 0:
        cfg.obs_interval_s = args.obs_interval
    cfg.server_shards = args.server_shards or cfg.server_shards
    cfg.merge_backend = args.merge_backend or cfg.merge_backend
    # CLI overrides bypass dataclass construction — re-run the invariant
    # checks so invalid combinations fail here, not as a runtime hang
    cfg.__post_init__()
    # refuse a missing card before any socket is bound: workers compute
    # on --device, servers merge on the resolved backend's device
    _check_device(node, cfg, args)
    if args.start_gate:
        _wait_at_gate(node, cfg, args)
    advertise = None
    if args.advertise:
        host, sep, port = args.advertise.rpartition(":")
        if not sep or not port.isdigit():
            ap.error(f"--advertise needs HOST:PORT, got {args.advertise!r}")
        advertise = (host or "127.0.0.1", int(port))
    po, role_obj, stop_ev = build_runtime(node, cfg, args.base_port,
                                          advertise=advertise)
    # black-box flight recorder crash/exit trigger: dump this node's
    # ring to GEOMX_OBS_DIR at interpreter exit and on SIGTERM/SIGINT
    # (SIGKILL leaves no dump — the postmortem assembler infers the
    # victim from the survivors' rings; docs/observability.md)
    from geomx_tpu_torch.obs.flight import install_process_hooks

    install_process_hooks(po)
    if cfg.enable_preempt:
        # spot semantics: SIGTERM = the preemption NOTICE (graceful
        # drain — installed after the flight hooks, so it owns the
        # signal; the exit-path dump still lands via atexit).  SIGKILL
        # keeps the ungraceful eviction/rejoin path.
        install_preempt_handler(po, role_obj, stop_ev)
    print(f"{node}: up", flush=True)
    if node.role is Role.WORKER:
        if args.workload == "lm":
            _worker_demo_lm(po, role_obj, args)
        elif args.esync:
            _worker_demo_esync(po, role_obj, args)
        elif cfg.enable_p3:
            # P3 deployments train through the staged overlap loop —
            # that IS the feature (priority-scheduled per-stage rounds)
            _worker_demo_staged(po, role_obj, args)
        elif args.join:
            _worker_demo(po, role_obj, args, join_advertise=advertise)
        else:
            _worker_demo(po, role_obj, args)
    elif node.role is Role.MASTER_WORKER:
        # the master worker's whole life: configure, then return before
        # training (ref: examples/cnn.py:96 — master returns after setup)
        role_obj.set_optimizer({"type": args.optimizer, "lr": 0.01})
        role_obj.set_sync_global_mode(args.sync == "fsa")
        if args.compression != "none":
            role_obj.set_gradient_compression({"type": args.compression})
        print(f"{node}: configured (optimizer={args.optimizer}, "
              f"sync={args.sync}, compression={args.compression}); "
              "returning before training", flush=True)
    else:
        stop_ev.wait()
        print(f"{node}: terminating", flush=True)
    fab = po.van.fabric
    udp_tx = getattr(fab, "udp_datagrams_sent", 0)
    udp_rx = getattr(fab, "udp_datagrams_recv", 0)
    udp_drop = getattr(fab, "udp_dropped", 0)
    if udp_tx or udp_rx or udp_drop:
        # observability for DGT acceptance runs: proves the lossy
        # channels actually rode UDP datagrams, not the reliable conn
        print(f"{node}: udp_tx={udp_tx} udp_rx={udp_rx} "
              f"udp_dropped={udp_drop}", flush=True)
    # per-feature observables for the acceptance matrix: each proves the
    # feature's mechanism actually fired, not just that training finished
    feats = []
    for attr, tag in (("ts_relays_received", "ts_relays"),
                      ("hfa_gated_key_rounds", "hfa_gated_key_rounds"),
                      ("ts_deliveries", "ts_deliveries"),
                      ("stale_pull_skips", "stale_skips")):
        v = getattr(role_obj, attr, 0)
        if v:
            feats.append(f"{tag}={v}")
    pc = getattr(role_obj, "push_codec", None)
    if pc is not None and getattr(pc, "bsc_picks", 0) + getattr(
            pc, "fp16_picks", 0) > 0:
        feats.append(f"mpq_bsc={pc.bsc_picks} mpq_fp16={pc.fp16_picks}")
    # DGT mode-3 observable: 4-bit requant chunks sent/decoded (the
    # KVWorker apps hold the sender; every app holds a reassembler)
    dgt4_tx = dgt4_rx = 0
    for app in (getattr(role_obj, "worker", None),
                getattr(role_obj, "up", None),
                getattr(role_obj, "server", None)):
        if app is None:
            continue
        s = getattr(app, "dgt_sender", None)
        if s is not None:
            dgt4_tx += getattr(s, "dgt4_chunks", 0)
        r = getattr(app, "_dgt_reasm", None)
        if r is not None:
            dgt4_rx += getattr(r, "dgt4_decoded", 0)
    if dgt4_tx or dgt4_rx:
        feats.append(f"dgt4_tx={dgt4_tx} dgt4_rx={dgt4_rx}")
    # WAN traffic observable (ref: send_bytes_/recv_bytes_ van.h:180-181)
    if po.van.wan_send_bytes or po.van.wan_recv_bytes:
        feats.append(f"wan_tx={po.van.wan_send_bytes} "
                     f"wan_rx={po.van.wan_recv_bytes}")
    # dynamic membership observable (ADD_NODE joins/leaves served)
    if getattr(role_obj, "joined_workers", 0) or getattr(
            role_obj, "left_workers", 0):
        feats.append(f"joined={role_obj.joined_workers} "
                     f"left={role_obj.left_workers}")
    if po.van.pq_overtakes:
        feats.append(f"pq_overtakes={po.van.pq_overtakes}")
    if po.flight is not None and po.flight.dumps:
        # flight-recorder observable: incident/operator dumps taken
        # during the run (the atexit dump lands after this line)
        feats.append(f"flight_dumps={po.flight.dumps}")
    # merge backend observable (kvstore/backend.py): which engine this
    # server's lanes actually ran, + the torch path's device counters
    be = getattr(role_obj, "_backend", None)
    if be is not None:
        bs = be.stats()
        feats.append(f"merge_backend={bs.get('merge_backend')}")
        if bs.get("h2d_bytes"):
            feats.append(f"h2d_bytes={bs['h2d_bytes']} "
                         f"merge_device_ms={bs.get('merge_device_ms')}")
        # device-resident optimizer stage (docs/merge-backends.md):
        # round closes that never left the device + the D2H the serve/
        # checkpoint events actually paid
        dev_opt = getattr(role_obj, "_dev_opt", None)
        if dev_opt is not None:
            feats.append(f"opt_device={dev_opt.kind} "
                         f"opt_device_ms={bs.get('opt_device_ms')} "
                         f"d2h_bytes={bs.get('d2h_bytes')} "
                         f"{dev_opt.state_summary()}")
    # codec kernel observable: a kernel fired in this server process
    codec = _codec_launches(role_obj)
    if codec:
        feats.append(f"codec_launches={codec}")
    # global-tier failover observables (replication stream, promotions,
    # term fencing, client-side retarget+replay)
    for attr, tag in (("failover_events", "failover_events"),
                      ("promotions", "promotions"),
                      ("fenced_rejects", "fenced_rejects"),
                      # sharded global tier: key-range drains shipped /
                      # adopted (live reassignment)
                      ("drains", "drains"),
                      ("merged_handoffs", "merged_handoffs"),
                      # crash-tolerant membership observables: evictions
                      # actuated (schedulers), fenced zombies + warm
                      # boots (local servers), party folds (global tier),
                      # replay-on-recovery (workers)
                      ("evictions", "worker_evictions"),
                      ("evicted_workers", "evicted_workers"),
                      ("eviction_fenced_pushes", "eviction_fenced"),
                      ("warm_boots", "warm_boots"),
                      ("party_folds", "party_folds"),
                      ("party_unfolds", "party_unfolds"),
                      ("server_recoveries", "server_recoveries"),
                      # serve tier observables: reads answered, the
                      # staleness contract's park/expire counters, the
                      # refresh cadence, membership events, and the
                      # tracked-view prunes (replicas + global servers)
                      ("serve_pulls", "serve_pulls"),
                      ("serve_predicts", "serve_predicts"),
                      ("staleness_violations", "staleness_violations"),
                      ("stale_rejects", "stale_rejects"),
                      ("refresh_rounds", "replica_refreshes"),
                      ("dense_resyncs", "dense_resyncs"),
                      ("replica_evictions", "replica_evictions"),
                      ("replica_rejoins", "replica_rejoins"),
                      ("subscriber_prunes", "subscriber_prunes")):
        v = getattr(role_obj, attr, 0)
        if v:
            feats.append(f"{tag}={v}")
    repl = getattr(role_obj, "_repl", None)
    if repl is not None and repl.acked_seq:
        feats.append(f"replicated_seq={repl.acked_seq}")
    if getattr(role_obj, "_repl_seq", 0):
        feats.append(f"applied_repl_seq={role_obj._repl_seq}")
    if getattr(role_obj, "term", 0):
        feats.append(f"term={role_obj.term}")
    if feats:
        print(f"{node}: " + " ".join(feats), flush=True)
    if cfg.trace_sample_every > 0:
        from geomx_tpu_torch.trace import get_tracer

        get_tracer(str(node)).flush()
        coll = getattr(po, "trace_collector", None)
        if coll is not None:
            # grace for the last TRACE_REPORT batches to land, then dump
            # the merged timeline + critical-path report
            time.sleep(1.0)
            out_dir = cfg.trace_dir or "."
            os.makedirs(out_dir, exist_ok=True)
            trace_path = os.path.join(out_dir, "geomx_trace.json")
            coll.dump(trace_path)
            report_path = os.path.join(out_dir, "geomx_trace_report.json")
            import json as _json

            with open(report_path, "w") as f:
                _json.dump(coll.critical_path(), f, indent=1)
            print(f"{node}: merged trace -> {trace_path}; critical-path "
                  f"report -> {report_path}", flush=True)
            txt = coll.report_text()
            if txt:
                print(txt, flush=True)
    # telemetry exit lines (global scheduler): the final cluster state
    # + health transition totals, and — when GEOMX_OBS_DIR names a
    # directory — the Prometheus exposition + alert history artifacts
    svc = getattr(po, "state_service", None)
    if svc is not None:
        from geomx_tpu_torch.obs.state import render_text as _render_state

        state = svc.compose()
        health = state.get("health") or {}
        mc = getattr(po, "metrics_collector", None)
        shard_bits = ", ".join(
            "{}:{}@t{}".format(k, v["holder"], v["term"])
            for k, v in sorted(state.get("shards", {}).items()))
        print(f"{node}: cluster_state shards={{{shard_bits}}} "
              f"health_alerts={health.get('transitions_total', 0)} "
              f"obs_reports={mc.reports_received if mc else 0}",
              flush=True)
        print(_render_state(state), flush=True)
        obs_dir = os.environ.get("GEOMX_OBS_DIR", "")
        if obs_dir and mc is not None:
            import json as _json

            os.makedirs(obs_dir, exist_ok=True)
            with open(os.path.join(obs_dir, "geomx_metrics.prom"),
                      "w") as f:
                f.write(mc.prometheus_text())
            with open(os.path.join(obs_dir, "geomx_cluster_state.json"),
                      "w") as f:
                _json.dump(state, f, indent=1)
            print(f"{node}: metrics exposition + cluster state -> "
                  f"{obs_dir}", flush=True)
    if hasattr(role_obj, "_await_inflight_at_exit"):
        # a global server's replication ship and device work end before
        # the interpreter does (C15)
        role_obj._await_inflight_at_exit()
    po.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
