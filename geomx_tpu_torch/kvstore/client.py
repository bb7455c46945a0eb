"""Worker-side distributed kvstore client.

Mirrors the worker API of the reference (ref: python/mxnet/kvstore.py:99-661
KVStore.{init,push,pull,set_optimizer,set_gradient_compression,rank,
num_workers,_barrier}; C++ side src/kvstore/kvstore_dist.h:460-528 Push_,
:355-414 PullImpl).  Values are numpy arrays on the host; the JAX training
step hands gradients off at the slice edge (device→host), and pulls flow
back host→device — see geomx_tpu_torch.parallel for the on-TPU side.

Tensors are encoded into ps keys with the shared KeyPlan (keys.py) so that
the same keys shard across global servers (MultiGPS).  Per-tensor
``priority`` (the reference passes ``priority=-idx``, ref examples/cnn.py:121)
orders sends under P3's priority queue.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from geomx_tpu_torch.core.config import Config, Group, NodeId
from geomx_tpu_torch.kvstore.common import APP_PS, Cmd, Ctrl
from geomx_tpu_torch.kvstore.keys import KeyPlan
from geomx_tpu_torch.ps import KVPairs, KVWorker, Postoffice
from geomx_tpu_torch.ps.postoffice import split_range
from geomx_tpu_torch.transport.message import Control, Domain, Message


class WorkerKVStore:
    def __init__(self, postoffice: Postoffice, config: Optional[Config] = None):
        self.po = postoffice
        self.config = config or postoffice.config
        topo = postoffice.topology
        assert postoffice.node.is_worker
        self.rank = postoffice.node.rank
        self.party = postoffice.node.party
        self.num_workers = topo.workers_per_party        # in my party
        self._membership_seen = -1   # last applied broadcast stamp
        self.num_all_workers = topo.num_workers_total    # ref: GetAllWorkerSize
        slice_elems = 0
        if self.config.enable_p3:
            slice_elems = self.config.p3_slice_elems or self.config.bigarray_bound
        self.plan = KeyPlan(
            num_shards=topo.num_global_servers,
            bigarray_bound=self.config.bigarray_bound,
            slice_elems=slice_elems,
        )
        self.worker = KVWorker(
            APP_PS, 1 + self.rank, postoffice,
            targets=[topo.server(self.party)],
            key_ranges=split_range(1),
            domain=Domain.LOCAL,
            owns_app=True,  # inbound TS relays route to this customer
        )
        # TSEngine intra-party overlay: pulls are served from the relay
        # buffer instead of the server (ref: KVWorker::AutoPull blocks on
        # auto_pull_kvs_ kv_app.h:1408-1455)
        self.ts_client = None
        self.ts_push = None
        if self.config.enable_intra_ts:
            from geomx_tpu_torch.sched.tsengine import TsClient
            from geomx_tpu_torch.sched.ts_push import TsPushWorker

            self.ts_client = TsClient(postoffice, topo.scheduler(self.party))
            self._ts_cv = threading.Condition()
            self._ts_buf: Dict[int, np.ndarray] = {}
            self._ts_count: Dict[int, int] = {}
            self.ts_relays_received = 0  # overlay acceptance observable
            self._push_rounds: Dict[int, int] = {}
            self.worker.ts_handler = self._on_ts_relay
            # push-direction overlay: worker-to-worker merge trees
            # (ref: ASK_PUSH pairing van.cc:1197-1252)
            self.ts_push = TsPushWorker(postoffice, topo.scheduler(self.party),
                                        self.worker)
        self._shapes: Dict[int, tuple] = {}
        self._dtypes: Dict[int, np.dtype] = {}
        self._pending: List[int] = []
        self._last_push_ts: Dict[int, int] = {}
        self._mu = threading.Lock()
        # distributed tracing: the worker is where a sampled round's root
        # span opens (trace_round); push/pull issue spans hang under it
        from geomx_tpu_torch.trace.recorder import get_tracer

        self._tracer = get_tracer(str(postoffice.node))
        # dynamic membership: track the server's join/leave broadcasts
        postoffice.add_control_hook(self._membership_hook)
        # global-tier failover: workers never talk to the global tier
        # directly (the party server does), but they track the
        # NEW_PRIMARY broadcasts for observability — a training loop can
        # read .failover_events / .global_primaries to know its WAN root
        # moved (and by which term)
        self.failover_events = 0
        self.global_primaries: Dict[int, str] = {}
        self._primary_terms: Dict[int, int] = {}
        postoffice.add_control_hook(self._failover_hook)
        # local-server recovery: the global scheduler's REJOIN broadcast
        # says our party server warm-booted after a crash — replay every
        # un-ACKed request at it immediately instead of waiting out the
        # retry backoff (the PR 1 retarget+replay machinery, old == new)
        self.server_recoveries = 0
        self._last_dead_nodes = 0  # num_dead_nodes graceful degradation
        postoffice.add_control_hook(self._server_back_hook)
        # graceful preemption drain (Control.PREEMPT_NOTICE; see
        # docs/deployment.md "Elasticity & preemption").  The notice
        # flag always exists (training loops poll it cheaply); the wire
        # hook is registered ONLY under Config.enable_preempt — default
        # off leaves the membership machinery bit-for-bit legacy.
        self.preempt_noticed = threading.Event()
        self.drain_complete = threading.Event()
        self.preempt_drains = 0
        self.last_drain_s: Optional[float] = None
        self._drain_started = False
        if self.config.enable_preempt:
            postoffice.add_control_hook(self._preempt_hook)

    def _preempt_hook(self, msg) -> bool:
        """A spot-preemption notice arrived: drain gracefully.  The
        reply is sent AFTER the drain completed (flushed + left), so
        the notifier's reply latency IS the notice→fold latency."""
        if msg.control is not Control.PREEMPT_NOTICE or not msg.request:
            return False
        body = msg.body if isinstance(msg.body, dict) else {}
        token = body.get("token")

        def reply():
            try:
                self.po.van.send(msg.reply_to(
                    control=Control.PREEMPT_NOTICE, body={
                        "ok": self.drain_complete.is_set(),
                        "drain_s": self.last_drain_s,
                        "node": str(self.po.node), "token": token}))
            except (KeyError, OSError):
                pass  # notifier gone — the drain still happened

        self.begin_drain(on_done=reply)
        return True

    def begin_drain(self, on_done=None) -> bool:
        """Start the graceful drain (idempotent): announce the drain to
        the party scheduler (holds eviction for the drain window), wait
        for the training loop to finish its in-flight step and for every
        un-ACKed push/pull to settle, then leave the party — the server
        folds this member out immediately.  Runs off the hook thread;
        returns False if a drain was already running (``on_done`` still
        fires after that drain)."""
        with self._mu:
            first = not self._drain_started
            self._drain_started = True
        self.preempt_noticed.set()
        if not first:
            if on_done is not None:
                threading.Thread(
                    target=lambda: (self.drain_complete.wait(
                        self.config.preempt_drain_s + 5.0), on_done()),
                    daemon=True,
                    name=f"preempt-wait-{self.po.node}").start()
            return False
        # eviction hold: the scheduler must not declare us dead while we
        # flush (the notice wins the race against heartbeat expiry)
        try:
            self.po.van.send(Message(
                recipient=self.po.topology.scheduler(self.party),
                control=Control.PREEMPT_NOTICE, domain=Domain.LOCAL,
                request=False,
                body={"event": "draining", "node": str(self.po.node)}))
        except (KeyError, OSError):
            pass  # scheduler dark: the drain itself still proceeds
        threading.Thread(target=self._drain_body, args=(on_done,),
                         daemon=True,
                         name=f"preempt-drain-{self.po.node}").start()
        return True

    def _drain_body(self, on_done):
        t0 = time.monotonic()
        deadline = t0 + self.config.preempt_drain_s
        try:
            # flush un-ACKed work: the training loop breaks at its next
            # step boundary (it polls preempt_noticed), so poll until
            # the pending set is empty AND stays empty for one beat —
            # bounded by the drain window (a wedged round must not
            # outlive the preemption)
            settled = 0
            while time.monotonic() < deadline:
                with self._mu:
                    pending = list(self._pending)
                if not pending:
                    settled += 1
                    if settled >= 2:
                        break
                    time.sleep(0.02)
                    continue
                settled = 0
                for ts in pending:
                    try:
                        self.worker.customer.wait(
                            ts, timeout=max(0.1, deadline
                                            - time.monotonic()))
                    except TimeoutError:
                        break
                with self._mu:
                    self._pending = [t for t in self._pending
                                     if t not in pending]
            # the final graceful leave: the server folds us out NOW —
            # rounds and (via the scheduler's membership tracking)
            # barriers continue on the survivor set
            self.leave_party(timeout=max(
                1.0, deadline - time.monotonic()))
        except Exception:
            import logging

            logging.getLogger(__name__).exception(
                "%s: preempt drain failed (falling back to the "
                "eviction path)", self.po.node)
        else:
            self.last_drain_s = round(time.monotonic() - t0, 4)
            self.preempt_drains += 1
            from geomx_tpu_torch.utils.metrics import system_counter

            system_counter(f"{self.po.node}.preempt_drains").inc()
            if self.po.flight is not None:
                from geomx_tpu_torch.obs.flight import FlightEv

                self.po.flight.record(
                    FlightEv.FOLD, a=int(self.last_drain_s * 1e6),
                    peer=str(self.po.node), note="preempt_drain")
            print(f"{self.po.node}: preempt drain complete — left "
                  f"gracefully in {self.last_drain_s:.3f}s", flush=True)
        finally:
            self.drain_complete.set()
            if on_done is not None:
                on_done()

    def finish_drain(self, timeout: Optional[float] = None) -> bool:
        """Block until a started drain finished (the launch.py SIGTERM
        path calls this after the training loop broke)."""
        return self.drain_complete.wait(
            timeout if timeout is not None
            else self.config.preempt_drain_s + 5.0)

    def _server_back_hook(self, msg) -> bool:
        if msg.control is not Control.REJOIN or msg.request:
            return False
        b = msg.body if isinstance(msg.body, dict) else {}
        if b.get("event") != "server_back":
            return False
        srv = self.po.topology.server(self.party)
        if b.get("server") not in (None, str(srv)):
            return True  # another party's server (shouldn't reach us)
        with self._mu:
            # a replacement server restarts its membership seq at 0; a
            # stale high watermark would make us discard its broadcasts
            # forever (same reset as an explicit re-join)
            self._membership_seen = -1
        replayed = self.worker.retarget(srv, srv)
        self.server_recoveries += 1
        from geomx_tpu_torch.utils.metrics import system_counter

        system_counter(f"{self.po.node}.server_recoveries").inc()
        print(f"{self.po.node}: party server recovered — replayed "
              f"{replayed} un-ACKed requests", flush=True)
        return True

    # ---- helpers ------------------------------------------------------------
    def _encode(self, tid: int, flat: np.ndarray, priority: int = 0) -> KVPairs:
        """Encode ``flat`` into the tensor's partition plan.  When the
        parts tile ``flat`` exactly the returned KVPairs ALIASES it
        (see push()'s aliasing contract) — callers hand the result to
        the van and must not mutate ``flat`` until acked."""
        parts = sorted(self.plan.parts(tid, flat.size, priority),
                       key=lambda p: p.ps_key)
        keys = np.array([p.ps_key for p in parts], dtype=np.int64)
        lens = np.array([p.length for p in parts], dtype=np.int64)
        # partition plans slice the tensor in key order: when the parts
        # tile ``flat`` exactly, skip the concatenate — the push payload
        # is the caller's buffer (in-proc delivery is zero-copy; servers
        # copy on first touch, and the caller must not mutate the buffer
        # until the push is acked — the reference's async-push contract)
        off = 0
        for p in parts:
            if p.start != off:
                break
            off += p.length
        if off == flat.size:
            return KVPairs(keys, flat, lens)
        vals = np.concatenate([flat[p.start:p.start + p.length] for p in parts])
        return KVPairs(keys, vals, lens)

    def _decode(self, tid: int, kvs: KVPairs) -> np.ndarray:
        size = int(np.prod(self._shapes[tid])) if self._shapes[tid] else 1
        parts = {p.ps_key: p for p in self.plan.parts(tid, size)}
        out = np.empty(size, dtype=np.float32)
        for k, v in kvs.slices():
            p = parts[k]
            out[p.start:p.start + p.length] = v
        # the fill above is the user-isolation copy; copy=False keeps
        # the f32 common case from paying a second full memcpy
        return out.reshape(self._shapes[tid]).astype(
            self._dtypes[tid], copy=False)

    def _track(self, ts: int):
        with self._mu:
            self._pending.append(ts)

    def trace_round(self, round_idx: int):
        """Root span of one synchronization round (no-op unless
        ``Config.trace_sample_every`` hits this round).  Wrap the whole
        step — grad compute, pushes, pulls, wait — so every message the
        step sends joins the round's trace:

            with kv.trace_round(step):
                ... push/pull ...
                kv.wait_all()
        """
        return self._tracer.round(round_idx,
                                  self.config.trace_sample_every)

    def span(self, name: str):
        """A span of this worker's on its node's tracer
        (:mod:`geomx_tpu_torch.trace.recorder`): how the training loops
        time the model step and the copies to and from the host."""
        return self._tracer.span(name)

    # ---- public API ---------------------------------------------------------
    def init(self, tid: int, value: np.ndarray, barrier: bool = False,
             overwrite: bool = False):
        """Initialize a tensor. Call on every worker; rank-0 of each party
        does the actual send (ref: kvstore_dist.h:300-330 InitImpl — only
        rank 0 pushes init, others wait on barrier).

        Unlike the reference (where each worker is an OS process and
        InitImpl always barriers), the barrier is opt-in: single-threaded
        simulations drive all workers from one thread and must skip it;
        threaded/multi-process workers should pass ``barrier=True``.

        ``overwrite`` replaces the servers' value even if the key exists
        (checkpoint restore onto a live cluster).  Only call it between
        rounds — an overwrite racing an in-flight aggregation round
        mixes old- and new-weight gradients."""
        value = np.asarray(value)
        self._shapes[tid] = value.shape
        self._dtypes[tid] = value.dtype
        if self.rank == 0:
            flat = value.astype(np.float32).ravel()
            body = {"overwrite": True} if overwrite else None
            self.worker.zpush(self._encode(tid, flat), cmd=Cmd.INIT,
                              wait=True, body=body)
        if barrier:
            self.barrier()

    def init_all(self, values: Dict[int, np.ndarray],
                 overwrite: bool = False):
        """Batch init of many tensors in ONE request per server — used by
        checkpoint restore so a 50-leaf model costs one round trip (and
        one server-side compressor rebuild / baseline checkpoint), not
        fifty."""
        pairs = []  # (ps_key, payload)
        for tid in sorted(values):
            v = np.asarray(values[tid])
            self._shapes[tid] = v.shape
            self._dtypes[tid] = v.dtype
            if self.rank == 0:
                kvs = self._encode(tid, v.astype(np.float32).ravel())
                pairs.extend((int(k), np.array(p)) for k, p in kvs.slices())
        if self.rank != 0 or not pairs:
            return
        pairs.sort(key=lambda p: p[0])
        body = {"overwrite": True} if overwrite else None
        self.worker.zpush(KVPairs(
            np.array([k for k, _ in pairs], dtype=np.int64),
            np.concatenate([p for _, p in pairs]),
            np.array([len(p) for _, p in pairs], dtype=np.int64),
        ), cmd=Cmd.INIT, wait=True, body=body)

    def _on_ts_relay(self, msg):
        """Receive an overlay relay: buffer the model, confirm delivery,
        relay onward per the scheduler (ref: TS_Process kv_app.h:1111-1179).
        The relay loop runs on the TsClient's dissemination thread — never
        on this customer thread, which must stay free to receive replies."""
        from geomx_tpu_torch.ps import KVPairs as _KVPairs

        it = str(msg.body["iter"])
        kvs = _KVPairs(msg.keys, msg.vals, msg.lens)
        with self._ts_cv:
            self.ts_relays_received += 1
            for k, v in kvs.slices():
                self._ts_buf[k] = np.array(v, copy=True)
                self._ts_count[k] = self._ts_count.get(k, 0) + 1
            self._ts_cv.notify_all()
        self.ts_client.send_reply(msg.sender, it)
        self.ts_client.disseminate_async(msg.keys, msg.vals, msg.lens, it,
                                         Cmd.TS_AUTOPULL)

    def _membership_hook(self, msg) -> bool:
        """Persistent hook: the party server broadcasts the new
        aggregation size on every join/leave; the per-step gradient
        pre-scale (1/num_workers) must track it or post-join updates
        stop being a mean.  Broadcasts are stamped with the server's
        membership sequence; a stale stamp (two concurrent membership
        changes, sends racing) must not roll the pre-scale back to an
        older target — that would be a PERSISTENT mean-scale error, not
        a transient."""
        if (msg.control is Control.ADD_NODE and not msg.request
                and isinstance(msg.body, dict)
                and msg.body.get("event") == "membership"):
            from geomx_tpu_torch.transport.van import apply_member_addrs

            # out-of-plan members' addresses first (not seq-guarded:
            # an address is never stale the way a count is, and a TS
            # relay to the joiner may be imminent)
            apply_member_addrs(self.po.van.fabric,
                               msg.body.get("addrs"), str(self.po.node))
            self._apply_membership(msg.body)
            return True
        return False

    def _failover_hook(self, msg) -> bool:
        """Track Control.NEW_PRIMARY broadcasts (global-tier failover).
        Term-guarded like the server-side hook: rebroadcasts and stale
        duplicates must not double-count or roll the map back."""
        if msg.control is not Control.NEW_PRIMARY or msg.request:
            return False
        b = msg.body if isinstance(msg.body, dict) else {}
        rank, term = int(b.get("rank", -1)), int(b.get("term", 0))
        with self._mu:
            if term <= self._primary_terms.get(rank, 0):
                return True
            self._primary_terms[rank] = term
            self.global_primaries[rank] = str(b.get("new"))
            self.failover_events += 1
        return True

    def _addnode_rpc(self, body: dict, timeout: float,
                     attempts: int = 3) -> dict:
        """ADD_NODE request/reply round trip to the party server.

        Control messages are outside the resender (it covers data
        traffic), so the request is retried here: the server handler is
        idempotent by node id (a replayed join re-uses the assigned
        rank, a replayed leave is a no-op), which is exactly what makes
        client-side retry safe under drop injection / lossy links.  The
        reply hook is one-shot AND unregistered on exit — a stale armed
        hook would swallow the reply meant for a later call."""
        cv = threading.Condition()
        reply: dict = {}
        # correlation token: retries make the server reply more than
        # once, and a STALE duplicate (e.g. from an earlier join) must
        # not satisfy a later call whose own request was lost — the
        # server echoes the token and the hook matches it
        with self._mu:
            self._addnode_seq = getattr(self, "_addnode_seq", 0) + 1
            token = f"{self.po.node}#{self._addnode_seq}"
        body = dict(body, token=token)

        def hook(msg) -> bool:
            b = msg.body if isinstance(msg.body, dict) else {}
            if (msg.control is Control.ADD_NODE and not msg.request
                    and "event" not in b and b.get("token") == token):
                with cv:
                    if "body" in reply:
                        return False
                    reply["body"] = b
                    cv.notify_all()
                return True
            return False

        self.po.add_control_hook(hook)
        try:
            deadline = time.monotonic() + timeout
            per_try = timeout / attempts
            for i in range(attempts):
                self.po.van.send(Message(
                    recipient=self.po.topology.server(self.party),
                    control=Control.ADD_NODE, domain=Domain.LOCAL,
                    request=True, body=body))
                # never exceed the caller's total timeout contract
                wait = min(per_try, max(deadline - time.monotonic(), 0.0))
                with cv:
                    if cv.wait_for(lambda: "body" in reply, timeout=wait):
                        break
                if time.monotonic() >= deadline:
                    break
            if "body" not in reply:
                raise TimeoutError(
                    f"{self.po.node}: ADD_NODE rpc timed out "
                    f"({attempts} attempts)")
        finally:
            self.po.remove_control_hook(hook)
        b = reply["body"]
        if "error" in b:
            raise RuntimeError(f"ADD_NODE rejected: {b['error']}")
        return b

    def join_party(self, timeout: float = 30.0,
                   advertise: Optional[tuple] = None) -> dict:
        """Register this worker with its party server MID-TRAINING
        (ref: the runtime id assignment of ProcessAddNodeCommandAtScheduler
        van.cc:41-112; here the party server owns the count — see
        LocalServer._on_add_node).  The server folds this worker into
        each key's aggregation count immediately (open rounds' targets
        included), and the natural bootstrap order — pull the current
        model, then start pushing — is safe: the server serves pulls
        from workers that have not contributed to the open round out of
        the last COMPLETED round, so our bootstrap pulls never park
        behind rounds that can only complete with our own push.
        Idempotent server-side: retrying after a timeout re-uses the
        assigned rank instead of double-counting.

        The caller must initialize its own model replica (``init`` of
        existing keys is a no-op server-side).  ``advertise``: (host,
        port) for TCP deployments so peers can dial the out-of-plan
        slot (rebroadcast to the whole party — TS relays and scheduler
        replies dial it too).  Returns the server's reply ({"rank",
        "num_workers"}).  Join works under every mode, including
        intra-party TSEngine (scheduler member sets track membership
        broadcasts) and HFA (the weight mean renormalizes via the
        per-push ``hfa_n`` denominator).

        Known limitation: membership lives in the party server's memory
        (like the reference scheduler's node table, which is also
        RAM-only) — if the party server restarts mid-training, joined
        workers must ``join_party`` again; until they do, rounds count
        to the static plan size and a joiner's pushes skew one round's
        mean (same transient class as the leave-side push leak)."""
        body = {"node": str(self.po.node)}
        if advertise is not None:
            body["host"], body["port"] = advertise[0], int(advertise[1])
        # an explicit (re)join resets the stale-broadcast baseline: a
        # RESTARTED party server counts its membership seq from 0 again,
        # and a high watermark from its previous life would make us
        # discard every broadcast of the new one forever
        with self._mu:
            self._membership_seen = -1
        b = self._addnode_rpc(body, timeout)
        self._apply_membership(b)
        return b

    def leave_party(self, timeout: float = 30.0) -> dict:
        """Gracefully leave the aggregation group (the inverse of
        ``join_party``): call AFTER ``wait_all()`` — the server lowers
        its per-round target at the boundary, and any round this worker
        had not yet reached completes without it.  Leaving without this
        call stalls every subsequent FSA round forever.  Idempotent
        server-side (a replayed leave does not double-decrement)."""
        b = self._addnode_rpc(
            {"action": "leave", "node": str(self.po.node)}, timeout)
        self._apply_membership(b)
        return b

    def _apply_membership(self, body: dict):
        """Apply an ADD_NODE reply's (num_workers, seq) through the SAME
        stale-guard as membership broadcasts: a reply built before a
        racing join/leave must not roll the 1/num_workers pre-scale back
        after the newer broadcast already landed."""
        seq = body.get("seq")
        with self._mu:
            if seq is not None and seq <= self._membership_seen:
                return
            if seq is not None:
                self._membership_seen = seq
            self.num_workers = int(body["num_workers"])

    def push(self, tid: int, grad: np.ndarray, priority: int = 0,
             num_merge: int = 1, _count_round: bool = True,
             body: Optional[dict] = None) -> int:
        """Async push of a gradient (ref: kvstore_dist.h:460-528).

        **Aliasing contract (public API)**: when ``grad`` is already
        float32/contiguous the payload ALIASES the caller's buffer all
        the way into the in-proc fabric — no defensive copy is taken.
        The caller must not mutate ``grad`` until the push is acked
        (``wait(ts)`` / ``wait_all()``); reusing the buffer earlier
        silently corrupts the in-flight push.  Servers copy on first
        touch, so the alias never outlives the ack.

        ``num_merge > 1`` marks a pre-merged gradient carrying that many
        workers' contributions (TS push-direction: the elected holder
        pushes once for everyone, ref: num_merge counting van.cc:1197-1252).
        """
        flat = np.asarray(grad, dtype=np.float32).ravel()
        body_out = dict(body) if body else {}
        if num_merge > 1:
            body_out["num_merge"] = int(num_merge)
        fields = {"body": body_out} if body_out else {}
        with self._tracer.span("worker.push"):
            ts = self.worker.zpush(self._encode(tid, flat, priority),
                                   cmd=Cmd.DEFAULT, priority=priority,
                                   **fields)
        with self._mu:
            self._last_push_ts[tid] = ts
            if self.ts_client is not None and _count_round:
                self._push_rounds[tid] = self._push_rounds.get(tid, 0) + 1
        self._track(ts)
        return ts

    def ts_merge_push(self, grads: Dict[int, np.ndarray]) -> bool:
        """Push one round's gradients through the TS merge overlay: join
        the scheduler-paired worker-to-worker merge tree; the elected
        holder pushes the fully-merged set to the server once (counted as
        num_workers contributions).  Returns True if this worker was the
        elected pusher.  Blocks until this worker's overlay role is done."""
        assert self.ts_push is not None, "requires enable_intra_ts"
        res = self.ts_push.merge_push(grads)  # normalizes f32/flat itself
        with self._mu:
            for tid in grads:
                self._push_rounds[tid] = self._push_rounds.get(tid, 0) + 1
        if res is None:
            return False
        merged, num_merge = res
        for tid, g in merged.items():
            self.push(tid, g.reshape(self._shapes[tid]),
                      num_merge=num_merge, _count_round=False)
        return True

    def pull(self, tid: int, cb: Callable[[int, np.ndarray], None],
             priority: int = 0) -> int:
        """Async pull; cb(tid, tensor) runs when all shards arrived
        (ref: kvstore_dist.h:355-414 PullImpl).

        Under intra-TS the overlay delivers the model instead — block on
        the relay buffer, no server round-trip (ref: AutoPull
        kvstore_dist.h:393-398, kv_app.h:1408-1455)."""
        size = int(np.prod(self._shapes[tid])) if self._shapes[tid] else 1
        # before any push the overlay has never relayed this tensor —
        # fall through to a normal server pull (want == 0)
        if self.ts_client is not None and self._push_rounds.get(tid, 0) > 0:
            parts = {p.ps_key: p for p in self.plan.parts(tid, size)}
            want = self._push_rounds.get(tid, 0)
            with self._ts_cv:
                ok = self._ts_cv.wait_for(
                    lambda: all(self._ts_count.get(k, 0) >= want
                                for k in parts),
                    timeout=self.config.ts_relay_wait_s)
                if not ok:
                    raise TimeoutError(
                        f"{self.po.node}: TS overlay never delivered t{tid}")
                out = np.empty(size, dtype=np.float32)
                for k, p in parts.items():
                    out[p.start:p.start + p.length] = self._ts_buf[k]
            cb(tid, out.reshape(self._shapes[tid]).astype(self._dtypes[tid], copy=False))
            return self.worker.customer.new_request(0)  # already complete
        keys = [p.ps_key for p in self.plan.parts(tid, size)]
        with self._mu:
            after = self._last_push_ts.get(tid)

        def decode(kvs):
            # runs on the response-delivery thread under the response's
            # trace context — the decode span closes the round's chain
            with self._tracer.span("worker.pull_decode"):
                out = self._decode(tid, kvs)
            cb(tid, out)

        with self._tracer.span("worker.pull"):
            ts = self.worker.zpull(
                keys, cb=decode,
                cmd=Cmd.DEFAULT, priority=priority, after_ts=after,
            )
        self._track(ts)
        return ts

    # ---- row-sparse (embedding) path ----------------------------------------
    def _rs_check(self, tid: int, row_ids: np.ndarray):
        """Validate a row-sparse access; returns (key, cols).

        Row-sparse tensors must live whole under one ps key (the reference
        never partitions them, ref: EncodeRowSparseKey
        kvstore_dist.h:900-957) — a table big enough to shard across
        global servers, or sliced by P3, is rejected loudly instead of
        corrupting server state.  HFA pushes weights, not gradients, so
        the combination is rejected too."""
        shape = self._shapes[tid]
        if len(shape) != 2:
            raise ValueError("row-sparse requires a 2D tensor")
        if self.config.use_hfa:
            raise ValueError("row-sparse push/pull is incompatible with HFA "
                             "(HFA rounds exchange weights, not gradients)")
        size = int(np.prod(shape))
        parts = self.plan.parts(tid, size)
        if len(parts) != 1:
            raise ValueError(
                f"row-sparse tensor {tid} ({shape}) would be partitioned "
                f"into {len(parts)} keys (bigarray_bound/P3); row-sparse "
                "tensors must fit one shard")
        if row_ids.size and (row_ids.min() < 0 or row_ids.max() >= shape[0]):
            raise ValueError(
                f"row ids out of range for tensor {tid} with {shape[0]} rows")
        return parts[0].ps_key, shape[1]

    def push_row_sparse(self, tid: int, row_ids: np.ndarray,
                        rows: np.ndarray, priority: int = 0) -> int:
        """Push gradients for a subset of rows of a 2D tensor
        (ref: row-sparse push kvstore_dist.h:628-702).  Only active rows
        cross the LAN; the merged round crosses the WAN sparse when that
        is smaller."""
        from geomx_tpu_torch.compression.codecs import pack_rows
        from geomx_tpu_torch.ps import KVPairs

        row_ids = np.asarray(row_ids, dtype=np.int64)
        key, cols = self._rs_check(tid, row_ids)
        rows = np.asarray(rows, dtype=np.float32).reshape(len(row_ids), cols)
        payload = pack_rows(row_ids, rows)
        ts = self.worker.zpush(
            KVPairs(np.array([key], np.int64), payload,
                    np.array([len(payload)], np.int64)),
            cmd=Cmd.ROW_SPARSE_PUSH, priority=priority,
            body={"rs_cols": int(cols)},
        )
        with self._mu:
            self._last_push_ts[tid] = ts
        self._track(ts)
        return ts

    def pull_row_sparse(self, tid: int, row_ids: np.ndarray,
                        cb: Callable[[int, np.ndarray], None],
                        priority: int = 0) -> int:
        """Pull only the given rows (ref: PullRowSparse
        include/mxnet/kvstore.h; kvstore_dist.h:662-702).  cb receives
        (tid, rows [len(row_ids), cols]) in row_ids order."""
        row_ids = np.asarray(row_ids, dtype=np.int64)
        key, cols = self._rs_check(tid, row_ids)
        with self._mu:
            after = self._last_push_ts.get(tid)

        def decode(kvs):
            from geomx_tpu_torch.compression.codecs import unpack_rows

            _, rows = unpack_rows(kvs.vals, cols)
            cb(tid, np.array(rows, copy=True))

        ts = self.worker.zpull(
            [key], cb=decode, cmd=Cmd.ROW_SPARSE_PULL, priority=priority,
            after_ts=after,
            body={"rows": row_ids.tolist(), "rs_cols": int(cols)},
        )
        self._track(ts)
        return ts

    def push_pull(self, tid: int, grad: np.ndarray,
                  cb: Callable[[int, np.ndarray], None],
                  priority: int = 0) -> List[int]:
        """P3-style combined push+pull: one request PER SLICE so slices
        are independently schedulable in the priority send queue, and the
        push response carries the updated values when the round completes
        (ref: P3_ZPush per slice kv_app.h:204-259 + fake-pull
        kvstore_dist.h:355-363 — data arrives as push response)."""
        from geomx_tpu_torch.ps import KVPairs

        flat = np.asarray(grad).astype(np.float32).ravel()
        parts = self.plan.parts(tid, flat.size, priority)
        out = np.empty(flat.size, dtype=np.float32)
        remaining = [len(parts)]
        shape, dtype = self._shapes[tid], self._dtypes[tid]

        def make_cb(part):
            def on_data(kvs):
                for _, v in kvs.slices():
                    out[part.start:part.start + part.length] = v
                with self._mu:
                    remaining[0] -= 1
                    done = remaining[0] == 0
                if done:
                    cb(tid, out.reshape(shape).astype(dtype, copy=False))
            return on_data

        tss = []
        for p in parts:
            kvs = KVPairs(np.array([p.ps_key], dtype=np.int64),
                          flat[p.start:p.start + p.length],
                          np.array([p.length], dtype=np.int64))
            ts = self.worker.push_pull(kvs, cb=make_cb(p),
                                       cmd=Cmd.DEFAULT, priority=priority)
            tss.append(ts)
            self._track(ts)
        with self._mu:
            self._last_push_ts[tid] = tss[-1]
        return tss

    def pull_sync(self, tid: int, priority: int = 0) -> np.ndarray:
        out: Dict[int, np.ndarray] = {}
        ts = self.pull(tid, lambda t, arr: out.__setitem__(t, arr), priority)
        self.worker.wait(ts)
        return out[tid]

    def wait_all(self):
        """Drain every outstanding push/pull (ref: kvstore.py _wait
        semantics).  Raises if any server rejected a request."""
        with self._mu:
            pending, self._pending = self._pending, []
        for ts in pending:
            self.worker.wait(ts)
        if self.worker.errors:
            errs, self.worker.errors = list(self.worker.errors), []
            raise RuntimeError("; ".join(errs))

    def barrier(self, is_global: bool = False):
        """Party-wide (workers+server) or WAN-wide barrier
        (ref: kvstore_dist.h:207-210 Barrier(is_global))."""
        if is_global:
            self.po.barrier(Group.GLOBAL_SERVERS | Group.GLOBAL_WORKERS)
        else:
            self.po.barrier(Group.WORKERS)

    # ---- control plane (master-worker commands) -----------------------------
    def global_targets(self) -> List[NodeId]:
        """Current primary of every global shard, deduplicated (a
        key-range drain can merge two shards onto one holder).  Control
        commands are fire-once — no replay layer covers them — so they
        must address each shard's LIVE holder (the NEW_PRIMARY-tracked
        view from ``_failover_hook``), not the static plan primary: a
        worker configuring right after a shard failed over would
        otherwise hang on a corpse."""
        with self._mu:
            prim = dict(self.global_primaries)
        out: List[NodeId] = []
        seen = set()
        for gs in self.po.topology.global_servers():
            cur = prim.get(gs.rank)
            node = NodeId.parse(cur) if cur else gs
            if str(node) not in seen:
                seen.add(str(node))
                out.append(node)
        return out

    def set_optimizer(self, opt_config: dict):
        """Ship the optimizer to every global server (ref:
        kvstore.py:452-499 set_optimizer pickles to the servers)."""
        for gs in self.global_targets():
            self.worker.send_cmd(gs, Ctrl.SET_OPTIMIZER, body=opt_config,
                                 domain=Domain.GLOBAL)

    def set_sync_mode(self, local_sync: bool = True, global_sync: bool = True):
        """ref: kvstore.cc:53-63 — rank-0 worker sends kSyncMode, master
        worker sends kSyncGlobalMode."""
        self.worker.send_cmd(self.po.topology.server(self.party),
                             Ctrl.SET_SYNC_MODE, body={"sync": local_sync})
        for gs in self.global_targets():
            self.worker.send_cmd(gs, Ctrl.SET_SYNC_GLOBAL_MODE,
                                 body={"sync": global_sync}, domain=Domain.GLOBAL)

    def set_gradient_compression(self, comp_config: dict):
        """Configure WAN compression on my party's local server and on
        every global server (push decode + pull-direction sparsifier).

        Like the reference, this configures the *caller's* party — every
        party's rank-0 worker must call it (the reference has every worker
        run the same script, so every server hears it; ref: kvstore.py
        set_gradient_compression → kSetGradientCompression).

        Fields missing from ``comp_config`` fall back to this client's
        Config knobs (twobit_threshold / bsc_* / mpq_size_bound), keeping
        one source of truth for the tuning surface."""
        defaults = {
            "ratio": self.config.bsc_ratio,
            "momentum": self.config.bsc_momentum,
            "sample_rate": self.config.bsc_sample_rate,
            "threshold": self.config.twobit_threshold,
            "size_bound": self.config.mpq_size_bound,
        }
        comp_config = {**defaults, **comp_config}
        targets = [(self.po.topology.server(self.party), Domain.LOCAL)]
        targets += [(gs, Domain.GLOBAL) for gs in self.global_targets()]
        for node, domain in targets:
            reply = self.worker.send_cmd(node, Ctrl.SET_COMPRESSION,
                                         body=comp_config, domain=domain)
            if isinstance(reply, dict) and "error" in reply:
                raise ValueError(reply["error"])

    def set_hfa(self, enabled: bool, k2: int = 1):
        self.worker.send_cmd(self.po.topology.server(self.party),
                             Ctrl.SET_HFA, body={"enabled": enabled, "k2": k2})

    def num_dead_nodes(self, timeout: float = 5.0) -> int:
        """Dead nodes known to my party scheduler (heartbeat timeouts,
        ref: kv.get_num_dead_node kvstore_dist.h:225-234).

        Degrades gracefully when the scheduler is slow or mid-failover:
        on a query timeout this logs and returns the last known count
        instead of propagating — callers poll it for observability, and
        a transient scheduler stall must not kill the training loop."""
        import logging

        try:
            n = len(self.po.query_dead_nodes(timeout=timeout))
        except TimeoutError:
            logging.getLogger(__name__).warning(
                "%s: dead-node query timed out; returning last known "
                "count (%d)", self.po.node, self._last_dead_nodes)
            return self._last_dead_nodes
        self._last_dead_nodes = n
        return n

    def set_server_profiler(self, action: str, include_global: bool = True,
                            **kw) -> List[dict]:
        """Remote profiler control on servers (ref: SetServerProfilerCommand
        include/mxnet/kvstore.h:442).  Returns each server's stats reply."""
        body = {"action": action, **kw}
        targets = [(self.po.topology.server(self.party), Domain.LOCAL)]
        if include_global:
            targets += [(gs, Domain.GLOBAL)
                        for gs in self.global_targets()]
        # overlap the round-trips: send all, then collect
        tss = [self.worker.send_cmd(n, Ctrl.PROFILER, body=body,
                                    domain=d, wait=False)
               for n, d in targets]
        out = []
        for ts in tss:
            self.worker.wait(ts)
            out.append(self.worker.cmd_response(ts))
        return out

    def save_server_checkpoints(self, directory: str) -> List[str]:
        """Checkpoint every global server's state (weights + optimizer) to
        ``directory`` (an improvement over the reference, which keeps
        server state only in RAM — SURVEY.md §5)."""
        return self._checkpoint_cmd("save", directory)

    def load_server_checkpoints(self, directory: str):
        self._checkpoint_cmd("load", directory)

    def _checkpoint_cmd(self, action: str, directory: str) -> List[str]:
        """One overlapped round-trip to every global server.  Paths stay
        keyed by SHARD rank (the relaunch contract) while the command
        addresses the shard's current holder."""
        with self._mu:
            prim = dict(self.global_primaries)
        jobs = []
        for gs in self.po.topology.global_servers():
            path = f"{directory}/global_server_{gs.rank}.npz"
            node = (NodeId.parse(prim[gs.rank])
                    if gs.rank in prim else gs)
            ts = self.worker.send_cmd(
                node, Ctrl.CHECKPOINT,
                body={"action": action, "path": path},
                domain=Domain.GLOBAL, wait=False)
            jobs.append((ts, path))
        paths = []
        for ts, path in jobs:
            self.worker.wait(ts)
            reply = self.worker.cmd_response(ts)
            if isinstance(reply, dict) and "error" in reply:
                raise RuntimeError(reply["error"])
            paths.append(path)
        return paths

    def server_stats(self) -> dict:
        """WAN byte counters from my local server (observability,
        ref: van.h:180-181 byte counters; kv.get_num_dead_node-style query)."""
        return self.worker.send_cmd(
            self.po.topology.server(self.party), Ctrl.QUERY_STATS
        ) or {}

    def esync_report(self, step_s: float, comm_s: float,
                     max_steps: int = 64) -> int:
        """ESync state-server round trip: report this worker's measured
        per-local-step compute time and per-round push+pull time, get
        back the local-step count to run before the next sync
        (geomx_tpu_torch.sched.esync; ref README.md:45 — the reference's
        planned-but-unintegrated straggler balancer)."""
        reply = self.worker.send_cmd(
            self.po.topology.server(self.party), Ctrl.ESYNC,
            body={"worker": str(self.po.node), "step_s": float(step_s),
                  "comm_s": float(comm_s), "max_steps": int(max_steps)},
        ) or {}
        return int(reply.get("steps", 1))

    def stop(self):
        if self.ts_client is not None:
            # stops the dissemination drain (a dedicated thread under
            # the threaded transport, a shared-reactor Periodic under
            # lightweight mode — which would otherwise tick forever)
            self.ts_client.stop()
        self.worker.stop()


class MasterWorker:
    """The central party's control-plane-only client.

    Mirrors the reference master worker (ref: DMLC_ROLE_MASTER_WORKER
    postoffice.cc:32-33; DMLC_ENABLE_CENTRAL_WORKER): it drives cluster
    configuration — optimizer to the global tier, the global sync mode,
    WAN compression — and returns before training begins
    (ref: examples/cnn.py:96 — the master returns right after setup).
    It never pushes gradients and does not count toward any worker
    group's barriers.

    Cross-party control commands travel the GLOBAL domain (they cross
    the WAN from the central party).
    """

    def __init__(self, postoffice: Postoffice, config: Optional[Config] = None):
        self.po = postoffice
        self.config = config or postoffice.config
        topo = postoffice.topology
        assert postoffice.node.role.value == "master_worker"
        # one endpoint toward the global servers; commands to party
        # servers address them directly over the GLOBAL domain
        self.worker = KVWorker(
            APP_PS, 99, postoffice,
            targets=topo.global_servers(),
            key_ranges=split_range(topo.num_global_servers),
            domain=Domain.GLOBAL,
        )
        # global-tier failover: retarget the control endpoint like the
        # local servers retarget their data up-link
        self.failover_events = 0
        self._primary_terms: Dict[int, int] = {}
        self._mw_mu = threading.Lock()
        postoffice.add_control_hook(self._failover_hook)

    def _failover_hook(self, msg) -> bool:
        if msg.control is not Control.NEW_PRIMARY or msg.request:
            return False
        b = msg.body if isinstance(msg.body, dict) else {}
        rank, term = int(b.get("rank", -1)), int(b.get("term", 0))
        with self._mw_mu:
            if term <= self._primary_terms.get(rank, 0):
                return True
            self._primary_terms[rank] = term
            self.failover_events += 1
        self.worker.retarget(NodeId.parse(b["old"]), NodeId.parse(b["new"]))
        return True

    def _global_targets(self) -> List[NodeId]:
        """Current holder of every shard: the KVWorker's target slots
        track NEW_PRIMARY retargets; dedup covers drain-merged shards."""
        out, seen = [], set()
        for n in list(self.worker.targets):
            if str(n) not in seen:
                seen.add(str(n))
                out.append(n)
        return out

    def set_optimizer(self, opt_config: dict):
        """Ship the optimizer to every global server (the master worker's
        defining job, ref: kvstore.py:452-499 → kController command)."""
        for gs in self._global_targets():
            self.worker.send_cmd(gs, Ctrl.SET_OPTIMIZER, body=opt_config,
                                 domain=Domain.GLOBAL)

    def set_sync_global_mode(self, sync: bool):
        """ref: kvstore.cc:56-63 — the master worker sends kSyncGlobalMode."""
        for gs in self._global_targets():
            self.worker.send_cmd(gs, Ctrl.SET_SYNC_GLOBAL_MODE,
                                 body={"sync": sync}, domain=Domain.GLOBAL)

    def set_gradient_compression(self, comp_config: dict):
        """Configure WAN compression everywhere: every party's local
        server plus every global server — the central-driver alternative
        to each party's rank-0 worker configuring its own party."""
        defaults = {
            "ratio": self.config.bsc_ratio,
            "momentum": self.config.bsc_momentum,
            "sample_rate": self.config.bsc_sample_rate,
            "threshold": self.config.twobit_threshold,
            "size_bound": self.config.mpq_size_bound,
        }
        comp_config = {**defaults, **comp_config}
        targets = [(s, Domain.GLOBAL) for s in self.po.topology.servers()]
        targets += [(gs, Domain.GLOBAL)
                    for gs in self._global_targets()]
        for node, domain in targets:
            reply = self.worker.send_cmd(node, Ctrl.SET_COMPRESSION,
                                         body=comp_config, domain=domain)
            if isinstance(reply, dict) and "error" in reply:
                raise ValueError(reply["error"])

    def query_stats(self) -> dict:
        """Aggregate WAN counters across the global tier.  Numeric stats
        sum; boolean stats AND (``optimizer_configured`` must mean EVERY
        shard is configured, or MultiGPS would silently mix optimizers)."""
        out: Dict[str, object] = {}
        for gs in self._global_targets():
            stats = self.worker.send_cmd(gs, Ctrl.QUERY_STATS,
                                         domain=Domain.GLOBAL) or {}
            for k, v in stats.items():
                if isinstance(v, bool):
                    out[k] = bool(out.get(k, True)) and v
                elif isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
        return out

    def stop(self):
        self.worker.stop()
