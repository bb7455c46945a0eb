"""Read-serving model replica: the inference half of a train-and-serve
parameter server.

"Millions of users" means most traffic is *reads of the current model*,
not training pushes (ROADMAP item 2; PAPERS.md: the TensorFlow paper is
the exemplar for coupling training and serving in one PS system).  A
:class:`ModelReplica` is a first-class cluster member (``--role
replica:K`` / ``Topology.num_replicas``) that

- keeps a **full local copy** of every global shard's key range,
  refreshed by staleness-bounded async pulls that ride the exact PR 4
  machinery the local servers use: ``BroadcastCompressor`` sparse
  deltas against this replica's tracked view, the per-key ``pv``
  version handshake, and a forced DENSE resync whenever either side's
  view moved (server restart, lost response, epoch-fenced WAN-policy
  swap — the rebuilt compressor's cleared views make every next pull
  mismatch);
- answers ``Cmd.SERVE_PULL`` (read keys) and ``Cmd.PREDICT`` (a small
  MLP forward pass over the local copy) from memory over the PR 5
  zero-copy wire path — served arrays are frozen and shipped by alias,
  never copied — without ever touching the training lanes;
- enforces the **staleness bound** (``Config.serve_staleness_s``): a
  read is NEVER answered from a copy older than the bound.  A read
  arriving while the copy is stale parks, pokes the refresh thread,
  and is served the moment a refresh lands — or answered with an error
  once the bound passes again with the global tier unreachable.  Every
  successful response body carries ``{staleness_s, version,
  rounds_at_refresh}`` so readers (and the slow e2e) can assert the
  contract;
- is **evictable and rejoinable** via the PR 2 machinery: it heartbeats
  the global scheduler, whose :class:`~geomx_tpu_torch.serve.monitor.
  ReplicaMonitor` turns an expired heartbeat into a subscriber-view
  prune at every shard (freeing the tracked full-model views) and logs
  the rejoin when heartbeats resume — the replica's own refresh then
  heals through a dense resync, no coordination needed;
- follows **failovers and reassignments**: ``Control.NEW_PRIMARY``
  broadcasts (PR 1/PR 6) retarget the subscription up-link and replay
  un-ACKed refresh pulls at the shard's new holder.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from geomx_tpu_torch.core.config import Config, NodeId
from geomx_tpu_torch.kvstore.common import APP_PS, Cmd, Ctrl
from geomx_tpu_torch.ps import KVPairs, KVServer, KVWorker, Postoffice
from geomx_tpu_torch.ps.postoffice import split_range
from geomx_tpu_torch.transport.message import Control, Domain, Message
from geomx_tpu_torch.utils.metrics import system_counter, system_gauge


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return vs[idx]


class ModelReplica:
    """One read-serving replica node (role ``replica:K``)."""

    def __init__(self, postoffice: Postoffice,
                 config: Optional[Config] = None):
        self.po = postoffice
        self.config = config or postoffice.config
        topo = postoffice.topology
        self.staleness_s = float(self.config.serve_staleness_s)
        # refresh cadence clamped under the bound: refreshing slower
        # than the bound would park every read by construction
        iv = float(self.config.serve_refresh_interval_s)
        self.refresh_interval_s = (0.0 if iv <= 0
                                   else min(iv, self.staleness_s / 2))
        # a parked read waits at most one more bound for a refresh to
        # land before it errors (the global tier is unreachable — the
        # caller retries another replica rather than reading stale)
        self._park_timeout_s = max(self.staleness_s, 0.5)
        self.store: Dict[int, np.ndarray] = {}
        self._mu = threading.RLock()
        # per-key pull-view version echoed to the global tier (the PR 4
        # handshake).  -1 = "I hold SOMETHING but no tracked view" — it
        # can never equal a tracked version, so the next compressed
        # pull of that key is forced dense (warm-boot semantics)
        self._pull_ver: Dict[int, int] = {}
        self._parked: List[tuple] = []  # (msg, deadline, t0)
        self._last_refresh: Optional[float] = None
        self._refresh_busy = False
        # observables (stats() + the metrics registry)
        self.refresh_rounds = 0        # completed refresh cycles
        self.rounds_at_refresh = 0     # Σ shard key_rounds the last
        #                                completed refresh reflects (the
        #                                version-lag numerator)
        self.serve_pulls = 0
        self.serve_predicts = 0
        self.staleness_violations = 0  # reads that arrived while the
        #                                copy was stale (parked, never
        #                                served stale)
        self.serve_sheds = 0           # admission-control refusals
        #                                (explicit RETRY_AFTER errors —
        #                                the shed is the feature, not
        #                                the failure)
        self.predict_batches = 0       # aggregated PREDICT executions
        self.batched_predicts = 0      # requests that rode a batch
        self.retires = 0               # SERVE_SCALE deactivations
        self.stale_rejects = 0         # parked reads that expired
        self.stale_pull_skips = 0      # out-of-order refresh responses
        self.dense_resyncs = 0         # forced dense ("f32") adoptions
        self.failover_events = 0
        self._primary_terms: Dict[int, int] = {}
        self._lat = collections.deque(maxlen=512)  # serve seconds
        n = str(postoffice.node)
        self._pulls_counter = system_counter(f"{n}.serve_pulls")
        self._predict_counter = system_counter(f"{n}.serve_predicts")
        self._viol_counter = system_counter(f"{n}.staleness_violations")
        self._refresh_counter = system_counter(f"{n}.replica_refreshes")
        self._staleness_gauge = system_gauge(f"{n}.staleness_s")
        self._rounds_gauge = system_gauge(f"{n}.rounds_at_refresh")
        self._shed_counter = system_counter(f"{n}.serve_sheds")
        self._inflight_gauge = system_gauge(f"{n}.serve_inflight")
        # admission control (ISSUE 15): a bounded pending-read budget.
        # Past it, SERVE_PULL/PREDICT answer an explicit RETRY_AFTER
        # shed error (suggested backoff + current depth) instead of
        # queueing unboundedly — the balancer deprioritizes this
        # replica and retries elsewhere.  0 = OFF, bit-for-bit the
        # legacy always-queue path.
        self.max_inflight = int(self.config.serve_max_inflight)
        self.retry_after_s = float(self.config.serve_retry_after_s)
        self._admitted = 0  # reads accepted but not yet answered
        # SERVE_SCALE retirement: a retired replica sheds every read
        # (RETRY_AFTER + retired flag) and pauses its refresh loop —
        # the autoscaler's reversible scale-down actuation
        self._retired = False
        # batched PREDICT: aggregate compatible forward passes up to a
        # size/latency budget so goodput rises before shedding starts
        self.batch_max = int(self.config.serve_batch_max)
        self.batch_wait_s = float(self.config.serve_batch_wait_ms) / 1e3
        self._batch: List[tuple] = []  # (msg, t0, enqueued_monotonic)
        self._batch_cv = threading.Condition(self._mu)
        # subscription up-link toward the global shards — the same
        # worker shape as a local server's, so NEW_PRIMARY retargeting
        # and un-ACKed replay apply verbatim
        self.up = KVWorker(
            APP_PS, 1, postoffice,
            targets=topo.global_servers(),
            key_ranges=split_range(topo.num_global_servers),
            domain=Domain.GLOBAL,
        )
        self.server = KVServer(APP_PS, 0, postoffice, self._handle)
        self.server.cmd_handler = self._on_cmd
        postoffice.add_control_hook(self._on_new_primary)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        if self.refresh_interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"replica-refresh-{postoffice.node}")
            self._thread.start()
        self._batch_thread = None
        if self.batch_max > 1:
            self._batch_thread = threading.Thread(
                target=self._batch_loop, daemon=True,
                name=f"replica-batch-{postoffice.node}")
            self._batch_thread.start()

    # ---- failover retarget ---------------------------------------------------
    def _on_new_primary(self, msg: Message) -> bool:
        """Shard ``rank``'s key range moved (failover or reassignment):
        retarget the subscription and replay un-ACKed refresh pulls at
        the new holder.  Term-guarded per shard like the local servers'
        hook; observe-only so sibling consumers on this node still
        fire."""
        if msg.control is not Control.NEW_PRIMARY or msg.request:
            return False
        b = msg.body if isinstance(msg.body, dict) else {}
        rank, term = int(b.get("rank", -1)), int(b.get("term", 0))
        with self._mu:
            if term <= self._primary_terms.get(rank, 0):
                return False
            self._primary_terms[rank] = term
        replayed = self.up.retarget(NodeId.parse(b["old"]),
                                    NodeId.parse(b["new"]))
        self.failover_events += 1
        self._wake.set()  # refresh against the new holder NOW, not at
        #                   the next interval — the bound clock is running
        print(f"{self.po.node}: shard {rank} moved to {b['new']} "
              f"(term={term}, replayed={replayed} refresh pulls)",
              flush=True)
        return False

    # ---- refresh (subscription pull) ----------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            self._wake.wait(self.refresh_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            if self._retired:
                continue  # scaled down: no refresh traffic, no parked
                #           reads (retirement shed them all)
            try:
                self.refresh()
            except Exception:  # a cycle error must not kill the loop
                import logging

                logging.getLogger(__name__).exception(
                    "%s: replica refresh failed", self.po.node)
            self._expire_parked()

    def refresh(self, timeout: Optional[float] = None) -> bool:
        """One refresh cycle: discover the hosted key set + round
        progress per shard, pull new keys dense and known keys through
        the delta handshake, then serve any parked reads.  Returns True
        when the cycle completed (the copy is fresh NOW).  Reentrant
        calls coalesce (one cycle in flight)."""
        with self._mu:
            if self._refresh_busy or self._retired:
                return False
            self._refresh_busy = True
        try:
            return self._refresh_inner(
                timeout if timeout is not None
                else max(2.0, self.staleness_s))
        finally:
            with self._mu:
                self._refresh_busy = False

    def _refresh_inner(self, timeout: float) -> bool:
        keys: set = set()
        rounds = 0
        heard = 0
        seen: set = set()
        for gs in list(self.up.targets):  # retarget() swaps in place
            if str(gs) in seen:
                continue  # a drain merged two ranges onto one holder
            seen.add(str(gs))
            try:
                ts = self.up.send_cmd(gs, Ctrl.LIST_KEYS,
                                      domain=Domain.GLOBAL, wait=False)
                self.up.customer.wait(ts, timeout=min(2.0, timeout))
                reply = self.up.cmd_response(ts) or {}
            except TimeoutError:
                continue  # shard mid-failover: the retarget broadcast
                #           (or the next cycle) heals it
            except (KeyError, OSError):
                continue
            heard += 1
            keys.update(int(k) for k in reply.get("keys", ()))
            rounds += int(reply.get("key_rounds", 0) or 0)
        if heard < len(seen):
            # a dark shard means the copy cannot be declared fresh:
            # the keys it hosts would silently stop advancing
            return False
        if not keys:
            # nothing initialized yet — an empty model is trivially fresh
            self._complete_refresh(rounds)
            return True
        with self._mu:
            new = sorted(k for k in keys if k not in self.store)
            known = sorted(k for k in keys if k in self.store)
            echo = {str(k): self._pull_ver.get(k, -1) for k in known}
        ok = True
        if new:
            # a fresh replica has no view for a delta (or an fp16
            # downgrade) to be safe against — dense, like a warm boot
            ok = self._pull(new, {"dense": True}, timeout) and ok
        if known and ok:
            ok = self._pull(known, {"pv": echo}, timeout) and ok
        if ok:
            self._complete_refresh(rounds)
        return ok

    def _pull(self, keys: List[int], body: dict, timeout: float) -> bool:
        try:
            ts = self.up.zpull(keys, cb=self._install, cmd=Cmd.DEFAULT,
                               body=body)
        except (KeyError, OSError):
            return False
        try:
            # the install cb runs before wait() unblocks (KVWorker fires
            # the merged-callback ahead of the completion count)
            self.up.customer.wait(ts, timeout=timeout)
        except TimeoutError:
            return False  # replays / the next cycle finish the job;
            #               late responses pass the stale-skip guards
        with self.up._mu:
            errs, self.up.errors[:] = list(self.up.errors), []
        if errs:
            import logging

            logging.getLogger(__name__).warning(
                "%s: refresh pull errors: %s", self.po.node,
                "; ".join(errs[:3]))
            return False
        return True

    def _install(self, kvs: KVPairs):
        """Adopt one refresh response — the subscriber half of the PR 4
        handshake, mirroring ``LocalServer._on_pull_down``'s stale-skip
        rules: a bsc delta applies only against the exact view it was
        encoded for, a dense resync never yields to an older response."""
        from geomx_tpu_torch.compression.codecs import unpack_sparse

        tags = kvs.tags or {}
        pv = kvs.pv or {}
        with self._mu:
            for k, v in kvs.slices():
                tag = tags.get(k, "")
                cur = self._pull_ver.get(k, -1)
                if k in pv:
                    if tag == "bsc" and cur != pv[k] - 1:
                        self.stale_pull_skips += 1
                        continue
                    if tag == "f32" and pv[k] <= cur:
                        self.stale_pull_skips += 1
                        continue
                if tag == "bsc":
                    w = self.store.get(k)
                    if w is None:
                        # no base to apply a delta to (raced an evict
                        # prune) — the next cycle pulls this key dense
                        self.stale_pull_skips += 1
                        continue
                    vals, idx = unpack_sparse(
                        np.ascontiguousarray(v).view(np.float32))
                    if not w.flags.writeable:
                        w = w.copy()  # COW: in-flight reads alias it
                    w[idx] += vals
                    self.store[k] = w
                elif tag == "f32":
                    arr = np.ascontiguousarray(v).view(np.float32)
                    # frozen payload = upstream immutability promise:
                    # adopt the alias (local mutation paths COW)
                    self.store[k] = (arr if not arr.flags.writeable
                                     else arr.copy())
                    self.dense_resyncs += 1
                elif tag == "fp16":
                    self.store[k] = np.ascontiguousarray(v).view(
                        np.float16).astype(np.float32)
                    self._pull_ver[k] = -1  # no view version rode along
                    continue
                else:
                    # untagged dense (no pull compression configured, or
                    # a {"dense": True} bootstrap pull).  -1, never 0:
                    # if compression turns on later, echo -1 can't match
                    # a fresh tracked 0, so the first compressed pull is
                    # forced dense instead of sparse-from-INIT applying
                    # against this TRAINED copy
                    arr = np.asarray(v, dtype=np.float32)
                    if arr.dtype == np.float32 and not arr.flags.writeable:
                        self.store[k] = arr
                    else:
                        self.store[k] = np.array(arr, copy=True)
                    self._pull_ver[k] = -1
                    continue
                if k in pv:
                    self._pull_ver[k] = pv[k]

    def _complete_refresh(self, rounds: int):
        with self._mu:
            self.refresh_rounds += 1
            self.rounds_at_refresh = rounds
            self._last_refresh = time.monotonic()
            parked, self._parked = self._parked, []
        self._refresh_counter.inc()
        self._staleness_gauge.set(0.0)
        self._rounds_gauge.set(float(rounds))
        for msg, _deadline, t0 in parked:
            self._dispatch_fresh(msg, t0)

    def _expire_parked(self):
        now = time.monotonic()
        expired = []
        with self._mu:
            keep = []
            for ent in self._parked:
                (expired if now >= ent[1] else keep).append(ent)
            self._parked = keep
        for msg, _deadline, _t0 in expired:
            self.stale_rejects += 1
            self._release()
            self.server.response(msg, body={
                "error": f"replica {self.po.node} stale beyond the "
                         f"{self.staleness_s:.2f}s bound and the global "
                         "tier is unreachable — retry another replica"})

    # ---- read serving --------------------------------------------------------
    def staleness(self) -> float:
        """Age of the local copy in seconds (inf before first refresh)."""
        with self._mu:
            if self._last_refresh is None:
                return float("inf")
            return time.monotonic() - self._last_refresh

    def _maybe_add_addr(self, msg: Message):
        """Out-of-plan querier (the serve.load driver, an inference
        frontend outside the static plan): its reply address rides the
        request body, status-console style — install it so the
        response can dial."""
        body = msg.body if isinstance(msg.body, dict) else {}
        addr = body.get("addr")
        if not addr:
            return
        add = getattr(self.po.van.fabric, "add_address", None)
        if add is not None:
            try:
                add(str(msg.sender), (str(addr[0]), int(addr[1])))
            except (TypeError, ValueError, IndexError):
                pass

    def _handle(self, msg: Message, kvs, server: KVServer):
        if not msg.request:
            return  # stray response
        self._maybe_add_addr(msg)
        if msg.cmd == Cmd.PREDICT:
            self._gate(msg)
        elif msg.pull:
            self._gate(msg)
        else:
            # a replica is read-only: gradient traffic belongs to the
            # training tree — answer loudly instead of dropping
            server.response(msg, body={
                "error": f"{self.po.node} is a read-serving replica; "
                         "pushes go to the training tiers"})

    def inflight(self) -> int:
        """Current pending-read depth: reads admitted but not yet
        answered (in-hand + parked + batched) plus the customer-queue
        backlog the handler hasn't reached yet — the number the
        admission budget judges and the shed errors report."""
        c = self.server.customer
        with self._mu:
            d = self._admitted
        for q in (getattr(c, "_q", None), getattr(c, "_pull_q", None)):
            if q is not None:
                d += q.qsize()
        for ch in (getattr(c, "_chan", None),
                   getattr(c, "_pull_chan", None)):
            if ch is not None:
                d += ch.qsize()
        return d

    def _release(self):
        with self._mu:
            self._admitted = max(0, self._admitted - 1)

    def _shed(self, msg: Message, reason: str, depth=None):
        """Admission control's explicit refusal: an error body carrying
        the RETRY_AFTER backoff (+ current depth) so the client retries
        ELSEWHERE with discipline instead of timing out here — degrade
        by refusing work with a retry signal, never by missing every
        deadline."""
        self.serve_sheds += 1
        self._shed_counter.inc()
        retry = self.retry_after_s
        body = {"shed": True, "retry_after_s": retry}
        if reason == "retiring":
            body["retired"] = True
            body["error"] = (f"replica {self.po.node} retired by the "
                             f"autoscaler — RETRY_AFTER {retry:.3f}s "
                             "on another replica")
        else:
            body["inflight"] = int(depth or 0)
            body["error"] = (f"replica {self.po.node} overloaded "
                             f"(inflight {depth} >= budget "
                             f"{self.max_inflight}) — RETRY_AFTER "
                             f"{retry:.3f}s")
        self.server.response(msg, body=body)

    def _gate(self, msg: Message):
        """Admission first, then THE staleness bound: serve fresh now,
        or park until a refresh lands — a read is never answered from a
        copy older than the bound, and never queued past the admission
        budget (it is shed with an explicit RETRY_AFTER instead)."""
        t0 = time.perf_counter()
        if self._retired:
            self._shed(msg, "retiring")
            return
        if self.max_inflight > 0:
            depth = self.inflight()
            if depth >= self.max_inflight:
                self._shed(msg, "overloaded", depth=depth)
                return
        with self._mu:
            self._admitted += 1
        if self.staleness() <= self.staleness_s:
            self._dispatch_fresh(msg, t0)
            return
        self.staleness_violations += 1
        self._viol_counter.inc()
        overflow = False
        with self._mu:
            if len(self._parked) < 4096:
                self._parked.append(
                    (msg, time.monotonic() + self._park_timeout_s, t0))
            else:
                overflow = True
        if overflow:
            self._release()
            self.server.response(msg, body={
                "error": f"replica {self.po.node} overloaded while "
                         "stale (parked-read queue full)"})
        self._wake.set()  # refresh NOW, not at the next interval

    def _dispatch_fresh(self, msg: Message, t0: float):
        if msg.cmd == Cmd.PREDICT:
            if self._batch_thread is not None:
                self._enqueue_predict(msg, t0)
            else:
                self._respond_predict(msg, t0)
        else:
            self._respond_read(msg, t0)

    # ---- batched PREDICT -----------------------------------------------------
    def _enqueue_predict(self, msg: Message, t0: float):
        with self._batch_cv:
            self._batch.append((msg, t0, time.monotonic()))
            self._batch_cv.notify()

    def _batch_loop(self):
        """Aggregate compatible PREDICTs up to ``serve_batch_max``
        requests or ``serve_batch_wait_ms`` of waiting, whichever comes
        first — N queued inferences cost one matmul chain, so goodput
        rises before the admission budget starts shedding."""
        while not self._stop.is_set():
            with self._batch_cv:
                while not self._batch and not self._stop.is_set():
                    self._batch_cv.wait(0.25)
                if self._stop.is_set():
                    return
                deadline = self._batch[0][2] + self.batch_wait_s
                while (len(self._batch) < self.batch_max
                       and not self._stop.is_set()):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._batch_cv.wait(left)
                batch = self._batch[:self.batch_max]
                del self._batch[:self.batch_max]
            if batch:
                try:
                    self._run_batch(batch)
                except Exception:  # one bad batch must not kill serving
                    import logging

                    logging.getLogger(__name__).exception(
                        "%s: predict batch failed", self.po.node)

    @staticmethod
    def _predict_sig(msg: Message):
        body = msg.body if isinstance(msg.body, dict) else {}
        layers = body.get("layers") or []
        try:
            sig = tuple(
                (int(ly["key"]), int(ly["rows"]), int(ly["cols"]),
                 None if ly.get("bias") is None else int(ly["bias"]))
                for ly in layers)
        except (KeyError, TypeError, ValueError):
            return None
        return (sig, bool(body.get("relu", True)))

    def _run_batch(self, batch):
        groups: Dict[object, list] = {}
        for msg, t0, _ts in batch:
            sig = self._predict_sig(msg)
            groups.setdefault(sig, []).append((msg, t0))
        for sig, items in groups.items():
            if sig is None or len(items) == 1:
                for msg, t0 in items:
                    self._respond_predict(msg, t0)
                continue
            self._respond_predict_batch(items)

    def _respond_predict_batch(self, items):
        """One forward pass for N compatible requests: inputs stack
        along the batch axis, outputs split back per request."""
        xs, rows, live = [], [], []
        for msg, t0 in items:
            body = msg.body if isinstance(msg.body, dict) else {}
            b = int(body.get("batch", 1))
            x = (None if msg.vals is None
                 else np.ascontiguousarray(msg.vals, dtype=np.float32))
            try:
                x = x.reshape(b, -1) if x is not None else None
            except ValueError:
                x = None
            if x is None:
                self._release()
                self.server.response(msg, body={
                    "error": "predict needs an input payload tiling "
                             "body['batch']"})
                continue
            xs.append(x)
            rows.append(b)
            live.append((msg, t0))
        if not live:
            return
        if len({x.shape[1] for x in xs}) != 1:
            # same layer chain but mismatched input widths: one of them
            # is malformed — fall back to per-request handling, which
            # produces the precise per-request error
            for msg, t0 in live:
                self._respond_predict(msg, t0)
            return
        body0 = live[0][0].body
        layers = body0.get("layers") or []
        relu = bool(body0.get("relu", True))
        mats = []
        with self._mu:
            for ly in layers:
                k = int(ly["key"])
                w = self.store.get(k)
                r, c = int(ly["rows"]), int(ly["cols"])
                if w is None or len(w) != r * c:
                    err = {"error": f"{self.po.node}: layer key {k} "
                                    "missing or wrong size"}
                    for msg, _t0 in live:
                        self._release()
                        self.server.response(msg, body=err)
                    return
                b = (self.store.get(int(ly["bias"]))
                     if ly.get("bias") is not None else None)
                mats.append((w.reshape(r, c), b))
            meta = self._meta_locked()
        h = np.concatenate(xs, axis=0)
        for i, (w, b) in enumerate(mats):
            h = h @ w
            if b is not None:
                h = h + b
            if relu and i < len(mats) - 1:
                np.maximum(h, 0.0, out=h)
        h = np.ascontiguousarray(h, dtype=np.float32)
        self.predict_batches += 1
        self.batched_predicts += len(live)
        off = 0
        for (msg, t0), n in zip(live, rows):
            part = h[off:off + n]
            off += n
            flat = part.ravel()
            m = dict(meta)
            m["shape"] = [int(d) for d in part.shape]
            m["batched"] = len(live)
            self.serve_predicts += 1
            self._predict_counter.inc()
            self._release()
            self.server.response(msg, KVPairs(
                np.array([0], dtype=np.int64), flat,
                np.array([len(flat)], dtype=np.int64)), body=m)
            self._lat.append(time.perf_counter() - t0)

    def _meta_locked(self) -> dict:
        return {
            "staleness_s": (time.monotonic() - self._last_refresh
                            if self._last_refresh is not None else None),
            "version": self.refresh_rounds,
            "rounds_at_refresh": self.rounds_at_refresh,
        }

    def _respond_read(self, msg: Message, t0: float):
        ks = [int(k) for k in msg.keys]
        with self._mu:
            missing = [k for k in ks if k not in self.store]
            if missing:
                self._release()
                self.server.response(msg, body={
                    "error": f"{self.po.node} does not hold key(s) "
                             f"{missing[:4]} (model not initialized, or "
                             "a stale key plan)"})
                return
            if len(ks) == 1:
                w = self.store[ks[0]]
                if w.dtype == np.float32:
                    # zero-copy serve: freeze in place and ship the
                    # alias (every local mutation path COWs on a frozen
                    # array) — the PR 5 wire path scatter-gathers it
                    # without a memcpy
                    w.flags.writeable = False
                    payload = w
                else:
                    payload = np.asarray(w, np.float32)
                ls = [len(payload)]
            else:
                # multi-key: the concat IS the isolation copy
                ls = [len(self.store[k]) for k in ks]
                payload = np.empty(sum(ls), np.float32)
                off = 0
                for k, ln in zip(ks, ls):
                    payload[off:off + ln] = self.store[k]
                    off += ln
            meta = self._meta_locked()
        self.serve_pulls += 1
        self._pulls_counter.inc()
        self._release()
        self.server.response(msg, KVPairs(
            np.array(ks, dtype=np.int64), payload,
            np.array(ls, dtype=np.int64)), body=meta)
        self._lat.append(time.perf_counter() - t0)

    def _respond_predict(self, msg: Message, t0: float):
        body = msg.body if isinstance(msg.body, dict) else {}
        layers = body.get("layers") or []
        relu = bool(body.get("relu", True))
        batch = int(body.get("batch", 1))
        if msg.vals is None or not layers:
            self._release()
            self.server.response(msg, body={
                "error": "predict needs an input payload and a "
                         "non-empty body['layers'] spec"})
            return
        x = np.ascontiguousarray(msg.vals, dtype=np.float32)
        try:
            x = x.reshape(batch, -1)
        except ValueError:
            self._release()
            self.server.response(msg, body={
                "error": f"input of {x.size} elements does not tile "
                         f"batch={batch}"})
            return
        mats = []
        with self._mu:
            for ly in layers:
                k = int(ly["key"])
                rows, cols = int(ly["rows"]), int(ly["cols"])
                w = self.store.get(k)
                if w is None or len(w) != rows * cols:
                    self._release()
                    self.server.response(msg, body={
                        "error": f"{self.po.node}: layer key {k} "
                                 f"missing or wrong size "
                                 f"({0 if w is None else len(w)} != "
                                 f"{rows * cols})"})
                    return
                b = None
                if ly.get("bias") is not None:
                    b = self.store.get(int(ly["bias"]))
                # reshape of a (possibly frozen) flat slab is a view —
                # no copy on the serve hot path
                mats.append((w.reshape(rows, cols), b))
            meta = self._meta_locked()
        h = x
        for i, (w, b) in enumerate(mats):
            h = h @ w
            if b is not None:
                h = h + b
            if relu and i < len(mats) - 1:
                np.maximum(h, 0.0, out=h)
        flat = np.ascontiguousarray(h, dtype=np.float32).ravel()
        self.serve_predicts += 1
        self._predict_counter.inc()
        meta["shape"] = [int(d) for d in h.shape]
        self._release()
        self.server.response(msg, KVPairs(
            np.array([0], dtype=np.int64), flat,
            np.array([len(flat)], dtype=np.int64)), body=meta)
        self._lat.append(time.perf_counter() - t0)

    # ---- control -------------------------------------------------------------
    def set_active(self, active: bool):
        """SERVE_SCALE actuation (reversible scale-down): retiring
        sheds every parked read with the RETRY_AFTER signal and pauses
        the refresh loop; reactivating wakes an immediate refresh —
        after the autoscaler's subscriber prune, that refresh resyncs
        dense, exactly the eviction→rejoin semantics."""
        new_retired = not bool(active)
        parked = []
        with self._mu:
            changed = self._retired != new_retired
            self._retired = new_retired
            if changed and new_retired:
                parked, self._parked = self._parked, []
        if not changed:
            return
        if not active:
            self.retires += 1
            for pmsg, _dl, _t0 in parked:
                self._release()
                self._shed(pmsg, "retiring")
            print(f"{self.po.node}: retired (SERVE_SCALE) — reads shed "
                  "with RETRY_AFTER until reactivation", flush=True)
        else:
            self._wake.set()  # refresh NOW: a pruned subscription heals
            #                   through the dense-resync handshake
            print(f"{self.po.node}: reactivated (SERVE_SCALE) — "
                  "refreshing and serving again", flush=True)

    def _on_cmd(self, msg: Message):
        self._maybe_add_addr(msg)
        if msg.cmd == Ctrl.QUERY_STATS:
            self.server.reply_cmd(msg, body=self.stats())
        elif msg.cmd == Ctrl.LIST_KEYS:
            # read clients discover what this replica holds (the serve
            # load driver's bootstrap)
            with self._mu:
                ks = sorted(int(k) for k in self.store)
            self.server.reply_cmd(msg, body={"keys": ks})
        elif msg.cmd == Ctrl.SERVE_SCALE:
            b = msg.body if isinstance(msg.body, dict) else {}
            active = bool(b.get("active", True))
            self.set_active(active)
            self.server.reply_cmd(msg, body={"ok": True,
                                             "active": active})
        else:
            self.server.reply_cmd(msg)

    def stats(self) -> dict:
        """QUERY_STATS body — also what the telemetry pump ships, so
        the status console's replicas section and the health engine's
        replica-staleness rule read these exact fields."""
        van = self.po.van
        stale = self.staleness()
        if stale != float("inf"):
            self._staleness_gauge.set(stale)
        lat_ms = [v * 1e3 for v in list(self._lat)]
        inflight = self.inflight()
        self._inflight_gauge.set(float(inflight))
        with self._mu:
            store_b = sum(a.nbytes for a in self.store.values())
            nkeys = len(self.store)
            parked = len(self._parked)
            retired = self._retired
        out = {
            "serve_pulls": self.serve_pulls,
            "serve_predicts": self.serve_predicts,
            "staleness_violations": self.staleness_violations,
            "serve_sheds": self.serve_sheds,
            "inflight": inflight,
            "max_inflight": self.max_inflight,
            "retired": retired,
            "predict_batches": self.predict_batches,
            "batched_predicts": self.batched_predicts,
            "retires": self.retires,
            "stale_rejects": self.stale_rejects,
            "stale_pull_skips": self.stale_pull_skips,
            "dense_resyncs": self.dense_resyncs,
            "replica_refreshes": self.refresh_rounds,
            "rounds_at_refresh": self.rounds_at_refresh,
            "parked_reads": parked,
            "keys": nkeys,
            "store_bytes": store_b,
            "failover_events": self.failover_events,
            "serve_p50_ms": _percentile(lat_ms, 0.50),
            "serve_p99_ms": _percentile(lat_ms, 0.99),
            "wan_send_bytes": van.wan_send_bytes,
            "wan_recv_bytes": van.wan_recv_bytes,
            "uptime_s": self.po.uptime_s(),
            "boot": van.boot,
        }
        if stale != float("inf"):
            out["staleness_s"] = stale  # absent before the 1st refresh
        return out

    def stop(self):
        self._stop.set()
        self._wake.set()
        with self._batch_cv:
            self._batch_cv.notify_all()
        self.server.stop()
        self.up.stop()
