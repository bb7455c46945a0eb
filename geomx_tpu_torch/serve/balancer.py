"""Liveness-aware client-side load balancer for the serve tier.

PR 8 left the read path pinned to ONE hand-picked replica
(``ReplicaClient.retarget`` was the whole failover story): a SIGKILLed
or stale-stuck replica cost every subsequent read a full timeout.
:class:`ServeBalancer` is the missing client half of the serving plane
(docs/serving.md "Serving plane"):

- **power-of-two-choices** over the replica set: each read samples two
  candidate replicas and takes the one with the lower load score
  (locally-observed outstanding reads, then the cluster-state QPS) —
  the classic p2c result: near-best-of-N balance at O(1) cost;
- **cluster-state view**: the candidate set is fed by the global
  scheduler's ``Ctrl.CLUSTER_STATE`` replica table (freshness /
  staleness / qps / retired), cached and refreshed at most every
  ``Config.serve_lb_refresh_s`` — a replica the telemetry plane
  already knows is dead, stale past the bound, or retired is skipped
  WITHOUT burning a probe on it;
- **per-replica health accounting**: consecutive errors / timeouts /
  staleness rejects eject a replica from the candidate set
  (``serve_eject_errors``); after ``serve_probe_s`` it gets exactly
  one HALF-OPEN trial read — success restores it, failure re-opens the
  breaker.  A dead replica costs one failed read, not a stream of them;
- **shed honoring**: an admission-control ``RETRY_AFTER`` error
  (``ReplicaError.shed``) deprioritizes the replica for the suggested
  backoff (jittered) and the read retries ELSEWHERE immediately —
  the explicit-load-shedding contract, client side;
- **bounded attempt latency**: every attempt runs under
  ``serve_attempt_timeout_s``, so the FIRST failure on a dead target
  triggers an immediate re-pick instead of burning the caller's whole
  deadline (the PR 8 regression this module fixes).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geomx_tpu_torch.core.config import Config, Role
from geomx_tpu_torch.kvstore.common import Ctrl
from geomx_tpu_torch.ps import Postoffice
from geomx_tpu_torch.serve.client import ReplicaClient, ReplicaError
from geomx_tpu_torch.transport.message import Domain
from geomx_tpu_torch.utils.metrics import system_counter


class _Health:
    """Per-replica circuit state: closed (serving) -> open (ejected)
    -> half-open (one probe in flight) -> closed/open."""

    __slots__ = ("consec_errors", "open_until", "probing",
                 "depri_until", "outstanding", "picks", "errors",
                 "sheds")

    def __init__(self):
        self.consec_errors = 0
        self.open_until = 0.0   # 0 = closed
        self.probing = False    # a half-open trial is in flight
        self.depri_until = 0.0  # shed backoff window
        self.outstanding = 0    # reads in flight through THIS balancer
        self.picks = 0
        self.errors = 0
        self.sheds = 0

    def open_now(self, now: float) -> bool:
        return self.open_until > now


class ServeBalancer:
    """One per read frontend; owns one :class:`ReplicaClient` per
    replica rank on the caller's postoffice."""

    def __init__(self, postoffice: Postoffice,
                 config: Optional[Config] = None,
                 replicas: Optional[Sequence[int]] = None,
                 advertise: Optional[tuple] = None,
                 seed: Optional[int] = None):
        self.po = postoffice
        self.config = config or postoffice.config
        topo = postoffice.topology
        ranks = (list(replicas) if replicas is not None
                 else list(range(topo.num_replicas)))
        assert ranks, "ServeBalancer needs at least one replica rank"
        self.clients: Dict[int, ReplicaClient] = {
            r: ReplicaClient(postoffice, self.config, replica=r,
                             customer_id=3 + i, advertise=advertise)
            for i, r in enumerate(ranks)}
        self.ranks = ranks
        cfg = self.config
        self.bound_s = float(cfg.serve_staleness_s)
        self.attempt_timeout_s = float(cfg.serve_attempt_timeout_s)
        self.eject_errors = int(cfg.serve_eject_errors)
        self.probe_s = float(cfg.serve_probe_s)
        self.view_refresh_s = float(cfg.serve_lb_refresh_s)
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self._health: Dict[int, _Health] = {r: _Health() for r in ranks}
        # cached cluster-state replica table ({rank: entry}) + the next
        # instant a refresh may be attempted (throttle, also after
        # failures — a dark scheduler must not stall every pick)
        self._view: Dict[int, dict] = {}
        self._view_next = 0.0
        self._gsched = topo.global_scheduler()
        n = str(postoffice.node)
        self.lb_picks = system_counter(f"{n}.lb_picks")
        self.lb_failovers = system_counter(f"{n}.lb_failovers")
        self.lb_sheds = system_counter(f"{n}.lb_sheds")
        self.lb_ejections = system_counter(f"{n}.lb_ejections")
        self.lb_probes = system_counter(f"{n}.lb_probes")
        self.lb_recoveries = system_counter(f"{n}.lb_recoveries")

    # ---- cluster-state view --------------------------------------------------
    def refresh_view(self, timeout: float = 2.0) -> bool:
        """One ``Ctrl.CLUSTER_STATE`` round trip; False when the
        scheduler is unreachable (the cached view — possibly empty —
        keeps serving picks)."""
        client = self.clients[self.ranks[0]]
        try:
            ts = client.send_cmd(self._gsched, Ctrl.CLUSTER_STATE,
                                 body=client._body(),
                                 domain=Domain.GLOBAL, wait=False)
            client.customer.wait(ts, timeout=timeout)
            reply = client.cmd_response(ts)
        except (TimeoutError, KeyError, OSError):
            return False
        if not isinstance(reply, dict):
            return False
        table = reply.get("replicas") or {}
        view: Dict[int, dict] = {}
        for k, ent in table.items():
            try:
                view[int(k)] = dict(ent)
            except (TypeError, ValueError):
                continue
        with self._mu:
            self._view = view
        return True

    def _maybe_refresh_view(self, now: float):
        with self._mu:
            if now < self._view_next:
                return
            # claim the slot before the (blocking) query so concurrent
            # readers don't stampede the scheduler
            self._view_next = now + max(self.view_refresh_s, 0.1)
        self.refresh_view(timeout=min(1.0, self.attempt_timeout_s))

    def _view_ok(self, rank: int) -> bool:
        """False only when the cached cluster-state view POSITIVELY
        disqualifies the replica (dead / retired / stale past the
        bound) — an absent or silent view never blocks serving."""
        ent = self._view.get(rank)
        if not ent:
            return True
        if ent.get("alive") is False:
            return False
        if ent.get("retired"):
            return False
        s = ent.get("staleness_s")
        if isinstance(s, (int, float)) and s > self.bound_s:
            return False
        return True

    # ---- candidate choice ----------------------------------------------------
    def candidates(self, now: Optional[float] = None,
                   exclude: Sequence[int] = ()) -> List[int]:
        """Ranks currently eligible for a pick: breaker closed (or due
        a half-open probe), not disqualified by the cluster-state view,
        not inside a shed backoff — with each filter relaxed in that
        order rather than returning an empty set (a degraded tier still
        wants its best shot routed somewhere)."""
        now = time.monotonic() if now is None else now
        ex = set(exclude)
        with self._mu:
            base = []
            for r in self.ranks:
                if r in ex:
                    continue
                h = self._health[r]
                if h.open_until and h.open_now(now):
                    continue  # ejected, probe not due yet
                if h.open_until and h.probing:
                    continue  # half-open: one trial at a time
                base.append(r)
            healthy = [r for r in base if self._view_ok(r)]
            if healthy:
                base = healthy
            fresh = [r for r in base
                     if self._health[r].depri_until <= now]
            return fresh or base

    def pick(self, exclude: Sequence[int] = ()) -> Optional[int]:
        """Power-of-two-choices: sample two eligible replicas, keep the
        lower (outstanding, qps) score.  Returns None when nothing is
        eligible."""
        now = time.monotonic()
        self._maybe_refresh_view(now)
        cands = self.candidates(now, exclude)
        if not cands:
            return None
        if len(cands) == 1:
            choice = cands[0]
        else:
            a, b = self._rng.sample(cands, 2)
            choice = min((a, b), key=self._score)
        with self._mu:
            h = self._health[choice]
            h.picks += 1
            h.outstanding += 1
            if h.open_until:  # due for its half-open trial
                h.probing = True
                self.lb_probes.inc()
        self.lb_picks.inc()
        return choice

    def _score(self, rank: int) -> Tuple[float, float]:
        h = self._health[rank]
        ent = self._view.get(rank) or {}
        qps = ent.get("serve_qps")
        return (float(h.outstanding),
                float(qps) if isinstance(qps, (int, float)) else 0.0)

    # ---- outcome accounting --------------------------------------------------
    def _on_success(self, rank: int):
        with self._mu:
            h = self._health[rank]
            h.outstanding = max(0, h.outstanding - 1)
            recovered = h.open_until > 0
            h.consec_errors = 0
            h.open_until = 0.0
            h.probing = False
            h.depri_until = 0.0
        if recovered:
            self.lb_recoveries.inc()
            print(f"{self.po.node}: replica:{rank} recovered "
                  "(half-open probe succeeded) — restored to the "
                  "candidate set", flush=True)

    def _on_shed(self, rank: int, retry_after_s: float):
        now = time.monotonic()
        backoff = max(retry_after_s, 1e-3)
        backoff *= 1.0 + self._rng.uniform(0.0, 0.5)  # jitter: a
        #                 synchronized client fleet must not re-dogpile
        #                 the shedding replica at one instant
        with self._mu:
            h = self._health[rank]
            h.outstanding = max(0, h.outstanding - 1)
            h.sheds += 1
            # a shed is a RESPONSE: the replica is alive, just loaded —
            # close the breaker (a probe answered with a shed counts as
            # recovery) but back off for the suggested window
            h.consec_errors = 0
            h.open_until = 0.0
            h.probing = False
            h.depri_until = max(h.depri_until, now + backoff)
        self.lb_sheds.inc()

    def _on_error(self, rank: int):
        now = time.monotonic()
        with self._mu:
            h = self._health[rank]
            h.outstanding = max(0, h.outstanding - 1)
            h.errors += 1
            h.consec_errors += 1
            was_probe = h.probing
            h.probing = False
            eject = (h.consec_errors >= self.eject_errors or was_probe
                     or h.open_until > 0)
            if eject:
                first = h.open_until == 0.0
                h.open_until = now + self.probe_s
            else:
                first = False
        if eject and first:
            self.lb_ejections.inc()
            print(f"{self.po.node}: replica:{rank} ejected after "
                  f"{self.eject_errors} consecutive failures — "
                  f"half-open probe in {self.probe_s:.1f}s", flush=True)

    # ---- read API ------------------------------------------------------------
    def _call(self, fn_name: str, args: tuple, kwargs: dict,
              timeout: Optional[float]) -> tuple:
        """One balanced read: pick -> bounded attempt -> on failure
        re-pick IMMEDIATELY (never burn the caller's whole deadline on
        one dead target).  Returns ``(result, rank)``."""
        deadline = time.monotonic() + (10.0 if timeout is None
                                       else float(timeout))
        tried: set = set()
        last_err: Optional[Exception] = None
        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            rank = self.pick(exclude=tried)
            if rank is None:
                if not tried:
                    break  # nothing eligible at all
                # every replica was tried this pass: brief jittered
                # backoff, then a fresh pass (sheds/ejections may have
                # expired by then)
                tried.clear()
                pause = min(0.05 * (1 + self._rng.random()),
                            max(deadline - now, 0.0))
                if pause <= 0:
                    break
                time.sleep(pause)
                continue
            attempt = min(self.attempt_timeout_s,
                          max(deadline - now, 1e-3))
            client = self.clients[rank]
            try:
                res = getattr(client, fn_name)(*args, timeout=attempt,
                                               **kwargs)
            except ReplicaError as e:
                last_err = e
                tried.add(rank)
                if e.shed:
                    self._on_shed(rank, e.retry_after_s)
                else:
                    self._on_error(rank)
                self.lb_failovers.inc()
                continue
            except (TimeoutError, KeyError, OSError) as e:
                last_err = e
                tried.add(rank)
                self._on_error(rank)
                self.lb_failovers.inc()
                continue
            self._on_success(rank)
            return res, rank
        if last_err is not None:
            raise last_err
        raise TimeoutError(
            f"{self.po.node}: no serve replica eligible within the "
            "deadline (all ejected/deprioritized)")

    def pull(self, keys, timeout: Optional[float] = None):
        """Balanced SERVE_PULL; returns ``(KVPairs, meta)`` like
        :meth:`ReplicaClient.pull` (meta gains ``replica``)."""
        (kvs, meta), rank = self._call("pull", (keys,), {}, timeout)
        meta["replica"] = rank
        return kvs, meta

    def pull_tensor(self, tid: int, size: int,
                    timeout: Optional[float] = None):
        (arr, meta), rank = self._call("pull_tensor", (tid, size), {},
                                       timeout)
        meta["replica"] = rank
        return arr, meta

    def predict(self, x: np.ndarray, layers: List[tuple],
                relu: bool = True, timeout: Optional[float] = None):
        (out, meta), rank = self._call("predict", (x, layers),
                                       {"relu": relu}, timeout)
        meta["replica"] = rank
        return out, meta

    def list_keys(self, timeout: Optional[float] = None) -> List[int]:
        """Key discovery through any eligible replica."""
        keys, _rank = self._call("list_keys", (), {}, timeout)
        return keys

    # ---- observability -------------------------------------------------------
    def stats(self) -> dict:
        now = time.monotonic()
        with self._mu:
            per = {}
            for r in self.ranks:
                h = self._health[r]
                per[r] = {
                    "picks": h.picks, "errors": h.errors,
                    "sheds": h.sheds,
                    "consec_errors": h.consec_errors,
                    "ejected": h.open_now(now),
                    "probing": h.probing,
                    "deprioritized": h.depri_until > now,
                    "outstanding": h.outstanding,
                }
        return {
            "replicas": per,
            "picks": self.lb_picks.value,
            "failovers": self.lb_failovers.value,
            "sheds": self.lb_sheds.value,
            "ejections": self.lb_ejections.value,
            "probes": self.lb_probes.value,
            "recoveries": self.lb_recoveries.value,
        }

    def stop(self):
        for c in self.clients.values():
            c.stop()
