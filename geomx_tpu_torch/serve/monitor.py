"""Replica membership actuator on the global scheduler.

Serve replicas heartbeat the global scheduler like the global tier
does.  :class:`ReplicaMonitor` makes them first-class fenced members of
the PR 2 machinery:

- **eviction**: a replica whose heartbeats expire past
  ``Config.heartbeat_timeout_s`` is declared dead and every global
  shard's CURRENT holder (failover-aware via ``ShardTargets``) is told
  ``Control.EVICT {action: subscriber_prune}`` — freeing the tracked
  ``BroadcastCompressor`` views that would otherwise pin one full-model
  copy per dead replica forever (the PR 8 leak fix, actuated);
- **rejoin**: when the identity's heartbeats resume (a restarted
  process with a fresh ``boot``, or a revived zombie), the monitor
  logs the recovery and clears the eviction record.  Nothing else is
  needed: the replica's own refresh loop heals through the dense-resync
  version handshake — its first pull after the prune mismatches every
  tracked view and comes back dense.

False positives are safe by construction: pruning a live replica's
views only costs one dense response per key on its next refresh.
"""

from __future__ import annotations

import time
from typing import Dict

from geomx_tpu_torch.core.config import Role
from geomx_tpu_torch.kvstore.eviction import _HeartbeatActuator
from geomx_tpu_torch.trace.recorder import get_tracer
from geomx_tpu_torch.transport.message import Control, Domain
from geomx_tpu_torch.utils.metrics import system_counter


class ReplicaMonitor(_HeartbeatActuator):
    """One per deployment, on the global scheduler (requires heartbeats
    on and ``Topology.num_replicas > 0``)."""

    def __init__(self, postoffice, check_interval_s=None):
        assert postoffice.node.role is Role.GLOBAL_SCHEDULER
        from geomx_tpu_torch.kvstore.replication import ShardTargets

        self._shards = ShardTargets(postoffice)
        self._evicted: Dict[str, int] = {}  # replica -> boot at eviction
        self._acting: set = set()
        self.replica_evictions = 0
        self.replica_rejoins = 0
        self._evict_counter = system_counter(
            f"{postoffice.node}.replica_evictions")
        self._rejoin_counter = system_counter(
            f"{postoffice.node}.replica_rejoins")
        super().__init__(postoffice, check_interval_s)

    def _check(self):
        info, epoch = self.po.heartbeat_info()
        now = time.monotonic()
        for r in self.topology.replicas():
            s = str(r)
            with self._mu:
                if s in self._acting:
                    continue
                evicted = s in self._evicted
            age = self._age(info, s, epoch, now)
            if not evicted and age > self._timeout:
                self._evict(s, info.get(s, (None, 0))[1])
            elif evicted and age <= self._timeout:
                self._rejoin(s, info.get(s, (None, 0))[1])

    def _evict(self, replica_s: str, boot: int):
        with self._mu:
            self._acting.add(replica_s)
        try:
            for gs in self._shards.global_servers():
                self._rpc(gs, Control.EVICT,
                          {"action": "subscriber_prune",
                           "node": replica_s},
                          Domain.GLOBAL, attempts=3)
            with self._mu:
                self._evicted[replica_s] = boot
            self.replica_evictions += 1
            self._evict_counter.inc()
            get_tracer(str(self.po.node)).instant(
                "evict.replica", node=replica_s, boot=boot)
            print(f"{self.po.node}: evicted replica {replica_s} "
                  f"(heartbeat expired, boot={boot}) — tracked pull "
                  "views pruned at every shard", flush=True)
        finally:
            with self._mu:
                self._acting.discard(replica_s)

    def _rejoin(self, replica_s: str, boot: int):
        with self._mu:
            self._evicted.pop(replica_s, None)
        self.replica_rejoins += 1
        self._rejoin_counter.inc()
        get_tracer(str(self.po.node)).instant(
            "recover.replica_rejoin", node=replica_s, boot=boot)
        print(f"{self.po.node}: replica {replica_s} resumed heartbeats "
              f"(boot={boot}) — rejoined; its next refresh resyncs "
              "dense", flush=True)
