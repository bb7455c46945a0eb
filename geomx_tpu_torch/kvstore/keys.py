"""Tensor → ps-key encoding.

Mirrors the semantics of the reference key encoders
(ref: src/kvstore/kvstore_dist.h:721-799):

- ``EncodeDefaultKey``: tensors smaller than ``bigarray_bound`` live whole
  on one server chosen by hash ``(tensor_id * 9973) % num_shards``; bigger
  tensors are partitioned evenly across **all** shards (this is also what
  MultiGPS does at the global tier, ref: kvstore_dist_server.h:1770-1810).
- ``EncodeP3Key``: slice every ``slice_elems`` elements into its own key so
  each slice can be scheduled/prioritized independently
  (ref: kvstore_dist.h:763-799).

One encoding is used for both tiers: the shard count is the number of
*global* servers, so the same ps keys flow worker → local server → global
server, and the local server (which owns the whole key space at tier 1)
can push each key straight to its owning global shard.

ps-key layout: ``shard * step + tensor_id * CHUNK_SPACE + chunk_idx`` where
``step = MAX_KEY // num_shards``.

The shard count is config-driven: ``Config.global_shards`` /
``GEOMX_GLOBAL_SHARDS`` / ``launch.py --global-shards`` set
``Topology.num_global_servers``, and the assignment here is a pure
deterministic function of (tensor_id, size, num_shards) — every node
computes the identical plan with no coordination.  The range → SERVER
binding is the dynamic half: ``split_range`` (ps/postoffice.py) maps
range k to global server rank k at plan time, and per-shard failover /
live key-range reassignment move a range's CURRENT holder at runtime
(kvstore/replication.py) without touching the key encoding.
"""

from __future__ import annotations

import dataclasses
from typing import List

from geomx_tpu_torch.ps.postoffice import MAX_KEY

CHUNK_SPACE = 1 << 20  # max chunks of one tensor per shard


@dataclasses.dataclass(frozen=True)
class KeyPart:
    """One wire key of an encoded tensor."""

    ps_key: int
    start: int   # element offset into the flat tensor
    length: int  # element count
    shard: int   # owning (global-)server rank
    priority: int = 0


def encode_tensor(
    tensor_id: int,
    size: int,
    num_shards: int,
    bigarray_bound: int = 1_000_000,
    slice_elems: int = 0,
    base_priority: int = 0,
) -> List[KeyPart]:
    """Compute the wire keys for one tensor.

    ``slice_elems > 0`` selects P3-style slicing; otherwise default
    hashing/partitioning. Returned parts are ordered by ``start``.
    """
    assert size > 0
    step = MAX_KEY // num_shards
    parts: List[KeyPart] = []
    if slice_elems > 0:
        nchunks = (size + slice_elems - 1) // slice_elems
        for c in range(nchunks):
            shard = c % num_shards
            idx = c // num_shards
            start = c * slice_elems
            parts.append(KeyPart(
                ps_key=shard * step + tensor_id * CHUNK_SPACE + idx,
                start=start,
                length=min(slice_elems, size - start),
                shard=shard,
                priority=base_priority,
            ))
    elif size >= bigarray_bound and num_shards > 1:
        # even partition across all shards (ref: kvstore_dist.h:743-756)
        per = size // num_shards
        for s in range(num_shards):
            start = s * per
            length = (size - start) if s == num_shards - 1 else per
            parts.append(KeyPart(
                ps_key=s * step + tensor_id * CHUNK_SPACE,
                start=start, length=length, shard=s, priority=base_priority,
            ))
    else:
        shard = (tensor_id * 9973) % num_shards
        parts.append(KeyPart(
            ps_key=shard * step + tensor_id * CHUNK_SPACE,
            start=0, length=size, shard=shard, priority=base_priority,
        ))
    return parts


@dataclasses.dataclass
class KeyPlan:
    """Cached encoding for a model's tensors (ref: the encode cache
    kvstore_dist.h:711-719 ps_kv_)."""

    num_shards: int
    bigarray_bound: int = 1_000_000
    slice_elems: int = 0

    def __post_init__(self):
        self._cache = {}

    def parts(self, tensor_id: int, size: int, priority: int = 0) -> List[KeyPart]:
        ent = self._cache.get(tensor_id)
        if ent is None or ent[0] != size:
            ent = (size, encode_tensor(
                tensor_id, size, self.num_shards, self.bigarray_bound,
                self.slice_elems, priority,
            ))
            self._cache[tensor_id] = ent
        return ent[1]
