"""Ulysses-style sequence parallelism: the port of the JAX package's
``parallel/ulysses.py``.

The second long-context strategy beside ring attention: instead of
rotating K/V blocks around a ring, one all-to-all re-shards the
activations from sequence-sharded to head-sharded, every rank runs
dense attention over the whole sequence for its slice of heads, and a
second all-to-all restores the sequence sharding.  Two exchanges in all
instead of ``sp`` hops; the head count must divide by ``sp``.

Single-controller, as :func:`~geomx_tpu_torch.parallel.ring_attention.
ring_attention` is: the all-to-alls are
:func:`~geomx_tpu_torch.parallel.mesh.all_to_all`, slices moved to their
new rank's device and concatenated there.  It runs no
kernel of its own.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from geomx_tpu_torch.parallel.mesh import all_to_all
from geomx_tpu_torch.parallel.ring_attention import (
    dense_attention, fast_dense_attention)


def ulysses_attention(q_shards: Sequence[torch.Tensor],
                      k_shards: Sequence[torch.Tensor],
                      v_shards: Sequence[torch.Tensor], mesh,
                      axis: str = "sp", causal: bool = True,
                      fast: bool = False) -> List[torch.Tensor]:
    """Exact attention via head↔sequence re-sharding.

    One ``[B, T_local, H, D]`` shard per rank of ``axis``, each on its
    rank's device, the global sequence laid out in rank order (the
    contract of ``ring_attention``).  Returns the per-rank outputs
    ``[B, T_local, H, D]`` in q's dtype."""
    n = mesh.axis_size(axis)
    if not len(q_shards) == len(k_shards) == len(v_shards) == n:
        raise ValueError(f"ulysses_attention needs one shard per rank of "
                         f"'{axis}' ({n}), got {len(q_shards)}, "
                         f"{len(k_shards)}, {len(v_shards)}")
    H = q_shards[0].shape[2]
    if H % n != 0:
        raise ValueError(
            f"ulysses_attention needs the per-shard head count ({H} heads "
            f"a rank) divisible by the '{axis}' axis size ({n}); use "
            f"ring_attention otherwise")

    def seq_to_heads(xs):   # [B, T/n, H, D] each -> [B, T, H/n, D] each
        return all_to_all(xs, split_dim=2, concat_dim=1)

    def heads_to_seq(xs):   # [B, T, H/n, D] each -> [B, T/n, H, D] each
        return all_to_all(xs, split_dim=1, concat_dim=2)

    attn = fast_dense_attention if fast else dense_attention
    outs = [attn(a, b, c, causal=causal) for a, b, c in
            zip(seq_to_heads(q_shards), seq_to_heads(k_shards),
                seq_to_heads(v_shards))]
    return [o.to(q.dtype) for o, q in zip(heads_to_seq(outs), q_shards)]
