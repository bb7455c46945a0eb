"""Ring attention over a sequence-parallel mesh axis, and the
single-device attention beside it — the port of the JAX package's
``parallel/ring_attention.py``.

``ring_attention`` is exact attention over a sequence laid out in
contiguous shards, one per rank of the ``sp`` axis: each rank keeps its
queries, the K/V blocks rotate around the ring, and each rank merges
its blocks' partial attention online (running max and denominator, in
f32), so no rank holds the whole sequence's scores.  The JAX package
runs it inside ``shard_map``, with ``lax.ppermute`` moving the blocks;
the port runs the same program single-controller over a
:class:`~geomx_tpu_torch.parallel.mesh.Mesh`: it takes the list of
per-rank shards, loops over the ranks, and moves a block to its next
holder's device with :func:`~geomx_tpu_torch.parallel.mesh.ppermute` (a
no-op when ranks share a card).

``dense_attention`` and ``fast_dense_attention`` are the single-device
functions on ``[B, T, H, Dh]`` tensors.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from geomx_tpu_torch.parallel.mesh import ppermute

MASK_VALUE = -1e30


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool
                   ) -> torch.Tensor:
    """f32 scores [B, Tq, H, Tk] of f32 products, scaled by 1/sqrt(Dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        mask = (torch.arange(Tq, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        s = torch.where(mask[None, :, None, :], s, MASK_VALUE)
    return s


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """All-f32 reference attention: full score matrix, f32 softmax and
    PV product, output in q's dtype."""
    p = torch.softmax(_masked_scores(q, k, causal), dim=-1)
    o = torch.einsum("bqhk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def fast_dense_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, causal: bool = True
                         ) -> torch.Tensor:
    """The JAX package's bf16-operand attention: products of the input
    operands accumulated in f32, softmax in f32, probabilities rounded
    to the input dtype before the PV product.  The operands are upcast
    to f32 for the products (exact for bf16 inputs), so the result does
    not depend on how a backend accumulates bf16 matmuls."""
    p = torch.softmax(_masked_scores(q, k, causal), dim=-1).to(q.dtype)
    o = torch.einsum("bqhk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype)


def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor, fast: bool = False):
    """One (Q-block, KV-block) partial attention: q ``[B, Tq, H, D]``,
    k/v ``[B, Tk, H, D]``, bias ``[Tq, Tk]`` additive.  Returns ``(m
    [B,Tq,H], l [B,Tq,H], o [B,Tq,H,D])`` in f32.  The scores are f32
    products of the input operands either way; ``fast`` rounds ``p`` to
    the input dtype before the PV product, as the JAX package's bf16
    products do."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    s = s + bias[None, :, None, :]
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    pv = p.to(q.dtype).float() if fast else p
    o = torch.einsum("bqhk,bkhd->bqhd", pv, v.float())
    return m, l, o


def ring_attention(q_shards: Sequence[torch.Tensor],
                   k_shards: Sequence[torch.Tensor],
                   v_shards: Sequence[torch.Tensor], mesh,
                   axis: str = "sp", causal: bool = True,
                   fast=False) -> List[torch.Tensor]:
    """Exact attention with K/V ring rotation over ``mesh``'s ``axis``.

    ``q_shards``/``k_shards``/``v_shards``: one ``[B, T_local, H, D]``
    tensor per rank of the axis, each on its rank's device; the global
    sequence is the shards in rank order.  Returns the per-rank outputs
    ``[B, T_local, H, D]`` in q's dtype.  ``fast`` as in
    :func:`_block_attn`; ``fast="flash"`` computes each hop's block with
    :func:`~geomx_tpu_torch.ops.block_attention.flash_block_attention`
    (the hand kernel on the card): one launch per (rank, hop), ``n²`` a
    call.  The merge across hops is f32 either way."""
    from geomx_tpu_torch.ops.block_attention import flash_block_attention

    n = mesh.axis_size(axis)
    if not len(q_shards) == len(k_shards) == len(v_shards) == n:
        raise ValueError(f"ring_attention needs one shard per rank of "
                         f"'{axis}' ({n}), got {len(q_shards)}, "
                         f"{len(k_shards)}, {len(v_shards)}")
    devs = [q.device for q in q_shards]
    B, T, H, D = q_shards[0].shape

    def bias_for(rank: int, src: int) -> torch.Tensor:
        """Additive causal bias between rank's Q block and the KV block
        that started on rank ``src``."""
        if not causal:
            return torch.zeros((T, T), device=devs[rank])
        q_pos = rank * T + torch.arange(T, device=devs[rank])
        k_pos = src * T + torch.arange(T, device=devs[rank])
        return torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                           MASK_VALUE)

    # the online-softmax accumulators of each rank (f32)
    m = [torch.full((B, T, H), -math.inf, device=d) for d in devs]
    l = [torch.zeros((B, T, H), device=d) for d in devs]
    o = [torch.zeros((B, T, H, D), device=d) for d in devs]
    k_blk, v_blk = list(k_shards), list(v_shards)
    for i in range(n):
        # after i hops rank r holds the block that started on (r + i) % n
        for r in range(n):
            src = (r + i) % n
            if fast == "flash":
                bm, bl, bo = flash_block_attention(
                    q_shards[r], k_blk[r], v_blk[r], (r * T, src * T),
                    causal)
            else:
                bm, bl, bo = _block_attn(q_shards[r], k_blk[r], v_blk[r],
                                         bias_for(r, src), fast=bool(fast))
            new_m = torch.maximum(m[r], bm)
            # guard the first hop (m = -inf) and fully masked blocks
            alpha = torch.exp(torch.where(torch.isfinite(m[r]),
                                          m[r] - new_m, MASK_VALUE))
            beta = torch.exp(torch.where(torch.isfinite(bm), bm - new_m,
                                         MASK_VALUE))
            l[r] = l[r] * alpha + bl * beta
            o[r] = o[r] * alpha[..., None] + bo * beta[..., None]
            m[r] = new_m
        if i + 1 < n:
            # rank j receives the block of rank j + 1
            perm = [((j + 1) % n, j) for j in range(n)]
            k_blk, v_blk = ppermute(k_blk, perm), ppermute(v_blk, perm)
    return [(o[r] / torch.clamp(l[r], min=1e-20)[..., None])
            .to(q_shards[r].dtype) for r in range(n)]
