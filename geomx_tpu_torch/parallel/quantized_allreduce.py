"""Quantized gradient all-reduce over a party's mesh axis — the port of
the JAX package's ``parallel/quantized_allreduce.py``.

An int8 block-quantized reduce-scatter + all-gather in place of the f32
gradient all-reduce (the public EQuARX design: quantize, exchange,
dequantize and accumulate the partial sums exactly, re-quantize once
for the broadcast leg).  The JAX package runs it inside ``shard_map``
with ``lax.all_to_all`` / ``lax.all_gather``; the port runs it
single-controller on a list of per-rank vectors with the mesh module's
:func:`~geomx_tpu_torch.parallel.mesh.all_to_all` and
:func:`~geomx_tpu_torch.parallel.mesh.all_gather`.  Both packages
compute it in plain tensor operations, outside any kernel.

Two exact-arithmetic properties bound the error:

- partial sums are accumulated in f32 AFTER dequantization (only the
  wire is int8), and
- each element is quantized at most twice end to end (once a leg), so
  the error is at most ``2 * block_absmax / 254``.

Rounding: ``torch.round`` rounds half to even, as ``jnp.round`` does;
every division is by a tensor (CUDA turns a division by a Python number
into a product with its reciprocal, which is not one IEEE division), so
the card and the CPU give the same bits.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from geomx_tpu_torch.parallel.dp import _per_rank
from geomx_tpu_torch.parallel.mesh import (_sum_on, all_gather, all_to_all,
                                           reduce_mean)

BLOCK = 256  # quantization block (per-block scale)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as one IEEE division on any device."""
    return x / x.new_full((), float(d))


def _quantize_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n] f32 -> (q int8 [n], scale f32 [n/BLOCK]).  n % BLOCK == 0."""
    blocks = x.reshape(-1, BLOCK)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, _div(absmax, 127.0),
                        absmax.new_ones(()))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def _dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes [..., n] and scales [..., n/BLOCK] -> f32 [..., n]."""
    lead = q.shape[:-1]
    blocks = q.reshape(*lead, -1, BLOCK).float() * scale[..., None]
    return blocks.reshape(*lead, -1)


def _chunk(n: int, k: int) -> int:
    """Elements a rank owns: n padded to a multiple of k × BLOCK, / k."""
    return -(-n // (k * BLOCK)) * BLOCK


def _reduce_scatter(xps: Sequence[torch.Tensor]):
    """Leg 1 over padded ``[k * chunk]`` vectors: each rank's codes, the
    all-to-all that hands rank d shard d of every peer, and the f32 sum
    of the dequantized shards divided by k (the mean).  Returns (per-rank
    codes and scales as quantized, per-rank shard means)."""
    k = len(xps)
    qs, ss = zip(*(_quantize_blocks(x) for x in xps))
    # [k, chunk] / [k, chunk / BLOCK]: the leading dim is exchanged
    q_peers = all_to_all([q.reshape(k, -1) for q in qs], 0, 0)
    s_peers = all_to_all([s.reshape(k, -1) for s in ss], 0, 0)
    # the peers' shards summed in rank order, on any device
    means = [_div(_sum_on(_dequantize_blocks(q, s).unbind(0), q.device), k)
             for q, s in zip(q_peers, s_peers)]
    return qs, ss, means


def _broadcast(means: Sequence[torch.Tensor], n: int):
    """Leg 2: re-quantize each rank's shard mean, all-gather the codes
    and scales, dequantize, truncate to n.  Returns (the per-rank
    results, the shard means' codes and scales)."""
    q2, s2 = zip(*(_quantize_blocks(m) for m in means))
    q_all = all_gather(list(q2), 0)
    s_all = all_gather(list(s2), 0)
    return ([_dequantize_blocks(q, s)[:n] for q, s in zip(q_all, s_all)],
            q2, s2)


def quantized_psum_mean(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Mean-reduce flat f32 vectors across the ranks of one axis with
    int8 wire traffic: ``xs`` holds each rank's full-length local vector
    on its device (the axis size is ``len(xs)``); returns each rank's
    copy of the reduced vector.

    Reduce-scatter leg: quantize locally, all-to-all so rank d receives
    shard d of every peer, dequantize and sum in f32.  Broadcast leg:
    re-quantize the summed shard, all-gather, dequantize.  Wire bytes
    ~ 2 n (1 + 4/BLOCK) against 2 · 4n for the f32 ring."""
    k, n = len(xs), xs[0].shape[0]
    pad = _chunk(n, k) * k - n
    _, _, means = _reduce_scatter(
        [torch.nn.functional.pad(x, (0, pad)) for x in xs])
    return _broadcast(means, n)[0]


def quantized_psum_mean_ef(xs: Sequence[torch.Tensor],
                           residuals: Sequence[torch.Tensor]):
    """:func:`quantized_psum_mean` with EQuARX-style error feedback:
    returns ``(means, new_residuals)``, one of each per rank.

    Each rank folds its residual into this round's contribution BEFORE
    quantizing and keeps the quantization error it just incurred for the
    next round, so a block's sub-threshold components accumulate in the
    residual until they cross the quantization step instead of being
    lost.  The residual lives in the SUM domain (each contribution enters
    with weight 1, ``mean * k``):

    - leg 1: ``(x + r) - dequant(quant(x + r))``, the rank's own
      full-length quantization error;
    - leg 2: the re-quantization error of the shard the rank owns, times
      k (the shard sum it distorts lands in the output with weight k
      against one contribution), held by the shard owner alone.

    Thread ``new_residuals`` back in next round (zeros to start).
    Without it this is :func:`quantized_psum_mean` of ``x + r``."""
    k, n = len(xs), xs[0].shape[0]
    chunk = _chunk(n, k)
    pad = chunk * k - n
    xps = [torch.nn.functional.pad(x + r, (0, pad))
           for x, r in zip(xs, residuals)]
    qs, ss, means = _reduce_scatter(xps)
    out, q2s, s2s = _broadcast(means, n)
    new_r = []
    for d, (xp, q, s, m, q2, s2) in enumerate(
            zip(xps, qs, ss, means, q2s, s2s)):
        leg = xp - _dequantize_blocks(q, s)
        err2 = (m - _dequantize_blocks(q2, s2)) * float(k)
        leg2 = torch.zeros_like(xp)
        leg2[d * chunk:(d + 1) * chunk] = err2
        new_r.append((leg + leg2)[:n])
    return out, new_r


def make_party_step_quantized(grad_fn: Callable, mesh) -> Callable:
    """Drop-in for :func:`geomx_tpu_torch.parallel.dp.make_party_step`
    that reduces the gradients with :func:`quantized_psum_mean` instead
    of the exact f32 psum: each rank's gradients concatenated in
    ``tree_flatten`` order (sorted keys) as one f32 vector.  Loss and
    accuracy are mean-reduced exactly.  The mesh's first axis is the
    reduce axis."""
    def step(params, x, y):
        outs, devs = _per_rank(grad_fn, mesh, params, x, y)
        names = sorted(outs[0][2])
        sizes = [outs[0][2][n].numel() for n in names]
        cats = [torch.cat([g[n].reshape(-1).float() for n in names])
                for _, _, g in outs]
        red = quantized_psum_mean(cats)[0]
        grads = {}
        for n, piece in zip(names, red.split(sizes)):
            grads[n] = piece.reshape(outs[0][2][n].shape)
        grads = {n: grads[n] for n in outs[0][2]}
        return (reduce_mean([o[0] for o in outs], devs[0]),
                reduce_mean([o[1] for o in outs], devs[0]), grads)

    return step
