"""One (Q-block, KV-block) partial attention: the block of each ring
hop — the port of the JAX package's ``ops/block_attention.py``.

``ring_attention(fast="flash")`` computes each hop's block through
:func:`flash_block_attention`.  Positions arrive as offsets: ``q_off``
and ``k_off`` are the global positions of the blocks' first tokens, so
one function serves every hop — diagonal (the causal triangle), below
the diagonal (fully visible) and above it (fully masked).  The outputs
are the unnormalised online-softmax partials the ring merges:
``m [B,Tq,H]``, ``l [B,Tq,H]`` and ``o [B,Tq,H,D]``, all f32.  A masked
score is exactly ``MASK_VALUE`` (-1e30), so a fully masked row gives
``m = -1e30``, ``l = Tk`` and ``o = sum_k v``: junk that the merge wipes
(its weight ``exp(-1e30 - m)`` is 0).

A CUDA tensor goes to the hand kernel
(:mod:`geomx_tpu_torch.ops.kernels.block_attention`, which counts its
launches), a CPU tensor to :func:`block_attention_ref`; there is no
fallback between the two.  The JAX package's ``GEOMX_FLASH_BLOCK_Q``
tile knob is not ported: the kernel picks its own tile.

The backward recomputes the block through :func:`block_attention_ref`
and takes its gradient, as the JAX package's custom VJP does
(``_vjp_fwd``/``_vjp_bwd``).  Neither package has a backward kernel
here: the JAX VJP is einsums that XLA compiles, and the port's is the
same torch ops.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from geomx_tpu_torch.ops.kernels import block_attention as kernels
from geomx_tpu_torch.parallel.ring_attention import MASK_VALUE

Offsets = Tuple[int, int]


def block_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        offs: Offsets, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Plain block attention, with the JAX reference's rounding points:
    f32 scores of the input operands, ``× 1/sqrt(D)``, the mask
    ``q_off + i >= k_off + j`` filled with ``MASK_VALUE``; ``m = amax``,
    ``p = exp(s - m)``, ``l = sum p`` in f32; ``o`` = (``p`` rounded to
    q's dtype) · v in f32.  ``torch.amax`` splits the gradient of tied
    maxima evenly, as ``jnp.max`` does."""
    Tq, Tk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if causal:
        q_pos = offs[0] + torch.arange(Tq, device=q.device)
        k_pos = offs[1] + torch.arange(Tk, device=q.device)
        vis = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(vis[None, :, None, :], s, MASK_VALUE)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bqhk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    return m, l, o


def block_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        offs: Offsets, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """``(m, l, o)``: the CUDA kernel for CUDA tensors, else the plain
    version.  Views (the ring's shards) go to the kernel as they are,
    which reads them through their strides."""
    if q.is_cuda:
        return kernels.block_attn_fwd(q, k, v, offs, causal)
    return block_attention_ref(q, k, v, offs, causal)


class BlockAttention(torch.autograd.Function):
    """Forward: :func:`block_attention_fwd`.  Backward: the gradient of
    :func:`block_attention_ref` recomputed from the saved inputs (no
    stored probabilities)."""

    @staticmethod
    def forward(ctx, q, k, v, offs, causal):
        ctx.save_for_backward(q, k, v)
        ctx.offs, ctx.causal = offs, causal
        return block_attention_fwd(q, k, v, offs, causal)

    @staticmethod
    def backward(ctx, dm, dl, do):
        saved = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = block_attention_ref(*saved, ctx.offs, ctx.causal)
            grads = torch.autograd.grad(outs, saved, (dm, dl, do))
        return (*grads, None, None)


def flash_block_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, offs: Offsets,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One differentiable partial attention block: q ``[B, Tq, H, D]``,
    k/v ``[B, Tk, H, D]``, ``offs = (q_off, k_off)`` Python ints (the
    global positions of q's and k's first tokens).  Returns ``(m, l,
    o)`` f32, the unnormalised partials ``ring_attention`` merges."""
    offs = (int(offs[0]), int(offs[1]))
    return BlockAttention.apply(q, k, v, offs, bool(causal))
