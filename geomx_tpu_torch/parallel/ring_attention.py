"""Single-device attention of the JAX package's
``parallel/ring_attention.py``: ``dense_attention`` and
``fast_dense_attention`` on ``[B, T, H, Dh]`` tensors.

``ring_attention`` itself (K/V rotation over an ``sp`` mesh axis, and
its fused block kernel ``ops/block_attention.py``) needs several
devices and comes with the multi-device slice.
"""

from __future__ import annotations

import math

import torch

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
