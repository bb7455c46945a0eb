"""Causal flash attention: plain PyTorch versions, the dispatchers, and
the autograd function the transformer's ``attn_impl="flash"`` runs.

The counterpart of JAX's bundled Pallas TPU kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``), which the JAX
package calls from ``models/transformer.py:245-251`` with
``causal=True, sm_scale=1/sqrt(Dh)`` and has no module of its own in
the repo.  The public layout is the JAX package's ``[B, T, H, Dh]``
(the JAX call swaps to ``[B, H, T, Dh]`` around the bundled kernel; the
CUDA kernels read ``[B, T, H, Dh]`` directly).

A CUDA tensor goes to the hand kernels
(:mod:`geomx_tpu_torch.ops.kernels.flash_attention`, which also keeps
their launch counts), a CPU tensor to the plain versions here; there is
no fallback between the two.

Numerics, shared by the kernels and the plain versions, and those of
JAX's kernel: scores in f32 from the input operands, masked scores
excluded from the softmax, ``lse`` f32 ``[B, H, T]``, every product
accumulated in f32.  In the forward the probabilities are rounded to the
input dtype before the PV product (as ``fast_dense_attention`` rounds
them); the kernel rounds the running (unnormalised) ``p`` and divides by
the row sum at the end, as JAX's kernel does, the plain version rounds
the normalised ``p``: in bf16 the two differ by about one bf16 ulp of
``o``.  The backward recomputes ``p = exp(s - lse)`` in f32, rounds it
to the input dtype before ``dv = p^T do`` (JAX's ``flash_attention.py``
:900), and rounds ``ds * sm_scale``, ``ds = p * (dp - delta)``, before
``dk = ds^T q`` and ``dq = ds k`` (:911-918, :1243-1261); ``dk`` and
``dq`` take no scale after the product.  In f32 the roundings are the
identity.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch

from geomx_tpu_torch.ops.kernels import flash_attention as kernels
from geomx_tpu_torch.parallel.ring_attention import MASK_VALUE


def _causal(T: int, device) -> torch.Tensor:
    """[T, T] bool, True where query t may see key s (s <= t)."""
    i = torch.arange(T, device=device)
    return i[:, None] >= i[None, :]


def _scores(q: torch.Tensor, k: torch.Tensor, sm_scale: float
            ) -> torch.Tensor:
    """Scaled causal scores f32 [B, H, Tq, Tk], masked at MASK_VALUE."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    return s.masked_fill(~_causal(q.shape[1], q.device), MASK_VALUE)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain causal attention: ``(o [B,T,H,Dh] in q's dtype, lse f32
    [B,H,T])``."""
    s = _scores(q, k, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            sm_scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain backward of :func:`flash_attention_ref`: ``(dq, dk, dv)`` in
    q's dtype, with ``p = exp(s - lse)`` recomputed in f32 and
    ``delta = rowsum(do * o)``; ``p`` and ``ds * sm_scale`` are rounded
    to q's dtype before the products they feed, as in JAX's kernel."""
    s = _scores(q, k, sm_scale)
    p = torch.exp(s - lse[..., None])      # masked entries underflow to 0
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1).transpose(1, 2)   # [B, H, T]
    ds = (dp - delta[..., None]) * p
    ds = (ds * sm_scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the CUDA kernel for CUDA tensors, else the plain
    version."""
    if q.is_cuda:
        return kernels.flash_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), sm_scale)
    return flash_attention_ref(q, k, v, sm_scale)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, sm_scale: float,
                        ordered: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the CUDA kernels for CUDA tensors (in bf16 with
    dQ summed in a fixed order when ``ordered``), else the plain
    version, whose order is fixed anyway."""
    if q.is_cuda:
        return kernels.flash_bwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), o.contiguous(),
                                 lse.contiguous(), do.contiguous(), sm_scale,
                                 ordered=ordered)
    return flash_attention_bwd_ref(q, k, v, o, lse, do, sm_scale)


_ORDER = threading.local()


@contextlib.contextmanager
def fixed_order_backward(enabled: bool = True):
    """While open (on this thread), :func:`flash_attention` calls record
    that their backward must repeat bit for bit: the bf16 kernel then
    sums dQ over the key tiles in a fixed order (``Config.deterministic``
    on the worker side; PyTorch's global deterministic switch has the
    same effect everywhere).  The choice is taken in the forward, so it
    holds wherever autograd runs the backward."""
    prev = getattr(_ORDER, "on", False)
    _ORDER.on = bool(enabled)
    try:
        yield
    finally:
        _ORDER.on = prev


def fixed_order() -> bool:
    """Whether :func:`fixed_order_backward` is open on this thread."""
    return getattr(_ORDER, "on", False)


class FlashAttention(torch.autograd.Function):
    """Causal attention whose forward and backward are the dispatchers
    above; saves ``(q, k, v, o, lse)`` and :func:`fixed_order` for the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        # the einsum projections hand over strided views; one copy here
        # serves both the forward and the saved inputs of the backward
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        ctx.ordered = fixed_order()
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale,
                                         ordered=ctx.ordered)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention on ``[B, T, H, Dh]``, differentiable; ``sm_scale``
    defaults to ``1/sqrt(Dh)`` as the JAX package passes it."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, float(sm_scale))

