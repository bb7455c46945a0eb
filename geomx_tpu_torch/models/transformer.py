"""The flagship transformer LM — the port of the JAX package's
``models/transformer.py``: one device, or sequence parallel over a
mesh's ``sp`` axis.

A GPT-style LM: token + learned position embedding, ``n_layers`` blocks
of RMSNorm → causal self-attention → residual → RMSNorm → GELU MLP →
residual, a final RMSNorm and an LM head tied to the embedding.  Params
are f32; activations run in ``compute_dtype`` (bf16 by default), cast at
each weight use as the JAX package casts them.

Parameters keep the JAX shapes and einsum subscripts (``wq`` ``[D,H,Dh]``,
``wo`` ``[H,Dh,D]``, ``w1`` ``[D,F]``, ``embed`` ``[V,D]`` …) and live in
an ordered dict whose names follow the key path (``layers.0.wq``) and
whose order is JAX's ``tree_flatten`` order — dict keys sorted, list
order kept: ``embed``, each layer's ``ln1, ln2, w1, w2, wk, wo, wq, wv``,
``ln_f``, ``pos`` — so kv key ids agree between the packages.

Single-device attention per ``attn_impl``: ``dense`` (all-f32),
``fast`` (bf16 operands, f32 accumulation and softmax) or ``flash``
(the hand CUDA kernels on the card, their plain versions on the CPU).
With a mesh whose ``sp`` axis is larger than 1, attention runs sequence
parallel per ``sp_attn``: ring attention (``attn_impl="flash"`` puts
each hop's block on the hand block-attention kernel) or Ulysses.  The
mesh is single-controller (:mod:`geomx_tpu_torch.parallel.mesh`): its
ranks may share one card, or the CPU.  ``remat`` recomputes each layer
in the backward (``torch.utils.checkpoint``).  Not yet ported, and
refused rather than run differently: the mesh's ``dp`` and ``tp`` axes
(ROADMAP A11) and MoE layers (A9).
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from geomx_tpu_torch.core.platform import resolve_device
from geomx_tpu_torch.ops.flash_attention import flash_attention
from geomx_tpu_torch.parallel.ring_attention import (
    dense_attention, fast_dense_attention, ring_attention)
from geomx_tpu_torch.parallel.ulysses import ulysses_attention

AUX_COEF = 0.01  # MoE load-balancing aux weight (the JAX package's)
LAYER_KEYS = ("ln1", "ln2", "w1", "w2", "wk", "wo", "wq", "wv")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 512
    moe_every: int = 0       # every Nth layer is MoE (0 = none)
    n_experts: int = 4
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    compute_dtype: torch.dtype = torch.bfloat16
    sp_attn: str = "ring"    # "ring" | "ulysses" (mesh with sp > 1 only)
    attn_impl: str = "fast"  # "fast" | "dense" | "flash"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    def is_moe(self, layer: int) -> bool:
        return self.moe_every > 0 and (layer + 1) % self.moe_every == 0


def _refuse_unported(cfg: TransformerConfig) -> None:
    if cfg.moe_every > 0:
        raise NotImplementedError(
            "MoE layers (moe_every > 0) are not ported yet")


def _sp_size(mesh) -> int:
    """The mesh's ``sp`` size (1 without a mesh).  The mesh must name
    ``dp``, ``sp`` and ``tp`` (the JAX package shards activations as
    ``P("dp", "sp", "tp", None)``); ``dp`` and ``tp`` must be 1."""
    if mesh is None:
        return 1
    missing = [a for a in ("dp", "sp", "tp") if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"the mesh must name the axes dp, sp and tp "
                         f"(missing {missing}): {mesh.shape}")
    for axis in ("dp", "tp"):
        if mesh.shape[axis] > 1:
            raise NotImplementedError(
                f"a mesh with {axis} > 1 is not ported yet (ROADMAP A11): "
                f"{mesh.shape}")
    return mesh.shape["sp"]


def _sp_attention(cfg: TransformerConfig, mesh, q, k, v):
    """Causal attention over the mesh's ``sp`` axis: q, k, v split into
    contiguous sequence shards, one on each rank's device, attention per
    ``cfg.sp_attn``, and the shards joined on rank 0's device."""
    n = mesh.shape["sp"]
    T = q.shape[1]
    if T % n != 0:
        raise ValueError(f"sequence length {T} is not divisible by the "
                         f"'sp' axis size {n}")
    devs = mesh.axis_devices("sp")
    t = T // n

    def split(x):
        return [x[:, r * t:(r + 1) * t].to(devs[r]) for r in range(n)]

    if cfg.sp_attn == "ulysses":
        outs = ulysses_attention(split(q), split(k), split(v), mesh,
                                 causal=True,
                                 fast=cfg.attn_impl != "dense")
    else:
        fast = ("flash" if cfg.attn_impl == "flash"
                else cfg.attn_impl != "dense")
        outs = ring_attention(split(q), split(k), split(v), mesh,
                              causal=True, fast=fast)
    return torch.cat([o.to(devs[0]) for o in outs], dim=1).to(q.device)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's shapes and scales — normal draws times
    ``1/sqrt(fan_in)`` (``0.02`` for the embeddings, ``1/sqrt(D)`` for
    ``wo``, ``1/sqrt(F)`` for ``w2``), ones for the norms — drawn on the
    CPU from ``generator`` and placed on ``device`` (default CPU), in
    flatten order."""
    _refuse_unported(cfg)
    H, Dh, D, Fd = cfg.n_heads, cfg.head_dim, cfg.d_model, cfg.d_ff

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return torch.randn(shape, generator=generator) * scale

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    out["embed"] = dense((cfg.vocab, D), scale=0.02)
    pos = dense((cfg.max_seq, D), scale=0.02)
    for i in range(cfg.n_layers):
        layer = {
            "ln1": torch.ones(D), "ln2": torch.ones(D),
            "wq": dense((D, H, Dh)), "wk": dense((D, H, Dh)),
            "wv": dense((D, H, Dh)),
            "wo": dense((H, Dh, D), scale=1.0 / math.sqrt(D)),
            "w1": dense((D, Fd)),
            "w2": dense((Fd, D), scale=1.0 / math.sqrt(Fd)),
        }
        for name in LAYER_KEYS:
            out[f"layers.{i}.{name}"] = layer[name]
    out["ln_f"] = torch.ones(D)
    out["pos"] = pos
    dev = torch.device("cpu") if device is None else device
    return OrderedDict((n, t.to(dev)) for n, t in out.items())


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _single_device_attention(cfg: TransformerConfig, q, k, v):
    """Causal attention per ``cfg.attn_impl`` on ``[B, T, H, Dh]``."""
    if cfg.attn_impl == "dense":
        return dense_attention(q, k, v, causal=True)
    if cfg.attn_impl == "fast":
        return fast_dense_attention(q, k, v, causal=True)
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, 1.0 / math.sqrt(q.shape[-1]))
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _layer_forward(cfg: TransformerConfig, i: int, layer: Dict, x,
                   attn_op: Callable):
    """One block (attention + MLP residual); returns ``(x, aux)``."""
    cd = cfg.compute_dtype
    h = _rms_norm(x, layer["ln1"])
    q = torch.einsum("btd,dhk->bthk", h, layer["wq"].to(cd))
    k = torch.einsum("btd,dhk->bthk", h, layer["wk"].to(cd))
    v = torch.einsum("btd,dhk->bthk", h, layer["wv"].to(cd))
    a = attn_op(q, k, v)
    x = x + torch.einsum("bthk,hkd->btd", a, layer["wo"].to(cd))
    h = _rms_norm(x, layer["ln2"])
    # jax.nn.gelu defaults to the tanh approximation
    up = F.gelu(torch.einsum("btd,df->btf", h, layer["w1"].to(cd)),
                approximate="tanh")
    x = x + torch.einsum("btf,fd->btd", up, layer["w2"].to(cd))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def make_apply(cfg: TransformerConfig, mesh=None, return_aux: bool = False):
    """The forward ``apply(params, tokens [B, T] int) -> logits [B, T, V]
    f32`` (``(logits, aux)`` with ``return_aux``).  ``params`` is keyed
    like :func:`init_params`.  With a ``mesh`` (naming ``dp``, ``sp``
    and ``tp``) whose ``sp`` is larger than 1, attention runs sequence
    parallel over it; ``sp == 1`` is the single-device path.  Raises
    NotImplementedError on ``dp``/``tp`` larger than 1 and on MoE
    layers."""
    _refuse_unported(cfg)
    if cfg.sp_attn not in ("ring", "ulysses"):
        raise ValueError(
            f"sp_attn must be 'ring' or 'ulysses', got {cfg.sp_attn!r}")
    use_sp = _sp_size(mesh) > 1

    def attn_op(q, k, v):
        if use_sp:
            return _sp_attention(cfg, mesh, q, k, v)
        return _single_device_attention(cfg, q, k, v)

    def layer_fn(layer, x, i):
        return _layer_forward(cfg, i, layer, x, attn_op)

    def apply(params: Dict[str, torch.Tensor], tokens: torch.Tensor):
        cd = cfg.compute_dtype
        T = tokens.shape[1]
        x = params["embed"][tokens].to(cd)
        x = x + params["pos"][:T][None].to(cd)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            layer = {n: params[f"layers.{i}.{n}"] for n in LAYER_KEYS}
            if cfg.remat:
                # recompute the layer in the backward, as jax.checkpoint
                x, aux = checkpoint(layer_fn, layer, x, i,
                                    use_reentrant=False)
            else:
                x, aux = layer_fn(layer, x, i)
            aux_total = aux_total + aux
        x = _rms_norm(x, params["ln_f"])
        # the tied head runs in the compute dtype, then goes to f32
        logits = torch.einsum("btd,vd->btv", x,
                              params["embed"].to(cd)).float()
        return (logits, aux_total) if return_aux else logits

    return apply


def token_cross_entropy(logits: torch.Tensor, tokens: torch.Tensor
                        ) -> torch.Tensor:
    """Next-token cross-entropy (shift by one), the LM objective."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())
    return -ll.mean()


def lm_loss(apply_fn: Callable, params, tokens) -> torch.Tensor:
    """Next-token cross-entropy of ``apply_fn(params, tokens)``."""
    return token_cross_entropy(apply_fn(params, tokens), tokens)


def make_lm_grad_fn(cfg: TransformerConfig, mesh=None) -> Callable:
    """``grad_fn(params, x, y) -> (loss, acc, grads)`` with the worker
    loop's signature (``training.run_worker``); ``y`` is ignored (the LM
    objective shifts ``x``).  ``x`` may be a numpy array; it moves to
    the parameters' device.  ``mesh`` as in :func:`make_apply`.  Safe to
    call from several worker threads at once (pure in ``params``)."""
    apply_fn = make_apply(cfg, mesh)

    def grad_fn(params: Dict[str, torch.Tensor], x, _y=None):
        dev = next(iter(params.values())).device
        x = torch.as_tensor(np.asarray(x), device=dev).long()
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = apply_fn(p, x)
        loss = token_cross_entropy(logits, x)
        acc = (logits[:, :-1].argmax(-1) == x[:, 1:]).float().mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), acc.detach(), dict(zip(p, grads))

    return grad_fn


def create_lm_state(cfg: TransformerConfig, seed: int = 0, device=None):
    """``(params, grad_fn)`` on ``device`` (CUDA unless ``"cpu"``), the
    params drawn from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return init_params(cfg, gen, dev), make_lm_grad_fn(cfg)
