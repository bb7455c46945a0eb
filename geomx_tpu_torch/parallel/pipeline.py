"""Pipeline parallelism: a GPipe microbatch schedule over a ``pp`` axis —
the port of the JAX package's ``parallel/pipeline.py``.

A stack of identical blocks is split layer-wise over the ``pp`` mesh
axis: each stage rank owns ``L / pp`` consecutive blocks on its device.
The batch splits into M microbatches; each tick every stage that holds
a microbatch runs its blocks on it, and the activation moves from stage
rank r to r + 1 (:func:`~geomx_tpu_torch.parallel.mesh.ppermute`).
The JAX package runs the schedule as a ``lax.scan`` of M + pp − 1
ticks inside ``shard_map``, every stage computing every tick and the
bubble ticks masked out with ``where``; the port runs the same ticks
single-controller and skips a stage's bubble ticks (no real
microbatch), so each microbatch passes each block exactly once: M × L
block calls a pipeline (× dp with ``dp_axis``).  The outputs are the
same.  Gradients flow through autograd over the whole schedule; the
stage parameters are placed with
:func:`~geomx_tpu_torch.parallel.mesh.named_sharding`, so a stage's
gradient is the explicit sum over its dp replicas.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from geomx_tpu_torch.core.platform import resolve_device
from geomx_tpu_torch.parallel.mesh import Mesh, named_sharding, ppermute

PP_MOE_MESSAGE = "pp flagship pipelines homogeneous layers"


def pipeline_apply(mesh: Mesh, block_fn: Callable,
                   stacked_params: Dict[str, torch.Tensor],
                   x_mb: torch.Tensor, axis: str = "pp",
                   dp_axis: Optional[str] = None) -> torch.Tensor:
    """Run microbatches through the pipelined block stack.

    - ``block_fn(params_one_block, x) -> x`` applies ONE block.
    - ``stacked_params``: a dict of tensors with a leading layer dim L
      (L must divide by the ``axis`` size); stage rank s gets layers
      ``[s L/pp, (s+1) L/pp)`` on its device.
    - ``x_mb``: ``[M, mb, ...]`` microbatches.
    - ``dp_axis``: an optional mesh axis splitting the microbatch dim
      (index 1): each dp rank runs its own pipeline over its slice of
      every microbatch, with its own replica of the stage parameters.

    Returns the ``[M, mb, ...]`` outputs on the device of the mesh's
    rank 0 (the dp slices joined along dim 1)."""
    pp = mesh.shape[axis]
    dp = mesh.shape[dp_axis] if dp_axis else 1
    L = next(iter(stacked_params.values())).shape[0]
    if L % pp:
        raise ValueError(f"{L} layers do not split over {axis} = {pp}")
    M, mb = x_mb.shape[0], x_mb.shape[1]
    if mb % dp:
        raise ValueError(f"microbatch of {mb} does not split over "
                         f"{dp_axis} = {dp}")
    w = mb // dp
    placed = {n: named_sharding(mesh, axis).shard(t)
              for n, t in stacked_params.items()}
    outs = []
    for d in range(dp):
        at = {dp_axis: d} if dp_axis else {}
        ranks = [mesh.rank(**at, **{axis: s}) for s in range(pp)]
        devs = [mesh.devices[r] for r in ranks]
        stages = [{n: placed[n][r] for n in placed} for r in ranks]
        x = x_mb[:, d * w:(d + 1) * w]
        done: List[Optional[torch.Tensor]] = [None] * M
        acts: List[Optional[torch.Tensor]] = [None] * pp
        for t in range(M + pp - 1):
            nxt: List[Optional[torch.Tensor]] = [None] * pp
            for s in range(pp):
                m = t - s
                if not 0 <= m < M:
                    continue            # a bubble tick: no real microbatch
                h = x[m].to(devs[0]) if s == 0 else acts[s]
                for j in range(L // pp):
                    h = block_fn({n: p[j] for n, p in stages[s].items()}, h)
                if s == pp - 1:
                    done[m] = h
                nxt[s] = h
            acts = ppermute(nxt, [(s, s + 1) for s in range(pp - 1)], devs)
        outs.append(torch.stack([o.to(mesh.devices[0]) for o in done]))
    return torch.cat(outs, dim=1)


def mlp_block(params: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    """Reference block for tests and dry runs: pre-norm MLP residual
    block (RMS norm without scale, tanh GELU as ``jax.nn.gelu``)."""
    var = x.square().mean(-1, keepdim=True)
    h = x * torch.rsqrt(var + 1e-6)
    return x + F.gelu(h @ params["w1"], approximate="tanh") @ params["w2"]


def init_mlp_stack(generator: torch.Generator, n_layers: int, d: int,
                   f: int, device=None) -> "OrderedDict[str, torch.Tensor]":
    """``w1 [L, d, f]`` and ``w2 [L, f, d]``, normal draws from
    ``generator`` scaled by ``1/sqrt(d)`` and ``1/sqrt(f)``, on
    ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    w1 = torch.randn((n_layers, d, f), generator=generator) / math.sqrt(d)
    w2 = torch.randn((n_layers, f, d), generator=generator) / math.sqrt(f)
    return OrderedDict(w1=w1.to(dev), w2=w2.to(dev))


def sequential_apply(stacked_params: Dict[str, torch.Tensor],
                     x_mb: torch.Tensor, block_fn: Callable = mlp_block
                     ) -> torch.Tensor:
    """Single-device reference: the same math, no pipeline."""
    L = next(iter(stacked_params.values())).shape[0]
    outs = []
    for x in x_mb:
        for j in range(L):
            x = block_fn({n: p[j] for n, p in stacked_params.items()}, x)
        outs.append(x)
    return torch.stack(outs)


# --------------------------------------------------------------------------
# the flagship transformer over pp (+dp)
# --------------------------------------------------------------------------

def stack_layers(layers: List[Dict[str, torch.Tensor]]
                 ) -> "OrderedDict[str, torch.Tensor]":
    """Stack identical-structure layer dicts along a new leading dim
    (the pp shard dim), keys sorted.  Homogeneous (non-MoE) layers
    only."""
    return OrderedDict((n, torch.stack([layer[n] for layer in layers]))
                       for n in sorted(layers[0]))


def init_pp_transformer(cfg, generator: torch.Generator, device=None
                        ) -> "OrderedDict[str, torch.Tensor]":
    """Flagship params in pipeline layout: :func:`init_params`' draws
    from ``generator``, the ``layers.*`` stacked ``[L, ...]``, then an
    UNTIED head ``[d_model, vocab]`` (normal / sqrt(d_model), as
    ``make_staged`` draws it: one tensor must not live in two stages),
    in ``tree_flatten`` order (``embed``, ``head``, ``layers.*``,
    ``ln_f``, ``pos``), on ``device`` (CUDA unless ``"cpu"``).  MoE is
    refused with the JAX package's assertion."""
    from geomx_tpu_torch.models.transformer import init_params

    if cfg.moe_every != 0:
        raise AssertionError(PP_MOE_MESSAGE)
    dev = resolve_device(device)
    params = init_params(cfg, generator)
    head = (torch.randn((cfg.d_model, cfg.vocab), generator=generator)
            / math.sqrt(cfg.d_model))
    layers = stack_layers([
        {n: params[f"layers.{i}.{n}"] for n in cfg.layer_keys(i)}
        for i in range(cfg.n_layers)])
    out = OrderedDict(embed=params["embed"], head=head)
    out.update((f"layers.{n}", t) for n, t in layers.items())
    out.update(ln_f=params["ln_f"], pos=params["pos"])
    return OrderedDict((n, t.to(dev)) for n, t in out.items())


def pp_param_specs(pp_params: Dict[str, torch.Tensor], axis: str = "pp"
                   ) -> "OrderedDict[str, tuple]":
    """Placements mirroring an :func:`init_pp_transformer` dict: the
    layer stack split over ``axis`` on its leading dim, everything else
    replicated."""
    return OrderedDict(
        (n, ((axis,) if n.startswith("layers.") else (None,))
         + (None,) * (t.dim() - 1)) for n, t in pp_params.items())


def make_pp_apply(cfg, mesh: Mesh, n_microbatches: int, axis: str = "pp",
                  dp_axis: Optional[str] = None) -> Callable:
    """Pipelined flagship forward ``apply(pp_params, tokens) -> logits``
    f32: embedding (on rank 0's device) → the GPipe schedule over the
    stacked layers (:func:`pipeline_apply`, single-device attention per
    ``cfg.attn_impl`` on each stage's device) → ln_f and the untied head.
    Gradients flow through the schedule, so autograd of a loss of the
    returned apply is the full pipelined train step.  MoE is refused
    with the JAX package's assertion (every block runs as layer 0)."""
    from geomx_tpu_torch.models.transformer import (
        _layer_forward, _rms_norm, _single_device_attention)

    if cfg.moe_every != 0:
        raise AssertionError(PP_MOE_MESSAGE)
    cd = cfg.compute_dtype

    def block(layer, x):
        return _layer_forward(
            cfg, 0, layer, x,
            lambda q, k, v: _single_device_attention(cfg, q, k, v))[0]

    def apply(pp_params: Dict[str, torch.Tensor], tokens: torch.Tensor):
        B, T = tokens.shape
        M = n_microbatches
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             f"microbatches")
        dev = mesh.devices[0]
        tokens = tokens.to(dev).long()
        x = pp_params["embed"].to(dev)[tokens].to(cd)
        x = x + pp_params["pos"].to(dev)[:T][None].to(cd)
        x_mb = x.reshape(M, B // M, T, cfg.d_model)
        layers = {n[len("layers."):]: t for n, t in pp_params.items()
                  if n.startswith("layers.")}
        out = pipeline_apply(mesh, block, layers, x_mb, axis=axis,
                             dp_axis=dp_axis)
        x = _rms_norm(out.reshape(B, T, cfg.d_model),
                      pp_params["ln_f"].to(dev))
        return torch.einsum("btd,dv->btv", x,
                            pp_params["head"].to(dev).to(cd)).float()

    return apply
