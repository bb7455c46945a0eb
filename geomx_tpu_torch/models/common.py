"""Shared model-factory plumbing: every family returns the same
``(model, params, grad_fn)`` contract, so the training loop and the
kvstore integration swap models freely.  ``params`` is an ordered dict
of tensors named like the JAX package's flax leaves, in the same order
(see :mod:`geomx_tpu_torch.convert`)."""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """flax's ``GroupNorm`` (as the JAX package's ``group_norm`` builds
    it: ``gcd(8, C)`` groups, eps 1e-6) on a channels-first ``x``
    ``[N, C, ...]``.  Statistics in f32 (``E[x²] - E[x]²``, clipped at
    0), then ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32,
    cast back to ``x``'s dtype."""
    N, C = x.shape[:2]
    G = math.gcd(8, C)
    xg = x.float().reshape(N, G, C // G, *x.shape[2:])
    dims = tuple(range(2, xg.ndim))
    mean = xg.mean(dims, keepdim=True)
    var = (xg.square().mean(dims, keepdim=True)
           - mean.square()).clamp_min(0.0)
    shape = (1, G, C // G) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(var + eps) * scale.float().reshape(shape)
    y = (xg - mean) * mul + bias.float().reshape(shape)
    return y.reshape(x.shape).to(x.dtype)


def make_grad_fn(model: torch.nn.Module) -> Callable:
    """``grad_fn(params, x, y) -> (loss, acc, grads)`` over the model's
    pure ``apply(params, x)``, with log-softmax
    NLL + accuracy — the one loss definition all families use.  ``x``
    and ``y`` may be numpy arrays (as the data iterators yield them);
    they are moved to the parameters' device.  ``loss`` and ``acc`` are
    0-d f32 tensors, ``grads`` a dict shaped like ``params``."""

    def grad_fn(params: Dict[str, torch.Tensor], x, y):
        dev = next(iter(params.values())).device
        x = torch.as_tensor(np.asarray(x), device=dev)
        y = torch.as_tensor(np.asarray(y), device=dev).long()
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = model.apply(p, x)
        logp = F.log_softmax(logits, dim=-1)
        loss = -logp.gather(1, y[:, None]).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), acc.detach(), dict(zip(p, grads))

    return grad_fn


def _same_pads(size: int, k: int, stride: int) -> tuple:
    """flax ``"SAME"`` padding of one spatial dim: ``(before, after)``,
    the odd element after (so 0 before, 1 after for an even input, a 3×3
    kernel and stride 2)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class FlaxLikeModel:
    """A family of the zoo as a pure function of an ordered param dict.

    Subclasses register their leaves in ``__init__`` through
    :meth:`conv`, :meth:`dense` and :meth:`norm` under flax's module
    paths (``ResBlock_1.Conv_0``), a kernel as ``weight`` in torch's
    layout (conv OIHW, Dense ``[out, in]``), GroupNorm's ``scale`` and
    every ``bias`` as flax keeps them; :attr:`shapes` lists them in
    ``tree_flatten`` order (keys sorted level by level).  ``apply(params,
    x)`` takes NHWC input (the JAX package's layout) and runs NCHW
    inside, activations in ``compute_dtype``, logits in f32.
    ``flatten`` names the Dense that reads flattened conv features and
    that map's ``(C, H, W)`` (``convert.py`` permutes its rows), or is
    None where the features are pooled."""

    flatten = None

    def __init__(self, compute_dtype: torch.dtype):
        self.compute_dtype = compute_dtype
        self._shapes: Dict[str, tuple] = {}

    @property
    def shapes(self) -> Dict[str, tuple]:
        return {n: self._shapes[n] for n in
                sorted(self._shapes, key=lambda n: tuple(n.split(".")))}

    def conv(self, name: str, cin: int, cout: int, k: int,
             bias: bool = True, groups: int = 1) -> None:
        self._shapes[f"{name}.weight"] = (cout, cin // groups, k, k)
        if bias:
            self._shapes[f"{name}.bias"] = (cout,)

    def dense(self, name: str, fin: int, fout: int) -> None:
        self._shapes[f"{name}.weight"] = (fout, fin)
        self._shapes[f"{name}.bias"] = (fout,)

    def norm(self, name: str, c: int) -> None:
        self._shapes[f"{name}.scale"] = (c,)
        self._shapes[f"{name}.bias"] = (c,)

    def init_params(self, generator: torch.Generator
                    ) -> "Dict[str, torch.Tensor]":
        """flax's defaults drawn on the CPU from ``generator``, in
        flatten order: Lecun-normal kernels (untruncated), zero biases,
        GroupNorm scales of one."""
        from collections import OrderedDict

        out = OrderedDict()
        for name, shape in self.shapes.items():
            if name.endswith(".weight"):
                fan_in = math.prod(shape[1:])
                out[name] = (torch.randn(shape, generator=generator)
                             * math.sqrt(1.0 / fan_in))
            elif name.endswith(".scale"):
                out[name] = torch.ones(shape)
            else:
                out[name] = torch.zeros(shape)
        return out

    # ---- the layers apply() is written in, on NCHW activations --------

    def _conv(self, params, name, x, stride: int = 1, groups: int = 1):
        dt = self.compute_dtype
        w = params[f"{name}.weight"].to(dt)
        bias = params.get(f"{name}.bias")
        k = w.shape[-1]
        top, bottom = _same_pads(x.shape[2], k, stride)
        left, right = _same_pads(x.shape[3], k, stride)
        if (top, left) != (bottom, right):
            # asymmetric: torch's padding= is symmetric only
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        else:
            pad = (top, left)
        return F.conv2d(x, w, None if bias is None else bias.to(dt),
                        stride=stride, padding=pad, groups=groups)

    def _dense(self, params, name, x):
        dt = self.compute_dtype
        return F.linear(x, params[f"{name}.weight"].to(dt),
                        params[f"{name}.bias"].to(dt))

    @staticmethod
    def _norm(params, name, x):
        return group_norm(x, params[f"{name}.scale"], params[f"{name}.bias"])


def create_state(model: FlaxLikeModel, seed: int, device=None):
    """``(model, params, grad_fn)`` for a :class:`FlaxLikeModel`: the
    params drawn from ``torch.Generator().manual_seed(seed)`` and placed
    on ``device`` (CUDA unless ``"cpu"``)."""
    from collections import OrderedDict

    from geomx_tpu_torch.core.platform import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params = OrderedDict((k, v.to(dev))
                         for k, v in model.init_params(gen).items())
    return model, params, make_grad_fn(model)
