"""Shared model-factory plumbing: every family returns the same
``(model, params, grad_fn)`` contract, so the training loop and the
kvstore integration swap models freely.  ``params`` is an ordered dict
of tensors named like the JAX package's flax leaves, in the same order
(see :mod:`geomx_tpu_torch.convert`)."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F


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
