"""Worker-side (local) optimizers for the HFA and ESync loops.

The JAX package's loops run an optax transform on the worker
(``optax.adam(1e-2)`` by default); these are the port's counterparts, in
optax's shape: a transform is an ``init(params) -> state`` and an
``update(grads, state, params) -> (updates, state)`` over dicts of
tensors keyed like the params, and :func:`apply_updates` adds the
updates.  The state lives on the params' device.

The arithmetic follows optax's order and rounding, so that the same
gradients give the same weights up to f32 rounding: ``sgd`` is ``-lr *
g``; ``adam`` is optax's ``scale_by_adam`` then ``-lr`` (``mu = (1-b1)·g
+ b1·mu``, ``nu = (1-b2)·g² + b2·nu``, each bias-corrected by ``1 -
b^count`` formed in f32, ``mu_hat / (sqrt(nu_hat) + eps)``).  PyTorch's
``torch.optim.Adam`` folds the corrections into the step size and
rounds elsewhere, so it is not used.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def sgd(lr: float) -> GradientTransformation:
    """Plain SGD: ``updates = -lr * grads`` (no state)."""

    def init(params: Tensors):
        return ()

    def update(grads: Tensors, state, params=None):
        return OrderedDict((n, g * -lr) for n, g in grads.items()), state

    return GradientTransformation(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """Adam in optax's order (``optax.adam(lr, b1, b2, eps)``)."""

    def init(params: Tensors):
        zeros = lambda: OrderedDict(  # noqa: E731
            (n, torch.zeros_like(p)) for n, p in params.items())
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def update(grads: Tensors, state, params=None):
        count = state["count"] + 1
        # 1 - b^count in f32, as optax forms it from its int32 count
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu, nu, out = OrderedDict(), OrderedDict(), OrderedDict()
        for n, g in grads.items():
            m = g * (1 - b1) + state["mu"][n] * b1
            v = (g * g) * (1 - b2) + state["nu"][n] * b2
            mu[n], nu[n] = m, v
            out[n] = (m / c1) / (torch.sqrt(v / c2) + eps) * -lr
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def apply_updates(params: Tensors, updates: Tensors
                  ) -> "OrderedDict[str, torch.Tensor]":
    """``params + updates``, leaf by leaf, in the params' dtype."""
    return OrderedDict((n, (p + updates[n]).to(p.dtype))
                       for n, p in params.items())
