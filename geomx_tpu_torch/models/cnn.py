"""The reference demo CNN (ref: examples/cnn.py:32-45 of the original
system): Conv(32, 3×3) → pool → Conv(64, 3×3) → pool → Dense(128) →
Dense(64) → Dense(num_classes), ReLU activations.

The counterpart of the JAX package's ``models/cnn.py``: parameters stay
float32 and activations run in ``compute_dtype`` (bfloat16 by default,
cast at each layer like flax's ``dtype=``).  Inputs keep the JAX
package's NHWC layout; the network runs NCHW inside.  Parameter names
follow the flax leaves (``Conv_0.bias``, ``Conv_0.weight`` …), so
sorting them gives ``training.flatten_params``'s key order.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from geomx_tpu_torch.core.platform import resolve_device


class CNN(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 spatial: Tuple[int, int] = (28, 28),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Conv_0 = nn.Conv2d(in_channels, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        chw = (64, spatial[0] // 4, spatial[1] // 4)
        # the Dense reading the flattened features and their (C, H, W):
        # convert.py permutes its rows between flax's NHWC flatten order
        # and this NCHW one
        self.flatten = ("Dense_0", chw)
        self.Dense_0 = nn.Linear(chw[0] * chw[1] * chw[2], 128)
        self.Dense_1 = nn.Linear(128, 64)
        self.Dense_2 = nn.Linear(64, num_classes)

    def apply(self, params, x):
        """The forward pass as a pure function of ``params`` (a dict
        named like :meth:`named_parameters`): safe to call from several
        worker threads at once, unlike swapping module state."""
        dt = self.compute_dtype

        def conv(name, h):
            return F.conv2d(h, params[f"{name}.weight"].to(dt),
                            params[f"{name}.bias"].to(dt), padding=1)

        def dense(name, h):
            return F.linear(h, params[f"{name}.weight"].to(dt),
                            params[f"{name}.bias"].to(dt))

        # NHWC (the JAX package's layout) → NCHW
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(conv("Conv_0", x)), 2, 2)
        x = F.max_pool2d(F.relu(conv("Conv_1", x)), 2, 2)
        x = x.flatten(1)  # NCHW order; convert.py permutes Dense_0
        x = F.relu(dense("Dense_0", x))
        x = F.relu(dense("Dense_1", x))
        return dense("Dense_2", x).float()

    def forward(self, x):
        return self.apply(dict(self.named_parameters()), x)


def init_params(model: nn.Module, generator: torch.Generator
                ) -> "OrderedDict[str, torch.Tensor]":
    """Lecun-normal weights and zero biases (flax's defaults, untruncated)
    drawn on the CPU from ``generator`` — the same numbers on any
    device — in flatten order."""
    out = OrderedDict()
    for name, p in sorted(model.named_parameters()):
        if name.endswith("bias"):
            out[name] = torch.zeros(p.shape)
        else:
            fan_in = math.prod(p.shape[1:])
            out[name] = (torch.randn(p.shape, generator=generator)
                         * math.sqrt(1.0 / fan_in))
    return out


def create_cnn_state(seed: int = 0, input_shape=(1, 28, 28, 1),
                     num_classes: int = 10,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     device=None):
    """``(model, params, grad_fn)`` on ``device`` (CUDA unless
    ``device="cpu"``); ``params`` is the ordered dict of f32 tensors
    ``grad_fn(params, x, y) -> (loss, acc, grads)`` differentiates."""
    from geomx_tpu_torch.models.common import make_grad_fn

    dev = resolve_device(device)
    _, h, w, c = input_shape
    model = CNN(num_classes=num_classes, in_channels=c, spatial=(h, w),
                compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(int(seed))
    params = OrderedDict((k, v.to(dev))
                         for k, v in init_params(model, gen).items())
    model.to(dev)
    return model, params, make_grad_fn(model)
