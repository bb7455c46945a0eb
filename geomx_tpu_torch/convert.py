"""Carry CNN weights between the JAX package and the port.

The JAX side is a flax parameter tree held as numpy
(``{"params": {"Conv_0": {"bias", "kernel"}, …}}``); the port side an
ordered dict of tensors named ``Conv_0.bias``, ``Conv_0.weight`` ….
Layouts differ:

- a conv kernel is HWIO in flax and OIHW in torch;
- a Dense kernel is ``[in, out]`` in flax and a Linear weight
  ``[out, in]`` in torch;
- the first Dense after the convolutions reads a flattened feature map:
  flax flattens NHWC (``models/cnn.py:35``), torch NCHW, so its input
  rows are permuted between (h, w, c) and (c, h, w) order.

Sorted port names give the same leaf order as
``geomx_tpu.training.flatten_params`` (modules in name order, ``bias``
before ``kernel``/``weight``), so kv key ids agree between the packages.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

# the Dense layer that reads the flattened conv features, and that
# feature map's (channels, height, width) at the CNN's full width
FLATTEN_DENSE = "Dense_0"
FLATTEN_CHW = (64, 7, 7)


def flax_to_torch(flax_params: dict, device=None
                  ) -> "OrderedDict[str, torch.Tensor]":
    """flax CNN params (numpy leaves) → the port's ordered params."""
    tree = flax_params.get("params", flax_params)
    out = OrderedDict()
    for mod in sorted(tree):
        leaves = tree[mod]
        out[f"{mod}.bias"] = np.asarray(leaves["bias"], np.float32)
        k = np.asarray(leaves["kernel"], np.float32)
        if k.ndim == 4:                      # HWIO → OIHW
            w = k.transpose(3, 2, 0, 1)
        else:                                # [in, out] → [out, in]
            if mod == FLATTEN_DENSE:
                c, h, wd = FLATTEN_CHW
                k = (k.reshape(h, wd, c, -1).transpose(2, 0, 1, 3)
                     .reshape(c * h * wd, -1))
            w = k.T
        out[f"{mod}.weight"] = w
    return OrderedDict((n, torch.from_numpy(np.array(v, np.float32))
                        .to(device if device is not None else "cpu"))
                       for n, v in out.items())


def torch_to_flax(params: Dict[str, torch.Tensor]) -> dict:
    """The port's params → a flax CNN param tree with numpy leaves."""
    tree: dict = {}
    for name, t in params.items():
        mod, kind = name.rsplit(".", 1)
        a = t.detach().float().cpu().numpy()
        if kind == "bias":
            tree.setdefault(mod, {})["bias"] = a.copy()
            continue
        if a.ndim == 4:                      # OIHW → HWIO
            k = a.transpose(2, 3, 1, 0)
        else:
            k = a.T
            if mod == FLATTEN_DENSE:
                c, h, wd = FLATTEN_CHW
                k = (k.reshape(c, h, wd, -1).transpose(1, 2, 0, 3)
                     .reshape(c * h * wd, -1))
        tree.setdefault(mod, {})["kernel"] = np.ascontiguousarray(k)
    return {"params": tree}
