"""Carry model weights between the JAX package and the port.

The CNN (:func:`flax_to_torch`, :func:`torch_to_flax`), and the zoo and
ResNet (:func:`flax_zoo_to_torch`, :func:`torch_zoo_to_flax`: the same
rules on nested module names, ``model.flatten`` naming the Dense that
reads flattened features, and GroupNorm's ``scale`` and ``bias`` kept
as they are):

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

The flagship transformer (:func:`flax_lm_to_torch`,
:func:`torch_lm_to_flax`): the JAX param tree ``{"embed", "pos",
"ln_f", "layers": [{...}, ...]}`` and the port's ordered dict share
every shape, so conversion only renames along the key path
(``layers.0.wq``) and orders the leaves as JAX's ``tree_flatten`` does.

The flagship's stages for the overlap loop (:func:`flax_staged_to_torch`,
:func:`torch_staged_to_flax`): the JAX ``make_staged`` stage list (a
list of flat dicts with numpy leaves) and the port's list of ordered
dicts share every key name and shape; each stage keeps its keys, in
sorted (``tree_flatten``) order.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

# the Dense layer that reads the flattened conv features, and that
# feature map's (channels, height, width) at the CNN's full width
FLATTEN_DENSE = "Dense_0"
FLATTEN_CHW = (64, 7, 7)


def _flat_rows(k: np.ndarray, chw, to_chw: bool) -> np.ndarray:
    """Permute a Dense kernel's input rows between flax's (h, w, c)
    flatten order and the port's (c, h, w)."""
    c, h, wd = chw
    if to_chw:
        return (k.reshape(h, wd, c, -1).transpose(2, 0, 1, 3)
                .reshape(c * h * wd, -1))
    return k.reshape(c, h, wd, -1).transpose(1, 2, 0, 3).reshape(c * h * wd,
                                                                 -1)


def flax_zoo_to_torch(flax_params: dict, flatten=None, device=None
                      ) -> "OrderedDict[str, torch.Tensor]":
    """A flax CNN, zoo or ResNet param tree (numpy leaves, modules nested
    as flax nests them) → the port's ordered params: each path joined
    with dots, in ``tree_flatten`` order; a ``kernel`` becomes
    ``weight`` in torch's layout (HWIO → OIHW, ``[in, out]`` →
    ``[out, in]``); ``bias`` and GroupNorm's ``scale`` stay as they are.
    ``flatten`` (a model's ``flatten``: the Dense reading flattened
    conv features and their ``(C, H, W)``) permutes that kernel's rows."""
    out = OrderedDict()

    def walk(prefix, node):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                walk(f"{prefix}{key}.", val)
                continue
            a = np.asarray(val, np.float32)
            if key != "kernel":
                out[prefix + key] = a
                continue
            mod = prefix[:-1]
            if a.ndim == 4:                      # HWIO → OIHW
                a = a.transpose(3, 2, 0, 1)
            else:                                # [in, out] → [out, in]
                if flatten is not None and mod == flatten[0]:
                    a = _flat_rows(a, flatten[1], to_chw=True)
                a = a.T
            out[f"{mod}.weight"] = a

    walk("", flax_params.get("params", flax_params))
    dev = device if device is not None else "cpu"
    return OrderedDict((n, torch.from_numpy(np.array(v, np.float32)).to(dev))
                       for n, v in out.items())


def torch_zoo_to_flax(params: Dict[str, torch.Tensor], flatten=None) -> dict:
    """The port's CNN, zoo or ResNet params → the flax param tree with
    numpy leaves (the inverse of :func:`flax_zoo_to_torch`)."""
    tree: dict = {}
    for name, t in params.items():
        *mods, kind = name.split(".")
        a = t.detach().float().cpu().numpy()
        if kind == "weight":
            kind = "kernel"
            if a.ndim == 4:                      # OIHW → HWIO
                a = a.transpose(2, 3, 1, 0)
            else:
                a = a.T
                if flatten is not None and ".".join(mods) == flatten[0]:
                    a = _flat_rows(a, flatten[1], to_chw=False)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[kind] = np.ascontiguousarray(a).copy()
    return {"params": tree}


def flax_to_torch(flax_params: dict, device=None
                  ) -> "OrderedDict[str, torch.Tensor]":
    """flax CNN params (numpy leaves) → the port's ordered params."""
    return flax_zoo_to_torch(flax_params, (FLATTEN_DENSE, FLATTEN_CHW),
                             device)


def torch_to_flax(params: Dict[str, torch.Tensor]) -> dict:
    """The port's params → a flax CNN param tree with numpy leaves."""
    return torch_zoo_to_flax(params, (FLATTEN_DENSE, FLATTEN_CHW))


def flax_lm_to_torch(tree: dict, device=None
                     ) -> "OrderedDict[str, torch.Tensor]":
    """JAX transformer params (numpy leaves) → the port's ordered
    params, in ``tree_flatten`` order (dict keys sorted, list order
    kept)."""
    out = OrderedDict()
    for key in sorted(tree):
        if key == "layers":
            for i, layer in enumerate(tree["layers"]):
                for name in sorted(layer):
                    out[f"layers.{i}.{name}"] = layer[name]
        else:
            out[key] = tree[key]
    dev = device if device is not None else "cpu"
    return OrderedDict((n, torch.from_numpy(np.array(v, np.float32)).to(dev))
                       for n, v in out.items())


def torch_lm_to_flax(params: Dict[str, torch.Tensor]) -> dict:
    """The port's transformer params → the JAX param tree with numpy
    leaves."""
    tree: dict = {}
    layers: Dict[int, dict] = {}
    for name, t in params.items():
        a = t.detach().float().cpu().numpy().copy()
        if name.startswith("layers."):
            _, i, leaf = name.split(".", 2)
            layers.setdefault(int(i), {})[leaf] = a
        else:
            tree[name] = a
    tree["layers"] = [layers[i] for i in range(len(layers))]
    return tree


def flax_staged_to_torch(stages: List[dict], device=None
                         ) -> "List[OrderedDict[str, torch.Tensor]]":
    """JAX ``make_staged`` stage params (numpy leaves) → the port's
    stage dicts, each in sorted key order."""
    return [flax_lm_to_torch(dict(s), device) for s in stages]


def torch_staged_to_flax(stages: List[Dict[str, torch.Tensor]]
                         ) -> List[dict]:
    """The port's stage dicts → JAX ``make_staged`` stage params with
    numpy leaves."""
    return [{n: t.detach().float().cpu().numpy().copy()
             for n, t in s.items()} for s in stages]
