"""The initial weights of a configuration, made on the device from the
seed, in the order and under the names the port's models use (its kv key
order).

One ``torch.Generator`` on the run's device draws every random leaf in a
single call into one flat buffer; each leaf is a scaled slice of it.
The program and the reference both take their weights from here, so
they start from the same tensors bit for bit.

Scales follow the port's initialisers: the transformer's
(``models/transformer.py`` ``init_params``: normal over the fan-in, 0.02
for the embeddings, ones for the norms).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import List, Tuple

import torch


def transformer_leaves(m: dict) -> List[Tuple[str, tuple, object]]:
    """``(name, shape, init)`` in kv key order; ``init`` is a scale for a
    normal draw or the string ``"ones"``."""
    D, H, F, V, T = (m["d_model"], m["n_heads"], m["d_ff"], m["vocab"],
                     m["max_seq"])
    Dh = D // H
    out = [("embed", (V, D), 0.02)]
    for i in range(m["n_layers"]):
        layer = {"ln1": ((D,), "ones"), "ln2": ((D,), "ones"),
                 "w1": ((D, F), 1 / math.sqrt(D)),
                 "w2": ((F, D), 1 / math.sqrt(F)),
                 "wk": ((D, H, Dh), 1 / math.sqrt(D)),
                 "wo": ((H, Dh, D), 1 / math.sqrt(D)),
                 "wq": ((D, H, Dh), 1 / math.sqrt(D)),
                 "wv": ((D, H, Dh), 1 / math.sqrt(D))}
        for name in sorted(layer):
            out.append((f"layers.{i}.{name}",) + layer[name])
    out.append(("ln_f", (D,), "ones"))
    out.append(("pos", (T, D), 0.02))
    return out


LEAVES = {"transformer": transformer_leaves}


def leaves(config: dict) -> List[Tuple[str, tuple, object]]:
    return LEAVES[config["family"]](config["model"])


def make(config: dict, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """Every leaf as an f32 tensor on ``device``, from ``seed``."""
    spec = leaves(config)
    drawn = sum(math.prod(s) for _, s, init in spec
                if not isinstance(init, str))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(drawn, generator=gen, device=device,
                       dtype=torch.float32)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    off = 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = flat[off:off + n].view(shape).mul(init)
            off += n
    return out
