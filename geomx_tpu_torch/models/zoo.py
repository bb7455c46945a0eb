"""The model zoo — the port of the JAX package's ``models/zoo.py``: MLP,
VGG, MobileNet and SqueezeNet at the JAX package's default widths, for
its CIFAR/MNIST-shape workloads.

Each family is a :class:`~geomx_tpu_torch.models.common.FlaxLikeModel`:
f32 parameters named after the flax leaves (``_Fire_2.Conv_1.weight``,
``GroupNorm_0.scale``) in JAX's ``tree_flatten`` order, a pure
``apply(params, x)`` on NHWC input run NCHW inside, activations in
``compute_dtype`` (bf16 by default), GroupNorm (``gcd(8, C)`` groups)
where the JAX package has it.  flax's ``"SAME"`` padding is asymmetric
at stride 2 (nothing before, one after on an even input), so strided
convolutions pad explicitly; ``max_pool`` is ``"VALID"`` (floor).
Weights cross from the JAX package through
:func:`geomx_tpu_torch.convert.flax_zoo_to_torch`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from geomx_tpu_torch.models.common import FlaxLikeModel, create_state


class MLP(FlaxLikeModel):
    """Dense stacks on the flattened NHWC input (no permutation: flax
    flattens the input as it comes)."""

    def __init__(self, num_classes: int = 10,
                 hidden: Sequence[int] = (256, 128),
                 input_shape: Tuple[int, ...] = (1, 28, 28, 1),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(compute_dtype)
        fin = 1
        for d in input_shape[1:]:
            fin *= d
        widths = [fin, *hidden, num_classes]
        self.n_dense = len(widths) - 1
        for i in range(self.n_dense):
            self.dense(f"Dense_{i}", widths[i], widths[i + 1])

    def apply(self, params, x):
        x = x.reshape(x.shape[0], -1).to(self.compute_dtype)
        for i in range(self.n_dense):
            x = self._dense(params, f"Dense_{i}", x)
            if i < self.n_dense - 1:
                x = F.relu(x)
        return x.float()


class VGG(FlaxLikeModel):
    """N stages of [conv3x3 + GroupNorm + ReLU] × reps and a 2×2 max
    pool, then a Dense head on the flattened features."""

    def __init__(self, num_classes: int = 10,
                 stages: Sequence[Tuple[int, int]] = ((32, 1), (64, 1),
                                                      (128, 2)),
                 head: int = 256,
                 input_shape: Tuple[int, ...] = (1, 28, 28, 1),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(compute_dtype)
        self.stages = tuple(tuple(s) for s in stages)
        _, h, w, cin = input_shape
        i = 0
        for feats, reps in self.stages:
            for _ in range(reps):
                self.conv(f"Conv_{i}", cin, feats, 3)
                self.norm(f"GroupNorm_{i}", feats)
                cin, i = feats, i + 1
            h, w = h // 2, w // 2
        # flax flattens NHWC, the port NCHW: convert.py permutes Dense_0
        self.flatten = ("Dense_0", (cin, h, w))
        self.dense("Dense_0", cin * h * w, head)
        self.dense("Dense_1", head, num_classes)

    def apply(self, params, x):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        i = 0
        for _, reps in self.stages:
            for _ in range(reps):
                x = self._conv(params, f"Conv_{i}", x)
                x = F.relu(self._norm(params, f"GroupNorm_{i}", x))
                i += 1
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self._dense(params, "Dense_0", x.flatten(1)))
        return self._dense(params, "Dense_1", x).float()


class MobileNet(FlaxLikeModel):
    """A conv stem, then depthwise-separable blocks (``_SeparableBlock``:
    depthwise 3×3 at the block's stride + GroupNorm + ReLU, pointwise
    1×1 + GroupNorm + ReLU), global average pool, Dense."""

    def __init__(self, num_classes: int = 10,
                 blocks: Sequence[Tuple[int, int]] = ((64, 1), (128, 2),
                                                      (256, 2)),
                 width: int = 32,
                 input_shape: Tuple[int, ...] = (1, 28, 28, 1),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(compute_dtype)
        self.blocks = tuple(tuple(b) for b in blocks)
        cin = input_shape[-1]
        self.conv("Conv_0", cin, width, 3, bias=False)
        self.norm("GroupNorm_0", width)
        cin = width
        for j, (feats, _) in enumerate(self.blocks):
            blk = f"_SeparableBlock_{j}"
            self.conv(f"{blk}.Conv_0", cin, cin, 3, bias=False, groups=cin)
            self.norm(f"{blk}.GroupNorm_0", cin)
            self.conv(f"{blk}.Conv_1", cin, feats, 1, bias=False)
            self.norm(f"{blk}.GroupNorm_1", feats)
            cin = feats
        self.dense("Dense_0", cin, num_classes)

    def apply(self, params, x):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu(self._norm(params, "GroupNorm_0",
                              self._conv(params, "Conv_0", x)))
        for j, (_, stride) in enumerate(self.blocks):
            blk = f"_SeparableBlock_{j}"
            x = self._conv(params, f"{blk}.Conv_0", x, stride=stride,
                           groups=x.shape[1])
            x = F.relu(self._norm(params, f"{blk}.GroupNorm_0", x))
            x = self._conv(params, f"{blk}.Conv_1", x)
            x = F.relu(self._norm(params, f"{blk}.GroupNorm_1", x))
        return self._dense(params, "Dense_0", x.mean((2, 3))).float()


class SqueezeNet(FlaxLikeModel):
    """A stride-2 conv stem, Fire modules (squeeze 1×1, then expand 1×1
    ‖ 3×3, concatenated) around a max pool, and a 1×1 conv classifier
    averaged over space (no Dense at all)."""

    FIRES = ((8, 32), (8, 32), (16, 64), (16, 64))   # (squeeze, expand)
    POOL_AFTER = 1                                   # max pool after it

    def __init__(self, num_classes: int = 10,
                 input_shape: Tuple[int, ...] = (1, 28, 28, 1),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(compute_dtype)
        self.conv("Conv_0", input_shape[-1], 32, 3)
        cin = 32
        for j, (sq, ex) in enumerate(self.FIRES):
            self.conv(f"_Fire_{j}.Conv_0", cin, sq, 1)
            self.conv(f"_Fire_{j}.Conv_1", sq, ex, 1)
            self.conv(f"_Fire_{j}.Conv_2", sq, ex, 3)
            cin = 2 * ex
        self.conv("Conv_1", cin, num_classes, 1)

    def apply(self, params, x):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu(self._conv(params, "Conv_0", x, stride=2))
        for j in range(len(self.FIRES)):
            fire = f"_Fire_{j}"
            s = F.relu(self._conv(params, f"{fire}.Conv_0", x))
            x = torch.cat([F.relu(self._conv(params, f"{fire}.Conv_1", s)),
                           F.relu(self._conv(params, f"{fire}.Conv_2", s))],
                          dim=1)
            if j == self.POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        x = self._conv(params, "Conv_1", x)
        return x.mean((2, 3)).float()


def _factory(cls):
    def create(seed: int = 0, input_shape: Tuple[int, ...] = (1, 28, 28, 1),
               num_classes: int = 10,
               compute_dtype: torch.dtype = torch.bfloat16, device=None,
               **kw):
        model = cls(num_classes=num_classes, input_shape=tuple(input_shape),
                    compute_dtype=compute_dtype, **kw)
        return create_state(model, seed, device)

    create.__name__ = f"create_{cls.__name__.lower()}_state"
    create.__doc__ = (
        f"``(model, params, grad_fn)`` of {cls.__name__} on ``device`` "
        "(CUDA unless ``\"cpu\"``), the params drawn from "
        "``torch.Generator().manual_seed(seed)``; ``kw`` sets the "
        "family's widths.")
    return create


create_mlp_state = _factory(MLP)
create_vgg_state = _factory(VGG)
create_mobilenet_state = _factory(MobileNet)
create_squeezenet_state = _factory(SqueezeNet)
