"""Small ResNet for CIFAR-shape inputs — the port of the JAX package's
``models/resnet.py``: a conv stem, stages of residual blocks
(``ResBlock``: conv3×3 at the block's stride + GroupNorm + ReLU, conv3×3
+ GroupNorm, a 1×1 projection shortcut where the width or stride
changes), global average pool, Dense.

A :class:`~geomx_tpu_torch.models.common.FlaxLikeModel`, like the zoo's
families: flax leaf names in ``tree_flatten`` order, NHWC input run
NCHW, activations in ``compute_dtype``.  The strided 3×3 conv pads as
flax's ``"SAME"`` does (asymmetrically on an even input); the strided
1×1 shortcut has no padding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from geomx_tpu_torch.models.common import FlaxLikeModel, create_state


class ResNet(FlaxLikeModel):
    def __init__(self, num_classes: int = 10,
                 stage_sizes: Sequence[int] = (1, 1, 1), width: int = 32,
                 input_shape: Tuple[int, ...] = (1, 32, 32, 3),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(compute_dtype)
        self.conv("Conv_0", input_shape[-1], width, 3, bias=False)
        self.norm("GroupNorm_0", width)
        # (name, stride, projection shortcut) of each ResBlock
        self.blocks = []
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            feats = width * (2 ** i)
            for b in range(n_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                blk = f"ResBlock_{len(self.blocks)}"
                self.conv(f"{blk}.Conv_0", cin, feats, 3, bias=False)
                self.norm(f"{blk}.GroupNorm_0", feats)
                self.conv(f"{blk}.Conv_1", feats, feats, 3, bias=False)
                self.norm(f"{blk}.GroupNorm_1", feats)
                project = cin != feats or stride != 1
                if project:
                    self.conv(f"{blk}.Conv_2", cin, feats, 1, bias=False)
                self.blocks.append((blk, stride, project))
                cin = feats
        self.dense("Dense_0", cin, num_classes)

    def apply(self, params, x):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu(self._norm(params, "GroupNorm_0",
                              self._conv(params, "Conv_0", x)))
        for blk, stride, project in self.blocks:
            h = self._conv(params, f"{blk}.Conv_0", x, stride=stride)
            h = F.relu(self._norm(params, f"{blk}.GroupNorm_0", h))
            h = self._norm(params, f"{blk}.GroupNorm_1",
                           self._conv(params, f"{blk}.Conv_1", h))
            if project:
                x = self._conv(params, f"{blk}.Conv_2", x, stride=stride)
            x = F.relu(h + x)
        return self._dense(params, "Dense_0", x.mean((2, 3))).float()


def create_resnet_state(seed: int = 0,
                        input_shape: Tuple[int, ...] = (1, 32, 32, 3),
                        num_classes: int = 10,
                        stage_sizes: Sequence[int] = (1, 1, 1),
                        width: int = 32,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        device=None):
    """``(model, params, grad_fn)`` on ``device`` (CUDA unless
    ``"cpu"``), the params drawn from ``torch.Generator().manual_seed(
    seed)`` — the contract of ``create_cnn_state``."""
    model = ResNet(num_classes=num_classes, stage_sizes=tuple(stage_sizes),
                   width=width, input_shape=tuple(input_shape),
                   compute_dtype=compute_dtype)
    return create_state(model, seed, device)
