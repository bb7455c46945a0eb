"""INT8 post-training quantization for inference — the port of the JAX
package's ``ops/int8.py``.

Weights are quantized ahead of time (symmetric per-output-column int8 +
f32 scales), activations dynamically per batch (symmetric per-tensor),
and the product runs int8 × int8 → int32 through ``torch._int_mm``
before it is dequantized into f32.  On CUDA that call wants more than
16 rows and K, N multiples of 8, so the operands are padded with zero
rows and columns (exact: a zero adds nothing to an integer sum) and the
result is cut back; nothing falls back to a float product.  ``round``
is half to even and ``x / scale`` one IEEE division, as in the JAX
package, so ``q``, ``scale`` and the logits equal its bit for bit.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def quantize_symmetric(x: torch.Tensor, axis=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: ``(q, scale)`` with ``x ≈ q *
    scale``.  ``axis`` keeps independent scales along the other axes
    (``axis=0`` on a ``[K, N]`` matrix: one scale per column, shape
    ``[1, N]``); None = one scale for the tensor (a 0-d scale)."""
    if axis is None:
        absmax = x.abs().amax()
    else:
        absmax = x.abs().amax(dim=axis, keepdim=True)
    # divide by a tensor: CUDA turns a division by a Python number into
    # a product with its reciprocal, which is not one IEEE division
    scale = torch.clamp(absmax, min=1e-8) / absmax.new_full((), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8`` in int32 through
    ``torch._int_mm``, padded to its CUDA shape rules (M > 16; K, N
    multiples of 8) with zeros and cut back to ``[M, N]``."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(_round_up(M, 8), 24), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp, Np) != (M, K, N):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
        b = F.pad(b, (0, Np - N, 0, Kp - K))
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor
                ) -> torch.Tensor:
    """``x @ w`` with dynamically quantized activations.

    ``x`` ``[..., K]`` float; ``w_q`` ``[K, N]`` int8 with per-column
    scales ``w_scale`` ``[1, N]``.  Accumulates in int32, dequantizes
    with the product of both scales (``acc * x_scale * w_scale``, in
    that order)."""
    x_q, x_scale = quantize_symmetric(x)
    lead = x.shape[:-1]
    acc = _int_mm(x_q.reshape(-1, x.shape[-1]), w_q)
    return (acc.float() * x_scale * w_scale).reshape(*lead, w_q.shape[1])


def quantize_dense_tree(params: Dict[str, torch.Tensor]) -> "OrderedDict":
    """Post-training quantization of a port param dict: every 2-D leaf
    (a Dense ``weight``, torch's ``[out, in]``) becomes ``{"q": int8 [in,
    out], "scale": f32 [1, out]}`` — the JAX package's per-column
    quantization of the flax ``[in, out]`` kernel, so both hold the same
    numbers; the other leaves are kept."""
    out = OrderedDict()
    for name, leaf in params.items():
        if leaf.ndim == 2:
            q, scale = quantize_symmetric(leaf.detach().t(), axis=0)
            out[name] = {"q": q, "scale": scale}
        else:
            out[name] = leaf
    return out


def make_quantized_mlp_apply():
    """Quantized-inference forward for the zoo MLP: flatten, then every
    ``Dense_i`` through :func:`int8_matmul` (+ its f32 bias), ReLU
    between.  Usage::

        model, params, _ = create_mlp_state(seed, device=...)
        logits = make_quantized_mlp_apply()(quantize_dense_tree(params), x)
    """

    def apply(qparams, x):
        n = sum(1 for name in qparams if name.endswith(".weight"))
        x = x.reshape(x.shape[0], -1).float()
        for i in range(n):
            w = qparams[f"Dense_{i}.weight"]
            x = int8_matmul(x, w["q"], w["scale"])
            x = x + qparams[f"Dense_{i}.bias"].float()
            if i < n - 1:
                x = torch.relu(x)
        return x

    return apply
