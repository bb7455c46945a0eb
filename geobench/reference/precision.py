"""The arithmetic of the reference's products, in one of two precisions.

``f32``: plain float32 products with TF32 switched off, the reference
itself.  ``fp8``: the correctness control, the step below the bf16 that
the configurations state.  Each operand of a product (and, in the
backward pass, the incoming gradient) is rounded to float8 with one
scale per tensor, as fp8 training recipes round them (e4m3 for the
forward operands, e5m2 for gradients), and the product is then formed
in float32.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "fp8")


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _q(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one per-tensor scale, back in
    float32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().max()
    if amax == 0 or not torch.isfinite(amax):
        return x
    s = amax / top
    return (x / s).to(dtype).float() * s


def q_fwd(x):
    return _q(x, torch.float8_e4m3fn)


def q_grad(x):
    return _q(x, torch.float8_e5m2)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = q_fwd(a), q_fwd(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = q_grad(g)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


class Arith:
    """The products of one precision: ``matmul`` (batched, last two
    dims)."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def matmul(self, a, b):
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)
