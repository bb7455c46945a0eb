"""Plain float32 GPT-style LM: the loss and the gradients of the port's
``models/transformer.py`` equations, written from them and not from its
code.

Token and learned position embeddings, ``n_layers`` blocks of RMSNorm →
causal softmax attention → residual → RMSNorm → tanh-GELU MLP →
residual, a final RMSNorm and the head tied to the token embedding;
next-token cross-entropy averaged over every predicted position.
Attention is formed as full score matrices with a causal mask.  The
batch runs in blocks of rows (``rows``) so that the scores of a
1024-token sequence fit, and the blocks' losses and gradients are
summed with the weight of their share of the positions.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from geobench.reference.precision import Arith


def _rms(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def _forward_loss(p: Dict[str, torch.Tensor], tok: torch.Tensor, m: dict,
                  ar: Arith) -> torch.Tensor:
    """Summed (not averaged) next-token cross-entropy of one block."""
    b, T = tok.shape
    D, H = m["d_model"], m["n_heads"]
    Dh = D // H
    x = p["embed"][tok] + p["pos"][:T][None]
    mask = torch.ones(T, T, dtype=torch.bool, device=tok.device).triu(1)
    for i in range(m["n_layers"]):
        lp = {n: p[f"layers.{i}.{n}"] for n in
              ("ln1", "ln2", "w1", "w2", "wk", "wo", "wq", "wv")}
        h = _rms(x, lp["ln1"]).reshape(b * T, D)

        def heads(w):
            return ar.matmul(h, w.reshape(D, H * Dh)).view(
                b, T, H, Dh).transpose(1, 2)

        q, k, v = heads(lp["wq"]), heads(lp["wk"]), heads(lp["wv"])
        s = ar.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
        a = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        o = ar.matmul(a, v).transpose(1, 2).reshape(b * T, H * Dh)
        x = x + ar.matmul(o, lp["wo"].reshape(H * Dh, D)).view(b, T, D)
        h = _rms(x, lp["ln2"]).reshape(b * T, D)
        u = F.gelu(ar.matmul(h, lp["w1"]), approximate="tanh")
        x = x + ar.matmul(u, lp["w2"]).view(b, T, D)
    h = _rms(x, p["ln_f"]).reshape(b * T, D)
    logits = ar.matmul(h, p["embed"].t()).view(b, T, -1)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tok[:, 1:, None].long()).sum()


def loss_and_grads(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   model: dict, precision: str = "f32", rows: int = 2
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """``(loss, grads)`` of the batch ``tokens`` ``[B, T]``: the loss as
    a Python float, the gradients as float32 tensors keyed like
    ``params``."""
    ar = Arith(precision)
    p = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    B, T = tokens.shape
    count = B * (T - 1)
    total = 0.0
    grads = None
    for r in range(0, B, rows):
        lsum = _forward_loss(p, tokens[r:r + rows], model, ar)
        g = torch.autograd.grad(lsum / count, list(p.values()))
        grads = list(g) if grads is None else [a + b for a, b in
                                               zip(grads, g)]
        total += float(lsum.detach())
    return total / count, dict(zip(p, grads))
