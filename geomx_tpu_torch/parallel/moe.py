"""Top-k routed MoE with capacity-bounded dispatch — the port of the JAX
package's ``parallel/moe.py``.

GShard/Switch-style routing: each token is computed by only its ``k``
chosen experts, bounded by a per-group expert capacity, so per-token
FLOPs do not depend on the expert count.  Dispatch and combine are
einsums over one-hot tensors, as in the JAX package (there, the form
GSPMD partitions); here they are ``torch.einsum`` on one device.

- Shapes are static: capacity ``C = ceil(S*k*cf/E)`` comes from static
  dims, tokens past capacity are dropped (GShard semantics), and no
  control flow depends on the data.
- Tokens route in groups (the leading batch dim): capacity is per group,
  which bounds the dispatch tensor at ``[G, S, E, C]``.
- Ties: ``lax.top_k`` puts the lower expert index first; so does the
  stable descending sort the top k is taken from here.
- Slot positions are counted in f32 (exact integers below 2**24) and
  become int64 only for ``one_hot``; the gradient flows through the
  gates (the top-k router probabilities) and the aux loss's mean
  probabilities, not through positions or one-hots.

With ``k = E`` and ``capacity = S`` the dispatch is total, so the layer
computes dense routing (every expert, combined by the softmax gates).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def expert_capacity(tokens_per_group: int, n_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Per-group per-expert slot count: ceil(S·k·cf / E), min 1."""
    return max(1, math.ceil(tokens_per_group * k * capacity_factor
                            / n_experts))


def topk_indices(probs: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k``'s choice along the last axis: the ``k`` largest,
    ties to the lower index (a stable descending sort), as int64."""
    return torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True).indices[..., :k]


def route(router_logits: torch.Tensor, k: int, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """:func:`topk_dispatch_combine`'s routing with the aux loss's two
    statistics in place of the loss: ``(dispatch, combine,
    frac_tokens [E], mean_prob [E])``, the means over this call's
    groups.  A data-parallel caller averages the statistics over its
    ranks before forming the loss, which is not linear in them."""
    G, S, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_idx = topk_indices(probs, k)                       # [G, S, k]
    gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(gate_idx, E).float()                 # [G, S, k, E]

    # position of each (token, choice) in its expert's queue, counted
    # choice-major: an exclusive cumsum over the flattened [k*S] order
    oh_km = onehot.transpose(1, 2)                          # [G, k, S, E]
    cum = torch.cumsum(oh_km.reshape(G, k * S, E), dim=1)
    pos = (cum.reshape(G, k, S, E) - oh_km).transpose(1, 2)  # [G, S, k, E]
    pos_in_expert = (pos * onehot).sum(-1)                  # exact, f32

    keep = (pos_in_expert < capacity).float()
    # one_hot of a position past capacity is all zeros, as jax's: one
    # extra class takes those, then goes
    over = pos_in_expert.clamp(max=capacity).long()
    loc = F.one_hot(over, capacity + 1)[..., :capacity].float()

    dispatch = torch.einsum("gske,gskc->gsec", onehot * keep[..., None], loc)
    combine = torch.einsum("gske,gskc->gsec",
                           onehot * (gate_vals * keep)[..., None], loc)

    first = F.one_hot(gate_idx[..., 0], E).float()
    return dispatch, combine, first.mean(dim=(0, 1)), probs.mean(dim=(0, 1))


def aux_loss(frac_tokens: torch.Tensor, mean_prob: torch.Tensor
             ) -> torch.Tensor:
    """The Switch load-balancing loss ``E · Σ_e frac_e · mean_prob_e``."""
    return frac_tokens.shape[0] * (frac_tokens * mean_prob).sum()


def topk_dispatch_combine(router_logits: torch.Tensor, k: int,
                          capacity: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Top-k routing tensors for grouped tokens.

    ``router_logits``: ``[G, S, E]`` (G groups of S tokens), taken in
    f32.  Returns ``(dispatch, combine, aux_loss)``:

    - ``dispatch`` ``[G, S, E, C]`` f32 in {0, 1} — token s of group g
      occupies slot c of expert e;
    - ``combine`` ``[G, S, E, C]`` f32 — dispatch times the token's
      gate for that expert (the top-k probabilities renormalised to sum
      to 1, the sum floored at 1e-9);
    - ``aux_loss`` scalar — the Switch load-balancing loss
      ``E · Σ_e frac_tokens_e · mean_prob_e`` over first choices.

    Priority is choice-major then token-major (all first choices claim
    slots before any second choice), as GShard's.
    """
    dispatch, combine, frac, mean_prob = route(router_logits, k, capacity)
    return dispatch, combine, aux_loss(frac, mean_prob)


def expert_ffn(x: torch.Tensor, dispatch: torch.Tensor,
               combine: torch.Tensor, we1: torch.Tensor, we2: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """The routed experts' FFN on ``x [G, S, D]``: dispatch, both expert
    products (tanh GELU between) and the combine in ``compute_dtype``,
    experts leading (``[E, G, C, D]``).  ``we1``/``we2`` and the expert
    dim of ``dispatch``/``combine`` may be a slice of the experts (an
    expert-parallel rank's); the result is then that slice's share."""
    cd = compute_dtype
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(cd), x.to(cd))
    up = F.gelu(torch.einsum("egcd,edf->egcf", xe, we1.to(cd)),
                approximate="tanh")
    ye = torch.einsum("egcf,efd->egcd", up, we2.to(cd))
    return torch.einsum("gsec,egcd->gsd", combine.to(cd), ye)


def moe_ffn_topk(x: torch.Tensor, router_w: torch.Tensor,
                 we1: torch.Tensor, we2: torch.Tensor, k: int,
                 capacity_factor: float = 1.25,
                 capacity: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN.

    ``x`` ``[G, S, D]``, ``router_w`` ``[D, E]``, ``we1`` ``[E, D, F]``,
    ``we2`` ``[E, F, D]``.  Router logits in f32, then
    :func:`expert_ffn`.  Returns ``(y [G, S, D] in compute_dtype,
    aux_loss)``.
    """
    G, S, D = x.shape
    E = router_w.shape[-1]
    if capacity is None:
        capacity = expert_capacity(S, E, k, capacity_factor)

    logits = torch.einsum("gsd,de->gse", x.float(), router_w)
    dispatch, combine, aux = topk_dispatch_combine(logits, k, capacity)
    y = expert_ffn(x, dispatch, combine, we1, we2, compute_dtype)
    return y.to(compute_dtype), aux
