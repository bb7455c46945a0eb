"""Model FLOPs of one training sample (forward and backward) of the
GPT-style LM, counted from its shapes with nothing recomputed.

6 · N · T for the matrix products of the ``N`` weights that multiply
every token (each layer's q, k, v, o, MLP in and out, and the tied
head's ``vocab × d_model``; the token and position lookups multiply
nothing), plus causal attention: the two products ``Q Kᵀ`` and ``P V``
are ``2 · 2 · T · d_model`` operations per token and layer over the
full square, half of it under the causal mask, times 3 for forward and
backward: ``6 · n_layers · T² · d_model`` a sequence.
"""

from __future__ import annotations


def sample_flops(model: dict) -> float:
    D, F, V, T, L = (model["d_model"], model["d_ff"], model["vocab"],
                     model["max_seq"], model["n_layers"])
    n_matmul = L * (4 * D * D + 2 * D * F) + V * D
    return 6.0 * n_matmul * T + 6.0 * L * T * T * D
