"""The batches of a cell, made from ``--seed`` alone.

One generator serves every configuration: the configuration's
``inputs`` block says what a sample is (``tokens``: a sequence of token
ids), the cell's file says nothing about the data.  Worker ``w``'s ``r``-th batch is a pure function
of ``(seed, w, r)``, so the program and the reference get the same rows,
every row differs from every other, and the harness can hand out batches
without holding them.

Tokens follow the port's synthetic LM corpus
(``geomx_tpu_torch/data/synthetic.py`` ``synthetic_lm``, copied here):
with probability ``order`` the next token is ``(5 * cur + 17) % vocab``,
else uniform, so a model's loss falls within a few steps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rng(seed: int, worker: int, step: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(worker), int(step)])


def lm_tokens(rng: np.random.Generator, n: int, seq: int, vocab: int,
              order: float) -> np.ndarray:
    """``[n, seq]`` int32 token ids of the affine chain (the port's
    ``synthetic_lm``, same draws in the same order)."""
    toks = np.empty((n, seq), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(1, seq):
        det = (5 * toks[:, t - 1] + 17) % vocab
        rand = rng.integers(0, vocab, size=n)
        toks[:, t] = np.where(rng.random(n) < order, det, rand)
    return toks


def batch(inputs: dict, batch_size: int, seed: int, worker: int,
          step: int) -> Tuple[np.ndarray, np.ndarray]:
    """Worker ``worker``'s batch for step ``step`` as host arrays ``(x,
    y)``, the pair the port's worker loops take."""
    rng = _rng(seed, worker, step)
    kind = inputs["kind"]
    if kind == "tokens":
        x = lm_tokens(rng, batch_size, int(inputs["seq"]),
                      int(inputs["vocab"]), float(inputs["order"]))
        return x, x
    raise ValueError(f"unknown input kind {kind!r}")
