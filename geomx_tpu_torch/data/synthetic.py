"""Synthetic datasets + sharded iteration.

The reference trains on MNIST fetched at runtime (ref: examples/cnn.py:49
mx.test_utils.get_mnist); this environment has no egress, so the stand-in
is a class-template image dataset with additive noise — learnable by the
same CNN in a few steps, which is all the acceptance tests need
(correctness oracle = "accuracy/loss curve matches vanilla", SURVEY.md §4).

``ShardedIterator`` reproduces the reference's per-worker data sharding
(ref: examples/cnn.py:49 splits by num_all_workers/worker rank).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def synthetic_classification(
    n: int = 2048,
    shape: Tuple[int, ...] = (28, 28, 1),
    num_classes: int = 10,
    noise: float = 0.35,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Images = class template + gaussian noise; labels = class id."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((num_classes, *shape)).astype(np.float32)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = templates[y] + noise * rng.standard_normal((n, *shape)).astype(np.float32)
    return x, y


def synthetic_lm(
    n: int = 2048,
    seq: int = 64,
    vocab: int = 256,
    order: float = 0.85,
    seed: int = 0,
) -> np.ndarray:
    """Token sequences from a low-entropy affine chain: with probability
    ``order`` the next token is ``(5*cur + 17) % vocab``, else uniform —
    an LM can cut its loss well below ``log(vocab)`` within a few steps,
    which is all the e2e acceptance needs (same oracle philosophy as
    ``synthetic_classification``).  Returns int32 [n, seq]."""
    rng = np.random.default_rng(seed)
    toks = np.empty((n, seq), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(1, seq):
        det = (5 * toks[:, t - 1] + 17) % vocab
        rand = rng.integers(0, vocab, size=n)
        toks[:, t] = np.where(rng.random(n) < order, det, rand)
    return toks


class TokenIterator:
    """Sharded batch iterator over token sequences; yields ``(tokens,
    tokens)`` pairs so the generic worker loops (which expect (x, y))
    work unchanged — the LM objective ignores y."""

    def __init__(self, tokens: np.ndarray, batch_size: int,
                 worker_index: int = 0, num_workers: int = 1, seed: int = 0):
        self.tokens = tokens[worker_index::num_workers]
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed + worker_index)

    def __iter__(self):
        return self

    def __next__(self):
        idx = self._rng.integers(0, len(self.tokens), size=self.batch_size)
        batch = self.tokens[idx]
        return batch, batch


class ShardedIterator:
    """Round-robin shard of a dataset for one worker among
    ``num_all_workers`` (global worker index orders shards)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 worker_index: int = 0, num_workers: int = 1, seed: int = 0):
        self.x = x[worker_index::num_workers]
        self.y = y[worker_index::num_workers]
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed + worker_index)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self):
        idx = self._rng.integers(0, len(self.x), size=self.batch_size)
        return self.x[idx], self.y[idx]
