"""The comparison that decides ``correct``: the program's readings of a
cell's first steps against the plain reference's.

Each number is held to a limit from the cell's file:

- ``loss_gap``: the largest relative gap between a worker's loss and the
  reference's, over every worker and every checked step;
- ``grad_norm_gap``: over the leaves (and, under HFA, the workers), the
  largest gap between the norm of the first gradient as the optimizer
  took it in the program and in the reference, over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same reading of the norm of each worker's weight
  change over the checked steps, over the leaves whose pull is exact
  (dense, or fp16 under MPQ: every leaf where the pull does not sample);
- ``change_gap_sampled``: the same over the leaves whose pull is a
  sampled top-k (BSC, and MPQ's large keys), with the median of those
  leaves; read only where the cell's pull samples.  The sample's
  threshold draws from a generator whose draws follow the order in which
  pulls reach the program's global server, so these leaves' changes
  differ from the reference's by more than rounding (``PERF.md``), and
  the two groups have limits of their own;
- ``grad_diff``: worker 0's first gradient, as its model step produced
  it, against the reference's: per leaf the norm of their difference
  over the reference's norm of that leaf or of the median leaf,
  whichever is larger, the largest over the leaves.  The numbers above
  compare norms, in which rounding noise cancels to second order, so a
  step computed in fp8 reads on them little above one in bf16; this one
  reads the noise itself, and covers the model step with its kernels.

A leaf whose reference gradient is zero, or under a thousandth of the
median moved leaf's, moves by round-off alone and is left out (the
change's leaves by the reference's first gradient).  A number that is
not finite fails.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

NUMBERS = ("loss_gap", "grad_norm_gap", "change_gap", "change_gap_sampled",
           "grad_diff")


def _kept(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves the reference moves: a gradient norm above zero and
    at least a thousandth of the median nonzero leaf's."""
    moved = [v for v in ref_grad.values() if v > 0]
    if not moved:
        return []
    med = float(np.median(moved))
    return [n for n, v in ref_grad.items() if v > 0 and v >= 1e-3 * med]


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float],
              kept: List[str]) -> float:
    if not kept:
        return math.inf
    med = float(np.median([ref[n] for n in kept]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in kept)


def _diffs(prog: dict, ref: dict) -> Dict[str, float]:
    """Per kept leaf, ``|g_prog - g_ref|`` over the larger of the leaf's
    reference norm and the median leaf's."""
    if not prog or set(prog) != set(ref):
        return {}
    norms = {n: float(ref[n].double().norm()) for n in ref}
    kept = _kept(norms)
    if not kept:
        return {}
    med = float(np.median([norms[n] for n in kept]))
    return {n: float((prog[n].double() - ref[n].double()).norm())
            / max(norms[n], med) for n in kept}


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: ``losses`` ``{worker: [loss by step]}``, ``grad_norms``
    (a dict, or a list by worker), ``change`` ``{worker: {leaf:
    norm}}``, ``first_grad`` (worker 0's, ``{leaf: tensor}``).  ``ref``:
    :func:`geobench.reference.georound.run`'s.  Returns the cell's
    numbers: :data:`NUMBERS`, ``change_gap_sampled`` only where the
    reference's pull samples some leaf."""
    sampled = set(ref.get("sampled", ()))
    names = (["change_gap_sampled"] if sampled else []) + [
        k for k in NUMBERS if k != "change_gap_sampled"]
    loss_gap = 0.0
    for w, ls in prog["losses"].items():
        if len(ls) != len(ref["losses"]):
            return {k: math.inf for k in names}
        for s, row in enumerate(ref["losses"]):
            loss_gap = max(loss_gap, abs(ls[s] - row[w]) / abs(row[w]))
    ref_g = ref["grad_norms"]
    prog_g = prog["grad_norms"]
    if isinstance(ref_g, dict):
        ref_g, prog_g = [ref_g], [prog_g]
    grad_gap = max(_norm_gap(p, r, _kept(r)) for p, r in zip(prog_g, ref_g))
    kept = _kept(ref_g[0])
    groups = {"change_gap": [n for n in kept if n not in sampled],
              "change_gap_sampled": [n for n in kept if n in sampled]}
    out = {"loss_gap": loss_gap, "grad_norm_gap": grad_gap}
    for k, leaves in groups.items():
        if k in names:
            out[k] = max(_norm_gap(prog["change"][w], ref["change_norms"][w],
                                   leaves)
                         for w in range(len(ref["change_norms"])))
    d = _diffs(prog["first_grad"], ref["first_grad"])
    out["grad_diff"] = max(d.values()) if d else math.inf
    return {k: (out[k] if math.isfinite(out[k]) else math.inf)
            for k in NUMBERS if k in names}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit from the cell's file, and a limit
    for every number and a number for every limit."""
    return set(numbers) == set(limits) and all(
        numbers[k] <= float(limits[k]) for k in numbers)
