"""Kernels: the hand codec kernels' share of their roofline in the
traced rounds (all three are bound by HBM bandwidth): the bytes the
rounds' calls need over the bandwidth, over those kernels' device time.
Each party encodes every key its codec sends by BSC through the DGC
update kernel once a round; read only where the trace holds exactly
that many launches."""

import math

from geobench.flops.codec import kernel_kind, nbytes
from geobench.reference.weights import leaves


def _calls(run):
    comp = run.cell.cell.get("compression", {"type": "none"})
    typ = comp["type"]
    sizes = [math.prod(s) for _, s, _ in leaves(run.cell.config)]
    if typ == "mpq":
        bsc = [n for n in sizes if n >= int(comp["size_bound"])]
        return {"dgc_update": bsc}
    if typ == "bsc":
        return {"dgc_update": sizes}
    return {}


def read(run):
    tr, peaks = run.trace, run.peaks
    if tr is None or not peaks:
        return None
    per_round = _calls(run)
    if not per_round:
        return None
    parties = int(run.cell.cell["topology"]["parties"])
    reps = tr.rounds * parties
    need = 0
    for kind, ns in per_round.items():
        if tr.count(lambda n, k=kind: kernel_kind(n) == k) != reps * len(ns):
            return None
        need += reps * sum(nbytes(kind, n) for n in ns)
    us = tr.device_us(lambda n: kernel_kind(n) in per_round)
    if us <= 0:
        return None
    return 100.0 * need / peaks["hbm_bytes_per_s"] / (us / 1e6)
