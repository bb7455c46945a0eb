"""The geo-round in plain PyTorch: what the port's Simulation computes for
a cell's first steps, worked out again from the same weights and batches.

Topology: ``parties`` × ``workers_per_party`` workers, one global
server.  FSA, every step:

1. every worker takes the loss and gradients of its batch at its party's
   weights, scaled by ``1 / workers_per_party``;
2. each party sums its workers' scaled gradients (the local merge);
3. the party's push codec encodes each key for the WAN (``none``;
   ``fp16``; ``bsc``: DGC momentum and accumulation, exact top-k of the accumulation at ratio
   ``ratio``, the sent entries cleared; ``mpq``: fp16 below
   ``size_bound`` elements, ``bsc`` from it on) and the global server
   decodes it;
4. the global server sums the parties' decoded gradients, scales the
   sum by ``1 / parties`` and takes an Adam step (bias-corrected, eps
   outside the root, no weight decay);
5. each party pulls the new weights: dense float32, except under
   ``bsc`` and ``mpq``, where a key of ``size_bound`` elements or more
   comes as the sampled top-k of its change since the party's last view
   (the pull half of Bi-Sparse: a threshold at the ``1 - ratio`` quantile
   of a 0.5 % sample of the change's magnitudes, every entry at or above
   it sent, the largest ``2 * ratio`` of the key where more pass, at
   least the largest one) and a smaller key under ``mpq`` as fp16 weights.

HFA: every worker takes local Adam steps on its own weights; every
``k1`` steps each party averages its workers' weights; every ``k2``-th
such sync the party sends ``(mean - milestone) / parties`` to the global
server, which adds the parties' deltas to its weights, and every worker
of every party continues from those (the new milestone).

The pull's sampled threshold draws from its own generator (``pull_seed``,
the program's seed by default), so its sample (and with it the few
entries at the threshold) differs from the program's, whose draws
follow the order in which pulls reach its global server; everything
else is the same arithmetic.  ``sampled`` in the result names the leaves
pulled that way.

Faults for the correctness control, planted here in place of the
program: ``half_batch`` (each worker's gradient from the first half of
its batch), ``no_exchange`` (the global update from party 0 alone) and
``altered_gradient`` (worker 0's gradient of the largest leaf doubled).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from geobench import traffic
from geobench.reference import transformer as ref_transformer
from geobench.reference import weights
from geobench.reference.precision import no_tf32

FAULTS = ("half_batch", "no_exchange", "altered_gradient")


def _f32(x: float) -> float:
    return float(np.float32(x))


class _Model:
    """One configuration's loss and gradients on one worker's batch."""

    def __init__(self, config: dict, cell: dict, seed: int, device,
                 precision: str, fault: Optional[str]):
        self.config, self.cell, self.seed = config, cell, seed
        self.device, self.precision, self.fault = device, precision, fault
        self.batch = int(cell.get("batch_per_worker",
                                  config["batch_per_worker"]))
        self.rows = int(config.get("reference_rows", self.batch))

    def grads(self, params, worker: int, step: int):
        x, _ = traffic.batch(self.config["inputs"], self.batch, self.seed,
                             worker, step)
        if self.fault == "half_batch":
            x = x[:len(x) // 2]
        tok = torch.as_tensor(x, device=self.device).long()
        loss, g = ref_transformer.loss_and_grads(
            params, tok, self.config["model"], self.precision, self.rows)
        if self.fault == "altered_gradient" and worker == 0:
            big = max(g, key=lambda n: g[n].numel())
            g[big] = g[big] * 2.0
        return loss, g


class _PushCodec:
    """One party's push codec, per key."""

    def __init__(self, comp: dict):
        self.comp = comp
        self.state: Dict[str, tuple] = {}

    def kind(self, n: int) -> str:
        typ = self.comp.get("type", "none")
        if typ == "mpq":
            return "bsc" if n >= int(self.comp["size_bound"]) else "fp16"
        return typ

    def __call__(self, name: str, g: torch.Tensor) -> torch.Tensor:
        flat = g.reshape(-1)
        n = flat.numel()
        kind = self.kind(n)
        if kind == "none":
            return flat.clone()
        if kind == "fp16":
            return flat.half().float()
        if kind == "bsc":
            mom = _f32(self.comp.get("momentum", 0.9))
            v, u = self.state.get(name, (torch.zeros_like(flat),
                                         torch.zeros_like(flat)))
            v = v * mom + flat
            u = u + v
            k = max(1, int(float(self.comp.get("ratio", 0.01)) * n))
            idx = torch.topk(u.abs(), k).indices
            out = torch.zeros_like(u)
            out[idx] = u[idx]
            v = v.clone()
            u = u.clone()
            v[idx] = 0.0
            u[idx] = 0.0
            self.state[name] = (v, u)
            return out
        raise ValueError(f"unknown compression {kind!r}")


class _PullCodec:
    """The global server's pull compression, one view per key (every
    party's view of a key moves by the same deltas under FSA)."""

    def __init__(self, comp: dict, init: Dict[str, torch.Tensor],
                 seed: int = 1234):
        self.comp = comp
        self.typ = comp.get("type", "none")
        self.ratio = float(comp.get("ratio", 0.01))
        self.view = {n: t.reshape(-1).clone() for n, t in init.items()}
        self.rng = np.random.default_rng(seed)
        self.sampled = [n for n, t in init.items()
                        if self.kind(t.numel()) == "sampled"]

    def kind(self, n: int) -> str:
        if self.typ == "fp16" or (self.typ == "mpq"
                                  and n < int(self.comp["size_bound"])):
            return "fp16"
        return "sampled" if self.typ in ("bsc", "mpq") else "dense"

    def __call__(self, name: str, w: torch.Tensor) -> torch.Tensor:
        flat = w.reshape(-1)
        n = flat.numel()
        kind = self.kind(n)
        if kind == "fp16":
            return flat.half().float().view_as(w)
        if kind == "dense":
            return w.clone()
        delta = flat - self.view[name]
        sample_n = max(int(n * 0.005), min(n, 64))
        pick = torch.as_tensor(self.rng.integers(0, n, size=sample_n),
                               device=flat.device)
        sample = delta[pick].abs().cpu().numpy()
        thr = float(np.quantile(sample, max(0.0, 1.0 - self.ratio)))
        cap = max(1, int(2 * self.ratio * n))
        mag = delta.abs()
        idx = torch.nonzero(mag >= thr).reshape(-1)
        if idx.numel() == 0:
            idx = mag.argmax().reshape(1)
        elif idx.numel() > cap:
            idx = idx[torch.topk(mag[idx], cap).indices]
        view = self.view[name]
        view[idx] += delta[idx]
        return view.clone().view_as(w)


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` rounded once (a 0-dim divisor: CUDA turns a division
    by a host scalar into a product with its reciprocal)."""
    return t / torch.full((), _f32(c), dtype=t.dtype, device=t.device)


def _adam_step(w, g, st, lr, b1=0.9, b2=0.999, eps=1e-8):
    st["t"] += 1
    st["m"] = st["m"] * _f32(b1) + g * _f32(1 - b1)
    st["v"] = st["v"] * _f32(b2) + (g * _f32(1 - b2)) * g
    mhat = _div(st["m"], 1 - b1 ** st["t"])
    vhat = _div(st["v"], 1 - b2 ** st["t"])
    return w - (mhat * _f32(lr)) / (torch.sqrt(vhat) + _f32(eps))


def _local_adam(p, g, st, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax's ``adam`` (the port's ``optim/local.py`` order)."""
    st["count"] += 1
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(st["count"]))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(st["count"]))
    out = OrderedDict()
    for n in p:
        st["mu"][n] = g[n] * (1 - b1) + st["mu"][n] * b1
        st["nu"][n] = (g[n] * g[n]) * (1 - b2) + st["nu"][n] * b2
        out[n] = p[n] + ((st["mu"][n] / c1)
                         / (torch.sqrt(st["nu"][n] / c2) + eps) * -lr)
    return out


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


def run(config: dict, cell: dict, seed: int, device, steps: int,
        precision: str = "f32", fault: Optional[str] = None,
        pull_seed: int = 1234) -> dict:
    """Follow the cell's first ``steps`` steps.  Returns ``losses``
    (``[step][worker]``), ``grad_norms`` (the first gradient as the
    optimizer takes it, per leaf: FSA the global Adam's, one dict; HFA
    each worker's local Adam's, a list), ``change_norms`` (per worker,
    per leaf, ``|w_steps - w_0|``), ``first_grad`` (worker 0's
    gradient at step 0, host tensors) and ``sampled`` (the leaves whose
    pull is a sampled top-k, its generator seeded with ``pull_seed``)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    with no_tf32():
        return _run(config, cell, seed, device, steps, precision, fault,
                    pull_seed)


def _run(config, cell, seed, device, steps, precision, fault, pull_seed):
    topo = cell["topology"]
    P, W = int(topo["parties"]), int(topo["workers_per_party"])
    model = _Model(config, cell, seed, device, precision, fault)
    w0 = weights.make(config, seed, device)
    names = list(w0)
    losses: List[List[float]] = []
    if cell["loop"] == "fsa":
        comp = cell.get("compression", {"type": "none"})
        lr = float(cell["global_optimizer"]["lr"])
        G = OrderedDict((n, t.clone()) for n, t in w0.items())
        party_w = [OrderedDict((n, t.clone()) for n, t in w0.items())
                   for _ in range(P)]
        push = [_PushCodec(comp) for _ in range(P)]
        pull = _PullCodec(comp, w0, pull_seed)
        opt = {n: {"m": torch.zeros_like(t), "v": torch.zeros_like(t),
                   "t": 0} for n, t in w0.items()}
        grad_norms = None
        for s in range(steps):
            row, dec = [], []
            for p in range(P):
                acc = None
                for j in range(W):
                    loss, g = model.grads(party_w[p], p * W + j, s)
                    row.append(loss)
                    if s == 0 and p * W + j == 0:
                        first = {n: t.cpu() for n, t in g.items()}
                    g = {n: g[n] * _f32(1.0 / W) for n in names}
                    acc = g if acc is None else {n: acc[n] + g[n]
                                                 for n in names}
                dec.append({n: push[p](n, acc[n]).view_as(acc[n])
                            for n in names})
            losses.append(row)
            parts = dec[:1] if fault == "no_exchange" else dec
            scale = _f32(1.0 / len(parts))
            step_g = {}
            for n in names:
                tot = parts[0][n]
                for d in parts[1:]:
                    tot = tot + d[n]
                step_g[n] = tot * scale
                G[n] = _adam_step(G[n], step_g[n], opt[n], lr)
            if s == 0:
                grad_norms = _norms(step_g)
            new = OrderedDict((n, pull(n, G[n])) for n in names)
            party_w = [new] * P
        final = [party_w[p] for p in range(P) for _ in range(W)]
        sampled = pull.sampled
    else:
        lr = float(cell["local_optimizer"]["lr"])
        k1, k2 = int(cell["hfa_k1"]), int(cell["hfa_k2"])
        G = OrderedDict((n, t.clone()) for n, t in w0.items())
        ws = [OrderedDict((n, t.clone()) for n, t in w0.items())
              for _ in range(P * W)]
        st = [{"count": 0,
               "mu": OrderedDict((n, torch.zeros_like(t))
                                 for n, t in w0.items()),
               "nu": OrderedDict((n, torch.zeros_like(t))
                                 for n, t in w0.items())}
              for _ in range(P * W)]
        milestone = [G] * P
        grad_norms, syncs = [], 0
        for s in range(steps):
            row = []
            for i in range(P * W):
                loss, g = model.grads(ws[i], i, s)
                row.append(loss)
                if s == 0:
                    grad_norms.append(_norms(g))
                    if i == 0:
                        first = {n: t.cpu() for n, t in g.items()}
                ws[i] = _local_adam(ws[i], g, st[i], lr)
            losses.append(row)
            if (s + 1) % k1:
                continue
            syncs += 1
            means = []
            for p in range(P):
                mean = None
                for j in range(W):
                    part = {n: ws[p * W + j][n] / W for n in names}
                    mean = part if mean is None else {n: mean[n] + part[n]
                                                      for n in names}
                means.append(mean)
            if syncs % k2:
                for p in range(P):
                    for j in range(W):
                        ws[p * W + j] = OrderedDict(
                            (n, means[p][n].clone()) for n in names)
                continue
            deltas = [{n: (means[p][n] - milestone[p][n]) / P
                       for n in names} for p in range(P)]
            if fault == "no_exchange":
                deltas = [{n: deltas[0][n] * P for n in names}]
            G = OrderedDict()
            for n in names:
                tot = deltas[0][n]
                for d in deltas[1:]:
                    tot = tot + d[n]
                G[n] = milestone[0][n] + tot
            milestone = [G] * P
            ws = [OrderedDict((n, t.clone()) for n, t in G.items())
                  for _ in range(P * W)]
        final = ws
        sampled = []
    change = [_norms({n: f[n] - w0[n] for n in names}) for f in final]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "first_grad": first,
            "sampled": sampled}
