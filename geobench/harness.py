"""Driving the port's in-process geo-round for one cell.

The harness stands up ``geomx_tpu_torch.kvstore.Simulation`` (every
server's merge, optimizer and codec stage on the run's device), starts
one thread a worker running the port's ``training.run_worker`` (FSA) or
``training.run_worker_hfa`` (HFA) once, for the whole run, and steers
the run through the workers' data iterators:

- every worker's ``r``-th batch comes from :mod:`geobench.traffic`;
- at a few steps every worker waits in ``next()`` until all have
  arrived, and the harness acts while the servers are quiet: it reads
  the global Adam's first moments after step 0, starts and stops the
  profiler around the traced rounds, and opens the timed window;
- a step's time is the interval between one worker's consecutive
  ``next()`` calls, so it holds the step's compute, its push, its wait
  for the pull and the next batch;
- the window closes ``seconds`` after it opened: the harness fixes the
  step at which every iterator ends (the furthest worker's next step,
  rounded up to whole HFA periods), so every worker runs the same number
  of steps and no FSA round waits on a worker that stopped.

The correctness check's readings of the program are taken on the way:
each worker's loss at the first ``check_steps`` steps, its weights at
step ``check_steps`` and worker 0's first gradient (a host copy, through
a wrapper of the port's ``grad_fn``), and the first gradient as the
optimizer took it (the global Adam's state under FSA, each worker's
local Adam's under HFA).
"""

from __future__ import annotations

import importlib
import math
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from geobench import traffic
from geobench.reference import weights

JOIN_S = 300.0


class RunError(RuntimeError):
    pass


class Gate:
    """The workers' iterators and the meeting points between them and
    the harness."""

    def __init__(self, n: int, meets, batch_fn, errors: list):
        self.n = n
        self.meets = set(meets)
        self.batch_fn = batch_fn
        self.errors = errors
        self.cv = threading.Condition()
        self.handed = [0] * n
        self.calls: List[List[float]] = [[] for _ in range(n)]
        self.arrived: Dict[int, int] = {}
        self.released: Dict[int, float] = {}
        self.stop: Optional[int] = None
        self.ended: List[Optional[float]] = [None] * n

    def next(self, w: int):
        with self.cv:
            s = self.handed[w]
            now = time.perf_counter()
            if self.stop is not None and s >= self.stop:
                self.calls[w].append(now)
                self.ended[w] = now
                self.cv.notify_all()
                raise StopIteration
            if s in self.meets:
                self.arrived[s] = self.arrived.get(s, 0) + 1
                self.cv.notify_all()
                while s not in self.released:
                    self.cv.wait(1.0)
                now = self.released[s]
            self.calls[w].append(now)
            self.handed[w] = s + 1
        return self.batch_fn(w, s)

    def wait_arrived(self, s: int, deadline: float):
        with self.cv:
            while self.arrived.get(s, 0) < self.n:
                if self.errors:
                    raise RunError(f"a worker failed before step {s}: "
                                   f"{self.errors[0]!r}") from self.errors[0]
                if time.monotonic() > deadline:
                    raise RunError(f"workers did not reach step {s} in time")
                self.cv.wait(0.5)

    def release(self, s: int) -> float:
        with self.cv:
            t = time.perf_counter()
            self.released[s] = t
            self.cv.notify_all()
            return t

    def set_stop(self, multiple: int, least: int = 0) -> int:
        with self.cv:
            top = max(max(self.handed), least)
            self.stop = -(-top // multiple) * multiple
            self.cv.notify_all()
            return self.stop


class _Iter:
    def __init__(self, gate: Gate, w: int):
        self.gate, self.w = gate, w

    def __iter__(self):
        return self

    def __next__(self):
        return self.gate.next(self.w)


def _window_measure():
    """The port's ``Measure`` with each phase's end time kept, so that
    the phases of the timed window can be told from the warm-up's."""
    from contextlib import contextmanager

    from geomx_tpu_torch.utils.measure import Measure

    class WindowMeasure(Measure):
        def __init__(self):
            super().__init__()
            self.ends: List[tuple] = []

        @contextmanager
        def phase(self, name: str):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                with self._mu:
                    self.ends.append((t1, name, t1 - t0))

    return WindowMeasure()


def _norms(d) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


class Readings:
    """What the correctness check reads of the program."""

    def __init__(self, n_workers: int):
        self.losses: Dict[int, list] = {w: [] for w in range(n_workers)}
        self.change: Dict[int, Dict[str, float]] = {}
        self.grad_norms = None          # FSA: one dict; HFA: by worker
        self.first_grad: Dict[str, object] = {}  # worker 0, step 0
        self.local_grad: Dict[int, Dict[str, float]] = {}


def _cell_steps(c: dict, trace: bool):
    loop = c["loop"]
    S = int(c["check_steps"])
    mult = int(c["hfa_k1"]) * int(c["hfa_k2"]) if loop == "hfa" else 1
    # the window opens on a whole HFA period; a traced run profiles the
    # rounds just before it, in place of the untraced run's warm rounds
    after = int(c["trace_rounds"] if trace else c["warm_steps"])
    window_at = -(-(S + after) // mult) * mult
    traced_at = window_at - int(c["trace_rounds"]) if trace else None
    return S, mult, window_at, traced_at


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             tmpdir: Optional[str] = None) -> dict:
    """One run of ``cell`` (a :class:`geobench.spec.Cell`); returns the
    window's numbers, the program's readings and, with ``trace``, the
    trace.  The Simulation is shut down and every thread joined before
    it returns."""
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.optim import local
    from geomx_tpu_torch.training import run_worker, run_worker_hfa

    family = importlib.import_module(
        f"geobench.families.{cell.config['family']}")
    c, cfg = cell.cell, cell.config
    topo = c["topology"]
    P, W = int(topo["parties"]), int(topo["workers_per_party"])
    n = P * W
    loop = c["loop"]
    S, mult, window_at, traced_at = _cell_steps(c, trace)
    comp = dict(c.get("compression", {"type": "none"}))
    batch = cell.batch

    params = weights.make(cfg, seed, device)
    names = list(params)
    grad_fn = family.grad_fn(cfg, device)
    readings = Readings(n)
    held: Dict[int, dict] = {}
    errors: list = []

    def batch_fn(w, s):
        return traffic.batch(cfg["inputs"], batch, seed, w, s)

    meets = {window_at} | ({1} if loop == "fsa" else set())
    if traced_at is not None:
        meets.add(traced_at)
    gate = Gate(n, meets, batch_fn, errors)

    def wrapped_grad(w):
        calls = [0]

        def gf(p, x, y):
            s = calls[0]
            calls[0] += 1
            loss, acc, grads = grad_fn(p, x, y)
            if s == 0 and w == 0:
                readings.first_grad = {k: g.detach().float().cpu()
                                       for k, g in grads.items()}
            if s < S:
                readings.losses[w].append(loss)
            elif s == S:
                # the loop never writes a params dict it has handed on:
                # hold this one, and take its norms after the window
                held[w] = p
            return loss, acc, grads
        return gf

    def local_opt(w):
        b1 = 0.9
        inner = local.adam(float(c["local_optimizer"]["lr"]), b1=b1)
        first = [True]

        def update(grads, state, p=None):
            out, st = inner.update(grads, state, p)
            if first[0]:
                first[0] = False
                readings.local_grad[w] = {
                    k: float((st["mu"][k].double() / (1 - b1)).norm())
                    for k in names}
            return out, st
        return local.GradientTransformation(inner.init, update)

    config = Config(
        topology=Topology(num_parties=P, workers_per_party=W,
                          num_global_servers=int(topo["global_servers"])),
        sync_global_mode=True,
        compression=comp["type"],
        merge_backend="torch:cpu" if device.type == "cpu" else "torch",
        use_hfa=loop == "hfa",
        hfa_k1=int(c.get("hfa_k1", 1)), hfa_k2=int(c.get("hfa_k2", 1)))
    sim = Simulation(config)
    measures = [_window_measure() for _ in range(n)]
    threads = []
    try:
        def worker_main(p, r, w):
            try:
                kv = sim.worker(p, r)
                if r == 0:
                    if p == 0:
                        kv.set_optimizer(dict(c["global_optimizer"]))
                    if comp["type"] != "none":
                        kv.set_gradient_compression(comp)
                kv.barrier()
                it = _Iter(gate, w)
                if loop == "fsa":
                    run_worker(kv, params, wrapped_grad(w), it, 1 << 40,
                               measure=measures[w])
                else:
                    run_worker_hfa(kv, params, wrapped_grad(w), it, 1 << 40,
                                   k1=int(c["hfa_k1"]),
                                   optimizer=local_opt(w),
                                   measure=measures[w])
            except BaseException as e:  # raised in the main thread
                errors.append(e)
                with gate.cv:
                    gate.cv.notify_all()

        for p in range(P):
            for r in range(W):
                t = threading.Thread(target=worker_main, args=(p, r, p * W + r),
                                     name=f"geobench-worker-{p}-{r}",
                                     daemon=True)
                t.start()
                threads.append(t)

        deadline = time.monotonic() + JOIN_S
        prof = None
        trace_path = None
        out: dict = {}
        for s in sorted(meets):
            gate.wait_arrived(s, deadline)
            if s == 1 and loop == "fsa":
                readings.grad_norms = _adam_first_grad(sim, names,
                                                         params)
            if s == traced_at:
                prof = _start_profiler(torch, device)
                _mark(torch, "geobench.traced_rounds.start")
            if s == window_at:
                if prof is not None:
                    _mark(torch, "geobench.traced_rounds.end")
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    prof.stop()
                    fd, trace_path = tempfile.mkstemp(
                        suffix=".json", prefix="geobench_trace_",
                        dir=tmpdir)
                    os.close(fd)
                    prof.export_chrome_trace(trace_path)
                    prof = None
                out["wan0"] = sim.wan_bytes()["wan_send_bytes"]
                out["bytes0"] = _server_bytes(sim)
                out["t0"] = gate.release(s)
                out["setup_end_wall"] = time.time()
                continue
            gate.release(s)

        end = out["t0"] + seconds
        while time.perf_counter() < end:
            if errors:
                raise RunError(f"a worker failed in the window: "
                               f"{errors[0]!r}") from errors[0]
            time.sleep(min(0.2, max(0.0, end - time.perf_counter())))
        # the check reads the weights each worker takes into step S
        stop = gate.set_stop(mult, least=S + 1)
        for t in threads:
            t.join(max(1.0, deadline - time.monotonic()))
        if errors:
            raise RunError(f"a worker failed: {errors[0]!r}") from errors[0]
        if any(t.is_alive() for t in threads):
            raise RunError("a worker did not finish its last step")
        t1 = max(gate.ended)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            out["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(device))
        out["wan1"] = sim.wan_bytes()["wan_send_bytes"]
        out["bytes1"] = _server_bytes(sim)
    finally:
        sim.shutdown()
        for t in threads:
            t.join(5.0)

    t0 = out["t0"]
    steps_in_window = stop - window_at
    step_times = []
    for w in range(n):
        ts = [t for t in gate.calls[w] if t >= t0]
        step_times.extend(b - a for a, b in zip(ts, ts[1:]))
    phases = {}
    for m in measures:
        for t_end, name, dt in m.ends:
            if t_end > t0:
                phases.setdefault(name, []).append(dt)
    readings.losses = {w: [float(x) for x in ls]
                       for w, ls in readings.losses.items()}
    readings.change = {w: _norms(OrderedDict((k, held[w][k] - params[k])
                                             for k in names))
                       for w in sorted(held)}
    held.clear()
    if loop == "hfa":
        readings.grad_norms = [readings.local_grad[w] for w in range(n)]
    return {
        "seconds": t1 - t0,
        "t0": t0,
        "setup_end_wall": out["setup_end_wall"],
        "worker_steps": steps_in_window * n,
        "rounds": steps_in_window,
        "samples": steps_in_window * n * batch,
        "step_times": step_times,
        "wan_bytes": out["wan1"] - out["wan0"],
        "server_bytes": out["bytes1"] - out["bytes0"],
        "phases": phases,
        "memory_peak_bytes": out.get("memory_peak_bytes"),
        "trace_path": trace_path,
        "traced_rounds": (window_at - traced_at) if trace else None,
        "readings": readings,
        "n_workers": n,
    }


def _adam_first_grad(sim, names, params) -> Dict[str, float]:
    """The gradient the global Adam took at step 0, per leaf: its first
    moment after one step over ``1 - beta1``, from the device optimizer
    stage or, where the server runs Adam on the host, from that.  A key
    with no state reads 0."""
    import torch

    from geomx_tpu_torch.kvstore.keys import encode_tensor

    gs = sim.global_servers[0]
    dev = gs._dev_opt
    if dev is not None:
        state, b1 = dev._st, float(dev.beta1)
    else:
        state = getattr(gs.optimizer, "state", {})
        b1 = float(getattr(gs.optimizer, "beta1", 0.9))
    out = {}
    for tid, n in enumerate(names):
        key = encode_tensor(tid, params[n].numel(), 1)[0].ps_key
        st = state.get(key)
        if st is None or "m" not in st:
            out[n] = 0.0
            continue
        m = torch.as_tensor(st["m"]).double()
        out[n] = float((m / (1 - b1)).norm())
    return out


def _server_bytes(sim) -> int:
    """Host↔device bytes every server's TorchBackend has counted: the
    merges' staging copies, the optimizer's host copies and the codec
    stage's compressed frames."""
    total = 0
    for s in list(sim.local_servers) + list(sim.global_servers):
        st = s._backend.stats()
        total += int(st.get("h2d_bytes", 0)) + int(st.get("d2h_bytes", 0))
        total += int(st.get("codec_d2h_bytes", 0))
    return total


def _start_profiler(torch, device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _mark(torch, name: str):
    with torch.profiler.record_function(name):
        pass


def quantile(xs: List[float], q: int) -> float:
    """The ``q``-th percentile, interpolated between order statistics
    (``statistics.quantiles(..., method='inclusive')``)."""
    ys = sorted(xs)
    if not ys:
        return math.nan
    pos = (len(ys) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(ys) - 1)
    return ys[lo] + (ys[hi] - ys[lo]) * (pos - lo)


def mean(xs) -> Optional[float]:
    xs = list(xs)
    return float(np.mean(xs)) if xs else None
