"""Compute/communication overlap: the staged (P3-style) worker loop.

The counterpart of the JAX package's ``overlap.py``.  The reference's
defining perf mechanism is that every kvstore push/pull is a
dependency-engine op with a per-layer priority, so round-r communication
overlaps round-r(+1) compute: layer-N's push starts the moment its
gradient exists mid-backward, and next-step forward begins as soon as
shallow layers' pulls land (ref: include/mxnet/engine.h:153-263
PushAsync w/ priority; kvstore_dist.h:355-363 P3 fake pull;
threadsafe_queue.h:49-58 priority send queue).

The model is split into **stages**, each a function
``(stage_params, x) -> x`` of an ordered dict of tensors, chained from
Python:

- **forward walk**: stage *i* blocks only on *its own* pulled params, so
  shallow stages compute while deep params are still crossing the WAN;
  each stage runs under ``torch.no_grad()`` and keeps only its input
  (no autograd graph is held across stages);
- **backward walk**: stage *i*'s forward is recomputed with grad enabled
  (rematerialization) and its gradient is pushed the instant
  ``torch.autograd.grad`` returns, so the uplink transmits deep grads
  while shallow stages are still computing, and under P3's priority
  queue shallow grads jump any queued deep slices at the end of
  backward.

Gradients equal those of autograd through the composed stages: chained
vector-Jacobian products are the chain rule.

Key ids are assigned stage-major, in each stage dict's key order, which
must be sorted (the JAX package's ``tree_flatten`` order): key ids, P3
priorities (``priority=-tid``) and WAN frames then agree between the two
packages.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geomx_tpu_torch.kvstore.client import WorkerKVStore
from geomx_tpu_torch.training import step_order


def _stage_fwd(f: Callable) -> Callable:
    def fwd(p, x):
        with torch.no_grad():
            return f(p, x)

    return fwd


def _stage_bwd(f: Callable) -> Callable:
    """``(params, x_in, g_out) -> (g_params, g_x_in)``: recompute the
    stage on fresh leaves and take the vector-Jacobian product.  An
    integer input (token ids) gets no gradient (``None``)."""

    def bwd(p, x, g):
        with torch.enable_grad():
            leaves = OrderedDict((n, t.detach().requires_grad_(True))
                                 for n, t in p.items())
            x_in = x.detach()
            diff_x = x_in.is_floating_point()
            if diff_x:
                x_in.requires_grad_(True)
            out = f(leaves, x_in)
            inputs = list(leaves.values()) + ([x_in] if diff_x else [])
            grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
        # a leaf the stage does not read has a zero gradient
        g_params = OrderedDict(
            (n, torch.zeros_like(t) if gr is None else gr)
            for (n, t), gr in zip(leaves.items(), grads))
        g_x = grads[-1] if diff_x else None
        return g_params, g_x

    return bwd


class StagedModel:
    """A model split into forward/backward segments.

    ``stage_fns[i]`` is a function ``(stage_params, x) -> x`` of an
    ordered dict of tensors; the last stage's output feeds
    ``loss_fn(logits, y) -> (loss, aux)`` (aux is typically accuracy).
    Gradients of the chained stages equal autograd through the composed
    stages.

    ``_fwd[i]``, ``_bwd[i]`` and ``_loss_grad`` are the per-stage
    callables the walks call; a caller may wrap them (the benchmark
    below adds modeled compute time)."""

    def __init__(self, stage_fns: Sequence[Callable], loss_fn: Callable):
        self.stage_fns = list(stage_fns)
        self.n = len(self.stage_fns)
        self._fwd = [_stage_fwd(f) for f in self.stage_fns]
        self._bwd = [_stage_bwd(f) for f in self.stage_fns]

        def _loss_grad(logits, y):
            with torch.enable_grad():
                leaf = logits.detach().requires_grad_(True)
                loss, aux = loss_fn(leaf, y)
                (g,) = torch.autograd.grad(loss, [leaf])
            if isinstance(aux, torch.Tensor):
                aux = aux.detach()
            return loss.detach(), aux, g

        self._loss_grad = _loss_grad

    def forward(self, stage_params: Sequence, x,
                pre_stage: Optional[Callable[[int], None]] = None):
        """Run the staged forward; returns (logits, residuals).
        ``pre_stage(i)`` runs before stage i — the overlap hook where the
        worker loop blocks on stage i's pulled params."""
        residuals = []
        for i in range(self.n):
            if pre_stage is not None:
                pre_stage(i)
            residuals.append((stage_params[i], x))
            x = self._fwd[i](stage_params[i], x)
        return x, residuals

    def backward(self, residuals, g_out,
                 on_stage_grad: Callable[[int, object], None]):
        """Walk the stages deepest-first; ``on_stage_grad(i, g_params)``
        fires the moment stage i's gradient exists (the push hook)."""
        for i in reversed(range(self.n)):
            p, x_in = residuals[i]
            g_params, g_out = self._bwd[i](p, x_in, g_out)
            on_stage_grad(i, g_params)

    def loss_and_logit_grad(self, logits, y):
        """``(loss, aux, d loss / d logits)``."""
        return self._loss_grad(logits, y)


class _StagePullTracker:
    """Round-counted arrival tracking: one pull per stage per round."""

    def __init__(self, n_stages: int):
        self._cv = threading.Condition()
        self._rounds = [0] * n_stages

    def arrived(self, stage: int):
        with self._cv:
            self._rounds[stage] += 1
            self._cv.notify_all()

    def wait(self, stage: int, round_no: int, timeout: float = 120.0):
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._rounds[stage] >= round_no, timeout=timeout)
        if not ok:
            raise TimeoutError(
                f"stage {stage} params for round {round_no} never arrived")


def _to_device(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.tensor(np.asarray(a), device=dev)


def _stage_tensors(names: List[str], arrs: List[np.ndarray],
                   dev: torch.device) -> "OrderedDict[str, torch.Tensor]":
    """Host f32 leaves → a stage dict on ``dev``.  Copies: pulled arrays
    may be views of receive buffers the transport reuses."""
    return OrderedDict(
        (n, torch.from_numpy(np.array(a, np.float32)).to(dev))
        for n, a in zip(names, arrs))


def run_worker_overlapped(
    kv: WorkerKVStore,
    model: StagedModel,
    stage_params: Sequence[Dict[str, torch.Tensor]],
    data_iter: Iterable,
    steps: int,
    normalize: bool = True,
    barrier_init: bool = True,
    log_fn: Optional[Callable[[int, float, float], None]] = None,
    params_out: Optional[dict] = None,
) -> List[Tuple[float, float]]:
    """The overlapped counterpart of ``training.run_worker``.

    Semantics are identical to the BSP loop (FSA: every worker holds the
    same params each round); only the schedule differs — pushes stream
    during backward, pulls gate the next forward per stage.  Batches
    (numpy or tensors) move to stage 0's device; each stage's params
    stay on their own device.
    """
    n = model.n
    # tid assignment: stage i's leaves get consecutive ids, stage-major,
    # so priority=-tid means shallow stages outrank deep ones (ref:
    # examples/cnn.py:121 priority=-idx)
    names: List[List[str]] = []
    devs: List[torch.device] = []
    flats: List[List[np.ndarray]] = []
    stage_tids: List[List[int]] = []
    tid = 0
    for i, p in enumerate(stage_params):
        keys = list(p)
        if keys != sorted(keys):
            raise ValueError(
                f"stage {i}'s keys {keys} are not sorted: key ids and P3 "
                "priorities follow the JAX package's tree_flatten order")
        names.append(keys)
        devs.append(next(iter(p.values())).device)
        flats.append([p[k].detach().float().cpu().numpy().copy()
                      for k in keys])
        stage_tids.append(list(range(tid, tid + len(keys))))
        tid += len(keys)
    for i in range(n):
        for t, leaf in zip(stage_tids[i], flats[i]):
            kv.init(t, leaf, barrier=False)
    if barrier_init:
        kv.barrier()
    stage_params = [_stage_tensors(names[i], flats[i], devs[i])
                    for i in range(n)]

    scale = 1.0 / kv.num_workers if normalize else 1.0
    tracker = _StagePullTracker(n)
    pulled: dict = {}  # tid -> np.ndarray

    def _mk_cb(stage: int, want: int):
        got = []

        def cb(t, arr):
            pulled[t] = arr
            got.append(t)
            if len(got) == want:
                tracker.arrived(stage)

        return cb

    def _push_and_pull_stage(i: int, g_params):
        cb = _mk_cb(i, len(stage_tids[i]))
        for t, n_ in zip(stage_tids[i], names[i]):
            g_np = g_params[n_].detach().float().cpu().numpy() * scale
            if kv.config.enable_p3:
                # combined push+pull: values ride the push response
                kv.push_pull(t, g_np, cb, priority=-t)
            else:
                kv.push(t, g_np, priority=-t)
                kv.pull(t, cb, priority=-t)

    def _adopt_pulled(i: int):
        stage_params[i] = _stage_tensors(
            names[i], [pulled[t] for t in stage_tids[i]], devs[i])

    history: List[Tuple[float, float]] = []
    round_no = 0
    for step, (x, y) in enumerate(data_iter):
        if step >= steps:
            break

        def pre_stage(i: int):
            if round_no > 0:
                tracker.wait(i, round_no)
                _adopt_pulled(i)

        x, y = _to_device(x, devs[0]), _to_device(y, devs[-1])
        # the backward recomputes each stage's forward: both run under
        # Config.deterministic's fixed-order flash backward
        with step_order(kv):
            logits, residuals = model.forward(stage_params, x,
                                              pre_stage=pre_stage)
            loss, acc, g_logits = model.loss_and_logit_grad(logits, y)
            model.backward(residuals, g_logits, _push_and_pull_stage)
        round_no += 1
        history.append((float(loss), float(acc)))
        if log_fn is not None:
            log_fn(step, float(loss), float(acc))

    # drain the final round so callers observe the synced params
    # (round_no == 0 means the iterator yielded nothing: no pulls exist)
    if round_no > 0:
        for i in range(n):
            tracker.wait(i, round_no)
            _adopt_pulled(i)
    kv.wait_all()
    if params_out is not None:
        params_out["params"] = list(stage_params)
    return history


def overlap_vs_bsp_benchmark(stages: int = 6, n: int = 192_000,
                             steps: int = 3, fwd_s: float = 0.012,
                             bwd_s: float = 0.024,
                             wan_bandwidth_bps: float = 20e6,
                             wan_latency_s: float = 0.005,
                             device=None) -> dict:
    """Measure the staged loop against BSP under a serialized WAN uplink.

    The JAX package's harness with the same modeled constants and
    return keys: per-stage device compute is modeled with deterministic
    host sleeps around small torch stages on ``device`` (CUDA unless
    ``"cpu"``); both loops carry identical total compute — only the
    schedule differs.
    """
    import time

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.training import run_worker
    from geomx_tpu_torch.transport.van import FaultPolicy

    dev = resolve_device(device)

    def build():
        gen = torch.Generator().manual_seed(0)
        fns, params = [], []
        for i in range(stages):
            params.append(OrderedDict(
                big=torch.zeros(n, device=dev),
                w=(torch.randn(192, 192, generator=gen) / 14.0).to(dev)))
            last = i == stages - 1

            def fn(p, x, last=last):
                h = x @ p["w"] + 1e-9 * p["big"].sum()
                return h if last else torch.relu(h)

            fns.append(fn)
        return fns, params

    def ce(logits, y):
        logp = torch.log_softmax(logits, -1)
        loss = -logp.gather(1, y[:, None].long()).mean()
        return loss, logits.mean()

    data = [(np.zeros((16, 192), np.float32), np.zeros(16, np.int32))] * steps
    fault = dict(wan_bandwidth_bps=wan_bandwidth_bps,
                 wan_latency_s=wan_latency_s)

    def timed(overlapped: bool) -> float:
        sim = Simulation(Config(
            topology=Topology(num_parties=1, workers_per_party=1),
            enable_p3=True,
            merge_backend="torch:cpu" if dev.type == "cpu" else "torch"),
            fault=FaultPolicy(**fault))
        try:
            kv = sim.all_workers()[0]
            kv.set_optimizer({"type": "sgd", "lr": 0.01})
            fns, params = build()
            if overlapped:
                model = StagedModel(fns, ce)
                for i in range(model.n):
                    f0, b0 = model._fwd[i], model._bwd[i]
                    model._fwd[i] = (lambda p, x, f0=f0:
                                     (time.sleep(fwd_s), f0(p, x))[1])
                    model._bwd[i] = (lambda p, x, g, b0=b0:
                                     (time.sleep(bwd_s), b0(p, x, g))[1])
                run_worker_overlapped(kv, model, params, data[:1], 1,
                                      barrier_init=False)
                t0 = time.perf_counter()
                run_worker_overlapped(kv, model, params, data, steps,
                                      barrier_init=False)
                return time.perf_counter() - t0

            # BSP: one flat dict, stage-major, the same key order
            flat = OrderedDict((f"{i}.{k}", t) for i, p in enumerate(params)
                               for k, t in p.items())

            def grad_fn(ps, x, y):
                time.sleep(stages * (fwd_s + bwd_s))
                leaves = OrderedDict((k, t.detach().requires_grad_(True))
                                     for k, t in ps.items())
                h = _to_device(x, dev)
                for i, f in enumerate(fns):
                    h = f({k: leaves[f"{i}.{k}"] for k in ("big", "w")}, h)
                loss, aux = ce(h, _to_device(y, dev))
                grads = torch.autograd.grad(loss, list(leaves.values()))
                return loss.detach(), aux.detach(), dict(zip(leaves, grads))

            run_worker(kv, flat, grad_fn, data[:1], 1, barrier_init=False)
            t0 = time.perf_counter()
            run_worker(kv, flat, grad_fn, data, steps, barrier_init=False)
            return time.perf_counter() - t0
        finally:
            sim.shutdown()

    bsp = timed(False)
    ovl = timed(True)
    # modeled constants, exported so the regression test can derive its
    # bound from the SAME source as the schedule
    compute_s = (fwd_s + bwd_s) * stages
    wan_dir_s = stages * (n * 4) / wan_bandwidth_bps
    return {
        "bsp_s_per_step": bsp / steps,
        "overlap_s_per_step": ovl / steps,
        "speedup": bsp / ovl,
        "modeled": {
            "compute_s_per_step": compute_s,
            "wan_s_per_direction_per_step": wan_dir_s,
            # the overlap schedule can hide at most min(compute, one
            # direction's WAN) behind the other; this is the structural
            # quantity the staged loop exists to claw back
            "hideable_s_per_step": min(compute_s, wan_dir_s),
        },
        "setting": (f"{stages} stages x {n * 4 // 1024}KB, WAN "
                    f"{wan_bandwidth_bps / 1e6:.0f}MB/s uplink, "
                    f"{wan_latency_s * 1000:.0f}ms latency, modeled "
                    f"compute {compute_s * 1000:.0f}ms/step"),
    }
