"""Worker-side training loops gluing PyTorch compute to the HiPS kvstore.

The counterpart of the JAX package's ``training.py``:

- :func:`run_worker`, the FSA loop: autograd → per-layer
  ``kv.push(grad, priority=-idx)`` → ``kv.pull`` → next step;
- :func:`run_worker_hfa`, HFA (hierarchical frequency aggregation): k1
  local steps with a worker-side optimizer
  (:mod:`geomx_tpu_torch.optim.local`), then one weight sync;
- :func:`run_worker_esync`, ESync: the party's state server assigns each
  worker its local steps a sync round;
- :class:`Trainer`, the fit/evaluate/save/load facade over them;
- :func:`save_params` / :func:`load_params`, the port's checkpoint.

The device↔host handoff is at the worker edge: gradients (or, under HFA
and ESync, weights) leave the device as numpy, pulled weights come back
as tensors on the worker's device.  Per-layer priorities let shallow
layers jump the send queue under P3.

``params`` is an ordered dict of tensors whose order is the kv key order
(:func:`flatten_params`), the same order as the JAX package's flax
leaves.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from geomx_tpu_torch.kvstore.client import WorkerKVStore


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """The port's checkpoint: ``torch.save`` of the ordered ``{name: f32
    CPU tensor}`` dict, in key order, written atomically.  (The JAX
    package writes flax msgpack; a JAX checkpoint reaches the port
    through :func:`geomx_tpu_torch.convert.flax_to_torch`.)"""
    from geomx_tpu_torch.utils.io import atomic_write

    host = OrderedDict((n, t.detach().to("cpu", torch.float32))
                       for n, t in params.items())
    with atomic_write(path) as f:
        torch.save(host, f)


def load_params(path: str, device=None) -> "OrderedDict[str, torch.Tensor]":
    """Inverse of :func:`save_params`, onto ``device`` (CUDA unless
    ``"cpu"``)."""
    from geomx_tpu_torch.core.platform import resolve_device

    dev = resolve_device(device)
    host = torch.load(path, map_location="cpu", weights_only=True)
    return OrderedDict((n, t.to(dev)) for n, t in host.items())


def step_order(kv):
    """The context a worker's grad step runs in: under
    ``Config.deterministic`` flash attention's bf16 backward sums dQ in a
    fixed order, so the step's gradients repeat bit for bit (the merge
    side is numpy under that flag already)."""
    from geomx_tpu_torch.ops.flash_attention import fixed_order_backward

    return fixed_order_backward(
        bool(getattr(getattr(kv, "config", None), "deterministic", False)))


def _preempt_noticed(kv) -> bool:
    """True once a spot-preemption notice landed on this worker: the
    loop finishes its in-flight step, then stops pushing."""
    ev = getattr(kv, "preempt_noticed", None)
    return ev is not None and ev.is_set()


def flatten_params(params: Dict[str, torch.Tensor]
                   ) -> Tuple[List[np.ndarray], Tuple[List[str], torch.device]]:
    """Host f32 copies of the leaves in key order, and the "treedef"
    (names + device) :func:`unflatten_params` rebuilds from."""
    names = list(params)
    dev = params[names[0]].device
    return ([params[n].detach().float().cpu().numpy().copy()
             for n in names], (names, dev))


def unflatten_params(treedef, arrs: List[np.ndarray]
                     ) -> "OrderedDict[str, torch.Tensor]":
    """Host leaves → tensors on the treedef's device.  A blocking copy:
    pulled arrays may be views of receive buffers the transport reuses
    (and on the CPU device the copy keeps the params from aliasing
    them)."""
    names, dev = treedef
    return OrderedDict(
        (n, torch.from_numpy(np.ascontiguousarray(a, np.float32))
         .to(dev, copy=True))
        for n, a in zip(names, arrs))


def run_worker(
    kv: WorkerKVStore,
    params: Dict[str, torch.Tensor],
    grad_fn: Callable,
    data_iter: Iterable,
    steps: int,
    normalize: bool = True,
    barrier_init: bool = True,
    log_fn: Optional[Callable[[int, float, float], None]] = None,
    params_out: Optional[dict] = None,
    measure=None,
) -> List[Tuple[float, float]]:
    """Train ``steps`` steps; returns ``[(loss, acc), ...]`` per step.

    Under FSA the params after each step are identical on every worker.
    ``grad_fn(params, x, y) -> (loss, acc, grads)`` with ``grads`` keyed
    like ``params``.  ``measure`` (utils.Measure) brackets each phase —
    grad compute / push / pull-wait — per step.
    """
    from geomx_tpu_torch.utils.measure import Measure

    m = measure if measure is not None else Measure()
    leaves, treedef = flatten_params(params)
    names = treedef[0]
    for tid, leaf in enumerate(leaves):
        kv.init(tid, leaf, barrier=barrier_init)
    params = unflatten_params(treedef, leaves)
    # grads are summed across the party then averaged over parties at the
    # global server; pre-divide by party size so the update is the
    # all-worker mean
    history: List[Tuple[float, float]] = []
    buf: List[Optional[np.ndarray]] = [None] * len(leaves)

    for step, (x, y) in enumerate(data_iter):
        if step >= steps or _preempt_noticed(kv):
            break
        # re-read per step: dynamic join/leave changes the party size
        scale = 1.0 / kv.num_workers if normalize else 1.0
        m.step_start()
        with kv.trace_round(step):
            with m.phase("grad"), step_order(kv):
                loss, acc, grads = grad_fn(params, x, y)
                # one D2H per leaf, which also waits for the backward
                # pass, so the phase split is honest
                g_leaves = [grads[n].detach().float().cpu().numpy()
                            for n in names]
            with m.phase("push"):
                if kv.ts_push is not None:
                    # TS push direction: worker-to-worker merge tree
                    kv.ts_merge_push({tid: g * scale
                                      for tid, g in enumerate(g_leaves)})
                    for tid in range(len(leaves)):
                        kv.pull(tid,
                                lambda t, arr: buf.__setitem__(t, arr),
                                priority=-tid)
                elif kv.config.enable_p3:
                    # P3: sliced push+pull, values ride the response
                    for tid, g in enumerate(g_leaves):
                        kv.push_pull(tid, g * scale,
                                     lambda t, arr: buf.__setitem__(t, arr),
                                     priority=-tid)
                else:
                    for tid, g in enumerate(g_leaves):
                        kv.push(tid, g * scale, priority=-tid)
                    for tid in range(len(leaves)):
                        kv.pull(tid,
                                lambda t, arr: buf.__setitem__(t, arr),
                                priority=-tid)
            with m.phase("pull_wait"):
                kv.wait_all()
        params = unflatten_params(treedef, buf)  # type: ignore[arg-type]
        m.step_end()
        history.append((float(loss), float(acc)))
        if log_fn is not None:
            log_fn(step, float(loss), float(acc))
    if params_out is not None:
        params_out["params"] = params
    return history


def run_worker_hfa(
    kv: WorkerKVStore,
    params: Dict[str, torch.Tensor],
    grad_fn: Callable,
    data_iter: Iterable,
    steps: int,
    k1: int = 2,
    optimizer=None,
    barrier_init: bool = True,
    log_fn: Optional[Callable[[int, float, float], None]] = None,
    params_out: Optional[dict] = None,
    measure=None,
) -> List[Tuple[float, float]]:
    """HFA client loop: each worker runs a LOCAL optimizer (a
    :mod:`geomx_tpu_torch.optim.local` transform, ``adam(1e-2)`` by
    default) for k1 steps, then pushes weight/num_workers (the local
    server averages weights; every k2-th sync the milestone delta
    crosses the WAN).  The optimizer state persists across syncs."""
    from geomx_tpu_torch.optim import local
    from geomx_tpu_torch.utils.measure import Measure

    m = measure if measure is not None else Measure()
    if optimizer is None:
        optimizer = local.adam(1e-2)
    leaves, treedef = flatten_params(params)
    for tid, leaf in enumerate(leaves):
        kv.init(tid, leaf, barrier=barrier_init)
    params = unflatten_params(treedef, leaves)
    opt_state = optimizer.init(params)
    history: List[Tuple[float, float]] = []
    buf: List[Optional[np.ndarray]] = [None] * len(leaves)

    for step, (x, y) in enumerate(data_iter):
        if step >= steps or _preempt_noticed(kv):
            break
        m.step_start()
        with m.phase("grad"), step_order(kv):
            loss, acc, grads = grad_fn(params, x, y)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = local.apply_updates(params, updates)
        if (step + 1) % k1 == 0:
            params, _ = _hfa_sync_round(kv, params, treedef, len(leaves),
                                        buf, m)
        m.step_end()
        history.append((float(loss), float(acc)))
        if log_fn is not None:
            log_fn(step, float(loss), float(acc))
    if params_out is not None:
        params_out["params"] = params
    return history


def _hfa_sync_round(kv, params, treedef, n_leaves, buf, m,
                    measure_comm: bool = False):
    """One weight-exchange sync, shared by the HFA and ESync loops: push
    party-mean weights (host f32), pull the merged result into ``buf``.

    Returns ``(params, comm_s)``.  ``comm_s`` (only when
    ``measure_comm``) times the push acks alone, the uplink: the pull
    barrier after them is the straggler wait ESync exists to remove."""
    import time

    w_leaves, _ = flatten_params(params)
    comm_s = None
    # re-read the party size at every sync: join/leave moves it, and the
    # denominator each push used rides along as ``hfa_n``
    n = kv.num_workers
    t1 = time.perf_counter()
    with m.phase("push"):
        push_ts = [kv.push(tid, w / n, priority=-tid, body={"hfa_n": n})
                   for tid, w in enumerate(w_leaves)]
        if measure_comm:
            for pts in push_ts:
                kv.worker.wait(pts)
            comm_s = time.perf_counter() - t1
        for tid in range(n_leaves):
            kv.pull(tid, lambda t, arr: buf.__setitem__(t, arr),
                    priority=-tid)
    with m.phase("pull_wait"):
        kv.wait_all()
    return unflatten_params(treedef, buf), comm_s


def run_worker_esync(
    kv: WorkerKVStore,
    params: Dict[str, torch.Tensor],
    grad_fn: Callable,
    data_iter: Iterable,
    rounds: int,
    optimizer=None,
    barrier_init: bool = True,
    log_fn: Optional[Callable[[int, float, float], None]] = None,
    params_out: Optional[dict] = None,
    max_local_steps: int = 64,
    measure=None,
    rounds_out: Optional[list] = None,
) -> List[Tuple[float, float]]:
    """ESync client loop: like HFA, a LOCAL optimizer and a mean-weight
    push at every sync, but the party's state server assigns each worker
    its local steps a round (``sched/esync.py``), so fast workers fill
    the slowest one's round with local progress instead of idling at
    the barrier.

    ``rounds`` counts SYNC rounds, the same on every worker of the party;
    local steps a round vary per worker (1 until the first plan).
    ``data_iter`` should yield up to rounds × max_local_steps batches or
    be cyclic; a worker whose data runs dry still pushes every round
    and stops reporting.  ``rounds_out`` gets (local steps, reach-server
    seconds) per round.  Needs HFA on the servers (Config.use_hfa)."""
    import time

    from geomx_tpu_torch.optim import local
    from geomx_tpu_torch.utils.measure import Measure

    m = measure if measure is not None else Measure()
    if optimizer is None:
        optimizer = local.adam(1e-2)
    leaves, treedef = flatten_params(params)
    for tid, leaf in enumerate(leaves):
        kv.init(tid, leaf, barrier=barrier_init)
    params = unflatten_params(treedef, leaves)
    opt_state = optimizer.init(params)
    history: List[Tuple[float, float]] = []
    buf: List[Optional[np.ndarray]] = [None] * len(leaves)

    it = iter(data_iter)
    local_steps = 1  # until the state server has a plan
    loss = acc = 0.0
    for _round in range(rounds):
        if _preempt_noticed(kv):
            break
        m.step_start()
        t0 = time.perf_counter()
        ran = 0
        with m.phase("grad"), step_order(kv):
            for _ in range(local_steps):
                try:
                    x, y = next(it)
                except StopIteration:
                    break
                loss, acc, grads = grad_fn(params, x, y)
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                params = local.apply_updates(params, updates)
                ran += 1
                history.append((float(loss), float(acc)))
        step_s = (time.perf_counter() - t0) / max(ran, 1)
        params, comm_s = _hfa_sync_round(kv, params, treedef, len(leaves),
                                         buf, m, measure_comm=True)
        m.step_end()
        if rounds_out is not None:
            rounds_out.append((ran, round(step_s * ran + comm_s, 4)))
        if ran > 0:
            # a dry iterator must not report: its near-zero step time
            # would pin every worker that still has data at min_steps
            local_steps = kv.esync_report(step_s, comm_s,
                                          max_steps=max_local_steps)
        if log_fn is not None:
            log_fn(_round, float(loss), float(acc))
    if params_out is not None:
        params_out["params"] = params
    return history


class Trainer:
    """Fit/evaluate facade over the worker loops: rank-0 configuration
    (optimizer to the global tier, compression to the party server), the
    init barrier, the loop (plain FSA or HFA), streaming-metric
    evaluation, and checkpoints in the port's format."""

    def __init__(self, kv: WorkerKVStore, params, grad_fn: Callable,
                 model=None, optimizer: Optional[dict] = None,
                 compression: Optional[dict] = None,
                 hfa_k1: Optional[int] = None):
        self.kv = kv
        self.params = params
        self.grad_fn = grad_fn
        self.model = model  # needs ``apply(params, x)`` for evaluate()
        self.hfa_k1 = hfa_k1
        if (hfa_k1 is not None) != bool(kv.config.use_hfa):
            # the HFA loop pushes WEIGHTS, the plain loop GRADIENTS: a
            # mismatch with the servers' mode feeds weights to the
            # optimizer as gradients
            raise ValueError(
                "hfa_k1 must be set if and only if the cluster runs with "
                f"use_hfa (got hfa_k1={hfa_k1!r}, "
                f"config.use_hfa={kv.config.use_hfa})")
        if kv.party == 0 and kv.rank == 0 and optimizer is not None:
            kv.set_optimizer(optimizer)
        if kv.rank == 0 and compression is not None:
            kv.set_gradient_compression(compression)
        kv.barrier()

    def fit(self, data_iter: Iterable, steps: int,
            log_fn: Optional[Callable[[int, float, float], None]] = None,
            measure=None) -> List[Tuple[float, float]]:
        """Train; returns [(loss, acc)] per step.  The updated params
        stay on the trainer for evaluate() and further fits."""
        captured: dict = {}
        if self.hfa_k1 is not None:
            hist = run_worker_hfa(self.kv, self.params, self.grad_fn,
                                  data_iter, steps, k1=self.hfa_k1,
                                  log_fn=log_fn, params_out=captured,
                                  measure=measure)
        else:
            hist = run_worker(self.kv, self.params, self.grad_fn,
                              data_iter, steps, log_fn=log_fn,
                              params_out=captured, measure=measure)
        if "params" in captured:
            self.params = captured["params"]
        return hist

    def save(self, path: str) -> None:
        """Persist the current params (:func:`save_params`)."""
        save_params(path, self.params)

    def load(self, path: str) -> None:
        """Restore params onto their device AND overwrite the servers'
        weights (a local-only load would be dropped at the first sync).
        Call on every worker of every party, between fits."""
        dev = next(iter(self.params.values())).device
        self.params = load_params(path, dev)
        leaves, _ = flatten_params(self.params)
        self.kv.init_all(dict(enumerate(leaves)), overwrite=True)
        self.kv.barrier()

    def evaluate(self, data_iter: Iterable, batches: int, metric=None):
        """Forward ``batches`` batches through ``model.apply``, streaming
        (labels, softmax probabilities in f32) into ``metric`` (default
        Accuracy); returns ``metric.get()``."""
        from geomx_tpu_torch.utils import metrics as _metrics

        if self.model is None:
            raise ValueError("evaluate() needs the model; pass it to "
                             "Trainer(model=...)")
        if metric is None:
            metric = _metrics.Accuracy()
        dev = next(iter(self.params.values())).device
        for i, (x, y) in enumerate(data_iter):
            if i >= batches:
                break
            with torch.no_grad():
                logits = self.model.apply(
                    self.params, torch.as_tensor(np.asarray(x), device=dev))
                probs = torch.softmax(logits.float(), dim=-1)
            metric.update(np.asarray(y), probs.cpu().numpy())
        return metric.get()


def build_flagship_lm(device=None, attn_impl: str = "fast"):
    """The flagship LM workload, sized by the ``GEOMX_LM_*`` variables
    with the JAX package's defaults (vocab 8192, d_model 384, 6 heads,
    4 layers, d_ff 1536, seq 128: 10,276,224 f32 parameters), bf16
    compute, on ``device`` (CUDA unless ``"cpu"``).  Returns ``(cfg,
    params, n_params, grad_fn, data)``; ``data`` is 512 synthetic token
    sequences.  ``GEOMX_LM_MOE_EXPERTS > 0`` makes every 2nd layer a
    top-k MoE with that many experts (``GEOMX_LM_MOE_TOP_K``, default 2,
    clamped to the expert count): 17,357,184 parameters at 4 experts,
    trained with the load-balancing aux."""
    import os

    from geomx_tpu_torch.data import synthetic_lm
    from geomx_tpu_torch.models.transformer import (
        TransformerConfig, create_lm_state)

    def _e(name, dflt):
        return int(os.environ.get(name, dflt))

    moe_experts = _e("GEOMX_LM_MOE_EXPERTS", 0)
    cfg = TransformerConfig(
        vocab=_e("GEOMX_LM_VOCAB", 8192),
        d_model=_e("GEOMX_LM_DMODEL", 384),
        n_heads=_e("GEOMX_LM_HEADS", 6),
        n_layers=_e("GEOMX_LM_LAYERS", 4),
        d_ff=_e("GEOMX_LM_DFF", 1536),
        max_seq=_e("GEOMX_LM_SEQ", 128),
        attn_impl=attn_impl,
        moe_every=2 if moe_experts > 0 else 0,
        n_experts=max(moe_experts, 1),
        moe_top_k=(min(_e("GEOMX_LM_MOE_TOP_K", 2), moe_experts)
                   if moe_experts > 0 else 0),
    )
    params, grad_fn = create_lm_state(cfg, seed=0, device=device)
    n_params = sum(t.numel() for t in params.values())
    data = synthetic_lm(n=512, seq=cfg.max_seq, vocab=cfg.vocab, seed=0)
    return cfg, params, n_params, grad_fn, data
