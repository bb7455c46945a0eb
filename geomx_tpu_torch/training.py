"""Worker-side training loop gluing PyTorch compute to the HiPS kvstore.

The counterpart of the JAX package's ``training.py`` (``run_worker``):
autograd → per-layer ``kv.push(grad, priority=-idx)`` → ``kv.pull`` →
next step, with the device↔host handoff at the worker edge — gradients
leave the device as numpy, pulled weights come back as tensors on the
worker's device.  Per-layer priorities let shallow layers jump the send
queue under P3.

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
            with m.phase("grad"):
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


def build_flagship_lm(device=None, attn_impl: str = "fast"):
    """The flagship LM workload, sized by the ``GEOMX_LM_*`` variables
    with the JAX package's defaults (vocab 8192, d_model 384, 6 heads,
    4 layers, d_ff 1536, seq 128: 10,276,224 f32 parameters), bf16
    compute, on ``device`` (CUDA unless ``"cpu"``).  Returns ``(cfg,
    params, n_params, grad_fn, data)``; ``data`` is 512 synthetic token
    sequences.  ``GEOMX_LM_MOE_EXPERTS > 0`` asks for MoE layers, which
    are not ported yet and raise NotImplementedError."""
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
