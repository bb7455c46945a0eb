"""The port's HFA and ESync worker loops and local optimizers against the
JAX package's (CPU).

- A 2×2 + 1 HFA Simulation (hierarchical frequency aggregation: k1 = 2
  local steps a party sync, k2 = 2 party syncs a WAN sync), 8 steps, and
  the same with ESync at ``max_local_steps=1`` (the plan is then one
  local step a round, whatever the timing), 4 rounds: both packages'
  ``Simulation`` with ONE shared dyadic numpy gradient function and local
  SGD at lr 1/4 (``optax.sgd(0.25)`` / ``local.sgd(0.25)``).  The
  reference runs on the JAX package's numpy backend; the port on its
  ``numpy`` and ``torch:cpu`` merge backends.  Tolerance: none — the
  final weights must be BITWISE equal (each product is by a power of
  two, and both sides round each f32 sum once in the same order).
- The port of ``tests/test_esync.py``'s heterogeneous pair: a slow and a
  fast worker; the fast one runs more local steps in the same rounds,
  the replicas end equal (rtol 1e-5 / atol 1e-6, the JAX test's), the
  loss falls.
- ``local.adam`` against ``optax.adam`` over 20 steps of seeded
  gradients: within rtol 1e-6 / atol 1e-7 (the bias corrections'
  powers may differ in the last bit between XLA's and numpy's ``pow``);
  ``local.sgd`` against ``optax.sgd``: bitwise.
- The full-width CNN under HFA (k1 = 2, k2 = 1, 4 steps, local SGD lr
  0.1, f32 compute) from converted weights: losses within rtol 1e-5,
  final weights within rtol 1e-4 / atol 1e-6 (the tolerance of
  ``tests/test_torch_georound.py``'s full-width FSA run: the frameworks
  sum convolution windows in different orders).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geomx_tpu.core.config import Config as JConfig, Topology as JTopology
from geomx_tpu.data import ShardedIterator as JShardedIterator
from geomx_tpu.data import synthetic_classification
from geomx_tpu.kvstore import Simulation as JSimulation
from geomx_tpu.models.cnn import create_cnn_state as j_create_cnn_state
from geomx_tpu.training import run_worker_esync as j_run_worker_esync
from geomx_tpu.training import run_worker_hfa as j_run_worker_hfa
from geomx_tpu_torch.convert import flax_to_torch, torch_to_flax
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.data import ShardedIterator
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.models.cnn import create_cnn_state
from geomx_tpu_torch.optim import local
from geomx_tpu_torch.training import run_worker_esync, run_worker_hfa
from test_torch_georound import (_drive, _init_leaves, _jax_grad_fn,
                                 _torch_grad_fn)

HFA_STEPS = 8
ESYNC_ROUNDS = 4


def _hfa_config(C, T, backend, k2=2, parties=2, workers=2):
    return C(topology=T(num_parties=parties, workers_per_party=workers,
                        num_global_servers=1),
             sync_global_mode=True, use_hfa=True, hfa_k2=k2,
             merge_backend=backend)


def _run_jax(loop):
    init = _init_leaves()
    sim = JSimulation(_hfa_config(JConfig, JTopology, "numpy"))

    def body(kv, p, r, widx):
        kv.barrier()
        res: dict = {}
        params = jax.tree_util.tree_map(jnp.asarray, init)
        if loop == "hfa":
            j_run_worker_hfa(kv, params, _jax_grad_fn,
                             [((s, widx), None) for s in range(HFA_STEPS)],
                             HFA_STEPS, k1=2, optimizer=optax.sgd(0.25),
                             params_out=res)
        else:
            j_run_worker_esync(kv, params, _jax_grad_fn,
                               [((s, widx), None)
                                for s in range(ESYNC_ROUNDS)],
                               ESYNC_ROUNDS, optimizer=optax.sgd(0.25),
                               params_out=res, max_local_steps=1)
        return [np.asarray(x).tobytes()
                for x in jax.tree_util.tree_leaves(res["params"])]

    try:
        return _drive(sim, body)
    finally:
        sim.shutdown()


def _run_port(loop, backend):
    init = _init_leaves()
    sim = Simulation(_hfa_config(Config, Topology, backend))

    def body(kv, p, r, widx):
        kv.barrier()
        res: dict = {}
        params = {f"{m}.{k}": torch.from_numpy(v.copy())
                  for m, leaves in init.items() for k, v in leaves.items()}
        params = dict(sorted(params.items()))
        if loop == "hfa":
            run_worker_hfa(kv, params, _torch_grad_fn,
                           [((s, widx), None) for s in range(HFA_STEPS)],
                           HFA_STEPS, k1=2, optimizer=local.sgd(0.25),
                           params_out=res)
        else:
            run_worker_esync(kv, params, _torch_grad_fn,
                             [((s, widx), None)
                              for s in range(ESYNC_ROUNDS)],
                             ESYNC_ROUNDS, optimizer=local.sgd(0.25),
                             params_out=res, max_local_steps=1)
        return [t.numpy().tobytes() for t in res["params"].values()]

    try:
        got = _drive(sim, body)
        stats = [s.stats() for s in sim.local_servers + sim.global_servers]
    finally:
        sim.shutdown()
    return got, stats


_JAX_RUNS: dict = {}


@pytest.mark.parametrize("backend", ["numpy", "torch:cpu"])
@pytest.mark.parametrize("loop", ["hfa", "esync"])
def test_2x2_hfa_and_esync_bitwise_equal_to_jax(loop, backend):
    if loop not in _JAX_RUNS:
        _JAX_RUNS[loop] = _run_jax(loop)
    ref = _JAX_RUNS[loop]
    got, stats = _run_port(loop, backend)
    init = [v.tobytes() for m in _init_leaves().values() for v in m.values()]
    # the last sync of both loops is a WAN round (k2 = 2): one replica
    assert all(v == ref[0] for v in ref.values())
    assert ref[0] != init                           # training moved it
    assert all(v == ref[0] for v in got.values())   # bitwise equal
    want = "torch" if backend.startswith("torch") else "numpy"
    assert all(s["merge_backend"] == want for s in stats)


def test_esync_gives_the_fast_worker_more_steps():
    """Two heterogeneous workers in one party, lockstep rounds: the state
    server gives the fast worker more local steps a round, the replicas
    end equal and the loss falls (``tests/test_esync.py``'s case)."""
    sim = Simulation(_hfa_config(Config, Topology, "torch:cpu", k2=1,
                                 parties=1))
    target = torch.full((8,), 3.0)

    def make_grad_fn(delay_s):
        def grad_fn(params, x, y):
            time.sleep(delay_s)
            err = params["w"] - target
            return float((err ** 2).mean()), 0.0, {"w": 0.5 * err}
        return grad_fn

    def batches():
        while True:
            yield None, None

    results = {}

    def worker_main(rank, delay_s):
        out: dict = {}
        hist = run_worker_esync(
            sim.worker(0, rank), {"w": torch.zeros(8)},
            make_grad_fn(delay_s), batches(), 5, params_out=out,
            max_local_steps=8)
        results[rank] = (hist, out["params"])

    try:
        ts = [threading.Thread(target=worker_main, args=(0, 0.15)),
              threading.Thread(target=worker_main, args=(1, 0.005))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert set(results) == {0, 1}, "a worker hung"
    finally:
        sim.shutdown()
    (hist_slow, p_slow), (hist_fast, p_fast) = results[0], results[1]
    assert len(hist_fast) > len(hist_slow), (len(hist_fast), len(hist_slow))
    np.testing.assert_allclose(p_slow["w"].numpy(), p_fast["w"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert hist_fast[-1][0] < hist_fast[0][0]


def _seeded_grads(steps):
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (11,)}
    return [{n: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2))
             .astype(np.float32) for n, s in shapes.items()}
            for _ in range(steps)]


@pytest.mark.parametrize("kw", [{}, {"b1": 0.8, "b2": 0.99, "eps": 1e-6}])
def test_local_adam_matches_optax(kw):
    grads = _seeded_grads(20)
    p0 = {n: np.full(g.shape, 0.5, np.float32) for n, g in grads[0].items()}
    jopt, topt = optax.adam(1e-2, **kw), local.adam(1e-2, **kw)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                             jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({n: torch.from_numpy(v) for n, v in g.items()},
                             ts, tp)
        tp = local.apply_updates(tp, tu)
    for n in p0:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    assert ts["count"] == 20


def test_local_sgd_bitwise_equal_to_optax():
    grads = _seeded_grads(5)
    jp = {n: jnp.zeros(g.shape) for n, g in grads[0].items()}
    tp = {n: torch.zeros(g.shape) for n, g in grads[0].items()}
    jopt, topt = optax.sgd(0.1), local.sgd(0.1)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({n: jnp.asarray(v) for n, v in g.items()}, js)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({n: torch.from_numpy(v) for n, v in g.items()},
                             ts)
        tp = local.apply_updates(tp, tu)
    for n in jp:
        assert tp[n].numpy().tobytes() == np.asarray(jp[n]).tobytes(), n


def test_full_cnn_hfa_close_to_jax():
    steps, k1 = 4, 2
    x, y = synthetic_classification(n=256, seed=0)
    _, jparams, j_grad = j_create_cnn_state(jax.random.PRNGKey(0),
                                            compute_dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)

    jsim = JSimulation(_hfa_config(JConfig, JTopology, "numpy", k2=1,
                                   workers=1))

    def jbody(kv, p, r, widx):
        kv.barrier()
        res: dict = {}
        hist = j_run_worker_hfa(kv, jparams, j_grad,
                                JShardedIterator(x, y, 16, widx, 2, seed=0),
                                steps, k1=k1, optimizer=optax.sgd(0.1),
                                params_out=res)
        return hist, jax.tree_util.tree_map(np.asarray, res["params"])

    try:
        ref = _drive(jsim, jbody, workers=1)
    finally:
        jsim.shutdown()

    _, _, grad_fn = create_cnn_state(seed=0, device="cpu",
                                     compute_dtype=torch.float32)
    params0 = flax_to_torch(jparams)
    sim = Simulation(_hfa_config(Config, Topology, "torch:cpu", k2=1,
                                 workers=1))

    def tbody(kv, p, r, widx):
        kv.barrier()
        res: dict = {}
        hist = run_worker_hfa(kv, params0, grad_fn,
                              ShardedIterator(x, y, 16, widx, 2, seed=0),
                              steps, k1=k1, optimizer=local.sgd(0.1),
                              params_out=res)
        return hist, torch_to_flax(res["params"])

    try:
        got = _drive(sim, tbody, workers=1)
    finally:
        sim.shutdown()

    for w in range(2):
        (jh, jp), (th, tp) = ref[w], got[w]
        np.testing.assert_allclose([l for l, _ in th], [l for l, _ in jh],
                                   rtol=1e-5)
        for mod, leaves in jp["params"].items():
            for kind, a in leaves.items():
                np.testing.assert_allclose(tp["params"][mod][kind], a,
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{mod}.{kind}")
