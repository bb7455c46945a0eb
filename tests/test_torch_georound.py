"""The port's geo-round against the JAX package's Simulation (CPU).

- A 2×2 FSA geo-round — 2 parties × 2 workers, one global server — run
  through both packages' ``Simulation`` and ``run_worker`` with ONE
  shared dyadic numpy gradient function and SGD (lr 1/4).  The reference
  is the JAX package on its numpy backend (host merge, host codecs, host
  optimizer); the port runs its torch backend on the CPU device (device
  merge, device optimizer, device codec stage with the plain versions of
  the codec kernels).  Every sum and product is exact, so the final
  weights must be BITWISE equal under ``none``, ``2bit`` and ``bsc``.
  BSC runs with momentum 1/2 and a ratio that sends one coordinate per
  key: exact top-k and the host codec's sampled threshold then pick the
  same (tie-free) coordinate.
- A 3-step run of the full-width CNN (float32 compute on both sides)
  with compression ``none``: losses within rtol 1e-5 and final weights
  within rtol 1e-4 / atol 1e-6 (the two frameworks sum convolution
  windows in different orders; three SGD steps amplify ~1e-7 relative
  gradient differences by at most lr × steps).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.core.config import Config as JConfig, Topology as JTopology
from geomx_tpu.data import ShardedIterator as JShardedIterator
from geomx_tpu.data import synthetic_classification
from geomx_tpu.kvstore import Simulation as JSimulation
from geomx_tpu.models.cnn import create_cnn_state as j_create_cnn_state
from geomx_tpu.training import run_worker as j_run_worker
from geomx_tpu_torch.convert import flax_to_torch, torch_to_flax
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.data import ShardedIterator
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.models.cnn import create_cnn_state
from geomx_tpu_torch.training import run_worker

STEPS = 3
SHAPES = {"a": {"bias": (8,), "weight": (6, 5)},
          "b": {"bias": (3,), "weight": (4, 7)}}


def _init_leaves():
    rng = np.random.default_rng(0)
    return {m: {k: (rng.integers(-8, 9, s) / 8).astype(np.float32)
                for k, s in sorted(leaves.items())}
            for m, leaves in sorted(SHAPES.items())}


def _dyadic_grads(step, widx, leaves):
    """The shared gradient function: distinct dyadic magnitudes per key
    plus a quarter of the current weights."""
    rng = np.random.default_rng(1000 * step + widx)
    out = []
    for p in leaves:
        q = rng.permutation(p.size).reshape(p.shape) + 1
        sign = np.where(rng.random(p.shape) < 0.5, -1.0, 1.0)
        out.append((q * sign / 64.0 + p / 4).astype(np.float32))
    return out


def _jax_grad_fn(params, x, y):
    step, widx = x
    leaves, treedef = jax.tree_util.tree_flatten(params)
    grads = _dyadic_grads(step, widx, [np.asarray(p) for p in leaves])
    zero = np.float32(0.0)
    return zero, zero, jax.tree_util.tree_unflatten(treedef, grads)


def _torch_grad_fn(params, x, y):
    step, widx = x
    names = list(params)
    grads = _dyadic_grads(step, widx, [params[n].numpy() for n in names])
    zero = torch.zeros(())
    return zero, zero, {n: torch.from_numpy(g) for n, g in zip(names, grads)}


def _drive(sim, worker_body, parties=2, workers=2):
    """Run ``worker_body(kv, party, rank, widx)`` on every worker thread;
    returns {widx: result}; re-raises a worker's exception."""
    out, errors = {}, []

    def main(p, r):
        try:
            widx = p * workers + r
            out[widx] = worker_body(sim.worker(p, r), p, r, widx)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=main, args=(p, r), daemon=True)
          for p in range(parties) for r in range(workers)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts), "a worker hung"
    if errors:
        raise errors[0]
    return out


def _configure(kv, p, r, opt, comp):
    if r == 0:
        if p == 0:
            kv.set_optimizer(opt)
        if comp is not None:
            kv.set_gradient_compression(comp)
    kv.barrier()


COMPRESSION = {
    "none": None,
    "2bit": {"type": "2bit", "threshold": 0.5},
    "bsc": {"type": "bsc", "ratio": 0.01, "momentum": 0.5},
}


@pytest.mark.parametrize("mode", sorted(COMPRESSION))
def test_2x2_fsa_georound_bitwise_equal_to_jax(mode):
    opt = {"type": "sgd", "lr": 0.25}
    comp = COMPRESSION[mode]
    init = _init_leaves()

    def topo(T):
        return T(num_parties=2, workers_per_party=2, num_global_servers=1)

    jsim = JSimulation(JConfig(topology=topo(JTopology),
                               sync_global_mode=True,
                               merge_backend="numpy"))

    def jbody(kv, p, r, widx):
        _configure(kv, p, r, opt, comp)
        res: dict = {}
        params = jax.tree_util.tree_map(jnp.asarray, init)
        j_run_worker(kv, params, _jax_grad_fn,
                     [((s, widx), None) for s in range(STEPS)], STEPS,
                     params_out=res)
        return [np.asarray(x).tobytes()
                for x in jax.tree_util.tree_leaves(res["params"])]

    try:
        ref = _drive(jsim, jbody)
    finally:
        jsim.shutdown()

    sim = Simulation(Config(topology=topo(Topology), sync_global_mode=True,
                            merge_backend="torch:cpu"))

    def tbody(kv, p, r, widx):
        _configure(kv, p, r, opt, comp)
        res: dict = {}
        params = {f"{m}.{k}": torch.from_numpy(v.copy())
                  for m, leaves in init.items() for k, v in leaves.items()}
        run_worker(kv, dict(sorted(params.items())), _torch_grad_fn,
                   [((s, widx), None) for s in range(STEPS)], STEPS,
                   params_out=res)
        return [t.numpy().tobytes() for t in res["params"].values()]

    try:
        got = _drive(sim, tbody)
        stats = [s.stats() for s in sim.local_servers + sim.global_servers]
    finally:
        sim.shutdown()

    assert all(v == ref[0] for v in ref.values())   # FSA: one replica
    assert ref[0] != [v.tobytes() for m in init.values()
                      for v in m.values()]           # training moved it
    assert all(v == ref[0] for v in got.values())   # bitwise equal
    for s in stats:
        assert s["merge_backend"] == "torch"
        assert s["codec_host_bytes"] == 0
    if comp is not None:
        assert stats[0]["codec_d2h_bytes"] > 0      # device encode ran
    assert stats[-1]["opt_device"] == "sgd"          # device optimizer ran


def test_full_cnn_three_steps_close_to_jax():
    opt = {"type": "sgd", "lr": 0.1}
    x, y = synthetic_classification(n=256, seed=0)
    _, jparams, j_grad = j_create_cnn_state(jax.random.PRNGKey(0),
                                            compute_dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)

    def topo(T):
        return T(num_parties=2, workers_per_party=1, num_global_servers=1)

    jsim = JSimulation(JConfig(topology=topo(JTopology),
                               sync_global_mode=True,
                               merge_backend="numpy"))

    def jbody(kv, p, r, widx):
        _configure(kv, p, r, opt, None)
        res: dict = {}
        hist = j_run_worker(kv, jparams, j_grad,
                            JShardedIterator(x, y, 16, widx, 2, seed=0),
                            STEPS, params_out=res)
        return hist, jax.tree_util.tree_map(np.asarray, res["params"])

    try:
        ref = _drive(jsim, jbody, workers=1)
    finally:
        jsim.shutdown()

    _, _, grad_fn = create_cnn_state(seed=0, device="cpu",
                                     compute_dtype=torch.float32)
    params0 = flax_to_torch(jparams)
    sim = Simulation(Config(topology=topo(Topology), sync_global_mode=True,
                            merge_backend="torch:cpu"))

    def tbody(kv, p, r, widx):
        _configure(kv, p, r, opt, None)
        res: dict = {}
        hist = run_worker(kv, params0, grad_fn,
                          ShardedIterator(x, y, 16, widx, 2, seed=0),
                          STEPS, params_out=res)
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
