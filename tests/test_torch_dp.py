"""The port's party-level data parallelism against the JAX package's
(CPU): ``make_party_step`` and ``party_meshes``.

The JAX side runs its jitted GSPMD party step on meshes of the virtual
CPU devices (``tests/conftest.py``); the port runs the same step
single-controller on ``["cpu"] * k`` meshes: each rank's batch shard
through ``grad_fn`` against its own replica, then an explicit psum / dp.
Data and weights come from numpy seeds (the LM's cross through
``convert.flax_lm_to_torch``), f32.

Tolerances: JAX reduces the loss over the global batch, the port takes
the mean of the ranks' means (the same sum in another order).  The MLP
step: loss rtol 1e-6 (measured equal), gradients atol 1e-7 (measured
worst 1.5e-8); after 6 HiPS rounds (SGD, lr 0.5) the parties' weights
atol 1e-6 of JAX's (measured 3.0e-8) and the two parties bitwise equal.
The LM party step: loss rtol 1e-6 (measured equal), gradients atol 1e-6
(measured 7.1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.core.config import Config as JConfig, Topology as JTopology
from geomx_tpu.kvstore import Simulation as JSimulation
from geomx_tpu.models import transformer as JT
from geomx_tpu.parallel.dp import (make_party_step as j_make_party_step,
                                   party_meshes as j_party_meshes)
from geomx_tpu_torch.convert import flax_lm_to_torch
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.models import transformer as T
from geomx_tpu_torch.parallel.dp import make_party_step, party_meshes

ROUNDS, LR = 6, 0.5


def _mlp_data():
    rng = np.random.default_rng(0)
    params = {"W": (rng.standard_normal((8, 4)) * 0.1).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    y = rng.integers(0, 4, (2, 16)).astype(np.int32)
    return params, x, y


def _j_grad_fn(p, x, y):
    def loss_fn(p):
        logits = x @ p["W"] + p["b"]
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))
        return loss, jnp.mean(jnp.argmax(logits, -1) == y)

    (loss, acc), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
    return loss, acc, g


def _t_grad_fn(p, x, y):
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x, y = torch.as_tensor(x), torch.as_tensor(y).long()
    logits = x @ p["W"] + p["b"]
    logp = torch.log_softmax(logits, -1)
    loss = -logp.gather(1, y[:, None]).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), acc, dict(zip(p, grads))


def test_party_step_matches_jax():
    params, x, y = _mlp_data()
    jmesh = j_party_meshes(2)[0]
    mesh = party_meshes(2, ["cpu"] * 8)[0]
    assert mesh.shape == {"dp": 4} and jmesh.shape["dp"] == 4
    lj, aj, gj = j_make_party_step(_j_grad_fn, jmesh)(params, x[0], y[0])
    lt, at, gt = make_party_step(_t_grad_fn, mesh)(
        {k: torch.from_numpy(v) for k, v in params.items()}, x[0], y[0])
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert float(at) == float(aj)
    for k in params:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   atol=1e-7, err_msg=k)


def test_ranks_sharing_a_device_are_reduced_not_summed():
    """Four ranks on one device: every rank sees the same shard, and the
    reduced gradient is their mean (the single-shard gradient), never
    the sum that one shared autograd leaf would give."""
    params, x, _ = _mlp_data()
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    xs = np.concatenate([x[0][:4]] * 4)
    ys = np.zeros(16, np.int32)
    _, _, one = _t_grad_fn({k: v.clone() for k, v in p.items()}, xs[:4],
                           ys[:4])
    _, _, red = make_party_step(_t_grad_fn,
                                party_meshes(1, ["cpu"] * 4)[0])(p, xs, ys)
    for k in p:
        torch.testing.assert_close(red[k], one[k], rtol=0, atol=1e-7)


def _j_hips(steps, params, x, y):
    sim = JSimulation(JConfig(topology=JTopology(num_parties=2,
                                                 workers_per_party=1)))
    try:
        kvs = [sim.worker(p, 0) for p in range(2)]
        leaves, treedef = jax.tree_util.tree_flatten(params)
        for kv in kvs:
            for tid, leaf in enumerate(leaves):
                kv.init(tid, np.asarray(leaf))
        kvs[0].set_optimizer({"type": "sgd", "lr": LR})
        cur = [params, params]
        for _ in range(ROUNDS):
            for p in range(2):
                _, _, g = steps[p](cur[p], x[p], y[p])
                for tid, gl in enumerate(jax.tree_util.tree_leaves(g)):
                    kvs[p].push(tid, np.asarray(gl))
            for p in range(2):
                buf = [kvs[p].pull_sync(tid) for tid in range(len(leaves))]
                kvs[p].wait_all()
                cur[p] = jax.tree_util.tree_unflatten(
                    treedef, [np.array(b) for b in buf])
        return cur
    finally:
        sim.shutdown()


def _t_hips(steps, params, x, y):
    sim = Simulation(Config(topology=Topology(num_parties=2,
                                              workers_per_party=1),
                            merge_backend="torch:cpu"))
    try:
        kvs = [sim.worker(p, 0) for p in range(2)]
        names = sorted(params)
        for kv in kvs:
            for tid, n in enumerate(names):
                kv.init(tid, params[n])
        kvs[0].set_optimizer({"type": "sgd", "lr": LR})
        cur = [dict(params), dict(params)]
        for _ in range(ROUNDS):
            for p in range(2):
                _, _, g = steps[p](
                    {n: torch.from_numpy(v) for n, v in cur[p].items()},
                    x[p], y[p])
                for tid, n in enumerate(names):
                    kvs[p].push(tid, g[n].numpy())
            for p in range(2):
                buf = [kvs[p].pull_sync(tid) for tid in range(len(names))]
                kvs[p].wait_all()
                cur[p] = {n: np.array(b) for n, b in zip(names, buf)}
        return cur
    finally:
        sim.shutdown()


def test_two_parties_through_hips_match_jax():
    """The JAX package's headline mapping: 2 parties, each a 4-rank dp
    mesh, push one merged gradient per tensor into the two-tier kvstore
    (FSA, SGD) for 6 rounds; the parties end bitwise equal and within
    1e-6 of JAX's weights."""
    params, x, y = _mlp_data()
    j = _j_hips([j_make_party_step(_j_grad_fn, m) for m in j_party_meshes(2)],
                params, x, y)
    t = _t_hips([make_party_step(_t_grad_fn, m)
                 for m in party_meshes(2, ["cpu"] * 8)], params, x, y)
    for n in params:
        assert t[0][n].tobytes() == t[1][n].tobytes()
        np.testing.assert_allclose(t[0][n], np.asarray(j[0][n]), atol=1e-6,
                                   err_msg=n)
    assert not np.array_equal(t[0]["W"], params["W"])


def test_lm_party_step_matches_jax():
    w = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=16)
    jcfg = JT.TransformerConfig(**w, compute_dtype=jnp.float32,
                                attn_impl="dense")
    host = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, 64, (4, 16), np.int32)
    lj, _, gj = j_make_party_step(JT.make_lm_grad_fn(jcfg),
                                  j_party_meshes(2, jax.devices()[:4])[0])(
        host, tokens, tokens)
    cfg = T.TransformerConfig(**w, compute_dtype=torch.float32,
                              attn_impl="dense")
    lt, _, gt = make_party_step(T.make_lm_grad_fn(cfg),
                                party_meshes(2, ["cpu"] * 4)[0])(
        flax_lm_to_torch(host), tokens, tokens)
    gj = flax_lm_to_torch(jax.tree_util.tree_map(np.asarray, gj))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    for n, g in gt.items():
        np.testing.assert_allclose(g.numpy(), gj[n].numpy(), atol=1e-6,
                                   err_msg=n)


def test_party_meshes_errors_are_jaxs():
    for parties, k in ((2, 5), (3, 2)):
        with pytest.raises((ValueError, AssertionError)) as j:
            j_party_meshes(parties, jax.devices()[:k])
        with pytest.raises(j.type) as t:
            party_meshes(parties, ["cpu"] * k)
        assert str(t.value) == str(j.value)
    meshes = party_meshes(2, ["cpu"] * 6, axis="party")
    assert [m.shape for m in meshes] == [{"party": 3}] * 2
