"""The port's ``Trainer`` and checkpoints against the JAX package's (CPU).

The cases of ``tests/test_optim_metrics.py``'s Trainer tests, on the
full-width CNN (the port's model registry holds the CNN only), f32
compute, one party of one worker:

- ``fit`` + ``evaluate`` from converted weights, server SGD (lr 0.05), 3
  steps, against JAX's ``Trainer``: losses within rtol 1e-5, final
  weights within rtol 1e-4 / atol 1e-6 (``tests/test_torch_georound.py``'s
  full-width tolerance: the frameworks sum convolution windows in
  different orders), the same accuracy, cross-entropy within rtol 1e-4;
- the HFA mismatch raises; ``evaluate`` without a model raises;
  cross-entropy reads between 0 and 30;
- ``save``/``load`` round trip: bitwise; ``load`` overwrites the servers
  (a zero-gradient round pulls back the restored weights, rtol 1e-6 as
  the JAX test);
- a JAX checkpoint (flax msgpack, written by the JAX ``save_params``)
  read on the JAX side and carried through ``convert.flax_to_torch``:
  the port's ``save`` and ``load`` keep it bitwise, and converting back
  gives the JAX leaves bitwise.
"""

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
from geomx_tpu.training import Trainer as JTrainer
from geomx_tpu.training import load_params as j_load_params
from geomx_tpu.training import save_params as j_save_params
from geomx_tpu.utils import metrics as jmetrics
from geomx_tpu_torch.convert import flax_to_torch, torch_to_flax
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.data import ShardedIterator
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.models.cnn import create_cnn_state
from geomx_tpu_torch.training import Trainer, load_params, save_params
from geomx_tpu_torch.utils import metrics

OPT = {"type": "sgd", "lr": 0.05}


def _sim(**kw):
    return Simulation(Config(topology=Topology(num_parties=1,
                                               workers_per_party=1),
                             merge_backend="torch:cpu", **kw))


def _cnn():
    model, _, grad_fn = create_cnn_state(seed=0, device="cpu",
                                         compute_dtype=torch.float32)
    _, jparams, _ = j_create_cnn_state(jax.random.PRNGKey(0),
                                       compute_dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return model, flax_to_torch(jparams), grad_fn


def _bits(params):
    return [t.numpy().tobytes() for t in params.values()]


def test_fit_and_evaluate_close_to_jax():
    x, y = synthetic_classification(n=256, seed=0)
    jmodel, jparams, j_grad = j_create_cnn_state(jax.random.PRNGKey(0),
                                                 compute_dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    jsim = JSimulation(JConfig(topology=JTopology(num_parties=1,
                                                  workers_per_party=1),
                               merge_backend="numpy"))
    try:
        jt = JTrainer(jsim.worker(0, 0), jparams, j_grad, model=jmodel,
                      optimizer=OPT)
        jhist = jt.fit(JShardedIterator(x, y, 32, 0, 1, seed=0), steps=3)
        jacc = jt.evaluate(JShardedIterator(x, y, 64, 0, 1, seed=1), 2)
        jce = jt.evaluate(JShardedIterator(x, y, 64, 0, 1, seed=1), 2,
                          metric=jmetrics.create("ce"))
        jfinal = jax.tree_util.tree_map(np.asarray, jt.params)
    finally:
        jsim.shutdown()

    model, params, grad_fn = _cnn()
    sim = _sim()
    try:
        t = Trainer(sim.worker(0, 0), params, grad_fn, model=model,
                    optimizer=OPT)
        hist = t.fit(ShardedIterator(x, y, 32, 0, 1, seed=0), steps=3)
        acc = t.evaluate(ShardedIterator(x, y, 64, 0, 1, seed=1), 2)
        ce = t.evaluate(ShardedIterator(x, y, 64, 0, 1, seed=1), 2,
                        metric=metrics.create("ce"))
        final = torch_to_flax(t.params)
        stats = sim.global_servers[0].stats()
    finally:
        sim.shutdown()

    np.testing.assert_allclose([l for l, _ in hist], [l for l, _ in jhist],
                               rtol=1e-5)
    for mod, leaves in jfinal["params"].items():
        for kind, a in leaves.items():
            np.testing.assert_allclose(final["params"][mod][kind], a,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{mod}.{kind}")
    assert acc == jacc and acc[0] == "accuracy"
    assert ce[0] == jce[0] == "cross-entropy"
    np.testing.assert_allclose(ce[1], jce[1], rtol=1e-4)
    assert stats["opt_device"] == "sgd"            # device optimizer ran


def test_trainer_rejects_hfa_mismatch():
    sim = _sim()
    try:
        with pytest.raises(ValueError, match="use_hfa"):
            Trainer(sim.worker(0, 0), {}, lambda *a: None, hfa_k1=2)
    finally:
        sim.shutdown()


def test_trainer_evaluate_requires_model():
    sim = _sim()
    try:
        t = Trainer(sim.worker(0, 0), {}, lambda *a: None)
        with pytest.raises(ValueError, match="needs the model"):
            t.evaluate(iter([]), 1)
    finally:
        sim.shutdown()


def test_evaluate_cross_entropy_gets_probabilities():
    x, y = synthetic_classification(n=64, seed=0)
    model, params, grad_fn = _cnn()
    sim = _sim()
    try:
        t = Trainer(sim.worker(0, 0), params, grad_fn, model=model)
        name, ce = t.evaluate(ShardedIterator(x, y, 32, 0, 1), 2,
                              metric=metrics.create("ce"))
    finally:
        sim.shutdown()
    assert name == "cross-entropy" and 0.0 < ce < 30.0


def test_save_load_params_roundtrip(tmp_path):
    _, params, _ = _cnn()
    p = str(tmp_path / "w.pt")
    save_params(p, params)
    back = load_params(p, "cpu")
    assert list(back) == list(params)
    assert _bits(back) == _bits(params)


def test_trainer_load_propagates_to_servers(tmp_path):
    x, y = synthetic_classification(n=128, seed=0)
    model, params, grad_fn = _cnn()
    sim = _sim()
    try:
        kv = sim.worker(0, 0)
        t = Trainer(kv, params, grad_fn, model=model, optimizer=OPT)
        ckpt = str(tmp_path / "w.pt")
        t.save(ckpt)                      # snapshot the initial weights
        t.fit(ShardedIterator(x, y, 32, 0, 1), steps=3)  # servers move on
        assert _bits(t.params) != _bits(params)
        t.load(ckpt)                      # restore them everywhere
        assert _bits(t.params) == _bits(params)
        # a zero-gradient round pulls back exactly the restored weights
        first = next(iter(params.values())).numpy().ravel()
        kv.push(0, np.zeros_like(first))
        np.testing.assert_allclose(kv.pull_sync(0), first, rtol=1e-6)
    finally:
        sim.shutdown()


def test_jax_checkpoint_cross_loads(tmp_path):
    """JAX ``save_params`` (flax msgpack) → JAX ``load_params`` →
    ``convert.flax_to_torch`` → the port's ``save``/``load``: bitwise,
    and back through ``torch_to_flax`` to the JAX leaves."""
    _, jparams, _ = j_create_cnn_state(jax.random.PRNGKey(5),
                                       compute_dtype=jnp.float32)
    jfile = str(tmp_path / "w.msgpack")
    j_save_params(jfile, jparams)
    tree = j_load_params(jfile)
    params = flax_to_torch(tree)
    sim = _sim()
    try:
        t = Trainer(sim.worker(0, 0), params, lambda *a: None)
        pfile = str(tmp_path / "w.pt")
        t.save(pfile)
        t.params = {n: torch.zeros_like(v) for n, v in params.items()}
        t.load(pfile)
    finally:
        sim.shutdown()
    assert _bits(t.params) == _bits(params)
    back = torch_to_flax(t.params)
    want = jax.tree_util.tree_map(np.asarray, jparams)
    for mod, leaves in want["params"].items():
        for kind, a in leaves.items():
            assert back["params"][mod][kind].tobytes() == a.tobytes(), \
                f"{mod}.{kind}"
