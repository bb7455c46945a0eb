"""The port's CNN against the JAX package's (CPU).

Weights cross through ``geomx_tpu_torch.convert``; both sides compute in
float32 (the JAX model with ``compute_dtype=float32``), so loss,
accuracy and gradients agree within rtol 1e-5 (atol 1e-7 for gradient
entries that are sums cancelling to ~0: the two libraries add the batch
and the convolution windows in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.models.cnn import create_cnn_state as j_create_cnn_state
from geomx_tpu.training import flatten_params as j_flatten
from geomx_tpu_torch.convert import flax_to_torch, torch_to_flax
from geomx_tpu_torch.models import create_model_state
from geomx_tpu_torch.models.cnn import create_cnn_state
from geomx_tpu_torch.training import flatten_params, unflatten_params

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module")
def jax_cnn():
    model, params, grad_fn = j_create_cnn_state(
        jax.random.PRNGKey(3), compute_dtype=jnp.float32)
    return model, jax.tree_util.tree_map(np.asarray, params), grad_fn


def _batch(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def test_full_width_parameter_count_and_leaf_order(jax_cnn):
    _, jparams, _ = jax_cnn
    _, params, _ = create_cnn_state(seed=0, device="cpu")
    assert sum(p.numel() for p in params.values()) == 429_258
    assert max(p.numel() for p in params.values()) == 401_408
    # key ids agree: same leaf order and sizes as the JAX flatten order
    j_leaves, _ = j_flatten(jparams)
    leaves, _ = flatten_params(params)
    assert [a.size for a in leaves] == [a.size for a in j_leaves]
    assert list(params) == sorted(params)


def test_convert_round_trip_is_exact(jax_cnn):
    _, jparams, _ = jax_cnn
    back = torch_to_flax(flax_to_torch(jparams))
    for mod, leaves in jparams["params"].items():
        for kind, a in leaves.items():
            assert back["params"][mod][kind].tobytes() == \
                np.ascontiguousarray(a).tobytes(), (mod, kind)


def test_loss_accuracy_and_gradients_match_jax_f32(jax_cnn):
    _, jparams, j_grad = jax_cnn
    x, y = _batch()
    j_loss, j_acc, j_grads = j_grad(jparams, x, y)
    model, _, grad_fn = create_cnn_state(seed=0, device="cpu",
                                         compute_dtype=torch.float32)
    params = flax_to_torch(jparams)
    loss, acc, grads = grad_fn(params, x, y)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
    assert float(acc) == float(j_acc)
    back = torch_to_flax(grads)
    j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
    for mod, leaves in j_grads["params"].items():
        for kind, g in leaves.items():
            np.testing.assert_allclose(back["params"][mod][kind], g,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{mod}.{kind}")


def test_bf16_default_runs_and_keeps_f32_master_params():
    model, params, grad_fn = create_model_state("cnn", 0, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in params.values())
    x, y = _batch(8)
    loss, acc, grads = grad_fn(params, x, y)
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0
    assert all(grads[k].dtype == torch.float32 and grads[k].shape == v.shape
               for k, v in params.items())


def test_flatten_unflatten_round_trip():
    _, params, _ = create_cnn_state(seed=1, device="cpu")
    leaves, treedef = flatten_params(params)
    again = unflatten_params(treedef, leaves)
    assert list(again) == list(params)
    assert all(torch.equal(again[k], params[k]) for k in params)
    # the rebuilt tensors never alias the host leaves
    leaves[0][...] = 7.0
    assert not torch.equal(again[list(params)[0]],
                           torch.full_like(again[list(params)[0]], 7.0))


def test_seeded_init_is_deterministic():
    _, a, _ = create_cnn_state(seed=5, device="cpu")
    _, b, _ = create_cnn_state(seed=5, device="cpu")
    _, c, _ = create_cnn_state(seed=6, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Dense_0.weight"], c["Dense_0.weight"])
