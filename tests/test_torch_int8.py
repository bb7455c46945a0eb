"""The port's INT8 inference (``ops/int8.py``) against the JAX package's
(CPU), bitwise: ``round`` is half to even in both, ``x / scale`` one
IEEE division and the int8 × int8 product exact in int32, so ``q``,
``scale``, the matmul and the quantized MLP's logits are equal bit for
bit — at N = 10 (the MLP's last layer) and batch 5, the shapes the
card's ``torch._int_mm`` takes only padded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.models import create_model_state as j_create_model_state
from geomx_tpu.ops import int8 as J
from geomx_tpu_torch.convert import flax_zoo_to_torch
from geomx_tpu_torch.models import create_model_state
from geomx_tpu_torch.ops import int8 as P


def _x(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("shape,axis", [((5, 784), None), ((784, 10), 0),
                                        ((64, 32), None), ((64, 32), 0),
                                        ((3, 1), 0)])
def test_quantize_symmetric_is_bitwise(shape, axis):
    x = _x(shape)
    x[0, 0] = 0.5 * np.abs(x).max()     # a value that rounds half-way
    jq, js = J.quantize_symmetric(jnp.asarray(x), axis=axis)
    q, s = P.quantize_symmetric(torch.from_numpy(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == tuple(js.shape)
    assert _bits(q.numpy()) == _bits(jq) and _bits(s.numpy()) == _bits(js)
    np.testing.assert_array_equal(P.dequantize(q, s).numpy(),
                                  np.asarray(J.dequantize(jq, js)))


def test_quantize_zero_tensor_keeps_the_scale_floor():
    q, s = P.quantize_symmetric(torch.zeros(4, 8))
    assert not q.any() and float(s) == np.float32(1e-8) / np.float32(127.0)


@pytest.mark.parametrize("m,k,n", [(5, 784, 10), (32, 256, 128),
                                   (17, 8, 8), (1, 3, 1)])
def test_int8_matmul_is_bitwise(m, k, n):
    x, w = _x((m, k), 1), _x((k, n), 2)
    wq, ws = J.quantize_symmetric(jnp.asarray(w), axis=0)
    want = J.int8_matmul(jnp.asarray(x), wq, ws)
    got = P.int8_matmul(torch.from_numpy(x), torch.from_numpy(
        np.array(wq)), torch.from_numpy(np.array(ws)))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _bits(got.numpy()) == _bits(want)


def test_int8_products_pad_to_the_card_shapes(monkeypatch):
    """Every ``torch._int_mm`` call gets more than 16 rows and K, N
    multiples of 8 (the card's rules), zero-padded."""
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    x = torch.from_numpy(_x((5, 784)))
    wq, ws = P.quantize_symmetric(torch.from_numpy(_x((784, 10), 3)), axis=0)
    assert P.int8_matmul(x, wq, ws).shape == (5, 10)
    ((m, k), (k2, n)), = seen
    assert m > 16 and k == k2 and k % 8 == 0 and n % 8 == 0


@pytest.mark.parametrize("batch", [32, 5])
def test_quantized_mlp_logits_are_bitwise(batch):
    _, jparams, _ = j_create_model_state("mlp", jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    model, _, _ = create_model_state("mlp", 0, device="cpu")
    params = flax_zoo_to_torch(jparams, model.flatten)
    x = _x((batch, 28, 28, 1), 4, scale=1.0)
    want = jax.jit(J.make_quantized_mlp_apply())(
        J.quantize_dense_tree(jparams), jnp.asarray(x))
    qtree = P.quantize_dense_tree(params)
    jtree = J.quantize_dense_tree(jparams)["params"]
    for i in range(3):
        leaf = qtree[f"Dense_{i}.weight"]
        assert leaf["q"].dtype == torch.int8
        assert _bits(leaf["q"].numpy()) == _bits(jtree[f"Dense_{i}"]
                                                 ["kernel"]["q"])
        assert _bits(leaf["scale"].numpy()) == _bits(jtree[f"Dense_{i}"]
                                                     ["kernel"]["scale"])
    got = P.make_quantized_mlp_apply()(qtree, torch.from_numpy(x))
    assert got.shape == (batch, 10)
    assert _bits(got.numpy()) == _bits(want)


def test_quantized_mlp_keeps_a_trained_mlps_accuracy():
    """The JAX test's acceptance: int8 inference of an MLP trained 30
    SGD steps on the synthetic task keeps its accuracy within 0.03."""
    from geomx_tpu_torch.data import synthetic_classification

    model, params, grad_fn = create_model_state(
        "mlp", 0, input_shape=(1, 8, 8, 1), device="cpu")
    x, y = synthetic_classification(n=512, shape=(8, 8, 1), seed=0)
    for _ in range(30):
        _, _, grads = grad_fn(params, x[:128], y[:128])
        params = {k: v - 0.1 * grads[k] for k, v in params.items()}
    xs = torch.from_numpy(x)
    fp_acc = float((model.apply(params, xs).argmax(-1).numpy() == y).mean())
    q = P.make_quantized_mlp_apply()(P.quantize_dense_tree(params), xs)
    q_acc = float((q.argmax(-1).numpy() == y).mean())
    assert fp_acc > 0.8
    assert q_acc >= fp_acc - 0.03, (fp_acc, q_acc)
