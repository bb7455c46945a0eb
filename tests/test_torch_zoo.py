"""The port's model zoo and ResNet against the JAX package's (CPU).

Each of the five families (MLP, VGG, MobileNet, SqueezeNet, ResNet) at
the JAX package's default widths on a 28 × 28 × 1 input (the CNN
example's shape) and on ResNet's own default 32 × 32 × 3: the leaf
names and order are JAX's ``tree_flatten`` order, weights cross through
``convert.flax_zoo_to_torch`` and back bitwise, and in f32 the logits
(rtol 1e-5, atol 1e-5 × the largest), the loss (rtol 1e-5) and the
accuracy (exact) equal JAX's, and
every gradient lies within rtol 1e-5, atol 1e-5 × the leaf's largest
entry (the libraries sum convolution windows and the batch in other
orders) of JAX's.  flax's ``"SAME"`` padding at stride 2 is shown to
differ from torch's symmetric ``padding=1``; the registry refuses an
unknown name; the CNN example runs ``--model resnet`` on the CPU.

A ReLU makes the gradient discontinuous, so an input within rounding of
0 may take either side in f32: at these weights XLA's f32 SqueezeNet
gradient of ``Conv_0`` leaves JAX's own float64 gradient by 4.5e-3 × its
largest entry (ResNet's ``ResBlock_1.Conv_0`` by 5.2e-4 at
``PRNGKey(1)``), while the port's f32 gradients stay within 2e-6 of it.
So each gradient is held to JAX's float64 gradient (the same flax
function under ``jax.enable_x64``), and to JAX's f32 gradient wherever
that one agrees with JAX's float64 within the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.models import MODEL_REGISTRY as J_REGISTRY
from geomx_tpu_torch.convert import flax_zoo_to_torch, torch_zoo_to_flax
from geomx_tpu_torch.models import MODEL_REGISTRY, create_model_state
from geomx_tpu_torch.models import common as C

FAMILIES = ["mlp", "vgg", "mobilenet", "squeezenet", "resnet"]
SHAPES = [(name, (1, 28, 28, 1)) for name in FAMILIES] + [
    ("resnet", (1, 32, 32, 3))]
RTOL, ATOL_FRAC = 1e-5, 1e-5


def _jax_names(tree):
    """Port-style names of JAX's leaves (``kernel`` → ``weight``), in
    ``tree_flatten`` order."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
        parts = [str(k.key) for k in path]
        if parts[-1] == "kernel":
            parts[-1] = "weight"
        out.append(".".join(parts))
    return out


_CACHE: dict = {}


def _jax_family(name, shape):
    """JAX's (params as numpy, f32 grad_fn, model), built once per
    case."""
    if (name, shape) not in _CACHE:
        model, params, grad_fn = J_REGISTRY[name](
            jax.random.PRNGKey(0), input_shape=shape,
            compute_dtype=jnp.float32)
        _CACHE[name, shape] = (jax.tree_util.tree_map(np.asarray, params),
                               grad_fn, model)
    return _CACHE[name, shape]


def _port(name, shape, dtype=torch.float32):
    return create_model_state(name, 0, input_shape=shape,
                              compute_dtype=dtype, device="cpu")


def _batch(shape, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *shape[1:])).astype(np.float32)
    return x, rng.integers(0, 10, n).astype(np.int32)


@pytest.mark.parametrize("name,shape", SHAPES)
def test_leaf_names_order_and_shapes_equal_jax(name, shape):
    jparams = _jax_family(name, shape)[0]
    model, params, _ = _port(name, shape)
    assert list(params) == _jax_names(jparams)
    got = flax_zoo_to_torch(jparams, model.flatten)
    assert list(got) == list(params)
    assert [t.shape for t in got.values()] == [t.shape
                                               for t in params.values()]
    assert all(t.dtype == torch.float32 for t in params.values())
    # flax's initial values: GroupNorm scales one, biases zero
    for n, t in params.items():
        if n.endswith(".scale"):
            assert torch.equal(t, torch.ones_like(t)), n
        if n.endswith(".bias"):
            assert not t.any(), n


@pytest.mark.parametrize("name,shape", SHAPES)
def test_convert_round_trip_is_bitwise(name, shape):
    jparams = _jax_family(name, shape)[0]
    model, _, _ = _port(name, shape)
    back = torch_zoo_to_flax(flax_zoo_to_torch(jparams, model.flatten),
                             model.flatten)
    a, sa = jax.tree_util.tree_flatten(jparams)
    b, sb = jax.tree_util.tree_flatten(back)
    assert sa == sb
    assert all(np.ascontiguousarray(x).tobytes() == y.tobytes()
               for x, y in zip(a, b))


@pytest.mark.parametrize("name,shape", SHAPES)
def test_loss_accuracy_and_gradients_match_jax_f32(name, shape):
    jparams, j_grad, j_model = _jax_family(name, shape)
    model, _, grad_fn = _port(name, shape)
    x, y = _batch(shape)
    j_loss, j_acc, j_grads = j_grad(jparams, x, y)
    params = flax_zoo_to_torch(jparams, model.flatten)
    want = np.asarray(j_model.apply(jparams, x))
    with torch.no_grad():
        logits = model.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, want, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(want).max())
    loss, acc, grads = grad_fn(params, x, y)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
    assert float(acc) == float(j_acc)
    back = flax_zoo_to_torch(jax.tree_util.tree_map(np.asarray, j_grads),
                             model.flatten)
    with jax.enable_x64(True):
        _, _, grad64 = J_REGISTRY[name](
            jax.random.PRNGKey(0), input_shape=shape,
            compute_dtype=jnp.float64)
        g64 = grad64(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jparams),
            x.astype(np.float64), y)[2]
        back64 = flax_zoo_to_torch(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), g64), model.flatten)
    assert list(back) == list(grads) == list(back64)

    def atol(want):
        return ATOL_FRAC * max(float(np.abs(want).max()), 1e-30)

    for n, g in grads.items():
        w64, w32 = back64[n].numpy(), back[n].numpy()
        np.testing.assert_allclose(g.numpy(), w64, rtol=RTOL,
                                   atol=atol(w64), err_msg=n)
        # unless JAX's f32 took the other side of a kink (this leaf or
        # one the backward passes through on its way here)
        if np.allclose(w32, w64, rtol=RTOL, atol=atol(w64)):
            np.testing.assert_allclose(g.numpy(), w32, rtol=RTOL,
                                       atol=atol(w32), err_msg=n)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_default_runs_and_keeps_f32_params(name):
    model, params, grad_fn = create_model_state(name, 0, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    x, y = _batch((1, 28, 28, 1) if name != "resnet" else (1, 32, 32, 3))
    loss, acc, grads = grad_fn(params, x, y)
    assert bool(torch.isfinite(loss)) and 0.0 <= float(acc) <= 1.0
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())


@pytest.mark.parametrize("name", ["mobilenet", "squeezenet", "resnet"])
def test_stride_two_padding_is_flax_same_not_symmetric(name, monkeypatch):
    """flax pads a stride-2 3×3 conv on an even input 0 before and 1
    after; torch's ``padding=1`` would pad 1 and 1 and shift every
    window.  With symmetric padding the logits leave JAX's."""
    shape = (1, 28, 28, 1)
    jparams, _, j_model = _jax_family(name, shape)
    model, _, _ = _port(name, shape)
    params = flax_zoo_to_torch(jparams, model.flatten)
    x, _ = _batch(shape)
    want = np.asarray(j_model.apply(jparams, x))
    got = model.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert C._same_pads(28, 3, 2) == (0, 1)
    monkeypatch.setattr(C, "_same_pads",
                        lambda size, k, stride: (k // 2, k // 2))
    sym = model.apply(params, torch.from_numpy(x)).numpy()
    assert np.abs(sym - want).max() > 1e-3


def test_registry_offers_jax_families_and_refuses_unknown():
    assert sorted(MODEL_REGISTRY) == sorted(J_REGISTRY)
    with pytest.raises(ValueError, match="unknown model 'alexnet'"):
        create_model_state("alexnet", 0, device="cpu")


def test_cnn_example_runs_resnet_on_cpu():
    from geomx_tpu_torch.examples.cnn import build_parser, main

    assert build_parser().parse_args(["--model", "squeezenet"]).model == \
        "squeezenet"
    assert main(["--device", "cpu", "--model", "resnet", "--steps", "2",
                 "--parties", "1", "--workers", "1", "--batch", "8"]) == 0
