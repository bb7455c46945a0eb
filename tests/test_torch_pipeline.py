"""The port's GPipe pipeline against the JAX package's (CPU).

The JAX side runs ``pipeline_apply`` / ``make_pp_apply`` in
``shard_map`` over ``pp`` (and ``dp``) axes of virtual CPU devices
(``tests/conftest.py``), jitted; the port runs the same schedule
single-controller on ``["cpu"] * n`` meshes.  Weights cross with
``convert.flax_pp_to_torch`` (the ``init_mlp_stack`` and
``init_pp_transformer`` trees), inputs come from numpy seeds, f32.

Tolerances (the packages sum the blocks' products in other orders):
the 8-block MLP stack's outputs (up to 6.6) and gradients (up to 41)
within 2e-5 × (1 + |JAX's value|) (measured worst 1.5e-6 and 7.9e-6);
the pipelined flagship's logits atol 5e-6 (measured 1.5e-6), loss rtol
1e-6 (measured equal) and gradients atol 2e-6 (measured 6.6e-7; every
value O(1) or below).  The port's pipeline
against its own unpipelined model: bitwise (the same ops in the same
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from geomx_tpu.models import transformer as JT
from geomx_tpu.parallel import make_mesh as j_make_mesh
from geomx_tpu.parallel import pipeline as JP
from geomx_tpu_torch.convert import flax_pp_to_torch, torch_pp_to_flax
from geomx_tpu_torch.models import transformer as T
from geomx_tpu_torch.parallel import make_mesh
from geomx_tpu_torch.parallel import pipeline as TP

CFG = dict(vocab=64, d_model=16, n_heads=2, n_layers=4, d_ff=32,
           max_seq=32)


def _mlp_inputs():
    params = jax.tree_util.tree_map(
        np.asarray, JP.init_mlp_stack(jax.random.PRNGKey(0), 8, 16, 32))
    x = np.random.default_rng(0).standard_normal((8, 4, 16)).astype(
        np.float32)
    w = np.random.default_rng(1).standard_normal((8, 4, 16)).astype(
        np.float32)
    return params, x, w


@pytest.mark.parametrize("axes,dp_axis", [({"pp": 4}, None),
                                          ({"pp": 2, "dp": 2}, "dp")])
def test_pipeline_apply_matches_jax(axes, dp_axis):
    params, x, w = _mlp_inputs()
    jmesh = j_make_mesh(axes, jax.devices()[:4])

    def jloss(p):
        out = JP.pipeline_apply(jmesh, JP.mlp_block, p, x, dp_axis=dp_axis)
        return jnp.sum(out * w), out

    (_, j_out), j_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    mesh = make_mesh(axes, devices=["cpu"] * 4)
    p = {n: t.requires_grad_(True)
         for n, t in flax_pp_to_torch(params).items()}
    out = TP.pipeline_apply(mesh, TP.mlp_block, p, torch.from_numpy(x),
                            dp_axis=dp_axis)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=2e-5, atol=2e-5)
    for n in p:
        np.testing.assert_allclose(p[n].grad.numpy(), np.asarray(j_g[n]),
                                   rtol=2e-5, atol=2e-5, err_msg=n)
    # the same math with no pipeline, bitwise
    seq = TP.sequential_apply({n: t.detach() for n, t in p.items()},
                              torch.from_numpy(x))
    assert torch.equal(seq, out.detach())


def test_pipeline_skips_bubbles_one_block_call_per_microbatch_and_layer():
    calls = []

    def block(p, h):
        calls.append(h.shape)
        return TP.mlp_block(p, h)

    params = TP.init_mlp_stack(torch.Generator().manual_seed(0), 8, 16, 32,
                               device="cpu")
    mesh = make_mesh({"pp": 4, "dp": 2}, devices=["cpu"] * 8)
    TP.pipeline_apply(mesh, block, params, torch.zeros(6, 4, 16),
                      dp_axis="dp")
    assert len(calls) == 2 * 6 * 8 and set(calls) == {(2, 16)}
    with pytest.raises(ValueError, match="do not split over pp"):
        TP.pipeline_apply(make_mesh({"pp": 3}, devices=["cpu"] * 3),
                          block, params, torch.zeros(2, 1, 16))


def _flagship(seed, axes, dp_axis, n_mb):
    jcfg = JT.TransformerConfig(**CFG, compute_dtype=jnp.float32)
    pp = jax.tree_util.tree_map(
        np.asarray, JP.init_pp_transformer(jcfg, jax.random.PRNGKey(seed)))
    tokens = np.random.default_rng(seed).integers(0, CFG["vocab"], (8, 32),
                                                  dtype=np.int32)
    jmesh = j_make_mesh(axes, jax.devices()[:int(np.prod(
        list(axes.values())))])
    shard = jax.tree_util.tree_map(
        lambda s: NamedSharding(jmesh, s), JP.pp_param_specs(pp),
        is_leaf=lambda x: isinstance(x, P))
    apply = JP.make_pp_apply(jcfg, jmesh, n_microbatches=n_mb,
                             dp_axis=dp_axis)

    def loss(p):
        logits = apply(p, tokens)
        return JT.token_cross_entropy(logits, tokens), logits

    (lj, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.device_put(pp, shard))
    return pp, tokens, float(lj), np.asarray(logits), flax_pp_to_torch(
        jax.tree_util.tree_map(np.asarray, g))


@pytest.mark.parametrize("axes,dp_axis,n_mb", [({"pp": 4}, None, 4),
                                               ({"pp": 2, "dp": 2}, "dp", 2)])
def test_make_pp_apply_matches_jax(axes, dp_axis, n_mb):
    pp, tokens, lj, logits_j, g_j = _flagship(1, axes, dp_axis, n_mb)
    cfg = T.TransformerConfig(**CFG, compute_dtype=torch.float32)
    mesh = make_mesh(axes, devices=["cpu"] * 4)
    p = {n: t.requires_grad_(True) for n, t in flax_pp_to_torch(pp).items()}
    assert list(p) == list(g_j) == list(TP.pp_param_specs(p))
    x = torch.from_numpy(tokens).long()
    logits = TP.make_pp_apply(cfg, mesh, n_mb, dp_axis=dp_axis)(p, x)
    loss = T.token_cross_entropy(logits, x)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), logits_j, atol=5e-6)
    np.testing.assert_allclose(float(loss.detach()), lj, rtol=1e-6)
    for n in p:
        np.testing.assert_allclose(p[n].grad.numpy(), g_j[n].numpy(),
                                   atol=2e-6, err_msg=n)


def test_init_pp_transformer_layout_specs_and_refusals():
    cfg = T.TransformerConfig(**CFG, compute_dtype=torch.float32)
    p = TP.init_pp_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = JP.init_pp_transformer(
        JT.TransformerConfig(**CFG), jax.random.PRNGKey(0))
    ref = flax_pp_to_torch(jax.tree_util.tree_map(np.asarray, jp))
    assert list(p) == list(ref)
    assert all(p[n].shape == ref[n].shape for n in p)
    specs = TP.pp_param_specs(p)
    jspecs = jax.tree_util.tree_leaves(JP.pp_param_specs(jp),
                                       is_leaf=lambda x: isinstance(x, P))
    assert list(specs.values()) == [tuple(s) for s in jspecs]
    back = torch_pp_to_flax(p)
    assert set(back) == set(jp) and set(back["layers"]) == set(jp["layers"])
    moe = T.TransformerConfig(**CFG, moe_every=2)
    for call in (lambda: TP.init_pp_transformer(moe, torch.Generator(),
                                                "cpu"),
                 lambda: TP.make_pp_apply(moe, make_mesh(
                     {"pp": 2}, devices=["cpu"] * 2), 2)):
        with pytest.raises(AssertionError, match="homogeneous layers"):
            call()
