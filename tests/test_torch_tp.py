"""The port's tensor (and expert) parallel flagship against the JAX
package's GSPMD step (CPU).

The JAX side places the weights with ``param_specs`` on a ``dp × sp ×
tp`` mesh of virtual CPU devices (``tests/conftest.py``) and jits
``value_and_grad`` of the LM loss (with the MoE aux where top-k layers
train with it); the port runs ``make_lm_grad_fn(cfg, mesh)`` single-
controller on ``make_mesh(axes, devices=["cpu"] * n)``.  Weights cross
with ``convert.flax_lm_to_torch``, tokens come from a numpy seed, all in
f32, attention ``dense`` (the ring's f32 blocks when ``sp > 1``).

Tolerances (the packages sum the tp partials, the softmax and the
embedding scatter in other orders): loss rtol 1e-6 (measured worst
over the nine cases 1.1e-7), logits atol 1e-5 (measured 2.5e-7), every
gradient atol 2e-6 (measured 1.7e-7; values are O(1) or below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from geomx_tpu.models import transformer as JT
from geomx_tpu.parallel import make_mesh as j_make_mesh
from geomx_tpu_torch.convert import flax_lm_to_torch
from geomx_tpu_torch.models import transformer as T
from geomx_tpu_torch.parallel import make_mesh, named_sharding
from geomx_tpu_torch.parallel.mesh import (all_gather, all_to_all, axis_index,
                                           ppermute, psum)

WIDTHS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16)
MESHES = [{"dp": 1, "sp": 1, "tp": 2}, {"dp": 2, "sp": 1, "tp": 2},
          {"dp": 2, "sp": 2, "tp": 2}]
MOE = {"none": {}, "dense": dict(moe_every=2, n_experts=4, moe_top_k=0),
       "topk": dict(moe_every=2, n_experts=4, moe_top_k=2)}
BATCH = 4


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(
        0, WIDTHS["vocab"], (BATCH, WIDTHS["max_seq"]), dtype=np.int32)


def _jax_step(axes, moe, tokens):
    """JAX's GSPMD step: (loss, logits, grads as the port's dict)."""
    jcfg = JT.TransformerConfig(**WIDTHS, compute_dtype=jnp.float32,
                                attn_impl="dense", **moe)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, params)
    mesh = j_make_mesh(axes)
    shard = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), JT.param_specs(jcfg),
        is_leaf=lambda x: isinstance(x, P))
    apply = JT.make_apply(jcfg, mesh, return_aux=True)
    toks = jax.device_put(jnp.asarray(tokens),
                          NamedSharding(mesh, P("dp", "sp")))

    def loss(p):
        logits, aux = apply(p, toks)
        return (JT.token_cross_entropy(logits, toks)
                + JT.AUX_COEF * aux), logits

    (lj, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.device_put(params, shard))
    return (float(lj), np.asarray(logits), host,
            flax_lm_to_torch(jax.tree_util.tree_map(np.asarray, g)))


@pytest.mark.parametrize("moe", list(MOE))
@pytest.mark.parametrize(
    "axes", MESHES, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_grad_fn_on_the_mesh_matches_jax_gspmd(axes, moe):
    tokens = _tokens()
    lj, logits_j, host, grads_j = _jax_step(axes, MOE[moe], tokens)
    cfg = T.TransformerConfig(**WIDTHS, compute_dtype=torch.float32,
                              attn_impl="dense", **MOE[moe])
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=["cpu"] * n)
    params = flax_lm_to_torch(host)
    loss, acc, grads = T.make_lm_grad_fn(cfg, mesh)(params, tokens)
    with torch.no_grad():
        out = T.make_apply(cfg, mesh, return_aux=True)(
            params, torch.from_numpy(tokens).long())[0]
    np.testing.assert_allclose(float(loss), lj, rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), logits_j, atol=1e-5)
    assert 0.0 <= float(acc) <= 1.0
    assert list(grads) == list(grads_j)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads_j[name].numpy(),
                                   atol=2e-6, err_msg=name)


def test_param_specs_mirror_jax():
    for moe in MOE.values():
        jcfg = JT.TransformerConfig(**WIDTHS, **moe)
        cfg = T.TransformerConfig(**WIDTHS, **moe)
        flat = flax_lm_to_torch(jax.tree_util.tree_map(
            lambda s: np.zeros(()), JT.param_specs(jcfg),
            is_leaf=lambda x: isinstance(x, P)))
        specs = T.param_specs(cfg)
        assert list(specs) == list(flat)
        jspecs = jax.tree_util.tree_leaves(
            JT.param_specs(jcfg), is_leaf=lambda x: isinstance(x, P))
        assert [tuple(s) for s in jspecs] == list(specs.values())


def test_named_sharding_places_and_joins_and_sums_replicas():
    """A tp split over a dp × tp mesh: each rank's piece on its device;
    the join (shard's transpose) sums each piece's dp replicas, and so
    does the gradient of a piece."""
    mesh = make_mesh({"dp": 2, "tp": 2}, devices=["cpu"] * 4)
    x = torch.arange(24.0).reshape(4, 6).requires_grad_(True)
    sh = named_sharding(mesh, "tp", None)
    shards = sh.shard(x)
    assert [tuple(s.shape) for s in shards] == [(2, 6)] * 4
    assert torch.equal(shards[1], x[2:].detach())
    assert torch.equal(sh.join(shards), 2 * x.detach())
    sum((s * (r + 1)).sum() for r, s in enumerate(shards)).backward()
    assert torch.equal(x.grad[:2], torch.full((2, 6), 1.0 + 3.0))
    assert torch.equal(x.grad[2:], torch.full((2, 6), 2.0 + 4.0))
    with pytest.raises(ValueError, match="does not split"):
        named_sharding(mesh, None, "tp").shard(torch.zeros(2, 3))
    assert [axis_index(mesh, "tp", r) for r in range(4)] == [0, 1, 0, 1]


def test_collectives_over_one_axis():
    """psum (and its backward, a psum), all_gather, all_to_all and
    ppermute on per-rank lists, each rank's result on its device."""
    xs = [torch.full((2,), float(r + 1), requires_grad=True)
          for r in range(3)]
    out = psum(xs)
    assert all(torch.equal(o, torch.full((2,), 6.0)) for o in out)
    sum((o * (r + 1)).sum() for r, o in enumerate(out)).backward()
    assert all(torch.equal(x.grad, torch.full((2,), 6.0)) for x in xs)
    g = all_gather([torch.ones(1), torch.zeros(2)])
    assert all(torch.equal(t, torch.tensor([1.0, 0.0, 0.0])) for t in g)
    a2a = all_to_all([torch.arange(4.0), 10 + torch.arange(4.0)], 0, 0)
    assert [t.tolist() for t in a2a] == [[0, 1, 10, 11], [2, 3, 12, 13]]
    perm = ppermute([torch.ones(1), None, torch.zeros(1)],
                    [(0, 1), (1, 2), (2, 0)], [torch.device("cpu")] * 3)
    assert perm[0].item() == 0.0 and perm[1].item() == 1.0
    assert perm[2] is None


def test_mesh_refusals():
    cfg = T.TransformerConfig(**WIDTHS, compute_dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="n_heads = 4 does not split"):
        T.make_apply(cfg, make_mesh({"dp": 1, "sp": 1, "tp": 3},
                                    devices=["cpu"] * 3))
    apply = T.make_apply(cfg, make_mesh({"dp": 3, "sp": 1, "tp": 1},
                                        devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="batch 4 does not split"):
        apply(params, torch.from_numpy(_tokens()).long())
