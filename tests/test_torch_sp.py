"""The port's sequence parallelism against the JAX package's (CPU).

The JAX side runs ``shard_map`` over a 4-way ``sp`` axis of virtual CPU
devices (``tests/conftest.py``), jitted, with the Pallas block kernel in
TPU interpret mode; the port runs the same program single-controller on
``make_mesh({"dp": 1, "sp": 4, "tp": 1}, devices=["cpu"] * 4)``, the
block through its plain version.  Inputs and weights come from numpy
seeds (weights cross with ``convert.flax_lm_to_torch``); everything is
f32.

Tolerances: ring and Ulysses outputs 1e-3 and gradients 2e-3 (rtol and
atol, as the JAX package's own ring tests hold them); the transformer's
logits atol 1e-4 and ``lm_loss`` gradients rtol/atol 1e-3 (the two
libraries sum in other orders; every value is O(1) or below); ``remat``
changes nothing on the port's side (the same ops run again), so it is
held to the non-remat run at 1e-6.  MoE layers (dense routing and
top-k) on the ring: logits atol 1e-4, loss rtol 1e-5, gradients
rtol/atol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from geomx_tpu.compat import force_tpu_interpret_mode, shard_map
from geomx_tpu.models import transformer as JT
from geomx_tpu.parallel import make_mesh as j_make_mesh
from geomx_tpu.parallel.ring_attention import ring_attention as j_ring
from geomx_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from geomx_tpu_torch.convert import flax_lm_to_torch
from geomx_tpu_torch.models import transformer as T
from geomx_tpu_torch.parallel import (make_mesh, ring_attention,
                                      ulysses_attention)

AXES = {"dp": 1, "sp": 4, "tp": 1}
SP = AXES["sp"]
B, TG, H, D = 2, 64, 4, 32      # global sequence TG, TG / SP per rank
WIDTHS = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
              max_seq=32)


@pytest.fixture(scope="module")
def meshes():
    return j_make_mesh(AXES), make_mesh(AXES, devices=["cpu"] * SP)


def _np(shape, seed, n=1):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    return out if n > 1 else out[0]


def _split(x: torch.Tensor):
    return list(torch.chunk(x, SP, dim=1))


# ---- the mesh ------------------------------------------------------------

def test_make_mesh_counts_devices_and_orders_ranks_as_jax():
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 2"):
        make_mesh(AXES, devices=["cpu"] * 2)
    mesh = make_mesh({"dp": 2, "sp": 3, "tp": 2}, devices=["cpu"] * 12)
    assert mesh.axis_names == ("dp", "sp", "tp") and mesh.size == 12
    assert mesh.axis_size("sp") == 3
    # row-major, as JAX reshapes its device array
    ids = np.arange(12).reshape(2, 3, 2)
    for r in range(12):
        c = mesh.coords(r)
        assert ids[c["dp"], c["sp"], c["tp"]] == r == mesh.rank(**c)
    assert mesh.device(dp=1, sp=2, tp=1) == torch.device("cpu")
    assert len(mesh.axis_devices("sp", dp=1)) == 3
    # the first prod(sizes) devices, one device named several times
    assert make_mesh({"sp": 2}, devices=["cpu", "meta", "cpu"]).devices \
        == [torch.device("cpu"), torch.device("meta")]


# ---- ring attention and Ulysses -------------------------------------------

def _j_attn(kind, fast):
    if kind == "ring":
        return lambda a, b, c: j_ring(a, b, c, axis_name="sp",
                                      axis_size=SP, causal=True, fast=fast)
    return lambda a, b, c: j_ulysses(a, b, c, axis_name="sp", causal=True,
                                     fast=fast)


CASES = [("ring", False), ("ring", True), ("ring", "flash"),
         ("ulysses", False), ("ulysses", True)]


@pytest.mark.parametrize("kind,fast", CASES)
def test_sp_attention_matches_jax_shard_map(meshes, kind, fast):
    jmesh, mesh = meshes
    q, k, v, w = _np((B, TG, H, D), seed=len(kind) + 2 * bool(fast), n=4)
    spec = P(None, "sp", None, None)
    f = shard_map(_j_attn(kind, fast), mesh=jmesh, in_specs=(spec,) * 3,
                  out_specs=spec, check_vma=False)

    def loss(a, b, c):
        out = f(a, b, c)
        return jnp.sum(out * w), out

    with force_tpu_interpret_mode():
        (_, j_out), j_g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    fn = ring_attention if kind == "ring" else ulysses_attention
    outs = fn(_split(tq), _split(tk), _split(tv), mesh, causal=True,
              fast=fast)
    assert len(outs) == SP and all(o.shape == (B, TG // SP, H, D)
                                   for o in outs)
    out = torch.cat(outs, dim=1)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-3, atol=1e-3)
    for t, g, name in zip((tq, tk, tv), j_g, "qkv"):
        assert bool(torch.isfinite(t.grad).all()), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-3,
                                   atol=2e-3, err_msg=f"d{name}")


def test_ring_flash_launches_one_block_per_rank_and_hop(meshes,
                                                        monkeypatch):
    """``fast="flash"`` computes sp² blocks a call, each with the offsets
    of its (rank, hop): rank r's queries at r·T against the block that
    started on (r + hop) mod sp."""
    from geomx_tpu_torch.ops import block_attention as BA

    seen = []
    real = BA.block_attention_fwd

    def spy(q, k, v, offs, causal):
        seen.append(offs)
        return real(q, k, v, offs, causal)

    monkeypatch.setattr(BA, "block_attention_fwd", spy)
    x = [torch.zeros(1, 4, 1, 8) for _ in range(SP)]
    ring_attention(x, x, x, meshes[1], fast="flash")
    assert seen == [(r * 4, ((r + i) % SP) * 4)
                    for i in range(SP) for r in range(SP)]


def test_ulysses_needs_heads_divisible_by_sp(meshes):
    x = [torch.zeros(1, 4, 6, 8) for _ in range(SP)]
    with pytest.raises(ValueError, match="divisible by the 'sp' axis size"):
        ulysses_attention(x, x, x, meshes[1])
    with pytest.raises(ValueError, match="one shard per rank"):
        ring_attention(x[:3], x[:3], x[:3], meshes[1])


# ---- the transformer over the mesh ----------------------------------------

@pytest.fixture(scope="module")
def lm():
    """JAX weights (numpy) and tokens shared by the transformer tests."""
    jcfg = JT.TransformerConfig(**WIDTHS, compute_dtype=jnp.float32)
    p = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, WIDTHS["vocab"], (B, WIDTHS["max_seq"]), dtype=np.int32)
    return jax.tree_util.tree_map(np.asarray, p), tokens


def _j_step(jmesh, jparams, tokens, **cfg):
    """JAX logits and lm_loss gradients on the sp mesh, jitted."""
    jcfg = JT.TransformerConfig(**WIDTHS, compute_dtype=jnp.float32, **cfg)
    apply = JT.make_apply(jcfg, jmesh)

    def loss(p):
        logits = apply(p, tokens)
        return JT.token_cross_entropy(logits, tokens), logits

    with force_tpu_interpret_mode():
        (_, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jparams)
    return np.asarray(logits), flax_lm_to_torch(
        jax.tree_util.tree_map(np.asarray, g))


def _t_step(mesh, params, tokens, **cfg):
    tcfg = T.TransformerConfig(**WIDTHS, compute_dtype=torch.float32, **cfg)
    logits = T.make_apply(tcfg, mesh)(params, torch.from_numpy(tokens).long())
    _, _, grads = T.make_lm_grad_fn(tcfg, mesh)(params, tokens)
    return logits.detach().numpy(), grads


@pytest.mark.parametrize("impl,sp_attn", [
    ("dense", "ring"), ("fast", "ring"), ("flash", "ring"),
    ("fast", "ulysses")])
def test_make_apply_on_the_sp_mesh_matches_jax(meshes, lm, impl, sp_attn):
    jparams, tokens = lm
    j_logits, j_grads = _j_step(meshes[0], jparams, tokens, attn_impl=impl,
                                sp_attn=sp_attn)
    logits, grads = _t_step(meshes[1], flax_lm_to_torch(jparams), tokens,
                            attn_impl=impl, sp_attn=sp_attn)
    np.testing.assert_allclose(logits, j_logits, atol=1e-4)
    assert list(grads) == list(j_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("impl", ["fast", "flash"])
def test_remat_equals_no_remat_and_jax_remat(meshes, lm, impl):
    """The port's remat against its own run without, for the ring's
    einsum blocks and its block kernel; JAX's remat on the ``fast``
    ring (``jax.checkpoint`` cannot take the interpret-mode Pallas
    kernel: its IO callbacks are effects remat refuses)."""
    jparams, tokens = lm
    params = flax_lm_to_torch(jparams)
    cfg = dict(attn_impl=impl, sp_attn="ring")
    logits, grads = _t_step(meshes[1], params, tokens, remat=True, **cfg)
    logits0, grads0 = _t_step(meshes[1], params, tokens, remat=False, **cfg)
    np.testing.assert_allclose(logits, logits0, rtol=1e-6, atol=1e-6)
    for name in grads:
        np.testing.assert_allclose(grads[name].numpy(), grads0[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    if impl == "flash":
        return
    j_logits, j_grads = _j_step(meshes[0], jparams, tokens, remat=True,
                                **cfg)
    np.testing.assert_allclose(logits, j_logits, atol=1e-4)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    # remat on one device too
    single = T.TransformerConfig(**WIDTHS, compute_dtype=torch.float32,
                                 attn_impl=impl, remat=True)
    loss, _, g1 = T.make_lm_grad_fn(single)(params, tokens)
    loss0, _, g0 = T.make_lm_grad_fn(
        dataclasses.replace(single, remat=False))(params, tokens)
    assert float(loss) == float(loss0)
    assert all(torch.allclose(g1[n], g0[n], rtol=1e-6, atol=1e-6)
               for n in g0)


def test_sp_size_one_takes_the_single_device_path(lm):
    jparams, tokens = lm
    params = flax_lm_to_torch(jparams)
    cfg = T.TransformerConfig(**WIDTHS, compute_dtype=torch.float32)
    x = torch.from_numpy(tokens).long()
    one = make_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=["cpu"])
    assert torch.equal(T.make_apply(cfg, one)(params, x),
                       T.make_apply(cfg)(params, x))


def test_sp_refusals(lm):
    jparams, tokens = lm
    params = flax_lm_to_torch(jparams)
    cfg = T.TransformerConfig(**WIDTHS, compute_dtype=torch.float32)
    cpu = ["cpu"] * 8
    for axes in ({"dp": 2, "sp": 4, "tp": 1}, {"dp": 1, "sp": 4, "tp": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            T.make_apply(cfg, make_mesh(axes, devices=cpu))
    with pytest.raises(ValueError, match="dp, sp and tp"):
        T.make_apply(cfg, make_mesh({"sp": 4}, devices=cpu))
    # MoE layers are no refusal: the layer forward is shared and the
    # shards are joined before the FFN (matched to JAX below)
    moe = dataclasses.replace(cfg, moe_every=1)
    assert T.make_apply(moe, make_mesh(AXES, devices=cpu))(
        T.init_params(moe, torch.Generator().manual_seed(0)),
        torch.from_numpy(tokens).long()).shape == (
            B, WIDTHS["max_seq"], WIDTHS["vocab"])
    # a sequence the sp axis does not divide
    apply = T.make_apply(cfg, make_mesh(AXES, devices=cpu))
    with pytest.raises(ValueError, match="not divisible"):
        apply(params, torch.from_numpy(tokens[:, :30]).long())


@pytest.mark.parametrize("top_k", [0, 2])
def test_moe_on_the_sp_mesh_matches_jax(meshes, lm, top_k):
    """MoE layers (dense routing and top-k, the aux folded into the loss)
    on the sp ring against JAX's ``make_apply(cfg, mesh)``."""
    moe = dict(moe_every=1, n_experts=4, moe_top_k=top_k)
    jcfg = JT.TransformerConfig(**WIDTHS, compute_dtype=jnp.float32, **moe)
    jparams = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    _, tokens = lm
    apply = JT.make_apply(jcfg, meshes[0], return_aux=True)

    def loss(p):
        logits, aux = apply(p, tokens)
        return (JT.token_cross_entropy(logits, tokens)
                + JT.AUX_COEF * aux), logits

    with force_tpu_interpret_mode():
        (j_loss, j_logits), j_g = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(jparams)
    j_grads = flax_lm_to_torch(jax.tree_util.tree_map(np.asarray, j_g))
    tcfg = T.TransformerConfig(**WIDTHS, compute_dtype=torch.float32, **moe)
    params = flax_lm_to_torch(jparams)
    logits, _ = T.make_apply(tcfg, meshes[1], return_aux=True)(
        params, torch.from_numpy(tokens).long())
    t_loss, _, grads = T.make_lm_grad_fn(tcfg, meshes[1])(params, tokens)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert list(grads) == list(j_grads)
    assert "layers.0.router" in grads
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
