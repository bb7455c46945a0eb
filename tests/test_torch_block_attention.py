"""The port's block attention (one ring hop's partial block) against the
JAX package's (CPU), and its CUDA kernel against its plain version (card
only).

The JAX side is ``geomx_tpu.ops.block_attention.flash_block_attention``
with its Pallas kernel in TPU interpret mode, and its custom VJP (the
gradient of the einsum reference); the port's side on the CPU is
``block_attention_ref`` through the ``BlockAttention`` autograd
Function.  Inputs come from numpy seeds.

Geometries: the three ring hops the offsets encode — diagonal (the
causal triangle), below the diagonal (fully visible), above it (fully
masked: m = -1e30, l = Tk, o = sum of v) — and non-causal.

Tolerances: f32 m and l rtol 1e-5, o rtol 1e-4 (atol alike; the two
sides sum in other orders); bf16 2e-2 relative to the largest entry
(the products are exact in f32 on both sides, but ``p`` is rounded to
bf16 after an ``exp`` that may differ by an f32 ulp); gradients
rtol/atol 1e-3, as the JAX package's own test holds its VJP.  On the
card (``cuda`` marker): kernel against plain version, f32 1e-4 and
bf16 2e-2, each times max(1, the largest unmasked reference entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.compat import force_tpu_interpret_mode
from geomx_tpu.ops.block_attention import (
    flash_block_attention as j_flash_block)
from geomx_tpu_torch.ops import block_attention as BA
from geomx_tpu_torch.ops.kernels import block_attention as K

B, T, H, D = 2, 32, 2, 64
# (q_off, k_off, causal) of each geometry
GEOMETRIES = {"diagonal": (0, 0, True), "below": (T, 0, True),
              "above": (0, T, True), "noncausal": (0, 0, False)}


def _np(shape=(B, T, H, D), seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _as(x, dtype):
    t = torch.from_numpy(x)
    return t.bfloat16() if dtype == "bfloat16" else t


def _jas(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


@pytest.fixture(scope="module")
def j_block():
    """JAX's block attention, jitted once (offsets are runtime data)."""
    fwd = jax.jit(j_flash_block, static_argnums=4)

    def loss(q, k, v, offs, w, causal):
        m, l, o = j_flash_block(q, k, v, offs, causal)
        return (jnp.sum(m * w[0]) + jnp.sum(l * w[1])
                + jnp.sum(o * w[2][..., None]))

    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)), static_argnums=5)

    def run(fn, *args):
        with force_tpu_interpret_mode():
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), fn(*args))

    return (lambda *a: run(fwd, *a)), (lambda *a: run(grad, *a))


@pytest.mark.parametrize("geo", list(GEOMETRIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_block_matches_jax_pallas_interpret(j_block, geo, dtype):
    qo, ko, causal = GEOMETRIES[geo]
    q, k, v = _np(seed=len(geo))
    jm, jl, jo = j_block[0](*(_jas(a, dtype) for a in (q, k, v)),
                            jnp.array([qo, ko], jnp.int32), causal)
    m, l, o = BA.flash_block_attention(*(_as(a, dtype) for a in (q, k, v)),
                                       (qo, ko), causal)
    assert all(t.dtype == torch.float32 for t in (m, l, o))
    assert m.shape == l.shape == (B, T, H) and o.shape == (B, T, H, D)
    m, l, o = (t.numpy() for t in (m, l, o))
    if dtype == "float32":
        np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(l, jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o, jo, rtol=1e-4, atol=1e-4)
    else:
        for got, ref in ((m, jm), (l, jl), (o, jo)):
            live = ref > -1e29
            assert np.array_equal(got[~live], ref[~live])
            scale = max(1.0, float(np.abs(ref[live]).max(initial=0.0)))
            assert np.max(np.abs(got[live] - ref[live]),
                          initial=0.0) <= 2e-2 * scale
    if geo == "above":   # fully masked: the junk the ring's merge wipes
        assert np.all(m == np.float32(-1e30)) and np.all(l == T)
        np.testing.assert_allclose(
            o, np.broadcast_to(_as(v, dtype).float().numpy()
                               .sum(1, keepdims=True), o.shape),
            rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("geo", [*GEOMETRIES, "ties"])
def test_block_grads_match_jax_custom_vjp(j_block, geo):
    """The backward (recompute through the plain version) against JAX's
    custom VJP, the fully masked hop included.  ``ties``: q = 0 makes
    every visible score of a row equal, so the gradient of m depends on
    how the maximum's gradient is split: evenly, as ``jnp.max``."""
    qo, ko, causal = GEOMETRIES.get(geo, (0, 0, True))
    q, k, v = _np(seed=11)
    if geo == "ties":
        q = np.zeros_like(q)
    w = _np((B, T, H), seed=12)
    jg = j_block[1](*(jnp.asarray(a) for a in (q, k, v)),
                    jnp.array([qo, ko], jnp.int32),
                    [jnp.asarray(a) for a in w], causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    m, l, o = BA.flash_block_attention(tq, tk, tv, (qo, ko), causal)
    tw = [torch.from_numpy(a) for a in w]
    ((m * tw[0]).sum() + (l * tw[1]).sum()
     + (o * tw[2][..., None]).sum()).backward()
    for t, g, name in zip((tq, tk, tv), jg, "qkv"):
        assert bool(torch.isfinite(t.grad).all()), name
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-3, atol=1e-3,
                                   err_msg=f"d{name} ({geo})")


def test_kernel_wrapper_checks_its_arguments():
    before = K.launches()
    q = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        K.block_attn_fwd(q, q, q, (0, 0))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.block_attn_fwd(q.half(), q.half(), q.half(), (0, 0))
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 4, 1, 32)
        K.block_attn_fwd(z, z, z, (0, 0))
    with pytest.raises(ValueError, match="no keys"):
        K.block_attn_fwd(q, q[:, :0], q[:, :0], (0, 0))
    with pytest.raises(ValueError, match=r"\[B, T, H, D\]"):
        K.block_attn_fwd(torch.zeros(4, 64), q, q, (0, 0))
    assert K.launches() == before   # nothing launched, nothing counted


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v = (torch.from_numpy(a) for a in _np((1, 8, 2, 64), seed=5))
    before = K.launches()
    got = BA.block_attention_fwd(q, k, v, (8, 0), True)
    ref = BA.block_attention_ref(q, k, v, (8, 0), True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert K.launches() == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the block kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 16, 128), (8, 32, 6, 64),
                                   (2, 250, 3, 64), (1, 1, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(card, shape, dtype):
    t = shape[1]
    q, k, v = (_as(a, dtype).to(card) for a in _np(shape, seed=3))
    tol = 1e-4 if dtype == "float32" else 2e-2
    for qo, ko, causal in ((0, 0, True), (t, 0, True), (0, t, True),
                           (0, 0, False)):
        before = K.launches()["block_attn_fwd"]
        got = K.block_attn_fwd(q, k, v, (qo, ko), causal)
        assert K.launches()["block_attn_fwd"] == before + 1
        ref = BA.block_attention_ref(q, k, v, (qo, ko), causal)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            live = r > -1e29
            assert torch.equal(g[~live], r[~live])
            scale = max(1.0, float(r[live].abs().max())) \
                if bool(live.any()) else 1.0
            assert float((g[live] - r[live]).abs().max()
                         if bool(live.any()) else 0.0) <= tol * scale
