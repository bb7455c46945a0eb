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
masked: m = -1e30, l = Tk, o = sum of v) — a block that straddles the
diagonal off the kernel's tile grid (rows fully masked, partly visible
and mixed within one tile), and non-causal; also Tq != Tk.

Tolerances: f32 m and l rtol 1e-5, o rtol 1e-4 (atol alike; the two
sides sum in other orders); bf16 2e-2 relative to the largest entry
(the products are exact in f32 on both sides, but ``p`` is rounded to
bf16 after an ``exp`` that may differ by an f32 ulp); gradients
rtol/atol 1e-3, as the JAX package's own test holds its VJP.  On the
card (``cuda`` marker): kernel against plain version, f32 1e-4 and
bf16 2e-2, each times max(1, the largest unmasked reference entry), and
a relative L2 of 1e-4 / 1e-2; fully masked rows exact.  The f32 kernel's
3xTF32 arithmetic is held against JAX on the CPU by
``tests/test_torch_attention_f32.py``.
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
              "above": (0, T, True), "straddle": (0, T // 2 + 3, True),
              "noncausal": (0, 0, False)}
# the kernel's key tile, and its query tiles (one or two warpgroups)
BN = 128
BMS = (64, 128)


def _geometries(tq, tk):
    """(q_off, k_off, causal) of each causal geometry for Tq x Tk."""
    return {"diagonal": (0, 0, True), "below": (tk, 0, True),
            "above": (0, tq, True), "straddle": (0, tq // 2 + 3, True)}


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


def _matches_jax(j_block, q, k, v, offs, causal, dtype):
    """The port's block (plain version, CPU) against JAX's Pallas kernel
    in interpret mode on the same numpy inputs; returns the port's
    ``(m, l, o)`` as numpy."""
    Tq, Tk = q.shape[1], k.shape[1]
    jm, jl, jo = j_block[0](*(_jas(a, dtype) for a in (q, k, v)),
                            jnp.array(offs, jnp.int32), causal)
    m, l, o = BA.flash_block_attention(*(_as(a, dtype) for a in (q, k, v)),
                                       offs, causal)
    assert all(t.dtype == torch.float32 for t in (m, l, o))
    assert m.shape == l.shape == q.shape[:3] and o.shape == q.shape
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
    # a fully masked row: the junk the ring's merge wipes, exactly
    dead = offs[0] + np.arange(Tq) < offs[1] if causal else \
        np.zeros(Tq, bool)
    assert np.all(m[:, dead] == np.float32(-1e30))
    assert np.all(l[:, dead] == Tk) and np.all(jl[:, dead] == Tk)
    assert np.all(m[:, ~dead] > -1e29)
    return m, l, o


@pytest.mark.parametrize("geo", list(GEOMETRIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_block_matches_jax_pallas_interpret(j_block, geo, dtype):
    qo, ko, causal = GEOMETRIES[geo]
    q, k, v = _np(seed=len(geo))
    m, l, o = _matches_jax(j_block, q, k, v, (qo, ko), causal, dtype)
    if geo == "above":   # fully masked: the junk the ring's merge wipes
        assert np.all(m == np.float32(-1e30)) and np.all(l == T)
        np.testing.assert_allclose(
            o, np.broadcast_to(_as(v, dtype).float().numpy()
                               .sum(1, keepdims=True), o.shape),
            rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("geo", ["diagonal", "below", "above", "straddle"])
@pytest.mark.parametrize("tq,tk", [(24, 40), (40, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uneven_block_matches_jax_pallas_interpret(j_block, geo, tq, tk,
                                                   dtype):
    """Tq != Tk: the query and key blocks of unequal length."""
    qo, ko, causal = _geometries(tq, tk)[geo]
    q, = _np((B, tq, H, D), seed=tq, n=1)
    k, v = _np((B, tk, H, D), seed=tk + 1, n=2)
    _matches_jax(j_block, q, k, v, (qo, ko), causal, dtype)


def _kept_key_tiles(q0, bm, Tq, Tk, q_off, k_off):
    """The kernel's rule for one query tile (rows q0 .. q0 + bm - 1):
    the number of key tiles of BN it runs.  Where every row sees a key
    (q_off + q0 >= k_off), the tiles past the last one holding a visible
    key are all masked and left out; otherwise all of them run."""
    nk = -(-Tk // BN)
    qe = min(q0 + bm, Tq) - 1
    if q_off + q0 >= k_off:
        return min(nk, (q_off + qe - k_off) // BN + 1)
    return nk


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("offs", [(0, 0), (0, 70), (130, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skipping_masked_key_tiles_is_exact_on_the_plain_version(
        bm, offs, dtype):
    """Each query tile of a causal block through the plain version, once
    as it is and once with the key tiles the kernel leaves out replaced
    by other keys and values (scores a hundred times larger, which would
    set the max if they were not masked): m, l and o bitwise equal, so
    no bit depends on a left-out tile (its scores are masked, below
    their row's max, and its p is exactly 0).  m, an order-free max, is
    also the same with those tiles cut off."""
    Tq, Tk = 300, 500
    q, = _np((1, Tq, 2, D), seed=21, n=1)
    k, v, k2, v2 = _np((1, Tk, 2, D), seed=22, n=4)
    q, k, v, k2, v2 = (_as(a, dtype) for a in (q, k, v, k2 * 100, v2))
    skipped = 0
    for q0 in range(0, Tq, bm):
        qt = q[:, q0:q0 + bm]
        offs_t = (offs[0] + q0, offs[1])
        n = min(_kept_key_tiles(q0, bm, Tq, Tk, *offs) * BN, Tk)
        skipped += Tk - n
        other_k = torch.cat([k[:, :n], k2[:, n:]], 1)
        other_v = torch.cat([v[:, :n], v2[:, n:]], 1)
        whole = BA.block_attention_ref(qt, k, v, offs_t, True)
        other = BA.block_attention_ref(qt, other_k, other_v, offs_t, True)
        for a, b, name in zip(whole, other, "mlo"):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                f"{name}, query tile at {q0}"
        m_cut = BA.block_attention_ref(qt, k[:, :n], v[:, :n], offs_t,
                                       True)[0]
        assert torch.equal(whole[0].view(torch.int32),
                           m_cut.view(torch.int32))
    assert skipped > 0


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
    # both dtypes are read through TMA: a strided last dimension is not
    with pytest.raises(ValueError, match="contiguous"):
        f = torch.zeros(1, 4, 1, 128)[..., ::2]
        K.block_attn_fwd(f, f, f, (0, 0))
    # bf16 is read through TMA maps of the tensors' strides: a ring
    # shard's view passes the layout checks (and fails only for being on
    # the CPU); a strided last dimension, a stride off 16 bytes or a
    # misaligned start does not
    bf = torch.bfloat16
    shard = torch.zeros(1, 8, 1, 64, dtype=bf)[:, 4:]
    with pytest.raises(ValueError, match="CUDA"):
        K.block_attn_fwd(shard, shard, shard, (4, 0))
    for bad, match in (
            (torch.zeros(1, 4, 1, 128, dtype=bf)[..., ::2], "last dimension"),
            (torch.zeros(1, 4, 1, 68, dtype=bf)[..., :64], "16 bytes"),
            (torch.zeros(4 * 64 + 1, dtype=bf)[1:].view(1, 4, 1, 64),
             "16-byte boundary")):
        for args in ((bad, shard, shard), (shard, bad, shard),
                     (shard, shard, bad)):
            with pytest.raises(ValueError, match=match):
                K.block_attn_fwd(*args, (0, 0))
    assert K.launches() == before   # nothing launched, nothing counted


def test_f32_wrapper_reads_shard_views_and_refuses_tma_breaking_layouts(
        monkeypatch):
    """f32 is read through TMA maps of the tensors' strides, as bf16: a
    ring shard's view passes the layout checks (and fails only for being
    on the CPU); a strided last dimension, a stride off 16 bytes or a
    misaligned start does not.  Each is refused before the library is
    loaded."""
    def no_load():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(K.LIB, "load", no_load)
    before = K.launches()
    shard = torch.zeros(2, 8, 1, 64)[:, 4:]
    assert not shard.is_contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        K.block_attn_fwd(shard, shard, shard, (4, 0))
    for bad, match in (
            (torch.zeros(2, 4, 1, 128)[..., ::2], "last dimension"),
            (torch.zeros(2, 4, 1, 66)[..., :64], "16 bytes"),
            (torch.zeros(2 * 4 * 64 + 1)[1:].view(2, 4, 1, 64),
             "16-byte boundary")):
        for args in ((bad, shard, shard), (shard, bad, shard),
                     (shard, shard, bad)):
            with pytest.raises(ValueError, match=match):
                K.block_attn_fwd(*args, (0, 0))
    assert K.launches() == before


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


def _rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref||, the denominator held at least at an rms
    of 1e-2."""
    floor = 1e-2 * max(ref.numel(), 1) ** 0.5
    return float((got.double() - ref.double()).norm()
                 / max(float(ref.double().norm()), floor))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 512, 16, 128), (8, 32, 32, 6, 64),
                                   (2, 250, 250, 3, 64), (1, 1, 1, 1, 64),
                                   (2, 300, 77, 3, 128),
                                   (1, 70, 400, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(card, shape, dtype):
    """(B, Tq, Tk, H, D): the MFU config's hop, the flagship LM's, a
    ragged tail, one token, and Tq != Tk both ways."""
    b, tq, tk, h, d = shape
    q, = (_as(a, dtype).to(card) for a in _np((b, tq, h, d), seed=3, n=1))
    k, v = (_as(a, dtype).to(card) for a in _np((b, tk, h, d), seed=4, n=2))
    tol = 1e-4 if dtype == "float32" else 2e-2
    geos = [*_geometries(tq, tk).values(), (0, 0, False)]
    count = "block_attn_fwd" if dtype == "bfloat16" else "block_attn_fwd_f32"
    for qo, ko, causal in geos:
        before = K.launches()[count]
        got = K.block_attn_fwd(q, k, v, (qo, ko), causal)
        assert K.launches()[count] == before + 1
        ref = BA.block_attention_ref(q, k, v, (qo, ko), causal)
        torch.cuda.synchronize()
        dead = ref[0] <= -1e29        # fully masked rows
        assert torch.equal(got[0][dead], ref[0][dead])
        assert bool((got[1][dead] == tk).all()), "l of a fully masked row"
        for g, r in zip(got, ref):
            live = r > -1e29
            scale = max(1.0, float(r[live].abs().max())) \
                if bool(live.any()) else 1.0
            assert float((g[live] - r[live]).abs().max()
                         if bool(live.any()) else 0.0) <= tol * scale
            assert _rel_l2(g[live], r[live]) <= tol / 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_reads_ring_shard_views_in_place(card, dtype):
    """q, k, v as the ring passes them, views of the sequence split
    x[:, r*t:(r+1)*t]: the same bits as their contiguous copies."""
    x = torch.from_numpy(_np((2, 4 * 64, 3, 128), seed=9, n=1)[0]).to(
        card, getattr(torch, dtype))
    q, k, v = x[:, 128:192], x[:, 64:128], x[:, 192:256]
    assert not q.is_contiguous()
    got = K.block_attn_fwd(q, k, v, (128, 64), True)
    want = K.block_attn_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                            (128, 64), True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
