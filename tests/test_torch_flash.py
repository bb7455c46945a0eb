"""The port's flash attention against the JAX package's attention (CPU),
and its CUDA kernels against their plain versions (card only).

The JAX package's ``attn_impl="flash"`` calls JAX's bundled Pallas TPU
kernel, which is broken under interpret mode on this JAX
(``tests/test_flash.py``), so the reference here is JAX's
``dense_attention`` and ``jax.grad`` of it, as that file uses.

Tolerances (inputs seeded with numpy, unit scale):
- f32: ``atol 1e-5`` on outputs and gradients — both sides compute in
  f32 and differ only in summation order;
- bf16 inputs: max abs 5e-2, the repo's bf16 attention tolerance
  (``bench.py`` ``_flash_exactness_check``): the port rounds ``p`` to
  bf16 before the PV product, JAX's ``dense_attention`` does not, and
  outputs and gradients are rounded to bf16;
- the port's ``dense_attention``/``fast_dense_attention`` against
  JAX's: f32 at atol 1e-6, bf16 within one bf16 ulp of the output
  (both round the same f32 value, up to f32 summation order);
- the plain backward in bf16 against a transcription of JAX's kernel's
  backward arithmetic: within one bf16 ulp of the largest entry (only
  the summation order and ``exp(s - lse)`` against ``exp(s - m) / l``
  differ), and bitwise equal in all but a few entries (at most 5 %,
  where those f32 differences cross a bf16 rounding boundary; scaling
  ``ds`` after its rounding instead changes about half of them);
- on the card (``cuda`` marker): kernel against plain version, f32 at
  atol 1e-4 (the forward's and the backward's 3xTF32 products,
  ``tests/test_torch_attention_f32.py``, summed in another order), bf16
  at 2e-2 for ``o`` (one bf16 ulp at |o| < 4: the kernel rounds the
  unnormalised ``p``, the plain version the normalised one) and 2e-2
  relative to the largest gradient entry for the backward (the tensor
  cores sum in another order, so a rounded ``p`` or ``ds`` may land one
  ulp apart);
  and each of ``o``, ``lse``, ``dq``, ``dk``, ``dv`` within a relative
  L2 of 1e-4 (f32) / 1e-2 (bf16), its denominator held at least at an
  rms of 1e-2 (at T = 1 the gradients of q and k are noise about 0).
  In bf16 at Dh 128 the kernel's gradients lie nearer the rounding
  plain version than the unrounded backward the port had before it
  rounded where JAX's kernel rounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from geomx_tpu.parallel.ring_attention import (
    dense_attention as j_dense, fast_dense_attention as j_fast)
from geomx_tpu_torch.ops import flash_attention as FA
from geomx_tpu_torch.ops.kernels import flash_attention as K
from geomx_tpu_torch.parallel.ring_attention import (
    dense_attention, fast_dense_attention)

# [B, T, H, Dh]: the LM tests' width (d 32, 4 heads), a ragged longer
# sequence, and the flagship's and MFU config's head dims
SHAPES = [(2, 16, 4, 8), (1, 37, 2, 64), (2, 20, 1, 128)]


def _np_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _as(x, dtype):
    t = torch.from_numpy(x)
    return t.bfloat16() if dtype == "bfloat16" else t


def _jas(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_and_grads_match_jax_dense(shape, dtype):
    q, k, v, w = _np_inputs(shape, seed=sum(shape))
    jq, jk, jv = (_jas(a, dtype) for a in (q, k, v))
    jw = jnp.asarray(w)

    def j_loss(a, b, c):
        return jnp.sum(j_dense(a, b, c, causal=True).astype(jnp.float32)
                       * jw)

    j_o = j_dense(jq, jk, jv, causal=True)
    j_g = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (_as(a, dtype).requires_grad_(True) for a in (q, k, v))
    o = FA.flash_attention(tq, tk, tv)
    (o.float() * torch.from_numpy(w)).sum().backward()
    assert o.dtype == tq.dtype and o.shape == tq.shape
    tol = 1e-5 if dtype == "float32" else 5e-2
    assert np.max(np.abs(_f(o) - _f(j_o))) < tol
    for t, g, name in zip((tq, tk, tv), j_g, "qkv"):
        assert t.grad.dtype == t.dtype
        err = np.max(np.abs(_f(t.grad) - _f(g)))
        assert err < tol, f"grad {name}: {err}"


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_ref_lse_and_bwd_ref_agree_with_autograd(shape):
    """The plain backward is the gradient of the plain forward (f32)."""
    q, k, v, w = _np_inputs(shape, seed=7)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = FA.flash_attention_ref(tq, tk, tv, scale)
    # lse: log-sum-exp of the visible scaled scores of each row
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = np.where(np.tril(np.ones((shape[1],) * 2, bool)), s, -np.inf)
    np.testing.assert_allclose(lse.detach().numpy(),
                               np.logaddexp.reduce(s, -1),
                               rtol=1e-5, atol=1e-5)
    assert lse.dtype == torch.float32
    assert lse.shape == (shape[0], shape[2], shape[1])
    do = torch.from_numpy(w)
    grads = torch.autograd.grad(o, (tq, tk, tv), do)
    refs = FA.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      o.detach(), lse.detach(), do, scale)
    for g, r, name in zip(grads, refs, "qkv"):
        np.testing.assert_allclose(r.numpy(), g.numpy(), atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "fast"])
def test_dense_and_fast_attention_match_jax(impl, dtype):
    q, k, v, _ = _np_inputs((2, 16, 4, 8), seed=3)
    j_fn, fn = {"dense": (j_dense, dense_attention),
                "fast": (j_fast, fast_dense_attention)}[impl]
    ref = _f(j_fn(*(_jas(a, dtype) for a in (q, k, v)), causal=True))
    got = _f(fn(*(_as(a, dtype) for a in (q, k, v)), causal=True))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-6)
    else:
        ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got - ref) <= ulp)
    # non-causal is the plain softmax attention
    got_nc = _f(fn(*(_as(a, dtype) for a in (q, k, v)), causal=False))
    ref_nc = _f(j_fn(*(_jas(a, dtype) for a in (q, k, v)), causal=False))
    np.testing.assert_allclose(got_nc, ref_nc,
                               atol=1e-6 if dtype == "float32" else 2e-2)


# JAX's DEFAULT_MASK_VALUE (pallas/ops/tpu/flash_attention.py:29)
_JAX_MASK = -0.7 * float(np.finfo(np.float32).max)


def _jax_kernel_bwd(q, k, v, o, do, sm_scale):
    """The arithmetic of JAX's bundled kernel's backward on one block
    holding the whole sequence, ``[B, T, H, Dh]`` in and out: ``p`` from
    the forward's row max and sum, rounded to ``do``'s dtype before
    ``dv`` (``flash_attention.py:900``); ``ds = (dp - di) * p``, then
    ``* sm_scale``, rounded before ``dk`` (:911-918) and ``dq``
    (:1243-1261); every product accumulates in f32."""
    q, k, v, o, do = (jnp.swapaxes(x, 1, 2) for x in (q, k, v, o, do))
    f32 = jnp.float32
    T = q.shape[2]
    s = lax.dot_general(q, k, (((3,), (3,)), ((0, 1), (0, 1))),
                        preferred_element_type=f32) * sm_scale
    s = s + jnp.where(jnp.tril(jnp.ones((T, T), bool)), 0.0, _JAX_MASK)
    m = jnp.max(s, -1, keepdims=True)
    l = jnp.sum(jnp.exp(s - m), -1, keepdims=True)
    p = jnp.exp(s - m) * (1 / l)
    di = jnp.sum(o.astype(f32) * do.astype(f32), -1)[..., None]
    dv = jnp.einsum("bhqk,bhqd->bhkd", p.astype(do.dtype), do,
                    preferred_element_type=f32)
    dp = jnp.einsum("bhqd,bhkd->bhqk", do, v, preferred_element_type=f32)
    ds = (dp - di) * p
    ds = ds * sm_scale
    dk = jnp.einsum("bhqk,bhqd->bhkd", ds.astype(do.dtype), q,
                    preferred_element_type=f32)
    dq = jnp.einsum("bhqk,bhkd->bhqd", ds.astype(k.dtype), k,
                    preferred_element_type=f32)
    return [jnp.swapaxes(x, 1, 2).astype(q.dtype) for x in (dq, dk, dv)]


def _bwd_against_jax_kernel(bwd, shape):
    """``(ulps, share)`` per gradient of ``bwd`` (the plain backward's
    signature) against :func:`_jax_kernel_bwd` on the same bf16 inputs:
    the largest difference in bf16 ulps of the largest entry, and the
    share of entries that differ at all."""
    rng = np.random.default_rng(sum(shape))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).bfloat16()
                   for _ in range(4))
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = FA.flash_attention_ref(q, k, v, scale)
    got = bwd(q, k, v, o, lse, do, scale)
    ref = _jax_kernel_bwd(*(jnp.asarray(_f(t), jnp.bfloat16)
                            for t in (q, k, v, o, do)), scale)
    out = []
    for g, r in zip(got, ref):
        g, r = _f(g), _f(r)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        out.append((np.abs(g - r).max() / ulp, np.mean(g != r)))
    return out


# ragged T, the flagship's head dim and the MFU config's (whose scale,
# 1/sqrt(128), is not a power of two, so where ds is scaled matters)
_ROUNDING_SHAPES = [(1, 37, 2, 64), (2, 45, 2, 128), (1, 61, 3, 128)]


@pytest.mark.parametrize("shape", _ROUNDING_SHAPES)
def test_bf16_bwd_ref_rounds_where_jax_kernel_rounds(shape):
    for name, (ulps, share) in zip("qkv", _bwd_against_jax_kernel(
            FA.flash_attention_bwd_ref, shape)):
        assert ulps <= 1.0, f"d{name}: {ulps} ulps of the largest entry"
        assert share <= 0.05, f"d{name}: {share:.1%} of entries differ"


def test_scaling_ds_after_rounding_is_caught():
    """The check above fails a backward that rounds ``ds`` and scales
    after the product, which differs from JAX's kernel at Dh 128."""

    def scaled_after(q, k, v, o, lse, do, sm_scale):
        s = FA._scores(q, k, sm_scale)
        p = torch.exp(s - lse[..., None])
        dof = do.float()
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
        delta = (dof * o.float()).sum(-1).transpose(1, 2)
        ds = ((dp - delta[..., None]) * p).to(q.dtype).float()
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
        return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)

    dq, dk, _ = _bwd_against_jax_kernel(scaled_after, _ROUNDING_SHAPES[1])
    assert dq[1] > 0.05 and dk[1] > 0.05, (dq, dk)


def test_kernel_wrappers_check_their_arguments():
    before = K.launches()
    q = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_fwd(q, q, q, 0.125)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.flash_fwd(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        K.flash_fwd(torch.zeros(1, 4, 1, 32), torch.zeros(1, 4, 1, 32),
                    torch.zeros(1, 4, 1, 32), 0.125)
    with pytest.raises(ValueError, match=r"\[B, T, H, Dh\]"):
        K.flash_fwd(torch.zeros(4, 64), torch.zeros(4, 64),
                    torch.zeros(4, 64), 0.125)
    lse = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_bwd(q, q, q, q, lse, q, 0.125)
    # nothing was launched, so nothing was counted
    assert K.launches() == before


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v, _ = _np_inputs((1, 8, 2, 64), seed=5)
    before = K.launches()
    o, lse = FA.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), 0.125)
    ro, rlse = FA.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), 0.125)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert K.launches() == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda")


def _unrounded_bwd(q, k, v, o, lse, do, sm_scale):
    """The plain backward without the roundings JAX's kernel makes:
    ``p`` and ``ds`` in f32, dK and dQ scaled after the product."""
    s = FA._scores(q, k, sm_scale)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _rel_l2(got, ref):
    floor = 1e-2 * math.sqrt(max(ref.numel(), 1))
    return float((got.double() - ref.double()).norm()
                 / max(float(ref.double().norm()), floor))


def test_unrounded_backward_is_a_distinct_control():
    """The control of the card test differs from the rounding plain
    version by more than summation order would (Dh 128, bf16)."""
    q, k, v, w = (_as(a, "bfloat16") for a in _np_inputs((1, 96, 2, 128),
                                                          11))
    scale = 1.0 / math.sqrt(128)
    o, lse = FA.flash_attention_ref(q, k, v, scale)
    refs = FA.flash_attention_bwd_ref(q, k, v, o, lse, w, scale)
    for g, r in zip(_unrounded_bwd(q, k, v, o, lse, w, scale), refs):
        assert _rel_l2(g, r) > 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128, 6, 64), (2, 1000, 3, 64),
                                   (1, 1, 1, 64), (2, 300, 2, 128),
                                   (4, 2048, 16, 128), (1, 2047, 2, 128),
                                   (2, 100, 3, 64), (1, 1500, 24, 128),
                                   (2, 200, 70, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_the_card(card, shape, dtype):
    q, k, v, w = (_as(a, dtype).to(card) for a in _np_inputs(shape, 11))
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = K.flash_fwd(q, k, v, scale)
    ro, rlse = FA.flash_attention_ref(q, k, v, scale)
    torch.cuda.synchronize()
    f32 = dtype == "float32"
    assert (o.float() - ro.float()).abs().max() < (1e-4 if f32 else 2e-2)
    assert (lse - rlse).abs().max() < 1e-4
    grads = K.flash_bwd(q, k, v, o, lse, w, scale)
    refs = FA.flash_attention_bwd_ref(q, k, v, o, lse, w, scale)
    torch.cuda.synchronize()
    for g, r in zip(grads, refs):
        bound = (1e-4 if f32 else 2e-2) * max(1.0, r.float().abs().max())
        assert (g.float() - r.float()).abs().max() < bound
    gate = 1e-4 if f32 else 1e-2
    for g, r, name in zip((o, lse, *grads), (ro, rlse, *refs),
                          ("o", "lse", "dq", "dk", "dv")):
        assert _rel_l2(g, r) <= gate, name
    if not f32 and shape[-1] == 128:
        unrounded = _unrounded_bwd(q, k, v, o, lse, w, scale)
        for g, r, u, name in zip(grads, refs, unrounded, "qkv"):
            assert _rel_l2(g, r) < _rel_l2(g, u), f"d{name}"


@pytest.mark.cuda
def test_bf16_kernels_refuse_unaligned_tensors(card):
    q = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16,
                    device=card)[1:].view(1, 4, 1, 64)
    ok = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        K.flash_fwd(q, ok, ok, 0.125)
    lse = torch.zeros(1, 1, 4, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        K.flash_bwd(ok, ok, ok, ok, lse, q, 0.125)


@pytest.mark.cuda
def test_f32_kernels_refuse_unaligned_tensors(card):
    """The f32 forward and backward read through TMA too."""
    q = torch.zeros(4 * 64 + 1, device=card)[1:].view(1, 4, 1, 64)
    ok = torch.zeros(1, 4, 1, 64, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        K.flash_fwd(q, ok, ok, 0.125)
    lse = torch.zeros(1, 1, 4, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        K.flash_bwd(ok, ok, ok, ok, lse, q, 0.125)
