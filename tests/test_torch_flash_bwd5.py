"""The bf16 flash backward's schedule on the card, emulated on the CPU,
against JAX's gradient and the port's plain backward; and the flash
wrappers' checks.

The bf16 backward kernel (``csrc/flash_attention.cu`` ``bwd_tc_kernel``)
forms five products per key tile and adds the dQ partial of each
consumer warpgroup's 64 keys into an f32 scratch with TMA's reduce-add, in an order that changes from
run to run; a last pass rounds the f32 sum to bf16 once.  Its rounding
points are JAX's kernel's: ``p`` rounded to bf16 before ``dv``, ``ds *
sm_scale`` rounded before ``dk`` and the dQ product.  The emulation
below does the same arithmetic on the CPU: per-key-tile dQ partials in
f32, summed in a seeded random order.

Tolerances (inputs seeded with numpy, unit scale):
- against JAX's ``jax.grad`` of ``dense_attention`` in bf16 (as
  ``tests/test_torch_flash.py`` computes it): max abs 5e-2, the repo's
  bf16 attention tolerance (``bench.py`` ``_flash_exactness_check``);
- against the port's plain backward, which rounds where JAX's kernel
  rounds: nearer it, in relative L2, than the unrounded backward (``p``
  and ``ds`` kept in f32, dK and dQ scaled after the product) is.  At
  T = 1 nothing rounds (``p`` is 1 and ``ds`` 0), so that check runs at
  T 100 and 200.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.parallel.ring_attention import dense_attention as j_dense
from geomx_tpu_torch.ops import flash_attention as FA
from geomx_tpu_torch.ops.kernels import flash_attention as K


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def bwd5_emulated(q, k, v, o, lse, do, sm_scale, order_seed):
    """The kernel's bf16 backward on the CPU: ``(dq, dk, dv)`` in bf16.
    Each consumer warpgroup's 64 keys make one dQ partial, its rounded
    ``ds * sm_scale`` times its keys in f32, and the partials are added
    in f32 in a random order."""
    B, T, H, D = q.shape
    bn = 64
    s = FA._scores(q, k, sm_scale)                       # [B, H, T, T]
    p = torch.exp(s - lse[..., None])                    # 0 where masked
    dof, qf, kf = do.float(), q.float(), k.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = ((dp - delta[..., None]) * p * sm_scale).bfloat16().float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    tiles = range(0, T, bn)
    order = np.random.default_rng(order_seed).permutation(len(tiles))
    dq = torch.zeros_like(qf)
    for t in order:
        k0 = tiles[t]
        dq += torch.einsum("bhqk,bkhd->bqhd", ds[..., k0:k0 + bn],
                           kf[:, k0:k0 + bn])
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _unrounded_bwd(q, k, v, o, lse, do, sm_scale):
    s = FA._scores(q, k, sm_scale)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _rel_l2(got, ref):
    floor = 1e-2 * math.sqrt(max(ref.numel(), 1))
    return float((got.double() - ref.double()).norm()
                 / max(float(ref.double().norm()), floor))


def _bf16_case(shape, seed):
    q, k, v, w = _inputs(shape, seed)
    tq, tk, tv, tw = (torch.from_numpy(a).bfloat16() for a in (q, k, v, w))
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = FA.flash_attention_ref(tq, tk, tv, scale)
    return (q, k, v, w), (tq, tk, tv, tw), o, lse, scale


_SHAPES = [(2, 1, 2, 64), (1, 100, 2, 64), (1, 200, 2, 64),
           (2, 1, 2, 128), (1, 100, 2, 128), (1, 200, 2, 128)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_emulated_bwd5_within_bf16_gate_of_jax(shape):
    (q, k, v, w), (tq, tk, tv, tw), o, lse, scale = _bf16_case(shape, 3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jw = jnp.asarray(w)

    def j_loss(a, b, c):
        return jnp.sum(j_dense(a, b, c, causal=True).astype(jnp.float32)
                       * jw)

    j_g = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)
    got = bwd5_emulated(tq, tk, tv, o, lse, tw, scale, order_seed=sum(shape))
    for g, r, name in zip(got, j_g, "qkv"):
        err = np.max(np.abs(g.float().numpy() - np.asarray(r, np.float32)))
        assert err < 5e-2, f"d{name}: {err}"


@pytest.mark.parametrize("shape", [s for s in _SHAPES if s[1] > 1])
@pytest.mark.parametrize("order_seed", [0, 1])
def test_emulated_bwd5_nearer_the_rounding_backward(shape, order_seed):
    _, (tq, tk, tv, tw), o, lse, scale = _bf16_case(shape, 5)
    got = bwd5_emulated(tq, tk, tv, o, lse, tw, scale, order_seed)
    refs = FA.flash_attention_bwd_ref(tq, tk, tv, o, lse, tw, scale)
    unr = _unrounded_bwd(tq, tk, tv, o, lse, tw, scale)
    for g, r, u, name in zip(got, refs, unr, "qkv"):
        assert _rel_l2(g, r) < _rel_l2(g, u), f"d{name}"


def test_dq_summation_order_moves_only_f32_rounding():
    """Two orders of the tiles' dQ partials give f32 sums within f32
    rounding of each other, so the bf16 results differ by at most one
    bf16 ulp of an entry and agree almost everywhere."""
    _, (tq, tk, tv, tw), o, lse, scale = _bf16_case((1, 300, 2, 64), 9)
    a = bwd5_emulated(tq, tk, tv, o, lse, tw, scale, order_seed=0)[0]
    b = bwd5_emulated(tq, tk, tv, o, lse, tw, scale, order_seed=1)[0]
    a, b = a.float(), b.float()
    ulp = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7 + 1e-30
    assert bool(((a - b).abs() <= ulp).all())
    assert float((a != b).float().mean()) <= 0.05


class _OnCard:
    """A CPU tensor that answers the wrapper's checks as a CUDA tensor
    would (device, contiguity and address from the tensor unless given)."""

    def __init__(self, t, device="cuda:0", contiguous=None, ptr=None):
        self.t, self.device = t, torch.device(device)
        self.dtype, self.shape = t.dtype, t.shape
        self._contig, self._ptr = contiguous, ptr

    is_cuda = property(lambda self: self.device.type == "cuda")

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return self.t.is_contiguous() if self._contig is None \
            else self._contig

    def data_ptr(self):
        return 4096 if self._ptr is None else self._ptr


_Q = torch.zeros(1, 4, 1, 64)


@pytest.mark.parametrize("case, err, match", [
    (dict(q=torch.zeros(4, 64)), ValueError, r"\[B, T, H, Dh\]"),
    (dict(q=_Q.half()), TypeError, "float32 or bfloat16"),
    (dict(q=torch.zeros(1, 4, 1, 32)), ValueError, "head_dim"),
    (dict(q=torch.zeros(1, 1, 65536, 64)), ValueError, "exceeds the grid"),
    (dict(q=_Q, oncard=False), ValueError, "q must be a CUDA tensor"),
    (dict(k=_OnCard(_Q, device="cpu")), ValueError,
     "k must be a CUDA tensor"),
    (dict(k=_OnCard(_Q, device="cuda:1")), ValueError, "k is on cuda:1"),
    (dict(v=_OnCard(_Q.bfloat16())), TypeError, "v is torch.bfloat16"),
    (dict(v=_OnCard(torch.zeros(1, 5, 1, 64))), ValueError,
     "v has shape"),
    (dict(k=_OnCard(_Q, contiguous=False)), ValueError,
     "k must be contiguous"),
    (dict(v=_OnCard(_Q, ptr=4100)), ValueError, "16-byte aligned"),
])
def test_merged_checks_raise_each_message(case, err, match):
    q = case.get("q", _Q)
    q = q if case.get("oncard") is False else _OnCard(q)
    named = tuple((n, case.get(n, _OnCard(_Q))) for n in ("k", "v"))
    before = K.launches()
    with pytest.raises(err, match=match):
        K._check(q, named)
    assert K.launches() == before


def test_merged_checks_pass_and_give_the_shape_and_addresses():
    q, k = _OnCard(_Q), _OnCard(_Q, ptr=8192)
    assert K._check(q, (("k", k), ("v", q))) == ((1, 4, 1, 64),
                                                 [4096, 8192, 4096])


@pytest.mark.parametrize("lse, err, match", [
    (_OnCard(torch.zeros(1, 1, 4), device="cuda:1"), ValueError,
     "lse is on"),
    (_OnCard(torch.zeros(1, 1, 4).double()), TypeError, "lse is"),
    (_OnCard(torch.zeros(1, 4, 1)), ValueError, "lse has shape"),
    (_OnCard(torch.zeros(1, 1, 4), contiguous=False), ValueError,
     "lse must be contiguous"),
])
def test_lse_check_raises(lse, err, match):
    with pytest.raises(err, match=match):
        K._check_lse(lse, _OnCard(_Q), 1, 1, 4)
