"""The arithmetic of the f32 attention kernels on the tensor cores
(``fwd_f32_tc_kernel``, ``dkdv_f32_tc_kernel`` and ``dq_f32_tc_kernel``
in ``csrc/flash_attention.cu``, ``block_attn_f32_tc_kernel`` in
``csrc/block_attention.cu``), emulated in torch on the CPU and held
against the JAX package.

What is emulated (``csrc/hopper_tiles.cuh``, 3xTF32): an f32 operand x
splits into hi = x with its low 13 mantissa bits cleared (what the tensor
core reads of x as stored) and lo = x - hi, of which the tensor core
reads only the TF32 part, so lo is truncated the same way; each product
is hi hi' + hi lo' + lo hi', every partial exact in f32 (two 11-bit
significands), summed in f32.  The kernels' tiling is kept: query tiles
of 64 rows and key steps of 32, an online softmax over the steps (the
block kernel's in one pass, masked scores exactly -1e30 after the scale,
keys past Tk left out; the flash forward's with -inf masking in log2
units), the block kernel's skip rule (key steps past the last visible one
are left out where every row of the query tile sees a key) and its fully
masked query tile (o = 1 V by the same three products).  The flash
backward's: 64-key tiles with query steps of 16 (D = 128) or 32 (D =
64) from the diagonal down for dK and dV, 64-query tiles with key steps
of the same size up to the diagonal for dQ, p = exp2(s scale log2 e -
lse log2 e) with the causal mask, ds scaled before its products, and
each step's product added to the sum in f32.

References, on the same numpy inputs: JAX's ``flash_block_attention``
with its Pallas kernel in interpret mode, and for the flash forward
JAX's ``dense_attention`` and the log-sum-exp of the scaled scores in
float64 (JAX's bundled flash kernel does not run in interpret mode on
this JAX; ``tests/test_torch_flash.py`` uses the same reference), and
for the flash backward ``jax.grad`` of ``dense_attention``.

Gate: the f32 gate of ``chip_smoke.py`` and the card tests, 1e-4 times
max(1, the largest reference entry) on the largest error and a relative
L2 of 1e-4, over the entries a fully masked row does not fill; there
``m`` must be exactly -1e30 and ``l`` exactly Tk.  3xTF32 leaves about
2^-20 of each product, far inside it.  The negative control, one TF32
product (the lo terms dropped), is off by about 2^-10 a product and must
fail the same gate at D = 128: a single TF32 product would change what
f32 means.  In the backward, delta = rowsum(dO * O) takes O from the
emulated forward, as the kernels take it from the forward kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.compat import force_tpu_interpret_mode
from geomx_tpu.ops.block_attention import (
    flash_block_attention as j_flash_block)
from geomx_tpu.parallel.ring_attention import dense_attention as j_dense

BM, BN = 64, 32            # the kernels' query tile and key step
MASK = np.float32(-1e30)
TOL = 1e-4                 # f32: largest error and relative L2
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with the low 13 mantissa bits cleared: what the tensor core
    reads of an f32 word."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b as the kernels form it: three TF32 products, the small ones
    (hi lo, lo hi) summed first and then hi hi, or, for the control, one
    (hi hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if not three:
        return ah @ bh
    return (ah @ _tf32(b - bh) + _tf32(a - ah) @ bh) + ah @ bh


def emulate_block(q, k, v, offs, causal, three=True):
    """The f32 block kernel on [B, T, H, D] float32 tensors: ``(m, l, o,
    skipped key steps)``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    q_off, k_off = offs
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))   # B, H, T, D
    m_out = torch.empty(B, H, Tq)
    l_out = torch.empty(B, H, Tq)
    o_out = torch.empty(B, H, Tq, D)
    nk = -(-Tk // BN)
    skipped = 0
    for q0 in range(0, Tq, BM):
        qe = min(q0 + BM, Tq) - 1
        rows = slice(q0, qe + 1)
        q_pos = q_off + torch.arange(q0, qe + 1)
        if causal and q_off + qe < k_off:       # every row fully masked
            o = torch.zeros(B, H, qe + 1 - q0, D)
            for k0 in range(0, Tk, BN):
                ones = torch.ones(B, H, qe + 1 - q0, min(BN, Tk - k0))
                o = o + _mm(ones, vh[:, :, k0:k0 + BN], three)
            m_out[:, :, rows], l_out[:, :, rows] = float(MASK), float(Tk)
            o_out[:, :, rows] = o
            continue
        n_kt = (min(nk, (q_off + qe - k_off) // BN + 1)
                if causal and q_off + q0 >= k_off else nk)
        skipped += nk - n_kt
        m = torch.full((B, H, qe + 1 - q0), -math.inf)
        l = torch.zeros(B, H, qe + 1 - q0)
        o = torch.zeros(B, H, qe + 1 - q0, D)
        for k0 in range(0, n_kt * BN, BN):
            kt, vt = kh[:, :, k0:k0 + BN], vh[:, :, k0:k0 + BN]
            s = _mm(qh[:, :, rows], kt.transpose(-1, -2), three) * scale
            if causal:
                k_pos = k_off + torch.arange(k0, k0 + kt.shape[2])
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                                torch.tensor(MASK))
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mn)           # 0 on the first step
            m = mn
            p = torch.exp(s - m[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + _mm(p, vt, three)
        m_out[:, :, rows], l_out[:, :, rows], o_out[:, :, rows] = m, l, o
    return (m_out.transpose(1, 2), l_out.transpose(1, 2),
            o_out.permute(0, 2, 1, 3), skipped)


def emulate_flash(q, k, v, three=True):
    """The f32 flash forward (causal) on [B, T, H, D]: ``(o [B, T, H,
    D], lse [B, H, T])``."""
    B, T, H, D = q.shape
    sl2 = np.float32(1.0 / math.sqrt(D)) * LOG2E
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    o_out = torch.empty(B, H, T, D)
    lse = torch.empty(B, H, T)
    for q0 in range(0, T, BM):
        qe = min(q0 + BM, T) - 1
        rows = slice(q0, qe + 1)
        qi = torch.arange(q0, qe + 1)
        m2 = torch.full((B, H, qe + 1 - q0), -math.inf)
        l = torch.zeros(B, H, qe + 1 - q0)
        o = torch.zeros(B, H, qe + 1 - q0, D)
        for k0 in range(0, qe // BN * BN + 1, BN):   # steps to the diagonal
            kt, vt = kh[:, :, k0:k0 + BN], vh[:, :, k0:k0 + BN]
            s = _mm(qh[:, :, rows], kt.transpose(-1, -2), three)
            kc = torch.arange(k0, k0 + kt.shape[2])
            s = torch.where(kc[None, :] <= qi[:, None], s,
                            torch.tensor(-math.inf))
            mn = torch.maximum(m2, s.amax(-1) * sl2)
            alpha = torch.exp2(m2 - mn)
            m2 = mn
            p = torch.exp2(s * sl2 - m2[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + _mm(p, vt, three)
        o_out[:, :, rows] = o / l[..., None]
        lse[:, :, rows] = m2 * LN2 + torch.log(l)
    return o_out.permute(0, 2, 1, 3), lse


def emulate_flash_bwd(q, k, v, o, lse, do, three=True):
    """The f32 flash backward (causal) on [B, T, H, D] tensors, ``lse``
    [B, H, T]: ``(dq, dk, dv)`` as the kernels form them."""
    B, T, H, D = q.shape
    step = 16 if D == 128 else 32        # rows a step (shared memory)
    scale = np.float32(1.0 / math.sqrt(D))
    sl2 = scale * LOG2E
    qh, kh, vh, oh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, o, do))
    lse2 = lse * LOG2E
    delta = (doh * oh).sum(-1)                          # delta_kernel
    dq, dk, dv = (torch.zeros(B, H, T, D) for _ in range(3))

    def p_ds(s, dp, qi, kc, l2, dl):
        """p = exp(s scale - lse), masked; ds * scale."""
        p = torch.exp2(s * sl2 - l2)
        p = torch.where(kc[None, :] <= qi[:, None], p, torch.tensor(0.0))
        return p, (dp - dl) * p * scale

    for k0 in range(0, T, BM):                          # dK/dV blocks
        ke = min(k0 + BM, T)
        kt, vt = kh[:, :, k0:ke], vh[:, :, k0:ke]
        kc = torch.arange(k0, ke)
        dkt = torch.zeros(B, H, ke - k0, D)
        dvt = torch.zeros(B, H, ke - k0, D)
        for q0 in range(k0, T, step):                   # diagonal down
            qe = min(q0 + step, T)
            qs, dos = qh[:, :, q0:qe], doh[:, :, q0:qe]
            st = _mm(kt, qs.transpose(-1, -2), three)   # S^T
            dpt = _mm(vt, dos.transpose(-1, -2), three)  # dP^T
            p, ds = p_ds(st.transpose(-1, -2), dpt.transpose(-1, -2),
                         torch.arange(q0, qe), kc,
                         lse2[:, :, q0:qe, None], delta[:, :, q0:qe, None])
            dvt = dvt + _mm(p.transpose(-1, -2), dos, three)
            dkt = dkt + _mm(ds.transpose(-1, -2), qs, three)
        dk[:, :, k0:ke], dv[:, :, k0:ke] = dkt, dvt
    for q0 in range(0, T, BM):                          # dQ blocks
        qe = min(q0 + BM, T)
        qt, dot_ = qh[:, :, q0:qe], doh[:, :, q0:qe]
        qi = torch.arange(q0, qe)
        dqt = torch.zeros(B, H, qe - q0, D)
        for k0 in range(0, (qe - 1) // step * step + 1, step):  # to diagonal
            ke = min(k0 + step, T)
            ks, vs = kh[:, :, k0:ke], vh[:, :, k0:ke]
            p, ds = p_ds(_mm(qt, ks.transpose(-1, -2), three),
                         _mm(dot_, vs.transpose(-1, -2), three), qi,
                         torch.arange(k0, ke), lse2[:, :, q0:qe, None],
                         delta[:, :, q0:qe, None])
            dqt = dqt + _mm(ds, ks, three)
        dq[:, :, q0:qe] = dqt
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))


def _errors(got, ref):
    """(largest error, its allowance, relative L2) of ``got`` against
    ``ref`` (numpy) over the entries a fully masked row does not fill."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    live = ref > -1e29
    g, r = got[live], ref[live]
    if r.size == 0:
        return 0.0, TOL, 0.0
    err = float(np.abs(g - r).max())
    allow = TOL * max(1.0, float(np.abs(r).max()))
    floor = 1e-2 * math.sqrt(r.size)
    rel = float(np.linalg.norm(g - r) / max(np.linalg.norm(r), floor))
    return err, allow, rel


def _passes(pairs) -> bool:
    """The f32 gate over every (got, ref) pair."""
    for got, ref in pairs:
        err, allow, rel = _errors(got, ref)
        if err > allow or rel > TOL:
            return False
    return True


@pytest.fixture(scope="module")
def j_block():
    fwd = jax.jit(j_flash_block, static_argnums=4)

    def run(q, k, v, offs, causal):
        with force_tpu_interpret_mode():
            out = fwd(*(jnp.asarray(a) for a in (q, k, v)),
                      jnp.array(offs, jnp.int32), causal)
        return [np.asarray(a, np.float32) for a in out]

    return run


def _inputs(B, Tq, Tk, H, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Tk, H, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _geometry(geo, Tq, Tk):
    return {"diagonal": (0, 0, True), "below": (Tk, 0, True),
            "above": (0, Tq, True), "straddle": (0, Tq // 2 + 3, True),
            "noncausal": (0, 0, False)}[geo]


# Tq = Tk = 80: a ragged query tile (64 + 16) and key step (32 + 32 + 16);
# and Tq != Tk both ways
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("geo", ["diagonal", "below", "above", "straddle",
                                 "noncausal"])
@pytest.mark.parametrize("tq,tk", [(80, 80), (70, 100), (100, 45)])
def test_block_3xtf32_matches_jax_pallas_interpret(j_block, D, geo, tq, tk):
    q, k, v = _inputs(1, tq, tk, 2, D, seed=tq + tk + D)
    qo, ko, causal = _geometry(geo, tq, tk)
    jm, jl, jo = j_block(q, k, v, (qo, ko), causal)
    m, l, o, skipped = emulate_block(*(torch.from_numpy(a) for a in (q, k, v)),
                                     (qo, ko), causal)
    m, l, o = (t.numpy() for t in (m, l, o))
    for got, ref, name in ((m, jm, "m"), (l, jl, "l"), (o, jo, "o")):
        err, allow, rel = _errors(got, ref)
        assert err <= allow and rel <= TOL, (name, err, allow, rel)
    dead = (qo + np.arange(tq) < ko) if causal else np.zeros(tq, bool)
    assert np.all(m[:, dead] == MASK) and np.all(jm[:, dead] == MASK)
    assert np.all(l[:, dead] == tk) and np.all(jl[:, dead] == tk)
    assert np.all(m[:, ~dead] > -1e29)
    if geo == "diagonal" and tk > BM:
        assert skipped > 0      # the skip rule took part


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 80, 150])
def test_flash_forward_3xtf32_matches_jax_reference(D, T):
    q, k, v = _inputs(2, T, T, 2, D, seed=T + D)
    o, lse = emulate_flash(*(torch.from_numpy(a) for a in (q, k, v)))
    jo = np.asarray(j_dense(*(jnp.asarray(a) for a in (q, k, v)),
                            causal=True), np.float32)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(D)
    s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    ref_lse = np.logaddexp.reduce(s, axis=-1)
    assert _passes([(o.numpy(), jo), (lse.numpy(), ref_lse)])


def _j_grads(q, k, v, do):
    """JAX's gradients of causal ``dense_attention`` (f32) against the
    cotangent ``do``."""
    _, vjp = jax.vjp(lambda a, b, c: j_dense(a, b, c, causal=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do))]


def _bwd_inputs(T, D, seed):
    """q, k, v, do (numpy) and the emulated forward's o, lse (torch)."""
    q, k, v = _inputs(2, T, T, 2, D, seed)
    do = np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)
    o, lse = emulate_flash(*(torch.from_numpy(a) for a in (q, k, v)))
    return q, k, v, do, o, lse


# T = 1, a ragged T (a 64-row tile and a part step), and T past two tiles
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 100, 200])
def test_flash_backward_3xtf32_matches_jax_grad(D, T):
    q, k, v, do, o, lse = _bwd_inputs(T, D, seed=2 * T + D)
    got = emulate_flash_bwd(*(torch.from_numpy(a) for a in (q, k, v)), o,
                            lse, torch.from_numpy(do))
    refs = _j_grads(q, k, v, do)
    for g, r, name in zip(got, refs, ("dq", "dk", "dv")):
        err, allow, rel = _errors(g.numpy(), r)
        assert err <= allow and rel <= TOL, (name, err, allow, rel)


@pytest.mark.parametrize("kernel", ["block", "flash", "flash_bwd"])
def test_single_tf32_product_fails_the_f32_gate(j_block, kernel):
    """The control: with the lo terms dropped, the emulation of the same
    tiles misses the gate at D = 128, while the three products meet it;
    so the gate tells 3xTF32 from one TF32 product."""
    q, k, v = _inputs(1, 80, 80, 2, 128, seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if kernel == "block":
        jm, jl, jo = j_block(q, k, v, (80, 0), True)

        def run(three):
            m, l, o, _ = emulate_block(tq, tk, tv, (80, 0), True, three)
            return [(m.numpy(), jm), (l.numpy(), jl), (o.numpy(), jo)]
    elif kernel == "flash":
        jo = np.asarray(j_dense(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=True), np.float32)

        def run(three):
            return [(emulate_flash(tq, tk, tv, three)[0].numpy(), jo)]
    else:
        # the backward's products alone: o and lse from the three-product
        # forward in both runs
        q, k, v, do, o, lse = _bwd_inputs(80, 128, seed=3)
        refs = _j_grads(q, k, v, do)
        args = [torch.from_numpy(a) for a in (q, k, v)]

        def run(three):
            got = emulate_flash_bwd(*args, o, lse, torch.from_numpy(do),
                                    three)
            return [(g.numpy(), r) for g, r in zip(got, refs)]

    assert _passes(run(True))
    assert not _passes(run(False))
