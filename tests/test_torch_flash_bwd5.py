"""The bf16 flash backward's schedule on the card, emulated on the CPU,
against JAX's gradient and the port's plain backward; and the flash
wrappers' checks.

The bf16 backward kernel (``csrc/flash_attention.cu`` ``bwd_tc_kernel``)
forms five products per key tile and adds the dQ partial of each
consumer warpgroup's 64 keys into an f32 scratch with TMA's reduce-add, in an order that changes from
run to run, or, while ``torch.are_deterministic_algorithms_enabled()``,
in ascending key tiles; a last pass rounds the f32 sum to bf16 once.  Its rounding
points are JAX's kernel's: ``p`` rounded to bf16 before ``dv``, ``ds *
sm_scale`` rounded before ``dk`` and the dQ product.  The emulation
below does the same arithmetic on the CPU: per-key-tile dQ partials in
f32, summed in a seeded random order, or in ascending key tiles.

Tolerances (inputs seeded with numpy, unit scale):
- against JAX's ``jax.grad`` of ``dense_attention`` in bf16 (as
  ``tests/test_torch_flash.py`` computes it): max abs 5e-2, the repo's
  bf16 attention tolerance (``bench.py`` ``_flash_exactness_check``);
- against the port's plain backward, which rounds where JAX's kernel
  rounds: nearer it, in relative L2, than the unrounded backward (``p``
  and ``ds`` kept in f32, dK and dQ scaled after the product) is.  At
  T = 1 nothing rounds (``p`` is 1 and ``ds`` 0), so that check runs at
  T 100 and 200;
- the fixed-order sum: bitwise equal to itself whatever the seed of the
  random order (tolerance: none).

On the card (``cuda`` marker, skipped without one): five backwards on
the same inputs at the LM's and the MFU shape (and three more), dK and
dV bitwise equal on both paths, dQ bitwise equal on the fixed-order
path, each within the bf16 gates of the card test in
``tests/test_torch_flash.py`` (max abs 2e-2 × max(1, largest entry),
relative L2 1e-2).
"""

import functools
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


def bwd5_emulated(q, k, v, o, lse, do, sm_scale, order_seed,
                  ordered=False, f32_dq=False):
    """The kernel's bf16 backward on the CPU: ``(dq, dk, dv)`` in bf16.
    Each consumer warpgroup's 64 keys make one dQ partial, its rounded
    ``ds * sm_scale`` times its keys in f32, and the partials are added
    in f32 in a random order, or in ascending key tiles when
    ``ordered`` (the fixed-order path; ``order_seed`` is then unused).
    ``f32_dq`` returns dQ's f32 sum, before the last pass rounds it."""
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
    order = (range(len(tiles)) if ordered else
             np.random.default_rng(order_seed).permutation(len(tiles)))
    dq = torch.zeros_like(qf)
    for t in order:
        k0 = tiles[t]
        dq += torch.einsum("bhqk,bkhd->bqhd", ds[..., k0:k0 + bn],
                           kf[:, k0:k0 + bn])
    return (dq if f32_dq else dq.bfloat16()), dk.bfloat16(), dv.bfloat16()


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


@functools.lru_cache(maxsize=None)
def _jax_bf16_grads(shape, seed):
    """JAX's ``jax.grad`` of ``dense_attention`` in bf16 on
    ``_bf16_case(shape, seed)``'s inputs, as f32 numpy (dq, dk, dv)."""
    q, k, v, w = _inputs(shape, seed)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jw = jnp.asarray(w)

    def j_loss(a, b, c):
        return jnp.sum(j_dense(a, b, c, causal=True).astype(jnp.float32)
                       * jw)

    return tuple(np.asarray(g, np.float32) for g in
                 jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv))


_SHAPES = [(2, 1, 2, 64), (1, 100, 2, 64), (1, 200, 2, 64),
           (2, 1, 2, 128), (1, 100, 2, 128), (1, 200, 2, 128)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_emulated_bwd5_within_bf16_gate_of_jax(shape):
    _, (tq, tk, tv, tw), o, lse, scale = _bf16_case(shape, 3)
    j_g = _jax_bf16_grads(shape, 3)
    got = bwd5_emulated(tq, tk, tv, o, lse, tw, scale, order_seed=sum(shape))
    for g, r, name in zip(got, j_g, "qkv"):
        err = np.max(np.abs(g.float().numpy() - r))
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


@pytest.mark.parametrize("shape", [(1, 300, 2, 64), (1, 200, 2, 128)])
def test_fixed_order_emulation_is_the_same_bits_whatever_the_seed(shape):
    _, (tq, tk, tv, tw), o, lse, scale = _bf16_case(shape, 9)
    # dQ compared in f32, before the last pass rounds it (equal f32 bits
    # round to equal bf16 bits); dK and dV in bf16
    fixed = [bwd5_emulated(tq, tk, tv, o, lse, tw, scale, s, ordered=True,
                           f32_dq=True) for s in range(4)]
    for run in fixed[1:]:
        assert torch.equal(run[0].view(torch.int32),
                           fixed[0][0].view(torch.int32))
        for a, b in zip(run[1:], fixed[0][1:]):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # random orders move some of the f32 bits
    shuffled = [bwd5_emulated(tq, tk, tv, o, lse, tw, scale, s,
                              f32_dq=True)[0] for s in range(2)]
    assert any(not torch.equal(d, fixed[0][0]) for d in shuffled)


@pytest.mark.parametrize("shape", _SHAPES)
def test_fixed_order_emulation_within_bf16_gate_of_jax(shape):
    _, (tq, tk, tv, tw), o, lse, scale = _bf16_case(shape, 3)
    j_g = _jax_bf16_grads(shape, 3)
    got = bwd5_emulated(tq, tk, tv, o, lse, tw, scale, None, ordered=True)
    for g, r, name in zip(got, j_g, "qkv"):
        err = np.max(np.abs(g.float().numpy() - r))
        assert err < 5e-2, f"d{name}: {err}"
    if shape[1] > 1:
        refs = FA.flash_attention_bwd_ref(tq, tk, tv, o, lse, tw, scale)
        unr = _unrounded_bwd(tq, tk, tv, o, lse, tw, scale)
        for g, r, u, name in zip(got, refs, unr, "qkv"):
            assert _rel_l2(g, r) < _rel_l2(g, u), f"d{name}"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _backwards(q, k, v, o, lse, w, scale, runs, ordered):
    """``runs`` backwards on the same inputs with PyTorch's
    deterministic switch set to ``ordered`` (restored after)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(ordered)
    try:
        out = [K.flash_bwd(q, k, v, o, lse, w, scale) for _ in range(runs)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128, 6, 64), (4, 2048, 16, 128),
                                   (2, 1000, 3, 64), (1, 2047, 2, 128),
                                   (1, 1500, 24, 128)])
def test_bf16_backward_reproducible_on_the_card(card, shape, record_property):
    """The LM's and the MFU shape, a ragged tail, T off the tile and
    the two-warpgroup tiles: five backwards a path."""
    q, k, v, w = (torch.from_numpy(a).to(card, torch.bfloat16)
                  for a in _inputs(shape, 11))
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = K.flash_fwd(q, k, v, scale)
    refs = FA.flash_attention_bwd_ref(q, k, v, o, lse, w, scale)
    before = K.launches()
    default = _backwards(q, k, v, o, lse, w, scale, 5, ordered=False)
    fixed = _backwards(q, k, v, o, lse, w, scale, 5, ordered=True)
    after = K.launches()
    assert after["flash_bwd"] - before["flash_bwd"] == 5
    assert after["flash_bwd_ordered"] - before["flash_bwd_ordered"] == 5

    def same(a, b):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))

    for runs in (default, fixed):
        for run in runs[1:]:
            assert same(run[1], runs[0][1]) and same(run[2], runs[0][2]), \
                "dK or dV moved between runs"
    dq_default_same = all(same(r[0], default[0][0]) for r in default[1:])
    record_property("default_dq_bitwise_equal_across_5_runs",
                    dq_default_same)
    for run in fixed[1:]:
        assert same(run[0], fixed[0][0]), "fixed-order dQ moved"
    for g, r, name in zip(fixed[0], refs, ("dq", "dk", "dv")):
        bound = 2e-2 * max(1.0, float(r.float().abs().max()))
        assert float((g.float() - r.float()).abs().max()) < bound, name
        assert _rel_l2(g, r) <= 1e-2, name
    print(f"{shape}: default-path dQ bitwise equal across 5 runs: "
          f"{dq_default_same}")


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


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("loop", ["fsa", "hfa", "overlapped"])
def test_config_deterministic_takes_the_fixed_order_backward(
        monkeypatch, loop, deterministic):
    """``Config.deterministic`` reaches a worker's flash backward with
    PyTorch's global switch off: every backward of a bf16 attention step
    run by the FSA loop, the HFA loop or the staged (P3) loop, whose
    backward recomputes the forward, asks for the fixed-order path
    exactly when the flag is set (on the card the bf16 kernel then sums
    dQ in ascending key tiles; here the plain version runs)."""
    from geomx_tpu_torch import overlap, training
    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation

    asked = []
    plain = FA.flash_attention_bwd

    def recording_bwd(*args, ordered=False):
        asked.append(ordered)
        return plain(*args, ordered=ordered)

    monkeypatch.setattr(FA, "flash_attention_bwd", recording_bwd)
    assert not torch.are_deterministic_algorithms_enabled()
    shape = (1, 16, 2, 64)
    x = torch.from_numpy(_inputs(shape, 3)[0]).to(torch.bfloat16)

    def attend(p, x):
        q = x * p["w"].to(torch.bfloat16)
        return FA.flash_attention(q, x, x)

    def grad_fn(p, x, _y):
        p = {n: t.detach().requires_grad_(True) for n, t in p.items()}
        loss = attend(p, x).float().square().mean()
        (g,) = torch.autograd.grad(loss, [p["w"]])
        return loss.detach(), torch.tensor(0.0), {"w": g}

    steps = 2
    sim = Simulation(Config(
        topology=Topology(num_parties=1, workers_per_party=1),
        deterministic=deterministic, use_hfa=loop == "hfa",
        merge_backend="numpy"))
    try:
        kv = sim.all_workers()[0]
        kv.set_optimizer({"type": "sgd", "lr": 0.1})
        params = {"w": torch.ones(shape[-1])}
        data = [(x, torch.zeros(1))] * steps
        if loop == "fsa":
            training.run_worker(kv, params, grad_fn, data, steps,
                                barrier_init=False)
        elif loop == "hfa":
            training.run_worker_hfa(kv, params, grad_fn, data, steps, k1=1,
                                    barrier_init=False)
        else:
            model = overlap.StagedModel(
                [attend], lambda out, _y: (out.float().square().mean(),
                                           torch.tensor(0.0)))
            overlap.run_worker_overlapped(kv, model, [params], data, steps,
                                          barrier_init=False)
    finally:
        sim.shutdown()
    assert asked == [deterministic] * steps
    assert not FA.fixed_order()


@pytest.mark.cuda
def test_config_deterministic_reproducible_on_the_card(card):
    """Under a worker's ``Config.deterministic`` step context, with
    PyTorch's global switch off, two autograd backwards of the bf16
    flash call at the MFU shape give bitwise equal dQ through the
    fixed-order kernel (counted as ``flash_bwd_ordered``)."""
    from types import SimpleNamespace

    from geomx_tpu_torch.core.config import Config
    from geomx_tpu_torch.training import step_order

    shape = (4, 2048, 16, 128)
    q, k, v, w = (torch.from_numpy(a).to(card, torch.bfloat16)
                  for a in _inputs(shape, 11))
    assert not torch.are_deterministic_algorithms_enabled()
    kv = SimpleNamespace(config=Config(deterministic=True))
    before = K.launches()
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with step_order(kv):
            o = FA.flash_attention(*leaves)
        runs.append(torch.autograd.grad(o, leaves, w))
    torch.cuda.synchronize()
    after = K.launches()
    assert after["flash_bwd_ordered"] - before["flash_bwd_ordered"] == 2
    assert after["flash_bwd"] == before["flash_bwd"]
    assert torch.equal(runs[0][0].view(torch.int16),
                       runs[1][0].view(torch.int16))
