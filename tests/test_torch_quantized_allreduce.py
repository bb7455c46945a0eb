"""The port's int8 quantized all-reduce against the JAX package's (CPU).

The JAX side runs ``quantized_psum_mean`` / ``quantized_psum_mean_ef``
inside ``shard_map`` over k virtual CPU devices (``tests/conftest.py``),
jitted; the port runs them single-controller on a list of k per-rank
vectors.  Inputs come from numpy seeds, f32, at lengths off the block
(1000) and off a whole k × BLOCK span.

Tolerances: the quantize and dequantize are bitwise equal to JAX's, and
the port sums the dequantized peer shards in rank order, one product and
one add at a time, so the card and the CPU agree bit for bit.  XLA's CPU
code fuses each peer's dequantize into the sum as a fused multiply-add
(``fma(q1, s1, q0 * s0)`` reproduces JAX's k = 2 mean bit for bit), so a
shard mean can differ from JAX's in its last bit, and with it the block
scale of the second leg: each output is held within 1e-4 of its block's
int8 step (``absmax / 127``; measured worst 1.5e-5, on 230 to 594 of
1,000–3,077 elements, the rest bitwise) and each residual within 1e-4
of k steps (measured 2.3e-5).  ``make_party_step_quantized`` against
JAX's: loss rtol
1e-6, gradients atol 1e-7 (measured worst 1.5e-8: the per-rank
gradients differ in their last bits, as in ``make_party_step``), and
every element within JAX's per-leg block bound (2 · absmax / 254 a leg)
of the exact ``make_party_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from geomx_tpu.compat import shard_map
from geomx_tpu.parallel import make_mesh as j_make_mesh
from geomx_tpu.parallel.dp import make_party_step as j_make_party_step
from geomx_tpu.parallel.quantized_allreduce import (
    make_party_step_quantized as j_make_party_step_quantized,
    quantized_psum_mean as j_qpm, quantized_psum_mean_ef as j_qpm_ef)
from geomx_tpu_torch.parallel import (make_party_step_quantized,
                                      quantized_psum_mean)
from geomx_tpu_torch.parallel.dp import (_per_rank, make_party_step,
                                         party_meshes)
from geomx_tpu_torch.parallel.quantized_allreduce import (
    BLOCK, quantized_psum_mean_ef)


def _inputs(k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, n)).astype(np.float32)
    x[:, 3] *= 300.0          # a block whose absmax hides its small entries
    r = (rng.standard_normal((k, n)) * 0.01).astype(np.float32)
    return x, r


def _jax_qpm(x, r=None):
    k = x.shape[0]
    mesh = j_make_mesh({"dp": k}, jax.devices()[:k])
    if r is None:
        f = shard_map(lambda a: j_qpm(a[0], "dp", k)[None], mesh=mesh,
                      in_specs=P("dp"), out_specs=P("dp"), check_vma=False)
        return np.asarray(jax.jit(f)(jnp.asarray(x))), None

    def body(a, b):
        out, res = j_qpm_ef(a[0], b[0], "dp", k)
        return out[None], res[None]

    f = shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                  out_specs=(P("dp"), P("dp")), check_vma=False)
    out, res = jax.jit(f)(jnp.asarray(x), jnp.asarray(r))
    return np.asarray(out), np.asarray(res)


def _step_of(v):
    """Each element's int8 step: its block's absmax / 127."""
    pad = (-v.shape[0]) % BLOCK
    amax = np.pad(np.abs(v), (0, pad)).reshape(-1, BLOCK).max(1)
    return np.repeat(amax / 127, BLOCK)[:v.shape[0]]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("n", [1000, 3 * BLOCK * 4 + 5])
def test_quantized_psum_mean_matches_jax(k, n):
    x, _ = _inputs(k, n, seed=k + n)
    jout, _ = _jax_qpm(x)
    outs = quantized_psum_mean([torch.from_numpy(a) for a in x])
    assert len(outs) == k
    for d, o in enumerate(outs):
        assert o.shape == (n,) and o.dtype == torch.float32
        assert torch.equal(o, outs[0])
        assert (np.abs(o.numpy() - jout[d]) <= 1e-4 * _step_of(jout[d])).all()
    # the bound JAX's own test holds: each element quantized at most
    # twice, each at <= absmax/127 of its block
    exact = x.mean(0)
    assert np.abs(outs[0].numpy() - exact).max() <= 2 * np.abs(x).max() / 127


@pytest.mark.parametrize("k", [2, 4])
def test_quantized_psum_mean_ef_matches_jax(k):
    x, r = _inputs(k, 1000, seed=7 * k)
    jout, jres = _jax_qpm(x, r)
    outs, res = quantized_psum_mean_ef([torch.from_numpy(a) for a in x],
                                       [torch.from_numpy(a) for a in r])
    step = _step_of(jout[0])
    for d in range(k):
        assert (np.abs(outs[d].numpy() - jout[d]) <= 1e-4 * step).all(), d
        assert (np.abs(res[d].numpy() - jres[d]) <= 1e-4 * k * step).all(), d
    # zero residuals: the plain rung of x
    zero = [torch.zeros(1000) for _ in range(k)]
    plain = quantized_psum_mean([torch.from_numpy(a) for a in x])
    assert torch.equal(quantized_psum_mean_ef(
        [torch.from_numpy(a) for a in x], zero)[0][0], plain[0])


def _grad_fns():
    def j_fn(params, x, y):
        def loss_fn(p):
            logits = x @ p["w"] + p["b"]
            logp = jax.nn.log_softmax(logits)
            ls = -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))
            return ls, (logits.argmax(-1) == y).mean()

        (loss, acc), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, acc, g

    def t_fn(params, x, y):
        p = {k: v.requires_grad_(True) for k, v in params.items()}
        x, y = torch.as_tensor(x), torch.as_tensor(y).long()
        logits = x @ p["w"] + p["b"]
        loss = -torch.log_softmax(logits, -1).gather(1, y[:, None]).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return loss.detach(), acc, dict(zip(
            p, torch.autograd.grad(loss, list(p.values()))))

    return j_fn, t_fn


def test_party_step_quantized_matches_jax_and_the_block_bound():
    rng = np.random.default_rng(1)
    params = {"w": (rng.standard_normal((16, 40)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal(40) * 0.1).astype(np.float32)}
    x = rng.standard_normal((32, 16)).astype(np.float32)
    y = rng.integers(0, 40, 32).astype(np.int32)
    j_fn, t_fn = _grad_fns()
    jmesh = j_make_mesh({"dp": 4}, jax.devices()[:4])
    lj, aj, gj = j_make_party_step_quantized(j_fn, jmesh)(params, x, y)
    mesh = party_meshes(1, ["cpu"] * 4)[0]
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    lt, at, gt = make_party_step_quantized(t_fn, mesh)(tp, x, y)
    _, _, exact = make_party_step(t_fn, mesh)(tp, x, y)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert float(at) == float(aj)
    assert list(gt) == list(params)
    # each leg rounds an element by at most half its block's int8 step,
    # absmax / 254: within 2 · A / 254 of the exact mean, A the larger
    # block absmax of the ranks' vectors and the mean (the concatenated,
    # sorted-key vector's blocks), plus 4 f32 ulps of A for the two
    # steps' own sums
    def blocks(g):
        v = torch.cat([g[k].reshape(-1) for k in sorted(g)])
        return torch.nn.functional.pad(v, (0, (-v.numel()) % BLOCK)
                                       ).reshape(-1, BLOCK)

    ranks = [o[2] for o in _per_rank(t_fn, mesh, tp, x, y)[0]]
    amax = torch.stack([blocks(g).abs().amax(1)
                        for g in ranks + [exact]]).amax(0)
    err = (blocks(gt) - blocks(exact)).abs().amax(1)
    assert bool((err <= amax * (2 / 254 + 4 * 2.0 ** -23)).all()), \
        (err / amax).max()
    for k in params:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   atol=1e-7, err_msg=k)
    # and JAX's exact party step for scale: the int8 wire moved them
    je = j_make_party_step(j_fn, jmesh)(params, x, y)[2]
    assert not np.array_equal(gt["w"].numpy(), np.asarray(je["w"]))
