"""The port's codec kernels against the JAX package (CPU).

- strided layout: the plain PyTorch versions against the Pallas kernels
  run in interpret mode (``quantize_2bit_tpu`` / ``dequantize_2bit_tpu``
  / ``dgc_update_tpu``), bitwise — codes, residual (``-0.0`` turns
  ``+0.0`` there) and outputs;
- consecutive layout: frames byte-identical to the host ``TwoBitCodec``
  and to the JAX device codec ``DeviceTwoBitCodec`` over several rounds,
  residuals bitwise (``-0.0`` kept), and decode bitwise against both;
- DGC on dyadic inputs, where a fused multiply-add and two rounded
  operations agree, so the comparison is bitwise whatever XLA fuses;
- the dispatcher: CPU tensors take the plain version, the CUDA C++
  kernel wrappers refuse a CPU tensor, and a CUDA card (when present)
  holds each kernel against its plain version bitwise on aligned
  tensors (offset views, in place and more sizes in
  ``test_torch_quantize_cuda.py``);
- the plain DGC update writes into ``out``, in place, bitwise as out
  of place.

Tolerance everywhere: exact (bit patterns compared).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomx_tpu.compression.codecs import TwoBitCodec
from geomx_tpu.core.config import Config, Topology
from geomx_tpu.kvstore.jax_backend import JaxBackend
from geomx_tpu.ops.quantize import (dequantize_2bit_tpu, dgc_update_tpu,
                                    quantize_2bit_tpu)
from geomx_tpu_torch.ops import quantize as Q
from geomx_tpu_torch.ops.kernels import quantize_cuda as C

THR = 0.5


def _inputs(n, seed=0):
    """Dyadic gradient/residual with signed zeros and exact ±t sums."""
    rng = np.random.default_rng(seed)
    g = (rng.integers(-12, 13, n) / 16).astype(np.float32)
    r = (rng.integers(-12, 13, n) / 16).astype(np.float32)
    g[0::7] = -0.0
    r[0::7] = -0.0        # r + g = -0.0
    g[1::11] = THR
    r[1::11] = 0.0        # r + g = +t exactly → code 0
    g[2::13] = -THR
    r[2::13] = 0.0        # r + g = -t exactly → code 0
    return g, r


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("n", [1, 5, 4097, 131_073])
def test_strided_matches_pallas_interpret_bitwise(n):
    g, r = _inputs(n, seed=n)
    p_j, r_j = quantize_2bit_tpu(jnp.asarray(g), jnp.asarray(r), THR,
                                 interpret=True)
    p_t, r_t = Q.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r),
                               THR, "strided")
    assert _bits(p_j) == _bits(p_t.numpy())
    assert _bits(r_j) == _bits(r_t.numpy())
    # the Pallas residual form turns the -0.0 sums into +0.0
    z = r_t.numpy()[0::7]
    assert not np.signbit(z[z == 0]).any()
    assert p_t.numel() == Q.packed_len(n, "strided")
    d_j = dequantize_2bit_tpu(p_j, n, THR, interpret=True)
    d_t = Q.dequantize_2bit(p_t, n, THR, "strided")
    assert _bits(d_j) == _bits(d_t.numpy())


@pytest.mark.parametrize("n", [1, 4097, 131_073])
def test_dgc_matches_pallas_interpret_bitwise(n):
    rng = np.random.default_rng(n)
    v = (rng.integers(-64, 65, n) / 32).astype(np.float32)
    u = (rng.integers(-64, 65, n) / 16).astype(np.float32)
    g = (rng.integers(-64, 65, n) / 64).astype(np.float32)
    vj, uj = dgc_update_tpu(jnp.asarray(v), jnp.asarray(u), jnp.asarray(g),
                            0.75, interpret=True)
    vt, ut = Q.dgc_update(torch.from_numpy(v), torch.from_numpy(u),
                          torch.from_numpy(g), 0.75)
    assert _bits(vj) == _bits(vt.numpy())
    assert _bits(uj) == _bits(ut.numpy())


def _jax_two_bit():
    cfg = Config(topology=Topology())
    stage = JaxBackend(cfg).make_codec_stage(cfg)
    return stage, stage.make_push_codec({"type": "2bit", "threshold": THR})


@pytest.mark.parametrize("n", [1, 6, 4097])
def test_consecutive_frames_match_host_and_jax_codecs(n):
    """Three rounds of residual feedback: each frame byte-identical to
    the host codec's and the JAX device codec's, residual bitwise."""
    host = TwoBitCodec(THR)
    stage, dev = _jax_two_bit()
    r = torch.zeros(n)
    for rnd in range(3):
        g, _ = _inputs(n, seed=100 * rnd + n)
        frame_host = host.compress(0, g.copy())
        frame_jax = dev.compress(0, jnp.asarray(g))
        packed, r = Q.quantize_2bit(torch.from_numpy(g), r, THR,
                                    "consecutive")
        assert packed.numpy().tobytes() == frame_host.tobytes()
        assert packed.numpy().tobytes() == np.asarray(frame_jax).tobytes()
        assert _bits(r.numpy()) == _bits(dev._residual[0])
        out = Q.dequantize_2bit(packed, n, THR, "consecutive")
        assert _bits(out.numpy()) == _bits(host.decompress(0, frame_host, n))
        assert _bits(out.numpy()) == _bits(
            stage.decode("2bit", 0, frame_host, n, THR))


def test_consecutive_residual_keeps_negative_zero():
    g, r = _inputs(29)
    _, new_r = Q.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r),
                               THR, "consecutive")
    z = new_r.numpy()[0::7]
    assert (z == 0).sum() >= 3 and np.signbit(z[z == 0]).all()
    # values exactly at ±t stay in the residual, uncoded
    assert (new_r.numpy()[[1, 12]] == THR).all()
    assert (new_r.numpy()[[2, 15]] == -THR).all()


def test_inputs_are_not_modified():
    g, r = _inputs(4097)
    tg, tr = torch.from_numpy(g.copy()), torch.from_numpy(r.copy())
    for layout in Q.LAYOUTS:
        Q.quantize_2bit(tg, tr, THR, layout)
    Q.dgc_update(tr, tr.clone(), tg, 0.9)
    assert _bits(tg.numpy()) == _bits(g) and _bits(tr.numpy()) == _bits(r)


def test_dispatch_cpu_uses_plain_version_and_kernel_refuses_cpu():
    g, r = _inputs(64)
    tg, tr = torch.from_numpy(g), torch.from_numpy(r)
    before = C.launches()
    Q.quantize_2bit(tg, tr, THR, "consecutive")
    Q.dequantize_2bit(torch.zeros(16, dtype=torch.uint8), 64, THR)
    Q.dgc_update(tr, tr, tg, 0.9)
    Q.dgc_update(tr.clone(), tr.clone(), tg, 0.9, out=(tr.clone(),
                                                       tr.clone()))
    assert C.launches() == before  # no kernel on the host
    with pytest.raises(ValueError, match="CUDA"):
        C.quantize_2bit(tg, tr, THR, "consecutive")
    with pytest.raises(ValueError, match="CUDA"):
        C.dequantize_2bit(torch.zeros(16, dtype=torch.uint8), 64, THR,
                          "consecutive")
    with pytest.raises(ValueError, match="CUDA"):
        C.dgc_update(tr, tr, tg, 0.9)
    with pytest.raises(ValueError, match="layout"):
        Q.quantize_2bit(tg, tr, THR, "rows")


@pytest.mark.parametrize("fn", ["quantize", "dequantize"])
@pytest.mark.parametrize("mod", ["dispatcher", "kernel"])
def test_unknown_layout_raises_on_every_route(fn, mod):
    """A misspelled layout is refused before any route is chosen: the
    CUDA kernel wrapper checks it too, so the card never falls through
    to the consecutive kernel."""
    g, r = _inputs(64)
    tg, tr = torch.from_numpy(g), torch.from_numpy(r)
    m = Q if mod == "dispatcher" else C
    with pytest.raises(ValueError, match="layout"):
        if fn == "quantize":
            m.quantize_2bit(tg, tr, THR, "stride")
        else:
            m.dequantize_2bit(torch.zeros(16, dtype=torch.uint8), 64, THR,
                              "stride")


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_dgc_in_place_equals_out_of_place_bitwise(momentum):
    """``out=(v, u)`` updates the inputs themselves; the result is the
    out-of-place one bit for bit, signed zeros included."""
    g, r = _inputs(4097, seed=3)
    rng = np.random.default_rng(4)
    v = (rng.standard_normal(4097) * 0.3).astype(np.float32)
    v[0::7] = -0.0
    tv, tu, tg = (torch.from_numpy(a.copy()) for a in (v, r, g))
    want_v, want_u = Q.dgc_update_ref(tv, tu, tg, momentum)
    got = Q.dgc_update(tv, tu, tg, momentum, out=(tv, tu))
    assert got[0] is tv and got[1] is tu
    assert _bits(tv.numpy()) == _bits(want_v.numpy())
    assert _bits(tu.numpy()) == _bits(want_u.numpy())
    z = tu.numpy()[0::7]
    assert (z == 0).sum() > 100 and np.signbit(z[z == 0]).all()
    assert _bits(tg.numpy()) == _bits(g)


def test_dequantize_rejects_short_payload():
    with pytest.raises(ValueError, match="bytes"):
        Q.dequantize_2bit(torch.zeros(3, dtype=torch.uint8), 64, THR)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 401_408])
def test_kernels_match_plain_versions_on_card(n):
    """On a CUDA card: each CUDA kernel against its plain version on the
    same device tensors, bitwise, in both layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    g, r = _inputs(n, seed=n)
    tg, tr = torch.from_numpy(g).cuda(), torch.from_numpy(r).cuda()
    for layout in Q.LAYOUTS:
        pk, rk = C.quantize_2bit(tg, tr, THR, layout)
        pp, rp = Q.quantize_2bit_ref(tg, tr, THR, layout)
        assert torch.equal(pk, pp)
        assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
        dk = C.dequantize_2bit(pk, n, THR, layout)
        dp = Q.dequantize_2bit_ref(pk, n, THR, layout)
        assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
    vk, uk = C.dgc_update(tr, tr * 2, tg, 0.9)
    vp, up = Q.dgc_update_ref(tr, tr * 2, tg, 0.9)
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))
    assert torch.equal(uk.view(torch.int32), up.view(torch.int32))
