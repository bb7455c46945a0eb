"""The port's torch merge backend (CPU device) against the JAX package.

Scenarios of ``tests/test_merge_backend.py``, ``tests/test_device_opt.py``
and ``tests/test_device_codec.py``, held against the reference engines:

- merge: integer-valued f32 pushes sum bitwise like the numpy backend;
  f16 pushes promote to an f32 accumulator; a non-donated payload is
  never aliased or written;
- device optimizer: 5 rounds × 4 pushers of integer gradients with
  powers-of-two hyper-parameters — SGD (plain, momentum, momentum+wd)
  and NAG bitwise against ``optim/server_opt.py`` (weights and exported
  state); Adam within rtol 1e-6 (division and square root are correctly
  rounded on both sides, but the tolerance leaves room for a library's
  sqrt/div); an export → import handover continues bitwise;
- codec stage: fp16 and 2bit frames byte-identical to the host codecs
  and the JAX device codecs; BSC frames byte-identical to the JAX device
  codec on tie-free input; every frame cross-decodes bitwise between the
  port, the host codecs and the JAX codec stage; the decode gates raise
  the same ``CodecError``; BSC's velocity and accumulator, updated in
  place, match an out-of-place loop of the plain DGC update bitwise;
- backend choice: ``auto`` → torch (raises without CUDA), ``torch:cpu``
  by name, ``deterministic`` → numpy, unknown names rejected; a torch
  backend refuses to move its optimizer or codec stage to the host.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomx_tpu.compression import (BscCodec, Fp16Codec, TwoBitCodec,
                                   decompress_payload)
from geomx_tpu.compression.codecs import pack_sparse
from geomx_tpu.core.config import Config as JConfig, Topology as JTopology
from geomx_tpu.kvstore.backend import NumpyBackend as JNumpyBackend
from geomx_tpu.kvstore.jax_backend import JaxBackend
from geomx_tpu.optim import make_optimizer as j_make_optimizer
from geomx_tpu_torch.compression.codecs import CodecError
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore.backend import (NumpyBackend, make_merge_backend,
                                             resolve_merge_backend)
from geomx_tpu_torch.kvstore.torch_backend import (CodecStage, DeviceWeight,
                                                   TorchBackend)
from geomx_tpu_torch.ops.quantize import dgc_update_ref


def _cfg(**kw):
    return Config(topology=Topology(), **kw)


def _be(**kw):
    return TorchBackend(_cfg(**kw), device="cpu")


def _rounds(rounds=5, pushers=4, n=2048, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [[rng.integers(-8, 9, n).astype(dtype) for _ in range(pushers)]
            for _ in range(rounds)]


# ---- backend choice ---------------------------------------------------------

def test_backend_choice_rules(monkeypatch):
    monkeypatch.delenv("GEOMX_MERGE_BACKEND", raising=False)
    assert resolve_merge_backend(_cfg()) == "torch"
    assert resolve_merge_backend(_cfg(merge_backend="torch:cpu")) == "torch:cpu"
    assert resolve_merge_backend(_cfg(merge_backend="numpy")) == "numpy"
    assert resolve_merge_backend(
        _cfg(merge_backend="torch:cpu", deterministic=True)) == "numpy"
    for bad in ("jax", "torch:cuda:1", "numpy:cpu"):
        with pytest.raises(ValueError):
            resolve_merge_backend(_cfg(merge_backend=bad))
    monkeypatch.setenv("GEOMX_MERGE_BACKEND", "torch:cpu")
    assert isinstance(make_merge_backend(_cfg()), TorchBackend)
    assert isinstance(make_merge_backend(_cfg(merge_backend="numpy")),
                      NumpyBackend)


def test_auto_raises_without_cuda_instead_of_degrading(monkeypatch):
    monkeypatch.delenv("GEOMX_MERGE_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_merge_backend(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_merge_backend(_cfg(merge_backend="torch"))


# ---- merge ------------------------------------------------------------------

def test_f32_merge_exact_parity_with_numpy():
    be, ref = _be(), JNumpyBackend(JConfig(topology=JTopology()))
    for grads in _rounds(rounds=2):
        a = be.seed(grads[0].copy(), donated=False, key=0)
        b = ref.seed(grads[0].copy(), donated=False, key=0)
        for g in grads[1:]:
            a = be.accumulate(a, g)
            b = ref.accumulate(b, g)
        a = be.scale(a, 0.25)
        b = ref.scale(b, 0.25)
        assert be.materialize(a).tobytes() == ref.materialize(b).tobytes()
    st = be.stats()
    assert st["merge_backend"] == "torch" and st["merge_device"] == "cpu"
    assert st["h2d_bytes"] == 2 * 4 * 2048 * 4


def test_f16_promotes_to_f32_accumulator():
    be = _be()
    g = np.arange(-6, 6, dtype=np.float16) / 4
    acc = be.seed(g, donated=True, key=0)
    acc = be.accumulate(acc, g)
    out = be.materialize(acc)
    assert out.dtype == np.float32
    assert out.tobytes() == (2 * g.astype(np.float32)).tobytes()


def test_non_donated_payload_never_aliased_or_written():
    be = _be()
    g = np.ones(64, np.float32)
    frozen = g.copy()
    frozen.flags.writeable = False
    acc = be.seed(frozen, donated=False, key=0)
    acc = be.accumulate(acc, g)
    host = be.materialize(acc)
    assert host.flags.writeable
    assert not np.may_share_memory(host, frozen)
    assert (frozen == 1).all() and (g == 1).all()
    # a donated device tensor (a decode output) is adopted, not copied
    t = torch.ones(8)
    assert be.seed(t, donated=True).data_ptr() == t.data_ptr()
    assert be.seed(t, donated=False).data_ptr() != t.data_ptr()


def test_screen_finite():
    be = _be()
    assert be.screen_finite(np.ones(4, np.float32))
    assert not be.screen_finite(np.array([1, np.nan], np.float32))
    assert not be.screen_finite(torch.tensor([1.0, 9.0]), mag_max=4.0)


# ---- device optimizer -------------------------------------------------------

OPT_SPECS = [
    {"type": "sgd", "lr": 0.5},
    {"type": "sgd", "lr": 0.5, "momentum": 0.5},
    {"type": "sgd", "lr": 0.5, "momentum": 0.5, "wd": 0.25},
    {"type": "nag", "lr": 0.5, "momentum": 0.5},
    {"type": "adam", "lr": 0.25, "beta1": 0.5, "beta2": 0.5, "eps": 1.0},
]


def _numpy_trajectory(spec, rounds, w0, scale):
    be = JNumpyBackend(JConfig(topology=JTopology()))
    opt = j_make_optimizer(dict(spec))
    w = w0.copy()
    for grads in rounds:
        acc = be.seed(grads[0].copy(), donated=True, key=0)
        for g in grads[1:]:
            acc = be.accumulate(acc, g.copy())
        w = opt.update_scaled(0, w, be.materialize(acc), scale)
    return w, opt


def _device_trajectory(spec, rounds, w0, scale, be=None, dev=None,
                       raw=None):
    be = be or _be()
    dev = dev or be.make_device_optimizer(dict(spec))
    raw = w0.copy() if raw is None else raw
    for grads in rounds:
        acc = be.seed(grads[0].copy(), donated=True, key=0)
        for g in grads[1:]:
            acc = be.accumulate(acc, g.copy())
        raw = dev.step(0, raw, acc, scale)
    return raw, dev


def _state(opt):
    return {k: {n: (v.tobytes() if isinstance(v, np.ndarray) else v)
                for n, v in sorted(st.items())}
            for k, st in sorted(opt.state.items())}


@pytest.mark.parametrize("spec", OPT_SPECS, ids=lambda s: "-".join(
    str(v) for v in s.values()))
def test_device_optimizer_matches_numpy(spec):
    rounds = _rounds()
    w0 = np.zeros(2048, np.float32)
    w_np, opt_np = _numpy_trajectory(spec, rounds, w0, 0.25)
    raw, dev = _device_trajectory(spec, rounds, w0, 0.25)
    assert isinstance(raw, DeviceWeight)
    w_dev = raw.host()
    if spec["type"] == "adam":
        np.testing.assert_allclose(w_dev, w_np, rtol=1e-6, atol=0)
        return
    assert w_dev.tobytes() == w_np.tobytes()
    assert _state(dev.export_state()) == _state(opt_np)


def test_device_adam_bitwise_with_numpy():
    """The device Adam's square root is rounded to nearest on the host
    too (torch's vectorised CPU sqrt is not): weights and moments equal
    numpy's to the bit, as the JAX suite's contract asks (ROADMAP C16)."""
    spec = {"type": "adam", "lr": 0.25, "beta1": 0.5, "beta2": 0.5,
            "eps": 1.0}
    rounds = _rounds(seed=3)
    w0 = np.zeros(2048, np.float32)
    w_np, opt_np = _numpy_trajectory(spec, rounds, w0, 0.25)
    raw, dev = _device_trajectory(spec, rounds, w0, 0.25)
    assert raw.host().tobytes() == w_np.tobytes()
    assert _state(dev.export_state()) == _state(opt_np)


def test_host_sqrt_rounds_to_nearest():
    from geomx_tpu_torch.kvstore.torch_backend import _sqrt_rn_

    x = np.random.default_rng(1).random(100_000).astype(np.float32) * 100
    t = torch.from_numpy(x.copy())
    assert _sqrt_rn_(t) is t
    assert t.numpy().tobytes() == np.sqrt(x).tobytes()


def test_backend_takes_the_device_its_config_names(monkeypatch):
    monkeypatch.delenv("GEOMX_MERGE_BACKEND", raising=False)
    be = TorchBackend(_cfg(merge_backend="torch:cpu"))
    assert be.device == torch.device("cpu")
    monkeypatch.setenv("GEOMX_MERGE_BACKEND", "torch:cpu")
    assert TorchBackend(_cfg()).device == torch.device("cpu")
    monkeypatch.setenv("GEOMX_MERGE_BACKEND", "torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend(_cfg())


def test_device_optimizer_f16_promotion_bitwise():
    spec = {"type": "sgd", "lr": 0.5, "momentum": 0.5}
    rounds = _rounds(dtype=np.float16)
    w0 = np.zeros(2048, np.float32)
    w_np, _ = _numpy_trajectory(spec, rounds, w0, 0.25)
    raw, _ = _device_trajectory(spec, rounds, w0, 0.25)
    assert raw.host().tobytes() == w_np.tobytes()


def test_export_import_handover_continues_bitwise():
    """3 device rounds, export to the numpy state format, import into a
    fresh device stage and finish: equal to 5 numpy rounds."""
    spec = {"type": "nag", "lr": 0.5, "momentum": 0.5}
    rounds = _rounds(seed=3)
    w0 = np.zeros(2048, np.float32)
    w_ref, _ = _numpy_trajectory(spec, rounds, w0, 0.25)
    raw, dev = _device_trajectory(spec, rounds[:3], w0, 0.25)
    be2 = _be()
    dev2 = be2.make_device_optimizer(dict(spec))
    dev2.import_state(dev.export_state())
    raw2, _ = _device_trajectory(spec, rounds[3:], w0, 0.25, be=be2,
                                 dev=dev2, raw=raw.host().copy())
    assert raw2.host().tobytes() == w_ref.tobytes()
    dev2.drop_key(0)
    assert dev2.stats()["opt_device_keys"] == 0


def test_unsupported_optimizer_stays_on_host():
    be = _be()
    assert be.make_device_optimizer({"type": "dcasgd", "lr": 0.1}) is None
    with pytest.raises(ValueError, match="numpy"):
        _be(merge_opt_device=False)


@pytest.mark.parametrize("off", [
    {"merge_opt_device": False}, {"codec_device": False},
    {"deterministic": True}, "GEOMX_MERGE_OPT_DEVICE", "GEOMX_CODEC_DEVICE"])
def test_device_stages_cannot_be_turned_off(off, monkeypatch):
    """The torch backend never moves its optimizer or codec work to host
    numpy: asking for that, by a Config field or by the env, raises."""
    for var in ("GEOMX_MERGE_OPT_DEVICE", "GEOMX_CODEC_DEVICE"):
        monkeypatch.delenv(var, raising=False)
    kw = off if isinstance(off, dict) else {}
    if isinstance(off, str):
        monkeypatch.setenv(off, "0")
    with pytest.raises(ValueError, match="numpy"):
        _be(**kw)


# ---- codec stage ------------------------------------------------------------

def _stages():
    be = _be()
    stage = be.make_codec_stage(_cfg())
    assert isinstance(stage, CodecStage)
    jcfg = JConfig(topology=JTopology())
    return be, stage, JaxBackend(jcfg).make_codec_stage(jcfg)


def _tie_free(n, seed):
    """Distinct magnitudes: exact top-k has one answer."""
    rng = np.random.default_rng(seed)
    mag = (rng.permutation(n) + 1).astype(np.float32) / 64
    return np.where(rng.random(n) < 0.5, -mag, mag).astype(np.float32)


def test_fp16_frames_byte_identical_and_cross_decode():
    _, stage, jstage = _stages()
    g = _tie_free(1000, 1)
    ours = stage.make_push_codec({"type": "fp16"}).compress(0, torch.from_numpy(g))
    assert ours.tobytes() == Fp16Codec().compress(0, g).tobytes()
    assert ours.tobytes() == np.asarray(
        jstage.make_push_codec({"type": "fp16"}).compress(0, jnp.asarray(g))
    ).tobytes()
    dec = stage.decode("fp16", 0, ours, 1000)
    assert dec.numpy().tobytes() == decompress_payload(
        "fp16", 0, ours, 1000).tobytes()


def test_2bit_frames_byte_identical_across_rounds():
    be, stage, jstage = _stages()
    ours = stage.make_push_codec({"type": "2bit", "threshold": 0.5})
    host = TwoBitCodec(0.5)
    jdev = jstage.make_push_codec({"type": "2bit", "threshold": 0.5})
    rng = np.random.default_rng(5)
    for _ in range(4):
        g = (rng.integers(-6, 7, 4097) / 8).astype(np.float32)
        f = ours.compress(3, torch.from_numpy(g))
        assert f.tobytes() == host.compress(3, g.copy()).tobytes()
        assert f.tobytes() == np.asarray(jdev.compress(3, jnp.asarray(g))).tobytes()
        for dec in (stage.decode("2bit", 3, f, 4097, 0.5).numpy(),
                    ours.decompress(3, f, 4097).numpy()):
            assert dec.tobytes() == host.decompress(3, f, 4097).tobytes()
            assert dec.tobytes() == np.asarray(
                jstage.decode("2bit", 3, f, 4097, 0.5)).tobytes()
    st = be.stats()
    assert st["codec_host_bytes"] == 0 and st["codec_d2h_bytes"] == 4 * 1025


def _pairs(frame):
    vals, idx = frame[:len(frame) // 2], frame[len(frame) // 2:].view(np.int32)
    order = np.argsort(idx)
    return idx[order].tobytes(), vals[order].tobytes()


def test_bsc_frames_match_jax_and_cross_decode_bitwise():
    """Round 0 (tie-free input): the frame is byte-identical to the JAX
    device codec's.  Later rounds (accumulated mass may tie in |u|, and
    the two top-k order ties differently): the same support and values.
    Every frame, ours or the host codec's, decodes bitwise alike under
    the port, the host codecs and the JAX codec stage."""
    _, stage, jstage = _stages()
    ours = stage.make_push_codec({"type": "bsc", "ratio": 0.05,
                                  "momentum": 0.5})
    jdev = jstage.make_push_codec({"type": "bsc", "ratio": 0.05,
                                   "momentum": 0.5})
    host = BscCodec(ratio=0.05, momentum=0.5)
    for rnd in range(3):
        g = _tie_free(2000, 10 + rnd)
        f = ours.compress(1, torch.from_numpy(g))
        fj = np.asarray(jdev.compress(1, jnp.asarray(g)))
        if rnd == 0:
            assert f.tobytes() == fj.tobytes()
        assert _pairs(f) == _pairs(fj)
        fh = host.compress(1, g.copy())
        for frame in (f, fh):
            want = decompress_payload("bsc", 1, frame, 2000)
            assert stage.decode("bsc", 1, frame, 2000).numpy().tobytes() \
                == want.tobytes()
            assert np.asarray(jstage.decode("bsc", 1, frame, 2000)).tobytes() \
                == want.tobytes()


def test_bsc_state_updated_in_place_as_the_out_of_place_loop():
    """Three pushes of one key: each frame, the velocity and the
    accumulator equal, bit for bit, a loop of the out-of-place plain DGC
    update (momentum 0.9, so the product rounds) and the same exact
    top-k; the codec updates its two state tensors in place."""
    stage = _be().make_codec_stage(_cfg())
    codec = stage.make_push_codec({"type": "bsc", "ratio": 0.05,
                                   "momentum": 0.9})
    n, k = 2000, 100
    v, u = torch.zeros(n), torch.zeros(n)
    ptrs = None
    for rnd in range(3):
        g = torch.from_numpy(_tie_free(n, 20 + rnd))
        frame = codec.compress(3, g)
        v, u = dgc_update_ref(v, u, g, 0.9)
        idx = torch.topk(u.abs(), k).indices
        vals = u[idx]
        v[idx] = 0.0
        u[idx] = 0.0
        want = torch.cat([vals, idx.to(torch.int32).view(torch.float32)])
        assert frame.tobytes() == want.numpy().tobytes()
        state = (codec._velocity[3], codec._accum[3])
        assert state[0].numpy().tobytes() == v.numpy().tobytes()
        assert state[1].numpy().tobytes() == u.numpy().tobytes()
        if ptrs is None:
            ptrs = [t.data_ptr() for t in state]
        assert [t.data_ptr() for t in state] == ptrs


def test_compress_never_writes_its_input():
    _, stage, _ = _stages()
    g = torch.from_numpy(_tie_free(512, 2))
    before = g.clone()
    for body in ({"type": "2bit"}, {"type": "bsc", "ratio": 0.1},
                 {"type": "fp16"}):
        stage.make_push_codec(body).compress(0, g)
    assert torch.equal(g, before)


def test_decode_gates_raise_codec_error():
    _, stage, _ = _stages()
    with pytest.raises(CodecError):
        stage.decode("2bit", 0, np.zeros(3, np.uint8), 64)
    with pytest.raises(CodecError):
        stage.decode("fp16", 0, np.zeros(3, np.float16), 4)
    with pytest.raises(CodecError):
        stage.decode("bsc", 0, pack_sparse(np.ones(2, np.float32),
                                           np.array([0, 99])), 10)
    with pytest.raises(CodecError):
        stage.decode("zip", 0, np.zeros(3, np.uint8), 4)
    with pytest.raises(ValueError):
        stage.make_push_codec({"type": "nope"})


def test_mpq_selector_splits_by_size():
    from geomx_tpu_torch.compression import MpqSelector

    _, stage, _ = _stages()
    sel = stage.make_push_codec({"type": "mpq", "size_bound": 100})
    assert isinstance(sel, MpqSelector)
    assert sel.select(1000).name == "bsc" and sel.select(10).name == "fp16"
    assert sel.bsc.device and sel.fp16.device
