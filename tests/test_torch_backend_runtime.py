"""The torch backend inside the runtime, against the numpy control (CPU).

Counterparts, on ``TorchBackend("cpu")`` (``merge_backend="torch:cpu"``),
of the scenarios of ``tests/test_device_opt.py``,
``tests/test_merge_backend.py`` and ``tests/test_device_codec.py`` that
``tests/test_torch_backend.py`` and ``tests/test_torch_merge_mesh.py``
do not hold:

- steady-state rounds under the device optimizer move ``d2h_bytes`` by
  nothing (and allocate nothing of a tensor's size on the host); a
  serve pays one weight materialization, cached until the next round;
  compressed rounds under the device codecs pay no merge-plane D2H, no
  full-tensor codec copy and no global re-staging: only the wire
  payload and the serves;
- a checkpoint is a materialization event and a warm boot from it
  continues bitwise as staying up;
- a handoff range merge lands the shipped momentum in the device
  trajectory (the host shell stays empty);
- a failover mid-run with the device optimizer continues bitwise equal
  to the numpy control (-2.125: the momentum survived);
- the int8 rung's residual reaches loss parity with exact f32 over 60
  SGD rounds where the rung without it drifts (the recovery case is
  ``tests/test_torch_merge_mesh.py``'s);
- a full two-tier FSA round trip bitwise equal to numpy, with the
  backend's gauges in the registry;
- the device decoders under truncation and bit flips (a typed
  ``CodecError`` or a right-shaped f32 tensor), unknown tags and bad
  geometry, and sparse indices fenced before any scatter.

Tolerances: bitwise everywhere (integer-valued gradients and
powers-of-two hyper-parameters make every sum exact), except the
residual's loss bounds, which are the JAX test's. Imports nothing of
JAX.
"""

import time
import tracemalloc

import numpy as np
import pytest
import torch

import geomx_tpu_torch.kvstore.torch_backend as tb
from geomx_tpu_torch.compression.codecs import CodecError, pack_sparse
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.kvstore import checkpoint as ckpt
from geomx_tpu_torch.kvstore.common import Cmd
from geomx_tpu_torch.optim import make_optimizer
from geomx_tpu_torch.ps.kv_app import KVPairs
from geomx_tpu_torch.transport.message import Message
from geomx_tpu_torch.utils.metrics import system_snapshot

SPEC = {"type": "sgd", "lr": 0.5, "momentum": 0.5}


def _gs_harness(elems=1 << 18, parties=4, spec=None, **cfg_kw):
    """A global server on ``torch:cpu`` fed whole rounds by hand (no
    wire): ``(sim, gs, one_round)``."""
    sim = Simulation(Config(topology=Topology(num_parties=parties,
                                              workers_per_party=1),
                            merge_backend="torch:cpu", **cfg_kw))
    gs = sim.global_servers[0]
    gs.server.response = lambda *a, **k: None
    with gs._mu:
        if spec is not None:
            gs.optimizer = make_optimizer(dict(spec))
            gs._optimizer_configured = True
            gs._activate_dev_opt_locked()
        gs.store[0] = np.zeros(elems, np.float32)
    senders = [sim.topology.server(p) for p in range(parties)]
    ts = [0]
    grads = [np.full(elems, float(i + 1), np.float32)
             for i in range(parties)]

    def one_round():
        for i, s in enumerate(senders):
            ts[0] += 1
            m = Message(sender=s, recipient=gs.po.node, push=True,
                        request=True, timestamp=ts[0], cmd=Cmd.DEFAULT,
                        keys=np.array([0], np.int64), vals=grads[i],
                        lens=np.array([elems], np.int64))
            gs._handle(m, KVPairs(m.keys, m.vals, m.lens), gs.server)
        gs._shards.drain()

    return sim, gs, one_round


def test_steady_state_rounds_zero_d2h():
    elems = 1 << 18
    sim, gs, one_round = _gs_harness(elems=elems, spec=SPEC)
    try:
        assert isinstance(gs._backend, tb.TorchBackend)
        one_round()
        rounds0 = gs.key_rounds
        d2h0 = gs._backend.stats()["d2h_bytes"]
        tracemalloc.start()
        try:
            for _ in range(5):
                one_round()
            _, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        st = gs.stats()
        assert gs.key_rounds == rounds0 + 5, "rounds did not complete"
        assert st["d2h_bytes"] == d2h0, st["d2h_bytes"] - d2h0
        assert st["opt_device"] == "sgd"
        assert st["opt_device_ms"] > 0
        assert peak < elems * 4 // 2, f"host copy on the round path: {peak}"
        w = gs.store[0]
        assert len(w) == elems
        d2h2 = gs._backend.stats()["d2h_bytes"]
        assert d2h2 == d2h0 + elems * 4
        _ = gs.store[0]
        assert gs._backend.stats()["d2h_bytes"] == d2h2
        snap = system_snapshot()
        assert any(k.endswith(".d2h_bytes") for k in snap)
        assert any(k.endswith(".opt_device_ms") for k in snap)
    finally:
        sim.shutdown()


def test_steady_state_compressed_rounds_zero_host_copies(monkeypatch):
    monkeypatch.setenv("GEOMX_MERGE_BACKEND", "torch:cpu")
    monkeypatch.setenv("GEOMX_CODEC_DEVICE", "1")
    n = 20000
    sim = Simulation(Config(topology=Topology(num_parties=2,
                                              workers_per_party=1)))
    try:
        ws = sim.all_workers()
        for w in ws:
            w.init(0, np.zeros(n, np.float32))
        ws[0].set_optimizer({"type": "sgd", "lr": 0.05})
        for p in range(2):
            sim.worker(p, 0).set_gradient_compression(
                {"type": "bsc", "ratio": 0.05})

        def one_round():
            g = np.ones(n, np.float32)
            for w in ws:
                w.push(0, g)
            return [w.pull_sync(0) for w in ws]

        one_round()

        def counters(servers):
            return [(be.d2h_bytes, be.h2d_bytes, be.codec_host_bytes,
                     be.codec_d2h_bytes)
                    for be in (s._backend for s in servers)]

        loc0 = counters(sim.local_servers)
        glob0 = counters(sim.global_servers)
        for _ in range(5):
            one_round()
        wire = 5 * 2 * max(1, int(0.05 * n)) * 4
        for (d0, h0, c0, w0), (d1, h1, c1, w1) in zip(
                loc0, counters(sim.local_servers)):
            assert d1 - d0 == 0, f"local merge plane paid D2H: {d1 - d0}"
            assert c1 - c0 == 0, f"full-tensor host copy: {c1 - c0}"
            assert w1 - w0 == wire, (w1 - w0, wire)
            assert h1 - h0 == 5 * n * 4
        for (d0, h0, c0, _), (d1, h1, c1, _) in zip(
                glob0, counters(sim.global_servers)):
            assert h1 - h0 == 0, f"global tier re-staged grads: {h1 - h0}"
            assert c1 - c0 == 0
            assert d1 - d0 == 5 * n * 4, (d1 - d0, 5 * n * 4)
        outs = one_round()
        assert outs[0].mean() < -0.05
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
    finally:
        sim.shutdown()


def test_checkpoint_event_materializes_and_restores_trajectory(tmp_path):
    sim, gs, one_round = _gs_harness(elems=4096, spec=SPEC)
    try:
        for _ in range(3):
            one_round()
        path = str(tmp_path / "gs.npz")
        with gs._mu:
            store_snap = {k: v.copy() for k, v in gs.store.items()}
            opt_snap = gs._export_opt_locked()
        assert 0 in opt_snap.state, "moments missing from the export"
        ckpt.save_server_state(path, store_snap,
                               {"optimizer": opt_snap}, {})
        one_round()
        one_round()
        live = gs.store[0].copy()
        gs.load_checkpoint(path)
        assert gs._dev_opt is not None, "restore left the device stage off"
        one_round()
        one_round()
        assert gs.store[0].tobytes() == live.tobytes()
    finally:
        sim.shutdown()


def test_handoff_range_merge_imports_device_state():
    sim, gs, one_round = _gs_harness(elems=4096, spec=SPEC)
    try:
        one_round()
        shipped = make_optimizer(dict(SPEC))
        shipped.state[7] = {"mom": np.full(16, 2.0, np.float32)}
        with gs._mu:
            gs._merge_state_locked({7: np.zeros(16, np.float32)},
                                   {"optimizer": shipped},
                                   {"optimizer_configured": True})
        assert gs.optimizer.state == {}  # single owner: the device
        assert isinstance(gs._dev_opt._st[7]["mom"], torch.Tensor)
        exported = gs._export_opt_locked()
        assert exported.state[7]["mom"].tobytes() == np.full(
            16, 2.0, np.float32).tobytes()
        assert 0 in exported.state
    finally:
        sim.shutdown()


def _run_failover(backend):
    sim = Simulation(Config(
        topology=Topology(num_parties=2, workers_per_party=1,
                          num_standby_globals=1),
        request_retry_s=0.4, heartbeat_interval_s=0.05,
        heartbeat_timeout_s=0.4, replicate_every=1,
        merge_backend=backend))
    try:
        ws = sim.all_workers()
        for w in ws:
            w.init(0, np.zeros(16, np.float32))
        ws[0].set_optimizer(dict(SPEC))
        for _ in range(2):
            for w in ws:
                w.push(0, np.ones(16, np.float32))
            for w in ws:
                w.pull_sync(0)
                w.wait_all()
        sb = sim.standby_globals[0]
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if (sb._repl_seq >= 1 and 0 in sb.store
                    and np.allclose(sb.store[0], -1.25)):
                break
            time.sleep(0.02)
        assert np.allclose(sb.store[0], -1.25), "replication stalled"
        sim.kill_global_server(0)
        for w in ws:
            w.push(0, np.ones(16, np.float32))
        got = {}
        for i, w in enumerate(ws):
            w.pull(0, lambda t, v, i=i: got.__setitem__(i, np.array(v)))
        for w in ws:
            w.wait_all()
        assert not sb.is_standby and sb.promotions == 1
        if backend != "numpy":
            assert sb._dev_opt is not None
        return got[0].tobytes()
    finally:
        sim.shutdown()


def test_failover_device_opt_trajectory_bitwise_vs_numpy_control():
    w_torch = _run_failover("torch:cpu")
    w_np = _run_failover("numpy")
    assert w_torch == w_np
    np.testing.assert_allclose(np.frombuffer(w_torch, np.float32), -2.125)


def _quantized_round(be, parts, key=0):
    acc = be.seed(parts[0].copy(), donated=True, key=key)
    for p in parts[1:]:
        acc = be.accumulate(acc, p.copy())
    return be.materialize(acc)


def test_residual_reaches_loss_parity_over_training(monkeypatch):
    monkeypatch.setattr(tb, "_MESH_MIN_ELEMS", 256)
    n, parties, rounds, lr = 1024, 4, 60, 0.05
    w_star = np.full(n, 0.1, np.float32)
    w_star[0] = 4000.0

    def rung(residual):
        return tb.TorchBackend(Config(topology=Topology(),
                                      merge_quantized=True,
                                      merge_residual=residual),
                               "cpu", devices=["cpu"] * 4)

    def train(be=None):
        w = np.zeros(n, np.float32)
        for _ in range(rounds):
            grad = (w - w_star).astype(np.float32)
            parts = [grad] * parties
            s = grad * float(parties) if be is None \
                else _quantized_round(be, parts)
            w = w - lr * (s / parties)
        return float(np.mean((w - w_star)[1:] ** 2))

    loss_f32 = train()
    loss_ef = train(rung(True))
    loss_no = train(rung(False))
    assert loss_ef < 0.2 * loss_no, (loss_f32, loss_ef, loss_no)
    assert loss_ef <= loss_f32 + 0.1 * loss_no, (loss_f32, loss_ef,
                                                 loss_no)


def _train_rounds(steps=2, lr=0.1, **cfg_kw):
    sim = Simulation(Config(topology=Topology(num_parties=2,
                                              workers_per_party=2),
                            **cfg_kw))
    try:
        ws = sim.all_workers()
        for w in ws:
            w.init(0, np.zeros(2048, np.float32))
        ws[0].set_optimizer({"type": "sgd", "lr": lr})
        for _ in range(steps):
            for i, w in enumerate(ws):
                w.push(0, np.full(2048, float(i + 1), np.float32))
            for w in ws:
                w.pull_sync(0)
                w.wait_all()
        out = ws[0].pull_sync(0)
        ls = sim.local_servers[0]
        return np.array(out), ls._backend.name, ls.stats()
    finally:
        sim.shutdown()


def test_e2e_torch_backend_matches_numpy_bitwise():
    w_np, be_np, _ = _train_rounds(merge_backend="numpy")
    w_t, be_t, st = _train_rounds(merge_backend="torch:cpu")
    assert (be_np, be_t) == ("numpy", "torch")
    assert st["merge_backend"] == "torch"
    assert st["h2d_bytes"] > 0
    assert w_np.tobytes() == w_t.tobytes()


def test_torch_backend_registry_gauges_set():
    _train_rounds(merge_backend="torch:cpu", steps=1)
    snap = system_snapshot()
    keyed = {k for k in snap if k.endswith(".merge_device_ms")
             or k.endswith(".h2d_bytes")}
    assert keyed, f"merge gauges missing: {sorted(snap)[:8]}"


def _stage():
    return tb.TorchBackend(Config(topology=Topology()), "cpu") \
        .make_codec_stage(None)


def _fuzz_decode(decode, orig_len):
    try:
        out = decode()
    except CodecError:
        return "typed-reject"
    assert isinstance(out, torch.Tensor)
    assert tuple(out.shape) == (orig_len,), f"wrong shape {out.shape}"
    assert out.dtype == torch.float32
    return "decoded"


@pytest.mark.parametrize("codec_name", ["bsc", "fp16", "2bit"])
def test_device_decoder_fuzz_truncate_bitflip(codec_name):
    rng = np.random.default_rng({"bsc": 11, "fp16": 12, "2bit": 13}
                                [codec_name])
    n = 4096
    grad = rng.standard_normal(n).astype(np.float32) * 2.0
    stage = _stage()
    body = {"bsc": {"type": "bsc", "ratio": 0.05},
            "fp16": {"type": "fp16"},
            "2bit": {"type": "2bit", "threshold": 0.5}}[codec_name]
    codec = stage.make_push_codec(body)
    payload = np.asarray(codec.compress(1, grad))
    tag = codec.name
    out1 = stage.decode(tag, 1, payload, n).cpu().numpy()
    out2 = stage.decode(tag, 1, payload.copy(), n).cpu().numpy()
    assert out1.shape == (n,)
    assert out1.tobytes() == out2.tobytes()
    raw = payload.tobytes()
    item = payload.dtype.itemsize

    def decode_bytes(b):
        arr = (np.frombuffer(b, dtype=payload.dtype)
               if len(b) % item == 0
               else np.frombuffer(b, dtype=np.uint8))
        return stage.decode(tag, 1, arr, n)

    rejects = 0
    for cut in rng.choice(max(1, len(raw) - 1), size=48, replace=False):
        rejects += _fuzz_decode(
            lambda: decode_bytes(raw[:int(cut)]), n) == "typed-reject"
    assert rejects > 0, "no truncation was ever rejected"
    for _ in range(96):
        dam = bytearray(raw)
        pos = int(rng.integers(len(dam) * 8))
        dam[pos // 8] ^= 1 << (pos % 8)
        _fuzz_decode(lambda: decode_bytes(bytes(dam)), n)


def test_device_decoder_rejects_unknown_tag_and_bad_geometry():
    stage = _stage()
    with pytest.raises(CodecError, match="unknown"):
        stage.decode("zstd9", 1, np.ones(4, np.float32), 4)
    with pytest.raises(CodecError):
        stage.decode("fp16", 1, np.ones(3, np.float16), 4)
    with pytest.raises(CodecError):
        stage.decode("2bit", 1, np.zeros(2, np.uint8), 64)
    with pytest.raises(CodecError):
        stage.decode("bsc", 1, np.ones(3, np.float32), 16)


def test_device_sparse_scatter_indices_are_fenced():
    stage = _stage()
    vals = np.array([1.0, 2.0], np.float32)
    for idx in ([-3, 0], [0, 10 ** 6]):
        payload = pack_sparse(vals, np.array(idx, np.int64))
        with pytest.raises(CodecError, match="index"):
            stage.decode("bsc", 5, payload, 16)
