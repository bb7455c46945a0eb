"""MixedSync and partition catch-up with a compressed WAN on the torch
backend, against the port's numpy backend.

Under MixedSync (``sync_global_mode=False``) the global server applies
each party's push as it arrives (``GlobalServer._push_async``), and a
healed party's catch-up delta goes through the same update
(``_push_catchup``). With a WAN codec, the torch backend's codec stage
decodes the push into a device tensor: the device optimizer stage takes
it where it lies, a host optimizer (DC-ASGD) after one explicit copy to
the host.

- 2 parties × 2 workers + 1 global server, two keys, 3 rounds, the
  parties' rounds driven one after the other so the global tier sees
  the same order in every run; DC-ASGD (host) and Adam (the device
  stage), under ``2bit`` and ``bsc``: the global weights after the run
  equal the numpy backend's, bit for bit under DC-ASGD (a host
  optimizer on both backends) and within rtol 1e-5 under Adam (the
  device stage against the host ``Adam``, which differ in the last bits
  of their scalar divisions; measured at most 3.7e-9 apart on the host
  and 4.7e-10 apart, 2.2e-6 relative, on an NVIDIA H100). Under ``bsc``
  the local tier
  encodes with the host ``BscCodec`` in both runs: the device encoder
  picks its support by exact top-k and the host one by a sampled
  threshold, so their frames differ by design; the global tier still
  decodes on the device.
- a party cut off behind a WAN blackhole, 3 degraded rounds, heal: its
  2bit catch-up delta merges once on the global tier and the global
  weights equal the numpy backend's bit for bit.

The backend under test is ``torch:cpu``, or what ``GEOMX_MIXED_SYNC_BACKEND``
names (``torch`` on the card: ``chip_smoke.py`` phase 11 runs this file
there, where the decoded push is a CUDA tensor). Imports nothing of JAX.
"""

import importlib
import os
import time

import numpy as np
import pytest

from geomx_tpu_torch.compression import make_push_codec
from geomx_tpu_torch.kvstore.torch_backend import CodecStage, TorchBackend

BACKEND = os.environ.get("GEOMX_MIXED_SYNC_BACKEND", "torch:cpu")
SIZES = (384, 1000)
ROUNDS = 3
OPTS = {"dcasgd": {"type": "dcasgd", "lr": 0.1, "lamda": 0.04},
        "adam": {"type": "adam", "lr": 0.01}}
CODECS = {"2bit": {"type": "2bit", "threshold": 0.5},
          "bsc": {"type": "bsc", "ratio": 0.05}}


def _wait_for(pred, timeout=30.0, every=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


@pytest.fixture
def host_bsc_encoder(monkeypatch):
    """The local tier's BSC push codec is the host one on both backends."""
    device_codec = CodecStage.make_push_codec

    def make(self, config):
        if config.get("type") == "bsc":
            return make_push_codec(config)
        return device_codec(self, config)

    monkeypatch.setattr(CodecStage, "make_push_codec", make)


def _on_the_backend(gs, backend: str) -> None:
    """The global server merges on the torch backend, on the card when
    the backend is ``torch``: its codec stage's decodes are CUDA
    tensors there."""
    assert isinstance(gs._backend, TorchBackend)
    want = "cpu" if backend == "torch:cpu" else "cuda"
    assert gs._backend.device.type == want, gs._backend.device
    assert gs._backend.codec_device_ms > 0  # the stage decoded pushes


def _simulation(pkg: str, parties: int, workers: int, **kw):
    """A ``Simulation`` of package ``pkg``: the port's, or the JAX
    package's for the reference in ``tests/test_torch_mixed_sync_jax.py``."""
    config = importlib.import_module(f"{pkg}.core.config")
    kvstore = importlib.import_module(f"{pkg}.kvstore")
    return kvstore.Simulation(config.Config(
        topology=config.Topology(num_parties=parties,
                                 workers_per_party=workers), **kw))


def _mixed(backend: str, codec: str, opt: str,
           pkg: str = "geomx_tpu_torch") -> dict:
    sim = _simulation(
        pkg, 2, 2, sync_global_mode=False, merge_backend=backend)
    try:
        gss = sim.global_servers

        def key_rounds():
            return sum(g.key_rounds for g in gss)

        ws = sim.all_workers()
        for w in ws:
            for k, n in enumerate(SIZES):
                w.init(k, np.zeros(n, np.float32))
        ws[0].set_optimizer(OPTS[opt])
        for p in range(2):
            sim.worker(p, 0).set_gradient_compression(CODECS[codec])
        rng = np.random.default_rng(5)
        applied = 0
        for _ in range(ROUNDS):
            for p in range(2):
                for i in range(2):
                    for k, n in enumerate(SIZES):
                        sim.worker(p, i).push(
                            k, rng.standard_normal(n).astype(np.float32))
                for i in range(2):
                    sim.worker(p, i).wait_all()
                applied += len(SIZES)
                assert _wait_for(lambda: key_rounds() >= applied), \
                    (key_rounds(), applied)
        assert key_rounds() == applied
        if backend != "numpy":
            for g in gss:
                _on_the_backend(g, backend)
                assert (g._dev_opt is not None) == (opt == "adam")
        return {(i, k): np.array(g.store[k], np.float32)
                for i, g in enumerate(gss) for k in sorted(g.store.keys())}
    finally:
        sim.shutdown()


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_mixed_sync_compressed_matches_numpy(codec, opt, host_bsc_encoder):
    got = _mixed(BACKEND, codec, opt)
    want = _mixed("numpy", codec, opt)
    assert got.keys() == want.keys() and len(want) == len(SIZES)
    for k in want:
        assert np.isfinite(want[k]).all() and np.abs(want[k]).max() > 0
        if opt == "adam":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
        else:
            assert got[k].tobytes() == want[k].tobytes(), (
                k, float(np.abs(got[k] - want[k]).max()))


def _catchup(backend: str, pkg: str = "geomx_tpu_torch") -> np.ndarray:
    sim = _simulation(
        pkg, 2, 1,
        sync_global_mode=False, merge_backend=backend,
        heartbeat_interval_s=0.05, heartbeat_timeout_s=0.4,
        enable_partition_mode=True, probe_timeout_s=0.4,
        partition_degrade_s=0.6)
    try:
        w0, w1 = sim.all_workers()
        dim = 4096
        for w in (w0, w1):
            w.init(0, np.zeros(dim, np.float32))
        w0.set_optimizer({"type": "sgd", "lr": 0.1})
        for p in range(2):
            sim.worker(p, 0).set_gradient_compression(CODECS["2bit"])
        rng = np.random.default_rng(9)
        grads = [rng.standard_normal(dim).astype(np.float32)
                 for _ in range(7)]
        gs = sim.global_servers[0]
        for w, g in ((w0, grads[0]), (w1, grads[1])):
            w.push(0, g)
            w.wait_all()
        assert _wait_for(lambda: gs.key_rounds == 2)
        rm = sim.recovery_monitor
        ls0 = sim.local_servers[0]
        sim.partition_party(0)
        w0.push(0, grads[2])   # in flight when the cut is seen: abandoned
        w0.wait_all()
        assert _wait_for(lambda: ls0._degraded and 0 in rm._quarantined,
                         15)
        for g in grads[3:6]:
            w0.push(0, g)
            w0.wait_all()
        assert _wait_for(lambda: ls0._catchup_rounds == 3, 10)
        w1.push(0, grads[6])
        w1.wait_all()
        assert _wait_for(lambda: gs.key_rounds == 3)
        sim.heal_party(0)
        assert _wait_for(lambda: ls0.catchup_pushes == 1, 30)
        assert _wait_for(lambda: gs.catchup_merges == 1, 30)
        assert ls0.catchup_fallbacks == 0
        if backend != "numpy":
            _on_the_backend(gs, backend)
        return np.array(gs.store[0], np.float32)
    finally:
        sim.shutdown()


def test_partition_catchup_2bit_matches_numpy():
    got, want = _catchup(BACKEND), _catchup("numpy")
    assert np.abs(want).max() > 0
    assert got.tobytes() == want.tobytes(), float(np.abs(got - want).max())
