"""The torch backend's mesh rung against the JAX backend's (CPU).

``JaxBackend`` spreads a big key's round over the 8 virtual CPU devices
(``tests/conftest.py``) and reduces across them with ``shard_map``; the
port's ``TorchBackend(devices=["cpu"] * 8)`` spreads it over 8 slots on
the CPU and reduces across them single-controller.  Both modules'
``_MESH_MIN_ELEMS`` are patched down so small keys spread, as the JAX
package's own tests do; through a ``Simulation`` the port's default
device list (``_MESH_DEVICES``) is patched the same way.

Tolerances: the exact rung sums whole-number pushes, exact in any order:
bitwise equal to JAX's and to numpy.  The int8 rung: within the JAX
test's bound ``2 k max|p| / 127`` of the exact sum, and within 1e-4 of
a block's int8 step of JAX's result (XLA's CPU code fuses a peer's
dequantize into the shard sum as a fused multiply-add, the port does
not; measured worst 2.0e-5 of a step, 1,330 of 4,096 elements apart).
The residual scenario: the recovery and drift bounds JAX's test holds,
over 40 rounds so that the residual crosses a step, and cumulative sums
within 1e-4 of a step of JAX's (measured: equal).
"""

import numpy as np
import pytest
import torch

import geomx_tpu.kvstore.jax_backend as jb
import geomx_tpu_torch.kvstore.torch_backend as tb
from geomx_tpu.core.config import Config as JConfig, Topology as JTopology
from geomx_tpu.kvstore import Simulation as JSimulation
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.parallel.quantized_allreduce import \
    quantized_psum_mean_ef

K = 8   # the virtual devices and the port's slots


@pytest.fixture
def small_keys(monkeypatch):
    monkeypatch.setattr(jb, "_MESH_MIN_ELEMS", 256)
    monkeypatch.setattr(tb, "_MESH_MIN_ELEMS", 256)


def _backends(**cfg):
    return (jb.JaxBackend(JConfig(topology=JTopology(), **cfg)),
            tb.TorchBackend(Config(topology=Topology(), **cfg), "cpu",
                            devices=["cpu"] * K))


def _round(be, pushes, key=0):
    acc = be.seed(pushes[0].copy(), donated=True, key=key)
    for p in pushes[1:]:
        acc = be.accumulate(acc, p.copy())
    return acc, be.materialize(acc)


def test_exact_rung_sums_bitwise_as_jax(small_keys):
    rng = np.random.default_rng(3)
    for pushes in ([np.full(4096, float(i + 1), np.float32)
                    for i in range(5)],
                   [rng.integers(-64, 64, 1000).astype(np.float32)
                    for _ in range(11)]):
        outs = []
        for be in _backends():
            acc = be.seed(pushes[0].copy(), donated=True, key=0)
            for p in pushes[1:]:
                acc = be.accumulate(acc, p.copy())
            assert len(acc.parts) == min(len(pushes), K)
            # a peek folds on the host and leaves the round as it was
            assert acc.tobytes() == np.sum(pushes, 0, np.float32).tobytes()
            assert len(acc.parts) == min(len(pushes), K)
            outs.append(be.materialize(acc))
        assert outs[0].tobytes() == outs[1].tobytes()
        assert outs[1].tobytes() == np.sum(pushes, 0, np.float32).tobytes()


def test_below_the_threshold_and_one_slot_stay_single(small_keys):
    be = tb.TorchBackend(None, "cpu", devices=["cpu"] * K)
    assert isinstance(be.seed(np.ones(100, np.float32), True), torch.Tensor)
    one = tb.TorchBackend(None, "cpu")
    assert isinstance(one.seed(np.ones(4096, np.float32), True),
                      torch.Tensor)
    assert one.stats()["merge_devices"] == 1


def _step_of(v):
    pad = (-v.shape[0]) % 256
    amax = np.pad(np.abs(v), (0, pad)).reshape(-1, 256).max(1)
    return np.repeat(amax / 127, 256)[:v.shape[0]]


def test_quantized_rung_matches_jax_within_the_bound(small_keys):
    rng = np.random.default_rng(11)
    pushes = [rng.standard_normal(4096).astype(np.float32)
              for _ in range(4)]
    outs = [_round(be, pushes)[1] for be in _backends(merge_quantized=True,
                                                      merge_residual=False)]
    exact = np.sum(pushes, axis=0)
    k = len(pushes)
    bound = 2.0 * k * max(np.abs(p).max() for p in pushes) / 127.0
    assert np.max(np.abs(outs[1] - exact)) <= bound
    assert (np.abs(outs[1] - outs[0]) <= 1e-4 * _step_of(outs[0])).all()
    stats = _backends(merge_quantized=True)[1].stats()
    assert stats["merge_quantized"] is True
    assert stats["merge_residual"] is True and stats["merge_devices"] == K
    plain = _backends()[1].stats()
    assert plain["merge_quantized"] is plain["merge_residual"] is False


def test_residual_recovers_subthreshold_components_as_jax(small_keys):
    """JAX's ``test_residual_recovers_subthreshold_components``: one
    block-dominating element pins the int8 scale so the block's small
    components quantize to 0 every round; the residual brings them back
    (error within two steps), without it they are lost.  40 rounds, not
    JAX's 10: a slot's residual grows by 0.1 a round against a half
    step of 1.575, so it first crosses a step in round 16; at 10 rounds
    both runs give 0 and the two-step bound (12.6 against a wanted 4.0)
    could not tell them apart.  At 40 the wanted sum is 16.0: 0 without
    the residual lies outside two steps of it, the residual's 12.6
    inside."""
    n, parties, rounds = 1024, 4, 40
    x = np.full(n, 0.1, np.float32)
    x[0] = 400.0
    want = rounds * parties * 0.1

    def cumulative(be):
        tot = np.zeros(n, np.float64)
        for _ in range(rounds):
            tot += _round(be, [x] * parties)[1]
        return tot

    cum = {}
    for residual in (True, False):
        cum[residual] = [cumulative(be) for be in _backends(
            merge_quantized=True, merge_residual=residual)]
    assert abs(cum[False][1][1] - want) >= 0.9 * want
    step = 2 * 400.0 / 127.0
    assert abs(cum[True][1][1] - want) <= 2 * step
    assert abs(cum[False][1][1] - want) > 2 * step
    assert cum[True][1][1] != cum[False][1][1]
    for residual in (True, False):
        np.testing.assert_allclose(cum[residual][1], cum[residual][0],
                                   rtol=0, atol=1e-4 * step)


def test_residual_carries_into_the_next_round_with_the_same_k(small_keys):
    """A second round of the same key over the same slots starts from
    the residual the first left: the backend's stored residual after it
    is the one quantized_psum_mean_ef gives from the first's, bitwise,
    not the one it gives from zeros."""
    be = _backends(merge_quantized=True)[1]
    x = np.full(1024, 0.1, np.float32)
    x[0] = 400.0
    _round(be, [x] * 4, key=5)
    first = be._residuals[5][1]
    assert be._residual_for(5, 4, 1024) is first
    parts = [torch.from_numpy(x)] * 4     # one push a slot
    means, carried = quantized_psum_mean_ef(parts,
                                            [r.clone() for r in first])
    _, fresh = quantized_psum_mean_ef(parts, [torch.zeros(1024)] * 4)
    _, out = _round(be, [x] * 4, key=5)
    k, stored = be._residuals[5]
    assert k == 4
    assert all(torch.equal(a, b) for a, b in zip(stored, carried))
    assert not all(torch.equal(a, b) for a, b in zip(stored, fresh))
    assert out.tobytes() == (means[0] * 4.0).numpy().tobytes()


def test_residual_resets_when_the_slot_count_changes(small_keys):
    be = _backends(merge_quantized=True)[1]
    x = np.full(1024, 0.1, np.float32)
    x[0] = 400.0
    _round(be, [x] * 4, key=5)
    k, res = be._residuals[5]
    assert k == 4 and len(res) == 4 and float(res[0].abs().sum()) > 0
    assert all(float(r.abs().sum()) == 0
               for r in be._residual_for(5, 3, 1024))
    _round(be, [x] * 3, key=5)
    assert be._residuals[5][0] == 3


def _train(sim_cls, cfg_cls, topo_cls, steps=2, **cfg_kw):
    cfg = cfg_cls(topology=topo_cls(num_parties=2, workers_per_party=2),
                  **cfg_kw)
    sim = sim_cls(cfg)
    try:
        ws = sim.all_workers()
        for w in ws:
            w.init(0, np.zeros(2048, np.float32))
        ws[0].set_optimizer({"type": "sgd", "lr": 0.25})
        for _ in range(steps):
            for i, w in enumerate(ws):
                w.push(0, np.full(2048, float(i + 1), np.float32))
            for w in ws:
                w.pull_sync(0)
                w.wait_all()
        return (np.array(ws[0].pull_sync(0)),
                [s.stats() for s in sim.local_servers])
    finally:
        sim.shutdown()


def test_simulation_on_the_rung_matches_jax_bitwise(small_keys, monkeypatch):
    """A 2 × 2 FSA round trip whose key spreads over the slots (the
    port's default device list patched to 8 CPU slots): weights bitwise
    equal to the JAX backend's on its 8 virtual devices and to numpy."""
    monkeypatch.setattr(tb, "_MESH_DEVICES", ["cpu"] * K)
    w_t, st = _train(Simulation, Config, Topology,
                     merge_backend="torch:cpu")
    w_j, _ = _train(JSimulation, JConfig, JTopology, merge_backend="jax")
    w_n, _ = _train(Simulation, Config, Topology, merge_backend="numpy")
    assert st[0]["merge_backend"] == "torch" and st[0]["merge_devices"] == K
    assert w_t.tobytes() == w_j.tobytes() == w_n.tobytes()
