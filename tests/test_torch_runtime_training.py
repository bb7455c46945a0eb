"""Port counterparts of the backend lane's JAX-using cases.

The lane (``tests/test_torch_runtime_lane_*.py``) runs the JAX
package's in-process suites against the port without JAX, so it leaves
out the cases that build the JAX CNN (``jax.random.PRNGKey``) or hand
``training.run_worker*`` JAX arrays (``LEFT_OUT`` in
``tests/test_torch_runtime_lane_backend.py``). Each is rebuilt here on
the port: its CNN on ``device="cpu"`` in f32, its params carried over
from the JAX CNN by ``convert.flax_zoo_to_torch``, its servers on
``torch:cpu``, and the JAX test's own assertions.

Where the JAX run is deterministic the same scenario also runs on the
JAX package (numpy backend, f32 compute) and the two are compared:

- one worker, or two (a two-term sum does not depend on arrival
  order): losses within rtol 1e-5 and final weights within rtol 1e-4 /
  atol 1e-6, the tolerance of ``tests/test_torch_trainer.py`` (the
  frameworks sum convolution windows in different orders);
- the constant-gradient loop of ``test_run_worker_fills_measure``:
  bitwise.

Three or more workers sum in arrival order and ESync's local steps
follow wall-clock step times: those phases are held to the JAX test's
assertions only.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geomx_tpu.data as j_data
import geomx_tpu.training as j_training
from geomx_tpu.core.config import Config as JConfig, Topology as JTopology
from geomx_tpu.kvstore import Simulation as JSimulation
from geomx_tpu.models.cnn import create_cnn_state as j_create_cnn_state
from geomx_tpu.utils import Measure as JMeasure
from geomx_tpu_torch import data as p_data
from geomx_tpu_torch import training as p_training
from geomx_tpu_torch.convert import (FLATTEN_DENSE, flax_zoo_to_torch,
                                     torch_zoo_to_flax)
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.models.cnn import create_cnn_state
from geomx_tpu_torch.utils import Measure

SHAPE = (1, 8, 8, 1)
CHW = (64, 2, 2)   # the 8 x 8 input after two 2 x 2 pools


class _Side:
    """One package's half of a scenario: its Simulation, data, loops and
    the CNN (the port's from the JAX CNN's converted params)."""

    def __init__(self, port: bool):
        self.port = port
        jmodel, jparams, jgrad = j_create_cnn_state(
            jax.random.PRNGKey(0), input_shape=SHAPE,
            compute_dtype=jnp.float32)
        if port:
            _, _, self.grad_fn = create_cnn_state(
                seed=0, input_shape=SHAPE, compute_dtype=torch.float32,
                device="cpu")
            self.params = flax_zoo_to_torch(
                jax.tree_util.tree_map(np.asarray, jparams),
                (FLATTEN_DENSE, CHW), "cpu")
            self.data, self.training = p_data, p_training
        else:
            self.params, self.grad_fn = jparams, jgrad
            self.data, self.training = j_data, j_training

    def sim(self, topology: dict, **kw):
        if self.port:
            return Simulation(Config(topology=Topology(**topology),
                                     merge_backend="torch:cpu", **kw))
        return JSimulation(JConfig(topology=JTopology(**topology),
                                   merge_backend="numpy", **kw))


def _flat(params) -> list:
    """Either package's CNN params as the flax leaves, f32 numpy."""
    if not (isinstance(params, dict) and "params" in params):
        params = torch_zoo_to_flax(params, (FLATTEN_DENSE, CHW))
    return [np.asarray(a, np.float32)
            for a in jax.tree_util.tree_leaves(params)]


def _close(port_hist, jax_hist, port_params=None, jax_params=None):
    np.testing.assert_allclose([l for l, _ in port_hist],
                               [l for l, _ in jax_hist], rtol=1e-5)
    if port_params is not None:
        got, want = _flat(port_params), _flat(jax_params)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"leaf {i}")


# ---- test_churn.py::test_training_loops_break_at_step_boundary_on_notice

def _break_on_notice(side: _Side):
    sim = side.sim(dict(num_parties=1, workers_per_party=1),
                   heartbeat_interval_s=0.0, heartbeat_timeout_s=2.0,
                   enable_preempt=True)
    try:
        kv = sim.all_workers()[0]
        x, y = side.data.synthetic_classification(n=64, shape=(8, 8, 1),
                                                  seed=0)
        it = side.data.ShardedIterator(x, y, 8, 0, 1)

        def log(step, _l, _a):
            if step == 2:
                kv.preempt_noticed.set()

        out = {}
        hist = side.training.run_worker(kv, side.params, side.grad_fn, it,
                                        50, barrier_init=False, log_fn=log,
                                        params_out=out)
        assert len(hist) == 3, "loop did not break at the boundary"
        return hist, out["params"]
    finally:
        sim.shutdown()


def test_training_loop_breaks_at_step_boundary_on_notice():
    hist, params = _break_on_notice(_Side(port=True))
    jhist, jparams = _break_on_notice(_Side(port=False))
    _close(hist, jhist, params, jparams)


# ---- test_dynamic_join.py: joins while a CNN trains ---------------------

def _join_run(side: _Side, cfg: dict, loop: str = "plain",
              static_steps: int = 2, joined_steps: int = 2,
              it_seed=1):
    """Two static workers train, a third joins, all three train again:
    ``(static-phase histories, joined-phase histories)``."""
    sim = side.sim(dict(num_parties=1, workers_per_party=2), **cfg)
    try:
        x, y = side.data.synthetic_classification(n=256, shape=(8, 8, 1),
                                                  seed=0)
        ws = sim.all_workers()
        if loop == "plain":
            ws[0].set_optimizer({"type": "adam", "lr": 0.01})
        hist = {}

        def train(kv, widx, nw, n):
            it = (side.data.ShardedIterator(x, y, 16, widx, nw)
                  if it_seed is None else
                  side.data.ShardedIterator(x, y, 16, widx, nw,
                                            seed=it_seed))
            if loop == "esync":
                hist[widx] = side.training.run_worker_esync(
                    kv, side.params, side.grad_fn, it, n,
                    barrier_init=False, max_local_steps=4)
            else:
                hist[widx] = side.training.run_worker(
                    kv, side.params, side.grad_fn, it, n,
                    barrier_init=False)

        def phase(kvs, nw, n, timeout):
            ths = [threading.Thread(target=train, args=(w, i, nw, n))
                   for i, w in enumerate(kvs)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=timeout)

        phase(ws, 2, static_steps, 120)
        assert len(hist) == 2, "static phase hung"
        static = dict(hist)
        w3 = sim.add_worker(0)
        if cfg.get("enable_intra_ts"):
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if all(str(w3.po.node) in s.members
                       for s in sim.ts_schedulers):
                    break
                time.sleep(0.02)
            for sched in sim.ts_schedulers:
                assert str(w3.po.node) in sched.members
        hist.clear()
        phase(ws + [w3], 3, joined_steps, 150)
        assert len(hist) == 3, "post-join phase hung"
        assert len(hist[2]) == joined_steps  # the joiner trained fully
        for h in hist.values():
            assert np.isfinite([l for l, _ in h]).all()
        return static, dict(hist)
    finally:
        sim.shutdown()


def _join_against_jax(cfg, loop="plain", static_steps=2, joined_steps=2,
                      it_seed=1):
    static, _ = _join_run(_Side(port=True), cfg, loop, static_steps,
                          joined_steps, it_seed)
    if loop == "esync":
        return  # local steps follow wall-clock step times
    jstatic, _ = _join_run(_Side(port=False), cfg, loop, static_steps,
                           joined_steps, it_seed)
    for w in (0, 1):
        _close(static[w], jstatic[w])


def test_join_under_intra_ts():
    """``test_join_under_intra_ts``: the joiner enters the intra-party
    TS overlay's member sets and trains full rounds."""
    _join_against_jax(dict(enable_intra_ts=True))


def test_joined_worker_trains_a_model():
    """``test_joined_worker_trains_a_model``: training continues across a
    join, the joiner runs full rounds, losses stay finite."""
    _join_against_jax({}, static_steps=3, joined_steps=3, it_seed=None)


@pytest.mark.parametrize("mode", ["p3", "esync"])
def test_join_trains_under(mode):
    """``test_join_under_p3`` (sliced piggybacked push_pull) and
    ``test_join_under_esync`` (report-keyed plans, HFA weight mean)."""
    if mode == "p3":
        _join_against_jax(dict(enable_p3=True, p3_slice_elems=5_000))
    else:
        _join_against_jax(dict(use_hfa=True), loop="esync")


# ---- test_aux.py::test_run_worker_fills_measure --------------------------

def test_run_worker_fills_measure():
    """The worker loop brackets grad / push / pull-wait per step in a
    ``Measure``; the weights after 3 SGD steps on a constant gradient
    are the JAX loop's bit for bit."""

    def run(port: bool):
        if port:
            sim = Simulation(Config(topology=Topology(
                num_parties=1, workers_per_party=1),
                merge_backend="torch:cpu"))
            m = Measure()
            params = {"w": torch.zeros(16)}

            def grad_fn(p, x, y):
                return (torch.tensor(1.0), torch.tensor(0.0),
                        {"w": torch.ones_like(p["w"])})

            data = [(torch.zeros(1), torch.zeros(1))] * 3
            loop = p_training.run_worker
        else:
            sim = JSimulation(JConfig(topology=JTopology(
                num_parties=1, workers_per_party=1), merge_backend="numpy"))
            m = JMeasure()
            params = {"w": jnp.zeros(16)}

            def grad_fn(p, x, y):
                return (jnp.float32(1.0), jnp.float32(0.0),
                        {"w": jnp.ones_like(p["w"])})

            data = [(jnp.zeros(1), jnp.zeros(1))] * 3
            loop = j_training.run_worker
        try:
            kv = sim.all_workers()[0]
            kv.set_optimizer({"type": "sgd", "lr": 0.1})
            out = {}
            loop(kv, params, grad_fn, data, 3, barrier_init=False,
                 measure=m, params_out=out)
            rep = m.report()
            for phase in ("grad", "push", "pull_wait", "step"):
                assert rep[phase]["count"] == 3, rep
            return np.asarray(out["params"]["w"], np.float32)
        finally:
            sim.shutdown()

    got, want = run(True), run(False)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, np.full(16, -0.3, np.float32),
                               rtol=1e-6)


# ---- test_esync.py::test_esync_training_assigns_more_steps_to_fast_worker

def test_esync_training_assigns_more_steps_to_fast_worker():
    """Two workers of one party, one slowed 150 ms a step: the state
    server gives the fast one more local steps a round, both replicas
    end equal, the fast worker's loss falls.  The port's loops take
    tensors (the JAX test hands numpy arrays to JAX's loop)."""
    sim = Simulation(Config(topology=Topology(num_parties=1,
                                              workers_per_party=2),
                            use_hfa=True, hfa_k2=1,
                            merge_backend="torch:cpu"))
    try:
        target = torch.full((8,), 3.0)

        def make_grad_fn(delay_s):
            def grad_fn(params, x, y):
                time.sleep(delay_s)
                err = params["w"] - target
                return float((err ** 2).mean()), 0.0, {"w": 0.5 * err}
            return grad_fn

        def batches():
            while True:
                yield None, None

        results = {}

        def worker_main(rank, delay_s):
            kv = sim.worker(0, rank)
            out = {}
            hist = p_training.run_worker_esync(
                kv, {"w": torch.zeros(8)}, make_grad_fn(delay_s),
                batches(), 5, params_out=out, max_local_steps=8)
            results[rank] = (hist, out["params"])

        ts = [threading.Thread(target=worker_main, args=(0, 0.15)),
              threading.Thread(target=worker_main, args=(1, 0.005))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert set(results) == {0, 1}, "a worker hung"
        hist_slow, params_slow = results[0]
        hist_fast, params_fast = results[1]
        assert len(hist_fast) > len(hist_slow), (len(hist_fast),
                                                 len(hist_slow))
        np.testing.assert_allclose(params_slow["w"].numpy(),
                                   params_fast["w"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert hist_fast[-1][0] < hist_fast[0][0]
    finally:
        sim.shutdown()
