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


# ---- the slow soaks that train the JAX CNN (the lane's slow mode leaves
# them out): held to the JAX tests' own assertions, on the port's CNN

def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _wait_for(pred, timeout=20.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def _delta(base, snap, key):
    return snap.get(key, 0) - base.get(key, 0)


def _train_cnn(side: _Side, workers, hist, errs, num_all=None,
               barrier_init=False, progress=None):
    """``tests/test_eviction.py`` ``_train_cnn`` on ``side``'s CNN."""
    x, y = side.data.synthetic_classification(n=512, shape=(8, 8, 1),
                                              seed=3)
    n = num_all or len(workers)

    def train(kv, widx, nsteps):
        def tick(step, _loss, _acc):
            if progress is not None:
                progress[widx] = step + 1

        try:
            it = side.data.ShardedIterator(x, y, 16, widx, n, seed=4)
            hist[widx] = side.training.run_worker(
                kv, side.params, side.grad_fn, it, nsteps,
                barrier_init=barrier_init, log_fn=tick)
        except Exception as e:  # noqa: BLE001 — asserted by callers
            errs.append((widx, repr(e)))

    ths = [threading.Thread(target=train, args=(kv, i, s))
           for i, (kv, s) in enumerate(workers)]
    for t in ths:
        t.start()
    return ths


@pytest.mark.slow
def test_crash_eviction_e2e_worker_and_local_server():
    """``tests/test_eviction.py::test_crash_eviction_e2e_worker_and_local_
    server`` on the port (``torch:cpu``): a worker and, separately, a
    local server die mid-training; the survivors finish within 0.5 of
    the unkilled control's loss, the zombie's push is fenced, the
    replacement server warm-boots and the party folds back in, and the
    counters say so."""
    from geomx_tpu_torch.utils.metrics import system_snapshot

    side = _Side(port=True)
    steps, kill_after = 24, 8
    topo = dict(num_parties=2, workers_per_party=2)
    hb = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.8,
              request_retry_s=1.0)

    sim = side.sim(topo)
    try:
        ws = sim.all_workers()
        ws[0].set_optimizer({"type": "adam", "lr": 0.01})
        hist, errs = {}, []
        for t in _train_cnn(side, [(w, steps) for w in ws], hist, errs):
            t.join(300)
        assert not errs, errs
        control_loss = float(np.mean([hist[i][-1][0] for i in hist]))
    finally:
        sim.shutdown()

    # phase A: a worker dies ungracefully mid-training
    sim = side.sim(topo, **hb)
    base = system_snapshot()
    try:
        ws = sim.all_workers()
        ws[0].set_optimizer({"type": "adam", "lr": 0.01})
        hist, errs = {}, []
        jobs = [(w, kill_after if i == 1 else steps)
                for i, w in enumerate(ws)]
        ths = _train_cnn(side, jobs, hist, errs)
        ths[1].join(300)
        assert 1 in hist, errs
        sim.kill_worker(0, 1)
        for t in ths:
            t.join(300)
        assert not errs, errs
        assert len(hist) == 4, "a survivor hung after the worker kill"
        crash_loss = float(np.mean(
            [hist[i][-1][0] for i in hist if i != 1]))
        assert np.isfinite(crash_loss)
        assert abs(crash_loss - control_loss) < 0.5, (crash_loss,
                                                      control_loss)
        assert sim.eviction_monitors[0].evictions == 1
        ws[1].po.start()
        ws[1].push(0, np.ones(4, np.float32))
        with pytest.raises(RuntimeError, match="evicted"):
            ws[1].wait_all()
        snap = system_snapshot()
        assert _delta(base, snap, "scheduler:0@p0.worker_evictions") == 1
        assert _delta(base, snap,
                      "server:0@p0.eviction_fenced_pushes") >= 1
    finally:
        sim.shutdown()

    # phase B: a local server dies mid-training, its replacement rejoins
    sim = side.sim(dict(num_parties=2, workers_per_party=1), **hb)
    base = system_snapshot()
    try:
        ws = sim.all_workers()
        ws[0].set_optimizer({"type": "adam", "lr": 0.01})
        hist, errs, progress = {}, [], {}
        ths = _train_cnn(side, [(w, steps) for w in ws], hist, errs,
                         progress=progress)
        assert _wait_for(lambda: progress.get(1, 0) >= 6, 120), progress
        sim.kill_local_server(1)
        time.sleep(2.5)
        killed_at = progress.get(1, 0)
        assert killed_at < steps, "server outlived the training run"
        sim.restart_local_server(1)
        assert _wait_for(
            lambda: sim.recovery_monitor.party_unfolds == 1, 60), \
            "party never folded back in"
        ths[0].join(300)
        assert 0 in hist, errs
        sim.local_servers[0].leave_global()
        for t in ths:
            t.join(300)
        assert not errs, errs
        assert len(hist) == 2, "a worker hung across the server crash"
        for h in hist.values():
            assert len(h) == steps
            assert np.isfinite([loss for loss, _ in h]).all()
        server_loss = float(np.mean([hist[i][-1][0] for i in hist]))
        assert abs(server_loss - control_loss) < 0.5, (server_loss,
                                                       control_loss)
        assert sim.recovery_monitor.party_folds == 1
        snap = system_snapshot()
        assert _delta(base, snap, "global_scheduler:0.party_folds") == 1
        assert _delta(base, snap,
                      "global_scheduler:0.party_unfolds") == 1
        assert _delta(base, snap, "server:0@p1.warm_boots") >= 1
        assert _delta(base, snap,
                      "worker:0@p1.server_recoveries") >= 1
        ls2 = sim.local_servers[1]
        assert ls2.store and all(
            np.isfinite(_host(v)).all() for v in ls2.store.values())
    finally:
        sim.shutdown()


@pytest.mark.slow
def test_chaos_soak_drops_joins_leaves_compression():
    """``tests/test_robustness.py::test_chaos_soak_drops_joins_leaves_
    compression`` on the port (``torch:cpu``): 2-party BSC training under
    15 % message drop with a worker leaving, one joining and one killed
    without a leave; every survivor finishes finite, the zombie's push
    is fenced and the party stores agree."""
    from geomx_tpu_torch.transport.van import FaultPolicy

    side = _Side(port=True)
    sim = Simulation(
        Config(topology=Topology(num_parties=2, workers_per_party=2),
               resend_timeout_ms=150, request_retry_s=2.0,
               heartbeat_interval_s=0.1, heartbeat_timeout_s=1.0,
               merge_backend="torch:cpu"),
        fault=FaultPolicy(drop_rate=0.15, seed=11))
    try:
        x, y = p_data.synthetic_classification(n=512, shape=(8, 8, 1),
                                               seed=3)
        ws = sim.all_workers()
        ws[0].set_optimizer({"type": "adam", "lr": 0.01})
        for p in range(2):
            sim.worker(p, 0).set_gradient_compression(
                {"type": "bsc", "ratio": 0.1})
        hist, errs = {}, []

        def train(kv, widx, nw, steps, leave_after=None):
            try:
                it = p_data.ShardedIterator(x, y, 16, widx, nw, seed=4)
                h = p_training.run_worker(kv, side.params, side.grad_fn, it,
                                          steps, barrier_init=False)
                if leave_after is not None:
                    kv.wait_all()
                    kv.leave_party()
                hist[widx] = h
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append((widx, repr(e)))

        def phase(kvs, nw, steps, **kw):
            hist.clear()
            ths = [threading.Thread(target=train, args=(w, i, nw, steps),
                                    kwargs={k: v(i) for k, v in kw.items()})
                   for i, w in enumerate(kvs)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=300)
            assert not errs, errs
            assert len(hist) == len(kvs), "a worker hung"
            for h in hist.values():
                assert np.isfinite([loss for loss, _ in h]).all()

        def stores_agree():
            s0 = sim.local_servers[0].store
            s1 = sim.local_servers[1].store
            for k in s0:
                np.testing.assert_allclose(_host(s0[k]), _host(s1[k]),
                                           rtol=1e-4, atol=1e-5)

        # phase 1: 20 steps; party 0's worker 1 leaves at the end
        phase(ws, 4, 20, leave_after=lambda i: 20 if i == 1 else None)
        # phase 2: a new worker joins party 1; the three train 20 more
        w4 = sim.add_worker(1)
        phase([ws[0]] + ws[2:] + [w4], 4, 20)
        stores_agree()
        # phase 3: worker:0@p1 dies without a leave; 12 more steps
        sim.kill_worker(1, 0)
        phase([ws[0], ws[3], w4], 3, 12)
        assert sim.local_servers[1].evicted_workers == 1
        assert sim.eviction_monitors[1].evictions == 1
        ws[2].po.start()
        ws[2].push(0, np.ones(4, np.float32))
        with pytest.raises(RuntimeError, match="evicted"):
            ws[2].wait_all()
        assert sim.local_servers[1].eviction_fenced_pushes >= 1
        stores_agree()
    finally:
        sim.shutdown()
