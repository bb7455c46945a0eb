"""The JAX package's process-level acceptance suite against the port's
launcher (``geomx_tpu_torch.acceptance``), on the host.

Each case launches every role as its own OS process over loopback TCP
with the JAX test's topology, flags, steps and environment, and holds
the JAX test's mechanism assertion besides every process's return code,
every worker's ``steps=N`` and every server's merge backend.  On the
host the roles run ``--device cpu``; the servers merge on ``numpy``, or
on ``torch:cpu`` where the case is about the torch backend's optimizer
state crossing processes (restart, replacement, failover, shards).

- tier-1: three 1 × 1 cases whose gates are counters only (HFA's K2
  gate, the MPQ size split on the CNN, DGT mode 3), the optimizer
  state's two in-process crossings on the torch backend (a checkpoint
  restore and a shard handoff), each bit for bit against the JAX
  package's numpy path on the same inputs, and the ESync workload's
  local-step cap against the step times the card showed;
- ``slow``, as the JAX package marks them: every other case, and the
  JAX launcher and the port's run with the same flags, their
  deterministic counters compared.
"""

import os
import re

import numpy as np
import pytest

from geomx_tpu_torch import acceptance as A

TIER1 = ("hfa_k2", "mpq_cnn", "dgt3")
MARKS = {"failover": [pytest.mark.failover],
         "shards": [pytest.mark.failover, pytest.mark.chaos]}


def test_version_matches_the_jax_package():
    import geomx_tpu
    import geomx_tpu_torch

    assert geomx_tpu_torch.__version__ == geomx_tpu.__version__ == "0.1.0"


def test_cases_cover_the_jax_process_tests():
    """Every case names an existing JAX test, and the table holds the
    cases of the JAX acceptance matrix, the joins, recovery, failover,
    the sharded tier and the TCP / multi-host topologies."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for case in A.CASES.values():
        path, line = case.source.rsplit(":", 1)
        lines = open(os.path.join(root, path)).read().splitlines()
        assert lines[int(line) - 1].startswith("def test_"), case
    assert len(A.CASES) == 18
    assert set(TIER1) <= set(A.CASES)


@pytest.mark.parametrize("name", TIER1)
def test_counter_case_on_the_host(name):
    rec = A.run_case(name, device="cpu")
    assert rec["seconds"] < A.CASES[name].deadline_s


@pytest.mark.slow
@pytest.mark.parametrize("name", [
    pytest.param(n, marks=MARKS.get(n, [])) for n in A.CASES
    if n not in TIER1])
def test_case_on_the_host(name):
    rec = A.run_case(name, device="cpu")
    if A.CASES[name].scenario in ("failover", "shards"):
        assert rec["promoted_state"]["on"] == "cpu"
    if name in ("restart", "replace"):
        assert rec["restored_state"]["keys"] == A.CNN_KEYS


def test_esync_cap_lets_the_fast_worker_reach_with_the_slow_one():
    """The ESync case on the card (NVIDIA H100 80GB HBM3): the fast
    worker's local step took ~4.5 ms, the worker slowed by 150 ms ~180
    ms.  Under the JAX launcher's cap of 16 local steps the planner
    could not balance them (reach ratio 2.5 > 2, the case failed); the
    port's launcher caps at the planner's own bound."""
    from geomx_tpu_torch.launch import ESYNC_MAX_LOCAL_STEPS
    from geomx_tpu_torch.sched.esync import EsyncState

    def reach_ratio(cap):
        st = EsyncState()
        for worker, step_s in (("fast", 0.0045), ("slow", 0.18)):
            st.report(worker, step_s, 0.001, max_steps=cap)
        plan = st.plan()
        fast = plan["fast"] * 0.0045 + 0.001
        slow = plan["slow"] * 0.18 + 0.001
        return max(fast, slow) / min(fast, slow)

    assert reach_ratio(16) > 2.0
    assert reach_ratio(ESYNC_MAX_LOCAL_STEPS) < 2.0
    assert ESYNC_MAX_LOCAL_STEPS == EsyncState().max_steps


# ---- the optimizer state's crossings, in process --------------------------
# The reference is the JAX package's numpy merge path on the same inputs:
# the fault the shard handoff shows (ROADMAP C2) lives in the device
# stage, which the numpy path does not run.

def _sim(pkg, backend, topology, **kw):
    import importlib

    config = importlib.import_module(f"{pkg}.core.config")
    kvstore = importlib.import_module(f"{pkg}.kvstore")
    return kvstore.Simulation(config.Config(
        topology=config.Topology(**topology), merge_backend=backend, **kw))


def _key(tid, size):
    from geomx_tpu_torch.kvstore.keys import encode_tensor

    (part,) = encode_tensor(tid, size, 2)
    return part.ps_key


def _rounds(ws, n, seed):
    rng = np.random.default_rng(seed)
    out = None
    for _ in range(n):
        for w in ws:
            for tid in (0, 1):
                w.push(tid, rng.standard_normal(8).astype(np.float32))
        out = [[np.asarray(w.pull_sync(tid)) for tid in (0, 1)]
               for w in ws]
        for w in ws:
            w.wait_all()
    return out


def _handoff(pkg, backend):
    sim = _sim(pkg, backend,
               dict(num_parties=2, workers_per_party=1,
                    num_global_servers=2, num_standby_globals=0),
               request_retry_s=0.4, heartbeat_interval_s=0.0,
               retry_backoff_cap=2)
    try:
        ws = sim.all_workers()
        for w in ws:
            for tid in (0, 1):
                w.init(tid, np.zeros(8, np.float32))
        ws[0].set_optimizer({"type": "adam", "lr": 0.1})
        _rounds(ws, 2, seed=0)
        gs0, gs1 = sim.global_servers
        assert sim.reassign_shard(1, target=gs0.po.node), "drain failed"
        assert gs1._fenced and gs0.merged_handoffs == 1
        after = _rounds(ws, 1, seed=1)
        return after, gs0
    finally:
        sim.shutdown()


def test_shard_handoff_carries_adam_state_onto_the_torch_backend():
    """A drained shard's key crosses with its Adam moments and step
    counter (``import_key``): the next round on the target equals the
    JAX package's numpy path bit for bit, and the moved key's step
    counter reads 3 after 2 rounds on its old holder and 1 on the
    new."""
    ref, _ = _handoff("geomx_tpu", "numpy")
    got, gs0 = _handoff("geomx_tpu_torch", "torch:cpu")
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    st = gs0._dev_opt._st[_key(1, 8)]
    assert st["t"] == 3
    assert st["m"].device.type == "cpu"
    assert "opt_device_keys=2 opt_state_on=cpu opt_steps=3..3" == \
        gs0._dev_opt.state_summary()


def _restore(pkg, backend, tmp_path):
    topology = dict(num_parties=1, workers_per_party=1)
    sim = _sim(pkg, backend, topology)
    ckpt_dir = tmp_path / f"{pkg}_{backend.replace(':', '_')}"
    ckpt_dir.mkdir()
    try:
        w = sim.all_workers()[0]
        w.init(0, np.zeros(16, np.float32))
        w.set_optimizer({"type": "adam", "lr": 0.1})
        _rounds_one(w, 2, seed=0)
        (path,) = w.save_server_checkpoints(str(ckpt_dir))
    finally:
        sim.shutdown()
    sim = _sim(pkg, backend, topology)
    try:
        gs = sim.global_servers[0]
        gs.load_checkpoint(path)
        w = sim.all_workers()[0]
        w.init(0, np.zeros(16, np.float32))
        return _rounds_one(w, 1, seed=1), gs
    finally:
        sim.shutdown()


def _rounds_one(w, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        w.push(0, rng.standard_normal(16).astype(np.float32))
        out = np.asarray(w.pull_sync(0))
        w.wait_all()
    return out


def test_checkpoint_restore_lands_adam_state_on_the_torch_backend(tmp_path):
    """A restarted global server's ``load_checkpoint`` puts the
    checkpointed Adam state on its device (``import_state``) and the
    next round equals the JAX package's numpy path bit for bit."""
    ref, _ = _restore("geomx_tpu", "numpy", tmp_path)
    got, gs = _restore("geomx_tpu_torch", "torch:cpu", tmp_path)
    np.testing.assert_array_equal(got, ref)
    assert gs._dev_opt.state_summary() == \
        "opt_device_keys=1 opt_state_on=cpu opt_steps=3..3"


# ---- the JAX launcher beside the port's -----------------------------------

def _jax_counters(name):
    from tests.test_acceptance_matrix import _launch_matrix

    case = A.CASES[name]
    _, outs = _launch_matrix(case.parties, case.workers, list(case.flags),
                             extra_env=dict(case.env), steps=case.steps,
                             timeout=case.deadline_s)
    return {k: (0, v) for k, v in outs.items()}


def _port_counters(name):
    from geomx_tpu_torch.launch import run_local_cluster

    case = A.CASES[name]
    outs = run_local_cluster(
        case.parties, case.workers,
        ["--device", "cpu", "--merge-backend", "numpy", "--steps",
         str(case.steps), *case.flags],
        env=dict(os.environ, **dict(case.env)), deadline_s=case.deadline_s,
        cwd=A.ROOT)
    assert all(rc == 0 for rc, _ in outs.values()), outs
    return outs


def _counters(outs):
    out = {}
    for k, (_, text) in outs.items():
        for tag in ("mpq_bsc", "mpq_fp16", "hfa_gated_key_rounds",
                    "n_params"):
            m = re.search(rf"\b{tag}=(\d+)", text)
            if m:
                out[f"{k} {tag}"] = int(m.group(1))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", ["hfa_k2", "mpq_cnn", "moe_lm"])
def test_counters_equal_the_jax_launchers(name):
    jax_c = _counters(_jax_counters(name))
    port_c = _counters(_port_counters(name))
    assert jax_c, name
    assert port_c == jax_c
