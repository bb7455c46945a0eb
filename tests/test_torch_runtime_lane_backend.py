"""The backend lane: the JAX package's in-process runtime suites run
against the port on ``TorchBackend``.

Each listed JAX test file is read as text, its ``geomx_tpu`` tokens are
rewritten to ``geomx_tpu_torch`` (as ``tests/test_torch_analysis.py``
rewrites its fixtures), and it is written into a temporary directory
beside a ``conftest.py`` made from ``tests/conftest.py`` without its
JAX lines (the thread-leak guard and the metrics reset stay) and a copy
of ``pytest.ini``. pytest then runs the directory in a subprocess with
``GEOMX_MERGE_BACKEND`` set to ``torch:cpu`` here (``torch`` on the
card, ``chip_smoke.py`` phase 11) and both device stages pinned on, as
``scripts/run_backend_smoke.sh`` pins them for the JAX lane. The
written conftest refuses any import of ``jax``: nothing the lane runs
may need it, since the card's machine runs it without JAX.

This file holds the runner and the lane's first group (the backend
lane proper: kvstore, failover, eviction, sharded merge, recovery, the
sharded global tier, the codecs and the adaptive WAN). The other groups
are ``test_torch_runtime_lane_serve.py`` and
``test_torch_runtime_lane_churn.py``; they import the runner from here.

Cases the lane leaves out are named in ``LEFT_OUT`` with the reason
and the port test that stands in for each. JAX-side timing tests that
fail under load (ROADMAP C), and the one case too heavy for a tier-1
worker, run only in ``test_lane_slow_cases``, which is ``slow``.

The slow mode (``run_slow_cases``, ``SLOW_CASES``) runs the JAX
suites' ``slow`` soak and kill cases of these files and of
``test_reactor.py``, each in a pytest subprocess of its own (``slow``
tests here; on the card ``chip_smoke.py --slow-lane``); the lists beside
it name what stands in for the others.  A JAX test file that another
imports a helper from (``tests.test_tcp``) is written into the lane
beside the files and imported from there.

One file by hand::

    python -m tests.test_torch_runtime_lane_backend kvstore [--backend torch:cpu]
    python -m tests.test_torch_runtime_lane_backend --slow
"""

import argparse
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# The lane's files, in the order it runs them (group 1, 2, 3).
GROUPS = {
    "backend": ("kvstore", "failover", "eviction", "sharded_merge",
                "recovery", "sharded_global", "compression",
                "adaptive_wan"),
    "serve": ("partition", "serve", "serve_plane", "obs", "flight",
              "integrity", "zero_copy", "trace", "stress"),
    "churn": ("churn", "dynamic_join", "robustness", "aux", "esync"),
}
FILES = tuple(f for g in GROUPS.values() for f in g)
# Files whose every case the JAX package marks ``slow``: the lane runs
# them all the same (the written conftest marks their cases
# ``lane_runs_slow``, which ``MARKER`` selects).
ALL_SLOW = ("stress",)
MARKER = "not slow or lane_runs_slow"

# Node-id prefixes (in the rewritten tree) the lane deselects, each
# with the reason and the port test that stands in for it.
_CNN = ("builds the JAX CNN (jax.random.PRNGKey) and trains it through "
        "training.run_worker*: the card's machine has no JAX")
LEFT_OUT = {
    "test_churn.py::test_training_loops_break_at_step_boundary_on_notice":
        (_CNN, "tests/test_torch_runtime_training.py::"
               "test_training_loop_breaks_at_step_boundary_on_notice"),
    "test_dynamic_join.py::test_join_under_intra_ts":
        (_CNN, "tests/test_torch_runtime_training.py::"
               "test_join_under_intra_ts"),
    "test_dynamic_join.py::test_joined_worker_trains_a_model":
        (_CNN, "tests/test_torch_runtime_training.py::"
               "test_joined_worker_trains_a_model"),
    "test_dynamic_join.py::test_join_under_p3":
        (_CNN, "tests/test_torch_runtime_training.py::"
               "test_join_trains_under[p3]"),
    "test_dynamic_join.py::test_join_under_esync":
        (_CNN, "tests/test_torch_runtime_training.py::"
               "test_join_trains_under[esync]"),
    "test_aux.py::test_run_worker_fills_measure":
        ("its grad_fn returns jax.numpy arrays",
         "tests/test_torch_runtime_training.py::"
         "test_run_worker_fills_measure"),
    "test_esync.py::test_esync_training_assigns_more_steps_to_fast_worker":
        (_CNN, "tests/test_torch_runtime_training.py::"
               "test_esync_training_assigns_more_steps_to_fast_worker"),
    "test_eviction.py::test_crash_eviction_e2e_worker_and_local_server":
        (_CNN + " (slow)", "tests/test_torch_runtime_training.py::"
                           "test_crash_eviction_e2e_worker_and_local_server"),
    "test_robustness.py::test_chaos_soak_drops_joins_leaves_compression":
        (_CNN + " (slow)", "tests/test_torch_runtime_training.py::"
                           "test_chaos_soak_drops_joins_leaves_compression"),
    "test_sharded_merge.py::test_sharded_merge_bit_identical_to_single_lock":
        ("reads the server's accumulator with ndarray.tobytes(); on the "
         "torch backend it is a tensor",
         "tests/test_torch_runtime_lane_backend.py::"
         "test_sharded_merge_bit_identical_to_single_lock"),
}

# Cases too heavy for a tier-1 worker beside five others: the 50M-element
# scale run peaks at 9.3 GB of host memory on ``torch:cpu``. They run in
# ``test_lane_heavy_cases`` (``slow``) and on the card (phase 11).
HEAVY = (
    "test_stress.py::test_scale_4x4_multigps_bsc_with_midrun_recovery",
)

# JAX-side timing tests that fail under load (ROADMAP C, reference
# side): out of the tier-1 lane cases, run in ``test_lane_slow_cases``.
TIMING = (
    "test_churn.py::test_two_parties_fold_in_same_global_round",
    "test_sharded_merge.py::test_pull_not_blocked_behind_other_keys_merge",
    "test_sharded_global.py::test_shard_kill_promotes_only_that_shard",
    "test_failover.py::test_standby_replication_carries_dedup_window",
    "test_obs.py::test_failover_visible_in_cluster_state_and_round_stall_alert",
)


# The slow mode (``run_slow_cases``): the ``slow`` cases of the lane's
# files and of ``test_reactor.py``, each in a pytest subprocess of its
# own (a soak's leftover load must not time the next one), but the soaks
# the lane runs already (``ALL_SLOW``), those that train the JAX CNN
# (``LEFT_OUT``), those whose scenarios ``geomx_tpu_torch/acceptance.py``
# runs as real processes (``SLOW_COVERED``: its cases ``failover``,
# ``replace``, ``restart``, ``shards`` and ``join_*``) and the JAX-side
# timing case of ``SLOW_TIMING``.
SLOW_FILES = FILES + ("reactor",)
SLOW_MARKER = "slow and not lane_runs_slow"
SLOW_CASES = (
    "test_adaptive_wan.py::"
    "test_throttled_wan_downshift_recovers_wall_time_with_loss_parity",
    "test_partition.py::test_region_outage_soak_quarantine_catchup_loss_parity",
    "test_serve.py::test_e2e_reads_survive_shard_sigkill_under_training",
    "test_flight.py::test_postmortem_of_killed_shard_primary_e2e",
    "test_robustness.py::test_tcp_peer_restart_recovery_via_resend",
    "test_reactor.py::test_128_party_512_worker_soak",
)
# Fails on the JAX package too, alone, on an 8-core host (ROADMAP C,
# reference side): its graceful drains must each take under a quarter
# of the 0.6 s heartbeat timeout with 48 workers' threads on the cores.
SLOW_TIMING = (
    "test_churn.py::test_spot_churn_soak_24_parties_loss_parity",
)
SLOW_COVERED = {
    "test_failover.py::test_failover_e2e_processes": "failover",
    "test_recovery.py::test_global_server_replacement_at_new_address":
        "replace",
    "test_recovery.py::"
    "test_global_server_crash_restart_midtraining_resumes_checkpoint":
        "restart",
    "test_sharded_global.py::test_shard_chaos_e2e_processes": "shards",
    "test_dynamic_join.py::test_worker_joins_over_real_tcp":
        "join_plain, join_tsengine, join_hfa",
}


# JAX test files some lane files import a helper from (``from
# tests.test_tcp import free_base_port``): written into the lane,
# rewritten, beside its files (not run), and imported from there (a
# ``tests`` package installed on the card's machine shadows the
# repository's)
HELPERS = ("tcp",)


def _rewrite(text: str) -> str:
    text = re.sub(r"\btests\.test_(\w+)\b", r"test_\1", text)
    return re.sub(r"geomx_tpu\b", "geomx_tpu_torch", text)


_JAX_BLOCK = re.compile(
    r'^flags = os\.environ\.get\("XLA_FLAGS".*?'
    r'^jax\.config\.update\("jax_platforms", "cpu"\)\n', re.M | re.S)

_NO_JAX = '''

class _NoJax:
    """The lane runs where JAX is absent: importing it is an error."""

    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError(f"the backend lane does not import {name}")
        return None


sys.meta_path.insert(0, _NoJax())

_RUNS_SLOW = {RUNS_SLOW!r}


def pytest_itemcollected(item):
    # every case of these files is slow in the JAX package: the lane
    # runs them all the same
    if item.path.name in _RUNS_SLOW:
        item.add_marker("lane_runs_slow")


def pytest_deselected(items):
    # the runner counts what it left out from this list
    path = os.environ.get("GEOMX_LANE_DESELECTED")
    if path:
        with open(path, "a") as f:
            f.writelines(it.nodeid + "\\n" for it in items)


def _implicit_numpy(self, *args, **kwargs):
    raise TypeError("implicit numpy conversion of a torch tensor "
                    "(a CUDA tensor refuses it): use .cpu().numpy()")


if os.environ.get("GEOMX_MERGE_BACKEND") == "torch:cpu":
    # hold the host run to the card's rule: numpy may not read a
    # tensor implicitly
    import torch

    torch.Tensor.__array__ = _implicit_numpy
'''


def lane_conftest() -> str:
    """``tests/conftest.py`` without its JAX lines, prefix rewritten,
    with an import guard that refuses ``jax``."""
    text = (ROOT / "tests" / "conftest.py").read_text()
    text, n = _JAX_BLOCK.subn("", text)
    assert n == 1, "tests/conftest.py's JAX block moved"
    anchor = "\nimport pytest  # noqa: E402\n"
    assert anchor in text
    guard = _NO_JAX.replace(
        "{RUNS_SLOW!r}", repr({f"test_{f}.py" for f in ALL_SLOW}))
    return _rewrite(text).replace(anchor, guard + anchor, 1)


def write_lane(dest: pathlib.Path, files=FILES, extra=()) -> pathlib.Path:
    """Write the rewritten test files, the port's ``extra`` test files
    (repository paths, copied as they are), the conftest and
    ``pytest.ini`` into ``dest``."""
    dest.mkdir(parents=True, exist_ok=True)
    for name in tuple(files) + tuple(h for h in HELPERS if h not in files):
        src = (ROOT / "tests" / f"test_{name}.py").read_text()
        (dest / f"test_{name}.py").write_text(_rewrite(src))
    for rel in extra:
        (dest / pathlib.Path(rel).name).write_text((ROOT / rel).read_text())
    (dest / "conftest.py").write_text(lane_conftest())
    ini = (ROOT / "pytest.ini").read_text().rstrip("\n")
    (dest / "pytest.ini").write_text(
        ini + "\n    lane_runs_slow: a case the backend lane runs although "
        "the JAX package marks it slow\n")
    return dest


@dataclass
class LaneResult:
    rc: int
    wall_s: float
    output: str
    cases: dict = field(default_factory=dict)   # node id -> outcome
    walls: dict = field(default_factory=dict)   # node id -> s (slow mode)

    def per_file(self):
        """{file: {"passed": n, "failed": n, "skipped": n, "left_out": n}}"""
        out = {}
        for nid, outcome in self.cases.items():
            f = nid.split("::")[0][len("test_"):-len(".py")]
            row = out.setdefault(f, {"passed": 0, "failed": 0,
                                     "skipped": 0, "left_out": 0})
            row[outcome] += 1
        return out

    def failed(self):
        return sorted(n for n, o in self.cases.items() if o == "failed")


def _junit_cases(path: pathlib.Path) -> dict:
    cases = {}
    for tc in ET.parse(path).getroot().iter("testcase"):
        # classname is the module's dotted path inside the lane dir
        mod = tc.get("classname", "").split(".")
        nid = f"{mod[0]}.py::" + "::".join(mod[1:] + [tc.get("name")])
        kids = {c.tag for c in tc}
        if kids & {"failure", "error"}:
            cases[nid] = "failed"
        elif "skipped" in kids:
            cases[nid] = "skipped"
        else:
            cases[nid] = "passed"
    return cases


def _env(backend: str, extra_env=None) -> dict:
    env = dict(os.environ, **(extra_env or {}))
    env.update(GEOMX_MERGE_BACKEND=backend, GEOMX_MERGE_OPT_DEVICE="1",
               GEOMX_CODEC_DEVICE="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + ([env["PYTHONPATH"]]
                                  if env.get("PYTHONPATH") else [])))
    env.pop("PYTEST_ADDOPTS", None)
    env.pop("PYTEST_XDIST_WORKER", None)
    return env


def run_lane(files=FILES, backend: str = "torch:cpu", *,
             workdir=None, only=None, heavy: bool = False,
             timeout: float = 900, extra=(), extra_env=None,
             marker=None, slow: bool = False, leave_out=()) -> LaneResult:
    """Run the lane's ``files`` under ``backend`` in one pytest
    subprocess, the cases ``marker`` (default ``MARKER``) selects, with
    the port's ``extra`` test files beside them (``extra_env`` added to
    the environment).  ``only``: run just these node ids (the timing or
    heavy cases); otherwise ``LEFT_OUT``, ``TIMING`` and, unless
    ``heavy``, ``HEAVY`` are left out and counted as such.  ``slow``:
    the slow mode (``SLOW_MARKER``, ``SLOW_COVERED`` left out too)."""
    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="lane-")
        workdir = tmp.name
    workdir = pathlib.Path(workdir).resolve()   # pytest runs in the lane
    lane = write_lane(workdir / "lane", files, extra)
    junit = workdir / "lane.xml"
    deselect = () if only is not None else \
        tuple(LEFT_OUT) + TIMING + (() if heavy else HEAVY) + tuple(leave_out)
    marker = SLOW_MARKER if slow else (marker or MARKER)
    targets = list(only) if only is not None else \
        [f"test_{f}.py" for f in files] + [pathlib.Path(r).name
                                           for r in extra]
    args = [sys.executable, "-m", "pytest", "-q", "-m", marker,
            "-p", "no:cacheprovider", "-p", "no:randomly",
            "-p", "no:xdist", "-o", "junit_family=xunit1",
            f"--junitxml={junit}", *targets]
    args += [f"--deselect={d}" for d in deselect]
    desel = workdir / "lane.deselected"
    desel.unlink(missing_ok=True)
    env = _env(backend, dict(extra_env or {},
                             GEOMX_LANE_DESELECTED=str(desel)))
    t0 = time.monotonic()
    try:
        out = subprocess.run(args, cwd=str(lane), capture_output=True,
                             text=True, env=env, timeout=timeout)
        rc, text = out.returncode, out.stdout + out.stderr
    except subprocess.TimeoutExpired as e:
        rc = 124
        text = ((e.stdout or b"").decode(errors="replace")
                if isinstance(e.stdout, bytes) else (e.stdout or ""))
    wall = time.monotonic() - t0
    cases = _junit_cases(junit) if junit.exists() else {}
    if deselect and desel.exists():
        for nid in desel.read_text().split():
            if nid.startswith(tuple(deselect)):
                cases[nid] = "left_out"
    if tmp is not None:
        tmp.cleanup()
    return LaneResult(rc, wall, text, cases)


def run_slow_cases(backend: str = "torch:cpu", *, workdir=None,
                   cases=SLOW_CASES, timeout: float = 600) -> LaneResult:
    """The slow mode: each of ``cases`` alone in its own pytest
    subprocess; one result over them all (the walls summed)."""
    out = LaneResult(0, 0.0, "")
    for i, nid in enumerate(cases):
        f = nid.split("::")[0][len("test_"):-len(".py")]
        wd = None if workdir is None else pathlib.Path(workdir) / f"c{i}"
        res = run_lane((f,), backend, workdir=wd, only=(nid,), slow=True,
                       timeout=timeout)
        out.rc = out.rc or res.rc
        out.wall_s += res.wall_s
        out.output += f"===== {nid}: rc {res.rc} {res.wall_s:.1f} s\n" \
            + res.output[-6000:] + "\n"
        out.cases.update(res.cases)
        out.cases.setdefault(nid, "failed")   # no JUnit entry: it never ran
        out.walls[nid] = res.wall_s
    return out


def check_file(name: str, tmp_path) -> None:
    """One lane case: ``name``'s collected cases all pass on
    ``torch:cpu`` but those left out."""
    res = run_lane((name,), "torch:cpu", workdir=tmp_path, timeout=900)
    row = res.per_file().get(name, {})
    assert res.rc == 0 and not res.failed() and row.get("passed"), (
        f"rc {res.rc}, failed {res.failed()}, counts {row}\n"
        + res.output[-6000:])
    assert row.get("skipped", 0) == 0, res.output[-3000:]


@pytest.mark.parametrize("name", GROUPS["backend"])
def test_lane_file_passes_on_the_torch_backend(name, tmp_path):
    check_file(name, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("which", ["timing", "heavy"])
def test_lane_slow_cases(which, tmp_path):
    """The JAX-side timing tests that fail under load, and the cases too
    heavy for tier-1, on the port."""
    ids = TIMING if which == "timing" else HEAVY
    files = sorted({t.split("::")[0][len("test_"):-len(".py")]
                    for t in ids})
    res = run_lane(files, "torch:cpu", workdir=tmp_path, only=ids)
    assert res.rc == 0 and not res.failed(), res.output[-6000:]


@pytest.mark.slow
@pytest.mark.parametrize("nid", SLOW_CASES + SLOW_TIMING)
def test_lane_slow_case(nid, tmp_path):
    """The slow mode: one of the JAX suites' soak and kill cases on the
    port (``SLOW_TIMING``'s fails on the JAX package too, ROADMAP C)."""
    res = run_slow_cases("torch:cpu", workdir=tmp_path, cases=(nid,))
    assert res.rc == 0 and res.cases == {nid: "passed"}, \
        res.output[-6000:]


def test_slow_lists_cover_every_slow_case():
    """Every ``slow`` case of the slow mode's files is in exactly one of
    its lists: run (``SLOW_CASES``), JAX-side timing (``SLOW_TIMING``),
    covered by an acceptance case (``SLOW_COVERED``), trained on the JAX
    CNN (``LEFT_OUT``), or of a file the lane runs whole
    (``ALL_SLOW``)."""
    found = set()
    for f in SLOW_FILES:
        if f in ALL_SLOW:
            continue
        src = (ROOT / "tests" / f"test_{f}.py").read_text()
        for m in re.finditer(r"@pytest\.mark\.slow\n(?:@.*\n)*def (\w+)\(",
                             src):
            found.add(f"test_{f}.py::{m.group(1)}")
    lists = [set(SLOW_CASES), set(SLOW_TIMING), set(SLOW_COVERED),
             set(LEFT_OUT) & found]
    assert sum(len(x) for x in lists) == len(set().union(*lists))
    assert set().union(*lists) == found, found ^ set().union(*lists)


def test_lane_lists_are_whole():
    """Every left-out and timing entry names a real test of a lane
    file, and every left-out case names its stand-in."""
    from geomx_tpu_torch import acceptance

    for nid in tuple(LEFT_OUT) + TIMING + HEAVY + tuple(SLOW_COVERED) + \
            SLOW_CASES + SLOW_TIMING:
        fname, test = nid.split("::")
        assert fname[len("test_"):-len(".py")] in SLOW_FILES, nid
        text = (ROOT / "tests" / fname).read_text()
        assert re.search(rf"^def {re.escape(test)}\(", text, re.M), nid
    for nid, cases in SLOW_COVERED.items():
        src = (ROOT / "tests" / nid.split("::")[0]).read_text()
        assert re.search(rf"@pytest\.mark\.slow\n(@.*\n)*def "
                         rf"{nid.split('::')[1]}\(", src), nid
        for case in cases.split(", "):
            assert case in acceptance.CASES, (nid, case)
            line = int(acceptance.CASES[case].source.split(":")[1])
            assert src.splitlines()[line - 1].startswith(
                f"def {nid.split('::')[1]}("), (nid, case)
    for nid, (reason, counterpart) in LEFT_OUT.items():
        path, test = counterpart.split("::")
        text = (ROOT / path).read_text()
        assert re.search(rf"^def {re.escape(test.split('[')[0])}\(",
                         text, re.M), counterpart


def test_lane_conftest_imports_no_jax(tmp_path):
    text = lane_conftest()
    assert "import jax" not in text and "from jax" not in text
    assert "geomx_tpu_torch.utils.metrics" in text
    assert "def thread_leak_guard" in text


# The port's counterpart of the white-box case the lane leaves out.

def _push_stress(shards: int, pushers: int = 8, pushes: int = 12,
                 elems: int = 2048):
    """``tests/test_sharded_merge.py`` ``_push_stress`` on ``torch:cpu``:
    {key: accumulator bytes} after ``pushers`` threads push their own
    key and a shared one through the LocalServer's push handler, the
    accumulator read with ``.cpu().numpy()``."""
    import threading

    import numpy as np
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.kvstore.common import Cmd
    from geomx_tpu_torch.ps.kv_app import KVPairs
    from geomx_tpu_torch.transport.message import Message

    cfg = Config(topology=Topology(num_parties=1,
                                   workers_per_party=pushers),
                 server_shards=shards, merge_backend="torch:cpu")
    sim = Simulation(cfg)
    try:
        ls = sim.local_servers[0]
        ls._workers_target = 1 << 30   # rounds must never complete here
        ls.server.response = lambda *a, **k: None  # merge only, no wire
        workers = sim.topology.workers(0)
        shared_key = 1000

        def pusher(i):
            for t in range(pushes):
                for k in (i, shared_key):
                    m = Message(sender=workers[i], recipient=ls.po.node,
                                push=True, request=True,
                                timestamp=t * 2 + (k == shared_key),
                                cmd=Cmd.DEFAULT,
                                keys=np.array([k], np.int64),
                                vals=np.full(elems, float(i + 1),
                                             np.float32),
                                lens=np.array([elems], np.int64))
                    ls._handle_push(m, KVPairs(m.keys, m.vals, m.lens))

        threads = [threading.Thread(target=pusher, args=(i,))
                   for i in range(pushers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert ls._shards.drain(20)
        out = {}
        with ls._mu:
            for k, st in ls._keys.items():
                assert isinstance(st.accum, torch.Tensor), type(st.accum)
                out[int(k)] = st.accum.cpu().numpy().tobytes()
                expect = pushes * (pushers if k == 1000 else 1)
                assert st.count == expect, (k, st.count, expect)
        return out
    finally:
        sim.shutdown()


def test_sharded_merge_bit_identical_to_single_lock():
    """The lane's white-box case on the torch backend: striped and
    single-lock accumulators bitwise equal, every push counted."""
    single = _push_stress(shards=1)
    sharded = _push_stress(shards=8)
    assert single.keys() == sharded.keys()
    for k in single:
        assert single[k] == sharded[k], f"key {k} sum diverged"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run JAX test files of the backend lane against "
                    "the port.")
    ap.add_argument("files", nargs="*", default=[],
                    help=f"lane files (default all): {', '.join(FILES)}")
    ap.add_argument("--backend", default="torch:cpu",
                    help="GEOMX_MERGE_BACKEND (torch:cpu or torch)")
    ap.add_argument("--slow", action="store_true",
                    help="the slow mode: SLOW_CASES, each alone")
    args = ap.parse_args(argv)
    if args.slow:
        res = run_slow_cases(args.backend)
    else:
        res = run_lane(tuple(args.files) or FILES, args.backend,
                       timeout=3000)
    print(res.output[-4000:])
    for f, row in sorted(res.per_file().items()):
        print(f, row)
    print(f"rc {res.rc} wall {res.wall_s:.1f} s failed {res.failed()}")
    return 0 if res.rc == 0 and not res.failed() else 1


if __name__ == "__main__":
    sys.exit(main())
