"""The JAX package's process-level acceptance suite, held against the
port's launcher.

Each case is one of the JAX package's ``slow`` tests that launch every
role as its own OS process over loopback TCP (``tests/test_acceptance_
matrix.py``, ``test_dynamic_join.py``, ``test_recovery.py``,
``test_failover.py``, ``test_sharded_global.py``, ``test_tcp.py``,
``test_multihost.py``), with that test's topology, flags, steps and
environment, run through :func:`geomx_tpu_torch.launch.run_local_cluster`
and held to that test's mechanism assertion.  On top of it every case
holds:

- every process to return code 0 (a process killed by the scenario, or
  a zombie it starts, excepted), and a process still running at the
  deadline fails the case;
- ``steps=N`` from every worker (the joiner its own N);
- ``merge_backend=<backend>`` from every server;
- on the card, DGC update launches above 0 in every local server of a
  case that runs MPQ, one for each key its selector sent down BSC.

``run_case(name, device=...)`` runs one case (``device="cpu"`` on a host
without a card: the servers merge on ``numpy``, or on ``torch:cpu``
where the case is about the backend's optimizer state crossing
processes) and returns its record; a failed gate raises
``AssertionError``.  ``python -m geomx_tpu_torch.acceptance --device cpu
[--case NAME ...]`` runs cases from the command line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

from geomx_tpu_torch.core.config import Topology
from geomx_tpu_torch.launch import (LocalCluster, free_base_port,
                                    run_local_cluster)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER_PREFIXES = ("server:", "global_server:", "standby_global:")
JOINER = "worker:2@p0"
# the launcher's demo CNN (create_cnn_state at 12 x 12 x 1): 2 conv and
# 3 dense layers, a weight and a bias each
CNN_KEYS = 10
# tests/test_failover.py's and tests/test_sharded_global.py's loss gates
# against the unkilled control run
FAILOVER_LOSS_TOL = 0.5
SHARDS_LOSS_TOL = 0.35


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    source: str                 # the JAX test, file:line
    parties: int
    workers: int
    flags: Tuple[str, ...]
    steps: int
    env: Tuple[Tuple[str, str], ...] = ()
    deadline_s: float = 180.0
    scenario: str = "plain"     # plain|join|restart|replace|failover|shards
    global_servers: int = 1
    standby_globals: int = 0
    # the servers' optimizer state crosses processes (restore, standby):
    # on the host the case runs the torch backend (torch:cpu)
    state: bool = False
    # a gate reads wall time, or a process must come up within the
    # cluster's remaining rounds (a joiner, a zombie): run it with no
    # other cluster on the machine (the kills of restart, replace and
    # shards wait for a checkpoint or a round, not for a time)
    timing: bool = False
    # the servers run a WAN codec whose kernel is the DGC update
    dgc: bool = False


_FAILOVER_ENV = (("GEOMX_NUM_STANDBY_GLOBALS", "1"),
                 ("GEOMX_HEARTBEAT_INTERVAL", "0.2"),
                 ("GEOMX_HEARTBEAT_TIMEOUT", "1.5"),
                 ("GEOMX_REQUEST_RETRY_S", "1.0"))
_SHARDS_ENV = (("GEOMX_GLOBAL_SHARDS", "2"),
               ("GEOMX_NUM_STANDBY_GLOBALS", "2"),
               ("GEOMX_HEARTBEAT_INTERVAL", "0.2"),
               ("GEOMX_HEARTBEAT_TIMEOUT", "1.5"),
               ("GEOMX_REQUEST_RETRY_S", "1.0"),
               ("GEOMX_RETRY_BACKOFF_CAP", "2"),
               ("GEOMX_BIGARRAY_BOUND", "2000"))
_RECOVERY_ENV = (("GEOMX_AUTO_CKPT_UPDATES", "1"),
                 ("GEOMX_REQUEST_RETRY_S", "1.0"))

CASES: Dict[str, Case] = {c.name: c for c in (
    Case("tsengine", "tests/test_acceptance_matrix.py:96", 1, 2,
         ("--tsengine",), 3),
    Case("p3", "tests/test_acceptance_matrix.py:105", 1, 1, ("--p3",), 3),
    Case("hfa_k2", "tests/test_acceptance_matrix.py:115", 1, 1,
         ("--hfa",), 4, (("GEOMX_HFA_K2", "2"),)),
    Case("esync", "tests/test_acceptance_matrix.py:125", 1, 2,
         ("--esync",), 6,
         (("GEOMX_TEST_STEP_SLEEP_MS", '{"worker:1@p0": 150}'),),
         timing=True),
    Case("dgt3", "tests/test_acceptance_matrix.py:166", 1, 1,
         ("--dgt", "3"), 3),
    Case("lm_mpq", "tests/test_acceptance_matrix.py:178", 1, 1,
         ("--workload", "lm", "--compression", "mpq", "--batch", "4"), 3,
         (("GEOMX_MPQ_SIZE_BOUND", "100000"),), deadline_s=420, dgc=True),
    Case("moe_lm", "tests/test_acceptance_matrix.py:201", 1, 1,
         ("--workload", "lm", "--compression", "mpq", "--batch", "4"), 3,
         (("GEOMX_LM_MOE_EXPERTS", "4"), ("GEOMX_LM_DMODEL", "128"),
          ("GEOMX_LM_HEADS", "4"), ("GEOMX_LM_DFF", "512"),
          ("GEOMX_LM_VOCAB", "1024"), ("GEOMX_MPQ_SIZE_BOUND", "100000")),
         deadline_s=420, dgc=True),
    Case("mpq_cnn", "tests/test_acceptance_matrix.py:225", 1, 1,
         ("--compression", "mpq"), 3, (("GEOMX_MPQ_SIZE_BOUND", "2000"),),
         dgc=True),
    Case("join_plain", "tests/test_dynamic_join.py:484", 1, 2, (), 8,
         deadline_s=300, scenario="join", timing=True),
    Case("join_tsengine", "tests/test_dynamic_join.py:484", 1, 2,
         ("--tsengine",), 8, deadline_s=300, scenario="join", timing=True),
    Case("join_hfa", "tests/test_dynamic_join.py:484", 1, 2, ("--hfa",), 8,
         deadline_s=300, scenario="join", timing=True),
    Case("restart", "tests/test_recovery.py:265", 1, 1, (), 25,
         _RECOVERY_ENV, deadline_s=300, scenario="restart", state=True),
    Case("replace", "tests/test_recovery.py:201", 1, 1, (), 25,
         _RECOVERY_ENV, deadline_s=300, scenario="replace", state=True),
    Case("failover", "tests/test_failover.py:290", 1, 1, (), 120,
         _FAILOVER_ENV, deadline_s=240, scenario="failover",
         standby_globals=1, state=True, timing=True),
    Case("shards", "tests/test_sharded_global.py:448", 1, 1, (), 120,
         _SHARDS_ENV, deadline_s=240, scenario="shards", global_servers=2,
         standby_globals=2, state=True),
    Case("full", "tests/test_tcp.py:72", 1, 1, (), 3),
    Case("dgt1_lossy", "tests/test_tcp.py:168", 1, 1, ("--dgt", "1"), 3,
         (("GEOMX_CHANNEL_DROP_MSG", "30"),)),
    Case("multihost", "tests/test_multihost.py:75", 2, 1, (), 3,
         deadline_s=240),
)}
# the cases phase 7b of chip_smoke.py already runs on the card
IN_PHASE_7B = ("p3", "lm_mpq")


def host_map(topo: Topology) -> dict:
    """``tests/test_multihost.py``'s plan: party 0 on 127.0.0.2, party 1
    on 127.0.0.3, the global tier on 127.0.0.1."""
    hosts = {}
    for n in topo.all_nodes():
        s = str(n)
        hosts[s] = ("127.0.0.2" if "@p0" in s else
                    "127.0.0.3" if "@p1" in s else "127.0.0.1")
    return hosts


def stat(outs: dict, pattern: str, keys=None) -> int:
    """The sum of an integer exit observable over the processes'
    outputs (``keys``: only those)."""
    return sum(int(m.group(1)) for k, (_, out) in outs.items()
               if keys is None or k in keys
               for m in re.finditer(pattern, out))


def _last_loss(out: str) -> float:
    m = re.search(r"last_loss=([0-9.]+)", out)
    assert m, out[-2000:]
    return float(m.group(1))


def _restored_state(text: str, what: str) -> dict:
    """The ``<what> optimizer state:`` line a launched server printed."""
    m = re.search(rf"{what} optimizer state: opt_device_keys=(\d+)"
                  r"(?: opt_state_on=(\S+))?(?: opt_steps=(\d+)\.\.(\d+))?",
                  text)
    assert m, f"no {what} optimizer state line: {text[-1500:]}"
    keys, on, lo, hi = m.groups()
    return {"keys": int(keys), "on": on,
            "steps": None if lo is None else (int(lo), int(hi))}


class _Run:
    """One case's run: its arguments, environment and scratch."""

    def __init__(self, case: Case, device: str, backend: str,
                 work: str):
        self.case, self.work = case, work
        self.control = None     # the unkilled control run's outputs
        # what the servers print as merge_backend=, and where the torch
        # backend's optimizer state lives
        self.backend_name = "numpy" if backend == "numpy" else "torch"
        self.state_device = "cuda:0" if device == "cuda" else "cpu"
        env = dict(os.environ, **dict(case.env))
        if case.scenario in ("restart", "replace"):
            env["GEOMX_CHECKPOINT_DIR"] = work
        if case.name == "multihost":
            env["GEOMX_NODE_HOSTS"] = json.dumps(host_map(self.topo()))
        self.env = env
        self.args = ["--device", device, "--steps", str(case.steps),
                     *case.flags]
        if case.scenario in ("failover", "shards"):
            # the worker's progress lines time the kill (a logging flag:
            # the training is the JAX test's)
            self.args += ["--log-every", "1"]
        if backend != "auto":
            self.args += ["--merge-backend", backend]

    def topo(self) -> Topology:
        c = self.case
        return Topology(num_parties=c.parties, workers_per_party=c.workers,
                        num_global_servers=c.global_servers,
                        num_standby_globals=c.standby_globals)

    def cluster(self, during=None) -> dict:
        c = self.case
        return run_local_cluster(
            c.parties, c.workers, self.args, env=self.env,
            deadline_s=c.deadline_s, global_servers=c.global_servers,
            cwd=ROOT, standby_globals=c.standby_globals, during=during)


# ---- scenarios: what runs while the cluster trains ------------------------

def _join(run: _Run, rec: dict):
    def during(cl: LocalCluster):
        # tests/test_dynamic_join.py: the joiner is launched with the
        # cluster and runs fewer steps, so its rounds are a prefix of
        # the static workers' (its leave covers the rest); its --steps
        # comes after the cluster's and wins
        cl.spawn(JOINER, extra=["--steps", "2", "--join", "--advertise",
                                f"127.0.0.1:{free_base_port(1)}"])
    return run.cluster(during)


def _checkpointed_rounds(path: str) -> int:
    """How many rounds every key's optimizer state in the checkpoint at
    ``path`` has seen (Adam's step counter; 0 while a key is missing or
    the file is mid-write)."""
    from geomx_tpu_torch.kvstore.checkpoint import load_server_state

    try:
        store, opt, _ = load_server_state(path)
    except Exception:  # absent, or caught mid-write: poll again
        return 0
    state = getattr(opt.get("optimizer"), "state", {})
    if len(store) < CNN_KEYS or len(state) < CNN_KEYS:
        return 0
    return min(int(st.get("t", 0)) for st in state.values())


def _kill_after_checkpoint(run: _Run, rec: dict, advertise: bool):
    """``tests/test_recovery.py``: SIGKILL the global server once its
    auto-checkpoint holds a trained round, restart it (at a new address
    for the replacement), and the workers finish every step.  The JAX
    test kills 1 s after the file first appears; here the kill waits
    for a checkpoint in which every key's optimizer state has seen a
    round, whatever the pace (the first file can hold an unfinished
    INIT, from which the restarted server cannot serve)."""
    gs = str(run.topo().global_servers()[0])
    ckpt = os.path.join(run.work, "global_server_0.npz")

    def during(cl: LocalCluster):
        deadline = time.monotonic() + 120
        rounds = 0
        while time.monotonic() < deadline and not rounds:
            rounds = _checkpointed_rounds(ckpt)
            time.sleep(0.02)
        assert rounds, "no auto-checkpoint of a trained round appeared"
        rec["killed_at_s"] = time.monotonic() - t0
        rec["checkpointed_rounds"] = rounds
        cl.kill(gs)
        extra = []
        if advertise:
            # the replacement binds and announces a new address
            extra = ["--advertise", f"127.0.0.1:{free_base_port(1)}"]
        cl.spawn(gs, extra=extra)

    t0 = time.monotonic()
    return run.cluster(during)


def _failover(run: _Run, rec: dict, kill_shard: int):
    """``tests/test_failover.py`` / ``test_sharded_global.py``: a control
    run, then a run whose primary of ``kill_shard`` is SIGKILLed once
    ``KILL_AFTER_ROUNDS`` rounds have landed (the JAX tests wait 6 s
    from the spawn, or 3 s after "training begins": on the card 120
    rounds can end within that).  For the single-shard case the killed
    primary comes back as a zombie at its old identity once the standby
    was promoted, and its stale term must fence it while the cluster
    still trains: the zombie is started with the cluster, its modules
    and device loaded, and let through ``--start-gate`` at the
    promotion (on the card a fresh process takes longer to reach the
    card than the remaining rounds take)."""
    topo = run.topo()
    wrole = str(topo.workers(0)[0])
    victim = str(topo.global_servers()[kill_shard])
    standby = str(topo.standby_for(kill_shard))
    gate = os.path.join(run.work, "zombie.go")
    zombie = run.case.scenario == "failover"

    def during(cl: LocalCluster):
        if zombie:
            cl.spawn("zombie", role=victim, optional=True,
                     extra=["--start-gate", gate])
        assert cl.wait_output(wrole, rf"round {KILL_AFTER_ROUNDS}\b", 180), \
            f"worker never reached round {KILL_AFTER_ROUNDS}:\n" \
            + cl.output(wrole)[-2000:]
        cl.kill(victim)
        if zombie:
            assert cl.wait_output(standby, "promoted to primary", 60), \
                "standby never promoted:\n" + cl.output(standby)[-2000:]
            open(gate, "w").close()
            rec["zombie_fenced_live"] = bool(
                cl.wait_output("zombie", "fenced", 60))

    t0 = time.monotonic()
    ctrl = run.control = run.cluster()
    rec["control_s"] = time.monotonic() - t0
    _hold_common(run, ctrl)
    rec["control"] = _replication(ctrl, topo)
    rec["control_loss"] = _last_loss(ctrl[wrole][1])
    outs = run.cluster(during)
    rec["kill_loss"] = _last_loss(outs[wrole][1])
    ctrl_r, kill_r = (_round_losses(o[wrole][1]) for o in (ctrl, outs))
    rec["parity_rounds"] = {r: (ctrl_r.get(r), kill_r.get(r))
                            for r in PARITY_ROUNDS}
    return outs


# the kill lands once the worker has finished this many of its 120
# rounds: several rounds and replication ships, as in the JAX tests
KILL_AFTER_ROUNDS = 10
# the rounds right after the kill, whose losses the kill run must hold
# to the control run's at the JAX test's tolerance: the demo CNN's loss
# prints 0.0000 long before round 120 in both runs, so the final-loss
# gate alone cannot fail.  They need not be equal: replication ships
# asynchronously, so the failover may lose updates the dead primary had
# acknowledged but not yet shipped
PARITY_ROUNDS = range(KILL_AFTER_ROUNDS + 1, KILL_AFTER_ROUNDS + 21)


def _round_losses(out: str) -> Dict[int, float]:
    """A worker's ``round K loss=L`` lines (``--log-every 1``)."""
    return {int(k): float(v)
            for k, v in re.findall(r": round (\d+) loss=([0-9.]+)", out)}


def _replication(outs: dict, topo: Topology) -> dict:
    """The replication stream of an unkilled run, by shard: snapshots
    the standby applied, the bytes it received on the global domain
    (the snapshots and heartbeats), and the primary's billed D2H."""
    out = {}
    for gs in topo.global_servers():
        sb = topo.standby_for(gs.rank)
        if sb is None:
            continue
        g, s = outs[str(gs)][1], outs[str(sb)][1]
        out[gs.rank] = {
            "shipped": stat({0: (0, g)}, r"replicated_seq=(\d+)"),
            "applied": stat({0: (0, s)}, r"applied_repl_seq=(\d+)"),
            "standby_rx_bytes": stat({0: (0, s)}, r"wan_rx=(\d+)"),
            "primary_d2h_bytes": stat({0: (0, g)}, r"d2h_bytes=(\d+)")}
    return out


# ---- the gates ------------------------------------------------------------

def _hold_common(run: _Run, outs: dict) -> None:
    """Every process exited 0 (killed ones and a zombie excepted), every
    worker printed its ``steps=N``, every server its merge backend."""
    bad = {k: (rc, text[-1500:]) for k, (rc, text) in outs.items()
           if rc != 0 and "#killed" not in k and k != "zombie"}
    assert not bad, f"{run.case.name}: a process failed or hung: {bad}"
    for k, (_, text) in outs.items():
        if k.startswith("worker:") and "#" not in k:
            want = 2 if k == JOINER else run.case.steps
            assert re.search(rf"steps={want}\b", text), \
                f"{run.case.name} {k}: no steps={want}: {text[-800:]}"
        if k.startswith(SERVER_PREFIXES) and "#" not in k:
            assert f"merge_backend={run.backend_name} " in text + " ", \
                f"{run.case.name} {k}: not merge_backend=" \
                f"{run.backend_name}: {text[-800:]}"


def _mechanism(run: _Run, outs: dict, rec: dict) -> None:
    """The JAX test's assertion that the feature's mechanism fired."""
    c, topo = run.case, run.topo()
    name = c.name
    if name == "tsengine":
        rec["ts_relays"] = stat(outs, r"ts_relays=(\d+)")
        assert rec["ts_relays"] > 0, "overlay never relayed"
    elif name == "p3":
        rec["pq_overtakes"] = stat(outs, r"pq_overtakes=(\d+)")
        assert rec["pq_overtakes"] > 0, "priority queue never reordered"
    elif name == "hfa_k2":
        rec["hfa_gated_key_rounds"] = stat(outs,
                                           r"hfa_gated_key_rounds=(\d+)")
        assert rec["hfa_gated_key_rounds"] > 0, "K2 gate never fired"
    elif name == "esync":
        _esync(outs, rec)
    elif name == "dgt3":
        rec["dgt4_tx"] = stat(outs, r"dgt4_tx=(\d+)")
        rec["dgt4_rx"] = stat(outs, r"dgt4_rx=(\d+)")
        assert rec["dgt4_tx"] > 0, "no chunk was 4-bit requantized"
        assert rec["dgt4_rx"] > 0, "no 4-bit chunk was decoded"
    elif name in ("lm_mpq", "moe_lm", "mpq_cnn"):
        rec["mpq_bsc"] = stat(outs, r"mpq_bsc=(\d+)")
        rec["mpq_fp16"] = stat(outs, r"mpq_fp16=(\d+)")
        rec["wan_tx"] = stat(outs, r"wan_tx=(\d+)")
        if name != "moe_lm":
            assert rec["mpq_bsc"] > 0 and rec["mpq_fp16"] > 0, \
                "MPQ split did not exercise both codecs"
        if name != "mpq_cnn":
            w = outs[str(topo.workers(0)[0])][1]
            rec["n_params"] = int(re.search(r"n_params=(\d+)", w).group(1))
            rec["tokens_per_s"] = float(re.search(
                r"tokens_per_sec=([\d.]+)", w).group(1))
            if name == "lm_mpq":
                assert rec["n_params"] >= 10_000_000, rec["n_params"]
            else:
                assert rec["n_params"] > 1_500_000, rec["n_params"]
        if name == "lm_mpq":
            assert rec["wan_tx"] > 0, "no WAN traffic accounted"
    elif c.scenario == "join":
        j, srv = outs[JOINER][1], outs[str(topo.server(0))][1]
        assert "joined as rank 2" in j, j[-1000:]
        assert "left cleanly" in j, j[-1000:]
        m = re.search(r"joined=(\d+) left=(\d+)", srv)
        assert m and m.groups() == ("1", "1"), srv[-1000:]
        rec["joined"], rec["left"] = 1, 1
    elif c.scenario in ("restart", "replace"):
        gs = outs[str(topo.global_servers()[0])][1]
        rec["resumed"] = "resumed from" in gs
        assert rec["resumed"], gs[-2000:]
        st = _restored_state(gs, "restored")
        rec["restored_state"] = st
        assert st["keys"] == CNN_KEYS, st
        assert st["on"] == run.state_device, st
        assert st["steps"] is not None and st["steps"][0] >= 1, st
    elif c.scenario == "failover":
        sb = outs[str(topo.standby_globals()[0])][1]
        assert "promoted to primary" in sb, sb[-2000:]
        assert "term=1" in sb, sb[-2000:]
        srv = outs[str(topo.server(0))][1]
        assert "failed over to" in srv, srv[-2000:]
        assert "fenced" in outs["zombie"][1], outs["zombie"][1][-2000:]
        _promoted_state(run, sb, rec)
        _loss_parity(rec, FAILOVER_LOSS_TOL)
    elif c.scenario == "shards":
        sb1 = outs[str(topo.standby_globals()[1])][1]
        assert "promoted to primary" in sb1 and "term=1" in sb1, \
            sb1[-2000:]
        gs0 = outs[str(topo.global_servers()[0])][1]
        assert "fenced" not in gs0 and "term=1" not in gs0, gs0[-2000:]
        sb0 = outs[str(topo.standby_globals()[0])][1]
        assert "promoted to primary" not in sb0, sb0[-2000:]
        srv = outs[str(topo.server(0))][1]
        assert re.search(r"global shard 1 failed over to", srv), \
            srv[-2000:]
        _promoted_state(run, sb1, rec)
        _loss_parity(rec, SHARDS_LOSS_TOL)
    elif name == "dgt1_lossy":
        def udp(k):
            m = re.search(r"udp_tx=(\d+) udp_rx=(\d+) udp_dropped=(\d+)",
                          outs[k][1])
            return tuple(map(int, m.groups())) if m else (0, 0, 0)
        tx, _, dropped = udp(str(topo.server(0)))
        _, rx, _ = udp(str(topo.global_servers()[0]))
        rec.update(udp_tx=tx, udp_dropped=dropped, udp_rx=rx)
        assert tx > 0, "no UDP datagrams sent"
        assert dropped > 0, "no UDP loss occurred"
        assert rx > 0, "global server received no datagrams"


def _esync(outs: dict, rec: dict) -> None:
    """``tests/test_acceptance_matrix.py:125``'s gates: the planner hands
    the fast worker more local steps over the planned tail, the last
    round's per-step ratio exceeds 2 and its reach ratio stays below
    2."""
    rounds = {}
    for k, (_, out) in outs.items():
        m = re.search(r"esync_rounds=(\[.*\])", out)
        if m:
            rounds[k] = json.loads(m.group(1).replace("(", "[")
                                   .replace(")", "]"))
    assert set(rounds) == {"worker:0@p0", "worker:1@p0"}, sorted(rounds)
    fast, slow = rounds["worker:0@p0"], rounds["worker:1@p0"]
    fast_steps = sum(r[0] for r in fast[1:])
    slow_steps = sum(r[0] for r in slow[1:])
    f_ran, f_reach = fast[-1]
    s_ran, s_reach = slow[-1]
    per_step = (s_reach / max(s_ran, 1)) / max(f_reach / max(f_ran, 1),
                                               1e-9)
    reach = max(f_reach, s_reach) / max(min(f_reach, s_reach), 1e-9)
    rec.update(fast_steps=fast_steps, slow_steps=slow_steps,
               per_step_ratio=per_step, reach_ratio=reach,
               rounds={"fast": fast, "slow": slow})
    assert fast_steps > slow_steps, (fast, slow)
    assert per_step > 2.0, (fast, slow)
    assert reach < 2.0, (fast, slow)


def _promoted_state(run: _Run, out: str, rec: dict) -> None:
    st = _restored_state(out, "promoted")
    rec["promoted_state"] = st
    assert st["keys"] > 0 and st["on"] == run.state_device, st
    assert st["steps"] is not None and st["steps"][0] >= 1, st


def _loss_parity(rec: dict, tol: float) -> None:
    """The JAX test's gate on the final loss, and the same tolerance on
    every loss of ``PARITY_ROUNDS``, where the control run's loss must
    still read above 0."""
    rec["loss_delta"] = abs(rec["kill_loss"] - rec["control_loss"])
    assert rec["loss_delta"] < tol, (rec["kill_loss"], rec["control_loss"])
    rounds = rec["parity_rounds"]
    assert all(c is not None and k is not None
               for c, k in rounds.values()), rounds
    assert all(c > 0 for c, _ in rounds.values()), rounds
    rec["round_loss_delta"] = max(abs(k - c) for c, k in rounds.values())
    assert rec["round_loss_delta"] < tol, rounds


def _dgc(run: _Run, outs: dict, rec: dict) -> None:
    """On the card: each local server launched the DGC update once for
    each key its MPQ selector sent down BSC (its codec stage's BSC rung,
    in its own process)."""
    local = [str(run.topo().server(p)) for p in range(run.case.parties)]
    dgc = {r: stat(outs, r"dgc_update:(\d+)", [r]) for r in local}
    picks = {r: stat(outs, r"mpq_bsc=(\d+)", [r]) for r in local}
    rec["dgc_update_by_server"] = dgc
    assert all(n > 0 for n in dgc.values()), \
        f"a local server launched no DGC update: {dgc}"
    assert dgc == picks, f"DGC launches {dgc} != BSC picks {picks}"


SCENARIOS: Dict[str, Callable] = {
    "plain": lambda run, rec: run.cluster(),
    "join": _join,
    "restart": lambda run, rec: _kill_after_checkpoint(run, rec, False),
    "replace": lambda run, rec: _kill_after_checkpoint(run, rec, True),
    "failover": lambda run, rec: _failover(run, rec, 0),
    "shards": lambda run, rec: _failover(run, rec, 1),
}


def backend_for(case: Case, device: str) -> str:
    """The servers' merge backend: the default (``auto``: the torch
    backend on the card) on CUDA; on the host ``torch:cpu`` where the
    case is about the backend's state, else ``numpy``."""
    if device == "cuda":
        return "auto"
    return "torch:cpu" if case.state else "numpy"


def run_case(name: str, device: str = "cuda", backend: Optional[str] = None,
             out_dir: Optional[str] = None, prefix: str = "accept_") -> dict:
    """Run one case; returns its record (``seconds``: the wall of the
    whole case) and raises ``AssertionError`` when a gate fails.  Each
    process's output goes to ``out_dir/<prefix><name>.txt`` when
    given (an unkilled control run's to ``<prefix><name>_control.txt``)."""
    case = CASES[name]
    backend = backend or backend_for(case, device)
    work = tempfile.mkdtemp(prefix=f"geomx_accept_{name}_")
    try:
        run = _Run(case, device, backend, work)
        rec = {"case": name, "source": case.source, "device": device,
               "merge_backend": backend}
        t0 = time.monotonic()
        outs = SCENARIOS[case.scenario](run, rec)
        rec["seconds"] = time.monotonic() - t0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for suffix, kept in (("", outs), ("_control", run.control)):
                if kept is None:
                    continue
                with open(os.path.join(out_dir,
                                       f"{prefix}{name}{suffix}.txt"),
                          "w") as f:
                    for k, (rc, text) in kept.items():
                        f.write(f"===== {k} rc={rc}\n{text}\n")
        _hold_common(run, outs)
        _mechanism(run, outs, rec)
        if case.dgc and device == "cuda":
            _dgc(run, outs, rec)
        rec["processes"] = len(outs)
        return rec
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.acceptance",
        description="the JAX package's process-level acceptance cases "
                    "against the port's launcher")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="run only this case (repeatable; default: all)")
    ap.add_argument("--out-dir", default=None,
                    help="keep each process's output here")
    args = ap.parse_args(argv)
    failed = []
    for name in args.case or list(CASES):
        try:
            rec = run_case(name, args.device, out_dir=args.out_dir)
            print(json.dumps(rec, default=str), flush=True)
        except AssertionError as e:
            failed.append(name)
            print(f"{name}: FAILED: {e}", flush=True)
    print(f"{len(failed)} failed: {failed}" if failed else "all passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
