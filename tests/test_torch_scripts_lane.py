"""The scripts lane: every ``scripts/run_*.sh`` of the JAX package run
through the port.

Each script is read as text and rewritten into a temporary tree:

- ``geomx_tpu`` becomes ``geomx_tpu_torch`` (the scripts ``cd`` to the
  tree's root, which holds only ``scripts/``; ``PYTHONPATH`` names the
  repository, so ``python -m geomx_tpu_torch.X`` finds the port);
- ``python examples/cnn_esync.py`` becomes the port's preset,
  ``python -m geomx_tpu_torch.examples.cnn_esync``;
- the tours' ``rm -rf`` of their log directory at exit becomes ``:``,
  so the runner can read every process's exit lines (``TMPDIR`` is the
  run's own directory, where ``mktemp -d`` puts them);
- an in-process script's Python (``<<'PY'``) prints the codec kernels'
  launches at its end (``kernel_launches={...}``);
- on the host (``device="cpu"``) every ``geomx_tpu_torch.launch --role
  R`` gains ``--device cpu`` after ``R``, the CNN preset too, and the
  servers merge on ``torch:cpu`` (``GEOMX_MERGE_BACKEND``); on the card
  nothing is added: the launcher's device is CUDA and ``auto`` is the
  torch backend.

Each run gets its own port range (``GEOMX_BASE_PORT`` and
``BASE_PORT``).  ``TABLE`` puts every script in one of four groups:

- ``run``: run as rewritten, held to its own exit code and assertions,
  and every launched cluster to its exit lines (every server prints
  ``merge_backend=torch``, every worker its ``steps=``; the roles a tour
  kills or drains are named in ``EXIT_EXCEPT``);
- ``covered``: the script's topology, flags, steps and environment
  equal those of a named case of ``geomx_tpu_torch.acceptance``
  (``test_covered_scripts_equal_their_cases`` proves it from both);
- ``counterpart``: a port module stands in for the script;
- ``lane``: the script is a pytest lane; it maps onto ``run_lane`` of
  ``tests/test_torch_runtime_lane_backend.py`` (``LANES``).

One script by hand::

    python -m tests.test_torch_scripts_lane --device cpu --script vanilla_hips
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pathlib
import re
import shlex
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"

RUN, COVERED, COUNTERPART, LANE = "run", "covered", "counterpart", "lane"

# the ten reference configs: run_cluster.sh (2 parties x 2 workers + one
# global server, 6 steps) with the config's flags
CONFIGS = ("vanilla_hips", "bisparse_compression", "dgt", "fp16",
           "hfa_sync", "mixed_precision", "mixed_sync", "multi_gps", "p3",
           "tsengine")
# the operator tours, each with its own assertions
TOURS = ("serve_demo", "integrity_demo", "partition_demo", "churn_demo",
         "postmortem_demo", "status_demo", "shard_chaos", "adaptive_demo",
         "lm")

TABLE = {
    **{f"run_{c}.sh": (RUN, "a reference config on run_cluster.sh")
       for c in CONFIGS},
    **{f"run_{t}.sh": (RUN, "an operator tour") for t in TOURS},
    "run_cluster.sh": (RUN, "the launcher of the ten configs: each execs "
                            "it with its flags (vanilla_hips with none)"),
    "run_esync.sh": (COUNTERPART, "geomx_tpu_torch/examples/cnn_esync.py "
                                  "(the script runs, rewritten onto the "
                                  "port's preset)"),
    "run_trace_demo.sh": (COUNTERPART,
                          "geomx_tpu_torch/examples/trace_demo.py (the "
                          "script's Python imports jax and trains the "
                          "JAX CNN)"),
    "run_recovery.sh": (COVERED, "restart"),
    "run_dynamic_join.sh": (COVERED, "join_plain"),
    "run_backend_smoke.sh": (LANE, "backend"),
    "run_shard_smoke.sh": (LANE, "shard"),
    "run_reactor_smoke.sh": (LANE, "reactor"),
    "run_chaos.sh": (LANE, "chaos"),
    "run_lint.sh": (LANE, "lint"),
}

# the scripts the runner runs (run_cluster.sh runs through each config)
RUNNABLE = tuple(f"run_{n}.sh" for n in CONFIGS + TOURS) + ("run_esync.sh",)

# the rewritten run_dynamic_join.sh's MODE → its acceptance case
JOIN_MODES = {"": "join_plain", "tsengine": "join_tsengine",
              "hfa": "join_hfa"}

# roles a tour kills (SIGKILL leaves no exit line) or drains (a
# preempted worker prints its drain, not steps=)
EXIT_EXCEPT = {
    "run_status_demo.sh": {"global_server:1": "SIGKILLed"},
    "run_postmortem_demo.sh": {"global_server:1": "SIGKILLed"},
    "run_shard_chaos.sh": {"global_server:1": "SIGKILLed"},
    "run_churn_demo.sh": {"worker:1@p1": "drained by SIGTERM ('preempted "
                                         "— drained and left gracefully')"},
}

# the local servers' DGC updates on the card: the bsc config's, once a
# key a step (run_cluster.sh's 6 steps of the launcher's 10-key CNN);
# the mpq config's, once for each key its selector sent down BSC
# (``mpq_bsc=``: none at these key sizes, all under the default
# 200,000-element bound, so the config's WAN is fp16 throughout)
DGC_EXACT = {"run_bisparse_compression.sh": 6 * 10}
DGC_PICKS = ("run_mixed_precision.sh",)
# the clusters whose servers' codec launches are printed
CODEC_SCRIPTS = tuple(DGC_EXACT) + DGC_PICKS + ("run_serve_demo.sh",
                                                 "run_lm.sh")

# the ports a script's processes bind above its base: the cluster's
# plan (base + i), a joiner (+40), the status console (+177) and the
# serve load drivers (+191 + replica)
PORT_SPAN = 256

SERVER_PREFIXES = ("server:", "global_server:", "standby_global:")
_ROLE = (r"(?:global_scheduler|global_server|standby_global|scheduler|"
         r"server|worker|replica):\d+(?:@p\d+)?")

# the lanes the pytest scripts map onto: the script's marker, its files
# (those the backend lane can rewrite: the others import JAX at module
# top, and their scenarios have port counterparts, ROADMAP A1) and its
# environment
LANES = {
    "backend": dict(files="FILES", marker=None, env={}),
    "shard": dict(files=("kvstore", "failover", "eviction",
                         "sharded_global", "recovery"),
                  marker=None, env={"GEOMX_GLOBAL_SHARDS": "2"}),
    "reactor": dict(files=("reactor", "transport", "tcp", "wire_v2", "ps",
                           "kvstore", "failover", "eviction", "churn",
                           "sharded_global", "recovery", "serve",
                           "serve_plane"),
                    marker=None, env={"GEOMX_TRANSPORT": "reactor"}),
    # the slow cases included, but those the slow mode leaves out too
    "chaos": dict(files="FILES", marker="chaos or failover", env={},
                  leave_out="SLOW"),
    "lint": dict(files=(), marker=None, env={}),
}


def lane_runner():
    """``tests/test_torch_runtime_lane_backend.py``, loaded by its path
    (a ``tests`` package installed on a machine would shadow the
    repository's namespace package)."""
    name = "torch_runtime_lane"
    if name not in sys.modules:
        path = ROOT / "tests" / "test_torch_runtime_lane_backend.py"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


# ---- the rewrite ------------------------------------------------------------

_LAUNCH_ROLE = re.compile(r"(geomx_tpu_torch\.launch --role \S+)")
_PRINT_LAUNCHES = '''
import sys as _sys
_q = _sys.modules.get("geomx_tpu_torch.ops.kernels.quantize_cuda")
print(f"kernel_launches={_q.launches() if _q else {}}", flush=True)
'''


def rewrite(text: str, device: str) -> str:
    """A script's text as the runner runs it on ``device``."""
    text = re.sub(r"geomx_tpu\b", "geomx_tpu_torch", text)
    text = text.replace("python examples/cnn_esync.py",
                        "python -m geomx_tpu_torch.examples.cnn_esync")
    text = text.replace('rm -rf "$OUT"', ":").replace(
        'rm -rf "$LOG_DIR"', ":")
    text = re.sub(r"^PY$", _PRINT_LAUNCHES.strip("\n") + "\nPY", text,
                  flags=re.M)
    if device == "cpu":
        text = _LAUNCH_ROLE.sub(r"\1 --device cpu", text)
        text = text.replace("geomx_tpu_torch.examples.cnn_esync",
                            "geomx_tpu_torch.examples.cnn_esync "
                            "--device cpu")
    return text


def write_tree(dest: pathlib.Path, device: str) -> pathlib.Path:
    """Every ``scripts/run_*.sh`` rewritten into ``dest/scripts``."""
    sdir = dest / "scripts"
    sdir.mkdir(parents=True, exist_ok=True)
    for src in sorted(SCRIPTS.glob("run_*.sh")):
        out = sdir / src.name
        out.write_text(rewrite(src.read_text(), device))
        out.chmod(0o755)
    return sdir


def launched_modules(text: str) -> set:
    """The ``python -m geomx_tpu_torch.X`` modules a rewritten script
    runs."""
    return set(re.findall(r"python3? -m (geomx_tpu_torch[\w.]*)", text))


def launcher_argv(text: str) -> list:
    """Each ``geomx_tpu_torch.launch`` call's arguments, with the
    script's variables given sample values and its arrays expanded as
    the script builds them."""
    flat = re.sub(r"\\\n\s*", " ", re.sub(r"^\s*#.*$", "", text,
                                          flags=re.M))
    arrays = {}
    for name, body in re.findall(r"^\s*(\w+)=\(([^)]*)\)", flat, re.M):
        arrays[name] = body
    calls = []
    for m in re.finditer(r"-m geomx_tpu_torch\.launch (.*?)(?:>|&\s*$|$)",
                         flat, re.M):
        s = m.group(1)
        for name, body in arrays.items():
            s = s.replace(f'"${{{name}[@]}}"', body)
        s = re.sub(r'"\$\{\w+\[@\]\}"', "", s)
        s = s.replace('"$@"', "")
        s = re.sub(r'"\$\(\((\w+) \+ \d+\)\)"', "9340", s)
        s = re.sub(r'"?\$\w+"?|"?\$\{\w+\}"?', "9300", s)
        calls.append(shlex.split(s))
    return calls


# ---- the run ----------------------------------------------------------------

@dataclass
class ScriptResult:
    script: str
    device: str
    rc: int
    wall_s: float
    output: str
    roles: dict = field(default_factory=dict)     # role -> its exit text
    codec: dict = field(default_factory=dict)     # server -> launches
    kernel_launches: dict = field(default_factory=dict)
    problems: list = field(default_factory=list)
    timeline: list = field(default_factory=list)  # (s, source, line)

    def ok(self) -> bool:
        return self.rc == 0 and not self.problems


def _role_of_log(stem: str):
    m = re.match(r"^([a-z_]+?)_(\d+)(?:_p(\d+))?$", stem)
    if not m:
        return None
    role = f"{m.group(1)}:{m.group(2)}"
    return role + (f"@p{m.group(3)}" if m.group(3) else "")


def collect_roles(output: str, tmp: pathlib.Path) -> dict:
    """{role: text}: the lines a role printed to the script's output
    (``role: ...``) and the log files the tours keep under ``tmp``."""
    roles = {}
    # processes share the script's output: one's line can run into
    # another's (print writes the text and its newline apart), so a
    # line is split at every "role: " in it
    for line in output.splitlines():
        for part in re.split(rf"(?<!global_)(?<!standby_)(?=(?:{_ROLE}): )",
                             line):
            m = re.match(rf"({_ROLE}): (.*)$", part)
            if m:
                roles.setdefault(m.group(1), []).append(m.group(2))
    out = {r: "\n".join(lines) for r, lines in roles.items()}
    for log in sorted(tmp.glob("*/*.log")):
        role = _role_of_log(log.stem)
        if role is not None:
            out[role] = out.get(role, "") + "\n" + log.read_text(
                errors="replace")
    return out


def _codec_launches(text: str) -> dict:
    m = re.findall(r"codec_launches=(\S+)", text)
    if not m:
        return {}
    return {k: int(v) for k, v in (p.split(":") for p in m[-1].split(","))}


def hold_exit_lines(res: ScriptResult, launched: bool) -> None:
    """Every server of a launched cluster printed ``merge_backend=torch``
    and every worker its ``steps=`` (the roles the script kills or
    drains excepted); the codec launches of every server are kept."""
    if not launched:
        return
    except_ = EXIT_EXCEPT.get(res.script, {})
    # the cluster's own roles (a host tool's client, such as serve.load's
    # balancer, takes a worker id outside the plan: no party)
    servers = [r for r in res.roles if r.startswith(SERVER_PREFIXES)]
    workers = [r for r in res.roles if re.match(r"worker:\d+@p\d+$", r)]
    if not servers or not workers:
        res.problems.append(f"no server or worker exit lines: "
                            f"{sorted(res.roles)}")
    for r in servers:
        if r in except_:
            continue
        if not re.search(r"merge_backend=torch\b", res.roles[r]):
            res.problems.append(f"{r}: no merge_backend=torch")
    for r in workers:
        if r in except_:
            continue
        if not re.search(r"steps=\d+", res.roles[r]):
            res.problems.append(f"{r}: no steps=")
    if res.script in CODEC_SCRIPTS:
        res.codec = {r: _codec_launches(res.roles[r]) for r in servers
                     if r not in except_}
    if res.device != "cuda":
        return
    for r, c in res.codec.items():
        if not r.startswith("server:"):
            continue
        want = DGC_EXACT.get(res.script)
        if res.script in DGC_PICKS:
            picks = re.findall(r"mpq_bsc=(\d+)", res.roles[r])
            want = int(picks[-1]) if picks else None
        if want is not None and c.get("dgc_update") != want:
            res.problems.append(f"{r}: {c.get('dgc_update')} DGC updates "
                                f"launched, not {want}")


def script_env(device: str, base_port: int, tmp: pathlib.Path,
               extra=None) -> dict:
    """The environment a script runs in: this interpreter first on
    ``PATH`` as ``python`` (the scripts call ``python``), the
    repository on ``PYTHONPATH``, its own ports and ``TMPDIR``."""
    bin_dir = tmp / "bin"
    bin_dir.mkdir(parents=True, exist_ok=True)
    exe = bin_dir / "python"
    if not exe.exists():
        # a wrapper, not a symlink: a virtual environment's interpreter
        # finds its environment from the path it was started by
        exe.write_text(f'#!/bin/sh\nexec {shlex.quote(sys.executable)} "$@"\n')
        exe.chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("GEOMX_", "PYTEST_"))}
    env.update(extra or {})
    env.update(GEOMX_BASE_PORT=str(base_port), BASE_PORT=str(base_port),
               TMPDIR=str(tmp), PYTHONUNBUFFERED="1",
               PATH=os.pathsep.join([str(bin_dir), env.get("PATH", "")]),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])))
    if device == "cpu":
        env["GEOMX_MERGE_BACKEND"] = "torch:cpu"
    return env


def run_script(script: str, device: str = "cpu", *, workdir=None,
               timeout: float = 900, base_port=None,
               extra_env=None) -> ScriptResult:
    """Run one rewritten script on ``device``; its exit lines are held
    (``ScriptResult.problems``) but nothing is raised."""
    from geomx_tpu_torch.launch import free_base_port

    assert TABLE.get(script, (None,))[0] in (RUN, COUNTERPART) and \
        script in RUNNABLE, f"{script} is not run by the runner"
    tmpd = None
    if workdir is None:
        tmpd = tempfile.TemporaryDirectory(prefix="scripts-lane-")
        workdir = tmpd.name
    work = pathlib.Path(workdir).resolve() / script[:-3]
    tree = work / "tree"
    tmp = work / "tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    sdir = write_tree(tree, device)
    base = base_port or free_base_port(PORT_SPAN)
    env = script_env(device, base, tmp, extra_env)
    t0 = time.monotonic()
    proc = subprocess.Popen(["bash", str(sdir / script)], cwd=str(tree),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    timeline = []           # (seconds, source, line): when it was seen
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)
            timeline.append((time.monotonic() - t0, "script",
                             line.rstrip("\n")))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    seen = {}
    rc = None
    while rc is None:
        try:
            rc = proc.wait(timeout=0.5)
        except subprocess.TimeoutExpired:
            if time.monotonic() - t0 > timeout:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                rc = 124
        _poll_logs(tmp, seen, timeline, time.monotonic() - t0)
    # what the script left running (its traps kill their children)
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    reader.join(10)
    output = "".join(lines)
    wall = time.monotonic() - t0
    res = ScriptResult(script, device, rc, wall, output)
    res.timeline = sorted(timeline)
    res.roles = collect_roles(output, tmp)
    m = re.findall(r"kernel_launches=(\{.*\})", output)
    if m:
        res.kernel_launches = eval(m[-1], {})   # a dict literal we printed
    hold_exit_lines(res, launched="geomx_tpu_torch.launch" in
                    (sdir / script).read_text() + (
                        (sdir / "run_cluster.sh").read_text()
                        if "run_cluster.sh" in (sdir / script).read_text()
                        else ""))
    if tmpd is not None:
        tmpd.cleanup()
    return res


def _poll_logs(tmp: pathlib.Path, seen: dict, timeline: list,
               t: float) -> None:
    """The lines the tours' log files gained since the last poll, each
    stamped ``t`` (a timeline for a failure's post-mortem)."""
    for log in sorted(tmp.glob("*/*.log")):
        try:
            data = log.read_bytes()
        except OSError:
            continue
        old, head = seen.get(log, (0, b""))
        if data[:old] != head:     # a relaunched role rewrote its log
            old = 0
        end = data.rfind(b"\n", old) + 1
        if end > old:
            for line in data[old:end].decode(errors="replace").splitlines():
                timeline.append((t, log.stem, line))
            seen[log] = (end, data[:end])


def summary(res: ScriptResult) -> str:
    return (f"{res.script}: rc {res.rc} wall {res.wall_s:.1f} s, "
            f"{len(res.roles)} roles"
            + (f", codec_launches {res.codec}" if res.codec else "")
            + (f", kernel_launches {res.kernel_launches}"
               if res.kernel_launches else "")
            + (f", problems {res.problems}" if res.problems else ""))


def write_output(res: ScriptResult, out_dir: pathlib.Path) -> None:
    """The script's output and each role's exit text, in
    ``out_dir/script_<name>.txt``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"script_{res.script[:-3]}.txt", "w") as f:
        f.write(res.output)
        for r, text in sorted(res.roles.items()):
            f.write(f"\n===== {r}\n{text}\n")
        f.write("\n===== timeline (s since the start, when seen)\n")
        for t, src, line in res.timeline:
            f.write(f"{t:8.1f} {src}: {line}\n")


def check(res: ScriptResult) -> None:
    timeline = "\n".join(f"{t:8.1f} {src}: {line}"
                         for t, src, line in res.timeline[-80:])
    assert res.ok(), (summary(res) + "\n" + res.output[-4000:]
                      + "\n--- timeline\n" + timeline)


def run_mapped_lane(name: str, backend: str = "torch:cpu", *,
                    workdir=None, timeout: float = 1500):
    """A pytest script's lane: ``run_lane`` with the script's marker,
    files and environment (``lint``: the port's checkers)."""
    spec = LANES[name]
    if name == "lint":
        out = subprocess.run(
            [sys.executable, "-m", "geomx_tpu_torch.analysis"],
            cwd=str(ROOT), capture_output=True, text=True, timeout=timeout,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        return out.returncode, out.stdout + out.stderr
    lane = lane_runner()
    files = lane.FILES if spec["files"] == "FILES" else spec["files"]
    leave_out = tuple(lane.SLOW_COVERED) + lane.SLOW_TIMING \
        if spec.get("leave_out") == "SLOW" else ()
    return lane.run_lane(files, backend, workdir=workdir, timeout=timeout,
                         extra_env=spec["env"], marker=spec["marker"],
                         leave_out=leave_out)


# ---- tier-1 -----------------------------------------------------------------

def test_every_script_is_accounted_for():
    """The table names every ``scripts/run_*.sh`` once, in one group."""
    names = sorted(p.name for p in SCRIPTS.glob("run_*.sh"))
    missing = [n for n in names if n not in TABLE]
    assert not missing, f"scripts the lane's table leaves out: {missing}"
    stale = [n for n in TABLE if n not in names]
    assert not stale, f"table entries with no script: {stale}"
    for n, (group, what) in TABLE.items():
        assert group in (RUN, COVERED, COUNTERPART, LANE), n
        if group == LANE:
            assert what in LANES, n
        if group == COUNTERPART:
            path = what.split()[0]
            assert (ROOT / path).is_file(), path
    assert set(RUNNABLE) <= set(TABLE)


def test_chip_smoke_phase_12_names_runnable_scripts():
    """``chip_smoke.py`` phase 12's lists name scripts the runner runs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_lane", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.SCRIPTS_QUIET) <= set(RUNNABLE)
    quiet = [n for seq in smoke.QUIET_STREAMS for n in seq] + list(
        smoke.QUIET_ALONE)
    assert sorted(quiet) == sorted(set(quiet)) == sorted(smoke.SCRIPTS_QUIET)
    assert set(smoke.SCRIPT_WALL_HINT_S) <= set(RUNNABLE)
    assert smoke.SCRIPT_STREAMS >= 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_rewritten_scripts_are_sound(tmp_path, device):
    """Each rewritten script parses (``bash -n``), names no module of
    the JAX package, every ``python -m geomx_tpu_torch.X`` in it
    resolves, and every launcher call's flags parse with the port's
    launcher (``--device cpu`` on the host, nothing on the card)."""
    from geomx_tpu_torch import launch

    sdir = write_tree(tmp_path, device)
    parser_calls = []
    orig_parse = launch.argparse.ArgumentParser.parse_args

    class _Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        ns = orig_parse(self, args, namespace)
        parser_calls.append(ns)
        raise _Parsed

    for path in sorted(sdir.glob("run_*.sh")):
        text = path.read_text()
        rc = subprocess.run(["bash", "-n", str(path)], capture_output=True,
                            text=True)
        assert rc.returncode == 0, (path.name, rc.stderr)
        assert not re.search(r"geomx_tpu\.", text), path.name
        assert not re.search(r"\bimport jax\b|\bfrom jax\b", text) or \
            TABLE[path.name][0] == COUNTERPART, path.name
        for mod in launched_modules(text):
            assert importlib.util.find_spec(mod) is not None, \
                (path.name, mod)
        for argv in launcher_argv(text):
            if device == "cpu":
                assert "--device" in argv and \
                    argv[argv.index("--device") + 1] == "cpu", \
                    (path.name, argv)
            else:
                assert "--device" not in argv, (path.name, argv)
            parser_calls.clear()
            launch.argparse.ArgumentParser.parse_args = capture
            try:
                with pytest.raises(_Parsed):
                    launch.main(argv)
            finally:
                launch.argparse.ArgumentParser.parse_args = orig_parse
            assert parser_calls, (path.name, argv)
    # the rewrite reached the launcher calls of every launching script
    for name in ("run_cluster.sh", "run_serve_demo.sh",
                 "run_integrity_demo.sh", "run_dynamic_join.sh",
                 "run_recovery.sh"):
        assert launcher_argv((sdir / name).read_text()), name


def _script_env_defaults(text: str) -> dict:
    """``export VAR="${VAR:-V}"`` / ``export VAR=V`` lines: {VAR: V}."""
    out = {}
    for var, val in re.findall(
            r'^export (GEOMX_\w+)="?\$\{\w+:-([^}]*)\}"?', text, re.M):
        out[var] = val
    for var, val in re.findall(r"^export (GEOMX_\w+)=(?!\"?\$)(\S+)$", text,
                               re.M):
        out[var] = val.strip("'\"")
    return out


def test_covered_scripts_equal_their_cases():
    """``run_recovery.sh`` is the ``restart`` case and
    ``run_dynamic_join.sh`` (each MODE) the ``join_*`` cases: the same
    topology, launcher flags, steps and environment, read from both
    files."""
    from geomx_tpu_torch import acceptance as A

    rec = (SCRIPTS / "run_recovery.sh").read_text()
    case = A.CASES[TABLE["run_recovery.sh"][1]]
    common = re.search(r"^COMMON=\((.*)\)$", rec, re.M).group(1).split()
    flags = dict(zip(common[0::2], common[1::2]))
    assert (int(flags["--parties"]), int(flags["--workers"])) == \
        (case.parties, case.workers)
    assert set(flags) == {"--parties", "--workers", "--base-port",
                          "--steps"} and case.flags == ()
    steps = re.search(r'^STEPS="\$\{STEPS:-(\d+)\}"', rec, re.M).group(1)
    assert int(steps) == case.steps
    env = _script_env_defaults(rec)
    # a directory (the script's and the case's own): not compared
    assert re.search(r'^export GEOMX_CHECKPOINT_DIR="\$CKPT_DIR"$', rec,
                     re.M) and "GEOMX_CHECKPOINT_DIR" not in env
    assert env == dict(case.env)
    assert case.scenario == "restart"
    # the script kills the global server and relaunches it at its own
    # address (no --advertise): the restart scenario, not the replacement
    assert re.search(r'kill -9 "\$GS_PID"', rec)
    assert re.search(r'^launch "global_server:0"$', rec, re.M)
    assert "--advertise" not in rec

    dj = (SCRIPTS / "run_dynamic_join.sh").read_text()
    assert TABLE["run_dynamic_join.sh"][1] == JOIN_MODES[""]
    m = re.search(r"PARTIES=(\d+) WORKERS=(\d+) STEPS=", dj)
    steps = int(re.search(r'^STEPS="\$\{STEPS:-(\d+)\}"', dj, re.M).group(1))
    join_steps = int(re.search(r"^JOIN_STEPS=(\d+)$", dj, re.M).group(1))
    modes = dict(re.findall(r"^\s+(\w+)\)\s+EXTRA\+=\(([^)]*)\)", dj, re.M))
    assert set(modes) | {""} == set(JOIN_MODES)
    assert not _script_env_defaults(dj)
    for mode, name in JOIN_MODES.items():
        c = A.CASES[name]
        assert c.scenario == "join"
        assert (int(m.group(1)), int(m.group(2)), steps) == \
            (c.parties, c.workers, c.steps)
        assert tuple(modes.get(mode, "").split()) == c.flags, mode
        assert c.env == ()
    src = (ROOT / "geomx_tpu_torch" / "acceptance.py").read_text()
    assert f'JOINER = "worker:2@p0"' in src and "--role worker:2@p0" in dj
    assert re.search(r'cl\.spawn\(JOINER, extra=\["--steps", "2", "--join"',
                     src) and join_steps == 2


@pytest.mark.parametrize("config", ["vanilla_hips", "bisparse_compression",
                                    "mixed_sync", "hfa_sync"])
def test_short_config_runs_on_the_host(config, tmp_path):
    """Short configs run as rewritten on ``torch:cpu``: rc 0, every
    worker's ``steps=`` and every server's ``merge_backend=torch``
    (``mixed_sync``: no party is cut off by the end of the run, C13)."""
    res = run_script(f"run_{config}.sh", "cpu", workdir=tmp_path,
                     timeout=300)
    check(res)
    assert sum(r.startswith("worker:") for r in res.roles) == 4
    assert sum(r.startswith(SERVER_PREFIXES) for r in res.roles) == 3


@pytest.mark.parametrize("module", ["serve.load", "status",
                                    "obs.postmortem"])
def test_host_tools_start_without_torch(module):
    """C9: the command-line tools the tours run beside a cluster
    (``serve.load``, ``status``, ``obs.postmortem``) import no torch, as
    the JAX package's import no JAX: with 2.5 s of torch import
    ``run_serve_demo.sh``'s balanced reads began after its killed
    replica was already marked dead, and never failed over."""
    code = (f"import sys, geomx_tpu_torch.{module}; "
            f"assert 'torch' not in sys.modules, 'torch imported'; "
            f"import geomx_tpu_torch as g; g.resolve_device('cpu'); "
            f"assert 'torch' in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]


def test_serve_load_dials_a_dead_replica_briefly():
    """C14: ``serve.load`` joins a running cluster, and its first read at
    a replica that is down must fail over within one read attempt.  The
    fabric's first dial to a peer it has never reached retried for the
    30 s bring-up window in the sender's thread (``run_serve_demo.sh``'s
    balanced reads started after their first pick's replica was killed
    and listed no keys for 33 s); the send now returns at once and the
    dial goes on behind it (``TcpFabric._dial_or_defer``)."""
    import socket

    from geomx_tpu_torch.transport.message import Control, Message
    from geomx_tpu_torch.transport.tcp import TcpFabric

    with socket.socket() as s:           # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()
    fab = TcpFabric({"replica:1": dead})
    try:
        t0 = time.monotonic()
        assert fab.deliver(Message(recipient="replica:1",
                                   control=Control.EMPTY))
        assert time.monotonic() - t0 < 1.0
    finally:
        fab.shutdown()


def _cluster_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("GEOMX_")}
    env.update(PYTHONPATH=str(ROOT), **extra)
    return env


def test_finished_worker_waits_for_the_end_of_the_run():
    """C10: with heartbeats on, a worker that finishes before the run
    ends (party 1's, here 12 steps at full pace against party 0's 500 ms
    steps, mixed sync) stays up until the terminator's TERMINATE, which
    its party scheduler passes on: no scheduler reports it evicted, and
    every process exits 0.  Before, it exited at once and its scheduler
    evicted it by heartbeat expiry (``run_partition_demo.sh`` failed on
    that line, in both packages)."""
    from geomx_tpu_torch.launch import run_local_cluster

    outs = run_local_cluster(
        2, 1, ["--steps", "12", "--sync", "mixed", "--device", "cpu",
               "--merge-backend", "numpy"],
        env=_cluster_env(GEOMX_HEARTBEAT_INTERVAL="0.2",
                         GEOMX_HEARTBEAT_TIMEOUT="2.0",
                         GEOMX_REQUEST_RETRY_S="1.0",
                         GEOMX_TEST_STEP_SLEEP_MS='{"worker:0@p0": 500}'),
        deadline_s=150, cwd=str(ROOT))
    bad = {k: (rc, text[-800:]) for k, (rc, text) in outs.items() if rc}
    assert not bad, bad
    text = "\n".join(t for _, t in outs.values())
    assert "steps=12" in outs["worker:0@p1"][1]
    assert "evicted worker" not in text, [
        ln for ln in text.splitlines() if "evicted" in ln]


def test_lagging_party_is_not_cut_off():
    """C13: under ``--sync mixed`` the parties progress apart; party 1's
    worker here takes 400 ms a step against party 0's full pace.  The
    terminator (party 0's rank 0) ends the run only once every party has
    reported done, so party 1 finishes its 12 steps and every process
    exits 0.  Before, it ended the run 0.5 s after its own party, and
    party 1's worker died mid-round (``run_mixed_sync.sh`` and
    ``run_churn_demo.sh`` failed on that, in both packages)."""
    from geomx_tpu_torch.launch import run_local_cluster

    outs = run_local_cluster(
        2, 1, ["--steps", "12", "--sync", "mixed", "--device", "cpu",
               "--merge-backend", "numpy"],
        env=_cluster_env(GEOMX_TEST_STEP_SLEEP_MS='{"worker:0@p1": 400}'),
        deadline_s=150, cwd=str(ROOT))
    bad = {k: (rc, text[-800:]) for k, (rc, text) in outs.items() if rc}
    assert not bad, bad
    assert "steps=12" in outs["worker:0@p1"][1]
    assert "without a done report" not in outs["worker:0@p0"][1]


def test_finished_worker_leaves_when_its_scheduler_is_gone():
    """A finished worker waits for the TERMINATE its party scheduler
    passes on (C10), but not for ever: with that scheduler killed after
    the worker finished, it leaves, saying so, once the terminator has
    stopped answering its reports (three heartbeat timeouts, at least
    10 s, after the terminator exits), with rc 0."""
    from geomx_tpu_torch.launch import run_local_cluster

    def kill_scheduler(cl):
        assert cl.wait_output("worker:0@p1", r"steps=12", 120)
        cl.kill("scheduler:0@p1")

    t0 = time.monotonic()
    outs = run_local_cluster(
        2, 1, ["--steps", "12", "--sync", "mixed", "--device", "cpu",
               "--merge-backend", "numpy"],
        env=_cluster_env(GEOMX_HEARTBEAT_INTERVAL="0.2",
                         GEOMX_HEARTBEAT_TIMEOUT="2.0",
                         GEOMX_REQUEST_RETRY_S="1.0",
                         GEOMX_TEST_STEP_SLEEP_MS='{"worker:0@p0": 500}'),
        deadline_s=150, during=kill_scheduler, cwd=str(ROOT))
    rc, text = outs["worker:0@p1"]
    assert rc == 0, text[-1500:]
    assert "leaving without the end of the run" in text, text[-1500:]
    assert outs["worker:0@p0"][0] == 0
    assert time.monotonic() - t0 < 120


@pytest.mark.parametrize("name", [
    "shard", "reactor", "lint",
    pytest.param("chaos", marks=pytest.mark.slow)])
def test_mapped_lane_passes_on_the_host(name, tmp_path):
    """A pytest script's lane on ``torch:cpu`` (``chaos`` runs the JAX
    suites' slow cases, so it is ``slow`` itself): every case but those
    left out passes; ``lint``: 0 findings."""
    if name == "lint":
        rc, out = run_mapped_lane(name)
        assert rc == 0 and "0 finding(s)" in out, out[-3000:]
        return
    res = run_mapped_lane(name, "torch:cpu", workdir=tmp_path)
    ran = {n: o for n, o in res.cases.items() if o != "left_out"}
    assert res.rc == 0 and not res.failed() and ran, res.output[-6000:]
    assert "skipped" not in ran.values(), res.output[-3000:]


def _jax_trace_demo(out_dir: pathlib.Path) -> dict:
    """The JAX script's Python (its ``<<'PY'`` block), run as it is."""
    text = (SCRIPTS / "run_trace_demo.sh").read_text()
    code = re.search(r"<<'PY'\n(.*?)^PY$", text, re.M | re.S).group(1)
    out_dir.mkdir(parents=True, exist_ok=True)    # the script's mkdir -p
    env = {k: v for k, v in os.environ.items() if not k.startswith("GEOMX_")}
    env.update(JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-", str(out_dir)], input=code,
                         capture_output=True, text=True, cwd=str(ROOT),
                         env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return _trace_invariants(out_dir)


def _trace_invariants(out_dir: pathlib.Path) -> dict:
    import json

    trace = json.loads((out_dir / "geomx_trace.json").read_text())
    report = json.loads((out_dir / "geomx_trace_report.json").read_text())
    evs = trace["traceEvents"]
    ids = {e["args"]["span"] for e in evs}
    return {
        "roles": {e["pid"].split(":")[0] for e in evs},
        "dangling": sum(1 for e in evs if e["args"]["parent"]
                        and e["args"]["parent"] not in ids),
        "rounds": len(report["rounds"]),
        "dominant": all(r["dominant_stage"] for r in report["rounds"]),
        "names": {e["name"] for e in evs},
    }


def test_trace_demo_counterpart_matches_the_jax_script(tmp_path):
    """The port's ``examples/trace_demo.py`` on the CPU and the JAX
    script's Python beside it: the same roles, no dangling edge in
    either, the same number of rounds, a dominant stage in each, and
    the same span names."""
    from geomx_tpu_torch.examples import trace_demo

    rec = trace_demo.run("cpu", str(tmp_path / "port"))
    port = _trace_invariants(tmp_path / "port")
    jax_side = _jax_trace_demo(tmp_path / "jax")
    assert rec["rounds"] == port["rounds"]
    assert port["roles"] == jax_side["roles"] >= {"worker", "server",
                                                  "global_server"}
    assert port["dangling"] == jax_side["dangling"] == 0
    assert port["rounds"] == jax_side["rounds"] > 0
    assert port["dominant"] and jax_side["dominant"]
    assert port["names"] == jax_side["names"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run JAX package scripts rewritten onto the port.")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--script", action="append",
                    help="NAME of scripts/run_NAME.sh (repeatable; "
                         "default: every runnable script)")
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--out", default=None,
                    help="keep each script's output and its roles' exit "
                         "text in DIR/script_NAME.txt")
    args = ap.parse_args(argv)
    names = [f"run_{n}.sh" for n in args.script] if args.script \
        else list(RUNNABLE)
    bad = []
    for name in names:
        res = run_script(name, args.device, timeout=args.timeout)
        if args.out:
            write_output(res, pathlib.Path(args.out))
        print(res.output[-3000:])
        print(summary(res), flush=True)
        if not res.ok():
            bad.append(name)
    print(f"failed: {bad}" if bad else "all passed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
