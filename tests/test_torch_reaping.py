"""The process registry (``geomx_tpu_torch/utils/reaper.py``) on the
host: every way a program ends leaves no process it started behind.

Each test gives the processes it starts a token of its own (a ``sleep``
argument) and afterwards scans ``/proc`` for a live process holding it.
The programs under test are small scripts run in a subprocess: :class:`reaper.Run`
makes its process a child subreaper and installs signal handlers, which
a test worker must not keep.
"""

import signal
import subprocess
import sys
import textwrap
import time
import uuid

from geomx_tpu_torch.utils import reaper
from tests.test_torch_runtime_lane_backend import ROOT, run_lane

# a child that puts a grandchild in a session of its own (``setsid``),
# prints the grandchild's pid, then sleeps (or exits, given "exit")
_SETSID_CHILD = textwrap.dedent("""\
    import subprocess, sys, time
    g = subprocess.Popen(["sleep", sys.argv[1]], start_new_session=True)
    print(g.pid, flush=True)
    if sys.argv[2:] != ["exit"]:
        time.sleep(600)
""")


def _token() -> str:
    # a sleep length no other test uses: it names this test's processes
    return f"{600 + uuid.uuid4().int % 10**6 / 10**3:.3f}"


def _survivors(token: str, sleeps_only: bool = False) -> list:
    """Live processes holding ``token`` (only its ``sleep``s)."""
    procs = reaper.table()
    out = [(pid, reaper.argv(pid)) for pid, p in procs.items()
           if p.alive and token in reaper.argv(pid).split()]
    return [(pid, a) for pid, a in out
            if not sleeps_only or a == f"sleep {token}"]


def _wait_no_survivor(token: str, timeout_s: float = 10.0) -> list:
    deadline = time.monotonic() + timeout_s
    while True:
        left = _survivors(token)
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)


def _program(tmp_path, body: str) -> subprocess.Popen:
    """Write a program whose ``body`` runs inside a
    :class:`reaper.Run` of phases ``one``, ``two``; its output merged."""
    path = tmp_path / f"prog_{uuid.uuid4().hex[:8]}.py"
    path.write_text(textwrap.dedent("""\
        import subprocess, sys, time
        sys.path.insert(0, {root!r})
        from geomx_tpu_torch.utils import reaper

        SETSID_CHILD = {child!r}
        deadline = float(sys.argv[2]) if sys.argv[2:] else 120.0
        try:
            with reaper.Run(deadline, ("one", "two"), name="prog",
                            log=lambda m: print(m, flush=True)) as run:
        {body}
        except reaper.Leftover as e:
            print(f"prog: {{e}}", flush=True)
            sys.exit(1)
        print("prog: ok", flush=True)
    """).format(root=str(ROOT), child=_SETSID_CHILD,
                body=textwrap.indent(textwrap.dedent(body), " " * 8)))
    return path


def _run(path, token, *extra, timeout=60):
    out = subprocess.run([sys.executable, str(path), token, *extra],
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout + out.stderr


def test_lane_timeout_kills_pytests_grandchild(tmp_path):
    """``run_lane`` on a written test that starts a ``sleep`` and then
    outlives the lane's timeout: pytest and the sleep both die."""
    token = _token()
    pid_file = tmp_path / "sleep.pid"
    test = tmp_path / "test_sleeps_past_the_timeout.py"
    test.write_text(textwrap.dedent(f"""\
        import subprocess, time

        def test_sleeps():
            p = subprocess.Popen(["sleep", "{token}"])
            with open({str(pid_file)!r}, "w") as f:
                f.write(str(p.pid))
            time.sleep(600)
    """))
    res = run_lane((), "torch:cpu", workdir=tmp_path / "w", extra=(str(test),),
                   timeout=25)
    assert res.rc == 124, res.output[-2000:]
    assert pid_file.exists(), res.output[-2000:]
    assert any(token in k for k in res.leftovers), res.leftovers
    assert _wait_no_survivor(token) == []


def test_release_names_and_kills_a_grandchild_that_left_the_group():
    token = _token()
    child = reaper.popen([sys.executable, "-c", _SETSID_CHILD, token],
                         stdout=subprocess.PIPE, text=True)
    try:
        gpid = int(child.stdout.readline())
        assert reaper.table()[gpid].sid == gpid   # its own session
        killed = reaper.release(child.pid)
        assert any(f"pid {gpid} " in k and token in k for k in killed), killed
        assert child.wait(10) == -signal.SIGKILL
        assert child.pid not in reaper.registered()
    finally:
        child.stdout.close()
    assert _wait_no_survivor(token) == []


def test_sigterm_mid_phase_reaps_every_child_and_exits_nonzero(tmp_path):
    token = _token()
    path = _program(tmp_path, """\
        run.done("one")
        c = reaper.popen([sys.executable, "-c", SETSID_CHILD, sys.argv[1]],
                         stdout=subprocess.PIPE, text=True)
        c.stdout.readline()
        subprocess.Popen(["sleep", sys.argv[1]])   # not registered
        print("phase two running", flush=True)
        time.sleep(600)
    """)
    prog_p = subprocess.Popen([sys.executable, str(path), token],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    lines = []
    for line in prog_p.stdout:
        lines.append(line)
        if "phase two running" in line:
            break
    assert len(_survivors(token, sleeps_only=True)) == 2, lines
    prog_p.send_signal(signal.SIGTERM)
    out = "".join(lines) + prog_p.stdout.read()
    rc = prog_p.wait(30)
    assert rc == 128 + signal.SIGTERM, out
    assert "signal 15 in phase two" in out, out
    assert "still alive: none" in out, out
    assert _wait_no_survivor(token) == [], out


def test_exception_in_a_phase_reaps_every_child(tmp_path):
    token = _token()
    path = _program(tmp_path, """\
        c = reaper.popen([sys.executable, "-c", SETSID_CHILD, sys.argv[1]],
                         stdout=subprocess.PIPE, text=True)
        c.stdout.readline()
        assert False, "phase one failed"
    """)
    rc, out = _run(path, token)
    assert rc == 1, out
    assert "ended by AssertionError (phase one failed) in phase one" in out
    assert "still alive: none" in out, out
    assert _wait_no_survivor(token) == [], out


def test_deadline_kills_every_child_and_names_the_phase(tmp_path):
    token = _token()
    path = _program(tmp_path, """\
        run.done("one")
        reaper.popen(["sleep", sys.argv[1]])
        subprocess.Popen(["sleep", sys.argv[1]])
        time.sleep(600)
    """)
    rc, out = _run(path, token, "3")
    assert rc == 124, out
    assert "deadline of 3 s passed in phase two" in out, out
    assert "still alive: none" in out, out
    assert _wait_no_survivor(token) == [], out


def test_orphan_comes_back_to_the_subreaper_and_fails_its_phase(tmp_path):
    """A registered child starts a grandchild in a session of its own and
    exits: the grandchild is reparented to the program (a subreaper), and
    the phase's end names it and fails the run."""
    token = _token()
    path = _program(tmp_path, """\
        c = reaper.popen([sys.executable, "-c", SETSID_CHILD, sys.argv[1],
                          "exit"], stdout=subprocess.PIPE, text=True)
        gpid = int(c.stdout.readline())
        c.wait()
        import os
        assert reaper.table()[gpid].ppid == os.getpid(), "not reparented"
        run.done("one")
    """)
    rc, out = _run(path, token)
    assert rc == 1, out
    assert "phase one left a process running" in out, out
    assert f"sleep {token}" in out, out
    assert _wait_no_survivor(token) == [], out


def test_background_group_is_spared_at_a_phase_end_not_at_the_run_end(
        tmp_path):
    token = _token()
    path = _program(tmp_path, """\
        with reaper.tagged(reaper.BACKGROUND):
            reaper.popen(["sleep", sys.argv[1]])
        run.done("one")
        print("phase one passed", flush=True)
    """)
    rc, out = _run(path, token)
    assert "phase one passed" in out, out
    assert rc == 1 and "outlived their phases" in out, out
    assert f"sleep {token}" in out, out
    assert _wait_no_survivor(token) == [], out


def test_a_clean_run_returns_normally(tmp_path):
    token = _token()
    path = _program(tmp_path, """\
        p = reaper.popen(["sleep", "0.1"])
        p.wait()
        reaper.release(p.pid)
        run.done("one")
        run.done("two")
    """)
    rc, out = _run(path, token)
    assert rc == 0 and "prog: ok" in out, out
    assert "every child reaped; still alive: none" in out, out


def test_popen_is_refused_once_the_run_ends(tmp_path):
    path = _program(tmp_path, """\
        pass
    """)
    path.write_text(path.read_text().replace(
        'print("prog: ok", flush=True)',
        'try:\n    reaper.popen(["true"])\nexcept RuntimeError as e:\n'
        '    print(f"refused: {e}", flush=True)'))
    rc, out = _run(path, _token())
    assert rc == 0 and "refused: the run is ending" in out, out


def test_release_of_an_ended_group_is_quiet():
    p = reaper.popen([sys.executable, "-c", "pass"])
    p.wait()
    assert reaper.release(p.pid) == []
    assert p.pid not in reaper.registered()
