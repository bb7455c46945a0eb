"""The child processes a program starts, registered by process group,
and the reaping of them all however the program ends.

A child starts through :func:`popen` in a session of its own, so that
it and everything it starts (unless they leave the session) form one
process group that one ``killpg`` ends; the registry keeps that group.
:func:`release` ends a group: it notes the group's descendants first,
kills the group, then kills every noted descendant that had left it (a
grandchild that called ``setsid``), and names what it killed.

:class:`Run` guards a whole program (``chip_smoke.py``):

- it makes the program a child subreaper (``prctl(PR_SET_CHILD_SUBREAPER)``,
  an attribute of its own process), so an orphaned descendant comes back
  to it rather than to init and stays findable;
- SIGTERM and SIGINT kill every registered group at once and raise
  ``SystemExit`` (so no waiting thread outlives its processes);
- a watchdog thread keeps the program's own deadline: when it passes, it
  kills every descendant, names the running phase and exits non-zero;
- :meth:`Run.done` checks at each phase's end that no process outlived
  the phase, but the groups started under a background tag;
- on every way out (a return, an exception, a signal) it closes the
  registry, kills every registered group and every descendant, and lists
  what is still alive.

A leftover is a failure: one found at a phase's end, or at a normal
return, raises :class:`Leftover` naming the phase and each process's
argv; it is killed, never in silence.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

_PR_SET_CHILD_SUBREAPER = 36
# the tag of groups that may outlive a phase (their owner joins them
# later); :meth:`Run.done` spares them
BACKGROUND = "background"

_mu = threading.RLock()   # re-entered by a signal handler in popen()
_groups: dict = {}        # pgid -> _Group
_closed = False           # set once a run ends: no new child
_tag = threading.local()  # the tag popen() gives the groups it starts


@dataclass(frozen=True)
class Proc:
    pid: int
    ppid: int
    pgid: int
    sid: int
    state: str
    start: int            # clock ticks after boot: tells a reused pid

    @property
    def alive(self) -> bool:
        return self.state not in ("Z", "X")


@dataclass
class _Group:
    pgid: int
    what: str
    tag: str
    start: int = -1       # the leader's start time, -1 when not read


def _start_of(pid: int) -> int:
    p = table_of((pid,)).get(pid)
    return p.start if p is not None else -1


def _foreign(pgid: int, procs: dict) -> bool:
    """Whether group ``pgid`` is no longer the one registered: its
    leader's pid now names a process started later (a pid is not reused
    while a group of that id has members, so members without their
    leader are still the registered group's)."""
    with _mu:
        g = _groups.get(pgid)
    p = procs.get(pgid)
    return (g is not None and g.start >= 0 and p is not None
            and p.start != g.start)


class Leftover(RuntimeError):
    """A process outlived the phase that started it."""


# ---- the process table ----------------------------------------------------

def table_of(pids) -> dict:
    """``{pid: Proc}`` for those of ``pids`` that ``/proc`` shows."""
    out = {}
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                stat = f.read().decode(errors="replace")
        except OSError:
            continue
        # the command name may hold spaces and parentheses
        rest = stat[stat.rfind(")") + 2:].split()
        out[int(pid)] = Proc(int(pid), int(rest[1]), int(rest[2]),
                             int(rest[3]), rest[0], int(rest[19]))
    return out


def table() -> dict:
    """Every process of the machine that ``/proc`` shows: ``{pid: Proc}``."""
    return table_of(n for n in os.listdir("/proc") if n.isdigit())


def argv(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            raw = f.read()
    except OSError:
        return "?"
    return raw.replace(b"\0", b" ").decode(errors="replace").strip() or "?"


def descendants(root: int, procs=None) -> list:
    """The pids below ``root`` by parent link, nearest first."""
    procs = table() if procs is None else procs
    kids: dict = {}
    for p in procs.values():
        kids.setdefault(p.ppid, []).append(p.pid)
    out, todo = [], list(kids.get(root, ()))
    while todo:
        pid = todo.pop(0)
        out.append(pid)
        todo.extend(kids.get(pid, ()))
    return out


def _same_alive(p: Proc, now: dict) -> bool:
    q = now.get(p.pid)
    return q is not None and q.start == p.start and q.alive


def _kill(pids) -> None:
    for pid in pids:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.kill(pid, signal.SIGKILL)


def _killpg(pgid: int) -> None:
    if pgid <= 1 or pgid == os.getpgrp():
        return
    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.killpg(pgid, signal.SIGKILL)


def _wait_gone(procs, timeout_s: float) -> list:
    """Poll until none of ``procs`` is alive; those still alive."""
    deadline = time.monotonic() + timeout_s
    while True:
        now = table()
        left = [p for p in procs if _same_alive(p, now)]
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.02)


def named(procs) -> list:
    return [f"pid {p.pid} (group {p.pgid}, session {p.sid}): {argv(p.pid)}"
            for p in procs]


# ---- the registry ---------------------------------------------------------

@contextlib.contextmanager
def tagged(tag: str):
    """Groups that :func:`popen` starts in this thread, inside the block,
    carry ``tag`` (a phase's end spares those tagged ``BACKGROUND``)."""
    old = getattr(_tag, "value", "")
    _tag.value = tag
    try:
        yield
    finally:
        _tag.value = old


def popen(args, what=None, **kw) -> subprocess.Popen:
    """``subprocess.Popen`` in a session of its own, registered by its
    group.  Refused once the run is ending."""
    kw["start_new_session"] = True
    with _mu:
        if _closed:
            raise RuntimeError("the run is ending: no new child process")
        p = subprocess.Popen(args, **kw)
        _groups[p.pid] = _Group(p.pid, what or " ".join(map(str, args)),
                                getattr(_tag, "value", ""), _start_of(p.pid))
    return p


def release(pgid: int, timeout_s: float = 10.0) -> list:
    """Kill the registered group ``pgid`` and whatever of its process
    tree had left it (noted before the kill); unregister it.  Returns
    every process it killed but the group's leader, named."""
    procs = table()
    members = [] if _foreign(pgid, procs) else \
        [p for p in procs.values() if p.pgid == pgid and p.alive]
    tree = {d for m in members for d in descendants(m.pid, procs)}
    escaped = [procs[d] for d in sorted(tree)
               if procs[d].pgid != pgid and procs[d].alive]
    killed = named(p for p in members + escaped if p.pid != pgid)
    if members:
        _killpg(pgid)
    _kill(p.pid for p in escaped)
    _wait_gone(members + escaped, timeout_s)
    with _mu:
        _groups.pop(pgid, None)
    return killed


def registered() -> dict:
    with _mu:
        return {g.pgid: (g.what, g.tag) for g in _groups.values()}


def become_subreaper() -> bool:
    """Make this process a child subreaper: orphaned descendants are
    reparented to it.  False where the call is not there."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(_PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def kill_everything(timeout_s: float = 10.0) -> tuple:
    """Close the registry, kill every registered group and every
    descendant of this process.  Returns (what was alive, named; what is
    still alive after the kill, named)."""
    global _closed
    with _mu:
        _closed = True
        groups = list(_groups)
    me = os.getpid()
    procs = table()
    found = [procs[d] for d in descendants(me, procs) if procs[d].alive]
    names = named(found)   # before the kill: a dead process has no argv
    for g in groups:
        if not _foreign(g, procs):
            _killpg(g)
    _kill(p.pid for p in found)
    _wait_gone(found, timeout_s)
    now = table()
    still = [now[d] for d in descendants(me, now) if now[d].alive]
    return names, named(still)


# ---- a guarded run ----------------------------------------------------------

class Run:
    """A program's run: its phases in ``phases`` order (the first one is
    running), its deadline ``deadline_s`` from construction, ``log`` for
    its lines.  ``on_end`` callables run first on every way out (stop a
    pool from starting more)."""

    def __init__(self, deadline_s: float, phases, log=print, name="run"):
        self.t0 = time.monotonic()
        self.deadline_s = deadline_s
        self.phases = list(phases)
        self.phase = self.phases[0]
        self.log = log
        self.name = name
        self.on_end = []
        self.subreaper = False
        self._stop = threading.Event()
        self._old = {}

    # -- entry and exit --
    def __enter__(self):
        global _closed
        with _mu:
            _closed = False
        self.subreaper = become_subreaper()
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old[sig] = signal.signal(sig, self._on_signal)
        threading.Thread(target=self._watchdog, daemon=True,
                         name=f"{self.name}-deadline").start()
        self.log(f"{self.name}: child subreaper "
                 f"{'on' if self.subreaper else 'not available'}; deadline "
                 f"{self.deadline_s:.0f} s")
        return self

    def __exit__(self, exc_type, exc, tb):
        self._stop.set()
        for fn in self.on_end:
            with contextlib.suppress(Exception):
                fn()
        left = self._alive_descendants() if exc_type is None else []
        found, still = kill_everything()
        for sig, old in self._old.items():
            signal.signal(sig, old)
        if exc_type is not None:
            how = ("signal" if isinstance(exc, SystemExit) else
                   f"{exc_type.__name__} ({exc})")
            self.log(f"{self.name}: ended by {how} in phase {self.phase} "
                     f"after {time.monotonic() - self.t0:.1f} s; killed "
                     f"{len(found)} processes: {found}; still alive: "
                     f"{still or 'none'}")
            return False
        self.log(f"{self.name}: every child reaped; still alive: "
                 f"{still or 'none'}")
        if left or still:
            raise Leftover(f"{self.name}: at its end {len(left)} processes "
                           f"outlived their phases: {left}; alive after "
                           f"the kill: {still}")
        return False

    def _alive_descendants(self) -> list:
        procs = table()
        return named(procs[d] for d in descendants(os.getpid(), procs)
                     if procs[d].alive)

    # -- the ways out that do not return --
    def _on_signal(self, sig, frame):
        self.log(f"{self.name}: signal {sig} in phase {self.phase}: killing "
                 f"every child and exiting")
        for fn in self.on_end:
            with contextlib.suppress(Exception):
                fn()
        found, _ = kill_everything(timeout_s=2.0)
        self.log(f"{self.name}: killed {len(found)} processes: {found}")
        raise SystemExit(128 + sig)

    def _watchdog(self):
        if self._stop.wait(max(0.0, self.deadline_s
                               - (time.monotonic() - self.t0))):
            return
        self.log(f"{self.name}: deadline of {self.deadline_s:.0f} s passed "
                 f"in phase {self.phase}: killing every child")
        for fn in self.on_end:
            with contextlib.suppress(Exception):
                fn()
        found, still = kill_everything()
        self.log(f"{self.name}: killed {len(found)} processes: {found}; "
                 f"still alive: {still or 'none'}; exiting in phase "
                 f"{self.phase}")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(124)

    # -- phases --
    def done(self, name: str) -> None:
        """Phase ``name`` ended: log it, fail on a process that outlived
        it (but the background groups), and move to the next phase."""
        self.log(f"phase {name} done in {time.monotonic() - self.t0:.1f} s")
        procs = table()
        with _mu:
            spared = {g.pgid for g in _groups.values()
                      if g.tag == BACKGROUND}
        left = [procs[d] for d in descendants(os.getpid(), procs)
                if procs[d].alive and procs[d].pgid not in spared
                and procs[d].sid not in spared]
        if left:
            names = named(left)
            for n in names:
                self.log(f"{self.name}: phase {name} left a process "
                         f"running: {n}")
            _kill(p.pid for p in left)
            raise Leftover(f"phase {name} left {len(left)} processes "
                           f"running: {names}")
        i = self.phases.index(name) if name in self.phases else -1
        self.phase = (self.phases[i + 1] if 0 <= i < len(self.phases) - 1
                      else f"after {name}")
