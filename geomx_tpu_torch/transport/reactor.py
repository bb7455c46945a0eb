"""Per-process event-driven transport core: reactor loops + timer wheel.

The thread-per-endpoint harness caps realistic topology size: ``Van``
spawns recv/send/resend threads per node, ``TcpFabric`` adds an accept
loop, a UDP loop and one recv thread *per connection*, and every
monitor/pump owns a sleep-loop thread — a 128-party in-proc topology
means thousands of OS threads fighting the GIL, and the scheduler hot
spots the flight recorder's pressure gauges exist to name drown in pure
thread-switch noise.  This module is the classic reactor-over-
thread-per-connection move (the ps-lite/ZeroMQ design the reference
builds on; the TensorFlow paper's single-process multi-device harness
discipline, PAPERS.md):

- ``Reactor`` — a small FIXED pool of selector loop threads
  (``GEOMX_REACTOR_LOOPS``) servicing every registered socket in the
  process (non-blocking accept, readiness-driven reads, write-queue
  drains), plus ONE timer heap per loop (the timer wheel that absorbs
  ``Van._resend_thread``, the heartbeat loops and the monitor/pump
  sleep threads), plus a bounded worker pool
  (``GEOMX_REACTOR_WORKERS``) that executes handler work off the loop
  threads.
- ``SerialChannel`` — per-node FIFO dispatch over the shared worker
  pool: at most one in-flight drain per channel, so a node's inbound
  messages keep their exact arrival order (the ordering guarantee the
  per-node recv/customer threads provided) while the process runs
  O(loops + workers) threads instead of O(nodes).
- ``Periodic`` — a repeating tick that is a reactor timer when a
  reactor is present and a plain daemon thread otherwise, so the
  monitors migrate with one line and the legacy path stays untouched.

Selection: ``GEOMX_TRANSPORT=reactor|threads`` (``Config.transport``
wins when set; default ``threads`` until the reactor path has soaked).
``threads`` keeps the pre-reactor behavior bit-for-bit.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, List, Optional

_LOG = logging.getLogger(__name__)

_VALID_TRANSPORTS = ("threads", "reactor")


def resolve_transport(config=None) -> str:
    """The effective transport engine: ``Config.transport`` when set,
    else the ``GEOMX_TRANSPORT`` env (so a whole test suite can be
    shaken under the threaded fabric — ``GEOMX_TRANSPORT=threads
    pytest ...`` — without threading the knob through every fixture,
    the way GEOMX_SERVER_SHARDS / GEOMX_GLOBAL_SHARDS work), default
    ``reactor``.

    The reactor became the default after the flip checklist in
    docs/perf.md "Default-flip evidence" closed (clean blocking audits,
    full-suite parity, measured scaling); ``GEOMX_TRANSPORT=threads``
    stays supported as the escape hatch."""
    t = str(getattr(config, "transport", "") or "") if config is not None \
        else ""
    if not t:
        t = os.environ.get("GEOMX_TRANSPORT", "") or "reactor"
    t = t.strip().lower()
    if t not in _VALID_TRANSPORTS:
        raise ValueError(
            f"unknown transport {t!r} (GEOMX_TRANSPORT / Config.transport "
            f"must be one of {_VALID_TRANSPORTS})")
    return t


def resolve_reactor_loops(config=None) -> int:
    """Loop-thread count: ``Config.reactor_loops`` / GEOMX_REACTOR_LOOPS,
    0 = auto (min(4, cpus) — loops block in select(), more loops than
    cores only helps when one loop's callbacks are busy)."""
    n = int(getattr(config, "reactor_loops", 0) or 0) if config is not None \
        else 0
    if n <= 0:
        n = int(os.environ.get("GEOMX_REACTOR_LOOPS", "0") or 0)
    if n <= 0:
        n = min(4, os.cpu_count() or 1)
    return max(1, n)


def resolve_reactor_workers() -> int:
    """Handler-pool size (GEOMX_REACTOR_WORKERS, 0 = auto).  Handlers
    are event-driven (the push→merge→push-up→pull-down chain completes
    via callbacks, never parking a thread in wait()), so a small pool
    services hundreds of nodes; the floor of 8 leaves slack for the
    few blocking control paths (monitor RPCs, warm boots)."""
    n = int(os.environ.get("GEOMX_REACTOR_WORKERS", "0") or 0)
    if n <= 0:
        n = max(8, 2 * (os.cpu_count() or 1))
    return max(2, n)


class _Timer:
    __slots__ = ("due", "fn", "cancelled")

    def __init__(self, due: float, fn: Callable[[], None]):
        self.due = due
        self.fn = fn
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


class Registration:
    """One registered socket: read/write callbacks run on the owning
    loop thread.  ``want_write`` arms/disarms write readiness (senders
    toggle it around a non-empty write queue); ``close`` unregisters
    and (by default) closes the socket.  All mutations marshal onto
    the loop thread — the selectors module is not thread-safe."""

    __slots__ = ("_loop", "sock", "read_cb", "write_cb", "_mask",
                 "closed", "_installed")

    def __init__(self, loop: "_Loop", sock, read_cb, write_cb):
        self._loop = loop
        self.sock = sock
        self.read_cb = read_cb
        self.write_cb = write_cb
        self._mask = (selectors.EVENT_READ if read_cb else 0)
        self.closed = False
        self._installed = False

    # ---- loop-thread only ----------------------------------------------------
    def _install(self):
        if self.closed:
            return
        try:
            self._loop._sel.register(self.sock, self._mask or
                                     selectors.EVENT_READ, self)
            self._installed = True
            if not self._mask:
                # registered purely for future write interest: park with
                # read interest off by modifying to 0-ish is invalid —
                # selectors require at least one event, so idle write-
                # only sockets register READ (a peer close shows up as
                # readable EOF, which the write_cb owner handles)
                self._mask = selectors.EVENT_READ
        except (OSError, ValueError, KeyError):
            self.closed = True

    def _set_mask(self, mask: int):
        if self.closed or not self._installed:
            return
        mask = mask or selectors.EVENT_READ
        if mask == self._mask:
            return
        try:
            self._loop._sel.modify(self.sock, mask, self)
            self._mask = mask
        except (OSError, ValueError, KeyError):
            pass

    # ---- any thread ----------------------------------------------------------
    def want_write(self, on: bool):
        base = selectors.EVENT_READ if self.read_cb else 0
        mask = base | (selectors.EVENT_WRITE if on else 0)
        self._loop.call_on_loop(lambda: self._set_mask(mask))

    def close(self, close_sock: bool = True):
        def _do():
            if not self.closed:
                self.closed = True
                if self._installed:
                    try:
                        self._loop._sel.unregister(self.sock)
                    except (OSError, ValueError, KeyError):
                        pass
            if close_sock:
                try:
                    self.sock.close()
                except OSError:
                    pass
        self._loop.call_on_loop(_do)


class _Loop:
    """One selector + timer heap serviced by one thread.  The waker
    socketpair interrupts select() for cross-thread register/timer
    operations (the standard self-pipe trick)."""

    def __init__(self, name: str):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._r, self._w = socket.socketpair()
        self._r.setblocking(False)
        self._w.setblocking(False)
        self._sel.register(self._r, selectors.EVENT_READ, None)
        self._mu = threading.Lock()
        self._pending: deque = deque()
        self._timers: list = []  # heap of (due, tie, _Timer)
        self._tie = itertools.count()
        self._stop = False
        self.last_lag_ms = 0.0  # scheduled-vs-actual delta of the most
        #                         recently fired timer: a loop that can't
        #                         keep up with its fds shows it here
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _wake(self):
        try:
            self._w.send(b"\0")
        except (OSError, BlockingIOError):
            pass  # a full waker buffer already guarantees a wakeup

    def call_on_loop(self, fn: Callable[[], None]):
        with self._mu:
            self._pending.append(fn)
        self._wake()

    def call_at(self, due: float, fn: Callable[[], None]) -> _Timer:
        t = _Timer(due, fn)
        with self._mu:
            heapq.heappush(self._timers, (due, next(self._tie), t))
        self._wake()
        return t

    def fd_count(self) -> int:
        """Registered sockets on this loop (the waker excluded)."""
        try:
            return max(0, len(self._sel.get_map()) - 1)
        except (OSError, RuntimeError):
            return 0

    def stop(self):
        self._stop = True
        self._wake()

    def _run(self):
        while not self._stop:
            with self._mu:
                timeout = None
                if self._timers:
                    timeout = max(0.0,
                                  self._timers[0][0] - time.monotonic())
            try:
                events = self._sel.select(timeout)
            except OSError:
                continue  # a socket closed mid-select; retry
            if self._stop:
                break
            for key, mask in events:
                if key.data is None:  # the waker
                    try:
                        while self._r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                reg: Registration = key.data
                if reg.closed:
                    continue
                try:
                    if mask & selectors.EVENT_READ and reg.read_cb:
                        reg.read_cb()
                    if (mask & selectors.EVENT_WRITE and reg.write_cb
                            and not reg.closed):
                        reg.write_cb()
                except Exception:  # pragma: no cover - surfaced via logs
                    _LOG.exception("%s: socket callback failed", self.name)
            # cross-thread operations (register/modify/close)
            while True:
                with self._mu:
                    if not self._pending:
                        break
                    fn = self._pending.popleft()
                try:
                    fn()
                except Exception:  # pragma: no cover
                    _LOG.exception("%s: loop op failed", self.name)
            # due timers
            now = time.monotonic()
            while True:
                with self._mu:
                    if not self._timers or self._timers[0][0] > now:
                        break
                    due, _, t = heapq.heappop(self._timers)
                if t.cancelled:
                    continue
                self.last_lag_ms = max(0.0, (now - due) * 1000.0)
                try:
                    t.fn()
                except Exception:  # pragma: no cover
                    _LOG.exception("%s: timer failed", self.name)
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._r, self._w):
            try:
                s.close()
            except OSError:
                pass


class SerialChannel:
    """FIFO dispatch lane over a shared pool: items are processed in
    exact ``put`` order with at most one in-flight drain task — the
    per-node ordering the dedicated recv/customer threads provided,
    at O(1) threads.  ``close`` drops queued items and makes further
    puts no-ops (a stopped node processes nothing further)."""

    # yield the pool worker back after this many items so one firehose
    # channel cannot starve every other node's dispatch
    _BATCH = 64

    __slots__ = ("_pool", "_cb", "_mu", "_items", "_active", "_closed",
                 "name")

    def __init__(self, pool, cb: Callable, name: str = ""):
        self._pool = pool
        self._cb = cb
        self._mu = threading.Lock()
        self._items: deque = deque()
        self._active = False
        self._closed = False
        self.name = name

    def put(self, item) -> None:
        with self._mu:
            if self._closed:
                return
            self._items.append(item)
            if self._active:
                return
            self._active = True
        self._pool.submit(self._drain)

    def qsize(self) -> int:
        with self._mu:
            return len(self._items)

    def _drain(self):
        for _ in range(self._BATCH):
            with self._mu:
                if self._closed or not self._items:
                    self._active = False
                    return
                item = self._items.popleft()
            try:
                self._cb(item)
            except Exception:  # pragma: no cover - surfaced via logs
                _LOG.exception("channel %s: handler failed", self.name)
        # batch exhausted with work left: requeue so siblings get a turn
        with self._mu:
            if self._closed or not self._items:
                self._active = False
                return
        self._pool.submit(self._drain)

    def close(self):
        with self._mu:
            self._closed = True
            self._items.clear()


class _RepeatingTask:
    """One ``call_every`` registration: fires on the timer wheel,
    executes on the worker pool, skips a tick while the previous run is
    still going (matching the thread-loop semantics where a long sweep
    simply delays the next)."""

    __slots__ = ("_reactor", "interval", "fn", "name", "_cancelled",
                 "_running", "_mu", "_timer")

    def __init__(self, reactor: "Reactor", interval: float, fn, name: str):
        self._reactor = reactor
        self.interval = max(1e-3, float(interval))
        self.fn = fn
        self.name = name
        self._cancelled = False
        self._running = False
        self._mu = threading.Lock()
        self._timer = None
        self._schedule()

    def _schedule(self):
        if self._cancelled:
            return
        loop = self._reactor._loop_for_timers()
        self._timer = loop.call_at(time.monotonic() + self.interval,
                                   self._fire)

    def _fire(self):  # loop thread: hand off, never block the selector
        if self._cancelled:
            return
        with self._mu:
            skip = self._running
            if not skip:
                self._running = True
        if not skip:
            self._reactor.submit(self._run)
        self._schedule()

    def _run(self):
        try:
            if not self._cancelled:
                self.fn()
        except Exception:  # pragma: no cover - surfaced via logs
            _LOG.exception("periodic %s failed", self.name)
        finally:
            with self._mu:
                self._running = False

    def cancel(self):
        self._cancelled = True
        t = self._timer
        if t is not None:
            t.cancel()

    # Periodic-compat alias
    stop = cancel


class Reactor:
    """The per-process event core: N selector loops + one worker pool.
    Create private instances for tests; production code shares ONE via
    :meth:`shared` (its threads are process-lifetime, named
    ``geomx-reactor-*`` — a fixed-size pool, O(1) in node count)."""

    _shared: Optional["Reactor"] = None
    _shared_mu = threading.Lock()

    def __init__(self, loops: int = 0, workers: int = 0,
                 name: str = "geomx-reactor"):
        from concurrent.futures import ThreadPoolExecutor

        n = loops or resolve_reactor_loops()
        self.name = name
        self._loops: List[_Loop] = [_Loop(f"{name}-loop-{i}")
                                    for i in range(n)]
        self._rr = itertools.count()
        self.workers = workers or resolve_reactor_workers()
        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix=f"{name}-w")
        self._stopped = False

    @classmethod
    def shared(cls) -> "Reactor":
        with cls._shared_mu:
            if cls._shared is None or cls._shared._stopped:
                cls._shared = cls()
            return cls._shared

    # ---- sockets -------------------------------------------------------------
    def register(self, sock, read_cb=None, write_cb=None) -> Registration:
        """Register a NON-BLOCKING socket; callbacks run on the owning
        loop thread (level-triggered: keep them short, read until
        EAGAIN).  fds spread round-robin across the loops."""
        loop = self._loops[next(self._rr) % len(self._loops)]
        reg = Registration(loop, sock, read_cb, write_cb)
        loop.call_on_loop(reg._install)
        return reg

    # ---- timer wheel ---------------------------------------------------------
    def _loop_for_timers(self) -> _Loop:
        return self._loops[next(self._rr) % len(self._loops)]

    def call_later(self, delay: float, fn: Callable[[], None]) -> _Timer:
        """One-shot timer; ``fn`` runs ON THE LOOP THREAD — keep it
        tiny (or submit to the pool yourself)."""
        return self._loop_for_timers().call_at(
            time.monotonic() + max(0.0, delay), fn)

    def call_every(self, interval: float, fn: Callable[[], None],
                   name: str = "") -> _RepeatingTask:
        """Repeating tick executed on the WORKER POOL (safe to block
        briefly); overlapping ticks are skipped.  This is the timer
        wheel that absorbs the per-node resend/heartbeat/monitor sleep
        threads."""
        return _RepeatingTask(self, interval, fn, name or "tick")

    # ---- handler pool --------------------------------------------------------
    def submit(self, fn: Callable[[], None]):
        try:
            self._pool.submit(self._guard, fn)
        except RuntimeError:
            # raced stop(): a timer tick fired while the pool was
            # shutting down — dropping it matches the thread-loop
            # semantics (a stopped loop simply never runs its next turn)
            pass

    @staticmethod
    def _guard(fn):
        try:
            fn()
        except Exception:  # pragma: no cover - surfaced via logs
            _LOG.exception("reactor task failed")

    def channel(self, cb: Callable, name: str = "") -> SerialChannel:
        return SerialChannel(self._pool, cb, name=name)

    # ---- observability -------------------------------------------------------
    def loop_lag_ms(self) -> float:
        """Worst recent timer-fire lag across the loops — the
        ``reactor_loop_lag_ms`` pressure gauge: a loop whose callbacks
        hog it shows up here before anything deadlocks."""
        return max((lp.last_lag_ms for lp in self._loops), default=0.0)

    def fd_counts(self) -> List[int]:
        """Registered sockets per loop."""
        return [lp.fd_count() for lp in self._loops]

    def fd_count(self) -> int:
        """Total registered sockets (the ``reactor_fds`` gauge; per-loop
        detail via :meth:`fd_counts`)."""
        return sum(self.fd_counts())

    @property
    def loops(self) -> int:
        return len(self._loops)

    def stop(self):
        """Tear down (private/test reactors only — never the shared
        one: its channels and timers are owned process-wide)."""
        self._stopped = True
        for lp in self._loops:
            lp.stop()
        self._pool.shutdown(wait=False)


class Periodic:
    """A repeating background tick: a reactor timer when ``reactor`` is
    given (one timer-wheel entry, zero threads), else a daemon thread
    with the classic ``Event.wait(interval)`` loop (the pre-reactor
    behavior, bit-for-bit).  The one-line migration path for the
    monitor/pump loops."""

    def __init__(self, interval: float, fn: Callable[[], None],
                 name: str = "periodic", reactor: Optional[Reactor] = None):
        self.interval = float(interval)
        self.fn = fn
        self.name = name
        self._task = None
        self._stop_ev = None
        self._thread = None
        if reactor is not None:
            self._task = reactor.call_every(self.interval, fn, name=name)
        else:
            self._stop_ev = threading.Event()
            self._thread = threading.Thread(target=self._run, name=name,
                                            daemon=True)
            self._thread.start()

    def _run(self):
        while not self._stop_ev.wait(self.interval):
            try:
                self.fn()
            except Exception:  # pragma: no cover - surfaced via logs
                _LOG.exception("periodic %s failed", self.name)

    def stop(self):
        if self._task is not None:
            self._task.cancel()
        if self._stop_ev is not None:
            self._stop_ev.set()
