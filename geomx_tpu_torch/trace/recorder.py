"""Per-node span recorder + batched reporter.

One ``Tracer`` per node (keyed like ``utils.get_profiler``).  Spans are
recorded as Chrome-trace events **into the node's existing Profiler
event buffer** (one buffer per node — the remote-profiler dump and the
distributed trace cannot drift apart), with the causal identity
(trace_id / span / parent) in ``args``.  A second reference to each
event dict sits in the tracer's pending batch until it is shipped to the
scheduler-side collector (``Ctrl.TRACE_REPORT``) — the dicts are shared,
never copied.

Spans record in two cases: inside a sampled round (``ACTIVE`` and a
thread context, the causal trace), and, traceless where no sampled
context is open, whenever ``torch.profiler`` records — so a profiled
run gets the program's spans beside the device's events with no knob
of its own.

Timestamps: events carry the profiler-relative ``ts`` (so a per-node
``Profiler.dump`` stays coherent) plus an absolute ``t_mono_us`` in
``args`` — the collector merges on the monotonic clock, corrected by the
per-node offset estimated from heartbeat RTTs.  A span's ``args`` also
hold ``unix_ns``, its start and end in Unix nanoseconds
(``time.time_ns``, the clock ``torch.profiler`` stamps host events on:
a Chrome trace's ``ts`` is microseconds after its
``baseTimeNanoseconds``), and the two ids such a trace gives its
thread: ``native_tid`` (the OS id: the ``tid`` of the thread's events
where the profiler registered the thread, as it does the one that
started it) and ``profiler_tid`` (from its pthread id: the ``tid`` of
the CUDA runtime events of a thread it did not register, such as a
worker's).
:func:`recorded_spans` returns them.

Overhead: ``span()`` / ``round()`` return the shared ``_NULL_SPAN``
whenever neither case holds — two flag reads, no allocation, nothing
stamped.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional

from geomx_tpu_torch.trace import context as _ctx
from geomx_tpu_torch.utils.profiler import Profiler, get_profiler


def torch_profiling() -> bool:
    """True while ``torch.profiler`` (or the autograd profiler) records,
    on any thread: torch keeps one process-wide flag for it.  Never
    imports torch — a process that has not loaded it is not profiling."""
    m = sys.modules.get("torch.autograd.profiler")
    return m is not None and m._is_profiler_enabled


class _NullSpan:
    """Shared no-op span: the entire cost of an instrumented site when
    tracing is off (``tracer.span(...) is _NULL_SPAN``).  ``recording``
    is False, so a site computes a span's ``args`` only when it records."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A recording span.  ``args`` (a dict) rides into the event's
    ``args``: a site adds its counts (``bytes``, ``key``) there.  A
    traceless span (``trace_id`` 0: recorded because the torch profiler
    runs) leaves the thread's context alone, so nothing it encloses
    joins or starts a trace."""

    __slots__ = ("_tr", "name", "cat", "_enter_ctx", "_prev", "span_id",
                 "parent", "trace_id", "_t0", "_t0_mono", "_t0_ns", "args")
    recording = True

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: int, parent: int):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.parent = parent
        self.span_id = _ctx.new_span_id()
        self.args: dict = {}

    def __enter__(self):
        if self.trace_id:
            self._prev = _ctx.swap(_ctx.TraceContext(self.trace_id,
                                                     self.span_id))
        self._t0_mono = time.monotonic()
        self._t0 = time.perf_counter()
        self._t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1_ns = time.time_ns()
        dur_us = (time.perf_counter() - self._t0) * 1e6
        if self.trace_id:
            _ctx.restore(self._prev)
        self._tr._record(self.name, self.cat, dur_us, self.trace_id,
                         self.span_id, self.parent, self._t0_mono,
                         unix_ns=(self._t0_ns, t1_ns),
                         native_tid=threading.get_native_id(),
                         profiler_tid=_profiler_tid(), **self.args)
        return False


def _profiler_tid() -> int:
    """The id ``torch.profiler``'s trace gives the CUDA runtime events of
    a thread it has not registered: the low 32 bits of the thread's
    pthread id read as a signed int, without its sign."""
    i = threading.get_ident() & 0xFFFFFFFF
    return (1 << 32) - i if i >= 1 << 31 else i


class Tracer:
    """Span recorder for one node; ship via :meth:`attach` + flush."""

    def __init__(self, node: str, profiler: Optional[Profiler] = None):
        self.node = node
        self.profiler = profiler or get_profiler(node)
        self._mu = threading.Lock()
        self._pending: List[dict] = []
        self._po = None  # postoffice, once attached
        self._collector = None  # in-proc shortcut (collector on this node)
        self.batch_events = 256
        self.dropped_events = 0
        self._cap = 100_000

    # ---- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "trace"):
        """Timed child span of the thread's current context; traceless
        where there is none and the torch profiler records; else the
        shared no-op."""
        if _ctx.ACTIVE:
            cur = _ctx.current()
            if cur is not None:
                return _Span(self, name, cat, cur.trace_id, cur.span_id)
        if torch_profiling():
            return _Span(self, name, cat, 0, 0)
        return _NULL_SPAN

    def handler_span(self, name: str):
        """A request handler's span: this tracer's when it records, else
        the node profiler's own (a no-op unless that runs).  Both write
        into one buffer, so a handler is recorded once, never twice."""
        sp = self.span(name)
        return sp if sp.recording else self.profiler.span(name)

    def round(self, round_idx: int, sample_every: int):
        """Root span of one sampled round: every node derives the same
        ``trace_id`` from the round index, so the collector can merge
        all parties' round-N spans into one tree."""
        if (not _ctx.ACTIVE or sample_every <= 0
                or round_idx % sample_every != 0):
            return _NULL_SPAN
        return _Span(self, "round", "round",
                     _ctx.trace_id_for_round(round_idx), 0)

    def instant(self, name: str, span: int = 0, parent: int = 0,
                trace_id: int = 0, **extra):
        """Zero-duration event.  With ``trace_id`` (the message hooks:
        wan.send / wan.recv) it joins that trace; without one it adopts
        the thread's context when present, else records traceless — how
        failover / eviction control events land on the shared timeline
        even though no sampled round is open around them."""
        if not _ctx.ACTIVE:
            return
        if trace_id == 0:
            cur = _ctx.current()
            if cur is not None:
                trace_id, parent = cur.trace_id, cur.span_id
        self._record(name, "event", 0.0, trace_id,
                     span or _ctx.new_span_id(), parent,
                     time.monotonic(), **extra)

    def _record(self, name: str, cat: str, dur_us: float, trace_id: int,
                span: int, parent: int, t_mono: float, **extra):
        prof = self.profiler
        ev = {
            "name": name, "cat": cat, "ph": "X" if dur_us else "i",
            "ts": (t_mono - prof.t0_mono) * 1e6,
            "dur": dur_us,
            "pid": self.node, "tid": threading.current_thread().name,
            "args": {"trace_id": trace_id, "span": span, "parent": parent,
                     "t_mono_us": t_mono * 1e6, **extra},
        }
        prof.add_event(ev)
        with self._mu:
            if len(self._pending) >= self._cap:
                self.dropped_events += 1
                return
            self._pending.append(ev)
            ship = (self._po is not None
                    and len(self._pending) >= self.batch_events)
        if ship:
            self.flush()

    # ---- shipping -----------------------------------------------------------
    def attach(self, postoffice, collector=None) -> "Tracer":
        """Bind to this node's postoffice; completed spans batch-ship to
        the global scheduler's collector (or straight into ``collector``
        when it lives on this very node)."""
        self._po = postoffice
        self._collector = collector
        return self

    def flush(self) -> int:
        """Ship every pending span to the collector; returns the count.
        Safe to call with nothing attached (spans just keep pending)."""
        with self._mu:
            if not self._pending or self._po is None:
                return 0
            batch, self._pending = self._pending, []
        body = {"node": self.node, "spans": batch,
                "offsets": self._po.clock_offsets()}
        if self._collector is not None:
            self._collector.ingest(body)
            return len(batch)
        from geomx_tpu_torch.kvstore.common import APP_PS, Ctrl
        from geomx_tpu_torch.transport.message import Domain, Message

        with _ctx.suppressed():  # trace traffic never traces itself
            try:
                self._po.van.send(Message(
                    recipient=self._po.topology.global_scheduler(),
                    domain=Domain.GLOBAL, app_id=APP_PS, customer_id=0,
                    request=True, cmd=int(Ctrl.TRACE_REPORT), body=body))
            except (KeyError, OSError):
                # collector down/unreachable: re-queue rather than lose
                # the batch (bounded by _cap like everything else)
                with self._mu:
                    self._pending = batch + self._pending
                    del self._pending[self._cap:]
                return 0
        return len(batch)

    def pending(self) -> int:
        with self._mu:
            return len(self._pending)

    def reset(self) -> None:
        """Drop unshipped spans (a fresh deployment reusing this node
        name must not inherit a previous run's leftovers — round-derived
        trace ids would collide across runs)."""
        with self._mu:
            self._pending.clear()


_tracers: Dict[str, Tracer] = {}
_mu = threading.Lock()


def recorded_spans() -> List[dict]:
    """Every node's recorded spans, from the node profilers' buffers:
    ``node``, ``thread`` (its name), ``native_tid`` and ``profiler_tid``
    (the ids a torch profiler trace may give the thread), ``name``,
    ``t0_ns`` and ``t1_ns`` (Unix nanoseconds, the torch profiler's host
    clock) and ``args`` (the span's counts and causal ids).  Instants
    and the profiler's own spans carry no such stamps and are left out."""
    with _mu:
        tracers = list(_tracers.values())
    out = []
    for tr in tracers:
        for ev in tr.profiler.events():
            a = ev.get("args")
            if not a or "unix_ns" not in a:
                continue
            t0, t1 = a["unix_ns"]
            out.append({"node": tr.node, "thread": ev["tid"],
                        "native_tid": a["native_tid"],
                        "profiler_tid": a["profiler_tid"],
                        "name": ev["name"], "t0_ns": t0, "t1_ns": t1,
                        "args": dict(a)})
    return out


def get_tracer(node: str) -> Tracer:
    with _mu:
        t = _tracers.get(node)
        if t is None:
            t = _tracers[node] = Tracer(node)
        return t
