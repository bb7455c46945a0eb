"""Per-node span recorder + batched reporter.

One ``Tracer`` per node (keyed like ``utils.get_profiler``).  Spans are
recorded as Chrome-trace events **into the node's existing Profiler
event buffer** (one buffer per node — the remote-profiler dump and the
distributed trace cannot drift apart), with the causal identity
(trace_id / span / parent) in ``args``.  A second reference to each
event dict sits in the tracer's pending batch until it is shipped to the
scheduler-side collector (``Ctrl.TRACE_REPORT``) — the dicts are shared,
never copied.

Timestamps: events carry the profiler-relative ``ts`` (so a per-node
``Profiler.dump`` stays coherent) plus an absolute ``t_mono_us`` in
``args`` — the collector merges on the monotonic clock, corrected by the
per-node offset estimated from heartbeat RTTs.

Overhead: ``span()`` / ``round()`` return the shared ``_NULL_SPAN``
whenever tracing is inactive or the current thread carries no sampled
context — no allocation, no branch beyond the gate, nothing stamped.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from geomx_tpu_torch.trace import context as _ctx
from geomx_tpu_torch.utils.profiler import Profiler, get_profiler


class _NullSpan:
    """Shared no-op span: the entire cost of an instrumented site when
    tracing is off (``tracer.span(...) is _NULL_SPAN``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "name", "cat", "_enter_ctx", "_prev", "span_id",
                 "parent", "trace_id", "_t0", "_t0_mono")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: int, parent: int):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.parent = parent
        self.span_id = _ctx.new_span_id()

    def __enter__(self):
        self._prev = _ctx.swap(_ctx.TraceContext(self.trace_id, self.span_id))
        self._t0 = time.perf_counter()
        self._t0_mono = time.monotonic()
        return self

    def __exit__(self, *exc):
        dur_us = (time.perf_counter() - self._t0) * 1e6
        _ctx.restore(self._prev)
        self._tr._record(self.name, self.cat, dur_us, self.trace_id,
                         self.span_id, self.parent, self._t0_mono)
        return False


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
        """Timed child span of the thread's current context (no-op when
        tracing is off or the context is unsampled)."""
        if not _ctx.ACTIVE:
            return _NULL_SPAN
        cur = _ctx.current()
        if cur is None:
            return _NULL_SPAN
        return _Span(self, name, cat, cur.trace_id, cur.span_id)

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


def get_tracer(node: str) -> Tracer:
    with _mu:
        t = _tracers.get(node)
        if t is None:
            t = _tracers[node] = Tracer(node)
        return t
