"""Trace context: the (trace_id, span_id) pair that rides every message.

The propagation model mirrors Dapper/OpenTelemetry trimmed to what the
HiPS tree needs (cf. the cross-host timeline the TensorFlow system paper
treats as prerequisite to optimizing its distributed runtime —
PAPERS.md):

- a **trace** is one sampled synchronization round; every worker derives
  the same ``trace_id`` from the round index, so the collector can merge
  all parties' spans of round N into one tree without coordination;
- a **span** is one timed region on one node (worker push issue, local
  merge, optimizer step, ...); its id is process-unique;
- the context travels (a) between threads of one node implicitly — a
  thread-local installed by the span that is currently open — and
  (b) between nodes explicitly as ``Message.trace_id`` /
  ``Message.span_id`` / ``Message.parent_span_id`` / ``Message.sampled``,
  stamped by ``Van.send`` from the sender's thread-local and re-installed
  around the receiver's handler by ``Customer``.

Overhead discipline: the whole subsystem hides behind the module-global
``ACTIVE`` flag (set once, when a role is constructed with
``Config.trace_sample_every > 0``).  Every hook on the message hot path
checks that single attribute before doing anything else, and the span
factory returns a shared no-op object when tracing is off or the current
round is unsampled — the disabled path allocates nothing per message.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Optional

# Single gate for every hot-path hook.  Flipped (never cleared) by
# activate(); reading one module attribute is the entire disabled cost.
ACTIVE = False

_tls = threading.local()

# span ids: process-unique, nonzero.  High bits are a per-process salt so
# two OS processes of one deployment cannot collide; low bits count.
# Salt is capped at 30 bits so salt<<32 | counter always fits the wire's
# SIGNED int64 header field (struct "q").
_SALT = ((int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF) | 1) << 32
_ids = itertools.count(1)


def activate() -> None:
    global ACTIVE
    ACTIVE = True


def new_span_id() -> int:
    return _SALT | next(_ids)


def trace_id_for_round(round_idx: int) -> int:
    """Deterministic nonzero trace id shared by every node for one
    sampled round — the cross-party merge key."""
    return int(round_idx) + 1


class TraceContext:
    """Immutable-by-convention (trace_id, span_id) the current thread is
    working under.  ``span_id`` is the id new child spans and outbound
    messages use as their parent."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def swap(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as the thread's context; returns the previous one
    (restore() it when the scope ends)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def restore(prev: Optional[TraceContext]) -> None:
    _tls.ctx = prev


class suppressed:
    """Scope with NO trace context — used around the tracer's own
    report shipping so trace traffic never traces itself."""

    def __enter__(self):
        self._prev = swap(None)
        return self

    def __exit__(self, *exc):
        restore(self._prev)
        return False
