"""The port's own spans, on the time base of :mod:`geobench.trace`.

While ``torch.profiler`` records, the port records spans of its own
(``geomx_tpu_torch.trace``): the worker's model step (``worker.grad``)
and its copies to and from the host (``worker.d2h``, ``worker.h2d``,
each with its ``bytes``), the PS runtime's handlers (``local.*``,
``global.*``), its pull serving (``global.pull_serve``, with ``key`` and
``bytes``) and its codec stages (``codec.*``).  Each is stamped in Unix
nanoseconds on the profiler's host clock; a Chrome trace's ``ts`` is
microseconds after the file's ``baseTimeNanoseconds``, so that one
number places the spans beside the device's events.

A program that records no such spans (a port without its span reader)
gives None, and the readers that need spans say nothing.
"""

from __future__ import annotations

import json
import re
from typing import List, NamedTuple, Optional, Tuple

SERVER_PREFIXES = ("local.", "global.", "codec.")
_BASE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


class Span(NamedTuple):
    node: str
    thread: str
    native_tid: int
    profiler_tid: int
    name: str
    t0: float   # µs on the trace's time base
    t1: float
    args: dict

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def base_ns(path: str) -> int:
    """The trace file's ``baseTimeNanoseconds`` (0 where it has none:
    its ``ts`` are then Unix microseconds)."""
    with open(path, "rb") as f:
        m = _BASE.search(f.read(1 << 16))
    if m:
        return int(m.group(1))
    with open(path) as f:
        doc = json.load(f)
    return int(doc.get("baseTimeNanoseconds", 0)) if isinstance(doc, dict) \
        else 0


def place(recorded: List[dict], base: int) -> List[Span]:
    """``geomx_tpu_torch.trace.recorded_spans()`` on the trace's base."""
    return [Span(s["node"], s["thread"], int(s["native_tid"]),
                 int(s["profiler_tid"]), s["name"],
                 (s["t0_ns"] - base) / 1e3, (s["t1_ns"] - base) / 1e3,
                 s.get("args") or {})
            for s in recorded]


def spans(run) -> Optional[List[Span]]:
    """The program's spans that start inside the traced span, each cut
    at its end; None where the run has no trace or the program records
    no spans.  Read once a run."""
    if hasattr(run, "_program_spans"):
        return run._program_spans
    out = None
    tr, path = run.trace, (run.result or {}).get("trace_path")
    if tr is not None and path:
        try:
            from geomx_tpu_torch.trace import recorded_spans
        except ImportError:
            recorded_spans = None
        if recorded_spans is not None:
            t0, t1 = tr.span
            out = [s._replace(t1=min(s.t1, t1))
                   for s in place(recorded_spans(), base_ns(path))
                   if t0 <= s.t0 < t1] or None
    run._program_spans = out
    return out


def named(sp: List[Span], *names: str) -> List[Span]:
    return [s for s in sp if s.name in names]


def worker_steps(run) -> int:
    return int(run.trace.rounds) * int(run.result["n_workers"])


def union(ivs) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_us(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The traced span less the device's busy intervals (kernels,
    copies, memsets)."""
    t0, t1 = trace.span
    out, prev = [], t0
    for a, b in trace.busy_intervals():
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        out.append((prev, t1))
    return out
