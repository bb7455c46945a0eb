"""Reading a profiler trace: the device's intervals, their union, the
idle gaps and what the host was doing in them.

The harness exports ``torch.profiler``'s Chrome trace of a few steady
rounds and reads it back here; the per-layer metrics read the result.
Times are microseconds on the profiler's clock.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")
START_MARK = "geobench.traced_rounds.start"
END_MARK = "geobench.traced_rounds.end"


class Trace:
    """``device``: ``(name, cat, ts, dur)`` of every kernel, copy and
    memset inside the traced span; ``host``: the same of host events;
    ``span``: ``(t0, t1)`` between the harness's two marks; ``rounds``:
    the steps every worker took inside it."""

    def __init__(self, events: List[dict], rounds: int):
        marks = {e["name"]: float(e["ts"]) for e in events
                 if e.get("name") in (START_MARK, END_MARK)}
        if START_MARK not in marks or END_MARK not in marks:
            raise ValueError("the trace lacks the harness's span marks")
        self.span = (marks[START_MARK], marks[END_MARK])
        self.rounds = rounds
        t0, t1 = self.span
        self.device: List[Tuple[str, str, float, float]] = []
        self.host: List[Tuple[str, str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if ts + dur <= t0 or ts >= t1:
                continue
            row = (e.get("name", ""), e.get("cat", ""), ts, dur)
            if row[1] in DEVICE_CATS:
                self.device.append(row)
            elif row[1] in HOST_CATS and not row[0].startswith("geobench."):
                self.host.append(row)

    @classmethod
    def load(cls, path: str, rounds: int) -> "Trace":
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return cls(events, rounds)

    @property
    def window_us(self) -> float:
        return self.span[1] - self.span[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's intervals, clipped to the span."""
        t0, t1 = self.span
        ivs = sorted((max(ts, t0), min(ts + dur, t1))
                     for _, _, ts, dur in self.device)
        out: List[Tuple[float, float]] = []
        for a, b in ivs:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_us(self, match) -> float:
        """Summed device time of the events whose name ``match`` takes."""
        return sum(dur for name, _, _, dur in self.device if match(name))

    def count(self, match) -> int:
        return sum(1 for name, _, _, _ in self.device if match(name))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, _, _, dur in self.device:
            by[name] = by.get(name, 0.0) + dur
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between busy intervals inside the span,
        each named by the host event that overlaps it most."""
        t0, t1 = self.span
        busy = self.busy_intervals()
        gaps, prev = [], t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if t1 > prev:
            gaps.append((prev, t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_label(a, b), (b - a) / 1e6]
                for a, b in gaps[:n]]

    def _host_label(self, a: float, b: float) -> str:
        best: Optional[str] = None
        best_ov = 0.0
        for name, _, ts, dur in self.host:
            ov = min(b, ts + dur) - max(a, ts)
            if ov > best_ov:
                best, best_ov = name, ov
        return best if best is not None else "host (no traced op)"
