"""The program-span readers on a hand-built trace file and span list:
the spans placed by the file's ``baseTimeNanoseconds``, cut to the
traced span, and the interval logic of ``ps_idle_pct``."""

from __future__ import annotations

import json

import pytest

import geomx_tpu_torch.trace as port_trace
from geobench import program_spans as ps
from geobench.spec import reader
from geobench.trace import END_MARK, START_MARK, Trace

BASE = 1_790_000_000_000_000_000
NEW = ("model_step_ms", "worker_copy_ms", "worker_pcie_mb_per_step",
       "pull_serve_ms", "ps_idle_pct")


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _span(name, t0_us, t1_us, node="worker:0@p0", tid=11, **args):
    return {"node": node, "thread": "w", "native_tid": tid,
            "profiler_tid": tid << 20, "name": name,
            "t0_ns": BASE + int(t0_us * 1e3), "t1_ns": BASE + int(t1_us * 1e3),
            "args": args}


# The traced span is 1000..2000 µs; the device is busy 1100..1300 and
# 1500..1600 (idle 700 µs of the 1000).
EVENTS = [
    _ev(START_MARK, "user_annotation", 1000.0, 0.0),
    _ev(END_MARK, "user_annotation", 2000.0, 0.0),
    _ev("gemm", "kernel", 1100.0, 200.0),
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1500.0, 100.0),
]

SPANS = [
    # two worker-steps of two workers (rounds 2, workers 2 → 4)
    _span("worker.grad", 1050, 1150),
    _span("worker.grad", 1200, 1400, tid=12),
    _span("worker.grad", 1450, 1500),
    _span("worker.grad", 1600, 1650, tid=12),
    _span("worker.d2h", 1150, 1200, bytes=400_000),
    _span("worker.h2d", 1400, 1450, bytes=600_000),
    _span("worker.d2h", 1650, 1700, tid=12, bytes=400_000),
    _span("worker.h2d", 1700, 1760, tid=12, bytes=600_000),
    # server spans: 1250..1450 (overlaps busy 1250..1300, idle
    # 1300..1450 = 150) and 1550..1700 nested with a codec span
    # (idle 1600..1700 = 100): 250 µs idle under a server span
    _span("local.push", 1250, 1450, node="local_server:0@p0", tid=21),
    _span("global.pull_serve", 1550, 1700, node="global_server:0", tid=31,
          key=0, bytes=8),
    _span("codec.encode", 1560, 1690, node="global_server:0", tid=31),
    # worker-side PS spans are not the server's
    _span("worker.pull", 1800, 1900),
    # before the traced span: left out; across its end: cut at 2000
    _span("worker.grad", 900, 990),
    _span("global.pull_serve", 1950, 2100, node="global_server:0", tid=31,
          key=1, bytes=8),
]


class _Run:
    def __init__(self, trace, result):
        self.trace, self.result = trace, result
        self.cell = self.peaks = None


@pytest.fixture
def run(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"schemaVersion": 1,
                                "baseTimeNanoseconds": BASE,
                                "traceEvents": EVENTS}, indent=1))
    monkeypatch.setattr(port_trace, "recorded_spans", lambda: list(SPANS))
    return _Run(Trace.load(str(path), rounds=2),
                {"trace_path": str(path), "n_workers": 2})


def test_spans_are_placed_and_cut(run):
    sp = ps.spans(run)
    assert ps.spans(run) is sp  # read once a run
    assert len(sp) == len(SPANS) - 1
    grad = ps.named(sp, "worker.grad")
    assert [(s.t0, s.t1) for s in grad][:2] == [(1050.0, 1150.0),
                                                 (1200.0, 1400.0)]
    last = ps.named(sp, "global.pull_serve")[-1]
    assert (last.t0, last.t1, last.args["key"]) == (1950.0, 2000.0, 1)
    assert grad[0].native_tid == 11 and grad[0].node == "worker:0@p0"
    assert grad[0].profiler_tid == 11 << 20


def test_the_five_readers(run):
    got = {m: reader(m).read(run) for m in NEW}
    assert got["model_step_ms"] == pytest.approx((100 + 200 + 50 + 50)
                                                 / 4 / 1e3)
    assert got["worker_copy_ms"] == pytest.approx((50 + 50 + 50 + 60)
                                                  / 4 / 1e3)
    assert got["worker_pcie_mb_per_step"] == pytest.approx(2e6 / 4 / 1e6)
    assert got["pull_serve_ms"] == pytest.approx((150 + 50) / 2 / 1e3)
    # idle under a server span: 150 + 100 + the cut serve's 1950..2000
    assert got["ps_idle_pct"] == pytest.approx(100 * (150 + 100 + 50)
                                               / 1000)
    device_idle = reader("device_idle_pct").read(run)
    assert device_idle == pytest.approx(70.0)
    assert got["ps_idle_pct"] <= device_idle


def test_interval_helpers():
    assert ps.union([(5, 6), (1, 3), (2, 4), (7, 7)]) == [(1, 4), (5, 6)]
    assert ps.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert ps.overlap_us([(0, 1)], [(1, 2)]) == 0


def test_idle_intervals_are_the_busy_complement(run):
    assert ps.idle_intervals(run.trace) == [(1000.0, 1100.0),
                                            (1300.0, 1500.0),
                                            (1600.0, 2000.0)]


def test_the_base_is_read_from_the_file(tmp_path):
    head = tmp_path / "a.json"
    head.write_text('{\n "baseTimeNanoseconds": 42,\n "traceEvents": []}')
    assert ps.base_ns(str(head)) == 42
    bare = tmp_path / "b.json"
    bare.write_text(json.dumps({"traceEvents": []}))
    assert ps.base_ns(str(bare)) == 0


def test_nothing_to_read_says_nothing(run, monkeypatch):
    monkeypatch.setattr(port_trace, "recorded_spans", lambda: [])
    for m in NEW:
        assert reader(m).read(run) is None, m
    fresh = _Run(run.trace, run.result)
    monkeypatch.delattr(port_trace, "recorded_spans")
    for m in NEW:  # a program with no span reader, as before its spans
        assert reader(m).read(fresh) is None, m
    assert ps.spans(_Run(None, {})) is None
