"""The port's program spans beside ``torch.profiler``'s trace.

- Clock: a span around a ``record_function`` mark holds the mark on the
  exported Chrome trace's timeline (``baseTimeNanoseconds`` + ``ts``) to
  within 20 µs at each end, on the profiling thread and on a second one
  (which records its spans because the profiler runs, with no sampled
  round open), and carries the native id the trace gives that thread.
- Off cost: with the torch profiler off and tracing inactive, every new
  span site is the shared ``_NULL_SPAN`` and a geo-round builds no span.
- Counts: a ``torch:cpu`` 2 × 2 + 1 geo-round under FSA and under HFA
  (k1 2) records the leaves' f32 bytes on ``worker.d2h`` and
  ``worker.h2d`` at every step and sync, one ``worker.grad`` a step, and
  one ``global.pull_serve`` for each (key, subscriber) response; under
  the threaded transport the merge lanes' work gets its own spans.
- Repairs: a handler span is written once when the node profiler and a
  span both record; HFA steps open the round's root span.
"""

import collections
import json
import threading
import time

import pytest
import torch

from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.kvstore.server import _lane_span
from geomx_tpu_torch.optim import local
from geomx_tpu_torch.trace import context as tctx
from geomx_tpu_torch.trace import recorded_spans, recorder
from geomx_tpu_torch.trace.collector import _stage_of
from geomx_tpu_torch.trace.recorder import _NULL_SPAN, Tracer, torch_profiling
from geomx_tpu_torch.training import run_worker, run_worker_hfa
from geomx_tpu_torch.utils.profiler import Profiler

SHAPES = {"a": (8,), "b": (6, 5), "c": (300,)}
LEAF_BYTES = 4 * sum(torch.Size(s).numel() for s in SHAPES.values())
STEPS = 4
PARTIES = WORKERS = 2


def _profile(all_threads: bool = False):
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], **kw)


@pytest.mark.parametrize("second_thread", [False, True],
                         ids=["same-thread", "second-thread"])
def test_span_holds_a_profiler_mark_on_the_trace_clock(tmp_path,
                                                        second_thread):
    tr = Tracer("clock-node", profiler=Profiler("clock-node"))
    seen = {}

    def body():
        with tr.span("clock.outer") as sp:
            seen["recording"] = sp.recording
            seen["native"] = threading.get_native_id()
            seen["ident"] = threading.get_ident()
            with torch.profiler.record_function("clock.mark"):
                time.sleep(0.005)

    assert not torch_profiling()
    with _profile(all_threads=second_thread) as prof:
        assert torch_profiling()
        if second_thread:
            t = threading.Thread(target=body)
            t.start()
            t.join(30)
        else:
            body()
    assert not torch_profiling()
    assert seen["recording"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    marks = [e for e in doc["traceEvents"] if e.get("name") == "clock.mark"]
    assert len(marks) == 1
    m0 = base + round(float(marks[0]["ts"]) * 1e3)
    m1 = m0 + round(float(marks[0]["dur"]) * 1e3)
    (ev,) = [e for e in tr.profiler.events() if e["name"] == "clock.outer"]
    s0, s1 = ev["args"]["unix_ns"]
    assert s0 <= m0 + 20_000, (s0 - m0) / 1e3
    assert s1 >= m1 - 20_000, (m1 - s1) / 1e3
    assert ev["args"]["trace_id"] == 0  # traceless: no sampled round
    # the profiler registered this thread: its events carry the OS id
    assert ev["args"]["native_tid"] == seen["native"] == marks[0]["tid"]
    # a thread it does not register: the low 32 bits of the pthread id
    # as a signed int, without its sign (as a CUDA trace shows them)
    low = seen["ident"] & 0xFFFFFFFF
    assert ev["args"]["profiler_tid"] == abs(low - (1 << 32)
                                             if low >= 1 << 31 else low)


def _grad_fn(params, x, y):
    zero = torch.zeros(())
    return zero, zero, {n: p * 0.25 + 1.0 for n, p in params.items()}


def _geo_round(loop: str, **cfg):
    """One 2 × 2 + 1 geo-round of ``STEPS`` steps on ``torch:cpu``."""
    config = Config(topology=Topology(num_parties=PARTIES,
                                      workers_per_party=WORKERS),
                    merge_backend="torch:cpu", use_hfa=loop == "hfa",
                    hfa_k1=2, hfa_k2=1, **cfg)
    sim = Simulation(config)
    errors = []

    def main(p, r):
        try:
            kv = sim.worker(p, r)
            if r == 0 and p == 0:
                kv.set_optimizer({"type": "sgd", "lr": 0.1})
            kv.barrier()
            params = {n: torch.ones(s) for n, s in SHAPES.items()}
            data = [(None, None)] * STEPS
            if loop == "hfa":
                run_worker_hfa(kv, params, _grad_fn, data, STEPS, k1=2,
                               optimizer=local.sgd(0.1))
            else:
                run_worker(kv, params, _grad_fn, data, STEPS)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=main, args=(p, r), daemon=True)
               for p in range(PARTIES) for r in range(WORKERS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads), "a worker hung"
        if errors:
            raise errors[0]
    finally:
        sim.shutdown()
    return sim


def test_new_span_sites_are_the_null_span_when_off(monkeypatch):
    """The guard of ``test_disabled_tracing_no_per_message_work``, for the
    spans that follow the torch profiler: with it off and tracing
    inactive, each new site is the shared no-op and no span is built."""
    monkeypatch.setattr(tctx, "ACTIVE", False)
    assert not torch_profiling()
    built = [0]
    init = recorder._Span.__init__

    def counting(self, *a, **kw):
        built[0] += 1
        init(self, *a, **kw)

    monkeypatch.setattr(recorder._Span, "__init__", counting)
    tr = Tracer("off-guard-node", profiler=Profiler("off-guard-node"))
    for name in ("worker.grad", "worker.d2h", "worker.h2d",
                 "global.pull_serve", "local.merge", "global.merge"):
        assert tr.span(name) is _NULL_SPAN
    assert not _NULL_SPAN.recording
    sim = _geo_round("fsa", transport="threads", server_shards=2)
    kv = sim.worker(0, 0)
    assert kv.span("worker.grad") is _NULL_SPAN
    for s in sim.local_servers + sim.global_servers:
        assert not s._shards.inline
        assert _lane_span(s._tr, s._shards, "local.merge") is _NULL_SPAN
    assert sim.global_servers[0]._tr.span("global.pull_serve") is _NULL_SPAN
    assert built[0] == 0
    assert tr.profiler.events() == []


def _spans_since(t0_ns):
    return [s for s in recorded_spans() if s["t0_ns"] >= t0_ns]


@pytest.mark.parametrize("loop,transport", [("fsa", "reactor"),
                                            ("hfa", "reactor"),
                                            ("fsa", "threads")])
def test_copy_bytes_and_pull_serves_are_counted(loop, transport):
    t0 = time.time_ns()
    cfg = {"transport": transport}
    if transport == "threads":
        cfg["server_shards"] = 2
    with _profile():
        sim = _geo_round(loop, **cfg)
    spans = _spans_since(t0)
    by = collections.defaultdict(list)
    for s in spans:
        by[s["name"]].append(s)
        assert s["t0_ns"] <= s["t1_ns"]
    n = PARTIES * WORKERS
    syncs = STEPS // 2 if loop == "hfa" else STEPS
    assert len(by["worker.grad"]) == n * STEPS
    for name in ("worker.d2h", "worker.h2d"):
        assert [s["args"]["bytes"] for s in by[name]] == [LEAF_BYTES] * (
            n * syncs), name
    workers = {str(sim.worker(p, r).po.node) for p in range(PARTIES)
               for r in range(WORKERS)}
    assert {s["node"] for s in by["worker.h2d"]} == workers
    # a pull serve is one (key, subscriber) response: every key of the
    # model, once a sync for each party's local server
    keys = collections.Counter(s["args"]["key"] for s in by["global.pull_serve"])
    assert len(keys) == len(SHAPES)
    assert set(keys.values()) == {PARTIES * syncs}
    assert sorted({s["args"]["bytes"] for s in by["global.pull_serve"]}) == \
        sorted(4 * torch.Size(s).numel() for s in SHAPES.values())
    if transport == "threads":
        for name in ("local.merge", "global.merge"):
            assert by[name], name
            assert all("-lane-" in s["thread"] for s in by[name])
    else:
        # reactor: lanes run inline, inside the handlers' spans
        assert not by["local.merge"] and not by["global.merge"]
    for s in spans:
        assert isinstance(s["native_tid"], int)
        assert isinstance(s["profiler_tid"], int)


def test_a_handler_span_is_written_once():
    prof = Profiler("once-node")
    prof.start()
    tr = Tracer("once-node", profiler=prof)
    with tr.handler_span("local.push"):
        pass  # the node profiler alone
    with _profile():
        with tr.handler_span("local.push"):
            pass  # the tracer's span, not both
    was = tctx.ACTIVE
    tctx.ACTIVE = True
    prev = tctx.swap(tctx.TraceContext(7, 11))
    try:
        with tr.handler_span("local.push"):
            pass  # a sampled round's span, not both
    finally:
        tctx.restore(prev)
        tctx.ACTIVE = was
    evs = [e for e in prof.events() if e["name"] == "local.push"]
    assert len(evs) == 3
    assert [e.get("args", {}).get("trace_id") for e in evs] == [None, 0, 7]


def test_hfa_steps_open_the_round_span():
    t0 = time.time_ns()
    _geo_round("hfa", trace_sample_every=1)
    spans = _spans_since(t0)
    roots = [s for s in spans if s["name"] == "round"
             and s["node"].startswith("worker")]
    assert len(roots) == PARTIES * WORKERS * STEPS
    assert all(s["args"]["trace_id"] > 0 for s in roots)
    root_ids = {s["args"]["span"] for s in roots}
    for name in ("worker.grad", "worker.push", "worker.d2h"):
        kids = [s for s in spans if s["name"] == name]
        assert kids and {s["args"]["parent"] for s in kids} <= root_ids, name


def test_collector_stages_of_the_new_spans():
    assert _stage_of("local.merge") == "local_merge"
    assert _stage_of("global.merge") == "global_merge"
    assert _stage_of("global.pull_serve") == "pull_fanout"
    for name in ("worker.grad", "worker.d2h", "worker.h2d"):
        assert _stage_of(name) is None
