"""The trace reader and the per-layer metric readers on a small canned
profiler trace."""

from __future__ import annotations

import json

import pytest

from geobench.flops import codec, flash_attention
from geobench.flops.transformer import sample_flops as lm_flops
from geobench.spec import reader
from geobench.tests import tiny
from geobench.trace import END_MARK, START_MARK, Trace

PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _events(extra=()):
    return [
        _ev(START_MARK, "user_annotation", 1000.0, 0.0),
        _ev(END_MARK, "user_annotation", 2000.0, 0.0),
        # overlapping kernels: their union is 1100..1300
        _ev("void (anonymous namespace)::fwd_tc_kernel<64>(x)", "kernel",
            1100.0, 150.0),
        _ev("bwd_tc_kernel<64, 1, false>", "kernel", 1200.0, 100.0),
        _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1500.0, 100.0),
        _ev("void dgc_update<256>(float*)", "kernel", 1700.0, 20.0),
        _ev("void at::native::sbtopk::gatherTopK<float>", "kernel", 1720.0,
            30.0),
        # half outside the span: clipped to 1990..2000
        _ev("Memset (Device)", "gpu_memset", 1990.0, 50.0),
        # before the span: dropped
        _ev("gemm_early", "kernel", 100.0, 50.0),
        _ev("aten::copy_", "cpu_op", 1310.0, 150.0),
        _ev("cudaStreamSynchronize", "cuda_runtime", 1800.0, 150.0),
    ] + list(extra)


class _Run:
    def __init__(self, trace, cell, result, peaks=PEAKS):
        self.trace, self.cell, self.result, self.peaks = (trace, cell,
                                                          result, peaks)


def test_union_idle_and_gaps():
    tr = Trace(_events(), rounds=2)
    assert tr.window_us == 1000.0
    assert tr.busy_intervals() == [(1100.0, 1300.0), (1500.0, 1600.0),
                                   (1700.0, 1750.0), (1990.0, 2000.0)]
    assert tr.busy_us() == 360.0
    gaps = tr.idle_gaps(3)
    assert [g[1] for g in gaps] == [240e-6, 200e-6, 100e-6]
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[1][0] == "aten::copy_"
    top = tr.top_ops(2)
    assert top[0][0].startswith("void (anonymous namespace)::fwd_tc")
    assert top[0][1] == 150e-6


def test_idle_is_a_union_not_a_sum(tmp_path):
    cell = tiny.cell("t-fsa-mpq", str(tmp_path))
    tr = Trace(_events(), rounds=2)
    got = reader("device_idle_pct").read(_Run(tr, cell, {}))
    assert got == pytest.approx(64.0)


def test_codec_ms_groups_dgc_and_topk(tmp_path):
    cell = tiny.cell("t-fsa-mpq", str(tmp_path))
    tr = Trace(_events(), rounds=2)
    got = reader("codec_ms_per_step").read(_Run(tr, cell, {}))
    assert got == pytest.approx((20.0 + 30.0) / 1e3 / 2)


def test_trace_needs_its_marks():
    with pytest.raises(ValueError):
        Trace([_ev("k", "kernel", 0.0, 1.0)], rounds=1)


def test_trace_loads_a_chrome_file(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    assert Trace.load(str(p), 2).busy_us() == 360.0


def test_flash_roofline_counts_calls_or_says_nothing(tmp_path):
    cell = tiny.cell("t-fsa-mpq", str(tmp_path))
    m = cell.config["model"]
    n_workers, rounds = 4, 1
    calls = rounds * n_workers * m["n_layers"]
    extra = [_ev("fwd_tc_kernel<32>", "kernel", 1300.0 + i, 1.0)
             for i in range(calls - 1)]
    run = _Run(Trace(_events(extra), rounds=rounds), cell,
               {"n_workers": n_workers})
    c = flash_attention.costs(cell.batch, m["max_seq"], m["n_heads"],
                              m["d_model"] // m["n_heads"])
    least = sum(max(o / PEAKS["bf16_flops"], b / PEAKS["hbm_bytes_per_s"])
                for o, b in c.values()) * calls
    device_s = (150.0 + 100.0 + calls - 1) / 1e6
    assert reader("flash_roofline").read(run) == pytest.approx(
        100 * least / device_s)
    short = _Run(Trace(_events(extra[1:]), rounds=rounds), cell,
                 {"n_workers": n_workers})
    assert reader("flash_roofline").read(short) is None
    assert reader("flash_roofline").read(_Run(None, cell, {})) is None


def test_codec_roofline_needs_one_launch_a_key_and_party(tmp_path):
    from math import prod

    from geobench.reference.weights import leaves

    cell = tiny.cell("t-fsa-mpq", str(tmp_path))
    sizes = [prod(s) for _, s, _ in leaves(cell.config)]
    bsc = [n for n in sizes if n >= 1000]
    launches = [_ev("void dgc_update<256>(float*)", "kernel",
                    1760.0 + i * 0.1, 0.1) for i in range(2 * len(bsc) - 1)]
    run = _Run(Trace(_events(launches), rounds=1), cell, {})
    need = 2 * sum(codec.nbytes("dgc_update", n) for n in bsc)
    us = 20.0 + 0.1 * (2 * len(bsc) - 1)
    assert reader("codec_roofline").read(run) == pytest.approx(
        100 * need / PEAKS["hbm_bytes_per_s"] / (us / 1e6))
    fewer = _Run(Trace(_events(launches[1:]), rounds=1), cell, {})
    assert reader("codec_roofline").read(fewer) is None


def test_window_readers(tmp_path):
    cell = tiny.cell("t-fsa-mpq", str(tmp_path))
    res = {"phases": {"grad": [0.1, 0.3], "push": [0.01], "pull_wait":
                      [0.03, 0.04]},
           "worker_steps": 2, "rounds": 2, "server_bytes": 4e6,
           "samples": 100, "seconds": 2.0}
    run = _Run(None, cell, res)
    assert reader("grad_ms").read(run) == pytest.approx(200.0)
    assert reader("sync_wait_ms").read(run) == pytest.approx(40.0)
    assert reader("server_pcie_mb_per_step").read(run) == pytest.approx(2.0)
    assert reader("mfu_pct").read(run) == pytest.approx(
        100 * lm_flops(cell.config["model"]) * 100 / (2.0 * 989e12))
    assert reader("device_idle_pct").read(run) is None
    assert reader("mfu_pct").read(_Run(None, cell, res, peaks=None)) is None
    hfa = tiny.cell("t-hfa", str(tmp_path))
    assert reader("grad_ms").read(_Run(None, hfa, res)) is None


def test_flop_counts():
    gpt2 = {"vocab": 50257, "d_model": 768, "n_heads": 12, "n_layers": 12,
            "d_ff": 3072, "max_seq": 1024}
    # 6 N T with N = 85 M in the blocks + 38.6 M in the tied head, plus
    # causal attention: about 0.82 TFLOP a sequence
    assert lm_flops(gpt2) == pytest.approx(8.18e11, rel=0.01)
