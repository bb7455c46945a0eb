"""The manifest against the benchmark's contract: names, units, keys,
limits, the cells' files and readers, and which cell reports what."""

from __future__ import annotations

import json
import os
import re

import pytest

from geobench import check
from geobench.spec import NAME, UNIT

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATHCH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_size(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51


def test_command_and_paths(man):
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATHCH.match(p) and ".." not in p.split("/")
        assert not p.startswith("/") and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(REPO, p))
    assert 1 <= len(man["command"]) <= 32
    for w in man["command"]:
        assert TEXT.match(w) and not w.startswith("/")
        assert ".." not in w.split("/")
    files = [w for w in man["command"] if "/" in w]
    for w in files:
        assert any(w.startswith(p + "/") for p in man["paths"]), w


def test_names_units_and_text(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert TEXT.match(e[k]), (e["name"], k)
            if "layer" in e:
                assert TEXT.match(e["layer"])
    metrics = [n for is_metric, n in names if is_metric]
    assert len(metrics) == len(set(metrics))
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in man[group]]
        assert len(ns) == len(set(ns))


def test_entry_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not (k.endswith("_dim") or k.endswith("_rank"))
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_counts_and_chips(man):
    assert 1 <= len(man["configs"]) <= 24
    assert 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_enough(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        got = [m for m in man["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in {m["name"] for m in got}
        assert len(got) >= 2
        assert any(_reports(m, w["name"]) for m in man["per_layer"])
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in
                                        man["workloads"]]):
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in man["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_cells_files_and_readers_exist(man):
    for c in man["configs"]:
        path = os.path.join(REPO, c["file"])
        assert os.path.isfile(path)
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        with open(path) as f:
            cfg = json.load(f)
        assert os.path.isfile(os.path.join(REPO, "geobench", "families",
                                           f"{cfg['family']}.py"))
        assert os.path.isfile(os.path.join(REPO, "geobench", "flops",
                                           f"{cfg['family']}.py"))
        assert set(c["reduced"]) <= set(cfg.get("reduced", []))
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for w in man["workloads"]:
        path = os.path.join(REPO, "geobench", "workloads",
                            f"{w['name']}.json")
        with open(path) as f:
            cell = json.load(f)
        assert set(cell["limits"]) <= set(check.NUMBERS)
        assert set(check.NUMBERS) - set(cell["limits"]) <= {
            "change_gap_sampled"}
    for m in man["per_layer"]:
        assert os.path.isfile(os.path.join(REPO, "geobench", "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_shares_are_named_as_the_contract_asks(man):
    for m in man["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    kernels = [m for m in man["per_layer"] if m["layer"] == "kernels"]
    assert kernels and any("mfu" in m["name"] for m in man["per_layer"])
