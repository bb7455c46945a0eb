"""The correctness check has to fail what it exists to catch.

- The control: the reference with fp8 products put in the program's
  place, and each fault planted in the reference, read against the
  float32 reference, at a tiny size: every one fails the tiny cell's
  limits.
- A whole run (everything but the look for a card) with the program
  broken underneath: a step that returns its state unchanged, half of
  each batch left out, the exchange between workers and parties left
  out, a gradient altered where it is produced.  ``correct`` comes out
  false for each.
"""

from __future__ import annotations

import argparse
import json

import pytest
import torch

from geobench import check
from geobench.reference import georound
from geobench.tests import tiny

SEED = 2_147_483_711


def _as_prog(ref):
    n = len(ref["change_norms"])
    return {"losses": {w: [row[w] for row in ref["losses"]]
                       for w in range(n)},
            "grad_norms": ref["grad_norms"],
            "change": dict(enumerate(ref["change_norms"])),
            "first_grad": ref["first_grad"]}


@pytest.mark.parametrize("variant", [("fp8", None)] + [
    ("f32", f) for f in georound.FAULTS], ids=lambda v: v[1] or v[0])
@pytest.mark.parametrize("name", ["t-fsa-mpq", "t-hfa"])
def test_control_fails(name, variant, tmp_path):
    cell = tiny.cell(name, str(tmp_path))
    dev = torch.device("cpu")
    S = cell.cell["check_steps"]
    ref = georound.run(cell.config, cell.cell, SEED, dev, S)
    got = georound.run(cell.config, cell.cell, SEED, dev, S,
                       precision=variant[0], fault=variant[1])
    nums = check.compare(_as_prog(got), ref)
    assert not check.judge(nums, cell.cell["limits"]), nums


def test_change_gap_reads_the_exact_pull_apart(tmp_path):
    """Under MPQ the leaves pulled exactly (fp16) have a number of their
    own, so a fault on them is not lost among the leaves of the sampled
    pull: one fp16 leaf left unmoved reads 1 on ``change_gap``."""
    cell = tiny.cell("t-fsa-mpq", str(tmp_path))
    ref = georound.run(cell.config, cell.cell, SEED, torch.device("cpu"),
                       cell.cell["check_steps"])
    leaves = set(ref["change_norms"][0])
    assert ref["sampled"] and set(ref["sampled"]) < leaves
    prog = _as_prog(ref)
    assert check.compare(prog, ref)["change_gap"] == 0
    exact = sorted(leaves - set(ref["sampled"]))
    big = max(exact, key=lambda n: ref["change_norms"][0][n])
    prog["change"] = {w: {**c, big: 0.0} for w, c in prog["change"].items()}
    nums = check.compare(prog, ref)
    assert nums["change_gap"] == pytest.approx(1.0)
    assert nums["change_gap_sampled"] == 0
    assert not check.judge(nums, cell.cell["limits"])


def test_judge_wants_a_limit_for_each_number():
    nums = {"loss_gap": 0.0, "grad_norm_gap": 0.0, "change_gap": 0.0,
            "grad_diff": 0.0}
    limits = dict.fromkeys(nums, 1.0)
    assert check.judge(nums, limits)
    assert not check.judge(nums, {**limits, "change_gap_sampled": 1.0})
    assert not check.judge({**nums, "change_gap_sampled": 0.0}, limits)
    assert not check.judge({**nums, "loss_gap": 1.5}, limits)


def _unchanged_adam(monkeypatch):
    from geomx_tpu_torch.kvstore import torch_backend

    monkeypatch.setattr(torch_backend.DeviceAdam, "_update",
                        lambda self, k, w, g, scale: w.clone())


def _unchanged_local(monkeypatch):
    from geomx_tpu_torch.optim import local

    monkeypatch.setattr(local, "apply_updates",
                        lambda params, updates: params)


def _half_batch(monkeypatch):
    from geomx_tpu_torch.models import transformer

    orig = transformer.token_cross_entropy

    def half(logits, tokens):
        b = logits.shape[0] // 2
        return orig(logits[:b], tokens[:b])

    monkeypatch.setattr(transformer, "token_cross_entropy", half)


def _no_exchange(monkeypatch):
    from geomx_tpu_torch.kvstore import torch_backend

    monkeypatch.setattr(torch_backend.TorchBackend, "accumulate",
                        lambda self, acc, v: acc)


def _altered_gradient(monkeypatch):
    from geomx_tpu_torch.models import transformer

    orig = transformer.make_lm_grad_fn

    def make(cfg, mesh=None):
        fn = orig(cfg, mesh)

        def grad_fn(params, x, y=None):
            loss, acc, grads = fn(params, x, y)
            grads = dict(grads)
            grads["embed"] = grads["embed"] * 2.0
            return loss, acc, grads
        return grad_fn

    monkeypatch.setattr(transformer, "make_lm_grad_fn", make)


FAULTS = {
    "t-fsa-mpq": {"unchanged": _unchanged_adam, "half_batch": _half_batch,
                  "no_exchange": _no_exchange,
                  "altered_gradient": _altered_gradient},
    "t-hfa": {"unchanged": _unchanged_local, "half_batch": _half_batch,
              "no_exchange": _no_exchange,
              "altered_gradient": _altered_gradient},
}


def _run(name, tmp_path, capsys):
    from geobench import run as run_mod

    root = tiny.write(str(tmp_path))
    args = argparse.Namespace(workload=name, seed=SEED, seconds=0.5,
                              trace=0)
    assert run_mod.run(args, torch.device("cpu"), root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["t-fsa-mpq", "t-hfa"])
def test_a_sound_run_is_correct(name, tmp_path, capsys):
    line = _run(name, tmp_path, capsys)
    assert line["correct"] is True, line["check"]
    assert list(line)[-1] == "check"
    assert set(line["metrics"]) == {"samples_per_s", "step_p90_ms",
                                    "wan_bytes_per_sample", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange",
                                   "altered_gradient"])
@pytest.mark.parametrize("name", ["t-fsa-mpq", "t-hfa"])
def test_a_broken_program_is_not_correct(name, fault, tmp_path, capsys,
                                         monkeypatch):
    FAULTS[name][fault](monkeypatch)
    line = _run(name, tmp_path, capsys)
    assert line["correct"] is False, line["check"]
