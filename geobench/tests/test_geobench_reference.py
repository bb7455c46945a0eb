"""The plain reference against the port at tiny sizes on the CPU: the
model's loss and gradients, and the geo-round's readings for FSA under
MPQ and for HFA."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from geobench import check, traffic
from geobench.harness import run_cell
from geobench.reference import georound
from geobench.reference import transformer as ref_lm
from geobench.reference import weights
from geobench.tests import tiny

SEED = 2_147_483_659


def test_leaves_are_the_ports():
    from geomx_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)

    m = tiny.LM["model"]
    cfg = TransformerConfig(vocab=m["vocab"], d_model=m["d_model"],
                            n_heads=m["n_heads"], n_layers=m["n_layers"],
                            d_ff=m["d_ff"], max_seq=m["max_seq"])
    port = init_params(cfg, torch.Generator().manual_seed(0))
    assert [(n, tuple(t.shape)) for n, t in port.items()] == [
        (n, s) for n, s, _ in weights.transformer_leaves(m)]


def test_weights_repeat_from_the_seed():
    a = weights.make(tiny.LM, SEED, torch.device("cpu"))
    b = weights.make(tiny.LM, SEED, torch.device("cpu"))
    c = weights.make(tiny.LM, SEED + 1, torch.device("cpu"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed"], c["embed"])
    x1, _ = traffic.batch(tiny.LM["inputs"], 4, SEED, 1, 2)
    x2, _ = traffic.batch(tiny.LM["inputs"], 4, SEED, 1, 2)
    x3, _ = traffic.batch(tiny.LM["inputs"], 4, SEED, 2, 2)
    assert np.array_equal(x1, x2) and not np.array_equal(x1, x3)


def test_model_matches_the_port_in_f32():
    """The port's grad_fn in f32 (dense attention) against the
    reference's loss and gradients."""
    import copy

    from geobench.families import transformer as fam_lm

    cfg = copy.deepcopy(tiny.LM)
    cfg["model"]["compute_dtype"] = "float32"
    cfg["model"]["attn_impl"] = "dense"
    dev = torch.device("cpu")
    p = weights.make(cfg, SEED, dev)
    x, y = traffic.batch(cfg["inputs"], cfg["batch_per_worker"], SEED, 0, 0)
    loss, _acc, g = fam_lm.grad_fn(cfg, dev)(p, x, y)
    rl, rg = ref_lm.loss_and_grads(p, torch.as_tensor(x).long(),
                                   cfg["model"], rows=2)
    assert float(loss) == pytest.approx(rl, rel=1e-5)
    for n in p:
        assert torch.allclose(g[n], rg[n], rtol=1e-3, atol=1e-6), n


def _readings(cell, dev, seed=SEED):
    res = run_cell(cell, seed, 0.0, False, dev)
    return {"losses": res["readings"].losses,
            "grad_norms": res["readings"].grad_norms,
            "change": res["readings"].change,
                "first_grad": res["readings"].first_grad}


# MPQ with every key under its size bound: fp16 both ways, no sampled pull
EXACT = {"t-fsa-mpq": {"compression": {"type": "mpq", "size_bound": 10 ** 9,
                                       "ratio": 0.05, "momentum": 0.9}},
         "t-hfa": {}}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_georound_is_the_ports_arithmetic(name, tmp_path):
    """In f32, FSA with fp16 both ways and HFA follow the port to
    rounding: the same codes, merges, Adam steps and milestone deltas."""
    cell = tiny.cell(name, str(tmp_path), **EXACT[name])
    cell.config["model"]["compute_dtype"] = "float32"
    dev = torch.device("cpu")
    prog = _readings(cell, dev)
    ref = georound.run(cell.config, cell.cell, SEED, dev,
                       cell.cell["check_steps"])
    nums = check.compare(prog, ref)
    assert "change_gap_sampled" not in nums
    assert max(nums.values()) < 1e-4, nums


def test_georound_mpq_in_f32(tmp_path):
    """Under MPQ the first gradient (push: exact top-k with DGC, fp16
    small keys, global merge) repeats in f32; the losses of the later
    steps differ only by the pull's sampled threshold, whose sample the
    reference draws in its own order."""
    cell = tiny.cell("t-fsa-mpq", str(tmp_path))
    cell.config["model"]["compute_dtype"] = "float32"
    dev = torch.device("cpu")
    prog = _readings(cell, dev)
    ref = georound.run(cell.config, cell.cell, SEED, dev,
                       cell.cell["check_steps"])
    nums = check.compare(prog, ref)
    assert nums["grad_norm_gap"] < 1e-5 and nums["loss_gap"] < 1e-3, nums
    assert [row[0] for row in ref["losses"]][0] == pytest.approx(
        prog["losses"][0][0], rel=1e-5)


@pytest.mark.parametrize("name", ["t-fsa-mpq", "t-hfa"])
def test_georound_matches_the_port(name, tmp_path):
    """The harness's run of the port as configured (bf16 compute, flash
    on its plain version) against the float32 reference: every number
    within the tiny cell's limits."""
    cell = tiny.cell(name, str(tmp_path))
    dev = torch.device("cpu")
    prog = _readings(cell, dev)
    ref = georound.run(cell.config, cell.cell, SEED, dev,
                       cell.cell["check_steps"])
    nums = check.compare(prog, ref)
    assert check.judge(nums, cell.cell["limits"]), nums
    assert len(prog["change"]) == 4
