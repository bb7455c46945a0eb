"""The port's CNN example takes the JAX example's flags (CPU).

- Every option of the JAX package's ``examples/cnn.py`` is an option of
  ``geomx_tpu_torch.examples.cnn`` (``--model`` offers the port's
  registry), and each flag set gives the port's ``Simulation`` the same
  ``Config`` fields as the JAX example gives its own (both captured at
  the ``Simulation`` call, before anything runs).
- Each of the nine presets (``examples/cnn_<feature>.py`` on
  ``examples/_wrapper.py``) gives the same ``Config`` fields as its
  port counterpart ``geomx_tpu_torch.examples.cnn_<feature>``.
- ``--device cpu`` runs of 2 steps (or rounds) of the full-width CNN
  under ``--hfa`` (k1 = 1, so the second sync crosses the WAN and the
  global server adds the milestone delta on its device), ``--esync``, ``--p3``, ``--tsengine``, ``--sync mixed
  --optimizer dcasgd``, ``--record`` (written on first use) and
  ``--mnist`` (small idx files written here; the held-out accuracy is
  printed from the t10k files): finite losses, every worker's steps,
  final weights of the full width.
"""

import argparse
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest

import geomx_tpu_torch.kvstore as port_kvstore
from geomx_tpu_torch.data import MNISTIter
from geomx_tpu_torch.examples import cnn

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("sync_global_mode", "compression", "bsc_ratio", "use_hfa",
          "hfa_k2", "enable_p3", "p3_slice_elems", "enable_intra_ts",
          "enable_inter_ts", "enable_inter_ts_push", "enable_dgt")


class _Stop(Exception):
    def __init__(self, what):
        self.what = what


def _raise_stop(*args, **kw):
    raise _Stop(args[0] if args else kw)


@pytest.fixture(scope="module")
def jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_examples_cnn", ROOT / "examples" / "cnn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_config(mod, flags, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["cnn.py", *flags])
    monkeypatch.setattr(mod, "Simulation", _raise_stop)
    with pytest.raises(_Stop) as stop:
        mod.main()
    return stop.value.what


def _port_config(flags, monkeypatch):
    monkeypatch.setattr(port_kvstore, "Simulation", _raise_stop)
    args = cnn.build_parser().parse_args([*flags, "--device", "cpu"])
    with pytest.raises(_Stop) as stop:
        cnn.train(args, log=lambda msg: None)
    return stop.value.what


def _view(cfg):
    t = cfg.topology
    return ({f: getattr(cfg, f) for f in FIELDS},
            (t.num_parties, t.workers_per_party, t.num_global_servers))


def test_port_takes_every_option_of_the_jax_example(jax_example,
                                                    monkeypatch):
    monkeypatch.setattr(sys, "argv", ["cnn.py"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, *a, **k: _raise_stop(self))
    with pytest.raises(_Stop) as stop:
        jax_example.main()
    monkeypatch.undo()
    jax_opts = {a.dest: a for a in stop.value.what._actions}
    port_opts = {a.dest: a for a in cnn.build_parser()._actions}
    assert set(jax_opts) <= set(port_opts)
    for dest, a in jax_opts.items():
        b = port_opts[dest]
        assert a.option_strings == b.option_strings, dest
        if dest == "model":
            # the port's registry holds the JAX package's six families
            assert sorted(b.choices) == sorted(a.choices)
        elif a.choices is not None:
            assert set(a.choices) <= set(b.choices), dest
        else:
            assert a.default == b.default, dest


FLAG_SETS = [
    [],
    ["--sync", "mixed", "--optimizer", "dcasgd"],
    ["--p3"],
    ["--tsengine"],
    ["--tsengine-inter"],
    ["--tsengine-inter-push"],
    ["--dgt", "3"],
    ["--hfa", "--hfa-k1", "3", "--hfa-k2", "4"],
    ["--esync"],
    ["--compression", "bsc", "--bsc-ratio", "0.05", "--parties", "3",
     "--workers", "1", "--global-servers", "2"],
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f) or
                         "defaults")
def test_flags_set_the_jax_examples_config_fields(jax_example, monkeypatch,
                                                  flags):
    want = _view(_jax_config(jax_example, flags, monkeypatch))
    got = _view(_port_config(flags, monkeypatch))
    assert got == want


PRESETS = ("bsc", "dgt", "esync", "fp16", "hfa", "mixed_sync", "mpq", "p3",
           "tsengine")


@pytest.mark.parametrize("name", PRESETS)
def test_preset_gives_the_jax_presets_config(jax_example, monkeypatch,
                                             name):
    """The JAX preset (run as a script: its ``_wrapper`` imports ``cnn``
    from its directory, here the JAX example with ``Simulation``
    patched) and the port's preset on the CPU give equal fields."""
    import runpy

    from geomx_tpu_torch.examples import _wrapper

    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setitem(sys.modules, "cnn", jax_example)
    monkeypatch.delitem(sys.modules, "_wrapper", raising=False)
    monkeypatch.setattr(sys, "argv", [f"cnn_{name}.py"])
    monkeypatch.setattr(jax_example, "Simulation", _raise_stop)
    with pytest.raises(_Stop) as stop:
        runpy.run_path(str(ROOT / "examples" / f"cnn_{name}.py"),
                       run_name="__main__")
    monkeypatch.delitem(sys.modules, "_wrapper", raising=False)
    want = _view(stop.value.what)

    preset = importlib.import_module(f"geomx_tpu_torch.examples.cnn_{name}")
    monkeypatch.setattr(port_kvstore, "Simulation", _raise_stop)
    with pytest.raises(_Stop) as stop:
        _wrapper.run(preset.FLAGS, ["--device", "cpu"])
    assert _view(stop.value.what) == want
    assert want != _view(_jax_config(jax_example, [], monkeypatch)), \
        f"cnn_{name} sets no field the comparison sees"


def _write_mnist(root: Path, split: str, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    MNISTIter.write_idx(str(root / f"{split}-images-idx3-ubyte"),
                        rng.integers(0, 256, (n, 28, 28)).astype(np.uint8))
    MNISTIter.write_idx(str(root / f"{split}-labels-idx1-ubyte"),
                        rng.integers(0, 10, n).astype(np.uint8))


@pytest.mark.parametrize("flags", [
    ["--hfa", "--hfa-k1", "1"], ["--esync"], ["--p3"], ["--tsengine"],
    ["--sync", "mixed", "--optimizer", "dcasgd"], ["--record"],
    ["--mnist"]], ids=lambda f: " ".join(f))
def test_two_step_runs_on_the_cpu(tmp_path, flags):
    extra = []
    if flags == ["--record"]:
        extra = [str(tmp_path / "train.rec")]
    elif flags == ["--mnist"]:
        _write_mnist(tmp_path, "train", 256, 0)
        _write_mnist(tmp_path, "t10k", 64, 1)
        extra = [str(tmp_path)]
    args = cnn.build_parser().parse_args(
        [*flags, *extra, "--steps", "2", "--batch", "16", "--device",
         "cpu"])
    out = cnn.train(args, log=lambda msg: None)
    hist = out["histories"]
    assert len(hist) == 4
    assert all(len(h) >= 2 for h in hist.values())
    assert all(math.isfinite(l) for h in hist.values() for l, _ in h)
    assert sum(t.numel() for t in out["params"].values()) == 429_258
    if flags == ["--record"]:
        assert (tmp_path / "train.rec").exists()
    if flags == ["--mnist"]:
        assert 0.0 <= out["t10k_accuracy"] <= 1.0
    if "--hfa" in flags or "--esync" in flags:
        stats = out["sim_stats"]["global"][0]
        assert stats["merge_backend"] == "torch"
        assert stats["opt_device_ms"] > 0      # the milestone delta added
