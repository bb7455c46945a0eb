"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU.

- every module of ``geomx_tpu_torch`` (the static checkers of
  ``analysis/`` among them) and ``chip_smoke.py`` import in a fresh
  interpreter without pulling ``jax``, ``flax``, ``optax``, ``msgpack`` or
  ``geomx_tpu`` (the top-level name) into ``sys.modules`` (the machine
  with the card has no ``flax``, ``optax`` or ``msgpack``);
- no source file of the package imports from ``geomx_tpu``;
- with CUDA absent, every entry point raises unless ``device="cpu"``.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "geomx_tpu_torch"


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "geomx_tpu_torch.kvstore.torch_backend" in mods
    assert "geomx_tpu_torch.analysis" in mods
    assert "geomx_tpu_torch.analysis.__main__" in mods
    # only what the port's imports bring in counts: a site customization
    # may have imported jax before the first line runs
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m in ('jax', 'flax', 'optax', 'msgpack',\n"
        "                      'geomx_tpu')\n"
        "             or m.startswith(('jax.', 'geomx_tpu.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_no_source_file_imports_the_jax_package():
    bad = []
    for p in PKG.rglob("*.py"):
        text = p.read_text()
        for pat in ("from geomx_tpu.", "import geomx_tpu.",
                    "from geomx_tpu import", "import jax", "from jax"):
            if pat in text:
                bad.append((str(p.relative_to(ROOT)), pat))
    assert not bad, bad


def test_chip_smoke_imports_without_jax_or_the_jax_package():
    """``chip_smoke.py`` (imported, not run) and the static checkers'
    CLI pull in nothing of JAX or of the JAX package."""
    text = (ROOT / "chip_smoke.py").read_text()
    for pat in ("from geomx_tpu.", "import geomx_tpu.",
                "from geomx_tpu import", "import jax", "from jax"):
        assert pat not in text, pat
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import chip_smoke\n"
        "from geomx_tpu_torch.analysis.__main__ import main\n"
        "assert main(['--list']) == 0\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m in ('jax', 'flax', 'optax', 'geomx_tpu')\n"
        "             or m.startswith(('jax.', 'geomx_tpu.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "lock-discipline" in out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GEOMX_MERGE_BACKEND", raising=False)


def test_entry_points_raise_without_cuda_unless_cpu(no_cuda):
    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.examples.cnn import main
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.kvstore.torch_backend import TorchBackend
    from geomx_tpu_torch.models import create_model_state
    from geomx_tpu_torch.models.cnn import create_cnn_state
    from geomx_tpu_torch.models.transformer import (TransformerConfig,
                                                    make_staged)
    from geomx_tpu_torch.training import load_params

    tiny = TransformerConfig(vocab=16, d_model=8, n_heads=2, n_layers=1,
                             d_ff=16, max_seq=4)

    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: create_cnn_state(seed=0),
                 lambda: create_model_state("cnn", 0),
                 lambda: TorchBackend(Config(topology=Topology())),
                 lambda: main(["--steps", "1"]),
                 lambda: main(["--steps", "1", "--hfa"]),
                 lambda: main(["--steps", "1", "--esync"]),
                 lambda: load_params("no-such-file.pt"),
                 lambda: make_staged(tiny, torch.Generator())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the default Config resolves to the torch backend on CUDA: the
    # servers refuse to come up rather than merge on the host
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(Config(topology=Topology(num_parties=1,
                                            workers_per_party=1)))

    assert resolve_device("cpu") == torch.device("cpu")
    assert create_cnn_state(seed=0, device="cpu")[1]["Conv_0.bias"].device \
        == torch.device("cpu")
    assert TorchBackend(None, device="cpu").device.type == "cpu"
    assert make_staged(tiny, torch.Generator(), "cpu")[1][0]["embed"] \
        .device == torch.device("cpu")


def test_presets_and_trace_demo_raise_without_cuda_unless_cpu(no_cuda,
                                                              tmp_path):
    """The CNN presets and the trace demo (the counterparts of the JAX
    package's ``examples/cnn_<feature>.py`` and
    ``scripts/run_trace_demo.sh``)."""
    import importlib

    from geomx_tpu_torch.examples import _wrapper, trace_demo

    for name in ("bsc", "dgt", "esync", "fp16", "hfa", "mixed_sync", "mpq",
                 "p3", "tsengine"):
        preset = importlib.import_module(
            f"geomx_tpu_torch.examples.cnn_{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            _wrapper.run(preset.FLAGS, ["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_demo.main(["--out", str(tmp_path)])
    assert trace_demo.run("cpu", str(tmp_path), steps=1)["rounds"] >= 1


def test_zoo_moe_int8_and_parity_entry_points_raise_without_cuda(
        no_cuda, monkeypatch):
    """The zoo's and ResNet's factories (directly and by name), the MoE
    flagship, the LM example's MoE flags and the parity harness raise
    without CUDA unless given the CPU; the int8 path has no device of
    its own (it runs where its tensors are)."""
    from geomx_tpu_torch.examples.lm import main as lm_main
    from geomx_tpu_torch.models import MODEL_REGISTRY, create_model_state
    from geomx_tpu_torch.ops import int8
    from geomx_tpu_torch.training import build_flagship_lm
    from geomx_tpu_torch.utils import parity

    for var, val in (("MOE_EXPERTS", "4"), ("VOCAB", "16"), ("DMODEL", "8"),
                     ("HEADS", "2"), ("LAYERS", "2"), ("DFF", "16"),
                     ("SEQ", "8")):
        monkeypatch.setenv(f"GEOMX_LM_{var}", val)
    calls = [lambda f=f: f(0) for f in MODEL_REGISTRY.values()]
    calls += [lambda n=n: create_model_state(n, 0) for n in MODEL_REGISTRY]
    calls += [lambda: build_flagship_lm(),
              lambda: lm_main(["--steps", "1", "--moe-top-k", "2"]),
              lambda: parity.run_parity_config("vanilla", steps=1),
              lambda: parity.run_parity_matrix(steps=1, names=["vanilla"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()

    for name, factory in MODEL_REGISTRY.items():
        _, params, _ = factory(0, device="cpu")
        assert all(t.device.type == "cpu" for t in params.values()), name
    cfg, params, n, _, _ = build_flagship_lm(device="cpu")
    assert cfg.uses_aux and params["layers.1.router"].device.type == "cpu"
    _, mlp, _ = create_model_state("mlp", 0, device="cpu")
    assert int8.quantize_dense_tree(mlp)["Dense_0.weight"]["q"].device \
        .type == "cpu"


def test_mesh_entry_points_raise_without_cuda_unless_cpu(no_cuda):
    """The multi-device entry points: a mesh, the party meshes, the
    pipelined flagship's and the MLP stack's params, and the torch
    backend's default device slots raise without CUDA, as does the
    single-device step's timer; CPU meshes and slots, asked for by
    name, run."""
    from geomx_tpu_torch.examples.time_lm_step import main as time_step
    from geomx_tpu_torch.kvstore.torch_backend import TorchBackend
    from geomx_tpu_torch.models.transformer import TransformerConfig
    from geomx_tpu_torch.parallel import make_mesh
    from geomx_tpu_torch.parallel.dp import party_meshes
    from geomx_tpu_torch.parallel.pipeline import (init_mlp_stack,
                                                   init_pp_transformer)

    tiny = TransformerConfig(vocab=16, d_model=8, n_heads=2, n_layers=2,
                             d_ff=16, max_seq=4)
    for call in (lambda: make_mesh({"dp": 1, "sp": 1, "tp": 1}),
                 lambda: party_meshes(2),
                 lambda: init_pp_transformer(tiny, torch.Generator()),
                 lambda: init_mlp_stack(torch.Generator(), 2, 4, 8),
                 lambda: TorchBackend(None, devices=["cuda"] * 2),
                 lambda: time_step(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert party_meshes(2, ["cpu"] * 4)[1].devices[0].type == "cpu"
    assert init_pp_transformer(tiny, torch.Generator(), "cpu")[
        "layers.wq"].shape == (2, 8, 2, 4)
    assert TorchBackend(None, "cpu", devices=["cpu"] * 4).stats()[
        "merge_devices"] == 4


def test_launcher_roles_raise_without_cuda_unless_cpu(no_cuda):
    """Without CUDA a launched worker raises unless ``--device cpu``, a
    server unless its merge backend is ``numpy`` or ``torch:cpu``; both
    before binding a socket.  Schedulers never need the card."""
    from argparse import Namespace

    from geomx_tpu_torch.core.config import Config, NodeId, Topology
    from geomx_tpu_torch.launch import _check_device, main

    for role in ("worker:0@p0", "server:0@p0", "global_server:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--role", role, "--base-port", "1"])
    topo = Topology(num_parties=1, workers_per_party=1)
    for role, backend, device in (
            ("worker:0@p0", "auto", "cpu"),
            ("server:0@p0", "numpy", None),
            ("server:0@p0", "torch:cpu", None),
            ("global_server:0", "numpy", None),
            ("scheduler:0@p0", "auto", None),
            ("global_scheduler:0", "auto", None)):
        _check_device(NodeId.parse(role),
                      Config(topology=topo, merge_backend=backend),
                      Namespace(device=device))


LANE_MODULES = ("tests.test_torch_runtime_lane_backend",
                "tests.test_torch_runtime_lane_serve",
                "tests.test_torch_runtime_lane_churn",
                "tests.test_torch_mixed_sync",
                "tests.test_torch_backend_runtime")


def test_backend_lane_imports_neither_jax_nor_the_jax_package():
    """The backend lane's runner and the port tests ``chip_smoke.py``
    phase 11 runs on the card import nothing of JAX or of the JAX
    package, and the conftest the lane writes imports no ``jax``."""
    import ast

    for mod in LANE_MODULES:
        text = (ROOT / (mod.replace(".", "/") + ".py")).read_text()
        for node in ast.walk(ast.parse(text)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "flax", "optax", "geomx_tpu"), \
                    (mod, name)
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {LANE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tests.test_torch_runtime_lane_backend import lane_conftest\n"
        "text = lane_conftest()\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m in ('jax', 'flax', 'optax', 'geomx_tpu')\n"
        "             or m.startswith(('jax.', 'geomx_tpu.')))\n"
        "assert not bad, bad\n"
        "print(text)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    conftest = ast.parse(out.stdout)
    for node in ast.walk(conftest):
        if isinstance(node, ast.Import):
            assert all(not a.name.startswith(("jax", "geomx_tpu."))
                       or a.name.startswith("geomx_tpu_torch")
                       for a in node.names), ast.dump(node)
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            assert not mod.startswith("jax") and not (
                mod.startswith("geomx_tpu")
                and not mod.startswith("geomx_tpu_torch")), mod
    assert "thread_leak_guard" in out.stdout
