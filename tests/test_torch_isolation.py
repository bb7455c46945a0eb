"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU.

- every module of ``geomx_tpu_torch`` imports in a fresh interpreter
  without pulling ``jax`` or ``geomx_tpu`` (the top-level name) into
  ``sys.modules``;
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
    # only what the port's imports bring in counts: a site customization
    # may have imported jax before the first line runs
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m in ('jax', 'flax', 'optax', 'geomx_tpu')\n"
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

    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: create_cnn_state(seed=0),
                 lambda: create_model_state("cnn", 0),
                 lambda: TorchBackend(Config(topology=Topology())),
                 lambda: main(["--steps", "1"])):
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
