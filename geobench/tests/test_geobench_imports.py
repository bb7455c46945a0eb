"""Nothing the harness runs loads JAX or the JAX package, and the
reference loads nothing of the port.  Top-level module names are
compared whole: ``geomx_tpu_torch`` is the port, ``geomx_tpu`` the JAX
package."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from geobench.tests import tiny

REPO = tiny.REPO
PKG = os.path.join(REPO, "geobench")
JAX = {"jax", "jaxlib", "flax", "geomx_tpu"}


def _file_of(module: str):
    parts = module.split(".")
    base = os.path.join(REPO, *parts)
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def _imports(path: str):
    """Every module an ``import`` anywhere in ``path`` names (a name
    imported from a package counts as its submodule too)."""
    tree = ast.parse(open(path).read(), path)
    pkg = os.path.relpath(os.path.dirname(path), REPO).replace(os.sep, ".")
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                mod = ".".join(base + ([mod] if mod else []))
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value)
    return out


def walk(start_files):
    """Top-level names of everything the files load, following
    ``geobench`` modules (and the metric and family modules the harness
    loads by name) through their own imports."""
    seen, tops = set(), set()
    todo = list(start_files)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in _imports(path):
            top = mod.split(".", 1)[0]
            tops.add(top)
            if top == "geobench":
                f = _file_of(mod)
                if f is not None:
                    todo.append(f)
    return tops, seen


def _pkg_files(sub):
    d = os.path.join(PKG, sub)
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(".py")]


def test_the_run_loads_no_jax():
    start = [os.path.join(PKG, "run.py")] + _pkg_files("metrics") + \
        _pkg_files("families") + _pkg_files("flops")
    tops, seen = walk(start)
    assert not tops & JAX, tops & JAX
    assert os.path.join(PKG, "harness.py") in seen
    assert "geomx_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    tops, seen = walk(_pkg_files("reference"))
    assert not tops & (JAX | {"geomx_tpu_torch"}), tops
    assert all("/reference/" in p or p.endswith(("traffic.py",
                                                 "__init__.py"))
               for p in seen), seen


def test_the_walk_sees_a_prefix_as_another_name(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import geomx_tpu_torch.training\n"
                 "def f():\n    from geomx_tpu import x\n")
    tops, _ = walk([str(p)])
    assert tops == {"geomx_tpu_torch", "geomx_tpu"}


_LOADED = """
import sys, json
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def _loaded(body: str, cwd: str):
    code = _LOADED.format(repo=REPO, body=body)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    root = tiny.write(str(tmp_path))
    body = f"""
import argparse, torch
from geobench import run
args = argparse.Namespace(workload="t-fsa-mpq", seed=5, seconds=0.3,
                          trace=1)
assert run.run(args, torch.device("cpu"), {root!r}) == 0
assert run.forbidden_modules() == []
"""
    tops = _loaded(body, root)
    assert not tops & JAX
    assert "geomx_tpu_torch" in tops


def test_the_reference_runs_without_the_program(tmp_path):
    body = """
import torch
from geobench.tests import tiny
from geobench.reference import georound
cell = tiny.CELLS["t-fsa-mpq"][1]
georound.run(tiny.LM, cell, 5, torch.device("cpu"), 2)
georound.run(tiny.LM, cell, 5, torch.device("cpu"), 2, precision="fp8")
"""
    tops = _loaded(body, str(tmp_path))
    assert not tops & (JAX | {"geomx_tpu_torch"}), tops


@pytest.mark.parametrize("name,bad", [("geomx_tpu", True),
                                      ("geomx_tpu_torch", False),
                                      ("jaxlib", True), ("jaxfoo", False)])
def test_forbidden_compares_whole_names(name, bad, monkeypatch):
    from geobench import run

    monkeypatch.setitem(sys.modules, f"{name}.sub", object())
    assert (name in run.forbidden_modules()) is bad
