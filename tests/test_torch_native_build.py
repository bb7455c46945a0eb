"""The port's native codec library builds once under concurrent first
loads.

A fresh tree has no ``libgeocodecs.so`` (it is gitignored), so the
first load in each process builds it.  Six processes that load a fresh
copy of ``geomx_tpu_torch/native/`` at once must all end up with a
usable library: the build runs under a file lock, a waiting process
re-checks and loads the winner's build, and the library appears under
its name only complete (compiled to a temporary name, then moved).
"""

import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
NATIVE = ROOT / "geomx_tpu_torch" / "native"
N_PROCS = 6

_LOAD = (
    "import importlib.util, sys\n"
    "spec = importlib.util.spec_from_file_location('copied_bindings',\n"
    "                                              sys.argv[1])\n"
    "mod = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(mod)\n"
    "print('available', mod.available())\n")


@pytest.fixture
def fresh_native(tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no make/g++ on this host: the library cannot build")
    dst = tmp_path / "native"
    shutil.copytree(NATIVE, dst, ignore=shutil.ignore_patterns(
        "*.so", "*.lock", "__pycache__", ".libgeocodecs*"))
    assert not (dst / "libgeocodecs.so").exists()
    return dst


def test_concurrent_first_loads_all_find_the_library(fresh_native):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOAD, str(fresh_native / "bindings.py")],
        cwd=str(fresh_native), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(N_PROCS)]
    outs = []
    deadline = time.monotonic() + 240
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out.strip(), err[-1000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _, _ in outs), outs
    assert [o for _, o, _ in outs] == ["available True"] * N_PROCS, outs
    # one complete library, no temporary left behind
    left = sorted(f.name for f in fresh_native.iterdir()
                  if f.name.startswith(".libgeocodecs"))
    assert left == [], left
    assert (fresh_native / "libgeocodecs.so").stat().st_size > 0
