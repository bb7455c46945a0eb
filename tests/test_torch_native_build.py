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


def test_nvcc_library_is_stale_when_an_included_header_is_newer(tmp_path):
    """A CUDA library rebuilds when a header beside its source changes,
    and not otherwise (a stub stands in for nvcc)."""
    from geomx_tpu_torch.utils.build import NvccLibrary, locked_build

    (tmp_path / "tiles.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// innermost\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda.h>\n#include "tiles.cuh"\n')
    lib = NvccLibrary(src, tmp_path / "cache" / "libk.so", lambda _: None)
    builds = []

    def compile_to(out):
        builds.append(out)
        pathlib.Path(out).write_bytes(b"lib")

    def build_at(t):
        locked_build(lib.library, lib.stale, compile_to)
        os.utime(lib.library, (t, t))

    for f in ("k.cu", "tiles.cuh", "inner.cuh"):
        os.utime(tmp_path / f, (1000, 1000))
    build_at(2000)
    assert len(builds) == 1
    locked_build(lib.library, lib.stale, compile_to)   # nothing touched
    assert len(builds) == 1
    for n, f in enumerate(("tiles.cuh", "inner.cuh", "k.cu")):
        t = 3000 + 1000 * n                            # touch one file
        os.utime(tmp_path / f, (t, t))
        assert lib.stale(), f
        build_at(t + 500)
        assert len(builds) == 2 + n
        assert not lib.stale()


def test_nvcc_library_keeps_the_ptxas_log_beside_the_library(
        tmp_path, monkeypatch):
    """The ptxas report of a build reaches a process that loads the
    cached library without building it (a script stands in for nvcc)."""
    import ctypes

    from geomx_tpu_torch.utils.build import NvccLibrary

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n"
                    "echo \"ptxas info    : Used 40 registers\" >&2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    built = NvccLibrary(src, tmp_path / "cache" / "libk.so", lambda _: None)
    assert built.load() == built.library
    assert "Used 40 registers" in built.log
    cached = NvccLibrary(src, built.library, lambda _: None)
    assert not cached.stale()
    cached.load()
    assert cached.log == built.log


@pytest.mark.parametrize("module", ["flash_attention", "block_attention"])
def test_port_libraries_watch_the_tile_header(module):
    import importlib

    mod = importlib.import_module(f"geomx_tpu_torch.ops.kernels.{module}")
    csrc = ROOT / "geomx_tpu_torch" / "csrc"
    assert mod.LIB.inputs()[0] == str(csrc / f"{module}.cu")
    assert str(csrc / "hopper_tiles.cuh") in mod.LIB.inputs()
