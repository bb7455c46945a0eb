"""Build a shared library at first use, safely across processes, and
the nvcc build of the port's CUDA sources on top of it.

Several processes (test workers, the worker threads' first calls in
different interpreters) may find a library missing or stale at once.
:func:`locked_build` serialises them on an ``fcntl.flock`` of a lock
file beside the library, re-checks staleness once the lock is held (a
process that waited loads what the winner built), compiles into a
temporary name in the same directory and ``os.replace``s it onto the
library, so no process ever opens a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable


def locked_build(target: str, stale: Callable[[], bool],
                 compile_to: Callable[[str], None]) -> None:
    """Make ``target`` current: if ``stale()``, take the lock
    ``target + ".lock"``, check ``stale()`` again and, if still stale,
    call ``compile_to(tmp)`` with a fresh path in ``target``'s directory
    and move the result onto ``target``.  Errors of ``compile_to``
    propagate; the temporary file never outlives the call."""
    if not stale():
        return
    d = os.path.dirname(os.path.abspath(target))
    os.makedirs(d, exist_ok=True)
    with open(target + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not stale():
                return
            fd, tmp = tempfile.mkstemp(
                prefix="." + os.path.basename(target) + ".", dir=d)
            os.close(fd)
            try:
                compile_to(tmp)
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


# ---- CUDA sources built with nvcc into a ctypes library ------------------

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default prefix; raises RuntimeError when none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


class NvccLibrary:
    """One ``.cu`` source compiled with ``nvcc`` for ``sm_90a`` into a
    shared library at its first :meth:`load` (rebuilt when the source or
    a ``.cuh`` header beside it is newer, under :func:`locked_build`),
    loaded once per process with ctypes; ``bind(lib)`` sets the entry
    points' ``argtypes``.  ``log`` holds what ptxas said of each kernel
    (registers, shared memory, spills) at the library's build, kept in
    ``library + ".ptxas"`` so a process that loads a cached library reads
    it too."""

    def __init__(self, source: str, library: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source, self.library = str(source), str(library)
        self._bind = bind
        self._lib = None
        self._mu = threading.Lock()
        self.log = ""

    def inputs(self) -> list:
        """The source and the headers beside it, which it may include."""
        d = os.path.dirname(self.source)
        return [self.source, *sorted(glob.glob(os.path.join(d, "*.cuh")))]

    def stale(self) -> bool:
        """True when the library is missing or older than an input."""
        try:
            built = os.stat(self.library).st_mtime
            return any(built < os.stat(f).st_mtime for f in self.inputs())
        except FileNotFoundError:
            return True

    def _compile(self, out: str) -> None:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", out, self.source]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        with open(self.library + ".ptxas", "w") as f:
            f.write(res.stderr)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._mu:
                if self._lib is None:
                    locked_build(self.library, self.stale, self._compile)
                    try:
                        with open(self.library + ".ptxas") as f:
                            self.log = f.read()
                    except FileNotFoundError:
                        self.log = ""
                    lib = ctypes.CDLL(self.library)
                    self._bind(lib)
                    self._lib = lib
        return self._lib
