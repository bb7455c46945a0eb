"""Build a shared library at first use, safely across processes.

Several processes (test workers, the worker threads' first calls in
different interpreters) may find a library missing or stale at once.
:func:`locked_build` serialises them on an ``fcntl.flock`` of a lock
file beside the library, re-checks staleness once the lock is held (a
process that waited loads what the winner built), compiles into a
temporary name in the same directory and ``os.replace``s it onto the
library, so no process ever opens a half-written file.
"""

from __future__ import annotations

import fcntl
import os
import tempfile
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
