"""Shared filesystem helpers."""

from __future__ import annotations

import contextlib
import os
import tempfile


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb"):
    """Write-then-rename: the file at ``path`` is either the previous
    version or the complete new one, never a torn write.  Creates parent
    directories.  Used by every on-disk artifact (checkpoints, param
    saves, record datasets).

    Durability: the temp file is fsync'd BEFORE the rename and the
    parent directory AFTER — rename alone only orders the metadata, so
    a power loss shortly after ``os.replace`` could surface the new
    name pointing at unwritten blocks (or no entry at all)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
