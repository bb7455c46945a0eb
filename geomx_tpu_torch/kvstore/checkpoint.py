"""Server-state checkpoint/restore and wire-format snapshots.

The reference keeps server model state only in RAM and supports
client-side optimizer-state saves that are explicitly unsupported for
distributed updaters (ref: python/mxnet/kvstore.py:566-591;
kvstore_dist_server.h:1923 store_ map) — SURVEY.md §7 flags server-side
checkpointing as an improvement to build.  Format: a single .npz holding
the weight slabs keyed by ps-key plus pickled optimizer state, written
atomically (tmp + rename) so a crash mid-save never corrupts the last
good checkpoint.

``dumps_server_state`` / ``loads_server_state`` expose the same slab
format as bytes — the hot-standby replication stream ships exactly what
a checkpoint would hold, over the wire instead of disk, so the standby's
restore path and the crash-restart restore path stay one code path.

The pickled optimizer is ALWAYS the host-numpy ``ServerOptimizer``:
a server running the device-resident optimizer stage
(kvstore/jax_backend.py) exports its trajectory through
``GlobalServer._export_opt_locked()`` before any state reaches this
module, and re-imports on restore — the slab format is engine-agnostic
by construction, so checkpoints round-trip between numpy and device
servers in both directions.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
from typing import Dict, List

import numpy as np

from geomx_tpu_torch.transport.message import wire_checksum
from geomx_tpu_torch.utils.io import atomic_write

# Verified-slab format (GEOMX_INTEGRITY_CKPT): the npz blob is wrapped
# in a magic + format-version + whole-blob CRC header, and the payload
# additionally carries a per-slab CRC table ("__crc__") so a restore
# can pinpoint WHICH slab rotted.  Legacy blobs (bare npz, "PK" zip
# magic) load unchanged; the stamp is opt-in so a mixed-version fleet's
# replication stream stays readable both ways.
CKPT_INTEGRITY = (os.environ.get("GEOMX_INTEGRITY_CKPT", "")
                  .strip().lower() in ("1", "true", "yes", "on"))
_CKPT_MAGIC = b"GXCK"
_CKPT_VERSION = 1
_CKPT_HDR = struct.Struct("<HI")  # version, crc32 of the npz blob


class CheckpointCorruption(ValueError):
    """A stamped server-state blob failed verification (bad CRC,
    truncation, or an unknown format version).  Restore paths catch
    this and fall back to the previous generation; a standby rejects
    the snapshot and keeps the one it has."""


def dumps_server_state(store: Dict[int, np.ndarray],
                       optimizer_state: dict, meta: dict,
                       integrity: bool = None) -> bytes:
    payload: Dict[str, np.ndarray] = {
        f"k{k}": v for k, v in store.items()
    }
    payload["__opt__"] = np.frombuffer(
        pickle.dumps(optimizer_state, protocol=4), dtype=np.uint8)
    payload["__meta__"] = np.frombuffer(
        pickle.dumps(meta, protocol=4), dtype=np.uint8)
    if integrity is None:
        integrity = CKPT_INTEGRITY
    if integrity:
        crcs = {name: wire_checksum(np.ascontiguousarray(v).tobytes())
                for name, v in payload.items()}
        payload["__crc__"] = np.frombuffer(
            pickle.dumps(crcs, protocol=4), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    blob = buf.getvalue()
    if not integrity:
        return blob
    return (_CKPT_MAGIC
            + _CKPT_HDR.pack(_CKPT_VERSION, wire_checksum(blob)) + blob)


def loads_server_state(data: bytes):
    """Returns (store, optimizer_state, meta).  A stamped blob is
    verified end to end first (whole-blob CRC, then per-slab CRCs);
    any mismatch raises :class:`CheckpointCorruption` — including npz/
    pickle parse failures past a valid-looking stamp, so callers need
    exactly one except clause on the restore path."""
    stamped = data[:4] == _CKPT_MAGIC
    if stamped:
        if len(data) < 4 + _CKPT_HDR.size:
            raise CheckpointCorruption("truncated checkpoint header")
        version, crc = _CKPT_HDR.unpack_from(data, 4)
        if version != _CKPT_VERSION:
            raise CheckpointCorruption(
                f"unknown checkpoint format version {version}")
        data = data[4 + _CKPT_HDR.size:]
        if wire_checksum(data) != crc:
            raise CheckpointCorruption("checkpoint blob CRC mismatch")
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            store = {int(name[1:]): z[name] for name in z.files
                     if name.startswith("k")}
            opt = pickle.loads(z["__opt__"].tobytes())
            meta = pickle.loads(z["__meta__"].tobytes())
            crcs = (pickle.loads(z["__crc__"].tobytes())
                    if "__crc__" in z.files else None)
    except CheckpointCorruption:
        raise
    except Exception as e:
        if stamped:
            # the outer CRC passed, so this is a writer bug or an
            # unsupported payload — surface it as corruption anyway:
            # the restore path's job is falling back, not crashing
            raise CheckpointCorruption(f"stamped blob unparseable: {e}")
        raise
    if crcs is not None:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            for name in z.files:
                if name == "__crc__":
                    continue
                want = crcs.get(name)
                got = wire_checksum(
                    np.ascontiguousarray(z[name]).tobytes())
                if want is None or got != want:
                    raise CheckpointCorruption(
                        f"slab '{name}' CRC mismatch")
    return store, opt, meta


def save_server_state(path: str, store: Dict[int, np.ndarray],
                      optimizer_state: dict, meta: dict,
                      integrity: bool = None) -> None:
    blob = dumps_server_state(store, optimizer_state, meta,
                              integrity=integrity)
    with atomic_write(path) as f:
        f.write(blob)


def load_server_state(path: str):
    """Returns (store, optimizer_state, meta)."""
    with open(path, "rb") as f:
        return loads_server_state(f.read())


# ---- N-generation retention -------------------------------------------------
def rotate_generations(path: str, keep: int) -> None:
    """Shift ``path`` → ``path.1`` → … → ``path.{keep-1}`` before a new
    write lands at ``path`` (the oldest generation falls off the end).
    ``keep <= 1`` keeps today's single-file behavior."""
    for i in range(max(1, keep) - 1, 0, -1):
        src = path if i == 1 else f"{path}.{i - 1}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i}")


def restore_candidates(path: str) -> List[str]:
    """Existing generations, newest first: ``path``, ``path.1``, …"""
    out = [path] if os.path.exists(path) else []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        out.append(f"{path}.{i}")
        i += 1
    return out
