"""Record-IO: length-prefixed binary record files with random access.

Mirrors the reference's dmlc record-IO storage layer (ref: src/io/ uses
3rdparty/dmlc-core/include/dmlc/recordio.h readers; python surface
python/mxnet/recordio.py — MXRecordIO/MXIndexedRecordIO + pack/unpack).
Wire format per record: ``[u32 magic | u32 lrec | payload | pad-to-4]``
with payload length in the low 29 bits of ``lrec``.  Indexing a file is
a single native scan (geomx_tpu_torch/native/recordio.cc) with a pure-python
fallback.

On top of raw records, :func:`pack_array` / :func:`unpack_array` carry a
labelled ndarray (the reference's IRHeader + data payload,
ref: python/mxnet/recordio.py pack/unpack).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

RECORD_MAGIC = 0xCED7230A
_LEN_MASK = (1 << 29) - 1

_ARRAY_MAGIC = 0x47584152  # "GXAR"
_DTYPES = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.int64,
           4: np.uint8, 5: np.int8}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class RecordWriter:
    """Append-only record file writer (cold path — plain Python).
    Accepts a path or an open binary file object (not closed on exit —
    the atomic_write context manages it)."""

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "write"):
            self._f = path_or_file
            self._owns = False
        else:
            self._f = open(path_or_file, "wb")
            self._owns = True

    def write(self, payload: bytes) -> None:
        if len(payload) > _LEN_MASK:
            raise ValueError(f"record too large: {len(payload)}")
        self._f.write(struct.pack("<II", RECORD_MAGIC, len(payload)))
        self._f.write(payload)
        pad = (-len(payload)) % 4
        if pad:
            self._f.write(b"\x00" * pad)

    def close(self) -> None:
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _index_python(buf: bytes) -> List[Tuple[int, int]]:
    out = []
    pos, size = 0, len(buf)
    while pos + 8 <= size:
        magic, lrec = struct.unpack_from("<II", buf, pos)
        if magic != RECORD_MAGIC:
            raise IOError(f"corrupt record file at byte {pos}")
        n = lrec & _LEN_MASK
        if pos + 8 + n > size:
            raise IOError(f"truncated record at byte {pos}")
        out.append((pos + 8, n))
        pos += 8 + ((n + 3) & ~3)
    if pos != size:
        raise IOError(f"trailing garbage at byte {pos}")
    return out


def _index_native(buf) -> Optional[List[Tuple[int, int]]]:
    from geomx_tpu_torch.native import bindings

    lib = bindings.lib()
    if lib is None or not hasattr(lib, "geo_recordio_index"):
        return None
    data = np.frombuffer(buf, dtype=np.uint8)
    cap = len(buf) // 8 + 1
    offsets = np.empty(cap, dtype=np.int64)
    lengths = np.empty(cap, dtype=np.int64)
    n = lib.geo_recordio_index(data, len(buf), cap, offsets, lengths)
    if n < 0:
        raise IOError(f"corrupt record file at byte {-n - 1}")
    return list(zip(offsets[:n].tolist(), lengths[:n].tolist()))


class RecordReader:
    """Random-access reader: whole file in memory + (offset, len) index.

    The reference splits sequential (MXRecordIO) and indexed
    (MXIndexedRecordIO w/ a .idx sidecar) readers; here the index is
    rebuilt by one native scan at open so no sidecar file is needed.
    The file is mmapped, so N readers of one file in a process (one per
    worker thread) share a single physical copy via the page cache."""

    def __init__(self, path: str):
        import mmap

        self._f = open(path, "rb")
        if os.path.getsize(path) == 0:
            self._buf: bytes = b""
        else:
            self._buf = mmap.mmap(self._f.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        idx = _index_native(self._buf)
        self._index = idx if idx is not None else _index_python(self._buf)

    def __len__(self) -> int:
        return len(self._index)

    def read(self, i: int) -> bytes:
        off, n = self._index[i]
        return self._buf[off:off + n]

    def __iter__(self):
        for i in range(len(self)):
            yield self.read(i)


def pack_array(x: np.ndarray, label: float = 0.0) -> bytes:
    """Serialize one labelled ndarray into a record payload."""
    x = np.ascontiguousarray(x)
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"unsupported dtype {x.dtype}")
    hdr = struct.pack("<IBBHf", _ARRAY_MAGIC, code, x.ndim, 0, label)
    dims = struct.pack(f"<{x.ndim}q", *x.shape)
    return hdr + dims + x.tobytes()


def unpack_array(payload: bytes) -> Tuple[np.ndarray, float]:
    magic, code, ndim, _, label = struct.unpack_from("<IBBHf", payload, 0)
    if magic != _ARRAY_MAGIC:
        raise IOError("not an array record")
    dims = struct.unpack_from(f"<{ndim}q", payload, 12)
    data = np.frombuffer(payload, dtype=_DTYPES[code], offset=12 + 8 * ndim)
    return data.reshape(dims).copy(), label


def write_array_dataset(path: str, x: np.ndarray, y: np.ndarray) -> None:
    """Write a (features, labels) dataset as one record per example.

    The write is atomic (temp file + rename): an interrupted or
    concurrent writer can never leave a truncated file at ``path`` for
    later runs to trip over."""
    from geomx_tpu_torch.utils.io import atomic_write

    with atomic_write(path) as f:
        w = RecordWriter(f)
        for xi, yi in zip(x, y):
            w.write(pack_array(xi, float(yi)))
