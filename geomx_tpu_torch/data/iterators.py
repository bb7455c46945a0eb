"""Dataset iterators over on-disk formats + augmentation.

The reference ships record/image/MNIST/CSV/libsvm iterators and a
threaded prefetcher (ref: src/io/ — iter_image_recordio_2.cc,
iter_mnist.cc, iter_csv.cc, iter_libsvm.cc, iter_prefetcher.h).  These
are their host-side equivalents: every iterator yields dense
``(x, y)`` numpy batches (or row-sparse triples for libsvm), sharded
per worker the same way the examples shard
(ref: examples/cnn.py:49 — split by global worker index).
"""

from __future__ import annotations

import queue
import struct
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from geomx_tpu_torch.data.recordio import RecordReader, unpack_array


def _shard(n: int, worker_index: int, num_workers: int) -> np.ndarray:
    """Round-robin shard of ``range(n)`` — matches ShardedIterator."""
    ids = np.arange(worker_index, n, num_workers)
    if len(ids) == 0:
        raise ValueError(
            f"empty shard: {n} examples over {num_workers} workers leaves "
            f"none for worker {worker_index}")
    return ids


class RecordDatasetIter:
    """Batches from a record file of packed arrays (infinite, shuffled).

    ref: src/io/iter_image_recordio_2.cc — record-backed batch iterator
    with per-worker sharding (part_index/num_parts there)."""

    def __init__(self, path: str, batch_size: int, worker_index: int = 0,
                 num_workers: int = 1, shuffle: bool = True, seed: int = 0):
        self._reader = RecordReader(path)
        self._ids = _shard(len(self._reader), worker_index, num_workers)
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._cursor = 0
        self._rng = np.random.default_rng(seed + worker_index)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._shuffle:
            pick = self._rng.choice(self._ids, size=self.batch_size)
        else:
            # sequential sweep over the shard, wrapping at the end
            pos = (self._cursor + np.arange(self.batch_size)) % len(self._ids)
            self._cursor = (self._cursor + self.batch_size) % len(self._ids)
            pick = self._ids[pos]
        xs, ys = [], []
        for i in pick:
            x, label = unpack_array(self._reader.read(int(i)))
            xs.append(x)
            ys.append(label)
        return np.stack(xs), np.asarray(ys, dtype=np.int32)


class MNISTIter:
    """Reader for idx-format ubyte files (the MNIST container format,
    ref: src/io/iter_mnist.cc — magic 0x803 images / 0x801 labels).
    Yields normalized float32 NHWC batches."""

    def __init__(self, images_path: str, labels_path: str, batch_size: int,
                 worker_index: int = 0, num_workers: int = 1, seed: int = 0):
        self.x = self._read_idx(images_path)
        self.y = self._read_idx(labels_path)
        if len(self.x) != len(self.y):
            raise IOError("images/labels length mismatch")
        self._ids = _shard(len(self.x), worker_index, num_workers)
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed + worker_index)

    @staticmethod
    def _read_idx(path: str) -> np.ndarray:
        with open(path, "rb") as f:
            buf = f.read()
        if buf[:2] == b"\x1f\x8b":  # distributed gzipped; read in place
            import gzip
            buf = gzip.decompress(buf)
        zero, dtype_code, ndim = struct.unpack_from(">HBB", buf, 0)
        if zero != 0:
            raise IOError(f"{path}: not an idx file")
        dims = struct.unpack_from(f">{ndim}I", buf, 4)
        codes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        dt = codes.get(dtype_code)
        if dt is None:
            raise IOError(f"{path}: unknown idx dtype 0x{dtype_code:02x}")
        data = np.frombuffer(buf, dtype=np.dtype(dt).newbyteorder(">"),
                             offset=4 + 4 * ndim)
        return data.reshape(dims).astype(dt)

    @staticmethod
    def write_idx(path: str, arr: np.ndarray) -> None:
        """Inverse of _read_idx (lets tests and offline tools build the
        container without egress)."""
        codes = {np.dtype(np.uint8): 0x08, np.dtype(np.int8): 0x09,
                 np.dtype(np.int16): 0x0B, np.dtype(np.int32): 0x0C,
                 np.dtype(np.float32): 0x0D, np.dtype(np.float64): 0x0E}
        code = codes[arr.dtype]
        with open(path, "wb") as f:
            f.write(struct.pack(">HBB", 0, code, arr.ndim))
            f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
            f.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        pick = self._rng.choice(self._ids, size=self.batch_size)
        x = self.x[pick].astype(np.float32) / 255.0
        if x.ndim == 3:  # HW → HWC
            x = x[..., None]
        return x, self.y[pick].astype(np.int32)


class CSVIter:
    """Dense CSV: label in ``label_col``, features in the rest
    (ref: src/io/iter_csv.cc)."""

    def __init__(self, path: str, batch_size: int, label_col: int = 0,
                 worker_index: int = 0, num_workers: int = 1, seed: int = 0):
        raw = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
        self.y = raw[:, label_col].astype(np.int32)
        self.x = np.delete(raw, label_col, axis=1)
        self._ids = _shard(len(self.x), worker_index, num_workers)
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed + worker_index)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        pick = self._rng.choice(self._ids, size=self.batch_size)
        return self.x[pick], self.y[pick]


class LibSVMIter:
    """Sparse ``label idx:val …`` rows (ref: src/io/iter_libsvm.cc).

    Yields ``(row_ids, values, labels)`` batches shaped for the row-sparse
    push/pull path: ``row_ids`` are the distinct feature ids touched by
    the batch and ``values`` is a dense ``[len(row_ids), 1]`` slab — the
    same layout WorkerKVStore.push_row_sparse takes."""

    def __init__(self, path: str, batch_size: int, num_features: int,
                 worker_index: int = 0, num_workers: int = 1, seed: int = 0):
        self.rows = []  # list of (ids ndarray, vals ndarray, label)
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                label = float(parts[0])
                ids, vals = [], []
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    ids.append(int(i))
                    vals.append(float(v))
                self.rows.append((np.asarray(ids, np.int64),
                                  np.asarray(vals, np.float32), label))
        self.num_features = num_features
        self._ids = _shard(len(self.rows), worker_index, num_workers)
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed + worker_index)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        pick = self._rng.choice(self._ids, size=self.batch_size)
        labels = np.asarray([self.rows[i][2] for i in pick], np.float32)
        touched = np.unique(np.concatenate([self.rows[i][0] for i in pick]))
        pos = {int(t): j for j, t in enumerate(touched)}
        slab = np.zeros((len(touched), 1), np.float32)
        for i in pick:
            ids, vals, _ = self.rows[i]
            for t, v in zip(ids, vals):
                slab[pos[int(t)], 0] += v
        return touched, slab, labels


class AugmentIter:
    """Random horizontal flip + zero-pad crop over an image-batch
    iterator (ref: src/io/image_aug_default.cc rand_mirror/rand_crop)."""

    def __init__(self, it, flip: bool = True, pad_crop: int = 0,
                 seed: int = 0):
        self._it = it
        self._flip = flip
        self._pad = pad_crop
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        x, y = next(self._it)
        if self._flip:
            m = self._rng.random(len(x)) < 0.5
            x = x.copy()
            x[m] = x[m, :, ::-1]
        if self._pad:
            p = self._pad
            padded = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
            h = self._rng.integers(0, 2 * p + 1, size=2)
            x = padded[:, h[0]:h[0] + x.shape[1], h[1]:h[1] + x.shape[2]]
        return x, y


class PrefetchIter:
    """Background-thread prefetch with a bounded buffer
    (ref: src/io/iter_prefetcher.h — double-buffered PrefetcherIter).
    Overlaps host-side batch assembly with device compute."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="data-prefetch")
        self._t.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer closed us."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except BaseException as e:  # surfaced on next()
            self._exc = e
        self._put(None)  # end-of-stream (or error) sentinel

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            self.close()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
