"""Wire codecs: FP16, 2-bit quantization, Bi-Sparse top-k, MPQ.

Reimplements the reference GradientCompression family
(ref: src/kvstore/gradient_compression.{h,cc,-inl.h}) as stateful
host-side codecs applied at the WAN edge (local server ↔ global server):

- **FP16** — plain half-precision transmission, 2× reduction
  (ref: README.md:22; fp16 push paths kvstore_dist_server.h:760-820).
- **2-bit** — elementwise {−t, 0, +t} quantization with residual
  feedback, 4 values per byte = 16× vs float32
  (ref: gradient_compression-inl.h:40-139 — 16:1 packing, residual kept
  client-side and folded into the next round).
- **BSC (Bi-Sparse)** — DGC-style top-k sparsification with momentum
  correction and sampled-threshold estimation
  (ref: gradient_compression.cc:191-269 BSCompress — momentum m=0.9,
  accumulated velocity, 0.5% random sample to pick the threshold, emit
  [values ‖ indices]).  The pull direction re-sparsifies what flows back
  down (ref: BSCPullCompress :271-308) — implemented here as
  ``BroadcastCompressor``: per-(key, subscriber) top-k weight *deltas*
  with residual carry, so every byte down the WAN is also sparse.
- **MPQ** — mixed precision by size: tensors under ``size_bound`` go FP16,
  big ones BSC (ref: kvstore_dist_server.h:183, examples/cnn_mpq.py).

Wire format: a payload numpy array per key (dtype carries the encoding) +
the message-level ``compr`` tag.  Sparse payloads pack
``[float32 values ‖ int32 indices bit-cast to float32]`` like the
reference's [values ‖ indices] layout; the receiver recovers indices by
re-viewing the bits, so no precision is lost.

These run on the server hosts (numpy).  The worker-side/TPU variants of
the same math (for on-device compression before the host handoff) live in
geomx_tpu_torch/ops as jax/pallas kernels.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import numpy as np


def _native():
    """The C++ hot-loop library (geomx_tpu_torch/native), or None — numpy
    remains the fallback and the semantic reference."""
    try:
        from geomx_tpu_torch.native import bindings

        return bindings.lib()
    except Exception:  # pragma: no cover - missing toolchain
        return None


class CodecError(ValueError):
    """A payload failed structural validation at decode time.

    Every decode entry point raises THIS (never a bare IndexError /
    ValueError / reshape error, and never a silent wrong-shaped tensor)
    when a payload is truncated, mis-sized, or carries out-of-range
    indices — so receivers can fence the one bad push instead of letting
    a corrupt buffer take down the merge thread or, worse, scatter into
    the wrong coordinates.  Subclasses ValueError so pre-existing
    catch-sites keep working."""

    def __init__(self, what: str, *, tag: str = "", key: int = -1):
        self.what = what
        self.tag = tag
        self.key = int(key)
        detail = f" (tag '{tag}'" + (f", key {key})" if key >= 0 else ")") \
            if tag else (f" (key {key})" if key >= 0 else "")
        super().__init__(f"corrupt codec payload: {what}{detail}")


def _check_f32_vector(payload: np.ndarray, tag: str, key: int) -> np.ndarray:
    """Common structural gate for the bit-cast sparse formats: the
    [values ‖ indices] layouts re-view raw bits as int32, which is only
    meaningful on a contiguous 1-D 4-byte-item array."""
    arr = np.asarray(payload)
    if arr.ndim != 1:
        raise CodecError(f"expected 1-D payload, got ndim={arr.ndim}",
                         tag=tag, key=key)
    if arr.dtype.itemsize != 4:
        raise CodecError(
            f"expected 4-byte items for index bit-cast, got {arr.dtype}",
            tag=tag, key=key)
    # bit-cast (never a value conversion): the indices half only decodes
    # correctly if the raw 4-byte patterns are preserved
    return np.ascontiguousarray(arr).view(np.float32)


class Codec:
    name = "none"

    def compress(self, key: int, arr: np.ndarray) -> np.ndarray:
        return arr

    def decompress(self, key: int, payload: np.ndarray, orig_len: int) -> np.ndarray:
        return payload

    @property
    def dense_delta(self) -> bool:
        """True if decompressed output is a delta to ADD (sparse codecs)
        rather than a full replacement value."""
        return False


class Fp16Codec(Codec):
    name = "fp16"

    def compress(self, key, arr):
        return arr.astype(np.float16)

    def decompress(self, key, payload, orig_len):
        if len(payload) != orig_len:
            raise CodecError(
                f"fp16 payload carries {len(payload)} values for a "
                f"{orig_len}-element tensor", tag="fp16", key=key)
        return payload.astype(np.float32)


class TwoBitCodec(Codec):
    """{−t, 0, +t} with residual feedback; 4 values/byte.

    ref: gradient_compression-inl.h:40-139 (quantize_2bit: residual +=
    grad; emit ±threshold where |residual| > threshold; subtract emitted).
    """

    name = "2bit"

    def __init__(self, threshold: float = 0.5):
        self.threshold = float(threshold)
        self._residual: Dict[int, np.ndarray] = {}

    def compress(self, key, arr):
        n = len(arr)
        r = self._residual.get(key)
        if r is None or len(r) != n:
            r = np.zeros(n, dtype=np.float32)
        nlib = _native()
        if nlib is not None:
            g = np.ascontiguousarray(arr, dtype=np.float32)
            r = np.ascontiguousarray(r)
            out = np.zeros((n + 3) // 4, dtype=np.uint8)
            nlib.geo_pack2bit(g, r, out, n, self.threshold)
            self._residual[key] = r  # updated in place
            return out
        r = r + arr.astype(np.float32)
        q = np.zeros(n, dtype=np.uint8)  # 0 = zero, 1 = +t, 2 = −t
        q[r > self.threshold] = 1
        q[r < -self.threshold] = 2
        # in-place float32 updates (a `(q==1)*threshold` expression would
        # silently promote the stored residual to float64)
        r[q == 1] -= np.float32(self.threshold)
        r[q == 2] += np.float32(self.threshold)
        self._residual[key] = r
        # pack 4 two-bit codes per byte
        pad = (-len(q)) % 4
        qp = np.pad(q, (0, pad)).reshape(-1, 4)
        packed = (qp[:, 0] | (qp[:, 1] << 2) | (qp[:, 2] << 4) | (qp[:, 3] << 6))
        return packed.astype(np.uint8)

    def decompress(self, key, payload, orig_len):
        b = np.ascontiguousarray(payload, dtype=np.uint8)
        if len(b) < (orig_len + 3) // 4:
            # length gate BEFORE either decoder touches the buffer: the
            # native geo_unpack2bit reads orig_len/4 bytes unchecked (a
            # truncated payload would read out of bounds), and the numpy
            # path would return a silently short boolean mask
            raise CodecError(
                f"2bit payload holds {len(b) * 4} codes for a "
                f"{orig_len}-element tensor", tag="2bit", key=key)
        nlib = _native()
        if nlib is not None:
            out = np.empty(orig_len, dtype=np.float32)
            nlib.geo_unpack2bit(b, out, orig_len, self.threshold)
            return out
        q = np.empty((len(b), 4), dtype=np.uint8)
        q[:, 0] = b & 3
        q[:, 1] = (b >> 2) & 3
        q[:, 2] = (b >> 4) & 3
        q[:, 3] = (b >> 6) & 3
        q = q.reshape(-1)[:orig_len]
        out = np.zeros(orig_len, dtype=np.float32)
        out[q == 1] = self.threshold
        out[q == 2] = -self.threshold
        return out


def pack_sparse(values: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """[float32 values ‖ int32 indices bit-cast to float32]
    (ref wire layout: gradient_compression.cc:219-269 emits values then
    indices in one buffer)."""
    return np.concatenate([
        values.astype(np.float32),
        indices.astype(np.int32).view(np.float32),
    ])


def unpack_sparse(payload: np.ndarray, *, tag: str = "bsc",
                  key: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    payload = _check_f32_vector(payload, tag, key)
    if len(payload) % 2 != 0:
        raise CodecError(
            f"sparse payload must be [values ‖ indices] (even length, "
            f"got {len(payload)})", tag=tag, key=key)
    k = len(payload) // 2
    values = payload[:k].astype(np.float32)
    indices = payload[k:].view(np.int32).astype(np.int64)
    return values, indices


def pack_rows(row_ids: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Row-sparse wire format: [rows.ravel() ‖ int32 row_ids bit-cast]
    (one definition for the four client/server codec sites)."""
    return np.concatenate([
        np.asarray(rows, np.float32).ravel(),
        np.asarray(row_ids, np.int64).astype(np.int32).view(np.float32),
    ])


def unpack_rows(payload: np.ndarray, cols: int):
    """Inverse of pack_rows → (row_ids int64 [k], rows float32 [k, cols])."""
    if cols < 1:
        raise CodecError(f"row-sparse decode needs cols >= 1, got {cols}",
                         tag="rows")
    payload = _check_f32_vector(payload, "rows", -1)
    if len(payload) % (cols + 1) != 0:
        raise CodecError(
            f"row-sparse payload of {len(payload)} values does not "
            f"split into (row ‖ id) groups of {cols + 1}", tag="rows")
    k = len(payload) // (cols + 1)
    rows = payload[:k * cols].reshape(k, cols).astype(np.float32)
    row_ids = payload[k * cols:].view(np.int32).astype(np.int64)
    return row_ids, rows


def _check_index_bounds(idx: np.ndarray, orig_len: int, tag: str,
                        key: int) -> None:
    """Reject out-of-range scatter indices BEFORE any write: a negative
    int32 from a flipped bit would silently wrap through numpy fancy
    indexing into the wrong coordinate, and the native geo_sparse_add
    would write out of bounds."""
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= orig_len):
        raise CodecError(
            f"scatter index out of range [0, {orig_len}) "
            f"(min {int(idx.min())}, max {int(idx.max())})",
            tag=tag, key=key)


def scatter_sparse(payload: np.ndarray, orig_len: int, *,
                   key: int = -1) -> np.ndarray:
    """Densify a [values ‖ indices] payload (shared by all bsc decoders)."""
    vals, idx = unpack_sparse(payload, key=key)
    _check_index_bounds(idx, orig_len, "bsc", key)
    out = np.zeros(orig_len, dtype=np.float32)
    out[idx] = vals
    return out


class BscCodec(Codec):
    """Bi-Sparse push-direction compressor (DGC-style).

    velocity = m·velocity + grad;  accum += velocity;  threshold from a
    random sample of |accum|;  emit top entries;  zero velocity+accum at
    emitted coordinates (ref: gradient_compression.cc:191-269).
    """

    name = "bsc"

    def __init__(self, ratio: float = 0.01, momentum: float = 0.9,
                 sample_rate: float = 0.005, seed: int = 0):
        import threading

        self.ratio = float(ratio)
        self.momentum = float(momentum)
        self.sample_rate = float(sample_rate)
        self._velocity: Dict[int, np.ndarray] = {}
        self._accum: Dict[int, np.ndarray] = {}
        self._rng = np.random.default_rng(seed)
        # np.random.Generator is not thread-safe; the parallel WAN
        # encode pool compresses different KEYS concurrently (per-key
        # velocity/accum never collide) but they share this sampler
        self._rng_mu = threading.Lock()

    def _threshold(self, arr: np.ndarray) -> float:
        """Sampled |.|-quantile threshold.  Takes the RAW array and
        abs-es only the sample — a full-array np.abs before sampling
        costs a 2x-tensor-size memory pass per push on the 50M hot
        path for values the sample never looks at."""
        n = len(arr)
        sample_n = max(int(n * self.sample_rate), min(n, 64))
        with self._rng_mu:
            idx = self._rng.integers(0, n, size=sample_n)
        sample = np.abs(arr[idx])
        # top `ratio` of the sample ⇒ quantile threshold
        return float(np.quantile(sample, max(0.0, 1.0 - self.ratio)))

    def compress(self, key, arr):
        g = np.ascontiguousarray(arr, dtype=np.float32)
        n = len(g)
        v = self._velocity.get(key)
        u = self._accum.get(key)
        if v is None or len(v) != n:
            v = np.zeros_like(g)
            u = np.zeros_like(g)
        cap = max(1, int(2 * self.ratio * n))
        nlib = _native()
        if nlib is not None:
            nlib.geo_dgc_update(v, u, g, n, self.momentum)  # in place
            thr = self._threshold(u)
            idx = np.empty(cap, dtype=np.int64)
            cnt = nlib.geo_select_threshold(u, n, thr, cap, idx)
            idx = idx[:cnt]
        else:
            v = self.momentum * v + g
            u = u + v
            mag = np.abs(u)
            thr = self._threshold(mag)
            mask = mag >= thr
            if not mask.any():
                mask[np.argmax(mag)] = True  # always send at least one entry
            idx = np.nonzero(mask)[0]
            # the sampled threshold is unstable on narrow magnitude
            # distributions (all-equal gradients would select 100%);
            # hard-cap the payload at 2x the target ratio via exact top-k
            if len(idx) > cap:
                top = np.argpartition(mag[idx], -cap)[-cap:]
                idx = idx[top]
        vals = u[idx]
        v[idx] = 0.0  # momentum factor masking (ref: DGC)
        u[idx] = 0.0
        self._velocity[key] = v
        self._accum[key] = u
        return pack_sparse(vals, idx)

    def decompress(self, key, payload, orig_len):
        return scatter_sparse(payload, orig_len, key=key)

    @property
    def dense_delta(self) -> bool:
        return True


class MpqSelector:
    """Mixed-precision: FP16 for small tensors, BSC for big ones
    (ref: kvstore_dist_server.h:183 MXNET_KVSTORE_SIZE_LOWER_BOUND)."""

    name = "mpq"

    def __init__(self, size_bound: int = 200_000, ratio: float = 0.01,
                 momentum: float = 0.9, sample_rate: float = 0.005):
        self.size_bound = int(size_bound)
        self.fp16 = Fp16Codec()
        self.bsc = BscCodec(ratio=ratio, momentum=momentum,
                            sample_rate=sample_rate)
        # split observability for acceptance runs / QUERY_STATS
        self.bsc_picks = 0
        self.fp16_picks = 0

    def select(self, size: int) -> Codec:
        if size >= self.size_bound:
            self.bsc_picks += 1
            return self.bsc
        self.fp16_picks += 1
        return self.fp16


def _sampled_topk_indices(delta: np.ndarray, ratio: float,
                          rng: np.random.Generator,
                          sample_rate: float = 0.005) -> np.ndarray:
    """Approximate top-|ratio| selection via a sampled quantile
    threshold + one capped scan — the reference's own BSC selection
    scheme (random-sample 0.5%, threshold from the sample, ref:
    gradient_compression.cc:191-269).  ~6x cheaper than the exact
    introselect at the 16.7M MultiGPS shard size (no full-array
    partition; the only full passes are sequential scans), at the cost
    of a payload that floats around the target ratio (hard-capped at
    2x, floor 1 entry)."""
    n = len(delta)
    sample_n = max(int(n * sample_rate), min(n, 64))
    sample = np.abs(delta[rng.integers(0, n, size=sample_n)])
    thr = float(np.quantile(sample, max(0.0, 1.0 - ratio)))
    cap = max(1, int(2 * ratio * n))
    nlib = _native()
    if nlib is not None:
        idx = np.empty(cap, dtype=np.int64)
        cnt = nlib.geo_select_threshold(delta, n, thr, cap, idx)
        if cnt == 0:
            # mirror the numpy fallback's argmax floor: a payload must
            # never be empty (an all-below-threshold scan — e.g. a NaN
            # quantile or float-compare edge — would otherwise ship 0
            # entries from native hosts while numpy hosts ship 1, and
            # the two builds' wire payloads must be identical)
            return np.array([int(np.argmax(np.abs(delta)))], dtype=np.int64)
        return idx[:cnt]
    mag = np.abs(delta)
    idx = np.flatnonzero(mag >= thr)
    if len(idx) == 0:
        return np.array([int(np.argmax(mag))], dtype=np.int64)
    if len(idx) > cap:
        top = np.argpartition(mag[idx], -cap)[-cap:]
        idx = idx[top]
    return idx


class BroadcastCompressor:
    """Pull-direction sparsifier (the second 'Bi' in Bi-Sparse).

    Per (subscriber, key): ship the top-k of (current weights − what the
    subscriber last received), accumulate the remainder as residual, and
    track the subscriber's view so it never desyncs
    (ref: BSCPullCompress kvstore_dist_server.h:1171-1211, :271-308 —
    the reference sparsifies the merged sum serving pulls; the delta+view
    formulation here is the TPU-build's numerically-safe equivalent).
    """

    def __init__(self, ratio: float = 0.01, trust_init: bool = True):
        self.ratio = float(ratio)
        # trust_init: the sparse-from-INIT fast path assumes every fresh
        # subscriber's replica equals the recorded INIT value.  True for
        # a compressor installed at SET_COMPRESSION / overwrite-INIT time
        # (the value was just propagated everywhere); MUST be False when
        # rebuilt from a checkpoint restore — subscribers still hold
        # whatever they last pulled, not the restored weights
        self.trust_init = bool(trust_init)
        self._view: Dict[Tuple[str, int], np.ndarray] = {}
        self._ver: Dict[Tuple[str, int], int] = {}
        self._init_values: Dict[int, np.ndarray] = {}
        # (subscriber, key) -> lineage token.  Two views share content
        # iff they share (lineage, ver): both start at "init" (the
        # propagated INIT value) and advance by the same cached deltas;
        # a dense RESYNC forks the subscriber onto a unique lineage —
        # its version numbers can collide with sparse-path peers'
        # (new_ver = max(echo, tracked)+1), so version alone must NEVER
        # authorize payload sharing (that applies a delta computed
        # against a different base: silent permanent replica corruption)
        self._lineage: Dict[Tuple[str, int], str] = {}
        # key -> (weakref(weights), lineage, ver, vals, idx): one top-k
        # per round serves every same-lineage-and-version subscriber.
        # weakref: a strong ref would pin the previous round's full
        # store array (~200 MB at the 50M hot path) until next compress
        self._payload_cache: Dict[int, tuple] = {}
        self._rng = np.random.default_rng(1234)  # sampled-threshold
        self.resyncs = 0  # forced dense resyncs (observability)

    def ensure_base(self, key: int, init_value: np.ndarray):
        self._init_values[key] = np.array(init_value, copy=True)

    def invalidate_key(self, key: int, new_init: np.ndarray):
        """Overwrite-INIT of ``key``: the new value was just propagated
        to every replica, so drop all subscribers' tracked views/versions
        for THIS key and re-seed its INIT base — echo-0 pulls re-enter
        the sparse-from-INIT path against the propagated value.  Other
        keys' handshake state stays untouched (a full rebuild would
        re-seed their INIT bases from trained weights that echo-0
        subscribers never held)."""
        self.ensure_base(key, new_init)
        self._payload_cache.pop(key, None)
        for pair in [p for p in self._view if p[1] == key]:
            del self._view[pair]
        for pair in [p for p in self._ver if p[1] == key]:
            del self._ver[pair]
        for pair in [p for p in self._lineage if p[1] == key]:
            # every subscriber re-enters sparse-from-INIT against the
            # NEW propagated value: back to the shared "init" lineage
            del self._lineage[pair]

    def drop_subscriber(self, subscriber: str) -> int:
        """Free every tracked view/version/lineage entry of one
        subscriber (a departed party server or an evicted serve
        replica).  Each view pins a full-model copy, so a server that
        never prunes leaks one model per subscriber that ever churned.
        Always SAFE to call on a live subscriber: a pruned pair's next
        pull takes the no-base branch of :meth:`compress` and resyncs
        dense — one extra dense response, never a wrong delta.  Returns
        the number of view arrays freed."""
        n = 0
        for pair in [p for p in self._view if p[0] == subscriber]:
            del self._view[pair]
            n += 1
        for pair in [p for p in self._ver if p[0] == subscriber]:
            del self._ver[pair]
        for pair in [p for p in self._lineage if p[0] == subscriber]:
            del self._lineage[pair]
        return n

    def subscribers(self) -> set:
        """Distinct subscriber ids with any tracked state
        (observability for the prune paths + their tests)."""
        return ({p[0] for p in self._view} | {p[0] for p in self._ver}
                | {p[0] for p in self._lineage})

    def compress(self, subscriber: str, key: int, weights: np.ndarray,
                 echo_ver: int = 0):
        """Encode one pull for ``subscriber``.

        ``echo_ver`` is the view version the subscriber last decoded
        (0 = fresh replica still at the INIT value).  Returns
        ``(payload, tag, new_ver)`` where tag is "bsc" (sparse delta) or
        "f32" (dense resync).  The version handshake is what makes the
        tracked view CRASH-SAFE: a restarted server has no view for the
        (subscriber, key) pair but the subscriber echoes ver>0 → the
        mismatch forces a dense resync instead of a delta against the
        wrong base, which silently corrupts a handful of top-k entries
        (observed: post-restart FSA desync in the 4x4 stress test).  A
        replaced subscriber echoes 0 against a tracked ver>0 — same
        resync.  Lost responses (replayed pulls) also mismatch and heal
        the same way."""
        tracked = self._ver.get((subscriber, key), 0)
        base = self._view.get((subscriber, key))
        if (base is None and tracked == 0 and echo_ver == 0
                and self.trust_init and (key in self._init_values)):
            # fresh pair on a server that has seen INIT: both sides hold
            # the INIT value (overwrite-INITs propagate to every replica
            # before pulls resume), so the first pull can already be
            # sparse.  No recorded INIT value (or a restore-rebuilt
            # compressor, trust_init=False) → dense resync below; a
            # guessed base here would corrupt the replica.
            base = self._init_values[key].copy()
        elif base is None or echo_ver != tracked:
            self.resyncs += 1
            new_ver = max(int(echo_ver), tracked) + 1
            w = np.ascontiguousarray(weights, dtype=np.float32)
            self._view[(subscriber, key)] = w.copy()
            self._ver[(subscriber, key)] = new_ver
            # fork onto a unique lineage: this subscriber's future
            # versions may numerically collide with sparse-path peers',
            # and the payload cache must never treat that as shared
            # content (confirmed corruption: one lost response -> peer's
            # delta applied to the resynced base, permanently wrong)
            self._lineage[(subscriber, key)] = f"resync{self.resyncs}"
            return w, "f32", new_ver
        # same-round payload reuse across subscribers (the 50M MultiGPS
        # hot path, VERDICT r4 item 4): subscribers on the SAME lineage
        # at the SAME version hold bit-identical views (both are INIT
        # plus the identical sequence of cached deltas), so the
        # (vals, idx) computed for the first subscriber of this
        # (weights, lineage, ver) triple serves the rest for the cost
        # of a scatter instead of a full selection scan.  Version alone
        # is NOT sufficient — a resynced subscriber's version collides
        # with sparse-path peers' (see _lineage).  Identity of the
        # weights ARRAY (via weakref, `is`, never id()) scopes the
        # cache to one optimizer round without pinning the old store.
        lineage = self._lineage.get((subscriber, key), "init")
        cached = self._payload_cache.get(key)
        if (cached is not None and cached[0]() is weights
                and cached[1] == lineage and cached[2] == tracked):
            vals, idx = cached[3], cached[4]
        else:
            # asarray, not astype: weights is the (frozen) f32 store
            # array in the hot path; astype would memcpy before the
            # subtract
            delta = np.ascontiguousarray(
                np.asarray(weights, np.float32) - base)
            idx = _sampled_topk_indices(delta, self.ratio, self._rng)
            vals = delta[idx]
            self._payload_cache[key] = (weakref.ref(weights), lineage,
                                        tracked, vals, idx)
        base[idx] += vals
        new_ver = tracked + 1
        self._view[(subscriber, key)] = base
        self._ver[(subscriber, key)] = new_ver
        return pack_sparse(vals, idx.astype(np.int64)), "bsc", new_ver

    @staticmethod
    def decompress_into(store_val: np.ndarray, payload: np.ndarray) -> np.ndarray:
        vals, idx = unpack_sparse(payload)
        _check_index_bounds(idx, len(store_val), "bsc", -1)
        out = np.ascontiguousarray(store_val, dtype=np.float32)
        if np.may_share_memory(out, store_val) or not out.flags.writeable:
            # ascontiguousarray of an already-contiguous same-dtype
            # input ALIASES it — copy only then (we mutate below and
            # must not write the caller's replica), or when the dtype
            # conversion produced a fresh-but-frozen array.  A
            # non-contiguous or non-f32 input already paid its one
            # conversion copy; the old unconditional .copy() stacked a
            # second full-model copy on every subscriber pull.
            out = out.copy()
        nlib = _native()
        if nlib is not None:
            nlib.geo_sparse_add(out, np.ascontiguousarray(vals),
                                np.ascontiguousarray(idx), len(idx))
        else:
            out[idx] += vals
        return out


def make_push_codec(config: dict):
    """Build the push-direction codec (or selector) from a SET_COMPRESSION
    body, e.g. {"type": "bsc", "ratio": 0.01}."""
    typ = config.get("type", "none")
    if typ == "none":
        return None
    if typ == "fp16":
        return Fp16Codec()
    if typ == "2bit":
        return TwoBitCodec(threshold=config.get("threshold", 0.5))
    if typ == "bsc":
        return BscCodec(ratio=config.get("ratio", 0.01),
                        momentum=config.get("momentum", 0.9),
                        sample_rate=config.get("sample_rate", 0.005))
    if typ == "mpq":
        return MpqSelector(size_bound=config.get("size_bound", 200_000),
                           ratio=config.get("ratio", 0.01),
                           momentum=config.get("momentum", 0.9),
                           sample_rate=config.get("sample_rate", 0.005))
    raise ValueError(f"unknown compression type '{typ}'")


# Wire tags a gradient-push payload may legally carry ("" = vanilla
# uncompressed f32).  Receivers fence anything else at message-decode
# time instead of letting a bare ValueError poison the merge path.
KNOWN_PUSH_TAGS = frozenset(("", "fp16", "2bit", "bsc"))

# codecs whose payload semantics survive carrying WEIGHTS instead of
# gradients (HFA rounds exchange party-mean weights; residual-feedback /
# top-k-delta codecs assume a gradient stream and silently corrupt a
# weight exchange)
WEIGHT_SAFE_CODECS = frozenset(("none", "fp16"))


def compression_allowed(codec: str, *, inter_ts: bool = False,
                        hfa: bool = False) -> Tuple[bool, Optional[str]]:
    """THE compatibility matrix for WAN codecs vs. operating modes.

    One predicate shared by static config validation
    (``Config.__post_init__``), the runtime ``SET_COMPRESSION`` /
    ``SET_WAN_POLICY`` command gates, and the adaptive policy engine's
    ladder construction (``geomx_tpu_torch/control/policy.py``) — so the
    rules can never drift.  Returns ``(ok, reason)``; ``reason`` is
    None when allowed.

    ``hfa=True`` is the RUNTIME-ACTUATION context (the adaptive policy
    ladder and SET_WAN_POLICY): under HFA only weight-safe codecs may
    be *switched to*, because the others either do nothing (the HFA K2
    push path bypasses the push codec with dense milestone deltas) or
    would corrupt a weight stream if they ever applied.  A STATIC
    config combining HFA with bsc/mpq stays legal — the HFA data path
    routes around gradient codecs with dense pushes and dense pulls
    (see test_hfa_with_bsc_pull_stays_dense_and_synced) — so config
    validation passes ``hfa=False``."""
    if codec not in ("none", "fp16", "2bit", "bsc", "mpq"):
        return False, f"unknown compression type '{codec}'"
    if inter_ts and codec in ("bsc", "mpq"):
        return False, (
            "enable_inter_ts cannot combine with bsc/mpq pull "
            "compression (per-subscriber sparsified deltas don't fit "
            "a shared relay payload); use fp16 or none")
    if hfa and codec not in WEIGHT_SAFE_CODECS:
        return False, (
            f"'{codec}' is not weight-safe: HFA rounds exchange party-"
            "mean weights, and residual/top-k gradient codecs corrupt a "
            "weight stream; use fp16 or none")
    return True, None


class DecoderBank:
    """Per-endpoint stateful-decoder cache (bounded, LRU).

    Replaces the old module-level ``_TWOBIT_DECODERS`` dict, which was
    shared across every Simulation in one process and unbounded across
    thresholds: two concurrent deployments decoding 2-bit payloads with
    different thresholds hit the same instances, and any future decoder
    that keeps per-key state (residuals, bases) would silently leak one
    run's state into another.  Each receiving server owns one bank."""

    def __init__(self, cap: int = 32):
        import collections
        import threading

        self._cap = int(cap)
        self._decoders: "collections.OrderedDict" = collections.OrderedDict()
        # the parallel decode pool hits one endpoint's bank from
        # several threads; the LRU reorder needs real mutual exclusion
        self._mu = threading.Lock()

    def twobit(self, threshold: float) -> TwoBitCodec:
        key = ("2bit", float(threshold))
        with self._mu:
            dec = self._decoders.get(key)
            if dec is None:
                dec = self._decoders[key] = TwoBitCodec(threshold)
            self._decoders.move_to_end(key)
            while len(self._decoders) > self._cap:
                self._decoders.popitem(last=False)
        return dec

    def clear(self) -> None:
        """Drop all decoder state (a policy-epoch switch installs fresh
        codec parameters; stale residual-bearing decoders must not
        outlive the epoch that created them)."""
        with self._mu:
            self._decoders.clear()


def decompress_payload(compr: str, key: int, payload: np.ndarray,
                       orig_len: int, threshold: float = 0.5,
                       bank: Optional[DecoderBank] = None) -> np.ndarray:
    """Decode by tag (receiver side).  ``bank`` scopes stateful decoders
    to the calling endpoint; without one a fresh (stateless-for-decode)
    codec is used."""
    if compr == "fp16":
        if len(payload) != orig_len:
            raise CodecError(
                f"fp16 payload carries {len(payload)} values for a "
                f"{orig_len}-element tensor", tag="fp16", key=key)
        return payload.astype(np.float32)
    if compr == "bsc":
        return scatter_sparse(payload, orig_len, key=key)
    if compr == "2bit":
        dec = bank.twobit(threshold) if bank is not None \
            else TwoBitCodec(threshold)
        return dec.decompress(key, payload, orig_len)
    raise CodecError(f"unknown compr tag '{compr}'", tag=compr, key=key)
