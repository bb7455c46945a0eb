"""PyTorch merge backend: party aggregation, the server optimizer and the
WAN codecs on the backend's device (CUDA by default), the merge of a big
key spread over device slots when there are several.

The counterpart of the JAX package's ``kvstore/jax_backend.py``:

- each push is **staged exactly once** (one blocking H2D copy of the
  zero-copy recv view; ``h2d_bytes`` counts them) into an f32 device
  tensor, and later pushes fold into it with an in-place ``add_`` — the
  analog of the JAX path's donated-argument accumulate;
- the **mesh rung**: with more than one device slot (``devices``; by
  default every visible card, so one card leaves it off, as one chip
  does in JAX) a key of at least ``_MESH_MIN_ELEMS`` elements spreads
  its round over the slots — contribution i folds into slot ``i % k``
  in arrival order — and the round close reduces across the slots, an
  explicit f32 psum in slot order
  (:func:`geomx_tpu_torch.parallel.mesh.psum`).  ``Config.
  merge_quantized`` routes that reduction through the int8 block
  quantized psum (:func:`~geomx_tpu_torch.parallel.quantized_allreduce.
  quantized_psum_mean` × k), and ``merge_residual`` (default on) keeps a
  per-key, per-slot error-feedback residual
  (:func:`~geomx_tpu_torch.parallel.quantized_allreduce.
  quantized_psum_mean_ef`), reset when k changes.  Slots may share a
  device (``[card] * 4``, ``["cpu"] * 4``);
- the **device-resident optimizer stage**: for plain/momentum SGD, NAG
  and Adam the round close
  keeps weights and moments on the device (:class:`DeviceOptimizer`)
  and host copies happen only at events (pulls, checkpoints,
  replication, handoff), billed to ``d2h_bytes``;
- the **codec stage**: the local tier encodes the WAN push straight from the device accumulator and
  the global tier decodes it to a device tensor the merge seeds
  without re-staging (:class:`CodecStage`).  2-bit encode and decode
  and the DGC update inside the BSC encoder run the hand kernels of
  :mod:`geomx_tpu_torch.ops.quantize` on CUDA tensors.

Row-sparse scatters stay host-side exactly as on the JAX path.

Bit-compatibility: every update mirrors its numpy reference
(:mod:`geomx_tpu_torch.optim.server_opt`) operation for operation —
same op order, f32 scalars, each multiply and add rounded on its own
(separate in-place ops, so nothing contracts into a fused multiply-add)
— so for exact-representable gradients the device trajectory is
bitwise equal to the host one, and a trajectory exported at a snapshot
restores into either engine.

Threads: the servers' lanes share the device's default stream;
:meth:`TorchBackend.materialize`, :meth:`DeviceWeight.host` and
:meth:`CodecStage._wire` synchronize through ``.cpu()``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from geomx_tpu_torch.core.platform import resolve_device
from geomx_tpu_torch.kvstore.backend import (MergeBackend, _accumulate_kernel,
                                             resolve_codec_device,
                                             resolve_merge_backend,
                                             resolve_opt_device)
from geomx_tpu_torch.ops import quantize as _q
from geomx_tpu_torch.ops.quantize import _f32
from geomx_tpu_torch.parallel.mesh import psum, visible_cards
from geomx_tpu_torch.parallel.quantized_allreduce import (
    quantized_psum_mean, quantized_psum_mean_ef)

# below this many elements the mesh reduction loses to a plain add; the
# JAX package's knob, under its name, so the CPU tests can spread small
# keys
_MESH_MIN_ELEMS = int(os.environ.get("GEOMX_MERGE_MESH_MIN_ELEMS",
                                     str(1 << 16)))
# the device slots a backend takes when not given ``devices``: None is
# every visible card (the backend's own device alone on the CPU); tests
# and the card's smoke run set a list, as JAX's tests patch the knob
# above
_MESH_DEVICES: Optional[List] = None


def _indexed(d: torch.device) -> torch.device:
    """``d`` with its card index: a bare ``cuda`` is the current card."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class _DeviceAccum:
    """One key's in-flight round spread over the device slots: one
    pre-reduced part a slot (slot i on ``devices[i]``).  Confined to the
    key's merge lane.  ``key`` anchors the error-feedback residual."""

    __slots__ = ("parts", "elems", "count", "key")

    def __init__(self, part: torch.Tensor, elems: int, key=None):
        self.parts: List[torch.Tensor] = [part]
        self.elems = elems
        self.count = 1
        self.key = key

    @property
    def nbytes(self) -> int:  # device-resident f32 bytes (stats())
        return 4 * self.elems * len(self.parts)

    def tobytes(self) -> bytes:
        """The pending parts as the host bytes a numpy accumulator would
        hold, folded on the host so peeking never perturbs the round."""
        if len(self.parts) == 1:
            return self.parts[0].cpu().numpy().tobytes()
        total = np.zeros(self.elems, np.float32)
        for p in self.parts:
            total += p.cpu().numpy()
        return total.tobytes()


class TorchBackend(MergeBackend):
    """Accumulators are f32 device tensors, one per key's in-flight
    round, confined to the key's merge lane (no lock); a
    :class:`_DeviceAccum` when the round spreads over the device slots;
    a host array when a row-sparse scatter seeded the round."""

    name = "torch"
    # one device stream serializes the work; more lanes only contend
    max_lanes = 4

    def __init__(self, config=None, device=None, devices=None):
        if device is None and config is not None and \
                resolve_merge_backend(config) == "torch:cpu":
            device = "cpu"   # the device the config names
        self.device = resolve_device(device)
        if devices is None:
            devices = _MESH_DEVICES
        if devices is None:
            # the backend's own device first, then the other cards
            devices = [self.device] + (
                [c for c in visible_cards() if c != _indexed(self.device)]
                if self.device.type == "cuda" else [])
        self._devices = [resolve_device(d) for d in devices]
        # slot 0 holds the seed part and the reduced round, on the
        # backend's device: the optimizer and codec stages read it there
        if _indexed(self._devices[0]) != _indexed(self.device):
            raise ValueError(f"device slots {self._devices} do not start "
                             f"on the backend's device {self.device}")
        self._quantized = bool(getattr(config, "merge_quantized", False))
        self._ef = (self._quantized
                    and bool(getattr(config, "merge_residual", True)))
        # per-key error-feedback residual: key -> (slot count, one
        # tensor a slot); mutated only on the key's merge lane
        self._residuals: Dict[int, tuple] = {}
        self._threads = int(getattr(config, "server_merge_threads", 0)
                            or 0)
        # both stages are this backend's device work: turning either off
        # would move it to host numpy while the tensors sit on the card
        if not (resolve_opt_device(config) and resolve_codec_device(config)):
            raise ValueError(
                "the torch backend always runs the optimizer and codec "
                "stages on its device; merge_opt_device / codec_device "
                "off (or GEOMX_MERGE_OPT_DEVICE / GEOMX_CODEC_DEVICE=0, "
                "or deterministic) needs merge_backend='numpy'")
        self._mu = threading.Lock()  # counters (leaf lock)
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.merge_device_ms = 0.0
        self.opt_device_ms = 0.0
        # codec-stage counters: wall spent in codec device work, the
        # wire-ready compressed bytes materialized (the only D2H of the
        # device codec path), and full-tensor bytes that crossed the
        # host boundary for codec work (0 in steady state)
        self.codec_device_ms = 0.0
        self.codec_d2h_bytes = 0
        self.codec_host_bytes = 0

    # ---- staging ------------------------------------------------------------
    def _stage(self, v, copy: bool = False, device=None) -> torch.Tensor:
        """One H2D copy of the (possibly zero-copy wire view) payload,
        f32-promoted, onto ``device`` (the backend's by default).  The
        copy is blocking: a recv buffer may be reused as soon as this
        returns, and a non-blocking copy from pageable memory would race
        it.  A payload that is already a device tensor (the codec
        stage's decode output) stages for free; ``copy`` forces a
        private buffer (a non-donated seed)."""
        device = self.device if device is None else device
        if isinstance(v, torch.Tensor):
            return v.to(device, torch.float32, copy=copy)
        arr = np.ascontiguousarray(v, dtype=np.float32)
        staged = torch.from_numpy(arr).to(device, copy=copy)
        with self._mu:
            self.h2d_bytes += arr.nbytes
        return staged

    def seed(self, v, donated: bool, key=None):
        # a host payload is always copied (on the CPU device too: the
        # accumulator is mutated in place and must never alias the wire
        # buffer); a device payload is adopted only when donated
        t0 = time.perf_counter()
        acc = self._stage(v, copy=not (donated
                                       and isinstance(v, torch.Tensor)))
        if len(self._devices) > 1 and acc.shape[0] >= _MESH_MIN_ELEMS:
            acc = _DeviceAccum(acc, int(acc.shape[0]), key)
        self._bill(t0)
        return acc

    def accumulate(self, acc, v):
        if isinstance(acc, np.ndarray):
            # a row-sparse scatter seeded this key host-side: stay on
            # the host kernel for the rest of the round
            _accumulate_kernel()(acc, np.ascontiguousarray(v, np.float32),
                                 self._threads)
            return acc
        t0 = time.perf_counter()
        if isinstance(acc, _DeviceAccum):
            # contribution i folds into slot i % k in arrival order; the
            # round close reduces ACROSS the slots
            slot = acc.count % len(self._devices)
            dev = self._devices[slot]
            if slot < len(acc.parts):
                acc.parts[slot].add_(self._stage(v, device=dev))
            else:
                acc.parts.append(self._stage(v, copy=True, device=dev))
            acc.count += 1
        else:
            acc.add_(self._stage(v))
        self._bill(t0)
        return acc

    def _reduced(self, acc):
        """The round's sum as one tensor on the backend's device: a
        spread round reduced across its slots (exact psum, or the int8
        rung × k, with the key's residual under ``merge_residual``)."""
        if not isinstance(acc, _DeviceAccum):
            return acc
        parts, k = acc.parts, len(acc.parts)
        if k == 1:
            return parts[0]
        if not self._quantized:
            out = psum(parts)[0]
        elif self._ef and acc.key is not None:
            means, res = quantized_psum_mean_ef(
                parts, self._residual_for(acc.key, k, acc.elems))
            self._residuals[acc.key] = (k, res)
            # the quantized mean × k is the party SUM the round close
            # expects; the residual is in that sum's domain already
            out = means[0] * _f32(k)
        else:
            out = quantized_psum_mean(parts)[0] * _f32(k)
        # reduced once: a later read (round_value, then materialize)
        # must not reduce, or move the residual, again
        acc.parts = [out]
        return out

    def _residual_for(self, key, k: int, elems: int) -> List[torch.Tensor]:
        """The key's per-slot residual, zeros when the slot count (or the
        length) changed: a party fold reshapes the round, and a residual
        kept for another k would compensate the wrong shards."""
        ent = self._residuals.get(key)
        if ent is not None and ent[0] == k and ent[1][0].shape[0] == elems:
            return ent[1]
        return [torch.zeros(elems, dtype=torch.float32, device=d)
                for d in self._devices[:k]]

    # ---- round close --------------------------------------------------------
    def scale(self, acc, s: float):
        if isinstance(acc, np.ndarray):
            np.multiply(acc, s, out=acc)
            return acc
        t0 = time.perf_counter()
        acc = self._reduced(acc).mul_(_f32(s))
        self._bill(t0)
        return acc

    def materialize(self, acc) -> np.ndarray:
        if isinstance(acc, np.ndarray):
            return acc
        t0 = time.perf_counter()
        # sync + one D2H (a view on cpu)
        host = self._reduced(acc).cpu().numpy()
        with self._mu:
            self.d2h_bytes += host.nbytes
        self._bill(t0)
        return host

    def screen_finite(self, v, mag_max: float = 0.0) -> bool:
        """Device screen: one fused reduction, one bool back."""
        if isinstance(v, torch.Tensor):
            x = v.float()
        else:  # the screen is not a staging copy: not billed
            x = torch.from_numpy(np.ascontiguousarray(
                v, dtype=np.float32)).to(self.device)
        if mag_max > 0.0:
            return bool((x.abs() <= _f32(mag_max)).all())
        return bool(torch.isfinite(x).all())

    # ---- stages -------------------------------------------------------------
    def make_codec_stage(self, config):
        """The :class:`CodecStage` (always on: checked at construction)."""
        return CodecStage(self)

    def make_device_optimizer(self, spec: dict):
        """A :class:`DeviceOptimizer` for ``spec`` when the type is in the
        supported family, else None (the host optimizer keeps it)."""
        cls = _DEVICE_OPTS.get(str(spec.get("type", "")).lower())
        if cls is None:
            return None
        return cls(self, spec)

    # ---- observability ------------------------------------------------------
    def _bill(self, t0: float) -> None:
        dt = (time.perf_counter() - t0) * 1e3
        with self._mu:
            self.merge_device_ms += dt

    def _bill_opt(self, t0: float) -> None:
        dt = (time.perf_counter() - t0) * 1e3
        with self._mu:
            self.opt_device_ms += dt

    def _bill_d2h(self, nbytes: int) -> None:
        with self._mu:
            self.d2h_bytes += int(nbytes)

    def stats(self) -> dict:
        with self._mu:
            return {"merge_backend": self.name,
                    "merge_device": self.device.type,
                    "merge_devices": len(self._devices),
                    "merge_quantized": self._quantized,
                    "merge_residual": self._ef,
                    "merge_opt_device": True,
                    "merge_device_ms": round(self.merge_device_ms, 3),
                    "opt_device_ms": round(self.opt_device_ms, 3),
                    "codec_device_ms": round(self.codec_device_ms, 3),
                    "codec_d2h_bytes": self.codec_d2h_bytes,
                    "codec_host_bytes": self.codec_host_bytes,
                    "h2d_bytes": self.h2d_bytes,
                    "d2h_bytes": self.d2h_bytes}


class DeviceWeight:
    """One key's weights, device-resident between round closes.  Host
    consumers go through :meth:`host` — at most one D2H per round close,
    billed to ``d2h_bytes``.  Updates never write the weight tensor in
    place: an in-flight pull response may alias a previous ``host()``
    view (on the CPU device it IS the tensor's memory)."""

    __slots__ = ("ref", "_be", "_host")

    def __init__(self, be: TorchBackend, ref: torch.Tensor):
        self.ref = ref
        self._be = be
        self._host: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        return int(self.ref.nbytes)

    def __len__(self) -> int:
        return int(self.ref.shape[0])

    def host(self) -> np.ndarray:
        if self._host is None:
            h = self.ref.cpu().numpy()
            self._be._bill_d2h(h.nbytes)
            self._host = h
        return self._host


class DeviceOptimizer:
    """Device-resident optimizer stage: per-key state as device tensors,
    one round close = one update over the device accumulator.  The
    gradient and state buffers are updated in place (they are owned by
    the stage); the weights are replaced, never written.  :meth:`step`
    runs only on the key's merge lane; the snapshot hooks run under the
    server's all-stripes barrier."""

    kind = "abstract"

    def __init__(self, be: TorchBackend, spec: dict):
        self._be = be
        self.spec = dict(spec)
        self.lr = float(spec.get("lr", 0.01))
        self.wd = float(spec.get("wd", 0.0))
        self._st: Dict[int, dict] = {}

    # ---- hot path -----------------------------------------------------------
    def step(self, k: int, raw_w, accum, scale: float) -> DeviceWeight:
        """``ServerOptimizer.update_scaled(k, weight, accum, scale)`` with
        everything on the device."""
        t0 = time.perf_counter()
        w = self._weight_ref(raw_w)
        g = self._grad_ref(accum)
        new = self._update(k, w, g, float(scale))
        self._be._bill_opt(t0)
        return DeviceWeight(self._be, new)

    def add_delta(self, raw_w, accum) -> DeviceWeight:
        """HFA milestone-delta close: ``weight + accum`` (pre-divided)."""
        t0 = time.perf_counter()
        new = self._weight_ref(raw_w) + self._grad_ref(accum)
        self._be._bill_opt(t0)
        return DeviceWeight(self._be, new)

    def _weight_ref(self, raw) -> torch.Tensor:
        if isinstance(raw, DeviceWeight):
            return raw.ref
        return self._be._stage(np.ascontiguousarray(raw, np.float32),
                               copy=True)

    def _grad_ref(self, accum) -> torch.Tensor:
        # the device accumulator is the round's own (updated in place);
        # a host-seeded (row-sparse) round pays one billed H2D copy
        if isinstance(accum, (torch.Tensor, _DeviceAccum)):
            return self._be._reduced(accum)
        return self._be._stage(accum, copy=True)

    def _update(self, k: int, w, g, scale: float):
        raise NotImplementedError

    # ---- snapshot hooks -----------------------------------------------------
    def export_state(self):
        """The equivalent host :class:`ServerOptimizer` with all per-key
        state materialized (one billed D2H per state tensor)."""
        from geomx_tpu_torch.optim import make_optimizer

        opt = make_optimizer(dict(self.spec))
        for k, st in self._st.items():
            out = {}
            for name, v in st.items():
                if isinstance(v, torch.Tensor):
                    h = v.cpu().numpy().copy()  # own the copy (pickled)
                    self._be._bill_d2h(h.nbytes)
                    out[name] = h
                else:
                    out[name] = v
            opt.state[k] = out
        return opt

    def import_state(self, opt) -> None:
        """Adopt a restored host optimizer's per-key state wholesale."""
        self._st.clear()
        for k, st in getattr(opt, "state", {}).items():
            self.import_key(int(k), st)

    def import_key(self, k: int, st: dict) -> None:
        """Adopt one key's host state (HANDOFF range merge)."""
        out = {}
        for name, v in st.items():
            if isinstance(v, np.ndarray):
                out[name] = self._be._stage(v, copy=True)
            else:
                out[name] = v
        self._st[k] = out

    def drop_key(self, k: int) -> None:
        """Discard one key's trajectory."""
        self._st.pop(k, None)

    def stats(self) -> dict:
        return {"opt_device": self.kind, "opt_device_keys": len(self._st)}

    def state_summary(self) -> str:
        """``opt_device_keys=N opt_state_on=DEVICES opt_steps=LO..HI``:
        how many keys hold state, the devices their tensors sit on, and
        the range of Adam's step counter (a host int), for the exit and
        restore lines of a launched server."""
        on = sorted({str(v.device) for st in self._st.values()
                     for v in st.values() if isinstance(v, torch.Tensor)})
        steps = sorted(st["t"] for st in self._st.values() if "t" in st)
        out = (f"opt_device_keys={len(self._st)} "
               f"opt_state_on={','.join(on) or '-'}")
        if steps:
            out += f" opt_steps={steps[0]}..{steps[-1]}"
        return out


class DeviceSgd(DeviceOptimizer):
    kind = "sgd"

    def __init__(self, be, spec):
        super().__init__(be, spec)
        self.momentum = float(spec.get("momentum", 0.0))

    def _update(self, k, w, g, scale):
        if self.momentum == 0.0 and self.wd == 0.0:
            # numpy Sgd.update_scaled's fast path: g·c + w with
            # c = f32(-(lr·scale)), built in the accumulator
            return g.mul_(_f32(-(self.lr * scale))).add_(w)
        g.mul_(_f32(scale)).add_(w * _f32(self.wd))
        if self.momentum == 0.0:
            return w - g.mul_(_f32(self.lr))
        st = self._st.get(k)
        if st is None:
            st = {"mom": torch.zeros_like(w)}
            self._st[k] = st
        st["mom"].mul_(_f32(self.momentum)).sub_(g.mul_(_f32(self.lr)))
        return w + st["mom"]


class DeviceNag(DeviceOptimizer):
    kind = "nag"

    def __init__(self, be, spec):
        super().__init__(be, spec)
        self.momentum = float(spec.get("momentum", 0.9))

    def _update(self, k, w, g, scale):
        st = self._st.get(k)
        if st is None:
            st = {"mom": torch.zeros_like(w)}
            self._st[k] = st
        m = _f32(self.momentum)
        g.mul_(_f32(scale)).add_(w * _f32(self.wd))
        mom = st["mom"].mul_(m).add_(g)
        return w - g.add_(mom * m).mul_(_f32(self.lr))


class DeviceAdam(DeviceOptimizer):
    kind = "adam"

    def __init__(self, be, spec):
        super().__init__(be, spec)
        self.beta1 = float(spec.get("beta1", 0.9))
        self.beta2 = float(spec.get("beta2", 0.999))
        self.eps = float(spec.get("eps", 1e-8))

    def _update(self, k, w, g, scale):
        st = self._st.get(k)
        if st is None:
            st = {"m": torch.zeros_like(w), "v": torch.zeros_like(w),
                  "t": 0}
            self._st[k] = st
        st["t"] += 1
        g.mul_(_f32(scale)).add_(w * _f32(self.wd))
        st["m"].mul_(_f32(self.beta1)).add_(g * _f32(1 - self.beta1))
        st["v"].mul_(_f32(self.beta2)).add_(
            (g * _f32(1 - self.beta2)).mul_(g))
        # bias corrections computed host-side in f64 then f32-cast —
        # the weak-scalar cast numpy applies to the division
        mhat = _div_rn(st["m"], 1 - self.beta1 ** st["t"])
        vhat = _div_rn(st["v"], 1 - self.beta2 ** st["t"])
        return w - mhat.mul_(_f32(self.lr)).div_(
            _sqrt_rn_(vhat).add_(_f32(self.eps)))


def _div_rn(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` rounded to nearest, ``c`` cast to f32 as numpy casts a
    Python float.  On CUDA torch divides by a host scalar as a multiply
    by its reciprocal, which rounds twice; a 0-dim tensor on ``t``'s
    device (filled there, no host copy) is divided elementwise."""
    return t / torch.full((), _f32(c), dtype=torch.float32, device=t.device)


def _sqrt_rn_(t: torch.Tensor) -> torch.Tensor:
    """``t.sqrt_()`` rounded to nearest, as IEEE (and numpy, and XLA)
    round it.  CUDA's square root is; torch's vectorised CPU kernel is
    not (AVX-512: about 0.6 % of f32 values one ulp off), so on the host
    the tensor's own memory goes through numpy's."""
    if t.device.type == "cpu":
        a = t.numpy()
        np.sqrt(a, out=a)
        return t
    return t.sqrt_()


_DEVICE_OPTS = {"sgd": DeviceSgd, "nag": DeviceNag, "adam": DeviceAdam}


class CodecStage:
    """Device-resident WAN codec engine, one per server when the codec
    stage resolves on.  The LOCAL tier builds the push family with
    :meth:`make_push_codec` — encode reads the device accumulator and
    materializes only the wire-ready compressed payload (billed to
    ``codec_d2h_bytes``); the GLOBAL tier uses :meth:`decode` — the
    structural gates of :mod:`geomx_tpu_torch.compression.codecs` run on
    the small host payload first (same typed :class:`CodecError`, never
    an out-of-bounds scatter), then the device lands the gradient as a
    tensor that :meth:`TorchBackend.seed` adopts without re-staging.

    Wire frames are those of the host codecs: fp16 and 2bit encoders
    emit byte-identical frames for identical state; the BSC encoder
    picks its support by exact ``torch.topk`` (k = ratio·n) under the
    same ``[f32 values ‖ int32 indices bit-cast to f32]`` layout, and
    every decoder reconstructs any legal frame bitwise identically."""

    device = True

    def __init__(self, be: TorchBackend):
        self._be = be
        self.dev = be.device

    # ---- residency helpers (server-side seam) -------------------------------
    def is_device(self, v) -> bool:
        return isinstance(v, torch.Tensor)

    def round_value(self, accum):
        """The completed round as one device tensor, without the host
        materialization ``MergeBackend.materialize`` would pay."""
        if isinstance(accum, _DeviceAccum):
            return self._be._reduced(accum)
        return accum  # a device tensor; host-seeded rounds pass through

    def concat(self, vs):
        """Multi-key round packing on the device."""
        return torch.cat([torch.as_tensor(v, dtype=torch.float32,
                                          device=self.dev) for v in vs])

    def to_host(self, v) -> np.ndarray:
        """Full-tensor D2H for the fallback event paths, billed to
        ``codec_host_bytes``."""
        host = v.cpu().numpy()
        with self._be._mu:
            self._be.codec_host_bytes += host.nbytes
        return host

    def _ensure_device(self, arr) -> torch.Tensor:
        """Encoder input: device tensors pass through; a host array pays
        one H2D, billed as a codec host copy."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.dev, torch.float32)
        host = np.ascontiguousarray(arr, dtype=np.float32)
        with self._be._mu:
            self._be.codec_host_bytes += host.nbytes
        return torch.from_numpy(host).to(self.dev, copy=True)

    def _wire(self, payload: torch.Tensor) -> np.ndarray:
        """The single D2H of the device encode path: the compressed
        frame as the wire-ready host buffer (senders ship it donated and
        never mutate it)."""
        host = payload.cpu().numpy()
        with self._be._mu:
            self._be.codec_d2h_bytes += host.nbytes
        return host

    def _bill(self, t0: float) -> None:
        dt = (time.perf_counter() - t0) * 1e3
        with self._be._mu:
            self._be.codec_device_ms += dt

    # ---- push-codec factory (sender side) -----------------------------------
    def make_push_codec(self, config: dict):
        """Device analog of
        :func:`geomx_tpu_torch.compression.make_push_codec`: same config
        schema, same ValueError on unknown types."""
        typ = config.get("type", "none")
        if typ == "none":
            return None
        if typ == "fp16":
            return DeviceFp16Codec(self)
        if typ == "2bit":
            return DeviceTwoBitCodec(
                self, threshold=config.get("threshold", 0.5))
        if typ == "bsc":
            return DeviceBscCodec(self, ratio=config.get("ratio", 0.01),
                                  momentum=config.get("momentum", 0.9))
        if typ == "mpq":
            return DeviceMpqSelector(
                self, size_bound=config.get("size_bound", 200_000),
                ratio=config.get("ratio", 0.01),
                momentum=config.get("momentum", 0.9))
        raise ValueError(f"unknown compression type '{typ}'")

    # ---- decode (receiver side) ---------------------------------------------
    def decode(self, compr: str, key: int, payload: np.ndarray,
               orig_len: int, threshold: float = 0.5) -> torch.Tensor:
        """Tag-dispatched decode to a DEVICE f32 tensor — drop-in for
        :func:`geomx_tpu_torch.compression.decompress_payload`, with the
        same structural gates run host-side before any device work."""
        from geomx_tpu_torch.compression.codecs import (CodecError,
                                                        _check_index_bounds,
                                                        unpack_sparse)

        t0 = time.perf_counter()
        n = int(orig_len)
        if compr == "fp16":
            if len(payload) != n:
                raise CodecError(
                    f"fp16 payload carries {len(payload)} values for a "
                    f"{n}-element tensor", tag="fp16", key=key)
            p = np.ascontiguousarray(payload, np.float16)
            out = torch.from_numpy(p).to(self.dev).float()
        elif compr == "bsc":
            vals, idx = unpack_sparse(payload, key=key)
            _check_index_bounds(idx, n, "bsc", key)
            out = torch.zeros(n, dtype=torch.float32, device=self.dev)
            out[torch.from_numpy(idx.astype(np.int64)).to(self.dev)] = \
                torch.from_numpy(np.ascontiguousarray(vals)).to(self.dev)
        elif compr == "2bit":
            b = np.ascontiguousarray(payload, dtype=np.uint8)
            if len(b) < (n + 3) // 4:
                raise CodecError(
                    f"2bit payload holds {len(b) * 4} codes for a "
                    f"{n}-element tensor", tag="2bit", key=key)
            out = _q.dequantize_2bit(torch.from_numpy(b).to(self.dev), n,
                                     threshold, "consecutive")
        else:
            raise CodecError(f"unknown compr tag '{compr}'", tag=compr,
                             key=key)
        self._bill(t0)
        return out


class DeviceCodec:
    """Push-direction device codec base: the duck-typed surface of
    :class:`geomx_tpu_torch.compression.codecs.Codec` (``name`` /
    ``compress`` / ``decompress`` / ``dense_delta``) plus ``device``.
    ``compress`` takes a device tensor (the hot path) or a host array
    and returns the wire-ready HOST payload; it never writes its input
    (it may alias an in-flight view), only stage-private state."""

    device = True
    name = "abstract"

    def __init__(self, stage: CodecStage):
        self._stage = stage

    @property
    def dense_delta(self) -> bool:
        return False


class DeviceFp16Codec(DeviceCodec):
    name = "fp16"

    def compress(self, key, arr):
        t0 = time.perf_counter()
        out = self._stage._ensure_device(arr).to(torch.float16)
        self._stage._bill(t0)
        return self._stage._wire(out)

    def decompress(self, key, payload, orig_len):
        return self._stage.decode("fp16", key, payload, orig_len)


class DeviceTwoBitCodec(DeviceCodec):
    """{−t, 0, +t} with a device-resident per-key residual, 4 codes a
    byte exactly like the numpy/native encoders (the quantize kernel in
    the consecutive layout on CUDA): for identical residual state the
    frame is byte-identical."""

    name = "2bit"

    def __init__(self, stage, threshold: float = 0.5):
        super().__init__(stage)
        self.threshold = float(threshold)
        self._residual: Dict[int, torch.Tensor] = {}

    def compress(self, key, arr):
        t0 = time.perf_counter()
        g = self._stage._ensure_device(arr).contiguous()
        n = int(g.shape[0])
        r = self._residual.get(key)
        if r is None or int(r.shape[0]) != n:
            r = torch.zeros(n, dtype=torch.float32, device=g.device)
        packed, self._residual[key] = _q.quantize_2bit(
            g, r, self.threshold, "consecutive")
        self._stage._bill(t0)
        return self._stage._wire(packed)

    def decompress(self, key, payload, orig_len):
        return self._stage.decode("2bit", key, payload, orig_len,
                                  self.threshold)


class DeviceBscCodec(DeviceCodec):
    """DGC-style Bi-Sparse push compressor on the device: the DGC kernel
    updates velocity and accumulated mass, exact ``torch.topk`` over
    |accum| picks the support (k = ratio·n, floor 1), and the sent
    coordinates are zeroed.  Same ``[f32 values ‖ int32 indices
    bit-cast to f32]`` frame as :class:`BscCodec`."""

    name = "bsc"

    def __init__(self, stage, ratio: float = 0.01,
                 momentum: float = 0.9):
        super().__init__(stage)
        self.ratio = float(ratio)
        self.momentum = float(momentum)
        self._velocity: Dict[int, torch.Tensor] = {}
        self._accum: Dict[int, torch.Tensor] = {}

    def compress(self, key, arr):
        t0 = time.perf_counter()
        g = self._stage._ensure_device(arr).contiguous()
        n = int(g.shape[0])
        v = self._velocity.get(key)
        u = self._accum.get(key)
        if v is None or int(v.shape[0]) != n:
            v = torch.zeros(n, dtype=torch.float32, device=g.device)
            u = torch.zeros(n, dtype=torch.float32, device=g.device)
        # in place, as the host BscCodec updates them
        _q.dgc_update(v, u, g, self.momentum, out=(v, u))
        k = max(1, int(self.ratio * n))
        idx = torch.topk(u.abs(), k).indices
        vals = u[idx]
        v[idx] = 0.0  # momentum factor masking (DGC)
        u[idx] = 0.0
        wire = torch.cat([vals, idx.to(torch.int32).view(torch.float32)])
        self._velocity[key] = v
        self._accum[key] = u
        self._stage._bill(t0)
        return self._stage._wire(wire)

    def decompress(self, key, payload, orig_len):
        return self._stage.decode("bsc", key, payload, orig_len)

    @property
    def dense_delta(self) -> bool:
        return True


def _mpq_base():
    from geomx_tpu_torch.compression.codecs import MpqSelector

    return MpqSelector


class DeviceMpqSelector(_mpq_base()):
    """Mixed precision over the DEVICE family: the numpy
    :class:`MpqSelector`'s ``size_bound`` split and pick counters (it
    subclasses it, so the server's ``isinstance`` dispatch keeps
    working) with both rungs swapped for their device versions."""

    device = True

    def __init__(self, stage, size_bound: int = 200_000,
                 ratio: float = 0.01, momentum: float = 0.9):
        super().__init__(size_bound=size_bound, ratio=ratio,
                         momentum=momentum)
        self.fp16 = DeviceFp16Codec(stage)
        self.bsc = DeviceBscCodec(stage, ratio=ratio, momentum=momentum)
