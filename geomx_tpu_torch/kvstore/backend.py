"""Pluggable merge backends for the server aggregation lanes.

Both server tiers accumulate gradient pushes per key on their
``ShardExecutor`` lanes (kvstore/common.py).  The MERGE itself —
first-push accumulator seeding, ``acc += v``, the weighted mean at
round close — is delegated to a :class:`MergeBackend` so the same lane
machinery can run host-side (numpy + the native threaded axpy, the
default and the semantic reference) or on an accelerator
(:mod:`geomx_tpu_torch.kvstore.torch_backend`: one staged H2D copy + in-place
device accumulate).

Contract every backend honors:

- **dtype promotion**: the accumulator is float32 whatever the push
  payload dtype (f16 pushes promote on the first touch — the same rule
  ``_adopt_or_copy`` always enforced).
- **donated-buffer adopt**: a push whose ``Message.donated`` flag
  transfers ownership may be adopted as the accumulator without a copy
  (numpy path) or consumed by the single staged H2D copy (torch path);
  a NON-donated payload is never aliased or mutated.
- **opaque accumulator**: ``_KeyState.accum`` holds whatever
  :meth:`MergeBackend.seed` returned; the only operations the servers
  apply to it are the backend's own methods plus ``.nbytes`` (memory
  accounting).  Paths that need a host array (optimizer update, WAN
  pack, row-sparse scatter) call :meth:`MergeBackend.materialize`.

``NumpyBackend`` is extracted verbatim from the pre-backend server hot
loop and stays the semantic reference: with it, every merge is
bit-identical to the JAX package's host path and the ``deterministic``
suite is unaffected (deterministic mode FORCES numpy — device dispatch
order is not replayable).  ``auto`` resolves to the torch backend.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from geomx_tpu_torch.native.bindings import accumulate as _native_accumulate


def _adopt_or_copy(v: np.ndarray, donated: bool) -> np.ndarray:
    """First-push accumulator seed: adopt the wire buffer when the sender
    transferred ownership (``Message.donated``) and it is mutable;
    otherwise take the defensive copy — in-proc delivery is by reference,
    so a non-donated payload may alias the sender's live data, and a
    frozen payload is an immutability promise to OTHER aliases."""
    acc = np.ascontiguousarray(v, dtype=np.float32)
    if donated and acc.flags.writeable:
        return acc
    if np.may_share_memory(acc, v):
        acc = acc.copy()  # never alias (or mutate) the wire buffer
    return acc


class MergeBackend:
    """One server's merge engine (one instance per server; its methods
    run concurrently from that server's merge lanes, each key confined
    to one lane).

    ``max_lanes`` caps the server's lane count when the backend cannot
    merge more streams in parallel than that (a single device stream
    serializes dispatch; extra lanes only add contention) — ``None``
    leaves :func:`geomx_tpu_torch.kvstore.common.resolve_server_shards`
    alone."""

    name = "abstract"
    max_lanes: Optional[int] = None

    def seed(self, v: np.ndarray, donated: bool, key: Optional[int] = None):
        """First push of a round: build and return the accumulator
        (f32-promoted; adopt ``v`` only under the donation contract).
        ``key`` is the ps-key the round belongs to — backends that keep
        cross-round per-key state (the quantized rung's error-feedback
        residual) key it here; the numpy path ignores it."""
        raise NotImplementedError

    def accumulate(self, acc, v: np.ndarray):
        """Merge one push into the accumulator; returns the (possibly
        replaced) accumulator handle."""
        raise NotImplementedError

    def scale(self, acc, s: float):
        """In-place weighted mean at round close (the HFA convex
        renormalization); returns the accumulator handle."""
        raise NotImplementedError

    def materialize(self, acc) -> np.ndarray:
        """The accumulator as a host f32 ndarray the server owns (the
        identity on the numpy path — NO copy; a device sync + one D2H
        on an accelerator path)."""
        raise NotImplementedError

    def stats(self) -> dict:
        """Observability: merged into the server's QUERY_STATS body."""
        return {"merge_backend": self.name}

    def screen_finite(self, v: np.ndarray, mag_max: float = 0.0) -> bool:
        """Gradient-hygiene screen (Config.integrity_push_screen): True
        iff every element of the push payload is finite — and, when
        ``mag_max`` > 0, within ``[-mag_max, mag_max]``.  The host
        reference is one fused pass; accelerator backends override with
        a jitted device reduction so the screen ships one scalar back
        instead of the tensor."""
        if mag_max > 0.0:
            with np.errstate(invalid="ignore"):
                return bool((np.abs(v) <= mag_max).all())
        return bool(np.isfinite(v).all())

    def make_device_optimizer(self, spec: dict):
        """Optimizer stage of the round close: return a device-resident
        optimizer for ``spec`` (a ``make_optimizer`` config dict), or
        None when this backend keeps the optimizer on the host (the
        numpy path always does; the torch path returns one for the
        supported family when ``merge_opt_device`` is on).  The server
        treats a non-None return as "this backend closes rounds without
        materializing": weights + moments stay device-resident and host
        copies happen only at serve/checkpoint/handoff events (see
        :class:`geomx_tpu_torch.kvstore.torch_backend.DeviceOptimizer` for the
        full contract, including ``export_state``/``import_state`` —
        the hooks every snapshot path goes through so the trajectory
        survives failover and reassignment)."""
        return None

    def make_codec_stage(self, config):
        """Codec stage of the WAN path: return a device-resident codec
        engine for ``config`` (push-compression + decode kernels), or
        None when this backend keeps the codecs on the host (the numpy
        path always does; the torch path returns one when
        ``codec_device`` resolves on — see
        :func:`resolve_codec_device`).  The servers treat a non-None
        return as "encode may read the device accumulator directly and
        decode may land device arrays": the encode side materializes
        only the wire-ready compressed payload, the decode side feeds
        ``seed``/``accumulate`` a device array the backend recognizes
        without re-staging.  Wire frames are bit-identical to the
        :mod:`geomx_tpu_torch.compression.codecs` reference in both
        directions (cross-decode parity is part of the contract)."""
        return None

    def stop(self) -> None:  # release device handles, if any
        pass


def _accumulate_kernel():
    """The threaded host accumulate, resolved late through the server
    module when it is loaded: ``tests/test_sharded_merge`` wedges a
    lane by rebinding ``kvstore.server._native_accumulate``, and that
    published patch point must keep working now the call site lives
    here."""
    srv = sys.modules.get("geomx_tpu_torch.kvstore.server")
    if srv is not None:
        return srv._native_accumulate
    return _native_accumulate


class NumpyBackend(MergeBackend):
    """The host merge path, verbatim from the pre-backend server hot
    loop: adopt-or-copy seed, native threaded axpy accumulate (numpy
    fallback inside the binding), ``np.multiply(..., out=)`` scale.
    Bit-identical to HEAD by construction — zero-copy recv views flow
    straight into the accumulator, no host copy is added anywhere."""

    name = "numpy"

    def __init__(self, config=None):
        self._threads = int(getattr(config, "server_merge_threads", 0)
                            or 0)

    def seed(self, v: np.ndarray, donated: bool,
             key: Optional[int] = None) -> np.ndarray:
        return _adopt_or_copy(v, donated)

    def accumulate(self, acc: np.ndarray, v: np.ndarray) -> np.ndarray:
        # native threaded merge for big tensors (the server hot loop;
        # ref: kvstore_dist_server.h:1277-1296)
        _accumulate_kernel()(acc, np.ascontiguousarray(v, np.float32),
                             self._threads)
        return acc

    def scale(self, acc: np.ndarray, s: float) -> np.ndarray:
        np.multiply(acc, s, out=acc)
        return acc

    def materialize(self, acc) -> np.ndarray:
        return acc  # row-sparse scatters hand host arrays through too


def resolve_merge_backend(config) -> str:
    """The effective backend for a server: ``Config.merge_backend``
    (``auto`` | ``numpy`` | ``torch``, or ``torch:cpu`` for a host run of
    the torch backend), with ``GEOMX_MERGE_BACKEND`` as the env fallback
    for directly-constructed Configs.  Returns ``"numpy"``, ``"torch"``
    or ``"torch:cpu"``.  Rules:

    - ``deterministic`` FORCES numpy — device dispatch completion order
      is not replayable run-to-run.
    - ``auto`` is ``torch`` on its default device (CUDA): the port runs
      its merge lanes on the card, and a host without CUDA raises at
      construction instead of quietly merging on the CPU.  A CPU run
      asks for it by name (``torch:cpu``) or keeps ``numpy``."""
    if getattr(config, "deterministic", False):
        return "numpy"
    choice = (getattr(config, "merge_backend", "") or "").strip().lower()
    if choice in ("", "auto"):
        env = os.environ.get("GEOMX_MERGE_BACKEND", "").strip().lower()
        choice = env or "auto"
    if choice == "auto":
        return "torch"
    if choice in ("numpy", "torch", "torch:cpu"):
        return choice
    raise ValueError(
        f"unknown merge_backend {choice!r} (auto|numpy|torch|torch:cpu)")


def resolve_opt_device(config) -> bool:
    """Whether the torch backend should run the device-resident optimizer
    stage: ``Config.merge_opt_device`` (default on), with
    ``GEOMX_MERGE_OPT_DEVICE`` honored as the env override for
    directly-constructed Configs (so a whole suite can pin the stage
    off the way GEOMX_MERGE_BACKEND pins the lanes on).  Irrelevant
    under the numpy backend — the host optimizer is the only stage."""
    if not bool(getattr(config, "merge_opt_device", True)):
        return False
    env = os.environ.get("GEOMX_MERGE_OPT_DEVICE", "").strip().lower()
    if env:
        return env not in ("0", "false", "no", "off")
    return True


def resolve_codec_device(config) -> bool:
    """Whether the torch backend should run the device-resident WAN codec
    stage: ``Config.codec_device`` (default on), with
    ``GEOMX_CODEC_DEVICE`` honored as the env override for
    directly-constructed Configs (same fallback idiom as
    GEOMX_MERGE_OPT_DEVICE).  Deterministic mode forces the host
    codecs — they are the bit-compat reference and their dispatch is
    replayable.  Irrelevant under the numpy backend, which has no
    device to encode on."""
    if getattr(config, "deterministic", False):
        return False
    if not bool(getattr(config, "codec_device", True)):
        return False
    env = os.environ.get("GEOMX_CODEC_DEVICE", "").strip().lower()
    if env:
        return env not in ("0", "false", "no", "off")
    return True


def make_merge_backend(config, node: str = "?") -> MergeBackend:
    """Construct the resolved backend.  A torch backend whose device is
    missing raises here: the merge never degrades to the host path
    behind the caller's back."""
    kind = resolve_merge_backend(config)
    if kind != "numpy":
        from geomx_tpu_torch.kvstore.torch_backend import TorchBackend

        return TorchBackend(config,
                            device="cpu" if kind == "torch:cpu" else None)
    return NumpyBackend(config)
