"""Adaptive WAN control plane (closed-loop codec/ratio autotuning).

GeoMX's WAN optimizations were all statically configured: the codec and
ratio chosen at launch stayed fixed for the whole run even as WAN
bandwidth, straggler identity, and gradient compressibility drift.  PR 3
already collects the signals needed to do better (per-codec
``wan_bytes_*`` counters, heartbeat RTT gauges, the per-round
critical-path report), and the actuation primitive
(``Ctrl.SET_COMPRESSION``) existed but was only ever invoked at setup
time.  This package closes the loop:

- :mod:`signals` — sliding-window estimators over the existing
  observability (goodput from registry byte deltas, heartbeat RTT,
  WAN round rate, the trace collector's ``dominant_stage``).
- :mod:`policy` — a deadband-and-cooldown hysteresis engine mapping a
  target round budget to a codec tier
  (``none → fp16 → bsc(r) → bsc(r/4) → 2bit``, MPQ size-bound retuning),
  constraint-aware via the shared ``compression_allowed`` predicate
  (TS overlay forbids bsc/mpq; HFA forbids non-weight-safe codecs).
- :mod:`controller` — the epoch-fenced reconfiguration protocol:
  ``Ctrl.SET_WAN_POLICY {epoch, compression}`` broadcast down both
  tiers, applied atomically at round boundaries, with cross-epoch
  payloads fenced by receivers and transparently re-encoded + retried
  by senders.

See docs/adaptive-wan.md for the protocol and tuning-knob reference.
"""

from geomx_tpu_torch.control.controller import AdaptiveWanController  # noqa: F401
from geomx_tpu_torch.control.policy import WanPolicyEngine, build_ladder  # noqa: F401
from geomx_tpu_torch.control.signals import SignalEstimator, WanSignals  # noqa: F401
