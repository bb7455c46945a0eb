"""Deadband-and-cooldown hysteresis policy: signals -> codec tier.

The ladder orders WAN configurations from most bytes / least lossy to
fewest bytes / most lossy::

    none -> fp16 -> bsc(r) -> bsc(r/4) -> 2bit

or, when the operator launched with MPQ, the size-bound retuning ladder::

    none -> fp16 -> mpq(sb) -> mpq(sb/4) -> mpq(sb/16) -> 2bit

(shrinking ``size_bound`` routes ever-smaller tensors through BSC — the
reference's MXNET_KVSTORE_SIZE_LOWER_BOUND knob, retuned live).  Every
rung is filtered through the shared :func:`compression_allowed`
predicate, so the engine can never propose bsc/mpq under the inter-party
TS overlay or a non-weight-safe codec under HFA — the same rules static
config validation enforces (EQuARX, arxiv 2506.17615, makes the case
that quantized-collective settings must be tuned per-link; this engine
is that tuner for the HiPS WAN tier).

Hysteresis discipline (what keeps an oscillating link from thrashing):

- **deadband** — no action while round time sits within
  ``budget * (1 ± deadband)``;
- **patience** — a shift needs K *consecutive* out-of-band samples
  (upshifts need 2K: decompressing is the risky direction);
- **cooldown** — after any shift, decisions are frozen for
  ``cooldown_s`` so the new tier's effect is actually observed before
  the next move;
- **compute veto** — when tracing supplies a ``dominant_stage`` that is
  compute (local/global merge), downshifts are vetoed: more compression
  cannot shorten a compute-bound round, it only loses gradient mass.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List, Optional

from geomx_tpu_torch.compression.codecs import compression_allowed
from geomx_tpu_torch.control.signals import WanSignals

# critical-path stages a codec change cannot speed up
_COMPUTE_STAGES = frozenset(("local_merge", "global_merge"))


def build_ladder(base: dict, *, inter_ts: bool = False,
                 hfa: bool = False) -> List[dict]:
    """Codec ladder from lightest to heaviest compression, seeded from
    the launch-time compression config (``base``) and filtered by the
    shared compatibility predicate."""
    ratio = float(base.get("ratio", 0.01))
    threshold = float(base.get("threshold", 0.5))
    if base.get("type") == "mpq":
        sb = int(base.get("size_bound", 200_000))
        rungs = [
            {"type": "none"},
            {"type": "fp16"},
            {"type": "mpq", "ratio": ratio, "size_bound": sb},
            {"type": "mpq", "ratio": ratio, "size_bound": max(1, sb // 4)},
            {"type": "mpq", "ratio": ratio, "size_bound": max(1, sb // 16)},
            {"type": "2bit", "threshold": threshold},
        ]
    else:
        rungs = [
            {"type": "none"},
            {"type": "fp16"},
            {"type": "bsc", "ratio": ratio},
            {"type": "bsc", "ratio": ratio / 4},
            {"type": "2bit", "threshold": threshold},
        ]
    return [r for r in rungs
            if compression_allowed(r["type"], inter_ts=inter_ts,
                                   hfa=hfa)[0]]


@dataclasses.dataclass
class Decision:
    """One policy change, with everything needed to audit it later."""

    action: str                      # "downshift" | "upshift" | "manual"
    compression: dict                # the new codec config
    reason: str
    round_time_s: Optional[float] = None
    budget_s: Optional[float] = None
    goodput_bps: Optional[float] = None
    dominant_stage: Optional[str] = None


class WanPolicyEngine:
    """Consumes :class:`WanSignals`, emits :class:`Decision` or None."""

    def __init__(self, base_compression: Optional[dict] = None, *,
                 inter_ts: bool = False, hfa: bool = False,
                 budget_s: float = 0.0, deadband: float = 0.25,
                 cooldown_s: float = 5.0, patience: int = 2,
                 clock=time.monotonic):
        base = dict(base_compression or {"type": "none"})
        self.ladder = build_ladder(base, inter_ts=inter_ts, hfa=hfa)
        self.idx = self._seed_index(base)
        self.budget_s = float(budget_s)       # 0 = auto-calibrate
        self.deadband = float(deadband)
        self.cooldown_s = float(cooldown_s)
        self.patience = max(1, int(patience))
        self._clock = clock
        self._over = 0       # consecutive over-budget samples
        self._under = 0      # consecutive under-budget samples
        self._last_change = -float("inf")
        self._calib: List[float] = []  # auto-budget samples
        self.decisions: List[Decision] = []  # audit trail
        self.vetoes = 0      # compute-bound downshifts refused

    def _seed_index(self, base: dict) -> int:
        for i, rung in enumerate(self.ladder):
            if rung["type"] == base.get("type") and all(
                    base.get(k) == v for k, v in rung.items() if k != "type"):
                return i
        # the launch config isn't a ladder rung (custom ratio, or a codec
        # the constraints filtered) — start at the closest type match,
        # else at the lightest rung
        for i, rung in enumerate(self.ladder):
            if rung["type"] == base.get("type"):
                return i
        return 0

    @property
    def current(self) -> dict:
        return dict(self.ladder[self.idx])

    # ---- decision loop ------------------------------------------------------
    def observe(self, sig: WanSignals) -> Optional[Decision]:
        rt = sig.round_time_s
        if rt is None:
            return None  # no round completed in the window — no evidence
        now = self._clock()
        if self.budget_s <= 0.0:
            # auto-calibration: the first few observed rounds define
            # "normal"; budget = 1.5x their median.  A deployment that
            # STARTS degraded calibrates to the degraded speed — an
            # explicit adapt_round_budget_s is the fix for that.
            self._calib.append(rt)
            if len(self._calib) < self.patience + 1:
                return None
            self.budget_s = 1.5 * statistics.median(self._calib)
        hi = self.budget_s * (1.0 + self.deadband)
        lo = self.budget_s * (1.0 - self.deadband)
        if rt > hi:
            self._over += 1
            self._under = 0
        elif rt < lo:
            self._under += 1
            self._over = 0
        else:
            self._over = self._under = 0
            return None
        if now - self._last_change < self.cooldown_s:
            return None  # cooling down: keep counting, don't act
        if self._over >= self.patience and self.idx < len(self.ladder) - 1:
            if sig.dominant_stage in _COMPUTE_STAGES:
                # compute-bound round: compression can't help — hold
                self.vetoes += 1
                return None
            return self._shift(+1, "downshift", sig, now)
        # upshifts (less compression) need twice the patience: the risky
        # direction is the one that puts bytes back on the wire
        if self._under >= 2 * self.patience and self.idx > 0:
            return self._shift(-1, "upshift", sig, now)
        return None

    def _shift(self, step: int, action: str, sig: WanSignals,
               now: float) -> Decision:
        frm = self.current
        self.idx += step
        self._over = self._under = 0
        self._last_change = now
        d = Decision(
            action=action, compression=self.current,
            reason=(f"round_time {sig.round_time_s:.3f}s vs budget "
                    f"{self.budget_s:.3f}s (deadband {self.deadband}); "
                    f"{frm.get('type')} -> {self.current.get('type')}"),
            round_time_s=sig.round_time_s, budget_s=self.budget_s,
            goodput_bps=sig.goodput_bps,
            dominant_stage=sig.dominant_stage,
        )
        self.decisions.append(d)
        return d

    def force(self, compression: dict, reason: str = "manual") -> Decision:
        """Manual override (``Simulation.set_wan_policy``): pin the
        ladder to ``compression`` (appended if it is no rung) and reset
        the hysteresis counters; the cooldown starts now, so the
        automatic loop cannot immediately fight the operator."""
        for i, rung in enumerate(self.ladder):
            if rung == compression:
                self.idx = i
                break
        else:
            self.ladder.append(dict(compression))
            self.idx = len(self.ladder) - 1
        self._over = self._under = 0
        self._last_change = self._clock()
        d = Decision(action="manual", compression=self.current,
                     reason=reason)
        self.decisions.append(d)
        return d
