"""Network-fault orchestrator: seeded, scripted WAN partitions.

The churn engine (geomx_tpu_torch/chaos/churn.py) kills PROCESSES; real
geo-distributed outages more often kill LINKS — a region's WAN uplink
goes dark while every process behind it keeps running.  This module
scripts that case: a :class:`NetFaultPlan` (absolute-time phases of
party-scoped blackholes, asymmetric single-direction cuts, and seeded
flap schedules) is pre-expanded into the same kind of deterministic
event tape as :class:`~geomx_tpu_torch.chaos.churn.ChurnPlan`, and
:class:`NetFaultOrchestrator` executes it against a live ``Simulation``
through the targeted fault-injection surface
(``Simulation.partition_party`` / ``partition`` / ``heal_party`` /
``heal`` — which in turn drive ``FaultPolicy`` cuts inside the message
fabric, heartbeats included).

Every cut and heal is stamped into the global scheduler's flight
recorder (``FlightEv.NETFAULT``) and counted in the registry family
``partition_{cuts,heals}`` by the Simulation layer, so a postmortem can
attribute a quarantine to an injected partition vs an organic one.

``install_env_netfaults(po)`` is the OS-process analog
(``GEOMX_NETFAULT_PLAN``, a JSON phase list): inside a launched
process it applies the same tape to the process's OWN fabric fault
policy — a send-side blackhole of this node's WAN links, which is how
``scripts/run_partition_demo.sh`` strands a real local server without
touching iptables.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import List, Optional, Tuple

_KINDS = ("party_blackhole", "asym_cut", "flap", "corrupt")


@dataclasses.dataclass(frozen=True)
class NetFaultPhase:
    """One scripted fault window starting ``at_s`` into the run.

    - ``party_blackhole``: cut party ``party``'s local server from every
      WAN peer (global scheduler, global servers, standbys, other
      parties' servers) for ``duration_s`` — the LAN behind the uplink
      keeps working, which is exactly what makes indirect probing able
      to tell "partitioned" from "dead".
    - ``asym_cut``: cut only the ``src``→``dst`` direction (``dst``
      still reaches ``src``) — the gray failure that must quarantine,
      never evict.
    - ``flap``: a party blackhole that cycles cut/heal every
      ``period_s`` seconds (``duty`` = cut fraction of each period,
      edges jittered by the plan seed) for ``duration_s`` — the
      retry-storm shaker.
    - ``corrupt``: damage data frames on the ``src``→``dst`` link in
      flight for ``duration_s`` (``"*"`` wildcards allowed): each frame
      is corrupted with probability ``rate`` in ``corrupt_mode``
      ("bitflip" | "truncate"), on a deterministic per-rule tape seeded
      from the plan seed — the rot a flaky NIC inflicts, which the wire
      checksums (GEOMX_INTEGRITY_WIRE) must catch and NACK-resend.
    """

    at_s: float
    duration_s: float
    kind: str = "party_blackhole"
    party: int = 0
    src: Optional[str] = None    # asym_cut / corrupt
    dst: Optional[str] = None    # asym_cut / corrupt
    symmetric: bool = True       # party_blackhole / flap
    period_s: float = 2.0        # flap only
    duty: float = 0.5            # flap only: fraction of period cut
    rate: float = 1.0            # corrupt only: per-frame damage prob
    corrupt_mode: str = "bitflip"  # corrupt only: bitflip | truncate

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown netfault kind '{self.kind}' "
                             f"(one of {_KINDS})")
        if self.kind == "asym_cut" and not (self.src and self.dst):
            raise ValueError("asym_cut needs src and dst node strings")
        if self.kind == "flap" and not (0.0 < self.duty < 1.0
                                        and self.period_s > 0):
            raise ValueError("flap needs period_s > 0 and 0 < duty < 1")
        if self.kind == "corrupt":
            if not (self.src and self.dst):
                raise ValueError(
                    "corrupt needs src and dst node strings ('*' ok)")
            if not 0.0 < self.rate <= 1.0:
                raise ValueError("corrupt needs 0 < rate <= 1")
            from geomx_tpu_torch.transport.van import _CORRUPT_MODES

            if self.corrupt_mode not in _CORRUPT_MODES:
                raise ValueError(
                    f"unknown corrupt_mode '{self.corrupt_mode}' "
                    f"(one of {_CORRUPT_MODES})")


@dataclasses.dataclass
class NetFaultPlan:
    """Seeded, scripted partition schedule.  ``schedule()`` pre-expands
    the whole cut/heal tape — two plans with the same seed and phases
    produce the SAME tape, so a flaky soak reproduces."""

    phases: Tuple[NetFaultPhase, ...]
    seed: int = 0

    def schedule(self) -> List[Tuple[float, str, NetFaultPhase]]:
        """The deterministic event tape: sorted ``(t, action, phase)``
        triples with ``action`` in {"cut", "heal"}.  A flap phase
        expands into one pair per period, edges jittered (seeded) by up
        to 10% of the period so flap harmonics can't phase-lock with
        retry timers."""
        rng = random.Random(self.seed)
        tape: List[Tuple[float, str, NetFaultPhase]] = []
        for ph in self.phases:
            if ph.kind == "flap":
                t = ph.at_s
                end = ph.at_s + ph.duration_s
                jit = 0.1 * ph.period_s
                while t < end:
                    cut_t = max(ph.at_s, t + rng.uniform(-jit, jit))
                    heal_t = min(end, cut_t + ph.duty * ph.period_s
                                 + rng.uniform(-jit, jit))
                    if heal_t <= cut_t:
                        heal_t = cut_t + 0.5 * ph.duty * ph.period_s
                    tape.append((cut_t, "cut", ph))
                    tape.append((min(heal_t, end), "heal", ph))
                    t += ph.period_s
            else:
                tape.append((ph.at_s, "cut", ph))
                tape.append((ph.at_s + ph.duration_s, "heal", ph))
        tape.sort(key=lambda e: e[0])
        return tape

    @property
    def duration_s(self) -> float:
        return max((ph.at_s + ph.duration_s for ph in self.phases),
                   default=0.0)


class NetFaultOrchestrator:
    """Executes a :class:`NetFaultPlan` against a live ``Simulation``.

    ``start()``/``stop()``/``join()`` manage the driver thread;
    ``run()`` executes inline.  The Simulation's targeted-injection
    surface does the actual cutting (and owns the ``partition_*``
    counters + ``FlightEv.NETFAULT`` stamps), so this class is pure
    scheduling — which also means a test can skip it entirely and call
    ``sim.partition_party`` by hand.
    """

    def __init__(self, sim, plan: NetFaultPlan):
        self.sim = sim
        self.plan = plan
        self._tape = plan.schedule()
        self.events: List[dict] = []  # executed tape (postmortem aid)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.node = str(sim.topology.global_scheduler())

    # ---- lifecycle ----------------------------------------------------------
    def start(self) -> "NetFaultOrchestrator":
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"netfault-orchestrator-{self.node}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def join(self, timeout: Optional[float] = None):
        if self._thread is not None:
            self._thread.join(timeout)

    # ---- execution ----------------------------------------------------------
    def run(self):
        t_start = time.monotonic()
        for t, action, ph in self._tape:
            wait = t_start + t - time.monotonic()
            if wait > 0 and self._stop.wait(wait):
                break
            if self._stop.is_set():
                break
            try:
                self._execute(action, ph)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "netfault: injected %s/%s failed", action, ph.kind)
        if self._stop.is_set():
            # leave no dangling cut behind an aborted soak
            for ph in self.plan.phases:
                try:
                    self._execute("heal", ph)
                except Exception:
                    pass

    def _execute(self, action: str, ph: NetFaultPhase):
        if ph.kind == "corrupt":
            if action == "cut":
                self.sim.corrupt_link(
                    ph.src, ph.dst, rate=ph.rate, mode=ph.corrupt_mode,
                    seed=_corrupt_seed(self.plan.seed, ph))
            else:
                self.sim.heal_corrupt(ph.src, ph.dst)
            target = f"{ph.src}->{ph.dst}"
        elif ph.kind == "asym_cut":
            if action == "cut":
                self.sim.partition(ph.src, ph.dst, symmetric=False)
            else:
                self.sim.heal(ph.src, ph.dst, symmetric=False)
            target = f"{ph.src}->{ph.dst}"
        else:  # party_blackhole / flap
            if action == "cut":
                self.sim.partition_party(ph.party,
                                         symmetric=ph.symmetric)
            else:
                self.sim.heal_party(ph.party)
            target = f"party:{ph.party}"
        self.events.append({"t": time.monotonic(), "action": action,
                            "kind": ph.kind, "target": target})


def _corrupt_seed(plan_seed: int, ph: NetFaultPhase) -> int:
    """Per-link corruption-tape seed: stable across runs (plan seed ⊕
    link name), distinct per link so two corrupt phases don't share a
    tape."""
    import zlib

    return plan_seed ^ zlib.crc32(f"{ph.src}->{ph.dst}".encode())


def _wan_peers_of(topology, party: int) -> List[str]:
    """Party ``party``'s WAN-side peers: everything its local server
    talks to across the WAN — and NOT its own party scheduler/workers,
    whose LAN links survive a regional uplink outage (that surviving
    side channel is what indirect probes ride)."""
    peers = [str(topology.global_scheduler())]
    peers += [str(g) for g in topology.global_servers()]
    peers += [str(s) for s in topology.standby_globals()]
    peers += [str(topology.server(q))
              for q in range(topology.num_parties) if q != party]
    return peers


def install_env_netfaults(po) -> Optional[threading.Thread]:
    """Launch-time hook (``GEOMX_NETFAULT_PLAN``): apply a scripted
    fault tape to THIS process's fabric fault policy.  The env var is a
    JSON list of :class:`NetFaultPhase` field dicts (plus an optional
    leading ``{"seed": n}`` entry); cuts are send-side, so setting it
    on a local server's process blackholes that node's own WAN sends —
    heartbeats included — without touching any other process.  Returns
    the driver thread (daemon) or None when the env var is unset."""
    import json
    import os

    raw = os.environ.get("GEOMX_NETFAULT_PLAN", "").strip()
    if not raw:
        return None
    entries = json.loads(raw)
    seed = 0
    phases = []
    for e in entries:
        if set(e) == {"seed"}:
            seed = int(e["seed"])
            continue
        phases.append(NetFaultPhase(**e))
    plan = NetFaultPlan(tuple(phases), seed=seed)
    tape = plan.schedule()
    fault = getattr(po.van.fabric, "fault", None)
    if fault is None or not tape:
        return None
    me = str(po.node)
    topo = po.topology

    def _apply(action: str, ph: NetFaultPhase):
        if ph.kind == "corrupt":
            if action == "cut":
                fault.corrupt(ph.src, ph.dst, rate=ph.rate,
                              mode=ph.corrupt_mode,
                              seed=_corrupt_seed(seed, ph))
            else:
                fault.heal_corrupt(ph.src, ph.dst)
            print(f"{me}: netfault {action} corrupt "
                  f"{ph.src}->{ph.dst}", flush=True)
            return
        if ph.kind == "asym_cut":
            if action == "cut":
                fault.partition(ph.src, ph.dst, symmetric=False)
            else:
                fault.heal(ph.src, ph.dst, symmetric=False)
            target = f"{ph.src}->{ph.dst}"
        else:
            peers = _wan_peers_of(topo, ph.party)
            srv = str(topo.server(ph.party))
            if action == "cut":
                fault.blackhole(srv, peers, symmetric=ph.symmetric)
            else:
                for p in peers:
                    fault.heal(srv, p)
            target = f"party:{ph.party}"
        print(f"{me}: netfault {action} {ph.kind} {target}", flush=True)

    def _run():
        t_start = time.monotonic()
        for t, action, ph in tape:
            wait = t_start + t - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            try:
                _apply(action, ph)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "netfault: env-scripted %s/%s failed",
                    action, ph.kind)

    th = threading.Thread(target=_run, daemon=True,
                          name=f"netfault-env-{po.node}")
    th.start()
    return th
