"""Black-box flight recorder: always-on per-node event ring.

Geo-distributed failures are rare, cross-node, and unreproducible: by
the time an operator looks at a round-stall alert, the evidence is
gone.  PR 3's tracing only sees sampled rounds (``trace_sample_every``,
default off) and the PR 7 health engine says *that* something fired,
not *why*.  The flight recorder closes that gap the way production
systems do (cf. TensorFlow's always-on event logs, PAPERS.md): every
node keeps a **fixed-size ring of structured events** — preallocated
column arrays, no per-event allocation on the hot path — recording the
decision points the subsystems already log ad hoc:

- message send/recv heads (cmd/control, policy epoch, boot, bytes,
  peer) tapped in the Van;
- fence and dedup decisions (eviction fences, policy-epoch fences,
  stale-term replication rejects, van duplicate suppression);
- barrier enter/release/timeout (both the waiter and the scheduler);
- promotion / eviction / fold / handoff / warm-boot transitions;
- round open/complete per server (the stall forensic);
- periodically sampled **pressure** readings (StripedRLock wait,
  merge-lane queue depth, van send-queue depth, codec-pool backlog),
  mirrored into the system-metrics registry so the PR 7 pump ships
  them as gauges (``lock_wait_s`` / ``lane_depth`` /
  ``van_sendq_depth`` / ``codec_pool_busy``).

Rings dump to ``GEOMX_OBS_DIR`` (JSON, one file per node per incident)
on three triggers: process exit/signal (``install_process_hooks``), a
HealthEngine alert transition (the engine broadcasts
``Control.FLIGHT_DUMP`` so every node snapshots the same incident
window, and the alert record carries the dump paths), and operator
request (``python -m geomx_tpu_torch.status --dump-flight`` →
``Ctrl.FLIGHT_DUMP`` at the scheduler → the same broadcast).  The
offline assembler (``python -m geomx_tpu_torch.obs.postmortem <dir>``)
merges per-node dumps on the heartbeat clock-offset estimates into one
causal timeline and answers "why did round X stall".

Disabled path (``GEOMX_FLIGHT=0`` / ``Config.enable_flight=False``):
no recorder is constructed anywhere — every tap is one attribute-load
+ None check.
"""

from __future__ import annotations

import enum
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from geomx_tpu_torch.utils.metrics import system_counter, system_gauge

# the pressure gauges every sampled reading mirrors into the registry
# (documented in docs/metrics.md; the status console's pressure column
# and the PR 7 pump read them back).  process_threads is registered on
# every node; the reactor_* pair only when the node's fabric rides the
# shared reactor (GEOMX_TRANSPORT=reactor / lightweight sims)
PRESSURE_GAUGES = ("lock_wait_s", "lane_depth", "van_sendq_depth",
                   "codec_pool_busy", "process_threads",
                   "reactor_loop_lag_ms", "reactor_fds")


class FlightEv(enum.IntEnum):
    """Structured event codes.  The int value is what sits in the ring;
    dumps carry the name."""

    SEND = 1             # a=cmd (>=0) or -control, b=policy_epoch,
    #                      c=nbytes, d=boot, peer=recipient
    RECV = 2             # mirror of SEND, peer=sender
    DEDUP = 3            # duplicate suppressed (van resender window)
    FENCE = 4            # a/b context ints, peer=the fenced party,
    #                      note=which fence (evicted_push/policy_epoch/
    #                      stale_repl_term/deposed/...)
    BARRIER_ENTER = 5    # a=group value; scheduler side: peer=entrant
    BARRIER_RELEASE = 6  # c=waiters released (scheduler side)
    BARRIER_TIMEOUT = 7
    PROMOTE = 8          # a=term, peer=the promoted node
    EVICT = 9            # peer=the evicted member
    FOLD = 10            # peer=the folded member/party server
    UNFOLD = 11
    HANDOFF = 12         # a=term, peer=the handoff target
    ROUND_OPEN = 13      # a=key (global) / wan round counter (local)
    ROUND_COMPLETE = 14  # a=keys completed, b=total key/wan rounds
    PRESSURE = 15        # a=value*1e6 (scaled int), note=gauge name
    WARM_BOOT = 16       # a=keys pulled
    DUMP = 17            # a ring dump was taken (note=incident)
    ALERT = 18           # health transition observed locally
    MERGE_BACKEND = 19   # server merge engine chosen at boot: a=lane
    #                      count, note=backend name (numpy/jax) — the
    #                      postmortem can tell a device-lane server
    #                      from a host-lane one without its config
    CHURN = 20           # churn-orchestrator injected event (chaos/
    #                      churn.py): peer=the targeted node,
    #                      note=churn_{notice,kill,join,server_kill,
    #                      server_restart,stall_round} — postmortems
    #                      attribute stalls to INJECTED vs organic
    #                      faults by joining these with the fold/evict
    #                      timeline
    NETFAULT = 21        # partition-tolerance transition (chaos/netfault
    #                      injection + kvstore quarantine machinery):
    #                      note=netfault_{cut,heal,quarantine,
    #                      unquarantine,degraded,catchup_merge,
    #                      catchup_fallback}, peer=the affected node/
    #                      party server; a=context int (keys merged,
    #                      party id, ...), b=rounds accumulated —
    #                      postmortems can separate INJECTED cuts from
    #                      organic silence and audit every quarantine
    #                      state-machine edge without logs
    CORRUPT = 22         # data-integrity plane verdict: note=
    #                      wire_nack_resend (sender retransmitting after
    #                      a receiver checksum NACK), poison_push (a
    #                      NaN/Inf/oversized push zeroed out of a merge),
    #                      poison_quarantine (sender crossed the strike
    #                      budget), corrupt_snapshot (standby rejected a
    #                      REPLICATE slab), ckpt_fallback (restore
    #                      skipped an unverifiable generation); peer=the
    #                      offending sender/file, a=strike count or
    #                      generation — the health engine's
    #                      data_corruption rule reads the same counters,
    #                      the flight tape gives the per-event trail


_EV_NAMES = {int(e): e.name for e in FlightEv}


def _sanitize(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-." else "_" for c in s)


def dump_path(out_dir: str, node: str, incident: Optional[str]) -> str:
    return os.path.join(
        out_dir, f"flight_{_sanitize(node)}_{_sanitize(incident or 'exit')}"
        ".json")


class FlightRecorder:
    """One per node (owned by its Postoffice).  ``record`` is the hot
    path: one short lock + column-array stores into preallocated slots
    — the guard test taps it with tracemalloc."""

    def __init__(self, node: str, config=None, postoffice=None,
                 cap: Optional[int] = None):
        self.node = str(node)
        self.po = postoffice
        n = int(cap if cap is not None
                else getattr(config, "flight_events", 4096) or 4096)
        self.cap = max(8, n)
        # column layout: one preallocated array per field; a slot is
        # overwritten in place on wraparound — record() allocates
        # nothing that outlives the call
        self._t = np.zeros(self.cap, np.float64)
        self._code = np.zeros(self.cap, np.int16)
        self._a = np.zeros(self.cap, np.int64)
        self._b = np.zeros(self.cap, np.int64)
        self._c = np.zeros(self.cap, np.int64)
        self._d = np.zeros(self.cap, np.int64)
        self._peer = np.empty(self.cap, object)  # NodeId/str refs as-is
        self._note = np.empty(self.cap, object)  # interned literals
        self._n = 0          # total ever recorded (monotonic)
        self._mu = threading.Lock()
        self.dumps = 0
        self._dumped_incidents: set = set()
        self._dump_mu = threading.Lock()
        # pressure sources: name -> (fn, gauge); sampled by the metrics
        # pump, the optional sampler thread, and every dump
        self._pressure: Dict[str, tuple] = {}
        self._last_pressure: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread = None
        sample_s = float(getattr(config, "flight_sample_s", 0.0) or 0.0)
        if sample_s > 0:
            self._thread = threading.Thread(
                target=self._sample_loop, args=(sample_s,), daemon=True,
                name=f"flight-sampler-{self.node}")
            self._thread.start()

    # ---- hot path -----------------------------------------------------------
    def record(self, code: int, a: int = 0, b: int = 0, c: int = 0,
               d: int = 0, peer=None, note=None,
               t: Optional[float] = None) -> None:
        """Store one event into the ring.  Preallocated slots only: the
        wraparound overwrites the oldest event in place.  ``t`` is
        injectable for deterministic tests; production call sites leave
        it None (monotonic now)."""
        with self._mu:
            i = self._n % self.cap
            self._n += 1
            self._t[i] = time.monotonic() if t is None else t
            self._code[i] = code
            self._a[i] = a
            self._b[i] = b
            self._c[i] = c
            self._d[i] = d
            self._peer[i] = peer
            self._note[i] = note

    # ---- van taps (hot path; see transport/van.py) --------------------------
    def msg_send(self, msg, nbytes: int) -> None:
        """One SEND head: cmd (>=0) or -control, the policy epoch the
        payload was encoded under, size, sender incarnation, peer."""
        self.record(FlightEv.SEND,
                    a=(msg.cmd if msg.control.value == 0
                       else -msg.control.value),
                    b=msg.policy_epoch, c=nbytes, d=msg.boot,
                    peer=msg.recipient)

    def msg_recv(self, msg, nbytes: int) -> None:
        self.record(FlightEv.RECV,
                    a=(msg.cmd if msg.control.value == 0
                       else -msg.control.value),
                    b=msg.policy_epoch, c=nbytes, d=msg.boot,
                    peer=msg.sender)

    def msg_dedup(self, msg) -> None:
        """A reliable-channel duplicate was suppressed — a burst of
        these around an incident is a replay stampede the postmortem
        should see."""
        self.record(FlightEv.DEDUP, a=msg.msg_sig, d=msg.boot,
                    peer=msg.sender, note="resend_dedup")

    # ---- pressure -----------------------------------------------------------
    def add_pressure(self, name: str, fn: Callable[[], float]) -> None:
        """Register one pressure source; its sampled value is recorded
        as a PRESSURE event AND set on the ``<node>.<name>`` registry
        gauge (the PR 7 pump ships that slice)."""
        self._pressure[name] = (fn, system_gauge(f"{self.node}.{name}"))

    def sample_pressure(self) -> Dict[str, float]:
        """One sweep over the registered sources (pump cadence / the
        optional sampler thread / dump time).  A broken source must
        never take the pump down."""
        out = {}
        for name, (fn, gauge) in list(self._pressure.items()):
            try:
                v = float(fn())
            except Exception:
                continue
            if not math.isfinite(v):
                continue
            out[name] = v
            self._last_pressure[name] = v
            gauge.set(v)
            # scaled to int for the fixed column layout (µ-units keep
            # sub-ms lock waits visible)
            self.record(FlightEv.PRESSURE, a=int(v * 1e6), note=name)
        return out

    def _sample_loop(self, interval_s: float):
        while not self._stop.wait(interval_s):
            try:
                self.sample_pressure()
            except Exception:
                pass

    # ---- reading / dumping --------------------------------------------------
    def events(self) -> List[dict]:
        """Chronological decode of the ring (oldest surviving event
        first).  Off the hot path — allocates freely."""
        with self._mu:
            n = self._n
            if n <= self.cap:
                order = range(n)
            else:
                start = n % self.cap
                order = [(start + i) % self.cap for i in range(self.cap)]
            rows = [(self._t[i], int(self._code[i]), int(self._a[i]),
                     int(self._b[i]), int(self._c[i]), int(self._d[i]),
                     self._peer[i], self._note[i]) for i in order]
        out = []
        for t, code, a, b, c, d, peer, note in rows:
            out.append({
                "t": float(t),
                "ev": _EV_NAMES.get(code, str(code)),
                "a": a, "b": b, "c": c, "d": d,
                "peer": None if peer is None else str(peer),
                "note": None if note is None else str(note),
            })
        return out

    def snapshot(self, incident=None) -> dict:
        """The dump body (also what tests inspect in-memory)."""
        po = self.po
        body = {
            "node": self.node,
            "boot": int(po.van.boot) if po is not None else 0,
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "clock_offsets": (po.clock_offsets() if po is not None
                              else {}),
            "topology": ([str(n) for n in po.topology.all_nodes()]
                         if po is not None else []),
            "incident": incident,
            "pressure": dict(self._last_pressure),
            "n_recorded": self._n,
            "capacity": self.cap,
            "events": self.events(),
        }
        return body

    def dump(self, out_dir: str, incident: Optional[str] = None,
             meta: Optional[dict] = None) -> Optional[str]:
        """Write the ring to ``out_dir`` (one JSON file per node per
        incident).  Idempotent per incident id: a rebroadcast dump
        request is a no-op — exactly one dump per alert transition.
        Returns the path, or None (already dumped / no dir)."""
        if not out_dir:
            return None
        with self._dump_mu:
            if incident is not None:
                if incident in self._dumped_incidents:
                    return None
                self._dumped_incidents.add(incident)
        try:
            self.sample_pressure()  # final reading rides the dump
            body = self.snapshot(incident)
            if meta:
                body["meta"] = meta
            os.makedirs(out_dir, exist_ok=True)
            path = dump_path(out_dir, self.node, incident)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(body, f)
            os.replace(tmp, path)  # a crash mid-write leaves no torn dump
        except (OSError, ValueError):
            return None  # best-effort: a full disk must not kill the node
        self.dumps += 1
        system_counter(f"{self.node}.flight_dumps").inc()
        self.record(FlightEv.DUMP, note="dump")
        return path

    # ---- wire trigger -------------------------------------------------------
    def on_control(self, msg) -> bool:
        """Postoffice control hook: ``Control.FLIGHT_DUMP`` broadcast
        (health engine alert transition, or operator request relayed by
        the scheduler) — snapshot the incident window."""
        from geomx_tpu_torch.transport.message import Control

        if msg.control is not Control.FLIGHT_DUMP:
            return False
        b = msg.body if isinstance(msg.body, dict) else {}
        out_dir = str(b.get("dir") or os.environ.get("GEOMX_OBS_DIR", ""))
        self.record(FlightEv.ALERT, peer=msg.sender,
                    note=str(b.get("rule") or "flight_dump"))
        self.dump(out_dir, incident=b.get("incident"),
                  meta={k: b[k] for k in ("rule", "subject", "reason")
                        if k in b})
        return True

    def stop(self):
        self._stop.set()


def attach_server_pressure(recorder: Optional[FlightRecorder],
                           striped_lock, shard_executor) -> None:
    """Register the server-tier pressure sources on ``recorder`` (both
    kvstore tiers call this): merge-lock contention, merge-lane
    backlog, and the shared codec pool's queued work.  Each sampled
    value lands in the ring (PRESSURE event) AND on the registry gauge
    the PR 7 pump ships (``lock_wait_s`` / ``lane_depth`` /
    ``codec_pool_busy``; the van's ``van_sendq_depth`` is registered by
    the Postoffice)."""
    if recorder is None:
        return
    stripes = striped_lock._stripes

    def lock_wait() -> float:
        # probe each stripe ONE AT A TIME (never two — the documented
        # lock order): total time spent waiting to step through all of
        # them is the contention reading; an idle server measures ~0
        t0 = time.perf_counter()
        for s in stripes:
            s.acquire()
            s.release()
        return time.perf_counter() - t0

    from geomx_tpu_torch.kvstore.common import codec_pool_depth

    recorder.add_pressure("lock_wait_s", lock_wait)
    recorder.add_pressure("lane_depth", shard_executor.depth)
    recorder.add_pressure("codec_pool_busy", codec_pool_depth)


def broadcast_flight_dump(postoffice, out_dir: str, incident: str,
                          **info) -> List[str]:
    """Ask EVERY plan node (this one included) to snapshot its ring for
    ``incident`` — the health engine's alert trigger and the operator's
    ``--dump-flight`` share this.  Fire-and-forget: a dead node simply
    leaves no dump (which is itself the postmortem's signal).  Returns
    the per-node paths the dumps will land at."""
    from geomx_tpu_torch.transport.message import Control, Domain, Message

    topo = postoffice.topology
    body = {"incident": incident, "dir": out_dir}
    body.update({k: v for k, v in info.items() if v is not None})
    paths = []
    for n in topo.all_nodes():
        paths.append(dump_path(out_dir, str(n), incident))
        try:
            postoffice.van.send(Message(
                recipient=n, control=Control.FLIGHT_DUMP,
                domain=Domain.GLOBAL, request=False, body=dict(body)))
        except (KeyError, OSError):
            pass  # a dark node's missing dump is the finding
    return paths


def install_process_hooks(postoffice) -> None:
    """Real-deployment (one process per role) crash/exit trigger: dump
    this node's ring to ``GEOMX_OBS_DIR`` at interpreter exit and on
    SIGTERM/SIGINT (chained to any previous handler).  SIGKILL leaves
    no dump by definition — the postmortem assembler infers the victim
    from every OTHER node's ring."""
    import atexit
    import signal

    fl = getattr(postoffice, "flight", None)
    if fl is None:
        return

    def _dump(reason: str):
        out_dir = os.environ.get("GEOMX_OBS_DIR", "")
        if out_dir:
            fl.dump(out_dir, incident=reason)

    atexit.register(_dump, "exit")
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev = signal.getsignal(sig)

        def handler(signum, frame, prev=prev):
            _dump(f"signal-{signum}")
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        try:
            signal.signal(sig, handler)
        except ValueError:
            pass  # not the main thread (library use) — atexit remains
