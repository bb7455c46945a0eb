"""Scheduler-side trace collector: merge + round critical-path report.

Runs on the global scheduler (the one node every party can reach over
the WAN domain).  Nodes batch-ship completed spans as
``Ctrl.TRACE_REPORT`` data-channel requests (fire-and-forget — no
response slot, so a dead collector never blocks training); the collector
owns the PS app id on the scheduler's postoffice, which otherwise serves
no data traffic.

Clock correction: each report carries the sender's heartbeat-RTT clock
offsets to its scheduler(s) (``Postoffice.clock_offsets``).  Offsets are
"scheduler clock minus my clock"; a worker only knows its party
scheduler, so its offset to the global clock is chained through its
party's local server, which heartbeats both tiers:

    off(worker -> global) = off(worker -> psched) + off(psched -> global)
    off(psched -> global) = off(server -> global) - off(server -> psched)

On one host all offsets are ~0; on real deployments this is the same
RTT/2 estimate NTP starts from — good to a few ms, enough to order
LAN-push vs WAN vs optimizer stages that differ by tens of ms.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

# span-name prefix -> critical-path stage (the push→merge→WAN→optimize→
# pull round trip of PAPER.md, plus the control stages)
_STAGES = (
    ("worker.push", "lan_push"),
    ("local.push", "local_merge"),
    ("local.init", "local_merge"),
    ("local.merge", "local_merge"),
    ("codec.", "codec"),
    ("wan.", "wan"),
    ("global.push", "global_merge"),
    ("global.opt", "global_merge"),
    ("global.init", "global_merge"),
    ("global.merge", "global_merge"),
    ("global.pull", "pull_fanout"),
    ("local.pull", "pull_fanout"),
    ("worker.pull", "pull_fanout"),
    ("barrier", "barrier"),
)


def _stage_of(name: str) -> Optional[str]:
    for prefix, stage in _STAGES:
        if name.startswith(prefix):
            return stage
    return None


def _party_of(node: str) -> str:
    return node.rsplit("@", 1)[1] if "@" in node else "central"


def _shard_of(node: str):
    """Global-tier shard rank of a node, or None.  The shard identity
    survives failover: ``standby_global:k`` serves exactly shard k's
    key range once promoted, so its spans bill to the same shard as the
    primary it replaced."""
    for role in ("global_server:", "standby_global:"):
        if node.startswith(role):
            try:
                return int(node[len(role):].split("@", 1)[0])
            except ValueError:
                return None
    return None


def resolve_clock_offsets(offs: Dict[str, Dict[str, float]],
                          gname: str) -> Dict[str, float]:
    """Per-node offset to the global scheduler's clock (seconds), from
    each node's heartbeat-echo offsets to its scheduler target(s) —
    the chaining documented in the module docstring.  Shared by the
    trace collector and the flight-recorder postmortem assembler
    (obs/postmortem.py), which rebases per-node dumps the same way."""
    out: Dict[str, float] = {gname: 0.0}
    # party-scheduler offsets chained through the party's server
    psched_to_g: Dict[str, float] = {}
    for n, o in offs.items():
        if gname in o:
            out[n] = o[gname]
            for sched, v in o.items():
                if sched != gname:
                    psched_to_g[sched] = o[gname] - v
                    out.setdefault(sched, o[gname] - v)
    for n, o in offs.items():
        if n in out:
            continue
        for sched, v in o.items():
            if sched in psched_to_g:
                out[n] = v + psched_to_g[sched]
                break
    return out


class TraceCollector:
    """One per deployment, on the global scheduler's postoffice."""

    def __init__(self, postoffice):
        from geomx_tpu_torch.kvstore.common import Ctrl
        from geomx_tpu_torch.obs.endpoint import get_endpoint

        self.po = postoffice
        self.node = str(postoffice.node)
        self._mu = threading.Lock()
        self._events: List[dict] = []
        self._offsets: Dict[str, Dict[str, float]] = {}
        self.reports_received = 0
        # sibling collectors (the metrics collector's perfetto counter
        # tracks) contribute events to the merged timeline through here
        self.extra_event_sources: List = []
        # the scheduler's PS app is shared with the other telemetry
        # collectors — one endpoint routes frames by Ctrl head
        self._endpoint = get_endpoint(postoffice).acquire()
        self._endpoint.route(Ctrl.TRACE_REPORT, self._on_msg)

    def _on_msg(self, msg):
        body = msg.body if isinstance(msg.body, dict) else {}
        self.ingest(body)

    def ingest(self, body: dict) -> None:
        node = str(body.get("node", "?"))
        spans = body.get("spans") or ()
        with self._mu:
            self._events.extend(spans)
            offs = body.get("offsets")
            if offs:
                self._offsets[node] = {str(k): float(v)
                                       for k, v in offs.items()}
            self.reports_received += 1

    # ---- clock-offset resolution -------------------------------------------
    def _resolve_offsets(self) -> Dict[str, float]:
        """Per-node offset to the global scheduler's clock (seconds)."""
        with self._mu:
            offs = {n: dict(o) for n, o in self._offsets.items()}
        out = resolve_clock_offsets(
            offs, str(self.po.topology.global_scheduler()))
        out.setdefault(self.node, 0.0)
        return out

    # ---- merge --------------------------------------------------------------
    def merged_events(self) -> List[dict]:
        """Every collected event, timestamps rebased onto the global
        scheduler's clock (``ts`` in µs from the earliest event)."""
        offsets = self._resolve_offsets()
        with self._mu:
            events = list(self._events)
        for src in list(self.extra_event_sources):
            try:
                events.extend(src())
            except Exception:  # a sibling mid-stop must not break dumps
                pass
        if not events:
            return []
        out = []
        for ev in events:
            node = ev.get("pid", "?")
            off_us = offsets.get(node, 0.0) * 1e6
            t = ev.get("args", {}).get("t_mono_us", ev.get("ts", 0.0))
            e = dict(ev)
            e["ts"] = t + off_us
            out.append(e)
        t_min = min(e["ts"] for e in out)
        for e in out:
            e["ts"] -= t_min
        out.sort(key=lambda e: e["ts"])
        return out

    def merged_trace(self) -> dict:
        """Chrome-trace/perfetto JSON of the whole deployment: one
        ``pid`` per node, spans linked by args.span/args.parent."""
        return {"traceEvents": self.merged_events(),
                "displayTimeUnit": "ms",
                "otherData": {"clock_offsets_s": self._resolve_offsets()}}

    def dump(self, path: str) -> dict:
        trace = self.merged_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace

    # ---- critical path ------------------------------------------------------
    def critical_path(self) -> dict:
        """Per-round stage breakdown + straggler attribution.

        For each sampled round (one ``trace_id``): the wall window, the
        busy time per stage (WAN time is recovered from matched
        wan.send → wan.recv instants, everything else from span
        durations), the per-stage worst node (the straggler), and the
        ``dominant_stage`` — the stage with the largest busy share,
        i.e. the first place a perf PR should look.
        """
        events = self.merged_events()
        rounds: Dict[int, dict] = {}
        # wan.send spans by span-id, for pairing with their wan.recv
        sends: Dict[int, dict] = {}
        for ev in events:
            a = ev.get("args", {})
            if ev.get("name") == "wan.send" and a.get("span"):
                sends[a["span"]] = ev
        for ev in events:
            a = ev.get("args", {})
            tid = a.get("trace_id", 0)
            if not tid or tid < 0:
                continue
            r = rounds.setdefault(tid, {
                "trace_id": tid, "round": tid - 1, "t0": ev["ts"],
                "t1": ev["ts"], "num_spans": 0, "stages": {}, "events": [],
            })
            dur = float(ev.get("dur") or 0.0)
            r["t0"] = min(r["t0"], ev["ts"])
            r["t1"] = max(r["t1"], ev["ts"] + dur)
            r["num_spans"] += 1
            name = ev.get("name", "")
            stage = _stage_of(name)
            node = ev.get("pid", "?")
            if name == "wan.recv":
                send = sends.get(a.get("parent", -1))
                if send is not None:
                    dur = max(0.0, ev["ts"] - send["ts"])
                    node = send.get("pid", node)  # bill the sender's link
                else:
                    continue
            elif name == "wan.send" or dur <= 0.0:
                continue  # instants: wan time comes from the recv pair
            if stage is None:
                continue
            st = r["stages"].setdefault(stage, {
                "busy_us": 0.0, "worst_node": None, "worst_us": 0.0,
                "by_party": {}})
            st["busy_us"] += dur
            party = _party_of(node)
            st["by_party"][party] = st["by_party"].get(party, 0.0) + dur
            if dur > st["worst_us"]:
                st["worst_us"] = dur
                st["worst_node"] = node
            # sharded global tier: bill global-server work (and WAN
            # transit INTO a shard — the recv side of the matched pair)
            # to its shard, so the report names the slowest shard the
            # way it names the straggler party
            shard = _shard_of(str(ev.get("pid", node))
                              if name == "wan.recv" else node)
            if shard is not None:
                bs = r.setdefault("by_shard", {})
                bs[shard] = bs.get(shard, 0.0) + dur
        out = []
        for tid in sorted(rounds):
            r = rounds.pop(tid)
            r.pop("events", None)
            r["wall_us"] = r["t1"] - r["t0"]
            if r["stages"]:
                r["dominant_stage"] = max(
                    r["stages"], key=lambda s: r["stages"][s]["busy_us"])
                for st in r["stages"].values():
                    if st["by_party"]:
                        st["straggler_party"] = max(
                            st["by_party"], key=st["by_party"].get)
            else:
                r["dominant_stage"] = None
            if r.get("by_shard"):
                # the first place to look when shard-count scaling is
                # sublinear: which key range's server bounded the round
                r["slowest_shard"] = max(r["by_shard"],
                                         key=r["by_shard"].get)
            out.append(r)
        return {"rounds": out,
                "num_events": len(events),
                "clock_offsets_s": self._resolve_offsets()}

    def report_text(self) -> str:
        """Human-readable critical-path summary, one line per round."""
        cp = self.critical_path()
        lines = []
        for r in cp["rounds"]:
            stages = ", ".join(
                f"{s}={st['busy_us'] / 1e3:.1f}ms"
                + (f"(worst {st['worst_node']})" if st["worst_node"] else "")
                for s, st in sorted(r["stages"].items(),
                                    key=lambda kv: -kv[1]["busy_us"]))
            shard = (f" slowest_shard={r['slowest_shard']}"
                     if "slowest_shard" in r else "")
            lines.append(
                f"round {r['round']}: wall={r['wall_us'] / 1e3:.1f}ms "
                f"dominant={r['dominant_stage']}{shard} [{stages}]")
        return "\n".join(lines)

    def stop(self):
        self._endpoint.release()
