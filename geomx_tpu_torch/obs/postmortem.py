"""Offline cross-node postmortem forensics over flight-recorder dumps.

``python -m geomx_tpu_torch.obs.postmortem <dir>`` loads every
``flight_*.json`` the nodes dumped into ``<dir>`` (crash/exit hooks,
health-alert broadcasts, operator requests — see obs/flight.py),
rebases every node's events onto the global scheduler's clock using
the heartbeat RTT/2 offset estimates each dump carries (the same
chaining the trace collector uses: ``resolve_clock_offsets``), and
assembles ONE causal timeline plus a report that answers "why did
round X stall":

- **dead nodes** — plan nodes that left no dump (SIGKILL leaves none
  by definition), with the last instant any *surviving* node heard
  from them (peers' RECV events);
- **stalled shards/rounds** — per global shard, the last completed
  key-round and how long before the window end it happened; a shard
  whose holder is dead is named with the round it stalled at;
- **who fenced whom** — every FENCE event in the window;
- **saturation** — peak pressure readings per node (merge-lock wait,
  lane depth, van send-queue depth, codec-pool backlog);
- **straggler attribution** — per party, the last local round
  completion (the slowest party bounds the stalled FSA round);
- **transitions** — promotions / evictions / folds / handoffs, so the
  recovery that followed the incident is on the same timeline.

The assembler is pure offline file reading — it never touches a live
cluster.  See docs/observability.md ("Postmortem forensics").
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

from geomx_tpu_torch.trace.collector import _party_of, _shard_of, \
    resolve_clock_offsets

_GSCHED_PREFIX = "global_scheduler:"


def load_dumps(dump_dir: str) -> List[dict]:
    """Every parseable flight dump in ``dump_dir`` (a node may have
    several: per-incident + exit)."""
    out = []
    for path in sorted(glob.glob(os.path.join(dump_dir, "flight_*.json"))):
        try:
            with open(path) as f:
                body = json.load(f)
        except (OSError, ValueError):
            continue  # a torn/foreign file must not kill the assembly
        if isinstance(body, dict) and body.get("node"):
            body["_path"] = path
            out.append(body)
    return out


def assemble(dump_dir: str) -> dict:
    """Merge the dumps into one rebased timeline + findings dict."""
    dumps = load_dumps(dump_dir)
    if not dumps:
        return {"error": f"no flight dumps in {dump_dir}", "nodes": [],
                "dead": [], "timeline": [], "shards": {}, "fences": [],
                "transitions": [], "pressure": {}, "parties": {}}

    # ---- clock rebasing -----------------------------------------------------
    gname = None
    offsets_in: Dict[str, Dict[str, float]] = {}
    expected: set = set()
    by_node: Dict[str, List[dict]] = {}
    for d in dumps:
        node = str(d["node"])
        offs = d.get("clock_offsets") or {}
        if offs:
            offsets_in[node] = {str(k): float(v) for k, v in offs.items()}
        for n in d.get("topology") or ():
            expected.add(str(n))
            if str(n).startswith(_GSCHED_PREFIX):
                gname = gname or str(n)
        by_node.setdefault(node, []).append(d)
    if gname is None:  # no topology metadata: pick any scheduler target
        for o in offsets_in.values():
            for tgt in o:
                if tgt.startswith(_GSCHED_PREFIX):
                    gname = tgt
                    break
    offsets = resolve_clock_offsets(offsets_in, gname or "")

    # ---- merge events (dedup across a node's incident + exit dumps) ---------
    timeline: List[dict] = []
    seen = set()
    for node, ds in by_node.items():
        off = offsets.get(node, 0.0)
        for d in ds:
            for ev in d.get("events") or ():
                key = (node, ev.get("t"), ev.get("ev"), ev.get("a"),
                       ev.get("b"), ev.get("c"), ev.get("d"),
                       ev.get("peer"), ev.get("note"))
                if key in seen:
                    continue
                seen.add(key)
                e = dict(ev)
                e["node"] = node
                e["t"] = float(ev.get("t", 0.0)) + off
                timeline.append(e)
    timeline.sort(key=lambda e: e["t"])
    t0 = timeline[0]["t"] if timeline else 0.0
    t1 = timeline[-1]["t"] if timeline else 0.0

    # ---- dead nodes + last-heard attribution --------------------------------
    # A node may have dumped EARLIER incidents (a warn-level alert at
    # startup) and still have died later — "left any dump" is not
    # alive.  When exit-class dumps exist (the atexit/signal hooks'
    # incident, or an in-proc Simulation.dump_flight final sweep), a
    # plan node MISSING one is the corpse: a SIGKILL leaves no exit
    # dump by definition.  With no exit-class dump anywhere (a
    # mid-incident assembly), fall back to "left no dump at all".
    def _exit_class(inc) -> bool:
        return inc is None or str(inc).startswith(("exit", "signal"))

    dumped = set(by_node)
    have_exit = {n for n, ds in by_node.items()
                 if any(_exit_class(d.get("incident")) for d in ds)}
    alive = have_exit if have_exit else dumped
    dead = []
    for n in sorted(expected - alive):
        last, via = None, None
        for e in timeline:
            if e["ev"] == "RECV" and e.get("peer") == n:
                last, via = e["t"], e["node"]
        dead.append({"node": n, "last_heard_t": last, "last_heard_by": via})

    # ---- per-shard round progress ------------------------------------------
    shards: Dict[int, dict] = {}
    rounds_by_holder: Dict[str, int] = {}
    for e in timeline:
        k = _shard_of(e["node"])
        if k is None:
            continue
        s = shards.setdefault(k, {"holders": [], "last_complete_t": None,
                                  "key_rounds": 0, "stalled": False,
                                  "stalled_round": None, "dead_holder": None})
        if e["node"] not in s["holders"]:
            s["holders"].append(e["node"])
        if e["ev"] == "ROUND_COMPLETE":
            s["last_complete_t"] = e["t"]
            s["key_rounds"] = max(s["key_rounds"], int(e.get("b") or 0))
            rounds_by_holder[e["node"]] = max(
                rounds_by_holder.get(e["node"], 0), int(e.get("b") or 0))
    dead_names = {d["node"] for d in dead}
    for k, s in shards.items():
        dead_holders = [h for h in s["holders"] if h in dead_names] + [
            d["node"] for d in dead
            if _shard_of(d["node"]) == k and d["node"] not in s["holders"]]
        if dead_holders:
            s["dead_holder"] = dead_holders[0]
            s["stalled"] = True
            # prefer the DEAD holder's own last completed round (its
            # earlier incident dumps carry it) — the round the shard
            # stalled at is the one after the last round the corpse
            # finished, not whatever a promoted standby completed later
            own = rounds_by_holder.get(s["dead_holder"])
            s["stalled_round"] = (own if own is not None
                                  else s["key_rounds"]) + 1
        if s["last_complete_t"] is not None:
            s["gap_to_window_end_s"] = round(t1 - s["last_complete_t"], 3)
    # a dead plan global server with NO events anywhere still names its
    # shard as stalled (it died before any surviving dump's window)
    for d in dead:
        k = _shard_of(d["node"])
        if k is not None and k not in shards:
            shards[k] = {"holders": [], "last_complete_t": None,
                         "key_rounds": 0, "stalled": True,
                         "stalled_round": 1, "dead_holder": d["node"]}

    # ---- fences / transitions ----------------------------------------------
    fences = [e for e in timeline if e["ev"] == "FENCE"]
    transitions = [e for e in timeline
                   if e["ev"] in ("PROMOTE", "EVICT", "FOLD", "UNFOLD",
                                  "HANDOFF", "WARM_BOOT")]

    # ---- pressure peaks -----------------------------------------------------
    pressure: Dict[str, dict] = {}
    for e in timeline:
        if e["ev"] != "PRESSURE" or not e.get("note"):
            continue
        p = pressure.setdefault(e["node"], {})
        v = float(e.get("a") or 0) / 1e6  # recorded scaled by 1e6
        if v > p.get(e["note"], float("-inf")):
            p[e["note"]] = v

    # ---- straggler attribution (per party, last local round) ----------------
    parties: Dict[str, dict] = {}
    for e in timeline:
        if not e["node"].startswith("server:"):
            continue
        p = parties.setdefault(_party_of(e["node"]), {
            "server": e["node"], "last_round_t": None, "wan_rounds": 0})
        if e["ev"] == "ROUND_COMPLETE":
            p["last_round_t"] = e["t"]
            p["wan_rounds"] = max(p["wan_rounds"], int(e.get("b") or 0))
    straggler = None
    timed = {p: d["last_round_t"] for p, d in parties.items()
             if d["last_round_t"] is not None}
    if timed:
        straggler = min(timed, key=timed.get)

    return {
        "dir": dump_dir,
        "nodes": sorted(dumped),
        "num_dumps": len(dumps),
        "window": [t0, t1],
        "clock_offsets_s": offsets,
        "dead": dead,
        "shards": shards,
        "fences": fences,
        "transitions": transitions,
        "pressure": pressure,
        "parties": parties,
        "straggler_party": straggler,
        "timeline": timeline,
    }


def _rel(t: Optional[float], t0: float) -> str:
    return "?" if t is None else f"+{t - t0:.3f}s"


def report_text(result: dict) -> str:
    """The human-readable postmortem (what the demo script asserts on)."""
    if result.get("error"):
        return f"postmortem: {result['error']}"
    t0 = result["window"][0]
    lines = [
        f"postmortem: {result['num_dumps']} dump(s) from "
        f"{len(result['nodes'])} node(s), window "
        f"{result['window'][1] - t0:.3f}s "
        f"[{', '.join(result['nodes'])}]",
    ]
    for d in result["dead"]:
        heard = ("never heard from in the window" if d["last_heard_t"] is
                 None else f"last heard {_rel(d['last_heard_t'], t0)} "
                           f"by {d['last_heard_by']}")
        lines.append(f"DEAD: {d['node']} — no exit/crash dump; {heard}")
    for k in sorted(result["shards"]):
        s = result["shards"][k]
        if s["stalled"]:
            # ">=": the ring data between the corpse's last dump and
            # its death died with it — the recorded round is the best
            # (lower-bound) evidence a black box can leave
            lines.append(
                f"shard {k}: STALLED at round >={s['stalled_round']} — "
                f"holder {s['dead_holder']} dead; shard's last recorded "
                f"key-round {s['key_rounds']} at "
                f"{_rel(s['last_complete_t'], t0)}")
        else:
            lines.append(
                f"shard {k}: healthy — {s['key_rounds']} key-rounds, "
                f"last completed {_rel(s['last_complete_t'], t0)}")
    for e in result["transitions"]:
        if e["ev"] == "PROMOTE":
            lines.append(f"PROMOTED: {e.get('peer') or e['node']} "
                         f"(term {e.get('a')}) at {_rel(e['t'], t0)} "
                         f"[seen by {e['node']}]")
        elif e["ev"] == "HANDOFF":
            lines.append(f"HANDOFF: {e['node']} -> {e.get('peer')} "
                         f"(term {e.get('a')}) at {_rel(e['t'], t0)}")
        else:
            lines.append(f"{e['ev']}: {e.get('peer') or ''} at "
                         f"{_rel(e['t'], t0)} [by {e['node']}]")
    for e in result["fences"][-16:]:
        lines.append(f"FENCE: {e['node']} fenced {e.get('peer') or '-'} "
                     f"({e.get('note')}) at {_rel(e['t'], t0)}")
    for node in sorted(result["pressure"]):
        p = result["pressure"][node]
        bits = " ".join(f"{k}={v:.4g}" for k, v in sorted(p.items()))
        lines.append(f"pressure peak {node}: {bits}")
    if result.get("straggler_party") is not None:
        lines.append(f"straggler party: {result['straggler_party']} "
                     "(oldest last-completed local round)")
    # the causal tail: the last events involving each dead node, so the
    # report shows WHAT was in flight when the evidence stops
    for d in result["dead"]:
        tail = [e for e in result["timeline"]
                if e.get("peer") == d["node"]][-5:]
        for e in tail:
            lines.append(
                f"  tail[{d['node']}]: {_rel(e['t'], t0)} {e['node']} "
                f"{e['ev']} a={e.get('a')} c={e.get('c')}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.obs.postmortem",
        description="assemble per-node flight-recorder dumps into one "
                    "causal timeline + stall report")
    ap.add_argument("dir", help="directory holding flight_*.json dumps "
                                "(GEOMX_OBS_DIR)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full findings dict (timeline "
                         "included) instead of the text report")
    ap.add_argument("--out", default="",
                    help="also write the findings JSON here (default "
                         "<dir>/postmortem.json; '-' disables)")
    args = ap.parse_args(argv)
    result = assemble(args.dir)
    if args.as_json:
        print(json.dumps(result, indent=1, sort_keys=True))
    else:
        print(report_text(result))
    out = args.out or os.path.join(args.dir, "postmortem.json")
    if out != "-":
        try:
            with open(out, "w") as f:
                json.dump(result, f, indent=1)
        except OSError:
            pass
    return 1 if result.get("error") else 0


if __name__ == "__main__":
    sys.exit(main())
