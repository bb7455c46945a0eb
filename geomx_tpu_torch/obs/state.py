"""Live cluster-state query service + operator dashboard rendering.

``Ctrl.CLUSTER_STATE`` is answered by the global scheduler — the one
node that already holds every piece of the answer: the failover
monitor's per-shard holders/terms, the recovery monitor's party fold
state, its own heartbeat table (per-node freshness), the adaptive-WAN
controller's policy epoch, the health engine's active alerts, and the
metrics collector's freshest per-node stats.  :meth:`compose` merges
them into one JSON-safe dict; :func:`render_text` turns that dict into
the text dashboard both ``python -m geomx_tpu_torch.status`` and the launch
exit lines print.

The service costs nothing until queried (no threads, no per-step work),
so it is always on wherever a global scheduler runs.
"""

from __future__ import annotations

import time
from typing import Optional

from geomx_tpu_torch.core.config import NodeId, Role
from geomx_tpu_torch.obs.health import _json_safe
from geomx_tpu_torch.utils.metrics import system_snapshot


class ClusterStateService:
    """One per deployment, on the global scheduler's postoffice.
    Monitor references may be bound after construction (the launchers
    build them in their own order) via plain attribute assignment."""

    def __init__(self, postoffice, config=None, failover_monitor=None,
                 recovery_monitor=None, wan_controller=None,
                 collector=None, health=None):
        from geomx_tpu_torch.kvstore.common import Ctrl
        from geomx_tpu_torch.obs.endpoint import get_endpoint

        assert postoffice.node.role is Role.GLOBAL_SCHEDULER, \
            "the cluster-state service runs on the global scheduler"
        self.po = postoffice
        self.config = config or postoffice.config
        self.failover_monitor = failover_monitor
        self.recovery_monitor = recovery_monitor
        self.wan_controller = wan_controller
        self.collector = collector
        self.health = health
        self.queries_served = 0
        self.flight_requests = 0
        self._endpoint = get_endpoint(postoffice).acquire()
        self._endpoint.route(Ctrl.CLUSTER_STATE, self._on_query)
        # operator flight-dump trigger (python -m geomx_tpu_torch.status
        # --dump-flight): relayed as a Control.FLIGHT_DUMP broadcast so
        # every node snapshots its ring under one incident id
        self._endpoint.route(Ctrl.FLIGHT_DUMP, self._on_flight_dump)

    # ---- wire query ---------------------------------------------------------
    def _on_query(self, msg):
        # out-of-plan querier (the status CLI): install its reply
        # address like a dynamic joiner's, so the response can dial
        self._install_reply_addr(msg)
        self.queries_served += 1
        try:
            self.po.van.send(msg.reply_to(body=self.compose()))
        except (KeyError, OSError):
            pass  # querier vanished between ask and answer

    def _install_reply_addr(self, msg):
        body = msg.body if isinstance(msg.body, dict) else {}
        addr = body.get("addr")
        if addr:
            add = getattr(self.po.van.fabric, "add_address", None)
            if add is not None:
                try:
                    add(str(msg.sender), (str(addr[0]), int(addr[1])))
                except (TypeError, ValueError, IndexError):
                    pass

    def _on_flight_dump(self, msg):
        """Ctrl.FLIGHT_DUMP from the status console: broadcast the ring
        snapshot to every node and answer with the dump dir + expected
        per-node paths."""
        import os

        self._install_reply_addr(msg)
        body = msg.body if isinstance(msg.body, dict) else {}
        out_dir = str(body.get("dir")
                      or os.environ.get("GEOMX_OBS_DIR", ""))
        if not out_dir:
            reply = {"ok": False,
                     "error": "no dump directory: set GEOMX_OBS_DIR on "
                              "the cluster or pass --flight-dir"}
        else:
            from geomx_tpu_torch.obs.flight import broadcast_flight_dump

            self.flight_requests += 1
            incident = f"operator-{self.flight_requests}"
            paths = broadcast_flight_dump(self.po, out_dir, incident,
                                          reason="operator request")
            reply = {"ok": True, "dir": out_dir, "incident": incident,
                     "nodes": len(paths), "paths": paths}
        try:
            self.po.van.send(msg.reply_to(body=reply))
        except (KeyError, OSError):
            pass  # querier vanished between ask and answer

    def _pressure_of(self, node: str) -> dict:
        """The node's freshest flight-recorder pressure gauges (shipped
        through the metrics pump; docs/metrics.md) — the status
        console's pressure column."""
        from geomx_tpu_torch.obs.flight import PRESSURE_GAUGES

        out = {}
        if self.collector is None:
            return out
        for key in PRESSURE_GAUGES:
            v = self.collector.value(node, key)
            if isinstance(v, (int, float)):
                out[key] = round(float(v), 6)
        return out

    # ---- composition --------------------------------------------------------
    def compose(self) -> dict:
        topo = self.po.topology
        cfg = self.config
        now = time.monotonic()
        hb, epoch = self.po.heartbeat_info()
        hb_on = cfg.heartbeat_interval_s > 0

        def node_entry(n) -> dict:
            s = str(n)
            t, boot = hb.get(s, (None, 0))
            age = now - (t if t is not None else epoch)
            alive = None  # unknown: heartbeats off, nothing to judge by
            if hb_on:
                alive = age <= cfg.heartbeat_timeout_s
            return {"age_s": round(age, 3), "alive": alive, "boot": boot}

        nodes = {}
        for n in (list(topo.global_servers()) + list(topo.standby_globals())
                  + list(topo.servers()) + list(topo.replicas())):
            nodes[str(n)] = node_entry(n)

        fm = self.failover_monitor
        shard_reg = system_snapshot("global_shard")
        table = fm.shard_table() if fm is not None else {}
        shards = {}
        for k in range(topo.num_global_servers):
            if k in table:
                holder = table[k]["holder"]
                term = table[k]["term"]
                promoted = table[k]["promoted"]
            else:
                # no monitor on this node: the registry gauges its
                # monitors (if any ever ran here) left behind
                holder = str(NodeId(Role.GLOBAL_SERVER, k))
                term = int(shard_reg.get(f"global_shard{k}.term", 0) or 0)
                promoted = term > 0
            sb = topo.standby_for(k)
            entry = {
                "holder": holder, "term": term, "promoted": promoted,
                "standby": str(sb) if sb is not None else None,
                "promotions": int(shard_reg.get(
                    f"global_shard{k}.promotions", 0) or 0),
                "reassignments": int(shard_reg.get(
                    f"global_shard{k}.reassignments", 0) or 0),
                "alive": nodes.get(holder, {}).get("alive"),
            }
            if self.collector is not None:
                st = self.collector.latest_stats(holder) or {}
                for key in ("draining", "policy_epoch",
                            "num_global_workers", "key_rounds",
                            "merge_backend"):
                    if key in st:
                        entry[key] = st[key]
                press = self._pressure_of(holder)
                if press:
                    entry["pressure"] = press
            shards[k] = entry

        rm = self.recovery_monitor
        folded = set(rm._folded) if rm is not None else set()
        quarantined = set(getattr(rm, "_quarantined", ())) \
            if rm is not None else set()
        parties = {}
        for p in range(topo.num_parties):
            server = str(topo.server(p))
            entry = {"server": server, "folded": p in folded,
                     "quarantined": p in quarantined,
                     "alive": nodes.get(server, {}).get("alive"),
                     "workers": topo.workers_per_party}
            if self.collector is not None:
                st = self.collector.latest_stats(server) or {}
                for key in ("wan_push_rounds", "policy_epoch", "uptime_s",
                            "merge_backend", "degraded",
                            "degraded_rounds", "quarantined_workers"):
                    if key in st:
                        entry[key] = st[key]
                press = self._pressure_of(server)
                if press:
                    entry["pressure"] = press
            parties[p] = entry

        # serve replicas (geomx_tpu_torch/serve): per-replica staleness / QPS
        # / version lag vs the shard holders' current round progress
        replicas = {}
        if topo.num_replicas:
            cur_rounds = None
            if self.collector is not None:
                vals = []
                for k, s in shards.items():
                    kr = s.get("key_rounds")
                    if isinstance(kr, (int, float)):
                        vals.append(kr)
                if vals:
                    cur_rounds = int(sum(vals))
            for r in topo.replicas():
                s = str(r)
                entry = {"node": s, "alive": nodes.get(s, {}).get("alive")}
                if self.collector is not None:
                    st = self.collector.latest_stats(s) or {}
                    for key in ("staleness_s", "serve_pulls",
                                "serve_predicts", "staleness_violations",
                                "stale_rejects", "replica_refreshes",
                                "rounds_at_refresh", "keys",
                                "serve_p50_ms", "serve_p99_ms",
                                "serve_sheds", "inflight",
                                "max_inflight", "retired"):
                        if st.get(key) is not None:
                            entry[key] = st[key]
                    qps = self.collector.rate(s, "serve_pulls")
                    if qps is not None:
                        entry["serve_qps"] = round(qps, 2)
                    shed = self.collector.rate(s, "serve_sheds")
                    if shed is not None:
                        entry["shed_rate"] = round(shed, 2)
                    if (cur_rounds is not None
                            and isinstance(st.get("rounds_at_refresh"),
                                           (int, float))):
                        # clamped at 0: the replica's LIST_KEYS snapshot
                        # and the holder's pump sample are taken at
                        # different instants, so a fresh replica can
                        # read "ahead" of the collector by a few rounds
                        entry["version_lag_rounds"] = max(0, int(
                            cur_rounds - st["rounds_at_refresh"]))
                replicas[r.rank] = entry

        policy = None
        if self.wan_controller is not None:
            s = self.wan_controller.status()
            policy = {"epoch": s["epoch"],
                      "compression": s["compression"],
                      "decisions": s["decisions"]}
        elif self.collector is not None:
            epochs = [self.collector.value(str(n), "policy_epoch")
                      for n in topo.global_servers()]
            epochs = [e for e in epochs if isinstance(e, (int, float))]
            if epochs:
                policy = {"epoch": int(max(epochs))}

        health = None
        if self.health is not None:
            with self.health._mu:
                total = len(self.health.alerts)
                recent = [dict(a) for a in self.health.alerts[-5:]]
            health = {"active": self.health.active_alerts(),
                      "transitions_total": total, "recent": recent}

        telemetry = None
        if self.collector is not None:
            telemetry = {
                "reports": self.collector.reports_received,
                "nodes_reporting": len(self.collector.nodes()),
                "node_restarts": dict(self.collector.node_restarts),
            }

        return _json_safe({
            "t": time.time(),
            "node": str(self.po.node),
            "topology": {
                "num_parties": topo.num_parties,
                "workers_per_party": topo.workers_per_party,
                "global_shards": topo.num_global_servers,
                "standby_globals": topo.num_standby_globals,
                "replicas": topo.num_replicas,
            },
            "heartbeats": hb_on,
            "shards": shards,
            "parties": parties,
            "replicas": replicas,
            "nodes": nodes,
            "policy": policy,
            "health": health,
            "telemetry": telemetry,
        })

    def stop(self):
        self._endpoint.release()


def _alive_tag(alive) -> str:
    if alive is None:
        return "?"
    return "up" if alive else "DOWN"


def _press_tag(entry: dict) -> str:
    """Compact pressure column for one console row: merge-lock wait,
    lane/send-queue depth, codec backlog (absent gauges are omitted)."""
    p = entry.get("pressure") or {}
    if not p:
        return ""
    bits = []
    if "lock_wait_s" in p:
        bits.append(f"lock={p['lock_wait_s'] * 1e3:.1f}ms")
    for key, short in (("lane_depth", "lane"),
                       ("van_sendq_depth", "sq"),
                       ("codec_pool_busy", "codec"),
                       ("process_threads", "thr"),
                       ("reactor_fds", "rfds")):
        if key in p:
            bits.append(f"{short}={int(p[key])}")
    if "reactor_loop_lag_ms" in p:
        bits.append(f"rlag={p['reactor_loop_lag_ms']:.1f}ms")
    return " press[" + " ".join(bits) + "]" if bits else ""


def render_text(state: dict) -> str:
    """The operator dashboard: one screen of text for
    ``python -m geomx_tpu_torch.status`` and the demo scripts."""
    topo = state.get("topology", {})
    when = time.strftime("%H:%M:%S", time.localtime(state.get("t", 0)))
    lines = [
        f"cluster @ {when} (via {state.get('node', '?')})",
        f"topology: {topo.get('num_parties', '?')} parties x "
        f"{topo.get('workers_per_party', '?')} workers, "
        f"{topo.get('global_shards', '?')} global shard(s)"
        + (f" (+{topo['standby_globals']} standby)"
           if topo.get("standby_globals") else "")
        + (f", {topo['replicas']} serve replica(s)"
           if topo.get("replicas") else ""),
    ]
    lines.append("shards:")
    shards = state.get("shards", {})
    for k in sorted(shards, key=int):  # keys are ints in-proc, strings
        s = shards[k]                  # after a JSON round trip
        extra = ""
        if s.get("promoted"):
            extra += " PROMOTED"
        if s.get("draining"):
            extra += " draining"
        if s.get("key_rounds") is not None:
            extra += f" rounds={int(s['key_rounds'])}"
        if s.get("merge_backend"):
            extra += f" merge={s['merge_backend']}"
        lines.append(
            f"  shard {k}: holder={s.get('holder')} term={s.get('term')} "
            f"[{_alive_tag(s.get('alive'))}]"
            f" standby={s.get('standby') or '-'}{extra}{_press_tag(s)}")
    lines.append("parties:")
    parties = state.get("parties", {})
    for p in sorted(parties, key=int):
        e = parties[p]
        extra = " FOLDED-OUT" if e.get("folded") else ""
        if e.get("quarantined"):
            # heartbeat-dead but probe-alive: folded out REVERSIBLY
            # (never alongside FOLDED-OUT — escalation moves the party
            # from one set to the other)
            extra += " QUARANTINED"
        if e.get("degraded"):
            extra += f" DEGRADED({int(e.get('degraded_rounds', 0))}r)"
        if e.get("quarantined_workers"):
            extra += f" qworkers={int(e['quarantined_workers'])}"
        if e.get("wan_push_rounds") is not None:
            extra += f" wan_rounds={int(e['wan_push_rounds'])}"
        if e.get("merge_backend"):
            extra += f" merge={e['merge_backend']}"
        lines.append(f"  p{p}: {e.get('server')} "
                     f"[{_alive_tag(e.get('alive'))}]{extra}{_press_tag(e)}")
    replicas = state.get("replicas") or {}
    if replicas:
        lines.append("replicas:")
        for r in sorted(replicas, key=int):
            e = replicas[r]
            extra = ""
            if e.get("staleness_s") is not None:
                extra += f" staleness={e['staleness_s']:.2f}s"
            if e.get("version_lag_rounds") is not None:
                extra += f" lag={int(e['version_lag_rounds'])}r"
            if e.get("serve_qps") is not None:
                extra += f" qps={e['serve_qps']:.1f}"
            if e.get("serve_pulls") is not None:
                extra += f" pulls={int(e['serve_pulls'])}"
            if e.get("shed_rate") is not None:
                extra += f" shed_rate={e['shed_rate']:.1f}/s"
            elif e.get("serve_sheds"):
                extra += f" sheds={int(e['serve_sheds'])}"
            if e.get("inflight") is not None:
                extra += f" inflight={int(e['inflight'])}"
                if e.get("max_inflight"):
                    extra += f"/{int(e['max_inflight'])}"
            if e.get("staleness_violations"):
                extra += (f" violations="
                          f"{int(e['staleness_violations'])}")
            if e.get("retired"):
                extra += " RETIRED"
            lines.append(f"  replica {r}: {e.get('node')} "
                         f"[{_alive_tag(e.get('alive'))}]{extra}")
    pol = state.get("policy")
    if pol:
        line = f"wan policy: epoch={pol.get('epoch')}"
        comp = pol.get("compression")
        if isinstance(comp, dict):
            line += f" codec={comp.get('type', 'none')}"
        lines.append(line)
    h = state.get("health")
    if h is not None:
        active = h.get("active") or []
        lines.append(f"health: {len(active)} active alert(s), "
                     f"{h.get('transitions_total', 0)} transition(s)")
        for a in active:
            lines.append(f"  ALERT {a.get('rule')} {a.get('subject')} — "
                         f"{a.get('message')}")
    t = state.get("telemetry")
    if t is not None:
        restarts = sum((t.get("node_restarts") or {}).values())
        lines.append(f"telemetry: {t.get('reports', 0)} reports from "
                     f"{t.get('nodes_reporting', 0)} node(s)"
                     + (f", {restarts} restart(s)" if restarts else ""))
    return "\n".join(lines)
