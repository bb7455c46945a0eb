"""Operator cluster-state console: ``python -m geomx_tpu_torch.status``.

Joins the deployment's TCP plan as an OUT-OF-PLAN querier (its reply
address travels in the request body, like a dynamic joiner's), asks the
global scheduler for ``Ctrl.CLUSTER_STATE``, and renders the live text
dashboard — shard holders/terms, party fold state, per-node heartbeat
freshness, WAN policy epoch, active health alerts, and the flight
recorder's pressure column.  ``--watch`` redraws on an interval until
interrupted; ``--dump-flight`` instead asks the scheduler to broadcast
a flight-recorder snapshot (every node dumps its black-box ring to
``GEOMX_OBS_DIR`` — see docs/observability.md "Postmortem
forensics").

Topology comes from the same env surface the launcher uses
(GEOMX_NUM_PARTIES / GEOMX_WORKERS_PER_PARTY / GEOMX_GLOBAL_SHARDS /
GEOMX_NUM_STANDBY_GLOBALS / GEOMX_BASE_PORT / GEOMX_NODE_HOSTS), with
CLI overrides.  See docs/observability.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from geomx_tpu_torch.core.config import Config, NodeId, Role, Topology
from geomx_tpu_torch.kvstore.common import APP_PS, Ctrl
from geomx_tpu_torch.obs.state import render_text
from geomx_tpu_torch.ps import Postoffice
from geomx_tpu_torch.ps.kv_app import _App
from geomx_tpu_torch.transport.message import Domain
from geomx_tpu_torch.transport.tcp import TcpFabric, default_address_plan

# out-of-plan rank for the console's node id: far above any planned
# master worker, so two operators can even watch at once (ranks differ
# by --status-port, the identity includes it)
_STATUS_RANK_BASE = 900


class _QueryApp(_App):
    """Command-channel-only endpoint: sends the query, collects the
    reply (the controller's _CmdEndpoint shape)."""

    def _process(self, msg):
        if not msg.push and not msg.pull:
            self._handle_command(msg)
        # stray data traffic at the console is dropped


class StatusClient:
    """One short-lived (or --watch long-lived) query endpoint."""

    def __init__(self, config: Config, base_port: int,
                 status_port: int, host: str = "127.0.0.1"):
        # the console is a passive querier: no heartbeats (it has no
        # scheduler slot to ping — they would only log dial noise)
        config.heartbeat_interval_s = 0.0
        self.config = config
        hosts = json.loads(os.environ.get("GEOMX_NODE_HOSTS", "{}"))
        plan = default_address_plan(config.topology, base_port, hosts)
        self.node = NodeId(Role.MASTER_WORKER,
                           _STATUS_RANK_BASE + status_port % 97)
        self.addr = (host, status_port)
        plan[str(self.node)] = self.addr
        self.fabric = TcpFabric(plan, config=config)
        self.po = Postoffice(self.node, config.topology, self.fabric,
                             config)
        self.po.start()
        self._app = _QueryApp(APP_PS, 0, self.po)

    def query(self, timeout: float = 5.0) -> dict:
        return self._cmd(Ctrl.CLUSTER_STATE, {}, timeout,
                         "empty cluster-state reply")

    def dump_flight(self, out_dir: str = "", timeout: float = 5.0) -> dict:
        """Ask the scheduler to broadcast a flight-recorder snapshot
        (Ctrl.FLIGHT_DUMP → Control.FLIGHT_DUMP to every node); returns
        the reply naming the dump dir + expected per-node paths."""
        body = {"dir": out_dir} if out_dir else {}
        return self._cmd(Ctrl.FLIGHT_DUMP, body, timeout,
                         "empty flight-dump reply")

    def _cmd(self, cmd, body: dict, timeout: float, err: str) -> dict:
        gsched = self.po.topology.global_scheduler()
        body = dict(body, addr=[self.addr[0], self.addr[1]])
        ts = self._app.send_cmd(gsched, cmd, body=body,
                                domain=Domain.GLOBAL, wait=False)
        self._app.customer.wait(ts, timeout=timeout)
        reply = self._app.cmd_response(ts)
        if not isinstance(reply, dict):
            raise RuntimeError(err)
        return reply

    def stop(self):
        self._app.stop()
        self.po.stop()
        self.fabric.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.status",
        description="live cluster-state console (Ctrl.CLUSTER_STATE)")
    ap.add_argument("--watch", action="store_true",
                    help="redraw every --interval seconds until ^C")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="dump the raw state dict instead of the "
                         "dashboard")
    ap.add_argument("--parties", type=int,
                    default=int(os.environ.get("GEOMX_NUM_PARTIES", "1")))
    ap.add_argument("--workers", type=int,
                    default=int(os.environ.get("GEOMX_WORKERS_PER_PARTY",
                                               "1")))
    ap.add_argument("--global-shards", type=int,
                    default=int(os.environ.get(
                        "GEOMX_GLOBAL_SHARDS",
                        os.environ.get("GEOMX_NUM_GLOBAL_SERVERS", "1"))))
    ap.add_argument("--standby-globals", type=int,
                    default=int(os.environ.get("GEOMX_NUM_STANDBY_GLOBALS",
                                               "0")))
    ap.add_argument("--replicas", type=int,
                    default=int(os.environ.get("GEOMX_SERVE_REPLICAS",
                                               "0")))
    ap.add_argument("--base-port", type=int,
                    default=int(os.environ.get("GEOMX_BASE_PORT", "9200")))
    ap.add_argument("--status-port", type=int,
                    default=int(os.environ.get("GEOMX_STATUS_PORT", "0"))
                    or None,
                    help="local reply port (default base-port + 177)")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--dump-flight", action="store_true",
                    help="ask every node to snapshot its black-box "
                         "flight-recorder ring to the cluster's "
                         "GEOMX_OBS_DIR (or --flight-dir), then exit; "
                         "assemble with python -m "
                         "geomx_tpu_torch.obs.postmortem <dir>")
    ap.add_argument("--flight-dir", default="",
                    help="dump directory override sent with "
                         "--dump-flight (must be writable by the "
                         "cluster's processes)")
    args = ap.parse_args(argv)

    cfg = Config.from_env()
    cfg.topology = Topology(num_parties=args.parties,
                            workers_per_party=args.workers,
                            num_global_servers=args.global_shards,
                            num_standby_globals=args.standby_globals,
                            num_replicas=args.replicas)
    client = StatusClient(cfg, args.base_port,
                          args.status_port or args.base_port + 177)
    try:
        if args.dump_flight:
            try:
                reply = client.dump_flight(args.flight_dir,
                                           timeout=args.timeout)
            except (TimeoutError, RuntimeError) as e:
                print(f"status: flight dump failed ({e})",
                      file=sys.stderr)
                return 1
            if not reply.get("ok"):
                print(f"status: flight dump refused — "
                      f"{reply.get('error')}", file=sys.stderr)
                return 1
            print(f"flight dump requested: incident "
                  f"{reply.get('incident')} -> {reply.get('dir')} "
                  f"({reply.get('nodes')} node(s)); assemble with "
                  f"python -m geomx_tpu_torch.obs.postmortem "
                  f"{reply.get('dir')}")
            return 0
        while True:
            try:
                state = client.query(timeout=args.timeout)
            except (TimeoutError, RuntimeError) as e:
                print(f"status: no answer from the global scheduler "
                      f"({e})", file=sys.stderr)
                if not args.watch:
                    return 1
                time.sleep(args.interval)
                continue
            if args.as_json:
                print(json.dumps(state, indent=1, sort_keys=True))
            else:
                if args.watch:
                    sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
                print(render_text(state), flush=True)
            if not args.watch:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        client.stop()


if __name__ == "__main__":
    sys.exit(main())
