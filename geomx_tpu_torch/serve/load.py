"""Operator read-load driver: ``python -m geomx_tpu_torch.serve.load``.

Joins a running TCP deployment as an OUT-OF-PLAN read client (its bind
address rides the static plan like the status console's), discovers the
target replica's key set, and hammers it with ``Cmd.SERVE_PULL`` reads
for ``--seconds``, printing one summary line::

    serve_load: replica=replica:0 pulls=412 qps=137.3 p50_ms=1.2 \
p99_ms=4.8 max_staleness_s=0.41 errors=0

``--assert-staleness`` exits non-zero if any *successful* read reported
a staleness above the bound — the demo script's survivor assertion.
Topology comes from the same env surface the launcher uses, with CLI
overrides (see docs/serving.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from geomx_tpu_torch.core.config import Config, NodeId, Role, Topology
from geomx_tpu_torch.ps import Postoffice
from geomx_tpu_torch.serve.client import ReplicaClient
from geomx_tpu_torch.transport.tcp import TcpFabric, default_address_plan

# out-of-plan rank family for load clients (status.py uses 900+; several
# load drivers may run at once — the rank folds in the bind port)
_LOAD_RANK_BASE = 700


def _percentile(vs, q):
    if not vs:
        return float("nan")
    vs = sorted(vs)
    return vs[min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.serve.load",
        description="read-load driver for the serve replica tier")
    ap.add_argument("--replica", type=int, default=0,
                    help="target replica rank")
    ap.add_argument("--balance", action="store_true",
                    help="read through the ServeBalancer across ALL "
                         "replicas (p2c + health ejection + shed "
                         "honoring) instead of pinning --replica; "
                         "prints an extra serve_lb summary line")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--timeout", type=float, default=5.0,
                    help="per-read timeout")
    ap.add_argument("--assert-staleness", action="store_true",
                    help="exit 1 if any successful read exceeded the "
                         "GEOMX_SERVE_STALENESS_S bound")
    ap.add_argument("--max-shed-frac", type=float, default=-1.0,
                    help="with --balance: exit 1 if more than this "
                         "fraction of reads were shed (the bounded-"
                         "shedding assertion; <0 = no assertion)")
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
    ap.add_argument("--load-port", type=int, default=0,
                    help="local reply port (default base-port + 191 + "
                         "replica rank)")
    args = ap.parse_args(argv)

    cfg = Config.from_env()
    cfg.heartbeat_interval_s = 0.0  # passive querier: no scheduler slot
    cfg.topology = Topology(num_parties=args.parties,
                            workers_per_party=args.workers,
                            num_global_servers=args.global_shards,
                            num_standby_globals=args.standby_globals,
                            num_replicas=args.replicas)
    port = args.load_port or args.base_port + 191 + args.replica
    hosts = json.loads(os.environ.get("GEOMX_NODE_HOSTS", "{}"))
    plan = default_address_plan(cfg.topology, args.base_port, hosts)
    me = NodeId(Role.MASTER_WORKER, _LOAD_RANK_BASE + port % 97)
    plan[str(me)] = ("127.0.0.1", port)
    fabric = TcpFabric(plan, config=cfg)
    po = Postoffice(me, cfg.topology, fabric, cfg)
    po.start()
    lb = None
    if args.balance:
        from geomx_tpu_torch.serve.balancer import ServeBalancer

        if cfg.topology.num_replicas < 1:
            print("serve_load: FAIL --balance needs --replicas >= 1",
                  flush=True)
            return 1
        lb = ServeBalancer(po, cfg, advertise=("127.0.0.1", port))
        client = lb  # same pull/list_keys surface
        who = f"balance={cfg.topology.num_replicas}-replicas"
    else:
        client = ReplicaClient(po, cfg, replica=args.replica,
                               advertise=("127.0.0.1", port))
        who = f"replica=replica:{args.replica}"
    bound = float(os.environ.get("GEOMX_SERVE_STALENESS_S",
                                 cfg.serve_staleness_s))
    pulls = errors = sheds = 0
    lat_ms, staleness = [], []
    try:
        # bootstrap: wait for the replica to hold keys (training INITs
        # may still be in flight when the driver starts)
        deadline = time.monotonic() + args.timeout * 4
        keys = []
        while time.monotonic() < deadline:
            try:
                keys = client.list_keys(timeout=args.timeout)
            except (TimeoutError, RuntimeError, OSError):
                keys = []
            if keys:
                break
            time.sleep(0.3)
        if not keys:
            print(f"serve_load: {who} FAIL no-keys (replica "
                  "unreachable or model uninitialized)", flush=True)
            return 1
        t_end = time.monotonic() + args.seconds
        i = 0
        while time.monotonic() < t_end:
            k = keys[i % len(keys)]
            i += 1
            t0 = time.perf_counter()
            try:
                _, meta = client.pull([k], timeout=args.timeout)
            except (TimeoutError, RuntimeError, OSError):
                errors += 1
                continue
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            s = meta.get("staleness_s")
            if isinstance(s, (int, float)):
                staleness.append(float(s))
            pulls += 1
        if lb is not None:
            sheds = lb.stats()["sheds"]
    finally:
        if lb is not None:
            lb.stop()
        else:
            client.stop()
        po.stop()
        fabric.shutdown()
    dur = max(args.seconds, 1e-9)
    max_stale = max(staleness) if staleness else float("nan")
    print(f"serve_load: {who} pulls={pulls} "
          f"qps={pulls / dur:.1f} "
          f"p50_ms={_percentile(lat_ms, 0.5):.1f} "
          f"p99_ms={_percentile(lat_ms, 0.99):.1f} "
          f"max_staleness_s={max_stale:.2f} errors={errors}",
          flush=True)
    if lb is not None:
        st = lb.stats()
        print(f"serve_lb: failovers={st['failovers']} "
              f"sheds={st['sheds']} ejections={st['ejections']} "
              f"probes={st['probes']} recoveries={st['recoveries']}",
              flush=True)
    if pulls == 0:
        print("serve_load: FAIL no successful reads", flush=True)
        return 1
    if args.assert_staleness and staleness and max_stale > bound:
        print(f"serve_load: FAIL staleness bound violated "
              f"({max_stale:.2f}s > {bound:.2f}s)", flush=True)
        return 1
    if lb is not None and args.max_shed_frac >= 0:
        frac = sheds / max(pulls + sheds, 1)
        if frac > args.max_shed_frac:
            print(f"serve_load: FAIL shed fraction {frac:.2f} > "
                  f"{args.max_shed_frac:.2f} (sheds unbounded)",
                  flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
