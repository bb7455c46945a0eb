"""C12: a recovering party's notifications do not wait on a dead peer.

A relaunched local server has dialed no peer yet, and the global
scheduler's recovery monitor has never dialed a worker.  Over TCP a
first dial to a peer that is down (``scripts/run_churn_demo.sh``'s
drained worker) retried for the fabric's bring-up window, 30 s, in the
sender's thread.  The warm boot's membership broadcast and the
monitor's "server back" notices went out in line, so the warm boot's
REJOIN reply, and with it the party's recovery, waited those 30 s (the
tour's recovered party then finished after the run's terminator on the
card).  The port's ``TcpFabric`` now makes one connect attempt and, if
it is refused, dials through the window on a thread of its own
(``_dial_or_defer``).  Here the dead worker's messages ride a real
``TcpFabric`` to a port nobody listens on, the rest stay in process;
the worker then comes up and receives what was queued for it.
"""

import socket
import time

import numpy as np

from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.transport.message import Control
from geomx_tpu_torch.transport.tcp import TcpFabric


class _DeadOverTcp:
    """A van's fabric: messages to ``dead`` go over ``tcp``, the rest to
    ``inproc``; ``sent`` collects the recipients of ``control``."""

    def __init__(self, inproc, tcp, dead: str, control, sent: list):
        self.inproc, self.tcp, self.dead = inproc, tcp, dead
        self.control, self.sent = control, sent

    def deliver(self, msg, *args, **kwargs):
        if msg.control is self.control:
            self.sent.append(str(msg.recipient))
        if str(msg.recipient) == self.dead:
            return self.tcp.deliver(msg)
        return self.inproc.deliver(msg, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.inproc, name)


def _free_addr():
    with socket.socket() as s:           # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        return s.getsockname()


def _route_dead_over_tcp(van, dead_node, control, sent):
    """Point ``van``'s messages to ``dead_node`` at a closed port; returns
    (the fabric, the dead node's address)."""
    addr = _free_addr()
    tcp = TcpFabric({str(dead_node): addr})
    van.fabric = _DeadOverTcp(van.fabric, tcp, str(dead_node), control,
                              sent)
    return tcp, addr


def _comes_up(node, addr):
    """``node``'s listener at ``addr``: (its fabric, its mailbox)."""
    fab = TcpFabric({str(node): addr})
    return fab, fab.register(node)


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_warm_boot_does_not_wait_on_a_dead_worker():
    sim = Simulation(Config(topology=Topology(num_parties=2,
                                              workers_per_party=2),
                            merge_backend="torch:cpu"))
    fabs = []
    try:
        ws = sim.all_workers()
        for w in ws:
            w.init(0, np.zeros(16, np.float32))
        ls = sim.local_servers[1]
        dead = sim.topology.workers(1)[1]
        sent = []
        tcp, addr = _route_dead_over_tcp(ls.po.van, dead, Control.ADD_NODE,
                                         sent)
        fabs.append(tcp)
        t0 = time.monotonic()
        assert ls.warm_boot() == 1
        took = time.monotonic() - t0
        assert took < 2.0, f"warm boot waited {took:.1f} s"
        assert {"worker:0@p1", "worker:1@p1", "scheduler:0@p1"} <= set(sent)
        # the worker comes back inside the window: the notice reaches it
        back, box = _comes_up(dead, addr)
        fabs.append(back)
        msg = box.q.get(timeout=10)
        assert msg.control is Control.ADD_NODE
        assert msg.body["event"] == "membership"
    finally:
        for f in fabs:
            f.shutdown()
        sim.shutdown()


def test_recovery_monitor_notices_do_not_wait_on_a_dead_worker():
    sim = Simulation(Config(topology=Topology(num_parties=2,
                                              workers_per_party=2),
                            heartbeat_interval_s=0.1,
                            heartbeat_timeout_s=2.0,
                            merge_backend="torch:cpu"))
    fabs = []
    try:
        for w in sim.all_workers():
            w.init(0, np.zeros(16, np.float32))
        rm = sim.recovery_monitor
        node = sim.topology.server(1)
        dead = sim.topology.workers(1)[0]
        sent = []
        tcp, addr = _route_dead_over_tcp(rm.po.van, dead, Control.REJOIN,
                                         sent)
        fabs.append(tcp)
        with rm._mu:
            rm._folded[1] = node
        t0 = time.monotonic()
        rm._recover(1)
        took = time.monotonic() - t0
        assert took < 2.0, f"the recovery waited {took:.1f} s"
        assert rm.party_unfolds == 1
        assert sorted(r for r in sent if r.startswith("worker:")) == [
            "worker:0@p1", "worker:1@p1"]
        back, box = _comes_up(dead, addr)
        fabs.append(back)
        msg = box.q.get(timeout=10)
        assert msg.control is Control.REJOIN
        assert msg.body == {"event": "server_back", "server": str(node)}
    finally:
        for f in fabs:
            f.shutdown()
        sim.shutdown()


def test_first_dial_queues_in_order_then_drops_past_the_window():
    """Messages to a peer that is not up yet leave the sender at once and
    reach the peer in the order sent when it comes up.  A peer that never
    comes up loses its queue, ledgered as drops, once the window is past,
    and a later send fails in the sender's thread, at once, as before."""
    from geomx_tpu_torch.core.config import NodeId
    from geomx_tpu_torch.transport.message import Message

    late, never = NodeId.parse("worker:0@p0"), NodeId.parse("worker:1@p0")
    plan = {str(late): _free_addr(), str(never): _free_addr()}
    fab = TcpFabric(dict(plan))
    fabs = [fab]
    # the never-up peer's window has 1 s left
    fab._dial_window[str(never)] = time.monotonic() + 1.0 - fab.DIAL_WINDOW_S
    try:
        t0 = time.monotonic()
        for i in range(3):
            for n in (late, never):
                assert fab.deliver(Message(recipient=n, timestamp=i,
                                           control=Control.EMPTY))
        assert time.monotonic() - t0 < 2.0
        back, box = _comes_up(late, plan[str(late)])
        fabs.append(back)
        assert [box.q.get(timeout=10).timestamp for _ in range(3)] == \
            [0, 1, 2]
        assert _wait_for(lambda: str(never) not in fab._dialing, 5.0)
        assert fab.dropped == 3
        t0 = time.monotonic()
        try:
            fab.deliver(Message(recipient=never, control=Control.EMPTY))
        except OSError:
            pass
        else:
            raise AssertionError("a send past the window did not fail")
        assert time.monotonic() - t0 < 2.0
    finally:
        for f in fabs:
            f.shutdown()


def test_first_dial_keeps_every_sender_in_order():
    """More sending threads than cores, at a peer that comes up while
    they send (some sends queue behind the dial, later ones go straight
    out): every message arrives once, each thread's in the order it
    sent them."""
    import os
    import sys
    import threading

    from geomx_tpu_torch.core.config import NodeId
    from geomx_tpu_torch.transport.message import Message

    peer = NodeId.parse("worker:0@p0")
    addr = _free_addr()
    fab = TcpFabric({str(peer): addr})
    fabs = [fab]
    threads_n, per = 2 * (os.cpu_count() or 4), 20
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        go = threading.Barrier(threads_n + 1)

        def send(t):
            go.wait()
            for i in range(per):
                fab.deliver(Message(recipient=peer, control=Control.EMPTY,
                                    timestamp=t * 1000 + i))
                time.sleep(0.001)

        ts = [threading.Thread(target=send, args=(t,), daemon=True)
              for t in range(threads_n)]
        for t in ts:
            t.start()
        go.wait()
        time.sleep(0.01)
        back, box = _comes_up(peer, addr)
        fabs.append(back)
        for t in ts:
            t.join(30)
            assert not t.is_alive()
        got = [box.q.get(timeout=10).timestamp
               for _ in range(threads_n * per)]
        assert box.q.empty()
        for t in range(threads_n):
            mine = [x % 1000 for x in got if x // 1000 == t]
            assert mine == list(range(per)), (t, mine)
    finally:
        sys.setswitchinterval(interval)
        for f in fabs:
            f.shutdown()
