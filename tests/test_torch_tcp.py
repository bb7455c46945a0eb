"""The port's TCP fabric, its copied deployment tools and its
multi-process launcher (``geomx_tpu_torch.launch``) on the CPU.

- The fabric scenarios of ``tests/test_tcp.py`` (a framed round trip,
  a lossy-channel message as a real UDP datagram, an oversize one
  falling back to TCP) and of ``tests/test_multihost.py`` (two nodes on
  distinct loopback addresses) against the port's ``TcpFabric``.
- Each module copied verbatim from the JAX package here equals its
  original once the import prefix is rewritten.
- Launcher clusters, every role its own OS process over loopback TCP on
  a bind-probed free port span, every child killed at the deadline: the
  CNN workload (``--device cpu --merge-backend numpy``, 3 steps) on
  1 × 1 + global tier, and under ``--hfa`` and ``--esync`` on 1 × 2, in
  tier-1; the ``--p3`` staged run (priority-queue
  overtakes) and a small-width ``--workload lm --compression mpq`` run
  on the torch backend on the host are marked ``slow``, as their JAX
  counterparts in ``tests/test_acceptance_matrix.py`` are.
"""

import pathlib
import re
import threading

import numpy as np
import pytest

from geomx_tpu_torch.core.config import Topology
from geomx_tpu_torch.launch import free_base_port, run_local_cluster
from geomx_tpu_torch.transport import Message, Van
from geomx_tpu_torch.transport.tcp import TcpFabric, default_address_plan

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ("transport/tcp.py", "chaos/__init__.py", "chaos/netfault.py",
          "chaos/churn.py", "serve/load.py", "status.py")


# repairs the port's copies carry (ROADMAP C): (the port's text, the
# JAX original's); with them reverted the copy equals its original
REPAIRS = {
    "transport/tcp.py": [  # C12, C14: a first dial leaves the sender
        ("""        self._dial_window: Dict[str, float] = {}
        # peers being dialed off the sender's thread (_dial_or_defer):
        # the frames sent to each meanwhile, in order
        self._dialing: Dict[str, list] = {}
""",
         """        self._dial_window: Dict[str, float] = {}
"""),
        ("""        with mu:
            queued = self._dialing.get(dest)
            if queued is not None:  # behind the first dial to this peer
                queued.append(frames)
                return True
            conn = self._conns.get(dest)""",
         """        with mu:
            conn = self._conns.get(dest)"""),
        ("""                conn = self._dial_or_defer(dest, frames)
                if conn is None:
                    return True
""",
         """                conn = self._dial(dest)
"""),
        ('''    def _dial_or_defer(self, dest: str, frames) -> Optional[socket.socket]:
        """One connect attempt to ``dest``; if it is refused while the
        peer's bring-up window is open (never reached yet), the rest of
        the window is waited out on a thread of its own
        (:meth:`_dial_behind`), which sends ``frames`` and whatever
        follows them once the peer answers: returns None then.  So no
        send holds its thread for the window: not a relaunched server's
        notices to a dead worker, nor a client's first read at a killed
        replica (C12, C14).  Caller holds the destination's lock."""
        try:
            return self._dial(dest, retry_for=0.0)
        except OSError as e:
            transient = (isinstance(e, TimeoutError)
                         or e.errno in self._TRANSIENT_ERRNOS)
            with self._registry_mu:
                opened = self._dial_window.get(dest, 0.0)
                patient = (transient and not self._stop
                           and dest not in self._established
                           and time.monotonic() < opened + self.DIAL_WINDOW_S)
            if not patient:
                raise
        self._dialing[dest] = [frames]
        threading.Thread(target=self._dial_behind, args=(dest,),
                         daemon=True, name=f"dial-{dest}").start()
        return None

    def _dial_behind(self, dest: str) -> None:
        """Dial ``dest`` through its bring-up window, then send what
        queued for it in order; a peer that never answers loses those
        messages, ledgered as drops (the resend layer owns recovery, as
        for a dial that fails in the sender's thread)."""
        try:
            conn = self._dial(dest)
        except OSError:
            conn = None
        with self._registry_mu:
            mu = self._conn_mus[dest]
        with mu:
            queued = self._dialing.pop(dest)
            while conn is not None and queued:
                try:
                    self._send_on(conn, queued[0])
                except OSError:
                    conn.close()
                    self._conns.pop(dest, None)
                    break
                queued.pop(0)
            with self._registry_mu:
                for _ in queued:
                    self._count_drop()

''',
         """"""),
        ("""    # how long a first dial to a peer retries while its listener comes up
    DIAL_WINDOW_S = 30.0

    def _dial(self, dest: str, retry_for: float = DIAL_WINDOW_S
              ) -> socket.socket:""",
         """    def _dial(self, dest: str, retry_for: float = 30.0) -> socket.socket:"""),
    ],
}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_its_jax_original(rel):
    orig = (ROOT / "geomx_tpu" / rel).read_text()
    port = (ROOT / "geomx_tpu_torch" / rel).read_text()
    for repaired, original in REPAIRS.get(rel, ()):
        assert port.count(repaired) == 1, (rel, repaired)
        port = port.replace(repaired, original)
    assert re.sub(r"geomx_tpu\b", "geomx_tpu_torch", orig) == port


def _pair(plan, a, b, fab_a, fab_b):
    van_a, van_b = Van(a, fab_a), Van(b, fab_b)
    got, ev = [], threading.Event()
    van_a.start(lambda m: None)
    van_b.start(lambda m: (got.append(m), ev.set()))
    return van_a, van_b, got, ev


def test_tcp_fabric_roundtrip():
    topo = Topology(num_parties=1, workers_per_party=1)
    plan = default_address_plan(topo, base_port=free_base_port())
    fab = TcpFabric(plan)
    a, b = topo.workers(0)[0], topo.server(0)
    van_a, van_b, got, ev = _pair(plan, a, b, fab, fab)
    try:
        van_a.send(Message(recipient=b, timestamp=3,
                           keys=np.array([1], np.int64),
                           vals=np.arange(5, dtype=np.float32),
                           lens=np.array([5], np.int64)))
        assert ev.wait(5)
        np.testing.assert_array_equal(got[0].vals,
                                      np.arange(5, dtype=np.float32))
        assert got[0].sender == a and got[0].timestamp == 3
    finally:
        van_a.stop(); van_b.stop(); fab.shutdown()


@pytest.mark.parametrize("n,udp", [(16, True), (100_000, False)])
def test_lossy_channel_rides_udp_unless_oversize(n, udp):
    """A lossy-channel message is one UDP datagram; a payload beyond the
    datagram limit (400 KB) rides the reliable connection.  Two fabrics
    stand for two processes (one would shortcut through its mailbox)."""
    topo = Topology(num_parties=1, workers_per_party=1)
    plan = default_address_plan(topo, base_port=free_base_port())
    a, b = topo.workers(0)[0], topo.server(0)
    fab_a, fab_b = TcpFabric(dict(plan)), TcpFabric(dict(plan))
    van_a, van_b, got, ev = _pair(plan, a, b, fab_a, fab_b)
    try:
        van_a.send(Message(recipient=b, channel=2 if udp else 1, seq=0,
                           seq_end=5, vals=np.arange(n, dtype=np.float32)))
        assert ev.wait(5)
        assert fab_a.udp_datagrams_sent == int(udp)
        assert fab_b.udp_datagrams_recv == int(udp)
        np.testing.assert_array_equal(got[0].vals,
                                      np.arange(n, dtype=np.float32))
    finally:
        van_a.stop(); van_b.stop()
        fab_a.shutdown(); fab_b.shutdown()


def test_tcp_fabric_crosses_distinct_addresses():
    """Party 0 on 127.0.0.2, party 1 on 127.0.0.3 (GEOMX_NODE_HOSTS'
    plan): a worker reaches the other party's server across them."""
    topo = Topology(num_parties=2, workers_per_party=1)
    hosts = {str(n): ("127.0.0.2" if "@p0" in str(n) else
                      "127.0.0.3" if "@p1" in str(n) else "127.0.0.1")
             for n in topo.all_nodes()}
    plan = default_address_plan(topo, base_port=free_base_port(),
                                hosts=hosts)
    w0, s1 = topo.workers(0)[0], topo.server(1)
    assert plan[str(w0)][0] != plan[str(s1)][0]
    fab_a, fab_b = TcpFabric(plan), TcpFabric(plan)
    van_a, van_b, got, ev = _pair(plan, w0, s1, fab_a, fab_b)
    try:
        van_a.send(Message(recipient=s1, timestamp=7,
                           keys=np.array([1], np.int64),
                           vals=np.arange(4, dtype=np.float32),
                           lens=np.array([4], np.int64)))
        assert ev.wait(10), "message never crossed the address boundary"
        np.testing.assert_array_equal(got[0].vals,
                                      np.arange(4, dtype=np.float32))
        assert got[0].sender == w0
    finally:
        van_a.stop(); van_b.stop()
        fab_a.shutdown(); fab_b.shutdown()


def _cluster(parties, workers, extra, steps, deadline_s, env=None):
    import os

    outs = run_local_cluster(
        parties, workers, ["--device", "cpu", "--steps", str(steps),
                           *extra],
        env=dict(os.environ, **(env or {})), deadline_s=deadline_s,
        cwd=str(ROOT))
    for role, (rc, out) in outs.items():
        assert rc == 0, f"{role} rc={rc}: {out[-1500:]}"
    for w in Topology(num_parties=parties,
                      workers_per_party=workers).workers(0):
        assert f"steps={steps}" in outs[str(w)][1], outs[str(w)][1][-800:]
    return {r: out for r, (_, out) in outs.items()}


def _stat(outputs, pattern):
    return sum(int(m.group(1)) for out in outputs.values()
               for m in re.finditer(pattern, out))


@pytest.mark.parametrize("workers,mode", [(1, []), (2, ["--hfa"]),
                                          (2, ["--esync"])])
def test_launcher_cnn_cluster_on_the_host(workers, mode):
    """The CNN workload, plain (FSA), under HFA (weights pushed, k1 = 2)
    and under ESync (the state server's step plans; steps = sync
    rounds)."""
    outs = _cluster(1, workers, ["--merge-backend", "numpy", *mode],
                    steps=3, deadline_s=180)
    assert "merge_backend=numpy" in outs["server:0@p0"]
    assert "codec_launches=" in outs["server:0@p0"]
    assert _stat(outs, r"wan_tx=(\d+)") > 0
    if mode == ["--esync"]:
        for w in ("worker:0@p0", "worker:1@p0"):
            assert "esync_rounds=[" in outs[w], outs[w][-800:]


@pytest.mark.slow
def test_launcher_p3_staged_priority_inversions():
    outs = _cluster(1, 1, ["--merge-backend", "numpy", "--p3"], steps=3,
                    deadline_s=180)
    assert _stat(outs, r"pq_overtakes=(\d+)") > 0, outs


@pytest.mark.slow
def test_launcher_lm_mpq_on_the_torch_backend():
    """The flagship LM at small widths through MPQ (bound 2,000: the
    d_ff and qkv leaves go BSC, the norms fp16) on the torch backend on
    the host."""
    env = {"GEOMX_MPQ_SIZE_BOUND": "2000", "GEOMX_LM_VOCAB": "256",
           "GEOMX_LM_DMODEL": "32", "GEOMX_LM_HEADS": "4",
           "GEOMX_LM_LAYERS": "2", "GEOMX_LM_DFF": "64",
           "GEOMX_LM_SEQ": "16"}
    outs = _cluster(1, 1, ["--merge-backend", "torch:cpu", "--workload",
                           "lm", "--compression", "mpq", "--batch", "4"],
                    steps=3, deadline_s=300, env=env)
    w = outs["worker:0@p0"]
    assert re.search(r"n_params=25248\b", w), w
    assert re.search(r"tokens_per_sec=[\d.]+", w), w
    assert _stat(outs, r"mpq_bsc=(\d+)") > 0, outs
    assert _stat(outs, r"mpq_fp16=(\d+)") > 0, outs
    assert _stat(outs, r"wan_tx=(\d+)") > 0, outs
    assert "merge_backend=torch" in outs["server:0@p0"]
