"""A global server's exit waits for its in-flight work (ROADMAP C15).

The launcher's last step used to be ``po.stop()`` and a return: a
replication ship, or the snapshot a completed ship starts, could still
run in a daemon thread when the interpreter finalized, and a daemon
thread ended inside a device call aborts the process ("terminate called
without an active exception", once on the card).  The abort itself does
not show on the host; its window does: a slow ship is alive at the
moment the launcher would have returned, and
``GlobalServer._await_inflight_at_exit`` closes it.
"""

import threading
import time

import numpy as np

from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.kvstore import checkpoint as ckpt

SHIP_S = 1.0


def _ships(gs):
    return [t for t in threading.enumerate()
            if t.name == f"repl-ship-{gs.po.node}" and t.is_alive()]


def _primary_with_a_slow_ship(monkeypatch):
    """A 2 × 1 + 1 cluster with a hot standby on ``torch:cpu``, whose
    replication ship serializes for ``SHIP_S`` seconds; one round."""
    dumps = ckpt.dumps_server_state

    def slow(*a, **k):
        time.sleep(SHIP_S)
        return dumps(*a, **k)

    monkeypatch.setattr(ckpt, "dumps_server_state", slow)
    cfg = Config(topology=Topology(num_parties=2, workers_per_party=1,
                                   num_standby_globals=1),
                 replicate_every=1, merge_backend="torch:cpu")
    sim = Simulation(cfg)
    ws = sim.all_workers()
    for w in ws:
        w.init(0, np.zeros(16, np.float32))
    ws[0].set_optimizer({"type": "sgd", "lr": 0.5, "momentum": 0.5})
    for w in ws:
        w.push(0, np.ones(16, np.float32))
    for w in ws:
        w.pull_sync(0)
        w.wait_all()
    return sim, sim.global_servers[0]


def test_exit_joins_the_replication_ship_and_starts_no_other(monkeypatch):
    sim, gs = _primary_with_a_slow_ship(monkeypatch)
    try:
        # the window: where the launcher used to return from main, a
        # ship is still running
        deadline = time.monotonic() + 5
        while not _ships(gs) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _ships(gs), "no replication ship in flight"
        t0 = time.monotonic()
        out = gs._await_inflight_at_exit()
        assert out["ships"] >= 1 and out["ships_alive"] == 0, out
        assert time.monotonic() - t0 < SHIP_S + 5
        assert not _ships(gs)
        # nothing ships after it: a forced snapshot starts no thread
        with gs._mu:
            gs._repl.mark_locked(force=True)
        assert not _ships(gs)
    finally:
        sim.shutdown()


def test_exit_does_not_wait_on_a_held_merge_stripe(monkeypatch):
    """A merge lane may hold a stripe of ``_mu`` while it waits on peers
    that are gone: the exit neither takes ``_mu`` nor waits past its
    bound."""
    sim, gs = _primary_with_a_slow_ship(monkeypatch)
    held = threading.Event()
    release = threading.Event()

    def hold():
        with gs._mu:
            held.set()
            release.wait(30)

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    try:
        assert held.wait(5)
        t0 = time.monotonic()
        out = gs._await_inflight_at_exit(timeout_s=SHIP_S + 5)
        assert time.monotonic() - t0 < SHIP_S + 5
        assert out["ships_alive"] == 0, out
    finally:
        release.set()
        holder.join(10)
        sim.shutdown()


def test_exit_of_a_server_without_a_standby_returns_at_once():
    cfg = Config(topology=Topology(num_parties=1, workers_per_party=1),
                 merge_backend="torch:cpu")
    sim = Simulation(cfg)
    try:
        gs = sim.global_servers[0]
        t0 = time.monotonic()
        assert gs._await_inflight_at_exit() == {"ships": 0,
                                                "ships_alive": 0}
        assert time.monotonic() - t0 < 2
    finally:
        sim.shutdown()
