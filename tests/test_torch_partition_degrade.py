"""C11: a party cut off between its WAN batch's acks and the batch's
pull-down degrades all the same.

The local server's degrade watchdog (partition mode) counted only WAN
push batches awaiting their acks.  A blackhole that lands after the
acks, when the server has sent its pull-down request, left nothing it
counted in flight: the round waited for weights that could not come,
no later round pushed, and the party never entered degraded mode
(``scripts/run_partition_demo.sh``: "TIMEOUT waiting for 'entered
degraded mode'"; ``tests/test_partition.py``'s region-outage soak after
other cases in one process).  The port's copy counts the pull-downs
too.  Here the cut is made exactly there, on ``torch:cpu`` and on the
numpy backend: the party degrades within the window, closes local rounds
against frozen weights, and catches up on heal.
"""

import time

import numpy as np
import pytest

from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation


def _wait_for(pred, timeout=20.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


@pytest.mark.parametrize("backend", ["numpy", "torch:cpu"])
def test_cut_between_acks_and_pull_down_degrades(backend):
    sim = Simulation(Config(
        topology=Topology(num_parties=2, workers_per_party=1),
        heartbeat_interval_s=0.05, heartbeat_timeout_s=0.4,
        enable_partition_mode=True, probe_timeout_s=0.4,
        sync_global_mode=False, partition_degrade_s=0.6,
        merge_backend=backend))
    try:
        w0, w1 = sim.all_workers()
        for w in (w0, w1):
            w.init(0, np.zeros(8, np.float32))
        w0.set_optimizer({"type": "sgd", "lr": 1.0})
        for w in (w0, w1):
            w.push(0, np.ones(8, np.float32))
            w.wait_all()
        ls0 = sim.local_servers[0]
        assert _wait_for(lambda: not any(
            st.in_flight for st in ls0._keys.values()))

        # the next round's batch is acked; the blackhole lands as the
        # server sends the batch's pull-down request
        zpull, cut = ls0.up.zpull, []

        def cut_then_pull(*args, **kwargs):
            if not cut:
                cut.append(True)
                sim.partition_party(0)
            return zpull(*args, **kwargs)

        ls0.up.zpull = cut_then_pull
        w0.push(0, np.ones(8, np.float32))
        w0.wait_all()
        assert _wait_for(lambda: bool(cut), 10), "no pull-down was sent"
        with ls0._ctr_mu:
            assert ls0._wan_inflight == 0, "the batch's acks never came"
        assert _wait_for(lambda: ls0._degraded, 15), \
            "a party cut before its pull-down never degraded"
        ls0.up.zpull = zpull

        # degraded rounds close locally and accrue the catch-up delta
        for _ in range(2):
            w0.push(0, np.ones(8, np.float32))
            w0.wait_all()
        assert _wait_for(lambda: ls0._catchup_rounds == 2, 10), \
            ls0._catchup_rounds
        sim.heal_party(0)
        assert _wait_for(lambda: ls0.catchup_pushes == 1, 30)
        assert ls0.catchup_fallbacks == 0
    finally:
        sim.shutdown()
