"""BSC pull compression after a global server's restart (ROADMAP C8).

A restarted global server rebuilds its pull compressor
(``BroadcastCompressor``, ``trust_init=False``): every party's next
pull resyncs dense. The JAX package forks each resynced subscriber onto
a lineage of its own, so from the next round on each party gets a top-k
of its own sampled threshold, and FSA parties that must hold the same
weights drift apart (``tests/test_stress.py``'s 4 × 4 scale run fails
on the JAX package for it). The port's copy shares a resync lineage
among subscribers resynced to the same weights array at the same
version (their views are the same bits), so they share each round's one
top-k again:

- two subscribers resynced to one weights array get the same sparse
  payload next round, and a subscriber resynced to other weights does
  not share it;
- 4 parties × 1 worker, BSC at 0.1 %, the global server killed and
  restarted from its checkpoint mid-run: every party pulls the same
  weights in every round after, on the numpy and the torch backend.

Tolerance: bitwise.
"""

import tempfile

import numpy as np
import pytest

from geomx_tpu_torch.compression.codecs import BroadcastCompressor
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.kvstore.server import GlobalServer
from geomx_tpu_torch.ps import Postoffice


def test_resynced_subscribers_share_the_next_round_payload():
    rng = np.random.default_rng(3)
    pc = BroadcastCompressor(ratio=0.01, trust_init=False)
    w1 = rng.standard_normal(20000).astype(np.float32)
    sent = {s: pc.compress(s, 0, w1, echo_ver=1) for s in ("a", "b")}
    assert all(tag == "f32" and ver == 2 for _, tag, ver in sent.values())
    w_other = w1.copy()
    assert pc.compress("c", 0, w_other, echo_ver=1)[1] == "f32"
    w2 = w1 + rng.standard_normal(20000).astype(np.float32)
    pa, ta, _ = pc.compress("a", 0, w2, echo_ver=2)
    pb, tb, _ = pc.compress("b", 0, w2, echo_ver=2)
    assert ta == tb == "bsc"
    assert pa.tobytes() == pb.tobytes()
    # same content, another array: its own lineage, its own sample
    assert pc._lineage[("c", 0)] != pc._lineage[("a", 0)]


@pytest.mark.parametrize("backend", ["numpy", "torch:cpu"])
def test_parties_agree_after_a_restart_under_bsc(backend):
    n = 300_000
    tmp = tempfile.mkdtemp()
    cfg = Config(topology=Topology(num_parties=4, workers_per_party=1),
                 request_retry_s=2.0, checkpoint_dir=tmp,
                 auto_ckpt_updates=1, merge_backend=backend)
    sim = Simulation(cfg)
    try:
        ws = sim.all_workers()
        for w in ws:
            w.init(0, np.zeros(n, np.float32))
        ws[0].set_optimizer({"type": "sgd", "lr": 0.1})
        for p in range(4):
            sim.worker(p, 0).set_gradient_compression(
                {"type": "bsc", "ratio": 0.001})
        g = np.abs(np.random.default_rng(0).standard_normal(n)) \
            .astype(np.float32)
        for r in range(4):
            for w in ws:
                w.push(0, g)
            if r == 1:
                gs = sim.global_servers[0]
                node = gs.po.node
                gs.stop()
                gs.po.stop()
                po = Postoffice(node, cfg.topology, sim.fabric, cfg)
                restarted = GlobalServer(po, cfg)
                restarted.load_checkpoint(
                    f"{tmp}/global_server_{node.rank}.npz")
                po.start()
                sim.global_servers[0] = restarted
                sim.offices[str(node)] = po
            outs = [w.pull_sync(0) for w in ws]
            for w in ws:
                w.wait_all()
            for p in range(1, 4):
                assert outs[p].tobytes() == outs[0].tobytes(), (r, p)
        assert sim.global_servers[0].pull_comp.resyncs == 4
        assert outs[0].min() < 0
    finally:
        sim.shutdown()
