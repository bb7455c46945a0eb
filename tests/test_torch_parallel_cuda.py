"""The multi-device paths on the card against the same on the CPU.

Every rank of these meshes lives on one card (``[card] * k``), the
reference on ``["cpu"] * k``.  The file imports nothing of the JAX
package, so it runs where the card is (``-m cuda``); on a host without
CUDA each test skips.

Tolerances: the dp × sp × tp step in f32 with TF32 off, loss rtol 1e-5
and every gradient atol 1e-5 (the card's and the CPU's matmuls sum in
other orders); the quantized all-reduce and the backend's mesh rung
bitwise (elementwise operations and rank-order sums only).
"""

import numpy as np
import pytest
import torch

from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.kvstore.torch_backend import TorchBackend
from geomx_tpu_torch.models import transformer as T
from geomx_tpu_torch.parallel import make_mesh, quantized_psum_mean
from geomx_tpu_torch.parallel.quantized_allreduce import (
    quantized_psum_mean_ef)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def test_tp_mesh_on_the_card_matches_the_cpu(card):
    cfg = T.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                              d_ff=64, max_seq=16, moe_every=2, n_experts=4,
                              compute_dtype=torch.float32, attn_impl="dense")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, 64, (4, 16), np.int32)
    out = {}
    for dev in ("cpu", card):
        mesh = make_mesh({"dp": 2, "sp": 2, "tp": 2}, devices=[dev] * 8)
        p = {n: t.to(dev) for n, t in params.items()}
        loss, _, grads = T.make_lm_grad_fn(cfg, mesh)(p, tokens)
        out[str(dev)] = (float(loss),
                         {n: g.cpu() for n, g in grads.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, g in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][n].numpy(), g.numpy(),
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("k", [2, 4])
def test_quantized_all_reduce_card_equals_cpu_bitwise(card, k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((k, 1000)).astype(np.float32)
    x[:, 3] *= 300.0
    r = (rng.standard_normal((k, 1000)) * 0.01).astype(np.float32)
    out = {}
    for dev in ("cpu", card):
        xs = [torch.from_numpy(a).to(dev) for a in x]
        rs = [torch.from_numpy(a).to(dev) for a in r]
        mean, res = quantized_psum_mean_ef(xs, rs)
        out[str(dev)] = [t.cpu() for t in
                         quantized_psum_mean(xs) + mean + res]
    assert all(torch.equal(a, b) for a, b in zip(out["cpu"], out["cuda"]))


@pytest.mark.parametrize("quantized", [False, True])
def test_merge_rung_card_equals_cpu_bitwise(card, quantized):
    rng = np.random.default_rng(5)
    pushes = [rng.standard_normal(1 << 16).astype(np.float32)
              for _ in range(6)]
    cfg = Config(topology=Topology(), merge_quantized=quantized)
    out = {}
    for dev in ("cpu", card):
        be = TorchBackend(cfg, dev, devices=[dev] * 4)
        sums = []
        for _ in range(3):
            acc = be.seed(pushes[0].copy(), donated=True, key=0)
            for p in pushes[1:]:
                acc = be.accumulate(acc, p.copy())
            sums.append(be.materialize(acc).copy())
        out[str(dev)] = sums
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(out["cpu"], out["cuda"]))


def test_merge_slots_start_on_the_backends_own_card(card):
    """Slot 0 holds the seed part and the reduced round: the default
    slots start on the backend's own card, whichever it is, and a list
    that starts elsewhere is refused."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    for dev in (card, last):
        be = TorchBackend(None, dev)
        assert be._devices[0] == dev
        assert len(be._devices) == torch.cuda.device_count()
    assert TorchBackend(None, card, devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="do not start"):
        TorchBackend(None, card, devices=["cpu"] * 2)
