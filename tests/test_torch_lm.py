"""The port's flagship transformer LM against the JAX package's (CPU).

Small widths (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64, seq
16), weights crossing through ``geomx_tpu_torch.convert``, tokens
seeded with numpy.  Both sides compute in float32
(``compute_dtype=float32``).  The port's ``flash`` runs its plain
version on the CPU; JAX's ``flash`` calls the bundled Pallas TPU
kernel, broken under interpret mode (``tests/test_flash.py``), so the
port's ``flash`` is held against JAX's ``dense`` — the same function.

Tolerances: logits atol 2e-5, loss rtol 1e-5, accuracy exact, grads
atol 2e-6 + rtol 1e-4 (the two libraries sum einsums, softmax and the
embedding scatter in different orders; every value is O(1) or below).
The 2×2 FSA geo-round (SGD, 2 steps) ends with weights within atol
1e-6 of the JAX run's: two SGD steps at lr 0.1 move them by
lr × grad, and the grads agree to ~1e-7.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.core.config import Config as JConfig, Topology as JTopology
from geomx_tpu.data import TokenIterator as JTokenIterator
from geomx_tpu.data import synthetic_lm as j_synthetic_lm
from geomx_tpu.kvstore import Simulation as JSimulation
from geomx_tpu.models import transformer as JT
from geomx_tpu.training import run_worker as j_run_worker
from geomx_tpu_torch.convert import flax_lm_to_torch, torch_lm_to_flax
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.data import TokenIterator, synthetic_lm
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.models import transformer as T
from geomx_tpu_torch.training import (build_flagship_lm, flatten_params,
                                      run_worker)

WIDTHS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16)
# the JAX side's attention for each port attn_impl (JAX's flash has no
# CPU path; its reference function is dense)
J_IMPL = {"dense": "dense", "fast": "fast", "flash": "dense"}


def _cfgs(impl, **over):
    w = {**WIDTHS, **over}
    return (JT.TransformerConfig(**w, compute_dtype=jnp.float32,
                                 attn_impl=J_IMPL[impl]),
            T.TransformerConfig(**w, compute_dtype=torch.float32,
                                attn_impl=impl))


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs("dense")
    p = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def _tokens(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, WIDTHS["vocab"], (n, WIDTHS["max_seq"]),
                        dtype=np.int32)


def _jax_names(tree):
    """Port-style names of JAX's tree_flatten leaves, in its order."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for k in path:
            parts.append(str(k.key if hasattr(k, "key") else k.idx))
        out.append(".".join(parts))
    return out


@pytest.mark.parametrize("n_layers", [2, 12])
def test_leaf_order_equals_jax_tree_flatten(n_layers):
    jcfg, cfg = _cfgs("dense", n_layers=n_layers)
    jtree = JT.init_params(jcfg, jax.random.PRNGKey(1))
    names = _jax_names(jtree)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert list(params) == names            # layers.10 after layers.9
    assert list(flax_lm_to_torch(jax.tree_util.tree_map(np.asarray,
                                                        jtree))) == names
    j_leaves = jax.tree_util.tree_leaves(jtree)
    assert [tuple(t.shape) for t in params.values()] == \
        [tuple(a.shape) for a in j_leaves]
    # init scales: the embeddings 0.02, norms ones
    assert abs(float(params["embed"].std()) - 0.02) < 0.004
    assert torch.equal(params["ln_f"], torch.ones(WIDTHS["d_model"]))


def test_flagship_parameter_count_and_keys(monkeypatch):
    for var in ("VOCAB", "DMODEL", "HEADS", "LAYERS", "DFF", "SEQ",
                "MOE_EXPERTS", "MOE_TOP_K"):
        monkeypatch.delenv(f"GEOMX_LM_{var}", raising=False)
    cfg, params, n_params, grad_fn, data = build_flagship_lm(
        device="cpu", attn_impl="flash")
    assert n_params == 10_276_224
    assert len(params) == 35
    assert max(params.values(), key=lambda t: t.numel()).shape == (8192, 384)
    assert cfg.attn_impl == "flash" and cfg.compute_dtype == torch.bfloat16
    assert data.shape == (512, 128) and data.dtype == np.int32
    assert all(t.dtype == torch.float32 for t in params.values())
    # MoE layers on every 2nd layer, top-k clamped to the expert count
    monkeypatch.setenv("GEOMX_LM_MOE_EXPERTS", "4")
    monkeypatch.setenv("GEOMX_LM_MOE_TOP_K", "8")
    cfg, params, n_params, _, _ = build_flagship_lm(device="cpu")
    assert (n_params, len(params)) == (17_357_184, 37)
    assert (cfg.moe_every, cfg.moe_top_k) == (2, 4) and cfg.uses_aux


def test_convert_round_trip_is_exact(jparams):
    back = torch_lm_to_flax(flax_lm_to_torch(jparams))
    flat_a = jax.tree_util.tree_leaves(jparams)
    flat_b = jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jparams)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(flat_a, flat_b))


@pytest.mark.parametrize("impl", ["dense", "fast", "flash"])
def test_logits_loss_acc_and_grads_match_jax_f32(jparams, impl):
    jcfg, cfg = _cfgs(impl)
    x = _tokens()
    j_logits = np.asarray(JT.make_apply(jcfg)(jparams, jnp.asarray(x)))
    j_loss, j_acc, j_grads = JT.make_lm_grad_fn(jcfg)(jparams, x, x)

    params = flax_lm_to_torch(jparams)
    logits = T.make_apply(cfg)(params, torch.from_numpy(x).long())
    np.testing.assert_allclose(logits.numpy(), j_logits, atol=2e-5)
    loss, acc, grads = T.make_lm_grad_fn(cfg)(params, x, x)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert float(acc) == float(j_acc)
    back = flax_lm_to_torch(jax.tree_util.tree_map(np.asarray, j_grads))
    assert list(grads) == list(back)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), back[name].numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=name)


def test_bf16_compute_runs_flash_and_keeps_f32_params():
    cfg = T.TransformerConfig(**WIDTHS, attn_impl="flash")
    assert cfg.compute_dtype == torch.bfloat16
    params, grad_fn = T.create_lm_state(cfg, seed=0, device="cpu")
    loss, acc, grads = grad_fn(params, _tokens(), None)
    assert torch.isfinite(loss) and 0.0 <= float(acc) <= 1.0
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())
    # random init: the loss sits near log(vocab)
    assert abs(float(loss) - np.log(WIDTHS["vocab"])) < 0.5


def test_unported_paths_raise():
    from geomx_tpu_torch.parallel import make_mesh

    _, cfg = _cfgs("fast")
    # the mesh's sp axis is ported (tests/test_torch_sp.py); dp and tp
    # are not
    for axes in ({"dp": 2, "sp": 2, "tp": 1}, {"dp": 1, "sp": 1, "tp": 2}):
        with pytest.raises(NotImplementedError, match="A11"):
            T.make_apply(cfg, mesh=make_mesh(axes, devices=["cpu"] * 4))
    # MoE is ported (tests/test_torch_moe.py): top-k built without the
    # aux warns, as JAX's does
    with pytest.warns(UserWarning, match="aux"):
        T.make_apply(T.TransformerConfig(**WIDTHS, moe_every=2, moe_top_k=2))
    with pytest.raises(ValueError, match="attn_impl"):
        T._single_device_attention(
            T.TransformerConfig(attn_impl="nope"),
            *(torch.zeros(1, 2, 1, 8) for _ in range(3)))


def _drive(sim, body):
    out, errors = {}, []

    def main(p, r):
        try:
            out[2 * p + r] = body(sim.worker(p, r), p, r, 2 * p + r)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=main, args=(p, r), daemon=True)
          for p in range(2) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts), "a worker hung"
    if errors:
        raise errors[0]
    return out


def _configure(kv, p, r):
    if r == 0 and p == 0:
        kv.set_optimizer({"type": "sgd", "lr": 0.1})
    kv.barrier()


def test_2x2_fsa_lm_georound_close_to_jax(jparams):
    steps = 2
    jcfg, cfg = _cfgs("flash")
    tokens = j_synthetic_lm(n=64, seq=WIDTHS["max_seq"],
                            vocab=WIDTHS["vocab"], seed=0)
    assert np.array_equal(tokens, synthetic_lm(
        n=64, seq=WIDTHS["max_seq"], vocab=WIDTHS["vocab"], seed=0))

    def topo(Tp):
        return Tp(num_parties=2, workers_per_party=2, num_global_servers=1)

    jsim = JSimulation(JConfig(topology=topo(JTopology),
                               sync_global_mode=True,
                               merge_backend="numpy"))
    j_grad = JT.make_lm_grad_fn(jcfg)

    def jbody(kv, p, r, widx):
        _configure(kv, p, r)
        res: dict = {}
        hist = j_run_worker(kv, jparams, j_grad,
                            JTokenIterator(tokens, 4, widx, 4, seed=0),
                            steps, params_out=res)
        return hist, jax.tree_util.tree_map(np.asarray, res["params"])

    try:
        ref = _drive(jsim, jbody)
    finally:
        jsim.shutdown()

    params0 = flax_lm_to_torch(jparams)
    grad_fn = T.make_lm_grad_fn(cfg)
    sim = Simulation(Config(topology=topo(Topology), sync_global_mode=True,
                            merge_backend="torch:cpu"))

    def tbody(kv, p, r, widx):
        _configure(kv, p, r)
        res: dict = {}
        hist = run_worker(kv, params0, grad_fn,
                          TokenIterator(tokens, 4, widx, 4, seed=0),
                          steps, params_out=res)
        return hist, res["params"]

    try:
        got = _drive(sim, tbody)
    finally:
        sim.shutdown()

    init = [a.copy() for a in flatten_params(params0)[0]]
    for w in range(4):
        (jh, jp), (th, tp) = ref[w], got[w]
        np.testing.assert_allclose([l for l, _ in th], [l for l, _ in jh],
                                   rtol=1e-5)
        j_leaves = jax.tree_util.tree_leaves(jp)
        t_leaves = flatten_params(tp)[0]
        moved = False
        for name, a, b, a0 in zip(tp, t_leaves, j_leaves, init):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
            moved |= not np.array_equal(a, a0)
        assert moved, "training did not move the weights"
