"""The port's MoE (``parallel/moe.py`` and the transformer's MoE layers)
against the JAX package's (CPU, f32).

Inputs come from numpy seeds; transformer weights cross through
``convert.flax_lm_to_torch``.  Tolerances:

- ``topk_dispatch_combine``: ``dispatch`` bitwise (expert choice, tie
  order and slot positions are discrete); ``combine`` bitwise where the
  router probabilities are exact (tied logits) and within rtol 1e-6
  elsewhere: XLA's CPU ``exp`` is not correctly rounded (about 1 in 10
  f32 results differ from the correctly rounded value) and torch's
  differs from it, so the softmax's last bit differs between the two
  libraries; the aux loss within 1e-6.
- ``moe_ffn_topk`` output and gradients: rtol 1e-5, atol 1e-6 × each
  tensor's largest entry (k = 2 and 3: at k = 1 the gate is p / p = 1,
  whose gradient is the rounding residue of each library's division
  backward).
- The transformer with MoE layers: logits, aux and loss rtol 1e-5;
  every gradient rtol 1e-5 / atol 2e-6 × the leaf's largest entry (the
  worst leaf measured 1.24e-6 × its largest entry with top-k layers,
  6.1e-7 with dense routing: the softmax's last bit, above, reaches the
  gates).
- The 2 × 2 FSA MoE geo-round (SGD lr 0.1, 2 steps): losses rtol 1e-5,
  weights atol 1e-6, as ``tests/test_torch_lm.py`` holds the dense LM.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.core.config import Config as JConfig, Topology as JTopology
from geomx_tpu.data import TokenIterator as JTokenIterator
from geomx_tpu.kvstore import Simulation as JSimulation
from geomx_tpu.models import transformer as JT
from geomx_tpu.parallel import moe as JM
from geomx_tpu.training import run_worker as j_run_worker
from geomx_tpu_torch.convert import flax_lm_to_torch
from geomx_tpu_torch.core.config import Config, Topology
from geomx_tpu_torch.data import TokenIterator, synthetic_lm
from geomx_tpu_torch.kvstore import Simulation
from geomx_tpu_torch.models import transformer as T
from geomx_tpu_torch.parallel import moe as M
from geomx_tpu_torch.training import (build_flagship_lm, flatten_params,
                                      run_worker)

WIDTHS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16, n_experts=4)


def _close(got, want, rtol=1e-5, atol_frac=1e-6, name=""):
    want = np.asarray(want)
    atol = atol_frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=name)


# ---- parallel/moe.py -------------------------------------------------------

@pytest.mark.parametrize("S,E,k,cf", [(128, 4, 2, 1.25), (16, 4, 1, 1.0),
                                      (3, 8, 2, 0.5), (1, 64, 1, 0.01),
                                      (100, 3, 3, 2.0)])
def test_expert_capacity(S, E, k, cf):
    assert M.expert_capacity(S, E, k, cf) == JM.expert_capacity(S, E, k, cf)


@pytest.mark.parametrize("case", ["drops", "one_slot", "tied", "ample"])
def test_topk_dispatch_combine_matches_jax(case):
    G, S, E = 3, 16, 4
    logits = np.random.default_rng(7).standard_normal(
        (G, S, E)).astype(np.float32) * 2.0
    k, capacity = {"drops": (2, 5), "one_slot": (1, 1), "tied": (2, 6),
                   "ample": (3, 48)}[case]
    if case == "tied":
        # a zero router: every probability 1/E, so the order is the ties'
        logits = np.zeros_like(logits)
        logits[1, :4] = [1.0, 1.0, 0.0, 1.0]    # ties among the top
    jd, jc, ja = JM.topk_dispatch_combine(jnp.asarray(logits), k, capacity)
    d, c, a = M.topk_dispatch_combine(torch.from_numpy(logits), k, capacity)
    assert d.shape == (G, S, E, capacity) and d.dtype == torch.float32
    assert d.numpy().tobytes() == np.asarray(jd).tobytes()
    if case == "tied":
        assert c.numpy().tobytes() == np.asarray(jc).tobytes()
    else:
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                                   atol=0)
    assert abs(float(a) - float(ja)) <= 1e-6
    # every case but "ample" drops tokens at capacity
    dropped = float(np.asarray(jd).sum()) < G * S * k
    assert dropped == (case != "ample")


def test_tied_router_picks_the_lower_expert_first():
    d, c, _ = M.topk_dispatch_combine(torch.zeros(1, 2, 4), k=2,
                                      capacity=2)
    # both tokens take experts 0 and 1, gates 1/2 each
    assert d[0, :, :2].sum().item() == 4.0 and d[0, :, 2:].sum().item() == 0
    assert torch.equal(c.sum(dim=(2, 3)), torch.ones(1, 2))


def _ffn_inputs(G=2, S=16, D=8, Fd=32, E=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, S, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    we1 = (rng.standard_normal((E, D, Fd)) / np.sqrt(D)).astype(np.float32)
    we2 = (rng.standard_normal((E, Fd, D)) / np.sqrt(Fd)).astype(np.float32)
    w = rng.standard_normal((G, S, D)).astype(np.float32)
    return x, router, we1, we2, w


@pytest.mark.parametrize("k,cf", [(2, 1.25), (2, 0.5), (3, 0.75)])
def test_moe_ffn_topk_forward_and_grads_match_jax(k, cf):
    x, router, we1, we2, w = _ffn_inputs()

    def jloss(*args):
        y, aux = JM.moe_ffn_topk(*args, k=k, capacity_factor=cf,
                                 compute_dtype=jnp.float32)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(x, router, we1, we2)
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (x, router, we1, we2)]
    y, aux = M.moe_ffn_topk(*ts, k=k, capacity_factor=cf,
                            compute_dtype=torch.float32)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    _close(y.detach(), jy, name="y")
    _close(aux.detach(), jaux, name="aux")
    for t, g, name in zip(ts, jg, ("x", "router", "we1", "we2")):
        _close(t.grad, g, name=f"d{name}")


def test_topk_at_k_e_and_full_capacity_is_dense_routing():
    """k = E with capacity = S is a total dispatch: the dense-routing
    math, in both packages (JAX ``tests/test_moe.py:44``)."""
    x, router, we1, we2, _ = _ffn_inputs(seed=3)
    G, S, _ = x.shape
    E = router.shape[1]
    y, _ = M.moe_ffn_topk(*(torch.from_numpy(a) for a in
                            (x, router, we1, we2)),
                          k=E, capacity=S, compute_dtype=torch.float32)
    gates = jax.nn.softmax(jnp.einsum("gsd,de->gse", x, router), axis=-1)
    up = jax.nn.gelu(jnp.einsum("gsd,edf->gsef", x, we1))
    ref = jnp.einsum("gsed,gse->gsd",
                     jnp.einsum("gsef,efd->gsed", up, we2), gates)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---- the transformer's MoE layers ------------------------------------------

def _cfgs(**over):
    w = {**WIDTHS, **over}
    return (JT.TransformerConfig(**w, compute_dtype=jnp.float32,
                                 attn_impl="dense"),
            T.TransformerConfig(**w, compute_dtype=torch.float32,
                                attn_impl="dense"))


def _jparams(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(seed)))


def _tokens(n=4, seed=0):
    return np.random.default_rng(seed).integers(
        0, WIDTHS["vocab"], (n, WIDTHS["max_seq"]), dtype=np.int32)


@pytest.mark.parametrize("top_k,moe_every", [(2, 2), (1, 1), (0, 2),
                                             (0, 1)])
def test_transformer_moe_matches_jax(top_k, moe_every):
    jcfg, cfg = _cfgs(moe_every=moe_every, moe_top_k=top_k)
    jparams = _jparams(jcfg)
    x = _tokens()
    j_apply = JT.make_apply(jcfg, return_aux=True)
    j_logits, j_aux = j_apply(jparams, jnp.asarray(x))
    j_loss, _, j_grads = JT.make_lm_grad_fn(jcfg)(jparams, x, x)

    params = flax_lm_to_torch(jparams)
    logits, aux = T.make_apply(cfg, return_aux=True)(
        params, torch.from_numpy(x).long())
    _close(logits, j_logits, name="logits")
    _close(aux, j_aux, name="aux")
    assert (float(aux) > 0) == (top_k > 0)
    loss, _, grads = T.make_lm_grad_fn(cfg)(params, x, x)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    # the loss folds the aux in exactly when the layers are top-k
    np.testing.assert_allclose(
        float(loss), float(T.lm_loss_with_aux(
            T.make_apply(cfg, return_aux=True), params,
            torch.from_numpy(x).long(),
            aux_coef=T.AUX_COEF if top_k else 0.0)), rtol=1e-6)
    back = flax_lm_to_torch(jax.tree_util.tree_map(np.asarray, j_grads))
    assert list(grads) == list(back)
    for name, g in grads.items():
        _close(g, back[name].numpy(), atol_frac=2e-6, name=name)


def test_transformer_topk_equals_dense_routing():
    """k = E and cf = 1 gives capacity S: the top-k forward is the
    dense-routing forward (JAX ``tests/test_moe.py:56``)."""
    _, dense = _cfgs(moe_every=1, max_seq=32)
    topk = dataclasses.replace(dense, moe_top_k=4, moe_capacity_factor=1.0)
    params = T.init_params(dense, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, WIDTHS["vocab"], (2, 32))).long()
    ref = T.make_apply(dense)(params, x)
    out, _ = T.make_apply(topk, return_aux=True)(params, x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_top_k_without_aux_warns_and_keys_follow_jax():
    _, cfg = _cfgs(moe_every=2, moe_top_k=2)
    with pytest.warns(UserWarning, match="aux"):
        T.make_apply(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    jnames = list(flax_lm_to_torch(_jparams(_cfgs(moe_every=2,
                                                  moe_top_k=2)[0])))
    assert list(params) == jnames
    assert [n for n in params if n.startswith("layers.1.")] == [
        f"layers.1.{k}" for k in ("ln1", "ln2", "router", "we1", "we2",
                                  "wk", "wo", "wq", "wv")]
    # the router's init scale, 0.02
    assert abs(float(params["layers.1.router"].std()) - 0.02) < 0.006


def test_flagship_moe_parameter_count_and_keys(monkeypatch):
    for var in ("VOCAB", "DMODEL", "HEADS", "LAYERS", "DFF", "SEQ",
                "MOE_TOP_K"):
        monkeypatch.delenv(f"GEOMX_LM_{var}", raising=False)
    monkeypatch.setenv("GEOMX_LM_MOE_EXPERTS", "4")
    cfg, params, n_params, grad_fn, data = build_flagship_lm(
        device="cpu", attn_impl="flash")
    assert n_params == 17_357_184
    assert len(params) == 37
    assert (cfg.moe_every, cfg.n_experts, cfg.moe_top_k) == (2, 4, 2)
    assert [i for i in range(cfg.n_layers) if cfg.is_moe(i)] == [1, 3]
    # JAX's flagship at the same widths, shapes only
    jtree = jax.eval_shape(lambda: JT.init_params(
        JT.TransformerConfig(vocab=8192, d_model=384, n_heads=6, n_layers=4,
                             d_ff=1536, max_seq=128, moe_every=2,
                             n_experts=4, moe_top_k=2),
        jax.random.PRNGKey(0)))
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert list(params) == names
    assert [tuple(t.shape) for t in params.values()] == [
        tuple(a.shape) for a in jax.tree_util.tree_leaves(jtree)]
    assert sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(jtree)) == n_params


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


def test_2x2_fsa_moe_lm_georound_close_to_jax():
    steps = 2
    jcfg, cfg = _cfgs(moe_every=2, moe_top_k=2)
    jparams = _jparams(jcfg)
    tokens = synthetic_lm(n=64, seq=WIDTHS["max_seq"],
                          vocab=WIDTHS["vocab"], seed=0)

    def topo(Tp):
        return Tp(num_parties=2, workers_per_party=2, num_global_servers=1)

    def configure(kv, p, r):
        if r == 0 and p == 0:
            kv.set_optimizer({"type": "sgd", "lr": 0.1})
        kv.barrier()

    jsim = JSimulation(JConfig(topology=topo(JTopology),
                               sync_global_mode=True,
                               merge_backend="numpy"))
    j_grad = JT.make_lm_grad_fn(jcfg)

    def jbody(kv, p, r, widx):
        configure(kv, p, r)
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
        configure(kv, p, r)
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
        moved = set()
        for name, a, b, a0 in zip(tp, flatten_params(tp)[0],
                                  jax.tree_util.tree_leaves(jp), init):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
            if not np.array_equal(a, a0):
                moved.add(name.rsplit(".", 1)[-1])
        # the experts and the router trained too
        assert {"router", "we1", "we2"} <= moved, moved
