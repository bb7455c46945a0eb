#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. device report — the ``nvidia-smi`` name and power limit;
2. kernels — each Triton codec kernel against its plain PyTorch version
   on the card: 2-bit quantize and dequantize in both layouts compared
   bitwise (inputs hold signed zeros and values exactly at ±t), the DGC
   update bitwise too (tolerance: none), at 1, 4097, 401,408 (the CNN's
   largest leaf) and 50,000,000 elements; then CUDA-event times;
3. flash attention — the CUDA forward and backward kernels (built with
   ``nvcc`` for sm_90a from ``geomx_tpu_torch/csrc/``) against their
   plain versions in bf16 and f32 at (B,T,H,Dh) = (8,128,6,64) (the
   flagship LM), (4,2048,16,128) (the MFU config), (2,1000,3,64) (a
   ragged tail) and (1,1,1,64); tolerance f32 1e-4, bf16 2e-2, each
   times max(1, largest reference entry); CUDA-event times of kernel,
   plain version and ``scaled_dot_product_attention`` (a yardstick
   only, never on the port's path), each beside its bound;
4. full-width reference step — one forward and backward of the port's
   transformer at the MFU config's widths (d 2048, 16 heads, 8 layers,
   d_ff 8192, seq 2048, batch 4, bf16, ~424M parameters) with
   ``attn_impl="flash"`` and again with ``"dense"`` (and ``"fast"``,
   which rounds the probabilities as flash does): losses within 1e-3
   relative, every leaf's gradient within 5e-2 relative L2;
5. reference check — a 2×2 geo-round of the port's Simulation with a
   shared dyadic gradient function, on the card (torch backend, kernels)
   and on the host (numpy backend, host codecs): weights bitwise equal
   under 2bit and bsc;
6. geo-rounds — the port's main paths through their user entry points:
   ``geomx_tpu_torch.examples.cnn`` (2 parties × 2 workers + 1 global
   server, full-width CNN, FSA, Adam, a few steps under 2bit and again
   under bsc) and ``geomx_tpu_torch.examples.lm`` (the flagship LM at
   full width, 10,276,224 parameters, flash attention, bf16, FSA, Adam,
   8 steps under 2bit); the launch counts are set to 0 just before each
   run and read just after it, and each path must launch its own
   kernels (2bit: quantize and dequantize; bsc: DGC; LM: flash forward
   and backward, quantize and dequantize).

Prints, before the last line, the kernel table as one JSON object, and
as the last line ``{"ok": true, "device": {...}}``.  Writes the kernel
table and the per-size times to ``chiprun_out/chip_smoke.json`` too.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
SIZES = (1, 4097, 401_408, 50_000_000)
MAIN_N = 401_408              # largest leaf of the CNN: the main path's size
THRESHOLD = 0.5
MOMENTUM = 0.9
STEPS = 12
# flash attention: (B, T, H, Dh) of the flagship LM (the main path),
# the MFU config, a ragged tail and one token
FLASH_SHAPES = ((8, 128, 6, 64), (4, 2048, 16, 128), (2, 1000, 3, 64),
                (1, 1, 1, 64))
FLASH_MAIN = ((8, 128, 6, 64), "bfloat16")
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MFU_WIDTHS = dict(vocab=8192, d_model=2048, n_heads=16, n_layers=8,
                  d_ff=8192, max_seq=2048)     # bench.py MFU_CFG
MFU_BATCH = 4
LM_STEPS = 8
LM_ARGS = ["--parties", "2", "--workers", "2", "--global-servers", "1",
           "--steps", str(LM_STEPS), "--batch", "8", "--seq", "128",
           "--vocab", "8192", "--d-model", "384", "--layers", "4",
           "--heads", "6", "--d-ff", "1536", "--optimizer", "adam",
           "--lr", "3e-3", "--compression", "2bit", "--attn-impl", "flash",
           "--compute-dtype", "bfloat16", "--seed", "0"]
LM_PARAMS = 10_276_224


def log(msg: str) -> None:
    print(msg, flush=True)


def device_report() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"nvidia-smi: {line}")
    return line


# ---- phase 2: kernels against their plain versions ---------------------

def _inputs(n: int, dev, seed: int):
    """Gradient and residual with signed zeros and exact ±t sums."""
    import torch

    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 0.4).astype(np.float32)
    r = (rng.standard_normal(n) * 0.2).astype(np.float32)
    g[0::13] = -0.0
    r[0::13] = -0.0            # r + g = -0.0: the residual's sign matters
    g[1::17] = THRESHOLD
    r[1::17] = 0.0             # r + g = +t exactly: not > t, code 0
    g[2::19] = -THRESHOLD
    r[2::19] = 0.0             # r + g = -t exactly: not < -t, code 0
    g[3::23] = 0.25
    r[3::23] = 0.5             # above t
    return (torch.from_numpy(g).to(dev), torch.from_numpy(r).to(dev))


def _bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return a.shape == b.shape and bool(
            torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return a.shape == b.shape and bool(torch.equal(a, b))


def _max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def check_kernels(dev) -> dict:
    """Every kernel against its plain version at every size; returns the
    largest absolute error of each kernel (0 where bitwise)."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_triton as K

    err = {"quantize_2bit": 0.0, "dequantize_2bit": 0.0, "dgc_update": 0.0}
    for n in SIZES:
        g, r = _inputs(n, dev, seed=n)
        for layout in Q.LAYOUTS:
            p_k, r_k = K.quantize_2bit(g, r, THRESHOLD, layout)
            p_p, r_p = Q.quantize_2bit_ref(g, r, THRESHOLD, layout)
            torch.cuda.synchronize()
            assert _bits_equal(p_k, p_p), f"quantize {layout} n={n}: codes"
            assert _bits_equal(r_k, r_p), f"quantize {layout} n={n}: residual"
            err["quantize_2bit"] = max(err["quantize_2bit"],
                                       _max_abs(r_k, r_p))
            d_k = K.dequantize_2bit(p_k, n, THRESHOLD, layout)
            d_p = Q.dequantize_2bit_ref(p_k, n, THRESHOLD, layout)
            torch.cuda.synchronize()
            assert _bits_equal(d_k, d_p), f"dequantize {layout} n={n}"
            err["dequantize_2bit"] = max(err["dequantize_2bit"],
                                         _max_abs(d_k, d_p))
        if n > 1:
            # consecutive layout: the -0.0 residual survives
            z = r_k[0::13]
            z = z[z == 0]
            assert z.numel() > 0 and bool(torch.signbit(z).all()), \
                "consecutive residual lost -0.0"
        v = r * 3.0
        v_k, u_k = K.dgc_update(v, r, g, MOMENTUM)
        v_p, u_p = Q.dgc_update_ref(v, r, g, MOMENTUM)
        torch.cuda.synchronize()
        # tolerance: none — the kernel rounds m·v and + g apart
        # (enable_fp_fusion=False), as the plain version does
        for a, b, what in ((v_k, v_p, "v"), (u_k, u_p, "u")):
            err["dgc_update"] = max(err["dgc_update"], _max_abs(a, b))
            assert _bits_equal(a, b), f"dgc n={n} {what}: not bitwise"
        log(f"kernels n={n}: quantize/dequantize bitwise in both layouts, "
            f"dgc max abs err {err['dgc_update']:g}")
        del g, r, v
        torch.cuda.empty_cache()
    return err


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_costs(n: int) -> dict:
    """Bytes each function must move (inputs read once, outputs written
    once) and its f32 operations, for n elements (consecutive layout)."""
    nb = (n + 3) // 4
    return {
        # read g, r; write r, packed codes.  ops: add, 2 compares, the
        # residual select-add, shift-or of the code
        "quantize_2bit": (12 * n + nb, 6 * n),
        # read packed codes; write f32.  ops: shift, mask, 2 selects
        "dequantize_2bit": (nb + 4 * n, 4 * n),
        # read v, u, g; write v, u.  ops: mul, add, add
        "dgc_update": (20 * n, 3 * n),
    }


def time_kernels(dev, sizes, iters_for) -> dict:
    """CUDA-event times of each kernel and its plain version (and, for
    DGC, the in-place two-op torch form) at each size, warm in L2 where
    the tensor fits (the codec reads the accumulator the merge just
    wrote)."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_triton as K

    out = {}
    for n in sizes:
        g, r = _inputs(n, dev, seed=7)
        v = r * 3.0
        packed, _ = K.quantize_2bit(g, r, THRESHOLD, "consecutive")
        it = iters_for(n)
        row = {
            "quantize_2bit": (
                _time_ms(lambda: K.quantize_2bit(g, r, THRESHOLD,
                                                 "consecutive"), it),
                _time_ms(lambda: Q.quantize_2bit_ref(g, r, THRESHOLD,
                                                     "consecutive"), it)),
            "dequantize_2bit": (
                _time_ms(lambda: K.dequantize_2bit(packed, n, THRESHOLD,
                                                   "consecutive"), it),
                _time_ms(lambda: Q.dequantize_2bit_ref(
                    packed, n, THRESHOLD, "consecutive"), it)),
            "dgc_update": (
                _time_ms(lambda: K.dgc_update(v, r, g, MOMENTUM), it),
                _time_ms(lambda: Q.dgc_update_ref(v, r, g, MOMENTUM), it)),
        }
        vv, uu = v.clone(), r.clone()

        def inplace():
            vv.mul_(MOMENTUM).add_(g)
            uu.add_(vv)

        dgc_inplace = _time_ms(inplace, it)
        costs = kernel_costs(n)
        out[n] = {}
        for name, (ms, plain_ms) in row.items():
            nbytes, ops = costs[name]
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = ops / F32_OPS_PER_S * 1e3
            rec = {"ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(b_bytes, b_ops),
                   "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                   "gb_per_s": nbytes / (ms * 1e-3) / 1e9}
            if name == "dgc_update":
                rec["torch_inplace_ms"] = dgc_inplace
            out[n][name] = rec
            log(f"time n={n} {name}: kernel {ms:.4f} ms "
                f"({rec['gb_per_s']:.1f} GB/s), plain {plain_ms:.4f} ms, "
                f"bound {rec['bound_ms']:.4f} ms"
                + (f", in-place torch {dgc_inplace:.4f} ms"
                   if name == "dgc_update" else ""))
        del g, r, v, vv, uu, packed
        torch.cuda.empty_cache()
    return out


# ---- phase 3: flash attention against its plain versions ----------------

def flash_costs(shape, dtype: str) -> dict:
    """Causal attention's work at ``shape``: flops (forward 2 matmuls,
    backward 5, over the T(T+1)/2 visible pairs of each (b, h)) and
    bytes (each input read once, each output written once)."""
    B, T, H, D = shape
    es = 4 if dtype == "float32" else 2
    n = B * T * H * D
    pairs = B * H * T * (T + 1) // 2
    rows = B * H * T * 4                        # lse (and delta) f32
    return {"flash_fwd": (2 * 2 * D * pairs, 4 * n * es + rows),
            "flash_bwd": (5 * 2 * D * pairs, 8 * n * es + rows)}


def _bound(flops: float, nbytes: float, dtype: str):
    peak = F32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
    b_ops = flops / peak * 1e3
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(b_ops, b_bytes), ("operations" if b_ops >= b_bytes
                                 else "bytes")


def check_flash(dev) -> dict:
    """Each flash kernel against its plain version at every shape and
    dtype, then CUDA-event times of kernel, plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    from geomx_tpu_torch.ops import flash_attention as FA
    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    t0 = time.perf_counter()
    FK.library()
    ptx = [ln.strip() for ln in FK.BUILD_LOG.splitlines()
           if "registers" in ln or "spill" in ln]
    log(f"flash kernels built with nvcc in {time.perf_counter() - t0:.1f} s;"
        f" ptxas: {'; '.join(ptx)}")
    out = {"build_s": time.perf_counter() - t0, "ptxas": ptx, "by_shape": {}}
    for shape in FLASH_SHAPES:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            rng = np.random.default_rng(sum(shape))
            q, k, v, do = (torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))
                .to(dev, dtype) for _ in range(4))
            scale = 1.0 / math.sqrt(shape[-1])
            o, lse = FK.flash_fwd(q, k, v, scale)
            ro, rlse = FA.flash_attention_ref(q, k, v, scale)
            grads = FK.flash_bwd(q, k, v, o, lse, do, scale)
            refs = FA.flash_attention_bwd_ref(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            err = {"flash_fwd": max(_max_abs(o, ro), _max_abs(lse, rlse)),
                   "flash_bwd": max(_max_abs(g, r)
                                    for g, r in zip(grads, refs))}
            tol = {"flash_fwd": FLASH_TOL[dt] * max(
                       1.0, float(ro.float().abs().max())),
                   "flash_bwd": FLASH_TOL[dt] * max(
                       1.0, max(float(r.float().abs().max())
                                for r in refs))}
            for name in err:
                assert err[name] <= tol[name], (
                    f"{name} {shape} {dt}: max abs err {err[name]} > "
                    f"{tol[name]}")
            # SDPA, the library yardstick: [B, H, T, Dh]
            sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
            sdo = do.transpose(1, 2).contiguous()
            it = 5 if shape[1] >= 2048 else 50
            times = {
                "flash_fwd": (
                    _time_ms(lambda: FK.flash_fwd(q, k, v, scale), it),
                    _time_ms(lambda: FA.flash_attention_ref(q, k, v, scale),
                             it),
                    _time_ms(lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, is_causal=True), it)),
                "flash_bwd": (
                    _time_ms(lambda: FK.flash_bwd(q, k, v, o, lse, do,
                                                  scale), it),
                    _time_ms(lambda: FA.flash_attention_bwd_ref(
                        q, k, v, o, lse, do, scale), it),
                    _time_ms(lambda: torch.autograd.grad(
                        so, (sq, sk, sv), sdo, retain_graph=True), it)),
            }
            costs = flash_costs(shape, dt)
            rec = {}
            for name, (ms, plain_ms, lib_ms) in times.items():
                flops, nbytes = costs[name]
                bound_ms, bound_by = _bound(flops, nbytes, dt)
                rec[name] = {"max_abs_err": err[name], "tol": tol[name],
                             "ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by,
                             "tflop_per_s": flops / (ms * 1e-3) / 1e12}
                log(f"flash {name} {shape} {dt}: max abs err "
                    f"{err[name]:.3g} (tol {tol[name]:.3g}); kernel "
                    f"{ms:.4f} ms ({rec[name]['tflop_per_s']:.2f} TFLOP/s), "
                    f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by})")
            out["by_shape"][f"{shape} {dt}"] = rec
            del q, k, v, do, o, lse, ro, rlse, grads, refs, sq, sk, sv, so
            torch.cuda.empty_cache()
    return out


# ---- phase 4: full-width reference step, flash against dense ------------

def check_full_width_step(dev) -> dict:
    """One forward + backward at the MFU config's widths, flash against
    dense (and fast) attention on the same weights and tokens."""
    import dataclasses

    import torch

    from geomx_tpu_torch.data import synthetic_lm
    from geomx_tpu_torch.models.transformer import (
        TransformerConfig, init_params, make_lm_grad_fn)

    cfg = TransformerConfig(**MFU_WIDTHS, attn_impl="flash")
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = sum(t.numel() for t in params.values())
    tokens = synthetic_lm(n=MFU_BATCH, seq=cfg.max_seq, vocab=cfg.vocab,
                          seed=0)

    def step(impl):
        fn = make_lm_grad_fn(dataclasses.replace(cfg, attn_impl=impl))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = fn(params, tokens, None)
        torch.cuda.synchronize()
        return float(loss), grads, time.perf_counter() - t0

    lf, gf, tf = step("flash")
    out = {"n_params": n_params, "loss_flash": lf, "wall_s_flash": tf}
    # dense is the reference the tolerance holds; fast rounds p to bf16
    # before the PV product as flash does, so it shows how much of the
    # difference that rounding makes
    for impl in ("dense", "fast"):
        lo, go, to = step(impl)
        rel_loss = abs(lf - lo) / abs(lo)
        rel = {n: float((gf[n] - go[n]).norm() / go[n].norm()) for n in go}
        worst = max(rel, key=rel.get)
        log(f"full-width step ({n_params} params): loss flash {lf:.6f} "
            f"{impl} {lo:.6f} (rel {rel_loss:.2e}, tol 1e-3); worst leaf "
            f"grad rel L2 {rel[worst]:.2e} ({worst}, tol 5e-2); wall flash "
            f"{tf:.3f} s, {impl} {to:.3f} s (first call)")
        assert math.isfinite(lf) and rel_loss <= 1e-3, \
            f"flash loss differs from {impl}"
        assert rel[worst] <= 5e-2, f"flash grad of {worst} differs ({impl})"
        out[impl] = {"loss": lo, "rel_loss": rel_loss, "grad_rel_l2": rel,
                     "wall_s": to}
        del go
    del params, gf
    torch.cuda.empty_cache()
    return out


# ---- phase 5: the geo-round against the host reference -----------------

def _dyadic_georound(backend: str, compression: str) -> list:
    """2 parties × 2 workers, FSA, SGD lr 1/4, 3 steps, with one dyadic
    numpy gradient function: every sum and product is exact, so any two
    correct engines agree to the bit.  BSC uses momentum 1/2 and a ratio
    that sends one coordinate per key (tie-free gradients), where exact
    top-k and the host codec's sampled threshold pick the same one."""
    import threading

    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.training import run_worker

    shapes = {"a.bias": (8,), "a.weight": (6, 5)}
    init = {n: torch.from_numpy(
        np.random.default_rng(i).integers(-8, 9, s).astype(np.float32) / 8)
        for i, (n, s) in enumerate(sorted(shapes.items()))}

    def grad_fn(params, x, y):
        step, widx = x
        rng = np.random.default_rng(1000 * step + widx)
        grads = {}
        for n, p in params.items():
            q = rng.permutation(p.numel()).reshape(p.shape) + 1
            sign = np.where(rng.random(p.shape) < 0.5, -1.0, 1.0)
            g = (q * sign / 64.0 + p.cpu().numpy() / 4).astype(np.float32)
            grads[n] = torch.from_numpy(g)
        zero = torch.zeros(())
        return zero, zero, grads

    cfg = Config(topology=Topology(num_parties=2, workers_per_party=2,
                                   num_global_servers=1),
                 sync_global_mode=True, merge_backend=backend)
    sim = Simulation(cfg)
    out = {}
    errors = []

    def worker(p, r):
        try:
            kv = sim.worker(p, r)
            if r == 0:
                if p == 0:
                    kv.set_optimizer({"type": "sgd", "lr": 0.25})
                kv.set_gradient_compression(
                    {"type": compression, "ratio": 0.01, "momentum": 0.5,
                     "threshold": 0.5})
            kv.barrier()
            widx = 2 * p + r
            data = [((s, widx), None) for s in range(3)]
            res: dict = {}
            run_worker(kv, init, grad_fn, data, 3, params_out=res)
            out[(p, r)] = [t.cpu().numpy().tobytes()
                           for t in res["params"].values()]
        except BaseException as e:
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(p, r), daemon=True)
          for p in range(2) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    sim.shutdown()
    if errors:
        raise errors[0]
    first = out[(0, 0)]
    assert all(v == first for v in out.values()), "FSA replicas differ"
    return first


def check_reference() -> None:
    for comp in ("2bit", "bsc"):
        dev_w = _dyadic_georound("torch", comp)
        host_w = _dyadic_georound("numpy", comp)
        assert dev_w == host_w, f"{comp}: card weights differ from host"
        log(f"reference {comp}: card geo-round weights bitwise equal to "
            "the host numpy reference")


# ---- phase 6: the main paths ---------------------------------------------

def run_georound(compression: str) -> dict:
    import torch

    from geomx_tpu_torch.examples.cnn import build_parser, train

    args = build_parser().parse_args(
        ["--parties", "2", "--workers", "2", "--global-servers", "1",
         "--steps", str(STEPS), "--batch", "32", "--optimizer", "adam",
         "--lr", "0.001", "--compression", compression,
         "--bsc-ratio", "0.01", "--seed", "0"])
    stamps = []
    out = train(args, log=lambda msg: stamps.append(time.perf_counter()))
    losses = [l for h in out["histories"].values() for l, _ in h]
    assert len(losses) == 4 * STEPS, "a worker did not finish its steps"
    assert all(math.isfinite(x) for x in losses), "non-finite loss"
    params = out["params"]
    assert params is not None and all(t.is_cuda for t in params.values()), \
        "final weights are not on the card"
    assert sum(t.numel() for t in params.values()) == 429_258
    assert all(bool(torch.isfinite(t).all()) for t in params.values())
    servers = out["sim_stats"]["local"] + out["sim_stats"]["global"]
    for s in servers:
        assert s["merge_backend"] == "torch" and s["merge_device"] == "cuda"
        assert s["codec_host_bytes"] == 0, f"codec host copies: {s}"
    # steady state: from the third step on (the first ones compile)
    steady = (len(stamps) - 3) / (stamps[-1] - stamps[2])
    wan = out["wan"]["wan_send_bytes"] / STEPS
    first = [h[0][0] for h in out["histories"].values()]
    last = [h[-1][0] for h in out["histories"].values()]
    log(f"geo-round {compression}: {STEPS} steps, loss "
        f"{np.mean(first):.4f} -> {np.mean(last):.4f}, "
        f"{steady:.2f} steps/s steady, {out['seconds']:.2f} s total, "
        f"WAN bytes/step {wan:.0f}")
    return {"steps_per_s": steady, "wan_bytes_per_step": wan,
            "loss_first": float(np.mean(first)),
            "loss_last": float(np.mean(last)), "seconds": out["seconds"]}


def run_lm_georound() -> dict:
    """The flagship LM through ``geomx_tpu_torch.examples.lm``."""
    import torch

    from geomx_tpu_torch.examples.lm import build_parser, train

    args = build_parser().parse_args(LM_ARGS)
    stamps = []
    out = train(args, log=lambda msg: stamps.append(time.perf_counter()))
    losses = [l for h in out["histories"].values() for l, _ in h]
    assert len(losses) == 4 * LM_STEPS, "a worker did not finish its steps"
    assert all(math.isfinite(x) for x in losses), "non-finite loss"
    assert out["n_params"] == LM_PARAMS, out["n_params"]
    params = out["params"]
    assert params is not None and all(t.is_cuda for t in params.values()), \
        "final weights are not on the card"
    assert sum(t.numel() for t in params.values()) == LM_PARAMS
    assert all(bool(torch.isfinite(t).all()) for t in params.values())
    for s in out["sim_stats"]["local"] + out["sim_stats"]["global"]:
        assert s["merge_backend"] == "torch" and s["merge_device"] == "cuda"
        assert s["codec_host_bytes"] == 0, f"codec host copies: {s}"
    steady = (len(stamps) - 3) / (stamps[-1] - stamps[2])
    tokens_per_step = 4 * args.batch * args.seq
    wan = out["wan"]["wan_send_bytes"] / LM_STEPS
    first = [h[0][0] for h in out["histories"].values()]
    last = [h[-1][0] for h in out["histories"].values()]
    log(f"geo-round lm 2bit: {LM_STEPS} steps, {out['n_params']} params, "
        f"loss {np.mean(first):.4f} -> {np.mean(last):.4f}, "
        f"{steady:.3f} steps/s steady ({steady * tokens_per_step:.0f} "
        f"tokens/s), {out['seconds']:.2f} s total, WAN bytes/step {wan:.0f}")
    return {"steps_per_s": steady,
            "tokens_per_s": steady * tokens_per_step,
            "wan_bytes_per_step": wan, "n_params": out["n_params"],
            "loss_first": float(np.mean(first)),
            "loss_last": float(np.mean(last)), "seconds": out["seconds"]}


# the kernels each main path must launch; a kernel's ``launches`` in the
# kernel table is the count from the first path that lists it
PATH_KERNELS = {"2bit": ("quantize_2bit", "dequantize_2bit"),
                "bsc": ("dgc_update",),
                "lm": ("flash_fwd", "flash_bwd", "quantize_2bit",
                       "dequantize_2bit")}

KERNEL_ROWS = {
    "quantize_2bit": ("geomx_tpu/ops/quantize.py:39 _quant_kernel "
                      "(quantize_2bit_tpu :87)"),
    "dequantize_2bit": ("geomx_tpu/ops/quantize.py:105 _dequant_kernel "
                        "(dequantize_2bit_tpu :138)"),
    "dgc_update": ("geomx_tpu/ops/quantize.py:147 _dgc_kernel "
                   "(dgc_update_tpu :174)"),
    "flash_fwd": ("geomx_tpu/models/transformer.py:245 JAX's bundled "
                  "pallas.ops.tpu.flash_attention (forward kernel)"),
    "flash_bwd": ("geomx_tpu/models/transformer.py:245 JAX's bundled "
                  "pallas.ops.tpu.flash_attention (dK/dV and dQ backward "
                  "kernels)"),
}
ROUTES = {"quantize_2bit": "triton", "dequantize_2bit": "triton",
          "dgc_update": "triton", "flash_fwd": "cuda", "flash_bwd": "cuda"}
SOURCES = {"triton": "geomx_tpu_torch/ops/kernels/quantize_triton.py",
           "cuda": "geomx_tpu_torch/csrc/flash_attention.cu"}


def reset_all_launches() -> None:
    from geomx_tpu_torch.ops.kernels import flash_attention as FK
    from geomx_tpu_torch.ops.kernels import quantize_triton as K

    K.reset_launches()
    FK.reset_launches()


def all_launches() -> dict:
    from geomx_tpu_torch.ops.kernels import flash_attention as FK
    from geomx_tpu_torch.ops.kernels import quantize_triton as K

    return {**K.launches(), **FK.launches()}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    # the kernels build from this checkout's sources into its own cache
    os.environ.setdefault(
        "TRITON_CACHE_DIR", os.path.join(root, "geomx_tpu_torch",
                                         ".kernel_cache"))
    from geomx_tpu_torch.core.platform import resolve_device

    # a float32 reference states its matmul and convolution precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    smi = device_report()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    err = check_kernels(dev)
    times = time_kernels(dev, SIZES,
                         lambda n: 20 if n >= 10_000_000 else 200)
    log(f"phases 1-2 done in {time.perf_counter() - t0:.1f} s")

    flash = check_flash(dev)
    log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")
    full = check_full_width_step(dev)
    log(f"phase 4 done in {time.perf_counter() - t0:.1f} s")

    check_reference()

    geo, launches = {}, {}
    for path, names in PATH_KERNELS.items():
        reset_all_launches()
        geo[path] = (run_lm_georound() if path == "lm"
                     else run_georound(path))
        counts = all_launches()
        geo[path]["launches"] = counts
        log(f"main-path launches under {path}: {counts}")
        for name in names:
            assert counts[name] > 0, \
                f"{name} was not launched on the {path} main path"
            launches.setdefault(name, counts[name])
    assert set(launches) == set(KERNEL_ROWS), "a kernel has no main path"

    rows = []
    main_shape, main_dt = FLASH_MAIN
    for name, replaces in KERNEL_ROWS.items():
        route = ROUTES[name]
        if route == "triton":
            t = dict(times[MAIN_N][name], max_abs_err=err[name],
                     library_ms=None)
            where = {"n": MAIN_N}
        else:
            t = flash["by_shape"][f"{main_shape} {main_dt}"][name]
            # the error over every shape and dtype checked
            t = dict(t, max_abs_err=max(
                r[name]["max_abs_err"] for r in flash["by_shape"].values()))
            where = {"shape": list(main_shape), "dtype": main_dt}
        rows.append({
            "name": name, "route": route, "source": SOURCES[route],
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **where})
    report = {"nvidia_smi": smi, "kernels": rows,
              "times_by_size": {str(n): v for n, v in times.items()},
              "flash": flash, "full_width_step": full,
              "georound": geo, "seconds": time.perf_counter() - t0}
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
