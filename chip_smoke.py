#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. device report — the ``nvidia-smi`` name and power limit;
2. codec kernels — the CUDA C++ 2-bit quantize, dequantize and DGC
   update (``geomx_tpu_torch/csrc/quantize.cu``, built with ``nvcc``)
   against their plain PyTorch versions on the card, bitwise (tolerance:
   none), at 1, 3, 5, 384, 4097, 147,456, 401,408 (the CNN's largest
   leaf), 3,145,728 (the LM's largest) and 50,000,000 elements, on
   aligned tensors and on views offset by 1, 2 and 3 elements (f32
   inputs and uint8 codes alike), on inputs that hold signed zeros:
   quantize and dequantize in both layouts and on values exactly at
   ±t, the DGC update out of place and in place (``out`` = its inputs)
   at momentum 0.9 and 0.0; then at 384, 401,408, 3,145,728 and
   50,000,000 the CUDA-event time of each kernel (the DGC update also
   in place) and of its plain version (for the DGC update also the
   three in-place torch operations) beside its bound, GB/s, and each
   kernel's device time a call (``torch.profiler``, 10 calls each in one
   window); and the LM push sweep: the flagship LM's 35 key sizes in
   model order, one quantize each, then one dequantize each, CUDA-event
   time over 20 sweeps.  Each kernel's event time must be below its
   plain version's and below the event time of the Triton kernel it
   replaced, as last measured (``TRITON_LAST_MS``): at 401,408 for all
   three, and on the sweep for quantize and dequantize;
3. flash attention — the CUDA forward and backward kernels (built with
   ``nvcc`` for sm_90a from ``geomx_tpu_torch/csrc/``; bf16 on the
   tensor cores, f32 on them too as three TF32 products of split
   operands (3xTF32)) against their plain versions in bf16 and f32 at
   (B,T,H,Dh) = (8,128,6,64) (the flagship LM), (4,2048,16,128) (the
   MFU config), (2,1000,3,64) (a ragged tail), (1,2047,2,128) (T
   not a multiple of the 128-row tile), (1,1500,24,128) (the same on
   the two-warpgroup tiles, which the bf16 kernels take when 128-row
   tiles fill the SMs), (2,100,3,64) (T below one tile) and (1,1,1,64);
   tolerance f32 1e-4, bf16 2e-2, each times max(1, largest reference
   entry), and each of o, lse, dq, dk, dv within a relative L2 of f32
   1e-4, bf16 1e-2; in bf16 at Dh 128 the kernel's gradients must lie
   nearer the plain backward (which rounds p and ds*scale where JAX's
   kernel does) than the unrounded one; the ptxas log must show no
   spill in a tensor-core kernel; CUDA-event times of kernel, plain version
   and ``scaled_dot_product_attention`` (a yardstick only, never on the
   port's path), each beside its bound (in f32: three TF32 products at
   495 TFLOP/s), and at the LM's and the MFU shape in both dtypes each
   kernel's device time a call (``torch.profiler`` over 10 calls: the
   backward's delta, dK/dV and dQ kernels apart); the f32 forward and
   the f32 backward at the MFU shape must each take less event time than
   its plain version and than the FMA kernels they replaced, as last
   measured (``FMA_LAST_MS``);
3b. block attention — the CUDA kernel of a ring hop's partial block
   (``geomx_tpu_torch/csrc/block_attention.cu``; bf16 and f32, 3xTF32,
   on the tensor cores) against its plain version in bf16 and f32, for
   the three hop geometries (diagonal ``(0, 0)``, below ``(Tk, 0)``,
   above ``(0, Tq)``), a block straddling the diagonal off the tile grid
   ``(0, Tq//2 + 3)`` and non-causal, at (B,Tq,Tk,H,D) =
   (4,512,512,16,128) (the MFU config's hop at sp = 4: the main path),
   (8,32,32,6,64) (the flagship LM's at sp = 4), a ragged
   (2,250,250,3,64), (1,1,1,1,64), and Tq != Tk both ways
   (2,300,77,3,128), (1,70,400,2,64); ``m``, ``l`` and ``o`` each within
   f32 1e-4 / bf16 2e-2 times max(1, its largest unmasked reference
   entry) and within a relative L2 of 1e-4 / 1e-2, masked maxima exactly
   -1e30 and the ``l`` of a fully masked row exactly Tk; the ptxas log
   must show no spill in a tensor-core kernel; CUDA-event times of
   kernel, plain version and ``scaled_dot_product_attention`` on the
   same block and mask (a yardstick only: it returns normalised ``o``),
   each beside its bound, and at the main shape in both dtypes the
   kernel's device time a call in each geometry; the bf16 kernel at the
   main shape, "below", must take less event time than its plain version
   and than 0.30 ms, the f32 kernel there less than its plain version and
   than the FMA kernel it replaced (``FMA_LAST_MS``);
4. full-width reference step — one forward and backward of the port's
   transformer at the MFU config's widths (d 2048, 16 heads, 8 layers,
   d_ff 8192, seq 2048, batch 4, bf16, ~424M parameters) with
   ``attn_impl="flash"`` and again with ``"dense"`` (and ``"fast"``,
   which rounds the probabilities as flash does): losses within 1e-3
   relative, every leaf's gradient within 5e-2 relative L2; the flash
   and dense steps then run three more times each, and their warm walls
   are kept;
4b. the sequence-parallel step — the same weights and tokens through
   ``make_apply(cfg, mesh)`` on ``make_mesh({"dp": 1, "sp": 4, "tp": 1},
   devices=[card] * 4)`` with ring attention and ``attn_impl="flash"``
   (the main path of the block kernel: the launch counts are set to 0
   just before its forward and backward and read just after, and must
   be 8 layers × 4² = 128): loss and every gradient held to the
   single-device dense and fast steps of phase 4 with phase 4's gates;
   one forward with ``sp_attn="ulysses"`` against dense; then 3 Adam
   steps (lr 1e-3) on the repeated batch, whose loss must fall; the
   steps' wall times, and the last step's device time by kernel
   (``torch.profiler``, the device's own entries only), in which the
   block kernels must show;
4c. the f32 step — phase 4's widths and tokens in ``compute_dtype=
   float32`` (fresh weights from the same seed): one forward and
   backward with ``attn_impl="flash"`` (the f32 flash forward and
   backward on the tensor cores) and one with ``"dense"``
   (TF32 off for every torch product), then the same weights through
   ``make_apply`` on the ``sp = 4`` mesh with ring attention and
   ``"flash"`` (the f32 block kernel on every hop); loss within 1e-4
   relative and every leaf's gradient within 1e-3 relative L2 of dense
   for each; the launch counts, set to 0 just before each pass and read
   just after it, must be 8 f32 flash forwards and backwards and no
   bf16 launch, and 8 × 4² = 128 f32 block launches;
5. reference check — a 2×2 geo-round of the port's Simulation with a
   shared dyadic gradient function, on the card (torch backend, kernels)
   and on the host (numpy backend, host codecs): weights bitwise equal
   under 2bit and bsc;
6. geo-rounds — the port's main paths through their user entry points:
   ``geomx_tpu_torch.examples.cnn`` (2 parties × 2 workers + 1 global
   server, full-width CNN, FSA, Adam, a few steps under 2bit and again
   under bsc) and ``geomx_tpu_torch.examples.lm`` (the flagship LM at
   full width, 10,276,224 parameters, flash attention, bf16, FSA, Adam,
   8 steps under 2bit, and again in its default f32 for 3 steps); the
   launch counts are set to 0 just before each run and read just after
   it, and each path must launch its own kernels (2bit: quantize and
   dequantize; bsc: the DGC update, exactly 2 parties × 10 keys a step;
   LM: flash forward and backward, quantize and dequantize, in bf16 and
   in f32).

The three CUDA sources are built with ``nvcc`` at the start, in
parallel; phase 2 waits for the codec library, the small one.

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
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
# the f32 kernels whose products are three TF32 products (3xTF32): their
# bound counts 3 x the function's operations at the TF32 peak
TF32X3_KERNELS = ("flash_fwd", "flash_bwd", "block_attn_fwd")
SIZES = (1, 4097, 401_408, 50_000_000)
MAIN_N = 401_408              # largest leaf of the CNN: the main path's size
# the CUDA codec kernels are also checked at the LM's key sizes (384,
# 147,456, 3,145,728) and at sizes off a whole byte; offsets in elements
CODEC_SIZES = tuple(sorted(set(SIZES) | {3, 5, 384, 147_456, 3_145_728}))
CODEC_OFFSETS = (1, 2, 3)
CODEC_TIME_SIZES = (384, MAIN_N, 3_145_728, 50_000_000)
LM_SWEEPS = 20
THRESHOLD = 0.5
MOMENTUM = 0.9
DGC_MOMENTA = (MOMENTUM, 0.0)
# event times (ms) of the Triton kernels that the CUDA ones replaced, as
# last measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md, kernel table): at
# 401,408 elements, and over the LM push sweep
TRITON_LAST_MS = {"quantize_2bit": 0.0359, "dequantize_2bit": 0.0278,
                  "dgc_update": 0.0369}
TRITON_LAST_SWEEP_MS = {"quantize_2bit": 1.2189, "dequantize_2bit": 0.8287}
STEPS = 12
CNN_KEYS = 10                 # the CNN's parameter leaves: keys a push
# flash attention: (B, T, H, Dh) of the flagship LM (the main path),
# the MFU config, a ragged tail, T off the 128-row tile, T off it with
# enough (b, h) for the bf16 kernels' two-warpgroup tiles, T below one
# tile, and one token
FLASH_SHAPES = ((8, 128, 6, 64), (4, 2048, 16, 128), (2, 1000, 3, 64),
                (1, 2047, 2, 128), (1, 1500, 24, 128), (2, 100, 3, 64),
                (1, 1, 1, 64))
FLASH_MAIN = ((8, 128, 6, 64), "bfloat16")
FLASH_MFU = ((4, 2048, 16, 128), "bfloat16")   # also in the kernel rows
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# relative L2 of each output (o, lse, dq, dk, dv), a second gate beside
# the largest error: it sees an error spread over many entries that stays
# below the max-abs allowance entry by entry
FLASH_REL_L2 = {"float32": 1e-4, "bfloat16": 1e-2}
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
# the same LM in its default f32, where --attn-impl flash reaches the f32
# flash forward
LM_F32_STEPS = 3
LM_F32_ARGS = [a for flag, val in zip(LM_ARGS[0::2], LM_ARGS[1::2])
               for a in (flag, {"--steps": str(LM_F32_STEPS),
                                "--compute-dtype": "float32"}.get(flag, val))]
# block attention: (B, Tq, Tk, H, D) of the MFU config's ring hop at
# sp = 4 (the main path), the flagship LM's at sp = 4, a ragged tail, one
# token, and Tq != Tk both ways
BLOCK_SHAPES = ((4, 512, 512, 16, 128), (8, 32, 32, 6, 64),
                (2, 250, 250, 3, 64), (1, 1, 1, 1, 64),
                (2, 300, 77, 3, 128), (1, 70, 400, 2, 64))
BLOCK_MAIN = ((4, 512, 512, 16, 128), "bfloat16", "below")
BLOCK_MAIN_F32 = ((4, 512, 512, 16, 128), "float32", "below")
# the bf16 kernel at the main shape, "below", must beat its plain version
# and this event time (ms)
BLOCK_MAIN_MAX_MS = 0.30
# event times (ms) of the f32 FMA kernels that the 3xTF32 tensor-core
# kernels replaced, as last measured (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md, kernel table): the flash forward and backward at the MFU shape
# and the block "below" at the MFU hop; each new kernel must beat them
# there
FMA_LAST_MS = {"flash_fwd": 7.0180, "flash_bwd": 22.0077,
               "block_attn_fwd": 1.2300}
# phase 4c, f32 everywhere: flash (and the sp ring) against dense.  They
# differ by summation order, the forward's 3xTF32 products and the tensor
# cores' f32 accumulation, which the backward's delta = rowsum(dO * O)
# amplifies in the gradients where dP is close to delta (near-uniform
# attention at initialisation); the gates are tighter than phase 4's
# bf16 ones (1e-3, 5e-2), and PERF.md records what the step reaches
F32_STEP_LOSS_TOL = 1e-4
F32_STEP_GRAD_TOL = 1e-3
SP_MESH = {"dp": 1, "sp": 4, "tp": 1}
SP_ADAM_STEPS = 3


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


def _offset_view(t, off: int):
    """``t`` copied ``off`` elements into a larger tensor: a contiguous
    view whose first element lies ``off`` × its item size past an
    aligned start."""
    import torch

    base = torch.zeros(t.numel() + off, dtype=t.dtype, device=t.device)
    base[off:].copy_(t)
    return base[off:]


def _dgc_inputs(n: int, dev, seed: int):
    """Gradient, velocity and accumulator, all three -0.0 at the same
    places (a product and sums of negative zeros)."""
    import torch

    g, _ = _inputs(n, dev, seed)
    rng = np.random.default_rng(seed + 1)
    v = (rng.standard_normal(n) * 0.3).astype(np.float32)
    u = (rng.standard_normal(n) * 0.5).astype(np.float32)
    v[0::13] = -0.0
    u[0::13] = -0.0
    return g, torch.from_numpy(v).to(dev), torch.from_numpy(u).to(dev)


def check_kernels(dev) -> dict:
    """Every codec kernel against its plain version at every size, on
    aligned tensors and offset views; returns the largest absolute error
    of each kernel (0 where bitwise)."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    err = {"quantize_2bit": 0.0, "dequantize_2bit": 0.0, "dgc_update": 0.0}
    for n in CODEC_SIZES:
        g, r = _inputs(n, dev, seed=n)
        for layout in Q.LAYOUTS:
            for off in (0,) + CODEC_OFFSETS:
                gv, rv = ((g, r) if off == 0 else
                          (_offset_view(g, off), _offset_view(r, off)))
                p_k, r_k = C.quantize_2bit(gv, rv, THRESHOLD, layout)
                p_p, r_p = Q.quantize_2bit_ref(gv, rv, THRESHOLD, layout)
                torch.cuda.synchronize()
                what = f"quantize {layout} n={n} offset {off}"
                assert _bits_equal(p_k, p_p), f"{what}: codes"
                assert _bits_equal(r_k, r_p), f"{what}: residual"
                err["quantize_2bit"] = max(err["quantize_2bit"],
                                           _max_abs(r_k, r_p))
                pv = p_k if off == 0 else _offset_view(p_k, off)
                d_k = C.dequantize_2bit(pv, n, THRESHOLD, layout)
                d_p = Q.dequantize_2bit_ref(pv, n, THRESHOLD, layout)
                torch.cuda.synchronize()
                assert _bits_equal(d_k, d_p), \
                    f"dequantize {layout} n={n} offset {off}"
                err["dequantize_2bit"] = max(err["dequantize_2bit"],
                                             _max_abs(d_k, d_p))
        if n > 1:
            # consecutive layout: the -0.0 residual survives
            z = r_k[0::13]
            z = z[z == 0]
            assert z.numel() > 0 and bool(torch.signbit(z).all()), \
                "consecutive residual lost -0.0"
        del g, r, p_k, r_k, p_p, r_p, pv, d_k, d_p
        g, v, u = _dgc_inputs(n, dev, seed=n)
        for off in (0,) + CODEC_OFFSETS:
            gv, vv, uv = (_offset_view(t, off) for t in (g, v, u))
            for m in DGC_MOMENTA:
                # tolerance: none — the kernel rounds m·v and each sum
                # apart (__fmul_rn/__fadd_rn), as the plain version does
                v_p, u_p = Q.dgc_update_ref(vv, uv, gv, m)
                v_k, u_k = C.dgc_update(vv, uv, gv, m)
                vi, ui = _offset_view(vv, off), _offset_view(uv, off)
                C.dgc_update(vi, ui, gv, m, out=(vi, ui))
                torch.cuda.synchronize()
                for a, b, what in ((v_k, v_p, "v"), (u_k, u_p, "u"),
                                   (vi, v_p, "v in place"),
                                   (ui, u_p, "u in place")):
                    err["dgc_update"] = max(err["dgc_update"],
                                            _max_abs(a, b))
                    assert _bits_equal(a, b), \
                        f"dgc n={n} offset {off} m={m} {what}: not bitwise"
        if n > 1:
            z = u_p[0::13]
            z = z[z == 0]
            assert z.numel() > 0 and bool(torch.signbit(z).all()), \
                "the DGC update lost -0.0"
        log(f"kernels n={n}: quantize/dequantize bitwise in both layouts, "
            f"dgc bitwise out of place and in place at momenta "
            f"{DGC_MOMENTA}, at offsets 0-3")
        del g, v, u, gv, vv, uv, v_p, u_p, v_k, u_k, vi, ui
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


def _in_turns(first, second, iters: int) -> tuple:
    """Event times (ms) of two versions of one function, run first,
    second, second, first: the mean of each version's two runs."""
    a1 = _time_ms(first, iters)
    b1 = _time_ms(second, iters)
    b2 = _time_ms(second, iters)
    a2 = _time_ms(first, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


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


def _bound_ms(name: str, n: int) -> tuple:
    nbytes, ops = kernel_costs(n)[name]
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / F32_OPS_PER_S * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                 else "operations")


def _codec_kernel_of(name: str):
    """The function a profiler kernel name belongs to."""
    for marker, fn in (("dgc_update", "dgc_update"),
                       ("dequant_", "dequantize_2bit"),
                       ("quant_", "quantize_2bit")):
        if marker in name:
            return fn
    return None


def _below_gates(what: str, ms: float, plain_ms: float,
                 replaced_ms: float, replaced: str = "Triton") -> None:
    """A kernel's event time must be below its plain version's and the
    last measured one of the kernel it replaced (Triton, or f32 FMA)."""
    assert ms < min(plain_ms, replaced_ms), (
        f"{what}: CUDA {ms:.4f} ms, not below its plain version's "
        f"{plain_ms:.4f} ms and the {replaced} kernel's {replaced_ms:.4f} ms")


def time_kernels(dev, sizes, iters_for) -> dict:
    """At each size: CUDA-event times of the CUDA quantize, dequantize
    and DGC update (out of place and in place) and of their plain
    versions, and of the three in-place torch operations of the DGC
    update, warm in L2 where the tensors fit (the codec reads the
    accumulator the merge just wrote); then each kernel's device time a
    call (one profiler window, 10 calls of each)."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    lay = "consecutive"
    out = {}
    for n in sizes:
        g, r = _inputs(n, dev, seed=7)
        v = r * 3.0
        packed, _ = C.quantize_2bit(g, r, THRESHOLD, lay)
        vv, uu = v.clone(), r.clone()
        it = iters_for(n)
        calls = {
            "quantize_2bit": (
                lambda: C.quantize_2bit(g, r, THRESHOLD, lay),
                lambda: Q.quantize_2bit_ref(g, r, THRESHOLD, lay)),
            "dequantize_2bit": (
                lambda: C.dequantize_2bit(packed, n, THRESHOLD, lay),
                lambda: Q.dequantize_2bit_ref(packed, n, THRESHOLD, lay)),
            "dgc_update": (
                lambda: C.dgc_update(v, r, g, MOMENTUM),
                lambda: Q.dgc_update_ref(v, r, g, MOMENTUM)),
        }
        out[n] = {name: {"ms": _time_ms(call, it),
                         "plain_ms": _time_ms(plain, it)}
                  for name, (call, plain) in calls.items()}

        def torch_inplace():
            vv.mul_(MOMENTUM).add_(g)
            uu.add_(vv)

        dgc = out[n]["dgc_update"]
        dgc["inplace_ms"] = _time_ms(
            lambda: C.dgc_update(vv, uu, g, MOMENTUM, out=(vv, uu)), it)
        dgc["torch_inplace_ms"] = _time_ms(torch_inplace, it)
        # device time a call: 10 calls of each kernel in one window
        by = _device_ms_by_kernel(lambda: [call() for call, _ in
                                           calls.values()
                                           for _ in range(10)])
        dev_ms = {}
        for k, t in by.items():
            fn = _codec_kernel_of(k)
            if fn is not None:
                dev_ms[fn] = dev_ms.get(fn, 0.0) + t / 10
        for name, rec in out[n].items():
            nbytes = kernel_costs(n)[name][0]
            rec["bound_ms"], rec["bound_by"] = _bound_ms(name, n)
            rec["device_ms"] = dev_ms.get(name)
            rec["gb_per_s"] = nbytes / (rec["ms"] * 1e-3) / 1e9
            assert rec["device_ms"] is not None, \
                f"the profiler saw no {name} kernel at n={n}"
            log(f"time n={n} {name}: cuda {rec['ms']:.4f} ms "
                f"({rec['gb_per_s']:.1f} GB/s), device "
                f"{rec['device_ms']:.5f} ms a call"
                + (f"; in place {rec['inplace_ms']:.4f} ms, in-place torch "
                   f"{rec['torch_inplace_ms']:.4f} ms"
                   if name == "dgc_update" else "")
                + f"; plain {rec['plain_ms']:.4f} ms, bound "
                f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
        del g, r, v, vv, uu, packed
        torch.cuda.empty_cache()
    for name, rec in out[MAIN_N].items():
        _below_gates(f"{name} n={MAIN_N}", rec["ms"], rec["plain_ms"],
                     TRITON_LAST_MS[name])
    return out


def lm_key_sizes() -> list:
    """The flagship LM's key sizes in model order (its push order)."""
    import torch

    from geomx_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)

    a = dict(zip(LM_ARGS[0::2], LM_ARGS[1::2]))
    cfg = TransformerConfig(
        vocab=int(a["--vocab"]), d_model=int(a["--d-model"]),
        n_heads=int(a["--heads"]), n_layers=int(a["--layers"]),
        d_ff=int(a["--d-ff"]), max_seq=int(a["--seq"]))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sizes = [t.numel() for t in params.values()]
    assert sum(sizes) == LM_PARAMS, sum(sizes)
    return sizes


def time_lm_sweep(dev) -> dict:
    """One party's push of the flagship LM through the codec: its 35
    keys in model order, one quantize each, then one dequantize each of
    the codes; CUDA-event time of a sweep over ``LM_SWEEPS`` sweeps, of
    the CUDA kernels and of the plain versions."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    lay = "consecutive"
    sizes = lm_key_sizes()
    keys = [_inputs(n, dev, seed=i) for i, n in enumerate(sizes)]
    codes = [C.quantize_2bit(g, r, THRESHOLD, lay)[0] for g, r in keys]

    def quant(m):
        return lambda: [m.quantize_2bit(g, r, THRESHOLD, lay)
                        for g, r in keys]

    def dequant(m):
        return lambda: [m.dequantize_2bit(p, n, THRESHOLD, lay)
                        for p, n in zip(codes, sizes)]

    out = {"keys": len(sizes), "elements": sum(sizes), "sweeps": LM_SWEEPS}
    for name, (sweep, plain) in (
            ("quantize_2bit", (quant(C), lambda: [
                Q.quantize_2bit_ref(g, r, THRESHOLD, lay) for g, r in keys])),
            ("dequantize_2bit", (dequant(C), lambda: [
                Q.dequantize_2bit_ref(p, n, THRESHOLD, lay)
                for p, n in zip(codes, sizes)]))):
        ms = _time_ms(sweep, LM_SWEEPS)
        bound = sum(_bound_ms(name, n)[0] for n in sizes)
        out[name] = {"ms": ms, "plain_ms": _time_ms(plain, LM_SWEEPS),
                     "bound_ms": bound}
        log(f"LM push sweep ({len(sizes)} keys, {sum(sizes)} elements) "
            f"{name}: cuda {ms:.4f} ms, plain "
            f"{out[name]['plain_ms']:.4f} ms, bound {bound:.5f} ms")
        _below_gates(f"LM push sweep {name}", ms, out[name]["plain_ms"],
                     TRITON_LAST_SWEEP_MS[name])
    del keys, codes
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


def _bound(flops: float, nbytes: float, dtype: str, name: str):
    """(least time in ms, what bounds it) of kernel ``name``'s function:
    bf16 products at the bf16 tensor-core peak; f32 products as three
    TF32 products each (3xTF32) at the TF32 peak."""
    assert dtype == "bfloat16" or name in TF32X3_KERNELS, name
    if dtype == "bfloat16":
        ops, peak = flops, BF16_OPS_PER_S
    else:
        ops, peak = 3 * flops, TF32_OPS_PER_S
    b_ops = ops / peak * 1e3
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(b_ops, b_bytes), ("operations" if b_ops >= b_bytes
                                 else "bytes")


def _rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref||, the denominator held at least at an rms of
    1e-2 (at T = 1 the gradients of q and k are rounding noise about 0,
    where the typical rms is 0.08-0.3)."""
    floor = 1e-2 * math.sqrt(max(ref.numel(), 1))
    return float((got.double() - ref.double()).norm()
                 / max(float(ref.double().norm()), floor))


def _flash_bwd_unrounded(q, k, v, o, lse, do, sm_scale):
    """The plain backward as it stood before it rounded where JAX's
    kernel rounds: ``p`` and ``ds`` kept in f32, dK and dQ scaled after
    the product.  A control: the bf16 kernel must lie nearer the
    rounding plain version than this one."""
    import torch

    from geomx_tpu_torch.ops import flash_attention as FA

    s = FA._scores(q, k, sm_scale)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def check_flash(dev) -> dict:
    """Each flash kernel against its plain version at every shape and
    dtype, then CUDA-event times of kernel, plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    from geomx_tpu_torch.ops import flash_attention as FA
    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    ptx = _ptxas(FK.LIB)
    log(f"flash kernels: ptxas: {'; '.join(ptx)}")
    spills = _spilling(FK.LIB.log, "_tc_kernel")
    assert not spills, f"tensor-core flash kernels spill: {spills}"
    out = {"ptxas": ptx, "by_shape": {}}
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
            rel = {n: _rel_l2(g, r) for n, g, r in zip(
                ("o", "lse", "dq", "dk", "dv"), (o, lse, *grads),
                (ro, rlse, *refs))}
            assert max(rel.values()) <= FLASH_REL_L2[dt], (
                f"flash {shape} {dt}: relative L2 {rel} > "
                f"{FLASH_REL_L2[dt]}")
            control = None
            if dt == "bfloat16" and shape[-1] == 128:
                # where the kernel rounds: 1/sqrt(128) is not a power of
                # two, so rounding ds*scale and scaling after differ too
                unr = _flash_bwd_unrounded(q, k, v, o, lse, do, scale)
                control = {n: _rel_l2(g, u) for n, g, u in zip(
                    ("dq", "dk", "dv"), grads, unr)}
                for n in control:
                    assert rel[n] < control[n], (
                        f"flash {shape} bf16 d{n[1]}: rel L2 {rel[n]:.3e} to "
                        f"the rounding plain version, not below "
                        f"{control[n]:.3e} to the unrounded one")
                del unr
            log(f"flash {shape} {dt}: rel L2 o/lse/dq/dk/dv "
                + "/".join(f"{rel[n]:.3g}" for n in rel)
                + f" (gate {FLASH_REL_L2[dt]:g})"
                + ("" if control is None else
                   "; dq/dk/dv to the unrounded backward "
                   + "/".join(f"{control[n]:.3g}" for n in control)))
            # SDPA, the library yardstick: [B, H, T, Dh]
            sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
            sdo = do.transpose(1, 2).contiguous()
            # the plain version takes 10-20 ms a call at the MFU shape
            it, plain_it = 50, (5 if shape[1] >= 2048 else 50)
            times = {
                "flash_fwd": (
                    _time_ms(lambda: FK.flash_fwd(q, k, v, scale), it),
                    _time_ms(lambda: FA.flash_attention_ref(q, k, v, scale),
                             plain_it),
                    _time_ms(lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, is_causal=True), it)),
                "flash_bwd": (
                    _time_ms(lambda: FK.flash_bwd(q, k, v, o, lse, do,
                                                  scale), it),
                    _time_ms(lambda: FA.flash_attention_bwd_ref(
                        q, k, v, o, lse, do, scale), plain_it),
                    _time_ms(lambda: torch.autograd.grad(
                        so, (sq, sk, sv), sdo, retain_graph=True), it)),
            }
            costs = flash_costs(shape, dt)
            rec = {"rel_l2": rel, "rel_l2_to_unrounded": control}
            if shape in (FLASH_MAIN[0], FLASH_MFU[0]):
                # device time by kernel a call, over 10 calls (a one-call
                # window can lose records), in both dtypes: the event
                # times at the LM's shape are mostly the host's launch
                # path
                for name, fn in (
                        ("flash_fwd", lambda: FK.flash_fwd(q, k, v, scale)),
                        ("flash_bwd", lambda: FK.flash_bwd(q, k, v, o, lse,
                                                           do, scale))):
                    by = {n: t / 10 for n, t in _device_ms_by_kernel(
                        lambda: [fn() for _ in range(10)]).items()}
                    rec[f"{name}_device_ms"] = by
                    log(f"flash {name} {shape} {dt}: device ms by kernel "
                        + "; ".join(f"{n[:40]} {t:.4f}"
                                    for n, t in by.items()))
            for name, (ms, plain_ms, lib_ms) in times.items():
                flops, nbytes = costs[name]
                bound_ms, bound_by = _bound(flops, nbytes, dt, name)
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
            if (shape, dt) == (FLASH_MFU[0], "float32"):
                for name in ("flash_fwd", "flash_bwd"):
                    f = rec[name]
                    _below_gates(f"{name} {shape} f32", f["ms"],
                                 f["plain_ms"], FMA_LAST_MS[name], "FMA")
            out["by_shape"][f"{shape} {dt}"] = rec
            del q, k, v, do, o, lse, ro, rlse, grads, refs, sq, sk, sv, so
            torch.cuda.empty_cache()
    return out


# ---- the CUDA builds, in parallel ----------------------------------------

def start_cuda_builds():
    """Start ``nvcc`` on every CUDA source at once; returns the futures
    (``.result()`` re-raises a failed build)."""
    from concurrent.futures import ThreadPoolExecutor

    from geomx_tpu_torch.ops.kernels import block_attention as KB
    from geomx_tpu_torch.ops.kernels import flash_attention as FK
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    pool = ThreadPoolExecutor(max_workers=3)
    t0 = time.perf_counter()

    def build(lib):
        lib.load()
        return time.perf_counter() - t0

    futs = {name: pool.submit(build, lib)
            for name, lib in (("codec", C.LIB), ("flash", FK.LIB),
                              ("block", KB.LIB))}
    pool.shutdown(wait=False)
    return futs


def _ptxas(lib) -> list:
    return [ln.strip() for ln in lib.log.splitlines()
            if "registers" in ln or "spill" in ln]


def _spilling(log: str, marker: str) -> list:
    """The kernels whose mangled name holds ``marker`` and for which
    ptxas reported spill stores, from the library's ptxas log."""
    assert "Compiling entry function" in log, \
        "no ptxas log of the library: remove its cached build to rebuild"
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif "bytes spill stores" in ln and name and marker in name:
            if not ln.strip().split(", ")[1].startswith("0 bytes"):
                out.append(name)
    return out


# ---- phase 3b: block attention against its plain version ---------------

def _geometries(Tq: int, Tk: int) -> dict:
    """(q_off, k_off, causal) of each ring-hop geometry, and a block that
    straddles the diagonal off the tile grid: rows fully masked, partly
    visible and mixed within one query tile."""
    return {"diagonal": (0, 0, True), "below": (Tk, 0, True),
            "above": (0, Tq, True), "straddle": (0, Tq // 2 + 3, True),
            "noncausal": (0, 0, False)}


def block_costs(Tq: int, Tk: int, B: int, H: int, D: int, q_off: int,
                k_off: int, causal: bool, dtype: str) -> tuple:
    """(flops, bytes) the block's function needs: two products over the
    visible (query, key) pairs, and for each fully masked row the sum of
    v over its keys; q, k, v read once, m, l, o (f32) written once."""
    es = 4 if dtype == "float32" else 2
    i = q_off + np.arange(Tq)
    if causal:
        vis = np.clip(i - k_off + 1, 0, Tk)
    else:
        vis = np.full(Tq, Tk)
    pairs = int(vis.sum()) * B * H
    masked_rows = int((vis == 0).sum()) * B * H
    flops = 4 * D * pairs + Tk * D * masked_rows
    nbytes = ((B * Tq + 2 * B * Tk) * H * D * es
              + (2 * B * Tq * H + B * Tq * H * D) * 4)
    return flops, nbytes


def _block_check(got, ref, tol: float, rel_tol: float, Tk: int) -> tuple:
    """({output: error}, {output: allowance}, {output: relative L2}) for
    m, l and o, each held to ``tol`` times max(1, its largest unmasked
    reference entry) and to a relative L2 of ``rel_tol`` over its
    unmasked entries; a masked maximum (-1e30) must be exact, and the l
    of a fully masked row exactly Tk."""
    import torch

    dead = ref[0] <= -1e29
    assert torch.equal(got[1][dead], torch.full_like(got[1][dead], Tk)), \
        "l of a fully masked row is not Tk"
    errs, allows, rels = {}, {}, {}
    for name, g, r in zip("mlo", got, ref):
        masked = r <= -1e29
        assert torch.equal(g[masked], r[masked]), f"{name}: masked rows"
        live = r[~masked]
        allows[name] = tol * max(
            1.0, float(live.abs().max()) if live.numel() else 0.0)
        errs[name] = _max_abs(g[~masked], live)
        rels[name] = _rel_l2(g[~masked], live)
        assert errs[name] <= allows[name], \
            f"{name}: max abs err {errs[name]} > {allows[name]}"
        assert rels[name] <= rel_tol, \
            f"{name}: relative L2 {rels[name]} > {rel_tol}"
    return errs, allows, rels


def check_block(dev) -> dict:
    """The block kernel against its plain version at every shape, dtype
    and geometry, then CUDA-event times of kernel, plain version and SDPA
    on the same block and mask, and at the main shape in bf16 the
    kernel's device time a call."""
    import torch
    import torch.nn.functional as F

    from geomx_tpu_torch.ops import block_attention as BA
    from geomx_tpu_torch.ops.kernels import block_attention as KB

    ptx = _ptxas(KB.LIB)
    log(f"block kernel: ptxas: {'; '.join(ptx)}")
    spills = _spilling(KB.LIB.log, "_tc_kernel")
    assert not spills, f"tensor-core block kernels spill: {spills}"
    out = {"ptxas": ptx, "by_case": {}}
    for shape in BLOCK_SHAPES:
        B, Tq, Tk, H, D = shape
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            rng = np.random.default_rng(sum(shape) + 1)
            q = torch.from_numpy(rng.standard_normal(
                (B, Tq, H, D)).astype(np.float32)).to(dev, dtype)
            k, v = (torch.from_numpy(rng.standard_normal(
                (B, Tk, H, D)).astype(np.float32)).to(dev, dtype)
                for _ in range(2))
            sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            it = 20 if Tq >= 512 else 50
            for geo, (qo, ko, causal) in _geometries(Tq, Tk).items():
                offs = (qo, ko)
                got = KB.block_attn_fwd(q, k, v, offs, causal)
                ref = BA.block_attention_ref(q, k, v, offs, causal)
                torch.cuda.synchronize()
                errs, allows, rels = _block_check(
                    got, ref, FLASH_TOL[dt], FLASH_REL_L2[dt], Tk)
                mask = None
                if causal:
                    mask = ((qo + torch.arange(Tq, device=dev))[:, None]
                            >= (ko + torch.arange(Tk, device=dev))[None, :])
                ms = _time_ms(lambda: KB.block_attn_fwd(q, k, v, offs,
                                                        causal), it)
                plain_ms = _time_ms(lambda: BA.block_attention_ref(
                    q, k, v, offs, causal), it)
                lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=mask), it)
                flops, nbytes = block_costs(Tq, Tk, B, H, D, qo, ko, causal,
                                            dt)
                bound_ms, bound_by = _bound(flops, nbytes, dt,
                                            "block_attn_fwd")
                rec = {"max_abs_err": max(errs.values()), "errs": errs,
                       "tols": allows, "rel_l2": rels, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "flops": flops, "bytes": nbytes,
                       "tflop_per_s": flops / (ms * 1e-3) / 1e12}
                if shape == BLOCK_MAIN[0]:
                    by = {n: t / 10 for n, t in _device_ms_by_kernel(
                        lambda: [KB.block_attn_fwd(q, k, v, offs, causal)
                                 for _ in range(10)]).items()}
                    rec["device_ms_by_kernel"] = by
                    rec["device_ms"] = sum(
                        t for n, t in by.items() if "block_attn" in n)
                    log(f"block {shape} {dt} {geo}: device ms a call "
                        + "; ".join(f"{n[:60]} {t:.4f}"
                                    for n, t in by.items()))
                out["by_case"][f"{shape} {dt} {geo}"] = rec
                log(f"block {shape} {dt} {geo}: max abs err m/l/o "
                    + "/".join(f"{errs[n]:.3g}" for n in "mlo")
                    + " (tol " + "/".join(f"{allows[n]:.3g}" for n in "mlo")
                    + "), rel L2 " + "/".join(f"{rels[n]:.3g}" for n in "mlo")
                    + f" (gate {FLASH_REL_L2[dt]:g}); kernel {ms:.4f} ms "
                    f"({rec['tflop_per_s']:.2f} TFLOP/s), plain "
                    f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by})")
                del got, ref
            del q, k, v, sq, sk, sv
            torch.cuda.empty_cache()
    main = out["by_case"][" ".join(str(x) for x in BLOCK_MAIN)]
    assert main["ms"] < min(main["plain_ms"], BLOCK_MAIN_MAX_MS), (
        f"block {BLOCK_MAIN}: kernel {main['ms']:.4f} ms, not below its "
        f"plain version's {main['plain_ms']:.4f} ms and "
        f"{BLOCK_MAIN_MAX_MS} ms")
    main = out["by_case"][" ".join(str(x) for x in BLOCK_MAIN_F32)]
    _below_gates(f"block {BLOCK_MAIN_F32}", main["ms"], main["plain_ms"],
                 FMA_LAST_MS["block_attn_fwd"], "FMA")
    return out


# ---- phase 4: full-width reference step, flash against dense ------------

def check_full_width_step(dev) -> tuple:
    """One forward + backward at the MFU config's widths, flash against
    dense (and fast) attention on the same weights and tokens.  Returns
    the summary and what phase 4b holds the sequence-parallel step to:
    the weights, the tokens and the dense and fast losses and grads."""
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

    def warm_walls(impl):
        """The walls of three more steps, after one that warmed the
        allocator and the libraries (a single wall varies several-fold
        with the host)."""
        return [step(impl)[2] for _ in range(3)]

    lf, gf, tf = step("flash")
    tf_warm = warm_walls("flash")
    out = {"n_params": n_params, "loss_flash": lf, "wall_s_flash": tf,
           "warm_walls_s_flash": tf_warm}
    refs = {"cfg": cfg, "params": params, "tokens": tokens}
    # dense is the reference the tolerance holds; fast rounds p to bf16
    # before the PV product as flash does, so it shows how much of the
    # difference that rounding makes
    for impl in ("dense", "fast"):
        lo, go, to = step(impl)
        rel_loss, rel = _rel_diffs(lf, gf, lo, go)
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
        refs[impl] = (lo, go)
    out["dense"]["warm_walls_s"] = warm_walls("dense")
    log(f"full-width step warm walls (s): flash "
        f"{[round(w, 4) for w in tf_warm]} (median "
        f"{float(np.median(tf_warm)):.4f}), dense "
        f"{[round(w, 4) for w in out['dense']['warm_walls_s']]} (median "
        f"{float(np.median(out['dense']['warm_walls_s'])):.4f})")
    del gf
    torch.cuda.empty_cache()
    return out, refs


def _rel_diffs(loss, grads, ref_loss, ref_grads) -> tuple:
    """(relative loss difference, {leaf: relative L2 gradient
    difference})."""
    rel = {n: float((grads[n] - ref_grads[n]).norm() / ref_grads[n].norm())
           for n in ref_grads}
    return abs(loss - ref_loss) / abs(ref_loss), rel


# ---- phase 4b: the sequence-parallel step ------------------------------

def _device_ms_by_kernel(fn) -> dict:
    """Device time (ms) of each kernel and copy over one call of ``fn``
    (``torch.profiler``).  Only the device's own entries count: a CPU
    op's entry carries the time of the kernels it launched, which the
    kernels' entries count already."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:
            continue
        ms = evt.self_device_time_total / 1e3
        if ms > 0:
            out[evt.key] = out.get(evt.key, 0.0) + ms
    return out


def check_sp_step(dev, refs: dict) -> dict:
    """The MFU-width step sequence parallel over 4 ranks on the card (ring
    attention, the block kernel on every hop) against phase 4's
    single-device dense and fast steps; a Ulysses forward against dense;
    3 Adam steps on the repeated batch.  The launch counts around the
    ring step are this path's."""
    import dataclasses

    import torch

    from geomx_tpu_torch.models.transformer import (
        lm_loss, make_apply, make_lm_grad_fn)
    from geomx_tpu_torch.parallel import make_mesh

    cfg, params, tokens = refs["cfg"], refs["params"], refs["tokens"]
    mesh = make_mesh(SP_MESH, devices=[dev] * SP_MESH["sp"])
    ring = dataclasses.replace(cfg, attn_impl="flash", sp_attn="ring")
    grad_fn = make_lm_grad_fn(ring, mesh)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    loss, _, grads = grad_fn(params, tokens, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_launches()
    loss = float(loss)
    want = cfg.n_layers * SP_MESH["sp"] ** 2
    log(f"sp step (ring, flash, sp={SP_MESH['sp']} on one card): loss "
        f"{loss:.6f}, wall {wall:.3f} s (first call), launches {counts}")
    assert counts["block_attn_fwd"] == want, \
        f"block kernel launched {counts['block_attn_fwd']} times, not {want}"
    out = {"loss": loss, "wall_s": wall, "launches": counts}
    for impl in ("dense", "fast"):
        rel_loss, rel = _rel_diffs(loss, grads, *refs[impl])
        worst = max(rel, key=rel.get)
        log(f"sp step against single-device {impl}: loss rel "
            f"{rel_loss:.2e} (tol 1e-3); worst leaf grad rel L2 "
            f"{rel[worst]:.2e} ({worst}, tol 5e-2)")
        assert math.isfinite(loss) and rel_loss <= 1e-3, \
            f"sp loss differs from {impl}"
        assert rel[worst] <= 5e-2, f"sp grad of {worst} differs ({impl})"
        out[impl] = {"rel_loss": rel_loss, "grad_rel_l2": rel}
    del grads

    x = torch.as_tensor(tokens, device=dev).long()
    uly = make_apply(dataclasses.replace(ring, sp_attn="ulysses"), mesh)
    with torch.no_grad():
        lu = float(lm_loss(uly, params, x))
        rel_u = abs(lu - refs["dense"][0]) / abs(refs["dense"][0])
        log(f"sp forward (ulysses): loss {lu:.6f}, rel to dense "
            f"{rel_u:.2e} (tol 1e-3)")
        assert rel_u <= 1e-3, "ulysses loss differs from dense"
        out["ulysses"] = {"loss": lu, "rel_loss": rel_u}

    apply = make_apply(ring, mesh)
    p = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=1e-3)
    losses, walls = [], []

    def adam_step():
        opt.zero_grad(set_to_none=True)
        step_loss = lm_loss(apply, p, x)
        step_loss.backward()
        opt.step()
        losses.append(float(step_loss.detach()))

    for _ in range(SP_ADAM_STEPS - 1):
        t0 = time.perf_counter()
        adam_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # the last step runs under the profiler: its device time by kernel
    by_kernel = _device_ms_by_kernel(adam_step)
    device_ms = sum(by_kernel.values())
    # block_attn_tc_kernel (bf16) and block_attn_f32_tc_kernel (f32)
    block_ms = sum(v for k, v in by_kernel.items() if "block_attn" in k)
    assert block_ms > 0, "the profiler saw no block kernel in the sp step"
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    log(f"sp Adam steps on a repeated batch: losses {losses}, walls "
        f"{[round(w, 3) for w in walls]} s (the last step profiled)")
    log(f"sp Adam step device time {device_ms:.3f} ms, block kernel "
        f"{block_ms:.3f} ms ({want} launches, {100 * block_ms / device_ms:.1f} "
        f"%); top kernels (ms): "
        + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top.items()))
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], \
        "the sp step's loss did not fall"
    out["adam"] = {"losses": losses, "wall_s": walls,
                   "profiled_step": {"device_ms": device_ms,
                                     "block_kernel_ms": block_ms,
                                     "top_kernels_ms": top}}
    del p, opt
    torch.cuda.empty_cache()
    return out


# ---- phase 4c: the f32 step, single device and sequence parallel --------

def check_f32_step(dev) -> dict:
    """The MFU-width step in f32: flash against dense on one device, then
    the ring over the ``sp`` mesh against the same dense step; the
    launch counts around each pass are its own."""
    import dataclasses

    import torch

    from geomx_tpu_torch.data import synthetic_lm
    from geomx_tpu_torch.models.transformer import (
        TransformerConfig, init_params, make_lm_grad_fn)
    from geomx_tpu_torch.parallel import make_mesh

    cfg = TransformerConfig(**MFU_WIDTHS, attn_impl="flash",
                            compute_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    tokens = synthetic_lm(n=MFU_BATCH, seq=cfg.max_seq, vocab=cfg.vocab,
                          seed=0)
    mesh = make_mesh(SP_MESH, devices=[dev] * SP_MESH["sp"])

    def step(c, m=None):
        fn = make_lm_grad_fn(c, m)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        loss, _, grads = fn(params, tokens, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return float(loss), grads, wall, all_launches()

    ld, gd, td, _ = step(dataclasses.replace(cfg, attn_impl="dense"))
    out = {"loss_dense": ld, "wall_s_dense": td}
    L, sp = cfg.n_layers, SP_MESH["sp"]
    want = {"flash": {"flash_fwd_f32": L, "flash_bwd_f32": L},
            "sp_ring": {"block_attn_fwd_f32": L * sp ** 2}}
    for name, c, m in (
            ("flash", cfg, None),
            ("sp_ring", dataclasses.replace(cfg, sp_attn="ring"), mesh)):
        lo, go, to, counts = step(c, m)
        rel_loss, rel = _rel_diffs(lo, go, ld, gd)
        worst = max(rel, key=rel.get)
        log(f"f32 step {name}: loss {lo:.6f} dense {ld:.6f} (rel "
            f"{rel_loss:.2e}, tol {F32_STEP_LOSS_TOL:g}); worst leaf grad "
            f"rel L2 {rel[worst]:.2e} ({worst}, tol {F32_STEP_GRAD_TOL:g}); "
            f"wall {to:.3f} s (dense {td:.3f} s, first calls); launches "
            f"{counts}")
        assert math.isfinite(lo) and rel_loss <= F32_STEP_LOSS_TOL, \
            f"f32 {name} loss differs from dense"
        assert rel[worst] <= F32_STEP_GRAD_TOL, \
            f"f32 {name} grad of {worst} differs from dense"
        launched = {k: v for k, v in counts.items() if v}
        assert launched == want[name], \
            f"f32 {name}: launches {launched}, not {want[name]}"
        out[name] = {"loss": lo, "rel_loss": rel_loss, "grad_rel_l2": rel,
                     "wall_s": to, "launches": counts}
        del go
    del gd, params
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


def run_lm_georound(argv=LM_ARGS, steps: int = LM_STEPS) -> dict:
    """The flagship LM through ``geomx_tpu_torch.examples.lm``."""
    import torch

    from geomx_tpu_torch.examples.lm import build_parser, train

    args = build_parser().parse_args(argv)
    stamps = []
    out = train(args, log=lambda msg: stamps.append(time.perf_counter()))
    losses = [l for h in out["histories"].values() for l, _ in h]
    assert len(losses) == 4 * steps, "a worker did not finish its steps"
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
    # steady state from the third step on; a run of 3 steps has none
    steady = ((len(stamps) - 3) / (stamps[-1] - stamps[2])
              if len(stamps) > 3 else None)
    tokens_per_step = 4 * args.batch * args.seq
    wan = out["wan"]["wan_send_bytes"] / steps
    first = [h[0][0] for h in out["histories"].values()]
    last = [h[-1][0] for h in out["histories"].values()]
    log(f"geo-round lm 2bit {args.compute_dtype}: {steps} steps, "
        f"{out['n_params']} params, loss {np.mean(first):.4f} -> "
        f"{np.mean(last):.4f}, "
        + (f"{steady:.3f} steps/s steady ({steady * tokens_per_step:.0f} "
           f"tokens/s), " if steady else "")
        + f"{out['seconds']:.2f} s total, WAN bytes/step {wan:.0f}")
    return {"steps_per_s": steady,
            "tokens_per_s": steady and steady * tokens_per_step,
            "wan_bytes_per_step": wan, "n_params": out["n_params"],
            "loss_first": float(np.mean(first)),
            "loss_last": float(np.mean(last)), "seconds": out["seconds"]}


# the kernels each main path must launch; a kernel's ``launches`` in the
# kernel table is the count from the first path that lists it
PATH_KERNELS = {"2bit": ("quantize_2bit", "dequantize_2bit"),
                "bsc": ("dgc_update",),
                "lm": ("flash_fwd", "flash_bwd", "quantize_2bit",
                       "dequantize_2bit"),
                "lm_f32": ("flash_fwd_f32", "flash_bwd_f32", "quantize_2bit",
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
    "block_attn_fwd": ("geomx_tpu/ops/block_attention.py:72 _kernel "
                       "(pallas_call :141, flash_block_attention :154)"),
}
# the f32 kernels: the same TPU kernels, in f32
KERNEL_ROWS.update({f"{name}_f32": KERNEL_ROWS[name] for name in (
    "flash_fwd", "flash_bwd", "block_attn_fwd")})
_CODEC = ("cuda", "geomx_tpu_torch/csrc/quantize.cu")
_FLASH = ("cuda", "geomx_tpu_torch/csrc/flash_attention.cu")
# (route, source) of each kernel
_BLOCK = ("cuda", "geomx_tpu_torch/csrc/block_attention.cu")
ROUTES = {"quantize_2bit": _CODEC, "dequantize_2bit": _CODEC,
          "dgc_update": _CODEC, "flash_fwd": _FLASH, "flash_bwd": _FLASH,
          "flash_fwd_f32": _FLASH, "flash_bwd_f32": _FLASH,
          "block_attn_fwd": _BLOCK, "block_attn_fwd_f32": _BLOCK}
# launches a path must make exactly: the DGC update once per key per
# party per step
PATH_EXACT = {"bsc": {"dgc_update": 2 * CNN_KEYS * STEPS}}


def _launch_modules():
    from geomx_tpu_torch.ops.kernels import block_attention as KB
    from geomx_tpu_torch.ops.kernels import flash_attention as FK
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    return C, FK, KB


def reset_all_launches() -> None:
    for mod in _launch_modules():
        mod.reset_launches()


def all_launches() -> dict:
    """Each kernel's launches."""
    out = {}
    for mod in _launch_modules():
        out.update(mod.launches())
    return out


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
    from geomx_tpu_torch.core.platform import resolve_device

    # a float32 reference states its matmul and convolution precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    smi = device_report()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    builds = start_cuda_builds()
    builds["codec"].result()
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    log(f"codec kernels: ptxas: {'; '.join(_ptxas(C.LIB))}")
    err = check_kernels(dev)
    times = time_kernels(dev, CODEC_TIME_SIZES,
                         lambda n: 20 if n >= 10_000_000 else 500)
    sweep = time_lm_sweep(dev)
    log(f"phases 1-2 done in {time.perf_counter() - t0:.1f} s")
    build_s = {name: f.result() for name, f in builds.items()}
    log(f"CUDA sources built with nvcc, in parallel: "
        f"{ {n: round(v, 1) for n, v in build_s.items()} } s")

    flash = check_flash(dev)
    log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")
    block = check_block(dev)
    log(f"phase 3b done in {time.perf_counter() - t0:.1f} s")
    full, refs = check_full_width_step(dev)
    log(f"phase 4 done in {time.perf_counter() - t0:.1f} s")
    sp = check_sp_step(dev, refs)
    del refs
    torch.cuda.empty_cache()
    log(f"phase 4b done in {time.perf_counter() - t0:.1f} s")
    f32_step = check_f32_step(dev)
    log(f"phase 4c done in {time.perf_counter() - t0:.1f} s")

    check_reference()

    geo, launches = {}, {}
    for path, names in PATH_KERNELS.items():
        reset_all_launches()
        geo[path] = (run_lm_georound() if path == "lm" else
                     run_lm_georound(LM_F32_ARGS, LM_F32_STEPS)
                     if path == "lm_f32" else run_georound(path))
        counts = all_launches()
        geo[path]["launches"] = counts
        log(f"main-path launches under {path}: {counts}")
        for name in names:
            assert counts[name] > 0, \
                f"{name} was not launched on the {path} main path"
            launches.setdefault(name, counts[name])
        for name, want in PATH_EXACT.get(path, {}).items():
            assert counts[name] == want, \
                f"{name} launched {counts[name]} times on the {path} " \
                f"path, not {want}"
    # the block kernels' main paths are the sequence-parallel steps of
    # phases 4b (bf16) and 4c (f32)
    launches["block_attn_fwd"] = sp["launches"]["block_attn_fwd"]
    launches["block_attn_fwd_f32"] = \
        f32_step["sp_ring"]["launches"]["block_attn_fwd_f32"]
    assert set(launches) == set(KERNEL_ROWS), "a kernel has no main path"

    rows = []
    main_shape, main_dt = FLASH_MAIN
    for name, replaces in KERNEL_ROWS.items():
        route, source = ROUTES[name]
        if name in err:
            t = dict(times[MAIN_N][name], max_abs_err=err[name],
                     library_ms=None)
            where = {"n": MAIN_N, "device_ms": t["device_ms"]}
            if name in sweep:
                where["lm_push_sweep"] = sweep[name]
            else:
                where.update(inplace_ms=t["inplace_ms"],
                             torch_inplace_ms=t["torch_inplace_ms"])
        elif name.startswith("block_attn_fwd"):
            b_shape, b_dt, b_geo = (BLOCK_MAIN_F32 if name.endswith("_f32")
                                    else BLOCK_MAIN)
            t = block["by_case"][f"{b_shape} {b_dt} {b_geo}"]
            # the error over every shape and geometry checked in its dtype
            t = dict(t, max_abs_err=max(
                r["max_abs_err"] for case, r in block["by_case"].items()
                if b_dt in case))
            where = {"shape": list(b_shape), "dtype": b_dt,
                     "geometry": b_geo, "device_ms": t["device_ms"]}
        else:
            fn, dt = ((name[:-4], "float32") if name.endswith("_f32")
                      else (name, main_dt))
            t = flash["by_shape"][f"{main_shape} {dt}"][fn]
            # the error over every shape checked in its dtype
            t = dict(t, max_abs_err=max(
                r[fn]["max_abs_err"] for shape, r in flash["by_shape"].items()
                if dt in shape))
            mfu_shape, mfu_dt = FLASH_MFU[0], dt
            m = flash["by_shape"][f"{mfu_shape} {mfu_dt}"][fn]
            where = {"shape": list(main_shape), "dtype": dt,
                     "at_mfu_shape": {
                         "shape": list(mfu_shape), "dtype": mfu_dt,
                         **{key: m[key] for key in (
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "tflop_per_s")}}}
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **where})
    report = {"nvidia_smi": smi, "kernels": rows, "build_s": build_s,
              "times_by_size": {str(n): v for n, v in times.items()},
              "lm_push_sweep": sweep,
              "flash": flash, "block": block, "full_width_step": full,
              "sp_step": sp, "f32_step": f32_step,
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
