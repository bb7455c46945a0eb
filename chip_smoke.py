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
   time of a sweep in 5 batches of 20 sweeps (each batch printed; the
   kernels' time is their median: the sweep runs at the host's pace).
   Each kernel's event time must be below its plain version's and below
   the event time of the Triton kernel it replaced, as last measured
   (``TRITON_LAST_MS``): at 401,408 for all three, and on the sweep
   (the median) for quantize and dequantize; beside each gate the
   kernels' time replayed from a ``torch.cuda.CUDAGraph`` capture
   (printed, not gated);
3. flash attention — the CUDA forward and backward kernels (built with
   ``nvcc`` for sm_90a from ``geomx_tpu_torch/csrc/``; bf16 on the
   tensor cores, f32 on them too as three TF32 products of split
   operands (3xTF32)) against their plain versions in bf16 and f32 at
   (B,T,H,Dh) = (8,128,6,64) (the flagship LM), (4,2048,16,128) (the
   MFU config), (2,1000,3,64) (a ragged tail), (1,2047,2,128) (T
   not a multiple of the 128-row tile), (1,1500,24,128) (the same on
   the two-warpgroup tiles, which the bf16 kernels take when 128-row
   tiles fill the SMs), (2,100,3,64) (T below one tile), (1,1,1,64),
   and phase 9's mesh shapes (4,128,3,64) (a dp 2 × tp 2 rank),
   (4,128,6,64) (a dp rank of the party step) and (1,128,6,64) (a
   pipeline microbatch on a dp rank); tolerance f32 1e-4, bf16 2e-2, each times max(1, largest reference
   entry), and each of o, lse, dq, dk, dv within a relative L2 of f32
   1e-4, bf16 1e-2; in bf16 at Dh 128 the kernel's gradients must lie
   nearer the plain backward (which rounds p and ds*scale where JAX's
   kernel does) than the unrounded one; the ptxas log must show no
   spill in a tensor-core kernel; CUDA-event times of kernel, plain version
   and ``scaled_dot_product_attention`` (a yardstick only, never on the
   port's path; kernel and SDPA timed in turns), each beside its bound
   (in f32: three TF32 products at 495 TFLOP/s), and at the LM's and the
   MFU shape in both dtypes each kernel's device time a call
   (``torch.profiler`` over 10 calls: the backward's kernels apart, in
   bf16 the delta pass that zeroes the f32 dQ scratch, the five-product
   dK/dV/dQ kernel and the dQ convert); at the LM's shape the host time
   of each piece of a flash call (``examples/time_flash_launch.py``); the
   f32 forward and
   the f32 backward at the MFU shape must each take less event time than
   its plain version and than the FMA kernels they replaced, as last
   measured (``FMA_LAST_MS``); then the bf16 backward's fixed-order path
   (its dQ partials added in ascending key tiles, taken while
   ``torch.use_deterministic_algorithms(True)``, restored after) at the
   LM's and the MFU shape: 3 runs whose dq, dk and dv are bitwise equal
   (tolerance: none), each within the bf16 gates above against the plain
   backward, its event time in turns with the default path and SDPA and
   its device time by kernel, and whether the default path's dQ differed
   across its own 3 runs (printed, not a gate);
3b. block attention — the CUDA kernel of a ring hop's partial block
   (``geomx_tpu_torch/csrc/block_attention.cu``; bf16 and f32, 3xTF32,
   on the tensor cores) against its plain version in bf16 and f32, for
   the three hop geometries (diagonal ``(0, 0)``, below ``(Tk, 0)``,
   above ``(0, Tq)``), a block straddling the diagonal off the tile grid
   ``(0, Tq//2 + 3)`` and non-causal, at (B,Tq,Tk,H,D) =
   (4,512,512,16,128) (the MFU config's hop at sp = 4: the main path),
   (8,32,32,6,64) (the flagship LM's at sp = 4), a ragged
   (2,250,250,3,64), (1,1,1,1,64), and Tq != Tk both ways
   (2,300,77,3,128), (1,70,400,2,64), and (4,64,64,3,64) (phase 9's
   hop of the flagship on dp 2 × sp 2 × tp 2); ``m``, ``l`` and ``o``
   each within
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
   in f32); then GeoMX's own sync modes through the CNN example's flags
   (2 × 2 + 1, full width, the workers' local Adam): ``--hfa --hfa-k1 2
   --hfa-k2 2`` for 8 steps and ``--esync`` for 4 rounds, each with
   finite losses and final weights on the card, every server on the
   torch backend on ``cuda``, the global server's device optimizer time
   above 0 (the milestone delta added on the card), and the workers of
   each party holding bitwise-equal weights at the end; all four after
   the HFA run's last sync, a WAN round.  HFA pushes weights
   uncompressed, so these runs launch no kernel of the table, and the
   ``codec_host_bytes == 0`` gate is the FSA runs' only (under HFA the
   round is put together on the host);
7. overlap and the launcher — 7a: the flagship LM split by
   ``make_staged`` at ``build_flagship_lm``'s widths (vocab 8192, d 384,
   6 heads, 4 layers, d_ff 1536, seq 128, bf16, ``attn_impl="flash"``,
   an untied head: 13,421,952 parameters): one batch's per-stage
   gradients against autograd through the same stages built with
   ``attn_impl="dense"`` (the plain attention) on the same params and
   tokens, under phase 4's gates (loss within 1e-3 relative, each leaf
   within 5e-2 relative L2), then ``run_worker_overlapped`` on a 2 × 2 +
   1 Simulation with P3, FSA, Adam (the LM geo-round's lr, 3e-3), no
   compression, the torch backend on the
   card, 8 steps (batch 8): the launch counts, set to 0 just before and
   read just after, must be exactly 4 workers × 8 steps × 4 layers × 2
   bf16 flash forwards (the forward walk and each stage's recompute) and
   × 1 bf16 flash backward, and nothing else; each worker's loss falls
   and the four workers' final stage params are bitwise equal; steps/s
   and tokens/s; 7b: ``python -m geomx_tpu_torch.launch`` for every
   role, each its own process over loopback TCP on a free port span, the
   kernels built already: the flagship LM (2 × 2 + 1, ``--workload lm
   --compression mpq --steps 4 --batch 4``, ``GEOMX_MPQ_SIZE_BOUND=
   100000``) — every process exits 0, each worker prints ``steps=4``,
   ``n_params=10276224`` and its tokens/s, ``mpq_bsc``, ``mpq_fp16`` and
   ``wan_tx`` are above 0 and each local server printed DGC update
   launches above 0, one for each of its MPQ selector's BSC picks (its
   codec stage's BSC rung, in its own process);
   then the P3 staged MLP (1 × 1 + 1, ``--p3``): ``pq_overtakes`` above
   0.  A process still running at its deadline is killed and fails the
   phase; each process's output is kept in
   ``chiprun_out/chip_smoke_launch_*.txt``;
8. MoE, the zoo, int8 and the parity harness — 8a: the MoE flagship
   (``build_flagship_lm`` under ``GEOMX_LM_MOE_EXPERTS=4``: top-2 MoE on
   layers 1 and 3, 17,357,184 parameters in 37 keys, capacity 80 a
   group of 128 tokens), one batch (8 × 128): f32 dense attention on the
   card against the same on the CPU from the same params (loss within
   1e-4 relative, each leaf within 1e-3 relative L2, TF32 off), then
   bf16 flash against bf16 dense on the card (1e-3, 5e-2); each pair
   with the reference run's expert choices replayed in the other (top-k
   routing is discontinuous: a last-bit change moves a token to another
   expert and its gradient with it), and a freely routed run beside it
   whose loss holds the same loss gate and whose moved routing
   decisions and capacity drops are printed; 8b: the same model through
   ``examples/lm.py --moe-top-k 2 --experts 4`` (2 × 2 + 1, FSA, Adam
   3e-3, 2bit, bf16 flash, batch 8, 8 steps): exactly 128 bf16 flash
   forwards and backwards, 592 quantize and 592 dequantize launches (37
   keys × 2 local servers a step), WAN bytes the 37 keys' frames (2-bit
   codes up, f32 weights down, the f32 init) plus at most
   ``WAN_META_MAX`` bytes of meta a message, every worker's loss
   falling, steps/s and tokens/s; 8c: the five zoo families at the JAX
   package's default widths (28 × 28 × 1, batch 32, f32) on the card
   against the CPU from the same params (loss 1e-4, each leaf 1e-3
   relative L2) and a finite bf16 step, then ``examples/cnn.py --model
   resnet --compression bsc`` (2 × 2 + 1, 6 steps): exactly one DGC
   update per key per party a step, every worker's loss falling; 8d:
   the zoo MLP trained 30 SGD steps, ``quantize_dense_tree`` +
   ``make_quantized_mlp_apply`` on the card at batch 32 and 5 bitwise
   equal to the CPU's, f32 and int8 accuracy printed; 8e:
   ``run_parity_matrix(steps=20)`` over vanilla, fp16, 2bit, bsc and mpq
   on the card and on the CPU: no config errors, WAN bytes equal (bsc
   and mpq, whose BSC count follows a sampled threshold, within 5 %),
   the codec kernels launched in 2bit, bsc and mpq, each delta against
   vanilla printed;
9. multi-device parallelism on single-controller meshes, every rank on
   the one card (so no figure here measures NVLink or NCCL): 9a, tp / ep
   — the flagship (``build_flagship_lm``'s widths, bf16) through
   ``make_lm_grad_fn(cfg, mesh)`` on ``{"dp": 2, "sp": 1, "tp": 2}`` with
   flash against the single-device dense step (loss 1e-3 relative, each
   leaf 5e-2 relative L2), exactly dp × tp × L = 16 flash forwards and
   16 backwards at (4, 128, 3, 64) and nothing else; the same mesh in
   f32 with dense attention against the single-device f32 step (1e-4,
   1e-3, no launch); ``{"dp": 2, "sp": 2, "tp": 2}`` with ring flash
   (exactly 2 × 2 × 4 × 2² = 64 block launches) against dense; the MoE
   flagship (top-2, 4 experts, 2 a tp rank) on that mesh against
   single-device bf16 dense on the reference run's routing (replayed
   per dp rank), beside a freely routed run whose loss holds 1e-3 and
   whose moved decisions are printed; 3 Adam steps (lr 3e-3) of the tp
   mesh's gradients on the repeated batch, whose loss must fall; 9b,
   the pipeline — ``init_pp_transformer`` + ``make_pp_apply`` on
   ``{"pp": 2, "dp": 2}``, 4 microbatches of batch 8, bf16 flash,
   against the same weights with no pipeline (dense) under phase 4's
   gates, exactly dp × M × L = 32 flash forwards and backwards (the
   schedule skips bubble ticks); then 2 parties, each such a mesh,
   through the port's Simulation (2 × 1 + 1, FSA, SGD 0.1, the torch
   backend, 2 rounds): parties bitwise equal, the loss falling, the
   flash count exact; 9c, dp — ``party_meshes(2, [card] * 4)`` and
   ``make_party_step(make_lm_grad_fn(cfg))`` at batch 8 against the
   single-device full batch under phase 4's gates, exactly dp × L = 8
   flash forwards and backwards; the hips scenario (2 × 1 + 1, FSA,
   Adam 3e-3, 2bit at 0.05, 3 rounds): exactly 35 keys × 2 parties
   quantize and dequantize launches a round, the parties bitwise equal,
   some weights moved;
   ``make_party_step_quantized`` on the same batch, every gradient block
   within 2 · A / 254 of the exact step's (A the larger block absmax of
   the ranks' and the mean's vectors), its int8 wire bytes a step
   printed beside the f32 ring's (from the shapes);
   ``quantized_psum_mean`` and ``_ef`` at k = 2 and 4 bitwise equal on
   the card and the CPU; 9d, the merge backend's mesh rung —
   ``TorchBackend(devices=[card] * 4)`` exact, int8 and int8 with its
   residual on JAX's scenarios (5 pushes summed exactly; the int8 error
   within ``2 k max|p| / 127``; the residual scenario of
   ``test_device_opt.py`` over 40 rounds, so that the residual crosses
   a step: within two steps with it, outside two without), each bitwise
   equal to ``["cpu"] * 4``; then
   a 2 × 2 + 1 geo-round of the flagship's 35 key shapes on the rung
   with its residual (the port's default device slots set to 4 on the
   card, then on the CPU): weights finite and bitwise equal, every
   server's ``merge_devices`` 4 and each big key holding a residual;
10. the JAX package's process-level acceptance suite
   (``geomx_tpu_torch/acceptance.py``) against the launcher on the
   card: every case but phase 7b's two, with its JAX test's topology,
   flags, steps and environment, every role ``--device cuda`` on the
   default merge backend (the torch backend on the card) — TSEngine
   relays, HFA's K2 gate, ESync with a worker slowed 150 ms a step (the
   fast worker gets more local steps, per-step ratio above 2, reach
   ratio below 2), DGT mode 3's 4-bit chunks, the MoE LM over TCP
   (``n_params`` above 1.5M, tokens/s), the MPQ size split on the CNN,
   a worker's ``--join`` in the plain, TSEngine and HFA modes ("joined
   as rank 2", "left cleanly"), the global server SIGKILLed once its
   auto-checkpoint holds a trained round and restarted ("resumed from",
   its restored Adam state on ``cuda:0`` for all 10 keys) or replaced
   at a new address (its restored state held the same), a hot standby
   promoted after its primary's SIGKILL at the worker's round 10 of 120
   (``term=1``, the promoted Adam state on ``cuda:0``, the final loss
   and the losses of rounds 11–30 within 0.5 of an unkilled control
   run's, and the zombie — started with the cluster, let through
   ``--start-gate`` at the promotion — fenced), the same per
   shard on 2 shards with 2 standbys (0.35), the full 1 × 1
   topology, DGT mode 1 over lossy UDP, and two parties on distinct
   loopback addresses; every process exits 0 (the killed and the zombie
   excepted), every worker prints ``steps=N``, every server
   ``merge_backend=torch``, each local server of an MPQ case launched
   the DGC update once for each key its selector sent down BSC; the
   cases whose gates read no wall time run 4 clusters at once, ESync,
   the joins and the failover (whose joiner or zombie must come up
   within the cluster's remaining rounds) one at a time;
   each case's wall printed, each process's output kept in
   ``chiprun_out/chip_smoke_accept_*.txt``;
11. the backend lane (``tests/test_torch_runtime_lane_backend.py``):
   the JAX package's 22 in-process runtime suites (kvstore, failover,
   eviction, sharded merge, recovery, the sharded global tier, the
   codecs, the adaptive WAN, partition, serve, the serving plane, obs,
   the flight recorder, integrity, zero-copy, trace, stress, churn,
   dynamic join, robustness, aux, ESync), rewritten to the port, run in
   one pytest subprocess with ``GEOMX_MERGE_BACKEND=torch`` (every
   server's state on the card) and both device stages pinned on; the
   cases the lane leaves out are its lists' (``LEFT_OUT``, ``TIMING``;
   the ``HEAVY`` 50M-element scale run of ``test_stress.py``, out of
   tier-1 for its host memory, runs here); fails on any failed case or
   a file with no case
   run; prints each file's passed, failed and left-out counts and the
   wall, and keeps the output and the JUnit file under
   ``chiprun_out/chip_smoke_lane*``; in the same subprocess
   ``tests/test_torch_mixed_sync.py`` on the card (MixedSync under 2bit
   and bsc with DC-ASGD and the device Adam, and a 2bit partition
   catch-up, the decoded pushes CUDA tensors), held to the numpy
   backend;
12. the JAX repo's operator scripts and slow cases on the card: 12a
   every ``scripts/run_*.sh`` the scripts lane
   (``tests/test_torch_scripts_lane.py``) marks to run — the ten
   reference configs on ``run_cluster.sh`` (2 × 2 + 1, 6 steps: vanilla,
   bsc, DGT, fp16, HFA, MPQ, mixed sync, two global servers, P3,
   TSEngine), the serve, integrity, partition, churn, postmortem,
   status, shard-chaos and adaptive-WAN tours, the LM over TCP and the
   ESync preset — rewritten onto the port with nothing added (every
   role on the card, the servers on the torch backend), each on its
   own port range, in the background from the end of phase 3b (phases
   4-10 gate no time) until phase 10's timed cases, all but the tours
   of ``SCRIPTS_QUIET`` ``SCRIPT_STREAMS`` at once; after phase 11 the
   quiet tours, the sequences of ``QUIET_STREAMS`` side by side, then
   ``QUIET_ALONE`` alone; each held to
   its own exit code and assertions and every launched cluster to its
   exit lines (every server ``merge_backend=torch``, every worker
   ``steps=``), each local server of the bsc config to 60 DGC updates
   and of the mpq config to one for each BSC pick; each script's wall,
   codec launches and output printed (output and a timeline of its
   processes' log lines in ``chiprun_out/chip_smoke/script_*.txt``);
   12b ``geomx_tpu_torch/examples/trace_demo.py`` (the counterpart of
   ``scripts/run_trace_demo.sh``) on the card, its critical-path report
   printed.  The backend lane's slow mode (the JAX suites' soak and kill
   cases) does not fit the call's time: ``python3 chip_smoke.py
   --slow-lane`` runs it on the card (``run_slow_lane``: each case in
   its own pytest subprocess, ``GEOMX_MERGE_BACKEND=torch``, 0 failed,
   0 skipped).

The three CUDA sources are built with ``nvcc`` at the start, in
parallel; phase 2 checks the codec kernels as soon as the codec library
is built, then waits for every build before it times anything (C6).
``python3 chip_smoke.py --c6-probe`` times phase 2 in the old order
(builds still running, each batch logged with the builds then running)
and again after the join.

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
# the CUDA codec kernels are also checked at sizes off a whole byte and
# at every key size of the flagship LM (lm_key_sizes(), added in
# check_kernels: 384, 49,152, 147,456, 589,824, 3,145,728 — the launched
# LM's MPQ sends those above GEOMX_MPQ_SIZE_BOUND to dgc_update); offsets
# in elements
CODEC_SIZES = tuple(sorted(set(SIZES) | {3, 5}))
CODEC_OFFSETS = (1, 2, 3)
CODEC_TIME_SIZES = (384, MAIN_N, 3_145_728, 50_000_000)
LM_SWEEPS = 20
# the sweep runs at the host's pace: its gate reads the median of this
# many batches of LM_SWEEPS sweeps, so one batch slowed by the host does
# not decide it
SWEEP_BATCHES = 5
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
# tile, one token, and phase 9's mesh shapes: a (dp, tp) rank of the
# dp 2 x tp 2 step, a dp rank of the party step, and a pipeline stage's
# microbatch on a dp rank of pp 2 x dp 2
FLASH_SHAPES = ((8, 128, 6, 64), (4, 2048, 16, 128), (2, 1000, 3, 64),
                (1, 2047, 2, 128), (1, 1500, 24, 128), (2, 100, 3, 64),
                (1, 1, 1, 64), (4, 128, 3, 64), (4, 128, 6, 64),
                (1, 128, 6, 64))
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
# token, Tq != Tk both ways, and phase 9's hop of the flagship on a
# dp 2 x sp 2 x tp 2 mesh (dense and MoE)
BLOCK_SHAPES = ((4, 512, 512, 16, 128), (8, 32, 32, 6, 64),
                (2, 250, 250, 3, 64), (1, 1, 1, 1, 64),
                (2, 300, 77, 3, 128), (1, 70, 400, 2, 64),
                (4, 64, 64, 3, 64))
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
# phase 3, the bf16 backward's fixed-order path: runs a shape
FLASH_ORDERED_RUNS = 3
# phase 6, GeoMX's sync modes through the CNN example's flags: steps
# (HFA) or sync rounds (ESync)
HFA_ARGS = ["--hfa", "--hfa-k1", "2", "--hfa-k2", "2", "--steps", "8"]
ESYNC_ARGS = ["--esync", "--steps", "4"]
SP_MESH = {"dp": 1, "sp": 4, "tp": 1}
# phase 7a: the flagship's stage split at build_flagship_lm's widths,
# with the untied head (8192 x 384) on top of the LM's parameters
STAGED_WIDTHS = dict(vocab=8192, d_model=384, n_heads=6, n_layers=4,
                     d_ff=1536, max_seq=128)
STAGED_PARAMS = 13_421_952
STAGED_STEPS = 8
STAGED_BATCH = 8
# Adam at the LM geo-round's rate (LM_ARGS): the launcher's 0.01
# (scripts/run_p3.sh) made this LM's loss rise over 8 steps on the card
STAGED_LR = float(dict(zip(LM_ARGS[0::2], LM_ARGS[1::2]))["--lr"])
# phase 7b: launched clusters — (parties, workers, launcher flags,
# deadline in seconds); the LM's MPQ size bound is the JAX acceptance
# matrix's (GEOMX_MPQ_SIZE_BOUND=100000)
LAUNCHED = {
    "lm_mpq": (2, 2, ["--workload", "lm", "--compression", "mpq",
                      "--steps", "4", "--batch", "4"], 300),
    "p3": (1, 1, ["--p3", "--steps", "3"], 180)}
SP_ADAM_STEPS = 3
# phase 8a-b: the MoE flagship — build_flagship_lm's widths under
# GEOMX_LM_MOE_EXPERTS=4 (top-2 MoE on layers 1 and 3), and the same
# model through examples/lm.py for the geo-round
MOE_ENV = {"GEOMX_LM_MOE_EXPERTS": "4", "GEOMX_LM_MOE_TOP_K": "2"}
MOE_PARAMS = 17_357_184
MOE_KEYS = 37
MOE_CAPACITY = 80              # ceil(128 tokens × 2 × 1.25 / 4) a group
MOE_BATCH = 8
MOE_F32_LOSS_TOL = 1e-4        # card against CPU, f32, TF32 off
MOE_F32_GRAD_TOL = 1e-3
MOE_LM_ARGS = LM_ARGS + ["--moe-top-k", "2", "--experts", "4"]
# a WAN message's meta (64 bytes and its pickled header) is ~367 bytes
# for the LM's keys (CPU runs of examples/lm.py and PR 10's 87,373,600
# bytes a step for the 35-key LM); the gate bounds it at this
WAN_META_MAX = 512
# phase 8c-e
ZOO_FAMILIES = ("mlp", "vgg", "mobilenet", "squeezenet", "resnet")
ZOO_BATCH = 32
ZOO_STEPS = 6
INT8_BATCHES = (32, 5)         # 5: fewer rows than torch._int_mm takes
PARITY_STEPS = 20
PARITY_NAMES = ("vanilla", "fp16", "2bit", "bsc", "mpq")
# configs whose frames hold a count that follows the values (BSC's
# sampled threshold): their WAN bytes are held within a relative bound
PARITY_VALUE_SIZED = ("bsc", "mpq")
PARITY_BSC_BYTES_RTOL = 0.05
# the table's kernels each parity config must launch
PARITY_KERNELS = {"2bit": ("quantize_2bit", "dequantize_2bit"),
                  "bsc": ("dgc_update",), "mpq": ("dgc_update",)}
# phase 9: meshes whose ranks all live on the one card
TP_MESH = {"dp": 2, "sp": 1, "tp": 2}
TP_SP_MESH = {"dp": 2, "sp": 2, "tp": 2}
TP_BATCH = 8
TP_ADAM_STEPS = 3
PP_MESH = {"pp": 2, "dp": 2}
PP_MICROBATCHES = 4
PP_BATCH = 8
PP_HIPS_ROUNDS = 2
PP_HIPS_LR = 0.1               # the JAX dryrun's pp-hips rate
DP_PARTIES = 2
DP_DEVICES = 4                 # party_meshes(2, [card] * 4): 2 ranks each
DP_HIPS_ROUNDS = 3
DP_HIPS_THRESHOLD = 0.05       # the JAX acceptance matrix's 2bit value
QAR_RANKS = (2, 4)
QAR_N = 1_000_003
# the int8 party step's bound allows this many f32 ulps of a block's
# absmax beside its two half steps: the exact step and the int8 one each
# round their own sums (on an NVIDIA H100 the flagship's worst block
# reached 0.997 of 2/254)
QAR_ROUNDING_ULPS = 4
MERGE_SLOTS = 4
# rounds of the residual scenario: a slot's residual grows by 0.1 a
# round against a half step of 1.575, so it first crosses a step in
# round 16; at 40 the wanted 16.0 lies more than two steps from the 0
# that the int8 rung gives without its residual
MERGE_EF_ROUNDS = 40
# phase 11: the backend lane's pytest subprocess time limit, seconds, and
# the port's MixedSync tests it runs beside the lane's files
LANE_TIMEOUT_S = 600
MIXED_SYNC_TESTS = "tests/test_torch_mixed_sync.py"
# phase 10: clusters of the untimed acceptance cases run at once
ACCEPT_PARALLEL = 4
# phase 12: scripts run at once on disjoint port ranges, a script's time
# limit (its own waits are its own), a slow case's limit, and each
# script's wall on the card (the pool's order)
SCRIPT_STREAMS = 3
# tours that failed beside other clusters on the card: after phase 11,
# QUIET_STREAMS (each a sequence) side by side, then the tours of
# QUIET_ALONE one at a time with nothing else running
QUIET_STREAMS = (("run_serve_demo.sh", "run_adaptive_demo.sh"),
                 ("run_status_demo.sh", "run_postmortem_demo.sh"))
QUIET_ALONE = ("run_churn_demo.sh",)
SCRIPTS_QUIET = tuple(n for seq in QUIET_STREAMS for n in seq) + QUIET_ALONE
SCRIPT_TIMEOUT_S = 420
SLOW_CASE_TIMEOUT_S = 300
SCRIPT_WALL_HINT_S = {      # each alone on an H100 80GB HBM3
    "run_serve_demo.sh": 154.8, "run_churn_demo.sh": 100.0,
    "run_postmortem_demo.sh": 80.8, "run_integrity_demo.sh": 77.2,
    "run_status_demo.sh": 71.1, "run_partition_demo.sh": 61.7,
    "run_p3.sh": 32.7, "run_multi_gps.sh": 28.0}


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
    for n in sorted(set(CODEC_SIZES) | set(lm_key_sizes())):
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


def _in_turns_all(fns: dict, iters: int) -> dict:
    """Event times (ms) of several versions of one function, run in
    order and then in reverse order (first, second, second, first for
    two): the mean of each one's two runs."""
    first = {n: _time_ms(f, iters) for n, f in fns.items()}
    second = {n: _time_ms(fns[n], iters) for n in reversed(list(fns))}
    return {n: (first[n] + second[n]) / 2 for n in fns}


def _in_turns(first, second, iters: int) -> tuple:
    """:func:`_in_turns_all` of two versions: ``(first's, second's)``."""
    t = _in_turns_all({0: first, 1: second}, iters)
    return t[0], t[1]


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


def _nvcc_running(builds) -> list:
    """The CUDA builds still running (``nvcc`` on the host's cores)."""
    return sorted(n for n, f in (builds or {}).items() if not f.done())


def _graph_ms(fn, iters: int) -> float:
    """CUDA-event time (ms) of one replay of ``fn`` captured in a
    ``torch.cuda.CUDAGraph``: the kernels without the host's launch
    path.  The capture calls the wrappers once more; their launch counts
    are not read here."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                    # warm: allocator and libraries
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    ms = _time_ms(g.replay, iters)
    del g
    return ms


def time_kernels(dev, sizes, iters_for, builds=None, gate=True) -> dict:
    """At each size: CUDA-event times of the CUDA quantize, dequantize
    and DGC update (out of place and in place) and of their plain
    versions, and of the three in-place torch operations of the DGC
    update, warm in L2 where the tensors fit (the codec reads the
    accumulator the merge just wrote); then each kernel's device time a
    call (one profiler window, 10 calls of each).  At ``MAIN_N`` also
    each kernel's time replayed from a CUDA graph, printed beside its
    gate.  ``builds``: the CUDA builds' futures, whose state is logged
    at each size (C6); ``gate=False`` (the C6 probe) logs the gates
    without asserting them."""
    import torch

    from geomx_tpu_torch.ops import quantize as Q
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    lay = "consecutive"
    out = {}
    for n in sizes:
        g, r = _inputs(n, dev, seed=7)
        v = r * 3.0
        packed, _ = C.quantize_2bit(g, r, THRESHOLD, lay)
        running = _nvcc_running(builds)
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
                         "plain_ms": _time_ms(plain, it),
                         "nvcc_running": running}
                  for name, (call, plain) in calls.items()}
        if n == MAIN_N:
            for name, (call, _) in calls.items():
                out[n][name]["graph_ms"] = _graph_ms(call, it)

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
                f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})"
                + (f"; CUDA graph {rec['graph_ms']:.4f} ms"
                   if "graph_ms" in rec else "")
                + f"; nvcc running: {rec['nvcc_running'] or 'none'}")
        del g, r, v, vv, uu, packed
        torch.cuda.empty_cache()
    for name, rec in out[MAIN_N].items():
        log(f"gate {name} n={MAIN_N}: cuda {rec['ms']:.4f} ms (CUDA graph "
            f"{rec['graph_ms']:.4f} ms, not gated) against plain "
            f"{rec['plain_ms']:.4f} and {TRITON_LAST_MS[name]:.4f} ms")
        if gate:
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


def time_lm_sweep(dev, builds=None, gate=True) -> dict:
    """One party's push of the flagship LM through the codec: its 35
    keys in model order, one quantize each, then one dequantize each of
    the codes; CUDA-event time of a sweep, of the CUDA kernels as the
    median of ``SWEEP_BATCHES`` batches of ``LM_SWEEPS`` sweeps (each
    batch printed with the CUDA builds still running when it started,
    C6), of the plain versions over ``LM_SWEEPS``, and of one sweep
    replayed from a CUDA graph (printed beside the gate, not gated).
    ``gate=False`` (the C6 probe) logs the gate without asserting it."""
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
        batches, running = [], []
        for _ in range(SWEEP_BATCHES):
            running.append(_nvcc_running(builds))
            batches.append(_time_ms(sweep, LM_SWEEPS))
        ms = float(np.median(batches))
        bound = sum(_bound_ms(name, n)[0] for n in sizes)
        out[name] = {"ms": ms, "batches_ms": batches,
                     "batches_nvcc_running": running,
                     "plain_ms": _time_ms(plain, LM_SWEEPS),
                     "graph_ms": _graph_ms(sweep, LM_SWEEPS),
                     "bound_ms": bound}
        log(f"LM push sweep ({len(sizes)} keys, {sum(sizes)} elements) "
            f"{name}: cuda batches "
            f"{', '.join(f'{b:.4f}' for b in batches)} ms (nvcc running: "
            f"{', '.join('+'.join(r) or 'none' for r in running)}), median "
            f"{ms:.4f} ms against the gate "
            f"{TRITON_LAST_SWEEP_MS[name]:.4f} ms; CUDA graph "
            f"{out[name]['graph_ms']:.4f} ms (not gated); plain "
            f"{out[name]['plain_ms']:.4f} ms, bound {bound:.5f} ms")
        out[name]["under_gate"] = ms < min(out[name]["plain_ms"],
                                           TRITON_LAST_SWEEP_MS[name])
        if gate:
            _below_gates(f"LM push sweep {name}", ms,
                         out[name]["plain_ms"], TRITON_LAST_SWEEP_MS[name])
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
            # the plain version takes 10-20 ms a call at the MFU shape;
            # kernel and SDPA in turns (kernel, SDPA, SDPA, kernel): at the
            # LM's shape events move with the host between calls
            it, plain_it = 50, (5 if shape[1] >= 2048 else 50)
            fwd_ms, fwd_lib = _in_turns(
                lambda: FK.flash_fwd(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, is_causal=True), it)
            bwd_ms, bwd_lib = _in_turns(
                lambda: FK.flash_bwd(q, k, v, o, lse, do, scale),
                lambda: torch.autograd.grad(
                    so, (sq, sk, sv), sdo, retain_graph=True), it)
            times = {
                "flash_fwd": (fwd_ms, _time_ms(
                    lambda: FA.flash_attention_ref(q, k, v, scale),
                    plain_it), fwd_lib),
                "flash_bwd": (bwd_ms, _time_ms(
                    lambda: FA.flash_attention_bwd_ref(
                        q, k, v, o, lse, do, scale), plain_it), bwd_lib),
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
            if shape == FLASH_MAIN[0]:
                rec["launch_path_us"] = _flash_launch_path(
                    q, k, v, o, lse, do, scale)
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


def check_flash_ordered(dev) -> dict:
    """The bf16 backward's fixed-order path against its plain version
    and against itself, at the LM's and the MFU shape."""
    import torch
    import torch.nn.functional as F

    from geomx_tpu_torch.ops import flash_attention as FA
    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    was = torch.are_deterministic_algorithms_enabled()

    def ordered_bwd(*args):
        torch.use_deterministic_algorithms(True)
        try:
            return FK.flash_bwd(*args)
        finally:
            torch.use_deterministic_algorithms(was)

    def bits(t):
        return t.view(torch.int16)

    out = {}
    for shape in (FLASH_MAIN[0], FLASH_MFU[0]):
        rng = np.random.default_rng(sum(shape))
        q, k, v, do = (torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
            .to(dev, torch.bfloat16) for _ in range(4))
        scale = 1.0 / math.sqrt(shape[-1])
        o, lse = FK.flash_fwd(q, k, v, scale)
        args = (q, k, v, o, lse, do, scale)
        refs = FA.flash_attention_bwd_ref(*args)
        n0 = FK.launches()["flash_bwd_ordered"]
        fixed = [ordered_bwd(*args) for _ in range(FLASH_ORDERED_RUNS)]
        default = [FK.flash_bwd(*args) for _ in range(FLASH_ORDERED_RUNS)]
        torch.cuda.synchronize()
        assert FK.launches()["flash_bwd_ordered"] - n0 == \
            FLASH_ORDERED_RUNS, "the fixed-order path was not taken"
        for run in fixed[1:]:
            for g, g0, name in zip(run, fixed[0], ("dq", "dk", "dv")):
                assert torch.equal(bits(g), bits(g0)), \
                    f"fixed-order bf16 backward {shape}: {name} moved"
        default_dq_same = all(torch.equal(bits(r[0]), bits(default[0][0]))
                              for r in default[1:])
        err = max(_max_abs(g, r) for g, r in zip(fixed[0], refs))
        tol = FLASH_TOL["bfloat16"] * max(
            1.0, max(float(r.float().abs().max()) for r in refs))
        assert err <= tol, f"fixed-order {shape}: max abs err {err} > {tol}"
        rel = {n: _rel_l2(g, r) for n, g, r in zip(("dq", "dk", "dv"),
                                                    fixed[0], refs)}
        assert max(rel.values()) <= FLASH_REL_L2["bfloat16"], \
            f"fixed-order {shape}: relative L2 {rel}"
        if shape[-1] == 128:
            unr = _flash_bwd_unrounded(*args)
            for n, g, u in zip(("dq", "dk", "dv"), fixed[0], unr):
                assert rel[n] < _rel_l2(g, u), \
                    f"fixed-order {shape} {n}: not nearer the rounding " \
                    "plain backward"
            del unr
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        sdo = do.transpose(1, 2).contiguous()
        times = _in_turns_all({
            "ordered": lambda: ordered_bwd(*args),
            "default": lambda: FK.flash_bwd(*args),
            "sdpa": lambda: torch.autograd.grad(so, (sq, sk, sv), sdo,
                                                retain_graph=True)}, 50)
        device = {name: {n: t / 10 for n, t in _device_ms_by_kernel(
            lambda: [fn(*args) for _ in range(10)]).items()}
            for name, fn in (("ordered", ordered_bwd),
                             ("default", FK.flash_bwd))}
        out[str(shape)] = {
            "default_dq_bitwise_equal": default_dq_same,
            "max_abs_err": err, "tol": tol, "rel_l2": rel,
            "ms": times["ordered"], "default_ms": times["default"],
            "sdpa_ms": times["sdpa"], "device_ms_by_kernel": device}
        log(f"flash_bwd fixed order {shape} bf16: {FLASH_ORDERED_RUNS} runs "
            f"bitwise equal; max abs err {err:.3g} (tol {tol:.3g}), rel L2 "
            + "/".join(f"{rel[n]:.3g}" for n in rel)
            + f"; {times['ordered']:.4f} ms against the default path's "
            f"{times['default']:.4f} and SDPA's {times['sdpa']:.4f} "
            f"(in turns); default-path dQ bitwise equal across "
            f"{FLASH_ORDERED_RUNS} runs: {default_dq_same}")
        for name, by in device.items():
            log(f"flash_bwd {name} {shape} bf16: device ms by kernel "
                + "; ".join(f"{n[:40]} {t:.4f}" for n, t in by.items()))
        del q, k, v, do, o, lse, refs, fixed, default, sq, sk, sv, so, sdo
        torch.cuda.empty_cache()
    assert torch.are_deterministic_algorithms_enabled() == was
    return out


def check_config_deterministic(dev) -> dict:
    """A worker's ``Config.deterministic`` step context
    (``training.step_order``), with PyTorch's global switch off: two
    autograd backwards of the bf16 flash call at the MFU shape take the
    fixed-order kernel (``flash_bwd_ordered`` counted twice, the default
    path not at all) and give bitwise equal dQ, equal to the ordered
    kernel called directly."""
    from types import SimpleNamespace

    import torch

    from geomx_tpu_torch.core.config import Config
    from geomx_tpu_torch.ops import flash_attention as FA
    from geomx_tpu_torch.ops.kernels import flash_attention as FK
    from geomx_tpu_torch.training import step_order

    assert not torch.are_deterministic_algorithms_enabled()
    shape = FLASH_MFU[0]
    rng = np.random.default_rng(sum(shape) + 1)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
        .to(dev, torch.bfloat16) for _ in range(4))
    kv = SimpleNamespace(config=Config(deterministic=True))
    before = FK.launches()
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with step_order(kv):
            o = FA.flash_attention(*leaves)
        runs.append(torch.autograd.grad(o, leaves, do))
    torch.cuda.synchronize()
    after = FK.launches()
    ordered = after["flash_bwd_ordered"] - before["flash_bwd_ordered"]
    default = after["flash_bwd"] - before["flash_bwd"]
    assert (ordered, default) == (2, 0), \
        f"Config.deterministic took {ordered} ordered, {default} default"
    same = torch.equal(runs[0][0].view(torch.int16),
                       runs[1][0].view(torch.int16))
    assert same, "Config.deterministic: dQ moved between two runs"
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = FK.flash_fwd(q, k, v, scale)
    direct = FK.flash_bwd(q, k, v, o, lse, do, scale, ordered=True)[0]
    assert torch.equal(direct.view(torch.int16),
                       runs[0][0].view(torch.int16)), \
        "Config.deterministic's dQ is not the ordered kernel's"
    log(f"Config.deterministic {shape} bf16, global switch off: 2 "
        f"backwards through flash_bwd_ordered, dQ bitwise equal")
    del q, k, v, do, runs, o, lse, direct
    torch.cuda.empty_cache()
    return {"shape": list(shape), "ordered_launches": ordered,
            "default_launches": default, "dq_bitwise_equal": same}


def _flash_launch_path(q, k, v, o, lse, do, scale) -> dict:
    """Host time (µs) of one flash call's pieces at the LM's shape
    (``examples/time_flash_launch.py``, 500 calls a piece): the whole
    call, the wrapper's checks, allocations, stream handle, counter, the
    ``ctypes`` call; inside the library a tensor map encoded, the
    shared-memory attribute set, ``cudaGetDevice``, ``cudaGetLastError``."""
    from geomx_tpu_torch.examples import time_flash_launch as TL

    out = {"library": TL.c_pieces(q, 1000)}
    for fn, parts in TL.pieces(q, k, v, o, lse, do, scale).items():
        out[fn] = {p: TL._host_us(f, 500) for p, f in parts.items()}
    dt = str(q.dtype).replace("torch.", "")
    for fn in ("library", "flash_fwd", "flash_bwd"):
        log(f"flash launch path {tuple(q.shape)} {dt} {fn} (host us): "
            + "; ".join(f"{p} {t:.2f}" for p, t in out[fn].items()))
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
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation

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

    def setup(kv, p, r):
        if r == 0:
            if p == 0:
                kv.set_optimizer({"type": "sgd", "lr": 0.25})
            kv.set_gradient_compression(
                {"type": compression, "ratio": 0.01, "momentum": 0.5,
                 "threshold": 0.5})
        return [((s, 2 * p + r), None) for s in range(3)]

    try:
        return _fsa_workers(sim, init, grad_fn, setup)
    finally:
        sim.shutdown()


def _fsa_workers(sim, init: dict, grad_fn, setup) -> list:
    """Run the 2 × 2 workers of ``sim`` in threads: ``setup(kv, p, r)``
    configures worker (p, r)'s kvstore and returns its 3 batches, then
    ``run_worker`` takes 3 steps from ``init``.  Returns the final
    weights' bytes, which every worker must hold alike."""
    import threading

    from geomx_tpu_torch.training import run_worker

    out, errors = {}, []

    def worker(p, r):
        try:
            kv = sim.worker(p, r)
            data = setup(kv, p, r)
            kv.barrier()
            res: dict = {}
            run_worker(kv, init, grad_fn, data, 3, params_out=res)
            out[(p, r)] = [t.cpu().numpy().tobytes()
                           for t in res["params"].values()]
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(p, r), daemon=True)
          for p in range(2) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
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


def run_sync_mode(extra: list) -> dict:
    """The CNN example under HFA or ESync (``extra``: its flags), 2 × 2
    + 1, full width, the workers' local Adam, on the card."""
    import torch

    from geomx_tpu_torch.examples.cnn import build_parser, train

    args = build_parser().parse_args(
        ["--parties", "2", "--workers", "2", "--global-servers", "1",
         "--batch", "32", "--optimizer", "adam", "--lr", "0.001",
         "--seed", "0", *extra])
    mode = "esync" if args.esync else "hfa"
    stamps = []
    out = train(args, log=lambda msg: stamps.append(time.perf_counter()))
    hist = out["histories"]
    assert len(hist) == 4 and all(len(h) >= args.steps
                                  for h in hist.values()), \
        f"{mode}: a worker did not finish its steps"
    assert all(math.isfinite(l) for h in hist.values() for l, _ in h), \
        f"{mode}: non-finite loss"
    final = out["final_params"]
    assert set(final) == {(p, r) for p in range(2) for r in range(2)}
    for params in final.values():
        assert all(t.is_cuda for t in params.values()), \
            f"{mode}: final weights are not on the card"
        assert sum(t.numel() for t in params.values()) == 429_258
        assert all(bool(torch.isfinite(t).all()) for t in params.values())
    bits = {w: [t.cpu().numpy().tobytes() for t in params.values()]
            for w, params in final.items()}
    for p in range(2):
        assert bits[(p, 0)] == bits[(p, 1)], \
            f"{mode}: party {p}'s workers hold different weights"
    all_equal = bits[(0, 0)] == bits[(1, 0)]
    if mode == "hfa":
        assert all_equal, "hfa: the parties differ after the WAN round"
    servers = out["sim_stats"]["local"] + out["sim_stats"]["global"]
    for s in servers:
        assert s["merge_backend"] == "torch" and s["merge_device"] == "cuda"
    g = out["sim_stats"]["global"][0]
    assert g["opt_device_ms"] > 0, \
        f"{mode}: the global server added no milestone delta on the card"
    steps = args.steps        # HFA: steps; ESync: sync rounds
    rate = ((len(stamps) - 3) / (stamps[-1] - stamps[2])
            if len(stamps) > 3 else None)
    wan = out["wan"]["wan_send_bytes"] / steps
    local_steps = {f"{p},{r}": len(h) for (p, r), h in sorted(hist.items())}
    first = [h[0][0] for h in hist.values()]
    last = [h[-1][0] for h in hist.values()]
    log(f"sync mode {mode}: {steps} {'steps' if mode == 'hfa' else 'rounds'}"
        f", local steps by worker {local_steps}, loss {np.mean(first):.4f} "
        f"-> {np.mean(last):.4f}, "
        + (f"{rate:.2f} {'steps' if mode == 'hfa' else 'rounds'}/s steady "
           "(worker 0,0), " if rate else "")
        + f"{out['seconds']:.2f} s total, WAN bytes/"
        f"{'step' if mode == 'hfa' else 'round'} {wan:.0f}; parties "
        f"bitwise equal: {all_equal}; global opt_device_ms "
        f"{g['opt_device_ms']}")
    return {"mode": mode, "steps": steps, "per_s_steady": rate,
            "wan_bytes_per_step": wan, "local_steps": local_steps,
            "parties_bitwise_equal": all_equal,
            "loss_first": float(np.mean(first)),
            "loss_last": float(np.mean(last)), "seconds": out["seconds"],
            "global_opt_device_ms": g["opt_device_ms"]}


def run_lm_georound(argv=LM_ARGS, steps: int = LM_STEPS,
                    n_params: int = LM_PARAMS, keep_params: bool = False,
                    make_iter=None) -> dict:
    """The flagship LM through ``geomx_tpu_torch.examples.lm``
    (``keep_params``: the record also holds the final ``params`` and the
    ``cfg``; ``make_iter``: the workers' batches, as ``train`` takes
    it)."""
    import torch

    from geomx_tpu_torch.examples.lm import build_parser, train

    args = build_parser().parse_args(argv)
    stamps = []
    out = train(args, log=lambda msg: stamps.append(time.perf_counter()),
                make_iter=make_iter)
    losses = [l for h in out["histories"].values() for l, _ in h]
    assert len(losses) == 4 * steps, "a worker did not finish its steps"
    assert all(math.isfinite(x) for x in losses), "non-finite loss"
    assert out["n_params"] == n_params, out["n_params"]
    params = out["params"]
    assert params is not None and all(t.is_cuda for t in params.values()), \
        "final weights are not on the card"
    assert sum(t.numel() for t in params.values()) == n_params
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
    log(f"geo-round lm{' moe' if args.moe_top_k else ''} "
        f"{args.compression} {args.compute_dtype}: {steps} steps, "
        f"{out['n_params']} params, loss {np.mean(first):.4f} -> "
        f"{np.mean(last):.4f}, "
        + (f"{steady:.3f} steps/s steady ({steady * tokens_per_step:.0f} "
           f"tokens/s), " if steady else "")
        + f"{out['seconds']:.2f} s total, WAN bytes/step {wan:.0f}")
    return {"steps_per_s": steady,
            "tokens_per_s": steady and steady * tokens_per_step,
            "wan_bytes_per_step": wan, "n_params": out["n_params"],
            **({"params": params, "cfg": out["cfg"]} if keep_params
               else {}),
            "key_sizes": [t.numel() for t in params.values()],
            "histories": {f"{p},{r}": [l for l, _ in h] for (p, r), h in
                          sorted(out["histories"].items())},
            "loss_first": float(np.mean(first)),
            "loss_last": float(np.mean(last)), "seconds": out["seconds"]}


# ---- phase 7: the staged loop and the launcher ---------------------------

def _staged_lm_loss(logits, tokens):
    """The LM objective and next-token accuracy, for ``StagedModel``."""
    from geomx_tpu_torch.models.transformer import token_cross_entropy

    acc = (logits[:, :-1].argmax(-1) == tokens[:, 1:].long()).float().mean()
    return token_cross_entropy(logits, tokens), acc


def check_staged_lm(dev) -> dict:
    """7a: the flagship LM split by ``make_staged`` (bf16, flash, full
    widths, untied head) — per-stage gradients of one batch against
    autograd through the composed stages with dense attention (the
    plain version of flash) on the same params, under phase 4's bf16
    gates — then ``run_worker_overlapped`` on a 2 × 2 + 1 P3 Simulation
    (FSA, Adam at ``STAGED_LR``, no compression, the torch backend on
    the card) for
    ``STAGED_STEPS`` steps: exact flash launch counts, each worker's loss
    falling, the four workers' final stage params bitwise equal."""
    import dataclasses
    import threading

    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.data import TokenIterator, synthetic_lm
    from geomx_tpu_torch.kvstore import Simulation
    from geomx_tpu_torch.models.transformer import (TransformerConfig,
                                                    make_staged)
    from geomx_tpu_torch.overlap import StagedModel, run_worker_overlapped

    cfg = TransformerConfig(**STAGED_WIDTHS, compute_dtype=torch.bfloat16,
                            attn_impl="flash")
    fns, params = make_staged(cfg, torch.Generator().manual_seed(0),
                              device=dev)
    n_params = sum(t.numel() for p in params for t in p.values())
    assert n_params == STAGED_PARAMS, n_params
    data = synthetic_lm(n=512, seq=cfg.max_seq, vocab=cfg.vocab, seed=0)

    # per-stage gradients against autograd through the composed stages
    # of the plain (dense) attention: its params are dropped, the flash
    # stages' are used
    dense_fns, _ = make_staged(dataclasses.replace(cfg, attn_impl="dense"),
                               torch.Generator().manual_seed(0), "cpu")
    x = torch.as_tensor(data[:STAGED_BATCH], device=dev)
    model = StagedModel(fns, _staged_lm_loss)
    logits, residuals = model.forward(params, x)
    loss, _acc, g_logits = model.loss_and_logit_grad(logits, x)
    got = {}
    model.backward(residuals, g_logits, lambda i, g: got.__setitem__(i, g))
    leaves = [{k: t.detach().requires_grad_(True) for k, t in p.items()}
              for p in params]
    h = x
    for f, p in zip(dense_fns, leaves):
        h = f(p, h)
    ref_loss, _ = _staged_lm_loss(h, x)
    flat = [t for p in leaves for t in p.values()]
    ref = torch.autograd.grad(ref_loss, flat)
    ref_loss = ref_loss.detach()
    names = [f"{i}.{k}" for i, p in enumerate(params) for k in p]
    rel_loss, rel = _rel_diffs(
        float(loss), {f"{i}.{k}": got[i][k] for i, p in enumerate(params)
                      for k in p},
        float(ref_loss), dict(zip(names, ref)))
    worst = max(rel, key=rel.get)
    log(f"staged LM ({n_params} params, bf16, flash): loss "
        f"{float(loss):.6f} vs composed dense autograd "
        f"{float(ref_loss):.6f} "
        f"(rel {rel_loss:.2e}); worst leaf {worst} rel L2 {rel[worst]:.2e}")
    assert rel_loss < 1e-3, f"staged loss off by {rel_loss:.2e}"
    assert rel[worst] < 5e-2, f"staged grad {worst} off by {rel[worst]:.2e}"
    del logits, residuals, g_logits, got, leaves, h, ref

    # the overlapped loop on a P3 Simulation
    sim = Simulation(Config(
        topology=Topology(num_parties=2, workers_per_party=2,
                          num_global_servers=1),
        enable_p3=True, sync_global_mode=True, merge_backend="torch"))
    hist, final, errors, stamps = {}, {}, [], []
    lock = threading.Lock()

    def worker(party, rank, widx):
        try:
            kv = sim.worker(party, rank)
            if party == 0 and rank == 0:
                kv.set_optimizer({"type": "adam", "lr": STAGED_LR})
            kv.barrier()
            cap = {}
            h = run_worker_overlapped(
                kv, StagedModel(fns, _staged_lm_loss), params,
                TokenIterator(data, STAGED_BATCH, widx, 4), STAGED_STEPS,
                log_fn=(lambda *a: stamps.append(time.perf_counter()))
                if widx == 0 else None, params_out=cap)
            with lock:
                hist[(party, rank)], final[(party, rank)] = h, cap["params"]
        except BaseException as e:  # raised below, after the join
            with lock:
                errors.append(e)

    try:
        reset_all_launches()
        threads = [threading.Thread(target=worker, args=(p, r, 2 * p + r),
                                    daemon=True)
                   for p in range(2) for r in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        counts = all_launches()
        assert not any(t.is_alive() for t in threads), "a worker hung"
        if errors:
            raise errors[0]
        stats = [s.stats() for s in sim.local_servers + sim.global_servers]
    finally:
        sim.shutdown()
    for st in stats:
        assert st["merge_backend"] == "torch" and st["merge_device"] == "cuda"
    want = {"flash_fwd": 4 * STAGED_STEPS * cfg.n_layers * 2,
            "flash_bwd": 4 * STAGED_STEPS * cfg.n_layers}
    log(f"staged LM launches over {STAGED_STEPS} steps: {counts}")
    for name, n in counts.items():
        assert n == want.get(name, 0), \
            f"{name} launched {n} times on the staged path, not " \
            f"{want.get(name, 0)}"
    for w, h in sorted(hist.items()):
        assert len(h) == STAGED_STEPS and all(math.isfinite(l) for l, _ in h)
        assert h[-1][0] < h[0][0], f"worker {w}'s loss did not fall: {h}"
    bits = {w: [t.cpu().numpy().tobytes() for p in ps for t in p.values()]
            for w, ps in final.items()}
    assert len(bits) == 4 and all(b == bits[(0, 0)] for b in bits.values()), \
        "the workers' final stage params differ"
    steady = (len(stamps) - 3) / (stamps[-1] - stamps[2])
    tokens = steady * 4 * STAGED_BATCH * cfg.max_seq
    first = [h[0][0] for h in hist.values()]
    last = [h[-1][0] for h in hist.values()]
    log(f"staged LM P3 geo-round: {STAGED_STEPS} steps, loss "
        f"{np.mean(first):.4f} -> {np.mean(last):.4f} (worker 0,0: "
        f"{', '.join(f'{l:.4f}' for l, _ in hist[(0, 0)])}), {steady:.3f} steps/s "
        f"steady ({tokens:.0f} tokens/s), {seconds:.2f} s total; workers "
        "bitwise equal")
    return {"n_params": n_params, "loss_rel": rel_loss,
            "grad_rel_l2_worst": [worst, rel[worst]],
            "steps_per_s": steady, "tokens_per_s": tokens,
            "seconds": seconds, "loss_first": float(np.mean(first)),
            "loss_last": float(np.mean(last)), "launches": counts}


def _stat(outs: dict, pattern: str, roles=None) -> int:
    """The sum of an integer exit observable over the roles' outputs."""
    import re

    return sum(int(m.group(1)) for r, (_, out) in outs.items()
               if roles is None or r in roles
               for m in re.finditer(pattern, out))


def run_launched_clusters() -> dict:
    """7b: the launcher, every role its own process over loopback TCP on
    this card: the flagship LM under MPQ (2 × 2 + 1), then the P3
    staged MLP (1 × 1 + 1).  The kernels are built already; a child
    only loads them."""
    import re

    from geomx_tpu_torch.launch import run_local_cluster
    from geomx_tpu_torch.ops.kernels import flash_attention as FK
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    assert not C.LIB.stale() and not FK.LIB.stale(), \
        "a kernel library is not built: a child process would build it"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GEOMX_MPQ_SIZE_BOUND="100000")
    out = {}
    for name, (parties, workers, args, deadline) in LAUNCHED.items():
        t0 = time.perf_counter()
        outs = run_local_cluster(parties, workers, args, env=env,
                                 deadline_s=deadline, cwd=root)
        seconds = time.perf_counter() - t0
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               f"chip_smoke_launch_{name}.txt"), "w") as f:
            for r, (rc, text) in outs.items():
                f.write(f"===== {r} rc={rc}\n{text}\n")
        bad = {r: (rc, text[-1500:]) for r, (rc, text) in outs.items()
               if rc != 0}
        assert not bad, f"launched {name}: a process failed or hung: {bad}"
        workers_out = {r: text for r, (_, text) in outs.items()
                       if r.startswith("worker")}
        steps = args[args.index("--steps") + 1]
        for r, text in workers_out.items():
            assert f"steps={steps} " in text, f"{r}: {text[-800:]}"
        rec = {"seconds": seconds, "processes": len(outs)}
        if name == "lm_mpq":
            tps = {}
            for r, text in workers_out.items():
                assert f"n_params={LM_PARAMS} " in text, text[-800:]
                tps[r] = float(re.search(r"tokens_per_sec=([\d.]+|nan)",
                                         text).group(1))
            local = [r for r in outs if r.startswith("server:")]
            dgc = {r: _stat(outs, r"dgc_update:(\d+)", [r]) for r in local}
            rec.update(
                tokens_per_s_by_worker=tps,
                tokens_per_s=sum(tps.values()),
                mpq_bsc=_stat(outs, r"mpq_bsc=(\d+)"),
                mpq_fp16=_stat(outs, r"mpq_fp16=(\d+)"),
                wan_tx=_stat(outs, r"wan_tx=(\d+)"),
                dgc_update_by_server=dgc)
            for key in ("mpq_bsc", "mpq_fp16", "wan_tx"):
                assert rec[key] > 0, f"launched lm: {key} = 0"
            assert all(n > 0 for n in dgc.values()), \
                f"a local server launched no DGC update: {dgc}"
            # one DGC update for each key the MPQ selector sent down BSC
            picks = {r: _stat(outs, r"mpq_bsc=(\d+)", [r]) for r in local}
            assert dgc == picks, f"DGC launches {dgc} != BSC picks {picks}"
        else:
            rec["pq_overtakes"] = _stat(outs, r"pq_overtakes=(\d+)")
            assert rec["pq_overtakes"] > 0, "the priority queue never " \
                "reordered a send"
        log(f"launched {name}: {rec}")
        out[name] = rec
    return out


# ---- phase 10: the JAX package's process-level acceptance suite ----------

def run_acceptance(before_timed=None) -> dict:
    """10: every case of ``geomx_tpu_torch/acceptance.py`` but phase 7b's
    (the P3 staged MLP and the dense LM under MPQ), each role its own
    process with ``--device cuda`` and the default merge backend (the
    torch backend on this card), each held to its JAX test's mechanism
    assertion and the suite's common gates.  The cases marked ``timing``
    (a gate reads wall time, or a joiner or zombie must come up within
    the cluster's remaining rounds) run one at a time; the others
    ``ACCEPT_PARALLEL`` at once.  The kernels are built already; a
    child only loads them.  ``before_timed`` runs between the two (the
    background scripts of phase 12a join there)."""
    from concurrent.futures import ThreadPoolExecutor

    from geomx_tpu_torch import acceptance as A
    from geomx_tpu_torch.ops.kernels import flash_attention as FK
    from geomx_tpu_torch.ops.kernels import quantize_cuda as C

    assert not C.LIB.stale() and not FK.LIB.stale(), \
        "a kernel library is not built: a child process would build it"
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    names = [n for n in A.CASES if n not in A.IN_PHASE_7B]
    timing = [n for n in names if A.CASES[n].timing]
    # the scenarios with a kill (two runs for the shards) first: the
    # pool ends with the short plain cases
    untimed = sorted((n for n in names if not A.CASES[n].timing),
                     key=lambda n: A.CASES[n].scenario == "plain")
    log(f"phase 10: {len(untimed)} cases {ACCEPT_PARALLEL} clusters at "
        f"once ({untimed}), then {len(timing)} timed cases one at a "
        f"time ({timing})")

    def case(name):
        rec = A.run_case(name, "cuda", out_dir=out_dir,
                         prefix="chip_smoke_accept_")
        log(f"accept {name}: {rec['seconds']:.1f} s "
            f"{json.dumps(rec, default=str)}")
        return rec

    t0 = time.perf_counter()
    with ThreadPoolExecutor(ACCEPT_PARALLEL) as ex:
        futures = {n: ex.submit(case, n) for n in untimed}
        recs = {n: f.result() for n, f in futures.items()}
    untimed_s = time.perf_counter() - t0
    if before_timed is not None:
        before_timed()
    for n in timing:
        recs[n] = case(n)
    return {"cases": recs, "parallel": ACCEPT_PARALLEL,
            "untimed_s": untimed_s,
            "timed_s": time.perf_counter() - t0 - untimed_s,
            "seconds": time.perf_counter() - t0}


# ---- phase 8: MoE, the zoo, int8 and the parity harness ------------------

class _moe_env:
    """``GEOMX_LM_MOE_EXPERTS`` (and the default top-k) set for the
    flagship while the block runs, restored after."""

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in MOE_ENV}
        os.environ.update(MOE_ENV)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Routes:
    """Record each MoE layer's expert choices (``parallel.moe.
    topk_indices``) in call order while the block runs, or replay those
    of an earlier run (``replay``) in their place, so two runs route
    every token alike."""

    def __init__(self, replay=None):
        self.seen, self.replay = [], replay

    def __enter__(self):
        from geomx_tpu_torch.parallel import moe

        self.real = moe.topk_indices

        def choose(probs, k):
            if self.replay is None:
                idx = self.real(probs, k)
            else:
                idx = self.replay[len(self.seen)].to(probs.device)
            self.seen.append(idx.cpu())
            return idx

        moe.topk_indices = choose
        return self

    def __exit__(self, *exc):
        from geomx_tpu_torch.parallel import moe

        moe.topk_indices = self.real

    def dropped(self, n_experts: int, capacity: int) -> list:
        """Each layer's (token, choice) pairs past capacity."""
        import torch

        return [int((torch.nn.functional.one_hot(idx, n_experts).sum((1, 2))
                     - capacity).clamp(min=0).sum()) for idx in self.seen]


def _changed(a, b) -> tuple:
    """(routing decisions that differ between two recorded runs, all)."""
    return (sum(int((x != y).sum()) for x, y in zip(a.seen, b.seen)),
            sum(x.numel() for x in a.seen))


def check_moe_lm(dev) -> dict:
    """8a: the MoE flagship (``build_flagship_lm`` under
    ``GEOMX_LM_MOE_EXPERTS=4``, top-2, layers 1 and 3) at full width.
    Top-k routing is discontinuous: a change in the last bits of a
    router logit can move a token to another expert, and that token's
    gradient with it.  So each comparison replays the reference run's
    expert choices in the other run (gated: f32 dense attention on the
    card against the CPU from the same params, loss within 1e-4
    relative and each leaf within 1e-3 relative L2, TF32 off; bf16 with
    flash against bf16 with dense attention on the card, phase 4's 1e-3
    and 5e-2), and a free run beside it counts the decisions that move
    (printed, its loss held to the same loss gate) and the tokens
    dropped at capacity."""
    import dataclasses

    import torch

    from geomx_tpu_torch.models.transformer import make_lm_grad_fn
    from geomx_tpu_torch.parallel.moe import expert_capacity
    from geomx_tpu_torch.training import build_flagship_lm

    with _moe_env():
        cfg, params, n_params, _, data = build_flagship_lm(
            device=dev, attn_impl="dense")
    assert n_params == MOE_PARAMS and len(params) == MOE_KEYS, \
        (n_params, len(params))
    assert cfg.uses_aux and (cfg.n_experts, cfg.moe_top_k) == (4, 2)
    cap = expert_capacity(cfg.max_seq, cfg.n_experts, cfg.moe_top_k,
                          cfg.moe_capacity_factor)
    assert cap == MOE_CAPACITY, cap
    tokens = data[:MOE_BATCH]
    host = {n: t.cpu() for n, t in params.items()}

    def step(c, p, replay=None):
        with _Routes(replay) as routes:
            loss, _, grads = make_lm_grad_fn(c)(p, tokens, None)
        return (float(loss), {n: g.float().cpu() for n, g in grads.items()},
                routes)

    out = {"n_params": n_params, "keys": len(params), "capacity": cap}
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    bf16 = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    pairs = {
        # what: (reference, the run held to it, its free twin, gates)
        "f32": ((f32, params), (f32, host), MOE_F32_LOSS_TOL,
                MOE_F32_GRAD_TOL, "card", "CPU"),
        "bf16": ((dataclasses.replace(bf16, attn_impl="dense"), params),
                 (dataclasses.replace(bf16, attn_impl="flash"), params),
                 1e-3, 5e-2, "dense", "flash")}
    for what, (ref, run, loss_tol, grad_tol, ref_name, run_name) in \
            pairs.items():
        lr, gr, rr = step(*ref)
        lt, gt, rt = step(*run, replay=rr.seen)
        lfree, _, rfree = step(*run)
        rel_loss, rel = _rel_diffs(lt, gt, lr, gr)
        worst = max(rel, key=rel.get)
        free_rel = abs(lfree - lr) / abs(lr)
        moved, choices = _changed(rr, rfree)
        drops = {ref_name: rr.dropped(cfg.n_experts, cap),
                 run_name: rfree.dropped(cfg.n_experts, cap)}
        log(f"MoE LM ({n_params} params, {len(params)} keys, capacity "
            f"{cap}) {what}: {run_name} loss {lt:.6f} against {ref_name} "
            f"{lr:.6f} on the same routing (rel {rel_loss:.2e}, tol "
            f"{loss_tol}); worst leaf {worst} rel L2 {rel[worst]:.2e} (tol "
            f"{grad_tol}); routed freely: loss {lfree:.6f} (rel "
            f"{free_rel:.2e}), routing decisions that differ {moved} of "
            f"{choices} ({moved / choices:.4%}); (token, choice) pairs "
            f"dropped at capacity by layer {drops}")
        assert math.isfinite(lt) and rel_loss <= loss_tol, \
            f"MoE {what}: {run_name} loss off {ref_name} by {rel_loss:.2e}"
        assert rel[worst] <= grad_tol, \
            f"MoE {what}: grad of {worst} off by {rel[worst]:.2e}"
        assert free_rel <= loss_tol, \
            f"MoE {what}: freely routed loss off by {free_rel:.2e}"
        out[what] = {f"loss_{ref_name}": lr, f"loss_{run_name}": lt,
                     "rel_loss": rel_loss, "worst_leaf": worst,
                     "worst_rel_l2": rel[worst], "free_loss": lfree,
                     "free_rel_loss": free_rel, "routing_changed": moved,
                     "routing_choices": choices,
                     "dropped_by_layer": drops}
        del gr, gt
    return out


def check_moe_georound(compression: str) -> dict:
    """8b: the MoE flagship through ``examples/lm.py --moe-top-k 2
    --experts 4`` (2 × 2 + 1, FSA, Adam 3e-3, bf16 flash, batch 8, 8
    steps): exact flash and codec launches and the WAN bytes of the 37
    keys' frames.  ``2bit``: the example's data; at the codec's
    threshold 0.5 no entry crosses in 8 steps, so the weights do not move
    (printed).  ``none``: every worker on one shared batch, repeated:
    every worker's loss must fall and every MoE leaf move."""
    import itertools

    from geomx_tpu_torch.data import synthetic_lm
    from geomx_tpu_torch.models.transformer import create_lm_state

    argv = [compression if prev == "--compression" else a
            for prev, a in zip([""] + MOE_LM_ARGS, MOE_LM_ARGS)]
    make_iter = None
    if compression == "none":
        flags = dict(zip(argv[0::2], argv[1::2]))
        batch = synthetic_lm(n=int(flags["--batch"]), seq=int(flags["--seq"]),
                             vocab=int(flags["--vocab"]), seed=0)
        make_iter = lambda widx, num_all: itertools.repeat(  # noqa: E731
            (batch, batch))
    reset_all_launches()
    rec = run_lm_georound(argv, LM_STEPS, MOE_PARAMS, keep_params=True,
                          make_iter=make_iter)
    counts = all_launches()
    final, cfg = rec.pop("params"), rec.pop("cfg")
    rec["launches"] = counts
    sizes = rec.pop("key_sizes")
    assert len(sizes) == MOE_KEYS, len(sizes)
    codec = 2 * MOE_KEYS * LM_STEPS if compression == "2bit" else 0
    want = {"flash_fwd": 4 * LM_STEPS * 4, "flash_bwd": 4 * LM_STEPS * 4,
            "quantize_2bit": codec, "dequantize_2bit": codec}
    log(f"main-path launches under moe_lm {compression}: {counts} (want "
        f"{want})")
    for name, n in want.items():
        assert counts[name] == n, \
            f"{name} launched {counts[name]} times on the MoE LM " \
            f"({compression}), not {n}"
    # each party's local server sends every key's f32 weights up once
    # (init), then a step sends its push up (2-bit codes, or f32) and the
    # global server its f32 weights down, once a party; every message
    # adds its meta (64 bytes and the pickled header)
    n = sum(sizes)
    up = sum(-(-k // 4) for k in sizes) if compression == "2bit" else 4 * n
    total = round(rec["wan_bytes_per_step"] * LM_STEPS)
    frames = 2 * 4 * n + LM_STEPS * 2 * (up + 4 * n)
    messages = 2 * MOE_KEYS * (LM_STEPS + 1)
    meta = total - frames
    log(f"MoE LM {compression} WAN bytes in {LM_STEPS} steps {total}: the "
        f"37 keys' frames {frames} ({up} bytes up and {4 * n} down a party "
        f"a step, the f32 init) + message meta {meta} "
        f"({meta / messages:.1f} a message of {messages})")
    assert 0 < meta <= messages * WAN_META_MAX, \
        f"MoE LM WAN bytes are not the 37 keys' frames: meta {meta}"
    init, _ = create_lm_state(cfg, seed=0, device=final["embed"].device)
    moved = {k: int((final[k] != init[k]).sum()) for k in final}
    moe_moved = {k: v for k, v in moved.items()
                 if k.rsplit(".", 1)[-1] in ("router", "we1", "we2")}
    log(f"MoE LM {compression}: losses by worker {rec['histories']}; "
        f"entries moved {sum(moved.values())} of {n}, in the MoE leaves "
        f"{moe_moved}")
    if compression == "none":
        for w, h in rec["histories"].items():
            assert h[-1] < h[0], f"MoE LM worker {w}'s loss did not fall"
        assert all(moe_moved.values()), \
            f"an MoE leaf did not move: {moe_moved}"
    rec.update(wan_bytes=total, frames_bytes=frames, meta_bytes=meta,
               entries_moved=sum(moved.values()), moe_entries_moved=moe_moved)
    return rec


def check_zoo(dev) -> dict:
    """8c: the five zoo families at the JAX package's default widths,
    28 × 28 × 1, batch 32: one f32 step on the card against the CPU from
    the same params (loss within 1e-4 relative, each leaf within 1e-3
    relative L2) and a finite bf16 step on the card."""
    import torch

    from geomx_tpu_torch.data import synthetic_classification
    from geomx_tpu_torch.models import create_model_state

    x, y = synthetic_classification(n=ZOO_BATCH, seed=0)
    out = {}
    for name in ZOO_FAMILIES:
        model, params, grad_fn = create_model_state(
            name, 0, input_shape=(1, 28, 28, 1), compute_dtype=torch.float32,
            device=dev)
        n_params = sum(t.numel() for t in params.values())
        lc, _, gc = grad_fn(params, x, y)
        lh, _, gh = grad_fn({n: t.cpu() for n, t in params.items()}, x, y)
        rel_loss, rel = _rel_diffs(float(lc), {n: g.cpu()
                                               for n, g in gc.items()},
                                   float(lh), gh)
        worst = max(rel, key=rel.get)
        model16, _, grad16 = create_model_state(name, 0, device=dev)
        l16, _, g16 = grad16(params, x, y)
        finite = bool(torch.isfinite(l16)) and all(
            bool(torch.isfinite(g).all()) for g in g16.values())
        log(f"zoo {name} ({n_params} params, {len(params)} keys) f32: card "
            f"loss {float(lc):.6f} CPU {float(lh):.6f} (rel "
            f"{rel_loss:.2e}); worst leaf {worst} rel L2 {rel[worst]:.2e}; "
            f"bf16 loss {float(l16):.6f}, finite {finite}")
        assert rel_loss <= 1e-4, f"zoo {name}: loss off by {rel_loss:.2e}"
        assert rel[worst] <= 1e-3, \
            f"zoo {name}: grad of {worst} off by {rel[worst]:.2e}"
        assert finite, f"zoo {name}: the bf16 step is not finite"
        out[name] = {"n_params": n_params, "keys": len(params),
                     "loss_card": float(lc), "loss_cpu": float(lh),
                     "rel_loss": rel_loss, "worst_leaf": worst,
                     "worst_rel_l2": rel[worst], "bf16_loss": float(l16)}
    return out


def run_zoo_georound() -> dict:
    """8c: ``examples/cnn.py --model resnet --compression bsc`` (2 × 2 +
    1, FSA, Adam, batch 32, the torch backend on the card): the DGC
    update once per key per party a step (every key a BSC pick), every
    worker's loss falling."""
    from geomx_tpu_torch.examples.cnn import build_parser, train

    reset_all_launches()
    args = build_parser().parse_args(
        ["--parties", "2", "--workers", "2", "--global-servers", "1",
         "--model", "resnet", "--steps", str(ZOO_STEPS), "--batch", "32",
         "--optimizer", "adam", "--lr", "0.001", "--compression", "bsc",
         "--bsc-ratio", "0.01", "--seed", "0"])
    out = train(args, log=lambda msg: None)
    counts = all_launches()
    keys = len(out["params"])
    want = 2 * keys * ZOO_STEPS
    hist = {f"{p},{r}": [l for l, _ in h]
            for (p, r), h in sorted(out["histories"].items())}
    wan = out["wan"]["wan_send_bytes"] / ZOO_STEPS
    log(f"geo-round resnet bsc: {ZOO_STEPS} steps, {keys} keys, loss by "
        f"worker {hist}, {out['seconds']:.2f} s, WAN bytes/step {wan:.0f}; "
        f"launches {counts} (DGC want {want})")
    assert counts["dgc_update"] == want, \
        f"dgc_update launched {counts['dgc_update']} times, not {want}"
    for s in out["sim_stats"]["local"] + out["sim_stats"]["global"]:
        assert s["merge_backend"] == "torch" and s["merge_device"] == "cuda"
    for w, h in hist.items():
        assert all(math.isfinite(v) for v in h) and h[-1] < h[0], \
            f"resnet worker {w}'s loss did not fall: {h}"
    return {"launches": counts, "keys": keys, "histories": hist,
            "wan_bytes_per_step": wan, "seconds": out["seconds"]}


def check_int8(dev) -> dict:
    """8d: the zoo MLP trained 30 SGD steps on the card, quantized by
    ``quantize_dense_tree`` and run through ``make_quantized_mlp_apply``
    on the card at batch 32 and at batch 5 (the padded ``torch._int_mm``
    path): bitwise equal to the same on the CPU; the f32 model's and
    the int8 model's accuracy side by side."""
    import torch

    from geomx_tpu_torch.data import synthetic_classification
    from geomx_tpu_torch.models import create_model_state
    from geomx_tpu_torch.ops.int8 import (make_quantized_mlp_apply,
                                          quantize_dense_tree)

    model, params, grad_fn = create_model_state(
        "mlp", 0, compute_dtype=torch.float32, device=dev)
    x, y = synthetic_classification(n=512, seed=0)
    for i in range(30):
        _, _, grads = grad_fn(params, x[:128], y[:128])
        params = {k: v - 0.1 * grads[k] for k, v in params.items()}
    q_apply = make_quantized_mlp_apply()
    q_card = quantize_dense_tree(params)
    q_cpu = quantize_dense_tree({k: v.cpu() for k, v in params.items()})
    out = {}
    for batch in INT8_BATCHES:
        xb = x[:batch]
        got = q_apply(q_card, torch.as_tensor(xb, device=dev)).cpu()
        want = q_apply(q_cpu, torch.from_numpy(xb))
        same = got.numpy().tobytes() == want.numpy().tobytes()
        log(f"int8 MLP batch {batch}: card logits bitwise equal to the "
            f"CPU's: {same}")
        assert same, f"int8 MLP at batch {batch}: card and CPU differ"
        out[f"batch_{batch}_bitwise"] = same
    xs = torch.as_tensor(x, device=dev)
    with torch.no_grad():
        fp = float((model.apply(params, xs).argmax(-1).cpu().numpy()
                    == y).mean())
    q = float((q_apply(q_card, xs).argmax(-1).cpu().numpy() == y).mean())
    log(f"int8 MLP accuracy on 512 synthetic samples: f32 {fp:.4f}, "
        f"int8 {q:.4f}")
    out.update(f32_accuracy=fp, int8_accuracy=q)
    return out


def check_parity(dev) -> dict:
    """8e: ``run_parity_matrix`` (``PARITY_STEPS`` steps, the configs of
    ``PARITY_NAMES``) on the card and on the CPU: no config errors; WAN
    bytes equal where the frames' sizes do not depend on values, within
    ``PARITY_BSC_BYTES_RTOL`` where BSC's sampled threshold picks a
    value-dependent count; the codec kernels launched in each config
    that compresses through them; each delta against vanilla printed."""
    from geomx_tpu_torch.utils import parity

    real = parity.run_parity_config
    by_config = {}

    def counted(name, **kw):
        before = all_launches()
        try:
            return real(name, **kw)
        finally:
            after = all_launches()
            by_config[name] = {k: after[k] - before[k] for k in after}

    reset_all_launches()
    parity.run_parity_config = counted
    try:
        card = parity.run_parity_matrix(steps=PARITY_STEPS,
                                        names=list(PARITY_NAMES), device=dev)
    finally:
        parity.run_parity_config = real
    counts = all_launches()
    host = parity.run_parity_matrix(steps=PARITY_STEPS,
                                    names=list(PARITY_NAMES), device="cpu")
    for name in PARITY_NAMES:
        c, h = card[name], host[name]
        log(f"parity {name}: card {c}; CPU wan_send_bytes "
            f"{h.get('wan_send_bytes')}, final_accuracy "
            f"{h.get('final_accuracy')}; launches "
            f"{ {k: v for k, v in by_config[name].items() if v} }")
        assert "error" not in c and "error" not in h, (name, c, h)
        assert c["steps"] == h["steps"] == PARITY_STEPS, (name, c, h)
        if name in PARITY_VALUE_SIZED:
            rel = abs(c["wan_send_bytes"] / h["wan_send_bytes"] - 1)
            assert rel <= PARITY_BSC_BYTES_RTOL, \
                f"parity {name}: WAN bytes card {c['wan_send_bytes']} CPU " \
                f"{h['wan_send_bytes']}"
        else:
            assert c["wan_send_bytes"] == h["wan_send_bytes"], \
                f"parity {name}: WAN bytes card {c['wan_send_bytes']} CPU " \
                f"{h['wan_send_bytes']}"
        for kernel in PARITY_KERNELS.get(name, ()):
            assert by_config[name][kernel] > 0, \
                f"parity {name}: {kernel} was not launched"
    return {"card": card, "cpu": host, "launches": counts,
            "launches_by_config": by_config}


# ---- phase 9: multi-device parallelism on single-controller meshes -----

def _launched(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _held(what: str, loss, grads, ref_loss, ref_grads, loss_tol: float,
          grad_tol: float) -> dict:
    """Gate a step against its reference: loss within ``loss_tol``
    relative, every leaf within ``grad_tol`` relative L2."""
    rel_loss, rel = _rel_diffs(float(loss), grads, float(ref_loss),
                               ref_grads)
    worst = max(rel, key=rel.get)
    log(f"{what}: loss {float(loss):.6f} against {float(ref_loss):.6f} (rel "
        f"{rel_loss:.2e}, tol {loss_tol:g}); worst leaf {worst} rel L2 "
        f"{rel[worst]:.2e} (tol {grad_tol:g})")
    assert math.isfinite(float(loss)) and rel_loss <= loss_tol, \
        f"{what}: loss off by {rel_loss:.2e}"
    assert rel[worst] <= grad_tol, f"{what}: grad of {worst} off by " \
        f"{rel[worst]:.2e}"
    return {"loss": float(loss), "rel_loss": rel_loss, "worst_leaf": worst,
            "worst_rel_l2": rel[worst]}


def _counted_step(fn, *args) -> tuple:
    """``fn(*args)`` with the launch counts set to 0 just before and read
    just after; returns (result, counts, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, all_launches(), time.perf_counter() - t0


def _exact(what: str, counts: dict, want: dict, wall: float) -> None:
    got = _launched(counts)
    log(f"{what}: launches {got} (want {want}), wall {wall:.4f} s")
    assert got == want, f"{what}: launches {got}, not {want}"


def check_tp(dev) -> dict:
    """9a: the flagship at build_flagship_lm's widths on a dp × tp mesh
    and a dp × sp × tp mesh on the card, against the single-device
    step; the MoE flagship on the 8-rank mesh; Adam steps on the tp
    mesh."""
    import dataclasses

    import torch

    from geomx_tpu_torch.models import transformer as T
    from geomx_tpu_torch.models.transformer import make_lm_grad_fn
    from geomx_tpu_torch.parallel import make_mesh
    from geomx_tpu_torch.training import build_flagship_lm

    cfg, params, n_params, _, data = build_flagship_lm(
        device=dev, attn_impl="flash")
    assert n_params == LM_PARAMS, n_params
    tokens = data[:TP_BATCH]
    mesh = make_mesh(TP_MESH, devices=[dev] * 4)
    mesh8 = make_mesh(TP_SP_MESH, devices=[dev] * 8)
    dp, tp, L = TP_MESH["dp"], TP_MESH["tp"], cfg.n_layers
    dense = dataclasses.replace(cfg, attn_impl="dense")
    ref_loss, _, ref = make_lm_grad_fn(dense)(params, tokens)
    out = {"n_params": n_params}

    shapes = []
    real = T.flash_attention
    T.flash_attention = lambda q, *a: (shapes.append(tuple(q.shape)),
                                       real(q, *a))[1]
    try:
        (loss, _, grads), counts, wall = _counted_step(
            make_lm_grad_fn(cfg, mesh), params, tokens)
    finally:
        T.flash_attention = real
    _exact("tp step (flash, dp 2 x tp 2)", counts,
           {"flash_fwd": dp * tp * L, "flash_bwd": dp * tp * L}, wall)
    want = (TP_BATCH // dp, cfg.max_seq, cfg.n_heads // tp, cfg.head_dim)
    log(f"tp step flash shapes {sorted(set(shapes))} (want {want})")
    assert set(shapes) == {want}, f"tp flash shapes {set(shapes)}"
    out["tp_flash"] = dict(_held(
        "tp step bf16 flash on dp 2 x tp 2 against single-device dense",
        loss, grads, ref_loss, ref, 1e-3, 5e-2), wall_s=wall,
        launches=counts)

    f32 = dataclasses.replace(dense, compute_dtype=torch.float32)
    l32, _, g32 = make_lm_grad_fn(f32)(params, tokens)
    (loss, _, grads), counts, wall = _counted_step(
        make_lm_grad_fn(f32, mesh), params, tokens)
    _exact("tp step (f32 dense)", counts, {}, wall)
    out["tp_f32"] = dict(_held(
        "tp step f32 dense on dp 2 x tp 2 against single-device f32",
        loss, grads, l32, g32, F32_STEP_LOSS_TOL, F32_STEP_GRAD_TOL),
        wall_s=wall)
    del g32

    ring = dataclasses.replace(cfg, sp_attn="ring")
    sp = TP_SP_MESH["sp"]
    (loss, _, grads), counts, wall = _counted_step(
        make_lm_grad_fn(ring, mesh8), params, tokens)
    _exact("tp ring step (flash, dp 2 x sp 2 x tp 2)", counts,
           {"block_attn_fwd": dp * tp * L * sp ** 2}, wall)
    out["tp_ring"] = dict(_held(
        "tp ring step bf16 on dp 2 x sp 2 x tp 2 against single-device "
        "dense", loss, grads, ref_loss, ref, 1e-3, 5e-2), wall_s=wall,
        launches=counts)
    del grads, ref

    out["moe"] = _check_tp_moe(dev, mesh8)

    # Adam on the repeated batch, the gradients from the tp mesh
    p = {n: t.detach().clone() for n, t in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=STAGED_LR)
    grad_fn = make_lm_grad_fn(cfg, mesh)
    losses = []
    for _ in range(TP_ADAM_STEPS):
        loss, _, grads = grad_fn(p, tokens)
        for n, t in p.items():
            t.grad = grads[n]
        opt.step()
        losses.append(float(loss))
    log(f"tp Adam steps (lr {STAGED_LR}) on a repeated batch: losses "
        f"{losses}")
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], \
        "the tp step's loss did not fall"
    out["adam_losses"] = losses
    del p, opt
    torch.cuda.empty_cache()
    return out


def _by_layer(seen: list, dp: int) -> list:
    """A dp mesh's recorded routing (one call a (dp rank, MoE layer), dp
    rank major) as the single-device run records it: one call a layer,
    the dp ranks' groups joined."""
    import torch

    n = len(seen) // dp
    return [torch.cat([seen[d * n + i] for d in range(dp)])
            for i in range(n)]


def _check_tp_moe(dev, mesh8) -> dict:
    """The MoE flagship (top-2, 4 experts, 2 a tp rank) on the 8-rank
    mesh with ring flash, against single-device bf16 dense on the
    reference run's routing; a freely routed run beside it."""
    import dataclasses

    import torch

    from geomx_tpu_torch.models.transformer import make_lm_grad_fn
    from geomx_tpu_torch.training import build_flagship_lm

    with _moe_env():
        cfg, params, n_params, _, data = build_flagship_lm(
            device=dev, attn_impl="dense")
    assert n_params == MOE_PARAMS, n_params
    tokens = data[:MOE_BATCH]
    dp = TP_SP_MESH["dp"]
    with _Routes() as ref_routes:
        ref_loss, _, ref = make_lm_grad_fn(cfg)(params, tokens)
    replay = [r[d * (MOE_BATCH // dp):(d + 1) * (MOE_BATCH // dp)]
              for d in range(dp) for r in ref_routes.seen]
    run = dataclasses.replace(cfg, attn_impl="flash", sp_attn="ring")
    fn = make_lm_grad_fn(run, mesh8)
    with _Routes(replay):
        (loss, _, grads), counts, wall = _counted_step(fn, params, tokens)
    L, sp = cfg.n_layers, TP_SP_MESH["sp"]
    _exact("MoE tp ring step", counts,
           {"block_attn_fwd": dp * TP_SP_MESH["tp"] * L * sp ** 2}, wall)
    out = _held("MoE (top-2, 4 experts over tp 2) on dp 2 x sp 2 x tp 2 "
                "against single-device bf16 dense, the same routing",
                loss, grads, ref_loss, ref, 1e-3, 5e-2)
    with _Routes() as free:
        free_loss = float(fn(params, tokens)[0])
    free.seen = _by_layer(free.seen, dp)
    moved, choices = _changed(ref_routes, free)
    free_rel = abs(free_loss - float(ref_loss)) / abs(float(ref_loss))
    log(f"MoE tp ring step routed freely: loss {free_loss:.6f} (rel "
        f"{free_rel:.2e}, tol 1e-3), routing decisions that differ {moved} "
        f"of {choices} ({moved / choices:.4%})")
    assert free_rel <= 1e-3, f"MoE tp: freely routed loss off by {free_rel}"
    out.update(wall_s=wall, launches=counts, free_loss=free_loss,
               free_rel_loss=free_rel, routing_changed=moved,
               routing_choices=choices)
    return out


def _hips_rounds(steps: list, params0: dict, rounds: int, optimizer: dict,
                 compression=None) -> dict:
    """2 parties × 1 worker + 1 global server (FSA, the torch backend on
    the card): each round, party p's ``steps[p](params) -> (loss,
    grads)`` pushes its gradients into the two-tier kvstore and pulls
    the weights back.  Returns each party's losses and final weights."""
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation

    sim = Simulation(Config(topology=Topology(num_parties=2,
                                              workers_per_party=1),
                            merge_backend="torch"))
    try:
        kvs = [sim.worker(p, 0) for p in range(2)]
        names = list(params0)
        for kv in kvs:
            for tid, n in enumerate(names):
                kv.init(tid, params0[n].cpu().numpy())
            if compression:
                kv.set_gradient_compression(compression)
        kvs[0].set_optimizer(optimizer)
        for kv in kvs:
            kv.barrier()
        dev = params0[names[0]].device
        cur = [params0, params0]
        losses = [[], []]
        for _ in range(rounds):
            for p in range(2):
                loss, grads = steps[p](cur[p])
                losses[p].append(float(loss))
                for tid, n in enumerate(names):
                    kvs[p].push(tid, grads[n].float().cpu().numpy())
            for p in range(2):
                buf = [kvs[p].pull_sync(tid) for tid in range(len(names))]
                kvs[p].wait_all()
                cur[p] = {n: torch.from_numpy(np.array(b)).to(dev)
                          for n, b in zip(names, buf)}
        stats = [s.stats() for s in sim.local_servers + sim.global_servers]
    finally:
        sim.shutdown()
    for s in stats:
        assert s["merge_backend"] == "torch" and s["merge_device"] == "cuda"
    bits = [[t.cpu().numpy().tobytes() for t in c.values()] for c in cur]
    assert bits[0] == bits[1], "the two parties' weights differ"
    return {"losses": losses, "final": cur[0]}


def check_pp(dev) -> dict:
    """9b: the pipelined flagship (build_flagship_lm's widths, an untied
    head) on pp 2 x dp 2, 4 microbatches, against the same weights with
    no pipeline; then 2 parties of it through the kvstore."""
    import dataclasses

    import torch

    from geomx_tpu_torch.data import synthetic_lm
    from geomx_tpu_torch.models.transformer import (TransformerConfig,
                                                    token_cross_entropy)
    from geomx_tpu_torch.parallel import make_mesh
    from geomx_tpu_torch.parallel.pipeline import (init_pp_transformer,
                                                   make_pp_apply)

    cfg = TransformerConfig(**STAGED_WIDTHS, attn_impl="flash")
    pp = init_pp_transformer(cfg, torch.Generator().manual_seed(0), dev)
    n_params = sum(t.numel() for t in pp.values())
    assert n_params == STAGED_PARAMS, n_params
    x = torch.as_tensor(synthetic_lm(n=PP_BATCH, seq=cfg.max_seq,
                                     vocab=cfg.vocab, seed=0),
                        device=dev).long()
    mesh = make_mesh(PP_MESH, devices=[dev] * 4)

    def grad_step(apply):
        def step(p):
            leaves = {n: t.detach().requires_grad_(True)
                      for n, t in p.items()}
            loss = token_cross_entropy(apply(leaves, x), x)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return loss.detach(), dict(zip(leaves, grads))
        return step

    one = make_mesh({"pp": 1}, devices=[dev])
    ref_loss, ref = grad_step(make_pp_apply(
        dataclasses.replace(cfg, attn_impl="dense"), one, 1))(pp)
    run = grad_step(make_pp_apply(cfg, mesh, PP_MICROBATCHES,
                                  dp_axis="dp"))
    (loss, grads), counts, wall = _counted_step(run, pp)
    n = PP_MESH["dp"] * PP_MICROBATCHES * cfg.n_layers
    _exact("pp step (pp 2 x dp 2, 4 microbatches, bubbles skipped)",
           counts, {"flash_fwd": n, "flash_bwd": n}, wall)
    out = dict(_held("pp step bf16 flash against the same weights with no "
                     "pipeline (dense)", loss, grads, ref_loss, ref, 1e-3,
                     5e-2), n_params=n_params, wall_s=wall, launches=counts)
    del grads, ref

    steps = [grad_step(make_pp_apply(cfg, make_mesh(PP_MESH, [dev] * 4),
                                     PP_MICROBATCHES, dp_axis="dp"))
             for _ in range(2)]
    (hips, counts, wall) = _counted_step(
        _hips_rounds, steps, pp, PP_HIPS_ROUNDS,
        {"type": "sgd", "lr": PP_HIPS_LR})
    first, last = hips["losses"][0][0], hips["losses"][0][-1]
    log(f"pp-hips: 2 parties x (pp 2 x dp 2) -> the two-tier kvstore, "
        f"{PP_HIPS_ROUNDS} rounds (SGD {PP_HIPS_LR}), losses "
        f"{hips['losses']}, parties bitwise equal, {wall:.2f} s")
    assert last < first, f"pp-hips: loss {first} -> {last} did not fall"
    _exact("pp-hips", counts, {"flash_fwd": 2 * PP_HIPS_ROUNDS * n,
                               "flash_bwd": 2 * PP_HIPS_ROUNDS * n}, wall)
    out["hips"] = {"losses": hips["losses"], "wall_s": wall,
                   "launches": counts}
    del hips
    torch.cuda.empty_cache()
    return out


def _int8_wire_bytes(n: int, k: int) -> tuple:
    """(int8 wire bytes, f32 ring all-reduce bytes) that k ranks move
    between them for one n-element reduction, from the shapes: the
    all-to-all and the all-gather each carry (k - 1) chunks of int8
    codes and their f32 block scales to each of the k ranks; a ring
    all-reduce moves 2 (k - 1) / k of the f32 vector from each rank."""
    from geomx_tpu_torch.parallel.quantized_allreduce import BLOCK, _chunk

    chunk = _chunk(n, k)
    return (2 * k * (k - 1) * (chunk + 4 * chunk // BLOCK),
            2 * (k - 1) * 4 * n)


def check_dp(dev) -> dict:
    """9c: party_meshes(2, [card] * 4) with make_party_step on the
    flagship; the hips scenario under 2bit; the int8 party step; the
    quantized all-reduce card against CPU."""
    import torch

    from geomx_tpu_torch.models.transformer import make_lm_grad_fn
    from geomx_tpu_torch.parallel import (make_party_step_quantized,
                                          quantized_psum_mean)
    from geomx_tpu_torch.parallel.dp import (_per_rank, make_party_step,
                                             party_meshes)
    from geomx_tpu_torch.parallel.quantized_allreduce import (
        BLOCK, quantized_psum_mean_ef)
    from geomx_tpu_torch.training import build_flagship_lm

    cfg, params, n_params, _, data = build_flagship_lm(
        device=dev, attn_impl="flash")
    meshes = party_meshes(DP_PARTIES, [dev] * DP_DEVICES)
    dp = meshes[0].shape["dp"]
    grad_fn = make_lm_grad_fn(cfg)
    tokens = data[:TP_BATCH]
    ref_loss, _, ref = grad_fn(params, tokens)
    (loss, _, grads), counts, wall = _counted_step(
        make_party_step(grad_fn, meshes[0]), params, tokens, tokens)
    _exact("dp party step (flash, 2 ranks)", counts,
           {"flash_fwd": dp * cfg.n_layers, "flash_bwd": dp * cfg.n_layers},
           wall)
    out = dict(_held("dp party step against the single-device full batch",
                     loss, grads, ref_loss, ref, 1e-3, 5e-2), wall_s=wall,
               launches=counts)

    # the hips scenario: each party a dp mesh, the WAN under 2bit
    batches = [data[p * TP_BATCH:(p + 1) * TP_BATCH]
               for p in range(DP_PARTIES)]
    steps = [(lambda cur, s=make_party_step(grad_fn, m), b=b:
              (lambda r: (r[0], r[2]))(s(cur, b, b)))
             for m, b in zip(meshes, batches)]
    hips, counts, wall = _counted_step(
        _hips_rounds, steps, params, DP_HIPS_ROUNDS,
        {"type": "adam", "lr": STAGED_LR}, {"type": "2bit",
                                            "threshold": DP_HIPS_THRESHOLD})
    keys = len(params)
    want = {"flash_fwd": DP_HIPS_ROUNDS * DP_PARTIES * dp * cfg.n_layers,
            "flash_bwd": DP_HIPS_ROUNDS * DP_PARTIES * dp * cfg.n_layers,
            "quantize_2bit": DP_HIPS_ROUNDS * DP_PARTIES * keys,
            "dequantize_2bit": DP_HIPS_ROUNDS * DP_PARTIES * keys}
    moved = sum(int((hips["final"][n] != params[n]).sum()) for n in params)
    log(f"dp hips: 2 parties x {dp}-rank dp mesh -> two-tier kvstore (FSA, "
        f"Adam {STAGED_LR}, 2bit at {DP_HIPS_THRESHOLD}), {DP_HIPS_ROUNDS} "
        f"rounds, losses "
        f"{hips['losses']}, parties bitwise equal, entries moved {moved} "
        f"of {n_params}, {wall:.2f} s")
    _exact(f"dp hips ({keys} keys x {DP_PARTIES} parties a round)", counts,
           want, wall)
    assert moved > 0, "dp hips: no 2bit update reached the weights"
    out["hips"] = {"losses": hips["losses"], "entries_moved": moved,
                   "wall_s": wall, "launches": counts}
    del hips

    # the int8 party step on the same batch: within 2 · A / 254 of the
    # exact step, A the larger block absmax of the ranks' and the mean's
    # (each leg rounds by at most half a step, A / 254), plus
    # QAR_ROUNDING_ULPS f32 ulps of A for the two steps' own sums
    qloss, _, qgrads = make_party_step_quantized(grad_fn, meshes[0])(
        params, tokens, tokens)
    names = sorted(grads)

    def blocks(g):
        v = torch.cat([g[k].reshape(-1).float() for k in names])
        return torch.nn.functional.pad(v, (0, (-v.numel()) % BLOCK)
                                       ).reshape(-1, BLOCK)

    ranks = [o[2] for o in _per_rank(grad_fn, meshes[0], params, tokens,
                                     tokens)[0]]
    amax = torch.stack([blocks(g).abs().amax(1)
                        for g in ranks + [grads]]).amax(0)
    err = (blocks(qgrads) - blocks(grads)).abs().amax(1)
    ratio = float((err / amax.clamp(min=1e-30)).max())
    bound = amax * (2 / 254 + QAR_ROUNDING_ULPS * 2.0 ** -23)
    wire, ring = _int8_wire_bytes(n_params, dp)
    log(f"dp int8 party step: loss {float(qloss):.6f} (exact "
        f"{float(loss):.6f}); worst block error {ratio:.7f} of its absmax "
        f"(bound 2/254 = {2 / 254:.7f} + {QAR_ROUNDING_ULPS} ulps); wire "
        f"bytes a step {wire} int8 against {ring} f32 (from the shapes, "
        f"{dp} ranks)")
    assert bool((err <= bound).all()), \
        f"int8 party step outside the block bound ({ratio})"
    assert float(qloss) == float(loss)
    out["quantized"] = {"loss": float(qloss), "worst_err_over_absmax": ratio,
                        "wire_bytes_int8": wire, "wire_bytes_f32": ring}
    del grads, qgrads, ranks, ref

    # the quantized all-reduce, card against CPU, bitwise
    rng = np.random.default_rng(0)
    for k in QAR_RANKS:
        x = rng.standard_normal((k, QAR_N)).astype(np.float32)
        x[:, ::997] *= 300.0
        r = (rng.standard_normal((k, QAR_N)) * 0.01).astype(np.float32)
        got = {}
        for d in (dev, "cpu"):
            xs = [torch.from_numpy(a).to(d) for a in x]
            rs = [torch.from_numpy(a).to(d) for a in r]
            ef, res = quantized_psum_mean_ef(xs, rs)
            got[str(d)] = [t.cpu().numpy().tobytes() for t in
                           quantized_psum_mean(xs) + ef + res]
        assert got[str(dev)] == got["cpu"], \
            f"quantized all-reduce at k = {k}: card differs from the CPU"
        log(f"quantized_psum_mean and _ef at k = {k}, n = {QAR_N}: card "
            f"bitwise equal to the CPU")
    out["qar_card_equals_cpu"] = list(QAR_RANKS)
    torch.cuda.empty_cache()
    return out


def _merge_round(be, pushes, key=0):
    acc = be.seed(pushes[0].copy(), donated=True, key=key)
    for p in pushes[1:]:
        acc = be.accumulate(acc, p.copy())
    return be.materialize(acc).copy()


def _lm_rung_georound(backend: str, devices: list, shapes: dict) -> tuple:
    """2 × 2 + 1 FSA geo-round of the flagship's 35 key shapes (SGD lr
    1/4, 3 steps) under the int8 mesh rung with its residual, every
    worker pushing one gradient a step (numpy, from the step's seed), so
    no slot's contents depend on arrival order; the torch backend's
    default device slots set to ``devices``.  Returns (the weights'
    bytes, the servers' stats, keys with a residual)."""
    import torch

    import geomx_tpu_torch.kvstore.torch_backend as TB
    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore import Simulation

    init = {n: torch.from_numpy(np.random.default_rng(i).integers(
        -8, 9, s).astype(np.float32) / 8)
        for i, (n, s) in enumerate(shapes.items())}

    def grad_fn(params, x, y):
        rng = np.random.default_rng(x)
        grads = {n: torch.from_numpy(
            (rng.integers(-64, 65, p.shape) / 64.0
             + p.cpu().numpy() / 4).astype(np.float32))
            for n, p in params.items()}
        zero = torch.zeros(())
        return zero, zero, grads

    saved = TB._MESH_DEVICES
    TB._MESH_DEVICES = devices
    try:
        sim = Simulation(Config(
            topology=Topology(num_parties=2, workers_per_party=2,
                              num_global_servers=1),
            sync_global_mode=True, merge_backend=backend,
            merge_quantized=True, merge_residual=True))
    finally:
        TB._MESH_DEVICES = saved

    def setup(kv, p, r):
        if (p, r) == (0, 0):
            kv.set_optimizer({"type": "sgd", "lr": 0.25})
        return [(s, None) for s in range(3)]

    try:
        first = _fsa_workers(sim, init, grad_fn, setup)
        servers = sim.local_servers + sim.global_servers
        stats = [s.stats() for s in servers]
        residual_keys = [len(s._backend._residuals) for s in servers]
    finally:
        sim.shutdown()
    return first, stats, residual_keys


def check_merge_rung(dev) -> dict:
    """9d: TorchBackend(devices=[card] * 4) on JAX's merge-rung scenarios
    with and without the int8 rung and its residual, each bitwise equal
    to the same on ``["cpu"] * 4``; then an LM geo-round on the rung."""
    import torch

    from geomx_tpu_torch.core.config import Config, Topology
    from geomx_tpu_torch.kvstore.torch_backend import (_MESH_MIN_ELEMS,
                                                       TorchBackend)
    from geomx_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)

    n, k = _MESH_MIN_ELEMS, MERGE_SLOTS
    rng = np.random.default_rng(11)
    exact = [np.full(n, float(i + 1), np.float32) for i in range(5)]
    noisy = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    hot = np.full(n, 0.1, np.float32)
    hot[0] = 400.0
    out = {}
    for quantized, residual in ((False, True), (True, False), (True, True)):
        name = ("exact" if not quantized else
                "int8+residual" if residual else "int8")
        cfg = Config(topology=Topology(), merge_quantized=quantized,
                     merge_residual=residual)
        res = {}
        for d in (dev, "cpu"):
            be = TorchBackend(cfg, d, devices=[d] * k)
            st = be.stats()
            assert (st["merge_devices"], st["merge_quantized"],
                    st["merge_residual"]) == (k, quantized,
                                              quantized and residual), st
            sums = [_merge_round(be, exact), _merge_round(be, noisy)]
            sums += [_merge_round(be, [hot] * 4, key=1)
                     for _ in range(MERGE_EF_ROUNDS)]
            res[str(d)] = sums
        card, host = res[str(dev)], res["cpu"]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(card, host)), \
            f"merge rung {name}: the card differs from the CPU"
        bound = float(2.0 * 4 * max(np.abs(p).max() for p in noisy) / 127.0)
        err = float(np.abs(card[1] - np.sum(noisy, 0)).max())
        cum = float(np.sum([s[1] for s in card[2:]], dtype=np.float64))
        want = MERGE_EF_ROUNDS * 4 * 0.1
        log(f"merge rung {name} on {k} slots of the card: 5 pushes sum "
            f"{'exactly' if (card[0] == 15.0).all() else 'NOT exactly'}; "
            f"4 noisy pushes off their sum by {err:.4e} (int8 bound "
            f"{bound:.4e}); hot block's small "
            f"entry after {MERGE_EF_ROUNDS} rounds {cum:.4f} (exact "
            f"{want}); bitwise "
            f"equal to the CPU's")
        if not quantized:
            assert (card[0] == 15.0).all() and err <= 1e-5, err
        else:
            assert err <= bound, f"merge rung {name}: error {err} > {bound}"
        step = 2 * 400.0 / 127.0
        if quantized and residual:
            assert abs(cum - want) <= 2 * step, cum
            assert cum != out["int8"]["subthreshold_cum"], \
                "merge rung: the residual changed nothing"
        elif quantized:
            assert abs(cum - want) >= 0.9 * want, cum
            assert abs(cum - want) > 2 * step, cum
        out[name] = {"int8_err": err, "bound": bound,
                     "subthreshold_cum": cum, "rounds": MERGE_EF_ROUNDS}

    cfg = TransformerConfig(**STAGED_WIDTHS)
    shapes = {n: tuple(t.shape) for n, t in init_params(
        cfg, torch.Generator().manual_seed(0)).items()}
    t0 = time.perf_counter()
    card, stats, with_res = _lm_rung_georound("torch", [dev] * k, shapes)
    wall = time.perf_counter() - t0
    host, _, _ = _lm_rung_georound("torch:cpu", ["cpu"] * k, shapes)
    big = sum(1 for s in shapes.values() if math.prod(s) >= n)
    assert all(s["merge_devices"] == k > 1 for s in stats), stats
    assert all(s["merge_device"] == "cuda" for s in stats)
    assert all(r >= big for r in with_res), (with_res, big)
    finite = all(np.isfinite(np.frombuffer(b, np.float32)).all()
                 for b in card)
    assert finite, "the LM rung geo-round's weights are not finite"
    assert card == host, "the LM rung geo-round: card differs from the CPU"
    log(f"LM geo-round on the merge rung (2 x 2 + 1, int8 + residual, "
        f"{len(shapes)} keys, {big} spread over {k} slots): weights finite "
        f"and bitwise equal to the CPU's; merge_devices "
        f"{stats[0]['merge_devices']}; keys with a residual by server "
        f"{with_res}; {wall:.2f} s on the card")
    out["lm_georound"] = {"keys": len(shapes), "spread_keys": big,
                          "residual_keys_by_server": with_res,
                          "wall_s": wall}
    return out


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
# the CUDA kernels one call of each flash function launches, in order
FLASH_CUDA_KERNELS = {
    "flash_fwd": ["fwd_tc_kernel"], "flash_fwd_f32": ["fwd_f32_tc_kernel"],
    "flash_bwd": ["delta_kernel (with the f32 dQ scratch zeroed)",
                  "bwd_tc_kernel (dK, dV and dQ: five products)",
                  "dq_convert_kernel"],
    "flash_bwd_f32": ["delta_kernel", "dkdv_f32_tc_kernel",
                      "dq_f32_tc_kernel"]}
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


# ---- phase 11: the backend lane on the card -----------------------------

def _load_by_path(name: str, rel: str):
    """A repository test file as a module, loaded by its path: a
    ``tests`` package installed on the machine would shadow the
    repository's namespace package."""
    import importlib.util

    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]



def _lane_runner():
    """``tests/test_torch_runtime_lane_backend.py``."""
    return _load_by_path("torch_runtime_lane",
                         "tests/test_torch_runtime_lane_backend.py")


def run_backend_lane() -> dict:
    """11: the JAX package's in-process runtime suites against the port
    with every server on the card, and C7's MixedSync and catch-up tests
    (``tests/test_torch_mixed_sync.py`` under
    ``GEOMX_MIXED_SYNC_BACKEND=torch``) beside them, in one pytest
    subprocess (CUDA starts once)."""
    import torch

    lane_mod = _lane_runner()
    files = lane_mod.FILES
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "chiprun_out")
    work = os.path.join(out_dir, "chip_smoke_lane")
    os.makedirs(work, exist_ok=True)
    res = lane_mod.run_lane(
        files, "torch", workdir=work, heavy=True, timeout=LANE_TIMEOUT_S,
        extra=(MIXED_SYNC_TESTS,),
        extra_env={"GEOMX_MIXED_SYNC_BACKEND": "torch"})
    with open(os.path.join(out_dir, "chip_smoke_lane.txt"), "w") as f:
        f.write(res.output)
    per_file = res.per_file()
    mixed = os.path.basename(MIXED_SYNC_TESTS)[len("test_"):-len(".py")]
    for name in files + (mixed,):
        row = per_file.get(name, {})
        log(f"lane {name}: {row.get('passed', 0)} passed, "
            f"{row.get('failed', 0)} failed, {row.get('skipped', 0)} "
            f"skipped, {row.get('left_out', 0)} left out")
    log(f"lane on the card (GEOMX_MERGE_BACKEND=torch): {len(files)} "
        f"files and {MIXED_SYNC_TESTS}, "
        f"{sum(r['passed'] for r in per_file.values())} passed, "
        f"{len(res.failed())} failed, rc {res.rc}, {res.wall_s:.1f} s")
    assert res.rc == 0 and not res.failed(), \
        f"backend lane on the card: rc {res.rc}, failed {res.failed()}\n" \
        + res.output[-4000:]
    empty = [n for n in files + (mixed,)
             if not per_file.get(n, {}).get("passed")]
    assert not empty, f"lane files with no case run: {empty}"
    skipped = {n: r["skipped"] for n, r in per_file.items() if r["skipped"]}
    assert not skipped, f"lane cases skipped on the card: {skipped}"
    torch.cuda.empty_cache()
    return {"files": per_file, "failed": res.failed(), "rc": res.rc,
            "seconds": res.wall_s}


# ---- phase 12: the JAX repo's scripts and slow cases on the card --------

def _scripts_runner():
    return _load_by_path("torch_scripts_lane",
                         "tests/test_torch_scripts_lane.py")


class ScriptPool:
    """12a's scripts but the tours of ``SCRIPTS_QUIET`` run in the
    background from the end of phase 3b, ``SCRIPT_STREAMS`` at a time
    on their own port ranges (phases 4-10 gate no time, and run as they
    did beside them; phase 10's timed cases wait for :meth:`join`); the
    quiet tours wait for :meth:`finish`.  Each script is held
    to its own exit code and assertions and every launched cluster to
    its exit lines (every server ``merge_backend=torch``, every worker
    ``steps=``), the bsc config's local servers to 60 DGC updates each,
    the mpq config's to one for each BSC pick.  Every script runs before
    a failure fails the phase."""

    def __init__(self):
        import pathlib
        from concurrent.futures import ThreadPoolExecutor

        from geomx_tpu_torch.ops.kernels import quantize_cuda as C

        assert not C.LIB.stale(), \
            "the codec library is not built: a child process would build it"
        self.lane = _scripts_runner()
        root = os.path.dirname(os.path.abspath(__file__))
        self.out_dir = pathlib.Path(root) / "chiprun_out"
        self.work = self.out_dir / "chip_smoke_scripts"
        self.work.mkdir(parents=True, exist_ok=True)
        names = list(self.lane.RUNNABLE)
        # the longest first: the pool ends with the short configs
        self.pooled = sorted((n for n in names if n not in SCRIPTS_QUIET),
                             key=lambda n: -SCRIPT_WALL_HINT_S.get(n, 30))
        log(f"phase 12a: {len(self.pooled)} scripts {SCRIPT_STREAMS} at once "
            f"in the background; after phase 11 {QUIET_STREAMS} side by "
            f"side, then {QUIET_ALONE} alone")
        self.t0 = time.perf_counter()
        self.results = {}
        self.ex = ThreadPoolExecutor(SCRIPT_STREAMS)
        self.futures = {n: self.ex.submit(self._one, n) for n in self.pooled}

    def _one(self, name):
        res = self.lane.run_script(name, "cuda", workdir=self.work,
                                   timeout=SCRIPT_TIMEOUT_S)
        self.lane.write_output(res, self.out_dir / "chip_smoke")
        log(f"script {self.lane.summary(res)}")
        return res

    def join(self) -> float:
        """Wait for the background scripts; their wall (s)."""
        self.results.update({n: f.result() for n, f in self.futures.items()})
        self.ex.shutdown()
        self.pooled_s = time.perf_counter() - self.t0
        log(f"phase 12a: the background scripts joined after "
            f"{self.pooled_s:.1f} s")
        return self.pooled_s

    def finish(self) -> dict:
        """Run the quiet scripts, then fail on any failed script."""
        from concurrent.futures import ThreadPoolExecutor

        def stream(seq):
            return {n: self._one(n) for n in seq}

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(QUIET_STREAMS)) as ex:
            for done in ex.map(stream, QUIET_STREAMS):
                self.results.update(done)
        self.results.update(stream(QUIET_ALONE))
        quiet_s = time.perf_counter() - t0
        bad = {n: self.lane.summary(r) + "\n" + r.output[-2500:]
               for n, r in self.results.items() if not r.ok()}
        assert not bad, f"scripts failed on the card: {bad}"
        return {"scripts": {n: {"rc": r.rc, "seconds": r.wall_s,
                                "roles": len(r.roles),
                                "codec_launches": r.codec,
                                "kernel_launches": r.kernel_launches}
                            for n, r in self.results.items()},
                "streams": SCRIPT_STREAMS, "quiet_streams": QUIET_STREAMS,
                "quiet_alone": QUIET_ALONE, "pooled_s": self.pooled_s,
                "quiet_s": quiet_s}


def run_trace_counterpart() -> dict:
    """12b: ``examples/trace_demo.py`` (the counterpart of
    ``scripts/run_trace_demo.sh``) on the card: its assertions, and its
    critical-path report printed, each round's dominant stage."""
    from geomx_tpu_torch.examples import trace_demo

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "chip_smoke_trace")
    t0 = time.perf_counter()
    rec = trace_demo.run("cuda", out)
    seconds = time.perf_counter() - t0
    log("trace demo on the card, critical-path report:\n"
        + rec["report_text"])
    dominant = [r["dominant_stage"] for r in rec["report"]["rounds"]]
    log(f"trace demo: {rec['events']} events, roles {rec['roles']}, "
        f"{rec['rounds']} rounds, dominant stages {dominant}, "
        f"{seconds:.1f} s")
    return {"events": rec["events"], "roles": rec["roles"],
            "rounds": rec["report"]["rounds"], "dominant": dominant,
            "seconds": seconds}


def run_slow_lane(cases=None) -> dict:
    """``--slow-lane``: the backend lane's slow mode (the JAX suites'
    soak and kill cases, each in its own pytest subprocess; ``cases``,
    default ``SLOW_CASES``) with ``GEOMX_MERGE_BACKEND=torch``: 0
    failed, 0 skipped.  The kernels must be built."""
    lane_mod = _lane_runner()
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "chiprun_out")
    work = os.path.join(out_dir, "chip_smoke_slow_lane")
    os.makedirs(work, exist_ok=True)
    cases = tuple(cases or lane_mod.SLOW_CASES)
    res = lane_mod.run_slow_cases("torch", workdir=work, cases=cases,
                                  timeout=SLOW_CASE_TIMEOUT_S)
    with open(os.path.join(out_dir, "chip_smoke_slow_lane.txt"), "w") as f:
        f.write(res.output)
    for nid, outcome in res.cases.items():
        log(f"slow lane {nid}: {outcome}, {res.walls.get(nid, 0):.1f} s")
    log(f"slow lane on the card: {len(res.cases)} cases, "
        f"{sum(o == 'passed' for o in res.cases.values())} passed, "
        f"{len(res.failed())} failed, rc {res.rc}, {res.wall_s:.1f} s")
    assert res.rc == 0 and not res.failed() and set(res.cases) == set(
        cases), \
        f"slow lane on the card: rc {res.rc}, failed {res.failed()}\n" \
        + res.output[-4000:]
    skipped = [n for n, o in res.cases.items() if o == "skipped"]
    assert not skipped, f"slow lane cases skipped on the card: {skipped}"
    return {"cases": res.cases, "walls": res.walls, "rc": res.rc,
            "seconds": res.wall_s}


def _codec_iters(n: int) -> int:
    return 20 if n >= 10_000_000 else 500


def c6_probe() -> int:
    """``--c6-probe``: phase 2's timings in the order before C6's repair
    (the flash and block builds still running while the codec kernels
    and the LM sweep are timed, each batch logged with the builds then
    running), then the same timings again after every build has joined.
    Run it twice in one call: from a cold kernel cache (nvcc runs) and
    from a warm one (every build is a load).  Writes
    ``chiprun_out/chip_smoke_c6_<n>.json``."""
    import torch

    from geomx_tpu_torch.core.platform import resolve_device
    from geomx_tpu_torch.ops.kernels import block_attention as KB
    from geomx_tpu_torch.ops.kernels import flash_attention as FK

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device("cuda")
    smi = device_report()
    cold = FK.LIB.stale() or KB.LIB.stale()
    builds = start_cuda_builds()
    builds["codec"].result()
    log(f"c6 probe: kernel cache {'cold' if cold else 'warm'}; nvcc "
        f"running after the codec build: {_nvcc_running(builds) or 'none'}")
    rec = {"nvidia_smi": smi, "cache": "cold" if cold else "warm"}
    check_kernels(dev)          # the parent's order: checks, times, sweep
    rec["during_builds"] = {
        "times": time_kernels(dev, CODEC_TIME_SIZES, _codec_iters, builds,
                              gate=False),
        "sweep": time_lm_sweep(dev, builds, gate=False)}
    rec["build_s"] = {n: f.result() for n, f in builds.items()}
    log(f"c6 probe: builds joined: {rec['build_s']} s")
    rec["after_builds"] = {
        "times": time_kernels(dev, CODEC_TIME_SIZES, _codec_iters, builds,
                              gate=False),
        "sweep": time_lm_sweep(dev, builds, gate=False)}
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    n = 0
    while os.path.exists(os.path.join(root, "chiprun_out",
                                      f"chip_smoke_c6_{n}.json")):
        n += 1
    with open(os.path.join(root, "chiprun_out",
                           f"chip_smoke_c6_{n}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return 0


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
    # C6: no timing while nvcc runs on the host's cores; the correctness
    # checks above may overlap the builds
    log(f"nvcc running after the codec checks: "
        f"{_nvcc_running(builds) or 'none'}")
    build_s = {name: f.result() for name, f in builds.items()}
    log(f"CUDA sources built with nvcc, in parallel: "
        f"{ {n: round(v, 1) for n, v in build_s.items()} } s")
    times = time_kernels(dev, CODEC_TIME_SIZES, _codec_iters, builds)
    sweep = time_lm_sweep(dev, builds)
    log(f"phases 1-2 done in {time.perf_counter() - t0:.1f} s")

    flash = check_flash(dev)
    flash["fixed_order"] = check_flash_ordered(dev)
    flash["config_deterministic"] = check_config_deterministic(dev)
    log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")
    block = check_block(dev)
    log(f"phase 3b done in {time.perf_counter() - t0:.1f} s")
    # the time gates are behind us: phase 12a's load-tolerant scripts
    # start in the background, beside phases 4-10's untimed work
    scripts_pool = ScriptPool()
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
    # GeoMX's own sync modes: no kernel of the table on their path
    for path, extra in (("hfa", HFA_ARGS), ("esync", ESYNC_ARGS)):
        reset_all_launches()
        geo[path] = run_sync_mode(extra)
        geo[path]["launches"] = all_launches()
        log(f"main-path launches under {path}: {geo[path]['launches']}")
    log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    staged = check_staged_lm(dev)
    torch.cuda.empty_cache()
    log(f"phase 7a done in {time.perf_counter() - t0:.1f} s")
    launched = run_launched_clusters()
    log(f"phase 7b done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    moe = check_moe_lm(dev)
    log(f"phase 8a done in {time.perf_counter() - t0:.1f} s")
    moe["georound"] = check_moe_georound("2bit")
    moe["georound_none"] = check_moe_georound("none")
    log(f"phase 8b done in {time.perf_counter() - t0:.1f} s")
    zoo = check_zoo(dev)
    zoo["georound"] = run_zoo_georound()
    log(f"phase 8c done in {time.perf_counter() - t0:.1f} s")
    int8 = check_int8(dev)
    log(f"phase 8d done in {time.perf_counter() - t0:.1f} s")
    par = check_parity(dev)
    log(f"phase 8e done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    tp = check_tp(dev)
    log(f"phase 9a done in {time.perf_counter() - t0:.1f} s")
    pp = check_pp(dev)
    log(f"phase 9b done in {time.perf_counter() - t0:.1f} s")
    dpr = check_dp(dev)
    log(f"phase 9c done in {time.perf_counter() - t0:.1f} s")
    rung = check_merge_rung(dev)
    log(f"phase 9d done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    accept = run_acceptance(before_timed=scripts_pool.join)
    log(f"phase 10 done in {time.perf_counter() - t0:.1f} s "
        f"({accept['seconds']:.1f} s)")
    lane = run_backend_lane()
    log(f"phase 11 done in {time.perf_counter() - t0:.1f} s "
        f"({lane['seconds']:.1f} s)")
    scripts = scripts_pool.finish()
    log(f"phase 12a done in {time.perf_counter() - t0:.1f} s (the "
        f"background scripts {scripts['pooled_s']:.1f} s, the quiet ones "
        f"{scripts['quiet_s']:.1f} s)")
    trace = run_trace_counterpart()
    log(f"phase 12b done in {time.perf_counter() - t0:.1f} s")
    # every path's launches by kernel; the launched LM's DGC updates ran
    # in the local servers' processes, which printed them
    path_launches = {path: rec["launches"] for path, rec in geo.items()}
    path_launches.update(sp=sp["launches"],
                         f32_flash=f32_step["flash"]["launches"],
                         f32_sp_ring=f32_step["sp_ring"]["launches"],
                         staged_lm=staged["launches"])
    path_launches["launched_lm_mpq_local_servers"] = {"dgc_update": sum(
        launched["lm_mpq"]["dgc_update_by_server"].values())}
    # phase 10's MPQ cases: the DGC updates of their local servers
    for name, rec in accept["cases"].items():
        if "dgc_update_by_server" in rec:
            path_launches[f"accept_{name}_local_servers"] = {
                "dgc_update": sum(rec["dgc_update_by_server"].values())}
    # phase 12: the scripts' servers (their own processes) and the
    # in-process adaptive demo
    for name, rec in scripts["scripts"].items():
        local = {r: c for r, c in rec["codec_launches"].items()
                 if r.startswith("server:")}
        if local:
            path_launches[f"script_{name[:-3]}_local_servers"] = {
                k: sum(c.get(k, 0) for c in local.values())
                for k in ("quantize_2bit", "dequantize_2bit", "dgc_update")}
        if rec["kernel_launches"]:
            path_launches[f"script_{name[:-3]}"] = rec["kernel_launches"]
    path_launches.update(moe_lm=moe["georound"]["launches"],
                         moe_lm_none=moe["georound_none"]["launches"],
                         zoo_resnet_bsc=zoo["georound"]["launches"],
                         parity=par["launches"])
    # phase 9: the meshes' paths, every rank on the one card
    path_launches.update(tp_dp2_tp2=tp["tp_flash"]["launches"],
                         tp_ring_dp2_sp2_tp2=tp["tp_ring"]["launches"],
                         moe_tp_ring=tp["moe"]["launches"],
                         pp_pp2_dp2=pp["launches"],
                         pp_hips=pp["hips"]["launches"],
                         dp_party_step=dpr["launches"],
                         dp_hips_2bit=dpr["hips"]["launches"])
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
                     "cuda_kernels": FLASH_CUDA_KERNELS[name],
                     "device_ms_by_kernel": {
                         "lm": flash["by_shape"][f"{main_shape} {dt}"][
                             f"{fn}_device_ms"],
                         "mfu": flash["by_shape"][f"{mfu_shape} {dt}"][
                             f"{fn}_device_ms"]},
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
            "launches_by_path": {p: c[name] for p, c in path_launches.items()
                                 if c.get(name)},
            **where})
    report = {"nvidia_smi": smi, "kernels": rows, "build_s": build_s,
              "times_by_size": {str(n): v for n, v in times.items()},
              "lm_push_sweep": sweep,
              "flash": flash, "block": block, "full_width_step": full,
              "sp_step": sp, "f32_step": f32_step,
              "georound": geo, "staged_lm": staged, "launched": launched,
              "moe_lm": moe, "zoo": zoo, "int8": int8, "parity": par,
              "parallel": {"tp": tp, "pp": pp, "dp": dpr,
                           "merge_rung": rung},
              "acceptance": accept, "backend_lane": lane,
              "scripts": scripts, "trace_demo": trace,
              "seconds": time.perf_counter() - t0}
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def slow_lane_main(argv) -> int:
    """``--slow-lane [NODE_ID ...]``: build the kernels, then
    :func:`run_slow_lane` on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device_report()
    for f in start_cuda_builds().values():
        f.result()
    rec = run_slow_lane(argv or None)
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "chiprun_out",
                           "chip_smoke_slow_lane.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--c6-probe"], ["--slow-lane"]):
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(c6_probe() if sys.argv[1] == "--c6-probe"
                 else slow_lane_main(sys.argv[2:]))
    sys.exit(main())
