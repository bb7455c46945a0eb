// Causal flash attention for Hopper (sm_90a): forward, and the backward
// as a delta pass (delta = rowsum(dO * O)) and, in bf16, one kernel for
// dK, dV and dQ and a pass that rounds dQ, in f32 a dK/dV and a dQ kernel.
//
// Replaces JAX's bundled Pallas TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention, called by
// geomx_tpu/models/transformer.py:245-251 when attn_impl="flash"): its
// forward kernel and its dK/dV and dQ backward kernels.  The plain
// PyTorch versions are flash_attention_ref / flash_attention_bwd_ref in
// geomx_tpu_torch/ops/flash_attention.py; the ctypes binding and the
// build are in geomx_tpu_torch/ops/kernels/flash_attention.py.
//
// Layout: q, k, v, o, dO are [B, T, H, D] with D contiguous (row (b,t,h)
// at b*sb + t*st + h*sh), in f32 or bf16; lse and delta are f32
// [B, H, T].  D is 64 or 128.  Causal: query t sees keys 0..t.
//
// Numerics, as JAX's kernel: scores and the softmax in f32; the forward
// rounds p to the input type against the running max (unnormalised)
// before the PV product and divides by the row sum at the end; the
// backward recomputes p = exp(s*scale - lse) in f32, rounds p before
// dV += p^T dO (JAX's flash_attention.py:900), and rounds
// ds*scale = p*(dP - delta)*scale before dK += ds^T Q and dQ += ds K
// (:911-918, :1243-1261); dK and dQ are stored with no further scale.
// Every product accumulates in f32.  In f32 the roundings are the
// identity.
//
// What bounds it on an H100.  A causal pass does 2*B*H*T(T+1)*D flops
// (forward, two products; the backward five products, 2.5x that) on
// 4*B*T*H*D input and output elements (backward 8).  At the flagship
// LM's (8,128,6,64) that is ~32 flops a byte in bf16, below the card's
// ~295 bf16 tensor-core flops per byte of HBM traffic: bytes and launch
// latency bound it (~1 us forward, ~2 us backward by bytes).  At the MFU
// config's (4,2048,16,128) it is ~510 flops a byte: operations, 69 us
// forward and 174 us backward on the tensor cores at 989 TFLOP/s.
//
// bf16: tensor cores (wgmma) fed by TMA.  Each block has one producer
// warp, which issues every copy (TMA boxes of 64 columns x 64 or 128
// rows, 128-byte swizzle, rows past T zero-filled) into a 2-stage ring
// of shared-memory tiles guarded by full/empty mbarriers, and one or two
// consumer warpgroups of 64 rows each (the tile machinery is in
// hopper_tiles.cuh).  The producer warp is the first of a warpgroup
// whose other three exit at once: with two consumers, setmaxnreg moves
// that warpgroup's registers to the consumers' accumulators.  A consumer forms scores with wgmma from shared
// memory (both operands K-major), does the softmax on the f32
// accumulator fragment (a row lives in the 4 lanes of a quad, so row
// max and sum are two __shfl_xor steps), and feeds the rounded
// probabilities from its registers as the A operand of the next
// product, whose B operand (V, dO, Q or K) is read MN-major from the
// same tiles.  No operand goes back to shared memory: the dK/dV kernel
// forms S^T = K Q^T and dP^T = V dO^T, whose fragments are already the
// A operands of dV += P^T dO and dK += dS^T Q.
//   * forward: one block per (query tile, b*h), the longest rows first;
//     key tiles of 128, tiles above the diagonal skipped, only tiles
//     that cross the diagonal or T masked;
//   * backward: delta_kernel (which also zeroes an f32 dQ scratch), then
//     one block per key tile (queries from the diagonal down, 64 at a
//     step) forming dK, dV and each step's dQ partial in five products,
//     the partials added into the scratch by TMA's reduce-add (in an
//     order that may change from run to run, or, on the fixed-order
//     path, in ascending key tiles), then dq_convert_kernel
//     (bwd_tc_kernel, below);
//   * tile height: two consumer warpgroups (128-row tiles) when the grid
//     of 128-row tiles covers every SM once, else one (64-row tiles,
//     twice the blocks): the LM's T = 128 gives 48 tiles of 128 for 132
//     SMs, so it runs 96 blocks of 64 rows (each choice is the faster one
//     at the shapes that take it: examples/time_flash_tiles.py);
//   * masked scores are -inf before the max; key 0 is visible to every
//     row and lies in the first tile, so the running max is finite from
//     the first tile on and no exp(-inf - (-inf)) is formed.
// f32 forward (fwd_f32_tc_kernel): the tensor cores too, with every
// product to f32 accuracy, the port's f32 convention: three TF32 wgmma
// products of split operands (3xTF32, hopper_tiles.cuh; a single TF32
// product, ~2^-10, is not allowed).  Its bound at the MFU shape is then
// 3 x 68.7 GFLOP at 495 TF32 TFLOP/s, 0.417 ms (on FMAs at 67 f32
// TFLOP/s it was 1.026 ms, too near a library call's time in f32 for
// any FMA kernel to beat it clearly).  The block is
// hopper_tiles.cuh's Tf32Pipe: one warp issues the TMA copies (f32,
// 32-column boxes) into a 2-stage ring; three warps split Q once and
// each K tile into hi and lo and transpose V into Vt (TF32 takes K-major
// operands only) into a second 2-stage ring, a step ahead of the
// products; one consumer warpgroup (64 query rows: the shared-memory
// budget leaves no room for a second at D = 128) forms S in three
// products, keeps the bf16 forward's online softmax (-inf masking, the
// longest rows first, tiles above the diagonal skipped) and feeds p from
// its registers, split, into three P V products, each step's into a
// fresh accumulator added to O in f32.  Key steps of 32 (the budget
// again).
// f32 backward (delta_kernel, dkdv_f32_tc_kernel, dq_f32_tc_kernel): the
// same convention and the same roles (BwdF32Pipe, below), with dS scaled
// before its products as in bf16.  Seven products of three TF32 wgmma
// each (no atomics: S and dP are formed in both kernels): 3 x 171.9
// GFLOP at the MFU shape is 1.042 ms at 495 TF32 TFLOP/s, 7/5 of it
// 1.46 ms.  Shared memory bounds the steps: 16 rows at D = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <chrono>

#include "hopper_tiles.cuh"

namespace {

constexpr int NT = 256;      // threads a block of delta_kernel, dq_convert

struct Strides {
  int64_t b, t, h;   // elements between rows of b, t and h
};

// blocks of NT threads for `items` items a thread: at most 8 blocks an
// SM (full occupancy), the rest taken by grid-stride loops
unsigned grid_for(int64_t items) {
  const int64_t cap = int64_t(hopper::sm_count()) * 8;
  const int64_t grid = (items + NT - 1) / NT;
  return unsigned(grid < 1 ? 1 : grid < cap ? grid : cap);
}

// ---- backward: delta = rowsum(dO * O); the f32 dQ scratch zeroed --------
//
// Bound by bytes: O and dO read once (and, in bf16, the f32 dQ scratch
// written once), delta written.  A lane loads 16 bytes of O and of dO a
// round (__ldg), D*ES/16 lanes share a row (8, 16 or 32), so a
// warp takes 32*16/(D*ES) rows a round; rows in memory order, so a warp's
// loads are 512 contiguous bytes; the grid is grid_for's (grid-stride).
// Lanes of a row sum by __shfl_xor.  dq_acc (f32 [B, T, H, D], the same
// element strides) is zeroed beside O's row when not null.

template <typename E>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b);
template <>
__device__ __forceinline__ float dot16<float>(const uint4& a,
                                              const uint4& b) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) +
         __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) +
         __uint_as_float(a.w) * __uint_as_float(b.w);
}
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(const uint4& a,
                                                      const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    acc += u.x * v.x + u.y * v.y;
  }
  return acc;
}

template <typename E, int D>
__global__ void __launch_bounds__(NT)
delta_kernel(const E* __restrict__ o, const E* __restrict__ dout,
             float* __restrict__ delta, float* __restrict__ dq_acc, int B,
             int H, int n, Strides s) {
  constexpr int EPL = 16 / int(sizeof(E));     // elements a lane
  constexpr int LPR = D / EPL;                 // lanes a row
  constexpr int RPW = 32 / LPR;                // rows a warp a round
  const int64_t rows = int64_t(B) * n * H;
  const int lane = threadIdx.x & 31, l = lane % LPR;
  const int64_t warps = int64_t(gridDim.x) * (NT / 32);
  for (int64_t r0 = (int64_t(blockIdx.x) * NT + threadIdx.x) / 32 * RPW;
       r0 < rows; r0 += warps * RPW) {        // warp-uniform
    const int64_t row = r0 + lane / LPR;
    const int h = int(row % H);
    const int t = int((row / H) % n);
    const int b = int(row / (int64_t(H) * n));
    const int64_t off = b * s.b + t * s.t + h * s.h + l * EPL;
    float acc = 0.f;
    if (row < rows) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + off));
      const uint4 c = __ldg(reinterpret_cast<const uint4*>(dout + off));
      acc = dot16<E>(a, c);
      if (dq_acc != nullptr) {
#pragma unroll
        for (int z = 0; z < EPL / 4; ++z)
          reinterpret_cast<float4*>(dq_acc + off)[z] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int w = LPR / 2; w > 0; w >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (row < rows && l == 0) delta[(int64_t(b) * H + h) * n + t] = acc;
  }
}

template <typename E, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         float* dq_acc, int B, int H, int n, Strides s,
                         cudaStream_t stream) {
  constexpr int LPR = D * int(sizeof(E)) / 16;
  const int64_t lanes = int64_t(B) * n * H * LPR;
  delta_kernel<E, D><<<grid_for(lanes), NT, 0, stream>>>(
      static_cast<const E*>(o), static_cast<const E*>(dout), delta, dq_acc,
      B, H, n, s);
  return cudaGetLastError();
}

// ---- backward, bf16: dQ rounded once from its f32 sum --------------------
//
// Bound by bytes (the f32 sum read, bf16 written); 8 elements a thread a
// round, 32-byte loads and a 16-byte store; grid_for's grid.
__global__ void __launch_bounds__(NT)
dq_convert_kernel(const float4* __restrict__ acc, uint4* __restrict__ dq,
                  int64_t n8) {
  for (int64_t i = int64_t(blockIdx.x) * NT + threadIdx.x; i < n8;
       i += int64_t(gridDim.x) * NT) {
    const float4 a = acc[2 * i], b = acc[2 * i + 1];
    uint4 out;
    out.x = hopper::pack_bf16(a.x, a.y);
    out.y = hopper::pack_bf16(a.z, a.w);
    out.z = hopper::pack_bf16(b.x, b.y);
    out.w = hopper::pack_bf16(b.z, b.w);
    dq[i] = out;
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

using hopper::align1024;
using hopper::consumer_regs;
using hopper::fence_frags;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_tx;
using hopper::mbar_wait;
using hopper::pack_frags;
using hopper::producer_regs;
using hopper::smem_desc_k;
using hopper::smem_desc_mn;
using hopper::tc_threads;
using hopper::tma_load_tile;
using hopper::two_warpgroups;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs;
using hopper::wgmma_ss;
using hopper::wgmma_wait;
using hopper::zero_regs;
typedef __nv_bfloat16 bf16;

constexpr int ST = 2;        // stages of the copy ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// rows 8i apart (i = 0, 1) of a 64-row accumulator: dst row base + the
// thread's columns 8j + 2q, +1, rounded to bf16
template <int D>
__device__ __forceinline__ void store_frag_row(bf16* row,
                                               const float (&d)[D / 2],
                                               int i, int qd, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * qd) =
        __floats2bfloat162_rn(d[4 * j + 2 * i] * mul,
                              d[4 * j + 2 * i + 1] * mul);
}

// ---- bf16 forward ------------------------------------------------------------

template <int D, int NWG>
struct FwdTc {
  static constexpr int BM = 64 * NWG;      // query rows a block
  static constexpr int BN = 128;           // keys a step
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES +
                              8 * (1 + 2 * ST);
};

template <int D, int NWG>
__global__ void __launch_bounds__(tc_threads(NWG), 1)
fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
              float* __restrict__ lse, int H, int n, Strides s,
              float scale) {
  using L = FwdTc<D, NWG>;
  constexpr int BM = L::BM, BN = L::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + L::Q_BYTES;               // ST stages
  uint8_t* Vs = Ks + ST * L::KV_BYTES;         // ST stages
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * L::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int nt = (n + BM - 1) / BM;
  const int qt = nt - 1 - blockIdx.x;          // the longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BM;
  const int n_kt = min(q0 + BM - 1, n - 1) / BN + 1;   // tiles 0..diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4 * NWG);   // one arrival a warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {                       // the producer warpgroup
    producer_regs<NWG>();
    if (warp == 4 * NWG && lane == 0) {
      mbar_arrive_tx(q_full, L::Q_BYTES);
      tma_load_tile<D>(Qs, &tq, q_full, BM, q0, h, b);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % ST;
        mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], 2 * L::KV_BYTES);
        tma_load_tile<D>(Ks + st * L::KV_BYTES, &tk, &full[st], BN, it * BN,
                         h, b);
        tma_load_tile<D>(Vs + st * L::KV_BYTES, &tv, &full[st], BN, it * BN,
                         h, b);
      }
    }
    return;
  }

  consumer_regs<NWG>();
  const int wg = warp / 4, qd = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;   // tile row, i = 0
  const float sl2 = scale * LOG2E;             // exp(x) = exp2(x log2 e)
  float sacc[BN / 2], oacc[D / 2];
  zero_regs(sacc);
  zero_regs(oacc);
  float m2[2] = {-INFINITY, -INFINITY};        // running max, log2 units
  float l[2] = {0.f, 0.f};                     // this thread's partial sums
  uint32_t pa[BN / 16][4];

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % ST, k0 = it * BN;
    const uint8_t* Kt = Ks + st * L::KV_BYTES;
    const uint8_t* Vt = Vs + st * L::KV_BYTES;
    mbar_wait(&full[st], (it / ST) & 1);

    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN>(sacc, smem_desc_k(Qs, BM, 64 * wg, kk),
                   smem_desc_k(Kt, BN, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // mask keys past the diagonal or past T (warp-uniform test)
    if (k0 + BN - 1 > q0 + 64 * wg || k0 + BN > n) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kc = k0 + 8 * j + 2 * qd + c, qi = q0 + r0 + 8 * i;
            if (kc > qi || kc >= n) sacc[4 * j + 2 * i + c] = -INFINITY;
          }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mt = fmaxf(mt, fmaxf(sacc[4 * j + 2 * i], sacc[4 * j + 2 * i + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m2[i], mt * sl2);   // finite from tile 0 on
      alpha[i] = exp2f(m2[i] - mn);              // 0 on the first tile
      m2[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sacc[4 * j + 2 * i + c];
          x = exp2f(fmaf(x, sl2, -m2[i]));       // masked: exp2(-inf) = 0
          l[i] += x;
        }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        oacc[4 * j + 2 * i] *= alpha[i];
        oacc[4 * j + 2 * i + 1] *= alpha[i];
      }
    pack_frags<BN>(pa, sacc);                    // p rounded to bf16

    fence_frags(pa);
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(oacc, pa[kk], smem_desc_mn(Vt, BN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = q0 + r0 + 8 * i;
    if (qi < n) {
      store_frag_row<D>(o + b * s.b + h * s.h + int64_t(qi) * s.t, oacc, i,
                        qd, 1.f / l[i]);
      if (qd == 0) lse[int64_t(bh) * n + qi] = m2[i] * LN2 + logf(l[i]);
    }
  }
}

// ---- f32 forward: 3xTF32 on the tensor cores ------------------------------

template <int D>
__global__ void __launch_bounds__(tc_threads(1), 1)
fwd_f32_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ o, float* __restrict__ lse, int H,
                  int n, Strides s, float scale) {
  using L = hopper::Tf32Tiles<D>;
  constexpr int BM = L::BM, BN = L::BN, ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  const hopper::Tf32Pipe<D> pp(smem_raw);

  const int nt = (n + BM - 1) / BM;
  const int qt = nt - 1 - blockIdx.x;          // the longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BM;
  const int n_kt = min(q0 + BM - 1, n - 1) / BN + 1;   // tiles 0..diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) pp.init();
  __syncthreads();
  if (warp == 4) {                             // the copies
    if (lane == 0) pp.produce(&tq, &tk, &tv, q0, h, b, n_kt, true);
    return;
  }
  if (warp > 4) {                              // the splits
    pp.convert(n_kt, true, threadIdx.x - 5 * 32);
    return;
  }

  const int qd = lane % 4;
  const int r0 = 16 * warp + lane / 4;         // tile row, i = 0
  const float sl2 = scale * LOG2E;             // exp(x) = exp2(x log2 e)
  float sacc[BN / 2], oacc[D / 2];
  zero_regs(oacc);
  float m2[2] = {-INFINITY, -INFINITY};        // running max, log2 units
  float l[2] = {0.f, 0.f};                     // this thread's partial sums
  uint32_t qa[D / 8][4], phi[BN / 8][4], plo[BN / 8][4];

  mbar_wait(pp.q_ready, 0);
  hopper::load_q_frags<D>(qa, pp.q, BM);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % ST, k0 = it * BN;
    mbar_wait(&pp.cv_full[st], (it / ST) & 1);
    hopper::qk_tf32x3<D, BN>(sacc, qa, pp.q_lo, BM, pp.stage(pp.k, it),
                             pp.stage(pp.k_lo, it));
    if (lane == 0) mbar_arrive(&pp.empty[st]);   // K is read

    // mask keys past the diagonal or past T (warp-uniform test)
    if (k0 + BN - 1 > q0 + 16 * warp || k0 + BN > n) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kc = k0 + 8 * j + 2 * qd + c, qi = q0 + r0 + 8 * i;
            if (kc > qi || kc >= n) sacc[4 * j + 2 * i + c] = -INFINITY;
          }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mt = fmaxf(mt, fmaxf(sacc[4 * j + 2 * i], sacc[4 * j + 2 * i + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m2[i], mt * sl2);   // finite from tile 0 on
      alpha[i] = exp2f(m2[i] - mn);              // 0 on the first tile
      m2[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sacc[4 * j + 2 * i + c];
          x = exp2f(fmaf(x, sl2, -m2[i]));       // masked: exp2(-inf) = 0
          l[i] += x;
        }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        oacc[4 * j + 2 * i] *= alpha[i];
        oacc[4 * j + 2 * i + 1] *= alpha[i];
      }
    hopper::split_frags<BN>(phi, plo, sacc);
    hopper::pv_tf32x3<D, BN>(oacc, phi, plo, pp.stage(pp.vt, it),
                             pp.stage(pp.vt_lo, it));
    if (lane == 0) mbar_arrive(&pp.cv_empty[st]);   // K_lo, Vt are read
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = q0 + r0 + 8 * i;
    if (qi < n) {
      float* row = o + b * s.b + h * s.h + int64_t(qi) * s.t + 2 * qd;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(oacc[4 * j + 2 * i] * inv,
                        oacc[4 * j + 2 * i + 1] * inv);
      if (qd == 0) lse[int64_t(bh) * n + qi] = m2[i] * LN2 + logf(l[i]);
    }
  }
}

// ---- f32 backward: 3xTF32 on the tensor cores ------------------------------
//
// Both kernels run one plan (BwdF32Pipe).  A block holds a resident
// 64-row pair (X, Y) with its lo -- K and V for dK/dV, Q and dO for dQ --
// and streams STEP-row pairs (A, B) -- Q and dO for dK/dV, K and V for
// dQ.  Its first two products, S = X A^T and P = Y B^T (S^T and dP^T, or
// S and dP), are K-major along D on both sides.  Each streamed tile lands
// in the first STEP rows of 2*STEP-row boxes and its lo goes to the last
// STEP, so one wgmma of N = 2*STEP forms hi hi' and hi lo' together
// (X [A; A_lo]^T) and a second, of N = STEP, forms lo hi' (X_lo A^T): two
// instructions a depth step for three products, each part summed apart
// and added in f32.  At N = 16 a TF32 wgmma costs nearly as much as at
// N = 32, so the number of wgmma issued, not the bytes of their
// operands, bounds the S and dP products; pairing takes a third away.
//
// The products that reduce over the stream's rows need its transposes,
// since TF32 takes K-major operands only: the converter warps write A^T
// (and for dK/dV B^T) as hi and lo, keys in the order 0 2 4 6 1 3 5 7 of
// each 8, so the first products' accumulators are the A fragments of
// the next (split_frags):
//   * dK/dV (one block per 64-key tile, queries from the diagonal down):
//     dV += P^T dO against dO^T, dK += (dS scale)^T Q against Q^T;
//   * dQ (one block per 64-query tile, the longest rows first, keys up
//     to the diagonal): dQ += (dS scale) K against K^T, with Q's hi held
//     in registers as the A operand of S (load_q_frags).
// Each step's product goes into a fresh accumulator added to dK, dV or dQ
// in f32 (pv_tf32x3), so the tensor cores' accumulation never sees a
// running sum over the sequence.
//
// Roles: warps 0-3, one consumer warpgroup; warp 4 issues the TMA copies
// (X and Y once, then a ring of ST stages of A and B); warps 5-7 split X
// and Y once, then each landed stage's lo beside it and, after that, the
// transposes (a ring of two stages, which at STEP = 16 share one tile:
// positions 0-15 and 16-31 of its 128-byte rows).  Shared memory at
// D = 128 (a row is 512 bytes): X, X_lo, Y, Y_lo 128 KB; a stage of A,
// A_lo, B, B_lo 32 KB; the transposes 32 KB a tensor (hi and lo, both
// stages).  dK/dV transposes A and B: 128 + 32 + 64 = 224 KB, so one
// stage and STEP = 16; dQ transposes A only: two stages.  At D = 64
// everything halves, and STEP = 32 with two stages.

template <int D, int NTR>   // NTR: streamed tensors transposed (2 or 1)
struct BwdF32Pipe {
  static constexpr int R = 64;                  // resident rows
  static constexpr int STEP = D == 128 ? 16 : 32;
  static constexpr int ST = (D == 128 && NTR == 2) ? 1 : 2;
  static constexpr int NCV = 96;                // converter threads
  static constexpr int RES_BYTES = R * D * 4;
  static constexpr int STEP_BYTES = STEP * D * 4;
  static constexpr int PAIR_BYTES = 2 * STEP_BYTES;   // a tile and its lo
  static constexpr int T_BYTES = 2 * STEP_BYTES;      // both stages
  static constexpr int N_BARS = 2 + 3 * ST + 4;
  static constexpr int SMEM = 1024 + 4 * RES_BYTES + 2 * ST * PAIR_BYTES +
                              2 * NTR * T_BYTES + 8 * N_BARS;
  static_assert(SMEM <= 232448, "f32 backward tiles exceed shared memory");

  uint8_t *x, *x_lo, *y, *y_lo;       // resident
  uint8_t *a, *b;                     // ST stages of [tile; lo] boxes
  uint8_t *at, *at_lo, *bt, *bt_lo;   // transposes, two stages each
  uint64_t *x_full, *x_ready;         // X, Y landed; split
  uint64_t *full, *lo_full, *empty;   // A, B landed; lo written; read
  uint64_t *t_full, *t_empty;         // transposes written; read

  __device__ explicit BwdF32Pipe(uint8_t* raw) {
    x = align1024(raw);
    x_lo = x + RES_BYTES;
    y = x_lo + RES_BYTES;
    y_lo = y + RES_BYTES;
    a = y_lo + RES_BYTES;
    b = a + ST * PAIR_BYTES;
    at = b + ST * PAIR_BYTES;
    at_lo = at + T_BYTES;
    bt = at_lo + T_BYTES;                       // unused when NTR == 1
    bt_lo = bt + T_BYTES;
    x_full = reinterpret_cast<uint64_t*>(at + 2 * NTR * T_BYTES);
    x_ready = x_full + 1;
    full = x_ready + 1;
    lo_full = full + ST;
    empty = lo_full + ST;
    t_full = empty + ST;
    t_empty = t_full + 2;
  }

  // by thread 0, before a __syncthreads
  __device__ void init() const {
    hopper::mbar_init(x_full, 1);
    hopper::mbar_init(x_ready, NCV);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&lo_full[i], NCV);
      hopper::mbar_init(&empty[i], 4 + NCV);   // consumer warps, converters
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&t_full[i], NCV);
      hopper::mbar_init(&t_empty[i], 4);
    }
    hopper::mbar_init_fence();
  }

  __device__ static int ph(int it, int st) { return (it / st) & 1; }

  __device__ uint8_t* stage(uint8_t* ring, int it) const {
    return ring + (it % ST) * PAIR_BYTES;
  }

  // warp 4, lane 0: X, Y (rows r0 ..) once, then A, B of each step (rows
  // s0 + it * STEP ..) into the first STEP rows of their boxes
  __device__ void produce(const CUtensorMap* tx, const CUtensorMap* ty,
                          const CUtensorMap* ta, const CUtensorMap* tb,
                          int r0, int s0, int h, int bi,
                          int n_it) const {
    mbar_arrive_tx(x_full, 2 * RES_BYTES);
    tma_load_tile<D, 4>(x, tx, x_full, R, r0, h, bi);
    tma_load_tile<D, 4>(y, ty, x_full, R, r0, h, bi);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % ST;
      mbar_wait(&empty[st], ph(it, ST) ^ 1);
      mbar_arrive_tx(&full[st], 2 * STEP_BYTES);
      const int row = s0 + it * STEP;
      tma_load_tile<D, 4>(stage(a, it), ta, &full[st], STEP, row, h, bi,
                          2 * STEP);
      tma_load_tile<D, 4>(stage(b, it), tb, &full[st], STEP, row, h, bi,
                          2 * STEP);
    }
  }

  // the lo of stage it's A and B into the last STEP rows of each box, by
  // thread t of NCV: four 16-byte chunks a round, loaded before any is
  // stored
  __device__ void split_pairs(int it, int t) const {
    constexpr int HALF = STEP * 128;            // bytes of a box's rows
    constexpr int CH = 2 * STEP_BYTES / 16;     // chunks of A and B
    uint8_t* const ta = stage(a, it);
    uint8_t* const tb = stage(b, it);
    for (int c0 = t; c0 < CH; c0 += 4 * NCV) {
      float4 v[4];
      uint8_t* hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 16 * (c0 + u * NCV);     // byte of A, then of B
        const int j = i % STEP_BYTES;
        hi[u] = (i < STEP_BYTES ? ta : tb) + (j / HALF) * 2 * HALF +
                j % HALF;
        if (c0 + u * NCV < CH) v[u] = *reinterpret_cast<const float4*>(hi[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * NCV < CH) {
          uint4 h, l;
          hopper::split_tf32(v[u].x, h.x, l.x);
          hopper::split_tf32(v[u].y, h.y, l.y);
          hopper::split_tf32(v[u].z, h.z, l.z);
          hopper::split_tf32(v[u].w, h.w, l.w);
          *reinterpret_cast<uint4*>(hi[u] + HALF) = l;
        }
    }
  }

  // warps 5-7 (t = 0 .. NCV-1): X_lo, Y_lo once; then for each step the
  // lo of A and B and the transposes; each made visible to wgmma before
  // it is announced
  __device__ void convert(int n_it, int t) const {
    mbar_wait(x_full, 0);
    hopper::split_tile(x, x_lo, RES_BYTES, t, NCV);
    hopper::split_tile(y, y_lo, RES_BYTES, t, NCV);
    hopper::fence_async_smem();
    mbar_arrive(x_ready);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % ST, s = it & 1;
      uint8_t* ar = stage(a, it);
      uint8_t* br = stage(b, it);
      mbar_wait(&full[st], ph(it, ST));
      split_pairs(it, t);
      hopper::fence_async_smem();
      mbar_arrive(&lo_full[st]);
      mbar_wait(&t_empty[s], ph(it, 2) ^ 1);
      constexpr int UNITS = STEP / 4 * (D / 4);   // a tile's transpose
      for (int u = t; u < NTR * UNITS; u += NCV) {
        const bool second = u >= UNITS;          // B's (NTR == 2)
        hopper::split_transpose_unit<D, STEP>(
            second ? br : ar, second ? bt : at, second ? bt_lo : at_lo,
            u - (second ? UNITS : 0), s * STEP, 2 * STEP);
      }
      hopper::fence_async_smem();
      mbar_arrive(&t_full[s]);
      mbar_arrive(&empty[st]);
    }
  }

  // the consumer warpgroup: wait for step it's lo and form S = X A^T and
  // P = Y B^T (3xTF32 each, see above); X's hi from registers (xa, as
  // load_q_frags reads it) when XREG.  On return the stage is released.
  template <bool XREG>
  __device__ void products(int it, float (&s)[STEP / 2],
                           float (&p)[STEP / 2],
                           const uint32_t (*xa)[4] = nullptr) const {
    const int st = it % ST;
    const uint8_t* A = stage(a, it);
    const uint8_t* B = stage(b, it);
    float s2[STEP], p2[STEP];   // [hi hi' | hi lo'], N = 2 STEP
    mbar_wait(&lo_full[st], ph(it, ST));
    zero_regs(s2);
    zero_regs(s);
    zero_regs(p2);
    zero_regs(p);
    fence_regs(s2);
    fence_regs(s);
    fence_regs(p2);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      if constexpr (XREG)
        hopper::wgmma_tf32_rs<2 * STEP>(s2, xa[kk],
                                        smem_desc_k(A, 2 * STEP, 0, kk));
      else
        hopper::wgmma_tf32_ss<2 * STEP>(s2, smem_desc_k(x, R, 0, kk),
                                        smem_desc_k(A, 2 * STEP, 0, kk), 1);
      hopper::wgmma_tf32_ss<STEP>(s, smem_desc_k(x_lo, R, 0, kk),
                                  smem_desc_k(A, 2 * STEP, 0, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      hopper::wgmma_tf32_ss<2 * STEP>(p2, smem_desc_k(y, R, 0, kk),
                                      smem_desc_k(B, 2 * STEP, 0, kk), 1);
      hopper::wgmma_tf32_ss<STEP>(p, smem_desc_k(y_lo, R, 0, kk),
                                  smem_desc_k(B, 2 * STEP, 0, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s2);
    fence_regs(s);
    fence_regs(p2);
    fence_regs(p);
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[st]);
    // columns c of s2 and p2 hold hi hi', columns STEP + c hi lo'
#pragma unroll
    for (int e = 0; e < STEP / 2; ++e) {
      s[e] = (s2[e + STEP / 2] + s[e]) + s2[e];
      p[e] = (p2[e + STEP / 2] + p[e]) + p2[e];
    }
  }

  // acc += F T in three TF32 products over the step's rows, F the
  // fragments of a first product (split_frags), T the step's transpose
  // of A (which = 0) or B (which = 1); the fresh accumulator spans all D
  // columns in dK/dV (one wait a product, not two) and 64 in dQ, whose
  // registers also hold Q's hi
  __device__ void accumulate(int it, float (&acc)[D / 2],
                             uint32_t (&hi)[STEP / 8][4],
                             uint32_t (&lo)[STEP / 8][4], int which) const {
    const int s = it & 1;
    mbar_wait(&t_full[s], ph(it, 2));
    hopper::pv_tf32x3<D, STEP, NTR == 2 ? D : 64>(
        acc, hi, lo, which ? bt : at, which ? bt_lo : at_lo, s * STEP / 8);
  }

  __device__ void release_t(int it) const {
    if (threadIdx.x % 32 == 0) mbar_arrive(&t_empty[it & 1]);
  }
};

// rows 8i apart (i = 0, 1) of a 64-row f32 accumulator: the thread's
// columns 8j + 2q, +1 of dst row `row`
template <int D>
__device__ __forceinline__ void store_f32_row(float* row,
                                              const float (&d)[D / 2], int i,
                                              int qd) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<float2*>(row + 8 * j + 2 * qd) =
        make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
}

// ---- f32 backward: dK, dV (one block per key tile) -------------------------

template <int D>
__global__ void __launch_bounds__(tc_threads(1), 1)
dkdv_f32_tc_kernel(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int H, int n, Strides s,
                   float scale) {
  using P = BwdF32Pipe<D, 2>;
  constexpr int STEP = P::STEP;
  extern __shared__ uint8_t smem_raw[];
  const P pp(smem_raw);

  const int kt = blockIdx.x;                   // low key tiles: most work
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * P::R;
  const int n_it = (n + STEP - 1) / STEP - k0 / STEP;   // diagonal down
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) pp.init();
  __syncthreads();
  if (warp == 4) {                             // the copies
    if (lane == 0) pp.produce(&tk, &tv, &tq, &tdo, k0, k0, h, b, n_it);
    return;
  }
  if (warp > 4) {                              // the splits
    pp.convert(n_it, threadIdx.x - 5 * 32);
    return;
  }

  const int qd = lane % 4;
  const int kr = 16 * warp + lane / 4;         // tile key, i = 0
  const float sl2 = scale * LOG2E;
  const float* lse_bh = lse + int64_t(bh) * n;
  const float* del_bh = delta + int64_t(bh) * n;
  float sacc[STEP / 2], pacc[STEP / 2];        // S^T, dP^T: keys x queries
  float dvacc[D / 2], dkacc[D / 2];
  zero_regs(dvacc);
  zero_regs(dkacc);
  uint32_t fhi[STEP / 8][4], flo[STEP / 8][4];

  mbar_wait(pp.x_ready, 0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = k0 + it * STEP;
    // lse and delta of the thread's queries 8j + 2qd + c, loaded ahead of
    // the products and used after them; 0 past T
    float l2[STEP / 8][2], dl[STEP / 8][2];
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = q0 + 8 * j + 2 * qd + c;
        l2[j][c] = qi < n ? lse_bh[qi] : 0.f;
        dl[j][c] = qi < n ? del_bh[qi] : 0.f;
      }
    pp.template products<false>(it, sacc, pacc);

    // p^T = exp(s*scale - lse), 0 where the key is past the query or T;
    // ds^T * scale = p^T (dP^T - delta) * scale
    const bool edge = q0 < k0 + 16 * warp + 15 || q0 + STEP > n ||
                      k0 + 16 * warp + 16 > n;
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float x = exp2f(fmaf(sacc[e], sl2, -l2[j][c] * LOG2E));
          if (edge) {
            const int qi = q0 + 8 * j + 2 * qd + c, kc = k0 + kr + 8 * i;
            if (kc > qi || qi >= n || kc >= n) x = 0.f;
          }
          sacc[e] = x;
          pacc[e] = (pacc[e] - dl[j][c]) * x * scale;
        }
    hopper::split_frags<STEP>(fhi, flo, sacc);
    pp.accumulate(it, dvacc, fhi, flo, 1);       // dV += P^T dO
    hopper::split_frags<STEP>(fhi, flo, pacc);
    pp.accumulate(it, dkacc, fhi, flo, 0);       // dK += (dS scale)^T Q
    pp.release_t(it);
  }

  const int64_t base = b * s.b + h * s.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kc = k0 + kr + 8 * i;
    if (kc < n) {
      store_f32_row<D>(dk + base + int64_t(kc) * s.t, dkacc, i, qd);
      store_f32_row<D>(dv + base + int64_t(kc) * s.t, dvacc, i, qd);
    }
  }
}

// ---- f32 backward: dQ (one block per query tile) ---------------------------

template <int D>
__global__ void __launch_bounds__(tc_threads(1), 1)
dq_f32_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int H, int n, Strides s, float scale) {
  using P = BwdF32Pipe<D, 1>;
  constexpr int STEP = P::STEP;
  extern __shared__ uint8_t smem_raw[];
  const P pp(smem_raw);

  const int nt = (n + P::R - 1) / P::R;
  const int qt = nt - 1 - blockIdx.x;          // the longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * P::R;
  const int n_it = min(q0 + P::R - 1, n - 1) / STEP + 1;   // to the diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) pp.init();
  __syncthreads();
  if (warp == 4) {                             // the copies
    if (lane == 0) pp.produce(&tq, &tdo, &tk, &tv, q0, 0, h, b, n_it);
    return;
  }
  if (warp > 4) {                              // the splits
    pp.convert(n_it, threadIdx.x - 5 * 32);
    return;
  }

  const int qd = lane % 4;
  const int r0 = 16 * warp + lane / 4;         // tile row, i = 0
  const float sl2 = scale * LOG2E;
  float lr[2], dr[2];                          // lse (log2 units), delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    lr[i] = qi < n ? lse[int64_t(bh) * n + qi] * LOG2E : 0.f;
    dr[i] = qi < n ? delta[int64_t(bh) * n + qi] : 0.f;
  }
  float sacc[STEP / 2], pacc[STEP / 2], dqacc[D / 2];
  zero_regs(dqacc);
  uint32_t fhi[STEP / 8][4], flo[STEP / 8][4];

  mbar_wait(pp.x_ready, 0);
  uint32_t qa[D / 8][4];                       // Q's hi, read once
  hopper::load_q_frags<D>(qa, pp.x, P::R);
  for (int it = 0; it < n_it; ++it) {
    const int k0 = it * STEP;
    pp.template products<true>(it, sacc, pacc, qa);

    // ds * scale = p (dP - delta) * scale, p = exp(s*scale - lse), 0
    // where the key is past the query or T
    const bool edge = k0 + STEP - 1 > q0 + 16 * warp || k0 + STEP > n;
#pragma unroll
    for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float x = exp2f(fmaf(sacc[e], sl2, -lr[i]));
          if (edge) {
            const int kc = k0 + 8 * j + 2 * qd + c, qi = q0 + r0 + 8 * i;
            if (kc > qi || kc >= n) x = 0.f;
          }
          pacc[e] = (pacc[e] - dr[i]) * x * scale;
        }
    hopper::split_frags<STEP>(fhi, flo, pacc);
    pp.accumulate(it, dqacc, fhi, flo, 0);       // dQ += (dS scale) K
    pp.release_t(it);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    if (qi < n)
      store_f32_row<D>(dq + b * s.b + h * s.h + int64_t(qi) * s.t, dqacc, i,
                       qd);
  }
}

// ---- bf16 backward: dK, dV and dQ (one block per key tile) ---------------
//
// Five products a step, none formed twice: per (key tile, b*h) the block
// streams 64 queries a step from the diagonal down and forms S^T =
// K Q^T and dP^T = V dO^T (keys x queries, so their fragments are the A
// operands that follow), then dV += P^T dO, dK += (dS scale)^T Q, and the
// step's dQ partial, dS scale K.  That last product needs dS with the
// queries as its rows: each consumer writes its rounded dS^T (the same
// bf16 values as its dK fragments) to shared memory, and the product
// reads it MN-major, as it reads K.  With two consumer warpgroups (128
// keys) each forms half of dQ's columns over all 128 keys, after a named
// barrier of the two; dS^T has two stages, so a warpgroup a step ahead
// never writes over what the other's dQ product still reads.
//
// dQ is summed over the key tiles in f32: a warpgroup stages its partial
// (64 queries x D/NWG f32, in TMA's swizzled boxes) in shared memory and
// the producer warpgroup's second warp hands it to TMA's reduce-add into
// the f32 scratch (cp.reduce.async.bulk.tensor ... add), which the delta
// pass zeroed; the copy engine and the L2 do the adds, and a consumer
// waits only before it writes its staging tile again.  The order of the
// f32 sums across key tiles varies from run to run; dq_convert_kernel
// rounds the sum to bf16 once.
//
// The fixed-order path (ORDERED, under PyTorch's deterministic switch)
// adds the partials of a 64-query step in ascending key tiles, as JAX's
// kernel sums dQ over key blocks in order, so that two runs give the
// same bits.  One int a (b*h, query step, warpgroup), zeroed before the
// launch, counts the key tiles that have added theirs; the key tiles
// that reach query step qt are 0 .. qt*64/BN, so tile kt's turn is kt.
// The writer warp waits for its turn, issues the reduce, waits for it to
// complete (not only to read the staging) and passes the turn on.  The
// blocks of one (b, h) are launched in ascending key tiles (the block
// order below), so a block waits only on blocks launched before it, as
// long as the card dispatches blocks in blockIdx order; wait_turn traps
// rather than hang if it ever does not.
//
// Overlap: dV is issued as soon as p is packed, so the tensor cores run it
// while the consumer waits for dP^T and forms dS.
//
// What bounds it: shared memory as much as the tensor cores.  A step
// reads each product's shared-memory operands (two warpgroups: about 256
// KB) and writes dS^T and the dQ staging (48 KB), which TMA reads back;
// at 128 bytes a clock that is close to the products' own time at the
// bf16 peak.  Staging dQ alone cost 0.09 of 0.46 ms at the MFU shape
// (PERF.md, PR 10).
//
// Tile height: two consumer warpgroups only at D = 128 (two_warpgroups'
// rule); at D = 64 half of dQ's columns would be 32, half a swizzled box,
// so D = 64 always takes one.  Registers: the consumers take 240 a thread
// and leave the producer warpgroup 24 (hopper_tiles.cuh).

template <int D, int NWG>
struct BwdTc {
  static constexpr int BN = 64 * NWG;      // keys a block
  static constexpr int QB = 64;            // queries a step
  static constexpr int DQN = D / NWG;      // dQ columns a warpgroup
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int QT_BYTES = QB * D * 2;
  static constexpr int DS_BYTES = BN * QB * 2;    // dS^T, a stage
  static constexpr int DQ_BYTES = QB * DQN * 4;   // a warpgroup's dQ
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * ST * QT_BYTES +
                              2 * DS_BYTES + NWG * DQ_BYTES +
                              ST * 2 * QB * 4 + 8 * (1 + 2 * ST);
  static_assert(SMEM <= 232448, "bf16 backward tiles exceed shared memory");
  static_assert(DQN % 64 == 0, "dQ columns a warpgroup: whole boxes");
};

// named barriers of bwd_tc_kernel (0 is __syncthreads'): one warpgroup's
// dS^T written (NWG = 1); warpgroup w's dS^T written at a step of parity
// p (id DS_READY + 2p + w: w arrives, the other waits; two parities, so
// an arrival never meets the last step's); warpgroup w's dQ staged (w
// arrives, the writer waits); its staging free again (the writer
// arrives, w waits)
constexpr int DS_LOCAL = 1, DS_READY = 2, DQ_FULL = 6, DQ_EMPTY = 8;

template <int D, int NWG, bool ORDERED>
__global__ void __launch_bounds__(tc_threads(NWG), 1)
bwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tdq,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int* turns,
              int H, int n, int group, Strides s, float scale) {
  using L = BwdTc<D, NWG>;
  constexpr int BN = L::BN, QB = L::QB, DQN = L::DQN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + L::KV_BYTES;
  uint8_t* Qs = Vs + L::KV_BYTES;              // ST stages
  uint8_t* dOs = Qs + ST * L::QT_BYTES;        // ST stages
  uint8_t* dSs = dOs + ST * L::QT_BYTES;       // 2 stages
  uint8_t* dQs = dSs + 2 * L::DS_BYTES;        // one a warpgroup
  float* rowv = reinterpret_cast<float*>(dQs + NWG * L::DQ_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rowv + ST * 2 * QB);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  // Block order, which the scheduler follows: groups of `group` (b, h),
  // and in a group the low key tiles, the most work, of every (b, h)
  // first, so that short blocks fill the tail; a group's Q and dO stay in
  // the L2 while it runs
  const int n_kt = (n + BN - 1) / BN;
  const int g0 = blockIdx.x / (group * n_kt) * group;    // its first (b, h)
  const int gs = min(group, int(gridDim.x) / n_kt - g0);  // its size
  const int r = blockIdx.x - g0 * n_kt;
  const int kt = r / gs;
  const int bh = g0 + r % gs, b = bh / H, h = bh % H;
  const int k0 = kt * BN;
  const int qt0 = k0 / QB;                     // first tile with q >= k0
  const int n_it = (n + QB - 1) / QB - qt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 32);         // every producer lane
      hopper::mbar_init(&empty[i], 4 * NWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {                       // the producer warpgroup
    producer_regs<NWG, 24>();
    if (warp == 4 * NWG + 1) {                 // the dQ writer
      for (int w = 0; w < NWG; ++w)            // staging starts free
        hopper::named_arrive(DQ_EMPTY + w, 160);
      for (int it = 0; it < n_it; ++it) {
        const int q0 = (qt0 + it) * QB;
        for (int w = 0; w < NWG; ++w) {
          hopper::named_sync(DQ_FULL + w, 160);   // warpgroup w staged
          if (lane == 0) {
            int* turn = nullptr;     // of (b*h, query step, w)
            if constexpr (ORDERED) {
              turn = turns + (int64_t(bh) * ((n + QB - 1) / QB) + q0 / QB) *
                                 NWG + w;
              hopper::wait_turn(turn, kt);
            }
#pragma unroll
            for (int box = 0; box < DQN / 32; ++box)
              hopper::tma_reduce_add_4d(
                  dQs + w * L::DQ_BYTES + box * QB * 128, &tdq,
                  w * DQN + box * 32, h, q0, b);
            hopper::bulk_commit();
            if constexpr (ORDERED) {
              hopper::bulk_wait();
              hopper::pass_turn(turn);
            } else {
              hopper::bulk_wait_read();
            }
          }
          __syncwarp();
          if (it + 1 < n_it) hopper::named_arrive(DQ_EMPTY + w, 160);
        }
      }
      if (lane == 0) hopper::bulk_wait();
      return;
    }
    if (warp != 4 * NWG) return;
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * L::KV_BYTES);
      tma_load_tile<D>(Ks, &tk, kv_full, BN, k0, h, b);
      tma_load_tile<D>(Vs, &tv, kv_full, BN, k0, h, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % ST, q0 = (qt0 + it) * QB;
      mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
      // lse (in log2 units) and delta of the step's queries; 0 past T
      float* lr = rowv + st * 2 * QB;
      for (int i = lane; i < QB; i += 32) {
        const int t = q0 + i;
        lr[i] = t < n ? lse[int64_t(bh) * n + t] * LOG2E : 0.f;
        lr[QB + i] = t < n ? delta[int64_t(bh) * n + t] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[st], 2 * L::QT_BYTES);
        tma_load_tile<D>(Qs + st * L::QT_BYTES, &tq, &full[st], QB, q0, h,
                         b);
        tma_load_tile<D>(dOs + st * L::QT_BYTES, &tdo, &full[st], QB, q0, h,
                         b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  consumer_regs<NWG, 240>();
  const int wg = warp / 4, qd = lane % 4;
  const int kr = 64 * wg + 16 * (warp % 4) + lane / 4;   // tile key, i = 0
  const int r0 = 16 * (warp % 4) + lane / 4;             // dQ row, i = 0
  const float sl2 = scale * LOG2E;
  uint8_t* const dQt = dQs + wg * L::DQ_BYTES;
  // this warpgroup's dQ columns of K: whole 64-column boxes
  const uint8_t* const Kq = Ks + wg * (DQN / 64) * BN * 128;
  float sacc[QB / 2], pacc[QB / 2];            // S^T and dP^T: keys x queries
  float dvacc[D / 2], dkacc[D / 2], dqacc[DQN / 2];
  zero_regs(sacc);
  zero_regs(pacc);
  zero_regs(dvacc);
  zero_regs(dkacc);
  zero_regs(dqacc);
  uint32_t pa[QB / 16][4], da[QB / 16][4];

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % ST, q0 = (qt0 + it) * QB;
    const uint8_t* Qt = Qs + st * L::QT_BYTES;
    const uint8_t* dOt = dOs + st * L::QT_BYTES;
    uint8_t* dSt = dSs + (it & 1) * L::DS_BYTES;
    const float* lr = rowv + st * 2 * QB;
    const float* dr = lr + QB;
    mbar_wait(&full[st], (it / ST) & 1);

    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<QB>(sacc, smem_desc_k(Ks, BN, 64 * wg, kk),
                   smem_desc_k(Qt, QB, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<QB>(pacc, smem_desc_k(Vs, BN, 64 * wg, kk),
                   smem_desc_k(dOt, QB, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                           // S^T is in
    fence_regs(sacc);

    // p^T = exp(s*scale - lse), 0 where the key is past the query or T
    const bool edge = q0 < k0 + 64 * wg + 63 || q0 + QB > n ||
                      k0 + 64 * wg + 64 > n;
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * j + 2 * qd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sacc[4 * j + 2 * i + c];
          x = exp2f(fmaf(x, sl2, -(c ? l2.y : l2.x)));
          if (edge) {
            const int qi = q0 + 8 * j + 2 * qd + c, kc = k0 + kr + 8 * i;
            if (kc > qi || qi >= n || kc >= n) x = 0.f;
          }
        }
    }
    pack_frags<QB>(pa, sacc);                    // p rounded to bf16

    // dV += P^T dO runs while dP^T lands and dS is formed
    fence_frags(pa);
    fence_regs(dvacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk)
      wgmma_rs<D>(dvacc, pa[kk], smem_desc_mn(dOt, QB, kk));
    wgmma_commit();
    wgmma_wait<1>();                           // dP^T is in
    fence_regs(pacc);
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dr + 8 * j + 2 * qd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          const float ds = (pacc[e] - (c ? d2.y : d2.x)) * sacc[e];
          pacc[e] = ds * scale;
        }
    }
    pack_frags<QB>(da, pacc);                    // ds*scale rounded to bf16

    // dS^T to shared memory (one 64-query box of BN keys): fragment
    // da[kk][x] is key kr + 8(x & 1), queries 16kk + 8(x >> 1) + 2qd, +1
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        *reinterpret_cast<uint32_t*>(
            dSt + hopper::sw128(kr + 8 * (x & 1), 2 * kk + (x >> 1)) +
            4 * qd) = da[kk][x];
    hopper::fence_async_smem();
    if constexpr (NWG == 1)
      hopper::named_sync(DS_LOCAL, 128);       // every warp's dS^T is in
    else
      hopper::named_arrive(DS_READY + 2 * (it & 1) + wg, 256);   // ours

    // dK += (dS scale)^T Q; dQ partial = (dS scale) K over the BN keys,
    // once the other warpgroup's dS^T is in too
    fence_frags(da);
    fence_regs(dkacc);
    fence_regs(dqacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk)
      wgmma_rs<D>(dkacc, da[kk], smem_desc_mn(Qt, QB, kk));
    if constexpr (NWG == 2)
      hopper::named_sync(DS_READY + 2 * (it & 1) + 1 - wg, 256);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hopper::wgmma_ss_mn<DQN>(dqacc, smem_desc_mn(dSt, BN, kk),
                               smem_desc_mn(Kq, BN, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    fence_regs(dqacc);
    if (lane == 0) mbar_arrive(&empty[st]);

    // stage the dQ partial (32-column f32 boxes, 128-byte swizzle) once
    // the writer warp has handed the last one to TMA, and hand it over
    hopper::named_sync(DQ_EMPTY + wg, 160);
#pragma unroll
    for (int j = 0; j < DQN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(
            dQt + (j / 4) * QB * 128 +
            hopper::sw128(r0 + 8 * i, 2 * (j % 4) + qd / 2) + 8 * (qd & 1)) =
            make_float2(dqacc[4 * j + 2 * i], dqacc[4 * j + 2 * i + 1]);
    hopper::fence_async_smem();
    hopper::named_arrive(DQ_FULL + wg, 160);
  }

  const int64_t base = b * s.b + h * s.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kc = k0 + kr + 8 * i;
    if (kc < n) {
      store_frag_row<D>(dk + base + int64_t(kc) * s.t, dkacc, i, qd, 1.f);
      store_frag_row<D>(dv + base + int64_t(kc) * s.t, dvacc, i, qd, 1.f);
    }
  }
}

// ---- launches --------------------------------------------------------------
//
// At the LM's shape a call costs more on the host than on the card; of
// the library's share, encoding a tensor map and setting the shared-memory
// attribute cost about 0.1 us each (geo_flash_host_pieces), so both are
// done on every launch.

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool bthd_map(CUtensorMap* map, const void* p, int B, int H, int n, int D,
              Strides s, int rows, int es = 2) {
  return hopper::make_bthd_map(map, p, B, n, H, D, s.b, s.t, s.h, rows, es);
}

template <int D>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int H, int n,
                           Strides s, float scale, cudaStream_t stream) {
  using L = hopper::Tf32Tiles<D>;
  CUtensorMap tq, tk, tv;
  if (!bthd_map(&tq, q, B, H, n, D, s, L::BM, 4) ||
      !bthd_map(&tk, k, B, H, n, D, s, L::BN, 4) ||
      !bthd_map(&tv, v, B, H, n, D, s, L::BN, 4))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fwd_f32_tc_kernel<D>, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + L::BM - 1) / L::BM, B * H);
  fwd_f32_tc_kernel<D><<<grid, tc_threads(1), L::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(o), lse, H, n, s, scale);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int n,
                          Strides s, float scale, cudaStream_t stream) {
  using L = FwdTc<D, NWG>;
  CUtensorMap tq, tk, tv;
  if (!bthd_map(&tq, q, B, H, n, D, s, L::BM) ||
      !bthd_map(&tk, k, B, H, n, D, s, L::BN) ||
      !bthd_map(&tv, v, B, H, n, D, s, L::BN))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fwd_tc_kernel<D, NWG>, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + L::BM - 1) / L::BM, B * H);
  fwd_tc_kernel<D, NWG><<<grid, tc_threads(NWG), L::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, H, n, s, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            void* o, float* lse, int B, int H, int n,
                            Strides s, float scale, cudaStream_t stream) {
  if (two_warpgroups(B, H, n))
    return launch_fwd_tc<D, 2>(q, k, v, o, lse, B, H, n, s, scale, stream);
  return launch_fwd_tc<D, 1>(q, k, v, o, lse, B, H, n, s, scale, stream);
}

template <int D, int NWG, bool ORDERED>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, float* dq_acc, int* turns,
                          void* dk, void* dv, int B, int H, int n, Strides s,
                          float scale, cudaStream_t stream) {
  using L = BwdTc<D, NWG>;
  // key tiles of L::BN, query steps of L::QB; dQ's f32 boxes of 64 rows
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!bthd_map(&tq, q, B, H, n, D, s, L::QB) ||
      !bthd_map(&tk, k, B, H, n, D, s, L::BN) ||
      !bthd_map(&tv, v, B, H, n, D, s, L::BN) ||
      !bthd_map(&tdo, dout, B, H, n, D, s, L::QB) ||
      !bthd_map(&tdq, dq_acc, B, H, n, D, s, L::QB, 4))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(bwd_tc_kernel<D, NWG, ORDERED>, L::SMEM);
  if (err != cudaSuccess) return err;
  if (ORDERED) {
    err = cudaMemsetAsync(
        turns, 0, sizeof(int) * B * H * ((n + L::QB - 1) / L::QB) * NWG,
        stream);
    if (err != cudaSuccess) return err;
  }
  // (b, h) a group: their Q and dO in 32 MB of the 50 MB L2
  const int64_t per_bh = int64_t(n) * D * 4;
  const int group = int(std::max<int64_t>(
      1, std::min<int64_t>(B * H, (int64_t(32) << 20) / per_bh)));
  const int64_t n_kt = (n + L::BN - 1) / L::BN;
  bwd_tc_kernel<D, NWG, ORDERED>
      <<<unsigned(B * H * n_kt), tc_threads(NWG), L::SMEM, stream>>>(
          tq, tk, tv, tdo, tdq, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), turns, H, n, group, s, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v,
                           const void* o, const void* dout,
                           const float* lse, float* delta, void* dq,
                           void* dk, void* dv, int B, int H, int n,
                           Strides s, float scale, cudaStream_t stream) {
  using PK = BwdF32Pipe<D, 2>;
  using PQ = BwdF32Pipe<D, 1>;
  cudaError_t err =
      launch_delta<float, D>(o, dout, delta, nullptr, B, H, n, s, stream);
  if (err != cudaSuccess) return err;
  // dK/dV: K, V resident (64 rows), Q, dO streamed (STEP rows);
  // dQ: Q, dO resident, K, V streamed
  CUtensorMap kk, kv, kq, kdo, qq, qdo, qk, qv;
  if (!bthd_map(&kk, k, B, H, n, D, s, PK::R, 4) ||
      !bthd_map(&kv, v, B, H, n, D, s, PK::R, 4) ||
      !bthd_map(&kq, q, B, H, n, D, s, PK::STEP, 4) ||
      !bthd_map(&kdo, dout, B, H, n, D, s, PK::STEP, 4) ||
      !bthd_map(&qq, q, B, H, n, D, s, PQ::R, 4) ||
      !bthd_map(&qdo, dout, B, H, n, D, s, PQ::R, 4) ||
      !bthd_map(&qk, k, B, H, n, D, s, PQ::STEP, 4) ||
      !bthd_map(&qv, v, B, H, n, D, s, PQ::STEP, 4))
    return cudaErrorInvalidValue;
  err = set_smem(dkdv_f32_tc_kernel<D>, PK::SMEM);
  if (err != cudaSuccess) return err;
  dkdv_f32_tc_kernel<D>
      <<<dim3((n + PK::R - 1) / PK::R, B * H), tc_threads(1), PK::SMEM,
         stream>>>(kk, kv, kq, kdo, lse, delta, static_cast<float*>(dk),
                   static_cast<float*>(dv), H, n, s, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(dq_f32_tc_kernel<D>, PQ::SMEM);
  if (err != cudaSuccess) return err;
  dq_f32_tc_kernel<D>
      <<<dim3((n + PQ::R - 1) / PQ::R, B * H), tc_threads(1), PQ::SMEM,
         stream>>>(qq, qdo, qk, qv, lse, delta, static_cast<float*>(dq), H,
                   n, s, scale);
  return cudaGetLastError();
}

template <int D, bool ORDERED>
cudaError_t launch_bwd_tiles(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, float* dq_acc, int* turns,
                             void* dk, void* dv, int B, int H, int n,
                             Strides s, float scale, cudaStream_t stream) {
  if constexpr (D == 128) {
    if (two_warpgroups(B, H, n))
      return launch_bwd_tc<D, 2, ORDERED>(q, k, v, dout, lse, delta, dq_acc,
                                          turns, dk, dv, B, H, n, s, scale,
                                          stream);
  }
  return launch_bwd_tc<D, 1, ORDERED>(q, k, v, dout, lse, delta, dq_acc,
                                      turns, dk, dv, B, H, n, s, scale,
                                      stream);
}

// delta pass (which zeroes dq_acc), the fused kernel, dQ rounded to bf16;
// turns (not null: the fixed-order path) holds B*H*ceil(n/64)*2 ints
template <int D>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, float* dq_acc,
                            int* turns, void* dq, void* dk, void* dv, int B,
                            int H, int n, Strides s, float scale,
                            cudaStream_t stream) {
  cudaError_t err =
      launch_delta<bf16, D>(o, dout, delta, dq_acc, B, H, n, s, stream);
  if (err != cudaSuccess) return err;
  err = turns != nullptr
            ? launch_bwd_tiles<D, true>(q, k, v, dout, lse, delta, dq_acc,
                                        turns, dk, dv, B, H, n, s, scale,
                                        stream)
            : launch_bwd_tiles<D, false>(q, k, v, dout, lse, delta, dq_acc,
                                         turns, dk, dv, B, H, n, s, scale,
                                         stream);
  if (err != cudaSuccess) return err;
  const int64_t n8 = int64_t(B) * n * H * D / 8;
  dq_convert_kernel<<<grid_for(n8), NT, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<uint4*>(dq), n8);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Every [B, T,
// H, D] tensor of the call is contiguous (the TMA maps need 16-byte
// aligned bases).  Returns a cudaError_t (0 = launched).
Strides contiguous(int H, int n, int D) {
  return Strides{int64_t(n) * H * D, int64_t(H) * D, D};
}

extern "C" int geo_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, void* o,
                             float* lse, int B, int H, int n, float scale,
                             void* stream) {
  const Strides s = contiguous(H, n, head_dim);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_fwd_f32<64>(q, k, v, o, lse, B, H, n, s, scale, cs);
  if (dtype == 0 && head_dim == 128)
    return launch_fwd_f32<128>(q, k, v, o, lse, B, H, n, s, scale, cs);
  if (dtype == 1 && head_dim == 64)
    return launch_fwd_bf16<64>(q, k, v, o, lse, B, H, n, s, scale, cs);
  if (dtype == 1 && head_dim == 128)
    return launch_fwd_bf16<128>(q, k, v, o, lse, B, H, n, s, scale, cs);
  return int(cudaErrorInvalidValue);
}

// delta is f32 [B, H, T] scratch the caller allocates; dq_acc f32 scratch
// of q's shape and strides (bf16 only: the delta pass zeroes it and the
// key tiles add their dQ into it; null in f32).  turns: null, or (bf16
// only) B*H*ceil(T/64)*2 ints of scratch, which asks for the fixed-order
// dQ sum (the launch zeroes them).
extern "C" int geo_flash_bwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* o,
                             const void* dout, const float* lse,
                             float* delta, float* dq_acc, int* turns,
                             void* dq, void* dk, void* dv, int B, int H,
                             int n, float scale, void* stream) {
  const Strides s = contiguous(H, n, head_dim);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_bwd_f32<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                              H, n, s, scale, cs);
  if (dtype == 0 && head_dim == 128)
    return launch_bwd_f32<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               H, n, s, scale, cs);
  if (dq_acc == nullptr) return int(cudaErrorInvalidValue);
  if (dtype == 1 && head_dim == 64)
    return launch_bwd_bf16<64>(q, k, v, o, dout, lse, delta, dq_acc, turns,
                               dq, dk, dv, B, H, n, s, scale, cs);
  if (dtype == 1 && head_dim == 128)
    return launch_bwd_bf16<128>(q, k, v, o, dout, lse, delta, dq_acc, turns,
                                dq, dk, dv, B, H, n, s, scale, cs);
  return int(cudaErrorInvalidValue);
}

// Host time (us, mean over `reps`, host clock) of the library's pieces of
// a launch, for a forward call's q in the given dtype and head_dim (f32
// box rows 32, bf16 64): [0] one tensor map encoded, [1]
// cudaFuncSetAttribute, [2] cudaGetDevice, [3] cudaGetLastError.
extern "C" int geo_flash_host_pieces(int dtype, int head_dim, const void* q,
                                     int B, int H, int n, int reps,
                                     double* us) {
  using clock = std::chrono::steady_clock;
  const Strides s = contiguous(H, n, head_dim);
  const int es = dtype == 0 ? 4 : 2, rows = dtype == 0 ? 32 : 64;
  if (reps < 1 || (head_dim != 64 && head_dim != 128))
    return int(cudaErrorInvalidValue);
  auto mean_us = [reps](clock::time_point t0) {
    return std::chrono::duration<double, std::micro>(clock::now() - t0)
               .count() / reps;
  };
  CUtensorMap m;
  bool ok = true;
  auto t0 = clock::now();
  for (int i = 0; i < reps; ++i)
    ok &= bthd_map(&m, q, B, H, n, head_dim, s, rows, es);
  us[0] = mean_us(t0);
  if (!ok) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  t0 = clock::now();
  for (int i = 0; i < reps; ++i)
    err = set_smem(fwd_f32_tc_kernel<64>, hopper::Tf32Tiles<64>::SMEM);
  us[1] = mean_us(t0);
  if (err != cudaSuccess) return int(err);
  int dev = 0;
  t0 = clock::now();
  for (int i = 0; i < reps; ++i) err = cudaGetDevice(&dev);
  us[2] = mean_us(t0);
  t0 = clock::now();
  for (int i = 0; i < reps; ++i) err = cudaGetLastError();
  us[3] = mean_us(t0);
  return int(err);
}
