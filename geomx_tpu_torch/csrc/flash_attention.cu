// Causal flash attention for Hopper (sm_90a): forward, and the backward
// as three kernels (delta = rowsum(dO * O), dK/dV, dQ).
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
//   * backward: delta_kernel, then one block per key tile (queries from
//     the diagonal down, 64 at a step) for dK/dV and one per query tile
//     (keys 64 at a step) for dQ; no atomics, so the same bits run to
//     run;
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
// again); the backward stays on the FMA kernels below.
// f32 backward: plain FMAs from shared memory: one block of 256 threads
// per 64-row tile, 4 lanes a row, tiles in shared memory,
// register-blocked products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {


constexpr int BR = 64;       // rows of a tile (queries or keys)
constexpr int NT = 256;      // threads a block: 4 lanes per tile row
constexpr int PAD = 4;       // floats of padding per [BR][D] tile row
constexpr int SP = BR + 1;   // row stride of a [BR][BR] score tile
constexpr int NC = BR / 4;   // score columns a lane holds

template <typename E> __device__ __forceinline__ float to_f(E x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch casts
}

struct Strides {
  int64_t b, t, h;   // elements between rows of b, t and h
};

// Rows row0 .. row0+BR-1 of the (b, h) slice of a [B, T, H, D] tensor
// into a [BR][D + PAD] f32 tile; rows past n are zeros.
template <typename E, int D>
__device__ __forceinline__ void load_tile(float* dst, const E* src,
                                          int64_t base, int row0, int n,
                                          int64_t st) {
  for (int i = threadIdx.x; i < BR * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = row0 + r;
    dst[r * (D + PAD) + d] = t < n ? to_f<E>(src[base + t * st + d]) : 0.f;
  }
}

// The 4 lanes of a row own the row's stats: lse and delta of rows
// row0 .. row0+BR-1 of [B, H, T] slice bh into dst[BR] (0 past n).
__device__ __forceinline__ void load_rowvec(float* dst, const float* src,
                                            int64_t bh, int row0, int n) {
  for (int i = threadIdx.x; i < BR; i += NT) {
    const int t = row0 + i;
    dst[i] = t < n ? src[bh * n + t] : 0.f;
  }
}

// acc[j] = A[r] . Bm[qd + 4j] over D, for the lane's NC columns.
template <int D>
__device__ __forceinline__ void dot_rows(float (&acc)[NC], const float* A,
                                         const float* Bm, int r, int qd) {
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;
  const float* a = A + r * (D + PAD);
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + d);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(
          Bm + (qd + 4 * j) * (D + PAD) + d);
      acc[j] += av.x * bv.x + av.y * bv.y + av.z * bv.z + av.w * bv.w;
    }
  }
}

// acc[r][d] += sum_c M[r][c] * X[c][d]: the lane holds columns
// d = 16*jj + 4*qd .. +3 of row r.
template <int D>
__device__ __forceinline__ void acc_mx(float4 (&acc)[D / 16], const float* M,
                                       const float* X, int r, int qd) {
  const float* m = M + r * SP;
#pragma unroll 4
  for (int c = 0; c < BR; ++c) {
    const float mc = m[c];
    const float* x = X + c * (D + PAD) + 4 * qd;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      const float4 xv = *reinterpret_cast<const float4*>(x + 16 * jj);
      acc[jj].x += mc * xv.x;
      acc[jj].y += mc * xv.y;
      acc[jj].z += mc * xv.z;
      acc[jj].w += mc * xv.w;
    }
  }
}

template <typename E, int D>
__device__ __forceinline__ void store_row(E* dst, const float4 (&acc)[D / 16],
                                          float mul, int qd) {
#pragma unroll
  for (int jj = 0; jj < D / 16; ++jj) {
    E* p = dst + 16 * jj + 4 * qd;
    p[0] = from_f<E>(acc[jj].x * mul);
    p[1] = from_f<E>(acc[jj].y * mul);
    p[2] = from_f<E>(acc[jj].z * mul);
    p[3] = from_f<E>(acc[jj].w * mul);
  }
}

template <int D>
__device__ __forceinline__ void zero(float4 (&acc)[D / 16]) {
#pragma unroll
  for (int jj = 0; jj < D / 16; ++jj)
    acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__host__ __device__ constexpr size_t tile_floats(int D) {
  return size_t(BR) * (D + PAD);
}
__host__ __device__ constexpr size_t score_floats() {
  return size_t(BR) * SP;
}

// ---- backward: delta = rowsum(dO * O) --------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(NT)
delta_kernel(const E* __restrict__ o, const E* __restrict__ dout,
             float* __restrict__ delta, int B, int H, int n, Strides s) {
  // one warp per row (b, t, h); lanes stride over D
  const int64_t row = (int64_t(blockIdx.x) * NT + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= int64_t(B) * n * H) return;
  const int h = int(row % H);
  const int t = int((row / H) % n);
  const int b = int(row / (int64_t(H) * n));
  const int64_t off = b * s.b + t * s.t + h * s.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += to_f<E>(dout[off + d]) * to_f<E>(o[off + d]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[(int64_t(b) * H + h) * n + t] = acc;
}

// ---- backward: dK, dV (one block per key tile) -----------------------------

template <typename E, int D>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
            const E* __restrict__ v, const E* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            E* __restrict__ dk, E* __restrict__ dv, int H, int n, Strides s,
            float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + tile_floats(D);
  float* Qs = Vs + tile_floats(D);
  float* dOs = Qs + tile_floats(D);
  float* Pt = dOs + tile_floats(D);     // P^T: [key][query]
  float* dSt = Pt + score_floats();     // dS^T
  float* lse_s = dSt + score_floats();
  float* del_s = lse_s + BR;

  const int nt = (n + BR - 1) / BR;
  const int kt = blockIdx.x;            // low key tiles carry most work
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t base = b * s.b + h * s.h;
  const int c = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const int k0 = kt * BR, kc = k0 + c;

  load_tile<E, D>(Ks, k, base, k0, n, s.t);
  load_tile<E, D>(Vs, v, base, k0, n, s.t);
  float4 dk_acc[D / 16], dv_acc[D / 16];
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  for (int qt = kt; qt < nt; ++qt) {
    const int q0 = qt * BR;
    __syncthreads();
    load_tile<E, D>(Qs, q, base, q0, n, s.t);
    load_tile<E, D>(dOs, dout, base, q0, n, s.t);
    load_rowvec(lse_s, lse, bh, q0, n);
    load_rowvec(del_s, delta, bh, q0, n);
    __syncthreads();
    float st[NC], dpt[NC];
    dot_rows<D>(st, Ks, Qs, c, qd);     // s[i][c] for i = qd + 4j
    dot_rows<D>(dpt, Vs, dOs, c, qd);   // dP[i][c] = dO[i] . V[c]
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int i = qd + 4 * j, qi = q0 + i;
      const float p = (qi < n && kc < n && kc <= qi)
                          ? expf(st[j] * scale - lse_s[i]) : 0.f;
      Pt[c * SP + i] = p;
      dSt[c * SP + i] = p * (dpt[j] - del_s[i]);
    }
    __syncwarp();   // row c of Pt/dSt was written by this warp's 4 lanes
    acc_mx<D>(dv_acc, Pt, dOs, c, qd);   // dV[c] += sum_i P[i][c] dO[i]
    acc_mx<D>(dk_acc, dSt, Qs, c, qd);   // dK[c] += sum_i dS[i][c] Q[i]
  }
  if (kc < n) {
    store_row<E, D>(dk + base + kc * s.t, dk_acc, scale, qd);
    store_row<E, D>(dv + base + kc * s.t, dv_acc, 1.f, qd);
  }
}

// ---- backward: dQ (one block per query tile) -------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
          const E* __restrict__ v, const E* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          E* __restrict__ dq, int H, int n, Strides s, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + tile_floats(D);
  float* Ks = dOs + tile_floats(D);
  float* Vs = Ks + tile_floats(D);
  float* dSs = Vs + tile_floats(D);
  float* lse_s = dSs + score_floats();
  float* del_s = lse_s + BR;

  const int nt = (n + BR - 1) / BR;
  const int qt = nt - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t base = b * s.b + h * s.h;
  const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const int q0 = qt * BR, qi = q0 + r;

  load_tile<E, D>(Qs, q, base, q0, n, s.t);
  load_tile<E, D>(dOs, dout, base, q0, n, s.t);
  load_rowvec(lse_s, lse, bh, q0, n);
  load_rowvec(del_s, delta, bh, q0, n);
  float4 dq_acc[D / 16];
  zero<D>(dq_acc);
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();
    load_tile<E, D>(Ks, k, base, k0, n, s.t);
    load_tile<E, D>(Vs, v, base, k0, n, s.t);
    __syncthreads();
    float sc[NC], dp[NC];
    dot_rows<D>(sc, Qs, Ks, r, qd);
    dot_rows<D>(dp, dOs, Vs, r, qd);
    const float lr = lse_s[r], dr = del_s[r];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int kc = k0 + qd + 4 * j;
      const float p = (qi < n && kc < n && kc <= qi)
                          ? expf(sc[j] * scale - lr) : 0.f;
      dSs[r * SP + qd + 4 * j] = p * (dp[j] - dr);
    }
    __syncwarp();
    acc_mx<D>(dq_acc, dSs, Ks, r, qd);   // dQ[r] += sum_c dS[r][c] K[c]
  }
  if (qi < n) store_row<E, D>(dq + base + qi * s.t, dq_acc, scale, qd);
}

constexpr size_t dkdv_smem(int D) {
  return (4 * tile_floats(D) + 2 * score_floats() + 2 * BR) * sizeof(float);
}
constexpr size_t dq_smem(int D) {
  return (4 * tile_floats(D) + score_floats() + 2 * BR) * sizeof(float);
}

template <typename E, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int H, int n, Strides s, float scale,
                       cudaStream_t stream) {
  const int64_t rows = int64_t(B) * n * H;
  const int warps_per_block = NT / 32;
  delta_kernel<E, D><<<unsigned((rows + warps_per_block - 1) /
                                warps_per_block), NT, 0, stream>>>(
      static_cast<const E*>(o), static_cast<const E*>(dout), delta, B, H, n,
      s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((n + BR - 1) / BR, B * H);
  err = cudaFuncSetAttribute(dkdv_kernel<E, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dkdv_smem(D)));
  if (err != cudaSuccess) return err;
  dkdv_kernel<E, D><<<grid, NT, dkdv_smem(D), stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
      static_cast<E*>(dk), static_cast<E*>(dv), H, n, s, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dq_kernel<E, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dq_smem(D)));
  if (err != cudaSuccess) return err;
  dq_kernel<E, D><<<grid, NT, dq_smem(D), stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
      static_cast<E*>(dq), H, n, s, scale);
  return cudaGetLastError();
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

// ---- bf16 backward: dK, dV (one block per key tile) -----------------------

template <int D, int NWG>
struct DkdvTc {
  static constexpr int BN = 64 * NWG;      // keys a block
  static constexpr int QB = 64;            // queries a step
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int QT_BYTES = QB * D * 2;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * ST * QT_BYTES +
                              ST * 2 * QB * 4 + 8 * (1 + 2 * ST);
};

template <int D, int NWG>
__global__ void __launch_bounds__(tc_threads(NWG), 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int n,
               Strides s, float scale) {
  using L = DkdvTc<D, NWG>;
  constexpr int BN = L::BN, QB = L::QB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + L::KV_BYTES;
  uint8_t* Qs = Vs + L::KV_BYTES;              // ST stages
  uint8_t* dOs = Qs + ST * L::QT_BYTES;        // ST stages
  float* rowv = reinterpret_cast<float*>(dOs + ST * L::QT_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rowv + ST * 2 * QB);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int kt = blockIdx.x;                   // low key tiles: most work
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
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
    producer_regs<NWG>();
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

  consumer_regs<NWG>();
  const int wg = warp / 4, qd = lane % 4;
  const int kr = 64 * wg + 16 * (warp % 4) + lane / 4;   // tile key, i = 0
  const float sl2 = scale * LOG2E;
  float sacc[QB / 2], pacc[QB / 2];            // S^T and dP^T: keys x queries
  float dvacc[D / 2], dkacc[D / 2];
  zero_regs(sacc);
  zero_regs(pacc);
  zero_regs(dvacc);
  zero_regs(dkacc);
  uint32_t pa[QB / 16][4], da[QB / 16][4];

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % ST, q0 = (qt0 + it) * QB;
    const uint8_t* Qt = Qs + st * L::QT_BYTES;
    const uint8_t* dOt = dOs + st * L::QT_BYTES;
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

    wgmma_wait<0>();                           // dP^T is in
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

    fence_frags(pa);
    fence_frags(da);
    fence_regs(dvacc);
    fence_regs(dkacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk)
      wgmma_rs<D>(dvacc, pa[kk], smem_desc_mn(dOt, QB, kk));
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk)
      wgmma_rs<D>(dkacc, da[kk], smem_desc_mn(Qt, QB, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    if (lane == 0) mbar_arrive(&empty[st]);
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

// ---- bf16 backward: dQ (one block per query tile) --------------------------

template <int D, int NWG>
struct DqTc {
  static constexpr int BM = 64 * NWG;      // queries a block
  static constexpr int KB = 64;            // keys a step
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KT_BYTES = KB * D * 2;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * ST * KT_BYTES +
                              8 * (1 + 2 * ST);
};

template <int D, int NWG>
__global__ void __launch_bounds__(tc_threads(NWG), 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int H, int n, Strides s, float scale) {
  using L = DqTc<D, NWG>;
  constexpr int BM = L::BM, KB = L::KB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + L::Q_BYTES;
  uint8_t* Ks = dOs + L::Q_BYTES;              // ST stages
  uint8_t* Vs = Ks + ST * L::KT_BYTES;         // ST stages
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * L::KT_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int nt = (n + BM - 1) / BM;
  const int qt = nt - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BM;
  const int n_kt = min(q0 + BM - 1, n - 1) / KB + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4 * NWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {                       // the producer warpgroup
    producer_regs<NWG>();
    if (warp == 4 * NWG && lane == 0) {
      mbar_arrive_tx(q_full, 2 * L::Q_BYTES);
      tma_load_tile<D>(Qs, &tq, q_full, BM, q0, h, b);
      tma_load_tile<D>(dOs, &tdo, q_full, BM, q0, h, b);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % ST;
        mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], 2 * L::KT_BYTES);
        tma_load_tile<D>(Ks + st * L::KT_BYTES, &tk, &full[st], KB, it * KB,
                         h, b);
        tma_load_tile<D>(Vs + st * L::KT_BYTES, &tv, &full[st], KB, it * KB,
                         h, b);
      }
    }
    return;
  }

  consumer_regs<NWG>();
  const int wg = warp / 4, qd = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  const float sl2 = scale * LOG2E;
  float lr[2], dr[2];                          // lse (log2 units), delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    lr[i] = qi < n ? lse[int64_t(bh) * n + qi] * LOG2E : 0.f;
    dr[i] = qi < n ? delta[int64_t(bh) * n + qi] : 0.f;
  }
  float sacc[KB / 2], pacc[KB / 2], dqacc[D / 2];
  zero_regs(sacc);
  zero_regs(pacc);
  zero_regs(dqacc);
  uint32_t da[KB / 16][4];

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % ST, k0 = it * KB;
    const uint8_t* Kt = Ks + st * L::KT_BYTES;
    const uint8_t* Vt = Vs + st * L::KT_BYTES;
    mbar_wait(&full[st], (it / ST) & 1);

    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<KB>(sacc, smem_desc_k(Qs, BM, 64 * wg, kk),
                   smem_desc_k(Kt, KB, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<KB>(pacc, smem_desc_k(dOs, BM, 64 * wg, kk),
                   smem_desc_k(Vt, KB, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(pacc);

    const bool edge = k0 + KB - 1 > q0 + 64 * wg || k0 + KB > n;
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float p = exp2f(fmaf(sacc[e], sl2, -lr[i]));
          if (edge) {
            const int kc = k0 + 8 * j + 2 * qd + c, qi = q0 + r0 + 8 * i;
            if (kc > qi || kc >= n) p = 0.f;
          }
          const float ds = (pacc[e] - dr[i]) * p;
          pacc[e] = ds * scale;
        }
    pack_frags<KB>(da, pacc);                    // ds*scale rounded to bf16

    fence_frags(da);
    fence_regs(dqacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
      wgmma_rs<D>(dqacc, da[kk], smem_desc_mn(Kt, KB, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqacc);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    if (qi < n)
      store_frag_row<D>(dq + b * s.b + h * s.h + int64_t(qi) * s.t, dqacc, i,
                        qd, 1.f);
  }
}

// ---- launches --------------------------------------------------------------

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

template <int D, int NWG>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, void* dk, void* dv,
                          int B, int H, int n, Strides s, float scale,
                          cudaStream_t stream) {
  using LK = DkdvTc<D, NWG>;
  using LQ = DqTc<D, NWG>;
  // dK/dV: key tiles of LK::BN, query steps of LK::QB;
  // dQ: query tiles of LQ::BM, key steps of LQ::KB
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  if (!bthd_map(&kq, q, B, H, n, D, s, LK::QB) ||
      !bthd_map(&kk, k, B, H, n, D, s, LK::BN) ||
      !bthd_map(&kv, v, B, H, n, D, s, LK::BN) ||
      !bthd_map(&kdo, dout, B, H, n, D, s, LK::QB) ||
      !bthd_map(&qq, q, B, H, n, D, s, LQ::BM) ||
      !bthd_map(&qk, k, B, H, n, D, s, LQ::KB) ||
      !bthd_map(&qv, v, B, H, n, D, s, LQ::KB) ||
      !bthd_map(&qdo, dout, B, H, n, D, s, LQ::BM))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(dkdv_tc_kernel<D, NWG>, LK::SMEM);
  if (err != cudaSuccess) return err;
  dkdv_tc_kernel<D, NWG>
      <<<dim3((n + LK::BN - 1) / LK::BN, B * H), tc_threads(NWG), LK::SMEM,
         stream>>>(kq, kk, kv, kdo, lse, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), H, n, s, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(dq_tc_kernel<D, NWG>, LQ::SMEM);
  if (err != cudaSuccess) return err;
  dq_tc_kernel<D, NWG>
      <<<dim3((n + LQ::BM - 1) / LQ::BM, B * H), tc_threads(NWG), LQ::SMEM,
         stream>>>(qq, qk, qv, qdo, lse, delta, static_cast<bf16*>(dq), H, n,
                   s, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int B, int H, int n,
                            Strides s, float scale, cudaStream_t stream) {
  const int64_t rows = int64_t(B) * n * H;
  const int warps_per_block = NT / 32;
  delta_kernel<bf16, D><<<unsigned((rows + warps_per_block - 1) /
                                   warps_per_block), NT, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, B,
      H, n, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (two_warpgroups(B, H, n))
    return launch_bwd_tc<D, 2>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                               n, s, scale, stream);
  return launch_bwd_tc<D, 1>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, n,
                             s, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Strides in
// elements, shared by every [B, T, H, D] tensor of the call (bf16: the
// TMA maps need 16-byte aligned bases).  Returns a cudaError_t (0 =
// launched).
extern "C" int geo_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, void* o,
                             float* lse, int B, int H, int n, long long sb,
                             long long st, long long sh, float scale,
                             void* stream) {
  const Strides s{int64_t(sb), int64_t(st), int64_t(sh)};
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

// delta is f32 [B, H, T] scratch the caller allocates.
extern "C" int geo_flash_bwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* o,
                             const void* dout, const float* lse,
                             float* delta, void* dq, void* dk, void* dv,
                             int B, int H, int n, long long sb, long long st,
                             long long sh, float scale, void* stream) {
  const Strides s{int64_t(sb), int64_t(st), int64_t(sh)};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_bwd<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 H, n, s, scale, cs);
  if (dtype == 0 && head_dim == 128)
    return launch_bwd<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                  H, n, s, scale, cs);
  if (dtype == 1 && head_dim == 64)
    return launch_bwd_bf16<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               H, n, s, scale, cs);
  if (dtype == 1 && head_dim == 128)
    return launch_bwd_bf16<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                H, n, s, scale, cs);
  return int(cudaErrorInvalidValue);
}
