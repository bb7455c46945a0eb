// One (Q-block, KV-block) partial attention for Hopper (sm_90a): the
// per-hop block of ring attention over a sequence-parallel axis.
//
// Replaces the Pallas TPU kernel geomx_tpu/ops/block_attention.py:72
// (_kernel, launched by _flash_fwd_impl's pallas_call at :141 and
// reached through flash_block_attention at :154), which
// geomx_tpu/parallel/ring_attention.py:106-111 calls once per ring hop
// when fast="flash".  The plain PyTorch version is block_attention_ref
// in geomx_tpu_torch/ops/block_attention.py; the ctypes binding and the
// build are in geomx_tpu_torch/ops/kernels/block_attention.py.  There is
// no backward kernel here, as there is none in the JAX package: the
// backward recomputes the plain version and takes its gradient.
//
// Contract (the Pallas kernel's, in shape and meaning): q [B, Tq, H, D],
// k and v [B, Tk, H, D], contiguous, f32 or bf16, D 64 or 128; q_off and
// k_off are the global positions of q's and k's first tokens.  Outputs,
// all f32 and unnormalised: m [B, Tq, H] the row max of the scaled
// scores, l [B, Tq, H] = sum_k exp(s - m), o [B, Tq, H, D] =
// sum_k round(exp(s - m)) v, where round() is to the input type.  With
// causal, a score whose query position is before its key position is
// exactly -1e30 (not -inf) and takes part in the max and the sums, so a
// fully masked row gives m = -1e30, l = Tk and o = sum_k v: the junk the
// ring's merge wipes.  No tile is skipped.  Keys past Tk (the ragged
// edge of the last tile) take no part at all.
//
// What bounds it on an H100.  At the MFU config's ring hop (sp = 4:
// B 4, Tq = Tk 512, H 16, D 128, bf16) the function reads q, k, v
// (25.2 MB) and writes m, l, o (17.0 MB): 42.2 MB, 12.6 us at 3.35 TB/s;
// its two products are 8.6 GFLOP, 8.7 us at 989 bf16 TFLOP/s.  So bytes
// bound it, barely.  This first version computes with plain f32 FMAs
// from shared memory, as the flash kernels do (no tensor cores, no
// TMA): it does a third product's work more than the function (the
// scores twice, below), so at ~10 TFLOP/s it is operations that hold it,
// about a hundred times the bound; wgmma/TMA tiles are later work.
//
// Design:
//   * one block of 256 threads per (64-row query tile, b*h); each tile
//     row is owned by 4 neighbouring lanes of one warp, each lane holding
//     16 of the 64 columns of a score tile, so a row's max and sum are
//     two __shfl_xor steps and the score tile never leaves the warp;
//   * two passes over the key tiles.  The first takes the row max over
//     the whole of Tk; the second forms p = exp(s - m) in f32, adds it to
//     l, and adds round(p) v to o.  So p is rounded after the whole-row
//     max, where the Pallas kernel rounds it (it takes the max over all
//     of Tk before it exponentiates); an online softmax would round
//     against a running max instead.  Both passes form the scores with
//     the same function, so the second pass never sees a score above m;
//   * the ragged edges: query rows past Tq are loaded as zeros and never
//     stored; key columns past Tk are left out of the max and the sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;        // rows of a tile (queries or keys)
constexpr int NT = 256;       // threads a block: 4 lanes per tile row
constexpr int PAD = 4;        // floats of padding per [BR][D] tile row
constexpr int SP = BR + 1;    // row stride of the [BR][BR] p tile
constexpr int NC = BR / 4;    // score columns a lane holds
constexpr float MASK = -1e30f;

template <typename E> __device__ __forceinline__ float to_f(E x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded through the input type (round to nearest even, as torch
// casts; the identity for f32)
template <typename E> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows row0 .. row0+BR-1 of head h of batch b of a contiguous [B, T, H, D]
// tensor into a [BR][D + PAD] f32 tile; rows past n are zeros.
template <typename E, int D>
__device__ __forceinline__ void load_tile(float* dst, const E* src, int b,
                                          int h, int H, int row0, int n) {
  const int64_t base = (int64_t(b) * n * H + h) * D;
  const int64_t st = int64_t(H) * D;
  for (int i = threadIdx.x; i < BR * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = row0 + r;
    dst[r * (D + PAD) + d] = t < n ? to_f<E>(src[base + t * st + d]) : 0.f;
  }
}

// The lane's NC scaled and masked scores of row r against the key tile
// starting at k0: column k0 + qd + 4j.  Columns past Tk are -inf (left
// out of the max; the caller drops them from the sums).
template <int D>
__device__ __forceinline__ void scores(float (&sc)[NC], const float* Qs,
                                       const float* Ks, int r, int qd,
                                       int q_pos, int k0, int Tk,
                                       int k_off, bool causal, float scale) {
#pragma unroll
  for (int j = 0; j < NC; ++j) sc[j] = 0.f;
  const float* a = Qs + r * (D + PAD);
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + d);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(
          Ks + (qd + 4 * j) * (D + PAD) + d);
      sc[j] += av.x * bv.x + av.y * bv.y + av.z * bv.z + av.w * bv.w;
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int kc = k0 + qd + 4 * j;
    if (kc >= Tk)
      sc[j] = -INFINITY;
    else if (causal && q_pos < k_off + kc)
      sc[j] = MASK;
    else
      sc[j] *= scale;
  }
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename E, int D>
__global__ void __launch_bounds__(NT)
block_attn_kernel(const E* __restrict__ q, const E* __restrict__ k,
                  const E* __restrict__ v, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ o_out,
                  int H, int Tq, int Tk, int q_off, int k_off, int causal,
                  float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BR * (D + PAD);
  float* Vs = Ks + BR * (D + PAD);
  float* Ps = Vs + BR * (D + PAD);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const int q0 = blockIdx.x * BR, qi = q0 + r;
  const int q_pos = q_off + qi;
  const int nk = (Tk + BR - 1) / BR;
  const bool cz = causal != 0;

  load_tile<E, D>(Qs, q, b, h, H, q0, Tq);

  // pass 1: the row max over the whole of Tk
  float m = -INFINITY;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();   // the last tile's readers are done
    load_tile<E, D>(Ks, k, b, h, H, k0, Tk);
    __syncthreads();
    float sc[NC];
    scores<D>(sc, Qs, Ks, r, qd, q_pos, k0, Tk, k_off, cz, scale);
#pragma unroll
    for (int j = 0; j < NC; ++j) m = fmaxf(m, sc[j]);
  }
  m = row_max(m);

  // pass 2: p = exp(s - m) into l, round(p) v into o
  float l = 0.f;
  float4 acc[D / 16];
#pragma unroll
  for (int jj = 0; jj < D / 16; ++jj)
    acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();
    load_tile<E, D>(Ks, k, b, h, H, k0, Tk);
    load_tile<E, D>(Vs, v, b, h, H, k0, Tk);
    __syncthreads();
    float sc[NC];
    scores<D>(sc, Qs, Ks, r, qd, q_pos, k0, Tk, k_off, cz, scale);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      // a column past Tk is -inf: p = 0, and V's row there is zeros
      const float p = sc[j] == -INFINITY ? 0.f : expf(sc[j] - m);
      l += p;
      Ps[r * SP + qd + 4 * j] = round_to<E>(p);
    }
    __syncwarp();   // row r of Ps was written by this warp's 4 lanes
    const float* pr = Ps + r * SP;
#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      const float pc = pr[c];
      const float* x = Vs + c * (D + PAD) + 4 * qd;
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        const float4 xv = *reinterpret_cast<const float4*>(x + 16 * jj);
        acc[jj].x += pc * xv.x;
        acc[jj].y += pc * xv.y;
        acc[jj].z += pc * xv.z;
        acc[jj].w += pc * xv.w;
      }
    }
  }
  l = row_sum(l);

  if (qi < Tq) {
    const int64_t row = (int64_t(b) * Tq + qi) * H + h;
    if (qd == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
    float* dst = o_out + row * D + 4 * qd;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj)
      *reinterpret_cast<float4*>(dst + 16 * jj) = acc[jj];
  }
}

constexpr size_t smem_bytes(int D) {
  return (3 * size_t(BR) * (D + PAD) + size_t(BR) * SP) * sizeof(float);
}

template <typename E, int D>
cudaError_t launch(const void* q, const void* k, const void* v, float* m,
                   float* l, float* o, int B, int H, int Tq, int Tk,
                   int q_off, int k_off, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BR - 1) / BR, B * H);
  block_attn_kernel<E, D><<<grid, NT, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), m, l, o, H, Tq, Tk, q_off, k_off, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Every tensor
// contiguous; m, l f32 [B, Tq, H] and o f32 [B, Tq, H, D] are written
// whole.  Returns a cudaError_t (0 = launched).
extern "C" int geo_block_attn_fwd(int dtype, int head_dim, const void* q,
                                  const void* k, const void* v, float* m,
                                  float* l, float* o, int B, int H, int Tq,
                                  int Tk, int q_off, int k_off, int causal,
                                  float scale, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, m, l, o, B, H, Tq, Tk, q_off, k_off,
                             causal, scale, cs);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, m, l, o, B, H, Tq, Tk, q_off, k_off,
                              causal, scale, cs);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, m, l, o, B, H, Tq, Tk, q_off,
                                     k_off, causal, scale, cs);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, m, l, o, B, H, Tq, Tk, q_off,
                                      k_off, causal, scale, cs);
  return int(cudaErrorInvalidValue);
}
