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
// What bounds it on an H100.  A causal pass does 2*B*H*T(T+1)*D flops
// (forward; the backward 2.5x that) on 4*B*T*H*D input and output
// elements.  At the flagship LM's (8,128,6,64) that is ~32 flops a byte
// in bf16: below the card's ~295 bf16 tensor-core flops per byte of HBM
// traffic, so bytes bound it there (~1 us).  At the MFU config's
// (4,2048,16,128) it is ~510 flops a byte: operations (69 us in bf16 on
// the tensor cores, 1 ms at the f32 FMA rate).  This first version
// computes with plain f32 FMAs from shared memory (no tensor cores, no
// TMA): each (query tile, key tile) pair reads its tiles from device
// memory once, converted to f32 into shared memory, and the products
// are register-blocked 16 columns a lane with 16-byte shared loads.
// Those products issue one shared-memory load per 4 FMAs, and the
// kernels reach ~8-10 TFLOP/s at the MFU shape on an H100 (chip_smoke.py),
// against 67 for f32 FMAs; wgmma/TMA tiles on the tensor cores are
// later work.
//
// Design, from the TPU kernel's online softmax:
//   * one block of 256 threads per (64-row tile, b*h); each tile row is
//     owned by 4 neighbouring lanes of one warp, each lane holding 16
//     of the 64 columns of the score tile, so row max and row sum are
//     two __shfl_xor steps and the score tile never leaves the warp;
//   * the forward loops over key tiles 0..diagonal with the running
//     max m and sum l in f32; p is rounded to the input type before the
//     PV product (as the plain version rounds softmax(s) before it);
//     masked scores are -inf and both exp() sites are guarded, so no
//     exp(-inf - (-inf)) is ever formed; key 0 is visible to every row,
//     so m is finite after the first tile and lse = m + log(l) is finite;
//   * the backward recomputes p = exp(s*scale - lse) in f32 (0 where
//     masked, no infinities at all); dK/dV takes one block per key tile
//     looping over query tiles from the diagonal down, dQ one block per
//     query tile looping over key tiles; no atomics, so results are
//     the same bits run to run.
//   * ragged tiles: rows past T are loaded as zeros, masked, and never
//     stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// x rounded through the input type (the identity for f32)
template <typename E> __device__ __forceinline__ float round_to(float x) {
  return to_f<E>(from_f<E>(x));
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

// ---- forward ---------------------------------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
           const E* __restrict__ v, E* __restrict__ o,
           float* __restrict__ lse, int H, int n, Strides s, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + tile_floats(D);
  float* Vs = Ks + tile_floats(D);
  float* Ps = Vs + tile_floats(D);

  const int nt = (n + BR - 1) / BR;
  const int qt = nt - 1 - blockIdx.x;   // the longest rows start first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t base = b * s.b + h * s.h;
  const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const int q0 = qt * BR, qi = q0 + r;

  load_tile<E, D>(Qs, q, base, q0, n, s.t);
  float m = -INFINITY, l = 0.f;
  float4 acc[D / 16];
  zero<D>(acc);
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();   // the last tile's readers are done
    load_tile<E, D>(Ks, k, base, k0, n, s.t);
    load_tile<E, D>(Vs, v, base, k0, n, s.t);
    __syncthreads();
    float sc[NC];
    dot_rows<D>(sc, Qs, Ks, r, qd);
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int kc = k0 + qd + 4 * j;
      sc[j] = (kc < n && kc <= qi) ? sc[j] * scale : -INFINITY;
      mt = fmaxf(mt, sc[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float mn = fmaxf(m, mt);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - mn);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = (sc[j] == -INFINITY) ? 0.f : expf(sc[j] - mn);
      ls += p;
      Ps[r * SP + qd + 4 * j] = round_to<E>(p);
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = mn;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      acc[jj].x *= alpha;
      acc[jj].y *= alpha;
      acc[jj].z *= alpha;
      acc[jj].w *= alpha;
    }
    __syncwarp();   // row r of Ps was written by this warp's 4 lanes
    acc_mx<D>(acc, Ps, Vs, r, qd);
  }
  if (qi < n) {
    store_row<E, D>(o + base + qi * s.t, acc, 1.f / l, qd);
    if (qd == 0) lse[int64_t(bh) * n + qi] = m + logf(l);
  }
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

constexpr size_t fwd_smem(int D) {
  return (3 * tile_floats(D) + score_floats()) * sizeof(float);
}
constexpr size_t dkdv_smem(int D) {
  return (4 * tile_floats(D) + 2 * score_floats() + 2 * BR) * sizeof(float);
}
constexpr size_t dq_smem(int D) {
  return (4 * tile_floats(D) + score_floats() + 2 * BR) * sizeof(float);
}

template <typename E, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int n, Strides s,
                       float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BR - 1) / BR, B * H);
  fwd_kernel<E, D><<<grid, NT, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), lse, H, n, s, scale);
  return cudaGetLastError();
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Strides in
// elements, shared by every [B, T, H, D] tensor of the call.  Returns a
// cudaError_t (0 = launched).
extern "C" int geo_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, void* o,
                             float* lse, int B, int H, int n, long long sb,
                             long long st, long long sh, float scale,
                             void* stream) {
  const Strides s{int64_t(sb), int64_t(st), int64_t(sh)};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_fwd<float, 64>(q, k, v, o, lse, B, H, n, s, scale, cs);
  if (dtype == 0 && head_dim == 128)
    return launch_fwd<float, 128>(q, k, v, o, lse, B, H, n, s, scale, cs);
  if (dtype == 1 && head_dim == 64)
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, n, s, scale,
                                         cs);
  if (dtype == 1 && head_dim == 128)
    return launch_fwd<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, n, s, scale,
                                          cs);
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
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, dk,
                                         dv, B, H, n, s, scale, cs);
  if (dtype == 1 && head_dim == 128)
    return launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, B, H, n, s, scale, cs);
  return int(cudaErrorInvalidValue);
}
