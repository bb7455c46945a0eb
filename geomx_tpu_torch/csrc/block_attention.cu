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
// k and v [B, Tk, H, D], f32 or bf16, D 64 or 128; q_off and k_off are
// the global positions of q's and k's first tokens.  Outputs, all f32,
// contiguous and unnormalised: m [B, Tq, H] the row max of the scaled
// scores, l [B, Tq, H] = sum_k exp(s - m), o [B, Tq, H, D] =
// sum_k round(exp(s - m)) v, where round() is to the input type (the
// identity in f32, whose products are to f32 accuracy).  With
// causal, a score whose query position is before its key position is
// exactly -1e30 (not -inf) and takes part in the max and the sums, so a
// fully masked row gives m = -1e30, l = Tk and o = sum_k v: the junk the
// ring's merge wipes.  Keys past Tk (the ragged edge of the last tile)
// take no part at all.  A key tile is skipped only where that changes
// no bit: when every score in it is masked for every real row of the
// query tile (q_off + qe < k_off + k0, qe the tile's last row below Tq)
// and every row of the query tile sees at least one key (q_off + q0 >=
// k_off), its p would be exactly 0 and its scores lie below every row's
// max.  A query tile whose rows are all fully masked (q_off + qe <
// k_off) forms no score: it writes m = -1e30, l = Tk and o = sum_k v.
//
// What bounds it on an H100.  At the MFU config's ring hop (sp = 4:
// B 4, Tq = Tk 512, H 16, D 128, bf16) the function reads q, k, v
// (25.2 MB) and writes m, l, o (17.0 MB): 42.2 MB, 12.6 us at 3.35 TB/s;
// its two products are 8.6 GFLOP, 8.7 us at 989 bf16 TFLOP/s.  So bytes
// bound it, barely.
//
// bf16: tensor cores (wgmma) fed by TMA, on the tiles of
// hopper_tiles.cuh, as the bf16 flash forward (flash_attention.cu).  One
// block per (query tile, b*h), one producer warp issuing every copy
// (64-column boxes, 128-byte swizzle, rows past T zero-filled; the maps
// take the tensors' strides, so a ring shard's view is read in place)
// into a 2-stage ring of key tiles (128 keys) guarded by full/empty
// mbarriers, and one or two consumer warpgroups of 64 query rows.
//   * two passes over the key tiles, so p is rounded after the
//     whole-row max, where the Pallas kernel rounds it (it takes the max
//     over all of Tk before it exponentiates; an online softmax would
//     round against a running max and give other bits).  Pass 1 streams
//     K alone and takes the row max of S = Q K^T (wgmma, both operands
//     K-major).  Pass 2 streams K and V, forms the same S with the same
//     instructions (so it never sees a score above m), p = expf(s - m)
//     in f32 into l, and feeds p rounded to bf16 (round to nearest even,
//     as torch casts) from its registers as the A operand of O += P V,
//     V read MN-major.  Three products for the function's two;
//   * JAX's order on the accumulator fragment: s = acc * scale, then a
//     masked score is set to exactly -1e30 and a key past Tk to -inf,
//     then p = expf(s - m), the subtraction first: on a fully masked row
//     s - m is exactly 0, so p = 1 and l = Tk exactly (an fma of the
//     scale into the exponent, as the flash forward does, would leave a
//     rounding residue of -1e30 * scale, and p = inf);
//   * the fully masked query tile (the ring's hops above the diagonal)
//     streams V alone and runs O += 1 V with a fragment of ones;
//   * the grid runs (b*h) fastest and the query tiles from the last: in
//     a causal hop the tiles with the most visible keys start first, so
//     the short ones fill the tail;
//   * tile height: two consumer warpgroups (128-row tiles) when the grid
//     of 128-row tiles covers every SM once, else one (64-row tiles), the
//     flash kernels' rule; the producer warpgroup gives its registers to
//     two consumers (setmaxnreg), so neither spills.
// f32 (block_attn_f32_tc_kernel): the tensor cores too, every product to
// f32 accuracy (the port's f32 convention: 3xTF32, three TF32 wgmma
// products of split operands, hopper_tiles.cuh; a single TF32 product
// is not allowed).  At the MFU hop in f32 the bytes are 67.4 MB, 0.020
// ms, and the products 3 x 8.6 GFLOP at 495 TF32 TFLOP/s, 0.052 ms: the
// operations bound "below" and "diagonal", the bytes "above" (the FMA
// kernel's bound was 0.128 ms).  The same tiles and pipeline as the f32
// flash forward (flash_attention.cu, hopper_tiles.cuh's Tf32Pipe): f32
// TMA boxes of 32 columns read the ring's views in place, three warps
// split Q and K into hi and lo and transpose V into Vt a step ahead, one
// consumer warpgroup of 64 query rows runs key steps of 32.
//   * one pass with an online softmax: rounding p to f32 is the
//     identity, so nothing needs the whole-row max before p is formed
//     (the bf16 path's second pass exists for that alone); an online
//     softmax changes bits only within f32 rounding.  JAX's order on the
//     fragment as in bf16 (scale, then exactly -1e30 or -inf), the first
//     tile holds key 0, so the running max is finite from it on: the
//     rescale exp(m - m') never meets -inf - (-inf), and a fully masked
//     row takes exp(MASK - MASK) = 1 at every step, so l = Tk exactly;
//   * the same skip rule, tile order and fully masked tile (V alone,
//     O += 1 V, with hi = 1 and lo = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr float MASK = -1e30f;

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- bf16 on the tensor cores ----------------------------------------------

using hopper::align1024;
using hopper::consumer_regs;
using hopper::fence_frags;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_tx;
using hopper::mbar_wait;
using hopper::pack_bf16;
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

constexpr int ST = 2;         // stages of the copy ring
constexpr int BN = 128;       // keys a step

struct Strides {
  int64_t b, t, h;   // elements between rows of b, t and h
};

template <int D, int NWG>
struct BlockTc {
  static constexpr int BM = 64 * NWG;      // query rows a block
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES +
                              8 * (1 + 2 * ST);
};

// S = Q K^T for the warpgroup's 64 rows of the Q tile (rows 64 wg ..)
// against a key tile of BN keys: both operands K-major.
template <int D, int NWG>
__device__ __forceinline__ void qk(float (&s)[BN / 2], const uint8_t* Qs,
                                   const uint8_t* Kt, int wg) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BN>(s, smem_desc_k(Qs, 64 * NWG, 64 * wg, kk),
                 smem_desc_k(Kt, BN, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// O += P V: P from registers (BN/16 A fragments), V MN-major.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   uint32_t (&pa)[BN / 16][4],
                                   const uint8_t* Vt) {
  fence_frags(pa);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D>(o, pa[kk], smem_desc_mn(Vt, BN, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// JAX's order on the fragment: s = acc * scale in f32, then a masked
// score (query position before key position) is exactly MASK and a key
// past Tk is -inf.  Element 4j + 2i + c is row qp[i], key k0 + 8j + 2qd
// + c.  `edge` (warp-uniform) is false when no element of the tile can
// be masked or past Tk.  N: the accumulator's registers (keys / 2).
template <int N>
__device__ __forceinline__ void scale_mask(float (&s)[N], const int (&qp)[2],
                                           int k0, int qd, int Tk, int k_off,
                                           bool causal, bool edge,
                                           float scale) {
#pragma unroll
  for (int x = 0; x < N; ++x) s[x] *= scale;
  if (!edge) return;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kc = k0 + 8 * j + 2 * qd + c;
        float& x = s[4 * j + 2 * i + c];
        if (kc >= Tk)
          x = -INFINITY;
        else if (causal && qp[i] < k_off + kc)
          x = MASK;
      }
}

template <int D, int NWG>
__global__ void __launch_bounds__(tc_threads(NWG), 1)
block_attn_tc_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ o_out, int H, int Tq, int Tk,
                     int q_off, int k_off, int causal, float scale) {
  using L = BlockTc<D, NWG>;
  constexpr int BM = L::BM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + L::Q_BYTES;               // ST stages
  uint8_t* Vs = Ks + ST * L::KV_BYTES;         // ST stages
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * L::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  // the query tiles with the most keys to run first: every (b, h) of
  // the last tile, then of the one before, and so on
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * BM;
  const int qe = min(q0 + BM, Tq) - 1;         // the tile's last real row
  const int nk = (Tk + BN - 1) / BN;
  const bool cz = causal != 0;
  // every real row fully masked: no score, o = sum_k v
  const bool masked = cz && q_off + qe < k_off;
  // every row sees a key: the key tiles past the last visible one are
  // all masked and are skipped
  const int n_kt = cz && q_off + q0 >= k_off
                       ? min(nk, (q_off + qe - k_off) / BN + 1)
                       : nk;
  const int n_items = masked ? nk : 2 * n_kt;  // pass 1, then pass 2
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
      if (!masked) {
        mbar_arrive_tx(q_full, L::Q_BYTES);
        tma_load_tile<D>(Qs, &tq, q_full, BM, q0, h, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % ST;
        const bool pass1 = !masked && it < n_kt;
        const int k0 = (masked || pass1 ? it : it - n_kt) * BN;
        mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], masked || pass1 ? L::KV_BYTES
                                                  : 2 * L::KV_BYTES);
        if (!masked)
          tma_load_tile<D>(Ks + st * L::KV_BYTES, &tk, &full[st], BN, k0, h,
                           b);
        if (!pass1)
          tma_load_tile<D>(Vs + st * L::KV_BYTES, &tv, &full[st], BN, k0, h,
                           b);
      }
    }
    return;
  }

  consumer_regs<NWG>();
  const int wg = warp / 4, qd = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;   // tile row, i = 0
  const int qp[2] = {q_off + q0 + r0, q_off + q0 + r0 + 8};
  // the warp's rows are q_off + w0 .. w0 + 15: a key tile can hold a
  // masked score for them only if its last key lies past the first row
  const int w0 = q_off + q0 + 64 * wg + 16 * (warp % 4);
  float oacc[D / 2];
  zero_regs(oacc);
  float m[2], l[2];

  if (masked) {
    // p = exp(MASK - MASK) = 1 for every key below Tk; V's rows past Tk
    // are zeros
    uint32_t ones[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) ones[kk][x] = pack_bf16(1.f, 1.f);
    for (int it = 0; it < nk; ++it) {
      const int st = it % ST;
      mbar_wait(&full[st], (it / ST) & 1);
      pv<D>(oacc, ones, Vs + st * L::KV_BYTES);
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    m[0] = m[1] = MASK;
    l[0] = l[1] = float(Tk);
  } else {
    float sacc[BN / 2];
    mbar_wait(q_full, 0);
    // pass 1: the row max over every key tile that can hold it
    m[0] = m[1] = -INFINITY;
    for (int it = 0; it < n_kt; ++it) {
      const int st = it % ST, k0 = it * BN;
      mbar_wait(&full[st], (it / ST) & 1);
      qk<D, NWG>(sacc, Qs, Ks + st * L::KV_BYTES, wg);
      if (lane == 0) mbar_arrive(&empty[st]);
      const bool edge = k0 + BN > Tk || (cz && w0 < k_off + k0 + BN - 1);
      scale_mask(sacc, qp, k0, qd, Tk, k_off, cz, edge, scale);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          m[i] = fmaxf(m[i], fmaxf(sacc[4 * j + 2 * i],
                                   sacc[4 * j + 2 * i + 1]));
    }
    m[0] = row_max(m[0]);   // finite: key 0 lies in the first tile
    m[1] = row_max(m[1]);

    // pass 2: p = exp(s - m) into l, round(p) V into o
    l[0] = l[1] = 0.f;
    uint32_t pa[BN / 16][4];
    for (int t = 0; t < n_kt; ++t) {
      const int it = n_kt + t, st = it % ST, k0 = t * BN;
      mbar_wait(&full[st], (it / ST) & 1);
      qk<D, NWG>(sacc, Qs, Ks + st * L::KV_BYTES, wg);
      const bool edge = k0 + BN > Tk || (cz && w0 < k_off + k0 + BN - 1);
      scale_mask(sacc, qp, k0, qd, Tk, k_off, cz, edge, scale);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sacc[4 * j + 2 * i + c];
            x = expf(x - m[i]);              // past Tk: exp(-inf) = 0
            l[i] += x;
          }
      pack_frags<BN>(pa, sacc);                // p rounded to bf16
      pv<D>(oacc, pa, Vs + st * L::KV_BYTES);
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    l[0] = row_sum(l[0]);
    l[1] = row_sum(l[1]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    if (qi >= Tq) continue;                    // padding rows: not stored
    const int64_t row = (int64_t(b) * Tq + qi) * H + h;
    if (qd == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
    float* dst = o_out + row * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(oacc[4 * j + 2 * i], oacc[4 * j + 2 * i + 1]);
  }
}

// ---- f32: 3xTF32 on the tensor cores, one pass ------------------------------

template <int D>
__global__ void __launch_bounds__(tc_threads(1), 1)
block_attn_f32_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         float* __restrict__ o_out, int H, int Tq, int Tk,
                         int q_off, int k_off, int causal, float scale) {
  using L = hopper::Tf32Tiles<D>;
  constexpr int BM = L::BM, BN = L::BN, ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  const hopper::Tf32Pipe<D> pp(smem_raw);

  // the query tiles with the most keys to run first, as the bf16 kernel
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * BM;
  const int qe = min(q0 + BM, Tq) - 1;         // the tile's last real row
  const int nk = (Tk + BN - 1) / BN;
  const bool cz = causal != 0;
  const bool masked = cz && q_off + qe < k_off;   // o = sum_k v, no score
  const int n_kt = cz && q_off + q0 >= k_off
                       ? min(nk, (q_off + qe - k_off) / BN + 1)
                       : nk;
  const int n_items = masked ? nk : n_kt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) pp.init();
  __syncthreads();
  if (warp == 4) {                             // the copies
    if (lane == 0) pp.produce(&tq, &tk, &tv, q0, h, b, n_items, !masked);
    return;
  }
  if (warp > 4) {                              // the splits
    pp.convert(n_items, !masked, threadIdx.x - 5 * 32);
    return;
  }

  const int qd = lane % 4;
  const int r0 = 16 * warp + lane / 4;         // tile row, i = 0
  const int qp[2] = {q_off + q0 + r0, q_off + q0 + r0 + 8};
  const int w0 = q_off + q0 + 16 * warp;       // the warp's first row
  float oacc[D / 2];
  zero_regs(oacc);
  float m[2], l[2];
  uint32_t phi[BN / 8][4], plo[BN / 8][4];

  if (masked) {
    // p = exp(MASK - MASK) = 1 for every key below Tk; V's rows past Tk
    // are zeros.  hi = 1 and lo = 0 make O += V exactly as 3xTF32 forms
    // it.
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        phi[kk][x] = __float_as_uint(1.f);
        plo[kk][x] = 0u;
      }
    for (int it = 0; it < nk; ++it) {
      const int st = it % ST;
      mbar_wait(&pp.cv_full[st], (it / ST) & 1);
      if (lane == 0) mbar_arrive(&pp.empty[st]);   // V is transposed
      hopper::pv_tf32x3<D, BN>(oacc, phi, plo, pp.stage(pp.vt, it),
                               pp.stage(pp.vt_lo, it));
      if (lane == 0) mbar_arrive(&pp.cv_empty[st]);
    }
    m[0] = m[1] = MASK;
    l[0] = l[1] = float(Tk);
  } else {
    float sacc[BN / 2];
    uint32_t qa[D / 8][4];
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    mbar_wait(pp.q_ready, 0);
    hopper::load_q_frags<D>(qa, pp.q, BM);
    for (int it = 0; it < n_kt; ++it) {
      const int st = it % ST, k0 = it * BN;
      mbar_wait(&pp.cv_full[st], (it / ST) & 1);
      hopper::qk_tf32x3<D, BN>(sacc, qa, pp.q_lo, BM, pp.stage(pp.k, it),
                               pp.stage(pp.k_lo, it));
      if (lane == 0) mbar_arrive(&pp.empty[st]);   // K is read
      const bool edge = k0 + BN > Tk || (cz && w0 < k_off + k0 + BN - 1);
      scale_mask(sacc, qp, k0, qd, Tk, k_off, cz, edge, scale);
      // the online softmax: the first tile holds key 0, whose score is
      // real or MASK, so the running max is finite from it on and no
      // exp(-inf - (-inf)) is formed; on a fully masked row every step
      // is exp(MASK - MASK) = 1
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mt = fmaxf(mt, fmaxf(sacc[4 * j + 2 * i], sacc[4 * j + 2 * i + 1]));
        const float mn = fmaxf(m[i], row_max(mt));
        alpha[i] = expf(m[i] - mn);            // 0 on the first tile
        m[i] = mn;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sacc[4 * j + 2 * i + c];
            x = expf(x - m[i]);                // past Tk: exp(-inf) = 0
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
    l[0] = row_sum(l[0]);
    l[1] = row_sum(l[1]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    if (qi >= Tq) continue;                    // padding rows: not stored
    const int64_t row = (int64_t(b) * Tq + qi) * H + h;
    if (qd == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
    float* dst = o_out + row * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(oacc[4 * j + 2 * i], oacc[4 * j + 2 * i + 1]);
  }
}

// ---- launches --------------------------------------------------------------

template <int D, int NWG>
cudaError_t launch_tc(const void* q, const void* k, const void* v, float* m,
                      float* l, float* o, int B, int H, int Tq, int Tk,
                      const Strides (&s)[3], int q_off, int k_off,
                      int causal, float scale, cudaStream_t stream) {
  using L = BlockTc<D, NWG>;
  CUtensorMap tq, tk, tv;
  if (!hopper::make_bthd_map(&tq, q, B, Tq, H, D, s[0].b, s[0].t, s[0].h,
                             L::BM) ||
      !hopper::make_bthd_map(&tk, k, B, Tk, H, D, s[1].b, s[1].t, s[1].h,
                             BN) ||
      !hopper::make_bthd_map(&tv, v, B, Tk, H, D, s[2].b, s[2].t, s[2].h,
                             BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_tc_kernel<D, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + L::BM - 1) / L::BM);
  block_attn_tc_kernel<D, NWG><<<grid, tc_threads(NWG), L::SMEM, stream>>>(
      tq, tk, tv, m, l, o, H, Tq, Tk, q_off, k_off, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, float* m,
                       float* l, float* o, int B, int H, int Tq, int Tk,
                       const Strides (&s)[3], int q_off, int k_off,
                       int causal, float scale, cudaStream_t stream) {
  using L = hopper::Tf32Tiles<D>;
  CUtensorMap tq, tk, tv;
  if (!hopper::make_bthd_map(&tq, q, B, Tq, H, D, s[0].b, s[0].t, s[0].h,
                             L::BM, 4) ||
      !hopper::make_bthd_map(&tk, k, B, Tk, H, D, s[1].b, s[1].t, s[1].h,
                             L::BN, 4) ||
      !hopper::make_bthd_map(&tv, v, B, Tk, H, D, s[2].b, s[2].t, s[2].h,
                             L::BN, 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_f32_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + L::BM - 1) / L::BM);
  block_attn_f32_tc_kernel<D><<<grid, tc_threads(1), L::SMEM, stream>>>(
      tq, tk, tv, m, l, o, H, Tq, Tk, q_off, k_off, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        float* m, float* l, float* o, int B, int H, int Tq,
                        int Tk, const Strides (&s)[3], int q_off, int k_off,
                        int causal, float scale, cudaStream_t stream) {
  if (two_warpgroups(B, H, Tq))
    return launch_tc<D, 2>(q, k, v, m, l, o, B, H, Tq, Tk, s, q_off, k_off,
                           causal, scale, stream);
  return launch_tc<D, 1>(q, k, v, m, l, o, B, H, Tq, Tk, s, q_off, k_off,
                         causal, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  strides: the
// (b, t, h) strides in elements of q, k and v, nine values; D is
// contiguous.  Both dtypes read through TMA maps built from them (bases
// 16-byte aligned, strides multiples of 16 bytes).  m, l f32 [B, Tq, H] and o f32 [B, Tq, H, D] are
// contiguous and written whole.  Returns a cudaError_t (0 = launched).
extern "C" int geo_block_attn_fwd(int dtype, int head_dim, const void* q,
                                  const void* k, const void* v, float* m,
                                  float* l, float* o, int B, int H, int Tq,
                                  int Tk, const long long* strides,
                                  int q_off, int k_off, int causal,
                                  float scale, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  Strides s[3];
  for (int i = 0; i < 3; ++i)
    s[i] = Strides{int64_t(strides[3 * i]), int64_t(strides[3 * i + 1]),
                   int64_t(strides[3 * i + 2])};
  if (dtype == 0 && head_dim == 64)
    return launch_f32<64>(q, k, v, m, l, o, B, H, Tq, Tk, s, q_off, k_off,
                          causal, scale, cs);
  if (dtype == 0 && head_dim == 128)
    return launch_f32<128>(q, k, v, m, l, o, B, H, Tq, Tk, s, q_off, k_off,
                           causal, scale, cs);
  if (dtype == 1 && head_dim == 64)
    return launch_bf16<64>(q, k, v, m, l, o, B, H, Tq, Tk, s, q_off, k_off,
                           causal, scale, cs);
  if (dtype == 1 && head_dim == 128)
    return launch_bf16<128>(q, k, v, m, l, o, B, H, Tq, Tk, s, q_off, k_off,
                            causal, scale, cs);
  return int(cudaErrorInvalidValue);
}
