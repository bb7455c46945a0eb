// Tile machinery for Hopper (sm_90a) kernels in raw PTX: TMA tensor maps
// and loads, an mbarrier ring, and warpgroup matrix multiply (wgmma) on
// bf16 tiles that TMA lands in shared memory with the 128-byte swizzle;
// and what the warp-specialised kernels built on it share (a producer
// warpgroup beside one or two consumer warpgroups, and the rule that
// picks how many).
//
// The one tile layout: a TMA box of 64 bf16 (128 bytes) by R rows,
// written with CU_TENSOR_MAP_SWIZZLE_128B, so row r sits at byte r*128 of
// the box and its 16-byte chunk c at chunk c ^ (r % 8).  A tile wider
// than 64 columns is several boxes one after another (box b at byte
// b*R*128).  Every box starts on a 1024-byte boundary, which the swizzle
// and the wgmma descriptors below assume.
//
// Such a tile feeds wgmma two ways:
//   * K-major (the product's depth runs along the row): smem_desc_k(); a
//     depth step of 16 elements is 32 bytes inside the swizzled row;
//   * MN-major (the depth runs down the rows, the output columns along
//     them): smem_desc_mn(); a depth step of 16 rows is 2048 bytes, and
//     the second 64 output columns are the next box.
//
// Accumulator fragment of an m64nN f32 wgmma, thread t of the warpgroup
// (warp w = t / 32, lane l): d[4j + 2i + c] is row 16w + l/4 + 8i,
// column 8j + 2(l%4) + c.  The same registers, two 8-column chunks at a
// time, are the A fragment of a register-A wgmma (pack_bf16), so a product's
// rows can feed the next product without leaving the registers.
//
// Kernels that include this header are launched without clusters;
// cluster-scoped PTX spellings below address the block's own shared
// memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: reach it through the
// runtime, so the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a bf16 [B, T, H, D] tensor (strides in elements) as the 4-D
// (D, H, T, B), with boxes of 64 columns by `rows` rows of one (b, h);
// rows past T read as zeros.  Returns false when the driver refuses it
// (a base address not 16-byte aligned, a stride not a multiple of 16
// bytes).
inline bool make_bthd_map(CUtensorMap* map, const void* base, int B, int T,
                          int H, int D, int64_t sb, int64_t st, int64_t sh,
                          int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(st) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: addresses, barriers, TMA ----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make barrier initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D map into shared memory; completion bytes go to `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// Rows row0 .. row0+rows-1 of the (b, h) slice, all D columns, as D/64
// boxes of `rows` x 64 one after another at `dst`.
template <int D>
__device__ __forceinline__ void tma_load_tile(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int rows,
                                              int row0, int h, int b) {
#pragma unroll
  for (int box = 0; box < D / 64; ++box)
    tma_load_4d(static_cast<char*>(dst) + box * rows * 128, map, bar,
                box * 64, h, row0, b);
}

// Hand registers between warpgroups: every warp of a warpgroup runs the
// same one, on paths that never join again.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- device: wgmma -----------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// K-major operand: 64 rows of a tile of `rows` rows starting at row
// `row0`, depth step kk (16 elements) of the tile's D columns.
__device__ __forceinline__ uint64_t smem_desc_k(const void* tile, int rows,
                                                int row0, int kk) {
  const uint32_t a = smem_addr(tile) + (kk / 4) * rows * 128 + row0 * 128 +
                     (kk % 4) * 32;
  return make_desc(a, 16, 1024);
}

// MN-major operand: depth step kk covers rows 16kk .. 16kk+15 of a tile
// of `rows` rows; its 64-column boxes are rows*128 bytes apart.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* tile, int rows,
                                                 int kk) {
  return make_desc(smem_addr(tile) + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across the async
// product's issue and wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two f32 as a bf16 pair, the first in the low half.  Four such pairs
// are the A fragment of a k16 step: a[0] = (r, 2q..2q+1), a[1] = (r+8,
// ..), a[2] = (r, 8+2q..), a[3] = (r+8, 8+2q..), which are the
// accumulator registers d[8kk .. 8kk+7] of columns 16kk .. 16kk+15.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define GEO_F8(i)                                                       \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

#define GEO_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define GEO_D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B: A and B both K-major in shared memory, bf16 in, f32 out;
// accumulate when `acc`, else overwrite.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GEO_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GEO_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24), GEO_F8(32), GEO_F8(40),
        GEO_F8(48), GEO_F8(56)
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B: A from registers (pack_bf16 fragments), B MN-major in shared
// memory (the transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GEO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GEO_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24), GEO_F8(32), GEO_F8(40),
        GEO_F8(48), GEO_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef GEO_F8
#undef GEO_D32
#undef GEO_D64

// ---- warp-specialised blocks ---------------------------------------------

constexpr int WG = 128;   // threads of a warpgroup

// nwg consumer warpgroups, then a producer warpgroup whose first warp
// issues the copies (setmaxnreg acts on whole warpgroups).  With two
// consumer warpgroups the block may hold 168 registers a thread, too few
// for the accumulators: the producer gives back all but 40, the
// consumers take 232 (with one, each thread may hold 255 at launch).
__host__ __device__ constexpr int tc_threads(int nwg) {
  return (nwg + 1) * WG;
}

template <int NWG>
__device__ __forceinline__ void producer_regs() {
  if constexpr (NWG == 2) setmaxnreg_dec<40>();
}
template <int NWG>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (NWG == 2) setmaxnreg_inc<232>();
}

// the first 1024-byte boundary at or after p (every box starts on one)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

template <int R>
__device__ __forceinline__ void zero_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// fence_regs for A fragments
template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// accumulator d[C/2] of a 64 x C product as C/16 A fragments
template <int C>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[C / 16][4],
                                           const float (&d)[C / 2]) {
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(d[8 * kk + 2 * x], d[8 * kk + 2 * x + 1]);
}

// ---- host: tile height -------------------------------------------------

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// Two consumer warpgroups (128-row tiles) when the grid of 128-row tiles
// covers every SM once; else one (64-row tiles, twice the blocks).
inline bool two_warpgroups(int B, int H, int n) {
  return int64_t((n + 127) / 128) * B * H >= sm_count();
}

}  // namespace hopper
