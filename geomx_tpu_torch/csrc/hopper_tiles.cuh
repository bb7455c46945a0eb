// Tile machinery for Hopper (sm_90a) kernels in raw PTX: TMA tensor maps
// and loads, an mbarrier ring, and warpgroup matrix multiply (wgmma) on
// bf16 or f32 tiles that TMA lands in shared memory with the 128-byte
// swizzle; f32 products to f32 accuracy on the tensor cores (3xTF32);
// and what the warp-specialised kernels built on it share (a producer
// warpgroup beside one or two consumer warpgroups, and the rule that
// picks how many).
//
// The one tile layout: a TMA box of 128 bytes (64 bf16 or 32 f32) by R
// rows, written with CU_TENSOR_MAP_SWIZZLE_128B, so row r sits at byte
// r*128 of the box and its 16-byte chunk c at chunk c ^ (r % 8).  A tile
// wider than one box is several boxes one after another (box b at byte
// b*R*128).  Every box starts on a 1024-byte boundary, which the swizzle
// and the wgmma descriptors below assume.
//
// Such a tile feeds wgmma two ways:
//   * K-major (the product's depth runs along the row): smem_desc_k(); a
//     depth step (16 bf16 or 8 TF32 elements) is 32 bytes inside the
//     swizzled row;
//   * MN-major (the depth runs down the rows, the output columns along
//     them): smem_desc_mn(); a depth step of 16 rows is 2048 bytes, and
//     the second 64 output columns are the next box.  bf16 only: TF32
//     wgmma takes K-major operands alone.
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

// Map of a bf16 (es = 2) or f32 (es = 4) [B, T, H, D] tensor (strides in
// elements) as the 4-D (D, H, T, B), with boxes of 128 bytes of columns
// (64 bf16, 32 f32) by `rows` rows of one (b, h); rows past T read as
// zeros.  Returns false when the driver refuses it (a base address not
// 16-byte aligned, a stride not a multiple of 16 bytes).
inline bool make_bthd_map(CUtensorMap* map, const void* base, int B, int T,
                          int H, int D, int64_t sb, int64_t st, int64_t sh,
                          int rows, int es = 2) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * es, cuuint64_t(st) * es,
                                 cuuint64_t(sb) * es};
  const cuuint32_t box[4] = {cuuint32_t(128 / es), 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map,
            es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, elem,
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

// Rows row0 .. row0+rows-1 of the (b, h) slice, all D columns of ES
// bytes, as D*ES/128 boxes of `rows` x 128 bytes at `dst`, one every
// `pitch` rows (default: one after another).
template <int D, int ES = 2>
__device__ __forceinline__ void tma_load_tile(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int rows,
                                              int row0, int h, int b,
                                              int pitch = 0) {
  const int step = (pitch ? pitch : rows) * 128;
#pragma unroll
  for (int box = 0; box < D * ES / 128; ++box)
    tma_load_4d(static_cast<char*>(dst) + box * step, map, bar,
                box * (128 / ES), h, row0, b);
}

// make generic-proxy writes to shared memory (the threads' own stores)
// visible to the async proxy (wgmma, TMA) before it reads the bytes
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of shared memory added element by element (f32 add, in the
// L2) into a 4-D map's box: the reverse of tma_load_4d, without a
// barrier; completion is tracked by bulk groups (bulk_commit, then
// bulk_wait_read before the box is written again, bulk_wait before the
// block exits).  Rows past the map's extent are dropped.
__device__ __forceinline__ void tma_reduce_add_4d(const void* src,
                                                  const CUtensorMap* map,
                                                  int c0, int c1, int c2,
                                                  int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the committed bulk groups have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Turns between blocks over an int in global memory: wait_turn spins
// until it reads `turn` (acquire, GPU scope), then orders the async
// proxy's next copies after that read; pass_turn, once the thread's
// bulk groups have completed (bulk_wait), orders their writes before a
// release add of 1.  Blocks that take turns this way must be dispatched
// in the order of their turns.  CUDA does not document that blocks are
// dispatched in blockIdx order (FlashAttention-3's deterministic
// backward rests on it too), so the spin is bounded: a wait longer than
// TURN_TIMEOUT_NS traps, and the launch fails with an error the host
// sees at its next synchronisation instead of hanging the card.  The
// low 32 bits of the nanosecond timer wrap every 4.29 s, more than the
// bound, so their unsigned difference is the time waited.
constexpr uint32_t TURN_TIMEOUT_NS = 2000000000u;   // 2 s

__device__ __forceinline__ uint32_t globaltimer_lo() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ void wait_turn(const int* flag, int turn) {
  int v;
  const uint32_t t0 = globaltimer_lo();
  for (;;) {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(flag)
                 : "memory");
    if (v == turn) break;
    if (globaltimer_lo() - t0 > TURN_TIMEOUT_NS) __trap();
    __nanosleep(32);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void pass_turn(int* flag) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(flag)
               : "memory");
}

// a barrier of `threads` threads (whole warps) on named barrier `id` (1-15;
// 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
// `row0`, depth step kk (32 bytes: 16 bf16 or 8 TF32 elements) of the
// tile's columns, four steps to a box.
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

#define GEO_D16                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
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

// d (+)= A B: A and B both MN-major in shared memory (both transpose bits
// set: A's rows, B's columns run along the tile's rows), bf16 in, f32
// out; accumulate when `acc`, else overwrite.
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss_mn<64>(float (&d)[32], uint64_t da,
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GEO_D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_mn<128>(float (&d)[64], uint64_t da,
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GEO_D64
      ", %64, %65, p, 1, 1, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24), GEO_F8(32), GEO_F8(40),
        GEO_F8(48), GEO_F8(56)
      : "l"(da), "l"(db), "r"(acc));
}

// The TF32 forms (k8, 32 bytes of depth a step): operands hold TF32
// values in 32-bit words, both K-major (TF32 has no transpose flags).

// d (+)= A B, A and B in shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32],
                                                  uint64_t da, uint64_t db,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " GEO_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[8],
                                                  uint64_t da, uint64_t db,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : GEO_F8(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16],
                                                  uint64_t da, uint64_t db,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " GEO_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8)
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B, A from registers: a[0] = (r, c), a[1] = (r+8, c), a[2] =
// (r, c+4), a[3] = (r+8, c+4), r = 16 w + l/4, c = l % 4 (warp w of the
// warpgroup, lane l); N = 32 for S, 64 and 128 for O
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " GEO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " GEO_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8), GEO_F8(16), GEO_F8(24), GEO_F8(32), GEO_F8(40),
        GEO_F8(48), GEO_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " GEO_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : GEO_F8(0), GEO_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef GEO_F8
#undef GEO_D16
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

// A kernel whose producer warpgroup does little may give more, so that
// its consumers take 240: the consumers can only take what the producer
// gives back of the block's 168 a thread, (240 - 168) * 256 = (168 - 24)
// * 128, so the producer keeps 24 (with 32, setmaxnreg.inc waits
// forever).
template <int NWG, int P = 40>
__device__ __forceinline__ void producer_regs() {
  if constexpr (NWG == 2) setmaxnreg_dec<P>();
}
template <int NWG, int C = 232>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (NWG == 2) setmaxnreg_inc<C>();
}

// arrive at named barrier `id` (of `threads` threads) without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// ---- f32 attention tiles on the tensor cores: 3xTF32 ---------------------
//
// An f32 operand x is split into two parts: hi = x with the low 13
// mantissa bits cleared (a TF32 value, what the tensor core reads of x
// as stored: it ignores those bits) and lo = x - hi (exact in f32, below
// 2^-10 |x|).  A product is taken as hi hi' + hi lo' + lo hi', three
// TF32 products accumulated in f32; the dropped lo lo' and the bits the
// tensor core ignores in lo leave about 2^-20 of |x x'| a term, the
// order of f32 accumulation over D = 128 terms (one TF32 product alone
// is off by about 2^-10).
//
// The tiles of an attention step (64 query rows, BN keys a step): Q and
// K land by TMA as f32 K-major tiles (the depth D along the row), which
// serve as their own hi; their lo goes to a buffer of the same layout.
// V lands with the keys down the rows, but TF32 takes K-major operands
// only, so V is written transposed (Vt: D rows of BN keys, boxes of 32
// keys) as hi and lo.  Its keys go in the order 0 2 4 6 1 3 5 7 within
// each group of 8: then the S accumulator's own registers are the A
// fragments of P V (split_frags), with no shuffle and no trip through
// shared memory.
//
// A block (Tf32Pipe) has three roles: warps 0-3, one consumer
// warpgroup, run the products and the softmax, with Q's hi held in
// registers (load_q_frags); warp 4 issues the TMA copies into a 2-stage
// ring of raw K and V tiles; warps 5-7 split and transpose each landed
// stage into a second 2-stage ring (K_lo, Vt, Vt_lo), so a step's
// splitting overlaps the products of the step before.  Shared memory at
// BN = 32: Q, Q_lo 2*32 KB; raw K, V 2*2*16 KB; K_lo, Vt, Vt_lo 2*3*16
// KB: 224 KB at D = 128 (one block an SM), 112 KB at D = 64.  64-key
// steps, or a second consumer warpgroup, would not fit at D = 128, so
// the two-warpgroup rule below does not apply: a block of 256 threads
// may hold 255 registers a thread.  The consumer waits for each product
// before the next: a step's S issued ahead of the last step's softmax
// made ptxas serialize every wgmma (its note C7515), which cost more
// than the overlap gained.

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the lo of `bytes` of f32 at `tile` into `lo` (the same layout), by
// thread t of n; the tile itself is its hi
__device__ __forceinline__ void split_tile(const uint8_t* tile, uint8_t* lo,
                                           int bytes, int t, int n) {
  for (int i = 16 * t; i < bytes; i += 16 * n) {
    const float4 x = *reinterpret_cast<const float4*>(tile + i);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// byte of 16-byte chunk c of row r in a 128-byte-swizzled box
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// A V tile as TMA lands it (BN keys down the rows, D f32 columns in
// boxes of 32) into Vt and Vt_lo (D rows, BN keys along them in boxes of
// 32, keys 0 2 4 6 1 3 5 7 in each group of 8), by thread t of n.  A
// unit (of BN/4 * D/4) is 4 keys of one parity in a group by 4 columns:
// four 16-byte loads, a 4 x 4 transpose in registers, four 16-byte
// stores each of hi and lo.  Neighbouring threads take neighbouring
// (group, parity), so a warp's stores fill every bank.  The unit form
// puts the keys at positions kofs .. kofs+BN-1 of Vt's rows (a ring of
// several BN-key stages in one transposed tile, when BN < 32) and reads
// V's boxes vrows rows apart.
template <int D, int BN>
__device__ __forceinline__ void split_transpose_unit(const uint8_t* V,
                                                     uint8_t* Vt,
                                                     uint8_t* Vt_lo, int u,
                                                     int kofs, int vrows) {
  constexpr int GH = BN / 4;                   // (group, parity) pairs
  const int gh = u % GH, c = u / GH;           // c: the column quad
  const int g = gh / 2, par = gh % 2;
  float x[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 8 * g + par + 2 * i;         // the key
    const float4 f = *reinterpret_cast<const float4*>(
        V + (c / 8) * vrows * 128 + sw128(r, c % 8));
    x[i][0] = f.x;
    x[i][1] = f.y;
    x[i][2] = f.z;
    x[i][3] = f.w;
  }
  const int kp = kofs + 8 * g + 4 * par;       // its first key position
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = 4 * c + e;
    uint4 h, l;
    split_tf32(x[0][e], h.x, l.x);
    split_tf32(x[1][e], h.y, l.y);
    split_tf32(x[2][e], h.z, l.z);
    split_tf32(x[3][e], h.w, l.w);
    const int off = (kp / 32) * D * 128 + sw128(d, (kp % 32) / 4);
    *reinterpret_cast<uint4*>(Vt + off) = h;
    *reinterpret_cast<uint4*>(Vt_lo + off) = l;
  }
}

template <int D, int BN>
__device__ __forceinline__ void split_transpose(const uint8_t* V,
                                                uint8_t* Vt, uint8_t* Vt_lo,
                                                int t, int n) {
  for (int u = t; u < BN / 4 * (D / 4); u += n)
    split_transpose_unit<D, BN>(V, Vt, Vt_lo, u, 0, BN);
}

template <int D>
struct Tf32Tiles {
  static constexpr int BM = 64;    // query rows: one consumer warpgroup
  static constexpr int BN = 32;    // keys a step
  static constexpr int ST = 2;     // stages of each ring
  static constexpr int NCV = 96;   // converter threads (warps 5-7)
  static constexpr int Q_BYTES = BM * D * 4;
  static constexpr int KV_BYTES = BN * D * 4;
  static constexpr int N_BARS = 2 + 4 * ST;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 5 * ST * KV_BYTES + 8 * N_BARS;
};

// The block's shared memory, carved as Tf32Tiles lays it out, and the
// three roles' steps.  Step `it` uses stage it % ST of both rings, with
// parity (it / ST) & 1.
template <int D>
struct Tf32Pipe {
  using L = Tf32Tiles<D>;
  uint8_t *q, *q_lo, *k, *v, *k_lo, *vt, *vt_lo;   // k .. vt_lo: ST stages
  uint64_t *q_full, *q_ready;   // Q landed; Q split
  uint64_t *full, *empty;       // raw K, V landed; K read
  uint64_t *cv_full, *cv_empty; // K_lo, Vt, Vt_lo written; read

  __device__ explicit Tf32Pipe(uint8_t* raw) {
    q = align1024(raw);
    q_lo = q + L::Q_BYTES;
    k = q_lo + L::Q_BYTES;
    v = k + L::ST * L::KV_BYTES;
    k_lo = v + L::ST * L::KV_BYTES;
    vt = k_lo + L::ST * L::KV_BYTES;
    vt_lo = vt + L::ST * L::KV_BYTES;
    q_full = reinterpret_cast<uint64_t*>(vt_lo + L::ST * L::KV_BYTES);
    q_ready = q_full + 1;
    full = q_ready + 1;
    empty = full + L::ST;
    cv_full = empty + L::ST;
    cv_empty = cv_full + L::ST;
  }

  // by thread 0, before a __syncthreads
  __device__ void init() const {
    mbar_init(q_full, 1);
    mbar_init(q_ready, L::NCV);
    for (int i = 0; i < L::ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);           // one arrival a consumer warp
      mbar_init(&cv_full[i], L::NCV);    // every converter thread
      mbar_init(&cv_empty[i], 4);
    }
    mbar_init_fence();
  }

  __device__ uint8_t* stage(uint8_t* ring, int it) const {
    return ring + (it % L::ST) * L::KV_BYTES;
  }

  // warp 4, lane 0: Q (when with_k) and steps' K (when with_k) and V
  __device__ void produce(const CUtensorMap* tq, const CUtensorMap* tk,
                          const CUtensorMap* tv, int q0, int h, int b,
                          int n_items, bool with_k) const {
    if (with_k) {
      mbar_arrive_tx(q_full, L::Q_BYTES);
      tma_load_tile<D, 4>(q, tq, q_full, L::BM, q0, h, b);
    }
    for (int it = 0; it < n_items; ++it) {
      const int st = it % L::ST;
      mbar_wait(&empty[st], ((it / L::ST) & 1) ^ 1);
      mbar_arrive_tx(&full[st], with_k ? 2 * L::KV_BYTES : L::KV_BYTES);
      if (with_k)
        tma_load_tile<D, 4>(stage(k, it), tk, &full[st], L::BN, it * L::BN,
                            h, b);
      tma_load_tile<D, 4>(stage(v, it), tv, &full[st], L::BN, it * L::BN, h,
                          b);
    }
  }

  // warps 5-7 (t = 0 .. NCV-1): Q's lo once (when with_k), then each
  // landed stage's K_lo (when with_k) and its V split and transposed into
  // Vt and Vt_lo; each made visible to wgmma before it is announced
  __device__ void convert(int n_items, bool with_k, int t) const {
    if (with_k) {
      mbar_wait(q_full, 0);
      split_tile(q, q_lo, L::Q_BYTES, t, L::NCV);
      fence_async_smem();
      mbar_arrive(q_ready);
    }
    for (int it = 0; it < n_items; ++it) {
      const int st = it % L::ST, ph = (it / L::ST) & 1;
      mbar_wait(&full[st], ph);
      mbar_wait(&cv_empty[st], ph ^ 1);
      if (with_k)
        split_tile(stage(k, it), stage(k_lo, it), L::KV_BYTES, t, L::NCV);
      split_transpose<D, L::BN>(stage(v, it), stage(vt, it),
                                stage(vt_lo, it), t, L::NCV);
      fence_async_smem();
      mbar_arrive(&cv_full[st]);
    }
  }
};

// The S accumulator d[BN/2] (element 4j + 2i + c: row r + 8i, key 8j +
// 2(l%4) + c) as the A fragments of the TF32 P V product, split into hi
// and lo.  Step kk takes keys 8kk .. 8kk+7; its fragment's column l%4 is
// key 2(l%4) and column l%4 + 4 key 2(l%4) + 1 (Vt's order), so a[] =
// d[4kk], d[4kk+2], d[4kk+1], d[4kk+3].
template <int BN>
__device__ __forceinline__ void split_frags(uint32_t (&hi)[BN / 8][4],
                                            uint32_t (&lo)[BN / 8][4],
                                            const float (&d)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    split_tf32(d[4 * kk], hi[kk][0], lo[kk][0]);
    split_tf32(d[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split_tf32(d[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split_tf32(d[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// Q's hi (the tile as it landed) as the A fragments of the consumer
// warpgroup's 64 rows, read once: step kk, a[] = (r, c), (r+8, c), (r,
// c+4), (r+8, c+4) with r = 16 w + l/4, c = 8 kk + l%4.  Held in
// registers, Q's hi costs the S products no shared-memory reads.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&a)[D / 8][4],
                                             const uint8_t* Q, int rows) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int r = 16 * w + lane / 4, c0 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int rr = r + 8 * (x & 1), c = 8 * kk + c0 + 4 * (x >> 1);
      a[kk][x] = *reinterpret_cast<const uint32_t*>(
          Q + (c / 32) * rows * 128 + sw128(rr, (c % 32) / 4) + (c % 4) * 4);
    }
}

// S = Q K^T in three TF32 products over D for the consumer warpgroup's 64
// rows: Q's hi from registers (load_q_frags), its lo from a tile of
// `qrows` rows, K a tile of BN keys.  The small products (hi lo, lo hi)
// go first, so the tensor cores' f32 accumulation rounds them against
// their own small sum and not against the large one (hi hi).
template <int D, int BN>
__device__ __forceinline__ void qk_tf32x3(float (&s)[BN / 2],
                                          const uint32_t (&qa)[D / 8][4],
                                          const uint8_t* Q_lo, int qrows,
                                          const uint8_t* K,
                                          const uint8_t* K_lo) {
  zero_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_rs<BN>(s, qa[kk], smem_desc_k(K_lo, BN, 0, kk));
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss<BN>(s, smem_desc_k(Q_lo, qrows, 0, kk),
                      smem_desc_k(K, BN, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_rs<BN>(s, qa[kk], smem_desc_k(K, BN, 0, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// O += P V in three TF32 products over BN keys, P from registers
// (split_frags), V from Vt and Vt_lo, whose depth steps kk0 .. kk0 +
// BN/8 - 1 hold the keys.  Each W columns of O are formed in a fresh
// accumulator, small products first, and added to O in f32, so the
// tensor cores' accumulation never sees O's running sum.
template <int D, int BN, int W = 64>
__device__ __forceinline__ void pv_tf32x3(float (&o)[D / 2],
                                          uint32_t (&hi)[BN / 8][4],
                                          uint32_t (&lo)[BN / 8][4],
                                          const uint8_t* Vt,
                                          const uint8_t* Vt_lo,
                                          int kk0 = 0) {
  float t[W / 2];
#pragma unroll
  for (int part = 0; part < D / W; ++part) {
    zero_regs(t);
    fence_frags(hi);
    fence_frags(lo);
    fence_regs(t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk)
      wgmma_tf32_rs<W>(t, hi[kk], smem_desc_k(Vt_lo, D, W * part, kk0 + kk));
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk)
      wgmma_tf32_rs<W>(t, lo[kk], smem_desc_k(Vt, D, W * part, kk0 + kk));
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk)
      wgmma_tf32_rs<W>(t, hi[kk], smem_desc_k(Vt, D, W * part, kk0 + kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(t);
#pragma unroll
    for (int x = 0; x < W / 2; ++x) o[W / 2 * part + x] += t[x];
  }
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
// covers every SM once; else one (64-row tiles, twice the blocks).  The
// bf16 flash backward (bwd_tc_kernel) takes the rule at D = 128 only: its
// two warpgroups split dQ's columns, half a swizzled box at D = 64, so at
// D = 64 it always takes one.
inline bool two_warpgroups(int B, int H, int n) {
  return int64_t((n + 127) / 128) * B * H >= sm_count();
}

}  // namespace hopper
