// The WAN codec's 2-bit quantize and dequantize, and the DGC momentum
// update, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of geomx_tpu/ops/quantize.py:
// _quant_kernel (:39, launched by the pallas_call at :67 and reached
// through quantize_2bit_tpu at :87), _dequant_kernel (:105, the
// pallas_call at :125, dequantize_2bit_tpu at :138) and _dgc_kernel
// (:147, the pallas_call at :161, dgc_update_tpu at :174).  The plain
// PyTorch versions are quantize_2bit_ref, dequantize_2bit_ref and
// dgc_update_ref in geomx_tpu_torch/ops/quantize.py; the ctypes binding
// and the build are in geomx_tpu_torch/ops/kernels/quantize_cuda.py.
//
// Contract, bit for bit the plain versions'.  Quantize: r = r_in + g;
// code 1 where r > t, 2 where r < -t, else 0; four codes a byte, low
// bits first; the emitted +-t leaves the residual.  Two layouts:
//  - consecutive (the wire "2bit" frame): byte b holds elements 4b..4b+3,
//    ceil(n/4) bytes; residual where(pos, r-t, where(neg, r+t, r)), which
//    keeps every untouched element's bits, -0.0 included;
//  - strided (the Pallas kernel's "2bit-tpu" layout): byte p of
//    131,072-element block k holds elements k*131072 + l*32768 +
//    (p mod 32768) for lanes l = 0..3, ceil(n/131072)*32768 bytes;
//    residual (r - where(pos,t,0)) + where(neg,t,0), which turns -0.0
//    into +0.0.
// Elements past n read as 0 and code 0; the padding bytes of the strided
// layout are written, residual elements past n are not.  Dequantize:
// code 1 gives +t, 2 gives -t, 0 and 3 give +0.0; n elements written.
// DGC update: v' = m*v + g, then u' = u + v', each product and sum
// rounded on its own.  Quantize and dequantize do not multiply.  The DGC
// update does, and the build leaves nvcc's --fmad on, which would
// contract m*v + g into one FFMA that rounds once and differs from the
// plain version in the last bit; so it is written with __fmul_rn and
// __fadd_rn, which nvcc never contracts.  The build must not use
// -use_fast_math (it flushes denormals).
//
// What bounds them on an H100: bytes.  Quantize moves 12.25 bytes an
// element (g and r read, r written, a quarter byte of codes) for about 6
// f32 operations; dequantize 4.25 bytes for about 4; the DGC update 20
// bytes (v, u, g read, v and u written) for 3.  At the codec stage's key
// sizes (384 to 3,145,728 elements) the bound is 0.1 to 11 us, under the
// host's cost of a launch, so the design keeps the launch short: a plain
// C entry point per function (ctypes, no PyTorch headers), a grid sized
// to the work (one block of 256 threads for 384 elements; see
// BLOCKS_PER_SM below), no device query after the first call.  The body
// moves each byte once, 16 bytes a thread where the pointers allow:
//  - quantize, consecutive: a thread reads one float4 of g and of r and
//    writes one float4 of residual and one packed byte; neighbouring
//    threads on neighbouring addresses;
//  - quantize, strided: a thread takes four neighbouring packed bytes,
//    which read one float4 from each of the four lane rows, and writes
//    one 32-bit word of codes;
//  - dequantize, consecutive: a warp reads 32 words of codes, one a
//    thread, and hands the bytes round by shuffles so that each of its
//    four float4 stores is 512 contiguous bytes a warp;
//  - dequantize, strided: a thread reads one word and writes one float4
//    into each lane row;
//  - DGC update: a thread reads one float4 each of v, u and g and writes
//    one float4 each of v' and u'; the first block takes the n mod 4
//    tail.  The outputs may be the inputs themselves (the codec stage
//    updates its velocity and accumulator in place): a thread reads its
//    elements before it writes them, and no other thread touches them.
// A pointer off a 16-byte boundary (a view at a 4-byte offset, a code
// buffer at any byte) takes the scalar form of the same kernel: one
// element, or one byte, at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// The grid is one thread an item (a byte of codes, or a word of them),
// capped at BLOCKS_PER_SM blocks an SM (2048 threads, the grid-stride
// loop takes the rest) while the call's bytes fit in L2, and past L2
// only if CAP_PAST_L2.  Timed on the card (examples/time_codec_grid.py):
// from L2 fewer, longer-lived blocks are faster; streaming from HBM more
// blocks in flight are.
constexpr int BLOCKS_PER_SM = 8;
constexpr bool CAP_PAST_L2 = false;
constexpr long long STRIDE_BLOCK = 131072;  // elements of a strided block
constexpr long long QUARTER = 32768;       // its bytes: one lane row

__device__ __forceinline__ uint32_t code_of(float r, float t) {
  return r > t ? 1u : (r < -t ? 2u : 0u);
}

// the wire codec's residual: untouched elements keep their bits
__device__ __forceinline__ float resid_consecutive(float r, float t) {
  return r > t ? r - t : (r < -t ? r + t : r);
}

// the Pallas kernel's residual: an untouched -0.0 comes out +0.0
__device__ __forceinline__ float resid_strided(float r, float t) {
  return (r - (r > t ? t : 0.0f)) + (r < -t ? t : 0.0f);
}

__device__ __forceinline__ float value_of(uint32_t q, float t) {
  return q == 1u ? t : (q == 2u ? -t : 0.0f);
}

__device__ __forceinline__ long long first_thread() {
  return static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
}

__device__ __forceinline__ long long all_threads() {
  return static_cast<long long>(gridDim.x) * THREADS;
}

// ---- quantize ------------------------------------------------------------

// Packed byte b of the consecutive layout from r + g over elements
// 4b..4b+3 (all below n): its code byte and four residuals.
__device__ __forceinline__ uint8_t quant_byte(float4 gg, float4 rr, float t,
                                              float4* out) {
  const float v[4] = {rr.x + gg.x, rr.y + gg.y, rr.z + gg.z, rr.w + gg.w};
  uint32_t byte = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) byte |= code_of(v[k], t) << (2 * k);
  *out = make_float4(resid_consecutive(v[0], t), resid_consecutive(v[1], t),
                     resid_consecutive(v[2], t), resid_consecutive(v[3], t));
  return static_cast<uint8_t>(byte);
}

// One thread a packed byte.  VEC: g, r and r_out 16-byte aligned; else
// each element is read and written alone.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_consecutive(const float* __restrict__ g, const float* __restrict__ r,
                  uint8_t* __restrict__ packed, float* __restrict__ r_out,
                  long long n, float t) {
  const long long full = n >> 2;  // bytes whose four elements are all < n
  for (long long b = first_thread(); b < full; b += all_threads()) {
    const long long e = 4 * b;
    float4 o;
    if (VEC) {
      packed[b] = quant_byte(*reinterpret_cast<const float4*>(g + e),
                             *reinterpret_cast<const float4*>(r + e), t, &o);
      *reinterpret_cast<float4*>(r_out + e) = o;
    } else {
      packed[b] = quant_byte(make_float4(g[e], g[e + 1], g[e + 2], g[e + 3]),
                             make_float4(r[e], r[e + 1], r[e + 2], r[e + 3]),
                             t, &o);
      r_out[e] = o.x;
      r_out[e + 1] = o.y;
      r_out[e + 2] = o.z;
      r_out[e + 3] = o.w;
    }
  }
  // the last byte, when n is not a multiple of 4: its elements past n
  // code 0
  if (first_thread() == 0 && (n & 3)) {
    uint32_t byte = 0;
    for (long long e = 4 * full; e < n; ++e) {
      const float v = r[e] + g[e];
      byte |= code_of(v, t) << (2 * (e - 4 * full));
      r_out[e] = resid_consecutive(v, t);
    }
    packed[full] = static_cast<uint8_t>(byte);
  }
}

// One thread four packed bytes p..p+3 of one strided block: elements
// base + l*QUARTER + k for lane row l and byte k.  VEC: g, r and r_out
// 16-byte aligned, packed 4-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_strided(const float* __restrict__ g, const float* __restrict__ r,
              uint8_t* __restrict__ packed, float* __restrict__ r_out,
              long long n, float t) {
  const long long words = (n + STRIDE_BLOCK - 1) / STRIDE_BLOCK * (QUARTER / 4);
  for (long long w = first_thread(); w < words; w += all_threads()) {
    const long long p = 4 * w;
    const long long base = p / QUARTER * STRIDE_BLOCK + p % QUARTER;
    uint32_t word = 0;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const long long e = base + l * QUARTER;
      if (VEC && e + 4 <= n) {
        const float4 gg = *reinterpret_cast<const float4*>(g + e);
        const float4 rr = *reinterpret_cast<const float4*>(r + e);
        const float v[4] = {rr.x + gg.x, rr.y + gg.y, rr.z + gg.z,
                            rr.w + gg.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          word |= code_of(v[k], t) << (8 * k + 2 * l);
        *reinterpret_cast<float4*>(r_out + e) = make_float4(
            resid_strided(v[0], t), resid_strided(v[1], t),
            resid_strided(v[2], t), resid_strided(v[3], t));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (e + k < n) {
            const float v = r[e + k] + g[e + k];
            word |= code_of(v, t) << (8 * k + 2 * l);
            r_out[e + k] = resid_strided(v, t);
          }
        }
      }
    }
    if (VEC) {
      reinterpret_cast<uint32_t*>(packed)[w] = word;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        packed[p + k] = static_cast<uint8_t>(word >> (8 * k));
    }
  }
}

// ---- dequantize ----------------------------------------------------------

// The 32 words of codes from word w0 on, one a lane of a warp (zero
// past nw), to elements 16*w0 on: for store j, lane i needs byte 32j + i
// of the warp's 128, which lies in word 8j + i/4, so a shuffle brings it
// and each of the warp's four float4 stores is 512 contiguous bytes.
__device__ __forceinline__ void dequant_tile(uint32_t word, long long w0,
                                             long long nw, int lane,
                                             float4* __restrict__ o4,
                                             float t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int src = 8 * j + (lane >> 2);
    const uint32_t byte =
        __shfl_sync(0xffffffffu, word, src) >> (8 * (lane & 3));
    if (w0 + src < nw)
      o4[4 * w0 + 32 * j + lane] = make_float4(
          value_of(byte & 3u, t), value_of((byte >> 2) & 3u, t),
          value_of((byte >> 4) & 3u, t), value_of((byte >> 6) & 3u, t));
  }
}

// Packed 4-byte and out 16-byte aligned.  Word w holds elements
// 16w..16w+15; a warp takes 32 words a trip of its grid-stride loop.
// The last n mod 16 elements are read byte by byte.
__global__ void __launch_bounds__(THREADS)
dequant_consecutive_vec(const uint8_t* __restrict__ packed,
                        float* __restrict__ out, long long n, float t) {
  const long long nw = n >> 4;
  const int lane = threadIdx.x & 31;
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(packed);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long w0 = first_thread() - lane; w0 < nw; w0 += all_threads())
    dequant_tile(w0 + lane < nw ? pw[w0 + lane] : 0u, w0, nw, lane, o4, t);
  const long long e = 16 * nw + first_thread();
  if (e < n) out[e] = value_of((packed[e >> 2] >> (2 * (e & 3))) & 3u, t);
}

// Any alignment: one thread a byte, its four elements stored one by one.
__global__ void __launch_bounds__(THREADS)
dequant_consecutive_scalar(const uint8_t* __restrict__ packed,
                           float* __restrict__ out, long long n, float t) {
  const long long need = (n + 3) >> 2;
  for (long long b = first_thread(); b < need; b += all_threads()) {
    const uint32_t byte = packed[b];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * b + k < n) out[4 * b + k] = value_of((byte >> (2 * k)) & 3u, t);
  }
}

// One thread a word of codes: one float4 into each of the four lane
// rows.  VEC: packed 4-byte and out 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dequant_strided(const uint8_t* __restrict__ packed, float* __restrict__ out,
                long long n, float t) {
  const long long words = (n + STRIDE_BLOCK - 1) / STRIDE_BLOCK * (QUARTER / 4);
  for (long long w = first_thread(); w < words; w += all_threads()) {
    const long long p = 4 * w;
    const long long base = p / QUARTER * STRIDE_BLOCK + p % QUARTER;
    if (base >= n) continue;  // padding bytes only
    uint32_t word;
    if (VEC) {
      word = reinterpret_cast<const uint32_t*>(packed)[w];
    } else {
      word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        word |= static_cast<uint32_t>(packed[p + k]) << (8 * k);
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const long long e = base + l * QUARTER;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = value_of((word >> (8 * k + 2 * l)) & 3u, t);
      if (VEC && e + 4 <= n) {
        *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (e + k < n) out[e + k] = v[k];
      }
    }
  }
}

// ---- DGC momentum update -------------------------------------------------

// m*v + g and u + v', each rounded on its own (never one FFMA)
__device__ __forceinline__ float dgc_v(float v, float g, float m) {
  return __fadd_rn(__fmul_rn(m, v), g);
}

// VEC: all five pointers 16-byte aligned, one float4 of each operand a
// thread, the first block's first n mod 4 threads also take the tail;
// else one element a thread.  v_out may be v and u_out may be u, so
// those four are not __restrict__.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dgc_update(const float* v, const float* u, const float* __restrict__ g,
           float* v_out, float* u_out, long long n, float m) {
  long long e = first_thread();
  if (VEC) {
    const long long n4 = n >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long i = e; i < n4; i += all_threads()) {
      const float4 vv = v4[i], uu = u4[i], gg = g4[i];
      const float4 vn = make_float4(dgc_v(vv.x, gg.x, m), dgc_v(vv.y, gg.y, m),
                                    dgc_v(vv.z, gg.z, m), dgc_v(vv.w, gg.w, m));
      reinterpret_cast<float4*>(v_out)[i] = vn;
      reinterpret_cast<float4*>(u_out)[i] =
          make_float4(__fadd_rn(uu.x, vn.x), __fadd_rn(uu.y, vn.y),
                      __fadd_rn(uu.z, vn.z), __fadd_rn(uu.w, vn.w));
    }
    e += 4 * n4;  // the tail: elements 4*n4 .. n-1
    if (e < n) {
      const float vn = dgc_v(v[e], g[e], m);
      const float ue = u[e];
      v_out[e] = vn;
      u_out[e] = __fadd_rn(ue, vn);
    }
  } else {
    for (; e < n; e += all_threads()) {
      const float vn = dgc_v(v[e], g[e], m);
      const float ue = u[e];
      v_out[e] = vn;
      u_out[e] = __fadd_rn(ue, vn);
    }
  }
}

// ---- launch --------------------------------------------------------------

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// SMs and L2 bytes of each device, read once (a race writes the same
// values)
struct DeviceInfo {
  int sms = 0;
  long long l2_bytes = 0;
};

const DeviceInfo& device_info(int device) {
  static DeviceInfo cached[64];
  static const DeviceInfo h100{132, 50LL << 20};
  if (device < 0 || device >= 64) return h100;
  DeviceInfo& d = cached[device];
  if (d.sms == 0) {
    int sms = 0, l2 = 0;
    if (cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        sms <= 0)
      return h100;
    d.l2_bytes = l2;
    d.sms = sms;
  }
  return d;
}

// one thread an item, at least one block; while the call's `bytes` fit
// in L2 (or always, with CAP_PAST_L2) at most BLOCKS_PER_SM blocks an SM
unsigned grid_for(long long items, long long bytes, int device) {
  const DeviceInfo& d = device_info(device);
  long long grid = (items + THREADS - 1) / THREADS;
  if (CAP_PAST_L2 || bytes <= d.l2_bytes) {
    const long long cap = static_cast<long long>(d.sms) * BLOCKS_PER_SM;
    grid = grid < cap ? grid : cap;
  }
  return static_cast<unsigned>(grid < 1 ? 1 : grid);
}

// the kernels launch on `device`, the stream's; the caller's current
// device is put back afterwards
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != device)
      cudaSetDevice(device);
    else
      prev = -1;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// r_out f32 [n] and packed uint8 [ceil(n/4)] (consecutive) or
// [ceil(n/131072)*32768] (strided) are the caller's; returns the launch's
// cudaError_t.
extern "C" int geo_quantize_2bit(const float* g, const float* r,
                                 uint8_t* packed, float* r_out, long long n,
                                 float t, int strided, int device,
                                 void* stream) {
  if (n <= 0) return 0;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(g, 16) && aligned(r, 16) && aligned(r_out, 16);
  const long long bytes = 12 * n + n / 4;
  if (strided) {
    const long long words = (n + STRIDE_BLOCK - 1) / STRIDE_BLOCK * (QUARTER / 4);
    const unsigned grid = grid_for(words, bytes, device);
    if (vec && aligned(packed, 4))
      quant_strided<true><<<grid, THREADS, 0, s>>>(g, r, packed, r_out, n, t);
    else
      quant_strided<false><<<grid, THREADS, 0, s>>>(g, r, packed, r_out, n,
                                                    t);
  } else {
    const unsigned grid = grid_for(n >> 2, bytes, device);
    if (vec)
      quant_consecutive<true><<<grid, THREADS, 0, s>>>(g, r, packed, r_out, n,
                                                       t);
    else
      quant_consecutive<false><<<grid, THREADS, 0, s>>>(g, r, packed, r_out,
                                                        n, t);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed holds at least the layout's bytes for n elements; out f32 [n]
// is the caller's; returns the launch's cudaError_t.
extern "C" int geo_dequantize_2bit(const uint8_t* packed, float* out,
                                   long long n, float t, int strided,
                                   int device, void* stream) {
  if (n <= 0) return 0;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(packed, 4) && aligned(out, 16);
  const long long bytes = 4 * n + n / 4;
  if (strided) {
    const long long words = (n + STRIDE_BLOCK - 1) / STRIDE_BLOCK * (QUARTER / 4);
    const unsigned grid = grid_for(words, bytes, device);
    if (vec)
      dequant_strided<true><<<grid, THREADS, 0, s>>>(packed, out, n, t);
    else
      dequant_strided<false><<<grid, THREADS, 0, s>>>(packed, out, n, t);
  } else if (vec) {
    // one thread a word; the first block's first n mod 16 threads also
    // take the tail
    dequant_consecutive_vec<<<grid_for(n >> 4, bytes, device), THREADS, 0,
                              s>>>(packed, out, n, t);
  } else {
    dequant_consecutive_scalar<<<grid_for((n + 3) >> 2, bytes, device),
                                 THREADS, 0, s>>>(packed, out, n, t);
  }
  return static_cast<int>(cudaGetLastError());
}

// v_out and u_out f32 [n] are the caller's and may be v and u
// themselves (no other overlap); returns the launch's cudaError_t.
extern "C" int geo_dgc_update(const float* v, const float* u, const float* g,
                              float* v_out, float* u_out, long long n,
                              float m, int device, void* stream) {
  if (n <= 0) return 0;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = 20 * n;
  if (aligned(v, 16) && aligned(u, 16) && aligned(g, 16) &&
      aligned(v_out, 16) && aligned(u_out, 16))
    dgc_update<true><<<grid_for((n + 3) >> 2, bytes, device), THREADS, 0,
                       s>>>(v, u, g, v_out, u_out, n, m);
  else
    dgc_update<false><<<grid_for(n, bytes, device), THREADS, 0, s>>>(
        v, u, g, v_out, u_out, n, m);
  return static_cast<int>(cudaGetLastError());
}
