// Hopper (sm_90a) building blocks for the port's kernels: shared memory
// barriers (mbarrier), TMA tensor loads and their tensor maps, wgmma
// descriptors and products, and register reallocation between warpgroups.
// Each device wrapper is one PTX instruction or a few; the layouts they
// assume are written beside them. The attention forward
// (flash_fwd_sm90.cu) and backward (flash_bwd_sm90.cu) use them for bf16
// or fp16 inputs (`In`: __nv_bfloat16 or __half) and for fp32 ones (tf32
// products, In = float); the BatchNorm statistics (bn_stats.cu) use the
// mbarriers and 2-d TMA loads.
//
// Shared-memory tiles are what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B:
// a tile of R rows and 128 bytes a row (64 16-bit columns, 32 fp32 ones)
// is a "slab" of R/8 atoms of 8 rows x 128 bytes = 1024 bytes, the 16-byte
// chunks of row r permuted by XOR with r % 8. A wider tile is several slabs
// one after the other. Every slab starts on a 1024-byte boundary, so the
// permutation, which the hardware takes from address bits 4-6 and 7-9, is
// the same for TMA's writes, wgmma's reads and the kernels' own.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier: a 64-bit barrier in shared memory that completes a phase when
// its arrival count is met and the bytes it was told to expect have landed.
// A wait names the parity of the phase it waits for: waiting on parity 1 of
// a fresh barrier passes at once (that phase counts as done), on parity 0
// it blocks until the first phase completes.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); then a
// __syncthreads() publishes them to the block.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count of the current phase:
// the phase completes once TMA has written that many bytes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// No wait of a kernel built from these pieces lasts a second; one that
// lasts ten has lost a phase (a parity or byte-count error), and the trap
// turns the hang into a launch failure the caller sees.
constexpr uint64_t kWatchdogNs = 10000000000ull;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer_ns() - t0 > kWatchdogNs) __trap();
  }
}

// mbar_wait with every branch warp-uniform (votes over the warp's lanes):
// for a wait between asynchronous products, where ptxas serializes every
// wgmma of the function (C7520) if the wait's loop may diverge.
__device__ __forceinline__ void mbar_wait_warp(uint64_t* bar,
                                               uint32_t parity) {
  if (__all_sync(0xffffffffu, mbar_try_wait(bar, parity))) return;
  const uint64_t t0 = globaltimer_ns();
  while (!__all_sync(0xffffffffu, mbar_try_wait(bar, parity))) {
    if (__any_sync(0xffffffffu, globaltimer_ns() - t0 > kWatchdogNs))
      __trap();
  }
}

// Orders this thread's writes to shared memory (the generic proxy) before
// later reads of it by wgmma or TMA (the async proxy): a thread that writes
// an operand runs it before it arrives on the barrier the products wait on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory at `dst`, completing `bytes` of `bar`'s transaction count.
// Elements outside the tensor are written as zeros and counted all the same.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-d tensor map at coordinates (c0 innermost, c1), as above.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma: a warpgroup (4 warps, 128 threads) computes a 64 x N tile, N a
// multiple of 8, over a depth of 16 bf16 or fp16 values per instruction, fp32
// accumulators in registers. Thread (warp w, lane 4g + t) holds, for each
// 8-column block j of the tile, d[4j + 0..1] = row 16w + g, columns
// 8j + 2t and 8j + 2t + 1, and d[4j + 2..3] = the same columns of row
// 16w + g + 8. An A operand in registers has the same shape for its 16
// columns: a[0] = row g columns 2t, 2t+1; a[1] = row g + 8; a[2], a[3] the
// same rows at columns 2t + 8, 2t + 9; each a pair of In, the lower column
// in the low half. So d's columns 16k .. 16k + 15 (blocks 2k and 2k + 1),
// rounded pairwise to In, are the A operand of a product over depth 16k
// (to_operand below). The products are Wgmma<N, In> (sm90_wgmma.cuh).

// The depth of one product: 16 bf16 or fp16 values, 8 tf32 ones (32 bytes
// of each row either way).
template <typename In>
constexpr int kStep = 32 / sizeof(In);

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero),
// the bits of an fp32 whose 13 low bits are 0. wgmma reads an fp32 operand
// in shared memory or registers as tf32 without rounding it to nearest,
// so the kernels round every operand with this first.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float(tf32_bits(x));
}

// Two floats rounded to a pair of In, the first in the low half.
template <typename In>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// tf32 (wgmma m64nNk8): an A operand in registers is four fp32 values a
// thread, a[0] = row g column t, a[1] = row g + 8 column t, a[2] = row g
// column t + 4, a[3] = row g + 8 column t + 4 of an 8-column step, which
// is not the accumulator's pairing (columns 2t and 2t + 1). So the tf32
// kernels feed a product its depth in a permuted order: within each group
// of 8, operand column k holds depth 2k (k < 4) or 2(k - 4) + 1, and the B
// operand's rows of that depth are written in the same order
// (transpose_tf32). An accumulator of N registers, each rounded to tf32,
// is then the A operands of N/4 products of depth 8 with no data crossing
// threads.
template <int N>
__device__ __forceinline__ void to_operand_tf32(const float (&d)[N],
                                                uint32_t (&a)[N / 4][4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    a[j][0] = tf32_bits(d[4 * j]);
    a[j][1] = tf32_bits(d[4 * j + 2]);
    a[j][2] = tf32_bits(d[4 * j + 1]);
    a[j][3] = tf32_bits(d[4 * j + 3]);
  }
}

// x's four elements rounded to tf32.
__device__ __forceinline__ float4 tf32x4(float4 x) {
  return make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
}

// The tf32 kernels' converters: the 96 threads of warps 1-3 of the
// producer warpgroup (ct = 0..95), which round and transpose operands in
// shared memory while warp 0 loads.
constexpr int kConverters = 96;

// `n` floats of shared memory rounded to tf32 in place, float4 by float4,
// four loads in flight before their stores.
__device__ __forceinline__ void round_tf32(float* x, int n, int ct) {
  float4* v = reinterpret_cast<float4*>(x);
  constexpr int kStep = 4 * kConverters;
  int i = ct;
  for (; i + 3 * kConverters < n / 4; i += kStep) {
    float4 a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = v[i + u * kConverters];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[i + u * kConverters] = tf32x4(a[u]);
  }
  for (; i < n / 4; i += kConverters) v[i] = tf32x4(v[i]);
}

// A slab of 64 rows x 32 fp32 columns in TMA's swizzled layout (row r's
// 16-byte chunk c at chunk c ^ (r % 8)) transposed, rounded to tf32, into
// rows row0 .. row0 + 31 of a K-major operand of kRows rows by 64 depth
// values: two slabs of 32, the slab's row r becoming depth r in
// to_operand_tf32's order within each group of 8. With kInPlace the
// rounded values also go back to the slab. A work item is 4 rows of 4
// columns (4 float4 loads, 4 float4 stores); each 8 consecutive items
// touch 8 distinct 16-byte bank groups on both sides: no bank conflicts.
template <int kRows, bool kInPlace>
__device__ __forceinline__ void transpose_tf32(float* slab, float* dst,
                                               int row0, int ct) {
  for (int w = ct; w < 128; w += kConverters) {
    const int half = w >> 6, u = w & 7, v = (w >> 3) & 7;
    const int q = u ^ ((v >> 2) << 2);              // the column quad
    const int odd = ((u >> 1) & 1) ^ (v & 1);       // odd depths or even
    const int grp = (u >> 2) + ((v >> 1) & 1) * 2;  // group of 8 in the half
    const int r0 = 32 * half + 8 * grp + odd;       // rows r0 + 2m
    float4 x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = r0 + 2 * m;
      float4* src =
          reinterpret_cast<float4*>(slab + r * 32 + ((q ^ (r & 7)) << 2));
      x[m] = tf32x4(*src);
      if (kInPlace) *src = x[m];
    }
    // depths r0 + 2m are operand columns 8 grp + 4 odd + m: one chunk
    const int chunk = 2 * grp + odd;
    float* out = dst + half * kRows * 32 + (row0 + 4 * q) * 32;
    const int sw = (4 * q) & 7;   // the swizzle of rows row0 + 4q + i, - i
    *reinterpret_cast<float4*>(out + ((chunk ^ sw) << 2)) =
        make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
    *reinterpret_cast<float4*>(out + 32 + ((chunk ^ (sw + 1)) << 2)) =
        make_float4(x[0].y, x[1].y, x[2].y, x[3].y);
    *reinterpret_cast<float4*>(out + 64 + ((chunk ^ (sw + 2)) << 2)) =
        make_float4(x[0].z, x[1].z, x[2].z, x[3].z);
    *reinterpret_cast<float4*>(out + 96 + ((chunk ^ (sw + 3)) << 2)) =
        make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
  }
}

// An accumulator of N registers (2N columns), rounded pairwise to In, as
// the register A operands of N/8 products over depth 16: registers
// 8kk .. 8kk + 7 of d are the kk-th (row g: 8kk + 0, 1, 4, 5; row g + 8:
// + 2, 3, 6, 7).
template <typename In, int N>
__device__ __forceinline__ void to_operand(const float (&d)[N],
                                           uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<In>(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// A shared-memory operand: its start address, LBO and SBO (bytes) and the
// 128-byte swizzle (layout type 1 in bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (the depth contiguous: rows of Q or K, each of 64 depth
// values in a slab): 8-row atoms 1024 bytes apart (SBO); LBO is unused.
// One instruction reads 16 depth values, 32 bytes of each row, so the k-th
// step of a slab starts 32k bytes in; the next 64 values are the next slab.
__device__ __forceinline__ uint64_t desc_k_major(const void* smem) {
  return desc_sw128(smem, 16, 1024);
}

// MN-major operand (the N columns contiguous: V as the B of P V, a row of
// the slab is one depth index with 64 columns): the 8 depth rows of an
// instruction's 16 lie in atoms 1024 bytes apart (SBO), and column blocks of
// 64 lie `slab_bytes` apart (LBO). The k-th step starts 16 rows, 2048
// bytes, in. Used with the transpose flag set.
__device__ __forceinline__ uint64_t desc_mn_major(const void* smem,
                                                  uint32_t slab_bytes) {
  return desc_sw128(smem, slab_bytes, 1024);
}

// Orders this thread's register writes before the products that read them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A compiler fence on registers that an asynchronous product reads or
// writes: placed after wgmma_wait, it keeps every use of them after the
// wait, and keeps them live (not reused) until it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) fence_regs(r[k]);
}

// ---------------------------------------------------------------------------
// Register reallocation between warpgroups. A warpgroup that only issues
// copies gives registers back; the ones that hold accumulators take them.
// Both must run in every thread of the warpgroup, at the top of branches
// that never rejoin.

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// Host: tensor maps. cuTensorMapEncodeTiled is a driver function; it is
// taken from the driver through the runtime, so the library links without
// -lcuda.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The CUtensorMap element type of In.
template <typename In>
constexpr CUtensorMapDataType tma_type();
template <>
constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// The tensor map of a [B, H, T, D] view of In (D contiguous, element strides
// sb, sh, st) as a 4-d tensor (D, T, H, B), read in boxes of 128 bytes of
// columns (64 of 16 bits, 32 of fp32) by `rows` rows of one (b, h),
// 128-byte swizzled. D is the view's own head dim: a kernel built for a
// larger one reads its columns past D, as its rows past T, as zeros
// (counted in the transaction bytes all the same). TMA needs a 16-byte
// aligned base and strides that are multiples of 16 bytes (8 elements of
// 16 bits, 4 of fp32); a view without them is refused here
// (cudaErrorInvalidValue).
template <typename In>
cudaError_t bhtd_map(CUtensorMap* map, const void* ptr, int B, int H, int T,
                     int D, long long sb, long long sh, long long st,
                     int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  constexpr cuuint64_t kSize = sizeof(In);
  const cuuint64_t strides[3] = {(cuuint64_t)st * kSize,
                                 (cuuint64_t)sh * kSize,
                                 (cuuint64_t)sb * kSize};
  const cuuint32_t box[4] = {128 / (cuuint32_t)kSize, (cuuint32_t)rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, tma_type<In>(), 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90

#include "sm90_wgmma.cuh"
