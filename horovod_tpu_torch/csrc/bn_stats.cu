// BatchNorm statistics: per-channel column reductions of an (M, C)
// activation, one launch a call, with the module's per-channel math in the
// epilogue.
//
// Replaces horovod_tpu/ops/pallas_kernels.py:bn_stats_pallas (K2,
// _bn_stats_kernel: sum(x), sum(x*x)) and bn_bwd_stats_pallas (K3,
// _bn_bwd_kernel: sum(dy), sum(dy*xhat) with xhat = (x - mean) * invstd),
// and the per-channel scalar math around them in
// horovod_tpu/ops/fused_batch_norm.py (_fwd_impl, _bn_bwd, and the
// running-statistic EMA of FusedBatchNorm).
//
// What bounds them on an H100: bytes. Each reads its input once (x, or dy
// and x) and does 2 to 4 fp32 operations an element, far below the card's
// 295 operations a byte. At ResNet-50's small layers (M = 3136) the bound
// is 1-4 us, so a launch's latency and the host's cost of issuing it are
// the floor there; the design keeps both to one launch.
//
// Design, for bf16, fp16 or fp32 inputs of any C >= 1 and M >= 1:
// - Channel tiles of 128 bytes (64 16-bit channels, 32 fp32). The grid is
//   (CTAs of a tile, tiles); each CTA owns a tile and a contiguous range of
//   rows (the wrapper's plan fills the card: bn_plan in ops/kernels.py).
// - Streaming: one producer thread (warp 8) keeps a ring of stages of kRows
//   rows x 128 bytes (x, and dy in the backward; 8 stages forward, 4
//   backward: 64 KB in flight a CTA) filled by TMA 2-d loads on full/empty
//   mbarriers; TMA zero-fills what lies past M or C.
//   The 256 consumer threads read a stage from shared memory as 16-byte
//   vectors (thread = 16-byte chunk j of row slot `slot`, 8 chunks a row,
//   32 row slots) and sum into fp32 registers. Where TMA's rules fail (the
//   row pitch C * itemsize is not a multiple of 16 bytes, or a base is not
//   16-byte aligned: fp16 C = 3, an offset view), the same kernel reads
//   the same elements with plain loads, in the same order, so both routes
//   give the same bits.
// - Combining, inside the launch: the 4 row slots of a warp by a fixed
//   shuffle butterfly, the 8 warps of a CTA in order in shared memory; then
//   the CTAs of a thread-block cluster (up to 16 neighbouring CTAs of one
//   tile) through distributed shared memory, rank 0 summing ranks 0, 1, ...
//   in order. The plan (ops/kernels.py:bn_plan) makes a tile of up to 4096
//   rows a CTA one cluster, when that gives the card enough CTAs, so that
//   no partial row or ticket is needed; larger tiles get one wave of
//   clusters of 8, from the occupancy that hvd_bn_max_clusters reports. A
//   tile with more than one cluster writes one partial row per cluster to
//   a per-device workspace and takes a ticket (an atomic counter per
//   tile); the last cluster to arrive sums the partial rows in index order
//   and resets the ticket. Every sum is in an order fixed by indices,
//   never by arrival, and there are no float atomics: results repeat
//   bitwise. The per-device attributes are set at a device's first launch.
// - The epilogue runs in that last CTA, one thread a channel: the raw sums,
//   or (forward) mean, var = max(E[x^2] - mean^2, 0), invstd, a = scale *
//   invstd, b = bias - mean * a and, when given, the running statistics'
//   EMA in place; (backward) dgamma = sum dy*xhat, dbeta = sum dy and dx's
//   coefficients a, -a * k1 and -a * invstd * k2 (k1, k2 the sums over M).
//   Each operation is rounded as the module's PyTorch ops round it (no
//   fused multiply-adds).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowBytes = 128;   // bytes of a channel tile's row
constexpr int kChunks = kRowBytes / 16;
constexpr int kConsumers = 256;
constexpr int kSlots = kConsumers / kChunks;   // row slots of a CTA
constexpr int kThreads = kConsumers + 32;      // + the producer warp
constexpr int kRows = 64;                      // rows of a stage
constexpr int kStageBytes = kRows * kRowBytes;
constexpr int kWarps = kConsumers / 32;
constexpr int kMaxCluster = 16;   // H100's non-portable cluster size

// stages of the ring: 64 KB of loads in flight a CTA in either kernel
template <bool BWD>
__host__ __device__ constexpr int stages() {
  return BWD ? 4 : 8;
}

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct BnParams {
  const void* x;
  const void* dy;
  const float* mean;     // backward: the forward's mean and invstd
  const float* invstd;
  long long M;
  int C;
  long long rows_per_cta;
  int cluster;             // CTAs of a cluster (the grid's x is a multiple)
  int clusters_per_tile;
  float* work;             // [tiles][clusters_per_tile][2][tile channels]
  int* tickets;            // [tiles], 0 between launches
  int epilogue;            // 0: the raw sums, 1: the module's math
  const float* scale;
  const float* bias;
  float eps;
  float* run_mean;         // forward, optional: the EMA in place
  float* run_var;
  float momentum;
  float one_minus_momentum;
  float* out;              // [2 or 5][C]
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// 16 bytes of In as floats.
template <typename In>
__device__ __forceinline__ void unpack(const uint4& v, float* out);

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v,
                                                     float* out) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {   // a bf16 is the upper half of an fp32
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void unpack<__half>(const uint4& v, float* out) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[k]));
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

// The VEC elements of one row from channel cb on, plain loads; 0 past C.
template <typename In, int VEC>
__device__ __forceinline__ void load_plain(const In* row, int cb, int C,
                                           float* out) {
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    out[e] = cb + e < C ? to_f(row[cb + e]) : 0.f;
}

template <bool BWD, int VEC>
__device__ __forceinline__ void accumulate(const float* xv, const float* dv,
                                           const float* mu, const float* isd,
                                           float* a, float* b) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (BWD) {
      a[e] += dv[e];
      b[e] += dv[e] * ((xv[e] - mu[e]) * isd[e]);
    } else {
      a[e] += xv[e];
      b[e] += xv[e] * xv[e];
    }
  }
}

// Channel c's results from its two sums (s, q): sum x and sum x^2, or sum
// dy and sum dy*xhat; in0..in3 its inputs (forward: scale, bias, the
// running mean and var; backward: scale, invstd).
template <bool BWD>
__device__ __forceinline__ void epilogue(const BnParams& p, int c, float s,
                                         float q, float in0, float in1,
                                         float in2, float in3) {
  const int C = p.C;
  float* out = p.out;
  if (!p.epilogue) {
    out[c] = s;
    out[C + c] = q;
    return;
  }
  const float m = (float)p.M;
  if (!BWD) {
    const float mean = __fdiv_rn(s, m);
    const float var =
        fmaxf(__fsub_rn(__fdiv_rn(q, m), __fmul_rn(mean, mean)), 0.f);
    const float invstd = rsqrtf(__fadd_rn(var, p.eps));
    const float a = __fmul_rn(in0, invstd);
    const float b = __fsub_rn(in1, __fmul_rn(mean, a));
    out[c] = mean;
    out[C + c] = var;
    out[2 * C + c] = invstd;
    out[3 * C + c] = a;
    out[4 * C + c] = b;
    if (p.run_mean != nullptr) {
      p.run_mean[c] = __fadd_rn(__fmul_rn(p.momentum, in2),
                                __fmul_rn(p.one_minus_momentum, mean));
      p.run_var[c] = __fadd_rn(__fmul_rn(p.momentum, in3),
                               __fmul_rn(p.one_minus_momentum, var));
    }
  } else {
    const float a = __fmul_rn(in0, in1);
    out[c] = q;                                        // dgamma
    out[C + c] = s;                                    // dbeta
    out[2 * C + c] = a;
    out[3 * C + c] = __fmul_rn(-a, __fdiv_rn(s, m));   // -a * k1
    out[4 * C + c] = __fmul_rn(__fmul_rn(-a, in1), __fdiv_rn(q, m));
  }
}

template <typename In>
__host__ __device__ constexpr int tile_channels() {
  return kRowBytes / (int)sizeof(In);
}

template <typename In, bool BWD>
constexpr int smem_bytes() {
  return stages<BWD>() * (BWD ? 2 : 1) * kStageBytes +
         (2 * kWarps + 2) * tile_channels<In>() * 4 + 2 * stages<BWD>() * 8 +
         16;
}

// One CTA an SM is the bound ptxas plans registers for (with no minimum
// it spilled 8 bytes of the bf16 backward at 56 registers); three fit.
template <typename In, bool BWD, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
bn_stats_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tdy, const BnParams p) {
  constexpr int VEC = 16 / (int)sizeof(In);
  constexpr int CT = tile_channels<In>();
  constexpr int kTensors = BWD ? 2 : 1;
  constexpr int kStages = stages<BWD>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;   // [kStages][kTensors][kRows][kRowBytes]
  float* red = reinterpret_cast<float*>(smem + kStages * kTensors *
                                        kStageBytes);   // [2][kWarps][CT]
  float* part = red + 2 * kWarps * CT;                   // [2][CT]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + 2 * CT);
  uint64_t* empty = full + kStages;
  int* last = reinterpret_cast<int*>(empty + kStages);

  cg::cluster_group cluster = cg::this_cluster();
  const int tile = blockIdx.y;
  const int c0 = tile * CT;
  const long long r0 = (long long)blockIdx.x * p.rows_per_cta;
  const long long r1 = min(r0 + p.rows_per_cta, p.M);
  const int n_st = r1 > r0 ? (int)((r1 - r0 + kRows - 1) / kRows) : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j = tid % kChunks, slot = tid / kChunks;

  if (TMA && tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, kWarps);
    }
    sm90::fence_mbar_init();
  }
  // the epilogue's per-channel inputs, loaded while the rows stream (only
  // the tile's last CTA uses them)
  float in0 = 0.f, in1 = 0.f, in2 = 0.f, in3 = 0.f;
  if (p.epilogue && tid < CT && c0 + tid < p.C) {
    const int c = c0 + tid;
    in0 = p.scale[c];
    if (BWD) {
      in1 = p.invstd[c];
    } else {
      in1 = p.bias[c];
      if (p.run_mean != nullptr) {
        in2 = p.run_mean[c];
        in3 = p.run_var[c];
      }
    }
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer warp
    if (TMA && tid == kConsumers) {
      sm90::prefetch_tensor_map(&tx);
      if (BWD) sm90::prefetch_tensor_map(&tdy);
      for (int i = 0; i < n_st; ++i) {
        const int s = i % kStages;
        if (i >= kStages) sm90::mbar_wait(empty + s, (i / kStages - 1) & 1);
        sm90::mbar_arrive_expect_tx(full + s, kTensors * kStageBytes);
        unsigned char* dst = ring + s * kTensors * kStageBytes;
        const int row = (int)(r0 + (long long)i * kRows);
        sm90::tma_load_2d(dst, &tx, full + s, c0, row);
        if (BWD) sm90::tma_load_2d(dst + kStageBytes, &tdy, full + s, c0, row);
      }
    }
  } else {
    float a[VEC], b[VEC], mu[VEC], isd[VEC];
    const int cb = c0 + j * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      a[e] = b[e] = 0.f;
      if (BWD) {
        mu[e] = cb + e < p.C ? p.mean[cb + e] : 0.f;
        isd[e] = cb + e < p.C ? p.invstd[cb + e] : 0.f;
      }
    }
    if (TMA) {
      for (int i = 0; i < n_st; ++i) {
        const int s = i % kStages;
        sm90::mbar_wait(full + s, (i / kStages) & 1);
        const unsigned char* st = ring + s * kTensors * kStageBytes;
#pragma unroll
        for (int rr = slot; rr < kRows; rr += kSlots) {
          if (r0 + (long long)i * kRows + rr < r1) {
            const int off = rr * kRowBytes + j * 16;
            float xv[VEC], dv[VEC];
            unpack<In>(*reinterpret_cast<const uint4*>(st + off), xv);
            if (BWD)
              unpack<In>(
                  *reinterpret_cast<const uint4*>(st + kStageBytes + off), dv);
            accumulate<BWD, VEC>(xv, dv, mu, isd, a, b);
          }
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + s);
      }
    } else {
      const In* x = reinterpret_cast<const In*>(p.x);
      const In* dy = reinterpret_cast<const In*>(p.dy);
#pragma unroll 4
      for (long long row = r0 + slot; row < r1; row += kSlots) {
        float xv[VEC], dv[VEC];
        load_plain<In, VEC>(x + row * p.C, cb, p.C, xv);
        if (BWD) load_plain<In, VEC>(dy + row * p.C, cb, p.C, dv);
        accumulate<BWD, VEC>(xv, dv, mu, isd, a, b);
      }
    }
    // the warp's row slots of each chunk (lanes j, j + kChunks, ...) by a
    // fixed butterfly, then the 8 warps in order below
#pragma unroll
    for (int off = kChunks; off < 32; off *= 2) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        a[e] += __shfl_xor_sync(0xffffffffu, a[e], off);
        b[e] += __shfl_xor_sync(0xffffffffu, b[e], off);
      }
    }
    if (lane < kChunks) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        red[warp * CT + j * VEC + e] = a[e];
        red[(kWarps + warp) * CT + j * VEC + e] = b[e];
      }
    }
  }
  __syncthreads();
  if (tid < 2 * CT) {
    const int w = tid / CT, c = tid % CT;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += red[(w * kWarps + q) * CT + c];
    part[tid] = v;
  }
  // the cluster's: rank 0 adds ranks 0, 1, ... through distributed shared
  // memory (all loads issued first; ranks past the cluster add 0); the
  // second sync keeps every rank's `part` alive until read
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  float* fin = red;   // [2][CT], rank 0's
  if (rank == 0 && tid < 2 * CT) {
    float r[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      r[q] = q < p.cluster ? cluster.map_shared_rank(part, q)[tid] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v += r[q];
    fin[tid] = v;
  }
  cluster.sync();
  if (rank != 0) return;

  if (p.clusters_per_tile > 1) {
    const long long row0 = (long long)tile * p.clusters_per_tile;
    float* mine = p.work + (row0 + blockIdx.x / p.cluster) * 2 * CT;
    if (tid < 2 * CT) mine[tid] = fin[tid];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      *last = atomicAdd(p.tickets + tile, 1) == p.clusters_per_tile - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    if (tid < 2 * CT) {
      float v = 0.f;
      for (int q0 = 0; q0 < p.clusters_per_tile; q0 += 8) {
        float r[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          r[q] = q0 + q < p.clusters_per_tile
                     ? __ldcg(p.work + (row0 + q0 + q) * 2 * CT + tid)
                     : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) v += r[q];
      }
      fin[tid] = v;
    }
    if (tid == 0) p.tickets[tile] = 0;
    __syncthreads();
  }
  if (tid < CT && c0 + tid < p.C)
    epilogue<BWD>(p, c0 + tid, fin[tid], fin[CT + tid], in0, in1, in2, in3);
}

template <typename In>
constexpr CUtensorMapDataType map_type();
template <>
constexpr CUtensorMapDataType map_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <>
constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
constexpr CUtensorMapDataType map_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// The tensor map of an (M, C) row-major array of In read in boxes of kRows
// rows by one channel tile, unswizzled; elements past M or C read as 0.
template <typename In>
cudaError_t rows_map(CUtensorMap* map, const void* ptr, long long M, int C) {
  const sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(In)};
  const cuuint32_t box[2] = {(cuuint32_t)tile_channels<In>(), kRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, map_type<In>(), 2, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel's attributes (its dynamic shared memory above 48 KB, clusters
// past the portable 8) belong to each device: set at its first launch
// there, which spares every later call two driver calls.
template <typename In, bool BWD, bool TMA>
cudaError_t configure(int device) {
  static std::atomic<uint64_t> done{0};   // a bit a device ordinal < 64
  const uint64_t bit = device < 64 ? 1ull << device : 0;
  if (bit != 0 && (done.load() & bit)) return cudaSuccess;
  auto kernel = bn_stats_kernel<In, BWD, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<In, BWD>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename In, bool BWD, bool TMA>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tdy,
                   const BnParams& p, int ctas, int device,
                   cudaStream_t stream) {
  auto kernel = bn_stats_kernel<In, BWD, TMA>;
  constexpr int smem = smem_bytes<In, BWD>();
  cudaError_t err = configure<In, BWD, TMA>(device);
  if (err != cudaSuccess) return err;
  const int tiles = (p.C + tile_channels<In>() - 1) / tile_channels<In>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, (unsigned)tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tdy, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename In, bool BWD>
cudaError_t run_in(const BnParams& p, int ctas, int device,
                   cudaStream_t stream) {
  CUtensorMap tx = {}, tdy = {};
  const bool tma = ((long long)p.C * sizeof(In)) % 16 == 0 &&
                   aligned16(p.x) && (!BWD || aligned16(p.dy));
  if (!tma) return launch<In, BWD, false>(tx, tdy, p, ctas, device, stream);
  cudaError_t err = rows_map<In>(&tx, p.x, p.M, p.C);
  if (err == cudaSuccess && BWD) err = rows_map<In>(&tdy, p.dy, p.M, p.C);
  if (err != cudaSuccess) return err;
  return launch<In, BWD, true>(tx, tdy, p, ctas, device, stream);
}

template <bool BWD>
int run(int device, int dtype, const BnParams& p, int ctas, void* stream) {
  if (p.M < 1 || p.C < 1 || ctas < 1 || p.cluster < 1 ||
      p.cluster > kMaxCluster || ctas % p.cluster ||
      p.clusters_per_tile * p.cluster != ctas)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return (int)run_in<float, BWD>(p, ctas, device, s);
    case kBF16:
      return (int)run_in<__nv_bfloat16, BWD>(p, ctas, device, s);
    case kF16:
      return (int)run_in<__half, BWD>(p, ctas, device, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename In, bool BWD>
int max_clusters(int device, int cluster) {
  auto kernel = bn_stats_kernel<In, BWD, true>;
  constexpr int smem = smem_bytes<In, BWD>();
  cudaError_t err = configure<In, BWD, true>(device);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" {

// Clusters of `cluster` CTAs (1 to 16) of K2 (bwd 0) or K3 (bwd 1) on
// dtype's inputs that the device holds at once (one wave; 0 if it cannot
// run one), or minus a CUDA error.
int hvd_bn_max_clusters(int device, int dtype, int bwd, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  switch (dtype) {
    case kF32:
      return bwd ? max_clusters<float, true>(device, cluster)
                 : max_clusters<float, false>(device, cluster);
    case kBF16:
      return bwd ? max_clusters<__nv_bfloat16, true>(device, cluster)
                 : max_clusters<__nv_bfloat16, false>(device, cluster);
    case kF16:
      return bwd ? max_clusters<__half, true>(device, cluster)
                 : max_clusters<__half, false>(device, cluster);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

// device: CUDA ordinal of the tensors and the stream. dtype: 0 fp32, 1
// bf16, 2 fp16. x (and dy): (M, C) row-major, any alignment. The plan
// (ops/kernels.py:bn_plan): `ctas` CTAs a channel tile (128 bytes of
// channels), `cluster` of them to a cluster, `rows_per_cta` rows each;
// work: fp32 [tiles][ctas / cluster][2][tile channels], tickets: int
// [tiles], zero. epilogue 0: out = [sum, sumsq] (2, C); 1: out = [mean,
// var, invstd, a, b] (5, C) from scale, bias (fp32 (C,)) and eps, and the
// EMA run = momentum * run + one_minus_momentum * batch of run_mean and
// run_var (fp32 (C,), in place) unless they are null.
int hvd_bn_stats(int device, int dtype, const void* x, long long M, int C,
                 int ctas, int cluster, long long rows_per_cta, float* work,
                 int* tickets, int epilogue, const float* scale,
                 const float* bias, float eps, float* run_mean,
                 float* run_var, float momentum, float one_minus_momentum,
                 float* out, void* stream) {
  BnParams p = {};
  p.x = x;
  p.M = M;
  p.C = C;
  p.rows_per_cta = rows_per_cta;
  p.cluster = cluster;
  p.clusters_per_tile = ctas / cluster;
  p.work = work;
  p.tickets = tickets;
  p.epilogue = epilogue;
  p.scale = scale;
  p.bias = bias;
  p.eps = eps;
  p.run_mean = run_mean;
  p.run_var = run_var;
  p.momentum = momentum;
  p.one_minus_momentum = one_minus_momentum;
  p.out = out;
  return run<false>(device, dtype, p, ctas, stream);
}

// The backward pair sum dy and sum dy * (x - mean) * invstd, mean and
// invstd fp32 (C,); dy as x. epilogue 0: out = [sum dy, sum dy*xhat]
// (2, C); 1: out = [dgamma, dbeta, a, -a * k1, -a * invstd * k2] (5, C)
// with a = scale * invstd, k1 = sum dy / M, k2 = sum dy*xhat / M.
int hvd_bn_bwd_stats(int device, int dtype, const void* dy, const void* x,
                     const float* mean, const float* invstd, long long M,
                     int C, int ctas, int cluster, long long rows_per_cta,
                     float* work, int* tickets, int epilogue,
                     const float* scale, float* out, void* stream) {
  BnParams p = {};
  p.x = x;
  p.dy = dy;
  p.mean = mean;
  p.invstd = invstd;
  p.M = M;
  p.C = C;
  p.rows_per_cta = rows_per_cta;
  p.cluster = cluster;
  p.clusters_per_tile = ctas / cluster;
  p.work = work;
  p.tickets = tickets;
  p.epilogue = epilogue;
  p.scale = scale;
  p.out = out;
  return run<true>(device, dtype, p, ctas, stream);
}

}  // extern "C"
