// Adasum's pairwise combine: K4 (the coefficient triple) and K5 (the scaled
// add).
//
// Replaces horovod_tpu/ops/pallas_kernels.py:adasum_combine_pallas, whose two
// Pallas passes are _triple_kernel ([a.b, |a|^2, |b|^2] accumulated in fp32
// over a sequential grid) and _scale_kernel (ca*a + cb*b in fp32, stored in
// the input dtype, ca and cb read from SMEM).
//
// What bounds them on an H100: bytes. K4 reads a and b once and does 6 fp32
// operations per element pair; K5 reads a, b and writes the output once with
// 3 operations per element: far below the card's 295 operations per byte.
// The flagship LM's tied embedding gradient (67,108,864 fp32) is 537 MB for
// K4 (0.160 ms at 3.35 TB/s) and 805 MB for K5 (0.240 ms).
//
// Design:
// - K4 is a two-kernel deterministic reduction (the BN statistics' pattern,
//   bn_stats.cu): each thread walks a grid-stride range of 16-byte vectors
//   of both operands, four vectors in flight, and keeps a dot, |a|^2 and
//   |b|^2 accumulator for each lane of the vector; the block sums its
//   threads' partials with warp shuffles and then its warps in order, and
//   writes [3][blocks]; a second one-block-per-quantity kernel sums the
//   partials in a fixed order. No atomics: the triple repeats run to run.
// - Swap symmetry, bit for bit: triple(b, a) is (dot, |b|^2, |a|^2) of
//   triple(a, b). |a|^2 and |b|^2 go through the same code in the same order
//   (fma(x, x, acc)), and the dot's products are fma(x, y, acc), whose exact
//   product commutes. So VHDD partners, each combining (mine, theirs),
//   compute the same bits, and every rank stays identical.
// - Which thread sums which element, and in what order, depends only on the
//   length and the grid, never on alignment: an operand that is not 16-byte
//   aligned is read element by element into the same lanes. Partners whose
//   buffers differ in alignment still agree bitwise.
// - K5 reads the triple from device memory, so the coefficient costs no
//   launch and no host round trip (the TPU kernel's SMEM scalars), and the
//   same K5 serves the flat combine (triple straight from K4) and the
//   sharded one (triple summed over the local group by a collective).
//   ca = 1 - dot / (2 |a|^2), 0 when |a|^2 = 0, with IEEE division; the
//   output is fadd(fmul(ca, a), fmul(cb, b)) with no contraction, so the
//   swapped call (fadd commutes) gives the same bits, and the rounding is
//   the plain version's.
// The TPU kernel's 512x128 blocks and the padding they force have no
// counterpart: the tail is masked.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // vectors of each operand in flight per thread

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int DT>
struct Traits {
  static constexpr int kVec = DT == kF32 ? 4 : 8;   // elements per 16 bytes
};

template <int DT>
__device__ __forceinline__ float load_one(const void* base, long long i) {
  if constexpr (DT == kF32) {
    return reinterpret_cast<const float*>(base)[i];
  } else if constexpr (DT == kBF16) {
    // a bf16 is the upper half of an fp32
    const unsigned short h = reinterpret_cast<const unsigned short*>(base)[i];
    return __uint_as_float(static_cast<unsigned>(h) << 16);
  } else {
    const unsigned short h = reinterpret_cast<const unsigned short*>(base)[i];
    return __half2float(__ushort_as_half(h));
  }
}

template <int DT>
__device__ __forceinline__ unsigned short to_bits(float v) {
  if constexpr (DT == kBF16) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  } else {
    return __half_as_ushort(__float2half_rn(v));
  }
}

template <int DT>
__device__ __forceinline__ void store_one(void* base, long long i, float v) {
  if constexpr (DT == kF32) {
    reinterpret_cast<float*>(base)[i] = v;
  } else {
    reinterpret_cast<unsigned short*>(base)[i] = to_bits<DT>(v);
  }
}

// Elements [vi*V, vi*V + V) as floats: one 16-byte load when ALIGNED, else
// V element loads into the same lanes.
template <int DT, bool ALIGNED>
__device__ __forceinline__ void load_vec(const void* base, long long vi,
                                         float* out) {
  constexpr int V = Traits<DT>::kVec;
  if constexpr (!ALIGNED) {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = load_one<DT>(base, vi * V + k);
  } else if constexpr (DT == kF32) {
    const float4 v = reinterpret_cast<const float4*>(base)[vi];
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(base)[vi];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (DT == kBF16) {
        out[2 * k] = __uint_as_float(w[k] << 16);
        out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      } else {
        out[2 * k] = __half2float(__ushort_as_half(
            static_cast<unsigned short>(w[k] & 0xffffu)));
        out[2 * k + 1] = __half2float(__ushort_as_half(
            static_cast<unsigned short>(w[k] >> 16)));
      }
    }
  }
}

template <int DT, bool ALIGNED>
__device__ __forceinline__ void store_vec(void* base, long long vi,
                                          const float* in) {
  constexpr int V = Traits<DT>::kVec;
  if constexpr (!ALIGNED) {
#pragma unroll
    for (int k = 0; k < V; ++k) store_one<DT>(base, vi * V + k, in[k]);
  } else if constexpr (DT == kF32) {
    reinterpret_cast<float4*>(base)[vi] = make_float4(in[0], in[1], in[2],
                                                      in[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = static_cast<unsigned>(to_bits<DT>(in[2 * k])) |
             (static_cast<unsigned>(to_bits<DT>(in[2 * k + 1])) << 16);
    }
    reinterpret_cast<uint4*>(base)[vi] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// dot += x*y, na += x*x, nb += y*y, each one fused multiply-add: the same
// operations on (y, x) give (dot, nb, na) bit for bit.
__device__ __forceinline__ void accumulate(float x, float y, float& dot,
                                           float& na, float& nb) {
  dot = __fmaf_rn(x, y, dot);
  na = __fmaf_rn(x, x, na);
  nb = __fmaf_rn(y, y, nb);
}

// Sum v over the block's threads in a fixed order; the total lands in
// thread 0. `sh` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) sh[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, sh[w]);
  }
  __syncthreads();
  return s;
}

// partial: [3][gridDim.x], the block's (dot, |a|^2, |b|^2).
template <int DT, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
adasum_triple_partial_kernel(const void* __restrict__ a,
                             const void* __restrict__ b, long long n,
                             float* __restrict__ partial) {
  constexpr int V = Traits<DT>::kVec;
  float dot[V], na[V], nb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) { dot[k] = 0.f; na[k] = 0.f; nb[k] = 0.f; }
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nv = n / V;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < nv; i += kUnroll * stride) {
    float x[kUnroll][V], y[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_vec<DT, ALIGNED>(a, i + u * stride, x[u]);
      load_vec<DT, ALIGNED>(b, i + u * stride, y[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) accumulate(x[u][k], y[u][k], dot[k], na[k],
                                             nb[k]);
    }
  }
  for (; i < nv; i += stride) {
    float x[V], y[V];
    load_vec<DT, ALIGNED>(a, i, x);
    load_vec<DT, ALIGNED>(b, i, y);
#pragma unroll
    for (int k = 0; k < V; ++k) accumulate(x[k], y[k], dot[k], na[k], nb[k]);
  }
  // the n % V tail, one element a thread, into lane 0
  for (long long j = nv * V + (long long)blockIdx.x * kThreads + threadIdx.x;
       j < n; j += stride) {
    accumulate(load_one<DT>(a, j), load_one<DT>(b, j), dot[0], na[0], nb[0]);
  }
  float d = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    d = __fadd_rn(d, dot[k]);
    sa = __fadd_rn(sa, na[k]);
    sb = __fadd_rn(sb, nb[k]);
  }
  __shared__ float sh[kWarps];
  d = block_sum(d, sh);
  sa = block_sum(sa, sh);
  sb = block_sum(sb, sh);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = d;
    partial[gridDim.x + blockIdx.x] = sa;
    partial[2 * gridDim.x + blockIdx.x] = sb;
  }
}

// triple[q] = sum over the blocks of partial[q][.], block q, in a fixed
// order.
__global__ void __launch_bounds__(kThreads)
adasum_triple_finalize_kernel(const float* __restrict__ partial, int blocks,
                              float* __restrict__ triple) {
  const float* p = partial + (long long)blockIdx.x * blocks;
  float s = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) s = __fadd_rn(s, p[i]);
  __shared__ float sh[kWarps];
  s = block_sum(s, sh);
  if (threadIdx.x == 0) triple[blockIdx.x] = s;
}

// The reference's fp32 coefficient: 1 - dot / (2 n), 0 when n = 0.
__device__ __forceinline__ float coefficient(float dot, float norm) {
  if (norm == 0.f) return 0.f;
  return __fsub_rn(1.f, __fdiv_rn(dot, __fmul_rn(2.f, norm)));
}

template <int DT, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
adasum_scale_kernel(const float* __restrict__ triple,
                    const void* __restrict__ a, const void* __restrict__ b,
                    void* __restrict__ out, long long n) {
  constexpr int V = Traits<DT>::kVec;
  const float ca = coefficient(triple[0], triple[1]);
  const float cb = coefficient(triple[0], triple[2]);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nv = n / V;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nv;
       i += stride) {
    float x[V], y[V], o[V];
    load_vec<DT, ALIGNED>(a, i, x);
    load_vec<DT, ALIGNED>(b, i, y);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      o[k] = __fadd_rn(__fmul_rn(ca, x[k]), __fmul_rn(cb, y[k]));
    }
    store_vec<DT, ALIGNED>(out, i, o);
  }
  for (long long j = nv * V + (long long)blockIdx.x * kThreads + threadIdx.x;
       j < n; j += stride) {
    const float x = load_one<DT>(a, j), y = load_one<DT>(b, j);
    store_one<DT>(out, j, __fadd_rn(__fmul_rn(ca, x), __fmul_rn(cb, y)));
  }
}

template <int DT>
int launch_triple(const void* a, const void* b, long long n, int aligned,
                  int blocks, float* partial, float* triple,
                  cudaStream_t stream) {
  if (aligned) {
    adasum_triple_partial_kernel<DT, true><<<blocks, kThreads, 0, stream>>>(
        a, b, n, partial);
  } else {
    adasum_triple_partial_kernel<DT, false><<<blocks, kThreads, 0, stream>>>(
        a, b, n, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adasum_triple_finalize_kernel<<<3, kThreads, 0, stream>>>(partial, blocks,
                                                            triple);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_scale(const float* triple, const void* a, const void* b,
                 void* out, long long n, int aligned, int blocks,
                 cudaStream_t stream) {
  if (aligned) {
    adasum_scale_kernel<DT, true><<<blocks, kThreads, 0, stream>>>(
        triple, a, b, out, n);
  } else {
    adasum_scale_kernel<DT, false><<<blocks, kThreads, 0, stream>>>(
        triple, a, b, out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// device: CUDA ordinal of the tensors and the stream.
// triple = [sum a*b, sum a*a, sum b*b] in fp32 over n >= 1 elements of a and
// b, both dtype (0 fp32, 1 bf16, 2 fp16), contiguous; aligned = both 16-byte
// aligned. partial: fp32 scratch of 3 * blocks.
int hvd_adasum_triple(int device, const void* a, const void* b, int dtype,
                      long long n, int aligned, int blocks, float* partial,
                      float* triple, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch_triple<kF32>(a, b, n, aligned, blocks, partial,
                                          triple, s);
    case kBF16: return launch_triple<kBF16>(a, b, n, aligned, blocks, partial,
                                            triple, s);
    case kF16: return launch_triple<kF16>(a, b, n, aligned, blocks, partial,
                                          triple, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out = ca * a + cb * b in fp32, stored in the dtype, with ca and cb from
// the fp32 triple in device memory; aligned = a, b and out 16-byte aligned.
int hvd_adasum_scale(int device, const float* triple, const void* a,
                     const void* b, void* out, int dtype, long long n,
                     int aligned, int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch_scale<kF32>(triple, a, b, out, n, aligned,
                                         blocks, s);
    case kBF16: return launch_scale<kBF16>(triple, a, b, out, n, aligned,
                                           blocks, s);
    case kF16: return launch_scale<kF16>(triple, a, b, out, n, aligned,
                                         blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
