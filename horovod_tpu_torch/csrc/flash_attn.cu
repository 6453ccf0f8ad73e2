// Flash attention: the C entry points of K6 and K7, and di = rowsum(dO o O)
// (K6b) for every input type and head dim.
//
// Replaces the Pallas kernels that horovod_tpu/parallel/flash_attention.py:
// flash_attention_local takes from jax's library (the flash / splash
// forward and its custom-VJP backward, _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq) and ring attention's per-segment kernels
// (horovod_tpu/parallel/ring_attention.py: _seg_fwd_pallas,
// _seg_bwd_pallas).
//
// Every forward, dk/dv and dq runs a Hopper kernel (TMA and wgmma): the
// forward of flash_fwd_sm90.cu and the dk/dv and dq of flash_bwd_sm90.cu,
// at every head dim and input type (fp32 on tf32 wgmma; bf16 and fp16
// dk/dv and dq above head dim 256 on the deep kernels, the output columns
// in groups over blocks and S and dP summed over the depth's slabs). They
// read a head dim below their instance's in place (Args::Dr). run() below
// checks a launch's arguments and runs it; there is no fallback: a launch
// runs its kernel or returns the error.
//
// di is a bandwidth-bound row reduction: a warp a row, pairs of elements a
// lane, fp32 sums, a shuffle reduction; nothing is accumulated across
// blocks, so results repeat bitwise, on views as on contiguous copies.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash.cuh"

namespace {

using flash::Args;
using flash::Stat;
using flash::View;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float* stat_row(const Stat& s, int b, int h) {
  return s.p + b * s.sb + h * s.sh;
}

// di[row] = sum_d dO[row, d] * O[row, d] over the views' head dim Dr (pairs
// of columns: Dr is even); one warp per row of B*H*T.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// D = 64 or 128 compile-time when Dr is that (the loop unrolls and its
// loads issue together), 0 for any other Dr, read from p.
template <int D, typename In>
__global__ void __launch_bounds__(kThreads)
flash_bwd_pre_kernel(const Args p) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= (long long)p.B * p.H * p.Tq) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / p.Tq;
  const int t = (int)(row % p.Tq), b = (int)(bh / p.H), h = (int)(bh % p.H);
  const In* orow = reinterpret_cast<const In*>(p.o.p) + b * p.o.sb +
                   h * p.o.sh + t * p.o.st;
  const In* drow = reinterpret_cast<const In*>(p.dout.p) + b * p.dout.sb +
                   h * p.dout.sh + t * p.dout.st;
  float acc = 0.f;
  if (D != 0) {
#pragma unroll
    for (int d = lane * 2; d < D; d += 64) {
      const float2 of = load2(orow + d), df = load2(drow + d);
      acc += of.x * df.x + of.y * df.y;
    }
  } else {
#pragma unroll 4
    for (int d = lane * 2; d < p.Dr; d += 64) {
      const float2 of = load2(orow + d), df = load2(drow + d);
      acc += of.x * df.x + of.y * df.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) stat_row(p.di, b, h)[t] = acc;
}

template <int D, typename In>
cudaError_t pre(const Args& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.H * a.Tq;
  flash_bwd_pre_kernel<D, In>
      <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename In>
cudaError_t pre_in(const Args& a, cudaStream_t s) {
  return a.Dr == 64    ? pre<64, In>(a, s)
         : a.Dr == 128 ? pre<128, In>(a, s)
                       : pre<0, In>(a, s);
}

cudaError_t bwd_pre(const Args& a, cudaStream_t s) {
  switch (a.dtype) {
    case flash::kF16:
      return pre_in<__half>(a, s);
    case flash::kF32:
      return pre_in<float>(a, s);
    default:
      return pre_in<__nv_bfloat16>(a, s);
  }
}

typedef cudaError_t (*Fn)(const Args&, cudaStream_t);

// Checks the arguments every kernel relies on (the views' head dim Dr
// even and at least 2), sets the instance's head dim D (64, 128, or Dr
// rounded up to a multiple of 64: ops/kernels.py:_flash_dim), selects the
// device, and runs `fn`.
int run(int device, Args a, void* stream, Fn fn) {
  if (a.Dr < 2 || a.Dr % 2 != 0) return (int)cudaErrorInvalidValue;
  a.D = a.Dr <= 64 ? 64 : a.Dr <= 128 ? 128 : (a.Dr + 63) / 64 * 64;
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.dtype != flash::kBF16 && a.dtype != flash::kF16 &&
      a.dtype != flash::kF32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)fn(a, (cudaStream_t)stream);
}

View view(const void* ptr, const long long* strides, int i) {
  return View{const_cast<void*>(ptr), strides[3 * i], strides[3 * i + 1],
              strides[3 * i + 2]};
}

// A statistic whose B and H strides follow the n tensors' strides, two by
// two: strides[3n + 2j], strides[3n + 2j + 1].
Stat stat(const float* ptr, const long long* strides, int n, int j) {
  return Stat{const_cast<float*>(ptr), strides[3 * n + 2 * j],
              strides[3 * n + 2 * j + 1]};
}

// A contiguous [B, H, T] statistic.
Stat dense_stat(const float* ptr, int H, int T) {
  return Stat{const_cast<float*>(ptr), (long long)H * T, (long long)T};
}

// The inputs of a launch: q, k, v (and dout) are the first views.
Args inputs(int dtype, const void* q, const void* k, const void* v,
            const void* dout, const long long* strides, int B, int H, int Tq,
            int Tk, int Dr, int causal, float scale) {
  Args a = {};
  a.dtype = dtype;
  a.B = B;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.Dr = Dr;
  a.causal = causal;
  a.scale = scale;
  a.q = view(q, strides, 0);
  a.k = view(k, strides, 1);
  a.v = view(v, strides, 2);
  if (dout != nullptr) a.dout = view(dout, strides, 3);
  return a;
}

}  // namespace

extern "C" {

// Every tensor argument is a [B, H, T, Dr] view, its head dim contiguous,
// with the element strides of B, H and T given three by three in
// `strides` (host memory), in argument order. Dr is their head dim, even.
// dtype: 0 bf16, 1 fp16, 2 fp32 (the inputs'). q and dout have Tq rows, k
// and v Tk. device: the CUDA ordinal of the tensors and stream.
//
// K6 (flash attention): outputs have the inputs' type; lse and di are fp32
// [B, H, Tq] contiguous.

// o = softmax(q k^T * scale) v, lse = logsumexp(q k^T * scale). strides:
// q, k, v, o.
int hvd_flash_fwd(int device, int dtype, const void* q, const void* k,
                  const void* v, void* o, float* lse,
                  const long long* strides, int B, int H, int Tq, int Tk,
                  int Dr, int causal, float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, nullptr, strides, B, H, Tq, Tk, Dr,
                  causal, scale);
  a.o = view(o, strides, 3);
  a.lse = dense_stat(lse, H, Tq);
  return run(device, a, stream, flash::fwd_sm90);
}

// di = rowsum(dout * o). strides: o, dout.
int hvd_flash_bwd_pre(int device, int dtype, const void* o, const void* dout,
                      float* di, const long long* strides, int B, int H,
                      int T, int Dr, void* stream) {
  Args a = {};
  a.dtype = dtype;
  a.B = B;
  a.H = H;
  a.Tq = a.Tk = T;
  a.Dr = Dr;
  a.o = view(o, strides, 0);
  a.dout = view(dout, strides, 1);
  a.di = dense_stat(di, H, T);
  return run(device, a, stream, bwd_pre);
}

// dk = ds^T q * scale, dv = p^T dout, p = exp(q k^T * scale - lse),
// ds = p * (dout v^T - di). strides: q, k, v, dout, dk, dv.
int hvd_flash_bwd_dkdv(int device, int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* di, void* dk, void* dv,
                       const long long* strides, int B, int H, int Tq,
                       int Tk, int Dr, int causal, float scale,
                       void* stream) {
  Args a = inputs(dtype, q, k, v, dout, strides, B, H, Tq, Tk, Dr,
                  causal, scale);
  a.dk = view(dk, strides, 4);
  a.dv = view(dv, strides, 5);
  a.lse = dense_stat(lse, H, Tq);
  a.di = dense_stat(di, H, Tq);
  return run(device, a, stream, flash::bwd_dkdv_sm90);
}

// dq = ds k * scale, ds as above. strides: q, k, v, dout, dq.
int hvd_flash_bwd_dq(int device, int dtype, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* di, void* dq, const long long* strides,
                     int B, int H, int Tq, int Tk, int Dr, int causal,
                     float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, dout, strides, B, H, Tq, Tk, Dr,
                  causal, scale);
  a.dq = view(dq, strides, 4);
  a.lse = dense_stat(lse, H, Tq);
  a.di = dense_stat(di, H, Tq);
  return run(device, a, stream, flash::bwd_dq_sm90);
}

// K7 (ring attention's segments, Tq = Tk = the segment length S): the same
// functions with fp32 outputs, [B, H, S, D] views whose strides follow the
// inputs' in `strides`; lse and di are fp32 [B, H, S] views whose B and H
// strides come last in `strides`, two by two (their T stride is 1).

// strides: q, k, v, o; then lse.
int hvd_flash_seg_fwd(int device, int dtype, const void* q, const void* k,
                      const void* v, float* o, float* lse,
                      const long long* strides, int B, int H, int Tq, int Tk,
                      int Dr, int causal, float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, nullptr, strides, B, H, Tq, Tk, Dr,
                  causal, scale);
  a.o = view(o, strides, 3);
  a.lse = stat(lse, strides, 4, 0);
  a.out_f32 = 1;
  return run(device, a, stream, flash::fwd_sm90);
}

// (dk, dv) of one segment under the given lse and di.
// strides: q, k, v, dout, dk, dv; then lse, di.
int hvd_flash_seg_bwd_dkdv(int device, int dtype, const void* q,
                           const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, float* dk,
                           float* dv, const long long* strides, int B, int H,
                           int Tq, int Tk, int Dr, int causal,
                           float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, dout, strides, B, H, Tq, Tk, Dr,
                  causal, scale);
  a.dk = view(dk, strides, 4);
  a.dv = view(dv, strides, 5);
  a.lse = stat(lse, strides, 6, 0);
  a.di = stat(di, strides, 6, 1);
  a.out_f32 = 1;
  return run(device, a, stream, flash::bwd_dkdv_sm90);
}

// dq of one segment under the given lse and di.
// strides: q, k, v, dout, dq; then lse, di.
int hvd_flash_seg_bwd_dq(int device, int dtype, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* di, float* dq, const long long* strides,
                         int B, int H, int Tq, int Tk, int Dr,
                         int causal, float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, dout, strides, B, H, Tq, Tk, Dr,
                  causal, scale);
  a.dq = view(dq, strides, 4);
  a.lse = stat(lse, strides, 5, 0);
  a.di = stat(di, strides, 5, 1);
  a.out_f32 = 1;
  return run(device, a, stream, flash::bwd_dq_sm90);
}

}  // extern "C"
