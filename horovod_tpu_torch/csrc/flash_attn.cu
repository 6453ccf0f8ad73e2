// Flash attention: the C entry points of K6 and K7, di = rowsum(dO o O)
// (K6b) for every input type, and the fp32 family of the forward and the
// backward on tf32 tensor cores.
//
// Replaces the Pallas kernels that horovod_tpu/parallel/flash_attention.py:
// flash_attention_local takes from jax's library (the flash / splash
// forward and its custom-VJP backward, _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq) and ring attention's per-segment kernels
// (horovod_tpu/parallel/ring_attention.py: _seg_fwd_pallas,
// _seg_bwd_pallas). bf16 and fp16 inputs run the Hopper kernels of
// flash_fwd_sm90.cu and flash_bwd_sm90.cu (TMA and wgmma); fp32 inputs run
// the kernels below.
//
// The fp32 family. wgmma takes tf32 operands K-major only, and four of the
// attention products (P V, P^T dO, dS^T Q, dS K) would need an MN-major
// one, so fp32 runs on mma.sync m16n8k8 tf32 instead: the tiles are staged
// in shared memory as fp32 (rows padded by 4 floats), every fragment is a
// scalar load from it (so a transposed operand is only another index),
// operands are rounded to tf32 (cvt.rna) as they are loaded, and the
// accumulators are fp32. P and dS go from the accumulators to a warp's own
// rows of shared memory to become the next product's A. Each warp owns 16
// rows of its block's tile; 4 warps a block, tiles of 64 rows by 32:
// - forward: a block of 64 q rows, online softmax over kv tiles of 32;
// - dk/dv: a block of 64 kv rows, q tiles of 32 from the causal diagonal
//   on, P^T = exp(K Q^T * scale - lse), dV += P^T dO, dK += dS^T Q;
// - dq: a block of 64 q rows, kv tiles of 32, dQ += dS K.
// What bounds it: operations, at tf32's 495 TFLOP/s, half of bf16's; no
// shipped configuration trains attention in fp32, so it is the simple
// tile code, unpipelined. Its error is tf32's: the operands keep 10
// mantissa bits (unit roundoff 2^-11).
//
// Causal (key <= query by absolute index) tiles past the diagonal are never
// loaded, and a tile that crosses the diagonal or the end of q or k/v runs
// the mask; rows past the ends load as zeros and are never stored. The
// arithmetic never sees the views' strides and nothing is accumulated
// across blocks: results repeat bitwise, on views as on contiguous copies.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash.cuh"

namespace {

using flash::Args;
using flash::Stat;
using flash::View;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 4;     // floats of padding at the end of a staged row
constexpr int kRows = 64;   // rows of a block's own tile (16 a warp)
constexpr int kTile = 32;   // rows of a streamed tile
constexpr int kLdP = kTile + kPad;   // row pitch of the staged P or dS
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;   // the lse of a row that sees no key

__device__ __forceinline__ float* head_ptr(const View& t, int b, int h) {
  return reinterpret_cast<float*>(t.p) + b * t.sb + h * t.sh;
}

__device__ __forceinline__ float* stat_row(const Stat& s, int b, int h) {
  return s.p + b * s.sb + h * s.sh;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a b, a 16x8 (row), b 8x8 (col), c 16x8; tf32 operands, fp32 sums.
// a: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b: (k t,
// col g), (t + 4, g); c: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// rows [row0, row0 + ROWS) of one head into shared memory (row pitch
// D + kPad); rows at or past T are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* s, const float* head,
                                          long long st, int row0, int T) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T)
      val = *reinterpret_cast<const float4*>(head + (row0 + r) * st + c * 4);
    *reinterpret_cast<float4*>(s + r * (D + kPad) + c * 4) = val;
  }
}

// c[j] += X[x0 + 16 rows][0, K) Y[8j + n][0, K)^T: both operands stored as
// rows of their depth (S = Q K^T, dP = dO V^T and their transposes).
template <int K, int NT>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4], const float* x,
                                        int ldx, const float* y, int ldy,
                                        int g, int t) {
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float* xa = x + g * ldx + k0 + t;
    const uint32_t a0 = tf32(xa[0]), a1 = tf32(xa[8 * ldx]);
    const uint32_t a2 = tf32(xa[4]), a3 = tf32(xa[8 * ldx + 4]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* yb = y + (8 * j + g) * ldy + k0 + t;
      mma(c[j], a0, a1, a2, a3, tf32(yb[0]), tf32(yb[4]));
    }
  }
}

// c[j] += X[16 rows][0, K) Y[0, K)[8j + n]: Y stored as rows of the depth
// (P V, P^T dO, dS^T Q, dS K).
template <int K, int NT>
__device__ __forceinline__ void gemm_nn(float (&c)[NT][4], const float* x,
                                        int ldx, const float* y, int ldy,
                                        int g, int t) {
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float* xa = x + g * ldx + k0 + t;
    const uint32_t a0 = tf32(xa[0]), a1 = tf32(xa[8 * ldx]);
    const uint32_t a2 = tf32(xa[4]), a3 = tf32(xa[8 * ldx + 4]);
    const float* yb = y + (k0 + t) * ldy + g;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma(c[j], a0, a1, a2, a3, tf32(yb[8 * j]), tf32(yb[4 * ldy + 8 * j]));
  }
}

// A warp's 16 x kTile accumulator into its own rows of the staging tile
// (pitch kLdP), to be read back as the A of the next product.
__device__ __forceinline__ void stage(float* pw,
                                      const float (&c)[kTile / 8][4], int g,
                                      int t) {
  __syncwarp();   // the previous product has read what is overwritten
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    float* p = pw + g * kLdP + 8 * j + 2 * t;
    p[0] = c[j][0];
    p[1] = c[j][1];
    p[8 * kLdP] = c[j][2];
    p[8 * kLdP + 1] = c[j][3];
  }
  __syncwarp();
}

// rows r_lo and r_lo + 8 of a 16 x D accumulator, times mul[i], to the rows
// < T of one head of `out`.
template <int D>
__device__ __forceinline__ void store_rows(const View& out, int b, int h,
                                           int r_lo, int T,
                                           const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int t) {
  float* head = head_ptr(out, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= T) continue;
    float* row = head + r * out.st;
#pragma unroll
    for (int dj = 0; dj < D / 8; ++dj)
      *reinterpret_cast<float2*>(row + 8 * dj + 2 * t) =
          make_float2(acc[dj][2 * i] * mul[i], acc[dj][2 * i + 1] * mul[i]);
  }
}

template <int D>
constexpr int fwd_smem() {
  return ((kRows + 2 * kTile) * (D + kPad) + kRows * kLdP) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tf32_kernel(const Args p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kRows * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // causal: the longest rows first, so the last wave is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + warp * 16 + g;
  float* pw = ps + warp * 16 * kLdP;
  const float sl2 = p.scale * kLog2e;

  load_tile<D, kRows>(qs, head_ptr(p.q, b, h), p.q.st, q0, p.Tq);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
  zero(o);

  const int kv_end = p.causal ? min(p.Tk, q0 + kRows) : p.Tk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();   // the previous tile is consumed
    load_tile<D, kTile>(ks, head_ptr(p.k, b, h), p.k.st, kv0, p.Tk);
    load_tile<D, kTile>(vs, head_ptr(p.v, b, h), p.v.st, kv0, p.Tk);
    __syncthreads();
    float s[kTile / 8][4];
    zero(s);
    gemm_nt<D, kTile / 8>(s, qs + warp * 16 * LD, LD, ks, LD, g, t);
    const bool mask =
        kv0 + kTile > p.Tk || (p.causal && kv0 + kTile - 1 > q0 + warp * 16);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1);
        const int col = kv0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * sl2;
        if (mask && (col >= p.Tk || (p.causal && col > row))) x = -INFINITY;
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2], msub[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float mnew = fmaxf(m[i], mt[i]);
      // nothing seen yet in this row: nothing to rescale
      alpha[i] = mnew == -INFINITY ? 1.f : exp2f(m[i] - mnew);
      msub[i] = mnew == -INFINITY ? 0.f : mnew;
      m[i] = mnew;
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - msub[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dj = 0; dj < D / 8; ++dj) {
      o[dj][0] *= alpha[0];
      o[dj][1] *= alpha[0];
      o[dj][2] *= alpha[1];
      o[dj][3] *= alpha[1];
    }
    stage(pw, s, g, t);
    gemm_nn<kTile, D / 8>(o, pw, kLdP, vs, LD, g, t);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    // a row that saw no key: o = 0, lse = the finite sentinel
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  store_rows<D>(p.o, b, h, r_lo, p.Tq, o, inv, t);
  if (t == 0) {
    float* lse = stat_row(p.lse, b, h);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      if (r < p.Tq) lse[r] = l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : kNegInf;
    }
  }
}

template <int D>
constexpr int dkdv_smem() {
  return ((2 * kRows + 2 * kTile) * (D + kPad) + kRows * kLdP + 2 * kTile) *
         4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tf32_kernel(const Args p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kRows * LD;
  float* qs = vs + kRows * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;
  float* lse_s = ps + kRows * kLdP;
  float* di_s = lse_s + kTile;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // causal: the first kv tiles see the most q tiles; they start first
  const int kv0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = kv0 + warp * 16 + g;   // kv rows of this thread
  float* pw = ps + warp * 16 * kLdP;
  const float sl2 = p.scale * kLog2e;
  const float* lse = stat_row(p.lse, b, h);
  const float* di = stat_row(p.di, b, h);

  load_tile<D, kRows>(ks, head_ptr(p.k, b, h), p.k.st, kv0, p.Tk);
  load_tile<D, kRows>(vs, head_ptr(p.v, b, h), p.v.st, kv0, p.Tk);
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);

  // causal: key <= query, so the q tiles from the one holding row kv0 on
  const int q_start = p.causal ? kv0 : 0;
  for (int q0 = q_start; q0 < p.Tq; q0 += kTile) {
    __syncthreads();
    load_tile<D, kTile>(qs, head_ptr(p.q, b, h), p.q.st, q0, p.Tq);
    load_tile<D, kTile>(dos, head_ptr(p.dout, b, h), p.dout.st, q0, p.Tq);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      // past Tq: lse +inf makes p exactly 0
      lse_s[threadIdx.x] = r < p.Tq ? lse[r] * kLog2e : INFINITY;
      di_s[threadIdx.x] = r < p.Tq ? di[r] : 0.f;
    }
    __syncthreads();
    const bool mask = p.causal && kv0 + warp * 16 + 15 > q0;
    // P^T = exp(K Q^T * scale - lse), masked
    float pt[kTile / 8][4];
    zero(pt);
    gemm_nt<D, kTile / 8>(pt, ks + warp * 16 * LD, LD, qs, LD, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = exp2f(pt[j][e] * sl2 - lse_s[c]);
        if (mask && r_lo + 8 * (e >> 1) > q0 + c) x = 0.f;
        pt[j][e] = x;
      }
    }
    stage(pw, pt, g, t);
    gemm_nn<kTile, D / 8>(dv, pw, kLdP, dos, LD, g, t);
    // dP^T = V dO^T; dS^T = P^T * (dP^T - di)
    float dst[kTile / 8][4];
    zero(dst);
    gemm_nt<D, kTile / 8>(dst, vs + warp * 16 * LD, LD, dos, LD, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        dst[j][e] = pt[j][e] * (dst[j][e] - di_s[c]);
      }
    }
    stage(pw, dst, g, t);
    gemm_nn<kTile, D / 8>(dk, pw, kLdP, qs, LD, g, t);
  }
  const float one[2] = {1.f, 1.f}, sc[2] = {p.scale, p.scale};
  store_rows<D>(p.dk, b, h, r_lo, p.Tk, dk, sc, t);
  store_rows<D>(p.dv, b, h, r_lo, p.Tk, dv, one, t);
}

template <int D>
constexpr int dq_smem() {
  return ((2 * kRows + 2 * kTile) * (D + kPad) + kRows * kLdP) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tf32_kernel(const Args p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kRows * LD;
  float* ks = dos + kRows * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + warp * 16 + g;
  float* pw = ps + warp * 16 * kLdP;
  const float sl2 = p.scale * kLog2e;
  const float* lse = stat_row(p.lse, b, h);
  const float* di = stat_row(p.di, b, h);
  float lse_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    lse_r[i] = r < p.Tq ? lse[r] * kLog2e : 0.f;
    di_r[i] = r < p.Tq ? di[r] : 0.f;
  }
  load_tile<D, kRows>(qs, head_ptr(p.q, b, h), p.q.st, q0, p.Tq);
  load_tile<D, kRows>(dos, head_ptr(p.dout, b, h), p.dout.st, q0, p.Tq);
  float dq[D / 8][4];
  zero(dq);

  const int kv_end = p.causal ? min(p.Tk, q0 + kRows) : p.Tk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();
    load_tile<D, kTile>(ks, head_ptr(p.k, b, h), p.k.st, kv0, p.Tk);
    load_tile<D, kTile>(vs, head_ptr(p.v, b, h), p.v.st, kv0, p.Tk);
    __syncthreads();
    float s[kTile / 8][4], dp[kTile / 8][4];
    zero(s);
    zero(dp);
    gemm_nt<D, kTile / 8>(s, qs + warp * 16 * LD, LD, ks, LD, g, t);
    gemm_nt<D, kTile / 8>(dp, dos + warp * 16 * LD, LD, vs, LD, g, t);
    const bool mask =
        kv0 + kTile > p.Tk || (p.causal && kv0 + kTile - 1 > q0 + warp * 16);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = kv0 + 8 * j + 2 * t + (e & 1);
        float x = exp2f(s[j][e] * sl2 - lse_r[i]);
        if (mask && (col >= p.Tk || (p.causal && col > r_lo + 8 * i)))
          x = 0.f;
        s[j][e] = x * (dp[j][e] - di_r[i]);   // dS
      }
    }
    stage(pw, s, g, t);
    gemm_nn<kTile, D / 8>(dq, pw, kLdP, ks, LD, g, t);
  }
  const float sc[2] = {p.scale, p.scale};
  store_rows<D>(p.dq, b, h, r_lo, p.Tq, dq, sc, t);
}

// di[row] = sum_d dO[row, d] * O[row, d]; one warp per row of B*H*T.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

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
#pragma unroll
  for (int d = lane * 2; d < D; d += 64) {
    const float2 of = load2(orow + d), df = load2(drow + d);
    acc += of.x * df.x + of.y * df.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) stat_row(p.di, b, h)[t] = acc;
}

// ---------------------------------------------------------------------------
// launch

// Opt a kernel into more than 48 KB of dynamic shared memory and launch it
// over (B * H, the blocks of T rows). The attribute belongs to the current
// device, so it is set at every launch: a process may launch on several
// cards, and the call costs little.
template <typename K>
cudaError_t launch(K kernel, int smem, int T, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((T + kRows - 1) / kRows));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t fwd_tf32(const Args& a, cudaStream_t s) {
  return a.D == 64 ? launch(flash_fwd_tf32_kernel<64>, fwd_smem<64>(), a.Tq,
                            a, s)
                   : launch(flash_fwd_tf32_kernel<128>, fwd_smem<128>(),
                            a.Tq, a, s);
}

cudaError_t dkdv_tf32(const Args& a, cudaStream_t s) {
  return a.D == 64 ? launch(flash_bwd_dkdv_tf32_kernel<64>, dkdv_smem<64>(),
                            a.Tk, a, s)
                   : launch(flash_bwd_dkdv_tf32_kernel<128>,
                            dkdv_smem<128>(), a.Tk, a, s);
}

cudaError_t dq_tf32(const Args& a, cudaStream_t s) {
  return a.D == 64 ? launch(flash_bwd_dq_tf32_kernel<64>, dq_smem<64>(), a.Tq,
                            a, s)
                   : launch(flash_bwd_dq_tf32_kernel<128>, dq_smem<128>(),
                            a.Tq, a, s);
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
  return a.D == 64 ? pre<64, In>(a, s) : pre<128, In>(a, s);
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

// Checks the arguments every kernel relies on, selects the device, and
// runs `sm90` (bf16, fp16) or `f32` (fp32).
int run(int device, const Args& a, void* stream, Fn sm90, Fn f32) {
  if (a.D != 64 && a.D != 128) return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.dtype != flash::kBF16 && a.dtype != flash::kF16 &&
      a.dtype != flash::kF32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(a.dtype == flash::kF32 ? f32 : sm90)(a, (cudaStream_t)stream);
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
            int Tk, int D, int causal, float scale) {
  Args a = {};
  a.dtype = dtype;
  a.B = B;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.D = D;
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

// Every tensor argument is a [B, H, T, D] view, D = 64 or 128 contiguous,
// with the element strides of B, H and T given three by three in
// `strides` (host memory), in argument order. dtype: 0 bf16, 1 fp16, 2 fp32
// (the inputs'). q and dout have Tq rows, k and v Tk. device: the CUDA
// ordinal of the tensors and stream.
//
// K6 (flash attention): outputs have the inputs' type; lse and di are fp32
// [B, H, Tq] contiguous.

// o = softmax(q k^T * scale) v, lse = logsumexp(q k^T * scale). strides:
// q, k, v, o.
int hvd_flash_fwd(int device, int dtype, const void* q, const void* k,
                  const void* v, void* o, float* lse,
                  const long long* strides, int B, int H, int Tq, int Tk,
                  int D, int causal, float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, nullptr, strides, B, H, Tq, Tk, D, causal,
                  scale);
  a.o = view(o, strides, 3);
  a.lse = dense_stat(lse, H, Tq);
  return run(device, a, stream, flash::fwd_sm90, fwd_tf32);
}

// di = rowsum(dout * o). strides: o, dout.
int hvd_flash_bwd_pre(int device, int dtype, const void* o, const void* dout,
                      float* di, const long long* strides, int B, int H,
                      int T, int D, void* stream) {
  Args a = {};
  a.dtype = dtype;
  a.B = B;
  a.H = H;
  a.Tq = a.Tk = T;
  a.D = D;
  a.o = view(o, strides, 0);
  a.dout = view(dout, strides, 1);
  a.di = dense_stat(di, H, T);
  return run(device, a, stream, bwd_pre, bwd_pre);
}

// dk = ds^T q * scale, dv = p^T dout, p = exp(q k^T * scale - lse),
// ds = p * (dout v^T - di). strides: q, k, v, dout, dk, dv.
int hvd_flash_bwd_dkdv(int device, int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* di, void* dk, void* dv,
                       const long long* strides, int B, int H, int Tq,
                       int Tk, int D, int causal, float scale,
                       void* stream) {
  Args a = inputs(dtype, q, k, v, dout, strides, B, H, Tq, Tk, D, causal,
                  scale);
  a.dk = view(dk, strides, 4);
  a.dv = view(dv, strides, 5);
  a.lse = dense_stat(lse, H, Tq);
  a.di = dense_stat(di, H, Tq);
  return run(device, a, stream, flash::bwd_dkdv_sm90, dkdv_tf32);
}

// dq = ds k * scale, ds as above. strides: q, k, v, dout, dq.
int hvd_flash_bwd_dq(int device, int dtype, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* di, void* dq, const long long* strides,
                     int B, int H, int Tq, int Tk, int D, int causal,
                     float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, dout, strides, B, H, Tq, Tk, D, causal,
                  scale);
  a.dq = view(dq, strides, 4);
  a.lse = dense_stat(lse, H, Tq);
  a.di = dense_stat(di, H, Tq);
  return run(device, a, stream, flash::bwd_dq_sm90, dq_tf32);
}

// K7 (ring attention's segments, Tq = Tk = the segment length S): the same
// functions with fp32 outputs, [B, H, S, D] views whose strides follow the
// inputs' in `strides`; lse and di are fp32 [B, H, S] views whose B and H
// strides come last in `strides`, two by two (their T stride is 1).

// strides: q, k, v, o; then lse.
int hvd_flash_seg_fwd(int device, int dtype, const void* q, const void* k,
                      const void* v, float* o, float* lse,
                      const long long* strides, int B, int H, int Tq, int Tk,
                      int D, int causal, float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, nullptr, strides, B, H, Tq, Tk, D, causal,
                  scale);
  a.o = view(o, strides, 3);
  a.lse = stat(lse, strides, 4, 0);
  a.out_f32 = 1;
  return run(device, a, stream, flash::fwd_sm90, fwd_tf32);
}

// (dk, dv) of one segment under the given lse and di.
// strides: q, k, v, dout, dk, dv; then lse, di.
int hvd_flash_seg_bwd_dkdv(int device, int dtype, const void* q,
                           const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, float* dk,
                           float* dv, const long long* strides, int B, int H,
                           int Tq, int Tk, int D, int causal, float scale,
                           void* stream) {
  Args a = inputs(dtype, q, k, v, dout, strides, B, H, Tq, Tk, D, causal,
                  scale);
  a.dk = view(dk, strides, 4);
  a.dv = view(dv, strides, 5);
  a.lse = stat(lse, strides, 6, 0);
  a.di = stat(di, strides, 6, 1);
  a.out_f32 = 1;
  return run(device, a, stream, flash::bwd_dkdv_sm90, dkdv_tf32);
}

// dq of one segment under the given lse and di.
// strides: q, k, v, dout, dq; then lse, di.
int hvd_flash_seg_bwd_dq(int device, int dtype, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* di, float* dq, const long long* strides,
                         int B, int H, int Tq, int Tk, int D, int causal,
                         float scale, void* stream) {
  Args a = inputs(dtype, q, k, v, dout, strides, B, H, Tq, Tk, D, causal,
                  scale);
  a.dq = view(dq, strides, 4);
  a.lse = stat(lse, strides, 5, 0);
  a.di = stat(di, strides, 5, 1);
  a.out_f32 = 1;
  return run(device, a, stream, flash::bwd_dq_sm90, dq_tf32);
}

}  // extern "C"
