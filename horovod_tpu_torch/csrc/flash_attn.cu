// Flash attention: the C entry points of K6 and K7, di = rowsum(dO o O)
// (K6b) for every input type and head dim, and the mma.sync family of the
// backward: bf16 and fp16 dk/dv and dq above head dim 256.
//
// Replaces the Pallas kernels that horovod_tpu/parallel/flash_attention.py:
// flash_attention_local takes from jax's library (the flash / splash
// forward and its custom-VJP backward, _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq) and ring attention's per-segment kernels
// (horovod_tpu/parallel/ring_attention.py: _seg_fwd_pallas,
// _seg_bwd_pallas).
//
// The route (run() below; ops/kernels.py:flash_route says the same):
// - the forward: the Hopper kernels of flash_fwd_sm90.cu (TMA and wgmma)
//   at every head dim and input type, fp32 on tf32 wgmma;
// - dk/dv and dq: the Hopper kernels of flash_bwd_sm90.cu, fp32 at every
//   head dim (tf32 wgmma, the output columns in groups over blocks), bf16
//   and fp16 up to head dim 256 (kBwdMaxD);
// - bf16 and fp16 dk/dv and dq above 256: the mma.sync family below.
//   wgmma's N is at most 256, and the 16-bit Hopper dk/dv holds dK and dV
//   of its 64 kv rows at the whole D, and dq dQ beside S and dP, which fit
//   no register budget above 256 yet.
// The Hopper kernels read a head dim below their instance's in place
// (Args::Dr); the mma.sync family takes Dr = D (the wrapper pads). There is
// no fallback: a launch runs its route's kernel or returns the error.
//
// The mma.sync family runs mma.sync m16n8k8 on tf32: tiles are staged in
// shared memory as fp32 (rows padded by 4 floats), every fragment is a
// scalar load from it (so a transposed operand is only another index),
// operands are rounded to tf32 (cvt.rna) as they are loaded, and the
// accumulators are fp32. bf16 and fp16 values are exact in tf32 (8 and 11
// significant bits of tf32's 11), so the 16-bit inputs are staged as fp32
// and multiplied exactly, and P and dS are rounded to the input type before
// their products (as the plain versions round them): the results are fp32
// sums of the products the plain versions form. P and dS go from the
// accumulators to a warp's own rows of shared memory to become the next
// product's A. Each warp owns 16 rows of its block's tile; 4 warps a block,
// tiles of 64 rows by 32:
// - dk/dv: a block of 64 kv rows, q tiles of 32 from the causal diagonal
//   on, P^T = exp(K Q^T * scale - lse), dV += P^T dO, dK += dS^T Q;
// - dq: a block of 64 q rows, kv tiles of 32, dQ += dS K.
// The wrapper pads D to a multiple of 64 (the family reads every view at D
// columns: Dr = D). The grid's third dimension splits the output columns
// into slices of kDS = 128; a block holds accumulators for its slice only
// (dk/dv: two 16 x 128 a warp, which fit) and computes S = Q K^T and
// dP = dO V^T over the whole D in chunks of kDS columns staged one after
// the other, S (and dP) again in each slice: at D 320 three times the
// products of S and dP, the price of holding no more than 128 accumulator
// columns. What bounds it: operations, at tf32's 495 TFLOP/s, half of
// bf16's; it is the simple tile code, unpipelined.
//
// Causal (key <= query by absolute index) tiles past the diagonal are never
// loaded, and a tile that crosses the diagonal or the end of q or k/v runs
// the mask; rows past the ends and columns past D load as zeros and are
// never stored. The arithmetic never sees the views' strides and nothing is
// accumulated across blocks: results repeat bitwise, on views as on
// contiguous copies.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
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
constexpr int kDS = 128;    // output columns of a block's slice
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;   // the lse of a row that sees no key

template <typename T>
__device__ __forceinline__ T* head_ptr(const View& t, int b, int h) {
  return reinterpret_cast<T*>(t.p) + b * t.sb + h * t.sh;
}

__device__ __forceinline__ float* stat_row(const Stat& s, int b, int h) {
  return s.p + b * s.sb + h * s.sh;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x rounded to In (to nearest even), as a float.
template <typename In>
__device__ __forceinline__ float round_in(float x);
template <>
__device__ __forceinline__ float round_in<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float round_in<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

// Four neighbouring elements of In as floats.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Two floats stored as a pair of Out.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
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

// Rows [row0, row0 + ROWS) and columns [col0, col0 + width) of one head into
// shared memory as fp32 (row pitch LD); rows at or past T and columns past
// width (up to LD - kPad) are zero. width is a multiple of 4.
template <int ROWS, int LD, typename In>
__device__ __forceinline__ void load_tile(float* s, const In* head,
                                          long long st, int row0, int T,
                                          int col0, int width) {
  constexpr int kChunks = (LD - kPad) / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = 4 * (i % kChunks);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T && c < width)
      val = load4(head + (row0 + r) * st + col0 + c);
    *reinterpret_cast<float4*>(s + r * LD + c) = val;
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

// gemm_nt over a chunk of the depth w = 64 or kDS wide (D is a multiple of
// 64), each width a loop of compile-time length.
template <int NT>
__device__ __forceinline__ void gemm_nt_chunk(float (&c)[NT][4],
                                              const float* x, int ldx,
                                              const float* y, int ldy, int w,
                                              int g, int t) {
  if (w == 64)
    gemm_nt<64, NT>(c, x, ldx, y, ldy, g, t);
  else
    gemm_nt<kDS, NT>(c, x, ldx, y, ldy, g, t);
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

// A warp's 16 x kTile accumulator, rounded to In, into its own rows of the
// staging tile (pitch kLdP), to be read back as the A of the next product.
template <typename In>
__device__ __forceinline__ void stage(float* pw,
                                      const float (&c)[kTile / 8][4], int g,
                                      int t) {
  __syncwarp();   // the previous product has read what is overwritten
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    float* p = pw + g * kLdP + 8 * j + 2 * t;
    p[0] = round_in<In>(c[j][0]);
    p[1] = round_in<In>(c[j][1]);
    p[8 * kLdP] = round_in<In>(c[j][2]);
    p[8 * kLdP + 1] = round_in<In>(c[j][3]);
  }
  __syncwarp();
}

// Rows r_lo and r_lo + 8 of a 16 x kDS accumulator, times mul[i], to the
// rows < T and columns col0 + [0, kDS) < D of one head of `out`.
template <typename Out>
__device__ __forceinline__ void store_rows(const View& out, int b, int h,
                                           int r_lo, int T, int col0, int D,
                                           const float (&acc)[kDS / 8][4],
                                           const float (&mul)[2], int t) {
  Out* head = head_ptr<Out>(out, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= T) continue;
    Out* row = head + r * out.st + col0;
#pragma unroll
    for (int dj = 0; dj < kDS / 8; ++dj)
      if (col0 + 8 * dj + 2 * t < D)
        store2(row + 8 * dj + 2 * t, acc[dj][2 * i] * mul[i],
               acc[dj][2 * i + 1] * mul[i]);
  }
}

// The chunks of the depth and the block's slice of the output columns.
struct Cols {
  int n_chunks, col0, width;
  __device__ explicit Cols(int D)
      : n_chunks((D + kDS - 1) / kDS),
        col0((int)blockIdx.z * kDS),
        width(min(kDS, D - (int)blockIdx.z * kDS)) {}
  __device__ static int chunk_width(int D, int ch) {
    return min(kDS, D - ch * kDS);
  }
};

constexpr int dkdv_smem() {
  return ((2 * kRows + 2 * kTile) * (kDS + kPad) + kRows * kLdP +
          2 * kTile) *
         4;
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma_kernel(const Args p) {
  constexpr int LD = kDS + kPad;
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
  const Cols cols(p.D);
  const In* qh = head_ptr<In>(p.q, b, h);
  const In* kh = head_ptr<In>(p.k, b, h);
  const In* vh = head_ptr<In>(p.v, b, h);
  const In* doh = head_ptr<In>(p.dout, b, h);

  float dk[kDS / 8][4], dv[kDS / 8][4];
  zero(dk);
  zero(dv);

  // causal: key <= query, so the q tiles from the one holding row kv0 on
  const int q_start = p.causal ? kv0 : 0;
  for (int q0 = q_start; q0 < p.Tq; q0 += kTile) {
    // P^T = exp(K Q^T * scale - lse), masked, over the chunks of the depth
    float pt[kTile / 8][4];
    zero(pt);
    for (int ch = 0; ch < cols.n_chunks; ++ch) {
      const int w = Cols::chunk_width(p.D, ch);
      __syncthreads();
      load_tile<kRows, LD>(ks, kh, p.k.st, kv0, p.Tk, ch * kDS, w);
      load_tile<kTile, LD>(qs, qh, p.q.st, q0, p.Tq, ch * kDS, w);
      if (ch == 0 && threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        // past Tq: lse +inf makes p exactly 0
        lse_s[threadIdx.x] = r < p.Tq ? lse[r] * kLog2e : INFINITY;
        di_s[threadIdx.x] = r < p.Tq ? di[r] : 0.f;
      }
      __syncthreads();
      gemm_nt_chunk<kTile / 8>(pt, ks + warp * 16 * LD, LD, qs, LD, w, g,
                               t);
    }
    const bool mask = p.causal && kv0 + warp * 16 + 15 > q0;
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
    // dV += P^T dO over the block's slice of columns
    __syncthreads();
    load_tile<kTile, LD>(dos, doh, p.dout.st, q0, p.Tq, cols.col0,
                         cols.width);
    __syncthreads();
    stage<In>(pw, pt, g, t);
    gemm_nn<kTile, kDS / 8>(dv, pw, kLdP, dos, LD, g, t);
    // dP^T = V dO^T over the chunks; dS^T = P^T * (dP^T - di)
    float dst[kTile / 8][4];
    zero(dst);
    for (int ch = 0; ch < cols.n_chunks; ++ch) {
      const int w = Cols::chunk_width(p.D, ch);
      __syncthreads();
      load_tile<kRows, LD>(vs, vh, p.v.st, kv0, p.Tk, ch * kDS, w);
      load_tile<kTile, LD>(dos, doh, p.dout.st, q0, p.Tq, ch * kDS, w);
      __syncthreads();
      gemm_nt_chunk<kTile / 8>(dst, vs + warp * 16 * LD, LD, dos, LD, w, g,
                               t);
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        dst[j][e] = pt[j][e] * (dst[j][e] - di_s[c]);
      }
    }
    // dK += dS^T Q over the block's slice of columns
    __syncthreads();
    load_tile<kTile, LD>(qs, qh, p.q.st, q0, p.Tq, cols.col0, cols.width);
    __syncthreads();
    stage<In>(pw, dst, g, t);
    gemm_nn<kTile, kDS / 8>(dk, pw, kLdP, qs, LD, g, t);
  }
  const float one_[2] = {1.f, 1.f}, sc[2] = {p.scale, p.scale};
  store_rows<Out>(p.dk, b, h, r_lo, p.Tk, cols.col0, p.D, dk, sc, t);
  store_rows<Out>(p.dv, b, h, r_lo, p.Tk, cols.col0, p.D, dv, one_, t);
}

constexpr int dq_smem() {
  return ((2 * kRows + 2 * kTile) * (kDS + kPad) + kRows * kLdP) * 4;
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const Args p) {
  constexpr int LD = kDS + kPad;
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
  const Cols cols(p.D);
  const In* qh = head_ptr<In>(p.q, b, h);
  const In* kh = head_ptr<In>(p.k, b, h);
  const In* vh = head_ptr<In>(p.v, b, h);
  const In* doh = head_ptr<In>(p.dout, b, h);
  float lse_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    lse_r[i] = r < p.Tq ? lse[r] * kLog2e : 0.f;
    di_r[i] = r < p.Tq ? di[r] : 0.f;
  }
  float dq[kDS / 8][4];
  zero(dq);

  const int kv_end = p.causal ? min(p.Tk, q0 + kRows) : p.Tk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    // S = Q K^T and dP = dO V^T over the chunks of the depth
    float s[kTile / 8][4], dp[kTile / 8][4];
    zero(s);
    zero(dp);
    for (int ch = 0; ch < cols.n_chunks; ++ch) {
      const int w = Cols::chunk_width(p.D, ch);
      __syncthreads();
      load_tile<kRows, LD>(qs, qh, p.q.st, q0, p.Tq, ch * kDS, w);
      load_tile<kRows, LD>(dos, doh, p.dout.st, q0, p.Tq, ch * kDS, w);
      load_tile<kTile, LD>(ks, kh, p.k.st, kv0, p.Tk, ch * kDS, w);
      load_tile<kTile, LD>(vs, vh, p.v.st, kv0, p.Tk, ch * kDS, w);
      __syncthreads();
      gemm_nt_chunk<kTile / 8>(s, qs + warp * 16 * LD, LD, ks, LD, w, g, t);
      gemm_nt_chunk<kTile / 8>(dp, dos + warp * 16 * LD, LD, vs, LD, w, g,
                               t);
    }
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
    // dQ += dS K over the block's slice of columns
    __syncthreads();
    load_tile<kTile, LD>(ks, kh, p.k.st, kv0, p.Tk, cols.col0, cols.width);
    __syncthreads();
    stage<In>(pw, s, g, t);
    gemm_nn<kTile, kDS / 8>(dq, pw, kLdP, ks, LD, g, t);
  }
  const float sc[2] = {p.scale, p.scale};
  store_rows<Out>(p.dq, b, h, r_lo, p.Tq, cols.col0, p.D, dq, sc, t);
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

// ---------------------------------------------------------------------------
// launch

// Opt a kernel into more than 48 KB of dynamic shared memory and launch it
// over (B * H, the blocks of T rows, the slices of the head dim). The
// attribute belongs to the current device, so it is set at every launch: a
// process may launch on several cards, and the call costs little.
template <typename K>
cudaError_t launch(K kernel, int smem, int T, int slices, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((T + kRows - 1) / kRows),
                  (unsigned)slices);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The two kernels of the family for In and Out, in slices of kDS.
template <typename In, typename Out>
struct Mma {
  static int slices(const Args& a) { return (a.D + kDS - 1) / kDS; }
  static cudaError_t dkdv(const Args& a, cudaStream_t s) {
    return launch(flash_bwd_dkdv_mma_kernel<In, Out>, dkdv_smem(), a.Tk,
                  slices(a), a, s);
  }
  static cudaError_t dq(const Args& a, cudaStream_t s) {
    return launch(flash_bwd_dq_mma_kernel<In, Out>, dq_smem(), a.Tq,
                  slices(a), a, s);
  }
};

// One kernel of the family for a's inputs, bf16 or fp16 (above head dim
// 256); outputs of the input type, or fp32 (out_f32).
template <template <typename, typename> class F>
cudaError_t mma_pick(const Args& a, cudaStream_t s) {
  if (a.Dr != a.D) return cudaErrorInvalidValue;
  switch (a.dtype) {
    case flash::kF16:
      return a.out_f32 ? F<__half, float>::run(a, s)
                       : F<__half, __half>::run(a, s);
    case flash::kBF16:
      return a.out_f32 ? F<__nv_bfloat16, float>::run(a, s)
                       : F<__nv_bfloat16, __nv_bfloat16>::run(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename In, typename Out>
struct DkdvMma {
  static cudaError_t run(const Args& a, cudaStream_t s) {
    return Mma<In, Out>::dkdv(a, s);
  }
};
template <typename In, typename Out>
struct DqMma {
  static cudaError_t run(const Args& a, cudaStream_t s) {
    return Mma<In, Out>::dq(a, s);
  }
};

cudaError_t dkdv_mma(const Args& a, cudaStream_t s) {
  return mma_pick<DkdvMma>(a, s);
}
cudaError_t dq_mma(const Args& a, cudaStream_t s) {
  return mma_pick<DqMma>(a, s);
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

// The largest head dim of the Hopper dk/dv and dq for bf16 and fp16
// (ops/kernels.py:SM90_BWD_MAX_DIM holds the same); fp32 and the forward
// have none.
constexpr int kBwdMaxD = 256;

// Checks the arguments every kernel relies on (the views' head dim Dr
// even and at least 2), sets the instance's head dim D (64, 128, or Dr
// rounded up to a multiple of 64: ops/kernels.py:_flash_dim), selects the
// device, and runs `sm90` (the Hopper kernels) for fp32 inputs and for
// bf16 and fp16 ones at D up to `max_d` (every D by default), else `mma`
// (the mma.sync family).
int run(int device, Args a, void* stream, Fn sm90, Fn mma,
        int max_d = INT_MAX) {
  if (a.Dr < 2 || a.Dr % 2 != 0) return (int)cudaErrorInvalidValue;
  a.D = a.Dr <= 64 ? 64 : a.Dr <= 128 ? 128 : (a.Dr + 63) / 64 * 64;
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.dtype != flash::kBF16 && a.dtype != flash::kF16 &&
      a.dtype != flash::kF32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool hopper = a.dtype == flash::kF32 || a.D <= max_d;
  return (int)(hopper ? sm90 : mma)(a, (cudaStream_t)stream);
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
// `strides` (host memory), in argument order. Dr is their head dim, even;
// the mma.sync family (bf16 and fp16 dk/dv and dq above 256) takes a
// multiple of 64 only (the wrapper pads other head dims with zeros).
// dtype: 0 bf16, 1 fp16, 2 fp32 (the inputs'). q and dout have Tq rows, k
// and v Tk. device:
// the CUDA ordinal of the tensors and stream.
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
  return run(device, a, stream, flash::fwd_sm90, nullptr);
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
  return run(device, a, stream, bwd_pre, bwd_pre);
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
  return run(device, a, stream, flash::bwd_dkdv_sm90, dkdv_mma, kBwdMaxD);
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
  return run(device, a, stream, flash::bwd_dq_sm90, dq_mma, kBwdMaxD);
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
  return run(device, a, stream, flash::fwd_sm90, nullptr);
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
  return run(device, a, stream, flash::bwd_dkdv_sm90, dkdv_mma, kBwdMaxD);
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
  return run(device, a, stream, flash::bwd_dq_sm90, dq_mma, kBwdMaxD);
}

}  // extern "C"
