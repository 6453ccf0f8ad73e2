// Flash attention backward, bf16 in, fp32 softmax statistics.
//
// Replaces the custom-VJP backward of the Pallas kernels that
// horovod_tpu/parallel/flash_attention.py:flash_attention_local takes from
// jax's library (_flash_attention_bwd_dkv, _flash_attention_bwd_dq). The
// forward is flash_fwd_sm90.cu, a TMA and wgmma kernel; these are the first
// Hopper versions, on the older tile code.
//
// What bounds them on an H100: operations. At the flagship shape (B4 H16
// T2048 D128, causal) dk/dv do 8*D and dq 6*D operations a (q, kv) pair,
// far above the card's 295 operations a byte. So the products run on the
// tensor cores, and S, P, dP and dS never go to device memory: O(T)
// memory, no T^2 buffer.
//
// Design (a first, simple Hopper version):
// - mma.sync m16n8k16, bf16 operands, fp32 accumulators. Each warp owns 16
//   rows of its block's tile; 4 warps a block. Tiles of Q, K, V, dO are
//   staged in shared memory with 16-byte loads (rows padded by 16 bytes so
//   the fragment loads hit 32 distinct banks). A fragments come from shared
//   memory as 32-bit pairs; B fragments that need the transpose (dO, Q and
//   K in the gradient products) are gathered as two 16-bit loads.
// - The score accumulators of two n-tiles are, element for element, the A
//   fragment of the next product, so P and dS go from registers to the
//   tensor cores after one bf16 rounding.
// - flash_bwd_pre: di = rowsum(dO * O), one warp per row.
// - flash_bwd_dkdv: one block per (b*h, 64-row kv tile), looping over
//   32-row q tiles from the diagonal on; recomputes p = exp(s*scale - lse)
//   and accumulates dV += P^T dO, dK += dS^T Q * scale in registers.
// - flash_bwd_dq: one block per (b*h, 64-row q tile), looping over 32-row
//   kv tiles up to the diagonal; dQ += dS K * scale. A separate pass means
//   no float atomics: results repeat bitwise.
// Causal: tiles past the diagonal are never loaded; the diagonal tile and
// the tail tile (T not a multiple of the tile) are masked, so any T >= 1
// runs. The backward takes lse and di from outside, so under a global lse
// it is ring attention's per-block backward as well.
//
// K7's backward, ring attention's per-segment kernels (horovod_tpu/
// parallel/ring_attention.py :_seg_bwd_pallas), are the same kernels
// instantiated with fp32 outputs (OutT = float): the ring adds block
// gradients over its hops in fp32, so dq, dk and dv leave the registers
// unrounded. Their lse and di are [B, H, S] views with B and H strides (the
// zig-zag halves of a [B, H, T] tensor). A segment is the aligned causal
// diagonal (DIAG, causal=1) or all-visible (FULL, causal=0).
// Not yet here (later work): TMA pipelining, wgmma and warp specialisation
// on the helpers of sm90.cuh, as the forward has them; fusing the ring's
// fp32 accumulation into the stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;   // bf16 elements of padding at the end of a row
constexpr float kLog2e = 1.4426950408889634f;

// A [B, H, T, D] view: base pointer and element strides of B, H and T (the
// D stride is 1).
template <typename T>
struct ViewT {
  const T* p;
  long long sb, sh, st;
};
typedef ViewT<bf16> View;
typedef ViewT<float> FView;

// A [B, H, T] fp32 statistic (lse, di): base pointer and the element
// strides of B and H (the T stride is 1).
struct Stat {
  float* p;
  long long sb, sh;
};

struct Params {
  View q, k, v, o, dout, dq, dk, dv;   // bf16 tensors (K6's outputs)
  FView dqf, dkf, dvf;                 // fp32 outputs (K7)
  Stat lse_in, di_in, di_out;
  int B, H, T, causal;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const ViewT<T>& t, int b,
                                             int h) {
  return t.p + (long long)b * t.sb + (long long)h * t.sh;
}

__device__ __forceinline__ float* stat_row(const Stat& s, int b, int h) {
  return s.p + (long long)b * s.sb + (long long)h * s.sh;
}

// The output view of the element type OutT: K6's bf16 one or K7's fp32 one.
template <typename OutT>
__device__ __forceinline__ const ViewT<OutT>& pick(const View& b,
                                                   const FView& f);
template <>
__device__ __forceinline__ const View& pick<bf16>(const View& b,
                                                  const FView&) {
  return b;
}
template <>
__device__ __forceinline__ const FView& pick<float>(const View&,
                                                    const FView& f) {
  return f;
}

__device__ __forceinline__ uint32_t ld32(const bf16* s) {
  return *reinterpret_cast<const uint32_t*>(s);
}

// Two bf16 from two places, the first in the low half.
__device__ __forceinline__ uint32_t ld2x16(const bf16* lo, const bf16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b, a 16x16 (row), b 16x8 (col), c 16x8, fp32 accumulate.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// rows [row0, row0 + ROWS) of one head into shared memory (row pitch
// D + kPad); rows at or past T are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* head,
                                          long long st, int row0, int T) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(head + (long long)(row0 + r) * st +
                                            c * 8);
    *reinterpret_cast<uint4*>(s + r * (D + kPad) + c * 8) = val;
  }
}

// A fragment of rows [r0, r0 + 16), cols [c0, c0 + 16) of a row-major tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int r0,
                                       int c0, int g, int tig) {
  const bf16* p = s + (r0 + g) * LD + c0 + tig * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// c[j] += A * B^T over D, B rows n0 + 8j .. (the "NT" product: S = Q K^T).
template <int D, int NT>
__device__ __forceinline__ void gemm_nt(float c[NT][4], const bf16* sa,
                                        int ra, const bf16* sb, int g,
                                        int tig) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a<LD>(a, sa, ra, kk * 16, g, tig);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* p = sb + (j * 8 + g) * LD + kk * 16 + tig * 2;
      mma(c[j], a, ld32(p), ld32(p + 8));
    }
  }
}

// acc[dj] += P * B over the KT = 16*KS rows of a tile B (row-major, D cols),
// P given as score accumulators p[2*KS][4] (rounded to bf16 here).
template <int D, int KS>
__device__ __forceinline__ void gemm_pv(float acc[D / 8][4],
                                        const float p[2 * KS][4],
                                        const bf16* sb, int g, int tig) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * ks][0], p[2 * ks][1]);
    a[1] = pack_bf16(p[2 * ks][2], p[2 * ks][3]);
    a[2] = pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    a[3] = pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
    const bf16* base = sb + (ks * 16 + tig * 2) * LD + g;
#pragma unroll
    for (int dj = 0; dj < D / 8; ++dj) {
      const bf16* p0 = base + dj * 8;
      mma(acc[dj], a, ld2x16(p0, p0 + LD), ld2x16(p0 + 8 * LD, p0 + 9 * LD));
    }
  }
}

// Two neighbouring output elements: rounded to one bf16 pair, or as fp32.
__device__ __forceinline__ void store2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

// rows r_lo = r0 + g and r_lo + 8 of a 16 x D accumulator, times mul[i],
// to the rows < T of one head of `out`.
template <int D, typename OutT>
__device__ __forceinline__ void store_rows(const ViewT<OutT>& out, int b,
                                           int h, int r_lo, int T,
                                           const float acc[D / 8][4],
                                           const float mul[2], int tig) {
  OutT* head = const_cast<OutT*>(head_ptr(out, b, h));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= T) continue;
    OutT* row = head + (long long)r * out.st;
#pragma unroll
    for (int dj = 0; dj < D / 8; ++dj) {
      store2(row + dj * 8 + tig * 2, acc[dj][2 * i] * mul[i],
             acc[dj][2 * i + 1] * mul[i]);
    }
  }
}

// di[row] = sum_d dO[row, d] * O[row, d]; one warp per row of B*H*T.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_pre_kernel(const Params p) {
  const long long rows = (long long)p.B * p.H * p.T;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / p.T;
  const int t = (int)(row % p.T), b = (int)(bh / p.H), h = (int)(bh % p.H);
  const bf16* orow = head_ptr(p.o, b, h) + (long long)t * p.o.st;
  const bf16* drow = head_ptr(p.dout, b, h) + (long long)t * p.dout.st;
  float acc = 0.f;
#pragma unroll
  for (int d = lane * 2; d < D; d += 64) {
    const float2 of = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(orow + d));
    const float2 df = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(drow + d));
    acc += of.x * df.x + of.y * df.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) stat_row(p.di_out, b, h)[t] = acc;
}

template <int D>
constexpr int dkdv_smem() {
  return (2 * 64 + 2 * 32) * (D + kPad) * 2 + 2 * 32 * 4;
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Params p) {
  constexpr int BKV = 64, BQ = 32, LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BKV * LD;
  bf16* qs = vs + BKV * LD;
  bf16* dos = qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);
  float* di_s = lse_s + BQ;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // causal: the first kv tiles see the most q tiles; they start first
  const int kv0 = blockIdx.y * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r_lo = kv0 + warp * 16 + g;   // kv rows of this thread
  const float sl2 = p.scale * kLog2e;
  const float* lse = stat_row(p.lse_in, b, h);
  const float* di = stat_row(p.di_in, b, h);

  load_tile<D, BKV>(ks, head_ptr(p.k, b, h), p.k.st, kv0, p.T);
  load_tile<D, BKV>(vs, head_ptr(p.v, b, h), p.v.st, kv0, p.T);
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);

  const int q_start = p.causal ? (kv0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < p.T; q0 += BQ) {
    __syncthreads();
    load_tile<D, BQ>(qs, head_ptr(p.q, b, h), p.q.st, q0, p.T);
    load_tile<D, BQ>(dos, head_ptr(p.dout, b, h), p.dout.st, q0, p.T);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < p.T ? lse[r] * kLog2e : 0.f;
      di_s[threadIdx.x] = r < p.T ? di[r] : 0.f;
    }
    __syncthreads();
    // P^T = exp(K Q^T * scale - lse), masked
    float pt[BQ / 8][4];
    zero(pt);
    gemm_nt<D, BQ / 8>(pt, ks, warp * 16, qs, g, tig);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1);
        const int c = j * 8 + tig * 2 + (e & 1);
        const int col = q0 + c;
        const bool ok = col < p.T && row < p.T && (!p.causal || col >= row);
        pt[j][e] = ok ? exp2f(pt[j][e] * sl2 - lse_s[c]) : 0.f;
      }
    }
    gemm_pv<D, BQ / 16>(dv, pt, dos, g, tig);
    // dP^T = V dO^T; dS^T = P^T * (dP^T - di)
    float dst[BQ / 8][4];
    zero(dst);
    gemm_nt<D, BQ / 8>(dst, vs, warp * 16, dos, g, tig);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tig * 2 + (e & 1);
        dst[j][e] = pt[j][e] * (dst[j][e] - di_s[c]);
      }
    }
    gemm_pv<D, BQ / 16>(dk, dst, qs, g, tig);
  }
  const float one[2] = {1.f, 1.f}, sc[2] = {p.scale, p.scale};
  store_rows<D>(pick<OutT>(p.dk, p.dkf), b, h, r_lo, p.T, dk, sc, tig);
  store_rows<D>(pick<OutT>(p.dv, p.dvf), b, h, r_lo, p.T, dv, one, tig);
}

template <int D>
constexpr int dq_smem() { return (2 * 64 + 2 * 32) * (D + kPad) * 2; }

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int BQ = 64, BKV = 32, LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BQ * LD;
  bf16* ks = dos + BQ * LD;
  bf16* vs = ks + BKV * LD;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r_lo = q0 + warp * 16 + g;
  const float sl2 = p.scale * kLog2e;
  const float* lse = stat_row(p.lse_in, b, h);
  const float* di = stat_row(p.di_in, b, h);
  float lse_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    lse_r[i] = r < p.T ? lse[r] * kLog2e : 0.f;
    di_r[i] = r < p.T ? di[r] : 0.f;
  }
  load_tile<D, BQ>(qs, head_ptr(p.q, b, h), p.q.st, q0, p.T);
  load_tile<D, BQ>(dos, head_ptr(p.dout, b, h), p.dout.st, q0, p.T);
  float dq[D / 8][4];
  zero(dq);

  const int kv_end = p.causal ? min(p.T, q0 + BQ) : p.T;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();
    load_tile<D, BKV>(ks, head_ptr(p.k, b, h), p.k.st, kv0, p.T);
    load_tile<D, BKV>(vs, head_ptr(p.v, b, h), p.v.st, kv0, p.T);
    __syncthreads();
    float s[BKV / 8][4], dp[BKV / 8][4];
    zero(s);
    zero(dp);
    gemm_nt<D, BKV / 8>(s, qs, warp * 16, ks, g, tig);
    gemm_nt<D, BKV / 8>(dp, dos, warp * 16, vs, g, tig);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, row = r_lo + 8 * i;
        const int col = kv0 + j * 8 + tig * 2 + (e & 1);
        const bool ok = col < p.T && row < p.T && (!p.causal || col <= row);
        const float pe = ok ? exp2f(s[j][e] * sl2 - lse_r[i]) : 0.f;
        s[j][e] = pe * (dp[j][e] - di_r[i]);   // dS
      }
    }
    gemm_pv<D, BKV / 16>(dq, s, ks, g, tig);
  }
  const float sc[2] = {p.scale, p.scale};
  store_rows<D>(pick<OutT>(p.dq, p.dqf), b, h, r_lo, p.T, dq, sc, tig);
}

template <typename T>
ViewT<T> view_of(const void* ptr, const long long* strides, int i) {
  return ViewT<T>{reinterpret_cast<const T*>(ptr), strides[3 * i],
                  strides[3 * i + 1], strides[3 * i + 2]};
}

View view(const void* ptr, const long long* strides, int i) {
  return view_of<bf16>(ptr, strides, i);
}

FView fview(const void* ptr, const long long* strides, int i) {
  return view_of<float>(ptr, strides, i);
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

// Opt a kernel into more than 48 KB of dynamic shared memory. The attribute
// belongs to the current device, so it is set at every launch: a process
// may launch on several cards, and the call costs little.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_pre(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.T;
  flash_bwd_pre_kernel<D>
      <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int launch_dkdv(const Params& p, cudaStream_t stream) {
  cudaError_t err =
      allow_smem(flash_bwd_dkdv_kernel<D, OutT>, dkdv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.T + 63) / 64));
  flash_bwd_dkdv_kernel<D, OutT>
      <<<grid, kThreads, dkdv_smem<D>(), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int launch_dq(const Params& p, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, OutT>, dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.T + 63) / 64));
  flash_bwd_dq_kernel<D, OutT><<<grid, kThreads, dq_smem<D>(), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int (*L64)(const Params&, cudaStream_t),
          int (*L128)(const Params&, cudaStream_t)>
int dispatch(int device, const Params& p, int D, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (p.B <= 0 || p.H <= 0 || p.T <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return D == 64 ? L64(p, (cudaStream_t)stream)
                 : L128(p, (cudaStream_t)stream);
}

Params base(int B, int H, int T, int causal, float scale) {
  Params p = {};
  p.B = B;
  p.H = H;
  p.T = T;
  p.causal = causal;
  p.scale = scale;
  return p;
}

// q, k, v (and dout) of a forward or backward launch: the first n views.
Params inputs(const void* q, const void* k, const void* v, const void* dout,
              const long long* strides, int B, int H, int T, int causal,
              float scale) {
  Params p = base(B, H, T, causal, scale);
  p.q = view(q, strides, 0);
  p.k = view(k, strides, 1);
  p.v = view(v, strides, 2);
  if (dout != nullptr) p.dout = view(dout, strides, 3);
  return p;
}

}  // namespace

extern "C" {

// Every bf16 tensor argument is a [B, H, T, D] view, D = 64 or 128
// contiguous, with the element strides of B, H and T given three by three
// in `strides` (host memory), in argument order. device: the CUDA ordinal
// of the tensors and stream.
//
// K6 (flash attention): outputs are bf16 views as well; lse and di are
// fp32 [B, H, T] contiguous. The forward, hvd_flash_fwd, is in
// flash_fwd_sm90.cu.

// di = rowsum(dout * o). strides: o, dout.
int hvd_flash_bwd_pre(int device, const void* o, const void* dout, float* di,
                      const long long* strides, int B, int H, int T, int D,
                      void* stream) {
  Params p = base(B, H, T, 0, 0.f);
  p.o = view(o, strides, 0);
  p.dout = view(dout, strides, 1);
  p.di_out = dense_stat(di, H, T);
  return dispatch<launch_pre<64>, launch_pre<128>>(device, p, D, stream);
}

// dk = ds^T q * scale, dv = p^T dout, p = exp(q k^T * scale - lse),
// ds = p * (dout v^T - di). strides: q, k, v, dout, dk, dv.
int hvd_flash_bwd_dkdv(int device, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* di, void* dk, void* dv,
                       const long long* strides, int B, int H, int T, int D,
                       int causal, float scale, void* stream) {
  Params p = inputs(q, k, v, dout, strides, B, H, T, causal, scale);
  p.dk = view(dk, strides, 4);
  p.dv = view(dv, strides, 5);
  p.lse_in = dense_stat(lse, H, T);
  p.di_in = dense_stat(di, H, T);
  return dispatch<launch_dkdv<64, bf16>, launch_dkdv<128, bf16>>(device, p, D,
                                                                 stream);
}

// dq = ds k * scale, ds as above. strides: q, k, v, dout, dq.
int hvd_flash_bwd_dq(int device, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* di,
                     void* dq, const long long* strides, int B, int H, int T,
                     int D, int causal, float scale, void* stream) {
  Params p = inputs(q, k, v, dout, strides, B, H, T, causal, scale);
  p.dq = view(dq, strides, 4);
  p.lse_in = dense_stat(lse, H, T);
  p.di_in = dense_stat(di, H, T);
  return dispatch<launch_dq<64, bf16>, launch_dq<128, bf16>>(device, p, D,
                                                             stream);
}

// K7 (ring attention's segments, T = the segment length S): the same
// functions with fp32 outputs, [B, H, S, D] views whose strides follow the
// bf16 inputs' in `strides`; lse and di are fp32 [B, H, S] views whose B and
// H strides come last in `strides`, two by two (their T stride is 1). The
// forward, hvd_flash_seg_fwd, is in flash_fwd_sm90.cu.

// (dk, dv) of one segment under the given lse and di.
// strides: q, k, v, dout, dk, dv; then lse, di.
int hvd_flash_seg_bwd_dkdv(int device, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* di, float* dk, float* dv,
                           const long long* strides, int B, int H, int T,
                           int D, int causal, float scale, void* stream) {
  Params p = inputs(q, k, v, dout, strides, B, H, T, causal, scale);
  p.dkf = fview(dk, strides, 4);
  p.dvf = fview(dv, strides, 5);
  p.lse_in = stat(lse, strides, 6, 0);
  p.di_in = stat(di, strides, 6, 1);
  return dispatch<launch_dkdv<64, float>, launch_dkdv<128, float>>(
      device, p, D, stream);
}

// dq of one segment under the given lse and di.
// strides: q, k, v, dout, dq; then lse, di.
int hvd_flash_seg_bwd_dq(int device, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* di, float* dq, const long long* strides,
                         int B, int H, int T, int D, int causal, float scale,
                         void* stream) {
  Params p = inputs(q, k, v, dout, strides, B, H, T, causal, scale);
  p.dqf = fview(dq, strides, 4);
  p.lse_in = stat(lse, strides, 5, 0);
  p.di_in = stat(di, strides, 5, 1);
  return dispatch<launch_dq<64, float>, launch_dq<128, float>>(device, p, D,
                                                               stream);
}

}  // extern "C"
