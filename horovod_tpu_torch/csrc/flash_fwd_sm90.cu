// Flash attention forward for Hopper: K6a (flash attention, o in the input
// type) and K7a (ring attention's segment, fp32 o), one kernel, for bf16 or
// fp16 inputs (In), and a kernel of its own for fp32 inputs on tf32 (the
// last part of this header).
//
// Replaces the forward Pallas kernels that horovod_tpu/parallel/
// flash_attention.py:flash_attention_local takes from jax's library
// (flash_attention / splash_attention forward) and horovod_tpu/parallel/
// ring_attention.py:_seg_fwd_pallas: o = softmax(q k^T * scale) v and
// lse = logsumexp(q k^T * scale), fp32 softmax statistics, p rounded to
// In before the PV product (the reference casts p to v.dtype). q has Tq
// rows and k, v Tk; causal is the library kernel's rule, key <= query by
// absolute index.
//
// What bounds it on an H100: operations. At the flagship shape (B4 H16
// T2048 D128, causal) it does 69 GFLOP on 24 MB of input, some 2,900
// operations a byte against the card's 295, so the work is the tensor
// cores' and the design is about keeping them fed:
// - Block = 3 warpgroups, one block an SM. Warpgroup 0 is the producer
//   (setmaxnreg 24): one of its threads issues TMA loads, the block's
//   128-row Q tile once, then K and V tiles of 96 rows into rings of 2
//   slots each (4 at D 64) on full/empty mbarriers, K one tile ahead of V,
//   each slot refilled as soon as both consumers release it. Warpgroups 1
//   and 2 are consumers (setmaxnreg 240), 64 q rows each, unsynchronised,
//   so one's softmax also overlaps the other's products.
// - A consumer computes S = Q K^T with wgmma from shared memory (m64n96k16,
//   both operands K-major) and O += P V with wgmma taking P from registers
//   and V as an MN-major B (m64nDk16). The two products of consecutive
//   tiles overlap the softmax: S_i and P_{i-1} V_{i-1} are issued together,
//   the online softmax of S_i (log2 units, fp32) runs while the second is
//   in flight, then O is rescaled and P_i rounded pairwise to In in place
//   (the accumulator layout is the register-A layout). O, m and l stay in
//   registers; S and P never leave them.
// - Why 96 kv rows: during the overlap a consumer thread holds S (48
//   registers), O (D/2) and P (24) at once. ptxas kept the consumers within
//   the kernel's 168 registers whatever setmaxnreg allowed, and with 128-row
//   tiles (S 64, P 32) the overlap spilled and ran slower than no overlap;
//   96 rows fit with no spill.
// - TMA zero-fills rows past Tq or Tk, so any lengths >= 1 run; only a
//   tile that crosses the causal diagonal or Tk runs the per-element mask.
//   Causal
//   tiles past the diagonal are never loaded, and blocks start with the
//   longest rows so the last wave is short.
// - A head dim below the instance's (16 or 80 on the D 64 or 128 one, 160
//   on 192, 288 on 320: FwdParams::d) is read in place: the tensor maps'
//   inner dimension is the views' own, and TMA fills the columns past it
//   with zeros, which change neither S nor the softmax; the epilogue stores
//   the views' columns only. No zero-padded copy is made.
// - The epilogue divides by l and stores o (In or fp32) and lse from
//   registers, rows < Tq only. A row that sees no key writes o = 0 and
//   lse = -1e30, a finite sentinel the ring's merge needs.
// - Head dims 192, 256 and 320 (Tiles<D>): the same kernel, S over the
//   whole depth once. What decides the tiles is registers: ptxas allocates
//   a wgmma consumer's accumulators within the launch's count whatever
//   setmaxnreg asks (it starts every accumulator at R24 and, short of
//   room, spills O around S), and a block of more than 8 warps launches
//   with at most 168 a thread (3 warps on one of the SM's 4 register
//   files of 16K). At D 192 O is 96 registers: two consumers, kv tiles of
//   48 rows (S 24, P 12) in a ring of 4. At D 256 O alone is 128: one
//   consumer in a block of 256 threads, which launches with 255 registers
//   a thread (it uses about 200), 64 q rows a block and kv tiles of 64 (Q
//   32 KB, two K and two V slots 128 KB of shared memory). D 320 is laid
//   out as D 256 (O 160, S 32, P 16; Q 40 KB, the ring 160 KB), but
//   wgmma's N is at most 256: O += P V is two products over the same P
//   operands, O's first 192 columns and its last 128, each a whole number
//   of 64-column slabs of V (issue_pv). O stays one array in the layout
//   of a 320-column accumulator, so the rescale and the epilogue are
//   those of every other D.
// - Head dims 384 and 512: O's columns are split over blocks
//   (Tiles<D>::kOut, the groups along blockIdx.x beside (b, h)). A block
//   loads Q and the K tiles at the whole depth and computes S and the same
//   online softmax as every other group of its rows, but loads V and holds
//   O for its group only: 192 columns at D 384 (two groups; the D 192
//   forward's O of 96 registers), 256 at 512 (the D 256 forward's 128).
//   So the register picture is that of D 192 and 256 in a block of 256
//   threads (255 registers at launch), and no group needs more than
//   wgmma's N of 256. The price is S once a group: 1.5 times the products
//   of D 384 with one group, 2 times at 512. Shared memory decides the kv
//   tile: Q (128 D bytes), two K slots (kBK D 2 bytes each) and two V
//   slots (kBK kOut 2) fit 227 KB with kBK 64 at D 384 (197,888 bytes)
//   and 48 at 512 (214,272). Head dims 385 to 512 run on the 512 instance,
//   the columns past theirs read as zeros (a box may lie wholly past
//   them). Every group computes the same m and l: only the first writes
//   lse.
// - Head dims above 512 (Deep<kOut>, flash_fwd_sm90_kernel_deep): one
//   instance for every such D, S streamed over the depth. A Q tile and two
//   whole-depth K slots no longer fit beside V at D 576 (Q, two K and two V
//   slots: about 221 KB of 227), so S = sum_c Q_c K_c^T is summed over the
//   64-column slabs c of the depth, ceil(D / 64) of them, a run-time loop:
//   four m64n64k16 products a slab into the same accumulator, one commit
//   group a slab. K comes through a TMA ring of 4 slab slots (64 kv rows x
//   64 columns, 8 KB each), a slot released to the producer once the group
//   that read it has retired (one group stays in flight behind the next
//   slab's); so K's shared memory does not depend on D. Q stays resident
//   (TMA-loaded once, 64 rows x D) while it fits beside the ring and the
//   two V slots: up to 18 slabs (D 1152) at kOut 192, 16 (D 1024) at 256.
//   Above that Q streams through the same ring, a slot holding K_c and Q_c
//   together (re-read from L2 for every kv tile). O's columns are split
//   over blocks as at 384 and 512, in groups of kOut = 192 or 256 (the
//   fewest groups, then the narrower width: D 576 is 3 x 192, 640 to 1024
//   are 256s), so the register picture is that of the D 192 or D 256
//   forward in a block of 256 threads (255 registers at launch): O (96 or
//   128), S (32), P (16). The last group may be partial: V's columns past
//   D read as zeros (a box may lie wholly past them), and only the views'
//   columns are stored. The kv tile's products overlap its softmax as
//   elsewhere: S_i's slabs, then P_{i-1} V_{i-1}, whose product runs
//   while the softmax of S_i does.
// - fp32 inputs (Tf32<kOut>, flash_fwd_sm90_tf32_kernel<kOut>, o fp32 for
//   K6a and K7a alike): wgmma on tf32, m64nNk8, the plain version's
//   arithmetic under tf32 products (every operand rounded to nearest,
//   fp32 sums). What differs from 16 bits, and the answers:
//   * tf32 operands are K-major only. S = Q K^T is K-major on both sides,
//     but P V contracts over kv and V is stored kv-major (MN-major). The
//     wrapper could transpose V (a launch, Tk D 8 bytes and host time a
//     call, on paths the host already limits); instead the producer
//     warpgroup does it: warp 0 issues every TMA load, warps 1-3 (96
//     "converter" threads, sm90.cuh) take each 64 x 32 slab of V from a
//     staging slot (2 of them) and write it transposed into a V^T slot (2
//     of them, kOut rows by 64 kv), 128-byte swizzled as TMA would have,
//     16 bytes a store with no bank conflict (sm90::transpose_tf32).
//   * P as the register A operand: a tf32 A fragment holds columns t and
//     t + 4 of an 8-column step, the accumulator 2t and 2t + 1. V^T's
//     rows take each group of 8 kv in the order 0 2 4 6 1 3 5 7, so S's
//     accumulator is the A operand as it lies (sm90::to_operand_tf32), no
//     shuffle; the same transpose writes that order at no cost.
//   * Rounding: TMA puts raw fp32 into shared memory, and wgmma does not
//     round an fp32 operand to nearest as it reads it as tf32. The
//     converters round Q (once), each K slab and V^T with cvt.rna before
//     the consumer may read them (a proxy fence, then an arrival on a
//     barrier of 96), and P is rounded as it becomes the operand: every
//     product the kernel forms is one the plain version forms under
//     tf32, so its error stays the plain version's, whatever D.
//   * Shared memory: an fp32 slab of 128 bytes is 32 columns, and a tile
//     twice the bytes of a 16-bit one. So the deep forward's structure is
//     taken at every D: S is summed over the depth's slabs of 32 columns
//     through a ring of up to 8 slots of 64 kv rows (8 KB each), Q
//     resident while 4 slots fit beside it (up to D 448 at kOut 128, 96 at
//     64) and streamed beside K above that, and O's columns in groups of
//     kOut: 64 at head dims up to 64, 128 above (D 256: 2 groups).
//   * Registers: P as tf32 is one register an element: O (kOut / 2), S
//     (32) and P (32) at kv tiles of 64. At kOut 128 that is 128 beside
//     the loop's state, in a block of 256 threads (255 registers at
//     launch); at kOut 64, 96, and the block is launched for two a SM
//     (128 registers a thread), which ViT_Tiny's small blocks need. ptxas:
//     154 and 122 registers, no spill.
//   The consumer is the 16-bit one (consume), its operand and PV issue
//   chosen by the input type.
// The arithmetic does not depend on the views' strides and nothing is
// accumulated across blocks: strided views and contiguous copies give the
// same bits, and runs repeat bitwise.
// Not yet here (later work): ping-pong scheduling of the consumers' turns
// (tried: no faster than this), a persistent tile scheduler, a TMA store
// epilogue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash.cuh"
#include "sm90.cuh"

namespace {

using flash::Args;

// What the kernel reads of Args, packed: its parameter. Measured on an
// H100: with Args itself as the parameter and q0 from gridDim.y, ptxas
// scheduled the consumers' main loop with more integer work and K7a ran
// about 4% slower.
struct FwdParams {
  flash::View o;
  flash::Stat lse;
  int H, Tq, Tk, causal, n_qt;
  int d;         // the views' head dim: o's columns from d on are not stored
  float scale;
};

constexpr int kSlab = 64;     // 16-bit columns of a 128-byte swizzled slab
constexpr int kCols32 = 32;   // fp32 columns of a 128-byte swizzled slab
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;   // the lse of a row that sees no key

template <int D>
struct Tiles {
  // the columns of O a block holds: all of them up to D 320, above it a
  // group of 192 (D 384) or 256 (512) of kGroups (see the header)
  static constexpr int kOut = D <= 320 ? D : D == 384 ? 192 : 256;
  static constexpr int kGroups = (D + kOut - 1) / kOut;
  // consumer warpgroups of a block, 64 q rows each: 2, or 1 from D 256 on
  // (its O alone is 128 registers or more: see the header)
  static constexpr int kConsumers = D >= 256 ? 1 : 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBQ = 64 * kConsumers;     // q rows of a block
  // kv rows of a K or V tile
  static constexpr int kBK = D == 192 || D == 512 ? 48 : D >= 256 ? 64 : 96;
  // ring slots of K and of V (3 at D 128 ran no faster than 2)
  static constexpr int kStages = D == 64 || D == 192 ? 4 : 2;
  static constexpr int kQElems = kBQ * D;         // the Q tile
  static constexpr int kKElems = kBK * D;         // a K tile
  static constexpr int kVElems = kBK * kOut;      // a V tile: kOut columns
  // the tiles, their barriers, and room to align the base to 1024 bytes
  static constexpr int kSmem =
      (kQElems + kStages * (kKElems + kVElems)) * 2 + 256 + 1024;
  static_assert(kOut % 64 == 0 && kGroups * kOut == D, "whole slabs of O");
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// Above head dim 512: O's columns in groups of kOut (192 or 256), S summed
// over the depth's slabs through a ring (see the header). Any D: the
// number of slabs, and whether Q streams, are run-time values.
template <int kOut_>
struct Deep {
  static constexpr int kOut = kOut_;
  static constexpr int kThreads = 256;   // a producer and one consumer
  static constexpr int kBQ = 64, kBK = 64;
  static constexpr int kSlots = 4;       // ring slots of slabs
  static constexpr int kSlabElems = 64 * kSlab;   // 64 rows of one slab
  static constexpr int kVStages = 2;
  static constexpr int kVElems = kBK * kOut;      // a V tile
  // the V ring, the barriers, and room to align the base to 1024 bytes
  static constexpr int kFixed = kVStages * kVElems * 2 + 256 + 1024;
  // the most slabs of a resident Q beside the ring of K slabs
  static constexpr int kMaxResident =
      (232448 - kFixed - kSlots * kSlabElems * 2) / (kSlabElems * 2);
  // a ring slot: K_c, and Q_c beside it where Q streams
  __host__ __device__ static int slot_elems(bool stream_q) {
    return (stream_q ? 2 : 1) * kSlabElems;
  }
  static int smem(int n_slab) {
    const bool stream_q = n_slab > kMaxResident;
    return kFixed +
           (kSlots * slot_elems(stream_q) + (stream_q ? 0 : n_slab * kSlabElems)) *
               2;
  }
};

// Two neighbouring output elements: a pair of In, or two floats.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = sm90::pack2<T>(lo, hi);
}
template <>
__device__ __forceinline__ void store2<float>(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

struct Barriers {
  uint64_t* q_full;
  // a ring slot of K or V: filled by TMA (1 arrival and the tile's
  // bytes), emptied by the consumers (an arrival from each thread)
  uint64_t* k_full;
  uint64_t* k_empty;
  uint64_t* v_full;
  uint64_t* v_empty;
};

// The i-th K or V tile (kv rows i * kBK .., kCols columns from col0) into
// its slot of a ring of kStages, once the consumers have emptied the slot's
// previous tile.
template <int kBK, int kStages, int kCols, typename In>
__device__ __forceinline__ void load_kv(const CUtensorMap* map, In* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int i, int col0, int b, int h) {
  const int st = i % kStages;
  sm90::mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
  sm90::mbar_arrive_expect_tx(full + st, kBK * kCols * 2);
  In* dst = ring + st * kBK * kCols;
#pragma unroll
  for (int s = 0; s < kCols / kSlab; ++s)
    sm90::tma_load_4d(dst + s * kBK * kSlab, map, full + st,
                      col0 + s * kSlab, i * kBK, h, b);
}

// Warpgroup 0, one thread: Q once, then the kv tiles, K one tile ahead of
// V (the block's kOut columns from col0), in the order the consumers take
// them.
template <int D, typename In>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, In* qs,
                                        In* ks, In* vs,
                                        const Barriers& bar, int b, int h,
                                        int q0, int n_kv, int col0) {
  using C = Tiles<D>;
  sm90::prefetch_tensor_map(tq);
  sm90::prefetch_tensor_map(tk);
  sm90::prefetch_tensor_map(tv);
  sm90::mbar_arrive_expect_tx(bar.q_full, C::kQElems * 2);
#pragma unroll
  for (int s = 0; s < D / kSlab; ++s)
    sm90::tma_load_4d(qs + s * C::kBQ * kSlab, tq, bar.q_full, s * kSlab, q0,
                      h, b);
  constexpr int kOut = C::kOut;
  constexpr int kBK = C::kBK, kStages = C::kStages;
  for (int i = 0; i < n_kv; ++i) {
    load_kv<kBK, kStages, D>(tk, ks, bar.k_full, bar.k_empty, i, 0, b, h);
    if (i > 0)
      load_kv<kBK, kStages, kOut>(tv, vs, bar.v_full, bar.v_empty, i - 1,
                                  col0, b, h);
  }
  load_kv<kBK, kStages, kOut>(tv, vs, bar.v_full, bar.v_empty, n_kv - 1,
                              col0, b, h);
}

// Scale a score tile into log2 units, masking what the row may not see
// (columns at or past Tk; causal: past the row) to -inf, and return the
// tile's running max of the thread's two rows.
template <bool kMask, int N>
__device__ __forceinline__ void scale_mask(float (&s)[N], float sl2,
                                           int kv0, int r_lo, int t, int Tk,
                                           int causal, float (&mt)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = s[i] * sl2;
    if (kMask) {
      const int col = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int row = r_lo + 8 * ((i / 2) & 1);
      if (col >= Tk || (causal && col > row)) x = -INFINITY;
    }
    s[i] = x;
    mt[(i / 2) & 1] = fmaxf(mt[(i / 2) & 1], x);
  }
}

// The online softmax of one score tile, in place: s becomes
// p = exp2(s * scale * log2(e) - m_new), m the new running max of the
// thread's two rows; alpha[i] = exp2(m_old - m_new) rescales what was
// summed before, rs[i] is the new p's sum over this thread's columns. Only
// a tile that crosses Tk or the diagonal runs the per-element mask.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N],
                                               float (&m)[2],
                                               float (&alpha)[2],
                                               float (&rs)[2], bool mask,
                                               float sl2, int kv0, int r_lo,
                                               int t, int Tk, int causal) {
  float mt[2] = {-INFINITY, -INFINITY};
  if (mask)
    scale_mask<true>(s, sl2, kv0, r_lo, t, Tk, causal, mt);
  else
    scale_mask<false>(s, sl2, kv0, r_lo, t, Tk, causal, mt);
  float msub[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    const float mnew = fmaxf(m[i], mt[i]);
    // nothing seen yet in this row: nothing to rescale
    alpha[i] = mnew == -INFINITY ? 1.f : exp2f(m[i] - mnew);
    msub[i] = mnew == -INFINITY ? 0.f : mnew;
    m[i] = mnew;
    rs[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = exp2f(s[i] - msub[(i / 2) & 1]);
    rs[(i / 2) & 1] += s[i];
  }
}

// S = Q K^T over D (D/16 steps, 4 a slab), issued and committed.
template <int D, typename In>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<D>::kBK / 2],
                                         const In* qw, const In* kt) {
  constexpr int kBK = Tiles<D>::kBK, kBQ = Tiles<D>::kBQ;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int slab = kk / 4, col = (kk % 4) * 16;
    sm90::Wgmma<kBK, In>::template ss<0, 0>(
        s, sm90::desc_k_major(qw + slab * kBQ * kSlab + col),
        sm90::desc_k_major(kt + slab * kBK * kSlab + col), kk > 0);
  }
  sm90::wgmma_commit();
}

// O += P V over one V tile (kBK/16 steps of 16 kv rows, 2 KB of a slab),
// issued and committed, O and V the block's kN columns. wgmma's N is at
// most 256: above it (D 320), O is two accumulators in one array, its
// first kN0 columns and the rest, each product over the same P operand and
// its own slabs of V.
template <int kN, int kBK, typename In>
__device__ __forceinline__ void issue_pv(float (&o)[kN / 2],
                                         uint32_t (&pa)[kBK / 16][4],
                                         const In* vt) {
  constexpr int kN0 = kN > 256 ? 192 : kN;
  auto& o0 = *reinterpret_cast<float(*)[kN0 / 2]>(o);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    sm90::Wgmma<kN0, In>::template rs<1>(
        o0, pa[kk], sm90::desc_mn_major(vt + kk * 16 * kSlab, kBK * kSlab * 2),
        1);
    if constexpr (kN > kN0) {
      auto& o1 = *reinterpret_cast<float(*)[(kN - kN0) / 2]>(o + kN0 / 2);
      sm90::Wgmma<kN - kN0, In>::template rs<1>(
          o1, pa[kk],
          sm90::desc_mn_major(vt + (kN0 / kSlab * kBK + kk * 16) * kSlab,
                              kBK * kSlab * 2),
          1);
    }
  }
  sm90::wgmma_commit();
}

// tf32 (fp32 inputs): O += P V over one V^T tile, V^T the block's kN
// columns of O as rows of kBK kv values (K-major, slabs of 32, the depth
// of each group of 8 in to_operand_tf32's order), issued and committed.
// kN is at most 128 (Tf32<kOut>).
template <int kN, int kBK>
__device__ __forceinline__ void issue_pv_tf32(float (&o)[kN / 2],
                                              uint32_t (&pa)[kBK / 8][4],
                                              const float* vt) {
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk)
    sm90::Wgmma<kN, float>::template rs<0>(
        o, pa[kk],
        sm90::desc_k_major(vt + (kk / 4) * kN * kCols32 + (kk % 4) * 8), 1);
  sm90::wgmma_commit();
}

// P (the softmax's tile, in the accumulator) as the A operands of P V:
// pairs of In, or tf32 values in the tf32 kernels' depth order.
template <typename In, int N, int K>
__device__ __forceinline__ void p_operand(const float (&s)[N],
                                          uint32_t (&pa)[K][4]) {
  if constexpr (sm90::kStep<In> == 8)
    sm90::to_operand_tf32(s, pa);
  else
    sm90::to_operand<In>(s, pa);
}

// O += P V of one tile: issue_pv, or issue_pv_tf32 for fp32 inputs.
template <int kN, int kBK, typename In, int K>
__device__ __forceinline__ void issue_p_v(float (&o)[kN / 2],
                                          uint32_t (&pa)[K][4],
                                          const In* vt) {
  if constexpr (sm90::kStep<In> == 8)
    issue_pv_tf32<kN, kBK>(o, pa, vt);
  else
    issue_pv<kN, kBK>(o, pa, vt);
}

template <int kN, int kK>
__device__ __forceinline__ void fence_pv(float (&o)[kN], uint32_t (&pa)[kK][4]) {
  sm90::fence_regs(o);
  sm90::fence_regs(pa);
}

// The epilogue of a consumer: o = O / l, the block's kOut columns from
// col0 (those below the views' d), and, from the first group, lse; rows
// below Tq. l is this thread's partial row sums.
template <int kOut, typename OutT>
__device__ __forceinline__ void store_out(const FwdParams& p,
                                          const float (&o)[kOut / 2],
                                          const float (&m)[2], float (&l)[2],
                                          int b, int h, int r_lo, int t,
                                          int col0) {
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    // a row that saw no key: o = 0, lse = the finite sentinel
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  OutT* head = reinterpret_cast<OutT*>(p.o.p) + b * p.o.sb + h * p.o.sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= p.Tq) continue;
    OutT* row = head + r * p.o.st;
#pragma unroll
    for (int j = 0; j < kOut / 8; ++j) {
      const int c = col0 + 8 * j + 2 * t;
      if (c < p.d)   // the views' columns only
        store2(row + c, o[4 * j + 2 * i] * inv[i],
               o[4 * j + 2 * i + 1] * inv[i]);
    }
  }
  if (t == 0 && col0 == 0) {
    float* lse = p.lse.p + b * p.lse.sb + h * p.lse.sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      if (r < p.Tq) lse[r] = l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : kNegInf;
    }
  }
}

// A consumer warpgroup: 64 q rows from qw0, every kv tile of the block. The
// products of one tile overlap the softmax of the next: S_i = Q K_i^T and
// O += P_{i-1} V_{i-1} are issued together, the softmax of S_i runs while
// the second is in flight, and O is rescaled and P_i formed after it. Each
// tile's arithmetic, and its order, are those of the plain online softmax.
// The first tile is peeled off, so no product is issued under a branch.
// O is the block's kOut columns from col0, V a ring of kVStages slots.
// After q_full, issue_s(s, i) waits for tile i's K (and a streamed Q),
// fences and issues the products of S_i = Q K_i^T into s, committed;
// release_s(i) gives back the shared memory they read, once they have
// retired. (q_full is waited for here, not before the call: there, ptxas
// scheduled the D 512 instance otherwise, and it ran 2% slower.)
template <int kOut, int kBK, int kVStages, typename In, typename OutT,
          typename IssueS, typename ReleaseS>
__device__ __forceinline__ void consume(const FwdParams& p, const In* vs,
                                        const Barriers& bar, int b, int h,
                                        int qw0, int n_kv, int col0,
                                        IssueS issue_s, ReleaseS release_s) {
  constexpr int kVElems = kBK * kOut;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = qw0 + 16 * warp + g;    // this thread's rows: r_lo, +8
  const float sl2 = p.scale * kLog2e;
  // a tile needs the mask if it crosses Tk or, causal, the diagonal
  auto mask = [&](int kv0) {
    return kv0 + kBK > p.Tk || (p.causal && kv0 + kBK - 1 > qw0);
  };

  float o[kOut / 2];
#pragma unroll
  for (int i = 0; i < kOut / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2], alpha[2];
  float s[kBK / 2];
  uint32_t pa[kBK / sm90::kStep<In>][4];   // P of the tile whose PV is next

  sm90::mbar_wait(bar.q_full, 0);
  issue_s(s, 0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  release_s(0);
  online_softmax(s, m, alpha, l, mask(0), sl2, 0, r_lo, t, p.Tk, p.causal);
  p_operand<In>(s, pa);

  for (int it = 1; it < n_kv; ++it) {
    const int prev = (it - 1) % kVStages;
    const int kv0 = it * kBK;
    issue_s(s, it);
    sm90::mbar_wait(bar.v_full + prev, ((it - 1) / kVStages) & 1);
    issue_p_v<kOut, kBK>(o, pa, vs + prev * kVElems);
    sm90::wgmma_wait<1>();      // S_i is done; P_{i-1} V_{i-1} may not be
    sm90::fence_regs(s);
    release_s(it);
    float rs[2];
    online_softmax(s, m, alpha, rs, mask(kv0), sl2, kv0, r_lo, t, p.Tk,
                   p.causal);
    sm90::wgmma_wait<0>();
    fence_pv(o, pa);
    sm90::mbar_arrive(bar.v_empty + prev);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int i = 0; i < kOut / 2; ++i) o[i] *= alpha[(i / 2) & 1];
    p_operand<In>(s, pa);
  }
  const int last = (n_kv - 1) % kVStages;
  sm90::mbar_wait(bar.v_full + last, ((n_kv - 1) / kVStages) & 1);
  sm90::wgmma_fence();
  issue_p_v<kOut, kBK>(o, pa, vs + last * kVElems);
  sm90::wgmma_wait<0>();
  fence_pv(o, pa);
  sm90::mbar_arrive(bar.v_empty + last);

  store_out<kOut, OutT>(p, o, m, l, b, h, r_lo, t, col0);
}

// The shared memory of a kernel, its base aligned to the 1024-byte atoms
// the swizzle is anchored to.
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
}

template <int D, typename In, typename OutT>
__global__ void __launch_bounds__(Tiles<D>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const FwdParams p) {
  using C = Tiles<D>;
  In* qs = reinterpret_cast<In*>(smem_base());
  In* ks = qs + C::kQElems;
  In* vs = ks + C::kStages * C::kKElems;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + C::kStages * C::kVElems);
  const Barriers bar{bars, bars + 1, bars + 1 + C::kStages,
                     bars + 1 + 2 * C::kStages, bars + 1 + 3 * C::kStages};

  const int bh = blockIdx.x / C::kGroups, b = bh / p.H, h = bh % p.H;
  // the first of the block's group of O's columns (and V's)
  const int col0 = blockIdx.x % C::kGroups * C::kOut;
  // causal: the longest rows first, so the last wave is short
  const int q0 = (p.n_qt - 1 - blockIdx.y) * C::kBQ;
  const int kv_end = p.causal ? min(p.Tk, q0 + C::kBQ) : p.Tk;
  const int n_kv = (kv_end + C::kBK - 1) / C::kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(bar.k_full + s, 1);
      sm90::mbar_init(bar.k_empty + s, 128 * C::kConsumers);
      sm90::mbar_init(bar.v_full + s, 1);
      sm90::mbar_init(bar.v_empty + s, 128 * C::kConsumers);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // one consumer has the launch's registers; two take the producer's
  if (threadIdx.x < 128) {
    if constexpr (C::kConsumers == 2) sm90::reg_dealloc<24>();
    if (threadIdx.x == 0)
      produce<D>(&tq, &tk, &tv, qs, ks, vs, bar, b, h, q0, n_kv, col0);
  } else {
    if constexpr (C::kConsumers == 2) sm90::reg_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    // this warpgroup's 64 rows of each Q slab
    const In* qw = qs + wg * 64 * kSlab;
    auto issue_s = [&](float(&s)[C::kBK / 2], int it) {
      const int st = it % C::kStages;
      sm90::mbar_wait(bar.k_full + st, (it / C::kStages) & 1);
      sm90::wgmma_fence();
      issue_qk<D>(s, qw, ks + st * C::kKElems);
    };
    auto release_s = [&](int it) {
      sm90::mbar_arrive(bar.k_empty + it % C::kStages);
    };
    consume<C::kOut, C::kBK, C::kStages, In, OutT>(
        p, vs, bar, b, h, q0 + 64 * wg, n_kv, col0, issue_s, release_s);
  }
}

// Above head dim 512. The producer thread: Q once where it stays resident,
// then for each kv tile its ceil(D / 64) slabs of K (with Q's beside them
// where Q streams) into the ring, then the tile's V (the block's kOut
// columns from col0), in the order the consumer takes them.
template <int kOut, typename In>
__device__ __forceinline__ void produce_deep(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    In* qs, In* ring, In* vs, const Barriers& bar, int b, int h, int q0,
    int n_kv, int col0, int n_slab, bool stream_q) {
  using C = Deep<kOut>;
  sm90::prefetch_tensor_map(tq);
  sm90::prefetch_tensor_map(tk);
  sm90::prefetch_tensor_map(tv);
  // a streamed Q completes q_full with no bytes
  sm90::mbar_arrive_expect_tx(bar.q_full,
                              stream_q ? 0 : n_slab * C::kSlabElems * 2);
  if (!stream_q) {
    for (int c = 0; c < n_slab; ++c)
      sm90::tma_load_4d(qs + c * C::kSlabElems, tq, bar.q_full, c * kSlab,
                        q0, h, b);
  }
  const int slot = C::slot_elems(stream_q);
  int j = 0;   // slabs put into the ring
  for (int i = 0; i < n_kv; ++i) {
    for (int c = 0; c < n_slab; ++c, ++j) {
      const int st = j % C::kSlots;
      sm90::mbar_wait(bar.k_empty + st, ((j / C::kSlots) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(bar.k_full + st, slot * 2);
      In* dst = ring + st * slot;
      sm90::tma_load_4d(dst, tk, bar.k_full + st, c * kSlab, i * C::kBK, h,
                        b);
      if (stream_q)
        sm90::tma_load_4d(dst + C::kSlabElems, tq, bar.k_full + st,
                          c * kSlab, q0, h, b);
    }
    load_kv<C::kBK, C::kVStages, kOut>(tv, vs, bar.v_full, bar.v_empty, i,
                                       col0, b, h);
  }
}

// S = Q K^T of one kv tile over the depth, a commit group of four products
// a slab, into the same accumulator. Each slab's ring slot is released
// once the group that read it has retired, while the next slab's is in
// flight; the last slab's group may still be in flight on return, its slot
// not released. j counts the slabs taken from the ring.
template <int kOut, typename In>
__device__ __forceinline__ void issue_s_deep(float (&s)[Deep<kOut>::kBK / 2],
                                             const In* qs, const In* ring,
                                             const Barriers& bar, int n_slab,
                                             bool stream_q, int& j) {
  using C = Deep<kOut>;
  const int slot = C::slot_elems(stream_q);
  // slab c's four products, issued and committed; the first slab's start
  // the sum
  auto slab = [&](int c, bool first) {
    const int st = j % C::kSlots;
    sm90::mbar_wait(bar.k_full + st, (j / C::kSlots) & 1);
    const In* kt = ring + st * slot;
    const In* qt = stream_q ? kt + C::kSlabElems : qs + c * C::kSlabElems;
#pragma unroll
    for (int kk = 0; kk < kSlab / 16; ++kk)
      sm90::Wgmma<C::kBK, In>::template ss<0, 0>(
          s, sm90::desc_k_major(qt + kk * 16),
          sm90::desc_k_major(kt + kk * 16), !first || kk > 0);
    sm90::wgmma_commit();
    ++j;
  };
  slab(0, true);
  for (int c = 1; c < n_slab; ++c) {
    slab(c, false);
    sm90::wgmma_wait<1>();   // slab c - 1's products have retired
    sm90::mbar_arrive(bar.k_empty + (j - 2) % C::kSlots);
  }
}

template <int kOut, typename In, typename OutT>
__global__ void __launch_bounds__(Deep<kOut>::kThreads, 1)
flash_fwd_sm90_kernel_deep(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const FwdParams p) {
  using C = Deep<kOut>;
  const int n_slab = (p.d + kSlab - 1) / kSlab;
  const bool stream_q = n_slab > C::kMaxResident;
  In* vs = reinterpret_cast<In*>(smem_base());
  In* ring = vs + C::kVStages * C::kVElems;
  In* qs = ring + C::kSlots * C::slot_elems(stream_q);   // a resident Q
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      qs + (stream_q ? 0 : n_slab * C::kSlabElems));
  const Barriers bar{bars, bars + 1, bars + 1 + C::kSlots,
                     bars + 1 + 2 * C::kSlots,
                     bars + 1 + 2 * C::kSlots + C::kVStages};

  const int groups = (n_slab * kSlab + kOut - 1) / kOut;
  const int bh = blockIdx.x / groups, b = bh / p.H, h = bh % p.H;
  const int col0 = blockIdx.x % groups * kOut;
  const int q0 = (p.n_qt - 1 - blockIdx.y) * C::kBQ;
  const int kv_end = p.causal ? min(p.Tk, q0 + C::kBQ) : p.Tk;
  const int n_kv = (kv_end + C::kBK - 1) / C::kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.q_full, 1);
    for (int s = 0; s < C::kSlots; ++s) {
      sm90::mbar_init(bar.k_full + s, 1);
      sm90::mbar_init(bar.k_empty + s, 128);
    }
    for (int s = 0; s < C::kVStages; ++s) {
      sm90::mbar_init(bar.v_full + s, 1);
      sm90::mbar_init(bar.v_empty + s, 128);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0)
      produce_deep<kOut>(&tq, &tk, &tv, qs, ring, vs, bar, b, h, q0, n_kv,
                         col0, n_slab, stream_q);
  } else {
    int j = 0;   // slabs taken from the ring
    auto issue_s = [&](float(&s)[C::kBK / 2], int) {
      sm90::wgmma_fence();
      issue_s_deep<kOut>(s, qs, ring, bar, n_slab, stream_q, j);
    };
    auto release_s = [&](int) {
      sm90::mbar_arrive(bar.k_empty + (j - 1) % C::kSlots);
    };
    consume<kOut, C::kBK, C::kVStages, In, OutT>(
        p, vs, bar, b, h, q0, n_kv, col0, issue_s, release_s);
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: tf32 wgmma (see the header)

// The tf32 forward's layout: a block of 64 q rows and the kOut columns of
// O from col0 (64, or 128 in groups), S summed over the depth's slabs of 32
// fp32 columns through a ring, V transposed into V^T slots by the producer
// warpgroup. Warp 0 loads (one thread), warps 1-3 (96 threads) round and
// transpose, warpgroup 1 consumes.
template <int kOut_>
struct Tf32 {
  static constexpr int kOut = kOut_;
  static constexpr int kThreads = 256;
  // blocks an SM holds: two at kOut 64 (the consumer's O, S and P fit 128
  // registers), else one
  static constexpr int kMinBlocks = kOut == 64 ? 2 : 1;
  static constexpr int kBQ = 64, kBK = 64;
  static constexpr int kSlabElems = 64 * kCols32;   // 64 rows of a slab
  static constexpr int kStage = 2;       // V's staging slots, a slab each
  static constexpr int kVStages = 2;     // V^T slots
  static constexpr int kVElems = kBK * kOut;     // a V^T tile
  static constexpr int kMaxSlots = 8;    // ring slots of K slabs
  // a block's share of the SM's 228 KB (each block reserves 1 KB), at most
  // the 227 KB one block may have
  static constexpr int kCap =
      kMinBlocks == 1 ? 232448 : 233472 / kMinBlocks - 1024;
  // V^T, the staging slots, the barriers and room to align the base to
  // 1024 bytes
  static constexpr int kFixed =
      (kVStages * kVElems + kStage * kSlabElems) * 4 + 512 + 1024;
  static_assert(kOut % kCols32 == 0 && kOut <= 128, "wgmma's rs members");
  // Q resident (n_slab slabs) while 4 ring slots fit beside it, else
  // streamed: a ring slot then holds Q_c beside K_c
  struct Plan {
    bool stream_q;
    int slots, smem;
  };
  __host__ __device__ static Plan plan(int n_slab) {
    const int rest = kCap - kFixed, q_bytes = n_slab * kSlabElems * 4;
    const bool stream_q = rest - q_bytes < 4 * kSlabElems * 4;
    const int slot = (stream_q ? 2 : 1) * kSlabElems * 4;
    int slots = (rest - (stream_q ? 0 : q_bytes)) / slot;
    slots = slots < kMaxSlots ? slots : kMaxSlots;
    return {stream_q, slots, kFixed + (stream_q ? 0 : q_bytes) + slots * slot};
  }
};

// The tf32 forward's barriers beyond Barriers: TMA's completions of the
// raw tiles the converters round (q_raw, k_raw) and of V's staging slots
// (s_full), and the converters' release of a staging slot (s_empty).
// q_full, k_full and v_full complete when the 96 converters arrive.
struct Tf32Bars {
  uint64_t *q_raw, *k_raw, *s_full, *s_empty;
};

// The loading thread: Q where it stays resident, then for each kv tile its
// K slabs (with Q's beside them where Q streams) into the ring and its V
// slabs (the block's kOut columns from col0) into the staging slots, in the
// order the converters take them.
template <int kOut>
__device__ __forceinline__ void load_tf32(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    float* qs, float* ring, float* stage, const Barriers& bar,
    const Tf32Bars& tb, int b, int h, int q0, int n_kv, int col0,
    int n_slab, bool stream_q, int slots) {
  using C = Tf32<kOut>;
  sm90::prefetch_tensor_map(tq);
  sm90::prefetch_tensor_map(tk);
  sm90::prefetch_tensor_map(tv);
  // a streamed Q completes q_raw with no bytes
  sm90::mbar_arrive_expect_tx(tb.q_raw,
                              stream_q ? 0 : n_slab * C::kSlabElems * 4);
  if (!stream_q) {
    for (int c = 0; c < n_slab; ++c)
      sm90::tma_load_4d(qs + c * C::kSlabElems, tq, tb.q_raw, c * kCols32,
                        q0, h, b);
  }
  const int slot = (stream_q ? 2 : 1) * C::kSlabElems;
  int j = 0, g = 0;   // K slabs and V slabs loaded
  for (int i = 0; i < n_kv; ++i) {
    for (int c = 0; c < n_slab; ++c, ++j) {
      const int st = j % slots;
      sm90::mbar_wait(bar.k_empty + st, ((j / slots) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(tb.k_raw + st, slot * 4);
      float* dst = ring + st * slot;
      sm90::tma_load_4d(dst, tk, tb.k_raw + st, c * kCols32, i * C::kBK, h,
                        b);
      if (stream_q)
        sm90::tma_load_4d(dst + C::kSlabElems, tq, tb.k_raw + st,
                          c * kCols32, q0, h, b);
    }
    for (int s = 0; s < kOut / kCols32; ++s, ++g) {
      const int st = g % C::kStage;
      sm90::mbar_wait(tb.s_empty + st, ((g / C::kStage) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(tb.s_full + st, C::kSlabElems * 4);
      sm90::tma_load_4d(stage + st * C::kSlabElems, tv, tb.s_full + st,
                        col0 + s * kCols32, i * C::kBK, h, b);
    }
  }
}

// The converters (ct = 0..95): Q rounded once where it is resident, then
// for each kv tile its K slabs (and streamed Q slabs) rounded in place and
// its V slabs transposed into a V^T slot, in the loader's order; each
// barrier the consumer waits for completes after their fence.
template <int kOut>
__device__ __forceinline__ void convert_tf32(float* qs, float* ring,
                                             float* stage, float* vt,
                                             const Barriers& bar,
                                             const Tf32Bars& tb, int n_kv,
                                             int n_slab, bool stream_q,
                                             int slots, int ct) {
  using C = Tf32<kOut>;
  if (!stream_q) {
    sm90::mbar_wait(tb.q_raw, 0);
    sm90::round_tf32(qs, n_slab * C::kSlabElems, ct);
  }
  sm90::fence_proxy_async();
  sm90::mbar_arrive(bar.q_full);
  const int slot = (stream_q ? 2 : 1) * C::kSlabElems;
  int j = 0, g = 0;
  for (int i = 0; i < n_kv; ++i) {
    for (int c = 0; c < n_slab; ++c, ++j) {
      const int st = j % slots;
      sm90::mbar_wait(tb.k_raw + st, (j / slots) & 1);
      sm90::round_tf32(ring + st * slot, slot, ct);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar.k_full + st);
    }
    const int vs = i % C::kVStages;
    sm90::mbar_wait(bar.v_empty + vs, ((i / C::kVStages) & 1) ^ 1);
    for (int s = 0; s < kOut / kCols32; ++s, ++g) {
      const int st = g % C::kStage;
      sm90::mbar_wait(tb.s_full + st, (g / C::kStage) & 1);
      sm90::transpose_tf32<kOut, false>(stage + st * C::kSlabElems,
                                  vt + vs * C::kVElems, s * kCols32, ct);
      sm90::mbar_arrive(tb.s_empty + st);
    }
    sm90::fence_proxy_async();
    sm90::mbar_arrive(bar.v_full + vs);
  }
}

// S = Q K^T of one kv tile over the depth, a commit group of four tf32
// products a slab (as issue_s_deep): each slab's ring slot released once
// its group has retired; the last one's group may still be in flight on
// return, its slot not released. j counts the slabs taken from the ring.
__device__ __forceinline__ void issue_s_tf32(float (&s)[32], const float* qs,
                                             const float* ring,
                                             const Barriers& bar, int n_slab,
                                             bool stream_q, int slots,
                                             int& j) {
  constexpr int kSlabElems = 64 * kCols32;
  const int slot = (stream_q ? 2 : 1) * kSlabElems;
  auto slab = [&](int c, bool first) {
    const int st = j % slots;
    sm90::mbar_wait(bar.k_full + st, (j / slots) & 1);
    const float* kt = ring + st * slot;
    const float* qt = stream_q ? kt + kSlabElems : qs + c * kSlabElems;
#pragma unroll
    for (int kk = 0; kk < kCols32 / 8; ++kk)
      sm90::Wgmma<64, float>::template ss<0, 0>(
          s, sm90::desc_k_major(qt + kk * 8),
          sm90::desc_k_major(kt + kk * 8), !first || kk > 0);
    sm90::wgmma_commit();
    ++j;
  };
  slab(0, true);
  for (int c = 1; c < n_slab; ++c) {
    slab(c, false);
    sm90::wgmma_wait<1>();   // slab c - 1's products have retired
    sm90::mbar_arrive(bar.k_empty + (j - 2) % slots);
  }
}

template <int kOut>
__global__ void __launch_bounds__(Tf32<kOut>::kThreads,
                                  Tf32<kOut>::kMinBlocks)
flash_fwd_sm90_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const FwdParams p) {
  using C = Tf32<kOut>;
  const int n_slab = (p.d + kCols32 - 1) / kCols32;
  const typename C::Plan pl = C::plan(n_slab);
  const int slot = (pl.stream_q ? 2 : 1) * C::kSlabElems;
  float* vt = reinterpret_cast<float*>(smem_base());
  float* stage = vt + C::kVStages * C::kVElems;
  float* ring = stage + C::kStage * C::kSlabElems;
  float* qs = ring + pl.slots * slot;   // a resident Q
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      qs + (pl.stream_q ? 0 : n_slab * C::kSlabElems));
  constexpr int kM = C::kMaxSlots;
  const Barriers bar{bars, bars + 1, bars + 1 + kM, bars + 1 + 2 * kM,
                     bars + 1 + 2 * kM + C::kVStages};
  uint64_t* more = bars + 1 + 2 * kM + 2 * C::kVStages;
  const Tf32Bars tb{more, more + 1, more + 1 + kM,
                    more + 1 + kM + C::kStage};

  const int groups = (p.d + kOut - 1) / kOut;
  const int bh = blockIdx.x / groups, b = bh / p.H, h = bh % p.H;
  const int col0 = blockIdx.x % groups * kOut;
  const int q0 = (p.n_qt - 1 - blockIdx.y) * C::kBQ;
  const int kv_end = p.causal ? min(p.Tk, q0 + C::kBQ) : p.Tk;
  const int n_kv = (kv_end + C::kBK - 1) / C::kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.q_full, sm90::kConverters);
    sm90::mbar_init(tb.q_raw, 1);
    for (int s = 0; s < pl.slots; ++s) {
      sm90::mbar_init(tb.k_raw + s, 1);
      sm90::mbar_init(bar.k_full + s, sm90::kConverters);
      sm90::mbar_init(bar.k_empty + s, 128);
    }
    for (int s = 0; s < C::kVStages; ++s) {
      sm90::mbar_init(bar.v_full + s, sm90::kConverters);
      sm90::mbar_init(bar.v_empty + s, 128);
    }
    for (int s = 0; s < C::kStage; ++s) {
      sm90::mbar_init(tb.s_full + s, 1);
      sm90::mbar_init(tb.s_empty + s, sm90::kConverters);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      load_tf32<kOut>(&tq, &tk, &tv, qs, ring, stage, bar, tb, b, h, q0,
                      n_kv, col0, n_slab, pl.stream_q, pl.slots);
  } else if (threadIdx.x < 128) {
    convert_tf32<kOut>(qs, ring, stage, vt, bar, tb, n_kv, n_slab,
                       pl.stream_q, pl.slots, threadIdx.x - 32);
  } else {
    int j = 0;   // slabs taken from the ring
    auto issue_s = [&](float(&s)[C::kBK / 2], int) {
      sm90::wgmma_fence();
      issue_s_tf32(s, qs, ring, bar, n_slab, pl.stream_q, pl.slots, j);
    };
    auto release_s = [&](int) {
      sm90::mbar_arrive(bar.k_empty + (j - 1) % pl.slots);
    };
    consume<kOut, C::kBK, C::kVStages, float, float>(
        p, vt, bar, b, h, q0, n_kv, col0, issue_s, release_s);
  }
}

// The tensor maps of q, k and v, read in boxes of 128 bytes of columns by
// q_rows or kv_rows rows.
template <typename In>
cudaError_t qkv_maps(const Args& a, CUtensorMap (&maps)[3], int q_rows,
                     int kv_rows) {
  const flash::View* in[3] = {&a.q, &a.k, &a.v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = sm90::bhtd_map<In>(
        &maps[i], in[i]->p, a.B, a.H, i == 0 ? a.Tq : a.Tk, a.Dr, in[i]->sb,
        in[i]->sh, in[i]->st, i == 0 ? q_rows : kv_rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Opts `kernel` into `smem` bytes of dynamic shared memory (the attribute
// belongs to the current device: set at every launch) and launches it over
// (B * H * groups, the blocks of kBQ q rows).
template <typename K>
cudaError_t launch_on(K kernel, const Args& a, int groups, int kBQ,
                      int threads, int smem, cudaStream_t stream,
                      const CUtensorMap (&maps)[3]) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.Tq + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)(a.B * a.H * groups), (unsigned)n_qt);
  const FwdParams p{a.o,      a.lse,  a.H,  a.Tq,   a.Tk,
                    a.causal, n_qt,   a.Dr, a.scale};
  kernel<<<grid, threads, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <int D, typename In, typename OutT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Tiles<D>;
  CUtensorMap maps[3];
  const cudaError_t err = qkv_maps<In>(a, maps, C::kBQ, C::kBK);
  if (err != cudaSuccess) return err;
  return launch_on(flash_fwd_sm90_kernel<D, In, OutT>, a, C::kGroups, C::kBQ,
                   C::kThreads, C::kSmem, stream, maps);
}

template <int kOut, typename In, typename OutT>
cudaError_t launch_deep(const Args& a, cudaStream_t stream) {
  using C = Deep<kOut>;
  CUtensorMap maps[3];
  const cudaError_t err = qkv_maps<In>(a, maps, C::kBQ, C::kBK);
  if (err != cudaSuccess) return err;
  return launch_on(flash_fwd_sm90_kernel_deep<kOut, In, OutT>, a,
                   (a.D + kOut - 1) / kOut, C::kBQ, C::kThreads,
                   C::smem(a.D / kSlab), stream, maps);
}

// The instance for the head dim: 64 and 128, and 192, 256, 320, 384 and
// 512 (the wide ones; 448 runs on 512); above 512 the deep kernel, its
// groups of O's columns as few as may be, then as narrow (D 576: 3 x 192).
template <typename In, typename OutT>
cudaError_t forward(const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 64:
      return launch<64, In, OutT>(a, stream);
    case 128:
      return launch<128, In, OutT>(a, stream);
    case 192:
      return launch<192, In, OutT>(a, stream);
    case 256:
      return launch<256, In, OutT>(a, stream);
    case 320:
      return launch<320, In, OutT>(a, stream);
    case 384:
      return launch<384, In, OutT>(a, stream);
    case 448:
    case 512:
      return launch<512, In, OutT>(a, stream);
    default:
      if (a.D <= 512 || a.D % kSlab != 0) return cudaErrorInvalidValue;
      return (a.D + 191) / 192 <= (a.D + 255) / 256
                 ? launch_deep<192, In, OutT>(a, stream)
                 : launch_deep<256, In, OutT>(a, stream);
  }
}

template <typename In>
cudaError_t forward_in(const Args& a, cudaStream_t stream) {
  return a.out_f32 ? forward<In, float>(a, stream)
                   : forward<In, In>(a, stream);
}

// fp32 inputs (o fp32 for K6 and K7 alike): the tf32 kernel, O's columns
// in one group of 64 at D 64, else in groups of 128.
template <int kOut>
cudaError_t launch_tf32(const Args& a, cudaStream_t stream) {
  using C = Tf32<kOut>;
  CUtensorMap maps[3];
  const cudaError_t err = qkv_maps<float>(a, maps, C::kBQ, C::kBK);
  if (err != cudaSuccess) return err;
  const int n_slab = (a.Dr + kCols32 - 1) / kCols32;
  return launch_on(flash_fwd_sm90_tf32_kernel<kOut>, a,
                   (a.Dr + kOut - 1) / kOut, C::kBQ, C::kThreads,
                   C::plan(n_slab).smem, stream, maps);
}

cudaError_t forward_tf32(const Args& a, cudaStream_t stream) {
  return a.D == 64 ? launch_tf32<64>(a, stream) : launch_tf32<128>(a, stream);
}

}  // namespace

namespace flash {

// o = softmax(q k^T * scale) v and lse over [B, H, T, Dr] views: bf16 or
// fp16 on the instance of head dim D = 64, 128, 192, 256, 320, 384 or 512
// (D 448 on 512's), or above 512 (any multiple of 64) on the deep kernel,
// o in the input type or fp32 (out_f32); fp32 at any D on the tf32
// kernel, o in fp32.
cudaError_t fwd_sm90(const Args& a, cudaStream_t stream) {
  if (a.dtype == kF32) return forward_tf32(a, stream);
  return a.dtype == kF16 ? forward_in<__half>(a, stream)
                         : forward_in<__nv_bfloat16>(a, stream);
}

}  // namespace flash
