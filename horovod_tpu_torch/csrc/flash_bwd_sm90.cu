// Flash attention backward for Hopper: K6c (dk, dv) and K6d (dq) of flash
// attention, outputs in the input type, and K7b / K7c, ring attention's
// per-segment backward, fp32 outputs; bf16 or fp16 inputs (In) at every
// head dim, and dk/dv and dq for fp32 inputs on tf32 (K6 and K7 alike,
// fp32 outputs).
//
// Replaces the custom-VJP backward of the Pallas kernels that
// horovod_tpu/parallel/flash_attention.py:flash_attention_local takes from
// jax's library (_flash_attention_bwd_dkv, _flash_attention_bwd_dq) and the
// same two kernels under horovod_tpu/parallel/ring_attention.py:
// _seg_bwd_pallas. Under the lse and di given from outside (K6: the
// forward's; K7: the ring's global ones):
//   P = exp(S * scale - lse), S = Q K^T;   dS = P o (dO V^T - di);
//   dV = P^T dO;   dK = scale * dS^T Q;   dQ = scale * dS K;
// P and dS are rounded to In before their products, as the plain versions
// (ops/kernels.py) round them; q has Tq rows and k, v Tk; causal is the
// library kernel's rule, key <= query by absolute index.
//
// What bounds them on an H100: operations. At the flagship shape (B4 H16
// T2048 D128, causal) dk/dv do 8 D and dq 6 D operations a visible
// (q, kv) pair, some 2,000 operations a byte of their inputs against the
// card's 295, so the work is the tensor cores' (wgmma) and S, P, dP and dS
// never go to device memory. The design, on the helpers of sm90.cuh:
// - dk/dv: a block holds 64 kv rows of K and V (TMA, once) and a producer
//   thread streams the Q and dO tiles of 64 q rows through a ring of 3
//   slots on full/empty mbarriers; a second producer warp writes each
//   tile's lse (times log2 e; +inf past Tq, so P is 0 there with no test)
//   and di rows into the slot beside it and arrives on the same full
//   barrier, so a slot's tiles and its statistics complete in one phase.
//   Two consumer warpgroups split the roles over the same 64 kv rows:
//   warpgroup 1 computes S^T = K Q^T (wgmma, both operands K-major), P^T,
//   and dV += P^T dO (P^T from registers, dO an MN-major B), and hands
//   P^T in fp32 to warpgroup 2 through a shared-memory buffer of the ring
//   slot (thread i writes the values thread i of the other warpgroup
//   holds in the same layout; a per-slot mbarrier of 128 arrivals says
//   it is there); warpgroup 2 computes dP^T = V dO^T, dS^T, and
//   dK += dS^T Q. Each thread then holds one D-wide accumulator (64
//   registers at D 128) beside one 64 x 64 tile (32), which fits the 168
//   registers a thread of a 384-thread block has with no spill; holding
//   dK and dV in one warpgroup would need 192 and more. The two products
//   of each warpgroup run side by side, 4 products a tile.
// - dk/dv at head dims 192 and 256 (DkdvTiles<D>): ring slots of 2 (shared
//   memory; at D 256 K, V, two slots and their P^T buffers take 231,680
//   bytes). At D 192 an accumulator is 96 registers and fits as above. At
//   D 256 it is 128, beside S^T or dP^T (32) and P^T or dS^T (16): more
//   than the 168 a thread of a 384-thread block launches with, and ptxas
//   gives a wgmma consumer's accumulators the launch's count whatever
//   setmaxnreg asks (any block of more than 8 warps launches with at most
//   168: 3 warps share one of the SM's 4 register files). So at D 256 the
//   two consumers are the whole block, 256 threads launched with 255
//   registers each, and the dK warpgroup, which finishes each tile last,
//   loads the ring itself: its first warp refills a slot with the tile
//   two ahead (thread 0 the TMA loads, every lane its lse and di rows) as
//   soon as the slot's tile is done. S^T and dP^T are computed once.
// - dq: a block holds 128 q rows of Q and dO (TMA, once; 64 a consumer
//   warpgroup) and the producer streams K and V tiles of 64 kv rows
//   through a ring of 2 slots. A consumer computes S = Q K^T and
//   dP = dO V^T (one commit group), P and dS in registers (lse and di of
//   its two rows held in registers), and dQ += dS K (dS from registers, K
//   an MN-major B). Blocks start with the longest rows.
// - dq at head dims 192 and 256 (DqTiles<D>): dQ is 96 or 128 registers
//   beside S and dP (32 each) and dS (16), more than the 168 a thread of a
//   384-thread block has. So, as the forward at D 256: one consumer of 64
//   q rows in a block of 256 threads (255 registers at launch), S and dP
//   over the whole depth once, dQ over the whole D. With one consumer the
//   tensor cores would idle while it forms dS, so the products of
//   consecutive tiles overlap as the forward's do: S_j and dP_j are issued
//   with dS_{j-1} K_{j-1}, and dS_j is formed while that is in flight.
//   K_j is read by two tiles' products and V_j by one, so K and V have
//   rings of their own, 3 K slots and 2 V slots (at D 256 Q, dO and the
//   rings take 229,376 bytes), each V slot released once dP is done and
//   each K slot once its dQ product is.
// - dq for fp32 inputs (DqTf32<kOut>, flash_bwd_dq_sm90_tf32_kernel<kOut>):
//   tf32 wgmma, the forward's tf32 design (flash_fwd_sm90.cu) applied to
//   dq. S = Q K^T and dP = dO V^T are K-major products, summed over the
//   depth's slabs of 32 columns through a ring whose slot holds K_c and
//   V_c (up to 8 slots); dQ += dS K contracts over kv, so K is the operand
//   wgmma cannot take as stored. The producer warpgroup's 96 converters
//   round each slab to tf32 in place and, for the K slabs of the block's
//   columns, write K^T (kOut rows by 64 kv, the kv order of
//   sm90::to_operand_tf32) into a slot of its own, in the same pass; dS is
//   the A operand as it lies in the accumulator. dQ's columns go in groups
//   of kOut (64 at head dims up to 64, else 128: D 256 two groups, D 320
//   three, S and dP computed once a group), so a consumer holds dQ (kOut /
//   2 registers), S and dP (32 each) and dS (32): 160 at kOut 128, in a
//   block of 256 threads (ptxas: 190 registers at kOut 128, 155 at 64, no
//   spill). S_j and dP_j are issued with dQ += dS_{j-1} K_{j-1}, as the
//   16-bit dq above D 128 does. Q and dO stay resident while two ring
//   slots fit beside them (up to D 256: Tf32Plan); above that they stream
//   through the ring beside K_c and V_c, a slot holding the four slabs
//   (re-read from L2 for every kv tile, as the deep forward streams Q).
// - dk/dv for fp32 inputs (DkdvTf32<kOut>,
//   flash_bwd_dkdv_sm90_tf32_kernel<kOut>): the 16-bit dk/dv's math on
//   tf32 wgmma. S^T = K Q^T and dP^T = V dO^T are K-major on both sides,
//   summed over the depth's slabs of 32 columns through a ring whose slot
//   holds Q_c and dO_c of a q tile of 64 rows. dV += P^T dO and
//   dK += dS^T Q contract over q, so both dO and Q are operands wgmma
//   cannot take as stored: for the Q and dO slabs of the block's columns
//   the converters write Q^T and dO^T (kOut rows by 64 q, to_operand_tf32's
//   order) into a slot of the q tile's own (two slots), as dq writes K^T,
//   and the tile's lse (log2 units, +inf past Tq) and di rows beside them;
//   P^T and dS^T are the A operands as they lie in their accumulators. A
//   block holds 64 kv rows and one group of kOut of dK's and dV's columns
//   (groups along blockIdx.x, as dq's); K and V stay resident at the whole
//   depth while two ring slots fit beside them (up to D 128), above that
//   they stream through the ring beside Q_c and dO_c. The register budget
//   decides the rest. At head dims up to 64 (kOut 64, one group) one
//   consumer holds dK and dV (kOut / 2 each), S^T and dP^T (32 each) and
//   P^T and dS^T as operands (32 each), 192, and S^T_i and dP^T_i are
//   issued with tile i-1's dV and dK products, P^T_i and dS^T_i formed
//   while those are in flight. Above 64 (kOut 128) dK and dV alone take
//   128 registers, which leaves room for one tile's S^T and dP^T and no
//   more: a tile's products follow its S^T and dP^T, which are rounded in
//   place and become the A operands as they lie. Both in a block of 256
//   threads (255 registers at launch; ptxas: 221 at each kOut, no spill).
//   Each group computes S^T and dP^T again: 4 D + 4 kOut operations a
//   visible pair a group, twice the ideal 8 D at D 320 (3 groups).
//   Timed and not kept: kOut 64 with the overlap at every head dim (5
//   groups at D 320, 2 at 128: slower at D 320 and on the ring's D 128
//   half, a little faster at D 256, where K and V stay resident at kOut
//   64 and stream at 128), and one slot of Q^T and dO^T at kOut 128 (room
//   for more ring slots, or K and V resident to D 256; slower at D 256 and
//   320). Rejected without a build: the 16-bit dk/dv's split at kOut 128,
//   a dV warpgroup (S^T, P^T, dV) handing P^T through shared memory to a
//   dK warpgroup (dP^T, dS^T, dK) in a block of 384 threads. Its
//   consumers need about 160 registers beside the 168 a thread of such a
//   block launches with, and P^T's 16 KB a tile beside two slots of Q^T
//   and dO^T leave no room for K and V resident above D 64.
// - bf16 and fp16 dk/dv and dq above head dim 256 (DkdvDeep<kOut>,
//   flash_bwd_dkdv_sm90_kernel_deep, and DqDeep<kOut>,
//   flash_bwd_dq_sm90_kernel_deep: one instance each for every such D).
//   wgmma's N is at most 256, and dK and dV at the whole D, or dQ beside S
//   and dP, fit no register budget above 256, so the output columns go in
//   groups over blocks (along blockIdx.x, as the tf32 kernels'): dK's and
//   dV's in groups of 128 (one consumer holds both, 128 registers, beside
//   S^T and dP^T, 64), dQ's in the fewest groups of 192 or 256, then the
//   narrower (D 320 is 2 x 192, D 1024 4 x 256), beside S and dP. The
//   16-bit deep forward's structure serves both (flash_fwd_sm90.cu's
//   issue_s_deep): S^T and dP^T (S and dP) are summed over the depth's
//   slabs of 64 columns through a TMA ring of slab slots, one commit group
//   of eight m64n64k16 products a slab, a slot released once its group has
//   retired. The group's products read its columns of the streamed
//   operands, dO_g and Q_g (dk/dv) or K_g (dq), which are slabs of that
//   same stream: the ring takes a tile's slabs in an order that puts the
//   group's own last (SlabOrder), their slots stay until the group's
//   products retire, and the products go slab by slab (four m64n64k16 a
//   slab, the slot an MN-major B as stored, no transpose), each into its
//   64 columns of the accumulator. So no operand is loaded twice, and a
//   slot holds one slab of each streamed operand. K and V (dk/dv), or Q
//   and dO (dq), stay resident at the whole depth while the group's slots
//   and two more fit beside them (DeepPlan: to D 640 at dk/dv's 128, to
//   576 at dq's 192, 512 at 256) and stream through the ring beside the
//   others above. A block is a loading warp (one thread), for dk/dv a warp
//   that writes each q tile's lse and di rows into slots of their own, and
//   one consumer warpgroup, 256 threads launched with 255 registers. Each
//   group computes S and dP again: 4 D + 4 kOut operations a visible pair
//   a group against the ideal 8 D (dk/dv at D 320: 3 groups, 2.1 times).
//   The tensor cores idle while the consumer forms P^T and dS^T (dS): the
//   next tile's slabs may not overtake the group's kept slots. The wait
//   for a slab, between the products of the previous one and its own, is
//   warp-uniform (sm90::mbar_wait_warp): with a wait loop that may diverge
//   there, ptxas serialized every product of the kernel (C7520), which
//   ran slower.
// - Only a tile that crosses the causal diagonal, or Tk in dq, runs the
//   per-element mask; TMA zero-fills rows past Tq and Tk, whose outputs
//   are never stored. A dk/dv block past every query (causal, Tk > Tq)
//   loads nothing and stores zeros.
// - A head dim below the instance's (Args::Dr: 16 or 80 on the D 64 or 128
//   one, 160 on 192) is read in place: the tensor maps' inner dimension is
//   the views' own and TMA fills the columns past it with zeros, which add
//   nothing to S or dP; dq, dk and dv are stored at the views' columns
//   only. No zero-padded copy is made.
// Nothing is accumulated across blocks and dQ has a pass of its own (no
// float atomics), and the arithmetic never sees the views' strides: runs
// repeat bitwise, and strided views give the bits of contiguous copies.
// Tried and not kept (slower at the flagship shape): one warpgroup holding
// both dK and dV of its 64 kv rows under setmaxnreg 240 (it spilled: ptxas
// held the consumers to the block's 168 registers), S^T computed by both
// warpgroups instead of handed over (5 products a tile), and, in the
// 384-thread blocks, issuing the next tile's S^T / dP^T / S, dP behind the
// current tile's last product (ptxas reported the products serialized,
// C7512 / C7519; the wide dq's 256-thread block, 255 registers at launch,
// overlaps them with no such report and no spill).
// Not here (later work): a persistent scheduler, a TMA store epilogue.

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
using flash::View;

constexpr int kSlab = 64;      // 16-bit columns of a 128-byte swizzled slab
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kKV = 64;        // dk/dv: kv rows of a block
constexpr int kBQ = 64;        // dk/dv: q rows of a ring tile
constexpr int kBK = 64;        // dq: kv rows of a ring tile

template <int D>
struct DkdvTiles {
  // at D 256 the consumers load the ring themselves (see the header)
  static constexpr bool kSelfLoad = D == 256;
  static constexpr int kThreads = kSelfLoad ? 256 : 384;
  // ring slots of Q and dO: 3, or 2 above D 128 (shared memory)
  static constexpr int kStages = D <= 128 ? 3 : 2;
  static constexpr int kKVElems = kKV * D;   // the K or the V tile
  static constexpr int kQElems = kBQ * D;    // a Q or a dO tile
  static constexpr uint32_t kSlotBytes = 2 * kQElems * 2;
  static constexpr int kStatFloats = 2 * kBQ;  // lse, then di, of a slot
  // a slot's P^T, handed from the dV warpgroup to the dK one: kBQ / 2
  // values of each of 128 threads, value-major (conflict-free)
  static constexpr int kPFloats = kBQ / 2 * 128;
  static constexpr int kSmem = (2 * kKVElems + 2 * kStages * kQElems) * 2 +
                               kStages * (kStatFloats + kPFloats) * 4 + 256 +
                               1024;
};

template <int D>
struct DqTiles {
  // above D 128: one consumer, the products of consecutive tiles
  // overlapped, K and V in rings of their own (see the header)
  static constexpr bool kWide = D > 128;
  static constexpr int kConsumers = kWide ? 1 : 2;
  // a producer warpgroup and the consumers
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBQ = 64 * kConsumers;  // q rows of a block
  // ring slots of K (with K and V in one slot below D 192) and of V
  static constexpr int kKStages = kWide ? 3 : 2;
  static constexpr int kVStages = 2;
  static constexpr int kQElems = kBQ * D;      // the Q or the dO tile
  static constexpr int kTileElems = kBK * D;   // a K or a V tile
  // the bytes a full barrier waits for: a K and a V tile, or one of them
  static constexpr uint32_t kSlotBytes = (kWide ? 1 : 2) * kTileElems * 2;
  static constexpr int kSmem =
      (2 * kQElems + (kKStages + kVStages) * kTileElems) * 2 + 256 + 1024;
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

// A warpgroup's 64 x D accumulator times `mul`, rows r_lo and r_lo + 8 of
// this thread, to the rows < T and the columns < dr (the views' head dim)
// of one head of `out`.
template <int D, typename OutT>
__device__ __forceinline__ void store_acc(const View& out, int b, int h,
                                          int r_lo, int T, int dr,
                                          const float (&acc)[D / 2],
                                          float mul, int t) {
  OutT* head = reinterpret_cast<OutT*>(out.p) + b * out.sb + h * out.sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= T) continue;
    OutT* row = head + r * out.st;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j + 2 * t < dr)
        store2(row + 8 * j + 2 * t, acc[4 * j + 2 * i] * mul,
               acc[4 * j + 2 * i + 1] * mul);
  }
}

// acc (=) A B^T over depth D: A's 64 rows and B's N rows both K-major in
// slabs of 64 columns (slab strides a_rows and b_rows rows), issued, not
// committed.
template <int D, int N, typename In>
__device__ __forceinline__ void issue_nt(float (&acc)[N / 2], const In* a,
                                         int a_rows, const In* b,
                                         int b_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int slab = kk / 4, col = (kk % 4) * 16;
    sm90::Wgmma<N, In>::template ss<0, 0>(
        acc, sm90::desc_k_major(a + slab * a_rows * kSlab + col),
        sm90::desc_k_major(b + slab * b_rows * kSlab + col), kk > 0);
  }
}

// acc += A B over depth K: A in registers (K/16 operands), B a tile of K
// rows and D columns in slabs of 64, MN-major; issued and committed.
template <int D, int K, typename In>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         const In* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    sm90::Wgmma<D, In>::template rs<1>(
        acc, a[kk], sm90::desc_mn_major(b + kk * 16 * kSlab, K * kSlab * 2),
        1);
  sm90::wgmma_commit();
}

// ---------------------------------------------------------------------------
// dk / dv

struct DkdvShared {
  uint64_t* kv_full;   // the block's K and V tiles
  // a ring slot: filled by TMA (1 arrival and the tiles' bytes) and the
  // statistics warp (32 arrivals), emptied by both consumers (256)
  uint64_t* full;
  uint64_t* empty;
  uint64_t* p_full;   // a slot's P^T written by the dV warpgroup (128)
};

// What loads a dk/dv block's tiles: the tensor maps, the shared-memory
// tiles and the block's coordinates.
template <typename In>
struct DkdvLoads {
  const CUtensorMap *tq, *tk, *tv, *tdo;
  In *ks, *vs, *qr, *dr;
  float* stats;
  int b, h, kv0, q_first;
};

// One thread: the block's K and V tiles.
template <int D, typename In>
__device__ __forceinline__ void dkdv_load_kv(const DkdvLoads<In>& l,
                                             const DkdvShared& bar) {
  using C = DkdvTiles<D>;
  sm90::prefetch_tensor_map(l.tq);
  sm90::prefetch_tensor_map(l.tk);
  sm90::prefetch_tensor_map(l.tv);
  sm90::prefetch_tensor_map(l.tdo);
  sm90::mbar_arrive_expect_tx(bar.kv_full, 2 * C::kKVElems * 2);
#pragma unroll
  for (int s = 0; s < D / kSlab; ++s) {
    sm90::tma_load_4d(l.ks + s * kKV * kSlab, l.tk, bar.kv_full, s * kSlab,
                      l.kv0, l.h, l.b);
    sm90::tma_load_4d(l.vs + s * kKV * kSlab, l.tv, bar.kv_full, s * kSlab,
                      l.kv0, l.h, l.b);
  }
}

// One thread: the Q and dO tiles of the i-th q tile into its ring slot,
// once both consumers have released the slot's previous tile.
template <int D, typename In>
__device__ __forceinline__ void dkdv_load_tile(const DkdvLoads<In>& l,
                                               const DkdvShared& bar, int i) {
  using C = DkdvTiles<D>;
  const int st = i % C::kStages, q0 = l.q_first + i * kBQ;
  sm90::mbar_wait(bar.empty + st, ((i / C::kStages) & 1) ^ 1);
  sm90::mbar_arrive_expect_tx(bar.full + st, C::kSlotBytes);
  In* qd = l.qr + st * C::kQElems;
  In* dd = l.dr + st * C::kQElems;
#pragma unroll
  for (int s = 0; s < D / kSlab; ++s) {
    sm90::tma_load_4d(qd + s * kBQ * kSlab, l.tq, bar.full + st, s * kSlab,
                      q0, l.h, l.b);
    sm90::tma_load_4d(dd + s * kBQ * kSlab, l.tdo, bar.full + st, s * kSlab,
                      q0, l.h, l.b);
  }
}

// One warp: the i-th q tile's lse (log2 units) and di rows into its slot,
// then the warp's 32 arrivals on the slot's full barrier.
template <int D, typename In>
__device__ __forceinline__ void dkdv_load_stats(const Args& p,
                                                const DkdvLoads<In>& l,
                                                const DkdvShared& bar,
                                                int i) {
  using C = DkdvTiles<D>;
  const int lane = threadIdx.x % 32;
  const int st = i % C::kStages, q0 = l.q_first + i * kBQ;
  const float* lse = p.lse.p + l.b * p.lse.sb + l.h * p.lse.sh;
  const float* di = p.di.p + l.b * p.di.sb + l.h * p.di.sh;
  sm90::mbar_wait(bar.empty + st, ((i / C::kStages) & 1) ^ 1);
  float* ls = l.stats + st * C::kStatFloats;
  for (int r = lane; r < kBQ; r += 32) {
    const int q = q0 + r;
    ls[r] = q < p.Tq ? lse[q] * kLog2e : INFINITY;
    ls[kBQ + r] = q < p.Tq ? di[q] : 0.f;
  }
  sm90::mbar_arrive(bar.full + st);
}

// P^T in place of S^T: exp2(S^T * scale * log2 e - lse * log2 e), 0 where
// causal hides the pair (kv row > q column), only on a tile that crosses
// the diagonal.
__device__ __forceinline__ void p_transposed(float (&s)[kBQ / 2],
                                             const float* ls, float sl2,
                                             bool mask, int q0, int r_lo,
                                             int t) {
#pragma unroll
  for (int e = 0; e < kBQ / 2; ++e) {
    const int c = 8 * (e / 4) + 2 * t + (e & 1);
    float x = exp2f(s[e] * sl2 - ls[c]);
    if (mask && r_lo + 8 * ((e / 2) & 1) > q0 + c) x = 0.f;
    s[e] = x;
  }
}

// Consumer warpgroup 1 (0 with kSelfLoad): dV of the block's 64 kv rows.
template <int D, typename In, typename OutT>
__device__ __forceinline__ void dkdv_consume_dv(
    const Args& p, const In* ks, const In* qr, const In* dr,
    const float* stats, float* pbuf, const DkdvShared& bar, int b, int h,
    int kv0, int q_first, int n_q) {
  using C = DkdvTiles<D>;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3, r_lo = kv0 + 16 * warp + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_q > 0) sm90::mbar_wait(bar.kv_full, 0);
  for (int i = 0; i < n_q; ++i) {
    const int st = i % C::kStages, q0 = q_first + i * kBQ;
    const In* qt = qr + st * C::kQElems;
    const In* dt = dr + st * C::kQElems;
    sm90::mbar_wait(bar.full + st, (i / C::kStages) & 1);
    float s[kBQ / 2];
    sm90::wgmma_fence();
    issue_nt<D, kBQ>(s, ks, kKV, qt, kBQ);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    p_transposed(s, stats + st * C::kStatFloats, sl2,
                 p.causal && kv0 + kKV - 1 > q0, q0, r_lo, t);
    // P^T to the dK warpgroup, whose thread i holds the same elements
    float* pw = pbuf + st * C::kPFloats + threadIdx.x % 128;
#pragma unroll
    for (int e = 0; e < kBQ / 2; ++e) pw[e * 128] = s[e];
    sm90::mbar_arrive(bar.p_full + st);
    uint32_t pa[kBQ / 16][4];
    sm90::to_operand<In>(s, pa);
    sm90::wgmma_fence();
    issue_rs<D, kBQ>(acc, pa, dt);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
    sm90::mbar_arrive(bar.empty + st);
  }
  store_acc<D, OutT>(p.dv, b, h, r_lo, p.Tk, p.Dr, acc, 1.f, t);
}

// Consumer warpgroup 2 (1 with kSelfLoad): dK of the block's 64 kv rows;
// with kSelfLoad its first warp also loads K, V and the ring.
template <int D, typename In, typename OutT>
__device__ __forceinline__ void dkdv_consume_dk(
    const Args& p, const In* vs, const In* qr, const In* dr,
    const float* stats, const float* pbuf, const DkdvShared& bar, int b,
    int h, int kv0, int n_q, const DkdvLoads<In>& loads) {
  using C = DkdvTiles<D>;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3, r_lo = kv0 + 16 * warp + (lane >> 2);
  // the first warp of a self-loading warpgroup fills the ring ahead
  const bool loader = C::kSelfLoad && warp == 0;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (loader && n_q > 0) {
    if (lane == 0) {
      dkdv_load_kv<D>(loads, bar);
      for (int j = 0; j < min(n_q, C::kStages); ++j)
        dkdv_load_tile<D>(loads, bar, j);
    }
    for (int j = 0; j < min(n_q, C::kStages); ++j)
      dkdv_load_stats<D>(p, loads, bar, j);
  }
  if (n_q > 0) sm90::mbar_wait(bar.kv_full, 0);
  for (int i = 0; i < n_q; ++i) {
    const int st = i % C::kStages;
    const In* qt = qr + st * C::kQElems;
    const In* dt = dr + st * C::kQElems;
    const float* ls = stats + st * C::kStatFloats;
    sm90::mbar_wait(bar.full + st, (i / C::kStages) & 1);
    float dp[kBQ / 2];
    sm90::wgmma_fence();
    issue_nt<D, kBQ>(dp, vs, kKV, dt, kBQ);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    // P^T from the dV warpgroup, then dS^T = P^T o (dP^T - di)
    sm90::mbar_wait(bar.p_full + st, (i / C::kStages) & 1);
    const float* pr = pbuf + st * C::kPFloats + threadIdx.x % 128;
#pragma unroll
    for (int e = 0; e < kBQ / 2; ++e) {
      const int c = 8 * (e / 4) + 2 * t + (e & 1);
      dp[e] = pr[e * 128] * (dp[e] - ls[kBQ + c]);
    }
    uint32_t da[kBQ / 16][4];
    sm90::to_operand<In>(dp, da);
    sm90::wgmma_fence();
    issue_rs<D, kBQ>(acc, da, qt);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(da);
    sm90::mbar_arrive(bar.empty + st);
    if (loader && i + C::kStages < n_q) {
      if (lane == 0) dkdv_load_tile<D>(loads, bar, i + C::kStages);
      dkdv_load_stats<D>(p, loads, bar, i + C::kStages);
    }
  }
  store_acc<D, OutT>(p.dk, b, h, r_lo, p.Tk, p.Dr, acc, p.scale, t);
}

template <int D, typename In, typename OutT>
__global__ void __launch_bounds__(DkdvTiles<D>::kThreads, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const Args p) {
  using C = DkdvTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is anchored to 1024-byte atoms: align the tiles to them
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  In* ks = reinterpret_cast<In*>(base);
  In* vs = ks + C::kKVElems;
  In* qr = vs + C::kKVElems;
  In* dr = qr + C::kStages * C::kQElems;
  float* stats = reinterpret_cast<float*>(dr + C::kStages * C::kQElems);
  float* pbuf = stats + C::kStages * C::kStatFloats;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(pbuf + C::kStages * C::kPFloats);
  const DkdvShared bar{bars, bars + 1, bars + 1 + C::kStages,
                       bars + 1 + 2 * C::kStages};

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // the first kv rows see the most q tiles (causal): they start first
  const int kv0 = blockIdx.y * kKV;
  // causal: key <= query, so the q tiles from the one holding row kv0 on
  const int q_first = p.causal ? (kv0 / kBQ) * kBQ : 0;
  const int n_q = q_first < p.Tq ? (p.Tq - q_first + kBQ - 1) / kBQ : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(bar.full + s, 1 + 32);
      sm90::mbar_init(bar.empty + s, 256);
      sm90::mbar_init(bar.p_full + s, 128);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const DkdvLoads<In> loads{&tq, &tk, &tv, &tdo, ks, vs, qr, dr, stats,
                            b, h, kv0, q_first};
  // warpgroup 0 loads (a thread the tiles, a warp the statistics) and 1
  // and 2 consume; with kSelfLoad 0 and 1 consume and 1 loads
  const int role = threadIdx.x / 128 - (C::kSelfLoad ? 0 : 1);
  if (role < 0) {
    if (n_q == 0) return;
    if (threadIdx.x == 0) {
      dkdv_load_kv<D>(loads, bar);
      for (int i = 0; i < n_q; ++i) dkdv_load_tile<D>(loads, bar, i);
    } else if (threadIdx.x / 32 == 1) {
      for (int i = 0; i < n_q; ++i) dkdv_load_stats<D>(p, loads, bar, i);
    }
  } else if (role == 0) {
    dkdv_consume_dv<D, In, OutT>(p, ks, qr, dr, stats, pbuf, bar, b, h, kv0,
                                 q_first, n_q);
  } else {
    dkdv_consume_dk<D, In, OutT>(p, vs, qr, dr, stats, pbuf, bar, b, h,
                                 kv0, n_q, loads);
  }
}

// ---------------------------------------------------------------------------
// dq

struct DqShared {
  uint64_t* q_full;   // the block's Q and dO tiles
  // a ring slot of K and V (below D 192) or of K: TMA (1 arrival and the
  // bytes), emptied by the consumers (an arrival from each thread)
  uint64_t* full;
  uint64_t* empty;
  uint64_t* v_full;   // above D 128, a ring slot of V, as above
  uint64_t* v_empty;
};

// One thread: the kv tile j of `map` into `ring`'s slot for it, once the
// consumers have emptied the slot's previous tile; `bytes` completes the
// slot's full barrier.
template <int D, int kStages, typename In>
__device__ __forceinline__ void dq_load_tile(const CUtensorMap* map, In* ring,
                                             uint64_t* full, uint64_t* empty,
                                             uint32_t bytes, int j, int b,
                                             int h) {
  const int st = j % kStages;
  sm90::mbar_wait(empty + st, ((j / kStages) & 1) ^ 1);
  sm90::mbar_arrive_expect_tx(full + st, bytes);
  In* dst = ring + st * DqTiles<D>::kTileElems;
#pragma unroll
  for (int s = 0; s < D / kSlab; ++s)
    sm90::tma_load_4d(dst + s * kBK * kSlab, map, full + st, s * kSlab,
                      j * kBK, h, b);
}

// Producer thread: Q and dO once, then the K and V tiles in ring order.
template <int D, typename In>
__device__ __forceinline__ void dq_produce(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, In* qs, In* dos, In* kr, In* vr,
    const DqShared& bar, int b, int h, int q0, int n_kv) {
  using C = DqTiles<D>;
  sm90::prefetch_tensor_map(tq);
  sm90::prefetch_tensor_map(tk);
  sm90::prefetch_tensor_map(tv);
  sm90::prefetch_tensor_map(tdo);
  sm90::mbar_arrive_expect_tx(bar.q_full, 2 * C::kQElems * 2);
#pragma unroll
  for (int s = 0; s < D / kSlab; ++s) {
    sm90::tma_load_4d(qs + s * C::kBQ * kSlab, tq, bar.q_full, s * kSlab, q0,
                      h, b);
    sm90::tma_load_4d(dos + s * C::kBQ * kSlab, tdo, bar.q_full, s * kSlab,
                      q0, h, b);
  }
  for (int j = 0; j < n_kv; ++j) {
    if constexpr (C::kWide) {
      dq_load_tile<D, C::kKStages>(tk, kr, bar.full, bar.empty, C::kSlotBytes,
                                   j, b, h);
      dq_load_tile<D, C::kVStages>(tv, vr, bar.v_full, bar.v_empty,
                                   C::kSlotBytes, j, b, h);
    } else {
      const int st = j % C::kKStages;
      sm90::mbar_wait(bar.empty + st, ((j / C::kKStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(bar.full + st, C::kSlotBytes);
      In* kd = kr + st * C::kTileElems;
      In* vd = vr + st * C::kTileElems;
#pragma unroll
      for (int s = 0; s < D / kSlab; ++s) {
        sm90::tma_load_4d(kd + s * kBK * kSlab, tk, bar.full + st, s * kSlab,
                          j * kBK, h, b);
        sm90::tma_load_4d(vd + s * kBK * kSlab, tv, bar.full + st, s * kSlab,
                          j * kBK, h, b);
      }
    }
  }
}

// dS = P o (dP - di) in place of dP, P = exp2(S * scale * log2 e - lse *
// log2 e) of this thread's two rows; 0 where the pair is masked (columns
// at or past Tk; causal: past the row), only on a tile that needs it.
template <int N>
__device__ __forceinline__ void dq_ds(const float (&s)[N], float (&dp)[N],
                                      const float (&lse_r)[2],
                                      const float (&di_r)[2], float sl2,
                                      bool mask, int kv0, int r_lo, int t,
                                      int Tk, int causal) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int i = (e / 2) & 1;
    float x = exp2f(s[e] * sl2 - lse_r[i]);
    if (mask) {
      const int col = kv0 + 8 * (e / 4) + 2 * t + (e & 1);
      if (col >= Tk || (causal && col > r_lo + 8 * i)) x = 0.f;
    }
    dp[e] = x * (dp[e] - di_r[i]);
  }
}

// A consumer warpgroup: dQ of its 64 q rows over every kv tile of the block.
template <int D, typename In, typename OutT>
__device__ __forceinline__ void dq_consume(const Args& p, const In* qs,
                                           const In* dos, const In* kr,
                                           const In* vr, const DqShared& bar,
                                           int wg, int b, int h, int q0,
                                           int n_kv) {
  using C = DqTiles<D>;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int qw0 = q0 + 64 * wg;            // the warpgroup's first q row
  const int r_lo = qw0 + 16 * warp + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  const In* qw = qs + wg * 64 * kSlab;
  const In* dw = dos + wg * 64 * kSlab;
  float lse_r[2], di_r[2];
  {
    const float* lse = p.lse.p + b * p.lse.sb + h * p.lse.sh;
    const float* di = p.di.p + b * p.di.sb + h * p.di.sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      lse_r[i] = r < p.Tq ? lse[r] * kLog2e : 0.f;
      di_r[i] = r < p.Tq ? di[r] : 0.f;
    }
  }
  // a tile needs the mask if it crosses Tk or, causal, the diagonal
  auto mask = [&](int kv0) {
    return kv0 + kBK > p.Tk || (p.causal && kv0 + kBK - 1 > qw0);
  };
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(bar.q_full, 0);
  if constexpr (C::kWide) {
    // S_j and dP_j are issued with dQ += dS_{j-1} K_{j-1}; dS_j is formed
    // while that product is in flight. The first tile is peeled off, so no
    // product is issued under a branch.
    constexpr int kKS = C::kKStages, kVS = C::kVStages;
    float s[kBK / 2], dp[kBK / 2];
    uint32_t da[kBK / 16][4];   // dS of the tile whose dQ product is next
    sm90::mbar_wait(bar.full, 0);
    sm90::mbar_wait(bar.v_full, 0);
    sm90::wgmma_fence();
    issue_nt<D, kBK>(s, qw, C::kBQ, kr, kBK);
    issue_nt<D, kBK>(dp, dw, C::kBQ, vr, kBK);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::mbar_arrive(bar.v_empty);
    dq_ds(s, dp, lse_r, di_r, sl2, mask(0), 0, r_lo, t, p.Tk, p.causal);
    sm90::to_operand<In>(dp, da);
    for (int j = 1; j < n_kv; ++j) {
      const int ks = j % kKS, vs = j % kVS, prev = (j - 1) % kKS;
      sm90::mbar_wait(bar.full + ks, (j / kKS) & 1);
      sm90::mbar_wait(bar.v_full + vs, (j / kVS) & 1);
      sm90::wgmma_fence();
      issue_nt<D, kBK>(s, qw, C::kBQ, kr + ks * C::kTileElems, kBK);
      issue_nt<D, kBK>(dp, dw, C::kBQ, vr + vs * C::kTileElems, kBK);
      sm90::wgmma_commit();
      issue_rs<D, kBK>(acc, da, kr + prev * C::kTileElems);
      sm90::wgmma_wait<1>();   // S_j and dP_j are done; dQ may not be
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      sm90::mbar_arrive(bar.v_empty + vs);
      dq_ds(s, dp, lse_r, di_r, sl2, mask(j * kBK), j * kBK, r_lo, t, p.Tk,
            p.causal);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(da);
      sm90::mbar_arrive(bar.empty + prev);
      sm90::to_operand<In>(dp, da);
    }
    const int last = (n_kv - 1) % kKS;
    sm90::wgmma_fence();
    issue_rs<D, kBK>(acc, da, kr + last * C::kTileElems);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(da);
    sm90::mbar_arrive(bar.empty + last);
  } else {
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % C::kKStages, kv0 = j * kBK;
      const In* kt = kr + st * C::kTileElems;
      const In* vt = vr + st * C::kTileElems;
      sm90::mbar_wait(bar.full + st, (j / C::kKStages) & 1);
      float s[kBK / 2], dp[kBK / 2];
      sm90::wgmma_fence();
      issue_nt<D, kBK>(s, qw, C::kBQ, kt, kBK);
      issue_nt<D, kBK>(dp, dw, C::kBQ, vt, kBK);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      dq_ds(s, dp, lse_r, di_r, sl2, mask(kv0), kv0, r_lo, t, p.Tk,
            p.causal);
      uint32_t da[kBK / 16][4];
      sm90::to_operand<In>(dp, da);
      sm90::wgmma_fence();
      issue_rs<D, kBK>(acc, da, kt);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(da);
      sm90::mbar_arrive(bar.empty + st);
    }
  }
  store_acc<D, OutT>(p.dq, b, h, r_lo, p.Tq, p.Dr, acc, p.scale, t);
}

template <int D, typename In, typename OutT>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Args p) {
  using C = DqTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  In* qs = reinterpret_cast<In*>(base);
  In* dos = qs + C::kQElems;
  In* kr = dos + C::kQElems;
  In* vr = kr + C::kKStages * C::kTileElems;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(vr + C::kVStages * C::kTileElems);
  const DqShared bar{bars, bars + 1, bars + 1 + C::kKStages,
                     bars + 1 + 2 * C::kKStages,
                     bars + 1 + 2 * C::kKStages + C::kVStages};

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // causal: the longest rows first, so the last wave is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;
  const int kv_end = p.causal ? min(p.Tk, q0 + C::kBQ) : p.Tk;
  const int n_kv = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.q_full, 1);
    for (int s = 0; s < C::kKStages; ++s) {
      sm90::mbar_init(bar.full + s, 1);
      sm90::mbar_init(bar.empty + s, 128 * C::kConsumers);
    }
    if constexpr (C::kWide) {
      for (int s = 0; s < C::kVStages; ++s) {
        sm90::mbar_init(bar.v_full + s, 1);
        sm90::mbar_init(bar.v_empty + s, 128);
      }
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0)
      dq_produce<D>(&tq, &tk, &tv, &tdo, qs, dos, kr, vr, bar, b, h, q0,
                    n_kv);
  } else {
    dq_consume<D, In, OutT>(p, qs, dos, kr, vr, bar, threadIdx.x / 128 - 1,
                            b, h, q0, n_kv);
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: tf32 wgmma (see the header)

constexpr int kCols32 = 32;   // fp32 columns of a 128-byte swizzled slab
constexpr int kSlab32 = 64 * kCols32;   // a slab of 64 rows, in floats
constexpr int kMaxSlots32 = 8;          // ring slots of the tf32 kernels

// The shared memory of a tf32 block: kFixed bytes of its own, and a pair of
// operands resident at the whole depth (n_slab slabs each) while at least
// two ring slots of a pair of slabs fit beside them, else streamed, a ring
// slot then holding those two slabs beside the streamed ones.
struct Tf32Plan {
  bool stream;
  int slots, smem;
  __host__ __device__ static Tf32Plan make(int fixed, int n_slab) {
    const int rest = 232448 - fixed, pair = 2 * n_slab * kSlab32 * 4;
    const bool stream = rest - pair < 2 * 2 * kSlab32 * 4;
    const int slot = (stream ? 4 : 2) * kSlab32 * 4;
    int slots = (rest - (stream ? 0 : pair)) / slot;
    slots = slots < kMaxSlots32 ? slots : kMaxSlots32;
    return {stream, slots, fixed + (stream ? 0 : pair) + slots * slot};
  }
  // floats of a ring slot
  __host__ __device__ int slot_elems() const {
    return (stream ? 4 : 2) * kSlab32;
  }
};

// S = A_s B_s^T and dP = A_dp B_dp^T (64 x 64 each, tf32) over the depth's
// slabs of 32 columns, a commit group of eight products a slab: each slab's
// ring slot released once its group has retired, the last one's group left
// in flight and its slot not released (as issue_s_deep). `ops(c, slot)`
// gives slab c's four operands from its ring slot; j counts the slabs taken
// from the ring.
template <typename T>
struct SdpOps {
  const T *a_s, *b_s, *a_dp, *b_dp;
};

template <typename Ops>
__device__ __forceinline__ void issue_sdp_tf32(float (&s)[32], float (&dp)[32],
                                               const float* ring,
                                               int slot_elems,
                                               uint64_t* full,
                                               uint64_t* empty, int n_slab,
                                               int slots, int& j, Ops ops) {
  // slab c's eight products, issued and committed; the first slab's start
  // the sums (peeled off, so no product is issued under a branch)
  auto slab = [&](int c, bool first) {
    const int st = j % slots;
    sm90::mbar_wait(full + st, (j / slots) & 1);
    const SdpOps<float> o = ops(c, ring + st * slot_elems);
#pragma unroll
    for (int kk = 0; kk < kCols32 / 8; ++kk) {
      sm90::Wgmma<64, float>::template ss<0, 0>(
          s, sm90::desc_k_major(o.a_s + kk * 8),
          sm90::desc_k_major(o.b_s + kk * 8), !first || kk > 0);
      sm90::Wgmma<64, float>::template ss<0, 0>(
          dp, sm90::desc_k_major(o.a_dp + kk * 8),
          sm90::desc_k_major(o.b_dp + kk * 8), !first || kk > 0);
    }
    sm90::wgmma_commit();
    ++j;
  };
  slab(0, true);
  for (int c = 1; c < n_slab; ++c) {
    slab(c, false);
    sm90::wgmma_wait<1>();   // slab c - 1's products have retired
    sm90::mbar_arrive(empty + (j - 2) % slots);
  }
}

// acc += A B over a depth of 64, A in registers (a tf32 accumulator as
// to_operand_tf32 gives it), B the transposed tile `bt` (kOut rows of 64
// depth values in to_operand_tf32's order, two slabs of 32); issued, not
// committed.
template <int kOut>
__device__ __forceinline__ void issue_rs_tf32(float (&acc)[kOut / 2],
                                              const uint32_t (&a)[8][4],
                                              const float* bt) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    sm90::Wgmma<kOut, float>::template rs<0>(
        acc, a[kk],
        sm90::desc_k_major(bt + (kk / 4) * kOut * kCols32 + (kk % 4) * 8), 1);
}

// acc += A B as issue_rs_tf32, A an accumulator rounded to tf32 in place
// (sm90::to_tf32 of each element): to_operand_tf32's operands are the same
// registers in another order, so they take no registers of their own.
template <int kOut>
__device__ __forceinline__ void issue_rs_tf32(float (&acc)[kOut / 2],
                                              const float (&d)[32],
                                              const float* bt) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t a[4] = {__float_as_uint(d[4 * kk]),
                           __float_as_uint(d[4 * kk + 2]),
                           __float_as_uint(d[4 * kk + 1]),
                           __float_as_uint(d[4 * kk + 3])};
    sm90::Wgmma<kOut, float>::template rs<0>(
        acc, a,
        sm90::desc_k_major(bt + (kk / 4) * kOut * kCols32 + (kk % 4) * 8), 1);
  }
}

// The statistics of a consumer thread's two rows (dq: lse in log2 units,
// di), read once.
__device__ __forceinline__ void row_stats(const Args& p, int b, int h,
                                          int r_lo, float (&lse_r)[2],
                                          float (&di_r)[2]) {
  const float* lse = p.lse.p + b * p.lse.sb + h * p.lse.sh;
  const float* di = p.di.p + b * p.di.sb + h * p.di.sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    lse_r[i] = r < p.Tq ? lse[r] * kLog2e : 0.f;
    di_r[i] = r < p.Tq ? di[r] : 0.f;
  }
}

// One group's columns of an output view of T: from col0, its head dim less
// col0.
template <typename T>
__device__ __forceinline__ View group_view(View v, int col0) {
  v.p = reinterpret_cast<T*>(v.p) + col0;
  return v;
}

// ---- dq

// The tf32 dq's layout: a block of 64 q rows and the kOut columns of dQ
// from col0 (64, or 128 in groups), S and dP summed over the depth's slabs
// through a ring whose slot holds K_c and V_c (and Q_c and dO_c where Q and
// dO stream: Tf32Plan), K^T (the block's columns) in slots of its own. Warp
// 0 loads (one thread), warps 1-3 round and transpose, warpgroup 1
// consumes.
template <int kOut_>
struct DqTf32 {
  static constexpr int kOut = kOut_;
  static constexpr int kThreads = 256;
  static constexpr int kBQ = 64;
  static constexpr int kKtStages = 2;                // K^T slots
  static constexpr int kKtElems = kBK * kOut;        // a K^T tile
  // K^T, the barriers and room to align the base to 1024 bytes
  static constexpr int kFixed = kKtStages * kKtElems * 4 + 512 + 1024;
  static_assert(kOut % kCols32 == 0 && kOut <= 128, "wgmma's rs members");
  __host__ __device__ static Tf32Plan plan(int n_slab) {
    return Tf32Plan::make(kFixed, n_slab);
  }
};

// The tf32 dq's barriers: Q and dO as loaded (q_raw) and rounded (q_full);
// a ring slot as loaded (raw), rounded (full: the 96 converters) and
// released by the consumer (empty); a K^T slot written (kt_full) and
// released (kt_empty).
struct DqTf32Bars {
  uint64_t *q_raw, *q_full, *raw, *full, *empty, *kt_full, *kt_empty;
};

// The loading thread: Q and dO once where they stay resident, then each kv
// tile's slabs: K_c and V_c, and Q_c and dO_c beside them where they
// stream.
__device__ __forceinline__ void dq_load_tf32(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, float* qs, float* ring, const DqTf32Bars& bar,
    int b, int h, int q0, int n_kv, int n_slab, const Tf32Plan& pl) {
  sm90::prefetch_tensor_map(tq);
  sm90::prefetch_tensor_map(tk);
  sm90::prefetch_tensor_map(tv);
  sm90::prefetch_tensor_map(tdo);
  // streamed, Q and dO complete q_raw with no bytes
  sm90::mbar_arrive_expect_tx(bar.q_raw,
                              pl.stream ? 0 : 2 * n_slab * kSlab32 * 4);
  if (!pl.stream) {
    float* dos = qs + n_slab * kSlab32;
    for (int c = 0; c < n_slab; ++c) {
      sm90::tma_load_4d(qs + c * kSlab32, tq, bar.q_raw, c * kCols32, q0, h,
                        b);
      sm90::tma_load_4d(dos + c * kSlab32, tdo, bar.q_raw, c * kCols32, q0,
                        h, b);
    }
  }
  const int slot = pl.slot_elems();
  int j = 0;
  for (int i = 0; i < n_kv; ++i) {
    for (int c = 0; c < n_slab; ++c, ++j) {
      const int st = j % pl.slots;
      sm90::mbar_wait(bar.empty + st, ((j / pl.slots) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(bar.raw + st, slot * 4);
      float* dst = ring + st * slot;
      sm90::tma_load_4d(dst, tk, bar.raw + st, c * kCols32, i * kBK, h, b);
      sm90::tma_load_4d(dst + kSlab32, tv, bar.raw + st, c * kCols32,
                        i * kBK, h, b);
      if (pl.stream) {
        sm90::tma_load_4d(dst + 2 * kSlab32, tq, bar.raw + st, c * kCols32,
                          q0, h, b);
        sm90::tma_load_4d(dst + 3 * kSlab32, tdo, bar.raw + st, c * kCols32,
                          q0, h, b);
      }
    }
  }
}

// The converters (ct = 0..95): resident Q and dO rounded once, then each kv
// tile's slabs rounded in place, the K slabs of the block's columns also
// transposed into the tile's K^T slot.
template <int kOut>
__device__ __forceinline__ void dq_convert_tf32(float* qs, float* ring,
                                                float* kt,
                                                const DqTf32Bars& bar,
                                                int n_kv, int n_slab,
                                                const Tf32Plan& pl, int col0,
                                                int ct) {
  using C = DqTf32<kOut>;
  if (!pl.stream) {
    sm90::mbar_wait(bar.q_raw, 0);
    sm90::round_tf32(qs, 2 * n_slab * kSlab32, ct);   // Q, then dO
  }
  sm90::fence_proxy_async();
  sm90::mbar_arrive(bar.q_full);
  const int slot = pl.slot_elems();
  int j = 0;
  for (int i = 0; i < n_kv; ++i) {
    const int ks = i % C::kKtStages;
    sm90::mbar_wait(bar.kt_empty + ks, ((i / C::kKtStages) & 1) ^ 1);
    for (int c = 0; c < n_slab; ++c, ++j) {
      const int st = j % pl.slots;
      float* s = ring + st * slot;
      sm90::mbar_wait(bar.raw + st, (j / pl.slots) & 1);
      const int row0 = c * kCols32 - col0;   // K^T's rows of this slab
      if (row0 >= 0 && row0 < kOut)
        sm90::transpose_tf32<kOut, true>(s, kt + ks * C::kKtElems, row0, ct);
      else
        sm90::round_tf32(s, kSlab32, ct);
      // V_c, and Q_c and dO_c where they stream
      sm90::round_tf32(s + kSlab32, slot - kSlab32, ct);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar.full + st);
    }
    sm90::mbar_arrive(bar.kt_full + ks);
  }
}

// The consumer: dQ of the block's 64 q rows and kOut columns over every kv
// tile. S_j and dP_j are issued with dQ += dS_{j-1} K_{j-1}, and dS_j is
// formed while that product is in flight (as the 16-bit dq above D 128).
template <int kOut>
__device__ __forceinline__ void dq_consume_tf32(
    const Args& p, const float* qs, const float* ring, const float* kt,
    const DqTf32Bars& bar, int b, int h, int q0, int n_kv, int n_slab,
    const Tf32Plan& pl, int col0) {
  using C = DqTf32<kOut>;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  float lse_r[2], di_r[2];
  row_stats(p, b, h, r_lo, lse_r, di_r);
  auto mask = [&](int kv0) {
    return kv0 + kBK > p.Tk || (p.causal && kv0 + kBK - 1 > q0);
  };
  // slab c's operands: Q_c and dO_c resident or in the slot, K_c and V_c
  // in the slot
  const float* dos = qs + n_slab * kSlab32;
  const bool stream = pl.stream;
  auto ops = [=](int c, const float* at) {
    return SdpOps<float>{stream ? at + 2 * kSlab32 : qs + c * kSlab32, at,
                         stream ? at + 3 * kSlab32 : dos + c * kSlab32,
                         at + kSlab32};
  };
  const int slot = pl.slot_elems();
  float acc[kOut / 2];
#pragma unroll
  for (int i = 0; i < kOut / 2; ++i) acc[i] = 0.f;
  float s[kBK / 2], dp[kBK / 2];
  uint32_t da[kBK / 8][4];   // dS of the tile whose dQ product is next
  int j = 0;                 // slabs taken from the ring
  sm90::mbar_wait(bar.q_full, 0);
  sm90::wgmma_fence();
  issue_sdp_tf32(s, dp, ring, slot, bar.full, bar.empty, n_slab, pl.slots, j,
                 ops);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
  sm90::mbar_arrive(bar.empty + (j - 1) % pl.slots);
  dq_ds(s, dp, lse_r, di_r, sl2, mask(0), 0, r_lo, t, p.Tk, p.causal);
  sm90::to_operand_tf32(dp, da);
  for (int i = 1; i < n_kv; ++i) {
    const int prev = (i - 1) % C::kKtStages;
    sm90::wgmma_fence();
    issue_sdp_tf32(s, dp, ring, slot, bar.full, bar.empty, n_slab, pl.slots,
                   j, ops);
    sm90::mbar_wait(bar.kt_full + prev, ((i - 1) / C::kKtStages) & 1);
    issue_rs_tf32<kOut>(acc, da, kt + prev * C::kKtElems);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // S_i and dP_i are done; dQ may not be
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::mbar_arrive(bar.empty + (j - 1) % pl.slots);
    dq_ds(s, dp, lse_r, di_r, sl2, mask(i * kBK), i * kBK, r_lo, t, p.Tk,
          p.causal);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(da);
    sm90::mbar_arrive(bar.kt_empty + prev);
    sm90::to_operand_tf32(dp, da);
  }
  const int last = (n_kv - 1) % C::kKtStages;
  sm90::mbar_wait(bar.kt_full + last, ((n_kv - 1) / C::kKtStages) & 1);
  sm90::wgmma_fence();
  issue_rs_tf32<kOut>(acc, da, kt + last * C::kKtElems);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::fence_regs(da);
  sm90::mbar_arrive(bar.kt_empty + last);
  store_acc<kOut, float>(group_view<float>(p.dq, col0), b, h, r_lo, p.Tq,
                         p.Dr - col0, acc, p.scale, t);
}

template <int kOut>
__global__ void __launch_bounds__(DqTf32<kOut>::kThreads, 1)
flash_bwd_dq_sm90_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const Args p) {
  using C = DqTf32<kOut>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const int n_slab = (p.Dr + kCols32 - 1) / kCols32;
  const Tf32Plan pl = C::plan(n_slab);
  float* kt = reinterpret_cast<float*>(base);
  float* ring = kt + C::kKtStages * C::kKtElems;
  float* qs = ring + pl.slots * pl.slot_elems();   // resident Q, then dO
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      qs + (pl.stream ? 0 : 2 * n_slab * kSlab32));
  constexpr int kM = kMaxSlots32;
  const DqTf32Bars bar{bars,          bars + 1,
                       bars + 2,      bars + 2 + kM,
                       bars + 2 + 2 * kM, bars + 2 + 3 * kM,
                       bars + 2 + 3 * kM + C::kKtStages};

  const int groups = (p.Dr + kOut - 1) / kOut;
  const int bh = blockIdx.x / groups, b = bh / p.H, h = bh % p.H;
  const int col0 = blockIdx.x % groups * kOut;
  // causal: the longest rows first, so the last wave is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;
  const int kv_end = p.causal ? min(p.Tk, q0 + C::kBQ) : p.Tk;
  const int n_kv = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.q_raw, 1);
    sm90::mbar_init(bar.q_full, sm90::kConverters);
    for (int s = 0; s < pl.slots; ++s) {
      sm90::mbar_init(bar.raw + s, 1);
      sm90::mbar_init(bar.full + s, sm90::kConverters);
      sm90::mbar_init(bar.empty + s, 128);
    }
    for (int s = 0; s < C::kKtStages; ++s) {
      sm90::mbar_init(bar.kt_full + s, sm90::kConverters);
      sm90::mbar_init(bar.kt_empty + s, 128);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      dq_load_tf32(&tq, &tk, &tv, &tdo, qs, ring, bar, b, h, q0, n_kv,
                   n_slab, pl);
  } else if (threadIdx.x < 128) {
    dq_convert_tf32<kOut>(qs, ring, kt, bar, n_kv, n_slab, pl, col0,
                          threadIdx.x - 32);
  } else {
    dq_consume_tf32<kOut>(p, qs, ring, kt, bar, b, h, q0, n_kv, n_slab, pl,
                          col0);
  }
}

// ---- dk / dv

// The tf32 dk/dv's layout: a block of 64 kv rows and the kOut columns of
// dK and dV from col0 (groups along blockIdx.x), q streamed in tiles of 64
// rows. S^T and dP^T are summed over the depth's slabs through a ring whose
// slot holds Q_c and dO_c (and K_c and V_c where K and V stream:
// Tf32Plan); each q tile's Q^T and dO^T (the block's columns, written by
// the converters) and its lse (log2 units; +inf past Tq) and di rows have
// slots of their own. Warp 0 loads (one thread), warps 1-3 round, transpose
// and write the statistics, warpgroup 1 consumes.
template <int kOut_>
struct DkdvTf32 {
  static constexpr int kOut = kOut_;
  static constexpr int kThreads = 256;
  static constexpr int kTStages = 2;              // Q^T / dO^T slots
  static constexpr int kTElems = kBQ * kOut;      // a Q^T or a dO^T tile
  static constexpr int kStatFloats = 2 * kBQ;     // lse, then di, of a tile
  // the transposed tiles and statistics, the barriers and room to align
  // the base to 1024 bytes
  static constexpr int kFixed =
      kTStages * (2 * kTElems + kStatFloats) * 4 + 512 + 1024;
  static_assert(kOut % kCols32 == 0 && kOut <= 128, "wgmma's rs members");
  __host__ __device__ static Tf32Plan plan(int n_slab) {
    return Tf32Plan::make(kFixed, n_slab);
  }
};

// The tf32 dk/dv's barriers: K and V as loaded (kv_raw) and rounded
// (kv_full); a ring slot as loaded (raw), rounded (full) and released by
// the consumer (empty); a slot of Q^T, dO^T and statistics written
// (t_full) and released (t_empty).
struct DkdvTf32Bars {
  uint64_t *kv_raw, *kv_full, *raw, *full, *empty, *t_full, *t_empty;
};

// The loading thread: K and V once where they stay resident, then each q
// tile's slabs: Q_c and dO_c, and K_c and V_c beside them where they
// stream.
__device__ __forceinline__ void dkdv_load_tf32(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, float* ks, float* ring, const DkdvTf32Bars& bar,
    int b, int h, int kv0, int q_first, int n_q, int n_slab,
    const Tf32Plan& pl) {
  sm90::prefetch_tensor_map(tq);
  sm90::prefetch_tensor_map(tk);
  sm90::prefetch_tensor_map(tv);
  sm90::prefetch_tensor_map(tdo);
  sm90::mbar_arrive_expect_tx(bar.kv_raw,
                              pl.stream ? 0 : 2 * n_slab * kSlab32 * 4);
  if (!pl.stream) {
    float* vs = ks + n_slab * kSlab32;
    for (int c = 0; c < n_slab; ++c) {
      sm90::tma_load_4d(ks + c * kSlab32, tk, bar.kv_raw, c * kCols32, kv0,
                        h, b);
      sm90::tma_load_4d(vs + c * kSlab32, tv, bar.kv_raw, c * kCols32, kv0,
                        h, b);
    }
  }
  const int slot = pl.slot_elems();
  int j = 0;
  for (int i = 0; i < n_q; ++i) {
    const int q0 = q_first + i * kBQ;
    for (int c = 0; c < n_slab; ++c, ++j) {
      const int st = j % pl.slots;
      sm90::mbar_wait(bar.empty + st, ((j / pl.slots) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(bar.raw + st, slot * 4);
      float* dst = ring + st * slot;
      sm90::tma_load_4d(dst, tq, bar.raw + st, c * kCols32, q0, h, b);
      sm90::tma_load_4d(dst + kSlab32, tdo, bar.raw + st, c * kCols32, q0,
                        h, b);
      if (pl.stream) {
        sm90::tma_load_4d(dst + 2 * kSlab32, tk, bar.raw + st, c * kCols32,
                          kv0, h, b);
        sm90::tma_load_4d(dst + 3 * kSlab32, tv, bar.raw + st, c * kCols32,
                          kv0, h, b);
      }
    }
  }
}

// The converters (ct = 0..95): resident K and V rounded once, then each q
// tile's slabs rounded in place, the Q and dO slabs of the block's columns
// also transposed into the tile's Q^T and dO^T slot, which they take (and
// fill with the tile's lse and di rows) at the first of those slabs.
template <int kOut>
__device__ __forceinline__ void dkdv_convert_tf32(
    const Args& p, float* ks, float* ring, float* tt, float* stats,
    const DkdvTf32Bars& bar, int b, int h, int q_first, int n_q, int n_slab,
    const Tf32Plan& pl, int col0, int ct) {
  using C = DkdvTf32<kOut>;
  if (!pl.stream) {
    sm90::mbar_wait(bar.kv_raw, 0);
    sm90::round_tf32(ks, 2 * n_slab * kSlab32, ct);   // K, then V
  }
  sm90::fence_proxy_async();
  sm90::mbar_arrive(bar.kv_full);
  const float* lse = p.lse.p + b * p.lse.sb + h * p.lse.sh;
  const float* di = p.di.p + b * p.di.sb + h * p.di.sh;
  const int slot = pl.slot_elems();
  int j = 0;
  for (int i = 0; i < n_q; ++i) {
    const int ts = i % C::kTStages;
    float* qt = tt + ts * 2 * C::kTElems;   // Q^T, then dO^T
    for (int c = 0; c < n_slab; ++c, ++j) {
      const int st = j % pl.slots;
      float* s = ring + st * slot;
      const int row0 = c * kCols32 - col0;   // Q^T's rows of this slab
      if (row0 == 0) {
        sm90::mbar_wait(bar.t_empty + ts, ((i / C::kTStages) & 1) ^ 1);
        if (ct < kBQ) {
          const int q = q_first + i * kBQ + ct;
          float* ls = stats + ts * C::kStatFloats;
          ls[ct] = q < p.Tq ? lse[q] * kLog2e : INFINITY;
          ls[kBQ + ct] = q < p.Tq ? di[q] : 0.f;
        }
      }
      sm90::mbar_wait(bar.raw + st, (j / pl.slots) & 1);
      if (row0 >= 0 && row0 < kOut) {
        sm90::transpose_tf32<kOut, true>(s, qt, row0, ct);
        sm90::transpose_tf32<kOut, true>(s + kSlab32, qt + C::kTElems, row0,
                                         ct);
      } else {
        sm90::round_tf32(s, 2 * kSlab32, ct);
      }
      if (pl.stream) sm90::round_tf32(s + 2 * kSlab32, 2 * kSlab32, ct);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar.full + st);
    }
    sm90::mbar_arrive(bar.t_full + ts);
  }
}

// P^T and dS^T of q tile i in place of S^T and dP^T: P^T = exp2(S^T *
// scale * log2 e - lse * log2 e), 0 where causal hides the pair (kv row >
// q column, only on a tile that crosses the diagonal), dS^T = P^T o (dP^T -
// di), with the tile's lse and di rows from `ls`.
__device__ __forceinline__ void dkdv_p_ds(float (&s)[32], float (&dp)[32],
                                          const float* ls, float sl2,
                                          bool mask, int q0, int r_lo,
                                          int t) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int c = 8 * (e / 4) + 2 * t + (e & 1);
    float x = exp2f(s[e] * sl2 - ls[c]);
    if (mask && r_lo + 8 * ((e / 2) & 1) > q0 + c) x = 0.f;
    dp[e] = x * (dp[e] - ls[kBQ + c]);
    s[e] = x;
  }
}

// The consumer: dK and dV of the block's 64 kv rows and kOut columns over
// every q tile. At kOut 64, S^T_i and dP^T_i are issued with dV +=
// P^T_{i-1} dO_{i-1} and dK += dS^T_{i-1} Q_{i-1} (one commit group), and
// P^T_i and dS^T_i are formed while those products are in flight. At kOut
// 128 dK and dV take 128 registers, which leaves no room for a second
// tile's S^T and dP^T: the products of a tile follow its S^T and dP^T,
// which become their A operands in place.
template <int kOut>
__device__ __forceinline__ void dkdv_consume_tf32(
    const Args& p, const float* ks, const float* ring, const float* tt,
    const float* stats, const DkdvTf32Bars& bar, int b, int h, int kv0,
    int q_first, int n_q, int n_slab, const Tf32Plan& pl, int col0) {
  using C = DkdvTf32<kOut>;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3, r_lo = kv0 + 16 * warp + (lane >> 2);
  float dv[kOut / 2], dk[kOut / 2];
#pragma unroll
  for (int i = 0; i < kOut / 2; ++i) dv[i] = dk[i] = 0.f;
  if (n_q > 0) {
    const float sl2 = p.scale * kLog2e;
    // slab c's operands: K_c and V_c resident or in the slot, Q_c and dO_c
    // in the slot
    const float* vs = ks + n_slab * kSlab32;
    const bool stream = pl.stream;
    auto ops = [=](int c, const float* at) {
      return SdpOps<float>{stream ? at + 2 * kSlab32 : ks + c * kSlab32,
                           at, stream ? at + 3 * kSlab32 : vs + c * kSlab32,
                           at + kSlab32};
    };
    const int slot = pl.slot_elems();
    float s[kBQ / 2], dp[kBQ / 2];
    int j = 0;   // slabs taken from the ring
    // P^T_i and dS^T_i in s and dp, once the converters have written the
    // tile's statistics
    auto p_ds = [&](int i) {
      const int ts = i % C::kTStages, q0 = q_first + i * kBQ;
      sm90::mbar_wait(bar.t_full + ts, (i / C::kTStages) & 1);
      dkdv_p_ds(s, dp, stats + ts * C::kStatFloats, sl2,
                p.causal && kv0 + kKV - 1 > q0, q0, r_lo, t);
    };
    sm90::mbar_wait(bar.kv_full, 0);
    if constexpr (kOut == 128) {
      for (int i = 0; i < n_q; ++i) {
        const int ts = i % C::kTStages;
        const float* qt = tt + ts * 2 * C::kTElems;
        sm90::wgmma_fence();
        issue_sdp_tf32(s, dp, ring, slot, bar.full, bar.empty, n_slab,
                       pl.slots, j, ops);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::mbar_arrive(bar.empty + (j - 1) % pl.slots);
        p_ds(i);
#pragma unroll
        for (int e = 0; e < kBQ / 2; ++e) {
          s[e] = sm90::to_tf32(s[e]);
          dp[e] = sm90::to_tf32(dp[e]);
        }
        sm90::wgmma_fence();
        issue_rs_tf32<kOut>(dv, s, qt + C::kTElems);
        issue_rs_tf32<kOut>(dk, dp, qt);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::mbar_arrive(bar.t_empty + ts);
      }
    } else {
      // P^T and dS^T of the tile whose dV and dK products are next
      uint32_t pa[kBQ / 8][4], da[kBQ / 8][4];
      // dV += P^T dO and dK += dS^T Q over the tile of slot ts, one group
      auto issue_dvdk = [&](int ts) {
        const float* qt = tt + ts * 2 * C::kTElems;
        issue_rs_tf32<kOut>(dv, pa, qt + C::kTElems);
        issue_rs_tf32<kOut>(dk, da, qt);
        sm90::wgmma_commit();
      };
      sm90::wgmma_fence();
      issue_sdp_tf32(s, dp, ring, slot, bar.full, bar.empty, n_slab,
                     pl.slots, j, ops);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      sm90::mbar_arrive(bar.empty + (j - 1) % pl.slots);
      p_ds(0);
      sm90::to_operand_tf32(s, pa);
      sm90::to_operand_tf32(dp, da);
      for (int i = 1; i < n_q; ++i) {
        const int prev = (i - 1) % C::kTStages;
        sm90::wgmma_fence();
        issue_sdp_tf32(s, dp, ring, slot, bar.full, bar.empty, n_slab,
                       pl.slots, j, ops);
        issue_dvdk(prev);
        // S^T_i and dP^T_i are done; dV and dK may not be
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::mbar_arrive(bar.empty + (j - 1) % pl.slots);
        p_ds(i);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::fence_regs(pa);
        sm90::fence_regs(da);
        sm90::mbar_arrive(bar.t_empty + prev);
        sm90::to_operand_tf32(s, pa);
        sm90::to_operand_tf32(dp, da);
      }
      const int last = (n_q - 1) % C::kTStages;
      sm90::wgmma_fence();
      issue_dvdk(last);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pa);
      sm90::fence_regs(da);
      sm90::mbar_arrive(bar.t_empty + last);
    }
  }
  // a block past every query (causal) stores zeros
  store_acc<kOut, float>(group_view<float>(p.dv, col0), b, h, r_lo, p.Tk,
                         p.Dr - col0, dv, 1.f, t);
  store_acc<kOut, float>(group_view<float>(p.dk, col0), b, h, r_lo, p.Tk,
                         p.Dr - col0, dk, p.scale, t);
}

template <int kOut>
__global__ void __launch_bounds__(DkdvTf32<kOut>::kThreads, 1)
flash_bwd_dkdv_sm90_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const Args p) {
  using C = DkdvTf32<kOut>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const int n_slab = (p.Dr + kCols32 - 1) / kCols32;
  const Tf32Plan pl = C::plan(n_slab);
  float* tt = reinterpret_cast<float*>(base);
  float* ring = tt + C::kTStages * 2 * C::kTElems;
  float* ks = ring + pl.slots * pl.slot_elems();   // resident K, then V
  float* stats = ks + (pl.stream ? 0 : 2 * n_slab * kSlab32);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stats + C::kTStages * C::kStatFloats);
  constexpr int kM = kMaxSlots32;
  const DkdvTf32Bars bar{bars,          bars + 1,
                         bars + 2,      bars + 2 + kM,
                         bars + 2 + 2 * kM, bars + 2 + 3 * kM,
                         bars + 2 + 3 * kM + C::kTStages};

  const int groups = (p.Dr + kOut - 1) / kOut;
  const int bh = blockIdx.x / groups, b = bh / p.H, h = bh % p.H;
  const int col0 = blockIdx.x % groups * kOut;
  // the first kv rows see the most q tiles (causal): they start first
  const int kv0 = blockIdx.y * kKV;
  // causal: key <= query, so the q tiles from the one holding row kv0 on
  const int q_first = p.causal ? (kv0 / kBQ) * kBQ : 0;
  const int n_q = q_first < p.Tq ? (p.Tq - q_first + kBQ - 1) / kBQ : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.kv_raw, 1);
    sm90::mbar_init(bar.kv_full, sm90::kConverters);
    for (int s = 0; s < pl.slots; ++s) {
      sm90::mbar_init(bar.raw + s, 1);
      sm90::mbar_init(bar.full + s, sm90::kConverters);
      sm90::mbar_init(bar.empty + s, 128);
    }
    for (int s = 0; s < C::kTStages; ++s) {
      sm90::mbar_init(bar.t_full + s, sm90::kConverters);
      sm90::mbar_init(bar.t_empty + s, 128);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // a block past every query loads nothing
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0 && n_q > 0)
      dkdv_load_tf32(&tq, &tk, &tv, &tdo, ks, ring, bar, b, h, kv0, q_first,
                     n_q, n_slab, pl);
  } else if (threadIdx.x < 128) {
    if (n_q > 0)
      dkdv_convert_tf32<kOut>(p, ks, ring, tt, stats, bar, b, h, q_first,
                              n_q, n_slab, pl, col0, threadIdx.x - 32);
  } else {
    dkdv_consume_tf32<kOut>(p, ks, ring, tt, stats, bar, b, h, kv0, q_first,
                            n_q, n_slab, pl, col0);
  }
}

// ---------------------------------------------------------------------------
// bf16 and fp16 above head dim 256 (see the header)

constexpr int kSlabElems = 64 * kSlab;   // a 16-bit slab of 64 rows: 8 KB
constexpr int kMaxSlots16 = 8;           // ring slots of the deep kernels

// The shared memory of a deep block: kFixed bytes of its own, and a pair of
// operands resident at the whole depth (n_slab slabs each) while min_slots
// ring slots of a pair of slabs fit beside them, else streamed, a ring slot
// then holding those two slabs beside the streamed ones (Tf32Plan's rule).
struct DeepPlan {
  bool stream;
  int slots, smem;
  __host__ __device__ static DeepPlan make(int fixed, int n_slab,
                                           int min_slots) {
    const int rest = 232448 - fixed, pair = 2 * n_slab * kSlabElems * 2;
    const bool stream = rest - pair < min_slots * 2 * kSlabElems * 2;
    const int slot = (stream ? 4 : 2) * kSlabElems * 2;
    int slots = (rest - (stream ? 0 : pair)) / slot;
    slots = slots < kMaxSlots16 ? slots : kMaxSlots16;
    return {stream, slots, fixed + (stream ? 0 : pair) + slots * slot};
  }
  // 16-bit elements of a ring slot
  __host__ __device__ int slot_elems() const {
    return (stream ? 4 : 2) * kSlabElems;
  }
};

// The order in which a deep block takes the depth's slabs, for a group of
// kG slabs of output columns from slab c0: the slabs after the group first,
// wrapping around, so that the group's own slabs (`keep` of them: fewer
// where the group runs past the views' columns) come last and can stay in
// the ring for the group's products.
struct SlabOrder {
  int n_slab, keep, start;
  __device__ SlabOrder(int n, int c0, int kG)
      : n_slab(n), keep(min(kG, n - c0)), start(c0 + min(kG, n - c0)) {}
  // the slab taken k-th
  __device__ int at(int k) const {
    const int c = start + k;
    return c < n_slab ? c : c - n_slab;
  }
};

// The deep kernels' barriers: the resident pair loaded (res_full); a ring
// slot loaded (full, TMA) and released (empty, the consumer's 128 threads);
// dk/dv's slot of a q tile's statistics written (t_full, a warp) and
// released (t_empty).
struct DeepBars {
  uint64_t *res_full, *full, *empty, *t_full, *t_empty;
};

// S = A_s B_s^T and dP = A_dp B_dp^T (64 x 64 each) over the depth's slabs,
// a commit group of eight products a slab, in the order `ops(k, slot)`
// gives (SlabOrder): each slab's ring slot released once its group has
// retired, but for the last `keep`, which stay until the caller releases
// them; the last slab's group may be in flight on return (as
// issue_sdp_tf32). j counts the slabs taken from the ring.
template <typename In, typename Ops>
__device__ __forceinline__ void issue_sdp_deep(float (&s)[32], float (&dp)[32],
                                               const In* ring, int slot_elems,
                                               const DeepBars& bar, int n_slab,
                                               int keep, int slots, int& j,
                                               Ops ops) {
  // slab k's eight products, issued and committed; the first slab's start
  // the sums (peeled off, so no product is issued under a branch)
  auto slab = [&](int k, bool first) {
    const int st = j % slots;
    sm90::mbar_wait_warp(bar.full + st, (j / slots) & 1);
    const SdpOps<In> o = ops(k, ring + st * slot_elems);
#pragma unroll
    for (int kk = 0; kk < kSlab / 16; ++kk) {
      sm90::Wgmma<64, In>::template ss<0, 0>(
          s, sm90::desc_k_major(o.a_s + kk * 16),
          sm90::desc_k_major(o.b_s + kk * 16), !first || kk > 0);
      sm90::Wgmma<64, In>::template ss<0, 0>(
          dp, sm90::desc_k_major(o.a_dp + kk * 16),
          sm90::desc_k_major(o.b_dp + kk * 16), !first || kk > 0);
    }
    sm90::wgmma_commit();
    ++j;
  };
  slab(0, true);
  for (int k = 1; k < n_slab; ++k) {
    slab(k, false);
    sm90::wgmma_wait<1>();   // slab k - 1's products have retired
    if (k - 1 < n_slab - keep) sm90::mbar_arrive(bar.empty + (j - 2) % slots);
  }
}

// acc += A B over a depth of 64 (four products): A in registers, B one slab
// of 64 depth rows by 64 columns, MN-major; issued, not committed.
template <typename In>
__device__ __forceinline__ void issue_rs_slab(float (&acc)[32],
                                              const uint32_t (&a)[4][4],
                                              const In* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::Wgmma<64, In>::template rs<1>(
        acc, a[kk], sm90::desc_mn_major(b + kk * 16 * kSlab, kSlabElems * 2),
        1);
}

// The ring slot of the group's m-th slab, the tile's slabs taken (j counts
// them to its last): the tile's last `keep`; a slab past the views' columns
// is given the last one, whose products land in columns never stored.
__device__ __forceinline__ int group_slot(int j, int keep, int m,
                                          int slots) {
  return (j - keep + min(m, keep - 1)) % slots;
}

// An accumulator of kG 64-column slabs as one of kG * 64 columns (the
// layout is the same: 32 registers a slab).
template <int kG>
__device__ __forceinline__ auto flat(const float (&acc)[kG][32])
    -> const float (&)[kG * 32] {
  return *reinterpret_cast<const float(*)[kG * 32]>(acc[0]);
}

// The loading thread of a deep block: the pair (maps ra and rb, rows from
// r_row) resident at the whole depth where DeepPlan says it fits, then
// each of n_tiles tiles' slabs in SlabOrder: the streamed operands' (sa
// and sb, rows from s_row0 + 64 i), and the pair's beside them where it
// streams. dk/dv streams Q and dO over K and V, dq K and V over Q and dO.
template <typename In>
__device__ __forceinline__ void load_deep(
    const CUtensorMap* ra, const CUtensorMap* rb, int r_row,
    const CUtensorMap* sa, const CUtensorMap* sb, int s_row0, In* res,
    In* ring, const DeepBars& bar, int b, int h, int n_tiles,
    const SlabOrder& order, const DeepPlan& pl) {
  const int n_slab = order.n_slab;
  sm90::prefetch_tensor_map(ra);
  sm90::prefetch_tensor_map(rb);
  sm90::prefetch_tensor_map(sa);
  sm90::prefetch_tensor_map(sb);
  // streamed, the pair completes res_full with no bytes
  sm90::mbar_arrive_expect_tx(bar.res_full,
                              pl.stream ? 0 : 2 * n_slab * kSlabElems * 2);
  if (!pl.stream) {
    for (int c = 0; c < n_slab; ++c) {
      sm90::tma_load_4d(res + c * kSlabElems, ra, bar.res_full, c * kSlab,
                        r_row, h, b);
      sm90::tma_load_4d(res + (n_slab + c) * kSlabElems, rb, bar.res_full,
                        c * kSlab, r_row, h, b);
    }
  }
  const int slot = pl.slot_elems();
  int j = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int row = s_row0 + i * 64;
    for (int k = 0; k < n_slab; ++k, ++j) {
      const int c = order.at(k), st = j % pl.slots;
      sm90::mbar_wait(bar.empty + st, ((j / pl.slots) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(bar.full + st, slot * 2);
      In* dst = ring + st * slot;
      sm90::tma_load_4d(dst, sa, bar.full + st, c * kSlab, row, h, b);
      sm90::tma_load_4d(dst + kSlabElems, sb, bar.full + st, c * kSlab, row,
                        h, b);
      if (pl.stream) {
        sm90::tma_load_4d(dst + 2 * kSlabElems, ra, bar.full + st,
                          c * kSlab, r_row, h, b);
        sm90::tma_load_4d(dst + 3 * kSlabElems, rb, bar.full + st,
                          c * kSlab, r_row, h, b);
      }
    }
  }
}

// Slab k's four operands of S (S^T) and dP (dP^T) in a deep block: the
// pair's slabs c (resident, or the slot's third and fourth where the pair
// streams) as A, the slot's first two (the streamed operands) as B.
template <typename In>
struct DeepOps {
  SlabOrder order;
  const In* res;
  bool stream;
  __device__ SdpOps<In> operator()(int k, const In* at) const {
    const int c = order.at(k);
    return {stream ? at + 2 * kSlabElems : res + c * kSlabElems, at,
            stream ? at + 3 * kSlabElems
                   : res + (order.n_slab + c) * kSlabElems,
            at + kSlabElems};
  }
};

// ---- dk / dv

// The deep dk/dv's layout: a block of 64 kv rows and the kOut columns of dK
// and dV from col0 (groups along blockIdx.x), q streamed in tiles of 64
// rows. S^T and dP^T are summed over the depth's slabs through a ring whose
// slot holds Q_c and dO_c (and K_c and V_c where K and V stream:
// DeepPlan), the group's own slabs last and kept for its products; each q
// tile's lse (log2 units, +inf past Tq) and di rows have slots of their
// own. Warp 0 loads (one thread), warp 1 writes the statistics, warpgroup 1
// consumes.
template <int kOut_>
struct DkdvDeep {
  static constexpr int kOut = kOut_;
  static constexpr int kGroupSlabs = kOut / kSlab;
  static constexpr int kThreads = 256;
  static constexpr int kTStages = 2;            // statistics slots
  static constexpr int kStatFloats = 2 * kBQ;   // lse, then di, of a tile
  // the statistics, the barriers and room to align the base to 1024 bytes
  static constexpr int kFixed = kTStages * kStatFloats * 4 + 512 + 1024;
  static_assert(kOut % kSlab == 0, "whole slabs of output columns");
  // the group's slabs stay in the ring beside two that stream
  __host__ __device__ static DeepPlan plan(int n_slab) {
    return DeepPlan::make(kFixed, n_slab, kGroupSlabs + 2);
  }
};

// One warp: each q tile's lse (log2 units; +inf past Tq, so P^T is 0 there)
// and di rows into its statistics slot, then the warp's 32 arrivals.
__device__ __forceinline__ void dkdv_stats_deep(const Args& p, float* stats,
                                                const DeepBars& bar, int b,
                                                int h, int q_first,
                                                int n_q) {
  const int lane = threadIdx.x % 32;
  const float* lse = p.lse.p + b * p.lse.sb + h * p.lse.sh;
  const float* di = p.di.p + b * p.di.sb + h * p.di.sh;
  for (int i = 0; i < n_q; ++i) {
    const int ts = i % 2, q0 = q_first + i * kBQ;
    sm90::mbar_wait(bar.t_empty + ts, ((i / 2) & 1) ^ 1);
    float* ls = stats + ts * 2 * kBQ;
    for (int r = lane; r < kBQ; r += 32) {
      const int q = q0 + r;
      ls[r] = q < p.Tq ? lse[q] * kLog2e : INFINITY;
      ls[kBQ + r] = q < p.Tq ? di[q] : 0.f;
    }
    sm90::mbar_arrive(bar.t_full + ts);
  }
}

// The consumer: dK and dV of the block's 64 kv rows and kOut columns over
// every q tile: S^T and dP^T over the depth, P^T and dS^T in place, then
// dV += P^T dO_g and dK += dS^T Q_g, the q tile's slabs of the group's
// columns from the ring as MN-major B operands, slab by slab.
template <int kOut, typename In, typename OutT>
__device__ __forceinline__ void dkdv_consume_deep(
    const Args& p, const In* ks, const In* ring, const float* stats,
    const DeepBars& bar, int b, int h, int kv0, int q_first, int n_q,
    const SlabOrder& order, const DeepPlan& pl, int col0) {
  constexpr int kG = DkdvDeep<kOut>::kGroupSlabs;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3, r_lo = kv0 + 16 * warp + (lane >> 2);
  float dv[kG][32], dk[kG][32];
#pragma unroll
  for (int m = 0; m < kG; ++m)
#pragma unroll
    for (int e = 0; e < 32; ++e) dv[m][e] = dk[m][e] = 0.f;
  if (n_q > 0) {
    const float sl2 = p.scale * kLog2e;
    const int n_slab = order.n_slab, keep = order.keep;
    const DeepOps<In> ops{order, ks, pl.stream};   // K_c, Q_c, V_c, dO_c
    const int slot = pl.slot_elems();
    int j = 0;   // slabs taken from the ring
    sm90::mbar_wait(bar.res_full, 0);
    for (int i = 0; i < n_q; ++i) {
      const int ts = i % 2, q0 = q_first + i * kBQ;
      float s[kBQ / 2], dp[kBQ / 2];
      sm90::wgmma_fence();
      issue_sdp_deep(s, dp, ring, slot, bar, n_slab, keep, pl.slots, j, ops);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      sm90::mbar_wait(bar.t_full + ts, (i / 2) & 1);
      dkdv_p_ds(s, dp, stats + ts * 2 * kBQ, sl2,
                p.causal && kv0 + kKV - 1 > q0, q0, r_lo, t);
      sm90::mbar_arrive(bar.t_empty + ts);
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
      sm90::to_operand<In>(s, pa);
      sm90::to_operand<In>(dp, da);
      sm90::wgmma_fence();
#pragma unroll
      for (int m = 0; m < kG; ++m) {
        const In* g = ring + group_slot(j, keep, m, pl.slots) * slot;
        issue_rs_slab(dv[m], pa, g + kSlabElems);   // dO_c
        issue_rs_slab(dk[m], da, g);                // Q_c
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < kG; ++m) {
        sm90::fence_regs(dv[m]);
        sm90::fence_regs(dk[m]);
      }
      sm90::fence_regs(pa);
      sm90::fence_regs(da);
      for (int m = 0; m < keep; ++m)
        sm90::mbar_arrive(bar.empty + (j - keep + m) % pl.slots);
    }
  }
  // a block past every query (causal) stores zeros
  store_acc<kOut, OutT>(group_view<OutT>(p.dv, col0), b, h, r_lo, p.Tk,
                        p.Dr - col0, flat(dv), 1.f, t);
  store_acc<kOut, OutT>(group_view<OutT>(p.dk, col0), b, h, r_lo, p.Tk,
                        p.Dr - col0, flat(dk), p.scale, t);
}

template <int kOut, typename In, typename OutT>
__global__ void __launch_bounds__(DkdvDeep<kOut>::kThreads, 1)
flash_bwd_dkdv_sm90_kernel_deep(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const Args p) {
  using C = DkdvDeep<kOut>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const int n_slab = (p.Dr + kSlab - 1) / kSlab;
  const DeepPlan pl = C::plan(n_slab);
  In* ring = reinterpret_cast<In*>(base);
  In* ks = ring + pl.slots * pl.slot_elems();   // resident K, then V
  float* stats = reinterpret_cast<float*>(
      ks + (pl.stream ? 0 : 2 * n_slab * kSlabElems));
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stats + C::kTStages * C::kStatFloats);
  constexpr int kM = kMaxSlots16;
  const DeepBars bar{bars, bars + 1, bars + 1 + kM, bars + 1 + 2 * kM,
                     bars + 1 + 2 * kM + C::kTStages};

  const int groups = (p.Dr + kOut - 1) / kOut;
  const int bh = blockIdx.x / groups, b = bh / p.H, h = bh % p.H;
  const int col0 = blockIdx.x % groups * kOut;
  // the first kv rows see the most q tiles (causal): they start first
  const int kv0 = blockIdx.y * kKV;
  // causal: key <= query, so the q tiles from the one holding row kv0 on
  const int q_first = p.causal ? (kv0 / kBQ) * kBQ : 0;
  const int n_q = q_first < p.Tq ? (p.Tq - q_first + kBQ - 1) / kBQ : 0;
  const SlabOrder order(n_slab, col0 / kSlab, C::kGroupSlabs);

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.res_full, 1);
    for (int s = 0; s < pl.slots; ++s) {
      sm90::mbar_init(bar.full + s, 1);
      sm90::mbar_init(bar.empty + s, 128);
    }
    for (int s = 0; s < C::kTStages; ++s) {
      sm90::mbar_init(bar.t_full + s, 32);
      sm90::mbar_init(bar.t_empty + s, 128);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // a block past every query loads nothing
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0 && n_q > 0)
      load_deep(&tk, &tv, kv0, &tq, &tdo, q_first, ks, ring, bar, b, h, n_q,
                order, pl);
  } else if (threadIdx.x < 64) {
    if (n_q > 0) dkdv_stats_deep(p, stats, bar, b, h, q_first, n_q);
  } else if (threadIdx.x >= 128) {
    dkdv_consume_deep<kOut, In, OutT>(p, ks, ring, stats, bar, b, h, kv0,
                                      q_first, n_q, order, pl, col0);
  }
}

// ---- dq

// The deep dq's layout: a block of 64 q rows and the kOut columns of dQ
// from col0, S and dP summed over the depth's slabs through a ring whose
// slot holds K_c and V_c (and Q_c and dO_c where Q and dO stream:
// DeepPlan), the group's own slabs last and kept for dQ += dS K_g. Warp 0
// loads (one thread), warpgroup 1 consumes.
template <int kOut_>
struct DqDeep {
  static constexpr int kOut = kOut_;
  static constexpr int kGroupSlabs = kOut / kSlab;
  static constexpr int kThreads = 256;
  static constexpr int kBQ = 64;
  // the barriers and room to align the base to 1024 bytes
  static constexpr int kFixed = 512 + 1024;
  static_assert(kOut % kSlab == 0, "whole slabs of output columns");
  __host__ __device__ static DeepPlan plan(int n_slab) {
    return DeepPlan::make(kFixed, n_slab, kGroupSlabs + 2);
  }
};

// The consumer: dQ of the block's 64 q rows and kOut columns over every kv
// tile: S and dP over the depth, dS in place of dP, then dQ += dS K_g, the
// kv tile's slabs of the group's columns from the ring, slab by slab.
template <int kOut, typename In, typename OutT>
__device__ __forceinline__ void dq_consume_deep(
    const Args& p, const In* qs, const In* ring, const DeepBars& bar, int b,
    int h, int q0, int n_kv, const SlabOrder& order, const DeepPlan& pl,
    int col0) {
  constexpr int kG = DqDeep<kOut>::kGroupSlabs;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  float lse_r[2], di_r[2];
  row_stats(p, b, h, r_lo, lse_r, di_r);
  auto mask = [&](int kv0) {
    return kv0 + kBK > p.Tk || (p.causal && kv0 + kBK - 1 > q0);
  };
  const int n_slab = order.n_slab, keep = order.keep;
  const DeepOps<In> ops{order, qs, pl.stream};   // Q_c, K_c, dO_c, V_c
  const int slot = pl.slot_elems();
  float acc[kG][32];
#pragma unroll
  for (int m = 0; m < kG; ++m)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;
  int j = 0;   // slabs taken from the ring
  sm90::mbar_wait(bar.res_full, 0);
  for (int i = 0; i < n_kv; ++i) {
    float s[kBK / 2], dp[kBK / 2];
    sm90::wgmma_fence();
    issue_sdp_deep(s, dp, ring, slot, bar, n_slab, keep, pl.slots, j, ops);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    dq_ds(s, dp, lse_r, di_r, sl2, mask(i * kBK), i * kBK, r_lo, t, p.Tk,
          p.causal);
    uint32_t da[kBK / 16][4];
    sm90::to_operand<In>(dp, da);
    sm90::wgmma_fence();
#pragma unroll
    for (int m = 0; m < kG; ++m)   // K_c of the group's slabs
      issue_rs_slab(acc[m], da,
                    ring + group_slot(j, keep, m, pl.slots) * slot);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < kG; ++m) sm90::fence_regs(acc[m]);
    sm90::fence_regs(da);
    for (int m = 0; m < keep; ++m)
      sm90::mbar_arrive(bar.empty + (j - keep + m) % pl.slots);
  }
  store_acc<kOut, OutT>(group_view<OutT>(p.dq, col0), b, h, r_lo, p.Tq,
                        p.Dr - col0, flat(acc), p.scale, t);
}

template <int kOut, typename In, typename OutT>
__global__ void __launch_bounds__(DqDeep<kOut>::kThreads, 1)
flash_bwd_dq_sm90_kernel_deep(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const Args p) {
  using C = DqDeep<kOut>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const int n_slab = (p.Dr + kSlab - 1) / kSlab;
  const DeepPlan pl = C::plan(n_slab);
  In* ring = reinterpret_cast<In*>(base);
  In* qs = ring + pl.slots * pl.slot_elems();   // resident Q, then dO
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      qs + (pl.stream ? 0 : 2 * n_slab * kSlabElems));
  constexpr int kM = kMaxSlots16;
  const DeepBars bar{bars, bars + 1, bars + 1 + kM, nullptr, nullptr};

  const int groups = (p.Dr + kOut - 1) / kOut;
  const int bh = blockIdx.x / groups, b = bh / p.H, h = bh % p.H;
  const int col0 = blockIdx.x % groups * kOut;
  // causal: the longest rows first, so the last wave is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;
  const int kv_end = p.causal ? min(p.Tk, q0 + C::kBQ) : p.Tk;
  const int n_kv = (kv_end + kBK - 1) / kBK;
  const SlabOrder order(n_slab, col0 / kSlab, C::kGroupSlabs);

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar.res_full, 1);
    for (int s = 0; s < pl.slots; ++s) {
      sm90::mbar_init(bar.full + s, 1);
      sm90::mbar_init(bar.empty + s, 128);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0)
      load_deep(&tq, &tdo, q0, &tk, &tv, 0, qs, ring, bar, b, h, n_kv, order,
                pl);
  } else {
    dq_consume_deep<kOut, In, OutT>(p, qs, ring, bar, b, h, q0, n_kv, order,
                                    pl, col0);
  }
}

// ---------------------------------------------------------------------------
// launch

// The tensor maps of q, k, v and dout at the views' head dim (Dr), in boxes
// of q_rows and kv_rows rows.
template <typename In>
cudaError_t maps(const Args& a, int q_rows, int kv_rows,
                 CUtensorMap (&m)[4]) {
  const View* in[4] = {&a.q, &a.k, &a.v, &a.dout};
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    const cudaError_t err = sm90::bhtd_map<In>(
        &m[i], in[i]->p, a.B, a.H, is_q ? a.Tq : a.Tk, a.Dr, in[i]->sb,
        in[i]->sh, in[i]->st, is_q ? q_rows : kv_rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One launch of `kernel` over (B * H * groups, blocks) in blocks of
// `threads`, with the q, k, v and dout maps in boxes of q_rows and kv_rows
// rows.
template <typename In, typename K>
cudaError_t launch(K kernel, int threads, int smem, int q_rows, int kv_rows,
                   int blocks, const Args& a, cudaStream_t stream,
                   int groups = 1) {
  CUtensorMap m[4];
  cudaError_t err = maps<In>(a, q_rows, kv_rows, m);
  if (err != cudaSuccess) return err;
  // the attribute belongs to the current device: set at every launch
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.B * a.H * groups), (unsigned)blocks);
  kernel<<<grid, threads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

template <int D, typename In, typename OutT>
struct Dkdv {
  static cudaError_t run(const Args& a, cudaStream_t s) {
    using C = DkdvTiles<D>;
    return launch<In>(flash_bwd_dkdv_sm90_kernel<D, In, OutT>, C::kThreads,
                      C::kSmem, kBQ, kKV, (a.Tk + kKV - 1) / kKV, a, s);
  }
};

template <int D, typename In, typename OutT>
struct Dq {
  static cudaError_t run(const Args& a, cudaStream_t s) {
    using C = DqTiles<D>;
    return launch<In>(flash_bwd_dq_sm90_kernel<D, In, OutT>, C::kThreads,
                      C::kSmem, C::kBQ, kBK, (a.Tq + C::kBQ - 1) / C::kBQ, a,
                      s);
  }
};

// fp32 inputs: the tf32 kernels, the output columns in groups of kOut along
// blockIdx.x.
template <int kOut>
cudaError_t dq_tf32(const Args& a, cudaStream_t stream) {
  using C = DqTf32<kOut>;
  const int n_slab = (a.Dr + kCols32 - 1) / kCols32;
  return launch<float>(flash_bwd_dq_sm90_tf32_kernel<kOut>, C::kThreads,
                       C::plan(n_slab).smem, C::kBQ, kBK,
                       (a.Tq + C::kBQ - 1) / C::kBQ, a, stream,
                       (a.Dr + kOut - 1) / kOut);
}

template <int kOut>
cudaError_t dkdv_tf32(const Args& a, cudaStream_t stream) {
  using C = DkdvTf32<kOut>;
  const int n_slab = (a.Dr + kCols32 - 1) / kCols32;
  return launch<float>(flash_bwd_dkdv_sm90_tf32_kernel<kOut>, C::kThreads,
                       C::plan(n_slab).smem, kBQ, kKV, (a.Tk + kKV - 1) / kKV,
                       a, stream, (a.Dr + kOut - 1) / kOut);
}

// bf16 and fp16 above head dim 256: the deep kernels, the output columns
// in groups along blockIdx.x: dK's and dV's in groups of 128, dQ's in the
// fewest groups of 192 or 256, then the narrower (D 320: 2 x 192).
template <int kOut, typename In, typename OutT>
cudaError_t dkdv_deep(const Args& a, cudaStream_t stream) {
  using C = DkdvDeep<kOut>;
  const int n_slab = (a.Dr + kSlab - 1) / kSlab;
  return launch<In>(flash_bwd_dkdv_sm90_kernel_deep<kOut, In, OutT>,
                    C::kThreads, C::plan(n_slab).smem, kBQ, kKV,
                    (a.Tk + kKV - 1) / kKV, a, stream,
                    (a.Dr + kOut - 1) / kOut);
}

template <int kOut, typename In, typename OutT>
cudaError_t dq_deep(const Args& a, cudaStream_t stream) {
  using C = DqDeep<kOut>;
  const int n_slab = (a.Dr + kSlab - 1) / kSlab;
  return launch<In>(flash_bwd_dq_sm90_kernel_deep<kOut, In, OutT>,
                    C::kThreads, C::plan(n_slab).smem, C::kBQ, kBK,
                    (a.Tq + C::kBQ - 1) / C::kBQ, a, stream,
                    (a.Dr + kOut - 1) / kOut);
}

template <typename In, typename OutT>
struct DkdvAbove256 {
  static cudaError_t run(const Args& a, cudaStream_t s) {
    return dkdv_deep<128, In, OutT>(a, s);
  }
};

template <typename In, typename OutT>
struct DqAbove256 {
  static cudaError_t run(const Args& a, cudaStream_t s) {
    return (a.Dr + 191) / 192 <= (a.Dr + 255) / 256
               ? dq_deep<192, In, OutT>(a, s)
               : dq_deep<256, In, OutT>(a, s);
  }
};

// The instance for the arguments' head dim, input type and output type:
// D 64, 128, 192 and 256, and the deep kernel (Deep) above 256.
template <template <int, typename, typename> class F,
          template <typename, typename> class Deep, typename In,
          typename OutT>
cudaError_t pick_d(const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 64:
      return F<64, In, OutT>::run(a, stream);
    case 128:
      return F<128, In, OutT>::run(a, stream);
    case 192:
      return F<192, In, OutT>::run(a, stream);
    case 256:
      return F<256, In, OutT>::run(a, stream);
    default:   // run() gives a multiple of 64 above 128
      return Deep<In, OutT>::run(a, stream);
  }
}

template <template <int, typename, typename> class F,
          template <typename, typename> class Deep>
cudaError_t pick(const Args& a, cudaStream_t stream) {
  typedef __nv_bfloat16 bf16;
  if (a.dtype == flash::kF16)
    return a.out_f32 ? pick_d<F, Deep, __half, float>(a, stream)
                     : pick_d<F, Deep, __half, __half>(a, stream);
  return a.out_f32 ? pick_d<F, Deep, bf16, float>(a, stream)
                   : pick_d<F, Deep, bf16, bf16>(a, stream);
}

}  // namespace

namespace flash {

// (dk, dv) under the given lse and di, over [B, H, T, Dr] views: bf16 or
// fp16 on the instance of head dim D = 64, 128, 192 or 256, above 256 on the
// deep kernel, outputs in the input type or fp32 (out_f32); fp32 at any D
// on the tf32 kernel, dK's and dV's columns in one group of 64 at D 64,
// else in groups of 128, outputs fp32.
cudaError_t bwd_dkdv_sm90(const Args& a, cudaStream_t stream) {
  if (a.dtype == kF32)
    return a.D == 64 ? dkdv_tf32<64>(a, stream) : dkdv_tf32<128>(a, stream);
  return pick<Dkdv, DkdvAbove256>(a, stream);
}

// dq under the given lse and di: bf16 or fp16 as bwd_dkdv_sm90, and fp32 at
// any D on the tf32 kernel, in one group of 64 columns at D 64, else in
// groups of 128.
cudaError_t bwd_dq_sm90(const Args& a, cudaStream_t stream) {
  if (a.dtype == kF32)
    return a.D == 64 ? dq_tf32<64>(a, stream) : dq_tf32<128>(a, stream);
  return pick<Dq, DqAbove256>(a, stream);
}

}  // namespace flash
