// What the attention sources share: the arguments of one launch (every
// attention kernel takes them as its parameter), and the functions that
// flash_fwd_sm90.cu and flash_bwd_sm90.cu give the C entry points in
// flash_attn.cu.
//
// The Hopper kernels (TMA and wgmma) take every launch: the forward at any
// D and input type (bf16 and fp16: 320, 384 and 512 have instances of
// their own, and above 512 one kernel takes every D; fp32 on tf32 in
// groups of 64 or 128 of O's columns), fp32 dk/dv and dq at any D (tf32,
// the output columns in groups), and bf16 and fp16 dk/dv and dq at D = 64,
// 128, 192 or 256 and, above 256, on one deep kernel each (the output
// columns in groups, S and dP summed over the depth's slabs). D is 64, 128
// or a multiple of 64 above, the head dim of the kernel instance, which
// run() derives from the views' own head dim Dr. Dr may be less (at least
// 2 and even; the forward runs 448 on 512): the kernels read the views
// through tensor maps whose inner dimension is Dr, which TMA fills with
// zeros up to D, and store only columns below Dr. q has Tq rows and k, v Tk
// rows. Causal means the library kernel's rule: key <= query by absolute
// index.

#pragma once

#include <cuda_runtime.h>

namespace flash {

enum DType { kBF16 = 0, kF16 = 1, kF32 = 2 };

// A [B, H, T, D] view, D contiguous: base pointer and the element strides
// of B, H and T.
struct View {
  void* p;
  long long sb, sh, st;
};

// A [B, H, T] fp32 statistic (lse, di): base pointer and the element
// strides of B and H (the T stride is 1).
struct Stat {
  float* p;
  long long sb, sh;
};

struct Args {
  View q, k, v, o, dout, dq, dk, dv;
  Stat lse, di;
  int B, H, Tq, Tk, D, causal, dtype;
  int Dr;        // the views' head dim: Dr <= D, the rest reads as zeros
  int out_f32;   // fp32 outputs (K7) instead of the input type (K6)
  float scale;
};

// The Hopper kernels: the forward, dk/dv and dq for every dtype.
cudaError_t fwd_sm90(const Args& a, cudaStream_t stream);
cudaError_t bwd_dkdv_sm90(const Args& a, cudaStream_t stream);
cudaError_t bwd_dq_sm90(const Args& a, cudaStream_t stream);

}  // namespace flash
