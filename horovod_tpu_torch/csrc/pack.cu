// Fusion-buffer pack: N tensors -> one flat buffer, in one launch.
//
// Replaces horovod_tpu/ops/pallas_kernels.py:pack_pallas (the Pallas
// fusion packer, one DMA-style copy per tensor at prefix-sum offsets).
//
// What bounds it on an H100: bytes. Every input byte is read once and written
// once, 2 x 102 MB for ResNet-50's fp32 gradients, about 61 us at 3.35 TB/s.
// There is no arithmetic.
//
// Design. The wrapper cuts every tensor into tiles of at most kTileBytes and
// uploads one row per tensor (source pointer, destination byte offset, byte
// count, index of its first tile) with a single host-to-device copy. Block b
// copies tile b: it finds its tensor by a binary search over the rows, then
// copies 16 bytes a thread where source and destination share their
// alignment modulo 16, 4 bytes where they share it modulo 4, and single bytes
// otherwise, with scalar heads and tails. Tiles keep the blocks equal in work
// whatever the spread of tensor sizes (161 ResNet-50 gradients run from 256 B
// to 9.4 MB). The copy is dtype-agnostic and bitwise.
//
// Unpack needs no kernel: the reduced outputs are views of the reduced flat
// buffer at the same offsets (the reference's _unpack_flat slices), which
// copy nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kTileBytes = 64 * 1024;
constexpr int kThreads = 256;

struct PackRow {
  unsigned long long src;         // device pointer of the source tensor
  unsigned long long dst_offset;  // byte offset in the flat buffer
  unsigned long long nbytes;      // bytes of the source tensor
  unsigned long long first_tile;  // index of the tensor's first tile
};

template <typename V>
__device__ __forceinline__ void copy_words(const char* src, char* dst,
                                           long long n) {
  // src and dst share their alignment modulo sizeof(V): copy a scalar head
  // up to the boundary, whole words, then a scalar tail.
  long long head = (long long)((sizeof(V) - ((uintptr_t)src % sizeof(V))) %
                               sizeof(V));
  if (head > n) head = n;
  for (long long i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const V* s = reinterpret_cast<const V*>(src + head);
  V* d = reinterpret_cast<V*>(dst + head);
  long long words = (n - head) / (long long)sizeof(V);
  for (long long i = threadIdx.x; i < words; i += blockDim.x) d[i] = s[i];
  long long done = head + words * (long long)sizeof(V);
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

__global__ void pack_kernel(const PackRow* __restrict__ rows, int n_rows,
                            char* __restrict__ out) {
  const unsigned long long tile = blockIdx.x;
  // last row whose first_tile <= tile
  int lo = 0, hi = n_rows - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (rows[mid].first_tile <= tile) lo = mid; else hi = mid - 1;
  }
  const PackRow r = rows[lo];
  long long start = (long long)(tile - r.first_tile) * kTileBytes;
  long long n = (long long)r.nbytes - start;
  if (n > kTileBytes) n = kTileBytes;
  if (n <= 0) return;
  const char* src = reinterpret_cast<const char*>(r.src) + start;
  char* dst = out + r.dst_offset + start;
  uintptr_t mis = (uintptr_t)src ^ (uintptr_t)dst;
  if ((mis & 15) == 0) {
    copy_words<uint4>(src, dst, n);
  } else if ((mis & 3) == 0) {
    copy_words<uint32_t>(src, dst, n);
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

}  // namespace

extern "C" {

long long hvd_pack_tile_bytes() { return kTileBytes; }

// device: CUDA ordinal of out and the stream (this library's runtime keeps
// its own current device). rows: device array of n_rows PackRow; n_tiles:
// the tiles over all rows.
int hvd_pack(int device, const void* rows, int n_rows, long long n_tiles,
             void* out, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pack_kernel<<<(unsigned int)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const PackRow*>(rows), n_rows,
      reinterpret_cast<char*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
