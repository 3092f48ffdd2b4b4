// Block-sigma scramble S^k for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `scramble_blocks_pallas`
// (src/repro/kernels/scramble_kernel.py, body `_copy_kernel`).  On a g x g
// grid of (bm, bn) blocks over the trailing two dims of x,
//
//     output block (i, j) = input block perm[i*g + j],   perm = S^k
//
// for every leading index.  The kernel moves bytes and does no arithmetic,
// so it matches the plain version and the reference bit for bit, for any
// element type (it copies raw bytes; the wrapper passes the element size).
//
// What bounds it on this card: bytes.  Every element is read once and
// written once, so its bound is 2 * numel * itemsize / 3.35 TB/s (about
// 10 us for the (2, 2048, 2048) bf16 activations of mesh-paper training).
//
// Design.  On the TPU the permutation is free: the BlockSpec index map reads
// perm from scalar prefetch and the HBM->VMEM block schedule does the
// gather.  Here each CTA computes its own source offset instead: one CTA per
// (output block, row chunk), leading indices on blockIdx.z (grid-strided past
// 65535), reads its source block from an int32 table the wrapper uploaded
// once per (g, k).  Each thread moves 16 bytes and neighbouring threads take
// neighbouring addresses, so a 128-wide bf16 block row (256 bytes) is 16
// threads and every warp loads two whole rows, coalesced.  No shared memory
// is needed: nothing is reused, and the loads already coalesce.  A 16-byte
// chunk that runs past the block row, or whose source or destination is not
// 16-byte aligned (odd widths, odd element sizes), is copied byte by byte.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void __launch_bounds__(256)
scramble_blocks_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                       const int* __restrict__ perm, int g, int bm, int rows_per_cta,
                       long long row_bytes, long long ld_bytes, long long mat_bytes,
                       int lead) {
  const int cell = blockIdx.x;  // output block (i, j), row-major
  const int i = cell / g, j = cell % g;
  const int src = perm[cell];
  const int p = src / g, q = src % g;
  const int r0 = blockIdx.y * rows_per_cta;
  const int rows = min(rows_per_cta, bm - r0);
  if (rows <= 0) return;
  const long long chunks_per_row = (row_bytes + 15) / 16;
  const long long work = rows * chunks_per_row;

  for (long long z = blockIdx.z; z < lead; z += gridDim.z) {
    const unsigned char* in_blk =
        x + z * mat_bytes + (long long)(p * bm + r0) * ld_bytes + q * row_bytes;
    unsigned char* out_blk =
        out + z * mat_bytes + (long long)(i * bm + r0) * ld_bytes + j * row_bytes;
    for (long long e = threadIdx.x; e < work; e += blockDim.x) {
      const long long r = e / chunks_per_row;
      const long long off = (e % chunks_per_row) * 16;
      const unsigned char* s = in_blk + r * ld_bytes + off;
      unsigned char* d = out_blk + r * ld_bytes + off;
      const long long n = min(16LL, row_bytes - off);
      if (n == 16 && ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0) {
        *reinterpret_cast<uint4*>(d) = __ldg(reinterpret_cast<const uint4*>(s));
      } else {
        for (long long b = 0; b < n; ++b) d[b] = s[b];
      }
    }
  }
}

}  // namespace

// x, out: (lead, g*bm, g*bn) contiguous, elements of `itemsize` bytes; perm:
// int32 (g*g,) on the device.  Returns cudaGetLastError() after the launch.
extern "C" int scramble_blocks_launch(const void* x, void* out, const void* perm, int lead,
                                      int g, int bm, int bn, int itemsize, int rows_per_cta,
                                      void* stream) {
  const long long row_bytes = (long long)bn * itemsize;
  const long long ld_bytes = (long long)g * row_bytes;
  const long long mat_bytes = (long long)g * bm * ld_bytes;
  const dim3 grid(g * g, (bm + rows_per_cta - 1) / rows_per_cta, lead < 65535 ? lead : 65535);
  scramble_blocks_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      static_cast<const int*>(perm), g, bm, rows_per_cta, row_bytes, ld_bytes, mat_bytes,
      lead);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scramble_blocks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
