// Grouped (ragged-batch) mesh GEMM for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.  This is kernel K5 of the port.
//
// Replaces the Pallas TPU kernel `grouped_mesh_matmul_pallas`
// (src/repro/kernels/grouped.py, body `_make_grouped_kernel`).  Tokens arrive
// group-major in the MoE capacity layout, (G * rpg, K): group g owns rows
// [g * rpg, g * rpg + sizes[g]).  For every row r of group g = r / rpg:
//
//     out[r] = act(tokens[r] . W[g] + bias[g]) + residual[r]   if r - g*rpg < sizes[g]
//     out[r] = 0                                                otherwise
//
// with an f32 accumulator over the plan's logical (block_m, block_n,
// block_k) blocks.  Cell (g, i, j) walks its k blocks in the staggered order
// (g + i + j + k) mod nk, and the epilogue runs on the f32 accumulator
// before the one cast to the output type.
//
// What bounds it on this card.  In OLMoE serving, a decode tick gives each
// expert at most a few rows (rpg = 8), so every non-empty expert's weight
// slab (12.6 MB for wi + wo) is read once for a handful of FMAs per byte:
// the kernel is bound by the bytes of the weights of the non-empty experts
// (3.35 TB/s).  A prefill gives 128-row blocks and sits near the bf16 ridge.
// What the design does about it:
//   * one CTA per (group, row tile, column tile), the group on blockIdx.z;
//   * `sizes` is read on the device, so the host never waits on routing;
//   * a CTA whose first row is at or past its group's size writes its
//     zeros and returns before it reads any weight: an empty expert costs
//     no weight traffic, and a short expert skips its empty row tiles (the
//     TPU kernel skips whole logical row blocks; a CTA tile is finer);
//   * rows of a live tile past the group's size are not loaded (their
//     tokens count as 0) and are stored as exact zeros;
//   * two tile shapes, as in the mesh GEMM (csrc/mesh_matmul.cu): 8 x 32
//     with a 128-deep k step for decode-sized blocks (block_m <= 16), and
//     64 x 64 for prompt-sized ones.  A tile never crosses a logical block,
//     so the k order is that of the logical blocks; ragged N and K edges
//     are masked, not padded.
// SIMT FMA in f32 (never TF32: the contract is f32 accumulation of exact
// products).  wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

// One CTA computes a TM x TN tile of one logical block (g, i, j); each thread
// owns RM x RN outputs strided by the thread grid (conflict-free shared reads).
template <typename T, typename OutT, int TM, int TN, int TK, int RM, int RN>
__global__ void __launch_bounds__((TM / RM) * (TN / RN))
grouped_matmul_kernel(const T* __restrict__ A, const T* __restrict__ W,
                      const int* __restrict__ sizes, const float* __restrict__ bias,
                      const float* __restrict__ residual, OutT* __restrict__ C,
                      int rpg, int N, int K, int bm, int bn, int bk, int tiles_m,
                      int tiles_n, int stagger, int act) {
  constexpr int kThreadsN = TN / RN;
  constexpr int kThreadsM = TM / RM;
  constexpr int kThreads = kThreadsM * kThreadsN;
  __shared__ float As[TK][TM + 1];  // +1: conflict-free transposed stores
  __shared__ float Bs[TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN;
  const int ty = tid / kThreadsN;

  // Logical cell (g, i, j) and this CTA's tile inside it.
  const int g = blockIdx.z;
  const int j = blockIdx.x / tiles_n;
  const int i = blockIdx.y / tiles_m;
  const int lr0 = (blockIdx.y % tiles_m) * TM;
  const int lc0 = (blockIdx.x % tiles_n) * TN;
  const int rows = min(TM, bm - lr0);
  const int cols = min(TN, bn - lc0);
  const int r0 = i * bm + lr0;  // first row of the tile inside its group
  const int c0 = j * bn + lc0;
  if (c0 >= N) return;  // whole tile past the ragged N edge

  const int size = sizes[g];
  const long long row0 = (long long)g * rpg + r0;  // first row of the tile in C
  if (r0 >= size) {
    // Ragged steering: no valid row here.  Zeros, and no weight read.
    for (int e = tid; e < rows * TN; e += kThreads) {
      const int r = e / TN, c = e % TN;
      if (c < cols && c0 + c < N) C[(row0 + r) * N + c0 + c] = from_f32<OutT>(0.0f);
    }
    return;
  }
  const int live = min(rows, size - r0);  // rows of the tile inside the group's size
  A += row0 * K;
  W += (long long)g * K * N;

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.0f;

  const int nk = (K + bk - 1) / bk;
  for (int ks = 0; ks < nk; ++ks) {
    const int kb = stagger ? (g + i + j + ks) % nk : ks;
    const int k_begin = kb * bk;
    const int k_end = min(k_begin + bk, K);
    for (int k0 = k_begin; k0 < k_end; k0 += TK) {
      for (int e = tid; e < TM * TK; e += kThreads) {
        const int r = e / TK, kk = e % TK;
        const int gk = k0 + kk;
        float v = 0.0f;
        if (r < live && gk < k_end) v = to_f32(A[(long long)r * K + gk]);
        As[kk][r] = v;
      }
      for (int e = tid; e < TK * TN; e += kThreads) {
        const int kk = e / TN, c = e % TN;
        const int gk = k0 + kk, gc = c0 + c;
        float v = 0.0f;
        if (c < cols && gc < N && gk < k_end) v = to_f32(W[(long long)gk * N + gc]);
        Bs[kk][c] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        float av[RM], bv[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r) av[r] = As[kk][ty + r * kThreadsM];
#pragma unroll
        for (int c = 0; c < RN; ++c) bv[c] = Bs[kk][tx + c * kThreadsN];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

  // Epilogue on the f32 accumulator; rows past the group's size store 0.
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int lr = ty + r * kThreadsM;
    if (lr >= rows) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int lc = tx + c * kThreadsN;
      const int sc = c0 + lc;
      if (lc >= cols || sc >= N) continue;
      float v = 0.0f;
      if (lr < live) {
        v = acc[r][c];
        if (bias != nullptr) v += bias[(long long)g * N + sc];
        v = apply_act(v, act);
        if (residual != nullptr) v += residual[(row0 + lr) * N + sc];
      }
      C[(row0 + lr) * N + sc] = from_f32<OutT>(v);
    }
  }
}

struct Args {
  const void* tokens;
  const void* weights;
  const int* sizes;
  const float* bias;
  const float* residual;
  void* out;
  int groups, rpg, N, K, bm, bn, bk, stagger, act;
};

template <typename T, typename OutT, int TM, int TN, int TK, int RM, int RN>
cudaError_t launch(const Args& x, cudaStream_t stream) {
  const int tiles_m = (x.bm + TM - 1) / TM;
  const int tiles_n = (x.bn + TN - 1) / TN;
  const int nm = x.rpg / x.bm;
  const int nn = (x.N + x.bn - 1) / x.bn;
  const dim3 grid(nn * tiles_n, nm * tiles_m, x.groups);
  const dim3 block((TM / RM) * (TN / RN));
  grouped_matmul_kernel<T, OutT, TM, TN, TK, RM, RN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x.tokens), static_cast<const T*>(x.weights), x.sizes,
      x.bias, x.residual, static_cast<OutT*>(x.out), x.rpg, x.N, x.K, x.bm, x.bn,
      x.bk, tiles_m, tiles_n, x.stagger, x.act);
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t launch_config(const Args& x, int config, cudaStream_t stream) {
  if (config == 1) return launch<T, OutT, 8, 32, 128, 1, 1>(x, stream);  // decode
  return launch<T, OutT, 64, 64, 16, 4, 4>(x, stream);                    // prompt
}

template <typename T>
cudaError_t launch_out(const Args& x, int out_dtype, int config, cudaStream_t stream) {
  if (out_dtype == 1) return launch_config<T, __nv_bfloat16>(x, config, stream);
  return launch_config<T, float>(x, config, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  config: 0 = 64x64 tiles, 1 = 8x32
// decode tiles.  rpg must divide by bm (the wrapper checks).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int grouped_matmul_launch(const void* tokens, const void* weights,
                                     const void* sizes, const void* bias,
                                     const void* residual, void* out, int groups,
                                     int rpg, int N, int K, int bm, int bn, int bk,
                                     int stagger, int act, int in_dtype, int out_dtype,
                                     int config, void* stream) {
  const Args x{tokens, weights, static_cast<const int*>(sizes),
               static_cast<const float*>(bias), static_cast<const float*>(residual),
               out, groups, rpg, N, K, bm, bn, bk, stagger, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1) return static_cast<int>(launch_out<__nv_bfloat16>(x, out_dtype, config, s));
  return static_cast<int>(launch_out<float>(x, out_dtype, config, s));
}

extern "C" const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
