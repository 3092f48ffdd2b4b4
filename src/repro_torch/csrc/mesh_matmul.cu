// Mesh-array GEMM for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels `mesh_matmul_pallas` and
// `mesh_matmul_pallas_batched` (src/repro/kernels/mesh_matmul.py, body
// `_make_kernel`, assembly `_pallas_matmul`).  It computes, per batch element,
//
//     C = act(A . B + bias) + residual        f32 accumulator, fused epilogue
//
// on the plan's *logical* blocks (block_m, block_n, block_k):
//   * stagger      output cell (i, j) walks its k blocks in the order
//                  (i + j + k) mod nk, the paper's no-padding feed;
//   * scramble_out cell (i, j) computes standard block sigma(i, j) = (p, q),
//                  read from an int32 table the plan uploaded once; bias
//                  column and residual block follow (p, q), the output lands
//                  at (i, j);
//   * batch        blockIdx.z, with element strides per operand (0 = shared).
//
// What bounds it on this card.  On the serving path M is the number of decode
// slots (4-8 rows) or a prompt (128 rows), so every GEMM reads its weight once
// and does few operations per byte: decode is bound by the bytes of B (3.35
// TB/s), prefill sits near the bf16 ridge.  This first version is the simple
// one: thread-block tiles staged through shared memory and SIMT FMA in f32
// (never TF32: the reference contract is f32 accumulation of exact products).
// Two tile shapes are built: 64x64 (16 outputs per thread) for prompt-sized M,
// and 8x32 with a deep 128-element k step for decode, so that a 4-row product
// launches one CTA per 32 output columns and keeps 8 KB of B in flight per
// step instead of padding M to 128 rows (16-32x the work).  A tile never
// crosses a logical block: the sigma placement and the k order stay those of
// the logical blocks, and ragged M, N and K edges are masked in the kernel,
// not padded.  wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

// One CTA computes a TM x TN tile of one logical output block; each thread
// owns RM x RN outputs strided by the thread grid (conflict-free shared reads).
template <typename T, typename OutT, int TM, int TN, int TK, int RM, int RN>
__global__ void __launch_bounds__((TM / RM) * (TN / RN))
mesh_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ bias, const float* __restrict__ residual,
                   OutT* __restrict__ C, const int* __restrict__ sigma,
                   int M, int N, int K, int bm, int bn, int bk, int g,
                   int tiles_m, int tiles_n, long long a_bs, long long b_bs,
                   long long r_bs, long long c_bs, int stagger, int act) {
  constexpr int kThreadsN = TN / RN;
  constexpr int kThreadsM = TM / RM;
  constexpr int kThreads = kThreadsM * kThreadsN;
  __shared__ float As[TK][TM + 1];  // +1: conflict-free transposed stores
  __shared__ float Bs[TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN;
  const int ty = tid / kThreadsN;

  // Logical cell (i, j) and this CTA's tile inside it.
  const int j = blockIdx.x / tiles_n;
  const int i = blockIdx.y / tiles_m;
  const int lr0 = (blockIdx.y % tiles_m) * TM;
  const int lc0 = (blockIdx.x % tiles_n) * TN;
  const int rows = min(TM, bm - lr0);
  const int cols = min(TN, bn - lc0);

  int p = i, q = j;  // the standard block this cell computes
  if (sigma != nullptr) {
    const int flat = sigma[i * g + j];
    p = flat / g;
    q = flat % g;
  }
  const int sr0 = p * bm + lr0;  // standard rows / cols of the tile
  const int sc0 = q * bn + lc0;
  if (sr0 >= M || sc0 >= N) return;  // whole tile past the ragged edge

  const long long z = blockIdx.z;
  A += z * a_bs;
  B += z * b_bs;
  C += z * c_bs;
  if (residual != nullptr) residual += z * r_bs;

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.0f;

  const int nk = (K + bk - 1) / bk;
  for (int ks = 0; ks < nk; ++ks) {
    const int kb = stagger ? (i + j + ks) % nk : ks;
    const int k_begin = kb * bk;
    const int k_end = min(k_begin + bk, K);
    for (int k0 = k_begin; k0 < k_end; k0 += TK) {
      for (int e = tid; e < TM * TK; e += kThreads) {
        const int r = e / TK, kk = e % TK;
        const int gr = sr0 + r, gk = k0 + kk;
        float v = 0.0f;
        if (r < rows && gr < M && gk < k_end) v = to_f32(A[(long long)gr * K + gk]);
        As[kk][r] = v;
      }
      for (int e = tid; e < TK * TN; e += kThreads) {
        const int kk = e / TN, c = e % TN;
        const int gk = k0 + kk, gc = sc0 + c;
        float v = 0.0f;
        if (c < cols && gc < N && gk < k_end) v = to_f32(B[(long long)gk * N + gc]);
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

  // Epilogue on the standard block (p, q), stored at cell (i, j).
  const int cr0 = i * bm + lr0;
  const int cc0 = j * bn + lc0;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int lr = ty + r * kThreadsM;
    const int sr = sr0 + lr;
    if (lr >= rows || sr >= M) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int lc = tx + c * kThreadsN;
      const int sc = sc0 + lc;
      if (lc >= cols || sc >= N) continue;
      float v = acc[r][c];
      if (bias != nullptr) v += bias[sc];
      v = apply_act(v, act);
      if (residual != nullptr) v += residual[(long long)sr * N + sc];
      C[(long long)(cr0 + lr) * N + (cc0 + lc)] = from_f32<OutT>(v);
    }
  }
}

struct Args {
  const void* a;
  const void* b;
  const float* bias;
  const float* residual;
  void* out;
  const int* sigma;
  int batch, M, N, K, bm, bn, bk, g;
  long long a_bs, b_bs, r_bs, c_bs;
  int stagger, act;
};

template <typename T, typename OutT, int TM, int TN, int TK, int RM, int RN>
cudaError_t launch(const Args& x, cudaStream_t stream) {
  const int tiles_m = (x.bm + TM - 1) / TM;
  const int tiles_n = (x.bn + TN - 1) / TN;
  const int nm = (x.M + x.bm - 1) / x.bm;
  const int nn = (x.N + x.bn - 1) / x.bn;
  const dim3 grid(nn * tiles_n, nm * tiles_m, x.batch);
  const dim3 block((TM / RM) * (TN / RN));
  mesh_matmul_kernel<T, OutT, TM, TN, TK, RM, RN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), x.bias, x.residual,
      static_cast<OutT*>(x.out), x.sigma, x.M, x.N, x.K, x.bm, x.bn, x.bk, x.g,
      tiles_m, tiles_n, x.a_bs, x.b_bs, x.r_bs, x.c_bs, x.stagger, x.act);
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
// decode tiles.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mesh_matmul_launch(const void* a, const void* b, const void* bias,
                                  const void* residual, void* out, const void* sigma,
                                  int batch, int M, int N, int K, int bm, int bn,
                                  int bk, int g, long long a_bs, long long b_bs,
                                  long long r_bs, long long c_bs, int stagger,
                                  int act, int in_dtype, int out_dtype, int config,
                                  void* stream) {
  const Args x{a, b, static_cast<const float*>(bias), static_cast<const float*>(residual),
               out, static_cast<const int*>(sigma), batch, M, N, K, bm, bn, bk, g,
               a_bs, b_bs, r_bs, c_bs, stagger, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1) return static_cast<int>(launch_out<__nv_bfloat16>(x, out_dtype, config, s));
  return static_cast<int>(launch_out<float>(x, out_dtype, config, s));
}

extern "C" const char* mesh_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
