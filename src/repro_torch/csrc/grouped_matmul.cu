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
// (3.35 TB/s).  A 128-token prefill routes about 16 of each expert's 128
// rows, so its work follows the live rows, not the capacity.  What the
// design does about it:
//   * one CTA per (group, row tile, column tile), the group on blockIdx.z;
//   * `sizes` is read on the device, so the host never waits on routing;
//   * a CTA whose first row is at or past its group's size writes its
//     zeros and returns before it reads any weight: an empty expert costs
//     no weight traffic, and a short expert skips its empty row tiles (the
//     TPU kernel skips whole logical row blocks; a CTA tile is finer);
//   * rows of a live tile past the group's size load as zeros (`cp.async`
//     zero fill) and are stored as exact zeros;
//   * a tile never crosses a logical block, so the k order is that of the
//     logical blocks; ragged N and K edges are masked, not padded.
// bf16 runs on the tensor cores with the mesh GEMM's machinery
// (mma_tiles.cuh: `mma.sync.m16n8k16` with f32 accumulation, `ldmatrix`,
// a 4-stage ring of 16-byte `cp.async` copies 32 deep in k, rows padded by
// 16 bytes), per group:
//   (a) tc_rows32, block_m > 16 (prefill): a 32-row x 128-column CTA tile,
//       4 warps of 32 x 32, so that a group's ~16 live rows of 128 cost one
//       short tile, not a 128-row one (a 64-row tile ran 0.1-1.8 % slower
//       over OLMoE's prefill);
//   (b) tc_decode, block_m <= 16 (decode): one 16-row m-tile, rows past the
//       size zero-filled, a 32-column CTA whose 8 warps split the cell's k
//       tiles, each streaming through its own ring; the warps' sums meet in
//       shared memory in warp order, so the result is deterministic.
// f32 operands (the `_gmm` backward) keep the first SIMT tiles, 8 x 32 with
// a 128-deep k step for block_m <= 16 and 64 x 64 above, exact f32 FMA
// (never TF32: the contract is f32 accumulation of exact products).
// Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): OLMoE's
// decode step (32 launches) 2.9 ms against a 1.64 ms bound of weight bytes,
// a 128-token prefill 5.4 ms against 4.2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core tiles (bf16)
// ---------------------------------------------------------------------------

// Where a CTA's tile of group g sits, in mma_tiles.cuh's terms: rows are
// absolute rows of tokens and out (g * rpg + the row in the group), columns
// those of the logical block; the cell (i, j) is the group's.
__device__ __forceinline__ TileAt group_tile(int g, int rpg, int bm, int bn, int tiles_m,
                                             int tiles_n, int tm, int tn) {
  TileAt t;
  t.j = blockIdx.x / tiles_n;
  t.i = blockIdx.y / tiles_m;
  const int lr0 = (blockIdx.y % tiles_m) * tm;
  const int lc0 = (blockIdx.x % tiles_n) * tn;
  t.rows = min(tm, bm - lr0);
  t.cols = min(tn, bn - lc0);
  t.sr0 = t.cr0 = g * rpg + t.i * bm + lr0;
  t.sc0 = t.cc0 = t.j * bn + lc0;
  return t;
}

// Zeros over the whole tile, its columns inside N.
template <typename OutT>
__device__ __forceinline__ void store_zeros(OutT* C, const TileAt& t, int N) {
  const int cols = min(t.cols, N - t.sc0);
  for (int e = threadIdx.x; e < t.rows * cols; e += blockDim.x)
    C[(long long)(t.cr0 + e / cols) * N + t.cc0 + e % cols] = from_f32<OutT>(0.0f);
}

// The epilogue of the tile's output (lr, lc): rows inside the group's size
// (lr < live) finish on the accumulator, the rest of the tile stores 0.
template <typename OutT>
__device__ __forceinline__ void finish_or_zero(OutT* C, const float* bias,
                                               const float* residual, float v,
                                               const TileAt& t, int lr, int lc, int live,
                                               int N, int act) {
  if (lr < live) {
    finish_at(C, bias, residual, v, t, lr, lc, t.sr0 + live, N, act);
  } else if (lr < t.rows && lc < t.cols && t.sc0 + lc < N) {
    C[(long long)(t.cr0 + lr) * N + t.cc0 + lc] = from_f32<OutT>(0.0f);
  }
}

// (a) tc_rows32.
constexpr int kRowsM = 32, kRowsN = 128, kRowsK = 32, kRowsStages = 4;
constexpr int kRowsThreads = 128;     // 4 warps of 32 x 32, side by side in N
constexpr int kRowsALd = kRowsK + 8;  // bf16 per A row in shared memory (80 bytes)
constexpr int kRowsBLd = kRowsN + 8;  // bf16 per B row (272 bytes)
constexpr int kRowsAStage = kRowsM * kRowsALd;
constexpr int kRowsBStage = kRowsK * kRowsBLd;
constexpr int kRowsSmem = kRowsStages * (kRowsAStage + kRowsBStage) * 2;

template <typename OutT>
__global__ void __launch_bounds__(kRowsThreads)
grouped_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                   const int* __restrict__ sizes, const float* __restrict__ bias,
                   const float* __restrict__ residual, OutT* __restrict__ C, int rpg, int N,
                   int K, int bm, int bn, int bk, int tiles_m, int tiles_n, int stagger,
                   int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + kRowsStages * kRowsAStage;

  const int g = blockIdx.z;
  const TileAt t = group_tile(g, rpg, bm, bn, tiles_m, tiles_n, kRowsM, kRowsN);
  if (t.sc0 >= N) return;  // whole tile past the ragged N edge
  const int live = min(t.rows, sizes[g] - (t.sr0 - g * rpg));  // rows inside the size
  if (live <= 0) {  // no valid row: zeros, and no weight read
    store_zeros(C, t, N);
    return;
  }
  W += (long long)g * K * N;
  if (bias != nullptr) bias += (long long)g * N;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;  // the warp's columns: wn * 32
  const KTiles kt{(K + bk - 1) / bk, (bk + kRowsK - 1) / kRowsK, g + t.i + t.j, bk, K,
                  stagger, kRowsK};
  const int total = kt.count();
  // Rows at or past the size (absolute row t.sr0 + live) load as zeros.
  const StageLoader<kRowsM, kRowsN, kRowsK, kRowsThreads> loader(A, W, t, t.sr0 + live, N, K,
                                                                 kRowsALd, kRowsBLd, tid);
  KCursor cursor(kt);  // the next tile to load; tiles load in order
  auto load_next = [&](int stage) {
    loader.load(sa + stage * kRowsAStage, sb + stage * kRowsBStage, cursor.k0, cursor.k_end);
    cursor.next(kt);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // Ring: stage s holds tile s, s + kRowsStages, ...; one group committed
  // per tile (empty past the end).
#pragma unroll
  for (int st = 0; st < kRowsStages - 1; ++st) {
    if (st < total) load_next(st);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kRowsStages - 2>();
    __syncthreads();  // tile `it` visible; every warp is done with tile it - 1
    const int next = it + kRowsStages - 1;
    if (next < total) load_next(next % kRowsStages);
    cp_async_commit();
    const bf16* as = sa + (it % kRowsStages) * kRowsAStage;
    const bf16* bs = sb + (it % kRowsStages) * kRowsBStage + wn * 32;
#pragma unroll
    for (int kk = 0; kk < kRowsK; kk += 16)
      mma_step<2, 4>(acc, as, kRowsALd, bs, kRowsBLd, kk, lane);
  }
  cp_async_wait<0>();

  // acc[mt][nt] holds rows lane / 4 (+8) and columns 2 (lane % 4) (+1) of
  // its 16x8 tile.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = mt * 16 + (lane >> 2) + h * 8;
        const int lc = wn * 32 + nt * 8 + (lane & 3) * 2;
        finish_or_zero(C, bias, residual, acc[mt][nt][2 * h], t, lr, lc, live, N, act);
        finish_or_zero(C, bias, residual, acc[mt][nt][2 * h + 1], t, lr, lc + 1, live, N,
                       act);
      }
}

// (b) tc_decode.
constexpr int kDecM = 16, kDecN = 32, kDecK = 32, kDecStages = 4, kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecALd = kDecK + 8;  // 80 bytes a row
constexpr int kDecBLd = kDecN + 8;  // 80 bytes a row
constexpr int kDecAStage = kDecM * kDecALd;
constexpr int kDecBStage = kDecK * kDecBLd;
constexpr int kDecRing = kDecStages * (kDecAStage + kDecBStage);  // bf16 per warp
constexpr int kDecSmem = kDecWarps * kDecRing * 2;

template <typename OutT>
__global__ void __launch_bounds__(kDecThreads)
grouped_mma_decode_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                          const int* __restrict__ sizes, const float* __restrict__ bias,
                          const float* __restrict__ residual, OutT* __restrict__ C, int rpg,
                          int N, int K, int bm, int bn, int bk, int tiles_m, int tiles_n,
                          int stagger, int act) {
  constexpr int NT = kDecN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int g = blockIdx.z;
  const TileAt t = group_tile(g, rpg, bm, bn, tiles_m, tiles_n, kDecM, kDecN);
  if (t.sc0 >= N) return;
  const int live = min(t.rows, sizes[g] - (t.sr0 - g * rpg));
  if (live <= 0) {
    store_zeros(C, t, N);
    return;
  }
  W += (long long)g * K * N;
  if (bias != nullptr) bias += (long long)g * N;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bf16* sa = reinterpret_cast<bf16*>(smem_raw) + warp * kDecRing;  // this warp's ring
  bf16* sb = sa + kDecStages * kDecAStage;
  const KTiles kt{(K + bk - 1) / bk, (bk + kDecK - 1) / kDecK, g + t.i + t.j, bk, K, stagger,
                  kDecK};
  const int total = kt.count();
  const int mine = total > warp ? (total - warp + kDecWarps - 1) / kDecWarps : 0;

  const StageLoader<kDecM, kDecN, kDecK, 32> loader(A, W, t, t.sr0 + live, N, K, kDecALd,
                                                    kDecBLd, lane);
  auto load = [&](int stage, int u) {  // this warp's u-th tile: warp + u * kDecWarps
    int k0, k_end;
    kt.at(warp + u * kDecWarps, k0, k_end);
    loader.load(sa + stage * kDecAStage, sb + stage * kDecBStage, k0, k_end);
  };

  float acc[1][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < kDecStages - 1; ++st) {
    if (st < mine) load(st, st);
    cp_async_commit();
  }
  for (int u = 0; u < mine; ++u) {
    cp_async_wait<kDecStages - 2>();
    __syncwarp();  // the warp's copies visible; its lanes are done with tile u - 1
    const int next = u + kDecStages - 1;
    if (next < mine) load(next % kDecStages, next);
    cp_async_commit();
    const bf16* as = sa + (u % kDecStages) * kDecAStage;
    const bf16* bs = sb + (u % kDecStages) * kDecBStage;
#pragma unroll
    for (int kk = 0; kk < kDecK; kk += 16)
      mma_step<1, NT>(acc, as, kDecALd, bs, kDecBLd, kk, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: reuse the memory for the reduction

  float* red = reinterpret_cast<float*>(smem_raw);  // [kDecWarps][kDecM][kDecN]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 2) + h * 8;
      const int c = nt * 8 + (lane & 3) * 2;
      red[(warp * kDecM + r) * kDecN + c] = acc[0][nt][2 * h];
      red[(warp * kDecM + r) * kDecN + c + 1] = acc[0][nt][2 * h + 1];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < kDecM * kDecN; e += kDecThreads) {
    const int lr = e / kDecN;
    const int lc = e % kDecN;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) v += red[(w * kDecM + lr) * kDecN + lc];
    finish_or_zero(C, bias, residual, v, t, lr, lc, live, N, act);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

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

// A tensor-core family's launch: one tm x tn tile per CTA inside each
// logical block (a block wider than N needs only the tiles that reach into
// it), `smem` bytes of dynamic shared memory.
template <typename OutT, typename Kernel>
cudaError_t launch_mma(Kernel kernel, const Args& x, int tm, int tn, int threads, int smem,
                       cudaStream_t stream) {
  const int tiles_m = (x.bm + tm - 1) / tm;
  const int tiles_n = (min(x.bn, x.N) + tn - 1) / tn;
  const int nm = x.rpg / x.bm;
  const int nn = (x.N + x.bn - 1) / x.bn;
  const dim3 grid(nn * tiles_n, nm * tiles_m, x.groups);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(x.tokens), static_cast<const bf16*>(x.weights), x.sizes, x.bias,
      x.residual, static_cast<OutT*>(x.out), x.rpg, x.N, x.K, x.bm, x.bn, x.bk, tiles_m,
      tiles_n, x.stagger, x.act);
  return cudaGetLastError();
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised
// once; a refusal is returned like a launch error.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Tile configurations (kernels/grouped.py: TILE_CONFIGS).
enum Config {
  kSimt64 = 0,      // SIMT 64x64
  kSimtDecode = 1,  // SIMT 8x32, block_m <= 16
  kTcRows32 = 2,    // (a)
  kTcDecode = 3,    // (b)
};

template <typename OutT>
cudaError_t launch_bf16(const Args& x, int config, cudaStream_t stream) {
  switch (config) {
    case kSimt64: return launch<bf16, OutT, 64, 64, 16, 4, 4>(x, stream);
    case kSimtDecode: return launch<bf16, OutT, 8, 32, 128, 1, 1>(x, stream);
    case kTcRows32: {
      static const cudaError_t attr = allow_smem(grouped_mma_kernel<OutT>, kRowsSmem);
      if (attr != cudaSuccess) return attr;
      return launch_mma<OutT>(grouped_mma_kernel<OutT>, x, kRowsM, kRowsN, kRowsThreads,
                              kRowsSmem, stream);
    }
    case kTcDecode: {
      static const cudaError_t attr = allow_smem(grouped_mma_decode_kernel<OutT>, kDecSmem);
      if (attr != cudaSuccess) return attr;
      return launch_mma<OutT>(grouped_mma_decode_kernel<OutT>, x, kDecM, kDecN, kDecThreads,
                              kDecSmem, stream);
    }
    default: return cudaErrorInvalidValue;
  }
}

template <typename OutT>
cudaError_t launch_f32(const Args& x, int config, cudaStream_t stream) {
  switch (config) {
    case kSimt64: return launch<float, OutT, 64, 64, 16, 4, 4>(x, stream);
    case kSimtDecode: return launch<float, OutT, 8, 32, 128, 1, 1>(x, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  config: enum Config above (the
// wrapper's `tile_config` checks that the tile takes the shapes and blocks:
// 16-byte rows and k blocks a multiple of 32 for the tensor-core tiles).
// rpg must divide by bm (the wrapper checks).  Returns cudaGetLastError()
// after the launch (0 = launched).
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
  cudaError_t err;
  if (in_dtype == 1)
    err = out_dtype == 1 ? launch_bf16<bf16>(x, config, s) : launch_bf16<float>(x, config, s);
  else
    err = out_dtype == 1 ? launch_f32<bf16>(x, config, s) : launch_f32<float>(x, config, s);
  return static_cast<int>(err);
}

extern "C" const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
