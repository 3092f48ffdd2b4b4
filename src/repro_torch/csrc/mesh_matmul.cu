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
// A CTA tile never crosses a logical block: the sigma placement and the k
// order stay those of the logical blocks, and ragged M, N and K edges are
// masked in the kernel (zero-filled loads, guarded stores), not padded.  f32
// operands are never multiplied in TF32: the reference contract is f32
// accumulation of exact products.
//
// What bounds it on this card.  Training runs M = 4096-row products: bound by
// operations, 989 TFLOP/s for bf16 on the tensor cores, 67 TFLOP/s for f32 on
// the FMA units.  Decode runs M = 4-8 rows: every GEMM reads its weight once
// and does a few operations per byte, so B's bytes at 3.35 TB/s bound it.
// Prefill (M = 128) sits near the bf16 ridge.  Three tile families, chosen by
// the wrapper from (M, N, K, blocks, dtypes) (`tile_config` in
// kernels/mesh_matmul.py, passed here as `config`):
//
//   (a) tc128, bf16, M > 16: a 128x128 CTA tile on the tensor cores.  8 warps
//       of 64x32, `mma.sync.m16n8k16` bf16 with f32 accumulation, fragments
//       from shared memory through `ldmatrix` (B, (K, N) row-major, through
//       `ldmatrix.trans`), fed by a 4-stage ring of 16-byte `cp.async` copies
//       32 deep in k: 74 KB of dynamic shared memory, rows padded by 16 bytes
//       so that `ldmatrix` reads are free of bank conflicts.  The ring's
//       prefetch follows the staggered logical-block order.  The epilogue
//       (bias, activation, residual, sigma placement, cast) runs on the
//       accumulator fragments.
//   (b) f32_128, f32 operands (the `_mm` backward's dA, dB and z remat): a
//       register-blocked SIMT tile, 128x128 with 256 threads of 8x8 outputs,
//       16 deep in k, double-buffered: B by `cp.async`, A through registers
//       into a k-major copy, so both are read from shared memory with float4
//       loads.  Exact f32 `fmaf` only.
//   (c) tc_decode, bf16, M <= 16: family (a)'s instructions on one 16-row
//       m-tile and a narrow N tile of 32 columns, so that an N = 2048
//       projection still launches 64 CTAs.  (A 16-column tile, 128 CTAs at
//       N = 2048, was no faster at any of mesh-paper's decode shapes.)  Its 8
//       warps split the cell's k tiles (warp w takes tiles w, w + 8, ...),
//       each streaming A and B through its own 4-stage `cp.async` ring with
//       no CTA barrier in the loop; the warps' sums are reduced in shared
//       memory in warp order, so the result is deterministic.
//
// The first SIMT tiles stay for logical blocks the new tiles cannot take
// (blocks narrower than 64, or 16 for decode, k blocks not a multiple of the
// k step, rows not a multiple of 16 bytes): 64x64 (16 outputs per thread)
// and 8x32 with a 128-deep k step for M <= 16.  wgmma with TMA would be faster
// again on (a); it is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"

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

// ---------------------------------------------------------------------------
// Shared by the new tile families (with mma_tiles.cuh)
// ---------------------------------------------------------------------------

// CTAs run in launch order, x fastest.  Walking a whole row of N tiles
// before the next M tile would stream all of B through the 50 MB L2 once per
// M tile; so consecutive CTAs walk kGroupM M tiles down one N tile first, and
// the CTAs resident at once cover a compact block of the output.
constexpr int kGroupM = 8;

__device__ __forceinline__ void grouped_xy(int& x, int& y) {
  const int gx = gridDim.x, gy = gridDim.y;
  const int lin = blockIdx.y * gx + blockIdx.x;
  const int group = lin / (kGroupM * gx);
  const int y0 = group * kGroupM;
  const int rows = min(gy - y0, kGroupM);
  const int in = lin - group * kGroupM * gx;
  y = y0 + in % rows;
  x = in / rows;
}

__device__ __forceinline__ TileAt locate(const int* sigma, int bm, int bn, int g,
                                         int tiles_m, int tiles_n, int tm, int tn) {
  int x, y;
  grouped_xy(x, y);
  TileAt t;
  t.j = x / tiles_n;
  t.i = y / tiles_m;
  const int lr0 = (y % tiles_m) * tm;
  const int lc0 = (x % tiles_n) * tn;
  t.rows = min(tm, bm - lr0);
  t.cols = min(tn, bn - lc0);
  int p = t.i, q = t.j;  // the standard block this cell computes
  if (sigma != nullptr) {
    const int flat = sigma[t.i * g + t.j];
    p = flat / g;
    q = flat % g;
  }
  t.sr0 = p * bm + lr0;
  t.sc0 = q * bn + lc0;
  t.cr0 = t.i * bm + lr0;
  t.cc0 = t.j * bn + lc0;
  return t;
}

__device__ __forceinline__ KTiles k_tiles(const TileAt& t, int K, int bk, int stagger,
                                          int tk) {
  return KTiles{(K + bk - 1) / bk, (bk + tk - 1) / tk, t.i + t.j, bk, K, stagger, tk};
}

// ---------------------------------------------------------------------------
// (a) tc128: bf16 on the tensor cores, 128x128 CTA tiles
// ---------------------------------------------------------------------------

constexpr int kTcM = 128, kTcN = 128, kTcK = 32, kTcStages = 4, kTcThreads = 256;
constexpr int kTcALd = kTcK + 8;  // bf16 per A row in shared memory (80 bytes)
constexpr int kTcBLd = kTcN + 8;  // bf16 per B row (272 bytes)
constexpr int kTcAStage = kTcM * kTcALd;
constexpr int kTcBStage = kTcK * kTcBLd;
constexpr int kTcSmem = kTcStages * (kTcAStage + kTcBStage) * 2;

template <typename OutT>
__global__ void __launch_bounds__(kTcThreads, 2)
mesh_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                const float* __restrict__ bias, const float* __restrict__ residual,
                OutT* __restrict__ C, const int* __restrict__ sigma, int M, int N, int K,
                int bm, int bn, int bk, int g, int tiles_m, int tiles_n, long long a_bs,
                long long b_bs, long long r_bs, long long c_bs, int stagger, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + kTcStages * kTcAStage;

  const TileAt t = locate(sigma, bm, bn, g, tiles_m, tiles_n, kTcM, kTcN);
  if (t.sr0 >= M || t.sc0 >= N) return;  // whole tile past the ragged edge
  const long long z = blockIdx.z;
  A += z * a_bs;
  B += z * b_bs;
  C += z * c_bs;
  if (residual != nullptr) residual += z * r_bs;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // rows wm * 64 of the tile
  const int wn = warp & 3;   // columns wn * 32
  const KTiles kt = k_tiles(t, K, bk, stagger, kTcK);
  const int total = kt.count();
  const StageLoader<kTcM, kTcN, kTcK, kTcThreads> loader(A, B, t, M, N, K, kTcALd, kTcBLd,
                                                          tid);
  KCursor cursor(kt);  // the next tile to load; tiles load in order
  auto load_next = [&](int stage) {
    loader.load(sa + stage * kTcAStage, sb + stage * kTcBStage, cursor.k0, cursor.k_end);
    cursor.next(kt);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // Ring: stage s holds tile s, s + kTcStages, ...; one group committed per
  // tile (empty past the end), so waiting for all but kTcStages - 2 groups
  // leaves tile `it` resident.
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < total) load_next(st);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // tile `it` visible; every warp is done with tile it - 1
    const int next = it + kTcStages - 1;
    if (next < total) load_next(next % kTcStages);
    cp_async_commit();
    const bf16* as = sa + (it % kTcStages) * kTcAStage + wm * 64 * kTcALd;
    const bf16* bs = sb + (it % kTcStages) * kTcBStage + wn * 32;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) mma_step<4, 4>(acc, as, kTcALd, bs, kTcBLd, kk, lane);
  }
  cp_async_wait<0>();

  // Epilogue on the fragments: acc[mt][nt] holds rows lane / 4 (+8) and
  // columns 2 (lane % 4) (+1) of its 16x8 tile.  A tile wholly inside its
  // block and the matrix stores column pairs with no per-element test.
  const bool inside = t.rows == kTcM && t.cols == kTcN && t.sr0 + kTcM <= M &&
                      t.sc0 + kTcN <= N;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int lc = wn * 32 + nt * 8 + (lane & 3) * 2;
    if (inside) {
      const int sc = t.sc0 + lc;
      const float2 b2 = bias != nullptr ? *reinterpret_cast<const float2*>(bias + sc)
                                        : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = wm * 64 + mt * 16 + (lane >> 2) + h * 8;
          float v0 = apply_act(acc[mt][nt][2 * h] + b2.x, act);
          float v1 = apply_act(acc[mt][nt][2 * h + 1] + b2.y, act);
          if (residual != nullptr) {
            const float2 r2 =
                *reinterpret_cast<const float2*>(residual + (long long)(t.sr0 + lr) * N + sc);
            v0 += r2.x;
            v1 += r2.y;
          }
          store2(C + (long long)(t.cr0 + lr) * N + t.cc0 + lc, v0, v1);
        }
    } else {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = wm * 64 + mt * 16 + (lane >> 2) + h * 8;
          finish_at(C, bias, residual, acc[mt][nt][2 * h], t, lr, lc, M, N, act);
          finish_at(C, bias, residual, acc[mt][nt][2 * h + 1], t, lr, lc + 1, M, N, act);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) tc_decode: bf16, M <= 16, the warps of a CTA split the k tiles
// ---------------------------------------------------------------------------

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
mesh_mma_decode_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                       const float* __restrict__ bias, const float* __restrict__ residual,
                       OutT* __restrict__ C, const int* __restrict__ sigma, int M, int N,
                       int K, int bm, int bn, int bk, int g, int tiles_m, int tiles_n,
                       long long a_bs, long long b_bs, long long r_bs, long long c_bs,
                       int stagger, int act) {
  constexpr int NT = kDecN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const TileAt t = locate(sigma, bm, bn, g, tiles_m, tiles_n, kDecM, kDecN);
  if (t.sr0 >= M || t.sc0 >= N) return;
  const long long z = blockIdx.z;
  A += z * a_bs;
  B += z * b_bs;
  C += z * c_bs;
  if (residual != nullptr) residual += z * r_bs;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bf16* sa = reinterpret_cast<bf16*>(smem_raw) + warp * kDecRing;  // this warp's ring
  bf16* sb = sa + kDecStages * kDecAStage;
  const KTiles kt = k_tiles(t, K, bk, stagger, kDecK);
  const int total = kt.count();
  const int mine = total > warp ? (total - warp + kDecWarps - 1) / kDecWarps : 0;

  const StageLoader<kDecM, kDecN, kDecK, 32> loader(A, B, t, M, N, K, kDecALd, kDecBLd, lane);
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
    for (int kk = 0; kk < kDecK; kk += 16) mma_step<1, NT>(acc, as, kDecALd, bs, kDecBLd, kk, lane);
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
    finish_at(C, bias, residual, v, t, lr, lc, M, N, act);
  }
}

// ---------------------------------------------------------------------------
// (b) f32_128: f32 operands on the FMA units, 128x128 CTA tiles
// ---------------------------------------------------------------------------

constexpr int kFM = 128, kFN = 128, kFK = 16, kFThreads = 256;
constexpr int kFALd = kFM + 4;  // k-major A rows: float4-aligned, fewer store conflicts

template <typename OutT>
__global__ void __launch_bounds__(kFThreads)
mesh_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, const float* __restrict__ residual,
                OutT* __restrict__ C, const int* __restrict__ sigma, int M, int N, int K,
                int bm, int bn, int bk, int g, int tiles_m, int tiles_n, long long a_bs,
                long long b_bs, long long r_bs, long long c_bs, int stagger, int act) {
  __shared__ __align__(16) float As[2][kFK][kFALd];  // A^T: k rows of 128 m values
  __shared__ __align__(16) float Bs[2][kFK][kFN];

  const TileAt t = locate(sigma, bm, bn, g, tiles_m, tiles_n, kFM, kFN);
  if (t.sr0 >= M || t.sc0 >= N) return;
  const long long z = blockIdx.z;
  A += z * a_bs;
  B += z * b_bs;
  C += z * c_bs;
  if (residual != nullptr) residual += z * r_bs;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx * 4 + {0..3} and 64 + tx * 4 + {0..3}
  const int ty = tid >> 4;  // rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3}
  const KTiles kt = k_tiles(t, K, bk, stagger, kFK);
  const int total = kt.count();

  float4 ar[2];  // the next A tile on its way through registers
  KCursor cursor(kt);  // the tile being fetched; tiles are fetched in order
  auto fetch_a = [&]() {
    const int k0 = cursor.k0, k_end = cursor.k_end;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int c = tid + it * kFThreads;
      const int r = c >> 2;
      const int gr = t.sr0 + r;
      const int gk = k0 + (c & 3) * 4;
      ar[it] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < t.rows && gr < M && gk < k_end)
        ar[it] = __ldg(reinterpret_cast<const float4*>(A + (long long)gr * K + gk));
    }
  };
  auto stash_a = [&](int buf) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int c = tid + it * kFThreads;
      const int r = c >> 2;
      const int kc = (c & 3) * 4;
      As[buf][kc][r] = ar[it].x;
      As[buf][kc + 1][r] = ar[it].y;
      As[buf][kc + 2][r] = ar[it].z;
      As[buf][kc + 3][r] = ar[it].w;
    }
  };
  auto load_b = [&](int buf) {
    const int k0 = cursor.k0, k_end = cursor.k_end;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int c = tid + it * kFThreads;
      const int kr = c >> 5;
      const int nc = (c & 31) * 4;
      const int gk = k0 + kr;
      const int gc = t.sc0 + nc;
      const bool ok = gk < k_end && nc < t.cols && gc < N;
      cp_async16(&Bs[buf][kr][nc], ok ? B + (long long)gk * N + gc : B, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  if (total > 0) {
    fetch_a();
    stash_a(0);
    load_b(0);
    cp_async_commit();
    cursor.next(kt);
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int it = 0; it < total; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < total;
    if (more) {  // the next tile's copies fly while this one is multiplied
      load_b(cur ^ 1);
      cp_async_commit();
      fetch_a();
      cursor.next(kt);
    }
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    if (more) {
      stash_a(cur ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int lr = (r < 4 ? 0 : 60) + ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int lc = (c < 4 ? 0 : 60) + tx * 4 + c;
      finish_at(C, bias, residual, acc[r][c], t, lr, lc, M, N, act);
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

// A new family's launch: one tm x tn tile per CTA inside each logical block
// (a block taller or wider than the matrix needs only the tiles that reach
// into it), `smem` bytes of dynamic shared memory.
template <typename In, typename OutT, typename Kernel>
cudaError_t launch_tiles(Kernel kernel, const Args& x, int tm, int tn, int threads, int smem,
                         cudaStream_t stream) {
  const int tiles_m = (min(x.bm, x.M) + tm - 1) / tm;
  const int tiles_n = (min(x.bn, x.N) + tn - 1) / tn;
  const int nm = (x.M + x.bm - 1) / x.bm;
  const int nn = (x.N + x.bn - 1) / x.bn;
  const dim3 grid(nn * tiles_n, nm * tiles_m, x.batch);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const In*>(x.a), static_cast<const In*>(x.b), x.bias, x.residual,
      static_cast<OutT*>(x.out), x.sigma, x.M, x.N, x.K, x.bm, x.bn, x.bk, x.g, tiles_m,
      tiles_n, x.a_bs, x.b_bs, x.r_bs, x.c_bs, x.stagger, x.act);
  return cudaGetLastError();
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised
// once; a refusal is returned like a launch error.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Tile configurations (kernels/mesh_matmul.py: TILE_CONFIGS).
enum Config {
  kSimt64 = 0,      // first SIMT tile, 64x64
  kSimtDecode = 1,  // first SIMT decode tile, 8x32
  kTc128 = 2,       // (a)
  kF32Tile = 3,     // (b)
  kTcDecode = 4,    // (c)
};

template <typename OutT>
cudaError_t launch_bf16(const Args& x, int config, cudaStream_t stream) {
  switch (config) {
    case kSimt64: return launch<bf16, OutT, 64, 64, 16, 4, 4>(x, stream);
    case kSimtDecode: return launch<bf16, OutT, 8, 32, 128, 1, 1>(x, stream);
    case kTc128: {
      static const cudaError_t attr = allow_smem(mesh_mma_kernel<OutT>, kTcSmem);
      if (attr != cudaSuccess) return attr;
      return launch_tiles<bf16, OutT>(mesh_mma_kernel<OutT>, x, kTcM, kTcN, kTcThreads,
                                      kTcSmem, stream);
    }
    case kTcDecode: {
      static const cudaError_t attr = allow_smem(mesh_mma_decode_kernel<OutT>, kDecSmem);
      if (attr != cudaSuccess) return attr;
      return launch_tiles<bf16, OutT>(mesh_mma_decode_kernel<OutT>, x, kDecM, kDecN,
                                      kDecThreads, kDecSmem, stream);
    }
    default: return cudaErrorInvalidValue;
  }
}

template <typename OutT>
cudaError_t launch_f32(const Args& x, int config, cudaStream_t stream) {
  switch (config) {
    case kSimt64: return launch<float, OutT, 64, 64, 16, 4, 4>(x, stream);
    case kSimtDecode: return launch<float, OutT, 8, 32, 128, 1, 1>(x, stream);
    case kF32Tile:
      return launch_tiles<float, OutT>(mesh_f32_kernel<OutT>, x, kFM, kFN, kFThreads, 0,
                                       stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  config: enum Config above (the
// wrapper checks that the tile takes the shapes and blocks: 16-byte rows and
// k blocks a multiple of the k step for the new families).  Returns
// cudaGetLastError() after the launch (0 = launched).
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
  cudaError_t err;
  if (in_dtype == 1)
    err = out_dtype == 1 ? launch_bf16<bf16>(x, config, s) : launch_bf16<float>(x, config, s);
  else
    err = out_dtype == 1 ? launch_f32<bf16>(x, config, s) : launch_f32<float>(x, config, s);
  return static_cast<int>(err);
}

extern "C" const char* mesh_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
