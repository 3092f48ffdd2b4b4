// The tile machinery of the mesh GEMM's tensor-core families (mesh_matmul.cu,
// K1), shared with the grouped mesh GEMM (grouped_matmul.cu, K5): where a
// CTA's tile sits, the staggered k order of the logical blocks walked in
// tk-deep tiles, the 16-byte `cp.async` stage loader that masks rows,
// columns and k at the block and matrix edges, one 16-deep `mma.sync` step
// of a warp's tile, and the fused epilogue of one output.
#pragma once

#include <cuda_bf16.h>

#include "epilogue.cuh"
#include "mma_sm80.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Where a CTA's tile sits: the logical cell (i, j) (k order, output
// placement), the standard block it computes (A rows, B columns, bias and
// residual), and the tile's extent inside its logical block.
struct TileAt {
  int i, j;
  int sr0, sc0;    // first standard row / column of the tile
  int cr0, cc0;    // first output row / column (the cell's placement)
  int rows, cols;  // rows and columns of the tile inside the logical block
};

// A cell's k tiles in order: logical block after logical block in the
// staggered order (i + j + s) mod nk, each cut into tk-deep tiles.  A tile
// (or 16-byte chunk) at or past its block's end, or K, loads zeros.
// `at` finds any tile; a KCursor walks them one by one without dividing.
struct KTiles {
  int nk, per_block, i_plus_j, bk, K, stagger, tk;
  __device__ __forceinline__ int count() const { return nk * per_block; }
  __device__ __forceinline__ void at(int t, int& k0, int& k_end) const {
    const int s = t / per_block;
    const int kb = stagger ? (i_plus_j + s) % nk : s;
    k0 = kb * bk + (t - s * per_block) * tk;
    k_end = min(kb * bk + bk, K);
  }
};

struct KCursor {
  int kb, sub, k0, k_end;  // logical block, tile in it, its first k, the block's end
  __device__ __forceinline__ KCursor(const KTiles& kt) : sub(0) {
    kb = kt.stagger && kt.nk > 0 ? kt.i_plus_j % kt.nk : 0;
    k0 = kb * kt.bk;
    k_end = min(k0 + kt.bk, kt.K);
  }
  __device__ __forceinline__ void next(const KTiles& kt) {
    if (++sub == kt.per_block) {
      sub = 0;
      kb = kb + 1 == kt.nk ? 0 : kb + 1;
      k0 = kb * kt.bk;
      k_end = min(k0 + kt.bk, kt.K);
    } else {
      k0 += kt.tk;
    }
  }
};

// The epilogue of one output: standard (sr, sc), stored at C[c_at].
template <typename OutT>
__device__ __forceinline__ void finish(OutT* C, const float* bias, const float* residual,
                                       float v, int sr, int sc, long long c_at, int N,
                                       int act) {
  if (bias != nullptr) v += bias[sc];
  v = apply_act(v, act);
  if (residual != nullptr) v += residual[(long long)sr * N + sc];
  C[c_at] = from_f32<OutT>(v);
}

// The epilogue of the tile's output (lr, lc), if it lies inside the block
// and the matrix.
template <typename OutT>
__device__ __forceinline__ void finish_at(OutT* C, const float* bias, const float* residual,
                                          float v, const TileAt& t, int lr, int lc, int M,
                                          int N, int act) {
  const int sr = t.sr0 + lr;
  const int sc = t.sc0 + lc;
  if (lr >= t.rows || sr >= M || lc >= t.cols || sc >= N) return;
  finish(C, bias, residual, v, sr, sc, (long long)(t.cr0 + lr) * N + (t.cc0 + lc), N, act);
}

// Two neighbouring outputs (an even column, 4- or 8-byte aligned) at once.
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One 16-deep step of a warp's mma tile: MT 16-row A tiles at a_rows (row
// stride a_ld), NT/2 pairs of 8-column B tiles at b_cols (row stride b_ld),
// both at k offset kk of the stage.
template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const bf16* a_rows,
                                         int a_ld, const bf16* b_cols, int b_ld, int kk,
                                         int lane) {
  unsigned af[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    ldsm_x4(af[mt], a_rows + (mt * 16 + (lane & 15)) * a_ld + kk + (lane >> 4) * 8);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    unsigned b[4];  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
    ldsm_x4_trans(b, b_cols + (kk + (lane & 15)) * b_ld + np * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_16816(acc[mt][2 * np], af[mt], b[0], b[1]);
      mma_16816(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
    }
  }
}

// Copies one tk-deep stage of a tm x tn tile: A rows x k into `as` (row
// stride a_ld) and B k rows x columns into `bs` (row stride b_ld), in 16-byte
// chunks spread over THREADS threads.  Each thread's chunks keep their row,
// column and source row pointer from stage to stage; only k moves.
template <int TM, int TN, int TK, int THREADS>
struct StageLoader {
  static constexpr int kAPer = TM * TK / 8 / THREADS;
  static constexpr int kBPer = TK * TN / 8 / THREADS;
  static_assert(kAPer * THREADS * 8 == TM * TK && kBPer * THREADS * 8 == TK * TN,
                "whole 16-byte chunks per thread");
  const bf16* A;
  const bf16* B;
  long long n;
  const bf16* a_src[kAPer];
  const bf16* b_src[kBPer];
  int a_dst[kAPer], a_k[kAPer], b_dst[kBPer], b_k[kBPer];
  bool a_ok[kAPer], b_ok[kBPer];

  __device__ __forceinline__ StageLoader(const bf16* A_, const bf16* B_, const TileAt& t,
                                         int M, int N, int K, int a_ld, int b_ld, int me)
      : A(A_), B(B_), n(N) {
#pragma unroll
    for (int it = 0; it < kAPer; ++it) {
      const int c = me + it * THREADS;
      const int r = c / (TK / 8);
      const int kc = (c % (TK / 8)) * 8;
      const int gr = t.sr0 + r;
      a_ok[it] = r < t.rows && gr < M;
      a_src[it] = A + (long long)(a_ok[it] ? gr : 0) * K + kc;
      a_dst[it] = r * a_ld + kc;
      a_k[it] = kc;
    }
#pragma unroll
    for (int it = 0; it < kBPer; ++it) {
      const int c = me + it * THREADS;
      const int kr = c / (TN / 8);
      const int nc = (c % (TN / 8)) * 8;
      const int gc = t.sc0 + nc;
      b_ok[it] = nc < t.cols && gc < N;
      b_src[it] = B + (long long)kr * N + (b_ok[it] ? gc : 0);
      b_dst[it] = kr * b_ld + nc;
      b_k[it] = kr;
    }
  }

  // The stage of k [k0, k0 + TK), zeros at or past k_end.
  __device__ __forceinline__ void load(bf16* as, bf16* bs, int k0, int k_end) const {
#pragma unroll
    for (int it = 0; it < kAPer; ++it) {
      const bool ok = a_ok[it] && k0 + a_k[it] < k_end;
      cp_async16(as + a_dst[it], ok ? a_src[it] + k0 : A, ok);
    }
#pragma unroll
    for (int it = 0; it < kBPer; ++it) {
      const bool ok = b_ok[it] && k0 + b_k[it] < k_end;
      cp_async16(bs + b_dst[it], ok ? b_src[it] + k0 * n : B, ok);
    }
  }
};

}  // namespace
