// Flash attention (tiled online-softmax SDPA) for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++: kernel K6 of the port.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`): grouped-query
// attention, causal or full, tiled over both queries and keys, with the
// (m, l, acc) online-softmax recurrence kept on chip, so device memory sees
// Q + K + V once and O once.
//
//   q    (B, Tq, H, hd)   H = KV * rep
//   k, v (B, Tk, KV, hd)
//   out  (B, Tq, H, hd)
//
// The GQA fold, as in the reference: a (batch, kv head) pair owns
// Tq * rep query rows ordered (token, rep), row r being token r / rep of
// head kv * rep + r % rep.  Those rows sit rep * hd apart in q's own layout,
// so the kernel addresses them in place (the reference transposes q into
// that order first).  The causal mask is the reference's, top-left aligned
// and shifted by `q_offset`: key <= r / rep + q_offset, so Tq and Tk may
// differ (a row past the last key sees every key).  A context-parallel rank
// holding query tokens [q_offset, q_offset + Tq) of a longer sequence passes
// that offset; at 0 every output is bitwise what it was without it.  Keys past Tk (a ragged last tile) get
// p = 0; the reference has none.
//
// What bounds it on this card: operations.  Causal Qwen2-7B prefill at
// T = 2048 (28 heads, hd 128) is 30 GFLOP against 34 MB of Q, K, V and O:
// about 0.030 ms at the bf16 tensor-core rate against 0.010 ms of bytes.
// Two kernels, by input type:
//
//   flash_mma_kernel, bf16 (the serving and training paths): FlashAttention-2
//   on `mma.sync.m16n8k16` with f32 accumulators.  Grid (row tiles, B * KV),
//   heaviest causal tiles launched first; a CTA of 4 warps (64 rows; CTAs of
//   8 warps and 128 rows ran 6-8 % slower), each warp owning 16 folded
//   query rows.  The CTA's Q tile comes in by `cp.async` and each warp
//   keeps its Q fragments in registers (`ldmatrix`) for the whole key
//   loop.  K and V tiles of 64 keys x hd stream through a 3-stage
//   `cp.async` ring, rows padded by 16 bytes so that `ldmatrix` reads are
//   free of bank conflicts (Q's staging area is the ring's last stage,
//   reused once the fragments are in registers).  Per tile: S = Q K^T (K
//   rows through plain `ldmatrix` as the col operand), times hd^-0.5 in f32
//   after the product as the reference scales it, the mask on tiles that
//   cross the diagonal or Tk (masked entries get p = 0 explicitly); the row
//   max by quad shuffles (the 4 lanes holding one row), m' = max(m, max s),
//   corr = 2^(m - m'), p = 2^(s - m') in f32: exponentials are exp2f with
//   log2 e folded into the scale (scores and m are kept in log2 units; one
//   f32 rounding from exp(), far below bf16's), l' = l corr + sum p over
//   the unrounded p, as the reference sums it.  P goes to bf16 straight from
//   the S accumulator registers into the A fragments of P.V (the m16n8 C
//   layout pairs are the m16n8k16 A layout's), which is the reference's
//   rounding, p cast to v's type before P.V; P never touches shared memory.
//   V comes through `ldmatrix.trans`.  Tiles wholly above the diagonal are
//   skipped: their probabilities are exactly 0.  The output is acc / l,
//   with l == 0 read as 1, stored as bf16.  hd a multiple of 16, <= 128.
//
//   flash_attention_kernel, f32 (parity witnesses; never TF32): the first
//   SIMT version.  Grid as above, 128 threads for 64 query rows staged in
//   shared memory (transposed, f32); thread (ty, tx) = (tid / 8, tid % 8)
//   owns rows 4 ty .. 4 ty + 3, keys tx + 8 j of each 64-key tile and head
//   dims tx + 8 j of the accumulator; scores and P.V on f32 FMA, the
//   probabilities passing to P.V through shared memory (where K was).
//
// Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): the bf16
// kernel takes 0.22 ms at T = 2048 (137 TFLOP/s, 7x the bound, 3.2x SDPA's
// time).  Each warp owns one 16-row m-tile, so every warp reads the whole
// K and V tile from shared memory for 2 mma per ldmatrix; two m-tiles a
// warp (Q from shared memory), then wgmma with TMA and warp
// specialisation, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm80.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBM = 64;  // query rows per CTA
constexpr int kBN = 64;  // keys per tile
constexpr int kMaxHeadDim = 128;
constexpr int kMaxDims = kMaxHeadDim / 8;  // accumulator dims per thread

__device__ __forceinline__ float round_to(float x, float) { return x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Sixteen bytes of `src` (4 floats) as floats.
__device__ __forceinline__ void load16(const float* src, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// Shared-memory floats for head dim hd: Q^T (hd x 64), the K tile (64 rows
// of hd + 4, which the probabilities (64 x 68) reuse) and the V tile.
__host__ __device__ inline int ks_floats(int hd) {
  const int k = kBN * (hd + 4), p = kBN * (kBM + 4);
  return k > p ? k : p;
}
__host__ __device__ inline size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)hd * kBM + ks_floats(hd) + (size_t)kBN * hd);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int tq, int tk,
                       int kvh, int hd, int rep, int causal, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [hd][kBM]
  float* ks = qs + hd * kBM;                      // [kBN][hd + 4]
  float* ps = ks;                                 // [kBN][kBM + 4], after the scores
  float* vs = ks + ks_floats(hd);                 // [kBN][hd]
  const int ks_ld = hd + 4, ps_ld = kBM + 4;

  constexpr int kVec = 16 / sizeof(T);
  const int chunks = hd / kVec;
  const int rows = tq * rep;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int b = blockIdx.y / kvh, g = blockIdx.y % kvh;
  const long long heads = (long long)kvh * rep;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int n_dims = hd / 8;

  // Folded row r -> element offset of its (token, head) row in q / out.
  auto row_offset = [&](int r) -> long long {
    return (((long long)b * tq + r / rep) * heads + (long long)g * rep + r % rep) * hd;
  };
  auto kv_offset = [&](int key) -> long long {
    return (((long long)b * tk + key) * kvh + g) * hd;
  };

  // Q tile, transposed: consecutive threads take consecutive rows.
  for (int idx = tid; idx < kBM * chunks; idx += kThreads) {
    const int row = idx % kBM, c = idx / kBM, r = r0 + row;
    float vals[kVec];
    if (r < rows) {
      load16(q + row_offset(r) + c * kVec, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) qs[(c * kVec + i) * kBM + row] = vals[i];
  }

  int last_key = tk - 1;
  if (causal) last_key = min(last_key, min(rows - 1, r0 + kBM - 1) / rep + q_offset);
  const int n_tiles = last_key / kBN + 1;

  int token[4];
  float m[4], l[4], acc[4][kMaxDims];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    token[i] = (r0 + ty * 4 + i) / rep + q_offset;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxDims; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int key0 = kt * kBN;
    __syncthreads();  // the previous tile's P and V are consumed (Q is staged)
    for (int idx = tid; idx < kBN * chunks; idx += kThreads) {
      const int key = idx / chunks, c = idx % chunks;
      float kv[kVec], vv[kVec];
      if (key0 + key < tk) {
        load16(k + kv_offset(key0 + key) + c * kVec, kv);
        load16(v + kv_offset(key0 + key) + c * kVec, vv);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kv[i] = vv[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(ks + key * ks_ld + c * kVec + i) =
            make_float4(kv[i], kv[i + 1], kv[i + 2], kv[i + 3]);
        *reinterpret_cast<float4*>(vs + key * hd + c * kVec + i) =
            make_float4(vv[i], vv[i + 1], vv[i + 2], vv[i + 3]);
      }
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kBM + ty * 4);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      float kr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kr[j] = ks[(tx + 8 * j) * ks_ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    float corr[4], pr[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = key0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (key >= tk) x = -INFINITY;
        else if (causal && key > token[i]) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        pr[i][j] = round_to(p, T());
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done reading the K tile that P replaces
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 8 * j) * ps_ld + ty * 4) =
          make_float4(pr[0][j], pr[1][j], pr[2][j], pr[3][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxDims; ++j) acc[i][j] *= corr[i];
    const int keys = min(kBN, tk - key0);
    for (int key = 0; key < keys; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + key * ps_ld + ty * 4);
      const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vrow = vs + key * hd + tx;
#pragma unroll
      for (int j = 0; j < kMaxDims; ++j) {
        if (j < n_dims) {
          const float x = vrow[8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p4[i], x, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= rows) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = out + row_offset(r) + tx;
#pragma unroll
    for (int j = 0; j < kMaxDims; ++j)
      if (j < n_dims) store(orow + 8 * j, acc[i][j] / denom);
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMmaKeys = 64;  // keys per K / V tile
constexpr int kMmaStages = 3;
constexpr int kMmaWarps = 4;

template <int HD>
struct MmaTile {
  static constexpr int kRows = 16 * kMmaWarps;        // folded query rows per CTA
  static constexpr int kThreads = 32 * kMmaWarps;
  static constexpr int kLd = HD + 8;                  // bf16 per shared row: 16-byte pad
  static constexpr int kKV = kMmaKeys * kLd;          // bf16 of one K or V tile
  static constexpr int kStage = 2 * kKV;              // K, then V
  static constexpr int kQ = kRows * kLd;              // Q, staged in the last stage
  static constexpr int kSmem =
      2 * ((kMmaStages - 1) * kStage + (kQ > kStage ? kQ : kStage));
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(32 * kMmaWarps, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int tq, int tk, int kvh,
                 int rep, int causal, int q_offset, float scale) {
  using S = MmaTile<HD>;
  constexpr int KD = HD / 16;        // 16-deep steps over the head dim
  constexpr int NS = kMmaKeys / 8;   // 8-key column tiles of S
  constexpr int CH = HD / 8;         // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = ring + (kMmaStages - 1) * S::kStage;

  const int rows = tq * rep;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * S::kRows;
  const int b = blockIdx.y / kvh, g = blockIdx.y % kvh;
  const long long heads = (long long)kvh * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Folded row r -> element offset of its (token, head) row in q / out.
  auto row_offset = [&](int r) -> long long {
    return (((long long)b * tq + r / rep) * heads + (long long)g * rep + r % rep) * HD;
  };
  auto kv_offset = [&](int key) -> long long {
    return (((long long)b * tk + key) * kvh + g) * HD;
  };

  for (int c = tid; c < S::kRows * CH; c += S::kThreads) {
    const int row = c / CH, ch = c % CH;
    const bool ok = r0 + row < rows;
    cp_async16(qs + row * S::kLd + ch * 8, ok ? q + row_offset(r0 + row) + ch * 8 : q, ok);
  }
  cp_async_commit();

  int last_key = tk - 1;
  if (causal) last_key = min(last_key, min(rows - 1, r0 + S::kRows - 1) / rep + q_offset);
  const int n_tiles = last_key / kMmaKeys + 1;

  auto load_tile = [&](int stage, int t) {
    bf16* ks = ring + stage * S::kStage;
    bf16* vs = ks + S::kKV;
    const int key0 = t * kMmaKeys;
    for (int c = tid; c < kMmaKeys * CH; c += S::kThreads) {
      const int key = c / CH, ch = c % CH;
      const bool ok = key0 + key < tk;
      const long long at = ok ? kv_offset(key0 + key) + ch * 8 : 0;
      cp_async16(ks + key * S::kLd + ch * 8, k + at, ok);
      cp_async16(vs + key * S::kLd + ch * 8, v + at, ok);
    }
  };
  // Ring: stage s holds tile s, s + kMmaStages, ...; one group per tile
  // (empty past the end), after Q's own group.
#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }
  cp_async_wait<kMmaStages - 1>();  // Q has landed
  __syncthreads();
  unsigned qf[KD][4];  // A fragments of the warp's 16 rows, all of hd
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x4(qf[kd], qs + (warp * 16 + (lane & 15)) * S::kLd + kd * 16 + (lane >> 4) * 8);

  // This thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8.
  const int wr0 = r0 + warp * 16;
  const int tok_lo = wr0 / rep + q_offset;  // the warp's first token
  const int tok_a = (wr0 + (lane >> 2)) / rep + q_offset;
  const int tok_b = (wr0 + (lane >> 2) + 8) / rep + q_offset;
  const float scale2 = scale * kLog2e;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  float o[2 * KD][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // tile `it` visible; every warp is done with tile it - 1 (and Q)
    const int next = it + kMmaStages - 1;
    if (next < n_tiles) load_tile(next % kMmaStages, next);
    cp_async_commit();
    const bf16* ks = ring + (it % kMmaStages) * S::kStage;
    const bf16* vs = ks + S::kKV;
    const int key0 = it * kMmaKeys;

    // S = Q K^T: K rows are the col operand (matrices: keys 0-7 / 8-15 of a
    // 16-key pair, dims 0-7 / 8-15 of the step).
    float s[NS][4];
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ns][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned kb[4];
        ldsm_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S::kLd + kd * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * np], qf[kd], kb[0], kb[1]);
        mma_16816(s[2 * np + 1], qf[kd], kb[2], kb[3]);
      }

    // Scale in f32 after the product (log2 units), then the mask where the
    // tile crosses the warp's diagonal or Tk.
    const bool masked = key0 + kMmaKeys > tk || (causal && key0 + kMmaKeys - 1 > tok_lo);
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ns][e] *= scale2;
        if (masked) {
          const int key = key0 + ns * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= tk || (causal && key > (e < 2 ? tok_a : tok_b))) s[ns][e] = kNegInf;
        }
      }

    // Online softmax: row maxima over the quad, then corr, p and l.
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) {
      mx_a = fmaxf(mx_a, fmaxf(s[ns][0], s[ns][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[ns][2], s[ns][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd) {
      o[nd][0] *= corr_a;
      o[nd][1] *= corr_a;
      o[nd][2] *= corr_b;
      o[nd][3] *= corr_b;
    }
#pragma unroll
    for (int ns = 0; ns < NS; ++ns)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[ns][e];
        const float p = masked && x == kNegInf ? 0.0f : exp2f(x - (e < 2 ? m_a : m_b));
        s[ns][e] = p;
        if (e < 2) l_a += p; else l_b += p;
      }

    // acc += P.V: P in bf16 from the S registers as A fragments (16 keys a
    // step), V through ldmatrix.trans (dims 0-7 / 8-15 of a 16-dim pair).
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < KD; ++np) {
        unsigned vb[4];
        ldsm_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * S::kLd + np * 16 + (lane >> 4) * 8);
        mma_16816(o[2 * np], pa, vb[0], vb[1]);
        mma_16816(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // acc / l, l summed over the quad (l == 0 read as 1), stored as bf16 pairs.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = l_a == 0.0f ? 1.0f : l_a, den_b = l_b == 0.0f ? 1.0f : l_b;
  const int ra = wr0 + (lane >> 2), rb = ra + 8;
  const int d0 = (lane & 3) * 2;
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd) {
    if (ra < rows)
      *reinterpret_cast<unsigned*>(out + row_offset(ra) + nd * 8 + d0) =
          pack_bf16(o[nd][0] / den_a, o[nd][1] / den_a);
    if (rb < rows)
      *reinterpret_cast<unsigned*>(out + row_offset(rb) + nd * 8 + d0) =
          pack_bf16(o[nd][2] / den_b, o[nd][3] / den_b);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int batch,
                       int tq, int tk, int kvh, int rep, int causal, int q_offset,
                       float scale, cudaStream_t st) {
  using S = MmaTile<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (attr != cudaSuccess) return attr;
  const int rows = tq * rep;
  const dim3 grid((rows + S::kRows - 1) / S::kRows, batch * kvh);
  flash_mma_kernel<HD><<<grid, S::kThreads, S::kSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), tq, tk, kvh, rep, causal, q_offset, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int batch,
                        int tq, int tk, int kvh, int hd, int rep, int causal, int q_offset,
                        float scale, cudaStream_t st) {
#define FLASH_MMA(HD)                                                                   \
  case HD / 16:                                                                         \
    return launch_mma<HD>(q, k, v, out, batch, tq, tk, kvh, rep, causal, q_offset, scale, st)
  if (hd % 16) return cudaErrorInvalidValue;
  switch (hd / 16) {
    FLASH_MMA(16);
    FLASH_MMA(32);
    FLASH_MMA(48);
    FLASH_MMA(64);
    FLASH_MMA(80);
    FLASH_MMA(96);
    FLASH_MMA(112);
    FLASH_MMA(128);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_MMA
}

// ---------------------------------------------------------------------------
// f32 on the FMA units
// ---------------------------------------------------------------------------

int launch_f32(const void* q, const void* k, const void* v, void* out, int batch, int tq,
               int tk, int kvh, int hd, int rep, int causal, int q_offset, float scale,
               cudaStream_t st) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = tq * rep;
  const dim3 grid((rows + kBM - 1) / kBM, batch * kvh);
  flash_attention_kernel<float><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), tq, tk, kvh, hd, rep, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel).  q_offset >= 0 shifts the causal mask (key <= token + q_offset).
// Returns cudaGetLastError() after the launch (0 = launched).
// The caller checks hd <= 128 and hd % 8 == 0 for f32, hd % 16 == 0 for
// bf16, that every pointer is 16-byte aligned and the tensors contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int tq, int tk, int kvh, int hd, int rep,
                                      int causal, int q_offset, float scale, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, out, batch, tq, tk, kvh, hd, rep, causal, q_offset, scale, st);
    case 1:
      return static_cast<int>(launch_bf16(q, k, v, out, batch, tq, tk, kvh, hd, rep, causal,
                                          q_offset, scale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
