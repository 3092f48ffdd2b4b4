// Paged-KV decode attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention.py, body `_paged_kernel`): one query
// token per sequence slot attends over that slot's KV pages, addressed
// through its block table, with grouped-query heads (rep = H / KV query rows
// share one KV head).
//
//   q             (S, H, hd)              one token per slot
//   k_pool/v_pool (P, page_size, KV, hd)  shared pools, page 0 = scratch
//   block_tables  (S, n_pages) int32      page ids per slot
//   lengths       (S,) int32              valid length incl. the new token
//
// Keys at or past `length` are masked (the reference scores them -1e30,
// which gives them probability 0 whenever one key is valid); scale is
// hd^-0.5; p is rounded to the pool's type before the p . v product, the
// denominator l sums the unrounded p; the output is acc / l with l == 0
// read as 1.
//
// What bounds it on this card: bytes.  Each live K and V row is read once,
// the rep query rows of a KV head share it, and the arithmetic is two
// hd-long dot products per key and query row.  At Qwen2-7B's decode (4 slots
// x 4 KV heads, 2-4k-token contexts) that is 23 MB, 7 us at 3.35 TB/s; a
// grid of one CTA per (slot, KV head) would leave 116 of 132 SMs idle and
// walk 500 pages in order.  So the design is split-context ("flash
// decoding"), launches on one stream:
//
//   1. paged_split_kernel, grid (slot, kv_head, split), once per chunk of at
//      most kMaxRep of each KV head's rep query rows (rep 12 runs as 8 + 4;
//      the chunk's first row is an offset into q and into the partials,
//      which hold all rep rows, so nothing is copied).  Each split covers a
//      fixed run of `split_pages` pages, chosen by the host from the table
//      width and the SM count alone (never from `lengths`, so no host sync).
//      A CTA whose split starts at or past its slot's length writes an empty
//      partial (m = -1e30, l = 0) and exits.  Otherwise it loads the split's
//      block-table slice and the chunk's query rows (f32) into shared memory
//      once; each of its 4 warps takes its own pages.  A K or V row is read
//      with 16-byte loads by a group of hd / (16 / sizeof(T)) lanes (16 lanes
//      for a 128-wide bf16 row, so a warp scores two keys at once), each
//      group holds up to 4 keys of a page in flight, scores the chunk's
//      query rows against each key (one kernel per chunk size, its loops
//      unrolled) with a log2(lanes)-step shuffle, and keeps its own online
//      softmax state (m, l, acc) for those rows in registers, in log2 units
//      so that each exponential is one exp2f.  No barrier inside the loop:
//      the groups of a warp merge by shuffles, the warps through shared
//      memory once at the end, in a fixed order, into the split's partial
//      (m, l: f32 (S, KV, splits, rep); acc: f32 (S, KV, splits, rep, hd)).
//   2. paged_combine_kernel, grid (slot, kv_head, query row), one launch
//      over all rep rows after the chunks, merges the partials in split
//      order: M = max m_s, out = sum acc_s e^(m_s - M) / sum l_s e^(m_s -
//      M); empty splits (l_s == 0) contribute nothing.
//
// The order of every sum is fixed by the shapes, so the result is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxRep = 8;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSplitPages = 64;  // kernels/paged_attention.py: _MAX_SPLIT_PAGES
constexpr int kKeysInFlight = 4;    // keys a lane group loads before it scores them

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T as f32 values: 8 for bf16, 4 for f32.
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

// The probability as the P.V product sees it: rounded to the pool's type.
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  return to_f32(from_f32<T>(p));
}

// Scores are kept in log2 units (times log2 e), so every exponential is one
// exp2f; m and the partials' m are in the same units.
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int REP>
__global__ void __launch_bounds__(kThreads, 4)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc, int n_pages,
                   int ps, int kvh, int hd, int rep, int r0, int lanes_per_key,
                   int split_pages, int n_splits, float scale) {
  // Rows r0 .. r0 + REP - 1 of the rep query rows of KV head blockIdx.y.
  constexpr int VEC = Vec16<T>::n;
  __shared__ int pages_s[kMaxSplitPages];
  __shared__ __align__(16) float q_s[REP][kMaxHeadDim];  // the chunk's query rows, f32
  __shared__ float m_s[kWarps][REP];
  __shared__ float l_s[kWarps][REP];
  __shared__ float acc_s[kWarps][REP][kMaxHeadDim];

  const int s = blockIdx.x;
  const int j = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[s];
  const int p0 = split * split_pages;
  const int live = min(n_pages, (length + ps - 1) / ps);  // pages holding a valid key
  const int n_here = min(split_pages, live - p0);         // this split's live pages
  const long long part = ((long long)(s * kvh + j) * n_splits + split) * rep + r0;
  if (n_here <= 0) {  // the split starts at or past the length: an empty partial
    if (tid < REP) {
      part_m[part + tid] = kNegInf;
      part_l[part + tid] = 0.0f;
    }
    return;
  }
  for (int i = tid; i < n_here; i += kThreads)
    pages_s[i] = block_tables[(long long)s * n_pages + p0 + i];
  const T* qrows = q + ((long long)s * kvh * rep + (long long)j * rep + r0) * hd;
  for (int e = tid; e < REP * hd; e += kThreads) q_s[e / hd][e % hd] = to_f32(qrows[e]);

  const int group = lane / lanes_per_key;  // which key of the warp's step this lane scores
  const int keys_per_warp = 32 / lanes_per_key;
  const int d0 = (lane % lanes_per_key) * VEC;  // this lane's first head dim
  const bool has_dims = d0 < hd;
  const float scale2 = scale * kLog2e;

  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.0f;
  }
  __syncthreads();  // pages_s, q_s

  const int key_step = keys_per_warp * kKeysInFlight;
  for (int i = warp; i < n_here; i += kWarps) {
    const long long row0 = (long long)pages_s[i] * ps;  // first pool row of the page
    const int tok0 = (p0 + i) * ps;                     // its first token
    // The same trip count on every lane: the shuffles below need the whole warp.
    for (int t0 = 0; t0 < ps; t0 += key_step) {
      // Start every load of this step before any arithmetic.
      uint4 kraw[kKeysInFlight], vraw[kKeysInFlight];
      bool valid[kKeysInFlight];
      bool any = false;
#pragma unroll
      for (int c = 0; c < kKeysInFlight; ++c) {
        const int t = t0 + c * keys_per_warp + group;
        valid[c] = t < ps && tok0 + t < length;
        any |= valid[c];
        kraw[c] = vraw[c] = make_uint4(0, 0, 0, 0);
        if (valid[c] && has_dims) {
          const long long off = ((row0 + t) * kvh + j) * hd + d0;
          kraw[c] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
          vraw[c] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
        }
      }
      // Scores of the rep rows against each key, reduced over the key's lanes
      // (every lane takes part in the shuffles; masked keys read zeros).
      float sc[kKeysInFlight][REP];
#pragma unroll
      for (int c = 0; c < kKeysInFlight; ++c) {
        float kf[VEC];
        unpack(kraw[c], kf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float dot = 0.0f;
          if (has_dims) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(&q_s[r][d0 + e]);
              dot = fmaf(qv.x, kf[e], dot);
              dot = fmaf(qv.y, kf[e + 1], dot);
              dot = fmaf(qv.z, kf[e + 2], dot);
              dot = fmaf(qv.w, kf[e + 3], dot);
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)  // warp-uniform: off < lanes_per_key
            if (off < lanes_per_key) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          sc[c][r] = dot * scale2;
        }
      }
      if (!any) continue;  // uniform over the lane group
      // Online softmax over this step's valid keys, per query row.
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float mx = m[r];
#pragma unroll
        for (int c = 0; c < kKeysInFlight; ++c)
          if (valid[c]) mx = fmaxf(mx, sc[c][r]);
        const float corr = exp2f(m[r] - mx);
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
        m[r] = mx;
      }
#pragma unroll
      for (int c = 0; c < kKeysInFlight; ++c) {
        if (!valid[c]) continue;
        float vf[VEC];
        unpack(vraw[c], vf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float p = exp2f(sc[c][r] - m[r]);
          l[r] += p;
          const float pr = round_to<T>(p);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
        }
      }
    }
  }

  // Merge the lane groups of the warp (group g with g ^ 1, then g ^ 2, ...).
  for (int off = lanes_per_key; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float c1 = exp2f(m[r] - mx);
      const float c2 = exp2f(mo - mx);
      l[r] = l[r] * c1 + lo * c2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * c1 + ao * c2;
      }
      m[r] = mx;
    }
  }
  // Then the warps, in warp order, through shared memory.
  if (lane < lanes_per_key) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (lane == 0) {
        m_s[warp][r] = m[r];
        l_s[warp][r] = l[r];
      }
      if (has_dims) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc_s[warp][r][d0 + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < REP * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    float a = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(m_s[w][r] - mx);
      a += acc_s[w][r][d] * c;
      lsum += l_s[w][r] * c;
    }
    part_acc[(part + r) * hd + d] = a;
    if (d == 0) {
      part_m[part + r] = mx;
      part_l[part + r] = lsum;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out, int kvh,
                     int hd, int rep, int n_splits) {
  extern __shared__ float ml_s[];  // m_s then l_s of the n_splits partials
  float* w_s = ml_s;               // m_s, then the weights 2^(m_s - M)
  float* l_s = ml_s + n_splits;
  __shared__ float den_s;
  __shared__ int live_s;
  const int s = blockIdx.x;
  const int j = blockIdx.y;
  const int r = blockIdx.z;
  const long long first = (long long)(s * kvh + j) * n_splits;  // split 0 of (s, j)
  for (int sp = threadIdx.x; sp < n_splits; sp += blockDim.x) {
    const long long at = (first + sp) * rep + r;
    w_s[sp] = part_m[at];
    l_s[sp] = part_l[at];
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // M and the denominator, in split order
    // The empty splits (l == 0) are those past the length: a suffix.
    int live = 0;
    float mx = kNegInf;
    for (int sp = 0; sp < n_splits; ++sp)
      if (l_s[sp] > 0.0f) {
        mx = fmaxf(mx, w_s[sp]);
        live = sp + 1;
      }
    float den = 0.0f;
    for (int sp = 0; sp < live; ++sp) {
      const float w = exp2f(w_s[sp] - mx);
      w_s[sp] = w;
      den += l_s[sp] * w;
    }
    den_s = den == 0.0f ? 1.0f : den;
    live_s = live;
  }
  __syncthreads();
  const float den = den_s;
  const int live = live_s;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    const float* acc = part_acc + (first * rep + r) * hd + d;  // split sp at sp * rep * hd
    float num = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < live; ++sp) num += acc[(long long)sp * rep * hd] * w_s[sp];
    out[((long long)s * kvh * rep + (long long)j * rep + r) * hd + d] = from_f32<T>(num / den);
  }
}

template <typename T, int REP>
cudaError_t launch_split(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                         const int* ln, float* part_m, float* part_l, float* part_acc,
                         int slots, int n_pages, int ps, int kvh, int hd, int rep, int r0,
                         int lanes_per_key, int split_pages, int n_splits, float scale,
                         cudaStream_t st) {
  paged_split_kernel<T, REP><<<dim3(slots, kvh, n_splits), kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      bt, ln, part_m, part_l, part_acc, n_pages, ps, kvh, hd, rep, r0, lanes_per_key,
      split_pages, n_splits, scale);
  return cudaGetLastError();
}

// The split kernel over each chunk (r0[c], n[c]) of the rep rows, then one
// combine over all of them.
template <typename T>
cudaError_t launch_rep(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                       const int* ln, void* out, float* part_m, float* part_l,
                       float* part_acc, int slots, int n_pages, int ps, int kvh, int hd,
                       int rep, const int* chunk_r0, const int* chunk_n, int n_chunks,
                       int split_pages, int n_splits, float scale, cudaStream_t st) {
  const int need = hd / Vec16<T>::n;  // lanes that cover one row
  int lanes = 1;
  while (lanes < need) lanes <<= 1;
  for (int c = 0; c < n_chunks; ++c) {
    const int r0 = chunk_r0[c];
    cudaError_t err;
#define PAGED_SPLIT(R)                                                                      \
  case R:                                                                                   \
    err = launch_split<T, R>(q, k_pool, v_pool, bt, ln, part_m, part_l, part_acc, slots,    \
                             n_pages, ps, kvh, hd, rep, r0, lanes, split_pages, n_splits,   \
                             scale, st);                                                    \
    break
    switch (chunk_n[c]) {  // one kernel per chunk size, its row loops unrolled
      PAGED_SPLIT(1);
      PAGED_SPLIT(2);
      PAGED_SPLIT(3);
      PAGED_SPLIT(4);
      PAGED_SPLIT(5);
      PAGED_SPLIT(6);
      PAGED_SPLIT(7);
      PAGED_SPLIT(8);
      default: return cudaErrorInvalidValue;
    }
#undef PAGED_SPLIT
    if (err != cudaSuccess) return err;
  }
  paged_combine_kernel<T><<<dim3(slots, kvh, rep), kThreads, 2 * n_splits * sizeof(float), st>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), kvh, hd, rep, n_splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The rep query rows of each KV head run
// in n_chunks chunks, chunk c being rows chunk_r0[c] .. chunk_r0[c] +
// chunk_n[c] - 1 (host arrays; kernels/paged_attention.py: rep_chunks), each
// of at most kMaxRep rows, together covering every row once.  Returns
// cudaGetLastError() after the launches (0 = launched).  The caller checks
// hd <= 128 with hd a multiple of 16 bytes, 16-byte aligned pools,
// split_pages <= 64, n_splits * split_pages >= n_pages and 8 * n_splits + 8
// <= 48 KiB (the combine's shared memory), and allocates the partials:
// part_m and part_l (S, KV, n_splits, rep), part_acc (S, KV, n_splits, rep,
// hd), f32.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* lengths,
                                      void* out, void* part_m, void* part_l, void* part_acc,
                                      int slots, int n_pages, int ps, int kvh, int hd,
                                      int rep, const int* chunk_r0, const int* chunk_n,
                                      int n_chunks, int split_pages, int n_splits,
                                      float scale, int dtype, void* stream) {
  if (rep < 1 || hd > kMaxHeadDim || split_pages > kMaxSplitPages || split_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < n_chunks; ++c)
    if (chunk_r0[c] < 0 || chunk_n[c] < 1 || chunk_n[c] > kMaxRep ||
        chunk_r0[c] + chunk_n[c] > rep)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 1)
    return static_cast<int>(launch_rep<__nv_bfloat16>(q, k_pool, v_pool, bt, ln, out, pm, pl,
                                                      pa, slots, n_pages, ps, kvh, hd, rep,
                                                      chunk_r0, chunk_n, n_chunks, split_pages,
                                                      n_splits, scale, st));
  return static_cast<int>(launch_rep<float>(q, k_pool, v_pool, bt, ln, out, pm, pl, pa, slots,
                                            n_pages, ps, kvh, hd, rep, chunk_r0, chunk_n,
                                            n_chunks, split_pages, n_splits, scale, st));
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
