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
// One CTA per (slot, kv_head).  The CTA loads its own block-table row and
// length from device memory (the TPU kernel scalar-prefetched them), walks
// the live pages in order and skips pages with p * page_size >= length.
// Keys at or past `length` score -1e30.  The online-softmax state (m, l) and
// the f32 accumulator for the rep query rows stay in shared memory and
// registers; per page: m' = max(m, max s), corr = exp(m - m'),
// l' = l * corr + sum p, acc' = acc * corr + p . v, with p rounded to the
// pool's type before the p . v product as the reference does.  The output is
// acc / l with l == 0 read as 1.  Scale is hd^-0.5.
//
// What bounds it on this card: bytes.  Each live K and V row is read once
// (rep query rows share it), q and the output are tiny, and the arithmetic
// is two hd-long dot products per key and query row.  At mesh-paper decode
// (4 slots x 16 KV heads, 128-192 token contexts) the whole call moves well
// under a megabyte, so launch latency, not bandwidth, is what it costs; the
// design keeps it one launch per layer with no gathered copy of the context.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxRep = 8;
constexpr int kThreads = 128;  // one head dim per thread: hd <= 128

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int n_pages, int ps, int kvh, int hd, int rep, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                // rep * hd query rows, f32
  float* sc = q_s + rep * hd;       // rep * ps scores, then probabilities
  float* corr_s = sc + rep * ps;    // rep
  float* m_s = corr_s + rep;        // rep running max
  float* l_s = m_s + rep;           // rep running denominator

  const int s = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const long long heads = (long long)kvh * rep;
  const long long q_off = ((long long)s * heads + (long long)j * rep) * hd;

  for (int e = tid; e < rep * hd; e += kThreads) q_s[e] = to_f32(q[q_off + e]);
  if (tid < rep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  const int length = lengths[s];
  const int* bt = block_tables + (long long)s * n_pages;

  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.0f;
  __syncthreads();

  const int live = min(n_pages, (length + ps - 1) / ps);
  for (int p = 0; p < live; ++p) {
    const long long row0 = (long long)bt[p] * ps;  // first pool row of the page
    // Scores: one warp per key, lanes split the head dim.
    for (int t = warp; t < ps; t += kWarps) {
      const T* krow = k_pool + ((row0 + t) * kvh + j) * hd;
      const bool valid = p * ps + t < length;
      for (int r = 0; r < rep; ++r) {
        float part = 0.0f;
        for (int d = lane; d < hd; d += 32) part += q_s[r * hd + d] * to_f32(krow[d]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) sc[r * ps + t] = valid ? part * scale : kNegInf;
      }
    }
    __syncthreads();
    // Online-softmax update, one thread per query row.
    if (tid < rep) {
      float* row = sc + tid * ps;
      float mx = kNegInf;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, row[t]);
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const float pr = expf(row[t] - m_new);
        row[t] = pr;
        sum += pr;
      }
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      corr_s[tid] = corr;
    }
    __syncthreads();
    // acc = acc * corr + p . v, one head dim per thread.
    if (tid < hd) {
      float pv[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) pv[r] = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const float v = to_f32(v_pool[((row0 + t) * kvh + j) * hd + tid]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) pv[r] += to_f32(from_f32<T>(sc[r * ps + t])) * v;
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) acc[r] = acc[r] * corr_s[r] + pv[r];
    }
    __syncthreads();  // sc is rewritten by the next page
  }

  if (tid < hd) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      float l = l_s[r];
      if (l == 0.0f) l = 1.0f;
      out[q_off + (long long)r * hd + tid] = from_f32<T>(acc[r] / l);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).  rep <= 8 and hd <= 128 are checked by the caller.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* lengths,
                                      void* out, int slots, int n_pages, int ps, int kvh,
                                      int hd, int rep, float scale, int dtype,
                                      void* stream) {
  const dim3 grid(slots, kvh);
  const size_t smem = sizeof(float) * ((size_t)rep * hd + (size_t)rep * ps + 3 * (size_t)rep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    paged_attention_kernel<T><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
        bt, ln, static_cast<T*>(out), n_pages, ps, kvh, hd, rep, scale);
  } else {
    paged_attention_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), bt, ln, static_cast<float*>(out), n_pages, ps,
        kvh, hd, rep, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
