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
// that order first).  The causal mask compares token positions,
// key <= r / rep, with no query offset (causal needs Tq == Tk).
//
// Grid: (row tiles of 64, B * KV); one CTA of 128 threads per tile, heaviest
// causal tiles launched first.  The CTA stages its 64 query rows in shared
// memory (transposed, f32), then walks 64-key tiles of K and V up to its
// causal limit; tiles wholly above the diagonal are skipped, since their
// probabilities are exactly 0.  Thread (ty, tx) = (tid / 8, tid % 8) owns
// rows 4 ty .. 4 ty + 3, keys tx + 8 j of each tile and head dims tx + 8 j of
// the accumulator.  Per tile: f32 scores of f32-upcast operands times
// hd^-0.5; the -1e30 causal mask (keys past Tk are -inf: the reference has
// none); m' = max(m, max s), corr = exp(m - m'), l' = l * corr + sum p with p
// in f32, and acc' = acc * corr + p . v with p rounded to the input type
// first, as the reference rounds it; the probabilities pass to the P.V
// product through shared memory (where K was).  The output is acc / l, with
// l == 0 read as 1, in the input type.  f32 inputs run on f32 FMA, never
// TF32.
//
// What bounds it on this card: operations.  Causal Qwen2-7B prefill at
// T = 2048 (28 heads, hd 128) is 30 GFLOP against 34 MB of Q, K, V and O:
// about 0.030 ms at the bf16 tensor-core rate against 0.010 ms of bytes.
// This first version computes on SIMT FMA (scores and P.V from shared
// memory, 4 x 8 and 4 x 16 register tiles per thread), so it sits far above
// that bound; what its design does keep is the traffic: each K/V tile is
// read once per 64 query rows, which hold 64 / rep tokens of all rep heads
// of one kv head, and no score leaves the chip.  Tensor cores (mma.sync,
// then wgmma with TMA) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBM = 64;  // query rows per CTA
constexpr int kBN = 64;  // keys per tile
constexpr int kMaxHeadDim = 128;
constexpr int kMaxDims = kMaxHeadDim / 8;  // accumulator dims per thread

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Sixteen bytes of `src` (4 floats or 8 bf16) as floats.
__device__ __forceinline__ void load16(const float* src, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
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
                       int kvh, int hd, int rep, int causal, float scale) {
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
  if (causal) last_key = min(last_key, min(rows - 1, r0 + kBM - 1) / rep);
  const int n_tiles = last_key / kBN + 1;

  int token[4];
  float m[4], l[4], acc[4][kMaxDims];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    token[i] = (r0 + ty * 4 + i) / rep;
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int tq, int tk,
           int kvh, int hd, int rep, int causal, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = tq * rep;
  const dim3 grid((rows + kBM - 1) / kBM, batch * kvh);
  flash_attention_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), tq, tk, kvh, hd, rep, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).  The caller checks hd <= 128 and hd % 8 == 0, that
// every pointer is 16-byte aligned and the tensors contiguous, and that
// causal calls have tq == tk.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int tq, int tk, int kvh, int hd, int rep,
                                      int causal, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, batch, tq, tk, kvh, hd, rep, causal, scale, st);
  return launch<float>(q, k, v, out, batch, tq, tk, kvh, hd, rep, causal, scale, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
