// Row-ordered RMSNorm for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// A kernel of the port alone, R1: the reference computes rmsnorm in XLA
// (src/repro/models/layers.py, `rmsnorm`).  It exists to fix the order of
// summation.  PyTorch's CUDA reduction picks its launch shape, and so the
// order in which it adds a row's squares, from the number of rows; a row's
// f32 mean of squares, and so its output, then depends on the rows beside
// it, and decode stops being batch-invariant.  Here every row is summed in
// one order fixed by d alone:
//
//   y = (x * rsqrt(mean(x^2) + eps)).to(T) * gamma.to(T)
//
// with the plain version's casts (f32 arithmetic, the normalised value
// rounded to T, then a product in T: f32 rounded to T).
//
// Design.  One CTA per row, kThreads = 256 threads whatever the row count.
// Thread t adds the squares of its elements in increasing index order: the
// vectors t, t + 256, t + 512, ... of kVec elements each, by 16-byte loads
// where d and the pointers allow it, else element by element in the same
// order (a tail of d % kVec elements ends the last vector).  The load path
// depends on d and the alignment, never on the rows, and a row at d a
// multiple of kVec gives the same bits on either path.
// A warp then adds its 32 partial sums by an xor butterfly (offsets 16, 8,
// 4, 2, 1), and warp 0 adds the 8 warp sums in the same way.  Every step
// is fixed, so a row's sum is a function of that row alone: the same at 1
// row or 4096.  The row is read twice (the sum, then the scaled write); at
// d <= 12288 it stays in L1/L2 between the reads.
//
// What bounds it: bytes.  Each input element is read once and each output
// written once: 2 * rows * d * sizeof(T) over 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// gamma.to(T), back in f32.
template <typename T, typename G>
__device__ __forceinline__ float gamma_as(const G* gamma, long long i) {
  return to_f32<T>(from_f32<T>(to_f32<G>(gamma[i])));
}

template <typename T, typename G, bool kVector>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma, T* __restrict__ out,
               int d, float inv_d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  const int tid = threadIdx.x;

  float acc = 0.f;
  if (kVector) {
    const int nvec = d / kVec;
    for (int v = tid; v < nvec; v += kThreads) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr) + v);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f32<T>(e[j]);
        acc = fmaf(f, f, acc);
      }
    }
  } else {
    // The vector path's order element for element: a row gives the same
    // bits whichever path its alignment takes.
    for (int v = tid; v * kVec < d; v += kThreads) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int i = v * kVec + j;
        if (i < d) {
          const float f = to_f32<T>(xr[i]);
          acc = fmaf(f, f, acc);
        }
      }
    }
  }

  // Fixed-order tree: within each warp, then across the 8 warps.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float warp_sum[kWarps];
  __shared__ float row_scale;
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid < 32) {
    float s = tid < kWarps ? warp_sum[tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tid == 0) row_scale = rsqrtf(s * inv_d + eps);
  }
  __syncthreads();
  const float r = row_scale;

  if (kVector) {
    const int nvec = d / kVec;
    for (int v = tid; v < nvec; v += kThreads) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr) + v);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float n = to_f32<T>(from_f32<T>(to_f32<T>(e[j]) * r));
        o[j] = from_f32<T>(n * gamma_as<T, G>(gamma, (long long)v * kVec + j));
      }
      reinterpret_cast<uint4*>(yr)[v] = res;
    }
  } else {
    for (int i = tid; i < d; i += kThreads) {
      const float n = to_f32<T>(from_f32<T>(to_f32<T>(xr[i]) * r));
      yr[i] = from_f32<T>(n * gamma_as<T, G>(gamma, i));
    }
  }
}

template <typename T, typename G>
int launch(const void* x, const void* gamma, void* out, long long rows, int d, float eps,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const float inv_d = 1.0f / static_cast<float>(d);
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(gamma);
  T* op = static_cast<T*>(out);
  if (vec) {
    rmsnorm_kernel<T, G, true><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        xp, gp, op, d, inv_d, eps);
  } else {
    rmsnorm_kernel<T, G, false><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        xp, gp, op, d, inv_d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) contiguous of dtype code `dtype` (0 f32, 1 bf16); gamma:
// (d,) contiguous of code `gamma_dtype`.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for codes or sizes it does not take.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out, long long rows,
                              int d, int dtype, int gamma_dtype, float eps, void* stream) {
  if (rows <= 0 || rows >= (1LL << 31) || d <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gamma_dtype == 0) return launch<float, float>(x, gamma, out, rows, d, eps, s);
  if (dtype == 0 && gamma_dtype == 1) {
    return launch<float, __nv_bfloat16>(x, gamma, out, rows, d, eps, s);
  }
  if (dtype == 1 && gamma_dtype == 0) {
    return launch<__nv_bfloat16, float>(x, gamma, out, rows, d, eps, s);
  }
  if (dtype == 1 && gamma_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, out, rows, d, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
