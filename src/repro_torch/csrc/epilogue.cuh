// The fused epilogue's pieces shared by the port's GEMM kernels
// (mesh_matmul.cu, K1; grouped_matmul.cu, K5): the activation codes of the
// Python wrappers (`_ACT_CODES` in kernels/mesh_matmul.py), the activations
// on the f32 accumulator, and the loads and stores of f32 and bf16.
#pragma once

#include <cuda_bf16.h>

namespace {

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2/pi), as mesh_matmul.py
constexpr float kGeluA = 0.044715f;

enum Act { kNone = 0, kRelu = 1, kSilu = 2, kSigmoid = 3, kTanh = 4, kGelu = 5 };

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

__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case kRelu: return fmaxf(x, 0.0f);
    case kSilu: return x * (1.0f / (1.0f + expf(-x)));
    case kSigmoid: return 1.0f / (1.0f + expf(-x));
    case kTanh: return tanhf(x);
    case kGelu: return 0.5f * x * (1.0f + tanhf(kGeluC * (x + kGeluA * x * x * x)));
    default: return x;
  }
}

}  // namespace
