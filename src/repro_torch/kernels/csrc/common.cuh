// Shared helpers of the attention kernels: element loads and stores in
// fp32 for the two input types (float, bf16), and the masked-logit value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // masked logit, as in the reference kernels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Dtype codes of the C entry points (kernels/ops.py passes them).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

}  // namespace repro
