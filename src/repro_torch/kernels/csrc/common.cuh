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

// Copy ROWS rows of HD elements from global memory (row r at
// src + (row0 + r) * src_stride) into fp32 shared memory (row r at
// dst + r * dst_stride); rows at or past `valid` read as zeros. Each
// thread first issues all its 16-byte loads, then converts and stores, so
// a block keeps its whole tile in flight instead of one load per thread
// at a time. Needs 16-byte aligned rows: the wrappers check the base
// pointers, and HD * sizeof(T) is a multiple of 16.
template <typename T, int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride, const T* __restrict__ src,
                                          size_t src_stride, int row0, int valid) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = HD / VEC;
  constexpr int TOTAL = ROWS * PER_ROW;
  constexpr int ITERS = (TOTAL + THREADS - 1) / THREADS;
  static_assert(HD % VEC == 0, "rows must be whole 16-byte vectors");
  uint4 buf[ITERS];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int row = row0 + v / PER_ROW;
    buf[i] = (v < TOTAL && row < valid)
                 ? *reinterpret_cast<const uint4*>(src + row * src_stride + (v % PER_ROW) * VEC)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    if (v < TOTAL) {
      const T* e = reinterpret_cast<const T*>(&buf[i]);
      float* out = dst + (v / PER_ROW) * dst_stride + (v % PER_ROW) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = to_f32(e[j]);
    }
  }
}

}  // namespace repro
