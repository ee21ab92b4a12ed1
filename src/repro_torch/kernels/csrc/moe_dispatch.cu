// The MoE layer's dispatch (tokens to expert rows) and combine (expert rows
// back to tokens, weighted) for Hopper (sm_90a), each with its backward.
//
// Replaces no TPU kernel: the JAX package's moe_mlp (src/repro/models/
// layers.py) gathers and combines with jnp indexing that XLA compiles. The
// port's plain version (kernels/ref.py moe_dispatch_ref / moe_combine_ref)
// is PyTorch indexing: the dispatch gathers from the tokens with one zero row
// appended, every empty expert row pointing at it, and the combine gathers
// the rows of a token's k assignments, every dropped one pointing at row 0.
// Autograd turns each gather into index_put_(accumulate=True), which sorts
// the indices and walks each run of equal ones row after row: the thousands
// of empty rows and dropped assignments of a training step are runs of
// thousands, walked serially (on an H100 about 6 ms a mixtral-8x7b training
// microbatch, against a floor of about 50 us). This file computes the same
// functions without them.
//
// The maps (built by models/layers.py moe_maps):
// row_slot[r] is the assignment (token * k + slot) that expert row r holds,
// -1 for an empty row; slot_row[t * k + j] the row of token t's j-th
// assignment, -1 where it was dropped. Each kept assignment owns one row and
// each row holds at most one assignment, so both backwards are gathers too:
// every output row is written by one block, once, with no atomics and no
// sort, and two calls give the same bits.
//
// What bounds it on the H100: bytes (a few fp32 operations a byte). A
// mixtral-8x7b training microbatch moves about 430 MB through the four
// kernels (the forward twice under remat), about 0.13 ms. What the design
// does about it: one block of 128 threads a row or a token, each thread
// loading four 16-byte chunks before it uses any (a warp a token, looping
// over the row, waited on one round trip to memory a chunk: 51 us on an
// H100 at DeepSeek-V3's decode step against a bound of 1.4), 16-byte loads and
// stores only (the width a multiple of 8 and every pointer 16-byte aligned,
// or the entry point refuses the call); only kept rows are read; an empty row
// is written as zeros and never read.
//
// Arithmetic (slot order, fp32, the plain version's roundings):
// - moe_dispatch_kernel: xe[r] = x[row_slot[r] / k], or 0. A copy.
// - moe_dispatch_bwd_kernel: dx[t] = sum over kept j of dxe[slot_row[t,j]],
//   from 0 in fp32 in slot order, rounded once to x's type. For k <= 2 the
//   bits of index_put_: two fp32 addends from 0 commute.
// - moe_combine_kernel: out[t] = sum over kept j of w[t,j] * float(ye[row]),
//   fp32 out, the first kept product then each next one added, __fmul_rn and
//   __fadd_rn (nothing contracted into an FMA): the plain version's loop.
// - moe_combine_bwd_kernel: dye[r] = rounded(w[t,j] * dout[t]) for the (t, j)
//   owning row r, 0 for an empty row; dw[t,j] = sum over d of dout[t,d] *
//   float(ye[row,d]) for a kept assignment (each thread's elements in order
//   by fmaf, a fixed butterfly in each warp, the warps' sums in warp order),
//   0 for a dropped one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// Chunks (of 16 bytes, or 8 elements) a thread loads before it uses any: at
// d_model 4096 or 7168 one or two groups a thread, so a block waits on few
// round trips to memory in turn.
constexpr int GROUP = 4;

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);  // exact
}

__device__ __forceinline__ uint32_t f32_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // round to nearest even, as .to()
}

// Elements i .. i+7 of a row as fp32: one 16-byte load of bf16 or two of fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int i, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p + i);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = bf16_bits_to_f32(w[k] & 0xffffu);
    x[2 * k + 1] = bf16_bits_to_f32(w[k] >> 16);
  }
}

__device__ __forceinline__ void load8(const float* p, int i, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  const float4 b = *reinterpret_cast<const float4*>(p + i + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, int i, const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = f32_to_bf16_bits(x[2 * k]) | (f32_to_bf16_bits(x[2 * k + 1]) << 16);
  *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(float* p, int i, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + i + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// xe[r] = x[row_slot[r] / k] or zeros, in units of 16 bytes: one block a
// row, GROUP units a thread loaded before any is stored.
__global__ void __launch_bounds__(THREADS)
moe_dispatch_kernel(const uint4* __restrict__ x, const int64_t* __restrict__ row_slot, int k,
                    int units, uint4* __restrict__ xe) {
  const int64_t r = blockIdx.x;
  const int64_t a = __ldg(row_slot + r);
  uint4* dst = xe + r * units;
  if (a < 0) {
    for (int u = threadIdx.x; u < units; u += THREADS) dst[u] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* src = x + (a / k) * units;
  for (int u0 = threadIdx.x; u0 < units; u0 += GROUP * THREADS) {
    uint4 v[GROUP];
#pragma unroll
    for (int q = 0; q < GROUP; ++q)
      if (u0 + q * THREADS < units) v[q] = src[u0 + q * THREADS];
#pragma unroll
    for (int q = 0; q < GROUP; ++q)
      if (u0 + q * THREADS < units) dst[u0 + q * THREADS] = v[q];
  }
}

// dx[t] = the sum of dxe over token t's kept rows, fp32 in slot order: one
// block a token, GROUP chunks of 8 a thread.
template <typename T>
__global__ void __launch_bounds__(THREADS)
moe_dispatch_bwd_kernel(const T* __restrict__ dxe, const int64_t* __restrict__ slot_row, int k,
                        int d, T* __restrict__ dx) {
  const int64_t t = blockIdx.x;
  for (int i0 = 8 * threadIdx.x; i0 < d; i0 += 8 * GROUP * THREADS) {
    float acc[GROUP][8] = {};
    for (int j = 0; j < k; ++j) {
      const int64_t r = __ldg(slot_row + t * k + j);
      if (r < 0) continue;
      float v[GROUP][8];
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
        if (i0 + 8 * q * THREADS < d) load8(dxe + r * d, i0 + 8 * q * THREADS, v[q]);
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = __fadd_rn(acc[q][e], v[q][e]);
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q)
      if (i0 + 8 * q * THREADS < d) store8(dx + t * d, i0 + 8 * q * THREADS, acc[q]);
  }
}

// out[t] = the sum of w[t,j] * ye[row] over token t's kept assignments, fp32:
// one block a token, GROUP chunks of 8 a thread.
template <typename T>
__global__ void __launch_bounds__(THREADS)
moe_combine_kernel(const T* __restrict__ ye, const float* __restrict__ w,
                   const int64_t* __restrict__ slot_row, int k, int d,
                   float* __restrict__ out) {
  const int64_t t = blockIdx.x;
  for (int i0 = 8 * threadIdx.x; i0 < d; i0 += 8 * GROUP * THREADS) {
    float acc[GROUP][8] = {};
    bool first = true;
    for (int j = 0; j < k; ++j) {
      const int64_t r = __ldg(slot_row + t * k + j);
      if (r < 0) continue;
      const float wj = __ldg(w + t * k + j);
      float v[GROUP][8];
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
        if (i0 + 8 * q * THREADS < d) load8(ye + r * d, i0 + 8 * q * THREADS, v[q]);
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float p = __fmul_rn(wj, v[q][e]);
          acc[q][e] = first ? p : __fadd_rn(acc[q][e], p);
        }
      first = false;
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q)
      if (i0 + 8 * q * THREADS < d) store8(out + t * d, i0 + 8 * q * THREADS, acc[q]);
  }
}

// Blocks [0, tokens) take a token: dye of each of its kept rows and dw of
// each of its assignments (each thread's elements in order by fmaf, then a
// fixed butterfly in each warp and the warps' sums in warp order). Blocks
// [tokens, tokens + rows) take a row: zeros where it is empty.
template <typename T>
__global__ void __launch_bounds__(THREADS)
moe_combine_bwd_kernel(const T* __restrict__ ye, const float* __restrict__ w,
                       const float* __restrict__ dout, const int64_t* __restrict__ slot_row,
                       const int64_t* __restrict__ row_slot, int64_t tokens, int k, int d,
                       T* __restrict__ dye, float* __restrict__ dw) {
  __shared__ float warp_sums[WARPS];
  if (blockIdx.x >= tokens) {
    const int64_t r = blockIdx.x - tokens;
    if (__ldg(row_slot + r) >= 0) return;  // written by its token's block
    const float zeros[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 8 * threadIdx.x; i < d; i += 8 * THREADS) store8(dye + r * d, i, zeros);
    return;
  }
  const int64_t t = blockIdx.x;
  const float* g = dout + t * d;
  for (int j = 0; j < k; ++j) {
    const int64_t r = __ldg(slot_row + t * k + j);  // the same in every thread
    if (r < 0) {
      if (threadIdx.x == 0) dw[t * k + j] = 0.f;
      continue;
    }
    const float wj = __ldg(w + t * k + j);
    float acc = 0.f;
    for (int i0 = 8 * threadIdx.x; i0 < d; i0 += 8 * GROUP * THREADS) {
      float gv[GROUP][8], yv[GROUP][8];
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
        if (i0 + 8 * q * THREADS < d) {
          load8(g, i0 + 8 * q * THREADS, gv[q]);
          load8(ye + r * d, i0 + 8 * q * THREADS, yv[q]);
        }
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
        if (i0 + 8 * q * THREADS < d) {
          float o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc = fmaf(gv[q][e], yv[q][e], acc);
            o[e] = __fmul_rn(wj, gv[q][e]);
          }
          store8(dye + r * d, i0 + 8 * q * THREADS, o);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = warp_sums[0];
      for (int q = 1; q < WARPS; ++q) sum += warp_sums[q];
      dw[t * k + j] = sum;
    }
    __syncthreads();
  }
}

bool known(int dtype) { return dtype == repro::kFloat32 || dtype == repro::kBFloat16; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The kernels move rows in chunks of 8 elements, 16-byte aligned: the width a
// multiple of 8 and each row array's start 16-byte aligned, or the call is refused.
bool chunked(int d, const void* a, const void* b, const void* c = nullptr) {
  return d % 8 == 0 && aligned16(a) && aligned16(b) && (c == nullptr || aligned16(c));
}

// One block an item; the grid's x dimension holds 2^31 - 1.
bool too_many(int64_t items) { return items > 0x7fffffff; }

}  // namespace

// xe (rows x d, x's type) from x (tokens x d) through row_slot (rows, int64).
extern "C" int moe_dispatch(const void* x, int dtype, const void* row_slot, int64_t rows, int k,
                            int d, void* xe, void* stream) {
  if (!known(dtype) || rows < 0 || too_many(rows) || k < 1 || d < 1 || !chunked(d, x, xe))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int units = d * (dtype == repro::kBFloat16 ? 2 : 4) / 16;
  moe_dispatch_kernel<<<dim3((unsigned)rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int64_t*>(row_slot), k, units,
      static_cast<uint4*>(xe));
  return (int)cudaGetLastError();
}

// dx (tokens x d, dxe's type) from dxe (rows x d) through slot_row (tokens x k).
extern "C" int moe_dispatch_bwd(const void* dxe, int dtype, const void* slot_row, int64_t tokens,
                                int k, int d, void* dx, void* stream) {
  if (!known(dtype) || tokens < 0 || too_many(tokens) || k < 1 || d < 1 || !chunked(d, dxe, dx))
    return (int)cudaErrorInvalidValue;
  if (tokens == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sr = static_cast<const int64_t*>(slot_row);
  const dim3 blocks((unsigned)tokens);
  if (dtype == repro::kBFloat16)
    moe_dispatch_bwd_kernel<<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dxe), sr, k, d, static_cast<__nv_bfloat16*>(dx));
  else
    moe_dispatch_bwd_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const float*>(dxe), sr, k, d,
                                                       static_cast<float*>(dx));
  return (int)cudaGetLastError();
}

// out (tokens x d, fp32) from ye (rows x d) and w (tokens x k, fp32) through
// slot_row (tokens x k).
extern "C" int moe_combine(const void* ye, int dtype, const void* w, const void* slot_row,
                           int64_t tokens, int k, int d, void* out, void* stream) {
  if (!known(dtype) || tokens < 0 || too_many(tokens) || k < 1 || d < 1 || !chunked(d, ye, out))
    return (int)cudaErrorInvalidValue;
  if (tokens == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sr = static_cast<const int64_t*>(slot_row);
  const auto* wf = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  const dim3 blocks((unsigned)tokens);
  if (dtype == repro::kBFloat16)
    moe_combine_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(ye), wf, sr,
                                                  k, d, o);
  else
    moe_combine_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const float*>(ye), wf, sr, k, d,
                                                  o);
  return (int)cudaGetLastError();
}

// dye (rows x d, ye's type) and dw (tokens x k, fp32) from ye, w and dout
// (tokens x d, fp32) through both maps.
extern "C" int moe_combine_bwd(const void* ye, int dtype, const void* w, const void* dout,
                               const void* slot_row, const void* row_slot, int64_t tokens,
                               int64_t rows, int k, int d, void* dye, void* dw, void* stream) {
  if (!known(dtype) || tokens < 0 || rows < 0 || too_many(tokens + rows) || k < 1 || d < 1 ||
      !chunked(d, ye, dout, dye))
    return (int)cudaErrorInvalidValue;
  if (tokens + rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sr = static_cast<const int64_t*>(slot_row);
  const auto* rs = static_cast<const int64_t*>(row_slot);
  const auto* wf = static_cast<const float*>(w);
  const auto* g = static_cast<const float*>(dout);
  auto* dwf = static_cast<float*>(dw);
  const dim3 blocks((unsigned)(tokens + rows));
  if (dtype == repro::kBFloat16)
    moe_combine_bwd_kernel<<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(ye), wf, g, sr, rs, tokens, k, d,
        static_cast<__nv_bfloat16*>(dye), dwf);
  else
    moe_combine_bwd_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const float*>(ye), wf, g, sr,
                                                      rs, tokens, k, d, static_cast<float*>(dye),
                                                      dwf);
  return (int)cudaGetLastError();
}
