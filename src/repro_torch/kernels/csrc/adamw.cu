// AdamW for Hopper (sm_90a): the clipped global norm of the gradients, then
// one elementwise pass a leaf that reads p, g, mu and nu once and writes the
// new p, mu and nu into fresh buffers (the update stays functional).
//
// Replaces no TPU kernel: the JAX package leaves repro.optim.adamw to XLA,
// which fuses it. The port's plain version (kernels/ref.py adamw_update_ref,
// about 25 unfused fp32 passes, ~196 bytes a parameter) is what this
// replaces on the card; it is also the function computed here, operation for
// operation, in fp32.
//
// What bounds it on the H100: bytes. A bf16 parameter with a bf16 gradient
// is read as p (2), g (2), mu (4), nu (4) and written as p (2), mu (4),
// nu (4); the norm reads g once more (2): 24 bytes for about 16 fp32
// operations, under one a byte against the ~20 a byte the card's fp32 units
// could do. What the design does about it:
// - three kernels, all on the caller's stream with no host sync:
//   adamw_sumsq_kernel (per leaf, a fixed grid of `slots` blocks, each
//   writing its partial sum of squares into its own slot of one scratch
//   buffer), adamw_finalize_kernel (one block: the norm, the clip scale,
//   count + 1, the bias corrections and the learning rate, from device
//   memory, into a small buffer) and adamw_update_kernel (per leaf, a
//   grid-stride loop over groups of 8 elements sized to the 132 SMs);
// - 16-byte loads and stores with the streaming hint (ld/st .cs): every
//   byte is touched once and 41 GB pass through a 50 MB L2 a mixtral step;
//   a view with an unaligned start, or any pointer not 16-byte aligned,
//   takes scalar loads of the same groups, and the ragged tail is a group
//   with its missing elements masked, so the work a thread does, and the
//   order of every sum, depends on the sizes alone;
// - the norm is repeatable to the bit: no float atomics; each thread sums
//   its groups' squares (each group's 8 in a fixed fp32 tree) in fp64, a
//   block reduces in a fixed tree and rounds to its fp32 partial; a leaf's
//   partials are summed by one warp in fp64 in a fixed order and rounded to
//   fp32, and the leaves' sums are added in fp32 in leaf order, as the
//   plain version adds its per-leaf sums. adamw_leaf_total_kernel is that
//   warp's sum for one leaf alone: the sharded route's per-shard sum, so a
//   mesh of one device gives the unsharded route's bits;
// - the update keeps the plain version's operations and their order in
//   fp32 (g·scale, b1·m + (1−b1)·g, b2·v + ((1−b2)·g)·g, m/b1c, v/b2c, sqrt,
//   + eps, the division, + wd·p, p − lr·step, the cast to p's type) with
//   the _rn intrinsics, so nothing is contracted into an FMA, no division
//   or square root is approximated, and on equal coefficients its results
//   equal the plain version's on the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMS = 132;                   // the H100 SXM's streaming multiprocessors
constexpr int UPDATE_BLOCKS = 8 * SMS;     // 2048 threads an SM where registers allow
constexpr int UNROLL = 4;                  // groups a thread of the sum loads at once
constexpr int MAX_LEAVES = 12288;          // the finalize block's per-leaf sums in 48 KB

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);  // exact
}

__device__ __forceinline__ uint32_t f32_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // round to nearest even, as .to()
}

// The 8 elements i .. i+7 as fp32: one 16-byte load of bf16 or two of fp32
// where `vec` (every pointer of the kernel 16-byte aligned) and the group is
// whole; else element by element, 0 past n.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool vec, int64_t i, int64_t n,
                                      float (&x)[8]) {
  if (vec && i + 8 <= n) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p + i));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = bf16_bits_to_f32(w[k] & 0xffffu);
      x[2 * k + 1] = bf16_bits_to_f32(w[k] >> 16);
    }
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = i + k < n ? bf16_bits_to_f32(__ldcs(q + i + k)) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* p, bool vec, int64_t i, int64_t n,
                                      float (&x)[8]) {
  if (vec && i + 8 <= n) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p + i));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p + i + 4));
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = i + k < n ? __ldcs(p + i + k) : 0.f;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, bool vec, int64_t i, int64_t n,
                                       const float (&x)[8]) {
  if (vec && i + 8 <= n) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = f32_to_bf16_bits(x[2 * k]) | (f32_to_bf16_bits(x[2 * k + 1]) << 16);
    __stcs(reinterpret_cast<uint4*>(p + i), make_uint4(w[0], w[1], w[2], w[3]));
  } else {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i + k < n) __stcs(q + i + k, (unsigned short)f32_to_bf16_bits(x[k]));
  }
}

__device__ __forceinline__ void store8(float* p, bool vec, int64_t i, int64_t n,
                                       const float (&x)[8]) {
  if (vec && i + 8 <= n) {
    __stcs(reinterpret_cast<float4*>(p + i), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(p + i + 4), make_float4(x[4], x[5], x[6], x[7]));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i + k < n) __stcs(p + i + k, x[k]);
  }
}

__device__ __forceinline__ bool aligned16(uintptr_t bits) { return (bits & 15) == 0; }

// torch's .to(bfloat16) then .float(): the gradient compression's round trip
__device__ __forceinline__ float bf16_round_trip(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// fp64 sum over the block in a fixed tree; the result is thread 0's
__device__ double block_sum(double v) {
  __shared__ double warp_sums[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += warp_sums[w];
  return s;
}

// One leaf's partials summed by one warp in fp64 in a fixed order, rounded to
// fp32; the result is lane 0's. Both the finalize and the per-shard total run
// this, so they agree to the bit.
__device__ float warp_leaf_sum(const float* __restrict__ slots, int n) {
  const int lane = threadIdx.x & 31;
  double a = 0.0;
  for (int j = lane; j < n; j += 32) a += (double)slots[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
  return (float)a;
}

template <typename G>
__global__ void __launch_bounds__(THREADS) adamw_sumsq_kernel(const G* __restrict__ g, int64_t n,
                                                              bool round_bf16,
                                                              float* __restrict__ partials) {
  const bool vec = aligned16(reinterpret_cast<uintptr_t>(g));
  const int64_t groups = (n + 7) / 8;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  double acc = 0.0;
  for (int64_t base = (int64_t)blockIdx.x * THREADS + threadIdx.x; base < groups;
       base += UNROLL * stride) {
    float x[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // every load first, then the sums in order
      const int64_t gi = base + u * stride;
      if (gi < groups) load8(g, vec, gi * 8, n, x[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * stride >= groups) break;
      float q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v = round_bf16 ? bf16_round_trip(x[u][k]) : x[u][k];
        q[k] = __fmul_rn(v, v);
      }
      const float s = __fadd_rn(__fadd_rn(__fadd_rn(q[0], q[1]), __fadd_rn(q[2], q[3])),
                                __fadd_rn(__fadd_rn(q[4], q[5]), __fadd_rn(q[6], q[7])));
      acc += (double)s;
    }
  }
  const double total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = (float)total;
}

__global__ void adamw_leaf_total_kernel(const float* __restrict__ partials, int slots,
                                        float* __restrict__ out) {
  const float s = warp_leaf_sum(partials, slots);
  if (threadIdx.x == 0) out[0] = s;
}

struct Finalize {
  float lr_mul;   // cfg.lr (times *lr_scale), or the learning rate itself without lr_scale
  float b1, b2, clip_norm;
};

// coef = {clip scale, 1 − b1^count, 1 − b2^count, lr}, with count the new one
__global__ void __launch_bounds__(THREADS) adamw_finalize_kernel(
    const float* __restrict__ partials, int n_leaves, int slots, const int* __restrict__ count,
    const float* __restrict__ lr_scale, Finalize f, float* __restrict__ gnorm,
    float* __restrict__ coef, int* __restrict__ count_out) {
  extern __shared__ float leaf_sums[];
  const int warp = threadIdx.x >> 5;
  for (int l = warp; l < n_leaves; l += WARPS) {
    const float s = warp_leaf_sum(partials + (int64_t)l * slots, slots);
    if ((threadIdx.x & 31) == 0) leaf_sums[l] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float total = 0.f;
  for (int l = 0; l < n_leaves; ++l) total = __fadd_rn(total, leaf_sums[l]);
  // the plain version's ops: sqrt; clip / (gnorm + 1e-9), which torch computes as
  // reciprocal(gnorm + 1e-9) * clip; clamp(max=1); pow(b1, float(count)); lr·lr_scale
  const float gn = __fsqrt_rn(total);
  float scale = __fmul_rn(__frcp_rn(__fadd_rn(gn, 1e-9f)), f.clip_norm);
  scale = scale > 1.f ? 1.f : scale;  // a NaN stays NaN, as torch.clamp's
  const int c = count[0] + 1;
  gnorm[0] = gn;
  coef[0] = scale;
  coef[1] = __fsub_rn(1.f, powf(f.b1, (float)c));
  coef[2] = __fsub_rn(1.f, powf(f.b2, (float)c));
  coef[3] = lr_scale != nullptr ? __fmul_rn(lr_scale[0], f.lr_mul) : f.lr_mul;
  count_out[0] = c;
}

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
  bool round_bf16, decay;
};

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS) adamw_update_kernel(
    const P* __restrict__ p, const G* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ v, P* __restrict__ p_out, float* __restrict__ m_out,
    float* __restrict__ v_out, const float* __restrict__ coef, int64_t n, Hyper h) {
  const float scale = coef[0], b1c = coef[1], b2c = coef[2], lr = coef[3];
  const bool vec = aligned16(reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                             reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v) |
                             reinterpret_cast<uintptr_t>(p_out) |
                             reinterpret_cast<uintptr_t>(m_out) |
                             reinterpret_cast<uintptr_t>(v_out));
  const int64_t groups = (n + 7) / 8;
  for (int64_t gi = (int64_t)blockIdx.x * THREADS + threadIdx.x; gi < groups;
       gi += (int64_t)gridDim.x * THREADS) {
    const int64_t i = gi * 8;
    float pf[8], gf[8], mf[8], vf[8];
    load8(p, vec, i, n, pf);
    load8(g, vec, i, n, gf);
    load8(m, vec, i, n, mf);
    load8(v, vec, i, n, vf);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float gk = __fmul_rn(h.round_bf16 ? bf16_round_trip(gf[k]) : gf[k], scale);
      mf[k] = __fadd_rn(__fmul_rn(h.b1, mf[k]), __fmul_rn(h.one_minus_b1, gk));
      vf[k] = __fadd_rn(__fmul_rn(h.b2, vf[k]), __fmul_rn(__fmul_rn(h.one_minus_b2, gk), gk));
      const float mhat = __fdiv_rn(mf[k], b1c);
      const float vhat = __fdiv_rn(vf[k], b2c);
      float step = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
      if (h.decay) step = __fadd_rn(step, __fmul_rn(h.weight_decay, pf[k]));
      pf[k] = __fsub_rn(pf[k], __fmul_rn(lr, step));
    }
    store8(p_out, vec, i, n, pf);
    store8(m_out, vec, i, n, mf);
    store8(v_out, vec, i, n, vf);
  }
}

template <typename P>
cudaError_t launch_update(const P* p, const void* g, int g_dtype, const float* m, const float* v,
                          P* p_out, float* m_out, float* v_out, const float* coef, int64_t n,
                          Hyper h, int blocks, cudaStream_t s) {
  if (g_dtype == repro::kBFloat16)
    adamw_update_kernel<P, __nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        p, static_cast<const __nv_bfloat16*>(g), m, v, p_out, m_out, v_out, coef, n, h);
  else
    adamw_update_kernel<P, float><<<blocks, THREADS, 0, s>>>(
        p, static_cast<const float*>(g), m, v, p_out, m_out, v_out, coef, n, h);
  return cudaGetLastError();
}

bool known(int dtype) { return dtype == repro::kFloat32 || dtype == repro::kBFloat16; }

}  // namespace

// The partial sums of squares of one leaf g (n elements, bf16 or fp32; with
// round_bf16 each rounded to bf16 first) into partials[0 .. slots): one block
// a slot.
extern "C" int adamw_sumsq(const void* g, int g_dtype, int64_t n, int round_bf16, void* partials,
                           int slots, void* stream) {
  if (!known(g_dtype) || n < 0 || slots < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(partials);
  if (g_dtype == repro::kBFloat16)
    adamw_sumsq_kernel<<<slots, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(g), n,
                                                 round_bf16 != 0, out);
  else
    adamw_sumsq_kernel<<<slots, THREADS, 0, s>>>(static_cast<const float*>(g), n,
                                                 round_bf16 != 0, out);
  return (int)cudaGetLastError();
}

// One leaf's sum of squares from its `slots` partials, as the finalize sums
// each leaf's: one fp32 value.
extern "C" int adamw_leaf_total(const void* partials, int slots, void* out, void* stream) {
  if (slots < 1) return (int)cudaErrorInvalidValue;
  adamw_leaf_total_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), slots, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// gnorm (fp32), coef (fp32 [4]) and count_out (int32) from n_leaves × slots
// partials, the int32 step count and, when lr_scale is not null, the fp32
// schedule factor (coef[3] = lr_scale · lr_mul; else lr_mul).
extern "C" int adamw_finalize(const void* partials, int n_leaves, int slots, const void* count,
                              const void* lr_scale, float lr_mul, float b1, float b2,
                              float clip_norm, void* gnorm, void* coef, void* count_out,
                              void* stream) {
  if (n_leaves < 0 || n_leaves > MAX_LEAVES || slots < 1) return (int)cudaErrorInvalidValue;
  adamw_finalize_kernel<<<1, THREADS, n_leaves * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), n_leaves, slots, static_cast<const int*>(count),
      static_cast<const float*>(lr_scale), Finalize{lr_mul, b1, b2, clip_norm},
      static_cast<float*>(gnorm), static_cast<float*>(coef), static_cast<int*>(count_out));
  return (int)cudaGetLastError();
}

// New p (p's type), mu and nu (fp32) of one leaf of n elements from p, g
// (bf16 or fp32), mu, nu and coef (adamw_finalize's); decay on or off.
extern "C" int adamw_update(const void* p, int p_dtype, const void* g, int g_dtype, const void* m,
                            const void* v, void* p_out, void* m_out, void* v_out,
                            const void* coef, int64_t n, int round_bf16, int decay, float b1,
                            float one_minus_b1, float b2, float one_minus_b2, float eps,
                            float weight_decay, void* stream) {
  if (!known(p_dtype) || !known(g_dtype) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t want = ((n + 7) / 8 + THREADS - 1) / THREADS;
  const int blocks = (int)(want < UPDATE_BLOCKS ? want : UPDATE_BLOCKS);
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, round_bf16 != 0,
                decay != 0};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* mf = static_cast<const float*>(m);
  const auto* vf = static_cast<const float*>(v);
  auto* mo = static_cast<float*>(m_out);
  auto* vo = static_cast<float*>(v_out);
  const auto* c = static_cast<const float*>(coef);
  if (p_dtype == repro::kBFloat16)
    return (int)launch_update(static_cast<const __nv_bfloat16*>(p), g, g_dtype, mf, vf,
                              static_cast<__nv_bfloat16*>(p_out), mo, vo, c, n, h, blocks, s);
  return (int)launch_update(static_cast<const float*>(p), g, g_dtype, mf, vf,
                            static_cast<float*>(p_out), mo, vo, c, n, h, blocks, s);
}
