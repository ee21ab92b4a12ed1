// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a preallocated KV cache, per-sequence valid length, grouped-query
// heads, fp32 or bf16 inputs, fp32 softmax and accumulator.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention (body _decode_kernel). It computes, for q
// (B,H,hd) and caches (B,S,K,hd), softmax(q·kᵀ·hd^-½ masked to
// col < kv_len[b])·v, the G = H/K query heads of kv head kh being heads
// kh·G .. kh·G+G-1. kv_len is clamped to S; the tail past it is masked
// here, so S need not be a multiple of the tile (the TPU kernel asserts
// S % block_k == 0).
//
// What bounds it on the H100: every valid cache byte is read once per
// step and used for only 2·G FLOPs per element pair, so the bound is
// Σ_b kv_len[b]·K·hd·2 (k and v) elements at 3.35 TB/s. What the design
// does: one block per (b, kv head) loads the G query rows once and
// streams K and V in 64-key tiles through shared memory up to kv_len[b],
// so each cache byte is read once for the whole group (the GQA point of
// the TPU kernel) and no tile past kv_len is touched; each thread issues
// all its 16-byte loads of a tile before it uses any (load_rows), so the
// tile's bytes are in flight together. With B·K blocks it
// fills few of the 132 SMs at small batch; splitting the kv axis across
// blocks with a combine pass is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::kNegInf;
using repro::load_rows;
using repro::to_f32;

constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int MAX_G = 16;     // query heads per kv head

template <int HD>
constexpr int smem_floats() {
  return MAX_G * HD        // Qs
         + BK * (HD + 1)   // Ks, padded against bank conflicts
         + BK * HD         // Vs
         + MAX_G * BK      // Ps
         + 3 * MAX_G;      // running max, running sum, rescale factor
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ kv_len,
              T* __restrict__ o, int S, int K, int G, float sm_scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + MAX_G * HD;
  float* Vs = Ks + BK * (HD + 1);
  float* Ps = Vs + BK * HD;
  float* Ms = Ps + MAX_G * BK;
  float* Ls = Ms + MAX_G;
  float* As = Ls + MAX_G;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int H = K * G;
  const size_t kv_row = (size_t)K * HD;
  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * HD;
  const T* kb = kc + (size_t)b * S * kv_row + (size_t)kh * HD;
  const T* vb = vc + (size_t)b * S * kv_row + (size_t)kh * HD;
  T* ob = o + ((size_t)b * H + (size_t)kh * G) * HD;
  const int n = min(kv_len[b], S);

  for (int idx = tid; idx < G * HD; idx += THREADS) Qs[idx] = to_f32(qb[idx]);
  if (tid < G) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  // accumulator: element e = tid + THREADS*i of the (G, HD) output tile
  constexpr int ACC = (MAX_G * HD + THREADS - 1) / THREADS;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs, Ms, Ls written)
    load_rows<T, HD, BK, THREADS>(Ks, HD + 1, kb, kv_row, k0, n);
    load_rows<T, HD, BK, THREADS>(Vs, HD, vb, kv_row, k0, n);  // zeros past n: p·v stays finite
    __syncthreads();

    // scores: thread -> key c, query heads g = tid/BK, tid/BK + 2, ...
    {
      const int c = tid % BK;
      for (int g = tid / BK; g < G; g += THREADS / BK) {
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) s = fmaf(Qs[g * HD + d], Ks[c * (HD + 1) + d], s);
        Ps[g * BK + c] = k0 + c < n ? s * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head row, two keys per lane
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = Ps[g * BK + lane], s1 = Ps[g * BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = k0 + lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = k0 + lane + 32 < n ? expf(s1 - m_new) : 0.f;
      Ps[g * BK + lane] = p0;
      Ps[g * BK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + THREADS * i;
      if (e < G * HD) {
        const int g = e / HD, d = e % HD;
        float a = acc[i] * As[g];
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) a = fmaf(Ps[g * BK + kk], Vs[kk * HD + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // Ls final (also when n <= 0 and no tile ran)

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + THREADS * i;
    if (e < G * HD) ob[e] = from_f32<T>(acc[i] / fmaxf(Ls[e / HD], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* kv_len, void* o, int B, int S, int K, int G,
                   float sm_scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, HD><<<B * K, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), kv_len, static_cast<T*>(o), S, K, G, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* kc, const void* vc,
                        const int* kv_len, void* o, int B, int S, int K, int G,
                        int hd, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kc, vc, kv_len, o, B, S, K, G, sm_scale, stream);
    case 32: return launch<T, 32>(q, kc, vc, kv_len, o, B, S, K, G, sm_scale, stream);
    case 64: return launch<T, 64>(q, kc, vc, kv_len, o, B, S, K, G, sm_scale, stream);
    case 128: return launch<T, 128>(q, kc, vc, kv_len, o, B, S, K, G, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,hd), caches (B,S,K,hd), kv_len (B,) int32, o (B,H,hd), all
// contiguous; q, caches and o of one dtype. Returns cudaGetLastError().
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const void* kv_len,
                                    void* o, int dtype, int B, int S, int H,
                                    int K, int hd, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || H / K > MAX_G)
    return cudaErrorInvalidValue;
  const int G = H / K;
  const int* len = static_cast<const int*>(kv_len);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_hd<float>(q, k_cache, v_cache, len, o, B, S, K, G, hd, sm_scale, st);
  if (dtype == repro::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(q, k_cache, v_cache, len, o, B, S, K, G, hd, sm_scale, st);
  return cudaErrorInvalidValue;
}
