// Flash attention forward for Hopper (sm_90a): causal / sliding-window,
// grouped-query heads, fp32 or bf16 inputs, fp32 softmax and accumulator.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function flash_attention (body _flash_kernel). It computes
// softmax(q·kᵀ·hd^-½ + mask)·v for q (B,S,H,hd), k/v (B,S,K,hd), where
// query head h reads kv head h / (H/K); masks col <= row (causal) and
// col > row - window (window), and, unlike the TPU kernel, col < S: a
// ragged S needs no padding. Masked logits are -1e30, the denominator is
// clamped at 1e-30, the output has q's type.
//
// What bounds it on the H100: at long S the work is q·kᵀ and p·v,
// 4·S²·hd FLOPs per head (halved by the causal mask) against
// 2·S·hd·(H+2K) input bytes, far above the card's 295 FLOP/byte ridge in
// bf16, so the bound is the bf16 tensor-core rate (989 TFLOP/s; fp32:
// 67 TFLOP/s). This first kernel does not reach it: it runs both products
// as fp32 FMAs on the CUDA cores. What the design does: one block per
// (64-row q tile, b·h) keeps its q tile, one 64-row K and V tile, and
// the 64×64 probabilities in shared memory; each of 128 threads owns a
// 4-row × 8-column score tile and the same 4 rows of the fp32
// accumulator, so the running max and sum of a row live in the
// registers of the 8 lanes that share it (warp shuffles, no shared
// memory round trip); kv tiles past the causal diagonal or before the
// window are never loaded; tiles arrive by 16-byte loads that each thread
// issues all at once (load_rows). wgmma, TMA and a warp-specialised pipeline
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::kNegInf;
using repro::load_rows;
using repro::to_f32;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int TR = 4;         // rows per thread
constexpr int TC = BK / 8;    // score columns per thread (stride 8)

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1)      // Qs, padded against bank conflicts
         + BK * (HD + 1)    // Ks
         + BK * HD          // Vs
         + BQ * (BK + 1);   // Ps
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int K, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (HD + 1);
  float* Vs = Ks + BK * (HD + 1);
  float* Ps = Vs + BK * HD;

  const int tid = threadIdx.x;
  const int rg = tid / 8;  // row group: rows rg*TR .. rg*TR+TR-1
  const int cg = tid % 8;  // column group: columns cg + 8*j
  // heavy (late) q tiles first: under the causal mask they have the most kv tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / K);
  const size_t q_row = (size_t)H * HD;   // stride between sequence positions
  const size_t kv_row = (size_t)K * HD;
  const T* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)kh * HD;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)kh * HD;
  T* ob = o + (size_t)b * S * q_row + (size_t)h * HD;

  load_rows<T, HD, BQ, THREADS>(Qs, HD + 1, qb, q_row, q0, S);

  float m[TR], l[TR], acc[TR][HD / 8];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    load_rows<T, HD, BK, THREADS>(Ks, HD + 1, kb, kv_row, k0, S);
    load_rows<T, HD, BK, THREADS>(Vs, HD, vb, kv_row, k0, S);  // zeros past S: p·v stays finite
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[TR], bk[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = Qs[(rg * TR + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) bk[j] = Ks[(cg + 8 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + rg * TR + i;
      bool valid[TC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = k0 + cg + 8 * j;
        valid[j] = col < S && (!causal || col <= row) &&
                   (window <= 0 || col > row - window);
        s[i][j] = valid[j] ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes of a row group are adjacent: reduce across them
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(rg * TR + i) * (BK + 1) + cg + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[TR], vv[HD / 8];
#pragma unroll
      for (int i = 0; i < TR; ++i) p[i] = Ps[(rg * TR + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) vv[j] = Vs[kk * HD + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + rg * TR + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      ob[row * q_row + cg + 8 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int K, int causal, int window, float sm_scale,
                   cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, K, causal, window,
      sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int K, int hd, int causal,
                        int window, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, K, causal, window, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, K, causal, window, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, K, causal, window, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, K, causal, window, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,hd), k/v (B,S,K,hd), o (B,S,H,hd), all contiguous, one dtype.
// window <= 0 means no window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int S, int H,
                                   int K, int hd, int causal, int window,
                                   float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_hd<float>(q, k, v, o, B, S, H, K, hd, causal, window, sm_scale, st);
  if (dtype == repro::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, K, hd, causal, window, sm_scale, st);
  return cudaErrorInvalidValue;
}
