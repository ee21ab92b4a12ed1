// Flash attention backward for Hopper (sm_90a) on fp32 FMAs: the gradients
// dq, dk, dv of o = softmax(q·kᵀ·hd^-½ + mask)·v for the forward's shapes
// and masks: q, o, dO (B,Sq,H,hd), k/v (B,Skv,K,hd), query head h reading
// kv head h / (H/K), causal (col <= row) and sliding window
// (col > row - window), a ragged Skv masked by column and a ragged Sq by
// row; fp32 arithmetic, outputs in the inputs' type. Sq != Skv
// (cross-attention) comes without a mask, as in the forward. The wrapper
// sends here f32 at every head dim (16, 32, 64, 128, 192) and bf16 at hd 16
// and 32; bf16 at hd 64, 128 and 192 runs on the tensor cores
// (flash_attention_bwd_wgmma.cu).
//
// Replaces no TPU kernel: the JAX package has no Pallas backward, and its
// training step differentiates the plain attention (models/layers.py,
// sdpa) through XLA. This computes the same gradient.
//
// Algorithm (FlashAttention-2's backward, the row log-sum-exp lse saved by
// the forward). With s = q·kᵀ·scale, p = exp(s - lse), D_i = Σ_d dO_id·O_id:
//   dv = pᵀ·dO,  dp = dO·vᵀ,  ds = p ⊙ (dp - D),  dq = ds·k·scale,
//   dk = dsᵀ·q·scale.
// Two kernels, one stream, no atomics, so the result is deterministic:
//   1. flash_bwd_dq_kernel, one block per (64-row q tile, b·h): D of its
//      rows from dO and O, then one pass over the kv tiles that recomputes
//      p from lse, forms ds and accumulates dq in registers. It writes D for
//      kernel 2.
//   2. flash_bwd_dkdv_kernel, one block per (kv tile, b·kv head): keeps its
//      K and V tile in shared memory and dk, dv in registers, and loops over
//      the G = H/K query heads of its group and their q tiles, so the sum
//      over the group's heads happens in the block. Its tile is 64 keys, or
//      32 at hd 192, where 64 would need 231 KB of shared memory.
// q tiles wholly above the diagonal or outside the window are skipped in
// both, as in the forward.
//
// What bounds it on the H100: per valid (query, key) pair and query head
// the backward needs the recomputed q·kᵀ and four gradient products,
// 10·hd FLOPs, against a few bytes per element of q, k, v, o, dO, dq, dk,
// dv: far above the card's ridge, so the bound is the tensor-core rate
// (989 TFLOP/s bf16; 67 TFLOP/s for fp32 FMAs). This kernel does not
// approach it: every product runs as fp32 FMAs on the CUDA cores, 128
// threads each owning a 4 × 8 tile of the 64 × 64 scores (as in
// flash_attention.cu), and q·kᵀ and dO·vᵀ are computed once in each
// kernel. bf16 at hd 64 and up takes the wgmma kernels instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::load_rows;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile of the dq kernel
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int TR = 4;         // tile rows per thread
constexpr int TC = 8;         // tile columns per thread (stride 8)

// keys per tile of the dk/dv kernel: 64, or 32 at hd 192 (shared memory)
template <int HD>
__host__ __device__ constexpr int bkv() { return HD > 128 ? 32 : 64; }

template <int HD>
constexpr int dq_smem_floats() {
  return 2 * BQ * (HD + 1)    // Qs, dOs (O first, for D)
         + 2 * BK * (HD + 1)  // Ks, Vs
         + BQ * (BK + 1);     // DS
}

template <int HD>
constexpr int dkdv_smem_floats() {
  return 2 * bkv<HD>() * (HD + 1)    // Ks, Vs
         + 2 * BQ * (HD + 1)         // Qs, dOs
         + 2 * bkv<HD>() * (BQ + 1)  // PT, DST
         + 2 * BQ;                   // Ls, Ds
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Skv, int causal,
                                        int window) {
  return row < Sq && col < Skv && (!causal || col <= row) && (window <= 0 || col > row - window);
}

__device__ __forceinline__ float sum8(float x) {  // over the 8 lanes of a row group
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[i][j] = Σ_d A[(r_i)·(HD+1) + d] · B[(c_j)·(HD+1) + d] for the thread's
// rows r_i = rg·NR + i and columns c_j = cg + 8j.
template <int HD, int NR>
__device__ __forceinline__ void tile_dot(float (&acc)[NR][TC], const float* A, const float* B,
                                         int rg, int cg) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[NR], bb[TC];
#pragma unroll
    for (int i = 0; i < NR; ++i) a[i] = A[(rg * NR + i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < TC; ++j) bb[j] = B[(cg + 8 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse_in,
                    T* __restrict__ dq, float* __restrict__ delta_out,
                    int Sq, int Skv, int H, int K, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (HD + 1);
  float* Ks = dOs + BQ * (HD + 1);
  float* Vs = Ks + BK * (HD + 1);
  float* DS = Vs + BK * (HD + 1);

  const int tid = threadIdx.x;
  const int rg = tid / 8;
  const int cg = tid % 8;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy (late) tiles first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / K);
  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)K * HD;
  const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * HD;
  const size_t kv_off = (size_t)b * Skv * kv_row + (size_t)kh * HD;

  load_rows<T, HD, BQ, THREADS>(Qs, HD + 1, q + q_off, q_row, q0, Sq);
  load_rows<T, HD, BQ, THREADS>(dOs, HD + 1, dout + q_off, q_row, q0, Sq);
  load_rows<T, HD, BQ, THREADS>(Vs, HD + 1, o + q_off, q_row, q0, Sq);  // O, for D
  __syncthreads();

  // D of each row, and its lse from the forward
  float delta[TR], lse[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rg * TR + i;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      part = fmaf(dOs[r * (HD + 1) + cg + 8 * j], Vs[r * (HD + 1) + cg + 8 * j], part);
    delta[i] = sum8(part);
    const int row = q0 + r;
    lse[i] = row < Sq ? lse_in[((size_t)b * H + h) * Sq + row] : 0.f;
    if (cg == 0 && row < Sq) delta_out[((size_t)b * H + h) * Sq + row] = delta[i];
  }

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  // one pass: ds = p ⊙ (dO·vᵀ - D), dq += ds·k
  float acc[TR][HD / 8];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // Ks, Vs (the first time holding O) and DS consumed
    load_rows<T, HD, BK, THREADS>(Ks, HD + 1, k + kv_off, kv_row, k0, Skv);
    load_rows<T, HD, BK, THREADS>(Vs, HD + 1, v + kv_off, kv_row, k0, Skv);
    __syncthreads();
    float s[TR][TC], dp[TR][TC];
    tile_dot<HD, TR>(s, Qs, Ks, rg, cg);
    tile_dot<HD, TR>(dp, dOs, Vs, rg, cg);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + rg * TR + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = k0 + cg + 8 * j;
        const float p =
            visible(row, col, Sq, Skv, causal, window) ? expf(s[i][j] * sm_scale - lse[i]) : 0.f;
        DS[(rg * TR + i) * (BK + 1) + cg + 8 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[TR], kv[HD / 8];
#pragma unroll
      for (int i = 0; i < TR; ++i) ds[i] = DS[(rg * TR + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) kv[j] = Ks[kk * (HD + 1) + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + rg * TR + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      dqb[row * q_row + cg + 8 * j] = from_f32<T>(acc[i][j] * sm_scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv,
                      int Sq, int Skv, int H, int K, int causal, int window, float sm_scale) {
  constexpr int BKV = bkv<HD>();  // keys of the block's tile
  constexpr int TRK = BKV / 16;   // of them per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * (HD + 1);
  float* Qs = Vs + BKV * (HD + 1);
  float* dOs = Qs + BQ * (HD + 1);
  float* PT = dOs + BQ * (HD + 1);
  float* DST = PT + BKV * (BQ + 1);
  float* Ls = DST + BKV * (BQ + 1);
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x;
  const int rg = tid / 8;  // keys rg*TRK .. rg*TRK+TRK-1
  const int cg = tid % 8;  // query rows cg + 8*j (scores), dims cg + 8*j (dk, dv)
  const int k0 = blockIdx.x * BKV;  // under the causal mask early tiles have the most rows
  const int b = blockIdx.y / K;
  const int kh = blockIdx.y % K;
  const int G = H / K;
  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)K * HD;
  const size_t kv_off = (size_t)b * Skv * kv_row + (size_t)kh * HD;

  load_rows<T, HD, BKV, THREADS>(Ks, HD + 1, k + kv_off, kv_row, k0, Skv);
  load_rows<T, HD, BKV, THREADS>(Vs, HD + 1, v + kv_off, kv_row, k0, Skv);

  float adk[TRK][HD / 8], adv[TRK][HD / 8];
#pragma unroll
  for (int i = 0; i < TRK; ++i)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int q_begin = causal ? k0 / BQ * BQ : 0;
  const int q_end = window > 0 ? min(Sq, k0 + BKV - 1 + window) : Sq;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * HD;
    const float* lse_h = lse + ((size_t)b * H + h) * Sq;
    const float* delta_h = delta + ((size_t)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // Qs, dOs, PT, DST, Ls, Ds of the previous tile consumed
      load_rows<T, HD, BQ, THREADS>(Qs, HD + 1, q + q_off, q_row, q0, Sq);
      load_rows<T, HD, BQ, THREADS>(dOs, HD + 1, dout + q_off, q_row, q0, Sq);
      if (tid < BQ) {
        const int row = q0 + tid;
        Ls[tid] = row < Sq ? lse_h[row] : 0.f;
        Ds[tid] = row < Sq ? delta_h[row] : 0.f;
      }
      __syncthreads();
      float s[TRK][TC], dp[TRK][TC];
      tile_dot<HD, TRK>(s, Ks, Qs, rg, cg);   // sᵀ: keys x query rows
      tile_dot<HD, TRK>(dp, Vs, dOs, rg, cg);  // dpᵀ
#pragma unroll
      for (int i = 0; i < TRK; ++i) {
        const int col = k0 + rg * TRK + i;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int r = cg + 8 * j;
          const float p = visible(q0 + r, col, Sq, Skv, causal, window)
                              ? expf(s[i][j] * sm_scale - Ls[r]) : 0.f;
          PT[(rg * TRK + i) * (BQ + 1) + r] = p;
          DST[(rg * TRK + i) * (BQ + 1) + r] = p * (dp[i][j] - Ds[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float p[TRK], ds[TRK], dov[HD / 8], qv[HD / 8];
#pragma unroll
        for (int i = 0; i < TRK; ++i) {
          p[i] = PT[(rg * TRK + i) * (BQ + 1) + qq];
          ds[i] = DST[(rg * TRK + i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          dov[j] = dOs[qq * (HD + 1) + cg + 8 * j];
          qv[j] = Qs[qq * (HD + 1) + cg + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < TRK; ++i)
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            adv[i][j] = fmaf(p[i], dov[j], adv[i][j]);
            adk[i][j] = fmaf(ds[i], qv[j], adk[i][j]);
          }
      }
    }
  }

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < TRK; ++i) {
    const int key = k0 + rg * TRK + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      dkb[key * kv_row + cg + 8 * j] = from_f32<T>(adk[i][j] * sm_scale);
      dvb[key * kv_row + cg + 8 * j] = from_f32<T>(adv[i][j]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* delta, int B, int Sq, int Skv, int H, int K, int causal,
                   int window, float sm_scale, cudaStream_t stream) {
  const int smem_dq = dq_smem_floats<HD>() * (int)sizeof(float);
  const int smem_dkdv = dkdv_smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD><<<dim3((Sq + BQ - 1) / BQ, B * H), THREADS, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta,
      Sq, Skv, H, K, causal, window, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int BKV = bkv<HD>();
  const dim3 grid_kv((Skv + BKV - 1) / BKV, B * K);
  flash_bwd_dkdv_kernel<T, HD><<<grid_kv, THREADS, smem_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, H, K, causal, window, sm_scale);
  return cudaGetLastError();
}

// bf16 at hd 64, 128 and 192 is flash_attention_bwd_wgmma.cu's
template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, void* dq, void* dk, void* dv,
                        float* delta, int B, int Sq, int Skv, int H, int K, int hd,
                        int causal, int window, float sm_scale, cudaStream_t st) {
#define REPRO_LAUNCH(HD) \
  launch<T, HD>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv, H, K, causal, window, \
                sm_scale, st)
  switch (hd) {
    case 16: return REPRO_LAUNCH(16);
    case 32: return REPRO_LAUNCH(32);
  }
  if constexpr (std::is_same_v<T, float>) {
    switch (hd) {
      case 64: return REPRO_LAUNCH(64);
      case 128: return REPRO_LAUNCH(128);
      case 192: return REPRO_LAUNCH(192);
    }
  }
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq (B,Sq,H,hd); k, v, dk, dv (B,Skv,K,hd); all contiguous, one
// dtype. lse: fp32 (B,H,Sq), each row's log-sum-exp from the forward. delta:
// fp32 scratch of B·H·Sq floats (Σ dO·O of each row, written by the first
// kernel, read by the second). window <= 0 means no window; a causal or
// window mask needs Sq == Skv. Returns cudaGetLastError() after the launches.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* delta, int dtype,
                                   int B, int Sq, int Skv, int H, int K, int hd, int causal,
                                   int window, float sm_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || lse == nullptr)
    return cudaErrorInvalidValue;
  if ((causal || window > 0) && Sq != Skv) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == repro::kFloat32)
    return dispatch_hd<float>(q, k, v, o, dout, l, dq, dk, dv, d, B, Sq, Skv, H, K, hd, causal,
                              window, sm_scale, st);
  if (dtype == repro::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, dout, l, dq, dk, dv, d, B, Sq, Skv, H, K, hd,
                                      causal, window, sm_scale, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the dq (kernel 0) or dk/dv (kernel 1) kernel at
// head dim hd, or 0 for a head dim they do not take; for the build record.
extern "C" int flash_attention_bwd_smem_bytes(int hd, int kernel) {
  switch (hd) {
    case 16: return (kernel ? dkdv_smem_floats<16>() : dq_smem_floats<16>()) * 4;
    case 32: return (kernel ? dkdv_smem_floats<32>() : dq_smem_floats<32>()) * 4;
    case 64: return (kernel ? dkdv_smem_floats<64>() : dq_smem_floats<64>()) * 4;
    case 128: return (kernel ? dkdv_smem_floats<128>() : dq_smem_floats<128>()) * 4;
    case 192: return (kernel ? dkdv_smem_floats<192>() : dq_smem_floats<192>()) * 4;
  }
  return 0;
}
