// Flash attention backward for Hopper (sm_90a) on the tensor cores at fp32
// accuracy (3xTF32): the gradients dq, dk, dv of
// o = softmax(q·kᵀ·hd^-½ + mask)·v for the forward's shapes and masks:
// q, o, dO (B,Sq,H,hd), k/v (B,Skv,K,hd), query head h reading kv head
// h / (H/K), causal (col <= row) and sliding window (col > row - window), a
// ragged Skv masked by column and a ragged Sq by row; fp32 arithmetic,
// outputs in the inputs' type. Sq != Skv (cross-attention) comes without a
// mask, as in the forward. The wrapper sends here f32 at every head dim (16,
// 32, 64, 128, 192) and bf16 at hd 16 and 32; bf16 at hd 64, 128 and 192
// runs on wgmma (flash_attention_bwd_wgmma.cu).
//
// Replaces no TPU kernel: the JAX package has no Pallas backward, and its
// training step differentiates the plain attention (models/layers.py,
// sdpa) through XLA. This computes the same gradient.
//
// Algorithm (FlashAttention-2's backward, the row log-sum-exp lse saved by
// the forward). With s = q·kᵀ·scale, p = exp(s - lse), D_i = Σ_d dO_id·O_id:
//   dv = pᵀ·dO,  dp = dO·vᵀ,  ds = p ⊙ (dp - D),  dq = ds·k·scale,
//   dk = dsᵀ·q·scale.
//
// What bounds it on the H100: per visible (query, key) pair and query head
// the backward needs the recomputed q·kᵀ and four gradient products,
// 10·hd FLOPs, against a few bytes per element of q, k, v, o, dO, dq, dk,
// dv: far above the card's ridge, so the bound is the rate of the products.
// In f32 that is 3xTF32, a third of the 495 TFLOP/s TF32 rate (165; fp32
// FMAs on the CUDA cores would cap it at 67). Every product here runs as
// three TF32 mma.sync products with fp32 sums (flash_tf32.cuh). Without
// atomics the two passes recompute q·kᵀ and dO·vᵀ once each: 14·hd FLOPs a
// pair are executed for the 10·hd the bound counts.
//
// Two kernels, one stream, no atomics, so the result is deterministic:
//   1. flash_bwd_delta_kernel: D of every row, a warp a row.
//   2. flash_bwd_kernel: one launch of two kinds of block, the dk/dv blocks
//      first (early kv tiles first: under the causal mask they see the
//      most rows), then the dq blocks (late q tiles first), so that the dq
//      blocks fill the SMs that the dk/dv blocks' uneven causal work
//      leaves idle. Each block has 8 warps, in pairs that own 16 rows
//      of the block's tile, the two warps of a pair computing one of the two
//      score-shaped products each and trading them through shared memory
//      (one barrier), so that both do the same work and a block's
//      registers hold one accumulator per warp:
//      - a dq block, per (64-row q tile, b·h): one pass over the kv tiles
//        (32 keys, double-buffered by cp.async): warp 0 of a pair takes
//        p = exp(q·kᵀ·scale - lse), warp 1 dp = dO·vᵀ; after the exchange
//        both form ds = p ⊙ (dp - D) in registers and each accumulates half
//        of dq's columns, ds·k, feeding ds from its C fragments into the
//        product as flash_attention.cu feeds p;
//      - a dk/dv block, per (32-key tile, b·kv head): keeps its K and V
//        tile in shared memory and walks the G = H/K query heads of its
//        group and their q tiles (64 rows at hd <= 64, else 32; Q, dO, lse
//        and D double-buffered by cp.async), so the sum over the group's
//        heads happens in the block. Warp (key half, role, q half): role 0
//        takes pᵀ = exp(k·qᵀ·scale - lse) and accumulates dv += pᵀ·dO,
//        role 1 takes dpᵀ = v·dOᵀ, reads pᵀ from its partner and
//        accumulates dk += (pᵀ ⊙ (dpᵀ - D))·q, each over its 16 keys and
//        half of the q tile's rows; at the end the two q halves are added
//        in a fixed order. 32-key tiles give 128 dk/dv blocks at
//        nemotron-4-340b's S = 512 (8 kv heads).
// Tiles a pair cannot see are skipped, as in the forward. Shared memory per
// block, the larger of the two kinds (f32; bf16 halves the tiles): hd 16:
// 36.0 KB; hd 32: 54.0 KB; hd 64: 94.0 KB; hd 128: 148.0 KB; hd 192: 212.0
// KB: two blocks (16 warps) share an SM up to hd 64, one (8 warps) above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "flash_tf32.cuh"

namespace {

using repro::all_masked;
using repro::all_visible;
using repro::cp4;
using repro::cp_commit;
using repro::cp_wait;
using repro::load_tile;
using repro::mma_abt;
using repro::mma_pv;
using repro::store2;
using repro::stride;
using repro::to_f32;
using repro::visible;

constexpr int THREADS = 256;  // 8 warps
constexpr int BQ = 64;        // dq blocks: query rows per block (4 pairs of 16)
constexpr int BK = 32;        // dq blocks: keys per kv tile
constexpr int BKV = 32;       // dk/dv blocks: keys per block (2 halves of 16)
constexpr int FRAG = 4 * 32;  // floats of one warp's 16 x 8 C fragment, lane-major
constexpr float kLog2e = 1.4426950408889634f;

// dk/dv blocks: query rows per step (2 halves); 32 above hd 64 (registers
// and shared memory), 64 up to it (half the steps, and barriers, per row)
template <int HD>
__host__ __device__ constexpr int bqs() { return HD <= 64 ? 64 : 32; }

// dq block: Q, dO tiles, two buffers of [K | V], the p and dp exchange
template <typename T, int HD>
constexpr int dq_smem_bytes() {
  return (2 * BQ + 4 * BK) * stride<T, HD>() * (int)sizeof(T) + 2 * 4 * (BK / 8) * FRAG * 4;
}

// dk/dv block: K, V tiles, two buffers of [Q | dO], the pᵀ exchange, two
// buffers of [lse | D]
template <typename T, int HD>
constexpr int dkdv_smem_bytes() {
  return (2 * BKV + 4 * bqs<HD>()) * stride<T, HD>() * (int)sizeof(T) +
         (4 * (bqs<HD>() / 16) * FRAG + 4 * bqs<HD>()) * 4;
}

template <typename T, int HD>
constexpr int smem_bytes() {
  return dq_smem_bytes<T, HD>() > dkdv_smem_bytes<T, HD>() ? dq_smem_bytes<T, HD>()
                                                            : dkdv_smem_bytes<T, HD>();
}

// D_i = Σ_d dO_id·O_id of every row (b, s, h), a warp a row, into (B, H, Sq).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H) {
  const int r = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* a = o + (size_t)r * HD;
  const T* b = dout + (size_t)r * HD;
  float d = 0.f;
#pragma unroll
  for (int i = lane; i < HD; i += 32) d = fmaf(to_f32(b[i]), to_f32(a[i]), d);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (lane == 0) {
    const int h = r % H, s = (r / H) % Sq, bb = r / H / Sq;
    delta[((size_t)bb * H + h) * Sq + s] = d;
  }
}

// dq of q tile qt of (b, h) = bh.
template <typename T, int HD>
__device__ __forceinline__ void dq_block(unsigned char* smem_raw, int qt, int bh,
                                         const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         const float* __restrict__ lse_in,
                                         const float* __restrict__ delta_in, T* __restrict__ dq,
                                         int Sq, int Skv, int H, int K, int causal, int window,
                                         float sm_scale) {
  constexpr int ST = stride<T, HD>();
  constexpr int NT = BK / 8;   // 8-key steps of a kv tile
  constexpr int NH = HD / 16;  // 8-column tiles of dq per warp (half of hd)
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BQ * ST;
  T* KV = dOs + BQ * ST;  // buffer i: K at KV + 2·i·BK·ST, V after it
  float* X = reinterpret_cast<float*>(KV + 4 * BK * ST);  // [role][pair][NT] fragments

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int pr = w & 3, role = w >> 2;
  const int q0 = qt * BQ;
  const int b = bh / H;
  const int h = bh % H;
  const int kh = h / (H / K);
  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)K * HD;
  const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * HD;
  const size_t kv_off = (size_t)b * Skv * kv_row + (size_t)kh * HD;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  load_tile<HD, THREADS>(Qs, ST, q + q_off + q0 * q_row, q_row, BQ, Sq - q0);
  load_tile<HD, THREADS>(dOs, ST, dout + q_off + q0 * q_row, q_row, BQ, Sq - q0);
  load_tile<HD, THREADS>(KV, ST, kb + kv_begin * kv_row, kv_row, BK, Skv - kv_begin);
  load_tile<HD, THREADS>(KV + BK * ST, ST, vb + kv_begin * kv_row, kv_row, BK, Skv - kv_begin);
  cp_commit();

  const int r0 = q0 + 16 * pr;  // the pair's rows: r0 + g (i = 0), r0 + g + 8 (i = 1)
  float delta[2], lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    const size_t at = ((size_t)b * H + h) * Sq + row;
    delta[i] = row < Sq ? delta_in[at] : 0.f;
    lse[i] = row < Sq ? lse_in[at] : 0.f;
  }
  const float scale2 = sm_scale * kLog2e;  // p = 2^(s·scale·log2 e - lse·log2 e)
  lse[0] *= kLog2e;
  lse[1] *= kLog2e;
  const T* A = (role ? dOs : Qs) + 16 * pr * ST;
  float* Xmine = X + (role * 4 + pr) * NT * FRAG + lane;
  const float* Xother = X + ((1 - role) * 4 + pr) * NT * FRAG + lane;
  float acc[NH][4] = {};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_begin + t * BK;
    cp_wait<0>();
    __syncthreads();  // tile t landed; tile t-1's buffer and exchange consumed
    if (t + 1 < n_tiles) {
      T* nb = KV + ((t + 1) & 1) * 2 * BK * ST;
      const int k1 = k0 + BK;
      load_tile<HD, THREADS>(nb, ST, kb + k1 * kv_row, kv_row, BK, Skv - k1);
      load_tile<HD, THREADS>(nb + BK * ST, ST, vb + k1 * kv_row, kv_row, BK, Skv - k1);
    }
    cp_commit();
    const bool skip = all_masked(r0, 16, k0, BK, Sq, Skv, causal, window);
    const T* Ks = KV + (t & 1) * 2 * BK * ST;
    float s[NT][4] = {};
    if (!skip) {  // role 0: p; role 1: dp
      mma_abt<T, HD, NT, true>(s, A, role ? Ks + BK * ST : Ks, g, c);
      if (role == 0) {
        const bool full = all_visible(r0, 16, k0, BK, Sq, Skv, causal, window);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + g + 8 * (e >> 1), col = k0 + 8 * j + 2 * c + (e & 1);
            s[j][e] = full || visible(row, col, Sq, Skv, causal, window)
                          ? exp2f(s[j][e] * scale2 - lse[e >> 1]) : 0.f;
          }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) Xmine[(4 * j + e) * 32] = s[j][e];
    }
    __syncthreads();
    if (!skip) {  // ds = p ⊙ (dp - D), the same bits in both warps; dq[:, half] += ds·k
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = Xother[(4 * j + e) * 32];
          const float p = role ? x : s[j][e], dp = role ? s[j][e] : x;
          s[j][e] = p * (dp - delta[e >> 1]);
        }
      mma_pv<T, HD, NT, NH>(acc, s, Ks, role * (HD / 2), g, c);
    }
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= Sq) continue;
    T* dst = dqb + row * q_row + role * (HD / 2) + 2 * c;
#pragma unroll
    for (int n = 0; n < NH; ++n)
      store2(dst + 8 * n, acc[n][2 * i] * sm_scale, acc[n][2 * i + 1] * sm_scale);
  }
}

// dk and dv of kv tile kt of (b, kv head) = bk.
template <typename T, int HD>
__device__ __forceinline__ void dkdv_block(unsigned char* smem_raw, int kt, int bk,
                                           const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, const T* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, T* __restrict__ dk,
                                           T* __restrict__ dv, int Sq, int Skv, int H, int K,
                                           int causal, int window, float sm_scale) {
  constexpr int ST = stride<T, HD>();
  constexpr int BQS = bqs<HD>();  // query rows per step
  constexpr int NT = BQS / 16;    // 8-row steps of a warp's half of them
  constexpr int NO = HD / 8;      // 8-column tiles of dk or dv
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BKV * ST;
  T* QD = Vs + BKV * ST;  // buffer i: Q at QD + 2·i·BQS·ST, dO after it
  float* X = reinterpret_cast<float*>(QD + 4 * BQS * ST);  // [q half][key half][NT] fragments
  float* LD = X + 4 * NT * FRAG;  // buffer i: lse at LD + 2·i·BQS, D after it

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int kg = w & 1, role = (w >> 1) & 1, qh = w >> 2;
  const int k0 = kt * BKV;
  const int b = bk / K;
  const int kh = bk % K;
  const int G = H / K;
  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)K * HD;
  const size_t kv_off = (size_t)b * Skv * kv_row + (size_t)kh * HD;

  const int q_begin = causal ? k0 / BQS * BQS : 0;
  const int q_end = window > 0 ? min(Sq, k0 + BKV - 1 + window) : Sq;
  const int nq = (q_end - q_begin + BQS - 1) / BQS;
  const int total = G * nq;  // steps: (head of the group, q tile)

  // Q, dO, lse and D of step t into buffer `buf`
  auto issue = [&](int t, int buf) {
    const int h = kh * G + t / nq, q0 = q_begin + (t % nq) * BQS;
    const size_t q_off = (size_t)b * Sq * q_row + (size_t)h * HD + q0 * q_row;
    T* dst = QD + 2 * buf * BQS * ST;
    load_tile<HD, THREADS>(dst, ST, q + q_off, q_row, BQS, Sq - q0);
    load_tile<HD, THREADS>(dst + BQS * ST, ST, dout + q_off, q_row, BQS, Sq - q0);
    if (tid < BQS) {
      const size_t row = ((size_t)b * H + h) * Sq + q0;
      const bool ok = q0 + tid < Sq;
      cp4(LD + 2 * buf * BQS + tid, lse + row + (ok ? tid : 0), ok);
      cp4(LD + (2 * buf + 1) * BQS + tid, delta + row + (ok ? tid : 0), ok);
    }
  };
  load_tile<HD, THREADS>(Ks, ST, k + kv_off + k0 * kv_row, kv_row, BKV, Skv - k0);
  load_tile<HD, THREADS>(Vs, ST, v + kv_off + k0 * kv_row, kv_row, BKV, Skv - k0);
  issue(0, 0);
  cp_commit();

  const int kr0 = k0 + 16 * kg;  // the warp's keys: kr0 + g (i = 0), kr0 + g + 8 (i = 1)
  const float scale2 = sm_scale * kLog2e;  // p = 2^(s·scale·log2 e - lse·log2 e)
  const T* A = (role ? Vs : Ks) + 16 * kg * ST;
  float* Xg = X + (qh * 2 + kg) * NT * FRAG + lane;
  float acc[NO][4] = {};  // role 0: dv, role 1: dk / scale

  for (int t = 0; t < total; ++t) {
    const int q0 = q_begin + (t % nq) * BQS;
    const int buf = t & 1;
    cp_wait<0>();
    __syncthreads();  // step t landed; step t-1's buffer and exchange consumed
    if (t + 1 < total) issue(t + 1, buf ^ 1);
    cp_commit();
    const int qr0 = q0 + (BQS / 2) * qh;  // the warp's query rows
    const bool skip = all_masked(qr0, BQS / 2, kr0, 16, Sq, Skv, causal, window);
    const T* Qt = QD + 2 * buf * BQS * ST;
    const T* dOt = Qt + BQS * ST;
    const float* Lt = LD + 2 * buf * BQS + (BQS / 2) * qh;
    const float* Dt = Lt + BQS;
    float s[NT][4] = {};  // keys x query rows
    if (!skip) {  // role 0: pᵀ; role 1: dpᵀ
      mma_abt<T, HD, NT, true>(s, A, (role ? dOt : Qt) + (BQS / 2) * qh * ST, g, c);
      if (role == 0) {
        const bool full = all_visible(qr0, BQS / 2, kr0, 16, Sq, Skv, causal, window);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * j + 2 * c + (e & 1);
            s[j][e] = full || visible(qr0 + r, kr0 + g + 8 * (e >> 1), Sq, Skv, causal, window)
                          ? exp2f(s[j][e] * scale2 - Lt[r] * kLog2e) : 0.f;
            Xg[(4 * j + e) * 32] = s[j][e];
          }
      }
    }
    __syncthreads();
    if (!skip) {
      if (role == 1) {  // dsᵀ = pᵀ ⊙ (dpᵀ - D)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = Xg[(4 * j + e) * 32] * (s[j][e] - Dt[8 * j + 2 * c + (e & 1)]);
      }
      // dv += pᵀ·dO (role 0), dk += dsᵀ·q (role 1), over the warp's query rows
      mma_pv<T, HD, NT, NO>(acc, s, (role ? Qt : dOt) + (BQS / 2) * qh * ST, 0, g, c);
    }
  }

  // the two query halves, added in a fixed order: half 1 hands its sums to half 0
  __syncthreads();
  float* R = reinterpret_cast<float*>(QD) + (kg * 2 + role) * NO * FRAG + lane;
  if (qh == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) R[(4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (qh == 1) return;
  const float scale = role ? sm_scale : 1.f;
  T* out = (role ? dk : dv) + kv_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + g + 8 * i;
    if (key >= Skv) continue;
    T* dst = out + key * kv_row + 2 * c;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(dst + 8 * n, (acc[n][2 * i] + R[(4 * n + 2 * i) * 32]) * scale,
             (acc[n][2 * i + 1] + R[(4 * n + 2 * i + 1) * 32]) * scale);
  }
}

// The first kv_blocks blocks are dk/dv blocks, kv tile outermost (early,
// heavy tiles first); the rest dq blocks, late q tiles first. Up to hd 64
// two blocks share an SM (registers held to 128 a thread): one block's
// warps waiting at a barrier leave the SM to the other's (on the H100 the
// whisper encoder's backward, B=4 S=1500 hd 64, took 5.07 ms at one block
// an SM, 3.91 at two).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, T* __restrict__ dk,
                 T* __restrict__ dv, int B, int Sq, int Skv, int H, int K, int causal,
                 int window, float sm_scale, int kv_blocks, int q_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int blk = blockIdx.x;
  if (blk < kv_blocks) {
    dkdv_block<T, HD>(smem_raw, blk / (B * K), blk % (B * K), q, k, v, dout, lse, delta, dk, dv,
                      Sq, Skv, H, K, causal, window, sm_scale);
  } else {
    const int i = blk - kv_blocks;
    dq_block<T, HD>(smem_raw, q_tiles - 1 - i / (B * H), i % (B * H), q, k, v, dout, lse, delta,
                    dq, Sq, Skv, H, K, causal, window, sm_scale);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* delta, int B, int Sq, int Skv, int H, int K, int causal,
                   int window, float sm_scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T, HD><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                                  stream>>>(static_cast<const T*>(o),
                                            static_cast<const T*>(dout), delta, rows, Sq, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kv_blocks = (Skv + BKV - 1) / BKV * B * K;
  const int q_tiles = (Sq + BQ - 1) / BQ;
  flash_bwd_kernel<T, HD><<<kv_blocks + q_tiles * B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), B, Sq, Skv, H, K, causal, window, sm_scale, kv_blocks, q_tiles);
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

// Dynamic shared memory of the backward's main kernel (flash_bwd_kernel) for
// dtype (0 f32, 1 bf16) at head dim hd, or 0 for a case it does not take;
// for the build record.
extern "C" int flash_attention_bwd_smem_bytes(int dtype, int hd) {
  if (dtype == repro::kBFloat16) {
    if (hd == 16) return smem_bytes<__nv_bfloat16, 16>();
    if (hd == 32) return smem_bytes<__nv_bfloat16, 32>();
    return 0;
  }
  switch (hd) {
    case 16: return smem_bytes<float, 16>();
    case 32: return smem_bytes<float, 32>();
    case 64: return smem_bytes<float, 64>();
    case 128: return smem_bytes<float, 128>();
    case 192: return smem_bytes<float, 192>();
  }
  return 0;
}
