// Flash attention forward for Hopper (sm_90a): causal / sliding-window,
// grouped-query heads, fp32 or bf16 inputs, fp32 softmax and accumulator.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function flash_attention (body _flash_kernel), for the cases the wrapper
// sends here: f32 at every head dim (16, 32, 64, 128, 192) and bf16 at hd 16
// and 32; bf16 at hd 64, 128 and 192 runs on wgmma (flash_attention_wgmma.cu).
// It computes softmax(q·kᵀ·hd^-½ + mask)·v for q (B,Sq,H,hd), k/v
// (B,Skv,K,hd), where query head h reads kv head h / (H/K); masks
// col <= row (causal) and col > row - window (window), and, unlike the TPU
// kernel, col < Skv: a ragged Skv needs no padding, and rows past a ragged
// Sq are neither read nor written. Sq != Skv (cross-attention, which the
// TPU kernel cannot take: it reads its length from q) comes without a
// mask; the wrapper refuses a causal or window mask there. Masked logits
// are -1e30, the denominator is clamped at 1e-30, the output has q's type.
// When the caller passes an lse buffer (training), each row's log-sum-exp
// ln Σ exp(q·k·sm_scale) goes to it in fp32, (B, H, Sq), for the backward.
//
// What bounds it on the H100: at long S the work is q·kᵀ and p·v,
// 4·S²·hd FLOPs per head (halved by the causal mask) against
// 2·S·hd·(H+2K) input bytes, far above the card's ridge, so the bound is
// the rate of the products. In f32 that is 3xTF32 on the tensor cores, a
// third of the 495 TFLOP/s TF32 rate (165; fp32 FMAs on the CUDA cores
// would cap it at 67): each product is split into three TF32 mma.sync
// products with fp32 sums (flash_tf32.cuh), which keeps f32's accuracy.
//
// What the design does (FlashAttention-2's forward): one block per (q tile,
// b·h); each warp owns 16 rows of the q tile. Per kv tile a warp takes
// s = q·kᵀ on the tensor cores into C fragments, masks and exponentiates
// them in registers (a row's running max and sum live in the 4 lanes of its
// quad: two shuffles), rescales its output fragments, and feeds the
// probabilities straight from the C fragments into p·v as the A operand
// (the key order inside each 8-key step is permuted to make the layouts
// agree: no shuffle and no shared-memory round trip). K and V tiles come by
// cp.async into two buffers, the next tile in flight while the current one
// is multiplied; one barrier per tile. A warp skips the kv tiles its rows
// cannot see (above the causal diagonal, before the window); the block
// walks only the kv tiles some row of it sees. Tiles and shared memory per
// block (f32; bf16 halves the bytes):
//   hd 16, 32, 64: 4 warps, q tile 64, kv tile 64   (25.0, 45.0, 85.0 KB)
//   hd 128:        4 warps, q tile 64, kv tile 32   (99.0 KB: 2 blocks/SM)
//   hd 192:        8 warps, q tile 128, kv tile 32  (196.0 KB: 1 block/SM)
// so at every head dim 8 warps or more share an SM.
//
// Short Sq without a mask (whisper's cross-attention from a few decoder
// tokens to its 1500 frames): ⌈Sq/BQ⌉·B·H blocks would leave most SMs idle
// while each walks every key, so the caller may split the kv axis into
// n_split ranges of split_len keys (kernels/flash_attention.py split_plan,
// from the shapes alone). Each range's block writes its rows' normalised
// partial output and log-sum-exp to fp32 scratch, and flash_merge_kernel
// combines the ranges, weighting each by exp(lse_range - lse): the output,
// and the rows' lse, in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "flash_tf32.cuh"

namespace {

using repro::all_masked;
using repro::all_visible;
using repro::cp_commit;
using repro::cp_wait;
using repro::from_f32;
using repro::kNegInf;
using repro::load_tile;
using repro::mma_abt;
using repro::mma_pv;
using repro::store2;
using repro::stride;
using repro::visible;

template <int HD>
struct Tiles {
  static constexpr int WARPS = HD > 128 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;         // query rows per block
  static constexpr int BK = HD >= 128 ? 32 : 64;  // keys per kv tile
};

// Q tile, then two buffers of [K tile | V tile]
template <typename T, int HD>
constexpr int smem_bytes() {
  return (Tiles<HD>::BQ + 4 * Tiles<HD>::BK) * stride<T, HD>() * (int)sizeof(T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Tiles<HD>::THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ part, int split_len, int Sq, int Skv, int H, int K,
                 int causal, int window, float sm_scale) {
  using C = Tiles<HD>;
  constexpr int ST = stride<T, HD>();
  constexpr int NT = C::BK / 8;  // 8-key steps of a kv tile
  constexpr int NO = HD / 8;     // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KV = Qs + C::BQ * ST;  // buffer i: K at KV + 2·i·BK·ST, V right after it

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  // heavy (late) q tiles first: under the causal mask they have the most kv tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / K);
  const size_t q_row = (size_t)H * HD;  // stride between sequence positions
  const size_t kv_row = (size_t)K * HD;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * Skv * kv_row + (size_t)kh * HD;
  const T* vb = v + (size_t)b * Skv * kv_row + (size_t)kh * HD;
  T* ob = o + (size_t)b * Sq * q_row + (size_t)h * HD;

  // the kv range: blockIdx.z's split_len keys when split (no mask), else all it sees
  const int split = gridDim.z > 1;
  const int kv_end = split ? min(Skv, (int)(blockIdx.z + 1) * split_len)
                           : causal ? min(Skv, q0 + C::BQ) : Skv;
  const int kv_begin = split ? blockIdx.z * split_len
                             : window > 0 ? max(0, q0 - window + 1) / C::BK * C::BK : 0;
  const int n_tiles = (kv_end - kv_begin + C::BK - 1) / C::BK;

  load_tile<HD, C::THREADS>(Qs, ST, qb + q0 * q_row, q_row, C::BQ, Sq - q0);
  load_tile<HD, C::THREADS>(KV, ST, kb + kv_begin * kv_row, kv_row, C::BK, Skv - kv_begin);
  load_tile<HD, C::THREADS>(KV + C::BK * ST, ST, vb + kv_begin * kv_row, kv_row, C::BK,
                            Skv - kv_begin);
  cp_commit();

  const int r0 = q0 + 16 * w;  // the warp's rows: r0 + g (i = 0), r0 + g + 8 (i = 1)
  const T* Qw = Qs + 16 * w * ST;
  float acc[NO][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's columns only

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_begin + t * C::BK;
    cp_wait<0>();
    __syncthreads();  // tile t landed; tile t-1's buffer consumed by every warp
    if (t + 1 < n_tiles) {
      T* nb = KV + ((t + 1) & 1) * 2 * C::BK * ST;
      const int k1 = k0 + C::BK;
      load_tile<HD, C::THREADS>(nb, ST, kb + k1 * kv_row, kv_row, C::BK, Skv - k1);
      load_tile<HD, C::THREADS>(nb + C::BK * ST, ST, vb + k1 * kv_row, kv_row, C::BK, Skv - k1);
    }
    cp_commit();
    if (all_masked(r0, 16, k0, C::BK, Sq, Skv, causal, window)) continue;
    const T* Ks = KV + (t & 1) * 2 * C::BK * ST;

    float s[NT][4] = {};
    mma_abt<T, HD, NT, false>(s, Qw, Ks, g, c);
    uint32_t vis = 0xffffffffu;
    float mx[2] = {kNegInf, kNegInf};
    if (all_visible(r0, 16, k0, C::BK, Sq, Skv, causal, window)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= sm_scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    } else {
      vis = 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = visible(r0 + g + 8 * (e >> 1), k0 + 8 * j + 2 * c + (e & 1), Sq, Skv,
                                  causal, window);
          s[j][e] = ok ? s[j][e] * sm_scale : kNegInf;
          vis |= (uint32_t)ok << (4 * j + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the quad's 4 lanes share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (4 * j + e)) & 1u ? expf(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    mma_pv<T, HD, NT, NO>(acc, s, Ks + C::BK * ST, 0, g, c);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + g + 8 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const float row_lse = m[i] + logf(fmaxf(l[i], 1e-30f));
    if (split) {  // this range's row: its normalised output and lse, for the merge
      const size_t at = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * Sq + row;
      float* prow = part + at * HD + 2 * c;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2(prow + 8 * n, acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      if (c == 0) part[(size_t)gridDim.z * gridDim.y * Sq * HD + at] = row_lse;
      continue;
    }
    if (lse != nullptr && c == 0) lse[((size_t)b * H + h) * Sq + row] = row_lse;
    T* orow = ob + row * q_row + 2 * c;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(orow + 8 * n, acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// The n_split ranges' partial rows (flash_fwd_kernel's scratch) merged, a
// warp a row (b·h, row): o = Σ_z exp(lse_z - lse)·o_z with
// lse = ln Σ_z exp(lse_z), in the order of the ranges.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_merge_kernel(const float* __restrict__ part, T* __restrict__ o, float* __restrict__ lse,
                   int n_split, int BH, int Sq, int H) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= BH * Sq) return;
  const size_t rows = (size_t)BH * Sq;
  const float* plse = part + (size_t)n_split * rows * HD;
  float mx = kNegInf;
  for (int z = 0; z < n_split; ++z) mx = fmaxf(mx, plse[z * rows + r]);
  float den = 0.f;
  for (int z = 0; z < n_split; ++z) den += expf(plse[z * rows + r] - mx);
  const float inv = 1.f / den;
  const int bh = r / Sq, row = r % Sq, b = bh / H, h = bh % H;
  T* orow = o + (((size_t)b * Sq + row) * H + h) * HD;
#pragma unroll
  for (int col = lane; col < HD; col += 32) {
    float x = 0.f;
    for (int z = 0; z < n_split; ++z)
      x = fmaf(expf(plse[z * rows + r] - mx), part[(z * rows + r) * HD + col], x);
    orow[col] = from_f32<T>(x * inv);
  }
  if (lse != nullptr && lane == 0) lse[r] = mx + logf(den);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   float* part, int B, int Sq, int Skv, int H, int K, int causal, int window,
                   int n_split, int split_len, float sm_scale, cudaStream_t stream) {
  using C = Tiles<HD>;
  if (n_split > 1 && (part == nullptr || causal || window > 0 || split_len % C::BK != 0 ||
                      (n_split - 1) * split_len >= Skv || n_split * split_len < Skv))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, B * H, n_split);
  flash_fwd_kernel<T, HD><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, part, split_len, Sq, Skv, H, K,
      causal, window, sm_scale);
  if (n_split == 1) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_merge_kernel<T, HD><<<(B * H * Sq + 7) / 8, 256, 0, stream>>>(
      part, static_cast<T*>(o), lse, n_split, B * H, Sq, H);
  return cudaGetLastError();
}

// bf16 at hd 64, 128 and 192 is flash_attention_wgmma.cu's
template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                        float* part, int B, int Sq, int Skv, int H, int K, int hd, int causal,
                        int window, int n_split, int split_len, float sm_scale,
                        cudaStream_t st) {
#define REPRO_LAUNCH(HD)                                                                   \
  launch<T, HD>(q, k, v, o, lse, part, B, Sq, Skv, H, K, causal, window, n_split, split_len, \
                sm_scale, st)
  switch (hd) {
    case 16: return REPRO_LAUNCH(16);
    case 32: return REPRO_LAUNCH(32);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (hd == 64) return REPRO_LAUNCH(64);
    if (hd == 128) return REPRO_LAUNCH(128);
    if (hd == 192) return REPRO_LAUNCH(192);
  }
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,Sq,H,hd), k/v (B,Skv,K,hd), o (B,Sq,H,hd), all contiguous, one dtype.
// lse: null, or fp32 (B,H,Sq) that receives each row's log-sum-exp.
// window <= 0 means no window; a causal or window mask needs Sq == Skv.
// n_split = 1 walks every key in one block per q tile; n_split > 1 (no mask)
// splits the kv axis into ranges of split_len keys, a multiple of the kv
// tile, that cover Skv, and needs part: fp32 scratch of
// n_split·B·H·Sq·(hd + 1) floats. Returns cudaGetLastError() after the
// launches.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, void* part, int dtype, int B, int Sq,
                                   int Skv, int H, int K, int hd, int causal, int window,
                                   int n_split, int split_len, float sm_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || n_split < 1)
    return cudaErrorInvalidValue;
  if ((causal || window > 0) && Sq != Skv) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* p = static_cast<float*>(part);
  if (dtype == repro::kFloat32)
    return dispatch_hd<float>(q, k, v, o, l, p, B, Sq, Skv, H, K, hd, causal, window, n_split,
                              split_len, sm_scale, st);
  if (dtype == repro::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, l, p, B, Sq, Skv, H, K, hd, causal, window,
                                      n_split, split_len, sm_scale, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the kernel for dtype (0 f32, 1 bf16) at head dim
// hd, or 0 for a case it does not take; for the build record.
extern "C" int flash_attention_fwd_smem_bytes(int dtype, int hd) {
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
