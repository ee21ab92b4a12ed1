// Flash attention forward for Hopper (sm_90a) on the tensor cores: bf16
// inputs at head dim 64, 128 or 192, causal / sliding-window masks,
// grouped-query heads, fp32 softmax and accumulator, bf16 output, and on
// request each row's log-sum-exp for the backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function flash_attention (body _flash_kernel), for the cases the
// wrapper sends here: bf16 with hd 64 (smollm-360m), 128 (llama3, qwen2,
// chameleon, mixtral) or 192 (nemotron-4-340b: 18432 / 96). Every other
// dtype and head dim runs the FMA kernel
// in flash_attention.cu (f32 has no tensor-core path within its 2e-5
// tolerance). It computes softmax(q·kᵀ·hd^-½ + mask)·v for q (B,Sq,H,hd),
// k/v (B,Skv,K,hd), query head h reading kv head h / (H/K), with the masks
// col <= row (causal), col > row - window (window) and col < Skv (a ragged
// Skv needs no padding; rows past a ragged Sq are not written). Sq != Skv
// is cross-attention (whisper's decoder over its 1500 encoder frames, which
// the TPU kernel cannot take: it reads its length from q) and comes without
// a mask; the wrapper refuses a causal or window mask there. Masked logits
// are -1e30, the denominator is clamped at 1e-30, probabilities are rounded
// to bf16 before p·v as in the plain version.
//
// The log-sum-exp (lse, fp32, (B, H, Sq)) is written when the caller passes
// a buffer for it (training), in natural-log units of the scaled logits:
// lse = ln Σ_col exp(q·k·sm_scale), so p = exp(q·k·sm_scale - lse). The
// kernel keeps its running max m in raw q·k units and sums base-2
// exponentials of (s - m)·sm_scale·log2e, so it stores
// (m·sm_scale·log2e + log2 l)·ln 2.
//
// What bounds it on the H100: at long S, 4·hd FLOPs per unmasked
// query-key pair and head against 2·S·hd·(H+2K) bytes, far above the
// card's ridge of 295 FLOP/byte in bf16, so the bound is the bf16
// tensor-core rate (989 TFLOP/s); at smollm's S=512 the bytes bound it.
// What the design does:
// - both products are wgmma in bf16 with fp32 accumulators: S = q·kᵀ with
//   the q tile (A) and the K tile (B, K-major as it lies in memory) read
//   from shared memory; O += p·v with p as the A operand in registers (the
//   fp32 score fragment is the A-fragment layout, converted to bf16 in
//   place) and V as the B operand read with the transpose flag;
// - one producer thread loads the block's q rows once and streams 64-key K
//   and V tiles by TMA into a three-stage ring of shared memory, 128-byte
//   swizzled to match the wgmma descriptors, each load completing on an
//   mbarrier; K and V have their own barriers, so q·kᵀ starts while V is
//   still in flight;
// - q/k/v are 4-D tensor maps (hd, heads, Sq or Skv, B): a tile that runs
//   past its length reads zeros, never the next sequence's rows;
// - two consumer warpgroups own 64 query rows each and share every K/V
//   tile; the producer's warpgroup hands them its registers (setmaxnreg),
//   so that hd 192's 96 accumulators a thread do not spill. Under a plain causal mask, when the whole grid is resident at
//   once, a block pairs q tile y with tile nq-1-y, so every block has the
//   same work; otherwise it takes two neighbouring tiles, the heaviest
//   blocks first;
// - each warpgroup is software-pipelined: it issues q·kᵀ of tile j and
//   p·v of tile j-1 together, and the softmax of tile j runs on the CUDA
//   cores while p·v of tile j-1 runs on the tensor cores. The softmax
//   keeps the running max in raw units, so each p is one FFMA and one
//   ex2; only tiles crossing the diagonal, the window's edge or Skv test
//   elements; a row's max and sum live in the 4 threads that hold it in
//   the accumulator fragment (two shuffles);
// - kv tiles past the causal diagonal or before the window are not loaded,
//   and a warpgroup skips the products of a tile fully masked for its rows.
// What holds it back now is in PERF.md (§6, PR 13).
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int BQ = 128;                   // query rows per block: 2 warpgroups of 64
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (hopper.cuh)
constexpr float kNegInf = -1e30f;         // masked logit, as in the reference kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Each tile is stored as hd/64 column chunks of (rows × 64) bf16 (hopper.cuh).
constexpr int BK = 64;                    // keys per kv tile
constexpr int NSTAGE = 3;                 // K/V ring depth

template <int HD>
struct Smem {
  static constexpr int C = HD / 64;
  alignas(1024) __nv_bfloat16 q[C][BQ * 64];
  alignas(1024) __nv_bfloat16 k[NSTAGE][C][BK * 64];
  alignas(1024) __nv_bfloat16 v[NSTAGE][C][BK * 64];
  uint64_t q_full;
  uint64_t k_full[NSTAGE];
  uint64_t v_full[NSTAGE];
  uint64_t empty[NSTAGE];
};

// --- one warpgroup's steps ---------------------------------------------------

// Online softmax in base 2 of one tile's raw scores, in place: sc becomes p.
// Element i of the fragment is row (i & 2 ? r_hi : r_lo), column
// k0 + 8·(i/4) + 2·quad + (i & 1). The running max m is kept in raw units
// (scale > 0 keeps the order), so each p is one FFMA and one ex2. A row
// whose columns are all masked so far has m = -1e30; its reference is then
// 0, so its masked entries still give ex2(-1e30·scale) = 0. The partial sums
// l run over this thread's columns; (a_lo, a_hi) are the factors the
// accumulator rows must be scaled by. Reductions are trees of 4 chains.
template <int BK, bool MASKED>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float& m_lo, float& m_hi,
                                               float& l_lo, float& l_hi, float& a_lo,
                                               float& a_hi, int k0, int r_lo, int r_hi,
                                               int quad, int Skv, int causal, int window,
                                               float scale) {
  if constexpr (MASKED) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
      const int row = (i & 2) ? r_hi : r_lo;
      const bool ok = col < Skv && (!causal || col <= row) && (window <= 0 || col > row - window);
      sc[i] = ok ? sc[i] : kNegInf;
    }
  }
  float mx[2][4];  // [row half][chain]
#pragma unroll
  for (int c = 0; c < 4; ++c) mx[0][c] = mx[1][c] = kNegInf;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float& t = mx[(i >> 1) & 1][((i >> 2) + i) & 3];
    t = fmaxf(t, sc[i]);
  }
  float mx_lo = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  float mx_hi = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
  a_lo = fast_exp2((m_lo - mn_lo) * scale);
  a_hi = fast_exp2((m_hi - mn_hi) * scale);
  m_lo = mn_lo;
  m_hi = mn_hi;
  const float ref_lo = -(mn_lo == kNegInf ? 0.f : mn_lo) * scale;
  const float ref_hi = -(mn_hi == kNegInf ? 0.f : mn_hi) * scale;
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int half = (i >> 1) & 1;
    sc[i] = fast_exp2(fmaf(sc[i], scale, half ? ref_hi : ref_lo));
    sum[half][((i >> 2) + i) & 3] += sc[i];
  }
  l_lo = fmaf(l_lo, a_lo, (sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
  l_hi = fmaf(l_hi, a_hi, (sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
}

// A tile needs masking where it crosses the diagonal, the window's edge or
// Skv; the others take the softmax without a per-element test.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi, float& a_lo, float& a_hi,
                                             int k0, int row0, int r_lo, int r_hi, int quad,
                                             int Skv, int causal, int window, float scale) {
  if (k0 + BK > Skv || (causal && k0 + BK - 1 > row0) ||
      (window > 0 && k0 < row0 + 64 - window))
    online_softmax<BK, true>(sc, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, k0, r_lo, r_hi, quad, Skv,
                             causal, window, scale);
  else
    online_softmax<BK, false>(sc, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, k0, r_lo, r_hi, quad, Skv,
                              causal, window, scale);
}

// --- the kernel ------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int Sq, int Skv, int H, int K, int causal,
                   int window, int paired, float scale_log2) {
  using Sm = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw + (((raw + 1023) & ~1023u) - raw));

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / K);
  // The block's two 64-row q tiles, one per consumer warpgroup. Paired
  // (a causal mask without a window, the whole grid resident at once): a q
  // tile's work grows with its position, so block y pairs tile y with tile
  // nq-1-y and every block has the same work (the two are the same tile in
  // the middle of an odd nq: the second warpgroup then has no rows).
  // Otherwise the block takes two neighbouring tiles, the heaviest blocks
  // first, so that the lighter ones fill the SMs that finish early.
  const int nq = (Sq + 63) / 64;
  const int y = paired ? blockIdx.y : gridDim.y - 1 - blockIdx.y;
  const int tile0 = paired ? y : 2 * y;
  const int tile1 = paired ? nq - 1 - y : 2 * y + 1;
  const bool live1 = tile1 < nq && tile1 != tile0;
  auto kv_from = [&](int t) { return window > 0 ? max(0, 64 * t - window + 1) : 0; };
  auto kv_to = [&](int t) { return causal ? min(Skv, 64 * t + 64) : Skv; };
  const int kv_begin = min(kv_from(tile0), live1 ? kv_from(tile1) : Skv) / BK * BK;
  const int kv_end = max(kv_to(tile0), live1 ? kv_to(tile1) : 0);
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    producer_regs();
    // producer warpgroup: one thread issues every load
    if (tid == CONSUMERS) {
      constexpr uint32_t kTileBytes = BK * HD * 2;
      mbar_expect_tx(&sm.q_full, (live1 ? 2 : 1) * 64 * HD * 2);
#pragma unroll
      for (int c = 0; c < Sm::C; ++c) {
        tma_load(sm.q[c], &tq, &sm.q_full, 64 * c, h, 64 * tile0, b);
        if (live1) tma_load(sm.q[c] + 64 * 64, &tq, &sm.q_full, 64 * c, h, 64 * tile1, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NSTAGE;
        if (it >= NSTAGE) mbar_wait(&sm.empty[s], (it / NSTAGE - 1) & 1);
        const int k0 = kv_begin + it * BK;
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < Sm::C; ++c) tma_load(sm.k[s][c], &tk, &sm.k_full[s], 64 * c, kh, k0, b);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < Sm::C; ++c) tma_load(sm.v[s][c], &tv, &sm.v_full[s], 64 * c, kh, k0, b);
      }
    }
    return;
  }

  consumer_regs();
  // consumer warpgroup wg owns query rows row0 .. row0 + 63
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool live = wg == 0 || live1;
  const int row0 = 64 * (wg == 0 ? tile0 : tile1);
  // the two rows this thread holds in every accumulator fragment
  const int r_lo = row0 + 16 * warp + lane / 4;
  const int r_hi = r_lo + 8;

  // this warpgroup's tiles [it_lo, it_hi): those not fully masked for its rows
  int it_lo = 0, it_hi = 0;
  if (live) {
    it_lo = (kv_from(row0 / 64) - kv_begin) / BK;
    it_hi = max(it_lo, min(n_tiles, (kv_to(row0 / 64) - kv_begin + BK - 1) / BK));
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];         // scores, then probabilities, of the newest tile
  uint32_t pa[4][4];        // the tile before it's probabilities: the A operand of p·v
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f, a_lo, a_hi;
  const uint32_t q_addr = smem_u32(sm.q[0]) + 64 * wg * ROW_BYTES;
  constexpr uint32_t kQChunk = BQ * ROW_BYTES, kKvChunk = BK * ROW_BYTES;
  auto k_addr = [&](int it) { return smem_u32(sm.k[it % NSTAGE][0]); };
  auto v_addr = [&](int it) { return smem_u32(sm.v[it % NSTAGE][0]); };
  auto wait_tile = [&](uint64_t (&bars)[NSTAGE], int it) {
    mbar_wait(&bars[it % NSTAGE], (it / NSTAGE) & 1);
    __syncwarp();  // wgmma wants the warp converged after the polling loop
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[it % NSTAGE]);
  };

  mbar_wait(&sm.q_full, 0);
  __syncwarp();
  // tiles before this warpgroup's first one are released unread
  for (int it = 0; it < it_lo; ++it) {
    wait_tile(sm.v_full, it);
    release(it);
  }
  if (it_lo < it_hi) {
    wait_tile(sm.k_full, it_lo);
    issue_ss<HD>(sc, q_addr, kQChunk, k_addr(it_lo), kKvChunk);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile<BK>(sc, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kv_begin + it_lo * BK, row0, r_lo,
                     r_hi, lane % 4, Skv, causal, window, scale_log2);
    // acc is still zero: nothing to rescale
    to_a_operand(sc, pa);
    // steady state: q·kᵀ of tile it and p·v of tile it-1 are issued
    // together; the softmax of tile it overlaps p·v of tile it-1
    for (int it = it_lo + 1; it < it_hi; ++it) {
      wait_tile(sm.k_full, it);
      issue_ss<HD>(sc, q_addr, kQChunk, k_addr(it), kKvChunk);
      wait_tile(sm.v_full, it - 1);
      fence_regs(acc);
      issue_rs(acc, pa, v_addr(it - 1), kKvChunk);
      wgmma_wait<1>();  // q·kᵀ of tile it is done
      fence_regs(sc);
      softmax_tile<BK>(sc, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kv_begin + it * BK, row0, r_lo,
                       r_hi, lane % 4, Skv, causal, window, scale_log2);
      wgmma_wait<0>();  // p·v of tile it-1 is done: its stage can be refilled
      fence_regs(acc);
      release(it - 1);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? a_hi : a_lo;
      to_a_operand(sc, pa);
    }
    wait_tile(sm.v_full, it_hi - 1);
    fence_regs(acc);
    issue_rs(acc, pa, v_addr(it_hi - 1), kKvChunk);
    wgmma_wait<0>();
    fence_regs(acc);
    release(it_hi - 1);
  }
  // and so are the tiles after its last one
  for (int it = it_hi; it < n_tiles; ++it) {
    wait_tile(sm.v_full, it);
    release(it);
  }
  if (!live) return;

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  if (lse != nullptr && lane % 4 == 0) {  // one thread of the row's quad
    float* lb = lse + ((size_t)b * H + h) * Sq;
    if (r_lo < Sq) lb[r_lo] = fmaf(m_lo, scale_log2, log2f(fmaxf(l_lo, 1e-30f))) * kLn2;
    if (r_hi < Sq) lb[r_hi] = fmaf(m_hi, scale_log2, log2f(fmaxf(l_hi, 1e-30f))) * kLn2;
  }
  const size_t row_stride = (size_t)H * HD;
  __nv_bfloat16* ob = o + (size_t)b * Sq * row_stride + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = (i & 2) ? r_hi : r_lo;
    if (row >= Sq) continue;
    const float inv = (i & 2) ? inv_hi : inv_lo;
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(ob + row * row_stride + col) =
        __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
  }
}

// --- host side -------------------------------------------------------------

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int K, int causal, int window, float sm_scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, H, HD, 64) || !make_map(&tk, k, B, Skv, K, HD, BK) ||
      !make_map(&tv, v, B, Skv, K, HD, BK))
    return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<HD>) + 1024;  // + room to align the base to 1024
  // once each, as they cost host time: the shared-memory limit, and how
  // many blocks the card holds at once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  static const long resident = [smem] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_wgmma_kernel<HD>, THREADS, smem);
    return (long)sms * per_sm;
  }();
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);  // pairs of 64-row q tiles
  const int paired = causal && window <= 0 && (long)grid.x * grid.y <= resident;
  flash_wgmma_kernel<HD><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, K, causal, window, paired,
      sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,hd), k/v (B,Skv,K,hd), o (B,Sq,H,hd): bf16, contiguous, 16-byte
// aligned; hd 64, 128 or 192. lse: null, or fp32 (B,H,Sq) that receives each
// row's log-sum-exp. window <= 0 means no window; a causal or window mask
// needs Sq == Skv. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int B, int Sq, int Skv, int H, int K,
                                         int hd, int causal, int window, float sm_scale,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  if ((causal || window > 0) && Sq != Skv) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_LAUNCH(HD) launch<HD>(q, k, v, o, l, B, Sq, Skv, H, K, causal, window, sm_scale, st)
  if (hd == 64) return REPRO_LAUNCH(64);
  if (hd == 128) return REPRO_LAUNCH(128);
  if (hd == 192) return REPRO_LAUNCH(192);
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the kernel at head dim hd, or 0 for a head dim
// it does not take; for the build record.
extern "C" int flash_attention_wgmma_smem_bytes(int hd) {
  if (hd == 64) return (int)sizeof(Smem<64>) + 1024;
  if (hd == 128) return (int)sizeof(Smem<128>) + 1024;
  if (hd == 192) return (int)sizeof(Smem<192>) + 1024;
  return 0;
}
