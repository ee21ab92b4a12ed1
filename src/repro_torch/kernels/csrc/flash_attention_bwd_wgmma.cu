// Flash attention backward for Hopper (sm_90a) on the tensor cores: the
// gradients dq, dk, dv of o = softmax(q·kᵀ·hd^-½ + mask)·v for bf16 inputs
// at head dim 64, 128 or 192: q, o, dO (B,Sq,H,hd), k/v (B,Skv,K,hd), query
// head h reading kv head h / (H/K), causal (col <= row) and sliding window
// (col > row - window), a ragged Skv masked by column and a ragged Sq by
// row; fp32 accumulators, bf16 outputs. Sq != Skv is cross-attention
// (whisper's decoder over its encoder's frames) and comes without a mask,
// as in the forward. Every other dtype and head dim runs the FMA kernels in
// flash_attention_bwd.cu.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward, and its
// training step differentiates the plain attention (models/layers.py,
// sdpa) through XLA. This computes the same gradient.
//
// Algorithm (FlashAttention-2's backward). The forward wrote each row's
// log-sum-exp lse (natural-log units of the scaled logits). With
// s = q·kᵀ·scale, p = exp(s - lse), D_i = Σ_d dO_id·O_id:
//   dv = pᵀ·dO,  dp = dO·vᵀ,  ds = p ⊙ (dp - D),  dq = ds·k·scale,
//   dk = dsᵀ·q·scale.
// Three kernels on one stream, no atomics, so two runs on the same inputs
// give the same bits (the engine re-runs step tasks and relies on it):
//   0. flash_bwd_delta_kernel: D of every row, one warp per row, to fp32
//      scratch (B, H, Sq);
//   1. flash_bwd_wgmma_dq_kernel, one block per (two 64-row q tiles, b·h):
//      one pass over the visible kv tiles, per tile S = q·kᵀ and
//      dP = dO·vᵀ (both operands in shared memory), p from lse, ds, and
//      dq += ds·k with ds as the register A operand and K read transposed;
//   2. flash_bwd_wgmma_dkdv_kernel, one block per (64-key kv tile, b·kv
//      head): keeps K and V in shared memory and loops over the G = H/K
//      query heads of its group and their visible q tiles, so dk and dv sum
//      over the group inside the block. Per q tile its first consumer
//      warpgroup forms Sᵀ = k·qᵀ, Pᵀ = exp(Sᵀ·scale - lse) and
//      dV += Pᵀ·dO, and its second dPᵀ = v·dOᵀ, dSᵀ = Pᵀ ⊙ (dPᵀ - D) and
//      dK += dSᵀ·q. Pᵀ goes from the first to the second through a
//      double-buffered fp32 area of shared memory, guarded by named
//      barriers. Splitting dK and dV between the warpgroups keeps a thread
//      at hd/2 accumulator registers (96 at hd 192) instead of hd.
// Every accumulator is fp32. p and ds enter their products (pᵀ·dO, dsᵀ·q,
// ds·k) as the register A operand, which wgmma takes in bf16 only: each is
// split into bf16 hi + lo, two products, so that it carries about 16 bits
// of mantissa. One bf16 product would round p and ds to 8 bits, which puts
// dq, dk and dv 0.9 to 2.7 times the elementwise limit against the fp32
// formulas (1e-2·(|ref| + rms(ref))) in an emulation of the arithmetic;
// with the split they read about 0.3 of it, the rounding of the outputs.
//
// What bounds it on the H100: per visible (query, key) pair and query head
// the gradient needs five 2·hd-FLOP products (q·kᵀ recomputed, dO·vᵀ,
// pᵀ·dO, dsᵀ·q, ds·k), far above the card's ridge at long S, so the bound is
// the bf16 tensor-core rate (989 TFLOP/s). This design pays for q·kᵀ and
// dO·vᵀ twice, once in each of kernels 1 and 2: seven products per pair
// against the bound's five, ten with the hi + lo splits. Recomputing buys a
// result with no atomics and no cross-block reduction, deterministic to the
// bit. The producer warpgroup hands its registers to the consumers
// (setmaxnreg), so that a consumer thread holds hd/2 fp32 accumulators, two
// score fragments and the split operands without spilling. The rest
// follows the forward (flash_attention_wgmma.cu): 4-D TMA tensor maps
// (hd, heads, Sq or Skv, B) with 128-byte swizzle, so a tile past its
// length reads zeros; rows of a q tile past Sq get p = 0 before their lse
// and D (never read past Sq) could enter, so they add nothing to dk or dv;
// one producer thread that streams tiles into an mbarrier ring; two
// consumer warpgroups; tiles past the causal diagonal or outside the window
// are never loaded, and only tiles that cross the diagonal, the window's
// edge, Sq or Skv test elements. What holds it back is in PERF.md (§6-7).
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (hopper.cuh)
constexpr int BT = 64;                    // rows of every q and kv tile
constexpr uint32_t kChunk = BT * ROW_BYTES;  // between a 64-row tile's column chunks
constexpr float kLog2e = 1.4426950408889634f;
// named barriers of the Pᵀ hand-over in the dk/dv kernel (0 is __syncthreads)
constexpr int kPFull = 1, kPEmpty = 3;

// the shared ring's depth: three stages where they fit beside the rest
template <int HD>
constexpr int nstage() { return HD > 128 ? 2 : 3; }

template <int HD>
struct DqSmem {
  static constexpr int C = HD / 64, NST = nstage<HD>();
  alignas(1024) __nv_bfloat16 q[C][2 * BT * 64];   // the block's two q tiles
  alignas(1024) __nv_bfloat16 dO[C][2 * BT * 64];
  alignas(1024) __nv_bfloat16 k[NST][C][BT * 64];
  alignas(1024) __nv_bfloat16 v[NST][C][BT * 64];
  uint64_t q_full;
  uint64_t k_full[NST];
  uint64_t v_full[NST];
  uint64_t empty[NST];
};

template <int HD>
struct KvSmem {
  static constexpr int C = HD / 64, NST = nstage<HD>();
  alignas(1024) __nv_bfloat16 k[C][BT * 64];
  alignas(1024) __nv_bfloat16 v[C][BT * 64];
  alignas(1024) __nv_bfloat16 q[NST][C][BT * 64];
  alignas(1024) __nv_bfloat16 dO[NST][C][BT * 64];
  float p[2][32][128];  // Pᵀ fragments: [buffer][element][thread of the warpgroup]
  uint64_t kv_full;
  uint64_t q_full[NST];
  uint64_t do_full[NST];
  uint64_t empty[NST];
};

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Skv, int causal,
                                        int window) {
  return row < Sq && col < Skv && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// whether every (row, col) of the 64 × 64 tile at (r0, c0) is visible
__device__ __forceinline__ bool all_visible(int r0, int c0, int Sq, int Skv, int causal,
                                            int window) {
  return r0 + BT <= Sq && c0 + BT <= Skv && (!causal || c0 + BT - 1 <= r0) &&
         (window <= 0 || r0 + BT - 1 - c0 < window);
}

// Stores a 64 × hd fp32 accumulator fragment, times `scale`, as bf16 rows
// row0 + (fragment row) of `out` (rows `stride` elements apart), rows < n.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], __nv_bfloat16* out,
                                           size_t stride, int r_lo, int r_hi, int quad, int n,
                                           float scale) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = (i & 2) ? r_hi : r_lo;
    if (row >= n) continue;
    const int col = 8 * (i / 4) + 2 * quad;
    *reinterpret_cast<__nv_bfloat162*>(out + row * stride + col) =
        __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

// --- kernel 0: D = Σ_d dO·O ------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;  // (b, s, h) in memory order
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat162* ob = reinterpret_cast<const __nv_bfloat162*>(o + (size_t)row * HD);
  const __nv_bfloat162* db = reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)row * HD);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 64; ++j) {
    const float2 a = __bfloat1622float2(ob[lane + 32 * j]);
    const float2 d = __bfloat1622float2(db[lane + 32 * j]);
    acc = fmaf(a.x, d.x, fmaf(a.y, d.y, acc));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
    delta[((size_t)b * H + h) * Sq + s] = acc;
  }
}

// --- kernel 1: dq ---------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int K,
                          int causal, int window, float scale_log2, float sm_scale) {
  using Sm = DqSmem<HD>;
  constexpr int NST = Sm::NST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw + (((raw + 1023) & ~1023u) - raw));

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / K);
  // two neighbouring 64-row q tiles, one per consumer warpgroup, the
  // heaviest blocks (late tiles under the causal mask) first
  const int nq = (Sq + BT - 1) / BT;
  const int tile0 = 2 * (gridDim.y - 1 - blockIdx.y);
  const int tile1 = tile0 + 1;
  const bool live1 = tile1 < nq;
  auto kv_from = [&](int t) { return window > 0 ? max(0, BT * t - window + 1) : 0; };
  auto kv_to = [&](int t) { return causal ? min(Skv, BT * t + BT) : Skv; };
  const int kv_begin = min(kv_from(tile0), live1 ? kv_from(tile1) : Skv) / BT * BT;
  const int kv_end = max(kv_to(tile0), live1 ? kv_to(tile1) : 0);
  const int n_tiles = (kv_end - kv_begin + BT - 1) / BT;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < NST; ++s) {
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
      constexpr uint32_t kTileBytes = BT * HD * 2;
      mbar_expect_tx(&sm.q_full, (live1 ? 4 : 2) * kTileBytes);
#pragma unroll
      for (int c = 0; c < Sm::C; ++c) {
        tma_load(sm.q[c], &tq, &sm.q_full, 64 * c, h, BT * tile0, b);
        tma_load(sm.dO[c], &tdo, &sm.q_full, 64 * c, h, BT * tile0, b);
        if (live1) {
          tma_load(sm.q[c] + BT * 64, &tq, &sm.q_full, 64 * c, h, BT * tile1, b);
          tma_load(sm.dO[c] + BT * 64, &tdo, &sm.q_full, 64 * c, h, BT * tile1, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NST;
        if (it >= NST) mbar_wait(&sm.empty[s], (it / NST - 1) & 1);
        const int k0 = kv_begin + it * BT;
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
  const int quad = lane % 4;
  const bool live = wg == 0 || live1;
  const int row0 = BT * (wg == 0 ? tile0 : tile1);
  const int r_lo = row0 + 16 * warp + lane / 4;  // the thread's two rows in every fragment
  const int r_hi = r_lo + 8;

  int it_lo = 0, it_hi = 0;  // this warpgroup's tiles: those not fully masked for its rows
  if (live) {
    it_lo = (kv_from(row0 / BT) - kv_begin) / BT;
    it_hi = max(it_lo, min(n_tiles, (kv_to(row0 / BT) - kv_begin + BT - 1) / BT));
  }
  // each row's lse in base 2 and its D (rows past Sq: p = 0, never stored)
  const float* lse_bh = lse + ((size_t)b * H + h) * Sq;
  const float* d_bh = delta + ((size_t)b * H + h) * Sq;
  const float l2_lo = r_lo < Sq ? lse_bh[r_lo] * kLog2e : 0.f;
  const float l2_hi = r_hi < Sq ? lse_bh[r_hi] * kLog2e : 0.f;
  const float d_lo = r_lo < Sq ? d_bh[r_lo] : 0.f;
  const float d_hi = r_hi < Sq ? d_bh[r_hi] : 0.f;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t ds_hi[4][4], ds_lo[4][4];  // ds as the bf16 A operands of ds·k
  const uint32_t q_addr = smem_u32(sm.q[0]) + BT * wg * ROW_BYTES;
  const uint32_t do_addr = smem_u32(sm.dO[0]) + BT * wg * ROW_BYTES;
  constexpr uint32_t kQChunk = 2 * BT * ROW_BYTES;
  auto k_addr = [&](int it) { return smem_u32(sm.k[it % NST][0]); };
  auto v_addr = [&](int it) { return smem_u32(sm.v[it % NST][0]); };
  auto wait_tile = [&](uint64_t (&bars)[NST], int it) {
    mbar_wait(&bars[it % NST], (it / NST) & 1);
    __syncwarp();  // wgmma wants the warp converged after the polling loop
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[it % NST]);
  };
  auto issue_scores = [&](int it) {  // S = q·kᵀ and dP = dO·vᵀ of tile it
    wait_tile(sm.k_full, it);
    issue_ss<HD>(sc, q_addr, kQChunk, k_addr(it), kChunk);
    wait_tile(sm.v_full, it);
    issue_ss<HD>(dp, do_addr, kQChunk, v_addr(it), kChunk);
  };

  mbar_wait(&sm.q_full, 0);
  __syncwarp();
  for (int it = 0; it < it_lo; ++it) {  // tiles before this warpgroup's are released unread
    wait_tile(sm.v_full, it);
    release(it);
  }
  // Per tile: wait for its S and dP (and the previous tile's dq product),
  // form ds, issue dq += ds·k, then the next tile's S and dP behind it.
  // No wgmma is issued under a condition inside the loop (the last tile is
  // peeled off): ptxas would otherwise serialise every wgmma of the kernel.
  auto step = [&](int it, auto next) {
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    if (it > it_lo) release(it - 1);
    const int k0 = kv_begin + it * BT;
    const bool full = all_visible(row0, k0, Sq, Skv, causal, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = i & 2;
      const int col = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
      const float p = (full || visible(hi ? r_hi : r_lo, col, Sq, Skv, causal, window))
                          ? fast_exp2(fmaf(sc[i], scale_log2, -(hi ? l2_hi : l2_lo))) : 0.f;
      dp[i] = p * (dp[i] - (hi ? d_hi : d_lo));
    }
    to_a_operands(dp, ds_hi, ds_lo);
    issue_rs2(acc, ds_hi, ds_lo, k_addr(it), kChunk);
    if constexpr (decltype(next)::value) issue_scores(it + 1);
  };
  if (it_lo < it_hi) {
    issue_scores(it_lo);
    for (int it = it_lo; it + 1 < it_hi; ++it) step(it, std::true_type{});
    step(it_hi - 1, std::false_type{});
    wgmma_wait<0>();
    fence_regs(acc);
    release(it_hi - 1);
  }
  for (int it = it_hi; it < n_tiles; ++it) {  // and so are the tiles after its last
    wait_tile(sm.v_full, it);
    release(it);
  }
  if (!live) return;
  store_rows<HD>(acc, dq + (size_t)b * Sq * H * HD + (size_t)h * HD, (size_t)H * HD, r_lo, r_hi,
                 quad, Sq, sm_scale);
}

// --- kernel 2: dk, dv -----------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int Sq, int Skv, int H, int K, int causal, int window,
                            float scale_log2, float sm_scale) {
  using Sm = KvSmem<HD>;
  constexpr int NST = Sm::NST;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw + (((raw + 1023) & ~1023u) - raw));

  const int tid = threadIdx.x;
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int G = H / K;
  // kv tile j on y: the early tiles, which see the most q tiles under the
  // causal mask, are handed out first for every (b, kv head)
  const int k0 = BT * blockIdx.y;
  const int qt_begin = causal ? blockIdx.y : 0;
  const int qt_end = ((window > 0 ? min(Sq, k0 + BT - 1 + window) : Sq) + BT - 1) / BT;
  const int n_q = qt_end - qt_begin;
  const int n_it = G * n_q;  // (head of the group, q tile) pairs, head-major

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(&sm.q_full[s], 1);
      mbar_init(&sm.do_full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    producer_regs();
    if (tid == CONSUMERS) {
      constexpr uint32_t kTileBytes = BT * HD * 2;
      mbar_expect_tx(&sm.kv_full, 2 * kTileBytes);
#pragma unroll
      for (int c = 0; c < Sm::C; ++c) {
        tma_load(sm.k[c], &tk, &sm.kv_full, 64 * c, kh, k0, b);
        tma_load(sm.v[c], &tv, &sm.kv_full, 64 * c, kh, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % NST;
        if (it >= NST) mbar_wait(&sm.empty[s], (it / NST - 1) & 1);
        const int h = kh * G + it / n_q;
        const int q0 = BT * (qt_begin + it % n_q);
        mbar_expect_tx(&sm.q_full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < Sm::C; ++c) tma_load(sm.q[s][c], &tq, &sm.q_full[s], 64 * c, h, q0, b);
        mbar_expect_tx(&sm.do_full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < Sm::C; ++c)
          tma_load(sm.dO[s][c], &tdo, &sm.do_full[s], 64 * c, h, q0, b);
      }
    }
    return;
  }

  consumer_regs();
  // warpgroup 0: Pᵀ and dV; warpgroup 1: dSᵀ and dK. Fragment rows are the
  // block's keys, fragment columns the q tile's rows.
  const int wg = tid / 128;
  const int t = tid % 128;
  const int warp = t / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int key_lo = k0 + 16 * warp + lane / 4;
  const int key_hi = key_lo + 8;

  float acc[HD / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[32];                  // Sᵀ then Pᵀ (0), dPᵀ then dSᵀ (1)
  uint32_t a_hi[4][4], a_lo[4][4];  // sc as the bf16 A operands
  const uint32_t kv_addr = smem_u32(wg == 0 ? sm.k[0] : sm.v[0]);
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[it % NST]);
  };

  // Warpgroup 0 forms Sᵀ = k·qᵀ and then dV += Pᵀ·dO; warpgroup 1 forms
  // dPᵀ = v·dOᵀ and then dK += dSᵀ·q. The same code for both, on the tiles
  // each reads first and second (q and dO, or dO and q): no wgmma is issued
  // under a condition, which would make ptxas serialise them all.
  uint64_t* first_full = wg == 0 ? sm.q_full : sm.do_full;
  uint64_t* second_full = wg == 0 ? sm.do_full : sm.q_full;
  const uint32_t first_base = smem_u32(wg == 0 ? sm.q[0][0] : sm.dO[0][0]);
  const uint32_t second_base = smem_u32(wg == 0 ? sm.dO[0][0] : sm.q[0][0]);
  constexpr uint32_t kStage = sizeof(sm.q[0]);
  auto wait_on = [&](uint64_t* bars, int it) {
    mbar_wait(&bars[it % NST], (it / NST) & 1);
    __syncwarp();
  };
  auto issue_scores = [&](int it) {  // Sᵀ or dPᵀ of item it, into sc
    wait_on(first_full, it);
    issue_ss<HD>(sc, kv_addr, kChunk, first_base + (it % NST) * kStage, kChunk);
  };
  // Per item: the scores, then Pᵀ or dSᵀ, then the product, each waited
  // for. (Issuing the next item's scores ahead of this item's product was
  // measured slower: with a ring of two or three stages, the next tile's
  // load then starts only as it is needed.)
  mbar_wait(&sm.kv_full, 0);
  __syncwarp();
  for (int it = 0; it < n_it; ++it) {
    const int h = kh * G + it / n_q;
    const int q0 = BT * (qt_begin + it % n_q);
    const int buf = it % 2;
    // this thread's 16 columns: lse (base 2) for warpgroup 0, D for 1
    const float* rowvec = (wg == 0 ? lse : delta) + ((size_t)b * H + h) * Sq;
    const float unit = wg == 0 ? kLog2e : 1.f;
    float cv[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int row = q0 + 8 * (c / 2) + 2 * quad + (c & 1);
      cv[c] = row < Sq ? rowvec[row] * unit : 0.f;
    }
    issue_scores(it);
    wgmma_wait<0>();
    fence_regs(sc);
    if (wg == 0) {  // Pᵀ = exp(Sᵀ·scale - lse), handed to warpgroup 1
      const bool full = all_visible(q0, k0, Sq, Skv, causal, window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = q0 + 8 * (i / 4) + 2 * quad + (i & 1);
        const int key = (i & 2) ? key_hi : key_lo;
        const int c = 2 * (i / 4) + (i & 1);
        sc[i] = (full || visible(row, key, Sq, Skv, causal, window))
                    ? fast_exp2(fmaf(sc[i], scale_log2, -cv[c])) : 0.f;
      }
      if (it >= 2) named_sync(kPEmpty + buf, CONSUMERS);  // warpgroup 1 read this buffer
#pragma unroll
      for (int i = 0; i < 32; ++i) sm.p[buf][i][t] = sc[i];
      named_arrive(kPFull + buf, CONSUMERS);
    } else {  // dSᵀ = Pᵀ ⊙ (dPᵀ - D)
      named_sync(kPFull + buf, CONSUMERS);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 2 * (i / 4) + (i & 1);
        sc[i] = sm.p[buf][i][t] * (sc[i] - cv[c]);
      }
      if (it + 2 < n_it) named_arrive(kPEmpty + buf, CONSUMERS);
    }
    to_a_operands(sc, a_hi, a_lo);
    wait_on(second_full, it);
    fence_regs(acc);
    issue_rs2(acc, a_hi, a_lo, second_base + (it % NST) * kStage, kChunk);  // dV or dK
    wgmma_wait<0>();
    fence_regs(acc);
    release(it);
  }

  const size_t kv_row = (size_t)K * HD;
  __nv_bfloat16* out = (wg == 0 ? dv : dk) + (size_t)b * Skv * kv_row + (size_t)kh * HD;
  store_rows<HD>(acc, out, kv_row, key_lo, key_hi, quad, Skv, wg == 0 ? 1.f : sm_scale);
}

// --- host side -------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* delta, int B, int Sq, int Skv, int H, int K, int causal, int window,
                   float sm_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B, Sq, H, HD, BT) || !make_map(&tk, k, B, Skv, K, HD, BT) ||
      !make_map(&tv, v, B, Skv, K, HD, BT) || !make_map(&tdo, dout, B, Sq, H, HD, BT))
    return cudaErrorInvalidValue;
  const int smem_dq = (int)sizeof(DqSmem<HD>) + 1024;  // + room to align the base to 1024
  const int smem_kv = (int)sizeof(KvSmem<HD>) + 1024;
  static const cudaError_t attr = [&] {  // once: it costs host time
    const cudaError_t e = allow_smem(flash_bwd_wgmma_dq_kernel<HD>, smem_dq);
    return e != cudaSuccess ? e : allow_smem(flash_bwd_wgmma_dkdv_kernel<HD>, smem_kv);
  }();
  if (attr != cudaSuccess) return attr;
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<HD><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta,
      rows, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = sm_scale * kLog2e;
  const int nq = (Sq + BT - 1) / BT, nkv = (Skv + BT - 1) / BT;
  flash_bwd_wgmma_dq_kernel<HD><<<dim3(B * H, (nq + 1) / 2), THREADS, smem_dq, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, K, causal,
      window, scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_wgmma_dkdv_kernel<HD><<<dim3(B * K, nkv), THREADS, smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, K, causal, window, scale_log2, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B,Sq,H,hd); k, v, dk, dv (B,Skv,K,hd): bf16, contiguous,
// 16-byte aligned; hd 64, 128 or 192. lse: fp32 (B,H,Sq), each row's
// log-sum-exp from the forward. delta: fp32 scratch of B·H·Sq floats.
// window <= 0 means no window; a causal or window mask needs Sq == Skv.
// Returns cudaGetLastError() after the launches.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv, void* delta, int B,
                                         int Sq, int Skv, int H, int K, int hd, int causal,
                                         int window, float sm_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || lse == nullptr)
    return cudaErrorInvalidValue;
  if ((causal || window > 0) && Sq != Skv) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
#define REPRO_LAUNCH(HD) \
  launch<HD>(q, k, v, o, dout, l, dq, dk, dv, d, B, Sq, Skv, H, K, causal, window, sm_scale, st)
  if (hd == 64) return REPRO_LAUNCH(64);
  if (hd == 128) return REPRO_LAUNCH(128);
  if (hd == 192) return REPRO_LAUNCH(192);
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the dq (kernel 0) or dk/dv (kernel 1) kernel at
// head dim hd, or 0 for a head dim they do not take; for the build record.
extern "C" int flash_attention_bwd_wgmma_smem_bytes(int hd, int kernel) {
  if (hd == 64) return (int)(kernel ? sizeof(KvSmem<64>) : sizeof(DqSmem<64>)) + 1024;
  if (hd == 128) return (int)(kernel ? sizeof(KvSmem<128>) : sizeof(DqSmem<128>)) + 1024;
  if (hd == 192) return (int)(kernel ? sizeof(KvSmem<192>) : sizeof(DqSmem<192>)) + 1024;
  return 0;
}
