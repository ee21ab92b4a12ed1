// Chunkwise mLSTM (gated linear attention) for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linear_attention.py,
// function mlstm_chunk (body _mlstm_kernel). For each (b, h) it runs the
// chunks of the sequence in order, carrying the matrix state C (hd×hd)
// and the normaliser n (hd). Within a chunk of c positions, with
// fcum = cumsum(log f) and ftot = fcum[c-1]:
//   y_s   = (e^fcum_s q_s·C + Σ_{t≤s} (q_s·k_t) e^(fcum_s−fcum_t) i_t v_t)
//           / max(|e^fcum_s q_s·n + Σ_{t≤s} (q_s·k_t) e^(fcum_s−fcum_t) i_t|, 1)
//   C    ← e^ftot C + Σ_t k_t i_t e^(ftot−fcum_t) v_tᵀ,   n likewise with k_t.
// Beyond the TPU kernel it takes an initial state (zeros when null), writes
// the final one, and masks a ragged last chunk itself: positions past S act
// as log f = 0, i = 0, q = k = v = 0 (no padding copy, no S % c assertion).
// Every input and output is fp32.
//
// What bounds it on the H100: per position 2·(c+1)·hd + 4·hd² FLOPs (q·k
// and the product with v over the c(c+1)/2 causal pairs of a chunk, q·C
// and the state update) against 16·hd bytes of q, k, v and y, about 136
// FLOP/byte at hd = 512 and c = 64: the operations bound it. The products
// run on the tensor cores at fp32 accuracy as 3xTF32: each operand is split
// into a TF32 high part (rounded to nearest, ties away, as cvt.rna) and the
// remainder, which the tensor core reads as TF32 (its low 13 bits dropped),
// and a·b is taken as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi on mma.sync.m16n8k8
// with fp32 accumulation. One TF32 product alone keeps about 11 bits and
// misses the 5e-5 / 5e-4 tolerance at hd 512. So the bound is a third of
// the TF32 rate.
//
// Two kernels, one call:
// 1. mlstm_scores_kernel, a cluster of 4 CTAs per (chunk, b·h), each over
//    a quarter of the key width: fcum, the weights W_t = i_t e^(ftot−fcum_t),
//    the masked, decayed scores P = (q·kᵀ) ⊙ D over the 20 causal 16×8
//    tiles (the four partial sums added in rank order through distributed
//    shared memory; exp only where t ≤ s, above the diagonal it overflows),
//    the row sums of P, and u = Σ_t k_t W_t, the chunk's addition to n, into
//    a workspace record per (b, h, chunk). The c×c scores are computed once
//    per (b, h, chunk).
// 2. mlstm_state_kernel, grid (hd/32, b·h) in clusters of 2: at hd = 512, C
//    is 1 MiB for each (b, h), more than an SM's 227 KB of shared memory, so
//    C is split over its value columns: CTA (vt, bh) owns C[:, 32·vt : +32]
//    in shared memory and loops over the chunks. Per chunk it streams q,
//    then k, in slabs of 128 key columns through a ring of 2 stages filled
//    by TMA (one producer thread; each slab is fetched once per cluster and
//    multicast to both CTAs; the chunk's v tile, P, gates and u ride with its
//    first slab, so chunk j+1's loads run under chunk j's products):
//      y   = e^fcum ⊙ (q·C[:, vt]) + P·v[:, vt]
//      C   ← e^ftot C + kᵀ·(W ⊙ v[:, vt]),   n ← e^ftot n + u
//    Splitting costs instructions beside every product, so each warp shares
//    its splits over as many tiles as it can: for q·C warp w takes k-steps
//    w, w + 8 of each slab for all 64 rows and 32 value columns (16 tiles),
//    the eight partial sums meeting once per chunk in shared memory; for the
//    update, W ⊙ v is split once per chunk into registers. q·n is c·hd FMAs,
//    done beside the products. The state kernel starts under the scores
//    kernel's tail (programmatic dependent launch) and waits for it only
//    before its first copy.
//
// For the backward (csrc/mlstm_chunk_bwd.cu), when the caller passes the
// buffers, the state kernel also writes each chunk's entering state C_j
// (its value tile, from shared memory) and n_j, and each row's normaliser
// nrm. Without them it writes nothing more, and its output is the same.
#include <cuda.h>  // CUtensorMap and the driver's enums only: no -lcuda
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

using repro::cp_commit;
using repro::cp_wait;
using repro::load_tile;
using repro::mma;
using repro::mma3;
using repro::split;

constexpr int CM = 64;             // most positions in a chunk (rows of every tile)
constexpr int VT = 32;             // value columns of C owned by one state block
constexpr int THREADS = 256;       // state kernel: 8 warps
constexpr int SCORE_THREADS = 256; // scores kernel: 8 warps
constexpr int SCORE_CL = 4;        // scores CTAs per (chunk, b·h), each a quarter of the key width
constexpr int KS_MAX = 128;        // key columns per slab of the state kernel's ring
constexpr int CLUSTER = 2;         // state CTAs sharing each q / k slab (multicast)
constexpr int GATES = 3 * CM;      // fcum, W, row sums of P per chunk in the workspace
constexpr int PST = CM + 4;        // row stride of P, in the workspace and in shared memory
// Workspace record of one (b, h, chunk): P in rows of PST, the gates, then
// u = Σ_t k_t W_t (hd floats), the chunk's addition to n.
__host__ __device__ constexpr int record(int hd) { return CM * PST + GATES + hd; }

// ---- 1. scores: fcum, W, P = (q·kᵀ) ⊙ D, its row sums, and u ----

// The 20 (16-row, 8-key) tiles of P on and left of the diagonal, in order of
// their rows: tile k has rows 16·i .. and keys 8·j .., j < 2·(i + 1).
__device__ __forceinline__ int tile_row(int k) { return k < 2 ? 0 : k < 6 ? 1 : k < 12 ? 2 : 3; }
__device__ __forceinline__ int tile_col(int k) {
  return k - (k < 2 ? 0 : k < 6 ? 2 : k < 12 ? 6 : 12);
}
constexpr int CAUSAL_TILES = 20;

template <int HD>
struct ScoreSmem {
  static constexpr int DQ = HD / SCORE_CL;  // key columns of this CTA
  static constexpr int ST = DQ + 4;         // row stride: conflict-free fragment loads
  static constexpr int Q = 0;               // q, CM × ST
  static constexpr int K = Q + CM * ST;     // k, CM × ST
  static constexpr int PP = K + CM * ST;    // partial scores over this CTA's columns, CM × (CM + 1)
  static constexpr int FC = PP + CM * (CM + 1);
  static constexpr int IG = FC + CM;
  static constexpr int WT = IG + CM;        // W_t = i_t e^(ftot − fcum_t)
  static constexpr int UP = WT + CM;        // partial sums of u, SCORE_THREADS
  static constexpr int TOTAL = UP + SCORE_THREADS;
};

// A cluster of SCORE_CL CTAs per (chunk, b·h), CTA r taking key columns
// r·hd/SCORE_CL ..: each loads its slices of q and k once, sums its part of
// q·kᵀ over the causal tiles and its columns of u; then CTA r adds the
// partial scores of rows 16·r .. 16·r + 15 from all CTAs (in rank order),
// applies the decay mask and writes them.
template <int HD>
__global__ void __cluster_dims__(SCORE_CL, 1, 1) __launch_bounds__(SCORE_THREADS)
mlstm_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ log_f, const float* __restrict__ i_gate,
                    float* __restrict__ ws, int S, int H, int chunk, int n_chunks) {
  using L = ScoreSmem<HD>;
  constexpr int DQ = L::DQ, ST = L::ST;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");  // the state kernel may start
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + L::Q;
  float* Ks = smem + L::K;
  float* PP = smem + L::PP;
  float* Fc = smem + L::FC;
  float* Ig = smem + L::IG;
  float* Wt = smem + L::WT;
  float* up = smem + L::UP;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, c4 = lane & 3;
  const int rank = (int)cluster.block_rank();
  const int ci = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int c0 = ci * chunk;
  const int valid = min(chunk, S - c0);  // real positions of this chunk
  const int dq0 = rank * DQ;
  const size_t row = (size_t)H * HD;
  const size_t base = ((size_t)b * S + c0) * row + (size_t)h * HD + dq0;
  float* rec = ws + ((size_t)bh * n_chunks + ci) * record(HD);

  load_tile<DQ, SCORE_THREADS>(Qs, ST, q + base, row, CM, valid);
  load_tile<DQ, SCORE_THREADS>(Ks, ST, k + base, row, CM, valid);
  cp_commit();
  if (w == 0) {  // inclusive scan of log f: lane l holds positions 2l, 2l+1
    const size_t gb = ((size_t)b * S + c0) * H + h;
    const int p0 = 2 * lane, p1 = 2 * lane + 1;
    const float a = p0 < valid ? log_f[gb + (size_t)p0 * H] : 0.f;
    const float a2 = p1 < valid ? log_f[gb + (size_t)p1 * H] : 0.f;
    Ig[p0] = p0 < valid ? i_gate[gb + (size_t)p0 * H] : 0.f;
    Ig[p1] = p1 < valid ? i_gate[gb + (size_t)p1 * H] : 0.f;
    float incl = a + a2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    Fc[p0] = excl + a;
    Fc[p1] = incl;
    const float ftot = __shfl_sync(0xffffffffu, incl, 31);  // padded positions add log f = 0
    Wt[p0] = Ig[p0] * expf(ftot - Fc[p0]);
    Wt[p1] = Ig[p1] * expf(ftot - Fc[p1]);
  }
  cp_wait<0>();
  __syncthreads();

  // partial q·kᵀ over this CTA's columns: warp w takes the causal tiles w, w + 8, w + 16 (< 20)
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    const int kt = w + 8 * n;
    if (kt >= CAUSAL_TILES) continue;
    const int i = tile_row(kt), j = tile_col(kt);
    const float* qa = Qs + (16 * i + g) * ST + c4;
    const float* kr = Ks + (8 * j + g) * ST + c4;
    float acc[4] = {};
#pragma unroll
    for (int kk = 0; kk < DQ; kk += 8) {
      const float af[4] = {qa[kk], qa[8 * ST + kk], qa[kk + 4], qa[8 * ST + kk + 4]};
      const float bf[2] = {kr[kk], kr[kk + 4]};
      uint32_t ah[4], al[4], bh2[2], bl2[2];
      split(af, ah, al);
      split(bf, bh2, bl2);
      mma3(acc, ah, al, bh2, bl2);
    }
    float* pp = PP + (16 * i + g) * (CM + 1) + 8 * j + 2 * c4;
    pp[0] = acc[0];
    pp[1] = acc[1];
    pp[8 * (CM + 1)] = acc[2];
    pp[8 * (CM + 1) + 1] = acc[3];
  }
  {  // u = Σ_t k_t W_t over this CTA's columns: NG groups of key rows, then their sum in order
    constexpr int NG = SCORE_THREADS / DQ;
    const int col = tid % DQ, grp = tid / DQ;
    float part = 0.f;
    for (int t = grp; t < CM; t += NG) part = fmaf(Ks[t * ST + col], Wt[t], part);
    up[grp * DQ + col] = part;
  }
  cluster.sync();  // every CTA's partial scores (and u's parts) are complete
  if (tid < DQ) {
    float u = up[tid];
#pragma unroll
    for (int i = 1; i < SCORE_THREADS / DQ; ++i) u += up[i * DQ + tid];
    rec[CM * PST + GATES + dq0 + tid] = u;
  }
  {
    // rows 16·rank + tid / 16, keys 4·(tid % 16) .. + 3: P = scores ⊙ D with
    // D[s,t] = e^(fcum_s − fcum_t) i_t for t <= s, else 0 (exp only where t <= s:
    // above the diagonal it can overflow)
    const int s = 16 * rank + tid / 16, t0 = 4 * (tid % 16);
    float sc[4] = {};
    for (int r = 0; r < SCORE_CL; ++r) {
      const float* pr = cluster.map_shared_rank(PP, r) + s * (CM + 1) + t0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (t0 + e <= s) sc[e] += pr[e];
    }
    const float fs = Fc[s];
    float p[4], rs = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + e;
      p[e] = t <= s ? sc[e] * (expf(fs - Fc[t]) * Ig[t]) : 0.f;
      rs += p[e];
    }
    *reinterpret_cast<float4*>(rec + s * PST + t0) = make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    if (tid % 16 == 0) {
      float* G = rec + CM * PST;
      G[s] = Fc[s];
      G[CM + s] = Wt[s];
      G[2 * CM + s] = rs;
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial scores
}

// ---- 2. state: y and C for 32 value columns, chunk after chunk ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Arrive on the barrier at the offset of `bar` in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}
// A box of a 4-D tensor map into shared memory: into this CTA only (mask 0)
// or to the same offset in every CTA of the cluster in `mask`, completing on
// each one's barrier at the offset of `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3, uint16_t mask) {
  if (mask)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3), "h"(mask)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}
// Contiguous bytes, likewise.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint16_t mask) {
  if (mask)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}
// The consumer warps only (warps 0 .. 7), apart from the producer warpgroup.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// Element (r, c) of a tile of rows of 32-float halves as TMA writes it with
// the 128-byte swizzle: each half is 64 rows × 128 bytes, and the 16-byte
// group of a row is XORed with the row's index mod 8. Fragment loads of a
// warp (8 rows × 4 columns, or 4 rows × 8 columns) then spread over the banks.
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 5) * (CM * 32) + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}
// Element (r, c) of C and of the partial sums of y (rows of 32 floats, our
// own stores): 8-float groups swizzled by row mod 4, so that fragment loads
// (4 rows × 8 columns) and float2 accumulator stores hit distinct banks.
__device__ __forceinline__ int swz(int r, int c) { return r * VT + (c ^ ((r & 3) << 3)); }

// Shared memory, in floats, from a 1024-byte aligned base (TMA's swizzle).
template <int HD>
struct StateSmem {
  static constexpr int KS = HD < KS_MAX ? HD : KS_MAX;  // key columns per slab
  static constexpr int NS = HD / KS;            // slabs of q (then of k) per chunk
  // stages of the ring: at most 2·NS + 1, so that a chunk's extras never
  // land in the buffer of the chunk two back while it is still being read
  static constexpr int NST0 = KS >= 128 ? 2 : 4;  // what fits beside C at hd 512
  static constexpr int NST = NST0 < 2 * NS + 1 ? NST0 : 2 * NS + 1;
  static constexpr int STAGE = CM * KS;         // one q or k slab, halves of 32 columns
  // per-chunk extras, double-buffered: the v tile (TMA), then P and the gates
  static constexpr int EX_PG = CM * VT;
  static constexpr int PG = record(HD);
  static constexpr int EX = (EX_PG + PG + 255) / 256 * 256;  // keeps each v tile aligned
  static constexpr int RING = 0;
  static constexpr int EXTRAS = RING + NST * STAGE;
  static constexpr int C = EXTRAS + 2 * EX;     // C[:, v0:v0+VT], HD × VT
  static constexpr int N = C + HD * VT;         // n, HD
  static constexpr int YR = N + HD;             // y partial sums: four 64 × 32 slots
  static constexpr int NRM = YR + 4 * CM * VT;  // the normaliser of each row
  static constexpr int BARS = NRM + CM;         // full[NST], empty[NST] (8 bytes each)
  static constexpr int TOTAL = BARS + 4 * NST;
  static constexpr int BYTES = TOTAL * 4 + 1024;  // + room to align the base
};

constexpr int PRODUCER_THREADS = 128;  // a whole warpgroup, so that setmaxnreg can move registers
template <int HD>
__global__ void __launch_bounds__(THREADS + PRODUCER_THREADS, 1)
mlstm_state_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const float* __restrict__ ws,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   float* __restrict__ y, float* __restrict__ C_out, float* __restrict__ n_out,
                   float* __restrict__ C_states, float* __restrict__ n_states,
                   float* __restrict__ nrm_out, int S, int H, int chunk, int n_chunks) {
  using L = StateSmem<HD>;
  constexpr int KS = L::KS, NS = L::NS, NST = L::NST;
  // Aligned by an offset from the shared array itself, so that the compiler
  // still sees shared memory (LDS, not generic loads).
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) / 4;
  float* Cs = smem + L::C;
  float* Ns = smem + L::N;
  float* Yr = smem + L::YR;
  float* Nrm = smem + L::NRM;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + NST;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, c4 = lane & 3;
  const int vt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int v0 = vt * VT;
  const size_t row = (size_t)H * HD;  // stride between positions of y
  const size_t head = (size_t)b * S * row + (size_t)h * HD;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank(), ncta = (int)cluster.num_blocks();
  const int n_items = n_chunks * 2 * NS;

  // Rows of a stage that no box covers (past S in a ragged last chunk) keep
  // an earlier slab's finite values, which meet a zero (e^fcum taken as 0,
  // W_t = 0, P = 0) wherever they enter a product; zeros before the first.
  for (int e = tid; e < L::C - L::RING; e += blockDim.x) smem[L::RING + e] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // zeros before the copies
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);                              // the producer's expect_tx
      mbar_init(&empty[s], (THREADS / 32) * ncta);         // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster.sync();  // every CTA's barriers are ready before any copy lands in it

  if (w >= THREADS / 32) {
    // ---- producer warpgroup (one thread works): q, then k, slabs of each
    // chunk through the ring; it gives up its registers to the consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // Rank r copies rows 64·r/ncta .. of each slab, and rank 0 the chunk's
    // P and gates, to every CTA of the cluster; each CTA copies its own v
    // tile. A box past S is zero-filled and still counts all its bytes.
    if (tid == THREADS) {
      asm volatile("griddepcontrol.wait;" ::: "memory");  // the scores kernel's workspace is written
      const uint16_t mask = ncta > 1 ? (uint16_t)((1u << ncta) - 1) : 0;
      const int rows = CM / ncta;
      for (int it = 0; it < n_items; ++it) {
        const int s = it % NST;
        if (it >= NST) mbar_wait(&empty[s], (it / NST + 1) & 1);
        const int ci = it / (2 * NS), part = (it / NS) & 1, sl = it % NS;
        const int c0 = ci * chunk;
        const bool first = it % (2 * NS) == 0;
        const int boxes = min(ncta, (S - c0 + rows - 1) / rows);  // ranks whose rows start before S
        mbar_expect_tx(&full[s], boxes * rows * KS * 4 + (first ? (CM * VT + L::PG) * 4 : 0));
        float* dst = smem + L::RING + s * L::STAGE + rows * rank * 32;
        if (rank < boxes)
          for (int half = 0; half < KS / 32; ++half)
            tma_load(dst + half * CM * 32, part ? &tk : &tq, &full[s], sl * KS + 32 * half, h,
                     c0 + rows * rank, b, mask);
        if (first) {
          float* ex = smem + L::EXTRAS + (ci & 1) * L::EX;
          tma_load(ex, &tv, &full[s], v0, h, c0, b, 0);
          if (rank == 0)
            bulk_load(ex + L::EX_PG, ws + ((size_t)bh * n_chunks + ci) * L::PG, L::PG * 4,
                      &full[s], mask);
        }
      }
    }
    cluster.sync();  // no CTA leaves while a peer may still signal its barriers
    return;
  }
  {
    // ---- consumer warps ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    for (int e = tid; e < HD * VT; e += THREADS)
      Cs[swz(e / VT, e % VT)] = C0 ? C0[((size_t)bh * HD + e / VT) * HD + v0 + e % VT] : 0.f;
    for (int d = tid; d < HD; d += THREADS) Ns[d] = n0 ? n0[(size_t)bh * HD + d] : 0.f;
    consumers_sync();

    auto wait = [&](int it) {
      mbar_wait(&full[it % NST], (it / NST) & 1);
      return smem + L::RING + (it % NST) * L::STAGE;
    };
    auto release = [&](int it) {  // this warp is done reading item it's stage
      __syncwarp();
      if (it + NST < n_items && lane < ncta) mbar_arrive_cluster(&empty[it % NST], lane);
    };

    // q·C: warp kq takes k-steps kq, kq + 8, ... of each slab for all 64
    // rows and 32 value columns (16 tiles), so each fragment it splits feeds
    // 4 tiles; the eight partial sums meet in Yr. e^fcum scales the rows of
    // the sum, not q.
    const int kq = w;
    // Warp w writes the 16 × 16 piece of y at rows 16·(w / 2), value
    // columns 16·(w % 2); it updates C at rows d0 + 16·(cm ..), columns 8·(cn ..).
    const int pm = w >> 1, pn = (w & 1) * 2;
    constexpr int NTW = KS >= 64 ? 2 : 1;    // n tiles of the update per warp
    constexpr int MTW = KS >= 128 ? KS / 64 : 1;  // m tiles of the update per warp
    const int cm = (w / (4 / NTW)) * MTW, cn = (w % (4 / NTW)) * NTW;

    // Offsets of this thread's fragment elements, fixed for the whole run.
    // q (A of y): k-step kq + 8m lies in the 32-column half kq / 4 + 2m; row
    // 16·i + g (+8), 16-byte group 2·(kq % 4) (+1 for columns c+4); row mod 8 is g.
    const int qa0 = (kq / 4) * CM * 32 + g * 32 + (((2 * (kq % 4)) ^ g) << 2) + c4;
    const int qa1 = (kq / 4) * CM * 32 + g * 32 + (((2 * (kq % 4) + 1) ^ g) << 2) + c4;
    // C (B of y): row d = d0 + 64m + 8·kq + c4 (+4), value column 8j + g.
    int cb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cb[j] = swz(8 * kq + c4, 8 * j + g);
    // k (A of the update): rows t = 8·kk + c4 (+4), columns 16·(cm + mi) + g (+8).
    int ka[MTW][4];
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi) {
      const int d = 16 * (cm + mi) + g;
      ka[mi][0] = sw128(c4, d);
      ka[mi][1] = sw128(c4, d + 8);
      ka[mi][2] = sw128(c4 + 4, d);
      ka[mi][3] = sw128(c4 + 4, d + 8);
    }
    // q·n: row tid / 4, 16-byte groups c4, c4 + 4, ... of each slab
    const int qnr = tid >> 2;

    int it = 0;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const float* ex = smem + L::EXTRAS + (ci & 1) * L::EX;
      const float* Vs = ex;
      const float* Ps = ex + L::EX_PG;
      const float* Fc = Ps + CM * PST;
      const float* Wt = Fc + CM;
      const float* Rs = Fc + 2 * CM;
      const float* U = Fc + GATES;
      const int c0 = ci * chunk, valid = min(chunk, S - c0);
      if (C_states) {  // the state entering this chunk, for the backward (C and n are
                       // complete: the last chunk's update ended in a barrier)
        float* cj = C_states + ((size_t)bh * n_chunks + ci) * HD * HD + v0;
        for (int e = tid; e < HD * VT; e += THREADS)
          cj[(size_t)(e / VT) * HD + e % VT] = Cs[swz(e / VT, e % VT)];
        if (vt == 0)
          for (int d = tid; d < HD; d += THREADS)
            n_states[((size_t)bh * n_chunks + ci) * HD + d] = Ns[d];
      }

      // q part: q[:, d0:d0+KS] · C[d0:d0+KS, vt], C as before the chunk. Rows
      // past the chunk's end hold zeros or the next chunk's positions: their
      // e^fcum is taken as 0.
      float acc[4][4][4] = {};  // m tile i, n tile j
      float qn[4] = {};
      for (int sl = 0; sl < NS; ++sl, ++it) {
        const float* st = wait(it);
        const int d0 = sl * KS;
#pragma unroll
        for (int m = 0; m < (KS / 8 + 7) / 8; ++m) {  // k-steps kq, kq + 8, ... of the slab
          if (kq + 8 * m >= KS / 8) continue;
          uint32_t ah[4][4], al[4][4], bh2[4][2], bl2[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* sq = st + 2 * m * CM * 32 + 16 * i * 32;
            const float af[4] = {sq[qa0], sq[qa0 + 8 * 32], sq[qa1], sq[qa1 + 8 * 32]};
            split(af, ah[i], al[i]);
          }
          const float* cs = Cs + (d0 + 64 * m) * VT;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bf[2] = {cs[cb[j]], cs[cb[j] + 4 * VT]};
            split(bf, bh2[j], bl2[j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma3(acc[i][j], ah[i], al[i], bh2[j], bl2[j]);
        }
        // q·n with n as before the chunk, 4 columns per 16-byte load
#pragma unroll
        for (int grp = c4; grp < KS / 4; grp += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(st + sw128(qnr, 4 * grp));
          const float4 nv = *reinterpret_cast<const float4*>(Ns + d0 + 4 * grp);
          qn[0] = fmaf(qv.x, nv.x, qn[0]);
          qn[1] = fmaf(qv.y, nv.y, qn[1]);
          qn[2] = fmaf(qv.z, nv.z, qn[2]);
          qn[3] = fmaf(qv.w, nv.w, qn[3]);
        }
        release(it);
      }
      // scaled by e^fcum of their rows (0 past the chunk's end), the eight
      // partial sums of y, each with its share of P·v, meet in two rounds
      // through four slots of Yr
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * i + g + 8 * half;
          const float e = r < valid ? expf(Fc[r]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j][2 * half] *= e;
            acc[i][j][2 * half + 1] *= e;
          }
        }
      {  // y += P · v[:, vt]: warp kq takes keys 8·kq .. 8·kq + 7 (on and left of the diagonal)
        uint32_t bh2[4][2], bl2[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bf[2] = {Vs[sw128(8 * kq + c4, 8 * j + g)],
                               Vs[sw128(8 * kq + c4 + 4, 8 * j + g)]};
          split(bf, bh2[j], bl2[j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < (kq >> 1)) continue;  // rows 16·i .. 16·i + 15 all precede these keys
          const float* pa = Ps + (16 * i + g) * PST + 8 * kq + c4;
          const float af[4] = {pa[0], pa[8 * PST], pa[4], pa[8 * PST + 4]};
          uint32_t ah[4], al[4];
          split(af, ah, al);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma3(acc[i][j], ah, al, bh2[j], bl2[j]);
        }
      }
      auto slot_io = [&](bool add) {
        float* slot = Yr + (kq % 4) * CM * VT;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float2* p =
                  reinterpret_cast<float2*>(slot + swz(16 * i + g + 8 * half, 8 * j + 2 * c4));
              float2 v = make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
              if (add) {
                const float2 o = *p;
                v.x += o.x;
                v.y += o.y;
              }
              *p = v;
            }
      };
      if (kq >= 4) slot_io(false);
      consumers_sync();
      if (kq < 4) slot_io(true);
      float qs = (qn[0] + qn[1]) + (qn[2] + qn[3]);
      qs += __shfl_xor_sync(0xffffffffu, qs, 1);
      qs += __shfl_xor_sync(0xffffffffu, qs, 2);
      if (c4 == 0) Nrm[qnr] = fmaf(expf(Fc[qnr]), qs, Rs[qnr]);
      const float gtot = expf(Fc[CM - 1]);
      for (int d = tid; d < HD; d += THREADS) Ns[d] = fmaf(gtot, Ns[d], U[d]);  // n ← e^ftot n + u
      // k part: C[d0:d0+KS, vt] ← e^ftot C + k[:, d0:d0+KS]ᵀ · (W ⊙ v[:, vt]);
      // W_t = 0 past the chunk's end, so those rows of k and v add nothing.
      uint32_t vwh[CM / 8][NTW][2], vwl[CM / 8][NTW][2];  // B fragments of W ⊙ v, split once
#pragma unroll
      for (int kk = 0; kk < CM / 8; ++kk)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * kk + c4 + 4 * e;
            split(Wt[t] * Vs[sw128(t, 8 * (cn + j) + g)], vwh[kk][j][e], vwl[kk][j][e]);
          }
      for (int sl = 0; sl < NS; ++sl, ++it) {
        const float* st = wait(it);
        const int d0 = sl * KS;
        // three independent chains per tile: lo·hi, hi·lo, hi·hi
        float um[MTW][NTW][4] = {}, ua[MTW][NTW][4] = {}, ub[MTW][NTW][4] = {};
#pragma unroll
        for (int kk = 0; kk < CM / 8; ++kk) {
          const float* sk = st + 8 * kk * 32;  // rows 8·kk .. of every half
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi) {
            const float af[4] = {sk[ka[mi][0]], sk[ka[mi][1]], sk[ka[mi][2]], sk[ka[mi][3]]};
            uint32_t ah[4], al[4];
            split(af, ah, al);
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
              mma(ua[mi][j], al, vwh[kk][j]);
              mma(ub[mi][j], ah, vwl[kk][j]);
              mma(um[mi][j], ah, vwh[kk][j]);
            }
          }
        }
        release(it);
#pragma unroll
        for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
          for (int j = 0; j < NTW; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float2* c = reinterpret_cast<float2*>(
                  Cs + swz(d0 + 16 * (cm + mi) + g + 8 * half, 8 * (cn + j) + 2 * c4));
              const float2 old = *c;
              const int e = 2 * half;
              const float* u = um[mi][j];
              *c = make_float2(fmaf(gtot, old.x, u[e] + (ua[mi][j][e] + ub[mi][j][e])),
                               fmaf(gtot, old.y, u[e + 1] + (ua[mi][j][e + 1] + ub[mi][j][e + 1])));
            }
      }
      consumers_sync();  // C, n, Yr and Nrm are complete
      // y = the sum of the four slots, over the normaliser. The next chunk
      // writes Yr and Nrm only after NS of its items, and no warp gets NST
      // items ahead of another (the ring), so with NS > NST no barrier is
      // needed after this.
      {
        float yacc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int o = swz(16 * pm + g + 8 * half, 8 * (pn + j) + 2 * c4);
            float2 s = *reinterpret_cast<const float2*>(Yr + o);
#pragma unroll
            for (int slot = 1; slot < 4; ++slot) {
              const float2 p = *reinterpret_cast<const float2*>(Yr + slot * CM * VT + o);
              s.x += p.x;
              s.y += p.y;
            }
            yacc[j][2 * half] = s.x;
            yacc[j][2 * half + 1] = s.y;
          }
#pragma unroll
        if (nrm_out && vt == 0 && tid < valid)
          nrm_out[((size_t)b * S + c0 + tid) * H + h] = Nrm[tid];
        for (int half = 0; half < 2; ++half) {
          const int s = 16 * pm + g + 8 * half;
          if (s < valid) {
            const float inv = 1.f / fmaxf(fabsf(Nrm[s]), 1.f);
            float* yr = y + head + (size_t)(c0 + s) * row + v0 + 2 * c4;
#pragma unroll
            for (int j = 0; j < 2; ++j)
              *reinterpret_cast<float2*>(yr + 8 * (pn + j)) =
                  make_float2(yacc[j][2 * half] * inv, yacc[j][2 * half + 1] * inv);
          }
        }
      }
      if (NS <= NST) consumers_sync();
    }

    for (int e = tid; e < HD * VT; e += THREADS)
      C_out[((size_t)bh * HD + e / VT) * HD + v0 + e % VT] = Cs[swz(e / VT, e % VT)];
    if (vt == 0)
      for (int d = tid; d < HD; d += THREADS) n_out[(size_t)bh * HD + d] = Ns[d];
  }
  cluster.sync();  // no CTA leaves while a peer may still signal its barriers
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (B, S, H, hd) fp32, contiguous, as a 4-D map (hd, H, S, B) whose box is
// 32 columns (128 bytes, swizzled) of one head over `rows` positions
bool make_map(CUtensorMap* map, const float* base, int B, int S, int H, int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 4, (cuuint64_t)H * hd * 4,
                                 (cuuint64_t)S * H * hd * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// CTAs of one cluster: the value tiles of one (b, h) that share each q and
// k slab (one copy from global memory, multicast to all of them).
constexpr int cluster_size_for(int hd) { return hd / VT < CLUSTER ? hd / VT : CLUSTER; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaLaunchConfig_t state_config(dim3 grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS + PRODUCER_THREADS);  // 8 consumer warps and the producer
  cfg.dynamicSmemBytes = StateSmem<HD>::BYTES;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size_for(HD);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int HD>
cudaError_t set_attributes() {
  static const cudaError_t err = [] {  // once per instantiation
    cudaError_t e = allow_smem(mlstm_scores_kernel<HD>, ScoreSmem<HD>::TOTAL * (int)sizeof(float));
    if (e == cudaSuccess) e = allow_smem(mlstm_state_kernel<HD>, StateSmem<HD>::BYTES);
    if (e == cudaSuccess && cluster_size_for(HD) > 8)
      e = cudaFuncSetAttribute(mlstm_state_kernel<HD>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* log_f,
                   const float* i_gate, const float* C0, const float* n0, float* y,
                   float* C_out, float* n_out, float* ws, float* C_states, float* n_states,
                   float* nrm, int B, int S, int H, int chunk, cudaStream_t stream) {
  static_assert(HD % 32 == 0 && (HD <= 64 || HD % 64 == 0), "slabs of 32 or 64 columns");
  static_assert((HD / VT) % cluster_size_for(HD) == 0, "whole clusters of value tiles");
  static_assert(CM / cluster_size_for(HD) % 8 == 0, "each box whole 1024-byte swizzle atoms");
  const int n_chunks = (S + chunk - 1) / chunk;
  CUtensorMap tq, tk, tv;
  const int rows = CM / cluster_size_for(HD);
  if (!make_map(&tq, q, B, S, H, HD, rows) || !make_map(&tk, k, B, S, H, HD, rows) ||
      !make_map(&tv, v, B, S, H, HD, CM))
    return cudaErrorInvalidValue;
  cudaError_t err = set_attributes<HD>();
  if (err != cudaSuccess) return err;
  const dim3 sgrid(SCORE_CL, n_chunks, B * H);
  mlstm_scores_kernel<HD><<<sgrid, SCORE_THREADS, ScoreSmem<HD>::TOTAL * sizeof(float), stream>>>(
      q, k, log_f, i_gate, ws, S, H, chunk, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = state_config<HD>(dim3(HD / VT, B * H), stream, attr);
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // starts under the scores' tail
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, mlstm_state_kernel<HD>, tq, tk, tv, (const float*)ws, C0, n0, y,
                           C_out, n_out, C_states, n_states, nrm, S, H, chunk, n_chunks);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// q, k, v, y (B,S,H,hd); log_f, i_gate (B,S,H); C0, C_out (B,H,hd,hd);
// n0, n_out (B,H,hd); all fp32 and contiguous. C0 and n0 may both be null
// (zero initial state). 1 <= chunk <= 64. workspace: fp32 scratch of
// B·H·ceil(S/chunk)·(64·68 + 3·64) floats, one record per (b, h, chunk): P
// in rows of 68, then fcum, W and the row sums (the scores kernel writes
// it, the state kernel reads it). C_states (B,H,ceil(S/chunk),hd,hd),
// n_states (B,H,ceil(S/chunk),hd) and nrm (B,S,H): all null, or all given,
// and then written with each chunk's entering state and each row's
// normaliser for the backward. Returns cudaGetLastError() after the launches.
extern "C" int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                               const void* log_f, const void* i_gate, const void* C0,
                               const void* n0, void* y, void* C_out, void* n_out,
                               void* workspace, void* C_states, void* n_states, void* nrm,
                               int B, int S, int H, int hd, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > CM ||
      (C0 == nullptr) != (n0 == nullptr) || workspace == nullptr ||
      (C_states == nullptr) != (n_states == nullptr) || (C_states == nullptr) != (nrm == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* ff = static_cast<const float*>(log_f);
  const auto* gf = static_cast<const float*>(i_gate);
  const auto* cf = static_cast<const float*>(C0);
  const auto* nf = static_cast<const float*>(n0);
  auto* yf = static_cast<float*>(y);
  auto* co = static_cast<float*>(C_out);
  auto* no = static_cast<float*>(n_out);
  auto* ws = static_cast<float*>(workspace);
  auto* cs = static_cast<float*>(C_states);
  auto* ns = static_cast<float*>(n_states);
  auto* nr = static_cast<float*>(nrm);
  switch (hd) {
    case 32: return launch<32>(qf, kf, vf, ff, gf, cf, nf, yf, co, no, ws, cs, ns, nr, B, S, H, chunk, st);
    case 64: return launch<64>(qf, kf, vf, ff, gf, cf, nf, yf, co, no, ws, cs, ns, nr, B, S, H, chunk, st);
    case 512: return launch<512>(qf, kf, vf, ff, gf, cf, nf, yf, co, no, ws, cs, ns, nr, B, S, H, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block, in bytes: kernel 0 the scores
// kernel, 1 the state kernel; -1 for a head dim without kernels.
extern "C" int mlstm_chunk_smem_bytes(int hd, int kernel) {
  const int f = (int)sizeof(float);
  switch (hd) {
    case 32: return kernel ? StateSmem<32>::BYTES : ScoreSmem<32>::TOTAL * f;
    case 64: return kernel ? StateSmem<64>::BYTES : ScoreSmem<64>::TOTAL * f;
    case 512: return kernel ? StateSmem<512>::BYTES : ScoreSmem<512>::TOTAL * f;
    default: return -1;
  }
}

// How many clusters of the state kernel the card holds at once, at its
// shared memory and cluster size as launched; a negative CUDA error code if
// the query fails.
extern "C" int mlstm_chunk_max_clusters(int hd) {
  auto query = [](auto kernel, cudaError_t attrs, cudaLaunchConfig_t cfg) {
    int n = 0;
    const cudaError_t e =
        attrs != cudaSuccess ? attrs : cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return e == cudaSuccess ? n : -(int)e;
  };
  cudaLaunchAttribute attr[1];
  switch (hd) {
    case 32: return query(mlstm_state_kernel<32>, set_attributes<32>(),
                          state_config<32>(dim3(cluster_size_for(32)), nullptr, attr));
    case 64: return query(mlstm_state_kernel<64>, set_attributes<64>(),
                          state_config<64>(dim3(cluster_size_for(64)), nullptr, attr));
    case 512: return query(mlstm_state_kernel<512>, set_attributes<512>(),
                           state_config<512>(dim3(cluster_size_for(512)), nullptr, attr));
    default: return -1;
  }
}
