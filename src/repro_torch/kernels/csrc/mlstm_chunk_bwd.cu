// Backward of the chunkwise mLSTM (csrc/mlstm_chunk.cu) for Hopper (sm_90a), fp32.
//
// The JAX package has no Pallas backward for src/repro/kernels/linear_attention.py
// mlstm_chunk (its training differentiates the jnp recurrence through XLA);
// this computes the gradient of the forward kernel's function, as
// kernels/ref.py mlstm_chunk_bwd_ref writes it out. Per chunk of c positions,
// with the forward's notation (fcum, ftot, a_s = e^fcum_s, D[s,t] =
// e^(fcum_s − fcum_t) i_t for t ≤ s, P = (q·kᵀ) ⊙ D, W_t = i_t e^(ftot − fcum_t),
// m_s = max(|nrm_s|, 1)), the entering state C_j, n_j and the gradients dC',
// dn' of the state after the chunk:
//   g_s = dy_s / m_s,  d nrm_s = −(dy_s·y_s)/m_s · sign(nrm_s) · [|nrm_s| ≥ 1]
//   dP = g·vᵀ + d nrm,  dS = dP ⊙ D
//   dq = a ⊙ (g·C_jᵀ + d nrm ⊗ n_j) + dS·k
//   dk = dSᵀ·q + W ⊙ (v·dC'ᵀ + dn'),   dv = Pᵀ·g + W ⊙ (k·dC')
//   dC_j = e^ftot dC' + (a ⊙ q)ᵀ·g,    dn_j = e^ftot dn' + (a ⊙ d nrm)ᵀ·q
// and the gate terms, which meet in d log f as a reverse cumulative sum
// within the chunk plus d ftot at every position.
//
// It reads what the forward kernel wrote when asked (mlstm_chunk_fwd's
// C_states, n_states, nrm): each chunk's entering state and each row's
// normaliser. Storing costs 1 MiB per (b, h, chunk) at hd 512; recomputing
// the states would take a second sequential pass over the chunks.
//
// What bounds it on the H100: per position about 8·hd² FLOPs (g·C_jᵀ, v·dC'ᵀ,
// k·dC' and the state gradient's (a ⊙ q)ᵀ·g) and 10·hd per causal pair of a
// chunk (q·kᵀ, g·vᵀ, dS·k, dSᵀ·q, Pᵀ·g), against 28·hd bytes of inputs and
// outputs per position plus the stored states: the operations bound it. Every
// product runs on the tensor cores at fp32 accuracy as 3xTF32, as the forward
// does (tf32.cuh: each operand split into a TF32 high part and the
// remainder, a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi on mma.sync.m16n8k8 with
// fp32 sums; one TF32 product alone misses the tolerance at hd 512), so the
// bound is a third of the TF32 rate, 165 TFLOP/s. Operands reach shared
// memory by cp.async, the next slab's (or chunk's) copies in flight under the
// current one's products, in padded rows on which the fragment loads of a
// warp meet 32 distinct banks (dq's row-wise loads of dS two ways).
// Splitting costs instructions beside every product, so each warp splits a
// fragment once and uses it for all the output tiles it holds (2 × 4 of them
// in the sweep and in the tiles kernel's hd-deep products). Those hd-deep
// sums are taken two k-steps at a time on the tensor core and added to their
// accumulators by fp32 adds (mma3_rn2): the tensor core truncates its sums,
// which over 64 k-steps into one accumulator cost several times the error.
//
// Five kernels, one call, in stream order; none uses atomics, and every sum
// is taken in a fixed order, so two calls on the same inputs agree to the bit:
// 1. rows: g and d nrm for every row (one warp per row);
// 2. scores, a cluster of CTAs per (chunk, b·h), each over a slice of the
//    key width: the partial q·kᵀ and g·vᵀ over the causal 16 × 8 tiles, added
//    in rank order through distributed shared memory; P and dS into a record
//    per (b, h, chunk) with fcum, W and d nrm, and the gate terms that come
//    from D (row and column sums of dP ⊙ P, and Σ_s dP ⊙ q·kᵀ ⊙ E);
// 3. sweep, per (128 × 64 tile of dC, b·h): the chunks in reverse, carrying
//    the tile in registers (dC ← e^ftot dC + (a ⊙ q)ᵀ·g) and, in the blocks of
//    the first column tile, dn in shared memory; writes each chunk's dC' and
//    dn' to a workspace; ends with dC_0 and dn_0;
// 4. tiles, per (64 columns, chunk, b·h): g·C_jᵀ and v·dC'ᵀ over slabs of the
//    value width, then k·dC' over slabs of the key width, through one ring of
//    three stages; then dS·k, dSᵀ·q and Pᵀ·g over the chunk's causal pairs;
//    dq, dk, dv of its columns and per-row partial sums of the gate terms
//    (q·(C_j g) and k·(dC' v + dn')) and of Σ C_j ⊙ dC';
// 5. gates, per (chunk, b·h): the partial sums added in column order, then
//    d i and the reverse cumulative sum that is d log f.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

using repro::cp_commit;
using repro::cp_wait;
using repro::load_tile;
using repro::mma3;
using repro::split;

constexpr int CM = 64;        // most positions in a chunk
constexpr int THREADS = 256;  // rows, scores and tiles kernels: 8 warps
// Record per (b, h, chunk), written by the scores kernel: P and dS (CM × CM,
// row-major), then fcum, W, d nrm, the d fcum terms from D and the d i terms
// from D.
constexpr int REC = 2 * CM * CM + 5 * CM;
constexpr int R_DS = CM * CM, R_FC = 2 * CM * CM, R_W = R_FC + CM, R_DN = R_W + CM,
              R_DF = R_DN + CM, R_DI = R_DF + CM;
// Partial sums per (b, h, chunk, column tile), written by the tiles kernel:
// q_s·(C g_s + d nrm_s n) and k_t·(dC' v_t + dn') over its columns, and its
// share of Σ C ⊙ dC' + n·dn'.
constexpr int PART = 2 * CM + 4;

__host__ __device__ constexpr int tile_width(int hd) { return hd < 64 ? hd : 64; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

// Offsets (in floats) of the workspace's parts; each a multiple of 4.
struct Workspace {
  size_t g, dnrm, dC, dn, rec, part, total;
  __host__ Workspace(int B, int S, int H, int hd, int chunk) {
    const size_t nc = (S + chunk - 1) / chunk, bh = (size_t)B * H;
    auto up4 = [](size_t x) { return (x + 3) / 4 * 4; };
    g = 0;
    dnrm = g + (size_t)B * S * H * hd;
    dC = dnrm + up4((size_t)B * S * H);
    dn = dC + bh * nc * hd * hd;
    rec = dn + bh * nc * hd;
    part = rec + bh * nc * REC;
    total = part + bh * nc * (hd / tile_width(hd)) * PART;
  }
};

// ---- 1. rows: g = dy / m and d nrm ----

template <int HD>
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_rows_kernel(const float* __restrict__ y, const float* __restrict__ dy,
                      const float* __restrict__ nrm, float* __restrict__ g,
                      float* __restrict__ dnrm, int rows) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float4* yr = reinterpret_cast<const float4*>(y + (size_t)r * HD);
  const float4* dr = reinterpret_cast<const float4*>(dy + (size_t)r * HD);
  float4* gr = reinterpret_cast<float4*>(g + (size_t)r * HD);
  const float nr = nrm[r];
  const float m = fmaxf(fabsf(nr), 1.f);
  float dot = 0.f;
  for (int d = lane; d < HD / 4; d += 32) {  // four columns at a time
    const float4 a = dr[d], b = yr[d];
    dot = fmaf(a.x, b.x, dot);
    dot = fmaf(a.y, b.y, dot);
    dot = fmaf(a.z, b.z, dot);
    dot = fmaf(a.w, b.w, dot);
    gr[d] = make_float4(a.x / m, a.y / m, a.z / m, a.w / m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0) {
    const float sign = nr > 0.f ? 1.f : (nr < 0.f ? -1.f : 0.f);
    dnrm[r] = fabsf(nr) >= 1.f ? -(dot / m) * sign : 0.f;
  }
}

// ---- 2. scores: P, dS, and the gate terms that come from D ----

// CTAs of a scores cluster, each over hd / CL key columns (at least 16: two
// k-steps of mma).
__host__ __device__ constexpr int score_cluster(int hd) { return hd >= 128 ? 8 : hd / 16; }

template <int HD>
struct ScoreSmem {
  static constexpr int CL = score_cluster(HD);
  static constexpr int DQ = HD / CL;   // key columns of this CTA
  static constexpr int ST = DQ + 4;    // row stride: conflict-free fragment loads
  static constexpr int RPC = CM / CL;  // rows (and columns) of the pair terms this CTA reduces
  // q and k slices (CM × ST each), then g and v in their place, then the
  // partial g·vᵀ (CM × (CM + 1)); the partial q·kᵀ beside them
  static constexpr int IN = max_of(2 * CM * ST, CM * (CM + 1));
  static constexpr int SC = IN;
  static constexpr int DPP = SC + CM * (CM + 1);  // dP ⊙ P of this CTA's rows, RPC × CM
  static constexpr int DI = DPP + RPC * CM;   // dP ⊙ (q·kᵀ) ⊙ E of its rows
  static constexpr int FC = DI + RPC * CM;
  static constexpr int IG = FC + CM;
  static constexpr int DN = IG + CM;
  static constexpr int RS = DN + CM;          // row sums of dP ⊙ P of its rows
  static constexpr int TOTAL = RS + RPC;
};

// CTA r of the cluster takes key columns r·hd/CL ..: it loads its slices of
// q and k, sums its part of q·kᵀ over the causal tiles, then does the same
// for g·vᵀ in the same buffer (56 KB a CTA: four CTAs an SM, every cluster
// of the train shape in one wave); then it adds the partial scores of rows
// RPC·r .. from every CTA in rank order, applies the decay mask, writes
// those rows of P and dS, and after a second exchange the column sums of
// columns RPC·r ...
template <int HD>
__global__ void __launch_bounds__(THREADS, 4)
mlstm_bwd_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ dnrm, const float* __restrict__ log_f,
                        const float* __restrict__ i_gate, float* __restrict__ rec_all, int S,
                        int H, int chunk, int n_chunks) {
  using L = ScoreSmem<HD>;
  constexpr int CL = L::CL, DQ = L::DQ, ST = L::ST, RPC = L::RPC;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float* As = smem;            // q, then g
  float* Bs = As + CM * ST;    // k, then v
  float* Sc = smem + L::SC;    // partial q·kᵀ, CM × (CM + 1)
  float* Gv = smem;            // partial g·vᵀ, after the products
  float* Dpp = smem + L::DPP;
  float* Dis = smem + L::DI;
  float* Fc = smem + L::FC;
  float* Ig = smem + L::IG;
  float* Dn = smem + L::DN;
  float* Rs = smem + L::RS;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g4 = lane >> 2, c4 = lane & 3;
  const int rank = (int)cluster.block_rank();
  const int ci = blockIdx.y, bh = blockIdx.z, b = bh / H, h = bh % H;
  const int c0 = ci * chunk, valid = min(chunk, S - c0);
  const size_t row = (size_t)H * HD;
  const size_t base = ((size_t)b * S + c0) * row + (size_t)h * HD + rank * DQ;
  float* rec = rec_all + ((size_t)bh * n_chunks + ci) * REC;

  load_tile<DQ, THREADS>(As, ST, q + base, row, CM, valid);
  load_tile<DQ, THREADS>(Bs, ST, k + base, row, CM, valid);
  cp_commit();
  if (w == 0) {  // inclusive scan of log f as in the forward: lane l holds positions 2l, 2l+1
    const size_t gb = ((size_t)b * S + c0) * H + h;
    const int p0 = 2 * lane, p1 = 2 * lane + 1;
    const float a0 = p0 < valid ? log_f[gb + (size_t)p0 * H] : 0.f;
    const float a1 = p1 < valid ? log_f[gb + (size_t)p1 * H] : 0.f;
    Ig[p0] = p0 < valid ? i_gate[gb + (size_t)p0 * H] : 0.f;
    Ig[p1] = p1 < valid ? i_gate[gb + (size_t)p1 * H] : 0.f;
    Dn[p0] = p0 < valid ? dnrm[gb + (size_t)p0 * H] : 0.f;
    Dn[p1] = p1 < valid ? dnrm[gb + (size_t)p1 * H] : 0.f;
    float incl = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    Fc[p0] = excl + a0;
    Fc[p1] = incl;
    const float ftot = __shfl_sync(0xffffffffu, incl, 31);
    if (rank == 0) {
      rec[R_FC + p0] = Fc[p0];
      rec[R_FC + p1] = Fc[p1];
      rec[R_W + p0] = Ig[p0] * expf(ftot - Fc[p0]);
      rec[R_W + p1] = Ig[p1] * expf(ftot - Fc[p1]);
      rec[R_DN + p0] = Dn[p0];
      rec[R_DN + p1] = Dn[p1];
    }
  }

  // Warp w takes the m tile i = w / 2 (rows 16·i ..) and the key tiles
  // j = w % 2, w % 2 + 2, .. on and left of the diagonal (j < 2·(i + 1)):
  // the A fragment it splits serves all of them.
  const int mi = w >> 1;
  float sc[4][4] = {}, gv[4][4] = {};
  auto products = [&](float (&acc)[4][4]) {
    const float* pa = As + (16 * mi + g4) * ST + c4;
#pragma unroll
    for (int kk = 0; kk < DQ; kk += 8) {
      const float af[4] = {pa[kk], pa[8 * ST + kk], pa[kk + 4], pa[8 * ST + kk + 4]};
      uint32_t ah[4], al[4];
      split(af, ah, al);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n > mi) continue;
        const float* pb = Bs + (8 * ((w & 1) + 2 * n) + g4) * ST + c4 + kk;
        const float bf[2] = {pb[0], pb[4]};
        uint32_t bh2[2], bl2[2];
        split(bf, bh2, bl2);
        mma3(acc[n], ah, al, bh2, bl2);
      }
    }
  };
  auto store = [&](float* dst, const float (&acc)[4][4]) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n > mi) continue;
      const int o = (16 * mi + g4) * (CM + 1) + 8 * ((w & 1) + 2 * n) + 2 * c4;
      dst[o] = acc[n][0];
      dst[o + 1] = acc[n][1];
      dst[o + 8 * (CM + 1)] = acc[n][2];
      dst[o + 8 * (CM + 1) + 1] = acc[n][3];
    }
  };
  cp_wait<0>();
  __syncthreads();  // q and k have landed
  products(sc);
  store(Sc, sc);
  __syncthreads();  // every warp is done with q and k: g and v take their place
  load_tile<DQ, THREADS>(As, ST, g + base, row, CM, valid);
  load_tile<DQ, THREADS>(Bs, ST, v + base, row, CM, valid);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  products(gv);
  __syncthreads();  // every warp is done with g and v: their partial sums take their place
  store(Gv, gv);
  cluster.sync();  // every CTA's partial scores are complete

  // rows s = RPC·rank + sl: P = S ⊙ D, dP = g·vᵀ + d nrm, dS = dP ⊙ D on
  // t ≤ s < valid (exp only there: above the diagonal it can overflow);
  // zeros elsewhere
  for (int e = tid; e < RPC * CM; e += THREADS) {
    const int sl = e / CM, s = RPC * rank + sl, t = e % CM;
    float scv = 0.f, gvv = 0.f;
    if (t <= s)
      for (int r = 0; r < CL; ++r) {
        scv += cluster.map_shared_rank(Sc, r)[s * (CM + 1) + t];
        gvv += cluster.map_shared_rank(Gv, r)[s * (CM + 1) + t];
      }
    float pp = 0.f, dd = 0.f, dpp = 0.f, di = 0.f;
    if (t <= s && s < valid) {
      const float ex = expf(Fc[s] - Fc[t]);
      const float dmat = ex * Ig[t];
      const float dp = gvv + Dn[s];
      pp = scv * dmat;
      dd = dp * dmat;
      dpp = dp * pp;
      di = dp * scv * ex;
    }
    rec[s * CM + t] = pp;
    rec[R_DS + s * CM + t] = dd;
    Dpp[sl * CM + t] = dpp;
    Dis[sl * CM + t] = di;
  }
  __syncthreads();
  if (tid < RPC) {
    float rs = 0.f;
    for (int t = 0; t < CM; ++t) rs += Dpp[tid * CM + t];
    Rs[tid] = rs;
  }
  cluster.sync();  // every CTA's pair terms are complete
  if (tid < RPC) {  // d fcum_s from D: Σ_t (dP⊙P)[s,t] − Σ_r (dP⊙P)[r,s]; d i_t: Σ_s dP⊙S⊙E
    const int t = RPC * rank + tid;
    float cs = 0.f, di = 0.f;
    for (int r = 0; r < CL; ++r) {  // rows in order: rank r holds rows RPC·r ..
      const float* dp = cluster.map_shared_rank(Dpp, r);
      const float* dr = cluster.map_shared_rank(Dis, r);
      for (int sl = 0; sl < RPC; ++sl) {
        cs += dp[sl * CM + t];
        di += dr[sl * CM + t];
      }
    }
    rec[R_DF + t] = Rs[tid] - cs;
    rec[R_DI + t] = di;
  }
  cluster.sync();  // no CTA leaves while a peer may still read its shared memory
}

// ---- 3. sweep: dC and dn over the chunks in reverse ----

template <int HD>
struct SweepSmem {
  static constexpr int TR = HD < 128 ? HD : 128;  // rows (key dims) of a block's dC tile
  static constexpr int TC = tile_width(HD);       // its columns (value dims)
  static constexpr int WARPS = TR * TC / 1024;    // each holds a 32 × 32 piece
  static constexpr int QS = TR + 8;  // row stride of q: A read down its columns, conflict-free
  static constexpr int GS = TC + 8;  // row stride of g
  static constexpr int GA = CM * QS + CM * GS;  // the record's fcum, W and d nrm
  static constexpr int AW = GA + 3 * CM;        // a_s = e^fcum_s (0 past the chunk's end)
  static constexpr int STAGE = AW + CM;         // one chunk's operands
  static constexpr int DN = 2 * STAGE;          // dn over the block's rows
  static constexpr int TOTAL = DN + TR;
};

// Block (tile, b·h) owns dC[r0 .. r0 + TR, v0 .. v0 + TC] in registers, warp
// w the 32 × 32 piece at rows 32·(w % (TR/32)), columns 32·(w / (TR/32)).
// Per chunk, last first, it writes the tile as that chunk's dC', then takes
// dC ← e^ftot dC + (a ⊙ q)ᵀ·g over the chunk's 64 positions, the next
// chunk's q and g in flight meanwhile.
template <int HD>
__global__ void __launch_bounds__(SweepSmem<HD>::WARPS * 32, 2)  // two blocks per SM
mlstm_bwd_sweep_kernel(const float* __restrict__ q, const float* __restrict__ g,
                       const float* __restrict__ rec_all, const float* __restrict__ dC_final,
                       const float* __restrict__ dn_final, float* __restrict__ dC_ws,
                       float* __restrict__ dn_ws, float* __restrict__ dC0,
                       float* __restrict__ dn0, int S, int H, int chunk, int n_chunks) {
  using L = SweepSmem<HD>;
  constexpr int TR = L::TR, TC = L::TC, QS = L::QS, GS = L::GS, NT = L::WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  float* Dn = smem + L::DN;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g4 = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int r0 = (blockIdx.x % (HD / TR)) * TR, v0 = (blockIdx.x / (HD / TR)) * TC;
  const bool has_dn = v0 == 0;  // the blocks of the first column tile carry dn
  const size_t row = (size_t)H * HD;
  const int wr = 32 * (w % (TR / 32)), wc = 32 * (w / (TR / 32));  // the warp's piece in the tile
  constexpr int P = NT / TR;  // threads per row of dn (1 or 2), each over CM / P positions
  static_assert(P * TR == NT && (P == 1 || P == 2), "one or two threads per row of dn");

  auto load = [&](int ci) {
    float* st = smem + (ci & 1) * L::STAGE;
    const int c0 = ci * chunk, valid = min(chunk, S - c0);
    const size_t base = ((size_t)b * S + c0) * row + (size_t)h * HD;
    load_tile<TR, NT>(st, QS, q + base + r0, row, CM, valid);
    load_tile<TC, NT>(st + CM * QS, GS, g + base + v0, row, CM, valid);
    load_tile<3 * CM, NT>(st + L::GA, 0, rec_all + ((size_t)bh * n_chunks + ci) * REC + R_FC, 0,
                          1, 1);
    cp_commit();
  };
  load(n_chunks - 1);

  // acc[mi][nj]: rows r0 + wr + 16·mi + g4 (+8), columns v0 + wc + 8·nj + 2·c4 (+1)
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2 x = make_float2(0.f, 0.f);
        if (dC_final)
          x = *reinterpret_cast<const float2*>(
              dC_final + ((size_t)bh * HD + r0 + wr + 16 * mi + g4 + 8 * half) * HD + v0 + wc +
              8 * nj + 2 * c4);
        acc[mi][nj][2 * half] = x.x;
        acc[mi][nj][2 * half + 1] = x.y;
      }
  if (has_dn)
    for (int d = tid; d < TR; d += NT) Dn[d] = dn_final ? dn_final[(size_t)bh * HD + r0 + d] : 0.f;

  auto store_tile = [&](float* dst) {  // the tile as it stands into dst (an hd × hd matrix)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(dst + (size_t)(r0 + wr + 16 * mi + g4 + 8 * half) * HD + v0 +
                                     wc + 8 * nj + 2 * c4) =
              make_float2(acc[mi][nj][2 * half], acc[mi][nj][2 * half + 1]);
  };

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int c0 = ci * chunk, valid = min(chunk, S - c0);
    const size_t st_idx = (size_t)bh * n_chunks + ci;
    // dC' and dn' of this chunk (the gradient of the state after it). The
    // threads that store Dn here are not those that update it below (when
    // P == 2); the two barriers between (after the copies land, after As is
    // written) order the store before the update, and the barrier that ends
    // the chunk orders the update before the next chunk's store.
    store_tile(dC_ws + st_idx * HD * HD);
    if (has_dn)
      for (int d = tid; d < TR; d += NT) dn_ws[st_idx * HD + r0 + d] = Dn[d];
    if (ci > 0) {  // the next chunk's copies run under this one's products
      load(ci - 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this chunk's operands have landed
    float* Qt = smem + (ci & 1) * L::STAGE;
    const float* Gt = Qt + CM * QS;
    const float* Fc = Qt + L::GA;
    const float* Dr = Fc + 2 * CM;
    float* As = Qt + L::AW;
    for (int s = tid; s < CM; s += NT) As[s] = s < valid ? expf(Fc[s]) : 0.f;
    __syncthreads();
    const float decay = expf(Fc[CM - 1]);  // ftot: padded positions add log f = 0
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] *= decay;
    // (a ⊙ q)ᵀ·g: A[d][s] = a_s q[s][d] (rows past the chunk: a_s = 0 and q = 0), B = g
#pragma unroll 2
    for (int kk = 0; kk < CM / 8; ++kk) {
      const int s0 = 8 * kk + c4, s1 = s0 + 4;
      const float a0 = As[s0], a1 = As[s1];
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = wr + 16 * mi + g4;
        const float af[4] = {a0 * Qt[s0 * QS + m], a0 * Qt[s0 * QS + m + 8], a1 * Qt[s1 * QS + m],
                             a1 * Qt[s1 * QS + m + 8]};
        split(af, ah[mi], al[mi]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = wc + 8 * nj + g4;
        const float bf[2] = {Gt[s0 * GS + n], Gt[s1 * GS + n]};
        uint32_t bh2[2], bl2[2];
        split(bf, bh2, bl2);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][nj], ah[mi], al[mi], bh2, bl2);
      }
    }
    if (has_dn) {  // dn ← e^ftot dn' + (a ⊙ d nrm)ᵀ·q over the block's rows, in order
      const int d = tid / P, part = tid % P;
      float sum = part == 0 ? Dn[d] * decay : 0.f;
#pragma unroll 8
      for (int s = part * (CM / P); s < (part + 1) * (CM / P); ++s)
        sum = fmaf(As[s] * Qt[s * QS + d], Dr[s], sum);
      if (P == 2) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (part == 0) Dn[d] = sum;
    }
    __syncthreads();  // this stage is read before the copies of two chunks back land in it
  }
  if (dC0) {
    store_tile(dC0 + (size_t)bh * HD * HD);
    if (has_dn)
      for (int d = tid; d < TR; d += NT) dn0[(size_t)bh * HD + r0 + d] = Dn[d];
  }
}

// ---- 4. tiles: dq, dk, dv of 64 columns and partial gate sums ----

// The split A fragments of two consecutive k-steps of one m16n8k8 tile:
// element (r, c) of k-step j at p[r·row + c + j·step], rows g, g + 8 and
// columns c, c + 4 (tf32.cuh's fragment layout).
struct Frag2 {
  uint32_t hi[2][4], lo[2][4];
  __device__ __forceinline__ void load_a(const float* p, int row8, int step) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* q = p + j * step;
      const float x[4] = {q[0], q[row8], q[4], q[row8 + 4]};
      split(x, hi[j], lo[j]);
    }
  }
};
// The same for B: elements k = c, c + 4 at p[0], p[k4] of k-step j at p + j·step.
struct Frag2B {
  uint32_t hi[2][2], lo[2][2];
  __device__ __forceinline__ void load(const float* p, int k4, int step) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float x[2] = {p[j * step], p[j * step + k4]};
      split(x, hi[j], lo[j]);
    }
  }
};
// d += a·b over two k-steps at fp32 accuracy: the six products summed on the
// tensor core from zero, then added to d by fp32 adds, rounded to nearest.
// The tensor core does not round its sums to nearest (it truncates), and
// over the hd-deep sums of this kernel, taken into one accumulator, that
// bias builds up: on the H100, mma3 into d reached err/tol 0.67 on dv at the
// train shape with final-state gradients, this 0.10, for two adds per three
// products.
__device__ __forceinline__ void mma3_rn2(float (&d)[4], const Frag2& a, const Frag2B& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) mma3(t, a.hi[j], a.lo[j], b.hi[j], b.lo[j]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

template <int HD>
struct TileSmem {
  static constexpr int TW = tile_width(HD);
  static constexpr int AS = 32 + 4;   // row stride of 32-wide slabs (fragments read along rows)
  static constexpr int BS = TW + 8;   // row stride of TW-wide tiles read down their columns
  static constexpr int PS = CM + 8;   // row stride of P and dS
  static constexpr int NST = 3;       // stages of the ring
  // phase 1 stage: g, v (CM × 32), rows col0 .. of C_j and dC' (TW × 32);
  // phase 2 stage: k (CM × 32), rows of dC' (32 × TW)
  static constexpr int STAGE = max_of(2 * CM * AS + 2 * TW * AS, CM * AS + 32 * BS);
  // after the ring, in its place: q, k, g columns (CM × BS each), P and dS (CM × PS)
  static constexpr int MAIN = max_of(NST * STAGE, 3 * CM * BS + 2 * CM * PS);
  static constexpr int A = MAIN;     // a_s = e^fcum_s (0 past the chunk's end)
  static constexpr int W = A + CM;   // W_t
  static constexpr int DR = W + CM;  // d nrm_s
  static constexpr int NJ = DR + CM;      // n_j over this tile's columns
  static constexpr int DNP = NJ + TW;     // dn' over this tile's columns
  static constexpr int RED = DNP + TW;    // THREADS partial sums of Σ C ⊙ dC'
  static constexpr int ROWS = RED + THREADS;  // per-row gate sums of each column half, 4 × CM
  static constexpr int TOTAL = ROWS + 4 * CM;
};

// Warps 0-3 take g·C_jᵀ and then dq, warps 4-7 v·dC'ᵀ and then dk: warp w
// the 32 × TW/2 piece at rows 32·(w % 2), columns TW/2·(w / 2 % 2). All eight
// take k·dC' and then dv: the 32 × TW/4 piece at rows 32·(w % 2), columns
// TW/4·(w / 2). A warp's accumulators of a product go on as those of its
// output, and each fragment it splits serves 2 × 4 (or 2 × 2) tiles.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks per SM: 128 registers a thread
mlstm_bwd_tiles_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ C_states, const float* __restrict__ n_states,
                       const float* __restrict__ dC_ws, const float* __restrict__ dn_ws,
                       const float* __restrict__ rec_all, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ part_all, int S, int H, int chunk, int n_chunks) {
  using L = TileSmem<HD>;
  constexpr int TW = L::TW, AS = L::AS, BS = L::BS, PS = L::PS, NST = L::NST, NT = HD / TW;
  constexpr int N1 = TW / 16, N2 = TW / 32;   // n tiles of a warp's pieces
  constexpr int NI1 = HD / 32, NI = 2 * NI1;  // slabs of phase 1, of both phases
  extern __shared__ __align__(16) float smem[];
  float* A = smem + L::A;
  float* Wt = smem + L::W;
  float* Dr = smem + L::DR;
  float* nj = smem + L::NJ;
  float* dnp = smem + L::DNP;
  float* red = smem + L::RED;
  float* rows = smem + L::ROWS;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g4 = lane >> 2, c4 = lane & 3;
  const int ct = blockIdx.x, ci = blockIdx.y, bh = blockIdx.z, b = bh / H, h = bh % H;
  const int col0 = ct * TW;
  const int c0 = ci * chunk, valid = min(chunk, S - c0);
  const size_t row = (size_t)H * HD;
  const size_t base = ((size_t)b * S + c0) * row + (size_t)h * HD;
  const size_t st = (size_t)bh * n_chunks + ci;
  const float* Cj = C_states + st * HD * HD;
  const float* dCp = dC_ws + st * HD * HD;
  const float* rec = rec_all + st * REC;
  const int role = w >> 2;                   // 0: g·C_jᵀ and dq; 1: v·dC'ᵀ and dk
  const int r1 = 32 * (w & 1);               // first row of the warp's pieces
  const int c1 = (TW / 2) * ((w >> 1) & 1);  // first column of its piece of g·C_jᵀ or v·dC'ᵀ
  const int c2 = (TW / 4) * (w >> 1);        // first column of its piece of k·dC'

  auto load_item = [&](int it) {
    float* sp = smem + (it % NST) * L::STAGE;
    if (it < NI1) {  // phase 1: value columns c .. c + 31
      const int c = it * 32;
      load_tile<32, THREADS>(sp, AS, g + base + c, row, CM, valid);
      load_tile<32, THREADS>(sp + CM * AS, AS, v + base + c, row, CM, valid);
      load_tile<32, THREADS>(sp + 2 * CM * AS, AS, Cj + (size_t)col0 * HD + c, HD, TW, TW);
      load_tile<32, THREADS>(sp + 2 * CM * AS + TW * AS, AS, dCp + (size_t)col0 * HD + c, HD, TW,
                             TW);
    } else {  // phase 2: key rows c .. c + 31
      const int c = (it - NI1) * 32;
      load_tile<32, THREADS>(sp, AS, k + base + c, row, CM, valid);
      load_tile<TW, THREADS>(sp + CM * AS, BS, dCp + (size_t)c * HD + col0, HD, 32, 32);
    }
    cp_commit();
  };
  for (int it = 0; it < NST - 1; ++it) load_item(it);

  if (tid < CM) {
    const bool ok = tid < valid;
    A[tid] = ok ? expf(rec[R_FC + tid]) : 0.f;
    Wt[tid] = rec[R_W + tid];
    Dr[tid] = rec[R_DN + tid];
  }
  for (int c = tid; c < TW; c += THREADS) {
    nj[c] = n_states[st * HD + col0 + c];
    dnp[c] = dn_ws[st * HD + col0 + c];
  }

  // prod[i][n]: g·C_j[cols, :]ᵀ (role 0) or v·dC'[cols, :]ᵀ (role 1) at rows
  // r1 + 16·i + g4 (+8), columns c1 + 8·n + 2·c4 (+1); kd[i][n]: k·dC'[:, cols]
  // at rows r1 + 16·i + g4 (+8), columns c2 + 8·n + 2·c4 (+1)
  float prod[2][N1][4] = {}, kd[2][N2][4] = {};
  float tot = 0.f;  // this thread's share of Σ C_j ⊙ dC' over the tile's rows
  for (int it = 0; it < NI; ++it) {
    cp_wait<NST - 2>();
    __syncthreads();  // item it has landed; every warp is done with item it - 1
    if (it + NST - 1 < NI) load_item(it + NST - 1);
    else cp_commit();  // an empty group keeps the count of the wait above
    const float* sp = smem + (it % NST) * L::STAGE;
    if (it < NI1) {
      const float* As = sp + role * CM * AS;                 // g or v
      const float* Bs = sp + 2 * CM * AS + role * TW * AS;   // rows of C_j or of dC'
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {  // k-steps 2·kp, 2·kp + 1
        Frag2 a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a[i].load_a(As + (r1 + 16 * i + g4) * AS + 16 * kp + c4, 8 * AS, 8);
#pragma unroll
        for (int n = 0; n < N1; ++n) {
          Frag2B bf;
          bf.load(Bs + (c1 + 8 * n + g4) * AS + 16 * kp + c4, 4, 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma3_rn2(prod[i][n], a[i], bf);
        }
      }
      const float* Ct = sp + 2 * CM * AS;
      const float* Dt = Ct + TW * AS;
      for (int e = tid; e < TW * 8; e += THREADS) {  // four columns at a time
        const int o = (e >> 3) * AS + 4 * (e & 7);
        const float4 x = *reinterpret_cast<const float4*>(Ct + o);
        const float4 y = *reinterpret_cast<const float4*>(Dt + o);
        tot = fmaf(x.x, y.x, tot);
        tot = fmaf(x.y, y.y, tot);
        tot = fmaf(x.z, y.z, tot);
        tot = fmaf(x.w, y.w, tot);
      }
    } else {
      const float* Kt = sp;
      const float* Dc = Kt + CM * AS;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        Frag2 a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a[i].load_a(Kt + (r1 + 16 * i + g4) * AS + 16 * kp + c4, 8 * AS, 8);
#pragma unroll
        for (int n = 0; n < N2; ++n) {
          Frag2B bf;
          bf.load(Dc + (16 * kp + c4) * BS + c2 + 8 * n + g4, 4 * BS, 8 * BS);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma3_rn2(kd[i][n], a[i], bf);
        }
      }
    }
  }
  red[tid] = tot;
  cp_wait<0>();
  __syncthreads();  // the ring is read: the chunk's columns and P, dS take its place

  float* Qc = smem;
  float* Kc = Qc + CM * BS;
  float* Gc = Kc + CM * BS;
  float* Ps = Gc + CM * BS;
  float* Ds = Ps + CM * PS;
  load_tile<TW, THREADS>(Qc, BS, q + base + col0, row, CM, valid);
  load_tile<TW, THREADS>(Kc, BS, k + base + col0, row, CM, valid);
  load_tile<TW, THREADS>(Gc, BS, g + base + col0, row, CM, valid);
  load_tile<CM, THREADS>(Ps, PS, rec, CM, CM, CM);
  load_tile<CM, THREADS>(Ds, PS, rec + R_DS, CM, CM, CM);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // the state terms: dq = a ⊙ (g·C_jᵀ + d nrm ⊗ n_j) with the row sums of
  // q·(g·C_jᵀ + d nrm ⊗ n_j) (role 0); dk = W ⊙ (v·dC'ᵀ + dn') with those of
  // k·(v·dC'ᵀ + dn') (role 1); dv = W ⊙ k·dC'
  float rsum[2][2] = {};  // [i][half]: row r1 + 16·i + g4 + 8·half, over the warp's columns
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < N1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = r1 + 16 * i + g4 + 8 * (e >> 1), c = c1 + 8 * n + 2 * c4 + (e & 1);
        if (role == 0) {
          const float x = prod[i][n][e] + Dr[s] * nj[c];
          rsum[i][e >> 1] = fmaf(Qc[s * BS + c], x, rsum[i][e >> 1]);
          prod[i][n][e] = A[s] * x;
        } else {
          const float x = prod[i][n][e] + dnp[c];
          rsum[i][e >> 1] = fmaf(Kc[s * BS + c], x, rsum[i][e >> 1]);
          prod[i][n][e] = Wt[s] * x;
        }
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < N2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) kd[i][n][e] *= Wt[r1 + 16 * i + g4 + 8 * (e >> 1)];

  // the chunk's pairs (sums of at most 64 terms): dq += dS·k over keys t ≤ s
  // (role 0), dk += dSᵀ·q over t ≥ s (role 1), dv += Pᵀ·g over t ≥ s
#pragma unroll
  for (int kk = 0; kk < CM / 8; ++kk) {
    const int t = 8 * kk + c4;
    bool need[2], upper[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = r1 / 16 + i;  // the m tile: rows 16·mt .. 16·mt + 15
      upper[i] = kk >= 2 * mt;
      need[i] = role == 0 ? kk <= 2 * mt + 1 : upper[i];
    }
    if (need[0] || need[1]) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = r1 + 16 * i + g4;
        const int o = role == 0 ? s * PS + t : t * PS + s;  // dS[s][t], or dS[t][s]
        const int o8 = role == 0 ? 8 * PS : 8, o4 = role == 0 ? 4 : 4 * PS;
        const float af[4] = {Ds[o], Ds[o + o8], Ds[o + o4], Ds[o + o8 + o4]};
        split(af, ah[i], al[i]);
      }
      const float* Bc = role == 0 ? Kc : Qc;
#pragma unroll
      for (int n = 0; n < N1; ++n) {
        const float* pb = Bc + t * BS + c1 + 8 * n + g4;
        const float bf[2] = {pb[0], pb[4 * BS]};
        uint32_t bh2[2], bl2[2];
        split(bf, bh2, bl2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (need[i]) mma3(prod[i][n], ah[i], al[i], bh2, bl2);
      }
    }
    if (upper[0] || upper[1]) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = t * PS + r1 + 16 * i + g4;  // P[t][s]
        const float af[4] = {Ps[o], Ps[o + 8], Ps[o + 4 * PS], Ps[o + 4 * PS + 8]};
        split(af, ah[i], al[i]);
      }
#pragma unroll
      for (int n = 0; n < N2; ++n) {
        const float* pb = Gc + t * BS + c2 + 8 * n + g4;
        const float bf[2] = {pb[0], pb[4 * BS]};
        uint32_t bh2[2], bl2[2];
        split(bf, bh2, bl2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (upper[i]) mma3(kd[i][n], ah[i], al[i], bh2, bl2);
      }
    }
  }

  float* out = role == 0 ? dq : dk;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = r1 + 16 * i + g4 + 8 * half;
      if (s < valid) {
        const size_t o = base + (size_t)s * row + col0 + 2 * c4;
#pragma unroll
        for (int n = 0; n < N1; ++n)
          *reinterpret_cast<float2*>(out + o + c1 + 8 * n) =
              make_float2(prod[i][n][2 * half], prod[i][n][2 * half + 1]);
#pragma unroll
        for (int n = 0; n < N2; ++n)
          *reinterpret_cast<float2*>(dv + o + c2 + 8 * n) =
              make_float2(kd[i][n][2 * half], kd[i][n][2 * half + 1]);
      }
      // the four lanes of a row in order; the two column halves meet below
      float a = rsum[i][half];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (c4 == 0) rows[(2 * role + ((w >> 1) & 1)) * CM + s] = a;
    }
  __syncthreads();
  float* part = part_all + (st * NT + ct) * PART;
  if (tid < CM) {
    part[tid] = rows[tid] + rows[CM + tid];
    part[CM + tid] = rows[2 * CM + tid] + rows[3 * CM + tid];
  }
  if (tid == 0) {  // Σ C ⊙ dC' in thread order, and n·dn' over the tile
    float t = 0.f;
    for (int r = 0; r < THREADS; ++r) t += red[r];
    for (int c = 0; c < TW; ++c) t = fmaf(nj[c], dnp[c], t);
    part[2 * CM] = t;
  }
}

// ---- 5. gates: d i and d log f ----

template <int HD>
__global__ void __launch_bounds__(CM)
mlstm_bwd_gates_kernel(const float* __restrict__ rec_all, const float* __restrict__ part_all,
                       float* __restrict__ dlog_f, float* __restrict__ di, int S, int H,
                       int chunk, int n_chunks) {
  constexpr int NT = HD / tile_width(HD);
  __shared__ float dfc[CM], dww[CM];
  __shared__ float dftot;
  const int t = threadIdx.x;
  const int ci = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = ci * chunk, valid = min(chunk, S - c0);
  const size_t st = (size_t)bh * n_chunks + ci;
  const float* rec = rec_all + st * REC;
  const float* part = part_all + st * NT * PART;
  float da = 0.f, dw = 0.f;
  for (int c = 0; c < NT; ++c) {
    da += part[c * PART + t];
    dw += part[c * PART + CM + t];
  }
  const float fc = rec[R_FC + t], ftot = rec[R_FC + CM - 1], w = rec[R_W + t];
  const bool ok = t < valid;
  const float a = ok ? expf(fc) : 0.f;
  dfc[t] = ok ? fmaf(a, da, rec[R_DF + t]) - dw * w : 0.f;
  dww[t] = dw * w;
  if (ok) di[((size_t)b * S + c0 + t) * H + h] = fmaf(dw, expf(ftot - fc), rec[R_DI + t]);
  __syncthreads();
  if (t == 0) {
    float tot = 0.f;
    for (int c = 0; c < NT; ++c) tot += part[c * PART + 2 * CM];
    float sw = 0.f;
    for (int r = 0; r < CM; ++r) sw += dww[r];
    dftot = fmaf(expf(ftot), tot, sw);
    float run = 0.f;  // d log f_u = Σ_{s ≥ u} d fcum_s + d ftot
    for (int u = CM - 1; u >= 0; --u) {
      run += dfc[u];
      dfc[u] = run;
    }
  }
  __syncthreads();
  if (ok) dlog_f[((size_t)b * S + c0 + t) * H + h] = dfc[t] + dftot;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

template <int HD>
cudaError_t set_attributes() {
  static const cudaError_t err = [] {  // once per instantiation
    cudaError_t e = allow_smem(mlstm_bwd_scores_kernel<HD>, ScoreSmem<HD>::TOTAL);
    if (e == cudaSuccess) e = allow_smem(mlstm_bwd_sweep_kernel<HD>, SweepSmem<HD>::TOTAL);
    if (e == cudaSuccess) e = allow_smem(mlstm_bwd_tiles_kernel<HD>, TileSmem<HD>::TOTAL);
    return e;
  }();
  return err;
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* log_f,
                   const float* i_gate, const float* y, const float* dy, const float* C_states,
                   const float* n_states, const float* nrm, const float* dC_final,
                   const float* dn_final, float* dq, float* dk, float* dv, float* dlog_f,
                   float* di, float* dC0, float* dn0, float* ws, int B, int S, int H,
                   int chunk, cudaStream_t stream) {
  using SW = SweepSmem<HD>;
  static_assert(HD % 32 == 0 && HD % SW::TR == 0 && HD % SW::TC == 0, "whole tiles");
  const int n_chunks = (S + chunk - 1) / chunk;
  const Workspace o(B, S, H, HD, chunk);
  float *g = ws + o.g, *dnrm = ws + o.dnrm, *dCw = ws + o.dC, *dnw = ws + o.dn,
        *rec = ws + o.rec, *part = ws + o.part;
  cudaError_t err = set_attributes<HD>();
  if (err != cudaSuccess) return err;
  const int rows = B * S * H;
  mlstm_bwd_rows_kernel<HD><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(
      y, dy, nrm, g, dnrm, rows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ScoreSmem<HD>::CL, n_chunks, B * H);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = ScoreSmem<HD>::TOTAL * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ScoreSmem<HD>::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlstm_bwd_scores_kernel<HD>, q, k, v, (const float*)g,
                           (const float*)dnrm, log_f, i_gate, rec, S, H, chunk, n_chunks);
  if (err != cudaSuccess) return err;
  mlstm_bwd_sweep_kernel<HD><<<dim3((HD / SW::TR) * (HD / SW::TC), B * H), SW::WARPS * 32,
                               SW::TOTAL * sizeof(float), stream>>>(
      q, g, rec, dC_final, dn_final, dCw, dnw, dC0, dn0, S, H, chunk, n_chunks);
  mlstm_bwd_tiles_kernel<HD><<<dim3(HD / tile_width(HD), n_chunks, B * H), THREADS,
                               TileSmem<HD>::TOTAL * sizeof(float), stream>>>(
      q, k, v, g, C_states, n_states, dCw, dnw, rec, dq, dk, dv, part, S, H, chunk, n_chunks);
  mlstm_bwd_gates_kernel<HD><<<dim3(n_chunks, B * H), CM, 0, stream>>>(
      rec, part, dlog_f, di, S, H, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// Floats of fp32 scratch the backward needs at this shape (-1 if hd is not taken).
extern "C" long long mlstm_chunk_bwd_workspace_floats(int B, int S, int H, int hd, int chunk) {
  if (hd != 32 && hd != 64 && hd != 512) return -1;
  return (long long)Workspace(B, S, H, hd, chunk).total;
}

// q, k, v, y, dy, dq, dk, dv (B,S,H,hd); log_f, i_gate, nrm, dlog_f, di
// (B,S,H); C_states (B,H,ceil(S/chunk),hd,hd) and n_states (…,hd) as the
// forward wrote them; dC_final, dC0 (B,H,hd,hd) and dn_final, dn0 (B,H,hd)
// may be null (a null final gradient counts as zeros; a null dC0 and dn0
// are not written); all fp32 and contiguous. workspace:
// mlstm_chunk_bwd_workspace_floats(...) floats. Returns cudaGetLastError()
// after the launches.
extern "C" int mlstm_chunk_bwd(const void* q, const void* k, const void* v, const void* log_f,
                               const void* i_gate, const void* y, const void* dy,
                               const void* C_states, const void* n_states, const void* nrm,
                               const void* dC_final, const void* dn_final, void* dq, void* dk,
                               void* dv, void* dlog_f, void* di, void* dC0, void* dn0,
                               void* workspace, int B, int S, int H, int hd, int chunk,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > CM || workspace == nullptr ||
      C_states == nullptr || n_states == nullptr || nrm == nullptr ||
      (dC_final == nullptr) != (dn_final == nullptr) || (dC0 == nullptr) != (dn0 == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  auto* ws = m(workspace);
#define MLSTM_BWD(HD)                                                                        \
  launch<HD>(c(q), c(k), c(v), c(log_f), c(i_gate), c(y), c(dy), c(C_states), c(n_states),  \
             c(nrm), c(dC_final), c(dn_final), m(dq), m(dk), m(dv), m(dlog_f), m(di), m(dC0), \
             m(dn0), ws, B, S, H, chunk, st)
  switch (hd) {
    case 32: return MLSTM_BWD(32);
    case 64: return MLSTM_BWD(64);
    case 512: return MLSTM_BWD(512);
    default: return cudaErrorInvalidValue;
  }
#undef MLSTM_BWD
}

// Dynamic shared memory of the tiles kernel at this head dim, in bytes (-1 if not taken).
extern "C" int mlstm_chunk_bwd_smem_bytes(int hd) {
  switch (hd) {
    case 32: return TileSmem<32>::TOTAL * (int)sizeof(float);
    case 64: return TileSmem<64>::TOTAL * (int)sizeof(float);
    case 512: return TileSmem<512>::TOTAL * (int)sizeof(float);
    default: return -1;
  }
}
