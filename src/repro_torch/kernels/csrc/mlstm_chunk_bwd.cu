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
// outputs per position plus the stored states: the operations bound it, on
// fp32 FMAs at 67 TFLOP/s. This first version runs every product on FMAs
// with register tiles of 4 × 4 (or 4 × 2) and no tensor cores. Operands
// stream through shared memory in slabs of 32 columns (128 at the sweep);
// each thread fetches its share of the next slab into registers before the
// products of the current one, so that the loads overlap the arithmetic
// (loaded and stored one by one, each load waited for the store before it).
//
// Five kernels, one call, in stream order; none uses atomics, and every sum
// is taken in a fixed order, so two calls on the same inputs agree to the bit:
// 1. rows: g and d nrm for every row (one warp per row);
// 2. scores, per (chunk, b·h): q·kᵀ and g·vᵀ over the chunk, P and dS into a
//    record per (b, h, chunk) with fcum and W, and the gate terms that come
//    from D (row and column sums of dP ⊙ P, and Σ_s dP ⊙ q·kᵀ ⊙ E);
// 3. sweep, per (32 value columns, b·h): the chunks in reverse, carrying
//    dC[:, 32 columns] in registers and dn in shared memory, writing each
//    chunk's dC' and dn' to a workspace; ends with dC_0 and dn_0;
// 4. tiles, per (64 columns, chunk, b·h): g·C_jᵀ, v·dC'ᵀ and k·dC' for its
//    columns, then dq, dk, dv of those columns and per-row partial sums of
//    the gate terms (q·(C_j g) and k·(dC' v + dn')) and of Σ C_j ⊙ dC';
// 5. gates, per (chunk, b·h): the partial sums added in column order, then
//    d i and the reverse cumulative sum that is d log f.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CM = 64;        // most positions in a chunk
constexpr int THREADS = 256;
constexpr int TS = CM + 4;    // row stride of the 64-wide tiles in shared memory
constexpr int SL = 32;        // columns per slab streamed through shared memory
// Record per (b, h, chunk), written by the scores kernel: P and dS (CM × CM,
// row-major), then fcum, W, the d fcum terms from D and the d i terms from D.
constexpr int REC = 2 * CM * CM + 4 * CM;
constexpr int R_DS = CM * CM, R_FC = 2 * CM * CM, R_W = R_FC + CM, R_DF = R_W + CM,
              R_DI = R_DF + CM;
// Partial sums per (b, h, chunk, column tile), written by the tiles kernel:
// q_s·(C g_s + d nrm_s n) and k_t·(dC' v_t + dn') over its columns, and its
// share of Σ C ⊙ dC' + n·dn'.
constexpr int PART = 2 * CM + 4;

__host__ __device__ constexpr int tile_width(int hd) { return hd < 64 ? hd : 64; }

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
  const float* yr = y + (size_t)r * HD;
  const float* dr = dy + (size_t)r * HD;
  const float nr = nrm[r];
  const float m = fmaxf(fabsf(nr), 1.f);
  float dot = 0.f;
  for (int d = lane; d < HD; d += 32) {
    const float dv = dr[d];
    dot = fmaf(dv, yr[d], dot);
    g[(size_t)r * HD + d] = dv / m;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0) {
    const float sign = nr > 0.f ? 1.f : (nr < 0.f ? -1.f : 0.f);
    dnrm[r] = fabsf(nr) >= 1.f ? -(dot / m) * sign : 0.f;
  }
}

// One thread's share of a slab streamed through shared memory: N elements
// of an R × C tile (element e = threadIdx.x + i·THREADS is row e / C, column
// e % C), fetched from global memory into registers first and stored into
// shared memory later, so that the next slab's loads fly while this one is
// used.
template <int R, int C>
struct Slab {
  static constexpr int N = R * C / THREADS;
  static_assert(R * C % THREADS == 0, "whole slabs per thread");
  float x[N];
  // rows of a (B,S,H,HD) tensor at the chunk's positions (row stride `row`
  // from `src`); rows at or past `valid` are zeros
  __device__ __forceinline__ void fetch_rows(const float* __restrict__ src, size_t row,
                                             int valid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * THREADS, r = e / C, c = e % C;
      x[i] = r < valid ? src[(size_t)r * row + c] : 0.f;
    }
  }
  // transposed: dst[c][r], row stride `stride`
  __device__ __forceinline__ void store_t(float* dst, int stride) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * THREADS;
      dst[(e % C) * stride + e / C] = x[i];
    }
  }
  // as it is: dst[r][c], row stride `stride`
  __device__ __forceinline__ void store(float* dst, int stride) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * THREADS;
      dst[(e / C) * stride + e % C] = x[i];
    }
  }
};
using ChunkSlab = Slab<CM, SL>;  // SL columns of the chunk's CM positions

// ---- 2. scores: P, dS, and the gate terms that come from D ----

template <int HD>
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ dnrm, const float* __restrict__ log_f,
                        const float* __restrict__ i_gate, float* __restrict__ rec_all, int S,
                        int H, int chunk, int n_chunks) {
  // the four slabs, then (after the products) the (dP ⊙ P) and d i terms of each pair
  constexpr int BUF = 4 * SL * TS > 2 * CM * (CM + 1) ? 4 * SL * TS : 2 * CM * (CM + 1);
  __shared__ __align__(16) float buf[BUF];
  __shared__ float Fc[CM], Ig[CM], Dn[CM];
  float* Qt = buf;
  float* Kt = Qt + SL * TS;
  float* Gt = Kt + SL * TS;
  float* Vt = Gt + SL * TS;
  float* rowsum = buf;                 // CM × (CM + 1)
  float* disum = buf + CM * (CM + 1);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int ci = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = ci * chunk, valid = min(chunk, S - c0);
  const size_t row = (size_t)H * HD;
  const size_t base = ((size_t)b * S + c0) * row + (size_t)h * HD;
  float* rec = rec_all + ((size_t)bh * n_chunks + ci) * REC;

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
    rec[R_FC + p0] = Fc[p0];
    rec[R_FC + p1] = Fc[p1];
    rec[R_W + p0] = Ig[p0] * expf(ftot - Fc[p0]);
    rec[R_W + p1] = Ig[p1] * expf(ftot - Fc[p1]);
  }

  // thread (ty, tx): rows s = 4·ty + i, keys t = 4·tx + j
  const int ty = tid >> 4, tx = tid & 15;
  float sc[4][4] = {}, gv[4][4] = {};
  ChunkSlab sq, sk, sg, sv;
  sq.fetch_rows(q + base, row, valid);
  sk.fetch_rows(k + base, row, valid);
  sg.fetch_rows(g + base, row, valid);
  sv.fetch_rows(v + base, row, valid);
  for (int c = 0; c < HD; c += SL) {
    __syncthreads();  // the previous slab is read
    sq.store_t(Qt, TS);
    sk.store_t(Kt, TS);
    sg.store_t(Gt, TS);
    sv.store_t(Vt, TS);
    __syncthreads();
    if (c + SL < HD) {  // the next slab's loads run under this one's products
      sq.fetch_rows(q + base + c + SL, row, valid);
      sk.fetch_rows(k + base + c + SL, row, valid);
      sg.fetch_rows(g + base + c + SL, row, valid);
      sv.fetch_rows(v + base + c + SL, row, valid);
    }
#pragma unroll 4
    for (int kk = 0; kk < SL; ++kk) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + kk * TS + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + kk * TS + 4 * tx);
      const float4 ga = *reinterpret_cast<const float4*>(Gt + kk * TS + 4 * ty);
      const float4 va = *reinterpret_cast<const float4*>(Vt + kk * TS + 4 * tx);
      const float qi[4] = {qa.x, qa.y, qa.z, qa.w}, kj[4] = {ka.x, ka.y, ka.z, ka.w};
      const float gi[4] = {ga.x, ga.y, ga.z, ga.w}, vj[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qi[i], kj[j], sc[i][j]);
          gv[i][j] = fmaf(gi[i], vj[j], gv[i][j]);
        }
    }
  }
  // P = S ⊙ D, dP = g·vᵀ + d nrm, dS = dP ⊙ D on t ≤ s < valid (exp only
  // there: above the diagonal it can overflow); zeros elsewhere
  __syncthreads();  // the last slab is read: buf now holds the pair terms
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * ty + i;
    float p[4], ds[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * tx + j;
      float pp = 0.f, dd = 0.f, dpp = 0.f, di = 0.f;
      if (t <= s && s < valid) {
        const float e = expf(Fc[s] - Fc[t]);
        const float dmat = e * Ig[t];
        const float dp = gv[i][j] + Dn[s];
        pp = sc[i][j] * dmat;
        dd = dp * dmat;
        dpp = dp * pp;
        di = dp * sc[i][j] * e;
      }
      p[j] = pp;
      ds[j] = dd;
      rowsum[s * (CM + 1) + t] = dpp;
      disum[s * (CM + 1) + t] = di;
    }
    *reinterpret_cast<float4*>(rec + s * CM + 4 * tx) = make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(rec + R_DS + s * CM + 4 * tx) =
        make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
  __syncthreads();
  if (tid < CM) {  // d fcum_s from D: Σ_t (dP⊙P)[s,t] − Σ_r (dP⊙P)[r,s]; d i_t: Σ_s dP⊙S⊙E
    float rs = 0.f, cs = 0.f, di = 0.f;
    for (int t = 0; t < CM; ++t) rs += rowsum[tid * (CM + 1) + t];
    for (int r = 0; r < CM; ++r) {
      cs += rowsum[r * (CM + 1) + tid];
      di += disum[r * (CM + 1) + tid];
    }
    rec[R_DF + tid] = rs - cs;
    rec[R_DI + tid] = di;
  }
}

// ---- 3. sweep: dC and dn over the chunks in reverse ----

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)  // one block per SM: dC's 64 floats a thread stay in registers
mlstm_bwd_sweep_kernel(const float* __restrict__ q, const float* __restrict__ g,
                       const float* __restrict__ dnrm, const float* __restrict__ rec_all,
                       const float* __restrict__ dC_final, const float* __restrict__ dn_final,
                       float* __restrict__ dC_ws, float* __restrict__ dn_ws,
                       float* __restrict__ dC0, float* __restrict__ dn0, int S, int H,
                       int chunk, int n_chunks) {
  constexpr int QW = HD < 128 ? HD : 128;  // key columns per slab of a·q
  constexpr int R = HD / 32;               // rows of dC per thread
  __shared__ __align__(16) float AQ[CM * (QW + 4)];
  __shared__ __align__(16) float Gs[CM * (32 + 4)];
  __shared__ float Dn[HD], A[CM], Dr[CM];
  const int tid = threadIdx.x;
  const int vt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int v0 = vt * 32;
  const size_t row = (size_t)H * HD;
  // thread (ty, tx) owns dC rows ty + 32·r, columns v0 + 4·tx .. + 3
  const int ty = tid >> 3, tx = tid & 7;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = ty + 32 * r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (dC_final) x = *reinterpret_cast<const float4*>(dC_final + ((size_t)bh * HD + d) * HD + v0 + 4 * tx);
    acc[r][0] = x.x;
    acc[r][1] = x.y;
    acc[r][2] = x.z;
    acc[r][3] = x.w;
  }
  if (vt == 0)
    for (int d = tid; d < HD; d += THREADS) Dn[d] = dn_final ? dn_final[(size_t)bh * HD + d] : 0.f;
  // q of the next (chunk, slab) item in registers, scaled by a_s when stored
  Slab<CM, QW> qs;
  auto fetch_q = [&](int ci, int q0) {
    const int c0 = ci * chunk;
    qs.fetch_rows(q + ((size_t)b * S + c0) * row + (size_t)h * HD + q0, row, min(chunk, S - c0));
  };
  fetch_q(n_chunks - 1, 0);

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int c0 = ci * chunk, valid = min(chunk, S - c0);
    const float* rec = rec_all + ((size_t)bh * n_chunks + ci) * REC;
    __syncthreads();  // the previous chunk's tiles are read, Dn is updated
    // dC' and dn' of this chunk (the gradient of the state after it)
    float* dcw = dC_ws + ((size_t)bh * n_chunks + ci) * HD * HD + v0 + 4 * tx;
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(dcw + (size_t)(ty + 32 * r) * HD) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (vt == 0)
      for (int d = tid; d < HD; d += THREADS) dn_ws[((size_t)bh * n_chunks + ci) * HD + d] = Dn[d];
    const float fc_last = rec[R_FC + CM - 1];  // ftot: padded positions add log f = 0
    const float decay = expf(fc_last);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= decay;
    if (tid < CM) {
      const bool ok = tid < valid;
      A[tid] = ok ? expf(rec[R_FC + tid]) : 0.f;
      Dr[tid] = ok ? dnrm[((size_t)b * S + c0 + tid) * H + h] : 0.f;
    }
    for (int e = tid; e < CM * 32; e += THREADS) {
      const int s = e / 32, c = e % 32;
      Gs[s * 36 + c] = s < valid ? g[((size_t)b * S + c0 + s) * row + (size_t)h * HD + v0 + c] : 0.f;
    }
    if (vt == 0) {
      __syncthreads();  // Dn's readers above are done
      for (int d = tid; d < HD; d += THREADS) Dn[d] *= decay;
    }
#pragma unroll
    for (int sl = 0; sl < HD / QW; ++sl) {  // unrolled: acc's indices are constants
      const int q0 = sl * QW;
      __syncthreads();  // A is written; the previous slab is read
#pragma unroll
      for (int i = 0; i < Slab<CM, QW>::N; ++i) {  // a·q (rows past the chunk: 0 · 0)
        const int e = tid + i * THREADS, s = e / QW;
        AQ[s * (QW + 4) + e % QW] = A[s] * qs.x[i];
      }
      __syncthreads();
      if (sl + 1 < HD / QW)  // the next slab's loads run under this one's products
        fetch_q(ci, q0 + QW);
      else if (ci > 0)
        fetch_q(ci - 1, 0);
      for (int s = 0; s < valid; ++s) {
        const float4 gv = *reinterpret_cast<const float4*>(Gs + s * 36 + 4 * tx);
#pragma unroll
        for (int rr = 0; rr < QW / 32; ++rr) {  // this thread's rows in the slab
          const int r = sl * (QW / 32) + rr;
          const float aq = AQ[s * (QW + 4) + ty + 32 * rr];
          acc[r][0] = fmaf(aq, gv.x, acc[r][0]);
          acc[r][1] = fmaf(aq, gv.y, acc[r][1]);
          acc[r][2] = fmaf(aq, gv.z, acc[r][2]);
          acc[r][3] = fmaf(aq, gv.w, acc[r][3]);
        }
      }
      if (vt == 0)
        for (int d = tid; d < QW; d += THREADS) {
          float sum = Dn[q0 + d];
          for (int s = 0; s < valid; ++s) sum = fmaf(AQ[s * (QW + 4) + d], Dr[s], sum);
          Dn[q0 + d] = sum;
        }
    }
  }
  if (dC0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(dC0 + ((size_t)bh * HD + ty + 32 * r) * HD + v0 + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (vt == 0) {
      __syncthreads();
      for (int d = tid; d < HD; d += THREADS) dn0[(size_t)bh * HD + d] = Dn[d];
    }
  }
}

// ---- 4. tiles: dq, dk, dv of 64 columns and partial gate sums ----

// N consecutive floats from shared memory (16- or 8-byte aligned) in one load.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&x)[N]) {
  static_assert(N == 2 || N == 4, "two or four columns per thread");
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}

template <int HD>
struct TileSmem {
  static constexpr int TW = tile_width(HD);
  static constexpr int WS = TW + 4;  // row stride of the column tiles
  // phase 1: g, v transposed (SL × TS), rows of C_j and dC' transposed (SL × WS);
  // phase 2 reuses the first two slots: k transposed and dC' columns
  static constexpr int P1 = 2 * SL * TS + 2 * SL * WS;
  // phase 3: q, k, g column tiles (CM × WS), P and dS (CM × TS)
  static constexpr int P3 = 3 * CM * WS + 2 * CM * TS;
  static constexpr int TOTAL = (P1 > P3 ? P1 : P3) + 4 * CM + 2 * TW + THREADS;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks per SM: 128 registers a thread
mlstm_bwd_tiles_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ dnrm, const float* __restrict__ C_states,
                       const float* __restrict__ n_states, const float* __restrict__ dC_ws,
                       const float* __restrict__ dn_ws, const float* __restrict__ rec_all,
                       float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ part_all, int S, int H, int chunk, int n_chunks) {
  using L = TileSmem<HD>;
  constexpr int TW = L::TW, WS = L::WS, CPT = TW / 16, NT = HD / TW;
  extern __shared__ __align__(16) float smem[];
  float* gates = smem + (L::P1 > L::P3 ? L::P1 : L::P3);
  float* A = gates;            // a_s = e^fcum_s (0 past the chunk's end)
  float* Wt = A + CM;          // W_t
  float* Dr = Wt + CM;         // d nrm_s
  float* nj = Dr + CM + CM;    // n_j over this tile's columns
  float* dnp = nj + TW;        // dn' over this tile's columns
  float* red = dnp + TW;       // THREADS partial sums of Σ C ⊙ dC'

  const int tid = threadIdx.x;
  const int ct = blockIdx.x, ci = blockIdx.y, bh = blockIdx.z, b = bh / H, h = bh % H;
  const int col0 = ct * TW;
  const int c0 = ci * chunk, valid = min(chunk, S - c0);
  const size_t row = (size_t)H * HD;
  const size_t base = ((size_t)b * S + c0) * row + (size_t)h * HD;
  const size_t st = (size_t)bh * n_chunks + ci;
  const float* Cj = C_states + st * HD * HD;
  const float* dCp = dC_ws + st * HD * HD;
  const float* rec = rec_all + st * REC;
  // thread (ty, tx): rows 4·ty + i of the chunk, columns col0 + CPT·tx + j
  const int ty = tid >> 4, tx = tid & 15;

  if (tid < CM) {
    const bool ok = tid < valid;
    A[tid] = ok ? expf(rec[R_FC + tid]) : 0.f;
    Wt[tid] = rec[R_W + tid];
    Dr[tid] = ok ? dnrm[((size_t)b * S + c0 + tid) * H + h] : 0.f;
  }
  for (int c = tid; c < TW; c += THREADS) {
    nj[c] = n_states[st * HD + col0 + c];
    dnp[c] = dn_ws[st * HD + col0 + c];
  }

  // phase 1: CG = g·C_j[cols, :]ᵀ and DV = v·dC'[cols, :]ᵀ over slabs of value columns
  float cg[4][CPT] = {}, dvv[4][CPT] = {}, kd[4][CPT] = {};
  float tot = 0.f;  // this thread's share of Σ C_j ⊙ dC' over the tile's rows
  {
    float* Gt = smem;
    float* Vt = Gt + SL * TS;
    float* Ct = Vt + SL * TS;
    float* Dt = Ct + SL * WS;
    ChunkSlab sg, sv;
    Slab<TW, SL> scj, sdc;  // rows col0 .. of C_j and dC', SL columns
    sg.fetch_rows(g + base, row, valid);
    sv.fetch_rows(v + base, row, valid);
    scj.fetch_rows(Cj + (size_t)col0 * HD, HD, TW);
    sdc.fetch_rows(dCp + (size_t)col0 * HD, HD, TW);
    for (int c = 0; c < HD; c += SL) {
      __syncthreads();
      sg.store_t(Gt, TS);
      sv.store_t(Vt, TS);
      scj.store_t(Ct, WS);
      sdc.store_t(Dt, WS);
#pragma unroll
      for (int i = 0; i < Slab<TW, SL>::N; ++i) tot = fmaf(scj.x[i], sdc.x[i], tot);
      __syncthreads();
      if (c + SL < HD) {  // the next slab's loads run under this one's products
        sg.fetch_rows(g + base + c + SL, row, valid);
        sv.fetch_rows(v + base + c + SL, row, valid);
        scj.fetch_rows(Cj + (size_t)col0 * HD + c + SL, HD, TW);
        sdc.fetch_rows(dCp + (size_t)col0 * HD + c + SL, HD, TW);
      }
#pragma unroll 4
      for (int kk = 0; kk < SL; ++kk) {
        const float4 ga = *reinterpret_cast<const float4*>(Gt + kk * TS + 4 * ty);
        const float4 va = *reinterpret_cast<const float4*>(Vt + kk * TS + 4 * ty);
        const float gi[4] = {ga.x, ga.y, ga.z, ga.w}, vi[4] = {va.x, va.y, va.z, va.w};
        float cj[CPT], dj[CPT];
        load_n(Ct + kk * WS + CPT * tx, cj);
        load_n(Dt + kk * WS + CPT * tx, dj);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            cg[i][j] = fmaf(gi[i], cj[j], cg[i][j]);
            dvv[i][j] = fmaf(vi[i], dj[j], dvv[i][j]);
          }
      }
    }
    // phase 2: KD = k·dC'[:, cols] over slabs of key rows
    float* Kt = smem;
    float* Dc = Kt + SL * TS;
    ChunkSlab sk;
    Slab<SL, TW> sdcol;  // rows c .. of dC', columns col0 ..
    sk.fetch_rows(k + base, row, valid);
    sdcol.fetch_rows(dCp + col0, HD, SL);
    for (int c = 0; c < HD; c += SL) {
      __syncthreads();
      sk.store_t(Kt, TS);
      sdcol.store(Dc, WS);
      __syncthreads();
      if (c + SL < HD) {
        sk.fetch_rows(k + base + c + SL, row, valid);
        sdcol.fetch_rows(dCp + (size_t)(c + SL) * HD + col0, HD, SL);
      }
#pragma unroll 4
      for (int kk = 0; kk < SL; ++kk) {
        const float4 ka = *reinterpret_cast<const float4*>(Kt + kk * TS + 4 * ty);
        const float ki[4] = {ka.x, ka.y, ka.z, ka.w};
        float dj[CPT];
        load_n(Dc + kk * WS + CPT * tx, dj);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) kd[i][j] = fmaf(ki[i], dj[j], kd[i][j]);
      }
    }
  }
  red[tid] = tot;
  __syncthreads();  // phases 1 and 2 are read

  // phase 3: the intra-chunk products and the outputs
  float* Qc = smem;
  float* Kc = Qc + CM * WS;
  float* Gc = Kc + CM * WS;
  float* Ps = Gc + CM * WS;
  float* Ds = Ps + CM * TS;
  for (int e = tid; e < CM * TW; e += THREADS) {
    const int r = e / TW, c = e % TW;
    const bool ok = r < valid;
    const size_t o = base + (size_t)r * row + col0 + c;
    Qc[r * WS + c] = ok ? q[o] : 0.f;
    Kc[r * WS + c] = ok ? k[o] : 0.f;
    Gc[r * WS + c] = ok ? g[o] : 0.f;
  }
  for (int e = tid; e < CM * CM; e += THREADS) {
    const int r = e / CM, c = e % CM;
    Ps[r * TS + c] = rec[e];
    Ds[r * TS + c] = rec[R_DS + e];
  }
  __syncthreads();
  float oq[4][CPT], ok_[4][CPT], ov[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = CPT * tx + j;
      oq[i][j] = A[s] * (cg[i][j] + Dr[s] * nj[c]);
      ok_[i][j] = Wt[s] * (dvv[i][j] + dnp[c]);
      ov[i][j] = Wt[s] * kd[i][j];
    }
  }
  // per-row partial sums of the gate terms over this tile's columns
  float pa[4], pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * ty + i;
    pa[i] = 0.f;
    pw[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = CPT * tx + j;
      pa[i] = fmaf(Qc[s * WS + c], cg[i][j] + Dr[s] * nj[c], pa[i]);
      pw[i] = fmaf(Kc[s * WS + c], dvv[i][j] + dnp[c], pw[i]);
    }
  }
  for (int t = 0; t < CM; ++t) {
    float kc[CPT], qc[CPT], gc[CPT];
    load_n(Kc + t * WS + CPT * tx, kc);
    load_n(Qc + t * WS + CPT * tx, qc);
    load_n(Gc + t * WS + CPT * tx, gc);
    const float4 dst = *reinterpret_cast<const float4*>(Ds + t * TS + 4 * ty);  // dS[t][rows]
    const float4 pst = *reinterpret_cast<const float4*>(Ps + t * TS + 4 * ty);  // P[t][rows]
    const float dsr[4] = {dst.x, dst.y, dst.z, dst.w}, psr[4] = {pst.x, pst.y, pst.z, pst.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dsq = Ds[(4 * ty + i) * TS + t];  // dS[row][t]
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        oq[i][j] = fmaf(dsq, kc[j], oq[i][j]);       // dq_s += dS[s,t] k_t
        ok_[i][j] = fmaf(dsr[i], qc[j], ok_[i][j]);  // dk_s += dS[t,s] q_t
        ov[i][j] = fmaf(psr[i], gc[j], ov[i][j]);    // dv_s += P[t,s] g_t
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * ty + i;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {  // the 16 threads of a row: lanes of one half-warp
      pa[i] += __shfl_xor_sync(0xffffffffu, pa[i], off);
      pw[i] += __shfl_xor_sync(0xffffffffu, pw[i], off);
    }
    if (s < valid) {
      const size_t o = base + (size_t)s * row + col0 + CPT * tx;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        dq[o + j] = oq[i][j];
        dk[o + j] = ok_[i][j];
        dv[o + j] = ov[i][j];
      }
    }
  }
  float* part = part_all + (st * NT + ct) * PART;
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      part[4 * ty + i] = pa[i];
      part[CM + 4 * ty + i] = pw[i];
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

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* log_f,
                   const float* i_gate, const float* y, const float* dy, const float* C_states,
                   const float* n_states, const float* nrm, const float* dC_final,
                   const float* dn_final, float* dq, float* dk, float* dv, float* dlog_f,
                   float* di, float* dC0, float* dn0, float* ws, int B, int S, int H,
                   int chunk, cudaStream_t stream) {
  using L = TileSmem<HD>;
  const int n_chunks = (S + chunk - 1) / chunk;
  const Workspace o(B, S, H, HD, chunk);
  float *g = ws + o.g, *dnrm = ws + o.dnrm, *dCw = ws + o.dC, *dnw = ws + o.dn,
        *rec = ws + o.rec, *part = ws + o.part;
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_bwd_tiles_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::TOTAL * (int)sizeof(float));
  if (attr != cudaSuccess) return attr;
  const int rows = B * S * H;
  mlstm_bwd_rows_kernel<HD><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(
      y, dy, nrm, g, dnrm, rows);
  mlstm_bwd_scores_kernel<HD><<<dim3(n_chunks, B * H), THREADS, 0, stream>>>(
      q, k, v, g, dnrm, log_f, i_gate, rec, S, H, chunk, n_chunks);
  mlstm_bwd_sweep_kernel<HD><<<dim3(HD / 32, B * H), THREADS, 0, stream>>>(
      q, g, dnrm, rec, dC_final, dn_final, dCw, dnw, dC0, dn0, S, H, chunk, n_chunks);
  mlstm_bwd_tiles_kernel<HD><<<dim3(HD / L::TW, n_chunks, B * H), THREADS,
                               L::TOTAL * sizeof(float), stream>>>(
      q, k, v, g, dnrm, C_states, n_states, dCw, dnw, rec, dq, dk, dv, part, S, H, chunk,
      n_chunks);
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
