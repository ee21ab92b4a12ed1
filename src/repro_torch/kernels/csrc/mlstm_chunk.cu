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
// Every input and output is fp32, and the products are fp32 FMAs (no TF32).
//
// What bounds it on the H100: per position 2·(c+1)·hd + 4·hd² FLOPs (q·k
// and the product with v over the c(c+1)/2 causal pairs of a chunk, q·C
// and the state update) against 16·hd bytes of q, k, v and y, about 136
// FLOP/byte at hd = 512 and c = 64, above fp32's ridge (67 TFLOP/s over
// 3.35 TB/s = 20): the bound is the fp32 rate. What the design does about the state: at hd = 512, C is
// 1 MiB for each (b, h), more than an SM's 227 KB of shared memory, so C
// is split over its value columns: block (vt, h, b) owns C[:, 32·vt :
// 32·vt + 32] (64 KiB of shared memory at hd = 512) and loops over the
// chunks itself, which takes the place of the TPU's sequential grid axis.
// The terms that need the whole key width (the c×c scores q·kᵀ, q·n and
// the n update) do not split by value column: every block recomputes them,
// streaming q and k through shared memory in slabs of 64 key columns. That
// is the price of the split: at hd = 512 about 1.94× the FLOPs of the
// bound's count. Each slab also serves q·C and the state update of its 64
// rows of C, so q and k are read once per block and chunk. The 256 threads
// own 4×4 score tiles and 4×2 output tiles, read from shared memory in
// 16-byte vectors. The causal mask is built from the positions inside the
// chunk, and exp is evaluated only where t ≤ s.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::load_rows;

constexpr int CM = 64;        // most positions in a chunk
constexpr int VT = 32;        // value columns of C owned by one block
constexpr int THREADS = 256;  // 16 row groups × 16 column groups

// Shared memory, in floats. Every offset is a multiple of 4 (16 bytes).
template <int HD>
struct Smem {
  static constexpr int KS = HD < 64 ? HD : 64;  // key columns per slab
  static constexpr int KP = KS + 4;             // padded row of a q / k slab
  static constexpr int PP = CM + 4;             // padded row of P
  static constexpr int C = 0;                   // C[:, v0:v0+VT], HD × VT
  static constexpr int N = C + HD * VT;         // n, HD
  static constexpr int Q = N + HD;              // q slab, CM × KP
  static constexpr int K = Q + CM * KP;         // k slab, CM × KP
  static constexpr int P = K + CM * KP;         // masked, decayed scores, CM × PP
  static constexpr int V = P + CM * PP;         // v[:, v0:v0+VT], CM × VT
  static constexpr int VW = V + CM * VT;        // v scaled by W, CM × VT
  static constexpr int FC = VW + CM * VT;       // fcum, CM
  static constexpr int W = FC + CM;             // i_t e^(ftot − fcum_t), CM
  static constexpr int LF = W + CM;             // log f, CM
  static constexpr int IG = LF + CM;            // i, CM
  static constexpr int TOTAL = IG + CM;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ log_f,
                   const float* __restrict__ i_gate, const float* __restrict__ C0,
                   const float* __restrict__ n0, float* __restrict__ y,
                   float* __restrict__ C_out, float* __restrict__ n_out, int S,
                   int H, int chunk) {
  using L = Smem<HD>;
  constexpr int KS = L::KS, KP = L::KP, PP = L::PP;
  constexpr int R = KS / 16;  // rows of C per thread in the state update
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem + L::C;
  float* Ns = smem + L::N;
  float* Qs = smem + L::Q;
  float* Ks = smem + L::K;
  float* Ps = smem + L::P;
  float* Vs = smem + L::V;
  float* Vw = smem + L::VW;
  float* Fc = smem + L::FC;
  float* Wt = smem + L::W;
  float* Lf = smem + L::LF;
  float* Ig = smem + L::IG;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx + 16j; value columns 2tx, 2tx+1
  const int ty = tid / 16;  // score / output rows 4ty .. 4ty+3; state rows R·ty ..
  const int v0 = blockIdx.x * VT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row = (size_t)H * HD;  // stride between positions of q, k, v, y
  const size_t base = (size_t)b * S * row + (size_t)h * HD;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base + v0;
  float* yb = y + base + v0;
  const float* fb = log_f + (size_t)b * S * H + h;  // position s at s·H
  const float* ib = i_gate + (size_t)b * S * H + h;
  const size_t bh = (size_t)b * H + h;

  for (int e = tid; e < HD * VT; e += THREADS)
    Cs[e] = C0 ? C0[(bh * HD + e / VT) * HD + v0 + e % VT] : 0.f;
  for (int d = tid; d < HD; d += THREADS) Ns[d] = n0 ? n0[bh * HD + d] : 0.f;

  const int n_chunks = (S + chunk - 1) / chunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * chunk;
    const int valid = min(S, c0 + chunk);  // position c0 + r is real iff < valid
    __syncthreads();  // the previous chunk is done with Ps, Vs and the gates
    if (tid < CM) {
      const bool on = c0 + tid < valid;
      Lf[tid] = on ? fb[(size_t)(c0 + tid) * H] : 0.f;
      Ig[tid] = on ? ib[(size_t)(c0 + tid) * H] : 0.f;
    }
    load_rows<float, VT, CM, THREADS>(Vs, VT, vb, row, c0, valid);
    __syncthreads();
    if (tid < 32) {  // inclusive scan of log f: lane l holds positions 2l, 2l+1
      const float a = Lf[2 * tid], a2 = Lf[2 * tid + 1];
      float incl = a + a2;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      Fc[2 * tid] = excl + a;
      Fc[2 * tid + 1] = incl;
    }
    __syncthreads();
    const float ftot = Fc[CM - 1];  // padded positions add log f = 0
    const float gtot = expf(ftot);
    if (tid < CM) Wt[tid] = Ig[tid] * expf(ftot - Fc[tid]);
    __syncthreads();
    for (int e = tid; e < CM * VT; e += THREADS) Vw[e] = Wt[e / VT] * Vs[e];

    float sc[4][4], yi[4][2], ni[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ni[i] = yi[i][0] = yi[i][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }

    for (int d0 = 0; d0 < HD; d0 += KS) {
      load_rows<float, KS, CM, THREADS>(Qs, KP, qb + d0, row, c0, valid);
      load_rows<float, KS, CM, THREADS>(Ks, KP, kb + d0, row, c0, valid);
      __syncthreads();  // (also publishes Vw before its first use below)
      // scores q·kᵀ, and q·C and q·n with the state as it was before the chunk
#pragma unroll 2
      for (int d = 0; d < KS; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * KP + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KP + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float s = sc[i][j];
            s = fmaf(qv[i].x, kv[j].x, s);
            s = fmaf(qv[i].y, kv[j].y, s);
            s = fmaf(qv[i].z, kv[j].z, s);
            sc[i][j] = fmaf(qv[i].w, kv[j].w, s);
          }
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          const float2 c = *reinterpret_cast<const float2*>(Cs + (d0 + d + dd) * VT + 2 * tx);
          const float nn = Ns[d0 + d + dd];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float qd = dd == 0 ? qv[i].x : dd == 1 ? qv[i].y : dd == 2 ? qv[i].z : qv[i].w;
            yi[i][0] = fmaf(qd, c.x, yi[i][0]);
            yi[i][1] = fmaf(qd, c.y, yi[i][1]);
            ni[i] = fmaf(qd, nn, ni[i]);
          }
        }
      }
      __syncthreads();  // every read of rows d0 .. d0+KS of the old C and n is done
      {
        float acc[R][2];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 4
        for (int t = 0; t < CM; ++t) {
          const float2 w = *reinterpret_cast<const float2*>(Vw + t * VT + 2 * tx);
          const float* kr = Ks + t * KP + R * ty;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][0] = fmaf(kr[i], w.x, acc[i][0]);
            acc[i][1] = fmaf(kr[i], w.y, acc[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float2* c = reinterpret_cast<float2*>(Cs + (d0 + R * ty + i) * VT + 2 * tx);
          const float2 old = *c;
          *c = make_float2(fmaf(gtot, old.x, acc[i][0]), fmaf(gtot, old.y, acc[i][1]));
        }
        if (tid < KS) {
          float s = 0.f;
          for (int t = 0; t < CM; ++t) s = fmaf(Ks[t * KP + tid], Wt[t], s);
          Ns[d0 + tid] = fmaf(gtot, Ns[d0 + tid], s);
        }
      }
      __syncthreads();  // the next slab overwrites Qs and Ks
    }

    // intra-chunk: P = (q·kᵀ) ⊙ D, D[s,t] = e^(fcum_s − fcum_t) i_t for t ≤ s
    float nrm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * ty + i;
      const float fs = Fc[s];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx + 16 * j;
        const float p = t <= s ? sc[i][j] * (expf(fs - Fc[t]) * Ig[t]) : 0.f;
        Ps[s * PP + t] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      nrm[i] = fmaf(expf(fs), ni[i], rs);
    }
    __syncthreads();
    float ya[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ya[i][0] = ya[i][1] = 0.f;
#pragma unroll 2
    for (int t = 0; t < CM; t += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * PP + t);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const float2 vv = *reinterpret_cast<const float2*>(Vs + (t + tt) * VT + 2 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = tt == 0 ? pv[i].x : tt == 1 ? pv[i].y : tt == 2 ? pv[i].z : pv[i].w;
          ya[i][0] = fmaf(p, vv.x, ya[i][0]);
          ya[i][1] = fmaf(p, vv.y, ya[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * ty + i;
      if (c0 + s >= valid) continue;
      const float e = expf(Fc[s]);
      const float den = fmaxf(fabsf(nrm[i]), 1.f);
      float2 out;
      out.x = fmaf(e, yi[i][0], ya[i][0]) / den;
      out.y = fmaf(e, yi[i][1], ya[i][1]) / den;
      *reinterpret_cast<float2*>(yb + (size_t)(c0 + s) * row + 2 * tx) = out;
    }
  }

  __syncthreads();
  for (int e = tid; e < HD * VT; e += THREADS)
    C_out[(bh * HD + e / VT) * HD + v0 + e % VT] = Cs[e];
  if (blockIdx.x == 0)
    for (int d = tid; d < HD; d += THREADS) n_out[bh * HD + d] = Ns[d];
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* log_f,
                   const float* i_gate, const float* C0, const float* n0, float* y,
                   float* C_out, float* n_out, int B, int S, int H, int chunk,
                   cudaStream_t stream) {
  const int smem = Smem<HD>::TOTAL * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(HD / VT, H, B);
  mlstm_chunk_kernel<HD><<<grid, THREADS, smem, stream>>>(
      q, k, v, log_f, i_gate, C0, n0, y, C_out, n_out, S, H, chunk);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, y (B,S,H,hd); log_f, i_gate (B,S,H); C0, C_out (B,H,hd,hd);
// n0, n_out (B,H,hd); all fp32 and contiguous. C0 and n0 may both be null
// (zero initial state). 1 <= chunk <= 64. Returns cudaGetLastError() after
// the launch.
extern "C" int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                               const void* log_f, const void* i_gate, const void* C0,
                               const void* n0, void* y, void* C_out, void* n_out, int B,
                               int S, int H, int hd, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > CM || (C0 == nullptr) != (n0 == nullptr))
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
  switch (hd) {
    case 32: return launch<32>(qf, kf, vf, ff, gf, cf, nf, yf, co, no, B, S, H, chunk, st);
    case 64: return launch<64>(qf, kf, vf, ff, gf, cf, nf, yf, co, no, B, S, H, chunk, st);
    case 512: return launch<512>(qf, kf, vf, ff, gf, cf, nf, yf, co, no, B, S, H, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}
