// Decode attention for Hopper (sm_90a), split over the kv axis: one new
// query token per sequence against a preallocated KV cache, per-sequence
// valid length, grouped-query heads, fp32 or bf16 inputs, fp32 softmax and
// accumulator.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention (body _decode_kernel). It computes, for q
// (B,H,hd) and caches (B,S,K,hd), softmax(q·kᵀ·hd^-½ masked to
// col < kv_len[b])·v, the G = H/K query heads of kv head kh being heads
// kh·G .. kh·G+G-1. kv_len is clamped to S; the tail past it is masked
// here, so S need not be a multiple of the tile (the TPU kernel asserts
// S % block_k == 0).
//
// What bounds it on the H100: every valid cache byte is read once per
// step and used for only 2·G FLOPs per element pair, so the bound is
// Σ_b kv_len[b]·K·hd·2 (k and v) elements at 3.35 TB/s. What the design
// does about it:
// - the kv axis of each sequence is cut into n_split ranges of split_len
//   keys (whole 64-key tiles), chosen on the host from B, K and S alone so
//   that a small batch still fills the 132 SMs; the grid is
//   (n_split, K, B) and kv_len never leaves the device. A block whose range
//   starts past kv_len[b] writes an empty partial;
// - each block's 4 warps work alone: warp w takes keys w·16 .. w·16+15 of
//   every 64-key tile of the range and streams them through its own
//   cp.async ring, 2 to 4 tiles deep (about 16 KB in flight per warp; each
//   lane copies, and later reads, the same 16-byte vectors, so no barrier
//   is needed), so the next tiles are in flight while this one is used;
//   the first are issued before q is staged; each K/V vector serves all
//   G heads;
// - a lane holds one 16-byte vector of a key's row: a score is VEC
//   multiply-adds and a shuffle reduction over the hd/VEC lanes of the key,
//   p·v is G·VEC independent accumulators per lane, and the running max
//   of a warp is rescaled only when it grows. At hd 192 a row is 24 (bf16)
//   or 48 (f32) 16-byte vectors, which no power-of-two count of lanes
//   divides, and 16-byte vectors would leave a lane G·24 accumulators: there
//   all 32 lanes share one key, each holding NV = 3 vectors of 4 (bf16) or
//   8 (f32) bytes, lane l's the vectors l, l+32, l+64, so a lane keeps G·6
//   accumulators and each of its loads is one coalesced 128- or 256-byte
//   row segment per warp. The ring is still filled by 16-byte copies, each
//   lane its own share of the tile, so a __syncwarp after each wait makes
//   the other lanes' copies visible;
// - at the end the 4 warps merge by the log-sum-exp rule in shared memory.
//   With one split the block writes the output in q's type; otherwise it
//   writes (m, l, acc[G, hd]) in fp32 to scratch and decode_combine_kernel
//   merges the splits of each (b, kv head). At hd 192 the merge area
//   reuses the rings' memory once every warp has left its loop: q, the
//   rings and the merge area together would pass the 227 KB a block may
//   use in f32 (12 + 192 + 50 KB), and in bf16 (12 + 96 + 50 KB) they would
//   leave room for one block an SM instead of two.
// Asked for it, the kernel also writes each row's log-sum-exp (the merge
// already holds the row's max and sum): a decode over one range of a
// sequence-sharded cache merges with the other ranges' by it. A row that
// sees no key (kv_len 0) writes -inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::kNegInf;
using repro::to_f32;

constexpr int BK = 64;          // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KPW = BK / WARPS;  // keys of a tile per warp
constexpr int MAX_G = 16;       // query heads per kv head
constexpr float kLog2e = 1.4426950408889634f;

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use on sm_90

template <typename T, int HD, int GMAX>
struct Cfg {
  // a row as 16-byte vectors, one per lane of a key, where a power-of-two
  // count of lanes takes it; else (hd 192) NV vectors of 1/NV of a warp's row
  // share per lane over all 32 lanes
  static constexpr int V16 = HD * (int)sizeof(T) / 16;
  static constexpr bool WIDE = V16 > 32 || 32 % V16 != 0;
  static constexpr int NV = WIDE ? 3 : 1;       // vectors per lane
  static constexpr int LPK = WIDE ? 32 : V16;   // lanes per key
  static constexpr int VB = HD * (int)sizeof(T) / (LPK * NV);  // bytes per vector
  static constexpr int VEC = VB / (int)sizeof(T);  // elements per vector
  static constexpr int E = NV * VEC;            // elements of a key per lane
  static constexpr int R = 32 / LPK;            // keys per warp step
  static constexpr int STEPS = KPW / R;         // steps per tile
  // steps whose scores are held at once (GMAX·P of them, at most 32)
  static constexpr int P = STEPS < 32 / GMAX ? STEPS : (32 / GMAX < 1 ? 1 : 32 / GMAX);
  static constexpr int ROW = HD * sizeof(T);    // bytes of one cache row
  static constexpr int STAGE = 2 * KPW * ROW;   // K then V rows of one warp's tile
  // ring depth: about 16 KB of each warp's keys in flight, 2 to 4 tiles
  static constexpr int NSTAGE = 16384 / STAGE < 2 ? 2 : (16384 / STAGE > 4 ? 4 : 16384 / STAGE);
  // shared memory: q (GMAX × HD fp32), the per-warp rings, the merge area
  static constexpr int Q_BYTES = GMAX * HD * 4;
  static constexpr int RING_BYTES = WARPS * NSTAGE * STAGE;
  static constexpr int MERGE_BYTES = WARPS * GMAX * (HD + 2) * 4;
  // the merge area reuses the rings where all three would not fit, and at
  // hd 192, where that halves a block's shared memory so two fit on an SM
  static constexpr bool ALIAS = Q_BYTES + RING_BYTES + MERGE_BYTES > SMEM_MAX || WIDE;
  static constexpr int MERGE_OFF = Q_BYTES + (ALIAS ? 0 : RING_BYTES);
  static constexpr int SMEM = MERGE_OFF + (ALIAS && RING_BYTES > MERGE_BYTES ? RING_BYTES
                                                                              : MERGE_BYTES);
  static_assert(LPK <= 32 && 32 % LPK == 0 && KPW % R == 0 && STEPS % P == 0 &&
                NV * LPK * VB == HD * (int)sizeof(T) && VB % 4 == 0 && SMEM <= SMEM_MAX,
                "head dim out of range");
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte asynchronous copy; with `valid` false it writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// The E elements of a key this lane holds, from its NV vectors of VB bytes
// at row + (vec + LPK·n)·VB, to fp32
template <typename T, typename C>
__device__ __forceinline__ void load_key(const unsigned char* row, int vec, float (&out)[C::E]) {
#pragma unroll
  for (int n = 0; n < C::NV; ++n) {
    const unsigned char* p = row + (vec + C::LPK * n) * C::VB;
    T e[C::VEC];
    if constexpr (C::VB == 16) *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
    else if constexpr (C::VB == 8) *reinterpret_cast<uint2*>(e) = *reinterpret_cast<const uint2*>(p);
    else *reinterpret_cast<uint32_t*>(e) = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < C::VEC; ++j) out[n * C::VEC + j] = to_f32(e[j]);
  }
}

// Σ_j q[j]·k[j] over the lane's E elements, q from its head's fp32 row in
// shared memory (the same vectors as the key), in two chains
template <typename C>
__device__ __forceinline__ float dot_q(const float* qrow, int vec, const float (&kv)[C::E]) {
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int n = 0; n < C::NV; ++n) {
    const float* qp = qrow + (vec + C::LPK * n) * C::VEC;
#pragma unroll
    for (int j = 0; j < C::VEC; j += 4) {
      if constexpr (C::VEC % 4 == 0) {
        const float4 qq = *reinterpret_cast<const float4*>(qp + j);
        a = fmaf(qq.x, kv[n * C::VEC + j], a);
        c = fmaf(qq.y, kv[n * C::VEC + j + 1], c);
        a = fmaf(qq.z, kv[n * C::VEC + j + 2], a);
        c = fmaf(qq.w, kv[n * C::VEC + j + 3], c);
      } else {  // VEC == 2
        const float2 qq = *reinterpret_cast<const float2*>(qp + j);
        a = fmaf(qq.x, kv[n * C::VEC + j], a);
        c = fmaf(qq.y, kv[n * C::VEC + j + 1], c);
      }
    }
  }
  return a + c;
}

// A row's natural log-sum-exp from its running max M (log2 units, the
// scores scaled by log2 e) and its sum L of exp2(score - M): -inf when the
// row saw no key (L = 0).
__device__ __forceinline__ float row_lse(float M, float L) {
  return L > 0.f ? (M + log2f(L)) * 0.6931471805599453f : -INFINITY;
}

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ kv_len,
                    T* __restrict__ o, float* __restrict__ part, float* __restrict__ lse,
                    int S, int K, int G, int split_len, float scale_log2) {
  using C = Cfg<T, HD, GMAX>;
  constexpr int E = C::E, LPK = C::LPK, R = C::R, NSTAGE = C::NSTAGE, P = C::P;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + C::Q_BYTES;
  float* Wm = reinterpret_cast<float*>(smem + C::MERGE_OFF);              // WARPS × GMAX
  float* Wl = Wm + WARPS * GMAX;                                          // WARPS × GMAX
  float* Wacc = Wl + WARPS * GMAX;                                        // WARPS × GMAX × HD

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int H = K * G;
  const int n = min(max(kv_len[b], 0), S);
  const int k_lo = split * split_len;
  const int k_hi = min(k_lo + split_len, n);

  float m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) acc[g][j] = 0.f;
  }

  if (k_lo < k_hi) {
    const size_t kv_row = (size_t)K * HD;
    const T* kb = kc + (size_t)b * S * kv_row + (size_t)kh * HD;
    const T* vb = vc + (size_t)b * S * kv_row + (size_t)kh * HD;
    const int slot = lane / LPK;  // which key of a step this lane holds
    const int vec = lane % LPK;   // which 16-byte vector of the row
    const uint32_t ring0 = static_cast<uint32_t>(__cvta_generic_to_shared(ring)) +
                           warp * NSTAGE * C::STAGE;
    const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

    // one commit group per tile, empty past the last, so that "all but the
    // newest NSTAGE-1 groups have landed" always means "tile t has landed"
    auto issue = [&](int t) {
      if (t < n_tiles) {
        const uint32_t st = ring0 + (t % NSTAGE) * C::STAGE;
        if constexpr (C::NV == 1) {  // each lane copies the vectors it reads
#pragma unroll
          for (int s = 0; s < C::STEPS; ++s) {
            const int r = s * R + slot;                   // row of the warp's tile
            const int key = k_lo + t * BK + warp * KPW + r;
            const bool ok = key < k_hi;
            const size_t off = (size_t)(ok ? key : 0) * kv_row + vec * C::VEC;
            cp_async16(st + r * C::ROW + vec * 16, kb + off, ok);
            cp_async16(st + KPW * C::ROW + r * C::ROW + vec * 16, vb + off, ok);
          }
        } else {  // the warp's KPW rows as 16-byte chunks, lane-strided
          constexpr int CPR = C::ROW / 16;                // chunks per row
          constexpr int EPC = 16 / (int)sizeof(T);        // elements per chunk
#pragma unroll
          for (int c = lane; c < KPW * CPR; c += 32) {
            const int r = c / CPR;
            const int key = k_lo + t * BK + warp * KPW + r;
            const bool ok = key < k_hi;
            const size_t off = (size_t)(ok ? key : 0) * kv_row + (c % CPR) * EPC;
            cp_async16(st + c * 16, kb + off, ok);
            cp_async16(st + KPW * C::ROW + c * 16, vb + off, ok);
          }
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };

#pragma unroll
    for (int t = 0; t < NSTAGE - 1; ++t) issue(t);
    // q, scaled to base 2, while the first tiles are in flight
    const T* qb = q + ((size_t)b * H + (size_t)kh * G) * HD;
    // heads G .. GMAX-1 are zeros: every lane runs all GMAX chains, no branches
    for (int e = tid; e < GMAX * HD; e += THREADS)
      Qs[e] = e < G * HD ? to_f32(qb[e]) * scale_log2 : 0.f;
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      issue(t + NSTAGE - 1);  // into the stage that tile t-1 used
      asm volatile("cp.async.wait_group %0;" :: "n"(NSTAGE - 1) : "memory");
      if constexpr (C::NV > 1) __syncwarp();  // other lanes' copies are read too
      const unsigned char* st = ring + (warp * NSTAGE + t % NSTAGE) * C::STAGE;
      const int key0 = k_lo + t * BK + warp * KPW + slot;  // this lane's key of step 0
#pragma unroll
      for (int s0 = 0; s0 < C::STEPS; s0 += P) {
        // scores of P steps for every head: GMAX·P independent chains
        float sc[P][GMAX];
#pragma unroll
        for (int s = 0; s < P; ++s) {
          float kv[E];
          load_key<T, C>(st + ((s0 + s) * R + slot) * C::ROW, vec, kv);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) sc[s][g] = dot_q<C>(Qs + g * HD, vec, kv);
        }
        // sum over the LPK lanes of a key, mask, and the max over the warp's keys
        float mx[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) mx[g] = kNegInf;
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const bool ok = key0 + (s0 + s) * R < k_hi;
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
#pragma unroll
            for (int off = 1; off < LPK; off <<= 1)
              sc[s][g] += __shfl_xor_sync(0xffffffffu, sc[s][g], off);
            sc[s][g] = ok ? sc[s][g] : kNegInf;
            mx[g] = fmaxf(mx[g], sc[s][g]);
          }
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
#pragma unroll
          for (int off = LPK; off < 32; off <<= 1)
            mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
          if (mx[g] > m[g]) {  // the same in every lane of the warp
            const float alpha = fast_exp2(m[g] - mx[g]);
            l[g] *= alpha;
#pragma unroll
            for (int j = 0; j < E; ++j) acc[g][j] *= alpha;
            m[g] = mx[g];
          }
        }
        // p·v: GMAX·VEC independent accumulators
#pragma unroll
        for (int s = 0; s < P; ++s) {
          float vv[E];
          load_key<T, C>(st + (KPW + (s0 + s) * R + slot) * C::ROW, vec, vv);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            const float p = sc[s][g] == kNegInf ? 0.f : fast_exp2(sc[s][g] - m[g]);
            l[g] += p;
#pragma unroll
            for (int j = 0; j < E; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
          }
        }
      }
    }
  }

  if constexpr (C::ALIAS) {  // the merge area is the rings': every warp must be done
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
  // this warp's sums over its key slots, then the 4 warps merged by log-sum-exp
  const int vec = lane % LPK;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int j = 0; j < E; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
    }
    if (lane == 0) {
      Wm[warp * GMAX + g] = m[g];
      Wl[warp * GMAX + g] = l[g];
    }
    if (lane < LPK) {
#pragma unroll
      for (int j = 0; j < E; ++j)
        Wacc[(warp * GMAX + g) * HD + (vec + LPK * (j / C::VEC)) * C::VEC + j % C::VEC] =
            acc[g][j];
    }
  }
  __syncthreads();

  const size_t bk = (size_t)b * K + kh;
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, Wm[w * GMAX + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = fast_exp2(Wm[w * GMAX + g] - M);
      L = fmaf(Wl[w * GMAX + g], wt, L);
      A = fmaf(Wacc[(w * GMAX + g) * HD + d], wt, A);
    }
    if (n_split == 1) {
      o[(bk * G + g) * HD + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
      if (lse != nullptr && d == 0) lse[bk * G + g] = row_lse(M, L);
    } else {
      // partial (b, kh, split): m and l for each head, then acc (G × HD)
      float* pp = part + (bk * n_split + split) * G * (HD + 2);
      pp[2 * G + e] = A;
      if (d == 0) {
        pp[2 * g] = M;
        pp[2 * g + 1] = L;
      }
    }
  }
}

// Merges the n_split partials of each (b, kv head) by the log-sum-exp rule:
// a warp per head finds the largest m and each split's weight exp2(m - M)
// (into shared memory) and the weighted sum of l; then each thread sums its
// output elements over the splits, whose loads are independent.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                      float* __restrict__ lse, int K, int G, int n_split) {
  extern __shared__ float wsm[];  // G × n_split weights, then G sums
  float* Ls = wsm + G * n_split;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bk = (size_t)blockIdx.y * K + blockIdx.x;
  const int stride = G * (HD + 2);  // floats of one split's partial
  const float* pb = part + bk * n_split * stride;
  for (int g = warp; g < G; g += WARPS) {
    float M = kNegInf;
    for (int s = lane; s < n_split; s += 32) M = fmaxf(M, pb[s * stride + 2 * g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float wt = fast_exp2(pb[s * stride + 2 * g] - M);
      wsm[g * n_split + s] = wt;
      L = fmaf(pb[s * stride + 2 * g + 1], wt, L);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) {
      Ls[g] = L;
      if (lse != nullptr) lse[bk * G + g] = row_lse(M, L);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * HD; e += THREADS) {
    const int g = e / HD;
    const float* ws = wsm + g * n_split;
    const float* pa = pb + 2 * G + e;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) A = fmaf(pa[s * stride], ws[s], A);
    o[bk * G * HD + e] = from_f32<T>(A / fmaxf(Ls[g], 1e-30f));
  }
}

template <typename T, int HD, int GMAX>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* kv_len, void* o,
                   float* part, float* lse, int B, int S, int K, int G, int n_split, int split_len,
                   float sm_scale, cudaStream_t stream) {
  using C = Cfg<T, HD, GMAX>;
  if constexpr (C::SMEM > 48 * 1024) {  // set once: it costs host time on every call
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_split_kernel<T, HD, GMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
  }
  decode_split_kernel<T, HD, GMAX><<<dim3(n_split, K, B), THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), kv_len,
      static_cast<T*>(o), part, lse, S, K, G, split_len, sm_scale * kLog2e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int merge_smem = G * (n_split + 1) * (int)sizeof(float);
  if (merge_smem > 48 * 1024) return cudaErrorInvalidValue;  // n_split > 750: not planned
  decode_combine_kernel<T, HD><<<dim3(K, B), THREADS, merge_smem, stream>>>(
      part, static_cast<T*>(o), lse, K, G, n_split);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(const void* q, const void* kc, const void* vc, const int* kv_len,
                       void* o, float* part, float* lse, int B, int S, int K, int G, int n_split,
                       int split_len, float sm_scale, cudaStream_t st) {
  if (G <= 4)
    return launch<T, HD, 4>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
  if (G <= 8)
    return launch<T, HD, 8>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
  if (G <= 12)  // nemotron-4-340b: 96 heads over 8
    return launch<T, HD, 12>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
  return launch<T, HD, 16>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* kc, const void* vc, const int* kv_len,
                        void* o, float* part, float* lse, int B, int S, int K, int G, int hd,
                        int n_split, int split_len, float sm_scale, cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
    case 32: return dispatch_g<T, 32>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
    case 64: return dispatch_g<T, 64>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
    case 128: return dispatch_g<T, 128>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
    case 192: return dispatch_g<T, 192>(q, kc, vc, kv_len, o, part, lse, B, S, K, G, n_split, split_len, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,hd), caches (B,S,K,hd), kv_len (B,) int32, o (B,H,hd), all
// contiguous; q, caches and o of one dtype. The kv axis is cut into
// n_split ranges of split_len keys (a multiple of 64, n_split·split_len >= S);
// with n_split > 1, `part` is fp32 scratch of B·K·n_split·G·(hd+2) floats,
// otherwise it is not read. Unless `lse` is null it receives each row's
// log-sum-exp of its scaled scores, fp32 (B,H), -inf for a row that sees no
// key. Returns cudaGetLastError().
extern "C" int decode_attention_fwd(const void* q, const void* k_cache, const void* v_cache,
                                    const void* kv_len, void* o, void* part, void* lse,
                                    int dtype, int B,
                                    int S, int H, int K, int hd, int n_split, int split_len,
                                    float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || H / K > MAX_G || n_split <= 0 ||
      split_len <= 0 || split_len % BK != 0 || (long long)n_split * split_len < S ||
      (n_split > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const int G = H / K;
  const int* len = static_cast<const int*>(kv_len);
  float* scratch = static_cast<float*>(part);
  float* row_sums = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_hd<float>(q, k_cache, v_cache, len, o, scratch, row_sums, B, S, K, G, hd,
                              n_split, split_len, sm_scale, st);
  if (dtype == repro::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(q, k_cache, v_cache, len, o, scratch, row_sums, B, S, K,
                                      G, hd, n_split, split_len, sm_scale, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the split kernel for dtype (0 f32, 1 bf16), head
// dim hd and head group gmax (4, 8, 12, 16), or 0 for what it does not take;
// for the build record.
template <typename T>
int smem_of(int hd, int gmax) {
  auto pick = [gmax](auto c4, auto c8, auto c12, auto c16) {
    return gmax == 4 ? decltype(c4)::SMEM : gmax == 8 ? decltype(c8)::SMEM
           : gmax == 12 ? decltype(c12)::SMEM : gmax == 16 ? decltype(c16)::SMEM : 0;
  };
  switch (hd) {
    case 16: return pick(Cfg<T, 16, 4>{}, Cfg<T, 16, 8>{}, Cfg<T, 16, 12>{}, Cfg<T, 16, 16>{});
    case 32: return pick(Cfg<T, 32, 4>{}, Cfg<T, 32, 8>{}, Cfg<T, 32, 12>{}, Cfg<T, 32, 16>{});
    case 64: return pick(Cfg<T, 64, 4>{}, Cfg<T, 64, 8>{}, Cfg<T, 64, 12>{}, Cfg<T, 64, 16>{});
    case 128:
      return pick(Cfg<T, 128, 4>{}, Cfg<T, 128, 8>{}, Cfg<T, 128, 12>{}, Cfg<T, 128, 16>{});
    case 192:
      return pick(Cfg<T, 192, 4>{}, Cfg<T, 192, 8>{}, Cfg<T, 192, 12>{}, Cfg<T, 192, 16>{});
  }
  return 0;
}

extern "C" int decode_attention_smem_bytes(int dtype, int hd, int gmax) {
  if (dtype == repro::kFloat32) return smem_of<float>(hd, gmax);
  if (dtype == repro::kBFloat16) return smem_of<__nv_bfloat16>(hd, gmax);
  return 0;
}
