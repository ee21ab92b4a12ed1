// Warp-level tile products of the flash kernels that take f32 (at every head
// dim) and bf16 at hd 16 and 32: flash_attention.cu (forward) and
// flash_attention_bwd.cu (dq, dk, dv). Every product runs on the tensor
// cores as mma.sync.m16n8k8 in TF32 at fp32 accuracy (3xTF32, tf32.cuh):
// a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi. A bf16 value is exact in TF32
// (8 mantissa bits of TF32's 10), so its remainder is zero and the terms
// that would multiply it are dropped: bf16 × bf16 (q·kᵀ, dO·vᵀ) is one
// product, fp32 × bf16 (p·v, ds·k, pᵀ·dO, dsᵀ·q) two.
//
// Tiles sit in shared memory in the inputs' type, row r of a tile at
// r·stride<T, HD>(), copied there by cp.async. The stride pads a row by 16
// bytes: for f32, HD + 4 floats, 4 mod 32 banks at every head dim, so each
// fragment load below (lane (g, c) = (lane / 4, lane % 4) reading row g,
// column c, or row 2c, column g) touches 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace repro {

template <typename T, int HD>
__host__ __device__ constexpr int stride() { return HD + 16 / (int)sizeof(T); }

// One operand value as TF32 hi and lo (tf32.cuh's split); a bf16 value is
// its own hi, and its lo is zero (the products that read it are skipped).
__device__ __forceinline__ void split_t(float x, uint32_t& hi, uint32_t& lo) { split(x, hi, lo); }
__device__ __forceinline__ void split_t(__nv_bfloat16 x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}

// d += a·b with a from fp32 (split) and b from T.
template <typename T>
__device__ __forceinline__ void mma_fb(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  if constexpr (std::is_same_v<T, float>) {
    mma3(d, ah, al, bh, bl);
  } else {  // b exact in TF32
    mma(d, al, bh);
    mma(d, ah, bh);
  }
}

// d[n] += A·Bᵀ over columns k .. k+7 (one m16n8k8 k-step), a and b at
// lane (g, c)'s element of rows 0 and 8n.
template <typename T, int ST, int NT>
__device__ __forceinline__ void abt_step(float (&d)[NT][4], const T* a, const T* b, int k) {
  uint32_t ah[4], al[4];
  split_t(a[k], ah[0], al[0]);
  split_t(a[8 * ST + k], ah[1], al[1]);
  split_t(a[k + 4], ah[2], al[2]);
  split_t(a[8 * ST + k + 4], ah[3], al[3]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t bh[2], bl[2];
    split_t(b[8 * n * ST + k], bh[0], bl[0]);
    split_t(b[8 * n * ST + k + 4], bh[1], bl[1]);
    if constexpr (std::is_same_v<T, float>) {
      mma3(d[n], ah, al, bh, bl);
    } else {  // both exact in TF32: one product
      mma(d[n], ah, bh);
    }
  }
}

// acc[n] (16 × 8, C fragment: d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c),
// d3 (g+8, 2c+1)) += A·Bᵀ over HD columns: A's rows 0..15 at A, B's rows
// 8n .. 8n+7 at B, both in shared memory with the tile stride; the product
// of a 16-row tile with NT·8 rows of another (q·kᵀ, dO·vᵀ, k·qᵀ, v·dOᵀ).
//
// The tensor core does not round the sums it accumulates to nearest (it
// truncates). With RN, every two k-steps are summed on the tensor core
// from zero and added to acc by fp32 adds, rounded to nearest, as
// mlstm_chunk_bwd.cu's mma3_rn2 does: the backward needs it, its dq the
// small difference of two sums over p, whose error the truncated hd-long
// logits bias (err/tol 1.17 on nemotron-4-340b's dq at hd 192 without it,
// on the H100). The forward normalises by the same p and does not.
template <typename T, int HD, int NT, bool RN>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* A, const T* B, int g,
                                        int c) {
  constexpr int ST = stride<T, HD>();
  const T* a = A + g * ST + c;
  const T* b = B + g * ST + c;
  if constexpr (RN) {
#pragma unroll 2
    for (int k0 = 0; k0 < HD; k0 += 16) {
      float t[NT][4] = {};
      abt_step<T, ST, NT>(t, a, b, k0);
      abt_step<T, ST, NT>(t, a, b, k0 + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < HD; k += 8) abt_step<T, ST, NT>(acc, a, b, k);
  }
}

// acc[n] (16 × 8, C fragment) += P·V[:, col0 + 8n ..]: P (16 × 8·KS) held in
// registers as C fragments p[j] over keys 8j .. 8j+7, V's rows in shared
// memory with the tile stride. The sum over keys takes them in any order
// as long as A and B agree, so the m16n8k8 k index c stands for key 2c
// and c+4 for key 2c+1: then the A fragment is the C fragment itself
// (a0 = d0, a1 = d2, a2 = d1, a3 = d3), with no shuffle, and B reads rows
// 2c and 2c+1. (p·v, ds·k, pᵀ·dO, dsᵀ·q.)
//
// These are the deep sums (the output over every key, dq over every key,
// dk and dv over every query row of a kv group), and the tensor core does
// not round the sums it accumulates to nearest (it truncates), a bias that
// builds up over thousands of steps. So each call sums its KS k-steps on
// the tensor core from zero and adds them to acc by fp32 adds, rounded to
// nearest, as mlstm_chunk_bwd.cu's mma3_rn2 does.
template <typename T, int HD, int KS, int NN>
__device__ __forceinline__ void mma_pv(float (&acc)[NN][4], const float (&p)[KS][4], const T* V,
                                       int col0, int g, int c) {
  constexpr int ST = stride<T, HD>();
  // column tiles in groups of NG, NG chains of products in flight
  constexpr int NG = NN % 4 == 0 ? 4 : NN % 2 == 0 ? 2 : 1;
  uint32_t ah[KS][4], al[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    split(p[j][0], ah[j][0], al[j][0]);
    split(p[j][2], ah[j][1], al[j][1]);
    split(p[j][1], ah[j][2], al[j][2]);
    split(p[j][3], ah[j][3], al[j][3]);
  }
  const T* v = V + 2 * c * ST + col0 + g;
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += NG) {
    float t[NG][4] = {};
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        uint32_t bh[2], bl[2];
        split_t(v[8 * j * ST + 8 * (n0 + n)], bh[0], bl[0]);
        split_t(v[(8 * j + 1) * ST + 8 * (n0 + n)], bh[1], bl[1]);
        mma_fb<T>(t[n], ah[j], al[j], bh, bl);
      }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += t[n][e];
  }
}

// Two adjacent output values (a C fragment's pair of columns), rounded to
// T as torch rounds (bf16: to nearest even); dst 8-byte aligned for float.
__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// Whether (row, col) is visible: inside both lengths, and the causal and
// window masks (col <= row; col > row - window).
__device__ __forceinline__ bool visible(int row, int col, int Sq, int Skv, int causal,
                                        int window) {
  return row < Sq && col < Skv && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Whether every pair of rows [r0, r0 + nr) and columns [c0, c0 + nc) is
// visible: the tiles that need no mask.
__device__ __forceinline__ bool all_visible(int r0, int nr, int c0, int nc, int Sq, int Skv,
                                            int causal, int window) {
  return r0 + nr <= Sq && c0 + nc <= Skv && (!causal || c0 + nc - 1 <= r0) &&
         (window <= 0 || c0 > r0 + nr - 1 - window);
}

// Whether no pair of rows [r0, r0 + nr) and columns [c0, c0 + nc) is visible.
__device__ __forceinline__ bool all_masked(int r0, int nr, int c0, int nc, int Sq, int Skv,
                                           int causal, int window) {
  return r0 >= Sq || c0 >= Skv || (causal && c0 > r0 + nr - 1) ||
         (window > 0 && c0 + nc - 1 <= r0 - window);
}

}  // namespace repro
