// fp32 products at fp32 accuracy on Hopper's tensor cores (3xTF32), and the
// asynchronous copies that feed them; shared by the mLSTM forward
// (mlstm_chunk.cu), its backward (mlstm_chunk_bwd.cu) and the flash kernels
// that take f32 (flash_attention.cu, flash_attention_bwd.cu, through
// flash_tf32.cuh).
//
// Each operand is split into a TF32 high part (rounded to nearest, ties
// away, as cvt.rna) and the remainder, which the tensor core reads as TF32
// (its low 13 bits dropped); a·b is taken as a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi on mma.sync.m16n8k8 with fp32 accumulation. Only the lo·lo term
// is lost, below 2^-20 of the product.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// 16 bytes from global memory into shared memory, or 16 zero bytes when
// `valid` is false (src must still be a mapped address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
// The same for 4 bytes (one float).
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows 0 .. rows-1 of COLS elements (float, or bf16 for the flash kernels)
// from src (row r at src + r·src_stride) into shared memory (row r at
// dst + r·dst_stride) by cp.async, NT threads sharing the 16-byte pieces;
// rows at or past `valid` are zero-filled. src must point at a real row;
// src, dst and both strides 16-byte aligned.
template <int COLS, int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, int dst_stride, const T* src,
                                          size_t src_stride, int rows, int valid) {
  constexpr int VEC = 16 / sizeof(T);  // elements per piece
  constexpr int PER_ROW = COLS / VEC;
  for (int e = threadIdx.x; e < rows * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const bool ok = r < valid;
    cp16(dst + r * dst_stride + c, ok ? src + r * src_stride + c : src, ok);
  }
}

// x = hi + lo as fp32 bit patterns: hi the TF32 rounding of x (to nearest,
// ties away, as cvt.rna.tf32.f32) and lo the exact remainder, which mma reads
// as TF32 by dropping its low 13 bits (relative error of lo·b below 2^-10).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// d += a·b on one m16n8k8 TF32 tile. Fragments (PTX ISA, and CUTLASS's
// SM80_16x8x8_F32TF32TF32F32_TN), g = lane/4, c = lane%4:
// a0 (g, c), a1 (g+8, c), a2 (g, c+4), a3 (g+8, c+4); b0 (k=c, n=g),
// b1 (k=c+4, n=g); d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b at fp32 accuracy: the small cross terms first, then hi·hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

}  // namespace repro
