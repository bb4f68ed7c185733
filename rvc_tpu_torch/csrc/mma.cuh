// Tensor-core building blocks shared by the kernels that keep float32-level
// agreement through split-precision products (nearest_rows.cu,
// resblock_group.cu), for sm_90a.
//
// Hopper's tensor cores take bf16 (989 TFLOP/s dense) or TF32 (495 TFLOP/s)
// operands and accumulate in float32; the card's float32 pipes outside them
// give 67 TFLOP/s. A float32 operand is written as a sum of pieces that the
// tensor cores take exactly, and the product as a few piece products:
//   - bf16: x = hi + mid + lo, three bf16 pieces of 8 significant bits each
//     (split_bf16x3). An int8 value is bf16-exact, so against an int8 operand
//     the three products hi.b + mid.b + lo.b give every product exactly.
//   - TF32: x = big + small + e, two TF32 pieces of 11 significant bits each,
//     big = tf32_round(x) and small = tf32_round(x - big) (split_tf32), with
//     |e| <= 2^-22 |x|. a.b ~ a_big.b_big + a_big.b_small + a_small.b_big;
//     the dropped a_small.b_small and the two residuals are each about 2^-22
//     of |a.b|, float32's own rounding scale (2^-24) within a factor 4.
// Products of pieces are exact in float32 (8 x 8 or 11 x 11 bits); what
// differs from a float32 dot product is only the order of the sums.
//
// The mma.sync fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16
// / m16n8k8"), lane = 4 g + t:
//   m16n8k16 bf16: A (16 x 16, row) a0a1 (row g, k 2t..2t+1), a2a3 (row g+8,
//     same k), a4a5 (row g, k 2t+8..2t+9), a6a7 (row g+8, same k); B (16 x 8,
//     col) b0b1 (k 2t..2t+1, col g), b2b3 (k 2t+8..2t+9, col g).
//   m16n8k8 tf32: A a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4),
//     a3 (row g+8, k t+4); B b0 (k t, col g), b1 (k t+4, col g).
//   Both: C c0 c1 (row g, cols 2t, 2t+1), c2 c3 (row g+8, same cols).
// A dot product does not depend on the order of k, so the kernels relabel k
// within a fragment so that each lane's values are adjacent in memory (one
// vector load per row): for bf16, k 2t+{0,1} is stored at 4t+{0,1} and
// k 2t+8+{0,1} at 4t+{2,3}; for TF32, k t at 2t and k t+4 at 2t+1. A and B
// use the same relabelling.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// The products are not volatile: the compiler may interleave them with the
// loads and with other accumulators' products. Callers order their products
// so that consecutive ones update different accumulators (one mma's result
// takes tens of cycles).
//
// Measured behaviour to keep in mind: like earlier tensor cores, Hopper's
// mma.sync adds the products and the accumulator with a truncated alignment
// rather than a rounded float32 add, so a long chain of mma into one
// accumulator drifts by up to an ulp of the running sum per step. Kernels
// that sum thousands of products per output add each chunk's fresh partial
// sum into float32 registers instead (resblock_group.cu).

// d += a . b, m16n8k16, bf16 operands, float32 accumulator
__device__ __forceinline__ void bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, m16n8k8, TF32 operands, float32 accumulator
__device__ __forceinline__ void tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy that bypasses L1 (.cg); with src_bytes 0 it
// writes 16 zero bytes and reads nothing (rows past the end of an operand).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes = 16) {
  const unsigned int dst = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 (10 stored mantissa bits) to nearest, ties away from
// zero, as the bits of a float32 whose low 13 bits are zero: half of the
// dropped bits' weight is added to the magnitude bits, then they are cleared
// (what cvt.rna.tf32.f32 computes, in two integer operations). x -
// tf32_round(x) is exact in float32 and at most 2^-11 |x| (finite x).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small + e: big = tf32_round(x), small = tf32_round(x - big), and
// |e| <= 2^-11 |x - big| <= 2^-22 |x| (normal x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// Two floats as a bf16x2 register, rounded to nearest even; the first in the
// low half (the lower k of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The pieces of two floats (x0 in the low halves): x = hi + mid + lo with each
// piece bf16. hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); each
// subtraction is exact in float32 and each piece takes the next 8 significant
// bits, so hi + mid + lo == x exactly for normal x whose pieces stay normal
// (|x| above ~2^-110, far below any operand here).
__device__ __forceinline__ void split_bf16x3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                             uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  mid = pack_bf16(r0, r1);
  const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(&mid);
  lo = pack_bf16(r0 - __low2float(m), r1 - __high2float(m));
}

// Four int8 values (bytes 0..3 of w) as two bf16x2 registers, bytes 0, 1 in
// lo01 and bytes 2, 3 in lo23. Exact: |v| <= 127 needs 7 bits. Each byte,
// biased to 0..255, is put in the mantissa of 2^23 (a float whose unit is 1)
// and the bias 2^23 + 128 is subtracted, also exactly.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo01, uint32_t& lo23) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.f;  // 2^23 + 128
  const float v0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  const float v1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  const float v2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  const float v3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
  lo01 = pack_bf16(v0, v1);
  lo23 = pack_bf16(v2, v3);
}

}  // namespace mma
