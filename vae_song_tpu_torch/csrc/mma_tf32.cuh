// Split-TF32 helpers of the f32 fused FFN's mma.sync kernels (ffn_fwd.cu,
// ffn_bwd.cu, ffn_tf32.cuh) and, for split_tf32 alone, of the f32
// attention's wgmma kernels (tf32_wgmma.cuh: dense_attn_tf32.cu,
// dense_attn_tf32_wide.cu).
//
// The tensor cores take f32 data only as TF32 (10 mantissa bits). An f32
// operand x is carried as two TF32 values, big = rna(x) and small =
// rna(x - big), where rna rounds to the nearest TF32 value, ties away
// from zero (cvt.rna.tf32.f32's rounding; x - big is exact); big + small
// holds x to about 2^-22 relative. A product a b is then
//   a_small b_big + a_big b_small + a_big b_big
// in that order (a_small b_small, below 2^-22 of |a b|, is dropped):
// CUTLASS's OpMultiplyAddFastF32, the arithmetic of PyTorch's
// memory-efficient f32 attention. Here each 8-deep step of a product
// goes into a fresh accumulator that is then added to the running f32
// sum (mma_3xtf32). Three m16n8k8 TF32 products (495 TFLOP/s dense on an
// H100 SXM) give f32-accurate sums at 165 TFLOP/s of f32 work, against
// the FMA units' 67.
//
// mma.sync m16n8k8 (tf32 in, f32 accumulate) fragment layouts, lane =
// 4 g + t:
//   A (16x8, row): a0 = A[g][t],  a1 = A[g+8][t],  a2 = A[g][t+4],  a3 = A[g+8][t+4]
//   B (8x8, col):  b0 = B[t][g],  b1 = B[t+4][g]
//   C (16x8):      c0, c1 = C[g][2t, 2t+1],  c2, c3 = C[g+8][2t, 2t+1]
// The contraction index may be permuted as long as A and B agree, so an
// accumulator tile C (16 rows x 8 columns) is the A operand of a product
// over its 8 columns with no shuffle: A column t is C column 2t (a0 = c0,
// a1 = c2) and A column t + 4 is C column 2t + 1 (a2 = c1, a3 = c3); the
// B operand then takes its row t from index 2t and its row t + 4 from
// index 2t + 1 (mma_b_rows below).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vst {

// x rounded to TF32, to nearest with ties away from zero, as f32 bits
// with the low 13 bits clear: adding half a TF32 ulp to the magnitude
// bits and truncating is that rounding for every finite x (a carry into
// the exponent is the rounding up to the next binade; infinities stay
// infinite, NaNs stay NaN).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The split of x: big = rna(x), small = rna(x - big). The mma reads only
// the top 19 bits of a TF32 operand, so small keeps the half-ulp carry and
// not the mask (one integer operation fewer: integer operations issue at
// half the rate of f32 ones and are most of a split).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// D (16x8 f32) += A (16x8 tf32, row) * B (8x8 tf32, col)
__device__ __forceinline__ void mma_1688(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment as its split: ab = big, as = small.
struct SplitA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA s;
  split_tf32(a0, s.big[0], s.small[0]);
  split_tf32(a1, s.big[1], s.small[1]);
  split_tf32(a2, s.big[2], s.small[2]);
  split_tf32(a3, s.big[3], s.small[3]);
  return s;
}

// The A fragment of an accumulator tile c (16 x 8) for a product over its
// 8 columns, in the permuted order described above.
__device__ __forceinline__ SplitA a_from_acc(const float c[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// D += A B in split TF32: small big, big small, big big into a fresh
// accumulator, which is then added to D in f32 (to nearest). The tensor
// cores round each product's sum toward zero: chained on a running sum,
// that bias grows with the sum's magnitude and the number of steps
// (measured on an H100 80GB HBM3 with D itself as the accumulator, B = 4,
// N = 2048, H = 4, D = 64: 1.1e-5 of max|O| and 1.7e-5 of max|dQ| from a
// float64 version, four to six times the plain f32 version's distance,
// past the bounds chip_smoke.py holds the kernels to). On one step it is
// at most an ulp of that step's sum, and the running sum rounds to
// nearest. mma_3xtf32_fresh leaves the step's fresh accumulator in d, for
// a caller that adds a few steps together before the running sum.
__device__ __forceinline__ void mma_3xtf32_fresh(float d[4], const SplitA& a, uint32_t bb0,
                                                 uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  mma_1688(d, a.small, bb0, bb1);
  mma_1688(d, a.big, bs0, bs1);
  mma_1688(d, a.big, bb0, bb1);
}

__device__ __forceinline__ void mma_3xtf32(float c[4], const SplitA& a, uint32_t bb0,
                                           uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  float d[4];
  mma_3xtf32_fresh(d, a, bb0, bb1, bs0, bs1);
  c[0] += d[0];
  c[1] += d[1];
  c[2] += d[2];
  c[3] += d[3];
}

// The fused FFN's reads of a [rows][ld] f32 shared tile (ffn_tf32.cuh and
// ffn_bwd.cu; ld = 4 (mod 32) keeps every read free of bank conflicts): the
// A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 7, in the standard
// layout; D += A B with B^T the tile's rows n0 .. n0 + 7, columns k0 .. k0
// + 7 (the standard order: S = X Y^T with Y row by row), and D += A B with
// B the tile's rows k0 .. k0 + 7, columns n0 .. n0 + 7, in the permuted
// contraction order of a_from_acc (B row t = tile row k0 + 2t, B row t + 4
// = tile row k0 + 2t + 1: O = P Y with P an accumulator tile); `mul`
// scales each B element before the split.
__device__ __forceinline__ SplitA a_from_smem(const float* tile, int ld, int r0, int c0, int g,
                                              int t) {
  const float* p = tile + (r0 + g) * ld + c0 + t;
  return split_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

__device__ __forceinline__ void mma_b_rows_t(float c[4], const SplitA& a, const float* tile,
                                             int ld, int n0, int k0, int g, int t, float mul) {
  const float* p = tile + (n0 + g) * ld + k0 + t;
  uint32_t bb0, bb1, bs0, bs1;
  split_tf32(p[0] * mul, bb0, bs0);
  split_tf32(p[4] * mul, bb1, bs1);
  mma_3xtf32(c, a, bb0, bb1, bs0, bs1);
}

__device__ __forceinline__ void mma_b_rows(float c[4], const SplitA& a, const float* tile, int ld,
                                           int k0, int n0, int g, int t, float mul) {
  const float* p = tile + (k0 + 2 * t) * ld + n0 + g;
  uint32_t bb0, bb1, bs0, bs1;
  split_tf32(p[0] * mul, bb0, bs0);
  split_tf32(p[ld] * mul, bb1, bs1);
  mma_3xtf32(c, a, bb0, bb1, bs0, bs1);
}

// The reads of the fused FFN's f32 kernels (ffn_fwd.cu, ffn_bwd.cu), whose
// operands lie in shared memory in every layout:
//
// D += A B with B the rows k0 .. k0 + 7 of a [rows][ld] shared tile,
// columns n0 .. n0 + 7, in the standard order (B row t = tile row k0 + t):
// the A operand read by a_from_smem. ld = 8 (mod 16) keeps both reads free
// of bank conflicts.
__device__ __forceinline__ void mma_b_kn(float c[4], const SplitA& a, const float* tile, int ld,
                                         int k0, int n0, int g, int t) {
  const float* p = tile + (k0 + t) * ld + n0 + g;
  uint32_t bb0, bb1, bs0, bs1;
  split_tf32(p[0], bb0, bs0);
  split_tf32(p[4 * ld], bb1, bs1);
  mma_3xtf32(c, a, bb0, bb1, bs0, bs1);
}

// D += A B with B^T the rows n0 .. n0 + 7 of a [rows][ld] shared tile,
// columns k0 .. k0 + 7, in the permuted contraction order of a_from_acc
// (B row t = tile column k0 + 2t, row t + 4 = column k0 + 2t + 1: one
// 8-byte read a lane). ld = 8 (mod 32) keeps it free of bank conflicts.
// (mma_b_nk_pair_fresh: the step's fresh accumulator itself, for a caller
// that adds several steps before the running sum.)
__device__ __forceinline__ void mma_b_nk_pair_fresh(float d[4], const SplitA& a,
                                                    const float* tile, int ld, int n0, int k0,
                                                    int g, int t) {
  const float2 v = *reinterpret_cast<const float2*>(tile + (n0 + g) * ld + k0 + 2 * t);
  uint32_t bb0, bb1, bs0, bs1;
  split_tf32(v.x, bb0, bs0);
  split_tf32(v.y, bb1, bs1);
  mma_3xtf32_fresh(d, a, bb0, bb1, bs0, bs1);
}

// The A fragment (rows i0 .. i0 + 15 of A, contraction k0 .. k0 + 7) of
// A = T^T, T a [rows][ld] shared tile read down its rows k0 .. k0 + 7 at
// columns i0 .. i0 + 15: a product over the rows of two row-major tiles,
// as the weight gradients X^T dH are. ld = 8 (mod 32) keeps it free of
// bank conflicts.
__device__ __forceinline__ SplitA a_from_kn(const float* tile, int ld, int k0, int i0, int g,
                                            int t) {
  const float* p = tile + (k0 + t) * ld + i0 + g;
  return split_a(p[0], p[8], p[4 * ld], p[4 * ld + 8]);
}

// 16-byte asynchronous copy global -> shared (cp.async.cg: L2 only), its
// commit and its wait.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

}  // namespace vst
