// bf16 helpers shared by the attention forward (dense_attn_fwd.cu) and
// backward (dense_attn_bwd.cu), whose P is computed by one code path in
// both directions: p_pair in the wgmma kernels (D = 64 to 256),
// exp2_bf16 in the mma.sync kernels (D > 512), the same
// roundings; and by the fused FFN (ffn_fwd.cu, ffn_bwd.cu). allow_smem,
// at the end, is the one grant of dynamic shared memory every kernel uses.
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate) fragment layouts, lane =
// 4 g + t:
//   A (16x16, row): a0 = A[g][2t..2t+1],  a1 = A[g+8][2t..2t+1],
//                   a2 = A[g][2t+8..],    a3 = A[g+8][2t+8..]
//   B (16x8, col):  b0 = B[2t..2t+1][g],  b1 = B[2t+8..2t+9][g]
//   C (16x8):       c0, c1 = C[g][2t, 2t+1],  c2, c3 = C[g+8][2t, 2t+1]
// So the accumulator of two neighbouring 8-column n-tiles is the A
// operand of one 16-deep product, without going through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace vst {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// P = exp2 of the bf16-rounded base-2 logit, rounded to bf16: the
// roundings of the TPU kernel's bf16 softmax pass (denseattn.py:422, 468).
__device__ __forceinline__ float exp2_bf16(float s_minus_m) {
  return round_bf16(exp2f(round_bf16(s_minus_m)));
}

// The two bf16 values of a packed pair (pack_bf16's lo, hi) as f32.
__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// 2^x by the MUFU unit alone (ex2.approx.ftz.f32). exp2f compiles to the
// same MUFU.EX2 with a halving of x before it and a squaring after it
// for x < -126 only, three more instructions a value; so the two agree
// wherever 2^x >= 2^-126, and below that this gives 0 where exp2f gives
// a subnormal, which adds nothing to an f32 row sum of at least 1.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp2_bf16 of two neighbouring columns (below 2^-126 flushed to 0, see
// ex2_ftz), packed as bf16x2 in the layout of a wgmma A fragment
// (acc_to_a's): each rounding to bf16 is one conversion for two values.
// Conversions issue at a fraction of the FMA rate; one value per
// conversion set the time of the first attention kernels.
__device__ __forceinline__ uint32_t p_pair(float x0, float x1) {
  const uint32_t a = pack_bf16(x0, x1);
  return pack_bf16(ex2_ftz(bf16_lo(a)), ex2_ftz(bf16_hi(a)));
}

// A fragment of one 16-deep chunk kc of a 16 x 64 accumulator block
// (8 n-tiles of 8 columns): columns 16 kc .. 16 kc + 15.
__device__ __forceinline__ void acc_to_a(const float c[][4], int kc, uint32_t a[4]) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// A fragment of rows r0 .. r0 + 15, columns 16 kk .. 16 kk + 15, of a
// [rows][LD] bf16 shared tile.
template <int LD>
__device__ __forceinline__ void load_a_chunk(const __nv_bfloat16 (*tile)[LD], int r0, int kk,
                                             int g, int t, uint32_t a[4]) {
  a[0] = ld_u32(&tile[r0 + g][kk * 16 + 2 * t]);
  a[1] = ld_u32(&tile[r0 + g + 8][kk * 16 + 2 * t]);
  a[2] = ld_u32(&tile[r0 + g][kk * 16 + 2 * t + 8]);
  a[3] = ld_u32(&tile[r0 + g + 8][kk * 16 + 2 * t + 8]);
}

// Dynamic shared memory above the 48 KB a launch gets by default must be
// granted per kernel and device. A grant lasts as long as the process, so
// it is asked for once a kernel, device and size and then remembered (a
// short kernel's call is mostly host path); returns the attribute call's
// error.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> granted;
  const std::lock_guard<std::mutex> hold(mu);
  size_t& have = granted[{reinterpret_cast<const void*>(kernel), device}];
  if (have >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) have = bytes;
  return err;
}

}  // namespace vst
