// bf16 helpers shared by the attention forward (dense_attn_fwd.cu), its
// backward (dense_attn_bwd.cu) and the kernels for heads wider than 2048
// (dense_attn_scores.cu), whose P and dS are computed by one code path in
// every direction (p_pair, ds_pair: the same roundings), and by the fused
// FFN (ffn_fwd.cu, ffn_bwd.cu). allow_smem, at the end, is the one grant
// of dynamic shared memory every kernel uses.
//
// A warp's share of a wgmma accumulator has mma.sync m16n8k16's C layout
// (lane = 4 g + t): c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1] of
// each 8-column n-tile; a register A operand has its A layout, a0 =
// A[g][2t..2t+1], a1 = A[g+8][2t..2t+1], a2 = A[g][2t+8..], a3 =
// A[g+8][2t+8..]. So two neighbouring n-tiles of an accumulator, packed
// as bf16 pairs, are the A operand of one 16-deep product, without going
// through shared memory.

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

// P of two neighbouring columns: exp2 of the bf16-rounded base-2 logit,
// rounded to bf16, the roundings of the TPU kernel's bf16 softmax pass
// (denseattn.py:422, 468), below 2^-126 flushed to 0 (see ex2_ftz);
// packed as bf16x2 in the layout of a wgmma A fragment (the header's):
// each rounding to bf16 is one conversion for two values.
// Conversions issue at a fraction of the FMA rate; one value per
// conversion set the time of the first attention kernels.
__device__ __forceinline__ uint32_t p_pair(float x0, float x1) {
  const uint32_t a = pack_bf16(x0, x1);
  return pack_bf16(ex2_ftz(bf16_lo(a)), ex2_ftz(bf16_hi(a)));
}

// dS = round(P * round(round(dP) - delta)) for two columns, with P and
// delta packed bf16x2. The bf16x2 subtract and multiply round their exact
// results once; on bf16 operands that is what the f32 operation followed
// by a rounding to bf16 gives (the f32 difference of two bf16 values is
// exact, or within 2^-16 of the larger one; their product is exact).
// ds_packed takes dP already rounded and packed (dpr).
__device__ __forceinline__ uint32_t ds_packed(uint32_t p, uint32_t dpr, uint32_t dd) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                                   __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&dpr),
                                           *reinterpret_cast<const __nv_bfloat162*>(&dd)));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t ds_pair(uint32_t p, float dp0, float dp1, uint32_t dd) {
  return ds_packed(p, pack_bf16(dp0, dp1), dd);
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
