// Launchers of the bf16 attention kernels for heads wider than 2048
// (dense_attn_scores.cu), called by the dispatch of vst_dense_attn_fwd
// (dense_attn_fwd.cu) and vst_dense_attn_bwd (dense_attn_bwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vst {

// Bytes of the forward's scratch at (B, H, N, D), in this order: S2 f32
// [B H, N, N], P bf16 [B H, N, N], qc bf16 [B, N, H, D] (contiguous),
// 1 / l f32 [B H, N]. ops/denseattn.py:scores_fwd_scratch_bytes states
// the same sum.
inline long long attn_scores_fwd_scratch(int B, int H, int N, int D) {
  const long long bhn = (long long)B * H * N;
  return 6 * bhn * N + 2 * bhn * D + 4 * bhn;
}

// O and LSE2 of bf16 q, k, v at any D % 64 == 0 (and N % 64 == 0); the
// layout and preconditions of vst_dense_attn_fwd, and a scratch of
// attn_scores_fwd_scratch(B, H, N, D) bytes, 16-byte aligned.
cudaError_t launch_attn_fwd_scores(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                                   void* scratch, int B, int H, int N, int D, long long sb,
                                   long long sn, long long sh, long long ob, long long on,
                                   long long oh, float qscale, cudaStream_t st);

// P^T and dS^T into the bf16 scratches pt and dst ([B H, N, N] each, keys
// by queries), then dV = P^T dO and dK = ln2 dS^T qc, from LSE2 and delta
// (the preprocess has run: qc in O's layout); k, v with strides (sb, sn,
// sh, 1), qc, dO, dk, dv with O's (ob, on, oh, 1). dQ = scale dS K is
// dense_attn_bwd.cu's dQ kernel over dst.
cudaError_t launch_attn_bwd_scores(const __nv_bfloat16* k, const __nv_bfloat16* v,
                                   const __nv_bfloat16* qc, const __nv_bfloat16* d_o,
                                   const float* lse, const float* delta, __nv_bfloat16* pt,
                                   __nv_bfloat16* dst, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                   int B, int H, int N, int D, long long sb, long long sn,
                                   long long sh, long long ob, long long on, long long oh,
                                   cudaStream_t st);

}  // namespace vst
