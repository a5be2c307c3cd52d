// Launchers of the f32 attention kernels for heads of 64 and 128
// (dense_attn_tf32.cu), called by the dispatch of vst_dense_attn_fwd
// (dense_attn_fwd.cu) and vst_dense_attn_bwd (dense_attn_bwd.cu).

#pragma once

#include <cuda_runtime.h>

namespace vst {

// Bytes of the forward's scratch at (B, H, N, D), in this order: the split
// halves (big, small) of K f32 [B H, N, D] and of V^T f32 [B H, D, N] (its
// keys in the permuted order of each group of 8). ops/denseattn.py:
// tf32_narrow_fwd_scratch_bytes states the same sum.
inline long long attn_tf32_narrow_fwd_scratch(int B, int H, int N, int D) {
  const long long bhn = (long long)B * H * N;
  return 16 * bhn * D;
}

// Bytes of the backward's scratch, in this order: dS^T f32 [B H, N, N]
// (keys by queries), then the split halves (big, small) of qc and dO f32
// [B H, N, D], of qc^T and dO^T f32 [B H, D, N] (queries permuted) and of
// K^T f32 [B H, D, N]. ops/denseattn.py:tf32_narrow_bwd_scratch_bytes
// states the same sum.
inline long long attn_tf32_narrow_bwd_scratch(int B, int H, int N, int D) {
  const long long bhn = (long long)B * H * N;
  return 4 * bhn * N + 40 * bhn * D;
}

// O and LSE2 of f32 q, k, v at D = 64 or 128; the layout and
// preconditions of vst_dense_attn_fwd, and a scratch of
// attn_tf32_narrow_fwd_scratch(B, H, N, D) bytes, 16-byte aligned.
cudaError_t launch_attn_fwd_tf32(const float* q, const float* k, const float* v, float* o,
                                 float* lse, void* scratch, int B, int H, int N, int D,
                                 long long sb, long long sn, long long sh, long long ob,
                                 long long on, long long oh, float qscale, cudaStream_t st);

// dQ, dK, dV of f32 inputs at D = 64 or 128, from LSE2 and delta (the
// preprocess has run); the layout and preconditions of vst_dense_attn_bwd,
// and a scratch of attn_tf32_narrow_bwd_scratch(B, H, N, D) bytes,
// 16-byte aligned.
cudaError_t launch_attn_bwd_tf32(const float* q, const float* k, const float* v,
                                 const float* d_o, const float* lse, const float* delta,
                                 float* dq, float* dk, float* dv, void* scratch, int B, int H,
                                 int N, int D, long long sb, long long sn, long long sh,
                                 long long ob, long long on, long long oh, float qscale,
                                 float scale, cudaStream_t st);

}  // namespace vst
