// Launchers of the f32 attention kernels for heads of 192 and wider
// (dense_attn_tf32_wide.cu), called by the dispatch of vst_dense_attn_fwd
// (dense_attn_fwd.cu) and vst_dense_attn_bwd (dense_attn_bwd.cu).

#pragma once

#include <cuda_runtime.h>

namespace vst {

// O and LSE2 of f32 q, k, v at any D % 64 == 0 from 192 up; the layout
// and preconditions of vst_dense_attn_fwd.
cudaError_t launch_attn_fwd_tf32_wide(const float* q, const float* k, const float* v, float* o,
                                      float* lse, int B, int H, int N, int D, long long sb,
                                      long long sn, long long sh, long long ob, long long on,
                                      long long oh, float qscale, cudaStream_t st);

// dK/dV, then dQ, of f32 inputs at any D % 64 == 0 from 192 up, from LSE2
// and delta (the preprocess has run); the layout and preconditions of
// vst_dense_attn_bwd.
cudaError_t launch_attn_bwd_tf32_wide(const float* q, const float* k, const float* v,
                                      const float* d_o, const float* lse, const float* delta,
                                      float* dq, float* dk, float* dv, int B, int H, int N,
                                      int D, long long sb, long long sn, long long sh,
                                      long long ob, long long on, long long oh, float qscale,
                                      float scale, cudaStream_t st);

}  // namespace vst
