// Entry points for scripts/ab_attn_bf16.py --scores-narrow, which compiles
// this file into a library of its own (the package's nvcc flags, with
// dense_attn_scores.cu and dense_attn_tf32_wide.cu):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//        -shared -o ab_attn_scores.so scripts/ab_attn_scores.cu \
//        vae_song_tpu_torch/csrc/dense_attn_scores.cu \
//        vae_song_tpu_torch/csrc/dense_attn_tf32_wide.cu
//
// The package sends bf16 heads wider than 2048 to the kernels over
// written-out scores (dense_attn_scores.cu) and heads of 576 to 2048 to
// the cluster kernels. These entry points take vst_dense_attn_fwd's and
// vst_dense_attn_bwd's arguments and run the kernels over written-out
// scores at any bf16 head width, so that the script can time both
// designs at the same widths. Nothing of the package calls them.

#include "../vae_song_tpu_torch/csrc/dense_attn_bwd.cu"

extern "C" int vst_ab_attn_scores_fwd(int /*is_bf16*/, const void* q, const void* k,
                                      const void* v, void* o, void* lse, void* scratch, int B,
                                      int H, int N, int D, long long sb, long long sn,
                                      long long sh, long long ob, long long on, long long oh,
                                      float qscale, void* stream) {
  return static_cast<int>(vst::launch_attn_fwd_scores(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), scratch, B, H, N, D, sb, sn, sh, ob, on,
      oh, qscale, static_cast<cudaStream_t>(stream)));
}

extern "C" int vst_ab_attn_scores_bwd(int /*is_bf16*/, const void* q, const void* k,
                                      const void* v, const void* o, const void* d_o,
                                      const void* lse, void* delta, void* qc, void* ds, void* dq,
                                      void* dk, void* dv, int B, int H, int N, int D,
                                      long long sb, long long sn, long long sh, long long ob,
                                      long long on, long long oh, float qscale, float scale,
                                      void* stream) {
  return static_cast<int>(launch_bwd_scores(
      q, k, v, o, d_o, static_cast<const float*>(lse), static_cast<float*>(delta), qc, ds, dq,
      dk, dv, B, H, N, D, Strides{sb, sn, sh}, Strides{ob, on, oh}, qscale, scale,
      static_cast<cudaStream_t>(stream)));
}
