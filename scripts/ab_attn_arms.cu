// The compile-time arms of the bf16 attention kernels at D = 64 (K1, the
// packed forward; K2, the packed backward) for scripts/ab_attn_arms.py,
// which compiles this file into a library of its own, build/ab_attn_arms/:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//        -c -DVST_ARMS_FWD -o fwd.o scripts/ab_attn_arms.cu
//   nvcc ... -c -o bwd.o scripts/ab_attn_arms.cu
//   (and the package's dense_attn_scores.cu and dense_attn_tf32_wide.cu,
//   which the included sources call), then one link with -shared.
//
// Each half includes one of the package's sources (the two define names
// of their own in the same anonymous namespace, so they cannot share a
// translation unit), and with it the package's kernels; the arms are the
// hooks of those sources (dense_attn_fwd.cu: FwdArm, fwd_wgmma_block;
// dense_attn_bwd.cu: BwdArm, dkdv_wgmma_block, dq_wgmma_block),
// instantiated here and nowhere in the package. The TPU functions they
// port:
//   scripts/ab_attn_ablate.py:106 call        K2 strips (kBwdNoExp ... kBwdNoDk)
//   scripts/ab_attn_ablate8.py:139 call_bwd_fused   kBwdDfuse, kBwdLfuse, kBwdBfuse
//   scripts/ab_attn_bwd.py:113 call_bwd_fused       kBwdFusedE16, kBwdFusedE32
//   scripts/ab_attn_ablate5.py:101 call_fwd_bf16max kFwdBf16Max
//   scripts/ab_attn_ablate6.py:78 call_fwd    K1 strips (kFwdNoExp ... kFwdSOnly)
//   scripts/ab_attn_ablate7.py:28 call_fwd_bq the package's forward at NC = 1
//                                             and 2 (64 or 128 queries a block)
//   scripts/ab_attn_ablate5.py:45 call_bwd_bq kBwdRows64, the package's
//                                             backward in blocks of 64 rows
// Arm 0 of either entry point is the package's own launch path.

#if defined(VST_ARMS_FWD)

#include "../vae_song_tpu_torch/csrc/dense_attn_fwd.cu"

namespace {

template <int NC, int kArm>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
dense_attn_fwd_arm_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                          float* __restrict__ lse, int H, int N, long long ob, long long on,
                          long long oh, float qscale) {
  fwd_wgmma_block<64, NC, kArm>(&mq, &mk, &mv, o, lse, H, N, ob, on, oh, qscale);
}

template <int NC, int kArm>
cudaError_t launch_fwd_arm(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                           void* o, void* lse, int B, int H, int N, long long ob, long long on,
                           long long oh, float qscale, cudaStream_t st) {
  if constexpr (kArm == kFwdFull) {
    return launch_fwd_wgmma_nc<64, NC>(mq, mk, mv, o, lse, B, H, N, ob, on, oh, qscale, st);
  } else {
    constexpr size_t smem = FwdSmem<64, NC>::bytes;
    const cudaError_t err = vst::allow_smem(dense_attn_fwd_arm_kernel<NC, kArm>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + 64 * NC - 1) / (64 * NC), H, B);
    dense_attn_fwd_arm_kernel<NC, kArm><<<grid, 128 * (NC + 1), smem, st>>>(
        mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), H, N, ob, on, oh, qscale);
    return cudaGetLastError();
  }
}

template <int NC>
cudaError_t launch_fwd_arm_nc(int arm, const CUtensorMap& mq, const CUtensorMap& mk,
                              const CUtensorMap& mv, void* o, void* lse, int B, int H, int N,
                              long long ob, long long on, long long oh, float qscale,
                              cudaStream_t st) {
#define VST_ARM(A) \
  case A:          \
    return launch_fwd_arm<NC, A>(mq, mk, mv, o, lse, B, H, N, ob, on, oh, qscale, st)
  switch (arm) {
    VST_ARM(kFwdFull);
    VST_ARM(kFwdBf16Max);
    VST_ARM(kFwdNoExp);
    VST_ARM(kFwdNoMax);
    VST_ARM(kFwdNoPv);
    VST_ARM(kFwdSOnly);
    default:
      return cudaErrorInvalidValue;
  }
#undef VST_ARM
}

}  // namespace

// The bf16 forward at D = 64 with arm `arm` (FwdArm) at NC consumer
// warpgroups a block (1 or 2; 0: the package's choice), on q, k, v, o, lse
// as vst_dense_attn_fwd takes them. Returns cudaGetLastError() after the
// launch.
extern "C" int vst_attn_arm_fwd(int arm, int nc, const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int N, long long sb,
                                long long sn, long long sh, long long ob, long long on,
                                long long oh, float qscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % 64 != 0 || arm < 0 || arm >= kFwdArms || nc < 0 || nc > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!vst::bhnd_tensor_map(&mq, q, B, N, H, 64, sb, sn, sh) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, 64, sb, sn, sh) ||
      !vst::bhnd_tensor_map(&mv, v, B, N, H, 64, sb, sn, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nc == 0) {   // launch_fwd_wgmma's rule
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    nc = (long long)B * H * ((N + 127) / 128) < sms ? 1 : 2;
  }
  return static_cast<int>(
      nc == 1 ? launch_fwd_arm_nc<1>(arm, mq, mk, mv, o, lse, B, H, N, ob, on, oh, qscale, st)
              : launch_fwd_arm_nc<2>(arm, mq, mk, mv, o, lse, B, H, N, ob, on, oh, qscale, st));
}

#else  // the backward's half

#include "../vae_song_tpu_torch/csrc/dense_attn_bwd.cu"

namespace {

// A fold arm's preprocess: the package's (delta, qc) as its
// attn_bwd_preprocess_kernel<bf16, 64> computes them (its body, copied
// here so that the package's kernel stays as it was), then the row's
// folded constants as columns 0 and 1 of a [B H N, 16] bf16 scratch, row
// (b H + h) N + n, zeros in the rest: LSE2 as -hi, -lo into aug_l (hi =
// bf16(LSE2), lo = bf16(LSE2 - hi)); delta as -bf16(delta) (kBwdDfuse,
// kBwdBfuse) or as -hi, -lo of the unrounded f32 row sum (kBwdFused*) into
// aug_d.
__device__ __forceinline__ bf16 fold_column(float x, int lane, bool split) {
  const float hi = round_bf16(x);
  return __float2bfloat16_rn(lane == 0 ? -hi : (lane == 1 && split) ? -(x - hi) : 0.f);
}

template <int kArm>
__global__ void __launch_bounds__(32 * kPreRows)
attn_bwd_preprocess_fold_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o,
                                const bf16* __restrict__ q, bf16* __restrict__ qc,
                                float* __restrict__ delta, const float* __restrict__ lse,
                                bf16* __restrict__ aug_l, bf16* __restrict__ aug_d, int H, int N,
                                long long rows, Strides s, Strides os, float qscale) {
  constexpr int E = 64 / 32;
  const long long r = (long long)blockIdx.x * kPreRows + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int h = r % H;
  const int n = (r / H) % N;
  const long long b = r / ((long long)H * N);
  const long long off = b * os.b + n * os.n + h * os.h + lane * E;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc = fmaf(to_f(d_o[off + e]), to_f(o[off + e]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[(b * H + h) * N + n] = round_bf16(acc);
  const long long qoff = b * s.b + n * s.n + h * s.h + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e)
    qc[off + e] = __float2bfloat16_rn(__bfloat162float(q[qoff + e]) * qscale);
  if (lane >= 16) return;
  const long long row = (b * H + h) * N + n;
  if constexpr (folds_lse(kArm)) aug_l[row * 16 + lane] = fold_column(lse[row], lane, true);
  if constexpr (folds_delta(kArm))
    aug_d[row * 16 + lane] = fold_column(acc, lane, kArm == kBwdFusedE16 || kArm == kBwdFusedE32);
}

// The resident rows of arm kArm's blocks, and its threads (a consumer
// warpgroup each 64 rows, and the producer's).
template <int kArm>
__host__ __device__ constexpr int arm_rows() {
  return kArm == kBwdRows64 ? 64 : kBlockRows;
}
template <int kArm>
__host__ __device__ constexpr int arm_threads() {
  return 128 * (arm_rows<kArm>() / 64 + 1);
}

template <int kArm>
__global__ void __launch_bounds__(arm_threads<kArm>(), 1)
attn_bwd_dkdv_arm_kernel(const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mqc,
                         const __grid_constant__ CUtensorMap mdo,
                         const __grid_constant__ CUtensorMap aug_l,
                         const __grid_constant__ CUtensorMap aug_d,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N,
                         Strides os) {
  dkdv_wgmma_block<64, kArm, arm_rows<kArm>()>(&mk, &mv, &mqc, &mdo, &aug_l, &aug_d, lse, delta,
                                               dk, dv, H, N, os);
}

template <int kArm>
__global__ void __launch_bounds__(arm_threads<kArm>(), 1)
attn_bwd_dq_arm_kernel(const __grid_constant__ CUtensorMap mqc,
                       const __grid_constant__ CUtensorMap mdo,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap aug_l,
                       const __grid_constant__ CUtensorMap aug_d,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int H, int N, Strides os, float scale) {
  dq_wgmma_block<64, kArm, arm_rows<kArm>()>(&mqc, &mdo, &mk, &mv, &aug_l, &aug_d, lse, delta, dq,
                                             H, N, os, scale);
}

// Tensor map over a contiguous [rows, 16] bf16 matrix of folded columns:
// boxes of 16 columns x 64 rows, 32-byte swizzle (sm90.cuh:
// desc_kmajor_sw32 reads them).
bool fold_tensor_map(CUtensorMap* map, const void* base, long long rows) {
  const vst::TensorMapEncodeFn encode = vst::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {16, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kAugRowBytes};
  const cuuint32_t box[2] = {16, 64};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kArm>
cudaError_t launch_bwd_arm(const void* q, const void* k, const void* v, const void* o,
                           const void* d_o, const float* lse, float* delta, void* qc,
                           void* aug_l, void* aug_d, void* dq, void* dk, void* dv, int B, int H,
                           int N, Strides s, Strides os, float qscale, float scale,
                           cudaStream_t st) {
  if constexpr (kArm == kBwdFull) {
    return launch_bwd_wgmma<64>(q, k, v, o, d_o, lse, delta, qc, dq, dk, dv, B, H, N, s, os,
                                qscale, scale, st);
  } else {
    constexpr int kRows = arm_rows<kArm>();
    using Lk = WgmmaSmem<64, true, kArm, kRows>;
    using Lq = WgmmaSmem<64, false, kArm, kRows>;
    CUtensorMap mqc, mdo, mk, mv, ml, md;
    if (!vst::bhnd_tensor_map(&mqc, qc, B, N, H, 64, os.b, os.n, os.h) ||
        !vst::bhnd_tensor_map(&mdo, d_o, B, N, H, 64, os.b, os.n, os.h) ||
        !vst::bhnd_tensor_map(&mk, k, B, N, H, 64, s.b, s.n, s.h) ||
        !vst::bhnd_tensor_map(&mv, v, B, N, H, 64, s.b, s.n, s.h))
      return cudaErrorInvalidValue;
    const long long rows = (long long)B * N * H;
    ml = md = mk;   // unused unless folded
    if ((folds_lse(kArm) && !fold_tensor_map(&ml, aug_l, rows)) ||
        (folds_delta(kArm) && !fold_tensor_map(&md, aug_d, rows)))
      return cudaErrorInvalidValue;
    cudaError_t err;
    if ((err = vst::allow_smem(attn_bwd_dkdv_arm_kernel<kArm>, Lk::bytes)) != cudaSuccess)
      return err;
    if ((err = vst::allow_smem(attn_bwd_dq_arm_kernel<kArm>, Lq::bytes)) != cudaSuccess)
      return err;
    if constexpr (folds(kArm)) {
      attn_bwd_preprocess_fold_kernel<kArm>
          <<<static_cast<unsigned>((rows + kPreRows - 1) / kPreRows), 32 * kPreRows, 0, st>>>(
              static_cast<const bf16*>(o), static_cast<const bf16*>(d_o),
              static_cast<const bf16*>(q), static_cast<bf16*>(qc), delta, lse,
              static_cast<bf16*>(aug_l), static_cast<bf16*>(aug_d), H, N, rows, s, os, qscale);
    } else {
      launch_preprocess<bf16, 64>(q, o, d_o, qc, delta, B, H, N, s, os, qscale, st);
    }
    const dim3 grid((N + kRows - 1) / kRows, H, B);
    attn_bwd_dkdv_arm_kernel<kArm><<<grid, arm_threads<kArm>(), Lk::bytes, st>>>(
        mk, mv, mqc, mdo, ml, md, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
        N, os);
    attn_bwd_dq_arm_kernel<kArm><<<grid, arm_threads<kArm>(), Lq::bytes, st>>>(
        mqc, mdo, mk, mv, ml, md, lse, delta, static_cast<bf16*>(dq), H, N, os, scale);
    return cudaGetLastError();
  }
}

}  // namespace

// The bf16 backward at D = 64 with arm `arm` (BwdArm), on the arguments of
// vst_dense_attn_bwd (bf16, no dS scratch) and, for a fold arm, the
// [B H N, 16] bf16 scratches of the folded columns aug_l (LSE2's) and
// aug_d (delta's), each 16-byte aligned (else unused, may be null).
// Launches the preprocess, the dK/dV and the dQ kernels in order on
// `stream`; returns cudaGetLastError() after the launches.
extern "C" int vst_attn_arm_bwd(int arm, const void* q, const void* k, const void* v,
                                const void* o, const void* d_o, const void* lse, void* delta,
                                void* qc, void* aug_l, void* aug_d, void* dq, void* dk,
                                void* dv, int B, int H, int N, long long sb, long long sn,
                                long long sh, long long ob, long long on, long long oh,
                                float qscale, float scale, void* stream) {
  if (N % 64 != 0 || qc == nullptr || (folds_lse(arm) && aug_l == nullptr) ||
      (folds_delta(arm) && aug_d == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{sb, sn, sh}, os{ob, on, oh};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define VST_ARM(A)                                                                           \
  case A:                                                                                   \
    return static_cast<int>(launch_bwd_arm<A>(q, k, v, o, d_o, l, dl, qc, aug_l, aug_d, dq, \
                                              dk, dv, B, H, N, s, os, qscale, scale, st))
  switch (arm) {
    VST_ARM(kBwdFull);
    VST_ARM(kBwdDfuse);
    VST_ARM(kBwdLfuse);
    VST_ARM(kBwdBfuse);
    VST_ARM(kBwdFusedE16);
    VST_ARM(kBwdFusedE32);
    VST_ARM(kBwdNoExp);
    VST_ARM(kBwdNoDp);
    VST_ARM(kBwdNoDsMul);
    VST_ARM(kBwdNoDq);
    VST_ARM(kBwdNoDk);
    VST_ARM(kBwdRows64);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VST_ARM
}

#endif
