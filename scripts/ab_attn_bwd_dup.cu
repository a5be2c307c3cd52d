// A variant of the bf16 attention backward for heads of 192 and 256 for
// scripts/ab_attn_bf16.py, which compiles this file into a library of its
// own:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -Xcompiler -fPIC -shared -o ab_attn_bwd_dup.so scripts/ab_attn_bwd_dup.cu
//
// It includes the package's kernel source, so the library also holds the
// package's kernels and helpers. attn_bwd_dkdv_dup_kernel is the
// package's split dK/dV kernel (attn_bwd_dkdv_split_kernel) without the
// split scores: both consumer warpgroups compute S^T = K qc^T and dP^T =
// V dO^T over the whole head themselves (no exchange, no barrier between
// them), then accumulate dV and dK on their own panels of the head's
// columns as the package's kernel does. That is 6 products a tile pair
// against its 4: 18 B H N^2 D of tensor-core work in the backward against
// 14. Its arithmetic is the package's, so its outputs are the same bits,
// which the script checks. Nothing of the package calls it.

#include "../vae_song_tpu_torch/csrc/dense_attn_bwd.cu"

namespace {

template <int D, int W>
__device__ __forceinline__ void dkdv_dup_consumer(uint32_t base, unsigned char* gbase, int nq,
                                                  int k0, int N, long long head, long long sn,
                                                  bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using L = SplitSmem<D, true>;   // the package's layout; the exchange unused
  using C = SplitPanels<L::P, W>;
  constexpr int P = L::P, kStages = L::kStages, PW = C::count;
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kStages;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float adk[PW][8][4], adv[PW][8][4];
#pragma unroll
  for (int p = 0; p < PW; ++p) {
    zero_acc(adk[p]);
    zero_acc(adv[p]);
  }
  vst::mbar_wait(res_bar, 0);

  for (int it = 0; it < nq; ++it) {
    const int s = it % kStages;
    vst::mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t qs = base + L::stage0 + s * L::stage_bytes, dos = qs + P * kPanel64;
    const float* ls = reinterpret_cast<const float*>(gbase + L::vec0 + s * 512);
    const float* dls = ls + kStepRows;

    // S^T = K qc^T and dP^T = V dO^T, one commit group each
    float sc[8][4], dp[8][4];
    zero_acc(sc);
    zero_acc(dp);
    vst::fence_acc(sc);
    vst::fence_acc(dp);
    vst::wgmma_fence();
    wgmma_rows<P, kPanel64>(sc, base + L::res_a, qs);
    vst::wgmma_commit();
    wgmma_rows<P, kPanel64>(dp, base + L::res_b, dos);
    vst::wgmma_commit();
    vst::wgmma_wait<1>();
    vst::fence_acc(sc);

    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float l0 = ls[8 * j + 2 * t], l1 = ls[8 * j + 2 * t + 1];
      pa[j >> 1][(j & 1) * 2] = p_pair(sc[j][0] - l0, sc[j][1] - l1);
      pa[j >> 1][(j & 1) * 2 + 1] = p_pair(sc[j][2] - l0, sc[j][3] - l1);
    }
    // dV += P^T dO on this warpgroup's panels, while dP^T finishes
    fence_all<PW>(adv);
    vst::wgmma_fence();
    wgmma_frags_tile<PW>(adv, pa, dos + C::first * kPanel64);
    vst::wgmma_commit();
    vst::wgmma_wait<1>();
    vst::fence_acc(dp);

    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t dd = vst::pack_bf16(dls[8 * j + 2 * t], dls[8 * j + 2 * t + 1]);
      sa[j >> 1][(j & 1) * 2] = ds_pair(pa[j >> 1][(j & 1) * 2], dp[j][0], dp[j][1], dd);
      sa[j >> 1][(j & 1) * 2 + 1] = ds_pair(pa[j >> 1][(j & 1) * 2 + 1], dp[j][2], dp[j][3], dd);
    }
    fence_all<PW>(adk);
    vst::wgmma_fence();
    wgmma_frags_tile<PW>(adk, sa, qs + C::first * kPanel64);
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
    fence_all<PW>(adk);
    fence_all<PW>(adv);
    release_stage(empty0 + 8 * s, lane);
  }

  const int r = k0 + 16 * warp + g;
  store_rows<PW>(adk, dk + 64 * C::first, head, r, N, sn, t, kLn2);
  store_rows<PW>(adv, dv + 64 * C::first, head, r, N, sn, t, 1.f);
}

// attn_bwd_dkdv_split_kernel with dkdv_dup_consumer.
template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dkdv_dup_kernel(const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mqc,
                         const __grid_constant__ CUtensorMap mdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N,
                         Strides os) {
  using L = SplitSmem<D, true>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kStages;
  const int k0 = blockIdx.x * kStepRows, h = blockIdx.y, b = blockIdx.z;
  const int nq = N / kStepRows;
  init_barriers(res_bar, full0, empty0, kStages);
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      const long long vrow = ((long long)b * H + h) * N;
      produce<L::P, kStepRows, kStages, L::stage_bytes, L::tile_tx>(
          &mk, &mv, &mqc, &mdo, lse + vrow, delta + vrow, base + L::res_a, base + L::stage0,
          base + L::vec0, 512, res_bar, full0, empty0, k0, nq, h, b);
    }
    return;
  }
  vst::regs_alloc<240>();
  const long long head = (long long)b * os.b + (long long)h * os.h;
  if (wg == 0)
    dkdv_dup_consumer<D, 0>(base, gbase, nq, k0, N, head, os.n, dk, dv);
  else
    dkdv_dup_consumer<D, 1>(base, gbase, nq, k0, N, head, os.n, dk, dv);
}

}  // namespace

// vst_dense_attn_bwd's arguments, bf16 at D = 192 or 256 only
// (cudaErrorInvalidValue otherwise).
extern "C" int vst_ab_attn_bwd_dup(int is_bf16, const void* q, const void* k, const void* v,
                                   const void* o, const void* d_o, const void* lse, void* delta,
                                   void* qc, void* dq, void* dk, void* dv, int B, int H, int N,
                                   int D, long long sb, long long sn, long long sh, long long ob,
                                   long long on, long long oh, float qscale, float scale,
                                   void* stream) {
  if (!is_bf16 || qc == nullptr || (D != 192 && D != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{sb, sn, sh}, os{ob, on, oh};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  // the package's launch of the split kernels with this dK/dV kernel
  const cudaError_t err =
      D == 192 ? launch_bwd_tma<192>(attn_bwd_dkdv_dup_kernel<192>, SplitSmem<192, true>::bytes,
                                     attn_bwd_dq_split_kernel<192>, SplitSmem<192, false>::bytes,
                                     kStepRows, q, k, v, o, d_o, l, dl, qc, dq, dk, dv, B, H, N,
                                     s, os, qscale, scale, st)
               : launch_bwd_tma<256>(attn_bwd_dkdv_dup_kernel<256>, SplitSmem<256, true>::bytes,
                                     attn_bwd_dq_split_kernel<256>, SplitSmem<256, false>::bytes,
                                     kStepRows, q, k, v, o, d_o, l, dl, qc, dq, dk, dv, B, H, N,
                                     s, os, qscale, scale, st);
  return static_cast<int>(err);
}
