// A variant of the bf16 attention backward for heads of 576 to 2048 for
// scripts/ab_attn_bf16.py --cluster, which compiles this file into a
// library of its own (the package's nvcc flags):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -Xcompiler -fPIC -shared -o ab_attn_dq_cluster.so scripts/ab_attn_dq_cluster.cu
//
// It includes the package's kernel source, so the library also holds the
// package's kernels and helpers. The package's backward at those widths is
// the preprocess, the cluster dK/dV kernel (which also writes dS^T to a
// scratch) and a dQ kernel that reads dS^T and computes dQ = scale dS K:
// 10 B H N^2 D of products, no second cluster sum. This variant's dQ
// kernel is the dK/dV kernel's mirror image: a cluster of the same C CTAs
// shares 64 queries, each holding qc and dO on its panels, recomputing
// the partial S and dP over them, summing both over the cluster (two more
// cluster sums a tile) and accumulating dQ on its own panels: 14 B H N^2 D
// in all, the design the first cluster backward had. Its arithmetic
// rounds where the package's does, so its outputs are the same bits, which
// the script checks. Nothing of the package calls it.

#include "../vae_song_tpu_torch/csrc/dense_attn_bwd.cu"

namespace {

// Shared memory of the variant's dQ kernel: ClusterBwdSmem without the row
// vectors (qc and dO resident; the exchange; each warpgroup's cluster-sum
// buffers and ring; the mbarriers: resident, then for each warpgroup
// full[stages], empty[stages], the cluster sum's red and gat).
struct DqClusterSmem {
  static constexpr int kMaxStages = 8;
  static constexpr uint32_t kSlot = WiderBwdSmem::kSlot;
  uint32_t res_b, xch, csum, ring0, bars;
  int stages, wbars;
  size_t bytes;
  __host__ __device__ explicit DqClusterSmem(int C) {
    res_b = 4 * kPanel64;
    xch = 8 * kPanel64;
    csum = xch + 2 * kSlot;
    ring0 = csum + 2 * vst::csum_bytes(C);
    const uint32_t fixed = ring0 + 8 * (1 + 2 * (2 * kMaxStages + 2)) + 1024;
    stages = (232448 - static_cast<int>(fixed)) / static_cast<int>(2 * kPanel64);
    if (stages > kMaxStages) stages = kMaxStages;
    wbars = 2 * stages + 2;
    bars = ring0 + 2 * stages * kPanel64;
    bytes = bars + 8 * (1 + 2 * wbars) + 1024;   // + alignment
  }
};

// The package's dq_wider_consumer on the CTA's PS panels, its score tile
// summed over the cluster between its chain and the exchange.
template <int W, int PO, int PS, int C>
__device__ __forceinline__ void dq_cluster_consumer(uint32_t base, unsigned char* gbase,
                                                  const DqClusterSmem& L, int P, int nk, int q0,
                                                  int of, int N, long long vrow, long long head,
                                                  long long sn, uint32_t res_bar, uint32_t wb,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta,
                                                  bf16* __restrict__ dq, float scale,
                                                  vst::ClusterSum<C> sum) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* xch = reinterpret_cast<uint32_t*>(gbase + L.xch);
  uint32_t* mine = xch + W * (L.kSlot / 4);
  const uint32_t* theirs = xch + (1 - W) * (L.kSlot / 4);
  vst::RingConsumer ring{base + L.ring0 + W * L.stages * kPanel64, kPanel64, wb,
                         wb + 8 * L.stages, L.stages, lane};
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;   // < N: N is a multiple of 64
  const float l0 = lse[vrow + r0], l1 = lse[vrow + r1];
  const float d0 = delta[vrow + r0], d1 = delta[vrow + r1];
  const uint32_t dd0 = vst::pack_bf16(d0, d0), dd1 = vst::pack_bf16(d1, d1);
  float acc[PO][8][4];
#pragma unroll
  for (int p = 0; p < PO; ++p) zero_acc(acc[p]);
  vst::mbar_wait(res_bar, 0);

  for (int it = 0; it < nk; ++it) {
    // S (W = 0) or dP (W = 1): 64 queries x 64 keys
    float x[8][4];
    score_chain<PS>(x, base + (W == 0 ? 0 : L.res_b), P, ring);
    sum(x, tid);
    uint32_t pa[4][4], dpr[4][4];
    if constexpr (W == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pa[j >> 1][(j & 1) * 2] = p_pair(x[j][0] - l0, x[j][1] - l0);
        pa[j >> 1][(j & 1) * 2 + 1] = p_pair(x[j][2] - l1, x[j][3] - l1);
      }
      swap_frags(mine, theirs, pa, dpr, tid);
    } else {
      round_pairs(x, dpr);
      swap_frags(mine, theirs, dpr, pa, tid);
    }

    // dS = P (dP - delta), then dQ += dS K
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = j >> 1, c = (j & 1) * 2;
      sa[i][c] = ds_packed(pa[i][c], dpr[i][c], dd0);
      sa[i][c + 1] = ds_packed(pa[i][c + 1], dpr[i][c + 1], dd1);
    }
    frags_panels<PO>(acc, sa, ring);
    vst::wgmma_wait<0>();
    fence_all<PO>(acc);
    ring.release(PO);
  }

  store_rows<PO>(acc, dq + 64 * of, head, r0, N, sn, t, scale);
}

// Grid (C N / 64, H, B) in clusters of C along x, 384 threads: the dQ
// counterpart. The cluster's CTAs share the block's 64 queries, CTA r
// holding qc and dO on its PR panels and computing dQ there
// (dq_cluster_consumer on the CTA's panels, S summed over the cluster by
// the warpgroups 0, dP by the warpgroups 1); warpgroup 0 on its first
// floor(PR / 2) panels, 1 on the rest. The producer threads 256 and 288
// feed warpgroup 0's and 1's rings: for each key tile the PR panels of K
// (warpgroup 0) or V (1) for the score chain, then the K panels of the
// warpgroup's output share.
template <int C>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dq_cluster_kernel(const __grid_constant__ CUtensorMap mqc,
                           const __grid_constant__ CUtensorMap mdo,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dq, int H, int N, int P, Strides os, float scale) {
  const DqClusterSmem L(C);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L.bars;
  auto wbars = [&](int w) { return res_bar + 8 + w * 8 * L.wbars; };
  const int rank = vst::cluster_rank();
  const int q0 = (blockIdx.x / C) * kStepRows, h = blockIdx.y, b = blockIdx.z;
  const int pf = cluster_first(P, rank), pr = cluster_first(P, rank + 1) - pf;
  const int po0 = pr / 2;
  const int nk = N / kStepRows;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    vst::mbar_init(res_bar, 1);
    for (int w = 0; w < 2; ++w) {
      vst::ring_init(wbars(w), wbars(w) + 8 * L.stages, L.stages, 4);
      vst::mbar_init(wbars(w) + 8 * (L.wbars - 2), 4);
      vst::mbar_init(wbars(w) + 8 * (L.wbars - 1), 4);
    }
    vst::mbar_fence_init();
  }
  __syncthreads();
  const uint32_t xb = wbars(wg < 2 ? wg : 0) + 8 * (L.wbars - 2);
  const uint32_t buf = base + L.csum + (wg < 2 ? wg : 0) * vst::csum_bytes(C);
  vst::ClusterSum<C> sum{buf, buf + vst::csum_gat(C), xb, xb + 8, rank, 0};
  if (wg < 2) sum.arm(threadIdx.x & 127);
  vst::cluster_sync();   // every CTA's barriers are ready before any remote store

  if (wg == 2) {   // producer
    vst::regs_dealloc<24>();
    const int lt = threadIdx.x - 256;
    if (lt == 0 || lt == 32) {
      const int w = lt / 32;
      const uint32_t full0 = wbars(w), empty0 = full0 + 8 * L.stages;
      const uint32_t slots = base + L.ring0 + w * L.stages * kPanel64;
      if (w == 0) {
        vst::mbar_arrive_expect_tx(res_bar, 2 * pr * kPanel64);
        for (int i = 0; i < pr; ++i) {
          vst::tma_load_4d(base + i * kPanel64, &mqc, res_bar, 64 * (pf + i), h, q0, b);
          vst::tma_load_4d(base + L.res_b + i * kPanel64, &mdo, res_bar, 64 * (pf + i), h, q0,
                           b);
        }
      }
      vst::RingCursor c;
      auto push = [&](const CUtensorMap* map, int p, int row) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        vst::mbar_arrive_expect_tx(full0 + 8 * c.stage, kPanel64);
        vst::tma_load_4d(slots + c.stage * kPanel64, map, full0 + 8 * c.stage, 64 * p, h, row,
                         b);
        c.advance(L.stages);
      };
      const int of = w ? pf + po0 : pf, no = w ? pr - po0 : po0;
      for (int it = 0; it < nk; ++it) {
        const int row = it * kStepRows;
        for (int i = 0; i < pr; ++i) push(w == 0 ? &mk : &mv, pf + i, row);
        for (int p = of; p < of + no; ++p) push(&mk, p, row);
      }
      // let the consumer release every stage before leaving
      for (int s = 0; s < L.stages; ++s) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        c.advance(L.stages);
      }
    }
    return;
  }
  vst::regs_alloc<240>();
  const long long vrow = ((long long)b * H + h) * N;
  const long long head = (long long)b * os.b + (long long)h * os.h;
  const int of = wg ? pf + po0 : pf;
#define VST_DQ_ARGS base, gbase, L, pr, nk, q0, of, N, vrow, head, os.n, res_bar, wbars(wg), \
                    lse, delta, dq, scale, sum
  if (wg == 0) {
    if (pr == 2)
      dq_cluster_consumer<0, 1, 2, C>(VST_DQ_ARGS);
    else if (pr == 3)
      dq_cluster_consumer<0, 1, 3, C>(VST_DQ_ARGS);
    else
      dq_cluster_consumer<0, 2, 4, C>(VST_DQ_ARGS);
  } else {
    if (pr == 2)
      dq_cluster_consumer<1, 1, 2, C>(VST_DQ_ARGS);
    else if (pr == 3)
      dq_cluster_consumer<1, 2, 3, C>(VST_DQ_ARGS);
    else
      dq_cluster_consumer<1, 2, 4, C>(VST_DQ_ARGS);
  }
#undef VST_DQ_ARGS
  vst::cluster_sync();   // no CTA leaves while another may still store into it
}


template <int C>
cudaError_t launch_variant(const void* q, const void* k, const void* v, const void* o,
                           const void* d_o, const float* lse, float* delta, void* qc, void* ds,
                           void* dq, void* dk, void* dv, int B, int H, int N, int D, Strides s,
                           Strides os, float qscale, float scale, cudaStream_t st) {
  const ClusterBwdSmem ldkdv(C);
  const DqClusterSmem ldq(C);
  if (ldkdv.stages < kWiderMinStages || ldq.stages < kWiderMinStages) return cudaErrorInvalidValue;
  CUtensorMap mqc, mdo, mk, mv;
  if (!vst::bhnd_tensor_map(&mqc, qc, B, N, H, D, os.b, os.n, os.h) ||
      !vst::bhnd_tensor_map(&mdo, d_o, B, N, H, D, os.b, os.n, os.h) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, D, s.b, s.n, s.h) ||
      !vst::bhnd_tensor_map(&mv, v, B, N, H, D, s.b, s.n, s.h))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = vst::allow_smem(attn_bwd_dkdv_cluster_kernel<C>, ldkdv.bytes)) != cudaSuccess)
    return err;
  if ((err = vst::allow_smem(attn_bwd_dq_cluster_kernel<C>, ldq.bytes)) != cudaSuccess) return err;
  launch_preprocess_wide<bf16>(q, o, d_o, qc, delta, B, H, N, D, s, os, qscale, st);
  const dim3 grid(C * (N / kStepRows), H, B);
  const int P = D / 64;
  if ((err = vst::launch_cluster(attn_bwd_dkdv_cluster_kernel<C>, grid, kWgmmaThreads,
                                 ldkdv.bytes, C, st, mk, mv, mqc, mdo, lse,
                                 static_cast<const float*>(delta), static_cast<bf16*>(dk),
                                 static_cast<bf16*>(dv), static_cast<bf16*>(ds), H, N, P, os)) !=
      cudaSuccess)
    return err;
  return vst::launch_cluster(attn_bwd_dq_cluster_kernel<C>, grid, kWgmmaThreads, ldq.bytes, C,
                             st, mqc, mdo, mk, mv, lse, static_cast<const float*>(delta),
                             static_cast<bf16*>(dq), H, N, P, os, scale);
}

}  // namespace

// vst_dense_attn_bwd's arguments, bf16 at D = 576 to 2048 only
// (cudaErrorInvalidValue otherwise).
extern "C" int vst_ab_attn_bwd_dq_cluster(int is_bf16, const void* q, const void* k,
                                          const void* v, const void* o, const void* d_o,
                                          const void* lse, void* delta, void* qc, void* ds,
                                          void* dq, void* dk, void* dv, int B, int H, int N,
                                          int D, long long sb, long long sn, long long sh,
                                          long long ob, long long on, long long oh, float qscale,
                                          float scale, void* stream) {
  const int P = D / 64;
  if (!is_bf16 || qc == nullptr || ds == nullptr || D % 64 != 0 || P < 9 || P > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{sb, sn, sh}, os{ob, on, oh};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define VST_VARIANT(C) \
  launch_variant<C>(q, k, v, o, d_o, l, dl, qc, ds, dq, dk, dv, B, H, N, D, s, os, qscale, scale, st)
  const int C = cluster_ctas(P);
  const cudaError_t err = C == 3 ? VST_VARIANT(3) : C == 4 ? VST_VARIANT(4) : VST_VARIANT(8);
#undef VST_VARIANT
  return static_cast<int>(err);
}
