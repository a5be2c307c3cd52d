// The A/B arm of the f32 attention backward at head widths 64 and 128 whose
// dQ kernel recomputes S and dP (scripts/ab_attn_f32.py --dq-recompute):
// the package's split-TF32 dK/dV kernel without its dS^T store, then a dQ
// kernel with the block's 64 queries resident, 14 B H N^2 D executed and
// no [B H, N, N] scratch, against the package's 10 B H N^2 D with dS^T
// written and read back (csrc/dense_attn_tf32.cu). Built by the script
// into build/ab_attn_f32_dq/; the package's library holds none of it.
//
// The dQ kernel mirrors the dK/dV kernel: q (scaled by qscale as each value
// is loaded) and dO raw resident; per tile of keys (the dK/dV kernel's query
// tile: 64 at D = 64, 32 at 128) warpgroup 0 forms S =
// qc K^T and P = exp2(S - LSE2), warpgroup 1 dP = dO V^T and dP - delta
// (each with a fresh accumulator each 8-deep step), they swap the tiles,
// both form dS, and each accumulates dQ += dS K on its half of the head's
// columns (dS the register A operand; K^T with keys permuted, one fresh
// accumulator a tile). The keys stream as ring items: K and V rows split,
// then K^T split.

#include "../vae_song_tpu_torch/csrc/dense_attn_tf32.cu"

namespace {

// Grid (N / 64, H, B), 384 threads, Tf32DkdvSmem<D>'s layout (resident q
// and dO; score items K and V rows; output items K^T, two of four halves).
template <int D>
__global__ void __launch_bounds__(384, 1)
dq_recompute_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mkb, const __grid_constant__ CUtensorMap mks,
                    const __grid_constant__ CUtensorMap mvb, const __grid_constant__ CUtensorMap mvs,
                    const __grid_constant__ CUtensorMap mktb,
                    const __grid_constant__ CUtensorMap mkts, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int H, int N,
                    long long ob, long long on, long long oh, float qscale, float scale) {
  using L = Tf32DkdvSmem<D>;
  constexpr int NP = L::NP, KT = L::kQT, kSlots = L::kSlots, NO = D / 16, KQ = KT / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* xch = reinterpret_cast<float*>(smem_raw + (base - raw) + L::xch0);
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kSlots;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int nk = N / KT;
  if (threadIdx.x == 0) {
    vst::mbar_init(res_bar, 1);
    vst::ring_init(full0, empty0, kSlots, kConsumerWarps);
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    vst::mbar_arrive_expect_tx(res_bar, 2 * L::res);
    for (int p = 0; p < NP; ++p) {
      vst::tma_load_4d(base + p * 64 * 128, &mq, res_bar, 32 * p, h, q0, b);
      vst::tma_load_4d(base + L::res + p * 64 * 128, &mdo, res_bar, 32 * p, h, q0, b);
    }
    vst::RingCursor c;
    for (int i = 0; i < 2 * nk + kSlots; ++i, c.advance(kSlots)) {
      vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
      if (i >= 2 * nk) continue;
      const uint32_t sl = base + L::ring0 + c.stage * L::item, bar = full0 + 8 * c.stage;
      const int k = KT * (i / 2);
      if ((i & 1) == 0) {   // score item: K and V rows
        vst::mbar_arrive_expect_tx(bar, L::item);
        for (int p = 0; p < NP; ++p) {
          const uint32_t at = sl + p * KT * 128;
          vst::tma_load_3d(at, &mkb, bar, 32 * p, k, bh);
          vst::tma_load_3d(at + L::half, &mks, bar, 32 * p, k, bh);
          vst::tma_load_3d(at + 2 * L::half, &mvb, bar, 32 * p, k, bh);
          vst::tma_load_3d(at + 3 * L::half, &mvs, bar, 32 * p, k, bh);
        }
      } else {              // output item: K^T, keys permuted
        vst::mbar_arrive_expect_tx(bar, 2 * L::half);
        for (int pc = 0; pc < KT / 32; ++pc) {
          vst::tma_load_3d(sl + pc * D * 128, &mktb, bar, k + 32 * pc, 0, bh);
          vst::tma_load_3d(sl + L::half + pc * D * 128, &mkts, bar, k + 32 * pc, 0, bh);
        }
      }
    }
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;
  const long long head = (long long)bh * N;
  // warpgroup 0 subtracts LSE2, warpgroup 1 delta, of its rows
  const float* by = (wg == 0 ? lse : delta) + head + q0 + r;
  const float c0 = by[0], c1 = by[8];
  float dqr[NO][4];
  vst::zero_acc(dqr);
  vst::RingConsumer ring{base + L::ring0, L::item, full0, empty0, kSlots, lane};
  const uint32_t a0 = base + wg * L::res, b_off = 2 * wg * L::half;
  const uint32_t o_off = wg * (D / 2) * 128;
  const float mul = wg == 0 ? qscale : 1.f;
  vst::mbar_wait(res_bar, 0);

  for (int it = 0; it < nk; ++it) {
    const uint32_t si = ring.next();
    float x[KQ][4];
    score_steps<NP, KQ>(x, a0, 64 * 128, mul, si + b_off, si + b_off + L::half, KT * 128, r, g,
                        t);
    ring.release(1);
#pragma unroll
    for (int j = 0; j < KQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = x[j][e] - (e < 2 ? c0 : c1);
        x[j][e] = wg == 0 ? exp2f(v) : v;
      }
    float* buf = xch + (it & 1) * (2 * 64 * KT);
#pragma unroll
    for (int j = 0; j < KQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) buf[wg * 64 * KT + (4 * j + e) * 128 + tid] = x[j][e];
    vst::named_sync(1, 256);
    float ds[KQ][4];
#pragma unroll
    for (int j = 0; j < KQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = buf[(1 - wg) * 64 * KT + (4 * j + e) * 128 + tid];
        ds[j][e] = (wg == 0 ? x[j][e] : y) * (wg == 0 ? y : x[j][e]);
      }
    uint32_t db[KQ][4], dsm[KQ][4];
    split_acc<KQ>(ds, db, dsm);
    const uint32_t so = ring.next();
    float dqf[NO][4];
    vst::wgmma_fence();
    tile_products<NO, KQ>(dqf, db, dsm, so + o_off, so + L::half + o_off, D * 128);
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
    vst::fence_acc(dqf);
    ring.release(1);
    add_into(dqr, dqf);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* dst = dq + (long long)b * ob + (long long)(q0 + r + 8 * half) * on + (long long)h * oh +
                 (D / 2) * wg + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(dqr[j][2 * half] * scale, dqr[j][2 * half + 1] * scale);
  }
}

template <int D>
cudaError_t launch_dq_recompute(const float* q, const float* d_o, long long sb, long long sn,
                                long long sh, const float* kr, const float* vr, const float* ktp,
                                const float* lse, const float* delta, float* dq, int B, int H,
                                int N, long long ob, long long on, long long oh, float qscale,
                                float scale, cudaStream_t st) {
  using L = Tf32DkdvSmem<D>;
  const long long bh = (long long)B * H, half = bh * N * D;
  CUtensorMap mq, mdo, mkb, mks, mvb, mvs, mktb, mkts;
  if (!vst::bhnd_tensor_map_f32(&mq, q, B, N, H, D, sb, sn, sh, 64) ||
      !vst::bhnd_tensor_map_f32(&mdo, d_o, B, N, H, D, ob, on, oh, 64) ||
      !vst::heads_tensor_map_f32(&mkb, kr, bh, N, D, L::kQT) ||
      !vst::heads_tensor_map_f32(&mks, kr + half, bh, N, D, L::kQT) ||
      !vst::heads_tensor_map_f32(&mvb, vr, bh, N, D, L::kQT) ||
      !vst::heads_tensor_map_f32(&mvs, vr + half, bh, N, D, L::kQT) ||
      !vst::heads_tensor_map_f32(&mktb, ktp, bh, D, N, D) ||
      !vst::heads_tensor_map_f32(&mkts, ktp + half, bh, D, N, D))
    return cudaErrorInvalidValue;
  const cudaError_t err = vst::allow_smem(dq_recompute_kernel<D>, L::bytes);
  if (err != cudaSuccess) return err;
  dq_recompute_kernel<D><<<dim3(N / 64, H, B), 384, L::bytes, st>>>(
      mq, mdo, mkb, mks, mvb, mvs, mktb, mkts, lse, delta, dq, H, N, ob, on, oh, qscale, scale);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the arm's scratch: the split halves of qc, dO, K and V rows and
// of qc^T, dO^T and K^T (permuted) f32.
extern "C" long long vst_ab_dq_recompute_scratch(int B, int H, int N, int D) {
  return 56ll * B * H * N * D;
}

// dQ, dK, dV of f32 inputs at D = 64 or 128 from LSE2 and delta (given):
// the split pre-pass, the package's dK/dV kernel without the dS^T store,
// then the recomputing dQ kernel. The layout of vst_dense_attn_bwd.
extern "C" int vst_ab_attn_bwd_dq_recompute(const void* q, const void* k, const void* v,
                                            const void* d_o, const void* lse, const void* delta,
                                            void* dq, void* dk, void* dv, void* scratch, int B,
                                            int H, int N, int D, long long sb, long long sn,
                                            long long sh, long long ob, long long on,
                                            long long oh, float qscale, float scale,
                                            void* stream) {
  if (!shapes_ok(B, H, N, D, scratch)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *dof = static_cast<const float*>(d_o);
  const float *l = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  const long long half = (long long)B * H * N * D;
  float* qc = static_cast<float*>(scratch);
  float* dos = qc + 2 * half;
  float* qct = dos + 2 * half;
  float* dot = qct + 2 * half;
  float* kr = dot + 2 * half;
  float* vr = kr + 2 * half;
  float* ktp = vr + 2 * half;
  launch_split(qf, sb, sn, sh, B, H, N, D, qscale, qc, qct, st, true);
  launch_split(dof, ob, on, oh, B, H, N, D, 1.f, dos, dot, st, true);
  launch_split(kf, sb, sn, sh, B, H, N, D, 1.f, kr, ktp, st, true);
  launch_split(vf, sb, sn, sh, B, H, N, D, 1.f, vr, nullptr, st);
  float *dqf = static_cast<float*>(dq), *dkf = static_cast<float*>(dk),
        *dvf = static_cast<float*>(dv);
  cudaError_t err =
      D == 64 ? launch_dkdv<64, false>(kf, vf, sb, sn, sh, qc, dos, qct, dot, l, dl, nullptr, dkf,
                                       dvf, B, H, N, ob, on, oh, st)
              : launch_dkdv<128, false>(kf, vf, sb, sn, sh, qc, dos, qct, dot, l, dl, nullptr, dkf,
                                        dvf, B, H, N, ob, on, oh, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = D == 64 ? launch_dq_recompute<64>(qf, dof, sb, sn, sh, kr, vr, ktp, l, dl, dqf, B, H, N, ob,
                                          on, oh, qscale, scale, st)
                : launch_dq_recompute<128>(qf, dof, sb, sn, sh, kr, vr, ktp, l, dl, dqf, B, H, N,
                                           ob, on, oh, qscale, scale, st);
  return static_cast<int>(err);
}
