// f32 attention forward and backward for Hopper (sm_90a) at head widths
// D % 64 == 0 from 192 up: split-TF32 wgmma/TMA products over written-out
// scores, [B, N, H, D] tensors read through strides.
//
// Replaces: the f32 path (cd = f32, denseattn.py:82-85) of
// vae_song_tpu/ops/denseattn.py:_fwd_kernel (K3f, through _call_fwd) and
// _bwd_kernel (K3b, through _call_bwd) at those widths: SetVAE under
// `mixed_precision: false` with one head of 256 (d_model 256), or wider
// models with one or two heads. The function and its roundings are those
// of dense_attn_fwd.cu and dense_attn_bwd.cu in f32:
//   qc = q * scale * log2e (one f32 multiply), S2 = qc k^T, m = the exact
//   whole-row max, P = exp2(S2 - m), O = P v / rowsum(P),
//   LSE2 = m + log2(rowsum(P));
//   backward: P = exp2(qc k^T - LSE2), dV = P^T dO, dP = dO v^T,
//   dS = P (dP - delta), dQ = dS k scale, dK = dS^T qc ln2,
// with delta = rowsum(dO O) from the backward's preprocess pass.
//
// Split TF32. The tensor cores take f32 data only as TF32 (they read the
// top 19 bits of an operand). Every operand x is carried as big = rna(x)
// and small = rna(x - big) (mma_tf32.cuh: split_tf32), and each 8-deep
// step of a product is three TF32 products, small big, big small, big big
// (small small dropped): f32-accurate sums at a third of the TF32 rate.
// The tensor cores round each product's sum toward zero, so a long chain
// on one accumulator drifts (csrc/mma_tf32.cuh; ROADMAP Queue 3): every
// product here starts a fresh accumulator each 32 columns of a score's
// depth (12 wgmma) and each 64 keys or queries of an output's depth (24
// wgmma), adds it to the running sum in f32 (to nearest), in the order of
// the depth (tests/test_torch_denseattn_f32split.py emulates this order
// and holds it to chip_smoke.py's f32 bounds: a score chain of 64 columns
// comes within 15% of them at N = 2048, an output chain over the whole
// depth misses them 2.4x).
//
// What bounds it here: 4 B H N^2 D operations forward and 10 B H N^2 D
// backward, each made once; at B = 64, H = 1, N = 2048, D = 256, 2.75e11
// and 6.87e11, 1.67 and 4.17 ms as split TF32 (3 x operations at 495
// TFLOP/s). The f32 scores (1 GiB at that shape) and the split operands
// are written and read through device memory: about 3 GB forward and 7
// GB backward, 0.9 and 2.1 ms at 3.35 TB/s, most of it overlapped by the
// products.
//
// Design. TF32 wgmma has no transpose: both shared-memory operands are
// read K-major. So every product is arranged as A (registers) times B
// (shared memory, K-major): A is raw f32, brought by TMA into shared
// memory and split by the consumers as they load it into registers, in
// any layout (row-major, or transposed: dQ's dS read from dS^T); B is split
// ahead, by a pre-pass, into big and small arrays laid out K-major
// ([B H, N, D] for K, qc, dO; [B H, D, N] for V^T, qc^T, dO^T, K^T), so
// that TMA lands both halves ready for the descriptors. The scores are
// written out (as dense_attn_scores.cu does for bf16 wider than 2048), so
// every product is made once:
//   forward   split K and V^T; S2 = qc K^T (A = q, scaled as it is
//             loaded) in 128 x 128 tiles, each tile's row max beside it;
//             O = P V / l with P = exp2(S2 - m) formed from S2 as it is
//             loaded (A), m the max of the tiles' maxima, l the row sum
//             of P, LSE2 = m + log2(l);
//   backward  preprocess (delta); split qc, dO (rows) and qc^T, dO^T, K^T;
//             S^T = K qc^T and dP^T = V dO^T for a 128 x 64 tile (keys by
//             queries), P^T and dS^T written out; dV = P^T dO, dK = dS^T qc
//             ln2, dQ = dS K scale (A = dS^T read transposed).
// The consumers' A fragments and split, the product kernel and the split
// pre-pass live in tf32_wgmma.cuh, which dense_attn_tf32.cu (heads of 64
// and 128) shares. A product kernel's block: 384 threads, consumer
// warpgroups 0 and 1 on
// the tile's rows 0-63 and 64-127 (m64n128k8, or m64n64k8 for the
// backward's scores), a producer warpgroup one thread of which issues the
// TMA loads into a ring of 32-deep stages (A 16 KB raw, B 2 x 16 KB split:
// 4 stages, 192 KB; the backward's scores 3 stages of 64 KB). Blocks are
// persistent (one an SM, walking the tiles in order), so the ring runs on
// across tiles. A stage is given back once its products have completed.
// Ragged edges: N % 64 == 0 and D % 64 == 0, so a 128-row or 128-column
// tile may end 64 past N or D: TMA fills rows past N (a head's own
// dimension in every map) and past D with zeros, and the epilogues store
// nothing there. Nothing grows with D or N in shared memory or registers:
// every D % 64 == 0 from 192 up runs. No atomics, every sum in a fixed
// order: the same bits on every run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_attn_tf32_wide.cuh"
#include "tf32_wgmma.cuh"

namespace {

constexpr int kBwdStages = 3;                        // the backward's scores
constexpr uint32_t kBwdStageBytes = 2 * kPanel128 + 4 * kPanel64;   // K, V; qc, dO halves
constexpr size_t kBwdSmem = kBwdStages * kBwdStageBytes + 16 * kBwdStages + 1024;
constexpr int kScoreQueries = 64;                    // queries of a backward scores tile

// ---- the forward's scores ---------------------------------------------------------

// S2 = qc K^T in 128 x 128 tiles (queries by keys) of every head, `tiles`
// = B H nt^2 (nt = ceil(N / 128)), tile i at key tile i % nt, query tile
// i / nt % nt, head i / nt^2; the depth the head's D / 32 panels. A = q
// (4-D map, 128-row boxes) times qscale as it is loaded (qc, one f32
// multiply); B = K's halves ([B H, N, D] maps). Writes S2 into s_out [B H,
// N, N] and each row's max over the tile's keys into mpart [B H N, nt].
// Lane 4 g + t of warp i of consumer warpgroup w holds rows 64 w + 16 i +
// g and + 8, columns 8 j + 2 t and + 1 (j < 16).
__global__ void __launch_bounds__(kThreads, 1)
tf32_scores_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mkb,
                       const __grid_constant__ CUtensorMap mks, float* __restrict__ s_out,
                       float* __restrict__ mpart, int H, int N, int D, float qscale, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const RingSmem L(smem_raw, kStages, kStageBytes);
  const int nt = (N + kTile - 1) / kTile, np = D / kDepth;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int ct = tile % nt, rt = tile / nt % nt, bh = tile / (nt * nt);
      for (int p = 0; p < np; ++p, ++it) {
        vst::ring_wait_free(L.empty, it, kStages);
        const int s = it % kStages;
        const uint32_t st = L.base + s * kStageBytes, bar = L.full + 8 * s;
        vst::mbar_arrive_expect_tx(bar, kStageBytes);
        vst::tma_load_4d(st, &mq, bar, kDepth * p, bh % H, kTile * rt, bh / H);
        vst::tma_load_3d(st + kPanel128, &mkb, bar, kDepth * p, kTile * ct, bh);
        vst::tma_load_3d(st + 2 * kPanel128, &mks, bar, kDepth * p, kTile * ct, bh);
      }
    }
    for (int i = 0; i < kStages; ++i, ++it) vst::ring_wait_free(L.empty, it, kStages);
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * warp + g;   // this thread's first tile row
  vst::RingConsumer ring{L.base, kStageBytes, L.full, L.empty, kStages, lane};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ct = tile % nt, rt = tile / nt % nt, bh = tile / (nt * nt);
    float run[16][4], f[16][4];
    vst::zero_acc(run);
    vst::zero_acc(f);
    for (int p = 0; p < np; ++p) {
      const uint32_t st = ring.next();
      float x[4][4];
      uint32_t big[4][4], small[4][4];
      load_a(x, st, r, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] *= qscale;
      split_frags(x, big, small);
      vst::wgmma_fence();
      panel_products<16>(f, big, small, st + kPanel128, st + 2 * kPanel128, 0);
      vst::wgmma_commit();
      vst::wgmma_wait<0>();
      vst::fence_acc(f);
      ring.release(1);
      add_into(run, f);
    }
    const long long head = (long long)bh * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = kTile * rt + r + 8 * half;
      float m = -INFINITY;
      if (row < N) {
        float* out = s_out + (head + row) * N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = kTile * ct + 8 * j + 2 * t;   // N is even: col + 1 < N too
          if (col < N) {
            const float a = run[j][2 * half], b = run[j][2 * half + 1];
            *reinterpret_cast<float2*>(out + col) = make_float2(a, b);
            m = fmaxf(m, fmaxf(a, b));
          }
        }
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (row < N && t == 0) mpart[(head + row) * nt + ct] = m;
    }
  }
}

// ---- the backward's scores ----------------------------------------------------------

// S^T = K qc^T and dP^T = V dO^T for tiles of 128 keys by 64 queries of
// every head, `tiles` = B H nkt nqt (nkt = ceil(N / 128), nqt = N / 64),
// tile i at query tile i % nqt, key tile i / nqt % nkt, head i / (nqt
// nkt); the depth the head's D / 32 panels. A = K and V (4-D maps,
// 128-row boxes); B = the halves of qc and dO ([B H, N, D] maps, 64-row
// boxes). P^T = exp2(S^T - LSE2) and dS^T = P^T (dP^T - delta), each
// query's LSE2 and delta read from [B H, N], stored into pt and dst [B H,
// N, N] (keys by queries). Lane 4 g + t of warp i of warpgroup w holds
// keys 64 w + 16 i + g and + 8, queries 8 j + 2 t and + 1 (j < 8).
__global__ void __launch_bounds__(kThreads, 1)
tf32_scores_bwd_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mqb,
                       const __grid_constant__ CUtensorMap mqs,
                       const __grid_constant__ CUtensorMap mdb,
                       const __grid_constant__ CUtensorMap mds, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ pt,
                       float* __restrict__ dst, int H, int N, int D, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const RingSmem L(smem_raw, kBwdStages, kBwdStageBytes);
  const int nkt = (N + kTile - 1) / kTile, nqt = N / kScoreQueries, np = D / kDepth;
  const int wg = threadIdx.x / 128;
  constexpr uint32_t kQb = 2 * kPanel128, kQs = kQb + kPanel64, kDb = kQs + kPanel64,
                     kDs = kDb + kPanel64;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int qt = tile % nqt, kt = tile / nqt % nkt, bh = tile / (nqt * nkt);
      const int h = bh % H, b = bh / H;
      for (int p = 0; p < np; ++p, ++it) {
        vst::ring_wait_free(L.empty, it, kBwdStages);
        const int s = it % kBwdStages;
        const uint32_t st = L.base + s * kBwdStageBytes, bar = L.full + 8 * s;
        vst::mbar_arrive_expect_tx(bar, kBwdStageBytes);
        vst::tma_load_4d(st, &mk, bar, kDepth * p, h, kTile * kt, b);
        vst::tma_load_4d(st + kPanel128, &mv, bar, kDepth * p, h, kTile * kt, b);
        vst::tma_load_3d(st + kQb, &mqb, bar, kDepth * p, kScoreQueries * qt, bh);
        vst::tma_load_3d(st + kQs, &mqs, bar, kDepth * p, kScoreQueries * qt, bh);
        vst::tma_load_3d(st + kDb, &mdb, bar, kDepth * p, kScoreQueries * qt, bh);
        vst::tma_load_3d(st + kDs, &mds, bar, kDepth * p, kScoreQueries * qt, bh);
      }
    }
    for (int i = 0; i < kBwdStages; ++i, ++it) vst::ring_wait_free(L.empty, it, kBwdStages);
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * warp + g;
  vst::RingConsumer ring{L.base, kBwdStageBytes, L.full, L.empty, kBwdStages, lane};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int qt = tile % nqt, kt = tile / nqt % nkt, bh = tile / (nqt * nkt);
    float rs[8][4], rp[8][4], fs[8][4], fp[8][4];
    vst::zero_acc(rs);
    vst::zero_acc(rp);
    vst::zero_acc(fs);
    vst::zero_acc(fp);
    for (int p = 0; p < np; ++p) {
      const uint32_t st = ring.next();
      float x[4][4];
      uint32_t kb[4][4], ks[4][4], vb[4][4], vs[4][4];
      load_a(x, st, r, g, t);
      split_frags(x, kb, ks);
      load_a(x, st + kPanel128, r, g, t);
      split_frags(x, vb, vs);
      vst::wgmma_fence();
      panel_products<8>(fs, kb, ks, st + kQb, st + kQs, 0);
      panel_products<8>(fp, vb, vs, st + kDb, st + kDs, 0);
      vst::wgmma_commit();
      vst::wgmma_wait<0>();
      vst::fence_acc(fs);
      vst::fence_acc(fp);
      ring.release(1);
      add_into(rs, fs);
      add_into(rp, fp);
    }
    const long long head = (long long)bh * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kScoreQueries * qt + 8 * j + 2 * t;   // a query (< N: N % 64 == 0)
      const float2 l2 = *reinterpret_cast<const float2*>(lse + head + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + head + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = kTile * kt + r + 8 * half;   // a key
        if (row >= N) continue;
        const float p0 = exp2f(rs[j][2 * half] - l2.x), p1 = exp2f(rs[j][2 * half + 1] - l2.y);
        const long long at = (head + row) * N + col;
        *reinterpret_cast<float2*>(pt + at) = make_float2(p0, p1);
        *reinterpret_cast<float2*>(dst + at) =
            make_float2(p0 * (rp[j][2 * half] - d2.x), p1 * (rp[j][2 * half + 1] - d2.y));
      }
    }
  }
}

// ---- host ------------------------------------------------------------------------------

bool shapes_ok(int B, int H, int N, int D, const void* scratch) {
  return scratch != nullptr && N > 0 && D >= 192 && N % 64 == 0 && D % 64 == 0 &&
         (long long)B * H <= 65535 && (long long)B * H * N < (1ll << 31);
}

}  // namespace

namespace vst {

cudaError_t launch_attn_fwd_tf32_wide(const float* q, const float* k, const float* v, float* o,
                                      float* lse, void* scratch, int B, int H, int N, int D,
                                      long long sb, long long sn, long long sh, long long ob,
                                      long long on, long long oh, float qscale, cudaStream_t st) {
  if (!shapes_ok(B, H, N, D, scratch)) return cudaErrorInvalidValue;
  const long long bh = (long long)B * H, bhn = bh * N, nt = (N + kTile - 1) / kTile;
  float* s = static_cast<float*>(scratch);
  float* mpart = s + bhn * N;
  float* ksplit = mpart + bhn * nt;   // big, then small
  float* vsplit = ksplit + 2 * bhn * D;
  CUtensorMap mq, mkb, mks, ms, mvb, mvs;
  if (!bhnd_tensor_map_f32(&mq, q, B, N, H, D, sb, sn, sh, kTile) ||
      !heads_tensor_map_f32(&mkb, ksplit, bh, N, D, kTile) ||
      !heads_tensor_map_f32(&mks, ksplit + bhn * D, bh, N, D, kTile) ||
      !heads_tensor_map_f32(&ms, s, bh, N, N, kTile) ||
      !heads_tensor_map_f32(&mvb, vsplit, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mvs, vsplit + bhn * D, bh, D, N, kTile))
    return cudaErrorInvalidValue;
  cudaError_t err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_scores_fwd_kernel, kSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_product_kernel<kOut>, kSmem)) != cudaSuccess) return err;
  launch_split(k, sb, sn, sh, B, H, N, D, 1.f, ksplit, nullptr, st);
  launch_split(v, sb, sn, sh, B, H, N, D, 1.f, nullptr, vsplit, st);
  const long long score_tiles = bh * nt * nt;
  tf32_scores_fwd_kernel<<<persistent(score_tiles, sms), kThreads, kSmem, st>>>(
      mq, mkb, mks, s, mpart, H, N, D, qscale, static_cast<int>(score_tiles));
  const long long out_tiles = bh * nt * ((D + kTile - 1) / kTile);
  tf32_product_kernel<kOut><<<persistent(out_tiles, sms), kThreads, kSmem, st>>>(
      ms, mvb, mvs, mpart, lse, 1.f, o, H, N, D, ob, on, oh, static_cast<int>(out_tiles));
  return cudaGetLastError();
}

cudaError_t launch_attn_bwd_tf32_wide(const float* q, const float* k, const float* v,
                                      const float* d_o, const float* lse, const float* delta,
                                      float* dq, float* dk, float* dv, void* scratch, int B,
                                      int H, int N, int D, long long sb, long long sn,
                                      long long sh, long long ob, long long on, long long oh,
                                      float qscale, float scale, cudaStream_t st) {
  if (!shapes_ok(B, H, N, D, scratch)) return cudaErrorInvalidValue;
  const long long bh = (long long)B * H, bhn = bh * N, nt = (N + kTile - 1) / kTile;
  const long long half = bhn * D;   // one split half
  float* pt = static_cast<float*>(scratch);
  float* dst = pt + bhn * N;
  float* qc = dst + bhn * N;          // [B H, N, D] big, small
  float* dos = qc + 2 * half;
  float* qct = dos + 2 * half;        // [B H, D, N] big, small
  float* dot = qct + 2 * half;
  float* kt = dot + 2 * half;
  CUtensorMap mk, mv, mqb, mqs, mdb, mds, mpt, mdst, mdst_t, mdotb, mdots, mqctb, mqcts, mktb,
      mkts;
  if (!bhnd_tensor_map_f32(&mk, k, B, N, H, D, sb, sn, sh, kTile) ||
      !bhnd_tensor_map_f32(&mv, v, B, N, H, D, sb, sn, sh, kTile) ||
      !heads_tensor_map_f32(&mqb, qc, bh, N, D, kScoreQueries) ||
      !heads_tensor_map_f32(&mqs, qc + half, bh, N, D, kScoreQueries) ||
      !heads_tensor_map_f32(&mdb, dos, bh, N, D, kScoreQueries) ||
      !heads_tensor_map_f32(&mds, dos + half, bh, N, D, kScoreQueries) ||
      !heads_tensor_map_f32(&mpt, pt, bh, N, N, kTile) ||
      !heads_tensor_map_f32(&mdst, dst, bh, N, N, kTile) ||
      !heads_tensor_map_f32(&mdst_t, dst, bh, N, N, 32) ||
      !heads_tensor_map_f32(&mdotb, dot, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mdots, dot + half, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mqctb, qct, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mqcts, qct + half, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mktb, kt, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mkts, kt + half, bh, D, N, kTile))
    return cudaErrorInvalidValue;
  cudaError_t err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_scores_bwd_kernel, kBwdSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_product_kernel<kGrad>, kSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_product_kernel<kGradT>, kSmem)) != cudaSuccess) return err;
  launch_split(q, sb, sn, sh, B, H, N, D, qscale, qc, qct, st);
  launch_split(d_o, ob, on, oh, B, H, N, D, 1.f, dos, dot, st);
  launch_split(k, sb, sn, sh, B, H, N, D, 1.f, nullptr, kt, st);
  const long long score_tiles = bh * nt * (N / kScoreQueries);
  tf32_scores_bwd_kernel<<<persistent(score_tiles, sms), kThreads, kBwdSmem, st>>>(
      mk, mv, mqb, mqs, mdb, mds, lse, delta, pt, dst, H, N, D, static_cast<int>(score_tiles));
  const long long tiles = bh * nt * ((D + kTile - 1) / kTile);
  const unsigned grid = persistent(tiles, sms);
  const int ti = static_cast<int>(tiles);
  tf32_product_kernel<kGrad><<<grid, kThreads, kSmem, st>>>(mpt, mdotb, mdots, nullptr, nullptr,
                                                            1.f, dv, H, N, D, ob, on, oh, ti);
  tf32_product_kernel<kGrad><<<grid, kThreads, kSmem, st>>>(mdst, mqctb, mqcts, nullptr, nullptr,
                                                            kLn2, dk, H, N, D, ob, on, oh, ti);
  tf32_product_kernel<kGradT><<<grid, kThreads, kSmem, st>>>(
      mdst_t, mktb, mkts, nullptr, nullptr, scale, dq, H, N, D, ob, on, oh, ti);
  return cudaGetLastError();
}

}  // namespace vst
