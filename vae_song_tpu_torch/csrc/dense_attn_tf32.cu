// f32 attention forward and backward for Hopper (sm_90a) at head widths 64
// and 128: split-TF32 wgmma/TMA kernels that keep the scores on chip,
// [B, N, H, D] tensors read through strides.
//
// Replaces: the f32 path (cd = f32, denseattn.py:82-85) of
// vae_song_tpu/ops/denseattn.py:_fwd_kernel_packed (K1, through
// _call_fwd_packed) and _bwd_kernel_packed (K2, through _call_bwd_packed)
// at D = 64, and of _fwd_kernel (K3f, through _call_fwd) and _bwd_kernel
// (K3b, through _call_bwd) at D = 64 and 128: SetVAE under
// `mixed_precision: false` (four heads of 64, the packed route; two heads
// of 128, the BHND route). The function and its roundings are those of
// dense_attn_fwd.cu and dense_attn_bwd.cu in f32:
//   qc = q * scale * log2e (one f32 multiply), S2 = qc k^T, m = the exact
//   running row max, P = exp2(S2 - m), O = P v / rowsum(P),
//   LSE2 = m + log2(rowsum(P));
//   backward: P = exp2(qc k^T - LSE2), dV = P^T dO, dP = dO v^T,
//   dS = P (dP - delta), dQ = dS k scale, dK = dS^T qc ln2,
// with delta = rowsum(dO O) from the backward's preprocess pass.
//
// Split TF32 (mma_tf32.cuh: split_tf32): every operand x is carried as big
// = rna(x) and small = rna(x - big), each 8-deep step of a product is three
// TF32 wgmma, small big, big small, big big. The tensor cores round each
// product's sum toward zero, so every chain starts a fresh accumulator and
// is added to the running f32 sum (to nearest) in the depth's order: the
// forward's S each 32 columns of the head (one panel, 12 wgmma), the
// backward's S^T and dP^T each 8 (one step, 3 wgmma: with 32 their errors,
// through exp2, left the gradients farther from float64 than the plain f32
// version), O each key tile (64 keys at D = 64, 32 at 128), dV and dK each
// query tile (64 queries at D = 64, 32 at 128), dQ each 64 keys (tests/test_torch_denseattn_f32split.py
// emulates this order and holds it to chip_smoke.py's f32 bounds).
//
// What bounds them: 4 B H N^2 D operations forward and 10 B H N^2 D
// backward, each made once; at B = 64, H = 4, N = 2048, D = 64 (and H = 2,
// D = 128) 2.75e11 and 6.87e11, 1.67 and 4.17 ms as split TF32 (3 x
// operations at 495 TFLOP/s). TF32 wgmma has no transpose: both shared-
// memory operands are read K-major, so the B operands are split ahead by a
// pre-pass (tf32_wgmma.cuh: tf32_split_kernel) into K-major big and small
// arrays, and every operand is read twice over (big and small) at 4 bytes:
// eight times the bytes of a bf16 operand. Those reads come from L2 (each
// block streams its head's whole other side), 96 operations a byte in the
// forward and 48 in the dK/dV kernel.
//
// Forward. A block owns 64 NC query rows of one (b, h): NC consumer
// warpgroups of 64 rows (NC = 2, or 1 where B H N / 128 blocks would leave
// more than half the SMs idle: the decoder's B = 1) and a producer
// warpgroup (setmaxnreg 40 / 232), one thread of which issues the TMA
// loads: q raw once (qc = q qscale as each value is loaded into an A
// fragment, then split: the A operand in registers), then a ring of
// stages, each one key tile of K's split rows and V^T's split halves (3
// stages of 64 keys at D = 64, 2 of 32 at 128; 224 and 192 KB of shared
// memory). S = qc K^T (the head's panels two at a time, the A fragments
// of both live until their wgmma complete), the online softmax with the
// exact running max, then O += P V with P, in the accumulator layout, the
// register A operand as it stands: the pre-pass writes V^T with each
// group of 8 keys permuted (key 2 t at position t, 2 t + 1 at t + 4), the
// permuted contraction of mma_tf32.cuh. The two consumer warpgroups take
// turns issuing (S, then P V; named barriers 1 and 2), so one's softmax
// runs while the other's products do. The scores never leave the SM.
//
// Backward. The preprocess (dense_attn_bwd.cu) writes delta; the pre-pass
// splits qc and dO as rows, qc^T and dO^T with queries permuted, and K^T.
// The dK/dV kernel: a block owns 64 keys of one (b, h), K and V raw in
// shared memory; per tile of queries (64 at D = 64, 32 at 128) warpgroup 0
// forms S^T = K qc^T and
// P^T = exp2(S^T - LSE2), warpgroup 1 dP^T = V dO^T and dP^T - delta; they
// swap the two tiles through shared memory at a named barrier (two buffers
// alternate), both form dS^T = P^T (dP^T - delta) (the same bits), write
// it to an f32 scratch [B H, N, N] for dQ, and each accumulates dV += P^T
// dO and dK += dS^T qc on its half of the head's columns, P^T and dS^T the
// register A operands (the permuted qc^T and dO^T). The query tiles stream
// as ring items (the score half: qc and dO rows; the output half: dO^T and
// qc^T), two of 64 KB. Then dQ = scale dS
// K is tf32_wgmma.cuh's product kernel over dS^T read transposed (128 x
// 64 output tiles at D = 64, 128 x 128 at 128): 10 B H N^2 D in all. The
// scratch costs 4 B H N^2 bytes written and read (4.3 GB at B = 64, H =
// 4); a dQ kernel that recomputes S and dP instead (14 B H N^2 D, no
// scratch: scripts/ab_attn_f32_dq.cu, A/B'd by scripts/ab_attn_f32.py
// --dq-recompute) took 2.8-4.8 times as long as the store and the product
// together at B = 64, N = 2048 on an H100 (the whole backward 1.35-1.6
// times as long).
//
// N % 64 == 0: key tiles (64 or 32) and the backward's 64-key blocks and
// 32-query tiles are whole; the forward's last 128-row block may end 64 past
// N (TMA reads zeros there, nothing is stored). No atomics, every sum in a
// fixed order: the same bits on every run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_attn_tf32.cuh"
#include "tf32_wgmma.cuh"

namespace {

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One panel's A fragments (load_a) times `mul`, split.
__device__ __forceinline__ void load_split(uint32_t (&big)[4][4], uint32_t (&small)[4][4],
                                           uint32_t panel, float mul, int r, int g, int t) {
  float x[4][4];
  load_a(x, panel, r, g, t);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] *= mul;
  split_frags(x, big, small);
}

// run = A B over the head's NP = D / 32 panels: a fresh accumulator each
// panel (12 wgmma), added into run in panel order (the first panel's is run
// itself). A: rows r, r + 8 of the raw f32 K-major panels at a0, a_stride
// bytes apart, each value times `mul` as it is loaded, then split; B: the
// split halves, K-major panels at bb and bs, b_stride bytes apart. The
// panels go out two at a time: their A fragments (64 registers) stay
// live until the pair's wgmma complete.
template <int NP, int NT>
__device__ __forceinline__ void score_chains(float (&run)[NT][4], uint32_t a0, uint32_t a_stride,
                                             float mul, uint32_t bb, uint32_t bs,
                                             uint32_t b_stride, int r, int g, int t) {
  static_assert(NP == 2 || NP == 4, "heads of 64 or 128");
  float f[NT][4];
  uint32_t xb[4][4], xs[4][4], yb[4][4], ys[4][4];
  load_split(xb, xs, a0, mul, r, g, t);
  load_split(yb, ys, a0 + a_stride, mul, r, g, t);
  vst::wgmma_fence();
  panel_products<NT>(run, xb, xs, bb, bs, 0);
  panel_products<NT>(f, yb, ys, bb + b_stride, bs + b_stride, 0);
  vst::wgmma_commit();
  vst::wgmma_wait<0>();
  vst::fence_acc(run);
  vst::fence_acc(f);
  add_into(run, f);
  if constexpr (NP == 4) {
    float f2[NT][4];
    load_split(xb, xs, a0 + 2 * a_stride, mul, r, g, t);
    load_split(yb, ys, a0 + 3 * a_stride, mul, r, g, t);
    vst::wgmma_fence();
    panel_products<NT>(f, xb, xs, bb + 2 * b_stride, bs + 2 * b_stride, 0);
    panel_products<NT>(f2, yb, ys, bb + 3 * b_stride, bs + 3 * b_stride, 0);
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
    vst::fence_acc(f);
    vst::fence_acc(f2);
    add_into(run, f);
    add_into(run, f2);
  }
}

// run = A B as score_chains computes it, with a fresh accumulator each
// 8-deep step (3 wgmma) in place of each panel: the
// backward's S^T and dP^T, whose errors pass through exp2 into P^T and dS^T
// and from there into every gradient. A chain of 32 columns left the
// gradients farther from float64 than the plain f32 version on the card
// (tests/test_torch_denseattn_f32split.py: one step lands at 0.45-0.65 of
// that version's distance at N = 2048). KS steps at a time (the fresh
// 64 x 8 NT tiles of four steps at NT = 4, of two at NT = 8: 64
// registers), added into run in step order after their wait; the next
// panel's A fragments are loaded and split while the panel's last wgmma
// run.
template <int NP, int NT>
__device__ __forceinline__ void score_steps(float (&run)[NT][4], uint32_t a0, uint32_t a_stride,
                                            float mul, uint32_t bb, uint32_t bs,
                                            uint32_t b_stride, int r, int g, int t) {
  constexpr int KS = NT >= 8 ? 2 : 4;
  float f[KS][NT][4];
  uint32_t xb[2][4][4], xs[2][4][4];   // panel p's A in buffer p % 2
  vst::zero_acc(run);
  load_split(xb[0], xs[0], a0, mul, r, g, t);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int h = 0; h < 4; h += KS) {
      vst::wgmma_fence();
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int j = h + i;
        wgmma_tf32<NT>(f[i], xs[p & 1][j], vst::desc_kmajor(bb + p * b_stride, j), 0);
        wgmma_tf32<NT>(f[i], xb[p & 1][j], vst::desc_kmajor(bs + p * b_stride, j), 1);
        wgmma_tf32<NT>(f[i], xb[p & 1][j], vst::desc_kmajor(bb + p * b_stride, j), 1);
      }
      vst::wgmma_commit();
      // the next panel's A while these run
      if (h + KS == 4 && p + 1 < NP)
        load_split(xb[(p + 1) & 1], xs[(p + 1) & 1], a0 + (p + 1) * a_stride, mul, r, g, t);
      vst::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        vst::fence_acc(f[i]);
        add_into(run, f[i]);
      }
    }
  }
}

// The split of an accumulator tile x (64 x 8 KS) as the register A
// operand of a product over its columns, in the permuted contraction
// order (mma_tf32.cuh): k-step j's A columns t and t + 4 are x's columns
// 8 j + 2 t and 8 j + 2 t + 1.
template <int KS>
__device__ __forceinline__ void split_acc(const float (&x)[KS][4], uint32_t (&big)[KS][4],
                                          uint32_t (&small)[KS][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    vst::split_tf32(x[j][0], big[j][0], small[j][0]);
    vst::split_tf32(x[j][2], big[j][1], small[j][1]);
    vst::split_tf32(x[j][1], big[j][2], small[j][2]);
    vst::split_tf32(x[j][3], big[j][3], small[j][3]);
  }
}

// f (= fresh) A B over the KQ 8-deep steps of a tile, one chain: A the
// split accumulator tile (split_acc), B's halves at bb and bs as KQ / 4
// K-major panels (32 of the contraction each), `stride` bytes apart.
template <int NT, int KQ>
__device__ __forceinline__ void tile_products(float (&f)[NT][4], const uint32_t (&big)[KQ][4],
                                              const uint32_t (&small)[KQ][4], uint32_t bb,
                                              uint32_t bs, uint32_t stride) {
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const uint32_t at = (kk / 4) * stride;
    wgmma_tf32<NT>(f, small[kk], vst::desc_kmajor(bb + at, kk % 4), kk == 0 ? 0 : 1);
    wgmma_tf32<NT>(f, big[kk], vst::desc_kmajor(bs + at, kk % 4), 1);
    wgmma_tf32<NT>(f, big[kk], vst::desc_kmajor(bb + at, kk % 4), 1);
  }
}

// ---- forward ----------------------------------------------------------------------

// Shared memory, byte offsets from a 1024-byte aligned base: q (NP panels
// of 64 NC rows), the ring's stages (K big and small: NP panels of KT rows
// each; V^T big and small: KT / 32 panels of D rows each), then the
// mbarriers (q, full K[], full V[], empty[]).
template <int D, int NC>
struct Tf32FwdSmem {
  static constexpr int NP = D / 32;
  static constexpr int KT = D == 64 ? 64 : 32;          // keys a tile (a ring stage)
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr uint32_t q_panel = 64 * NC * 128;
  static constexpr uint32_t k_half = NP * KT * 128;
  static constexpr uint32_t v_half = KT / 32 * D * 128;
  static constexpr uint32_t stage_bytes = 2 * k_half + 2 * v_half;
  static constexpr uint32_t stage0 = NP * q_panel;
  static constexpr uint32_t bars = stage0 + kStages * stage_bytes;
  static constexpr size_t bytes = bars + 8 * (1 + 3 * kStages) + 1024;   // + alignment
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// Grid (ceil(N / (64 NC)), H, B), 128 (NC + 1) threads. Warpgroup w < NC
// owns queries q0 + 64 w .. + 63; lane 4 g + t of its warp i holds rows 16
// i + g and + 8 of those, columns 8 j + 2 t and + 1 of each 8-column block
// j of S (KT / 8 blocks) and O (D / 8).
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
tf32_fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mkb,
                const __grid_constant__ CUtensorMap mks, const __grid_constant__ CUtensorMap mvb,
                const __grid_constant__ CUtensorMap mvs, float* __restrict__ o,
                float* __restrict__ lse, int H, int N, long long ob, long long on, long long oh,
                float qscale) {
  using L = Tf32FwdSmem<D, NC>;
  constexpr int NP = L::NP, KT = L::KT, kSt = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (vst::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_bar = base + L::bars, full_k0 = q_bar + 8;
  const uint32_t full_v0 = full_k0 + 8 * kSt, empty0 = full_v0 + 8 * kSt;
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int nk = N / KT;
  if (threadIdx.x == 0) {
    vst::mbar_init(q_bar, 1);
    for (int s = 0; s < kSt; ++s) {
      vst::mbar_init(full_k0 + 8 * s, 1);
      vst::mbar_init(full_v0 + 8 * s, 1);
      vst::mbar_init(empty0 + 8 * s, 4 * NC);   // one arrival a consumer warp
    }
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  auto stage = [&](int it) { return base + L::stage0 + (it % kSt) * L::stage_bytes; };
  auto parity = [&](int it) { return (uint32_t)((it / kSt) & 1); };

  if (wg == NC) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x == 128 * NC) {
      vst::mbar_arrive_expect_tx(q_bar, NP * L::q_panel);
      for (int p = 0; p < NP; ++p)
        vst::tma_load_4d(base + p * L::q_panel, &mq, q_bar, 32 * p, h, q0, b);
      // the last kSt waits let the consumers release every stage
      for (int it = 0; it < nk + kSt; ++it) {
        vst::mbar_wait(empty0 + 8 * (it % kSt), parity(it) ^ 1);
        if (it >= nk) continue;
        const uint32_t st = stage(it), fk = full_k0 + 8 * (it % kSt), fv = full_v0 + 8 * (it % kSt);
        vst::mbar_arrive_expect_tx(fk, 2 * L::k_half);
        for (int p = 0; p < NP; ++p) {
          vst::tma_load_3d(st + p * KT * 128, &mkb, fk, 32 * p, KT * it, bh);
          vst::tma_load_3d(st + L::k_half + p * KT * 128, &mks, fk, 32 * p, KT * it, bh);
        }
        vst::mbar_arrive_expect_tx(fv, 2 * L::v_half);
        for (int c = 0; c < KT / 32; ++c) {
          vst::tma_load_3d(st + 2 * L::k_half + c * D * 128, &mvb, fv, KT * it + 32 * c, 0, bh);
          vst::tma_load_3d(st + 2 * L::k_half + L::v_half + c * D * 128, &mvs, fv,
                           KT * it + 32 * c, 0, bh);
        }
      }
    }
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * warp + g;   // the thread's first row in the block
  float orun[D / 8][4], of[D / 8][4];
  vst::zero_acc(orun);
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r and r + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  vst::mbar_wait(q_bar, 0);

  // S, then P V: each a burst that the two warpgroups take in turn
  constexpr bool kPingpong = NC == 2;
  if constexpr (kPingpong) {
    if (wg == 1) vst::named_arrive(1, 256);   // warpgroup 0 goes first
  }
  for (int it = 0; it < nk; ++it) {
    const uint32_t st = stage(it);
    float s[KT / 8][4];
    if constexpr (kPingpong) vst::named_sync(1 + wg, 256);
    vst::mbar_wait(full_k0 + 8 * (it % kSt), parity(it));
    score_chains<NP, KT / 8>(s, base, L::q_panel, qscale, st, st + L::k_half, KT * 128, r, g, t);
    if constexpr (kPingpong) vst::named_arrive(2 - wg, 256);

    // the online softmax: the exact running max, P = exp2(S2 - m) in f32
    float n0 = m0, n1 = m1;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      n0 = fmaxf(n0, fmaxf(s[j][0], s[j][1]));
      n1 = fmaxf(n1, fmaxf(s[j][2], s[j][3]));
    }
    n0 = quad_max(n0);
    n1 = quad_max(n1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);   // 0 on the first tile
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - n0);
      s[j][1] = exp2f(s[j][1] - n0);
      s[j][2] = exp2f(s[j][2] - n1);
      s[j][3] = exp2f(s[j][3] - n1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orun[j][0] *= a0;
      orun[j][1] *= a0;
      orun[j][2] *= a1;
      orun[j][3] *= a1;
    }
    uint32_t pb[KT / 8][4], psm[KT / 8][4];
    split_acc<KT / 8>(s, pb, psm);

    // O's fresh sum over the tile: k-step j reads keys 8 j .. 8 j + 7 of
    // V^T panel j / 4
    if constexpr (kPingpong) vst::named_sync(1 + wg, 256);
    vst::mbar_wait(full_v0 + 8 * (it % kSt), parity(it));
    const uint32_t vb = st + 2 * L::k_half, vs = vb + L::v_half;
    vst::wgmma_fence();
    tile_products<D / 8, KT / 8>(of, pb, psm, vb, vs, D * 128);
    vst::wgmma_commit();
    if constexpr (kPingpong) vst::named_arrive(2 - wg, 256);
    vst::wgmma_wait<0>();
    vst::fence_acc(of);
    vst::release_stage(empty0 + 8 * (it % kSt), lane);
    add_into(orun, of);
  }
  if constexpr (kPingpong) {
    if (wg == 0) vst::named_sync(1, 256);   // the arrival left from warpgroup 1's last burst
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r + 8 * half;
    if (row >= N) continue;
    const float l = half ? l1 : l0;
    float* dst = o + (long long)b * ob + (long long)row * on + (long long)h * oh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) =
          make_float2(orun[j][2 * half] / l, orun[j][2 * half + 1] / l);
    if (t == 0) lse[(long long)bh * N + row] = (half ? m1 : m0) + log2f(l);
  }
}

// ---- backward: dK/dV ---------------------------------------------------------------

// Shared memory, byte offsets from a 1024-byte aligned base: K and V raw
// (NP panels of 64 keys each), the ring of `kSlots` items (a score item:
// qc big, qc small, dO big, dO small, each NP panels of kQT rows; an output
// item: dO^T big, dO^T small, qc^T big, qc^T small, each kQT / 32 panels
// of D rows by 32 queries), the exchange (two buffers of two 64 x kQT f32
// tiles), then the mbarriers (the resident tiles', full[], empty[]).
template <int D>
struct Tf32DkdvSmem {
  static constexpr int NP = D / 32;
  static constexpr int kQT = D == 64 ? 64 : 32;                // queries a tile
  static constexpr int kSlots = 2;
  static constexpr uint32_t res = NP * 64 * 128;               // K or V
  static constexpr uint32_t half = NP * kQT * 128;             // one split half of a tile
  static constexpr uint32_t item = 4 * half;
  static constexpr uint32_t xtile = 64 * kQT * 4;              // one warpgroup's tile
  static constexpr uint32_t ring0 = 2 * res;
  static constexpr uint32_t xch0 = ring0 + kSlots * item;
  static constexpr uint32_t bars = xch0 + 4 * xtile;
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kSlots) + 1024;   // + alignment
  static_assert(half == kQT / 32 * D * 128, "an output item's half: kQT / 32 panels of D rows");
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// Grid (N / 64, H, B), 384 threads: consumer warpgroups 0 and 1 on the
// block's 64 keys k0 .., a producer warpgroup; tiles of kQT queries (64 at
// D = 64, 32 at 128). kStoreDs: dS^T into `dst`
// for the dQ product (false only in scripts/ab_attn_f32_dq.cu's A/B arm,
// whose dQ kernel recomputes S and dP). Lane 4 g + t of warp i
// holds keys 16 i + g and + 8, queries 8 j + 2 t and + 1 of the tile (j <
// kQT / 8), and columns (D / 2) w + 8 j + 2 t and + 1 of dK and dV (j <
// D / 16).
template <int D, bool kStoreDs = true>
__global__ void __launch_bounds__(384, 1)
tf32_dkdv_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mqb, const __grid_constant__ CUtensorMap mqs,
                 const __grid_constant__ CUtensorMap mdb, const __grid_constant__ CUtensorMap mds,
                 const __grid_constant__ CUtensorMap mdtb,
                 const __grid_constant__ CUtensorMap mdts,
                 const __grid_constant__ CUtensorMap mqtb,
                 const __grid_constant__ CUtensorMap mqts, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dst,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int N, long long ob,
                 long long on, long long oh) {
  using L = Tf32DkdvSmem<D>;
  constexpr int NP = L::NP, QT = L::kQT, kSlots = L::kSlots, NO = D / 16, KQ = QT / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* xch = reinterpret_cast<float*>(smem_raw + (base - raw) + L::xch0);
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kSlots;
  const int k0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int nq = N / QT;
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
      vst::tma_load_4d(base + p * 64 * 128, &mk, res_bar, 32 * p, h, k0, b);
      vst::tma_load_4d(base + L::res + p * 64 * 128, &mv, res_bar, 32 * p, h, k0, b);
    }
    vst::RingCursor c;
    for (int i = 0; i < 2 * nq + kSlots; ++i, c.advance(kSlots)) {
      vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
      if (i >= 2 * nq) continue;   // the last kSlots waits let the consumers release every item
      const uint32_t sl = base + L::ring0 + c.stage * L::item, bar = full0 + 8 * c.stage;
      const int q = QT * (i / 2);
      vst::mbar_arrive_expect_tx(bar, L::item);
      if ((i & 1) == 0) {   // score item: qc and dO rows
        for (int p = 0; p < NP; ++p) {
          const uint32_t at = sl + p * QT * 128;
          vst::tma_load_3d(at, &mqb, bar, 32 * p, q, bh);
          vst::tma_load_3d(at + L::half, &mqs, bar, 32 * p, q, bh);
          vst::tma_load_3d(at + 2 * L::half, &mdb, bar, 32 * p, q, bh);
          vst::tma_load_3d(at + 3 * L::half, &mds, bar, 32 * p, q, bh);
        }
      } else {              // output item: dO^T and qc^T, queries permuted
        for (int pc = 0; pc < QT / 32; ++pc) {
          const uint32_t at = sl + pc * D * 128;
          vst::tma_load_3d(at, &mdtb, bar, q + 32 * pc, 0, bh);
          vst::tma_load_3d(at + L::half, &mdts, bar, q + 32 * pc, 0, bh);
          vst::tma_load_3d(at + 2 * L::half, &mqtb, bar, q + 32 * pc, 0, bh);
          vst::tma_load_3d(at + 3 * L::half, &mqts, bar, q + 32 * pc, 0, bh);
        }
      }
    }
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;   // the thread's first key in the block
  const long long head = (long long)bh * N;
  float dkr[NO][4], dvr[NO][4];
  vst::zero_acc(dkr);
  vst::zero_acc(dvr);
  vst::RingConsumer ring{base + L::ring0, L::item, full0, empty0, kSlots, lane};
  // warpgroup 0: S^T = K qc^T; warpgroup 1: dP^T = V dO^T
  const uint32_t a0 = base + wg * L::res, b_off = 2 * wg * L::half;
  // this warpgroup's columns of dV (dO^T rows) and dK (qc^T rows)
  const uint32_t o_off = wg * (D / 2) * 128;
  vst::mbar_wait(res_bar, 0);

  // warpgroup 0 subtracts LSE2, warpgroup 1 delta (the tile's queries)
  const float* by = (wg == 0 ? lse : delta) + head;
  for (int it = 0; it < nq; ++it) {
    const int q = QT * it;
    float2 c2[KQ];   // read here, used after the scores
#pragma unroll
    for (int j = 0; j < KQ; ++j) c2[j] = *reinterpret_cast<const float2*>(by + q + 8 * j + 2 * t);
    const uint32_t si = ring.next();
    float x[KQ][4];
    score_steps<NP, KQ>(x, a0, 64 * 128, 1.f, si + b_off, si + b_off + L::half, QT * 128, r, g,
                        t);
    ring.release(1);

    // P^T = exp2(S^T - LSE2) or dP^T - delta
#pragma unroll
    for (int j = 0; j < KQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = x[j][e] - ((e & 1) ? c2[j].y : c2[j].x);
        x[j][e] = wg == 0 ? exp2f(v) : v;
      }
    // swap: each writes its tile, reads the other's; dS^T = P^T (dP^T - delta)
    float* buf = xch + (it & 1) * (2 * 64 * QT);
#pragma unroll
    for (int j = 0; j < KQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) buf[wg * 64 * QT + (4 * j + e) * 128 + tid] = x[j][e];
    vst::named_sync(1, 256);
    float pt[KQ][4], ds[KQ][4];
#pragma unroll
    for (int j = 0; j < KQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = buf[(1 - wg) * 64 * QT + (4 * j + e) * 128 + tid];
        pt[j][e] = wg == 0 ? x[j][e] : y;
        ds[j][e] = pt[j][e] * (wg == 0 ? y : x[j][e]);
      }
    // dS^T into the scratch for dQ: warpgroup w stores the tile's query
    // blocks [w KQ / 2, (w + 1) KQ / 2)
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      if (!kStoreDs || j / (KQ / 2) != wg) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(dst + (head + k0 + r + 8 * half) * N + q + 8 * j + 2 * t) =
            make_float2(ds[j][2 * half], ds[j][2 * half + 1]);
    }

    // dV += P^T dO and dK += dS^T qc on this warpgroup's columns, one fresh
    // accumulator each over the tile
    uint32_t pb[KQ][4], psm[KQ][4], db[KQ][4], dsm[KQ][4];
    split_acc<KQ>(pt, pb, psm);
    split_acc<KQ>(ds, db, dsm);
    const uint32_t so = ring.next();
    float dvf[NO][4], dkf[NO][4];
    vst::wgmma_fence();
    tile_products<NO, KQ>(dvf, pb, psm, so + o_off, so + L::half + o_off, D * 128);
    tile_products<NO, KQ>(dkf, db, dsm, so + 2 * L::half + o_off, so + 3 * L::half + o_off,
                          D * 128);
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
    vst::fence_acc(dvf);
    vst::fence_acc(dkf);
    ring.release(1);
    add_into(dvr, dvf);
    add_into(dkr, dkf);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long at = (long long)b * ob + (long long)(k0 + r + 8 * half) * on +
                         (long long)h * oh + (D / 2) * wg + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<float2*>(dk + at + 8 * j) =
          make_float2(dkr[j][2 * half] * kLn2, dkr[j][2 * half + 1] * kLn2);
      *reinterpret_cast<float2*>(dv + at + 8 * j) =
          make_float2(dvr[j][2 * half], dvr[j][2 * half + 1]);
    }
  }
}

// ---- host ------------------------------------------------------------------------------

bool shapes_ok(int B, int H, int N, int D, const void* scratch) {
  return scratch != nullptr && N > 0 && (D == 64 || D == 128) && N % 64 == 0 &&
         (long long)B * H <= 65535 && (long long)B * H * N < (1ll << 31);
}

template <int D, int NC>
cudaError_t launch_fwd(const float* q, long long sb, long long sn, long long sh, const float* ks,
                       const float* vt, float* o, float* lse, int B, int H, int N, long long ob,
                       long long on, long long oh, float qscale, cudaStream_t st) {
  using L = Tf32FwdSmem<D, NC>;
  const long long bh = (long long)B * H, half = bh * N * D;
  CUtensorMap mq, mkb, mks, mvb, mvs;
  if (!vst::bhnd_tensor_map_f32(&mq, q, B, N, H, D, sb, sn, sh, 64 * NC) ||
      !vst::heads_tensor_map_f32(&mkb, ks, bh, N, D, L::KT) ||
      !vst::heads_tensor_map_f32(&mks, ks + half, bh, N, D, L::KT) ||
      !vst::heads_tensor_map_f32(&mvb, vt, bh, D, N, D) ||
      !vst::heads_tensor_map_f32(&mvs, vt + half, bh, D, N, D))
    return cudaErrorInvalidValue;
  const cudaError_t err = vst::allow_smem(tf32_fwd_kernel<D, NC>, L::bytes);
  if (err != cudaSuccess) return err;
  tf32_fwd_kernel<D, NC><<<dim3((N + 64 * NC - 1) / (64 * NC), H, B), 128 * (NC + 1), L::bytes,
                           st>>>(mq, mkb, mks, mvb, mvs, o, lse, H, N, ob, on, oh, qscale);
  return cudaGetLastError();
}

// The forward at D: two consumer warpgroups a block unless that leaves
// more than half the card's SMs idle (one warpgroup a block has no partner
// to take turns with).
template <int D>
cudaError_t launch_fwd_d(const float* q, long long sb, long long sn, long long sh,
                         const float* ks, const float* vt, float* o, float* lse, int B, int H,
                         int N, long long ob, long long on, long long oh, float qscale,
                         cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (2 * (long long)B * H * ((N + 127) / 128) <= sms)
    return launch_fwd<D, 1>(q, sb, sn, sh, ks, vt, o, lse, B, H, N, ob, on, oh, qscale, st);
  return launch_fwd<D, 2>(q, sb, sn, sh, ks, vt, o, lse, B, H, N, ob, on, oh, qscale, st);
}

template <int D, bool kStoreDs = true>
cudaError_t launch_dkdv(const float* k, const float* v, long long sb, long long sn, long long sh,
                        const float* qc, const float* dos, const float* qct, const float* dot,
                        const float* lse, const float* delta, float* dst, float* dk, float* dv,
                        int B, int H, int N, long long ob, long long on, long long oh,
                        cudaStream_t st) {
  using L = Tf32DkdvSmem<D>;
  const long long bh = (long long)B * H, half = bh * N * D;
  CUtensorMap mk, mv, mqb, mqs, mdb, mds, mdtb, mdts, mqtb, mqts;
  if (!vst::bhnd_tensor_map_f32(&mk, k, B, N, H, D, sb, sn, sh, 64) ||
      !vst::bhnd_tensor_map_f32(&mv, v, B, N, H, D, sb, sn, sh, 64) ||
      !vst::heads_tensor_map_f32(&mqb, qc, bh, N, D, L::kQT) ||
      !vst::heads_tensor_map_f32(&mqs, qc + half, bh, N, D, L::kQT) ||
      !vst::heads_tensor_map_f32(&mdb, dos, bh, N, D, L::kQT) ||
      !vst::heads_tensor_map_f32(&mds, dos + half, bh, N, D, L::kQT) ||
      !vst::heads_tensor_map_f32(&mdtb, dot, bh, D, N, D) ||
      !vst::heads_tensor_map_f32(&mdts, dot + half, bh, D, N, D) ||
      !vst::heads_tensor_map_f32(&mqtb, qct, bh, D, N, D) ||
      !vst::heads_tensor_map_f32(&mqts, qct + half, bh, D, N, D))
    return cudaErrorInvalidValue;
  const cudaError_t err = vst::allow_smem(tf32_dkdv_kernel<D, kStoreDs>, L::bytes);
  if (err != cudaSuccess) return err;
  tf32_dkdv_kernel<D, kStoreDs><<<dim3(N / 64, H, B), 384, L::bytes, st>>>(
      mk, mv, mqb, mqs, mdb, mds, mdtb, mdts, mqtb, mqts, lse, delta, dst, dk, dv, H, N, ob, on,
      oh);
  return cudaGetLastError();
}

// dQ = scale dS K: the product kernel over dS^T (read transposed) and K^T's
// halves, output tiles of 128 queries by 8 NT columns.
template <int NT>
cudaError_t launch_dq(const float* dst, const float* kt, float* dq, int B, int H, int N, int D,
                      long long ob, long long on, long long oh, float scale, cudaStream_t st) {
  const long long bh = (long long)B * H, half = bh * N * D;
  CUtensorMap mdst_t, mktb, mkts;
  if (!vst::heads_tensor_map_f32(&mdst_t, dst, bh, N, N, 32) ||
      !vst::heads_tensor_map_f32(&mktb, kt, bh, D, N, 8 * NT) ||
      !vst::heads_tensor_map_f32(&mkts, kt + half, bh, D, N, 8 * NT))
    return cudaErrorInvalidValue;
  cudaError_t err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = vst::allow_smem(tf32_product_kernel<kGradT, NT>, kProductSmem<NT>)) != cudaSuccess)
    return err;
  const long long tiles = bh * ((N + kTile - 1) / kTile) * ((D + 8 * NT - 1) / (8 * NT));
  tf32_product_kernel<kGradT, NT><<<persistent(tiles, sms), kThreads, kProductSmem<NT>, st>>>(
      mdst_t, mktb, mkts, nullptr, nullptr, scale, dq, H, N, D, ob, on, oh,
      static_cast<int>(tiles));
  return cudaGetLastError();
}

}  // namespace

namespace vst {

cudaError_t launch_attn_fwd_tf32(const float* q, const float* k, const float* v, float* o,
                                 float* lse, void* scratch, int B, int H, int N, int D,
                                 long long sb, long long sn, long long sh, long long ob,
                                 long long on, long long oh, float qscale, cudaStream_t st) {
  if (!shapes_ok(B, H, N, D, scratch)) return cudaErrorInvalidValue;
  const long long half = (long long)B * H * N * D;   // one split half
  float* ks = static_cast<float*>(scratch);          // [B H, N, D] big, small
  float* vt = ks + 2 * half;                         // [B H, D, N] big, small, keys permuted
  launch_split(k, sb, sn, sh, B, H, N, D, 1.f, ks, nullptr, st);
  launch_split(v, sb, sn, sh, B, H, N, D, 1.f, nullptr, vt, st, true);
  return D == 64 ? launch_fwd_d<64>(q, sb, sn, sh, ks, vt, o, lse, B, H, N, ob, on, oh, qscale, st)
                 : launch_fwd_d<128>(q, sb, sn, sh, ks, vt, o, lse, B, H, N, ob, on, oh, qscale,
                                     st);
}

cudaError_t launch_attn_bwd_tf32(const float* q, const float* k, const float* v,
                                 const float* d_o, const float* lse, const float* delta,
                                 float* dq, float* dk, float* dv, void* scratch, int B, int H,
                                 int N, int D, long long sb, long long sn, long long sh,
                                 long long ob, long long on, long long oh, float qscale,
                                 float scale, cudaStream_t st) {
  if (!shapes_ok(B, H, N, D, scratch)) return cudaErrorInvalidValue;
  const long long bhn = (long long)B * H * N, half = bhn * D;
  float* dst = static_cast<float*>(scratch);   // [B H, N, N]
  float* qc = dst + bhn * N;                   // [B H, N, D] big, small
  float* dos = qc + 2 * half;
  float* qct = dos + 2 * half;                 // [B H, D, N] big, small, queries permuted
  float* dot = qct + 2 * half;
  float* kt = dot + 2 * half;                  // [B H, D, N] big, small
  launch_split(q, sb, sn, sh, B, H, N, D, qscale, qc, qct, st, true);
  launch_split(d_o, ob, on, oh, B, H, N, D, 1.f, dos, dot, st, true);
  launch_split(k, sb, sn, sh, B, H, N, D, 1.f, nullptr, kt, st);
  cudaError_t err =
      D == 64 ? launch_dkdv<64>(k, v, sb, sn, sh, qc, dos, qct, dot, lse, delta, dst, dk, dv, B,
                                H, N, ob, on, oh, st)
              : launch_dkdv<128>(k, v, sb, sn, sh, qc, dos, qct, dot, lse, delta, dst, dk, dv, B,
                                 H, N, ob, on, oh, st);
  if (err != cudaSuccess) return err;
  return D == 64 ? launch_dq<8>(dst, kt, dq, B, H, N, D, ob, on, oh, scale, st)
                 : launch_dq<16>(dst, kt, dq, B, H, N, D, ob, on, oh, scale, st);
}

}  // namespace vst
