// Dense attention forward for Hopper (sm_90a), [B, N, H, D] layout read
// through strides, any head width D % 64 == 0 (f32: dense_attn_tf32.cu at
// D = 64 and 128, dense_attn_tf32_wide.cu from 192 up; bf16 above 2048:
// dense_attn_scores.cu; all launched from the dispatch below).
//
// Replaces: vae_song_tpu/ops/denseattn.py:_fwd_kernel_packed (K1, called
// through _call_fwd_packed: 64-wide heads in pairs) and
// vae_song_tpu/ops/denseattn.py:_fwd_kernel (K3f, called through _call_fwd:
// the [B*H, N, D] layout, any D % 64 == 0). The two compute the same
// function with the same roundings, so one kernel serves both; the
// wrappers count the two routes apart. Same function and roundings:
//   qc = round_to_input_dtype(q * scale * log2e)
//   S2 = qc k^T (f32 accumulation), m = exact row max,
//   P  = exp2(S2 - m) (bf16 inputs: argument and result rounded to bf16),
//   O  = (P v) / rowsum(P), rowsum taken over the rounded P in f32,
//   LSE2 = m + log2(rowsum(P))  (the base-2 residual the backward reads).
//
// What bounds it here: the TPU kernel keeps a whole [N, N] row block of
// scores in VMEM (16.8 MB at N = 2048); one SM has 227 KB of shared
// memory, so the scores are never held whole: each block walks the keys
// with an online softmax, and only q, k, v, O and LSE touch device memory.
// At the main-path shape (B = 64, N = 2048, H D = 256) one call is
// 4 B H N^2 D = 2.75e11 flop against 0.27 GB of traffic: the tensor cores
// are the bound (0.28 ms at 989 TFLOP/s). Next come the B H N^2 score
// elements, each an exp2 on the MUFU unit (16 a clock per SM: as long as
// the tensor cores' work at D = 64, half of it at D = 128) and about seven
// other instructions, issued while no product of that warpgroup is in
// flight.
//
// bf16 at D = 64 to 256 (every configured path): a warp-specialised
// wgmma kernel (sm90.cuh). A block owns 64 NC query rows of one (b, h):
// NC consumer warpgroups of 64 rows and a producer warpgroup, one thread
// of which issues the TMA loads. Q is loaded once; K and V stream in
// tiles of KT keys through a ring of stages (KT = 128 at D = 64 and 128,
// 4 and 3 stages, 230 KB of shared memory; KT = 64 at D = 192 and 256, 3
// and 2 stages, 193 KB) with full barriers for K and V apart and one
// empty barrier a stage. Every tile is 128-byte-swizzled panels of 64
// columns, written by 4-D TMA boxes over the strided views (dims D, H,
// N, B). Each consumer warpgroup rewrites its Q rows in place as qc
// (prescaled, rounded two values per conversion), fences the writes for
// the async proxy and meets at a barrier; then S = qc K^T is a wgmma with
// both operands in shared memory (m64n128 or m64n64, K-major). P is
// computed in the accumulator layout, which is also the A layout of the
// next product, by p_pair (mma_bf16.cuh: two values per conversion, the
// function the backward uses); the row max and sum are taken over the
// four threads of a row. O += P V is a register-A wgmma with V read
// MN-major through its descriptor: no transposed copy (one m64n64 product
// a 64-column panel of the head from D = 192). O is held at full width
// (D / 2 f32 registers a thread: 128 at D = 256, which is why the key
// tile halves there: a 128-key S tile and its P would add 96 registers
// and pass the 240 a consumer thread gets) and rescaled by
// exp2(m_old - m_new) in the softmax, after the previous product's wait.
// P V of tile j and S of tile j + 1 go out back to back as one burst,
// and the two warpgroups take turns (a ping-pong on named barriers): one's
// softmax runs while the other's burst keeps the tensor cores busy. A
// software pipeline that keeps a product in flight across the softmax
// made ptxas serialise the wgmmas (C7511), as it did in the backward. The
// epilogue stores O times 1 / l (one division a row; within an f32 ulp of
// O / l before the rounding to bf16) as bf16x2, and LSE2 per row.
//
// Keys past N: N is a multiple of 64, so at KT = 128 the last tile may
// hold 64 rows past N, which TMA fills with zeros. A zero key would give
// S2 = 0 and enter the softmax, so those scores are set to -inf (P = 0).
// Query rows past N are computed on zeros and not stored.
//
// Launch shape: NC = 2 (384 threads, the producer giving its registers
// to the consumers: setmaxnreg 24 / 240) unless B H N / 128 blocks would
// leave SMs idle; then NC = 1 (256 threads, 64-row blocks), so the
// decoder's batch-constant layer at B = 1 (B H N / 128 = 64 at the
// shipped config, 16 with one head) still spreads over more SMs.
//
// The row max is the exact running max (never a norm bound: a bound
// underflowed whole rows to 0/0 under training transients,
// denseattn.py:88-96); exp2(s - m) has a 1.0 entry per tile at the max,
// so the row sum is >= 1 and log2 is safe. Because the softmax is online,
// P is rounded to bf16 against the running max of the KT-key tiles rather
// than the final row max: the values differ from the TPU kernel within
// bf16 rounding (tests/test_torch_denseattn_bf16wide.py models the 64-key
// order and holds it to the TPU kernel).
//
// bf16 at D = 320 to 512 (`num_heads: 1` at d_model 320 to 512): O at
// full width would take D / 2 = 256 f32 registers a thread at D = 512,
// and one 64-key K or V tile 64 KB beside the 64 KB Q tile. So a block
// owns 64 query rows, shared by two consumer warpgroups, and the head's P
// = D / 64 panels are split twice: warpgroup 0 sums the scores over panels
// [0, ceil(P / 2)) and accumulates O on [0, floor(P / 2)), warpgroup 1 the
// rest, so each issues P panel products a key tile and holds at most four
// panels of O (128 registers). The two partial score tiles (64 x 64 f32)
// are swapped through two 16 KB slots of shared memory at a named barrier
// and added: f32 addition commutes, so both warpgroups hold the same S
// bits and run the same online softmax (twice, small beside the
// products). Each warpgroup has a ring of its own of 64 x 64 panel stages
// (8 or 9, as many as fit: 217-225 KB of shared memory a block with Q and
// the exchange) that one producer thread fills: for each key tile the K
// panels of its score share, then the V panels of its output share. qc is
// prescaled once, in place in the resident Q. Every product is made once:
// 4 B H N^2 D. P V of tile j and the partial scores of tile j + 1 go out
// as one burst once all their stages have landed; the last tile is peeled
// off, so that no wgmma issue sits under a branch (a conditional burst
// made ptxas serialise the wgmmas, advisory C7520). What bounds it beside
// the tensor cores: each 64-row block reads the head's whole K and V (4
// MB at N = 2048, D = 512) through L2, 64 operations a byte read. Grid N /
// 64 x H x B: B = 1, N = 2048 runs 32 blocks on the 132 SMs.
//
// bf16 at D = 576 to 2048 (`num_heads: 1` at d_model 576 to 2048): one
// block can no longer hold a 64-row block's qc beside rings of K and V
// panels (8 P KB of Q alone), nor a thread O's columns. So a thread-block
// cluster of C CTAs (3 up to P = 12 panels, 4 up to 16, 8 above) shares a
// block of 128 queries and splits the head's panels, 2 to 4 a CTA
// (cluster_first). Each CTA holds qc on its panels and streams K and V on
// them through one ring of 64 x 64 panel stages that both consumer
// warpgroups read (a warpgroup a 64-row half of the block, O on the CTA's
// panels: at most 128 registers); per key tile each warpgroup sums its
// partial scores over the CTA's panels (a chain of one commit group a
// panel, each stage given back once the group after it completes), then
// the cluster sums each 64 x 64 partial tile over its CTAs
// (vst::ClusterSum: a reduce-scatter and an all-gather through
// distributed shared memory, st.async into the other CTAs, 21-28 KB a
// warpgroup a tile; the partials added in f32 in rank order, so every CTA
// holds the same S bits and runs the same online softmax), then O += P V
// on the CTA's panels and the next tile's chain go out back to back. CTA
// 0 writes LSE2. Every product is made once: 4 B H N^2 D. What bounds it
// beside the tensor cores: the cluster sums' traffic through the SMs'
// network (about 43 KB a CTA a key tile) and their two waits a tile, in
// which the warpgroup issues no product. The kernel is compiled for each
// C (the sum's loops unroll). Wider bf16 heads take the kernels of
// dense_attn_scores.cu, which write the scores out: the dense gate caps N
// at 2048, so there a head's [N, N] scores are smaller than its q [N, D],
// and the forward is S2 = qc k^T into an f32 scratch, a row pass and O =
// P V, each a product made once (4 B H N^2 D).
//
// f32 inputs (mixed_precision: false), the f32 path of the same two TPU
// kernels (their "parity path", cd = f32: denseattn.py:82-85), are split
// TF32 on wgmma fed by TMA at every width, launched from the dispatch
// below: at D = 64 and 128 dense_attn_tf32.cu's kernel, which keeps the
// scores on chip (a block of 128 queries, qc split in registers, K and V^T
// split ahead by a pre-pass, the online softmax, P the register A operand
// of P V); from D = 192 dense_attn_tf32_wide.cu's products over
// written-out scores. Both are tested on the CPU by
// tests/test_torch_denseattn_f32split.py's emulation of their order of
// work, and on the card by chip_smoke.py phase 3 and
// scripts/ab_attn_f32.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "dense_attn_scores.cuh"
#include "dense_attn_tf32.cuh"
#include "dense_attn_tf32_wide.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vst::pack_bf16;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- bf16, D = 64 to 256: warp-specialised wgmma kernel --------------------

constexpr uint32_t kPanel64 = 64 * vst::kPanelRowBytes;        // 64-row panel

// Shared memory, byte offsets from a 1024-byte aligned base: the Q tile
// (P panels of 64 NC rows, rewritten in place as qc), the ring's stages
// (a K tile, then a V tile, each P panels of KT rows), then the
// mbarriers (Q, full K[], full V[], empty[]).
template <int D, int NC>
struct FwdSmem {
  static constexpr int P = D / 64;
  static constexpr int KT = D <= 128 ? 128 : 64;                 // keys a ring stage
  static constexpr int kStages = D == 64 ? 4 : D == 256 ? 2 : 3;
  static constexpr uint32_t kv_panel = KT * vst::kPanelRowBytes;
  static constexpr uint32_t q_panel = NC * kPanel64;
  static constexpr uint32_t stage0 = P * q_panel;
  static constexpr uint32_t kv_bytes = P * kv_panel;             // one K or V tile
  static constexpr uint32_t stage_bytes = 2 * kv_bytes;
  static constexpr uint32_t bars = stage0 + kStages * stage_bytes;
  static constexpr size_t bytes = bars + 8 * (1 + 3 * kStages) + 1024;   // + alignment
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// Named barriers 1 .. NC order the consumer warpgroups' products (the
// ping-pong); 4 + w closes warpgroup w's rewrite of its Q rows.
using vst::named_arrive;
using vst::named_sync;

// Compile-time arms of the wgmma kernel below, for the A/B harness
// scripts/ab_attn_arms.py: the ports of the TPU ablations of K1
// (scripts/ab_attn_ablate5.py's bf16 max, ab_attn_ablate6.py's strips).
// scripts/ab_attn_arms.cu instantiates them (D = 64); the package launches
// kFwdFull only, for which every hook compiles away.
//   kFwdBf16Max (exact): the scores rounded to bf16 before the row max,
//     the max and the shift then taken on bf16 pairs two at a time
//     (__hmax2, and __hsub2, which rounds the exact difference once:
//     bf16(bf16(S2) - m)); rounding is monotone, so the running max of the
//     rounded scores is the rounded running max; LSE2 = m + log2(l) with
//     that bf16 m.
//   Strips, timing only: kFwdNoExp P = bf16(S2 - m), no exp2; kFwdNoMax m =
//     0, no row max and no rescale; kFwdNoPv no P V product (O = 0);
//     kFwdSOnly the S2 product alone, each tile added into O's
//     accumulator so that it is not dropped.
enum FwdArm : int {
  kFwdFull = 0,
  kFwdBf16Max, kFwdNoExp, kFwdNoMax, kFwdNoPv, kFwdSOnly,
  kFwdArms
};

// Issue S2 = qc K^T (64 queries x KT keys; qc at qw in P panels q_panel
// apart, the K tile at kt) as one commit group.
template <int D, int KT>
__device__ __forceinline__ void issue_scores(float (&sc)[KT / 8][4], uint32_t qw,
                                             uint32_t q_panel, uint32_t kt) {
  constexpr uint32_t kv_panel = KT * vst::kPanelRowBytes;
  vst::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = vst::desc_kmajor(qw + (kk / 4) * q_panel, kk % 4);
    const uint64_t db = vst::desc_kmajor(kt + (kk / 4) * kv_panel, kk % 4);
    if constexpr (KT == 128)
      vst::wgmma_ss_n128_t<0, 0>(sc, da, db, kk > 0);
    else
      vst::wgmma_ss_n64_t<0, 0>(sc, da, db, kk > 0);
  }
  vst::wgmma_commit();
}

// Issue O += P V (V at vt read MN-major: the contraction runs along its
// rows) as one commit group; from D = 192 one m64n64 product a 64-column
// panel of O.
template <int D, int KT>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 8][4], const uint32_t (&pa)[KT / 16][4],
                                         uint32_t vt) {
  constexpr uint32_t kv_panel = KT * vst::kPanelRowBytes;
  vst::fence_acc(acc);
  vst::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KT / 16; ++kc) {
    if constexpr (D == 64) {
      vst::wgmma_rs_n64_t<1>(acc, pa[kc], vst::desc_mnmajor(vt, kc, kv_panel));
    } else if constexpr (D == 128) {
      vst::wgmma_rs_n128_t<1>(acc, pa[kc], vst::desc_mnmajor(vt, kc, kv_panel));
    } else {
      vst::wgmma_rs_n64_t<1, 0>(acc, pa[kc], vst::desc_mnmajor(vt, kc, kv_panel));
      vst::wgmma_rs_n64_t<1, 8>(acc, pa[kc], vst::desc_mnmajor(vt + kv_panel, kc, kv_panel));
      vst::wgmma_rs_n64_t<1, 16>(acc, pa[kc],
                                 vst::desc_mnmajor(vt + 2 * kv_panel, kc, kv_panel));
      if constexpr (D == 256)
        vst::wgmma_rs_n64_t<1, 24>(acc, pa[kc],
                                   vst::desc_mnmajor(vt + 3 * kv_panel, kc, kv_panel));
    }
  }
  vst::wgmma_commit();
}

// kFwdBf16Max's softmax_p: the scores rounded to bf16 pairs first, the
// row max over the pairs, and P = exp2(bf16(s - m)) from one bf16x2
// subtraction a pair.
template <int KT>
__device__ __forceinline__ void softmax_p_bf16max(const float (&sc)[KT / 8][4], float& m0,
                                                  float& m1, float& l0, float& l1, float& a0,
                                                  float& a1, uint32_t (&pa)[KT / 16][4]) {
  auto bf2 = [](uint32_t x) { return *reinterpret_cast<const __nv_bfloat162*>(&x); };
  auto u32 = [](__nv_bfloat162 x) { return *reinterpret_cast<const uint32_t*>(&x); };
  uint32_t s0[KT / 8], s1[KT / 8];
  __nv_bfloat162 x0 = __float2bfloat162_rn(m0), x1 = __float2bfloat162_rn(m1);
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    s0[j] = pack_bf16(sc[j][0], sc[j][1]);
    s1[j] = pack_bf16(sc[j][2], sc[j][3]);
    x0 = __hmax2(x0, bf2(s0[j]));
    x1 = __hmax2(x1, bf2(s1[j]));
  }
  const float n0 = quad_max(fmaxf(__low2float(x0), __high2float(x0)));
  const float n1 = quad_max(fmaxf(__low2float(x1), __high2float(x1)));
  a0 = exp2f(m0 - n0);  // 0 on the first tile (m = -inf)
  a1 = exp2f(m1 - n1);
  m0 = n0;
  m1 = n1;
  const __nv_bfloat162 c0 = __float2bfloat162_rn(n0), c1 = __float2bfloat162_rn(n1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    const uint32_t d0 = u32(__hsub2(bf2(s0[j]), c0)), d1 = u32(__hsub2(bf2(s1[j]), c1));
    const uint32_t x = pack_bf16(vst::ex2_ftz(vst::bf16_lo(d0)), vst::ex2_ftz(vst::bf16_hi(d0)));
    const uint32_t y = pack_bf16(vst::ex2_ftz(vst::bf16_lo(d1)), vst::ex2_ftz(vst::bf16_hi(d1)));
    pa[j >> 1][(j & 1) * 2] = x;
    pa[j >> 1][(j & 1) * 2 + 1] = y;
    ps0 += vst::bf16_lo(x) + vst::bf16_hi(x);
    ps1 += vst::bf16_lo(y) + vst::bf16_hi(y);
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

// The online softmax of one tile of scores, rows r and r + 8 of the
// thread: the new running max (m0, m1; at KT = 128 keys from 64 on masked
// when `ragged_tile`), the row sums l0, l1 (this thread's share) rescaled
// by exp2(m_old - m_new), returned in a0, a1 for the accumulator, and P
// into A fragments (k-step kc covers keys 16 kc .. + 15). kArm: an arm
// above (the package's kernel: kFwdFull).
template <int KT, int kArm = kFwdFull>
__device__ __forceinline__ void softmax_p(float (&sc)[KT / 8][4], bool ragged_tile, float& m0,
                                          float& m1, float& l0, float& l1, float& a0, float& a1,
                                          uint32_t (&pa)[KT / 16][4]) {
  if constexpr (KT == 128) {
    if (ragged_tile) {   // keys N .. N + 63 are TMA's zeros
#pragma unroll
      for (int j = 8; j < 16; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = -INFINITY;
    }
  }
  if constexpr (kArm == kFwdBf16Max) {
    softmax_p_bf16max<KT>(sc, m0, m1, l0, l1, a0, a1, pa);
    return;
  }
  float n0 = m0, n1 = m1;
  if constexpr (kArm == kFwdNoMax) {
    n0 = n1 = 0.f;
    a0 = a1 = 1.f;
  } else {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      n0 = fmaxf(n0, fmaxf(sc[j][0], sc[j][1]));
      n1 = fmaxf(n1, fmaxf(sc[j][2], sc[j][3]));
    }
    n0 = quad_max(n0);
    n1 = quad_max(n1);
    a0 = exp2f(m0 - n0);  // 0 on the first tile (m = -inf)
    a1 = exp2f(m1 - n1);
  }
  m0 = n0;
  m1 = n1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    uint32_t x, y;
    if constexpr (kArm == kFwdNoExp) {
      x = pack_bf16(sc[j][0] - n0, sc[j][1] - n0);
      y = pack_bf16(sc[j][2] - n1, sc[j][3] - n1);
    } else {
      x = vst::p_pair(sc[j][0] - n0, sc[j][1] - n0);
      y = vst::p_pair(sc[j][2] - n1, sc[j][3] - n1);
    }
    pa[j >> 1][(j & 1) * 2] = x;
    pa[j >> 1][(j & 1) * 2 + 1] = y;
    ps0 += vst::bf16_lo(x) + vst::bf16_hi(x);
    ps1 += vst::bf16_lo(y) + vst::bf16_hi(y);
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

// softmax_p, then the accumulator rescaled by exp2(m_old - m_new) (not
// for kFwdNoMax, whose shift stays 0).
template <int D, int KT, int kArm = kFwdFull>
__device__ __forceinline__ void softmax_tile(float (&sc)[KT / 8][4], bool ragged_tile,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float (&acc)[D / 8][4],
                                             uint32_t (&pa)[KT / 16][4]) {
  float a0, a1;
  softmax_p<KT, kArm>(sc, ragged_tile, m0, m1, l0, l1, a0, a1, pa);
  if constexpr (kArm == kFwdNoMax) return;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] *= a0;
    acc[j][1] *= a0;
    acc[j][2] *= a1;
    acc[j][3] *= a1;
  }
}

// The block of the wgmma kernel (kArm: an arm above; the package's kernel
// is kFwdFull). Grid (ceil(N / (64 NC)), H, B), 128 (NC + 1) threads.
// Warpgroup w < NC owns queries q0 + 64 w .. + 63, its warp i the 16 rows
// 16 i .. of those; in the accumulator layout lane = 4 g + t holds rows g
// and g + 8, columns 8 j + 2 t and 8 j + 2 t + 1 of each 8-column block j.
template <int D, int NC, int kArm>
__device__ __forceinline__ void fwd_wgmma_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                                const CUtensorMap* mv, bf16* __restrict__ o,
                                                float* __restrict__ lse, int H, int N,
                                                long long ob, long long on, long long oh,
                                                float qscale) {
  using L = FwdSmem<D, NC>;
  constexpr int P = L::P, KT = L::KT, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_bar = base + L::bars, full_k0 = q_bar + 8;
  const uint32_t full_v0 = full_k0 + 8 * kStages, empty0 = full_v0 + 8 * kStages;
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z;
  const int nk = (N + KT - 1) / KT;
  if (threadIdx.x == 0) {
    vst::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      vst::mbar_init(full_k0 + 8 * s, 1);
      vst::mbar_init(full_v0 + 8 * s, 1);
      vst::mbar_init(empty0 + 8 * s, 4 * NC);   // one arrival a consumer warp
    }
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  auto k_full = [&](int it) { return full_k0 + 8 * (it % kStages); };
  auto v_full = [&](int it) { return full_v0 + 8 * (it % kStages); };
  auto parity = [&](int it) { return (uint32_t)((it / kStages) & 1); };
  auto kt_of = [&](int it) { return base + L::stage0 + (it % kStages) * L::stage_bytes; };

  if (wg == NC) {   // producer
    if constexpr (NC == 2) vst::regs_dealloc<24>();
    if (threadIdx.x == 128 * NC) {
      vst::mbar_arrive_expect_tx(q_bar, P * L::q_panel);
      for (int p = 0; p < P; ++p)
        for (int half = 0; half < NC; ++half)
          vst::tma_load_4d(base + p * L::q_panel + half * kPanel64, mq, q_bar, 64 * p, h,
                           q0 + 64 * half, b);
      // the last kStages waits let the consumers release every stage
      for (int it = 0; it < nk + kStages; ++it) {
        vst::mbar_wait(empty0 + 8 * (it % kStages), parity(it) ^ 1);
        if (it >= nk) continue;
        const uint32_t st = kt_of(it);
        vst::mbar_arrive_expect_tx(k_full(it), L::kv_bytes);
        for (int p = 0; p < P; ++p)
          for (int half = 0; half < KT / 64; ++half)
            vst::tma_load_4d(st + p * L::kv_panel + half * kPanel64, mk, k_full(it), 64 * p, h,
                             it * KT + 64 * half, b);
        vst::mbar_arrive_expect_tx(v_full(it), L::kv_bytes);
        for (int p = 0; p < P; ++p)
          for (int half = 0; half < KT / 64; ++half)
            vst::tma_load_4d(st + L::kv_bytes + p * L::kv_panel + half * kPanel64, mv,
                             v_full(it), 64 * p, h, it * KT + 64 * half, b);
      }
    }
    return;
  }

  // consumers
  if constexpr (NC == 2) vst::regs_alloc<240>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;   // the thread's first row in its warpgroup's 64
  const uint32_t qw = base + wg * kPanel64;   // this warpgroup's 64 rows of Q

  // qc = round_bf16(q * qscale), written back in place: the fragments of
  // the warpgroup's threads (rows r, r + 8; columns 16 kk + 2 t, + 8)
  // cover its rows once. Generic-proxy writes that wgmma (the async
  // proxy) reads: fenced, then the warpgroup meets at a barrier.
  vst::mbar_wait(q_bar, 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned char* panel = gbase + (kk / 4) * L::q_panel + wg * kPanel64;
    auto prescale = [&](int row, int col) {
      uint32_t* at = reinterpret_cast<uint32_t*>(panel + vst::swizzled(row, col));
      *at = pack_bf16(vst::bf16_lo(*at) * qscale, vst::bf16_hi(*at) * qscale);
    };
    const int c = 16 * (kk % 4) + 2 * t;
    prescale(r, c);
    prescale(r + 8, c);
    prescale(r, c + 8);
    prescale(r + 8, c + 8);
  }
  vst::fence_proxy_async();
  named_sync(4 + wg, 128);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r and r + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  const bool ragged = (N % KT) != 0;

  // P V of tile it and S of tile it + 1 go out back to back, so no product
  // is in flight during a softmax. With two warpgroups the pairs take
  // turns (ping-pong): one warpgroup's softmax runs while the other's
  // products do.
  constexpr bool kPingpong = NC == 2;
  if constexpr (kPingpong) {
    if (wg == 1) named_arrive(1, 256);   // warpgroup 0 goes first
  }
  float sc[KT / 8][4];
  vst::mbar_wait(k_full(0), 0);
  issue_scores<D, KT>(sc, qw, L::q_panel, kt_of(0));
  vst::wgmma_wait<0>();
  vst::fence_acc(sc);
  for (int it = 0; it < nk; ++it) {
    uint32_t pa[KT / 16][4];
    if constexpr (kArm == kFwdSOnly) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j % (D / 8)][e] += sc[j][e];
    } else {
      softmax_tile<D, KT, kArm>(sc, ragged && it == nk - 1, m0, m1, l0, l1, acc, pa);
    }
    if constexpr (kPingpong) named_sync(1 + wg, 256);
    vst::mbar_wait(v_full(it), parity(it));
    if constexpr (kArm != kFwdSOnly && kArm != kFwdNoPv)
      issue_pv<D, KT>(acc, pa, kt_of(it) + L::kv_bytes);
    if (it + 1 < nk) {
      vst::mbar_wait(k_full(it + 1), parity(it + 1));
      issue_scores<D, KT>(sc, qw, L::q_panel, kt_of(it + 1));
    }
    if constexpr (kPingpong) named_arrive(2 - wg, 256);
    vst::wgmma_wait<0>();
    vst::fence_acc(acc);
    vst::fence_acc(sc);
    __syncwarp();
    if (lane == 0) vst::mbar_arrive(empty0 + 8 * (it % kStages));   // release the stage
  }
  if constexpr (kPingpong) {
    if (wg == 0) named_sync(1, 256);   // the arrival left from warpgroup 1's last tile
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int row0 = q0 + 64 * wg + r;
  float* lrow = lse + ((long long)b * H + h) * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= N) continue;
    const float l = half ? l1 : l0, inv = 1.f / l;
    bf16* dst = o + (long long)b * ob + (long long)row * on + (long long)h * oh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * half] * inv, acc[j][2 * half + 1] * inv);
    if (t == 0) lrow[row] = (half ? m1 : m0) + log2f(l);
  }
}

template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
dense_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                            float* __restrict__ lse, int H, int N, long long ob, long long on,
                            long long oh, float qscale) {
  fwd_wgmma_block<D, NC, kFwdFull>(&mq, &mk, &mv, o, lse, H, N, ob, on, oh, qscale);
}

// ---- bf16, D = 320 to 512: wgmma kernel with the scores split ------------

// The head's P = D / 64 panels are split between the two consumer
// warpgroups twice: warpgroup 0 sums the scores over panels [0, s0) and
// accumulates O on [0, o0), warpgroup 1 the scores over [s0, P) and O on
// [o0, P), with s0 = ceil(P / 2) and o0 = floor(P / 2), so each issues P
// panels of products a key tile.
__host__ __device__ constexpr int wider_score_split(int P) { return (P + 1) / 2; }
__host__ __device__ constexpr int wider_out_split(int P) { return P / 2; }

// Shared memory at P panels (P known at run time), byte offsets from a
// 1024-byte aligned base: the block's 64 rows of Q (P panels, rewritten
// in place as qc), the exchange (two 16 KB slots of partial scores, slot
// w warpgroup w's), each warpgroup's ring of 64 x 64 panel stages (as
// many as fit, at most kMaxStages), then the mbarriers (Q, then for each
// warpgroup full[stages] and empty[stages]).
struct WiderFwdSmem {
  static constexpr int kMaxStages = 12;
  static constexpr uint32_t kSlot = 64 * 64 * 4;
  uint32_t xch, ring0, bars;
  int stages;
  size_t bytes;
  __host__ __device__ explicit WiderFwdSmem(int P) {
    xch = P * kPanel64;
    ring0 = xch + 2 * kSlot;
    const uint32_t fixed = ring0 + 8 * (1 + 4 * kMaxStages) + 1024;
    stages = (232448 - static_cast<int>(fixed)) / static_cast<int>(2 * kPanel64);
    if (stages > kMaxStages) stages = kMaxStages;
    bars = ring0 + 2 * stages * kPanel64;
    bytes = bars + 8 * (1 + 4 * stages) + 1024;   // + alignment
  }
};

// Consumer warpgroup w of the forward for heads of 320 to 512, on PS
// score panels from sf and PO output panels from of (32 PO accumulator
// registers a thread). Per key tile the warpgroup sums its partial scores
// over its score panels (qc resident, the K panels the ring's items),
// writes them to its exchange slot and adds the other warpgroup's: f32
// addition commutes, so both hold the same S bits and run the same online
// softmax; then O += P V on its own panels (V the ring's next PO items).
// P V of tile it and the partial scores of tile it + 1 go out as one
// burst, once every stage they read has landed (no wait, and no branch,
// between the wgmma issues); a stage is released once the burst that read
// it has completed.
template <int PS, int PO>
__device__ __forceinline__ void fwd_wider_consumer(uint32_t base, unsigned char* gbase,
                                                   const WiderFwdSmem& L, int nk, int w, int sf,
                                                   int of, uint32_t q_bar, uint32_t full0,
                                                   uint32_t empty0, bf16* __restrict__ o,
                                                   float* __restrict__ lse, int H, int N, int q0,
                                                   int h, int b, long long ob, long long on,
                                                   long long oh, float qscale) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;   // the thread's first row of the 64

  // qc = round_bf16(q * qscale) in place on this warpgroup's score panels
  // (the fragments of its threads cover each panel's 64 rows once), fenced
  // for the async proxy; the warpgroup meets at a barrier.
  vst::mbar_wait(q_bar, 0);
#pragma unroll
  for (int i = 0; i < PS; ++i) {
    unsigned char* panel = gbase + (sf + i) * kPanel64;
    auto prescale = [&](int row, int col) {
      uint32_t* at = reinterpret_cast<uint32_t*>(panel + vst::swizzled(row, col));
      *at = pack_bf16(vst::bf16_lo(*at) * qscale, vst::bf16_hi(*at) * qscale);
    };
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t;
      prescale(r, c);
      prescale(r + 8, c);
      prescale(r, c + 8);
      prescale(r + 8, c + 8);
    }
  }
  vst::fence_proxy_async();
  named_sync(3 + w, 128);

  float* xch = reinterpret_cast<float*>(gbase + L.xch);
  float* mine = xch + w * (L.kSlot / 4);
  const float* theirs = xch + (1 - w) * (L.kSlot / 4);
  vst::RingConsumer ring{base + L.ring0 + w * L.stages * kPanel64, kPanel64, full0, empty0,
                         L.stages, lane};
  const uint32_t qw = base + sf * kPanel64;
  // the partial scores: x = qc[:, score panels] K[:, score panels]^T
  // (K the ring's PS items from stage k0)
  auto issue_scores = [&](float (&x)[8][4], int k0) {
#pragma unroll
    for (int i = 0; i < PS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vst::wgmma_ss_n64_t<0, 0>(x, vst::desc_kmajor(qw + i * kPanel64, j),
                                  vst::desc_kmajor(ring.at(k0, i), j), (i | j) != 0);
    vst::wgmma_commit();
  };
  // S = x0 + x1: each thread's 32 values, word (4 j + e) at 128 (4 j + e)
  // + tid, so a warp's accesses are 32 consecutive words. Barrier 2: the
  // other warpgroup has read this slot's previous tile; barrier 1: both
  // slots are written.
  auto exchange = [&](float (&x)[8][4]) {
    named_sync(2, 256);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 128 + tid] = x[j][e];
    named_sync(1, 256);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] += theirs[(4 * j + e) * 128 + tid];
  };

  float acc[PO][8][4];
#pragma unroll
  for (int p = 0; p < PO; ++p) vst::zero_acc(acc[p]);
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r and r + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  float x[8][4];
  int k0 = ring.wait(PS);   // the first stage of the K items a burst reads
  vst::wgmma_fence();
  issue_scores(x, k0);
  vst::wgmma_wait<0>();
  vst::fence_acc(x);
  ring.release(PS);
  exchange(x);
  // one key tile: the softmax, then P V and, where another tile follows
  // (`more`, a constant in each of the two calls below), its partial
  // scores in the same burst; no wgmma issue sits under a branch
  auto tile = [&](auto more) {
    uint32_t pa[4][4];
    float a0, a1;
    softmax_p<64>(x, false, m0, m1, l0, l1, a0, a1, pa);
#pragma unroll
    for (int p = 0; p < PO; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[p][j][0] *= a0;
        acc[p][j][1] *= a0;
        acc[p][j][2] *= a1;
        acc[p][j][3] *= a1;
      }
    const int v0 = ring.wait(PO);
    if constexpr (decltype(more)::value) k0 = ring.wait(PS);
#pragma unroll
    for (int p = 0; p < PO; ++p) vst::fence_acc(acc[p]);
    vst::wgmma_fence();
#pragma unroll
    for (int p = 0; p < PO; ++p)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        vst::wgmma_rs_n64_t<1>(acc[p], pa[kc], vst::desc_mnmajor(ring.at(v0, p), kc, kPanel64));
    vst::wgmma_commit();
    if constexpr (decltype(more)::value) issue_scores(x, k0);
    vst::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < PO; ++p) vst::fence_acc(acc[p]);
    vst::fence_acc(x);
    if constexpr (decltype(more)::value) {
      ring.release(PO + PS);
      exchange(x);
    } else {
      ring.release(PO);
    }
  };
  for (int it = 0; it + 1 < nk; ++it) tile(std::true_type{});
  tile(std::false_type{});

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* lrow = lse + ((long long)b * H + h) * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r + 8 * half;
    const float l = half ? l1 : l0, inv = 1.f / l;
    bf16* dst = o + (long long)b * ob + (long long)row * on + (long long)h * oh + 64 * of;
#pragma unroll
    for (int p = 0; p < PO; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 64 * p + 8 * j + 2 * t) =
            pack_bf16(acc[p][j][2 * half] * inv, acc[p][j][2 * half + 1] * inv);
    if (w == 0 && t == 0) lrow[row] = (half ? m1 : m0) + log2f(l);
  }
}

// Grid (N / 64, H, B), 384 threads: consumer warpgroups 0 and 1 on the
// block's 64 queries q0 .. (fwd_wider_consumer), producer warpgroup 2,
// whose threads 256 and 288 feed warpgroup 0's and 1's rings: for each
// key tile the K panels of the warpgroup's score share, then the V panels
// of its output share. Thread 256 also loads Q. Every ring holds at
// least P stages, a tile's items (launch_fwd_wider checks it).
__global__ void __launch_bounds__(384, 1)
dense_attn_fwd_wider_kernel(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                            float* __restrict__ lse, int H, int N, int P, long long ob,
                            long long on, long long oh, float qscale) {
  const WiderFwdSmem L(P);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_bar = base + L.bars;
  auto full_of = [&](int w) { return q_bar + 8 + w * 16 * L.stages; };
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int nk = N / 64;
  if (threadIdx.x == 0) {
    vst::mbar_init(q_bar, 1);
    for (int w = 0; w < 2; ++w)
      vst::ring_init(full_of(w), full_of(w) + 8 * L.stages, L.stages, 4);
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int s0 = wider_score_split(P), o0 = wider_out_split(P);

  if (wg == 2) {   // producer
    vst::regs_dealloc<24>();
    const int lt = threadIdx.x - 256;
    if (lt == 0 || lt == 32) {
      const int w = lt / 32;
      const uint32_t full0 = full_of(w), empty0 = full0 + 8 * L.stages;
      const uint32_t slots = base + L.ring0 + w * L.stages * kPanel64;
      if (w == 0) {
        vst::mbar_arrive_expect_tx(q_bar, P * kPanel64);
        for (int p = 0; p < P; ++p)
          vst::tma_load_4d(base + p * kPanel64, &mq, q_bar, 64 * p, h, q0, b);
      }
      vst::RingCursor c;
      auto push = [&](const CUtensorMap* map, int p, int row) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        vst::mbar_arrive_expect_tx(full0 + 8 * c.stage, kPanel64);
        vst::tma_load_4d(slots + c.stage * kPanel64, map, full0 + 8 * c.stage, 64 * p, h, row,
                         b);
        c.advance(L.stages);
      };
      const int sf = w ? s0 : 0, sn = w ? P - s0 : s0;
      const int of = w ? o0 : 0, on_ = w ? P - o0 : o0;
      for (int it = 0; it < nk; ++it) {
        for (int p = sf; p < sf + sn; ++p) push(&mk, p, 64 * it);
        for (int p = of; p < of + on_; ++p) push(&mv, p, 64 * it);
      }
      // let the consumer release every stage before leaving
      for (int s = 0; s < L.stages; ++s) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        c.advance(L.stages);
      }
    }
    return;
  }

  // consumers: (score panels, output panels) (3, 2) and (2, 3) at D =
  // 320, (3, 3) at 384, (4, 3) and (3, 4) at 448, (4, 4) at 512
  vst::regs_alloc<240>();
  const uint32_t full0 = full_of(wg), empty0 = full0 + 8 * L.stages;
  const int ps = wg ? P - s0 : s0, po = wg ? P - o0 : o0;
#define VST_WIDER(PS, PO)                                                                   \
  fwd_wider_consumer<PS, PO>(base, gbase, L, nk, wg, wg ? s0 : 0, wg ? o0 : 0, q_bar, full0, \
                             empty0, o, lse, H, N, q0, h, b, ob, on, oh, qscale)
  if (ps == 3 && po == 2)
    VST_WIDER(3, 2);
  else if (ps == 2)
    VST_WIDER(2, 3);
  else if (ps == 3 && po == 3)
    VST_WIDER(3, 3);
  else if (ps == 4 && po == 3)
    VST_WIDER(4, 3);
  else if (ps == 3)
    VST_WIDER(3, 4);
  else
    VST_WIDER(4, 4);
#undef VST_WIDER
}

// ---- bf16, D = 576 to 2048: wgmma kernel over a cluster that splits the head

using vst::cluster_ctas;
using vst::cluster_first;

// Shared memory of the cluster forward, byte offsets from a 1024-byte
// aligned base: Q (each warpgroup's 64 rows on the CTA's panels, 4 panel
// slots each), each warpgroup's cluster-sum buffers (csum_bytes(C)), the
// ring of 64 x 64 panel stages both warpgroups read (as many as fit, at
// most kMaxStages), then the mbarriers (Q, full[stages], empty[stages],
// each warpgroup's red and gat).
struct ClusterFwdSmem {
  static constexpr int kMaxStages = 10;
  uint32_t csum, ring0, bars;
  int stages;
  size_t bytes;
  __host__ __device__ explicit ClusterFwdSmem(int C) {
    csum = 2 * 4 * kPanel64;
    ring0 = csum + 2 * vst::csum_bytes(C);
    const uint32_t fixed = ring0 + 8 * (1 + 2 * kMaxStages + 4) + 1024;
    stages = (232448 - static_cast<int>(fixed)) / static_cast<int>(kPanel64);
    if (stages > kMaxStages) stages = kMaxStages;
    bars = ring0 + stages * kPanel64;
    bytes = bars + 8 * (1 + 2 * stages + 4) + 1024;   // + alignment
  }
};

// The least ring the cluster forward runs with: a tile's PR V panels held
// while the next tile's score chain takes two more.
constexpr int kClusterFwdMinStages = 4 + 2;

// Consumer warpgroup w of the cluster forward: queries q0 + 64 w .. + 63
// on the CTA's PR panels (from panel pf of the head). Per key tile the
// warpgroup sums its partial scores over its panels (qc resident, K the
// ring's next PR items, a chain of one commit group a panel), and the
// cluster sums the partial tiles of its CTAs' warpgroups w (`csum`: every
// CTA then holds the same S bits and runs the same online softmax); then
// O += P V on its panels (V the ring's next PR items, one commit group),
// and the next tile's score chain right behind it. Both warpgroups read
// every item of the ring.
template <int PR, int C>
__device__ __forceinline__ void fwd_cluster_consumer(uint32_t base, unsigned char* gbase,
                                                     const ClusterFwdSmem& L, int nk, int w,
                                                     int pf, uint32_t q_bar, uint32_t full0,
                                                     uint32_t empty0, vst::ClusterSum<C>& csum,
                                                     bf16* __restrict__ o, float* __restrict__ lse,
                                                     int H, int N, int q0, int h, int b,
                                                     long long ob, long long on, long long oh,
                                                     float qscale) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;   // the thread's first row of its 64
  const uint32_t qw = base + w * 4 * kPanel64;

  // qc = round_bf16(q * qscale) in place on the warpgroup's panels,
  // fenced for the async proxy; the warpgroup meets at a barrier
  vst::mbar_wait(q_bar, 0);
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    unsigned char* panel = gbase + (w * 4 + i) * kPanel64;
    auto prescale = [&](int row, int col) {
      uint32_t* at = reinterpret_cast<uint32_t*>(panel + vst::swizzled(row, col));
      *at = pack_bf16(vst::bf16_lo(*at) * qscale, vst::bf16_hi(*at) * qscale);
    };
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t;
      prescale(r, c);
      prescale(r + 8, c);
      prescale(r, c + 8);
      prescale(r + 8, c + 8);
    }
  }
  vst::fence_proxy_async();
  named_sync(1 + w, 128);

  vst::RingConsumer ring{base + L.ring0, kPanel64, full0, empty0, L.stages, lane};
  // x = qc K^T over the CTA's panels: one commit group a panel, each K
  // stage given back once the group after it has completed; `held` more
  // stages (the V panels of a P V group issued just before) go back after
  // the first group
  auto chain = [&](float (&x)[8][4], int held) {
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const uint32_t kt = ring.next();
      vst::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vst::wgmma_ss_n64_t<0, 0>(x, vst::desc_kmajor(qw + i * kPanel64, j),
                                  vst::desc_kmajor(kt, j), (i | j) != 0);
      vst::wgmma_commit();
      vst::wgmma_wait<1>();
      ring.release(i == 0 ? held : 1);
    }
    vst::wgmma_wait<0>();
    ring.release(1);
    vst::fence_acc(x);
  };

  float acc[PR][8][4];
#pragma unroll
  for (int p = 0; p < PR; ++p) vst::zero_acc(acc[p]);
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r and r + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  float x[8][4];
  chain(x, 0);
  csum(x, tid);
  // one key tile: the softmax, then P V and, where another tile follows
  // (`more`, a constant in each of the two calls below), its score chain
  auto tile = [&](auto more) {
    uint32_t pa[4][4];
    float a0, a1;
    softmax_p<64>(x, false, m0, m1, l0, l1, a0, a1, pa);
#pragma unroll
    for (int p = 0; p < PR; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[p][j][0] *= a0;
        acc[p][j][1] *= a0;
        acc[p][j][2] *= a1;
        acc[p][j][3] *= a1;
      }
    const int v0 = ring.wait(PR);
#pragma unroll
    for (int p = 0; p < PR; ++p) vst::fence_acc(acc[p]);
    vst::wgmma_fence();
#pragma unroll
    for (int p = 0; p < PR; ++p)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        vst::wgmma_rs_n64_t<1>(acc[p], pa[kc], vst::desc_mnmajor(ring.at(v0, p), kc, kPanel64));
    vst::wgmma_commit();
    if constexpr (decltype(more)::value) {
      chain(x, PR);
#pragma unroll
      for (int p = 0; p < PR; ++p) vst::fence_acc(acc[p]);
      csum(x, tid);
    } else {
      vst::wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < PR; ++p) vst::fence_acc(acc[p]);
      ring.release(PR);
    }
  };
  for (int it = 0; it + 1 < nk; ++it) tile(std::true_type{});
  tile(std::false_type{});

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* lrow = lse + ((long long)b * H + h) * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 64 * w + r + 8 * half;
    if (row >= N) continue;
    const float l = half ? l1 : l0, inv = 1.f / l;
    bf16* dst = o + (long long)b * ob + (long long)row * on + (long long)h * oh + 64 * pf;
#pragma unroll
    for (int p = 0; p < PR; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 64 * p + 8 * j + 2 * t) =
            pack_bf16(acc[p][j][2 * half] * inv, acc[p][j][2 * half + 1] * inv);
    if (csum.me == 0 && t == 0) lrow[row] = (half ? m1 : m0) + log2f(l);
  }
}

// Grid (C N / 128 rounded up, H, B) in clusters of C = cluster_ctas(P)
// along x, 384 threads: block x = 128-query block * C + cluster rank.
// One kernel for each C (3, 4, 8).
// Consumer warpgroups 0 and 1 on queries q0 .. + 63 and q0 + 64 .. + 127
// (fwd_cluster_consumer); producer warpgroup 2, one thread of which loads
// both warpgroups' Q panels, then for each key tile the K panels of the
// CTA, then its V panels, into the ring both consumers read.
template <int C>
__global__ void __launch_bounds__(384, 1)
dense_attn_fwd_cluster_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                              float* __restrict__ lse, int H, int N, int P, long long ob,
                              long long on, long long oh, float qscale) {
  const ClusterFwdSmem L(C);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_bar = base + L.bars, full0 = q_bar + 8, empty0 = full0 + 8 * L.stages;
  const uint32_t xbar0 = empty0 + 8 * L.stages;   // warpgroup w: red at + 16 w, gat + 8
  const int rank = vst::cluster_rank();
  const int q0 = (blockIdx.x / C) * 128, h = blockIdx.y, b = blockIdx.z;
  const int pf = cluster_first(P, rank), pr = cluster_first(P, rank + 1) - pf;
  const int nk = N / 64;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    vst::mbar_init(q_bar, 1);
    vst::ring_init(full0, empty0, L.stages, 8);
    for (int i = 0; i < 4; ++i) vst::mbar_init(xbar0 + 8 * i, 4);
    vst::mbar_fence_init();
  }
  __syncthreads();
  vst::ClusterSum<C> csum{base + L.csum + wg * vst::csum_bytes(C),
                       base + L.csum + wg * vst::csum_bytes(C) + vst::csum_gat(C),
                          xbar0 + 16 * wg, xbar0 + 16 * wg + 8, rank, 0};
  if (wg < 2) csum.arm(threadIdx.x & 127);
  vst::cluster_sync();   // every CTA's barriers are ready before any remote store

  if (wg == 2) {   // producer
    vst::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      vst::mbar_arrive_expect_tx(q_bar, 2 * pr * kPanel64);
      for (int w = 0; w < 2; ++w)
        for (int i = 0; i < pr; ++i)
          vst::tma_load_4d(base + (w * 4 + i) * kPanel64, &mq, q_bar, 64 * (pf + i), h,
                           q0 + 64 * w, b);
      vst::RingCursor c;
      auto push = [&](const CUtensorMap* map, int p, int row) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        vst::mbar_arrive_expect_tx(full0 + 8 * c.stage, kPanel64);
        vst::tma_load_4d(base + L.ring0 + c.stage * kPanel64, map, full0 + 8 * c.stage, 64 * p,
                         h, row, b);
        c.advance(L.stages);
      };
      for (int it = 0; it < nk; ++it) {
        for (int i = 0; i < pr; ++i) push(&mk, pf + i, 64 * it);
        for (int i = 0; i < pr; ++i) push(&mv, pf + i, 64 * it);
      }
      // let the consumers release every stage before leaving
      for (int s = 0; s < L.stages; ++s) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        c.advance(L.stages);
      }
    }
    return;
  }

  vst::regs_alloc<240>();
#define VST_CLUSTER(PR)                                                                       \
  fwd_cluster_consumer<PR, C>(base, gbase, L, nk, wg, pf, q_bar, full0, empty0, csum, o, lse, H, \
                           N, q0, h, b, ob, on, oh, qscale)
  if (pr == 2)
    VST_CLUSTER(2);
  else if (pr == 3)
    VST_CLUSTER(3);
  else
    VST_CLUSTER(4);
#undef VST_CLUSTER
  vst::cluster_sync();   // no CTA leaves while another may still store into it
}

// bf16 at D = 320 to 512: the wgmma kernel with the scores split, over
// tensor maps of q, k, v.
cudaError_t launch_fwd_wider(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int N, int D, long long sb, long long sn, long long sh,
                             long long ob, long long on, long long oh, float qscale,
                             cudaStream_t st) {
  const int P = D / 64;
  const WiderFwdSmem L(P);
  if (L.stages < P) return cudaErrorInvalidValue;   // a key tile's items must fit a ring
  CUtensorMap mq, mk, mv;
  if (!vst::bhnd_tensor_map(&mq, q, B, N, H, D, sb, sn, sh) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, D, sb, sn, sh) ||
      !vst::bhnd_tensor_map(&mv, v, B, N, H, D, sb, sn, sh))
    return cudaErrorInvalidValue;
  const cudaError_t err = vst::allow_smem(dense_attn_fwd_wider_kernel, L.bytes);
  if (err != cudaSuccess) return err;
  dense_attn_fwd_wider_kernel<<<dim3(N / 64, H, B), 384, L.bytes, st>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), H, N, P, ob, on, oh, qscale);
  return cudaGetLastError();
}

// bf16 at D = 576 to 2048: the cluster kernel over tensor maps of q, k, v.
template <int C>
cudaError_t launch_fwd_cluster_c(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int B, int H, int N, int D, long long sb, long long sn,
                                 long long sh, long long ob, long long on, long long oh,
                                 float qscale, cudaStream_t st) {
  const ClusterFwdSmem L(C);
  if (L.stages < kClusterFwdMinStages) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!vst::bhnd_tensor_map(&mq, q, B, N, H, D, sb, sn, sh) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, D, sb, sn, sh) ||
      !vst::bhnd_tensor_map(&mv, v, B, N, H, D, sb, sn, sh))
    return cudaErrorInvalidValue;
  const cudaError_t err = vst::allow_smem(dense_attn_fwd_cluster_kernel<C>, L.bytes);
  if (err != cudaSuccess) return err;
  return vst::launch_cluster(dense_attn_fwd_cluster_kernel<C>,
                             dim3(C * ((N + 127) / 128), H, B), 384, L.bytes, C, st, mq, mk, mv,
                             static_cast<bf16*>(o), static_cast<float*>(lse), H, N, D / 64, ob,
                             on, oh, qscale);
}

cudaError_t launch_fwd_cluster(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int H, int N, int D, long long sb, long long sn,
                               long long sh, long long ob, long long on, long long oh,
                               float qscale, cudaStream_t st) {
  const int P = D / 64;
  if (P < 9 || P > 32) return cudaErrorInvalidValue;
  switch (cluster_ctas(P)) {
    case 3:
      return launch_fwd_cluster_c<3>(q, k, v, o, lse, B, H, N, D, sb, sn, sh, ob, on, oh, qscale,
                                     st);
    case 4:
      return launch_fwd_cluster_c<4>(q, k, v, o, lse, B, H, N, D, sb, sn, sh, ob, on, oh, qscale,
                                     st);
    default:
      return launch_fwd_cluster_c<8>(q, k, v, o, lse, B, H, N, D, sb, sn, sh, ob, on, oh, qscale,
                                     st);
  }
}

template <int D, int NC>
cudaError_t launch_fwd_wgmma_nc(const CUtensorMap& mq, const CUtensorMap& mk,
                                const CUtensorMap& mv, void* o, void* lse, int B, int H, int N,
                                long long ob, long long on, long long oh, float qscale,
                                cudaStream_t st) {
  constexpr size_t smem = FwdSmem<D, NC>::bytes;
  const cudaError_t err = vst::allow_smem(dense_attn_fwd_wgmma_kernel<D, NC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 64 * NC - 1) / (64 * NC), H, B);
  dense_attn_fwd_wgmma_kernel<D, NC><<<grid, 128 * (NC + 1), smem, st>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), H, N, ob, on, oh, qscale);
  return cudaGetLastError();
}

// bf16 at D = 64 to 256: the wgmma kernel over tensor maps of q, k, v,
// with two consumer warpgroups a block unless that gives fewer blocks
// than the card has SMs.
template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int N, long long sb, long long sn, long long sh,
                             long long ob, long long on, long long oh, float qscale,
                             cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!vst::bhnd_tensor_map(&mq, q, B, N, H, D, sb, sn, sh) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, D, sb, sn, sh) ||
      !vst::bhnd_tensor_map(&mv, v, B, N, H, D, sb, sn, sh))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * ((N + 127) / 128) < sms)
    return launch_fwd_wgmma_nc<D, 1>(mq, mk, mv, o, lse, B, H, N, ob, on, oh, qscale, st);
  return launch_fwd_wgmma_nc<D, 2>(mq, mk, mv, o, lse, B, H, N, ob, on, oh, qscale, st);
}

}  // namespace

// q, k, v: [B, N, H, D] with element strides (sb, sn, sh, 1), 16-byte
// aligned rows; o: [B, N, H, D] with strides (ob, on, oh, 1); lse:
// [B, H, N] f32, contiguous; scratch (bf16 with D > 2048:
// attn_scores_fwd_scratch(B, H, N, D) bytes, dense_attn_scores.cuh; f32
// at D = 64 and 128: attn_tf32_narrow_fwd_scratch(B, H, N, D) bytes,
// dense_attn_tf32.cuh; f32 with D >= 192: attn_tf32_fwd_scratch(B, H, N,
// D) bytes, dense_attn_tf32_wide.cuh; else unused and may be null),
// 16-byte aligned. N % 64 == 0, D % 64 == 0
// (cudaErrorInvalidValue otherwise). The caller checks all of it.
// Returns cudaGetLastError() after the launches.
extern "C" int vst_dense_attn_fwd(int is_bf16, const void* q, const void* k,
                                  const void* v, void* o, void* lse, void* scratch, int B,
                                  int H, int N, int D, long long sb, long long sn,
                                  long long sh, long long ob, long long on,
                                  long long oh, float qscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define VST_FWD_ARGS q, k, v, o, lse, B, H, N, sb, sn, sh, ob, on, oh, qscale, st
#define VST_FWD_ARGS_WIDE q, k, v, o, lse, B, H, N, D, sb, sn, sh, ob, on, oh, qscale, st
#define VST_FWD_TF32                                                                            \
  vst::launch_attn_fwd_tf32(static_cast<const float*>(q), static_cast<const float*>(k),         \
                            static_cast<const float*>(v), static_cast<float*>(o),               \
                            static_cast<float*>(lse), scratch, B, H, N, D, sb, sn, sh, ob, on, \
                            oh, qscale, st)
  switch (D) {
    case 64:
      err = is_bf16 ? launch_fwd_wgmma<64>(VST_FWD_ARGS) : VST_FWD_TF32;
      break;
    case 128:
      err = is_bf16 ? launch_fwd_wgmma<128>(VST_FWD_ARGS) : VST_FWD_TF32;
      break;
    default:
      if (D % 64 != 0 || D < 192) {
        err = cudaErrorInvalidValue;
      } else if (!is_bf16) {
        err = vst::launch_attn_fwd_tf32_wide(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
            scratch, B, H, N, D, sb, sn, sh, ob, on, oh, qscale, st);
      } else if (D == 192) {
        err = launch_fwd_wgmma<192>(VST_FWD_ARGS);
      } else if (D == 256) {
        err = launch_fwd_wgmma<256>(VST_FWD_ARGS);
      } else if (D <= 512) {
        err = launch_fwd_wider(VST_FWD_ARGS_WIDE);
      } else if (D <= 2048) {
        err = launch_fwd_cluster(VST_FWD_ARGS_WIDE);
      } else {
        err = vst::launch_attn_fwd_scores(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
            scratch, B, H, N, D, sb, sn, sh, ob, on, oh, qscale, st);
      }
  }
#undef VST_FWD_ARGS
#undef VST_FWD_ARGS_WIDE
#undef VST_FWD_TF32
  return static_cast<int>(err);
}

// How many clusters of the bf16 cluster kernels for a head of D (576 to
// 2048) the card holds at once, by cudaOccupancyMaxActiveClusters: the
// forward's into fit[0], the backward's dK/dV kernel's (dense_attn_bwd.cu)
// into fit[1]. The cluster size is cluster_ctas(D / 64).
int vst_attn_bwd_cluster_fit(int D, int* fit);

template <int C>
cudaError_t fwd_cluster_fit(int* fit) {
  const ClusterFwdSmem L(C);
  const cudaError_t err = vst::allow_smem(dense_attn_fwd_cluster_kernel<C>, L.bytes);
  return err != cudaSuccess ? err
                            : vst::cluster_fit(dense_attn_fwd_cluster_kernel<C>, C, 384, L.bytes,
                                               fit);
}

extern "C" int vst_dense_attn_cluster_fit(int D, void* fit, void* /*stream*/) {
  const int P = D / 64;
  int* out = static_cast<int*>(fit);
  if (D % 64 != 0 || P < 9 || P > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int C = cluster_ctas(P);
  const cudaError_t err = C == 3   ? fwd_cluster_fit<3>(&out[0])
                          : C == 4 ? fwd_cluster_fit<4>(&out[0])
                                   : fwd_cluster_fit<8>(&out[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  return vst_attn_bwd_cluster_fit(D, &out[1]);
}

extern "C" const char* vst_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
