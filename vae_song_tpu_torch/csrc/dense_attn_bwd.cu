// Dense attention backward for Hopper (sm_90a), [B, N, H, D] layout read
// through strides, any head width D % 64 == 0 (f32: the split-TF32 wgmma
// kernels of dense_attn_tf32.cu at D = 64 and 128 and of
// dense_attn_tf32_wide.cu from 192 up; bf16 above 2048: the kernels of
// dense_attn_scores.cu; all launched from here).
//
// Replaces: vae_song_tpu/ops/denseattn.py:_bwd_kernel_packed (K2, called
// through _call_bwd_packed) and vae_song_tpu/ops/denseattn.py:_bwd_kernel
// (K3b, called through _call_bwd), which round at the same points; one
// kernel serves both routes. Same function and roundings, with cd the
// compute dtype (bf16 for bf16 inputs, f32 for f32 inputs):
//   qc    = round_to_input_dtype(q * scale * log2e)
//   P     = exp2(round_cd(qc k^T - LSE2)), rounded to cd
//   dV    = P^T dO                       (f32 accumulation)
//   dP    = round_cd(dO V^T)
//   delta = round_cd(rowsum(dO * O))     (f32 sum)
//   dS    = round_cd(P * round_cd(dP - delta))
//   dQ    = (dS K) * scale,  dK = (dS^T qc) * ln2
// dQ, dK, dV are accumulated in f32 and cast to the input dtype.
//
// What bounds it here: at B = 64, N = 2048, H = 4, D = 64 one call is
// 10 B H N^2 D = 1.4e12 flop against ~0.5 GB of operand traffic, so the
// tensor cores bound it. The TPU kernel walks query-row blocks in grid
// order and adds dK/dV across them in VMEM scratch, which is safe only
// because a TPU grid runs in sequence (denseattn.py:490-507). Hopper
// blocks run at once, in no order. So the backward is split FA2-style
// into three kernels on one stream, with no atomics and a result that is
// the same on every run:
//   1. preprocess: a warp per (b, n, h) row writes delta and, on the bf16
//      path, qc into a bf16 scratch that the wrapper allocates (O's
//      layout), so the prescale leaves the inner loops and the qc that S
//      and dK read is one tensor, as in the JAX kernel;
//   2. dK/dV: one block per (b, h, 128-key tile), looping over all query
//      tiles and holding its dK/dV rows in registers;
//   3. dQ: one block per (b, h, 128-query tile), looping over all key
//      tiles.
// S and dP are computed in both kernels 2 and 3: 14 B H N^2 D of
// tensor-core work against the bound's 10, the price of no atomics.
//
// bf16 at D = 64 and 128 (every configured path): warp-specialised wgmma
// kernels (sm90.cuh). 384 threads: two consumer warpgroups of 64 rows
// each and a producer warpgroup whose one thread issues TMA loads; the
// producer gives its registers to the consumers (setmaxnreg 24 / 240).
// The block's own 128 rows (K and V, or qc and dO) stay resident in
// shared memory; the other side's 64-row tiles (qc, dO and their rows'
// LSE2 and delta, or K and V) stream through a ring of TMA loads (4
// stages at D = 64, 3 at D = 128) with full/empty mbarriers, so loads
// overlap compute. Every tile is 128-byte-swizzled panels of 64 columns.
// In the dK/dV kernel S^T = K qc^T and dP^T = V dO^T are wgmma with both
// operands in shared memory (K-major); P^T and dS^T are computed in
// registers in the accumulator layout, which is also wgmma's register A
// layout, so dV += P^T dO and dK += dS^T qc take A from registers and
// B = dO or qc from shared memory, transposed through the descriptor
// (MN-major): no transposed copy is made. The dQ kernel is the mirror
// image, with dQ += dS K reading K MN-major. Each warpgroup holds its
// accumulators for the full head width (dK and dV: 2 x D / 2 registers a
// thread), so S and dP are computed once per tile pair at every D.
// The elementwise passes round to bf16 two values per conversion and
// form dS with exact bf16x2 arithmetic (p_pair, ds_pair): one rounding
// at a time, at the conversion pipe's eighth of the FMA rate, took more
// time than the tensor cores. Tensor maps are built on the host per call
// over the strided views (4-D: D, H, N, B); rows past N read as zeros,
// so an N that is an odd multiple of 64 runs its last block with one
// warpgroup on zero rows whose results are not stored.
//
// bf16 at D = 192 and 256 (`num_heads: 1` at d_model 256): the same
// warp specialisation, TMA ring and register-A products, with the scores
// split between the consumer warpgroups. A thread cannot hold dK and dV
// of 64 rows at full width (2 x D / 2 = 256 registers at D = 256), nor
// does shared memory take 128 resident rows of qc and dO beside a ring
// (128 KB at D = 256). So a block owns 64 rows (keys, or queries), held
// in shared memory, and both warpgroups work on all 64: warpgroup 0
// computes S (S^T in the dK/dV kernel) and P, warpgroup 1 dP (dP^T) and
// rounds it to bf16; each writes its 64 x 64 tile of bf16 pairs (16 words
// a thread, in the A-fragment layout, which is the same in both
// warpgroups) to an exchange buffer in shared memory, they meet at a
// named barrier and each reads the other's, so both hold P and round(dP)
// and form the same dS. The head's columns of the outputs are split:
// warpgroup 0 accumulates dK and dV (or dQ) on panels [0, ceil(P / 2)),
// warpgroup 1 on the rest (at D = 256 2 x 2 x 32 registers a thread for
// dK and dV). Each product is computed once per tile pair: 14 B H N^2 D
// of tensor-core work, as at D = 64 and 128, against the 18 of both
// warpgroups computing S and dP over the whole head. Two exchange buffers
// alternate, so one barrier a tile orders both the writes and the reads.
// The ring holds 2 stages at D = 256, 3 at D = 192 (226-227 KB of shared
// memory a block with the exchange's 32 KB). N is a multiple of 64, so
// every tile is whole. The preprocess and its qc scratch are the D = 64
// and 128 path's.
//
// bf16 at D = 320 to 512 (`num_heads: 1` at d_model 320 to 512): the same
// split of the scores between the warpgroups, with the head in column
// groups. A block owns 64 rows; its resident tiles (K and V, or qc and
// dO) take 16 P KB of shared memory, P = D / 64 panels (128 KB at 512), so
// the other side streams through rings of 64 x 64 panel stages, one ring
// a consumer warpgroup, filled by one producer thread each (as many as
// fit: dK/dV 4 stages at D = 512 to 7 at 320, 211 KB a block; dQ 5 to 8,
// 225 KB). A score chain (S^T or dP^T over the head, panel by
// panel) gives each stage back once the product after it has completed,
// so it holds two stages at any D. dK/dV: ceil(P / 4) column groups of at
// most four panels, each block one group, each group recomputing S^T
// (warpgroup 0, with P^T) and dP^T (warpgroup 1, rounded) over the whole
// head; the two swap their bf16 tiles through two 8 KB slots at named
// barriers, form the same dS^T and accumulate dK and dV on at most two
// panels each (128 registers); per query tile the ring brings the P
// score panels (qc, or dO), then dO and qc on the warpgroup's panels,
// and a two-stage side ring the tile's LSE2 and delta rows. Its producer
// keeps 40 registers (two rings a thread), its consumers 232. dQ: the
// whole head's dQ split between the warpgroups (at most four panels,
// 128 registers), the ring bringing the P score panels (K, or V), then K
// on the warpgroup's panels. Executed at D = 320 to 512 (two groups): 12
// B H N^2 D in dK/dV and 6 in dQ, 18 against the bound's 10; no atomics.
//
// bf16 at D = 576 to 2048 (`num_heads: 1` at d_model 576 to 2048): the
// resident tiles of 16 P KB no longer fit beside the rings, and a thread
// cannot hold dK and dV on more than 2 panels each. So the dK/dV kernel
// runs on a thread-block cluster of C CTAs (3, 4 or 8: the forward's
// split, 2 to 4 panels a CTA) that share 64 keys: CTA r holds K and V on
// its panels, and its warpgroups run dkdv_wider_consumer there (S^T and
// P^T in one, dP^T in the other), each partial score tile summed over the
// cluster in f32 in rank order (vst::ClusterSum, through distributed
// shared memory) between its chain and the swap, so every CTA forms the
// same P^T and dS^T and accumulates dK and dV on its own panels. The
// dK/dV kernel also hands dS^T to the dQ kernel through a bf16 scratch
// [B H, N, N] (each CTA of a cluster storing every C-th query tile), and
// the dQ kernel is then a product, dQ = scale dS K, 128 queries and 3 or
// 4 panels a block, with no cluster and no recomputed S or dP: 10 B H N^2
// D in all, against the 14 of a dQ kernel that recomputes S and dP over
// its own cluster (scripts/ab_attn_dq_cluster.cu, the A/B arm of
// scripts/ab_attn_bf16.py --cluster --dq-cluster), whose two more cluster
// sums a tile cost more than the scratch's write and read. The scratch
// takes 2 B H N^2 bytes (512 MiB at B = 64, H = 1, N = 2048).
//
// bf16 above 2048: the preprocess, then dense_attn_scores.cu's kernels,
// which write the scores out (the dense gate caps N at 2048, so there one
// head's [N, N] scores are smaller than its q [N, D], and the resident
// tiles above no longer fit): one kernel computes S^T and dP^T for the
// same 128 x 128 tile and writes P^T and dS^T to two bf16 scratches [B H,
// N, N], two product kernels compute dV = P^T dO and dK = ln2 dS^T qc,
// and the cluster route's dQ kernel dQ = scale dS K from dS^T: 10 B H N^2
// D, each product made once.
//
// f32 inputs (mixed_precision: false), the f32 path of the same TPU
// kernels: the preprocess (delta only) at any width, then split TF32 on
// wgmma fed by TMA, launched from the dispatch below: at D = 64 and 128
// dense_attn_tf32.cu's dK/dV kernel, which keeps S^T, P^T and dP^T on chip
// and writes dS^T to an f32 scratch, and a dQ product over it (10 B H N^2
// D; scripts/ab_attn_f32.py --dq-recompute A/Bs a dQ kernel that
// recomputes S and dP instead); from D = 192 dense_attn_tf32_wide.cu's
// products over written-out P^T and dS^T. Tested on the CPU by
// tests/test_torch_denseattn_f32split.py's emulation and on the card by
// chip_smoke.py phase 3 and scripts/ab_attn_f32.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "dense_attn_scores.cuh"
#include "dense_attn_tf32.cuh"
#include "dense_attn_tf32_wide.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vst::pack_bf16;
using vst::p_pair;
using vst::round_bf16;

constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, n, h;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

// ---- preprocess: delta and qc ---------------------------------------------

constexpr int kPreRows = 8;   // rows (warps) a block

// One warp per (b, n, h) row; lane l holds columns l D/32 .. (l+1) D/32 - 1,
// so a warp reads its row's contiguous bytes at once. delta =
// round_cd(rowsum(dO * O)) into [B, H, N] f32; for bf16 also
// qc = round_bf16(q * qscale) into a scratch with O's strides.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kPreRows)
attn_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                           const T* __restrict__ q, T* __restrict__ qc,
                           float* __restrict__ delta, int H, int N, long long rows,
                           Strides s, Strides os, float qscale) {
  constexpr int E = D / 32;
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
  if (lane == 0) delta[(b * H + h) * N + n] = sizeof(T) == 2 ? round_bf16(acc) : acc;
  if constexpr (sizeof(T) == 2) {
    const long long qoff = b * s.b + n * s.n + h * s.h + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e)
      qc[off + e] = __float2bfloat16_rn(__bfloat162float(q[qoff + e]) * qscale);
  }
}

// The same preprocess at a runtime D % 64 == 0 (the head widths above
// 256): lane l takes columns l, l + 32, ...
template <typename T>
__global__ void __launch_bounds__(32 * kPreRows)
attn_bwd_preprocess_wide_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                                const T* __restrict__ q, T* __restrict__ qc,
                                float* __restrict__ delta, int H, int N, int D, long long rows,
                                Strides s, Strides os, float qscale) {
  const long long r = (long long)blockIdx.x * kPreRows + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int h = r % H;
  const int n = (r / H) % N;
  const long long b = r / ((long long)H * N);
  const long long off = b * os.b + n * os.n + h * os.h;
  float acc = 0.f;
  for (int e = lane; e < D; e += 32) acc = fmaf(to_f(d_o[off + e]), to_f(o[off + e]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[(b * H + h) * N + n] = sizeof(T) == 2 ? round_bf16(acc) : acc;
  if constexpr (sizeof(T) == 2) {
    const long long qoff = b * s.b + n * s.n + h * s.h;
    for (int e = lane; e < D; e += 32)
      qc[off + e] = __float2bfloat16_rn(__bfloat162float(q[qoff + e]) * qscale);
  }
}

// ---- bf16, D = 64 and 128: warp-specialised wgmma kernels -----------------

constexpr int kWgmmaThreads = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int kBlockRows = 128;      // rows a block owns, 64 per consumer
constexpr int kStepRows = 64;        // rows of a streamed tile
constexpr int kConsumerWarps = 8;
constexpr uint32_t kPanel64 = 64 * vst::kPanelRowBytes;    // 64-row panel
constexpr uint32_t kPanel128 = 128 * vst::kPanelRowBytes;  // 128-row panel

// Compile-time arms of the two kernels, for the A/B harness
// scripts/ab_attn_arms.py: the ports of the TPU ablations of K2
// (scripts/ab_attn_ablate.py, ab_attn_ablate8.py, ab_attn_bwd.py).
// scripts/ab_attn_arms.cu instantiates them (D = 64); the package launches
// kBwdFull only, for which every hook below compiles away.
//   Exact arms fold a row constant into a score product: the constant
//   comes as bf16 columns of a [B H N, 16] scratch (scripts/ab_attn_arms.cu's
//   preprocess writes them, zeros past the columns used), and one more
//   16-deep k-step of S (S^T) or dP (dP^T) multiplies them by a constant
//   64 x 16 panel of ones in shared memory, so the subtraction lands in the
//   f32 accumulator (depth 64 -> 80):
//     kBwdDfuse     -bf16(delta): dS = bf16(P bf16(dP - bf16(delta)));
//     kBwdLfuse     -hi, -lo of LSE2 (hi = bf16(LSE2), lo = bf16(LSE2 - hi)):
//                   P = bf16(exp2(bf16(S - LSE2)));
//     kBwdBfuse     both;
//     kBwdFusedE16  both, delta unrounded as -hi, -lo too;
//     kBwdFusedE32  as kBwdFusedE16, with P = bf16(exp2(S - LSE2)) in f32.
//   Strips, timing only (the outputs a strip keeps are the package's bits):
//     kBwdNoExp     P = bf16(S - LSE2), no exp2;
//     kBwdNoDp      no dP product, dS = P (keeps dV);
//     kBwdNoDsMul   dS = bf16(dP), no subtraction or product (keeps dV);
//     kBwdNoDq      no dQ product (keeps dK, dV);
//     kBwdNoDk      no dK product (keeps dV, dQ).
//   kBwdRows64: the package's arithmetic in blocks of 64 resident rows (kRows
//   64: one consumer warpgroup, 256 threads) in place of 128, twice the
//   blocks, each streaming the other side whole (the package's bits).
enum BwdArm : int {
  kBwdFull = 0,
  kBwdDfuse, kBwdLfuse, kBwdBfuse, kBwdFusedE16, kBwdFusedE32,
  kBwdNoExp, kBwdNoDp, kBwdNoDsMul, kBwdNoDq, kBwdNoDk,
  kBwdRows64,
  kBwdArms
};
__host__ __device__ constexpr bool folds_lse(int arm) {
  return arm >= kBwdLfuse && arm <= kBwdFusedE32;
}
__host__ __device__ constexpr bool folds_delta(int arm) {
  return arm == kBwdDfuse || (arm >= kBwdBfuse && arm <= kBwdFusedE32);
}
__host__ __device__ constexpr bool folds(int arm) { return folds_lse(arm) || folds_delta(arm); }
// The folded columns' tiles: 64 rows of 16 bf16 columns, 32-byte swizzled.
constexpr uint32_t kAugRowBytes = 32;
constexpr uint32_t kAugTile = 64 * kAugRowBytes;

// Shared memory of the two wgmma kernels, byte offsets from a 1024-byte
// aligned base: the resident 128-row tiles (P panels each), the ring's
// stages (two 64-row tiles of P panels; in the dK/dV kernel then 64 LSE2
// and 64 delta values), and the mbarriers (resident, full[], empty[]).
// The ring holds 4 stages at D = 64, 3 at D = 128 (161 KB for dK/dV).
// A fold arm adds the panel of ones after the resident tiles, and the
// tiles of its folded columns (`aug` bytes for 64 rows of each): in the dQ
// kernel the resident rows of each after the ones, in the dK/dV kernel
// the streamed 64 rows in every stage, after its row vectors. kRows: the
// resident rows (kBwdRows64: 64).
template <int D, bool kRowVectors, int kArm = kBwdFull, int kRows = kBlockRows>
struct WgmmaSmem {
  static constexpr int P = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr uint32_t res_panel = kRows * vst::kPanelRowBytes;
  static constexpr uint32_t aug = (folds_lse(kArm) + folds_delta(kArm)) * kAugTile;
  static constexpr uint32_t res_a = 0;
  static constexpr uint32_t res_b = P * res_panel;
  static constexpr uint32_t ones = 2 * P * res_panel;
  static constexpr uint32_t res_aug = ones + (folds(kArm) ? kAugTile : 0);
  static constexpr uint32_t stage0 = res_aug + (kRowVectors ? 0 : kRows / 64 * aug);
  static constexpr uint32_t vec = 2 * P * kPanel64;                // in a stage
  static constexpr uint32_t stage_aug = vec + (kRowVectors ? 1024 : 0);
  static constexpr uint32_t stage_bytes = stage_aug + (kRowVectors ? aug : 0);
  static constexpr uint32_t bars = stage0 + kStages * stage_bytes;
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;   // + alignment
  static constexpr uint32_t tile_tx = 2 * P * kPanel64 + (kRowVectors ? 512 + aug : 0);
};

using vst::zero_acc;

// The elementwise passes work on pairs of neighbouring columns, packed as
// bf16x2 in the layout of a wgmma A fragment: P by vst::p_pair (shared
// with the forward), dS by vst::ds_pair (shared with the kernels of
// dense_attn_scores.cu).
using vst::ds_packed;
using vst::ds_pair;

// The resident tile's barrier (one arrival: the producer's) and the
// ring's full (one arrival) and empty (one per consumer warp) barriers.
__device__ __forceinline__ void init_barriers(uint32_t res_bar, uint32_t full0, uint32_t empty0,
                                              int stages, int consumer_warps = kConsumerWarps) {
  if (threadIdx.x == 0) {
    vst::mbar_init(res_bar, 1);
    for (int s = 0; s < stages; ++s) {
      vst::mbar_init(full0 + 8 * s, 1);
      vst::mbar_init(empty0 + 8 * s, consumer_warps);
    }
    vst::mbar_fence_init();
  }
  __syncthreads();
}

// The fold arms' panel of ones (64 x 16 bf16, every entry 1, so its
// swizzle does not matter), written by the consumer threads and fenced for
// the async proxy before the block's first barrier.
__device__ __forceinline__ void write_ones(unsigned char* at) {
  if (threadIdx.x < 256) {
    uint32_t* w = reinterpret_cast<uint32_t*>(at);
    w[threadIdx.x] = w[threadIdx.x + 256] = 0x3F803F80u;
    vst::fence_proxy_async();
  }
}

// acc (64 x 64) = A (64 rows of the resident panels at a, kResPanel bytes
// apart) B^T (64 rows of the stage's panels at b), contracting over D:
// K-major both.
template <int P, uint32_t kResPanel = kPanel128>
__device__ __forceinline__ void wgmma_rows(float (&acc)[8][4], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * P; ++kk)
    vst::wgmma_ss_n64_t<0, 0>(acc, vst::desc_kmajor(a + (kk / 4) * kResPanel, kk % 4),
                      vst::desc_kmajor(b + (kk / 4) * kPanel64, kk % 4), kk > 0);
}

// out[p] (64 x 64 column block p of 64 x D) += A (64 x 64 bf16 in
// registers, four 16-deep fragments) B (the stage's 64 x D tile at b,
// contracting over its rows: MN-major).
template <int P>
__device__ __forceinline__ void wgmma_frags_tile(float (&out)[P][8][4], const uint32_t (&a)[4][4],
                                                 uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int p = 0; p < P; ++p)
      vst::wgmma_rs_n64_t<1>(out[p], a[kc], vst::desc_mnmajor(b + p * kPanel64, kc, kPanel64));
}

template <int P>
__device__ __forceinline__ void fence_all(float (&c)[P][8][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) vst::fence_acc(c[p]);
}

// Issue S = A B^T and dP = A' B'^T (A, A' resident at a, a2; B, B' the
// stage's two tiles at b, b2) into sc and dp, one commit group each. A
// fold arm adds to S the k-step over the 16-column tiles at fa, fb (LSE2's
// columns and the ones, in the order of A and B), to dP the one at fa2,
// fb2 (delta's); kBwdNoDp issues no dP.
template <int P, int kArm = kBwdFull, uint32_t kResPanel = kPanel128>
__device__ __forceinline__ void issue_scores(float (&sc)[8][4], float (&dp)[8][4], uint32_t a,
                                             uint32_t a2, uint32_t b, uint32_t b2,
                                             uint32_t fa = 0, uint32_t fb = 0, uint32_t fa2 = 0,
                                             uint32_t fb2 = 0) {
  zero_acc(sc);
  zero_acc(dp);
  vst::fence_acc(sc);
  vst::fence_acc(dp);
  vst::wgmma_fence();
  wgmma_rows<P, kResPanel>(sc, a, b);
  if constexpr (folds_lse(kArm))
    vst::wgmma_ss_n64_t<0, 0>(sc, vst::desc_kmajor_sw32(fa), vst::desc_kmajor_sw32(fb), 1);
  vst::wgmma_commit();
  if constexpr (kArm != kBwdNoDp) {
    wgmma_rows<P, kResPanel>(dp, a2, b2);
    if constexpr (folds_delta(kArm))
      vst::wgmma_ss_n64_t<0, 0>(dp, vst::desc_kmajor_sw32(fa2), vst::desc_kmajor_sw32(fb2), 1);
    vst::wgmma_commit();
  }
}

// P of two neighbouring score columns x0, x1 whose row constants (LSE2)
// are c0, c1, by arm: exp2 of the bf16-rounded difference (vst::p_pair);
// where LSE2 is folded, of x itself, in f32 for kBwdFusedE32; no exp2 for
// kBwdNoExp.
template <int kArm>
__device__ __forceinline__ uint32_t p_arm(float x0, float x1, float c0, float c1) {
  if constexpr (kArm == kBwdFusedE32)
    return pack_bf16(vst::ex2_ftz(x0), vst::ex2_ftz(x1));
  else if constexpr (folds_lse(kArm))
    return p_pair(x0, x1);
  else if constexpr (kArm == kBwdNoExp)
    return pack_bf16(x0 - c0, x1 - c1);
  else
    return p_pair(x0 - c0, x1 - c1);
}

// dS of two neighbouring columns from P (bf16 pair p), dP (d0, d1) and
// the bf16 pair of delta dd, by arm: vst::ds_pair; where delta is folded,
// bf16(P bf16(dP)) (one bf16x2 product); P for kBwdNoDp; bf16(dP) for
// kBwdNoDsMul.
template <int kArm>
__device__ __forceinline__ uint32_t ds_arm(uint32_t p, float d0, float d1, uint32_t dd) {
  if constexpr (folds_delta(kArm)) {
    const uint32_t dpr = pack_bf16(d0, d1);
    const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                                     *reinterpret_cast<const __nv_bfloat162*>(&dpr));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else if constexpr (kArm == kBwdNoDp) {
    return p;
  } else if constexpr (kArm == kBwdNoDsMul) {
    return pack_bf16(d0, d1);
  } else {
    return ds_pair(p, d0, d1, dd);
  }
}

// A strip that drops the product reading dS keeps dS computed: its words
// are folded by xor into `keep`, which the kernel stores (into its
// timing-only output) only if it equals an arbitrary constant.
__device__ __forceinline__ void keep_frags(uint32_t& keep, const uint32_t (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) keep ^= x[i][j];
}
constexpr uint32_t kKeepMagic = 0x2545F491u;

using vst::release_stage;

// Stores rows r and r + 8 (r = the thread's first accumulator row) of a
// 64 x D f32 block, times `mul`, as bf16 at out + row * os.n; rows >= N
// are skipped.
template <int P>
__device__ __forceinline__ void store_rows(const float (&c)[P][8][4], bf16* out, long long head,
                                           int r, int N, long long sn, int t, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= N) continue;
    bf16* dst = out + head + (long long)row * sn;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 64 * p + 8 * j + 2 * t) =
            pack_bf16(c[p][j][2 * half] * mul, c[p][j][2 * half + 1] * mul);
  }
}

// Producer of the wgmma kernels (one thread): the block's resident
// kResRows-row tiles of ra and rb, then for each of the n streamed 64-row
// tiles, once the consumers have released its stage, the tiles of sa and
// sb (and, where lse is given, the tile rows' LSE2 and delta, at vec0 +
// s vec_stride for stage s). Its last kStages waits let the consumers
// release every stage before it leaves. A fold arm's folded columns come
// through the 2-D maps al (LSE2's) and ad (delta's), rows vrow + the
// block's or tile's rows: kAugResident, the block's kResRows rows of each
// with its resident tiles, at aug0; else each streamed tile's 64 rows of
// each with its stage, at aug0 + s kStageBytes.
template <int P, int kResRows, int kStages, uint32_t kStageBytes, uint32_t kTileTx,
          int kArm = kBwdFull, bool kAugResident = false>
__device__ __forceinline__ void produce(const CUtensorMap* ra, const CUtensorMap* rb,
                                        const CUtensorMap* sa, const CUtensorMap* sb,
                                        const float* lse, const float* delta, uint32_t res,
                                        uint32_t stage0, uint32_t vec0, uint32_t vec_stride,
                                        uint32_t res_bar, uint32_t full0, uint32_t empty0,
                                        int r0, int n, int h, int b,
                                        const CUtensorMap* al = nullptr,
                                        const CUtensorMap* ad = nullptr, uint32_t aug0 = 0,
                                        int vrow = 0) {
  constexpr uint32_t res_panel = kResRows * vst::kPanelRowBytes;
  constexpr int kAugL = folds_lse(kArm), kAugD = folds_delta(kArm);
  constexpr uint32_t res_aug_tx = kAugResident ? (kAugL + kAugD) * kResRows * kAugRowBytes : 0;
  vst::mbar_arrive_expect_tx(res_bar, 2 * P * res_panel + res_aug_tx);
  for (int p = 0; p < P; ++p)
    for (int half = 0; half < kResRows / 64; ++half) {
      const uint32_t at = p * res_panel + half * kPanel64;
      vst::tma_load_4d(res + at, ra, res_bar, 64 * p, h, r0 + 64 * half, b);
      vst::tma_load_4d(res + P * res_panel + at, rb, res_bar, 64 * p, h, r0 + 64 * half, b);
    }
  if constexpr (kAugResident && folds(kArm)) {
    for (int half = 0; half < kResRows / 64; ++half) {
      if constexpr (kAugL)
        vst::tma_load_2d(aug0 + half * kAugTile, al, res_bar, 0, vrow + r0 + 64 * half);
      if constexpr (kAugD)
        vst::tma_load_2d(aug0 + (kAugL * kResRows / 64 + half) * kAugTile, ad, res_bar, 0,
                         vrow + r0 + 64 * half);
    }
  }
  for (int it = 0; it < n + kStages; ++it) {
    const int s = it % kStages;
    vst::mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
    if (it >= n) continue;
    const uint32_t st = stage0 + s * kStageBytes, full = full0 + 8 * s;
    vst::mbar_arrive_expect_tx(full, kTileTx);
    for (int p = 0; p < P; ++p) {
      vst::tma_load_4d(st + p * kPanel64, sa, full, 64 * p, h, it * kStepRows, b);
      vst::tma_load_4d(st + (P + p) * kPanel64, sb, full, 64 * p, h, it * kStepRows, b);
    }
    if (lse != nullptr) {
      const uint32_t vec = vec0 + s * vec_stride;
      vst::bulk_load(vec, lse + it * kStepRows, 256, full);
      vst::bulk_load(vec + 256, delta + it * kStepRows, 256, full);
    }
    if constexpr (!kAugResident && folds(kArm)) {
      const uint32_t at = aug0 + s * kStageBytes;
      if constexpr (kAugL) vst::tma_load_2d(at, al, full, 0, vrow + it * kStepRows);
      if constexpr (kAugD)
        vst::tma_load_2d(at + kAugL * kAugTile, ad, full, 0, vrow + it * kStepRows);
    }
  }
}

// The dK/dV kernel's block (kArm: an arm above, kRows its resident rows;
// the package's kernel is kBwdFull with 128). Grid (ceil(N / kRows), H, B),
// 384 threads (256 at kRows 64). Warpgroup w < kRows / 64 owns keys k0 + 64
// w .. + 63; its warp i the 16 rows 16 i .. of those. Per query tile: S^T
// and dP^T go out together; P^T is computed while dP^T runs, dS^T while dV
// runs. aug_l, aug_d: a fold arm's maps of the folded columns (else
// unused).
template <int D, int kArm, int kRows = kBlockRows>
__device__ __forceinline__ void dkdv_wgmma_block(const CUtensorMap* mk, const CUtensorMap* mv,
                                                 const CUtensorMap* mqc, const CUtensorMap* mdo,
                                                 const CUtensorMap* aug_l,
                                                 const CUtensorMap* aug_d,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta,
                                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                                 int H, int N, Strides os) {
  using L = WgmmaSmem<D, true, kArm, kRows>;
  constexpr int P = L::P, kStages = L::kStages, kWgs = kRows / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kStages;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int nq = N / kStepRows;
  const long long vrow = ((long long)b * H + h) * N;
  if constexpr (folds(kArm)) write_ones(smem_raw + (base - raw) + L::ones);
  init_barriers(res_bar, full0, empty0, kStages, 4 * kWgs);
  const int wg = threadIdx.x / 128;

  if (wg == kWgs) {   // producer
    if constexpr (kWgs == 2) vst::regs_dealloc<24>();
    if (threadIdx.x == 128 * kWgs)
      produce<P, kRows, kStages, L::stage_bytes, L::tile_tx, kArm>(
          mk, mv, mqc, mdo, lse + vrow, delta + vrow, base + L::res_a, base + L::stage0,
          base + L::stage0 + L::vec, L::stage_bytes, res_bar, full0, empty0, k0, nq, h, b,
          aug_l, aug_d, base + L::stage0 + L::stage_aug, static_cast<int>(vrow));
    return;
  }

  // consumers
  if constexpr (kWgs == 2) vst::regs_alloc<240>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t kw = base + L::res_a + wg * kPanel64;   // this warpgroup's 64 keys
  const uint32_t vw = base + L::res_b + wg * kPanel64;
  float adk[P][8][4], adv[P][8][4];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    zero_acc(adk[p]);
    zero_acc(adv[p]);
  }
  uint32_t keep = 0;
  vst::mbar_wait(res_bar, 0);

  for (int it = 0; it < nq; ++it) {
    const int s = it % kStages;
    vst::mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t qs = base + L::stage0 + s * L::stage_bytes, dos = qs + P * kPanel64;
    const float* ls = reinterpret_cast<const float*>(gbase + (qs - base) + L::vec);
    const float* dls = ls + kStepRows;
    // a fold arm's columns of the tile's queries (LSE2's, then delta's)
    const uint32_t fl = qs + L::stage_aug, fd = fl + (folds_lse(kArm) ? kAugTile : 0);

    // S^T = K qc^T and dP^T = V dO^T (64 keys x 64 queries each)
    float sc[8][4], dp[8][4];
    issue_scores<P, kArm, L::res_panel>(sc, dp, kw, vw, qs, dos, base + L::ones, fl,
                                        base + L::ones, fd);
    vst::wgmma_wait<kArm == kBwdNoDp ? 0 : 1>();
    vst::fence_acc(sc);

    // P^T (columns are queries), straight into A fragments
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float l0 = ls[8 * j + 2 * t], l1 = ls[8 * j + 2 * t + 1];
      pa[j >> 1][(j & 1) * 2] = p_arm<kArm>(sc[j][0], sc[j][1], l0, l1);
      pa[j >> 1][(j & 1) * 2 + 1] = p_arm<kArm>(sc[j][2], sc[j][3], l0, l1);
    }

    // dV += P^T dO, while dP^T finishes
    fence_all<P>(adv);
    vst::wgmma_fence();
    wgmma_frags_tile<P>(adv, pa, dos);
    vst::wgmma_commit();
    vst::wgmma_wait<1>();
    vst::fence_acc(dp);

    // dS^T = P^T (dP^T - delta)
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t dd = vst::pack_bf16(dls[8 * j + 2 * t], dls[8 * j + 2 * t + 1]);
      sa[j >> 1][(j & 1) * 2] = ds_arm<kArm>(pa[j >> 1][(j & 1) * 2], dp[j][0], dp[j][1], dd);
      sa[j >> 1][(j & 1) * 2 + 1] =
          ds_arm<kArm>(pa[j >> 1][(j & 1) * 2 + 1], dp[j][2], dp[j][3], dd);
    }

    // dK += dS^T qc
    if constexpr (kArm != kBwdNoDk) {
      fence_all<P>(adk);
      vst::wgmma_fence();
      wgmma_frags_tile<P>(adk, sa, qs);
      vst::wgmma_commit();
    } else {
      keep_frags(keep, sa);
    }
    vst::wgmma_wait<0>();
    fence_all<P>(adk);
    fence_all<P>(adv);
    release_stage(empty0 + 8 * s, lane);
  }

  const long long head = (long long)b * os.b + (long long)h * os.h;
  const int r = k0 + 64 * wg + 16 * warp + g;
  store_rows<P>(adk, dk, head, r, N, os.n, t, kLn2);
  store_rows<P>(adv, dv, head, r, N, os.n, t, 1.f);
  if constexpr (kArm == kBwdNoDk) {
    if (keep == kKeepMagic) dk[head] = __float2bfloat16_rn(1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mqc,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N,
                           Strides os) {
  dkdv_wgmma_block<D, kBwdFull>(&mk, &mv, &mqc, &mdo, nullptr, nullptr, lse, delta, dk, dv, H,
                                N, os);
}

// The dQ kernel's block (kArm, kRows as for dkdv_wgmma_block). Grid
// (ceil(N / kRows), H, B), 384 threads (256 at kRows 64). Warpgroup w <
// kRows / 64 owns queries q0 + 64 w .. + 63; its warp i the 16 rows 16 i ..
// of those. Per key tile: S and dP go out together; P is computed while dP
// runs.
template <int D, int kArm, int kRows = kBlockRows>
__device__ __forceinline__ void dq_wgmma_block(const CUtensorMap* mqc, const CUtensorMap* mdo,
                                               const CUtensorMap* mk, const CUtensorMap* mv,
                                               const CUtensorMap* aug_l,
                                               const CUtensorMap* aug_d,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               bf16* __restrict__ dq, int H, int N, Strides os,
                                               float scale) {
  using L = WgmmaSmem<D, false, kArm, kRows>;
  constexpr int P = L::P, kStages = L::kStages, kWgs = kRows / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kStages;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int nk = N / kStepRows;
  if constexpr (folds(kArm)) write_ones(smem_raw + (base - raw) + L::ones);
  init_barriers(res_bar, full0, empty0, kStages, 4 * kWgs);
  const int wg = threadIdx.x / 128;

  if (wg == kWgs) {   // producer
    if constexpr (kWgs == 2) vst::regs_dealloc<24>();
    if (threadIdx.x == 128 * kWgs)
      produce<P, kRows, kStages, L::stage_bytes, L::tile_tx, kArm, true>(
          mqc, mdo, mk, mv, nullptr, nullptr, base + L::res_a, base + L::stage0, 0, 0,
          res_bar, full0, empty0, q0, nk, h, b, aug_l, aug_d, base + L::res_aug,
          (b * H + h) * N);
    return;
  }

  // consumers
  if constexpr (kWgs == 2) vst::regs_alloc<240>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t qw = base + L::res_a + wg * kPanel64;   // this warpgroup's 64 queries
  const uint32_t ow = base + L::res_b + wg * kPanel64;
  const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
  const long long vrow = ((long long)b * H + h) * N;
  // a fold arm's columns of those queries (LSE2's, then delta's)
  const uint32_t fl = base + L::res_aug + wg * kAugTile;
  const uint32_t fd = fl + (folds_lse(kArm) ? kWgs * kAugTile : 0);
  // rows past N (zeros in shared memory) get LSE2 = delta = 0: finite,
  // and never stored
  const float l0 = r0 < N ? lse[vrow + r0] : 0.f, l1 = r1 < N ? lse[vrow + r1] : 0.f;
  const float d0 = r0 < N ? delta[vrow + r0] : 0.f, d1 = r1 < N ? delta[vrow + r1] : 0.f;
  const uint32_t dd0 = vst::pack_bf16(d0, d0), dd1 = vst::pack_bf16(d1, d1);
  float acc[P][8][4];
#pragma unroll
  for (int p = 0; p < P; ++p) zero_acc(acc[p]);
  uint32_t keep = 0;
  vst::mbar_wait(res_bar, 0);

  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    vst::mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t ks = base + L::stage0 + s * L::stage_bytes;

    // S = qc K^T and dP = dO V^T (64 queries x 64 keys each)
    float sc[8][4], dp[8][4];
    issue_scores<P, kArm, L::res_panel>(sc, dp, qw, ow, ks, ks + P * kPanel64, fl,
                                        base + L::ones, fd, base + L::ones);
    vst::wgmma_wait<kArm == kBwdNoDp ? 0 : 1>();
    vst::fence_acc(sc);
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j >> 1][(j & 1) * 2] = p_arm<kArm>(sc[j][0], sc[j][1], l0, l0);
      pa[j >> 1][(j & 1) * 2 + 1] = p_arm<kArm>(sc[j][2], sc[j][3], l1, l1);
    }
    vst::wgmma_wait<0>();
    vst::fence_acc(dp);

    // dS = P (dP - delta), then dQ += dS K
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sa[j >> 1][(j & 1) * 2] = ds_arm<kArm>(pa[j >> 1][(j & 1) * 2], dp[j][0], dp[j][1], dd0);
      sa[j >> 1][(j & 1) * 2 + 1] =
          ds_arm<kArm>(pa[j >> 1][(j & 1) * 2 + 1], dp[j][2], dp[j][3], dd1);
    }
    if constexpr (kArm != kBwdNoDq) {
      fence_all<P>(acc);
      vst::wgmma_fence();
      wgmma_frags_tile<P>(acc, sa, ks);
      vst::wgmma_commit();
      vst::wgmma_wait<0>();
      fence_all<P>(acc);
    } else {
      keep_frags(keep, sa);
    }
    release_stage(empty0 + 8 * s, lane);
  }

  const long long head = (long long)b * os.b + (long long)h * os.h;
  store_rows<P>(acc, dq, head, r0, N, os.n, t, scale);
  if constexpr (kArm == kBwdNoDq) {
    if (keep == kKeepMagic) dq[head] = __float2bfloat16_rn(1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mqc,
                         const __grid_constant__ CUtensorMap mdo,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int N, Strides os, float scale) {
  dq_wgmma_block<D, kBwdFull>(&mqc, &mdo, &mk, &mv, nullptr, nullptr, lse, delta, dq, H, N, os,
                              scale);
}

// ---- bf16, D = 192 and 256: wgmma kernels with the scores split ----------

// Shared memory of the two split kernels, byte offsets from a 1024-byte
// aligned base: the resident 64-row tiles (P panels each), the ring's
// stages (two 64-row tiles of P panels), the exchange (two buffers of
// two 8 KB slots: slot 2 i + w is warpgroup w's in buffer i), the ring's
// LSE2 and delta rows (dK/dV kernel) and the mbarriers (resident, full[],
// empty[]).
template <int D, bool kRowVectors>
struct SplitSmem {
  static constexpr int P = D / 64;
  static constexpr int kStages = D == 192 ? 3 : 2;
  static constexpr uint32_t res_a = 0;
  static constexpr uint32_t res_b = P * kPanel64;
  static constexpr uint32_t stage0 = 2 * P * kPanel64;
  static constexpr uint32_t stage_bytes = 2 * P * kPanel64;
  static constexpr uint32_t xch = stage0 + kStages * stage_bytes;
  static constexpr int kSlotWords = 16 * 128;                      // 16 words a thread
  static constexpr uint32_t vec0 = xch + 4 * kSlotWords * 4;
  static constexpr uint32_t bars = vec0 + (kRowVectors ? kStages * 512 : 0);
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;   // + alignment
  static constexpr uint32_t tile_tx = 2 * P * kPanel64 + (kRowVectors ? 512 : 0);
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// A 64 x 64 tile of bf16 pairs in the A-fragment layout (16 words a
// thread) into and out of an exchange slot: word j of thread tid at
// j * 128 + tid, so a warp's accesses are 32 consecutive words.
__device__ __forceinline__ void put_frags(uint32_t* slot, const uint32_t (&x)[4][4], int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) slot[(4 * i + j) * 128 + tid] = x[i][j];
}
__device__ __forceinline__ void get_frags(const uint32_t* slot, uint32_t (&x)[4][4], int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = slot[(4 * i + j) * 128 + tid];
}

// dP (or dP^T) of the accumulator rounded to bf16 pairs in the A layout.
__device__ __forceinline__ void round_pairs(const float (&x)[8][4], uint32_t (&out)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    out[j >> 1][(j & 1) * 2] = vst::pack_bf16(x[j][0], x[j][1]);
    out[j >> 1][(j & 1) * 2 + 1] = vst::pack_bf16(x[j][2], x[j][3]);
  }
}

// Warpgroup W's output panels of the head: [0, ceil(P / 2)) for W = 0,
// the rest for W = 1.
template <int P, int W>
struct SplitPanels {
  static constexpr int first = W == 0 ? 0 : (P + 1) / 2;
  static constexpr int count = W == 0 ? (P + 1) / 2 : P - (P + 1) / 2;
};

// Consumer warpgroup W of the split dK/dV kernel, for the block's keys
// k0 .. k0 + 63 (resident K and V). Per query tile: W = 0 computes S^T =
// K qc^T and P^T, hands P^T over and, while the exchange waits, issues dV
// += P^T dO on its panels; W = 1 computes dP^T = V dO^T, rounds and hands
// it over; both form dS^T = P^T (dP^T - delta) and add dK += dS^T qc on
// their panels.
template <int D, int W>
__device__ __forceinline__ void dkdv_split_consumer(uint32_t base, unsigned char* gbase, int nq,
                                                    int k0, int N, long long head, long long sn,
                                                    bf16* __restrict__ dk,
                                                    bf16* __restrict__ dv) {
  using L = SplitSmem<D, true>;
  using C = SplitPanels<L::P, W>;
  constexpr int P = L::P, kStages = L::kStages, PW = C::count;
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kStages;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* xch = reinterpret_cast<uint32_t*>(gbase + L::xch);
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
    uint32_t* mine = xch + (2 * (it & 1) + W) * L::kSlotWords;
    const uint32_t* theirs = xch + (2 * (it & 1) + 1 - W) * L::kSlotWords;

    // S^T = K qc^T (W = 0) or dP^T = V dO^T (W = 1): 64 keys x 64 queries
    float x[8][4];
    zero_acc(x);
    vst::fence_acc(x);
    vst::wgmma_fence();
    wgmma_rows<P, kPanel64>(x, base + (W == 0 ? L::res_a : L::res_b), W == 0 ? qs : dos);
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
    vst::fence_acc(x);

    uint32_t pa[4][4], dpr[4][4];
    if constexpr (W == 0) {
      // P^T (columns are queries), handed over; dV += P^T dO meanwhile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float l0 = ls[8 * j + 2 * t], l1 = ls[8 * j + 2 * t + 1];
        pa[j >> 1][(j & 1) * 2] = p_pair(x[j][0] - l0, x[j][1] - l1);
        pa[j >> 1][(j & 1) * 2 + 1] = p_pair(x[j][2] - l0, x[j][3] - l1);
      }
      put_frags(mine, pa, tid);
      fence_all<PW>(adv);
      vst::wgmma_fence();
      wgmma_frags_tile<PW>(adv, pa, dos + C::first * kPanel64);
      vst::wgmma_commit();
      vst::named_sync(1, 256);
      get_frags(theirs, dpr, tid);
    } else {
      round_pairs(x, dpr);
      put_frags(mine, dpr, tid);
      vst::named_sync(1, 256);
      get_frags(theirs, pa, tid);
      fence_all<PW>(adv);
      vst::wgmma_fence();
      wgmma_frags_tile<PW>(adv, pa, dos + C::first * kPanel64);
      vst::wgmma_commit();
    }

    // dS^T = P^T (dP^T - delta), then dK += dS^T qc
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t dd = vst::pack_bf16(dls[8 * j + 2 * t], dls[8 * j + 2 * t + 1]);
      const int i = j >> 1, c = (j & 1) * 2;
      sa[i][c] = ds_packed(pa[i][c], dpr[i][c], dd);
      sa[i][c + 1] = ds_packed(pa[i][c + 1], dpr[i][c + 1], dd);
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

// Grid (N / 64, H, B), 384 threads: consumer warpgroups 0 and 1 on the
// block's 64 keys k0 .. (dkdv_split_consumer), producer warpgroup 2.
template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dkdv_split_kernel(const __grid_constant__ CUtensorMap mk,
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
    dkdv_split_consumer<D, 0>(base, gbase, nq, k0, N, head, os.n, dk, dv);
  else
    dkdv_split_consumer<D, 1>(base, gbase, nq, k0, N, head, os.n, dk, dv);
}

// Consumer warpgroup W of the split dQ kernel, for the block's queries
// q0 .. q0 + 63 (resident qc and dO). Per key tile: W = 0 computes S =
// qc K^T and P, W = 1 dP = dO V^T rounded; they swap the two, both form
// dS = P (dP - delta) and add dQ += dS K on their panels.
template <int D, int W>
__device__ __forceinline__ void dq_split_consumer(uint32_t base, unsigned char* gbase, int nk,
                                                  int q0, int N, long long vrow, long long head,
                                                  long long sn, const float* __restrict__ lse,
                                                  const float* __restrict__ delta,
                                                  bf16* __restrict__ dq, float scale) {
  using L = SplitSmem<D, false>;
  using C = SplitPanels<L::P, W>;
  constexpr int P = L::P, kStages = L::kStages, PW = C::count;
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kStages;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* xch = reinterpret_cast<uint32_t*>(gbase + L::xch);
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;   // < N: N is a multiple of 64
  const float l0 = lse[vrow + r0], l1 = lse[vrow + r1];
  const float d0 = delta[vrow + r0], d1 = delta[vrow + r1];
  const uint32_t dd0 = vst::pack_bf16(d0, d0), dd1 = vst::pack_bf16(d1, d1);
  float acc[PW][8][4];
#pragma unroll
  for (int p = 0; p < PW; ++p) zero_acc(acc[p]);
  vst::mbar_wait(res_bar, 0);

  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    vst::mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint32_t ks = base + L::stage0 + s * L::stage_bytes, vs = ks + P * kPanel64;
    uint32_t* mine = xch + (2 * (it & 1) + W) * L::kSlotWords;
    const uint32_t* theirs = xch + (2 * (it & 1) + 1 - W) * L::kSlotWords;

    // S = qc K^T (W = 0) or dP = dO V^T (W = 1): 64 queries x 64 keys
    float x[8][4];
    zero_acc(x);
    vst::fence_acc(x);
    vst::wgmma_fence();
    wgmma_rows<P, kPanel64>(x, base + (W == 0 ? L::res_a : L::res_b), W == 0 ? ks : vs);
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
    vst::fence_acc(x);

    uint32_t pa[4][4], dpr[4][4];
    if constexpr (W == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pa[j >> 1][(j & 1) * 2] = p_pair(x[j][0] - l0, x[j][1] - l0);
        pa[j >> 1][(j & 1) * 2 + 1] = p_pair(x[j][2] - l1, x[j][3] - l1);
      }
      put_frags(mine, pa, tid);
      vst::named_sync(1, 256);
      get_frags(theirs, dpr, tid);
    } else {
      round_pairs(x, dpr);
      put_frags(mine, dpr, tid);
      vst::named_sync(1, 256);
      get_frags(theirs, pa, tid);
    }

    // dS = P (dP - delta), then dQ += dS K
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = j >> 1, c = (j & 1) * 2;
      sa[i][c] = ds_packed(pa[i][c], dpr[i][c], dd0);
      sa[i][c + 1] = ds_packed(pa[i][c + 1], dpr[i][c + 1], dd1);
    }
    fence_all<PW>(acc);
    vst::wgmma_fence();
    wgmma_frags_tile<PW>(acc, sa, ks + C::first * kPanel64);
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
    fence_all<PW>(acc);
    release_stage(empty0 + 8 * s, lane);
  }

  store_rows<PW>(acc, dq + 64 * C::first, head, r0, N, sn, t, scale);
}

// Grid (N / 64, H, B), 384 threads: consumer warpgroups 0 and 1 on the
// block's 64 queries q0 .. (dq_split_consumer), producer warpgroup 2.
template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dq_split_kernel(const __grid_constant__ CUtensorMap mqc,
                         const __grid_constant__ CUtensorMap mdo,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int N, Strides os, float scale) {
  using L = SplitSmem<D, false>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L::bars, full0 = res_bar + 8, empty0 = full0 + 8 * kStages;
  const int q0 = blockIdx.x * kStepRows, h = blockIdx.y, b = blockIdx.z;
  const int nk = N / kStepRows;
  init_barriers(res_bar, full0, empty0, kStages);
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<24>();
    if (threadIdx.x == 256)
      produce<L::P, kStepRows, kStages, L::stage_bytes, L::tile_tx>(
          &mqc, &mdo, &mk, &mv, nullptr, nullptr, base + L::res_a, base + L::stage0, 0, 0,
          res_bar, full0, empty0, q0, nk, h, b);
    return;
  }
  vst::regs_alloc<240>();
  const long long vrow = ((long long)b * H + h) * N;
  const long long head = (long long)b * os.b + (long long)h * os.h;
  if (wg == 0)
    dq_split_consumer<D, 0>(base, gbase, nk, q0, N, vrow, head, os.n, lse, delta, dq, scale);
  else
    dq_split_consumer<D, 1>(base, gbase, nk, q0, N, vrow, head, os.n, lse, delta, dq, scale);
}

// ---- bf16, D = 320 to 512: wgmma kernels, scores split, column groups ----

// The dK/dV kernel's column groups: ng = ceil(P / 4) groups of the head's
// P = D / 64 panels, group g on panels [first(g), first(g + 1)); within a
// group of G panels warpgroup 0 (which also takes P's exponentials)
// accumulates dK and dV on the first floor(G / 2), warpgroup 1 on the
// rest: at most 2 panels, 128 accumulator registers a thread. The dQ
// kernel splits the whole head the same way (at most 4 panels, 128
// registers).
__host__ __device__ constexpr int wider_groups(int P) { return (P + 3) / 4; }
__host__ __device__ constexpr int wider_group_first(int P, int g) {
  return g * P / wider_groups(P);
}

// Shared memory of the two kernels at P panels (P known at run time),
// byte offsets from a 1024-byte aligned base: the block's resident 64-row
// tiles (K and V, or qc and dO; P panels each), the exchange (two 8 KB
// slots of bf16 pairs in the A layout, slot w warpgroup w's), in the
// dK/dV kernel each warpgroup's two stages of its query tile's LSE2 and
// delta rows (512 bytes), each warpgroup's ring of 64 x 64 panel stages
// (as many as fit, at most kMaxStages), then the mbarriers (resident,
// then for each warpgroup full[stages], empty[stages] and, dK/dV, the
// row vectors' full[2] and empty[2]).
struct WiderBwdSmem {
  static constexpr int kMaxStages = 8;
  static constexpr uint32_t kSlot = 16 * 128 * 4;
  uint32_t res_b, xch, vec, ring0, bars;
  int stages, wbars;   // wbars: one warpgroup's barriers
  size_t bytes;
  __host__ __device__ WiderBwdSmem(int P, bool row_vectors) {
    res_b = P * kPanel64;
    xch = 2 * P * kPanel64;
    vec = xch + 2 * kSlot;
    ring0 = vec + (row_vectors ? 2 * 2 * 512 : 0);
    const int vbars = row_vectors ? 4 : 0;
    const uint32_t fixed = ring0 + 8 * (1 + 2 * (2 * kMaxStages + vbars)) + 1024;
    stages = (232448 - static_cast<int>(fixed)) / static_cast<int>(2 * kPanel64);
    if (stages > kMaxStages) stages = kMaxStages;
    wbars = 2 * stages + vbars;
    bars = ring0 + 2 * stages * kPanel64;
    bytes = bars + 8 * (1 + 2 * wbars) + 1024;   // + alignment
  }
};

// The least ring a wider kernel runs with: a score chain holds two
// stages, the dK/dV kernel's products four.
constexpr int kWiderMinStages = 4;



// x (64 x 64) = A B^T over the head, panel by panel: A's P panels resident
// at a, B's the ring's next P items, both K-major. One commit group a
// panel, issued once its stage has landed; each item is released once the
// group after it has completed, so the chain holds at most two stages
// whatever P is. PS > 0: P = PS, unrolled.
template <int PS = 0>
__device__ __forceinline__ void score_chain(float (&x)[8][4], uint32_t a, int P,
                                            vst::RingConsumer& ring) {
  auto panel = [&](int i) {
    const uint32_t bt = ring.next(), ap = a + i * kPanel64;
    vst::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      vst::wgmma_ss_n64_t<0, 0>(x, vst::desc_kmajor(ap, j), vst::desc_kmajor(bt, j),
                                (i | j) != 0);
    vst::wgmma_commit();
    if (i > 0) {
      vst::wgmma_wait<1>();
      ring.release(1);
    }
  };
  if constexpr (PS > 0) {
#pragma unroll
    for (int i = 0; i < PS; ++i) panel(i);
  } else {
    for (int i = 0; i < P; ++i) panel(i);
  }
  vst::wgmma_wait<0>();
  ring.release(1);
  vst::fence_acc(x);
}

// out[p] += A (64 x 64 bf16 in registers) B_p for p < PO, B_p the ring's
// next PO items (contracting over their rows: MN-major), one commit group
// issued once all PO stages have landed.
template <int PO>
__device__ __forceinline__ void frags_panels(float (&out)[PO][8][4], const uint32_t (&a)[4][4],
                                             vst::RingConsumer& ring) {
  const int b0 = ring.wait(PO);
  fence_all<PO>(out);
  vst::wgmma_fence();
#pragma unroll
  for (int p = 0; p < PO; ++p)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      vst::wgmma_rs_n64_t<1>(out[p], a[kc], vst::desc_mnmajor(ring.at(b0, p), kc, kPanel64));
  vst::wgmma_commit();
}

// The exchange: this warpgroup's tile of bf16 pairs into its slot, the
// other's out of its slot. Barrier 2: the other warpgroup has read this
// slot's previous tile; barrier 1: both slots are written.
__device__ __forceinline__ void swap_frags(uint32_t* mine, const uint32_t* theirs,
                                          const uint32_t (&give)[4][4], uint32_t (&take)[4][4],
                                          int tid) {
  vst::named_sync(2, 256);
  put_frags(mine, give, tid);
  vst::named_sync(1, 256);
  get_frags(theirs, take, tid);
}

// Consumer warpgroup W of the dK/dV kernel for heads of 320 to 512, for
// the block's keys k0 .. k0 + 63 (K and V resident) and PO output panels
// from `of` of its column group. Per query tile: W = 0 sums S^T = K qc^T
// over the head and forms P^T, W = 1 dP^T = V dO^T and rounds it (each a
// score chain over the ring's next P items: qc, or dO); W = 0 issues dV
// += P^T dO (the ring's next PO items: dO on its panels) before the
// exchange, W = 1 after it; both form dS^T = P^T (dP^T - delta) and issue
// dK += dS^T qc (the next PO items: qc on its panels). The dO stages go
// back as soon as dV has completed, while dK runs.
// The dK/dV kernel's hand-over of dS^T to the dQ kernel: none, or (with a
// cluster) into a bf16 scratch [B H, N keys, N queries] at `dst` (the
// block's first key row), warpgroup 1 of CTA `rank` storing the query
// tiles it with it % ctas == rank (every CTA of the cluster holds the same
// dS^T bits). In the A-fragment layout thread (warp, g, t) holds rows 16
// warp + g and + 8, columns 16 i + 2 t, + 1, + 8, + 9 of chunk i.
struct NoDsOut {
  __device__ __forceinline__ void operator()(const uint32_t (&)[4][4], int) const {}
};
struct DsOut {
  bf16* dst;
  int n, rank, ctas;
  __device__ __forceinline__ void operator()(const uint32_t (&sa)[4][4], int it) const {
    if (it % ctas != rank) return;
    const int tid = threadIdx.x & 127, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    bf16* row0 = dst + (long long)(16 * warp + g) * n + 64 * it + 2 * t;
    bf16* row1 = row0 + 8LL * n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<uint32_t*>(row0 + 16 * i) = sa[i][0];
      *reinterpret_cast<uint32_t*>(row1 + 16 * i) = sa[i][1];
      *reinterpret_cast<uint32_t*>(row0 + 16 * i + 8) = sa[i][2];
      *reinterpret_cast<uint32_t*>(row1 + 16 * i + 8) = sa[i][3];
    }
  }
};

// With a cluster (Smem ClusterBwdSmem, Sum a vst::ClusterSum, Ds a
// DsOut), P = PS is the CTA's panels, known at compile time (a score
// chain of a run-time length before the cluster sum's branches made ptxas
// serialise the wgmmas, advisory C7518), the warpgroup's score tile is
// summed over the cluster's CTAs between its chain and the exchange, and
// warpgroup 1 hands dS^T over to the dQ kernel.
template <int W, int PO, int PS = 0, class Smem = WiderBwdSmem, class Sum = vst::NoClusterSum,
          class Ds = NoDsOut>
__device__ __forceinline__ void dkdv_wider_consumer(uint32_t base, unsigned char* gbase,
                                                    const Smem& L, int P, int nq, int k0,
                                                    int of, int N, long long head, long long sn,
                                                    uint32_t res_bar, uint32_t wb,
                                                    bf16* __restrict__ dk,
                                                    bf16* __restrict__ dv, Sum sum = {},
                                                    Ds ds_out = {}) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* xch = reinterpret_cast<uint32_t*>(gbase + L.xch);
  uint32_t* mine = xch + W * (L.kSlot / 4);
  const uint32_t* theirs = xch + (1 - W) * (L.kSlot / 4);
  vst::RingConsumer ring{base + L.ring0 + W * L.stages * kPanel64, kPanel64, wb,
                         wb + 8 * L.stages, L.stages, lane};
  const uint32_t vfull0 = wb + 16 * L.stages, vempty0 = vfull0 + 16;
  const float* vecs = reinterpret_cast<const float*>(gbase + L.vec + W * 1024);
  vst::RingCursor vc;
  float adk[PO][8][4], adv[PO][8][4];
#pragma unroll
  for (int p = 0; p < PO; ++p) {
    zero_acc(adk[p]);
    zero_acc(adv[p]);
  }
  vst::mbar_wait(res_bar, 0);

  for (int it = 0; it < nq; ++it) {
    vst::mbar_wait(vfull0 + 8 * vc.stage, vc.phase);
    const float* ls = vecs + vc.stage * 128;
    const float* dls = ls + kStepRows;

    // S^T (W = 0) or dP^T (W = 1): 64 keys x 64 queries
    float x[8][4];
    score_chain<PS>(x, base + (W == 0 ? 0 : L.res_b), P, ring);
    sum(x, tid);
    uint32_t pa[4][4], dpr[4][4];
    if constexpr (W == 0) {
      // P^T (columns are queries); dV += P^T dO while the exchange waits
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float l0 = ls[8 * j + 2 * t], l1 = ls[8 * j + 2 * t + 1];
        pa[j >> 1][(j & 1) * 2] = p_pair(x[j][0] - l0, x[j][1] - l1);
        pa[j >> 1][(j & 1) * 2 + 1] = p_pair(x[j][2] - l0, x[j][3] - l1);
      }
      frags_panels<PO>(adv, pa, ring);
      swap_frags(mine, theirs, pa, dpr, tid);
    } else {
      round_pairs(x, dpr);
      swap_frags(mine, theirs, dpr, pa, tid);
      frags_panels<PO>(adv, pa, ring);
    }

    // dS^T = P^T (dP^T - delta), then dK += dS^T qc
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t dd = vst::pack_bf16(dls[8 * j + 2 * t], dls[8 * j + 2 * t + 1]);
      const int i = j >> 1, c = (j & 1) * 2;
      sa[i][c] = ds_packed(pa[i][c], dpr[i][c], dd);
      sa[i][c + 1] = ds_packed(pa[i][c + 1], dpr[i][c + 1], dd);
    }
    frags_panels<PO>(adk, sa, ring);
    if constexpr (W == 1) ds_out(sa, it);
    vst::wgmma_wait<1>();
    ring.release(PO);   // dO, read by dV
    vst::wgmma_wait<0>();
    fence_all<PO>(adk);
    fence_all<PO>(adv);
    ring.release(PO);   // qc, read by dK
    release_stage(vempty0 + 8 * vc.stage, lane);
    vc.advance(2);
  }

  const int r = k0 + 16 * warp + g;
  store_rows<PO>(adk, dk + 64 * of, head, r, N, sn, t, kLn2);
  store_rows<PO>(adv, dv + 64 * of, head, r, N, sn, t, 1.f);
}

// Grid (N / 64 * ng, H, B), 384 threads; block x = 64-key tile * ng +
// column group. Consumer warpgroups 0 and 1 on the block's keys
// (dkdv_wider_consumer); producer warpgroup 2, whose threads 256 and 288
// feed warpgroup 0's and 1's rings: for each query tile its LSE2 and
// delta rows, the P panels of qc (warpgroup 0) or dO (1) for the score
// chain, then the warpgroup's output panels of dO and of qc. Thread 256
// also loads K and V.
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dkdv_wider_kernel(const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mqc,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N, int P,
                           Strides os) {
  const WiderBwdSmem L(P, true);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L.bars;
  auto wbars = [&](int w) { return res_bar + 8 + w * 8 * L.wbars; };
  const int ng = wider_groups(P), grp = blockIdx.x % ng;
  const int k0 = (blockIdx.x / ng) * kStepRows, h = blockIdx.y, b = blockIdx.z;
  const int nq = N / kStepRows;
  const int gf = wider_group_first(P, grp), gn = wider_group_first(P, grp + 1) - gf;
  const int po0 = gn / 2;
  if (threadIdx.x == 0) {
    vst::mbar_init(res_bar, 1);
    for (int w = 0; w < 2; ++w) {
      const uint32_t wb = wbars(w);
      vst::ring_init(wb, wb + 8 * L.stages, L.stages, 4);
      vst::ring_init(wb + 16 * L.stages, wb + 16 * L.stages + 16, 2, 4);
    }
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer: 40 registers (two rings a thread), the consumers 232
    vst::regs_dealloc<40>();
    const int lt = threadIdx.x - 256;
    if (lt == 0 || lt == 32) {
      const int w = lt / 32;
      const uint32_t full0 = wbars(w), empty0 = full0 + 8 * L.stages;
      const uint32_t vfull0 = full0 + 16 * L.stages, vempty0 = vfull0 + 16;
      const uint32_t slots = base + L.ring0 + w * L.stages * kPanel64;
      const uint32_t vecs = base + L.vec + w * 1024;
      const long long vrow = ((long long)b * H + h) * N;
      if (w == 0) {
        vst::mbar_arrive_expect_tx(res_bar, 2 * P * kPanel64);
        for (int p = 0; p < P; ++p) {
          vst::tma_load_4d(base + p * kPanel64, &mk, res_bar, 64 * p, h, k0, b);
          vst::tma_load_4d(base + L.res_b + p * kPanel64, &mv, res_bar, 64 * p, h, k0, b);
        }
      }
      vst::RingCursor c, vc;
      auto push = [&](const CUtensorMap* map, int p, int row) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        vst::mbar_arrive_expect_tx(full0 + 8 * c.stage, kPanel64);
        vst::tma_load_4d(slots + c.stage * kPanel64, map, full0 + 8 * c.stage, 64 * p, h, row,
                         b);
        c.advance(L.stages);
      };
      const int of = w ? gf + po0 : gf, no = w ? gn - po0 : po0;
      for (int it = 0; it < nq; ++it) {
        const int row = it * kStepRows;
        vst::mbar_wait(vempty0 + 8 * vc.stage, vc.phase ^ 1);
        const uint32_t vfull = vfull0 + 8 * vc.stage, vec = vecs + 512 * vc.stage;
        vst::mbar_arrive_expect_tx(vfull, 512);
        vst::bulk_load(vec, lse + vrow + row, 256, vfull);
        vst::bulk_load(vec + 256, delta + vrow + row, 256, vfull);
        vc.advance(2);
        for (int p = 0; p < P; ++p) push(w == 0 ? &mqc : &mdo, p, row);
        for (int p = of; p < of + no; ++p) push(&mdo, p, row);
        for (int p = of; p < of + no; ++p) push(&mqc, p, row);
      }
      // let the consumer release every stage before leaving
      for (int s = 0; s < L.stages; ++s) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        c.advance(L.stages);
      }
      for (int s = 0; s < 2; ++s) {
        vst::mbar_wait(vempty0 + 8 * vc.stage, vc.phase ^ 1);
        vc.advance(2);
      }
    }
    return;
  }
  vst::regs_alloc<232>();
  const long long head = (long long)b * os.b + (long long)h * os.h;
  const int of = wg ? gf + po0 : gf;
#define VST_DKDV_ARGS base, gbase, L, P, nq, k0, of, N, head, os.n, res_bar, wbars(wg), dk, dv
  if (wg == 0) {
    if (po0 == 2)
      dkdv_wider_consumer<0, 2>(VST_DKDV_ARGS);
    else
      dkdv_wider_consumer<0, 1>(VST_DKDV_ARGS);
  } else {
    if (gn - po0 == 2)
      dkdv_wider_consumer<1, 2>(VST_DKDV_ARGS);
    else
      dkdv_wider_consumer<1, 1>(VST_DKDV_ARGS);
  }
#undef VST_DKDV_ARGS
}

// Consumer warpgroup W of the dQ kernel for heads of 320 to 512, for the
// block's queries q0 .. q0 + 63 (qc and dO resident) and PO output panels
// from `of`. Per key tile: W = 0 sums S = qc K^T over the head and forms
// P, W = 1 dP = dO V^T and rounds it (score chains over the ring's next P
// items: K, or V); they swap the two, both form dS = P (dP - delta) and
// add dQ += dS K on their panels (the ring's next PO items: K).
template <int W, int PO>
__device__ __forceinline__ void dq_wider_consumer(uint32_t base, unsigned char* gbase,
                                                  const WiderBwdSmem& L, int P, int nk, int q0,
                                                  int of, int N, long long vrow, long long head,
                                                  long long sn, uint32_t res_bar, uint32_t wb,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta,
                                                  bf16* __restrict__ dq, float scale) {
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
    score_chain(x, base + (W == 0 ? 0 : L.res_b), P, ring);
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

// Grid (N / 64, H, B), 384 threads: consumer warpgroups 0 and 1 on the
// block's 64 queries (dq_wider_consumer), producer warpgroup 2, whose
// threads 256 and 288 feed warpgroup 0's and 1's rings: for each key tile
// the P panels of K (warpgroup 0) or V (1) for the score chain, then the
// K panels of the warpgroup's output share. Thread 256 also loads qc and
// dO.
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dq_wider_kernel(const __grid_constant__ CUtensorMap mqc,
                         const __grid_constant__ CUtensorMap mdo,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int N, int P, Strides os, float scale) {
  const WiderBwdSmem L(P, false);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L.bars;
  auto wbars = [&](int w) { return res_bar + 8 + w * 8 * L.wbars; };
  const int q0 = blockIdx.x * kStepRows, h = blockIdx.y, b = blockIdx.z;
  const int nk = N / kStepRows;
  const int po0 = P / 2;   // warpgroup 0's output panels [0, po0), 1's [po0, P)
  if (threadIdx.x == 0) {
    vst::mbar_init(res_bar, 1);
    for (int w = 0; w < 2; ++w) vst::ring_init(wbars(w), wbars(w) + 8 * L.stages, L.stages, 4);
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<24>();
    const int lt = threadIdx.x - 256;
    if (lt == 0 || lt == 32) {
      const int w = lt / 32;
      const uint32_t full0 = wbars(w), empty0 = full0 + 8 * L.stages;
      const uint32_t slots = base + L.ring0 + w * L.stages * kPanel64;
      if (w == 0) {
        vst::mbar_arrive_expect_tx(res_bar, 2 * P * kPanel64);
        for (int p = 0; p < P; ++p) {
          vst::tma_load_4d(base + p * kPanel64, &mqc, res_bar, 64 * p, h, q0, b);
          vst::tma_load_4d(base + L.res_b + p * kPanel64, &mdo, res_bar, 64 * p, h, q0, b);
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
      const int of = w ? po0 : 0, no = w ? P - po0 : po0;
      for (int it = 0; it < nk; ++it) {
        const int row = it * kStepRows;
        for (int p = 0; p < P; ++p) push(w == 0 ? &mk : &mv, p, row);
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
#define VST_DQ_ARGS(of) base, gbase, L, P, nk, q0, of, N, vrow, head, os.n, res_bar, wbars(wg), \
                        lse, delta, dq, scale
  if (wg == 0) {
    if (po0 == 2)
      dq_wider_consumer<0, 2>(VST_DQ_ARGS(0));
    else if (po0 == 3)
      dq_wider_consumer<0, 3>(VST_DQ_ARGS(0));
    else
      dq_wider_consumer<0, 4>(VST_DQ_ARGS(0));
  } else {
    if (P - po0 == 3)
      dq_wider_consumer<1, 3>(VST_DQ_ARGS(po0));
    else
      dq_wider_consumer<1, 4>(VST_DQ_ARGS(po0));
  }
#undef VST_DQ_ARGS
}

// ---- bf16, D = 576 to 2048: wgmma kernels over a cluster that splits the head

using vst::cluster_ctas;
using vst::cluster_first;

// Shared memory of the cluster dK/dV kernel, byte offsets from a
// 1024-byte aligned base: the resident 64-row tiles of K and V on the
// CTA's panels (4 panel slots each), the exchange of bf16 tiles between
// the warpgroups (WiderBwdSmem's), each warpgroup's two stages of LSE2
// and delta rows, each warpgroup's cluster-sum buffers (csum_bytes(C)),
// each warpgroup's ring of 64 x 64 panel stages, then the mbarriers
// (resident, then for each warpgroup full[stages], empty[stages], the row
// vectors' full[2] and empty[2], then the cluster sum's red and gat).
struct ClusterBwdSmem {
  static constexpr int kMaxStages = 8;
  static constexpr uint32_t kSlot = WiderBwdSmem::kSlot;
  uint32_t res_b, xch, vec, csum, ring0, bars;
  int stages, wbars;   // wbars: one warpgroup's barriers
  size_t bytes;
  __host__ __device__ explicit ClusterBwdSmem(int C) {
    res_b = 4 * kPanel64;
    xch = 8 * kPanel64;
    vec = xch + 2 * kSlot;
    csum = vec + 2 * 2 * 512;
    ring0 = csum + 2 * vst::csum_bytes(C);
    const int vbars = 4 + 2;
    const uint32_t fixed = ring0 + 8 * (1 + 2 * (2 * kMaxStages + vbars)) + 1024;
    stages = (232448 - static_cast<int>(fixed)) / static_cast<int>(2 * kPanel64);
    if (stages > kMaxStages) stages = kMaxStages;
    wbars = 2 * stages + vbars;
    bars = ring0 + 2 * stages * kPanel64;
    bytes = bars + 8 * (1 + 2 * wbars) + 1024;   // + alignment
  }
};

// Warpgroup w's cluster sum in a cluster kernel: its buffers, and its red
// and gat barriers, the last two of its wbars.
template <int C>
__device__ __forceinline__ vst::ClusterSum<C> bwd_cluster_sum(const ClusterBwdSmem& L,
                                                              uint32_t base, uint32_t wb, int w,
                                                              int rank) {
  const uint32_t buf = base + L.csum + w * vst::csum_bytes(C);
  const uint32_t xb = wb + 8 * (L.wbars - 2);
  return vst::ClusterSum<C>{buf, buf + vst::csum_gat(C), xb, xb + 8, rank, 0};
}

// Grid (C N / 64, H, B) in clusters of C = cluster_ctas(P) along x, 384
// threads; block x = 64-key tile * C + cluster rank. The cluster's CTAs
// share the tile's 64 keys and split the head: CTA r holds K and V on
// its PR panels and computes dK and dV there. Consumer warpgroups 0 and
// 1 (dkdv_wider_consumer on the CTA's panels, each score tile summed over
// the cluster: S^T by the warpgroups 0, dP^T by the warpgroups 1, so
// every CTA forms the same P^T and dS^T), warpgroup 0 on dK and dV's first
// floor(PR / 2) panels, 1 on the rest; producer warpgroup 2, whose threads
// 256 and 288 feed warpgroup 0's and 1's rings: for each query tile its
// LSE2 and delta rows, the PR panels of qc (warpgroup 0) or dO (1) for
// the score chain, then the warpgroup's output panels of dO and of qc.
template <int C>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dkdv_cluster_kernel(const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const __grid_constant__ CUtensorMap mqc,
                             const __grid_constant__ CUtensorMap mdo,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             bf16* __restrict__ ds, int H, int N, int P, Strides os) {
  const ClusterBwdSmem L(C);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L.bars;
  auto wbars = [&](int w) { return res_bar + 8 + w * 8 * L.wbars; };
  const int rank = vst::cluster_rank();
  const int k0 = (blockIdx.x / C) * kStepRows, h = blockIdx.y, b = blockIdx.z;
  const int pf = cluster_first(P, rank), pr = cluster_first(P, rank + 1) - pf;
  const int po0 = pr / 2;
  const int nq = N / kStepRows;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    vst::mbar_init(res_bar, 1);
    for (int w = 0; w < 2; ++w) {
      const uint32_t wb = wbars(w);
      vst::ring_init(wb, wb + 8 * L.stages, L.stages, 4);
      vst::ring_init(wb + 16 * L.stages, wb + 16 * L.stages + 16, 2, 4);
      vst::mbar_init(wb + 8 * (L.wbars - 2), 4);
      vst::mbar_init(wb + 8 * (L.wbars - 1), 4);
    }
    vst::mbar_fence_init();
  }
  __syncthreads();
  vst::ClusterSum<C> sum = bwd_cluster_sum<C>(L, base, wbars(wg < 2 ? wg : 0), wg, rank);
  if (wg < 2) sum.arm(threadIdx.x & 127);
  vst::cluster_sync();   // every CTA's barriers are ready before any remote store

  if (wg == 2) {   // producer: 40 registers (two rings a thread), the consumers 232
    vst::regs_dealloc<40>();
    const int lt = threadIdx.x - 256;
    if (lt == 0 || lt == 32) {
      const int w = lt / 32;
      const uint32_t full0 = wbars(w), empty0 = full0 + 8 * L.stages;
      const uint32_t vfull0 = full0 + 16 * L.stages, vempty0 = vfull0 + 16;
      const uint32_t slots = base + L.ring0 + w * L.stages * kPanel64;
      const uint32_t vecs = base + L.vec + w * 1024;
      const long long vrow = ((long long)b * H + h) * N;
      if (w == 0) {
        vst::mbar_arrive_expect_tx(res_bar, 2 * pr * kPanel64);
        for (int i = 0; i < pr; ++i) {
          vst::tma_load_4d(base + i * kPanel64, &mk, res_bar, 64 * (pf + i), h, k0, b);
          vst::tma_load_4d(base + L.res_b + i * kPanel64, &mv, res_bar, 64 * (pf + i), h, k0, b);
        }
      }
      vst::RingCursor c, vc;
      auto push = [&](const CUtensorMap* map, int p, int row) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        vst::mbar_arrive_expect_tx(full0 + 8 * c.stage, kPanel64);
        vst::tma_load_4d(slots + c.stage * kPanel64, map, full0 + 8 * c.stage, 64 * p, h, row,
                         b);
        c.advance(L.stages);
      };
      const int of = w ? pf + po0 : pf, no = w ? pr - po0 : po0;
      for (int it = 0; it < nq; ++it) {
        const int row = it * kStepRows;
        vst::mbar_wait(vempty0 + 8 * vc.stage, vc.phase ^ 1);
        const uint32_t vfull = vfull0 + 8 * vc.stage, vec = vecs + 512 * vc.stage;
        vst::mbar_arrive_expect_tx(vfull, 512);
        vst::bulk_load(vec, lse + vrow + row, 256, vfull);
        vst::bulk_load(vec + 256, delta + vrow + row, 256, vfull);
        vc.advance(2);
        for (int i = 0; i < pr; ++i) push(w == 0 ? &mqc : &mdo, pf + i, row);
        for (int p = of; p < of + no; ++p) push(&mdo, p, row);
        for (int p = of; p < of + no; ++p) push(&mqc, p, row);
      }
      // let the consumer release every stage before leaving
      for (int s = 0; s < L.stages; ++s) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        c.advance(L.stages);
      }
      for (int s = 0; s < 2; ++s) {
        vst::mbar_wait(vempty0 + 8 * vc.stage, vc.phase ^ 1);
        vc.advance(2);
      }
    }
    return;
  }
  vst::regs_alloc<232>();
  const long long head = (long long)b * os.b + (long long)h * os.h;
  const int of = wg ? pf + po0 : pf;
  const DsOut ds_out{ds + ((long long)b * H + h) * N * N + (long long)k0 * N, N, rank, C};
#define VST_DKDV_ARGS \
  base, gbase, L, pr, nq, k0, of, N, head, os.n, res_bar, wbars(wg), dk, dv, sum, ds_out
  // (warpgroup, output panels, score panels): (0, 1, 2), (0, 1, 3), (0, 2,
  // 4), (1, 1, 2), (1, 2, 3), (1, 2, 4)
  if (wg == 0) {
    if (pr == 2)
      dkdv_wider_consumer<0, 1, 2>(VST_DKDV_ARGS);
    else if (pr == 3)
      dkdv_wider_consumer<0, 1, 3>(VST_DKDV_ARGS);
    else
      dkdv_wider_consumer<0, 2, 4>(VST_DKDV_ARGS);
  } else {
    if (pr == 2)
      dkdv_wider_consumer<1, 1, 2>(VST_DKDV_ARGS);
    else if (pr == 3)
      dkdv_wider_consumer<1, 2, 3>(VST_DKDV_ARGS);
    else
      dkdv_wider_consumer<1, 2, 4>(VST_DKDV_ARGS);
  }
#undef VST_DKDV_ARGS
  vst::cluster_sync();   // no CTA leaves while another may still store into it
}

// The dQ kernel for heads of 576 to 2048: dQ = scale dS K, dS^T read from
// the cluster dK/dV kernel's scratch. A block owns 128 queries (64 a
// consumer warpgroup) and a group of 3 or 4 of the head's panels (ceil(P /
// 4) groups, group g from panel g P / groups); per 64-key tile the ring
// brings each warpgroup's 64 x 64 tile of dS^T (keys by queries: wgmma's
// A read MN-major) and the group's K panels (B, MN-major), which both
// warpgroups read. 2 B H N^2 D operations, no exchange: S and dP are not
// recomputed.
__host__ __device__ constexpr int dq_ds_groups(int P) { return (P + 3) / 4; }
__host__ __device__ constexpr int dq_ds_first(int P, int g) { return g * P / dq_ds_groups(P); }
constexpr int kDqDsStages = 12;
constexpr size_t kDqDsSmem = kDqDsStages * kPanel64 + 8 * 2 * kDqDsStages + 1024;

template <int CN>
__device__ __forceinline__ void dq_ds_consumer(uint32_t base, int w, int nk, int q0, int cf,
                                               int N, long long head, long long sn,
                                               uint32_t full0, uint32_t empty0,
                                               bf16* __restrict__ dq, float scale) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  vst::RingConsumer ring{base, kPanel64, full0, empty0, kDqDsStages, lane};
  float acc[CN][8][4];
#pragma unroll
  for (int p = 0; p < CN; ++p) zero_acc(acc[p]);
  for (int it = 0; it < nk; ++it) {
    const int s0 = ring.wait(2 + CN);   // dS^T of warpgroups 0 and 1, then the K panels
    const uint32_t a = ring.at(s0, w);
    fence_all<CN>(acc);
    vst::wgmma_fence();
#pragma unroll
    for (int p = 0; p < CN; ++p)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        vst::wgmma_ss_n64_t<1, 1>(acc[p], vst::desc_mnmajor(a, kc, kPanel64),
                                  vst::desc_mnmajor(ring.at(s0, 2 + p), kc, kPanel64), 1);
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
    fence_all<CN>(acc);
    ring.release(2 + CN);
  }
  store_rows<CN>(acc, dq + 64 * cf, head, q0 + 64 * w + 16 * warp + g, N, sn, t, scale);
}

// Grid (ceil(N / 128) groups, H, B), 384 threads; block x = 128-query
// block * groups + panel group. Consumer warpgroups 0 and 1 on queries q0
// .. + 63 and q0 + 64 .. + 127 (dq_ds_consumer), producer warpgroup 2, one
// thread of which fills the ring.
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dq_ds_kernel(const __grid_constant__ CUtensorMap mds,
                      const __grid_constant__ CUtensorMap mk, bf16* __restrict__ dq, int H,
                      int N, int P, Strides os, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + kDqDsStages * kPanel64, empty0 = full0 + 8 * kDqDsStages;
  const int ng = dq_ds_groups(P), grp = blockIdx.x % ng;
  const int q0 = (blockIdx.x / ng) * 128, h = blockIdx.y, b = blockIdx.z;
  const int cf = dq_ds_first(P, grp), cn = dq_ds_first(P, grp + 1) - cf;
  const int nk = N / 64;
  if (threadIdx.x == 0) {
    vst::ring_init(full0, empty0, kDqDsStages, 8);
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {   // producer
    vst::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      vst::RingCursor c;
      auto push = [&](const CUtensorMap* map, int c0, int c1, int c2, int c3, bool panel4d) {
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        vst::mbar_arrive_expect_tx(full0 + 8 * c.stage, kPanel64);
        const uint32_t dst = base + c.stage * kPanel64;
        if (panel4d)
          vst::tma_load_4d(dst, map, full0 + 8 * c.stage, c0, c1, c2, c3);
        else
          vst::tma_load_2d(dst, map, full0 + 8 * c.stage, c0, c1);
        c.advance(kDqDsStages);
      };
      const int row = (b * H + h) * N;   // the head's first row of dS^T
      for (int it = 0; it < nk; ++it) {
        push(&mds, q0, row + 64 * it, 0, 0, false);
        push(&mds, q0 + 64, row + 64 * it, 0, 0, false);
        for (int i = 0; i < cn; ++i) push(&mk, 64 * (cf + i), h, 64 * it, b, true);
      }
      for (int s = 0; s < kDqDsStages; ++s) {   // let the consumers release every stage
        vst::mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
        c.advance(kDqDsStages);
      }
    }
    return;
  }
  vst::regs_alloc<240>();
  const long long head = (long long)b * os.b + (long long)h * os.h;
  if (cn == 3)
    dq_ds_consumer<3>(base, wg, nk, q0, cf, N, head, os.n, full0, empty0, dq, scale);
  else
    dq_ds_consumer<4>(base, wg, nk, q0, cf, N, head, os.n, full0, empty0, dq, scale);
}

// ---- launchers ----------------------------------------------------------------

template <typename T, int D>
void launch_preprocess(const void* q, const void* o, const void* d_o, void* qc, float* delta,
                       int B, int H, int N, Strides s, Strides os, float qscale,
                       cudaStream_t st) {
  const long long rows = (long long)B * N * H;
  const unsigned blocks = static_cast<unsigned>((rows + kPreRows - 1) / kPreRows);
  attn_bwd_preprocess_kernel<T, D><<<blocks, 32 * kPreRows, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(d_o), static_cast<const T*>(q),
      static_cast<T*>(qc), delta, H, N, rows, s, os, qscale);
}

template <typename T>
void launch_preprocess_wide(const void* q, const void* o, const void* d_o, void* qc,
                            float* delta, int B, int H, int N, int D, Strides s, Strides os,
                            float qscale, cudaStream_t st) {
  const long long rows = (long long)B * N * H;
  const unsigned blocks = static_cast<unsigned>((rows + kPreRows - 1) / kPreRows);
  attn_bwd_preprocess_wide_kernel<T><<<blocks, 32 * kPreRows, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(d_o), static_cast<const T*>(q),
      static_cast<T*>(qc), delta, H, N, D, rows, s, os, qscale);
}

// bf16: preprocess (delta and qc), then the dK/dV and dQ kernels `dkdv`
// and `dq_kernel` (dynamic shared memory smem_dkdv and smem_dq, `rows`
// rows a block) over tensor maps of qc, dO (O's strides) and k, v.
template <int D, typename DkdvKernel, typename DqKernel>
cudaError_t launch_bwd_tma(DkdvKernel dkdv, size_t smem_dkdv, DqKernel dq_kernel, size_t smem_dq,
                           int rows, const void* q, const void* k, const void* v, const void* o,
                           const void* d_o, const float* lse, float* delta, void* qc, void* dq,
                           void* dk, void* dv, int B, int H, int N, Strides s, Strides os,
                           float qscale, float scale, cudaStream_t st) {
  CUtensorMap mqc, mdo, mk, mv;
  if (!vst::bhnd_tensor_map(&mqc, qc, B, N, H, D, os.b, os.n, os.h) ||
      !vst::bhnd_tensor_map(&mdo, d_o, B, N, H, D, os.b, os.n, os.h) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, D, s.b, s.n, s.h) ||
      !vst::bhnd_tensor_map(&mv, v, B, N, H, D, s.b, s.n, s.h))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = vst::allow_smem(dkdv, smem_dkdv)) != cudaSuccess) return err;
  if ((err = vst::allow_smem(dq_kernel, smem_dq)) != cudaSuccess) return err;
  launch_preprocess<bf16, D>(q, o, d_o, qc, delta, B, H, N, s, os, qscale, st);
  const dim3 grid((N + rows - 1) / rows, H, B);
  dkdv<<<grid, kWgmmaThreads, smem_dkdv, st>>>(mk, mv, mqc, mdo, lse, delta,
                                               static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                               H, N, os);
  dq_kernel<<<grid, kWgmmaThreads, smem_dq, st>>>(mqc, mdo, mk, mv, lse, delta,
                                                  static_cast<bf16*>(dq), H, N, os, scale);
  return cudaGetLastError();
}

// bf16 at D = 64 to 256: the wgmma kernels, 128-row blocks at D = 64 and
// 128, 64-row blocks with the scores split at D = 192 and 256.
template <int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                             const void* d_o, const float* lse, float* delta, void* qc,
                             void* dq, void* dk, void* dv, int B, int H, int N, Strides s,
                             Strides os, float qscale, float scale, cudaStream_t st) {
  if constexpr (D <= 128)
    return launch_bwd_tma<D>(attn_bwd_dkdv_wgmma_kernel<D>, WgmmaSmem<D, true>::bytes,
                             attn_bwd_dq_wgmma_kernel<D>, WgmmaSmem<D, false>::bytes, kBlockRows,
                             q, k, v, o, d_o, lse, delta, qc, dq, dk, dv, B, H, N, s, os, qscale,
                             scale, st);
  else
    return launch_bwd_tma<D>(attn_bwd_dkdv_split_kernel<D>, SplitSmem<D, true>::bytes,
                             attn_bwd_dq_split_kernel<D>, SplitSmem<D, false>::bytes, kStepRows,
                             q, k, v, o, d_o, lse, delta, qc, dq, dk, dv, B, H, N, s, os, qscale,
                             scale, st);
}

// f32 at D = 64 or 128: preprocess (delta), then the split-TF32 wgmma
// kernels of dense_attn_tf32.cu over the scratch `ds` (their own split qc:
// no qc scratch).
template <int D>
cudaError_t launch_bwd_tf32(const void* q, const void* k, const void* v, const void* o,
                            const void* d_o, const float* lse, float* delta, void* ds, void* dq,
                            void* dk, void* dv, int B, int H, int N, Strides s, Strides os,
                            float qscale, float scale, cudaStream_t st) {
  if (ds == nullptr) return cudaErrorInvalidValue;
  launch_preprocess<float, D>(q, o, d_o, nullptr, delta, B, H, N, s, os, qscale, st);
  return vst::launch_attn_bwd_tf32(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_o), lse, delta, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), ds, B, H, N, D, s.b, s.n, s.h, os.b,
      os.n, os.h, qscale, scale, st);
}

// bf16 at D = 320 to 512: preprocess (delta and qc), then the wgmma
// dK/dV kernel (ng column groups) and dQ kernel over tensor maps of qc,
// dO (O's strides) and k, v.
cudaError_t launch_bwd_wider(const void* q, const void* k, const void* v, const void* o,
                             const void* d_o, const float* lse, float* delta, void* qc, void* dq,
                             void* dk, void* dv, int B, int H, int N, int D, Strides s,
                             Strides os, float qscale, float scale, cudaStream_t st) {
  const int P = D / 64;
  const WiderBwdSmem ldkdv(P, true), ldq(P, false);
  if (ldkdv.stages < kWiderMinStages || ldq.stages < kWiderMinStages)
    return cudaErrorInvalidValue;
  CUtensorMap mqc, mdo, mk, mv;
  if (!vst::bhnd_tensor_map(&mqc, qc, B, N, H, D, os.b, os.n, os.h) ||
      !vst::bhnd_tensor_map(&mdo, d_o, B, N, H, D, os.b, os.n, os.h) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, D, s.b, s.n, s.h) ||
      !vst::bhnd_tensor_map(&mv, v, B, N, H, D, s.b, s.n, s.h))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = vst::allow_smem(attn_bwd_dkdv_wider_kernel, ldkdv.bytes)) != cudaSuccess) return err;
  if ((err = vst::allow_smem(attn_bwd_dq_wider_kernel, ldq.bytes)) != cudaSuccess) return err;
  launch_preprocess_wide<bf16>(q, o, d_o, qc, delta, B, H, N, D, s, os, qscale, st);
  attn_bwd_dkdv_wider_kernel<<<dim3(N / kStepRows * wider_groups(P), H, B), kWgmmaThreads,
                               ldkdv.bytes, st>>>(mk, mv, mqc, mdo, lse, delta,
                                                  static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                  H, N, P, os);
  attn_bwd_dq_wider_kernel<<<dim3(N / kStepRows, H, B), kWgmmaThreads, ldq.bytes, st>>>(
      mqc, mdo, mk, mv, lse, delta, static_cast<bf16*>(dq), H, N, P, os, scale);
  return cudaGetLastError();
}

// bf16 at D = 576 to 2048: preprocess (delta and qc), then the cluster
// dK/dV and dQ kernels (clusters of C) over tensor maps of qc, dO (O's
// strides) and k, v.
template <int C>
cudaError_t launch_bwd_cluster_c(const void* q, const void* k, const void* v, const void* o,
                                 const void* d_o, const float* lse, float* delta, void* qc,
                                 void* ds, void* dq, void* dk, void* dv, int B, int H, int N,
                                 int D, Strides s, Strides os, float qscale, float scale,
                                 cudaStream_t st) {
  const ClusterBwdSmem L(C);
  if (L.stages < kWiderMinStages) return cudaErrorInvalidValue;
  CUtensorMap mqc, mdo, mk, mv, mds;
  if (!vst::bhnd_tensor_map(&mqc, qc, B, N, H, D, os.b, os.n, os.h) ||
      !vst::bhnd_tensor_map(&mdo, d_o, B, N, H, D, os.b, os.n, os.h) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, D, s.b, s.n, s.h) ||
      !vst::bhnd_tensor_map(&mv, v, B, N, H, D, s.b, s.n, s.h) ||
      !vst::matrix_tensor_map(&mds, ds, (long long)B * H * N, N))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = vst::allow_smem(attn_bwd_dkdv_cluster_kernel<C>, L.bytes)) != cudaSuccess) return err;
  if ((err = vst::allow_smem(attn_bwd_dq_ds_kernel, kDqDsSmem)) != cudaSuccess) return err;
  launch_preprocess_wide<bf16>(q, o, d_o, qc, delta, B, H, N, D, s, os, qscale, st);
  const int P = D / 64;
  if ((err = vst::launch_cluster(attn_bwd_dkdv_cluster_kernel<C>, dim3(C * (N / kStepRows), H, B),
                                 kWgmmaThreads, L.bytes, C, st, mk, mv, mqc, mdo, lse,
                                 static_cast<const float*>(delta), static_cast<bf16*>(dk),
                                 static_cast<bf16*>(dv), static_cast<bf16*>(ds), H, N, P, os)) !=
      cudaSuccess)
    return err;
  attn_bwd_dq_ds_kernel<<<dim3((N + 127) / 128 * dq_ds_groups(P), H, B), kWgmmaThreads,
                          kDqDsSmem, st>>>(mds, mk, static_cast<bf16*>(dq), H, N, P, os, scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd_cluster(const void* q, const void* k, const void* v, const void* o,
                               const void* d_o, const float* lse, float* delta, void* qc,
                               void* ds, void* dq, void* dk, void* dv, int B, int H, int N,
                               int D, Strides s, Strides os, float qscale, float scale,
                               cudaStream_t st) {
  const int P = D / 64;
  if (P < 9 || P > 32 || ds == nullptr) return cudaErrorInvalidValue;
#define VST_BWD_CLUSTER(C)                                                                    \
  launch_bwd_cluster_c<C>(q, k, v, o, d_o, lse, delta, qc, ds, dq, dk, dv, B, H, N, D, s, os, \
                          qscale, scale, st)
  switch (cluster_ctas(P)) {
    case 3:
      return VST_BWD_CLUSTER(3);
    case 4:
      return VST_BWD_CLUSTER(4);
    default:
      return VST_BWD_CLUSTER(8);
  }
#undef VST_BWD_CLUSTER
}

// bf16 above D = 2048: preprocess (delta and qc), then dense_attn_scores.cu's
// kernels (S^T and dP^T into P^T and dS^T, then dV and dK), then the dQ
// kernel over dS^T. ds holds the two scratches, P^T then dS^T.
cudaError_t launch_bwd_scores(const void* q, const void* k, const void* v, const void* o,
                              const void* d_o, const float* lse, float* delta, void* qc,
                              void* ds, void* dq, void* dk, void* dv, int B, int H, int N, int D,
                              Strides s, Strides os, float qscale, float scale, cudaStream_t st) {
  if (ds == nullptr || (long long)B * H * N >= (1ll << 31)) return cudaErrorInvalidValue;
  bf16* pt = static_cast<bf16*>(ds);
  bf16* dst = pt + (long long)B * H * N * N;
  CUtensorMap mds, mk;
  if (!vst::matrix_tensor_map(&mds, dst, (long long)B * H * N, N) ||
      !vst::bhnd_tensor_map(&mk, k, B, N, H, D, s.b, s.n, s.h))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = vst::allow_smem(attn_bwd_dq_ds_kernel, kDqDsSmem)) != cudaSuccess) return err;
  launch_preprocess_wide<bf16>(q, o, d_o, qc, delta, B, H, N, D, s, os, qscale, st);
  if ((err = vst::launch_attn_bwd_scores(
           static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(qc),
           static_cast<const bf16*>(d_o), lse, delta, pt, dst, static_cast<bf16*>(dk),
           static_cast<bf16*>(dv), B, H, N, D, s.b, s.n, s.h, os.b, os.n, os.h, st)) !=
      cudaSuccess)
    return err;
  const int P = D / 64;
  attn_bwd_dq_ds_kernel<<<dim3((N + 127) / 128 * dq_ds_groups(P), H, B), kWgmmaThreads,
                          kDqDsSmem, st>>>(mds, mk, static_cast<bf16*>(dq), H, N, P, os, scale);
  return cudaGetLastError();
}

// f32 from D = 192 up: preprocess (delta), then the split-TF32 wgmma
// kernels of dense_attn_tf32_wide.cu over the scratch `ds` (their own
// split qc: no qc scratch).
cudaError_t launch_bwd_tf32_wide(const void* q, const void* k, const void* v, const void* o,
                                 const void* d_o, const float* lse, float* delta, void* ds,
                                 void* dq, void* dk, void* dv, int B, int H, int N, int D,
                                 Strides s, Strides os, float qscale, float scale,
                                 cudaStream_t st) {
  if (ds == nullptr) return cudaErrorInvalidValue;
  launch_preprocess_wide<float>(q, o, d_o, nullptr, delta, B, H, N, D, s, os, qscale, st);
  return vst::launch_attn_bwd_tf32_wide(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_o), lse, delta, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), ds, B, H, N, D, s.b, s.n, s.h, os.b,
      os.n, os.h, qscale, scale, st);
}

}  // namespace

// q, k, v: [B, N, H, D] with element strides (sb, sn, sh, 1), 16-byte
// aligned rows; o, dO, dq, dk, dv: [B, N, H, D] with strides (ob, on, oh,
// 1); lse and delta (scratch): [B, H, N] f32, contiguous; qc (scratch,
// bf16 only; unused and may be null for f32): [B, N, H, D] with O's
// strides; ds (scratch, bf16 from D = 576: [B H, N, N] bf16, contiguous,
// dS^T from the dK/dV kernel to the dQ kernel, and above D = 2048 two of
// them, P^T then dS^T; f32 at D = 64 and 128:
// attn_tf32_narrow_bwd_scratch(B, H, N, D) bytes, dense_attn_tf32.cuh;
// f32 from D = 192: attn_tf32_bwd_scratch(B, H, N, D) bytes,
// dense_attn_tf32_wide.cuh; else unused and may be null).
// N % 64 == 0, D % 64 == 0 (cudaErrorInvalidValue otherwise).
// The caller checks all of it.
// Launches preprocess, dK/dV and dQ in order on `stream`; returns
// cudaGetLastError() after the launches.
extern "C" int vst_dense_attn_bwd(int is_bf16, const void* q, const void* k,
                                  const void* v, const void* o, const void* d_o,
                                  const void* lse, void* delta, void* qc, void* ds, void* dq,
                                  void* dk, void* dv, int B, int H, int N, int D, long long sb,
                                  long long sn, long long sh, long long ob,
                                  long long on, long long oh, float qscale,
                                  float scale, void* stream) {
  if (is_bf16 && qc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{sb, sn, sh}, os{ob, on, oh};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
#define VST_BWD_ARGS q, k, v, o, d_o, l, dl, qc, dq, dk, dv, B, H, N, s, os, qscale, scale, st
#define VST_BWD_TF32(D)                                                                      \
  launch_bwd_tf32<D>(q, k, v, o, d_o, l, dl, ds, dq, dk, dv, B, H, N, s, os, qscale, scale, st)
  switch (D) {
    case 64:
      err = is_bf16 ? launch_bwd_wgmma<64>(VST_BWD_ARGS) : VST_BWD_TF32(64);
      break;
    case 128:
      err = is_bf16 ? launch_bwd_wgmma<128>(VST_BWD_ARGS) : VST_BWD_TF32(128);
      break;
    default:
      if (D % 64 != 0 || D < 192) {
        err = cudaErrorInvalidValue;
      } else if (!is_bf16) {
        err = launch_bwd_tf32_wide(q, k, v, o, d_o, l, dl, ds, dq, dk, dv, B, H, N, D, s, os,
                                   qscale, scale, st);
      } else if (D == 192) {
        err = launch_bwd_wgmma<192>(VST_BWD_ARGS);
      } else if (D == 256) {
        err = launch_bwd_wgmma<256>(VST_BWD_ARGS);
      } else if (D <= 512) {
        err = launch_bwd_wider(q, k, v, o, d_o, l, dl, qc, dq, dk, dv, B, H, N, D, s, os, qscale,
                               scale, st);
      } else if (D <= 2048) {
        err = launch_bwd_cluster(q, k, v, o, d_o, l, dl, qc, ds, dq, dk, dv, B, H, N, D, s, os,
                                 qscale, scale, st);
      } else {
        err = launch_bwd_scores(q, k, v, o, d_o, l, dl, qc, ds, dq, dk, dv, B, H, N, D, s, os,
                                qscale, scale, st);
      }
  }
#undef VST_BWD_ARGS
#undef VST_BWD_TF32
  return static_cast<int>(err);
}

template <int C>
cudaError_t bwd_cluster_fit(int* fit) {
  const ClusterBwdSmem L(C);
  const cudaError_t err = vst::allow_smem(attn_bwd_dkdv_cluster_kernel<C>, L.bytes);
  return err != cudaSuccess
             ? err
             : vst::cluster_fit(attn_bwd_dkdv_cluster_kernel<C>, C, kWgmmaThreads, L.bytes, fit);
}

// The dK/dV cluster kernel's cudaOccupancyMaxActiveClusters at a head of D
// (576 to 2048; called by dense_attn_fwd.cu's vst_dense_attn_cluster_fit).
int vst_attn_bwd_cluster_fit(int D, int* fit) {
  const int C = cluster_ctas(D / 64);
  return static_cast<int>(C == 3   ? bwd_cluster_fit<3>(fit)
                          : C == 4 ? bwd_cluster_fit<4>(fit)
                                   : bwd_cluster_fit<8>(fit));
}
