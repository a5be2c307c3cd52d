// Fused transformer FFN backward for Hopper (sm_90a), the gradients of
//   y = x + relu(x W1 + b1) W2 + b2
// over x [M, D] (contiguous rows), M % 128 == 0, D % 128 == 0 and hidden
// width F % 128 == 0: every shape the JAX package's gate accepts.
//
// Replaces: vae_song_tpu/ops/ffn.py:_ffn_bwd_kernel (K6b, called through
// _call_bwd). Same formulas and roundings (ffn.py:104-166), cd the input
// dtype:
//   h32  = relu(x W1 + b1) (f32), recomputed as the forward computes it
//   dh32 = (dy W2^T) * [h32 > 0],  dh = round_cd(dh32)
//   dx   = round_cd(dh W1^T) + dy            (add in cd)
//   dW1  = x^T dh,  dW2 = h^T dy             (f32 sums, h = round_cd(h32))
//   db1  = colsum(dh32)  (the f32 dh32, not the rounded dh),  db2 = colsum(dy)
//   every weight and bias gradient rounded once to cd at the end.
// Weights and their gradients are in the port's Dense layout: w1 / dw1 =
// ff_up.weight [F, D], w2 / dw2 = ff_down.weight [D, F].
//
// What bounds it here: the TPU kernel walks row blocks in grid order and
// adds the weight gradients across them in VMEM scratch, which is safe
// only because a TPU grid runs in sequence. Hopper blocks run at once, so
// the backward is three passes on one stream, with no atomics and a
// result that is the same on every run:
//   1. rows: per 128-row block, h32 and dh32 a 64-wide hidden chunk at a
//      time, dx accumulated in f32 registers; h and dh (cd) written to a
//      workspace for pass 2, and per 64 rows the f32 column sums of dh32
//      and dy (db1, db2 partials);
//   2. weight gradients: dW1 = dh^T x and dW2 = dy^T h as products over the
//      M rows, one block per 128 x 128 output tile and per split of the
//      rows (the wrapper picks the split count to fill the card), each
//      writing its f32 partial tile;
//   3. sums: the partials of each output added in a fixed order (L
//      threads each add every L-th split or row block in order, then the
//      L sums are added in order; L depends on the count of partials
//      alone), rounded once to cd.
// h and dh make one round trip through device memory (2 M F in cd, 268 MB
// in bf16 at M = 131072, F = 512, 0.16 ms of the bound's 3.35 TB/s);
// recomputing them inside pass 2 would repeat the two M D F products of
// pass 1 for every output tile column. At that shape one call is 10 M D F
// = 1.7e11 flop (0.174 ms at 989 TFLOP/s): the tensor cores bound it.
//
// bf16: warp-specialised wgmma kernels (sm90.cuh), 384 threads: two
// consumer warpgroups of 64 rows (pass 1) or 64 output rows (pass 2) and
// a producer warpgroup, one thread of which issues TMA loads of 64 x 64
// swizzled panels through mbarrier rings.
//   Pass 1: a block owns 128 rows and DC columns of dx (all of D up to
//   256, else chunks of 256 or 128, each recomputing h and dh over the
//   whole of D). x and dy are resident when D <= 256, else streamed with
//   the weights. Ring A carries, per hidden chunk c, W1[c, p] for each
//   64-deep panel p of D (B of h = x W1[:, c], K-major), then W2[p, c]
//   (B of dh = dy W2[c, :]^T, read MN-major: no transposed copy); h and
//   dh are computed one after the other, the ReLU mask kept as bits in
//   between, so that only one of them is in flight beside the dx
//   accumulator (both at once made ptxas spill and serialise the
//   wgmmas). Ring B carries the W1[c, x0 .. x0 + DC] tile, the B of
//   dx += dh W1[c, :] read MN-major with dh from registers (the
//   accumulator layout is wgmma's A fragment layout).
//   Pass 2: both operands come from their row-major tiles (dh or dy, and
//   x or h; 64 rows a ring stage) read MN-major through the descriptors,
//   no transposing copy.
//
// f32 inputs (mixed_precision: false) take plain FMA kernels of the same
// three-pass shape, no TF32: pass 1 in 64-row blocks and 256-column
// chunks of dx (128 where 256 does not divide D), 16 hidden units a step,
// x and dy staged once up to D = 256 and in 64-column panels above it, so
// any D fits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using vst::pack_bf16;
using vst::round_bf16;

using bf = __nv_bfloat16;

constexpr int kThreads = 384;            // consumer warpgroups 0 and 1, producer 2
constexpr int kBM = 128;                 // rows a block (pass 1)
constexpr int kFC = 64;                  // hidden units a chunk (pass 1)
constexpr int kPartRows = 64;            // rows a db1 / db2 partial sums
constexpr uint32_t kPanel = 64 * vst::kPanelRowBytes;   // 64 x 64 bf16 panel, 8 KB
constexpr int kConsumerWarps = 8;

using vst::release_stage;
using vst::ring_wait_free;
using vst::zero_acc;

// A warp's column sums over its 16 rows, for the two columns a thread
// holds in the accumulator layout (rows g and g + 8 already added): the
// eight values of each column (over g) added by shuffles; every lane ends
// with the sums.
__device__ __forceinline__ void warp_colsum(float& s0, float& s1) {
#pragma unroll
  for (int m = 4; m < 32; m <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, m);
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
  }
}

// ---- pass 1, bf16 ---------------------------------------------------------------

// f32 values of one warpgroup's column-sum blocks: two [4 warps][64] for
// db1, alternating between hidden chunks, and one [4 warps][DC] for db2
__host__ __device__ constexpr int red_floats(int DC) { return 2 * 4 * kFC + 4 * DC; }

// Shared memory, byte offsets from a 1024-byte aligned base: x's and dy's
// resident panels (P each, of 128 rows) when D <= 256; ring A (a weight
// panel, then x's or dy's panel of 128 rows when they stream); ring B
// (DC / 64 W1 panels); the two warpgroups' column-sum blocks; the
// mbarriers (resident, full A[], empty A[], full B[], empty B[]).
struct RowsLayout {
  int P, xres, sa, sb;
  uint32_t a0, a_bytes, b0, b_bytes, red, bars;
  size_t bytes;
};

inline RowsLayout rows_layout(int D, int DC) {
  RowsLayout L{};
  L.P = D / 64;
  L.xres = D <= 256;
  const uint32_t res = L.xres ? 4 * L.P * kPanel : 0;
  L.a0 = res;
  L.a_bytes = kPanel + (L.xres ? 0 : 2 * kPanel);
  L.b_bytes = (DC / 64) * kPanel;
  const uint32_t red = 2 * red_floats(DC) * 4, budget = 220 * 1024;
  // two ring B stages where three or more ring A stages still fit, else one
  for (L.sb = 2; L.sb > 1; --L.sb)
    if (res + 3 * L.a_bytes + L.sb * L.b_bytes + red <= budget) break;
  L.sa = static_cast<int>((budget - res - L.sb * L.b_bytes - red) / L.a_bytes);
  if (L.sa > 8) L.sa = 8;
  L.b0 = L.a0 + L.sa * L.a_bytes;
  L.red = L.b0 + L.sb * L.b_bytes;
  L.bars = L.red + red;
  L.bytes = L.bars + 8 * (1 + 2 * L.sa + 2 * L.sb) + 1024;   // + alignment
  return L;
}

// acc (64 x 64) = A B over D, A the warpgroup's 64 rows of x or dy (the
// resident panels from `res` on, or each ring A item's), B each item's
// weight panel (K-major: W1[c, p]; MN-major: W2[p, c]). One commit group
// an item of ring A, from item `ia` on; once a group is done the stage it
// read is released.
template <int TB>
__device__ __forceinline__ void rows_product(float (&acc)[8][4], int& ia, const RowsLayout& L,
                                             uint32_t base, uint32_t full_a, uint32_t empty_a,
                                             uint32_t res, int wg, int lane) {
  for (int p = 0; p < L.P; ++p, ++ia) {
    const int s = ia % L.sa;
    vst::mbar_wait(full_a + 8 * s, (ia / L.sa) & 1);
    const uint32_t st = base + L.a0 + s * L.a_bytes;
    const uint32_t ap = (L.xres ? res + 2 * p * kPanel : st + kPanel) + wg * kPanel;
    vst::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      vst::wgmma_ss_n64_t<0, TB>(acc, vst::desc_kmajor(ap, kk),
                                 TB ? vst::desc_mnmajor(st, kk, kPanel) : vst::desc_kmajor(st, kk),
                                 p > 0 || kk > 0);
    vst::wgmma_commit();
    vst::wgmma_wait<1>();
    if (p > 0) release_stage(empty_a + 8 * ((ia - 1) % L.sa), lane);
  }
  vst::wgmma_wait<0>();
  vst::fence_acc(acc);
  release_stage(empty_a + 8 * ((ia - 1) % L.sa), lane);
}

// Grid (M / 128, D / DC), 384 threads. Warpgroup w < 2 owns rows
// r0 + 64 w .. + 63, its warp i the 16 rows 16 i .. of those; lane =
// 4 g + t holds rows g and g + 8 of the accumulator layout. Per hidden
// chunk, h32 and then dh32 are computed apart (the ReLU mask kept as bits
// in between), so only one 64 x 64 accumulator is in flight beside dx.
// Column chunk 0 also writes h, dh and the db1 partials.
template <int DC>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                          const __grid_constant__ CUtensorMap mdy,
                          const __grid_constant__ CUtensorMap mw1,
                          const __grid_constant__ CUtensorMap mw2,
                          const __grid_constant__ CUtensorMap mdx, const bf* __restrict__ dy,
                          const bf* __restrict__ b1, bf* __restrict__ dx,
                          bf* __restrict__ hbuf, bf* __restrict__ dhbuf,
                          float* __restrict__ pb1, float* __restrict__ pb2, int D, int F,
                          RowsLayout L) {
  constexpr int NX = DC / 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L.bars, full_a = res_bar + 8, empty_a = full_a + 8 * L.sa;
  const uint32_t full_b = empty_a + 8 * L.sa, empty_b = full_b + 8 * L.sb;
  const int r0 = blockIdx.x * kBM, x0 = blockIdx.y * DC;
  const bool first = blockIdx.y == 0;
  const int P = L.P, nc = F / kFC;
  if (threadIdx.x == 0) {
    vst::mbar_init(res_bar, 1);
    vst::ring_init(full_a, empty_a, L.sa, kConsumerWarps);
    vst::ring_init(full_b, empty_b, L.sb, kConsumerWarps);
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    if (L.xres) {   // x panels, then dy panels, each two 64-row boxes
      vst::mbar_arrive_expect_tx(res_bar, 4 * P * kPanel);
      for (int p = 0; p < P; ++p)
        for (int half = 0; half < 2; ++half) {
          vst::tma_load_2d(base + (2 * p + half) * kPanel, &mx, res_bar, 64 * p, r0 + 64 * half);
          vst::tma_load_2d(base + (2 * (P + p) + half) * kPanel, &mdy, res_bar, 64 * p,
                           r0 + 64 * half);
        }
    }
    int ia = 0, ib = 0;
    for (int c = 0; c < nc; ++c) {
      // W1[c, p] (with x's panel p when it streams) for p < P, then
      // W2[p, c] (with dy's panel p)
      for (int it = 0; it < 2 * P; ++it, ++ia) {
        const bool dh = it >= P;
        const int p = dh ? it - P : it;
        ring_wait_free(empty_a, ia, L.sa);
        const int s = ia % L.sa;
        const uint32_t st = base + L.a0 + s * L.a_bytes, bar = full_a + 8 * s;
        vst::mbar_arrive_expect_tx(bar, L.a_bytes);
        if (dh)
          vst::tma_load_2d(st, &mw2, bar, kFC * c, 64 * p);
        else
          vst::tma_load_2d(st, &mw1, bar, 64 * p, kFC * c);
        if (!L.xres)
          for (int half = 0; half < 2; ++half)
            vst::tma_load_2d(st + (1 + half) * kPanel, dh ? &mdy : &mx, bar, 64 * p,
                             r0 + 64 * half);
      }
      ring_wait_free(empty_b, ib, L.sb);
      const int s = ib % L.sb;
      const uint32_t st = base + L.b0 + s * L.b_bytes, bar = full_b + 8 * s;
      vst::mbar_arrive_expect_tx(bar, L.b_bytes);
      for (int q = 0; q < DC / 64; ++q)
        vst::tma_load_2d(st + q * kPanel, &mw1, bar, x0 + 64 * q, kFC * c);
      ++ib;
    }
    // let the consumers release every stage before leaving
    for (int s = 0; s < L.sa; ++s, ++ia) ring_wait_free(empty_a, ia, L.sa);
    for (int s = 0; s < L.sb; ++s, ++ib) ring_wait_free(empty_b, ib, L.sb);
    return;
  }

  // consumers
  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = r0 + 64 * wg + 16 * warp + g;            // and row + 8
  const long long part = (long long)(r0 / kPartRows + wg);  // this warpgroup's partial row
  float* red = reinterpret_cast<float*>(gbase + L.red) + wg * red_floats(DC);
  const uint32_t res_x = base, res_dy = base + 2 * P * kPanel;
  float dxacc[NX][16][4];
#pragma unroll
  for (int q = 0; q < NX; ++q) zero_acc(dxacc[q]);
  float acc[8][4];
  zero_acc(acc);
  if (L.xres) vst::mbar_wait(res_bar, 0);

  int ia = 0;
  for (int c = 0; c < nc; ++c) {
    // h32 = relu(x W1[:, c] + b1): its ReLU mask as bits (bit 4 j + e for
    // value e of block j) and, on column chunk 0, h to the workspace
    rows_product<0>(acc, ia, L, base, full_a, empty_a, res_x, wg, lane);
    uint32_t mask = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kFC * c + 8 * j + 2 * t;
      const uint32_t bb = vst::ld_u32(b1 + col);
      const float h00 = fmaxf(acc[j][0] + vst::bf16_lo(bb), 0.f);
      const float h01 = fmaxf(acc[j][1] + vst::bf16_hi(bb), 0.f);
      const float h10 = fmaxf(acc[j][2] + vst::bf16_lo(bb), 0.f);
      const float h11 = fmaxf(acc[j][3] + vst::bf16_hi(bb), 0.f);
      mask |= (uint32_t(h00 > 0.f) | uint32_t(h01 > 0.f) << 1 | uint32_t(h10 > 0.f) << 2 |
               uint32_t(h11 > 0.f) << 3) << (4 * j);
      if (first) {
        const long long o0 = (long long)row * F + col;
        *reinterpret_cast<uint32_t*>(hbuf + o0) = pack_bf16(h00, h01);
        *reinterpret_cast<uint32_t*>(hbuf + o0 + 8ll * F) = pack_bf16(h10, h11);
      }
    }

    // dh32 = (dy W2[c, :]^T) * mask; dh rounded into A fragments; on
    // column chunk 0 also dh to the workspace and its column sums (db1)
    rows_product<1>(acc, ia, L, base, full_a, empty_a, res_dy, wg, lane);
    uint32_t df[4][4];
    float* rc = red + (c & 1) * 4 * kFC;   // alternating between chunks
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t m = mask >> (4 * j);
      const float d00 = m & 1 ? acc[j][0] : 0.f, d01 = m & 2 ? acc[j][1] : 0.f;
      const float d10 = m & 4 ? acc[j][2] : 0.f, d11 = m & 8 ? acc[j][3] : 0.f;
      df[j >> 1][(j & 1) * 2] = pack_bf16(d00, d01);
      df[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d10, d11);
      if (first) {
        const long long o0 = (long long)row * F + kFC * c + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dhbuf + o0) = df[j >> 1][(j & 1) * 2];
        *reinterpret_cast<uint32_t*>(dhbuf + o0 + 8ll * F) = df[j >> 1][(j & 1) * 2 + 1];
        float s0 = d00 + d10, s1 = d01 + d11;
        warp_colsum(s0, s1);
        if (g == 0) {
          rc[warp * kFC + 8 * j + 2 * t] = s0;
          rc[warp * kFC + 8 * j + 2 * t + 1] = s1;
        }
      }
    }
    if (first) {
      vst::named_sync(1 + wg, 128);
      if (tid < kFC)
        pb1[part * F + kFC * c + tid] =
            ((rc[tid] + rc[kFC + tid]) + rc[2 * kFC + tid]) + rc[3 * kFC + tid];
    }

    // dx += dh W1[c, x0 ..] (W1 read MN-major, 128 columns a product)
    const int s = c % L.sb;
    vst::mbar_wait(full_b + 8 * s, (c / L.sb) & 1);
    const uint32_t st = base + L.b0 + s * L.b_bytes;
#pragma unroll
    for (int q = 0; q < NX; ++q) vst::fence_acc(dxacc[q]);
    vst::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < NX; ++q)
        vst::wgmma_rs_n128_t<1>(dxacc[q], df[kk], vst::desc_mnmajor(st + 2 * q * kPanel, kk, kPanel));
    vst::wgmma_commit();
    vst::wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < NX; ++q) vst::fence_acc(dxacc[q]);
    release_stage(empty_b + 8 * s, lane);
  }

  // dx = round(dh W1^T) + dy (the add rounded to bf16), and the column
  // sums of dy (db2) over the warpgroup's 64 rows. With dy resident (then
  // the block has all of D), each value of dx overwrites its dy in the
  // warpgroup's panels, which the TMA stores as whole boxes; else dy is
  // read and dx written from and to device memory.
  float* rc = red + 2 * 4 * kFC;
  const int r = 16 * warp + g;   // the thread's first row in its warpgroup's 64
#pragma unroll
  for (int q = 0; q < NX; ++q)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int cc = 128 * q + 8 * j + 2 * t;
      const long long o0 = (long long)row * D + x0 + cc, o1 = o0 + 8ll * D;
      uint32_t* s0p = reinterpret_cast<uint32_t*>(
          gbase + (2 * (P + (cc >> 6)) + wg) * kPanel + vst::swizzled(r, cc & 63));
      uint32_t* s1p = reinterpret_cast<uint32_t*>(
          gbase + (2 * (P + (cc >> 6)) + wg) * kPanel + vst::swizzled(r + 8, cc & 63));
      const uint32_t g0 = L.xres ? *s0p : vst::ld_u32(dy + o0);
      const uint32_t g1 = L.xres ? *s1p : vst::ld_u32(dy + o1);
      const uint32_t d0 = pack_bf16(round_bf16(dxacc[q][j][0]) + vst::bf16_lo(g0),
                                    round_bf16(dxacc[q][j][1]) + vst::bf16_hi(g0));
      const uint32_t d1 = pack_bf16(round_bf16(dxacc[q][j][2]) + vst::bf16_lo(g1),
                                    round_bf16(dxacc[q][j][3]) + vst::bf16_hi(g1));
      if (L.xres) {
        *s0p = d0;
        *s1p = d1;
      } else {
        *reinterpret_cast<uint32_t*>(dx + o0) = d0;
        *reinterpret_cast<uint32_t*>(dx + o1) = d1;
      }
      float s0 = vst::bf16_lo(g0) + vst::bf16_lo(g1), s1 = vst::bf16_hi(g0) + vst::bf16_hi(g1);
      warp_colsum(s0, s1);
      if (g == 0) {
        rc[warp * DC + cc] = s0;
        rc[warp * DC + cc + 1] = s1;
      }
    }
  if (L.xres) vst::fence_proxy_async();
  vst::named_sync(1 + wg, 128);
  for (int i = tid; i < DC; i += 128)
    pb2[part * D + x0 + i] = ((rc[i] + rc[DC + i]) + rc[2 * DC + i]) + rc[3 * DC + i];
  if (L.xres && tid == 0) {
    for (int p = 0; p < P; ++p)
      vst::tma_store_2d(&mdx, base + (2 * (P + p) + wg) * kPanel, 64 * p, r0 + 64 * wg);
    vst::tma_store_drain();
  }
}

// ---- pass 2, bf16 ---------------------------------------------------------------

constexpr int kWTile = 128;    // output tile edge
constexpr int kWStep = 64;     // rows a ring stage
constexpr int kWStages = 6;
constexpr uint32_t kWStageBytes = 4 * kPanel;
constexpr size_t kWgradSmem = kWStages * kWStageBytes + 16 * kWStages + 1024;

// One product of pass 2: C [Ma, Nb] = A^T B summed over rows, A [M, Ma]
// and B [M, Nb] row-major through tensor maps, into ws[split][Ma][Nb].
struct WgradJob {
  float* ws;
  int Ma, Nb;
};

// Grid (tiles of job 0 + tiles of job 1, splits), 384 threads. Block x
// names a 128 x 128 output tile; block y the split of the rows
// [y rows_per_split, + rows_per_split). Warpgroup w < 2 owns output rows
// i0 + 64 w .. + 63; lane = 4 g + t of its warp i holds rows 16 i + g and
// + 8, columns 8 j + 2 t, + 1.
__global__ void __launch_bounds__(kThreads, 1)
ffn_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap ma0,
                       const __grid_constant__ CUtensorMap mb0,
                       const __grid_constant__ CUtensorMap ma1,
                       const __grid_constant__ CUtensorMap mb1, WgradJob job0, WgradJob job1,
                       long long M, long long rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + kWStages * kWStageBytes, empty = full + 8 * kWStages;
  const int tiles0 = (job0.Ma / kWTile) * (job0.Nb / kWTile);
  const bool second = blockIdx.x >= tiles0;
  const WgradJob job = second ? job1 : job0;
  const CUtensorMap* ma = second ? &ma1 : &ma0;
  const CUtensorMap* mb = second ? &mb1 : &mb0;
  const int tile = second ? blockIdx.x - tiles0 : blockIdx.x;
  const int ntn = job.Nb / kWTile;
  const int i0 = (tile / ntn) * kWTile, j0 = (tile % ntn) * kWTile;
  const long long rbeg = (long long)blockIdx.y * rows_per_split;
  const long long rend = min(M, rbeg + rows_per_split);
  const int n = rend > rbeg ? static_cast<int>((rend - rbeg) / kWStep) : 0;
  if (threadIdx.x == 0) {
    vst::ring_init(full, empty, kWStages, kConsumerWarps);
    vst::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    for (int it = 0; it < n + kWStages; ++it) {
      ring_wait_free(empty, it, kWStages);
      if (it >= n) continue;
      const int s = it % kWStages;
      const uint32_t st = base + s * kWStageBytes, bar = full + 8 * s;
      const int m0 = static_cast<int>(rbeg + (long long)it * kWStep);
      vst::mbar_arrive_expect_tx(bar, kWStageBytes);
      for (int half = 0; half < 2; ++half) {
        vst::tma_load_2d(st + half * kPanel, ma, bar, i0 + 64 * half, m0);
        vst::tma_load_2d(st + (2 + half) * kPanel, mb, bar, j0 + 64 * half, m0);
      }
    }
    return;
  }

  // consumers
  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[16][4];
  zero_acc(acc);
  for (int it = 0; it < n; ++it) {
    const int s = it % kWStages;
    vst::mbar_wait(full + 8 * s, (it / kWStages) & 1);
    const uint32_t st = base + s * kWStageBytes;
    vst::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      vst::wgmma_ss_n128_t<1, 1>(acc, vst::desc_mnmajor(st + wg * kPanel, kk, kPanel),
                                 vst::desc_mnmajor(st + 2 * kPanel, kk, kPanel),
                                 it > 0 || kk > 0);
    vst::wgmma_commit();
    if (it > 0) {
      vst::wgmma_wait<1>();
      release_stage(empty + 8 * ((it - 1) % kWStages), lane);
    }
  }
  vst::wgmma_wait<0>();
  vst::fence_acc(acc);
  if (n > 0) release_stage(empty + 8 * ((n - 1) % kWStages), lane);

  float* out = job.ws + (long long)blockIdx.y * job.Ma * job.Nb;
  const int i = i0 + 64 * wg + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(out + (long long)i * job.Nb + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (long long)(i + 8) * job.Nb + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// ---- pass 3 ---------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf from_f<bf>(float x) { return __float2bfloat16_rn(x); }

constexpr int kSumCols = 32;       // columns a block of the sums
constexpr int kSumMaxLanes = 32;   // threads sharing one column's parts, at most

// out[i] = round_T(sum over s < S of parts[s * count + i]) in a fixed
// order: with L = blockDim.y lanes (a function of S alone), thread y of
// column i adds parts y, y + L, y + 2 L, ... in order, then the L partial
// sums are added in order of y. Grid ceil(count / 32), 32 x L threads;
// neighbouring threads read neighbouring columns.
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumMaxLanes)
ffn_sum_parts_kernel(const float* __restrict__ parts, int S, long long count,
                     T* __restrict__ out) {
  __shared__ float part[kSumMaxLanes][kSumCols];
  const int lanes = blockDim.y;
  const long long i = (long long)blockIdx.x * kSumCols + threadIdx.x;
  float s = 0.f;
  if (i < count) {
#pragma unroll 8
    for (int k = threadIdx.y; k < S; k += lanes) s += parts[k * count + i];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || i >= count) return;
  float total = part[0][threadIdx.x];
  for (int y = 1; y < lanes; ++y) total += part[y][threadIdx.x];
  out[i] = from_f<T>(total);
}

// ---- f32: plain FMA kernels -------------------------------------------------

constexpr int kF32Rows = 64;      // rows a block
constexpr int kF32Threads = 256;
constexpr int kF32F = 16;         // hidden units a step
constexpr int kF32Panel = 64;     // columns of x, dy and the weights staged at a time
constexpr int kF32Resident = 256; // up to this D the block's x and dy rows stay staged
constexpr int kTile = 64;         // output tile edge of the f32 pass 2

// Row stride of the staged x and dy, in floats: all of D when they stay,
// else a panel; odd, so that the threads' row reads fall on distinct banks.
inline int f32_x_stride(int D) { return (D <= kF32Resident ? D : kF32Panel) + 1; }

inline size_t f32_rows_smem(int D, int XC) {
  return (2 * kF32Rows * f32_x_stride(D) + 2 * kF32F * kF32Panel + kF32Rows * (kF32F + 1) +
          kF32F * XC) * sizeof(float);
}

// Grid (M / 64, D / XC), 256 threads; the f32 counterpart of pass 1. For
// the hidden step thread i computes row i % 64, units i / 64 + 4 j,
// summing over D in order; for dx it owns row i % 64, columns
// x0 + (i / 64) XC / 4 .. + XC / 4 - 1. Up to D = 256 the block's x and
// dy rows are staged once, above it one 64-column panel at a time. Column chunk 0 also writes h, dh and the db1 partials; every
// chunk writes its columns' db2 partials.
template <int XC>
__global__ void __launch_bounds__(kF32Threads)
ffn_bwd_rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                        const float* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ w2, float* __restrict__ dx,
                        float* __restrict__ hbuf, float* __restrict__ dhbuf,
                        float* __restrict__ pb1, float* __restrict__ pb2, int D, int F) {
  constexpr int HP = kF32F + 1, CW = XC / 4;
  const bool xres = D <= kF32Resident;
  const int XP = xres ? D + 1 : kF32Panel + 1;
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                          // x [64][D + 1] or a panel [64][65]
  float* dys = xs + kF32Rows * XP;          // dy, the same
  float* w1s = dys + kF32Rows * XP;         // W1[c, d0..] [16][64]
  float* w2c = w1s + kF32F * kF32Panel;     // W2[d0.., c]^T [16][64]
  float* dhs = w2c + kF32F * kF32Panel;     // dh32 [64][17]
  float* w1x = dhs + kF32Rows * HP;         // W1[c, x0..] [16][XC]

  const long long r0 = (long long)blockIdx.x * kF32Rows;
  const int x0 = blockIdx.y * XC;
  const bool first = blockIdx.y == 0;
  const int tid = threadIdx.x, row = tid % kF32Rows, grp = tid / kF32Rows;
  for (int c = tid; c < XC; c += kF32Threads) {
    float s = 0.f;
    for (int r = 0; r < kF32Rows; ++r) s += dy[(r0 + r) * D + x0 + c];
    pb2[(long long)blockIdx.x * D + x0 + c] = s;
  }
  const float* xr = xs + row * XP;
  const float* dyr = dys + row * XP;

  float acc[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < F; c0 += kF32F) {
    float s[kF32F / 4], ds[kF32F / 4];
#pragma unroll
    for (int jj = 0; jj < kF32F / 4; ++jj) s[jj] = ds[jj] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kF32Panel) {
      const int xc = xres ? d0 : 0;   // the panel's first column in xs, dys
      __syncthreads();
      if (!xres || c0 == 0)
        for (int i = tid; i < kF32Rows * kF32Panel; i += kF32Threads) {
          const long long off = (r0 + i / kF32Panel) * D + d0 + i % kF32Panel;
          xs[(i / kF32Panel) * XP + xc + i % kF32Panel] = x[off];
          dys[(i / kF32Panel) * XP + xc + i % kF32Panel] = dy[off];
        }
      for (int i = tid; i < kF32F * kF32Panel; i += kF32Threads) {
        const int j = i / kF32Panel, d = i % kF32Panel;
        w1s[i] = w1[(long long)(c0 + j) * D + d0 + d];
        w2c[i] = w2[(long long)(d0 + d) * F + c0 + j];
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kF32F / 4; ++jj) {
        const float* wr = w1s + (grp + 4 * jj) * kF32Panel;
        const float* vr = w2c + (grp + 4 * jj) * kF32Panel;
#pragma unroll 16
        for (int d = 0; d < kF32Panel; ++d) {
          s[jj] = fmaf(xr[xc + d], wr[d], s[jj]);
          ds[jj] = fmaf(dyr[xc + d], vr[d], ds[jj]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kF32F / 4; ++jj) {
      const int j = grp + 4 * jj;
      const float h = fmaxf(s[jj] + b1[c0 + j], 0.f);
      const float d = h > 0.f ? ds[jj] : 0.f;
      dhs[row * HP + j] = d;
      if (first) {
        hbuf[(r0 + row) * F + c0 + j] = h;
        dhbuf[(r0 + row) * F + c0 + j] = d;
      }
    }
    for (int i = tid; i < kF32F * XC; i += kF32Threads)
      w1x[i] = w1[(long long)(c0 + i / XC) * D + x0 + i % XC];
    __syncthreads();
    if (first && tid < kF32F) {
      float sum = 0.f;
      for (int r = 0; r < kF32Rows; ++r) sum += dhs[r * HP + tid];
      pb1[(long long)blockIdx.x * F + c0 + tid] = sum;
    }
#pragma unroll
    for (int j = 0; j < kF32F; ++j) {
      const float dv = dhs[row * HP + j];
#pragma unroll
      for (int i = 0; i < CW; ++i) acc[i] = fmaf(dv, w1x[j * XC + grp * CW + i], acc[i]);
    }
  }
  const long long off = (r0 + row) * D + x0 + grp * CW;
#pragma unroll
  for (int i = 0; i < CW; ++i) dx[off + i] = acc[i] + dy[off + i];
}

// The f32 counterpart of pass 2: C [Ma, Nb] = A^T B over the split's rows,
// A [M, Ma] and B [M, Nb] row-major, into ws[split][Ma][Nb]. Grid (Ma / 64
// * Nb / 64, splits), 256 threads, each a 4 x 4 block of the 64 x 64
// tile, 16 rows of A and B staged at a time.
__global__ void __launch_bounds__(kF32Threads)
ffn_wgrad_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ ws, long long M, int Ma, int Nb,
                     long long rows_per_split) {
  __shared__ __align__(16) float as[16][kTile];
  __shared__ __align__(16) float bs[16][kTile];
  const int ntn = Nb / kTile;
  const int m0 = (blockIdx.x / ntn) * kTile, n0 = (blockIdx.x % ntn) * kTile;
  const long long rbeg = (long long)blockIdx.y * rows_per_split;
  const long long rend = min(M, rbeg + rows_per_split);
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long rb = rbeg; rb < rend; rb += 16) {
    __syncthreads();
    for (int i = tid; i < 16 * kTile; i += kF32Threads) {
      const int r = i / kTile, c = i % kTile;
      as[r][c] = A[(rb + r) * Ma + m0 + c];
      bs[r][c] = B[(rb + r) * Nb + n0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(as[r][tm * 4 + i], bs[r][tn * 4 + j], acc[i][j]);
  }
  float* out = ws + (long long)blockIdx.y * Ma * Nb;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(long long)(m0 + tm * 4 + i) * Nb + n0 + tn * 4 + j] = acc[i][j];
}

template <typename T>
cudaError_t sum_parts(const float* parts, int S, long long count, void* out, cudaStream_t st) {
  // many parts (the db1 / db2 row blocks): 32 lanes a column; few (the
  // weight-gradient splits): 8
  const int lanes = S >= 256 ? kSumMaxLanes : 8;
  ffn_sum_parts_kernel<T><<<static_cast<unsigned>((count + kSumCols - 1) / kSumCols),
                            dim3(kSumCols, lanes), 0, st>>>(parts, S, count,
                                                            static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t sum_all(const float* pb1, const float* pb2, const float* pw1, const float* pw2,
                    void* dw1, void* db1, void* dw2, void* db2, long long M, int D, int F,
                    int S, cudaStream_t st) {
  const int nparts = static_cast<int>(M / kPartRows);
  cudaError_t err;
  if ((err = sum_parts<T>(pw1, S, (long long)F * D, dw1, st)) != cudaSuccess) return err;
  if ((err = sum_parts<T>(pw2, S, (long long)D * F, dw2, st)) != cudaSuccess) return err;
  if ((err = sum_parts<T>(pb1, nparts, F, db1, st)) != cudaSuccess) return err;
  return sum_parts<T>(pb2, nparts, D, db2, st);
}

template <int DC>
cudaError_t launch_rows_wgmma(const CUtensorMap& mx, const CUtensorMap& mdy,
                              const CUtensorMap& mw1, const CUtensorMap& mw2,
                              const CUtensorMap& mdx, const void* dy,
                              const void* b1, void* dx, void* hbuf, void* dhbuf, float* pb1,
                              float* pb2, long long M, int D, int F, cudaStream_t st) {
  const RowsLayout L = rows_layout(D, DC);
  const cudaError_t err = vst::allow_smem(ffn_bwd_rows_wgmma_kernel<DC>, L.bytes);
  if (err != cudaSuccess) return err;
  ffn_bwd_rows_wgmma_kernel<DC><<<dim3(static_cast<unsigned>(M / kBM), D / DC), kThreads,
                                  L.bytes, st>>>(
      mx, mdy, mw1, mw2, mdx, static_cast<const bf*>(dy), static_cast<const bf*>(b1),
      static_cast<bf*>(dx), static_cast<bf*>(hbuf), static_cast<bf*>(dhbuf), pb1, pb2, D, F, L);
  return cudaGetLastError();
}

cudaError_t launch_bwd_bf16(const void* x, const void* dy, const void* w1, const void* b1,
                            const void* w2, void* dx, void* dw1, void* db1, void* dw2,
                            void* db2, void* hbuf, void* dhbuf, float* pb1, float* pb2,
                            float* pw1, float* pw2, long long M, int D, int F, int S,
                            cudaStream_t st) {
  CUtensorMap mx, mdy, mw1, mw2, mdx, mh, mdh;
  if (!vst::matrix_tensor_map(&mx, x, M, D) || !vst::matrix_tensor_map(&mdy, dy, M, D) ||
      !vst::matrix_tensor_map(&mw1, w1, F, D) || !vst::matrix_tensor_map(&mw2, w2, D, F) ||
      !vst::matrix_tensor_map(&mdx, dx, M, D) || !vst::matrix_tensor_map(&mh, hbuf, M, F) ||
      !vst::matrix_tensor_map(&mdh, dhbuf, M, F))
    return cudaErrorInvalidValue;
  cudaError_t err =
      D % 256 == 0
          ? launch_rows_wgmma<256>(mx, mdy, mw1, mw2, mdx, dy, b1, dx, hbuf, dhbuf, pb1, pb2, M, D,
                                   F, st)
          : launch_rows_wgmma<128>(mx, mdy, mw1, mw2, mdx, dy, b1, dx, hbuf, dhbuf, pb1, pb2, M, D,
                                   F, st);
  if (err != cudaSuccess) return err;
  // dW1 [F, D] = dh^T x,  dW2 [D, F] = dy^T h
  if ((err = vst::allow_smem(ffn_wgrad_wgmma_kernel, kWgradSmem)) != cudaSuccess) return err;
  const long long per_split = ((M / kWStep + S - 1) / S) * kWStep;
  const int tiles = 2 * (F / kWTile) * (D / kWTile);
  ffn_wgrad_wgmma_kernel<<<dim3(tiles, S), kThreads, kWgradSmem, st>>>(
      mdh, mx, mdy, mh, WgradJob{pw1, F, D}, WgradJob{pw2, D, F}, M, per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_all<bf>(pb1, pb2, pw1, pw2, dw1, db1, dw2, db2, M, D, F, S, st);
}

template <int XC>
cudaError_t launch_rows_f32(const float* x, const float* dy, const float* w1, const float* b1,
                            const float* w2, void* dx, float* hbuf, float* dhbuf, float* pb1,
                            float* pb2, long long M, int D, int F, cudaStream_t st) {
  const size_t smem = f32_rows_smem(D, XC);
  const cudaError_t err = vst::allow_smem(ffn_bwd_rows_f32_kernel<XC>, smem);
  if (err != cudaSuccess) return err;
  ffn_bwd_rows_f32_kernel<XC><<<dim3(static_cast<unsigned>(M / kF32Rows), D / XC), kF32Threads,
                                smem, st>>>(x, dy, w1, b1, w2, static_cast<float*>(dx), hbuf,
                                            dhbuf, pb1, pb2, D, F);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32(const float* x, const float* dy, const float* w1, const float* b1,
                           const float* w2, void* dx, void* dw1, void* db1, void* dw2, void* db2,
                           float* hbuf, float* dhbuf, float* pb1, float* pb2, float* pw1,
                           float* pw2, long long M, int D, int F, int S, cudaStream_t st) {
  cudaError_t err = D % 256 == 0
                        ? launch_rows_f32<256>(x, dy, w1, b1, w2, dx, hbuf, dhbuf, pb1, pb2, M, D,
                                               F, st)
                        : launch_rows_f32<128>(x, dy, w1, b1, w2, dx, hbuf, dhbuf, pb1, pb2, M, D,
                                               F, st);
  if (err != cudaSuccess) return err;
  const long long per_split = ((M / kTile + S - 1) / S) * kTile;
  ffn_wgrad_f32_kernel<<<dim3(F / kTile * (D / kTile), S), kF32Threads, 0, st>>>(dhbuf, x, pw1,
                                                                                 M, F, D, per_split);
  ffn_wgrad_f32_kernel<<<dim3(D / kTile * (F / kTile), S), kF32Threads, 0, st>>>(dy, hbuf, pw2,
                                                                                 M, D, F, per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_all<float>(pb1, pb2, pw1, pw2, dw1, db1, dw2, db2, M, D, F, S, st);
}

}  // namespace

// x, dy, dx: [M, D]; w1, dw1: [F, D]; b1, db1: [F]; w2, dw2: [D, F]; db2:
// [D]; hbuf, dhbuf (scratch): [M, F]; all contiguous, one dtype (bf16 if
// is_bf16, else f32), 16-byte aligned. pb1 [M / 64, F], pb2 [M / 64, D],
// pw1 [S, F, D], pw2 [S, D, F]: f32 scratch. M % 128 == 0, D % 128 == 0,
// F % 128 == 0, S >= 1 (cudaErrorInvalidValue otherwise). Launches the
// three passes in order on `stream`; returns the first launch error, or
// cudaGetLastError() after the last launch.
extern "C" int vst_ffn_bwd(int is_bf16, const void* x, const void* dy, const void* w1,
                           const void* b1, const void* w2, void* dx, void* dw1, void* db1,
                           void* dw2, void* db2, void* hbuf, void* dhbuf, void* pb1,
                           void* pb2, void* pw1, void* pw2, long long M, int D, int F, int S,
                           void* stream) {
  if (M % kBM || D % 128 || F % 128 || M <= 0 || D <= 0 || F <= 0 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *p1 = static_cast<float*>(pb1), *p2 = static_cast<float*>(pb2);
  float *q1 = static_cast<float*>(pw1), *q2 = static_cast<float*>(pw2);
  const cudaError_t err =
      is_bf16 ? launch_bwd_bf16(x, dy, w1, b1, w2, dx, dw1, db1, dw2, db2, hbuf, dhbuf, p1, p2,
                                q1, q2, M, D, F, S, st)
              : launch_bwd_f32(static_cast<const float*>(x), static_cast<const float*>(dy),
                               static_cast<const float*>(w1), static_cast<const float*>(b1),
                               static_cast<const float*>(w2), dx, dw1, db1, dw2, db2,
                               static_cast<float*>(hbuf), static_cast<float*>(dhbuf), p1, p2, q1,
                               q2, M, D, F, S, st);
  return static_cast<int>(err);
}
