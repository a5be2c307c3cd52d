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
// f32 inputs (mixed_precision: false): split-TF32 mma.sync kernels of the
// same three-pass shape (ffn_fwd.cu's arithmetic and what bounds it: the
// tensor cores at 3 x 10 M D F TF32 operations, 1.04 ms at M = 131072,
// D = 256, F = 512; below them the issue of each product step's adds,
// splits and shared-memory reads). Pass 1: blocks of 64 rows and XC
// columns of dx (all of D up to 256, x and dy resident; else 128- or
// 256-column chunks, x and dy streamed in 128-column panels), 8 warps in
// pairs over a 16-row tile. For each 16-unit hidden chunk the h warp
// computes h32 = relu(x W1[c]^T + b1) through the forward's h_panel (the
// same steps in the same order: the forward's h32 bit for bit) while the
// dh warp computes dy W2[:, c] (W2 read row by row); the h warp hands the
// ReLU mask bits over, the dh warp the masked dh32 back, and both add dh
// W1[c] to their halves of dx (dh as A fragments). Column chunk 0 writes h
// and dh for pass 2 and takes the db1 and db2 partials from what the
// block holds: the dh warps' column sums of dh32 from their registers,
// dy's columns from shared memory. Pass 2: 128 x 128 output tiles, 8 warps
// of 32 x 64, both operands read down their rows from a 4-stage cp.async
// ring of 32 rows (a_from_kn), each B fragment split once for two row
// tiles; a split sums at most 2048 rows (ops/ffn.py:wgrad_splits), which
// keeps dW1 and dW2 closer to float64 than the plain version at M =
// 131072.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "ffn_tf32.cuh"
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

// ---- f32: split-TF32 mma.sync kernels ------------------------------------------

using vst::ffn32::kHC;
using vst::ffn32::kHT;
using vst::ffn32::kW2LD;

constexpr int kRowsTiles = 4;                  // f32 pass 1: row tiles of 16 a block
constexpr int kRowsBM = 16 * kRowsTiles;       // rows a block
constexpr int kRowsThreads = 2 * kRowsTiles * 32;
static_assert(kRowsBM == kPartRows, "one row of db1 / db2 partials a block");

// Pass 1's shared memory in floats: x's and dy's resident rows [64][D + 4]
// each (D <= 256); two stages of the ring, each a W1 panel [16][kp + 4]
// and a W2 panel [kp][kHC + 8] (then x's and dy's panels [64][kp + 4]
// where they stream); where they stream, two stages of W1[c, x0 .. x0 +
// XC] ([16][XC + 4]); the exchange of the h and dh warps (the mask bits,
// [4][32], and dh, [4][32][8]) and the db1 column sums [4][16].
struct Tf32RowsLayout {
  int xres, kp, P, ld, s_floats, c_floats;
  int s0, c0, xmask, xdh, red;
  size_t bytes;
};

inline Tf32RowsLayout tf32_rows_layout(int D, int XC) {
  Tf32RowsLayout L{};
  L.xres = D <= vst::ffn32::kResident;
  L.kp = L.xres ? D : vst::ffn32::kKP;
  L.P = D / L.kp;
  L.ld = vst::ffn32::panel_ld(L.kp);
  L.s_floats = kHC * L.ld + L.kp * kW2LD + (L.xres ? 0 : 2 * kRowsBM * L.ld);
  L.c_floats = L.xres ? 0 : kHC * (XC + 4);
  L.s0 = L.xres ? 2 * kRowsBM * L.ld : 0;
  L.c0 = L.s0 + 2 * L.s_floats;
  L.xmask = L.c0 + 2 * L.c_floats;
  L.xdh = L.xmask + kRowsTiles * 32;
  L.red = L.xdh + kRowsTiles * 32 * 4 * kHT;
  L.bytes = static_cast<size_t>(L.red + kRowsTiles * kHC) * sizeof(float);
  return L;
}

// Grid (M / 64, D / XC), 256 threads. Warp w works on the rows 16 (w % 4)
// .. + 15 of the block's 64 and on half s = w / 4 of the block's XC
// columns of dx; for each hidden chunk c of 16 units the h warps (s = 0)
// compute h32 = relu(x W1[c]^T + b1) through the forward's h_panel while
// the dh warps (s = 1) compute dy W2[:, c] over the same staged panels.
// Then the h warps hand their ReLU mask bits to the dh warps, which mask
// dh32 and hand it back, each lane to the same lane of its partner (the
// accumulator layouts match, so nothing is rearranged), and both warps add
// dh W1[c, their columns] to dx (dh as A fragments in a_from_acc's order).
// The cp.async ring's items, one __syncthreads each as in the forward:
// for each chunk the P panels of W1[c] and W2[:, c] (with x's and dy's
// where they stream) and, where they stream, W1[c, x0 .. x0 + XC]; with x
// and dy resident (D <= 256, then XC = D) the W1 panel is read K-major for
// h and row by row for dx. Column chunk 0 also writes h and dh for pass 2,
// the db1 partials (the dh warps' column sums of dh32 added in warp
// order) and the db2 partials (dy's staged columns summed in row order).
template <int XC>
__global__ void __launch_bounds__(kRowsThreads, 1)
ffn_bwd_rows_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ w2, float* __restrict__ dx,
                         float* __restrict__ hbuf, float* __restrict__ dhbuf,
                         float* __restrict__ pb1, float* __restrict__ pb2, int D, int F,
                         Tf32RowsLayout L) {
  constexpr int HX = XC / 2, NX = HX / 8;
  extern __shared__ __align__(16) float tsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, tile = warp % kRowsTiles, s = warp / kRowsTiles;
  const int rw = 16 * tile;
  const long long r0 = (long long)blockIdx.x * kRowsBM, row = r0 + rw + g;   // and row + 8
  const int x0 = blockIdx.y * XC;
  const bool first = blockIdx.y == 0;
  const int P = L.P, kp = L.kp, ld = L.ld;
  const int per = P + (L.xres ? 0 : 1), n = (F / kHC) * per;
  const float* xrow = tsm;
  const float* dyrow = tsm + kRowsBM * ld;
  uint32_t* xmask = reinterpret_cast<uint32_t*>(tsm + L.xmask) + tile * 32 + lane;
  float4* xdh = reinterpret_cast<float4*>(tsm + L.xdh) + (tile * 32 + lane) * kHT;
  float* red = tsm + L.red;

  auto issue = [&](int i) {
    const int c = i / per, q = i - c * per;
    if (q < P) {
      float* st = tsm + L.s0 + ((c * P + q) & 1) * L.s_floats;
      float* w2s = st + kHC * ld;
      vst::ffn32::cp_tile(st, ld, w1 + (long long)c * kHC * D + q * kp, D, kHC, kp, tid,
                          kRowsThreads);
      vst::ffn32::cp_tile(w2s, kW2LD, w2 + (long long)q * kp * F + c * kHC, F, kp, kHC, tid,
                          kRowsThreads);
      if (!L.xres) {
        float* xs = w2s + kp * kW2LD;
        vst::ffn32::cp_tile(xs, ld, x + r0 * D + q * kp, D, kRowsBM, kp, tid, kRowsThreads);
        vst::ffn32::cp_tile(xs + kRowsBM * ld, ld, dy + r0 * D + q * kp, D, kRowsBM, kp, tid,
                            kRowsThreads);
      }
    } else {
      vst::ffn32::cp_tile(tsm + L.c0 + (c & 1) * L.c_floats, XC + 4,
                          w1 + (long long)c * kHC * D + x0, D, kHC, XC, tid, kRowsThreads);
    }
  };
  if (L.xres) {
    vst::ffn32::cp_tile(tsm, ld, x + r0 * D, D, kRowsBM, D, tid, kRowsThreads);
    vst::ffn32::cp_tile(tsm + kRowsBM * ld, ld, dy + r0 * D, D, kRowsBM, D, tid, kRowsThreads);
  }
  issue(0);
  vst::cp_async_commit();

  float dxacc[NX][4];
#pragma unroll
  for (int j = 0; j < NX; ++j) dxacc[j][0] = dxacc[j][1] = dxacc[j][2] = dxacc[j][3] = 0.f;
  float acc[kHT][4];   // h32 (s = 0) or dy W2[:, c] (s = 1), then dh32 in both

  // dx[:, this warp's half] += dh W1[c, ..], W1's rows from a [16][ldw] tile
  auto dx_product = [&](const float* w1t, int ldw) {
#pragma unroll
    for (int kc = 0; kc < kHT; ++kc) {
      const vst::SplitA fa = vst::a_from_acc(acc[kc]);
#pragma unroll
      for (int j = 0; j < NX; ++j)
        vst::mma_b_rows(dxacc[j], fa, w1t, ldw, 8 * kc, s * HX + 8 * j, g, t, 1.f);
    }
  };

  for (int i = 0; i < n; ++i) {
    vst::cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n) {
      issue(i + 1);
      vst::cp_async_commit();
    }
    const int c = i / per, p = i - c * per;
    if (p == P) {
      dx_product(tsm + L.c0 + (c & 1) * L.c_floats, XC + 4);
      continue;
    }
    const float* st = tsm + L.s0 + ((c * P + p) & 1) * L.s_floats;
    const float* w2s = st + kHC * ld;
    const float* xs = L.xres ? xrow : w2s + kp * kW2LD;
    const float* dys = xs + kRowsBM * ld;
    if (p == 0) {
#pragma unroll
      for (int j = 0; j < kHT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    if (s == 0) {
      vst::ffn32::h_panel(acc, xs, st, ld, rw, kp, g, t);
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kp / 8; ++kk) {
        const vst::SplitA a = vst::a_from_smem(dys, ld, rw, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < kHT; ++j) vst::mma_b_kn(acc[j], a, w2s, kW2LD, 8 * kk, 8 * j, g, t);
      }
    }
    if (c == 0 && first)   // db2 partials: dy's staged columns over the 64 rows,
                           // rows r = k (mod 8) summed in order, then the 8 pairwise
      for (int col = tid; col < kp; col += kRowsThreads) {
        float sum[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          sum[k] = dys[k * ld + col];
#pragma unroll
          for (int r = k + 8; r < kRowsBM; r += 8) sum[k] += dys[r * ld + col];
        }
        pb2[blockIdx.x * (long long)D + p * kp + col] =
            ((sum[0] + sum[1]) + (sum[2] + sum[3])) + ((sum[4] + sum[5]) + (sum[6] + sum[7]));
      }
    if (p < P - 1) continue;

    // the exchange: the mask bits to the dh warps, dh32 back
    if (s == 0) {
      // h32 = relu(acc + b1): bit 4 kc + e for value e of n-tile kc
      uint32_t mask = 0;
#pragma unroll
      for (int kc = 0; kc < kHT; ++kc) {
        const int col = c * kHC + 8 * kc + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
        const float h0 = fmaxf(acc[kc][0] + bb.x, 0.f), h1 = fmaxf(acc[kc][1] + bb.y, 0.f);
        const float h2 = fmaxf(acc[kc][2] + bb.x, 0.f), h3 = fmaxf(acc[kc][3] + bb.y, 0.f);
        mask |= (uint32_t(h0 > 0.f) | uint32_t(h1 > 0.f) << 1 | uint32_t(h2 > 0.f) << 2 |
                 uint32_t(h3 > 0.f) << 3) << (4 * kc);
        if (first) {
          *reinterpret_cast<float2*>(hbuf + row * F + col) = make_float2(h0, h1);
          *reinterpret_cast<float2*>(hbuf + (row + 8) * F + col) = make_float2(h2, h3);
        }
      }
      *xmask = mask;
    }
    __syncthreads();
    if (s == 1) {
      const uint32_t mask = *xmask;
#pragma unroll
      for (int kc = 0; kc < kHT; ++kc) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!((mask >> (4 * kc + e)) & 1u)) acc[kc][e] = 0.f;
        xdh[kc] = make_float4(acc[kc][0], acc[kc][1], acc[kc][2], acc[kc][3]);
        if (first) {
          const int col = c * kHC + 8 * kc + 2 * t;
          *reinterpret_cast<float2*>(dhbuf + row * F + col) = make_float2(acc[kc][0], acc[kc][1]);
          *reinterpret_cast<float2*>(dhbuf + (row + 8) * F + col) =
              make_float2(acc[kc][2], acc[kc][3]);
          float s0 = acc[kc][0] + acc[kc][2], s1 = acc[kc][1] + acc[kc][3];
          warp_colsum(s0, s1);
          if (g == 0) {
            red[tile * kHC + 8 * kc + 2 * t] = s0;
            red[tile * kHC + 8 * kc + 2 * t + 1] = s1;
          }
        }
      }
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int kc = 0; kc < kHT; ++kc) {
        const float4 v = xdh[kc];
        acc[kc][0] = v.x;
        acc[kc][1] = v.y;
        acc[kc][2] = v.z;
        acc[kc][3] = v.w;
      }
    }
    if (first && tid < kHC)
      pb1[blockIdx.x * (long long)F + c * kHC + tid] =
          ((red[tid] + red[kHC + tid]) + red[2 * kHC + tid]) + red[3 * kHC + tid];
    if (L.xres) dx_product(st, ld);
  }

  // dx = dh W1^T + dy
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int col = x0 + s * HX + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long off = (row + 8 * half) * D + col;
      const float2 gv = L.xres
                            ? *reinterpret_cast<const float2*>(dyrow + (rw + g + 8 * half) * ld + col)
                            : *reinterpret_cast<const float2*>(dy + off);
      *reinterpret_cast<float2*>(dx + off) =
          make_float2(dxacc[j][2 * half] + gv.x, dxacc[j][2 * half + 1] + gv.y);
    }
  }
}

// Pass 2 in f32: C [Ma, Nb] = A^T B over the split's rows, A [M, Ma] and
// B [M, Nb] row-major, into ws[split][Ma][Nb].
struct WgradJob32 {
  const float* a;
  const float* b;
  float* ws;
  int Ma, Nb;
};

constexpr int kWgTile = 128;              // output tile edge
constexpr int kWgRows = 32;               // rows of A and B a ring stage
constexpr int kWgStages = 4;
constexpr int kWgLD = kWgTile + 8;        // 8 (mod 32): a_from_kn, the B reads
constexpr int kWgThreads = 256;
constexpr size_t kWgSmem = static_cast<size_t>(kWgStages) * 2 * kWgRows * kWgLD * sizeof(float);

// Grid (tiles of job 0 + tiles of job 1, splits), 256 threads. Block x
// names a 128 x 128 output tile, block y the split of the rows [y
// rows_per_split, + rows_per_split); warp w owns output rows
// 32 (w / 2) .. + 31 and columns 64 (w % 2) .. + 63 (2 x 8 accumulator
// tiles). A and B stream through a 4-stage cp.async ring of 32 rows each,
// both read down their rows (a_from_kn, B row by row): no transposing
// copy. Each B fragment is split once for the warp's two row tiles.
__global__ void __launch_bounds__(kWgThreads, 1)
ffn_wgrad_tf32_kernel(WgradJob32 job0, WgradJob32 job1, long long M, long long rows_per_split) {
  extern __shared__ __align__(16) float tsm[];
  const int tiles0 = (job0.Ma / kWgTile) * (job0.Nb / kWgTile);
  const bool second = blockIdx.x >= tiles0;
  const WgradJob32 job = second ? job1 : job0;
  const int tile = second ? blockIdx.x - tiles0 : blockIdx.x;
  const int ntn = job.Nb / kWgTile;
  const int i0 = (tile / ntn) * kWgTile, j0 = (tile % ntn) * kWgTile;
  const long long rbeg = (long long)blockIdx.y * rows_per_split;
  const long long rend = min(M, rbeg + rows_per_split);
  const int n = rend > rbeg ? static_cast<int>((rend - rbeg) / kWgRows) : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wi = (warp >> 1) * 32, wj = (warp & 1) * 64;

  auto issue = [&](int it) {
    float* st = tsm + (it % kWgStages) * 2 * kWgRows * kWgLD;
    const long long m0 = rbeg + (long long)it * kWgRows;
    vst::ffn32::cp_tile(st, kWgLD, job.a + m0 * job.Ma + i0, job.Ma, kWgRows, kWgTile, tid,
                        kWgThreads);
    vst::ffn32::cp_tile(st + kWgRows * kWgLD, kWgLD, job.b + m0 * job.Nb + j0, job.Nb, kWgRows,
                        kWgTile, tid, kWgThreads);
  };
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < n) issue(s);
    vst::cp_async_commit();
  }

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  for (int it = 0; it < n; ++it) {
    vst::cp_async_wait<kWgStages - 2>();
    __syncthreads();
    if (it + kWgStages - 1 < n) issue(it + kWgStages - 1);
    vst::cp_async_commit();
    const float* as = tsm + (it % kWgStages) * 2 * kWgRows * kWgLD;
    const float* bs = as + kWgRows * kWgLD;
#pragma unroll
    for (int kk = 0; kk < kWgRows / 8; ++kk) {
      vst::SplitA fa[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) fa[mi] = vst::a_from_kn(as, kWgLD, 8 * kk, wi + 16 * mi, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* p = bs + (8 * kk + t) * kWgLD + wj + 8 * j + g;
        uint32_t bb0, bb1, bs0, bs1;
        vst::split_tf32(p[0], bb0, bs0);
        vst::split_tf32(p[4 * kWgLD], bb1, bs1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) vst::mma_3xtf32(acc[mi][j], fa[mi], bb0, bb1, bs0, bs1);
      }
    }
  }

  float* out = job.ws + (long long)blockIdx.y * job.Ma * job.Nb;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = i0 + wi + 16 * mi + g;
      const int col = j0 + wj + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + i * job.Nb + col) = make_float2(acc[mi][j][0], acc[mi][j][1]);
      *reinterpret_cast<float2*>(out + (i + 8) * job.Nb + col) =
          make_float2(acc[mi][j][2], acc[mi][j][3]);
    }
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
cudaError_t launch_rows_tf32(const float* x, const float* dy, const float* w1, const float* b1,
                             const float* w2, void* dx, float* hbuf, float* dhbuf, float* pb1,
                             float* pb2, long long M, int D, int F, cudaStream_t st) {
  const Tf32RowsLayout L = tf32_rows_layout(D, XC);
  const cudaError_t err = vst::allow_smem(ffn_bwd_rows_tf32_kernel<XC>, L.bytes);
  if (err != cudaSuccess) return err;
  ffn_bwd_rows_tf32_kernel<XC><<<dim3(static_cast<unsigned>(M / kRowsBM), D / XC),
                                 kRowsThreads, L.bytes, st>>>(
      x, dy, w1, b1, w2, static_cast<float*>(dx), hbuf, dhbuf, pb1, pb2, D, F, L);
  return cudaGetLastError();
}

cudaError_t launch_bwd_tf32(const float* x, const float* dy, const float* w1, const float* b1,
                            const float* w2, void* dx, void* dw1, void* db1, void* dw2,
                            void* db2, float* hbuf, float* dhbuf, float* pb1, float* pb2,
                            float* pw1, float* pw2, long long M, int D, int F, int S,
                            cudaStream_t st) {
  cudaError_t err = D % 256 == 0
                        ? launch_rows_tf32<256>(x, dy, w1, b1, w2, dx, hbuf, dhbuf, pb1, pb2, M,
                                                D, F, st)
                        : launch_rows_tf32<128>(x, dy, w1, b1, w2, dx, hbuf, dhbuf, pb1, pb2, M,
                                                D, F, st);
  if (err != cudaSuccess) return err;
  // dW1 [F, D] = dh^T x,  dW2 [D, F] = dy^T h
  if ((err = vst::allow_smem(ffn_wgrad_tf32_kernel, kWgSmem)) != cudaSuccess) return err;
  const long long per_split = ((M / kPartRows + S - 1) / S) * kPartRows;
  const int tiles = 2 * (F / kWgTile) * (D / kWgTile);
  ffn_wgrad_tf32_kernel<<<dim3(tiles, S), kWgThreads, kWgSmem, st>>>(
      WgradJob32{dhbuf, x, pw1, F, D}, WgradJob32{dy, hbuf, pw2, D, F}, M, per_split);
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
              : launch_bwd_tf32(static_cast<const float*>(x), static_cast<const float*>(dy),
                               static_cast<const float*>(w1), static_cast<const float*>(b1),
                               static_cast<const float*>(w2), dx, dw1, db1, dw2, db2,
                               static_cast<float*>(hbuf), static_cast<float*>(dhbuf), p1, p2, q1,
                               q2, M, D, F, S, st);
  return static_cast<int>(err);
}
