// Fused transformer FFN forward for Hopper (sm_90a):
//   y = x + relu(x W1 + b1) W2 + b2
// over x [M, D] (contiguous rows), M % 128 == 0, D % 128 == 0 and hidden
// width F % 128 == 0: every shape the JAX package's gate (`fused_ffn_ok`)
// accepts.
//
// Replaces: vae_song_tpu/ops/ffn.py:_ffn_fwd_kernel (K6f, called through
// _call_fwd). Same function and roundings (ffn.py:86-101), cd the input
// dtype:
//   h = round_cd(relu(x W1 + b1))   f32 accumulation, the bias added in
//                                   f32, one rounding
//   y = (round_cd(h W2) + b2) + x   two adds in cd, left to right
// (the unfused Dense path rounds x W1 before adding b1; this does not).
//
// Weights come in the port's Dense layout: w1 = ff_up.weight [F, D]
// (W1 transposed, so its rows are W1's columns) and w2 = ff_down.weight
// [D, F]; no transposed copy is made.
//
// What bounds it here: the TPU kernel keeps both weight matrices resident
// in VMEM (0.5 MB in bf16 at D = 256, F = 512) while x streams by; one SM
// has 227 KB, so the weights stream instead. At M = 131072, D = 256,
// F = 512 one call is 4 M D F = 6.9e10 flop against 134 MB of x / y
// traffic (514 flop a byte, above the H100's ~295): the tensor cores bound
// it (0.070 ms at 989 TFLOP/s). Every 128-row block also reads the 0.5 MB
// of weights from L2 (0.54 GB in all), the next limit.
//
// bf16: a warp-specialised wgmma kernel (sm90.cuh). A block owns 128 rows
// (two consumer warpgroups of 64) and YC output columns (all of D up to
// 256; else column chunks of 256 or 128, each block recomputing h over
// the whole of D). One producer thread issues TMA loads of 64 x 64
// swizzled panels: x (resident for the whole block when D <= 256, else
// streamed with the W1 panels), and through two mbarrier rings W1[64c..,
// 64p..] (one 64-deep k-step panel of the h product) and W2[y0.., 64c..]
// (the y product's B for hidden chunk c). For each 64-wide hidden chunk c
// a warpgroup computes h = x W1[:, c] as K-major SS wgmma over D, adds b1,
// applies ReLU and rounds in registers, in the accumulator layout, which
// is the A fragment layout of y += h W2[c, :] (register-A wgmma, W2 read
// K-major). y stays in f32 registers at the block's full width (YC / 2 a
// thread). The two warpgroups run apart, so one's epilogue overlaps the
// other's products. Only x, the weights and y touch device memory; with x
// resident, y is written over it in shared memory and leaves by TMA
// stores of whole boxes.
//
// f32 inputs (mixed_precision: false): a split-TF32 mma.sync kernel
// (mma_tf32.cuh; TF32 wgmma reads only K-major operands, mma.sync any
// layout). Each f32 operand is split into big and small TF32 halves and
// each 8-deep step is three m16n8k8 products into a fresh accumulator
// (chained on a running sum, the tensor cores' rounding toward zero would
// bias it). At M = 131072, D = 256, F = 512 that is 3 x 6.9e10 TF32
// operations, 0.417 ms at 495 TFLOP/s (0.026 ms at M = 8192), against 1.03
// ms for 6.9e10 on the FMA units: the tensor cores bound it, but below
// them the instruction issue does: each product step (3 mma) also takes 4
// adds into the running sum, the splits of its operands (4 integer and
// float operations an element) and their shared-memory reads, about 7
// issue slots a product step in this kernel, and mma.sync does not reach
// wgmma's rate. The design spends what issue it can on the products: a
// block of 64 rows, 8 warps in pairs over a 16-row tile; for each 32-unit
// hidden chunk the pair splits h = relu(x W1[c]^T + b1) (16 units each, x
// read once a chunk from the block's resident rows, W1 read K-major), the
// two swap their halves of h through shared memory lane for lane (the
// accumulator layouts match) and each adds h W2[c]^T to its half of y's
// columns, h as the A fragments (a_from_acc's order, W2 read as float2
// pairs). The chunk's four steps are added into the first one's fresh
// accumulator before the one add to y; where a warp's y half is 64
// columns (YC = 128) the chunks go to two running sums, even and odd,
// added at the end (F / 64 adds deep each: closer to float64 than the
// plain version at F = 1536). W1 and W2 chunks come through two cp.async
// stages each, one __syncthreads an item; x stays resident up to D = 256
// and streams with the W1 panels (128 columns) above it. Only x, the
// weights and y touch device memory.

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

// ---- bf16: warp-specialised wgmma kernel -------------------------------------

constexpr int kThreads = 384;            // consumer warpgroups 0 and 1, producer 2
constexpr int kBM = 128;                 // rows a block
constexpr int kFC = 64;                  // hidden units a chunk
constexpr uint32_t kPanel = 64 * vst::kPanelRowBytes;   // 64 x 64 bf16 panel, 8 KB
constexpr int kConsumerWarps = 8;

// Shared memory, byte offsets from a 1024-byte aligned base: x's resident
// panels (P of 128 rows, two boxes each) when D <= 256, ring A (a W1
// panel, then x's panel of 128 rows when x streams), ring B (YC / 64 W2
// panels), the mbarriers (resident, full A[], empty A[], full B[],
// empty B[]).
struct FwdLayout {
  int P, xres, sa, sb;
  uint32_t a0, a_bytes, b0, b_bytes, bars;
  size_t bytes;
};

inline FwdLayout fwd_layout(int D, int YC) {
  FwdLayout L{};
  L.P = D / 64;
  L.xres = D <= 256;
  const uint32_t res = L.xres ? L.P * 2 * kPanel : 0;
  L.a0 = res;
  L.a_bytes = kPanel + (L.xres ? 0 : 2 * kPanel);
  L.b_bytes = (YC / 64) * kPanel;
  L.sa = 4;
  for (L.sb = 3; L.sb > 1; --L.sb)
    if (res + L.sa * L.a_bytes + L.sb * L.b_bytes <= 200 * 1024) break;
  L.b0 = L.a0 + L.sa * L.a_bytes;
  L.bars = L.b0 + L.sb * L.b_bytes;
  L.bytes = L.bars + 8 * (1 + 2 * L.sa + 2 * L.sb) + 1024;   // + alignment
  return L;
}

using vst::release_stage;
using vst::ring_wait_free;
using vst::zero_acc;

// Grid (M / 128, D / YC), 384 threads. Warpgroup w < 2 owns rows
// r0 + 64 w .. + 63, its warp i the 16 rows 16 i .. of those; in the
// accumulator layout lane = 4 g + t holds rows g and g + 8, columns
// 8 j + 2 t and 8 j + 2 t + 1 of each 8-column block j.
template <int YC>
__global__ void __launch_bounds__(kThreads, 1)
ffn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mw1,
                     const __grid_constant__ CUtensorMap mw2,
                     const __grid_constant__ CUtensorMap my, const bf* __restrict__ x,
                     const bf* __restrict__ b1, const bf* __restrict__ b2, bf* __restrict__ y,
                     int D, int F, FwdLayout L) {
  constexpr int NY = YC / 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = vst::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t res_bar = base + L.bars, full_a = res_bar + 8, empty_a = full_a + 8 * L.sa;
  const uint32_t full_b = empty_a + 8 * L.sa, empty_b = full_b + 8 * L.sb;
  const int r0 = blockIdx.x * kBM, y0 = blockIdx.y * YC;
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
    if (L.xres) {
      vst::mbar_arrive_expect_tx(res_bar, P * 2 * kPanel);
      for (int p = 0; p < P; ++p)
        for (int half = 0; half < 2; ++half)
          vst::tma_load_2d(base + (2 * p + half) * kPanel, &mx, res_bar, 64 * p, r0 + 64 * half);
    }
    int ia = 0, ib = 0;
    for (int c = 0; c < nc; ++c) {
      for (int p = 0; p < P; ++p, ++ia) {
        ring_wait_free(empty_a, ia, L.sa);
        const int s = ia % L.sa;
        const uint32_t st = base + L.a0 + s * L.a_bytes, bar = full_a + 8 * s;
        vst::mbar_arrive_expect_tx(bar, L.a_bytes);
        vst::tma_load_2d(st, &mw1, bar, 64 * p, kFC * c);
        if (!L.xres)
          for (int half = 0; half < 2; ++half)
            vst::tma_load_2d(st + (1 + half) * kPanel, &mx, bar, 64 * p, r0 + 64 * half);
      }
      ring_wait_free(empty_b, ib, L.sb);
      const int s = ib % L.sb;
      const uint32_t st = base + L.b0 + s * L.b_bytes, bar = full_b + 8 * s;
      vst::mbar_arrive_expect_tx(bar, L.b_bytes);
      for (int q = 0; q < YC / 64; ++q)
        vst::tma_load_2d(st + q * kPanel, &mw2, bar, kFC * c, y0 + 64 * q);
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
  float yacc[NY][16][4];
#pragma unroll
  for (int q = 0; q < NY; ++q) zero_acc(yacc[q]);
  float hacc[8][4];
  zero_acc(hacc);
  if (L.xres) vst::mbar_wait(res_bar, 0);

  // Issue h = x W1[:, c] over D, one commit group a 64-deep panel; once
  // a group is done, the stage it read is released (after the first
  // panel, `release_first` is released instead: the stage of the y
  // product issued just before).
  int ia = 0;
  auto issue_h = [&](uint32_t release_first) {
    for (int p = 0; p < P; ++p, ++ia) {
      const int s = ia % L.sa;
      vst::mbar_wait(full_a + 8 * s, (ia / L.sa) & 1);
      const uint32_t st = base + L.a0 + s * L.a_bytes;
      const uint32_t xp = (L.xres ? base + 2 * p * kPanel : st + kPanel) + wg * kPanel;
      vst::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        vst::wgmma_ss_n64_t<0, 0>(hacc, vst::desc_kmajor(xp, kk), vst::desc_kmajor(st, kk),
                          p > 0 || kk > 0);
      vst::wgmma_commit();
      vst::wgmma_wait<1>();
      if (p > 0)
        release_stage(empty_a + 8 * ((ia - 1) % L.sa), lane);
      else if (release_first != 0)
        release_stage(release_first, lane);
    }
    vst::wgmma_wait<0>();
    vst::fence_acc(hacc);
    release_stage(empty_a + 8 * ((ia - 1) % L.sa), lane);
  };

  // Per hidden chunk c: h's epilogue, then y += h W2[c, :] and the next
  // chunk's h product go out back to back, so the tensor cores have the
  // next product while this warpgroup waits for the y product.
  issue_h(0);
  for (int c = 0; c < nc; ++c) {
    // h = round(relu(h + b1)), straight into A fragments (k-step j / 2
    // covers hidden units 16 (j / 2) .. + 15 of the chunk)
    uint32_t hf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bb = vst::ld_u32(b1 + kFC * c + 8 * j + 2 * t);
      const float bb0 = vst::bf16_lo(bb), bb1 = vst::bf16_hi(bb);
      hf[j >> 1][(j & 1) * 2] = pack_bf16(fmaxf(hacc[j][0] + bb0, 0.f), fmaxf(hacc[j][1] + bb1, 0.f));
      hf[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(fmaxf(hacc[j][2] + bb0, 0.f), fmaxf(hacc[j][3] + bb1, 0.f));
    }

    // y += h W2[c, :] (W2 read K-major, 128 output columns a product)
    const int s = c % L.sb;
    vst::mbar_wait(full_b + 8 * s, (c / L.sb) & 1);
    const uint32_t st = base + L.b0 + s * L.b_bytes;
#pragma unroll
    for (int q = 0; q < NY; ++q) vst::fence_acc(yacc[q]);
    vst::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < NY; ++q)
        vst::wgmma_rs_n128_t<0>(yacc[q], hf[kk], vst::desc_kmajor(st + 2 * q * kPanel, kk));
    vst::wgmma_commit();
    if (c + 1 < nc) {
      issue_h(empty_b + 8 * s);
    } else {
      vst::wgmma_wait<0>();
      release_stage(empty_b + 8 * s, lane);
    }
#pragma unroll
    for (int q = 0; q < NY; ++q) vst::fence_acc(yacc[q]);
  }

  // y = (round(h W2) + b2) + x, each add rounded to bf16. With x resident
  // (then the block has all of D), each value of y overwrites its x in the
  // warpgroup's panels, which the TMA stores as whole boxes; else x is read
  // and y written from and to device memory.
  const int r = 16 * warp + g;   // the thread's first row in its warpgroup's 64
#pragma unroll
  for (int q = 0; q < NY; ++q)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = y0 + 128 * q + 8 * j + 2 * t;
      const uint32_t bb = vst::ld_u32(b2 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long off = (long long)(r0 + 64 * wg + r + 8 * half) * D + col;
        uint32_t* xs = reinterpret_cast<uint32_t*>(
            gbase + (2 * (col >> 6) + wg) * kPanel + vst::swizzled(r + 8 * half, col & 63));
        const uint32_t xv = L.xres ? *xs : vst::ld_u32(x + off);
        const float v0 = round_bf16(round_bf16(yacc[q][j][2 * half]) + vst::bf16_lo(bb)) +
                         vst::bf16_lo(xv);
        const float v1 = round_bf16(round_bf16(yacc[q][j][2 * half + 1]) + vst::bf16_hi(bb)) +
                         vst::bf16_hi(xv);
        if (L.xres)
          *xs = pack_bf16(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(y + off) = pack_bf16(v0, v1);
      }
    }
  if (L.xres) {
    vst::fence_proxy_async();
    vst::named_sync(1 + wg, 128);
    if (tid == 0) {
      for (int p = 0; p < P; ++p)
        vst::tma_store_2d(&my, base + (2 * p + wg) * kPanel, 64 * p, r0 + 64 * wg);
      vst::tma_store_drain();
    }
  }
}

template <int YC>
cudaError_t launch_fwd_wgmma(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, long long M, int D, int F,
                             cudaStream_t st) {
  CUtensorMap mx, mw1, mw2, my;
  if (!vst::matrix_tensor_map(&mx, x, M, D) || !vst::matrix_tensor_map(&mw1, w1, F, D) ||
      !vst::matrix_tensor_map(&mw2, w2, D, F) || !vst::matrix_tensor_map(&my, y, M, D))
    return cudaErrorInvalidValue;
  const FwdLayout L = fwd_layout(D, YC);
  const cudaError_t err = vst::allow_smem(ffn_fwd_wgmma_kernel<YC>, L.bytes);
  if (err != cudaSuccess) return err;
  ffn_fwd_wgmma_kernel<YC><<<dim3(static_cast<unsigned>(M / kBM), D / YC), kThreads, L.bytes,
                             st>>>(mx, mw1, mw2, my, static_cast<const bf*>(x),
                                   static_cast<const bf*>(b1), static_cast<const bf*>(b2),
                                   static_cast<bf*>(y), D, F, L);
  return cudaGetLastError();
}

// ---- f32: split-TF32 mma.sync kernel --------------------------------------------

using vst::ffn32::kHT;

constexpr int kF32Chunk = 32;              // hidden units a chunk
constexpr int kF32Tiles = 4;               // row tiles of 16 a block
constexpr int kF32BM = 16 * kF32Tiles;     // rows a block
constexpr int kF32Threads = 2 * kF32Tiles * 32;
constexpr int kF32W2LD = kF32Chunk + 8;    // W2 chunk row stride: 8 (mod 32)

// Shared memory in floats: x's resident rows [64][D + 4] (D <= 256); two
// stages of ring A (the chunk's rows of a W1 panel [32][kp + 4], then x's
// panel [64][kp + 4] where x streams) and two of ring B (the W2 chunk
// [YC][40]); the exchange of h, [4 row tiles][2 warps][32 lanes][8].
struct Tf32FwdLayout {
  int xres, kp, P, ld, a_floats, b_floats;
  int a0, b0, xh;
  size_t bytes;
};

inline Tf32FwdLayout tf32_fwd_layout(int D, int YC) {
  Tf32FwdLayout L{};
  L.xres = D <= vst::ffn32::kResident;
  L.kp = L.xres ? D : vst::ffn32::kKP;
  L.P = D / L.kp;
  L.ld = vst::ffn32::panel_ld(L.kp);
  L.a_floats = (kF32Chunk + (L.xres ? 0 : kF32BM)) * L.ld;
  L.b_floats = YC * kF32W2LD;
  L.a0 = L.xres ? kF32BM * L.ld : 0;
  L.b0 = L.a0 + 2 * L.a_floats;
  L.xh = L.b0 + 2 * L.b_floats;
  L.bytes = static_cast<size_t>(L.xh + kF32Tiles * 2 * 32 * 4 * kHT) * sizeof(float);
  return L;
}

// Grid (M / 64, D / YC), 256 threads. Warp w works on rows 16 (w % 4) ..
// + 15 of the block's 64 and, s = w / 4, on hidden units 16 s .. + 15 of
// each 32-unit chunk c (h32 = relu(x W1[c]^T + b1) through the backward's
// h_panel) and on columns s YC / 2 .. + YC / 2 - 1 of y. After h the two
// warps of a row tile swap their halves of it through shared memory, each
// lane with the same lane of its partner (the accumulator layouts match),
// and each adds h W2[c, its columns]^T to y, h as A fragments in
// a_from_acc's order, the chunk's four 8-unit steps in order. The items of
// the cp.async ring, in order: for each chunk the P panels of W1[c] (with
// x's panel where x streams), then the chunk W2[y0 .. y0 + YC, c]. One
// __syncthreads an item: each iteration waits for its own copies, meets
// the block (every warp is then done with the item before, whose stage the
// next item's copies overwrite, and with the h it read) and issues the
// next item's copies, which overlap this item's products.
template <int YC>
__global__ void __launch_bounds__(kF32Threads, 1)
ffn_fwd_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ y, int D, int F,
                    Tf32FwdLayout L) {
  constexpr int HY = YC / 2, NT = HY / 8;
  extern __shared__ __align__(16) float tsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, tile = warp % kF32Tiles, s = warp / kF32Tiles;
  const int rw = 16 * tile;
  const long long r0 = (long long)blockIdx.x * kF32BM;
  const int y0 = blockIdx.y * YC;
  const int P = L.P, kp = L.kp, ld = L.ld, per = P + 1, n = (F / kF32Chunk) * per;
  // h of the row tile: [2 warps][32 lanes][kHT float4]
  float4* xh = reinterpret_cast<float4*>(tsm + L.xh) + tile * 2 * 32 * kHT;

  auto issue = [&](int i) {
    const int c = i / per, q = i - c * per;
    if (q < P) {
      float* st = tsm + L.a0 + ((c * P + q) & 1) * L.a_floats;
      vst::ffn32::cp_tile(st, ld, w1 + (long long)c * kF32Chunk * D + q * kp, D, kF32Chunk, kp,
                          tid, kF32Threads);
      if (!L.xres)
        vst::ffn32::cp_tile(st + kF32Chunk * ld, ld, x + r0 * D + q * kp, D, kF32BM, kp, tid,
                            kF32Threads);
    } else {
      vst::ffn32::cp_tile(tsm + L.b0 + (c & 1) * L.b_floats, kF32W2LD,
                          w2 + (long long)y0 * F + c * kF32Chunk, F, YC, kF32Chunk, tid,
                          kF32Threads);
    }
  };
  if (L.xres) vst::ffn32::cp_tile(tsm, ld, x + r0 * D, D, kF32BM, D, tid, kF32Threads);
  issue(0);
  vst::cp_async_commit();

  // y's running sums: where a warp holds 64 columns (YC = 128), one over
  // the even and one over the odd chunks, added at the end (each F / 64
  // adds deep); at 128 columns (YC = 256) the second set of accumulators
  // does not fit the 255 registers, and yodd stays 0
  constexpr bool kTwoSums = YC == 128;
  float yeven[NT][4], yodd[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yeven[j][e] = yodd[j][e] = 0.f;
  float hacc[kHT][4];

  // ya[:, this warp's half] += h W2[c, ..]^T over the chunk's 32 units
  // from the B stage st: the four steps' fresh accumulators added in
  // order into the first, then that to ya
  auto y_chunk = [&](float (&ya)[NT][4], const float* st, const vst::SplitA (&fa)[4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float sum[4], d[4];
      vst::mma_b_nk_pair_fresh(sum, fa[0], st, kF32W2LD, 8 * j, 0, g, t);
#pragma unroll
      for (int kc = 1; kc < kF32Chunk / 8; ++kc) {
        vst::mma_b_nk_pair_fresh(d, fa[kc], st, kF32W2LD, 8 * j, 8 * kc, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e] += d[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[j][e] += sum[e];
    }
  };

  for (int i = 0; i < n; ++i) {
    vst::cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n) {
      issue(i + 1);
      vst::cp_async_commit();
    }
    const int c = i / per, q = i - c * per;
    if (q < P) {
      if (q == 0) {
#pragma unroll
        for (int j = 0; j < kHT; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;
      }
      const float* st = tsm + L.a0 + ((c * P + q) & 1) * L.a_floats;
      vst::ffn32::h_panel(hacc, L.xres ? tsm : st + kF32Chunk * ld, st + 16 * s * ld, ld, rw,
                             kp, g, t);
      if (q == P - 1) {   // h = relu(h + b1) to the exchange
#pragma unroll
        for (int kc = 0; kc < kHT; ++kc) {
          const float2 bb =
              *reinterpret_cast<const float2*>(b1 + c * kF32Chunk + 16 * s + 8 * kc + 2 * t);
          xh[(s * 32 + lane) * kHT + kc] = make_float4(
              fmaxf(hacc[kc][0] + bb.x, 0.f), fmaxf(hacc[kc][1] + bb.y, 0.f),
              fmaxf(hacc[kc][2] + bb.x, 0.f), fmaxf(hacc[kc][3] + bb.y, 0.f));
        }
      }
    } else {
      // y += h W2[c, ..]^T, into the running sum of c's parity where there
      // are two
      const float* st = tsm + L.b0 + (c & 1) * L.b_floats + s * HY * kF32W2LD;
      vst::SplitA fa[kF32Chunk / 8];
#pragma unroll
      for (int kc = 0; kc < kF32Chunk / 8; ++kc) {
        const float4 h = xh[((kc / kHT) * 32 + lane) * kHT + kc % kHT];
        fa[kc] = vst::split_a(h.x, h.z, h.y, h.w);
      }
      if (kTwoSums && (c & 1))
        y_chunk(yodd, st, fa);
      else
        y_chunk(yeven, st, fa);
    }
  }

  // y = (h W2 + b2) + x
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = y0 + s * HY + 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rw + g + 8 * half;
      const long long off = (r0 + r) * D + col;
      const float2 xv = L.xres ? *reinterpret_cast<const float2*>(tsm + r * ld + col)
                               : *reinterpret_cast<const float2*>(x + off);
      const float y0v = kTwoSums ? yeven[j][2 * half] + yodd[j][2 * half] : yeven[j][2 * half];
      const float y1v =
          kTwoSums ? yeven[j][2 * half + 1] + yodd[j][2 * half + 1] : yeven[j][2 * half + 1];
      *reinterpret_cast<float2*>(y + off) = make_float2((y0v + bb.x) + xv.x, (y1v + bb.y) + xv.y);
    }
  }
}

template <int YC>
cudaError_t launch_fwd_tf32(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* y, long long M, int D, int F,
                            cudaStream_t st) {
  const Tf32FwdLayout L = tf32_fwd_layout(D, YC);
  const cudaError_t err = vst::allow_smem(ffn_fwd_tf32_kernel<YC>, L.bytes);
  if (err != cudaSuccess) return err;
  ffn_fwd_tf32_kernel<YC><<<dim3(static_cast<unsigned>(M / kF32BM), D / YC), kF32Threads,
                            L.bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), D, F, L);
  return cudaGetLastError();
}

}  // namespace

// x, y: [M, D] contiguous; w1: [F, D], b1: [F], w2: [D, F], b2: [D], all
// contiguous, one dtype (bf16 if is_bf16, else f32), 16-byte aligned.
// M % 128 == 0, D % 128 == 0, F % 128 == 0 (cudaErrorInvalidValue
// otherwise). Returns cudaGetLastError() after the launch.
extern "C" int vst_ffn_fwd(int is_bf16, const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* y, long long M, int D,
                           int F, void* stream) {
  if (M % kBM || D % 128 || F % 128 || M <= 0 || D <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = D % 256 == 0 ? launch_fwd_tf32<256>(x, w1, b1, w2, b2, y, M, D, F, st)
                       : launch_fwd_tf32<128>(x, w1, b1, w2, b2, y, M, D, F, st);
  else if (D % 256 == 0)
    err = launch_fwd_wgmma<256>(x, w1, b1, w2, b2, y, M, D, F, st);
  else
    err = launch_fwd_wgmma<128>(x, w1, b1, w2, b2, y, M, D, F, st);
  return static_cast<int>(err);
}
