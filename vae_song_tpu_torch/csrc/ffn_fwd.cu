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
// f32 inputs (mixed_precision: false) take a plain FMA kernel, no TF32:
// 64-row blocks and 256-column chunks of y (128 where 256 does not divide
// D), 16 hidden units a step, x staged once up to D = 256 and in 64-column
// panels above it, so any D fits.

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

// ---- f32: plain FMA kernel -----------------------------------------------------

constexpr int kF32Rows = 64;      // rows a block
constexpr int kF32Threads = 256;
constexpr int kF32F = 16;         // hidden units a step
constexpr int kF32Panel = 64;     // columns of x and W1 staged at a time
constexpr int kF32Resident = 256; // up to this D the block's x rows stay staged

// Row stride of the staged x, in floats: all of D when it stays, else a
// panel; odd, so that the threads' row reads fall on distinct banks.
inline int f32_x_stride(int D) { return (D <= kF32Resident ? D : kF32Panel) + 1; }

inline size_t f32_smem(int D, int YC) {
  return (kF32Rows * f32_x_stride(D) + kF32F * kF32Panel + kF32Rows * (kF32F + 1) + kF32F * YC) *
         sizeof(float);
}

// Grid (M / 64, D / YC), 256 threads. For the h step thread i computes
// row i % 64, hidden units i / 64 + 4 j, summing over D in order; for y it
// owns row i % 64, columns y0 + (i / 64) YC / 4 .. + YC / 4 - 1. Up to
// D = 256 the block's x rows are staged once, above it one 64-column panel
// at a time.
template <int YC>
__global__ void __launch_bounds__(kF32Threads)
ffn_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ y, int D, int F) {
  constexpr int HP = kF32F + 1, CW = YC / 4;
  const bool xres = D <= kF32Resident;
  const int XP = xres ? D + 1 : kF32Panel + 1;
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                          // x [64][D + 1] or a panel [64][65]
  float* w1s = xs + kF32Rows * XP;          // W1[:, c] panel^T [16][64]
  float* hs = w1s + kF32F * kF32Panel;      // h [64][17]
  float* w2s = hs + kF32Rows * HP;          // W2[c, y0..]^T [16][YC]

  const long long r0 = (long long)blockIdx.x * kF32Rows;
  const int y0 = blockIdx.y * YC;
  const int tid = threadIdx.x, row = tid % kF32Rows, grp = tid / kF32Rows;
  const float* xr = xs + row * XP;

  float acc[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < F; c0 += kF32F) {
    float s[kF32F / 4];
#pragma unroll
    for (int jj = 0; jj < kF32F / 4; ++jj) s[jj] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kF32Panel) {
      const int xc = xres ? d0 : 0;   // the panel's first column in xs
      __syncthreads();
      if (!xres || c0 == 0)
        for (int i = tid; i < kF32Rows * kF32Panel; i += kF32Threads)
          xs[(i / kF32Panel) * XP + xc + i % kF32Panel] =
              x[(r0 + i / kF32Panel) * D + d0 + i % kF32Panel];
      for (int i = tid; i < kF32F * kF32Panel; i += kF32Threads)
        w1s[i] = w1[(long long)(c0 + i / kF32Panel) * D + d0 + i % kF32Panel];
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kF32F / 4; ++jj) {
        const float* wr = w1s + (grp + 4 * jj) * kF32Panel;
#pragma unroll 16
        for (int d = 0; d < kF32Panel; ++d) s[jj] = fmaf(xr[xc + d], wr[d], s[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kF32F / 4; ++jj) {
      const int j = grp + 4 * jj;
      hs[row * HP + j] = fmaxf(s[jj] + b1[c0 + j], 0.f);
    }
    for (int i = tid; i < kF32F * YC; i += kF32Threads)
      w2s[i] = w2[(long long)(y0 + i % YC) * F + c0 + i / YC];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kF32F; ++j) {
      const float hv = hs[row * HP + j];
#pragma unroll
      for (int i = 0; i < CW; ++i) acc[i] = fmaf(hv, w2s[j * YC + grp * CW + i], acc[i]);
    }
  }
  const long long off = (r0 + row) * D + y0 + grp * CW;
#pragma unroll
  for (int i = 0; i < CW; ++i) y[off + i] = (acc[i] + b2[y0 + grp * CW + i]) + x[off + i];
}

template <int YC>
cudaError_t launch_fwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* y, long long M, int D, int F,
                           cudaStream_t st) {
  const size_t smem = f32_smem(D, YC);
  const cudaError_t err = vst::allow_smem(ffn_fwd_f32_kernel<YC>, smem);
  if (err != cudaSuccess) return err;
  ffn_fwd_f32_kernel<YC><<<dim3(static_cast<unsigned>(M / kF32Rows), D / YC), kF32Threads, smem,
                           st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), D, F);
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
    err = D % 256 == 0 ? launch_fwd_f32<256>(x, w1, b1, w2, b2, y, M, D, F, st)
                       : launch_fwd_f32<128>(x, w1, b1, w2, b2, y, M, D, F, st);
  else if (D % 256 == 0)
    err = launch_fwd_wgmma<256>(x, w1, b1, w2, b2, y, M, D, F, st);
  else
    err = launch_fwd_wgmma<128>(x, w1, b1, w2, b2, y, M, D, F, st);
  return static_cast<int>(err);
}
