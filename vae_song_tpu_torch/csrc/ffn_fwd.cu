// Fused transformer FFN forward for Hopper (sm_90a):
//   y = x + relu(x W1 + b1) W2 + b2
// over x [M, D] (contiguous rows), D = 128 or 256, hidden width F % 64 == 0.
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
// has 227 KB, so W1 alone does not fit. Each block owns 64 rows of x
// (4 warps x 16 rows, x staged once in shared memory) and walks F in
// chunks of 64: it stages W1[:, c] and W2[c, :], computes the h chunk with
// mma.sync (bf16 in, f32 accumulate), adds b1 and applies ReLU in f32,
// rounds once, and keeps the chunk in registers as the A operand of
// y += h W2[c, :] (the accumulator-to-A trick of the attention forward's
// P V). y accumulates in f32 registers (16 x D a warp). Only x, the
// weights and y touch device memory: h never leaves the SM. At M = 131072,
// D = 256, F = 512 one call is 6.9e10 flop against 134 MB of x / y
// traffic, 514 flop a byte: above the H100's ~295, so the tensor cores
// bound it. Every block re-reads the 0.5 MB of weights (from L2); loads
// are synchronous and single-buffered.
//
// f32 inputs (mixed_precision: false) take a plain FMA kernel of the same
// row-block shape, 16 hidden units a chunk, no TF32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using vst::acc_to_a;
using vst::ld_u32;
using vst::load_a_chunk;
using vst::mma_16816;
using vst::pack_bf16;
using vst::round_bf16;

using bf = __nv_bfloat16;

constexpr int kRows = 64;      // rows of x per block (4 warps x 16)
constexpr int kF = 64;         // hidden units per chunk
constexpr int kThreads = 128;

template <int D>
constexpr size_t fwd_bf16_smem() {
  return ((kRows + kF) * (D + 8) + D * (kF + 8)) * sizeof(bf);
}

// Grid M / 64, 128 threads. Warp w owns rows r0 + 16w .. + 15; lane =
// 4 g + t holds rows g and g + 8 of the m16n8k16 fragments.
template <int D>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_bf16_kernel(const bf* __restrict__ x, const bf* __restrict__ w1,
                    const bf* __restrict__ b1, const bf* __restrict__ w2,
                    const bf* __restrict__ b2, bf* __restrict__ y, int F) {
  constexpr int LD = D + 8;
  constexpr int LDW = kF + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  auto xs = reinterpret_cast<bf (*)[LD]>(smem);                            // x [row][d]
  auto w1s = reinterpret_cast<bf (*)[LD]>(smem + kRows * LD * 2);          // W1[:, c]^T [j][d]
  auto w2s = reinterpret_cast<bf (*)[LDW]>(smem + (kRows + kF) * LD * 2);  // W2[c, :]^T [d][j]

  const long long r0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < kRows * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&xs[r][c]) =
        *reinterpret_cast<const uint4*>(x + (r0 + r) * D + c);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int c0 = 0; c0 < F; c0 += kF) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = tid; i < kF * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&w1s[r][c]) =
          *reinterpret_cast<const uint4*>(w1 + (long long)(c0 + r) * D + c);
    }
    for (int i = tid; i < D * kF / 8; i += kThreads) {
      const int r = i / (kF / 8), c = (i % (kF / 8)) * 8;
      *reinterpret_cast<uint4*>(&w2s[r][c]) =
          *reinterpret_cast<const uint4*>(w2 + (long long)r * F + c0 + c);
    }
    __syncthreads();

    // h = x W1[:, c] (16 rows x 64 hidden units a warp)
    float h[kF / 8][4];
#pragma unroll
    for (int nt = 0; nt < kF / 8; ++nt) h[nt][0] = h[nt][1] = h[nt][2] = h[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a_chunk<LD>(xs, warp * 16, kk, g, t, a);
#pragma unroll
      for (int nt = 0; nt < kF / 8; ++nt) {
        const bf* br = &w1s[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(h[nt], a, ld_u32(br), ld_u32(br + 8));
      }
    }
    // b1 and ReLU in f32, one rounding to bf16 (acc_to_a packs the
    // rounded values, exactly)
#pragma unroll
    for (int nt = 0; nt < kF / 8; ++nt) {
      const int col = c0 + nt * 8 + 2 * t;
      const float bb0 = __bfloat162float(b1[col]), bb1 = __bfloat162float(b1[col + 1]);
      h[nt][0] = round_bf16(fmaxf(h[nt][0] + bb0, 0.f));
      h[nt][1] = round_bf16(fmaxf(h[nt][1] + bb1, 0.f));
      h[nt][2] = round_bf16(fmaxf(h[nt][2] + bb0, 0.f));
      h[nt][3] = round_bf16(fmaxf(h[nt][3] + bb1, 0.f));
    }

    // y += h W2[c, :]
#pragma unroll
    for (int kc = 0; kc < kF / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(h, kc, pa);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf* br = &w2s[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[dt], pa, ld_u32(br), ld_u32(br + 8));
      }
    }
  }

  // y = (round(h W2) + b2) + x, each add rounded to bf16
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    const float bb0 = __bfloat162float(b2[c]), bb1 = __bfloat162float(b2[c + 1]);
    const float y00 = round_bf16(round_bf16(acc[dt][0]) + bb0) + __bfloat162float(xs[lr0][c]);
    const float y01 = round_bf16(round_bf16(acc[dt][1]) + bb1) + __bfloat162float(xs[lr0][c + 1]);
    const float y10 = round_bf16(round_bf16(acc[dt][2]) + bb0) + __bfloat162float(xs[lr1][c]);
    const float y11 = round_bf16(round_bf16(acc[dt][3]) + bb1) + __bfloat162float(xs[lr1][c + 1]);
    *reinterpret_cast<uint32_t*>(y + (r0 + lr0) * D + c) = pack_bf16(y00, y01);
    *reinterpret_cast<uint32_t*>(y + (r0 + lr1) * D + c) = pack_bf16(y10, y11);
  }
}

constexpr int kF32Threads = 256;
constexpr int kF32F = 16;       // hidden units per chunk

template <int D>
constexpr size_t fwd_f32_smem() {
  return (kRows * (D + 1) + 2 * kF32F * D + kRows * (kF32F + 1)) * sizeof(float);
}

// Grid M / 64, 256 threads. For the h chunk thread i computes row i % 64,
// hidden units i / 64 + 4 j; for y it owns row i % 64, columns
// (i / 64) * D / 4 .. + D / 4 - 1. Rows sit in shared memory with a stride
// of D + 1 floats, so the threads' row reads fall on distinct banks.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
ffn_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ y, int F) {
  constexpr int P = D + 1, HP = kF32F + 1, CW = D / 4;
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                        // [64][D + 1]
  float* w1s = xs + kRows * P;            // W1[:, c]^T [16][D]
  float* w2s = w1s + kF32F * D;           // W2[c, :]   [16][D]
  float* hs = w2s + kF32F * D;            // h [64][17]

  const long long r0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x, row = tid % kRows, grp = tid / kRows;
  for (int i = tid; i < kRows * D; i += kF32Threads)
    xs[(i / D) * P + i % D] = x[r0 * D + i];
  const float* xr = xs + row * P;

  float acc[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < F; c0 += kF32F) {
    __syncthreads();
    for (int i = tid; i < kF32F * D; i += kF32Threads) {
      const int j = i / D, d = i % D;
      w1s[i] = w1[(long long)(c0 + j) * D + d];
      w2s[i] = w2[(long long)d * F + c0 + j];
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kF32F / 4; ++jj) {
      const int j = grp + 4 * jj;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(xr[d], w1s[j * D + d], s);
      hs[row * HP + j] = fmaxf(s + b1[c0 + j], 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kF32F; ++j) {
      const float hv = hs[row * HP + j];
#pragma unroll
      for (int i = 0; i < CW; ++i) acc[i] = fmaf(hv, w2s[j * D + grp * CW + i], acc[i]);
    }
  }
  float* yr = y + (r0 + row) * D + grp * CW;
#pragma unroll
  for (int i = 0; i < CW; ++i) yr[i] = (acc[i] + b2[grp * CW + i]) + xr[grp * CW + i];
}

template <int D>
cudaError_t launch_fwd(int is_bf16, const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* y, long long M, int F,
                       cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(M / kRows);
  cudaError_t err;
  if (is_bf16) {
    constexpr size_t smem = fwd_bf16_smem<D>();
    if ((err = vst::allow_smem(ffn_fwd_bf16_kernel<D>, smem)) != cudaSuccess) return err;
    ffn_fwd_bf16_kernel<D><<<blocks, kThreads, smem, st>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w1), static_cast<const bf*>(b1),
        static_cast<const bf*>(w2), static_cast<const bf*>(b2), static_cast<bf*>(y), F);
  } else {
    constexpr size_t smem = fwd_f32_smem<D>();
    if ((err = vst::allow_smem(ffn_fwd_f32_kernel<D>, smem)) != cudaSuccess) return err;
    ffn_fwd_f32_kernel<D><<<blocks, kF32Threads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(y), F);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: [M, D] contiguous; w1: [F, D], b1: [F], w2: [D, F], b2: [D], all
// contiguous, one dtype (bf16 if is_bf16, else f32), 16-byte aligned.
// M % 64 == 0, F % 64 == 0, D 128 or 256 (cudaErrorInvalidValue
// otherwise). The caller checks all of it. Returns cudaGetLastError()
// after the launch.
extern "C" int vst_ffn_fwd(int is_bf16, const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* y, long long M, int D,
                           int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 128: err = launch_fwd<128>(is_bf16, x, w1, b1, w2, b2, y, M, F, st); break;
    case 256: err = launch_fwd<256>(is_bf16, x, w1, b1, w2, b2, y, M, F, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
