// What the fused FFN's f32 kernels (ffn_fwd.cu, ffn_bwd.cu) share: the
// tiling constants, the cp.async tile copy, and the product h32 = x W1^T
// + b1 of one warp's 16 rows, so that the backward recomputes the
// forward's h32, hence its ReLU mask and the h that enters dW2, bit for
// bit (the same steps in the same order).

#pragma once

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace vst {
namespace ffn32 {

constexpr int kHC = 16;          // hidden units a chunk
constexpr int kHT = kHC / 8;     // their 8-wide n-tiles
constexpr int kKP = 128;         // columns of x (dy) and W1 (W2) a panel where x streams
constexpr int kResident = 256;   // up to this D a block's x (and dy) rows stay resident
constexpr int kW2LD = kHC + 8;   // row stride of a W2 chunk tile: 8 (mod 16)

// Row stride of an x, dy or W1 panel tile, kp columns wide (kp % 128 ==
// 0): kp + 4, 4 (mod 32).
__host__ __device__ constexpr int panel_ld(int kp) { return kp + 4; }

// Rows 0 .. rows - 1, columns 0 .. cols - 1 (cols % 4 == 0) of a row-major
// f32 matrix at `src` with row stride `lds` (a multiple of 4, src 16-byte
// aligned) into a [rows][ldd] shared tile, 16 bytes a cp.async, by the
// block's nthr threads (not committed).
__device__ __forceinline__ void cp_tile(float* dst, int ldd, const float* src, long long lds,
                                        int rows, int cols, int tid, int nthr) {
  const int per = cols >> 2;
  for (int i = tid; i < rows * per; i += nthr) {
    const int r = i / per, c = (i - r * per) * 4;
    cp_async16(dst + r * ldd + c, src + (long long)r * lds + c);
  }
}

// acc[j] (rows r0 .. r0 + 15, hidden units 8 j .. 8 j + 7 of the chunk)
// += x[r0 .., 0 .. kp) W1c^T over one panel: xs a [rows][ld] tile of x's
// panel, w1s the chunk's [kHC][ld] tile of W1 (Dense layout: row = hidden
// unit, K-major). Each 8-deep step is split TF32 into a fresh accumulator
// added to acc (mma_3xtf32); the steps run in order of the columns, panel
// after panel, in the forward and the backward alike (unrolled by 4: two
// n-tiles a step give too few independent products to hide the mma.sync
// latency one step at a time).
__device__ __forceinline__ void h_panel(float (&acc)[kHT][4], const float* xs, const float* w1s,
                                        int ld, int r0, int kp, int g, int t) {
#pragma unroll 4
  for (int kk = 0; kk < kp / 8; ++kk) {
    const SplitA a = a_from_smem(xs, ld, r0, 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < kHT; ++j) mma_b_rows_t(acc[j], a, w1s, ld, 8 * j, 8 * kk, g, t, 1.f);
  }
}

}  // namespace ffn32
}  // namespace vst
