// Fused transformer FFN backward for Hopper (sm_90a), the gradients of
//   y = x + relu(x W1 + b1) W2 + b2
// over x [M, D] (contiguous rows), D = 128 or 256, hidden width F % 64 == 0.
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
//   1. rows: one block per 64 rows recomputes h32 and dh32 a hidden chunk
//      at a time (mma.sync, bf16 in, f32 accumulate), accumulates dx in
//      f32 registers, writes h and dh (cd) to a workspace for pass 2, and
//      the block's f32 column sums of dh32 and dy (db1, db2 partials);
//   2. weight gradients: dW1 = dh^T x and dW2 = dy^T h as products over
//      the M rows, one block per 64 x 64 output tile and per split of the
//      rows (16 splits), each writing its f32 partial tile;
//   3. sums: the partials added in split (or row-block) order, rounded
//      once to cd.
// Unlike the TPU kernel, h and dh make one round trip through device
// memory (2 x M x F in cd, 268 MB in bf16 at M = 131072, F = 512, about
// 0.16 ms at 3.35 TB/s): recomputing them inside pass 2 would repeat the
// two M x D x F products for every output tile. At the set shapes one call
// is 2.1e11 flop (five M x D x F products) against ~0.8 GB of traffic: the
// tensor cores bound it. Loads are synchronous and single-buffered.
//
// f32 inputs (mixed_precision: false) take plain FMA kernels of the same
// three-pass shape, no TF32.

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

constexpr int kRows = 64;      // rows per block in pass 1 (4 warps x 16)
constexpr int kF = 32;         // hidden units per chunk in pass 1
constexpr int kThreads = 128;
constexpr int kTile = 64;      // output tile edge and row tile of pass 2

template <int D>
constexpr size_t rows_bf16_smem() {
  return ((2 * kRows + 2 * kF) * (D + 8) + D * (kF + 8)) * sizeof(bf) +
         4 * kF * sizeof(float);
}

// ---- pass 1, bf16 -----------------------------------------------------------

// Grid M / 64, 128 threads. Warp w owns rows r0 + 16w .. + 15.
template <int D>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_rows_bf16_kernel(const bf* __restrict__ x, const bf* __restrict__ dy,
                         const bf* __restrict__ w1, const bf* __restrict__ b1,
                         const bf* __restrict__ w2, bf* __restrict__ dx,
                         bf* __restrict__ hbuf, bf* __restrict__ dhbuf,
                         float* __restrict__ pb1, float* __restrict__ pb2, int F) {
  constexpr int LD = D + 8;
  constexpr int LDT = kF + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  auto xs = reinterpret_cast<bf (*)[LD]>(smem);                    // x [row][d]
  auto dys = xs + kRows;                                           // dy [row][d]
  auto w1s = dys + kRows;                                          // W1[:, c]^T [j][d]
  auto w2c = w1s + kF;                                             // W2[c, :] [j][d]
  auto w1t = reinterpret_cast<bf (*)[LDT]>(w2c + kF);              // W1[:, c] [d][j]
  float* red = reinterpret_cast<float*>(w1t + D);                  // [4 warps][kF]

  const long long r0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < kRows * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&xs[r][c]) = *reinterpret_cast<const uint4*>(x + (r0 + r) * D + c);
    *reinterpret_cast<uint4*>(&dys[r][c]) = *reinterpret_cast<const uint4*>(dy + (r0 + r) * D + c);
  }
  __syncthreads();
  // db2 partial: this block's column sums of dy, rows in order
  for (int c = tid; c < D; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += __bfloat162float(dys[r][c]);
    pb2[(long long)blockIdx.x * D + c] = s;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;

  for (int c0 = 0; c0 < F; c0 += kF) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = tid; i < kF * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(w1 + (long long)(c0 + r) * D + c);
      *reinterpret_cast<uint4*>(&w1s[r][c]) = raw;
      const bf* e = reinterpret_cast<const bf*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) w1t[c + j][r] = e[j];
    }
    for (int i = tid; i < D * kF / 8; i += kThreads) {
      const int r = i / (kF / 8), c = (i % (kF / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(w2 + (long long)r * F + c0 + c);
      const bf* e = reinterpret_cast<const bf*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) w2c[c + j][r] = e[j];
    }
    __syncthreads();

    // h32 = relu(x W1[:, c] + b1), dh32 = (dy W2[c, :]^T) * [h32 > 0]
    float h[kF / 8][4], dh[kF / 8][4];
#pragma unroll
    for (int nt = 0; nt < kF / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[nt][j] = dh[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], da[4];
      load_a_chunk<LD>(xs, warp * 16, kk, g, t, a);
      load_a_chunk<LD>(dys, warp * 16, kk, g, t, da);
#pragma unroll
      for (int nt = 0; nt < kF / 8; ++nt) {
        const bf* br = &w1s[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(h[nt], a, ld_u32(br), ld_u32(br + 8));
        const bf* dr = &w2c[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(dh[nt], da, ld_u32(dr), ld_u32(dr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kF / 8; ++nt) {
      const int col = c0 + nt * 8 + 2 * t;
      const float bb0 = __bfloat162float(b1[col]), bb1 = __bfloat162float(b1[col + 1]);
      h[nt][0] = fmaxf(h[nt][0] + bb0, 0.f);
      h[nt][1] = fmaxf(h[nt][1] + bb1, 0.f);
      h[nt][2] = fmaxf(h[nt][2] + bb0, 0.f);
      h[nt][3] = fmaxf(h[nt][3] + bb1, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[nt][j] *= h[nt][j] > 0.f ? 1.f : 0.f;
      // h and dh, rounded once, for pass 2
      *reinterpret_cast<uint32_t*>(hbuf + (r0 + lr0) * F + col) = pack_bf16(h[nt][0], h[nt][1]);
      *reinterpret_cast<uint32_t*>(hbuf + (r0 + lr1) * F + col) = pack_bf16(h[nt][2], h[nt][3]);
      *reinterpret_cast<uint32_t*>(dhbuf + (r0 + lr0) * F + col) = pack_bf16(dh[nt][0], dh[nt][1]);
      *reinterpret_cast<uint32_t*>(dhbuf + (r0 + lr1) * F + col) = pack_bf16(dh[nt][2], dh[nt][3]);
      // db1 partial: the warp's 16 rows of the f32 dh32, then the 4 warps
      float s0 = dh[nt][0] + dh[nt][2], s1 = dh[nt][1] + dh[nt][3];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, m);
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      }
      if (g == 0) {
        red[warp * kF + nt * 8 + 2 * t] = s0;
        red[warp * kF + nt * 8 + 2 * t + 1] = s1;
      }
    }

    // dx += dh W1[:, c]^T (dh rounded to bf16 by the packing)
#pragma unroll
    for (int kc = 0; kc < kF / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(dh, kc, pa);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf* br = &w1t[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[dt], pa, ld_u32(br), ld_u32(br + 8));
      }
    }
    __syncthreads();
    if (tid < kF)
      pb1[(long long)blockIdx.x * F + c0 + tid] =
          ((red[tid] + red[kF + tid]) + red[2 * kF + tid]) + red[3 * kF + tid];
  }

  // dx = round(dh W1^T) + dy, the add rounded to bf16
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dx + (r0 + lr0) * D + c) =
        pack_bf16(round_bf16(acc[dt][0]) + __bfloat162float(dys[lr0][c]),
                  round_bf16(acc[dt][1]) + __bfloat162float(dys[lr0][c + 1]));
    *reinterpret_cast<uint32_t*>(dx + (r0 + lr1) * D + c) =
        pack_bf16(round_bf16(acc[dt][2]) + __bfloat162float(dys[lr1][c]),
                  round_bf16(acc[dt][3]) + __bfloat162float(dys[lr1][c + 1]));
  }
}

// ---- pass 2, bf16 -----------------------------------------------------------

// C[m][n] = sum over the split's rows r of A[r][m] B[r][n], A [M, Ma] and
// B [M, Nb] bf16 row-major, into ws[split][Ma][Nb] f32. Grid (Ma / 64 *
// Nb / 64, splits), 128 threads; warp w owns rows 16w .. + 15 of the
// tile. Both operands are staged transposed ([m][r], [n][r]), which is the
// A (row) and B (col) fragment layout of a product over r.
__global__ void __launch_bounds__(kThreads)
ffn_wgrad_bf16_kernel(const bf* __restrict__ A, const bf* __restrict__ B,
                      float* __restrict__ ws, long long M, int Ma, int Nb,
                      long long rows_per_split) {
  __shared__ __align__(16) bf at[kTile][kTile + 8];
  __shared__ __align__(16) bf bt[kTile][kTile + 8];
  const int ntn = Nb / kTile;
  const int m0 = (blockIdx.x / ntn) * kTile, n0 = (blockIdx.x % ntn) * kTile;
  const long long rbeg = (long long)blockIdx.y * rows_per_split;
  const long long rend = min(M, rbeg + rows_per_split);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[kTile / 8][4];
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (long long rb = rbeg; rb < rend; rb += kTile) {
    __syncthreads();
    for (int i = tid; i < kTile * kTile / 8; i += kThreads) {
      const int r = i / (kTile / 8), c = (i % (kTile / 8)) * 8;
      const uint4 ra = *reinterpret_cast<const uint4*>(A + (rb + r) * Ma + m0 + c);
      const uint4 rbv = *reinterpret_cast<const uint4*>(B + (rb + r) * Nb + n0 + c);
      const bf* ea = reinterpret_cast<const bf*>(&ra);
      const bf* eb = reinterpret_cast<const bf*>(&rbv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        at[c + j][r] = ea[j];
        bt[c + j][r] = eb[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t a[4];
      load_a_chunk<kTile + 8>(at, warp * 16, kc, g, t, a);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const bf* br = &bt[nt * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[nt], a, ld_u32(br), ld_u32(br + 8));
      }
    }
  }

  float* out = ws + (long long)blockIdx.y * Ma * Nb;
  const int m = m0 + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int n = n0 + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + (long long)m * Nb + n) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (long long)(m + 8) * Nb + n) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- pass 3 ---------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf from_f<bf>(float x) { return __float2bfloat16_rn(x); }

// out[i] = round_T(sum over s < S, in order, of parts[s * count + i])
template <typename T>
__global__ void __launch_bounds__(256)
ffn_sum_parts_kernel(const float* __restrict__ parts, int S, long long count,
                     T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += parts[k * count + i];
  out[i] = from_f<T>(s);
}

// ---- f32: plain FMA kernels -------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32F = 16;       // hidden units per chunk

template <int D>
constexpr size_t rows_f32_smem() {
  return (2 * kRows * (D + 1) + 2 * kF32F * D + kRows * (kF32F + 1)) * sizeof(float);
}

// Grid M / 64, 256 threads; the f32 counterpart of pass 1. For the hidden
// chunk thread i computes row i % 64, units i / 64 + 4 j; for dx it owns
// row i % 64, columns (i / 64) * D / 4 .. + D / 4 - 1.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
ffn_bwd_rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                        const float* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ w2, float* __restrict__ dx,
                        float* __restrict__ hbuf, float* __restrict__ dhbuf,
                        float* __restrict__ pb1, float* __restrict__ pb2, int F) {
  constexpr int P = D + 1, HP = kF32F + 1, CW = D / 4;
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                        // [64][D + 1]
  float* dys = xs + kRows * P;            // [64][D + 1]
  float* w1s = dys + kRows * P;           // W1[:, c]^T [16][D]
  float* w2c = w1s + kF32F * D;           // W2[c, :]   [16][D]
  float* dhs = w2c + kF32F * D;           // dh32 [64][17]

  const long long r0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x, row = tid % kRows, grp = tid / kRows;
  for (int i = tid; i < kRows * D; i += kF32Threads) {
    xs[(i / D) * P + i % D] = x[r0 * D + i];
    dys[(i / D) * P + i % D] = dy[r0 * D + i];
  }
  __syncthreads();
  for (int c = tid; c < D; c += kF32Threads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += dys[r * P + c];
    pb2[(long long)blockIdx.x * D + c] = s;
  }
  const float* xr = xs + row * P;
  const float* dyr = dys + row * P;

  float acc[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < F; c0 += kF32F) {
    __syncthreads();
    for (int i = tid; i < kF32F * D; i += kF32Threads) {
      const int j = i / D, d = i % D;
      w1s[i] = w1[(long long)(c0 + j) * D + d];
      w2c[i] = w2[(long long)d * F + c0 + j];
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kF32F / 4; ++jj) {
      const int j = grp + 4 * jj;
      float s = 0.f, ds = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(xr[d], w1s[j * D + d], s);
        ds = fmaf(dyr[d], w2c[j * D + d], ds);
      }
      const float h = fmaxf(s + b1[c0 + j], 0.f);
      ds *= h > 0.f ? 1.f : 0.f;
      dhs[row * HP + j] = ds;
      hbuf[(r0 + row) * F + c0 + j] = h;
      dhbuf[(r0 + row) * F + c0 + j] = ds;
    }
    __syncthreads();
    if (tid < kF32F) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += dhs[r * HP + tid];
      pb1[(long long)blockIdx.x * F + c0 + tid] = s;
    }
#pragma unroll
    for (int j = 0; j < kF32F; ++j) {
      const float dv = dhs[row * HP + j];
#pragma unroll
      for (int i = 0; i < CW; ++i) acc[i] = fmaf(dv, w1s[j * D + grp * CW + i], acc[i]);
    }
  }
  float* dxr = dx + (r0 + row) * D + grp * CW;
#pragma unroll
  for (int i = 0; i < CW; ++i) dxr[i] = acc[i] + dyr[grp * CW + i];
}

// The f32 counterpart of pass 2: grid (Ma / 64 * Nb / 64, splits), 256
// threads, each a 4 x 4 block of the 64 x 64 tile, 16 rows of A and B
// staged at a time.
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
  ffn_sum_parts_kernel<T><<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(
      parts, S, count, static_cast<T*>(out));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(int is_bf16, const void* x, const void* dy, const void* w1,
                       const void* b1, const void* w2, void* dx, void* dw1, void* db1,
                       void* dw2, void* db2, void* hbuf, void* dhbuf, float* pb1,
                       float* pb2, float* pw1, float* pw2, long long M, int F, int S,
                       cudaStream_t st) {
  const int nblk = static_cast<int>(M / kRows);
  const long long per_split = ((M / kTile + S - 1) / S) * kTile;
  const dim3 grid_w1(F / kTile * (D / kTile), S), grid_w2(D / kTile * (F / kTile), S);
  cudaError_t err;
  if (is_bf16) {
    constexpr size_t smem = rows_bf16_smem<D>();
    if ((err = vst::allow_smem(ffn_bwd_rows_bf16_kernel<D>, smem)) != cudaSuccess) return err;
    ffn_bwd_rows_bf16_kernel<D><<<nblk, kThreads, smem, st>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(dy), static_cast<const bf*>(w1),
        static_cast<const bf*>(b1), static_cast<const bf*>(w2), static_cast<bf*>(dx),
        static_cast<bf*>(hbuf), static_cast<bf*>(dhbuf), pb1, pb2, F);
    // dW1 [F, D] = dh^T x,  dW2 [D, F] = dy^T h
    ffn_wgrad_bf16_kernel<<<grid_w1, kThreads, 0, st>>>(
        static_cast<const bf*>(dhbuf), static_cast<const bf*>(x), pw1, M, F, D, per_split);
    ffn_wgrad_bf16_kernel<<<grid_w2, kThreads, 0, st>>>(
        static_cast<const bf*>(dy), static_cast<const bf*>(hbuf), pw2, M, D, F, per_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = sum_parts<bf>(pw1, S, (long long)F * D, dw1, st)) != cudaSuccess) return err;
    if ((err = sum_parts<bf>(pw2, S, (long long)D * F, dw2, st)) != cudaSuccess) return err;
    if ((err = sum_parts<bf>(pb1, nblk, F, db1, st)) != cudaSuccess) return err;
    return sum_parts<bf>(pb2, nblk, D, db2, st);
  }
  constexpr size_t smem = rows_f32_smem<D>();
  if ((err = vst::allow_smem(ffn_bwd_rows_f32_kernel<D>, smem)) != cudaSuccess) return err;
  ffn_bwd_rows_f32_kernel<D><<<nblk, kF32Threads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<float*>(dx), static_cast<float*>(hbuf),
      static_cast<float*>(dhbuf), pb1, pb2, F);
  ffn_wgrad_f32_kernel<<<grid_w1, kF32Threads, 0, st>>>(
      static_cast<const float*>(dhbuf), static_cast<const float*>(x), pw1, M, F, D, per_split);
  ffn_wgrad_f32_kernel<<<grid_w2, kF32Threads, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(hbuf), pw2, M, D, F, per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_parts<float>(pw1, S, (long long)F * D, dw1, st)) != cudaSuccess) return err;
  if ((err = sum_parts<float>(pw2, S, (long long)D * F, dw2, st)) != cudaSuccess) return err;
  if ((err = sum_parts<float>(pb1, nblk, F, db1, st)) != cudaSuccess) return err;
  return sum_parts<float>(pb2, nblk, D, db2, st);
}

}  // namespace

// x, dy, dx: [M, D]; w1, dw1: [F, D]; b1, db1: [F]; w2, dw2: [D, F]; db2:
// [D]; hbuf, dhbuf (scratch): [M, F];
// all contiguous, one dtype (bf16 if is_bf16, else f32), 16-byte aligned.
// pb1 [M / 64, F], pb2 [M / 64, D], pw1 [S, F, D], pw2 [S, D, F]: f32
// scratch. M % 64 == 0, F % 64 == 0, D 128 or 256 (cudaErrorInvalidValue
// otherwise). The caller checks all of it. Launches the three passes in
// order on `stream`; returns the first launch error, or
// cudaGetLastError() after the last launch.
extern "C" int vst_ffn_bwd(int is_bf16, const void* x, const void* dy, const void* w1,
                           const void* b1, const void* w2, void* dx, void* dw1, void* db1,
                           void* dw2, void* db2, void* hbuf, void* dhbuf, void* pb1,
                           void* pb2, void* pw1, void* pw2, long long M, int D, int F, int S,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *p1 = static_cast<float*>(pb1), *p2 = static_cast<float*>(pb2);
  float *q1 = static_cast<float*>(pw1), *q2 = static_cast<float*>(pw2);
  cudaError_t err;
  switch (D) {
    case 128:
      err = launch_bwd<128>(is_bf16, x, dy, w1, b1, w2, dx, dw1, db1, dw2, db2, hbuf, dhbuf,
                            p1, p2, q1, q2, M, F, S, st);
      break;
    case 256:
      err = launch_bwd<256>(is_bf16, x, dy, w1, b1, w2, dx, dw1, db1, dw2, db2, hbuf, dhbuf,
                            p1, p2, q1, q2, M, F, S, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
