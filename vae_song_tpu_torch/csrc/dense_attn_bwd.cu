// Dense attention backward for Hopper (sm_90a), [B, N, H, D] layout read
// through strides, head width D = 64.
//
// Replaces: vae_song_tpu/ops/denseattn.py:_bwd_kernel_packed (called
// through _call_bwd_packed). Same function and roundings, with cd the
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
// What bounds it here: the TPU kernel walks query-row blocks in grid
// order and adds dK/dV across them in VMEM scratch, which is safe only
// because a TPU grid runs in sequence (denseattn.py:490-507). Hopper
// blocks run at once, in no order. So the backward is split FA2-style
// into three kernels on one stream, with no atomics and a result that is
// the same on every run:
//   1. delta: one thread per (b, n, h) row, rowsum(dO * O);
//   2. dK/dV: one block per (b, h, 64-key tile), looping over all query
//      tiles inside the block and holding its dK/dV rows in registers;
//   3. dQ: one block per (b, h, 64-query tile), looping over all key
//      tiles.
// P and dP are recomputed in kernels 2 and 3 (about 20% more tensor-core
// work than a fused kernel with f32 atomics on dQ). At B = 64, N = 2048,
// H = 4 one call is 10 B H N^2 D = 1.4e12 flop against ~0.5 GB of
// operand traffic, so the tensor cores bound it. The bf16 path runs the
// same mma.sync m16n8k16 fragments and the same exp2 rounding as the
// forward (mma_bf16.cuh). Kernel 2 computes the scores transposed
// (S^T = K qc^T, keys on the M side), so P^T and dS^T sit in the
// accumulator layout that is also the A operand of dV = P^T dO and
// dK = dS^T qc. Loads are synchronous and single-buffered; wgmma, TMA and
// a load pipeline are left to the PRs that make it fast.
//
// f32 inputs (mixed_precision: false) take plain FMA kernels of the same
// three-pass shape: one thread per key row (dK/dV) or query row (dQ).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using vst::acc_to_a;
using vst::exp2_bf16;
using vst::ld_u32;
using vst::load_a_rows;
using vst::mma_16816;
using vst::pack_bf16;
using vst::round_bf16;

constexpr int kD = 64;         // head width
constexpr int kBlock = 64;     // rows per tile (4 warps x 16)
constexpr int kThreads = 128;
constexpr int kLds = kD + 8;   // padded row, as in the forward
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, n, h;
};

// ---- delta = round_cd(rowsum(dO * O)), [B, H, N] f32 -------------------

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                      float* __restrict__ delta, int H, int N, long long rows,
                      Strides os) {
  const long long r = (long long)blockIdx.x * 256 + threadIdx.x;
  if (r >= rows) return;
  const int h = r % H;
  const int n = (r / H) % N;
  const int b = r / ((long long)H * N);
  const long long off = b * os.b + n * os.n + h * os.h;
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) acc = fmaf(to_f(d_o[off + d]), to_f(o[off + d]), acc);
  if (sizeof(T) == 2) acc = round_bf16(acc);
  delta[((long long)b * H + h) * N + n] = acc;
}

// ---- bf16: dK / dV ------------------------------------------------------

// Grid (N / 64, H, B), 128 threads. Warp w owns keys k0 + 16w .. + 15.
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ d_o,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int H, int N,
                          Strides s, Strides os, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlock][kLds];       // qc [q][d]
  __shared__ __align__(16) __nv_bfloat16 qt[kD][kBlock + 8];     // qc^T [d][q]
  __shared__ __align__(16) __nv_bfloat16 dos[kBlock][kLds];      // dO [q][d]
  __shared__ __align__(16) __nv_bfloat16 dot[kD][kBlock + 8];    // dO^T [d][q]
  __shared__ float ls[kBlock], dls[kBlock];

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = (long long)b * s.b + (long long)h * s.h;
  const long long ohead = (long long)b * os.b + (long long)h * os.h;
  const float* lrow = lse + ((long long)b * H + h) * N;
  const float* drow = delta + ((long long)b * H + h) * N;

  // K and V rows of this block, staged through qs / dos into A fragments
  for (int i = tid; i < kBlock * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    const long long off = head + (long long)(k0 + r) * s.n + c;
    *reinterpret_cast<uint4*>(&qs[r][c]) = *reinterpret_cast<const uint4*>(k + off);
    *reinterpret_cast<uint4*>(&dos[r][c]) = *reinterpret_cast<const uint4*>(v + off);
  }
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a_rows<kLds>(qs, warp * 16, g, t, ka);
  load_a_rows<kLds>(dos, warp * 16, g, t, va);

  float adk[kD / 8][4], adv[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tiles
    for (int i = tid; i < kBlock * kD / 8; i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      uint4 raw = *reinterpret_cast<const uint4*>(q + head + (long long)(q0 + r) * s.n + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
        qt[c + j][r] = e[j];
      }
      *reinterpret_cast<uint4*>(&qs[r][c]) = raw;
      uint4 graw = *reinterpret_cast<const uint4*>(d_o + ohead + (long long)(q0 + r) * os.n + c);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&graw);
#pragma unroll
      for (int j = 0; j < 8; ++j) dot[c + j][r] = ge[j];
      *reinterpret_cast<uint4*>(&dos[r][c]) = graw;
    }
    if (tid < kBlock) {
      ls[tid] = lrow[q0 + tid];
      dls[tid] = drow[q0 + tid];
    }
    __syncthreads();

    // S^T = K qc^T (16 keys x 64 queries), then P^T
    float p[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* br = &qs[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(p[nt], ka[kk], ld_u32(br), ld_u32(br + 8));
      }
      const float l0 = ls[nt * 8 + 2 * t], l1 = ls[nt * 8 + 2 * t + 1];
      p[nt][0] = exp2_bf16(p[nt][0] - l0);
      p[nt][1] = exp2_bf16(p[nt][1] - l1);
      p[nt][2] = exp2_bf16(p[nt][2] - l0);
      p[nt][3] = exp2_bf16(p[nt][3] - l1);
    }

    // dV += P^T dO
#pragma unroll
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(p, kc, pa);
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const __nv_bfloat16* br = &dot[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(adv[dt], pa, ld_u32(br), ld_u32(br + 8));
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
    float ds[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
      ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* br = &dos[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(ds[nt], va[kk], ld_u32(br), ld_u32(br + 8));
      }
      const float d0 = dls[nt * 8 + 2 * t], d1 = dls[nt * 8 + 2 * t + 1];
      ds[nt][0] = round_bf16(p[nt][0] * round_bf16(round_bf16(ds[nt][0]) - d0));
      ds[nt][1] = round_bf16(p[nt][1] * round_bf16(round_bf16(ds[nt][1]) - d1));
      ds[nt][2] = round_bf16(p[nt][2] * round_bf16(round_bf16(ds[nt][2]) - d0));
      ds[nt][3] = round_bf16(p[nt][3] * round_bf16(round_bf16(ds[nt][3]) - d1));
    }

    // dK += dS^T qc
#pragma unroll
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      uint32_t sa[4];
      acc_to_a(ds, kc, sa);
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const __nv_bfloat16* br = &qt[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(adk[dt], sa, ld_u32(br), ld_u32(br + 8));
      }
    }
  }

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const long long o0 = ohead + (long long)r0 * os.n, o1 = ohead + (long long)r1 * os.n;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + o0 + c) = pack_bf16(adk[dt][0] * kLn2, adk[dt][1] * kLn2);
    *reinterpret_cast<uint32_t*>(dk + o1 + c) = pack_bf16(adk[dt][2] * kLn2, adk[dt][3] * kLn2);
    *reinterpret_cast<uint32_t*>(dv + o0 + c) = pack_bf16(adv[dt][0], adv[dt][1]);
    *reinterpret_cast<uint32_t*>(dv + o1 + c) = pack_bf16(adv[dt][2], adv[dt][3]);
  }
}

// ---- bf16: dQ -------------------------------------------------------------

// Grid (N / 64, H, B), 128 threads. Warp w owns queries q0 + 16w .. + 15.
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int N,
                        Strides s, Strides os, float qscale, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlock][kLds];    // K [key][d]
  __shared__ __align__(16) __nv_bfloat16 vs[kBlock][kLds];    // V [key][d]
  __shared__ __align__(16) __nv_bfloat16 kt[kD][kBlock + 8];  // K^T [d][key]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = (long long)b * s.b + (long long)h * s.h;
  const long long ohead = (long long)b * os.b + (long long)h * os.h;

  // qc and dO rows of this block, staged through ks / vs into A fragments
  for (int i = tid; i < kBlock * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(q + head + (long long)(q0 + r) * s.n + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
    *reinterpret_cast<uint4*>(&ks[r][c]) = raw;
    *reinterpret_cast<uint4*>(&vs[r][c]) =
        *reinterpret_cast<const uint4*>(d_o + ohead + (long long)(q0 + r) * os.n + c);
  }
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a_rows<kLds>(ks, warp * 16, g, t, qa);
  load_a_rows<kLds>(vs, warp * 16, g, t, da);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long hrow = ((long long)b * H + h) * N;
  const float l0 = lse[hrow + r0], l1 = lse[hrow + r1];
  const float d0 = delta[hrow + r0], d1 = delta[hrow + r1];

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBlock) {
    __syncthreads();
    for (int i = tid; i < kBlock * kD / 8; i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const long long off = head + (long long)(k0 + r) * s.n + c;
      const uint4 kraw = *reinterpret_cast<const uint4*>(k + off);
      *reinterpret_cast<uint4*>(&ks[r][c]) = kraw;
      *reinterpret_cast<uint4*>(&vs[r][c]) = *reinterpret_cast<const uint4*>(v + off);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&kraw);
#pragma unroll
      for (int j = 0; j < 8; ++j) kt[c + j][r] = e[j];
    }
    __syncthreads();

    // S = qc K^T (16 queries x 64 keys), then P
    float p[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* br = &ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(p[nt], qa[kk], ld_u32(br), ld_u32(br + 8));
      }
      p[nt][0] = exp2_bf16(p[nt][0] - l0);
      p[nt][1] = exp2_bf16(p[nt][1] - l0);
      p[nt][2] = exp2_bf16(p[nt][2] - l1);
      p[nt][3] = exp2_bf16(p[nt][3] - l1);
    }

    // dP = dO V^T, then dS = P (dP - delta)
    float ds[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
      ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* br = &vs[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(ds[nt], da[kk], ld_u32(br), ld_u32(br + 8));
      }
      ds[nt][0] = round_bf16(p[nt][0] * round_bf16(round_bf16(ds[nt][0]) - d0));
      ds[nt][1] = round_bf16(p[nt][1] * round_bf16(round_bf16(ds[nt][1]) - d0));
      ds[nt][2] = round_bf16(p[nt][2] * round_bf16(round_bf16(ds[nt][2]) - d1));
      ds[nt][3] = round_bf16(p[nt][3] * round_bf16(round_bf16(ds[nt][3]) - d1));
    }

    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      uint32_t sa[4];
      acc_to_a(ds, kc, sa);
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const __nv_bfloat16* br = &kt[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[dt], sa, ld_u32(br), ld_u32(br + 8));
      }
    }
  }

  const long long o0 = ohead + (long long)r0 * os.n, o1 = ohead + (long long)r1 * os.n;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dq + o0 + c) = pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    *reinterpret_cast<uint32_t*>(dq + o1 + c) = pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---- f32: plain FMA kernels ----------------------------------------------

constexpr int kF32Rows = 64;   // rows per block, one per thread
constexpr int kF32Tile = 16;   // rows of the other side per shared tile
constexpr int kPad = kD + 1;   // per-thread rows: stride 65 avoids bank conflicts

// Grid (N / 64, H, B), 64 threads; thread i owns key row k0 + i.
__global__ void __launch_bounds__(kF32Rows)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_o,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int N,
                         Strides s, Strides os, float qscale) {
  __shared__ float kr[kF32Rows][kPad], vr[kF32Rows][kPad];
  __shared__ __align__(16) float qs[kF32Tile][kD], dos[kF32Tile][kD];
  __shared__ float ls[kF32Tile], dls[kF32Tile];

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int key = blockIdx.x * kF32Rows + tid;
  const long long head = (long long)b * s.b + (long long)h * s.h;
  const long long ohead = (long long)b * os.b + (long long)h * os.h;
  const float* lrow = lse + ((long long)b * H + h) * N;
  const float* drow = delta + ((long long)b * H + h) * N;
  for (int d = 0; d < kD; ++d) {
    kr[tid][d] = k[head + (long long)key * s.n + d];
    vr[tid][d] = v[head + (long long)key * s.n + d];
  }
  float adk[kD], adv[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) adk[d] = adv[d] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kF32Tile) {
    __syncthreads();
    for (int i = tid; i < kF32Tile * kD; i += kF32Rows) {
      const int r = i / kD, c = i % kD;
      qs[r][c] = q[head + (long long)(q0 + r) * s.n + c] * qscale;
      dos[r][c] = d_o[ohead + (long long)(q0 + r) * os.n + c];
    }
    if (tid < kF32Tile) {
      ls[tid] = lrow[q0 + tid];
      dls[tid] = drow[q0 + tid];
    }
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        sc = fmaf(kr[tid][d], qs[j][d], sc);
        dp = fmaf(vr[tid][d], dos[j][d], dp);
      }
      const float p = exp2f(sc - ls[j]);
      const float ds = p * (dp - dls[j]);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        adv[d] = fmaf(p, dos[j][d], adv[d]);
        adk[d] = fmaf(ds, qs[j][d], adk[d]);
      }
    }
  }
  const long long out = ohead + (long long)key * os.n;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    dk[out + d] = adk[d] * kLn2;
    dv[out + d] = adv[d];
  }
}

// Grid (N / 64, H, B), 64 threads; thread i owns query row q0 + i.
__global__ void __launch_bounds__(kF32Rows)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ d_o,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int H, int N, Strides s, Strides os,
                       float qscale, float scale) {
  __shared__ float qr[kF32Rows][kPad], dr[kF32Rows][kPad];
  __shared__ __align__(16) float ks[kF32Tile][kD], vs[kF32Tile][kD];

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int row = blockIdx.x * kF32Rows + tid;
  const long long head = (long long)b * s.b + (long long)h * s.h;
  const long long ohead = (long long)b * os.b + (long long)h * os.h;
  for (int d = 0; d < kD; ++d) {
    qr[tid][d] = q[head + (long long)row * s.n + d] * qscale;
    dr[tid][d] = d_o[ohead + (long long)row * os.n + d];
  }
  const long long hrow = ((long long)b * H + h) * N;
  const float l = lse[hrow + row], dl = delta[hrow + row];
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kF32Tile) {
    __syncthreads();
    for (int i = tid; i < kF32Tile * kD; i += kF32Rows) {
      const int r = i / kD, c = i % kD;
      ks[r][c] = k[head + (long long)(k0 + r) * s.n + c];
      vs[r][c] = v[head + (long long)(k0 + r) * s.n + c];
    }
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        sc = fmaf(qr[tid][d], ks[j][d], sc);
        dp = fmaf(dr[tid][d], vs[j][d], dp);
      }
      const float ds = exp2f(sc - l) * (dp - dl);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }
  const long long out = ohead + (long long)row * os.n;
#pragma unroll
  for (int d = 0; d < kD; ++d) dq[out + d] = acc[d] * scale;
}

}  // namespace

// q, k, v: [B, N, H, 64] with element strides (sb, sn, sh, 1), 16-byte
// aligned rows; o, dO, dq, dk, dv: [B, N, H, 64] with strides (ob, on, oh,
// 1); lse and delta (scratch): [B, H, N] f32, contiguous. N % 64 == 0.
// The caller checks all of it. Launches delta, dK/dV and dQ in order on
// `stream`; returns cudaGetLastError() after the launches.
extern "C" int vst_dense_attn_bwd(int is_bf16, const void* q, const void* k,
                                  const void* v, const void* o, const void* d_o,
                                  const void* lse, void* delta, void* dq, void* dk,
                                  void* dv, int B, int H, int N, long long sb,
                                  long long sn, long long sh, long long ob,
                                  long long on, long long oh, float qscale,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{sb, sn, sh}, os{ob, on, oh};
  const long long rows = (long long)B * N * H;
  const unsigned delta_blocks = static_cast<unsigned>((rows + 255) / 256);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (is_bf16) {
    using bf = __nv_bfloat16;
    attn_bwd_delta_kernel<bf><<<delta_blocks, 256, 0, st>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(d_o), dl, H, N, rows, os);
    const dim3 grid(N / kBlock, H, B);
    attn_bwd_dkdv_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(d_o), l, dl, static_cast<bf*>(dk), static_cast<bf*>(dv),
        H, N, s, os, qscale);
    attn_bwd_dq_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(d_o), l, dl, static_cast<bf*>(dq), H, N, s, os, qscale,
        scale);
  } else {
    attn_bwd_delta_kernel<float><<<delta_blocks, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(d_o), dl, H, N, rows, os);
    const dim3 grid(N / kF32Rows, H, B);
    attn_bwd_dkdv_f32_kernel<<<grid, kF32Rows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(d_o), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), H, N, s, os, qscale);
    attn_bwd_dq_f32_kernel<<<grid, kF32Rows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(d_o), l, dl,
        static_cast<float*>(dq), H, N, s, os, qscale, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
