// Dense attention backward for Hopper (sm_90a), [B, N, H, D] layout read
// through strides, head width D a compile-time 64, 128, 192 or 256.
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
// Wider heads. A block owns 64 columns of its dK/dV or dQ rows: at
// D > 64 the grid carries D / 64 column chunks, and each chunk's block
// recomputes S and dP over the whole head width (the contraction is over
// D). That keeps the accumulators at 64 columns (64 registers a thread for
// dK and dV) at every D; the K/V (or qc/dO) A fragments are held in
// registers at D = 64 and reloaded from shared memory per 16-wide chunk
// above it. The tiles grow with D (154 KB for dK/dV at D = 256), so shared
// memory is dynamic, granted per instantiation. At D = 64 there is one
// chunk and the kernels do what the 64-wide kernels did.
//
// f32 inputs (mixed_precision: false) take plain FMA kernels of the same
// three-pass shape: one thread per key row (dK/dV) or query row (dQ), its
// row of K/V (or qc/dO) in shared memory, 64 output columns a block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using vst::acc_to_a;
using vst::exp2_bf16;
using vst::ld_u32;
using vst::load_a_chunk;
using vst::load_a_rows;
using vst::mma_16816;
using vst::pack_bf16;
using vst::round_bf16;

constexpr int kBlock = 64;     // rows per tile (4 warps x 16)
constexpr int kCols = 64;      // output columns per block
constexpr int kThreads = 128;
constexpr int kLdt = kBlock + 8;   // padded row of a transposed tile
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

template <typename T, int D>
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
  for (int d = 0; d < D; ++d) acc = fmaf(to_f(d_o[off + d]), to_f(o[off + d]), acc);
  if (sizeof(T) == 2) acc = round_bf16(acc);
  delta[((long long)b * H + h) * N + n] = acc;
}

// Shared tiles of the bf16 kernels, in bf16 elements: four [64][D + 8]
// row tiles and two [64][72] transposed column-chunk tiles; at D = 64 the
// first two row tiles (K/V or qc/dO, staged once into register
// fragments) alias the next two, as the 64-wide kernels had it.
template <int D>
constexpr size_t bwd_bf16_smem() {
  return ((D == 64 ? 2 : 4) * kBlock * (D + 8) + 2 * kCols * kLdt) * sizeof(__nv_bfloat16) +
         2 * kBlock * sizeof(float);
}

// ---- bf16: dK / dV ------------------------------------------------------

// Grid (N / 64 * D / 64, H, B), 128 threads; block x = 64-key tile * D / 64
// + column chunk. Warp w owns keys k0 + 16w .. + 15, columns c0 .. c0 + 63.
template <int D>
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
  constexpr int LD = D + 8;
  constexpr int KC = D / 16;
  constexpr bool kFragRegs = D == 64;
  using Row = __nv_bfloat16[LD];
  using Col = __nv_bfloat16[kLdt];
  extern __shared__ __align__(16) unsigned char smem[];
  Row* qs = reinterpret_cast<Row*>(smem);                          // qc [q][d]
  Row* dos = qs + kBlock;                                          // dO [q][d]
  Row* kts = kFragRegs ? qs : dos + kBlock;                        // K [key][d]
  Row* vts = kFragRegs ? dos : dos + 2 * kBlock;                   // V [key][d]
  Col* qt = reinterpret_cast<Col*>(kFragRegs ? dos + kBlock : dos + 3 * kBlock);  // qc^T
  Col* dot = qt + kCols;                                           // dO^T [c][q]
  float* ls = reinterpret_cast<float*>(dot + kCols);
  float* dls = ls + kBlock;

  constexpr int kChunks = D / kCols;
  const int c0 = (blockIdx.x % kChunks) * kCols;
  const int k0 = (blockIdx.x / kChunks) * kBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = (long long)b * s.b + (long long)h * s.h;
  const long long ohead = (long long)b * os.b + (long long)h * os.h;
  const float* lrow = lse + ((long long)b * H + h) * N;
  const float* drow = delta + ((long long)b * H + h) * N;

  // K and V rows of this block
  for (int i = tid; i < kBlock * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const long long off = head + (long long)(k0 + r) * s.n + c;
    *reinterpret_cast<uint4*>(&kts[r][c]) = *reinterpret_cast<const uint4*>(k + off);
    *reinterpret_cast<uint4*>(&vts[r][c]) = *reinterpret_cast<const uint4*>(v + off);
  }
  __syncthreads();
  uint32_t ka[kFragRegs ? KC : 1][4], va[kFragRegs ? KC : 1][4];
  if constexpr (kFragRegs) {
    load_a_rows<LD, KC>(kts, warp * 16, g, t, ka);
    load_a_rows<LD, KC>(vts, warp * 16, g, t, va);
  }

  float adk[kCols / 8][4], adv[kCols / 8][4];
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tiles
    for (int i = tid; i < kBlock * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool mine = c >= c0 && c < c0 + kCols;
      uint4 raw = *reinterpret_cast<const uint4*>(q + head + (long long)(q0 + r) * s.n + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
        if (mine) qt[c - c0 + j][r] = e[j];
      }
      *reinterpret_cast<uint4*>(&qs[r][c]) = raw;
      uint4 graw = *reinterpret_cast<const uint4*>(d_o + ohead + (long long)(q0 + r) * os.n + c);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&graw);
      if (mine) {
#pragma unroll
        for (int j = 0; j < 8; ++j) dot[c - c0 + j][r] = ge[j];
      }
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
    for (int nt = 0; nt < kBlock / 8; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t a[4];
      if constexpr (kFragRegs) {
        a[0] = ka[kk][0]; a[1] = ka[kk][1]; a[2] = ka[kk][2]; a[3] = ka[kk][3];
      } else {
        load_a_chunk<LD>(kts, warp * 16, kk, g, t, a);
      }
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
        const __nv_bfloat16* br = &qs[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(p[nt], a, ld_u32(br), ld_u32(br + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
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
      for (int dt = 0; dt < kCols / 8; ++dt) {
        const __nv_bfloat16* br = &dot[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(adv[dt], pa, ld_u32(br), ld_u32(br + 8));
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
    float ds[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t a[4];
      if constexpr (kFragRegs) {
        a[0] = va[kk][0]; a[1] = va[kk][1]; a[2] = va[kk][2]; a[3] = va[kk][3];
      } else {
        load_a_chunk<LD>(vts, warp * 16, kk, g, t, a);
      }
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
        const __nv_bfloat16* br = &dos[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(ds[nt], a, ld_u32(br), ld_u32(br + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
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
      for (int dt = 0; dt < kCols / 8; ++dt) {
        const __nv_bfloat16* br = &qt[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(adk[dt], sa, ld_u32(br), ld_u32(br + 8));
      }
    }
  }

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const long long o0 = ohead + (long long)r0 * os.n + c0, o1 = ohead + (long long)r1 * os.n + c0;
#pragma unroll
  for (int dt = 0; dt < kCols / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + o0 + c) = pack_bf16(adk[dt][0] * kLn2, adk[dt][1] * kLn2);
    *reinterpret_cast<uint32_t*>(dk + o1 + c) = pack_bf16(adk[dt][2] * kLn2, adk[dt][3] * kLn2);
    *reinterpret_cast<uint32_t*>(dv + o0 + c) = pack_bf16(adv[dt][0], adv[dt][1]);
    *reinterpret_cast<uint32_t*>(dv + o1 + c) = pack_bf16(adv[dt][2], adv[dt][3]);
  }
}

// ---- bf16: dQ -------------------------------------------------------------

// Grid (N / 64 * D / 64, H, B), 128 threads; block x = 64-query tile *
// D / 64 + column chunk. Warp w owns queries q0 + 16w .. + 15, columns
// c0 .. c0 + 63.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int N,
                        Strides s, Strides os, float qscale, float scale) {
  constexpr int LD = D + 8;
  constexpr int KC = D / 16;
  constexpr bool kFragRegs = D == 64;
  using Row = __nv_bfloat16[LD];
  using Col = __nv_bfloat16[kLdt];
  extern __shared__ __align__(16) unsigned char smem[];
  Row* ks = reinterpret_cast<Row*>(smem);                          // K [key][d]
  Row* vs = ks + kBlock;                                           // V [key][d]
  Row* qas = kFragRegs ? ks : vs + kBlock;                         // qc [q][d]
  Row* das = kFragRegs ? vs : vs + 2 * kBlock;                     // dO [q][d]
  Col* kt = reinterpret_cast<Col*>(kFragRegs ? vs + kBlock : vs + 3 * kBlock);  // K^T [c][key]

  constexpr int kChunks = D / kCols;
  const int c0 = (blockIdx.x % kChunks) * kCols;
  const int q0 = (blockIdx.x / kChunks) * kBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = (long long)b * s.b + (long long)h * s.h;
  const long long ohead = (long long)b * os.b + (long long)h * os.h;

  // qc and dO rows of this block
  for (int i = tid; i < kBlock * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(q + head + (long long)(q0 + r) * s.n + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
    *reinterpret_cast<uint4*>(&qas[r][c]) = raw;
    *reinterpret_cast<uint4*>(&das[r][c]) =
        *reinterpret_cast<const uint4*>(d_o + ohead + (long long)(q0 + r) * os.n + c);
  }
  __syncthreads();
  uint32_t qa[kFragRegs ? KC : 1][4], da[kFragRegs ? KC : 1][4];
  if constexpr (kFragRegs) {
    load_a_rows<LD, KC>(qas, warp * 16, g, t, qa);
    load_a_rows<LD, KC>(das, warp * 16, g, t, da);
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long hrow = ((long long)b * H + h) * N;
  const float l0 = lse[hrow + r0], l1 = lse[hrow + r1];
  const float d0 = delta[hrow + r0], d1 = delta[hrow + r1];

  float acc[kCols / 8][4];
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBlock) {
    __syncthreads();
    for (int i = tid; i < kBlock * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const long long off = head + (long long)(k0 + r) * s.n + c;
      const uint4 kraw = *reinterpret_cast<const uint4*>(k + off);
      *reinterpret_cast<uint4*>(&ks[r][c]) = kraw;
      *reinterpret_cast<uint4*>(&vs[r][c]) = *reinterpret_cast<const uint4*>(v + off);
      if (c >= c0 && c < c0 + kCols) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&kraw);
#pragma unroll
        for (int j = 0; j < 8; ++j) kt[c - c0 + j][r] = e[j];
      }
    }
    __syncthreads();

    // S = qc K^T (16 queries x 64 keys), then P
    float p[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t a[4];
      if constexpr (kFragRegs) {
        a[0] = qa[kk][0]; a[1] = qa[kk][1]; a[2] = qa[kk][2]; a[3] = qa[kk][3];
      } else {
        load_a_chunk<LD>(qas, warp * 16, kk, g, t, a);
      }
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
        const __nv_bfloat16* br = &ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(p[nt], a, ld_u32(br), ld_u32(br + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
      p[nt][0] = exp2_bf16(p[nt][0] - l0);
      p[nt][1] = exp2_bf16(p[nt][1] - l0);
      p[nt][2] = exp2_bf16(p[nt][2] - l1);
      p[nt][3] = exp2_bf16(p[nt][3] - l1);
    }

    // dP = dO V^T, then dS = P (dP - delta)
    float ds[kBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t a[4];
      if constexpr (kFragRegs) {
        a[0] = da[kk][0]; a[1] = da[kk][1]; a[2] = da[kk][2]; a[3] = da[kk][3];
      } else {
        load_a_chunk<LD>(das, warp * 16, kk, g, t, a);
      }
#pragma unroll
      for (int nt = 0; nt < kBlock / 8; ++nt) {
        const __nv_bfloat16* br = &vs[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(ds[nt], a, ld_u32(br), ld_u32(br + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
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
      for (int dt = 0; dt < kCols / 8; ++dt) {
        const __nv_bfloat16* br = &kt[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[dt], sa, ld_u32(br), ld_u32(br + 8));
      }
    }
  }

  const long long o0 = ohead + (long long)r0 * os.n + c0, o1 = ohead + (long long)r1 * os.n + c0;
#pragma unroll
  for (int dt = 0; dt < kCols / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dq + o0 + c) = pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    *reinterpret_cast<uint32_t*>(dq + o1 + c) = pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---- f32: plain FMA kernels ----------------------------------------------

constexpr int kF32Rows = 64;   // rows per block, one per thread
constexpr int kF32Tile = 16;   // rows of the other side per shared tile

// Two [64][D + 1] per-thread row tiles (stride D + 1 avoids bank
// conflicts), two [16][D] tiles of the other side, two [16] vectors.
template <int D>
constexpr size_t bwd_f32_smem() {
  return (2 * kF32Rows * (D + 1) + 2 * kF32Tile * D + 2 * kF32Tile) * sizeof(float);
}

// Grid (N / 64 * D / 64, H, B), 64 threads; thread i owns key row k0 + i,
// columns c0 .. c0 + 63.
template <int D>
__global__ void __launch_bounds__(kF32Rows)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_o,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int N,
                         Strides s, Strides os, float qscale) {
  constexpr int P = D + 1;
  extern __shared__ __align__(16) float fsm[];
  float* kr = fsm;                       // [64][D + 1]
  float* vr = kr + kF32Rows * P;         // [64][D + 1]
  float* qs = vr + kF32Rows * P;         // [16][D]
  float* dos = qs + kF32Tile * D;        // [16][D]
  float* ls = dos + kF32Tile * D;
  float* dls = ls + kF32Tile;

  constexpr int kChunks = D / kCols;
  const int c0 = (blockIdx.x % kChunks) * kCols;
  const int kb = (blockIdx.x / kChunks) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int key = kb + tid;
  const long long head = (long long)b * s.b + (long long)h * s.h;
  const long long ohead = (long long)b * os.b + (long long)h * os.h;
  const float* lrow = lse + ((long long)b * H + h) * N;
  const float* drow = delta + ((long long)b * H + h) * N;
  for (int i = tid; i < kF32Rows * D; i += kF32Rows) {
    const int r = i / D, c = i % D;
    kr[r * P + c] = k[head + (long long)(kb + r) * s.n + c];
    vr[r * P + c] = v[head + (long long)(kb + r) * s.n + c];
  }
  const float* myk = kr + tid * P;
  const float* myv = vr + tid * P;
  float adk[kCols], adv[kCols];
#pragma unroll
  for (int d = 0; d < kCols; ++d) adk[d] = adv[d] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kF32Tile) {
    __syncthreads();
    for (int i = tid; i < kF32Tile * D; i += kF32Rows) {
      const int r = i / D, c = i % D;
      qs[i] = q[head + (long long)(q0 + r) * s.n + c] * qscale;
      dos[i] = d_o[ohead + (long long)(q0 + r) * os.n + c];
    }
    if (tid < kF32Tile) {
      ls[tid] = lrow[q0 + tid];
      dls[tid] = drow[q0 + tid];
    }
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        sc = fmaf(myk[d], qs[j * D + d], sc);
        dp = fmaf(myv[d], dos[j * D + d], dp);
      }
      const float p = exp2f(sc - ls[j]);
      const float ds = p * (dp - dls[j]);
#pragma unroll
      for (int d = 0; d < kCols; ++d) {
        adv[d] = fmaf(p, dos[j * D + c0 + d], adv[d]);
        adk[d] = fmaf(ds, qs[j * D + c0 + d], adk[d]);
      }
    }
  }
  const long long out = ohead + (long long)key * os.n + c0;
#pragma unroll
  for (int d = 0; d < kCols; ++d) {
    dk[out + d] = adk[d] * kLn2;
    dv[out + d] = adv[d];
  }
}

// Grid (N / 64 * D / 64, H, B), 64 threads; thread i owns query row
// q0 + i, columns c0 .. c0 + 63.
template <int D>
__global__ void __launch_bounds__(kF32Rows)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ d_o,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int H, int N, Strides s, Strides os,
                       float qscale, float scale) {
  constexpr int P = D + 1;
  extern __shared__ __align__(16) float fsm[];
  float* qr = fsm;                       // [64][D + 1]
  float* dr = qr + kF32Rows * P;         // [64][D + 1]
  float* ks = dr + kF32Rows * P;         // [16][D]
  float* vs = ks + kF32Tile * D;         // [16][D]

  constexpr int kChunks = D / kCols;
  const int c0 = (blockIdx.x % kChunks) * kCols;
  const int qb = (blockIdx.x / kChunks) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int row = qb + tid;
  const long long head = (long long)b * s.b + (long long)h * s.h;
  const long long ohead = (long long)b * os.b + (long long)h * os.h;
  for (int i = tid; i < kF32Rows * D; i += kF32Rows) {
    const int r = i / D, c = i % D;
    qr[r * P + c] = q[head + (long long)(qb + r) * s.n + c] * qscale;
    dr[r * P + c] = d_o[ohead + (long long)(qb + r) * os.n + c];
  }
  const float* myq = qr + tid * P;
  const float* myd = dr + tid * P;
  const long long hrow = ((long long)b * H + h) * N;
  const float l = lse[hrow + row], dl = delta[hrow + row];
  float acc[kCols];
#pragma unroll
  for (int d = 0; d < kCols; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kF32Tile) {
    __syncthreads();
    for (int i = tid; i < kF32Tile * D; i += kF32Rows) {
      const int r = i / D, c = i % D;
      ks[i] = k[head + (long long)(k0 + r) * s.n + c];
      vs[i] = v[head + (long long)(k0 + r) * s.n + c];
    }
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        sc = fmaf(myq[d], ks[j * D + d], sc);
        dp = fmaf(myd[d], vs[j * D + d], dp);
      }
      const float ds = exp2f(sc - l) * (dp - dl);
#pragma unroll
      for (int d = 0; d < kCols; ++d) acc[d] = fmaf(ds, ks[j * D + c0 + d], acc[d]);
    }
  }
  const long long out = ohead + (long long)row * os.n + c0;
#pragma unroll
  for (int d = 0; d < kCols; ++d) dq[out + d] = acc[d] * scale;
}

template <int D>
cudaError_t launch_bwd(int is_bf16, const void* q, const void* k, const void* v,
                       const void* o, const void* d_o, const void* lse, void* delta,
                       void* dq, void* dk, void* dv, int B, int H, int N, Strides s,
                       Strides os, float qscale, float scale, cudaStream_t st) {
  const long long rows = (long long)B * N * H;
  const unsigned delta_blocks = static_cast<unsigned>((rows + 255) / 256);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const dim3 grid(N / kBlock * (D / kCols), H, B);
  cudaError_t err;
  if (is_bf16) {
    using bf = __nv_bfloat16;
    constexpr size_t smem = bwd_bf16_smem<D>();
    if ((err = vst::allow_smem(attn_bwd_dkdv_bf16_kernel<D>, smem)) != cudaSuccess) return err;
    if ((err = vst::allow_smem(attn_bwd_dq_bf16_kernel<D>, smem)) != cudaSuccess) return err;
    attn_bwd_delta_kernel<bf, D><<<delta_blocks, 256, 0, st>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(d_o), dl, H, N, rows, os);
    attn_bwd_dkdv_bf16_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(d_o), l, dl, static_cast<bf*>(dk), static_cast<bf*>(dv),
        H, N, s, os, qscale);
    attn_bwd_dq_bf16_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(d_o), l, dl, static_cast<bf*>(dq), H, N, s, os, qscale,
        scale);
  } else {
    constexpr size_t smem = bwd_f32_smem<D>();
    if ((err = vst::allow_smem(attn_bwd_dkdv_f32_kernel<D>, smem)) != cudaSuccess) return err;
    if ((err = vst::allow_smem(attn_bwd_dq_f32_kernel<D>, smem)) != cudaSuccess) return err;
    attn_bwd_delta_kernel<float, D><<<delta_blocks, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(d_o), dl, H, N, rows, os);
    attn_bwd_dkdv_f32_kernel<D><<<grid, kF32Rows, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(d_o), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), H, N, s, os, qscale);
    attn_bwd_dq_f32_kernel<D><<<grid, kF32Rows, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(d_o), l, dl,
        static_cast<float*>(dq), H, N, s, os, qscale, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, N, H, D] with element strides (sb, sn, sh, 1), 16-byte
// aligned rows; o, dO, dq, dk, dv: [B, N, H, D] with strides (ob, on, oh,
// 1); lse and delta (scratch): [B, H, N] f32, contiguous. N % 64 == 0, D
// one of 64, 128, 192, 256 (cudaErrorInvalidValue otherwise). The caller
// checks all of it. Launches delta, dK/dV and dQ in order on `stream`;
// returns cudaGetLastError() after the launches.
extern "C" int vst_dense_attn_bwd(int is_bf16, const void* q, const void* k,
                                  const void* v, const void* o, const void* d_o,
                                  const void* lse, void* delta, void* dq, void* dk,
                                  void* dv, int B, int H, int N, int D, long long sb,
                                  long long sn, long long sh, long long ob,
                                  long long on, long long oh, float qscale,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{sb, sn, sh}, os{ob, on, oh};
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch_bwd<64>(is_bf16, q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, N, s, os,
                           qscale, scale, st);
      break;
    case 128:
      err = launch_bwd<128>(is_bf16, q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, N, s, os,
                            qscale, scale, st);
      break;
    case 192:
      err = launch_bwd<192>(is_bf16, q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, N, s, os,
                            qscale, scale, st);
      break;
    case 256:
      err = launch_bwd<256>(is_bf16, q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, N, s, os,
                            qscale, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
