// Split-TF32 wgmma building blocks of the f32 attention kernels
// (dense_attn_tf32.cu at head widths 64 and 128, dense_attn_tf32_wide.cu
// from 192 up): the consumers' A fragments and split, the three-product
// step, the ring's shared memory, the product kernel over a depth of keys or
// queries (O = P V / l over written-out scores, dV, dK, dQ), the split
// pre-pass and the host's persistent-grid helpers. Included once by each of
// the two sources; everything lies in an anonymous namespace, so each
// library object holds the kernels it launches.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;                        // consumers 0, 1; producer 2
constexpr int kConsumerWarps = 8;
constexpr int kTile = 128;                           // a block's rows, and columns of most tiles
constexpr int kDepth = 32;                           // f32 columns of a panel: a stage's depth
constexpr uint32_t kPanel128 = kTile * 128;          // 128 rows x 32 f32 (16 KB)
constexpr uint32_t kPanel64 = 64 * 128;              // 64 rows x 32 f32 (8 KB)
constexpr int kStages = 4;                           // the products and the forward's scores
constexpr uint32_t kStageBytes = 3 * kPanel128;      // A, B big, B small
constexpr size_t kSmem = kStages * kStageBytes + 16 * kStages + 1024;
// The product kernel's stage and shared memory with output tiles of 8 NT
// columns: A, then B big and small (8 NT rows each).
template <int NT>
constexpr uint32_t kProductStage = kPanel128 + 2 * NT * 8 * 128;
template <int NT>
constexpr size_t kProductSmem = kStages * kProductStage<NT> + 16 * kStages + 1024;
constexpr float kLn2 = 0.6931471805599453f;

enum Product { kOut, kGrad, kGradT };   // O = P V / l; dV, dK; dQ (A read transposed)

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// ---- consumers: A fragments and the split-TF32 step ----------------------------

// This thread's A values of one 32-deep panel: x[j] the m16n8k8 TF32 A
// fragment of k-step j (0..3) of warp rows r - g .. r - g + 15: x[j][0] =
// A[r][8 j + t], [1] = A[r + 8][8 j + t], [2] = A[r][8 j + t + 4], [3] =
// A[r + 8][8 j + t + 4], r = the tile row of lane 4 g + t (r % 8 == g).
// K-major panel: row r at 128 r bytes, its 16-byte chunk c at c ^ (r % 8)
// (TMA's 128-byte swizzle). The 32 lanes of a read hit 32 banks.
__device__ __forceinline__ void load_a(float (&x)[4][4], uint32_t panel, int r, int g, int t) {
  const uint32_t row = panel + r * 128 + 4 * t;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t c0 = ((2 * j) ^ g) << 4, c1 = ((2 * j + 1) ^ g) << 4;
    x[j][0] = lds(row + c0);
    x[j][1] = lds(row + 1024 + c0);
    x[j][2] = lds(row + c1);
    x[j][3] = lds(row + 1024 + c1);
  }
}

// The same fragments from the transpose: the panel holds A^T as four
// boxes of 32 depth rows x 32 tile rows (4 KB each, box i the tile rows
// 32 i ..), element (m, k) of A at box m / 32, row k, column m % 32.
__device__ __forceinline__ void load_a_t(float (&x)[4][4], uint32_t panel, int r, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = r + 8 * (e & 1), k = 8 * j + t + 4 * (e >> 1);
      x[j][e] = lds(panel + (m >> 5) * 4096 + k * 128 + ((((m & 31) >> 2) ^ (k & 7)) << 4) +
                    (m & 3) * 4);
    }
}

__device__ __forceinline__ void split_frags(const float (&x)[4][4], uint32_t (&big)[4][4],
                                            uint32_t (&small)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) vst::split_tf32(x[j][e], big[j][e], small[j][e]);
}

template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&c)[NT][4], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  if constexpr (NT == 4)
    vst::wgmma_tf32_rs_n32(c, a, db, accumulate);
  else if constexpr (NT == 8)
    vst::wgmma_tf32_rs_n64(c, a, db, accumulate);
  else
    vst::wgmma_tf32_rs_n128(c, a, db, accumulate);
}

// f (+)= A B over one 32-deep panel in split TF32: per 8-deep step small
// big, big small, big big; B's halves K-major panels at bbig and bsmall
// (8 NT rows each). `accumulate` 0 starts f afresh.
template <int NT>
__device__ __forceinline__ void panel_products(float (&f)[NT][4], const uint32_t (&big)[4][4],
                                               const uint32_t (&small)[4][4], uint32_t bbig,
                                               uint32_t bsmall, int accumulate) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_tf32<NT>(f, small[j], vst::desc_kmajor(bbig, j), j == 0 ? accumulate : 1);
    wgmma_tf32<NT>(f, big[j], vst::desc_kmajor(bsmall, j), 1);
    wgmma_tf32<NT>(f, big[j], vst::desc_kmajor(bbig, j), 1);
  }
}

template <int NT>
__device__ __forceinline__ void add_into(float (&run)[NT][4], const float (&f)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) run[i][e] += f[i][e];
}

// Shared memory and barriers of a kernel; barriers ready on return.
struct RingSmem {
  uint32_t base, full, empty;
  __device__ __forceinline__ RingSmem(unsigned char* smem_raw, int stages, uint32_t stage_bytes) {
    const uint32_t raw = vst::smem_u32(smem_raw);
    base = (raw + 1023) & ~1023u;
    full = base + stages * stage_bytes;
    empty = full + 8 * stages;
    if (threadIdx.x == 0) {
      vst::ring_init(full, empty, stages, kConsumerWarps);
      vst::mbar_fence_init();
    }
    __syncthreads();
  }
};

// ---- the products with the depth over the keys or queries -----------------------

// out = f (A B) in 128 x 128 tiles (rows by the head's columns) of every
// head (128 x 64 with NT = 8, the f32 dQ at D = 64), `tiles` = B H nrt ndt
// (nrt = ceil(N / 128), ndt = ceil(D / (8 NT))),
// tile i at column tile i % ndt, row tile i / ndt % nrt, head i / (ndt
// nrt); the depth the N / 32 panels of A's columns; B's halves [B H, D,
// N] maps (the head's columns by the depth: V^T, dO^T, qc^T or K^T).
//   kOut:   A = S2 rows ([B H, N, N] map), formed into P = exp2(S2 - m)
//           as it is loaded (m of each row the max of its tiles' maxima
//           in mpart), l = the row sum of P; out = O = (P V) / l; the
//           blocks of column tile 0 write LSE2 = m + log2(l) into lse.
//   kGrad:  A = P^T or dS^T rows; out = mul (A B) (dV, dK).
//   kGradT: A = dS, read from dS^T ([B H, N, N] map, 32 x 32 boxes);
//           out = mul (A B) (dQ).
// out [B, N, H, D] with strides (ob, on, oh, 1).
template <int kKind, int NT = 16>
__global__ void __launch_bounds__(kThreads, 1)
tf32_product_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mbb,
                    const __grid_constant__ CUtensorMap mbs, const float* __restrict__ mpart,
                    float* __restrict__ lse, float mul, float* __restrict__ out, int H, int N,
                    int D, long long ob, long long on, long long oh, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t kStage = kProductStage<NT>, kBs = kPanel128 + NT * 8 * 128;
  constexpr int kCols = 8 * NT;
  const RingSmem L(smem_raw, kStages, kStage);
  const int nrt = (N + kTile - 1) / kTile, ndt = (D + kCols - 1) / kCols, np = N / kDepth;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int ct = tile % ndt, rt = tile / ndt % nrt, bh = tile / (ndt * nrt);
      for (int p = 0; p < np; ++p, ++it) {
        vst::ring_wait_free(L.empty, it, kStages);
        const int s = it % kStages;
        const uint32_t st = L.base + s * kStage, bar = L.full + 8 * s;
        vst::mbar_arrive_expect_tx(bar, kStage);
        if constexpr (kKind == kGradT) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            vst::tma_load_3d(st + 4096 * i, &ma, bar, kTile * rt + 32 * i, kDepth * p, bh);
        } else {
          vst::tma_load_3d(st, &ma, bar, kDepth * p, kTile * rt, bh);
        }
        vst::tma_load_3d(st + kPanel128, &mbb, bar, kDepth * p, kCols * ct, bh);
        vst::tma_load_3d(st + kBs, &mbs, bar, kDepth * p, kCols * ct, bh);
      }
    }
    for (int i = 0; i < kStages; ++i, ++it) vst::ring_wait_free(L.empty, it, kStages);
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * warp + g;
  vst::RingConsumer ring{L.base, kStage, L.full, L.empty, kStages, lane};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ct = tile % ndt, rt = tile / ndt % nrt, bh = tile / (ndt * nrt);
    const long long head = (long long)bh * N;
    const int row0 = kTile * rt + r;
    float m0 = 0.f, m1 = 0.f, l0 = 0.f, l1 = 0.f;
    if constexpr (kKind == kOut) {   // rows past N: any finite m (nothing is stored)
      if (row0 < N) {
        m0 = -INFINITY;
        for (int i = 0; i < nrt; ++i) m0 = fmaxf(m0, mpart[(head + row0) * nrt + i]);
      }
      if (row0 + 8 < N) {
        m1 = -INFINITY;
        for (int i = 0; i < nrt; ++i) m1 = fmaxf(m1, mpart[(head + row0 + 8) * nrt + i]);
      }
    }
    float run[NT][4], f[NT][4];
    vst::zero_acc(run);
    vst::zero_acc(f);
    for (int p = 0; p < np; ++p) {
      const uint32_t st = ring.next();
      float x[4][4];
      uint32_t big[4][4], small[4][4];
      if constexpr (kKind == kGradT)
        load_a_t(x, st, r, t);
      else
        load_a(x, st, r, g, t);
      if constexpr (kKind == kOut) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j][0] = exp2f(x[j][0] - m0);
          x[j][1] = exp2f(x[j][1] - m1);
          x[j][2] = exp2f(x[j][2] - m0);
          x[j][3] = exp2f(x[j][3] - m1);
          l0 += x[j][0] + x[j][2];
          l1 += x[j][1] + x[j][3];
        }
      }
      split_frags(x, big, small);
      vst::wgmma_fence();
      panel_products<NT>(f, big, small, st + kPanel128, st + kBs, p & 1);
      vst::wgmma_commit();
      vst::wgmma_wait<0>();
      vst::fence_acc(f);
      ring.release(1);
      if (p & 1) add_into(run, f);   // a fresh sum each 64 of the depth (N % 64 == 0)
    }
    if constexpr (kKind == kOut) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    }
    const int h = bh % H, b = bh / H;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= N) continue;
      float* dst = out + (long long)b * ob + (long long)row * on + (long long)h * oh;
      const float l = half ? l1 : l0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = kCols * ct + 8 * j + 2 * t;
        if (col >= D) continue;
        const float a = run[j][2 * half], c = run[j][2 * half + 1];
        *reinterpret_cast<float2*>(dst + col) =
            kKind == kOut ? make_float2(a / l, c / l) : make_float2(a * mul, c * mul);
      }
      if (kKind == kOut && ct == 0 && t == 0) lse[head + row] = (half ? m1 : m0) + log2f(l);
    }
  }
}

// ---- the split pre-pass ---------------------------------------------------------------

// One head's f32 [N, D] (a [B, N, H, D] view with strides (sb, sn, sh,
// 1)) times `mul` (qscale for qc, one f32 multiply; else 1), split into
// big and small: into rows_big / rows_small [B H, N, D] where given, and
// transposed into tr_big / tr_small [B H, D, N] where given, with `perm` each
// group of 8 of the N axis in the order of a permuted contraction (row i of
// the group at position i / 2 + 4 (i % 2): keys or queries 2 t and 2 t + 1 at
// positions t and t + 4, the order in which an accumulator tile is the
// register A operand of a product over its columns, mma_tf32.cuh). Grid (D /
// 32, N / 32, B H), 256 threads a 32 x 32 tile.
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ src, long long sb, long long sn, long long sh, int H,
                  int N, int D, float mul, uint32_t* __restrict__ rows_big,
                  uint32_t* __restrict__ rows_small, uint32_t* __restrict__ tr_big,
                  uint32_t* __restrict__ tr_small, int perm) {
  __shared__ uint32_t tb[32][33], ts[32][33];
  const int d0 = 32 * blockIdx.x, n0 = 32 * blockIdx.y, bh = blockIdx.z;
  const int h = bh % H, b = bh / H;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* head = src + (long long)b * sb + (long long)h * sh + d0 + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 8 * i;
    uint32_t big, small;
    vst::split_tf32(head[(long long)n * sn] * mul, big, small);
    if (rows_big != nullptr) {
      const long long at = ((long long)bh * N + n) * D + d0 + tx;
      rows_big[at] = big;
      rows_small[at] = small;
    }
    tb[ty + 8 * i][tx] = big;
    ts[ty + 8 * i][tx] = small;
  }
  if (tr_big == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = ty + 8 * i;
    const long long at = ((long long)bh * D + d0 + d) * N + n0 + tx;
    const int p = tx & 7;   // position tx holds row (tx & ~7) + (p < 4 ? 2 p : 2 p - 7)
    const int from = perm ? (tx & ~7) | (p < 4 ? 2 * p : 2 * p - 7) : tx;
    tr_big[at] = tb[from][d];
    tr_small[at] = ts[from][d];
  }
}

// The card's SM count (the persistent grids' size), asked once a device.
cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *sms;
  return err;
}

unsigned persistent(long long tiles, int sms) {
  return static_cast<unsigned>(tiles < sms ? tiles : sms);
}

void launch_split(const float* src, long long sb, long long sn, long long sh, int B, int H,
                  int N, int D, float mul, float* rows, float* tr, cudaStream_t st,
                  bool perm = false) {
  const long long half = (long long)B * H * N * D;
  uint32_t* r = reinterpret_cast<uint32_t*>(rows);
  uint32_t* t = reinterpret_cast<uint32_t*>(tr);
  tf32_split_kernel<<<dim3(D / 32, N / 32, B * H), 256, 0, st>>>(
      src, sb, sn, sh, H, N, D, mul, r, r ? r + half : nullptr, t, t ? t + half : nullptr,
      perm ? 1 : 0);
}

}  // namespace
