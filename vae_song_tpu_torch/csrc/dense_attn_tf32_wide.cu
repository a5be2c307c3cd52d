// f32 attention forward and backward for Hopper (sm_90a) at head widths
// D % 64 == 0 from 192 up: split-TF32 wgmma/TMA products over written-out
// scores, [B, N, H, D] tensors read through strides.
//
// Replaces: the f32 path (cd = f32, denseattn.py:82-85) of
// vae_song_tpu/ops/denseattn.py:_fwd_kernel (K3f, through _call_fwd) and
// _bwd_kernel (K3b, through _call_bwd) at those widths: SetVAE under
// `mixed_precision: false` with one head of 256 (d_model 256), or wider
// models with one or two heads. The function and its roundings are those
// of dense_attn_fwd.cu and dense_attn_bwd.cu in f32:
//   qc = q * scale * log2e (one f32 multiply), S2 = qc k^T, m = the exact
//   whole-row max, P = exp2(S2 - m), O = P v / rowsum(P),
//   LSE2 = m + log2(rowsum(P));
//   backward: P = exp2(qc k^T - LSE2), dV = P^T dO, dP = dO v^T,
//   dS = P (dP - delta), dQ = dS k scale, dK = dS^T qc ln2,
// with delta = rowsum(dO O) from the backward's preprocess pass.
//
// Split TF32. The tensor cores take f32 data only as TF32 (they read the
// top 19 bits of an operand). Every operand x is carried as big = rna(x)
// and small = rna(x - big) (mma_tf32.cuh: split_tf32), and each 8-deep
// step of a product is three TF32 products, small big, big small, big big
// (small small dropped): f32-accurate sums at a third of the TF32 rate.
// The tensor cores round each product's sum toward zero, so a long chain
// on one accumulator drifts (csrc/mma_tf32.cuh; ROADMAP Queue 3): every
// product here starts a fresh accumulator each 32 columns of a score's
// depth (12 wgmma) and each 64 keys or queries of an output's depth (24
// wgmma), adds it to the running sum in f32 (to nearest), in the order of
// the depth (tests/test_torch_denseattn_f32split.py emulates this order
// and holds it to chip_smoke.py's f32 bounds: a score chain of 64 columns
// comes within 15% of them at N = 2048, an output chain over the whole
// depth misses them 2.4x).
//
// What bounds it here: 4 B H N^2 D operations forward and 10 B H N^2 D
// backward, each made once; at B = 64, H = 1, N = 2048, D = 256, 2.75e11
// and 6.87e11, 1.67 and 4.17 ms as split TF32 (3 x operations at 495
// TFLOP/s). The f32 scores (1 GiB at that shape) and the split operands
// are written and read through device memory: about 3 GB forward and 7
// GB backward, 0.9 and 2.1 ms at 3.35 TB/s, most of it overlapped by the
// products.
//
// Design. TF32 wgmma has no transpose: both shared-memory operands are
// read K-major. So every product is arranged as A (registers) times B
// (shared memory, K-major): A is raw f32, brought by TMA into shared
// memory and split by the consumers as they load it into registers, in
// any layout (row-major, or transposed: dQ's dS read from dS^T); B is split
// ahead, by a pre-pass, into big and small arrays laid out K-major
// ([B H, N, D] for K, qc, dO; [B H, D, N] for V^T, qc^T, dO^T, K^T), so
// that TMA lands both halves ready for the descriptors. The scores are
// written out (as dense_attn_scores.cu does for bf16 wider than 2048), so
// every product is made once:
//   forward   split K and V^T; S2 = qc K^T (A = q, scaled as it is
//             loaded) in 128 x 128 tiles, each tile's row max beside it;
//             O = P V / l with P = exp2(S2 - m) formed from S2 as it is
//             loaded (A), m the max of the tiles' maxima, l the row sum
//             of P, LSE2 = m + log2(l);
//   backward  preprocess (delta); split qc, dO (rows) and qc^T, dO^T, K^T;
//             S^T = K qc^T and dP^T = V dO^T for a 128 x 64 tile (keys by
//             queries), P^T and dS^T written out; dV = P^T dO, dK = dS^T qc
//             ln2, dQ = dS K scale (A = dS^T read transposed).
// A product kernel's block: 384 threads, consumer warpgroups 0 and 1 on
// the tile's rows 0-63 and 64-127 (m64n128k8, or m64n64k8 for the
// backward's scores), a producer warpgroup one thread of which issues the
// TMA loads into a ring of 32-deep stages (A 16 KB raw, B 2 x 16 KB split:
// 4 stages, 192 KB; the backward's scores 3 stages of 64 KB). Blocks are
// persistent (one an SM, walking the tiles in order), so the ring runs on
// across tiles. A stage is given back once its products have completed.
// Ragged edges: N % 64 == 0 and D % 64 == 0, so a 128-row or 128-column
// tile may end 64 past N or D: TMA fills rows past N (a head's own
// dimension in every map) and past D with zeros, and the epilogues store
// nothing there. Nothing grows with D or N in shared memory or registers:
// every D % 64 == 0 from 192 up runs. No atomics, every sum in a fixed
// order: the same bits on every run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_attn_tf32_wide.cuh"
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
constexpr int kBwdStages = 3;                        // the backward's scores
constexpr uint32_t kBwdStageBytes = 2 * kPanel128 + 4 * kPanel64;   // K, V; qc, dO halves
constexpr size_t kSmem = kStages * kStageBytes + 16 * kStages + 1024;
constexpr size_t kBwdSmem = kBwdStages * kBwdStageBytes + 16 * kBwdStages + 1024;
constexpr int kScoreQueries = 64;                    // queries of a backward scores tile
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
  if constexpr (NT == 8)
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

// ---- the forward's scores ---------------------------------------------------------

// S2 = qc K^T in 128 x 128 tiles (queries by keys) of every head, `tiles`
// = B H nt^2 (nt = ceil(N / 128)), tile i at key tile i % nt, query tile
// i / nt % nt, head i / nt^2; the depth the head's D / 32 panels. A = q
// (4-D map, 128-row boxes) times qscale as it is loaded (qc, one f32
// multiply); B = K's halves ([B H, N, D] maps). Writes S2 into s_out [B H,
// N, N] and each row's max over the tile's keys into mpart [B H N, nt].
// Lane 4 g + t of warp i of consumer warpgroup w holds rows 64 w + 16 i +
// g and + 8, columns 8 j + 2 t and + 1 (j < 16).
__global__ void __launch_bounds__(kThreads, 1)
tf32_scores_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mkb,
                       const __grid_constant__ CUtensorMap mks, float* __restrict__ s_out,
                       float* __restrict__ mpart, int H, int N, int D, float qscale, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const RingSmem L(smem_raw, kStages, kStageBytes);
  const int nt = (N + kTile - 1) / kTile, np = D / kDepth;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int ct = tile % nt, rt = tile / nt % nt, bh = tile / (nt * nt);
      for (int p = 0; p < np; ++p, ++it) {
        vst::ring_wait_free(L.empty, it, kStages);
        const int s = it % kStages;
        const uint32_t st = L.base + s * kStageBytes, bar = L.full + 8 * s;
        vst::mbar_arrive_expect_tx(bar, kStageBytes);
        vst::tma_load_4d(st, &mq, bar, kDepth * p, bh % H, kTile * rt, bh / H);
        vst::tma_load_3d(st + kPanel128, &mkb, bar, kDepth * p, kTile * ct, bh);
        vst::tma_load_3d(st + 2 * kPanel128, &mks, bar, kDepth * p, kTile * ct, bh);
      }
    }
    for (int i = 0; i < kStages; ++i, ++it) vst::ring_wait_free(L.empty, it, kStages);
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * warp + g;   // this thread's first tile row
  vst::RingConsumer ring{L.base, kStageBytes, L.full, L.empty, kStages, lane};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ct = tile % nt, rt = tile / nt % nt, bh = tile / (nt * nt);
    float run[16][4], f[16][4];
    vst::zero_acc(run);
    vst::zero_acc(f);
    for (int p = 0; p < np; ++p) {
      const uint32_t st = ring.next();
      float x[4][4];
      uint32_t big[4][4], small[4][4];
      load_a(x, st, r, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] *= qscale;
      split_frags(x, big, small);
      vst::wgmma_fence();
      panel_products<16>(f, big, small, st + kPanel128, st + 2 * kPanel128, 0);
      vst::wgmma_commit();
      vst::wgmma_wait<0>();
      vst::fence_acc(f);
      ring.release(1);
      add_into(run, f);
    }
    const long long head = (long long)bh * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = kTile * rt + r + 8 * half;
      float m = -INFINITY;
      if (row < N) {
        float* out = s_out + (head + row) * N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = kTile * ct + 8 * j + 2 * t;   // N is even: col + 1 < N too
          if (col < N) {
            const float a = run[j][2 * half], b = run[j][2 * half + 1];
            *reinterpret_cast<float2*>(out + col) = make_float2(a, b);
            m = fmaxf(m, fmaxf(a, b));
          }
        }
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (row < N && t == 0) mpart[(head + row) * nt + ct] = m;
    }
  }
}

// ---- the products with the depth over the keys or queries -----------------------

// out = f (A B) in 128 x 128 tiles (rows by the head's columns) of every
// head, `tiles` = B H nrt ndt (nrt = ceil(N / 128), ndt = ceil(D / 128)),
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
template <int kKind>
__global__ void __launch_bounds__(kThreads, 1)
tf32_product_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mbb,
                    const __grid_constant__ CUtensorMap mbs, const float* __restrict__ mpart,
                    float* __restrict__ lse, float mul, float* __restrict__ out, int H, int N,
                    int D, long long ob, long long on, long long oh, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const RingSmem L(smem_raw, kStages, kStageBytes);
  const int nrt = (N + kTile - 1) / kTile, ndt = (D + kTile - 1) / kTile, np = N / kDepth;
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
        const uint32_t st = L.base + s * kStageBytes, bar = L.full + 8 * s;
        vst::mbar_arrive_expect_tx(bar, kStageBytes);
        if constexpr (kKind == kGradT) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            vst::tma_load_3d(st + 4096 * i, &ma, bar, kTile * rt + 32 * i, kDepth * p, bh);
        } else {
          vst::tma_load_3d(st, &ma, bar, kDepth * p, kTile * rt, bh);
        }
        vst::tma_load_3d(st + kPanel128, &mbb, bar, kDepth * p, kTile * ct, bh);
        vst::tma_load_3d(st + 2 * kPanel128, &mbs, bar, kDepth * p, kTile * ct, bh);
      }
    }
    for (int i = 0; i < kStages; ++i, ++it) vst::ring_wait_free(L.empty, it, kStages);
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * warp + g;
  vst::RingConsumer ring{L.base, kStageBytes, L.full, L.empty, kStages, lane};
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
    float run[16][4], f[16][4];
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
      panel_products<16>(f, big, small, st + kPanel128, st + 2 * kPanel128, p & 1);
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
      for (int j = 0; j < 16; ++j) {
        const int col = kTile * ct + 8 * j + 2 * t;
        if (col >= D) continue;
        const float a = run[j][2 * half], c = run[j][2 * half + 1];
        *reinterpret_cast<float2*>(dst + col) =
            kKind == kOut ? make_float2(a / l, c / l) : make_float2(a * mul, c * mul);
      }
      if (kKind == kOut && ct == 0 && t == 0) lse[head + row] = (half ? m1 : m0) + log2f(l);
    }
  }
}

// ---- the backward's scores ----------------------------------------------------------

// S^T = K qc^T and dP^T = V dO^T for tiles of 128 keys by 64 queries of
// every head, `tiles` = B H nkt nqt (nkt = ceil(N / 128), nqt = N / 64),
// tile i at query tile i % nqt, key tile i / nqt % nkt, head i / (nqt
// nkt); the depth the head's D / 32 panels. A = K and V (4-D maps,
// 128-row boxes); B = the halves of qc and dO ([B H, N, D] maps, 64-row
// boxes). P^T = exp2(S^T - LSE2) and dS^T = P^T (dP^T - delta), each
// query's LSE2 and delta read from [B H, N], stored into pt and dst [B H,
// N, N] (keys by queries). Lane 4 g + t of warp i of warpgroup w holds
// keys 64 w + 16 i + g and + 8, queries 8 j + 2 t and + 1 (j < 8).
__global__ void __launch_bounds__(kThreads, 1)
tf32_scores_bwd_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mqb,
                       const __grid_constant__ CUtensorMap mqs,
                       const __grid_constant__ CUtensorMap mdb,
                       const __grid_constant__ CUtensorMap mds, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ pt,
                       float* __restrict__ dst, int H, int N, int D, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const RingSmem L(smem_raw, kBwdStages, kBwdStageBytes);
  const int nkt = (N + kTile - 1) / kTile, nqt = N / kScoreQueries, np = D / kDepth;
  const int wg = threadIdx.x / 128;
  constexpr uint32_t kQb = 2 * kPanel128, kQs = kQb + kPanel64, kDb = kQs + kPanel64,
                     kDs = kDb + kPanel64;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int qt = tile % nqt, kt = tile / nqt % nkt, bh = tile / (nqt * nkt);
      const int h = bh % H, b = bh / H;
      for (int p = 0; p < np; ++p, ++it) {
        vst::ring_wait_free(L.empty, it, kBwdStages);
        const int s = it % kBwdStages;
        const uint32_t st = L.base + s * kBwdStageBytes, bar = L.full + 8 * s;
        vst::mbar_arrive_expect_tx(bar, kBwdStageBytes);
        vst::tma_load_4d(st, &mk, bar, kDepth * p, h, kTile * kt, b);
        vst::tma_load_4d(st + kPanel128, &mv, bar, kDepth * p, h, kTile * kt, b);
        vst::tma_load_3d(st + kQb, &mqb, bar, kDepth * p, kScoreQueries * qt, bh);
        vst::tma_load_3d(st + kQs, &mqs, bar, kDepth * p, kScoreQueries * qt, bh);
        vst::tma_load_3d(st + kDb, &mdb, bar, kDepth * p, kScoreQueries * qt, bh);
        vst::tma_load_3d(st + kDs, &mds, bar, kDepth * p, kScoreQueries * qt, bh);
      }
    }
    for (int i = 0; i < kBwdStages; ++i, ++it) vst::ring_wait_free(L.empty, it, kBwdStages);
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * wg + 16 * warp + g;
  vst::RingConsumer ring{L.base, kBwdStageBytes, L.full, L.empty, kBwdStages, lane};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int qt = tile % nqt, kt = tile / nqt % nkt, bh = tile / (nqt * nkt);
    float rs[8][4], rp[8][4], fs[8][4], fp[8][4];
    vst::zero_acc(rs);
    vst::zero_acc(rp);
    vst::zero_acc(fs);
    vst::zero_acc(fp);
    for (int p = 0; p < np; ++p) {
      const uint32_t st = ring.next();
      float x[4][4];
      uint32_t kb[4][4], ks[4][4], vb[4][4], vs[4][4];
      load_a(x, st, r, g, t);
      split_frags(x, kb, ks);
      load_a(x, st + kPanel128, r, g, t);
      split_frags(x, vb, vs);
      vst::wgmma_fence();
      panel_products<8>(fs, kb, ks, st + kQb, st + kQs, 0);
      panel_products<8>(fp, vb, vs, st + kDb, st + kDs, 0);
      vst::wgmma_commit();
      vst::wgmma_wait<0>();
      vst::fence_acc(fs);
      vst::fence_acc(fp);
      ring.release(1);
      add_into(rs, fs);
      add_into(rp, fp);
    }
    const long long head = (long long)bh * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kScoreQueries * qt + 8 * j + 2 * t;   // a query (< N: N % 64 == 0)
      const float2 l2 = *reinterpret_cast<const float2*>(lse + head + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + head + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = kTile * kt + r + 8 * half;   // a key
        if (row >= N) continue;
        const float p0 = exp2f(rs[j][2 * half] - l2.x), p1 = exp2f(rs[j][2 * half + 1] - l2.y);
        const long long at = (head + row) * N + col;
        *reinterpret_cast<float2*>(pt + at) = make_float2(p0, p1);
        *reinterpret_cast<float2*>(dst + at) =
            make_float2(p0 * (rp[j][2 * half] - d2.x), p1 * (rp[j][2 * half + 1] - d2.y));
      }
    }
  }
}

// ---- the split pre-pass ---------------------------------------------------------------

// One head's f32 [N, D] (a [B, N, H, D] view with strides (sb, sn, sh,
// 1)) times `mul` (qscale for qc, one f32 multiply; else 1), split into
// big and small: into rows_big / rows_small [B H, N, D] where given, and
// transposed into tr_big / tr_small [B H, D, N] where given. Grid (D / 32,
// N / 32, B H), 256 threads a 32 x 32 tile.
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ src, long long sb, long long sn, long long sh, int H,
                  int N, int D, float mul, uint32_t* __restrict__ rows_big,
                  uint32_t* __restrict__ rows_small, uint32_t* __restrict__ tr_big,
                  uint32_t* __restrict__ tr_small) {
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
    tr_big[at] = tb[tx][d];
    tr_small[at] = ts[tx][d];
  }
}

// ---- host ------------------------------------------------------------------------------

bool shapes_ok(int B, int H, int N, int D, const void* scratch) {
  return scratch != nullptr && N > 0 && D >= 192 && N % 64 == 0 && D % 64 == 0 &&
         (long long)B * H <= 65535 && (long long)B * H * N < (1ll << 31);
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
                  int N, int D, float mul, float* rows, float* tr, cudaStream_t st) {
  const long long half = (long long)B * H * N * D;
  uint32_t* r = reinterpret_cast<uint32_t*>(rows);
  uint32_t* t = reinterpret_cast<uint32_t*>(tr);
  tf32_split_kernel<<<dim3(D / 32, N / 32, B * H), 256, 0, st>>>(
      src, sb, sn, sh, H, N, D, mul, r, r ? r + half : nullptr, t, t ? t + half : nullptr);
}

}  // namespace

namespace vst {

cudaError_t launch_attn_fwd_tf32_wide(const float* q, const float* k, const float* v, float* o,
                                      float* lse, void* scratch, int B, int H, int N, int D,
                                      long long sb, long long sn, long long sh, long long ob,
                                      long long on, long long oh, float qscale, cudaStream_t st) {
  if (!shapes_ok(B, H, N, D, scratch)) return cudaErrorInvalidValue;
  const long long bh = (long long)B * H, bhn = bh * N, nt = (N + kTile - 1) / kTile;
  float* s = static_cast<float*>(scratch);
  float* mpart = s + bhn * N;
  float* ksplit = mpart + bhn * nt;   // big, then small
  float* vsplit = ksplit + 2 * bhn * D;
  CUtensorMap mq, mkb, mks, ms, mvb, mvs;
  if (!bhnd_tensor_map_f32(&mq, q, B, N, H, D, sb, sn, sh, kTile) ||
      !heads_tensor_map_f32(&mkb, ksplit, bh, N, D, kTile) ||
      !heads_tensor_map_f32(&mks, ksplit + bhn * D, bh, N, D, kTile) ||
      !heads_tensor_map_f32(&ms, s, bh, N, N, kTile) ||
      !heads_tensor_map_f32(&mvb, vsplit, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mvs, vsplit + bhn * D, bh, D, N, kTile))
    return cudaErrorInvalidValue;
  cudaError_t err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_scores_fwd_kernel, kSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_product_kernel<kOut>, kSmem)) != cudaSuccess) return err;
  launch_split(k, sb, sn, sh, B, H, N, D, 1.f, ksplit, nullptr, st);
  launch_split(v, sb, sn, sh, B, H, N, D, 1.f, nullptr, vsplit, st);
  const long long score_tiles = bh * nt * nt;
  tf32_scores_fwd_kernel<<<persistent(score_tiles, sms), kThreads, kSmem, st>>>(
      mq, mkb, mks, s, mpart, H, N, D, qscale, static_cast<int>(score_tiles));
  const long long out_tiles = bh * nt * ((D + kTile - 1) / kTile);
  tf32_product_kernel<kOut><<<persistent(out_tiles, sms), kThreads, kSmem, st>>>(
      ms, mvb, mvs, mpart, lse, 1.f, o, H, N, D, ob, on, oh, static_cast<int>(out_tiles));
  return cudaGetLastError();
}

cudaError_t launch_attn_bwd_tf32_wide(const float* q, const float* k, const float* v,
                                      const float* d_o, const float* lse, const float* delta,
                                      float* dq, float* dk, float* dv, void* scratch, int B,
                                      int H, int N, int D, long long sb, long long sn,
                                      long long sh, long long ob, long long on, long long oh,
                                      float qscale, float scale, cudaStream_t st) {
  if (!shapes_ok(B, H, N, D, scratch)) return cudaErrorInvalidValue;
  const long long bh = (long long)B * H, bhn = bh * N, nt = (N + kTile - 1) / kTile;
  const long long half = bhn * D;   // one split half
  float* pt = static_cast<float*>(scratch);
  float* dst = pt + bhn * N;
  float* qc = dst + bhn * N;          // [B H, N, D] big, small
  float* dos = qc + 2 * half;
  float* qct = dos + 2 * half;        // [B H, D, N] big, small
  float* dot = qct + 2 * half;
  float* kt = dot + 2 * half;
  CUtensorMap mk, mv, mqb, mqs, mdb, mds, mpt, mdst, mdst_t, mdotb, mdots, mqctb, mqcts, mktb,
      mkts;
  if (!bhnd_tensor_map_f32(&mk, k, B, N, H, D, sb, sn, sh, kTile) ||
      !bhnd_tensor_map_f32(&mv, v, B, N, H, D, sb, sn, sh, kTile) ||
      !heads_tensor_map_f32(&mqb, qc, bh, N, D, kScoreQueries) ||
      !heads_tensor_map_f32(&mqs, qc + half, bh, N, D, kScoreQueries) ||
      !heads_tensor_map_f32(&mdb, dos, bh, N, D, kScoreQueries) ||
      !heads_tensor_map_f32(&mds, dos + half, bh, N, D, kScoreQueries) ||
      !heads_tensor_map_f32(&mpt, pt, bh, N, N, kTile) ||
      !heads_tensor_map_f32(&mdst, dst, bh, N, N, kTile) ||
      !heads_tensor_map_f32(&mdst_t, dst, bh, N, N, 32) ||
      !heads_tensor_map_f32(&mdotb, dot, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mdots, dot + half, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mqctb, qct, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mqcts, qct + half, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mktb, kt, bh, D, N, kTile) ||
      !heads_tensor_map_f32(&mkts, kt + half, bh, D, N, kTile))
    return cudaErrorInvalidValue;
  cudaError_t err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_scores_bwd_kernel, kBwdSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_product_kernel<kGrad>, kSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(tf32_product_kernel<kGradT>, kSmem)) != cudaSuccess) return err;
  launch_split(q, sb, sn, sh, B, H, N, D, qscale, qc, qct, st);
  launch_split(d_o, ob, on, oh, B, H, N, D, 1.f, dos, dot, st);
  launch_split(k, sb, sn, sh, B, H, N, D, 1.f, nullptr, kt, st);
  const long long score_tiles = bh * nt * (N / kScoreQueries);
  tf32_scores_bwd_kernel<<<persistent(score_tiles, sms), kThreads, kBwdSmem, st>>>(
      mk, mv, mqb, mqs, mdb, mds, lse, delta, pt, dst, H, N, D, static_cast<int>(score_tiles));
  const long long tiles = bh * nt * ((D + kTile - 1) / kTile);
  const unsigned grid = persistent(tiles, sms);
  const int ti = static_cast<int>(tiles);
  tf32_product_kernel<kGrad><<<grid, kThreads, kSmem, st>>>(mpt, mdotb, mdots, nullptr, nullptr,
                                                            1.f, dv, H, N, D, ob, on, oh, ti);
  tf32_product_kernel<kGrad><<<grid, kThreads, kSmem, st>>>(mdst, mqctb, mqcts, nullptr, nullptr,
                                                            kLn2, dk, H, N, D, ob, on, oh, ti);
  tf32_product_kernel<kGradT><<<grid, kThreads, kSmem, st>>>(
      mdst_t, mktb, mkts, nullptr, nullptr, scale, dq, H, N, D, ob, on, oh, ti);
  return cudaGetLastError();
}

}  // namespace vst
