// bf16 dense attention for heads wider than 2048 on Hopper (sm_90a):
// wgmma/TMA products over written-out scores.
//
// Replaces, for bf16 heads of D > 2048 (any D % 64 == 0):
// vae_song_tpu/ops/denseattn.py:_fwd_kernel (K3f, called through
// _call_fwd) and :_bwd_kernel (K3b, called through _call_bwd), with
// their roundings (cd = bf16):
//   qc   = bf16(q * scale * log2e)
//   S2   = qc k^T (f32), m = the exact row max (a whole-row max)
//   P    = bf16(ex2(bf16(S2 - m))), below 2^-126 flushed to 0
//   l    = rowsum(P) in f32, in one fixed order (below)
//   O    = bf16((P v) * (1 / l)),  LSE2 = m + log2(l)
// and backward from LSE2 and delta = bf16(rowsum(dO O)):
//   P    = bf16(ex2(bf16(S2 - LSE2))),  dP = dO v^T
//   dS   = bf16(P * bf16(bf16(dP) - delta))
//   dV   = bf16(P^T dO),  dK = bf16(ln2 dS^T qc),  dQ = bf16(scale dS K)
//
// Why the scores are written out. The route is reached through the JAX
// package's dense gate, which caps N at 2048 (denseattn.py:372-378), so
// here D > 2048 >= N: one head's score matrix [N, N] is smaller than its
// q [N, D]. The TPU kernels hold whole score rows too (_fwd_kernel a
// [BQ, N] block with its exact row max, _bwd_kernel [N, N] S, P, dP and
// dS of one (b, h)). A flash-style kernel that keeps the scores on chip
// must sum each score over the whole head before it can use it, and a
// block can hold neither a 64-row tile of q at D > 2048 (256 KB and more)
// nor its output columns in registers, so it would split the head over
// blocks and recompute or exchange the scores for each split. Written
// out, the route is plain products, each executed once: 4 B H N^2 D
// forward, 10 backward, the bound's counts.
//
// What bounds it here: at B = 64, N = 2048, H = 1, D = 2304 the products
// are 2.47e12 (forward) and 6.19e12 (backward) operations, 2.50 and 6.25
// ms at 989 TFLOP/s; the scratch traffic (forward: S2 written once and
// read twice by the row pass, P written and read, 1.5 + 1.5 GiB; backward:
// P^T and dS^T written and read, 2 GiB) adds about 1 ms at 3.35 TB/s.
//
// Forward, four launches on one stream:
//   1. qc = bf16(q qscale) into a contiguous [B, N, H, D] scratch;
//   2. attn_scores_kernel<false>: S2 = qc k^T per (b, h), 128 x 128
//      tiles, written as f32 to a [B H, N, N] scratch;
//   3. attn_rows_kernel: a warp a row: the exact row max, P into a bf16
//      [B H, N, N] scratch, 1 / l and LSE2;
//   4. attn_out_kernel: O = P V, 128 x 128 tiles over (queries, the head's
//      columns), the depth over the keys; O = bf16(acc (1 / l)).
// The scratch is attn_scores_fwd_scratch(B, H, N, D) bytes (6 B H N^2 + 2
// B N H D + 4 B H N: 2.2 GB at B = 64, N = 2048, D = 2304), allocated by
// the wrapper (ops/denseattn.py:_launch_fwd).
//
// Backward (after dense_attn_bwd.cu's preprocess wrote qc and delta):
//   1. attn_scores_kernel<true>: S2^T = k qc^T and dP^T = v dO^T for the
//      same 128 x 128 tile (keys by queries), two accumulators; the
//      epilogue forms P^T and dS^T and writes both as bf16 to the two
//      [B H, N, N] scratches that `_launch_bwd` allocates (4 B H N^2
//      bytes: 1 GiB at B = 64, N = 2048);
//   2. attn_out_kernel twice: dV = P^T dO and dK = ln2 dS^T qc, the depth
//      over the queries;
//   3. dense_attn_bwd.cu's attn_bwd_dq_ds_kernel: dQ = scale dS K from
//      dS^T, the kernel the cluster route for 576 to 2048 already uses.
// Storing the transposes puts every A operand of this file in K-major
// order (the contraction along the tile's 64 columns); the transposed
// reads are B operands: V and dO in P V and P^T dO, qc in dS^T qc, read
// MN-major (the contraction along the tile's rows, the head's columns as
// two 64-column atoms) through the descriptor, as the other wgmma kernels
// read V; and dS in dQ (MN-major A in attn_bwd_dq_ds_kernel).
//
// The product kernels: a block owns one 128 x 128 output tile of one
// (b, h); 384 threads: consumer warpgroups 0 and 1 on the tile's rows 0-63
// and 64-127, each an m64n128k16 wgmma chain with both operands in shared
// memory, and a producer warpgroup one thread of which issues the TMA
// loads (4-D boxes over the strided [B, N, H, D] views, 2-D boxes over
// the row-major scratches) into a ring of 6 stages of 32 KB (a 128 x 64
// A tile and a 64-deep B tile: 198 KB of shared memory a block); a stage
// is given back once the product after it has completed (wgmma_wait<1>),
// and the first step is peeled, so no wgmma issue sits under a branch.
// Ragged edges: N % 64 == 0 and D % 64 == 0, so a 128-row or 128-column
// tile may end 64 past N or D; TMA fills rows of the [B, N, H, D] views
// past N and columns past D with zeros, the scratch's rows past a head
// belong to the next head or read as zeros, and the epilogues store
// nothing past N or D. Nothing in shared memory or registers grows with D
// or N: the depth loop and the tiling take any width. No atomics: every
// output is one block's, so a second call gives the same bits.
//
// The row pass adds each row's P in one fixed order: lane i of the row's
// warp sums columns 64 j + 2 i and 64 j + 2 i + 1, j = 0, 1, ..., in that
// order, then the 32 lane sums are added by an xor butterfly (16, 8, 4, 2,
// 1), which gives every lane the same bits
// (tests/test_torch_denseattn_bf16scores.py models it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_attn_scores.cuh"
#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;                               // consumers 0, 1; producer 2
constexpr int kConsumerWarps = 8;
constexpr int kTile = 128;                                  // output tile edge
constexpr uint32_t kPanel64 = 64 * vst::kPanelRowBytes;     // 64 x 64 bf16 (8 KB)
constexpr int kStages = 6;
constexpr uint32_t kStageBytes = 4 * kPanel64;              // A tile, then B tile
constexpr size_t kSmem = kStages * kStageBytes + 16 * kStages + 1024;   // + alignment
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kRowWarps = 8;                                // rows a row-pass block
constexpr int kQcThreads = 256;

// ---- producer: one ring stage's tiles -----------------------------------------

// K-major 128 x 64 tile: rows r0 .. r0 + 127 of a [B, N, H, D] view, the
// 64 columns of panel p (two 64-row boxes).
__device__ __forceinline__ void load_rows_bhnd(uint32_t dst, const CUtensorMap* m, uint32_t bar,
                                               int p, int h, int r0, int b) {
  vst::tma_load_4d(dst, m, bar, 64 * p, h, r0, b);
  vst::tma_load_4d(dst + kPanel64, m, bar, 64 * p, h, r0 + 64, b);
}

// The same tile of a row-major [rows, N] scratch: rows r0 .. r0 + 127,
// columns 64 p .. 64 p + 63.
__device__ __forceinline__ void load_rows_2d(uint32_t dst, const CUtensorMap* m, uint32_t bar,
                                             int p, int r0) {
  vst::tma_load_2d(dst, m, bar, 64 * p, r0);
  vst::tma_load_2d(dst + kPanel64, m, bar, 64 * p, r0 + 64);
}

// MN-major 64 x 128 tile: rows j0 .. j0 + 63 (the depth) of a [B, N, H,
// D] view, columns c0 .. c0 + 127 as two 64-column atoms.
__device__ __forceinline__ void load_cols_bhnd(uint32_t dst, const CUtensorMap* m, uint32_t bar,
                                               int c0, int h, int j0, int b) {
  vst::tma_load_4d(dst, m, bar, c0, h, j0, b);
  vst::tma_load_4d(dst + kPanel64, m, bar, c0 + 64, h, j0, b);
}

// ---- consumers: the product chain --------------------------------------------

// One 64-deep step of each of kProducts products, one commit group:
// acc[pr] (this warpgroup's 64 rows x 128 columns) += A B, A the rows 64
// w .. of the K-major A tile at the start of stage s0 + pr, B its B tile
// (K-major 128 x 64, or MN-major with kBMN).
template <int kProducts, int kBMN>
__device__ __forceinline__ void issue_step(float (&acc)[kProducts][16][4],
                                           const vst::RingConsumer& ring, int s0, int w) {
  vst::wgmma_fence();
#pragma unroll
  for (int pr = 0; pr < kProducts; ++pr) {
    const uint32_t st = ring.at(s0, pr);
    const uint32_t a = st + w * kPanel64, b = st + 2 * kPanel64;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      vst::wgmma_ss_n128_t<0, kBMN>(
          acc[pr], vst::desc_kmajor(a, j),
          kBMN ? vst::desc_mnmajor(b, j, kPanel64) : vst::desc_kmajor(b, j), 1);
  }
  vst::wgmma_commit();
}

// The whole chain over nk >= 1 depth steps, the ring bringing kProducts
// stages a step; each step's stages are given back once the next step's
// products are issued and its own have completed.
template <int kProducts, int kBMN>
__device__ __forceinline__ void product_chain(float (&acc)[kProducts][16][4],
                                              vst::RingConsumer& ring, int nk, int w) {
#pragma unroll
  for (int pr = 0; pr < kProducts; ++pr) {
    vst::zero_acc(acc[pr]);
    vst::fence_acc(acc[pr]);
  }
  issue_step<kProducts, kBMN>(acc, ring, ring.wait(kProducts), w);
  for (int it = 1; it < nk; ++it) {
    issue_step<kProducts, kBMN>(acc, ring, ring.wait(kProducts), w);
    vst::wgmma_wait<1>();
    ring.release(kProducts);
  }
  vst::wgmma_wait<0>();
#pragma unroll
  for (int pr = 0; pr < kProducts; ++pr) vst::fence_acc(acc[pr]);
  ring.release(kProducts);
}

// Shared memory and barriers of a product kernel; barriers ready on return.
struct ProductSmem {
  uint32_t base, full, empty;
  __device__ __forceinline__ explicit ProductSmem(unsigned char* smem_raw) {
    const uint32_t raw = vst::smem_u32(smem_raw);
    base = (raw + 1023) & ~1023u;
    full = base + kStages * kStageBytes;
    empty = full + 8 * kStages;
    if (threadIdx.x == 0) {
      vst::ring_init(full, empty, kStages, kConsumerWarps);
      vst::mbar_fence_init();
    }
    __syncthreads();
  }
};

// ---- the scores ---------------------------------------------------------------

// Grid (ceil(N / 128) column tiles, ceil(N / 128) row tiles, B H), 384
// threads; block (x, y, z) the tile at rows 128 y, columns 128 x of head
// z = b H + h. The depth is the head's P = D / 64 panels.
// Forward (kBwd false): S2 = qc k^T (rows queries, ma = qc, mb = k),
// stored as f32 into s_out [B H, N, N].
// Backward: S2^T = k qc^T and dP^T = v dO^T (rows keys, columns queries;
// ma, mb = k, qc and ma2, mb2 = v, dO, the ring alternating the two
// products' stages); P^T = bf16(ex2(bf16(S2^T - LSE2))) and dS^T =
// bf16(P^T bf16(bf16(dP^T) - delta)), each query's LSE2 and delta read
// from [B H, N], stored into pt and dst [B H, N, N].
// Lane 4 g + t of warp i of consumer warpgroup w holds rows 64 w + 16 i +
// g and + 8, columns 8 j + 2 t and + 1 (j < 16).
template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
attn_scores_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                   const __grid_constant__ CUtensorMap ma2,
                   const __grid_constant__ CUtensorMap mb2, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ s_out,
                   bf16* __restrict__ pt, bf16* __restrict__ dst, int H, int N, int P) {
  constexpr int kProducts = kBwd ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  const ProductSmem L(smem_raw);
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile, bh = blockIdx.z;
  const int h = bh % H, b = bh / H;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    const int items = kProducts * P;
    for (int it = 0; it < items + kStages; ++it) {
      vst::ring_wait_free(L.empty, it, kStages);
      if (it >= items) continue;
      const int s = it % kStages, p = it / kProducts;
      const uint32_t st = L.base + s * kStageBytes, bar = L.full + 8 * s;
      const bool second = kBwd && (it & 1);
      vst::mbar_arrive_expect_tx(bar, kStageBytes);
      load_rows_bhnd(st, second ? &ma2 : &ma, bar, p, h, m0, b);
      load_rows_bhnd(st + 2 * kPanel64, second ? &mb2 : &mb, bar, p, h, n0, b);
    }
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  vst::RingConsumer ring{L.base, kStageBytes, L.full, L.empty, kStages, lane};
  float acc[kProducts][16][4];
  product_chain<kProducts, 0>(acc, ring, P, wg);

  const int row0 = m0 + 64 * wg + 16 * warp + g;
  const long long head = (long long)bh * N;
  if constexpr (!kBwd) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= N) continue;
      float* out = s_out + (head + row) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < N)
          *reinterpret_cast<float2*>(out + col) =
              make_float2(acc[0][j][2 * half], acc[0][j][2 * half + 1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;   // a query; N is even, so col + 1 < N too
      if (col >= N) continue;
      const float2 l2 = *reinterpret_cast<const float2*>(lse + head + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + head + col);
      const uint32_t dd = vst::pack_bf16(d2.x, d2.y);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;   // a key
        if (row >= N) continue;
        const uint32_t p =
            vst::p_pair(acc[0][j][2 * half] - l2.x, acc[0][j][2 * half + 1] - l2.y);
        const uint32_t ds = vst::ds_pair(p, acc[1][j][2 * half], acc[1][j][2 * half + 1], dd);
        const long long at = (head + row) * N + col;
        *reinterpret_cast<uint32_t*>(pt + at) = p;
        *reinterpret_cast<uint32_t*>(dst + at) = ds;
      }
    }
  }
}

// ---- the products with the depth over a scratch's columns ------------------

// Grid (ceil(D / 128) column tiles, ceil(N / 128) row tiles, B H), 384
// threads; block (x, y, z) the tile at rows 128 y, columns 128 x of head
// z = b H + h: out[rows, cols] = bf16(f (A B)), A the rows of the
// row-major [B H N, N] scratch of ma (K-major: P, P^T or dS^T), B the
// [B, N, H, D] view of mb read MN-major (V, dO or qc), the depth over the
// N columns of A (N / 64 steps); f = mul times row_mul[row] where row_mul
// is given (the forward's 1 / l), else mul. out has strides (ob, on, oh,
// 1).
__global__ void __launch_bounds__(kThreads, 1)
attn_out_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                const float* __restrict__ row_mul, float mul, bf16* __restrict__ out, int H,
                int N, int D, long long ob, long long on, long long oh) {
  extern __shared__ unsigned char smem_raw[];
  const ProductSmem L(smem_raw);
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile, bh = blockIdx.z;
  const int h = bh % H, b = bh / H;
  const int nk = N / 64;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    vst::regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    const int arow = bh * N + m0;
    for (int it = 0; it < nk + kStages; ++it) {
      vst::ring_wait_free(L.empty, it, kStages);
      if (it >= nk) continue;
      const int s = it % kStages;
      const uint32_t st = L.base + s * kStageBytes, bar = L.full + 8 * s;
      vst::mbar_arrive_expect_tx(bar, kStageBytes);
      load_rows_2d(st, &ma, bar, it, arow);
      load_cols_bhnd(st + 2 * kPanel64, &mb, bar, n0, h, 64 * it, b);
    }
    return;
  }

  vst::regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  vst::RingConsumer ring{L.base, kStageBytes, L.full, L.empty, kStages, lane};
  float acc[1][16][4];
  product_chain<1, 1>(acc, ring, nk, wg);

  const int row0 = m0 + 64 * wg + 16 * warp + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= N) continue;
    const float f = row_mul != nullptr ? row_mul[(long long)bh * N + row] * mul : mul;
    bf16* dst = out + (long long)b * ob + (long long)row * on + (long long)h * oh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(dst + col) =
            vst::pack_bf16(acc[0][j][2 * half] * f, acc[0][j][2 * half + 1] * f);
    }
  }
}

// ---- the forward's elementwise passes -------------------------------------------

// qc = bf16(q qscale) into a contiguous [B, N, H, D] scratch, 8 columns a
// thread (`chunks` = B N H D / 8).
__global__ void __launch_bounds__(kQcThreads)
attn_qc_kernel(const bf16* __restrict__ q, bf16* __restrict__ qc, int H, int N, int D,
               long long sb, long long sn, long long sh, float qscale, long long chunks) {
  const long long i = (long long)blockIdx.x * kQcThreads + threadIdx.x;
  if (i >= chunks) return;
  const int per_row = D / 8;
  const long long row = i / per_row;   // (b, n, h) in qc's order
  const int c = static_cast<int>(i % per_row) * 8;
  const int h = static_cast<int>(row % H);
  const long long n = (row / H) % N, b = row / ((long long)H * N);
  uint4 raw = *reinterpret_cast<const uint4*>(q + b * sb + n * sn + h * sh + c);
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
  *reinterpret_cast<uint4*>(qc + row * D + c) = raw;
}

// The row pass: warp r of the grid takes row r of the [rows, N] f32 S2:
// m = its exact max, P = bf16(ex2(bf16(S2 - m))) (vst::p_pair) written as
// bf16 pairs to p [rows, N], l = the row sum of P in the order the file's
// header states, inv_l[r] = 1 / l and lse[r] = m + log2(l). Two passes
// over the row (the second from L2), so any N % 64 == 0 runs.
__global__ void __launch_bounds__(32 * kRowWarps)
attn_rows_kernel(const float* __restrict__ s, uint32_t* __restrict__ p,
                 float* __restrict__ inv_l, float* __restrict__ lse, long long rows, int N) {
  const long long r = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31, nj = N / 64;
  const float2* src = reinterpret_cast<const float2*>(s + r * N) + lane;
  float m = -INFINITY;
  for (int j = 0; j < nj; ++j) {
    const float2 x = src[32 * j];
    m = fmaxf(m, fmaxf(x.x, x.y));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  uint32_t* dst = p + r * (N / 2) + lane;
  float l = 0.f;
  for (int j = 0; j < nj; ++j) {
    const float2 x = src[32 * j];
    const uint32_t pp = vst::p_pair(x.x - m, x.y - m);
    l += vst::bf16_lo(pp);
    l += vst::bf16_hi(pp);
    dst[32 * j] = pp;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) {
    inv_l[r] = 1.f / l;
    lse[r] = m + log2f(l);
  }
}

// The launch preconditions both directions share: N, D multiples of 64,
// B H a grid dimension, B H N rows a 2-D tensor map coordinate.
bool shapes_ok(int B, int H, int N, int D) {
  return N > 0 && D > 0 && N % 64 == 0 && D % 64 == 0 && (long long)B * H <= 65535 &&
         (long long)B * H * N < (1ll << 31);
}

}  // namespace

namespace vst {

cudaError_t launch_attn_fwd_scores(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                   float* lse, void* scratch, int B, int H, int N, int D,
                                   long long sb, long long sn, long long sh, long long ob,
                                   long long on, long long oh, float qscale, cudaStream_t st) {
  if (!shapes_ok(B, H, N, D) || scratch == nullptr) return cudaErrorInvalidValue;
  const long long bhn = (long long)B * H * N;
  unsigned char* at = static_cast<unsigned char*>(scratch);
  float* s = reinterpret_cast<float*>(at);
  bf16* p = reinterpret_cast<bf16*>(at + 4 * bhn * N);
  bf16* qc = reinterpret_cast<bf16*>(at + 6 * bhn * N);
  float* inv_l = reinterpret_cast<float*>(at + 6 * bhn * N + 2 * bhn * D);
  CUtensorMap mqc, mk, mv, mp;
  if (!bhnd_tensor_map(&mqc, qc, B, N, H, D, (long long)N * H * D, (long long)H * D, D) ||
      !bhnd_tensor_map(&mk, k, B, N, H, D, sb, sn, sh) ||
      !bhnd_tensor_map(&mv, v, B, N, H, D, sb, sn, sh) || !matrix_tensor_map(&mp, p, bhn, N))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = allow_smem(attn_scores_kernel<false>, kSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(attn_out_kernel, kSmem)) != cudaSuccess) return err;
  const long long chunks = bhn * D / 8;
  attn_qc_kernel<<<static_cast<unsigned>((chunks + kQcThreads - 1) / kQcThreads), kQcThreads, 0,
                   st>>>(q, qc, H, N, D, sb, sn, sh, qscale, chunks);
  const int tn = (N + kTile - 1) / kTile;
  attn_scores_kernel<false><<<dim3(tn, tn, B * H), kThreads, kSmem, st>>>(
      mqc, mk, mqc, mk, nullptr, nullptr, s, nullptr, nullptr, H, N, D / 64);
  attn_rows_kernel<<<static_cast<unsigned>((bhn + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0,
                     st>>>(s, reinterpret_cast<uint32_t*>(p), inv_l, lse, bhn, N);
  attn_out_kernel<<<dim3((D + kTile - 1) / kTile, tn, B * H), kThreads, kSmem, st>>>(
      mp, mv, inv_l, 1.f, o, H, N, D, ob, on, oh);
  return cudaGetLastError();
}

cudaError_t launch_attn_bwd_scores(const bf16* k, const bf16* v, const bf16* qc, const bf16* d_o,
                                   const float* lse, const float* delta, bf16* pt, bf16* dst,
                                   bf16* dk, bf16* dv, int B, int H, int N, int D, long long sb,
                                   long long sn, long long sh, long long ob, long long on,
                                   long long oh, cudaStream_t st) {
  if (!shapes_ok(B, H, N, D) || pt == nullptr || dst == nullptr) return cudaErrorInvalidValue;
  const long long bhn = (long long)B * H * N;
  CUtensorMap mk, mv, mqc, mdo, mpt, mds;
  if (!bhnd_tensor_map(&mk, k, B, N, H, D, sb, sn, sh) ||
      !bhnd_tensor_map(&mv, v, B, N, H, D, sb, sn, sh) ||
      !bhnd_tensor_map(&mqc, qc, B, N, H, D, ob, on, oh) ||
      !bhnd_tensor_map(&mdo, d_o, B, N, H, D, ob, on, oh) ||
      !matrix_tensor_map(&mpt, pt, bhn, N) || !matrix_tensor_map(&mds, dst, bhn, N))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = allow_smem(attn_scores_kernel<true>, kSmem)) != cudaSuccess) return err;
  if ((err = allow_smem(attn_out_kernel, kSmem)) != cudaSuccess) return err;
  const int tn = (N + kTile - 1) / kTile;
  attn_scores_kernel<true><<<dim3(tn, tn, B * H), kThreads, kSmem, st>>>(
      mk, mqc, mv, mdo, lse, delta, nullptr, pt, dst, H, N, D / 64);
  const dim3 grid((D + kTile - 1) / kTile, tn, B * H);
  attn_out_kernel<<<grid, kThreads, kSmem, st>>>(mpt, mdo, nullptr, 1.f, dv, H, N, D, ob, on, oh);
  attn_out_kernel<<<grid, kThreads, kSmem, st>>>(mds, mqc, nullptr, kLn2, dk, H, N, D, ob, on,
                                                  oh);
  return cudaGetLastError();
}

}  // namespace vst
