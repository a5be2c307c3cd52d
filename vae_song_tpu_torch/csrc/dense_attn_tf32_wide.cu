// f32 attention forward and backward for Hopper (sm_90a) at head widths
// D % 64 == 0 from 192 up: split-TF32 mma.sync kernels (mma_tf32.cuh),
// [B, N, H, D] tensors read through strides.
//
// Replaces: the f32 path (cd = f32, denseattn.py:82-85) of
// vae_song_tpu/ops/denseattn.py:_fwd_kernel (K3f, through _call_fwd) and
// _bwd_kernel (K3b, through _call_bwd) at those widths: SetVAE under
// `mixed_precision: false` with one head of 256 (d_model 256), or wider
// models with one or two heads. The function and its roundings are those
// of dense_attn_fwd.cu and dense_attn_bwd.cu in f32:
//   qc = q * scale * log2e (one f32 multiply), S2 = qc k^T, m = exact row
//   max, P = exp2(S2 - m), O = P v / rowsum(P), LSE2 = m + log2(rowsum(P));
//   backward: P = exp2(qc k^T - LSE2), dV = P^T dO, dP = dO v^T,
//   dS = P (dP - delta), dQ = dS k scale, dK = dS^T qc ln2,
// with delta = rowsum(dO O) from the backward's preprocess pass.
//
// What bounds them here: 4 B H N^2 D operations forward and 10 B H N^2 D
// backward, 14 as executed (S and dP in both the dK/dV and the dQ kernel,
// the price of no atomics). At the f32 path's B = 64, H = 1, N = 2048,
// D = 256 that is 2.75e11 and 9.6e11: 1.67 and 5.83 ms as split TF32
// (three TF32 products a product, 495 TFLOP/s) against 4.1 and 10.3 ms
// on the FMA units (67 TFLOP/s). mma.sync runs 115-135 TFLOP/s of TF32
// products on an H100 (the kernels at D = 64 and 128), which sets the
// time, so the design spends nothing on products it does not need.
//
// Design. The kernels at D = 64 and 128 give one warp 16 rows and all D
// columns of O (or half of dK/dV and dQ); from D = 192 a thread would hold
// D / 2 accumulators or more. So the head's columns are split across the
// warps of a row group, 64 each (C = D / 64 warps): each warp sums the
// scores (and dP) over its 64 columns, 8 split-TF32 steps, each into a
// fresh accumulator added to the running sum in f32; the partial sums go
// through shared memory and every warp adds them in the order 0, 1, ..,
// C - 1, so all warps of the group hold the same S bits; each warp then
// forms P (and dS) in registers, the A operand of the next product
// (mma_tf32.cuh's permuted contraction), and accumulates its own 64
// columns of O, dQ (32 registers a thread) or dK and dV (64) at every D.
// S and dP are computed once per pair of tiles: 4 B H N^2 D products
// forward, 14 backward. A block holds the most row groups of 16 rows
// (forward 4, 2 or 1; backward 2 or 1) that keep at least two blocks an SM
// in the grid, 512 threads (forward) or 256 (backward) and 227 KB of shared
// memory; B = 1, N = 2048 runs 128 blocks of one row group on the 132 SMs.
// The block's own rows (qc; K and V; qc and dO) stay in shared memory for
// the whole head, the other side streams in tiles of 16 rows through two
// cp.async stages; rows padded to D + 4 floats, so every fragment read is
// free of bank conflicts. A tile costs one __syncthreads: each iteration
// waits for its own copies, meets the block (every warp is then done with
// the previous tile, its stage and the exchange slots) and only then
// issues the next tile's copies. On an H100 (scripts/ab_attn_f32.py)
// time followed warps an SM more than anything else: the backward kernels
// take 160-220 registers, so 8 warps an SM; 32-row tiles, 8-row tiles
// with two blocks an SM and a fully unrolled score loop landed within
// 10%. The whole head is staged up to D = 512 (C = 8; the backward's
// 214 KB).
// Above, a block owns one group of wg <= 8 warps' output columns (ng =
// ceil(C / 8) groups, wg = ceil(C / ng)) and sums S over the whole head in
// ng panels of 64 wg columns, staged one after another: warp w takes
// columns 64 (p wg + w) .. of panel p. Groups are 320 to 512 columns
// wide, and S is computed ng = ceil(D / 512) times (at most D / 256).
// No atomics, every sum in a fixed order: the same bits on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_attn_tf32_wide.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90.cuh"

namespace {

constexpr int kT = 16;                 // rows of a streamed tile
constexpr int kNT = kT / 8;            // its 8-row blocks (n-tiles of S)
constexpr int kCW = 64;                // head columns a warp owns
constexpr int kMaxWarps = 8;           // warps a row group
constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;
constexpr size_t kMaxSmem = 232448;    // 227 KB, the most a block may have
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows r0 .. r0 + rows - 1, columns c0 .. c0 + cols - 1 of one head of an
// f32 [B, N, H, D] tensor (`head` its element offset, `stride` its row
// stride, both multiples of 4) into a [rows][ld] shared tile, 16 bytes a
// cp.async, by the block's nthr threads (not committed).
__device__ __forceinline__ void cp_rows(float* tile, int ld, const float* src, long long head,
                                        long long stride, int r0, int rows, int c0, int cols,
                                        int tid, int nthr) {
  const int per = cols >> 2;   // 16-byte copies a row; thread tid takes copies tid + i nthr
  const int dr = nthr / per, dc = nthr - dr * per;
  for (int r = tid / per, c = tid - r * per; r < rows;) {
    vst::cp_async16(tile + r * ld + 4 * c, src + head + (long long)(r0 + r) * stride + c0 + 4 * c);
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// The same rows read synchronously and multiplied by `mul` (q into qc:
// one f32 multiply, the plain version's rounding).
__device__ __forceinline__ void load_rows_scaled(float* tile, int ld, const float* src,
                                                 long long head, long long stride, int r0,
                                                 int rows, int c0, int cols, int tid, int nthr,
                                                 float mul) {
  const int per = cols >> 2;
  const int dr = nthr / per, dc = nthr - dr * per;
  for (int r = tid / per, c = tid - r * per; r < rows;) {
    float4 x =
        *reinterpret_cast<const float4*>(src + head + (long long)(r0 + r) * stride + c0 + 4 * c);
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *reinterpret_cast<float4*>(tile + r * ld + 4 * c) = x;
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// x[j] += the scores of rows r0 .. r0 + 15 of tile `a` against rows 8 j ..
// 8 j + 7 of tile `bt`, over columns c0 .. c0 + 63 (8 steps of 8), bt's
// values multiplied by `bmul` as they are read. The steps are unrolled two
// at a time: fully unrolled in the kernels at D = 128, ptxas hoisted loads
// until it spilled.
__device__ __forceinline__ void partial_scores(float (&x)[kNT][4], const float* a,
                                               const float* bt, int ld, int r0, int c0, int g,
                                               int t, float bmul) {
#pragma unroll 2
  for (int kk = 0; kk < kCW / 8; ++kk) {
    const vst::SplitA fa = vst::a_from_smem(a, ld, r0, c0 + 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      vst::mma_b_rows_t(x[j], fa, bt, ld, 8 * j, c0 + 8 * kk, g, t, bmul);
  }
}

// acc (16 rows x columns c0 .. c0 + 63) += p b: p a 16 x kT tile in the
// accumulator layout (P, P^T, dS or dS^T), b the kT rows of a tile, its
// values multiplied by `bmul` as they are read.
__device__ __forceinline__ void accumulate(float (&acc)[kCW / 8][4], const float (&p)[kNT][4],
                                           const float* b, int ld, int c0, int g, int t,
                                           float bmul) {
#pragma unroll
  for (int kc = 0; kc < kNT; ++kc) {
    const vst::SplitA fa = vst::a_from_acc(p[kc]);
#pragma unroll
    for (int j = 0; j < kCW / 8; ++j)
      vst::mma_b_rows(acc[j], fa, b, ld, 8 * kc, c0 + 8 * j, g, t, bmul);
  }
}

// The row group's partial sums, added in a fixed order: warp w writes its
// NX partial tiles to slot w (one float4 a lane an 8-column block), the
// wg warps meet at named barrier `bar`, then each warp sets x to slot 0
// and adds slots 1, .., wg - 1 in turn, so every warp holds the same
// bits. Each tile's loop opens with a __syncthreads of the block, so the
// slots are written again only after every warp has read them.
template <int NX>
__device__ __forceinline__ void group_sum(float (&x)[NX][kNT][4], float4* slots, int w, int wg,
                                          int lane, int bar) {
  constexpr int kSlot = NX * kNT * 32;
  float4* mine = slots + w * kSlot + lane;
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      mine[(i * kNT + j) * 32] = make_float4(x[i][j][0], x[i][j][1], x[i][j][2], x[i][j][3]);
  vst::named_sync(bar, 32 * wg);
  const float4* s = slots + lane;
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float4 y = s[(i * kNT + j) * 32];
      x[i][j][0] = y.x;
      x[i][j][1] = y.y;
      x[i][j][2] = y.z;
      x[i][j][3] = y.w;
    }
  for (int u = 1; u < wg; ++u) {
    s += kSlot;
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float4 y = s[(i * kNT + j) * 32];
        x[i][j][0] += y.x;
        x[i][j][1] += y.y;
        x[i][j][2] += y.z;
        x[i][j][3] += y.w;
      }
  }
}

// Where a thread sits. blockDim.x = 32 wg rg: rg row groups of 16 rows,
// wg warps each; block x = row tile * ng + column group cg. With ng = 1
// (the whole head staged) a tile row is D + 4 floats; with column groups
// it is one panel of pw = 64 wg columns + 4.
struct Place {
  bool whole;
  int pw, ld, rows, cg, r_first, gi, w, r16, col, oc, ocols, lane, g, t, tid, nthr;
  __device__ Place(int D, int wg, int ng) {
    whole = ng == 1;
    pw = whole ? D : kCW * wg;
    ld = pw + 4;
    nthr = blockDim.x;
    rows = 16 * (nthr / (32 * wg));
    cg = blockIdx.x % ng;
    r_first = blockIdx.x / ng * rows;
    tid = threadIdx.x;
    const int warp = tid >> 5;
    lane = tid & 31;
    g = lane >> 2;
    t = lane & 3;
    gi = warp / wg;
    w = warp - gi * wg;
    r16 = 16 * gi;
    col = kCW * w;
    oc = cg * pw;
    ocols = min(pw, D - oc);
  }
  // whether the warp has output columns (the last column group may leave
  // some warps none)
  __device__ bool owns() const { return col < ocols; }
};

// The stage pointers of the whole-head loop: tile `it` of the streamed
// side in two stages of two [kT][ld] tensors. Each iteration waits for its
// tile, meets the block at one __syncthreads (the tile is in; every warp
// is done with tile it - 1, whose stage the next copies then refill) and
// only then issues tile it + 1, so one barrier a tile orders the ring.
__device__ __forceinline__ float* stage_of(float* st0, int ld, int it) {
  return st0 + (it & 1) * 2 * kT * ld;
}

// Forward. Grid (N / rows * ng, H, B). The block's qc rows stay staged
// (whole head) while K and V stream in tiles of kT keys; per tile each warp
// sums S over its columns, the row group adds the partial sums in warp
// order, every warp runs the online softmax (the exact running max) on the
// same S and accumulates its 64 columns of O. Warp 0 of each row group of
// column group 0 writes LSE2.
__global__ void __launch_bounds__(kFwdThreads)
attn_fwd_tf32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int N, int D, int wg, int ng,
                          long long sb, long long sn, long long sh, long long ob, long long on,
                          long long oh, float qscale) {
  extern __shared__ __align__(16) float fsm[];
  const Place at(D, wg, ng);
  const int ld = at.ld, g = at.g, t = at.t;
  const int h = blockIdx.y, b = blockIdx.z, q0 = at.r_first;
  const long long head = (long long)b * sb + (long long)h * sh;
  float* qs = fsm;                    // [rows][ld] qc
  float* st0 = qs + at.rows * ld;     // K then V, [kT][ld] each: two stages, or one
  float4* slots = reinterpret_cast<float4*>(st0 + (at.whole ? 4 : 2) * kT * ld) +
                  at.gi * wg * kNT * 32;
  const int nk = N / kT;

  auto stage = [&](int it) {   // K and V tile it, the whole head
    float* kt = stage_of(st0, ld, it);
    cp_rows(kt, ld, k, head, sn, it * kT, kT, 0, D, at.tid, at.nthr);
    cp_rows(kt + kT * ld, ld, v, head, sn, it * kT, kT, 0, D, at.tid, at.nthr);
    vst::cp_async_commit();
  };
  if (at.whole) {
    stage(0);
    load_rows_scaled(qs, ld, q, head, sn, q0, at.rows, 0, D, at.tid, at.nthr, qscale);
  }

  float acc[kCW / 8][4];
#pragma unroll
  for (int j = 0; j < kCW / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the row sums

  for (int it = 0; it < nk; ++it) {
    float s[1][kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[0][j][0] = s[0][j][1] = s[0][j][2] = s[0][j][3] = 0.f;
    const float* vt;
    if (at.whole) {
      vst::cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < nk) stage(it + 1);
      const float* kt = stage_of(st0, ld, it);
      vt = kt + kT * ld;
      partial_scores(s[0], qs, kt, ld, at.r16, at.col, g, t, 1.f);
    } else {
      for (int p = 0; p < ng; ++p) {   // panel p: qc and K columns p pw ..
        const int c0 = p * at.pw, cols = min(at.pw, D - c0);
        __syncthreads();   // the previous panel (and tile) is read
        cp_rows(st0, ld, k, head, sn, it * kT, kT, c0, cols, at.tid, at.nthr);
        vst::cp_async_commit();
        load_rows_scaled(qs, ld, q, head, sn, q0, at.rows, c0, cols, at.tid, at.nthr, qscale);
        vst::cp_async_wait<0>();
        __syncthreads();
        if (at.col < cols) partial_scores(s[0], qs, st0, ld, at.r16, at.col, g, t, 1.f);
      }
      vt = st0 + kT * ld;   // V's columns of this block's group
      cp_rows(st0 + kT * ld, ld, v, head, sn, it * kT, kT, at.oc, at.ocols, at.tid, at.nthr);
      vst::cp_async_commit();
      vst::cp_async_wait<0>();
      __syncthreads();
    }
    group_sum(s, slots, at.w, wg, at.lane, 1 + at.gi);

    // online softmax: the exact running max, P = exp2(S2 - m) in f32
    float n0 = m0, n1 = m1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      n0 = fmaxf(n0, fmaxf(s[0][j][0], s[0][j][1]));
      n1 = fmaxf(n1, fmaxf(s[0][j][2], s[0][j][3]));
    }
    n0 = quad_max(n0);
    n1 = quad_max(n1);
    const float a0 = exp2f(m0 - n0);   // 0 on the first tile (m = -inf)
    const float a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[0][j][0] = exp2f(s[0][j][0] - n0);
      s[0][j][1] = exp2f(s[0][j][1] - n0);
      s[0][j][2] = exp2f(s[0][j][2] - n1);
      s[0][j][3] = exp2f(s[0][j][3] - n1);
      ps0 += s[0][j][0] + s[0][j][1];
      ps1 += s[0][j][2] + s[0][j][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int j = 0; j < kCW / 8; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
    if (at.owns()) accumulate(acc, s[0], vt, ld, at.col, g, t, 1.f);   // O += P V
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* lrow = lse + ((long long)b * H + h) * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + at.r16 + g + 8 * half;
    const float l = half ? l1 : l0;
    if (at.owns()) {
      float* dst = o + (long long)b * ob + (long long)row * on + (long long)h * oh + at.oc +
                   at.col + 2 * t;
#pragma unroll
      for (int j = 0; j < kCW / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[j][2 * half] / l, acc[j][2 * half + 1] / l);
    }
    if (at.w == 0 && at.cg == 0 && t == 0) lrow[row] = (half ? m1 : m0) + log2f(l);
  }
}

// dK/dV. Grid (N / rows * ng, H, B). The block's K and V rows stay staged
// (whole head) while q and dO stream in tiles of kT queries; per tile each
// warp sums S^T = K qc^T and dP^T = V dO^T over its columns (qc = q
// qscale as each value is read), the row group adds the partial sums in
// warp order, every warp forms P^T = exp2(S^T - LSE2) and dS^T = P^T
// (dP^T - delta) and accumulates its 64 columns of dV += P^T dO and dK +=
// dS^T qc.
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dkdv_tf32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ d_o,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int H, int N,
                               int D, int wg, int ng, long long sb, long long sn, long long sh,
                               long long ob, long long on, long long oh, float qscale) {
  extern __shared__ __align__(16) float fsm[];
  const Place at(D, wg, ng);
  const int ld = at.ld, g = at.g, t = at.t;
  const int h = blockIdx.y, b = blockIdx.z, k0 = at.r_first;
  const long long head = (long long)b * sb + (long long)h * sh;
  const long long ohead = (long long)b * ob + (long long)h * oh;
  const float* lrow = lse + ((long long)b * H + h) * N;
  const float* drow = delta + ((long long)b * H + h) * N;
  float* ks = fsm;                    // [rows][ld] K
  float* vs = ks + at.rows * ld;      // [rows][ld] V
  float* st0 = vs + at.rows * ld;     // q then dO, [kT][ld] each: two stages, or one
  float4* slots = reinterpret_cast<float4*>(st0 + (at.whole ? 4 : 2) * kT * ld) +
                  at.gi * wg * 2 * kNT * 32;
  const int nq = N / kT;

  auto stage = [&](int it) {   // q and dO tile it, the whole head
    float* qt = stage_of(st0, ld, it);
    cp_rows(qt, ld, q, head, sn, it * kT, kT, 0, D, at.tid, at.nthr);
    cp_rows(qt + kT * ld, ld, d_o, ohead, on, it * kT, kT, 0, D, at.tid, at.nthr);
    vst::cp_async_commit();
  };
  if (at.whole) {
    cp_rows(ks, ld, k, head, sn, k0, at.rows, 0, D, at.tid, at.nthr);
    cp_rows(vs, ld, v, head, sn, k0, at.rows, 0, D, at.tid, at.nthr);
    stage(0);   // one group with the resident rows
  }

  float adk[kCW / 8][4], adv[kCW / 8][4];
#pragma unroll
  for (int j = 0; j < kCW / 8; ++j)
    adk[j][0] = adk[j][1] = adk[j][2] = adk[j][3] = adv[j][0] = adv[j][1] = adv[j][2] =
        adv[j][3] = 0.f;

  for (int it = 0; it < nq; ++it) {
    float x[2][kNT][4];   // S^T, dP^T: 16 keys x kT queries
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      x[0][j][0] = x[0][j][1] = x[0][j][2] = x[0][j][3] = x[1][j][0] = x[1][j][1] =
          x[1][j][2] = x[1][j][3] = 0.f;
    const float *qt, *dot;
    if (at.whole) {
      vst::cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < nq) stage(it + 1);
      qt = stage_of(st0, ld, it);
      dot = qt + kT * ld;
      partial_scores(x[0], ks, qt, ld, at.r16, at.col, g, t, qscale);
      partial_scores(x[1], vs, dot, ld, at.r16, at.col, g, t, 1.f);
    } else {
      for (int p = 0; p < ng; ++p) {   // panel p of K, V, q and dO
        const int c0 = p * at.pw, cols = min(at.pw, D - c0);
        __syncthreads();
        cp_rows(ks, ld, k, head, sn, k0, at.rows, c0, cols, at.tid, at.nthr);
        cp_rows(vs, ld, v, head, sn, k0, at.rows, c0, cols, at.tid, at.nthr);
        cp_rows(st0, ld, q, head, sn, it * kT, kT, c0, cols, at.tid, at.nthr);
        cp_rows(st0 + kT * ld, ld, d_o, ohead, on, it * kT, kT, c0, cols, at.tid, at.nthr);
        vst::cp_async_commit();
        vst::cp_async_wait<0>();
        __syncthreads();
        if (at.col < cols) {
          partial_scores(x[0], ks, st0, ld, at.r16, at.col, g, t, qscale);
          partial_scores(x[1], vs, st0 + kT * ld, ld, at.r16, at.col, g, t, 1.f);
        }
      }
      __syncthreads();   // q and dO of this block's group of columns
      cp_rows(st0, ld, q, head, sn, it * kT, kT, at.oc, at.ocols, at.tid, at.nthr);
      cp_rows(st0 + kT * ld, ld, d_o, ohead, on, it * kT, kT, at.oc, at.ocols, at.tid, at.nthr);
      vst::cp_async_commit();
      vst::cp_async_wait<0>();
      __syncthreads();
      qt = st0;
      dot = st0 + kT * ld;
    }
    group_sum(x, slots, at.w, wg, at.lane, 1 + at.gi);

    // P^T and dS^T; accumulator columns 2 t, 2 t + 1 of block j are queries
    // it kT + 8 j + 2 t, + 1
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int qi = it * kT + 8 * j + 2 * t;
      const float la = lrow[qi], lb = lrow[qi + 1], da = drow[qi], db = drow[qi + 1];
      x[0][j][0] = exp2f(x[0][j][0] - la);
      x[0][j][1] = exp2f(x[0][j][1] - lb);
      x[0][j][2] = exp2f(x[0][j][2] - la);
      x[0][j][3] = exp2f(x[0][j][3] - lb);
      x[1][j][0] = x[0][j][0] * (x[1][j][0] - da);
      x[1][j][1] = x[0][j][1] * (x[1][j][1] - db);
      x[1][j][2] = x[0][j][2] * (x[1][j][2] - da);
      x[1][j][3] = x[0][j][3] * (x[1][j][3] - db);
    }
    if (at.owns()) {
      accumulate(adv, x[0], dot, ld, at.col, g, t, 1.f);    // dV += P^T dO
      accumulate(adk, x[1], qt, ld, at.col, g, t, qscale);  // dK += dS^T qc
    }
  }

  if (!at.owns()) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long out =
        ohead + (long long)(k0 + at.r16 + g + 8 * half) * on + at.oc + at.col + 2 * t;
#pragma unroll
    for (int j = 0; j < kCW / 8; ++j) {
      *reinterpret_cast<float2*>(dk + out + 8 * j) =
          make_float2(adk[j][2 * half] * kLn2, adk[j][2 * half + 1] * kLn2);
      *reinterpret_cast<float2*>(dv + out + 8 * j) =
          make_float2(adv[j][2 * half], adv[j][2 * half + 1]);
    }
  }
}

// dQ. Grid (N / rows * ng, H, B). The block's qc rows (prescaled as they
// are staged) and dO rows stay staged (whole head) while K and V stream in
// tiles of kT keys; per tile each warp sums S = qc K^T and dP = dO V^T over
// its columns, the row group adds the partial sums in warp order, every
// warp forms P = exp2(S - LSE2) and dS = P (dP - delta) and accumulates
// its 64 columns of dQ += dS K.
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dq_tf32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ d_o,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, int H, int N, int D, int wg, int ng,
                             long long sb, long long sn, long long sh, long long ob,
                             long long on, long long oh, float qscale, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const Place at(D, wg, ng);
  const int ld = at.ld, g = at.g, t = at.t;
  const int h = blockIdx.y, b = blockIdx.z, q0 = at.r_first;
  const long long head = (long long)b * sb + (long long)h * sh;
  const long long ohead = (long long)b * ob + (long long)h * oh;
  float* qs = fsm;                    // [rows][ld] qc
  float* dos = qs + at.rows * ld;     // [rows][ld] dO
  float* st0 = dos + at.rows * ld;    // K then V, [kT][ld] each: two stages, or one
  float4* slots = reinterpret_cast<float4*>(st0 + (at.whole ? 4 : 2) * kT * ld) +
                  at.gi * wg * 2 * kNT * 32;
  const int nk = N / kT;

  auto stage = [&](int it) {   // K and V tile it, the whole head
    float* kt = stage_of(st0, ld, it);
    cp_rows(kt, ld, k, head, sn, it * kT, kT, 0, D, at.tid, at.nthr);
    cp_rows(kt + kT * ld, ld, v, head, sn, it * kT, kT, 0, D, at.tid, at.nthr);
    vst::cp_async_commit();
  };
  if (at.whole) {
    cp_rows(dos, ld, d_o, ohead, on, q0, at.rows, 0, D, at.tid, at.nthr);
    stage(0);   // one group with the resident dO rows
    load_rows_scaled(qs, ld, q, head, sn, q0, at.rows, 0, D, at.tid, at.nthr, qscale);
  }

  const long long hrow = ((long long)b * H + h) * N;
  const int r0 = q0 + at.r16 + g;
  const float l0 = lse[hrow + r0], l1 = lse[hrow + r0 + 8];
  const float d0 = delta[hrow + r0], d1 = delta[hrow + r0 + 8];
  float acc[kCW / 8][4];
#pragma unroll
  for (int j = 0; j < kCW / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < nk; ++it) {
    float x[2][kNT][4];   // S, dP: 16 queries x kT keys
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      x[0][j][0] = x[0][j][1] = x[0][j][2] = x[0][j][3] = x[1][j][0] = x[1][j][1] =
          x[1][j][2] = x[1][j][3] = 0.f;
    const float* kt;
    if (at.whole) {
      vst::cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < nk) stage(it + 1);
      kt = stage_of(st0, ld, it);
      partial_scores(x[0], qs, kt, ld, at.r16, at.col, g, t, 1.f);
      partial_scores(x[1], dos, kt + kT * ld, ld, at.r16, at.col, g, t, 1.f);
    } else {
      for (int p = 0; p < ng; ++p) {   // panel p of qc, dO, K and V
        const int c0 = p * at.pw, cols = min(at.pw, D - c0);
        __syncthreads();
        cp_rows(dos, ld, d_o, ohead, on, q0, at.rows, c0, cols, at.tid, at.nthr);
        cp_rows(st0, ld, k, head, sn, it * kT, kT, c0, cols, at.tid, at.nthr);
        cp_rows(st0 + kT * ld, ld, v, head, sn, it * kT, kT, c0, cols, at.tid, at.nthr);
        vst::cp_async_commit();
        load_rows_scaled(qs, ld, q, head, sn, q0, at.rows, c0, cols, at.tid, at.nthr, qscale);
        vst::cp_async_wait<0>();
        __syncthreads();
        if (at.col < cols) {
          partial_scores(x[0], qs, st0, ld, at.r16, at.col, g, t, 1.f);
          partial_scores(x[1], dos, st0 + kT * ld, ld, at.r16, at.col, g, t, 1.f);
        }
      }
      __syncthreads();   // K of this block's group of columns
      cp_rows(st0, ld, k, head, sn, it * kT, kT, at.oc, at.ocols, at.tid, at.nthr);
      vst::cp_async_commit();
      vst::cp_async_wait<0>();
      __syncthreads();
      kt = st0;
    }
    group_sum(x, slots, at.w, wg, at.lane, 1 + at.gi);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      x[0][j][0] = exp2f(x[0][j][0] - l0);
      x[0][j][1] = exp2f(x[0][j][1] - l0);
      x[0][j][2] = exp2f(x[0][j][2] - l1);
      x[0][j][3] = exp2f(x[0][j][3] - l1);
      x[1][j][0] = x[0][j][0] * (x[1][j][0] - d0);
      x[1][j][1] = x[0][j][1] * (x[1][j][1] - d0);
      x[1][j][2] = x[0][j][2] * (x[1][j][2] - d1);
      x[1][j][3] = x[0][j][3] * (x[1][j][3] - d1);
    }
    if (at.owns()) accumulate(acc, x[1], kt, ld, at.col, g, t, 1.f);   // dQ += dS K
  }

  if (!at.owns()) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* dst = dq + ohead + (long long)(r0 + 8 * half) * on + at.oc + at.col + 2 * t;
#pragma unroll
    for (int j = 0; j < kCW / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
  }
}

// A launch's shape: wg warps a row group, ng column groups, rg row groups
// a block, and its shared memory.
struct Plan {
  int wg, ng, rg;
  size_t smem;
};

// The whole head while C = D / 64 <= 8 (one warp a 64-column chunk), else
// column groups of at most 8 warps; then the most row groups, from
// max_rg down by halves (1 where there are column groups), that fit
// max_threads and 227 KB and keep at least two blocks an SM in the grid.
// `nx`: the tensors of the block's own rows staged (forward 1, backward
// 2), each also one tensor streamed and one partial tile a warp exchanged.
cudaError_t plan(int B, int H, int N, int D, int nx, int max_threads, int max_rg, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int C = D / kCW;
  p->ng = (C + kMaxWarps - 1) / kMaxWarps;
  p->wg = (C + p->ng - 1) / p->ng;
  const bool whole = p->ng == 1;
  const size_t ld = (whole ? D : kCW * p->wg) + 4;
  for (int rg = whole ? max_rg : 1;; rg /= 2) {
    const size_t smem = sizeof(float) * ((size_t)nx * 16 * rg * ld + (whole ? 4 : 2) * kT * ld +
                                         (size_t)rg * p->wg * nx * 16 * kT);
    if (rg == 1 || (32 * p->wg * rg <= max_threads && smem <= kMaxSmem &&
                    (long long)B * H * (N / (16 * rg)) >= 2LL * sms)) {
      p->rg = rg;
      p->smem = smem;
      return smem <= kMaxSmem ? cudaSuccess : cudaErrorInvalidValue;
    }
  }
}

}  // namespace

namespace vst {

cudaError_t launch_attn_fwd_tf32_wide(const float* q, const float* k, const float* v, float* o,
                                      float* lse, int B, int H, int N, int D, long long sb,
                                      long long sn, long long sh, long long ob, long long on,
                                      long long oh, float qscale, cudaStream_t st) {
  if (D % kCW != 0 || D < 3 * kCW || N % 64 != 0) return cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan(B, H, N, D, 1, kFwdThreads, 4, &p);
  if (err == cudaSuccess) err = vst::allow_smem(attn_fwd_tf32_wide_kernel, p.smem);
  if (err != cudaSuccess) return err;
  attn_fwd_tf32_wide_kernel<<<dim3(N / (16 * p.rg) * p.ng, H, B), 32 * p.wg * p.rg, p.smem,
                              st>>>(q, k, v, o, lse, H, N, D, p.wg, p.ng, sb, sn, sh, ob, on,
                                    oh, qscale);
  return cudaGetLastError();
}

cudaError_t launch_attn_bwd_tf32_wide(const float* q, const float* k, const float* v,
                                      const float* d_o, const float* lse, const float* delta,
                                      float* dq, float* dk, float* dv, int B, int H, int N,
                                      int D, long long sb, long long sn, long long sh,
                                      long long ob, long long on, long long oh, float qscale,
                                      float scale, cudaStream_t st) {
  if (D % kCW != 0 || D < 3 * kCW || N % 64 != 0) return cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan(B, H, N, D, 2, kBwdThreads, 2, &p);
  if (err == cudaSuccess) err = vst::allow_smem(attn_bwd_dkdv_tf32_wide_kernel, p.smem);
  if (err == cudaSuccess) err = vst::allow_smem(attn_bwd_dq_tf32_wide_kernel, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / (16 * p.rg) * p.ng, H, B);
  const int threads = 32 * p.wg * p.rg;
  attn_bwd_dkdv_tf32_wide_kernel<<<grid, threads, p.smem, st>>>(
      q, k, v, d_o, lse, delta, dk, dv, H, N, D, p.wg, p.ng, sb, sn, sh, ob, on, oh, qscale);
  attn_bwd_dq_tf32_wide_kernel<<<grid, threads, p.smem, st>>>(
      q, k, v, d_o, lse, delta, dq, H, N, D, p.wg, p.ng, sb, sn, sh, ob, on, oh, qscale, scale);
  return cudaGetLastError();
}

}  // namespace vst
