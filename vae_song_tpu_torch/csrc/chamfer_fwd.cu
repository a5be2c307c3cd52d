// Chamfer forward for Hopper (sm_90a): the packed nearest-neighbour keys
// of two clouds both ways in one launch. For pred point i and gt point j,
// d2_ij = ((dx*dx) + (dy*dy)) + (dz*dz) is computed once, and two keys
// come from it: (bits(d2) & ~0x7FF) | j for pred i and (bits(d2) & ~0x7FF)
// | i for gt j. One int32 min over each gives the (truncated) min distance
// and the exact argmin, lower index first at ties.
//
// Replaces: vae_song_tpu/ops/chamfer.py:_chamfer_kernel (called through
// _chamfer_pallas_fwd_impl). The TPU kernel also computes both sides from
// one [8, T, Ng] block, carrying the gt-side minimum across pred tiles in
// scratch because its grid runs in order. Here the CTAs run in no order,
// so the gt-side keys of one cloud combine across its pred tiles with
// int32 atomicMin on a key row that the caller fills with 0x7FFFFFFF, and
// the last CTA of the cloud to finish (an atomic count down, after a
// fence) unpacks the row into (ming, argg). An integer min is exact and
// independent of order, so every run gives the same bits. The key row's
// atomicMin and the count's atomicSub are the kernel's only atomics. (A
// thread-block cluster of the cloud's pred tiles, combining through
// distributed shared memory, needs none; but a cluster's CTAs must all fit
// one GPC at once, and with one large CTA an SM the card held too few such
// clusters: the call took a wave more than independent CTAs do.)
//
// What bounds it: at B = 64, N = 2048 it is 2.7e8 pairs of at least 8 FP32
// and 3 INT32 instructions against 1.5 MB of input, so instruction issue
// bounds it, not memory. The design keeps the issue count near 11 a pair:
//   * a CTA of 8 warps takes 128 pred rows; each warp holds 16 of them in
//     registers (every lane the same 16), and each lane takes two gt
//     columns a step from shared memory, so one float4 load serves 16
//     pairs (of the shapes timed on the card, 8 warps of 16 rows were the
//     fastest: 16 warps of 16 or 8 rows, 8 of 32 and 4 of 16 or 32 were
//     not);
//   * a pair costs one AND for the value bits, then for each side one
//     min(value + index, running min): the value's low 11 bits are 0, so
//     + is |, and Hopper's DPX unit does add-then-min in one instruction
//     (VIADDMNMX): 8 FP32 and 3 INT32 instructions a pair;
//   * the pred-side keys reduce in registers across the lane's columns,
//     and across the 32 lanes once, at the end;
//   * the gt-side key of a column is complete over the warp's 16 rows in
//     the lane's registers; each warp stores it to its row of a [8, Ng]
//     array in shared memory, the CTA takes the min down the 8 rows (no
//     atomics) and sends one atomicMin a column to the cloud's key row.
// Rows and columns past the cloud's end repeat its last point. A column
// takes that point's index too, so its keys equal that point's; a row keeps
// its own index (below 2048, as a tile ends at a multiple of 128 no larger
// than 2048), so its keys tie the last point's on the value and lose on the
// index. Neither changes a minimum.
//
// d2 is written with the _rn intrinsics so nvcc cannot contract it into
// FMAs: the bits then match the TPU kernel and the plain PyTorch version
// exactly. d2 >= 0, so its f32 bit pattern orders like the value.
//
// scripts/ab_chamfer_fwd.cu includes this file and times variants of the
// kernel that strip or add one part; the package builds none of them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                      // pred rows a warp holds
constexpr int kTileRows = kWarps * kRows;      // pred rows a CTA takes
constexpr int kIdxBits = 0x7FF;                // 11 index bits: N <= 2048
constexpr int kKeyMax = 0x7FFFFFFF;

// Shared memory: the gt cloud as float4, then [kWarps, ng] gt-side keys.
size_t smem_bytes(int ng) { return (size_t)ng * (sizeof(float4) + kWarps * sizeof(int)); }

__device__ __forceinline__ int sq_dist_bits(float px, float py, float pz, float4 g) {
  const float dx = __fsub_rn(px, g.x);
  const float dy = __fsub_rn(py, g.y);
  const float dz = __fsub_rn(pz, g.z);
  return __float_as_int(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

__device__ __forceinline__ void write_key(float* val, int* idx, long long at, int key) {
  val[at] = __int_as_float(key & ~kIdxBits);
  idx[at] = key & kIdxBits;
}

// Grid (ceil(np / 128), B). pred [B, np, 3], gt [B, ng, 3] contiguous f32;
// minp / argp [B, np], ming / argg [B, ng]; scratch: the gt-side key row
// [B, ng], then a count [B], all 0x7FFFFFFF on entry.
__global__ void __launch_bounds__(kThreads, 1)
chamfer_fwd_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                   float* __restrict__ minp, int* __restrict__ argp,
                   float* __restrict__ ming, int* __restrict__ argg, int* __restrict__ scratch,
                   int np, int ng, int nb) {
  extern __shared__ float4 smem[];
  float4* gs = smem;                                   // [ng]
  int* part = reinterpret_cast<int*>(gs + ng);         // [kWarps, ng]
  __shared__ bool last;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTileRows + warp * kRows;

  const float* gb = gt + (long long)b * ng * 3;
  for (int j = threadIdx.x; j < ng; j += kThreads)
    gs[j] = make_float4(gb[3 * j], gb[3 * j + 1], gb[3 * j + 2], 0.f);

  float px[kRows], py[kRows], pz[kRows];
  int pk[kRows];
  const float* pb = pred + (long long)b * np * 3;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = min(row0 + r, np - 1);
    px[r] = pb[3 * i];
    py[r] = pb[3 * i + 1];
    pz[r] = pb[3 * i + 2];
    pk[r] = kKeyMax;
  }
  __syncthreads();

  // two columns a lane a step, ja and jb; past ng they repeat column ng - 1
  for (int j0 = 0; j0 < ng; j0 += 64) {
    const int ja = min(j0 + lane, ng - 1), jb = min(j0 + 32 + lane, ng - 1);
    const float4 ga = gs[ja], gb4 = gs[jb];
    // the gt-side minima over even and odd rows apart: shorter chains
    int gka0 = kKeyMax, gka1 = kKeyMax, gkb0 = kKeyMax, gkb1 = kKeyMax;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // the value bits; a key is value + index (the bits do not overlap),
      // so each key and its running min are one min(a + b, c)
      const int va = sq_dist_bits(px[r], py[r], pz[r], ga) & ~kIdxBits;
      const int vb = sq_dist_bits(px[r], py[r], pz[r], gb4) & ~kIdxBits;
      pk[r] = min(vb + jb, min(va + ja, pk[r]));
      // the gt side adds the row's offset r in the warp's rows here and
      // row0 once, at the store
      if (r & 1) {
        gka1 = min(va + r, gka1);
        gkb1 = min(vb + r, gkb1);
      } else {
        gka0 = min(va + r, gka0);
        gkb0 = min(vb + r, gkb0);
      }
    }
    if (j0 + lane < ng) part[warp * ng + j0 + lane] = min(gka0, gka1) + row0;
    if (j0 + 32 + lane < ng) part[warp * ng + j0 + 32 + lane] = min(gkb0, gkb1) + row0;
  }

  // the pred side: min across the lanes (each took other columns), then
  // lane r writes row r
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) pk[r] = min(pk[r], __shfl_xor_sync(0xffffffffu, pk[r], s));
  }
  int key = pk[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) {
    if (lane == r) key = pk[r];
  }
  if (lane < kRows && row0 + lane < np) write_key(minp, argp, (long long)b * np + row0 + lane, key);

  __syncthreads();
  // the CTA's gt-side keys: min down the warps' rows, then one atomicMin a
  // column into the cloud's key row
  int* keys = scratch + (long long)b * ng;
  for (int j = threadIdx.x; j < ng; j += kThreads) {
    int k = part[j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) k = min(k, part[w * ng + j]);
    atomicMin(&keys[j], k);
  }
  // the last CTA of the cloud to get here unpacks its key row
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* count = scratch + (long long)nb * ng + b;
    last = atomicSub(count, 1) == kKeyMax - (int)(gridDim.x - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < ng; j += kThreads)
    write_key(ming, argg, (long long)b * ng + j, __ldcg(&keys[j]));
}

}  // namespace

// pred [B, np, 3], gt [B, ng, 3] f32 contiguous; minp, argp [B, np] and
// ming, argg [B, ng] (f32, int32) written; scratch int32 [B * (ng + 1)]
// filled with 0x7FFFFFFF by the caller (the gt-side key row, then a count
// a cloud); 1 <= np, ng <= 2048 (11 index bits). The caller checks shapes,
// dtype and contiguity. Returns cudaGetLastError() after the launch.
extern "C" int vst_chamfer_nn_packed(const void* pred, const void* gt, void* minp, void* argp,
                                     void* ming, void* argg, void* scratch, int B, int np,
                                     int ng, void* stream) {
  const cudaError_t err = vst::allow_smem(chamfer_fwd_kernel, smem_bytes(ng));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((np + kTileRows - 1) / kTileRows, B);
  chamfer_fwd_kernel<<<grid, kThreads, smem_bytes(ng), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(gt),
      static_cast<float*>(minp), static_cast<int*>(argp), static_cast<float*>(ming),
      static_cast<int*>(argg), static_cast<int*>(scratch), np, ng, B);
  return static_cast<int>(cudaGetLastError());
}
