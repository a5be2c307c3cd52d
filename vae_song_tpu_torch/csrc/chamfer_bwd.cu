// Chamfer backward for Hopper (sm_90a): the gradient of the symmetric
// Chamfer value routed through the nearest-neighbour indices of the
// forward (argp: pred -> gt, argg: gt -> pred).
//
// Replaces: vae_song_tpu/ops/chamfer.py:_chamfer_bwd_kernel (called
// through _chamfer_bwd_pallas). With sp = 1 / (B Np), sg = 1 / (B Ng):
//   d_pred_i = 2 sp (pred_i - gt_{argp_i}) - sum_{j: argg_j = i} 2 sg (gt_j - pred_i)
//   d_gt_j   = 2 sg (gt_j - pred_{argg_j}) - sum_{i: argp_i = j} 2 sp (pred_i - gt_j)
// The TPU kernel turns the scatter into masked bf16 matmuls over packed
// hi/lo columns and adds d_gt across pred tiles in its output block, an
// answer to the TPU's lack of scatter that relies on the sequential grid
// (chamfer.py:232-238).
//
// Here one CTA takes one side of one cloud (grid (B, 2)) and inverts the
// other side's argmin row in shared memory with a stable counting sort:
//   1. count the sources (other-side points) that chose each target (this
//      side's point), with shared-memory integer atomicAdd (exact);
//   2. an exclusive scan of the counts (warp shuffles, then the warps'
//      totals) gives each target's list start;
//   3. one warp places the sources 32 at a time in ascending order: lanes
//      that chose the same target find each other with __match_any_sync,
//      take their rank among themselves below a per-target cursor, and the
//      highest of them advances the cursor, so each list holds its sources
//      in ascending index order. Meanwhile the other warps compute each
//      source's term (2 (r_j - q_{t_j})) / (B N_r) once, in source order;
//   4. each target starts from its own term (2 (q_i - r_{own_i})) / (B N_q),
//      computed first so that its gathers overlap steps 1-3, and subtracts
//      its list's terms in list order.
// That is the order of the plain version (`_chamfer_bwd_xla`'s gather, then
// an index_add that adds in ascending index order on the CPU), with each
// term computed as it computes it, IEEE division and no FMA contraction,
// so the result is the same on every run. No floating-point atomics:
// they would change the order of the sums.
//
// What bounds it: the work is O(N) a side (3 MB of clouds and indices at
// B = 64, N = 2048), so memory latency and the placement's 64 serial
// steps bound a CTA, not throughput; the placement finds the peers of 8
// steps at a time, so that only the cursor's read and write are serial. Skew moves work only onto the thread that owns a
// popular target: it subtracts its list from shared memory, three
// independent chains, with no divergent global loads in its warp.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 2048;   // the forward's 11 index bits
constexpr int kAhead = 8;     // placement steps whose peers are found together
constexpr int kPerThread = kMaxN / kThreads;   // targets a thread sums

// Shared memory: target [kMaxN] (the other side's argmins), cursor
// [kMaxN] (counts, then each list's next free slot), start [kMaxN + 1],
// list [kMaxN] (sources by target), wsum [kWarps], then the terms as
// float4 [kMaxN] (aligned first).
constexpr size_t kSmemBytes =
    kMaxN * sizeof(float4) + (4 * kMaxN + 1 + kWarps) * sizeof(int);

__device__ __forceinline__ float term(float a, float b, float denom) {
  return __fdiv_rn(__fmul_rn(2.f, __fsub_rn(a, b)), denom);
}

// Grid (B, 2): y = 0 writes d_pred, y = 1 d_gt.
__global__ void __launch_bounds__(kThreads, 1)
chamfer_bwd_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                   const int* __restrict__ argp, const int* __restrict__ argg,
                   float* __restrict__ dpred, float* __restrict__ dgt, int np, int ng,
                   float denom_p, float denom_g) {
  extern __shared__ float4 smem[];
  float4* terms = smem;                                      // [kMaxN]
  int* target = reinterpret_cast<int*>(terms + kMaxN);       // [kMaxN]
  int* cursor = target + kMaxN;                              // [kMaxN]
  int* start = cursor + kMaxN;                               // [kMaxN + 1]
  int* list = start + kMaxN + 1;                             // [kMaxN]
  int* wsum = list + kMaxN;                                  // [kWarps]

  const int b = blockIdx.x;
  const bool gt_side = blockIdx.y == 1;
  const int nq = gt_side ? ng : np;
  const int nr = gt_side ? np : ng;
  const float* query = (gt_side ? gt : pred) + (long long)b * nq * 3;
  const float* ref = (gt_side ? pred : gt) + (long long)b * nr * 3;
  const int* own = (gt_side ? argg : argp) + (long long)b * nq;
  const int* other = (gt_side ? argp : argg) + (long long)b * nr;
  float* out = (gt_side ? dgt : dpred) + (long long)b * nq * 3;
  const float dq = gt_side ? denom_g : denom_p;
  const float dr = gt_side ? denom_p : denom_g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // each target's own term, first, so that its gathers overlap the sort
  float own_term[kPerThread][3];
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    const int i = tid + h * kThreads;
    if (i < nq) {
      const float* q = query + 3 * i;
      const float* nn = ref + 3 * own[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) own_term[h][c] = term(q[c], nn[c], dq);
    }
  }

  // 1. counts
  for (int t = tid; t < nq; t += kThreads) cursor[t] = 0;
  __syncthreads();
  for (int j = tid; j < nr; j += kThreads) {
    const int t = other[j];
    target[j] = t;
    atomicAdd(&cursor[t], 1);
  }
  __syncthreads();

  // 2. exclusive scan: each thread two consecutive counts (nq <= 2 kThreads)
  const int t0 = 2 * tid;
  const int c0 = t0 < nq ? cursor[t0] : 0;
  const int c1 = t0 + 1 < nq ? cursor[t0 + 1] : 0;
  int incl = c0 + c1;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = wsum[lane];
    int x = w;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, x, s);
      if (lane >= s) x += v;
    }
    wsum[lane] = x - w;                      // exclusive over the warps
  }
  __syncthreads();
  const int excl = wsum[warp] + incl - (c0 + c1);
  if (t0 < nq) start[t0] = cursor[t0] = excl;
  if (t0 + 1 < nq) start[t0 + 1] = cursor[t0 + 1] = excl + c0;
  if (tid == 0) start[nq] = nr;
  __syncthreads();

  if (warp == 0) {
    // 3. stable placement, 32 sources a step in ascending order; the
    // targets and their peer masks of kAhead steps are found first, so
    // that only the cursor's read and write stay in the serial chain
    const unsigned below = (1u << lane) - 1;
    for (int j0 = 0; j0 < nr; j0 += 32 * kAhead) {
      int t[kAhead];
      unsigned peers[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int j = j0 + 32 * a + lane;
        t[a] = j < nr ? target[j] : -1 - lane;        // idle lanes match no one
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) peers[a] = __match_any_sync(0xffffffffu, t[a]);
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int j = j0 + 32 * a + lane;
        const int base = j < nr ? cursor[t[a]] : 0;
        __syncwarp();
        if (j < nr) {
          list[base + __popc(peers[a] & below)] = j;
          if (lane == 31 - __clz(peers[a])) cursor[t[a]] = base + __popc(peers[a]);
        }
        __syncwarp();
      }
    }
  } else {
    // each source's term, once, in source order
    for (int j = tid - 32; j < nr; j += kThreads - 32) {
      const float* q = query + 3 * target[j];
      terms[j] = make_float4(term(ref[3 * j], q[0], dr), term(ref[3 * j + 1], q[1], dr),
                             term(ref[3 * j + 2], q[2], dr), 0.f);
    }
  }
  __syncthreads();

  // 4. each target: its own term, minus its list's in ascending source order
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    const int i = tid + h * kThreads;
    if (i >= nq) break;
    float gx = own_term[h][0], gy = own_term[h][1], gz = own_term[h][2];
    const int end = start[i + 1];
#pragma unroll 4
    for (int k = start[i]; k < end; ++k) {
      const float4 s = terms[list[k]];
      gx = __fsub_rn(gx, s.x);
      gy = __fsub_rn(gy, s.y);
      gz = __fsub_rn(gz, s.z);
    }
    out[3 * i] = gx;
    out[3 * i + 1] = gy;
    out[3 * i + 2] = gz;
  }
}

}  // namespace

// pred [B, np, 3], gt [B, ng, 3] f32 contiguous; argp [B, np], argg
// [B, ng] int32 contiguous, each index within the other cloud; np, ng <=
// 2048. The caller checks all of it. Returns cudaGetLastError().
extern "C" int vst_chamfer_bwd(const void* pred, const void* gt, const void* argp,
                               const void* argg, void* dpred, void* dgt, int B,
                               int np, int ng, void* stream) {
  const cudaError_t err = vst::allow_smem(chamfer_bwd_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chamfer_bwd_kernel<<<dim3(B, 2), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(gt),
      static_cast<const int*>(argp), static_cast<const int*>(argg),
      static_cast<float*>(dpred), static_cast<float*>(dgt), np, ng,
      static_cast<float>((long long)B * np), static_cast<float>((long long)B * ng));
  return static_cast<int>(cudaGetLastError());
}
