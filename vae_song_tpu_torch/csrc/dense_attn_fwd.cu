// Dense attention forward for Hopper (sm_90a), [B, N, H, D] layout read
// through strides, head width D a compile-time 64, 128, 192 or 256.
//
// Replaces: vae_song_tpu/ops/denseattn.py:_fwd_kernel_packed (K1, called
// through _call_fwd_packed: 64-wide heads in pairs) and
// vae_song_tpu/ops/denseattn.py:_fwd_kernel (K3f, called through _call_fwd:
// the [B*H, N, D] layout, any D % 64 == 0). The two compute the same
// function with the same roundings, so one kernel serves both; the
// wrappers count the two routes apart. Same function and roundings:
//   qc = round_to_input_dtype(q * scale * log2e)
//   S2 = qc k^T (f32 accumulation), m = exact row max,
//   P  = exp2(S2 - m) (bf16 inputs: argument and result rounded to bf16),
//   O  = (P v) / rowsum(P), rowsum taken over the rounded P in f32,
//   LSE2 = m + log2(rowsum(P))  (the base-2 residual the backward reads).
//
// What bounds it here: the TPU kernel keeps a whole [N, N] row block of
// scores in VMEM (16.8 MB at N = 2048); one SM has 227 KB of shared
// memory, so the scores are never held whole. Each block owns 64 query
// rows of one (batch, head) and walks the keys in 64-row tiles with an
// online softmax, so only the [B, N, H*D] operands and O/LSE touch device
// memory. At the SetVAE shapes (B = 64, N = 2048, H = 4) one call is
// 2.7e11 flop against 0.27 GB of q/k/v/O traffic: the tensor cores are the
// bound, not memory. The bf16 path issues mma.sync m16n8k16 (bf16 in, f32
// accumulate) from registers: S stays in the accumulator layout, which is
// also the A-operand layout of the P V product, so P never goes through
// shared memory. Loads are synchronous and single-buffered; wgmma, TMA
// and a load pipeline are left to the PRs that make it fast.
//
// The row max is the exact running max of the scores seen so far (never
// a norm bound: a bound underflowed whole rows to 0/0 under training
// transients, denseattn.py:88-96). exp2(s - m) has a 1.0 entry per tile
// at the max, so the row sum is >= 1 and log2 is safe. Because the
// softmax is online, P is rounded to bf16 against the running max rather
// than the final row max: the values differ from the TPU kernel within
// bf16 rounding, and the f32 path differs only in summation order.
//
// Wider heads. The tiles grow with D (qs + ks + vt is 104 KB at D = 256),
// so shared memory is dynamic, granted per instantiation above the 48 KB
// default. The accumulator of O is D / 2 registers a thread; above
// D = 128 the Q fragments are reloaded from shared memory for each
// 16-wide chunk instead of being held (64 registers at D = 256).
//
// f32 inputs (mixed_precision: false) take a plain FMA kernel: one thread
// per query row, its prescaled q row in shared memory, keys staged through
// shared memory, no TF32. A block computes 64 columns of O; at D > 64 the
// grid carries D / 64 column chunks, each recomputing the scores.

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

constexpr int kBlockQ = 64;       // query rows per block (4 warps x 16 rows)
constexpr int kBlockK = 64;       // keys per shared-memory tile
constexpr int kThreads = 128;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows padded by 8 bf16 (16 bytes): the 8 row groups of a fragment load
// land on distinct banks.
template <int D>
constexpr size_t fwd_bf16_smem() {
  return ((kBlockQ + kBlockK) * (D + 8) + D * (kBlockK + 8)) * sizeof(__nv_bfloat16);
}

// Grid (N / 64, H, B), 128 threads. Warp w owns query rows 16w..16w+15 of
// the block's tile; in the m16n8k16 fragment layouts lane = 4 g + t holds
// rows g and g + 8, columns 2t, 2t + 1 (+ 8).
template <int D>
__global__ void __launch_bounds__(kThreads)
dense_attn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int N,
                           long long sb, long long sn, long long sh,
                           long long ob, long long on, long long oh,
                           float qscale) {
  constexpr int LD = D + 8;
  constexpr int KC = D / 16;           // 16-wide chunks of the head
  constexpr bool kQInRegs = D <= 128;  // else reload Q fragments per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  auto qs = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem);
  auto ks = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem + kBlockQ * LD * 2);
  auto vt = reinterpret_cast<__nv_bfloat16 (*)[kBlockK + 8]>(   // V^T tile
      smem + (kBlockQ + kBlockK) * LD * 2);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = (long long)b * sb + (long long)h * sh;

  // Stage the query tile, prescaled by scale * log2e and rounded back to
  // bf16 (denseattn.py:131, :414).
  for (int i = tid; i < kBlockQ * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(q + head + (long long)(q0 + r) * sn + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
    *reinterpret_cast<uint4*>(&qs[r][c]) = raw;
  }
  __syncthreads();

  uint32_t qa[kQInRegs ? KC : 1][4];
  if constexpr (kQInRegs) load_a_rows<LD, KC>(qs, warp * 16, g, t, qa);

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const long long off = head + (long long)(k0 + r) * sn + c;
      *reinterpret_cast<uint4*>(&ks[r][c]) = *reinterpret_cast<const uint4*>(k + off);
      uint4 raw = *reinterpret_cast<const uint4*>(v + off);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[c + j][r] = e[j];
    }
    __syncthreads();

    // S2 = qc k^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
        a[0] = qa[kk][0]; a[1] = qa[kk][1]; a[2] = qa[kk][2]; a[3] = qa[kk][3];
      } else {
        load_a_chunk<LD>(qs, warp * 16, kk, g, t, a);
      }
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(s[nt], a, ld_u32(kr), ld_u32(kr + 8));
      }
    }

    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      t0 = fmaxf(t0, fmaxf(s[nt][0], s[nt][1]));
      t1 = fmaxf(t1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float n0 = fmaxf(m0, quad_max(t0));
    const float n1 = fmaxf(m1, quad_max(t1));
    const float a0 = exp2f(m0 - n0);  // 0 on the first tile (m = -inf)
    const float a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = exp2_bf16(s[nt][0] - n0);
      s[nt][1] = exp2_bf16(s[nt][1] - n0);
      s[nt][2] = exp2_bf16(s[nt][2] - n1);
      s[nt][3] = exp2_bf16(s[nt][3] - n1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }

    // O += P v: the accumulator layout of two S n-tiles is the A layout
    // of one 16-key chunk of P.
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(s, kc, pa);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = &vt[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[dt], pa, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* o0 = o + (long long)b * ob + (long long)r0 * on + (long long)h * oh;
  __nv_bfloat16* o1 = o + (long long)b * ob + (long long)r1 * on + (long long)h * oh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(o0 + dt * 8 + 2 * t) = pack_bf16(acc[dt][0] / l0, acc[dt][1] / l0);
    *reinterpret_cast<uint32_t*>(o1 + dt * 8 + 2 * t) = pack_bf16(acc[dt][2] / l1, acc[dt][3] / l1);
  }
  if (t == 0) {
    float* lrow = lse + ((long long)b * H + h) * N;
    lrow[r0] = m0 + log2f(l0);
    lrow[r1] = m1 + log2f(l1);
  }
}

constexpr int kF32Rows = 64;   // query rows per block, one per thread
constexpr int kF32Keys = 32;   // keys per shared-memory tile
constexpr int kF32Cols = 64;   // columns of O per block

template <int D>
constexpr size_t fwd_f32_smem() {
  return (kF32Rows * (D + 1) + kF32Keys * D + kF32Keys * kF32Cols) * sizeof(float);
}

// Grid (N / 64 * D / 64, H, B), 64 threads; thread i owns query row
// q0 + i and columns c0 .. c0 + 63 of O (block x = 64-row tile * D / 64 +
// column chunk). The q rows sit in shared memory with a stride of D + 1
// floats, so the threads' row reads fall on distinct banks.
template <int D>
__global__ void __launch_bounds__(kF32Rows)
dense_attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int N,
                          long long sb, long long sn, long long sh,
                          long long ob, long long on, long long oh,
                          float qscale) {
  constexpr int QLD = D + 1;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                              // [64][D + 1]
  float* ks = qs + kF32Rows * QLD;              // [32][D]
  float* vs = ks + kF32Keys * D;                // [32][64], this chunk's columns

  constexpr int kChunks = D / kF32Cols;
  const int chunk = blockIdx.x % kChunks, c0 = chunk * kF32Cols;
  const int q0 = (blockIdx.x / kChunks) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const long long head = (long long)b * sb + (long long)h * sh;

  for (int i = tid; i < kF32Rows * D; i += kF32Rows) {
    const int r = i / D, c = i % D;
    qs[r * QLD + c] = q[head + (long long)(q0 + r) * sn + c] * qscale;
  }
  const float* qr = qs + tid * QLD;
  float acc[kF32Cols];
#pragma unroll
  for (int d = 0; d < kF32Cols; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kF32Keys) {
    __syncthreads();
    for (int i = tid; i < kF32Keys * D / 4; i += kF32Rows) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(&ks[r * D + c]) =
          *reinterpret_cast<const float4*>(k + head + (long long)(k0 + r) * sn + c);
    }
    for (int i = tid; i < kF32Keys * kF32Cols / 4; i += kF32Rows) {
      const int r = i / (kF32Cols / 4), c = (i % (kF32Cols / 4)) * 4;
      *reinterpret_cast<float4*>(&vs[r * kF32Cols + c]) =
          *reinterpret_cast<const float4*>(v + head + (long long)(k0 + r) * sn + c0 + c);
    }
    __syncthreads();

    float s[kF32Keys];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float x = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], ks[j * D + d], x);
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    const float mn = fmaxf(m, tmax);
    const float alpha = exp2f(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kF32Cols; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const float p = exp2f(s[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < kF32Cols; ++d) acc[d] = fmaf(p, vs[j * kF32Cols + d], acc[d]);
    }
  }

  float* op = o + (long long)b * ob + (long long)row * on + (long long)h * oh + c0;
#pragma unroll
  for (int d = 0; d < kF32Cols; d += 4)
    *reinterpret_cast<float4*>(op + d) =
        make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
  if (chunk == 0) lse[((long long)b * H + h) * N + row] = m + log2f(l);
}

template <int D>
cudaError_t launch_fwd(int is_bf16, const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int N, long long sb, long long sn,
                       long long sh, long long ob, long long on, long long oh,
                       float qscale, cudaStream_t st) {
  if (is_bf16) {
    constexpr size_t smem = fwd_bf16_smem<D>();
    cudaError_t err = vst::allow_smem(dense_attn_fwd_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dense_attn_fwd_bf16_kernel<D><<<dim3(N / kBlockQ, H, B), kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), H, N, sb, sn, sh, ob, on, oh, qscale);
  } else {
    constexpr size_t smem = fwd_f32_smem<D>();
    cudaError_t err = vst::allow_smem(dense_attn_fwd_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dense_attn_fwd_f32_kernel<D><<<dim3(N / kF32Rows * (D / kF32Cols), H, B), kF32Rows, smem,
                                   st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), H, N, sb, sn, sh, ob, on, oh, qscale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, N, H, D] with element strides (sb, sn, sh, 1), 16-byte
// aligned rows; o: [B, N, H, D] with strides (ob, on, oh, 1); lse:
// [B, H, N] f32, contiguous. N % 64 == 0, D one of 64, 128, 192, 256
// (cudaErrorInvalidValue otherwise). The caller checks all of it.
// Returns cudaGetLastError() after the launch.
extern "C" int vst_dense_attn_fwd(int is_bf16, const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int H, int N, int D, long long sb, long long sn,
                                  long long sh, long long ob, long long on,
                                  long long oh, float qscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch_fwd<64>(is_bf16, q, k, v, o, lse, B, H, N, sb, sn, sh, ob, on, oh, qscale, st);
      break;
    case 128:
      err = launch_fwd<128>(is_bf16, q, k, v, o, lse, B, H, N, sb, sn, sh, ob, on, oh, qscale, st);
      break;
    case 192:
      err = launch_fwd<192>(is_bf16, q, k, v, o, lse, B, H, N, sb, sn, sh, ob, on, oh, qscale, st);
      break;
    case 256:
      err = launch_fwd<256>(is_bf16, q, k, v, o, lse, B, H, N, sb, sn, sh, ob, on, oh, qscale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* vst_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
