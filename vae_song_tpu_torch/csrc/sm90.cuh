// Hopper (sm_90a) building blocks: mbarriers, TMA tile loads through
// tensor maps, wgmma with shared-memory descriptors, register
// reallocation, thread-block clusters and the sum of a tile over a
// cluster. Used by the bf16 attention forward (dense_attn_fwd.cu) and
// backward (dense_attn_bwd.cu) at head widths 64 to 2048, by the bf16
// attention kernels for wider heads (dense_attn_scores.cu), by the f32
// attention kernels (dense_attn_tf32.cu at 64 and 128,
// dense_attn_tf32_wide.cu from 192: TF32 wgmma) and by the fused FFN
// (ffn_fwd.cu, ffn_bwd.cu).
//
// Shared-memory tiles are 128-byte-swizzled panels of 64 bf16 columns
// (one swizzle atom wide), one 128-byte row per tile row, each panel
// 1024-byte aligned: the layout a TMA box of {64 columns, rows} with
// CU_TENSOR_MAP_SWIZZLE_128B writes, and the layout a wgmma descriptor
// with layout type 1 (128B swizzle) reads, in either major-ness:
//   K-major (the contraction runs along the 64 columns): SBO = 1024 B
//     between 8-row groups, LBO unused (1); the 16-deep k-step j of a
//     panel starts 32 j bytes in.
//   MN-major (the contraction runs along the rows, the 64 columns are
//     the operand's M or N): SBO = 1024 B between 8-row groups of the
//     contraction, LBO = the panel stride between 64-column atoms; the
//     k-step j starts 16 rows (2048 bytes) in.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace vst {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to the other threads and to the
// async proxy (TMA); the block then syncs once.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` of TMA traffic before the phase
// completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait of more
// than 2^32 clock cycles (about 2 s; a real one takes microseconds) is a
// deadlock: trap, so that the launch fails instead of hanging the card.
// kCluster: with acquire at cluster scope, so that what other CTAs of the
// cluster stored into this CTA's shared memory before completing the
// phase is seen after it.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    if constexpr (kCluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// A ring of `n` stages: full barriers (one arrival, the producer's
// expect_tx) and empty barriers (one arrival from each of `consumers`
// warps), 8 bytes apart.
__device__ __forceinline__ void ring_init(uint32_t full, uint32_t empty, int n, int consumers) {
  for (int s = 0; s < n; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(empty + 8 * s, consumers);
  }
}

// The producer's wait for ring item `it`'s stage to be free (at once for
// the first `stages` items).
__device__ __forceinline__ void ring_wait_free(uint32_t empty, int it, int stages) {
  mbar_wait(empty + 8 * (it % stages), ((it / stages) & 1) ^ 1);
}

// One consumer warp's release of a ring stage: lane 0's arrival,
// predicated rather than branched (between a warpgroup's wgmma issues a
// divergent path makes ptxas serialise them, advisory C7520).
__device__ __forceinline__ void release_stage(uint32_t empty, int lane) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(empty),
      "r"(lane)
      : "memory");
}

// The position of the next item in a ring whose stage count is known only
// at run time: its stage, and the parity of that stage's current phase.
// A producer and its consumers walk the same sequence of items, each with
// a cursor of its own (a consumer may keep one for its waits and one for
// its releases).
struct RingCursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One consumer warpgroup's side of such a ring: `stages` stages of
// `stage_bytes` at `slots`, their full and empty barriers 8 bytes apart
// from full0 and empty0 (the empty ones counting one arrival a warp).
// next() waits for the next item and returns its stage's address;
// wait(n) waits for the next n <= stages items and returns the first one's
// stage, at(first, i) the address of the i-th from there (one register for
// a run of items, where an array of addresses costs one each);
// release(n) gives back the stages of the oldest n items not yet released.
struct RingConsumer {
  uint32_t slots, stage_bytes, full0, empty0;
  int stages, lane;
  RingCursor pop, rel;
  __device__ __forceinline__ uint32_t next() {
    mbar_wait(full0 + 8 * pop.stage, pop.phase);
    const uint32_t at = slots + pop.stage * stage_bytes;
    pop.advance(stages);
    return at;
  }
  __device__ __forceinline__ int wait(int n) {
    const int first = pop.stage;
    for (int i = 0; i < n; ++i) {
      mbar_wait(full0 + 8 * pop.stage, pop.phase);
      pop.advance(stages);
    }
    return first;
  }
  __device__ __forceinline__ uint32_t at(int first, int i) const {
    const int s = first + i;
    return slots + (s >= stages ? s - stages : s) * stage_bytes;
  }
  __device__ __forceinline__ void release(int n) {
    for (int i = 0; i < n; ++i) {
      release_stage(empty0 + 8 * rel.stage, lane);
      rel.advance(stages);
    }
  }
};

// ---- thread-block clusters --------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of the cluster that has not exited meets here: the
// shared-memory writes (and barrier initialisations) before it are seen
// by every CTA of the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address in CTA `rank` of the cluster of this CTA's shared-memory
// address `addr` (both shared::cluster addresses).
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another CTA's shared memory at cluster address `addr`,
// completing 16 bytes of transactions on its mbarrier `bar` (a cluster
// address).
__device__ __forceinline__ void st_async_v4(uint32_t addr, const float (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void ld_shared_v4(uint32_t addr, float (&v)[4]) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr)
               : "memory");
}

// ---- TMA --------------------------------------------------------------------

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`; completes `bytes` on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-D tensor map at coordinates (c0, c1), innermost first.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of contiguous
// global memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One box of a 2-D tensor map at coordinates (c0, c1) from shared memory
// at `src` to global memory, in the calling thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Close the calling thread's bulk group and wait until its stores have read
// their shared memory (which may then be reused or freed).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- named barriers ---------------------------------------------------------

// Wait at barrier `id` until `threads` threads (a multiple of 32) have
// arrived or waited there; arrive without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- the split of a head over a cluster -------------------------------------

// The head's P = D / 64 panels (9 to 32) split over a cluster of C CTAs,
// as the attention forward and backward split it: 3 up to P = 12, 4 up to
// 16, 8 above (the sizes whose cluster sums fit shared memory beside the
// rings); CTA r owns panels [first(r), first(r + 1)), first(r) = r P / C,
// 2 to 4 of them.
__host__ __device__ constexpr int cluster_ctas(int P) { return P <= 12 ? 3 : P <= 16 ? 4 : 8; }
__host__ __device__ constexpr int cluster_first(int P, int r) { return r * P / cluster_ctas(P); }

// ---- the sum of a 64 x 64 f32 tile over a cluster -----------------------------
//
// The same warpgroup of each of a cluster's R CTAs (R = 3, 4 or 8) holds a
// tile of partial sums in the accumulator layout (32 words a thread, in
// eight blocks x[j] of 4); afterwards every thread of every CTA holds the
// total, ((x_0 + x_1) + x_2) + ... + x_{R-1}, added in f32 in rank order,
// the same bits everywhere. A reduce-scatter, then an all-gather: block j
// of every thread belongs to rank j % R, which receives it from the other
// ranks (into its `red` buffer), adds the R values in rank order and sends
// the sum to every other rank (into their `gat` buffers). Each buffer has
// a slot for each of the R - 1 other ranks, Mb = ceil(8 / R) blocks of
// 128 threads x 16 bytes: block (slot, mb) of thread tid at ((slot Mb +
// mb) 128 + tid) 16 bytes, so a warp's accesses are 512 consecutive bytes
// and what one rank sends another in one step is contiguous. Each buffer
// has an mbarrier that counts the bytes arriving (each thread stores its
// blocks into the other CTAs with st.async, which completes them there),
// armed each phase by lane 0 of each of its warpgroup's warps with the
// bytes its warp's threads receive. One buffer of each suffices: a rank
// writes the next tile's blocks into another's buffer only after that
// rank has sent it everything it read from it for this tile.

__host__ __device__ constexpr int csum_blocks(int R) { return (8 + R - 1) / R; }

// The bytes of one of a warpgroup's two buffers (gat follows red), and of
// both.
__host__ __device__ constexpr uint32_t csum_gat(int R) {
  return (R - 1) * csum_blocks(R) * 128 * 16;
}
__host__ __device__ constexpr uint32_t csum_bytes(int R) { return 2 * csum_gat(R); }

template <int R>
struct ClusterSum {
  uint32_t red, gat;            // the buffers (this CTA's shared memory)
  uint32_t red_bar, gat_bar;    // their mbarriers (4 arrivals a phase)
  int me;                       // this CTA's rank
  uint32_t phase;

  // The bytes one warp's threads receive in one phase: in red, R - 1
  // values of each block this rank owns; in gat, each block it does not.
  __device__ __forceinline__ int owned() const { return (8 - me + R - 1) / R; }
  __device__ __forceinline__ uint32_t red_tx() const { return 32u * 16u * (R - 1) * owned(); }
  __device__ __forceinline__ uint32_t gat_tx() const { return 32u * 16u * (8 - owned()); }
  __device__ __forceinline__ static bool arms(int tid) { return (tid & 31) == 0; }
  // The arming of both barriers for the first phase.
  __device__ __forceinline__ void arm(int tid) const {
    if (arms(tid)) {
      mbar_arrive_expect_tx(red_bar, red_tx());
      mbar_arrive_expect_tx(gat_bar, gat_tx());
    }
  }

  __device__ __forceinline__ void operator()(float (&x)[8][4], int tid) {
    constexpr int Mb = csum_blocks(R);
    auto at = [&](uint32_t buf, int slot, int mb) {
      return buf + ((slot * Mb + mb) * 128 + tid) * 16;
    };
    auto slot_of = [](int r, int in) { return r - (r > in ? 1 : 0); };   // r's slot at rank `in`
    // 1. every block to its owner, into the slot of this rank (j % R and
    // j / R are constants once the loops unroll)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = j % R;
      if (o == me) continue;
      st_async_v4(map_rank(at(red, slot_of(me, o), j / R), o), x[j], map_rank(red_bar, o));
    }
    // 2. this rank's blocks: the R values in rank order, sent to the others
    mbar_wait<true>(red_bar, phase);
    if (arms(tid)) mbar_arrive_expect_tx(red_bar, red_tx());   // the next phase
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j % R != me) continue;
      float s[4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v[4];
        if (r == me) {
          v[0] = x[j][0], v[1] = x[j][1], v[2] = x[j][2], v[3] = x[j][3];
        } else {
          ld_shared_v4(at(red, slot_of(r, me), j / R), v);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = r == 0 ? v[e] : s[e] + v[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = s[e];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r != me)
          st_async_v4(map_rank(at(gat, slot_of(me, r), j / R), r), s, map_rank(gat_bar, r));
    }
    // 3. the other blocks, from their owners
    mbar_wait<true>(gat_bar, phase);
    if (arms(tid)) mbar_arrive_expect_tx(gat_bar, gat_tx());   // the next phase
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j % R != me) ld_shared_v4(at(gat, slot_of(j % R, me), j / R), x[j]);
    phase ^= 1;
  }
};

// In place of a ClusterSum where one CTA holds the whole head.
struct NoClusterSum {
  __device__ __forceinline__ void operator()(float (&)[8][4], int) {}
};

// ---- register reallocation between warpgroups ------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ------------------------------------------------------------------

constexpr uint32_t kPanelRowBytes = 128;        // 64 bf16 columns
constexpr uint32_t kSwizzleGroupBytes = 1024;   // 8 rows of a panel

// Byte offset of element (r, c) in a swizzled panel (the TMA 128-byte
// swizzle: the 16-byte chunk c / 8 of row r lies at chunk (c / 8) ^ (r % 8)).
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * kPanelRowBytes + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(kSwizzleGroupBytes >> 4) << 32) | (1ull << 62);
}

// K-major operand: the 16-deep k-step j (0..3) of the panel at `panel`.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t panel, int j) {
  return wgmma_desc(panel + 32 * j, 16);
}

// MN-major operand: k-step j (16 rows) of the panel at `panel`, whose
// next 64-column atom lies `atom_stride` bytes on.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t panel, int j, uint32_t atom_stride) {
  return wgmma_desc(panel + 16 * kPanelRowBytes * j, atom_stride);
}

// K-major operand of one 16-deep k-step in a tile of 16 bf16 columns (32
// bytes a row) with the 32-byte swizzle, 8-row groups 256 bytes apart:
// the layout a TMA box of {16 columns, rows} with
// CU_TENSOR_MAP_SWIZZLE_32B writes (the attention backward's fold arms,
// dense_attn_bwd.cu).
__device__ __forceinline__ uint64_t desc_kmajor_sw32(uint32_t tile) {
  return static_cast<uint64_t>((tile & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void zero_acc(float (&c)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Keep the compiler from moving accumulator registers across an
// asynchronous wgmma's issue and its wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&c)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(c[i][j])::"memory");
}

#define VST_C4(c, j) "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
// the 8 rows o .. o + 7 of c (32 registers)
#define VST_ACC32(c, o)                                                                    \
  VST_C4(c, o), VST_C4(c, o + 1), VST_C4(c, o + 2), VST_C4(c, o + 3), VST_C4(c, o + 4),  \
      VST_C4(c, o + 5), VST_C4(c, o + 6), VST_C4(c, o + 7)

#define VST_D32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// The wgmma wrappers below take each operand's major-ness as a template
// flag, wgmma's imm-trans: 0 K-major (the contraction runs along the 64
// columns of the panel), 1 MN-major (it runs along the rows). An A operand
// in registers is always mma.sync's A fragment layout per warp.

// c (64 x 64 f32, the accumulator layout of mma.sync's C per warp: c[j]
// holds n-tile j) (+)= A (64 x 16 in shared memory) B (16 x 64 in shared
// memory). `accumulate` 0 overwrites c.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64_t(float (&c)[8][4], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VST_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : VST_ACC32(c, 0)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// c (64 x 64 f32: rows O .. O + 7 of c, each 8 columns in mma.sync's C
// layout per warp) += A (64 x 16 bf16 in registers) B (16 x 64 in shared
// memory). O > 0 puts a 64-column panel of a wider accumulator in c.
template <int TB, int O = 0, int R>
__device__ __forceinline__ void wgmma_rs_n64_t(float (&c)[R][4], const uint32_t (&a)[4],
                                               uint64_t db) {
  static_assert(O % 8 == 0 && O + 8 <= R, "a 64-column panel of c");
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VST_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : VST_ACC32(c, O)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
}

#define VST_ACC64(c)                                                                        \
  VST_C4(c, 0), VST_C4(c, 1), VST_C4(c, 2), VST_C4(c, 3), VST_C4(c, 4), VST_C4(c, 5),       \
      VST_C4(c, 6), VST_C4(c, 7), VST_C4(c, 8), VST_C4(c, 9), VST_C4(c, 10), VST_C4(c, 11), \
      VST_C4(c, 12), VST_C4(c, 13), VST_C4(c, 14), VST_C4(c, 15)

#define VST_D64                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// c (64 x 128 f32, c[j] holds columns 8 j .. 8 j + 7 in mma.sync's C
// layout per warp) (+)= A (64 x 16 in shared memory) B (16 x 128 in shared
// memory; MN-major: two 64-column atoms, LBO apart). `accumulate` 0
// overwrites c.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128_t(float (&c)[16][4], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VST_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : VST_ACC64(c)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// c (64 x 128 f32) += A (64 x 16 bf16 in registers) B (16 x 128 in
// shared memory; MN-major: two 64-column atoms, LBO apart).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128_t(float (&c)[16][4], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VST_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : VST_ACC64(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
}

// TF32 (the f32 attention kernels, dense_attn_tf32.cu and
// dense_attn_tf32_wide.cu). TF32 wgmma has no transpose: B is read
// K-major, a 128-byte-swizzled panel of 32 f32 columns (one swizzle atom,
// the layout a TMA box of {32 columns, rows} with CU_TENSOR_MAP_SWIZZLE_128B
// writes), whose 8-deep k-step j (0..3) desc_kmajor(panel, j) gives; A
// comes from registers in mma.sync's m16n8k8 TF32 A layout per warp. The
// tensor cores read the top 19 bits of each 32-bit operand.
//
// c (64 x 32 f32) (+)= A (64 x 8 in registers) B (8 x 32 in shared
// memory); `accumulate` 0 overwrites c (the first step of a fresh sum).
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&c)[4][4], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : VST_C4(c, 0), VST_C4(c, 1), VST_C4(c, 2), VST_C4(c, 3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// c (64 x 64 f32) (+)= A (64 x 8 in registers) B (8 x 64 in shared
// memory).
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&c)[8][4], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " VST_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : VST_ACC32(c, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// c (64 x 128 f32) (+)= A (64 x 8 in registers) B (8 x 128 in shared
// memory).
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&c)[16][4], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " VST_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : VST_ACC64(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef VST_D64
#undef VST_ACC64
#undef VST_C4
#undef VST_D32
#undef VST_ACC32

// ---- tensor maps (host) -------------------------------------------------------

using TensorMapEncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                       const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                       const cuuint32_t*, CUtensorMapInterleave,
                                       CUtensorMapSwizzle, CUtensorMapL2promotion,
                                       CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded, so the kernel library needs no -lcuda at link time.
inline TensorMapEncodeFn tensor_map_encoder() {
  static const TensorMapEncodeFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<TensorMapEncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Tensor map over a [B, N, H, D] view of `type` elements of `bytes` bytes
// with element strides (sb, sn, sh, 1): dims (D, H, N, B) innermost first,
// boxes of `cols` columns x `rows` rows of one head, 128-byte swizzle; rows
// past N read as zeros.
inline bool bhnd_tensor_map_of(CUtensorMap* map, CUtensorMapDataType type, int bytes,
                               const void* base, int B, int N, int H, int D, long long sb,
                               long long sn, long long sh, int cols, int rows) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * bytes,
                                 static_cast<cuuint64_t>(sn) * bytes,
                                 static_cast<cuuint64_t>(sb) * bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16, boxes of 64 columns x 64 rows (one swizzle atom wide).
inline bool bhnd_tensor_map(CUtensorMap* map, const void* base, int B, int N, int H, int D,
                            long long sb, long long sn, long long sh) {
  return bhnd_tensor_map_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, B, N, H, D, sb, sn,
                            sh, 64, 64);
}

// f32, boxes of 32 columns (one swizzle atom wide) x `rows` rows.
inline bool bhnd_tensor_map_f32(CUtensorMap* map, const void* base, int B, int N, int H, int D,
                                long long sb, long long sn, long long sh, int rows) {
  return bhnd_tensor_map_of(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, B, N, H, D, sb, sn,
                            sh, 32, rows);
}

// Tensor map over a contiguous row-major bf16 [rows, cols] matrix: dims
// (cols, rows) innermost first, boxes of 64 columns x 64 rows, 128-byte
// swizzle (the panel layout above).
inline bool matrix_tensor_map(CUtensorMap* map, const void* base, long long rows, int cols) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map over a contiguous f32 [heads, rows, cols] array: dims (cols,
// rows, heads) innermost first, boxes of 32 columns x `box_rows` rows of
// one head, 128-byte swizzle; rows past `rows` read as zeros.
inline bool heads_tensor_map_f32(CUtensorMap* map, const void* base, long long heads, int rows,
                                 int cols, int box_rows) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- cluster launches (host) ----------------------------------------------------

// A launch configuration in clusters of `ctas` blocks along x (grid.x a
// multiple of it).
struct ClusterConfig {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  ClusterConfig(dim3 grid, int threads, size_t smem, int ctas, cudaStream_t st) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterConfig(const ClusterConfig&) = delete;   // cfg points into attr
};

// Launch `kernel` on `grid` in clusters of `ctas` blocks; returns the
// launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                           int ctas, cudaStream_t st, Args&&... args) {
  const ClusterConfig c(grid, threads, smem, ctas, st);
  const cudaError_t err = cudaLaunchKernelEx(&c.cfg, kernel, static_cast<Args&&>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of `kernel` in clusters of `ctas`
// blocks of `threads` threads and `smem` bytes of shared memory (already
// granted) into *fit.
template <typename... Params>
cudaError_t cluster_fit(void (*kernel)(Params...), int ctas, int threads, size_t smem, int* fit) {
  const ClusterConfig c(dim3(ctas * 64, 1, 1), threads, smem, ctas, nullptr);
  return cudaOccupancyMaxActiveClusters(fit, kernel, &c.cfg);
}

}  // namespace vst
