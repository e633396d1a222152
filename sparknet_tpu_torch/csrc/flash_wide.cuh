// Flash attention past head_dim 256: the forward, dQ and dK/dV kernels for
// a D that is a multiple of kSliceW = 128 columns (the wrappers zero-pad D
// to one, ops/cuda_attention.py built_head_dim), f32 and bf16 storage.
//
// The D <= 256 kernels hold whole (rows, D) tiles, and an accumulator of
// all D output columns, on chip; past 256 neither fits in one CTA.
//
// All three are thread-block-cluster kernels. In the forward and dQ
// (flash_wide_fwd_kernel, flash_wide_dq_kernel) a cluster of G CTAs
// ("ranks") owns one 64-row query tile of one (b, h) and streams the key
// tiles; in dK/dV (flash_wide_dkv_kernel) it owns one 64-row key tile and
// streams the query tiles. Rank r owns the 128 columns [128 r, 128 r +
// 128) of D: its slices of Q, K, V, dO (and dQ; dK, dV). Each score tile
// is built once, and each of its rows is finished by one rank, its owner
// (rank r owns rows [64 r / G, 64 (r + 1) / G) of the resident tile):
//  - every rank computes the partial score tile of its columns for a
//    streamed tile of KT rows on the tensor cores (S_r = Q_r K_r^T, and
//    dP_r = dO_r V_r^T in dQ; S^T_r = K_r Q_r^T and dP^T_r = V_r dO_r^T
//    in dK/dV), and stores each row of it into the owner's shared memory
//    through distributed shared memory (DSMEM: a reduce-scatter);
//  - the owner adds the G partials of its rows in rank order 0 .. G-1
//    in f32 and finishes them: the forward's online softmax (m, l,
//    alpha), dQ's P and dS from LSE and delta per row, dK/dV's P^T and
//    dS^T from LSE and delta per column (query); it stores the rows of P
//    (dS; P^T and dS^T), in the storage type, and alpha into every
//    rank's shared memory (an all-gather);
//  - each rank then multiplies them into its own slices on the tensor
//    cores: O_r += P V_r, dQ_r += dS K_r, dV_r += P^T dO_r and dK_r +=
//    dS^T Q_r. At the end the forward's owners store l for the
//    normalisation of O; owners write LSE and delta, and dQ's owners
//    first gather delta from per-rank partial row sums of dO_r O_r (dK/dV
//    reads dQ's delta).
// Every row is summed and finished once, in a fixed order: two launches
// on the same inputs give bitwise the same O, LSE, dQ, delta, dK and dV
// (no atomics). A rank receives one partial tile of 64 x KT f32 a
// streamed tile (two in dQ and dK/dV) and one tile of P (dS; two in
// dK/dV): not the G partial tiles that an all-gather of the partials
// moved, which bound the first design (PERF.md).
// The exchanges are st.async stores, which complete their bytes on an
// mbarrier in the receiving CTA: a receiver waits on its own mbarrier of
// that buffer and parity (two parities: tile j in buffer j % 2), and a
// sender never waits for its stores. No cluster barrier sits on that
// path (one with release semantics, flushing every remote store, took
// ~2 us a key tile: PERF.md). A relaxed cluster barrier only
// guards the reuse of a buffer: a rank arrives once it has read tile j's
// partials and P (dS), and waits for every rank's arrival of tile j - 1
// before it stores tile j + 1's partials (a tile of slack), which also
// orders its P (dS) stores of tile j + 1 after every read of tile j - 1.
// A full cluster barrier first makes sure every rank runs with its
// mbarriers set, and the forward's last one that l is in place.
// The cluster size G is set at launch from D (cudaLaunchKernelEx), so D
// stays a runtime argument and one instantiation a dtype serves every D.
// G is at most 8, the portable cluster size: that covers D <= 1024. Past
// it the output's slices split into `groups` clusters of equal size G
// (the grid's x axis; the wrappers pad D so that they are equal), and
// each cluster builds the scores again over all of D: rank r's partial
// then runs over the slices r, r + G, r + 2 G, ... in order (its own one
// resident, the others loaded on the spot, 64 columns at a time, into an
// extra tile), a recompute factor of `groups` = ceil(D / 1024) instead of
// the D / 64 of the CUDA-core kernels these replaced.
//
// Arithmetic, as the kernels up to D = 256 (flash_fwd.cu, flash_bwd.cu):
//  - bf16: mma.sync m16n8k16 (flash_mma.cuh) with f32 sums; the
//    forward's S is scaled after the products, in f32; P (forward), dS
//    (dQ), P^T and dS^T (dK/dV) are rounded to bf16 before the second
//    products, each output once.
//  - f32: split TF32 (3xTF32, flash_tf32.cuh): the forward scales Q (in
//    f32, in shared memory) before Q K^T, as the plain version does; no
//    tensor-core sum runs past kSumSteps k-steps (a slice's 128 columns
//    are two sums added in f32; P V one sum a key tile of 64, dS K of
//    32, P^T dO and dS^T Q one a query tile of 32);
//    built with SPARKNET_FLASH_TF32_ONE_PASS the lo terms drop out, as in
//    the other f32 kernels.
//  - The sum across ranks is IEEE f32, in rank order, from zero; within
//    a rank the slices in order. Masked scores are -1e30 (the backward's
//    P exactly 0), l is floored at 1e-30, the backward scales the
//    product (dQ and dK once, at the end).
// A CTA is 8 warps: warp w computes the partial of rows 16 (w % 4) ..
// + 16 and streamed rows (w / 4) KT / 2 .. + KT / 2 of the tile over all
// of its slice's 128 columns, and its outputs for the same rows and the
// columns 64 (w / 4) .. + 64 of its slice; an owner row is 8 threads,
// KT / 8 streamed rows each. KT is 64 in the forward and 32 in dQ and
// dK/dV (whose partials are two tiles). The streamed tiles come by
// 16-byte cp.async, the next tile in flight under the current one's
// other work: the forward one buffer each for K and V, dQ two for K
// (which both its products of a tile read), dK/dV two each for Q and dO
// (with their LSE and delta) in f32 and one in bf16 and past D = 1024,
// where the next tile loads after the products (WideDkvTiles). With two
// buffers each thread's copies arrive on the buffer's mbarrier and each
// thread waits there, not at a CTA barrier, so the warps that own no
// rows start the next tile's partials while the owners finish theirs.
// Row strides 136 (bf16; and the f32 forward's Q and K, read in 64-bit
// pairs: cols_dot_pairs) or 132 (f32), P of KT + 8: free of bank
// conflicts (flash_mma.cuh, flash_tf32.cuh). The single buffers fit two
// CTAs of the bf16 kernels on an SM (shared memory and 128 registers),
// whose exchanges overlap; the f32 kernels take more registers and run
// one CTA an SM (the f32 forward at 128 registers spilled and ran
// slower: PERF.md).
// Bound: operations. The forward does 4 S^2 D, dQ 6 S^2 D and dK/dV
// 8 S^2 D FLOPs (halved when causal). Registers, shared memory and
// co-resident clusters: sparknet_flash_forward_info /
// sparknet_flash_backward_info, printed by chip_smoke.py phase 6;
// measured times in PERF.md.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_tf32.cuh"
#include "flash_wgmma.cuh"

namespace sparknet_flash {

namespace cg = cooperative_groups;

constexpr int kSliceW = 128;       // columns of D a rank owns
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kWideThreads = 256;  // 8 warps (the note at the top)
constexpr int kTpr = 8;            // owner threads a row

// The cluster of a head_dim D: G ranks in each of `groups` clusters
// along the grid's x axis; false for a D the wrappers never pass (not a
// multiple of kSliceW, or slices that do not split into equal clusters
// of at most kMaxCluster).
inline bool wide_cluster(int D, int* gc, int* groups) {
  if (D <= 0 || D % kSliceW != 0) return false;
  const int slices = D / kSliceW;
  *groups = (slices + kMaxCluster - 1) / kMaxCluster;
  *gc = slices / *groups;
  return slices % *groups == 0;
}

// Rank r of G owns rows [own_lo(r), own_lo(r + 1)) of a 64-row tile: at
// most rows_max(G) of them; owner_of(row) inverts own_lo
__host__ __device__ __forceinline__ int own_lo(int r, int gc) {
  return r * 64 / gc;
}
__host__ __device__ __forceinline__ int rows_max(int gc) {
  return (64 + gc - 1) / gc;
}
__device__ __forceinline__ int owner_of(int row, int gc) {
  return (row * gc + gc - 1) >> 6;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// an arrival that orders nothing: the lagged barrier that only says a
// rank's reads of a buffer are done (their values already consumed)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// a barrier of every thread of the cluster that a warp need not reach
// together (the f32 head_dim-256 kernels of flash_fwd.cu and
// flash_bwd.cu, whose producer warps have one thread loading while the
// others wait)
__device__ __forceinline__ void cluster_sync_any() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address of this CTA's shared address `a` in rank
// `rank`'s shared memory
__device__ __forceinline__ uint32_t mapa_u32(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// the shared::cluster address of `p` (this CTA's shared memory) in rank
// `rank`'s shared memory
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  return mapa_u32(smem_addr(p), rank);
}

// Asynchronous stores into a rank's shared memory that complete their
// bytes on that rank's mbarrier `bar` (st.async): the sender never waits
template <int N>
__device__ __forceinline__ void st_async(uint32_t addr, const uint32_t (&w)[N],
                                         uint32_t bar) {
  static_assert(N == 1 || N == 2 || N == 4, "1, 2 or 4 words");
  if constexpr (N == 1)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
        "%1, [%2];\n" ::"r"(addr),
        "r"(w[0]), "r"(bar)
        : "memory");
  else if constexpr (N == 2)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
        "{%1, %2}, [%3];\n" ::"r"(addr),
        "r"(w[0]), "r"(w[1]), "r"(bar)
        : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
        "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
        "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(bar)
        : "memory");
}

// an arrival on the local mbarrier `bar` once this thread's cp.async
// copies so far have landed (the barrier counts every thread's arrival:
// noinc), so that a warp can wait for a tile without a CTA barrier
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// wait until the local mbarrier's phase `parity` has completed, with
// acquire at cluster scope (its bytes came from other ranks)
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a (seq, ld)
// matrix into a tile of row stride LD elements by 16-byte cp.async
// copies; rows at or past seq are zero-filled. Every thread of the CTA
// takes part; the caller commits.
template <int ROWS, int COLS, int LD, typename T>
__device__ __forceinline__ void cp_async_cols(T* dst, const T* src, int ld,
                                              int row0, int col0, int seq) {
  constexpr int kPer = 16 / sizeof(T);              // elements a copy
  constexpr int kChunks = COLS / kPer;              // copies a row
  static_assert(ROWS * kChunks % kWideThreads == 0, "whole rounds");
#pragma unroll
  for (int i0 = 0; i0 < ROWS * kChunks; i0 += kWideThreads) {
    const int i = i0 + threadIdx.x;
    const int r = i / kChunks, c = (i % kChunks) * kPer, g = row0 + r;
    const bool in = g < seq;
    cp_async16(dst + r * LD + c,
               src + (in ? static_cast<long long>(g) * ld + col0 + c : 0),
               in ? 16 : 0);
  }
}

// The ROWS x COLS f32 tile times `scale`, in place (the forward's Q)
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void scale_tile(float* tile, float scale) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += kWideThreads)
    tile[(i / COLS) * LD + i % COLS] *= scale;
}

// A B^T over COLS columns for this warp's 16 rows at r0 of the tile a and
// the NS n8 tiles of keys of the tile b (both [row][column], row stride
// LD). bf16: acc continues one tensor-core chain (from zero if `first`).
template <int LD, int COLS, int NS>
__device__ __forceinline__ void cols_dot(float (&acc)[NS][4],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int r0,
                                         int lane, bool first) {
  static_assert(NS % 2 == 0, "n8 tiles in pairs");
  if (first) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < COLS / 16; ++kk) {
    uint32_t af[4], bf[4];
    ldmatrix_x4(af, a_frag<LD>(a, r0, kk * 16, lane));
#pragma unroll
    for (int nn = 0; nn < NS / 2; ++nn) {
      ldmatrix_x4(bf, b_frag<LD>(b, nn * 16, kk * 16, lane));
      mma_bf16(acc[2 * nn], af, bf[0], bf[1]);
      mma_bf16(acc[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
}

// f32: split TF32, tensor-core sums of kSumSteps k-steps added in f32
// (dot_tiles); acc = that sum if `first`, else acc + it, in f32
template <int LD, int COLS, int NS>
__device__ __forceinline__ void cols_dot(float (&acc)[NS][4], const float* a,
                                         const float* b, int r0, int lane,
                                         bool first) {
  float part[NS][4];
  dot_tiles<LD, COLS / 8>(part, a, r0, b, 0, lane >> 2, lane & 3);
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = first ? part[n][e] : acc[n][e] + part[n][e];
}

// cols_dot (f32) with each fragment's k order permuted as frag_c_as_a
// permutes it (columns 2t and 2t + 1 of a k-step: one float2 a row, half
// the shared-memory loads): the same 8 products per k-step, so the same
// sums. Row stride LD = 8 mod 32 keeps those 64-bit loads free of bank
// conflicts.
template <int LD, int COLS, int NS>
__device__ __forceinline__ void cols_dot_pairs(float (&acc)[NS][4],
                                               const float* a, const float* b,
                                               int r0, int lane, bool first) {
  static_assert(LD % 32 == 8, "conflict-free 64-bit fragment loads");
  const int g = lane >> 2, t = lane & 3;
  float part[NS][4];
#pragma unroll
  for (int c0 = 0; c0 < COLS / 8; c0 += kSumSteps) {
    float chunk[NS][4] = {};
#pragma unroll
    for (int kk = c0; kk < c0 + kSumSteps && kk < COLS / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(
          a + (r0 + g) * LD + kk * 8 + 2 * t);
      const float2 x1 = *reinterpret_cast<const float2*>(
          a + (r0 + g + 8) * LD + kk * 8 + 2 * t);
      const float xa[4] = {x0.x, x1.x, x0.y, x1.y};
      uint32_t ah[4], al[4];
      split_tf32(xa, ah, al);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(
            b + (n * 8 + g) * LD + kk * 8 + 2 * t);
        const float yb[2] = {y.x, y.y};
        uint32_t bh[2], bl[2];
        split_tf32(yb, bh, bl);
        mma_3xtf32(chunk[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[n][e] = c0 == 0 ? chunk[n][e] : part[n][e] + chunk[n][e];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = first ? part[n][e] : acc[n][e] + part[n][e];
}

// acc[8] += P B for this warp's 16 rows at r0 of the tile p ([row][key],
// row stride LDP, KT keys) and the 64 columns at c0 of the tile b ([key]
// [column], row stride LD). bf16: ldmatrix fragments.
template <int LDP, int LD, int KT>
__device__ __forceinline__ void tile_mul_kt(float (&acc)[8][4],
                                            const __nv_bfloat16* p, int r0,
                                            const __nv_bfloat16* b, int c0,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a_frag<LDP>(p, r0, kk * 16, lane));
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, bt_frag<LD>(b, kk * 16, c0 + nd * 16, lane));
      mma_bf16(acc[2 * nd], af, bf[0], bf[1]);
      mma_bf16(acc[2 * nd + 1], af, bf[2], bf[3]);
    }
  }
}

// f32: split TF32 from the unrounded P, its A fragments read in the
// permuted k order of frag_b_kn (keys 2t and 2t + 1: one float2 a row),
// one tensor-core sum (KT / 8 <= kSumSteps k-steps) per n8 tile added to
// acc in f32; the k-steps outermost, so one A fragment is live at a time
template <int LDP, int LD, int KT>
__device__ __forceinline__ void tile_mul_kt(float (&acc)[8][4],
                                            const float* p, int r0,
                                            const float* b, int c0,
                                            int lane) {
  static_assert(KT / 8 <= kSumSteps, "one tensor-core sum a key tile");
  const int g = lane >> 2, t = lane & 3;
  float part[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(
        p + (r0 + g) * LDP + kk * 8 + 2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(
        p + (r0 + g + 8) * LDP + kk * 8 + 2 * t);
    const float x[4] = {x0.x, x1.x, x0.y, x1.y};
    uint32_t ah[4], al[4];
    split_tf32(x, ah, al);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bh[2], bl[2];
      frag_b_kn<LD>(bh, bl, b, kk * 8, c0 + n * 8, g, t);
      mma_3xtf32(part[n], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// This warp's partial sub-tile p (rows r0 + g, r0 + g + 8; NS n8 tiles
// of keys from key c0) into each row's owner: its incoming buffer `in`
// ([G source ranks][rows_max][KTP] f32, the same offset in every rank),
// slot of this rank `rank`, each store completing on the owner's
// mbarrier `bar` (the same offset in every rank).
template <int KTP, int NS>
__device__ __forceinline__ void push_partial(float* in, uint64_t* bar,
                                             const float (&p)[NS][4],
                                             int rank, int gc, int r0, int c0,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3, rmax = rows_max(gc);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i, ow = owner_of(row, gc);
    const uint32_t dst =
        cluster_addr(in + (rank * rmax + row - own_lo(ow, gc)) * KTP + c0 +
                         2 * t,
                     ow);
    const uint32_t b = cluster_addr(bar, ow);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const uint32_t w[2] = {__float_as_uint(p[n][2 * i]),
                             __float_as_uint(p[n][2 * i + 1])};
      st_async(dst + n * 8 * 4, w, b);
    }
  }
}

// An owner thread's CW keys of its row (orow of its owned rows) summed
// over the G ranks' partials in `in`, in rank order, from zero
template <int KTP, int CW>
__device__ __forceinline__ void owner_sum(float (&x)[CW], const float* in,
                                          int gc, int orow, int ch) {
  static_assert(CW % 4 == 0, "float4 reads");
#pragma unroll
  for (int c = 0; c < CW; ++c) x[c] = 0.f;
  const int rmax = rows_max(gc);
  for (int rr = 0; rr < gc; ++rr) {
    const float* src = in + (rr * rmax + orow) * KTP + ch * CW;
#pragma unroll
    for (int c = 0; c < CW; c += 4) {
      const float4 y = *reinterpret_cast<const float4*>(src + c);
      x[c] += y.x;
      x[c + 1] += y.y;
      x[c + 2] += y.z;
      x[c + 3] += y.w;
    }
  }
}

// An owner thread's CW values of row `row` into the tile `tile` ([64]
// [LDP] of T, the same offset in every rank) of every rank of the
// cluster, in the storage type (bf16: rounded to nearest even), each
// store completing on that rank's mbarrier `bar`
template <typename T, int LDP, int CW>
__device__ __forceinline__ void push_row(T* tile, uint64_t* bar,
                                         const float (&x)[CW], int gc,
                                         int row, int ch) {
  constexpr int kWords = CW * sizeof(T) / 4;
  static_assert(kWords == 2 || kWords % 4 == 0, "8- or 16-byte stores");
  uint32_t w[kWords];
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int c = 0; c < CW; ++c) w[c] = __float_as_uint(x[c]);
  } else {
#pragma unroll
    for (int c = 0; c < CW; c += 2) w[c / 2] = pack_bf16(x[c], x[c + 1]);
  }
  const T* at = tile + row * LDP + ch * CW;
  for (int rr = 0; rr < gc; ++rr) {
    const uint32_t dst = cluster_addr(at, rr), b = cluster_addr(bar, rr);
    if constexpr (kWords == 2) {
      st_async(dst, w, b);
    } else {
#pragma unroll
      for (int u = 0; u < kWords / 4; ++u) {
        const uint32_t w4[4] = {w[4 * u], w[4 * u + 1], w[4 * u + 2],
                                w[4 * u + 3]};
        st_async(dst + 16 * u, w4, b);
      }
    }
  }
}

// One float into `at` (the same offset in every rank) of every rank,
// completing on each rank's mbarrier `bar`
__device__ __forceinline__ void push_value(float* at, uint64_t* bar,
                                           float x, int gc) {
  const uint32_t w[1] = {__float_as_uint(x)};
  for (int rr = 0; rr < gc; ++rr)
    st_async(cluster_addr(at, rr), w, cluster_addr(bar, rr));
}

// Tiles of the cluster kernels: keys a tile, K and V buffers (KST,
// VST), row strides of the slices (LD; V's LDV), of P or dS (LDP) and of
// the extra tiles of 64 columns (LDX), the CTAs an SM is built for
// (shared memory and registers allow two for bf16), and whether Q K^T
// takes 64-bit fragment loads (cols_dot_pairs: the f32 forward, which
// shared-memory loads bind)
template <typename T>
struct WideFwdTiles;
template <>
struct WideFwdTiles<__nv_bfloat16> {
  static constexpr int KT = 64, KST = 1, VST = 1, LD = kSliceW + 8,
                       LDV = LD, LDP = KT + 8, LDX = 72, kMinCtas = 2;
  static constexpr bool kPairs = false;
};
template <>
struct WideFwdTiles<float> {   // registers allow one CTA an SM
  static constexpr int KT = 64, KST = 1, VST = 1, LD = kSliceW + 8,
                       LDV = kSliceW + 4, LDP = KT + 8, LDX = 72,
                       kMinCtas = 1;
  static constexpr bool kPairs = true;     // cols_dot_pairs for Q K^T
};

template <typename T>
struct WideDqTiles;
template <>
struct WideDqTiles<__nv_bfloat16> {
  static constexpr int KT = 32, KST = 2, VST = 1, LD = kSliceW + 8,
                       LDV = LD, LDP = KT + 8, LDX = 72, kMinCtas = 2;
  static constexpr bool kPairs = false;
};
template <>
struct WideDqTiles<float> {
  static constexpr int KT = 32, KST = 2, VST = 1, LD = kSliceW + 4,
                       LDV = LD, LDP = KT + 8, LDX = 68, kMinCtas = 1;
  static constexpr bool kPairs = false;
};

// dK/dV streams query tiles of KT rows (Q and dO, QST buffers each) past
// a resident key tile: f32 double-buffers them (both products of a tile
// read them, and the next tile's partials come before those products);
// bf16 takes one buffer each, so that two CTAs fit on an SM (108 KB of
// shared memory at 128 registers), and loads the next tile after the
// products. Past D = 1024 (groups > 1) the extra tiles leave no room for
// a second f32 buffer: one there too (dkv_layout). Each choice was timed
// against the other (PERF.md).
template <typename T>
struct WideDkvTiles;
template <>
struct WideDkvTiles<__nv_bfloat16> {
  static constexpr int KT = 32, QST = 1, LD = kSliceW + 8, LDP = KT + 8,
                       LDX = 72, kMinCtas = 2;
  static constexpr bool kPairs = false;
};
template <>
struct WideDkvTiles<float> {
  static constexpr int KT = 32, QST = 2, LD = kSliceW + 4, LDP = KT + 8,
                       LDX = 68, kMinCtas = 1;
  static constexpr bool kPairs = false;
};

// Byte offsets of a cluster kernel's dynamic shared memory: the own
// slices (Q; dO), the K and V tiles, the extra tile pair (groups >
// 1), the incoming partials of both parities (S; dP), P or dS of both
// parities, f32 rows (the forward's alpha of both parities and l, dQ's
// partial delta), then the mbarriers on which the incoming partials and
// P (dS) of each parity complete.
struct WideLayout {
  int q, dout, k, v, x, in, inp, pt, rows, bars, bytes;
};

template <typename L, typename T>
__host__ __device__ inline WideLayout wide_layout(bool dq, int gc,
                                                  int groups) {
  WideLayout w{};
  int at = 0;
  auto take = [&at](int bytes) {
    const int o = at;
    at += (bytes + 15) & ~15;
    return o;
  };
  const int in_bytes = 2 * gc * rows_max(gc) * (L::KT + 4) * 4;
  w.q = take(64 * L::LD * sizeof(T));
  w.dout = dq ? take(64 * L::LD * sizeof(T)) : 0;
  w.k = take(L::KST * L::KT * L::LD * sizeof(T));
  w.v = take(L::VST * L::KT * L::LDV * sizeof(T));
  w.x = groups > 1 ? take((64 + L::KT) * L::LDX * sizeof(T)) : 0;
  w.in = take(in_bytes);
  w.inp = dq ? take(in_bytes) : 0;
  w.pt = take(2 * 64 * L::LDP * sizeof(T));
  w.rows = take((dq ? 64 : 3 * 64) * 4);
  w.bars = take(4 * 8);   // mbarriers: partials in, P (dS) in; 2 parities
  w.bytes = at;
  return w;
}

// Byte offsets of the dK/dV kernel's dynamic shared memory: its K and V
// slices, `qst` buffers of the Q and dO tiles (WideDkvTiles) and of their
// LSE and delta, the extra tile pair (groups > 1), the incoming S^T and
// dP^T partials of both parities, P^T and dS^T of both parities, then
// the mbarriers on which the partials and P^T, dS^T of each parity
// complete, and those on which each buffer's tile lands.
struct WideDkvLayout {
  int k, v, q, dout, rows, x, in, inp, pt, bars, bytes, qst;
};

template <typename T>
__host__ __device__ inline WideDkvLayout dkv_layout(int gc, int groups) {
  using L = WideDkvTiles<T>;
  WideDkvLayout w{};
  int at = 0;
  auto take = [&at](int bytes) {
    const int o = at;
    at += (bytes + 15) & ~15;
    return o;
  };
  const int in_bytes = 2 * gc * rows_max(gc) * (L::KT + 4) * 4;
  const int tile = L::KT * L::LD * static_cast<int>(sizeof(T));
  w.qst = groups > 1 ? 1 : L::QST;
  w.k = take(64 * L::LD * sizeof(T));
  w.v = take(64 * L::LD * sizeof(T));
  w.q = take(w.qst * tile);
  w.dout = take(w.qst * tile);
  w.rows = take(w.qst * 2 * L::KT * 4);
  w.x = groups > 1 ? take((64 + L::KT) * L::LDX * sizeof(T)) : 0;
  w.in = take(in_bytes);
  w.inp = take(in_bytes);
  w.pt = take(2 * 2 * 64 * L::LDP * sizeof(T));
  w.bars = take(6 * 8);
  w.bytes = at;
  return w;
}

// This rank's partial (rows r0.., streamed rows half KT / 2 .. of tile
// j's KT) of A B^T over all its slices in order (groups > 1: the others
// loaded into the extra tiles xa, xb 64 columns at a time): the resident
// pair (as, bs) for its own slice `group`; `scale_a` scales each loaded
// A (the f32 forward's Q). A's 64 rows start at row0 of the (seq, D)
// matrix a, B's KT at row k0 of b (keys; queries in dK/dV).
template <typename L, typename T, int NS>
__device__ __forceinline__ void rank_partial(
    float (&s)[NS][4], const T* as, const T* bs, const T* a, const T* b,
    T* xa, T* xb, int row0, int k0, int seq, int D, int rank, int gc,
    int groups, int group, int r0, int half, int lane, float scale_a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KT = L::KT, LD = L::LD, LDX = L::LDX;
  for (int i = 0; i < groups; ++i) {
    if (i == group) {
      if constexpr (L::kPairs)
        cols_dot_pairs<LD, kSliceW>(s, as, bs + half * (KT / 2) * LD, r0,
                                    lane, i == 0);
      else
        cols_dot<LD, kSliceW>(s, as, bs + half * (KT / 2) * LD, r0, lane,
                              i == 0);
      continue;
    }
    const int c = (rank + i * gc) * kSliceW;
    float tmp[NS][4];
    for (int hc = 0; hc < 2; ++hc) {   // the slice in two 64-column halves
      __syncthreads();                 // xa, xb are free
      cp_async_cols<64, 64, LDX>(xa, a, D, row0, c + 64 * hc, seq);
      cp_async_cols<KT, 64, LDX>(xb, b, D, k0, c + 64 * hc, seq);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (kF32) {
        if (scale_a != 1.f) {
          scale_tile<64, 64, LDX>(xa, scale_a);
          __syncthreads();
        }
        // the slice's two sums of 8 k-steps, added as cols_dot adds them
        if constexpr (L::kPairs)
          cols_dot_pairs<LDX, 64>(tmp, xa, xb + half * (KT / 2) * LDX, r0,
                                  lane, hc == 0);
        else
          cols_dot<LDX, 64>(tmp, xa, xb + half * (KT / 2) * LDX, r0, lane,
                            hc == 0);
      } else {                         // one tensor-core chain
        cols_dot<LDX, 64>(s, xa, xb + half * (KT / 2) * LDX, r0, lane,
                          i == 0 && hc == 0);
      }
    }
    if constexpr (kF32) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = i == 0 ? tmp[n][e] : s[n][e] + tmp[n][e];
    }
  }
}

// O = softmax(scale Q K^T [causal]) V and LSE for one 64-row query tile:
// this rank's 128 columns of O, its owned rows of LSE (the note at the
// top).
template <typename T>
__global__ void __launch_bounds__(kWideThreads, WideFwdTiles<T>::kMinCtas)
    flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int seq, int D,
                          float scale, int causal) {
  using L = WideFwdTiles<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KT = L::KT, LD = L::LD, LDP = L::LDP, KTP = KT + 4;
  constexpr int NS = KT / 16;        // n8 tiles of a warp's partial
  constexpr int CW = KT / kTpr;      // keys of an owner thread
  extern __shared__ __align__(16) unsigned char smem_wide[];
  const cg::cluster_group cl = cg::this_cluster();
  const int gc = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int groups = gridDim.x / gc, group = blockIdx.x / gc;
  const int col0 = (group * gc + rank) * kSliceW;   // this rank's columns
  const WideLayout lay = wide_layout<L, T>(false, gc, groups);
  T* qs = reinterpret_cast<T*>(smem_wide + lay.q);
  T* ks = reinterpret_cast<T*>(smem_wide + lay.k);  // K tile j + 1
  T* vs = reinterpret_cast<T*>(smem_wide + lay.v);  // V tile j
  T* xa = reinterpret_cast<T*>(smem_wide + lay.x);
  T* xb = xa + 64 * L::LDX;
  float* in = reinterpret_cast<float*>(smem_wide + lay.in);
  T* pt = reinterpret_cast<T*>(smem_wide + lay.pt);
  float* alpha_s = reinterpret_cast<float*>(smem_wide + lay.rows);
  float* l_s = alpha_s + 2 * 64;
  const int in_par = gc * rows_max(gc) * KTP;     // floats a parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16, half = warp >> 2;
  const int lo = own_lo(rank, gc), n_own = own_lo(rank + 1, gc) - lo;
  const int orow = threadIdx.x / kTpr, ch = threadIdx.x % kTpr;
  const bool owner = orow < n_own;
  const int bh = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // causal: longest CTAs first
  const int q0 = qt * 64;
  const long long base = static_cast<long long>(bh) * seq * D;
  q += base;
  k += base;
  v += base;
  o += base;
  lse += static_cast<long long>(bh) * seq;
  const int tiles = (seq + KT - 1) / KT;
  const int n_k = causal ? min(tiles, (q0 + 64) / KT) : tiles;
  // S in log2 units for bf16 (exp2f), natural units for f32 (expf, Q
  // scaled first)
  const float mult = kF32 ? 1.f : scale * kLog2e;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_wide + lay.bars);
  uint64_t* full_in = bars;          // tile j's partials in: j & 1
  uint64_t* full_p = bars + 2;       // tile j's P and alpha in: j & 1
  const uint32_t in_bytes = gc * n_own * KT * 4;
  const uint32_t p_bytes = 64 * (KT * sizeof(T) + 4);

  auto load_k = [&](int j) {
    cp_async_cols<KT, kSliceW, LD>(ks, k, D, j * KT, col0, seq);
  };
  auto load_v = [&](int j) {
    cp_async_cols<KT, kSliceW, L::LDV>(vs, v, D, j * KT, col0, seq);
  };
  auto partial = [&](int j) {        // tile j's partial into its owners
    float s[NS][4];
    rank_partial<L>(s, qs, ks, q, k, xa, xb, q0, j * KT, seq, D, rank, gc,
                    groups, group, r0, half, lane, kF32 ? scale : 1.f);
    push_partial<KTP>(in + (j & 1) * in_par, full_in + (j & 1), s, rank, gc,
                      r0, half * (KT / 2), lane);
  };
  // cp.async groups: A_j (K tile j + 2, issued mid tile j) and B_j (V
  // tile j + 1, issued at the end of tile j), committed even when empty
  cp_async_cols<64, kSliceW, LD>(qs, q, D, q0, col0, seq);
  load_k(0);
  load_v(0);
  cp_async_commit();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(smem_addr(bars + i), 1);
    for (int i = 0; i < 2 && i < n_k; ++i) {
      mbar_expect_tx(smem_addr(full_in + i), in_bytes);
      mbar_expect_tx(smem_addr(full_p + i), p_bytes);
    }
    mbar_fence_init();
  }
  cluster_sync();                  // every rank runs, its mbarriers set
  cp_async_wait<0>();              // Q, K and V tile 0
  __syncthreads();
  if constexpr (kF32) {            // the forward scales Q first
    scale_tile<64, kSliceW, LD>(qs, scale);
    __syncthreads();
  }
  partial(0);
  __syncthreads();                 // K's buffer is free
  if (n_k > 1) load_k(1);
  cp_async_commit();               // A_-1
  cp_async_commit();               // B_-1 (V tile 0 is in)

  float acc[8][4] = {};            // O, unnormalised
  float m = kNegInf, l = 0.f;      // an owner's row
  for (int j = 0; j < n_k; ++j) {
    const int p = j & 1, k0 = j * KT;
    const uint32_t phase = (j >> 1) & 1;
    {  // the owned rows of tile j: P into every rank, and alpha
      float x[CW] = {};
      if (owner) {
        mbar_wait_cluster(smem_addr(full_in + p), phase);
        if (threadIdx.x == 0 && j + 2 < n_k)   // its next phase: tile j + 2
          mbar_expect_tx(smem_addr(full_in + p), in_bytes);
        owner_sum<KTP>(x, in + p * in_par, gc, orow, ch);
      }
      const int row = q0 + lo + orow;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        // a query row past seq is never stored: only keys are masked
        const int key = k0 + ch * CW + c;
        x[c] = key >= seq || (causal && key > row) ? kNegInf : x[c] * mult;
        mx = fmaxf(mx, x[c]);
      }
#pragma unroll
      for (int off = 1; off < kTpr; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float alpha = kF32 ? expf(m - m_new) : exp2f(m - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        x[c] = kF32 ? expf(x[c] - m_new) : exp2f(x[c] - m_new);
        sum += x[c];
      }
#pragma unroll
      for (int off = 1; off < kTpr; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l = l * alpha + sum;
      m = m_new;
      if (owner) {
        push_row<T, LDP>(pt + p * 64 * LDP, full_p + p, x, gc, lo + orow,
                         ch);
        if (ch == 0)
          push_value(alpha_s + p * 64 + lo + orow, full_p + p, alpha, gc);
      }
    }
    cp_async_wait<1>();            // A_j-1: K tile j + 1
    __syncthreads();
    if (j + 1 < n_k) {
      if (j > 0) cluster_wait();   // every owner has read tile j - 1's
      partial(j + 1);              // partials, whose buffer this refills
      __syncthreads();             // K's buffer is free
      if (j + 2 < n_k) load_k(j + 2);
    } else if (j > 0) {
      cluster_wait();
    }
    cp_async_commit();             // A_j
    cp_async_wait<1>();            // B_j-1: V tile j
    mbar_wait_cluster(smem_addr(full_p + p), phase);   // P of tile j
    if (threadIdx.x == 0 && j + 2 < n_k)
      mbar_expect_tx(smem_addr(full_p + p), p_bytes);
    const float a0 = alpha_s[p * 64 + r0 + g];
    const float a1 = alpha_s[p * 64 + r0 + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    __syncthreads();               // V tile j is visible to every warp
    tile_mul_kt<LDP, L::LDV, KT>(acc, pt + p * 64 * LDP, r0, vs, half * 64,
                                 lane);
    __syncthreads();               // V's buffer is free
    if (j + 1 < n_k) load_v(j + 1);
    cp_async_commit();             // B_j
    cluster_arrive_relaxed();      // tile j's partials and P are read
  }
  cluster_wait();
  if (owner && ch == 0)
    for (int rr = 0; rr < gc; ++rr)
      *cl.map_shared_rank(l_s + lo + orow, rr) = l;
  cluster_sync();                  // every row's l is in; no rank still
                                   // writes to another
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + g + 8 * i;
    if (r >= seq) continue;
    const float lc = fmaxf(l_s[r0 + g + 8 * i], 1e-30f);
    T* orow_p = o + static_cast<long long>(r) * D + col0 + half * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a = acc[n][2 * i] / lc, b = acc[n][2 * i + 1] / lc;
      if constexpr (kF32)
        *reinterpret_cast<float2*>(orow_p + 8 * n + 2 * t) = make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(orow_p + 8 * n + 2 * t) = pack_bf16(a, b);
    }
  }
  const int r = q0 + lo + orow;
  if (owner && ch == 0 && group == 0 && r < seq)
    lse[r] = (kF32 ? m : m * 0.6931471805599453f) + logf(fmaxf(l, 1e-30f));
}

// dQ = scale dS K, dS = P (dO V^T - delta), P = exp(scale Q K^T - LSE),
// and delta = rowsum(dO O) for one 64-row query tile: this rank's 128
// columns of dQ, its owned rows of delta (the note at the top).
template <typename T>
__global__ void __launch_bounds__(kWideThreads, WideDqTiles<T>::kMinCtas)
    flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse, T* __restrict__ dq,
                         float* __restrict__ delta, int seq, int D,
                         float scale, int causal) {
  using L = WideDqTiles<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KT = L::KT, LD = L::LD, LDP = L::LDP, KTP = KT + 4;
  constexpr int NS = KT / 16;        // n8 tiles of a warp's partials
  constexpr int CW = KT / kTpr;      // keys of an owner thread
  extern __shared__ __align__(16) unsigned char smem_wide[];
  const cg::cluster_group cl = cg::this_cluster();
  const int gc = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int groups = gridDim.x / gc, group = blockIdx.x / gc;
  const int col0 = (group * gc + rank) * kSliceW;   // this rank's columns
  const WideLayout lay = wide_layout<L, T>(true, gc, groups);
  T* qs = reinterpret_cast<T*>(smem_wide + lay.q);
  T* dos = reinterpret_cast<T*>(smem_wide + lay.dout);
  T* ks = reinterpret_cast<T*>(smem_wide + lay.k);  // K tile j at j & 1
  T* vs = reinterpret_cast<T*>(smem_wide + lay.v);  // V tile j + 1
  T* xa = reinterpret_cast<T*>(smem_wide + lay.x);
  T* xb = xa + 64 * L::LDX;
  float* in_s = reinterpret_cast<float*>(smem_wide + lay.in);   // S
  float* in_p = reinterpret_cast<float*>(smem_wide + lay.inp);  // dP
  T* pt = reinterpret_cast<T*>(smem_wide + lay.pt);             // dS
  float* drow = reinterpret_cast<float*>(smem_wide + lay.rows);
  const int in_par = gc * rows_max(gc) * KTP;     // floats a parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16, half = warp >> 2;
  const int lo = own_lo(rank, gc), n_own = own_lo(rank + 1, gc) - lo;
  const int orow = threadIdx.x / kTpr, ch = threadIdx.x % kTpr;
  const bool owner = orow < n_own;
  const int bh = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // causal: longest CTAs first
  const int q0 = qt * 64;
  const long long base = static_cast<long long>(bh) * seq * D;
  q += base;
  k += base;
  v += base;
  o += base;
  dout += base;
  dq += base;
  lse += static_cast<long long>(bh) * seq;
  delta += static_cast<long long>(bh) * seq;
  const int tiles = (seq + KT - 1) / KT;
  const int n_k = causal ? min(tiles, (q0 + 64) / KT) : tiles;

  auto load_k = [&](int j) {
    cp_async_cols<KT, kSliceW, LD>(ks + (j & 1) * KT * LD, k, D, j * KT,
                                   col0, seq);
  };
  auto load_v = [&](int j) {
    cp_async_cols<KT, kSliceW, LD>(vs, v, D, j * KT, col0, seq);
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_wide + lay.bars);
  uint64_t* full_in = bars;          // tile j's partials S, dP in: j & 1
  uint64_t* full_p = bars + 2;       // tile j's dS in: j & 1
  const uint32_t in_bytes = 2 * gc * n_own * KT * 4;
  const uint32_t p_bytes = 64 * KT * sizeof(T);
  auto partial = [&](int j) {        // tile j's partial S, dP into owners
    float s[NS][4];
    rank_partial<L>(s, qs, ks + (j & 1) * KT * LD, q, k, xa, xb, q0, j * KT,
                    seq, D, rank, gc, groups, group, r0, half, lane, 1.f);
    push_partial<KTP>(in_s + (j & 1) * in_par, full_in + (j & 1), s, rank,
                      gc, r0, half * (KT / 2), lane);
    rank_partial<L>(s, dos, vs, dout, v, xa, xb, q0, j * KT, seq, D, rank,
                    gc, groups, group, r0, half, lane, 1.f);
    push_partial<KTP>(in_p + (j & 1) * in_par, full_in + (j & 1), s, rank,
                      gc, r0, half * (KT / 2), lane);
  };
  cp_async_cols<64, kSliceW, LD>(qs, q, D, q0, col0, seq);
  cp_async_cols<64, kSliceW, LD>(dos, dout, D, q0, col0, seq);
  load_k(0);
  load_v(0);
  cp_async_commit();

  // delta's partial over this rank's slices: four lanes a row, 32 of
  // each slice's columns, from O and dO in device memory
  {
    const int rl = threadIdx.x >> 2, r = q0 + rl;
    float sum = 0.f;
    if (r < seq) {
      for (int i = 0; i < groups; ++i) {
        const long long at = static_cast<long long>(r) * D +
                             (rank + i * gc) * kSliceW + (lane & 3) * 32;
#pragma unroll
        for (int c = 0; c < 32; c += 16 / sizeof(T)) {
          const uint4 x = *reinterpret_cast<const uint4*>(o + at + c);
          const uint4 y = *reinterpret_cast<const uint4*>(dout + at + c);
          if constexpr (kF32) {
            const float4 a = *reinterpret_cast<const float4*>(&x);
            const float4 b = *reinterpret_cast<const float4*>(&y);
            sum = fmaf(a.x, b.x, sum);
            sum = fmaf(a.y, b.y, sum);
            sum = fmaf(a.z, b.z, sum);
            sum = fmaf(a.w, b.w, sum);
          } else {
            sum += dot8_bf16(x, y);
          }
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((lane & 3) == 0) drow[rl] = sum;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(smem_addr(bars + i), 1);
    for (int i = 0; i < 2 && i < n_k; ++i) {
      mbar_expect_tx(smem_addr(full_in + i), in_bytes);
      mbar_expect_tx(smem_addr(full_p + i), p_bytes);
    }
    mbar_fence_init();
  }
  cluster_sync();                  // every rank runs, its mbarriers set;
                                   // every drow is in
  // an owner's row: delta (the ranks' partials in rank order) and LSE
  const int orow_g = q0 + lo + orow;
  float delta_o = 0.f, lse_o = 0.f;
  if (owner) {
    for (int rr = 0; rr < gc; ++rr)
      delta_o += *cl.map_shared_rank(drow + lo + orow, rr);
    if (orow_g < seq) {
      lse_o = lse[orow_g] * (kF32 ? 1.f : kLog2e);
      if (ch == 0 && group == 0) delta[orow_g] = delta_o;
    }
  }
  // P = exp(S mult - LSE): natural units for f32, log2 units for bf16
  const float mult = kF32 ? scale : scale * kLog2e;
  cp_async_wait<0>();              // Q, dO, K and V tile 0
  __syncthreads();
  partial(0);
  __syncthreads();                 // V's buffer is free
  if (n_k > 1) {
    load_k(1);
    load_v(1);
  }
  cp_async_commit();
  float acc[8][4] = {};            // dQ, unscaled
  for (int j = 0; j < n_k; ++j) {
    const int p = j & 1, k0 = j * KT;
    const uint32_t phase = (j >> 1) & 1;
    {  // the owned rows of tile j: dS into every rank
      float x[CW] = {}, y[CW] = {};
      if (owner) {
        mbar_wait_cluster(smem_addr(full_in + p), phase);
        if (threadIdx.x == 0 && j + 2 < n_k)   // its next phase: tile j + 2
          mbar_expect_tx(smem_addr(full_in + p), in_bytes);
        owner_sum<KTP>(x, in_s + p * in_par, gc, orow, ch);
        owner_sum<KTP>(y, in_p + p * in_par, gc, orow, ch);
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float e = fmaf(x[c], mult, -lse_o);
        const float pr = masked(orow_g, k0 + ch * CW + c, seq, causal)
                             ? 0.f
                             : (kF32 ? expf(e) : exp2f(e));
        x[c] = pr * (y[c] - delta_o);           // dS
      }
      if (owner)
        push_row<T, LDP>(pt + p * 64 * LDP, full_p + p, x, gc, lo + orow,
                         ch);
    }
    if (j + 1 < n_k) {
      cp_async_wait<0>();          // K and V tile j + 1
      __syncthreads();
      if (j > 0) cluster_wait();   // every owner has read tile j - 1's
      partial(j + 1);              // partials, whose buffers this refills
      if (j + 2 < n_k) {
        __syncthreads();           // V's buffer is free
        load_v(j + 2);
        cp_async_commit();
      }
    } else if (j > 0) {
      cluster_wait();
    }
    mbar_wait_cluster(smem_addr(full_p + p), phase);   // dS of tile j
    if (threadIdx.x == 0 && j + 2 < n_k)
      mbar_expect_tx(smem_addr(full_p + p), p_bytes);
    tile_mul_kt<LDP, LD, KT>(acc, pt + p * 64 * LDP, r0, ks + p * KT * LD,
                             half * 64, lane);
    __syncthreads();               // K tile j's buffer is free
    if (j + 2 < n_k) {
      load_k(j + 2);
      cp_async_commit();
    }
    cluster_arrive_relaxed();      // tile j's partials and dS are read
  }
  cluster_wait();                  // no rank still reads drow or writes
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + g + 8 * i;
    if (r >= seq) continue;
    T* row = dq + static_cast<long long>(r) * D + col0 + half * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a = scale * acc[n][2 * i], b = scale * acc[n][2 * i + 1];
      if constexpr (kF32)
        *reinterpret_cast<float2*>(row + 8 * n + 2 * t) = make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * t) = pack_bf16(a, b);
    }
  }
}

// dK = scale dS^T Q and dV = P^T dO, P^T = exp(scale K Q^T - LSE) and
// dS^T = P^T (V dO^T - delta) with LSE and delta per column (query), for
// one 64-row key tile from the dQ kernel's delta: this rank's 128 columns
// of dK and dV (the note at the top).
template <typename T>
__global__ void __launch_bounds__(kWideThreads, WideDkvTiles<T>::kMinCtas)
    flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int seq,
                          int D, float scale, int causal) {
  using L = WideDkvTiles<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int QT = L::KT, LD = L::LD, LDP = L::LDP, QTP = QT + 4;
  constexpr int NS = QT / 16;        // n8 tiles of a warp's partials
  constexpr int CW = QT / kTpr;      // queries of an owner thread
  extern __shared__ __align__(16) unsigned char smem_wide[];
  const cg::cluster_group cl = cg::this_cluster();
  const int gc = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int groups = gridDim.x / gc, group = blockIdx.x / gc;
  const int col0 = (group * gc + rank) * kSliceW;   // this rank's columns
  const WideDkvLayout lay = dkv_layout<T>(gc, groups);
  // Q, dO tile j in buffer j & 1: f32 with one cluster a D (L::QST
  // first, so that bf16's code is free of that path at compile time)
  const bool two = L::QST == 2 && lay.qst == 2;
  T* ks = reinterpret_cast<T*>(smem_wide + lay.k);
  T* vs = reinterpret_cast<T*>(smem_wide + lay.v);
  T* qs = reinterpret_cast<T*>(smem_wide + lay.q);
  T* dos = reinterpret_cast<T*>(smem_wide + lay.dout);
  float* rows = reinterpret_cast<float*>(smem_wide + lay.rows);
  T* xa = reinterpret_cast<T*>(smem_wide + lay.x);
  T* xb = xa + 64 * L::LDX;
  float* in_s = reinterpret_cast<float*>(smem_wide + lay.in);   // S^T
  float* in_p = reinterpret_cast<float*>(smem_wide + lay.inp);  // dP^T
  T* pt = reinterpret_cast<T*>(smem_wide + lay.pt);  // P^T, dS^T a parity
  const int in_par = gc * rows_max(gc) * QTP;     // floats a parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16, half = warp >> 2;
  const int lo = own_lo(rank, gc), n_own = own_lo(rank + 1, gc) - lo;
  const int orow = threadIdx.x / kTpr, ch = threadIdx.x % kTpr;
  const bool owner = orow < n_own;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.z * 64;    // causal: key tile 0, the longest,
                                     // first
  const long long base = static_cast<long long>(bh) * seq * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  lse += static_cast<long long>(bh) * seq;
  delta += static_cast<long long>(bh) * seq;
  // query tiles j0 .. of QT rows; causal: from the one with key k0
  const int j0 = causal ? k0 / QT : 0;
  const int n_q = (seq + QT - 1) / QT - j0;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_wide + lay.bars);
  uint64_t* full_in = bars;          // tile j's partials S^T, dP^T: j & 1
  uint64_t* full_p = bars + 2;       // tile j's P^T and dS^T in: j & 1
  uint64_t* full_q = bars + 4;       // two buffers: tile j landed, j & 1
  const uint32_t in_bytes = 2 * gc * n_own * QT * 4;
  const uint32_t p_bytes = 2 * 64 * QT * sizeof(T);
  auto buf = [&](int j) { return (two ? j & 1 : 0) * QT * LD; };
  auto rows_of = [&](int j) { return rows + (two ? j & 1 : 0) * 2 * QT; };
  auto load_q = [&](int j) {         // Q, dO, LSE and delta of query tile j
    const int row0 = (j0 + j) * QT;
    cp_async_cols<QT, kSliceW, LD>(qs + buf(j), q, D, row0, col0, seq);
    cp_async_cols<QT, kSliceW, LD>(dos + buf(j), dout, D, row0, col0, seq);
    if (threadIdx.x < 2 * QT) {      // LSE at [0, QT), delta at [QT, 2 QT)
      const int i = threadIdx.x % QT, r = row0 + i;
      const float* src = threadIdx.x < QT ? lse : delta;
      cp_async4(rows_of(j) + threadIdx.x, src + (r < seq ? r : 0),
                r < seq ? 4 : 0);
    }
    if (two) cp_async_mbar_arrive(smem_addr(full_q + (j & 1)));
  };
  // two buffers: each thread waits for tile j's copies, no CTA barrier,
  // so a warp starts tile j's partials while the owners still finish
  // tile j - 1 (one buffer: the copies are waited for right after they
  // are issued, by a CTA barrier; the mbarrier spilled the bf16 kernel)
  auto wait_q = [&](int j) {
    mbar_wait(smem_addr(full_q + (j & 1)), (j >> 1) & 1);
  };
  auto partial = [&](int j) {        // tile j's S^T, dP^T into the owners
    const int row0 = (j0 + j) * QT;
    float s[NS][4];
    rank_partial<L>(s, ks, qs + buf(j), k, q, xa, xb, k0, row0, seq, D, rank,
                    gc, groups, group, r0, half, lane, 1.f);
    push_partial<QTP>(in_s + (j & 1) * in_par, full_in + (j & 1), s, rank,
                      gc, r0, half * (QT / 2), lane);
    rank_partial<L>(s, vs, dos + buf(j), v, dout, xa, xb, k0, row0, seq, D,
                    rank, gc, groups, group, r0, half, lane, 1.f);
    push_partial<QTP>(in_p + (j & 1) * in_par, full_in + (j & 1), s, rank,
                      gc, r0, half * (QT / 2), lane);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(smem_addr(bars + i), 1);
    for (int i = 4; i < 6; ++i) mbar_init(smem_addr(bars + i), kWideThreads);
    for (int i = 0; i < 2 && i < n_q; ++i) {
      mbar_expect_tx(smem_addr(full_in + i), in_bytes);
      mbar_expect_tx(smem_addr(full_p + i), p_bytes);
    }
    mbar_fence_init();
  }
  __syncthreads();                 // full_q is set before any arrival
  cp_async_cols<64, kSliceW, LD>(ks, k, D, k0, col0, seq);
  cp_async_cols<64, kSliceW, LD>(vs, v, D, k0, col0, seq);
  load_q(0);
  cp_async_commit();
  if (two && n_q > 1) load_q(1);
  cp_async_commit();
  cluster_sync();                  // every rank runs, its mbarriers set
  cp_async_wait<1>();              // K, V and tile 0
  __syncthreads();
  partial(0);
  // P^T = exp(S^T mult - LSE): natural units for f32, log2 units for bf16
  const float mult = kF32 ? scale : scale * kLog2e;
  const int key = k0 + lo + orow;  // an owner's row
  float acc_k[8][4] = {}, acc_v[8][4] = {};   // dK (unscaled), dV
  for (int j = 0; j < n_q; ++j) {
    const int p = j & 1, qrow0 = (j0 + j) * QT + ch * CW;
    const uint32_t phase = (j >> 1) & 1;
    T* ptj = pt + p * 2 * 64 * LDP;  // P^T of tile j, dS^T after it
    if (owner) {  // the owned rows of tile j: P^T and dS^T into every rank
      float x[CW], y[CW];
      mbar_wait_cluster(smem_addr(full_in + p), phase);
      if (threadIdx.x == 0 && j + 2 < n_q)     // its next phase: tile j + 2
        mbar_expect_tx(smem_addr(full_in + p), in_bytes);
      owner_sum<QTP>(x, in_s + p * in_par, gc, orow, ch);
      owner_sum<QTP>(y, in_p + p * in_par, gc, orow, ch);
      const float* lq = rows_of(j) + ch * CW;   // LSE, then delta at + QT
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float e = fmaf(x[c], mult, -lq[c] * (kF32 ? 1.f : kLog2e));
        const float pr = masked(qrow0 + c, key, seq, causal)
                             ? 0.f
                             : (kF32 ? expf(e) : exp2f(e));
        x[c] = pr;                                // P^T
        y[c] = pr * (y[c] - lq[QT + c]);          // dS^T
      }
      push_row<T, LDP>(ptj, full_p + p, x, gc, lo + orow, ch);
      push_row<T, LDP>(ptj + 64 * LDP, full_p + p, y, gc, lo + orow, ch);
    }
    if (two) {
      if (j + 1 < n_q) {
        wait_q(j + 1);
        if (j > 0) cluster_wait(); // every owner has read tile j - 1's
        partial(j + 1);            // partials, whose buffers this refills
      } else if (j > 0) {
        cluster_wait();
      }
    }
    mbar_wait_cluster(smem_addr(full_p + p), phase);   // P^T, dS^T of j
    if (threadIdx.x == 0 && j + 2 < n_q)
      mbar_expect_tx(smem_addr(full_p + p), p_bytes);
    tile_mul_kt<LDP, LD, QT>(acc_v, ptj, r0, dos + buf(j), half * 64, lane);
    tile_mul_kt<LDP, LD, QT>(acc_k, ptj + 64 * LDP, r0, qs + buf(j),
                             half * 64, lane);
    __syncthreads();               // tile j's Q, dO buffers are free
    if (two) {
      if (j + 2 < n_q) load_q(j + 2);
    } else if (j + 1 < n_q) {      // one buffer: tile j + 1 after j's
      load_q(j + 1);               // products
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (j > 0) cluster_wait();
      partial(j + 1);
    } else if (j > 0) {
      cluster_wait();
    }
    cluster_arrive_relaxed();      // tile j's partials and P^T, dS^T read
  }
  cluster_wait();                  // no rank still writes to another
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = k0 + r0 + g + 8 * i;
    if (r >= seq) continue;
    const long long at = static_cast<long long>(r) * D + col0 + half * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a = scale * acc_k[n][2 * i],
                  b = scale * acc_k[n][2 * i + 1];
      const float c = acc_v[n][2 * i], e = acc_v[n][2 * i + 1];
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(dk + at + 8 * n + 2 * t) =
            make_float2(a, b);
        *reinterpret_cast<float2*>(dv + at + 8 * n + 2 * t) =
            make_float2(c, e);
      } else {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * n + 2 * t) =
            pack_bf16(a, b);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * n + 2 * t) =
            pack_bf16(c, e);
      }
    }
  }
}

// Launch `kernel` (a cluster kernel) for head_dim D on a (G groups, bh,
// ceil(seq / 64)) grid of clusters of G CTAs along x, with `bytes` of
// dynamic shared memory; returns the launch's error code (a refused
// cluster launch included: nothing falls back).
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, size_t bytes, int bh, int seq, int D,
                   cudaStream_t stream, Args... args) {
  int gc = 0, groups = 0;
  if (!wide_cluster(D, &gc, &groups)) return cudaErrorInvalidValue;
  const int tiles = (seq + 63) / 64;
  if (tiles > 65535 || bh > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gc * groups, bh, tiles);   // the tile axis slowest
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = gc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Run `fn(T{})` for dtype 0 = f32, 1 = bf16; cudaErrorInvalidValue else.
template <typename Fn>
int wide_dispatch(int dtype, const Fn& fn) {
  if (dtype == 0) return fn(float{});
  if (dtype == 1) return fn(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of the forward (which 0), dQ (1) or
// dK/dV (2) for storage T at head_dim D (0 for a D the kernels do not
// take)
template <typename T>
size_t cluster_smem(int which, int D) {
  int gc = 0, groups = 0;
  if (!wide_cluster(D, &gc, &groups)) return 0;
  return which == 0
             ? wide_layout<WideFwdTiles<T>, T>(false, gc, groups).bytes
         : which == 1
             ? wide_layout<WideDqTiles<T>, T>(true, gc, groups).bytes
             : dkv_layout<T>(gc, groups).bytes;
}

inline int wide_forward(const void* q, const void* k, const void* v, void* o,
                        float* lse, int dtype, int bh, int seq, int D,
                        float scale, int causal, cudaStream_t stream) {
  return wide_dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch_cluster(flash_wide_fwd_kernel<T>,
                          cluster_smem<T>(0, D), bh, seq, D,
                          stream, static_cast<const T*>(q),
                          static_cast<const T*>(k), static_cast<const T*>(v),
                          static_cast<T*>(o), lse, seq, D, scale, causal);
  });
}

inline int wide_dq(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, float* delta,
                   int dtype, int bh, int seq, int D, float scale, int causal,
                   cudaStream_t stream) {
  return wide_dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch_cluster(flash_wide_dq_kernel<T>,
                          cluster_smem<T>(1, D), bh, seq, D,
                          stream, static_cast<const T*>(q),
                          static_cast<const T*>(k), static_cast<const T*>(v),
                          static_cast<const T*>(o),
                          static_cast<const T*>(dout), lse,
                          static_cast<T*>(dq), delta, seq, D, scale, causal);
  });
}

inline int wide_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int dtype, int bh, int seq, int D,
                    float scale, int causal, cudaStream_t stream) {
  return wide_dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch_cluster(flash_wide_dkv_kernel<T>,
                          cluster_smem<T>(2, D), bh, seq, D,
                          stream, static_cast<const T*>(q),
                          static_cast<const T*>(k), static_cast<const T*>(v),
                          static_cast<const T*>(dout), lse, delta,
                          static_cast<T*>(dk), static_cast<T*>(dv), seq, D,
                          scale, causal);
  });
}

// What the runtime says of one kernel launched with `threads` threads and
// `bytes` of dynamic shared memory, into out[0..5]: registers a thread,
// local memory a thread (spills), dynamic shared memory, resident CTAs
// per SM, cluster size (1: no cluster) and co-resident clusters on the
// card (cudaOccupancyMaxActiveClusters; 0 with no cluster).
template <typename Kernel>
int fill_info(Kernel kernel, int threads, size_t bytes, int gc, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int ctas = 0, clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        threads, bytes);
  if (err == cudaSuccess && gc > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(gc);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = gc;
    a[0].val.clusterDim.y = 1;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(bytes);
  out[3] = ctas;
  out[4] = gc;
  out[5] = clusters;
  return cudaSuccess;
}

// which 0: the forward, 1: dQ, 2: dK/dV at head_dim D
inline int wide_info(int which, int dtype, int D, int* out) {
  int gc = 0, groups = 0;
  if (!wide_cluster(D, &gc, &groups)) return cudaErrorInvalidValue;
  return wide_dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    const size_t bytes = cluster_smem<T>(which, D);
    return which == 0
               ? fill_info(flash_wide_fwd_kernel<T>, kWideThreads, bytes, gc,
                           out)
           : which == 1
               ? fill_info(flash_wide_dq_kernel<T>, kWideThreads, bytes, gc,
                           out)
               : fill_info(flash_wide_dkv_kernel<T>, kWideThreads, bytes, gc,
                           out);
  });
}

}  // namespace sparknet_flash
