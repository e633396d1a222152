// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the TPU kernels sparknet_tpu/ops/pallas_attention.py:_dq_kernel
// and :_dkv_kernel (reached from flash_attention's custom_vjp through
// _flash_backward there), the FlashAttention-2 recurrences with P
// recomputed from the forward's saved LSE:
//   P_ij   = exp(scale * Q_i K_j^T - LSE_i)      (masked: -1e30 -> 0)
//   delta_i = rowsum(dO_i * O_i)                 (O as stored)
//   dS_ij  = P_ij * (dO_i V_j^T - delta_i)
//   dQ_i   = scale * sum_j dS_ij K_j             (the dQ kernel)
//   dV_j   = sum_i P_ij^T dO_i                    (the dK/dV kernel)
//   dK_j   = scale * sum_i dS_ij^T Q_i           (the dK/dV kernel)
// The product is scaled (not Q), as the TPU backward does. Storage f32 or
// bf16, head_dim 16, 32, 64, 128 or 256, any sequence length. Two kernels and
// no atomics: every output element is summed by one thread in a fixed
// order, so the result is the same launch after launch.
//
// Not carried over block by block: the TPU kernels recompute delta at
// every block visit; here the dQ kernel, which reads each query row's dO
// once anyway, computes delta once, in f32 from O as stored, and writes
// it to a (B*H, S) f32 buffer that the dK/dV kernel, launched after it on
// the same stream, reads.
//
// Bound on the H100: operations. dQ does 3 and dK/dV 4 products of
// 2 * S^2 * D (halved when causal): at the LM's (4, 8, 4096, 128) causal,
// 206 GFLOP and 275 GFLOP against 202 MB of bf16 q, k, v, o, dO, dq, dk,
// dv, LSE and delta: 0.21 and 0.28 ms at 989 TFLOP/s of dense bf16.
//
// bf16 storage up to head_dim 128 (flash_dq_wgmma_kernel<D>,
// flash_dkv_wgmma_kernel<D>, D = 16, 32, 64, 128): every product on
// wgmma (flash_wgmma.cuh). A CTA of 384 threads: a producer warpgroup
// (setmaxnreg leaves it 24 registers a thread) and two consumer
// warpgroups (240), each owning 64 of the CTA's 128 rows and all D
// output columns, so S and dP (S^T and dP^T) are built once per tile
// pair and no warpgroup waits on the other: no CTA barrier in the loop.
//  - Loads: one producer thread issues TMA copies through 3-D tensor maps
//    (D, S, B*H) into tiles of D / W column blocks in the swizzle of 2 W
//    bytes, W = min(D, 64) (128 bytes at D = 64 and 128, as the forward);
//    rows past S arrive as zeros. The CTA's own 128-row pair lands once;
//    the streamed 64-row pair goes through a ring of three stages, each
//    with a full mbarrier (the copies' bytes) and a free one (all 256
//    consumer threads arrive after their last product that reads it), so
//    two tiles are in flight under the products of the one in hand.
//    Shared memory at D = 128: own pair 64 KB + 3 x 32 KB = 161 KB (dK/dV
//    1.5 KB more for the stages' LSE and delta rows), one CTA an SM.
//  - dQ: the CTA owns 128 queries (Q, dO resident) and walks the keys in
//    tiles of 64 (K, V streamed). A warpgroup builds dP = dO V^T and
//    S = Q K^T for its 64 rows (m64n64k16, D / 16 k-steps, both operands
//    in shared memory), forms P and dS in registers, and adds dS K into
//    its dQ rows (m64nDk16, dS packed from the accumulators as the
//    register A operand, K read MN-major): 32 + 32 + D / 2 f32 a thread.
//    S and dP of tile j + 1 go to the tensor cores before dS K of tile
//    j, so tile j + 1's softmax runs under dS K; and the two warpgroups
//    take turns to issue S and dP (named barriers), so one's softmax
//    runs under the other's products.
//    delta is computed first, in f32 from O and dO as stored, by the 4
//    threads of a quad that hold a row's accumulators (D / 4 columns
//    each, added by two shuffles), and written to the (B*H, S) buffer
//    that the dK/dV kernel reads.
//  - dK/dV: the CTA owns 128 keys (K, V resident) and streams 64-query
//    tiles of Q and dO. A warpgroup builds dP^T = V dO^T and S^T = K Q^T
//    for its 64 keys (m64n64k16), forms P^T and dS^T in registers and
//    adds P^T dO and dS^T Q into its dV and dK rows (m64nDk16, register
//    A, dO and Q read MN-major): 64 + 64 + 32 + 32 f32 a thread at
//    D = 128, so unlike head_dim 256 nothing goes through shared memory
//    between the products. dP^T is issued before S^T and its delta taken
//    off while S^T runs; the accumulators leave no registers for the
//    next tile's products, and turns at the tensor cores as in dQ ran
//    slower here. LSE and delta are indexed by S^T's columns,
//    16 of them a thread: the producer warpgroup's 128 threads write a
//    tile's 64 of each into its stage before the stage's full barrier
//    (rows past S as zeros), and the consumers read them from there.
//  - Causal: tiles past the diagonal are skipped (and a warpgroup's tile
//    that none of its rows see: dQ's first warpgroup leaves the CTA's
//    last key tile, dK/dV's second its first query tile, after arriving
//    on its free barrier); the mask runs only on tiles that cross the
//    diagonal or S. The dQ kernel maps the tile axis to query tiles last
//    to first and dK/dV's key tile 0 walks the most query tiles, so the
//    longest CTAs start first and the causal tail does not leave the last
//    wave half empty.
//  - P = 2^(S scale log2(e) - LSE log2(e)) in one MUFU.EX2 a score
//    (fast_exp2): exp2f's range handling added several instructions and
//    predicates a score, made the softmax a large share of a tile's
//    time, and spilled dK/dV's registers.
//  - Rounding: P and dS (P^T and dS^T) are rounded to bf16 once, before
//    the second products, as any tensor-core backward does (the TPU's MXU
//    takes the JAX kernel's f32 operands as single-pass bf16); the worst
//    64-row tile of dQ, dK, dV then reads ~3e-3 of its norm against the
//    f32 plain version (tests/test_torch_flash_rounding.py emulates the
//    kernels' tile walk; chip_smoke.py's limit 5e-3). S, dP, delta and
//    the dQ, dK, dV sums stay in f32; the outputs are rounded once. Every
//    output element is summed by one thread in a fixed order (dQ over the
//    key tiles, dK and dV over the query tiles, each into one f32
//    accumulator chain), with no atomics: two launches give the same
//    bits. The library's five-product backward would need atomics on dQ,
//    so the two kernels stay.
//  - Registers a thread, shared memory and CTAs per SM, as the runtime
//    reports them on the H100 (sparknet_flash_backward_info, printed and
//    checked by chip_smoke.py phase 6): 168 at launch (384 threads, the
//    consumers 240 after setmaxnreg), one CTA an SM, no spills; shared
//    memory 2 x 128 x 2 D + 3 x 2 x 64 x 2 D bytes + 1 KB (D = 128: 161
//    KB), dK/dV 1.5 KB more. At the LM's shape: PERF.md
//    (scripts/flash_ab.py).

// bf16 storage at head_dim 256 (flash_dq_wgmma256_kernel,
// flash_dkv_wgmma256_kernel; and D 129-255, zero-padded to it): one CTA of two
// warpgroups (256 threads, one CTA an SM) owns all 256 output columns of
// its tile, so S and dP (S^T and dP^T) are built once per tile pair, every
// product on wgmma (flash_wgmma.cuh). Loads: one thread issues TMA copies
// through 3-D tensor maps (D, S, B*H), four 64-column blocks of 128-byte
// swizzle a tile (rows past S arrive as zeros), each completing on an
// mbarrier; the streamed tiles are in flight under the products of the
// tile before.
//  - dQ: the CTA owns 128 queries (Q, dO resident, 128 KB), each
//    warpgroup 64 of them, and walks the keys in tiles of 64. A
//    warpgroup builds dP = dO V^T, then S = Q K^T, for its rows and all
//    64 keys (m64n64k16, both operands in shared memory, 16 k-steps over
//    D), forms dS in registers and adds dS K into its own dQ rows, all 256
//    columns (m64n256k16, dS as the register A operand, K read MN-major):
//    128 f32 accumulators a thread, and no exchange between the
//    warpgroups. K goes through two slots and V through one (224 KB in
//    all): V is released as soon as both warpgroups' dP is done (an
//    mbarrier every thread arrives on), and V of the next tile loads
//    under the softmax and dS K; K is released after dS K. delta is
//    computed first, two threads a row, from O and dO as stored.
//  - dK/dV: the CTA owns 64 keys (K, V resident), and streams 64-query
//    tiles of Q and dO (with their LSE and delta rows, read from device
//    memory under the products) through two stages. The accumulators of
//    dK and dV for all 256 columns (256 f32 a thread) do not fit one
//    warpgroup, so the work splits between the warpgroups twice: each
//    builds S^T and dP^T for its 32 of the tile's queries (m64n32k16),
//    writes P^T and dS^T as bf16 to 64 x 64 tiles in the same 128-byte
//    swizzle (the 8 rows of a store phase on 8 distinct 16-byte bank
//    groups), and after a CTA barrier adds P^T dO and dS^T Q into its own
//    128 columns of dV and dK over all 64 queries (m64n128k16, A the
//    handoff tile, B the streamed tile read MN-major). 209 KB.
//  - Causal, rounding and determinism as above: tiles past the diagonal
//    skipped (dQ's second warpgroup sees its last key tile, the first
//    none of it: masked), the longest CTAs first; P and dS (P^T, dS^T)
//    rounded to bf16 once; every output element summed by one thread in a
//    fixed order, no atomics.
//  - Registers a thread, shared memory and CTAs per SM on the H100
//    (sparknet_flash_backward_info, chip_smoke.py phase 6): dQ 240, 226 KB,
//    1; dK/dV 199, 209 KB, 1; no spills. At the lm verb's d_model 2048
//    shape, (2, 8, 4096, 256) causal, dQ and dK/dV take PERF.md's times.
//
// f32 storage at head_dim 64 and 128 (flash_dq_tf32_wgmma_kernel<D>,
// flash_dkv_tf32_wgmma_kernel<D>): every product on wgmma in split TF32
// (3xTF32: a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi, f32 accumulation;
// wgmma_tf32, flash_wgmma.cuh), which keeps the f32 limits (5e-4 of the
// largest element, 1e-4 of a 64-row tile). TF32 wgmma takes both operands
// K-major and has no transpose, and TMA does not transpose, so:
//  - A always comes from registers, gathered by threads from the tile
//    that TMA wrote and split there (flash_tf32.cuh's split_tf32): K and V
//    as A of S^T = K Q^T and dP^T = V dO^T (one ldmatrix.x4 a k-step), and
//    K^T, dO^T, Q^T as A of the second products, which run transposed:
//    dQ^T = K^T dS^T, dV^T = dO^T P, dK^T = Q^T dS.
//  - B comes from shared memory, K-major: Q and dO as TMA wrote them (3-D
//    maps (D, S, B*H) of f32, 32-float column blocks in the 128-byte
//    swizzle, rows_map<float>), and dS^T, P^T, dS^T as the threads write
//    them from the accumulators. A TMA tile serves as its own hi (the
//    tensor core reads a TF32 operand's top 19 bits: hi = x truncated) and
//    its lo, x - trunc(x), goes to a tile of its own, written once a CTA
//    by warps 1-3 of the producer warpgroup when the tile lands, then
//    handed over through fence.proxy.async and an mbarrier; a handoff is
//    split by the threads that write it.
// A CTA of 384 threads: a producer warpgroup (24 registers after
// setmaxnreg; one thread issues the copies) and two consumer warpgroups
// (240), one CTA an SM.
//  - dQ: the CTA owns 64 queries: Q, dO and their lo parts resident (128
//    KB at D = 128), one 64-key slot each for K and V (64 KB) and the
//    64 x 64 dS^T handoff, hi and lo (32 KB): 225.6 KB. Warpgroup 0 builds
//    S^T and P^T, warpgroup 1 dP^T (m64n64k8, every K and V fragment
//    gathered once a CTA) and, from P^T handed through the dS^T tile,
//    dS^T; then each adds K^T dS^T into its 64 rows of dQ^T (D = 64: all
//    rows, its 32 queries). V is released once dP^T is issued, K once
//    both warpgroups hold their K^T fragments, so the next K and V load
//    under the softmax and dQ^T. delta is computed first, in f32 from O
//    and dO as stored, four threads a row.
//  - dK/dV: the CTA owns 64 keys (K, V resident, 64 KB) and streams
//    32-query tiles through two stages (Q, dO and their lo parts, 64 KB
//    a stage) beside the 64 x 32 P^T and dS^T handoffs, hi and lo (32
//    KB): 225.1 KB. Warpgroup 0 builds S^T, P^T and dV^T += dO^T P;
//    warpgroup 1 dP^T, dS^T from warpgroup 0's P^T, and dK^T += Q^T dS;
//    each owns all D rows of its output, a 64-row block at a time (one
//    set of chunk registers). LSE and delta are read from device memory
//    under the first product.
//  - Sums: S^T and dP^T are one tensor-core sum over all of D (16 k-steps
//    at D = 128, twice flash_tf32.cuh's kSumSteps: the tile error doubles,
//    to ~2e-6 in tests/test_torch_flash_rounding.py's emulation at S 256,
//    and reads 2.0-2.6e-06 on the card at (4, 8, 4096, 128)), the second
//    products one sum a streamed tile (8 and 4 k-steps), added in f32.
//    Two k-steps are committed as one group, at most two groups in flight.
//  - Causal, determinism: tiles past the diagonal skipped, the longest
//    CTAs first; every output element summed by one thread in a fixed
//    order, no atomics.
//  - 168 registers at launch, no spills, one CTA an SM (chip_smoke.py
//    phase 6's _f32_bwd_design). At the LM's shape, (4, 8, 4096, 128)
//    causal: PERF.md (scripts/flash_ab.py --cases f32).
// f32 storage at head_dim 256, and 129-255 zero-padded to it
// (flash_dq_tf32_wgmma256_kernel, flash_dkv_tf32_wgmma256_kernel): the
// design above over a thread-block cluster of two CTAs ("ranks"), since
// its f32 tiles with their lo parts (225 KB at head_dim 128) do not fit
// one CTA at 256. Rank r owns the columns [128 r, 128 r + 128) of D: its
// slices of Q, K, V, dO and of dQ (dK, dV), each CTA laid out as the
// head_dim-128 kernels (384 threads, the same roles of the producer and
// the two consumer warpgroups, every product wgmma m64nNk8 in split TF32).
//  - Scores once: each rank builds its partial S^T = K_r Q_r^T and dP^T =
//    V_r dO_r^T over its 128 columns (one tensor-core sum of 16 k-steps,
//    as at head_dim 128). A tile's queries split between the ranks: rank
//    r finishes queries [16 r, 16 r + 16) of each 32, which are the same
//    8 of the 16 accumulator registers in every thread of either rank.
//    So a thread sends the other half of its registers to the thread in
//    the same place of the other rank (st.async into an exchange buffer
//    there, 8 f32 a thread, completing on that rank's mbarrier), and
//    adds the 8 it receives to its own half in rank order, in f32: every
//    score is summed once, in a fixed order. It finishes P^T (warpgroup
//    0) and dS^T (warpgroup 1) for its half and sends those back the same
//    way, and each rank writes both halves, hi and lo, into its handoff
//    tiles for the second products over its own 128 columns. Per tile a
//    rank receives 4 KB of each of S^T and dP^T and 4 KB of dS^T (and
//    P^T in dK/dV): no cluster barrier in the loop. An exchange buffer is
//    refilled only after its reader has passed it on: the other rank's
//    next write into it waits, through the data it needs, on what its
//    reader sent after reading it (a tile's partials wait on the last
//    tile's dS^T), so one buffer each and one mbarrier phase a tile
//    suffice, armed by its reader before it sends what releases the next.
//  - delta = rowsum(dO O): each rank of dQ reads the whole 256-column
//    rows from device memory (8 threads a row, 32 columns each), the
//    same sum in the same order on both ranks, and rank 0 writes it; a
//    gather of per-rank partials would add an exchange to the start of
//    every CTA for 32 KB of reads.
//  - dQ: a cluster owns 32 queries (Q, dO and their lo parts, 64 KB a
//    rank) and walks the key tiles of 64 through two stages of K and V
//    (128 KB), with the 32 x 64 dS^T handoff hi and lo and four exchange
//    buffers (the P^T handoff between its warpgroups is one of them):
//    230,784 bytes. 64 queries, as at head_dim 128, would need 256 KB
//    with one K and one V slot.
//  - dK/dV: a cluster owns 64 keys (K, V: 64 KB a rank) and streams
//    32-query tiles of Q and dO through two stages; the lo parts of the
//    tile in hand are written once the tile before is through its first
//    products, so one lo buffer serves both stages (214,144 bytes; one
//    for each stage would need 246,912).
//  - Launched with cudaLaunchKernelEx, a cluster dimension of 2 on a (2,
//    bh, tiles) grid, the longest clusters first; a cluster launch the
//    card refuses returns its error (no fallback). 168 registers at
//    launch, no spills, one CTA an SM, 66 clusters co-resident
//    (chip_smoke.py phase 6's _f32_bwd256_design). At (2, 8, 4096, 256)
//    causal, lm --d-model 2048 --heads 8's attention: PERF.md
//    (scripts/flash_ab.py --cases f32-256).
// f32 storage at head_dim 16 and 32 (flash_dq_tf32_kernel,
// flash_dkv_tf32_kernel): split TF32 on mma.sync m16n8k8 (flash_tf32.cuh):
// the transposed second products of the designs above would have M =
// head_dim rows, below wgmma's 64. A CTA of 4 warps owns a 64-row tile, a
// warp 16 rows of it, and streams 64-row tiles through two cp.async
// stages: f32 tiles of row stride D + 4 fed to mma.sync by plain
// shared-memory loads. S, dP, P and dS stay in f32 and enter the second
// products split, from the accumulators; nothing is rounded between the
// products. Every tensor-core sum runs over at most 64 columns of D or one
// streamed tile and is then added in f32 (the tensor core truncates its
// sums: flash_tf32.cuh). P is exp(scale S - LSE) in natural units, as the
// plain version computes it. Bound: operations, 165 TFLOP/s of
// f32-accurate products (495 TFLOP/s of dense TF32 over 3 products).
// Registers a thread, shared memory and CTAs per SM on the H100
// (sparknet_flash_backward_info, chip_smoke.py phase 6); no spills:
//        D        16           32
//        dQ       128 30 KB 4  128 54 KB 4
//        dK/dV    155 31 KB 3  164 55 KB 3
// At the lm verb's defaults, (8, 8, 256, 32) causal: PERF.md.
// The storage type picks the kernel and nothing else does.

#include <type_traits>

#include "flash_cluster.cuh"
#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_tf32.cuh"
#include "flash_wgmma.cuh"
#include "flash_wide.cuh"

namespace sparknet_flash {

// bf16 storage up to head_dim 128: the wgmma kernels (the note at the top).

using bf16 = __nv_bfloat16;

constexpr int kBwdThreads = 384;   // a producer warpgroup, two consumers
constexpr int kBwdRows = 128;      // a CTA's own rows (queries of dQ, keys of
                                   // dK/dV), 64 a consumer warpgroup
constexpr int kBwdStages = 3;      // the ring of streamed 64-row tile pairs

// Shared-memory geometry of the bf16 backward at head_dim D <= 128 (bytes;
// flash_wgmma.cuh): a tile of R rows of D bf16 is D / W column blocks of
// R rows of RB bytes, in the RB-byte swizzle that TMA writes and wgmma
// reads. The CTA's own pair of 128-row tiles (Q and dO, or K and V) stays
// resident; the streamed pair (K and V, or Q and dO) of each 64-row tile
// goes through a ring of kBwdStages stages.
template <int D>
struct BwdTiles {
  static_assert(D <= 128, "bf16 head_dim 256 runs the Bwd256Tiles kernels");
  static constexpr int W = D < 64 ? D : 64;   // columns of a swizzle block
  static constexpr int RB = 2 * W;            // its row: the swizzle bytes
  static constexpr int SBO = 8 * RB;          // 8 rows
  static constexpr int OWN = kBwdRows * D * 2;      // one own tile
  static constexpr int STREAMED = kBlockK * D * 2;  // one streamed tile
  static constexpr int STAGE = 2 * STREAMED;        // a stage: the pair
  // the own pair, the ring, 1 + 2 kBwdStages mbarriers, 1024 bytes to
  // align the tiles; dK/dV also the LSE and delta rows of each stage's
  // queries (f32)
  static constexpr size_t kDqSmem = 2 * OWN + kBwdStages * STAGE + 64 + 1024;
  static constexpr size_t kDkvSmem = kDqSmem + kBwdStages * 2 * kBlockQ * 4;

  // K-major descriptor of the 16 columns 16 kk .. of a tile of `rows`
  // rows, from row `row0` (a multiple of 8) on
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows,
                                                    int row0, int kk) {
    const int c = 16 * kk;
    return wgmma_desc(tile + (c / W) * rows * RB + row0 * RB + (c % W) * 2,
                      16, SBO, RB);
  }
  // MN-major descriptor of rows 16 kk .. 16 kk + 15 of a tile of `rows`
  // rows, all D columns (the next W columns one block further on)
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows,
                                                     int kk) {
    return wgmma_desc(tile + kk * 16 * RB, rows * RB, SBO, RB);
  }
  // rows row0 .. of a (D, seq, bh) map whose box is `rows` rows, into the
  // tile at `dst`, completing on `bar`
  static __device__ __forceinline__ void load(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int rows,
                                              int row0, int bh) {
#pragma unroll
    for (int c = 0; c < D / W; ++c)
      tma_load_3d(dst + c * rows * RB, map, bar, c * W, row0, bh);
  }
};

// mbarriers of the kernels below, from `bars`: +0 the own pair landed;
// then each stage's "full" (its pair landed) and "free" (all 256
// consumer threads have read it)
__device__ __forceinline__ uint32_t stage_full(uint32_t bars, int st) {
  return bars + 8 + 8 * st;
}
__device__ __forceinline__ uint32_t stage_free(uint32_t bars, int st) {
  return bars + 8 + 8 * (kBwdStages + st);
}

// The producer warpgroup: setmaxnreg leaves it 24 registers a thread, and
// one thread loads the own pair, then the streamed pair of each tile
// it = 0 .. n - 1 (rows row0 + 64 it ..) into stage it % kBwdStages once
// that stage's tile before is read. With `rows` (dK/dV), the warpgroup's
// 128 threads first write the stage's 64 rows of LSE (log2 units) and
// delta there, rows past seq as zeros: the stage's full barrier, which
// that thread arrives on after a barrier of the warpgroup, then covers
// them.
template <int D>
__device__ __forceinline__ void bwd_producer(
    uint32_t own, const CUtensorMap* own0, const CUtensorMap* own1,
    int own_row0, uint32_t ring, const CUtensorMap* str0,
    const CUtensorMap* str1, int row0, int n, uint32_t bars, int bh,
    float* rows = nullptr, const float* lse = nullptr,
    const float* delta = nullptr, int seq = 0) {
  using L = BwdTiles<D>;
  setmaxnreg_dec<24>();
  const int p = threadIdx.x - 256;     // 0 .. 127
  if (rows == nullptr && p != 0) return;
  if (p == 0) {
    mbar_expect_tx(bars, 2 * L::OWN);
    L::load(own, own0, bars, kBwdRows, own_row0, bh);
    L::load(own + L::OWN, own1, bars, kBwdRows, own_row0, bh);
  }
  for (int it = 0; it < n; ++it) {
    const int st = it % kBwdStages, r0 = row0 + it * kBlockK;
    const uint32_t dst = ring + st * L::STAGE;
    if (it >= kBwdStages)
      mbar_wait(stage_free(bars, st), (it / kBwdStages - 1) & 1);
    if (rows != nullptr) {
      const int r = r0 + (p & 63);
      rows[st * 2 * kBlockK + p] =
          r >= seq ? 0.f : p < 64 ? lse[r] * kLog2e : delta[r];
      named_bar_sync(1, 128);
    }
    if (p == 0) {
      mbar_expect_tx(stage_full(bars, st), L::STAGE);
      L::load(dst, str0, stage_full(bars, st), kBlockK, r0, bh);
      L::load(dst + L::STREAMED, str1, stage_full(bars, st), kBlockK, r0,
              bh);
    }
  }
}

__device__ __forceinline__ void bwd_init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(stage_full(bars, st), 1);
      mbar_init(stage_free(bars, st), 256);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// 2^x in one MUFU.EX2, denormal results flushed to zero: P = 2^x is at
// most 1 and is rounded to bf16 before its products, where exp2f's
// range handling (a few more instructions a score, and predicates that
// spilled at head_dim 128) buys nothing
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Turns of the dQ kernel's two consumer warpgroups at the tensor cores: a
// warpgroup issues a tile's S and dP only in its turn and then hands the
// turn to the other, so that one's softmax runs under the other's
// products. Named barriers 2 and 3 of all 256 consumer threads:
// warpgroup w syncs on 2 + w, the other arrives on it.
__device__ __forceinline__ void turn_take(int wg) {
  named_bar_sync(2 + wg, 256);
}
__device__ __forceinline__ void turn_give(int wg) {
  named_bar_arrive(3 - wg, 256);
}

// a thread's 32 f32 accumulators of an m64n64 product (S, dP, S^T or
// dP^T) packed to bf16 A fragments of the next product, columns 16 kk ..
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          bf16* __restrict__ dq, float* __restrict__ delta,
                          int seq, float scale, int causal) {
  using L = BwdTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms repeat every 1024 bytes: tiles start on that
  const uint32_t qs = (smem_addr(smem_raw) + 1023) & ~1023u;  // 128 queries
  const uint32_t dos = qs + L::OWN;
  const uint32_t ring = dos + L::OWN;   // key tile j: K, V in stage j % 3
  const uint32_t bars = ring + kBwdStages * L::STAGE;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * kBwdRows;
  const int key_tiles = (seq + kBlockK - 1) / kBlockK;
  const int n_k = causal ? min(2 * qt + 2, key_tiles) : key_tiles;
  const long long rows0 = static_cast<long long>(bh) * seq;

  bwd_init_bars(bars);
  if (wg == 2) {
    bwd_producer<D>(qs, &tm_q, &tm_do, q0, ring, &tm_k, &tm_v, 0, n_k, bars,
                    bh);
    return;
  }
  setmaxnreg_inc<240>();

  // this warpgroup's rows start at r0w; this thread's: r0w + row, + 8
  const int r0w = q0 + 64 * wg, row = 16 * warp + g;
  // delta = rowsum(dO O) in f32 from O and dO as stored, the 4 threads of
  // a quad (which hold the same rows) D / 4 columns each (D = 16: 2 of
  // them 8 each); LSE in log2 units
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    constexpr int kCols = D / 4 < 8 ? 8 : D / 4;
    const int r = r0w + row + 8 * i;
    float part = 0.f;
    if (r < seq && t * kCols < D) {
      const bf16* orow = o + (rows0 + r) * D + t * kCols;
      const bf16* drow = dout + (rows0 + r) * D + t * kCols;
#pragma unroll
      for (int c = 0; c < kCols; c += 8)
        part += dot8_bf16(*reinterpret_cast<const uint4*>(orow + c),
                          *reinterpret_cast<const uint4*>(drow + c));
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta_r[i] = part;
    if (t == 0 && r < seq) delta[rows0 + r] = part;
    lse_r[i] = r < seq ? lse[rows0 + r] * kLog2e : 0.f;
  }
  const float sl2 = scale * kLog2e;
  float acc[D / 2];                    // dQ, this thread's rows
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  // causal: the first warpgroup's rows see none of the CTA's last key
  // tile, which it leaves (no later tile needs that stage)
  const int j_end =
      causal && (n_k - 1) * kBlockK > r0w + 63 ? n_k - 1 : n_k;

  // dP = dO V^T and S = Q K^T of key tile j, this warpgroup's 64 rows x
  // 64 keys, into dp and s once the tile has landed; committed, not
  // waited for
  auto products = [&](int j, float (&s)[32], float (&dp)[32]) {
    const int st = j % kBwdStages;
    const uint32_t ks = ring + st * L::STAGE, vs = ks + L::STREAMED;
    mbar_wait(stage_full(bars, st), (j / kBwdStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, L::kmajor(dos, kBwdRows, 64 * wg, kk),
                   L::kmajor(vs, kBlockK, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, L::kmajor(qs, kBwdRows, 64 * wg, kk),
                   L::kmajor(ks, kBlockK, 0, kk), kk > 0);
    wgmma_commit();
  };
  // P and dS of tile j, in place in s
  auto softmax = [&](int j, float (&s)[32], const float (&dp)[32]) {
    const int k0 = j * kBlockK;
    const bool edge = (causal && k0 + kBlockK - 1 > r0w) ||
                      k0 + kBlockK > seq || r0w + 64 > seq;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float p = fast_exp2(fmaf(s[e], sl2, -lse_r[i]));
      if (edge && masked(r0w + row + 8 * i,
                         k0 + 8 * (e >> 2) + 2 * t + (e & 1), seq, causal))
        p = 0.f;
      s[e] = p * (dp[e] - delta_r[i]);           // dS
    }
  };
  // dQ += dS K of tile j, all D columns: K read MN-major
  auto add_dsk = [&](int j, const uint32_t (&ds)[4][4]) {
    const uint32_t ks = ring + (j % kBwdStages) * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D>(acc, ds[kk], L::mnmajor(ks, kBlockK, kk));
    wgmma_commit();
  };

  mbar_wait(bars, 0);                  // Q and dO have landed
  float s[32], dp[32];                 // S, dP of the tile in hand
  if (wg == 1) turn_give(wg);          // the first turn is warpgroup 0's
  if (j_end > 0) {
    turn_take(wg);
    products(0, s, dp);
    turn_give(wg);
    wgmma_wait<0>();
    fence_operands(dp);
    fence_operands(s);
  }
  for (int j = 0; j < j_end; ++j) {
    softmax(j, s, dp);                 // under dS K of tile j - 1
    wgmma_wait<0>();                   // dS K of tile j - 1
    fence_operands(acc);
    if (j > 0) mbar_arrive(stage_free(bars, (j - 1) % kBwdStages));
    uint32_t ds[4][4];                 // dS as A fragments, keys 16 kk ..
    pack_a(s, ds);
    // the products of tile j + 1 go to the tensor cores before dS K of
    // tile j, so that tile j + 1's P and dS are formed under dS K
    if (j + 1 < j_end) {
      turn_take(wg);
      products(j + 1, s, dp);
      turn_give(wg);
    }
    add_dsk(j, ds);
    wgmma_wait<1>();                   // S, dP of tile j + 1, if any
    fence_operands(dp);
    fence_operands(s);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  // the turn of the tile this warpgroup left, which the other takes
  for (int j = j_end; j < n_k; ++j) {
    turn_take(wg);
    turn_give(wg);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0w + row + 8 * i;
    if (r >= seq) continue;
    bf16* out = dq + (rows0 + r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(
          scale * acc[4 * n + 2 * i], scale * acc[4 * n + 2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int seq, float scale, int causal) {
  using L = BwdTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ks = (smem_addr(smem_raw) + 1023) & ~1023u;  // 128 keys
  const uint32_t vs = ks + L::OWN;
  const uint32_t ring = vs + L::OWN;   // query tile: Q, dO in a stage
  const uint32_t bars = ring + kBwdStages * L::STAGE;
  // stage st's LSE (log2 units) at rows + 128 st, its delta 64 on
  float* rows = reinterpret_cast<float*>(
      smem_raw + (bars + 64 - smem_addr(smem_raw)));
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y, k0 = kt * kBwdRows;   // causal: longest first
  const long long rows0 = static_cast<long long>(bh) * seq;
  // causal: query tiles wholly above the diagonal are skipped; query tile
  // it of the walk is q_first + it, in stage it % kBwdStages
  const int q_first = causal ? k0 / kBlockQ : 0;
  const int n_it = (seq + kBlockQ - 1) / kBlockQ - q_first;

  bwd_init_bars(bars);
  if (wg == 2) {
    bwd_producer<D>(ks, &tm_k, &tm_v, k0, ring, &tm_q, &tm_do,
                    q_first * kBlockQ, n_it, bars, bh, rows, lse + rows0,
                    delta + rows0, seq);
    return;
  }
  setmaxnreg_inc<240>();

  // this warpgroup's keys start at kw0; this thread's: kw0 + key, + 8
  const int kw0 = k0 + 64 * wg, key = 16 * warp + g;
  const float sl2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];  // this thread's key rows
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  mbar_wait(bars, 0);                  // K and V have landed

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kBwdStages;
    const int q0 = (q_first + it) * kBlockQ;
    if (causal && q0 + kBlockQ - 1 < kw0) {
      // these queries see none of this warpgroup's keys
      mbar_arrive(stage_free(bars, st));
      continue;
    }
    // the LSE and delta of the tile's queries, S^T's columns
    const float* lq = rows + st * 2 * kBlockQ;
    const float* dl = lq + kBlockQ;
    const uint32_t qs = ring + st * L::STAGE, dos = qs + L::STREAMED;
    const uint32_t ka = opaque(ks), va = opaque(vs);
    mbar_wait(stage_full(bars, st), (it / kBwdStages) & 1);  // Q, dO
    // dP^T = V dO^T, then S^T = K Q^T, this warpgroup's 64 keys x 64
    // queries
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, L::kmajor(va, kBwdRows, 64 * wg, kk),
                   L::kmajor(dos, kBlockQ, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, L::kmajor(ka, kBwdRows, 64 * wg, kk),
                   L::kmajor(qs, kBlockQ, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(dp);
    // dP^T - delta while S^T runs: columns 8 n + 2 t, + 1 (registers
    // 4 n + 0, 2 and 1, 3)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * t);
      dp[4 * n] -= d.x;
      dp[4 * n + 1] -= d.y;
      dp[4 * n + 2] -= d.x;
      dp[4 * n + 3] -= d.y;
    }
    wgmma_wait<0>();
    fence_operands(s);

    const bool edge = (causal && q0 < kw0 + 63) || q0 + kBlockQ > seq ||
                      kw0 + 64 > seq;
    uint32_t pf[4][4], dsf[4][4];      // A fragments, queries 16 kk ..
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk + h;
        const float2 l =
            *reinterpret_cast<const float2*>(lq + 8 * n + 2 * t);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 4 * n + r, c = 8 * n + 2 * t + (r & 1);
          float p = fast_exp2(fmaf(s[e], sl2, r & 1 ? -l.y : -l.x));
          if (edge && masked(q0 + c, kw0 + key + 8 * (r >> 1), seq, causal))
            p = 0.f;
          dp[e] *= p;                            // dS^T
          s[e] = p;                              // P^T
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        dsf[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }
    // dV += P^T dO and dK += dS^T Q, all D columns: dO, Q read MN-major
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D>(dv_acc, pf[kk], L::mnmajor(dos, kBlockQ, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D>(dk_acc, dsf[kk], L::mnmajor(qs, kBlockQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    mbar_arrive(stage_free(bars, st));   // Q, dO of this tile are read
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kw0 + key + 8 * i;
    if (c >= seq) continue;
    const long long at = (rows0 + c) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) = pack_bf16(
          scale * dk_acc[4 * n + 2 * i], scale * dk_acc[4 * n + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
          pack_bf16(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

// bf16 storage at head_dim 256: the wgmma kernels (the note at the top).

constexpr int kBwdWgThreads = 256;   // two warpgroups
constexpr int kDqRows = 128;         // query rows of a dQ CTA, 64 a warpgroup

// Shared-memory geometry of the head_dim-256 bf16 backward (bytes; the
// 64 x 256 tiles of flash_wgmma.cuh's Tile256): dQ's 128-row Q and dO
// tiles have blocks of 128 rows, and dK/dV's handoff tiles (P^T, dS^T)
// are one block of 64 x 64.
struct Bwd256Tiles : Tile256 {
  // dQ: 128 rows of Q and dO, two K slots and one V slot, seven
  // mbarriers and 128 f32 rows of delta; dK/dV: 64 rows of K and V, two
  // stages of Q and dO, the P^T and dS^T tiles, three mbarriers; both
  // with 1024 bytes to align the tiles
  static constexpr size_t kDqSmem = 7 * TILE + 64 + 512 + 1024;
  static constexpr size_t kDkvSmem = 6 * TILE + 2 * BLOCK + 64 + 1024;
};

__global__ void __launch_bounds__(kBwdWgThreads, 1)
    flash_dq_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const bf16* __restrict__ o,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             bf16* __restrict__ dq,
                             float* __restrict__ delta, int seq,
                             float scale, int causal) {
  using L = Bwd256Tiles;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;   // this CTA's 128 queries
  const uint32_t dos = qs + 2 * L::TILE;
  const uint32_t kslots = dos + 2 * L::TILE;   // K of tile j: slot j & 1
  const uint32_t vs = kslots + 2 * L::TILE;    // V of the tile in hand
  // mbarriers: +0 Q and dO; +8, +16 K slot full; +24 V full; +32, +40 K
  // slot free; +48 V free (every consumer thread arrives)
  const uint32_t bars = vs + L::TILE;
  float* delta_s = reinterpret_cast<float*>(smem_raw + (bars + 64 - raw));
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * kDqRows;
  const int key_tiles = (seq + kBlockK - 1) / kBlockK;
  const int n_k = causal ? min(2 * qt + 2, key_tiles) : key_tiles;
  const long long rows0 = static_cast<long long>(bh) * seq;

  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v, *mdo = &tm_do;
  auto load_k = [&](int j) {
    const uint32_t bar = bars + 8 + 8 * (j & 1);
    mbar_expect_tx(bar, L::TILE);
    tma_tile256(kslots + (j & 1) * L::TILE, mk, bar, j * kBlockK, bh,
                L::BLOCK);
  };
  auto load_v = [&](int j) {
    mbar_expect_tx(bars + 24, L::TILE);
    tma_tile256(vs, mv, bars + 24, j * kBlockK, bh, L::BLOCK);
  };
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i, 1);
    for (int i = 4; i < 7; ++i) mbar_init(bars + 8 * i, kBwdWgThreads);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 4 * L::TILE);
    tma_tile256(qs, mq, bars, q0, bh, 2 * L::BLOCK);
    tma_tile256(dos, mdo, bars, q0, bh, 2 * L::BLOCK);
    load_k(0);
    load_v(0);
    if (n_k > 1) load_k(1);
  }

  // delta = rowsum(dO O) in f32 from O and dO as stored: two threads a
  // row, 128 columns each
  {
    const int r = tid >> 1, gr = q0 + r, c0 = (tid & 1) * 128;
    float part = 0.f;
    if (gr < seq) {
      const bf16* orow = o + (rows0 + gr) * L::D + c0;
      const bf16* drow = dout + (rows0 + gr) * L::D + c0;
#pragma unroll 4
      for (int c = 0; c < 128; c += 8)
        part += dot8_bf16(*reinterpret_cast<const uint4*>(orow + c),
                          *reinterpret_cast<const uint4*>(drow + c));
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = part;
      if (gr < seq) delta[rows0 + gr] = part;
    }
  }
  __syncthreads();
  // this thread's rows: 64 wg + 16 warp + g and that + 8
  const int row = 64 * wg + 16 * warp + g;
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta_r[i] = delta_s[row + 8 * i];
    lse_r[i] = q0 + row + 8 * i < seq
                   ? lse[rows0 + q0 + row + 8 * i] * kLog2e : 0.f;
  }
  const float sl2 = scale * kLog2e;
  // this warpgroup's 64 rows of Q and dO: A of S = Q K^T, dP = dO V^T
  const uint32_t qa = qs + 64 * wg * L::RB, doa = dos + 64 * wg * L::RB;
  float acc[128];                      // dQ, all 256 columns
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  mbar_wait(bars, 0);                  // Q and dO have landed

  for (int j = 0; j < n_k; ++j) {
    const uint32_t ks = kslots + (j & 1) * L::TILE;
    mbar_wait(bars + 8 + 8 * (j & 1), (j >> 1) & 1);   // K of tile j
    mbar_wait(bars + 24, j & 1);                       // V of tile j
    float s[32], dp[32];               // S, dP: 64 rows x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss_n64(dp, kmajor256(doa, 0, kk, 2 * L::BLOCK),
                   kmajor256(vs, 0, kk, L::BLOCK), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss_n64(s, kmajor256(qa, 0, kk, 2 * L::BLOCK),
                   kmajor256(ks, 0, kk, L::BLOCK), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(dp);
    mbar_arrive(bars + 48);            // V of tile j is read
    if (tid == 0 && j + 1 < n_k) {
      mbar_wait(bars + 48, j & 1);
      load_v(j + 1);
    }
    wgmma_wait<0>();
    fence_operands(s);

    const int k0 = j * kBlockK;
    const bool edge = (causal && j >= 2 * qt) || k0 + kBlockK > seq ||
                      q0 + kDqRows > seq;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float p = exp2f(fmaf(s[e], sl2, -lse_r[i]));
      if (edge && masked(q0 + row + 8 * i,
                         k0 + 8 * (e >> 2) + 2 * t + (e & 1), seq, causal))
        p = 0.f;
      s[e] = p * (dp[e] - delta_r[i]);           // dS
    }
    uint32_t ds[4][4];                 // dS as A fragments, keys 16 kk ..
    pack_a(s, ds);
    // dQ += dS K, all 256 columns: K read MN-major
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<256>(acc, ds[kk],
                       wgmma_desc(ks + kk * 16 * L::RB, L::BLOCK, L::SBO,
                                  L::RB));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(bars + 32 + 8 * (j & 1));   // K of tile j is read
    if (tid == 0 && j + 2 < n_k) {
      mbar_wait(bars + 32 + 8 * (j & 1), (j >> 1) & 1);
      load_k(j + 2);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row + 8 * i;
    if (r >= seq) continue;
    bf16* out = dq + (rows0 + r) * L::D + 2 * t;
#pragma unroll
    for (int n = 0; n < 32; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(
          scale * acc[4 * n + 2 * i], scale * acc[4 * n + 2 * i + 1]);
  }
}

__global__ void __launch_bounds__(kBwdWgThreads, 1)
    flash_dkv_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int seq, float scale, int causal) {
  using L = Bwd256Tiles;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ks = (smem_addr(smem_raw) + 1023) & ~1023u;   // 64 keys
  const uint32_t vs = ks + L::TILE;
  const uint32_t qd = vs + L::TILE;   // stage st: Q at qd + 2 st TILE, dO after
  const uint32_t pts = qd + 4 * L::TILE;   // P^T, 64 keys x 64 queries
  const uint32_t dsts = pts + L::BLOCK;    // dS^T
  const uint32_t bars = dsts + L::BLOCK;   // K and V, then each stage
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y, k0 = kt * kBlockK;   // causal: longest first
  const long long rows0 = static_cast<long long>(bh) * seq;
  // causal: query tiles wholly above the diagonal are skipped
  const int n_q = gridDim.y, q_first = causal ? kt : 0;

  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v, *mdo = &tm_do;
  auto load_queries = [&](int it, int qt) {
    const uint32_t bar = bars + 8 + 8 * (it & 1);
    const uint32_t dst = qd + (it & 1) * 2 * L::TILE;
    mbar_expect_tx(bar, 2 * L::TILE);
    tma_tile256(dst, mq, bar, qt * kBlockQ, bh, L::BLOCK);
    tma_tile256(dst + L::TILE, mdo, bar, qt * kBlockQ, bh, L::BLOCK);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * L::TILE);
    tma_tile256(ks, mk, bars, k0, bh, L::BLOCK);
    tma_tile256(vs, mv, bars, k0, bh, L::BLOCK);
    for (int it = 0; it < 2 && q_first + it < n_q; ++it)
      load_queries(it, q_first + it);
  }
  const float sl2 = scale * kLog2e;
  // dK, dV: columns 128 wg .. 128 wg + 127 of this thread's key rows
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  mbar_wait(bars, 0);                  // K and V have landed

  for (int qt = q_first; qt < n_q; ++qt) {
    const int it = qt - q_first;
    const uint32_t qs = qd + (it & 1) * 2 * L::TILE, dos = qs + L::TILE;
    const int q0 = qt * kBlockQ;
    // LSE and delta of this thread's 8 query columns, 32 wg + 8 n + 2 t
    // + b: read here, used after the products
    float lq[8], dl[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int r = q0 + 32 * wg + 8 * (c >> 1) + 2 * t + (c & 1);
      lq[c] = r < seq ? lse[rows0 + r] * kLog2e : 0.f;
      dl[c] = r < seq ? delta[rows0 + r] : 0.f;
    }
    mbar_wait(bars + 8 + 8 * (it & 1), (it >> 1) & 1);   // Q, dO of tile qt
    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 32 queries
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss_n32(s, kmajor256(ks, 0, kk, L::BLOCK),
                   kmajor256(qs, 32 * wg, kk, L::BLOCK), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss_n32(dp, kmajor256(vs, 0, kk, L::BLOCK),
                   kmajor256(dos, 32 * wg, kk, L::BLOCK), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);

    const bool edge = (causal && qt == kt) || q0 + kBlockQ > seq ||
                      k0 + kBlockK > seq;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int c = 2 * (e >> 2) + (e & 1);      // the column's lq, dl
      const int key = warp * 16 + g + 8 * ((e >> 1) & 1);
      float p = exp2f(fmaf(s[e], sl2, -lq[c]));
      if (edge && masked(q0 + 32 * wg + 8 * (e >> 2) + 2 * t + (e & 1),
                         k0 + key, seq, causal))
        p = 0.f;
      dp[e] = p * (dp[e] - dl[c]);               // dS^T
      s[e] = p;                                  // P^T
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t at =
            swz128(warp * 16 + g + 8 * i, 32 * wg + 8 * n + 2 * t);
        st_shared_b32(pts + at,
                      pack_bf16(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
        st_shared_b32(dsts + at,
                      pack_bf16(dp[4 * n + 2 * i], dp[4 * n + 2 * i + 1]));
      }
    fence_proxy_async();
    __syncthreads();                   // P^T, dS^T of all 64 queries
    // dV += P^T dO and dK += dS^T Q, this warpgroup's 128 columns
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tb_n128(dv_acc, wgmma_desc(pts + kk * 32, 16, L::SBO, L::RB),
                       mnmajor256(dos, wg, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tb_n128(dk_acc, wgmma_desc(dsts + kk * 32, 16, L::SBO, L::RB),
                       mnmajor256(qs, wg, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    __syncthreads();                   // this stage, P^T and dS^T are free
    if (tid == 0 && qt + 2 < n_q) load_queries(it + 2, qt + 2);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + warp * 16 + g + 8 * i;
    if (c >= seq) continue;
    const long long at = (rows0 + c) * L::D + 128 * wg + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) = pack_bf16(
          scale * dk_acc[4 * n + 2 * i], scale * dk_acc[4 * n + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
          pack_bf16(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

// f32 storage at head_dim 16 and 32: split TF32 on mma.sync (the note at
// the top).

// Tiles of the f32 mma.sync backward kernels at head_dim D (floats): the
// CTA's own 64 rows, and streamed tiles of 64 rows through two stages
template <int D>
struct Tf32BwdTiles {
  static_assert(D <= 32, "f32 head_dim 64 and up runs the wgmma kernels");
  static constexpr int ST = 64;                    // rows a streamed tile
  static constexpr int STAGES = 2;                 // streamed tiles in flight
  static constexpr int LD = D + 4;                 // row stride
  static constexpr int TILE = kBlockQ * LD;        // the CTA's own rows
  static constexpr int STILE = ST * LD;            // a streamed tile
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * TILE + STAGES * 2 * STILE);
  static constexpr size_t kDkvSmem =
      sizeof(float) * (2 * TILE + STAGES * (2 * STILE + 2 * ST));
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta,
                         int seq, float scale, int causal) {
  using L = Tf32BwdTiles<D>;
  constexpr int LD = L::LD, KT = L::ST, NT = KT / 8, NO = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;                    // this CTA's 64 queries
  float* dos = qs + L::TILE;
  float* kvs = dos + L::TILE;   // stage st: K at kvs + 2 st STILE, V after
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * kBlockQ;
  const long long base = static_cast<long long>(blockIdx.x) * seq * D;
  q += base;
  k += base;
  v += base;
  o += base;
  dout += base;
  dq += base;
  lse += static_cast<long long>(blockIdx.x) * seq;
  delta += static_cast<long long>(blockIdx.x) * seq;
  const int tiles = (seq + KT - 1) / KT;
  const int n_k = causal ? min(tiles, (q0 + kBlockQ) / KT) : tiles;

  auto load_kv = [&](int j) {
    float* dst = kvs + (j % L::STAGES) * 2 * L::STILE;
    cp_async_f32<KT, D, LD>(dst, k, D, j * KT, 0, seq);
    cp_async_f32<KT, D, LD>(dst + L::STILE, v, D, j * KT, 0, seq);
  };
  cp_async_f32<kBlockQ, D, LD>(qs, q, D, q0, 0, seq);
  cp_async_f32<kBlockQ, D, LD>(dos, dout, D, q0, 0, seq);
  cp_async_commit();
  for (int j = 0; j < L::STAGES - 1; ++j) {
    if (j < n_k) load_kv(j);
    cp_async_commit();
  }
  cp_async_wait<L::STAGES - 1>();      // Q and dO have landed
  __syncthreads();

  // delta of row w0 + lane / 2, two lanes a row, half the row each
  float dl;
  {
    const int rl = w0 + (lane >> 1), r = q0 + rl, c0 = (lane & 1) * (D / 2);
    float part = 0.f;
    if (r < seq) {
#pragma unroll
      for (int c = c0; c < c0 + D / 2; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(
            o + static_cast<long long>(r) * D + c);
        const float4 y = *reinterpret_cast<const float4*>(dos + rl * LD + c);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
      }
    }
    dl = part + __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && r < seq) delta[r] = dl;
  }
  // this thread's rows of the score tiles: w0 + g and w0 + g + 8
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta_r[i] = __shfl_sync(0xffffffffu, dl, 2 * g + 16 * i);
    const int r = q0 + w0 + g + 8 * i;
    lse_r[i] = r < seq ? lse[r] : 0.f;
  }
  float acc[NO][4] = {};               // dQ, rows w0 .. w0 + 15

  for (int j = 0; j < n_k; ++j) {
    if (j + L::STAGES - 1 < n_k) load_kv(j + L::STAGES - 1);
    cp_async_commit();
    cp_async_wait<L::STAGES - 1>();    // tile j has landed
    __syncthreads();
    const float* ks = kvs + (j % L::STAGES) * 2 * L::STILE;
    const float* vs = ks + L::STILE;
    float s[NT][4], dp[NT][4];         // S, dP: 16 rows x KT keys
    dot_tiles<LD, D / 8>(s, qs, w0, ks, 0, g, t);
    dot_tiles<LD, D / 8>(dp, dos, w0, vs, 0, g, t);
    const int k0 = j * KT;
    const bool edge = (causal && k0 + KT > q0 + 1) || k0 + KT > seq ||
                      q0 + kBlockQ > seq;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = expf(fmaf(s[n][e], scale, -lse_r[i]));
        if (edge && masked(q0 + w0 + g + 8 * i, k0 + n * 8 + 2 * t + (e & 1),
                           seq, causal))
          p = 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[i]);    // dS
      }
    }
    uint32_t dsh[NT][4], dsl[NT][4];   // dQ += dS K
    split_c_tiles(dsh, dsl, s);
    mul_tiles<LD>(acc, dsh, dsl, ks, 0, 0, g, t);
    __syncthreads();                   // tile j's stage is free
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + w0 + g + 8 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dq + static_cast<long long>(r) * D + n * 8 +
                                 2 * t) =
          make_float2(scale * acc[n][2 * i], scale * acc[n][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int seq, float scale, int causal) {
  using L = Tf32BwdTiles<D>;
  constexpr int LD = L::LD, QT = L::ST, NS = QT / 8, NO = D / 8;
  extern __shared__ float smem[];
  float* ks = smem;                    // this CTA's 64 keys
  float* vs = ks + L::TILE;
  float* qds = vs + L::TILE;   // stage st: Q at qds + 2 st STILE, dO after
  float* rows = qds + L::STAGES * 2 * L::STILE;   // stage st: LSE at rows +
                                                  // 2 st QT, delta after
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.y, k0 = kt * kBlockK;   // causal: longest first
  const long long base = static_cast<long long>(blockIdx.x) * seq * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  lse += static_cast<long long>(blockIdx.x) * seq;
  delta += static_cast<long long>(blockIdx.x) * seq;
  // causal: query tiles wholly above the diagonal are skipped
  const int n_q = (seq + QT - 1) / QT, q_first = causal ? k0 / QT : 0;

  auto load_queries = [&](int stage, int qt) {
    float* dst = qds + stage * 2 * L::STILE;
    cp_async_f32<QT, D, LD>(dst, q, D, qt * QT, 0, seq);
    cp_async_f32<QT, D, LD>(dst + L::STILE, dout, D, qt * QT, 0, seq);
    cp_async_vec<QT>(rows + stage * 2 * QT, lse, qt * QT, seq);
    cp_async_vec<QT>(rows + stage * 2 * QT + QT, delta, qt * QT, seq);
  };
  cp_async_f32<kBlockK, D, LD>(ks, k, D, k0, 0, seq);
  cp_async_f32<kBlockK, D, LD>(vs, v, D, k0, 0, seq);
  for (int j = 0; j < L::STAGES - 1; ++j) {   // K, V land with tile 0
    if (q_first + j < n_q) load_queries(j, q_first + j);
    cp_async_commit();
  }
  float dk_acc[NO][4] = {}, dv_acc[NO][4] = {};   // rows w0 .. w0 + 15

  for (int qt = q_first; qt < n_q; ++qt) {
    const int it = qt - q_first;
    if (qt + L::STAGES - 1 < n_q)
      load_queries((it + L::STAGES - 1) % L::STAGES, qt + L::STAGES - 1);
    cp_async_commit();
    cp_async_wait<L::STAGES - 1>();    // tile qt has landed
    __syncthreads();
    const int stage = it % L::STAGES;
    const float* qs = qds + stage * 2 * L::STILE;
    const float* dos = qs + L::STILE;
    const float* lse_s = rows + stage * 2 * QT;
    const float* delta_s = lse_s + QT;
    const int qb0 = qt * QT;
    const bool edge = (causal && qb0 < k0 + kBlockK - 1) || qb0 + QT > seq ||
                      k0 + kBlockK > seq;
    // a warp whose keys this query tile does not see skips it
    if (!(causal && qb0 + QT - 1 < k0 + w0)) {
      float s[NS][4], dp[NS][4];         // S^T, dP^T: 16 keys x QT queries
      dot_tiles<LD, D / 8>(s, ks, w0, qs, 0, g, t);
      dot_tiles<LD, D / 8>(dp, vs, w0, dos, 0, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);   // query in tile
          float p = expf(fmaf(s[n][e], scale, -lse_s[c]));
          if (edge && masked(qb0 + c, k0 + w0 + g + 8 * (e >> 1), seq, causal))
            p = 0.f;
          dp[n][e] = p * (dp[n][e] - delta_s[c]);   // dS^T
          s[n][e] = p;                               // P^T
        }
      }
      uint32_t ph[NS][4], pl[NS][4], dh[NS][4], dl[NS][4];
      split_c_tiles(ph, pl, s);          // dV += P^T dO
      mul_tiles<LD>(dv_acc, ph, pl, dos, 0, 0, g, t);
      split_c_tiles(dh, dl, dp);         // dK += dS^T Q
      mul_tiles<LD>(dk_acc, dh, dl, qs, 0, 0, g, t);
    }
    __syncthreads();                   // tile qt's stage is free
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + w0 + g + 8 * i;
    if (c >= seq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long long at = static_cast<long long>(c) * D + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(scale * dk_acc[n][2 * i], scale * dk_acc[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + at) =
          make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// f32 storage at head_dim 64 and 128: split TF32 on wgmma (the note at the
// top).

constexpr int kTf32Queries = 32;   // dK/dV's streamed query tile

// Shared-memory geometry of the f32 wgmma backward (bytes): an f32 tile of
// R rows x D columns is D / 32 column blocks of R rows x 128 bytes in the
// 128-byte swizzle that TMA writes and wgmma reads (f32_at; the tiles'
// helpers, shared with the forward, are in flash_tf32.cuh).
template <int D>
struct Tf32WgTiles {
  static_assert(D == 64 || D == 128, "the f32 wgmma kernels: D 64, 128");
  static constexpr int TILE = 64 * D * 4;              // 64 rows
  static constexpr int QTILE = kTf32Queries * D * 4;   // a dK/dV query tile
  static constexpr int HAND = 64 * 64 * 4;   // dQ's dS^T: 64 x 64
  static constexpr int PT = 64 * kTf32Queries * 4;   // dK/dV's P^T or dS^T
  // dQ: Q, its lo, dO, its lo, K, V, dS^T hi and lo; LSE and delta of the
  // 64 queries; six mbarriers; 1024 bytes to align the tiles
  static constexpr size_t kDqSmem = 6 * TILE + 2 * HAND + 512 + 64 + 1024;
  // dK/dV: K, V; two stages of Q, its lo, dO, its lo; P^T and dS^T hi and
  // lo; seven mbarriers; 1024 to align
  static constexpr size_t kDkvSmem = 2 * TILE + 2 * 4 * QTILE + 4 * PT + 64 +
                                     1024;
};

__device__ __forceinline__ float f32_ld(const unsigned char* tile, int rows,
                                        int r, int c) {
  return *reinterpret_cast<const float*>(tile + f32_at(rows, r, c));
}

// The split A fragment of k-step kk for this warp's 16 rows m0 .. of an
// operand stored [k][m] in an f32 tile of `rows` rows (the transpose of
// what frag_mk, flash_tf32.cuh, reads: K^T, Q^T, dO^T), by scalar loads
__device__ __forceinline__ void frag_km(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const unsigned char* tile, int rows,
                                        int m0, int kk, int g, int t) {
  const int r = 8 * kk + t, c = m0 + g;
  const float x[4] = {f32_ld(tile, rows, r, c), f32_ld(tile, rows, r, c + 8),
                      f32_ld(tile, rows, r + 4, c),
                      f32_ld(tile, rows, r + 4, c + 8)};
  split_tf32(x, hi, lo);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ o,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               float* __restrict__ dq,
                               float* __restrict__ delta, int seq,
                               float scale, int causal) {
  using L = Tf32WgTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;   // the CTA's 64 queries
  const uint32_t qlo = qs + L::TILE, dos = qlo + L::TILE;
  const uint32_t dolo = dos + L::TILE;
  const uint32_t ks = dolo + L::TILE, vs = ks + L::TILE;   // key tile j
  // dS^T [query][key] hi and lo; P^T, handed from warpgroup 0 to 1, is
  // written where its dS^T hi goes
  const uint32_t dsh = vs + L::TILE, dsl = dsh + L::HAND;
  const uint32_t rows_at = dsl + L::HAND;      // LSE, then delta: 64 each
  // mbarriers: +0 Q and dO landed; +8 their lo parts written; +16 K full,
  // +24 V full; +32 K free (both warpgroups arrive), +40 V free
  // (warpgroup 1)
  const uint32_t bars = rows_at + 512;
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };
  float* lse_s = reinterpret_cast<float*>(at(rows_at));
  float* delta_s = lse_s + 64;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * 64;
  const int key_tiles = (seq + 63) / 64;
  const int n_k = causal ? min(qt + 1, key_tiles) : key_tiles;
  const long long rows0 = static_cast<long long>(bh) * seq;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 96);
    mbar_init(bars + 16, 1);
    mbar_init(bars + 24, 1);
    mbar_init(bars + 32, 256);
    mbar_init(bars + 40, 128);
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 2) {
    // the producer: one thread loads Q and dO, then V and K of each key
    // tile once the tile before is read; warps 1-3 write the lo parts of
    // Q and dO
    setmaxnreg_dec<24>();
    const int p = tid - 256;
    if (p == 0) {
      mbar_expect_tx(bars, 2 * L::TILE);
      f32_load<D>(qs, &tm_q, bars, 64, q0, bh);
      f32_load<D>(dos, &tm_do, bars, 64, q0, bh);
      for (int j = 0; j < n_k; ++j) {
        if (j > 0) mbar_wait(bars + 40, (j - 1) & 1);
        mbar_expect_tx(bars + 24, L::TILE);
        f32_load<D>(vs, &tm_v, bars + 24, 64, j * 64, bh);
        if (j > 0) mbar_wait(bars + 32, (j - 1) & 1);
        mbar_expect_tx(bars + 16, L::TILE);
        f32_load<D>(ks, &tm_k, bars + 16, 64, j * 64, bh);
      }
    } else if (p >= 32) {
      mbar_wait(bars, 0);
      split_lo(at(qlo), at(qs), L::TILE, p - 32, 96);
      split_lo(at(dolo), at(dos), L::TILE, p - 32, 96);
      fence_proxy_async();
      mbar_arrive(bars + 8);
    }
    return;
  }
  setmaxnreg_inc<240>();

  // delta = rowsum(dO O) of the 64 queries in f32 from O and dO as stored,
  // 4 threads a row (D / 4 columns each, added by two shuffles); LSE
  {
    const int r = tid >> 2, gr = q0 + r, c0 = (tid & 3) * (D / 4);
    float part = 0.f;
    if (gr < seq) {
      const float* orow = o + (rows0 + gr) * D + c0;
      const float* drow = dout + (rows0 + gr) * D + c0;
#pragma unroll
      for (int c = 0; c < D / 4; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if ((tid & 3) == 0) {
      delta_s[r] = part;
      if (gr < seq) delta[rows0 + gr] = part;
    } else if ((tid & 3) == 1) {
      lse_s[r] = gr < seq ? lse[rows0 + gr] : 0.f;
    }
  }
  named_bar_sync(1, 256);
  // warpgroup 0 builds S^T = K Q^T, warpgroup 1 dP^T = V dO^T, each for 64
  // keys x all 64 queries: register 4 n + b (+ 2) is query 8 n + 2 t + b,
  // whose LSE (warpgroup 0) or delta (1) this thread holds
  float rq[16];
#pragma unroll
  for (int c = 0; c < 16; ++c)
    rq[c] = (wg == 0 ? lse_s : delta_s)[8 * (c >> 1) + 2 * t + (c & 1)];
  // dQ^T = K^T dS^T: a warpgroup owns 64 of its rows (d) at D = 128, all
  // 64 at D = 64 (split by its 32 queries)
  constexpr int QN = D == 128 ? 64 : 32;
  const int m0 = D == 128 ? 64 * wg : 0, n0 = D == 128 ? 0 : 32 * wg;
  float run[QN / 2], chunk[QN / 2];
#pragma unroll
  for (int e = 0; e < QN / 2; ++e) run[e] = 0.f;
  const unsigned char* kp = at(ks);
  const unsigned char* own = at(wg == 0 ? ks : vs);
  unsigned char *hp = at(dsh), *lp = at(dsl);
  const uint32_t first = wg == 0 ? qs : dos;   // B of S^T or dP^T
  mbar_wait(bars + 8, 0);              // Q, dO and their lo parts

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * 64;
    float x[32];                       // S^T or dP^T, then P^T or dS^T
    mbar_wait(bars + (wg == 0 ? 16 : 24), j & 1);   // K or V of tile j
    product_3xtf32<64, D / 8>(
        x,
        [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          frag_mk(hi, lo, own, 64, 16 * warp, kk, g, t);
        },
        [&](int kk, bool low) {
          return f32_kmajor(first + (low ? L::TILE : 0), 64, 0, kk);
        });
    if (wg == 1) mbar_arrive(bars + 40);   // V is read (into fragments)
    // K^T's fragments for dQ^T, gathered now: K is free for tile j + 1
    uint32_t kth[8][4], ktl[8][4];
    if (wg == 1) mbar_wait(bars + 16, j & 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      frag_km(kth[kk], ktl[kk], kp, 64, m0 + 16 * warp, kk, g, t);
    mbar_arrive(bars + 32);            // K is read
    wgmma_wait<0>();
    fence_operands(x);
    if (wg == 0) {
      const bool edge = (causal && k0 + 63 > q0) || k0 + 64 > seq ||
                        q0 + 64 > seq;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float p = expf(fmaf(x[e], scale, -rq[2 * (e >> 2) + (e & 1)]));
        if (edge && masked(q0 + 8 * (e >> 2) + 2 * t + (e & 1),
                           k0 + 16 * warp + g + 8 * ((e >> 1) & 1), seq,
                           causal))
          p = 0.f;
        x[e] = p;                      // P^T
      }
      // warpgroup 1's dQ^T of tile j - 1 has read the handoff (this
      // warpgroup's was waited for)
      if (j > 0) named_bar_sync(3, 256);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        *reinterpret_cast<float*>(
            hp + f32_at(64, 8 * (e >> 2) + 2 * t + (e & 1),
                        16 * warp + g + 8 * ((e >> 1) & 1))) = x[e];
      named_bar_arrive(2, 256);        // P^T for warpgroup 1
    } else {
      named_bar_sync(2, 256);          // P^T of tile j
      uint32_t hi[32], lo[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const uint32_t a = f32_at(64, 8 * (e >> 2) + 2 * t + (e & 1),
                                  16 * warp + g + 8 * ((e >> 1) & 1));
        x[e] = *reinterpret_cast<const float*>(hp + a) *
               (x[e] - rq[2 * (e >> 2) + (e & 1)]);   // dS^T
      }
      split_tf32(x, hi, lo);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const uint32_t a = f32_at(64, 8 * (e >> 2) + 2 * t + (e & 1),
                                  16 * warp + g + 8 * ((e >> 1) & 1));
        *reinterpret_cast<uint32_t*>(hp + a) = hi[e];
        *reinterpret_cast<uint32_t*>(lp + a) = lo[e];
      }
      fence_proxy_async();
    }
    named_bar_sync(4, 256);            // dS^T of tile j is whole
    // dQ^T += K^T dS^T over the tile's 64 keys: one tensor-core sum a
    // tile, added in f32
    product_3xtf32<QN, 8>(
        chunk,
        [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hi[i] = kth[kk][i];
            lo[i] = ktl[kk][i];
          }
        },
        [&](int kk, bool low) {
          return f32_kmajor(low ? dsl : dsh, 64, n0, kk);
        });
    wgmma_wait<0>();
    fence_operands(chunk);
#pragma unroll
    for (int e = 0; e < QN / 2; ++e) run[e] += chunk[e];
    if (wg == 1 && j + 1 < n_k) named_bar_arrive(3, 256);
  }

#pragma unroll
  for (int e = 0; e < QN / 2; ++e) {
    const int r = q0 + n0 + 8 * (e >> 2) + 2 * t + (e & 1);
    if (r < seq)
      dq[(rows0 + r) * D + m0 + 16 * warp + g + 8 * ((e >> 1) & 1)] =
          scale * run[e];
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int seq, float scale, int causal) {
  using L = Tf32WgTiles<D>;
  constexpr int QT = kTf32Queries, MB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;   // the CTA's 64 keys
  const uint32_t vs = ks + L::TILE;
  // stage st: Q, its lo, dO, its lo of a query tile, from stage(st)
  const uint32_t stages = vs + L::TILE;
  auto stage = [&](int st) { return stages + st * 4 * L::QTILE; };
  const uint32_t ph = stages + 2 * 4 * L::QTILE, pl = ph + L::PT;   // P^T
  const uint32_t dsh = pl + L::PT, dsl = dsh + L::PT;               // dS^T
  // mbarriers: +0 K and V landed; +8, +16 stage full; +24, +32 stage
  // ready (its lo parts written); +40, +48 stage free
  const uint32_t bars = dsl + L::PT;
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * 64;      // causal: key tile 0 walks the most
  const long long rows0 = static_cast<long long>(bh) * seq;
  // causal: query tiles wholly above the diagonal are skipped
  const int q_first = causal ? k0 / QT : 0;
  const int n_it = (seq + QT - 1) / QT - q_first;

  if (tid == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bars + 8 + 8 * st, 1);
      mbar_init(bars + 24 + 8 * st, 96);
      mbar_init(bars + 40 + 8 * st, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 2) {
    // the producer: one thread loads K and V, then each query tile's Q
    // and dO into stage it % 2 once the tile before there is read; warps
    // 1-3 write each tile's lo parts
    setmaxnreg_dec<24>();
    const int p = tid - 256;
    auto load = [&](int it) {
      const int st = it & 1, qb = (q_first + it) * QT;
      const uint32_t full = bars + 8 + 8 * st, dst = stage(st);
      mbar_expect_tx(full, 2 * L::QTILE);
      f32_load<D>(dst, &tm_q, full, QT, qb, bh);
      f32_load<D>(dst + 2 * L::QTILE, &tm_do, full, QT, qb, bh);
    };
    if (p == 0) {
      mbar_expect_tx(bars, 2 * L::TILE);
      f32_load<D>(ks, &tm_k, bars, 64, k0, bh);
      f32_load<D>(vs, &tm_v, bars, 64, k0, bh);
      for (int it = 0; it < n_it; ++it) {
        if (it >= 2) mbar_wait(bars + 40 + 8 * (it & 1), ((it - 2) >> 1) & 1);
        load(it);
      }
    } else if (p >= 32) {
      const int i = p - 32;
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1;
        const uint32_t src = stage(st);
        mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);
        split_lo(at(src + L::QTILE), at(src), L::QTILE, i, 96);
        split_lo(at(src + 3 * L::QTILE), at(src + 2 * L::QTILE), L::QTILE, i,
                 96);
        fence_proxy_async();
        mbar_arrive(bars + 24 + 8 * st);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // warpgroup 0 builds S^T = K Q^T, P^T, and dV^T += dO^T P; warpgroup 1
  // dP^T = V dO^T, dS^T from warpgroup 0's P^T, and dK^T += Q^T dS. Both
  // own all D rows of their output (MB blocks of 64) and the 64 keys.
  float run[MB][32], chunk[32];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int e = 0; e < 32; ++e) run[mb][e] = 0.f;
  const unsigned char* own = at(wg == 0 ? ks : vs);
  unsigned char *php = at(ph), *plp = at(pl), *dshp = at(dsh), *dslp = at(dsl);
  mbar_wait(bars, 0);                  // K and V have landed

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, qb0 = (q_first + it) * QT;
    // this warpgroup's streamed operand of the first product: Q for S^T,
    // dO for dP^T (its lo 1 tile on), and of the second: dO^T, Q^T
    const uint32_t first = stage(st) + (wg == 0 ? 0 : 2 * L::QTILE);
    const uint32_t second = stage(st) + (wg == 0 ? 2 * L::QTILE : 0);
    // the LSE (warpgroup 0) or delta (1) of this thread's 8 queries, qb0 +
    // 8 n + 2 t + b for registers 4 n + b (+ 2); read under the product
    float rq[8];
    {
      const float* rows = (wg == 0 ? lse : delta) + rows0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int r = qb0 + 8 * (c >> 1) + 2 * t + (c & 1);
        rq[c] = r < seq ? rows[r] : 0.f;
      }
    }
    mbar_wait(bars + 24 + 8 * st, (it >> 1) & 1);   // the stage is ready
    float x[16];                       // S^T or dP^T: 64 keys x 32 queries
    product_3xtf32<32, D / 8>(
        x,
        [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          frag_mk(hi, lo, own, 64, 16 * warp, kk, g, t);
        },
        [&](int kk, bool low) {
          return f32_kmajor(first + (low ? L::QTILE : 0), QT, 0, kk);
        });
    wgmma_wait<0>();
    fence_operands(x);
    const bool edge = (causal && qb0 < k0 + 63) || qb0 + QT > seq ||
                      k0 + 64 > seq;
    // this thread's keys 16 warp + g (+ 8) and queries 8 n + 2 t (+ 1):
    // registers 4 n + 0, 1 (2, 3), written and read as float2
    uint32_t hand;                     // the handoff tile of this product
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        float p = expf(fmaf(x[e], scale, -rq[2 * (e >> 2) + (e & 1)]));
        if (edge && masked(qb0 + 8 * (e >> 2) + 2 * t + (e & 1),
                           k0 + 16 * warp + g + 8 * ((e >> 1) & 1), seq,
                           causal))
          p = 0.f;
        x[e] = p;                      // P^T
      }
      if (it > 0) named_bar_sync(4, 256);   // warpgroup 1 has read P^T
      hand = ph;
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] -= rq[2 * (e >> 2) + (e & 1)];
      named_bar_sync(5, 256);          // P^T of this tile
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const uint32_t a = f32_at(64, 16 * warp + g + 8 * ((e >> 1) & 1),
                                  8 * (e >> 2) + 2 * t);
        const float2 h = *reinterpret_cast<const float2*>(php + a);
        const float2 l = *reinterpret_cast<const float2*>(plp + a);
        x[e] *= h.x + l.x;             // dS^T = P^T (dP^T - delta)
        x[e + 1] *= h.y + l.y;
      }
      if (it + 1 < n_it) named_bar_arrive(4, 256);
      hand = dsh;
    }
    {
      unsigned char *hp = wg == 0 ? php : dshp, *lp = wg == 0 ? plp : dslp;
      uint32_t hi[16], lo[16];
      split_tf32(x, hi, lo);
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const uint32_t a = f32_at(64, 16 * warp + g + 8 * ((e >> 1) & 1),
                                  8 * (e >> 2) + 2 * t);
        *reinterpret_cast<uint2*>(hp + a) = make_uint2(hi[e], hi[e + 1]);
        *reinterpret_cast<uint2*>(lp + a) = make_uint2(lo[e], lo[e + 1]);
      }
    }
    fence_proxy_async();
    named_bar_sync(6 + wg, 128);       // this warpgroup's handoff is whole
    if (wg == 0) named_bar_arrive(5, 256);   // P^T for warpgroup 1
    // dV^T += dO^T P (warpgroup 0), dK^T += Q^T dS (1): one tensor-core
    // sum a query tile for each 64-row block of D, added in f32 before
    // the next block's (one set of chunk registers)
    const unsigned char* sp = at(second);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      product_3xtf32<64, QT / 8>(
          chunk,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
            frag_km(hi, lo, sp, QT, 64 * mb + 16 * warp, kk, g, t);
          },
          [&](int kk, bool low) {
            return f32_kmajor(hand + (low ? L::PT : 0), 64, 0, kk);
          });
      if (mb == MB - 1) mbar_arrive(bars + 40 + 8 * st);   // stage read
      wgmma_wait<0>();
      fence_operands(chunk);
#pragma unroll
      for (int e = 0; e < 32; ++e) run[mb][e] += chunk[e];
    }
  }

  float* out = wg == 0 ? dv : dk;
  const float f = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      if (key < seq)
        out[(rows0 + key) * D + 64 * mb + 16 * warp + g + 8 * ((e >> 1) & 1)] =
            f * run[mb][e];
    }
}

// f32 storage at head_dim 256 (and 129-255, zero-padded): split TF32 on
// wgmma in clusters of two CTAs (the note at the top).

constexpr int kTf32DqQueries = 32;   // a head_dim-256 dQ cluster's queries

// Shared-memory geometry of the f32 head_dim-256 backward (bytes): a
// rank's tiles are those of the head_dim-128 kernels over its 128 columns
// (f32_at), and the exchange buffers hold 8 f32 of each of a warpgroup's
// 128 threads, 16 bytes a slot, thread w's slots at w and 128 + w.
struct Tf32ClusterTiles {
  static constexpr int W = 128;                  // columns of a rank
  static constexpr int QTILE = 32 * W * 4;       // 32 rows: a query tile
  static constexpr int KTILE = 64 * W * 4;       // 64 rows: a key tile
  static constexpr int HAND = 64 * 32 * 4;       // a 64 x 32 handoff
  static constexpr int XCH = 2 * 128 * 16;       // an exchange buffer
  // dQ: Q, its lo, dO, its lo; two stages of K and V; dS^T hi and lo;
  // P^T (warpgroup 0 to 1) and the received S^T and dP^T partials and
  // dS^T; LSE and delta of the 32 queries; 13 mbarriers; 1024 to align
  static constexpr size_t kDqSmem =
      4 * QTILE + 4 * KTILE + 2 * HAND + 4 * XCH + 256 + 128 + 1024;
  // dK/dV: K, V; two stages of Q and dO as TMA lands them; the lo parts
  // of the tile in hand; P^T and dS^T hi and lo; the received S^T and
  // dP^T partials, P^T and dS^T; 11 mbarriers; 1024 to align
  static constexpr size_t kDkvSmem =
      2 * KTILE + 6 * QTILE + 4 * HAND + 4 * XCH + 128 + 1024;
};

__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_tf32_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const float* __restrict__ o,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ dq,
                                  float* __restrict__ delta, int seq,
                                  float scale, int causal) {
  using L = Tf32ClusterTiles;
  constexpr int D = 256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;   // the cluster's 32 queries
  const uint32_t qlo = qs + L::QTILE, dos = qlo + L::QTILE;
  const uint32_t dolo = dos + L::QTILE;
  // stage st of key tile j (st = j % 2): K at kv + 2 st KTILE, V after it
  const uint32_t kv = dolo + L::QTILE;
  // dS^T [query][key] hi and lo, the B operand of dQ^T = K^T dS^T
  const uint32_t dsh = kv + 4 * L::KTILE, dsl = dsh + L::HAND;
  // exchange buffers: P^T from warpgroup 0 to 1; received: the other
  // rank's partial S^T and dP^T of this rank's half, its half of dS^T
  const uint32_t pt = dsl + L::HAND, rs = pt + L::XCH, rp = rs + L::XCH;
  const uint32_t rd = rp + L::XCH;
  const uint32_t rows_at = rd + L::XCH;        // LSE, then delta: 32 each
  // mbarriers: +0 Q and dO landed; +8 their lo parts written; +16 + 8 st
  // K full, +32 + 8 st V full; +48 + 8 st K free (both warpgroups), +64
  // + 8 st V free (warpgroup 1); +80, +88, +96 rs, rp, rd received
  const uint32_t bars = rows_at + 256;
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };
  float* lse_s = reinterpret_cast<float*>(at(rows_at));
  float* delta_s = lse_s + kTf32DqQueries;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3, w = tid & 127;
  const int bh = blockIdx.y, col0 = L::W * rank;   // this rank's columns
  const int qt = gridDim.z - 1 - blockIdx.z;   // causal: longest first
  const int q0 = qt * kTf32DqQueries;
  const int key_tiles = (seq + 63) / 64;
  const int n_k = causal ? min(q0 / 64 + 1, key_tiles) : key_tiles;
  const long long rows0 = static_cast<long long>(bh) * seq;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 96);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bars + 16 + 8 * st, 1);
      mbar_init(bars + 32 + 8 * st, 1);
      mbar_init(bars + 48 + 8 * st, 256);
      mbar_init(bars + 64 + 8 * st, 128);
    }
    for (int i = 0; i < 3; ++i) mbar_init(bars + 80 + 8 * i, 1);
    mbar_fence_init();
    for (int i = 0; i < 3; ++i)                // key tile 0's exchanges
      mbar_expect_tx(bars + 80 + 8 * i, L::XCH);
  }
  cluster_sync_any();                  // both ranks run, mbarriers set
  if (wg == 2) {
    // the producer: one thread loads this rank's columns of Q and dO,
    // then V and K of each key tile into stage j % 2 once the tile
    // before there is read; warps 1-3 write the lo parts of Q and dO
    setmaxnreg_dec<24>();
    const int p = tid - 256;
    if (p == 0) {
      mbar_expect_tx(bars, 2 * L::QTILE);
      f32_load<L::W>(qs, &tm_q, bars, kTf32DqQueries, q0, bh, col0);
      f32_load<L::W>(dos, &tm_do, bars, kTf32DqQueries, q0, bh, col0);
      for (int j = 0; j < n_k; ++j) {
        const int st = j & 1;
        const uint32_t ks = kv + 2 * st * L::KTILE, vs = ks + L::KTILE;
        const uint32_t free_par = ((j >> 1) - 1) & 1;
        if (j >= 2) mbar_wait(bars + 64 + 8 * st, free_par);
        mbar_expect_tx(bars + 32 + 8 * st, L::KTILE);
        f32_load<L::W>(vs, &tm_v, bars + 32 + 8 * st, 64, j * 64, bh, col0);
        if (j >= 2) mbar_wait(bars + 48 + 8 * st, free_par);
        mbar_expect_tx(bars + 16 + 8 * st, L::KTILE);
        f32_load<L::W>(ks, &tm_k, bars + 16 + 8 * st, 64, j * 64, bh, col0);
      }
    } else if (p >= 32) {
      mbar_wait(bars, 0);
      split_lo(at(qlo), at(qs), L::QTILE, p - 32, 96);
      split_lo(at(dolo), at(dos), L::QTILE, p - 32, 96);
      fence_proxy_async();
      mbar_arrive(bars + 8);
    }
  } else {
    setmaxnreg_inc<240>();
    // delta = rowsum(dO O) of the 32 queries over all 256 columns, in f32
    // from O and dO as stored, 8 threads a row (both ranks read the whole
    // rows: the same sum in the same order); LSE
    {
      const int r = tid >> 3, gr = q0 + r, c0 = (tid & 7) * (D / 8);
      float part = 0.f;
      if (gr < seq) {
        const float* orow = o + (rows0 + gr) * D + c0;
        const float* drow = dout + (rows0 + gr) * D + c0;
#pragma unroll
        for (int c = 0; c < D / 8; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(orow + c);
          const float4 y = *reinterpret_cast<const float4*>(drow + c);
          part = fmaf(x.x, y.x, part);
          part = fmaf(x.y, y.y, part);
          part = fmaf(x.z, y.z, part);
          part = fmaf(x.w, y.w, part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      if ((tid & 7) == 0) {
        delta_s[r] = part;
        if (gr < seq && rank == 0) delta[rows0 + gr] = part;
      } else if ((tid & 7) == 1) {
        lse_s[r] = gr < seq ? lse[rows0 + gr] : 0.f;
      }
    }
    named_bar_sync(1, 256);
    // warpgroup 0 builds the partial S^T = K Q^T over this rank's 128
    // columns, warpgroup 1 dP^T = V dO^T, each for 64 keys x 32 queries;
    // rank r finishes queries 16 r .. 16 r + 15 (registers 8 r .. 8 r +
    // 7 of this thread: query 16 r + 8 (i >> 2) + 2 t + (i & 1) for its
    // i-th), whose LSE (warpgroup 0) or delta (1) it holds
    float rq[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      rq[c] = (wg == 0 ? lse_s : delta_s)[16 * rank + 8 * (c >> 1) + 2 * t +
                                          (c & 1)];
    // dQ^T = K^T dS^T: a warpgroup owns 64 of the rank's 128 rows (d)
    const int m0 = 64 * wg;
    float run[16], chunk[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) run[e] = 0.f;
    const uint32_t first = wg == 0 ? qs : dos;   // B of S^T or dP^T
    const uint32_t recv = wg == 0 ? rs : rp;
    const uint32_t recv_bar = bars + (wg == 0 ? 80 : 88);
    mbar_wait(bars + 8, 0);            // Q, dO and their lo parts

    for (int j = 0; j < n_k; ++j) {
      const int st = j & 1, k0 = j * 64;
      const uint32_t par = (j >> 1) & 1;
      const uint32_t ks = opaque(kv + 2 * st * L::KTILE);
      const unsigned char* own = at(wg == 0 ? ks : ks + L::KTILE);
      float x[16];                     // S^T or dP^T, this rank's part
      mbar_wait(bars + (wg == 0 ? 16 : 32) + 8 * st, par);
      product_3xtf32<32, L::W / 8>(
          x,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
            frag_mk(hi, lo, own, 64, 16 * warp, kk, g, t);
          },
          [&](int kk, bool low) {
            return f32_kmajor(first + (low ? L::QTILE : 0), 32, 0, kk);
          });
      if (wg == 1) mbar_arrive(bars + 64 + 8 * st);   // V is read
      // K^T's fragments for dQ^T, gathered now: K is free for tile j + 2
      uint32_t kth[8][4], ktl[8][4];
      if (wg == 1) mbar_wait(bars + 16 + 8 * st, par);
      const unsigned char* kp = at(ks);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        frag_km(kth[kk], ktl[kk], kp, 64, m0 + 16 * warp, kk, g, t);
      mbar_arrive(bars + 48 + 8 * st);   // K is read
      wgmma_wait<0>();
      fence_operands(x);
      {  // the other rank's half of the partial, to it
        float theirs[8];
        half_of(theirs, x, rank ^ 1);
        xch_send(theirs, recv, recv_bar, rank ^ 1, w);
      }
      mbar_wait_cluster(recv_bar, j & 1);
      if (w == 0 && j + 1 < n_k) mbar_expect_tx(recv_bar, L::XCH);
      float s[8], mine[8];             // this rank's half over all of D
      half_of(mine, x, rank);
      summed_half(s, mine, at(recv), rank, w);
      const bool edge = (causal && k0 + 63 > q0) || k0 + 64 > seq ||
                        q0 + kTf32DqQueries > seq;
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float p = expf(fmaf(s[i], scale, -rq[2 * (i >> 2) + (i & 1)]));
          if (edge && masked(q0 + 16 * rank + 8 * (i >> 2) + 2 * t + (i & 1),
                             k0 + 16 * warp + g + 8 * ((i >> 1) & 1), seq,
                             causal))
            p = 0.f;
          s[i] = p;                    // P^T
        }
        // warpgroup 1 read tile j - 1's P^T before this rank's dS^T of
        // j - 1 went out, which the other rank's partials of j waited for
        {
          unsigned char* b = at(pt);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            *reinterpret_cast<float4*>(b + (u * 128 + w) * 16) =
                make_float4(s[4 * u], s[4 * u + 1], s[4 * u + 2],
                            s[4 * u + 3]);
        }
        named_bar_arrive(2, 256);      // P^T for warpgroup 1
      } else {
        named_bar_sync(2, 256);        // P^T of tile j
        float p[8];
        xch_read(p, at(pt), w);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          s[i] = p[i] * (s[i] - rq[2 * (i >> 2) + (i & 1)]);   // dS^T
        xch_send(s, rd, bars + 96, rank ^ 1, w);
        mbar_wait_cluster(bars + 96, j & 1);
        if (w == 0 && j + 1 < n_k) mbar_expect_tx(bars + 96, L::XCH);
        float theirs[8];
        xch_read(theirs, at(rd), w);
        // all 16 registers into dS^T, split hi and lo, a pair at a time
        unsigned char *hp = at(dsh), *lp = at(dsl);
#pragma unroll
        for (int e = 0; e < 16; e += 2) {
          const bool mine = (e < 8) == (rank == 0);
          const float v[2] = {mine ? s[e & 7] : theirs[e & 7],
                              mine ? s[(e & 7) + 1] : theirs[(e & 7) + 1]};
          uint32_t hi[2], lo[2];
          split_tf32(v, hi, lo);
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const uint32_t a = f32_at(kTf32DqQueries,
                                      8 * (e >> 2) + 2 * t + b,
                                      16 * warp + g + 8 * ((e >> 1) & 1));
            *reinterpret_cast<uint32_t*>(hp + a) = hi[b];
            *reinterpret_cast<uint32_t*>(lp + a) = lo[b];
          }
        }
        fence_proxy_async();
      }
      named_bar_sync(3, 256);          // dS^T of tile j is whole
      // dQ^T += K^T dS^T over the tile's 64 keys: one tensor-core sum a
      // tile, added in f32
      product_3xtf32<32, 8>(
          chunk,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              hi[i] = kth[kk][i];
              lo[i] = ktl[kk][i];
            }
          },
          [&](int kk, bool low) {
            return f32_kmajor(low ? dsl : dsh, kTf32DqQueries, 0, kk);
          });
      wgmma_wait<0>();
      fence_operands(chunk);
#pragma unroll
      for (int e = 0; e < 16; ++e) run[e] += chunk[e];
    }

#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = q0 + 8 * (e >> 2) + 2 * t + (e & 1);
      if (r < seq)
        dq[(rows0 + r) * D + col0 + m0 + 16 * warp + g +
           8 * ((e >> 1) & 1)] = scale * run[e];
    }
  }
  cluster_sync_any();                  // no rank exits under the other's
                                       // exchanges
}

__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_tf32_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dk,
                                   float* __restrict__ dv, int seq,
                                   float scale, int causal) {
  using L = Tf32ClusterTiles;
  constexpr int D = 256, QT = kTf32Queries;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;   // the cluster's 64 keys
  const uint32_t vs = ks + L::KTILE;
  // stage st: Q, then dO of a 32-query tile as TMA lands them
  const uint32_t stages = vs + L::KTILE;
  auto stage = [&](int st) { return stages + st * 2 * L::QTILE; };
  // the lo parts of the tile in hand, written by the producer once the
  // tile before is through its first products
  const uint32_t qlo = stages + 4 * L::QTILE, dolo = qlo + L::QTILE;
  const uint32_t ph = dolo + L::QTILE, pl = ph + L::HAND;   // P^T
  const uint32_t dsh = pl + L::HAND, dsl = dsh + L::HAND;   // dS^T
  // received: the other rank's partial S^T and dP^T of this rank's half,
  // its half of P^T and of dS^T
  const uint32_t rs = dsl + L::HAND, rp = rs + L::XCH;
  const uint32_t rpf = rp + L::XCH, rdf = rpf + L::XCH;
  // mbarriers: +0 K and V landed; +8, +16 stage full; +24 lo parts
  // written; +32 lo parts read (the first products done); +40, +48 stage
  // free; +56, +64, +72, +80 rs, rp, rpf, rdf received
  const uint32_t bars = rdf + L::XCH;
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3, w = tid & 127;
  const int bh = blockIdx.y, col0 = L::W * rank;   // this rank's columns
  const int k0 = blockIdx.z * 64;      // causal: key tile 0 walks the most
  const long long rows0 = static_cast<long long>(bh) * seq;

  if (tid == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bars + 8 + 8 * st, 1);
      mbar_init(bars + 40 + 8 * st, 256);
    }
    mbar_init(bars + 24, 96);
    mbar_init(bars + 32, 256);
    for (int i = 0; i < 4; ++i) mbar_init(bars + 56 + 8 * i, 1);
    mbar_fence_init();
    for (int i = 0; i < 4; ++i)        // query tile 0's exchanges
      mbar_expect_tx(bars + 56 + 8 * i, L::XCH);
  }
  cluster_sync_any();                  // both ranks run, mbarriers set
  if (wg == 2) {
    // the producer: one thread loads this rank's columns of K and V,
    // then Q and dO of each query tile into stage it % 2 once the tile
    // before there is read; warps 1-3 write each tile's lo parts once
    // the tile before has been through its first products
    setmaxnreg_dec<24>();
    const int p = tid - 256;
    // causal: query tiles wholly above the diagonal are skipped (each
    // role works out its walk: held across the kernel, it spilled)
    const int q_first = causal ? k0 / QT : 0;
    const int n_it = (seq + QT - 1) / QT - q_first;
    if (p == 0) {
      mbar_expect_tx(bars, 2 * L::KTILE);
      f32_load<L::W>(ks, &tm_k, bars, 64, k0, bh, col0);
      f32_load<L::W>(vs, &tm_v, bars, 64, k0, bh, col0);
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1, qb = (q_first + it) * QT;
        const uint32_t full = bars + 8 + 8 * st;
        if (it >= 2) mbar_wait(bars + 40 + 8 * st, ((it >> 1) - 1) & 1);
        mbar_expect_tx(full, 2 * L::QTILE);
        f32_load<L::W>(stage(st), &tm_q, full, QT, qb, bh, col0);
        f32_load<L::W>(stage(st) + L::QTILE, &tm_do, full, QT, qb, bh, col0);
      }
    } else if (p >= 32) {
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1;
        mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);
        if (it > 0) mbar_wait(bars + 32, (it - 1) & 1);
        split_lo(at(qlo), at(stage(st)), L::QTILE, p - 32, 96);
        split_lo(at(dolo), at(stage(st) + L::QTILE), L::QTILE, p - 32, 96);
        fence_proxy_async();
        mbar_arrive(bars + 24);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    // warpgroup 0 builds the partial S^T = K Q^T over this rank's 128
    // columns, P^T, and dV^T += dO^T P; warpgroup 1 the partial dP^T = V
    // dO^T, dS^T from P^T, and dK^T += Q^T dS. Rank r finishes the
    // tile's queries 16 r .. 16 r + 15 (this thread's registers 8 r ..
    // 8 r + 7). Both warpgroups own all of the rank's 128 rows of their
    // output (two blocks of 64) and the 64 keys.
    float run[2][32], chunk[32];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int e = 0; e < 32; ++e) run[mb][e] = 0.f;
    mbar_wait(bars, 0);                // K and V have landed

    // the walk from the key tile's own queries when causal
    for (int qb0 = causal ? k0 : 0, it = 0; qb0 < seq; qb0 += QT, ++it) {
      const int st = it & 1;
      const bool more = qb0 + QT < seq;   // a query tile after this one
      // shared addresses are rebuilt where they are used, from an opaque
      // base (held across the loop, they spilled)
      auto rebase = [&](uint32_t a) { return opaque(ks) + (a - ks); };
      // the LSE (warpgroup 0) or delta (1) of this thread's 4 queries of
      // this rank's half; read under the product
      float rq[4];
      {
        const float* rows = (wg == 0 ? lse : delta) + rows0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = qb0 + 16 * rank + 8 * (c >> 1) + 2 * t + (c & 1);
          rq[c] = r < seq ? rows[r] : 0.f;
        }
      }
      mbar_wait(bars + 24, it & 1);    // the tile and its lo parts
      float x[16];                     // S^T or dP^T, this rank's part
      {
        // B of the first product: Q for S^T, dO for dP^T (hi as TMA
        // wrote it, and its lo)
        const unsigned char* own = at(rebase(wg == 0 ? ks : vs));
        const uint32_t bhi = rebase(stage(st) + (wg == 0 ? 0 : L::QTILE));
        const uint32_t blo = rebase(wg == 0 ? qlo : dolo);
        product_3xtf32<32, L::W / 8>(
            x,
            [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
              frag_mk(hi, lo, own, 64, 16 * warp, kk, g, t);
            },
            [&](int kk, bool low) {
              return f32_kmajor(low ? blo : bhi, QT, 0, kk);
            });
      }
      wgmma_wait<0>();
      fence_operands(x);
      mbar_arrive(bars + 32);          // the lo parts are read
      float s[8];                      // this rank's half over all of D
      {
        const uint32_t recv = rebase(wg == 0 ? rs : rp);
        const uint32_t recv_bar = rebase(bars + (wg == 0 ? 56 : 64));
        float theirs[8];               // the other rank's half, to it
        half_of(theirs, x, rank ^ 1);
        xch_send(theirs, recv, recv_bar, rank ^ 1, w);
        mbar_wait_cluster(recv_bar, it & 1);
        if (w == 0 && more) mbar_expect_tx(recv_bar, L::XCH);
        float mine[8];
        half_of(mine, x, rank);
        summed_half(s, mine, at(recv), rank, w);
      }
      const bool edge = (causal && qb0 < k0 + 63) || qb0 + QT > seq ||
                        k0 + 64 > seq;
      // this thread's keys 16 warp + g (+ 8) and queries 8 n + 2 t (+ 1):
      // registers 4 n + 0, 1 (2, 3), written and read as pairs
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float p = expf(fmaf(s[i], scale, -rq[2 * (i >> 2) + (i & 1)]));
          if (edge &&
              masked(qb0 + 16 * rank + 8 * (i >> 2) + 2 * t + (i & 1),
                     k0 + 16 * warp + g + 8 * ((i >> 1) & 1), seq, causal))
            p = 0.f;
          s[i] = p;                    // P^T
        }
      } else {
        named_bar_sync(5, 256);        // P^T of this tile, both halves
        const unsigned char* hp = at(rebase(ph));
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const uint32_t a = f32_at(64, 16 * warp + g + 8 * ((i >> 1) & 1),
                                    16 * rank + 8 * (i >> 2) + 2 * t);
          const float2 h = *reinterpret_cast<const float2*>(hp + a);
          const float2 l = *reinterpret_cast<const float2*>(hp + L::HAND +
                                                            a);
          s[i] = (h.x + l.x) * (s[i] - rq[2 * (i >> 2)]);   // dS^T
          s[i + 1] = (h.y + l.y) * (s[i + 1] - rq[2 * (i >> 2) + 1]);
        }
        if (more) named_bar_arrive(4, 256);   // P^T is read
      }
      {
        // the finished half to the other rank, and its half back: P^T
        // (warpgroup 0) or dS^T (1)
        const uint32_t fin = rebase(wg == 0 ? rpf : rdf);
        const uint32_t fin_bar = rebase(bars + (wg == 0 ? 72 : 80));
        xch_send(s, fin, fin_bar, rank ^ 1, w);
        mbar_wait_cluster(fin_bar, it & 1);
        if (w == 0 && more) mbar_expect_tx(fin_bar, L::XCH);
        // warpgroup 1 has read tile it - 1's P^T
        if (wg == 0 && it > 0) named_bar_sync(4, 256);
        float theirs[8];
        xch_read(theirs, at(fin), w);
        // all 16 registers into the handoff, split hi and lo, a pair at
        // a time
        unsigned char* hp = at(rebase(wg == 0 ? ph : dsh));
#pragma unroll
        for (int e = 0; e < 16; e += 2) {
          const bool mine = (e < 8) == (rank == 0);
          const float v[2] = {mine ? s[e & 7] : theirs[e & 7],
                              mine ? s[(e & 7) + 1] : theirs[(e & 7) + 1]};
          uint32_t hi[2], lo[2];
          split_tf32(v, hi, lo);
          const uint32_t a = f32_at(64, 16 * warp + g + 8 * ((e >> 1) & 1),
                                    8 * (e >> 2) + 2 * t);
          *reinterpret_cast<uint2*>(hp + a) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(hp + L::HAND + a) =
              make_uint2(lo[0], lo[1]);
        }
      }
      fence_proxy_async();
      named_bar_sync(6 + wg, 128);     // this warpgroup's handoff is whole
      if (wg == 0) named_bar_arrive(5, 256);   // P^T for warpgroup 1
      // dV^T += dO^T P (warpgroup 0), dK^T += Q^T dS (1): one tensor-core
      // sum a query tile for each 64-row block of the rank's columns,
      // added in f32 before the next block's; A the stage's dO^T or Q^T
      const unsigned char* sp =
          at(rebase(stage(st) + (wg == 0 ? L::QTILE : 0)));
      const uint32_t hand = rebase(wg == 0 ? ph : dsh);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        product_3xtf32<64, QT / 8>(
            chunk,
            [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
              frag_km(hi, lo, sp, QT, 64 * mb + 16 * warp, kk, g, t);
            },
            [&](int kk, bool low) {
              return f32_kmajor(hand + (low ? L::HAND : 0), 64, 0, kk);
            });
        if (mb == 1) mbar_arrive(bars + 40 + 8 * st);   // stage read
        wgmma_wait<0>();
        fence_operands(chunk);
#pragma unroll
        for (int e = 0; e < 32; ++e) run[mb][e] += chunk[e];
      }
    }

    float* out = wg == 0 ? dv : dk;
    const float f = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (key < seq)
          out[(rows0 + key) * D + col0 + 64 * mb + 16 * warp + g +
              8 * ((e >> 1) & 1)] = f * run[mb][e];
      }
  }
  cluster_sync_any();                  // no rank exits under the other's
                                       // exchanges
}

// The storage type and head_dim pick the kernel: bf16 the wgmma kernels
// (head_dim 256 its own); f32 split TF32 on wgmma at head_dim 64 and 128,
// on wgmma in clusters of two at 256, and on mma.sync at 16 and 32
// (launch_mma's grid).
template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
template <typename T, int D>
constexpr bool kWgmma256 = kBf16<T> && D == 256;
template <typename T, int D>
constexpr bool kTf32Wgmma = !kBf16<T> && (D == 64 || D == 128);
template <typename T, int D>
constexpr bool kTf32Cluster = !kBf16<T> && D == 256;
// threads of a backward CTA of storage T at head_dim D
template <typename T, int D>
constexpr int kBwdThreadsOf =
    kWgmma256<T, D> ? kBwdWgThreads
    : kBf16<T> || kTf32Wgmma<T, D> || kTf32Cluster<T, D> ? kBwdThreads
                                                         : kMmaThreads;

// Launch a wgmma backward kernel of storage T at head_dim D on a (bh,
// ceil(seq / tile)) grid of `threads` threads with `bytes` of dynamic
// shared memory, its first four arguments the tensor maps of q, k, v and
// dO: boxes of `q_rows` rows for q and dO, of `kv_rows` for k and v; ->
// the launch's error code.
template <typename T, int D, typename Kernel, typename... Args>
int launch_wgmma(Kernel kernel, int threads, const void* const (&src)[4],
                 int q_rows, int kv_rows, int tile, int bh, int seq,
                 size_t bytes, cudaStream_t stream, Args... args) {
  const int tiles = (seq + tile - 1) / tile;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = rows_map<T>(&maps[i], src[i], D, seq, bh,
                                        i == 0 || i == 3 ? q_rows : kv_rows);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, tiles, 1), threads, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], args...);
  return cudaGetLastError();
}

// Launch an f32 head_dim-256 kernel on a (2, bh, ceil(seq / tile)) grid of
// clusters of two CTAs along x (kBwdThreads threads, `bytes` of dynamic
// shared memory each; launch_cluster), its first four arguments the
// tensor maps of q, k, v and dO: boxes of `q_rows` rows for q and dO, of
// `kv_rows` for k and v; -> the launch's error code (a refused cluster
// launch included: nothing falls back).
template <typename Kernel, typename... Args>
int launch_tf32_cluster(Kernel kernel, const void* const (&src)[4],
                        int q_rows, int kv_rows, int tile, int bh, int seq,
                        size_t bytes, cudaStream_t stream, Args... args) {
  const int tiles = (seq + tile - 1) / tile;
  if (tiles > 65535 || bh > 65535) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = rows_map<float>(
        &maps[i], src[i], 256, seq, bh, i == 0 || i == 3 ? q_rows : kv_rows);
    if (err != cudaSuccess) return err;
  }
  // the tile axis slowest
  return launch_cluster(kernel, dim3(kTf32Ranks, bh, tiles), kBwdThreads,
                        bytes, stream, maps[0], maps[1], maps[2], maps[3],
                        args...);
}

struct DqLaunch {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void* dq;
  float* delta;
  int bh, seq;
  float scale;
  int causal;
  cudaStream_t stream;

  template <typename T, int D>
  static auto kernel() {
    if constexpr (kWgmma256<T, D>)
      return flash_dq_wgmma256_kernel;
    else if constexpr (kBf16<T>)
      return flash_dq_wgmma_kernel<D>;
    else if constexpr (kTf32Wgmma<T, D>)
      return flash_dq_tf32_wgmma_kernel<D>;
    else if constexpr (kTf32Cluster<T, D>)
      return flash_dq_tf32_wgmma256_kernel;
    else
      return flash_dq_tf32_kernel<D>;
  }

  template <typename T, int D>
  static size_t smem() {
    if constexpr (kWgmma256<T, D>)
      return Bwd256Tiles::kDqSmem;
    else if constexpr (kBf16<T>)
      return BwdTiles<D>::kDqSmem;
    else if constexpr (kTf32Wgmma<T, D>)
      return Tf32WgTiles<D>::kDqSmem;
    else if constexpr (kTf32Cluster<T, D>)
      return Tf32ClusterTiles::kDqSmem;
    else
      return Tf32BwdTiles<D>::kDqSmem;
  }

  template <typename T, int D>
  int run() const {
    if constexpr (kBf16<T> || kTf32Wgmma<T, D>) {
      // the CTA owns 128 queries (bf16; f32: 64) and streams 64-key tiles
      constexpr int own = kBf16<T> ? kDqRows : 64;
      const void* const src[4] = {q, k, v, dout};
      return launch_wgmma<T, D>(kernel<T, D>(), kBwdThreadsOf<T, D>, src, own,
                                kBlockK, own, bh, seq, smem<T, D>(), stream,
                                static_cast<const T*>(o),
                                static_cast<const T*>(dout), lse,
                                static_cast<T*>(dq), delta, seq, scale,
                                causal);
    } else if constexpr (kTf32Cluster<T, D>) {
      // a cluster owns 32 queries and streams 64-key tiles
      const void* const src[4] = {q, k, v, dout};
      return launch_tf32_cluster(
          kernel<T, D>(), src, kTf32DqQueries, kBlockK, kTf32DqQueries, bh,
          seq, smem<T, D>(), stream, static_cast<const float*>(o),
          static_cast<const float*>(dout), lse, static_cast<float*>(dq),
          delta, seq, scale, causal);
    } else {
      return launch_mma(kernel<T, D>(), bh, seq, smem<T, D>(), stream,
                        static_cast<const T*>(q),
                        static_cast<const T*>(k), static_cast<const T*>(v),
                        static_cast<const T*>(o), static_cast<const T*>(dout),
                        lse, static_cast<T*>(dq), delta, seq, scale, causal);
    }
  }
};

struct DkvLaunch {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dk, *dv;
  int bh, seq;
  float scale;
  int causal;
  cudaStream_t stream;

  template <typename T, int D>
  static auto kernel() {
    if constexpr (kWgmma256<T, D>)
      return flash_dkv_wgmma256_kernel;
    else if constexpr (kBf16<T>)
      return flash_dkv_wgmma_kernel<D>;
    else if constexpr (kTf32Wgmma<T, D>)
      return flash_dkv_tf32_wgmma_kernel<D>;
    else if constexpr (kTf32Cluster<T, D>)
      return flash_dkv_tf32_wgmma256_kernel;
    else
      return flash_dkv_tf32_kernel<D>;
  }

  template <typename T, int D>
  static size_t smem() {
    if constexpr (kWgmma256<T, D>)
      return Bwd256Tiles::kDkvSmem;
    else if constexpr (kBf16<T>)
      return BwdTiles<D>::kDkvSmem;
    else if constexpr (kTf32Wgmma<T, D>)
      return Tf32WgTiles<D>::kDkvSmem;
    else if constexpr (kTf32Cluster<T, D>)
      return Tf32ClusterTiles::kDkvSmem;
    else
      return Tf32BwdTiles<D>::kDkvSmem;
  }

  template <typename T, int D>
  int run() const {
    if constexpr (kBf16<T> || kTf32Wgmma<T, D>) {
      // the CTA owns 64 keys (bf16 below head_dim 256: 128) and streams
      // 64-query tiles (f32: 32)
      constexpr int own = kBf16<T> && D < 256 ? kBwdRows : kBlockK;
      constexpr int streamed = kBf16<T> ? kBlockQ : kTf32Queries;
      const void* const src[4] = {q, k, v, dout};
      return launch_wgmma<T, D>(kernel<T, D>(), kBwdThreadsOf<T, D>, src,
                                streamed, own, own, bh, seq, smem<T, D>(),
                                stream, lse, delta, static_cast<T*>(dk),
                                static_cast<T*>(dv), seq, scale, causal);
    } else if constexpr (kTf32Cluster<T, D>) {
      // a cluster owns 64 keys and streams 32-query tiles
      const void* const src[4] = {q, k, v, dout};
      return launch_tf32_cluster(
          kernel<T, D>(), src, kTf32Queries, kBlockK, kBlockK, bh, seq,
          smem<T, D>(), stream, lse, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), seq, scale, causal);
    } else {
      return launch_mma(kernel<T, D>(), bh, seq, smem<T, D>(), stream,
                        static_cast<const T*>(q),
                        static_cast<const T*>(k), static_cast<const T*>(v),
                        static_cast<const T*>(dout), lse, delta,
                        static_cast<T*>(dk), static_cast<T*>(dv), seq, scale,
                        causal);
    }
  }
};

// What the runtime says of one backward kernel: registers a thread, local
// memory a thread (spills), dynamic shared memory and resident CTAs per
// SM at the kernel's own thread count, into out[0..3]; out[4] the
// cluster size, out[5] co-resident clusters (1 and 0 without a cluster:
// all but the f32 head_dim-256 kernels, fill_info of flash_wide.cuh).
struct InfoQuery {
  int which;                           // 0: dQ, 1: dK/dV
  int* out;

  template <typename Kernel>
  int fill(Kernel kernel, size_t bytes, int threads, bool carveout) const {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
    if (err == cudaSuccess && carveout)      // as launch_mma sets it
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    int ctas = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                          threads, bytes);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = static_cast<int>(bytes);
    out[3] = ctas;
    out[4] = 1;                        // no cluster
    out[5] = 0;
    return cudaSuccess;
  }

  template <typename T, int D>
  int run() const {
    if constexpr (kTf32Cluster<T, D>)
      return which == 0 ? fill_info(DqLaunch::kernel<T, D>(), kBwdThreads,
                                    DqLaunch::smem<T, D>(), kTf32Ranks, out)
                        : fill_info(DkvLaunch::kernel<T, D>(), kBwdThreads,
                                    DkvLaunch::smem<T, D>(), kTf32Ranks,
                                    out);
    // the mma.sync kernels are launched with the largest carveout
    constexpr bool mma = kBwdThreadsOf<T, D> == kMmaThreads;
    return which == 0
               ? fill(DqLaunch::kernel<T, D>(), DqLaunch::smem<T, D>(),
                      kBwdThreadsOf<T, D>, mma)
               : fill(DkvLaunch::kernel<T, D>(), DkvLaunch::smem<T, D>(),
                      kBwdThreadsOf<T, D>, mma);
  }
};

}  // namespace sparknet_flash

// q, k, v, o, dout, dq: (bh, seq, head_dim) contiguous, dtype 0 = f32,
// 1 = bf16 (16-byte aligned); lse (read) and delta (written): (bh, seq)
// f32. A head_dim past 256 runs the wide kernels of flash_wide.cuh, here
// and in the dK/dV entry point (cluster kernels: D a multiple of 128 that
// splits into equal clusters, ops/cuda_attention.py built_head_dim).
extern "C" int sparknet_flash_backward_dq(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const void* lse,
                                          void* dq, void* delta, int dtype,
                                          int bh, int seq, int head_dim,
                                          float scale, int causal,
                                          void* stream) {
  if (head_dim > 256)
    return sparknet_flash::wide_dq(
        q, k, v, o, dout, static_cast<const float*>(lse), dq,
        static_cast<float*>(delta), dtype, bh, seq, head_dim, scale, causal,
        static_cast<cudaStream_t>(stream));
  const sparknet_flash::DqLaunch launch{
      q, k, v, o, dout, static_cast<const float*>(lse), dq,
      static_cast<float*>(delta), bh, seq, scale, causal,
      static_cast<cudaStream_t>(stream)};
  return sparknet_flash::dispatch(dtype, head_dim, launch);
}

// q, k, v, dout, dk, dv: (bh, seq, head_dim) contiguous; lse and delta
// (the dQ kernel's output): (bh, seq) f32.
extern "C" int sparknet_flash_backward_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int dtype,
                                           int bh, int seq, int head_dim,
                                           float scale, int causal,
                                           void* stream) {
  if (head_dim > 256)
    return sparknet_flash::wide_dkv(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(delta), dk, dv, dtype, bh, seq, head_dim,
        scale, causal, static_cast<cudaStream_t>(stream));
  const sparknet_flash::DkvLaunch launch{
      q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, bh, seq, scale, causal,
      static_cast<cudaStream_t>(stream)};
  return sparknet_flash::dispatch(dtype, head_dim, launch);
}

// which 0 = the dQ kernel, 1 = the dK/dV kernel, for (dtype, head_dim):
// out[0] registers a thread, out[1] local memory bytes a thread (spills),
// out[2] dynamic shared memory bytes, out[3] resident CTAs per SM, out[4]
// the cluster size (1: none), out[5] co-resident clusters on the card (the
// wide kernels past 256; 0 without a cluster).
extern "C" int sparknet_flash_backward_info(int which, int dtype,
                                            int head_dim, int* out) {
  if (head_dim > 256)
    return sparknet_flash::wide_info(which == 0 ? 1 : 2, dtype, head_dim,
                                     out);
  const sparknet_flash::InfoQuery query{which, out};
  return sparknet_flash::dispatch(dtype, head_dim, query);
}
