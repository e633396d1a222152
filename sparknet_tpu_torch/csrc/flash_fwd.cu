// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_attention.py:_fa_kernel
// (reached from flash_attention / _flash_forward there):
//   O   = softmax(scale * Q K^T [causal mask]) V
//   LSE = m + log(max(l, 1e-30))        per query row, f32
// by the online-softmax recurrence: a running max m, denominator l and
// unnormalised accumulator over tiles of keys; masked scores are -1e30;
// O = acc / max(l, 1e-30). Storage f32 or bf16, head_dim 16, 32, 64, 128
// or 256, any sequence length (the last tile is ragged and masked).
//
// Bound on the H100: operations. One (b, h) at S = 4096, D = 128 causal
// does 2 * 2 * S^2 * D / 2 = 4.3 GFLOP on 4 MB of bf16 q, k, v, o: ~1000
// operations per byte, far above the card's balance.
//
// bf16 storage up to head_dim 128 (flash_fwd_wgmma_kernel): both products
// on the tensor cores through wgmma (flash_wgmma.cuh). A CTA of two
// warpgroups owns 128 query rows of one (b, h), 64 per warpgroup (one m64
// tile).
//  - Loads: one thread issues TMA copies through 3-D tensor maps
//    (D, S, B*H), so rows past S of one (b, h) arrive as zeros and never
//    as the next head's rows. Q lands once; K and V follow in 128-key
//    tiles through a ring of two stages, each completing on an mbarrier,
//    so tile j + 1 is in flight while tile j is computed. 128-, 64- or
//    32-byte swizzle (D = 64 and 128, 32, 16). Shared memory at D = 128:
//    Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB, one CTA per SM.
//  - S = Q K^T: m64n128k16 wgmma with both operands in shared memory
//    (K-major: K stored [key][d] is already the B operand). S stays in
//    f32 registers and is scaled there, by scale * log2(e) for exp2f: the
//    TPU kernel scales Q in f32 before the product, which rounding
//    scale * Q back to bf16 would not reproduce.
//  - Online softmax in registers: a row's 128 scores sit in the 4 lanes of
//    a quad, so its max is two shuffles; l sums the f32 p before any
//    rounding, per lane, and the quad's parts are added at the end.
//  - O += P V: m64nDk16 wgmma with P from registers, packed to bf16 A
//    fragments straight from S's accumulators, and V stored [key][d] as
//    the MN-major B operand (imm-trans-b = 1). P is rounded to bf16 here,
//    as any tensor-core forward does; O is rounded once, at the end.
//  - Causal: key tiles past the diagonal are skipped and the mask runs
//    only on the tile that crosses it or S; the query tile is the slow
//    grid axis, last tile first, so the longest CTAs start first.
//  - Not yet: the head_dim-256 kernel's producer warpgroup and its S of
//    the next tile under this tile's P V (below), a persistent grid, and
//    a TMA store of O. Both warpgroups wait at one barrier per key tile
//    before its stage is refilled.
//
// bf16 storage at head_dim 256 (flash_fwd_wgmma256_kernel; and D 129-255,
// zero-padded to it): one CTA owns all 256 columns of O for its query
// rows, so S = Q K^T is built once per tile pair. 384 threads: a
// producer warpgroup and two consumer warpgroups; setmaxnreg leaves the
// producer 24 registers a thread and gives the consumers 240, enough for
// O's 128 f32 accumulators a thread beside S (32) and P (16).
//  - The CTA owns 128 query rows, 64 a consumer warpgroup, and walks the
//    keys in tiles of 64. Q is resident (128 x 256 bf16, 64 KB); K and V
//    of a tile go through two stages of 32 KB each (128 KB), four TMA
//    blocks of 64 columns in the 128-byte swizzle (Tile256): 194 KB in
//    all, one CTA an SM.
//  - Per warpgroup and tile: S = Q K^T as m64n64k16 over 16 k-steps of D
//    (both operands in shared memory); the online softmax on its 32 f32
//    a thread; P packed from S's accumulators into bf16 A fragments; O
//    += P V as four register-A m64n256k16 steps, V read MN-major. The
//    rounding points are those of the kernel above.
//  - No CTA barrier in the key loop: a full and an empty mbarrier guard
//    each stage's K and V. K of a tile is released once both warpgroups'
//    S is done, V once both have added their P V; the producer's one
//    thread refills each as it frees. S of tile j goes to the tensor
//    cores before P V of tile j - 1, so the softmax of tile j runs under
//    that P V (wgmma_wait<1>); O is rescaled after the P V is done, and
//    only by a warp whose rows' max moved (a factor of 1 is exact).
//  - Causal: key tiles past the diagonal are skipped; the first
//    warpgroup's rows see none of the CTA's last tile, which it leaves;
//    the mask runs only on the tiles that cross the diagonal or S; the
//    query tile is the slow grid axis, last tile first.
//  - Grids of fewer 128-row CTAs than the card has SMs (the host asks the
//    device) take the split variant: a CTA of 64 query rows, twice as
//    many CTAs, whose warpgroups walk the even and the odd key tiles,
//    each its own stage, with its own (m, l, O), in the order S, softmax,
//    P V (one stage a warpgroup leaves nothing to put under P V); at the
//    end the second hands its m, l and O (f32, through its stage) to the
//    first, which adds them to its own in that order, in f32.
//  - No atomics: each O element and LSE row is summed by one warpgroup
//    (and, in the split variant, the two halves added by one thread) in
//    a fixed order, so two launches give bitwise the same O and LSE.
//  - Tried and dropped (scripts/flash_ab.py, PERF.md): the two consumer
//    warpgroups taking turns at the tensor cores on named barriers
//    (ping-pong), 0.99x; no producer warpgroup, one consumer thread
//    refilling each stage, 0.89x; a producer warp beside the consumers
//    (288 threads), which leaves 168 registers a thread and spills.
//  - Registers a thread, shared memory and CTAs per SM, as the runtime
//    reports them on the H100 (sparknet_flash_forward_info, printed and
//    checked by chip_smoke.py phase 6); no instantiation spills:
//        D      16           32           64           128          256
//               130 21 KB 1  138 42 KB 1  154 83 KB 1  186 161 KB 1  168 194 KB 1
//    (at D = 256 the count at launch, 384 threads; the consumers run at
//    240 after setmaxnreg). At the LM's (4, 8, 4096, 128) causal:
//    0.32 ms, ~430 TFLOP/s, 1.24x F.scaled_dot_product_attention's time;
//    at the d_model 2048 LM's (2, 8, 4096, 256) causal: 0.27 ms, ~510
//    TFLOP/s, level with it (PERF.md).
//
// f32 storage at head_dim 32, 64 and 128 (flash_fwd_tf32_wgmma_kernel<D>):
// both products on wgmma in split TF32 (3xTF32, flash_tf32.cuh): each f32
// operand is split into a TF32 hi and lo, and a b ~ a_hi b_lo + a_lo b_hi
// + a_hi b_hi with f32 accumulation (wgmma_tf32, m64nNk8), which keeps O
// within the f32 limits (2e-5 of the largest element; one TF32 pass reads
// ~15x over it). TF32 wgmma takes both operands K-major and TMA does not
// transpose: S = Q K^T fits as TMA writes Q and K, O += P V does not (V
// [key][d] is MN-major there). A CTA of 384 threads owns 128 queries of
// one (b, h) and walks the keys in tiles of 64:
//  - The producer warpgroup (setmaxnreg 40): one thread loads Q once and
//    K and V of each key tile by TMA (3-D maps of 32-float column blocks
//    in the 128-byte swizzle, rows_map<float>: rows past S of a (b, h)
//    read as zeros); all 128 threads write K's lo (x - trunc(x): the
//    tensor core reads K's own tile as its truncated hi) and V^T [d][key]
//    hi and lo from V's landing slot, the keys of each group of 8 in the
//    order 0, 2, 4, 6, 1, 3, 5, 7, which is the k order in which P's A
//    fragments come from S's accumulators (transpose_v: 4 x 4 blocks,
//    reads and writes free of bank conflicts). Each written tile is
//    handed over by fence.proxy.async and an mbarrier. K is reloaded once
//    both consumers' S of the tile before is done, V as soon as the
//    transpose has read its slot, V^T rewritten once both consumers' P V
//    is done: one slot each, the next K and V land under this tile's
//    softmax and P V.
//  - Two consumer warpgroups (setmaxnreg 232), 64 queries each, all D
//    columns of O: S = Q K^T as m64n64k8 over D / 8 k-steps, Q's A
//    fragments gathered from its tile by ldmatrix and split in registers,
//    K and its lo as B, one tensor-core sum over all of D; scaled after
//    the product and the online softmax in natural units (expf, as the
//    plain version computes it; a row's scores in the 4 lanes of a quad);
//    O += P V as m64nDk8 over the tile's 8 k-steps, P split from S's
//    accumulators into A fragments without a shuffle, V^T hi and lo as
//    B: one tensor-core sum a key tile (the tensor core truncates its
//    sums, flash_tf32.cuh), added in f32 to O scaled by alpha. Nothing is
//    rounded between the products. Two k-steps a commit group, at most
//    two in flight (product_3xtf32). Addresses and descriptors are
//    rebuilt each tile from opaque values: held across the loop, they
//    spilled.
//  - Causal: key tiles past the diagonal are skipped, the first
//    warpgroup leaves the CTA's last tile, the mask runs on the tiles
//    that cross the diagonal or S; the query tile is the slow grid axis,
//    last tile first. No atomics: each O element and LSE row is summed by
//    one warpgroup in a fixed order, so two launches give the same bits.
//  - Shared memory: Q 64 KB; K, its lo, V's slot, V^T hi and lo 32 KB
//    each at D = 128: 230,464 bytes (115,776 at 64, 58,432 at 32), one
//    CTA an SM; 168 registers a thread at launch (384 threads), no spills
//    (chip_smoke.py phase 6's _f32_fwd_design).
//  - Bound: operations. At the LM's (4, 8, 4096, 128) causal, 137 GFLOP:
//    0.83 ms at 165 TFLOP/s of f32-accurate products (495 TFLOP/s of
//    dense TF32 over the 3 products). Measured 1.28-1.38 ms, 100-107
//    TFLOP/s, 60-65% of it, 1.98-2.09x the split-TF32 mma.sync kernel
//    that ran D = 128 before it, in the same calls, and 0.41x
//    F.scaled_dot_product_attention's f32 time (scripts/flash_ab.py
//    --cases f32; PERF.md).
// f32 storage at head_dim 256, and 129-255 zero-padded to it
// (flash_fwd_tf32_wgmma256_kernel): the design above over a thread-block
// cluster of two CTAs ("ranks"), since its f32 tiles with their lo parts
// (128 queries: 230,464 bytes at head_dim 128) do not fit one CTA at 256.
// Rank r owns the columns [128 r, 128 r + 128) of Q, K, V and O, and a
// cluster owns 64 queries (Q 32 KB a rank); S = Q K^T is built once a
// tile and O is not split over the grid. Per rank, 384 threads:
//  - The producer warpgroup (setmaxnreg 40): warps 0-1 load Q and K of
//    each 64-key tile by TMA (K once warpgroup 0's S of the tile before
//    is done) and write K's lo; warps 2-3 load V and write V^T hi and lo
//    (transpose_v), as above over the rank's 128 columns.
//  - Warpgroup 0 builds the partial S over the rank's columns, m64n64k8
//    in split TF32, one tensor-core sum of 16 k-steps (Q split in
//    registers, K as TMA wrote it and its lo). Rank r finishes rows g +
//    8 r of each warp's 16, which are the same 16 of the 32 accumulator
//    registers in every thread of either rank: a thread sends the other
//    half to the thread in the same place of the other rank (st.async
//    into an exchange buffer there, 16 f32 a thread, completing on that
//    rank's mbarrier), adds the 16 it receives to its own half in rank
//    order, in f32, scales and masks them, and runs the online softmax of
//    its row (m, l, alpha; a row's 64 keys in the 4 lanes of a quad).
//    It writes P and alpha of its row into the rank's P buffer and sends
//    them to the same place of the other rank's: every score is built
//    once, and both ranks use the same P bit for bit.
//  - Warpgroup 1 holds O over the rank's 128 columns for all 64 queries
//    (m64n128): a thread reads the 32 P values of its place in the
//    buffer (the order of S's accumulators, so they are P's A fragments
//    without a shuffle) and both alphas, and adds P V as one tensor-core
//    sum of the tile's 8 k-steps (P split in registers, V^T hi and lo as
//    B) to O scaled by alpha, in f32. Warpgroup 0 builds the next tile's
//    S while warpgroup 1 adds this tile's P V. At the end warpgroup 0
//    writes LSE of its rows and sends l to both ranks' warpgroup 1, which
//    writes its 128 columns of O.
//  - No cluster barrier in the loop: an exchange buffer is refilled only
//    after its reader has passed it on (a tile's partial goes out once
//    the other rank's P of the tile before has arrived, which it sent
//    after reading the partial, and once warpgroup 1 has read that P);
//    each mbarrier that counts received bytes is armed by its reader
//    before it sends what lets the other rank send them.
//  - Shared memory: Q, K, its lo, V's slot, V^T hi and lo, 32 KB each;
//    the received partial 8 KB, P 16 KB, alpha and l 1 KB each: 224,384
//    bytes, one CTA an SM. 168 registers a thread at launch (384
//    threads), no spills, clusters of two, 66 co-resident
//    (chip_smoke.py phase 6's _f32_fwd256_design).
//  - Launched with cudaLaunchKernelEx (launch_cluster,
//    flash_cluster.cuh), a cluster dimension of 2 on a (2, bh, tiles)
//    grid, the tile axis slowest and the longest causal clusters first;
//    a launch the card refuses returns its error (no fallback). At
//    (2, 8, 4096, 256) causal, lm --d-model 2048 --heads 8's attention at
//    the verb's default dtype (1,024 clusters): 2.08-2.15 ms, 39-40% of
//    its bound, 2.72x the split-TF32 mma.sync kernel that ran head_dim
//    256 before it (O's columns split over the grid, S built twice) and
//    0.55x F.scaled_dot_product_attention's f32 time in one call
//    (scripts/flash_ab.py --cases f32-256; PERF.md).
// f32 storage at head_dim 16 (flash_fwd_tf32_kernel): split TF32 on
// mma.sync m16n8k8 fed from shared memory. A CTA of 4 warps owns 64
// query rows, 16 a warp; K and V in tiles of 64 keys by cp.async through
// two stages, f32 tiles of row stride D + 4, free of bank conflicts; S
// and P V each one tensor-core sum a key tile. The wgmma kernel above
// lost at 16: 0.0160 ms against this kernel's 0.0144 at (8, 8, 256, 16)
// causal in one call (PERF.md). 128 registers, 25 KB of shared memory,
// 4 CTAs an SM (phase 6; no spills).
// The storage type picks the kernel and nothing else does.

#include <algorithm>
#include <type_traits>

#include "flash_cluster.cuh"
#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_tf32.cuh"
#include "flash_wgmma.cuh"
#include "flash_wide.cuh"

namespace sparknet_flash {

// bf16 storage: the tensor-core kernel (the note at the top).

using bf16 = __nv_bfloat16;

constexpr int kWgRows = 128;       // query rows per CTA, 64 per warpgroup
constexpr int kWgKeys = 128;       // keys per tile
constexpr int kWgThreads = 256;    // two warpgroups
constexpr int kWgStages = 2;       // the K/V ring's depth
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry at head_dim D <= 128 (bytes; flash_wgmma.cuh): a
// CTA computes all D columns of O through a ring of two K/V stages.
template <int D>
struct WgTiles {
  static_assert(D <= 128, "bf16 head_dim 256 runs flash_fwd_wgmma256_kernel");
  static constexpr int W = D < 64 ? D : 64;   // columns of a swizzle block
  static constexpr int RB = 2 * W;            // its row: the swizzle bytes
  static constexpr int BLOCK = 128 * RB;      // one block of a 128-row tile
  static constexpr int TILE = 128 * D * 2;    // a 128-row tile of Q, K or V
  static constexpr int STAGE = 2 * TILE;      // K then V
  static constexpr int SBO = 8 * RB;          // 8 rows
  // Q, the stages of K and V, their mbarriers, 1024-byte alignment
  static constexpr size_t kSmem = TILE + kWgStages * STAGE + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int seq, float scale, int causal) {
  using L = WgTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms repeat every 1024 bytes: tiles start on that
  const uint32_t qs = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t kv = qs + L::TILE;   // stage st at kv + st STAGE: K, V
  const uint32_t bars = kv + kWgStages * L::STAGE;   // Q, then each stage
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * kWgRows;
  const int n_k = causal ? qt + 1 : gridDim.y;   // key tiles to walk

  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v;
  // column blocks [c0, c0 + n) of rows [row0, row0 + 128)
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                  int row0, int c0, int n) {
    for (int c = 0; c < n; ++c)
      tma_load_3d(dst + c * L::BLOCK, map, bar, (c0 + c) * L::W, row0, bh);
  };
  auto load_kv = [&](int j) {
    const int st = j % kWgStages;
    const uint32_t bar = bars + 8 + 8 * st;
    const uint32_t dst = kv + st * L::STAGE;
    mbar_expect_tx(bar, L::STAGE);
    load(dst, mk, bar, j * kWgKeys, 0, D / L::W);
    load(dst + L::TILE, mv, bar, j * kWgKeys, 0, D / L::W);
  };
  if (tid == 0) {
    for (int i = 0; i <= kWgStages; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, L::TILE);
    load(qs, mq, bars, q0, 0, D / L::W);
    for (int j = 0; j < kWgStages && j < n_k; ++j) load_kv(j);
  }

  const float sl2 = scale * kLog2e;
  const int row = wg * 64 + warp * 16 + g;   // this thread's rows of the
                                             // CTA's 128: row, row + 8
  float acc[D / 2];                          // O, unnormalised
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units
  mbar_wait(bars, 0);                        // Q has landed

  for (int j = 0; j < n_k; ++j) {
    const int st = j % kWgStages;
    const uint32_t ks = kv + st * L::STAGE, vs = ks + L::TILE;
    mbar_wait(bars + 8 + 8 * st, (j / kWgStages) & 1);   // K, V of tile j
    float s[64];                             // S: 64 rows x 128 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16, blk = (c / L::W) * L::BLOCK, in = (c % L::W) * 2;
      wgmma_ss_n128(
          s, wgmma_desc(qs + blk + wg * 64 * L::RB + in, 16, L::SBO, L::RB),
          wgmma_desc(ks + blk + in, 16, L::SBO, L::RB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    const int k0 = j * kWgKeys;
    const bool edge = (causal && j == qt) || k0 + kWgKeys > seq;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int i = (e >> 1) & 1;
      float x = s[e] * sl2;
      if (edge) {
        // a query row past seq is never stored: only keys are masked
        const int c = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (c >= seq || (causal && c > q0 + row + 8 * i)) x = kNegInf;
      }
      s[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int i = (e >> 1) & 1;
      s[e] = exp2f(s[e] - m[i]);
      sum[i] += s[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    uint32_t pf[8][4];                       // P as A fragments, keys 16 kk..
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_tb<D>(
          acc, pf[kk],
          wgmma_desc(vs + kk * 16 * L::RB, L::BLOCK, L::SBO, L::RB));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncthreads();                         // stage st is free
    if (tid == 0 && j + kWgStages < n_k) load_kv(j + kWgStages);
  }

  const long long r0 = static_cast<long long>(bh) * seq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = q0 + row + 8 * i;
    if (r >= seq) continue;
    const float lc = fmaxf(lt, 1e-30f);
    bf16* orow = o + (r0 + r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(acc[4 * n + 2 * i] / lc, acc[4 * n + 2 * i + 1] / lc);
    if (t == 0) lse[r0 + r] = m[i] * kLn2 + logf(lc);
  }
}

// bf16 storage at head_dim 256 (and 129-255, zero-padded to it): the
// tensor-core kernel of the note at the top that owns all 256 columns.

constexpr int kFwd256Threads = 384;   // a producer warpgroup, two consumer
                                      // warpgroups

// Shared memory of the head_dim-256 forward (bytes; Tile256): Q (128
// rows, 64 in the split variant), two stages of K then V (64 keys each),
// nine mbarriers, the split variant's row state of its second warpgroup
// (m and l of 64 rows), and 1024 bytes to align the tiles.
struct Fwd256Tiles : Tile256 {
  static constexpr int STAGE = 2 * TILE;      // K, then V, of one key tile
  static constexpr int kBars = 128;           // nine mbarriers, rounded up
  static constexpr size_t smem(bool split) {
    return (split ? TILE : 2 * TILE) + 2 * STAGE + kBars + 512 + 1024;
  }
};

// kSplit: the variant for grids smaller than the card, a CTA of 64 query
// rows whose warpgroups walk alternate key tiles and combine at the end.
template <bool kSplit>
__global__ void __launch_bounds__(kFwd256Threads, 1)
    flash_fwd_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              bf16* __restrict__ o, float* __restrict__ lse,
                              int seq, float scale, int causal) {
  using L = Fwd256Tiles;
  constexpr int kRows = kSplit ? 64 : 128;       // query rows of a CTA
  constexpr int kQBlock = kRows * L::RB;         // Q's column blocks apart
  constexpr int kReaders = kSplit ? 128 : 256;   // threads that read a stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;     // this CTA's queries
  // stage st (key tile j: st = j & 1): K at stages + st STAGE, V a TILE on
  const uint32_t stages = qs + kRows * L::D * 2;
  // mbarriers: +0 Q; +8, +16 K full; +24, +32 V full; +40, +48 K free;
  // +56, +64 V free (every thread that reads the stage arrives)
  const uint32_t bars = stages + 2 * L::STAGE;
  float* row_state =
      reinterpret_cast<float*>(smem_raw + (bars + L::kBars - raw));
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;     // causal: longest CTAs first
  const int q0 = qt * kRows;
  const int key_tiles = (seq + kBlockK - 1) / kBlockK;
  const int n_k = causal ? min((q0 + kRows) / kBlockK, key_tiles)
                         : key_tiles;

  if (tid == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bars + 8 + 8 * st, 1);
      mbar_init(bars + 24 + 8 * st, 1);
      mbar_init(bars + 40 + 8 * st, kReaders);
      mbar_init(bars + 56 + 8 * st, kReaders);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer warpgroup: one thread loads Q, then K and V of each key
    // tile j into its stage once the stage's last tile, j - 2, is read
    setmaxnreg_dec<24>();
    if (tid == 256) {
      const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v;
      mbar_expect_tx(bars, kRows * L::D * 2);
      tma_tile256(qs, mq, bars, q0, bh, kQBlock);
      for (int j = 0; j < n_k; ++j) {
        const int st = j & 1;
        const uint32_t ks = stages + st * L::STAGE;
        const uint32_t freed = ((j >> 1) - 1) & 1;
        if (j >= 2) mbar_wait(bars + 40 + 8 * st, freed);
        mbar_expect_tx(bars + 8 + 8 * st, L::TILE);
        tma_tile256(ks, mk, bars + 8 + 8 * st, j * kBlockK, bh, L::BLOCK);
        if (j >= 2) mbar_wait(bars + 56 + 8 * st, freed);
        mbar_expect_tx(bars + 24 + 8 * st, L::TILE);
        tma_tile256(ks + L::TILE, mv, bars + 24 + 8 * st, j * kBlockK, bh,
                    L::BLOCK);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // this warpgroup's rows start at r0w; this thread's: r0w + row, + 8
  const int r0w = q0 + (kSplit ? 0 : 64 * wg);
  const int row = 16 * warp + g;
  const uint32_t qa = qs + (kSplit ? 0 : 64 * wg * L::RB);
  const float sl2 = scale * kLog2e;
  float acc[128];                      // O, unnormalised, all 256 columns
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units
  // this warpgroup's key tiles: j0, j0 + step, .. below j_end. Causal:
  // the first warpgroup's rows end before the CTA's last tile, which it
  // leaves (no later tile needs that stage, so it does not release it)
  const int step = kSplit ? 2 : 1, j0 = kSplit ? wg : 0;
  const int j_end =
      !kSplit && causal && (n_k - 1) * kBlockK > r0w + 63 ? n_k - 1 : n_k;

  // S = Q K^T of tile j into s (K-major operands in shared memory)
  auto scores = [&](int j, float (&s)[32]) {
    const int st = j & 1;
    mbar_wait(bars + 8 + 8 * st, (j >> 1) & 1);   // K of tile j
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss_n64(s, kmajor256(qa, 0, kk, kQBlock),
                   kmajor256(stages + st * L::STAGE, 0, kk, L::BLOCK),
                   kk > 0);
    wgmma_commit();
  };
  // O += P V of tile j, all 256 columns: V read MN-major
  auto add_pv = [&](int j, const uint32_t (&pf)[4][4]) {
    const int st = j & 1;
    const uint32_t vs = stages + st * L::STAGE + L::TILE;
    mbar_wait(bars + 24 + 8 * st, (j >> 1) & 1);  // V of tile j
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<256>(acc, pf[kk],
                       wgmma_desc(vs + kk * 16 * L::RB, L::BLOCK, L::SBO,
                                  L::RB));
    wgmma_commit();
  };
  // the online softmax of tile j's scores in s: p = exp2(s sl2 - m) in
  // place, l and m updated; -> alpha, O's factor
  auto softmax = [&](int j, float (&s)[32], float (&alpha)[2]) {
    const int k0 = j * kBlockK;
    const bool edge = (causal && k0 + kBlockK - 1 > r0w) ||
                      k0 + kBlockK > seq;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float x = s[e] * sl2;
      if (edge) {
        // a query row past seq is never stored: only keys are masked
        const int c = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (c >= seq || (causal && c > r0w + row + 8 * i)) x = kNegInf;
      }
      s[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      s[e] = exp2f(s[e] - m[i]);
      sum[i] += s[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
  };
  // P as A fragments of P V, keys 16 kk .., rounded to bf16
  auto pack = [&](const float (&s)[32], uint32_t (&pf)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };

  mbar_wait(bars, 0);                  // Q has landed
  if (j0 < j_end) {
    float s[32], alpha[2];             // S: 64 rows x 64 keys
    uint32_t pf[4][4];
    scores(j0, s);
    wgmma_wait<0>();
    fence_operands(s);
    mbar_arrive(bars + 40 + 8 * (j0 & 1));   // K of tile j0 is read
    softmax(j0, s, alpha);             // O is still 0: no rescale
    pack(s, pf);
    for (int j = j0 + step; j < j_end; j += step) {
      const int jp = j - step;
      if (kSplit) {
        // one stage a warpgroup: P V of the tile before goes first, so
        // that its V is free for the next load under this tile's S
        add_pv(jp, pf);
        wgmma_wait<0>();
        fence_operands(acc);
        mbar_arrive(bars + 56 + 8 * (jp & 1));   // V of tile jp is read
        scores(j, s);
        wgmma_wait<0>();
        fence_operands(s);
        mbar_arrive(bars + 40 + 8 * (j & 1));    // K of tile j is read
        softmax(j, s, alpha);
      } else {
        // S of tile j goes to the tensor cores before P V of the tile
        // before, so that tile j's softmax runs under that P V
        scores(j, s);
        add_pv(jp, pf);
        wgmma_wait<1>();
        fence_operands(s);
        mbar_arrive(bars + 40 + 8 * (j & 1));    // K of tile j is read
        softmax(j, s, alpha);
        wgmma_wait<0>();
        fence_operands(acc);
        mbar_arrive(bars + 56 + 8 * (jp & 1));   // V of tile jp is read
      }
      // O's rescale, left out by a warp whose rows kept their max (a
      // factor of 1 is exact either way)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < 128; ++e) acc[e] *= alpha[(e >> 1) & 1];
      }
      pack(s, pf);
    }
    const int jl = j0 + (j_end - 1 - j0) / step * step;   // the last
    add_pv(jl, pf);
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(bars + 56 + 8 * (jl & 1));     // V of tile jl is read
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (kSplit) {
    // the second warpgroup hands its (m, l, O) to the first through stage
    // 1 (only it read that stage, and it has read it to the end) and the
    // row state; the first adds them to its own, its own first, in f32
    float* part =
        reinterpret_cast<float*>(smem_raw + (stages + L::STAGE - raw));
    const int slot = tid & 127;
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < 128; ++e) part[e * 128 + slot] = acc[e];
      if (t == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          row_state[row + 8 * i] = m[i];
          row_state[64 + row + 8 * i] = l[i];
        }
      named_bar_arrive(3, 256);
      return;
    }
    named_bar_sync(3, 256);
    float a0[2], a1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = row_state[row + 8 * i];
      const float mm = fmaxf(m[i], m1);
      a0[i] = exp2f(m[i] - mm);
      a1[i] = exp2f(m1 - mm);
      l[i] = l[i] * a0[i] + row_state[64 + row + 8 * i] * a1[i];
      m[i] = mm;
    }
#pragma unroll
    for (int e = 0; e < 128; ++e) {
      const int i = (e >> 1) & 1;
      acc[e] = acc[e] * a0[i] + part[e * 128 + slot] * a1[i];
    }
  }

  const long long r0 = static_cast<long long>(bh) * seq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0w + row + 8 * i;
    if (r >= seq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    bf16* orow = o + (r0 + r) * L::D + 2 * t;
#pragma unroll
    for (int n = 0; n < 32; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(acc[4 * n + 2 * i] / lc, acc[4 * n + 2 * i + 1] / lc);
    if (t == 0) lse[r0 + r] = m[i] * kLn2 + logf(lc);
  }
}

// f32 storage: split TF32 on the tensor cores (the note at the top).

// Tiles of the f32 mma.sync forward, head_dim 16 alone (floats;
// flash_tf32.cuh)
template <int D>
struct Tf32FwdTiles {
  static_assert(D == 16,
                "f32 head_dim 32-128 runs wgmma, 256 its cluster kernel");
  static constexpr int KT = 64;                    // keys a tile
  static constexpr int STAGES = 2;                 // K/V tiles in flight
  static constexpr int LD = D + 4;                 // row stride of a tile
  static constexpr int STAGE = 2 * KT * LD;        // K then V
  static constexpr size_t kSmem =
      sizeof(float) * (kBlockQ * LD + STAGES * STAGE);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int seq, float scale,
                          int causal) {
  using L = Tf32FwdTiles<D>;
  constexpr int KT = L::KT, LD = L::LD;
  constexpr int NT = KT / 8, NO = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;                          // this CTA's 64 queries
  float* kv = qs + kBlockQ * LD;             // stage st: K, then V
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * kBlockQ;
  const long long base = static_cast<long long>(blockIdx.x) * seq * D;
  q += base;
  k += base;
  v += base;
  o += base;
  lse += static_cast<long long>(blockIdx.x) * seq;
  const int tiles = (seq + KT - 1) / KT;
  // causal: key tiles wholly above the diagonal are skipped
  const int n_k = causal ? min(tiles, (q0 + kBlockQ) / KT) : tiles;

  auto load_kv = [&](int j) {
    float* dst = kv + (j % L::STAGES) * L::STAGE;
    cp_async_f32<KT, D, LD>(dst, k, D, j * KT, 0, seq);
    cp_async_f32<KT, D, LD>(dst + KT * LD, v, D, j * KT, 0, seq);
  };
  cp_async_f32<kBlockQ, D, LD>(qs, q, D, q0, 0, seq);
  for (int j = 0; j < L::STAGES - 1; ++j) {   // Q lands with tile 0
    if (j < n_k) load_kv(j);
    cp_async_commit();
  }

  float acc[NO][4] = {};                     // O, unnormalised
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_k; ++j) {
    if (j + L::STAGES - 1 < n_k) load_kv(j + L::STAGES - 1);
    cp_async_commit();
    cp_async_wait<L::STAGES - 1>();          // tile j has landed
    __syncthreads();
    const float* ks = kv + (j % L::STAGES) * L::STAGE;
    const float* vs = ks + KT * LD;
    float s[NT][4];                          // S: 16 rows x KT keys
    dot_tiles<LD, D / 8>(s, qs, w0, ks, 0, g, t);
    const int k0 = j * KT;
    const bool edge = (causal && k0 + KT > q0 + 1) || k0 + KT > seq;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[n][e] * scale;
        if (edge) {
          // a query row past seq is never stored: only keys are masked
          const int c = k0 + n * 8 + 2 * t + (e & 1);
          if (c >= seq || (causal && c > q0 + w0 + g + 8 * i)) x = kNegInf;
        }
        s[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    uint32_t ph[NT][4], pl[NT][4];           // O += P V
    split_c_tiles(ph, pl, s);
    mul_tiles<LD>(acc, ph, pl, vs, 0, 0, g, t);
    __syncthreads();                         // tile j's stage is free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = q0 + w0 + g + 8 * i;
    if (r >= seq) continue;
    const float lc = fmaxf(lt, 1e-30f);
    float* orow = o + static_cast<long long>(r) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    if (t == 0) lse[r] = m[i] + logf(lc);
  }
}

// f32 storage at head_dim 32-128: split TF32 on wgmma (the note at the
// top).

constexpr int kTf32FwdThreads = 384;   // a producer warpgroup, two consumer
                                       // warpgroups

// Shared memory of the f32 wgmma forward (bytes): f32 tiles in 32-float
// column blocks of 128-byte rows in the 128-byte swizzle (f32_at).
template <int D>
struct Tf32WgFwdTiles {
  static_assert(D >= 32 && D <= 128,
                "f32 head_dim 16 runs flash_fwd_tf32_kernel, 256 "
                "flash_fwd_tf32_wgmma256_kernel");
  static constexpr int QTILE = 128 * D * 4;    // the CTA's 128 queries
  static constexpr int KTILE = 64 * D * 4;     // a 64-key tile of K or V
  static constexpr int VT = D * 64 * 4;        // V^T: D rows of 64 keys
  // Q; K, its lo and V as TMA lands it; V^T hi and lo; seven mbarriers;
  // 1024 bytes to align the tiles
  static constexpr size_t kSmem = QTILE + 3 * KTILE + 2 * VT + 64 + 1024;
};

// V^T of a 64-key tile, hi and lo (split_tf32), from V [key][d] as TMA
// wrote it, by the producer warpgroup's thread p of 128: V^T [d][key] is
// the K-major B operand of O += P V, the keys of each group of 8 in the
// order 0, 2, 4, 6, 1, 3, 5, 7, the k order in which P's A fragments
// come from S's accumulators (frag_c_as_a). A thread moves 4 x 4 blocks:
// keys 2 j + odd (j 0..3) of a group of 8 by 4 columns of d, 16 bytes
// from each key's row and 16 to each of the 4 rows of V^T. A warp's lanes
// run over (group, odd, column chunk), so its reads and its writes are
// 4 wavefronts each, free of bank conflicts.
template <int D>
__device__ __forceinline__ void transpose_v(unsigned char* hi,
                                            unsigned char* lo,
                                            const unsigned char* v, int p) {
  constexpr int DB = D / 32;                   // V's column blocks
#pragma unroll
  for (int n = 0; n < DB; ++n) {
    const int it = p + 128 * n;
    const int grp = it & 3, odd = (it >> 2) & 1, cc = (it >> 3) & 3;
    const int par = (it >> 5) & 1, cb = (it >> 6) % DB, kb = (it >> 6) / DB;
    const int c = 32 * cb + 4 * (2 * cc + par);   // the block's columns
    const int key = 32 * kb + 8 * grp + odd;      // its keys: + 2 j
    float x[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 r =
          *reinterpret_cast<const float4*>(v + f32_at(64, key + 2 * j, c));
      x[j][0] = r.x;
      x[j][1] = r.y;
      x[j][2] = r.z;
      x[j][3] = r.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float y[4] = {x[0][i], x[1][i], x[2][i], x[3][i]};
      uint32_t h[4], l[4];
      split_tf32(y, h, l);
      const uint32_t at = f32_at(D, c + i, 32 * kb + 8 * grp + 4 * odd);
      *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTf32FwdThreads, 1)
    flash_fwd_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                float* __restrict__ o,
                                float* __restrict__ lse, int seq,
                                float scale, int causal) {
  using L = Tf32WgFwdTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;   // the CTA's 128 queries
  const uint32_t ks = qs + L::QTILE, klo = ks + L::KTILE;   // key tile j
  const uint32_t vland = klo + L::KTILE;   // V of tile j as TMA wrote it
  const uint32_t vth = vland + L::KTILE, vtl = vth + L::VT;   // V^T hi, lo
  // mbarriers: +0 Q landed; +8 K landed, +16 V landed; +24 K's lo
  // written, +32 V^T written (the producer's 128 threads arrive); +40 K
  // read, +48 V^T read (the consumers' 256)
  const uint32_t bars = vtl + L::VT;
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * 128;
  const int key_tiles = (seq + 63) / 64;
  // causal: key tiles wholly above the diagonal are skipped
  const int n_k = causal ? min(key_tiles, 2 * qt + 2) : key_tiles;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init(bars + 24, 128);
    mbar_init(bars + 32, 128);
    mbar_init(bars + 40, 256);
    mbar_init(bars + 48, 256);
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 2) {
    // the producer: one thread loads Q, then K and V of each key tile (K
    // once both consumers' S of the tile before is done, V once the
    // transpose has read its slot); all 128 write K's lo and V^T
    setmaxnreg_dec<40>();
    const int p = tid - 256;
    auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                    int j) {
      mbar_expect_tx(bar, L::KTILE);
      f32_load<D>(dst, map, bar, 64, j * 64, bh);
    };
    if (p == 0) {
      mbar_expect_tx(bars, L::QTILE);
      f32_load<D>(qs, &tm_q, bars, 128, q0, bh);
      load(ks, &tm_k, bars + 8, 0);
      load(vland, &tm_v, bars + 16, 0);
    }
    for (int j = 0; j < n_k; ++j) {
      // the tiles' addresses are rebuilt each tile from an opaque p, not
      // held across the loop in 40 registers
      const int i = static_cast<int>(opaque(p));
      mbar_wait(bars + 8, j & 1);              // K of tile j has landed
      split_lo(at(klo), at(ks), L::KTILE, i, 128);
      fence_proxy_async();
      mbar_arrive(bars + 24);
      mbar_wait(bars + 16, j & 1);             // V of tile j has landed
      if (j > 0) mbar_wait(bars + 48, (j - 1) & 1);   // V^T of j - 1 read
      transpose_v<D>(at(vth), at(vtl), at(vland), i);
      fence_proxy_async();
      mbar_arrive(bars + 32);
      named_bar_sync(1, 128);                  // V's slot is read
      if (p == 0 && j + 1 < n_k) {
        load(vland, &tm_v, bars + 16, j + 1);
        mbar_wait(bars + 40, j & 1);           // K of tile j is read
        load(ks, &tm_k, bars + 8, j + 1);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  // this warpgroup's 64 queries start at r0w; this thread's rows: r0w +
  // row, + 8. Causal: the first warpgroup's rows end before the CTA's
  // last key tile, which it leaves (no later tile needs its slots)
  const int r0w = q0 + 64 * wg, row = 16 * warp + g;
  const int j_end = causal && (n_k - 1) * 64 > r0w + 63 ? n_k - 1 : n_k;
  float acc[D / 2], chunk[D / 2];              // O, unnormalised; P V
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(bars, 0);                          // Q has landed

  for (int j = 0; j < j_end; ++j) {
    // the tiles' addresses and descriptors are rebuilt each tile (a few
    // integer adds), not held across the loop in registers
    const unsigned char* qp = at(opaque(qs));
    const uint32_t kt = opaque(ks), vt = opaque(vth);
    // S = Q K^T (64 queries x 64 keys): Q gathered and split in
    // registers, K as TMA wrote it and its lo; one tensor-core sum over D
    float s[32];
    mbar_wait(bars + 24, j & 1);               // K of tile j and its lo
    product_3xtf32<64, D / 8>(
        s,
        [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          frag_mk(hi, lo, qp, 128, 64 * wg + 16 * warp, kk, g, t);
        },
        [&](int kk, bool low) {
          return f32_kmajor(low ? kt + L::KTILE : kt, 64, 0, kk);
        });
    wgmma_wait<0>();
    fence_operands(s);
    mbar_arrive(bars + 40);                    // K of tile j is read

    // the online softmax in natural units, S scaled after its product:
    // register e is row + 8 ((e >> 1) & 1), key 8 (e >> 2) + 2 t + (e & 1)
    const int k0 = j * 64;
    const bool edge = (causal && k0 + 63 > r0w) || k0 + 64 > seq;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float x = s[e] * scale;
      if (edge) {
        // a query row past seq is never stored: only keys are masked
        const int c = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (c >= seq || (causal && c > r0w + row + 8 * i)) x = kNegInf;
      }
      s[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      s[e] = expf(s[e] - m[i]);
      sum[i] += s[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];

    // O += P V: P split from S's accumulators as the A fragments of the 8
    // k-steps, V^T hi and lo from the producer; one tensor-core sum a key
    // tile, added to O in f32 after O's rescale
    mbar_wait(bars + 32, j & 1);               // V^T of tile j
    product_3xtf32<D, 8>(
        chunk,
        [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          const float c[4] = {s[4 * kk], s[4 * kk + 1], s[4 * kk + 2],
                              s[4 * kk + 3]};
          frag_c_as_a(hi, lo, c);
        },
        [&](int kk, bool low) {
          return f32_kmajor(low ? vt + L::VT : vt, D, 0, kk);
        });
    wgmma_wait<0>();
    fence_operands(chunk);
    mbar_arrive(bars + 48);                    // V^T of tile j is read
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      acc[e] = acc[e] * alpha[(e >> 1) & 1] + chunk[e];
  }

  const long long r0 = static_cast<long long>(bh) * seq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = r0w + row + 8 * i;
    if (r >= seq) continue;
    const float lc = fmaxf(lt, 1e-30f);
    float* orow = o + (r0 + r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[4 * n + 2 * i] / lc, acc[4 * n + 2 * i + 1] / lc);
    if (t == 0) lse[r0 + r] = m[i] + logf(lc);
  }
}

// f32 storage at head_dim 256 (and 129-255, zero-padded): split TF32 on
// wgmma in clusters of two CTAs (the note at the top).

constexpr int kTf32ClusterQueries = 64;   // a head_dim-256 cluster's queries

// Shared memory of the f32 head_dim-256 forward (bytes): a rank's tiles of
// the head_dim-128 wgmma kernel over its 128 columns (f32_at), its
// exchange buffers in the slot layout of flash_cluster.cuh.
struct Tf32ClusterFwdTiles {
  static constexpr int W = 128;                // columns of a rank
  static constexpr int QTILE = 64 * W * 4;     // the cluster's 64 queries
  static constexpr int KTILE = 64 * W * 4;     // a 64-key tile of K or V
  static constexpr int VT = W * 64 * 4;        // V^T: 128 rows of 64 keys
  static constexpr int XCH = 16 * 128 * 4;     // 16 f32 a consumer thread
  static constexpr int PTILE = 32 * 128 * 4;   // 32 f32 a consumer thread
  static constexpr int ROWS = 2 * 128 * 4;     // 2 f32 a consumer thread
  // what a rank receives of a tile's P and alpha from the other: 16 P
  // values and one alpha of each of its 128 threads of warpgroup 0
  static constexpr int PMSG = 128 * (16 + 1) * 4;
  // Q; K, its lo and V as TMA lands them; V^T hi and lo; the received
  // partial scores; P, alpha and l of the 64 rows (alpha and l one a
  // thread and row half); twelve mbarriers; 1024 bytes to align the tiles
  static constexpr size_t kSmem =
      QTILE + 3 * KTILE + 2 * VT + XCH + PTILE + 2 * ROWS + 128 + 1024;
};

__global__ void __launch_bounds__(kTf32FwdThreads, 1)
    flash_fwd_tf32_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   float* __restrict__ o,
                                   float* __restrict__ lse, int seq,
                                   float scale, int causal) {
  using L = Tf32ClusterFwdTiles;
  constexpr int D = 256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;   // the cluster's 64 queries
  const uint32_t ks = qs + L::QTILE, klo = ks + L::KTILE;   // key tile j
  const uint32_t vland = klo + L::KTILE;   // V of tile j as TMA wrote it
  const uint32_t vth = vland + L::KTILE, vtl = vth + L::VT;   // V^T hi, lo
  // the other rank's partial of this rank's half of S; P of both halves
  // (warpgroup 0's to warpgroup 1, the other rank's half by st.async);
  // alpha and, at the end, l of both halves
  const uint32_t rs = vtl + L::VT, pt = rs + L::XCH;
  const uint32_t al = pt + L::PTILE, ls = al + L::ROWS;
  // mbarriers: +0 Q landed; +8 K landed, +16 V landed; +24 K's lo written
  // (the K warps' 64), +32 V^T written (the V warps' 64); +40 K read
  // (warpgroup 0), +48 V^T read (warpgroup 1); +56 the partial received;
  // +64 this rank's half of P and alpha written (warpgroup 0), +72 the
  // other rank's received, +80 P and alpha read (warpgroup 1); +88 l of
  // both halves whole
  const uint32_t bars = ls + L::ROWS;
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3, w = tid & 127;
  const int bh = blockIdx.y, col0 = L::W * rank;   // this rank's columns
  const int qt = gridDim.z - 1 - blockIdx.z;   // causal: longest first
  const int q0 = qt * kTf32ClusterQueries;
  const int key_tiles = (seq + 63) / 64;
  // causal: key tiles wholly above the diagonal are skipped
  const int n_k = causal ? min(key_tiles, qt + 1) : key_tiles;
  const long long rows0 = static_cast<long long>(bh) * seq;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init(bars + 24, 64);
    mbar_init(bars + 32, 64);
    for (int i = 0; i < 2; ++i) mbar_init(bars + 40 + 8 * i, 128);
    mbar_init(bars + 56, 1);
    mbar_init(bars + 64, 128);
    mbar_init(bars + 72, 1);
    mbar_init(bars + 80, 128);
    mbar_init(bars + 88, 129);
    mbar_fence_init();
    // the received bytes of key tile 0 and of l, armed before any rank
    // can send them
    mbar_expect_tx(bars + 56, L::XCH);
    mbar_expect_tx(bars + 72, L::PMSG);
    mbar_expect_tx(bars + 88, L::ROWS / 2);
  }
  cluster_sync_any();                  // both ranks run, mbarriers set
  if (wg == 2) {
    // the producer: warps 0-1 load Q and K of each key tile (K once
    // warpgroup 0's S of the tile before is done) and write K's lo;
    // warps 2-3 load V of each key tile (once the transpose has read the
    // tile before) and write V^T hi and lo
    setmaxnreg_dec<40>();
    const int p = (tid - 256) & 63;
    if (tid < 320) {
      if (p == 0) {
        mbar_expect_tx(bars, L::QTILE);
        f32_load<L::W>(qs, &tm_q, bars, 64, q0, bh, col0);
        mbar_expect_tx(bars + 8, L::KTILE);
        f32_load<L::W>(ks, &tm_k, bars + 8, 64, 0, bh, col0);
      }
      for (int j = 0; j < n_k; ++j) {
        const int i = static_cast<int>(opaque(p));
        mbar_wait(bars + 8, j & 1);            // K of tile j has landed
        split_lo(at(klo), at(ks), L::KTILE, i, 64);
        fence_proxy_async();
        mbar_arrive(bars + 24);
        if (p == 0 && j + 1 < n_k) {
          mbar_wait(bars + 40, j & 1);         // K of tile j is read
          mbar_expect_tx(bars + 8, L::KTILE);
          f32_load<L::W>(ks, &tm_k, bars + 8, 64, (j + 1) * 64, bh, col0);
        }
      }
    } else {
      if (p == 0) {
        mbar_expect_tx(bars + 16, L::KTILE);
        f32_load<L::W>(vland, &tm_v, bars + 16, 64, 0, bh, col0);
      }
      for (int j = 0; j < n_k; ++j) {
        const int i = static_cast<int>(opaque(p));
        mbar_wait(bars + 16, j & 1);           // V of tile j has landed
        if (j > 0) mbar_wait(bars + 48, (j - 1) & 1);   // V^T of j - 1 read
        transpose_v<L::W>(at(vth), at(vtl), at(vland), i);
        transpose_v<L::W>(at(vth), at(vtl), at(vland), i + 64);
        fence_proxy_async();
        mbar_arrive(bars + 32);
        named_bar_sync(1, 64);                 // V's slot is read
        if (p == 0 && j + 1 < n_k) {
          mbar_expect_tx(bars + 16, L::KTILE);
          f32_load<L::W>(vland, &tm_v, bars + 16, 64, (j + 1) * 64, bh,
                         col0);
        }
      }
    }
  } else if (wg == 0) {
    // warpgroup 0: the partial S = Q K^T over this rank's 128 columns
    // (64 queries x 64 keys), its rows g + 8 rank of each warp's 16 (the
    // registers of row_half_of(rank)) finished here, the others by the
    // other rank: the half it finishes there sent to its twin thread,
    // the half it finishes here received from it and added in rank
    // order, scaled, masked and through the online softmax in natural
    // units (expf, as the plain version); P and alpha of those rows
    // written here and sent to the other rank, for both ranks' P V
    setmaxnreg_inc<232>();
    const int row = q0 + 16 * warp + g + 8 * rank;   // this thread's row
    float m = kNegInf, l = 0.f;
    mbar_wait(bars, 0);                        // Q has landed
    for (int j = 0; j < n_k; ++j) {
      // the tiles' addresses are rebuilt each tile from opaque values
      const unsigned char* qp = at(opaque(qs));
      const uint32_t kt = opaque(ks);
      float s[32];
      mbar_wait(bars + 24, j & 1);             // K of tile j and its lo
      product_3xtf32<64, L::W / 8>(
          s,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
            frag_mk(hi, lo, qp, 64, 16 * warp, kk, g, t);
          },
          [&](int kk, bool low) {
            return f32_kmajor(low ? kt + L::KTILE : kt, 64, 0, kk);
          });
      wgmma_wait<0>();
      fence_operands(s);
      mbar_arrive(bars + 40);                  // K of tile j is read
      if (j > 0) {
        // the other rank has read the partial of tile j - 1 (it sent
        // P of j - 1 after) and warpgroup 1 this rank's P of j - 1: the
        // buffers take tile j
        mbar_wait_cluster(bars + 72, (j - 1) & 1);
        mbar_wait(bars + 80, (j - 1) & 1);
        if (w == 0) mbar_expect_tx(bars + 72, L::PMSG);
      }
      {  // the other rank's half of the partial, to it
        float theirs[16];
        row_half_of(theirs, s, rank ^ 1);
        xch_send(theirs, rs, bars + 56, rank ^ 1, w);
      }
      float x[16], mine[16];                   // this row over all of D
      row_half_of(mine, s, rank);
      mbar_wait_cluster(bars + 56, j & 1);
      if (w == 0 && j + 1 < n_k) mbar_expect_tx(bars + 56, L::XCH);
      summed_half(x, mine, at(rs), rank, w);

      // x[2 n + b]: key 8 n + 2 t + b of the tile
      const int k0 = j * 64;
      const bool edge = (causal && k0 + 63 > q0) || k0 + 64 > seq;
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        float y = x[e] * scale;
        if (edge) {
          // a query row past seq is never stored: only keys are masked
          const int c = k0 + 8 * (e >> 1) + 2 * t + (e & 1);
          if (c >= seq || (causal && c > row)) y = kNegInf;
        }
        x[e] = y;
        mx = fmaxf(mx, y);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      m = m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        x[e] = expf(x[e] - m);
        sum += x[e];
      }
      l = l * alpha + sum;

      // P (registers 4 n + 2 rank + b of the tile's accumulator: words
      // 2 rank + b of slot n) and alpha, here and in the other rank
      const uint32_t ptw = opaque(pt) + w * 16 + 8 * rank;
      const uint32_t alw = al + (rank * 128 + w) * 4;
      const uint32_t rbar = mapa_u32(bars + 72, rank ^ 1);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t v[2] = {__float_as_uint(x[2 * n]),
                               __float_as_uint(x[2 * n + 1])};
        *reinterpret_cast<float2*>(at(ptw + n * 128 * 16)) =
            make_float2(x[2 * n], x[2 * n + 1]);
        st_async(mapa_u32(ptw + n * 128 * 16, rank ^ 1), v, rbar);
      }
      *reinterpret_cast<float*>(at(alw)) = alpha;
      {
        const uint32_t v[1] = {__float_as_uint(alpha)};
        st_async(mapa_u32(alw, rank ^ 1), v, rbar);
      }
      mbar_arrive(bars + 64);
    }

    // l of this row, and LSE; l to warpgroup 1 of both ranks
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lc = fmaxf(l, 1e-30f);
    if (t == 0 && row < seq) lse[rows0 + row] = m + logf(lc);
    const uint32_t lsw = ls + (rank * 128 + w) * 4;
    *reinterpret_cast<float*>(at(lsw)) = lc;
    const uint32_t v[1] = {__float_as_uint(lc)};
    st_async(mapa_u32(lsw, rank ^ 1), v, mapa_u32(bars + 88, rank ^ 1));
    mbar_arrive(bars + 88);
  } else {
    // warpgroup 1: O += P V over this rank's 128 columns for all 64
    // queries, P split from the 32 values of its twin thread of
    // warpgroup 0 (the accumulator's order: P's A fragments without a
    // shuffle), V^T hi and lo from the producer; one tensor-core sum a key
    // tile, added in f32 to O scaled by alpha
    setmaxnreg_inc<232>();
    float acc[64], chunk[64];                  // O, unnormalised; P V
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int j = 0; j < n_k; ++j) {
      const uint32_t vt = opaque(vth);
      float p[32], alpha[2];
      mbar_wait(bars + 64, j & 1);             // this rank's half of P
      mbar_wait_cluster(bars + 72, j & 1);     // the other rank's
      xch_read(p, at(opaque(pt)), w);
      {
        const float* a = reinterpret_cast<const float*>(at(al));
        alpha[0] = a[w];
        alpha[1] = a[128 + w];
      }
      mbar_arrive(bars + 80);                  // P and alpha are read
      mbar_wait(bars + 32, j & 1);             // V^T of tile j
      product_3xtf32<L::W, 8>(
          chunk,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
            const float c[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                p[4 * kk + 3]};
            frag_c_as_a(hi, lo, c);
          },
          [&](int kk, bool low) {
            return f32_kmajor(low ? vt + L::VT : vt, L::W, 0, kk);
          });
      wgmma_wait<0>();
      fence_operands(chunk);
      mbar_arrive(bars + 48);                  // V^T of tile j is read
#pragma unroll
      for (int e = 0; e < 64; ++e)
        acc[e] = acc[e] * alpha[(e >> 1) & 1] + chunk[e];
    }

    mbar_wait_cluster(bars + 88, 0);           // l of both halves
    const float* lsp = reinterpret_cast<const float*>(at(ls));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + 16 * warp + g + 8 * i;
      if (r >= seq) continue;
      const float lc = lsp[i * 128 + w];
      float* orow = o + (rows0 + r) * D + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < L::W / 8; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[4 * n + 2 * i] / lc, acc[4 * n + 2 * i + 1] / lc);
    }
  }
  cluster_sync_any();                  // no rank exits under the other's
                                       // exchanges
}

// bf16 storage takes the wgmma kernels (head_dim 256 its own); f32 the
// split-TF32 wgmma kernel at head_dim 32-128, its cluster kernel at 256,
// and the split-TF32 mma.sync kernel at 16
template <typename T>
constexpr bool kWgmma = std::is_same<T, bf16>::value;
template <typename T, int D>
constexpr bool kWgmma256 = kWgmma<T> && D == 256;
template <typename T, int D>
constexpr bool kTf32Wgmma = !kWgmma<T> && D >= 32 && D <= 128;
template <typename T, int D>
constexpr bool kTf32Cluster = !kWgmma<T> && D == 256;
// threads of a forward CTA of storage T at head_dim D
template <typename T, int D>
constexpr int kFwdThreadsOf =
    kWgmma256<T, D>                               ? kFwd256Threads
    : kWgmma<T>                                   ? kWgThreads
    : kTf32Wgmma<T, D> || kTf32Cluster<T, D>      ? kTf32FwdThreads
                                                  : kMmaThreads;

// Launch a forward kernel on TMA of storage T at head_dim D over a (bh,
// ceil(seq / q_rows)) grid with `bytes` of dynamic shared memory (the f32
// cluster kernel at 256: a (2, bh, ceil(seq / q_rows)) grid of clusters
// of two CTAs along x, launch_cluster), its first arguments the tensor
// maps of q, k and v with boxes of q_rows and kv_rows rows; -> the
// launch's error code.
template <typename T, int D, typename Kernel>
int launch_tma(Kernel fn, const void* const (&src)[3], int q_rows,
               int kv_rows, size_t bytes, T* o, float* lse, int bh, int seq,
               float scale, int causal, cudaStream_t stream) {
  const int tiles = (seq + q_rows - 1) / q_rows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = rows_map<T>(&maps[i], src[i], D, seq, bh,
                                        i == 0 ? q_rows : kv_rows);
    if (err != cudaSuccess) return err;
  }
  if constexpr (kTf32Cluster<T, D>) {
    if (bh > 65535) return cudaErrorInvalidValue;
    // the tile axis slowest
    return launch_cluster(fn, dim3(kTf32Ranks, bh, tiles),
                          kFwdThreadsOf<T, D>, bytes, stream, maps[0],
                          maps[1], maps[2], o, lse, seq, scale, causal);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  fn<<<dim3(bh, tiles), kFwdThreadsOf<T, D>, bytes, stream>>>(
      maps[0], maps[1], maps[2], o, lse, seq, scale, causal);
  return cudaGetLastError();
}

struct ForwardLaunch {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int bh, seq;
  float scale;
  int causal;
  cudaStream_t stream;

  template <typename T, int D>
  static auto kernel() {
    if constexpr (kWgmma256<T, D>)
      return flash_fwd_wgmma256_kernel<false>;
    else if constexpr (kWgmma<T>)
      return flash_fwd_wgmma_kernel<D>;
    else if constexpr (kTf32Wgmma<T, D>)
      return flash_fwd_tf32_wgmma_kernel<D>;
    else if constexpr (kTf32Cluster<T, D>)
      return flash_fwd_tf32_wgmma256_kernel;
    else
      return flash_fwd_tf32_kernel<D>;
  }

  template <typename T, int D>
  static size_t smem() {
    if constexpr (kWgmma256<T, D>)
      return Fwd256Tiles::smem(false);
    else if constexpr (kWgmma<T>)
      return WgTiles<D>::kSmem;
    else if constexpr (kTf32Wgmma<T, D>)
      return Tf32WgFwdTiles<D>::kSmem;
    else if constexpr (kTf32Cluster<T, D>)
      return Tf32ClusterFwdTiles::kSmem;
    else
      return Tf32FwdTiles<D>::kSmem;
  }

  template <typename T, int D>
  int run() const {
    const void* const src[3] = {q, k, v};
    T* out = static_cast<T*>(o);
    if constexpr (kWgmma256<T, D>) {
      // fewer 128-row CTAs than the card has SMs: the split variant's
      // 64-row CTAs, twice as many
      int dev = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return err;
      const long long ctas = static_cast<long long>(bh) * ((seq + 127) / 128);
      return ctas < sms
                 ? launch_tma<T, D>(flash_fwd_wgmma256_kernel<true>, src, 64,
                                    kBlockK, Fwd256Tiles::smem(true), out,
                                    lse, bh, seq, scale, causal, stream)
                 : launch_tma<T, D>(kernel<T, D>(), src, 128, kBlockK,
                                    smem<T, D>(), out, lse, bh, seq, scale,
                                    causal, stream);
    } else if constexpr (kWgmma<T>) {
      return launch_tma<T, D>(kernel<T, D>(), src, kWgRows, kWgKeys,
                              smem<T, D>(), out, lse, bh, seq, scale, causal,
                              stream);
    } else if constexpr (kTf32Wgmma<T, D> || kTf32Cluster<T, D>) {
      // 128 queries a CTA (at 256: 64 a cluster), 64-key tiles
      constexpr int rows = kTf32Cluster<T, D> ? kTf32ClusterQueries : 128;
      return launch_tma<T, D>(kernel<T, D>(), src, rows, 64, smem<T, D>(),
                              out, lse, bh, seq, scale, causal, stream);
    } else {
      return launch_mma(kernel<T, D>(), bh, seq, smem<T, D>(), stream,
                        static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v), out, lse, seq, scale,
                        causal);
    }
  }
};

// What the runtime says of the forward kernel for (dtype, head_dim) at its
// own thread count: registers a thread, local memory a thread (spills),
// dynamic shared memory and resident CTAs per SM, into out[0..3]; out[4]
// the cluster size, out[5] co-resident clusters (1 and 0 without a
// cluster: all but the f32 head_dim-256 kernel, fill_info of
// flash_wide.cuh). bf16 at head_dim 256: the 128-row kernel's, but
// registers and local memory the larger of its and the split variant's.
struct ForwardInfo {
  int* out;

  template <typename Kernel>
  static cudaError_t attributes(Kernel fn, size_t bytes,
                                cudaFuncAttributes* attr) {
    cudaError_t err = cudaFuncGetAttributes(attr, fn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
    return err;
  }

  template <typename T, int D>
  int run() const {
    const auto fn = ForwardLaunch::kernel<T, D>();
    const size_t bytes = ForwardLaunch::smem<T, D>();
    constexpr int threads = kFwdThreadsOf<T, D>;
    if constexpr (kTf32Cluster<T, D>)
      return fill_info(fn, threads, bytes, kTf32Ranks, out);
    cudaFuncAttributes attr;
    cudaError_t err = attributes(fn, bytes, &attr);
    if (err == cudaSuccess && threads == kMmaThreads)   // as launch_mma sets
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if constexpr (kWgmma256<T, D>) {
      cudaFuncAttributes split;
      if (err == cudaSuccess)
        err = attributes(flash_fwd_wgmma256_kernel<true>,
                         Fwd256Tiles::smem(true), &split);
      if (err == cudaSuccess) {
        attr.numRegs = std::max(attr.numRegs, split.numRegs);
        attr.localSizeBytes =
            std::max(attr.localSizeBytes, split.localSizeBytes);
      }
    }
    int ctas = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                          bytes);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = static_cast<int>(bytes);
    out[3] = ctas;
    out[4] = 1;                        // no cluster
    out[5] = 0;
    return cudaSuccess;
  }
};

}  // namespace sparknet_flash

// q, k, v, o: (bh, seq, head_dim) contiguous, dtype 0 = f32, 1 = bf16
// (16-byte aligned); lse: (bh, seq) f32. A head_dim past 256 runs the
// cluster kernel of flash_wide.cuh (a multiple of 128 that splits into
// equal clusters: ops/cuda_attention.py built_head_dim). Returns the CUDA
// error code of the launch.
extern "C" int sparknet_flash_forward(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int bh, int seq,
                                      int head_dim, float scale, int causal,
                                      void* stream) {
  if (head_dim > 256)
    return sparknet_flash::wide_forward(
        q, k, v, o, static_cast<float*>(lse), dtype, bh, seq, head_dim,
        scale, causal, static_cast<cudaStream_t>(stream));
  const sparknet_flash::ForwardLaunch launch{
      q, k, v, o, static_cast<float*>(lse), bh, seq, scale, causal,
      static_cast<cudaStream_t>(stream)};
  return sparknet_flash::dispatch(dtype, head_dim, launch);
}

// The forward kernel for (dtype, head_dim): out[0] registers a thread,
// out[1] local memory bytes a thread (spills), out[2] dynamic shared
// memory bytes, out[3] resident CTAs per SM, out[4] the cluster size (1:
// none), out[5] co-resident clusters on the card (past 256; 0 without a
// cluster).
extern "C" int sparknet_flash_forward_info(int dtype, int head_dim,
                                           int* out) {
  if (head_dim > 256)
    return sparknet_flash::wide_info(0, dtype, head_dim, out);
  const sparknet_flash::ForwardInfo query{out};
  return sparknet_flash::dispatch(dtype, head_dim, query);
}
