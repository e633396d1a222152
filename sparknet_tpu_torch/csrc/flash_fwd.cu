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
// bf16 storage (flash_fwd_wgmma_kernel): both products on the tensor
// cores through wgmma (flash_wgmma.cuh). A CTA of two warpgroups owns 128
// query rows of one (b, h), 64 per warpgroup (one m64 tile).
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
//  - Not yet: a producer warp with setmaxnreg (warp specialisation), the
//    ping-pong of two warpgroups that puts one's softmax under the
//    other's products, a persistent grid, and a TMA store of O. Both
//    warpgroups wait at one barrier per key tile before its stage is
//    refilled, so the tensor cores idle while both do their softmax.
//  - Head_dim 256 (WgTiles): an O accumulator of all 256 columns (128
//    f32 a thread) beside S (64) would pass 255 registers, and Q, K, V
//    and a second stage would pass 227 KB of shared memory. So the grid's
//    z axis splits O's columns in two 128-wide halves: each CTA computes
//    S = Q K^T over all of D, reads only its half of V and writes its
//    half of O (and the first, LSE); the ring keeps one K/V stage (Q 64
//    KB + K 64 KB + half of V 32 KB). The split costs one more S product
//    a tile; the single stage serialises each tile's loads and products.
//  - Registers a thread, shared memory and CTAs per SM, as the runtime
//    reports them on the H100 (sparknet_flash_forward_info, printed and
//    checked by chip_smoke.py phase 6); no instantiation spills:
//        D      16           32           64           128          256
//               130 21 KB 1  138 42 KB 1  154 83 KB 1  186 161 KB 1  186 161 KB 1
//    At the LM's (4, 8, 4096, 128) causal: 0.39-0.40 ms, 341-351 TFLOP/s,
//    1.2-1.5x F.scaled_dot_product_attention's time (PERF.md).
//
// f32 storage (flash_fwd_tf32_kernel): both products on the tensor cores
// in split TF32 (3xTF32, flash_tf32.cuh): each f32 operand is split into
// a TF32 hi and lo, and a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi with f32
// accumulation, which keeps O within the f32 limits (2e-5 of the largest
// element; one TF32 pass reads ~15x over it). A CTA of 4 warps owns 64
// query rows of one (b, h), 16 a warp, as the bf16 backward's layout
// (mma.sync m16n8k8 fed from shared memory; wgmma takes TF32 only with
// both operands K-major, which P V's V is not).
//  - Loads: Q lands once; K and V follow in KT-key tiles (64 at D <= 32,
//    32 from D = 64) by cp.async, two stages deep (tile j + 1 in flight
//    under tile j's products) but one at D = 128, where that lets three
//    CTAs share an SM. f32 tiles of row stride D + 4, free of bank
//    conflicts.
//  - S = Q K^T in f32 accumulators, summed on the tensor cores 64
//    columns of D at a time and added in f32 (the tensor core truncates
//    its sums: flash_tf32.cuh), then scaled. Online softmax in registers
//    as the bf16 kernel's (a row's scores in the 4 lanes of a quad), with
//    expf in natural units as the plain version computes it; nothing is
//    rounded between the products: P enters O += P V split, from S's
//    accumulators, one tile's sum added to O in f32.
//  - Head_dim 256: O's columns split in two 128-wide halves over the
//    grid's z axis (each CTA computes S over all of D and reads its half
//    of V), as the bf16 kernel does.
//  - Causal: key tiles past the diagonal are skipped; the query tile is
//    the slow grid axis, last tile first.
//  - Bound: operations. At the LM's (4, 8, 4096, 128) causal, 137 GFLOP:
//    0.83 ms at 165 TFLOP/s of f32-accurate products (495 TFLOP/s of
//    dense TF32 over the 3 products). Every mma also costs its loads and
//    the split of its B fragment, so instruction throughput and latency
//    bind it first.
//  - Registers a thread, shared memory and CTAs per SM on the H100
//    (sparknet_flash_forward_info, chip_smoke.py phase 6); no spills:
//        D      16           32           64           128          256
//               128 25 KB 4  128 45 KB 4  127 51 KB 4  167 66 KB 3  254 163 KB 1
//    At the LM's shape: 2.78 ms, 49.5 TFLOP/s, 30% of the bound; the
//    CUDA-core kernel it replaced took 5.91-6.15 ms in the same call and
//    F.scaled_dot_product_attention 3.20 (scripts/flash_ab.py;
//    PERF.md).
// The storage type picks the kernel and nothing else does.

#include <type_traits>

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
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry at head_dim D (bytes; flash_wgmma.cuh). Up to
// D = 128 a CTA computes all D columns of O through a ring of two K/V
// stages. At D = 256 an O accumulator of all columns would not fit in a
// thread's registers: the grid's z axis splits O's columns in DO = 128
// wide halves, each CTA computes the whole of S = Q K^T (its reduction
// runs over all of D) and O for its half, reading only its half of V;
// and the ring holds one stage, so that Q, K and half of V fit in
// shared memory (64 + 64 + 32 KB).
template <int D>
struct WgTiles {
  static constexpr int DO = D > 128 ? 128 : D;   // O columns of a CTA
  static constexpr int STAGES = D > 128 ? 1 : 2;  // K/V ring depth
  static constexpr int W = D < 64 ? D : 64;   // columns of a swizzle block
  static constexpr int RB = 2 * W;            // its row: the swizzle bytes
  static constexpr int BLOCK = 128 * RB;      // one block of a 128-row tile
  static constexpr int TILE = 128 * D * 2;    // a 128-row tile of Q or K
  static constexpr int VTILE = 128 * DO * 2;  // a CTA's columns of a V tile
  static constexpr int STAGE = TILE + VTILE;  // K then V
  static constexpr int SBO = 8 * RB;          // 8 rows
  // Q, the stages of K and V, their mbarriers, 1024-byte alignment
  static constexpr size_t kSmem = TILE + STAGES * STAGE + 64 + 1024;
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
  const uint32_t bars = kv + L::STAGES * L::STAGE;   // Q, then each stage
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * kWgRows;
  const int n_k = causal ? qt + 1 : gridDim.y;   // key tiles to walk
  const int col0 = blockIdx.z * L::DO;         // this CTA's columns of O

  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v;
  // column blocks [c0, c0 + n) of rows [row0, row0 + 128)
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                  int row0, int c0, int n) {
    for (int c = 0; c < n; ++c)
      tma_load_3d(dst + c * L::BLOCK, map, bar, (c0 + c) * L::W, row0, bh);
  };
  auto load_kv = [&](int j) {
    const int st = j % L::STAGES;
    const uint32_t bar = bars + 8 + 8 * st;
    const uint32_t dst = kv + st * L::STAGE;
    mbar_expect_tx(bar, L::STAGE);
    load(dst, mk, bar, j * kWgKeys, 0, D / L::W);
    load(dst + L::TILE, mv, bar, j * kWgKeys, col0 / L::W, L::DO / L::W);
  };
  if (tid == 0) {
    for (int i = 0; i <= L::STAGES; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, L::TILE);
    load(qs, mq, bars, q0, 0, D / L::W);
    for (int j = 0; j < L::STAGES && j < n_k; ++j) load_kv(j);
  }

  const float sl2 = scale * kLog2e;
  const int row = wg * 64 + warp * 16 + g;   // this thread's rows of the
                                             // CTA's 128: row, row + 8
  float acc[L::DO / 2];                      // O, unnormalised
#pragma unroll
  for (int e = 0; e < L::DO / 2; ++e) acc[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units
  mbar_wait(bars, 0);                        // Q has landed

  for (int j = 0; j < n_k; ++j) {
    const int st = j % L::STAGES;
    const uint32_t ks = kv + st * L::STAGE, vs = ks + L::TILE;
    mbar_wait(bars + 8 + 8 * st, (j / L::STAGES) & 1);   // K, V of tile j
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
    for (int e = 0; e < L::DO / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
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
      wgmma_rs_tb<L::DO>(
          acc, pf[kk],
          wgmma_desc(vs + kk * 16 * L::RB, L::BLOCK, L::SBO, L::RB));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncthreads();                         // stage st is free
    if (tid == 0 && j + L::STAGES < n_k) load_kv(j + L::STAGES);
  }

  const long long r0 = static_cast<long long>(bh) * seq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = q0 + row + 8 * i;
    if (r >= seq) continue;
    const float lc = fmaxf(lt, 1e-30f);
    bf16* orow = o + (r0 + r) * D + col0;
#pragma unroll
    for (int n = 0; n < L::DO / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(acc[4 * n + 2 * i] / lc, acc[4 * n + 2 * i + 1] / lc);
    if (t == 0 && col0 == 0) lse[r0 + r] = m[i] * kLn2 + logf(lc);
  }
}

// f32 storage: split TF32 on the tensor cores (the note at the top).

// Tiles of the f32 forward at head_dim D (floats; flash_tf32.cuh)
template <int D>
struct Tf32FwdTiles {
  static constexpr int DO = D > 128 ? 128 : D;     // O columns of a CTA
  // keys a tile, and K/V tiles in flight: at D = 128 one stage of 32
  // keys lets three CTAs share an SM, which ran faster at the LM's shape
  // than two stages and two CTAs, or one stage of 64 keys
  static constexpr int KT = D >= 64 ? 32 : 64;
  static constexpr int STAGES = D == 128 ? 1 : 2;
  static constexpr int LD = D + 4, LDV = DO + 4;   // row strides: Q, K; V
  static constexpr int STAGE = KT * (LD + LDV);    // K then V
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
  constexpr int KT = L::KT, LD = L::LD, LDV = L::LDV;
  constexpr int NT = KT / 8, NO = L::DO / 8;
  extern __shared__ float smem[];
  float* qs = smem;                          // this CTA's 64 queries
  float* kv = qs + kBlockQ * LD;             // stage st: K, then V
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;   // causal: longest CTAs first
  const int q0 = qt * kBlockQ;
  const int col0 = blockIdx.z * L::DO;         // this CTA's columns of O
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
    cp_async_f32<KT, L::DO, LDV>(dst + KT * LD, v, D, j * KT, col0, seq);
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
    mul_tiles<LDV>(acc, ph, pl, vs, 0, 0, g, t);
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
    float* orow = o + static_cast<long long>(r) * D + col0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    if (t == 0 && col0 == 0) lse[r] = m[i] + logf(lc);
  }
}

// bf16 storage takes the wgmma kernel, f32 the split-TF32 one
template <typename T>
constexpr bool kWgmma = std::is_same<T, bf16>::value;

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
    if constexpr (kWgmma<T>)
      return flash_fwd_wgmma_kernel<D>;
    else
      return flash_fwd_tf32_kernel<D>;
  }

  template <typename T, int D>
  static size_t smem() {
    if constexpr (kWgmma<T>)
      return WgTiles<D>::kSmem;
    else
      return Tf32FwdTiles<D>::kSmem;
  }

  template <typename T, int D>
  int run() const {
    if constexpr (kWgmma<T>) {
      const int tiles = (seq + kWgRows - 1) / kWgRows;
      if (tiles > 65535) return cudaErrorInvalidValue;
      CUtensorMap maps[3];
      const void* src[3] = {q, k, v};
      for (int i = 0; i < 3; ++i) {
        const cudaError_t err = rows_map(&maps[i], src[i], D, seq, bh, 128);
        if (err != cudaSuccess) return err;
      }
      const auto fn = kernel<T, D>();
      const size_t bytes = smem<T, D>();
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      fn<<<dim3(bh, tiles, D / WgTiles<D>::DO), kWgThreads, bytes, stream>>>(
          maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, seq, scale,
          causal);
      return cudaGetLastError();
    } else {
      return launch_mma(kernel<T, D>(), bh, seq, D / Tf32FwdTiles<D>::DO,
                        smem<T, D>(), stream, static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(o),
                        lse, seq, scale, causal);
    }
  }
};

// What the runtime says of the forward kernel for (dtype, head_dim):
// registers a thread, local memory a thread (spills), dynamic shared
// memory and resident CTAs per SM, into out[0..3]; out[4] = 1, out[5] = 0
// (no cluster).
struct ForwardInfo {
  int* out;

  template <typename T, int D>
  int run() const {
    const auto fn = ForwardLaunch::kernel<T, D>();
    const size_t bytes = ForwardLaunch::smem<T, D>();
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
    if (err == cudaSuccess && !kWgmma<T>)    // as launch_mma sets it
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    int ctas = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, fn, kWgmma<T> ? kWgThreads : kMmaThreads, bytes);
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
