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
// bf16 storage (flash_dq_mma_kernel, flash_dkv_mma_kernel): the products
// run on the tensor cores (mma.sync m16n8k16 bf16 -> f32, fed by ldmatrix
// from bf16 shared-memory tiles of row stride D + 8; flash_mma.cuh). A CTA
// of 4 warps owns one 64-row tile; each warp owns 16 of its rows.
//  - dQ: the warp's S = Q K^T and dP = dO V^T for 64 keys stay in f32
//    accumulator registers; P = exp2(S * scale * log2e - LSE * log2e) and
//    dS = P (dP - delta) are computed there and packed to bf16 A
//    fragments of dQ += dS K, which reads K through ldmatrix .trans.
//  - dK/dV: the warp computes S^T = K Q^T and dP^T = V dO^T for its 16
//    keys (32 queries at a time at D = 128, 64 below, for registers), so
//    P^T and dS^T are A fragments of dV += P^T dO and dK += dS^T Q, which
//    read dO and Q through ldmatrix .trans.
//  - The streamed pair (K, V for dQ; Q, dO with their LSE and delta rows
//    for dK/dV) is double-buffered: cp.async copies of tile j + 1
//    (16-byte chunks; rows past S zero-filled) run under the products of
//    tile j (cp.async.wait_group 1).
//  - Shared memory at D = 128: own pair 34 KB + two stages of the streamed
//    pair 68 KB (+ 1 KB of LSE/delta rows) = 102 / 103 KB, so two CTAs
//    fit on an SM (228 KB); launched with the largest carveout.
//  - Causal: tiles past the diagonal are skipped (and, in dK/dV, a
//    warp's query blocks that none of its keys see); the mask is applied
//    only on tiles that cross the diagonal or S. The tile index is the
//    slow grid axis, and the dQ kernel maps it to query tiles last to
//    first, so the longest CTAs start first and the causal tail does not
//    leave the last wave half empty.
//  - Rounding: P and dS are rounded to bf16 before the second products,
//    as any tensor-core backward does (the TPU's MXU takes the JAX
//    kernel's f32 operands as single-pass bf16); the worst 64-row tile of
//    dQ, dK, dV then reads ~3e-3 of its norm against the f32 plain
//    version (tests/test_torch_flash_rounding.py; chip_smoke.py's limit
//    5e-3). S, dP, delta and the dQ, dK, dV sums stay in f32; the
//    outputs are rounded once.
//  - Head_dim 256: the dK and dV accumulators of all columns (2 x 128 f32
//    a thread) would not fit in registers, so the grid's z axis splits
//    the output columns in 128-wide halves (kOutCols, flash_mma.cuh):
//    each CTA recomputes S and dP over all of D and accumulates its half
//    of dQ (or dK and dV); the first writes delta. Its tiles of all D
//    columns take ~198 KB: one CTA an SM.
//  - Registers a thread, shared memory and CTAs per SM, as the runtime
//    reports them on the H100 (sparknet_flash_backward_info, printed and
//    checked by chip_smoke.py phase 6); no instantiation spills:
//        D            16       32       64       128          256
//        dQ     125 18 KB 4  153 30 KB 3  190 54 KB 2  234 102 KB 2  242 198 KB 1
//        dK/dV  140 19 KB 3  170 31 KB 2  226 55 KB 2  244 103 KB 2  254 199 KB 1
//    At the LM's shape: dQ 0.79-0.84 ms, dK/dV 1.03-1.10 ms, 244-268
//    TFLOP/s (PERF.md).
//
// f32 storage (flash_dq_tf32_kernel, flash_dkv_tf32_kernel): every
// product on the tensor cores in split TF32 (3xTF32, flash_tf32.cuh:
// a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi, f32 accumulation), which keeps
// the f32 limits (5e-4 of the largest element, 1e-4 of a 64-row tile;
// the small LM's card-vs-CPU gradients within 1e-4). The layout is the
// bf16 kernels' (4 warps, a warp 16 rows of the CTA's own 64-row tile,
// the streamed pair through cp.async stages) with f32 tiles of row
// stride D + 4 and mma.sync m16n8k8 fed by plain shared-memory loads
// (ldmatrix moves 16-bit elements only). S, dP, P and dS stay in f32
// and enter the second products split, from the accumulators; nothing
// is rounded between the products. Every tensor-core sum runs over at
// most 64 columns of D or one streamed tile and is then added in f32
// (the tensor core truncates its sums: flash_tf32.cuh). Streamed tiles:
// 64 rows through two stages up to D = 64; from D = 128, dQ takes K and
// V 32 rows through one stage (two CTAs an SM at D = 128) and dK/dV Q
// and dO 16 rows through two; at D = 256 the output columns split over
// the grid's z axis as the bf16 kernels' do. P is exp(scale S - LSE) in
// natural units, as the plain version computes it. Bound: operations.
// At the LM's shape dQ does 206 and dK/dV 275 GFLOP: 1.25 and 1.67 ms at
// 165 TFLOP/s of f32-accurate products (495 TFLOP/s of dense TF32 over 3
// products); like the forward they are bound by instruction throughput
// and latency before that. Registers a thread, shared memory and CTAs
// per SM on the H100 (sparknet_flash_backward_info, chip_smoke.py phase
// 6); no spills:
//        D        16           32           64           128          256
//        dQ       128 30 KB 4  128 54 KB 4  168 102 KB 2 225 99 KB 2  202 195 KB 1
//        dK/dV    155 31 KB 3  164 55 KB 3  241 103 KB 2 250 99 KB 2  250 195 KB 1
// At the LM's shape: dQ 3.65 ms (56.5 TFLOP/s, 34% of the bound) and
// dK/dV 5.31-5.34 ms (51.7, 31%), against 10.37-10.41 and 12.58-12.67 for
// the CUDA-core kernels they replaced in the same call, and 10.03 for
// autograd through F.scaled_dot_product_attention's three gradients
// (scripts/flash_ab.py; PERF.md).
// The storage type picks the kernel and nothing else does.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_tf32.cuh"
#include "flash_wide.cuh"

namespace sparknet_flash {

// bf16 storage: the tensor-core kernels (the note at the top).

using bf16 = __nv_bfloat16;

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        float* __restrict__ delta, int seq, float scale,
                        int causal) {
  constexpr int LD = D + 8, TILE = kBlockQ * LD, KD = D / 16;
  constexpr int DO = kOutCols<D>, KO = DO / 16, NO = DO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // this CTA's 64 queries
  bf16* dos = qs + TILE;
  bf16* kvs = dos + TILE;   // stage st: K at kvs + 2 st TILE, V after it
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
  const int n_k = causal ? qt + 1 : gridDim.y;   // key tiles to walk
  const int col0 = blockIdx.z * DO;             // this CTA's columns of dQ

  cp_async_tile<D>(qs, q, q0, seq);
  cp_async_tile<D>(dos, dout, q0, seq);
  cp_async_commit();
  cp_async_tile<D>(kvs, k, 0, seq);
  cp_async_tile<D>(kvs + TILE, v, 0, seq);
  cp_async_commit();
  cp_async_wait<1>();                  // Q and dO have landed
  __syncthreads();

  // delta of row w0 + lane / 2, two lanes a row, half the row each
  float dl;
  {
    const int rl = w0 + (lane >> 1), r = q0 + rl, c0 = (lane & 1) * (D / 2);
    float part = 0.f;
    if (r < seq) {
#pragma unroll
      for (int c = c0; c < c0 + D / 2; c += 8)
        part += dot8_bf16(*reinterpret_cast<const uint4*>(
                              o + static_cast<long long>(r) * D + c),
                          *reinterpret_cast<const uint4*>(dos + rl * LD + c));
    }
    dl = part + __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && r < seq && col0 == 0) delta[r] = dl;
  }
  // this thread's rows of the score tiles: w0 + g and w0 + g + 8
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta_r[i] = __shfl_sync(0xffffffffu, dl, 2 * g + 16 * i);
    const int r = q0 + w0 + g + 8 * i;
    lse_r[i] = r < seq ? lse[r] * kLog2e : 0.f;
  }
  const float sl2 = scale * kLog2e;
  float acc[NO][4] = {};               // dQ, rows w0 .. w0 + 15

  for (int j = 0; j < n_k; ++j) {
    if (j + 1 < n_k) {
      bf16* next = kvs + ((j + 1) & 1) * 2 * TILE;
      cp_async_tile<D>(next, k, (j + 1) * kBlockK, seq);
      cp_async_tile<D>(next + TILE, v, (j + 1) * kBlockK, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();                // tile j has landed
    __syncthreads();
    const bf16* ks = kvs + (j & 1) * 2 * TILE;
    const bf16* vs = ks + TILE;
    float s[8][4] = {}, dp[8][4] = {};   // S, dP: 16 rows x 64 keys
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, a_frag<LD>(qs, w0, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        ldmatrix_x4(b, b_frag<LD>(ks, nn * 16, kk * 16, lane));
        mma_bf16(s[2 * nn], a, b[0], b[1]);
        mma_bf16(s[2 * nn + 1], a, b[2], b[3]);
      }
      ldmatrix_x4(a, a_frag<LD>(dos, w0, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        ldmatrix_x4(b, b_frag<LD>(vs, nn * 16, kk * 16, lane));
        mma_bf16(dp[2 * nn], a, b[0], b[1]);
        mma_bf16(dp[2 * nn + 1], a, b[2], b[3]);
      }
    }
    const int k0 = j * kBlockK;
    const bool edge = (causal && j == qt) || k0 + kBlockK > seq ||
                      q0 + kBlockQ > seq;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(fmaf(s[jn][e], sl2, -lse_r[i]));
        if (edge && masked(q0 + w0 + g + 8 * i, k0 + jn * 8 + 2 * t + (e & 1),
                           seq, causal))
          p = 0.f;
        s[jn][e] = p * (dp[jn][e] - delta_r[i]);    // dS
      }
    }
    uint32_t ds[4][4];                 // dS as A fragments, keys 16 kk ..
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ds[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      ds[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      ds[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      ds[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nd = 0; nd < KO; ++nd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bt_frag<LD>(ks, kk * 16, col0 + nd * 16, lane));
        mma_bf16(acc[2 * nd], ds[kk], b[0], b[1]);
        mma_bf16(acc[2 * nd + 1], ds[kk], b[2], b[3]);
      }
    }
    __syncthreads();                   // stage j & 1 is free for tile j + 2
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + w0 + g + 8 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dq + static_cast<long long>(r) * D + col0 +
                                   n * 8 + 2 * t) =
          pack_bf16(scale * acc[n][2 * i], scale * acc[n][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int seq, float scale, int causal) {
  constexpr int LD = D + 8, TILE = kBlockK * LD, KD = D / 16;
  constexpr int DO = kOutCols<D>, KO = DO / 16, NO = DO / 8;
  constexpr int kSub = D > 64 ? 32 : 64;   // queries per S^T block
  constexpr int NS = kSub / 8;             // its n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // this CTA's 64 keys
  bf16* vs = ks + TILE;
  bf16* qds = vs + TILE;   // stage st: Q at qds + 2 st TILE, dO after it
  float* rows = reinterpret_cast<float*>(qds + 4 * TILE);  // stage st: LSE
                                           // at rows + 128 st, delta after
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
  const int n_q = gridDim.y, q_first = causal ? kt : 0;
  const int col0 = blockIdx.z * DO;        // this CTA's columns of dK, dV

  auto load_queries = [&](int stage, int qt) {
    bf16* dst = qds + stage * 2 * TILE;
    cp_async_tile<D>(dst, q, qt * kBlockQ, seq);
    cp_async_tile<D>(dst + TILE, dout, qt * kBlockQ, seq);
    cp_async_rows(rows + stage * 128, lse, qt * kBlockQ, seq);
    cp_async_rows(rows + stage * 128 + 64, delta, qt * kBlockQ, seq);
  };
  cp_async_tile<D>(ks, k, k0, seq);
  cp_async_tile<D>(vs, v, k0, seq);
  load_queries(0, q_first);
  cp_async_commit();
  const float sl2 = scale * kLog2e;
  float dk_acc[NO][4] = {}, dv_acc[NO][4] = {};   // rows w0 .. w0 + 15

  for (int qt = q_first; qt < n_q; ++qt) {
    const int stage = (qt - q_first) & 1;
    if (qt + 1 < n_q) load_queries(stage ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile qt has landed
    __syncthreads();
    const bf16* qs = qds + stage * 2 * TILE;
    const bf16* dos = qs + TILE;
    const float* lse_s = rows + stage * 128;
    const float* delta_s = lse_s + 64;
    const int q0 = qt * kBlockQ;
    const bool edge = (causal && qt == kt) || q0 + kBlockQ > seq ||
                      k0 + kBlockK > seq;
#pragma unroll
    for (int sub = 0; sub < kBlockQ; sub += kSub) {
      // a block of queries that sees none of this warp's keys
      if (causal && q0 + sub + kSub - 1 < k0 + w0) continue;
      float s[NS][4] = {}, dp[NS][4] = {};   // S^T, dP^T: 16 keys x kSub
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, a_frag<LD>(ks, w0, kk * 16, lane));
#pragma unroll
        for (int nn = 0; nn < NS / 2; ++nn) {
          ldmatrix_x4(b, b_frag<LD>(qs, sub + nn * 16, kk * 16, lane));
          mma_bf16(s[2 * nn], a, b[0], b[1]);
          mma_bf16(s[2 * nn + 1], a, b[2], b[3]);
        }
        ldmatrix_x4(a, a_frag<LD>(vs, w0, kk * 16, lane));
#pragma unroll
        for (int nn = 0; nn < NS / 2; ++nn) {
          ldmatrix_x4(b, b_frag<LD>(dos, sub + nn * 16, kk * 16, lane));
          mma_bf16(dp[2 * nn], a, b[0], b[1]);
          mma_bf16(dp[2 * nn + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int jn = 0; jn < NS; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = sub + jn * 8 + 2 * t + (e & 1);   // query in tile
          float p = exp2f(fmaf(s[jn][e], sl2, -lse_s[c] * kLog2e));
          if (edge && masked(q0 + c, k0 + w0 + g + 8 * (e >> 1), seq, causal))
            p = 0.f;
          dp[jn][e] = p * (dp[jn][e] - delta_s[c]);   // dS^T
          s[jn][e] = p;                                 // P^T
        }
      }
      uint32_t pf[NS / 2][4], dsf[NS / 2][4];   // A fragments, queries 16 kk..
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        dsf[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        dsf[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        dsf[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        dsf[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
        for (int nd = 0; nd < KO; ++nd) {
          const int n0 = col0 + nd * 16;
          uint32_t b[4];
          ldmatrix_x4_trans(b, bt_frag<LD>(dos, sub + kk * 16, n0, lane));
          mma_bf16(dv_acc[2 * nd], pf[kk], b[0], b[1]);
          mma_bf16(dv_acc[2 * nd + 1], pf[kk], b[2], b[3]);
          ldmatrix_x4_trans(b, bt_frag<LD>(qs, sub + kk * 16, n0, lane));
          mma_bf16(dk_acc[2 * nd], dsf[kk], b[0], b[1]);
          mma_bf16(dk_acc[2 * nd + 1], dsf[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();                   // this stage is free for tile qt + 2
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + w0 + g + 8 * i;
    if (c >= seq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long long at =
          static_cast<long long>(c) * D + col0 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(scale * dk_acc[n][2 * i], scale * dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// f32 storage: split TF32 on the tensor cores (the note at the top).

// Tiles of the f32 backward kernels at head_dim D (floats): the CTA's own
// 64 rows, and ST-row streamed tiles through a ring of STAGES
template <int D, int kStreamed, int kStages>
struct Tf32BwdTiles {
  static constexpr int DO = kOutCols<D>;           // output columns a CTA
  static constexpr int ST = kStreamed;             // rows a streamed tile
  static constexpr int STAGES = kStages;           // streamed tiles in flight
  static constexpr int LD = D + 4;                 // row stride
  static constexpr int TILE = kBlockQ * LD;        // the CTA's own rows
  static constexpr int STILE = ST * LD;            // a streamed tile
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * TILE + STAGES * 2 * STILE);
  static constexpr size_t kDkvSmem =
      sizeof(float) * (2 * TILE + STAGES * (2 * STILE + 2 * ST));
};

// From D = 128 each kernel keeps two CTAs on an SM: dQ streams K and V
// 32 keys at a time through one stage, dK/dV Q and dO 16 queries at a
// time through two (each ran faster at the LM's shape than the other
// kernel's choice, and than 8 rows through two stages).
template <int D>
using DqTiles = Tf32BwdTiles<D, (D == 128 ? 32 : (D > 64 ? 16 : 64)),
                             (D == 128 ? 1 : 2)>;
template <int D>
using DkvTiles = Tf32BwdTiles<D, (D > 64 ? 16 : 64), 2>;

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
  using L = DqTiles<D>;
  constexpr int LD = L::LD, KT = L::ST, NT = KT / 8, NO = L::DO / 8;
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
  const int col0 = blockIdx.z * L::DO;          // this CTA's columns of dQ

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
    if ((lane & 1) == 0 && r < seq && col0 == 0) delta[r] = dl;
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
    mul_tiles<LD>(acc, dsh, dsl, ks, 0, col0, g, t);
    __syncthreads();                   // tile j's stage is free
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + w0 + g + 8 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dq + static_cast<long long>(r) * D + col0 +
                                 n * 8 + 2 * t) =
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
  using L = DkvTiles<D>;
  constexpr int LD = L::LD, QT = L::ST, NS = QT / 8, NO = L::DO / 8;
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
  const int col0 = blockIdx.z * L::DO;     // this CTA's columns of dK, dV

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
      mul_tiles<LD>(dv_acc, ph, pl, dos, 0, col0, g, t);
      split_c_tiles(dh, dl, dp);         // dK += dS^T Q
      mul_tiles<LD>(dk_acc, dh, dl, qs, 0, col0, g, t);
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
      const long long at =
          static_cast<long long>(c) * D + col0 + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(scale * dk_acc[n][2 * i], scale * dk_acc[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + at) =
          make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// The storage type picks the kernel: bf16 in bf16 on the tensor cores,
// f32 in split TF32 on them; both take launch_mma's grid.
template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

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
    if constexpr (kBf16<T>)
      return flash_dq_mma_kernel<D>;
    else
      return flash_dq_tf32_kernel<D>;
  }

  template <typename T, int D>
  static size_t smem() {
    if constexpr (kBf16<T>)
      return sizeof(T) * (2 * kBlockQ + 4 * kBlockK) * (D + 8);
    else
      return DqTiles<D>::kDqSmem;
  }

  template <typename T, int D>
  int run() const {
    return launch_mma(kernel<T, D>(), bh, seq, D / kOutCols<D>, smem<T, D>(),
                      stream, static_cast<const T*>(q),
                      static_cast<const T*>(k), static_cast<const T*>(v),
                      static_cast<const T*>(o), static_cast<const T*>(dout),
                      lse, static_cast<T*>(dq), delta, seq, scale, causal);
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
    if constexpr (kBf16<T>)
      return flash_dkv_mma_kernel<D>;
    else
      return flash_dkv_tf32_kernel<D>;
  }

  template <typename T, int D>
  static size_t smem() {
    if constexpr (kBf16<T>)
      return sizeof(T) * (2 * kBlockK + 4 * kBlockQ) * (D + 8) +
             sizeof(float) * 4 * kBlockQ;
    else
      return DkvTiles<D>::kDkvSmem;
  }

  template <typename T, int D>
  int run() const {
    return launch_mma(kernel<T, D>(), bh, seq, D / kOutCols<D>, smem<T, D>(),
                      stream, static_cast<const T*>(q),
                      static_cast<const T*>(k), static_cast<const T*>(v),
                      static_cast<const T*>(dout), lse, delta,
                      static_cast<T*>(dk), static_cast<T*>(dv), seq, scale,
                      causal);
  }
};

// What the runtime says of one backward kernel: registers a thread, local
// memory a thread (spills), dynamic shared memory and resident CTAs per
// SM, into out[0..3]; out[4] = 1, out[5] = 0 (no cluster).
struct InfoQuery {
  int which;                           // 0: dQ, 1: dK/dV
  int* out;

  template <typename Kernel>
  int fill(Kernel kernel, size_t bytes) const {
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
    int ctas = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, kernel, kMmaThreads, bytes);
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
    return which == 0
               ? fill(DqLaunch::kernel<T, D>(), DqLaunch::smem<T, D>())
               : fill(DkvLaunch::kernel<T, D>(), DkvLaunch::smem<T, D>());
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
