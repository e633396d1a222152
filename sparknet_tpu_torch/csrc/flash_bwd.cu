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
// f32 storage (flash_dq_kernel, flash_dkv_kernel) keeps CUDA-core
// products in f32: the f32 checks (5e-4 of the largest element; the small
// LM's card-vs-CPU gradients within 1e-4) need f32 products, which TF32
// tensor cores would not give. A CTA of 256 threads owns one R-row tile
// (R = kRows<D>: 64; 32 at D = 256, where four f32 tiles of D + 1
// columns must fit) staged in f32 with row stride D + 1; R/16 x R/16
// register blocks. The storage type picks the kernel and nothing else
// does.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_wide.cuh"

namespace sparknet_flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, int seq,
                    float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int R = kRows<D>, RI = R / 16, LD = D + 1, LP = R + 1;
  constexpr int NJ = D / 16;
  float* qs = smem;                  // R x LD
  float* dos = qs + R * LD;          // R x LD
  float* ks = dos + R * LD;          // R x LD
  float* vs = ks + R * LD;           // R x LD
  float* dss = vs + R * LD;          // R x LP
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * R;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  q += base;
  k += base;
  v += base;
  o += base;
  dout += base;
  dq += base;
  lse += static_cast<long long>(blockIdx.y) * seq;
  delta += static_cast<long long>(blockIdx.y) * seq;

  load_tile<T, D, R>(qs, q, q0, seq, 1.f);
  load_tile<T, D, R>(dos, dout, q0, seq, 1.f);
  __syncthreads();
  float lse_r[RI], delta_r[RI], acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty * RI + i;
    float part = 0.f;
    if (r < seq) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        part += dos[(ty * RI + i) * LD + tx + 16 * j] *
                to_f32(o[static_cast<long long>(r) * D + tx + 16 * j]);
    }
    delta_r[i] = row_sum16(part);
    lse_r[i] = r < seq ? lse[r] : 0.f;
    if (tx == 0 && r < seq) delta[r] = delta_r[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int k_end = causal ? min(seq, q0 + R) : seq;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D, R>(ks, k, k0, seq, 1.f);
    load_tile<T, D, R>(vs, v, k0, seq, 1.f);
    __syncthreads();
    float s[RI][RI] = {}, dp[RI][RI] = {};
    tile_dot<D, R>(s, qs, ks, ty, tx);
    tile_dot<D, R>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + ty * RI + i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p =
            masked(r, c, seq, causal) ? 0.f : expf(scale * s[i][j] - lse_r[i]);
        dss[(ty * RI + i) * LP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_mul<D, R, false>(acc, dss, ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty * RI + i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[static_cast<long long>(r) * D + tx + 16 * j] =
          from_f32<T>(scale * acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int R = kRows<D>, RI = R / 16, LD = D + 1, LP = R + 1;
  constexpr int NJ = D / 16;
  float* ks = smem;                  // R x LD (this CTA's keys)
  float* vs = ks + R * LD;           // R x LD
  float* qs = vs + R * LD;           // R x LD
  float* dos = qs + R * LD;          // R x LD
  float* ps = dos + R * LD;          // R x LP
  float* dss = ps + R * LP;          // R x LP
  float* lse_s = dss + R * LP;       // R
  float* delta_s = lse_s + R;        // R
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * R;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  lse += static_cast<long long>(blockIdx.y) * seq;
  delta += static_cast<long long>(blockIdx.y) * seq;

  load_tile<T, D, R>(ks, k, k0, seq, 1.f);
  load_tile<T, D, R>(vs, v, k0, seq, 1.f);
  float dk_acc[RI][NJ], dv_acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  // causal: query tiles wholly above the diagonal are skipped
  const int q_start = causal ? k0 : 0;
  for (int q0 = q_start; q0 < seq; q0 += R) {
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D, R>(qs, q, q0, seq, 1.f);
    load_tile<T, D, R>(dos, dout, q0, seq, 1.f);
    for (int i = threadIdx.x; i < R; i += kThreads) {
      const int r = q0 + i;
      lse_s[i] = r < seq ? lse[r] : 0.f;
      delta_s[i] = r < seq ? delta[r] : 0.f;
    }
    __syncthreads();
    float s[RI][RI] = {}, dp[RI][RI] = {};
    tile_dot<D, R>(s, qs, ks, ty, tx);
    tile_dot<D, R>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int rl = ty * RI + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p =
            masked(r, c, seq, causal) ? 0.f : expf(scale * s[i][j] - lse_s[rl]);
        ps[rl * LP + tx + 16 * j] = p;
        dss[rl * LP + tx + 16 * j] = p * (dp[i][j] - delta_s[rl]);
      }
    }
    __syncthreads();
    // rows of the accumulators are this CTA's keys: P^T dO and dS^T Q
    tile_mul<D, R, true>(dv_acc, ps, dos, ty, tx);
    tile_mul<D, R, true>(dk_acc, dss, qs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int c = k0 + ty * RI + i;
    if (c >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long at = static_cast<long long>(c) * D + tx + 16 * j;
      dk[at] = from_f32<T>(scale * dk_acc[i][j]);
      dv[at] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

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

// The storage type picks the kernel: bf16 the tensor cores, f32 the CUDA
// cores.
template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int D, typename Kernel, typename... Args>
int launch_bwd(Kernel kernel, int bh, int seq, size_t bytes,
               cudaStream_t stream, Args... args) {
  if constexpr (kTensorCores<T>)
    return launch_mma(kernel, bh, seq, D / kOutCols<D>, bytes, stream,
                      args...);
  else
    return launch_tiles(kernel, bh, seq, kRows<D>, bytes, stream, args...);
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
    if constexpr (kTensorCores<T>)
      return flash_dq_mma_kernel<D>;
    else
      return flash_dq_kernel<T, D>;
  }

  template <typename T, int D>
  static size_t smem() {
    if constexpr (kTensorCores<T>)
      return sizeof(T) * (2 * kBlockQ + 4 * kBlockK) * (D + 8);
    else
      return sizeof(float) * (4 * kRows<D> * (D + 1) +
                              kRows<D> * (kRows<D> + 1));
  }

  template <typename T, int D>
  int run() const {
    return launch_bwd<T, D>(kernel<T, D>(), bh, seq, smem<T, D>(), stream,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const T*>(o),
                         static_cast<const T*>(dout), lse, static_cast<T*>(dq),
                         delta, seq, scale, causal);
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
    if constexpr (kTensorCores<T>)
      return flash_dkv_mma_kernel<D>;
    else
      return flash_dkv_kernel<T, D>;
  }

  template <typename T, int D>
  static size_t smem() {
    if constexpr (kTensorCores<T>)
      return sizeof(T) * (2 * kBlockK + 4 * kBlockQ) * (D + 8) +
             sizeof(float) * 4 * kBlockQ;
    else
      return sizeof(float) * (4 * kRows<D> * (D + 1) +
                              2 * kRows<D> * (kRows<D> + 1) + 2 * kRows<D>);
  }

  template <typename T, int D>
  int run() const {
    return launch_bwd<T, D>(kernel<T, D>(), bh, seq, smem<T, D>(), stream,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const T*>(dout),
                         lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
                         seq, scale, causal);
  }
};

// What the runtime says of one backward kernel: registers a thread, local
// memory a thread (spills), dynamic shared memory and resident CTAs per
// SM, into out[0..3].
struct InfoQuery {
  int which;                           // 0: dQ, 1: dK/dV
  int* out;

  template <typename T, typename Kernel>
  int fill(Kernel kernel, size_t bytes) const {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
    if (err == cudaSuccess && kTensorCores<T>)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    int ctas = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &ctas, kernel, kTensorCores<T> ? kMmaThreads : kThreads, bytes);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = static_cast<int>(bytes);
    out[3] = ctas;
    return cudaSuccess;
  }

  template <typename T, int D>
  int run() const {
    return which == 0
               ? fill<T>(DqLaunch::kernel<T, D>(), DqLaunch::smem<T, D>())
               : fill<T>(DkvLaunch::kernel<T, D>(), DkvLaunch::smem<T, D>());
  }
};

}  // namespace sparknet_flash

// q, k, v, o, dout, dq: (bh, seq, head_dim) contiguous, dtype 0 = f32,
// 1 = bf16 (16-byte aligned); lse (read) and delta (written): (bh, seq)
// f32. A head_dim past 256 (a multiple of 64) runs the wide kernels of
// flash_wide.cuh, here and in the dK/dV entry point.
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
// out[2] dynamic shared memory bytes, out[3] resident CTAs per SM.
extern "C" int sparknet_flash_backward_info(int which, int dtype,
                                            int head_dim, int* out) {
  if (head_dim > 256)
    return sparknet_flash::wide_info(which == 0 ? 1 : 2, dtype, out);
  const sparknet_flash::InfoQuery query{which, out};
  return sparknet_flash::dispatch(dtype, head_dim, query);
}
