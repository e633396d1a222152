// Split-TF32 (3xTF32) building blocks of the f32 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): f32 tiles in shared memory, mma.sync
// m16n8k8 TF32 with f32 accumulation, the split that gives those
// products f32 accuracy, and (at the end) the tiles, fragments and
// products of the f32 kernels on wgmma.
//
// The split: each f32 operand x is written as hi = tf32(x), rounded to
// nearest with ties away from zero as cvt.rna.tf32.f32 rounds a finite
// x, and lo = x - hi, exact in f32 and handed to the mma whole: the
// tensor core reads a TF32 operand's top 19 bits, so lo enters truncated
// toward zero (CUTLASS's round_toward_zero for the small part). hi +
// tf32(lo) is x within 2^-21 of |x|, and
//   a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi
// (the dropped a_lo b_lo is ~2^-22 of |a b|). hi takes two integer
// operations and lo one subtraction: cvt.rna.tf32.f32 compiles to four
// instructions with its NaN guard, and with it on x and on x - hi the
// split was most of the kernels' instruction stream. A NaN x leaves lo
// NaN, so a NaN still reaches the outputs. The two small cross terms
// go into the accumulator first and a_hi b_hi last, as CUTLASS's
// OpMultiplyAddFastF32 orders them. A fragment is split once, after it
// is loaded, and serves every product it enters. Built with
// SPARKNET_FLASH_TF32_ONE_PASS, lo is dropped and each product is one
// TF32 pass (10-bit operands): the precision control that chip_smoke.py
// and scripts/flash_ab.py build and hold against the f32 limits,
// which it must fail. The wrappers never load that build.
//
// Tiles: f32 rows of D columns with a row stride of D + 4 floats. D + 4
// is 4 times an odd number for every built D, so the fragment reads
// below (lane = 4 g + t, g in 0..7, t in 0..3) hit 32 distinct banks:
// row g, column t reads bank 4 g * odd + t; row 2 t, column g reads
// 8 t * odd + g. Row starts stay 16-byte aligned for cp.async.
//
// Fragments of mma.m16n8k8 TF32:
//   A (16x8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8x8, k x n):      b0 (k t, n g), b1 (k t+4, n g)
//   C (16x8, f32):       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
//
// Sums: the tensor core does not round its f32 accumulation as IEEE f32
// does (it truncates), so a long chain of mma.sync into one accumulator
// drifts, the further the longer the chain (dK and dV summed over all
// of S did). So no tensor-core sum runs longer than kSumSteps k-steps of
// 8 (24 mma, split included): each chunk starts from zero and is then
// added into the f32 accumulator by an IEEE add (a product over D in
// chunks of 64 columns; a second product's sum per streamed tile).
//
// A C tile feeds the next product as an A fragment with its k index
// permuted: a0 = c0, a1 = c2 (k 2t), a2 = c1, a3 = c3 (k 2t+1), and the
// B fragment of that product reads rows k0 + 2t and k0 + 2t + 1
// (frag_b_kn). A sum over k does not depend on the order of k, so P and
// dS go from the accumulators of one product into the next without a
// shuffle.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"
#include "flash_wgmma.cuh"

namespace sparknet_flash {

constexpr int kSumSteps = 8;   // k-steps of a tensor-core sum (the note)

// hi, lo of N f32 values as mma operands (the note at the top; lo 0 in
// the one-pass control build)
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
#ifdef SPARKNET_FLASH_TF32_ONE_PASS
    lo[i] = 0u;
#else
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
#endif
  }
}

// c += a b, one m16n8k8 product of TF32 operands with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in split TF32: the cross terms first, hi hi last
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
#ifndef SPARKNET_FLASH_TF32_ONE_PASS
  mma_tf32(c, ah, bl);
  mma_tf32(c, al, bh);
#endif
  mma_tf32(c, ah, bh);
}

// The A fragment of the 16x8 block at (r0, k0) of a row-major tile of
// row stride LDT, split.
template <int LDT>
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* tile, int r0, int k0,
                                       int g, int t) {
  const float* p = tile + (r0 + g) * LDT + k0 + t;
  const float x[4] = {p[0], p[8 * LDT], p[4], p[8 * LDT + 4]};
  split_tf32(x, hi, lo);
}

// The B fragment of the n8 tile at n0 over k0..k0+7 from a tile stored
// [n][k] (K for S = Q K^T), split.
template <int LDT>
__device__ __forceinline__ void frag_b_nk(uint32_t (&hi)[2],
                                          uint32_t (&lo)[2],
                                          const float* tile, int n0, int k0,
                                          int g, int t) {
  const float* p = tile + (n0 + g) * LDT + k0 + t;
  const float x[2] = {p[0], p[4]};
  split_tf32(x, hi, lo);
}

// The B fragment of the n8 tile at n0 over rows k0..k0+7 of a tile
// stored [k][n] (V for O = P V), in the permuted k order of frag_c_as_a:
// rows k0 + 2t and k0 + 2t + 1, split.
template <int LDT>
__device__ __forceinline__ void frag_b_kn(uint32_t (&hi)[2],
                                          uint32_t (&lo)[2],
                                          const float* tile, int k0, int n0,
                                          int g, int t) {
  const float* p = tile + (k0 + 2 * t) * LDT + n0 + g;
  const float x[2] = {p[0], p[LDT]};
  split_tf32(x, hi, lo);
}

// An accumulator tile (16 rows x 8 columns) as the A fragment of a
// product over those 8 columns, split (the note at the top).
__device__ __forceinline__ void frag_c_as_a(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split_tf32(x, hi, lo);
}

// acc[n] = A B^T for the 16 rows at r0 of tile a and the NS n8 tiles at
// n0 of tile b, both stored [row][k] with row stride LDT, over KSTEPS
// k-steps of 8: tensor-core sums of at most kSumSteps k-steps, added in
// f32.
template <int LDT, int KSTEPS, int NS>
__device__ __forceinline__ void dot_tiles(float (&acc)[NS][4], const float* a,
                                          int r0, const float* b, int n0,
                                          int g, int t) {
#pragma unroll
  for (int c0 = 0; c0 < KSTEPS; c0 += kSumSteps) {
    float part[NS][4] = {};
#pragma unroll
    for (int kk = c0; kk < c0 + kSumSteps && kk < KSTEPS; ++kk) {
      uint32_t ah[4], al[4];
      frag_a<LDT>(ah, al, a, r0, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bh[2], bl[2];
        frag_b_nk<LDT>(bh, bl, b, n0 + n * 8, kk * 8, g, t);
        mma_3xtf32(part[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = c0 == 0 ? part[n][e] : acc[n][e] + part[n][e];
  }
}

// The KS accumulator tiles c (16 rows x 8 KS columns) as split A
// fragments of a product over those columns
template <int KS>
__device__ __forceinline__ void split_c_tiles(uint32_t (&hi)[KS][4],
                                              uint32_t (&lo)[KS][4],
                                              const float (&c)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) frag_c_as_a(hi[kk], lo[kk], c[kk]);
}

// acc[n] += P B for P's KS k-steps (split_c_tiles' fragments ph, pl) and
// the NO n8 tiles at column n1 of tile b, stored [k][n] with row stride
// LDT from row k0: one tensor-core sum per n8 tile, added in f32.
template <int LDT, int KS, int NO>
__device__ __forceinline__ void mul_tiles(float (&acc)[NO][4],
                                          const uint32_t (&ph)[KS][4],
                                          const uint32_t (&pl)[KS][4],
                                          const float* b, int k0, int n1,
                                          int g, int t) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += kSumSteps) {
      float part[4] = {};
#pragma unroll
      for (int kk = c0; kk < c0 + kSumSteps && kk < KS; ++kk) {
        uint32_t bh[2], bl[2];
        frag_b_kn<LDT>(bh, bl, b, k0 + kk * 8, n1 + n * 8, g, t);
        mma_3xtf32(part, ph[kk], pl[kk], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
  }
}

// Rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a (seq, ld)
// f32 matrix into a tile of row stride LDT by 16-byte cp.async copies;
// rows at or past seq are zero-filled. Every thread of the CTA takes
// part; the caller commits.
template <int ROWS, int COLS, int LDT>
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             int ld, int row0, int col0,
                                             int seq) {
  constexpr int kChunks = COLS / 4;            // 16-byte chunks per row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int i0 = 0; i0 < kTotal; i0 += kMmaThreads) {
    const int i = i0 + threadIdx.x;
    if (kTotal % kMmaThreads == 0 || i < kTotal) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const int g = row0 + r;
      const bool in = g < seq;
      cp_async16(dst + r * LDT + c,
                 src + (in ? static_cast<long long>(g) * ld + col0 + c : 0),
                 in ? 16 : 0);
    }
  }
}

// N f32 values [row0, row0 + N) of a per-row vector; past seq: zeros
template <int N>
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src,
                                             int row0, int seq) {
  static_assert(N <= kMmaThreads, "one value a thread");
  if (threadIdx.x < N) {
    const int g = row0 + threadIdx.x;
    const bool in = g < seq;
    cp_async4(dst + threadIdx.x, src + (in ? g : 0), in ? 4 : 0);
  }
}

// -- wgmma: f32 tiles as TMA writes them ----------------------------------
//
// The f32 kernels on wgmma (flash_fwd.cu's flash_fwd_tf32_wgmma_kernel,
// flash_bwd.cu's flash_dq_tf32_wgmma_kernel and
// flash_dkv_tf32_wgmma_kernel) keep f32 tiles in 32-float column blocks
// of 128-byte rows in the 128-byte swizzle (rows_map<float>), read by
// wgmma through K-major descriptors (TF32 takes no transpose), and gather
// A fragments from them into registers, split there.

// byte offset of element (r, c) of an f32 tile of `rows` rows: column
// block c / 32, row r, its 16-byte chunks XOR-permuted by r % 8
__device__ __forceinline__ uint32_t f32_at(int rows, int r, int c) {
  return (c >> 5) * rows * 128 + r * 128 +
         ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// K-major descriptor of k-step kk (columns 8 kk .. 8 kk + 7) of an f32 tile
// of `rows` rows, from row `row0` (a multiple of 8) on
__device__ __forceinline__ uint64_t f32_kmajor(uint32_t tile, int rows,
                                               int row0, int kk) {
  return wgmma_desc(tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32,
                    16, 1024, 128);
}

// rows row0 .. and D columns from col0 on of an f32 map (the tensor's
// head_dim, seq, bh) whose box is `rows` rows of 32 floats, into the tile
// at `dst`, completing on `bar`
template <int D>
__device__ __forceinline__ void f32_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int row0,
                                         int bh, int col0 = 0) {
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
    tma_load_3d(dst + c * rows * 128, map, bar, col0 + c * 32, row0, bh);
}

// The lo parts of a tile as TMA wrote it, which wgmma reads as its hi
// parts (its top 19 bits, truncated): lo = x - trunc(x), exact, at the
// same offsets in `dst`; thread i of `threads` takes every threads-th 16
// bytes of `bytes`.
__device__ __forceinline__ void split_lo(unsigned char* dst,
                                         const unsigned char* src, int bytes,
                                         int i, int threads) {
  for (int at = 16 * i; at < bytes; at += 16 * threads) {
    const float4 x = *reinterpret_cast<const float4*>(src + at);
    float4 y;
    y.x = x.x - __uint_as_float(__float_as_uint(x.x) & 0xffffe000u);
    y.y = x.y - __uint_as_float(__float_as_uint(x.y) & 0xffffe000u);
    y.z = x.z - __uint_as_float(__float_as_uint(x.z) & 0xffffe000u);
    y.w = x.w - __uint_as_float(__float_as_uint(x.w) & 0xffffe000u);
    *reinterpret_cast<float4*>(dst + at) = y;
  }
}

// The split A fragment of k-step kk for this warp's 16 rows m0 .. of an
// operand stored [m][k] (K-major) in an f32 tile of `rows` rows, by one
// ldmatrix.x4: its four 8 x 8 b16 matrices are the 8 x 4 f32 blocks
// (rows m0, m0 + 8; columns 8 kk, 8 kk + 4), each row one 16-byte chunk
// of the swizzle, and thread 4 g + t receives word t of row g of each:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
__device__ __forceinline__ void frag_mk(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const unsigned char* tile, int rows,
                                        int m0, int kk, int g, int t) {
  const int lane = 4 * g + t, j = lane >> 3;
  uint32_t r[4];
  ldmatrix_x4(r, tile + f32_at(rows, m0 + (lane & 7) + 8 * (j & 1),
                               8 * kk + 4 * (j >> 1)));
  const float x[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]),
                      __uint_as_float(r[2]), __uint_as_float(r[3])};
  split_tf32(x, hi, lo);
}

// d = A B over KSTEPS k-steps of 8 in split TF32: per k-step a_hi b_lo,
// a_lo b_hi, then a_hi b_hi (a_hi b_hi alone in the one-pass control), A's
// split fragments from frag(kk, hi, lo), B's hi and lo tiles through
// desc(kk, false) and desc(kk, true); one tensor-core sum from zero. Two
// k-steps are committed as one group and at most two groups are in
// flight: the next group's fragments are gathered while the last runs
// (one k-step a group ran slower at the LM's shape). The last group is
// left in flight.
template <int N, int KSTEPS, typename Frag, typename Desc>
__device__ __forceinline__ void product_3xtf32(float (&d)[N / 2], Frag frag,
                                               Desc desc) {
  static_assert(KSTEPS % 2 == 0, "two k-steps a group");
  uint32_t hi[2][2][4], lo[2][2][4];
#pragma unroll
  for (int k0 = 0; k0 < KSTEPS; k0 += 2) {
    const int b = (k0 >> 1) & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) frag(k0 + i, hi[b][i], lo[b][i]);
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = k0 + i, acc = kk == 0 ? 0 : 1;
#ifdef SPARKNET_FLASH_TF32_ONE_PASS
      wgmma_tf32<N>(d, hi[b][i], desc(kk, false), acc);
#else
      wgmma_tf32<N>(d, hi[b][i], desc(kk, true), acc);
      wgmma_tf32<N>(d, lo[b][i], desc(kk, false), 1);
      wgmma_tf32<N>(d, hi[b][i], desc(kk, false), 1);
#endif
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(d);
  }
}

}  // namespace sparknet_flash
