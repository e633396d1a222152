// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (B*H, S, D) in the
// storage type T (float or __nv_bfloat16); lse and delta are (B*H, S) f32.
// The CUDA-core helpers below (tile_dot, tile_mul) serve the dK/dV kernel
// past head_dim 256 (flash_wide.cuh): a CTA of kThreads threads over an
// R-row tile staged in shared memory as f32 with a row stride of D + 1
// (an odd stride keeps the column reads of 16 neighbouring rows on 16
// distinct banks), every product accumulated in f32. Thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty*RI .. ty*RI+RI-1 (RI = R / 16) of an
// R x R score tile and its columns tx, tx+16, ....

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sparknet_flash {

constexpr int kBlockQ = 64;     // query rows per tile (tensor-core kernels)
constexpr int kBlockK = 64;     // key rows per tile (tensor-core kernels)
constexpr int kThreads = 256;   // 16 x 16 (the wide dK/dV kernel)
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF: finite, so
                                   // exp(m_prev - m_new) never sees inf-inf

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as the plain
}                               // version's .to(torch.bfloat16)

// Is score (row r, column c) outside the attention: past the sequence,
// or above the diagonal when causal?
__device__ __forceinline__ bool masked(int r, int c, int seq, int causal) {
  return r >= seq || c >= seq || (causal && c > r);
}

// An RI x RI block (RI = R / 16) of an R x R score-like tile:
// acc[i][j] += sum_d a[ty*RI+i][d] * b[tx+16j][d], both operands f32 smem
// tiles with row stride D + 1.
template <int D, int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R / 16][R / 16],
                                         const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int RI = R / 16;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[RI], y[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = a[(ty * RI + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < RI; ++j) y[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][jd] += sum_c p[ty*RI+i][c] * m[c][tx+16jd] for an (R, R) score
// tile p (row stride R + 1) and an (R, D) tile m (row stride D + 1); with
// `transposed`, p is read as p[c][ty*RI+i] (P^T times m).
template <int D, int R, bool transposed>
__device__ __forceinline__ void tile_mul(float (&acc)[R / 16][D / 16],
                                         const float* p, const float* m,
                                         int ty, int tx) {
  constexpr int RI = R / 16, LP = R + 1;
#pragma unroll 4
  for (int c = 0; c < R; ++c) {
    float x[RI], y[D / 16];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      x[i] = transposed ? p[c * LP + ty * RI + i] : p[(ty * RI + i) * LP + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = m[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Run `launch.template run<T, D>()` for a (dtype, head_dim) pair the
// kernels are built for; cudaErrorInvalidValue for any other.
template <typename Launch>
int dispatch(int dtype, int head_dim, const Launch& launch) {
#define SPARKNET_FLASH_D(T)                                      \
  switch (head_dim) {                                            \
    case 16: return launch.template run<T, 16>();                \
    case 32: return launch.template run<T, 32>();                \
    case 64: return launch.template run<T, 64>();                \
    case 128: return launch.template run<T, 128>();              \
    case 256: return launch.template run<T, 256>();              \
    default: return cudaErrorInvalidValue;                       \
  }
  if (dtype == 0) { SPARKNET_FLASH_D(float) }
  if (dtype == 1) { SPARKNET_FLASH_D(__nv_bfloat16) }
#undef SPARKNET_FLASH_D
  return cudaErrorInvalidValue;
}

}  // namespace sparknet_flash
