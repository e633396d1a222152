// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (B*H, S, D) in the
// storage type T (float or __nv_bfloat16); lse and delta are (B*H, S) f32.
// A CTA of kThreads threads owns one 64-row tile of one (b, h): tiles are
// staged in shared memory as f32 with a row stride of D + 1 (an odd stride
// keeps the column reads of 16 neighbouring rows on 16 distinct banks),
// and every product accumulates in f32. Thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty*4 .. ty*4+3 of a score tile and its columns
// tx, tx+16, tx+32, tx+48; the 16 threads of a row are half a warp, so a
// row's max and sum are xor shuffles over lanes 8, 4, 2, 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sparknet_flash {

constexpr int kBlockQ = 64;     // query rows per tile
constexpr int kBlockK = 64;     // key rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLP = kBlockK + 1;  // row stride of a score tile in smem
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

// rows [row0, row0 + kBlockQ) of a (seq, D) matrix -> f32 smem tile with
// row stride D + 1, times `mult`; rows at or past seq read as zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int seq, float mult) {
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] =
        g < seq ? to_f32(src[static_cast<long long>(g) * D + c]) * mult : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Is score (row r, column c) outside the attention: past the sequence,
// or above the diagonal when causal?
__device__ __forceinline__ bool masked(int r, int c, int seq, int causal) {
  return r >= seq || c >= seq || (causal && c > r);
}

// A 4x4 block of a score-like tile: acc[i][j] += sum_d a[ty*4+i][d] *
// b[tx+16j][d], both operands f32 smem tiles with row stride D + 1.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][jd] += sum_c p[ty*4+i][c] * m[c][tx+16jd] for a (64, 64) score
// tile p (row stride kLP) and a (64, D) tile m (row stride D + 1); with
// `transposed`, p is read as p[c][ty*4+i] (P^T times m).
template <int D, bool transposed>
__device__ __forceinline__ void tile_mul(float (&acc)[4][D / 16],
                                         const float* p, const float* m,
                                         int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kBlockK; ++c) {
    float x[4], y[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = transposed ? p[c * kLP + ty * 4 + i] : p[(ty * 4 + i) * kLP + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = m[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
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
    default: return cudaErrorInvalidValue;                       \
  }
  if (dtype == 0) { SPARKNET_FLASH_D(float) }
  if (dtype == 1) { SPARKNET_FLASH_D(__nv_bfloat16) }
#undef SPARKNET_FLASH_D
  return cudaErrorInvalidValue;
}

// Opt the kernel in to `bytes` of dynamic shared memory (above 48 KB
// needs it), launch it on a (ceil(seq / 64), bh) grid, and return the
// launch's error code.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int bh, int seq, size_t bytes,
                 cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + kBlockQ - 1) / kBlockQ, bh);
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace sparknet_flash
