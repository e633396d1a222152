// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (B*H, S, D) in the
// storage type T (float or __nv_bfloat16); lse and delta are (B*H, S) f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sparknet_flash {

constexpr int kBlockQ = 64;     // query rows per tile (tensor-core kernels)
constexpr int kBlockK = 64;     // key rows per tile (tensor-core kernels)
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF: finite, so
                                   // exp(m_prev - m_new) never sees inf-inf

// Is score (row r, column c) outside the attention: past the sequence,
// or above the diagonal when causal?
__device__ __forceinline__ bool masked(int r, int c, int seq, int causal) {
  return r >= seq || c >= seq || (causal && c > r);
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
