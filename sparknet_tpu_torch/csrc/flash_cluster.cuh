// The two-CTA clusters of the f32 flash kernels at head_dim 256 (split
// TF32 on wgmma): flash_fwd.cu's flash_fwd_tf32_wgmma256_kernel and
// flash_bwd.cu's flash_dq_tf32_wgmma256_kernel and
// flash_dkv_tf32_wgmma256_kernel. Each CTA of a cluster ("rank") owns 128
// of the 256 columns of D and builds a partial score tile over them; a
// tile's scores are split between the ranks, each thread holding the same
// places of the tile in both ranks, so a thread trades the half of its
// partial that the other rank finishes for the half it finishes itself
// with the thread in the same place of the other rank (its twin):
//  - xch_send: st.async of a thread's values into its slots of an
//    exchange buffer in the other rank, completing on that rank's
//    mbarrier (the sender never waits); xch_read reads one's own slots.
//    A buffer holds N f32 of each of a warpgroup's 128 threads, 16 bytes
//    a slot, thread w's slots at w, 128 + w, ...: a warp's loads and
//    stores are 16-byte and free of bank conflicts.
//  - half_of (an m64n32 S^T tile of the backward: its queries 0-15 or
//    16-31) and row_half_of (an m64n64 S tile of the forward: each warp's
//    rows g or g + 8) pick the half; summed_half adds the two ranks'
//    partials of it in rank order, in f32.
//  - launch_cluster launches a kernel on clusters of kTf32Ranks CTAs
//    along the grid's x axis through cudaLaunchKernelEx; a launch the
//    card refuses returns its error (nothing falls back).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "flash_wide.cuh"

namespace sparknet_flash {

constexpr int kTf32Ranks = 2;   // CTAs of a head_dim-256 cluster

// N f32 of this thread (warpgroup thread w) into its slots of the
// exchange buffer `buf` of rank `to`, completing on that rank's mbarrier
// `bar`: the sender never waits
template <int N>
__device__ __forceinline__ void xch_send(const float (&x)[N], uint32_t buf,
                                         uint32_t bar, int to, int w) {
  static_assert(N % 4 == 0, "16-byte slots");
  const uint32_t rb = mapa_u32(bar, to);
#pragma unroll
  for (int u = 0; u < N / 4; ++u) {
    const uint32_t v[4] = {__float_as_uint(x[4 * u]),
                           __float_as_uint(x[4 * u + 1]),
                           __float_as_uint(x[4 * u + 2]),
                           __float_as_uint(x[4 * u + 3])};
    st_async(mapa_u32(buf + (u * 128 + w) * 16, to), v, rb);
  }
}

// this thread's N f32 of an exchange buffer (its own shared memory)
template <int N>
__device__ __forceinline__ void xch_read(float (&y)[N],
                                         const unsigned char* buf, int w) {
#pragma unroll
  for (int u = 0; u < N / 4; ++u) {
    const float4 v =
        *reinterpret_cast<const float4*>(buf + (u * 128 + w) * 16);
    y[4 * u] = v.x;
    y[4 * u + 1] = v.y;
    y[4 * u + 2] = v.z;
    y[4 * u + 3] = v.w;
  }
}

// An m64n32 accumulator's two halves: its registers of queries 0-15
// (0-7) or 16-31 (8-15) of the tile, h 0 or 1 (h at run time: selects,
// no indexed registers)
__device__ __forceinline__ void half_of(float (&y)[8], const float (&x)[16],
                                        int h) {
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = h == 0 ? x[i] : x[8 + i];
}

// An m64n64 accumulator's two halves: its registers of row g (h 0) or
// g + 8 (h 1) of the warp's 16, registers 4 n + 2 h and 4 n + 2 h + 1
// (keys 8 n + 2 t and + 1) into y[2 n], y[2 n + 1]
__device__ __forceinline__ void row_half_of(float (&y)[16],
                                            const float (&x)[32], int h) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      y[2 * n + b] = h == 0 ? x[4 * n + b] : x[4 * n + 2 + b];
}

// The half of a score tile that this rank finishes, summed over both
// ranks' columns: the other rank's partial, received in `buf`, and this
// rank's (`mine`), added in rank order (two terms: the same f32 sum
// either way)
template <int N>
__device__ __forceinline__ void summed_half(float (&s)[N],
                                            const float (&mine)[N],
                                            const unsigned char* buf,
                                            int rank, int w) {
  float theirs[N];
  xch_read(theirs, buf, w);
#pragma unroll
  for (int i = 0; i < N; ++i)
    s[i] = rank == 0 ? mine[i] + theirs[i] : theirs[i] + mine[i];
}

// Launch `kernel` on `grid` (x: kTf32Ranks, the ranks of a cluster) in
// clusters of kTf32Ranks CTAs along x, `threads` threads and `bytes` of
// dynamic shared memory a CTA; -> the launch's error code (a cluster
// launch the card refuses included: nothing falls back).
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, dim3 grid, int threads, size_t bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kTf32Ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sparknet_flash
