// mma.sync building blocks of the flash-attention kernels: cp.async
// copies, ldmatrix fragment loads and the m16n8k16 bf16 mma with f32
// accumulation, which the bf16 kernels past head_dim 256 (flash_wide.cuh)
// run on bf16 shared-memory tiles whose row stride is padded by 16 bytes,
// so the 8 rows an ldmatrix phase reads start on 8 distinct 16-byte bank
// groups; the launch of the f32 kernels (launch_mma). The bf16 kernels up
// to head_dim 256 run on wgmma instead (flash_wgmma.cuh) and take
// smem_addr, pack_bf16, dot8_bf16 and kLog2e from here.
//
// Fragments of mma.m16n8k16 (lane = 4 g + t, g in 0..7, t in 0..3):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16x8, f32):        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// Two neighbouring C tiles (n 0-7, 8-15) packed to bf16 pairs are one A
// fragment over k 0-15, which is how P and dS go from the accumulators
// of one product straight into the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sparknet_flash {

constexpr int kMmaThreads = 128;   // 4 warps, each 16 rows of the CTA's 64
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, one m16n8k16 product in bf16 with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of bf16 (round to nearest even), lo in the low
// half: the element with the lower column index, as the fragments want
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment addresses inside a tile of row stride LD (bf16 elements), for
// this lane of an ldmatrix.x4:
//  - a_frag: the A fragment of the 16x16 block at (r0, c0) of a row-major
//    matrix;
//  - b_frag: the B fragments of two n8 tiles (n0, n0 + 8) over k0..k0+15
//    from a matrix stored [n][k] (regs 0, 1: n0; regs 2, 3: n0 + 8);
//  - bt_frag: the same from a matrix stored [k][n], for ldmatrix .trans.
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* a_frag(
    const __nv_bfloat16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}

template <int LD>
__device__ __forceinline__ const __nv_bfloat16* b_frag(
    const __nv_bfloat16* tile, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
         ((lane >> 3) & 1) * 8;
}

template <int LD>
__device__ __forceinline__ const __nv_bfloat16* bt_frag(
    const __nv_bfloat16* tile, int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
         (lane >> 4) * 8;
}

// sum of the products of 8 bf16 pairs, in f32
__device__ __forceinline__ float dot8_bf16(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// Opt the kernel in to `bytes` of dynamic shared memory with the largest
// shared-memory carveout (so two CTAs of ~105 KB fit on an SM), launch it
// on a (bh, ceil(seq / 64)) grid of kMmaThreads threads, and
// return the launch's error code. The tile index is the slow grid axis,
// so every (b, h) starts its tile 0 before any starts tile 1.
template <typename Kernel, typename... Args>
int launch_mma(Kernel kernel, int bh, int seq, size_t bytes,
               cudaStream_t stream, Args... args) {
  const int tiles = (seq + 63) / 64;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, tiles), kMmaThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace sparknet_flash
