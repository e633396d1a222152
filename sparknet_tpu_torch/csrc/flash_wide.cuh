// Flash attention past head_dim 256: the forward, dQ and dK/dV kernels for
// any D that is a multiple of 64 (the wrappers zero-pad D to one), f32 and
// bf16 storage, every product on the CUDA cores in f32.
//
// The D <= 256 kernels hold whole (rows, D) tiles, and an accumulator of
// all D output columns, on chip; past 256 neither fits (PERF.md, section 6).
// Here a CTA of kThreads threads owns one 64-row tile of one (b, h) and
// one 64-column chunk of the output (blockIdx.z), and:
//   * builds each 64 x 64 score tile S = Q K^T (and dP = dO V^T in the
//     backward) by walking D in 64-column chunks through shared memory,
//     accumulating in registers (wide_dot);
//   * multiplies the score tile by its 64-column chunk of V (of K, Q and
//     dO in the backward) into its own output columns.
// Each CTA recomputes the scores over all of D: D / 64 times the work of
// one pass, traded for a design that fits at any D.
//
// The arithmetic is the plain versions': the forward scales Q before Q K^T,
// the backward scales the product; masked scores are -1e30 and l is floored
// at 1e-30. bf16 storage is read as f32 and the outputs rounded once.

#pragma once

#include "flash_common.cuh"

namespace sparknet_flash {

constexpr int kWideR = 64;                    // rows of a query / key tile
constexpr int kWideC = 64;                    // head_dim columns a chunk
constexpr int kWideLd = kWideC + 1;           // smem row stride (floats)
constexpr int kWideTile = kWideR * kWideLd;   // one staged tile (floats)

// rows [row0, row0 + 64) and columns [col0, col0 + 64) of a (seq, D)
// matrix -> an f32 smem tile with row stride 65, times `mult`; rows at or
// past seq read as zero
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int row0,
                                           int seq, int D, int col0,
                                           float mult) {
  for (int i = threadIdx.x; i < kWideR * kWideC; i += kThreads) {
    const int r = i / kWideC, c = i % kWideC, g = row0 + r;
    dst[r * kWideLd + c] =
        g < seq ? to_f32(src[static_cast<long long>(g) * D + col0 + c]) * mult
                : 0.f;
  }
}

// acc = (mult * A[a0 .. a0+64)) B[b0 .. b0+64)^T over all D columns, 64 at
// a time through the smem tiles as and bs. Starts with a barrier, so the
// caller's earlier reads of as and bs are done before they are refilled.
template <typename T>
__device__ __forceinline__ void wide_dot(float (&acc)[4][4], float* as,
                                         float* bs, const T* a, int a0,
                                         const T* b, int b0, int seq, int D,
                                         float mult, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kWideC) {
    __syncthreads();
    load_chunk(as, a, a0, seq, D, c0, mult);
    load_chunk(bs, b, b0, seq, D, c0, 1.f);
    __syncthreads();
    tile_dot<kWideC, kWideR>(acc, as, bs, ty, tx);
  }
}

// O = softmax(scale Q K^T [causal]) V for one 64-row query tile and one
// 64-column chunk of O; the chunk-0 CTA writes LSE.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int seq, int D,
                          float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kWideTile;
  float* ps = ks + kWideTile;
  float* vs = ps + kWideTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kWideR, col0 = blockIdx.z * kWideC;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  q += base;
  k += base;
  v += base;
  o += base;
  float m[4], l[4], acc[4][4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int n_k = causal ? blockIdx.x + 1 : (seq + kWideR - 1) / kWideR;
  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * kWideR;
    wide_dot(s, qs, ks, q, q0, k, k0, seq, D, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (masked(r, k0 + tx + 16 * j, seq, causal)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        ps[(ty * 4 + i) * kWideLd + tx + 16 * j] = p;
        acc[i][j] *= alpha;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = mn;
    }
    load_chunk(vs, v, k0, seq, D, col0, 1.f);
    __syncthreads();
    tile_mul<kWideC, kWideR, false>(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= seq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[static_cast<long long>(r) * D + col0 + tx + 16 * j] =
          from_f32<T>(acc[i][j] / lc);
    if (blockIdx.z == 0 && tx == 0)
      lse[static_cast<long long>(blockIdx.y) * seq + r] = m[i] + logf(lc);
  }
}

// dQ = scale dS K for one 64-row query tile and one 64-column chunk of dQ,
// dS = P (dO V^T - delta); every CTA computes its rows' delta =
// rowsum(dO O) over all D, and the chunk-0 CTA writes it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse, T* __restrict__ dq,
                         float* __restrict__ delta, int seq, int D,
                         float scale, int causal) {
  extern __shared__ float smem[];
  float* as = smem;
  float* bs = as + kWideTile;
  float* ds = bs + kWideTile;
  float* lse_s = ds + kWideTile;
  float* delta_s = lse_s + kWideR;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kWideR, col0 = blockIdx.z * kWideC;
  const long long row_base = static_cast<long long>(blockIdx.y) * seq;
  const long long base = row_base * D;
  q += base;
  k += base;
  v += base;
  o += base;
  dout += base;
  dq += base;
  {  // delta: four threads a row, then two xor shuffles
    const int r = tid / 4, part = tid % 4, g = q0 + r;
    float sum = 0.f;
    if (g < seq)
      for (int c = part; c < D; c += 4)
        sum += to_f32(dout[static_cast<long long>(g) * D + c]) *
               to_f32(o[static_cast<long long>(g) * D + c]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      delta_s[r] = sum;
      lse_s[r] = g < seq ? lse[row_base + g] : 0.f;
      if (g < seq && blockIdx.z == 0) delta[row_base + g] = sum;
    }
  }
  float acc[4][4], s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int n_k = causal ? blockIdx.x + 1 : (seq + kWideR - 1) / kWideR;
  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * kWideR;
    wide_dot(s, as, bs, q, q0, k, k0, seq, D, 1.f, ty, tx);
    wide_dot(dp, as, bs, dout, q0, v, k0, seq, D, 1.f, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = masked(q0 + r, k0 + tx + 16 * j, seq, causal)
                            ? 0.f
                            : expf(scale * s[i][j] - lse_s[r]);
        ds[r * kWideLd + tx + 16 * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();  // as is read by the last wide_dot until here
    load_chunk(as, k, k0, seq, D, col0, 1.f);
    __syncthreads();
    tile_mul<kWideC, kWideR, false>(acc, ds, as, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[static_cast<long long>(r) * D + col0 + tx + 16 * j] =
          from_f32<T>(scale * acc[i][j]);
  }
}

// dK = scale dS^T Q and dV = P^T dO for one 64-row key tile and one
// 64-column chunk of dK and dV, from the dQ kernel's delta.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int seq,
                          int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* as = smem;
  float* bs = as + kWideTile;
  float* ps = bs + kWideTile;   // P^T: rows keys, columns queries
  float* ds = ps + kWideTile;   // dS^T
  float* lse_s = ds + kWideTile;
  float* delta_s = lse_s + kWideR;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * kWideR, col0 = blockIdx.z * kWideC;
  const long long row_base = static_cast<long long>(blockIdx.y) * seq;
  const long long base = row_base * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  float acc_k[4][4], acc_v[4][4], st[4][4], dpt[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  const int n_q = (seq + kWideR - 1) / kWideR;
  for (int t = causal ? blockIdx.x : 0; t < n_q; ++t) {
    const int q0 = t * kWideR;
    // the last reads of lse_s / delta_s came before the barrier that
    // precedes the previous tile's products
    if (tid < kWideR) {
      const int g = q0 + tid;
      lse_s[tid] = g < seq ? lse[row_base + g] : 0.f;
      delta_s[tid] = g < seq ? delta[row_base + g] : 0.f;
    }
    wide_dot(st, as, bs, k, k0, q, q0, seq, D, 1.f, ty, tx);
    wide_dot(dpt, as, bs, v, k0, dout, q0, seq, D, 1.f, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = masked(q0 + c, k0 + r, seq, causal)
                            ? 0.f
                            : expf(scale * st[i][j] - lse_s[c]);
        ps[r * kWideLd + c] = p;
        ds[r * kWideLd + c] = p * (dpt[i][j] - delta_s[c]);
      }
    }
    __syncthreads();  // as and bs are read by the last wide_dot until here
    load_chunk(as, dout, q0, seq, D, col0, 1.f);
    load_chunk(bs, q, q0, seq, D, col0, 1.f);
    __syncthreads();
    tile_mul<kWideC, kWideR, false>(acc_v, ps, as, ty, tx);
    tile_mul<kWideC, kWideR, false>(acc_k, ds, bs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long at = static_cast<long long>(r) * D + col0 + tx + 16 * j;
      dk[at] = from_f32<T>(scale * acc_k[i][j]);
      dv[at] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// dynamic shared memory of the three kernels (0: forward, 1: dQ, 2: dK/dV)
inline size_t wide_smem(int which) {
  return sizeof(float) * (which == 0   ? 4 * kWideTile
                          : which == 1 ? 3 * kWideTile + 2 * kWideR
                                       : 4 * kWideTile + 2 * kWideR);
}

template <typename Kernel, typename... Args>
int launch_wide(Kernel kernel, int which, int bh, int seq, int D,
                cudaStream_t stream, Args... args) {
  if (D % kWideC != 0) return cudaErrorInvalidValue;
  const size_t bytes = wide_smem(which);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + kWideR - 1) / kWideR, bh, D / kWideC);
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// Run `fn(T{})` for dtype 0 = f32, 1 = bf16; cudaErrorInvalidValue else.
template <typename Fn>
int wide_dispatch(int dtype, const Fn& fn) {
  if (dtype == 0) return fn(float{});
  if (dtype == 1) return fn(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

inline int wide_forward(const void* q, const void* k, const void* v, void* o,
                        float* lse, int dtype, int bh, int seq, int D,
                        float scale, int causal, cudaStream_t stream) {
  return wide_dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch_wide(flash_wide_fwd_kernel<T>, 0, bh, seq, D, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(o), lse,
                       seq, D, scale, causal);
  });
}

inline int wide_dq(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, float* delta,
                   int dtype, int bh, int seq, int D, float scale, int causal,
                   cudaStream_t stream) {
  return wide_dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch_wide(flash_wide_dq_kernel<T>, 1, bh, seq, D, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<const T*>(o),
                       static_cast<const T*>(dout), lse, static_cast<T*>(dq),
                       delta, seq, D, scale, causal);
  });
}

inline int wide_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int dtype, int bh, int seq, int D,
                    float scale, int causal, cudaStream_t stream) {
  return wide_dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch_wide(flash_wide_dkv_kernel<T>, 2, bh, seq, D, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<const T*>(dout),
                       lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
                       seq, D, scale, causal);
  });
}

// registers a thread, local memory a thread (spills), dynamic shared
// memory and resident CTAs per SM of one wide kernel, into out[0..3]
template <typename Kernel>
int wide_fill_info(Kernel kernel, int which, int* out) {
  const size_t bytes = wide_smem(which);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(bytes);
  out[3] = ctas;
  return cudaSuccess;
}

inline int wide_info(int which, int dtype, int* out) {
  return wide_dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return which == 0   ? wide_fill_info(flash_wide_fwd_kernel<T>, 0, out)
           : which == 1 ? wide_fill_info(flash_wide_dq_kernel<T>, 1, out)
                        : wide_fill_info(flash_wide_dkv_kernel<T>, 2, out);
  });
}

}  // namespace sparknet_flash
