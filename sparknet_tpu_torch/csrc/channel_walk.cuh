// Shared body of the port's channel-window kernels (lrn.cu, epilogue.cu,
// lrn_bwd.cu).
//
// An NCHW tensor is viewed as (N, C, HW). One thread owns one (n, p) column
// and walks its C channels in order; neighbouring threads own neighbouring
// spatial positions p, so every load and store of a warp is one coalesced
// 128-byte line (f32) and every element is read once and written once.
//
// The cross-channel window for output channel c covers input channels
// [c - half, c + size - 1 - half] with half = (size - 1) / 2 (asymmetric for
// even size), zero outside [0, C). Each thread keeps the last `size` values
// of its column in a private ring in shared memory (slot s of thread t at
// ring[s * kThreads + t]: consecutive threads hit consecutive banks) and
// re-sums the `size` squares at every channel. That costs `size` shared
// loads and FMAs per output, nothing next to the device-memory traffic,
// and cannot drift the way a running add-and-subtract sum does over
// hundreds of channels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sparknet {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// x[c] of this thread's column, or max(x[c] + bias[c], 0) with kBiasRelu.
template <typename T, bool kBiasRelu>
__device__ __forceinline__ float column_value(const T* col, const T* bias,
                                              int c, long long hw) {
  float v = load_f32(col + c * hw);
  if (kBiasRelu) v = fmaxf(v + load_f32(bias + c), 0.f);
  return v;
}

// kLRN: out = v * (k + alpha_over_size * sum_{window} v^2)^-beta, where v is
// x (plain LRN) or max(x + b, 0) (epilogue). Without kLRN: out = v.
// All math in f32 whatever T is.
template <typename T, bool kBiasRelu, bool kLRN>
__global__ void __launch_bounds__(kThreads)
    channel_walk(const T* __restrict__ x, const T* __restrict__ bias,
                 T* __restrict__ out, int channels, long long hw, int size,
                 float alpha_over_size, float beta, float k) {
  extern __shared__ float ring[];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= hw) return;  // threads own disjoint ring columns: no barrier
  const long long base =
      static_cast<long long>(blockIdx.y) * channels * hw + p;
  const T* col = x + base;
  T* dst = out + base;
  if (!kLRN) {
    for (int c = 0; c < channels; ++c)
      store_f32(dst + c * hw, column_value<T, kBiasRelu>(col, bias, c, hw));
    return;
  }
  const int half = (size - 1) / 2;
  float* mine = ring + threadIdx.x;
  // window of channel 0, all but its newest entry: indices [-half, size-2-half]
  for (int j = -half; j <= size - 2 - half; ++j) {
    const int slot = ((j % size) + size) % size;
    mine[slot * kThreads] =
        (j >= 0 && j < channels) ? column_value<T, kBiasRelu>(col, bias, j, hw)
                                 : 0.f;
  }
  for (int c = 0; c < channels; ++c) {
    const int j = c + size - 1 - half;  // enters; j - size leaves
    mine[(j % size) * kThreads] =
        j < channels ? column_value<T, kBiasRelu>(col, bias, j, hw) : 0.f;
    float sum = 0.f;
    for (int s = 0; s < size; ++s) {
      const float v = mine[s * kThreads];
      sum = fmaf(v, v, sum);
    }
    const float v = mine[(c % size) * kThreads];
    store_f32(dst + c * hw, v * powf(k + alpha_over_size * sum, -beta));
  }
}

// Launch on `stream`; returns cudaGetLastError() so a refused launch (too
// much shared memory, a bad grid) reaches the caller.
template <typename T, bool kBiasRelu, bool kLRN>
cudaError_t launch_channel_walk(const void* x, const void* bias, void* out,
                                int n, int channels, long long hw, int size,
                                float alpha_over_size, float beta, float k,
                                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n));
  const size_t smem =
      kLRN ? static_cast<size_t>(size) * kThreads * sizeof(float) : 0;
  auto fn = channel_walk<T, kBiasRelu, kLRN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<T*>(out), channels, hw, size, alpha_over_size, beta, k);
  return cudaGetLastError();
}

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// The backward of the cross-channel LRN on the same column walk:
//   scale(j) = k + alpha/size * sum_{window(j)} v^2
//   t(j)     = g(j) * v(j) * scale(j)^(-beta-1)
//   dv(c)    = g(c) * scale(c)^-beta
//            - coeff * v(c) * sum_{j = c-(size-1-half)}^{c+half} t(j)
// with coeff = 2*alpha*beta/size; the second sum runs over the forward
// window mirrored. v is x (plain LRN) or, with kBiasRelu, y = max(x + b, 0)
// rounded to T, as the reference forms y in the storage type; then
// dx = y > 0 ? dv : 0.
//
// dv(c) needs t up to c + half, so scale up to c + half, so v up to
// c + size - 1: the walk forms scale(j) and t(j) at step j and writes
// channel c = j - half. Each thread keeps three rings in shared memory
// (slot s of thread t at s * kThreads + t, as the forward does): v over the
// window of channel j (size slots), t over the mirrored window of channel
// c (size slots), and a(j) = g(j) * scale(j)^-beta from the step that forms
// it to the step that writes it (half + 1 slots). Every window is summed
// afresh at each step. x and g are read once per element, dx written once.
template <typename T, bool kBiasRelu>
__global__ void __launch_bounds__(kThreads)
    channel_walk_bwd(const T* __restrict__ x, const T* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dx,
                     int channels, long long hw, int size,
                     float alpha_over_size, float beta, float k,
                     float coeff) {
  extern __shared__ float ring[];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= hw) return;  // threads own disjoint ring columns: no barrier
  const long long base =
      static_cast<long long>(blockIdx.y) * channels * hw + p;
  const T* col = x + base;
  const T* gcol = g + base;
  T* dst = dx + base;
  const int half = (size - 1) / 2;
  const int na = half + 1;
  float* vr = ring + threadIdx.x;
  float* tr = vr + size * kThreads;
  float* ar = tr + size * kThreads;
  for (int s = 0; s < size; ++s) tr[s * kThreads] = 0.f;  // t(j < 0) = 0
  // v over [-half, size-2-half]: the window of channel 0 but its newest
  for (int j = -half; j <= size - 2 - half; ++j) {
    const int slot = ((j % size) + size) % size;
    float v = 0.f;
    if (j >= 0 && j < channels) {
      v = column_value<T, kBiasRelu>(col, bias, j, hw);
      if (kBiasRelu) v = round_to(v, col);
    }
    vr[slot * kThreads] = v;
  }
  for (int j = 0; j < channels + half; ++j) {
    const int e = j + size - 1 - half;  // enters the v ring; e - size leaves
    float v = 0.f;
    if (e < channels) {
      v = column_value<T, kBiasRelu>(col, bias, e, hw);
      if (kBiasRelu) v = round_to(v, col);
    }
    vr[(e % size) * kThreads] = v;
    float t = 0.f;
    if (j < channels) {
      float sum = 0.f;
      for (int s = 0; s < size; ++s) {
        const float u = vr[s * kThreads];
        sum = fmaf(u, u, sum);
      }
      const float scale = k + alpha_over_size * sum;
      const float gj = load_f32(gcol + j * hw);
      ar[(j % na) * kThreads] = gj * powf(scale, -beta);
      t = gj * vr[(j % size) * kThreads] * powf(scale, -beta - 1.f);
    }
    tr[(j % size) * kThreads] = t;  // t(j >= channels) = 0
    const int c = j - half;
    if (c < 0) continue;
    float acc = 0.f;
    for (int s = 0; s < size; ++s) acc += tr[s * kThreads];
    const float vc = vr[(c % size) * kThreads];
    float d = ar[(c % na) * kThreads] - coeff * vc * acc;
    if (kBiasRelu && !(vc > 0.f)) d = 0.f;
    store_f32(dst + c * hw, d);
  }
}

// Shared memory of one backward block: the three rings of its threads.
inline size_t channel_walk_bwd_smem(int size) {
  return static_cast<size_t>(2 * size + (size - 1) / 2 + 1) * kThreads *
         sizeof(float);
}

template <typename T, bool kBiasRelu>
cudaError_t launch_channel_walk_bwd(const void* x, const void* bias,
                                    const void* g, void* dx, int n,
                                    int channels, long long hw, int size,
                                    float alpha_over_size, float beta,
                                    float k, float coeff,
                                    cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n));
  const size_t smem = channel_walk_bwd_smem(size);
  auto fn = channel_walk_bwd<T, kBiasRelu>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<const T*>(g), static_cast<T*>(dx), channels, hw, size,
      alpha_over_size, beta, k, coeff);
  return cudaGetLastError();
}

}  // namespace sparknet
