// Fused convolution epilogue for Hopper (sm_90a): bias + ReLU, optionally
// followed by the cross-channel LRN, on the raw (bias-free) conv output.
//
// Replaces the TPU kernels sparknet_tpu/ops/pallas_epilogue.py:
//   _bias_relu_kernel      out = max(x + b[c], 0)                 (kLRN false)
//   _bias_relu_lrn_kernel  y = max(x + b[c], 0)
//                          out = y * (k + alpha/size * sum_{window} y^2)^-beta
// both reached through _call_epilogue there. One kernel template,
// channel_walk<T, /*kBiasRelu=*/true, kLRN, kVec> (channel_walk.cuh),
// covers both; the pre-LRN y lives only in registers, formed from the x
// staged in shared memory, never in device memory.
//
// Bound on the H100: device memory. At GoogLeNet conv2/3x3 (8, 192, 56, 56)
// f32 the fused bias+ReLU+LRN moves 2 x 8*192*3136*4 B = 38.5 MB, about
// 11.5 us at 3.35 TB/s; the unfused chain (bias, ReLU, LRN as separate
// passes) moves that several times over.
//
// What the design does about it: the LRN forward's tiling (lrn.cu): a CTA
// stages up to 32 channels of one image over up to 128 columns, with the
// window's halo, through cp.async, all copies in flight before any use,
// and writes 16 bytes a thread where the rows are 16-byte aligned. A halo
// row outside [0, C) takes the bias -inf, so its y is 0. Bias+ReLU alone
// stages no halo. The bias is C values, staged once per CTA.

#include "channel_walk.cuh"

namespace {

template <typename T>
int epilogue(const void* x, const void* bias, void* out, int with_lrn, int n,
             int channels, long long hw, int size, float alpha_over_size,
             float beta, float k, cudaStream_t s, int aligned = -1,
             int* info = nullptr) {
  return with_lrn
             ? sparknet::channel_walk_entry<T, true, true>(
                   x, bias, out, n, channels, hw, size, alpha_over_size,
                   beta, k, s, aligned, info)
             : sparknet::channel_walk_entry<T, true, false>(
                   x, bias, out, n, channels, hw, size, alpha_over_size,
                   beta, k, s, aligned, info);
}

}  // namespace

extern "C" int sparknet_epilogue_forward(const void* x, const void* bias,
                                         void* out, int dtype, int with_lrn,
                                         int n, int channels, long long hw,
                                         int size, float alpha_over_size,
                                         float beta, float k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return epilogue<float>(x, bias, out, with_lrn, n, channels, hw, size,
                           alpha_over_size, beta, k, s);
  if (dtype == 1)
    return epilogue<__nv_bfloat16>(x, bias, out, with_lrn, n, channels, hw,
                                   size, alpha_over_size, beta, k, s);
  return cudaErrorInvalidValue;
}

// The geometry, registers, shared memory and CTAs per SM of the launch
// above for this shape, on the vector path or not (walk_info). variant:
// with_lrn.
extern "C" int sparknet_epilogue_info(int dtype, int variant, int channels,
                                      long long hw, int size, int aligned,
                                      int* out) {
  if (dtype == 0)
    return epilogue<float>(nullptr, nullptr, nullptr, variant, 1, channels,
                           hw, size, 0.f, 0.f, 0.f, nullptr, aligned, out);
  if (dtype == 1)
    return epilogue<__nv_bfloat16>(nullptr, nullptr, nullptr, variant, 1,
                                   channels, hw, size, 0.f, 0.f, 0.f, nullptr,
                                   aligned, out);
  return cudaErrorInvalidValue;
}
