// Cross-channel LRN backward for Hopper (sm_90a), plain and fused into the
// bias+ReLU conv epilogue.
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_lrn.py:_bwd_kernel
// (reached from _call_bwd there, which lrn_across's _lrn_bwd calls, and
// which pallas_epilogue.py's _brl_bwd calls on y = relu(x + b)):
//   scale = k + alpha/size * sum_{window} v^2         (v = x, or y)
//   dv    = g * scale^-beta
//         - (2*alpha*beta/size) * v * sum_{mirrored window} g*v*scale^(-beta-1)
// recomputing scale from v instead of reading a saved one. One template,
// channel_walk_bwd<T, kBiasRelu, kVec> in channel_walk.cuh, gives both
// instantiations:
//   (a) kBiasRelu false: v = x; writes dx = dv             (_call_bwd)
//   (b) kBiasRelu true:  v = y = max(x + b, 0), rounded to the storage type
//       as _brl_bwd forms it; writes dx = y > 0 ? dv : 0, without ever
//       storing y                                          (_brl_bwd)
// dbias = sum(dx) over (N, H, W) stays a PyTorch reduction, as it is an XLA
// reduce outside the kernel in the JAX package.
//
// Bound on the H100: device memory. About 4*size + 12 f32 operations per
// element against 3 x sizeof(T) bytes (x and g read, dx written). At
// GoogLeNet's pool1/norm1 at batch 32, (32, 64, 56, 56) f32, that is
// 77.1 MB, 0.023 ms at 3.35 TB/s; conv2/norm2's fused site,
// (32, 192, 56, 56), moves 231.2 MB, 0.069 ms (the bias is C values).
//
// What the design does about it (channel_walk.cuh): a CTA owns up to 32
// output channels of one image over up to 128 columns. It stages v with a
// halo of size - 1 rows on each side and g with the mirrored window's,
// all in flight at once through cp.async (16-byte copies wherever the
// addresses allow it), then makes two passes over shared memory: scale,
// one power (p = scale^-beta as exp2(-beta log2 scale) on the special
// function unit, scale^(-beta-1) = p / scale) and t for every g row, then
// dx for its own channels, stored 16 bytes a thread on the vector path.
// At size 5 the halo is 8 + 4 extra rows for 32 (19% more reads, most of
// them L2 hits). The tiles (74 KB at f32, size 5) allow three CTAs an
// SM and one tile each in flight; the persistent grid keeps them busy.
// No atomics: two launches give the same bits.

#include "channel_walk.cuh"

namespace {

template <typename T>
int lrn_backward(const void* x, const void* bias, const void* g, void* dx,
                 int bias_relu, int n, int channels, long long hw, int size,
                 float alpha_over_size, float beta, float k, float coeff,
                 cudaStream_t s, int aligned = -1, int* info = nullptr) {
  return bias_relu
             ? sparknet::channel_walk_bwd_entry<T, true>(
                   x, bias, g, dx, n, channels, hw, size, alpha_over_size,
                   beta, k, coeff, s, aligned, info)
             : sparknet::channel_walk_bwd_entry<T, false>(
                   x, bias, g, dx, n, channels, hw, size, alpha_over_size,
                   beta, k, coeff, s, aligned, info);
}

}  // namespace

extern "C" int sparknet_lrn_backward(const void* x, const void* bias,
                                     const void* g, void* dx, int dtype,
                                     int bias_relu, int n, int channels,
                                     long long hw, int size,
                                     float alpha_over_size, float beta,
                                     float k, float coeff, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lrn_backward<float>(x, bias, g, dx, bias_relu, n, channels, hw,
                               size, alpha_over_size, beta, k, coeff, s);
  if (dtype == 1)
    return lrn_backward<__nv_bfloat16>(x, bias, g, dx, bias_relu, n,
                                       channels, hw, size, alpha_over_size,
                                       beta, k, coeff, s);
  return cudaErrorInvalidValue;
}

// The geometry, registers, shared memory and CTAs per SM of the launch
// above for this shape, on the vector path or not (walk_info). variant:
// bias_relu.
extern "C" int sparknet_lrn_bwd_info(int dtype, int variant, int channels,
                                     long long hw, int size, int aligned,
                                     int* out) {
  if (dtype == 0)
    return lrn_backward<float>(nullptr, nullptr, nullptr, nullptr, variant, 1,
                               channels, hw, size, 0.f, 0.f, 0.f, 0.f,
                               nullptr, aligned, out);
  if (dtype == 1)
    return lrn_backward<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                       variant, 1, channels, hw, size, 0.f,
                                       0.f, 0.f, 0.f, nullptr, aligned, out);
  return cudaErrorInvalidValue;
}
