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
// channel_walk_bwd<T, kBiasRelu> in channel_walk.cuh, gives both
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
// What the design does about it: one thread per (n, h*w) column walks the
// channels, so every warp access is one coalesced line along H*W and each
// element of x and g is read once; the windows of v, t and g*scale^-beta
// live in per-thread shared-memory rings (channel_walk.cuh). Known gaps,
// left for a later change: no vector loads or TMA, and no channel split,
// so small H*W at small batch under-fills the 132 SMs.

#include "channel_walk.cuh"

extern "C" int sparknet_lrn_backward(const void* x, const void* bias,
                                     const void* g, void* dx, int dtype,
                                     int bias_relu, int n, int channels,
                                     long long hw, int size,
                                     float alpha_over_size, float beta,
                                     float k, float coeff, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bias_relu
               ? sparknet::launch_channel_walk_bwd<float, true>(
                     x, bias, g, dx, n, channels, hw, size, alpha_over_size,
                     beta, k, coeff, s)
               : sparknet::launch_channel_walk_bwd<float, false>(
                     x, bias, g, dx, n, channels, hw, size, alpha_over_size,
                     beta, k, coeff, s);
  if (dtype == 1)
    return bias_relu
               ? sparknet::launch_channel_walk_bwd<__nv_bfloat16, true>(
                     x, bias, g, dx, n, channels, hw, size, alpha_over_size,
                     beta, k, coeff, s)
               : sparknet::launch_channel_walk_bwd<__nv_bfloat16, false>(
                     x, bias, g, dx, n, channels, hw, size, alpha_over_size,
                     beta, k, coeff, s);
  return cudaErrorInvalidValue;
}
