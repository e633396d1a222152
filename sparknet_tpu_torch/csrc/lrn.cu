// Cross-channel LRN forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_lrn.py:_fwd_kernel
// (reached from lrn_across / _call_fwd there):
//   scale = k + alpha/size * sum_{window} x^2   (zero-padded channel edges)
//   out   = x * scale^-beta
// for any size (even sizes take the asymmetric window [-half, size-1-half]),
// any k, alpha, beta and C, H, W; storage f32 or bf16, math in f32.
//
// Bound on the H100: device memory. The work is ~2*size+6 f32 operations per
// element against 2 x sizeof(T) bytes moved, far below the card's
// operations-per-byte balance. At GoogLeNet pool1/norm1 (8, 64, 56, 56) f32
// it moves 2 x 8*64*3136*4 B = 12.8 MB, about 3.8 us at 3.35 TB/s; at
// CaffeNet's norm1 (256, 96, 27, 27) 143 MB, 43 us.
//
// What the design does about it (channel_walk.cuh): a CTA owns up to 32
// output channels of one image over up to 128 columns, stages them and
// their size - 1 halo rows into shared memory with cp.async (16-byte
// copies wherever the addresses allow it, all of them in flight before
// any use), then sums each window from shared memory and writes 16 bytes
// a thread where the rows are 16-byte aligned, four strided columns a
// thread where they are not (CaffeNet's 27x27 and 13x13).
// The halo costs 4 extra rows for 32 at size 5 (12.5% more reads, most of
// them L2 hits), and (8, 64, 56, 56) gets 8 x 2 x 25 = 400 CTAs for 132
// SMs.

#include "channel_walk.cuh"

extern "C" int sparknet_lrn_forward(const void* x, void* out, int dtype,
                                    int n, int channels, long long hw,
                                    int size, float alpha_over_size,
                                    float beta, float k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sparknet::channel_walk_entry<float, false, true>(
        x, nullptr, out, n, channels, hw, size, alpha_over_size, beta, k, s);
  if (dtype == 1)
    return sparknet::channel_walk_entry<__nv_bfloat16, false, true>(
        x, nullptr, out, n, channels, hw, size, alpha_over_size, beta, k, s);
  return cudaErrorInvalidValue;
}

// The geometry, registers, shared memory and CTAs per SM of the launch
// above for this shape, on the vector path or not (walk_info). variant: 0.
extern "C" int sparknet_lrn_info(int dtype, int variant, int channels,
                                 long long hw, int size, int aligned,
                                 int* out) {
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return sparknet::channel_walk_entry<float, false, true>(
        nullptr, nullptr, nullptr, 1, channels, hw, size, 0.f, 0.f, 0.f,
        nullptr, aligned, out);
  if (dtype == 1)
    return sparknet::channel_walk_entry<__nv_bfloat16, false, true>(
        nullptr, nullptr, nullptr, 1, channels, hw, size, 0.f, 0.f, 0.f,
        nullptr, aligned, out);
  return cudaErrorInvalidValue;
}
