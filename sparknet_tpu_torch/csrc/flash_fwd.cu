// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_attention.py:_fa_kernel
// (reached from flash_attention / _flash_forward there):
//   O   = softmax(scale * Q K^T [causal mask]) V
//   LSE = m + log(max(l, 1e-30))        per query row, f32
// by the online-softmax recurrence: a running max m, denominator l and
// unnormalised accumulator over 64-key tiles; Q is scaled as it is
// staged (before QK^T, as the TPU kernel does); masked scores are -1e30;
// O = acc / max(l, 1e-30). Storage f32 or bf16 (read into f32, only O
// rounded back), head_dim 16, 32, 64 or 128, any sequence length (the
// last tile is ragged and masked).
//
// Bound on the H100: operations. One (b, h) at S = 4096, D = 128 causal
// does 2 * 2 * S^2 * D / 2 = 4.3 GFLOP on 4 MB of bf16 q, k, v, o: ~1000
// operations per byte, far above the card's balance.
//
// What the design does about it, for now: a CTA owns 64 query rows, keeps
// Q in shared memory for its whole walk over the keys and streams K and V
// through shared memory one 64-row tile at a time, so device memory sees
// each K/V tile once per query tile and the (S, S) scores never leave the
// SM; causal tiles above the diagonal are skipped. Each thread computes a
// 4x4 block of scores and a 4 x D/16 block of O from shared memory on
// the CUDA cores in f32. Known gap, left for a later change: no tensor
// cores (wgmma), no TMA or pipelining of the next K/V tile, at most two
// CTAs per SM at D = 128 (the tiles take 113 KB of shared memory).

#include "flash_common.cuh"

namespace sparknet_flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale,
                     int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, NJ = D / 16;
  float* qs = smem;                  // kBlockQ x LD, scaled
  float* ks = qs + kBlockQ * LD;     // kBlockK x LD
  float* vs = ks + kBlockK * LD;     // kBlockK x LD
  float* ps = vs + kBlockK * LD;     // kBlockQ x kLP
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  q += base;
  k += base;
  v += base;
  o += base;
  lse += static_cast<long long>(blockIdx.y) * seq;

  load_tile<T, D>(qs, q, q0, seq, scale);
  float acc[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  // causal: key tiles wholly above the diagonal are skipped
  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D>(ks, k, k0, seq, 1.f);
    load_tile<T, D>(vs, v, k0, seq, 1.f);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a query row past seq is never stored: only keys are masked
        const int c = k0 + tx + 16 * j;
        if (c >= seq || (causal && c > r)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        ps[(ty * 4 + i) * kLP + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_mul<D, false>(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= seq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[static_cast<long long>(r) * D + tx + 16 * j] =
          from_f32<T>(acc[i][j] / lc);
    if (tx == 0) lse[r] = m[i] + logf(lc);
  }
}

struct ForwardLaunch {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int bh, seq;
  float scale;
  int causal;
  cudaStream_t stream;

  template <typename T, int D>
  int run() const {
    const size_t bytes =
        sizeof(float) * ((kBlockQ + 2 * kBlockK) * (D + 1) + kBlockQ * kLP);
    return launch_tiles(flash_fwd_kernel<T, D>, bh, seq, bytes, stream,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<T*>(o), lse,
                        seq, scale, causal);
  }
};

}  // namespace sparknet_flash

// q, k, v, o: (bh, seq, head_dim) contiguous, dtype 0 = f32, 1 = bf16;
// lse: (bh, seq) f32. Returns the CUDA error code of the launch.
extern "C" int sparknet_flash_forward(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int bh, int seq,
                                      int head_dim, float scale, int causal,
                                      void* stream) {
  const sparknet_flash::ForwardLaunch launch{
      q, k, v, o, static_cast<float*>(lse), bh, seq, scale, causal,
      static_cast<cudaStream_t>(stream)};
  return sparknet_flash::dispatch(dtype, head_dim, launch);
}
