// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the TPU kernels sparknet_tpu/ops/pallas_attention.py:_dq_kernel
// and :_dkv_kernel (reached from flash_attention's custom_vjp through
// _flash_backward there), the FlashAttention-2 recurrences with P
// recomputed from the forward's saved LSE:
//   P_ij   = exp(scale * Q_i K_j^T - LSE_i)      (masked: -1e30 -> 0)
//   delta_i = rowsum(dO_i * O_i)                 (O as stored)
//   dS_ij  = P_ij * (dO_i V_j^T - delta_i)
//   dQ_i   = scale * sum_j dS_ij K_j             (flash_dq_kernel)
//   dV_j   = sum_i P_ij^T dO_i                    (flash_dkv_kernel)
//   dK_j   = scale * sum_i dS_ij^T Q_i           (flash_dkv_kernel)
// The product is scaled (not Q), as the TPU backward does. Storage f32 or
// bf16 (read into f32; only dq, dk, dv rounded back), head_dim 16, 32,
// 64 or 128, any sequence length.
//
// Not carried over block by block: the TPU kernels recompute delta at
// every block visit; here the dQ kernel, which reads each query row's dO
// once anyway, computes delta once from O in its storage type and writes
// it to a (B*H, S) f32 buffer that the dK/dV kernel, launched after it on
// the same stream, reads.
//
// Bound on the H100: operations. dQ does 3 and dK/dV 4 products of
// 2 * S^2 * D (halved when causal): at S = 4096, D = 128 causal, 15 GFLOP
// per (b, h) against 8 MB of bf16 q, k, v, o, dO, dq, dk, dv.
//
// What the design does about it, for now: as flash_fwd.cu, a CTA owns one
// 64-row tile and streams the other operand's tiles through shared
// memory; the dQ kernel holds Q and dO and walks K/V (causal: up to the
// diagonal), the dK/dV kernel holds K and V and walks Q/dO (causal: from
// the diagonal). Scores and products run on the CUDA cores in f32. Known
// gap, left for a later change: no tensor cores, no pipelining, one CTA
// per SM at D = 128 (145 and 162 KB of shared memory).

#include "flash_common.cuh"

namespace sparknet_flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, int seq,
                    float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, NJ = D / 16;
  float* qs = smem;                  // kBlockQ x LD
  float* dos = qs + kBlockQ * LD;    // kBlockQ x LD
  float* ks = dos + kBlockQ * LD;    // kBlockK x LD
  float* vs = ks + kBlockK * LD;     // kBlockK x LD
  float* dss = vs + kBlockK * LD;    // kBlockQ x kLP
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  q += base;
  k += base;
  v += base;
  o += base;
  dout += base;
  dq += base;
  lse += static_cast<long long>(blockIdx.y) * seq;
  delta += static_cast<long long>(blockIdx.y) * seq;

  load_tile<T, D>(qs, q, q0, seq, 1.f);
  load_tile<T, D>(dos, dout, q0, seq, 1.f);
  __syncthreads();
  float lse_r[4], delta_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    float part = 0.f;
    if (r < seq) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        part += dos[(ty * 4 + i) * LD + tx + 16 * j] *
                to_f32(o[static_cast<long long>(r) * D + tx + 16 * j]);
    }
    delta_r[i] = row_sum16(part);
    lse_r[i] = r < seq ? lse[r] : 0.f;
    if (tx == 0 && r < seq) delta[r] = delta_r[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int k_end = causal ? min(seq, q0 + kBlockQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D>(ks, k, k0, seq, 1.f);
    load_tile<T, D>(vs, v, k0, seq, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p =
            masked(r, c, seq, causal) ? 0.f : expf(scale * s[i][j] - lse_r[i]);
        dss[(ty * 4 + i) * kLP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_mul<D, false>(acc, dss, ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[static_cast<long long>(r) * D + tx + 16 * j] =
          from_f32<T>(scale * acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, NJ = D / 16;
  float* ks = smem;                  // kBlockK x LD (this CTA's keys)
  float* vs = ks + kBlockK * LD;     // kBlockK x LD
  float* qs = vs + kBlockK * LD;     // kBlockQ x LD
  float* dos = qs + kBlockQ * LD;    // kBlockQ x LD
  float* ps = dos + kBlockQ * LD;    // kBlockQ x kLP
  float* dss = ps + kBlockQ * kLP;   // kBlockQ x kLP
  float* lse_s = dss + kBlockQ * kLP;  // kBlockQ
  float* delta_s = lse_s + kBlockQ;    // kBlockQ
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBlockK;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  lse += static_cast<long long>(blockIdx.y) * seq;
  delta += static_cast<long long>(blockIdx.y) * seq;

  load_tile<T, D>(ks, k, k0, seq, 1.f);
  load_tile<T, D>(vs, v, k0, seq, 1.f);
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  // causal: query tiles wholly above the diagonal are skipped
  const int q_start = causal ? (k0 / kBlockQ) * kBlockQ : 0;
  for (int q0 = q_start; q0 < seq; q0 += kBlockQ) {
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D>(qs, q, q0, seq, 1.f);
    load_tile<T, D>(dos, dout, q0, seq, 1.f);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      const int r = q0 + i;
      lse_s[i] = r < seq ? lse[r] : 0.f;
      delta_s[i] = r < seq ? delta[r] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p =
            masked(r, c, seq, causal) ? 0.f : expf(scale * s[i][j] - lse_s[rl]);
        ps[rl * kLP + tx + 16 * j] = p;
        dss[rl * kLP + tx + 16 * j] = p * (dp[i][j] - delta_s[rl]);
      }
    }
    __syncthreads();
    // rows of the accumulators are this CTA's keys: P^T dO and dS^T Q
    tile_mul<D, true>(dv_acc, ps, dos, ty, tx);
    tile_mul<D, true>(dk_acc, dss, qs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long at = static_cast<long long>(c) * D + tx + 16 * j;
      dk[at] = from_f32<T>(scale * dk_acc[i][j]);
      dv[at] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

struct DqLaunch {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void* dq;
  float* delta;
  int bh, seq;
  float scale;
  int causal;
  cudaStream_t stream;

  template <typename T, int D>
  int run() const {
    const size_t smem =
        sizeof(float) * ((2 * kBlockQ + 2 * kBlockK) * (D + 1) +
                         kBlockQ * kLP);
    return launch_tiles(flash_dq_kernel<T, D>, bh, seq, smem, stream,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<const T*>(o),
                        static_cast<const T*>(dout), lse, static_cast<T*>(dq),
                        delta, seq, scale, causal);
  }
};

struct DkvLaunch {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dk, *dv;
  int bh, seq;
  float scale;
  int causal;
  cudaStream_t stream;

  template <typename T, int D>
  int run() const {
    const size_t smem =
        sizeof(float) * ((2 * kBlockQ + 2 * kBlockK) * (D + 1) +
                         2 * kBlockQ * kLP + 2 * kBlockQ);
    return launch_tiles(flash_dkv_kernel<T, D>, bh, seq, smem, stream,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<const T*>(dout),
                        lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
                        seq, scale, causal);
  }
};

}  // namespace sparknet_flash

// q, k, v, o, dout, dq: (bh, seq, head_dim) contiguous, dtype 0 = f32,
// 1 = bf16; lse (read) and delta (written): (bh, seq) f32.
extern "C" int sparknet_flash_backward_dq(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const void* lse,
                                          void* dq, void* delta, int dtype,
                                          int bh, int seq, int head_dim,
                                          float scale, int causal,
                                          void* stream) {
  const sparknet_flash::DqLaunch launch{
      q, k, v, o, dout, static_cast<const float*>(lse), dq,
      static_cast<float*>(delta), bh, seq, scale, causal,
      static_cast<cudaStream_t>(stream)};
  return sparknet_flash::dispatch(dtype, head_dim, launch);
}

// q, k, v, dout, dk, dv: (bh, seq, head_dim) contiguous; lse and delta
// (the dQ kernel's output): (bh, seq) f32.
extern "C" int sparknet_flash_backward_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int dtype,
                                           int bh, int seq, int head_dim,
                                           float scale, int causal,
                                           void* stream) {
  const sparknet_flash::DkvLaunch launch{
      q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, bh, seq, scale, causal,
      static_cast<cudaStream_t>(stream)};
  return sparknet_flash::dispatch(dtype, head_dim, launch);
}
