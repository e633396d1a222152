// Shared body of the port's channel-window kernels (lrn.cu, epilogue.cu,
// lrn_bwd.cu) on an NCHW tensor viewed as (N, C, HW).
//
// Work split. A tile is one image n, a chunk of output channels
// [c0, c0 + cc) and a span of columns [p0, p0 + w) of H*W: ceil(C / kChunk)
// chunks of near-equal size, and spans of near-equal width, at most
// kSpanFwd or kSpanBwd columns (a multiple of the vector width on the
// vector path); walk_geometry picks both from the shape. The grid is as
// many CTAs as the card holds at once, each walking the tiles b, b + grid,
// ..., so neighbouring tiles, whose halos overlap, run together and meet
// in L2, and no partial last wave idles the card.
//
// Staging. For each tile a CTA copies every input row that its outputs
// need, its chunk and the halo, into shared memory with cp.async, as one
// commit group, so all of a tile's loads are in flight at once; and it
// issues the next tile's group into another stage (kStagesFwd in all)
// before it waits on the current one and computes; the backward, whose
// tiles are larger, keeps one stage. Rows outside [0, C) are zero-filled.
// On the vector path (the base pointers 16-byte aligned and
// H*W*sizeof(T) a multiple of 16, as at 56x56) the copies, the
// shared-memory reads and the global stores are 16 bytes a thread (4 f32
// or 8 bf16), a thread's V elements contiguous. Elsewhere (H*W = 729, 169
// or 323, or a view at an odd offset) a row's segment starts `lead`
// elements into its tile row, lead being its address mod 16, so that the
// 16-byte units of global memory that lie wholly inside the segment land
// on 16-byte units of the tile and copy as such; the units at its two
// ends copy as 4-byte words, and a bf16 element that shares its word with
// one outside the segment on its own. A thread then takes V = 4 columns
// P apart (q, q + P, q + 2P, q + 3P for P = ceil(w / 4) items a row):
// each access of a warp is to consecutive columns, and each thread has
// four independent chains.
//
// Windows. Output channel c of the forward sums v^2 over input channels
// [c - half, c + size - 1 - half], half = (size - 1) / 2 (asymmetric for
// even size), zero outside [0, C); each sum is taken afresh, in channel
// order, from shared memory. v is x, or y = max(x + b, 0) in the
// epilogue: a halo row outside [0, C) takes the bias -inf, so its y is the
// zero it must be, where relu(0 + b) would not be.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_mma.cuh"  // cp.async helpers

namespace sparknet {

using sparknet_flash::cp_async16;
using sparknet_flash::cp_async4;
using sparknet_flash::cp_async_commit;
using sparknet_flash::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kChunk = 32;      // output channels of a CTA, at most
constexpr int kSpanFwd = 128;   // columns of a forward tile, at most
constexpr int kSpanBwd = 128;   // columns of a backward tile, at most
// Tiles of a CTA in shared memory at once. The backward's tiles are
// larger (two tensors with wider halos, and t); on the H100 its 128
// columns in one stage (three CTAs an SM) beat 64 columns in two stages
// (PERF.md, section 6).
constexpr int kStagesFwd = 2;
constexpr int kStagesBwd = 1;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Elements a row of a T tile is apart: room for a lead of less than 16
// bytes and the span rounded up to 4 columns (the scalar path's reads),
// in whole 16-byte units so every row starts 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int tile_pitch(int span) {
  return round_up(round_up(span, 4) + 16 / static_cast<int>(sizeof(T)),
                  16 / static_cast<int>(sizeof(T)));
}

// ... and of an f32 tile (the backward's t and g * scale^-beta)
__host__ __device__ constexpr int f32_pitch(int span) {
  return round_up(span, 4);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive elements from p (16-byte aligned when V > 1) as f32
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const float* p) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V],
                                         const __nv_bfloat16* p) {
  if constexpr (V == 1) {
    v[0] = __bfloat162float(*p);
  } else {
    static_assert(V == 8, "a 16-byte bf16 vector is 8 elements");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16(v[0]);
  } else {
    static_assert(V == 8, "a 16-byte bf16 vector is 8 elements");
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// A thread's V elements of a row of `per` items, item q: columns
// q * V .. q * V + V - 1 on the vector path, q, q + per, ..., q + (V - 1)
// per on the scalar path. The scalar path reads past the row's w columns
// (the tiles have room; those lanes are never stored) and stores only
// inside them.
template <typename T, bool kVec, int V>
__device__ __forceinline__ void load_row(float (&v)[V], const T* row, int q,
                                         int per) {
  if constexpr (kVec) {
    load_vec<V>(v, row + q * V);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_f32(row[q + j * per]);
  }
}

template <typename T, bool kVec, int V>
__device__ __forceinline__ void store_row(T* row, const float (&v)[V], int q,
                                          int per, int w) {
  if constexpr (kVec) {
    store_vec<V>(row + q * V, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float one[1] = {v[j]};
      if (q + j * per < w) store_vec<1>(row + q + j * per, one);
    }
  }
}

// The same for the backward's f32 rows of t and g * p, which a thread
// writes and reads only for itself: there the vector path's V = 8 (bf16)
// are two float4 `per` items apart, so that a warp's 16-byte accesses
// are consecutive and free of bank conflicts.
template <bool kVec, int V>
__device__ __forceinline__ void load_f32row(float (&v)[V], const float* row,
                                            int q, int per) {
  if constexpr (kVec && V == 8) {
    float lo[4], hi[4];
    load_vec<4>(lo, row + q * 4);
    load_vec<4>(hi, row + (per + q) * 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = lo[j];
      v[4 + j] = hi[j];
    }
  } else {
    load_row<float, kVec, V>(v, row, q, per);
  }
}

template <bool kVec, int V>
__device__ __forceinline__ void store_f32row(float* row, const float (&v)[V],
                                             int q, int per) {
  if constexpr (kVec && V == 8) {
    const float lo[4] = {v[0], v[1], v[2], v[3]};
    const float hi[4] = {v[4], v[5], v[6], v[7]};
    store_vec<4>(row + q * 4, lo);
    store_vec<4>(row + (per + q) * 4, hi);
  } else {
    store_row<float, kVec, V>(row, v, q, per, INT_MAX);
  }
}

// A CTA's threads over a tile of `per_row` (<= kThreads) items a row:
// thread t takes item q = t % per_row of rows r0 = t / per_row, r0 + step,
// ... with step = kThreads / per_row rows at a time (threads past
// step * per_row idle), so the loops need no division.
struct Lanes {
  int q, r0, step;
  __device__ __forceinline__ explicit Lanes(int per_row)
      : q(threadIdx.x % per_row),
        r0(threadIdx.x < kThreads / per_row * per_row
               ? static_cast<int>(threadIdx.x) / per_row
               : INT_MAX),
        step(kThreads / per_row) {}
};

// scale^-beta as exp2(-beta * log2(scale)) on the hardware's log2 and
// exp2 (MUFU): a few instructions and ~3e-7 relative error where the
// accurate powf takes ~1 ulp and tens of instructions, which bounded the
// kernels. Every limit of the tests and chip_smoke.py holds with it.
__device__ __forceinline__ float pow_neg(float scale, float beta) {
  return exp2f(-beta * __log2f(scale));
}

// Issue the copies of channels [first, first + rows) of `plane` (one
// image, C x hw), columns [p0, p0 + w), into `tile`: row r at
// tile + r * pitch, plus lead[r] elements on the scalar path (lead is
// written there, and unused on the vector path). Rows outside [0, C)
// become zeros. The whole CTA issues; nobody waits here.
template <typename T, bool kVec>
__device__ __forceinline__ void stage(T* tile, int* lead, int pitch,
                                      const T* plane, int first, int rows,
                                      int channels, long long hw,
                                      long long p0, int w) {
  constexpr int U = 16 / sizeof(T);  // elements of a 16-byte unit
  if constexpr (kVec) {
    const Lanes l(w / U);
    for (int r = l.r0; r < rows; r += l.step) {
      const int ch = first + r, q = l.q;
      const bool in = ch >= 0 && ch < channels;
      cp_async16(tile + r * pitch + q * U,
                 in ? plane + ch * hw + p0 + q * U : plane, in ? 16 : 0);
    }
  } else {
    constexpr int E = 4 / sizeof(T);          // elements of a 4-byte word
    const Lanes l((w + 2 * U - 2) / U);       // units that hold w of them
    for (int r = l.r0; r < rows; r += l.step) {
      const int ch = first + r, q = l.q;
      T* dst = tile + r * pitch + q * U;
      if (ch < 0 || ch >= channels) {
        if (q == 0) lead[r] = 0;
        cp_async16(dst, plane, 0);
        continue;
      }
      const T* seg = plane + ch * hw + p0;
      // elements of seg's first 16-byte unit that lie before seg
      const int ld = static_cast<int>(
          (reinterpret_cast<uintptr_t>(seg) & 15) / sizeof(T));
      if (q == 0) lead[r] = ld;
      const int e0 = q * U - ld;  // this unit holds seg[e0 .. e0 + U)
      if (e0 >= 0 && e0 + U <= w) {
        cp_async16(dst, seg + e0, 16);
        continue;
      }
#pragma unroll
      for (int k = 0; k < U; k += E) {  // an end unit: its 4-byte words
        const int a = e0 + k;
        if (a >= 0 && a + E <= w)
          cp_async4(dst + k, seg + a, 4);
        else
          for (int e = max(a, 0); e < min(a + E, w); ++e) dst[e - e0] = seg[e];
      }
    }
  }
}

// Tile row r, from its first column
template <typename T, bool kVec>
__device__ __forceinline__ T* tile_row(T* tile, const int* lead, int pitch,
                                       int r) {
  T* p = tile + r * pitch;
  if constexpr (!kVec) p += lead[r];
  return p;
}

// v of tile row r: x, or max(x + b, 0) with b = bias_of[r]
template <typename T, bool kVec, bool kBiasRelu, int V>
__device__ __forceinline__ void fetch_v(float (&v)[V], const T* tile,
                                        const int* lead, int pitch,
                                        const float* bias_of, int r, int q,
                                        int per) {
  load_row<T, kVec, V>(v, tile_row<const T, kVec>(tile, lead, pitch, r), q,
                       per);
  if constexpr (kBiasRelu) {
    const float b = bias_of[r];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = fmaxf(v[j] + b, 0.f);
  }
}

// The bias of each staged row of v, -inf outside [0, C) (see the top)
template <typename T>
__device__ __forceinline__ void stage_bias(float* bias_of, const T* bias,
                                           int first, int rows,
                                           int channels) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int ch = first + r;
    bias_of[r] = ch >= 0 && ch < channels ? to_f32(bias[ch]) : -INFINITY;
  }
}

// The launch as the kernels see it: N images of C channels of hw columns,
// cut into n * chunks * spans tiles of `chunk` output channels and `span`
// columns. Tile t is image t / (chunks * spans), chunk t / spans % chunks,
// span t % spans: neighbouring tiles share their halos.
struct WalkShape {
  int n, channels;
  long long hw;
  int chunk, chunks, span, spans;
};

struct TileRef {
  long long plane, p0;  // element offset of the image; first column
  int c0, cc, w;        // first output channel; channels; columns
};

__device__ __forceinline__ TileRef tile_ref(const WalkShape& s, int t) {
  TileRef r;
  const int rest = t / s.spans;
  r.c0 = rest % s.chunks * s.chunk;
  r.cc = min(s.chunk, s.channels - r.c0);
  r.p0 = static_cast<long long>(t % s.spans) * s.span;
  r.w = static_cast<int>(min(static_cast<long long>(s.span), s.hw - r.p0));
  r.plane = static_cast<long long>(rest / s.chunks) * s.channels * s.hw;
  return r;
}

// Bytes of one stage of the forward's shared memory: the tile of `cap`
// rows, then bias_of and lead, a float and an int a row.
template <typename T>
__host__ __device__ constexpr int fwd_stage_bytes(int cap, int span) {
  return round_up(cap * (tile_pitch<T>(span) * static_cast<int>(sizeof(T)) +
                         8),
                  16);
}

// ... and of the backward's: the v and g tiles, bias_of, and the two leads
template <typename T>
__host__ __device__ constexpr int bwd_stage_bytes(int xcap, int gcap,
                                                  int span) {
  return round_up((xcap + gcap) * tile_pitch<T>(span) *
                          static_cast<int>(sizeof(T)) +
                      xcap * 8 + gcap * 4,
                  16);
}

// The CTAs are persistent: CTA b takes tiles b, b + grid, b + 2 grid, ...
// through kStagesFwd stages of shared memory, issuing the copies of the
// tile kStagesFwd - 1 ahead before it computes the current one (cp.async
// groups: commit one a tile, wait for all but the last kStagesFwd - 1), so
// its loads stay in flight while it computes and stores.
//
// kLRN: out = v * (k + alpha_over_size * sum_{window} v^2)^-beta, with v
// x (plain LRN) or max(x + b, 0) (epilogue). Without kLRN: out = v.
// All math in f32 whatever T is.
template <typename T, bool kBiasRelu, bool kLRN, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    channel_walk(const T* __restrict__ x, const T* __restrict__ bias,
                 T* __restrict__ out, WalkShape sh, int size,
                 float alpha_over_size, float beta, float k) {
  constexpr int V = kVec ? 16 / sizeof(T) : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int win = kLRN ? size : 1;
  const int half = kLRN ? (size - 1) / 2 : 0;
  const int cap = sh.chunk + win - 1;
  const int pitch = tile_pitch<T>(sh.span);
  const int stage_bytes = fwd_stage_bytes<T>(cap, sh.span);
  const int tiles = sh.n * sh.chunks * sh.spans;
  // stage b: the tile (row r is channel c0 - half + r), bias_of, lead
  auto tile_of = [&](int b) {
    return reinterpret_cast<T*>(smem + b * stage_bytes);
  };
  auto bias_of = [&](int b) {
    return reinterpret_cast<float*>(tile_of(b) + cap * pitch);
  };
  auto lead_of = [&](int b) { return reinterpret_cast<int*>(bias_of(b) + cap); };
  auto issue = [&](int t, int b) {
    const TileRef a = tile_ref(sh, t);
    stage<T, kVec>(tile_of(b), lead_of(b), pitch, x + a.plane, a.c0 - half,
                   a.cc + win - 1, sh.channels, sh.hw, a.p0, a.w);
    if constexpr (kBiasRelu)
      stage_bias(bias_of(b), bias, a.c0 - half, a.cc + win - 1, sh.channels);
  };

  int t = blockIdx.x;  // the grid is at most `tiles` CTAs
  for (int i = 0; i < kStagesFwd - 1; ++i) {
    if (t + i * gridDim.x < tiles) issue(t + i * gridDim.x, i);
    cp_async_commit();
  }
  for (int i = 0; t < tiles; ++i, t += gridDim.x) {
    const int b = i % kStagesFwd;
    const int ahead = t + (kStagesFwd - 1) * gridDim.x;
    if (ahead < tiles) issue(ahead, (i + kStagesFwd - 1) % kStagesFwd);
    cp_async_commit();
    cp_async_wait<kStagesFwd - 1>();  // tile t has landed; later ones may not
    __syncthreads();

    const TileRef a = tile_ref(sh, t);
    const T* tile = tile_of(b);
    T* dst = out + a.plane + static_cast<long long>(a.c0) * sh.hw + a.p0;
    const int per = (a.w + V - 1) / V;  // items a row
    const Lanes l(per);
    for (int r = l.r0; r < a.cc; r += l.step) {
      float sum[V] = {}, mid[V];
      for (int s = 0; s < win; ++s) {  // tile rows r .. r + win - 1
        float u[V];
        fetch_v<T, kVec, kBiasRelu, V>(u, tile, lead_of(b), pitch,
                                       bias_of(b), r + s, l.q, per);
#pragma unroll
        for (int j = 0; j < V; ++j) sum[j] = fmaf(u[j], u[j], sum[j]);
      }
      fetch_v<T, kVec, kBiasRelu, V>(mid, tile, lead_of(b), pitch,
                                     bias_of(b), r + half, l.q, per);
      if constexpr (kLRN) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          mid[j] *= pow_neg(k + alpha_over_size * sum[j], beta);
      }
      store_row<T, kVec, V>(dst + r * sh.hw, mid, l.q, per, a.w);
    }
    __syncthreads();  // stage b is free for a later tile
  }
}

// The backward of the cross-channel LRN:
//   scale(j) = k + alpha/size * sum_{window(j)} v^2
//   p(j)     = scale(j)^-beta
//   t(j)     = g(j) * v(j) * p(j) / scale(j)        (= g v scale^(-beta-1))
//   dv(c)    = g(c) * p(c) - coeff * v(c) * sum_{j = c-lo}^{c+half} t(j)
// with coeff = 2*alpha*beta/size and lo = size - 1 - half: the second sum
// runs over the forward window mirrored. v is x (plain LRN) or, with
// kBiasRelu, y = max(x + b, 0) rounded to T, as the reference forms y in
// the storage type; then dx = y > 0 ? dv : 0.
//
// A tile with outputs [c0, c0 + cc) stages v over [c0 - (size-1),
// c0 + cc + size - 1) and g over [c0 - lo, c0 + cc + half), kStagesBwd of
// them as in the forward, then makes two passes over shared memory: the
// first forms scale, p and t for every g row (one pow_neg an element) and
// g * p for its own channels, the second dv. t of a row outside [0, C) is
// 0.
template <typename T, bool kBiasRelu, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    channel_walk_bwd(const T* __restrict__ x, const T* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dx,
                     WalkShape sh, int size, float alpha_over_size,
                     float beta, float k, float coeff) {
  constexpr int V = kVec ? 16 / sizeof(T) : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = (size - 1) / 2, lo = size - 1 - half;
  const int xcap = sh.chunk + 2 * (size - 1), gcap = sh.chunk + size - 1;
  const int pitch = tile_pitch<T>(sh.span), fpitch = f32_pitch(sh.span);
  const int stage_bytes = bwd_stage_bytes<T>(xcap, gcap, sh.span);
  const int tiles = sh.n * sh.chunks * sh.spans;
  // stage b: the v tile (row r is channel c0 - (size - 1) + r), the g tile
  // (row j is channel c0 - lo + j), bias_of, the leads; then, once, t and
  // g * p
  auto xt_of = [&](int b) {
    return reinterpret_cast<T*>(smem + b * stage_bytes);
  };
  auto gt_of = [&](int b) { return xt_of(b) + xcap * pitch; };
  auto bias_of = [&](int b) {
    return reinterpret_cast<float*>(gt_of(b) + gcap * pitch);
  };
  auto xlead_of = [&](int b) {
    return reinterpret_cast<int*>(bias_of(b) + xcap);
  };
  auto glead_of = [&](int b) { return xlead_of(b) + xcap; };
  float* tt = reinterpret_cast<float*>(smem + kStagesBwd * stage_bytes);
  float* at = tt + gcap * fpitch;
  auto issue = [&](int t, int b) {
    const TileRef a = tile_ref(sh, t);
    stage<T, kVec>(xt_of(b), xlead_of(b), pitch, x + a.plane,
                   a.c0 - (size - 1), a.cc + 2 * (size - 1), sh.channels,
                   sh.hw, a.p0, a.w);
    stage<T, kVec>(gt_of(b), glead_of(b), pitch, g + a.plane, a.c0 - lo,
                   a.cc + size - 1, sh.channels, sh.hw, a.p0, a.w);
    if constexpr (kBiasRelu)
      stage_bias(bias_of(b), bias, a.c0 - (size - 1), a.cc + 2 * (size - 1),
                 sh.channels);
  };

  int t = blockIdx.x;  // the grid is at most `tiles` CTAs
  for (int i = 0; i < kStagesBwd - 1; ++i) {
    if (t + i * gridDim.x < tiles) issue(t + i * gridDim.x, i);
    cp_async_commit();
  }
  for (int i = 0; t < tiles; ++i, t += gridDim.x) {
    const int b = i % kStagesBwd;
    const int ahead = t + (kStagesBwd - 1) * gridDim.x;
    if (ahead < tiles) issue(ahead, (i + kStagesBwd - 1) % kStagesBwd);
    cp_async_commit();
    cp_async_wait<kStagesBwd - 1>();  // tile t has landed; later ones may not
    __syncthreads();

    const TileRef a = tile_ref(sh, t);
    T* xt = xt_of(b);
    const int grows = a.cc + size - 1;
    const int per = (a.w + V - 1) / V;  // items a row
    const Lanes l(per);
    const int q = l.q;
    if constexpr (kBiasRelu) {
      // the fused form: y = max(x + b, 0) rounded to T replaces x in the
      // tile, exactly (the reference forms y in T), once for all reads
      for (int r = l.r0; r < a.cc + 2 * (size - 1); r += l.step) {
        float v[V];
        fetch_v<T, kVec, true, V>(v, xt, xlead_of(b), pitch, bias_of(b), r,
                                  q, per);
        store_row<T, kVec, V>(tile_row<T, kVec>(xt, xlead_of(b), pitch, r), v,
                              q, per, a.w);
      }
      __syncthreads();
    }
    auto v_at = [&](float(&v)[V], int r) {
      load_row<T, kVec, V>(v, tile_row<T, kVec>(xt, xlead_of(b), pitch, r), q,
                           per);
    };

    // pass 1: g row j's window is v rows j .. j + size - 1, its v is v row
    // j + half
    for (int j = l.r0; j < grows; j += l.step) {
      float sum[V] = {}, vj[V], gj[V];
      for (int s = 0; s < size; ++s) {
        float u[V];
        v_at(u, j + s);
#pragma unroll
        for (int e = 0; e < V; ++e) sum[e] = fmaf(u[e], u[e], sum[e]);
      }
      v_at(vj, j + half);
      load_row<T, kVec, V>(
          gj, tile_row<T, kVec>(gt_of(b), glead_of(b), pitch, j), q, per);
      const int cj = a.c0 - lo + j;
      const bool in = cj >= 0 && cj < sh.channels;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float scale = k + alpha_over_size * sum[e];
        const float p = pow_neg(scale, beta);
        vj[e] = in ? gj[e] * vj[e] * __fdividef(p, scale) : 0.f;  // t(j)
        gj[e] *= p;                                       // g(j) * p(j)
      }
      // t and g * p of every lane, those past w too: a lane's columns are
      // its own in both passes
      store_f32row<kVec, V>(tt + j * fpitch, vj, q, per);
      if (j >= lo && j < lo + a.cc)
        store_f32row<kVec, V>(at + (j - lo) * fpitch, gj, q, per);
    }
    __syncthreads();

    // pass 2: output channel c0 + r sums t rows r .. r + size - 1; its v
    // is v row r + size - 1
    T* dst = dx + a.plane + static_cast<long long>(a.c0) * sh.hw + a.p0;
    for (int r = l.r0; r < a.cc; r += l.step) {
      float acc[V] = {}, u[V];
      for (int s = 0; s < size; ++s) {
        load_f32row<kVec, V>(u, tt + (r + s) * fpitch, q, per);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += u[e];
      }
      float vc[V];
      v_at(vc, r + size - 1);
      load_f32row<kVec, V>(u, at + r * fpitch, q, per);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = u[e] - coeff * vc[e] * acc[e];
        u[e] = kBiasRelu && !(vc[e] > 0.f) ? 0.f : d;
      }
      store_row<T, kVec, V>(dst + r * sh.hw, u, q, per, a.w);
    }
    __syncthreads();  // stage b, t and g * p are free for the next tile
  }
}

// What a launch looks like: its shape and tiles, the vector path or not,
// and the dynamic shared memory of one CTA.
struct WalkGeometry {
  WalkShape shape;
  long long tiles;
  bool vec;
  size_t smem;
};

// Dynamic shared memory of a CTA: its stages, and the backward's t and
// g * p once
template <typename T>
inline size_t walk_smem(bool backward, int chunk, int span, int window) {
  if (!backward)
    return kStagesFwd * static_cast<size_t>(
                            fwd_stage_bytes<T>(chunk + window - 1, span));
  const int xcap = chunk + 2 * (window - 1), gcap = chunk + window - 1;
  return kStagesBwd *
             static_cast<size_t>(bwd_stage_bytes<T>(xcap, gcap, span)) +
         static_cast<size_t>(gcap + chunk) * f32_pitch(span) * sizeof(float);
}

// Balanced chunks of at most kChunk channels and spans of at most
// kSpanFwd / kSpanBwd columns, a multiple of the vector width on the
// vector path; the span halves while a CTA's tiles would not fit in
// shared memory (wide windows). `window` is the LRN size (1 for bias+ReLU
// alone).
template <typename T>
inline WalkGeometry walk_geometry(bool backward, bool vec, int n,
                                  int channels, long long hw, int window) {
  WalkGeometry g;
  WalkShape& s = g.shape;
  s.n = n;
  s.channels = channels;
  s.hw = hw;
  s.chunks = (channels + kChunk - 1) / kChunk;
  s.chunk = (channels + s.chunks - 1) / s.chunks;
  const int vec_width = vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  int max_span = backward ? kSpanBwd : kSpanFwd;
  while (max_span > vec_width &&
         walk_smem<T>(backward, s.chunk, max_span, window) > kMaxSmem)
    max_span /= 2;
  const long long n_spans = (hw + max_span - 1) / max_span;
  s.span = round_up(static_cast<int>((hw + n_spans - 1) / n_spans), vec_width);
  const long long spans = (hw + s.span - 1) / s.span;
  s.spans = static_cast<int>(spans > INT_MAX ? INT_MAX : spans);
  g.tiles = static_cast<long long>(n) * s.chunks * spans;
  g.vec = vec;
  g.smem = walk_smem<T>(backward, s.chunk, s.span, window);
  return g;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Opt in to the shared memory; refuse what the kernels cannot index
// (tile numbers up to tile + (stages - 1) grid stay below 2^31).
template <typename Kernel>
cudaError_t prepare(Kernel fn, const WalkGeometry& g) {
  constexpr int stages = kStagesFwd > kStagesBwd ? kStagesFwd : kStagesBwd;
  if (g.smem > kMaxSmem || g.tiles * stages >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (g.smem > 48 * 1024)
    return cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(g.smem));
  return cudaSuccess;
}

// Launch a grid of as many CTAs as fit on the card at once, at most one a
// tile, on `stream`; returns the first error (a refused launch: too much
// shared memory, a bad grid) so that it reaches the caller.
template <typename... Params, typename... Args>
cudaError_t launch_walk(void (*fn)(Params...), const WalkGeometry& g,
                        cudaStream_t stream, Args... args) {
  cudaError_t e = prepare(fn, g);
  int dev = 0, sms = 0, ctas = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads,
                                                      g.smem);
  if (e != cudaSuccess) return e;
  const long long grid =
      g.tiles < static_cast<long long>(sms) * ctas
          ? g.tiles
          : static_cast<long long>(sms) * (ctas > 0 ? ctas : 1);
  fn<<<static_cast<unsigned>(grid), kThreads, g.smem, stream>>>(args...);
  return cudaGetLastError();
}

// out[0..8] = chunk, chunks, span, spans, vector path, dynamic shared
// memory, registers, resident CTAs per SM and local memory (spills) of
// `fn` on geometry `g`: for the card tests and chip_smoke.py.
template <typename Kernel>
int walk_info(Kernel fn, const WalkGeometry& g, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) e = prepare(fn, g);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads,
                                                      g.smem);
  if (e != cudaSuccess) return e;
  const WalkShape& s = g.shape;
  const int vals[] = {s.chunk,
                      s.chunks,
                      s.span,
                      s.spans,
                      g.vec,
                      static_cast<int>(g.smem),
                      attr.numRegs,
                      ctas,
                      static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return cudaSuccess;
}

// The forward on `stream`: the vector path where x, out and every row are
// 16-byte aligned. `aligned` < 0 reads the pointers' alignment; 0 or 1
// states it for walk_info, which then fills `info` and launches nothing.
template <typename T, bool kBiasRelu, bool kLRN>
int channel_walk_entry(const void* x, const void* bias, void* out, int n,
                       int channels, long long hw, int size,
                       float alpha_over_size, float beta, float k,
                       cudaStream_t stream, int aligned = -1,
                       int* info = nullptr) {
  const bool vec = hw * sizeof(T) % 16 == 0 &&
                   (aligned >= 0 ? aligned != 0
                                 : aligned16(x) && aligned16(out));
  const WalkGeometry g =
      walk_geometry<T>(false, vec, n, channels, hw, kLRN ? size : 1);
  if (info)
    return vec ? walk_info(channel_walk<T, kBiasRelu, kLRN, true>, g, info)
               : walk_info(channel_walk<T, kBiasRelu, kLRN, false>, g, info);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  return vec ? launch_walk(channel_walk<T, kBiasRelu, kLRN, true>, g, stream,
                           xt, bt, ot, g.shape, size, alpha_over_size, beta,
                           k)
             : launch_walk(channel_walk<T, kBiasRelu, kLRN, false>, g,
                           stream, xt, bt, ot, g.shape, size,
                           alpha_over_size, beta, k);
}

// The backward on `stream`, likewise; the vector path needs x, g and dx
// aligned.
template <typename T, bool kBiasRelu>
int channel_walk_bwd_entry(const void* x, const void* bias, const void* g,
                           void* dx, int n, int channels, long long hw,
                           int size, float alpha_over_size, float beta,
                           float k, float coeff, cudaStream_t stream,
                           int aligned = -1, int* info = nullptr) {
  const bool vec = hw * sizeof(T) % 16 == 0 &&
                   (aligned >= 0 ? aligned != 0
                                 : aligned16(x) && aligned16(g) &&
                                       aligned16(dx));
  const WalkGeometry geo =
      walk_geometry<T>(true, vec, n, channels, hw, size);
  if (info)
    return vec ? walk_info(channel_walk_bwd<T, kBiasRelu, true>, geo, info)
               : walk_info(channel_walk_bwd<T, kBiasRelu, false>, geo, info);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  return vec ? launch_walk(channel_walk_bwd<T, kBiasRelu, true>, geo, stream,
                           xt, bt, gt, dt, geo.shape, size, alpha_over_size,
                           beta, k, coeff)
             : launch_walk(channel_walk_bwd<T, kBiasRelu, false>, geo,
                           stream, xt, bt, gt, dt, geo.shape, size,
                           alpha_over_size, beta, k, coeff);
}

}  // namespace sparknet
