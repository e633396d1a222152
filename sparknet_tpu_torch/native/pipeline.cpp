// Native host-side data pipeline kernels (the port's copy of
// sparknet_tpu/native/pipeline.cpp, ABI 3).
//
// The native analog of the reference's native data path: Caffe ran
// decode/crop/mirror/mean in C++ worker threads (data_transformer.cpp:42-51,
// base_data_layer.cpp prefetch InternalThreadEntry :70-101) because the
// JVM/Python side could never keep the accelerator fed. Same economics here:
// these loops release the GIL (plain C called via ctypes) so the Python
// prefetch threads in sparknet_tpu_torch.data.prefetch overlap transform
// with the card's step.
//
// Build: sparknet_tpu_torch/native/__init__.py compiles this with g++ -O3
// on first use into sparknet_tpu_torch/_build/; numpy fallbacks exist for
// every entry point.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// (n,c,h,w) uint8 -> (n,c,crop,crop) float32: per-image crop offsets
// (ys/xs), optional horizontal mirror, mean subtraction, scale.
// mean: nullptr | per-channel (mean_kind=1, c floats) | CHW image at
// the CROPPED size (mean_kind=2, c*crop*crop floats, subtracted after the
// mirror) | CHW image at the SOURCE size (mean_kind=3, c*h*w floats,
// subtracted at the source crop-window index before the mirror — the exact
// mean_file semantics of the reference data_transformer.cpp:42-51, where
// top[mirrored_index] = (src[data_index] - mean[data_index]) * scale).
void transform_batch(const uint8_t* in, int64_t n, int64_t c, int64_t h,
                     int64_t w, int64_t crop, const int32_t* ys,
                     const int32_t* xs, const uint8_t* mirror,
                     const float* mean, int mean_kind, float scale,
                     float* out) {
  const int64_t in_img = c * h * w;
  const int64_t out_img = c * crop * crop;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = in + i * in_img;
    float* dst = out + i * out_img;
    const int64_t y0 = ys ? ys[i] : 0;
    const int64_t x0 = xs ? xs[i] : 0;
    const bool flip = mirror && mirror[i];
    for (int64_t ch = 0; ch < c; ++ch) {
      const uint8_t* splane = src + ch * h * w;
      float* dplane = dst + ch * crop * crop;
      const float* mplane =
          mean_kind == 2 ? mean + ch * crop * crop : nullptr;
      const float* fplane =
          mean_kind == 3 ? mean + ch * h * w : nullptr;
      const float mchan = mean_kind == 1 ? mean[ch] : 0.0f;
      for (int64_t y = 0; y < crop; ++y) {
        const uint8_t* __restrict srow = splane + (y0 + y) * w + x0;
        float* __restrict drow = dplane + y * crop;
        // branch-free inner loops so gcc vectorizes the u8->f32 convert
        if (fplane) {  // full-size mean, source-indexed (pre-mirror)
          const float* __restrict mrow = fplane + (y0 + y) * w + x0;
          if (!flip) {
            for (int64_t x = 0; x < crop; ++x)
              drow[x] = ((float)srow[x] - mrow[x]) * scale;
          } else {
            for (int64_t x = 0; x < crop; ++x)
              drow[x] = ((float)srow[crop - 1 - x] - mrow[crop - 1 - x])
                        * scale;
          }
        } else if (!flip && mplane) {
          const float* __restrict mrow = mplane + y * crop;
          for (int64_t x = 0; x < crop; ++x)
            drow[x] = ((float)srow[x] - mrow[x]) * scale;
        } else if (!flip) {
          for (int64_t x = 0; x < crop; ++x)
            drow[x] = ((float)srow[x] - mchan) * scale;
        } else if (mplane) {
          const float* __restrict mrow = mplane + y * crop;
          for (int64_t x = 0; x < crop; ++x)
            drow[x] = ((float)srow[crop - 1 - x] - mrow[x]) * scale;
        } else {
          for (int64_t x = 0; x < crop; ++x)
            drow[x] = ((float)srow[crop - 1 - x] - mchan) * scale;
        }
      }
    }
  }
}

// CIFAR binary records (1 label byte + c*h*w image bytes each) ->
// planar images + labels (the CifarLoader.scala:66-86 inner loop).
void decode_cifar_records(const uint8_t* raw, int64_t n, int64_t record,
                          uint8_t* images, int32_t* labels) {
  const int64_t img = record - 1;
  for (int64_t i = 0; i < n; ++i) {
    labels[i] = raw[i * record];
    std::memcpy(images + i * img, raw + i * record + 1, img);
  }
}

// uint8 (n,c,h,w) accumulate-sum into int64 (c,h,w) — the hot loop of
// streaming mean-image computation (ComputeMean.scala:10-37).
void accumulate_sum(const uint8_t* in, int64_t n, int64_t chw,
                    int64_t* acc) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* img = in + i * chw;
    for (int64_t j = 0; j < chw; ++j) acc[j] += img[j];
  }
}

// crc32c (Castagnoli), same (data, crc) semantics as the Python
// reference in data/leveldb.py: init/final xor inside, so chained calls
// pass the previous RESULT as crc. These entry points run GIL-released
// from multiple prefetch threads, so the table uses a C++11 magic
// static (guaranteed race-free one-time init).
struct Crc32cTable {
    uint32_t tab[256];
    Crc32cTable() {
        for (uint32_t n = 0; n < 256; n++) {
            uint32_t c = n;
            for (int k = 0; k < 8; k++)
                c = (c >> 1) ^ ((c & 1) ? 0x82f63b78u : 0u);
            tab[n] = c;
        }
    }
};

static const uint32_t* crc32c_table() {
    static const Crc32cTable t;
    return t.tab;
}

uint32_t crc32c_update(const uint8_t* data, int64_t len, uint32_t crc) {
    const uint32_t* tab = crc32c_table();
    uint32_t c = crc ^ 0xffffffffu;
    for (int64_t i = 0; i < len; i++)
        c = tab[(c ^ data[i]) & 0xff] ^ (c >> 8);
    return c ^ 0xffffffffu;
}

// Snappy raw-format decode (the LevelDB block codec): varint32 length
// preamble then literal/copy elements. Returns the decoded length, or
// -1 on malformed/overrunning input (callers fall back to the Python
// decoder, which raises a descriptive error). `out` must hold the
// preamble-declared length; overlapping copies run byte-wise (RLE).
int64_t snappy_uncompress(const uint8_t* in, int64_t in_len,
                          uint8_t* out, int64_t out_cap) {
    int64_t p = 0, o = 0;
    // varint32 preamble
    uint32_t declared = 0;
    int shift = 0;
    while (true) {
        if (p >= in_len || shift > 28) return -1;
        uint8_t b = in[p++];
        declared |= (uint32_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if ((int64_t)declared != out_cap) return -1;
    while (p < in_len) {
        uint8_t tag = in[p++];
        int kind = tag & 3;
        if (kind == 0) {                       // literal
            int64_t ln = tag >> 2;
            if (ln >= 60) {                    // length in 1-4 bytes
                int nb = (int)(ln - 59);
                if (p + nb > in_len) return -1;
                ln = 0;
                for (int i = 0; i < nb; i++)
                    ln |= (int64_t)in[p + i] << (8 * i);
                p += nb;
            }
            ln += 1;
            if (p + ln > in_len || o + ln > out_cap) return -1;
            std::memcpy(out + o, in + p, (size_t)ln);
            p += ln;
            o += ln;
            continue;
        }
        int64_t ln, off;
        if (kind == 1) {                       // copy, 1-byte offset
            if (p >= in_len) return -1;
            ln = ((tag >> 2) & 0x7) + 4;
            off = ((int64_t)(tag >> 5) << 8) | in[p];
            p += 1;
        } else if (kind == 2) {                // copy, 2-byte offset
            if (p + 2 > in_len) return -1;
            ln = (tag >> 2) + 1;
            off = (int64_t)in[p] | ((int64_t)in[p + 1] << 8);
            p += 2;
        } else {                               // copy, 4-byte offset
            if (p + 4 > in_len) return -1;
            ln = (tag >> 2) + 1;
            off = (int64_t)in[p] | ((int64_t)in[p + 1] << 8)
                | ((int64_t)in[p + 2] << 16) | ((int64_t)in[p + 3] << 24);
            p += 4;
        }
        if (off <= 0 || off > o || o + ln > out_cap) return -1;
        int64_t start = o - off;
        if (off >= ln) {
            std::memcpy(out + o, out + start, (size_t)ln);
        } else {
            for (int64_t i = 0; i < ln; i++) out[o + i] = out[start + i];
        }
        o += ln;
    }
    return o == out_cap ? o : -1;
}

int native_abi_version() { return 3; }

}  // extern "C"
