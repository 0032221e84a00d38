// Native host-side batch assembly for the input pipeline.
//
// The reference feeds the device through PaddlePaddle's C++ DataLoader queue
// (train.py:46); the TPU rebuild's equivalent host hot loop is turning HDF5
// shard rows (float16, CHW — the storage contract, hdf5_manager.py:152-159)
// into device-ready float32 NHWC batches. That is a bandwidth-bound
// convert+transpose, done here fused and multi-threaded instead of two
// numpy passes (astype + transpose copy).
//
// Exposed via ctypes (no pybind11 in this environment); build:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread feeder.cpp -o libfeeder.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Portable IEEE half -> float conversion (no F16C dependency).
inline float half_to_float(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {
      // subnormal: normalize (value = mant * 2^-24; after the shift the
      // leading 1 becomes the implicit bit, exponent = -14 - shift)
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1Fu) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

// All 2^16 half values as floats (256 KB, fits L2): turns the branchy
// bit-twiddle above into one table load per element (~4x on the convert
// pass). Built once per process, thread-safe via C++11 static init.
const float* half_lut() {
  static const std::vector<float> lut = [] {
    std::vector<float> t(65536);
    for (uint32_t i = 0; i < 65536; ++i) t[i] = half_to_float(i);
    return t;
  }();
  return lut.data();
}

// Convert one image: CHW float16 -> NHWC float32 (dst is the n-th image
// slot of a [N,H,W,C] batch).
void convert_one(const uint16_t* src, float* dst, int c, int h, int w) {
  const int hw = h * w;
  const float* lut = half_lut();
  for (int ch = 0; ch < c; ++ch) {
    const uint16_t* plane = src + ch * hw;
    float* out = dst + ch;  // stride C in NHWC
    for (int i = 0; i < hw; ++i) {
      out[static_cast<size_t>(i) * c] = lut[plane[i]];
    }
  }
}

}  // namespace

extern "C" {

// src: [N, C, H, W] float16 (contiguous), dst: [N, H, W, C] float32.
void convert_f16chw_to_f32nhwc(const uint16_t* src, float* dst, int n, int c,
                               int h, int w, int nthreads) {
  const size_t img_in = static_cast<size_t>(c) * h * w;
  const size_t img_out = img_in;  // same element count
  if (nthreads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) {
      convert_one(src + i * img_in, dst + i * img_out, c, h, w);
    }
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      convert_one(src + i * img_in, dst + i * img_out, c, h, w);
    }
  };
  std::vector<std::thread> pool;
  int t = nthreads < n ? nthreads : n;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Same fused convert+transpose for float32 CHW sources (e.g. the reference
// reader contract where rows were already cast to f32).
void convert_f32chw_to_f32nhwc(const float* src, float* dst, int n, int c,
                               int h, int w, int nthreads) {
  const size_t img = static_cast<size_t>(c) * h * w;
  const int hw = h * w;
  std::atomic<int> next(0);
  auto one = [&](int i) {
    const float* s = src + i * img;
    float* d = dst + i * img;
    for (int ch = 0; ch < c; ++ch) {
      const float* plane = s + ch * hw;
      float* out = d + ch;
      for (int j = 0; j < hw; ++j) out[static_cast<size_t>(j) * c] = plane[j];
    }
  };
  if (nthreads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) one(i);
    return;
  }
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      one(i);
    }
  };
  std::vector<std::thread> pool;
  int t = nthreads < n ? nthreads : n;
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Raw uint8 CHW shard rows (storage_dtype="uint8") -> normalized float32
// NHWC: out = in * scale[c] + bias[c], with scale[c] = 1/(255*std[c]) and
// bias[c] = -mean[c]/std[c] precomputed by the caller (fuses the /255 +
// mean/std normalization into the transpose pass via a 256-entry LUT per
// channel).
void convert_u8chw_to_f32nhwc(const uint8_t* src, float* dst, int n, int c,
                              int h, int w, int nthreads, const float* scale,
                              const float* bias) {
  const size_t img = static_cast<size_t>(c) * h * w;
  const int hw = h * w;
  // per-channel value LUTs: 256 floats each
  std::vector<float> lut(static_cast<size_t>(c) * 256);
  for (int ch = 0; ch < c; ++ch)
    for (int v = 0; v < 256; ++v)
      lut[ch * 256 + v] = static_cast<float>(v) * scale[ch] + bias[ch];
  std::atomic<int> next(0);
  auto one = [&](int i) {
    const uint8_t* s = src + i * img;
    float* d = dst + i * img;
    for (int ch = 0; ch < c; ++ch) {
      const uint8_t* plane = s + ch * hw;
      const float* tab = lut.data() + ch * 256;
      float* out = d + ch;
      for (int j = 0; j < hw; ++j)
        out[static_cast<size_t>(j) * c] = tab[plane[j]];
    }
  };
  if (nthreads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) one(i);
    return;
  }
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      one(i);
    }
  };
  std::vector<std::thread> pool;
  int t = nthreads < n ? nthreads : n;
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
