// Native host runtime for the gaussian-splat framework.
//
// The reference implements its entire host runtime in C++ (loader:
// src/splat/file_io.cpp + the vendored happly parser, include/happly.h,
// ~2k LoC of row-wise field extraction). Device compute lives in
// XLA/Pallas; this library covers the host-side hot paths that feed it:
//
//   * deinterleave_f32 — strided extraction of k float32 fields from a
//     packed binary-PLY vertex buffer into a dense (n, k) row-major matrix,
//     multithreaded. This is the work happly does one value at a time.
//   * center_flip_f32 — the reference's scene preprocessing
//     (src/main/splat.cpp:92-100): centre on the bounding-box midpoint and
//     negate z. One parallel pass for the reduce, one for the update.
//   * u8_from_f32 — exposure/gamma tone map + quantise for PNG dumps and
//     UI preview frames (ipu_rasteriser.cpp:131-144 does f32->u8 BGR on
//     every frame readback).
//
// Plain C ABI for ctypes (no pybind11 in this environment). Build:
//   make -C csrc        (produces libgsplat_native.so)
// Python loads it opportunistically (io/native.py) and falls back to numpy.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(begin, end) over [0, n) split across hardware threads.
template <typename F>
void parallel_for(int64_t n, F fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = std::max<int64_t>(1, std::min<int64_t>(hw, n / 16384));
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Extract k float32 fields at byte offsets `offsets[0..k)` from each of n
// records of `stride` bytes in `buf`, writing row-major (n, k) to `out`.
void deinterleave_f32(const uint8_t* buf, int64_t n, int64_t stride,
                      const int64_t* offsets, int64_t k, float* out) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* rec = buf + i * stride;
      float* row = out + i * k;
      for (int64_t j = 0; j < k; ++j) {
        std::memcpy(&row[j], rec + offsets[j], sizeof(float));
      }
    }
  });
}

// Centre (n, stride_floats) points on the bbox midpoint of their first
// three components and negate z (splat.cpp:92-100 parity). Returns the
// pre-centering bbox via bb_out[6] = {minx,miny,minz,maxx,maxy,maxz}.
void center_flip_f32(float* xyz, int64_t n, int64_t stride_floats,
                     float* bb_out) {
  float mins[3] = {INFINITY, INFINITY, INFINITY};
  float maxs[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int64_t i = 0; i < n; ++i) {
    const float* p = xyz + i * stride_floats;
    for (int j = 0; j < 3; ++j) {
      mins[j] = std::min(mins[j], p[j]);
      maxs[j] = std::max(maxs[j], p[j]);
    }
  }
  float c[3] = {(mins[0] + maxs[0]) * 0.5f, (mins[1] + maxs[1]) * 0.5f,
                (mins[2] + maxs[2]) * 0.5f};
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float* p = xyz + i * stride_floats;
      p[0] -= c[0];
      p[1] -= c[1];
      p[2] = -(p[2] - c[2]);
    }
  });
  for (int j = 0; j < 3; ++j) {
    bb_out[j] = mins[j];
    bb_out[3 + j] = maxs[j];
  }
}

// Tone-map n float32 values to u8: clamp(pow(x * exposure, 1/gamma)) * 255.
void u8_from_f32(const float* in, int64_t n, float exposure,
                 float inv_gamma, uint8_t* out) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float v = in[i] * exposure;
      if (inv_gamma != 1.0f) v = std::pow(std::max(v, 0.0f), inv_gamma);
      v = std::min(std::max(v, 0.0f), 1.0f);
      out[i] = static_cast<uint8_t>(v * 255.0f + 0.5f);
    }
  });
}

}  // extern "C"
