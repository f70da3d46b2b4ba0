// Native point-cloud preprocessing for the input pipeline hot path.
//
// The reference's per-sample LiDAR processing (np.fromfile + range-filter +
// pad-or-subsample, ref: train_detect.py:147-189) runs in the Python loader
// loop. This library does the same work in C++ with zero Python-object
// traffic: one call reads the .bin file, filters to the point-cloud range,
// and writes a fixed-size zero-padded (max_points, out_channels) float32
// buffer, optionally random-subsampling with a seeded xorshift PRNG.
//
// Exposed via a plain C ABI (loaded with ctypes — no pybind11 dependency):
//   int pointprep_load_lidar(path, record_floats, out, max_points,
//                            out_channels, range6, seed)
// Returns the number of real (non-padding) points written, or -1 on error.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// xorshift128+ — deterministic, seedable, fast
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed ^ 0x9E3779B97F4A7C15ull;
    s1 = (seed << 1) | 1;
    for (int i = 0; i < 8; ++i) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
};

}  // namespace

extern "C" {

// Filter + pad/subsample points already in memory.
// in: (n_in, record_floats) float32; out: (max_points, out_channels) float32
// (zeroed by this function). Keeps the first out_channels of each record.
// range6: [x0, y0, z0, x1, y1, z1] strict-inequality filter
// (ref: train_detect.py:153-156 uses > and <).
int pointprep_filter_pad(const float* in, int64_t n_in, int record_floats,
                         float* out, int64_t max_points, int out_channels,
                         const float* range6, uint64_t seed) {
  if (record_floats < 3 || out_channels > record_floats) return -1;
  std::memset(out, 0, sizeof(float) * max_points * out_channels);

  // collect indices of in-range points
  std::vector<int64_t> keep;
  keep.reserve(static_cast<size_t>(n_in));
  for (int64_t i = 0; i < n_in; ++i) {
    const float* p = in + i * record_floats;
    if (p[0] > range6[0] && p[0] < range6[3] && p[1] > range6[1] &&
        p[1] < range6[4] && p[2] > range6[2] && p[2] < range6[5]) {
      keep.push_back(i);
    }
  }

  int64_t n_keep = static_cast<int64_t>(keep.size());
  if (n_keep > max_points) {
    // random subsample without replacement (partial Fisher-Yates)
    Rng rng(seed);
    for (int64_t i = 0; i < max_points; ++i) {
      int64_t j = i + static_cast<int64_t>(rng.below(n_keep - i));
      std::swap(keep[i], keep[j]);
    }
    n_keep = max_points;
  }
  for (int64_t i = 0; i < n_keep; ++i) {
    const float* p = in + keep[i] * record_floats;
    std::memcpy(out + i * out_channels, p, sizeof(float) * out_channels);
  }
  return static_cast<int>(n_keep);
}

// Read a raw float32 .bin file and run filter+pad. record_floats selects the
// parse stride (4 reproduces the reference misparse Q5; 5 is the real
// nuScenes record). Returns real point count or -1 on IO error.
int pointprep_load_lidar(const char* path, int record_floats, float* out,
                         int64_t max_points, int out_channels,
                         const float* range6, uint64_t seed) {
  if (record_floats <= 0) return -1;  // guard BEFORE the division below
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (bytes < 0) {  // ftell failure would turn into a huge allocation
    std::fclose(f);
    return -1;
  }
  int64_t n_floats = bytes / static_cast<long>(sizeof(float));
  std::vector<float> buf(static_cast<size_t>(n_floats));
  size_t got = std::fread(buf.data(), sizeof(float), n_floats, f);
  std::fclose(f);
  if (got != static_cast<size_t>(n_floats)) return -1;
  int64_t n_in = n_floats / record_floats;
  return pointprep_filter_pad(buf.data(), n_in, record_floats, out,
                              max_points, out_channels, range6, seed);
}

// ImageNet normalization of an interleaved uint8 RGB image into float32 NHWC
// (the ToTensor+Normalize step, ref: train_detect.py:126-130).
void pointprep_normalize_image(const uint8_t* rgb, int64_t n_pixels,
                               const float* mean3, const float* std3,
                               float* out) {
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3] = {1.0f / std3[0], 1.0f / std3[1], 1.0f / std3[2]};
  for (int64_t i = 0; i < n_pixels; ++i) {
    const uint8_t* p = rgb + i * 3;
    float* q = out + i * 3;
    q[0] = (p[0] * inv255 - mean3[0]) * inv_std[0];
    q[1] = (p[1] * inv255 - mean3[1]) * inv_std[1];
    q[2] = (p[2] * inv255 - mean3[2]) * inv_std[2];
  }
}

}  // extern "C"
