// Native batch sampler: the host-side per-step hot path (pixel sampling +
// GT gather) as a multithreaded C++ library.
//
// Role: the TPU-native analogue of the reference's ParallelDataManager C++
// side (reference parallel_datamanager.py pushes this work onto mp.Process
// workers; torch's DataLoader does its collation in C++). The jitted train
// step consumes a host-assembled {ray_indices, image, is_thermal} batch every
// iteration; this library produces it without Python-loop overhead.
//
// Exposed via a plain C ABI consumed with ctypes
// (nerfstudio_thermal_tpu/data/native_sampler.py); the Python sampler is the
// behavioral spec and remains the fallback when the shared object has not
// been built (`make -C nerfstudio_thermal_tpu/native`).
//
// RNG: xoshiro256** seeded per call — deterministic given (seed, call_index),
// independent of thread count (each image's draw stream is seeded by
// (seed, image_slot)).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    // splitmix64 init
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return n ? next() % n : 0; }
};

}  // namespace

extern "C" {

// Sample a patch-aligned ray batch and gather GT pixels.
//
// images:       array of n_images pointers to float32 [h, w, c] buffers
// heights/widths: per-image dims; channels: shared channel count
// is_thermal:   per-image flags (float)
// seed:         RNG seed (caller advances per step)
// num_rays:     rays to emit (multiple of patch*patch)
// patch:        patch side (1 = uniform)
//
// Outputs (caller-allocated):
// ray_indices:  int32 [num_rays, 3] (cam, y, x)
// image_out:    float32 [num_rays, channels]
// thermal_out:  float32 [num_rays]
int sample_batch(const float** images, const int32_t* heights,
                 const int32_t* widths, int32_t channels,
                 const float* is_thermal, int32_t n_images, uint64_t seed,
                 int32_t num_rays, int32_t patch, int32_t num_threads,
                 int32_t* ray_indices, float* image_out, float* thermal_out) {
  if (n_images <= 0 || num_rays <= 0 || patch < 1) return 1;
  const int unit = patch * patch;
  if (num_rays % unit != 0) return 2;

  // Equal rays per image over a seeded permutation, matching the Python
  // sampler's balancing semantics (data/pixel_samplers.py:58-90).
  int per_image = (num_rays / n_images) / unit * unit;
  if (per_image < unit) per_image = unit;

  std::vector<int32_t> order(n_images);
  for (int i = 0; i < n_images; i++) order[i] = i;
  Xoshiro perm_rng(seed ^ 0xabcdef12345ULL);
  for (int i = n_images - 1; i > 0; i--) {
    int j = static_cast<int>(perm_rng.below(i + 1));
    std::swap(order[i], order[j]);
  }

  // assign [start, count) ranges per image slot
  std::vector<int32_t> img_of_ray(num_rays / unit);
  {
    int total = 0, slot = 0;
    while (total * unit < num_rays) {
      int idx = order[slot % n_images];
      int want = per_image / unit;
      int remaining = num_rays / unit - total;
      if (want > remaining) want = remaining;
      for (int k = 0; k < want; k++) img_of_ray[total + k] = idx;
      total += want;
      slot++;
    }
  }

  const int n_patches = num_rays / unit;
  auto worker = [&](int t0, int t1) {
    for (int pi = t0; pi < t1; pi++) {
      const int cam = img_of_ray[pi];
      const int h = heights[cam], w = widths[cam];
      Xoshiro rng(seed * 0x9e3779b97f4a7c15ULL + pi * 2654435761ULL + cam);
      int y0, x0;
      if (patch <= 1) {
        y0 = static_cast<int>(rng.below(h));
        x0 = static_cast<int>(rng.below(w));
      } else {
        y0 = static_cast<int>(rng.below(h - patch));
        x0 = static_cast<int>(rng.below(w - patch));
      }
      const float* img = images[cam];
      for (int dy = 0; dy < patch; dy++) {
        for (int dx = 0; dx < patch; dx++) {
          const int r = pi * unit + dy * patch + dx;
          const int y = y0 + dy, x = x0 + dx;
          ray_indices[3 * r + 0] = cam;
          ray_indices[3 * r + 1] = y;
          ray_indices[3 * r + 2] = x;
          std::memcpy(image_out + r * channels,
                      img + (static_cast<int64_t>(y) * w + x) * channels,
                      sizeof(float) * channels);
          thermal_out[r] = is_thermal[cam];
        }
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt == 1 || n_patches < 256) {
    worker(0, n_patches);
  } else {
    std::vector<std::thread> threads;
    int chunk = (n_patches + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int a = t * chunk, b = std::min(n_patches, (t + 1) * chunk);
      if (a < b) threads.emplace_back(worker, a, b);
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}

// Version tag for the ctypes wrapper to sanity-check the ABI.
int native_sampler_abi_version() { return 1; }

}  // extern "C"
