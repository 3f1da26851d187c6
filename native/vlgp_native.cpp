// Native data-layer kernels for vlgp_tpu.
//
// The reference does all IO-side preprocessing in Python loops
// (spike-time binning at vlgp/util.py:515-538; per-trial packing implied
// by the list-of-dicts layout).  These are host-side, memory-bound jobs
// that sit on the critical path between storage and the device: done in C++
// with a thread pool they stop mattering.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Bin spike times into counts.
//
// times:    concatenated spike times for all units (sorted per unit)
// offsets:  (n_units + 1) prefix offsets into `times`
// out:      (n_units, n_bins) float32 counts, zero-initialized by caller
// start, binwidth, n_bins: grid spec
void vlgp_bin_spikes(const double* times, const int64_t* offsets,
                     int64_t n_units, double start, double binwidth,
                     int64_t n_bins, float* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t u = next.fetch_add(1);
      if (u >= n_units) return;
      const double* t0 = times + offsets[u];
      const double* t1 = times + offsets[u + 1];
      float* row = out + u * n_bins;
      for (const double* t = t0; t < t1; ++t) {
        double b = (*t - start) / binwidth;
        int64_t bi = (int64_t)std::floor(b);
        if (bi == n_bins && *t <= start + binwidth * n_bins) bi = n_bins - 1;
        if (bi >= 0 && bi < n_bins) row[bi] += 1.0f;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Pack ragged per-trial matrices into a padded (n, tmax, d) tensor + mask.
//
// src:      concatenated trial matrices, row-major (sum(lengths), d)
// lengths:  (n,) per-trial row counts
// out:      (n, tmax, d) float32, zero-initialized by caller
// mask:     (n, tmax) float32, zero-initialized by caller
void vlgp_pack_ragged(const float* src, const int64_t* lengths, int64_t n,
                      int64_t tmax, int64_t d, float* out, float* mask,
                      int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int64_t> starts(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) starts[i + 1] = starts[i] + lengths[i];
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t L = std::min<int64_t>(lengths[i], tmax);
      std::memcpy(out + i * tmax * d, src + starts[i] * d,
                  (size_t)(L * d) * sizeof(float));
      float* m = mask + i * tmax;
      std::fill(m, m + L, 1.0f);
    }
  };
  std::vector<std::thread> pool;
  for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Gather window segments out of a padded (n, tmax, d) tensor:
// out[k] = src[trial_idx[k], start[k] : start[k]+window]  (zero past tmax).
void vlgp_gather_segments(const float* src, const int32_t* trial_idx,
                          const int32_t* start, int64_t n_seg, int64_t tmax,
                          int64_t window, int64_t d, float* out,
                          int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t k = next.fetch_add(1);
      if (k >= n_seg) return;
      int64_t i = trial_idx[k];
      int64_t s = start[k];
      int64_t L = std::min<int64_t>(window, tmax - s);
      if (L > 0)
        std::memcpy(out + k * window * d, src + (i * tmax + s) * d,
                    (size_t)(L * d) * sizeof(float));
      if (L < window)
        std::memset(out + (k * window + std::max<int64_t>(L, 0)) * d, 0,
                    (size_t)((window - std::max<int64_t>(L, 0)) * d) *
                        sizeof(float));
    }
  };
  std::vector<std::thread> pool;
  for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
