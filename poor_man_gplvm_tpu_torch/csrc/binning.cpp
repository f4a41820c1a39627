// Native spike binning for the port's ingestion layer (C ABI, loaded via
// ctypes by data/native.py; host code, built by the host's C++ compiler).
//
// The port's own copy of the JAX package's data/native/binning.cpp: scatter
// 1e7+ spike times into sliding/overlapping window count matrices.  Both
// windowing conventions of data/binning.py are implemented:
//
//   bin_sliding:     start-aligned windows; each spike counted once in the
//                    window with start index floor(t / step) (dropped if it
//                    falls past that window's end).
//   bin_overlapping: each spike counted in EVERY window containing it
//                    (window k covers [t0 + k*step, t0 + k*step + window)).
//
// Rows are pre-resolved unit indices (0..n_units-1); counts accumulate into
// a caller-allocated (n_units, n_windows) row-major double matrix.

#include <cmath>
#include <cstdint>

extern "C" {

void bin_sliding(const double* spike_times, const int64_t* rows,
                 int64_t n_spikes, double window, double step,
                 int64_t n_windows, int64_t n_units, double* out) {
  for (int64_t i = 0; i < n_spikes; ++i) {
    const double t = spike_times[i];
    const int64_t k = static_cast<int64_t>(std::floor(t / step));
    if (k < 0 || k >= n_windows) continue;
    if (t >= static_cast<double>(k) * step + window) continue;  // edge guard
    const int64_t r = rows[i];
    if (r < 0 || r >= n_units) continue;
    out[r * n_windows + k] += 1.0;
  }
}

void bin_overlapping(const double* spike_times, const int64_t* rows,
                     int64_t n_spikes, double t_start, double window,
                     double step, int64_t n_windows, int64_t n_units,
                     double* out) {
  for (int64_t i = 0; i < n_spikes; ++i) {
    const double rel = spike_times[i] - t_start;
    int64_t k_max = static_cast<int64_t>(std::floor(rel / step));
    int64_t k_min = static_cast<int64_t>(std::ceil((rel - window) / step));
    // clamp BOTH bounds into [0, n_windows-1], matching the reference's
    // np.clip edge behaviour (root core.py:1016-1017): spikes outside the
    // covered range register once in the boundary window
    if (k_min < 0) k_min = 0;
    if (k_min > n_windows - 1) k_min = n_windows - 1;
    if (k_max < 0) k_max = 0;
    if (k_max > n_windows - 1) k_max = n_windows - 1;
    const int64_t r = rows[i];
    if (r < 0 || r >= n_units) continue;
    double* row_out = out + r * n_windows;
    for (int64_t k = k_min; k <= k_max; ++k) row_out[k] += 1.0;
  }
}

}  // extern "C"
