// Native panel codec: fused mask-build + zero-fill over the raw char array.
//
// The reference loader (its src/data_loader.py:45-65) builds the validity
// mask and zero-fills invalid entries in several NumPy passes over the
// [T, N, 1+F] panel: a comparison per channel, an
// all-reduce over features, an isnan pass, then two `np.where` copies. At the
// real workload that is ~6 full sweeps over ~1.2 GB of data on the host.
//
// This codec does the whole thing in ONE multithreaded pass per (t, i) row:
// read the 1+F channel strip once (hot in L1), decide validity, and write the
// zero-filled returns/features + mask. The Python wrapper (native.py) falls
// back to the NumPy path when the shared library cannot be built. A copy of
// the JAX package's data/_native/panel_codec.cpp: the two decode bit for bit
// alike.
//
// An observation is valid iff: return > MISSING+1, return is not NaN, and
// every feature > MISSING+1 (data_loader.py:50-57).

#include <cmath>
#include <cstdint>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// data:    [T, N, 1+F] float32, returns in channel 0 (read-only)
// returns_out: [T, N] float32 (zero where invalid)
// features_out: [T, N, F] float32 (zero where invalid)
// mask_out: [T, N] uint8 (1 = valid)
// Returns the number of valid observations.
long long panel_decode(const float* data, long long T, long long N,
                       long long F, float missing_threshold,
                       float* returns_out, float* features_out,
                       uint8_t* mask_out) {
  const long long rows = T * N;
  const long long stride = 1 + F;
  long long valid_count = 0;

#if defined(_OPENMP)
#pragma omp parallel for reduction(+ : valid_count) schedule(static)
#endif
  for (long long r = 0; r < rows; ++r) {
    const float* row = data + r * stride;
    const float ret = row[0];
    bool valid = (ret > missing_threshold) && !std::isnan(ret);
    if (valid) {
      for (long long f = 1; f <= F; ++f) {
        if (!(row[f] > missing_threshold)) {  // NaN compares false => invalid
          valid = false;
          break;
        }
      }
    }
    mask_out[r] = valid ? 1 : 0;
    returns_out[r] = valid ? ret : 0.0f;
    float* feat = features_out + r * F;
    if (valid) {
      for (long long f = 0; f < F; ++f) feat[f] = row[1 + f];
    } else {
      for (long long f = 0; f < F; ++f) feat[f] = 0.0f;
    }
    valid_count += valid ? 1 : 0;
  }
  return valid_count;
}

int panel_codec_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
