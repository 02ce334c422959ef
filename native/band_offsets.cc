// Band starts of global alignments for a block of pairs in one call.
//
// The row loop of jtk_tpu_torch/ops/banded_align.py::linear_offsets (its
// NumPy twin, applied row by row), with the same double arithmetic: the
// band's centre is nearbyint(i * (t / max(q, 1))), which under the default
// rounding mode is NumPy's round half to even on the same double.  The two
// accumulates of the twin (a running max, then a running min of off - i)
// depend only on earlier rows, so one forward pass does both.
//
//   g++ -O3 -shared -fPIC -o libband_offsets.so band_offsets.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

// q_lens, t_lens (B,) int32; out (B, Q + 1) int32, row major.  Returns B,
// or before writing any row -(b + 1) for the first pair b whose band is
// too narrow (t_len - q_len >= W - 1), or -(B + b + 1) for the first pair
// whose q_len lies outside 0..Q.
int64_t band_offsets(const int32_t* q_lens, const int32_t* t_lens, int64_t B,
                     int32_t Q, int32_t W, int32_t* out) {
  for (int64_t b = 0; b < B; ++b)
    if (int64_t(t_lens[b]) - q_lens[b] >= int64_t(W) - 1) return -(b + 1);
  for (int64_t b = 0; b < B; ++b)
    if (q_lens[b] < 0 || q_lens[b] > Q) return -(B + b + 1);
  const int64_t half = W / 2;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t q = q_lens[b], t = t_lens[b];
    const double step = double(t) / double(std::max<int64_t>(q, 1));
    const int64_t hi = std::max<int64_t>(t - W + 1, 0);
    int32_t* row = out + b * (int64_t(Q) + 1);
    int64_t run_max = std::numeric_limits<int64_t>::min();
    int64_t run_min = std::numeric_limits<int64_t>::max();
    for (int64_t i = 0; i <= q; ++i) {
      const int64_t center =
          i < q ? int64_t(std::nearbyint(double(i) * step)) : t;
      run_max = std::max(run_max, std::clamp<int64_t>(center - half, 0, hi));
      run_min = std::min(run_min, run_max - i);
      // reachability of (q, t): the slope-1 lower-bound line
      const int64_t line = (t - W + 1) - (q - i);
      const int64_t off = std::max(run_min + i, std::max<int64_t>(line, 0));
      row[i] = int32_t(std::clamp<int64_t>(off, 0, hi));
    }
    std::fill(row + q + 1, row + int64_t(Q) + 1, row[q]);
  }
  return B;
}

}  // extern "C"
