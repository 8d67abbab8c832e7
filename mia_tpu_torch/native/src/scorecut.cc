// Length-vs-score cutoff fit with the reference's floating-point behaviour.
//
// The reference is built with gcc -O2, whose default -ffp-contract=fast
// fuses the multiply-adds in find_fsdb_score_cut (src/fsdb.c:269-383) and in
// the per-read cutoff-line evaluation (src/mia.c:352,462,466).  Those fused
// operations round differently from sequential IEEE arithmetic, and reads
// sitting exactly on the cutoff line flip their `dropped` flag with it.  The
// expressions here keep the same shapes under the same compiler defaults so
// the fit and the drop decisions match the reference bit-for-bit.

#include <cstdint>

extern "C" {

void mia_score_cut_fit(const int32_t* lens, const int32_t* scores,
                       const uint8_t* sel, int64_t n, double* slope_out,
                       double* intercept_out) {
  double xbar = 0, ybar = 0;
  int64_t j = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (sel[i]) {
      xbar += lens[i];
      ybar += scores[i];
      ++j;
    }
  }
  xbar /= j;
  ybar /= j;

  double ssxy = 0, ssxx = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (sel[i]) {
      ssxy += (lens[i] - xbar) * (scores[i] - ybar);
      ssxx += (lens[i] - xbar) * (lens[i] - xbar);
    }
  }
  double slope_bf = ssxy / ssxx;
  double intercept_bf = ybar - slope_bf * xbar;

  double max_slope_delta = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (sel[i]) {
      double slope_delta =
          (scores[i] - ((slope_bf * lens[i]) + intercept_bf)) / lens[i];
      if (slope_delta > max_slope_delta) max_slope_delta = slope_delta;
    }
  }

  *intercept_out = intercept_bf;
  if ((slope_bf - max_slope_delta) > 0) {
    *slope_out = slope_bf - (max_slope_delta * 2.0);
  } else {
    *slope_out = slope_bf * (80 / 100.0);  // SCORE_CUTOFF_BUFFER/100
  }
}

// min_score_for_len = intercept + (slope * len), evaluated with the same
// contraction as the reference's cull/collapse loops.
void mia_min_scores(double slope, double intercept, const int32_t* lens,
                    int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = intercept + (slope * lens[i]);
  }
}

}  // extern "C"
