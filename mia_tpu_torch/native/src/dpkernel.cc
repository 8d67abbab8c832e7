// Native banded DP fill for the host traceback path.
//
// Same integer recurrence as mia_tpu.ops.dp_numpy (and the TPU kernels):
// semi-global DP with position-specific substitution scores, running-argmax
// affine gaps, restart option, optional homopolymer-discounted gaps, and the
// exact reference tie-breaking priority.  Operates on a window the Python
// caller has already sliced (column indices are window-local), emitting full
// score+trace planes for the traceback walk.
//
// This is the narrow-band workhorse: bands of ~100-300 columns are far too
// small to amortise either numpy dispatch or a device round-trip, while a
// scalar fill runs them in microseconds.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kHim = -(int64_t(1) << 30);  // INT_MIN/2
constexpr int32_t kGop = 1000;
constexpr int32_t kGep = 200;
constexpr int kDepth = 15;

inline int sm_depth(int row, int len) {
  if (row < kDepth) return row;
  if (len - (row + 1) < kDepth) return 2 * kDepth - (len - (row + 1));
  return kDepth;
}

inline int32_t hp_discount(int gap_len, int hplen2) {
  static const double frac[] = {1.0, 0.5, 0.33, 0.25, 0.2,
                                0.17, 0.14, 0.13, 0.11, 0.10};
  double f = (hplen2 >= 1 && hplen2 <= 10) ? frac[hplen2 - 1] : 0.10;
  return (int32_t)(kGep * gap_len + kGop * f);
}

}  // namespace

extern "C" {

// Fill score/trace planes (len2 x len1, row-major).  All pointers may not
// alias.  hp arrays may be null (no homopolymer discounting).  seq1/seq2 are
// the raw characters of the window (used only for hp base equality).
void mia_dp_fill(const int8_t* s1c, int len1, const int8_t* s2c, int len2,
                 const int32_t* submat /* [31][5][5] */, const uint8_t* mask,
                 int sg5, const char* seq1, const char* seq2,
                 const int32_t* hpcl, const int32_t* hpcs,
                 const int32_t* hprl, const int32_t* hprs, int win_lo,
                 int32_t* score, int32_t* trace) {
  const bool hp = hpcl != nullptr;
  std::vector<int32_t> best_gap_row(len1, 0);
  int32_t row_sm[5];

  // row 0 (depth 0 always)
  for (int i = 0; i < 5; ++i) row_sm[i] = submat[(0 * 5 + i) * 5 + s2c[0]];
  for (int c = 0; c < len1; ++c) {
    score[c] = mask[c] ? row_sm[s1c[c]] : kHim;
    trace[c] = 0;
  }

  for (int row = 1; row < len2; ++row) {
    const int d = sm_depth(row, len2);
    for (int i = 0; i < 5; ++i) row_sm[i] = submat[(d * 5 + i) * 5 + s2c[row]];
    int32_t* cur = score + (size_t)row * len1;
    int32_t* ctr = trace + (size_t)row * len1;
    const int32_t* prev = cur - len1;
    const int32_t* prev2 = row >= 2 ? prev - len1 : nullptr;

    if (mask[0]) {
      cur[0] = row_sm[s1c[0]];
      if (sg5) cur[0] -= kGop + kGep * (row + 1);
    } else {
      cur[0] = kHim;
    }
    ctr[0] = 0;

    int best_gap_col = 0;
    const int32_t start_new = sg5 ? -(kGop + kGep * (row + 1)) : 0;

    for (int col = 1; col < len1; ++col) {
      if (!mask[col]) {
        cur[col] = kHim;
        ctr[col] = 0;
        continue;
      }
      int32_t gap_col = kHim;
      if (col >= 2) {
        if (prev[col - 2] - (kGop + kGep) >
            prev[best_gap_col] - (kGop + kGep * (col - best_gap_col - 1))) {
          best_gap_col = col - 2;
        }
        gap_col = prev[best_gap_col] - (kGop + kGep * (col - best_gap_col - 1));
      }
      int32_t gap_row = kHim;
      if (row >= 2) {
        int32_t bgr = best_gap_row[col - 1];
        if (prev2[col - 1] - (kGop + kGep) >
            score[(size_t)bgr * len1 + col - 1] -
                (kGop + kGep * (row - bgr - 1))) {
          bgr = row - 2;
          best_gap_row[col - 1] = bgr;
        }
        gap_row = score[(size_t)bgr * len1 + col - 1] -
                  (kGop + kGep * (row - bgr - 1));
      }
      const int32_t diag = prev[col - 1];

      int32_t hc = kHim, hr = kHim;
      if (hp && seq1[col] == seq2[row]) {
        const int gcol = col + win_lo;
        if (hprs[row] == row && hpcs[col] != gcol && hpcs[col] > 0 &&
            hpcs[col] - 1 >= win_lo) {
          hc = prev[hpcs[col] - 1 - win_lo] -
               hp_discount(gcol - hpcs[col], hprl[row]);
        }
        if (hpcs[col] == gcol && hprs[row] != row && hprs[row] > 0) {
          hr = score[(size_t)(hprs[row] - 1) * len1 + (col - 1)] -
               hp_discount(gcol - hpcs[col], hprl[row]);
        }
      }

      if (start_new > diag && start_new > gap_col && start_new > gap_row &&
          start_new > hc && start_new > hr) {
        ctr[col] = col;
        cur[col] = start_new;
      } else if (diag >= gap_col && diag >= gap_row && diag >= hc &&
                 diag >= hr) {
        ctr[col] = 0;
        cur[col] = row_sm[s1c[col]] + diag;
      } else if (gap_col >= gap_row && gap_col >= hc && gap_col >= hr) {
        cur[col] = row_sm[s1c[col]] + gap_col;
        ctr[col] = best_gap_col;
      } else if (gap_row >= hc && gap_row >= hr) {
        cur[col] = row_sm[s1c[col]] + gap_row;
        ctr[col] = -best_gap_row[col - 1];
      } else if (hc >= hr) {
        cur[col] = row_sm[s1c[col]] + hc;
        ctr[col] = hpcs[col] - 1 - win_lo;
      } else {
        cur[col] = row_sm[s1c[col]] + hr;
        ctr[col] = -(hprs[row] - 1);
      }
    }
  }
}

}  // extern "C"

extern "C" {

// Walk the trace back from (aer, aec) emitting the gapped alignment strings
// (window-local columns; same trace encoding as the Python engine).  Returns
// the alignment length; *abr/*abc receive the start cell.
int32_t mia_dp_traceback(const int32_t* trace, int len1, int len2, int aer,
                         int aec, const char* seq1, const char* seq2,
                         char* out_ref, char* out_frag, int cap,
                         int32_t* abr, int32_t* abc) {
  (void)len2;
  int row = aer, col = aec;
  int n = 0;
  char* r = out_ref + cap;
  char* f = out_frag + cap;
  const int32_t* tr = trace;
  // bounded walk: overflowing cap returns -1 (documented per-read fallback)
  // instead of silently writing before out_ref
  while (tr[(size_t)row * len1 + col] != col &&
         tr[(size_t)row * len1 + col] != -row) {
    if (n >= cap) return -1;
    *--r = seq1[col];
    *--f = seq2[row];
    ++n;
    int32_t t = tr[(size_t)row * len1 + col];
    if (t == 0) {
      --row;
      --col;
    } else if (t < 0) {
      int next_row = -t;
      --row;
      --col;
      while (row > next_row) {
        if (n >= cap) return -1;
        *--f = seq2[row--];
        *--r = '-';
        ++n;
      }
    } else {
      int next_col = t;
      --row;
      --col;
      while (col > next_col) {
        if (n >= cap) return -1;
        *--f = '-';
        *--r = seq1[col--];
        ++n;
      }
    }
  }
  if (n >= cap) return -1;
  *--r = seq1[col];
  *--f = seq2[row];
  ++n;
  *abr = row;
  *abc = col;
  memmove(out_ref, r, n);
  memmove(out_frag, f, n);
  return n;
}

// Fused fill + last-row argmax (earliest tie wins, src/mia.c:1278-1302) +
// begin walk (src/mia.c:605-637) + optional gapped-string traceback, all in
// one call: the per-read host path costs one FFI round-trip instead of four,
// and the score/trace planes live in reusable thread-local buffers instead
// of per-call numpy allocations.
//
// out_meta: [0]=aec (window-local), [1]=abr, [2]=abc (window-local),
// [3]=alignment string length (0 when do_trace == 0).  Returns best score.
int32_t mia_sg_window(const int8_t* s1c, int len1, const int8_t* s2c,
                      int len2, const int32_t* submat, const uint8_t* mask,
                      int sg5, const char* seq1, const char* seq2,
                      const int32_t* hpcl, const int32_t* hpcs,
                      const int32_t* hprl, const int32_t* hprs, int win_lo,
                      int do_trace, char* out_ref, char* out_frag, int cap,
                      int32_t* out_meta) {
  static thread_local std::vector<int32_t> score_buf, trace_buf;
  score_buf.resize((size_t)len1 * len2);
  trace_buf.resize((size_t)len1 * len2);
  mia_dp_fill(s1c, len1, s2c, len2, submat, mask, sg5, seq1, seq2, hpcl,
              hpcs, hprl, hprs, win_lo, score_buf.data(), trace_buf.data());
  const int32_t* last = score_buf.data() + (size_t)(len2 - 1) * len1;
  int aec = 0;
  int32_t best = last[0];
  for (int c = 1; c < len1; ++c) {
    if (last[c] > best) {
      best = last[c];
      aec = c;
    }
  }
  out_meta[0] = aec;
  if (do_trace) {
    out_meta[3] =
        mia_dp_traceback(trace_buf.data(), len1, len2, len2 - 1, aec, seq1,
                         seq2, out_ref, out_frag, cap, &out_meta[1],
                         &out_meta[2]);
  } else {
    int row = len2 - 1, col = aec;
    const int32_t* tr = trace_buf.data();
    while (tr[(size_t)row * len1 + col] != col &&
           tr[(size_t)row * len1 + col] != -row) {
      int32_t t = tr[(size_t)row * len1 + col];
      if (t == 0) {
        --row;
        --col;
      } else if (t < 0) {
        row = -t;
        --col;
      } else {
        col = t;
        --row;
      }
    }
    out_meta[1] = row;
    out_meta[2] = col;
    out_meta[3] = 0;
  }
  return best;
}

}  // extern "C"
