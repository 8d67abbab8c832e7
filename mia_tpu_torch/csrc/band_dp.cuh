// The band layout and the semi-global DP step of pass 1's WIDE rows, shared
// by the band form (dp_band.cu: a row on 1, 2, 4 or 8 warps of one block)
// and the strand form (dp_strand.cu: a row on a cluster of CTAs).  The two
// differ only in how a DP row's column-gap prefix and a slice's left
// neighbour cross from warp to warp and from CTA to CTA; this header holds
// the rest:
//   * the band: a row's valid intervals sorted by start and joined into runs
//     (band_runs); its band columns are the open columns and the two columns
//     before each run, in order, each keeping its real window column
//     (col_of) for the gap costs, and a closed column is a sixth code of the
//     score table, (HIM, HIM) (band_column, column_terms);
//   * an origin counts for the column gap where the column two to its right
//     is open, and band column 0 always (gate_origins);
//   * each DP row's PSSM depth from the read's length (find_sm_depth,
//     src/pssm.c:36-46), as dp_torch.depths_for gives it (table_row);
//   * one DP row of a thread's columns: the column-gap prefix (gap_prefix,
//     then warp_prefix over the warp's lanes), the row gaps (row_gaps), and
//     each cell's base and value with DPX add-max, the restart only on a
//     strict > (cell_base, cell_value);
//   * the best value and its first window column (lane_best, warp_best);
//   * under -h (src/mia.c:883-905) the step's homopolymer candidates: the
//     read runs of each DP row (hp_read_runs), each column's window char and
//     flags (hp_column), each DP row's kind and the columns that take its
//     candidate (hp_kind, hp_hits), the staged row before a read run
//     (hp_stage) and the candidate's join (hp_take).  Where the staged row
//     and the hp_col sources live, and how a candidate reads them, is each
//     form's own.
// The plain versions are dp_torch.last_row_band_plain,
// last_row_strand_plain and their -h counterparts; each equals the whole
// window's recurrence bit for bit (int32).  Everything here is
// __forceinline__: a form's row loop is one straight-line body.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace band {

// Duplicates of the Python side's values (entries.MAX_INTERVALS, L_MAX,
// mia_tpu_torch.constants, dp_torch._LOW); each form's constants entry
// exports them so that the loader (torchcfg.kernel_library) refuses a
// library that disagrees.
constexpr int kK = 16;               // intervals a row
constexpr int kLMax = 256;           // read rows
constexpr int kPssmDepth = 15;
constexpr int kDepth = 2 * kPssmDepth + 1;
constexpr int kCodes = 6;            // reference codes 0..4, and 5: a closed column
constexpr int GOP = 1000;
constexpr int GEP = 200;
constexpr int HIM = -1073741824;                 // INT_MIN / 2
constexpr int LOW = -(1 << 30) - (1 << 29);      // below any live value
constexpr int kGate = -(1 << 29);    // addend that sinks a value below every live one
constexpr unsigned FULL = 0xffffffffu;
constexpr int kHpw = 32;             // -h row reach (entries.HPW_ROUTE)
constexpr int kPengop = 11;          // -h gap-open discounts

// A row's band: its valid intervals sorted by start, and its runs: the
// first window column and first band column of each, and its columns.
struct Runs {
  int32_t lo[kK], hi[kK];
  int32_t seg_col[kK], seg_at[kK], seg_n[kK];
};

// One warp, every lane: sorts row e's valid intervals (ivl [., kK, 2]
// window-local [lo, hi)) by start into r and joins them into runs.  Returns
// the number of valid intervals; nband: the row's band columns.
__device__ __forceinline__ int band_runs(const int32_t* ivl, int64_t e, Runs& r, int lane,
                                         int& nband) {
  int lo = 0, hi = 0;
  if (lane < kK) {
    lo = ivl[(e * kK + lane) * 2];
    hi = ivl[(e * kK + lane) * 2 + 1];
  }
  const unsigned valid = __ballot_sync(FULL, lane < kK && lo < hi);
  const int n = __popc(valid);
  int rank = 0;
  for (int i = 0; i < kK; ++i) {
    const int olo = __shfl_sync(FULL, lo, i);
    rank += ((valid >> i) & 1) && (olo < lo || (olo == lo && i < lane));
  }
  if ((valid >> lane) & 1) {
    r.lo[rank] = lo;
    r.hi[rank] = hi;
  }
  __syncwarp();
  // lane i < n: sorted interval i adds the band columns [start, hi) past
  // every earlier interval's end
  const int my_lo = lane < n ? r.lo[lane] : 0;
  const int my_hi = lane < n ? r.hi[lane] : 0;
  int upto = my_hi;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) upto = max(upto, __shfl_up_sync(FULL, upto, off));
  int before = __shfl_up_sync(FULL, upto, 1);
  if (lane == 0) before = 0;
  const int start = max(max(my_lo - 2, 0), before);
  const int cnt = lane < n ? max(my_hi - start, 0) : 0;
  int at = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, at, off);
    if (lane >= off) at += t;
  }
  nband = __shfl_sync(FULL, at, 31);
  if (lane < n) {
    r.seg_col[lane] = start;
    r.seg_at[lane] = at - cnt;
    r.seg_n[lane] = cnt;
  }
  return n;
}

__device__ __forceinline__ bool is_open(const Runs& r, int n, int c) {
  bool o = false;
  for (int i = 0; i < n; ++i) o |= r.lo[i] <= c && c < r.hi[i];
  return o;
}

// The window column of band column k: in the run holding it, or past the
// band, continuing after its last column.
__device__ __forceinline__ int col_of(const Runs& r, int n, int k) {
  int c = 0;
  for (int i = 0; i < n; ++i)
    if (r.seg_n[i] > 0 && r.seg_at[i] <= k) c = r.seg_col[i] + k - r.seg_at[i];
  return c;
}

// Band column k of a row of nband band columns whose window starts at
// global column wlo of a state of wtot columns: its window column c,
// whether it lies in the band and in the state (in), and whether it is
// open (the return).
__device__ __forceinline__ bool band_column(const Runs& r, int n, int nband, int k, int wlo,
                                            int wtot, int& c, bool& in) {
  c = col_of(r, n, k);
  const bool inband = k < nband;
  in = inband && wlo + c < wtot;
  return inband && is_open(r, n, c);
}

// What a column of window column c and reference code `code` keeps in
// registers: the byte offset of its code in a table row (5 where closed),
// GEP * c (what it adds as a column-gap origin) and minus the column gap's
// cost into it, GOP + GEP * (c - 1).
__device__ __forceinline__ void column_terms(int c, bool open, int code, int& woff, int& gadd,
                                             int& ncost) {
  woff = 8 * (open ? (code < 0 ? 0 : (code > 4 ? 4 : code)) : 5);
  gadd = GEP * c;
  ncost = -(GOP + GEP * (c - 1));
}

// Origin j counts where column j + 2 is open (mbits: this thread's open
// columns, nbits: the next two), and band column 0 always (first): the
// others add kGate instead.
template <int kCPL>
__device__ __forceinline__ void gate_origins(int (&gadd)[kCPL], unsigned mbits, unsigned nbits,
                                             bool first) {
  const unsigned cand_ok = ((mbits | (nbits << kCPL)) >> 2) | (first ? 1u : 0u);
#pragma unroll
  for (int j = 0; j < kCPL; ++j)
    if (!((cand_ok >> j) & 1u)) gadd[j] = kGate;
}

// The score table: per depth and read code, per reference code, (score
// where the cell keeps its base, addend where it restarts); code 5 (a
// closed column): (HIM, HIM).  Filled by the threads tid of nthreads.
__device__ __forceinline__ void fill_table(int2* tab, const int32_t* submat, int tid,
                                           int nthreads) {
  for (int i = tid; i < kDepth * 5 * kCodes; i += nthreads) {
    const int w = i % kCodes, x = (i / kCodes) % 5, d = i / (kCodes * 5);
    tab[i] = w < 5 ? make_int2(submat[(d * 5 + w) * 5 + x], 0) : make_int2(HIM, HIM);
  }
}

// A read code 0..4 of a read's padded code (pad 4).
__device__ __forceinline__ uint8_t read_code(int x) {
  return (uint8_t)(x < 0 ? 0 : (x > 4 ? 4 : x));
}

// The table row of DP row `row` of a read of len bases whose code there is
// x: the PSSM depth from the read's both ends.
__device__ __forceinline__ const char* table_row(const int2* tab, int row, int len, int x) {
  const int from_back = len - (row + 1);
  int d = row < kPssmDepth ? row
                           : (from_back < kPssmDepth ? 2 * kPssmDepth - from_back : kPssmDepth);
  d = d < 0 ? 0 : (d > 2 * kPssmDepth ? 2 * kPssmDepth : d);
  return (const char*)(tab + (d * 5 + x) * kCodes);
}

// Row 0: each column's score, no row before it.
template <int kCPL>
__device__ __forceinline__ void first_row(const char* trow, const int (&woff)[kCPL],
                                          int (&prev)[kCPL], int (&prev2)[kCPL],
                                          int (&rbest)[kCPL]) {
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    prev[j] = ((const int2*)(trow + woff[j]))->x;
    prev2[j] = LOW;
    rbest[j] = prev[j];
  }
}

// Column gaps over this thread's columns: the inclusive prefix max of
// P[c] + GEP * column over the origins that count (rl); returns its last.
template <int kCPL>
__device__ __forceinline__ int gap_prefix(const int (&P)[kCPL], const int (&gadd)[kCPL],
                                          int (&rl)[kCPL]) {
  int run = LOW;
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    run = __viaddmax_s32(P[j], gadd[j], run);
    rl[j] = run;
  }
  return run;
}

// The same over the warp: returns the inclusive max over lanes <= this one
// (lane 31: the warp's total); excl, the max over the lanes before (LOW on
// lane 0); pre_m2, the prefix two columns before this lane's first column
// (lane 0: its caller's to set).
template <int kCPL>
__device__ __forceinline__ int warp_prefix(int run, const int (&rl)[kCPL], int lane, int& excl,
                                           int& pre_m2) {
  int tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    tot = max(tot, __shfl_up_sync(FULL, tot, off));  // a lane below off reads itself
  excl = __shfl_up_sync(FULL, tot, 1);
  if (lane == 0) excl = LOW;
  pre_m2 = __shfl_up_sync(FULL, max(rl[kCPL - 2], excl), 1);
  return tot;
}

// Row gaps: the running per-column max over rows <= row - 2 (Q: row - 2).
template <int kCPL>
__device__ __forceinline__ void row_gaps(const int (&Q)[kCPL], int row, int (&rbest)[kCPL]) {
  const int add = GEP * (row - 2);
#pragma unroll
  for (int j = 0; j < kCPL; ++j) rbest[j] = __viaddmax_s32(Q[j], add, rbest[j]);
}

// A cell's base before its -h candidate: the column gap from the prefix two
// columns back (pre - its cost), the diagonal, the row gap (rb, the left
// column's row-gap max, plus neg_grow).
__device__ __forceinline__ int cell_base(int pre, int ncost, int diag, int rb, int neg_grow) {
  const int base = __viaddmax_s32(pre, ncost, diag);
  return __viaddmax_s32(rb, neg_grow, base);
}

// A cell's value: its base and score, or the restart's value and addend
// where the base falls below start_new (strict: a tie keeps the base).
__device__ __forceinline__ int cell_value(int base, int start_new, const char* trow, int woff) {
  const int2 cell = *(const int2*)(trow + woff);
  bool keeps;  // base >= start_new: no restart
  const int m = __vibmax_s32(base, start_new, &keeps);
  return m + (keeps ? cell.x : cell.y);
}

// (bv, bc) takes (ov, oc) where it is larger, or equal at an earlier column.
__device__ __forceinline__ void take_better(int ov, int oc, int& bv, int& bc) {
  if (ov > bv || (ov == bv && oc < bc)) {
    bv = ov;
    bc = oc;
  }
}

// This thread's best value and its first window column.  A closed column
// ranks as (HIM, column 0): with no open column the answer is the whole
// window's, (HIM, 0); an open one is always above HIM.
template <int kCPL>
__device__ __forceinline__ void lane_best(const int (&prev)[kCPL], unsigned mbits,
                                          const int (&ncost)[kCPL], int& bv, int& bc) {
  bv = INT32_MIN;
  bc = 0;
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    const bool open = (mbits >> j) & 1u;
    take_better(open ? prev[j] : HIM, open ? (-ncost[j] - GOP) / GEP + 1 : 0, bv, bc);
  }
}

// The warp's best and its first column, on every lane.
__device__ __forceinline__ void warp_best(int& bv, int& bc) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, bv, off);
    const int oc = __shfl_xor_sync(FULL, bc, off);
    take_better(ov, oc, bv, bc);
  }
}

// ---- -h ------------------------------------------------------------------

// The band column of window column s, which lies in the band.
__device__ __forceinline__ int band_of(const Runs& r, int n, int s) {
  int k = 0;
  for (int i = 0; i < n; ++i) {
    const int s0 = r.seg_col[i];
    if (s0 <= s && s < s0 + r.seg_n[i]) k = r.seg_at[i] + s - s0;
  }
  return k;
}

// Bit 7 of every byte of x says whether the byte is zero.
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x);
}

// The code 0..4 of a read char.
__device__ __forceinline__ int hp_code(const int8_t* b2i, int x) {
  x = b2i[x];
  return x < 0 ? 0 : (x > 4 ? 4 : x);
}

// One warp, every lane: for each row r < L of a read of chars chr (pad 0),
// the start row of the read run holding it (hprs) and its discount slot,
// min(run length - 1, 10) (pidx); dp_entries.cu's ballots: the nearest run
// start at or before each row, the nearest run end at or after it.
__device__ __forceinline__ void hp_read_runs(const uint8_t* chr, int L, uint8_t* hprs,
                                             uint8_t* pidx, int lane) {
  int carry = 0;
  for (int base = 0; base < L; base += 32) {
    const int r = base + lane;
    const bool changed = r >= L || r == 0 || chr[r] != chr[r - 1];
    const unsigned m = __ballot_sync(FULL, changed) & (FULL >> (31 - lane));
    const int hs = m ? base + 31 - __clz(m) : carry;
    if (r < L) hprs[r] = (uint8_t)hs;
    carry = __shfl_sync(FULL, hs, 31);
  }
  carry = L - 1;
  for (int base = ((L - 1) / 32) * 32; base >= 0; base -= 32) {
    const int r = base + lane;
    const bool ends = r >= L - 1 || chr[r + 1] != chr[r];
    const unsigned m = __ballot_sync(FULL, ends) & (FULL << lane);
    const int he = m ? base + __ffs(m) - 1 : carry;
    if (r < L) {
      const int run = he - hprs[r] + 1;
      pidx[r] = (uint8_t)(run < 1 ? 0 : (run > kPengop ? kPengop - 1 : run - 1));
    }
    carry = __shfl_sync(FULL, he, 0);
  }
  __syncwarp();
}

// A thread's kCPL columns under -h: window chars (4 a word) and, as 0x80
// flags in the same layout, the columns that start a reference run (hrb:
// hp_row may take them) and those with an open hp_col source (hcb).
template <int kCPL>
struct HpCols {
  static constexpr int kW = (kCPL + 3) / 4;
  uint32_t wchr[kW], hrb[kW], hcb[kW];
};

// Column j of a thread's (window column c, global gc = wlo + c, open, in:
// in the band and the state; ch its reference char and hc its run's global
// start, 0 and 0 where not in): its char and flags into h, and its hp_col
// source's band column, the column before its reference run, where that is
// open (else -1; on the whole window a closed source's value is HIM, below
// the restart, so it gives no candidate).
template <int kCPL>
__device__ __forceinline__ int hp_column(HpCols<kCPL>& h, int j, const Runs& r, int n,
                                         bool open, int c, int wlo, uint32_t ch, int hc) {
  const int gc = wlo + c;
  if ((j & 3) == 0) h.wchr[j >> 2] = h.hrb[j >> 2] = h.hcb[j >> 2] = 0;
  h.wchr[j >> 2] |= ch << (8 * (j & 3));
  const uint32_t flag = 0x80u << (8 * (j & 3));
  if (open && c >= 1 && hc == gc) h.hrb[j >> 2] |= flag;
  if (open && c >= 1 && hc != gc && hc > 0 && hc - 1 >= wlo && is_open(r, n, hc - 1 - wlo)) {
    h.hcb[j >> 2] |= flag;
    return band_of(r, n, hc - 1 - wlo);
  }
  return -1;
}

// The byte offset of band column i of a slice in a lane-major array: warp
// w's 32 kCPL columns from w 32 kCPL on, column kCPL l + j of it at j 32 + l
// (no bank conflict when a warp's lanes read their j-th columns).
template <int kCPL>
__device__ __forceinline__ int lane_major(int i) {
  const int ik = i % (32 * kCPL);
  return 4 * (i - ik + (ik % kCPL) * 32 + ik / kCPL);
}

// A DP row's -h kind (row-uniform): hp_col where the row starts a read run
// (its source the row before, staged now), hp_row on the run's later rows
// within the reach, when the run does not start at row 0; minus the
// discount of the run's length.
struct HpKind {
  bool col, row;
  int neg_pen;
};
__device__ __forceinline__ HpKind hp_kind(int hs, int slot, int row, const int32_t* pengop) {
  return {hs == row, hs != row && hs > 0 && row - hs < kHpw, -pengop[slot]};
}

// The columns that take the row's candidate, as 0x80 flags: their reference
// char is the read's (ch) and their flag of the row's kind is set.  Returns
// nonzero where any does.
template <int kCPL>
__device__ __forceinline__ uint32_t hp_hits(const HpCols<kCPL>& h, uint32_t ch, bool col,
                                            uint32_t (&hit)[HpCols<kCPL>::kW]) {
  const uint32_t ch4 = ch * 0x01010101u;
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < HpCols<kCPL>::kW; ++k) {
    hit[k] = zero_bytes(h.wchr[k] ^ ch4) & (col ? h.hcb[k] : h.hrb[k]);
    any |= hit[k];
  }
  return any;
}

// The row before a read run, staged lane-major from this thread's columns
// (P: that row) into its warp's part of the array at row.
template <int kCPL>
__device__ __forceinline__ void hp_stage(int32_t* row, const int (&P)[kCPL], int lane) {
#pragma unroll
  for (int j = 0; j < kCPL; ++j) row[j * 32 + lane] = P[j];
}

// A cell's base with the candidate joined where column j takes it.
template <int kW>
__device__ __forceinline__ int hp_take(int base, const uint32_t (&hit)[kW], int j, int cand) {
  const bool takes = hit[j >> 2] & (0x80u << (8 * (j & 3)));
  return max(base, takes ? cand : HIM);
}

}  // namespace band
