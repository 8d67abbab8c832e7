// Scorers of pass 1's WIDE rows on their band columns only (Hopper, sm_90a):
// the band forms of K1g (plain) and K4g (-h).
//
// Replaces, for a row whose band is narrow, the last DP row over the row's
// whole strand window and the argmax after it: without -h
// mia_tpu/ops/dp_pallas.py::_dp_kernel at full width (dp_jax.batch_last_row
// with dp_jax.batch_best_and_aec), under -h dp_jax.batch_last_row_hp with
// the window set-up of jax_engine._entries_core_hp.  (best, first window
// column of the best) leaves, which is what csrc/dp_last_row.cu (the full
// forms) and an argmax compute over the whole window.  The plain versions
// are mia_tpu_torch/ops/dp_torch.py::last_row_band_plain and
// last_row_hp_band_plain; each equals the full form's plain version bit for
// bit (int32, restart only on a strict >).  One source, one template: the
// plain instantiation (kHp = false) is the -h one without its candidates.
//
// What bounds it: the integer pipe's instructions per DP cell, as for
// csrc/dp_entries.cu, and before that the cells themselves.  A wide row's
// window spans up to a whole strand (17,408 columns), but its band, the
// union of its <= 16 intervals, is a few hundred columns: on the cells'
// wide rows 1-3% of the window's cells lie in a band, and the full form, at
// the batch's widest window, computes closed cells for the rest.  A closed
// cell never reaches the answer.  So this form computes the band's cells
// only:
//   * a row's band columns are its open columns and the two columns before
//     each run of them (at least 0), in order: then an open column's two left
//     neighbours are its left neighbours here too, and the diagonal, the row
//     gap, hp_row and the column gap's admission (origin c - 2 counts where
//     c is open) read the same columns as on the whole window.  A closed
//     neighbour keeps the value of a closed cell, below every live one, as on
//     the whole window; band column 2 admits band column 0 whatever its
//     state, as column 2 does column 0 (band column 0 is window column 0
//     whenever that is open);
//   * one warp a row, lane l owning band columns [12 l, 12 l + 12), 384 in
//     all (entries.BAND_COLS; 16 a lane would spill in the plain form's row
//     loop at 128 registers).  The recurrence and layout of dp_entries.cu
//     (two rows and the
//     row-gap max in registers, DPX add-max; under -h the lane-major staged
//     row and hp_col sources in shared memory, the straight-line cell
//     variants per kind of row), with two changes: the column-gap terms take
//     each column's real window column (GEP * column and the gap cost sit in
//     registers, not immediates), and a closed column is a sixth code of the
//     score table, (HIM, HIM), so no per-column mask register is kept;
//   * the prologue sorts the row's intervals by rank, joins them into runs,
//     and gives each lane the window column of each of its band columns; it
//     reads codes (-h: chars and run starts too) from the strand state at
//     win_lo + that column (past the state: code 4, char 0, run start 0);
//   * the PSSM depth of each DP row comes from the read's length
//     (find_sm_depth, src/pssm.c:36-46), as dp_torch.depths_for gives it;
//   * -h: hp_col's source, the column before the cell's reference run, may
//     lie in any lane or interval: the prologue finds its band column, and a
//     source that is not open gives no candidate (on the whole window its
//     value is HIM, below the restart);
//   * a row whose band takes more columns than its form's is left to the
//     full form by the host (entries.wide_rows); given one anyway, the
//     kernel writes (HIM, -1), which the host refuses.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

// Duplicates of the Python side's values (entries.BAND_COLS, MAX_INTERVALS,
// L_MAX, HPW_ROUTE, mia_tpu_torch.constants, dp_torch._LOW);
// mia_dp_band_constants and mia_dp_band_hp_constants export them so that
// the loader (torchcfg.kernel_library) refuses a library that disagrees.
constexpr int kCPL = 12;              // band columns per lane
constexpr int kBand = 32 * kCPL;      // band columns a row
constexpr int kK = 16;                // intervals a row
constexpr int kLMax = 256;            // read rows
constexpr int kWarps = 8;             // rows per block
constexpr int kPssmDepth = 15;
constexpr int kDepth = 2 * kPssmDepth + 1;
constexpr int kCodes = 6;             // reference codes 0..4, and 5: a closed column
constexpr int kHpw = 32;              // -h row reach
constexpr int kPengop = 11;           // -h gap-open discounts
constexpr int GOP = 1000;
constexpr int GEP = 200;
constexpr int HIM = -1073741824;                 // INT_MIN / 2
constexpr int LOW = -(1 << 30) - (1 << 29);      // below any live value
constexpr int kGate = -(1 << 29);    // addend that sinks a value below every live one
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int8_t* refs;      // [2, wtot] codes
  const uint8_t* refchr;   // -h: [2, wtot] chars
  const int32_t* hpcs;     // -h: [2, wtot] global run start per column
  int wtot;
  const int8_t* strand;    // [B]
  const int32_t* win_lo;   // [B] global column of window column 0
  const int32_t* ivl;      // [B, kK, 2] window-local [lo, hi)
  const uint8_t* s2chr;    // -h: [B, L] read chars, pad 0
  int L;
  const int32_t* lengths;  // [B]
  const int32_t* submat;   // [31, 5, 5]
  const int32_t* pengop;   // -h: [kPengop]
  const int8_t* b2i;       // -h: [256]
  int B;
  int32_t* out;            // out[b]: best, out[ldo + b]: its window column
  int ldo;
  const int32_t* s2c;      // plain: [B, L] read codes, pad 4
};

// Per-block shared memory of the -h instantiation only: its tables, and
// its per-row arrays.
template <bool kHp>
struct HpTables {
  int32_t pengop[kPengop];
  int8_t b2i[256];
};
template <>
struct HpTables<false> {};

template <bool kHp>
struct HpRows {
  uint8_t hprs[kWarps][kLMax];    // start row of the read run holding each row
  uint8_t pidx[kWarps][kLMax];    // min(run length - 1, 10): pengop slot
  // lane-major, as in dp_entries.cu: band column 12 l + j at j * 32 + l
  uint16_t hsrc[kWarps][kBand];   // hp_col: byte offset of the source column in row[]
  int32_t hneg[kWarps][kBand];    // hp_col: minus the distance cost to that column
  int32_t row[kWarps][kBand];     // the row before the current read run, staged
};
template <>
struct HpRows<false> {};

template <bool kHp>
struct Shared {
  // per depth and read code, per reference code: (score where the cell
  // keeps its base, addend where it restarts); code 5: (HIM, HIM)
  int2 tab[kDepth * 5 * kCodes];
  HpTables<kHp> ht;
  uint8_t chr[kWarps][kLMax];     // read chars (-h) or codes 0..4
  HpRows<kHp> hp;
  // the row's valid intervals sorted by start, and the band's runs: the
  // first window column and first band column of each, and its columns
  int32_t lo[kWarps][kK], hi[kWarps][kK];
  int32_t seg_col[kWarps][kK], seg_at[kWarps][kK], seg_n[kWarps][kK];
};

// Bit 7 of every byte of x says whether the byte is zero.
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x);
}

template <bool kHp>
__global__ void __launch_bounds__(kWarps * 32, 2) dp_band_kernel(Args a) {
  __shared__ Shared<kHp> sh;
  for (int i = threadIdx.x; i < kDepth * 5 * kCodes; i += blockDim.x) {
    const int w = i % kCodes, x = (i / kCodes) % 5, d = i / (kCodes * 5);
    sh.tab[i] = w < 5 ? make_int2(a.submat[(d * 5 + w) * 5 + x], 0) : make_int2(HIM, HIM);
  }
  if constexpr (kHp) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sh.ht.b2i[i] = a.b2i[i];
    if (threadIdx.x < kPengop) sh.ht.pengop[threadIdx.x] = a.pengop[threadIdx.x];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= a.B) return;  // whole warp leaves together; no block barrier follows
  const int L = a.L;

  // ---- the band: intervals sorted by rank, then joined into runs ---------
  int lo = 0, hi = 0;
  if (lane < kK) {
    lo = a.ivl[((int64_t)e * kK + lane) * 2];
    hi = a.ivl[((int64_t)e * kK + lane) * 2 + 1];
  }
  const unsigned valid = __ballot_sync(FULL, lane < kK && lo < hi);
  const int n = __popc(valid);
  {
    int rank = 0;
    for (int i = 0; i < kK; ++i) {
      const int olo = __shfl_sync(FULL, lo, i);
      rank += ((valid >> i) & 1) && (olo < lo || (olo == lo && i < lane));
    }
    if ((valid >> lane) & 1) {
      sh.lo[warp][rank] = lo;
      sh.hi[warp][rank] = hi;
    }
  }
  __syncwarp();
  // lane i < n: sorted interval i adds the band columns [start, hi) past
  // every earlier interval's end
  int nband;
  {
    const int my_lo = lane < n ? sh.lo[warp][lane] : 0;
    const int my_hi = lane < n ? sh.hi[warp][lane] : 0;
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
      sh.seg_col[warp][lane] = start;
      sh.seg_at[warp][lane] = at - cnt;
      sh.seg_n[warp][lane] = cnt;
    }
  }
  if (nband > kBand) {
    if (lane == 0) {
      a.out[e] = HIM;
      a.out[a.ldo + e] = -1;
    }
    return;
  }

  // ---- read chars (-h) or codes, and -h's read runs -----------------------
  for (int r = lane; r < L; r += 32) {
    if constexpr (kHp) {
      sh.chr[warp][r] = a.s2chr[(int64_t)e * L + r];
    } else {
      const int x = a.s2c[(int64_t)e * L + r];
      sh.chr[warp][r] = (uint8_t)(x < 0 ? 0 : (x > 4 ? 4 : x));
    }
  }
  __syncwarp();
  if constexpr (kHp) {
    // dp_entries.cu's ballots: the nearest run start at or before each row,
    // the nearest run end at or after it
    int carry = 0;
    for (int base = 0; base < L; base += 32) {
      const int r = base + lane;
      const bool changed = r >= L || r == 0 || sh.chr[warp][r] != sh.chr[warp][r - 1];
      const unsigned m = __ballot_sync(FULL, changed) & (FULL >> (31 - lane));
      const int hs = m ? base + 31 - __clz(m) : carry;
      if (r < L) sh.hp.hprs[warp][r] = (uint8_t)hs;
      carry = __shfl_sync(FULL, hs, 31);
    }
    carry = L - 1;
    for (int base = ((L - 1) / 32) * 32; base >= 0; base -= 32) {
      const int r = base + lane;
      const bool ends = r >= L - 1 || sh.chr[warp][r + 1] != sh.chr[warp][r];
      const unsigned m = __ballot_sync(FULL, ends) & (FULL << lane);
      const int he = m ? base + __ffs(m) - 1 : carry;
      if (r < L) {
        const int run = he - sh.hp.hprs[warp][r] + 1;
        sh.hp.pidx[warp][r] = (uint8_t)(run < 1 ? 0 : (run > kPengop ? kPengop - 1 : run - 1));
      }
      carry = __shfl_sync(FULL, he, 0);
    }
    __syncwarp();
  }

  // ---- this lane's band columns --------------------------------------------
  auto is_open = [&](int c) {
    bool o = false;
    for (int i = 0; i < n; ++i) o |= sh.lo[warp][i] <= c && c < sh.hi[warp][i];
    return o;
  };
  const int len = a.lengths[e];
  int last = len - 1;  // a last row outside [0, L) keeps row 0
  if (last < 0 || last >= L) last = 0;
  const int wlo = a.win_lo[e];
  const int64_t sbase = (int64_t)a.strand[e] * a.wtot;
  const int k0 = lane * kCPL;

  int woff[kCPL];   // byte offset of the column's code in a table row
  int gadd[kCPL];   // what the column adds as a column-gap origin: GEP * its
                 // window column, or kGate where it may not count
  int ncost[kCPL];  // minus the column gap's cost into it: GOP + GEP * (column - 1)
  // -h: window chars (4 per word) and, as 0x80 flags in the same layout,
  // the columns that start a reference run and those with an hp_col source
  uint32_t wchr[kCPL / 4], hrb[kCPL / 4], hcb[kCPL / 4];
  unsigned mbits = 0;
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    const int k = k0 + j;
    // the window column: in the run holding band column k, or past the
    // band, continuing after its last column
    int c = 0;
    for (int i = 0; i < n; ++i)
      if (sh.seg_n[warp][i] > 0 && sh.seg_at[warp][i] <= k)
        c = sh.seg_col[warp][i] + k - sh.seg_at[warp][i];
    const bool inband = k < nband;
    const bool open = inband && is_open(c);
    mbits |= (unsigned)open << j;
    const int g = wlo + c;
    const bool in = inband && g < a.wtot;
    const int code = in ? a.refs[sbase + g] : 4;
    woff[j] = 8 * (open ? (code < 0 ? 0 : (code > 4 ? 4 : code)) : 5);
    gadd[j] = GEP * c;
    ncost[j] = -(GOP + GEP * (c - 1));
    if constexpr (kHp) {
      const uint32_t ch = in ? a.refchr[sbase + g] : 0;
      if ((j & 3) == 0) wchr[j >> 2] = hrb[j >> 2] = hcb[j >> 2] = 0;
      wchr[j >> 2] |= ch << (8 * (j & 3));
      const int hc = in ? a.hpcs[sbase + g] : 0;
      const uint32_t flag = 0x80u << (8 * (j & 3));
      if (open && c >= 1 && hc == g) hrb[j >> 2] |= flag;
      // hp_col: the source column's band column, where it is open
      int src = 0;
      if (open && c >= 1 && hc != g && hc > 0 && hc - 1 >= wlo && is_open(hc - 1 - wlo)) {
        const int s = hc - 1 - wlo;
        for (int i = 0; i < n; ++i) {
          const int s0 = sh.seg_col[warp][i];
          if (s0 <= s && s < s0 + sh.seg_n[warp][i]) src = sh.seg_at[warp][i] + s - s0;
        }
        hcb[j >> 2] |= flag;
      }
      sh.hp.hsrc[warp][j * 32 + lane] = (uint16_t)(4 * ((src % kCPL) * 32 + src / kCPL));
      sh.hp.hneg[warp][j * 32 + lane] = -GEP * (g - hc);
    }
  }
  // origin k counts where band column k + 2 is open; band column 0 always
  unsigned nbits = __shfl_down_sync(FULL, mbits, 1);
  if (lane == 31) nbits = 0;
  const unsigned cand_ok = ((mbits | (nbits << kCPL)) >> 2) | (lane == 0 ? 1u : 0u);
#pragma unroll
  for (int j = 0; j < kCPL; ++j)
    if (!((cand_ok >> j) & 1u)) gadd[j] = kGate;
  __syncwarp();

  // ---- row 0 -------------------------------------------------------------
  auto trow_of = [&](int row) {
    const int from_back = len - (row + 1);
    int d = row < kPssmDepth ? row
                             : (from_back < kPssmDepth ? 2 * kPssmDepth - from_back : kPssmDepth);
    d = d < 0 ? 0 : (d > 2 * kPssmDepth ? 2 * kPssmDepth : d);
    int x = sh.chr[warp][row];
    if constexpr (kHp) {
      x = sh.ht.b2i[x];
      x = x < 0 ? 0 : (x > 4 ? 4 : x);
    }
    return (const char*)(sh.tab + (d * 5 + x) * kCodes);
  };
  int prev[kCPL], prev2[kCPL], rbest[kCPL];
  {
    const char* trow = trow_of(0);
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      prev[j] = ((const int2*)(trow + woff[j]))->x;
      prev2[j] = LOW;
      rbest[j] = prev[j];
    }
  }

  // ---- rows 1 .. last ----------------------------------------------------
  // One row: P holds row - 1, Q row - 2; the new row replaces Q.
  auto do_row = [&](const int row, int (&P)[kCPL], int (&Q)[kCPL]) {
    const char* trow = trow_of(row);
    const int start_new = -(GOP + GEP * (row + 1));
    // no row gap ends on row 1: its cost there sinks the candidate
    const int neg_grow = row >= 2 ? -(GOP + GEP * (row - 1)) : kGate;

    // -h: which candidate this row may take (warp-uniform), and the
    // columns that take it as 0x80 flags
    bool hp_col_row = false, hp_row_row = false;
    int neg_pen = 0;
    uint32_t hit[kCPL / 4];
    if constexpr (kHp) {
      const int hs = sh.hp.hprs[warp][row];
      const int slot = sh.hp.pidx[warp][row];
      hp_col_row = hs == row;
      hp_row_row = hs != row && hs > 0 && row - hs < kHpw;
      neg_pen = -sh.ht.pengop[slot];
      const uint32_t ch4 = sh.chr[warp][row] * 0x01010101u;
      uint32_t any = 0;
#pragma unroll
      for (int k = 0; k < kCPL / 4; ++k) {
        hit[k] = zero_bytes(wchr[k] ^ ch4) & (hp_col_row ? hcb[k] : hrb[k]);
        any |= hit[k];
      }
      // the row before this run: hp_col's source now, hp_row's on the
      // run's later rows
      if (hp_col_row && (slot > 0 || __any_sync(FULL, any != 0))) {
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kCPL; ++j) sh.hp.row[warp][j * 32 + lane] = P[j];
        __syncwarp();
      }
    }

    // column gaps: inclusive prefix max of prev[c] + GEP * column over the
    // origins that count
    int rl[kCPL];
    int run = LOW;
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      run = __viaddmax_s32(P[j], gadd[j], run);
      rl[j] = run;
    }
    int tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      tot = max(tot, __shfl_up_sync(FULL, tot, off));  // a lane below off reads itself
    int excl = __shfl_up_sync(FULL, tot, 1);
    if (lane == 0) excl = LOW;
    // the prefix two columns back of this lane's first column
    int pre_m2 = __shfl_up_sync(FULL, max(rl[kCPL - 2], excl), 1);

    // row gaps: running per-column max over rows <= row - 2
    const int add = GEP * (row - 2);
#pragma unroll
    for (int j = 0; j < kCPL; ++j) rbest[j] = __viaddmax_s32(Q[j], add, rbest[j]);

    // previous lane's last column for the shifted reads; band column 0 has
    // no neighbours: its base is the restart value itself
    int rb_m1 = __shfl_up_sync(FULL, rbest[kCPL - 1], 1);
    int pv_m1 = __shfl_up_sync(FULL, P[kCPL - 1], 1);
    if (lane == 0) {
      pre_m2 = LOW;
      rb_m1 = HIM;
      pv_m1 = start_new;
    }

    // The cells, in one straight-line variant per kind of row (0: no -h
    // candidate, 1: hp_col, 2: hp_row), picked by a warp-uniform branch.
    // The -h arrays come in as a parameter, so that the plain
    // instantiation, which has none, does not look their members up.
    auto cells = [&](auto kind, auto& hs) {
      constexpr int kKind = decltype(kind)::value;
#pragma unroll
      for (int j = 0; j < kCPL; ++j) {
        // gap_col = prefix[c - 2] - (GOP + GEP * (c - 1))
        const int pre = j >= 2 ? max(rl[j - 2], excl) : (j == 1 ? excl : pre_m2);
        const int diag = j >= 1 ? P[j - 1] : pv_m1;
        int base = __viaddmax_s32(pre, ncost[j], diag);
        base = __viaddmax_s32(j >= 1 ? rbest[j - 1] : rb_m1, neg_grow, base);
        if constexpr (kHp && kKind != 0) {
          const bool takes = hit[j >> 2] & (0x80u << (8 * (j & 3)));
          int cand;
          if constexpr (kKind == 1) {
            const int src = *(const int32_t*)((const char*)hs.row[warp] +
                                              hs.hsrc[warp][j * 32 + lane]);
            cand = src + hs.hneg[warp][j * 32 + lane] + neg_pen;
          } else {
            // the column to the left; band column 0 takes none: lane 0
            // reads some column of its own instead
            cand = hs.row[warp][j >= 1 ? (j - 1) * 32 + lane
                                       : (kCPL - 1) * 32 + lane - (lane != 0)] + neg_pen;
          }
          base = max(base, takes ? cand : HIM);
        }
        const int2 cell = *(const int2*)(trow + woff[j]);
        bool keeps;  // base >= start_new: no restart
        const int m = __vibmax_s32(base, start_new, &keeps);
        Q[j] = m + (keeps ? cell.x : cell.y);
      }
    };
    if constexpr (kHp) {
#ifdef MIA_BAND_HP_KIND
      // every row of one kind, for counting that kind's instructions alone
      // (python -m mia_tpu_torch.utils.sass -D MIA_BAND_HP_KIND=k); wrong scores
      cells(std::integral_constant<int, MIA_BAND_HP_KIND>{}, sh.hp);
#else
      if (hp_col_row) cells(std::integral_constant<int, 1>{}, sh.hp);
      else if (hp_row_row) cells(std::integral_constant<int, 2>{}, sh.hp);
      else cells(std::integral_constant<int, 0>{}, sh.hp);
#endif
    } else {
      cells(std::integral_constant<int, 0>{}, sh.hp);
    }
  };

  int row = 1;
  for (; row + 1 <= last; row += 2) {
    do_row(row, prev, prev2);
    do_row(row + 1, prev2, prev);
  }
  if (row <= last) {
    do_row(row, prev, prev2);
#pragma unroll
    for (int j = 0; j < kCPL; ++j) prev[j] = prev2[j];
  }

  // ---- the best value and its first window column --------------------------
  // A closed column ranks as (HIM, column 0): with no open column the answer
  // is the whole window's, (HIM, 0); an open one is always above HIM.
  int bv = INT32_MIN, bc = 0;
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    const bool open = (mbits >> j) & 1u;
    const int v = open ? prev[j] : HIM;
    const int c = open ? (-ncost[j] - GOP) / GEP + 1 : 0;
    if (v > bv || (v == bv && c < bc)) {
      bv = v;
      bc = c;
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, bv, off);
    const int oc = __shfl_xor_sync(FULL, bc, off);
    if (ov > bv || (ov == bv && oc < bc)) {
      bv = ov;
      bc = oc;
    }
  }
  if (lane == 0) {
    a.out[e] = bv;
    a.out[a.ldo + e] = bc;
  }
}

template <bool kHp>
int launch(const Args& a, void* stream) {
  if (a.B <= 0) return 0;
  if (a.L < 1 || a.L > kLMax || a.ldo < a.B) return (int)cudaErrorInvalidValue;
  dp_band_kernel<kHp><<<(a.B + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int fill(const int32_t* c, int count, int32_t* out, int n) {
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}

}  // namespace

// (best, first window column of the best) of each row's last -h DP row, its
// band columns scored only: out[b] and out[ldo + b] (ldo >= B), int32.
// refs [2, wtot] int8 codes, refchr [2, wtot] uint8 chars, hpcs [2, wtot]
// int32 run starts (the scorer's state); strand [B] int8, win_lo [B] int32,
// ivl [B, 16, 2] int32 window-local intervals (0 <= lo, hi <= 17,408),
// s2chr [B, L] uint8 read chars (pad 0), lengths [B] int32; submat
// [31, 5, 5] int32, pengop [11] int32, b2i [256] int8.  L at most 256.
extern "C" int mia_dp_band_hp(const void* refs, const void* refchr, const void* hpcs,
                              int wtot, const void* strand, const void* win_lo,
                              const void* ivl, const void* s2chr, const void* lengths,
                              const void* submat, const void* pengop, const void* b2i,
                              int B, int L, void* out, int ldo, void* stream) {
  const Args a{(const int8_t*)refs,     (const uint8_t*)refchr, (const int32_t*)hpcs,
               wtot,                    (const int8_t*)strand,  (const int32_t*)win_lo,
               (const int32_t*)ivl,     (const uint8_t*)s2chr,  L,
               (const int32_t*)lengths, (const int32_t*)submat, (const int32_t*)pengop,
               (const int8_t*)b2i,      B,                      (int32_t*)out,
               ldo,                     nullptr};
  return launch<true>(a, stream);
}

// The same without -h: (best, first window column of the best) of each
// row's last DP row (sg5 on, the one PSSM submat for every row), its band
// columns scored only.  refs [2, wtot] int8 codes; strand [B] int8, win_lo
// [B] int32, ivl [B, 16, 2] int32 window-local intervals, s2c [B, L] int32
// read codes (pad 4), lengths [B] int32; submat [31, 5, 5] int32.  L at
// most 256.
extern "C" int mia_dp_band(const void* refs, int wtot, const void* strand,
                           const void* win_lo, const void* ivl, const void* s2c,
                           const void* lengths, const void* submat, int B, int L,
                           void* out, int ldo, void* stream) {
  const Args a{(const int8_t*)refs,     nullptr,                nullptr,
               wtot,                    (const int8_t*)strand,  (const int32_t*)win_lo,
               (const int32_t*)ivl,     nullptr,                L,
               (const int32_t*)lengths, (const int32_t*)submat, nullptr,
               nullptr,                 B,                      (int32_t*)out,
               ldo,                     (const int32_t*)s2c};
  return launch<false>(a, stream);
}

// The compile-time constants of the -h form, in this order: band columns a
// row, intervals a row, read rows, PSSM depth slots, GOP, GEP, HIM, LOW, -h
// row reach, -h discount slots.  Fills at most n values of out; returns how
// many there are.
extern "C" int mia_dp_band_hp_constants(int32_t* out, int n) {
  const int32_t c[] = {kBand, kK, kLMax, kDepth, GOP, GEP, HIM, LOW, kHpw, kPengop};
  return fill(c, (int)(sizeof(c) / sizeof(c[0])), out, n);
}

// The same for the plain form: band columns a row, intervals a row, read
// rows, PSSM depth slots, PSSM depth, GOP, GEP, HIM, LOW.
extern "C" int mia_dp_band_constants(int32_t* out, int n) {
  const int32_t c[] = {kBand, kK, kLMax, kDepth, kPssmDepth, GOP, GEP, HIM, LOW};
  return fill(c, (int)(sizeof(c) / sizeof(c[0])), out, n);
}
