// General-width semi-global DP scorer: the whole last row per read
// (Hopper, sm_90a).
//
// Replaces the general form of mia_tpu/ops/dp_pallas.py::_dp_kernel
// (launched by pallas_last_row) and its XLA twin
// mia_tpu/ops/dp_jax.py::batch_last_row: any reference width W, a reference
// row shared by the batch or one per read, and the DP row at each read's
// last row [B, W] as the result (csrc/dp_entries.cu is the same recurrence
// specialised to 384-column windows with (best, aec) out).  Integer
// semantics are those of mia_tpu_torch/ops/dp_torch.py::batch_last_row
// (int32, HIM in masked columns, LOW below every live value, restart only on
// a strict >), so the rows agree bit for bit, sentinels included.
//
// What bounds it: the integer pipe's instructions per DP cell, not bytes (a
// read moves 5 W bytes in and 4 W bytes out once, a cell is three gap
// candidates, a 3-way max, a restart test and a score lookup), and, because
// a row of 17,024 columns is far wider than a warp, one block-wide exchange
// per row.  Two forms, chosen by the wrapper from W alone:
//
// The register form (W <= 512 x 34 = 17,408), one block per read:
//   * thread t owns the 34 consecutive columns from 34 t and keeps the
//     current row and the running row-gap max for them in registers (68 of
//     its 128; 512 threads fill an SM's register file, so it is one block an
//     SM).  There is no row before last: the row-gap max takes a row in as
//     soon as it is written, one row early, which only adds a candidate
//     that the diagonal beats by GOP;
//   * one pass and one barrier a row.  While a thread writes the new row
//     over the old one it also takes the new row's column-gap prefix max
//     over its own columns; a shuffle scan joins the warp's totals, lane 31
//     leaves the warp's total and the three values the next warp's first
//     thread needs in one of two 16-byte slots per warp (by row parity),
//     and after the barrier every warp scans the 16 warp totals again: that
//     is the whole exchange;
//   * the column-gap prefix runs in thread-local coordinates (GEP * j is an
//     immediate, and so is every gap cost); an origin c may count only where
//     column c + 2 is open, which is the open bit of the cell that takes it
//     in, a predicate from a 36-bit register mask;
//   * Hopper's DPX instructions (__viaddmax_s32, __vibmax_s32) do every add
//     with its max in one instruction;
//   * the score of a cell is one 8-byte shared-memory load from a per-read
//     table [row][6] of (score if the cell keeps its base, addend if it
//     restarts), built in the prologue (12 KB at 256 rows); a column's code
//     stays a byte offset, four to a register, and a closed column is a
//     sixth code whose entry is (HIM, HIM).  So the band mask is folded into
//     the data: a closed cell is HIM plus a value of live size, below every
//     live value and above INT_MIN (HIM = -2^30 and LOW = -1.5 * 2^30 leave
//     2^29 of room for GEP * W), a restart always beats it, and the exact
//     HIM is restored in the row that is written out;
//   * column 0 (always cell + restart) is thread 0's diagonal input set to
//     the restart value, row 1 (no row gap yet) a gap cost of -2^29;
//   * a read is a block's whole work and reads differ in rows, so a batch
//     of a few reads an SM ends ragged (20% at 512 reads of 30-119 rows on
//     132 SMs).  Blocks start in the order of their index: block i takes
//     the read with the i-th most rows (a histogram of the row counts in
//     shared memory, then a count of the reads of that length before it),
//     which is the longest-first rule and leaves 3%.
//
// On an H100 80GB HBM3 at 700 W, B = 512 reads of 30-119 bases against
// W = 17,024 columns (645M cells) take 0.78 ms with a shared reference and
// 0.80 ms with one per read (chip_smoke.py; 0.85 in index order), 69% of the
// bound of 14 integer operations a cell, against 2.65-2.73 ms for the wide
// form.  The row loop is 751 machine instructions for 34 cells, 22.1 a cell,
// about half of them on the integer pipe (59.75 a cell in the wide form's two
// passes; python -m mia_tpu_torch.utils.sass); 128 registers, and 172 bytes
// of stack for table offsets that the compiler unpacks ahead of the row loop
// (unpacking them inside it, one PRMT a cell, was 4% slower).
//
// The wide form (any W past that), today only met in tests: rows in shared
// memory while 13 W bytes fit (W <= 17.8k), else in a scratch buffer in
// global memory; two passes and two barriers a row.  It is the kernel this
// file held before the register form, unchanged.
//
// The kHp instantiation of the register form (mia_dp_last_row_hp) replaces
// mia_tpu/ops/dp_jax.py::batch_last_row_hp at full width, with the window
// set-up of jax_engine._entries_core_hp done inside it: pass 1's -h WIDE
// reads, one row per (read, strand with intervals).  A row reads its window
// of the scorer's [2, WTOT] strand codes, chars and run starts itself, makes
// its band from its intervals, its codes and depths from its read chars and
// length, and only (best, first column of the best) leaves the block; the
// plain version is mia_tpu_torch/ops/dp_torch.py::last_row_hp_plain.  What
// -h adds (src/mia.c:883-905):
//   * hp_col, on the first row of a read run: the previous row at the column
//     before the cell's reference run, which may lie in any thread, and
//     hp_row, on the run's later rows: the row before the run at the column
//     to the left.  Both read the same row, the one before the run started,
//     so it is staged in shared memory on every run start (17,408 columns,
//     68 KB), in one of two buffers by turns, so that a thread can stage the
//     next run's row while its neighbours still read the last one's: no
//     barrier beyond the row's one.  The TPU's ring of 32 rows is not kept;
//     its reach stays as a guard (row - run start < 32), as in dp_entries.cu;
//   * per column one word in shared memory (68 KB): the reference char, and
//     whether and from where the column takes a candidate.  Registers have
//     no room for them: the plain form already holds 128.  A row's kind
//     (none, hp_col, hp_row) is the same for the block, so each kind is its
//     own straight-line variant of the cell loop;
//   * a candidate joins the cell's max like the gap candidates, which keeps
//     the row-gap max's one-row-early shortcut exact (the diagonal still
//     beats the extra candidate by GOP); one from a closed column is as low
//     as every value from a closed cell, below the restart value;
//   * the row's window is the batch's widest, W, and a narrower row's
//     columns past its own intervals are closed: it costs their cells, and
//     no read of the strand state goes past it (columns past WTOT read code
//     4, char 0, run start 0, as the plain version pads them).
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

// Duplicates of the Python side's values (mia_tpu_torch.constants,
// dp_torch._LOW, dp_cuda.LAST_ROW_*); mia_dp_last_row_constants exports
// them so that the loader refuses a library that disagrees.
constexpr int GOP = 1000;
constexpr int GEP = 200;
constexpr int HIM = -1073741824;             // INT_MIN / 2
constexpr int LOW = -(1 << 30) - (1 << 29);  // below any live value
constexpr int kGate = -(1 << 29);            // addend that sinks a value below every live one
constexpr int kDepth = 31;                   // PSSM depth slots
constexpr int kLMax = 256;                   // read rows
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 227 * 1024 - 1024;  // dynamic bytes a block may ask for here
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_scan_max(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = max(v, t);
  }
  return v;
}

// ---- the register form ------------------------------------------------------

constexpr int kCols = 34;          // columns per thread
constexpr int kRegThreads = 512;   // threads per block, at most
constexpr int kCodes = 6;          // reference codes 0..4, and 5: a closed column
constexpr int kRowBytes = kCodes * 8;
constexpr int kCodeWords = (kCols + 3) / 4;

// The kHp form (-h): intervals a row, the row reach of a read run, the
// discount slots, and the flags of a column's word (bits 0-15: hp_col's
// source column, bits 24-31: the reference char).
constexpr int kPssmDepth = (kDepth - 1) / 2;
constexpr int kK = 16;             // entries.MAX_INTERVALS
constexpr int kHpw = 32;           // entries.HPW_ROUTE
constexpr int kPengop = 11;        // entries.hp_pengop_table()
constexpr uint32_t kHcOk = 1u << 16;  // hp_col: the reference run starts inside the window
constexpr uint32_t kHrOk = 1u << 17;  // hp_row: the column starts a reference run (not column 0)

// The kHp form's inputs: the scorer's [2, WTOT] strand state, and per row
// its strand, window start, window-local intervals and read chars.
struct HpArgs {
  const int8_t* refs;      // [2, wtot] codes
  const uint8_t* refchr;   // [2, wtot] chars
  const int32_t* hpcs;     // [2, wtot] global run start per column (<= the column)
  int wtot;
  const int8_t* strand;    // [B]
  const int32_t* win_lo;   // [B] global column of the row's column 0
  const int32_t* ivl;      // [B, kK, 2] window-local [lo, hi), lo <= hi
  const uint8_t* s2chr;    // [B, L] read chars, pad 0
  const int32_t* pengop;   // [kPengop]
  const int8_t* b2i;       // [256] char -> code
};

// Shared memory of the kHp form only: each read row's char, the row its
// read run starts on and its discount slot; one (best, column) a warp.
template <bool kHp>
struct HpRows {
  uint8_t chr[kLMax], hprs[kLMax], pidx[kLMax];
  int pengop[kPengop];
  int2 best[32];
};
template <>
struct HpRows<false> {};

template <int k>
using Kind = std::integral_constant<int, k>;

template <bool kHp>
__global__ void __launch_bounds__(kRegThreads, 1)
dp_last_row_kernel(const int32_t* __restrict__ s1c, int s1c_per_read,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ s2c,
                   const int32_t* __restrict__ depths,
                   const int32_t* __restrict__ submat,
                   const int32_t* __restrict__ lengths, int B, int W, int L, int sg5,
                   int ranked, HpArgs hp, int32_t* __restrict__ out) {
  // per row and code: (score where the cell keeps its base, addend where it
  // restarts); code 5, a closed column: (HIM, HIM)
  __shared__ int2 sh_tab[kLMax * kCodes];
  // per row parity and warp: the warp's prefix-max total, the same without
  // its last thread's last column, and that column's row value and row-gap max
  __shared__ int4 sh_edge[2][32];
  __shared__ int sh_hist[kLMax], sh_warp[32], sh_pick[2];
  __shared__ HpRows<kHp> sh_hp;
  // kHp: two staged rows of blockDim.x * kCols columns, then a word a column
  extern __shared__ int32_t dyn[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // a read's last row; one outside [0, L) keeps row 0 (the plain version's
  // loop never reaches its snapshot row)
  auto last_of = [&](int r) {
    const int l = lengths[r] - 1;
    return l < 0 || l >= L ? 0 : l;
  };
  int b = blockIdx.x;
  if (ranked) {
    // block i takes the read with the i-th most rows (ties: the lower index)
    for (int i = tid; i < kLMax; i += blockDim.x) sh_hist[i] = 0;
    __syncthreads();
    for (int r = tid; r < B; r += blockDim.x) atomicAdd(&sh_hist[last_of(r)], 1);
    __syncthreads();
    if (warp == 0) {
      // lane i holds the 8 bins from kLMax - 1 - 8 i down; the lane whose
      // running total passes the block's rank walks its bins
      int mine = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) mine += sh_hist[kLMax - 1 - 8 * lane - i];
      int upto = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, upto, off);
        if (lane >= off) upto += t;
      }
      if (b >= upto - mine && b < upto) {
        int k = b - (upto - mine), l = kLMax - 1 - 8 * lane;
        while (k >= sh_hist[l]) k -= sh_hist[l--];
        sh_pick[0] = l;
        sh_pick[1] = k;
      }
    }
    __syncthreads();
    const int want = sh_pick[0];
    int k = sh_pick[1];  // the read is the k-th of its row count, by index
    for (int r0 = 0; r0 < B; r0 += blockDim.x) {
      const int r = r0 + tid;
      const bool hit = r < B && last_of(r) == want;
      const unsigned hits = __ballot_sync(FULL, hit);
      if (lane == 0) sh_warp[warp] = __popc(hits);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < nwarps; ++w) {
        before += w < warp ? sh_warp[w] : 0;
        total += sh_warp[w];
      }
      if (hit && before + __popc(hits & ((1u << lane) - 1)) == k) sh_pick[0] = r;
      __syncthreads();
      if (k < total) break;
      k -= total;
    }
    b = sh_pick[0];
  }
  const int c0 = tid * kCols;
  const int goff = GEP * c0;  // thread-local column-gap coordinates to the row's
  const int last = last_of(b);
  const int wp = blockDim.x * kCols;  // kHp: the columns of a staged row
  int32_t* stage = dyn;
  uint32_t* colw = (uint32_t*)(dyn + 2 * wp);

  if constexpr (kHp) {
    // read runs (dp_torch.read_runs) over all L rows: a row's run starts
    // after the last row before it with another char, and ends before the
    // first row after it with another char
    for (int r = tid; r < L; r += blockDim.x) sh_hp.chr[r] = hp.s2chr[(int64_t)b * L + r];
    if (tid < kPengop) sh_hp.pengop[tid] = hp.pengop[tid];
    __syncthreads();
    for (int r = tid; r < L; r += blockDim.x) {
      const uint8_t ch = sh_hp.chr[r];
      int hs = r, he = r;
      while (hs > 0 && sh_hp.chr[hs - 1] == ch) --hs;
      while (he + 1 < L && sh_hp.chr[he + 1] == ch) ++he;
      sh_hp.hprs[r] = (uint8_t)hs;
      sh_hp.pidx[r] = (uint8_t)min(he - hs, kPengop - 1);
    }
  }
  for (int r = tid; r <= last; r += blockDim.x) {
    int d, x;
    if constexpr (kHp) {
      // the row's PSSM depth (dp_torch.depths_for) and its char's code
      const int from_back = lengths[b] - (r + 1);
      d = r < kPssmDepth ? r
                         : (from_back < kPssmDepth ? 2 * kPssmDepth - from_back : kPssmDepth);
      x = hp.b2i[hp.s2chr[(int64_t)b * L + r]];
    } else {
      const int64_t at = (int64_t)b * L + r;
      d = depths[at];
      x = s2c[at];
    }
    d = d < 0 ? 0 : (d > kDepth - 1 ? kDepth - 1 : d);
    x = x < 0 ? 0 : (x > 4 ? 4 : x);
    const int32_t* p = submat + d * 25 + x;
#pragma unroll
    for (int code = 0; code < 5; ++code) sh_tab[r * kCodes + code] = make_int2(p[5 * code], 0);
    sh_tab[r * kCodes + 5] = make_int2(HIM, HIM);
  }

  // kHp: the row's window of its strand.  Columns past the strand state
  // read code 4, char 0 and run start 0, as the plain version pads them;
  // the band is the union of the row's intervals (36 bits: this thread's
  // columns and the next thread's first two).
  const int wlo = kHp ? hp.win_lo[b] : 0;
  const int64_t sbase = kHp ? (int64_t)hp.strand[b] * hp.wtot : 0;
  uint64_t band = 0;
  if constexpr (kHp) {
    const int32_t* iv = hp.ivl + (int64_t)b * kK * 2;
    for (int k = 0; k < kK; ++k) {
      const int lo = max(iv[2 * k], c0), hi = min(min(iv[2 * k + 1], W), c0 + kCols + 2);
      if (lo < hi) band |= ((1ull << (hi - lo)) - 1) << (lo - c0);
    }
  }
  const int32_t* ref = kHp ? nullptr : s1c + (s1c_per_read ? (int64_t)b * W : 0);
  const uint8_t* mk = kHp ? nullptr : mask + (int64_t)b * W;

  // A column's code as the byte offset of its entry in a table row, four to
  // a word; bit j of `admit`: cell j takes origin j - 2 into the column-gap
  // prefix (column c0 + j is open, or it is column 2: origin 0 always
  // counts).  Bits 34 and 35 are the next thread's first two cells.
  uint32_t cw[kCodeWords];
  uint64_t admit = 0;
#pragma unroll
  for (int j = 0; j < kCols + 2; ++j) {
    const int c = c0 + j;
    bool open;
    int code;
    if constexpr (kHp) {
      open = (band >> j) & 1;
      const int g = wlo + c;
      const bool in = c < W && g < hp.wtot;
      code = in ? hp.refs[sbase + g] : 4;
      if (j < kCols) {
        // the column's -h word: its char, and which candidate it may take
        uint32_t w = 0;
        if (in) {
          const int hc = hp.hpcs[sbase + g];
          w = (uint32_t)hp.refchr[sbase + g] << 24;
          if (hc == g && c >= 1) w |= kHrOk;
          if (hc != g && hc > 0 && hc - 1 >= wlo)
            w |= kHcOk | (uint32_t)min(hc - 1 - wlo, W - 1);
        }
        colw[c] = w;
      }
    } else {
      open = c < W && mk[c] != 0;
      code = c < W ? ref[c] : 0;
    }
    if (j < kCols) {
      code = code < 0 ? 0 : (code > 4 ? 4 : code);
      if ((j & 3) == 0) cw[j >> 2] = 0;
      cw[j >> 2] |= (uint32_t)(8 * (open ? code : 5)) << (8 * (j & 3));
    }
    if (open || c == 2) admit |= 1ull << j;
  }
  auto entry_off = [&](int j) { return __byte_perm(cw[j >> 2], 0, 0x4440 | (j & 3)); };
  __syncthreads();

  // ---- row 0 -----------------------------------------------------------------
  int R[kCols], rb[kCols];
  int run_new = LOW;  // the new row's prefix max over this thread's origins 0 .. 31
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    R[j] = ((const int2*)((const char*)sh_tab + entry_off(j)))->x;
    rb[j] = R[j];
    if (j >= 2 && (admit >> j & 1)) run_new = __viaddmax_s32(R[j - 2], GEP * (j - 2), run_new);
  }

  // What the row just written leaves for the next row's column gaps: this
  // thread's total over its origins (`x`: without its last column), joined
  // over the warp; lane 31 leaves the warp's share in the parity's slot.
  int excl = LOW, xw = LOW;
  auto publish = [&](int parity) {
    int x = run_new;
    if (admit >> kCols & 1) x = __viaddmax_s32(R[kCols - 2], GEP * (kCols - 2), x);
    int tot = x;
    if (admit >> (kCols + 1) & 1) tot = __viaddmax_s32(R[kCols - 1], GEP * (kCols - 1), tot);
    const int inc = warp_scan_max(tot + goff, lane);
    excl = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) excl = LOW;
    xw = max(excl, x + goff);
    if (lane == 31) sh_edge[parity][warp] = make_int4(inc, xw, R[kCols - 1], rb[kCols - 1]);
  };
  publish(0);

  // kHp: the row before the read's current run, staged for the -h
  // candidates of the run's rows (hp_col on its first row, hp_row on the
  // rest; the TPU kept a ring of 32 rows for the second).  The row before a
  // run start goes into the other of two buffers, so a thread may stage it
  // while the others still read the last run's; the next row's barrier
  // publishes it.
  int sb = 0;
  auto stage_if_run_starts = [&](int next) {
    if constexpr (kHp) {
      if (next <= last && sh_hp.hprs[next] == next) {
        sb ^= 1;
#pragma unroll
        for (int j = 0; j < kCols; ++j) stage[sb * wp + c0 + j] = R[j];
      }
    }
  };
  stage_if_run_starts(1);

  // ---- rows 1 .. last --------------------------------------------------------
  int parity = 0;
  for (int row = 1; row <= last; ++row) {
    __syncthreads();
    const int start_new = sg5 ? -(GOP + GEP * (row + 1)) : 0;
    // no row gap ends on row 1: its cost there sinks the candidate
    const int neg_grow = row >= 2 ? -(GOP + GEP * (row - 1)) : kGate;
    const int fold = GEP * row;

    // the exchange: prefix max over every column before this thread's first
    // (`pre1`) and before its first but one (`pre2`), the previous column's
    // row value and row-gap max
    const int sc = warp_scan_max(lane < nwarps ? sh_edge[parity][lane].x : LOW, lane);
    const int carry_a = __shfl_sync(FULL, sc, warp > 0 ? warp - 1 : 0);
    const int carry_b = __shfl_sync(FULL, sc, warp > 1 ? warp - 2 : 0);
    const int carry = warp > 0 ? carry_a : LOW;
    int pre1 = max(carry, excl);
    int pre2 = max(carry, __shfl_up_sync(FULL, xw, 1));
    int pm1 = __shfl_up_sync(FULL, R[kCols - 1], 1);
    int rbp = __shfl_up_sync(FULL, rb[kCols - 1], 1);
    if (lane == 0) {
      if (warp > 0) {
        const int4 e = sh_edge[parity][warp - 1];
        pre2 = max(warp > 1 ? carry_b : LOW, e.y);
        pm1 = e.z;
        rbp = e.w;
      } else {
        // column 0 has no neighbours: its base is the restart value itself
        pre2 = LOW;
        pm1 = start_new;
        rbp = HIM;
      }
    }
    pre1 -= goff;
    pre2 -= goff;

    const char* trow = (const char*)sh_tab + row * kRowBytes;
    int run = pre2, pm2 = LOW;
    run_new = LOW;
    // The cells, in one straight-line variant per kind of row (0: no -h
    // candidate, 1: hp_col, 2: hp_row), picked by a block-uniform branch.
    // hp_col of column c: the staged row at the column before its reference
    // run, src, less GEP * (c - 1 - src) and the read run's discount; hp_row:
    // the staged row at c - 1 less the discount; each only where the
    // reference char equals the read's.  A candidate from a closed column
    // stays below the restart value, as every value from a closed cell does.
    // The -h rows come in as a parameter, so that the plain form, which has
    // none, does not look their members up.
    auto cells = [&](auto kind, auto& rows) {
      constexpr int kKind = decltype(kind)::value;
      uint32_t ch = 0;
      int hp_add = 0;
      const int32_t* stg = nullptr;
      if constexpr (kKind != 0) {
        ch = rows.chr[row];
        hp_add = -rows.pengop[rows.pidx[row]] - (kKind == 1 ? goff : 0);
        stg = stage + sb * wp;
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (j == 1) run = pre1;
        if (j >= 2 && (admit >> j & 1)) {
          run = __viaddmax_s32(pm2, GEP * (j - 2), run);
          run_new = __viaddmax_s32(R[j - 2], GEP * (j - 2), run_new);
        }
        // gap_col = prefix[c - 2] - (GOP + GEP * (c - 1)), thread-local
        int base = __viaddmax_s32(run, -(GOP + GEP * (j - 1)), pm1);
        base = __viaddmax_s32(rbp, neg_grow, base);
        if constexpr (kKind != 0) {
          const uint32_t w = colw[c0 + j];
          int cand;
          bool takes;
          if constexpr (kKind == 1) {
            const int src = w & 0xffff;
            takes = (w & kHcOk) && (w >> 24) == ch;
            cand = stg[src] + GEP * (src + 1 - j) + hp_add;
          } else {
            takes = (w & kHrOk) && (w >> 24) == ch;
            cand = stg[c0 + j - (c0 + j > 0)] + hp_add;
          }
          base = max(base, takes ? cand : LOW);
        }
        const int2 cell = *(const int2*)(trow + entry_off(j));
        bool keeps;  // base >= start_new: no restart
        const int m = __vibmax_s32(base, start_new, &keeps);
        const int q = m + (keeps ? cell.x : cell.y);
        pm2 = pm1;
        pm1 = R[j];
        rbp = rb[j];
        R[j] = q;
        rb[j] = __viaddmax_s32(q, fold, rb[j]);
      }
    };
    if constexpr (kHp) {
      const int hs = sh_hp.hprs[row];
      if (hs == row) cells(Kind<1>{}, sh_hp);
      else if (hs > 0 && row - hs < kHpw) cells(Kind<2>{}, sh_hp);
      else cells(Kind<0>{}, sh_hp);
    } else {
      cells(Kind<0>{}, sh_hp);
    }
    parity ^= 1;
    if (row < last) {
      publish(parity);
      stage_if_run_starts(row + 1);
    }
  }

  if constexpr (kHp) {
    // the last row's best and its first column, closed columns at HIM
    int bv = INT_MIN, bc = INT_MAX;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int v = entry_off(j) == 8 * 5 ? HIM : R[j];
      if (c0 + j < W && v > bv) {
        bv = v;
        bc = c0 + j;
      }
    }
    auto join = [&]() {
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        const int ov = __shfl_xor_sync(FULL, bv, off), oc = __shfl_xor_sync(FULL, bc, off);
        if (ov > bv || (ov == bv && oc < bc)) {
          bv = ov;
          bc = oc;
        }
      }
    };
    join();
    if (lane == 0) sh_hp.best[warp] = make_int2(bv, bc);
    __syncthreads();
    if (warp == 0) {
      const int2 e = lane < nwarps ? sh_hp.best[lane] : make_int2(INT_MIN, INT_MAX);
      bv = e.x;
      bc = e.y;
      join();
      if (lane == 0) {
        out[b] = bv;
        out[B + b] = bc;
      }
    }
  } else {
    int32_t* o = out + (int64_t)b * W;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (c0 + j < W) o[c0 + j] = entry_off(j) == 8 * 5 ? HIM : R[j];
  }
}

// ---- the wide form ----------------------------------------------------------

constexpr int F_CODE = 7;    // bits 0-2: reference code 0..4
constexpr int F_OPEN = 8;    // this column is open
constexpr int F_UPD = 16;    // column c + 1 is open: the row-gap max at c updates
constexpr int F_CAND = 32;   // column c + 2 is open, or c == 0: a column-gap origin

__device__ __forceinline__ int sub_for(int code, int s0, int s1, int s2, int s3, int s4) {
  int v = s4;
  v = code == 0 ? s0 : v;
  v = code == 1 ? s1 : v;
  v = code == 2 ? s2 : v;
  v = code == 3 ? s3 : v;
  return v;
}

// ints one block's rows and flags take: 3 rows of W and W flag bytes
__host__ __device__ inline int64_t block_ints(int W) { return 3 * (int64_t)W + (W + 3) / 4; }

__global__ void __launch_bounds__(kMaxThreads, 1)
dp_last_row_wide_kernel(const int32_t* __restrict__ s1c, int s1c_per_read,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ s2c,
                   const int32_t* __restrict__ depths,
                   const int32_t* __restrict__ submat,
                   const int32_t* __restrict__ lengths, int B, int W, int L, int sg5,
                   int C, int32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  extern __shared__ int32_t dyn[];
  __shared__ int32_t sh_tot[32], sh_x[32];

  int32_t* base = scratch ? scratch + blockIdx.x * block_ints(W) : dyn;
  int32_t* prev = base;
  int32_t* prev2 = base + W;
  int32_t* rbest = base + 2 * (int64_t)W;
  uint8_t* flags = (uint8_t*)(base + 3 * (int64_t)W);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c0 = min(tid * C, W), c1 = min(c0 + C, W);

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int32_t* ref = s1c + (s1c_per_read ? (int64_t)b * W : 0);
    const uint8_t* mk = mask + (int64_t)b * W;
    // a read whose last row lies outside [0, L) keeps row 0 (the plain
    // version's loop never reaches its snapshot row)
    int last = lengths[b] - 1;
    if (last < 0 || last >= L) last = 0;

    // the 5 substitution scores of a row, the same for every column
    auto row_scores = [&](int row, int& s0, int& s1, int& s2, int& s3, int& s4) {
      const int64_t at = (int64_t)b * L + row;
      int d = depths[at], x = s2c[at];
      d = d < 0 ? 0 : (d > kDepth - 1 ? kDepth - 1 : d);
      x = x < 0 ? 0 : (x > 4 ? 4 : x);
      const int32_t* p = submat + d * 25 + x;
      s0 = p[0]; s1 = p[5]; s2 = p[10]; s3 = p[15]; s4 = p[20];
    };

    // ---- flags and row 0 ---------------------------------------------------
    {
      int s0, s1, s2, s3, s4;
      row_scores(0, s0, s1, s2, s3, s4);
      for (int c = c0; c < c1; ++c) {
        int code = ref[c];
        code = code < 0 ? 0 : (code > 4 ? 4 : code);
        const int m0 = mk[c] != 0;
        const int m1 = c + 1 < W && mk[c + 1] != 0;
        const int m2 = (c + 2 < W && mk[c + 2] != 0) || c == 0;
        flags[c] = (uint8_t)(code | (m0 ? F_OPEN : 0) | (m1 ? F_UPD : 0) | (m2 ? F_CAND : 0));
        const int v = m0 ? sub_for(code, s0, s1, s2, s3, s4) : HIM;
        prev[c] = v;
        prev2[c] = LOW;
        rbest[c] = v;
      }
    }
    __syncthreads();

    // ---- rows 1 .. last ----------------------------------------------------
    for (int row = 1; row <= last; ++row) {
      int s0, s1, s2, s3, s4;
      row_scores(row, s0, s1, s2, s3, s4);
      const int sg5_pen = sg5 ? GOP + GEP * (row + 1) : 0;
      const int start_new = -sg5_pen;
      const int grow_cost = GOP + GEP * (row - 1);
      const int radd = GEP * (row - 2);

      // pass 1: the row-gap max over rows <= row - 2, and this thread's
      // prefix-max total of prev[c] + GEP c over the open origins (`t2`: the
      // same without its last column)
      int run = LOW, t2 = LOW;
      for (int c = c0; c < c1; ++c) {
        const int f = flags[c];
        if (c == c1 - 1) t2 = run;
        if (f & F_CAND) run = max(run, prev[c] + GEP * c);
        if (row >= 2 && (f & F_UPD)) {
          const int cr = prev2[c] + radd;
          if (cr > rbest[c]) rbest[c] = cr;
        }
      }
      // block scan of the totals: inclusive in the warp, then one carry per warp
      const int inc = warp_scan_max(run, lane);
      int excl_w = __shfl_up_sync(FULL, inc, 1);
      if (lane == 0) excl_w = LOW;
      // prefix over the columns up to this thread's last but one (warp scope)
      const int x = max(excl_w, t2);
      if (lane == 31) {
        sh_tot[warp] = inc;
        sh_x[warp] = x;
      }
      __syncthreads();
      const int sc = warp_scan_max(lane < nwarps ? sh_tot[lane] : LOW, lane);
      const int carry_a = __shfl_sync(FULL, sc, warp > 0 ? warp - 1 : 0);
      const int carry_b = __shfl_sync(FULL, sc, warp > 1 ? warp - 2 : 0);
      const int carry = warp > 0 ? carry_a : LOW;        // columns of earlier warps
      const int carry_prev = warp > 1 ? carry_b : LOW;   // ... of warps before the last
      // rm[c0 - 1] and rm[c0 - 2]: the inclusive prefix max at the two columns
      // before this thread's first (C >= 2: both lie in the previous thread)
      int rm1 = max(carry, excl_w);
      int rm2 = max(carry, __shfl_up_sync(FULL, x, 1));
      if (lane == 0) rm2 = warp > 0 ? max(carry_prev, sh_x[warp - 1]) : LOW;

      // pass 2: the new row, written over prev2
      int diag_prev = c0 > 0 && c0 < W ? prev[c0 - 1] : LOW;
      int rb_prev = c0 > 0 && c0 < W ? rbest[c0 - 1] : LOW;
      int run2 = rm1;
      for (int c = c0; c < c1; ++c) {
        const int f = flags[c];
        const int p = prev[c];
        const int rb = rbest[c];
        const int gap_col = c >= 2 ? rm2 - (GOP + GEP * (c - 1)) : HIM;
        const int gap_row = (row >= 2 && c >= 1) ? rb_prev - grow_cost : HIM;
        const int diag = c >= 1 ? diag_prev : LOW;
        const int bs = max(max(diag, gap_col), gap_row);
        const int cell = sub_for(f & F_CODE, s0, s1, s2, s3, s4);
        int v = start_new > bs ? start_new : cell + bs;
        if (c == 0) v = cell - sg5_pen;
        prev2[c] = (f & F_OPEN) ? v : HIM;
        if (f & F_CAND) run2 = max(run2, p + GEP * c);
        rm2 = rm1;
        rm1 = run2;
        diag_prev = p;
        rb_prev = rb;
      }
      __syncthreads();
      int32_t* t = prev;
      prev = prev2;
      prev2 = t;
    }

    int32_t* o = out + (int64_t)b * W;
    for (int c = c0; c < c1; ++c) o[c] = prev[c];
    // the next read's prologue writes only this thread's own columns, and a
    // barrier follows it before any thread reads a neighbour's
  }
}

}  // namespace

// s1c [W] (s1c_per_read 0) or [B, W] int32 codes; mask [B, W] bytes;
// s2c [B, L], depths [B, L], submat [31, 5, 5] int32; lengths [B] int32;
// out [B, W] int32.  The register form: W at most kRegThreads * kCols
// columns, L at most kLMax rows; one block per read.
extern "C" int mia_dp_last_row(const void* s1c, int s1c_per_read, const void* mask,
                               const void* s2c, const void* depths, const void* submat,
                               const void* lengths, int B, int W, int L, int sg5,
                               void* out, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (L < 1 || L > kLMax || W > kRegThreads * kCols) return (int)cudaErrorInvalidValue;
  const int threads = ((W + kCols - 1) / kCols + 31) / 32 * 32;
  // the longest reads first while finding a read's rank is cheap beside
  // scoring it: a block looks at every read's length, `threads` at a time
  const int ranked = B <= 8 * threads;
  dp_last_row_kernel<false><<<B, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)s1c, s1c_per_read, (const uint8_t*)mask, (const int32_t*)s2c,
      (const int32_t*)depths, (const int32_t*)submat, (const int32_t*)lengths, B, W, L,
      sg5, ranked, HpArgs{}, (int32_t*)out);
  return (int)cudaGetLastError();
}

// -h (the kHp register form): (best, first column of the best) of each
// row's last DP row, out [2, B] int32, the column window-local.  refs
// [2, wtot] int8 codes, refchr [2, wtot] uint8 chars, hpcs [2, wtot] int32
// run starts (the scorer's state); strand [B] int8, win_lo [B] int32, ivl
// [B, 16, 2] int32 window-local intervals, s2chr [B, L] uint8 read chars
// (pad 0), lengths [B] int32; submat [31, 5, 5] int32, pengop [11] int32,
// b2i [256] int8.  W at most kRegThreads * kCols columns, L at most kLMax.
extern "C" int mia_dp_last_row_hp(const void* refs, const void* refchr, const void* hpcs,
                                  int wtot, const void* strand, const void* win_lo,
                                  const void* ivl, const void* s2chr, const void* lengths,
                                  const void* submat, const void* pengop, const void* b2i,
                                  int B, int W, int L, void* out, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (L < 1 || L > kLMax || W > kRegThreads * kCols) return (int)cudaErrorInvalidValue;
  const int threads = ((W + kCols - 1) / kCols + 31) / 32 * 32;
  const int ranked = B <= 8 * threads;
  // two staged rows and a word a column
  const int dyn = 3 * threads * kCols * (int)sizeof(int32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      dp_last_row_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  const HpArgs hp{(const int8_t*)refs,    (const uint8_t*)refchr, (const int32_t*)hpcs,
                  wtot,                   (const int8_t*)strand,  (const int32_t*)win_lo,
                  (const int32_t*)ivl,    (const uint8_t*)s2chr,  (const int32_t*)pengop,
                  (const int8_t*)b2i};
  dp_last_row_kernel<true><<<B, threads, dyn, (cudaStream_t)stream>>>(
      nullptr, 0, nullptr, nullptr, nullptr, (const int32_t*)submat,
      (const int32_t*)lengths, B, W, L, 1, ranked, hp, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The wide form, any W: `threads` is a multiple of 32 up to 1024, `blocks`
// at most B.  `scratch` is null when 4 * block_ints(W) fits the shared
// memory a block may ask for (mia_dp_last_row_constants), else
// [blocks, block_ints(W)] int32.
extern "C" int mia_dp_last_row_wide(const void* s1c, int s1c_per_read, const void* mask,
                                    const void* s2c, const void* depths,
                                    const void* submat, const void* lengths, int B, int W,
                                    int L, int sg5, int threads, int blocks, void* scratch,
                                    void* out, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (L < 1 || threads < 32 || threads > kMaxThreads || threads % 32 || blocks < 1 ||
      blocks > B)
    return (int)cudaErrorInvalidValue;
  int C = (W + threads - 1) / threads;
  if (C < 2) C = 2;
  const int64_t bytes = 4 * block_ints(W);
  size_t dyn = 0;
  if (!scratch) {
    if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
    dyn = (size_t)bytes;
    const cudaError_t e = cudaFuncSetAttribute(
        dp_last_row_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  dp_last_row_wide_kernel<<<blocks, threads, dyn, (cudaStream_t)stream>>>(
      (const int32_t*)s1c, s1c_per_read, (const uint8_t*)mask, (const int32_t*)s2c,
      (const int32_t*)depths, (const int32_t*)submat, (const int32_t*)lengths, B, W, L, sg5,
      C, (int32_t*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The compile-time constants of these kernels, in this order: GOP, GEP, HIM,
// LOW, PSSM depth slots, the wide form's dynamic shared memory limit in
// bytes, the register form's columns per thread, threads per block and read
// rows, and the kHp form's intervals a row, read-run reach, discount slots
// and widest row (entries.HP_WIDE_COLS).  Fills at most n values of out; returns how many there are.
extern "C" int mia_dp_last_row_constants(int32_t* out, int n) {
  const int32_t c[] = {GOP,   GEP,         HIM,   LOW, kDepth, kSmemLimit,
                       kCols, kRegThreads, kLMax, kK,  kHpw,   kPengop,
                       kRegThreads * kCols};
  const int count = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}
