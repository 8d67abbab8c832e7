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
//     loop at 128 registers); a row of a wider band takes G = 2, 4 or 8
//     warps (the fewest with 384 G at least its band, up to 3,072 columns,
//     entries.BAND_ROW_COLS), warp g of the row owning band columns
//     [384 g, 384 g + 384).  A block keeps 8 warps and holds 8 / G rows of
//     one G; the host orders the rows by G (entries.wide_rows) and passes
//     the rows of each class, whose blocks take consecutive blockIdx, so
//     that every band row is one launch.  Each DP row, lane 31 of each warp
//     leaves its warp's column-gap total, its prefix two columns before the
//     warp's end, and its last column's row-gap max and value in a
//     shared-memory slot chosen by row parity, as the register form's warps
//     do (dp_last_row.cu); one named barrier over the row's warps only
//     (bar.sync id, 32 G), and each warp takes the max of the totals before
//     it and lane 0 its left neighbour's values.  The argmax joins the
//     row's warps through shared memory, the first column on ties.  G = 1
//     rows run the one-warp body unchanged, with no barrier.  The
//     recurrence and layout of dp_entries.cu
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
//     win_lo + that column (past the state: code 4, char 0, run start 0).
//     The band layout, the origin gate, the DP step and the argmax are
//     band_dp.cuh's, shared with the strand form (dp_strand.cu);
//   * the PSSM depth of each DP row comes from the read's length
//     (find_sm_depth, src/pssm.c:36-46), as dp_torch.depths_for gives it;
//   * -h: hp_col's source, the column before the cell's reference run, may
//     lie in any lane, warp or interval: the prologue finds its band column,
//     and a source that is not open gives no candidate (on the whole window
//     its value is HIM, below the restart).  The staged row and the hp_col
//     sources of a row of G warps are one shared array 384 G columns wide
//     (its warps' arrays side by side, so a block's shared memory stays 8 x
//     384 columns); on G > 1 rows a named barrier before each staging keeps
//     it from overwriting a row that another warp still reads, and the
//     row's exchange barrier orders the staging before the reads;
//   * a row whose band takes more columns than its warps' is left to
//     another form by the host (entries.wide_rows); given one anyway, the
//     kernel writes (HIM, -1), which the host refuses.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "band_dp.cuh"

namespace {

using namespace band;

// Duplicates of the Python side's values (entries.BAND_COLS; band_dp.cuh
// holds the rest, HPW_ROUTE among them); mia_dp_band_constants and
// mia_dp_band_hp_constants export them so that the loader
// (torchcfg.kernel_library) refuses a library that disagrees.
constexpr int kCPL = 12;              // band columns per lane
constexpr int kBand = 32 * kCPL;      // band columns a warp
constexpr int kWarps = 8;             // warps per block; the most warps a row
constexpr int kClasses = 4;           // rows of 1, 2, 4 and 8 warps
constexpr int kRowBand = kBand * kWarps;  // band columns a row at most

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
  int n[kClasses];         // rows of 1, 2, 4 and 8 warps, in that order
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
  // (warp w's columns from w * 384 on; a row of G warps takes its warps'
  // arrays side by side)
  uint16_t hsrc[kWarps * kBand];  // hp_col: byte offset of the source column in the row's row[]
  int32_t hneg[kWarps * kBand];   // hp_col: minus the distance cost to that column
  int32_t row[kWarps * kBand];    // the row before the current read run, staged
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
  Runs runs[kWarps];              // each row's band
  // rows of G > 1 warps: per row parity and warp, (column-gap total, its
  // prefix two columns before the warp's end, the last column's row-gap max
  // and value); per warp its (best, column)
  int4 xch[2][kWarps];
  int2 amax[kWarps];
};

// A named barrier over the G warps of one row (id 1 + the row's place in
// its block; 0 is __syncthreads').
__device__ __forceinline__ void row_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One row of the band form on G warps; this warp is warp g of the row's.
template <bool kHp, int G>
__device__ __forceinline__ void band_row(const Args& a, const int warp, const int lane,
                                         const int e, const int g_in) {
  // the block's shared memory, dynamic so that an out-of-line body reaches
  // it as shared memory too: sizeof(Shared<kHp>), under 48 KB
  extern __shared__ __align__(16) unsigned char band_smem[];
  Shared<kHp>& sh = *reinterpret_cast<Shared<kHp>*>(band_smem);
  const int g = G == 1 ? 0 : g_in;
  const int bar_id = 1 + warp / G;
  const int L = a.L;

  // ---- the band: intervals sorted by rank, then joined into runs ---------
  Runs& rr = sh.runs[warp];
  int nband;
  const int n = band_runs(a.ivl, e, rr, lane, nband);
  if (nband > kBand * G) {  // every warp of the row leaves here
    if (g == 0 && lane == 0) {
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
      sh.chr[warp][r] = read_code(a.s2c[(int64_t)e * L + r]);
    }
  }
  __syncwarp();
  if constexpr (kHp) hp_read_runs(sh.chr[warp], L, sh.hp.hprs[warp], sh.hp.pidx[warp], lane);

  // ---- this lane's band columns --------------------------------------------
  const int len = a.lengths[e];
  int last = len - 1;  // a last row outside [0, L) keeps row 0
  if (last < 0 || last >= L) last = 0;
  const int wlo = a.win_lo[e];
  const int64_t sbase = (int64_t)a.strand[e] * a.wtot;
  const int k0 = g * kBand + lane * kCPL;
  // this warp's and its row's first column in the -h arrays
  const int wbase = warp * kBand;
  const int rbase = (warp - g) * kBand;

  int woff[kCPL], gadd[kCPL], ncost[kCPL];  // band_dp.cuh's column_terms
  HpCols<kCPL> hpc;                         // -h: band_dp.cuh's hp_column
  unsigned mbits = 0;
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    int c;
    bool in;
    const bool open = band_column(rr, n, nband, k0 + j, wlo, a.wtot, c, in);
    mbits |= (unsigned)open << j;
    const int gc = wlo + c;
    column_terms(c, open, in ? a.refs[sbase + gc] : 4, woff[j], gadd[j], ncost[j]);
    if constexpr (kHp) {
      const int hrun = in ? a.hpcs[sbase + gc] : 0;
      const int src =
          hp_column(hpc, j, rr, n, open, c, wlo, in ? a.refchr[sbase + gc] : 0, hrun);
      // the source's place in the row's arrays: the warp of src / 384,
      // lane-major in it
      sh.hp.hsrc[wbase + j * 32 + lane] = (uint16_t)lane_major<kCPL>(max(src, 0));
      sh.hp.hneg[wbase + j * 32 + lane] = -GEP * (gc - hrun);
    }
  }
  // origin k counts where band column k + 2 is open; band column 0 always
  unsigned nbits = __shfl_down_sync(FULL, mbits, 1);
  if (lane == 31) {
    // the next warp's first two columns, or none past the row's last warp
    nbits = 0;
    if constexpr (G > 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + kCPL + j;
        nbits |= (unsigned)(k < nband && is_open(rr, n, col_of(rr, n, k))) << j;
      }
    }
  }
  gate_origins(gadd, mbits, nbits, lane == 0 && g == 0);
  __syncwarp();

  // ---- row 0 -------------------------------------------------------------
  auto trow_of = [&](int row) {
    int x = sh.chr[warp][row];
    if constexpr (kHp) x = hp_code(sh.ht.b2i, x);
    return table_row(sh.tab, row, len, x);
  };
  int prev[kCPL], prev2[kCPL], rbest[kCPL];
  first_row(trow_of(0), woff, prev, prev2, rbest);
  // -h, hp_row: the staged column left of this lane's first column, from
  // this warp's first column (band column 0 takes none: lane 0 of the row's
  // first warp reads some column of its own instead)
  int left0;
  if constexpr (G == 1) {
    left0 = (kCPL - 1) * 32 + lane - (lane != 0);
  } else {
    left0 = lane != 0 ? (kCPL - 1) * 32 + lane - 1 : (g != 0 ? -1 : 0);
  }

  // ---- rows 1 .. last ----------------------------------------------------
  // One row: P holds row - 1, Q row - 2; the new row replaces Q.
  auto do_row = [&](const int row, int (&P)[kCPL], int (&Q)[kCPL]) {
    const char* trow = trow_of(row);
    const int start_new = -(GOP + GEP * (row + 1));
    // no row gap ends on row 1: its cost there sinks the candidate
    const int neg_grow = row >= 2 ? -(GOP + GEP * (row - 1)) : kGate;

    // -h: which candidate this row may take (row-uniform), and the
    // columns that take it as 0x80 flags
    HpKind hk{false, false, 0};
    uint32_t hit[HpCols<kCPL>::kW];
    if constexpr (kHp) {
      const int slot = sh.hp.pidx[warp][row];
      hk = hp_kind(sh.hp.hprs[warp][row], slot, row, sh.ht.pengop);
      const uint32_t any = hp_hits(hpc, sh.chr[warp][row], hk.col, hit);
      // the row before this run: hp_col's source now, hp_row's on the
      // run's later rows
      if constexpr (G == 1) {
        if (hk.col && (slot > 0 || __any_sync(FULL, any != 0))) {
          __syncwarp();
          hp_stage(sh.hp.row + wbase, P, lane);
          __syncwarp();
        }
      } else {
        (void)any;
        if (hk.col) {
          // no warp of the row still reads the row staged before; the
          // exchange barrier below orders these writes before the reads
          row_bar(bar_id, 32 * G);
          hp_stage(sh.hp.row + wbase, P, lane);
        }
      }
    }

    // column gaps: the prefix over this lane's columns, then the warp's
    int rl[kCPL];
    int excl, pre_m2;
    const int tot = warp_prefix(gap_prefix(P, gadd, rl), rl, lane, excl, pre_m2);
    row_gaps(Q, row, rbest);

    // previous lane's last column for the shifted reads; band column 0 has
    // no neighbours: its base is the restart value itself
    int rb_m1 = __shfl_up_sync(FULL, rbest[kCPL - 1], 1);
    int pv_m1 = __shfl_up_sync(FULL, P[kCPL - 1], 1);
    if (lane == 0) {
      pre_m2 = LOW;
      rb_m1 = HIM;
      pv_m1 = start_new;
    }
    if constexpr (G > 1) {
      // the row's earlier warps: the max of their totals, and lane 0's left
      // neighbour, the last column of the warp before
      int4* xs = sh.xch[row & 1] + (warp - g);  // this row's warps' slots
      if (lane == 31)
        xs[g] = make_int4(tot, max(rl[kCPL - 2], excl), rbest[kCPL - 1], P[kCPL - 1]);
      row_bar(bar_id, 32 * G);
      int before = LOW, before_prev = LOW;
#pragma unroll
      for (int v = 0; v < G - 1; ++v) {
        if (v < g) {
          before_prev = before;
          before = max(before, xs[v].x);
        }
      }
      excl = max(excl, before);
      pre_m2 = max(pre_m2, before);
      if (lane == 0 && g != 0) {
        const int4 p = xs[g - 1];
        pre_m2 = max(before_prev, p.y);
        rb_m1 = p.z;
        pv_m1 = p.w;
      }
    }

    // The cells, in one straight-line variant per kind of row (0: no -h
    // candidate, 1: hp_col, 2: hp_row), picked by a row-uniform branch.
    // The -h arrays come in as a parameter, so that the plain
    // instantiation, which has none, does not look their members up.
    auto cells = [&](auto kind, auto& hs) {
      constexpr int kKind = decltype(kind)::value;
#pragma unroll
      for (int j = 0; j < kCPL; ++j) {
        // gap_col = prefix[c - 2] - (GOP + GEP * (c - 1))
        const int pre = j >= 2 ? max(rl[j - 2], excl) : (j == 1 ? excl : pre_m2);
        int base = cell_base(pre, ncost[j], j >= 1 ? P[j - 1] : pv_m1,
                             j >= 1 ? rbest[j - 1] : rb_m1, neg_grow);
        if constexpr (kHp && kKind != 0) {
          int cand;
          if constexpr (kKind == 1) {
            const int src = *(const int32_t*)((const char*)(hs.row + rbase) +
                                              hs.hsrc[wbase + j * 32 + lane]);
            cand = src + hs.hneg[wbase + j * 32 + lane] + hk.neg_pen;
          } else {
            // the column to the left
            cand = hs.row[wbase + (j >= 1 ? (j - 1) * 32 + lane : left0)] + hk.neg_pen;
          }
          base = hp_take(base, hit, j, cand);
        }
        Q[j] = cell_value(base, start_new, trow, woff[j]);
      }
    };
    if constexpr (kHp) {
#ifdef MIA_HP_KIND
      // every row of one kind, for counting that kind's instructions alone
      // (python -m mia_tpu_torch.utils.sass -D MIA_HP_KIND=k); wrong scores
      cells(std::integral_constant<int, MIA_HP_KIND>{}, sh.hp);
#else
      if (hk.col) cells(std::integral_constant<int, 1>{}, sh.hp);
      else if (hk.row) cells(std::integral_constant<int, 2>{}, sh.hp);
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
  int bv, bc;
  lane_best(prev, mbits, ncost, bv, bc);
  warp_best(bv, bc);
  if constexpr (G > 1) {
    // the row's warps in order: a later warp's columns are later
    if (lane == 0) sh.amax[warp] = make_int2(bv, bc);
    row_bar(bar_id, 32 * G);
    if (g != 0) return;
    for (int v = 1; v < G; ++v) {
      const int2 o = sh.amax[warp + v];
      take_better(o.x, o.y, bv, bc);
    }
  }
  if (lane == 0) {
    a.out[e] = bv;
    a.out[a.ldo + e] = bc;
  }
}

// Rows of G > 1 warps, out of line: their exchange keeps a few more values
// live across the row loop, and inlined beside the one-warp body it raised
// that body's register pressure and its instructions a DP row (ptxas
// allocates each function apart; the kernel's limit of 128 holds for all).
// The arguments come by value, so that the kernel's stay in the constant
// bank for the one-warp body.
template <bool kHp, int G>
__device__ __noinline__ void band_row_warps(const Args a, const int warp, const int lane,
                                            const int e, const int g) {
  band_row<kHp, G>(a, warp, lane, e, g);
}

// Blocks of rows of class c (G = 2^c warps a row, 8 / G rows a block).
__host__ __device__ inline int class_blocks(int rows, int c) {
  const int per = kWarps >> c;
  return (rows + per - 1) / per;
}

template <bool kHp>
__global__ void __launch_bounds__(kWarps * 32, 2) dp_band_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  Shared<kHp>& sh = *reinterpret_cast<Shared<kHp>*>(band_smem);
  fill_table(sh.tab, a.submat, threadIdx.x, blockDim.x);
  if constexpr (kHp) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sh.ht.b2i[i] = a.b2i[i];
    if (threadIdx.x < kPengop) sh.ht.pengop[threadIdx.x] = a.pengop[threadIdx.x];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this block's class and its first row: the classes' blocks in order
  int blk = blockIdx.x, first = 0, c = 0;
  for (; c < kClasses; ++c) {
    const int nb = class_blocks(a.n[c], c);
    if (blk < nb) break;
    blk -= nb;
    first += a.n[c];
  }
  if (c == kClasses) return;
  const int e = first + blk * (kWarps >> c) + (warp >> c);
  // the row's warps leave together; no block barrier follows
  if (e >= first + a.n[c]) return;
  const int g = warp & ((1 << c) - 1);
  switch (c) {
    case 0: band_row<kHp, 1>(a, warp, lane, e, g); break;
    case 1: band_row_warps<kHp, 2>(a, warp, lane, e, g); break;
    case 2: band_row_warps<kHp, 4>(a, warp, lane, e, g); break;
    default: band_row_warps<kHp, 8>(a, warp, lane, e, g); break;
  }
}

template <bool kHp>
int launch(const Args& a, void* stream) {
  int rows = 0, blocks = 0;
  for (int c = 0; c < kClasses; ++c) {
    if (a.n[c] < 0) return (int)cudaErrorInvalidValue;
    rows += a.n[c];
    blocks += class_blocks(a.n[c], c);
  }
  if (rows <= 0) return 0;
  if (a.L < 1 || a.L > kLMax || a.ldo < rows) return (int)cudaErrorInvalidValue;
  dp_band_kernel<kHp><<<blocks, kWarps * 32, sizeof(Shared<kHp>), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int fill(const int32_t* c, int count, int32_t* out, int n) {
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}

}  // namespace

// (best, first window column of the best) of each row's last -h DP row, its
// band columns scored only: out[b] and out[ldo + b] (ldo >= B, B = n1 + n2
// + n4 + n8), int32.  The rows come ordered by the warps each takes: n1 on
// one warp (band columns at most 384), then n2 on two (768), n4 on four
// (1,536), n8 on eight (3,072).  refs [2, wtot] int8 codes, refchr [2, wtot]
// uint8 chars, hpcs [2, wtot] int32 run starts (the scorer's state); strand
// [B] int8, win_lo [B] int32, ivl [B, 16, 2] int32 window-local intervals
// (0 <= lo, hi <= 17,408), s2chr [B, L] uint8 read chars (pad 0), lengths
// [B] int32; submat [31, 5, 5] int32, pengop [11] int32, b2i [256] int8.  L
// at most 256.
extern "C" int mia_dp_band_hp(const void* refs, const void* refchr, const void* hpcs,
                              int wtot, const void* strand, const void* win_lo,
                              const void* ivl, const void* s2chr, const void* lengths,
                              const void* submat, const void* pengop, const void* b2i,
                              int n1, int n2, int n4, int n8, int L, void* out, int ldo,
                              void* stream) {
  const Args a{(const int8_t*)refs,     (const uint8_t*)refchr, (const int32_t*)hpcs,
               wtot,                    (const int8_t*)strand,  (const int32_t*)win_lo,
               (const int32_t*)ivl,     (const uint8_t*)s2chr,  L,
               (const int32_t*)lengths, (const int32_t*)submat, (const int32_t*)pengop,
               (const int8_t*)b2i,      {n1, n2, n4, n8},       (int32_t*)out,
               ldo,                     nullptr};
  return launch<true>(a, stream);
}

// The same without -h: (best, first window column of the best) of each
// row's last DP row (sg5 on, the one PSSM submat for every row), its band
// columns scored only, the rows ordered by warps as above.  refs [2, wtot]
// int8 codes; strand [B] int8, win_lo [B] int32, ivl [B, 16, 2] int32
// window-local intervals, s2c [B, L] int32 read codes (pad 4), lengths [B]
// int32; submat [31, 5, 5] int32.  L at most 256.
extern "C" int mia_dp_band(const void* refs, int wtot, const void* strand,
                           const void* win_lo, const void* ivl, const void* s2c,
                           const void* lengths, const void* submat, int n1, int n2, int n4,
                           int n8, int L, void* out, int ldo, void* stream) {
  const Args a{(const int8_t*)refs,     nullptr,                nullptr,
               wtot,                    (const int8_t*)strand,  (const int32_t*)win_lo,
               (const int32_t*)ivl,     nullptr,                L,
               (const int32_t*)lengths, (const int32_t*)submat, nullptr,
               nullptr,                 {n1, n2, n4, n8},       (int32_t*)out,
               ldo,                     (const int32_t*)s2c};
  return launch<false>(a, stream);
}

// The compile-time constants of the -h form, in this order: band columns a
// warp, intervals a row, read rows, PSSM depth slots, GOP, GEP, HIM, LOW, -h
// row reach, -h discount slots, band columns a row at most.  Fills at most n
// values of out; returns how many there are.
extern "C" int mia_dp_band_hp_constants(int32_t* out, int n) {
  const int32_t c[] = {kBand, kK, kLMax, kDepth, GOP, GEP, HIM, LOW, kHpw, kPengop, kRowBand};
  return fill(c, (int)(sizeof(c) / sizeof(c[0])), out, n);
}

// The same for the plain form: band columns a warp, intervals a row, read
// rows, PSSM depth slots, PSSM depth, GOP, GEP, HIM, LOW, band columns a row
// at most.
extern "C" int mia_dp_band_constants(int32_t* out, int n) {
  const int32_t c[] = {kBand, kK, kLMax, kDepth, kPssmDepth, GOP, GEP, HIM, LOW, kRowBand};
  return fill(c, (int)(sizeof(c) / sizeof(c[0])), out, n);
}
