// Scorers of pass 1's WIDE rows whose band spans up to a whole strand
// (Hopper, sm_90a): the strand forms of K1g (plain) and K4g (-h).
//
// Replaces, for a row whose band takes more columns than the band form's
// eight warps (csrc/dp_band.cu, 3,072), the last DP row over the row's
// whole strand window and the argmax after it: without -h
// mia_tpu/ops/dp_pallas.py::_dp_kernel at full width (dp_jax.batch_last_row
// with dp_jax.batch_best_and_aec), under -h dp_jax.batch_last_row_hp with
// the window set-up of jax_engine._entries_core_hp.  (best, first window
// column of the best) leaves, as from the band form.  The plain versions
// are mia_tpu_torch/ops/dp_torch.py::last_row_strand_plain and
// last_row_hp_strand_plain (batch_last_row, batch_last_row_hp on the row's
// window); each equals the full form's bit for bit (int32, restart only on
// a strict >).  One source, one template: the plain instantiation (kHp =
// false) is the -h one without its candidates.
//
// What bounds it: not the cells (a whole human-mt strand of ~16,900 columns
// by a read's ~60-150 rows is 1-2.5 M cells, ~0.002 ms of the integer pipe
// spread over the card) but the chain of one DP row: a row's value at every
// column depends on the row before through the column-gap prefix, a max
// over all the columns to its left.  csrc/dp_last_row.cu's register form
// runs such a row on one block of one SM, 34 columns a thread, ~2 us a DP
// row (~4 under -h) while the other SMs idle.  Here a row runs on a cluster
// of kC (16) CTAs on as many SMs, 2,048 threads of 9 columns each (18,432
// band columns, entries.STRAND_COLS, past a strand window and the full
// form's 17,408):
//   * the layout is dp_band.cu's: a row's band columns are its open columns
//     and the two columns before each run of them, each column keeps its
//     real window column for the gap costs (registers), and a closed column
//     is a sixth code of the score table, (HIM, HIM); CTA k owns band
//     columns [k S, k S + S), S = 2,048 / kC * 9, thread t of it 9 of them;
//   * within a CTA each DP row is dp_band.cu's warp step (the thread's
//     running prefix, a warp scan by shuffles) and one exchange through
//     shared memory (lane 31 of each warp leaves its warp's total, its
//     prefix two columns before its end and its last column's row-gap max
//     and value in a slot chosen by row parity; one __syncthreads a row);
//   * across CTAs a DP row's inputs from the left are one carry: the
//     column-gap prefix over every column before the CTA's slice, the
//     prefix two columns before it, and the slice's left neighbour's
//     row-gap max and value.  CTA k - 1 computes it right after its own
//     exchange (the prefix is a max over the previous row, so it needs
//     none of this row's cells), writes it into CTA k's shared memory over
//     distributed shared memory and arrives on CTA k's mbarrier of that DP
//     row (release at cluster scope); CTA k waits on it (acquire).  So the
//     CTAs run as a pipeline over DP rows, CTA k a step behind CTA k - 1,
//     in L + kC - 1 steps and with no cluster barrier a row.  Each DP row
//     has a slot and a barrier of its own (256 of each, 6 KB): CTA 0 runs
//     ahead freely and nothing is overwritten, so no back-pressure is
//     needed;
//   * the recurrence is band_dp.cuh's, which both forms include (the band
//     layout, the origin gate, the DP step, the -h step and the argmax):
//     DPX add-max, the restart only on a strict >, each DP row's PSSM depth
//     from the read's length (find_sm_depth, src/pssm.c:36-46), the forward
//     PSSM on both strands; codes (-h: chars and run starts too) come from
//     the scorer's [2, wtot] state at win_lo + the window column (past the
//     state: code 4, char 0, run start 0);
//   * the argmax: each CTA's first best over its slice (warp shuffles, then
//     its warps in order), written into CTA 0's shared memory, a cluster
//     barrier, and CTA 0 takes the first of the CTAs' in order.
// Under -h (src/mia.c:883-905) each CTA works on its own slice only:
//   * warp 1 builds the read's runs in the prologue (each DP row's run start
//     and discount slot, band_dp.cuh's hp_read_runs), as the band form's
//     warps do; no distributed shared memory is needed for them;
//   * on a read run's first DP row each thread stages its columns of the row
//     before the run (lane-major, 1,152 ints a CTA) in its CTA's shared
//     memory, into one of two buffers chosen by the run's parity, before
//     the row's exchange barrier, which orders the staging before every
//     read.  A warp may stage run i + 1 while another still reads run i's
//     row in the cells of the DP row before; the readers of run i - 1's
//     buffer have all passed the barrier of the DP row before.  No CTA reads
//     another's staged row: CTA 0 runs ahead with no back-pressure, so by
//     then an earlier CTA's buffer may hold a later run;
//   * hp_row's left neighbour at the slice's first column is the row before
//     the run at the previous slice's last column: the carry of the run's
//     first DP row brings exactly that (its left neighbour's value, of the
//     DP row before), and thread 0 keeps it in a register for the run's
//     later rows;
//   * hp_col's source, the column before the cell's reference run, lies
//     before the CTA's slice only for the columns of the reference run open
//     at the slice's left edge, and they all share it.  On a read run's
//     first DP row the carry gains a fifth value: the staged row at that
//     run's source.  CTA k - 1 reads it from its own staged row where the
//     source lies in its slice, and otherwise passes on the value it
//     received (the run then spans its whole slice, so the source is the
//     same).  The chain has no limit on run length; it was chosen over a
//     host rule that would route a row with a reference run longer than a
//     slice to the full form.  A source that is not open gives no candidate
//     (on the whole window its value is HIM, below the restart).
// A row whose band takes more than 18,432 columns is left to the full form
// by the host (entries.wide_rows); given one anyway, the kernel writes
// (HIM, -1), which the host refuses.  One launch a call, a cluster a row,
// through cudaLaunchKernelEx with a cluster dimension.
#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "band_dp.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace band;

// A row on a cluster of kC CTAs, 2,048 threads in all: 16 CTAs (an H100
// holds 28 such clusters at once; 16 ran faster than 2, 4 and 8 on whole
// strands, PERF.md).  Duplicates of the Python side's
// values (entries.STRAND_COLS, dp_cuda.STRAND_*; band_dp.cuh holds the
// rest); mia_dp_strand_constants and mia_dp_strand_hp_constants export them
// so that the loader (torchcfg.kernel_library) refuses a library that
// disagrees.
constexpr int kC = 16;                      // CTAs a row: one cluster
constexpr int kThreads = 2048 / kC;         // threads a CTA
constexpr int kWarpsC = kThreads / 32;
constexpr int kCPL = 9;                     // band columns per thread
constexpr int kSlice = kThreads * kCPL;     // band columns a CTA
constexpr int kStrand = kC * kSlice;        // band columns a row: 18,432
constexpr int kW = HpCols<kCPL>::kW;        // -h: words of a thread's column flags
static_assert(kThreads % 32 == 0 && kC * kThreads == 2048, "2,048 threads a row");
static_assert(kWarpsC >= 2, "warp 1 builds the read's runs");

struct Args {
  const int8_t* refs;      // [2, wtot] codes
  const uint8_t* refchr;   // -h: [2, wtot] chars
  const int32_t* hpcs;     // -h: [2, wtot] global run start per column
  int wtot;
  const int8_t* strand;    // [R]
  const int32_t* win_lo;   // [R] global column of window column 0
  const int32_t* ivl;      // [R, kK, 2] window-local [lo, hi)
  const int32_t* s2c;      // plain: [R, L] read codes, pad 4
  const uint8_t* s2chr;    // -h: [R, L] read chars, pad 0
  int L;
  const int32_t* lengths;  // [R]
  const int32_t* submat;   // [31, 5, 5]
  const int32_t* pengop;   // -h: [kPengop]
  const int8_t* b2i;       // -h: [256]
  int R;
  int32_t* out;            // out[r]: best, out[ldo + r]: its window column
  int ldo;
};

// Per-CTA shared memory of the -h instantiation only.
template <bool kHp>
struct HpShared {
  int32_t pengop[kPengop];
  int8_t b2i[256];
  uint8_t hprs[kLMax];     // start row of the read run holding each row
  uint8_t pidx[kLMax];     // min(run length - 1, 10): its discount slot
  int32_t hcarry[kLMax];   // per DP row: the carry's fifth value (a run's first row)
  // lane-major (band_dp.cuh's lane_major): a column's hp_col source, the byte
  // offset of its column in a staged row, and minus the distance cost to it
  uint16_t hsrc[kSlice];
  int32_t hneg[kSlice];
  int32_t row[2][kSlice];  // the row before the current read run, by run parity
};
template <>
struct HpShared<false> {};

template <bool kHp>
struct __align__(16) Shared {
  int4 carry[kLMax];         // per DP row: CTA k - 1's carry into this CTA
  int4 xch[2][kWarpsC];      // per row parity and warp: (total, prefix two
                             // columns before its end, last row-gap max, last value)
  unsigned long long full[kLMax];  // per DP row: mbarrier, the carry has landed
  int2 tab[kDepth * 5 * kCodes];  // band_dp.cuh's fill_table
  int2 amax[kWarpsC];        // per warp: (best, column)
  int2 cta_best[kC];         // CTA 0: each CTA's (best, column)
  Runs runs;                 // the row's band
  int32_t n, nband;
  uint8_t chr[kLMax];        // read codes 0..4 (-h: read chars)
  HpShared<kHp> hp;
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One value into CTA ``cta``'s copy of ``slot`` (ordered before the carry's
// arrival by its release).
__device__ __forceinline__ void send_int(int32_t* slot, int cta, int v) {
  uint32_t rs;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rs) : "r"(smem(slot)), "r"(cta));
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(rs), "r"(v) : "memory");
}

// The carry of one DP row into CTA ``cta``'s slot and its arrival on that
// CTA's barrier of the row, ordered after the store at cluster scope.
__device__ __forceinline__ void send_carry(int4* slot, unsigned long long* bar, int cta,
                                           int4 v) {
  uint32_t rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rs) : "r"(smem(slot)), "r"(cta));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(smem(bar)), "r"(cta));
  asm volatile("st.shared::cluster.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(rs), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(rb)
               : "memory");
}

// Wait until this CTA's barrier of a DP row has completed its first phase.
__device__ __forceinline__ void wait_carry(unsigned long long* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(0)
        : "memory");
  } while (!done);
}

template <bool kHp>
__global__ void __launch_bounds__(kThreads, 1) dp_strand_kernel(Args a) {
  __shared__ Shared<kHp> sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank();
  const int e = blockIdx.x / kC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int L = a.L;

  fill_table(sh.tab, a.submat, tid, kThreads);
  for (int i = tid; i < kLMax; i += kThreads)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(&sh.full[i])), "r"(1)
                 : "memory");
  if constexpr (kHp) {
    for (int i = tid; i < 256; i += kThreads) sh.hp.b2i[i] = a.b2i[i];
    if (tid < kPengop) sh.hp.pengop[tid] = a.pengop[tid];
    // ---- the read's chars and runs (warp 1)
    if (warp == 1) {
      for (int r = lane; r < L; r += 32) sh.chr[r] = a.s2chr[(int64_t)e * L + r];
      __syncwarp();
      hp_read_runs(sh.chr, L, sh.hp.hprs, sh.hp.pidx, lane);
    }
  } else {
    for (int r = tid; r < L; r += kThreads) sh.chr[r] = read_code(a.s2c[(int64_t)e * L + r]);
  }
  // ---- the band (warp 0): intervals sorted by rank, then joined into runs
  if (warp == 0) {
    int nband;
    const int n = band_runs(a.ivl, e, sh.runs, lane, nband);
    if (lane == 0) {
      sh.n = n;
      sh.nband = nband;
    }
  }
  // every CTA's barriers are ready before any carry is sent to it
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  cluster.sync();
  const int n = sh.n, nband = sh.nband;
  if (nband > kStrand) {  // every CTA of the cluster leaves here
    if (k == 0 && tid == 0) {
      a.out[e] = HIM;
      a.out[a.ldo + e] = -1;
    }
    return;
  }

  // ---- this thread's band columns ------------------------------------------
  const int len = a.lengths[e];
  int last = len - 1;  // a last row outside [0, L) keeps row 0
  if (last < 0 || last >= L) last = 0;
  const int wlo = a.win_lo[e];
  const int64_t sbase = (int64_t)a.strand[e] * a.wtot;
  const int slice0 = k * kSlice;
  const int k0 = slice0 + tid * kCPL;
  const int wbase = warp * 32 * kCPL;  // this warp's first column in the -h arrays
  const bool sender = k + 1 < kC && tid == kThreads - 1;

  int woff[kCPL], gadd[kCPL], ncost[kCPL];  // band_dp.cuh's column_terms
  HpCols<kCPL> hpc;                         // -h: band_dp.cuh's hp_column
  uint32_t hrm[kW];  // -h: as 0x80 flags, the columns whose source precedes the slice
  unsigned mbits = 0;
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    int c;
    bool in;
    const bool open = band_column(sh.runs, n, nband, k0 + j, wlo, a.wtot, c, in);
    mbits |= (unsigned)open << j;
    const int gc = wlo + c;
    column_terms(c, open, in ? a.refs[sbase + gc] : 4, woff[j], gadd[j], ncost[j]);
    if constexpr (kHp) {
      const int hrun = in ? a.hpcs[sbase + gc] : 0;
      const int src =
          hp_column(hpc, j, sh.runs, n, open, c, wlo, in ? a.refchr[sbase + gc] : 0, hrun);
      if ((j & 3) == 0) hrm[j >> 2] = 0;
      if (src >= 0 && src < slice0) hrm[j >> 2] |= 0x80u << (8 * (j & 3));
      sh.hp.hsrc[wbase + j * 32 + lane] =
          (uint16_t)lane_major<kCPL>(src >= slice0 ? src - slice0 : 0);
      sh.hp.hneg[wbase + j * 32 + lane] = -GEP * (gc - hrun);
    }
  }
  // -h, the sender: where the fifth value of the carry into the next CTA
  // comes from, the source of the reference run open at the next slice's
  // first column: its byte offset in this CTA's staged row, -2 where it
  // precedes this slice too (the value this CTA received), -1 where it has
  // none
  int nsrc = -1;
  if constexpr (kHp) {
    if (sender) {
      int c;
      bool in;
      band_column(sh.runs, n, nband, slice0 + kSlice, wlo, a.wtot, c, in);
      const int hrun = in ? a.hpcs[sbase + wlo + c] : 0;
      if (in && hrun > 0 && hrun - 1 >= wlo && is_open(sh.runs, n, hrun - 1 - wlo)) {
        const int s = band_of(sh.runs, n, hrun - 1 - wlo);
        nsrc = s >= slice0 ? lane_major<kCPL>(s - slice0) : -2;
      }
    }
  }
  // origin kk counts where band column kk + 2 is open; band column 0 always
  unsigned nbits = __shfl_down_sync(FULL, mbits, 1);
  if (lane == 31) {
    nbits = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = k0 + kCPL + j;
      nbits |= (unsigned)(kk < nband && is_open(sh.runs, n, col_of(sh.runs, n, kk))) << j;
    }
  }
  gate_origins(gadd, mbits, nbits, k0 == 0);

  // ---- row 0 -------------------------------------------------------------
  auto trow_of = [&](int row) {
    int x = sh.chr[row];
    if constexpr (kHp) x = hp_code(sh.hp.b2i, x);
    return table_row(sh.tab, row, len, x);
  };
  int prev[kCPL], prev2[kCPL], rbest[kCPL];
  first_row(trow_of(0), woff, prev, prev2, rbest);
  // -h, hp_row: the staged column left of this thread's first column, from
  // this warp's first column on (band column 0 takes none: thread 0 of CTA
  // 0 reads some column of its own instead); thread 0 of a later CTA keeps
  // its left neighbour in a register (left_hold)
  const int left0 = lane != 0 ? wbase + (kCPL - 1) * 32 + lane - 1 : (warp != 0 ? wbase - 1 : 0);
  const bool left_reg = tid == 0 && k > 0;
  int par = 0, left_hold = HIM;  // -h: the staged row's buffer; the left neighbour

  // ---- rows 1 .. last ----------------------------------------------------
  // One row: P holds row - 1, Q row - 2; the new row replaces Q.
  auto do_row = [&](const int row, int (&P)[kCPL], int (&Q)[kCPL]) {
    const char* trow = trow_of(row);
    const int start_new = -(GOP + GEP * (row + 1));
    // no row gap ends on row 1: its cost there sinks the candidate
    const int neg_grow = row >= 2 ? -(GOP + GEP * (row - 1)) : kGate;

    // -h: which candidate this row may take (row-uniform), the columns that
    // take it as 0x80 flags, and on a read run's first row the row before
    // it staged into the other buffer (the exchange barrier below orders
    // the staging before the reads)
    HpKind hk{false, false, 0};
    uint32_t hit[kW];
    const int32_t* srow = nullptr;
    if constexpr (kHp) {
      hk = hp_kind(sh.hp.hprs[row], sh.hp.pidx[row], row, sh.hp.pengop);
      hp_hits(hpc, sh.chr[row], hk.col, hit);
      par ^= (int)hk.col;
      srow = sh.hp.row[par];
      if (hk.col) hp_stage(sh.hp.row[par] + wbase, P, lane);
    }

    // column gaps: the prefix over this thread's columns, then the warp's
    int rl[kCPL];
    int excl, pre_m2;
    const int tot = warp_prefix(gap_prefix(P, gadd, rl), rl, lane, excl, pre_m2);
    row_gaps(Q, row, rbest);

    int rb_m1 = __shfl_up_sync(FULL, rbest[kCPL - 1], 1);
    int pv_m1 = __shfl_up_sync(FULL, P[kCPL - 1], 1);

    // the CTA's warps, then the slices before this CTA's (the carry; band
    // column 0 has no neighbours: its base is the restart value itself)
    int4* xs = sh.xch[row & 1];
    if (lane == 31)
      xs[warp] = make_int4(tot, max(rl[kCPL - 2], excl), rbest[kCPL - 1], P[kCPL - 1]);
    __syncthreads();
    int4 cin = make_int4(LOW, LOW, HIM, start_new);
    int hcv = HIM;  // -h: the carry's fifth value
    if (k > 0) {
      wait_carry(&sh.full[row]);
      cin = sh.carry[row];
      if constexpr (kHp) {
        if (hk.col) hcv = sh.hp.hcarry[row];
      }
    }
    int before = cin.x, before_prev = cin.x;
#pragma unroll
    for (int v = 0; v < kWarpsC - 1; ++v) {
      if (v < warp) {
        before_prev = before;
        before = max(before, xs[v].x);
      }
    }
    if (sender) {
      // the carry into the next CTA: its prefix, the prefix two columns
      // before its slice, this slice's last column, and under -h on a read
      // run's first row the staged row at the next slice's hp_col source
      const int4 me = xs[warp];
      if constexpr (kHp) {
        if (hk.col)
          send_int(&sh.hp.hcarry[row], k + 1,
                   nsrc >= 0 ? *(const int32_t*)((const char*)srow + nsrc)
                             : (nsrc == -2 ? hcv : HIM));
      }
      send_carry(&sh.carry[row], &sh.full[row], k + 1,
                 make_int4(max(before, me.x), max(before, me.y), me.z, me.w));
    }
    excl = max(excl, before);
    if (lane != 0) {
      pre_m2 = max(pre_m2, before);
    } else if (warp == 0) {
      pre_m2 = cin.y;
      rb_m1 = cin.z;
      pv_m1 = cin.w;
    } else {
      const int4 p = xs[warp - 1];
      pre_m2 = max(before_prev, p.y);
      rb_m1 = p.z;
      pv_m1 = p.w;
    }
    // -h: the previous slice's last column of the row before the run
    if constexpr (kHp) {
      if (left_reg && hk.col) left_hold = cin.w;
    }

    // The cells, in one straight-line variant per kind of row (0: no -h
    // candidate, 1: hp_col, 2: hp_row), picked by a row-uniform branch.
    // The -h arrays come in as a parameter, so that the plain
    // instantiation, which has none, does not look their members up.
    auto cells = [&](auto kind, auto& hp) {
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
            const bool remote = hrm[j >> 2] & (0x80u << (8 * (j & 3)));
            const int src = remote ? hcv
                                   : *(const int32_t*)((const char*)srow +
                                                       hp.hsrc[wbase + j * 32 + lane]);
            cand = src + hp.hneg[wbase + j * 32 + lane] + hk.neg_pen;
          } else {
            // the column to the left
            cand = (j >= 1 ? srow[wbase + (j - 1) * 32 + lane]
                           : (left_reg ? left_hold : srow[left0])) +
                   hk.neg_pen;
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
      (void)hcv;
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
  if (lane == 0) sh.amax[warp] = make_int2(bv, bc);
  __syncthreads();
  if (tid == 0) {
    for (int v = 1; v < kWarpsC; ++v) take_better(sh.amax[v].x, sh.amax[v].y, bv, bc);
    *cluster.map_shared_rank(&sh.cta_best[k], 0) = make_int2(bv, bc);
  }
  // CTA 0 reads every CTA's; no CTA leaves while its shared memory is read
  cluster.sync();
  if (k == 0 && tid == 0) {
    for (int v = 1; v < kC; ++v) take_better(sh.cta_best[v].x, sh.cta_best[v].y, bv, bc);
    a.out[e] = bv;
    a.out[a.ldo + e] = bc;
  }
}

template <bool kHp>
int launch(const Args& a, void* stream) {
  if (a.R <= 0) return 0;
  if (a.L < 1 || a.L > kLMax || a.ldo < a.R) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.R * kC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster of 16 is past the portable 8
  cudaError_t err = cudaFuncSetAttribute(dp_strand_kernel<kHp>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, dp_strand_kernel<kHp>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, dp_strand_kernel<kHp>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int fill(const int32_t* c, int count, int32_t* out, int n) {
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}

}  // namespace

// (best, first window column of the best) of each row's last DP row (sg5
// on, the one PSSM submat for every row), its band columns scored only, a
// cluster of CTAs a row: out[r] and out[ldo + r] (ldo >= R), int32.  refs
// [2, wtot] int8 codes (the scorer's state); strand [R] int8, win_lo [R]
// int32, ivl [R, 16, 2] int32 window-local intervals, s2c [R, L] int32 read
// codes (pad 4), lengths [R] int32; submat [31, 5, 5] int32.  L at most
// 256.  Returns a CUDA error code: cudaErrorInvalidConfiguration where the
// card admits no cluster of this size.
extern "C" int mia_dp_strand(const void* refs, int wtot, const void* strand,
                             const void* win_lo, const void* ivl, const void* s2c,
                             const void* lengths, const void* submat, int R, int L, void* out,
                             int ldo, void* stream) {
  const Args a{(const int8_t*)refs,    nullptr, nullptr, wtot, (const int8_t*)strand,
               (const int32_t*)win_lo, (const int32_t*)ivl,    (const int32_t*)s2c,
               nullptr,                L,
               (const int32_t*)lengths, (const int32_t*)submat, nullptr, nullptr, R,
               (int32_t*)out,          ldo};
  return launch<false>(a, stream);
}

// The same under -h: (best, first window column of the best) of each row's
// last -h DP row.  refs [2, wtot] int8 codes, refchr [2, wtot] uint8 chars,
// hpcs [2, wtot] int32 run starts (the scorer's state); strand [R] int8,
// win_lo [R] int32, ivl [R, 16, 2] int32 window-local intervals, s2chr [R,
// L] uint8 read chars (pad 0), lengths [R] int32; submat [31, 5, 5] int32,
// pengop [11] int32, b2i [256] int8.  L at most 256.
extern "C" int mia_dp_strand_hp(const void* refs, const void* refchr, const void* hpcs,
                                int wtot, const void* strand, const void* win_lo,
                                const void* ivl, const void* s2chr, const void* lengths,
                                const void* submat, const void* pengop, const void* b2i, int R,
                                int L, void* out, int ldo, void* stream) {
  const Args a{(const int8_t*)refs,     (const uint8_t*)refchr, (const int32_t*)hpcs,
               wtot,                    (const int8_t*)strand,  (const int32_t*)win_lo,
               (const int32_t*)ivl,     nullptr,                (const uint8_t*)s2chr,
               L,                       (const int32_t*)lengths, (const int32_t*)submat,
               (const int32_t*)pengop,  (const int8_t*)b2i,     R,
               (int32_t*)out,           ldo};
  return launch<true>(a, stream);
}

// The compile-time constants, in this order: band columns a row, band
// columns a thread, CTAs a row, threads a CTA, intervals a row, read rows,
// PSSM depth slots, PSSM depth, GOP, GEP, HIM, LOW.  Fills at most n values
// of out; returns how many there are.
extern "C" int mia_dp_strand_constants(int32_t* out, int n) {
  const int32_t c[] = {kStrand, kCPL, kC, kThreads, kK, kLMax, kDepth, kPssmDepth,
                       GOP,     GEP,  HIM, LOW};
  return fill(c, (int)(sizeof(c) / sizeof(c[0])), out, n);
}

// The same for the -h form, then its read-run reach (HPW) and discount
// slots.
extern "C" int mia_dp_strand_hp_constants(int32_t* out, int n) {
  const int32_t c[] = {kStrand, kCPL, kC,  kThreads, kK,   kLMax,  kDepth,
                       kPssmDepth, GOP, GEP, HIM,   LOW, kHpw, kPengop};
  return fill(c, (int)(sizeof(c) / sizeof(c[0])), out, n);
}
