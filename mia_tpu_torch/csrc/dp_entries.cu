// Fused banded semi-global DP scorer for scoring entries (Hopper, sm_90a).
//
// Replaces mia_tpu/ops/dp_pallas.py::_dp_kernel (launched by
// pallas_last_row) together with the XLA prologue and epilogue around it in
// mia_tpu/core/jax_engine.py::_entries_core and, as the kHp instantiation,
// the -h program mia_tpu/ops/dp_jax.py::batch_last_row_hp with its set-up
// jax_engine._entries_core_hp.  One launch scores a batch of entries: window
// gather from the two padded reference strands, interval -> band mask,
// per-row PSSM lookup, the DP rows 1..len-1, and the earliest argmax of the
// last row.  Only (best, aec) leaves the kernel, and they equal those of
// mia_tpu_torch/ops/dp_torch.py::entries_core_plain / entries_core_hp_plain
// bit for bit (int32, restart only on a strict >).
//
// What bounds it: the integer pipe's instruction count per DP cell, not
// bytes.  An entry reads a few hundred bytes (384 window codes, 16
// intervals, 256 read codes) and writes 8; a cell of the recurrence is
// three gap candidates, a 3-way max, a restart test and a score lookup.
// The design spends as few integer instructions per cell as the card allows
// and moves the lookup to the load/store pipe: the row loop is 366 SASS
// instructions for two rows of 12 cells, 15.25 a cell (cuobjdump through
// mia_tpu_torch/utils/sass.py; 35.2 with selects for the masks, compares for
// the score and a max beside every add), and one E = 16,384 batch of
// 256-row entries takes 0.78 ms on an H100 80GB HBM3 at 700 W (1.76 ms
// before), 128 registers, no spills, two blocks an SM:
//   * one warp per entry; lane l owns columns [12 l, 12 l + 12) and keeps
//     the last two rows and the running row-gap max for them in registers;
//     the row loop is unrolled by two so the two rows swap roles in place;
//   * Hopper's DPX instructions (__viaddmax_s32: max(a + b, c)) do each
//     running max with its add in one instruction: the column-gap prefix,
//     the row-gap update and both gap costs of the 3-way max;
//   * the column-gap prefix runs in lane-local coordinates (GEP * j, an
//     immediate), a 5-step __shfl_up_sync scan joins the lane totals, and
//     the gap costs become immediates too;
//   * the substitution score of a cell is one shared-memory load: both
//     PSSMs are laid out [matrix][depth][read code][window code], a row's
//     base address is the same for the whole warp (a broadcast of at most
//     5 words), and a column's byte offset stays in a register;
//   * the masks are folded into data.  A closed column carries a per-column
//     addend of HIM into its cell (one 3-input add), so closed cells stay
//     near HIM without a select; a column-gap origin that may not count
//     carries an addend of -2^29 in place of GEP * j; the row-gap max needs
//     no mask at all, because only the closed column to its right reads it.
//     Sentinel-derived values stay below every live value (a restart,
//     >= -(GOP + GEP * 257), beats them) and above INT_MIN (HIM = -2^30 and
//     LOW = -1.5 * 2^30 leave 2^29 of room), and the exact HIM of a closed
//     column is restored on the last row, before the argmax;
//   * column 0 (always cell + restart) is lane 0's diagonal input set to the
//     restart value, row 1 (no row gap yet) a gap cost of 2^29: no per-cell
//     special cases;
//   * each warp stops at its own last row (len - 1), so there is no length
//     sort or per-block row bound as on the TPU's sequential grid.
//
// The -h candidates (src/mia.c:883-905) add per row:
//   * hp_col, on the first row of each read homopolymer run: the previous
//     row at the column before the reference run's start, minus a distance
//     cost.  Source offset and cost are fixed per column: the prologue puts
//     them into per-warp shared arrays, the previous row is staged in a
//     per-warp shared-memory row (1.5 KB) and gathered from there;
//   * under -h the shared-memory pipe, not the integer pipe, would set the
//     pace if a lane read its 12 columns at a stride of 12 words (4-way bank
//     conflicts on every access: 2.07 ms a batch).  The staged row and the
//     per-column arrays are lane-major instead (column 12 l + j at word
//     j * 32 + l): a warp's access to its columns j is 32 consecutive words,
//     and the gather, a few columns to the left, lands in the bank of its
//     own lane or the one before: 1.22 ms a batch (2.86 ms before the
//     redesign), 128 registers, no spills;
//   * hp_row, on the later rows of a run: the row before the run started.
//     The TPU kept a ring of the last 32 rows for it; here it is the same
//     staged row, which no row writes again until the next run starts.  The
//     ring's reach stays as a guard (row - run start < 32), so reads with
//     longer runs score as on the TPU;
//   * the row is staged only when something can read it: the run goes on,
//     or some column of the warp takes an hp_col candidate on this row;
//   * a row's candidates are whole-row (run start or not), so the branch is
//     warp-uniform.  Which columns take one is a bit test: the window chars
//     stay packed four to a register, one xor and a zero-byte test per word
//     compare them with the row's char, and the columns that can take a
//     candidate at all sit in the same byte layout.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

// Duplicates of the Python side's values (jax_engine, mia_tpu.constants,
// dp_torch._LOW); mia_dp_entries_constants exports them so that the loader
// (torchcfg.kernel_library) refuses a library that disagrees.
constexpr int kW = 384;              // window width (jax_engine.WIN_W)
constexpr int kCPL = kW / 32;        // columns per lane
constexpr int kK = 16;               // intervals per entry (MAX_INTERVALS)
constexpr int kLMax = 256;           // read rows (jax_engine.L_MAX)
constexpr int kWarps = 8;            // entries per block
constexpr int kPssmDepth = 15;       // constants.PSSM_DEPTH
constexpr int kDepth = 2 * kPssmDepth + 1;  // PSSM depth slots
constexpr int kSms = 2 * kDepth * 25;
constexpr int kHpw = 32;             // -h row reach (jax_engine.HPW_ROUTE)
constexpr int kPengop = 11;          // -h gap-open discounts (hp_pengop_table)
constexpr int GOP = 1000;
constexpr int GEP = 200;
constexpr int HIM = -1073741824;                 // INT_MIN / 2
constexpr int LOW = -(1 << 30) - (1 << 29);      // below any live value
constexpr int kGate = -(1 << 29);    // addend that sinks a value below every live one
constexpr unsigned FULL = 0xffffffffu;

// -h inputs: reference chars and run starts [2, WTOT], the discount table,
// the char -> code table.  Null for the plain instantiation.
struct HpArgs {
  const uint8_t* refchr;
  const int32_t* hpcs;
  const int32_t* pengop;
  const int8_t* b2i;
};

// Per-block shared memory of the -h instantiation only.
template <bool kHp>
struct HpShared {
  uint8_t chr[kWarps][kLMax];     // read chars
  uint8_t hprs[kWarps][kLMax];    // start row of the read run holding each row
  uint8_t pidx[kWarps][kLMax];    // min(run length - 1, 10): pengop slot
  // The per-column arrays are lane-major: column c = 12 l + j sits at
  // j * 32 + l, so the 32 lanes of a warp, each on its own column j, touch
  // 32 consecutive words (no bank conflict), and a gather from a column a
  // little to the left lands in the bank of its own lane or the one before.
  uint16_t hsrc[kWarps][kW];      // hp_col: byte offset of the source column in row[]
  int32_t hneg[kWarps][kW];       // hp_col: minus the distance cost to that column
  int32_t row[kWarps][kW];        // the row before the current run, staged
  int32_t pengop[kPengop];
  int8_t b2i[256];
};
template <>
struct HpShared<false> {};

// Bit 7 of every byte of x says whether the byte is zero (exact: no carry
// crosses a byte); the other bits are left for the caller's mask to clear.
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x);
}

// Two blocks per SM (16 warps): both instantiations are held to 128
// registers; ptxas's report (build.log) says what that costs in spills.
template <bool kHp>
__global__ void __launch_bounds__(kWarps * 32, 2)
dp_entries_kernel(const int8_t* __restrict__ refs, int wtot,
                  const int32_t* __restrict__ sms, HpArgs hp,
                  const int8_t* __restrict__ ref_sel,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ ivl,
                  const int8_t* __restrict__ s2x, int L,
                  const int32_t* __restrict__ lengths,
                  const int8_t* __restrict__ smidx,
                  int32_t* __restrict__ out, int E) {
  // score table [matrix][depth][read code][window code]: sms transposed in
  // its last two axes, so that a row's five scores are consecutive words
  __shared__ int32_t sh_tab[kSms];
  __shared__ int8_t sh_s2c[kWarps][kLMax];
  __shared__ HpShared<kHp> sh;

  for (int i = threadIdx.x; i < kSms; i += blockDim.x) {
    const int code = i % 5, w = (i / 5) % 5, md = i / 25;
    sh_tab[(md * 5 + code) * 5 + w] = sms[i];
  }
  if constexpr (kHp) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sh.b2i[i] = hp.b2i[i];
    for (int i = threadIdx.x; i < kPengop; i += blockDim.x) sh.pengop[i] = hp.pengop[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= E) return;  // whole warp leaves together; no block barrier follows

  // ---- prologue: read codes, window codes, band mask ----------------------
  // s2x holds read codes, or under -h the read's raw chars (codes via b2i)
  for (int r = lane; r < L; r += 32) {
    if constexpr (kHp) {
      const uint8_t ch = (uint8_t)s2x[(int64_t)e * L + r];
      sh.chr[warp][r] = ch;
      sh_s2c[warp][r] = sh.b2i[ch];
    } else {
      sh_s2c[warp][r] = s2x[(int64_t)e * L + r];
    }
  }
  __syncwarp();

  const int len = lengths[e];
  // a read whose last row lies outside [0, L) keeps row 0 (the scan never
  // reaches its snapshot row)
  int last = len - 1;
  if (last < 0 || last >= L) last = 0;
  const int32_t* tab = sh_tab + (smidx[e] ? kDepth * 25 : 0);
  const int c0 = lane * kCPL;
  const int goff = GEP * c0;  // lane-local column-gap coordinates to the window's
  const int ws = starts[e];
  const int64_t wbase = (int64_t)ref_sel[e] * wtot + ws;
  const int64_t wmax = 2 * (int64_t)wtot - 1;

  int woff[kCPL];  // byte offset of the column's window code in a table row
  // -h: window chars (4 per word); as 0x80 flags in the same byte layout,
  // the columns that start a reference run (hp_row) and those whose run
  // start is an hp_col origin inside the window
  uint32_t wchr[kCPL / 4], hrb[kCPL / 4], hcb[kCPL / 4];
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    int64_t g = wbase + c0 + j;
    g = g < 0 ? 0 : (g > wmax ? wmax : g);
    woff[j] = 4 * refs[g];
    if constexpr (kHp) {
      const uint32_t ch = hp.refchr[g];
      if ((j & 3) == 0) wchr[j >> 2] = hrb[j >> 2] = hcb[j >> 2] = 0;
      wchr[j >> 2] |= ch << (8 * (j & 3));
      const int hc = hp.hpcs[g];
      const int gcol = ws + c0 + j;
      const uint32_t flag = 0x80u << (8 * (j & 3));
      if (hc == gcol && c0 + j >= 1) hrb[j >> 2] |= flag;
      // column 0 is always cell + restart: it takes no candidate
      if (hc != gcol && hc > 0 && hc - 1 >= ws && c0 + j >= 1) hcb[j >> 2] |= flag;
      int idx = hc - 1 - ws;
      idx = idx < 0 ? 0 : (idx > kW - 1 ? kW - 1 : idx);
      sh.hsrc[warp][j * 32 + lane] = (uint16_t)(4 * ((idx % kCPL) * 32 + idx / kCPL));
      sh.hneg[warp][j * 32 + lane] = -GEP * (gcol - hc);
    }
  }
  unsigned mbits = 0;
  const int32_t* iv = ivl + (int64_t)e * kK * 2;
  for (int k = 0; k < kK; ++k) {
    const int lo = iv[2 * k], hi = iv[2 * k + 1];
#pragma unroll
    for (int j = 0; j < kCPL; ++j)
      if (c0 + j >= lo && c0 + j < hi) mbits |= 1u << j;
  }
  // A column-gap origin at c counts only if c + 2 is open (past the window's
  // end: closed; column 0 always counts).  gadd is what the origin adds to
  // its value for the running max: GEP * j, or kGate where it may not count.
  // kadd is what a column adds to its cell: 0, or HIM where it is closed.
  unsigned nbits = __shfl_down_sync(FULL, mbits, 1);
  if (lane == 31) nbits = 0;
  const unsigned cand_ok = ((mbits | (nbits << kCPL)) >> 2) | (lane == 0 ? 1u : 0u);
  int gadd[kCPL], kadd[kCPL];
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    gadd[j] = (cand_ok >> j) & 1u ? GEP * j : kGate;
    kadd[j] = (mbits >> j) & 1u ? 0 : HIM;
  }

  if constexpr (kHp) {
    // read runs (dp_jax.batch_last_row_hp's hprs / hprl) over all L rows:
    // a row starts a run when its char differs from the row before; a run
    // ends where the next char differs.  One ballot per 32-row chunk finds
    // the nearest start at or before each row (forward) and the nearest end
    // at or after it (backward); the carry links the chunks.
    int carry = 0;
    for (int base = 0; base < L; base += 32) {
      const int r = base + lane;
      const bool changed = r >= L || r == 0 || sh.chr[warp][r] != sh.chr[warp][r - 1];
      const unsigned m = __ballot_sync(FULL, changed) & (FULL >> (31 - lane));
      const int hs = m ? base + 31 - __clz(m) : carry;
      if (r < L) sh.hprs[warp][r] = (uint8_t)hs;
      carry = __shfl_sync(FULL, hs, 31);
    }
    carry = L - 1;
    for (int base = ((L - 1) / 32) * 32; base >= 0; base -= 32) {
      const int r = base + lane;
      const bool ends = r >= L - 1 || sh.chr[warp][r + 1] != sh.chr[warp][r];
      const unsigned m = __ballot_sync(FULL, ends) & (FULL << lane);
      const int he = m ? base + __ffs(m) - 1 : carry;
      if (r < L) {
        const int run = he - sh.hprs[warp][r] + 1;
        sh.pidx[warp][r] = (uint8_t)(run < 1 ? 0 : (run > kPengop ? kPengop - 1 : run - 1));
      }
      carry = __shfl_sync(FULL, he, 0);
    }
    __syncwarp();
  }

  // ---- row 0 -------------------------------------------------------------
  int prev[kCPL], prev2[kCPL], rbest[kCPL];
  {
    const char* trow = (const char*)(tab + sh_s2c[warp][0] * 5);
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      prev[j] = (mbits >> j) & 1u ? *(const int32_t*)(trow + woff[j]) : HIM;
      prev2[j] = LOW;
      rbest[j] = prev[j];
    }
  }

  // ---- rows 1 .. last ----------------------------------------------------
  // One row: P holds row - 1, Q row - 2; the new row replaces Q.
  auto do_row = [&](const int row, int (&P)[kCPL], int (&Q)[kCPL]) {
    const int code = sh_s2c[warp][row];
    const int from_back = len - (row + 1);
    int d = row < kPssmDepth ? row
                             : (from_back < kPssmDepth ? 2 * kPssmDepth - from_back : kPssmDepth);
    d = d < 0 ? 0 : (d > 2 * kPssmDepth ? 2 * kPssmDepth : d);
    const char* trow = (const char*)(tab + (d * 5 + code) * 5);
    const int start_new = -(GOP + GEP * (row + 1));
    // no row gap ends on row 1: its cost there sinks the candidate
    const int neg_grow = row >= 2 ? -(GOP + GEP * (row - 1)) : kGate;

    // -h: which candidate this row may take (warp-uniform), and the columns
    // that take it as 0x80 flags
    bool hp_col_row = false, hp_row_row = false;
    int neg_pen = 0;
    uint32_t hit[kCPL / 4];
    if constexpr (kHp) {
      const int hs = sh.hprs[warp][row];
      const int slot = sh.pidx[warp][row];
      hp_col_row = hs == row;
      hp_row_row = hs != row && hs > 0 && row - hs < kHpw;
      neg_pen = -sh.pengop[slot];
      const uint32_t ch4 = sh.chr[warp][row] * 0x01010101u;
      uint32_t any = 0;
#pragma unroll
      for (int k = 0; k < kCPL / 4; ++k) {
        hit[k] = zero_bytes(wchr[k] ^ ch4) & (hp_col_row ? hcb[k] : hrb[k]);
        any |= hit[k];
      }
      // the row before this run: hp_col's source now, hp_row's on the run's
      // later rows
      if (hp_col_row && (slot > 0 || __any_sync(FULL, any != 0))) {
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kCPL; ++j) sh.row[warp][j * 32 + lane] = P[j];
        __syncwarp();
      }
    }

    // column gaps: inclusive prefix max of prev[c] + GEP * c over the origins
    // that count, in lane-local coordinates (less GEP * c0)
    int rl[kCPL];
    int run = LOW;
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      run = __viaddmax_s32(P[j], gadd[j], run);
      rl[j] = run;
    }
    int tot = run + goff;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      tot = max(tot, __shfl_up_sync(FULL, tot, off));  // a lane below off reads itself
    int excl = __shfl_up_sync(FULL, tot, 1) - goff;
    if (lane == 0) excl = LOW;
    // the prefix two columns back of this lane's first column, in the
    // previous lane's coordinates
    int pre_m2 = __shfl_up_sync(FULL, max(rl[kCPL - 2], excl), 1);

    // row gaps: running per-column max over rows <= row - 2
    const int add = GEP * (row - 2);
#pragma unroll
    for (int j = 0; j < kCPL; ++j) rbest[j] = __viaddmax_s32(Q[j], add, rbest[j]);

    // previous lane's last column for the shifted reads; column 0 has no
    // neighbours: its base is the restart value itself
    int rb_m1 = __shfl_up_sync(FULL, rbest[kCPL - 1], 1);
    int pv_m1 = __shfl_up_sync(FULL, P[kCPL - 1], 1);
    if (lane == 0) {
      pre_m2 = LOW;
      rb_m1 = HIM;
      pv_m1 = start_new;
    }

    // The cells, in one straight-line variant per kind of row (0: no -h
    // candidate, 1: hp_col, 2: hp_row), picked by a warp-uniform branch.
    // The -h loads are unconditional (the source offset is always inside
    // the staged row); whether the cell takes the candidate is a select.
    // The -h arrays come in as a parameter, so that the plain instantiation,
    // which has none, does not look their members up.
    auto cells = [&](auto kind, auto& hs) {
      constexpr int kKind = decltype(kind)::value;
#pragma unroll
      for (int j = 0; j < kCPL; ++j) {
        // gap_col = prefix[c - 2] - (GOP + GEP * (c - 1)), lane-local
        const int pre = j >= 2 ? max(rl[j - 2], excl) : (j == 1 ? excl : pre_m2);
        const int col_cost = j >= 1 ? -(GOP + GEP * (j - 1)) : -(GOP + GEP * (kCPL - 1));
        const int diag = j >= 1 ? P[j - 1] : pv_m1;
        int base = __viaddmax_s32(pre, col_cost, diag);
        base = __viaddmax_s32(j >= 1 ? rbest[j - 1] : rb_m1, neg_grow, base);
        if constexpr (kHp && kKind != 0) {
          const bool takes = hit[j >> 2] & (0x80u << (8 * (j & 3)));
          int cand;
          if constexpr (kKind == 1) {
            const int src = *(const int32_t*)((const char*)hs.row[warp] +
                                              hs.hsrc[warp][j * 32 + lane]);
            cand = src + hs.hneg[warp][j * 32 + lane] + neg_pen;
          } else {
            // the column to the left; column 0 takes none: lane 0 reads
            // some column of its own instead
            cand = hs.row[warp][j >= 1 ? (j - 1) * 32 + lane
                                       : (kCPL - 1) * 32 + lane - (lane != 0)] + neg_pen;
          }
          base = max(base, takes ? cand : HIM);
        }
        const int cell = *(const int32_t*)(trow + woff[j]);
        bool keeps;  // base >= start_new: no restart
        const int m = __vibmax_s32(base, start_new, &keeps);
        Q[j] = m + (keeps ? cell : 0) + kadd[j];
      }
    };
    if (hp_col_row) cells(std::integral_constant<int, 1>{}, sh);
    else if (hp_row_row) cells(std::integral_constant<int, 2>{}, sh);
    else cells(std::integral_constant<int, 0>{}, sh);
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

  // ---- epilogue: best value, earliest column ------------------------------
#pragma unroll
  for (int j = 0; j < kCPL; ++j)
    if (!((mbits >> j) & 1u)) prev[j] = HIM;
  int bv = prev[0], bc = c0;
#pragma unroll
  for (int j = 1; j < kCPL; ++j)
    if (prev[j] > bv) { bv = prev[j]; bc = c0 + j; }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, bv, off);
    const int oc = __shfl_xor_sync(FULL, bc, off);
    if (ov > bv || (ov == bv && oc < bc)) { bv = ov; bc = oc; }
  }
  if (lane == 0) {
    out[e] = bv;
    out[E + e] = bc;
  }
}

template <bool kHp>
int launch(const void* refs, int wtot, const void* sms, HpArgs hp, const void* ref_sel,
           const void* starts, const void* ivl, const void* s2x, int L,
           const void* lengths, const void* smidx, void* out, int E, void* stream) {
  if (E <= 0) return 0;
  if (L < 1 || L > kLMax) return (int)cudaErrorInvalidValue;
  const int blocks = (E + kWarps - 1) / kWarps;
  dp_entries_kernel<kHp><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)refs, wtot, (const int32_t*)sms, hp, (const int8_t*)ref_sel,
      (const int32_t*)starts, (const int32_t*)ivl, (const int8_t*)s2x, L,
      (const int32_t*)lengths, (const int8_t*)smidx, (int32_t*)out, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mia_dp_entries(const void* refs, int wtot, const void* sms,
                              const void* ref_sel, const void* starts,
                              const void* ivl, const void* s2c, int L,
                              const void* lengths, const void* smidx, void* out,
                              int E, void* stream) {
  return launch<false>(refs, wtot, sms, HpArgs{}, ref_sel, starts, ivl, s2c, L,
                       lengths, smidx, out, E, stream);
}

// -h: refchr [2, WTOT] u8, hpcs [2, WTOT] i32, pengop [11] i32, b2i [256] i8,
// s2chr [E, L] u8 raw read chars; the rest as mia_dp_entries.
extern "C" int mia_dp_entries_hp(const void* refs, const void* refchr, const void* hpcs,
                                 int wtot, const void* sms, const void* pengop,
                                 const void* b2i, const void* ref_sel,
                                 const void* starts, const void* ivl, const void* s2chr,
                                 int L, const void* lengths, const void* smidx,
                                 void* out, int E, void* stream) {
  const HpArgs hp{(const uint8_t*)refchr, (const int32_t*)hpcs, (const int32_t*)pengop,
                  (const int8_t*)b2i};
  return launch<true>(refs, wtot, sms, hp, ref_sel, starts, ivl, s2chr, L, lengths,
                      smidx, out, E, stream);
}

// The compile-time constants the kernels were built with, in this order:
// window width, intervals per entry, read rows, PSSM depth slots, PSSM depth,
// GOP, GEP, HIM, LOW, -h row reach, -h discount slots.  Fills at most n
// values of out; returns how many there are.  The loader holds them against
// the Python side's values once.
extern "C" int mia_dp_entries_constants(int32_t* out, int n) {
  const int32_t c[] = {kW, kK, kLMax, kDepth, kPssmDepth, GOP, GEP, HIM, LOW, kHpw, kPengop};
  const int count = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}
