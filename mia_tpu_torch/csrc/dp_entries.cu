// Fused banded semi-global DP scorer for scoring entries (Hopper, sm_90a).
//
// Replaces mia_tpu/ops/dp_pallas.py::_dp_kernel (launched by
// pallas_last_row) together with the XLA prologue and epilogue around it in
// mia_tpu/core/jax_engine.py::_entries_core and, as the kHp instantiation,
// the -h program mia_tpu/ops/dp_jax.py::batch_last_row_hp with its set-up
// jax_engine._entries_core_hp.  One launch scores a batch of entries: window
// gather from the two padded reference strands, interval -> band mask,
// per-row PSSM lookup, the DP rows 1..len-1, and the earliest argmax of the
// last row.  Integer semantics are those of
// mia_tpu_torch/ops/dp_torch.py::entries_core_plain / entries_core_hp_plain
// (int32, HIM / LOW sentinels, restart only on a strict >), so results agree
// bit for bit.
//
// What bounds it: integer ALU work, not bytes.  A cell costs ~20 int32
// operations (adds, maxes, selects) and an entry reads a few hundred bytes
// (384 window codes, 16 intervals, 256 read codes) and writes 8, so the
// kernel sits far to the compute side of the card's roofline.  The design
// keeps every row in registers and spends no memory traffic per cell:
//   * one warp per entry; lane l owns columns [12 l, 12 l + 12) and keeps
//     prev, prev2, the running row-gap max and the window codes for them in
//     registers, with the band mask as a 12-bit word;
//   * the column-gap prefix max is a serial max inside each lane plus a
//     5-step __shfl_up_sync scan over the lane totals;
//   * the shifts by one and two columns (diagonal, row gap, column gap) take
//     the previous lane's last values by shuffle;
//   * the 5 substitution scores of a row are the same for the whole warp:
//     both PSSMs (6.2 KB) and each warp's read codes sit in shared memory;
//   * each warp stops at its own last row (len - 1), so there is no length
//     sort or per-block row bound as on the TPU's sequential grid.
//
// The -h candidates (src/mia.c:883-905) add per row:
//   * hp_col, on the first row of each read homopolymer run: the previous
//     row at the column before the reference run's start, an index fixed
//     per column that may point into another lane.  That row is staged in a
//     per-warp shared-memory row (1.5 KB) and gathered from there;
//   * hp_row, on the later rows of a run: the row before the run started.
//     The TPU kept a ring of the last 32 rows for it; here it is the same
//     staged row, which no row writes again until the next run starts.  The
//     ring's reach stays as a guard (row - run start < 32), so reads with
//     longer runs score as on the TPU;
//   * both apply to whole rows (run start or not), so the branch is per row
//     and warp-uniform.  The read's run starts and lengths come from its
//     chars in the prologue (ballot scans over 32-row chunks); the window
//     chars stay packed four to a register, the columns' run starts and
//     the read's run arrays in shared memory.
#include <cstdint>
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
  int32_t hcs[kWarps][kW];        // window columns' reference run starts
  int32_t row[kWarps][kW];        // prev, staged on each run's first row
  int32_t pengop[kPengop];
  int8_t b2i[256];
};
template <>
struct HpShared<false> {};

__device__ __forceinline__ int sub_for(int code, int s0, int s1, int s2, int s3, int s4) {
  int v = s4;
  v = code == 0 ? s0 : v;
  v = code == 1 ? s1 : v;
  v = code == 2 ? s2 : v;
  v = code == 3 ? s3 : v;
  return v;
}

// Two blocks per SM: the plain instantiation fits in 126 registers anyway;
// the -h one would take 163 and leave one block per SM, and capped at 128
// (a few spilled bytes) it runs 1.6x faster on an H100 (PERF.md).
template <bool kHp>
__global__ void __launch_bounds__(kWarps * 32, kHp ? 2 : 1)
dp_entries_kernel(const int8_t* __restrict__ refs, int wtot,
                  const int32_t* __restrict__ sms, HpArgs hp,
                  const int8_t* __restrict__ ref_sel,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ ivl,
                  const int8_t* __restrict__ s2x, int L,
                  const int32_t* __restrict__ lengths,
                  const int8_t* __restrict__ smidx,
                  int32_t* __restrict__ out, int E) {
  __shared__ int32_t sh_sms[kSms];
  __shared__ int8_t sh_s2c[kWarps][kLMax];
  __shared__ HpShared<kHp> sh;

  for (int i = threadIdx.x; i < kSms; i += blockDim.x) sh_sms[i] = sms[i];
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
  const int32_t* sm = sh_sms + (smidx[e] ? kDepth * 25 : 0);
  const int c0 = lane * kCPL;
  const int ws = starts[e];
  const int64_t wbase = (int64_t)ref_sel[e] * wtot + ws;
  const int64_t wmax = 2 * (int64_t)wtot - 1;

  int win[kCPL];
  // -h: window chars (4 per word), columns that start a reference run
  // (hp_row), columns whose run start is an hp_col origin inside the window
  uint32_t wchr[kCPL / 4];
  unsigned hr_bits = 0, hc_bits = 0;
#pragma unroll
  for (int j = 0; j < kCPL; ++j) {
    int64_t g = wbase + c0 + j;
    g = g < 0 ? 0 : (g > wmax ? wmax : g);
    win[j] = refs[g];
    if constexpr (kHp) {
      const uint32_t ch = hp.refchr[g];
      if ((j & 3) == 0) wchr[j >> 2] = 0;
      wchr[j >> 2] |= ch << (8 * (j & 3));
      const int hc = hp.hpcs[g];
      const int gcol = ws + c0 + j;
      sh.hcs[warp][c0 + j] = hc;
      if (hc == gcol && c0 + j >= 1) hr_bits |= 1u << j;
      if (hc != gcol && hc > 0 && hc - 1 >= ws) hc_bits |= 1u << j;
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
  // mask bits of the next lane's first columns: a column-gap origin at c
  // counts only if c + 2 is open; the row-gap max at c updates only if c + 1
  // is open.  Past the window's end both are closed.
  unsigned nbits = __shfl_down_sync(FULL, mbits, 1);
  if (lane == 31) nbits = 0;
  const unsigned ext = mbits | (nbits << kCPL);
  const unsigned cand_ok = (ext >> 2) | (lane == 0 ? 1u : 0u);
  const unsigned upd_ok = ext >> 1;

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
    const int code = sh_s2c[warp][0];
    const int s0 = sm[0 * 5 + code], s1 = sm[1 * 5 + code], s2 = sm[2 * 5 + code],
              s3 = sm[3 * 5 + code], s4 = sm[4 * 5 + code];
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      prev[j] = (mbits >> j) & 1u ? sub_for(win[j], s0, s1, s2, s3, s4) : HIM;
      prev2[j] = LOW;
      rbest[j] = prev[j];
    }
  }

  // ---- rows 1 .. last ----------------------------------------------------
  for (int row = 1; row <= last; ++row) {
    const int code = sh_s2c[warp][row];
    const int from_back = len - (row + 1);
    int d = row < kPssmDepth ? row
                             : (from_back < kPssmDepth ? 2 * kPssmDepth - from_back : kPssmDepth);
    d = d < 0 ? 0 : (d > 2 * kPssmDepth ? 2 * kPssmDepth : d);
    const int32_t* smd = sm + d * 25;
    const int s0 = smd[0 * 5 + code], s1 = smd[1 * 5 + code], s2 = smd[2 * 5 + code],
              s3 = smd[3 * 5 + code], s4 = smd[4 * 5 + code];
    const int start_new = -(GOP + GEP * (row + 1));

    // -h: which candidate this row may take (warp-uniform)
    bool hp_col_row = false, hp_row_row = false;
    int pen0 = 0;
    uint32_t ch2x4 = 0;
    if constexpr (kHp) {
      const int hs = sh.hprs[warp][row];
      hp_col_row = hs == row;
      hp_row_row = hs != row && hs > 0 && row - hs < kHpw;
      pen0 = sh.pengop[sh.pidx[warp][row]];
      ch2x4 = sh.chr[warp][row] * 0x01010101u;
      if (hp_col_row) {
        // the row before this run: hp_col's source now, hp_row's later
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kCPL; ++j) sh.row[warp][c0 + j] = prev[j];
        __syncwarp();
      }
    }

    // column gaps: inclusive prefix max of prev[c] + GEP*c over open origins
    int rm[kCPL];
    int run = LOW;
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      const int cand = (cand_ok >> j) & 1u ? prev[j] + GEP * (c0 + j) : LOW;
      run = max(run, cand);
      rm[j] = run;
    }
    int tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, tot, off);
      if (lane >= off) tot = max(tot, t);
    }
    int excl = __shfl_up_sync(FULL, tot, 1);
    if (lane == 0) excl = LOW;
#pragma unroll
    for (int j = 0; j < kCPL; ++j) rm[j] = max(rm[j], excl);

    // row gaps: running per-column max over rows <= row - 2
    if (row >= 2) {
      const int add = GEP * (row - 2);
#pragma unroll
      for (int j = 0; j < kCPL; ++j) {
        const int cr = prev2[j] + add;
        if (((upd_ok >> j) & 1u) && cr > rbest[j]) rbest[j] = cr;
      }
    }

    // previous lane's last columns for the shifted reads
    const int rm_m2 = __shfl_up_sync(FULL, rm[kCPL - 2], 1);
    const int rm_m1 = __shfl_up_sync(FULL, rm[kCPL - 1], 1);
    const int rb_m1 = __shfl_up_sync(FULL, rbest[kCPL - 1], 1);
    const int pv_m1 = __shfl_up_sync(FULL, prev[kCPL - 1], 1);
    const int grow_cost = GOP + GEP * (row - 1);

    int nw[kCPL];
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      const int c = c0 + j;
      const int rmc = j >= 2 ? rm[j - 2] : (j == 1 ? rm_m1 : rm_m2);
      const int gap_col = c >= 2 ? rmc - (GOP + GEP * (c - 1)) : HIM;
      const int rbc = j >= 1 ? rbest[j - 1] : rb_m1;
      const int gap_row = (row >= 2 && c >= 1) ? rbc - grow_cost : HIM;
      const int diag = j >= 1 ? prev[j - 1] : (c >= 1 ? pv_m1 : LOW);
      int base = max(max(diag, gap_col), gap_row);
      if constexpr (kHp) {
        // char equality of this column's reference char with the read's
        const bool same = ((wchr[j >> 2] ^ ch2x4) & (0xffu << (8 * (j & 3)))) == 0;
        int hpv = HIM;
        if (hp_col_row) {
          if (same && ((hc_bits >> j) & 1u)) {
            const int hc = sh.hcs[warp][c];
            int idx = hc - 1 - ws;
            idx = idx < 0 ? 0 : (idx > kW - 1 ? kW - 1 : idx);
            hpv = sh.row[warp][idx] - (GEP * (ws + c - hc) + pen0);
          }
        } else if (hp_row_row) {
          if (same && ((hr_bits >> j) & 1u)) hpv = sh.row[warp][c - 1] - pen0;
        }
        base = max(base, hpv);
      }
      const int cell = sub_for(win[j], s0, s1, s2, s3, s4);
      int v = start_new > base ? start_new : cell + base;
      if (c == 0) v = cell + start_new;
      nw[j] = (mbits >> j) & 1u ? v : HIM;
    }
#pragma unroll
    for (int j = 0; j < kCPL; ++j) {
      prev2[j] = prev[j];
      prev[j] = nw[j];
    }
  }

  // ---- epilogue: best value, earliest column ------------------------------
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
