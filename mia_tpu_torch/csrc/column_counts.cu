// Consensus column counts (Hopper, sm_90a).
//
// Replaces mia_tpu/ops/consensus_device.py::_accum_fn (its `core`): the
// scatter-add of every aligned base into its reference column's one-hot
// counts, coverage tick and four PSSM-weighted candidate scores (add_base,
// src/map_align.c:229-263).  Semantics are those of
// mia_tpu_torch/ops/consensus_torch.py::column_counts_plain: record r covers
// columns starts[r] .. starts[r] + spans[r] - 1 with the chars
// seq[seq_off[r] + k] and depths smp[smp_off[r] + k] - 'A' (clipped to
// 0..30); columns outside [0, n) are dropped; chars that are not A, C, G, T
// or '-' tick coverage and score but count in no base; gaps do not score.
//
// What bounds it: atomics, not bytes or arithmetic.  An observation reads 2
// bytes and does up to 6 integer adds into ~16.5k columns x 10 accumulators.
// Sent to global memory one by one, those are millions of 64-bit atomics
// that all go to L2.  The design keeps them on the SM:
//   * the grid is (column tiles of 512) x (record slices), about one block
//     per SM; a slice is every n-th group of 32 records, so the blocks of a
//     tile share its records evenly even when they come sorted; a block owns a tile's 10 x 512 int32 accumulators in shared
//     memory (20 KB, one plane per accumulator, so the lanes of a warp, on
//     consecutive columns, never share a bank);
//   * the block works in rounds: each thread reads one record's start and
//     span (fetched a round ahead); the threads whose record touches the
//     block's tile fetch its arena offsets and strand and put the record on
//     a list in shared memory; then the warps take the list's records in
//     turn and walk each one's overlap with the tile, a lane per column,
//     adding with shared-memory int32 atomics.  A walk waits for memory
//     once, so latency decides: a block is 32 warps to have enough walks in
//     flight, and the list shares them evenly even when all the records
//     that hit sit in one warp's 32 (sorted records hit in runs);
//   * at the end the block adds its non-zero accumulators to the int64
//     results with one global atomic each: 10 per column and block in place
//     of 6 per observation;
//   * the strand/depth/base lookup table (5 KB) and the char tables sit in
//     shared memory.
// Exactness: a record covers a column at most once, so a block's private sum
// for a column is at most (records it has walked) x (largest |table entry|).
// The block takes that largest entry from its own table and flushes to the
// int64 results every floor(INT32_MAX / largest) records, so no private sum
// can overflow whatever the PSSM holds; with real PSSMs (|entry| ~ 10^3) that
// is one flush.  Two's complement makes the unsigned 64-bit adds exact for
// signed sums, so the result does not depend on the order of the adds and
// there is no bound on the number of reads.
// On an H100 80GB HBM3 at 700 W, 1,078,346 observations over 16,569 columns
// take 0.029 ms with the records in random order and 0.022 ms sorted by
// start (0.03-0.08 ms through the wrapper, which is host work), against
// 0.078-0.086 ms for one 64-bit global atomic per add and 0.038-0.042 ms for
// index_add_ of the score terms alone (chip_smoke.py).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;              // columns per block
constexpr int kPlanes = 10;             // 5 counts, coverage, 4 scores
constexpr int kDepth = 31;              // PSSM depth slots
constexpr int kLut = 2 * kDepth * 5 * 4;  // [strand][depth][read base][candidate]
constexpr int kMinSlice = 256;          // a slice of fewer records is not worth a block
constexpr int kMaxSlices = 65535;       // gridDim.y

__global__ void __launch_bounds__(kThreads)
column_counts_kernel(const uint8_t* __restrict__ seq, int64_t seq_n,
                     const uint8_t* __restrict__ smp, int64_t smp_n,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ spans,
                     const int32_t* __restrict__ seq_off,
                     const int32_t* __restrict__ smp_off,
                     const uint8_t* __restrict__ revs, int R,
                     const int32_t* __restrict__ fpsm,
                     const int32_t* __restrict__ rpsm,
                     const int8_t* __restrict__ base_idx,
                     const int8_t* __restrict__ sub_idx, int n,
                     unsigned long long* __restrict__ counts,
                     unsigned long long* __restrict__ cov,
                     unsigned long long* __restrict__ scores) {
  __shared__ int32_t sh_acc[kPlanes * kTile];
  __shared__ int32_t sh_lut[kLut];
  __shared__ int8_t sh_base[256], sh_sub[256];
  __shared__ int4 sh_list[kThreads];  // start, span | strand << 31, seq_off, smp_off
  __shared__ int sh_count[2];         // records on the list, by round parity
  __shared__ unsigned sh_maxabs;
  if (threadIdx.x == 0) {
    sh_maxabs = 1;
    sh_count[0] = 0;
  }
  __syncthreads();
  // lut[s][d][b][q] = psm_s[d][q][b]: the score of candidate base q for an
  // observed base b at depth d (add_base's strand-specific matrix)
  unsigned maxabs = 1;
  for (int i = threadIdx.x; i < kLut; i += kThreads) {
    const int q = i % 4, b = (i / 4) % 5, d = (i / 20) % kDepth, s = i / (20 * kDepth);
    const int32_t v = (s ? rpsm : fpsm)[d * 25 + q * 5 + b];
    sh_lut[i] = v;
    const unsigned a = v < 0 ? 0u - (unsigned)v : (unsigned)v;
    maxabs = a > maxabs ? a : maxabs;
  }
  atomicMax(&sh_maxabs, maxabs);
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    sh_base[i] = base_idx[i];
    sh_sub[i] = sub_idx[i];
  }
  for (int i = threadIdx.x; i < kPlanes * kTile; i += kThreads) sh_acc[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kTile;
  const int t1 = min(n, t0 + kTile);
  // The block's records: every gridDim.y-th group of 32, so that each slice
  // is a sample of the whole set and the blocks of a tile share its records
  // evenly whatever their order (a maln's records come sorted by start).
  // v counts them: record ((v / 32) * slices + slice) * 32 + v % 32.
  const int slices = gridDim.y;
  const int groups = (R + 31) / 32;
  const int64_t v_hi = (int64_t)((groups - (int)blockIdx.y + slices - 1) / slices) * 32;
  auto record = [&](int64_t v) {
    return ((v >> 5) * slices + blockIdx.y) * 32 + (v & 31);
  };
  // records between two flushes: their private sums fit int32
  int chunk = (int)(0x7fffffffu / sh_maxabs);
  chunk = chunk < 1 ? 1 : chunk;
  // A round: each thread looks at one record (fetched a round ahead) and the
  // ones that touch the tile go on a shared list with all the walk needs;
  // then the warps take the list's records in turn.  So the walks are
  // shared evenly among the warps wherever the records that hit came from
  // (sorted records hit in runs: one warp would find all of its 32 picked).
  const int step = min(kThreads, chunk);        // records a round
  const int rounds_per_flush = chunk / step;
  const bool scans = (int)threadIdx.x < step;

  int64_t r = record(threadIdx.x);
  int st = 0, sp = 0;
  if (scans && threadIdx.x < v_hi && r < R) {
    st = starts[r];
    sp = spans[r];
  }
  int parity = 0, since_flush = 0;
  for (int64_t v0 = 0; v0 < v_hi; v0 += step, parity ^= 1) {
    const int64_t v_n = v0 + step + threadIdx.x;
    const int64_t r_n = record(v_n);
    int st_n = 0, sp_n = 0;
    if (scans && v_n < v_hi && r_n < R) {
      st_n = starts[r_n];
      sp_n = spans[r_n];
    }
    const bool mine = sp > 0 && st < t1 && (int64_t)st + sp > t0;
    int so = 0, mo = 0, rv = 0;
    if (mine) {
      so = seq_off[r];
      mo = smp_off[r];
      rv = revs[r] ? 1 : 0;
    }
    const unsigned picked = __ballot_sync(0xffffffffu, mine);
    if (picked) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&sh_count[parity], __popc(picked));
      base = __shfl_sync(0xffffffffu, base, 0);
      // a span is positive here: its sign bit carries the strand
      if (mine)
        sh_list[base + __popc(picked & ((1u << lane) - 1))] =
            make_int4(st, (int)((unsigned)sp | ((unsigned)rv << 31)), so, mo);
    }
    if (threadIdx.x == 0) sh_count[parity ^ 1] = 0;  // the next round's; no one reads it now
    __syncthreads();
    const int listed = sh_count[parity];
    for (int i = warp; i < listed; i += kWarps) {
      const int4 e = sh_list[i];
      const int rst = e.x, rsp = e.y & 0x7fffffff, s = (unsigned)e.y >> 31;
      const int64_t rso = e.z, rmo = e.w;
      // the record's offsets that fall into this tile
      const int k_lo = rst < t0 ? t0 - rst : 0;
      const int k_hi = (int)min((int64_t)rsp, (int64_t)t1 - rst);
      for (int k = k_lo + lane; k < k_hi; k += 32) {
        int32_t* a = sh_acc + (rst + k - t0);
        const int64_t si = rso + k < seq_n - 1 ? rso + k : seq_n - 1;
        const int64_t mi = rmo + k < smp_n - 1 ? rmo + k : smp_n - 1;
        const int ch = seq[si];
        int d = (int)smp[mi] - 'A';
        d = d < 0 ? 0 : (d > kDepth - 1 ? kDepth - 1 : d);
        const int cls = sh_base[ch];
        if (cls >= 0) atomicAdd(a + cls * kTile, 1);
        atomicAdd(a + 5 * kTile, 1);
        if (ch != '-') {
          const int32_t* l = sh_lut + ((s * kDepth + d) * 5 + sh_sub[ch]) * 4;
#pragma unroll
          for (int q = 0; q < 4; ++q) atomicAdd(a + (6 + q) * kTile, l[q]);
        }
      }
    }
    __syncthreads();  // the list is free, the round's adds are in
    st = st_n;
    sp = sp_n;
    r = r_n;
    if (++since_flush < rounds_per_flush && v0 + step < v_hi) continue;
    since_flush = 0;
    // flush: plane p of column t0 + x goes to its int64 result.  The next
    // round's adds come after its own barrier.
    for (int i = threadIdx.x; i < kPlanes * kTile; i += kThreads) {
      const int32_t v = sh_acc[i];
      const int p = i / kTile;
      const int64_t col = t0 + i % kTile;
      if (v == 0 || col >= t1) continue;
      sh_acc[i] = 0;
      unsigned long long* dst = p < 5 ? counts + col * 5 + p
                                      : (p == 5 ? cov + col : scores + col * 4 + (p - 6));
      atomicAdd(dst, (unsigned long long)(long long)v);
    }
  }
}

}  // namespace

// counts [n, 5], cov [n], scores [n, 4]: int64, zeroed by the caller.  The
// grid follows from n and R here: one block per tile of columns and slice
// of records, about one block per SM, no slice empty.
extern "C" int mia_column_counts(const void* seq, int64_t seq_n, const void* smp,
                                 int64_t smp_n, const void* starts, const void* spans,
                                 const void* seq_off, const void* smp_off,
                                 const void* revs, int R, const void* fpsm,
                                 const void* rpsm, const void* base_idx,
                                 const void* sub_idx, int n, void* counts, void* cov,
                                 void* scores, void* stream) {
  if (R <= 0 || n <= 0) return 0;
  if (seq_n <= 0 || smp_n <= 0) return (int)cudaErrorInvalidValue;
  static int sm_count[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = dev < 64 ? sm_count[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sm_count[dev] = sms;
  }
  const int tiles = (n + kTile - 1) / kTile;
  int slices = sms / tiles;
  const int most = (R + kMinSlice - 1) / kMinSlice;
  slices = slices > most ? most : slices;
  slices = slices < 1 ? 1 : (slices > kMaxSlices ? kMaxSlices : slices);
  column_counts_kernel<<<dim3(tiles, slices), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, seq_n, (const uint8_t*)smp, smp_n, (const int32_t*)starts,
      (const int32_t*)spans, (const int32_t*)seq_off, (const int32_t*)smp_off,
      (const uint8_t*)revs, R, (const int32_t*)fpsm, (const int32_t*)rpsm,
      (const int8_t*)base_idx, (const int8_t*)sub_idx, n, (unsigned long long*)counts,
      (unsigned long long*)cov, (unsigned long long*)scores);
  return (int)cudaGetLastError();
}
