// Ungapped pileup counts of the dp x sp assembly step (Hopper, sm_90a).
//
// Replaces mia_tpu/parallel/sharded.py::_pileup_counts (inside
// make_assembly_step): every base of every read goes to the reference column
// starts[b] + r, where it ticks one of five counts (A, C, G, T, and code 4 in
// the fifth) and adds the PSSM score of each candidate base x in 0..3,
// psm[depth][x][base], strand-selected (the device half of add_base,
// src/map_align.c:229-263).  Semantics are those of
// mia_tpu_torch/parallel/sharded.py::_pileup_counts: rows past the read's
// length (or past L), columns outside [0, W) and codes outside 0..4 add
// nothing; sums wrap as int32, as they do in the JAX package.
//
// What bounds it: atomics and latency, not bytes or arithmetic.  A base reads
// 8 bytes and does five integer adds into W x 9 accumulators.  Sent to global
// memory one by one those are five atomics a base that all go to L2, into
// accumulators that the caller has to zero first (three launches a call).
// The design keeps the adds on the SM and makes a call one launch:
//   * one block per tile of columns (at most 128, fewer where W is small, so
//     that the tiles are about as many as the SMs); the block owns the
//     tile's 9 sums a column in shared memory, one plane per sum, so that
//     the lanes of a warp, on consecutive columns, never share a bank;
//   * the block works in rounds of 2,048 reads (one round at the step's
//     B = 2,048): every thread loads two reads' starts and lengths (16 KB a
//     block at B = 2,048, from L2 after the first block), the reads that
//     touch the tile go on a list in shared memory, then the warps take the
//     list's reads in turn, lanes on consecutive rows, and add with
//     shared-memory atomics.  A round waits for memory twice (starts and
//     lengths, then codes and depths), so latency decides: a block is 32
//     warps, about one per listed read at the step's shape, and a warp asks
//     for all of a read's rows in the tile (at most 128, four a lane) before
//     it adds any;
//   * the tile's owner *stores* its sums: no global atomic, no zeroing by
//     the caller, and every sum is in a fixed place whatever the order of
//     the adds (unsigned adds: exact modulo 2^32 in any order);
//   * both PSSMs sit in shared memory as [strand][depth][base][candidate],
//     so a base's four score terms are one 16-byte load.
// Where this stops paying: every block reads every read's start and length,
// 8 B x (W / 128) per read, against 5 atomics a base saved.  With reads of
// ~100 bases that is even at about W = 1M columns (8,000 tiles); past that
// the scan dominates and reads sorted into buckets by start would be the
// remedy.  The kernel is the same there and stays exact for any B, L, W: the
// grid is the tiles, the rounds cover any B, a list holds a whole round.
// On an H100 80GB HBM3 at 700 W, B = 2,048 reads of up to 256 rows over
// W = 17,024 columns (253,237 bases in range) take 0.008-0.011 ms a launch
// (chip_smoke.py), against 0.014 ms for one global atomic per add plus two
// fills, and 0.015-0.021 ms for the two index_add_ calls that do the same
// adds on indices made beforehand.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;                  // reads a thread looks at per round
constexpr int kRound = kThreads * kPer;  // reads per round, and the list's room
constexpr int kMaxTile = 128;            // columns per block, at most
constexpr int kStride = kMaxTile + 1;    // words between two planes
constexpr int kPlanes = 9;               // 5 counts, 4 scores
constexpr int kDepth = 31;               // PSSM depth slots
constexpr int kLut = 2 * kDepth * 5 * 4; // [strand][depth][base][candidate]

__global__ void __launch_bounds__(kThreads)
pileup_counts_kernel(const int32_t* __restrict__ s2c, const int32_t* __restrict__ depths,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ starts,
                     const uint8_t* __restrict__ strands,
                     const int32_t* __restrict__ fpsm, const int32_t* __restrict__ rpsm,
                     int B, int L, int W, int tile, uint32_t* __restrict__ counts,
                     uint32_t* __restrict__ scores) {
  __shared__ uint32_t sh_acc[kPlanes * kStride];
  __shared__ __align__(16) int32_t sh_lut[kLut];
  __shared__ int4 sh_list[kRound];  // read, first row, row bound, column of row 0 less t0
  __shared__ int sh_count[2];       // reads on the list, by round parity

  const int t0 = blockIdx.x * tile;
  const int t1 = min(W, t0 + tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the first round's reads, asked for before anything else
  int st[kPer], ln[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = j * kThreads + threadIdx.x;
    st[j] = b < B ? starts[b] : 0;
    ln[j] = b < B ? lengths[b] : 0;
  }
  for (int i = threadIdx.x; i < kLut; i += kThreads) {
    const int x = i % 4, base = (i / 4) % 5, d = (i / 20) % kDepth, s = i / (20 * kDepth);
    sh_lut[i] = (s ? rpsm : fpsm)[d * 25 + x * 5 + base];
  }
  for (int i = threadIdx.x; i < kPlanes * kStride; i += kThreads) sh_acc[i] = 0;
  if (threadIdx.x == 0) sh_count[0] = 0;
  __syncthreads();

  int parity = 0;
  for (int b0 = 0; b0 < B; b0 += kRound, parity ^= 1) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = b0 + j * kThreads + threadIdx.x;
      // rows [k_lo, k_hi) of the read fall into the tile
      const int len = min(max(ln[j], 0), L);
      const int64_t lo = (int64_t)t0 - st[j], hi = (int64_t)t1 - st[j];
      const int k_lo = lo > 0 ? (int)min(lo, (int64_t)len) : 0;
      const int k_hi = hi < len ? (int)max(hi, (int64_t)0) : len;
      const bool mine = b < B && k_lo < k_hi;
      const unsigned picked = __ballot_sync(0xffffffffu, mine);
      if (picked) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&sh_count[parity], __popc(picked));
        at = __shfl_sync(0xffffffffu, at, 0);
        // k_lo < k_hi: the column of row 0 less t0 lies within +-(L + tile)
        if (mine)
          sh_list[at + __popc(picked & ((1u << lane) - 1))] =
              make_int4(b, k_lo, k_hi, (int)((int64_t)st[j] - t0));
      }
      // the next round's reads
      const int bn = b + kRound;
      st[j] = bn < B ? starts[bn] : 0;
      ln[j] = bn < B ? lengths[bn] : 0;
    }
    if (threadIdx.x == 0) sh_count[parity ^ 1] = 0;  // the next round's; no one reads it now
    __syncthreads();
    const int listed = sh_count[parity];
    for (int i = warp; i < listed; i += kWarps) {
      const int4 e = sh_list[i];
      const int64_t row0 = (int64_t)e.x * L;
      const int32_t* lut = sh_lut + (strands[e.x] ? kDepth * 20 : 0);
      // at most kMaxTile rows of a read fall into a tile: kMaxTile / 32 a lane
      int base[kMaxTile / 32], d[kMaxTile / 32];
#pragma unroll
      for (int u = 0; u < kMaxTile / 32; ++u) {
        const int k = e.y + lane + 32 * u;
        base[u] = k < e.z ? s2c[row0 + k] : -1;
        d[u] = k < e.z ? depths[row0 + k] : 0;
      }
#pragma unroll
      for (int u = 0; u < kMaxTile / 32; ++u) {
        if (base[u] < 0 || base[u] > 4) continue;
        const int dd = d[u] < 0 ? 0 : (d[u] > kDepth - 1 ? kDepth - 1 : d[u]);
        uint32_t* a = sh_acc + (e.w + e.y + lane + 32 * u);
        atomicAdd(a + base[u] * kStride, 1u);
        const int4 t = *(const int4*)(lut + (dd * 5 + base[u]) * 4);
        atomicAdd(a + 5 * kStride, (uint32_t)t.x);
        atomicAdd(a + 6 * kStride, (uint32_t)t.y);
        atomicAdd(a + 7 * kStride, (uint32_t)t.z);
        atomicAdd(a + 8 * kStride, (uint32_t)t.w);
      }
    }
    __syncthreads();  // the list is free, the round's adds are in
  }

  // the tile's sums, stored: counts [W, 5] and scores [W, 4] row-major
  const int n = t1 - t0;
  for (int i = threadIdx.x; i < n * 5; i += kThreads)
    counts[(int64_t)t0 * 5 + i] = sh_acc[(i % 5) * kStride + i / 5];
  for (int i = threadIdx.x; i < n * 4; i += kThreads)
    scores[(int64_t)t0 * 4 + i] = sh_acc[(5 + i % 4) * kStride + i / 4];
}

}  // namespace

// s2c, depths [B, L] int32; lengths, starts [B] int32; strands [B] bytes;
// fpsm, rpsm [31, 5, 5] int32; counts [W, 5], scores [W, 4] int32: every
// element is written (zeros where nothing landed), so the caller need not
// clear them.  B and L may be 0.
extern "C" int mia_pileup_counts(const void* s2c, const void* depths, const void* lengths,
                                 const void* starts, const void* strands,
                                 const void* fpsm, const void* rpsm, int B, int L, int W,
                                 void* counts, void* scores, void* stream) {
  if (W <= 0) return 0;
  if (B < 0 || L < 0) return (int)cudaErrorInvalidValue;
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
  // about one tile per SM, a multiple of 32 columns between 32 and kMaxTile
  int tile = ((W + sms - 1) / sms + 31) / 32 * 32;
  tile = tile > kMaxTile ? kMaxTile : tile;
  const int tiles = (W + tile - 1) / tile;
  pileup_counts_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)s2c, (const int32_t*)depths, (const int32_t*)lengths,
      (const int32_t*)starts, (const uint8_t*)strands, (const int32_t*)fpsm,
      (const int32_t*)rpsm, B, L, W, tile, (uint32_t*)counts, (uint32_t*)scores);
  return (int)cudaGetLastError();
}

// The compile-time constants of this kernel, in this order: PSSM depth slots,
// reads per round (the list's room), the widest tile.  Fills at most n values
// of out; returns how many there are.
extern "C" int mia_pileup_counts_constants(int32_t* out, int n) {
  const int32_t c[] = {kDepth, kRound, kMaxTile};
  const int count = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}
