// Myers O(ND) wavefront for ccheck's global alignment (Hopper, sm_90a).
//
// Replaces mia_tpu/ops/myers_jax.py::_waves: up to maxd waves of the greedy
// furthest-reaching D-path algorithm (Myers 1986) over unit costs, with
// IUPAC matching (bm_b[x] & bm_a[y] != 0), one lane per diagonal
// k = x - y in [-maxd, maxd].  Semantics are those of
// mia_tpu_torch/ops/myers_torch.py::waves_plain, value for value: the same
// candidate arithmetic with the kNeg sentinel, the same accept rule (with
// the y <= len_a guard), the smallest accepting k, and hist[d][k + maxd] =
// furthest x on diagonal k after wave d for every wave run.  found =
// (found_d, found_k); found_d == maxd means no alignment.
//
// What bounds it: one SM's latency and issue rate, not bytes or the card's
// arithmetic.  The waves are serial in d, so a wave costs one barrier, the
// latency chain of a lane (its three candidates, its snake: the run of
// matches it extends, a loop of dependent loads) and, where the band is
// wide, the instructions of all its lanes on one SM's four schedulers.  At
// ccheck's size (16.6 kb x 16.6 kb, maxd 1661: 3,323 lanes, up to 1,661
// waves) the bytes are ~33 KB of bitmaps and the history words the waves
// write, microseconds at the card's memory rate.  Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 9, PERF.md): ~0.94 us a wave at
// d = 185, where the longest snake and the barrier set a wave's time, and
// ~0.98 us with all 3,323 lanes live and short snakes, where the
// instructions of every lane keep the schedulers busy.  What the design does:
//   * the snake compares 8 bases in its first step and 16 in each later
//     one: 32-bit words of each bitmap, read aligned and funnel-shifted
//     into place (__funnelshift_r), ANDed, the zero bytes marked and the
//     first taken with __ffs.  Bytes, not nibbles: a byte keeps the plain
//     version's (b & a) != 0 for any bitmap value with no packing step
//     (bitmap_seq gives 0..15, but nothing here has to rely on it).  Each
//     bitmap carries at least kSlack zero bytes past its length (the
//     caller's padding), so a snake stops at len_a / len_b by itself: one
//     bounds test a snake, none a base.  (Tried and dropped as slower: 16
//     bases from the first step, one base first, 64-bit words, 32 bases a
//     step.)
//   * the previous wave in shared memory: two rows of 2 maxd + 1 int32 as a
//     ring (26.6 KB at maxd 1661), so a lane's three candidates are shared
//     loads and the history row is only written, never read back.  A ring
//     too large for shared memory (maxd above ~14,500) reads the previous
//     wave back from the history instead: the same code, another pointer;
//   * only the live band [max(-d, -len_a), min(d, len_b)] (2 d + 1 lanes at
//     most) is computed.  The band only grows, so the ring row a wave
//     overwrites held a narrower band, and every lane outside the band
//     keeps kNeg: the ring's from the prologue, the history's from the
//     caller's fill;
//   * the bitmaps in shared memory when they fit beside the ring, read in
//     place from global memory otherwise: one source path, instantiated per
//     placement so each load knows its space;
//   * one block of 1,024 threads, the lanes strided over the threads.  256
//     and 512 are timed beside it (chip_smoke.py --myers-ab): at d = 185,
//     the traffic ccheck meets, 1,024 costs ~4-6% against them (more warps
//     at each barrier), to be ~12% faster than 512 at d = 913 and ~17% on
//     the unrelated pair, and 256 slower still there.  One barrier a wave,
//     which also tells every thread whether a lane accepted (the smallest
//     by a shared-memory atomicMin).
// The kernel uses one SM of 132: spreading a wave's lanes over a cluster
// of SMs is what is left (ROADMAP).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// kNeg duplicates the Python side's value and kSlack its padding rule
// (myers_cuda.padded_len); mia_myers_constants exports both so that the
// loader (torchcfg.kernel_library) refuses a library that disagrees.
constexpr int kNeg = -(1 << 30);              // myers_torch._NEG
constexpr int kSlack = 24;                    // zero bytes a bitmap carries past its length
constexpr int kThreads = 1024;                // threads of the one block
constexpr int kSmemMax = 227 * 1024 - 1024;   // dynamic shared memory the kernel asks for

// bytes of a bitmap of n bases with its padding: a multiple of 16 and at
// least n + kSlack (a snake step at position p <= n reads bytes up to
// 4 (p / 4) + 19)
__host__ __device__ constexpr int64_t padded_len(int64_t n) {
  return (n + kSlack + 15) / 16 * 16;
}

// 0x80 in each byte of t that is zero, 0 in the others (no carry between bytes)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t t) {
  return ~(((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t) & 0x80808080u;
}

// Which of the N bases from x on diagonal k match: a zero byte of the
// returned words is a mismatch.  Bytes x..x+4N-1 of b and y..y+4N-1 of a,
// each read as N + 1 aligned words and funnel-shifted into place.
template <int N>
__device__ __forceinline__ void mismatches(const uint8_t* a, int y, const uint8_t* b, int x,
                                           uint32_t (&z)[N]) {
  const uint32_t* wa = reinterpret_cast<const uint32_t*>(a) + (y >> 2);
  const uint32_t* wb = reinterpret_cast<const uint32_t*>(b) + (x >> 2);
  uint32_t va[N + 1], vb[N + 1];
#pragma unroll
  for (int j = 0; j <= N; ++j) {
    va[j] = wa[j];
    vb[j] = wb[j];
  }
  const int sa = (y & 3) * 8, sb = (x & 3) * 8;
#pragma unroll
  for (int j = 0; j < N; ++j)
    z[j] = zero_bytes(__funnelshift_r(va[j], va[j + 1], sa) &
                      __funnelshift_r(vb[j], vb[j + 1], sb));
}

// the offset of the first zero byte among z's words, or -1
template <int N>
__device__ __forceinline__ int first_zero(const uint32_t (&z)[N]) {
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) any |= z[j];
  if (!any) return -1;
#pragma unroll
  for (int j = 0; j < N - 1; ++j)
    if (z[j]) return 4 * j + ((__ffs((int)z[j]) - 1) >> 3);
  return 4 * (N - 1) + ((__ffs((int)z[N - 1]) - 1) >> 3);
}

// x after the snake on diagonal k from x: the first x' >= x with
// b[x'] & a[x' - k] == 0.  The padding's zero bytes end every run at
// len_b and len_a; a start outside the sequences (x or y below 0 or past
// its length: one unsigned test each) extends nothing.  Most snakes end
// within a few bases, so the first step takes 8, the later ones 16.
__device__ __forceinline__ int snake(const uint8_t* a, int len_a, const uint8_t* b,
                                     int len_b, int x, int k) {
  int y = x - k;
  if ((unsigned)x >= (unsigned)len_b || (unsigned)y >= (unsigned)len_a) return x;
  uint32_t z2[2];
  mismatches(a, y, b, x, z2);
  int off = first_zero(z2);
  if (off >= 0) return x + off;
  x += 8;
  y += 8;
  for (;;) {
    uint32_t z4[4];
    mismatches(a, y, b, x, z4);
    off = first_zero(z4);
    if (off >= 0) return x + off;
    x += 16;
    y += 16;
  }
}

// the accept rule of a live lane (myers_torch.waves_plain's accept: every
// lane computed here is in the valid range)
__device__ __forceinline__ bool accepts(int x, int k, int len_a, int len_b, int is_prefix,
                                        int has_prefix) {
  const int y = x - k;
  return (is_prefix || y == len_a) && (has_prefix || x == len_b) && y <= len_a;
}

template <bool kBmShared, bool kRingShared>
__global__ void __launch_bounds__(kThreads, 1)
myers_waves_kernel(const uint8_t* __restrict__ bm_a, int len_a,
                   const uint8_t* __restrict__ bm_b, int len_b, int maxd, int is_prefix,
                   int has_prefix, int32_t* hist, int32_t* __restrict__ found) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int sh_acc;  // the smallest accepting lane of the wave that finds one
  const int n_diag = 2 * maxd + 1;
  // shared memory: the ring (two rows), then both padded bitmaps
  int32_t* ring = reinterpret_cast<int32_t*>(smem);
  const uint8_t* a = bm_a;
  const uint8_t* b = bm_b;
  if (kBmShared) {
    const int ring_bytes = kRingShared ? (8 * n_diag + 15) / 16 * 16 : 0;
    const int na = (int)(padded_len(len_a) / 16), nb = (int)(padded_len(len_b) / 16);
    uint4* sa = reinterpret_cast<uint4*>(smem + ring_bytes);
    uint4* sb = sa + na;
    const uint4* ga = reinterpret_cast<const uint4*>(bm_a);
    const uint4* gb = reinterpret_cast<const uint4*>(bm_b);
    for (int i = threadIdx.x; i < na; i += blockDim.x) sa[i] = ga[i];
    for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = gb[i];
    a = reinterpret_cast<const uint8_t*>(sa);
    b = reinterpret_cast<const uint8_t*>(sb);
  }
  if (kRingShared)
    for (int i = threadIdx.x; i < 2 * n_diag; i += blockDim.x) ring[i] = kNeg;
  if (threadIdx.x == 0) sh_acc = INT_MAX;
  __syncthreads();

  // wave 0: the snake from 0 on diagonal 0, the band's only lane
  int hit = 0;  // this thread's lanes accepted in the current wave
  if (threadIdx.x == 0) {
    const int x = snake(a, len_a, b, len_b, 0, 0);
    hist[maxd] = x;
    if (kRingShared) ring[maxd] = x;
    if (accepts(x, 0, len_a, len_b, is_prefix, has_prefix)) {
      sh_acc = maxd;
      hit = 1;
    }
  }
  // Each wave ends in one barrier that also tells every thread whether a
  // lane accepted (__syncthreads_or); the first wave that finds one is the
  // last, so one slot holds its smallest accepting lane.
  int d = 0;
  while (!__syncthreads_or(hit)) {
    if (++d >= maxd) break;
    const int32_t* v = kRingShared ? ring + ((d - 1) & 1) * n_diag
                                   : hist + (int64_t)(d - 1) * n_diag;
    int32_t* cur = ring + (d & 1) * n_diag;
    int32_t* row = hist + (int64_t)d * n_diag;
    // |k| <= d < maxd in the band, so lanes i - 1 and i + 1 are in the row
    const int lo = max(-d, -len_a), hi = min(d, len_b);
    for (int k = lo + (int)threadIdx.x; k <= hi; k += (int)blockDim.x) {
      const int i = k + maxd;
      // the furthest of the previous wave's candidates: down = v[k-1] + 1,
      // up = v[k+1], straight = v[k] + 1.  myers_jax sets a candidate to
      // kNeg where its diagonal lies outside the previous band (k = -d
      // has no down or straight, k = d no up or straight); here those read
      // the ring's kNeg (+ 1).  The band grows by at most one lane a side a
      // wave, so every lane of it has a candidate in the previous band,
      // which is >= 0: the sentinels never win the max, and x is the same.
      const int x = snake(a, len_a, b, len_b, __viaddmax_s32(max(v[i - 1], v[i]), 1, v[i + 1]),
                          k);
      if (accepts(x, k, len_a, len_b, is_prefix, has_prefix)) {
        atomicMin(&sh_acc, i);
        hit = 1;
      }
      row[i] = x;
      if (kRingShared) cur[i] = x;
    }
  }
  if (threadIdx.x == 0) {
    found[0] = d;  // maxd: no wave accepted
    found[1] = d < maxd ? sh_acc - maxd : maxd + 1;
  }
}

}  // namespace

// bm_a and bm_b: uint8 IUPAC bitmaps of len_a and len_b bases, each
// 16-byte aligned and followed by zero bytes up to padded_len(len) (at
// least kSlack); hist [maxd + 1, 2 maxd + 1] int32, filled with kNeg by the
// caller (lanes outside a wave's band, and rows past the last wave run,
// stay so); found [2] int32.
extern "C" int mia_myers_waves(const void* bm_a, int len_a, const void* bm_b, int len_b,
                               int maxd, int is_prefix, int has_prefix, void* hist,
                               void* found, void* stream) {
  if (maxd <= 0 || len_a < 0 || len_b < 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)bm_a | (uintptr_t)bm_b) & 15) return (int)cudaErrorMisalignedAddress;
  const int64_t n_diag = 2 * (int64_t)maxd + 1;
  const int threads = n_diag < kThreads ? (int)(n_diag + 31) / 32 * 32 : kThreads;
  const int64_t ring = (8 * n_diag + 15) / 16 * 16;
  const int64_t bitmaps = padded_len(len_a) + padded_len(len_b);
  const bool ring_shared = ring <= kSmemMax;
  const bool bm_shared = (ring_shared ? ring : 0) + bitmaps <= kSmemMax;
  const int smem = (int)((ring_shared ? ring : 0) + (bm_shared ? bitmaps : 0));
  void (*kernel)(const uint8_t*, int, const uint8_t*, int, int, int, int, int32_t*, int32_t*) =
      bm_shared ? (ring_shared ? &myers_waves_kernel<true, true> : &myers_waves_kernel<true, false>)
                : (ring_shared ? &myers_waves_kernel<false, true>
                               : &myers_waves_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bm_a, len_a, (const uint8_t*)bm_b, len_b, maxd, is_prefix, has_prefix,
      (int32_t*)hist, (int32_t*)found);
  return (int)cudaGetLastError();
}

// The compile-time constants the Python side shares: the sentinel of lanes
// outside a wave's band, and the zero bytes a bitmap carries past its
// length.  Fills at most n values of out; returns how many there are.
extern "C" int mia_myers_constants(int32_t* out, int n) {
  const int32_t c[] = {kNeg, kSlack};
  const int count = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}
