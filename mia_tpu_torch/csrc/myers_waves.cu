// Myers O(ND) wavefront for ccheck's global alignment (Hopper, sm_90a).
//
// Replaces mia_tpu/ops/myers_jax.py::_waves: up to maxd waves of the greedy
// furthest-reaching D-path algorithm (Myers 1986) over unit costs, with
// IUPAC matching (bm_b[x] & bm_a[y] != 0), one lane per diagonal
// k = x - y in [-maxd, maxd].  Semantics are those of
// mia_tpu_torch/ops/myers_torch.py::waves_plain, value for value: the same
// candidate arithmetic with the kNeg sentinel in out-of-range lanes, the
// same accept rule (with the y <= len_a guard), the smallest accepting k,
// and hist[d][k + maxd] = furthest x on diagonal k after wave d for every
// wave run.  found = (found_d, found_k); found_d == maxd means no alignment.
//
// What bounds it: latency, not bytes or arithmetic.  The waves are serial
// in d, and inside a wave each lane's snake (its run of matches) is a
// data-dependent loop of dependent loads.  At ccheck's size (16.6 kb x
// 16.6 kb, maxd 1661: 3,323 lanes, up to 1,661 waves) the whole problem
// is ~33 KB of bitmaps and a 22 MB history, far too little to fill the
// card, so the design is the simple one:
//   * one block of up to 1024 threads per alignment, the lanes strided over
//     the threads (~4 each at ccheck's size);
//   * both bitmaps in shared memory when they fit (global memory
//     otherwise), and the snake by direct comparison, so the TPU's
//     run-length table R [n_diag, len_b] (~221 MB at ccheck's size) is gone;
//   * each wave writes its row of the history and reads the previous row
//     back from the same buffer, so there is no bound but device memory;
//   * the smallest accepting lane by a shared-memory atomicMin, then one
//     __syncthreads() per wave, after which all threads see the same
//     answer and leave together.  Three rotating slots for that minimum let
//     one barrier per wave suffice.
// The kernel uses one SM of 132 and each wave waits for its longest snake.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// kNeg duplicates the Python side's value; mia_myers_constants exports it
// so that the loader (torchcfg.kernel_library) refuses a library that
// disagrees.
constexpr int kNeg = -(1 << 30);      // myers_torch._NEG
constexpr int kThreads = 1024;        // threads of the one block
constexpr int kSmemMax = 200 * 1024;  // bitmaps staged in shared memory up to this

__device__ __forceinline__ int snake(const uint8_t* a, int len_a, const uint8_t* b,
                                     int len_b, int x, int k) {
  int y = x - k;
  if (x < 0) return x;
  while (x < len_b && y >= 0 && y < len_a && (b[x] & a[y]) != 0) {
    ++x;
    ++y;
  }
  return x;
}

__device__ __forceinline__ bool accepts(int x, int k, int d, int len_a, int len_b,
                                        int is_prefix, int has_prefix) {
  const int y = x - k;
  const bool valid = k >= max(-d, -len_a) && k <= min(d, len_b);
  return valid && (is_prefix || y == len_a) && (has_prefix || x == len_b) && y <= len_a;
}

__global__ void __launch_bounds__(kThreads, 1)
myers_waves_kernel(const uint8_t* __restrict__ bm_a, int len_a,
                   const uint8_t* __restrict__ bm_b, int len_b, int maxd,
                   int is_prefix, int has_prefix, int staged,
                   int32_t* hist, int32_t* __restrict__ found) {
  extern __shared__ uint8_t sh_bm[];
  __shared__ int sh_acc[3];  // smallest accepting lane of waves d = 0, 1, 2 (mod 3)
  const int n_diag = 2 * maxd + 1;
  const uint8_t* a = bm_a;
  const uint8_t* b = bm_b;
  if (staged) {
    uint8_t* sa = sh_bm;
    uint8_t* sb = sh_bm + len_a;
    for (int i = threadIdx.x; i < len_a; i += blockDim.x) sa[i] = bm_a[i];
    for (int i = threadIdx.x; i < len_b; i += blockDim.x) sb[i] = bm_b[i];
    a = sa;
    b = sb;
  }
  if (threadIdx.x < 3) sh_acc[threadIdx.x] = INT_MAX;
  __syncthreads();

  // wave 0: x = snake from 0 on diagonal 0, kNeg elsewhere
  for (int i = threadIdx.x; i < n_diag; i += blockDim.x) {
    const int k = i - maxd;
    int x = kNeg;
    if (k == 0) {
      x = snake(a, len_a, b, len_b, 0, 0);
      if (accepts(x, 0, 0, len_a, len_b, is_prefix, has_prefix)) atomicMin(&sh_acc[0], i);
    }
    hist[i] = x;
  }
  __syncthreads();
  int found_d = maxd, found_k = maxd + 1;
  if (sh_acc[0] != INT_MAX) {
    found_d = 0;
    found_k = sh_acc[0] - maxd;
  }

  for (int d = 1; found_d >= maxd && d < maxd; ++d) {
    // the slot of wave d + 1 was last read before the previous barrier
    if (threadIdx.x == 0) sh_acc[(d + 1) % 3] = INT_MAX;
    const int32_t* v = hist + (int64_t)(d - 1) * n_diag;
    int32_t* row = hist + (int64_t)d * n_diag;
    const int lo = max(-d, -len_a), hi = min(d, len_b);
    for (int i = threadIdx.x; i < n_diag; i += blockDim.x) {
      const int k = i - maxd;
      int x = kNeg;
      if (k >= lo && k <= hi) {
        // candidates from the previous wave, with myers_jax's sentinel
        // arithmetic: down = v[k-1] + 1, up = v[k+1], straight = v[k] + 1
        const int down = i > 0 ? v[i - 1] : kNeg;
        const int up = i + 1 < n_diag ? v[i + 1] : kNeg;
        const int c_down = k > -d ? down + 1 : kNeg;
        const int c_up = k < d ? up : kNeg;
        const int c_in = (k > -d && k < d) ? v[i] + 1 : kNeg;
        x = snake(a, len_a, b, len_b, max(c_down, max(c_up, c_in)), k);
        if (accepts(x, k, d, len_a, len_b, is_prefix, has_prefix))
          atomicMin(&sh_acc[d % 3], i);
      }
      row[i] = x;
    }
    __syncthreads();
    const int acc = sh_acc[d % 3];
    if (acc != INT_MAX) {
      found_d = d;
      found_k = acc - maxd;
    }
  }
  if (threadIdx.x == 0) {
    found[0] = found_d;
    found[1] = found_k;
  }
}

}  // namespace

// bm_a [len_a] and bm_b [len_b] uint8 IUPAC bitmaps (at least one byte
// each); hist [maxd + 1, 2 maxd + 1] int32, filled with kNeg by the caller
// (rows past the last wave run stay so); found [2] int32.
extern "C" int mia_myers_waves(const void* bm_a, int len_a, const void* bm_b, int len_b,
                               int maxd, int is_prefix, int has_prefix, void* hist,
                               void* found, void* stream) {
  if (maxd <= 0 || len_a < 0 || len_b < 0) return (int)cudaErrorInvalidValue;
  const int n_diag = 2 * maxd + 1;
  const int threads = n_diag < kThreads ? (n_diag + 31) / 32 * 32 : kThreads;
  const int64_t bytes = (int64_t)len_a + len_b;
  const int staged = bytes <= kSmemMax;
  const int smem = staged ? (int)bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        myers_waves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  myers_waves_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bm_a, len_a, (const uint8_t*)bm_b, len_b, maxd, is_prefix,
      has_prefix, staged, (int32_t*)hist, (int32_t*)found);
  return (int)cudaGetLastError();
}

// The compile-time constants the Python side shares: the sentinel of
// out-of-range lanes.  Fills at most n values of out; returns how many there
// are.
extern "C" int mia_myers_constants(int32_t* out, int n) {
  const int32_t c[] = {kNeg};
  const int count = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}
