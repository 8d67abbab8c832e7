// Ungapped pileup counts of the dp x sp assembly step (Hopper, sm_90a).
//
// Replaces mia_tpu/parallel/sharded.py::_pileup_counts (inside
// make_assembly_step): every base of every read goes to the reference column
// starts[b] + r, where it ticks one of five counts (A, C, G, T, and code 4 in
// the fifth) and adds the PSSM score of each candidate base x in 0..3,
// psm[depth][x][base], strand-selected (the device half of add_base,
// src/map_align.c:229-263).  Semantics are those of
// mia_tpu_torch/parallel/sharded.py::_pileup_counts: rows past the read's
// length and columns outside [0, W) add nothing.
//
// What bounds it: atomics and bytes, not arithmetic.  A base reads 8 bytes
// and does five int32 atomic adds into W x 9 accumulators (0.6 MB at
// W = 17,024, resident in L2).  One thread per (read, row); neighbouring
// threads take neighbouring rows of one read, so a warp's atomics hit
// consecutive columns.  Both PSSMs (6.2 KB) sit in shared memory.  Integer
// sums are exact in any order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 31;           // PSSM depth slots
constexpr int kPsm = kDepth * 25;
constexpr int kMaxBlocks = 1 << 16;

__global__ void __launch_bounds__(kThreads)
pileup_counts_kernel(const int32_t* __restrict__ s2c, const int32_t* __restrict__ depths,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ starts,
                     const uint8_t* __restrict__ strands,
                     const int32_t* __restrict__ fpsm, const int32_t* __restrict__ rpsm,
                     int B, int L, int W, int32_t* __restrict__ counts,
                     int32_t* __restrict__ scores) {
  __shared__ int32_t sh_psm[2 * kPsm];
  for (int i = threadIdx.x; i < 2 * kPsm; i += blockDim.x)
    sh_psm[i] = i < kPsm ? fpsm[i] : rpsm[i - kPsm];
  __syncthreads();

  const int64_t total = (int64_t)B * L;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / L), r = (int)(i % L);
    if (r >= lengths[b]) continue;
    const int64_t col = (int64_t)starts[b] + r;
    if (col < 0 || col >= W) continue;
    const int base = s2c[i];
    if (base < 0 || base > 4) continue;
    int d = depths[i];
    d = d < 0 ? 0 : (d > kDepth - 1 ? kDepth - 1 : d);
    atomicAdd(&counts[col * 5 + base], 1);
    const int32_t* p = sh_psm + (strands[b] ? kPsm : 0) + d * 25 + base;
#pragma unroll
    for (int x = 0; x < 4; ++x) atomicAdd(&scores[col * 4 + x], p[x * 5]);
  }
}

}  // namespace

// s2c, depths [B, L] int32; lengths, starts [B] int32; strands [B] bytes;
// fpsm, rpsm [31, 5, 5] int32; counts [W, 5], scores [W, 4] int32, zeroed by
// the caller.
extern "C" int mia_pileup_counts(const void* s2c, const void* depths, const void* lengths,
                                 const void* starts, const void* strands,
                                 const void* fpsm, const void* rpsm, int B, int L, int W,
                                 void* counts, void* scores, void* stream) {
  if (B <= 0 || L <= 0 || W <= 0) return 0;
  int64_t blocks = ((int64_t)B * L + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pileup_counts_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)s2c, (const int32_t*)depths, (const int32_t*)lengths,
      (const int32_t*)starts, (const uint8_t*)strands, (const int32_t*)fpsm,
      (const int32_t*)rpsm, B, L, W, (int32_t*)counts, (int32_t*)scores);
  return (int)cudaGetLastError();
}
