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
// What bounds it: atomics and bytes, not arithmetic.  An observation reads
// 2 bytes and does up to 6 integer atomic adds into ~16.5k columns x 10
// int64 accumulators (1.3 MB, resident in L2).  The design is the simple
// one: one warp per record, its lanes striding over the record's span (so
// a warp's atomics hit consecutive columns), the strand/depth/base lookup
// table (5 KB) and the char tables in shared memory, and 64-bit atomicAdd
// into global accumulators.  Two's complement makes the unsigned 64-bit
// adds exact for signed sums, so the result does not depend on the order
// of the adds and there is no bound on the number of reads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;               // records in flight per block
constexpr int kDepth = 31;              // PSSM depth slots
constexpr int kLut = 2 * kDepth * 5 * 4;  // [strand][depth][read base][candidate]
constexpr int kMaxBlocks = 8192;

__global__ void __launch_bounds__(kWarps * 32)
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
  __shared__ int32_t sh_lut[kLut];
  __shared__ int8_t sh_base[256], sh_sub[256];
  // lut[s][d][b][q] = psm_s[d][q][b]: the score of candidate base q for an
  // observed base b at depth d (add_base's strand-specific matrix)
  for (int i = threadIdx.x; i < kLut; i += blockDim.x) {
    const int q = i % 4, b = (i / 4) % 5, d = (i / 20) % kDepth, s = i / (20 * kDepth);
    sh_lut[i] = (s ? rpsm : fpsm)[d * 25 + q * 5 + b];
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    sh_base[i] = base_idx[i];
    sh_sub[i] = sub_idx[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < R; r += gridDim.x * kWarps) {
    const int span = spans[r], st = starts[r];
    const int64_t so = seq_off[r], mo = smp_off[r];
    const int s = revs[r] ? 1 : 0;
    for (int k = lane; k < span; k += 32) {
      const int col = st + k;
      if (col < 0 || col >= n) continue;
      const int64_t si = so + k < seq_n - 1 ? so + k : seq_n - 1;
      const int64_t mi = mo + k < smp_n - 1 ? mo + k : smp_n - 1;
      const int ch = seq[si];
      int d = (int)smp[mi] - 'A';
      d = d < 0 ? 0 : (d > kDepth - 1 ? kDepth - 1 : d);
      const int cls = sh_base[ch];
      if (cls >= 0) atomicAdd(&counts[(int64_t)col * 5 + cls], 1ull);
      atomicAdd(&cov[col], 1ull);
      if (ch != '-') {
        const int32_t* l = sh_lut + ((s * kDepth + d) * 5 + sh_sub[ch]) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          atomicAdd(&scores[(int64_t)col * 4 + q], (unsigned long long)(long long)l[q]);
      }
    }
  }
}

}  // namespace

// counts [n, 5], cov [n], scores [n, 4]: int64, zeroed by the caller.
extern "C" int mia_column_counts(const void* seq, int64_t seq_n, const void* smp,
                                 int64_t smp_n, const void* starts, const void* spans,
                                 const void* seq_off, const void* smp_off,
                                 const void* revs, int R, const void* fpsm,
                                 const void* rpsm, const void* base_idx,
                                 const void* sub_idx, int n, void* counts, void* cov,
                                 void* scores, void* stream) {
  if (R <= 0 || n <= 0) return 0;
  if (seq_n <= 0 || smp_n <= 0) return (int)cudaErrorInvalidValue;
  int blocks = (R + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  column_counts_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, seq_n, (const uint8_t*)smp, smp_n, (const int32_t*)starts,
      (const int32_t*)spans, (const int32_t*)seq_off, (const int32_t*)smp_off,
      (const uint8_t*)revs, R, (const int32_t*)fpsm, (const int32_t*)rpsm,
      (const int8_t*)base_idx, (const int8_t*)sub_idx, n, (unsigned long long*)counts,
      (unsigned long long*)cov, (unsigned long long*)scores);
  return (int)cudaGetLastError();
}
