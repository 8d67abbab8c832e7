// Consensus call per column from pileup counts (Hopper, sm_90a).
//
// Replaces mia_tpu/parallel/sharded.py::consensus_from_counts (inside
// make_assembly_step): find_consensus with consensus code 1
// (src/map_align.c:294-391) over columns.  A column with no coverage is N;
// one whose gap share reaches PERC4GAP percent is '-'; otherwise the best
// scoring base, a later base winning a tie (>=), or N when its score is
// below MIN_SCORE_CONS.  Semantics are those of
// mia_tpu_torch/parallel/sharded.py::consensus_from_counts.
//
// What bounds it: bytes.  A column reads 36 bytes and writes one; one thread
// per column, nothing shared.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Duplicates of mia_tpu_torch.constants; mia_consensus_call_constants
// exports them so that the loader refuses a library that disagrees.
constexpr int kPerc4Gap = 50;
constexpr int kMinScoreCons = -399;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
consensus_call_kernel(const int32_t* __restrict__ counts,
                      const int32_t* __restrict__ scores, int n,
                      uint8_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int32_t* k = counts + (int64_t)c * 5;
  const int32_t* s = scores + (int64_t)c * 4;
  const int cov = k[0] + k[1] + k[2] + k[3] + k[4];
  int top = s[0];
  uint8_t best = 'A';
  if (s[1] >= top) { top = s[1]; best = 'C'; }
  if (s[2] >= top) { top = s[2]; best = 'G'; }
  if (s[3] >= top) { top = s[3]; best = 'T'; }
  uint8_t ch = top >= kMinScoreCons ? best : (uint8_t)'N';
  if (k[4] * 100 >= kPerc4Gap * cov) ch = '-';
  if (cov == 0) ch = 'N';
  out[c] = ch;
}

}  // namespace

// counts [n, 5], scores [n, 4] int32; out [n] bytes.
extern "C" int mia_consensus_call(const void* counts, const void* scores, int n,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  consensus_call_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)counts, (const int32_t*)scores, n, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// PERC4GAP and MIN_SCORE_CONS as built in.  Fills at most n values of out;
// returns how many there are.
extern "C" int mia_consensus_call_constants(int32_t* out, int n) {
  const int32_t c[] = {kPerc4Gap, kMinScoreCons};
  const int count = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}
