// Consensus call per column from pileup counts summed over dp (Hopper, sm_90a).
//
// Replaces mia_tpu/parallel/sharded.py::consensus_from_counts and the psum
// over dp before it (inside make_assembly_step, :129-139): find_consensus
// with consensus code 1 (src/map_align.c:294-391) over columns whose counts
// and scores are the sum of n_parts partial accumulators, one per dp shard.
// A column with no coverage is N; one whose gap share reaches PERC4GAP
// percent is '-'; otherwise the best scoring base, a later base winning a
// tie (>=), or N when its score is below MIN_SCORE_CONS.  Semantics are
// those of mia_tpu_torch/parallel/sharded.py::consensus_from_parts: the
// int32 sum of the parts, wrapping as the psum does, then
// consensus_from_counts.
//
// What bounds it: bytes, n_parts x 36 read and one written a column, under
// a microsecond at the step's 17,024 columns: less than a launch's own
// latency, so the kernel's time is its launch.  What the design changes is
// the work around it: the step used to add the dp shards' accumulators
// with 2 (n_dp - 1) separate int32 adds (a launch and an allocation each)
// before one call per sp block; this kernel sums the parts as it reads
// them, so the step's tail is one launch per sp block (and one for a
// tail).  The parts' pointers travel by value in the launch's parameters
// (at most kMaxParts pairs).  One thread per column, nothing shared.
//
// The sums and the gap test's products are taken in uint32 and cast back:
// signed overflow is undefined in C++, and the plain version (torch int32,
// as JAX's int32) wraps, so unsigned arithmetic gives the same bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Duplicates of mia_tpu_torch.constants and of sharded.CONSENSUS_MAX_PARTS;
// mia_consensus_call_constants exports them so that the loader refuses a
// library that disagrees.
constexpr int kPerc4Gap = 50;
constexpr int kMinScoreCons = -399;
constexpr int kMaxParts = 32;   // 512 B of pointers in the launch's parameters
constexpr int kThreads = 256;

struct Parts {
  const int32_t* counts[kMaxParts];  // [n, 5] each
  const int32_t* scores[kMaxParts];  // [n, 4] each
};

__global__ void __launch_bounds__(kThreads)
consensus_call_kernel(const Parts parts, int n_parts, int n, uint8_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  uint32_t k[5] = {0, 0, 0, 0, 0}, s[4] = {0, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < kMaxParts; ++p) {
    if (p < n_parts) {  // static indices keep the pointers in the parameter space
      const int32_t* kp = parts.counts[p] + (int64_t)c * 5;
      const int32_t* sp = parts.scores[p] + (int64_t)c * 4;
#pragma unroll
      for (int j = 0; j < 5; ++j) k[j] += (uint32_t)__ldg(kp + j);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += (uint32_t)__ldg(sp + j);
    }
  }
  const int32_t cov = (int32_t)(k[0] + k[1] + k[2] + k[3] + k[4]);
  int32_t top = (int32_t)s[0];
  uint8_t best = 'A';
  if ((int32_t)s[1] >= top) { top = (int32_t)s[1]; best = 'C'; }
  if ((int32_t)s[2] >= top) { top = (int32_t)s[2]; best = 'G'; }
  if ((int32_t)s[3] >= top) { top = (int32_t)s[3]; best = 'T'; }
  uint8_t ch = top >= kMinScoreCons ? best : (uint8_t)'N';
  if ((int32_t)(k[4] * 100u) >= (int32_t)((uint32_t)kPerc4Gap * (uint32_t)cov)) ch = '-';
  if (cov == 0) ch = 'N';
  out[c] = ch;
}

}  // namespace

// counts[p] [n, 5] and scores[p] [n, 4] int32 for p < n_parts (host arrays
// of device pointers, 1 <= n_parts <= kMaxParts); out [n] bytes.
extern "C" int mia_consensus_call(const void* const* counts, const void* const* scores,
                                  int n_parts, int n, void* out, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Parts parts = {};
  for (int p = 0; p < n_parts; ++p) {
    parts.counts[p] = (const int32_t*)counts[p];
    parts.scores[p] = (const int32_t*)scores[p];
  }
  consensus_call_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(parts, n_parts, n, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// PERC4GAP, MIN_SCORE_CONS and the most parts a call sums, as built in.
// Fills at most n values of out; returns how many there are.
extern "C" int mia_consensus_call_constants(int32_t* out, int n) {
  const int32_t c[] = {kPerc4Gap, kMinScoreCons, kMaxParts};
  const int count = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}
