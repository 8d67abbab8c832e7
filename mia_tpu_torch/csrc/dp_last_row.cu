// General-width semi-global DP scorer: the whole last row per read
// (Hopper, sm_90a).
//
// Replaces the general form of mia_tpu/ops/dp_pallas.py::_dp_kernel
// (launched by pallas_last_row) and its XLA twin
// mia_tpu/ops/dp_jax.py::batch_last_row: any reference width W, a reference
// row shared by the batch or one per read, and the DP row at each read's
// last row [B, W] as the result (csrc/dp_entries.cu is the same recurrence
// specialised to 384-column windows with (best, aec) out).  Integer
// semantics are those of mia_tpu_torch/ops/dp_torch.py::batch_last_row
// (int32, HIM in masked columns, LOW below every live value, restart only on
// a strict >), so the rows agree bit for bit, sentinels included.
//
// What bounds it: integer ALU work, not bytes.  A cell costs about 14 int32
// operations, while a read moves W mask bytes in and 4 W bytes out once.
// But a row of W = 17,024 columns is too wide for the registers of one warp,
// so the rows live in shared memory and the design is:
//   * one thread block per read (a grid-stride loop over the batch); thread
//     t owns the C = ceil(W / threads) consecutive columns from t * C, so a
//     thread's column-gap prefix max is a serial max over its own columns;
//   * prev, prev2 (rotating) and the running row-gap max in shared memory,
//     3 x 4 x W bytes, beside one byte per column that packs the reference
//     code and the three mask bits the recurrence needs (this column open,
//     the next open, the next but one open): 13 W bytes, 221 KB at
//     W = 17,024, asked for with cudaFuncSetAttribute.  Wider rows go to a
//     scratch buffer in global memory that the wrapper allocates;
//   * per row two passes over a thread's columns and two barriers: pass 1
//     updates the row-gap max and takes the thread's prefix-max total, a
//     block scan (warp shuffles, one carry per warp through shared memory)
//     turns the totals into each thread's exclusive prefix, pass 2 writes
//     the new row over prev2;
//   * the row loop ends at the read's own last row;
//   * the priority chain restart > diagonal > column gap > row gap reduces
//     to one max (values only, no traceback here).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Duplicates of the Python side's values (mia_tpu_torch.constants,
// dp_torch._LOW, dp_cuda.LAST_ROW_SMEM); mia_dp_last_row_constants exports
// them so that the loader refuses a library that disagrees.
constexpr int GOP = 1000;
constexpr int GEP = 200;
constexpr int HIM = -1073741824;             // INT_MIN / 2
constexpr int LOW = -(1 << 30) - (1 << 29);  // below any live value
constexpr int kDepth = 31;                   // PSSM depth slots
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 227 * 1024 - 1024;  // dynamic bytes a block may ask for here
constexpr unsigned FULL = 0xffffffffu;

constexpr int F_CODE = 7;    // bits 0-2: reference code 0..4
constexpr int F_OPEN = 8;    // this column is open
constexpr int F_UPD = 16;    // column c + 1 is open: the row-gap max at c updates
constexpr int F_CAND = 32;   // column c + 2 is open, or c == 0: a column-gap origin

__device__ __forceinline__ int sub_for(int code, int s0, int s1, int s2, int s3, int s4) {
  int v = s4;
  v = code == 0 ? s0 : v;
  v = code == 1 ? s1 : v;
  v = code == 2 ? s2 : v;
  v = code == 3 ? s3 : v;
  return v;
}

__device__ __forceinline__ int warp_scan_max(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = max(v, t);
  }
  return v;
}

// ints one block's rows and flags take: 3 rows of W and W flag bytes
__host__ __device__ inline int64_t block_ints(int W) { return 3 * (int64_t)W + (W + 3) / 4; }

__global__ void __launch_bounds__(kMaxThreads, 1)
dp_last_row_kernel(const int32_t* __restrict__ s1c, int s1c_per_read,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ s2c,
                   const int32_t* __restrict__ depths,
                   const int32_t* __restrict__ submat,
                   const int32_t* __restrict__ lengths, int B, int W, int L, int sg5,
                   int C, int32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  extern __shared__ int32_t dyn[];
  __shared__ int32_t sh_tot[32], sh_x[32];

  int32_t* base = scratch ? scratch + blockIdx.x * block_ints(W) : dyn;
  int32_t* prev = base;
  int32_t* prev2 = base + W;
  int32_t* rbest = base + 2 * (int64_t)W;
  uint8_t* flags = (uint8_t*)(base + 3 * (int64_t)W);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c0 = min(tid * C, W), c1 = min(c0 + C, W);

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int32_t* ref = s1c + (s1c_per_read ? (int64_t)b * W : 0);
    const uint8_t* mk = mask + (int64_t)b * W;
    // a read whose last row lies outside [0, L) keeps row 0 (the plain
    // version's loop never reaches its snapshot row)
    int last = lengths[b] - 1;
    if (last < 0 || last >= L) last = 0;

    // the 5 substitution scores of a row, the same for every column
    auto row_scores = [&](int row, int& s0, int& s1, int& s2, int& s3, int& s4) {
      const int64_t at = (int64_t)b * L + row;
      int d = depths[at], x = s2c[at];
      d = d < 0 ? 0 : (d > kDepth - 1 ? kDepth - 1 : d);
      x = x < 0 ? 0 : (x > 4 ? 4 : x);
      const int32_t* p = submat + d * 25 + x;
      s0 = p[0]; s1 = p[5]; s2 = p[10]; s3 = p[15]; s4 = p[20];
    };

    // ---- flags and row 0 ---------------------------------------------------
    {
      int s0, s1, s2, s3, s4;
      row_scores(0, s0, s1, s2, s3, s4);
      for (int c = c0; c < c1; ++c) {
        int code = ref[c];
        code = code < 0 ? 0 : (code > 4 ? 4 : code);
        const int m0 = mk[c] != 0;
        const int m1 = c + 1 < W && mk[c + 1] != 0;
        const int m2 = (c + 2 < W && mk[c + 2] != 0) || c == 0;
        flags[c] = (uint8_t)(code | (m0 ? F_OPEN : 0) | (m1 ? F_UPD : 0) | (m2 ? F_CAND : 0));
        const int v = m0 ? sub_for(code, s0, s1, s2, s3, s4) : HIM;
        prev[c] = v;
        prev2[c] = LOW;
        rbest[c] = v;
      }
    }
    __syncthreads();

    // ---- rows 1 .. last ----------------------------------------------------
    for (int row = 1; row <= last; ++row) {
      int s0, s1, s2, s3, s4;
      row_scores(row, s0, s1, s2, s3, s4);
      const int sg5_pen = sg5 ? GOP + GEP * (row + 1) : 0;
      const int start_new = -sg5_pen;
      const int grow_cost = GOP + GEP * (row - 1);
      const int radd = GEP * (row - 2);

      // pass 1: the row-gap max over rows <= row - 2, and this thread's
      // prefix-max total of prev[c] + GEP c over the open origins (`t2`: the
      // same without its last column)
      int run = LOW, t2 = LOW;
      for (int c = c0; c < c1; ++c) {
        const int f = flags[c];
        if (c == c1 - 1) t2 = run;
        if (f & F_CAND) run = max(run, prev[c] + GEP * c);
        if (row >= 2 && (f & F_UPD)) {
          const int cr = prev2[c] + radd;
          if (cr > rbest[c]) rbest[c] = cr;
        }
      }
      // block scan of the totals: inclusive in the warp, then one carry per warp
      const int inc = warp_scan_max(run, lane);
      int excl_w = __shfl_up_sync(FULL, inc, 1);
      if (lane == 0) excl_w = LOW;
      // prefix over the columns up to this thread's last but one (warp scope)
      const int x = max(excl_w, t2);
      if (lane == 31) {
        sh_tot[warp] = inc;
        sh_x[warp] = x;
      }
      __syncthreads();
      const int sc = warp_scan_max(lane < nwarps ? sh_tot[lane] : LOW, lane);
      const int carry_a = __shfl_sync(FULL, sc, warp > 0 ? warp - 1 : 0);
      const int carry_b = __shfl_sync(FULL, sc, warp > 1 ? warp - 2 : 0);
      const int carry = warp > 0 ? carry_a : LOW;        // columns of earlier warps
      const int carry_prev = warp > 1 ? carry_b : LOW;   // ... of warps before the last
      // rm[c0 - 1] and rm[c0 - 2]: the inclusive prefix max at the two columns
      // before this thread's first (C >= 2: both lie in the previous thread)
      int rm1 = max(carry, excl_w);
      int rm2 = max(carry, __shfl_up_sync(FULL, x, 1));
      if (lane == 0) rm2 = warp > 0 ? max(carry_prev, sh_x[warp - 1]) : LOW;

      // pass 2: the new row, written over prev2
      int diag_prev = c0 > 0 && c0 < W ? prev[c0 - 1] : LOW;
      int rb_prev = c0 > 0 && c0 < W ? rbest[c0 - 1] : LOW;
      int run2 = rm1;
      for (int c = c0; c < c1; ++c) {
        const int f = flags[c];
        const int p = prev[c];
        const int rb = rbest[c];
        const int gap_col = c >= 2 ? rm2 - (GOP + GEP * (c - 1)) : HIM;
        const int gap_row = (row >= 2 && c >= 1) ? rb_prev - grow_cost : HIM;
        const int diag = c >= 1 ? diag_prev : LOW;
        const int bs = max(max(diag, gap_col), gap_row);
        const int cell = sub_for(f & F_CODE, s0, s1, s2, s3, s4);
        int v = start_new > bs ? start_new : cell + bs;
        if (c == 0) v = cell - sg5_pen;
        prev2[c] = (f & F_OPEN) ? v : HIM;
        if (f & F_CAND) run2 = max(run2, p + GEP * c);
        rm2 = rm1;
        rm1 = run2;
        diag_prev = p;
        rb_prev = rb;
      }
      __syncthreads();
      int32_t* t = prev;
      prev = prev2;
      prev2 = t;
    }

    int32_t* o = out + (int64_t)b * W;
    for (int c = c0; c < c1; ++c) o[c] = prev[c];
    // the next read's prologue writes only this thread's own columns, and a
    // barrier follows it before any thread reads a neighbour's
  }
}

}  // namespace

// s1c [W] (s1c_per_read 0) or [B, W] int32 codes; mask [B, W] bytes;
// s2c [B, L], depths [B, L], submat [31, 5, 5] int32; lengths [B] int32;
// out [B, W] int32.  `threads` is a
// multiple of 32 up to 1024, `blocks` at most B.  `scratch` is null when
// 4 * block_ints(W) fits the shared memory a block may ask for
// (mia_dp_last_row_constants), else [blocks, block_ints(W)] int32.
extern "C" int mia_dp_last_row(const void* s1c, int s1c_per_read, const void* mask,
                               const void* s2c, const void* depths, const void* submat,
                               const void* lengths, int B, int W, int L, int sg5,
                               int threads, int blocks, void* scratch, void* out,
                               void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (L < 1 || threads < 32 || threads > kMaxThreads || threads % 32 || blocks < 1 ||
      blocks > B)
    return (int)cudaErrorInvalidValue;
  int C = (W + threads - 1) / threads;
  if (C < 2) C = 2;
  const int64_t bytes = 4 * block_ints(W);
  size_t dyn = 0;
  if (!scratch) {
    if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
    dyn = (size_t)bytes;
    const cudaError_t e = cudaFuncSetAttribute(
        dp_last_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  dp_last_row_kernel<<<blocks, threads, dyn, (cudaStream_t)stream>>>(
      (const int32_t*)s1c, s1c_per_read, (const uint8_t*)mask, (const int32_t*)s2c,
      (const int32_t*)depths, (const int32_t*)submat, (const int32_t*)lengths, B, W, L, sg5, C, (int32_t*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The compile-time constants of this kernel, in this order: GOP, GEP, HIM,
// LOW, PSSM depth slots, the dynamic shared memory limit in bytes.  Fills at
// most n values of out; returns how many there are.
extern "C" int mia_dp_last_row_constants(int32_t* out, int n) {
  const int32_t c[] = {GOP, GEP, HIM, LOW, kDepth, kSmemLimit};
  const int count = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = c[i];
  return count;
}
