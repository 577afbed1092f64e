// Adjoint of the segmented max with carry (kernel K2-bwd of the port).
//
// Replaces: lattice_net_tpu/ops_tpu/segment.py, _seg_max_fast_bwd (the VJP
// of seg_max_carry_sorted_fast), which re-runs the Pallas segmented scan of
// _seg_scan_packed (the pallas_call at line 413) on f32 row positions to
// find each (vertex, channel)'s winning edge.
//
//   winner r*(v, c) = the LATEST edge r of v's run with vals[r, c] ==
//                     maxed[v, c] (the forward's tie rule)
//   d_vals[r*, c]  = g_max[v, c]; 0 everywhere else, including edges that
//                    lie in no run
//   d_carry[r]     = sum of g_carry[v, c] over the channels c that r wins
//
// with the run of v = [run_end[v-1] + 1, run_end[v]] as in seg_max.cu.
// d_vals and d_carry must be zeroed by the caller.
//
// Bound on the card: bytes.  It reads the edge values of every run, the
// run ends and the three (cap, C) tables, and writes d_vals and d_carry;
// the compares are free beside that traffic.
//
// Design: one warp per vertex run, as in the forward.  Lane l takes channel
// base + l and walks its run from the end back to the first match, so it
// reads only the suffix after its winner.  d_vals is a pure selection of
// g_max (bit-exact).  d_carry sums over channels in one warp: the lanes
// whose winners coincide are summed with shuffles, one distinct winner at
// a time, and lane 0 adds the sum to d_carry[r].  The warp owns every edge
// of its run, so no atomics are needed.  The TPU's second scan over f32
// positions (exact only below 2^24 edges) has no counterpart here.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void seg_max_bwd_kernel(const float* __restrict__ vals,
                                   const int32_t* __restrict__ run_end,
                                   const float* __restrict__ maxed,
                                   const float* __restrict__ g_max,
                                   const float* __restrict__ g_carry,
                                   float* __restrict__ d_vals,
                                   float* __restrict__ d_carry, int cap, int c) {
  const int v = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= cap) return;  // uniform over the warp
  const int end = run_end[v];
  const int start = v == 0 ? 0 : run_end[v - 1] + 1;
  if (start > end) return;  // empty run, uniform over the warp
  for (int base = 0; base < c; base += 32) {
    const int ch = base + lane;
    int win = -1;
    float gc = 0.0f;
    if (ch < c) {
      const long long vc = (long long)v * c + ch;
      const float m = maxed[vc];
      for (int r = end; r >= start; --r) {
        if (vals[(long long)r * c + ch] == m) {
          win = r;
          break;
        }
      }
      if (win >= 0) {
        d_vals[(long long)win * c + ch] = g_max[vc];
        gc = g_carry[vc];
      }
    }
    unsigned pending = __ballot_sync(kFull, win >= 0);
    while (pending) {
      const int r = __shfl_sync(kFull, win, __ffs(pending) - 1);
      const bool mine = win == r;
      float s = mine ? gc : 0.0f;
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) d_carry[r] += s;
      pending &= ~__ballot_sync(kFull, mine);
    }
  }
}

}  // namespace

extern "C" int lnt_seg_max_bwd(const void* vals, const void* run_end,
                               const void* maxed, const void* g_max,
                               const void* g_carry, void* d_vals, void* d_carry,
                               int cap, int c, void* stream) {
  if (cap == 0 || c == 0) return (int)cudaGetLastError();
  const int blocks = (cap + kWarpsPerBlock - 1) / kWarpsPerBlock;
  seg_max_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(run_end),
      static_cast<const float*>(maxed), static_cast<const float*>(g_max),
      static_cast<const float*>(g_carry), static_cast<float*>(d_vals),
      static_cast<float*>(d_carry), cap, c);
  return (int)cudaGetLastError();
}
