// Segmented max with the carry of the winner over sorted edge runs (kernel
// K2 of the port).
//
// Replaces: lattice_net_tpu/ops_tpu/segment.py, _seg_scan_packed (the
// pallas_call at line 413, kernel body _seg_scan_kernel_packed) and
// _seg_scan_pallas (line 298, _seg_scan_kernel), both reached through
// _seg_max_pallas_impl from ops.seg_max_sorted (the PointNet max-pool).
//
//   out_max[v, c]   = max of vals[r, c] over v's run r in [start_v, end_v]
//   out_carry[v, c] = carry[r*] for the LATEST r* attaining that max
//   empty runs give 0 in both outputs
//
// with end_v = run_end[v] (the cummax of EdgeSort.ends, so rows past
// nr_verts repeat the last end and come out empty) and start_v =
// run_end[v-1] + 1.
//
// Bound on the card: bytes.  Each edge value is read once and each output
// written once; the compares are free beside the traffic.
//
// Design: one warp per vertex run.  Lane l owns channels l, l+32, ...; it
// scans the run in order and takes x >= best, so ties go to the latest edge
// (the reference's rule), and it writes (max, carry) as a pure selection of
// input values: bit-exact, no atomics, no cross-block state.  For C = 32 a
// warp reads one 128-byte edge row per step.  The TPU kernel's grid carry,
// lane packing and run-end extraction have no counterpart: the run bounds
// come straight from run_end.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void seg_max_carry_kernel(const float* __restrict__ vals,
                                     const float* __restrict__ carry,
                                     const int32_t* __restrict__ run_end,
                                     float* __restrict__ out_max,
                                     float* __restrict__ out_carry, int cap,
                                     int c) {
  const int v = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= cap) return;
  const int end = run_end[v];
  const int start = v == 0 ? 0 : run_end[v - 1] + 1;
  for (int ch = lane; ch < c; ch += 32) {
    float best = 0.0f;
    float best_carry = 0.0f;
    for (int r = start; r <= end; ++r) {
      const float x = vals[(long long)r * c + ch];
      if (r == start || x >= best) {
        best = x;
        best_carry = carry[r];
      }
    }
    out_max[(long long)v * c + ch] = best;
    out_carry[(long long)v * c + ch] = best_carry;
  }
}

}  // namespace

extern "C" int lnt_seg_max_carry(const void* vals, const void* carry,
                                 const void* run_end, void* out_max,
                                 void* out_carry, int cap, int c, void* stream) {
  if (cap == 0 || c == 0) return (int)cudaGetLastError();
  const int blocks = (cap + kWarpsPerBlock - 1) / kWarpsPerBlock;
  seg_max_carry_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(carry),
      static_cast<const int32_t*>(run_end), static_cast<float*>(out_max),
      static_cast<float*>(out_carry), cap, c);
  return (int)cudaGetLastError();
}
