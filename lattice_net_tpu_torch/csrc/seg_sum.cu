// Segmented sum over sorted edge runs (kernel K3 of the port).
//
// Replaces: lattice_net_tpu/ops_tpu/segment.py, _seg_sum_pallas_impl (the
// pallas_call at line 142, kernel body _seg_sum_kernel), reached through
// seg_sum_sorted_fast from ops.seg_sum_sorted for C > 8: the edge-sort head
// adjoint (ops.gather_rows_clustered_segbwd) sums the permuted cotangent
// rows of each vertex with it.
//
//   out[v, c] = sum of vals[r, c] over v's run r in [start_v, end_v], in f32
//   empty runs give 0
//
// with end_v = run_end[v] (EdgeSort.run_end: the cummax of the run ends, so
// rows past nr_verts repeat the last end and come out empty) and start_v =
// run_end[v-1] + 1.  Edges past the last run (invalid vertex id = cap) are
// in no run and are dropped.
//
// Bound on the card: bytes.  Each edge row in a run is read once and each
// output row written once; one add per element read is free beside that.
//
// Design: K2's layout (csrc/seg_max.cu).  One warp per vertex run; lane l
// owns channels l, l+32, ...; it adds the run's rows in edge order into an
// f32 register starting at 0.  No atomics and no cross-block state, so the
// result is the same bits on every run.  For C = 28 a warp reads one
// 112-byte edge row per step.  The TPU kernel's one-hot MXU windows,
// HIGHEST-precision passes and _row_blocks range sweeps are VMEM
// workarounds with no counterpart: the run bounds come straight from
// run_end.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void seg_sum_kernel(const float* __restrict__ vals,
                               const int32_t* __restrict__ run_end,
                               float* __restrict__ out, int cap, int c) {
  const int v = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= cap) return;
  const int end = run_end[v];
  const int start = v == 0 ? 0 : run_end[v - 1] + 1;
  for (int ch = lane; ch < c; ch += 32) {
    float acc = 0.0f;
#pragma unroll 4
    for (int r = start; r <= end; ++r) acc += __ldg(vals + (long long)r * c + ch);
    out[(long long)v * c + ch] = acc;
  }
}

}  // namespace

extern "C" int lnt_seg_sum(const void* vals, const void* run_end, void* out,
                           int cap, int c, void* stream) {
  if (cap == 0 || c == 0) return (int)cudaGetLastError();
  const int blocks = (cap + kWarpsPerBlock - 1) / kWarpsPerBlock;
  seg_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(run_end),
      static_cast<float*>(out), cap, c);
  return (int)cudaGetLastError();
}
