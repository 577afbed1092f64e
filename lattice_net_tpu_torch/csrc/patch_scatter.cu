// Adjoint of the lattice im2row patch gather (kernel K1-bwd of the port).
//
// Replaces: lattice_net_tpu/ops_tpu/patch.py, _patch_gather_bwd (the VJP of
// patch_gather, whose forward is the pallas_call at line 133), an XLA f32
// scatter-add.  The port runs it for the head's per-point gather
// (ops.gather_rows_clustered); every conv's backward is another forward
// gather (the flip-neighbours adjoint) and does not come here.
//
//   out[nbr[q, a], :] += g[q, a, :]   for a < K and 0 <= nbr[q, a] < cap
//   out[q, :]         += g[q, K, :]   with include_center (the centre column)
//
// out must be zeroed by the caller.
//
// Bound on the card: bytes.  It reads g and the id table once and writes
// the (cap, C) table; one add per element of g is free beside that.
//
// Design: one thread per element of g, consecutive threads on consecutive
// channels of one patch row, so the reads of g are coalesced and the adds
// of one row land on one contiguous row of out.  Rows of out that several
// patch entries share are summed with f32 atomicAdd: the order of those
// adds, and so the last bits of a sum, change from run to run.  (A
// deterministic run-wise sum over the edge sort is the seg-sum kernel's
// work, not this one's.)  A grid-stride loop keeps the grid at a few blocks
// per SM.  No shared memory.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void patch_scatter_kernel(const float* __restrict__ g,
                                     const int32_t* __restrict__ nbr,
                                     float* __restrict__ out, long long q, int k,
                                     int kk, long long cap, int c) {
  const long long total = q * kk * c;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int ch = (int)(i % c);
    const long long t = i / c;
    const int a = (int)(t % kk);
    const long long row = t / kk;
    const long long dst = a < k ? (long long)__ldg(nbr + row * k + a) : row;
    if (dst >= 0 && dst < cap) atomicAdd(out + dst * c + ch, __ldg(g + i));
  }
}

}  // namespace

extern "C" int lnt_patch_scatter(const void* g, const void* nbr, void* out,
                                 long long q, int k, int include_center,
                                 long long cap, int c, void* stream) {
  const int kk = k + (include_center ? 1 : 0);
  const long long total = q * kk * c;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  patch_scatter_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(nbr),
      static_cast<float*>(out), q, k, kk, cap, c);
  return (int)cudaGetLastError();
}
