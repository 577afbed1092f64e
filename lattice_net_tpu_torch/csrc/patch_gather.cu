// Lattice im2row patch gather (kernel K1 of the port).
//
// Replaces: lattice_net_tpu/ops_tpu/patch.py, _patch_gather_pallas (the
// pallas_call at line 133, kernel body _patch_kernel_factory), which the JAX
// package reaches through patch_gather from ops.gather_neighbor_values and
// ops.gather_rows_clustered.  Semantics are those of
// ops.gather_neighbor_values_xla:
//
//   out[q, a, :] = values[nbr[q, a], :]   for a < K, zero where the id is
//                                          outside [0, cap_src)
//   out[q, K, :] = values[row0 + q, :]    with include_center (same-level)
//
// ``row0`` is the table row of the first query: a conv whose patch would be
// too large runs in row blocks (lattice/ops._conv_fwd), and the block of
// queries row0 .. row0 + Q - 1 appends their own rows as its centre column,
// as JAX's chunked conv does (values[:cq] cut per block).
//
// Bound on the card: bytes.  The gather does no arithmetic; it reads each
// neighbour row and writes Q * (K + center) rows, so its least time is the
// bytes moved over the HBM rate.  The TPU kernel's windows, one-hot matmuls,
// coverage cond and [:q] padding exist because a TPU row gather is
// latency-bound; none of that carries over.
//
// Design: a pure byte copy, so the element type does not matter (bf16 and
// f32 tables take the same path).  One thread moves one 16-byte chunk of one
// output row; consecutive threads take consecutive chunks of the same patch
// row, so a warp covers one query row (or a few, for narrow rows) and both
// the reads of a neighbour row and the writes are coalesced 16-byte
// accesses.  Rows whose byte width is not a multiple of 16 (or unaligned
// pointers) fall back to 4-, 2- or 1-byte chunks.  A grid-stride loop keeps
// the grid at a few blocks per SM.  No shared memory, no atomics.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void patch_gather_kernel(const V* __restrict__ values,
                                    const int32_t* __restrict__ nbr,
                                    V* __restrict__ out, long long q, int k,
                                    int kk, long long cap_src, long long row0,
                                    int vec_per_row) {
  const long long total = q * kk * vec_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int j = (int)(i % vec_per_row);
    const long long t = i / vec_per_row;
    const int a = (int)(t % kk);
    const long long row = t / kk;
    const long long src = a < k ? (long long)__ldg(nbr + row * k + a) : row0 + row;
    V v{};
    if (src >= 0 && src < cap_src) v = __ldg(values + src * vec_per_row + j);
    out[i] = v;
  }
}

template <typename V>
cudaError_t launch(const void* values, const void* nbr, void* out, long long q,
                   int k, int kk, long long cap_src, long long row0,
                   long long row_bytes, cudaStream_t stream) {
  const int vec_per_row = (int)(row_bytes / sizeof(V));
  const long long total = q * kk * vec_per_row;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  patch_gather_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(values), static_cast<const int32_t*>(nbr),
      static_cast<V*>(out), q, k, kk, cap_src, row0, vec_per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lnt_patch_gather(const void* values, const void* nbr, void* out,
                                long long q, int k, int include_center,
                                long long cap_src, long long row_bytes,
                                long long row0, void* stream) {
  const int kk = k + (include_center ? 1 : 0);
  if (q == 0 || kk == 0 || row_bytes == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)values | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return (int)launch<uint4>(values, nbr, out, q, k, kk, cap_src, row0, row_bytes, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return (int)launch<uint32_t>(values, nbr, out, q, k, kk, cap_src, row0, row_bytes, s);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return (int)launch<uint16_t>(values, nbr, out, q, k, kk, cap_src, row0, row_bytes, s);
  return (int)launch<uint8_t>(values, nbr, out, q, k, kk, cap_src, row0, row_bytes, s);
}
