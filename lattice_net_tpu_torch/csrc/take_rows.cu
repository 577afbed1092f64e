// Clamped row gather (kernel K4 of the port).
//
// Replaces: lattice_net_tpu/ops_tpu/gather.py, _take_rows_impl (the
// pallas_call at line 52, kernel body _gather_kernel), the forward of
// take_rows, which the JAX package reaches through ops.gather_rows; the
// edge-sort head adjoint (ops.gather_rows_clustered_segbwd) gathers its
// forward rows through it.  Semantics are those of take_rows_reference:
//
//   out[i, :] = values[min(idx[i], cap - 1), :]    (ids below 0 read row 0)
//
// Bound on the card: bytes.  The gather does no arithmetic; it reads each
// referenced row and the ids once and writes m rows, so its least time is
// the bytes moved over the HBM rate.  The TPU kernel's whole-table VMEM
// block and its (cap, C) broadcast of each index column exist because
// Mosaic lowers only equal-shaped take_along_axis gathers; none of that
// carries over.
//
// Design: K1's byte copy (csrc/patch_gather.cu) with one id per output row
// and a clamp where K1 zeroes.  The element type does not matter (f32 and
// bf16 tables take the same path).  One thread moves one 16-byte chunk of
// one output row; consecutive threads take consecutive chunks of a row, so
// reads and writes are coalesced 16-byte accesses.  Rows whose byte width is
// not a multiple of 16 (or unaligned pointers) fall back to 4-, 2- or 1-byte
// chunks.  A grid-stride loop keeps the grid at a few blocks per SM.  No
// shared memory, no atomics.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void take_rows_kernel(const V* __restrict__ values,
                                 const int32_t* __restrict__ idx,
                                 V* __restrict__ out, long long m,
                                 long long cap, int vec_per_row) {
  const long long total = m * vec_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int j = (int)(i % vec_per_row);
    long long src = (long long)__ldg(idx + i / vec_per_row);
    src = src < 0 ? 0 : (src >= cap ? cap - 1 : src);
    out[i] = __ldg(values + src * vec_per_row + j);
  }
}

template <typename V>
cudaError_t launch(const void* values, const void* idx, void* out, long long m,
                   long long cap, long long row_bytes, cudaStream_t stream) {
  const int vec_per_row = (int)(row_bytes / sizeof(V));
  const long long total = m * vec_per_row;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  take_rows_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(values), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), m, cap, vec_per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lnt_take_rows(const void* values, const void* idx, void* out,
                             long long m, long long cap, long long row_bytes,
                             void* stream) {
  if (m == 0 || cap == 0 || row_bytes == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)values | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return (int)launch<uint4>(values, idx, out, m, cap, row_bytes, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return (int)launch<uint32_t>(values, idx, out, m, cap, row_bytes, s);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return (int)launch<uint16_t>(values, idx, out, m, cap, row_bytes, s);
  return (int)launch<uint8_t>(values, idx, out, m, cap, row_bytes, s);
}
