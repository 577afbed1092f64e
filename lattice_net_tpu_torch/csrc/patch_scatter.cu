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
// The entry zeroes out itself (one cudaMemsetAsync), so the caller
// allocates it uninitialised.
//
// Bound on the card: bytes.  It reads g and the id table once and writes
// the (cap, C) table; one add per element of g is free beside that.
//
// Design.  A thread per scalar element of g meant 14.7 M scalar f32
// atomics for the head's (2^17, 4, 28) cotangent and a 64-bit division for
// each element's row and slot.  So, when C % 4 == 0, g
// is a flat array of float4 lanes (3.67 M at the head's shape), a thread a
// lane: its patch row is the lane index divided by C/4, and its point and
// slot that row divided by K(+1), both by multiply-high with a magic number
// the host computes (32-bit indices; the entry refuses a g of 2^31
// elements or more).  Each lane adds its float4 with one vector atomic
// (sm_90's atomicAdd on float4, a red.global.add.v4.f32 since the result is
// unused): a quarter of the atomic operations.  The (100000, 28) f32 table
// is 11.2 MB and stays in the H100's 50 MB L2, where the atomics resolve.
// Other widths take the same kernel on scalar floats.  What is left above
// the bound is the destinations' skew: the vertices near the sensor take
// hundreds of adds each, which serialise in L2 (chip_smoke.py times the
// same call with uniformly drawn ids beside it).  No warp aggregation of
// same-destination rows: the scene's points are not in lattice order, and
// a destination repeats within 32 consecutive points of one slot for only
// a few percent of the rows (chip_smoke.py prints the share, PERF.md).
//
// The atomics add in an order that changes from run to run, so the last
// bits of a shared row's sum do too: this kernel is not deterministic.  The
// deterministic head adjoint is the edge-sort one (LNT_HEAD_SEGVJP=1: the
// row gather K4 forward, the segmented sum K3 backward).
//
// C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// n / d for n < 2^31 by a multiply-high and a shift (Granlund-Montgomery):
// with s = ceil(log2 d) and magic = floor(2^32 (2^s - d) / d) + 1,
// n / d = (umulhi(n, magic) + n) >> s.
struct FastDiv {
  unsigned d, magic, shift;
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  const unsigned long long one = 1;
  return FastDiv{d, (unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ unsigned divide(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.magic) + n) >> f.shift;
}

__device__ __forceinline__ void add_to(float* p, float x) { atomicAdd(p, x); }

__device__ __forceinline__ void add_to(float4* p, float4 x) {
#if defined(__CUDA_ARCH__)  // the float4 overload is declared for the device pass only
  atomicAdd(p, x);
#endif
}

// T = float4 (C % 4 == 0) or float: `lanes` = Q * KK * C / width elements
// of g, one a thread; `row_len` = C / width of them a patch row, KK = K(+1)
// rows a point.
template <typename T>
__global__ void __launch_bounds__(256)
    patch_scatter_kernel(const T* __restrict__ g, const int32_t* __restrict__ nbr,
                         T* __restrict__ out, unsigned lanes, FastDiv row_len, FastDiv kk, int k,
                         int cap) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const unsigned t = divide(i, row_len);  // the patch row (q, a)
  const unsigned col = i - t * row_len.d;
  const unsigned q = divide(t, kk);
  const int a = (int)(t - q * kk.d);
  const int dst = a < k ? __ldg(nbr + (long long)q * k + a) : (int)q;
  if (dst >= 0 && dst < cap) add_to(out + (long long)dst * row_len.d + col, __ldg(g + i));
}

template <typename T>
void launch(const void* g, const void* nbr, void* out, unsigned lanes, int row_len, int kk, int k,
            int cap, cudaStream_t stream) {
  const int threads = 256;
  patch_scatter_kernel<T><<<(lanes + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(nbr), static_cast<T*>(out), lanes,
      fast_div(row_len), fast_div(kk), k, cap);
}

}  // namespace

// g (q, k + include_center, c) f32 and out (cap, c) f32 must be 16-byte
// aligned when c % 4 == 0 (the wrapper checks); q * (k + include_center) *
// c < 2^31.
extern "C" int lnt_patch_scatter(const void* g, const void* nbr, void* out, long long q, int k,
                                 int include_center, long long cap, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kk = k + (include_center ? 1 : 0);
  const long long total = q * kk * c;
  if (total >= (1ll << 31) || cap >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (cap * c > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(cap * c) * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (total == 0) return (int)cudaGetLastError();
  if (c % 4 == 0)
    launch<float4>(g, nbr, out, (unsigned)(total / 4), c / 4, kk, k, (int)cap, st);
  else
    launch<float>(g, nbr, out, (unsigned)total, c, kk, k, (int)cap, st);
  return (int)cudaGetLastError();
}
