// Lower-bound lookup of two-column packed lattice keys (d = 4..6).
//
// Replaces no TPU kernel: the JAX package's direct lookup
// (lattice_net_tpu/lattice/structure.py, LatticeStructure.lookup, the
// counterpart of the reference's HashTableGPU::retrieve) is XLA code, a
// vectorised lower bound in log2(capacity) gather rounds.  No PyTorch call
// searches lexicographic pairs, so the port's two-column keys took the merged
// lookup before this kernel: a stable sort of [table; queries], two int64
// cummax scans and a sort back to query order, every pass as wide as the
// table's capacity plus the queries.  Semantics are those of lookup2_plain
// (ops_cuda/lookup.py):
//
//   out[i] = r     where table[r] == queries[i] and r < nr_verts
//            cap   elsewhere
//
// table is (cap, 2) int64, sorted lexicographically, its keys unique, the
// sentinel rows (INT64_MAX) from nr_verts on.  nr_verts is read here, on the
// card.  Only [0, nr_verts) is searched: a packed key fills at most 48 bits of
// a column, so no query equals a sentinel row and the ids are those of a
// search over the whole table.
//
// Bound on the card: bytes.  Each query is read once (16 B) and its id
// written once (4 B); the occupied prefix of the table (under 4 MB at the 5M
// tables) stays in the 50 MB L2, so the probes are cache hits.  Design: one
// thread a query in a grid-stride loop over as many blocks as the card holds
// at once, the next query's load issued before the current search.  The rows
// that the top kTopLevels levels of the implicit search tree probe (at most
// 2047, 32 KB) are staged in shared memory once a block, so only the last
// levels read the table.  The compare is branchless.
//
// C interface for ctypes; returns the first CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTopLevels = 11;
constexpr int kPivots = (1 << kTopLevels) - 1;
constexpr long long kPast = 0x7FFFFFFFFFFFFFFFLL;  // a sentinel row: above every key

__device__ __forceinline__ bool less2(const longlong2 a, const longlong2 b) {
  return (a.x < b.x) | ((a.x == b.x) & (a.y < b.y));
}

// The power-of-two lower bound of JAX's lookup over [0, n): pos ends as the
// number of rows below q (at most 2^(top + below) - 1), then one compare.
__device__ __forceinline__ int32_t search(const longlong2* __restrict__ table,
                                          const longlong2* pivots, long long n,
                                          int top, int below, int cap,
                                          const longlong2 q) {
  int pm = 0;
  for (int step = top ? 1 << (top - 1) : 0; step; step >>= 1) {
    const int c = pm + step;
    pm = less2(pivots[c - 1], q) ? c : pm;
  }
  long long pos = (long long)pm << below;
  for (long long step = below ? 1LL << (below - 1) : 0; step; step >>= 1) {
    const long long c = pos + step;
    const bool ok = c <= n;
    const longlong2 row = __ldg(table + (ok ? c - 1 : 0));
    pos = (ok & less2(row, q)) ? c : pos;
  }
  const bool in = pos < n;
  const longlong2 row = __ldg(table + (in ? pos : 0));
  return (in & (row.x == q.x) & (row.y == q.y)) ? (int32_t)pos : cap;
}

__global__ void __launch_bounds__(kThreads)
    lookup2_kernel(const longlong2* __restrict__ table,
                   const int32_t* __restrict__ nr_verts,
                   const longlong2* __restrict__ queries,
                   int32_t* __restrict__ out, long long nq, int cap) {
  __shared__ longlong2 pivots[kPivots];
  const int nv = *nr_verts;
  const long long n = nv < 0 ? 0 : (nv > cap ? cap : nv);
  const int nsteps = n > 1 ? 64 - __clzll(n - 1) : 0;
  const int top = nsteps < kTopLevels ? nsteps : kTopLevels;
  const int below = nsteps - top;
  // pivot m is row (m + 1) * 2^below - 1, the row the top levels probe at
  // that position; past the occupied rows it compares above every query
  for (int m = threadIdx.x; m < (1 << top) - 1; m += blockDim.x) {
    const long long row = ((long long)(m + 1) << below) - 1;
    pivots[m] = row < n ? table[row] : make_longlong2(kPast, kPast);
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  longlong2 q = __ldcs(queries + i);
  for (;;) {
    const long long next = i + stride;
    longlong2 qn = q;
    if (next < nq) qn = __ldcs(queries + next);
    out[i] = search(table, pivots, n, top, below, cap, q);
    if (next >= nq) break;
    i = next;
    q = qn;
  }
}

}  // namespace

extern "C" int lnt_lookup2(const void* table, const void* nr_verts,
                           const void* queries, void* out, long long nq,
                           long long cap, void* stream) {
  if (nq == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lookup2_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (nq + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  lookup2_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const longlong2*>(table),
      static_cast<const int32_t*>(nr_verts),
      static_cast<const longlong2*>(queries), static_cast<int32_t*>(out), nq,
      (int)cap);
  return (int)cudaGetLastError();
}
