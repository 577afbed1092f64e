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
// in no run and are dropped.  ids (M,) are the sorted vertex ids the runs
// come from (EdgeSort.vertex).
//
// Bound on the card: bytes.  Each edge row in a run is read once and each
// output row written once; one add per element read is free beside that.
//
// Design.  The first version gave each vertex a warp whose lane l read the
// 4-byte channels l, l+32, ... of one edge row per step: one chain of
// dependent loads a lane, the run walked once per 32 channels (four times at
// C = 104), about a fifth of the card's memory rate.  Now:
// - Row lanes.  When C % 4 == 0 a row is C/4 float4 lanes, padded to a
//   power of two SW (8 lanes at C = 28 or 32, 32 at C = 104), and the warp
//   splits into G = 32 / SW lane groups; each lane keeps U rows in flight
//   (U = 4 at C = 28, 8 at C = 104).  Above C = 128 the warp loops over
//   128-channel slices.  Other widths take the scalar kernel below, the
//   first version's layout.
// - Three sizes of run.  On the SemanticKITTI scans (chip_smoke.py prints
//   them) the mean run is 17 edges, but three quarters of the edges lie in
//   runs of 32 or more (up to 857), which sit at consecutive vertices, and
//   every vertex past nr_verts (70% of cap) is empty.  A vertex block of 4
//   warps takes 4 * G consecutive vertices, one a group, loads their run
//   ends into shared memory at once, and writes zero rows with all its
//   threads when none has an edge.  A run of up to 2 U rows (4 U at G = 1)
//   is summed by its group alone, in edge order.  One of up to kChunk = 32
//   rows is summed by the whole warp afterwards, group g taking rows g, g +
//   G, ..., and the groups' sums added in group order (0 + 1, then + 2, then
//   + 3) by shuffles.  Longer runs are cut at the fixed 32-row chunks of the
//   edge array: pass 1 also gives each chunk a warp (chunk blocks, launched
//   first), which sums the pieces of the at most two long runs it meets
//   (the one holding its first row, and the one holding its last) into
//   part[chunk][0 or 1]; pass 2 gives each chunk a warp again, and the chunk
//   where a long run ends adds that run's pieces in chunk order into out[v].
//   So no warp reads more than 32 rows of a run.  These sizes were chosen
//   on the card against 8-warp blocks, two vertices a group, 16- to 128-row
//   chunks and 2 to 16 rows in flight a lane.
// - Deterministic order.  Each sum's order depends on the run bounds and C
//   only, so the result is the same bits on every run.  No atomics.
//
// C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps a block
constexpr int kChunk = 32;  // rows of a chunk; a run longer than this is cut into chunk pieces
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float4 shfl4(const float4& v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

__device__ __forceinline__ int2 run_of(const int32_t* __restrict__ run_end, int v) {
  return make_int2(v == 0 ? 0 : run_end[v - 1] + 1, run_end[v]);
}

// The sum, in edge order, of float4 column `col` over the rows start + q,
// start + q + nq, ... <= end, U rows in flight.  Lanes off the row add
// nothing and load nothing.
template <int U>
__device__ __forceinline__ float4 strided_sum(const float4* __restrict__ vals, int c4, int start,
                                              int end, int q, int nq, int col, bool on_row) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!on_row) return acc;
  for (int r0 = start + q; r0 <= end; r0 += nq * U) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * nq;
      x[u] = r <= end ? __ldg(vals + (long long)r * c4 + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * nq <= end) add4(acc, x[u]);
  }
  return acc;
}

// The sum of rows [start, end] over the warp's groups: group 0's lanes get
// the groups' sums added in group order.  Called by the whole warp.
template <int SW, int U>
__device__ __forceinline__ float4 warp_sum(const float4* __restrict__ vals, int c4, int start,
                                           int end, int col, int lane) {
  constexpr int G = 32 / SW;
  const float4 acc = strided_sum<U>(vals, c4, start, end, lane / SW, G, col, col < c4);
  float4 t = acc;
#pragma unroll
  for (int k = 1; k < G; ++k) add4(t, shfl4(acc, (lane + k * SW) & 31));
  return t;
}

// Pass 1.  Blocks [0, chunk_blocks) are chunk blocks, a chunk a warp; the
// rest are vertex blocks of kWarps * G vertices, one a group.
template <int SW, int U>
__global__ void __launch_bounds__(kWarps * 32)
    seg_sum_vec_kernel(const float4* __restrict__ vals, const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ run_end, float4* __restrict__ out,
                       float4* __restrict__ part, int m, int cap, int c4, int chunk_blocks) {
  constexpr int G = 32 / SW, kSpan = kWarps * G;
  constexpr int kGroupRows = (G == 1 ? 4 : 2) * U;  // a run a group sums alone
  __shared__ int ends[kSpan + 1];    // run_end[v0 - 1 .. v0 + kSpan - 1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / SW, j = lane % SW;
  if (blockIdx.x < chunk_blocks) {  // no block barrier in a chunk block
    const int k = blockIdx.x * kWarps + warp;
    const int first = k * kChunk;
    if (first >= m) return;
    const int last = min(first + kChunk, m) - 1;
    const int vh = ids[first], vt = ids[last];
    if (vh < cap) {  // the run holding the chunk's first row
      const int2 run = run_of(run_end, vh);
      if (run.y - run.x + 1 > kChunk) {
        for (int s = 0; s < c4; s += 32) {
          const float4 t = warp_sum<SW, U>(vals, c4, first, min(run.y, last), s + j, lane);
          if (g == 0 && s + j < c4) part[(long long)(2 * k) * c4 + s + j] = t;
        }
      }
    }
    if (vt < cap && vt != vh) {  // a run starting inside the chunk and holding its last row
      const int2 run = run_of(run_end, vt);
      if (run.y - run.x + 1 > kChunk) {
        for (int s = 0; s < c4; s += 32) {
          const float4 t = warp_sum<SW, U>(vals, c4, run.x, last, s + j, lane);
          if (g == 0 && s + j < c4) part[(long long)(2 * k + 1) * c4 + s + j] = t;
        }
      }
    }
    return;
  }
  const int v0 = (blockIdx.x - chunk_blocks) * kSpan;
  const int nv = min(kSpan, cap - v0);
  for (int i = threadIdx.x; i <= kSpan; i += blockDim.x) {
    const int v = v0 - 1 + min(i, nv);
    ends[i] = v < 0 ? -1 : run_end[v];
  }
  __syncthreads();
  if (ends[0] == ends[kSpan]) {  // no edge in the block's vertices: zero rows
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < nv * c4; i += blockDim.x) out[(long long)v0 * c4 + i] = z;
    return;
  }
  const int i = warp * G + g;  // the group's vertex
  const int start = ends[i] + 1, end = ends[i + 1], n = i < nv ? end - start + 1 : -1;
  if (n >= 0 && n <= kGroupRows) {  // the group alone
    for (int s = 0; s < c4; s += 32) {
      const float4 t = strided_sum<U>(vals, c4, start, end, 0, 1, s + j, s + j < c4);
      if (s + j < c4) out[(long long)(v0 + i) * c4 + s + j] = t;
    }
  }
  // runs of kGroupRows + 1 to kChunk rows, the whole warp on each in turn
  unsigned medium = __ballot_sync(kFull, j == 0 && n > kGroupRows && n <= kChunk);
  while (medium) {
    const int src = __ffs(medium) - 1;
    medium &= medium - 1;
    const int vi = __shfl_sync(kFull, i, src);
    const int s0 = __shfl_sync(kFull, start, src), e0 = __shfl_sync(kFull, end, src);
    for (int s = 0; s < c4; s += 32) {
      const float4 t = warp_sum<SW, U>(vals, c4, s0, e0, s + j, lane);
      if (g == 0 && s + j < c4) out[(long long)(v0 + vi) * c4 + s + j] = t;
    }
  }
}

// Pass 2: the warp of the chunk where a long run ends adds its pieces, in
// chunk order, 4 loads in flight; lane l takes float4 columns l, l + 32, ...
__global__ void __launch_bounds__(kWarps * 32)
    seg_sum_long_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ run_end,
                        const float4* __restrict__ part, float4* __restrict__ out, int m,
                        int cap, int c4) {
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int first = k * kChunk;
  if (first >= m) return;
  const int v = ids[first];
  if (v >= cap) return;
  const int2 run = run_of(run_end, v);
  if (run.y - run.x + 1 <= kChunk || run.y >= first + kChunk) return;
  const int j0 = run.x / kChunk;
  for (int col = lane; col < c4; col += 32) {
    float4 tot = part[(long long)(2 * j0 + (run.x != j0 * kChunk)) * c4 + col];
    for (int jj = j0 + 1; jj <= k; jj += 4) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (jj + u <= k) x[u] = part[(long long)(2 * (jj + u)) * c4 + col];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (jj + u <= k) add4(tot, x[u]);
    }
    out[(long long)v * c4 + col] = tot;
  }
}

// Any C: one warp per vertex, lane l owns channels l, l+32, ... and adds
// the run's rows in edge order.
__global__ void seg_sum_scalar_kernel(const float* __restrict__ vals,
                                      const int32_t* __restrict__ run_end,
                                      float* __restrict__ out, int cap, int c) {
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
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

struct Args {
  const void *vals, *ids, *run_end;
  void *out, *part;
  int m, cap, c4;
};

template <int SW>
void launch_vec(const Args& a, cudaStream_t stream) {
  constexpr int G = 32 / SW;
  constexpr int U = G == 1 ? 8 : 4;  // rows in flight a lane
  constexpr int kSpan = kWarps * G;
  const int chunks = (a.m + kChunk - 1) / kChunk;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int vertex_blocks = (a.cap + kSpan - 1) / kSpan;
  seg_sum_vec_kernel<SW, U><<<chunk_blocks + vertex_blocks, kWarps * 32, 0, stream>>>(
      static_cast<const float4*>(a.vals), static_cast<const int32_t*>(a.ids),
      static_cast<const int32_t*>(a.run_end), static_cast<float4*>(a.out),
      static_cast<float4*>(a.part), a.m, a.cap, a.c4, chunk_blocks);
  if (chunk_blocks == 0) return;
  seg_sum_long_kernel<<<chunk_blocks, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(a.ids), static_cast<const int32_t*>(a.run_end),
      static_cast<const float4*>(a.part), static_cast<float4*>(a.out), a.m, a.cap, a.c4);
}

}  // namespace

// 4-byte elements of the scratch `part` that lnt_seg_sum needs for m edge
// rows of c channels (0 for the scalar kernel).
extern "C" long long lnt_seg_sum_scratch(int m, int c) {
  if (c % 4 != 0) return 0;
  return (long long)((m + kChunk - 1) / kChunk) * 2 * c;
}

// vals, out and part must be 16-byte aligned when c % 4 == 0 (the wrapper
// checks), part of lnt_seg_sum_scratch(m, c) elements.
extern "C" int lnt_seg_sum(const void* vals, const void* ids, const void* run_end, void* out,
                           void* part, int m, int cap, int c, void* stream) {
  if (cap == 0 || c == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 4 != 0) {
    seg_sum_scalar_kernel<<<(cap + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(run_end),
        static_cast<float*>(out), cap, c);
    return (int)cudaGetLastError();
  }
  const Args a{vals, ids, run_end, out, part, m, cap, c / 4};
  if (a.c4 <= 1) launch_vec<1>(a, st);
  else if (a.c4 <= 2) launch_vec<2>(a, st);
  else if (a.c4 <= 4) launch_vec<4>(a, st);
  else if (a.c4 <= 8) launch_vec<8>(a, st);
  else if (a.c4 <= 16) launch_vec<16>(a, st);
  else launch_vec<32>(a, st);
  return (int)cudaGetLastError();
}
