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
// run_end[v-1] + 1.  Edges past the last run (invalid vertex id = cap) are
// in no run.  ids (M,) are the sorted vertex ids the runs come from
// (EdgeSort.vertex); the kernel reads them at its chunk bounds only.  The
// kernel writes every element of both outputs, once: the caller allocates
// them uninitialised.
//
// Bound on the card: bytes.  Each edge row in a run and its carry are read
// once, the run ends once, and each output written once; the compares are
// free beside that traffic.
//
// Design.  A warp a vertex, scanning its run one row at a time, kept one
// 4-byte load in flight a lane, idled on the 70% of empty runs and left the
// longest run (857 edges on a SemanticKITTI scan) to one warp.  So, with
// seg_max_bwd.cu's layout:
// - Row lanes.  When C % 4 == 0 and C <= 128 a row is C/4 float4 lanes,
//   padded to a power of two SW, in G = 32 / SW lane groups (8 lanes and 4
//   groups at C = 32); each lane keeps U = 4 rows in flight (8 at G = 1).
// - Three sizes of run.  A vertex block of 4 warps takes 4 * G consecutive
//   vertices, one a group, loads their run ends into shared memory at once,
//   and writes zeros with all its threads when none has an edge.  A run of
//   up to 2 U rows (4 U at G = 1) is done by its group alone; one of up to
//   kChunk = 32 rows by the whole warp, group g taking rows g, g + G, ...;
//   longer runs are cut at the fixed 32-row chunks of the edge array: pass
//   1 gives each chunk a warp (chunk blocks, launched first), which finds
//   the (max, winning row) per channel of the at most two long-run pieces
//   in its chunk into part[chunk][0 or 1], and in pass 2 the warp of the
//   chunk where a long run ends merges that run's pieces and writes it.
// - The tie rule across groups and pieces.  Each lane walks its rows
//   forwards and takes x >= best, so within a lane the latest maximal row
//   wins.  Groups and pieces merge by the pair (value, row): the larger
//   value wins and, on equal values, the larger row.  That equals the
//   serial scan's rule on every non-NaN input, signed zeros included (==
//   puts -0.0 and 0.0 together, and the later of them wins either way), and
//   the merge is order-free.  The winner's carry is read once, at the end:
//   both outputs are a pure selection of input values, bit-equal to the
//   reference, no atomics.
// - Other widths (C % 4 != 0, C > 128) take the scalar kernel below, a
//   warp a vertex.  The TPU kernel's grid carry, lane packing and
//   run-end extraction have no counterpart: the run bounds come straight
//   from run_end.
//
// C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps a block
constexpr int kChunk = 32;  // rows of a chunk; a run longer than this is cut into chunk pieces
constexpr unsigned kFull = 0xffffffffu;

// Per channel of a float4 column: the best value so far and its row (-1:
// none yet).
struct Best {
  float4 v;
  int4 r;
};

__device__ __forceinline__ Best no_best() {
  return Best{make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY), make_int4(-1, -1, -1, -1)};
}

// (v, r) beats (bv, br): the larger value, on equal values the larger row.
__device__ __forceinline__ void take(float& bv, int& br, float v, int r) {
  if (v > bv || (v == bv && r > br)) {
    bv = v;
    br = r;
  }
}

__device__ __forceinline__ void merge(Best& a, const Best& b) {
  take(a.v.x, a.r.x, b.v.x, b.r.x);
  take(a.v.y, a.r.y, b.v.y, b.r.y);
  take(a.v.z, a.r.z, b.v.z, b.r.z);
  take(a.v.w, a.r.w, b.v.w, b.r.w);
}

__device__ __forceinline__ int2 run_of(const int32_t* __restrict__ run_end, int v) {
  return make_int2(v == 0 ? 0 : run_end[v - 1] + 1, run_end[v]);
}

// The best (value, row) per channel of float4 column `col` over the rows
// start + q, start + q + nq, ... <= end, U rows in flight, walked forwards
// with >= so that the latest maximal row wins.
template <int U>
__device__ __forceinline__ Best scan_rows(const float4* __restrict__ vals, int c4, int start,
                                          int end, int q, int nq, int col) {
  Best b = no_best();
  if (col >= c4) return b;
  for (int r0 = start + q; r0 <= end; r0 += nq * U) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * nq;
      x[u] = r <= end ? __ldg(vals + (long long)r * c4 + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * nq;
      if (r > end) continue;
      if (x[u].x >= b.v.x) b.v.x = x[u].x, b.r.x = r;
      if (x[u].y >= b.v.y) b.v.y = x[u].y, b.r.y = r;
      if (x[u].z >= b.v.z) b.v.z = x[u].z, b.r.z = r;
      if (x[u].w >= b.v.w) b.v.w = x[u].w, b.r.w = r;
    }
  }
  return b;
}

// Every lane gets the best over the warp's groups (__shfl_xor_sync over SW,
// 2 SW, ...) for its column.  Called by the whole warp.
template <int SW>
__device__ __forceinline__ Best merge_groups(Best b) {
#pragma unroll
  for (int off = SW; off < 32; off <<= 1) {
    Best o;
    o.v = make_float4(__shfl_xor_sync(kFull, b.v.x, off), __shfl_xor_sync(kFull, b.v.y, off),
                      __shfl_xor_sync(kFull, b.v.z, off), __shfl_xor_sync(kFull, b.v.w, off));
    o.r = make_int4(__shfl_xor_sync(kFull, b.r.x, off), __shfl_xor_sync(kFull, b.r.y, off),
                    __shfl_xor_sync(kFull, b.r.z, off), __shfl_xor_sync(kFull, b.r.w, off));
    merge(b, o);
  }
  return b;
}

// The winning value and the carry of the winning row; 0 where no row won
// (an empty run).
__device__ __forceinline__ float value_of(float v, int r) { return r < 0 ? 0.f : v; }

__device__ __forceinline__ float carry_of(const float* __restrict__ carry, int r) {
  return r < 0 ? 0.f : __ldg(carry + r);
}

// Writes one float4 column of a vertex's two outputs.
__device__ __forceinline__ void write_best(float4* __restrict__ out_max,
                                           float4* __restrict__ out_carry,
                                           const float* __restrict__ carry, long long vc,
                                           const Best& b) {
  out_max[vc] = make_float4(value_of(b.v.x, b.r.x), value_of(b.v.y, b.r.y),
                            value_of(b.v.z, b.r.z), value_of(b.v.w, b.r.w));
  out_carry[vc] = make_float4(carry_of(carry, b.r.x), carry_of(carry, b.r.y),
                              carry_of(carry, b.r.z), carry_of(carry, b.r.w));
}

// The pieces of long runs in chunk k: the run holding the chunk's first
// row (slot 0) and one starting inside it and holding its last row (slot
// 1).  Returns the piece's rows, or an empty range where the slot has none.
__device__ __forceinline__ int2 chunk_piece(const int32_t* __restrict__ ids,
                                            const int32_t* __restrict__ run_end, int k, int slot,
                                            int m, int cap) {
  const int first = k * kChunk, last = min(first + kChunk, m) - 1;
  const int vh = ids[first];
  const int v = slot == 0 ? vh : ids[last];
  const int2 none = make_int2(0, -1);
  if (v >= cap || (slot == 1 && v == vh)) return none;
  const int2 run = run_of(run_end, v);
  if (run.y - run.x + 1 <= kChunk) return none;
  return slot == 0 ? make_int2(first, min(run.y, last)) : make_int2(run.x, last);
}

// Pass 1.  Blocks [0, chunk_blocks) are chunk blocks, a chunk a warp,
// finding the winners of their long-run pieces into part_v / part_r; the
// rest are vertex blocks of kWarps * G vertices, one a group, writing every
// vertex but those of long runs.
template <int SW, int U>
__global__ void __launch_bounds__(kWarps * 32)
    seg_max_vec_kernel(const float4* __restrict__ vals, const float* __restrict__ carry,
                       const int32_t* __restrict__ ids, const int32_t* __restrict__ run_end,
                       float4* __restrict__ out_max, float4* __restrict__ out_carry,
                       float4* __restrict__ part_v, int4* __restrict__ part_r, int m, int cap,
                       int c4, int chunk_blocks) {
  constexpr int G = 32 / SW, kSpan = kWarps * G;
  constexpr int kGroupRows = (G == 1 ? 4 : 2) * U;  // a run a group does alone
  __shared__ int ends[kSpan + 1];    // run_end[v0 - 1 .. v0 + kSpan - 1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / SW, col = lane % SW;
  if (blockIdx.x < chunk_blocks) {  // no block barrier in a chunk block
    const int k = blockIdx.x * kWarps + warp;
    if (k * kChunk >= m) return;
    for (int slot = 0; slot < 2; ++slot) {
      const int2 rows = chunk_piece(ids, run_end, k, slot, m, cap);
      if (rows.x > rows.y) continue;
      const Best b = merge_groups<SW>(scan_rows<U>(vals, c4, rows.x, rows.y, g, G, col));
      if (g == 0 && col < c4) {
        const long long i = (long long)(2 * k + slot) * c4 + col;
        part_v[i] = b.v;
        part_r[i] = b.r;
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
    for (int i = threadIdx.x; i < nv * c4; i += blockDim.x) {
      out_max[(long long)v0 * c4 + i] = z;
      out_carry[(long long)v0 * c4 + i] = z;
    }
    return;
  }
  const int i = warp * G + g;  // the group's vertex
  const int start = ends[i] + 1, end = ends[i + 1], n = i < nv ? end - start + 1 : -1;
  if (n >= 0 && n <= kGroupRows && col < c4)  // the group alone (an empty run writes zeros)
    write_best(out_max, out_carry, carry, (long long)(v0 + i) * c4 + col,
               scan_rows<U>(vals, c4, start, end, 0, 1, col));
  // runs of kGroupRows + 1 to kChunk rows, the whole warp on each in turn
  unsigned medium = __ballot_sync(kFull, col == 0 && n > kGroupRows && n <= kChunk);
  while (medium) {
    const int src = __ffs(medium) - 1;
    medium &= medium - 1;
    const int vi = __shfl_sync(kFull, i, src);
    const int s0 = __shfl_sync(kFull, start, src), e0 = __shfl_sync(kFull, end, src);
    const Best b = merge_groups<SW>(scan_rows<U>(vals, c4, s0, e0, g, G, col));
    if (g == 0 && col < c4)
      write_best(out_max, out_carry, carry, (long long)(v0 + vi) * c4 + col, b);
  }
}

// Pass 2: the warp of the chunk where a long run ends merges the winners of
// its pieces (4 loads in flight) and writes the run's outputs; lane l takes
// float4 columns l, l + 32, ...
__global__ void __launch_bounds__(kWarps * 32)
    seg_max_long_kernel(const float* __restrict__ carry, const int32_t* __restrict__ ids,
                        const int32_t* __restrict__ run_end, const float4* __restrict__ part_v,
                        const int4* __restrict__ part_r, float4* __restrict__ out_max,
                        float4* __restrict__ out_carry, int m, int cap, int c4) {
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
    const long long i0 = (long long)(2 * j0 + (run.x != j0 * kChunk)) * c4 + col;
    Best b{part_v[i0], part_r[i0]};
    for (int j = j0 + 1; j <= k; j += 4) {
      Best x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long i = (long long)(2 * (j + u)) * c4 + col;
        x[u] = j + u <= k ? Best{part_v[i], part_r[i]} : b;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) merge(b, x[u]);
    }
    write_best(out_max, out_carry, carry, (long long)v * c4 + col, b);
  }
}

// Any C: one warp per vertex, lane l owns channels l, l+32, ...; it scans
// the run in order and takes x >= best, so the latest maximal edge wins.
__global__ void seg_max_scalar_kernel(const float* __restrict__ vals,
                                      const float* __restrict__ carry,
                                      const int32_t* __restrict__ run_end,
                                      float* __restrict__ out_max, float* __restrict__ out_carry,
                                      int cap, int c) {
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
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

struct Args {
  const void *vals, *carry, *ids, *run_end;
  void *out_max, *out_carry, *part;
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
  float4* part_v = static_cast<float4*>(a.part);
  int4* part_r = reinterpret_cast<int4*>(part_v + (long long)chunks * 2 * a.c4);
  seg_max_vec_kernel<SW, U><<<chunk_blocks + vertex_blocks, kWarps * 32, 0, stream>>>(
      static_cast<const float4*>(a.vals), static_cast<const float*>(a.carry),
      static_cast<const int32_t*>(a.ids), static_cast<const int32_t*>(a.run_end),
      static_cast<float4*>(a.out_max), static_cast<float4*>(a.out_carry), part_v, part_r, a.m,
      a.cap, a.c4, chunk_blocks);
  if (chunk_blocks == 0) return;
  seg_max_long_kernel<<<chunk_blocks, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(a.carry), static_cast<const int32_t*>(a.ids),
      static_cast<const int32_t*>(a.run_end), part_v, part_r, static_cast<float4*>(a.out_max),
      static_cast<float4*>(a.out_carry), a.m, a.cap, a.c4);
}

bool vector_path(int c) { return c % 4 == 0 && c <= 128; }

}  // namespace

// 4-byte elements of the scratch `part` that lnt_seg_max_carry needs for m
// edge rows of c channels (0 for the scalar kernel): a (value, row) pair
// per channel for each of two pieces a chunk.
extern "C" long long lnt_seg_max_carry_scratch(int m, int c) {
  if (!vector_path(c)) return 0;
  return (long long)((m + kChunk - 1) / kChunk) * 2 * c * 2;
}

// vals, out_max, out_carry and part must be 16-byte aligned when c % 4 ==
// 0 (the wrapper checks), part of lnt_seg_max_carry_scratch(m, c)
// elements.
extern "C" int lnt_seg_max_carry(const void* vals, const void* carry, const void* ids,
                                 const void* run_end, void* out_max, void* out_carry, void* part,
                                 int m, int cap, int c, void* stream) {
  if (cap == 0 || c == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vector_path(c)) {
    seg_max_scalar_kernel<<<(cap + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const float*>(carry),
        static_cast<const int32_t*>(run_end), static_cast<float*>(out_max),
        static_cast<float*>(out_carry), cap, c);
    return (int)cudaGetLastError();
  }
  const Args a{vals, carry, ids, run_end, out_max, out_carry, part, m, cap, c / 4};
  if (a.c4 <= 1) launch_vec<1>(a, st);
  else if (a.c4 <= 2) launch_vec<2>(a, st);
  else if (a.c4 <= 4) launch_vec<4>(a, st);
  else if (a.c4 <= 8) launch_vec<8>(a, st);
  else if (a.c4 <= 16) launch_vec<16>(a, st);
  else launch_vec<32>(a, st);
  return (int)cudaGetLastError();
}
