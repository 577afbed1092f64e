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
// with the run of v = [run_end[v-1] + 1, run_end[v]] as in seg_max.cu.  The
// kernel writes every element of d_vals and d_carry (M rows, M = m), once:
// the caller allocates them uninitialised.
//
// Bound on the card: bytes.  It reads the edge values of every run, the
// run ends and the three (cap, C) tables, and writes d_vals and d_carry;
// the compares are free beside that traffic.
//
// Design.  The first version gave each lane one channel and walked the run
// backwards to the first match, so each load decided whether there was a
// next one (one load in flight a lane), and it scattered into outputs the
// wrapper had zeroed first (a 67 MB memset) with d_carry[r] += s.  Now, with
// seg_sum.cu's row lanes (C/4 float4 lanes padded to a power of two SW, G =
// 32 / SW lane groups: 8 lanes and 4 groups at C = 32), two passes over a
// run in one warp:
// 1. Find.  Each lane loads maxed[v] for its 4 channels once; its group
//    reads the rows g, g + G, ... forwards, U = 4 rows in flight a lane (16
//    rows a warp at C = 32), and keeps per channel the largest row index with
//    vals == maxed.  The groups merge by max (__shfl_xor_sync over 8 and
//    16), exact and order-free.  This reads the run once, which is what the
//    bound counts.
// 2. Write.  For every row r of the run, the group stores d_vals[r] =
//    (r == win[c]) ? g_max[v, c] : 0 as float4 and d_carry[r] = the winning
//    g_carry[v, c] summed over the lane's 4 channels, then an xor tree over
//    the group's lanes, in a fixed order (bit-equal from run to run); the
//    group's first lane stores it.  No atomics and no read of the outputs.
// Runs of three sizes as in seg_sum.cu: a vertex block of 4 warps takes 4 *
// G consecutive vertices, one a group, loads their run ends into shared
// memory at once and stops there when none has an edge; a group finds and
// writes a run of up to 2 U rows (8 at C = 32; 4 U at G = 1) alone, one lane
// then reading every row of its column, so no merge; runs of up to kChunk =
// 32 rows get the whole warp as above; longer runs are cut at the 32-row
// chunks of the edge array: in pass 1 each chunk's warp finds the winners of
// the (at most two) long-run pieces in its chunk into win[chunk][0 or 1],
// and in pass 2 it merges, by max, the winners of every piece of those runs
// and writes its pieces' rows.  Rows past the last run (ids = cap) get zero
// d_vals and d_carry in pass 1, split evenly over the blocks.  C % 4 != 0
// and C > 128 take the scalar kernel: a lane a channel, the first version's
// backward walk, the winners kept in shared memory, then the warp writes the
// run row by row.  The TPU's second scan over f32 positions (exact only
// below 2^24 edges) has no counterpart here.
//
// C interface for ctypes; returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps a block
constexpr int kChunk = 32;  // rows of a chunk; a run longer than this is cut into chunk pieces
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int4 max4(const int4& a, const int4& b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}

__device__ __forceinline__ int2 run_of(const int32_t* __restrict__ run_end, int v) {
  return make_int2(v == 0 ? 0 : run_end[v - 1] + 1, run_end[v]);
}

// Rows [tail0, m) lie in no run: zero them, this block's even share.
template <typename Row>
__device__ __forceinline__ void zero_tail(Row* __restrict__ d_vals, float* __restrict__ d_carry,
                                          const int32_t* __restrict__ run_end, int m, int cap,
                                          int row_len, const Row& z) {
  const int tail0 = cap > 0 ? run_end[cap - 1] + 1 : 0;
  const int n = m - tail0;
  if (n <= 0) return;
  const int per = (n + gridDim.x - 1) / gridDim.x;
  const int r0 = tail0 + blockIdx.x * per, r1 = min(r0 + per, m);
  const long long i1 = (long long)r1 * row_len;
  for (long long i = (long long)r0 * row_len + threadIdx.x; i < i1; i += blockDim.x) d_vals[i] = z;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) d_carry[r] = 0.f;
}

// Find: per channel of float4 column `col`, the latest of the rows start +
// q, start + q + nq, ... <= end whose value equals mx; -1 where none.
template <int U>
__device__ __forceinline__ int4 find_rows(const float4* __restrict__ vals, int c4, int start,
                                          int end, int q, int nq, int col, const float4& mx) {
  int4 w = make_int4(-1, -1, -1, -1);
  if (col >= c4) return w;
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
      if (x[u].x == mx.x) w.x = r;
      if (x[u].y == mx.y) w.y = r;
      if (x[u].z == mx.z) w.z = r;
      if (x[u].w == mx.w) w.w = r;
    }
  }
  return w;
}

// Every lane gets the max over the warp's groups (__shfl_xor_sync over SW,
// 2 SW, ...) for its column.  Called by the whole warp.
template <int SW>
__device__ __forceinline__ int4 merge_groups(int4 w) {
#pragma unroll
  for (int off = SW; off < 32; off <<= 1) {
    const int4 o = make_int4(__shfl_xor_sync(kFull, w.x, off), __shfl_xor_sync(kFull, w.y, off),
                             __shfl_xor_sync(kFull, w.z, off), __shfl_xor_sync(kFull, w.w, off));
    w = max4(w, o);
  }
  return w;
}

// Write: the rows start + q + u * nq of each step of nq * U rows; the steps
// are uniform over the lanes of `mask` (the group's, or the warp's), which
// the xor tree over the group's lanes needs.
template <int SW, int U>
__device__ __forceinline__ void write_rows(float4* __restrict__ d_vals, float* __restrict__ d_carry,
                                           int c4, int start, int end, int q, int nq, int col,
                                           const int4& w, const float4& gm, const float4& gc,
                                           unsigned mask) {
  for (int b = start; b <= end; b += nq * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = b + q + u * nq;
      const bool hx = w.x == r, hy = w.y == r, hz = w.z == r, hw = w.w == r;
      float p = (hx ? gc.x : 0.f) + (hy ? gc.y : 0.f) + (hz ? gc.z : 0.f) + (hw ? gc.w : 0.f);
#pragma unroll
      for (int off = SW / 2; off > 0; off >>= 1) p += __shfl_xor_sync(mask, p, off);
      if (r <= end) {
        if (col < c4)
          d_vals[(long long)r * c4 + col] =
              make_float4(hx ? gm.x : 0.f, hy ? gm.y : 0.f, hz ? gm.z : 0.f, hw ? gm.w : 0.f);
        if (col == 0) d_carry[r] = p;
      }
    }
  }
}

// The pieces of long runs in chunk k: the run holding the chunk's first
// row (slot 0) and one starting inside it and holding its last row (slot
// 1).  Returns the vertex (cap where none), its run and the piece's rows.
struct Piece {
  int v;
  int2 run, rows;
};

__device__ __forceinline__ Piece chunk_piece(const int32_t* __restrict__ ids,
                                             const int32_t* __restrict__ run_end, int k, int slot,
                                             int m, int cap) {
  const int first = k * kChunk, last = min(first + kChunk, m) - 1;
  const int vh = ids[first];
  Piece p{cap, make_int2(0, -1), make_int2(0, -1)};
  const int v = slot == 0 ? vh : ids[last];
  if (v >= cap || (slot == 1 && v == vh)) return p;
  const int2 run = run_of(run_end, v);
  if (run.y - run.x + 1 <= kChunk) return p;
  p.v = v;
  p.run = run;
  p.rows = slot == 0 ? make_int2(first, min(run.y, last)) : make_int2(run.x, last);
  return p;
}

// Pass 1.  Every block zeroes its share of the rows in no run.  Blocks [0,
// chunk_blocks) are chunk blocks, a chunk a warp, finding the winners of
// their long-run pieces; the rest are vertex blocks of kWarps * G
// vertices, one a group, finding and writing the runs of up to kChunk rows.
template <int SW, int U>
__global__ void __launch_bounds__(kWarps * 32)
    seg_max_bwd_vec_kernel(const float4* __restrict__ vals, const int32_t* __restrict__ ids,
                           const int32_t* __restrict__ run_end, const float4* __restrict__ maxed,
                           const float4* __restrict__ g_max, const float4* __restrict__ g_carry,
                           float4* __restrict__ d_vals, float* __restrict__ d_carry,
                           int4* __restrict__ wins, int m, int cap, int c4, int chunk_blocks) {
  constexpr int G = 32 / SW, kSpan = kWarps * G;
  constexpr int kGroupRows = (G == 1 ? 4 : 2) * U;  // a run a group does alone
  __shared__ int ends[kSpan + 1];    // run_end[v0 - 1 .. v0 + kSpan - 1]
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  zero_tail(d_vals, d_carry, run_end, m, cap, c4, z);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / SW, col = lane % SW;
  if (blockIdx.x < chunk_blocks) {  // no block barrier in a chunk block
    const int k = blockIdx.x * kWarps + warp;
    if (k * kChunk >= m) return;
    for (int slot = 0; slot < 2; ++slot) {
      const Piece p = chunk_piece(ids, run_end, k, slot, m, cap);
      if (p.v >= cap) continue;
      const int4 w = merge_groups<SW>(find_rows<U>(
          vals, c4, p.rows.x, p.rows.y, g, G, col, col < c4 ? maxed[(long long)p.v * c4 + col] : z));
      if (g == 0 && col < c4) wins[(long long)(2 * k + slot) * c4 + col] = w;
    }
    return;
  }
  const int v0 = (blockIdx.x - chunk_blocks) * kSpan;
  const int nv = min(kSpan, cap - v0);  // < 1 only when cap == 0
  for (int i = threadIdx.x; i <= kSpan; i += blockDim.x) {
    const int v = v0 - 1 + min(i, nv);
    ends[i] = v < 0 ? -1 : run_end[v];
  }
  __syncthreads();
  if (ends[0] == ends[kSpan]) return;  // no edge in the block's vertices
  const unsigned group_mask = SW == 32 ? kFull : ((1u << SW) - 1) << (g * SW);
  const int i = warp * G + g;  // the group's vertex
  const int start = ends[i] + 1, end = ends[i + 1], n = i < nv ? end - start + 1 : 0;
  if (n > 0 && n <= kGroupRows) {  // the group alone
    const long long vc = (long long)(v0 + i) * c4 + col;
    const int4 w = find_rows<U>(vals, c4, start, end, 0, 1, col, col < c4 ? maxed[vc] : z);
    write_rows<SW, U>(d_vals, d_carry, c4, start, end, 0, 1, col, w, col < c4 ? g_max[vc] : z,
                      col < c4 ? g_carry[vc] : z, group_mask);
  }
  // runs of kGroupRows + 1 to kChunk rows, the whole warp on each in turn
  unsigned medium = __ballot_sync(kFull, col == 0 && n > kGroupRows && n <= kChunk);
  while (medium) {
    const int src = __ffs(medium) - 1;
    medium &= medium - 1;
    const int vi = __shfl_sync(kFull, i, src);
    const int s0 = __shfl_sync(kFull, start, src), e0 = __shfl_sync(kFull, end, src);
    const long long vc = (long long)(v0 + vi) * c4 + col;
    const int4 w =
        merge_groups<SW>(find_rows<U>(vals, c4, s0, e0, g, G, col, col < c4 ? maxed[vc] : z));
    write_rows<SW, U>(d_vals, d_carry, c4, s0, e0, g, G, col, w, col < c4 ? g_max[vc] : z,
                      col < c4 ? g_carry[vc] : z, kFull);
  }
}

// Pass 2: each chunk's warp merges, by max, the winners of every piece of
// the long runs in its chunk (4 loads in flight) and writes its pieces' rows.
template <int SW, int U>
__global__ void __launch_bounds__(kWarps * 32)
    seg_max_bwd_long_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ run_end,
                            const float4* __restrict__ g_max, const float4* __restrict__ g_carry,
                            const int4* __restrict__ wins, float4* __restrict__ d_vals,
                            float* __restrict__ d_carry, int m, int cap, int c4) {
  constexpr int G = 32 / SW;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, g = lane / SW, col = lane % SW;
  if (k * kChunk >= m) return;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int slot = 0; slot < 2; ++slot) {
    const Piece p = chunk_piece(ids, run_end, k, slot, m, cap);
    if (p.v >= cap) continue;
    int4 w = make_int4(-1, -1, -1, -1);
    if (col < c4) {
      const int j0 = p.run.x / kChunk, j1 = p.run.y / kChunk;
      w = wins[(long long)(2 * j0 + (p.run.x != j0 * kChunk)) * c4 + col];
      for (int j = j0 + 1; j <= j1; j += 4) {
        int4 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          x[u] = j + u <= j1 ? wins[(long long)(2 * (j + u)) * c4 + col] : w;
#pragma unroll
        for (int u = 0; u < 4; ++u) w = max4(w, x[u]);
      }
    }
    const long long vc = (long long)p.v * c4 + col;
    write_rows<SW, U>(d_vals, d_carry, c4, p.rows.x, p.rows.y, g, G, col, w,
                      col < c4 ? g_max[vc] : z, col < c4 ? g_carry[vc] : z, kFull);
  }
}

// Any C: one warp per vertex, lane l owns channels l, l+32, ...; each walks
// its run back to the latest match and keeps it in shared memory, then the
// warp writes the run row by row.
__global__ void seg_max_bwd_scalar_kernel(const float* __restrict__ vals,
                                          const int32_t* __restrict__ run_end,
                                          const float* __restrict__ maxed,
                                          const float* __restrict__ g_max,
                                          const float* __restrict__ g_carry,
                                          float* __restrict__ d_vals,
                                          float* __restrict__ d_carry, int m, int cap, int c) {
  extern __shared__ int win_smem[];
  zero_tail(d_vals, d_carry, run_end, m, cap, c, 0.f);
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= cap) return;  // uniform over the warp; no block barrier below
  const int end = run_end[v];
  const int start = v == 0 ? 0 : run_end[v - 1] + 1;
  if (start > end) return;
  int* win = win_smem + (threadIdx.x >> 5) * c;
  const long long vc0 = (long long)v * c;
  for (int ch = lane; ch < c; ch += 32) {
    const float mx = maxed[vc0 + ch];
    int w = -1;
    for (int r = end; r >= start; --r) {
      if (vals[(long long)r * c + ch] == mx) {
        w = r;
        break;
      }
    }
    win[ch] = w;
  }
  __syncwarp();
  for (int r = start; r <= end; ++r) {
    float p = 0.f;
    for (int ch = lane; ch < c; ch += 32) {
      const bool hit = win[ch] == r;
      d_vals[(long long)r * c + ch] = hit ? g_max[vc0 + ch] : 0.f;
      p += hit ? g_carry[vc0 + ch] : 0.f;
    }
    for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
    if (lane == 0) d_carry[r] = p;
  }
}

struct Args {
  const void *vals, *ids, *run_end, *maxed, *g_max, *g_carry;
  void *d_vals, *d_carry, *wins;
  int m, cap, c4;
};

template <int SW>
void launch_vec(const Args& a, cudaStream_t stream) {
  constexpr int G = 32 / SW;
  constexpr int U = G == 1 ? 8 : 4;  // rows in flight a lane
  constexpr int kSpan = kWarps * G;
  const int chunks = (a.m + kChunk - 1) / kChunk;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int vertex_blocks = a.cap == 0 ? 1 : (a.cap + kSpan - 1) / kSpan;
  seg_max_bwd_vec_kernel<SW, U><<<chunk_blocks + vertex_blocks, kWarps * 32, 0, stream>>>(
      static_cast<const float4*>(a.vals), static_cast<const int32_t*>(a.ids),
      static_cast<const int32_t*>(a.run_end), static_cast<const float4*>(a.maxed),
      static_cast<const float4*>(a.g_max), static_cast<const float4*>(a.g_carry),
      static_cast<float4*>(a.d_vals), static_cast<float*>(a.d_carry), static_cast<int4*>(a.wins),
      a.m, a.cap, a.c4, chunk_blocks);
  seg_max_bwd_long_kernel<SW, U><<<chunk_blocks, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(a.ids), static_cast<const int32_t*>(a.run_end),
      static_cast<const float4*>(a.g_max), static_cast<const float4*>(a.g_carry),
      static_cast<const int4*>(a.wins), static_cast<float4*>(a.d_vals),
      static_cast<float*>(a.d_carry), a.m, a.cap, a.c4);
}

bool vector_path(int c) { return c % 4 == 0 && c <= 128; }

}  // namespace

// 4-byte elements of the scratch `wins` that lnt_seg_max_bwd needs for m
// edge rows of c channels (0 for the scalar kernel).
extern "C" long long lnt_seg_max_bwd_scratch(int m, int c) {
  if (!vector_path(c)) return 0;
  return (long long)((m + kChunk - 1) / kChunk) * 2 * c;
}

// vals, maxed, g_max, g_carry, d_vals and wins must be 16-byte aligned when
// c % 4 == 0 (the wrapper checks), wins of lnt_seg_max_bwd_scratch(m, c)
// elements.  m >= 1.
extern "C" int lnt_seg_max_bwd(const void* vals, const void* ids, const void* run_end,
                               const void* maxed, const void* g_max, const void* g_carry,
                               void* d_vals, void* d_carry, void* wins, int m, int cap, int c,
                               void* stream) {
  if (m == 0 || c == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vector_path(c)) {
    const size_t smem = (size_t)kWarps * c * sizeof(int);
    if (smem > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(seg_max_bwd_scalar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    seg_max_bwd_scalar_kernel<<<cap == 0 ? 1 : (cap + kWarps - 1) / kWarps, kWarps * 32, smem,
                                st>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(run_end),
        static_cast<const float*>(maxed), static_cast<const float*>(g_max),
        static_cast<const float*>(g_carry), static_cast<float*>(d_vals),
        static_cast<float*>(d_carry), m, cap, c);
    return (int)cudaGetLastError();
  }
  const Args a{vals, ids, run_end, maxed, g_max, g_carry, d_vals, d_carry, wins, m, cap, c / 4};
  if (a.c4 <= 1) launch_vec<1>(a, st);
  else if (a.c4 <= 2) launch_vec<2>(a, st);
  else if (a.c4 <= 4) launch_vec<4>(a, st);
  else if (a.c4 <= 8) launch_vec<8>(a, st);
  else if (a.c4 <= 16) launch_vec<16>(a, st);
  else launch_vec<32>(a, st);
  return (int)cudaGetLastError();
}
