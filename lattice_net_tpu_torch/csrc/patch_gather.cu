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
// bytes moved over the HBM rate, and the writes are most of them (9 output
// rows a query for a conv, 4 for the head).  The TPU kernel's windows,
// one-hot matmuls, coverage cond and [:q] padding exist because a TPU row
// gather is latency-bound; none of that carries over.
//
// What kept the first version of this kernel (one thread a chunk, 64-bit
// index division, a grid of a fixed size) from the byte rate on this card:
// index arithmetic paid for every chunk, 4-byte accesses for rows that are
// not a multiple of 16 bytes (the ScanNet head's 116-byte rows: 29 threads
// and 29 divisions a row), a patch streaming through L2 and evicting the
// table rows that later queries read again, and warps that all load, then
// all store, in step.  Two layouts, chosen on the host
// (ops_cuda/patch.py, _plan):
//
// * Rows of a multiple of 16 bytes on a 16-byte-aligned table (every conv;
//   the KITTI head's 112-byte rows): a block takes a tile of whole queries,
//   one contiguous span of ``out``, sized so that its 16-byte chunks fill
//   the block's passes of two chunks a thread.  A thread issues both loads
//   before either store; consecutive threads take consecutive chunks, so
//   the stores are one contiguous run a warp.  Row, column and query of a
//   chunk come from 32-bit multiply-high divisions whose constants the host
//   computes; offsets inside a tile are 32-bit from its 64-bit base, and
//   the neighbour id comes from L1 after the first chunk of its row.
// * Any other row (the ScanNet head's 116-byte rows, bf16 odd widths, a
//   table that starts off a 16-byte boundary): a block stages a tile of T
//   consecutive patch rows (T a multiple of 16, so a full tile's span of
//   the output is a multiple of 16 bytes; about 30 KB) in shared memory.
//   The tile's ids are staged first with one coalesced load.  Each source
//   row is read in the widest word its alignment allows (8- or 4-byte
//   cp.async with zero fill for invalid ids, 2-byte loads below that); the
//   tile leaves in 16-byte stores, and only the last tile's tail in
//   narrower ones.
//
// Both store the patch with the streaming hint (st.global.cs), so that it
// leaves L2 first and the table's rows stay, and both launch one block a
// tile: blocks that start as others finish keep loads and stores
// overlapping, where a grid of one wave (the SM count times the occupancy,
// with a loop over tiles) moved every warp in step and was slower on the
// card.  One launch per call: no atomics, no host synchronisation, no
// allocation.  A pure byte copy, so the element type does not matter (bf16
// and f32 tables take the same path).
//
// C interface for ctypes; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan that does not fit the arguments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// n / d for 0 <= n < 2^31 by a multiply-high (Granlund and Montgomery)
struct FastDiv {
  uint32_t m, s;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  return {(uint32_t)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return (int)((__umulhi((uint32_t)n, f.m) + (uint32_t)n) >> f.s);
}

// 16-byte rows: block b takes the tile of ``tq`` whole queries from b * tq,
// one contiguous span of ``out``; a thread builds kChunks 16-byte chunks of
// it at a time
constexpr int kChunks = 2;

__global__ void __launch_bounds__(kBlock)
    gather_rows16(const uint4* __restrict__ values, const int32_t* __restrict__ nbr,
                  uint4* __restrict__ out, long long q, int k, int kk, long long cap_src,
                  long long row0, int v, int tq, FastDiv by_v, FastDiv by_kk) {
  const long long q0 = (long long)blockIdx.x * tq;
  const int n = (int)min((long long)tq, q - q0) * kk * v;
  const int32_t* ids = nbr + q0 * k;
  uint4* dst = out + q0 * kk * v;
  for (int c0 = threadIdx.x; c0 < n; c0 += kChunks * kBlock) {
    uint4 r[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int c = c0 + u * kBlock;
      r[u] = make_uint4(0, 0, 0, 0);
      if (c < n) {
        const int row = fdiv(c, by_v), j = c - row * v;
        const int dq = fdiv(row, by_kk), a = row - dq * kk;
        const long long src = a < k ? (long long)__ldg(ids + dq * k + a) : row0 + q0 + dq;
        if (src >= 0 && src < cap_src) r[u] = __ldg(values + src * v + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
      if (c0 + u * kBlock < n) __stcs(dst + c0 + u * kBlock, r[u]);
  }
}

template <int W>
struct WordOf;
template <>
struct WordOf<2> {
  using T = uint16_t;
};
template <>
struct WordOf<4> {
  using T = uint32_t;
};
template <>
struct WordOf<8> {
  using T = uint2;
};

// one W-byte word global -> shared, zero where ``ok`` is false
template <int W>
__device__ __forceinline__ void copy_word(unsigned char* dst, const unsigned char* src, bool ok) {
  if constexpr (W >= 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(W),
                 "r"(ok ? W : 0));
  } else {
    using Word = typename WordOf<W>::T;
    *reinterpret_cast<Word*>(dst) = ok ? __ldg(reinterpret_cast<const Word*>(src)) : Word(0);
  }
}

// other rows: block b stages the tile of ``tile`` patch rows from b * tile
// in shared memory, the ids of its queries at ``ids_off``
template <int W>
__global__ void __launch_bounds__(kBlock)
    gather_rows_staged(const unsigned char* __restrict__ values, const int32_t* __restrict__ nbr,
                       unsigned char* __restrict__ out, long long q, int k, int kk,
                       long long cap_src, long long row0, int row_bytes, int tile,
                       FastDiv by_words, FastDiv by_kk, int ids_off) {
  using Word = typename WordOf<W>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* ids_s = reinterpret_cast<int32_t*>(smem + ids_off);
  const int wpr = row_bytes / W;
  // A grid-stride loop over tiles, though the launch gives each tile its
  // block and so the loop makes one pass: nvcc schedules the loop form
  // faster.  On an H100 80GB HBM3 at 700 W, f32 C = 29, K = 4, Q = 2^19
  // (the ScanNet head) took 124.2 us with the loop against 129.4 without;
  // __launch_bounds__(kBlock, 6) on the loop-free body closes the gap for
  // 4-byte words (125.0 us) but not for 2-byte ones (bf16 C = 29: 114.7
  // against 110.0 us); the registers are 40 in both loop-free builds.  See
  // PERF.md, section 6.  The tile's first patch row r0 is column af of
  // query qf.
  const long long rows = q * kk;
  long long r0 = (long long)blockIdx.x * tile;
  long long qf = r0 / kk;
  int af = (int)(r0 - qf * kk);
  const long long step = (long long)gridDim.x * tile;
  const long long step_q = step / kk;
  const int step_a = (int)(step - step_q * kk);
  for (; r0 < rows; r0 += step) {
    const int nrows = (int)min((long long)tile, rows - r0);
    const int nq = fdiv(af + nrows - 1, by_kk) + 1;
    const int32_t* nbr_t = nbr + qf * k;
    for (int i = threadIdx.x; i < nq * k; i += kBlock) ids_s[i] = __ldg(nbr_t + i);
    __syncthreads();
    const int nwords = nrows * wpr;
    for (int w = threadIdx.x; w < nwords; w += kBlock) {
      const int rl = fdiv(w, by_words);
      const int j = w - rl * wpr;
      const int dq = fdiv(af + rl, by_kk);
      const int a = af + rl - dq * kk;
      const long long src = a < k ? (long long)ids_s[dq * k + a] : row0 + qf + dq;
      const bool ok = src >= 0 && src < cap_src;
      copy_word<W>(smem + w * W, ok ? values + src * row_bytes + j * W : values, ok);
    }
    if constexpr (W >= 4) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int span = nrows * row_bytes;
    unsigned char* dst = out + r0 * row_bytes;
    const int n16 = span >> 4;
    for (int c = threadIdx.x; c < n16; c += kBlock)
      __stcs(reinterpret_cast<uint4*>(dst) + c, reinterpret_cast<const uint4*>(smem)[c]);
    for (int w = n16 * 16 / W + threadIdx.x; w < span / W; w += kBlock)
      reinterpret_cast<Word*>(dst)[w] = reinterpret_cast<const Word*>(smem)[w];
    __syncthreads();
    qf += step_q;
    af += step_a;
    if (af >= kk) {
      af -= kk;
      ++qf;
    }
  }
}

// one block a tile
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, long long tiles, int smem, cudaStream_t stream, Args... args) {
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)tiles, kBlock, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// ``word`` 16: the 16-byte layout with tiles of ``tile`` whole queries; 8, 4
// or 2: the staged layout with tiles of ``tile`` patch rows, their ids at
// byte ``ids_off`` of ``smem_bytes`` of dynamic shared memory.  The plan
// (ops_cuda/patch.py, _plan) lays the shared memory out; this entry checks
// that the rows fit below ``ids_off`` and the whole within the device's
// limit.
extern "C" int lnt_patch_gather(const void* values, const void* nbr, void* out, long long q,
                                int k, int include_center, long long cap_src,
                                long long row_bytes, long long row0, int word, int tile,
                                int ids_off, int smem_bytes, void* stream) {
  const int kk = k + (include_center ? 1 : 0);
  if (q == 0 || kk == 0 || row_bytes == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t vp = (uintptr_t)values, op = (uintptr_t)out;
  const int bad = (int)cudaErrorInvalidValue;
  if (word != 2 && word != 4 && word != 8 && word != 16) return bad;
  if (k < 0 || row_bytes % word || vp % word || op % 16 || tile < 1) return bad;
  const int32_t* ids = static_cast<const int32_t*>(nbr);
  if (word == 16) {
    const long long v = row_bytes / 16;
    if ((long long)tile * kk * v >= (1ll << 31)) return bad;
    return (int)launch(gather_rows16, (q + tile - 1) / tile, 0, s, static_cast<const uint4*>(values),
                       ids, static_cast<uint4*>(out), q, k, kk, cap_src, row0, (int)v, tile,
                       make_fastdiv((uint32_t)v), make_fastdiv((uint32_t)kk));
  }
  if (tile % 16 || ids_off % 16 || (long long)tile * row_bytes > ids_off || ids_off > smem_bytes)
    return bad;
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes > smem_max) return bad;
  const long long tiles = (q * kk + tile - 1) / tile;
  const FastDiv by_words = make_fastdiv((uint32_t)(row_bytes / word));
  const FastDiv by_kk = make_fastdiv((uint32_t)kk);
  const unsigned char* vals = static_cast<const unsigned char*>(values);
  unsigned char* o = static_cast<unsigned char*>(out);
  const int rb = (int)row_bytes;
  if (word == 8)
    return (int)launch(gather_rows_staged<8>, tiles, smem_bytes, s, vals, ids, o, q, k, kk, cap_src,
                       row0, rb, tile, by_words, by_kk, ids_off);
  if (word == 4)
    return (int)launch(gather_rows_staged<4>, tiles, smem_bytes, s, vals, ids, o, q, k, kk, cap_src,
                       row0, rb, tile, by_words, by_kk, ids_off);
  return (int)launch(gather_rows_staged<2>, tiles, smem_bytes, s, vals, ids, o, q, k, kk, cap_src,
                     row0, rb, tile, by_words, by_kk, ids_off);
}
