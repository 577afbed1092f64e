// Masked GroupNorm and its activation in one pass (no TPU kernel).
//
// Replaces no TPU kernel.  The JAX package's masked GroupNorm
// (lattice_net_tpu/nn/modules.py, masked_group_norm) is XLA code, which
// fuses its reductions and its normalising pass itself.  The port's eager
// composition (nn/modules.masked_group_norm, F.relu, the consumer's cast)
// launches about 40 kernels a call, nearly every one over the whole
// (capacity, C) table, though the statistics need only the rows the mask
// marks.  This kernel computes what ops_cuda/norm.group_norm_act_plain
// does, with the same arithmetic in another order of summation:
//
//   t_g    = the mean of row 0's channels of group g         (the shift)
//   n      = the rows the mask marks;  cnt = max(n * gs, 1)
//   S1_g   = the sum of x - t_g over the marked rows and g's channels
//   S2_g   = the same sum of (x - t_g)^2
//   m_g    = S1_g / cnt;  var_g = max(S2_g / cnt - m_g * m_g, 0)
//   mean_c = m_g + t_g;   mul_c = rsqrt(var_g + eps) * scale_c
//   out    = act((x - mean_c) * mul_c + bias_c) for every row, marked or
//            not, rounded once to f32 or bf16; act is ReLU or the identity
//
// Bound on the card: bytes.  The least traffic reads the marked rows once
// (the statistics), every row once and writes every row once (the output,
// in its consumer's dtype), and one mask byte a row.  A ScanNet room at the
// 5M-row tables marks about 1.4% of level 0's rows, so the statistics cost
// the mask's bytes and little more, and the output pass is the time.
//
// Design, three launches:
//  1. partials: a fixed grid (a few blocks an SM) walks tiles of TILE rows,
//     tile t on block t % grid, so that the marked prefix of a sorted table
//     spreads over the card.  A block stages the mask of TILES_PER_ROUND
//     tiles at once (8 bytes a thread), skips every tile that marks no row
//     without reading lv, and sums x - t and (x - t)^2 per channel over the
//     marked rows of the others (16-byte loads where C % 4 == 0 and lv is
//     aligned).  Its row slots' sums meet in shared memory in a fixed order;
//     every block writes its per-channel sums and its marked-row count.
//  2. finish: one block a group sums the blocks' partials per channel in a
//     fixed order, then the group's channels in order, and writes mean_c
//     and mul_c.  No float atomics anywhere: two runs give the same bits.
//     The count stays on the card (no host read).
//  3. apply: a grid-stride pass over the flat table, 16 bytes of lv a
//     thread with a scalar tail; the subtraction, product and sum each
//     rounded as the composition rounds them (no contraction into an FMA).
//
// C interface for ctypes: lnt_group_norm_act_scratch gives the f32 scratch
// the caller allocates; lnt_group_norm_act returns the first
// cudaGetLastError() after a launch that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 128;                                      // rows a tile
constexpr int MASK_BYTES = 8;                                  // mask bytes a thread stages
constexpr int TILES_PER_ROUND = THREADS * MASK_BYTES / TILE;   // 16
constexpr int BLOCKS_PER_SM = 4;                               // partials' grid

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

int partial_blocks(long long cap) {
  const long long tiles = (cap + TILE - 1) / TILE;
  const long long most = (long long)sm_count() * BLOCKS_PER_SM;
  return (int)(tiles < most ? tiles : most);
}

// the shift of group g: its channels of row 0 summed in order, over gs
__device__ float group_shift(const float* __restrict__ lv, int g, int gs) {
  float s = 0.f;
  for (int j = 0; j < gs; ++j) s = __fadd_rn(s, lv[g * gs + j]);
  return __fdiv_rn(s, (float)gs);
}

template <int V>
__device__ void load_v(const float* __restrict__ p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

// grid: partial_blocks(cap); dynamic shared memory: (C + 2 * THREADS * V) floats
template <int V>
__global__ void __launch_bounds__(THREADS)
partials_kernel(const float* __restrict__ lv, const uint8_t* __restrict__ mask, long long cap,
                int C, int gs, float* __restrict__ part, int* __restrict__ counts) {
  extern __shared__ float sh[];
  float* shift = sh;            // [C]: each channel's group shift
  float* red = sh + C;          // [2][THREADS * V]: the row slots' sums
  __shared__ __align__(8) uint8_t smask[THREADS * MASK_BYTES];
  __shared__ int sflag[TILES_PER_ROUND];
  __shared__ int scount;
  const int tid = threadIdx.x;
  for (int g = tid; g < C / gs; g += THREADS) {
    const float t = group_shift(lv, g, gs);
    for (int j = 0; j < gs; ++j) shift[g * gs + j] = t;
  }
  if (tid == 0) scount = 0;
  __syncthreads();

  const int cols = C / V;
  const int T = cols < THREADS ? cols : THREADS;   // vector columns at once
  const int R = THREADS / T;                       // row slots
  const int tx = tid % T, ty = tid / T;
  const long long tiles = (cap + TILE - 1) / TILE;
  const long long nblk = gridDim.x;
  const bool mask_aligned = ((uintptr_t)mask % MASK_BYTES) == 0;
  const int k_mine = tid / (TILE / MASK_BYTES);                 // the tile of my staged bytes
  const int off_mine = (tid % (TILE / MASK_BYTES)) * MASK_BYTES;  // their offset in it
  int count = 0;

  for (int cb = 0; cb < cols; cb += T) {  // more than one chunk only for C / V > THREADS
    const int col = cb + tx;
    const bool on = ty < R && col < cols;
    float s1[V], s2[V], t[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1[k] = 0.f;
      s2[k] = 0.f;
      t[k] = on ? shift[col * V + k] : 0.f;
    }
    for (long long base = blockIdx.x; base < tiles; base += nblk * TILES_PER_ROUND) {
      __syncthreads();  // the last round's readers of smask and sflag are done
      uint64_t bytes = 0;
      const long long my_tile = base + (long long)k_mine * nblk;
      if (my_tile < tiles) {
        const long long row0 = my_tile * TILE + off_mine;
        if (mask_aligned && row0 + MASK_BYTES <= cap) {
          bytes = __ldg(reinterpret_cast<const unsigned long long*>(mask + row0));
        } else {
          for (int j = 0; j < MASK_BYTES; ++j)
            if (row0 + j < cap) bytes |= (uint64_t)mask[row0 + j] << (8 * j);
        }
      }
      *reinterpret_cast<uint64_t*>(smask + tid * MASK_BYTES) = bytes;
      if (tid < TILES_PER_ROUND) sflag[tid] = 0;
      __syncthreads();
      if (bytes) sflag[k_mine] = 1;
      if (cb == 0) {  // marked rows: the nonzero bytes
        uint64_t nz = bytes;
        nz |= nz >> 4;
        nz |= nz >> 2;
        nz |= nz >> 1;
        count += __popcll(nz & 0x0101010101010101ULL);
      }
      __syncthreads();
      for (int k = 0; k < TILES_PER_ROUND; ++k) {
        if (!sflag[k] || !on) continue;  // sflag is the block's: a tile is skipped by all
        const uint8_t* m = smask + k * TILE;
        const long long row_base = (base + (long long)k * nblk) * TILE;
#pragma unroll 4
        for (int r = ty; r < TILE; r += R) {
          if (!m[r]) continue;  // rows past cap are unmarked
          float x[V];
          load_v<V>(lv + (row_base + r) * C + (long long)col * V, x);
#pragma unroll
          for (int k2 = 0; k2 < V; ++k2) {
            const float d = x[k2] - t[k2];
            s1[k2] += d;
            s2[k2] = fmaf(d, d, s2[k2]);
          }
        }
      }
    }
    // the row slots' sums, in slot order
    __syncthreads();
    if (on) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[(ty * T + tx) * V + k] = s1[k];
        red[THREADS * V + (ty * T + tx) * V + k] = s2[k];
      }
    }
    __syncthreads();
    if (ty == 0 && col < cols) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float a = 0.f, b = 0.f;
        for (int y = 0; y < R; ++y) {
          a += red[(y * T + tx) * V + k];
          b += red[THREADS * V + (y * T + tx) * V + k];
        }
        part[blockIdx.x * 2LL * C + col * V + k] = a;
        part[blockIdx.x * 2LL * C + C + col * V + k] = b;
      }
    }
  }
  atomicAdd(&scount, count);  // integers: the same sum in any order
  __syncthreads();
  if (tid == 0) counts[blockIdx.x] = scount;
}

// grid: one block a group; dynamic shared memory: (2 * THREADS + 2 * gs) floats
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ lv, const float* __restrict__ part, const int* __restrict__ counts,
              int nblk, int C, int gs, const float* __restrict__ scale, float eps, float* __restrict__ stats) {
  extern __shared__ float sh[];
  float* red1 = sh;
  float* red2 = sh + THREADS;
  float* ch1 = sh + 2 * THREADS;  // [gs]: each channel's sum over the blocks
  float* ch2 = ch1 + gs;
  __shared__ long long sn;
  __shared__ float smean, sinv;
  const int g = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) sn = 0;
  __syncthreads();
  long long n = 0;
  for (int b = tid; b < nblk; b += THREADS) n += counts[b];
  atomicAdd(reinterpret_cast<unsigned long long*>(&sn), (unsigned long long)n);

  const int per = gs < THREADS ? gs : THREADS;  // channels at once
  const int slots = THREADS / per;               // blocks' partials summed side by side
  const int j = tid % per, s = tid / per;
  for (int j0 = 0; j0 < gs; j0 += per) {
    float a = 0.f, b = 0.f;
    if (s < slots && j0 + j < gs) {
      const long long c = (long long)g * gs + j0 + j;
      for (int blk = s; blk < nblk; blk += slots) {
        a += part[blk * 2LL * C + c];
        b += part[blk * 2LL * C + C + c];
      }
    }
    red1[tid] = a;
    red2[tid] = b;
    __syncthreads();
    if (s == 0 && j0 + j < gs) {
      float aa = 0.f, bb = 0.f;
      for (int y = 0; y < slots; ++y) {
        aa += red1[y * per + j];
        bb += red2[y * per + j];
      }
      ch1[j0 + j] = aa;
      ch2[j0 + j] = bb;
    }
    __syncthreads();
  }
  if (tid == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < gs; ++c) {
      s1 += ch1[c];
      s2 += ch2[c];
    }
    const float t = group_shift(lv, g, gs);
    float cnt = __fmul_rn((float)sn, (float)gs);
    cnt = cnt < 1.f ? 1.f : cnt;
    const float m = __fdiv_rn(s1, cnt);
    float var = __fsub_rn(__fdiv_rn(s2, cnt), __fmul_rn(m, m));
    var = var < 0.f ? 0.f : var;
    smean = __fadd_rn(m, t);
    sinv = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  for (int c = tid; c < gs; c += THREADS) {
    const int ch = g * gs + c;
    stats[ch] = smean;
    stats[C + ch] = __fmul_rn(sinv, scale[ch]);
  }
}

template <bool RELU>
__device__ __forceinline__ float normalise(float x, int c, const float* __restrict__ stats,
                                           const float* __restrict__ bias, int C) {
  float y = __fadd_rn(__fmul_rn(__fsub_rn(x, __ldg(stats + c)), __ldg(stats + C + c)), __ldg(bias + c));
  if (RELU) y = y <= 0.f ? 0.f : y;  // NaN stays NaN, as F.relu's
  return y;
}

__device__ __forceinline__ void store4(float* out, long long i, const float (&y)[4]) {
  reinterpret_cast<float4*>(out)[i] = make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long i, const float (&y)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(out)[i] = u;
}

__device__ __forceinline__ void store1(float* out, long long e, float y) { out[e] = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, long long e, float y) {
  out[e] = __float2bfloat16_rn(y);
}

// n4: the 4-element chunks taken by 16-byte loads (0 where lv or out is not
// aligned for them); the elements from 4 * n4 on go one by one
template <bool RELU, typename Out>
__global__ void __launch_bounds__(THREADS)
apply_kernel(const float* __restrict__ lv, const float* __restrict__ stats, const float* __restrict__ bias,
             Out* __restrict__ out, long long total, long long n4, int C) {
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int step = (int)((4 * stride) % C);  // the column moves by this each iteration
  int c = (int)((4 * first) % C);
  for (long long i = first; i < n4; i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(lv) + i);
    const float x[4] = {v.x, v.y, v.z, v.w};
    float y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int ck = c + k;
      while (ck >= C) ck -= C;
      y[k] = normalise<RELU>(x[k], ck, stats, bias, C);
    }
    store4(out, i, y);
    c += step;
    if (c >= C) c -= C;
  }
  const int step1 = (int)(stride % C);
  c = (int)((4 * n4 + first) % C);
  for (long long e = 4 * n4 + first; e < total; e += stride) {
    store1(out, e, normalise<RELU>(__ldg(lv + e), c, stats, bias, C));
    c += step1;
    if (c >= C) c -= C;
  }
}

template <bool RELU, typename Out>
cudaError_t launch_apply(const float* lv, const float* stats, const float* bias, void* out, long long total,
                         int C, int vec_bytes, cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)lv % 16 | (uintptr_t)out % vec_bytes;
  const long long n4 = align == 0 ? total / 4 : 0;
  const long long work = n4 + (total - 4 * n4);
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long most = (long long)sm_count() * 8;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  apply_kernel<RELU, Out><<<(unsigned)blocks, THREADS, 0, stream>>>(lv, stats, bias, static_cast<Out*>(out),
                                                                   total, n4, C);
  return cudaGetLastError();
}

}  // namespace

// f32 scratch elements for a (cap, C) call: the partials' sums (2C a block)
// and counts (one int32 a block), then mean_c and mul_c
extern "C" long long lnt_group_norm_act_scratch(long long cap, int C) {
  const long long nblk = partial_blocks(cap);
  return nblk * 2LL * C + nblk + 2LL * C;
}

extern "C" int lnt_group_norm_act(const void* lv, const void* mask, const void* scale, const void* bias,
                                  void* out, void* scratch, long long cap, int C, int groups, float eps,
                                  int relu, int out_bf16, void* stream) {
  if (cap == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(lv);
  const int gs = C / groups;
  const int nblk = partial_blocks(cap);
  float* part = static_cast<float*>(scratch);
  int* counts = reinterpret_cast<int*>(part + (long long)nblk * 2 * C);
  float* stats = part + (long long)nblk * 2 * C + nblk;
  const bool vec = C % 4 == 0 && (uintptr_t)lv % 16 == 0;
  const size_t shared = (size_t)(C + 2 * THREADS * (vec ? 4 : 1)) * sizeof(float);
  if (vec)
    partials_kernel<4><<<nblk, THREADS, shared, s>>>(x, static_cast<const uint8_t*>(mask), cap, C, gs, part,
                                                     counts);
  else
    partials_kernel<1><<<nblk, THREADS, shared, s>>>(x, static_cast<const uint8_t*>(mask), cap, C, gs, part,
                                                     counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<groups, THREADS, (size_t)(2 * THREADS + 2 * gs) * sizeof(float), s>>>(
      x, part, counts, nblk, C, gs, static_cast<const float*>(scale), eps, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* b = static_cast<const float*>(bias);
  const long long total = cap * C;
  if (out_bf16)
    err = relu ? launch_apply<true, __nv_bfloat16>(x, stats, b, out, total, C, 8, s)
               : launch_apply<false, __nv_bfloat16>(x, stats, b, out, total, C, 8, s);
  else
    err = relu ? launch_apply<true, float>(x, stats, b, out, total, C, 16, s)
               : launch_apply<false, float>(x, stats, b, out, total, C, 16, s);
  return (int)err;
}
