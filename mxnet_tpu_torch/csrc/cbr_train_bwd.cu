// BatchNorm + ReLU (+ residual) backward of the fused conv3x3 + BN + ReLU
// training op, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_conv.py::_kernel_train_bwd
// (launched by _pallas_cbr_bwd). From the saved conv output, the output's
// gradient dy, the batch mean and invstd and gamma, beta (+ the residual) it
// recomputes xhat = (conv - mean) * invstd, y = xhat * gamma + beta (+ res)
// and the ReLU mask g = dy * [y > 0], and produces
//   dbeta = sum g, dgamma = sum g * xhat              (per channel, fp32)
//   dconv = invstd * (g * gamma - gamma * dbeta / M - xhat * gamma * dgamma / M)
//   dres  = g                                          (residual's dtype)
// with M = N*H*W rows. xhat, y and the mask are recomputed with
// round-to-nearest intrinsics (no contraction into FMAs), op by op as the
// plain PyTorch version computes them, so both take the same mask. The sums
// are added in an order fixed by the shape and the grid, so two launches
// give the same bits.
//
// What bounds it on an H100: bytes. conv and dy are read, dconv is written
// in fp32 (and dres in the residual's type): 8 bytes an element at bf16.
// The sums must be complete before any dconv, so a plain design reads conv
// and dy twice (12 bytes an element).
//
// Design. On the TPU one pallas_call walked the grid (channel block, phase,
// image) in order and carried the two sums in VMEM from phase 0 to phase 1.
// Hopper runs blocks in no order. Two variants, picked by the caller from
// the shape before the launch (ops.fused_conv.cbr_bwd_plan); in both a
// thread owns V channels (V = 8: 16 bytes of bf16, read and written as
// 16-byte vectors; V = 1 where Cout is not a multiple of 8) across rows,
// with the per-channel constants in registers:
//
//  persistent (Cout a multiple of 8, up to 4096): one cooperative launch,
//    a block on every SM, each owning a contiguous range of rows. Each
//    thread streams its rows through cp.async, 8 (bf16) or 4 (fp32) rows
//    in flight, into shared memory, and the block keeps as many conv and
//    dy rows there as its ~210 KB hold (about 13% of stage 1, 53% of stage
//    3 and all of stage 4 at batch 256). Phase 0 reads the rows it will
//    not keep first, through a ring of each thread's first cells, then the
//    kept rows into their cells, adding the block's partial sums. dy is
//    kept raw, so phase 1 recomputes the mask as the split pass does (the
//    residual, if any, is read again). The block's partials go through
//    shared memory to a (blocks, 2, Cout) scratch. Grid barrier; each block
//    sums its share of the columns over all blocks in a fixed order; grid
//    barrier; each block reads the sums once into shared memory. Phase 1
//    computes a few kept rows to free the ring's cells, re-reads the rows
//    it did not keep, last read first (those may still be in L2), then
//    computes the other kept rows, which need no reads. dconv is written
//    with the streaming hint. On an H100 (PERF.md section 6) it is about
//    1.7x faster than the earlier scalar three-launch design at ResNet-50's
//    four stage shapes, 4-16% faster than the vectorized three launches
//    below at stages 1-3 and level at stage 4, and 1.9-2.2x its bytes
//    bound: most of its bytes are the fp32 dconv it writes.
//  split (other shapes): three launches: partial sums of chunks of 8 rows
//    a thread, a fixed-order column sum, and the dconv pass (conv and dy
//    read twice).
//
// Statistics over several ranks (a data-parallel step whose BatchNorm
// normalizes over the global batch): the sums of every rank must be added
// before any dconv, so the caller runs the split variant in two calls
// (mx_cbr_train_bwd_staged): stage 1 the partial sums and the column sum,
// then the caller's cross-rank all-reduce of the sums, then stage 2 the
// dconv pass with M the global row count. The persistent variant computes
// both in one cooperative launch and has no point where the sums could
// leave the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxDevices = 64;

constexpr int SPLIT_THREADS = 256;  // threads of a split block
constexpr int PT = 512;             // threads of a persistent block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- packs
// V consecutive values of T: one scalar, or 8 values as one (bf16) or two
// (fp32) 16-byte words
template <typename T, int V> struct Pack;
template <typename T> struct Pack<T, 1> { T x; };
template <> struct Pack<bf16, 8> { uint4 u; };
template <> struct Pack<float, 8> { uint4 u[2]; };

__device__ __forceinline__ uint32_t& word(uint4& u, int w) {
  return w == 0 ? u.x : (w == 1 ? u.y : (w == 2 ? u.z : u.w));
}
__device__ __forceinline__ uint32_t word(const uint4& u, int w) {
  return w == 0 ? u.x : (w == 1 ? u.y : (w == 2 ? u.z : u.w));
}

template <typename T>
__device__ __forceinline__ void load(Pack<T, 1>& p, const T* a) {
  p.x = *a;
}
__device__ __forceinline__ void load(Pack<bf16, 8>& p, const bf16* a) {
  p.u = *reinterpret_cast<const uint4*>(a);
}
__device__ __forceinline__ void load(Pack<float, 8>& p, const float* a) {
  p.u[0] = reinterpret_cast<const uint4*>(a)[0];
  p.u[1] = reinterpret_cast<const uint4*>(a)[1];
}

template <typename T>
__device__ __forceinline__ void store(T* a, const Pack<T, 1>& p) {
  *a = p.x;
}
__device__ __forceinline__ void store(bf16* a, const Pack<bf16, 8>& p) {
  *reinterpret_cast<uint4*>(a) = p.u;
}
__device__ __forceinline__ void store(float* a, const Pack<float, 8>& p) {
  reinterpret_cast<uint4*>(a)[0] = p.u[0];
  reinterpret_cast<uint4*>(a)[1] = p.u[1];
}

template <typename T>
__device__ __forceinline__ float elem(const Pack<T, 1>& p, int) {
  return to_f(p.x);
}
__device__ __forceinline__ float elem(const Pack<bf16, 8>& p, int e) {
  const uint32_t w = word(p.u, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float elem(const Pack<float, 8>& p, int e) {
  return __uint_as_float(word(p.u[e >> 2], e & 3));
}

// element e := v, rounded to T
template <typename T>
__device__ __forceinline__ void set(Pack<T, 1>& p, int, float v) {
  p.x = from_f<T>(v);
}
__device__ __forceinline__ void set(Pack<bf16, 8>& p, int e, float v) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  uint32_t& w = word(p.u, e >> 1);
  w = (e & 1) ? ((w & 0x0000ffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
}
__device__ __forceinline__ void set(Pack<float, 8>& p, int e, float v) {
  word(p.u[e >> 2], e & 3) = __float_as_uint(v);
}

// dconv is written with the streaming hint (evict first): it is not read
// again here, and the conv and dy rows that phase 1 of the persistent
// variant reads again stay in L2 longer
template <int V>
__device__ __forceinline__ void store_f32(float* a, const float (&d)[V]) {
  if constexpr (V == 1) {
    __stcs(a, d[0]);
  } else {
    __stcs(reinterpret_cast<float4*>(a), make_float4(d[0], d[1], d[2], d[3]));
    __stcs(reinterpret_cast<float4*>(a) + 1,
           make_float4(d[4], d[5], d[6], d[7]));
  }
}

// --------------------------------------------------------- the arithmetic
// The per-channel constants of a thread's V channels
template <int V>
struct Chan {
  float mu[V], inv[V], gam[V], bet[V];
  __device__ __forceinline__ void load(const float* mean, const float* invstd,
                                       const float* gamma, const float* beta,
                                       int c0) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      mu[e] = mean[c0 + e];
      inv[e] = invstd[c0 + e];
      gam[e] = gamma[c0 + e];
      bet[e] = beta[c0 + e];
    }
  }
};

__device__ __forceinline__ float xhat_of(float conv, float mu, float inv) {
  return __fmul_rn(__fsub_rn(conv, mu), inv);
}

// One pack's share of the sums; returns g (dy where y > 0, else 0)
template <bool RES, typename T, typename TR, int V>
__device__ __forceinline__ Pack<T, V> add_sums(const Pack<T, V>& cv,
                                               const Pack<T, V>& dv,
                                               const Pack<TR, V>& rv,
                                               const Chan<V>& ch,
                                               float (&sg)[V],
                                               float (&sgx)[V]) {
  Pack<T, V> g = dv;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float xhat = xhat_of(elem(cv, e), ch.mu[e], ch.inv[e]);
    float y = __fadd_rn(__fmul_rn(xhat, ch.gam[e]), ch.bet[e]);
    if constexpr (RES) y = __fadd_rn(y, elem(rv, e));
    const float gv = y > 0.f ? elem(dv, e) : 0.f;
    if (!(y > 0.f)) set(g, e, 0.f);
    sg[e] += gv;
    sgx[e] += gv * xhat;
  }
  return g;
}

// dconv (and dres) of one pack. MASK: gsrc is dy, masked here from the
// recomputed y; else gsrc is g already.
template <bool MASK, bool RES, typename T, typename TR, int V>
__device__ __forceinline__ void dconv_pack(const Pack<T, V>& cv,
                                           const Pack<T, V>& gsrc,
                                           const Pack<TR, V>& rv,
                                           const Chan<V>& ch,
                                           const float (&k1)[V],
                                           const float (&k2)[V],
                                           float* dconv, TR* dres) {
  float d[V];
  Pack<TR, V> r{};
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float xhat = xhat_of(elem(cv, e), ch.mu[e], ch.inv[e]);
    float gv = elem(gsrc, e);
    if constexpr (MASK) {
      float y = __fadd_rn(__fmul_rn(xhat, ch.gam[e]), ch.bet[e]);
      if constexpr (RES) y = __fadd_rn(y, elem(rv, e));
      gv = y > 0.f ? gv : 0.f;
    }
    d[e] = ch.inv[e] * (gv * ch.gam[e] - k1[e] - xhat * k2[e]);
    if constexpr (RES) set(r, e, gv);
  }
  store_f32<V>(dconv, d);
  if constexpr (RES) store(dres, r);
}

// The block's per-channel sums of sg and sgx for channel groups [g0, g0 +
// cgb) -> dst[c] and dst[C + c], summed over the row slots in order. Thread
// t = k * cgb + group holds row slot k's sums (active: k < R and a real
// group). red: blockDim.x * (V + 1) floats of shared memory.
template <int V>
__device__ __forceinline__ void block_sums(float* red, const float (&sg)[V],
                                           const float (&sgx)[V],
                                           bool active, int R, int cgb,
                                           int g0, int CG, float* dst,
                                           int C) {
  for (int q = 0; q < 2; ++q) {
    __syncthreads();
    if (active) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        red[threadIdx.x * (V + 1) + e] = q ? sgx[e] : sg[e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cgb * V; c += blockDim.x) {
      const int gl = c / V, e = c % V;
      if (g0 + gl >= CG) break;
      float s = 0.f;
      for (int kk = 0; kk < R; ++kk) s += red[(kk * cgb + gl) * (V + 1) + e];
      dst[q * C + (g0 + gl) * V + e] = s;
    }
  }
}

// ------------------------------------------------------------------ split
// blocks over (chunk of `chunk` rows, tile of cgb channel groups); thread
// t = k * cgb + group walks rows k, k + R, ... of the chunk
template <bool RES, typename T, typename TR, int V>
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_partial(const T* __restrict__ conv, const T* __restrict__ dy,
                  const float* __restrict__ mean,
                  const float* __restrict__ invstd,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, const TR* __restrict__ res,
                  float* __restrict__ partial, int M, int C, int chunk) {
  __shared__ float red[SPLIT_THREADS * (V + 1)];
  const int CG = C / V, cgb = min(CG, SPLIT_THREADS), R = SPLIT_THREADS / cgb;
  const int k = threadIdx.x / cgb, g0 = blockIdx.y * cgb;
  const int cg = g0 + threadIdx.x % cgb;
  const bool active = k < R && cg < CG;
  float sg[V] = {}, sgx[V] = {};
  if (active) {
    Chan<V> ch;
    ch.load(mean, invstd, gamma, beta, cg * V);
    const int r0 = blockIdx.x * chunk, n = min(M - r0, chunk);
#pragma unroll 4
    for (int i = k; i < n; i += R) {
      const size_t o = (size_t)(r0 + i) * C + cg * V;
      Pack<T, V> cv, dv;
      Pack<TR, V> rv;
      load(cv, conv + o);
      load(dv, dy + o);
      if constexpr (RES) load(rv, res + o);
      add_sums<RES>(cv, dv, rv, ch, sg, sgx);
    }
  }
  block_sums<V>(red, sg, sgx, active, R, cgb, g0, CG,
                partial + (size_t)blockIdx.x * 2 * C, C);
}

// sums[c] = sum over t of partial[t][c] for c < cols, t in a fixed order
__global__ void __launch_bounds__(1024)
    bwd_col_sum_kernel(const float* __restrict__ partial,
                       float* __restrict__ sums, int tiles, int cols) {
  __shared__ float sPart[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < cols)
    for (int t = threadIdx.y; t < tiles; t += 32)
      acc += partial[(size_t)t * cols + c];
  sPart[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float s = 0.f;
    for (int r = 0; r < 32; ++r) s += sPart[r][threadIdx.x];
    sums[c] = s;
  }
}

template <bool RES, typename T, typename TR, int V>
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_dconv(const T* __restrict__ conv, const T* __restrict__ dy,
                const float* __restrict__ mean,
                const float* __restrict__ invstd,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, const TR* __restrict__ res,
                const float* __restrict__ sums, float* __restrict__ dconv,
                TR* __restrict__ dres, int M, int C, int chunk, float mdiv) {
  const int CG = C / V, cgb = min(CG, SPLIT_THREADS), R = SPLIT_THREADS / cgb;
  const int k = threadIdx.x / cgb;
  const int cg = blockIdx.y * cgb + threadIdx.x % cgb;
  if (k >= R || cg >= CG) return;
  const int c0 = cg * V;
  Chan<V> ch;
  ch.load(mean, invstd, gamma, beta, c0);
  float k1[V], k2[V];
  const float m = mdiv;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    k1[e] = ch.gam[e] * (sums[c0 + e] / m);
    k2[e] = ch.gam[e] * (sums[C + c0 + e] / m);
  }
  const int r0 = blockIdx.x * chunk, n = min(M - r0, chunk);
#pragma unroll 4
  for (int i = k; i < n; i += R) {
    const size_t o = (size_t)(r0 + i) * C + c0;
    Pack<T, V> cv, dv;
    Pack<TR, V> rv;
    load(cv, conv + o);
    load(dv, dy + o);
    if constexpr (RES) load(rv, res + o);
    dconv_pack<true, RES>(cv, dv, rv, ch, k1, k2, dconv + o,
                          RES ? dres + o : nullptr);
  }
}

// ------------------------------------------------------------- persistent
// rows in flight a thread: 16 (bf16) or 32 (fp32) bytes of conv and of dy
// each, 128 KB a block either way
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 8 : 4; }

// this thread's 8 values of row `row` of src -> cell `cell` of a (cells, C)
// shared array of T, by cp.async (16 bytes each)
template <typename T>
__device__ __forceinline__ void fetch(T* cells, int cell, const T* src,
                                      int64_t row, int C, int c0) {
  const uint32_t dst = hopper::smem_u32(cells + (size_t)cell * C + c0);
  const char* g = reinterpret_cast<const char*>(src + row * C + c0);
#pragma unroll
  for (int q = 0; q < (int)sizeof(T) / 2; ++q)
    hopper::cp_async_16(dst + 16 * q, g + 16 * q, 16);
}

// Thread t = k * CG + group owns rows k, k + R, ... of the block's range
// [r0, r0 + n) and channels [c0, c0 + 8). The first `held` rows (all n, or
// a multiple of R) stay in shared memory: thread t's j-th held row in cell
// k + j R of s_conv and s_dy. Phase 0 loads the other rows first, through
// a ring of each thread's first S cells, then the held rows into their
// cells, S rows in flight a thread. Phase 1 frees those S cells by
// computing their held rows, streams the other rows back through them in
// the reverse order (the rows read last are still in L2), then computes
// the remaining held rows.
template <bool RES, typename T, typename TR>
__global__ void __launch_bounds__(PT, 1)
    cbr_bwd_persistent(const T* __restrict__ conv, const T* __restrict__ dy,
                       const float* __restrict__ mean,
                       const float* __restrict__ invstd,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const TR* __restrict__ res, float* partial,
                       float* sums, float* __restrict__ dconv,
                       TR* __restrict__ dres, unsigned int* bar, int M,
                       int C, int held_rows) {
  constexpr int V = 8, S = stages<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[PT * (V + 1)];
  const int CG = C / V, R = PT / CG;
  const int k = threadIdx.x / CG, c0 = (threadIdx.x % CG) * V;
  const bool active = k < R;
  const unsigned int G = gridDim.x;
  Chan<V> ch;
  ch.load(mean, invstd, gamma, beta, c0);
  const int64_t per = ((int64_t)M + G - 1) / G;
  const int64_t start = (int64_t)blockIdx.x * per;
  const int64_t r0 = start < M ? start : M;
  const int n = (int)((r0 + per < M ? r0 + per : M) - r0);
  const int held = n <= held_rows ? n : held_rows / R * R;
  // this thread's held rows and other rows (at least S held when there
  // are others: the launch checks held_rows >= S * R)
  const int n_held = active && k < held ? (held - k + R - 1) / R : 0;
  const int n_rest =
      active && held + k < n ? (n - held - k + R - 1) / R : 0;
  T* s_conv = reinterpret_cast<T*>(smem);
  T* s_dy = s_conv + (size_t)held_rows * C;
  // ring slot of the thread's i-th other row: the last S take slots 0..S-1
  // in order, so held row j < S goes to cell j once its slot's row is done
  const int shift = S - n_rest % S;

  // phase 0: the sums
  float sg[V] = {}, sgx[V] = {};
  const int items = n_rest + n_held;
  auto row0 = [&](int j) -> int64_t {
    return j < n_rest ? r0 + held + k + (int64_t)j * R
                      : r0 + k + (int64_t)(j - n_rest) * R;
  };
  auto cell0 = [&](int j) -> int {
    return k + (j < n_rest ? (j + shift) % S : j - n_rest) * R;
  };
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    if (j < items) {
      fetch(s_conv, cell0(j), conv, row0(j), C, c0);
      fetch(s_dy, cell0(j), dy, row0(j), C, c0);
    }
    hopper::cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < items; ++j) {
    hopper::cp_async_wait<S - 1>();
    const int cell = cell0(j);
    Pack<T, V> cv, dv;
    Pack<TR, V> rv;
    load(cv, s_conv + (size_t)cell * C + c0);
    load(dv, s_dy + (size_t)cell * C + c0);
    if constexpr (RES) load(rv, res + row0(j) * C + c0);
    add_sums<RES>(cv, dv, rv, ch, sg, sgx);
    if (j + S < items) {
      fetch(s_conv, cell0(j + S), conv, row0(j + S), C, c0);
      fetch(s_dy, cell0(j + S), dy, row0(j + S), C, c0);
    }
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<0>();
  block_sums<V>(red, sg, sgx, active, R, CG, 0, CG,
                partial + (size_t)blockIdx.x * 2 * C, C);
  hopper::grid_barrier(bar, G);

  // this block's share of the 2 * C columns, each summed over the blocks
  // in a fixed order (lane-strided, then a fixed shuffle tree)
  const int cols = 2 * C, share = (cols + (int)G - 1) / (int)G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int jj = warp; jj < share; jj += PT / 32) {
    const int j = blockIdx.x * share + jj;
    if (j >= cols) break;
    float s = 0.f;
    for (unsigned int b = lane; b < G; b += 32)
      s += __ldcg(partial + (size_t)b * cols + j);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sums[j] = s;
  }
  hopper::grid_barrier(bar, G);

  // phase 1: dconv (and dres). Each block reads the sums once into shared
  // memory (every thread reading them from L2 would send all blocks' loads
  // to the same few lines)
  float k1[V], k2[V];
  const float m = (float)M;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += PT)
      red[c] = __ldcg(sums + q * C + c);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = ch.gam[e] * (red[c0 + e] / m);
      if (q) k2[e] = v; else k1[e] = v;
    }
  }
  // one row from its cell
  auto emit = [&](int cell, int64_t row) {
    Pack<T, V> cv, dv;
    Pack<TR, V> rv;
    load(cv, s_conv + (size_t)cell * C + c0);
    load(dv, s_dy + (size_t)cell * C + c0);
    const int64_t o = row * C + c0;
    if constexpr (RES) load(rv, res + o);
    dconv_pack<true, RES>(cv, dv, rv, ch, k1, k2, dconv + o,
                          RES ? dres + o : nullptr);
  };
  const int pre = n_rest > 0 ? S : 0;
#pragma unroll 1
  for (int j = 0; j < pre; ++j) emit(k + j * R, r0 + k + (int64_t)j * R);
  // the other rows, last read first, through cells k + (j % S) R
  auto row1 = [&](int j) -> int64_t {
    return r0 + held + k + (int64_t)(n_rest - 1 - j) * R;
  };
#pragma unroll 1
  for (int j = 0; j < pre; ++j) {
    if (j < n_rest) {
      fetch(s_conv, k + j * R, conv, row1(j), C, c0);
      fetch(s_dy, k + j * R, dy, row1(j), C, c0);
    }
    hopper::cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < n_rest; ++j) {
    hopper::cp_async_wait<S - 1>();
    emit(k + (j % S) * R, row1(j));
    if (j + S < n_rest) {
      fetch(s_conv, k + (j % S) * R, conv, row1(j + S), C, c0);
      fetch(s_dy, k + (j % S) * R, dy, row1(j + S), C, c0);
    }
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<0>();
#pragma unroll 1
  for (int j = pre; j < n_held; ++j) emit(k + j * R, r0 + k + (int64_t)j * R);
}

// ----------------------------------------------------------------- launch
struct Args {
  const void *conv, *dy;
  const float *mean, *invstd, *gamma, *beta;
  const void* res;
  float *partial, *sums, *dconv;
  void* dres;
  unsigned int* bar;
  int M, C, grid;     // grid: persistent blocks, or split rows a chunk
  cudaStream_t stream;
  int stage;          // split: 0 all three launches, 1 the sums, 2 dconv
  float mdiv;         // split: the rows the means divide by
};

template <bool RES, typename T, typename TR, int V>
int launch_split(const Args& a) {
  const T* conv = static_cast<const T*>(a.conv);
  const T* dy = static_cast<const T*>(a.dy);
  const TR* res = static_cast<const TR*>(a.res);
  if (a.grid < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (a.M + a.grid - 1) / a.grid;
  const int CG = a.C / V, cgb = CG < SPLIT_THREADS ? CG : SPLIT_THREADS;
  const dim3 grid(chunks, (CG + cgb - 1) / cgb);
  if (a.stage != 2) {
    split_partial<RES, T, TR, V><<<grid, SPLIT_THREADS, 0, a.stream>>>(
        conv, dy, a.mean, a.invstd, a.gamma, a.beta, res, a.partial, a.M,
        a.C, a.grid);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int cols = 2 * a.C;
    bwd_col_sum_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, a.stream>>>(
        a.partial, a.sums, chunks, cols);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.stage == 1) return (int)err;
  }
  split_dconv<RES, T, TR, V><<<grid, SPLIT_THREADS, 0, a.stream>>>(
      conv, dy, a.mean, a.invstd, a.gamma, a.beta, res, a.sums, a.dconv,
      static_cast<TR*>(a.dres), a.M, a.C, a.grid, a.mdiv);
  return (int)cudaGetLastError();
}

template <bool RES, typename T, typename TR>
int launch_persistent(const Args& a) {
  if (a.C % 8 != 0 || a.C / 8 > PT || a.grid < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = cbr_bwd_persistent<RES, T, TR>;
  // the dynamic shared memory a block may take beside the static buffer,
  // read and allowed once a device (host time: these calls cost more than
  // the launch)
  static std::atomic<int> budget[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int bytes = budget[device].load(std::memory_order_relaxed);
  if (bytes == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    bytes = optin - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    budget[device].store(bytes, std::memory_order_relaxed);
  }
  // as many rows as that holds, at most the block's share
  const int64_t row_bytes = (int64_t)a.C * 2 * sizeof(T);
  const int64_t per = ((int64_t)a.M + a.grid - 1) / a.grid;
  int64_t rows = bytes / row_bytes;
  if (rows > per) rows = per;
  // a block that cannot hold all its rows needs S held rows a thread for
  // its ring
  if (rows < per && rows < (int64_t)stages<T>() * (PT / (a.C / 8)))
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(rows * row_bytes);
  const T* conv = static_cast<const T*>(a.conv);
  const T* dy = static_cast<const T*>(a.dy);
  const TR* res = static_cast<const TR*>(a.res);
  TR* dres = static_cast<TR*>(a.dres);
  const float *mean = a.mean, *invstd = a.invstd, *gamma = a.gamma,
              *beta = a.beta;
  float *partial = a.partial, *sums = a.sums, *dconv = a.dconv;
  unsigned int* bar = a.bar;
  int M = a.M, C = a.C, held_rows = (int)rows;
  void* args[] = {&conv, &dy,   &mean,  &invstd, &gamma, &beta, &res,
                  &partial, &sums, &dconv, &dres, &bar, &M, &C,
                  &held_rows};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(a.grid),
                                          dim3(PT), args, smem, a.stream);
}

template <bool RES, typename T, typename TR>
int launch_variant(const Args& a, int variant) {
  switch (variant) {
    case 0: return launch_split<RES, T, TR, 1>(a);
    case 1: return launch_split<RES, T, TR, 8>(a);
    case 2: return launch_persistent<RES, T, TR>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_for(const Args& a, int variant, int res_dtype) {
  if (a.res == nullptr) return launch_variant<false, T, T>(a, variant);
  if (res_dtype == 1) return launch_variant<true, T, bf16>(a, variant);
  return launch_variant<true, T, float>(a, variant);
}

}  // namespace

extern "C" {

// conv and dy (M, Cout) in one dtype (0 = fp32, 1 = bf16); mean, invstd,
// gamma, beta (Cout,) fp32; residual and dres (M, Cout) in res_dtype, both
// null without a residual; dconv (M, Cout) fp32; sums (2, Cout) fp32 out:
// dbeta then dgamma. variant 0 / 1: split with 1 / 8 channels a thread
// (8 needs Cout a multiple of 8) over chunks of `grid` rows, partial a fp32
// scratch of ceil(M / grid) * 2 * Cout; three launches. variant 2:
// persistent over `grid` blocks (at
// most one a multiprocessor), Cout a multiple of 8 up to 4096, partial
// grid * 2 * Cout fp32, bar two unsigned words that are zero (and are zero
// again after the launch); one cooperative launch. 8-channel variants read
// and write 16-byte aligned rows. On `stream`; returns the first error.
int mx_cbr_train_bwd(const void* conv, const void* dy, const void* mean,
                     const void* invstd, const void* gamma, const void* beta,
                     const void* residual, void* partial, void* sums,
                     void* dconv, void* dres, void* bar, int M, int Cout,
                     int dtype, int res_dtype, int variant, int grid,
                     void* stream) {
  Args a{conv,
         dy,
         static_cast<const float*>(mean),
         static_cast<const float*>(invstd),
         static_cast<const float*>(gamma),
         static_cast<const float*>(beta),
         residual,
         static_cast<float*>(partial),
         static_cast<float*>(sums),
         static_cast<float*>(dconv),
         dres,
         static_cast<unsigned int*>(bar),
         M,
         Cout,
         grid,
         static_cast<cudaStream_t>(stream),
         0,
         (float)M};
  if (variant != 0 && Cout % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_for<bf16>(a, variant, res_dtype);
  if (dtype == 0) return launch_for<float>(a, variant, res_dtype);
  return (int)cudaErrorInvalidValue;
}

// The split variants (0 / 1) in two calls, for sums that span several
// ranks: stage 1 writes sums (dbeta then dgamma over this call's M rows)
// and returns; stage 2 reads sums (the caller's cross-rank totals) and
// writes dconv and dres with the means over `mdiv` rows. Arguments as
// mx_cbr_train_bwd; the persistent variant is refused.
int mx_cbr_train_bwd_staged(const void* conv, const void* dy,
                            const void* mean, const void* invstd,
                            const void* gamma, const void* beta,
                            const void* residual, void* partial, void* sums,
                            void* dconv, void* dres, int M, int Cout,
                            int dtype, int res_dtype, int variant, int grid,
                            int stage, float mdiv, void* stream) {
  Args a{conv,
         dy,
         static_cast<const float*>(mean),
         static_cast<const float*>(invstd),
         static_cast<const float*>(gamma),
         static_cast<const float*>(beta),
         residual,
         static_cast<float*>(partial),
         static_cast<float*>(sums),
         static_cast<float*>(dconv),
         dres,
         nullptr,
         M,
         Cout,
         grid,
         static_cast<cudaStream_t>(stream),
         stage,
         mdiv};
  if (variant > 1 || (stage != 1 && stage != 2) ||
      (variant == 1 && Cout % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_for<bf16>(a, variant, res_dtype);
  if (dtype == 0) return launch_for<float>(a, variant, res_dtype);
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
