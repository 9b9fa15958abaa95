// LAMB's two passes over a flat parameter (or a ZeRO bucket's flat shard),
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels mxnet_tpu/ops/fused_optimizer.py::_kernel_flat_lamb1
// (#9) and ::_kernel_flat_apply (#10), both launched by _launch.
//
// Pass 1 (mx_flat_lamb1) reads every element of the weight w (or its fp32
// master), the gradient g and the moments mean, var once and writes the
// fp32 direction and the new moments (in place, in their own dtype):
//   g32  = clip(g * rescale)
//   m    = beta1 * mean + omb1 * g32;  v = beta2 * var + (omb2 * g32) * g32
//   mh   = m / d1;  vh = v / d2                 (only with bias correction)
//   dir  = mh / (sqrt(vh) + eps) + wd * w32
// with omb = 1 - beta and d = 1 - beta^t computed by the caller in double,
// and wd a scalar or a per-element fp32 vector. Each step is one
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA and the
// outputs equal the same formula as separate fp32 torch ops, bit for bit.
//
// With norms it also returns, for each key (parameter) of the bucket, the
// squared norms ||w32||^2 and ||dir||^2 as a (2, n_keys) fp32 tensor. The TPU
// kernel did one masked reduction per key per tile (O(n_keys x n) work). Here
// the caller gives a chunk table built once per bucket from the bucket's
// contiguous key segments: (start, length <= chunk) per chunk, chunks grouped
// by key, and each key's first chunk. One block updates one chunk and writes
// its two partial sums; a second launch sums each key's partials in a fixed
// order (one warp per key). No atomics: the same norms every run. Padding
// elements that belong to no key sit in chunks after the last key's and are
// updated like any other element.
//
// Pass 2 (mx_flat_lamb2) writes w32 - scale * dir into w (its own dtype) and
// the fp32 master (mp on). scale is a host scalar (per-parameter path), one
// fp32 value on the card (stride 0: the per-parameter path without a host
// round trip), or per element (stride 1: lr x trust ratio of each element's
// key on the ZeRO path).
//
// What bounds them on an H100: bytes. Pass 1 in bf16 with per-element wd
// reads 2 + 2 + 2 + 2 + 4 and writes 4 + 2 + 2 bytes per element; pass 2
// reads 2 + 4 + 4 and writes 2. Loads are 16-byte (fp32) or 8-byte
// (bf16/fp16) vectors of four elements wherever the element index and every
// pointer are aligned, with scalar heads and tails. w, g and the moments may
// each be fp32, bf16 or fp16; the master, the direction and wd/scale are fp32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

enum { CLIP = 1, MP = 2, BIAS_CORR = 4, VEC_WD = 8 };
constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const f16* p, int64_t i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st(f16* p, int64_t i, float v) {
  p[i] = __float2half_rn(v);
}

__device__ __forceinline__ void ld4(const float* p, int64_t i, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p + i);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld4(const bf16* p, int64_t i, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p + i);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void ld4(const f16* p, int64_t i, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p + i);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, int64_t i, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(bf16* p, int64_t i, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p + i) = t;
}
__device__ __forceinline__ void st4(f16* p, int64_t i, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__half2*>(&t.x) = __floats2half2_rn(v[0], v[1]);
  *reinterpret_cast<__half2*>(&t.y) = __floats2half2_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p + i) = t;
}

// clamp into [-c, c]; a NaN stays NaN, as torch.clamp and jnp.clip keep it
__device__ __forceinline__ float clip(float v, float c) {
  return v < -c ? -c : (v > c ? c : v);
}

struct Lamb1Args {
  float beta1, omb1, beta2, omb2, d1, d2, eps, rescale, clip, wd;
  const float* wdv;
  int flags;
};

// cnt (<= 4) elements from i: through vector loads (vec), else one by one.
// Adds w32^2 and dir^2 of those elements to sw and sg.
template <typename TW, typename TG, typename TS>
__device__ __forceinline__ void lamb1_step(const TW* w, const TG* g, TS* mean,
                                           TS* var, const float* master,
                                           float* gdir, const Lamb1Args& a,
                                           int64_t i, int cnt, bool vec,
                                           float& sw, float& sg) {
  float wv[4], gv[4], mv[4], vv[4], wd[4];
  const bool mp = a.flags & MP, vwd = a.flags & VEC_WD;
  if (vec) {
    if (mp) ld4(master, i, wv); else ld4(w, i, wv);
    ld4(g, i, gv);
    ld4(mean, i, mv);
    ld4(var, i, vv);
    if (vwd) ld4(a.wdv, i, wd);
  } else {
    for (int k = 0; k < cnt; ++k) {
      wv[k] = mp ? master[i + k] : ld(w, i + k);
      gv[k] = ld(g, i + k);
      mv[k] = ld(mean, i + k);
      vv[k] = ld(var, i + k);
      if (vwd) wd[k] = a.wdv[i + k];
    }
  }
  float dv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= cnt) break;
    float g32 = __fmul_rn(gv[k], a.rescale);
    if (a.flags & CLIP) g32 = clip(g32, a.clip);
    const float m = __fadd_rn(__fmul_rn(a.beta1, mv[k]), __fmul_rn(a.omb1, g32));
    const float v = __fadd_rn(__fmul_rn(a.beta2, vv[k]),
                              __fmul_rn(__fmul_rn(a.omb2, g32), g32));
    float mh = m, vh = v;
    if (a.flags & BIAS_CORR) {
      mh = __fdiv_rn(m, a.d1);
      vh = __fdiv_rn(v, a.d2);
    }
    const float d = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), a.eps)),
                              __fmul_rn(vwd ? wd[k] : a.wd, wv[k]));
    dv[k] = d;
    mv[k] = m;
    vv[k] = v;
    sw = __fadd_rn(sw, __fmul_rn(wv[k], wv[k]));
    sg = __fadd_rn(sg, __fmul_rn(d, d));
  }
  if (vec) {
    st4(gdir, i, dv);
    st4(mean, i, mv);
    st4(var, i, vv);
  } else {
    for (int k = 0; k < cnt; ++k) {
      gdir[i + k] = dv[k];
      st(mean, i + k, mv[k]);
      st(var, i + k, vv[k]);
    }
  }
}

// pass 1 without norms: grid-stride over n, four elements per thread a step
template <typename TW, typename TG, typename TS>
__global__ void __launch_bounds__(THREADS)
    lamb1_kernel(const TW* __restrict__ w, const TG* __restrict__ g,
                 TS* __restrict__ mean, TS* __restrict__ var,
                 const float* __restrict__ master, float* __restrict__ gdir,
                 int64_t n, Lamb1Args a, bool vec) {
  float sw = 0.f, sg = 0.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    const int cnt = n - i < 4 ? (int)(n - i) : 4;
    lamb1_step(w, g, mean, var, master, gdir, a, i, cnt, vec && cnt == 4, sw,
               sg);
  }
}

// sum of v over the block, in a fixed order; the result in thread 0
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int k = 0; k < THREADS / 32; ++k) total = __fadd_rn(total, sh[k]);
  __syncthreads();
  return total;
}

// pass 1 with norms: block c updates chunk c and writes its partials
// (partial[c] = sum w32^2, partial[n_chunks + c] = sum dir^2)
template <typename TW, typename TG, typename TS>
__global__ void __launch_bounds__(THREADS)
    lamb1_chunk_kernel(const TW* __restrict__ w, const TG* __restrict__ g,
                       TS* __restrict__ mean, TS* __restrict__ var,
                       const float* __restrict__ master,
                       float* __restrict__ gdir,
                       const long long* __restrict__ chunk_start,
                       const int* __restrict__ chunk_len, int n_chunks,
                       float* __restrict__ partial, Lamb1Args a, bool vec) {
  __shared__ float sh[THREADS / 32];
  const int c = blockIdx.x;
  const int64_t s = chunk_start[c], e = s + chunk_len[c];
  const int t = threadIdx.x;
  float sw = 0.f, sg = 0.f;
  // [s, lo): scalar head up to the first index that is a multiple of 4;
  // [lo, hi): four at a time; [hi, e): scalar tail
  const int64_t lo = ((s + 3) & ~(int64_t)3) < e ? ((s + 3) & ~(int64_t)3) : e;
  const int64_t hi = lo + ((e - lo) & ~(int64_t)3);
  if (t < lo - s)
    lamb1_step(w, g, mean, var, master, gdir, a, s + t, 1, false, sw, sg);
  for (int64_t i = lo + (int64_t)t * 4; i < hi; i += THREADS * 4)
    lamb1_step(w, g, mean, var, master, gdir, a, i, 4, vec, sw, sg);
  if (t < e - hi)
    lamb1_step(w, g, mean, var, master, gdir, a, hi + t, 1, false, sw, sg);
  sw = block_sum(sw, sh);
  sg = block_sum(sg, sh);
  if (t == 0) {
    partial[c] = sw;
    partial[n_chunks + c] = sg;
  }
}

// norms[k] = sum of key k's partials, one warp per key, fixed order
__global__ void __launch_bounds__(THREADS)
    lamb_norms_kernel(const float* __restrict__ partial, int n_chunks,
                      const int* __restrict__ key_first, int n_keys,
                      float* __restrict__ norms) {
  const int k = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= n_keys) return;
  float sw = 0.f, sg = 0.f;
  for (int c = key_first[k] + lane; c < key_first[k + 1]; c += 32) {
    sw = __fadd_rn(sw, partial[c]);
    sg = __fadd_rn(sg, partial[n_chunks + c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sw = __fadd_rn(sw, __shfl_down_sync(0xffffffffu, sw, off));
    sg = __fadd_rn(sg, __shfl_down_sync(0xffffffffu, sg, off));
  }
  if (lane == 0) {
    norms[k] = sw;
    norms[n_keys + k] = sg;
  }
}

template <typename TW>
__global__ void __launch_bounds__(THREADS)
    lamb2_kernel(TW* __restrict__ w, float* __restrict__ master,
                 const float* __restrict__ gdir,
                 const float* __restrict__ scale_p, int64_t scale_stride,
                 float scale, int64_t n, bool mp, bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    const int cnt = n - i < 4 ? (int)(n - i) : 4;
    float wv[4], dv[4], sv[4];
    if (vec && cnt == 4) {
      if (mp) ld4(master, i, wv); else ld4(w, i, wv);
      ld4(gdir, i, dv);
      if (scale_p != nullptr && scale_stride == 1) ld4(scale_p, i, sv);
    } else {
      for (int k = 0; k < cnt; ++k) {
        wv[k] = mp ? master[i + k] : ld(w, i + k);
        dv[k] = gdir[i + k];
        if (scale_p != nullptr && scale_stride == 1) sv[k] = scale_p[i + k];
      }
    }
    const float s0 = scale_p == nullptr ? scale
                     : (scale_stride == 0 ? scale_p[0] : 0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= cnt) break;
      const float sc = (scale_p != nullptr && scale_stride == 1) ? sv[k] : s0;
      wv[k] = __fsub_rn(wv[k], __fmul_rn(sc, dv[k]));
    }
    if (vec && cnt == 4) {
      st4(w, i, wv);
      if (mp) st4(master, i, wv);
    } else {
      for (int k = 0; k < cnt; ++k) {
        st(w, i + k, wv[k]);
        if (mp) master[i + k] = wv[k];
      }
    }
  }
}

int blocks_for(int64_t n) {
  const int64_t want = (n + 1023) / 1024;   // 256 threads x 4 elements
  return (int)(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// vector loads need 16 bytes for four fp32, 8 for four bf16 or fp16
int vec_bytes(int dtype) { return dtype == 0 ? 16 : 8; }

struct Lamb1Call {
  const void* w;
  const void* g;
  void* mean;
  void* var;
  const float* master;
  float* gdir;
  int64_t n;
  const long long* chunk_start;
  const int* chunk_len;
  int n_chunks;
  const int* key_first;
  int n_keys;
  float* partial;
  float* norms;
};

template <typename TW, typename TG, typename TS>
int lamb1(const Lamb1Call& c, const Lamb1Args& a, bool vec, cudaStream_t s) {
  const TW* w = static_cast<const TW*>(c.w);
  const TG* g = static_cast<const TG*>(c.g);
  TS* mean = static_cast<TS*>(c.mean);
  TS* var = static_cast<TS*>(c.var);
  if (c.chunk_start == nullptr) {
    lamb1_kernel<TW, TG, TS><<<blocks_for(c.n), THREADS, 0, s>>>(
        w, g, mean, var, c.master, c.gdir, c.n, a, vec);
    return (int)cudaGetLastError();
  }
  lamb1_chunk_kernel<TW, TG, TS><<<c.n_chunks, THREADS, 0, s>>>(
      w, g, mean, var, c.master, c.gdir, c.chunk_start, c.chunk_len,
      c.n_chunks, c.partial, a, vec);
  int err = (int)cudaGetLastError();
  if (err || c.n_keys == 0) return err;
  const int per = THREADS / 32;
  lamb_norms_kernel<<<(c.n_keys + per - 1) / per, THREADS, 0, s>>>(
      c.partial, c.n_chunks, c.key_first, c.n_keys, c.norms);
  return (int)cudaGetLastError();
}

template <typename TW, typename TG>
int lamb1_s(int sd, const Lamb1Call& c, const Lamb1Args& a, bool vec,
            cudaStream_t s) {
  switch (sd) {
    case 0: return lamb1<TW, TG, float>(c, a, vec, s);
    case 1: return lamb1<TW, TG, bf16>(c, a, vec, s);
    case 2: return lamb1<TW, TG, f16>(c, a, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TW>
int lamb1_g(int gd, int sd, const Lamb1Call& c, const Lamb1Args& a, bool vec,
            cudaStream_t s) {
  switch (gd) {
    case 0: return lamb1_s<TW, float>(sd, c, a, vec, s);
    case 1: return lamb1_s<TW, bf16>(sd, c, a, vec, s);
    case 2: return lamb1_s<TW, f16>(sd, c, a, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TW>
int lamb2(void* w, float* master, const float* gdir, const float* scale_p,
          int64_t scale_stride, float scale, int64_t n, bool mp, bool vec,
          cudaStream_t s) {
  lamb2_kernel<TW><<<blocks_for(n), THREADS, 0, s>>>(
      static_cast<TW*>(w), master, gdir, scale_p, scale_stride, scale, n, mp,
      vec);
  return (int)cudaGetLastError();
}

bool valid(int d) { return d == 0 || d == 1 || d == 2; }

}  // namespace

extern "C" {

// Pass 1 over n elements. w (w_dtype), g (g_dtype), mean and var
// (state_dtype, updated in place), master fp32 (read, MP), gdir fp32 (n,)
// written. wd_vec fp32 (n,) with VEC_WD, else the scalar wd. dtypes: 0 fp32,
// 1 bf16, 2 fp16. flags: 1 clip, 2 mp, 4 bias correction, 8 vec wd.
// Without a chunk table (chunk_start null) one grid-stride launch; with one,
// n_chunks blocks write partial (2, n_chunks) fp32 and, when n_keys > 0, a
// second launch writes norms (2, n_keys) fp32 from key_first (n_keys + 1).
// Returns the first cudaError_t.
int mx_flat_lamb1(const void* w, const void* g, void* mean, void* var,
                  const void* master, void* gdir, const void* wd_vec,
                  long long n, const void* chunk_start, const void* chunk_len,
                  int n_chunks, const void* key_first, int n_keys,
                  void* partial, void* norms, float beta1, float omb1,
                  float beta2, float omb2, float d1, float d2, float eps,
                  float rescale, float clip_value, float wd, int w_dtype,
                  int g_dtype, int state_dtype, int flags, void* stream) {
  if (!valid(w_dtype) || !valid(g_dtype) || !valid(state_dtype) || n <= 0 ||
      (chunk_start != nullptr && n_chunks <= 0))
    return (int)cudaErrorInvalidValue;
  const Lamb1Args a{beta1, omb1, beta2, omb2, d1, d2, eps, rescale,
                    clip_value, wd, static_cast<const float*>(wd_vec), flags};
  const Lamb1Call c{w, g, mean, var, static_cast<const float*>(master),
                    static_cast<float*>(gdir), n,
                    static_cast<const long long*>(chunk_start),
                    static_cast<const int*>(chunk_len), n_chunks,
                    static_cast<const int*>(key_first), n_keys,
                    static_cast<float*>(partial), static_cast<float*>(norms)};
  const bool vec = aligned(w, vec_bytes(w_dtype)) &&
                   aligned(g, vec_bytes(g_dtype)) &&
                   aligned(mean, vec_bytes(state_dtype)) &&
                   aligned(var, vec_bytes(state_dtype)) &&
                   aligned(master, 16) && aligned(gdir, 16) &&
                   aligned(wd_vec, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case 0: return lamb1_g<float>(g_dtype, state_dtype, c, a, vec, s);
    case 1: return lamb1_g<bf16>(g_dtype, state_dtype, c, a, vec, s);
    default: return lamb1_g<f16>(g_dtype, state_dtype, c, a, vec, s);
  }
}

// Pass 2 over n elements, in place: w (w_dtype) and master fp32 (flags & 2)
// become w32 - scale * gdir. scale_ptr null: the scalar `scale`; else fp32
// values read at scale_ptr[i * scale_stride] (stride 0: one value on the
// card; 1: per element). Returns the launch's cudaError_t.
int mx_flat_lamb2(void* w, void* master, const void* gdir,
                  const void* scale_ptr, long long scale_stride, long long n,
                  float scale, int w_dtype, int flags, void* stream) {
  if (!valid(w_dtype) || n <= 0 || (scale_stride != 0 && scale_stride != 1))
    return (int)cudaErrorInvalidValue;
  const bool mp = flags & MP;
  const bool vec = aligned(w, vec_bytes(w_dtype)) && aligned(master, 16) &&
                   aligned(gdir, 16) &&
                   (scale_stride == 0 || aligned(scale_ptr, 16));
  const float* sp = static_cast<const float*>(scale_ptr);
  float* ms = static_cast<float*>(master);
  const float* gd = static_cast<const float*>(gdir);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case 0: return lamb2<float>(w, ms, gd, sp, scale_stride, scale, n, mp, vec, s);
    case 1: return lamb2<bf16>(w, ms, gd, sp, scale_stride, scale, n, mp, vec, s);
    default: return lamb2<f16>(w, ms, gd, sp, scale_stride, scale, n, mp, vec, s);
  }
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
