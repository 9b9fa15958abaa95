// One-pass SGD(-momentum) and Adam updates over a flat parameter, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels mxnet_tpu/ops/fused_optimizer.py::_kernel_flat_sgd
// and ::_kernel_flat_adam (both launched by _launch). Each element of the
// weight w, its gradient g and its state (momentum; or Adam's mean and var;
// plus an fp32 master copy when mp is on) is read once, the update runs in
// fp32 registers, and every output is written once, in place:
//   SGD:  g32 = clip(g * rescale) + wd * w32
//         momentum on:  m = mom * momentum - lr * g32;  w32' = w32 + m
//         momentum off: w32' = w32 - lr * g32
//   Adam: g32 = clip(g * rescale) + wd * w32
//         m = beta1 * mean + omb1 * g32;  v = beta2 * var + (omb2 * g32) * g32
//         w32' = w32 - (lr * m) / (sqrt(v) + eps)
// with w32 the master (mp on) or the weight upcast, omb1 = 1 - beta1 and
// omb2 = 1 - beta2 computed by the caller in double, and lr/wd either scalars
// or per-element fp32 vectors (vec_lrwd: the flat ZeRO shard's layout). The
// operations run in the order of the reference's _fused_flat_xla, each with
// a round-to-nearest intrinsic so that nvcc contracts nothing into an FMA:
// the result is the one that the same formula gives as separate fp32 torch
// ops. Each output is rounded once to its own dtype; the weight comes from the
// fp32 momentum, not the rounded one. w, g and the state may each be fp32 or
// bf16 (Adam's mean and var share one dtype); the master is fp32.
//
// What bounds it on an H100: bytes (a handful of flops per element). SGD with
// momentum in bf16 moves 2 + 2 + 2 reads and 2 + 2 writes per element. The
// kernel is grid-stride, four elements per thread per step, with 16-byte
// (fp32) or 8-byte (bf16) vector loads when every pointer is aligned and a
// scalar tail. One launch per parameter: a multi-tensor launch over all of a
// step's parameters is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { MOMENTUM = 1, CLIP = 2, MP = 4, VEC_LRWD = 8 };

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
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
__device__ __forceinline__ void st4(float* p, int64_t i, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(bf16* p, int64_t i, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p + i) = t;
}

// clamp into [-c, c]; a NaN stays NaN, as torch.clamp and jnp.clip keep it
__device__ __forceinline__ float clip(float v, float c) {
  return v < -c ? -c : (v > c ? c : v);
}

struct SgdArgs {
  float lr, wd, momentum, rescale, clip;
  const float* lrv;
  const float* wdv;
  int flags;
};

struct AdamArgs {
  float lr, wd, beta1, omb1, beta2, omb2, eps, rescale, clip;
  const float* lrv;
  const float* wdv;
  int flags;
};

// g32 = clip(g * rescale) + wd * w32
__device__ __forceinline__ float prep(float g, float w32, float rescale,
                                      float c, bool clip_on, float wd) {
  float g32 = __fmul_rn(g, rescale);
  if (clip_on) g32 = clip(g32, c);
  return __fadd_rn(g32, __fmul_rn(wd, w32));
}

// n elements from i: four through vector loads (vec), else one by one
template <typename TW, typename TG, typename TS>
__device__ __forceinline__ void sgd_step(TW* w, const TG* g, TS* mom,
                                         float* master, const SgdArgs& a,
                                         int64_t i, int cnt, bool vec) {
  float wv[4], gv[4], mv[4], lr[4], wd[4];
  const bool mom_on = a.flags & MOMENTUM, mp = a.flags & MP;
  const bool vlr = a.flags & VEC_LRWD, clip_on = a.flags & CLIP;
  if (vec) {
    if (mp) ld4(master, i, wv); else ld4(w, i, wv);
    ld4(g, i, gv);
    if (mom_on) ld4(mom, i, mv);
    if (vlr) { ld4(a.lrv, i, lr); ld4(a.wdv, i, wd); }
  } else {
    for (int k = 0; k < cnt; ++k) {
      wv[k] = mp ? master[i + k] : ld(w, i + k);
      gv[k] = ld(g, i + k);
      if (mom_on) mv[k] = ld(mom, i + k);
      if (vlr) { lr[k] = a.lrv[i + k]; wd[k] = a.wdv[i + k]; }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= cnt) break;
    const float l = vlr ? lr[k] : a.lr, d = vlr ? wd[k] : a.wd;
    const float g32 = prep(gv[k], wv[k], a.rescale, a.clip, clip_on, d);
    if (mom_on) {
      const float m = __fsub_rn(__fmul_rn(mv[k], a.momentum), __fmul_rn(l, g32));
      mv[k] = m;
      wv[k] = __fadd_rn(wv[k], m);
    } else {
      wv[k] = __fsub_rn(wv[k], __fmul_rn(l, g32));
    }
  }
  if (vec) {
    st4(w, i, wv);
    if (mom_on) st4(mom, i, mv);
    if (mp) st4(master, i, wv);
  } else {
    for (int k = 0; k < cnt; ++k) {
      st(w, i + k, wv[k]);
      if (mom_on) st(mom, i + k, mv[k]);
      if (mp) master[i + k] = wv[k];
    }
  }
}

template <typename TW, typename TG, typename TS>
__device__ __forceinline__ void adam_step(TW* w, const TG* g, TS* mean,
                                          TS* var, float* master,
                                          const AdamArgs& a, int64_t i,
                                          int cnt, bool vec) {
  float wv[4], gv[4], mv[4], vv[4], lr[4], wd[4];
  const bool mp = a.flags & MP, vlr = a.flags & VEC_LRWD;
  const bool clip_on = a.flags & CLIP;
  if (vec) {
    if (mp) ld4(master, i, wv); else ld4(w, i, wv);
    ld4(g, i, gv);
    ld4(mean, i, mv);
    ld4(var, i, vv);
    if (vlr) { ld4(a.lrv, i, lr); ld4(a.wdv, i, wd); }
  } else {
    for (int k = 0; k < cnt; ++k) {
      wv[k] = mp ? master[i + k] : ld(w, i + k);
      gv[k] = ld(g, i + k);
      mv[k] = ld(mean, i + k);
      vv[k] = ld(var, i + k);
      if (vlr) { lr[k] = a.lrv[i + k]; wd[k] = a.wdv[i + k]; }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= cnt) break;
    const float l = vlr ? lr[k] : a.lr, d = vlr ? wd[k] : a.wd;
    const float g32 = prep(gv[k], wv[k], a.rescale, a.clip, clip_on, d);
    const float m = __fadd_rn(__fmul_rn(a.beta1, mv[k]), __fmul_rn(a.omb1, g32));
    const float v = __fadd_rn(__fmul_rn(a.beta2, vv[k]),
                              __fmul_rn(__fmul_rn(a.omb2, g32), g32));
    const float step = __fdiv_rn(__fmul_rn(l, m),
                                 __fadd_rn(__fsqrt_rn(v), a.eps));
    wv[k] = __fsub_rn(wv[k], step);
    mv[k] = m;
    vv[k] = v;
  }
  if (vec) {
    st4(w, i, wv);
    st4(mean, i, mv);
    st4(var, i, vv);
    if (mp) st4(master, i, wv);
  } else {
    for (int k = 0; k < cnt; ++k) {
      st(w, i + k, wv[k]);
      st(mean, i + k, mv[k]);
      st(var, i + k, vv[k]);
      if (mp) master[i + k] = wv[k];
    }
  }
}

template <typename TW, typename TG, typename TS>
__global__ void __launch_bounds__(256)
    flat_sgd_kernel(TW* __restrict__ w, const TG* __restrict__ g,
                    TS* __restrict__ mom, float* __restrict__ master,
                    int64_t n, SgdArgs a, bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    const int cnt = n - i < 4 ? (int)(n - i) : 4;
    sgd_step(w, g, mom, master, a, i, cnt, vec && cnt == 4);
  }
}

template <typename TW, typename TG, typename TS>
__global__ void __launch_bounds__(256)
    flat_adam_kernel(TW* __restrict__ w, const TG* __restrict__ g,
                     TS* __restrict__ mean, TS* __restrict__ var,
                     float* __restrict__ master, int64_t n, AdamArgs a,
                     bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    const int cnt = n - i < 4 ? (int)(n - i) : 4;
    adam_step(w, g, mean, var, master, a, i, cnt, vec && cnt == 4);
  }
}

int blocks_for(int64_t n) {
  const int64_t want = (n + 1023) / 1024;   // 256 threads x 4 elements
  return (int)(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// vector loads need 16 bytes for four fp32, 8 for four bf16
int vec_bytes(int dtype) { return dtype == 0 ? 16 : 8; }

template <typename TW, typename TG, typename TS>
int sgd(void* w, const void* g, void* mom, void* master, int64_t n,
        const SgdArgs& a, bool vec, cudaStream_t s) {
  flat_sgd_kernel<TW, TG, TS><<<blocks_for(n), 256, 0, s>>>(
      static_cast<TW*>(w), static_cast<const TG*>(g), static_cast<TS*>(mom),
      static_cast<float*>(master), n, a, vec);
  return (int)cudaGetLastError();
}

template <typename TW, typename TG, typename TS>
int adam(void* w, const void* g, void* mean, void* var, void* master,
         int64_t n, const AdamArgs& a, bool vec, cudaStream_t s) {
  flat_adam_kernel<TW, TG, TS><<<blocks_for(n), 256, 0, s>>>(
      static_cast<TW*>(w), static_cast<const TG*>(g), static_cast<TS*>(mean),
      static_cast<TS*>(var), static_cast<float*>(master), n, a, vec);
  return (int)cudaGetLastError();
}

// the eight (w, g, state) dtype combinations; 0 = fp32, 1 = bf16
#define MX_DISPATCH(FN, WD, GD, SD, ...)                                   \
  switch ((WD) * 4 + (GD) * 2 + (SD)) {                                    \
    case 0: return FN<float, float, float>(__VA_ARGS__);                   \
    case 1: return FN<float, float, bf16>(__VA_ARGS__);                    \
    case 2: return FN<float, bf16, float>(__VA_ARGS__);                    \
    case 3: return FN<float, bf16, bf16>(__VA_ARGS__);                     \
    case 4: return FN<bf16, float, float>(__VA_ARGS__);                    \
    case 5: return FN<bf16, float, bf16>(__VA_ARGS__);                     \
    case 6: return FN<bf16, bf16, float>(__VA_ARGS__);                     \
    case 7: return FN<bf16, bf16, bf16>(__VA_ARGS__);                      \
    default: return (int)cudaErrorInvalidValue;                            \
  }

bool valid(int d) { return d == 0 || d == 1; }

}  // namespace

extern "C" {

// In place over n elements: w (w_dtype), mom (state_dtype; unused without
// MOMENTUM), master fp32 (MP). g in g_dtype. lr_vec/wd_vec fp32 (n,) with
// VEC_LRWD, else the scalars lr/wd. flags: 1 momentum, 2 clip, 4 mp, 8
// vec_lrwd. One launch on `stream`; returns its cudaError_t.
int mx_flat_sgd(void* w, const void* g, void* mom, void* master,
                const void* lr_vec, const void* wd_vec, long long n, float lr,
                float wd, float momentum, float rescale, float clip_value,
                int w_dtype, int g_dtype, int state_dtype, int flags,
                void* stream) {
  if (!valid(w_dtype) || !valid(g_dtype) || !valid(state_dtype) || n <= 0)
    return (int)cudaErrorInvalidValue;
  const SgdArgs a{lr, wd, momentum, rescale, clip_value,
                  static_cast<const float*>(lr_vec),
                  static_cast<const float*>(wd_vec), flags};
  const bool vec = aligned(w, vec_bytes(w_dtype)) &&
                   aligned(g, vec_bytes(g_dtype)) &&
                   aligned(mom, vec_bytes(state_dtype)) &&
                   aligned(master, 16) && aligned(lr_vec, 16) &&
                   aligned(wd_vec, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH(sgd, w_dtype, g_dtype, state_dtype, w, g, mom, master, n, a,
              vec, s)
}

// In place over n elements: w, mean and var (mean and var share
// state_dtype), master fp32 (MP); as mx_flat_sgd otherwise. omb1 = 1 -
// beta1 and omb2 = 1 - beta2, computed by the caller in double.
int mx_flat_adam(void* w, const void* g, void* mean, void* var, void* master,
                 const void* lr_vec, const void* wd_vec, long long n,
                 float lr, float wd, float beta1, float omb1, float beta2,
                 float omb2, float eps, float rescale, float clip_value,
                 int w_dtype, int g_dtype, int state_dtype, int flags,
                 void* stream) {
  if (!valid(w_dtype) || !valid(g_dtype) || !valid(state_dtype) || n <= 0)
    return (int)cudaErrorInvalidValue;
  const AdamArgs a{lr, wd, beta1, omb1, beta2, omb2, eps, rescale,
                   clip_value, static_cast<const float*>(lr_vec),
                   static_cast<const float*>(wd_vec), flags};
  const bool vec = aligned(w, vec_bytes(w_dtype)) &&
                   aligned(g, vec_bytes(g_dtype)) &&
                   aligned(mean, vec_bytes(state_dtype)) &&
                   aligned(var, vec_bytes(state_dtype)) &&
                   aligned(master, 16) && aligned(lr_vec, 16) &&
                   aligned(wd_vec, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_DISPATCH(adam, w_dtype, g_dtype, state_dtype, w, g, mean, var, master,
              n, a, vec, s)
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
