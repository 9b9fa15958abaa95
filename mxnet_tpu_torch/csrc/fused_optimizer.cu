// SGD(-momentum) and Adam over a list of tensors in one launch, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels mxnet_tpu/ops/fused_optimizer.py::_kernel_flat_sgd
// and ::_kernel_flat_adam (both launched by _launch), and serves the
// reference's aggregated update (optimizer.py::_fused_fn, one jitted call
// over every parameter of a step) with one launch. Each element of a weight
// w, its gradient g and its state (momentum; or Adam's mean and var; plus an
// fp32 master copy when mp is on) is read once, the update runs in fp32
// registers, and every output is written once, in place:
//   SGD:  g32 = clip(g * rescale) + wd * w32
//         momentum on:  m = mom * momentum - lr * g32;  w32' = w32 + m
//         momentum off: w32' = w32 - lr * g32
//   Adam: g32 = clip(g * rescale) + wd * w32
//         m = beta1 * mean + omb1 * g32;  v = beta2 * var + (omb2 * g32) * g32
//         w32' = w32 - (lr * m) / (sqrt(v) + eps)
// with w32 the master (mp on) or the weight upcast, omb1 = 1 - beta1 and
// omb2 = 1 - beta2 as the caller computed them, and lr/wd each tensor's own
// fp32 scalars or, for a one-tensor launch, per-element fp32 vectors
// (VEC_LRWD: the flat ZeRO shard's layout). The operations run in the order
// of the reference's _fused_flat_xla, each with a round-to-nearest intrinsic
// so that nvcc contracts nothing into an FMA: the result is the one that the
// same formula gives as separate fp32 torch ops. Each output is rounded once
// to its own dtype; the weight comes from the fp32 momentum, not the rounded
// one. Each tensor's w, g and state may each be fp32 or bf16 (Adam's mean
// and var share one dtype); the master is fp32.
//
// What bounds it on an H100: bytes (a handful of flops per element), and,
// for a step's many small tensors, launches. So:
// - One launch per list. The tensors' pointers, sizes, lr, wd and dtypes
//   travel as a table in the kernel's parameters (__grid_constant__, up to
//   kMaxTensors entries: no copy to the device, no allocation, no sync);
//   a longer list takes consecutive launches. Each tensor is cut into
//   chunks of kChunk elements and the table carries the running chunk
//   count. A persistent grid (the SMs times the blocks each holds) walks
//   the chunks; a block finds its tensor by a binary search over the
//   running counts and branches once on its dtypes, uniformly, so no warp
//   diverges. Small tensors (ResNet-50's BatchNorm vectors) are one chunk
//   each and leave no tail.
// - 16-byte accesses for every dtype: a thread holds two runs of 8
//   elements (any bf16 stream: one 16-byte access per bf16 run, two per
//   fp32 run) or, when all the tensor's streams are fp32, four runs of 4,
//   so every stream has at least two 16-byte accesses in flight per
//   thread. g and the lr/wd vectors are read through the non-coherent
//   path, everything else is read and written with the streaming hint
//   (each byte is touched once). Alignment is decided per tensor: a tensor
//   whose pointers are not all 16-byte aligned takes scalar accesses,
//   alone; the ragged end of a tensor takes scalar accesses too.
// - Registers set how many blocks an SM holds, and so how many accesses
//   are in flight: per-element lr/wd (two more streams held in registers)
//   is a kernel of its own, so the scalar lr/wd kernels keep their blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { MOMENTUM = 1, CLIP = 2, MP = 4, VEC_LRWD = 8 };

constexpr int kThreads = 256;
constexpr int kChunk = 8192;        // elements; a multiple of every tile
constexpr int kMaxTensors = 320;    // table entries a launch carries
constexpr int kMaxDevices = 64;

// One tensor as the caller packs it (ops/fused_optimizer.py, _ENTRY).
struct HostEntry {
  void* w;
  const void* g;
  void* s0;           // momentum, or Adam's mean
  void* s1;           // Adam's var
  float* master;      // fp32 master (MP), else null
  long long n;
  float lr, wd;
  int w_dtype, g_dtype, s_dtype, pad;
};

// One tensor as the kernel reads it: 64 bytes.
struct Entry {
  void* w;
  const void* g;
  void* s0;
  void* s1;
  float* master;
  long long n;
  int first_chunk;    // chunks of the tensors before this one
  float lr, wd;
  int kind;           // w/g/state dtypes (w * 4 + g * 2 + s) | kAligned
};
constexpr int kAligned = 8;

// The launch's scalars: b1 is SGD's momentum or Adam's beta1.
struct Head {
  const float* lrv;
  const float* wdv;
  float b1, omb1, b2, omb2, eps, rescale, clip;
  int flags, count, n_chunks;
};

template <int CAP>
struct Table {
  Head h;
  Entry e[CAP];
};

template <typename A, typename B>
struct same { static constexpr bool value = false; };
template <typename A>
struct same<A, A> { static constexpr bool value = true; };

// ---- element access --------------------------------------------------------
__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void unpack8(const uint4& t, float* v) {
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// RUN elements from p (16-byte aligned) into v: streaming (NC false) or
// through the non-coherent path (NC true)
template <int RUN, bool NC>
__device__ __forceinline__ void ld_run(const float* p, float* v) {
#pragma unroll
  for (int j = 0; j < RUN; j += 4) {
    const float4* q = reinterpret_cast<const float4*>(p + j);
    const float4 t = NC ? __ldg(q) : __ldcs(q);
    v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
  }
}
template <int RUN, bool NC>
__device__ __forceinline__ void ld_run(const bf16* p, float* v) {
  static_assert(RUN % 8 == 0, "a bf16 run is whole 16-byte accesses");
#pragma unroll
  for (int j = 0; j < RUN; j += 8) {
    const uint4* q = reinterpret_cast<const uint4*>(p + j);
    unpack8(NC ? __ldg(q) : __ldcs(q), v + j);
  }
}
template <int RUN>
__device__ __forceinline__ void st_run(float* p, const float* v) {
#pragma unroll
  for (int j = 0; j < RUN; j += 4)
    __stcs(reinterpret_cast<float4*>(p + j),
           make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
}
template <int RUN>
__device__ __forceinline__ void st_run(bf16* p, const float* v) {
  static_assert(RUN % 8 == 0, "a bf16 run is whole 16-byte accesses");
#pragma unroll
  for (int j = 0; j < RUN; j += 8) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[j + 2 * k],
                                                     v[j + 2 * k + 1]);
      u[k] = *reinterpret_cast<const uint32_t*>(&b);
    }
    __stcs(reinterpret_cast<uint4*>(p + j), make_uint4(u[0], u[1], u[2], u[3]));
  }
}

// ---- arithmetic (one element) ----------------------------------------------
// clamp into [-c, c]; a NaN stays NaN, as torch.clamp and jnp.clip keep it
__device__ __forceinline__ float clip(float v, float c) {
  return v < -c ? -c : (v > c ? c : v);
}

// g32 = clip(g * rescale) + wd * w32
__device__ __forceinline__ float prep(float g, float w32, float rescale,
                                      float c, bool clip_on, float wd) {
  float g32 = __fmul_rn(g, rescale);
  if (clip_on) g32 = clip(g32, c);
  return __fadd_rn(g32, __fmul_rn(wd, w32));
}

__device__ __forceinline__ void sgd_step(float& w32, float g, float& m,
                                         float lr, float wd, const Head& h,
                                         bool mom_on, bool clip_on) {
  const float g32 = prep(g, w32, h.rescale, h.clip, clip_on, wd);
  if (mom_on) {
    m = __fsub_rn(__fmul_rn(m, h.b1), __fmul_rn(lr, g32));
    w32 = __fadd_rn(w32, m);
  } else {
    w32 = __fsub_rn(w32, __fmul_rn(lr, g32));
  }
}

__device__ __forceinline__ void adam_step(float& w32, float g, float& m,
                                          float& v, float lr, float wd,
                                          const Head& h, bool clip_on) {
  const float g32 = prep(g, w32, h.rescale, h.clip, clip_on, wd);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g32));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g32), g32));
  const float step =
      __fdiv_rn(__fmul_rn(lr, m), __fadd_rn(__fsqrt_rn(v), h.eps));
  w32 = __fsub_rn(w32, step);
}

// ---- one tensor's elements [start, end) ------------------------------------
// A tile is kThreads threads x RUNS runs of RUN elements (4096 elements);
// thread t's run r starts at tile + r * kThreads * RUN + t * RUN, so each
// 16-byte access of a warp is contiguous across its lanes. VLR: per-element
// lr/wd (a one-tensor launch only).
template <typename TW, typename TG, typename TS, bool ADAM, bool VLR>
__device__ __forceinline__ void update_range(const Head& h, const Entry& e,
                                             int64_t start, int64_t end) {
  constexpr bool kF32 = same<TW, float>::value && same<TG, float>::value &&
                        same<TS, float>::value;
  constexpr int RUN = kF32 ? 4 : 8;
  constexpr int RUNS = kF32 ? 4 : 2;
  constexpr int E = RUN * RUNS;
  constexpr int STRIDE = kThreads * RUN;
  constexpr int TILE = STRIDE * RUNS;
  static_assert(kChunk % TILE == 0, "a chunk is whole tiles");
  TW* __restrict__ w = static_cast<TW*>(e.w);
  const TG* __restrict__ g = static_cast<const TG*>(e.g);
  TS* __restrict__ s0 = static_cast<TS*>(e.s0);
  TS* __restrict__ s1 = static_cast<TS*>(e.s1);
  float* __restrict__ master = e.master;
  constexpr bool vlr = VLR;
  const bool mp = h.flags & MP, clip_on = h.flags & CLIP;
  const float elr = e.lr, ewd = e.wd;
  const bool st0 = ADAM || (h.flags & MOMENTUM);
  const bool vec = e.kind & kAligned;
  for (int64_t base = start; base < end; base += TILE) {
    float wv[E], gv[E], av[E], bv[E], lr[E], wd[E];
    const int64_t i0 = base + (int64_t)threadIdx.x * RUN;
    if (vec && base + TILE <= end) {
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        const int64_t i = i0 + r * STRIDE;
        if (mp) ld_run<RUN, false>(master + i, wv + r * RUN);
        else ld_run<RUN, false>(w + i, wv + r * RUN);
        ld_run<RUN, true>(g + i, gv + r * RUN);
        if (st0) ld_run<RUN, false>(s0 + i, av + r * RUN);
        if (ADAM) ld_run<RUN, false>(s1 + i, bv + r * RUN);
        if (vlr) {
          ld_run<RUN, true>(h.lrv + i, lr + r * RUN);
          ld_run<RUN, true>(h.wdv + i, wd + r * RUN);
        }
      }
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float l = vlr ? lr[k] : elr, d = vlr ? wd[k] : ewd;
        if (ADAM) adam_step(wv[k], gv[k], av[k], bv[k], l, d, h, clip_on);
        else sgd_step(wv[k], gv[k], av[k], l, d, h, st0, clip_on);
      }
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        const int64_t i = i0 + r * STRIDE;
        st_run<RUN>(w + i, wv + r * RUN);
        if (st0) st_run<RUN>(s0 + i, av + r * RUN);
        if (ADAM) st_run<RUN>(s1 + i, bv + r * RUN);
        if (mp) st_run<RUN>(master + i, wv + r * RUN);
      }
    } else {
      // the ragged end, or a tensor with a pointer off 16 bytes: one
      // element at a time, in the same places
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int64_t i = i0 + (k / RUN) * STRIDE + k % RUN;
        if (i >= end) continue;
        wv[k] = mp ? master[i] : ld(w, i);
        gv[k] = ld(g, i);
        if (st0) av[k] = ld(s0, i);
        if (ADAM) bv[k] = ld(s1, i);
        const float l = vlr ? h.lrv[i] : elr, d = vlr ? h.wdv[i] : ewd;
        if (ADAM) adam_step(wv[k], gv[k], av[k], bv[k], l, d, h, clip_on);
        else sgd_step(wv[k], gv[k], av[k], l, d, h, st0, clip_on);
        st(w, i, wv[k]);
        if (st0) st(s0, i, av[k]);
        if (ADAM) st(s1, i, bv[k]);
        if (mp) master[i] = wv[k];
      }
    }
  }
}

template <int CAP, bool ADAM, bool V>
__device__ __forceinline__ void walk_chunks(const Table<CAP>& t) {
  for (int c = blockIdx.x; c < t.h.n_chunks; c += gridDim.x) {
    // the last tensor whose first chunk is at or before c
    int lo = 0, hi = t.h.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.e[mid].first_chunk <= c) lo = mid; else hi = mid - 1;
    }
    const Entry& e = t.e[lo];
    const int64_t start = (int64_t)(c - e.first_chunk) * kChunk;
    const int64_t end = e.n - start < kChunk ? e.n : start + kChunk;
    switch (e.kind & 7) {     // uniform across the block
      case 0:
        update_range<float, float, float, ADAM, V>(t.h, e, start, end);
        break;
      case 1:
        update_range<float, float, bf16, ADAM, V>(t.h, e, start, end);
        break;
      case 2:
        update_range<float, bf16, float, ADAM, V>(t.h, e, start, end);
        break;
      case 3:
        update_range<float, bf16, bf16, ADAM, V>(t.h, e, start, end);
        break;
      case 4:
        update_range<bf16, float, float, ADAM, V>(t.h, e, start, end);
        break;
      case 5:
        update_range<bf16, float, bf16, ADAM, V>(t.h, e, start, end);
        break;
      case 6:
        update_range<bf16, bf16, float, ADAM, V>(t.h, e, start, end);
        break;
      default:
        update_range<bf16, bf16, bf16, ADAM, V>(t.h, e, start, end);
        break;
    }
  }
}

// V: per-element lr/wd (a one-tensor table only), a kernel of its own.
template <int CAP, bool V>
__global__ void __launch_bounds__(kThreads)
    flat_sgd_kernel(const __grid_constant__ Table<CAP> t) {
  walk_chunks<CAP, false, V>(t);
}

template <int CAP, bool V>
__global__ void __launch_bounds__(kThreads)
    flat_adam_kernel(const __grid_constant__ Table<CAP> t) {
  walk_chunks<CAP, true, V>(t);
}

// each device's persistent grid (the SMs times the blocks each holds) for
// the 6 kernels: (a list, one tensor, one tensor with per-element lr/wd)
// x (SGD, Adam)
int& resident(int dev, int which) {
  static int cache[kMaxDevices][6];
  return cache[dev][which];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool valid(int d) { return d == 0 || d == 1; }

template <int CAP, bool ADAM, bool V>
int launch(const HostEntry* in, int count, Head h, cudaStream_t s) {
  static_assert(sizeof(Table<CAP>) <= 32764,
                "the table must fit in a kernel's parameters");
  if (count < 1 || count > CAP) return (int)cudaErrorInvalidValue;
  Table<CAP> t;
  memset(&t, 0, sizeof(t));
  int chunks = 0;
  for (int i = 0; i < count; ++i) {
    const HostEntry& a = in[i];
    if (!valid(a.w_dtype) || !valid(a.g_dtype) || !valid(a.s_dtype) ||
        a.n <= 0 || a.w == nullptr || a.g == nullptr)
      return (int)cudaErrorInvalidValue;
    const long long nc = (a.n + kChunk - 1) / kChunk;
    if (chunks + nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    bool al = aligned16(a.w) && aligned16(a.g) && aligned16(a.s0) &&
              aligned16(a.s1) && aligned16(a.master);
    if (h.flags & VEC_LRWD) al = al && aligned16(h.lrv) && aligned16(h.wdv);
    t.e[i] = Entry{a.w, a.g, a.s0, a.s1, a.master, a.n, chunks, a.lr, a.wd,
                   (a.w_dtype * 4 + a.g_dtype * 2 + a.s_dtype) |
                       (al ? kAligned : 0)};
    chunks += (int)nc;
  }
  h.count = count;
  h.n_chunks = chunks;
  t.h = h;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  void (*kernel)(Table<CAP>) =
      ADAM ? flat_adam_kernel<CAP, V> : flat_sgd_kernel<CAP, V>;
  int& grid = resident(dev, (CAP > 1 ? 0 : V ? 4 : 2) + ADAM);
  if (grid == 0) {
    int sms = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    grid = sms * (occ > 0 ? occ : 1);
  }
  kernel<<<chunks < grid ? chunks : grid, kThreads, 0, s>>>(t);
  return (int)cudaGetLastError();
}

template <bool ADAM>
int dispatch(const void* entries, int count, const Head& h, void* stream) {
  const HostEntry* in = static_cast<const HostEntry*>(entries);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h.flags & VEC_LRWD) {
    // per-element lr/wd: one tensor, both vectors given
    if (count != 1 || h.lrv == nullptr || h.wdv == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch<1, ADAM, true>(in, count, h, s);
  }
  if (count == 1) return launch<1, ADAM, false>(in, count, h, s);
  return launch<kMaxTensors, ADAM, false>(in, count, h, s);
}

}  // namespace

extern "C" {

// Entries one launch takes; a longer list is the caller's to split.
int mx_multi_capacity(void) { return kMaxTensors; }

// In place over `count` tensors (HostEntry each: w, g, mom (state dtype;
// null without MOMENTUM), unused, master fp32 (MP) or null, n, lr, wd,
// w/g/state dtypes 0 = fp32, 1 = bf16). flags: 1 momentum, 2 clip, 4 mp,
// 8 per-element lr/wd (lr_vec/wd_vec fp32 (n,), one tensor only; the
// entries' lr/wd are then unused). One launch on `stream`; returns its
// cudaError_t.
int mx_multi_sgd(const void* entries, int count, const void* lr_vec,
                 const void* wd_vec, float momentum, float rescale,
                 float clip_value, int flags, void* stream) {
  const Head h{static_cast<const float*>(lr_vec),
               static_cast<const float*>(wd_vec), momentum, 0.f, 0.f, 0.f,
               0.f, rescale, clip_value, flags, 0, 0};
  return dispatch<false>(entries, count, h, stream);
}

// As mx_multi_sgd, with each entry's s0 the mean and s1 the var (one
// dtype); omb1 = 1 - beta1 and omb2 = 1 - beta2 as the caller computed
// them (in double on the per-parameter route and in FusedTrainStep, in
// fp32 on Trainer's aggregated route, as each reference route does).
int mx_multi_adam(const void* entries, int count, const void* lr_vec,
                  const void* wd_vec, float beta1, float omb1, float beta2,
                  float omb2, float eps, float rescale, float clip_value,
                  int flags, void* stream) {
  const Head h{static_cast<const float*>(lr_vec),
               static_cast<const float*>(wd_vec), beta1, omb1, beta2, omb2,
               eps, rescale, clip_value, flags, 0, 0};
  return dispatch<true>(entries, count, h, stream);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
