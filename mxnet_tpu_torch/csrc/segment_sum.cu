// Dense scatter-add of sparse rows for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/sparse_ops.py::_kernel_segment_sum
// (launched by _segment_sum_pallas_impl). Given (nnz, D) value rows and
// their (nnz,) row ids it computes
//   out = zeros((num_segments, D));  out[ids[j]] += values[j]
// for every j in occurrence order. Rows whose id is negative (padding) or
// not below num_segments are dropped. Each add is made in the output dtype,
// as the Pallas body stores cur + upd per row: the sum is rounded to fp32,
// bf16 or fp16 after every add. No atomics: the sums are the same on every
// run and bit-equal to adding the rows one by one in order.
//
// What bounds it on an H100: bytes, and nearly all of them are the zero
// fill of the output (1,000,001 x 64 fp32 is 256 MB, the largest Criteo
// Kaggle table 648 MB), against a few MB of value rows.
//
// Design. The TPU kernel keeps the whole destination slab in VMEM and walks
// the rows one at a time. Here two routes, picked by the caller before the
// launch (ops.sparse_ops.segment_sum_plan):
//
//  fused (nnz <= 16384): one cooperative launch, every block resident (as
//    many as the card holds, or fewer for a small output).
//    Phase A: one block for each 1024 ids reads them (int32 or int64; ids
//    out of range become -1 here) and checks whether they are
//    non-decreasing. They are on every main path (the dedup's run numbers,
//    the embedding update's ascending unique ids), and then nothing more is
//    made. Otherwise each of these blocks sorts its chunk's (id + 1) << 32
//    | position keys in shared memory (a bitonic sort of distinct keys, so
//    stable), and, after a barrier among them, ranks its keys in the other
//    sorted chunks (binary search) and writes the sorted ids and an int32
//    permutation to a scratch. (One block sorting all 8192 ids of a push
//    took longer than the fill on an H100; 8 blocks of 1024 hide under it.)
//    Every other block meanwhile zeroes the output with 16-byte stores.
//    A grid barrier.
//    Phase B: a group of lanes sized to the row owns each run of equal ids:
//    the group at a run's first position adds the run's rows in order, 16
//    bytes a lane where the row's width and alignment allow, and writes the
//    row once. The sort's cost and the sums hide behind the fill, so the
//    launch takes about the fill's time.
//  presorted (larger nnz): the caller sorts the int32 ids stably
//    (torch.sort) and passes the permutation; a fill launch, then one warp
//    for each sorted position, the one at a run's start summing the run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxDevices = 64;
constexpr int FUSED_THREADS = 512;
constexpr int SORT_CHUNK = 1024;    // ids a sorting block sorts
constexpr int MAX_SORT_BLOCKS = 16;
constexpr int64_t FILL_BLOCK_BYTES = 256 << 10;   // output a block zeroes

__device__ __forceinline__ float add_rn(float acc, float v) {
  return __fadd_rn(acc, v);
}
__device__ __forceinline__ bf16 add_rn(bf16 acc, bf16 v) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(acc), __bfloat162float(v)));
}
__device__ __forceinline__ __half add_rn(__half acc, __half v) {
  return __float2half_rn(__fadd_rn(__half2float(acc), __half2float(v)));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16_rn(0.0f);
}
template <> __device__ __forceinline__ __half zero<__half>() {
  return __float2half_rn(0.0f);
}

// Zero bytes [0, n_bytes) of p, part `part` of `parts` (grid-stride over
// parts * blockDim.x threads): 16-byte stores over the aligned body, bytes
// at the ragged ends.
__device__ __forceinline__ void zero_part(unsigned char* p, int64_t n_bytes,
                                          int64_t part, int64_t parts) {
  const int64_t tid = part * blockDim.x + threadIdx.x;
  const int64_t stride = parts * blockDim.x;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  int64_t head = (int64_t)((16 - (addr & 15)) & 15);
  if (head > n_bytes) head = n_bytes;
  const int64_t n_vec = (n_bytes - head) / 16;
  const int64_t tail = head + n_vec * 16;
  uint4* body = reinterpret_cast<uint4*>(p + head);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
  for (int64_t i = tid; i < n_vec; i += stride) body[i] = z;
  for (int64_t i = tid; i < head; i += stride) p[i] = 0;
  for (int64_t i = tail + tid; i < n_bytes; i += stride) p[i] = 0;
}

__global__ void fill_zero(unsigned char* p, int64_t n_bytes) {
  zero_part(p, n_bytes, blockIdx.x, gridDim.x);
}

// ------------------------------------------------------------------ fused
template <typename TI>
__device__ __forceinline__ int32_t kept(TI id, int64_t num_segments) {
  return (id >= 0 && (int64_t)id < num_segments) ? (int32_t)id : -1;
}

// V values of T from p (16 bytes when V > 1) added into acc, each add
// rounded
template <typename T, int V>
__device__ __forceinline__ void add_row(T (&acc)[V], const T* p) {
  if constexpr (V == 1) {
    acc[0] = add_rn(acc[0], p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "16-byte vectors");
    alignas(16) T x[V];
    *reinterpret_cast<uint4*>(x) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = add_rn(acc[e], x[e]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* p, const T (&acc)[V]) {
  if constexpr (V == 1) {
    p[0] = acc[0];
  } else {
    alignas(16) T x[V];
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = acc[e];
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(x);
  }
}

// Sort keys[0, n) ascending in shared memory, n a power of two, all
// threads of the block taking part.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        // the p-th pair (i, i + j): insert a zero bit at j's position
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const unsigned long long a = keys[i], b = keys[i + j];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Rank of `key` among the sorted keys a[0, SORT_CHUNK): how many are less
__device__ __forceinline__ int rank_in(const unsigned long long* a,
                                       unsigned long long key) {
  int pos = 0;
  for (int step = SORT_CHUNK; step > 0; step >>= 1)
    if (pos + step <= SORT_CHUNK && a[pos + step - 1] < key) pos += step;
  return pos;
}

// One cooperative launch. Phase A: blocks 0 .. n_sort - 1 (one for each
// SORT_CHUNK ids) check their ids' order; if any chunk is out of order,
// each sorts its chunk's (id + 1) << 32 | position keys in shared memory,
// then places each key at its rank among all chunks' keys (its position
// in its chunk plus its rank in each other sorted chunk: the keys are
// distinct), writing the sorted ids and the permutation. The other blocks
// zero the output. A grid barrier. Phase B: ordered run sums. scratch:
// n_sort * SORT_CHUNK 8-byte keys, then nnz int32 sorted ids and nnz
// int32 positions; bar: the grid barrier's two words, the order flag, the
// sorting blocks' barrier's two words, then one flag a chunk. V values of
// T a lane; `lanes` lanes a row group (a power of two, at most 32).
template <typename T, typename TI, int V>
__global__ void __launch_bounds__(FUSED_THREADS)
    segment_sum_fused(const T* __restrict__ values,
                      const TI* __restrict__ ids, T* __restrict__ out,
                      unsigned long long* scratch, unsigned int* bar,
                      int nnz, int dim, int64_t num_segments, int lanes) {
  extern __shared__ unsigned long long keys[];
  const unsigned int nblocks = gridDim.x;
  const int n_sort = nnz > SORT_CHUNK ? (nnz + SORT_CHUNK - 1) / SORT_CHUNK
                                      : 1;
  const int n_keys = n_sort * SORT_CHUNK;
  int32_t* sorted_ids = reinterpret_cast<int32_t*>(scratch + n_keys);
  int32_t* perm = sorted_ids + nnz;
  if ((int)blockIdx.x < n_sort) {
    const int c = blockIdx.x, lo = c * SORT_CHUNK;
    const int hi = nnz < lo + SORT_CHUNK ? nnz : lo + SORT_CHUNK;
    int unordered = 0;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
      unordered |= i > 0 && kept(ids[i], num_segments) <
                                kept(ids[i - 1], num_segments);
    unordered = __syncthreads_or(unordered);
    if (threadIdx.x == 0) bar[5 + c] = (unsigned int)unordered;
    hopper::grid_barrier(bar + 3, n_sort);
    unordered = 0;
    for (int d = 0; d < n_sort; ++d) unordered |= __ldcg(bar + 5 + d) != 0;
    if (unordered) {
      for (int i = threadIdx.x; i < SORT_CHUNK; i += blockDim.x)
        keys[i] = lo + i < hi
                      ? (unsigned long long)(uint32_t)(
                            kept(ids[lo + i], num_segments) + 1) << 32 |
                            (uint32_t)(lo + i)
                      : ~0ull;
      __syncthreads();
      bitonic_sort(keys, SORT_CHUNK);
      for (int i = threadIdx.x; i < SORT_CHUNK; i += blockDim.x)
        scratch[lo + i] = keys[i];
      hopper::grid_barrier(bar + 3, n_sort);
      for (int i = threadIdx.x; i < n_keys; i += blockDim.x)
        keys[i] = __ldcg(scratch + i);
      __syncthreads();
      for (int i = threadIdx.x; i < hi - lo; i += blockDim.x) {
        const unsigned long long key = keys[lo + i];
        int rank = i;
        for (int d = 0; d < n_sort; ++d)
          if (d != c) rank += rank_in(keys + d * SORT_CHUNK, key);
        sorted_ids[rank] = (int32_t)(key >> 32) - 1;
        perm[rank] = (int32_t)(key & 0xffffffffu);
      }
    }
    if (c == 0 && threadIdx.x == 0) bar[2] = (unsigned int)unordered;
  } else {
    zero_part(reinterpret_cast<unsigned char*>(out),
              num_segments * dim * (int64_t)sizeof(T), blockIdx.x - n_sort,
              nblocks - n_sort);
  }
  hopper::grid_barrier(bar, nblocks);

  const bool unordered = __ldcg(bar + 2) != 0;
  const int groups = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int cols = dim / V;
  for (int64_t j = (int64_t)blockIdx.x * groups + threadIdx.x / lanes;
       j < nnz; j += (int64_t)nblocks * groups) {
    const int32_t id = unordered ? __ldcg(sorted_ids + j)
                                 : kept(ids[j], num_segments);
    if (id < 0) continue;
    if (j > 0 && (unordered ? __ldcg(sorted_ids + j - 1)
                            : kept(ids[j - 1], num_segments)) == id)
      continue;                                    // not a run's start
    int64_t end = j + 1;
    while (end < nnz && (unordered ? __ldcg(sorted_ids + end)
                                   : kept(ids[end], num_segments)) == id)
      ++end;
    T* dst = out + (int64_t)id * dim;
    for (int c = lane; c < cols; c += lanes) {
      T acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = zero<T>();
      for (int64_t r = j; r < end; ++r) {
        const int64_t row = unordered ? __ldcg(perm + r) : r;
        add_row<T, V>(acc, values + row * dim + (int64_t)c * V);
      }
      store_row<T, V>(dst + (int64_t)c * V, acc);
    }
  }
}

template <typename T, typename TI, int V>
cudaError_t launch_fused(const void* values, const void* ids, void* out,
                         void* scratch, void* bar, int nnz, int dim,
                         int64_t num_segments, int lanes, int sort_keys,
                         cudaStream_t stream) {
  auto kernel = segment_sum_fused<T, TI, V>;
  const int n_sort = nnz > SORT_CHUNK ? (nnz + SORT_CHUNK - 1) / SORT_CHUNK
                                      : 1;
  if (n_sort > MAX_SORT_BLOCKS || sort_keys != n_sort * SORT_CHUNK)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)sort_keys * sizeof(unsigned long long);
  // per device: the multiprocessors, and the blocks a multiprocessor holds
  // at each count of sort chunks, read once (host time: these calls cost
  // more than the launch); the largest shared memory allowed up front
  static std::atomic<int> sms_of[kMaxDevices];
  static std::atomic<int> per_sm_of[kMaxDevices][MAX_SORT_BLOCKS + 1];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = sms_of[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SORT_BLOCKS * SORT_CHUNK * (int)sizeof(unsigned long long));
    if (err != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    sms_of[device].store(sms, std::memory_order_relaxed);
  }
  int per_sm = per_sm_of[device][n_sort].load(std::memory_order_relaxed);
  if (per_sm == 0) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, FUSED_THREADS, smem)) != cudaSuccess)
      return err;
    per_sm_of[device][n_sort].store(per_sm, std::memory_order_relaxed);
  }
  if (per_sm < 1 || sms * per_sm <= n_sort)
    return cudaErrorInvalidConfiguration;
  // the sorting blocks and a block for each FILL_BLOCK_BYTES of output, at
  // most what the card holds at once: a small table's launch has a few
  // blocks to start and to wait for at the barrier
  const int64_t fill =
      (num_segments * dim * (int64_t)sizeof(T) + FILL_BLOCK_BYTES - 1) /
      FILL_BLOCK_BYTES;
  int64_t grid = n_sort + (fill > 1 ? fill : 1);
  if (grid > (int64_t)sms * per_sm) grid = (int64_t)sms * per_sm;
  const T* v = static_cast<const T*>(values);
  const TI* i = static_cast<const TI*>(ids);
  T* o = static_cast<T*>(out);
  unsigned long long* s = static_cast<unsigned long long*>(scratch);
  unsigned int* b = static_cast<unsigned int*>(bar);
  void* args[] = {&v, &i, &o, &s, &b, &nnz, &dim, &num_segments, &lanes};
  return cudaLaunchCooperativeKernel((const void*)kernel,
                                     dim3((unsigned int)grid),
                                     dim3(FUSED_THREADS), args, smem, stream);
}

template <typename T>
cudaError_t fused_for(const void* values, const void* ids, int id_bytes,
                      void* out, void* scratch, void* bar, int nnz, int dim,
                      int64_t num_segments, int vec, int lanes,
                      int sort_keys, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  if (vec == V16) {
    if (id_bytes == 8)
      return launch_fused<T, int64_t, V16>(values, ids, out, scratch, bar,
                                           nnz, dim, num_segments, lanes,
                                           sort_keys, s);
    return launch_fused<T, int32_t, V16>(values, ids, out, scratch, bar,
                                         nnz, dim, num_segments, lanes,
                                         sort_keys, s);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  if (id_bytes == 8)
    return launch_fused<T, int64_t, 1>(values, ids, out, scratch, bar, nnz,
                                       dim, num_segments, lanes, sort_keys,
                                       s);
  return launch_fused<T, int32_t, 1>(values, ids, out, scratch, bar, nnz,
                                     dim, num_segments, lanes, sort_keys, s);
}

// -------------------------------------------------------------- presorted
// One warp per sorted position j. sorted_ids: the int32 ids in stable
// sorted order; perm[j]: the row of `values` at sorted position j.
template <typename T>
__global__ void ordered_sums(const T* __restrict__ values,
                             const int32_t* __restrict__ sorted_ids,
                             const int64_t* __restrict__ perm,
                             T* __restrict__ out, int64_t nnz, int64_t dim,
                             int64_t num_segments) {
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nnz) return;
  const int32_t id = sorted_ids[warp];
  if (id < 0 || (int64_t)id >= num_segments) return;
  if (warp > 0 && sorted_ids[warp - 1] == id) return;   // not a run start
  int64_t end = warp + 1;
  while (end < nnz && sorted_ids[end] == id) ++end;
  T* dst = out + (int64_t)id * dim;
  for (int64_t c = lane; c < dim; c += 32) {
    T acc = zero<T>();
    for (int64_t r = warp; r < end; ++r)
      acc = add_rn(acc, values[perm[r] * dim + c]);
    dst[c] = acc;
  }
}

int grid_for(int64_t threads, int block) {
  int64_t g = (threads + block - 1) / block;
  if (g < 1) g = 1;
  if (g > 2147483647LL) g = 2147483647LL;
  return (int)g;
}

template <typename T>
cudaError_t launch_presorted(const void* values, const int32_t* sorted_ids,
                             const int64_t* perm, void* out, int64_t nnz,
                             int64_t dim, int64_t num_segments,
                             cudaStream_t stream) {
  const int64_t n_bytes = num_segments * dim * (int64_t)sizeof(T);
  if (n_bytes > 0) {
    // enough blocks to fill the card several times over; grid-stride beyond
    int g = grid_for(n_bytes / 16 + 1, 256);
    if (g > 132 * 32) g = 132 * 32;
    fill_zero<<<g, 256, 0, stream>>>(static_cast<unsigned char*>(out),
                                     n_bytes);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (nnz > 0 && dim > 0 && num_segments > 0) {
    ordered_sums<T><<<grid_for(nnz * 32, 256), 256, 0, stream>>>(
        static_cast<const T*>(values), sorted_ids, perm,
        static_cast<T*>(out), nnz, dim, num_segments);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The fused route: out (num_segments, dim) of dtype (0 fp32, 1 bf16, 2
// fp16) = the ordered segment sums of values (nnz, dim) of the same dtype
// at ids (nnz,) of id_bytes 4 or 8, nnz at most 16 * 1024. sort_keys:
// nnz rounded up to a multiple of 1024 (at least 1024); scratch: sort_keys
// + nnz 8-byte words; bar: 5 + sort_keys / 1024 unsigned words, the first
// five zero (two grid barriers' words; they are zero again after the
// launch). vec values a lane (1, or 16 bytes' worth, with dim a multiple
// of it and values 16-byte aligned), lanes lanes a row (a power of two up
// to 32). One cooperative launch on `stream`; returns its cudaError_t.
int mx_segment_sum_fused(const void* values, const void* ids, int id_bytes,
                         void* out, void* scratch, void* bar, int nnz,
                         int dim, long long num_segments, int dtype, int vec,
                         int lanes, int sort_keys, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case 0: err = fused_for<float>(values, ids, id_bytes, out, scratch, bar,
                                   nnz, dim, num_segments, vec, lanes,
                                   sort_keys, s); break;
    case 1: err = fused_for<bf16>(values, ids, id_bytes, out, scratch, bar,
                                  nnz, dim, num_segments, vec, lanes,
                                  sort_keys, s); break;
    case 2: err = fused_for<__half>(values, ids, id_bytes, out, scratch, bar,
                                    nnz, dim, num_segments, vec, lanes,
                                    sort_keys, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The presorted route: the same sums with sorted_ids the stably sorted
// int32 ids and perm (int64) the sorting permutation. Two launches on
// `stream` (fill, sums); returns the first cudaError_t.
int mx_segment_sum(const void* values, const void* sorted_ids,
                   const void* perm, void* out, long long nnz, long long dim,
                   long long num_segments, int dtype, void* stream) {
  const int32_t* ids = static_cast<const int32_t*>(sorted_ids);
  const int64_t* p = static_cast<const int64_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_presorted<float>(values, ids, p, out, nnz, dim,
                                          num_segments, s); break;
    case 1: err = launch_presorted<bf16>(values, ids, p, out, nnz, dim,
                                         num_segments, s); break;
    case 2: err = launch_presorted<__half>(values, ids, p, out, nnz, dim,
                                           num_segments, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// cudaMemsetAsync(p, 0, n_bytes) on `stream`: the yardstick chip_smoke.py
// times the fill against. No route of the kernel calls it.
int mx_memset_zero(void* p, long long n_bytes, void* stream) {
  return static_cast<int>(cudaMemsetAsync(p, 0, (size_t)n_bytes,
                                          static_cast<cudaStream_t>(stream)));
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
