// Dense scatter-add of sparse rows for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/sparse_ops.py::_kernel_segment_sum
// (launched by _segment_sum_pallas_impl). Given (nnz, D) value rows and
// their (nnz,) row ids it computes
//   out = zeros((num_segments, D));  out[ids[j]] += values[j]
// for every j in occurrence order. Rows whose id is negative (padding) or
// not below num_segments are dropped. Each add is made in the output dtype,
// as the Pallas body stores cur + upd per row: the sum is rounded to fp32,
// bf16 or fp16 after every add.
//
// The TPU kernel keeps the whole destination slab in VMEM and walks the
// rows one at a time. Here the work is split in two launches behind one C
// entry, with the permutation that a stable sort of the ids gives (taken by
// the caller):
//   1. fill: the (num_segments, D) output is zeroed, 16 bytes a store. At
//      the main shapes this is most of the bytes (1,000,001 x 64 fp32 is
//      256 MB, the largest Criteo Kaggle table 648 MB).
//   2. ordered sums: one warp for each position of the sorted ids. The warp
//      at the first position of a run of equal ids (all others leave at
//      once) sums that run's rows in sorted order, a lane per column, and
//      writes the row once. The sort is stable, so sorted order is
//      occurrence order, and the sums need no atomics: the same on every
//      run, and bit-equal to adding the rows one by one in order.
// What bounds it on an H100: bytes (one add per value element). The fill
// writes every output byte; the sums read each value row once and write
// each touched row once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

// Zero n_bytes at p: 16-byte stores over the aligned body, bytes at the
// ragged ends. Grid-stride.
__global__ void fill_zero(unsigned char* p, int64_t n_bytes) {
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  int64_t head = (int64_t)((16 - (addr & 15)) & 15);
  if (head > n_bytes) head = n_bytes;
  const int64_t n_vec = (n_bytes - head) / 16;
  const int64_t tail = head + n_vec * 16;
  uint4* body = reinterpret_cast<uint4*>(p + head);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = tid; i < n_vec; i += stride) body[i] = z;
  for (int64_t i = tid; i < head; i += stride) p[i] = 0;
  for (int64_t i = tail + tid; i < n_bytes; i += stride) p[i] = 0;
}

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
cudaError_t launch(const void* values, const int32_t* sorted_ids,
                   const int64_t* perm, void* out, int64_t nnz, int64_t dim,
                   int64_t num_segments, cudaStream_t stream) {
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

// out (num_segments, dim) of dtype (0 fp32, 1 bf16, 2 fp16) = the ordered
// segment sums of values (nnz, dim) of the same dtype, with sorted_ids the
// stably sorted int32 ids and perm (int64) the sorting permutation. Two
// launches on `stream` (fill, sums); returns the first cudaError_t.
int mx_segment_sum(const void* values, const void* sorted_ids,
                   const void* perm, void* out, long long nnz, long long dim,
                   long long num_segments, int dtype, void* stream) {
  const int32_t* ids = static_cast<const int32_t*>(sorted_ids);
  const int64_t* p = static_cast<const int64_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(values, ids, p, out, nnz, dim, num_segments,
                                s); break;
    case 1: err = launch<bf16>(values, ids, p, out, nnz, dim, num_segments,
                               s); break;
    case 2: err = launch<__half>(values, ids, p, out, nnz, dim, num_segments,
                                 s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
