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
// plain PyTorch version computes them, so both take the same mask.
//
// Design. On the TPU one pallas_call walked the grid (channel block, phase,
// image) in order and carried the two sums in VMEM scratch from phase 0 to
// phase 1. Hopper runs blocks in no order, so the one C entry makes three
// launches:
//   (a) cbr_bwd_partial_kernel: blocks over (256-row chunk x 32-channel
//       chunk); threads run along the contiguous channel dimension (so loads
//       coalesce) and 8 row lanes; each block writes its fp32 partial sums
//       of g and g * xhat to a scratch (n_chunks, 2, Cout);
//   (b) bwd_col_sum_kernel: sums the partials over the chunks in a fixed order
//       (no atomics: the same inputs give the same sums on every run);
//   (c) cbr_bwd_dconv_kernel: one elementwise pass for dconv and dres.
// What bounds it on an H100: bytes. conv and dy are read twice (once for the
// sums, once for dconv; the second pass needs the finished sums, as phase 1
// did on the TPU), dconv is written in fp32 and dres in the residual's type;
// at ResNet-50's stage 1 at batch 256 that is about 0.6 GB, ~0.2 ms at 3.35
// TB/s. The passes are plain loads and stores (no vectorized loads yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CHUNK_ROWS = 256;   // rows per block of the partial pass
constexpr int COLS = 32;          // channels per block of the partial pass
constexpr int ROW_LANES = 8;      // row lanes per block of the partial pass

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

// xhat and the pre-ReLU value y, rounded after every operation
template <typename TR>
__device__ __forceinline__ void recompute(float conv, float mean, float inv,
                                          float gam, float bet,
                                          const TR* res, size_t o,
                                          float& xhat, float& y) {
  xhat = __fmul_rn(__fsub_rn(conv, mean), inv);
  y = __fadd_rn(__fmul_rn(xhat, gam), bet);
  if (res != nullptr) y = __fadd_rn(y, to_f(res[o]));
}

template <typename T, typename TR>
__global__ void __launch_bounds__(COLS * ROW_LANES)
    cbr_bwd_partial_kernel(const T* __restrict__ conv, const T* __restrict__ dy,
                           const float* __restrict__ mean,
                           const float* __restrict__ invstd,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const TR* __restrict__ res,
                           float* __restrict__ partial, int M, int Cout) {
  __shared__ float sG[ROW_LANES][COLS], sGX[ROW_LANES][COLS];
  const int c = blockIdx.y * COLS + threadIdx.x;
  const int r0 = blockIdx.x * CHUNK_ROWS;
  const int r1 = min(M, r0 + CHUNK_ROWS);
  float sg = 0.f, sgx = 0.f;
  if (c < Cout) {
    const float mu = mean[c], inv = invstd[c], gam = gamma[c], bet = beta[c];
    for (int r = r0 + threadIdx.y; r < r1; r += ROW_LANES) {
      const size_t o = (size_t)r * Cout + c;
      float xhat, y;
      recompute(to_f(conv[o]), mu, inv, gam, bet, res, o, xhat, y);
      const float g = y > 0.f ? to_f(dy[o]) : 0.f;
      sg += g;
      sgx += g * xhat;
    }
  }
  sG[threadIdx.y][threadIdx.x] = sg;
  sGX[threadIdx.y][threadIdx.x] = sgx;
  __syncthreads();
  if (threadIdx.y == 0 && c < Cout) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < ROW_LANES; ++l) {
      a += sG[l][threadIdx.x];
      b += sGX[l][threadIdx.x];
    }
    float* p = partial + (size_t)blockIdx.x * 2 * Cout + c;
    p[0] = a;       // -> dbeta
    p[Cout] = b;    // -> dgamma
  }
}

// sums[c] = sum over t of partial[t][c] for c < cols, t in a fixed order
__global__ void __launch_bounds__(1024)
    bwd_col_sum_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                   int tiles, int cols) {
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

template <typename T, typename TR>
__global__ void __launch_bounds__(256)
    cbr_bwd_dconv_kernel(const T* __restrict__ conv, const T* __restrict__ dy,
                         const float* __restrict__ mean,
                         const float* __restrict__ invstd,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const TR* __restrict__ res,
                         const float* __restrict__ sums,
                         float* __restrict__ dconv, TR* __restrict__ dres,
                         size_t total, int Cout, float m) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += stride) {
    const int c = (int)(o % Cout);
    const float inv = invstd[c], gam = gamma[c];
    float xhat, y;
    recompute(to_f(conv[o]), mean[c], inv, gam, beta[c], res, o, xhat, y);
    const float g = y > 0.f ? to_f(dy[o]) : 0.f;
    const float mean_dxhat = gam * (sums[c] / m);
    const float mean_dxhat_xhat = gam * (sums[Cout + c] / m);
    dconv[o] = inv * (g * gam - mean_dxhat - xhat * mean_dxhat_xhat);
    if (dres != nullptr) dres[o] = from_f<TR>(g);
  }
}

template <typename T, typename TR>
int launch(const void* conv, const void* dy, const float* mean,
           const float* invstd, const float* gamma, const float* beta,
           const void* res, void* partial, float* sums, void* dconv,
           void* dres, int M, int Cout, cudaStream_t s) {
  const int chunks = (M + CHUNK_ROWS - 1) / CHUNK_ROWS;
  float* part = static_cast<float*>(partial);
  cbr_bwd_partial_kernel<T, TR>
      <<<dim3(chunks, (Cout + COLS - 1) / COLS), dim3(COLS, ROW_LANES), 0,
         s>>>(static_cast<const T*>(conv), static_cast<const T*>(dy), mean,
              invstd, gamma, beta, static_cast<const TR*>(res), part, M, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = 2 * Cout;
  bwd_col_sum_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, s>>>(part, sums, chunks,
                                                           cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)M * Cout;
  const int blocks = (int)((total + 255) / 256 < 132 * 16
                               ? (total + 255) / 256 : 132 * 16);
  cbr_bwd_dconv_kernel<T, TR><<<blocks, 256, 0, s>>>(
      static_cast<const T*>(conv), static_cast<const T*>(dy), mean, invstd,
      gamma, beta, static_cast<const TR*>(res), sums,
      static_cast<float*>(dconv), static_cast<TR*>(dres), total, Cout,
      (float)M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// conv and dy (M, Cout) in one dtype (0 = fp32, 1 = bf16); mean, invstd,
// gamma, beta (Cout,) fp32; residual and dres (M, Cout) in res_dtype, both
// null without a residual; dconv (M, Cout) fp32; sums (2, Cout) fp32 out:
// dbeta then dgamma; partial fp32 scratch of ceil(M / 256) * 2 * Cout
// elements. Three launches on `stream`; returns the first launch error.
int mx_cbr_train_bwd(const void* conv, const void* dy, const void* mean,
                     const void* invstd, const void* gamma, const void* beta,
                     const void* residual, void* partial, void* sums,
                     void* dconv, void* dres, int M, int Cout, int dtype,
                     int res_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* inv = static_cast<const float*>(invstd);
  const float* gam = static_cast<const float*>(gamma);
  const float* bet = static_cast<const float*>(beta);
  float* sm = static_cast<float*>(sums);
  const bool res_bf16 = residual != nullptr && res_dtype == 1;
  if (dtype == 1) {
    if (res_bf16)
      return launch<bf16, bf16>(conv, dy, mu, inv, gam, bet, residual,
                                partial, sm, dconv, dres, M, Cout, s);
    return launch<bf16, float>(conv, dy, mu, inv, gam, bet, residual,
                               partial, sm, dconv, dres, M, Cout, s);
  }
  if (dtype == 0) {
    if (res_bf16)
      return launch<float, bf16>(conv, dy, mu, inv, gam, bet, residual,
                                 partial, sm, dconv, dres, M, Cout, s);
    return launch<float, float>(conv, dy, mu, inv, gam, bet, residual,
                                partial, sm, dconv, dres, M, Cout, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
