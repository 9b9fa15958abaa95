// Fused conv3x3 (stride 1, SAME) + folded BatchNorm + ReLU (+ residual) for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_conv.py::_kernel (launched by
// _pallas_conv_bn_relu). It computes the same function: x (N,H,W,C) NHWC,
// w (3,3,C,Cout) HWIO, out[n,h,w,co] = relu(sum_{dh,dw,ci} x[n,h+dh-1,w+dw-1,ci]
// * w[dh,dw,ci,co] * scale[co] + shift[co] (+ residual[n,h,w,co])), with the
// sum in fp32, the epilogue in fp32 and the result rounded once to x's type.
//
// Design. The TPU kernel takes one whole image per grid step and forms the
// conv as 9 rolled-and-masked (H*W, C) x (C, Cout-block) dots in VMEM. Here it
// is an implicit GEMM with M = N*H*W output pixels, N = Cout and K = 9*C: a
// block owns a 64-pixel x 64-channel output tile over the flattened N*H*W
// rows (ResNet's 7x7 stage would leave most of a one-image tile empty), and
// loops over the 9 taps and, within a tap, over C in chunks. The SAME border
// is zero-filled from bounds checks while a tile is staged, in place of the
// roll + mask. The accumulator stays in registers; the epilogue (scale,
// shift, residual, ReLU, rounding) runs on it before the one NHWC store, so
// the conv output never reaches device memory unnormalised. Every shape is
// taken: 16-byte vector loads where C (for x) or Cout (for w) is a multiple
// of 8, element loads with bounds otherwise; offsets are 64-bit.
//
// * bf16: mma.sync m16n8k16 (bf16 in, fp32 accumulate; bf16 x bf16 products
//   are exact in fp32, as the reference's upcast-then-dot). 4 warps in 2x2,
//   each a 32x32 warp tile. The A tile (pixels x channels) is staged
//   row-major; the HWIO weight is contiguous in Cout, so the B tile is
//   staged transposed ([cout][k]) to give the .col operand's k-pairs in one
//   32-bit word. Rows are padded by 16 bytes so fragment reads hit 32 banks.
// * fp32: FMA in full fp32 (TF32 would keep ~3 decimal digits); 256 threads,
//   each a 4x4 output micro-tile, both tiles staged k-major.
//
// What bounds it on an H100. At ResNet-50's stage shapes (batch 64) the work
// is 14.8 GFLOP for ~51 MB at stage 1, about 15 us either way; the later
// stages are operations bound. This version stages each tile with all threads
// and then computes (no cp.async/TMA pipeline, no wgmma), so it runs at the
// mma.sync issue rate with load latency exposed; those are later steps.
//
// Training variant (mx_conv_bn_stats). Replaces the TPU kernel
// mxnet_tpu/ops/fused_conv.py::_kernel_train (launched by _pallas_conv_stats):
// the same implicit GEMM (the kernels below are templated on STATS), whose
// epilogue writes the conv output rounded once to x's type, with no
// scale/shift/ReLU, and, from the fp32 accumulator (not the rounded output),
// each block's per-channel partial sum and sum of squares over its 64 rows
// into an fp32 scratch (n_mtiles, 2, Cout). Rows past M are masked. The TPU
// kernel carried one image per grid step and summed the partials on the host
// side of the call; here a second small launch (stats_col_sum_kernel) sums the
// partials over the tiles in a fixed order, so the statistics are the same on
// every run (no atomics). It adds one fp32 write and read of (n_mtiles, 2,
// Cout), 1/32 of the conv output's bytes in bf16 at Cout = 64; the GEMM
// still bounds it. The batch mean/variance and the normalize + ReLU pass are
// plain PyTorch in the wrapper, as they were plain XLA on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block

// ------------------------------------------------------------ bf16, mma.sync
constexpr int BK = 32;           // input channels per staged chunk
constexpr int LDS = BK + 8;      // smem row stride (elements), 80 bytes
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, column-major), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// row -> (n, h, w) of the block's output pixels; n = -1 past the last pixel
__device__ __forceinline__ void decode_rows(int* sN, int* sH, int* sW, int m0,
                                            int M, int H, int W) {
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const int p = m0 + r;
    if (p < M) {
      const int n = p / (H * W);
      const int rem = p - n * H * W;
      sN[r] = n;
      sH[r] = rem / W;
      sW[r] = rem - (rem / W) * W;
    } else {
      sN[r] = -1;
      sH[r] = 0;
      sW[r] = 0;
    }
  }
}

// STATS = false: the inference epilogue (scale, shift, residual, ReLU).
// STATS = true: the training epilogue (the conv output as is, and the
// block's per-channel partial sums into partial[blockIdx.x][2][Cout]).
template <bool STATS>
__global__ void __launch_bounds__(MMA_THREADS)
    cbr_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const bf16* __restrict__ res, bf16* __restrict__ out,
                   float* __restrict__ partial, int M, int H, int W, int C,
                   int Cout) {
  __shared__ __align__(16) bf16 sA[BM * LDS];   // [pixel][k]
  __shared__ __align__(16) bf16 sB[BN * LDS];   // [cout][k]
  __shared__ int sN[BM], sH[BM], sW[BM];
  __shared__ float sStat[2][2][BN];             // [warp row][sum, sumsq][col]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gr = (tid & 31) >> 2;   // fragment row
  const int gc = tid & 3;           // fragment column pair
  const int wm = (warp >> 1) * 32;  // warp tile origin in the block tile
  const int wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bool vec_x = (C % 8) == 0;
  const bool vec_w = (Cout % 8) == 0;
  const bf16 zero = __float2bfloat16(0.f);

  decode_rows(sN, sH, sW, m0, M, H, W);

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += BK) {
      __syncthreads();  // the previous chunk is consumed (and rows decoded)
      // A: BM pixels x BK channels of the shifted input, zero off the image
      for (int i = tid; i < BM * (BK / 8); i += MMA_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const int n = sN[r], hs = sH[r] + dh, ws = sW[r] + dw;
        const int ci = c0 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n >= 0 && hs >= 0 && hs < H && ws >= 0 && ws < W) {
          const bf16* src = x + (((size_t)n * H + hs) * W + ws) * C + ci;
          if (vec_x) {
            if (ci < C) val = *reinterpret_cast<const uint4*>(src);
          } else {
            bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
            for (int j = 0; j < 8; ++j) e[j] = (ci + j < C) ? src[j] : zero;
          }
        }
        *reinterpret_cast<uint4*>(sA + r * LDS + c) = val;
      }
      // B: BK channels x BN outputs of tap `tap`, stored transposed
      for (int i = tid; i < BK * (BN / 8); i += MMA_THREADS) {
        const int k = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int ci = c0 + k, co = n0 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        bf16* e = reinterpret_cast<bf16*>(&val);
        if (ci < C) {
          const bf16* src = w + ((size_t)tap * C + ci) * Cout + co;
          if (vec_w) {
            if (co < Cout) val = *reinterpret_cast<const uint4*>(src);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) e[j] = (co + j < Cout) ? src[j] : zero;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) sB[(c + j) * LDS + k] = e[j];
      }
      __syncthreads();

#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const bf16* a = sA + (wm + mt * 16 + gr) * LDS + ks * 16 + 2 * gc;
          af[mt][0] = ld32(a);
          af[mt][1] = ld32(a + 8 * LDS);
          af[mt][2] = ld32(a + 8);
          af[mt][3] = ld32(a + 8 * LDS + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16* b = sB + (wn + nt * 8 + gr) * LDS + ks * 16 + 2 * gc;
          const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
        }
      }
    }
  }

  const bool pairs = (Cout % 2) == 0;
  if (STATS) {
    // training epilogue: the conv output rounded once, and per-channel
    // partial sums of the fp32 accumulator over this block's valid rows
    float ps[4][2], pq[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) ps[nt][j] = pq[nt][j] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = n0 + wn + nt * 8 + 2 * gc;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm + mt * 16 + gr + 8 * half;
          if (row >= M) continue;
          const size_t o = (size_t)row * Cout + co;
          const float v0 = acc[mt][nt][2 * half];
          const float v1 = acc[mt][nt][2 * half + 1];
          ps[nt][0] += v0;
          pq[nt][0] += v0 * v0;
          ps[nt][1] += v1;
          pq[nt][1] += v1 * v1;
          if (pairs && co + 1 < Cout) {
            *reinterpret_cast<__nv_bfloat162*>(out + o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (co < Cout) out[o] = __float2bfloat16(v0);
            if (co + 1 < Cout) out[o + 1] = __float2bfloat16(v1);
          }
        }
      }
    // sum over the 8 fragment rows of the warp (lanes gr*4 + gc)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          ps[nt][j] += __shfl_xor_sync(0xffffffffu, ps[nt][j], off);
          pq[nt][j] += __shfl_xor_sync(0xffffffffu, pq[nt][j], off);
        }
    if (gr == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sStat[warp >> 1][0][wn + nt * 8 + 2 * gc + j] = ps[nt][j];
          sStat[warp >> 1][1][wn + nt * 8 + 2 * gc + j] = pq[nt][j];
        }
    }
    __syncthreads();
    for (int c = tid; c < BN; c += MMA_THREADS) {
      if (n0 + c >= Cout) continue;
      float* p = partial + (size_t)blockIdx.x * 2 * Cout + n0 + c;
      p[0] = sStat[0][0][c] + sStat[1][0][c];
      p[Cout] = sStat[0][1][c] + sStat[1][1][c];
    }
    return;
  }

  // inference epilogue on the fp32 accumulator: scale, shift, residual,
  // ReLU, round
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int co = n0 + wn + nt * 8 + 2 * gc;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + gr + 8 * half;
        if (row >= M) continue;
        const size_t o = (size_t)row * Cout + co;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (pairs && co + 1 < Cout) {
          v0 = v0 * scale[co] + shift[co];
          v1 = v1 * scale[co + 1] + shift[co + 1];
          if (res != nullptr) {
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    res + o));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        } else {
          if (co < Cout) {
            v0 = v0 * scale[co] + shift[co];
            if (res != nullptr) v0 += __bfloat162float(res[o]);
            out[o] = __float2bfloat16(fmaxf(v0, 0.f));
          }
          if (co + 1 < Cout) {
            v1 = v1 * scale[co + 1] + shift[co + 1];
            if (res != nullptr) v1 += __bfloat162float(res[o + 1]);
            out[o + 1] = __float2bfloat16(fmaxf(v1, 0.f));
          }
        }
      }
    }
}

// ------------------------------------------------------------------ fp32, FMA
constexpr int FK = 16;            // input channels per staged chunk
constexpr int FMA_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDF = BM + 4;       // k-major rows, float4-aligned

template <bool STATS>
__global__ void __launch_bounds__(FMA_THREADS)
    cbr_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const float* __restrict__ res, float* __restrict__ out,
                   float* __restrict__ partial, int M, int H, int W, int C,
                   int Cout) {
  __shared__ __align__(16) float sA[FK * LDF];   // [k][pixel]
  __shared__ __align__(16) float sB[FK * LDF];   // [k][cout]
  __shared__ int sN[BM], sH[BM], sW[BM];
  __shared__ float sStat[16][2][BN];             // [thread row][sum, sq][col]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  decode_rows(sN, sH, sW, m0, M, H, W);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += FK) {
      __syncthreads();
      for (int i = tid; i < BM * FK; i += FMA_THREADS) {
        const int r = i / FK, k = i % FK;
        const int n = sN[r], hs = sH[r] + dh, ws = sW[r] + dw;
        const int ci = c0 + k;
        float val = 0.f;
        if (n >= 0 && ci < C && hs >= 0 && hs < H && ws >= 0 && ws < W)
          val = x[(((size_t)n * H + hs) * W + ws) * C + ci];
        sA[k * LDF + r] = val;
      }
      for (int i = tid; i < FK * BN; i += FMA_THREADS) {
        const int k = i / BN, c = i % BN;
        const int ci = c0 + k, co = n0 + c;
        sB[k * LDF + c] = (ci < C && co < Cout)
                              ? w[((size_t)tap * C + ci) * Cout + co]
                              : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(sA + k * LDF + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(sB + k * LDF + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  if (STATS) {
    float ps[4] = {0.f, 0.f, 0.f, 0.f}, pq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + tx * 4 + j;
        ps[j] += acc[i][j];
        pq[j] += acc[i][j] * acc[i][j];
        if (co < Cout) out[(size_t)row * Cout + co] = acc[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sStat[ty][0][tx * 4 + j] = ps[j];
      sStat[ty][1][tx * 4 + j] = pq[j];
    }
    __syncthreads();
    for (int c = tid; c < BN; c += FMA_THREADS) {
      if (n0 + c >= Cout) continue;
      float s = 0.f, q = 0.f;
      for (int r = 0; r < 16; ++r) {
        s += sStat[r][0][c];
        q += sStat[r][1][c];
      }
      float* p = partial + (size_t)blockIdx.x * 2 * Cout + n0 + c;
      p[0] = s;
      p[Cout] = q;
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= Cout) continue;
      const size_t o = (size_t)row * Cout + co;
      float v = acc[i][j] * scale[co] + shift[co];
      if (res != nullptr) v += res[o];
      out[o] = fmaxf(v, 0.f);
    }
  }
}

// sums[c] = sum over t of partial[t][c], c < cols, t in order: 32 columns
// x 32 tile lanes per block, each lane striding over the tiles, then the 32
// lane sums added in a fixed order
__global__ void __launch_bounds__(1024)
    stats_col_sum_kernel(const float* __restrict__ partial, float* __restrict__ sums,
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

}  // namespace

extern "C" {

// x (N,H,W,C), w (3,3,C,Cout), out and residual (N,H,W,Cout), all of one
// dtype (0 = fp32, 1 = bf16), contiguous and 16-byte aligned; scale and
// shift (Cout,) fp32; residual may be null. N*H*W < 2^31. Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
int mx_conv_bn_relu(const void* x, const void* w, const void* scale,
                    const void* shift, const void* residual, void* out, int N,
                    int H, int W, int C, int Cout, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 1) {
    cbr_mma_kernel<false><<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), sc, sh,
        static_cast<const bf16*>(residual), static_cast<bf16*>(out), nullptr,
        M, H, W, C, Cout);
  } else if (dtype == 0) {
    cbr_fma_kernel<false><<<grid, FMA_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, sh,
        static_cast<const float*>(residual), static_cast<float*>(out),
        nullptr, M, H, W, C, Cout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Training forward: out = conv3x3_same(x, w) rounded once to x's dtype, and
// sums (2, Cout) fp32 = per-channel sum and sum of squares of the fp32
// accumulator over the N*H*W rows. partial is fp32 scratch of
// ceil(N*H*W / 64) * 2 * Cout elements. Two launches on `stream`; returns
// the first launch error (0 on success).
int mx_conv_bn_stats(const void* x, const void* w, void* out, void* partial,
                     void* sums, int N, int H, int W, int C, int Cout,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * H * W;
  const int tiles = (M + BM - 1) / BM;
  const dim3 grid(tiles, (Cout + BN - 1) / BN);
  float* part = static_cast<float*>(partial);
  if (dtype == 1) {
    cbr_mma_kernel<true><<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), nullptr,
        nullptr, nullptr, static_cast<bf16*>(out), part, M, H, W, C, Cout);
  } else if (dtype == 0) {
    cbr_fma_kernel<true><<<grid, FMA_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), nullptr,
        nullptr, nullptr, static_cast<float*>(out), part, M, H, W, C, Cout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = 2 * Cout;
  stats_col_sum_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, s>>>(
      part, static_cast<float*>(sums), tiles, cols);
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
