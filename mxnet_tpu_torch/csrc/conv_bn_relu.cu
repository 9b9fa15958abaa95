// Fused conv3x3 (stride 1, SAME) + folded BatchNorm + ReLU (+ residual), and
// its training form (the conv and its per-channel batch sums), for Hopper
// (sm_90a), plain C interface.
//
// Replaces two TPU kernels of mxnet_tpu/ops/fused_conv.py:
// * _kernel (launched by _pallas_conv_bn_relu) -> mx_conv_bn_relu: x
//   (N,H,W,C) NHWC, w (3,3,C,Cout) HWIO, out[n,h,w,co] = relu(sum_{dh,dw,ci}
//   x[n,h+dh-1,w+dw-1,ci] * w[dh,dw,ci,co] * scale[co] + shift[co]
//   (+ residual[n,h,w,co])), the sum and the epilogue in fp32, the result
//   rounded once to x's type.
// * _kernel_train (launched by _pallas_conv_stats) -> mx_conv_bn_stats: the
//   conv output rounded once to x's type (no scale/shift/ReLU), and from the
//   fp32 accumulator (not the rounded output) the per-channel sum and sum of
//   squares over the N*H*W rows. Each block writes its partials for its rows
//   into an fp32 scratch (m_tiles, 2, Cout); stats_col_sum_kernel then sums
//   them over the tiles in a fixed order. No atomics: the same bits on every
//   run. The batch mean/variance and the normalize + ReLU pass are plain
//   PyTorch in the wrapper, as they were plain XLA on the TPU.
//
// Both are one implicit GEMM, templated on STATS: M = N*H*W output pixels,
// N = Cout, K = 9*C, walked as 9 taps x C in chunks. The TPU kernel took one
// whole image per grid step (9 rolled-and-masked dots in VMEM); here a block
// owns a tile of the flattened N*H*W rows (ResNet's 7x7 stage would leave
// most of a one-image tile empty) and the SAME border is zero-filled while
// the tile is gathered. The accumulator stays in registers and the epilogue
// runs on it before the one NHWC store.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s). ResNet-50's four
// bottleneck 3x3 shapes each do 2*M*9*C*Cout = 59.2 GFLOP at batch 256
// (0.060 ms of tensor-core time). Stage 1 (56x56, C = Cout = 64) moves x and
// the output once, 206 MB (0.061 ms), so it is balanced between bytes and
// operations; stages 2-4 (28x28x128, 14x14x256, 7x7x512) move 103, 51 and
// 26 MB and are operations bound. An implicit GEMM also gathers every x row
// once per tap: ~9 reads of x through L2 (0.9 GB a launch at stage 1).
//
// Variants, chosen by the wrapper from the shape before the launch:
// * wgmma (bf16, C % 64 == 0 and Cout % 64 == 0: every ResNet-50 bottleneck
//   3x3 conv). A warp-specialised, pipelined, persistent kernel. One
//   producer warpgroup gathers each K chunk (one tap, 64 input channels: one
//   128-byte row per pixel) with 16-byte cp.async copies into a ring of 4
//   shared-memory stages, at the 128-byte-swizzled addresses the wgmma
//   descriptors read; a pixel off the image or past M takes the copy's
//   zero-fill form. The weight, a plain (9*C, Cout) matrix contiguous in
//   Cout, is copied as it lies and read by wgmma through its transpose-B
//   bit. Each copy arrives on the stage's "full" mbarrier when it lands
//   (cp.async.mbarrier.arrive.noinc); one or two consumer warpgroups (64
//   rows each) wait on it, run 4 wgmma.m64nBNk16 per chunk with one wgmma
//   group kept in flight, and release the stage on its "empty" mbarrier.
//   Each block walks tiles in turn and the ring runs on across them, so the
//   next tile's gather overlaps this tile's epilogue. Tiles: BM = 128
//   pixels (two consumers) or 64 (one, for grids under one wave of
//   blocks) x BN = 128 channels, or 64 where Cout % 128 != 0 (stage 1).
//   This replaces the first design's single-buffered chunks of 32 channels,
//   staged by all threads between two barriers, its B operand transposed
//   with scalar stores, and mma.sync on 64 x 64 tiles: 3-5x faster at
//   the stage shapes. What holds it at ~2x cuDNN's conv: the L2 -> shared
//   traffic (a 128 x 128 chunk moves 32 KB for 2.1 MFLOP, and the gather
//   reads each x row once per tap), one block of two consumers per SM at
//   128 x 128 (the 64 accumulators a thread leave no registers for a
//   second block), and partial last waves where tiles barely exceed the
//   blocks resident (stage 3 at batch 64: 196 tiles on 132 blocks).
// * mma (bf16, any other shape): mma.sync m16n8k16 on 64 x 64 tiles, 4 warps
//   of 32 x 32; A staged row-major, B staged transposed ([cout][k]) for the
//   .col operand's k-pairs; 16-byte loads where C (x) or Cout (w) is a
//   multiple of 8, element loads with bounds otherwise. No pipeline.
// * fma (fp32): FMA in full fp32 (TF32 would keep ~3 decimal digits); 256
//   threads, each a 4 x 4 output micro-tile, both tiles staged k-major.
//
// Next step, for stage 1 first (nearest its byte bound, 2x cuDNN): reuse a
// halo of x rows between taps instead of gathering each row nine times, and
// share the B tile between blocks (a cluster's TMA multicast).
//
// bf16 x bf16 products are exact in fp32, as the reference's upcast-then-dot.
// Offsets are 64-bit; N*H*W < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ------------------------------------------------------------- bf16, wgmma
// One K chunk is one tap and 64 input channels. A stage holds the chunk's
// A tile (BM_ rows of 128 bytes, K-major) and B tile (64 k-rows of BN_
// columns, as BN_/64 atoms of 64 rows x 128 bytes, N-major), both in the
// 128-byte swizzle: 16-byte chunk c of row r lies at r * 128 + ((c ^ (r %
// 8)) * 16) from a 1024-byte aligned base.
template <int BM_, int BN_>
struct WgTile {
  static constexpr int kCons = BM_ / 64;              // consumer warpgroups
  static constexpr int kThreads = 128 * (kCons + 1);  // + the producer
  static constexpr int kStages = 4;                   // the ring
  // blocks per SM, as measured best on an H100: one at 128 x 128 (its
  // consumers hold 64 accumulators a thread: 167 registers), two at 128 x
  // 64 and 64 x 128, three at 64 x 64 (80 registers, 67 KB each)
  static constexpr int kMinBlocks =
      BM_ * BN_ == 128 * 128 ? 1 : (BM_ * BN_ == 64 * 64 ? 3 : 2);
  static constexpr int kABytes = BM_ * 128;
  static constexpr int kBBytes = BN_ * 128;
  static constexpr int kStatBytes = kCons * 4 * 2 * BN_ * 4;  // [warp][2][BN_]
  // alignment slack, the ring, full[] and empty[] barriers, the stats
  static constexpr int kSmem =
      1024 + kStages * (kABytes + kBBytes) + 2 * kStages * 8 + kStatBytes;
};

// Persistent: block b computes tiles b, b + gridDim.x, ... (n tiles fastest,
// so the blocks in flight share x rows), and the ring runs on across tiles:
// the producer gathers the next tile's first chunks while the consumers run
// the current tile's epilogue.
template <bool STATS, int BM_, int BN_>
__global__ void __launch_bounds__(WgTile<BM_, BN_>::kThreads,
                                  WgTile<BM_, BN_>::kMinBlocks)
    cbr_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const bf16* __restrict__ res, bf16* __restrict__ out,
                     float* __restrict__ partial, int M, int H, int W, int C,
                     int Cout) {
  using T = WgTile<BM_, BN_>;
  constexpr int STAGES = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sA = base;                             // STAGES x A tile
  const uint32_t sB = base + STAGES * T::kABytes;       // STAGES x B tile
  const uint32_t bars = sB + STAGES * T::kBBytes;       // full[], empty[]
  const uint32_t full0 = bars, empty0 = bars + 8 * STAGES;
  float* sStat = reinterpret_cast<float*>(smem_raw + (bars - raw) +
                                          2 * STAGES * 8);  // [warp][2][BN_]

  const int n_tiles = Cout / BN_;
  const int tiles = ((M + BM_ - 1) / BM_) * n_tiles;
  const int kchunks = C / 64;
  const int nk = 9 * kchunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 128);         // one per producer thread
      hopper::mbar_init(empty0 + 8 * s, 4 * T::kCons);  // one per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  if (wg == 0) {
    // ---- producer: thread t copies 16-byte chunk t % 8 of rows t / 8 + 16 i
    constexpr int RPT = BM_ / 16;
    const int ch = t & 7;
    const int r0 = t >> 3;
    const uint32_t swz = (uint32_t)((ch ^ (r0 & 7)) << 4);
    int g = 0;                      // chunks through the ring so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m_tile = tile / n_tiles;
      const int n0 = (tile - m_tile * n_tiles) * BN_;
      const int m0 = m_tile * BM_;
      int pix[RPT];          // the row's pixel index
      uint32_t taps[RPT];    // bit (dh+1)*3 + (dw+1): the tap lies on the image
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int p = m0 + r0 + 16 * i;
        pix[i] = 0;
        taps[i] = 0u;                 // none past M
        if (p < M) {
          const int hw = p % (H * W);
          const int h = hw / W, ww = hw - (hw / W) * W;
          uint32_t m = 0u;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int hs = h + tap / 3 - 1, ws = ww + tap % 3 - 1;
            if (hs >= 0 && hs < H && ws >= 0 && ws < W) m |= 1u << tap;
          }
          pix[i] = p;
          taps[i] = m;
        }
      }
      for (int kc = 0; kc < nk; ++kc, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES)
          hopper::mbar_wait(empty0 + 8 * s, ((g / STAGES) - 1) & 1);
        const int tap = kc / kchunks;
        const int c0 = (kc - tap * kchunks) * 64;
        const int shift_pix = (tap / 3 - 1) * W + (tap % 3 - 1);
        const uint32_t a_dst = sA + s * T::kABytes + r0 * 128 + swz;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const bool on = (taps[i] >> tap) & 1u;
          const bf16* src =
              on ? x + (size_t)(pix[i] + shift_pix) * C + c0 + ch * 8 : x;
          hopper::cp_async_16(a_dst + i * 16 * 128, src, on ? 16u : 0u);
        }
        // B: k-rows tap*C + c0 + kr of the (9*C, Cout) weight, columns n0..
        const bf16* wsrc = w + ((size_t)tap * C + c0) * Cout + n0 + ch * 8;
        const uint32_t b_dst = sB + s * T::kBBytes + swz;
#pragma unroll
        for (int j = 0; j < BN_ / 16; ++j) {
          const int atom = j >> 2;
          const int kr = r0 + 16 * (j & 3);
          hopper::cp_async_16(b_dst + atom * 8192 + kr * 128,
                              wsrc + (size_t)kr * Cout + atom * 64, 16u);
        }
        hopper::cp_async_arrive_noinc(full0 + 8 * s);
      }
    }
    hopper::cp_async_wait_all();
    return;
  }

  // ---- consumers: warpgroup cw owns rows cw*64 .. cw*64+63 of each tile
  const int cw = wg - 1;
  const int lane = t & 31, wq = t >> 5;
  int g = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m_tile = tile / n_tiles;
    const int n0 = (tile - m_tile * n_tiles) * BN_;
    const int m0 = m_tile * BM_;
    float acc[BN_ / 2];
#pragma unroll
    for (int i = 0; i < BN_ / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++g) {
      const int s = g % STAGES;
      hopper::mbar_wait(full0 + 8 * s, (g / STAGES) & 1);
      hopper::fence_proxy_async();
      const uint32_t a = sA + s * T::kABytes + cw * 64 * 128;
      const uint32_t b = sB + s * T::kBBytes;
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = hopper::sw128_desc(a + kk * 32, 1, 64);
        const uint64_t db = hopper::sw128_desc(b + kk * 2048, 512, 64);
        if constexpr (BN_ == 128)
          hopper::wgmma_m64n128k16_bf16(acc, da, db, 1);
        else
          hopper::wgmma_m64n64k16_bf16(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::fence_operands(acc);
      hopper::wgmma_wait<1>();   // the previous chunk's MMAs are done
      if (kc > 0 && lane == 0)
        hopper::mbar_arrive(empty0 + 8 * ((g - 1) % STAGES));
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    if (lane == 0) hopper::mbar_arrive(empty0 + 8 * ((g - 1) % STAGES));

    // fragment of wgmma m64nN: rows wq*16 + lane/4 (+8), columns j*8 +
    // 2*(lane%4) (+1) for j < BN_/8, at acc[4j .. 4j+3]
    const int row0 = m0 + cw * 64 + wq * 16 + (lane >> 2);
    const bool v0 = row0 < M, v1 = row0 + 8 < M;
    const size_t o0 = (size_t)row0 * Cout, o1 = o0 + (size_t)8 * Cout;
    if (STATS) {
      // training epilogue: the conv output rounded once, and per-channel
      // partial sums of the fp32 accumulator over the tile's valid rows
      float* st = sStat + (cw * 4 + wq) * 2 * BN_;
#pragma unroll
      for (int j = 0; j < BN_ / 8; ++j) {
        const int col = j * 8 + 2 * (lane & 3);
        const float a0 = acc[4 * j], a1 = acc[4 * j + 1];
        const float a2 = acc[4 * j + 2], a3 = acc[4 * j + 3];
        if (v0)
          *reinterpret_cast<__nv_bfloat162*>(out + o0 + n0 + col) =
              __floats2bfloat162_rn(a0, a1);
        if (v1)
          *reinterpret_cast<__nv_bfloat162*>(out + o1 + n0 + col) =
              __floats2bfloat162_rn(a2, a3);
        float s0 = v0 ? a0 : 0.f, s1 = v0 ? a1 : 0.f;
        float q0 = v0 ? a0 * a0 : 0.f, q1 = v0 ? a1 * a1 : 0.f;
        if (v1) {
          s0 += a2;
          s1 += a3;
          q0 += a2 * a2;
          q1 += a3 * a3;
        }
        // over the 8 row groups of the warp (lanes 4g + lane%4)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          q0 += __shfl_xor_sync(0xffffffffu, q0, off);
          q1 += __shfl_xor_sync(0xffffffffu, q1, off);
        }
        if (lane < 4) {
          st[col] = s0;
          st[col + 1] = s1;
          st[BN_ + col] = q0;
          st[BN_ + col + 1] = q1;
        }
      }
      hopper::bar_sync(1, 128 * T::kCons);   // the consumers only
      // the tile's sums over its warps, in warp order
      for (int c = threadIdx.x - 128; c < BN_; c += 128 * T::kCons) {
        float sum = 0.f, sq = 0.f;
#pragma unroll
        for (int wi = 0; wi < 4 * T::kCons; ++wi) {
          sum += sStat[wi * 2 * BN_ + c];
          sq += sStat[wi * 2 * BN_ + BN_ + c];
        }
        float* p = partial + (size_t)m_tile * 2 * Cout + n0 + c;
        p[0] = sum;
        p[Cout] = sq;
      }
      hopper::bar_sync(1, 128 * T::kCons);   // sStat is read: free again
    } else {
      // inference epilogue on the fp32 accumulator: scale, shift, residual,
      // ReLU, one rounding
#pragma unroll
      for (int j = 0; j < BN_ / 8; ++j) {
        const int co = n0 + j * 8 + 2 * (lane & 3);
        const float sc0 = scale[co], sc1 = scale[co + 1];
        const float sh0 = shift[co], sh1 = shift[co + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!(half ? v1 : v0)) continue;
          const size_t o = (half ? o1 : o0) + co;
          float y0 = acc[4 * j + 2 * half] * sc0 + sh0;
          float y1 = acc[4 * j + 2 * half + 1] * sc1 + sh1;
          if (res != nullptr) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + o));
            y0 += r.x;
            y1 += r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
        }
      }
    }
  }
}

// Launch one instantiation persistently: as many blocks as fit on the
// card at once (at most one per tile). The dynamic shared memory (above
// 48 KB) is allowed, and the blocks per SM read, once per instantiation and
// device.
template <bool STATS, int BM_, int BN_>
cudaError_t launch_wgmma(const bf16* x, const bf16* w, const float* scale,
                         const float* shift, const bf16* res, bf16* out,
                         float* partial, int M, int H, int W, int C, int Cout,
                         cudaStream_t s) {
  using T = WgTile<BM_, BN_>;
  auto kernel = cbr_wgmma_kernel<STATS, BM_, BN_>;
  static int resident[64] = {};   // blocks the card holds at once, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        T::kThreads, T::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const long long tiles = (long long)((M + BM_ - 1) / BM_) * (Cout / BN_);
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const int blocks = (int)(tiles < resident[dev] ? tiles : resident[dev]);
  kernel<<<blocks, T::kThreads, T::kSmem, s>>>(x, w, scale, shift, res, out,
                                               partial, M, H, W, C, Cout);
  return cudaGetLastError();
}

// the wgmma variant at tile (bm, bn); cudaErrorInvalidValue for a tile or a
// shape it does not take
template <bool STATS>
cudaError_t launch_wgmma_tile(int bm, int bn, const bf16* x, const bf16* w,
                              const float* scale, const float* shift,
                              const bf16* res, bf16* out, float* partial,
                              int M, int H, int W, int C, int Cout,
                              cudaStream_t s) {
  if (C % 64 != 0 || Cout % bn != 0) return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128)
    return launch_wgmma<STATS, 128, 128>(
        x, w, scale, shift, res, out, partial, M, H, W, C, Cout, s);
  if (bm == 128 && bn == 64)
    return launch_wgmma<STATS, 128, 64>(
        x, w, scale, shift, res, out, partial, M, H, W, C, Cout, s);
  if (bm == 64 && bn == 128)
    return launch_wgmma<STATS, 64, 128>(
        x, w, scale, shift, res, out, partial, M, H, W, C, Cout, s);
  if (bm == 64 && bn == 64)
    return launch_wgmma<STATS, 64, 64>(
        x, w, scale, shift, res, out, partial, M, H, W, C, Cout, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Variants (the wrapper picks one by shape and passes its tile):
// variant 0, the general kernels: bf16 mma.sync or fp32 FMA, tile 64 x 64
// (bm = bn = 64); variant 1, wgmma: bf16 only, C % 64 == 0, Cout % bn ==
// 0, bm and bn each 64 or 128. Anything else returns cudaErrorInvalidValue
// before a launch.
//
// x (N,H,W,C), w (3,3,C,Cout), out and residual (N,H,W,Cout), all of one
// dtype (0 = fp32, 1 = bf16), contiguous and 16-byte aligned; scale and
// shift (Cout,) fp32; residual may be null. N*H*W < 2^31. Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
int mx_conv_bn_relu(const void* x, const void* w, const void* scale,
                    const void* shift, const void* residual, void* out, int N,
                    int H, int W, int C, int Cout, int dtype, int variant,
                    int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * H * W;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (variant == 1 && dtype == 1)
    return (int)launch_wgmma_tile<false>(
        bm, bn, static_cast<const bf16*>(x), static_cast<const bf16*>(w), sc,
        sh, static_cast<const bf16*>(residual), static_cast<bf16*>(out),
        nullptr, M, H, W, C, Cout, s);
  if (variant != 0 || bm != BM || bn != BN) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
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
// ceil(N*H*W / bm) * 2 * Cout elements, bm the tile's rows (variants as for
// mx_conv_bn_relu). Two launches on `stream`; returns the first launch
// error (0 on success).
int mx_conv_bn_stats(const void* x, const void* w, void* out, void* partial,
                     void* sums, int N, int H, int W, int C, int Cout,
                     int dtype, int variant, int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * H * W;
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (variant == 1 && dtype == 1) {
    err = launch_wgmma_tile<true>(
        bm, bn, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        nullptr, nullptr, nullptr, static_cast<bf16*>(out), part, M, H, W, C,
        Cout, s);
  } else {
    if (variant != 0 || bm != BM || bn != BN)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
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
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + bm - 1) / bm;
  const int cols = 2 * Cout;
  stats_col_sum_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, s>>>(
      part, static_cast<float*>(sums), tiles, cols);
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
