// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Two kernels, each computing what one TPU kernel of
// mxnet_tpu/parallel/flash_attention.py computes (launched there by
// _pallas_backward_inner), from q, k, v, dO, the forward's fp32 log-sum-exp
// and delta = rowsum(dO * O) (fp32, computed by the caller):
//
//   P  = exp(S * scale - lse),  S = Q K^T    (P recomputed, never stored)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dq = dS K              -- mx_flash_bwd_dq  (replaces _dq_kernel, :200)
//   dk = dS^T Q, dv = P^T dO -- mx_flash_bwd_dkv (replaces _dkv_kernel, :245)
//
// Masking. An entry (query i, key j) takes part when j < Sk, i < Sq and,
// if causal, j <= i + (Sk - Sq); every other entry has P = 0 exactly. For a
// row with at least one visible key this is what the TPU kernels compute
// (there exp(-1e30 - lse) is 0, and rows past Sq are zeroed as in
// _dkv_kernel's lse/delta sanitising). A row with no visible key at all
// (causal with Sq > Sk) gets no gradient: its output is a constant of q and
// k, and P = 0 keeps the result independent of which tiles are visited
// (the TPU kernels' value there depends on their tile geometry). The same
// rule holds in the plain version (_ref_backward). Tiles that hold no
// visible entry are skipped, so the skip rule cannot change a result.
//
// Design. The TPU kernels run a sequential grid axis with fp32 accumulators
// in VMEM scratch and emit per-attention-head dk/dv, summed over the GQA
// group in XLA afterwards. Here:
//
// * dq: one block of 4 warps owns (batch, head, 64 query rows) and loops
//   over 64-row K/V tiles; dq stays in fp32 registers for the sweep.
// * dk/dv: one block owns (batch, kv head, 64 key rows) and loops over the
//   group's query heads and the query tiles (32 rows) that can see its
//   keys. It computes the transposed scores S^T = K Q^T directly, so the
//   P^T and dS^T accumulator fragments are already the A operands of
//   P^T dO and dS^T Q. dk/dv accumulate in fp32 registers across the whole
//   group, so the GQA group-sum happens before the one rounding and no
//   (B, H, Sk, D) buffer exists. No atomics: every output element is
//   written by exactly one thread, and gradients are the same run to run.
//
// bf16 runs every product on the tensor cores with mma.sync m16n8k16 (bf16
// in, fp32 accumulate). P is rounded to bf16 as the A operand of P^T dO, as
// in FlashAttention-2. dS is not: its rows sum to about zero, so in
// dq = sum_j dS_ij K_j (and dk likewise) the rounding errors of the terms
// do not cancel while the terms do, and with keys that share a large mean
// component a bf16 dS costs several percent of dq. dS goes in as two bf16
// operands, hi = bf16(dS) and lo = bf16(dS - hi), two mma's per step
// (about 16 significant bits). fp32 keeps fp32 FMA on tiles staged in
// shared memory, so fp32 inputs get full fp32 products (TF32 would keep
// ~3 digits).
//
// What bounds it on an H100. At the training shape (B=8, H=12, S=1024,
// D=64, causal, bf16) dq is 3 and dk/dv 4 products of 2*B*H*S*S*D/2 flops
// (9.7 and 12.9 GFLOP, ~10-13 us at the bf16 tensor-core peak) against
// ~13 MB of compulsory traffic (~4 us): operations bound. This version
// stages each tile with all threads and then computes (no cp.async/TMA
// overlap, no wgmma, no warp specialisation), so it is bound by load
// latency and the mma.sync issue rate; those are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int BQ = 64;        // dq: query rows per block
constexpr int BK = 64;        // dq: key rows per tile
constexpr int BKV = 64;       // dk/dv: key rows per block
constexpr int BM = 32;        // dk/dv: query rows per tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// The A fragment of rows r0, r0 + 8 and columns c .. c+15 of a row-major
// bf16 tile with row stride ld (elements); c already includes 2 * (lane & 3).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int r0, int c) {
  a[0] = ld32(t + r0 * ld + c);
  a[1] = ld32(t + (r0 + 8) * ld + c);
  a[2] = ld32(t + r0 * ld + c + 8);
  a[3] = ld32(t + (r0 + 8) * ld + c + 8);
}

// Accumulator fragments of n-tiles 2kk and 2kk+1 (16 columns) re-packed as
// the A operand of the next product, whose k dimension is those columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[4],
                                         const float (&y)[4]) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(y[0], y[1]);
  a[3] = pack_bf16(y[2], y[3]);
}

// The same re-packing with each value split into hi = bf16(x) and
// lo = bf16(x - hi), for products whose A operand needs more than 8 bits.
__device__ __forceinline__ uint32_t pack_lo(float a, float b, uint32_t hi) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  return pack_bf16(a - __low2float(h), b - __high2float(h));
}

__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&x)[4],
                                               const float (&y)[4]) {
  acc_to_a(hi, x, y);
  lo[0] = pack_lo(x[0], x[1], hi[0]);
  lo[1] = pack_lo(x[2], x[3], hi[1]);
  lo[2] = pack_lo(y[0], y[1], hi[2]);
  lo[3] = pack_lo(y[2], y[3], hi[3]);
}

// Copy rows [r0, r0 + rows) of a (S, D) bf16 matrix into a row-major tile
// (stride ld) and, when tt is given, its transpose (tt[d * ldt + row]).
// Rows past S are zero.
template <int D>
__device__ __forceinline__ void stage_bf16(const bf16* __restrict__ g,
                                           int r0, int S, int rows, bf16* t,
                                           int ld, bf16* tt, int ldt) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * D + c);
    if (t) *reinterpret_cast<uint4*>(t + r * ld + c) = val;
    if (tt) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tt[(c + j) * ldt + r] = e[j];
    }
  }
}

// ------------------------------------------------------------ bf16, dq
template <int D>
constexpr size_t dq_mma_smem() {
  // sQ, sdO [BQ][D+8]; sK, sV [BK][D+8]; sKt [D][BK+8]
  return sizeof(bf16) *
         (size_t)(2 * BQ * (D + 8) + 2 * BK * (D + 8) + D * (BK + 8));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int H, int Hkv, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = D + 8, LT = BK + 8;
  constexpr int KS = D / 16, NT = BK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;
  bf16* sV = sK + BK * LD;
  bf16* sKt = sV + BK * LD;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int gr = (tid & 31) >> 2, gc = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const size_t qbase = ((size_t)b * H + h) * (size_t)Sq * D;
  const size_t kbase = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const size_t rbase = ((size_t)b * H + h) * (size_t)Sq;
  const int off = Sk - Sq;

  stage_bf16<D>(q + qbase, q0, Sq, BQ, sQ, LD, nullptr, 0);
  stage_bf16<D>(dO + qbase, q0, Sq, BQ, sdO, LD, nullptr, 0);

  const int r0 = warp * 16 + gr;
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const float lse0 = qi0 < Sq ? lse[rbase + qi0] : 0.f;
  const float lse1 = qi1 < Sq ? lse[rbase + qi1] : 0.f;
  const float dl0 = qi0 < Sq ? delta[rbase + qi0] : 0.f;
  const float dl1 = qi1 < Sq ? delta[rbase + qi1] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int nk = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + off;  // last key any row here may see
    const int lim = last < 0 ? 0 : last / BK + 1;
    nk = nk < lim ? nk : lim;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed (and sQ/sdO written)
    stage_bf16<D>(k + kbase, k0, Sk, BK, sK, LD, sKt, LT);
    stage_bf16<D>(v + kbase, k0, Sk, BK, sV, LD, nullptr, 0);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + 2 * gc;
      uint32_t qa[4], oa[4];
      load_a(qa, sQ, LD, r0, c);
      load_a(oa, sdO, LD, r0, c);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* krow = sK + (nt * 8 + gr) * LD + c;
        const bf16* vrow = sV + (nt * 8 + gr) * LD + c;
        mma_bf16(s[nt], qa, ld32(krow), ld32(krow + 8));
        mma_bf16(dp[nt], oa, ld32(vrow), ld32(vrow + 8));
      }
    }

    // dS in place of S
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + nt * 8 + 2 * gc + e;
        const bool in = kj < Sk;
        const bool v0 = in && qi0 < Sq && (!causal || kj <= qi0 + off);
        const bool v1 = in && qi1 < Sq && (!causal || kj <= qi1 + off);
        const float p0 = v0 ? expf(s[nt][e] * scale - lse0) : 0.f;
        const float p1 = v1 ? expf(s[nt][2 + e] * scale - lse1) : 0.f;
        s[nt][e] = p0 * (dp[nt][e] - dl0) * scale;
        s[nt][2 + e] = p1 * (dp[nt][2 + e] - dl1) * scale;
      }

    // dq += dS K (dS as hi + lo): B operand from K^T (n = d, k = key)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t dh[4], dl[4];
      acc_to_a_split(dh, dl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* kt_row = sKt + (dt * 8 + gr) * LT + kk * 16 + 2 * gc;
        const uint32_t b0 = ld32(kt_row), b1 = ld32(kt_row + 8);
        mma_bf16(acc[dt], dh, b0, b1);
        mma_bf16(acc[dt], dl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * gc;
    if (qi0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + qbase + (size_t)qi0 * D + col) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (qi1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + qbase + (size_t)qi1 * D + col) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

// ----------------------------------------------------------- bf16, dk/dv
template <int D>
constexpr size_t dkv_mma_smem() {
  // sK, sV [BKV][D+8]; sQ, sdO [BM][D+8]; sQt, sdOt [D][BM+8]; lse, delta
  return sizeof(bf16) * (size_t)(2 * BKV * (D + 8) + 2 * BM * (D + 8) +
                                 2 * D * (BM + 8)) +
         sizeof(float) * 2 * BM;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                      int causal, float scale) {
  constexpr int LD = D + 8, LT = BM + 8;
  constexpr int KS = D / 16, NT = BM / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKV * LD;
  bf16* sQ = sV + BKV * LD;
  bf16* sdO = sQ + BM * LD;
  bf16* sQt = sdO + BM * LD;
  bf16* sdOt = sQt + D * LT;
  float* sL = reinterpret_cast<float*>(sdOt + D * LT);
  float* sDl = sL + BM;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int gr = (tid & 31) >> 2, gc = tid & 3;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * BKV;
  const size_t kbase = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const int off = Sk - Sq;

  stage_bf16<D>(k + kbase, k0, Sk, BKV, sK, LD, nullptr, 0);
  stage_bf16<D>(v + kbase, k0, Sk, BKV, sV, LD, nullptr, 0);

  const int r0 = warp * 16 + gr;  // this thread's key rows: r0, r0 + 8
  const int kj0 = k0 + r0, kj1 = kj0 + 8;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  // causal: the first query row that sees key k0 is k0 - off
  int m_first = 0;
  if (causal) {
    const int first = k0 - off;
    m_first = first <= 0 ? 0 : first / BM;
  }
  const int nm = (Sq + BM - 1) / BM;

  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    const size_t qbase = ((size_t)b * H + h) * (size_t)Sq * D;
    const size_t rbase = ((size_t)b * H + h) * (size_t)Sq;
    for (int mt = m_first; mt < nm; ++mt) {
      const int m0 = mt * BM;
      __syncthreads();  // the previous tile is consumed (sK/sV written)
      stage_bf16<D>(q + qbase, m0, Sq, BM, sQ, LD, sQt, LT);
      stage_bf16<D>(dO + qbase, m0, Sq, BM, sdO, LD, sdOt, LT);
      for (int i = tid; i < BM; i += THREADS) {
        const bool in = m0 + i < Sq;
        sL[i] = in ? lse[rbase + m0 + i] : 0.f;
        sDl[i] = in ? delta[rbase + m0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows = keys, columns = queries
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int c = ks * 16 + 2 * gc;
        uint32_t ka[4], va[4];
        load_a(ka, sK, LD, r0, c);
        load_a(va, sV, LD, r0, c);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* qrow = sQ + (nt * 8 + gr) * LD + c;
          const bf16* orow = sdO + (nt * 8 + gr) * LD + c;
          mma_bf16(st[nt], ka, ld32(qrow), ld32(qrow + 8));
          mma_bf16(dpt[nt], va, ld32(orow), ld32(orow + 8));
        }
      }

      // P^T in st, dS^T in dpt
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cq = nt * 8 + 2 * gc + e;
          const int qi = m0 + cq;
          const bool qin = qi < Sq;
          const bool v0 = qin && kj0 < Sk && (!causal || kj0 <= qi + off);
          const bool v1 = qin && kj1 < Sk && (!causal || kj1 <= qi + off);
          const float l = sL[cq], dl = sDl[cq];
          const float p0 = v0 ? expf(st[nt][e] * scale - l) : 0.f;
          const float p1 = v1 ? expf(st[nt][2 + e] * scale - l) : 0.f;
          st[nt][e] = p0;
          st[nt][2 + e] = p1;
          dpt[nt][e] = p0 * (dpt[nt][e] - dl) * scale;
          dpt[nt][2 + e] = p1 * (dpt[nt][2 + e] - dl) * scale;
        }

      // dv += P^T dO, dk += dS^T Q (dS^T as hi + lo): B operands from
      // dO^T and Q^T
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t pa[4], dh[4], dl[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a_split(dh, dl, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const int o = (dt * 8 + gr) * LT + kk * 16 + 2 * gc;
          mma_bf16(dva[dt], pa, ld32(sdOt + o), ld32(sdOt + o + 8));
          const uint32_t b0 = ld32(sQt + o), b1 = ld32(sQt + o + 8);
          mma_bf16(dka[dt], dh, b0, b1);
          mma_bf16(dka[dt], dl, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * gc;
    if (kj0 < Sk) {
      const size_t g = kbase + (size_t)kj0 * D + col;
      *reinterpret_cast<uint32_t*>(dk + g) = pack_bf16(dka[dt][0], dka[dt][1]);
      *reinterpret_cast<uint32_t*>(dv + g) = pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (kj1 < Sk) {
      const size_t g = kbase + (size_t)kj1 * D + col;
      *reinterpret_cast<uint32_t*>(dk + g) = pack_bf16(dka[dt][2], dka[dt][3]);
      *reinterpret_cast<uint32_t*>(dv + g) = pack_bf16(dva[dt][2], dva[dt][3]);
    }
  }
}

// -------------------------------------------------------------- fp32, dq
// Thread t owns rows 4*(t/8) .. +3 and key columns (t%8) + 8*j of a tile.
template <int D>
constexpr size_t dq_fma_smem() {
  // sQ, sdO [BQ][D+1]; sKt, sVt [D][BK+1]; sK [BK][D]; sdS [BQ][BK+1]
  return sizeof(float) * (size_t)(2 * BQ * (D + 1) + 2 * D * (BK + 1) +
                                  BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int H, int Hkv, int Sq, int Sk, int causal,
                     float scale) {
  constexpr int QS = D + 1, KS = BK + 1, PS = BK + 1, DC = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * QS;
  float* sKt = sdO + BQ * QS;
  float* sVt = sKt + D * KS;
  float* sK = sVt + D * KS;
  float* sdS = sK + BK * D;

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const size_t qbase = ((size_t)b * H + h) * (size_t)Sq * D;
  const size_t kbase = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const size_t rbase = ((size_t)b * H + h) * (size_t)Sq;
  const int off = Sk - Sq;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const bool in = q0 + r < Sq;
    const size_t g = qbase + (size_t)(q0 + r) * D + d;
    sQ[r * QS + d] = in ? q[g] : 0.f;
    sdO[r * QS + d] = in ? dO[g] : 0.f;
  }
  float lr[4], dl[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    lr[i] = qi < Sq ? lse[rbase + qi] : 0.f;
    dl[i] = qi < Sq ? delta[rbase + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + off;
    const int lim = last < 0 ? 0 : last / BK + 1;
    nk = nk < lim ? nk : lim;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < Sk;
      const size_t g = kbase + (size_t)(k0 + c) * D + d;
      const float kv = in ? k[g] : 0.f;
      sKt[d * KS + c] = kv;
      sK[c * D + d] = kv;
      sVt[d * KS + c] = in ? v[g] : 0.f;
    }
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(rg * 4 + i) * QS + d];
        ov[i] = sdO[(rg * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = sKt[d * KS + cg + 8 * j];
        vv[j] = sVt[d * KS + cg + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + cg + 8 * j;
        const bool valid =
            qi < Sq && kj < Sk && (!causal || kj <= qi + off);
        const float p = valid ? expf(s[i][j] * scale - lr[i]) : 0.f;
        sdS[(rg * 4 + i) * PS + cg + 8 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();  // sdS complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sdS[(rg * 4 + i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) kv[jj] = sK[c * D + cg + 8 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj)
          acc[i][jj] = fmaf(dsv[i], kv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      dq[qbase + (size_t)qi * D + cg + 8 * jj] = acc[i][jj];
  }
}

// ----------------------------------------------------------- fp32, dk/dv
// Thread t owns key rows 4*(t/8) .. +3 and query columns (t%8) + 8*j.
template <int D>
constexpr size_t dkv_fma_smem() {
  // sK, sV [BKV][D+1]; sQt, sdOt [D][BM+1]; sQ, sdO [BM][D];
  // sP, sdS [BKV][BM+1]; lse, delta [BM]
  return sizeof(float) * (size_t)(2 * BKV * (D + 1) + 2 * D * (BM + 1) +
                                  2 * BM * D + 2 * BKV * (BM + 1) + 2 * BM);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                      int causal, float scale) {
  constexpr int KS = D + 1, TS = BM + 1, PS = BM + 1, DC = D / 8;
  constexpr int MJ = BM / 8;  // query columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BKV * KS;
  float* sQt = sV + BKV * KS;
  float* sdOt = sQt + D * TS;
  float* sQ = sdOt + D * TS;
  float* sdO = sQ + BM * D;
  float* sP = sdO + BM * D;
  float* sdS = sP + BKV * PS;
  float* sL = sdS + BKV * PS;
  float* sDl = sL + BM;

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * BKV;
  const size_t kbase = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const int off = Sk - Sq;

  for (int i = tid; i < BKV * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const bool in = k0 + r < Sk;
    const size_t g = kbase + (size_t)(k0 + r) * D + d;
    sK[r * KS + d] = in ? k[g] : 0.f;
    sV[r * KS + d] = in ? v[g] : 0.f;
  }
  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  int m_first = 0;
  if (causal) {
    const int first = k0 - off;
    m_first = first <= 0 ? 0 : first / BM;
  }
  const int nm = (Sq + BM - 1) / BM;

  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    const size_t qbase = ((size_t)b * H + h) * (size_t)Sq * D;
    const size_t rbase = ((size_t)b * H + h) * (size_t)Sq;
    for (int mt = m_first; mt < nm; ++mt) {
      const int m0 = mt * BM;
      __syncthreads();
      for (int i = tid; i < BM * D; i += THREADS) {
        const int r = i / D, d = i % D;
        const bool in = m0 + r < Sq;
        const size_t g = qbase + (size_t)(m0 + r) * D + d;
        const float qv = in ? q[g] : 0.f, ov = in ? dO[g] : 0.f;
        sQt[d * TS + r] = qv;
        sQ[r * D + d] = qv;
        sdOt[d * TS + r] = ov;
        sdO[r * D + d] = ov;
      }
      for (int i = tid; i < BM; i += THREADS) {
        const bool in = m0 + i < Sq;
        sL[i] = in ? lse[rbase + m0 + i] : 0.f;
        sDl[i] = in ? delta[rbase + m0 + i] : 0.f;
      }
      __syncthreads();

      float st[4][MJ], dpt[4][MJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < MJ; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[MJ], ov[MJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(rg * 4 + i) * KS + d];
          vv[i] = sV[(rg * 4 + i) * KS + d];
        }
#pragma unroll
        for (int c = 0; c < MJ; ++c) {
          qv[c] = sQt[d * TS + cg + 8 * c];
          ov[c] = sdOt[d * TS + cg + 8 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < MJ; ++c) {
            st[i][c] = fmaf(kv[i], qv[c], st[i][c]);
            dpt[i][c] = fmaf(vv[i], ov[c], dpt[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + rg * 4 + i;
#pragma unroll
        for (int c = 0; c < MJ; ++c) {
          const int cq = cg + 8 * c, qi = m0 + cq;
          const bool valid =
              qi < Sq && kj < Sk && (!causal || kj <= qi + off);
          const float p = valid ? expf(st[i][c] * scale - sL[cq]) : 0.f;
          sP[(rg * 4 + i) * PS + cq] = p;
          sdS[(rg * 4 + i) * PS + cq] = p * (dpt[i][c] - sDl[cq]) * scale;
        }
      }
      __syncthreads();  // sP, sdS complete

#pragma unroll 4
      for (int c = 0; c < BM; ++c) {
        float pv[4], ov[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * PS + c];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) ov[jj] = sdO[c * D + cg + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DC; ++jj)
            dva[i][jj] = fmaf(pv[i], ov[jj], dva[i][jj]);
      }
#pragma unroll 4
      for (int c = 0; c < BM; ++c) {
        float dsv[4], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = sdS[(rg * 4 + i) * PS + c];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) qv[jj] = sQ[c * D + cg + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DC; ++jj)
            dka[i][jj] = fmaf(dsv[i], qv[jj], dka[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + rg * 4 + i;
    if (kj >= Sk) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const size_t g = kbase + (size_t)kj * D + cg + 8 * jj;
      dk[g] = dka[i][jj];
      dv[g] = dva[i][jj];
    }
  }
}

// ----------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Hkv, int Sq, int Sk, int causal, float scale,
              cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = dq_mma_smem<D>();
    err = prepare(flash_bwd_dq_mma<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_mma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), H, Hkv, Sq, Sk, causal, scale);
  } else {
    const size_t smem = dq_fma_smem<D>();
    err = prepare(flash_bwd_dq_fma<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_fma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), H, Hkv, Sq, Sk, causal, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Hkv, int Sq, int Sk, int causal, float scale,
               cudaStream_t stream) {
  const dim3 grid((Sk + BKV - 1) / BKV, Hkv, B);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = dkv_mma_smem<D>();
    err = prepare(flash_bwd_dkv_mma<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_mma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, Sq, Sk,
        causal, scale);
  } else {
    const size_t smem = dkv_fma_smem<D>();
    err = prepare(flash_bwd_dkv_fma<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_fma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Sq, Sk,
        causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dO, dq (B,H,Sq,D); k, v, dk, dv (B,Hkv,Sk,D); lse, delta (B,H,Sq)
// fp32. All contiguous, 16-byte aligned, on the current device; q, k, v,
// dO and the outputs share one dtype: 0 = fp32, 1 = bf16. D: 64 or 128.
// Each returns the launch's cudaError_t (0 on success).
int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dO, const void* lse, const void* delta,
                    void* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
                    int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && dtype == 1)
    return launch_dq<bf16, 64>(q, k, v, dO, lse, delta, dq, B, H, Hkv, Sq,
                               Sk, causal, scale, s);
  if (D == 128 && dtype == 1)
    return launch_dq<bf16, 128>(q, k, v, dO, lse, delta, dq, B, H, Hkv, Sq,
                                Sk, causal, scale, s);
  if (D == 64 && dtype == 0)
    return launch_dq<float, 64>(q, k, v, dO, lse, delta, dq, B, H, Hkv, Sq,
                                Sk, causal, scale, s);
  if (D == 128 && dtype == 0)
    return launch_dq<float, 128>(q, k, v, dO, lse, delta, dq, B, H, Hkv,
                                 Sq, Sk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dO, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int Hkv, int Sq,
                     int Sk, int D, int causal, float scale, int dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && dtype == 1)
    return launch_dkv<bf16, 64>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv,
                                Sq, Sk, causal, scale, s);
  if (D == 128 && dtype == 1)
    return launch_dkv<bf16, 128>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv,
                                 Sq, Sk, causal, scale, s);
  if (D == 64 && dtype == 0)
    return launch_dkv<float, 64>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv,
                                 Sq, Sk, causal, scale, s);
  if (D == 128 && dtype == 0)
    return launch_dkv<float, 128>(q, k, v, dO, lse, delta, dk, dv, B, H,
                                  Hkv, Sq, Sk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
