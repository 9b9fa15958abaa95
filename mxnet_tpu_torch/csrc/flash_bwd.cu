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
// Design: warp-specialised wgmma kernels for bf16 (the main paths' type),
// FMA kernels for fp32. The TPU kernels run a sequential grid axis with
// fp32 accumulators in VMEM scratch and emit per-attention-head dk/dv,
// summed over the GQA group in XLA afterwards. Here:
//
// * dq (flash_bwd_dq_wgmma): a block owns (batch, head, 64 * CONS query
//   rows), one consumer warpgroup per 64 rows, and walks the 64-key tiles
//   its rows can see; dq stays in fp32 registers for the sweep.
// * dk/dv (flash_bwd_dkv_wgmma): a block owns (batch, kv head, 64 * CONS
//   key rows) and walks the 64-row query tiles that can see its keys, for
//   the query heads of its share of the GQA group. It computes S^T = K Q^T,
//   so the P^T and dS^T accumulator fragments are already the A operands of
//   P^T dO and dS^T Q. With one share (split 1) dk/dv accumulate in fp32
//   registers over the whole group and are rounded once. Where the grid is
//   short (flash_bwd_plan) the group is split into shares: each block
//   writes fp32 partials of its share, and flash_bwd_dkv_group_sum adds the
//   shares in a fixed order and rounds once (the reference's per-head
//   dk/dv plus its group sum in XLA).
// * Loads: one producer warp copies the block's fixed operands once (Q and
//   dO for dq; K and V for dk/dv) and each step's tiles (K, V; or Q, dO
//   with their lse and delta rows) with cp.async into a ring of 3 stages,
//   with a full and an empty mbarrier a stage (cp.async.mbarrier.arrive
//   .noinc marks a stage full when its copies land). Rows past S take the
//   copy's zero-fill form, so ragged tiles need no second path. cp.async,
//   not TMA: the ring, the swizzled addresses and the descriptors are the
//   ones csrc/conv_bn_relu.cu's wgmma variant proved, with no tensor map or
//   driver entry point. Every mbarrier wait traps after its poll limit, so
//   a pipeline fault fails the launch instead of holding the card.
// * Products: every tile lies once in shared memory, 128-byte swizzled,
//   and is read both ways. S = Q K^T and dP = dO V^T (S^T = K Q^T and
//   dP^T = V dO^T) are SS wgmma with both operands K-major (imm-trans-b 0),
//   their K steps interleaved as two independent accumulator chains.
//   dq += dS K (dv += P^T dO, dk += dS^T Q) are RS wgmma: the A operand is
//   re-packed from the fp32 accumulator into registers, and B is read
//   N-major from the same tile through imm-trans-b 1. No transposed copy
//   exists.
// * Numerics. P is rounded to bf16 as the A operand of P^T dO, as in
//   FlashAttention-2. dS is not: its rows sum to about zero, so in dq =
//   sum_j dS_ij K_j (and dk likewise) the rounding errors of the terms do
//   not cancel while the terms do. With keys that share a large mean
//   component, a bf16 dS costs several percent of dq. dS goes in as two
//   bf16 operands, hi = bf16(dS) and lo = bf16(dS - hi), two RS wgmma's a K
//   step (about 16 significant bits). So dq runs 4 products and dk/dv 5,
//   against the function's 3 and 4. P = 2^(S scale log2 e - lse log2 e) on
//   the special-function unit (ex2.approx). fp32 keeps fp32 FMA on tiles
//   staged in shared memory (TF32 would keep ~3 digits).
// * Scheduling: the grid is ordered so that the blocks with the most work
//   under causal masking start first: the last query tiles for dq, the
//   first key tiles for dk/dv. Tiles that no row of a warpgroup sees are
//   skipped. Deterministic: no atomics, every output element is written by
//   one thread, and two launches are bit-equal.
// * Tiles (flash_bwd_plan): dq 64 query rows a block at D 64 (one consumer
//   and the producer, 160 threads: two blocks fit an SM) and 128 at D 128
//   (two consumers); dk/dv 128 key rows at D 64 and 64 at D 128 (dk and dv
//   are 64 + 64 fp32 a thread there before S^T and dP^T). A 288-thread
//   block is given at most 168 registers a thread. ptxas (H100 build in
//   chip_smoke.py): dq 149 registers at D 64 and 165 at D 128; dk/dv 168
//   at D 64 and 251 at D 128; no spills.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s). At the training
// shape (B 8, H 12, S 1024, D 64, causal) dq does 3 and dk/dv 4 products
// of 2 B H S S D / 2 flops: 9.7 and 12.9 GFLOP, 0.0195 and 0.0261 ms at
// the tensor peak, against ~13 MB of compulsory traffic: operations bound.
// Measured (chip_smoke.py, one H100 at 700 W): dq 0.097 ms, dk/dv 0.134 ms,
// 5.0x and 5.1x the bound, and about 1.5x the device time of SDPA's whole
// backward. What keeps them there:
// (1) the hi/lo split runs 4/3 and 5/4 of the function's products;
// (2) the consumer warpgroups of a block run in step, so both compute
//     their softmax while the tensor cores idle. The softmax is bound by
//     ex2 on the special-function unit (16 a clock an SM: 8192 a 128 x 64
//     step). Letting the warpgroups take turns at the tensor cores, as
//     FlashAttention-3 does, was slower here: one warpgroup alone keeps a
//     single dependent accumulator chain in flight per m64n64 wgmma, and
//     more chains do not fit the 168 registers;
// (3) 64-wide tiles: an SS m64n64k16 reads as many operand bytes from
//     shared memory (4 KB) as the SM's shared-memory port moves in the
//     instruction's 32 tensor clocks;
// (4) one block per SM at 128 rows, so a block's first loads and last
//     stores are not overlapped by another block's work.
// The next steps are a persistent kernel that prefetches the next tile's
// Q/dO, and wider tiles with setmaxnreg giving the consumers more
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// fp32 FMA kernels' tiles
constexpr int THREADS = 128;  // 4 warps
constexpr int BQ = 64;        // dq: query rows per block
constexpr int BK = 64;        // dq: key rows per tile
constexpr int BKV = 64;       // dk/dv: key rows per block
constexpr int BM = 32;        // dk/dv: query rows per tile

// wgmma kernels: every step takes a 64-row tile of the other side
constexpr int STEP = 64;

using hopper::acc_to_a;
using hopper::ex2;
using hopper::kmajor_desc;
using hopper::pack_bf16;

// The same with each value split into hi = bf16(x) and lo = bf16(x - hi),
// for products whose A operand needs more than 8 bits.
__device__ __forceinline__ uint32_t pack_lo(float a, float b, uint32_t hi) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  return pack_bf16(a - __low2float(h), b - __high2float(h));
}

__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float* x) {
  acc_to_a(hi, x);
  lo[0] = pack_lo(x[0], x[1], hi[0]);
  lo[1] = pack_lo(x[2], x[3], hi[1]);
  lo[2] = pack_lo(x[4], x[5], hi[2]);
  lo[3] = pack_lo(x[6], x[7], hi[3]);
}

// ------------------------------------------------------------ bf16, wgmma
// Tiles lie in shared memory 128-byte swizzled, as hopper.cuh describes,
// and are read K-major and N-major; every step's tile of the other side
// has STEP rows.

// The producer warp's copy of rows [r0, r0 + R) of a (S, D) matrix into a
// tile; rows past S are zero-filled by the copy itself.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ g, int r0,
                                          int S, int lane) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = lane; i < R * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const bool on = r0 + r < S;
    const bf16* src = on ? g + (size_t)(r0 + r) * D + c * 8 : g;
    hopper::cp_async_16(
        dst + (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
        src, on ? 16u : 0u);
  }
}

// s (64 x STEP) = A rows a_row0.. of tile a (R_A rows) * B tile b^T (STEP
// rows) and t = the same of tiles c and d, both K-major, over K = D; the
// two products' K steps interleaved (two independent accumulator chains)
template <int D, int R_A>
__device__ __forceinline__ void mma_ss2(float (&s)[32], uint32_t a,
                                        uint32_t b, float (&t)[32],
                                        uint32_t c, uint32_t d, int a_row0) {
  hopper::wgmma_m64n64k16_bf16_kk_first(s, kmajor_desc<R_A>(a, a_row0, 0),
                                        kmajor_desc<STEP>(b, 0, 0));
  hopper::wgmma_m64n64k16_bf16_kk_first(t, kmajor_desc<R_A>(c, a_row0, 0),
                                        kmajor_desc<STEP>(d, 0, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    hopper::wgmma_m64n64k16_bf16_kk(s, kmajor_desc<R_A>(a, a_row0, kk),
                                    kmajor_desc<STEP>(b, 0, kk));
    hopper::wgmma_m64n64k16_bf16_kk(t, kmajor_desc<R_A>(c, a_row0, kk),
                                    kmajor_desc<STEP>(d, 0, kk));
  }
}

// dq: a block of CONS consumer warpgroups owns 64 * CONS query rows of one
// (batch, head) and walks the key tiles that any of its rows can see; a
// producer warp copies Q and dO once and each K/V tile into a ring.
template <int D, int CONS>
struct DqTile {
  static constexpr int kRows = 64 * CONS;
  static constexpr int kThreads = 128 * CONS + 32;  // + the producer warp
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kRows * D * 2;     // sQ, sdO each
  static constexpr int kKBytes = STEP * D * 2;      // a K or V tile
  // alignment slack, sQ, sdO, the ring of (K, V), qbar, full[], empty[]
  static constexpr int kSmem =
      1024 + 2 * kQBytes + kStages * 2 * kKBytes + (1 + 2 * kStages) * 8;
};

template <int D, int CONS>
__global__ void __launch_bounds__(DqTile<D, CONS>::kThreads, 1)
    flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dO,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int B, int H, int Hkv, int Sq,
                       int Sk, int causal, float scale) {
  using T = DqTile<D, CONS>;
  constexpr int STAGES = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + T::kQBytes;
  const uint32_t sKV = sdO + T::kQBytes;  // stage s: K tile, then V tile
  const uint32_t bars = sKV + STAGES * 2 * T::kKBytes;
  const uint32_t qbar = bars, full0 = bars + 8, empty0 = full0 + 8 * STAGES;

  // block -> (query tile, batch, head); the highest query tiles, which see
  // the most keys when causal, first
  const int n_qt = (Sq + T::kRows - 1) / T::kRows;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / (B * H))) * T::kRows;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const size_t qbase = ((size_t)b * H + h) * (size_t)Sq * D;
  const size_t kbase = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const int off = Sk - Sq;
  int nk = (Sk + STEP - 1) / STEP;
  if (causal) {
    const int last = q0 + T::kRows - 1 + off;  // last key a row here sees
    const int lim = last < 0 ? 0 : last / STEP + 1;
    nk = nk < lim ? nk : lim;
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 32);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 32);          // the producer's lanes
      hopper::mbar_init(empty0 + 8 * s, 4 * CONS);   // one per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * CONS) {
    // ---- producer
    load_tile<D, T::kRows>(sQ, q + qbase, q0, Sq, lane);
    load_tile<D, T::kRows>(sdO, dO + qbase, q0, Sq, lane);
    hopper::cp_async_arrive_noinc(qbar);
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES)
        hopper::mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
      const uint32_t kt = sKV + s * 2 * T::kKBytes;
      load_tile<D, STEP>(kt, k + kbase, i * STEP, Sk, lane);
      load_tile<D, STEP>(kt + T::kKBytes, v + kbase, i * STEP, Sk, lane);
      hopper::cp_async_arrive_noinc(full0 + 8 * s);
    }
    hopper::cp_async_wait_all();
    return;
  }

  // ---- consumers: warpgroup cw owns rows q0 + 64 cw .. + 63; in a wgmma
  // m64nN fragment thread t holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
  // columns 8 j + 2 (t % 4) (+ 1) at [4 j .. 4 j + 3]. Each step runs S and
  // dP, the softmax, then dq += dS K, and skips the key tiles that no row
  // here sees.
  const int cw = warp >> 2, wq = warp & 3;
  const int rlo = q0 + 64 * cw;
  const int rhi = (rlo + 63 < Sq ? rlo + 63 : Sq - 1);
  const int qi0 = rlo + wq * 16 + (lane >> 2), qi1 = qi0 + 8;
  const size_t rbase = ((size_t)b * H + h) * (size_t)Sq;
  constexpr float LOG2E = 1.4426950408889634f;
  const float sl2 = scale * LOG2E;
  // P = 2^(S * scale * log2(e) - lse * log2(e))
  const float ls0 = qi0 < Sq ? lse[rbase + qi0] * LOG2E : 0.f;
  const float ls1 = qi1 < Sq ? lse[rbase + qi1] * LOG2E : 0.f;
  const float dl0 = qi0 < Sq ? delta[rbase + qi0] : 0.f;
  const float dl1 = qi1 < Sq ? delta[rbase + qi1] : 0.f;

  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(qbar, 0);
  for (int i = 0; i < nk; ++i) {
    const int st = i % STAGES;
    const int k0 = i * STEP;
    hopper::mbar_wait(full0 + 8 * st, (i / STAGES) & 1);
    hopper::fence_proxy_async();
    const uint32_t kt = sKV + st * 2 * T::kKBytes, vt = kt + T::kKBytes;
    // warpgroup-uniform: does any row here see a key of this tile?
    if (rlo < Sq && (!causal || k0 <= rhi + off)) {
      // S = Q K^T, dP = dO V^T
      hopper::wgmma_fence();
      mma_ss2<D, T::kRows>(s, sQ, kt, dp, sdO, vt, 64 * cw);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(s);
      hopper::fence_operands(dp);

      // dS in place of S; the mask only where the tile crosses an edge
      const bool inner = rlo + 63 < Sq && k0 + STEP <= Sk &&
                         (!causal || k0 + STEP - 1 <= rlo + off);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = ex2(fmaf(s[4 * j + e], sl2, -ls0));
          float p1 = ex2(fmaf(s[4 * j + 2 + e], sl2, -ls1));
          if (!inner) {
            const int kj = k0 + 8 * j + 2 * (lane & 3) + e;
            const bool in = kj < Sk;
            if (!(in && qi0 < Sq && (!causal || kj <= qi0 + off))) p0 = 0.f;
            if (!(in && qi1 < Sq && (!causal || kj <= qi1 + off))) p1 = 0.f;
          }
          s[4 * j + e] = p0 * (dp[4 * j + e] - dl0) * scale;
          s[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1) * scale;
        }

      // dq += dS K with dS as hi + lo; K read N-major from the same tile
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        acc_to_a_split(hi[kk], lo[kk], s + 8 * kk);
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::mma_rs<D, STEP>(acc, hi[kk], kt, kk);
        hopper::mma_rs<D, STEP>(acc, lo[kk], kt, kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::fence_regs(hi[kk]);
        hopper::fence_regs(lo[kk]);
      }
    }
    if (lane == 0) hopper::mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    if (qi0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + qbase + (size_t)qi0 * D + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (qi1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + qbase + (size_t)qi1 * D + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// dk/dv: a block of CONS consumer warpgroups owns 64 * CONS key rows of one
// (batch, kv head) and walks the query tiles that can see them, for the
// query heads of one share of the GQA group (all of it when split == 1); a
// producer warp copies K and V once and each Q/dO tile with its lse and
// delta rows into a ring.
template <int D, int CONS>
struct DkvTile {
  static constexpr int kRows = 64 * CONS;
  static constexpr int kThreads = 128 * CONS + 32;
  static constexpr int kStages = 3;
  static constexpr int kKBytes = kRows * D * 2;     // sK, sV each
  static constexpr int kQBytes = STEP * D * 2;      // a Q or dO tile
  // Q tile, dO tile, lse and delta rows (fp32), padded to 1024 bytes
  static constexpr int kStageBytes = 2 * kQBytes + 1024;
  static constexpr int kSmem =
      1024 + 2 * kKBytes + kStages * kStageBytes + (1 + 2 * kStages) * 8;
};

template <int D, int CONS>
__global__ void __launch_bounds__(DkvTile<D, CONS>::kThreads, 1)
    flash_bwd_dkv_wgmma(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ partial, int B, int H, int Hkv,
                        int Sq, int Sk, int causal, float scale, int split) {
  using T = DkvTile<D, CONS>;
  constexpr int STAGES = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = sK + T::kKBytes;
  const uint32_t sStage = sV + T::kKBytes;  // stage s: Q, dO, lse, delta
  const uint32_t bars = sStage + STAGES * T::kStageBytes;
  const uint32_t kvbar = bars, full0 = bars + 8, empty0 = full0 + 8 * STAGES;

  // block -> (key tile, batch, kv head, share of the group); the lowest key
  // tiles, which the most query rows see when causal, first
  const int per = B * Hkv * split;
  const int k0 = (int)(blockIdx.x / per) * T::kRows;
  const int rest = blockIdx.x % per;
  const int share = rest % split, bhk = rest / split;
  const int hk = bhk % Hkv, b = bhk / Hkv;
  const int heads = H / Hkv / split;
  const int h0 = hk * (H / Hkv) + share * heads;
  const size_t kbase = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const int off = Sk - Sq;
  int m_first = 0;  // causal: the first query tile that sees key k0
  if (causal) {
    const int first = k0 - off;
    m_first = first <= 0 ? 0 : first / STEP;
  }
  const int nm = (Sq + STEP - 1) / STEP;
  const int per_head = nm > m_first ? nm - m_first : 0;
  const int steps = heads * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kvbar, 32);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 32);
      hopper::mbar_init(empty0 + 8 * s, 4 * CONS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * CONS) {
    // ---- producer
    load_tile<D, T::kRows>(sK, k + kbase, k0, Sk, lane);
    load_tile<D, T::kRows>(sV, v + kbase, k0, Sk, lane);
    hopper::cp_async_arrive_noinc(kvbar);
    for (int i = 0; i < steps; ++i) {
      const int h = h0 + i / per_head;
      const int m0 = (m_first + i % per_head) * STEP;
      const size_t qbase = ((size_t)b * H + h) * (size_t)Sq * D;
      const size_t rbase = ((size_t)b * H + h) * (size_t)Sq;
      const int s = i % STAGES;
      if (i >= STAGES)
        hopper::mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
      const uint32_t t = sStage + s * T::kStageBytes;
      load_tile<D, STEP>(t, q + qbase, m0, Sq, lane);
      load_tile<D, STEP>(t + T::kQBytes, dO + qbase, m0, Sq, lane);
      const uint32_t rows = t + 2 * T::kQBytes;
#pragma unroll
      for (int r = lane; r < STEP; r += 32) {
        const bool on = m0 + r < Sq;
        const size_t g = on ? rbase + m0 + r : 0;
        hopper::cp_async_4(rows + 4 * r, lse + g, on ? 4u : 0u);
        hopper::cp_async_4(rows + 4 * (STEP + r), delta + g, on ? 4u : 0u);
      }
      hopper::cp_async_arrive_noinc(full0 + 8 * s);
    }
    hopper::cp_async_wait_all();
    return;
  }

  // ---- consumers: warpgroup cw owns keys k0 + 64 cw .. + 63 (the rows of
  // S^T = K Q^T; the columns are the step's query rows). Each step runs
  // S^T and dP^T, the softmax, then dv and dk, and skips the query tiles
  // that see none of its keys. (Taking turns as dq does at D 64 would keep
  // P^T and dS^T of one step live beside S^T and dP^T of the next: 176
  // fp32 a thread with dk and dv, over the 168 a 288-thread block has.)
  const int cw = warp >> 2, wq = warp & 3;
  const int klo = k0 + 64 * cw;
  const int kj0 = klo + wq * 16 + (lane >> 2), kj1 = kj0 + 8;
  constexpr float LOG2E = 1.4426950408889634f;
  const float sl2 = scale * LOG2E;

  float dka[D / 2], dva[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  hopper::mbar_wait(kvbar, 0);
  for (int i = 0; i < steps; ++i) {
    const int m0 = (m_first + i % per_head) * STEP;
    const int s = i % STAGES;
    hopper::mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    hopper::fence_proxy_async();
    const uint32_t tq = sStage + s * T::kStageBytes, tdo = tq + T::kQBytes;
    const int mhi = (m0 + STEP - 1 < Sq ? m0 + STEP - 1 : Sq - 1);
    // warpgroup-uniform: does a query row of this tile see a key here?
    if (klo < Sk && (!causal || klo <= mhi + off)) {
      // S^T = K Q^T, dP^T = V dO^T
      hopper::wgmma_fence();
      mma_ss2<D, T::kRows>(st, sK, tq, dpt, sV, tdo, 64 * cw);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(st);
      hopper::fence_operands(dpt);

      // P^T in st, dS^T in dpt; lse and delta by column (query row)
      const float* sL = reinterpret_cast<const float*>(
          smem_raw + (tq - raw) + 2 * T::kQBytes);
      const float* sDl = sL + STEP;
      const bool inner = klo + 63 < Sk && m0 + STEP <= Sq &&
                         (!causal || klo + 63 <= m0 + off);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cq = 8 * j + 2 * (lane & 3) + e;
          const float l = sL[cq] * LOG2E, dl = sDl[cq];
          float p0 = ex2(fmaf(st[4 * j + e], sl2, -l));
          float p1 = ex2(fmaf(st[4 * j + 2 + e], sl2, -l));
          if (!inner) {
            const int qi = m0 + cq;
            const bool in = qi < Sq;
            if (!(in && kj0 < Sk && (!causal || kj0 <= qi + off))) p0 = 0.f;
            if (!(in && kj1 < Sk && (!causal || kj1 <= qi + off))) p1 = 0.f;
          }
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dl) * scale;
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dl) * scale;
        }

      // dv += P^T dO, dk += dS^T Q (dS^T as hi + lo); dO and Q read
      // N-major from the same tiles
      uint32_t pa[4][4], hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], st + 8 * kk);
        acc_to_a_split(hi[kk], lo[kk], dpt + 8 * kk);
      }
      hopper::fence_operands(dka);
      hopper::fence_operands(dva);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::mma_rs<D, STEP>(dva, pa[kk], tdo, kk);
        hopper::mma_rs<D, STEP>(dka, hi[kk], tq, kk);
        hopper::mma_rs<D, STEP>(dka, lo[kk], tq, kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(dka);
      hopper::fence_operands(dva);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::fence_regs(pa[kk]);
        hopper::fence_regs(hi[kk]);
        hopper::fence_regs(lo[kk]);
      }
    }
    if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
  }

  // split == 1: dk, dv rounded once. Else fp32 partials of this share,
  // partial[0 = dk, 1 = dv][b][hk][share][Sk][D], for the group sum.
  const size_t pstride = (size_t)B * Hkv * split * Sk * D;
  const size_t pbase = ((size_t)bhk * split + share) * (size_t)Sk * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kj = half ? kj1 : kj0;
      if (kj >= Sk) continue;
      const float k0v = dka[4 * j + 2 * half], k1v = dka[4 * j + 2 * half + 1];
      const float v0v = dva[4 * j + 2 * half], v1v = dva[4 * j + 2 * half + 1];
      if (split == 1) {
        const size_t g = kbase + (size_t)kj * D + col;
        *reinterpret_cast<uint32_t*>(dk + g) = pack_bf16(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dv + g) = pack_bf16(v0v, v1v);
      } else {
        const size_t g = pbase + (size_t)kj * D + col;
        *reinterpret_cast<float2*>(partial + g) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(partial + pstride + g) =
            make_float2(v0v, v1v);
      }
    }
  }
}

// The group sum behind a split launch: dk[b, hk] = sum over the shares s =
// 0, 1, ... of partial[0][b][hk][s], in that order, rounded once; dv alike
// from partial[1]. Four consecutive elements a thread.
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_group_sum(const float* __restrict__ partial,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            long long n4, int row4, int split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long long bhk = i / row4, rem = i % row4;
  const float4* pk =
      reinterpret_cast<const float4*>(partial) + bhk * split * row4 + rem;
  const float4* pv = pk + n4 * split;
  float4 a = pk[0], c = pv[0];
  for (int s = 1; s < split; ++s) {
    const float4 x = pk[(long long)s * row4], y = pv[(long long)s * row4];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  uint2 ko, vo;
  ko.x = pack_bf16(a.x, a.y);
  ko.y = pack_bf16(a.z, a.w);
  vo.x = pack_bf16(c.x, c.y);
  vo.y = pack_bf16(c.z, c.w);
  reinterpret_cast<uint2*>(dk)[i] = ko;
  reinterpret_cast<uint2*>(dv)[i] = vo;
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

template <int D, int CONS>
cudaError_t launch_dq_wgmma(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* dO, const float* lse,
                            const float* delta, bf16* dq, int B, int H,
                            int Hkv, int Sq, int Sk, int causal, float scale,
                            cudaStream_t stream) {
  using T = DqTile<D, CONS>;
  const long long blocks =
      (long long)((Sq + T::kRows - 1) / T::kRows) * B * H;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = prepare(flash_bwd_dq_wgmma<D, CONS>, T::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma<D, CONS><<<(unsigned)blocks, T::kThreads, T::kSmem,
                                stream>>>(q, k, v, dO, lse, delta, dq, B, H,
                                          Hkv, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

template <int D, int CONS>
cudaError_t launch_dkv_wgmma(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* dO, const float* lse,
                             const float* delta, bf16* dk, bf16* dv,
                             float* partial, int B, int H, int Hkv, int Sq,
                             int Sk, int causal, float scale, int split,
                             cudaStream_t stream) {
  using T = DkvTile<D, CONS>;
  const long long blocks =
      (long long)((Sk + T::kRows - 1) / T::kRows) * B * Hkv * split;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = prepare(flash_bwd_dkv_wgmma<D, CONS>, T::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma<D, CONS><<<(unsigned)blocks, T::kThreads, T::kSmem,
                                 stream>>>(q, k, v, dO, lse, delta, dk, dv,
                                           partial, B, H, Hkv, Sq, Sk,
                                           causal, scale, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long long n4 = (long long)B * Hkv * Sk * D / 4;
  const long long grid = (n4 + 255) / 256;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  flash_bwd_dkv_group_sum<<<(unsigned)grid, 256, 0, stream>>>(
      partial, dk, dv, n4, Sk * D / 4, split);
  return cudaGetLastError();
}

template <int D>
int launch_dq_fma(const void* q, const void* k, const void* v, const void* dO,
                  const void* lse, const void* delta, void* dq, int B, int H,
                  int Hkv, int Sq, int Sk, int causal, float scale,
                  cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const size_t smem = dq_fma_smem<D>();
  cudaError_t err = prepare(flash_bwd_dq_fma<D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_fma<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_fma(const void* q, const void* k, const void* v,
                   const void* dO, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
                   int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Sk + BKV - 1) / BKV, Hkv, B);
  const size_t smem = dkv_fma_smem<D>();
  cudaError_t err = prepare(flash_bwd_dkv_fma<D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_fma<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Sq, Sk,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dO, dq (B,H,Sq,D); k, v, dk, dv (B,Hkv,Sk,D); lse, delta (B,H,Sq)
// fp32. All contiguous, 16-byte aligned, on the current device; q, k, v,
// dO and the outputs share one dtype: 0 = fp32, 1 = bf16. D: 64 or 128.
// The wrapper picks the variant by shape (flash_bwd_plan) and passes it:
// variant 0, the FMA kernels: fp32 only, rows 64, split 1; variant 1,
// wgmma: bf16 only, rows the query rows of a dq block (64 at D 64, 128
// at D 128) or the key rows of a dk/dv block (128 at D 64, 64 at D 128),
// split a divisor of H / Hkv. With split > 1, `partial` is fp32 scratch of 2 * B * Hkv * split * Sk * D
// elements, 16-byte aligned, and a second launch sums the group's shares.
// Anything else returns cudaErrorInvalidValue before a launch. Each
// returns the first launch error (0 on success).
int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dO, const void* lse, const void* delta,
                    void* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
                    int causal, float scale, int dtype, int variant, int rows,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0 && dtype == 0 && rows == BQ) {
    if (D == 64)
      return launch_dq_fma<64>(q, k, v, dO, lse, delta, dq, B, H, Hkv, Sq,
                               Sk, causal, scale, s);
    if (D == 128)
      return launch_dq_fma<128>(q, k, v, dO, lse, delta, dq, B, H, Hkv, Sq,
                                Sk, causal, scale, s);
  }
  if (variant != 1 || dtype != 1) return (int)cudaErrorInvalidValue;
  const bf16 *bq = static_cast<const bf16*>(q),
             *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v),
             *bo = static_cast<const bf16*>(dO);
  const float *l = static_cast<const float*>(lse),
              *dl = static_cast<const float*>(delta);
  bf16* out = static_cast<bf16*>(dq);
  if (D == 64 && rows == 64)
    return (int)launch_dq_wgmma<64, 1>(bq, bk, bv, bo, l, dl, out, B, H,
                                       Hkv, Sq, Sk, causal, scale, s);
  if (D == 128 && rows == 128)
    return (int)launch_dq_wgmma<128, 2>(bq, bk, bv, bo, l, dl, out, B, H,
                                        Hkv, Sq, Sk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dO, const void* lse, const void* delta,
                     void* dk, void* dv, void* partial, int B, int H,
                     int Hkv, int Sq, int Sk, int D, int causal, float scale,
                     int dtype, int variant, int rows, int split,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0 && dtype == 0 && rows == BKV && split == 1) {
    if (D == 64)
      return launch_dkv_fma<64>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv,
                                Sq, Sk, causal, scale, s);
    if (D == 128)
      return launch_dkv_fma<128>(q, k, v, dO, lse, delta, dk, dv, B, H, Hkv,
                                 Sq, Sk, causal, scale, s);
  }
  if (variant != 1 || dtype != 1 || Hkv < 1 || split < 1 ||
      (H / Hkv) % split != 0 || (split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const bf16 *bq = static_cast<const bf16*>(q),
             *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v),
             *bo = static_cast<const bf16*>(dO);
  const float *l = static_cast<const float*>(lse),
              *dl = static_cast<const float*>(delta);
  bf16 *ok = static_cast<bf16*>(dk), *ov = static_cast<bf16*>(dv);
  float* part = static_cast<float*>(partial);
  if (D == 64 && rows == 128)
    return (int)launch_dkv_wgmma<64, 2>(bq, bk, bv, bo, l, dl, ok, ov, part,
                                        B, H, Hkv, Sq, Sk, causal, scale,
                                        split, s);
  if (D == 128 && rows == 64)
    return (int)launch_dkv_wgmma<128, 1>(bq, bk, bv, bo, l, dl, ok, ov, part,
                                         B, H, Hkv, Sq, Sk, causal, scale,
                                         split, s);
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
