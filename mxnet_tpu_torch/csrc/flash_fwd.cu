// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/parallel/flash_attention.py::_fwd_kernel
// (launched by _pallas_forward). It computes the same function: for each
// query row, an online softmax over K/V tiles with fp32 running max, sum and
// accumulator; causal masking with the (Sk - Sq) diagonal offset; GQA (query
// head h reads key/value head h / (H / Hkv)); any sequence length through
// bounds masks; masked logits at -1e30 as in the TPU kernel; the output in
// the inputs' type and the per-row log-sum-exp in fp32 (natural log), with
// the l == 0 -> 1 guard of the TPU kernel's epilogue.
//
// Masking. An entry (query i, key j) takes part when j < Sk and, if causal,
// j <= i + (Sk - Sq); every other entry has P = 0 exactly, which for a row
// with a visible key is what exp(-1e30 - max) gives. A row with no visible
// key at all (causal with Sq > Sk) has l = 0, so o = 0 and lse = -1e30
// whatever tiles are visited; the plain version (_ref_forward) and the
// backward kernels follow the same rule.
//
// Design: a warp-specialised, persistent wgmma kernel for bf16 (the main
// paths' type), an FMA kernel for fp32. The TPU kernel runs a sequential
// grid axis over the K tiles with the accumulators in VMEM scratch. Here
// each block stays on one SM and walks work items, each one (batch, head,
// 128 query rows) over the 128-row K/V tiles its rows can see:
//
// * Roles. Two consumer warpgroups own 64 query rows each; one producer
//   warpgroup copies. setmaxnreg moves registers from the producer (40 a
//   thread) to the consumers (216), which hold O (64 x D fp32), S (64 x 128
//   fp32) and P (bf16 A fragments) at once.
// * Loads. One producer thread copies each item's Q into one of two slots
//   and its K and V tiles into two rings of two stages with TMA
//   (cp.async.bulk.tensor through tensor maps of q, k and v, 3-D: D, S,
//   batch x head), 128-byte swizzled in the layout hopper.cuh describes;
//   every slot has a full mbarrier, which the copy's bytes complete,
//   and an empty one. A K tile is released once S has read it, a V tile
//   once P V has, a Q slot at the end of its item, so the next tiles and
//   the next item's Q load under the current products and epilogue. Rows
//   past Sq or Sk read as zeros (the map's bounds), so ragged tiles need no
//   second path. TMA rather than the backward's cp.async: with 128 rows an
//   item every key tile is read from L2 once per 128 query rows, and 16-byte
//   cp.async copies of those tiles took most of the kernel's time on their
//   own, where bulk copies took about half as long (PERF.md). The tensor
//   maps are encoded on the host for each launch, with
//   cuTensorMapEncodeTiled found through the CUDA runtime (no link against
//   libcuda). Every mbarrier wait traps after its poll limit, so a
//   pipeline fault fails the launch instead of holding the card.
// * Products. S = Q K^T is an SS wgmma m64n128 with both operands K-major
//   (imm-trans-b 0). O += P V is an RS wgmma: P is re-packed from the S
//   accumulator into bf16 A fragments (acc_to_a; P rounded to bf16 as the
//   plain version rounds its probabilities to V's type), and V is read
//   N-major from the same tile through imm-trans-b 1, so no transposed
//   copy of V exists.
// * Overlap, as in FlashAttention-3. Within a warpgroup: it issues S_i =
//   Q K_i^T and O += P_{i-1} V_{i-1} back to back, waits for S_i alone and
//   runs tile i's softmax while P_{i-1} V_{i-1} is still on the tensor
//   cores; then it waits for O, rescales it and re-packs P_i. Between the
//   two: they take turns to issue their products (an mbarrier each, passed
//   back and forth), so one's softmax runs under the other's products.
//   Each warpgroup takes nk + 1 turns an item (nk: the item's key tiles),
//   with empty turns for the tiles its rows do not see, so the turns stay
//   paired whatever the causal mask.
// * Softmax. Logits are masked only in tiles that cross an edge (Sk, or
//   the causal diagonal); the running max is kept in log2 units and
//   P = 2^(S scale log2 e - max) on the special-function unit (ex2.approx);
//   each thread keeps partial row sums, reduced across the row's 4 lanes
//   once at the end.
// * Scheduling. One block an SM (at most one an item). Items are ordered
//   heaviest first under causal masking (the last query tiles), and block
//   j of G takes items j, 2G - 1 - j, 2G + j, ... (a snake), so the heavy
//   and light items spread evenly. A warpgroup walks only the key tiles
//   its rows see and releases the item's others unread. Deterministic: no
//   atomics, every output element written by one thread, two launches
//   bit-equal.
// * The group's query heads stay in separate items. At the main paths'
//   shapes an item's 128 rows of one head already share each K/V tile 128
//   ways. Where Sq per head is short (a GQA prefill of 16 tokens) the time
//   is the serial walk of the key tiles on a few SMs, which packing the
//   group's heads into one item would not shorten (fewer items, the same
//   walk); splitting the key range across blocks would.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): two products of
// 2 B H Sq Sk D flops, halved when causal, against q, k, v read once and o
// written once. Long causal prefills and training shapes (S 1024-2048) are
// bound by operations, BERT's 128-token sequences by bytes. Measured
// (chip_smoke.py, one H100 at 700 W, device time): 0.0148 ms at B 4, H 12,
// S 512, D 64, causal (3.9x its bytes bound); 0.079 at B 1, H 32/8, S 2048,
// D 128, causal (2.3x its operations bound, level with SDPA); 0.045 at
// BERT-base's B 128, S 128 (1.5x its bytes bound). Left on the
// table: the SS product re-reads Q from shared memory for every key tile;
// the epilogue stores o from registers 4 bytes a thread, not by TMA; a
// short Sq leaves most SMs idle (see above).
//
// The fp32 kernel: fp32 FMA on tiles staged in shared memory, so fp32
// inputs keep full fp32 products (tensor-core TF32 would keep ~3 decimal
// digits). Thread t owns rows 4*(t/8)..+3 and key columns (t%8) + 8*j; K is
// stored transposed and rows padded by one word for conflict-free reads.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // fp32: query rows per block
constexpr int BK = 64;        // fp32: key rows per tile
constexpr int THREADS = 128;  // fp32: 4 warps
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

using hopper::acc_to_a;
using hopper::ex2;
using hopper::kmajor_desc;
using hopper::pack_bf16;

// ------------------------------------------------------------ bf16, wgmma
// (the design is in the note at the top of this file)
template <int D>
struct FwdTile {
  static constexpr int kRows = 128;                // query rows an item
  static constexpr int kBK = 128;                  // key rows a tile
  static constexpr int kThreads = 384;             // 2 consumers + producer
  static constexpr int kStages = 2;                // Q slots, K/V stages
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKBytes = kBK * D * 2;      // a K or V tile
  // registers a thread: 384 x 168 at launch; the producer gives up all but
  // 40, and the consumers take 216 of what it frees (2 * 216 + 40 <= 3 * 168)
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 216;
  // alignment slack, the Q slots, the K ring, the V ring, then the
  // mbarriers: qfull[], qempty[], kfull[], kempty[], vfull[], vempty[]
  // (kStages each) and turn[2]
  static constexpr int kBarBytes = (2 + 6 * kStages) * 8;
  static constexpr int kSmem =
      1024 + kStages * kQBytes + 2 * kStages * kKBytes + kBarBytes;
};

// s (64 x N) = rows row0.. of the Q tile (R rows) * the K tile (N rows)^T,
// both K-major, over K = D
template <int D, int R, int N>
__device__ __forceinline__ void mma_qk(float (&s)[N / 2], uint32_t sq,
                                       uint32_t kt, int row0) {
  static_assert(N == 128, "S is m64n128");
  hopper::wgmma_m64n128k16_bf16_kk_first(s, kmajor_desc<R>(sq, row0, 0),
                                         kmajor_desc<N>(kt, 0, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    hopper::wgmma_m64n128k16_bf16_kk(s, kmajor_desc<R>(sq, row0, kk),
                                     kmajor_desc<N>(kt, 0, kk));
}

// o (64 x D) += P (64 x N, bf16 A fragments) * the V tile (N rows), read
// N-major
template <int D, int N>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const uint32_t (&p)[N / 16][4],
                                       uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) hopper::mma_rs<D, N>(o, p[kk], vt, kk);
}

// One tile's softmax in place: s (the m64nN fragment of S for rows qi0 and
// qi0 + 8, keys k0..) becomes P = 2^(S sl2 - max) in fp32, with masked
// entries at exactly 0; m (the running max, log2 units, -inf before any
// visible key) and l (this thread's partial row sums) move on, and alpha
// holds the factor by which each row's output must be rescaled.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int qi0, int Sk, int off,
                                             int causal, bool edge, int lane,
                                             float sl2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * (lane & 3) + e;
        const bool in = kj < Sk;
        if (!(in && (!causal || kj <= qi0 + off))) s[4 * j + e] = -INFINITY;
        if (!(in && (!causal || kj <= qi0 + 8 + off)))
          s[4 * j + 2 + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[0] = fmaxf(mx[0], s[4 * j + e]);
      mx[1] = fmaxf(mx[1], s[4 * j + 2 + e]);
    }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * sl2);
    // a row with no visible key so far takes base 0: its masked entries
    // (-inf) give exactly 0, and so does its rescale factor
    base[r] = mn == -INFINITY ? 0.f : mn;
    alpha[r] = ex2(m[r] - base[r]);
    m[r] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -base[0]));
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], sl2, -base[1]));
      sum[0] += s[4 * j + e];
      sum[1] += s[4 * j + 2 + e];
    }
  l[0] = alpha[0] * l[0] + sum[0];
  l[1] = alpha[1] * l[1] + sum[1];
}

// The key tiles (of N rows) that query rows up to `hi` (< Sq) see
template <int N>
__device__ __forceinline__ int tiles_upto(int hi, int Sq, int Sk,
                                          int causal) {
  const int n = (Sk + N - 1) / N;
  if (!causal) return n;
  const int last = hi + Sk - Sq;  // the last key row `hi` sees
  const int lim = last < 0 ? 0 : last / N + 1;
  return n < lim ? n : lim;
}

// The work items in the order a block walks them: block j of G takes, in
// round r, item r G + j (r even) or r G + G - 1 - j (r odd), so that the
// heaviest items (the first, under causal masking) spread evenly. Item n
// is (query tile n_qt - 1 - n / (B H), batch and head n % (B H)).
struct Item {
  int q0, b, h, nk;
};

template <int D>
__device__ __forceinline__ bool item_of(int r, int n_items, int B, int H,
                                        int Sq, int Sk, int causal,
                                        Item& it) {
  constexpr int R = FwdTile<D>::kRows, N = FwdTile<D>::kBK;
  const int G = gridDim.x, j = blockIdx.x;
  const int n = r * G + ((r & 1) ? G - 1 - j : j);
  if (n >= n_items) return false;
  const int n_qt = (Sq + R - 1) / R;
  const int bh = n % (B * H);
  it.q0 = (n_qt - 1 - n / (B * H)) * R;
  it.h = bh % H;
  it.b = bh / H;
  it.nk = tiles_upto<N>((it.q0 + R < Sq ? it.q0 + R : Sq) - 1, Sq, Sk,
                        causal);
  return true;
}

// tq, tk, tv: tensor maps of q (D, Sq, B H), k and v (D, Sk, B Hkv), read
// in boxes of 64 columns x 128 rows, 128-byte swizzled (tile_map)
template <int D>
__global__ void __launch_bounds__(FwdTile<D>::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, float* __restrict__ lse, int B,
                    int H, int Hkv, int Sq, int Sk, int causal, float scale) {
  using T = FwdTile<D>;
  constexpr int STAGES = T::kStages;
  constexpr int R = T::kRows, N = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                        // slot s at s * kQBytes
  const uint32_t sK = sQ + STAGES * T::kQBytes;    // stage s at s * kKBytes
  const uint32_t sV = sK + STAGES * T::kKBytes;
  const uint32_t bars = sV + STAGES * T::kKBytes;
  const uint32_t qfull = bars, qempty = qfull + 8 * STAGES;
  const uint32_t kfull = qempty + 8 * STAGES, kempty = kfull + 8 * STAGES;
  const uint32_t vfull = kempty + 8 * STAGES, vempty = vfull + 8 * STAGES;
  const uint32_t turn0 = vempty + 8 * STAGES;  // turn[0], turn[1]
  const int n_items = ((Sq + R - 1) / R) * B * H;
  const int off = Sk - Sq;

  if (threadIdx.x == 0) {
    // full: the producer's one arrival (with the copies' bytes); empty:
    // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(qfull + 8 * s, 1);
      hopper::mbar_init(qempty + 8 * s, 8);
      hopper::mbar_init(kfull + 8 * s, 1);
      hopper::mbar_init(kempty + 8 * s, 8);
      hopper::mbar_init(vfull + 8 * s, 1);
      hopper::mbar_init(vempty + 8 * s, 8);
    }
    // turn[w]: warpgroup w may issue its products; one arrival per warp
    // of the other warpgroup
    hopper::mbar_init(turn0, 4);
    hopper::mbar_init(turn0 + 8, 4);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Item it;
  if (warp >= 8) {
    // ---- producer warpgroup: one thread issues every copy
    hopper::setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x != 256) return;
    int t = 0;  // K/V tiles loaded so far
    for (int r = 0, n = 0; item_of<D>(r, n_items, B, H, Sq, Sk, causal, it);
         ++r, ++n) {
      const int bh = it.b * H + it.h;
      const int bhk = it.b * Hkv + it.h / (H / Hkv);
      const int qs = n % STAGES;
      if (n >= STAGES)
        hopper::mbar_wait(qempty + 8 * qs, ((n / STAGES) - 1) & 1);
      hopper::mbar_arrive_expect_tx(qfull + 8 * qs, T::kQBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        hopper::tma_load_3d(sQ + qs * T::kQBytes + cb * (R * 128), &tq,
                            64 * cb, it.q0, bh, qfull + 8 * qs);
      for (int i = 0; i < it.nk; ++i, ++t) {
        const int s = t % STAGES;
        const uint32_t par = ((t / STAGES) - 1) & 1;
        if (t >= STAGES) hopper::mbar_wait(kempty + 8 * s, par);
        hopper::mbar_arrive_expect_tx(kfull + 8 * s, T::kKBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          hopper::tma_load_3d(sK + s * T::kKBytes + cb * (N * 128), &tk,
                              64 * cb, i * N, bhk, kfull + 8 * s);
        if (t >= STAGES) hopper::mbar_wait(vempty + 8 * s, par);
        hopper::mbar_arrive_expect_tx(vfull + 8 * s, T::kKBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          hopper::tma_load_3d(sV + s * T::kKBytes + cb * (N * 128), &tv,
                              64 * cb, i * N, bhk, vfull + 8 * s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows q0 + 64 cw .. + 63 of each
  // item; in a wgmma m64nN fragment thread t holds rows 16 (t / 32) +
  // (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) at [4 j .. 4 j + 3].
  hopper::setmaxnreg_inc<T::kConsumerRegs>();
  const int cw = warp >> 2, wq = warp & 3;
  const float sl2 = scale * LOG2E;
  auto wait_k = [&](int t) {
    hopper::mbar_wait(kfull + 8 * (t % STAGES), (t / STAGES) & 1);
  };
  auto wait_v = [&](int t) {
    hopper::mbar_wait(vfull + 8 * (t % STAGES), (t / STAGES) & 1);
  };
  auto free_k = [&](int t) {
    if (lane == 0) hopper::mbar_arrive(kempty + 8 * (t % STAGES));
  };
  auto free_v = [&](int t) {
    if (lane == 0) hopper::mbar_arrive(vempty + 8 * (t % STAGES));
  };
  auto ktile = [&](int t) { return sK + (t % STAGES) * T::kKBytes; };
  auto vtile = [&](int t) { return sV + (t % STAGES) * T::kKBytes; };
  int turns = 0;  // turns this warpgroup has taken
  auto take_turn = [&]() { hopper::mbar_wait(turn0 + 8 * cw, turns & 1); };
  auto pass_turn = [&]() {
    if (lane == 0) hopper::mbar_arrive(turn0 + 8 * (1 - cw));
    ++turns;
  };
  if (cw == 1 && lane == 0) hopper::mbar_arrive(turn0);  // 0 goes first

  int t = 0;  // K/V tiles consumed so far
  for (int r = 0, n = 0; item_of<D>(r, n_items, B, H, Sq, Sk, causal, it);
       ++r, ++n) {
    const int rlo = it.q0 + 64 * cw;
    const int qi0 = rlo + wq * 16 + (lane >> 2), qi1 = qi0 + 8;
    // the key tiles this warpgroup's rows see, a prefix of the item's
    const int nw =
        rlo < Sq ? tiles_upto<N>(rlo + 63 < Sq ? rlo + 63 : Sq - 1, Sq, Sk,
                                 causal)
                 : 0;
    // does tile i cross an edge for these rows (warpgroup-uniform)?
    auto edge = [&](int i) {
      return (i + 1) * N > Sk || (causal && (i + 1) * N - 1 > rlo + off);
    };
    const int qs = n % STAGES;
    const uint32_t sq = sQ + qs * T::kQBytes;
    float acc[D / 2], s[N / 2], m[2] = {-INFINITY, -INFINITY},
                                l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pa[N / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(qfull + 8 * qs, (n / STAGES) & 1);
    if (nw > 0) {
      // tile 0: S_0, its softmax, P_0
      wait_k(t);
      hopper::fence_proxy_async();
      take_turn();
      hopper::wgmma_fence();
      mma_qk<D, R, N>(s, sq, ktile(t), 64 * cw);
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(s);
      free_k(t);
      softmax_tile<N>(s, m, l, alpha, 0, qi0, Sk, off, causal, edge(0), lane,
                      sl2);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) acc_to_a(pa[kk], s + 8 * kk);

      for (int i = 1; i < nw; ++i) {
        // S_i and P_{i-1} V_{i-1} in flight together; tile i's softmax
        // runs while the second is on the tensor cores
        wait_k(t + i);
        wait_v(t + i - 1);
        hopper::fence_proxy_async();
        hopper::fence_operands(acc);
        take_turn();
        hopper::wgmma_fence();
        mma_qk<D, R, N>(s, sq, ktile(t + i), 64 * cw);
        hopper::wgmma_commit();
        mma_pv<D, N>(acc, pa, vtile(t + i - 1));
        hopper::wgmma_commit();
        pass_turn();
        hopper::wgmma_wait<1>();
        hopper::fence_operands(s);
        free_k(t + i);
        softmax_tile<N>(s, m, l, alpha, i * N, qi0, Sk, off, causal, edge(i),
                        lane, sl2);
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) hopper::fence_regs(pa[kk]);
        free_v(t + i - 1);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) acc_to_a(pa[kk], s + 8 * kk);
      }

      // the last P V
      wait_v(t + nw - 1);
      hopper::fence_proxy_async();
      hopper::fence_operands(acc);
      take_turn();
      hopper::wgmma_fence();
      mma_pv<D, N>(acc, pa, vtile(t + nw - 1));
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) hopper::fence_regs(pa[kk]);
      free_v(t + nw - 1);
    }
    // the item's tiles that no row here sees: released unread, in order
    for (int i = nw; i < it.nk; ++i) {
      wait_k(t + i);
      free_k(t + i);
      wait_v(t + i);
      free_v(t + i);
      take_turn();
      pass_turn();
    }
    if (nw == 0 && it.nk > 0) {
      // the turn of the last P V: every warpgroup takes it.nk + 1 turns
      take_turn();
      pass_turn();
    }
    t += it.nk;
    if (lane == 0) hopper::mbar_arrive(qempty + 8 * qs);

    // o = acc / l (l == 0 -> 1: rows with no visible key read 0), lse =
    // max + ln(l) in natural units (-1e30 where l == 0)
    const size_t qbase = ((size_t)it.b * H + it.h) * (size_t)Sq * D;
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      if (qi0 < Sq)
        *reinterpret_cast<uint32_t*>(o + qbase + (size_t)qi0 * D + col) =
            pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
      if (qi1 < Sq)
        *reinterpret_cast<uint32_t*>(o + qbase + (size_t)qi1 * D + col) =
            pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
    }
    if ((lane & 3) == 0) {
      const size_t row = ((size_t)it.b * H + it.h) * Sq;
      if (qi0 < Sq)
        lse[row + qi0] = l[0] == 0.f ? NEG_INF : m[0] * LN2 + logf(l[0]);
      if (qi1 < Sq)
        lse[row + qi1] = l[1] == 0.f ? NEG_INF : m[1] * LN2 + logf(l[1]);
    }
  }
}

// ------------------------------------------------------------------ fp32, FMA
template <int D>
constexpr size_t fma_smem_bytes() {
  // sQ [BQ][D+1] + sKt [D][BK+1] + sV [BK][D] + sP [BQ][BK+1], fp32
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int Hkv, int Sq,
                         int Sk, int causal, float scale) {
  constexpr int QS = D + 1;   // padded row strides
  constexpr int KS = BK + 1;
  constexpr int PS = BK + 1;
  constexpr int DC = D / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKt = sQ + BQ * QS;  // K tile, transposed: [d][key]
  float* sV = sKt + D * KS;
  float* sP = sV + BK * D;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;    // this thread's rows: rg*4 .. rg*4+3
  const int cg = tid & 7;     // this thread's columns: cg + 8*j
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const size_t qbase = ((size_t)b * H + h) * (size_t)Sq * D;
  const size_t kbase = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const int off = Sk - Sq;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    sQ[r * QS + d] = (q0 + r < Sq) ? q[qbase + (size_t)(q0 + r) * D + d] : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + BK - 1) / BK;
  if (causal) {
    // the last key any row of this tile may see is q0 + BQ - 1 + off
    const int last = q0 + BQ - 1 + off;
    const int lim = last < 0 ? 0 : last / BK + 1;
    nk = nk < lim ? nk : lim;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool ok = k0 + c < Sk;
      const size_t g = kbase + (size_t)(k0 + c) * D + d;
      sKt[d * KS + c] = ok ? k[g] : 0.f;
      sV[c * D + d] = ok ? v[g] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sKt[d * KS + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + cg + 8 * j;
        const bool valid = kj < Sk && (!causal || kj <= qi + off);
        s[i][j] = valid ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // masked: exactly 0, also in a row that has seen no key yet (whose
        // max is still NEG_INF)
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        sP[(rg * 4 + i) * PS + cg + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // sP complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) vv[jj] = sV[c * D + cg + 8 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      o[qbase + (size_t)qi * D + cg + 8 * jj] = acc[i][jj] / ls;
    if (cg == 0) lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(ls);
  }
}

// ----------------------------------------------------------------- launch
// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t tensor_map_encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A map of `heads` matrices of S rows x D bf16 (contiguous, one after the
// other) as a 3-D tensor (D, S, heads), read in boxes of 64 columns x
// `rows` rows, 128-byte swizzled (the tile layout hopper.cuh describes);
// rows past S read as zeros.
cudaError_t tile_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                     int D, int S, long long heads, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Hkv, int Sq, int Sk,
                         int causal, float scale, cudaStream_t stream) {
  using T = FwdTile<D>;
  const long long items =
      (long long)((Sq + T::kRows - 1) / T::kRows) * B * H;
  if (items > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  EncodeTiled encode = nullptr;
  CUtensorMap tq, tk, tv;
  int dev = 0, sms = 0;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err == cudaSuccess)
    err = tile_map(encode, &tq, q, D, Sq, (long long)B * H, T::kRows);
  if (err == cudaSuccess)
    err = tile_map(encode, &tk, k, D, Sk, (long long)B * Hkv, T::kBK);
  if (err == cudaSuccess)
    err = tile_map(encode, &tv, v, D, Sk, (long long)B * Hkv, T::kBK);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
  if (err != cudaSuccess) return err;
  // one block an SM, each walking its share of the items
  const int blocks = items < sms ? (int)items : sms;
  flash_fwd_wgmma<D><<<blocks, T::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), B, H, Hkv,
      Sq, Sk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int Sq, int Sk,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_fma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,H,Sq,D), k and v (B,Hkv,Sk,D), o like q, lse (B,H,Sq) fp32; all
// contiguous, 16-byte aligned, on the current device. dtype: 0 = fp32,
// 1 = bf16. D: 64 or 128. The wrapper picks the variant by shape
// (flash_fwd_plan) and passes it: variant 0, the FMA kernel: fp32 only,
// rows 64; variant 1, wgmma: bf16 only, rows 128 (the query rows of a
// work item). Anything else returns cudaErrorInvalidValue before a launch.
// Returns the launch's cudaError_t (0 on success).
int mx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
                 int causal, float scale, int dtype, int variant, int rows,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0 && dtype == 0 && rows == BQ) {
    if (D == 64)
      return (int)launch_fma<64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
                                 scale, s);
    if (D == 128)
      return (int)launch_fma<128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
                                  scale, s);
  }
  if (variant != 1 || dtype != 1) return (int)cudaErrorInvalidValue;
  if (rows != 128) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)launch_wgmma<64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
                                 scale, s);
  if (D == 128)
    return (int)launch_wgmma<128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
                                  scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
