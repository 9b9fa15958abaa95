// Hopper (sm_90a) building blocks shared by the port's kernels: shared-
// memory addresses, mbarriers, cp.async with zero fill and an mbarrier
// arrival on completion, the async-proxy fence, warpgroup MMA (wgmma) with
// A and B read from shared memory through descriptors, and named barriers;
// for the flash-attention kernels also 4-byte cp.async, TMA tensor copies
// completing on an mbarrier, setmaxnreg, wgmma with B K-major
// (imm-trans-b 0), wgmma with A from registers, and the tile helpers both
// flash sources share (ex2, the accumulator-to-A re-pack, the swizzled
// tile layout's two descriptors); for the persistent kernels of
// segment_sum.cu and cbr_train_bwd.cu cp.async groups and a grid barrier.
// Plain inline PTX; no PyTorch or CUTLASS headers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the other threads and to the
// async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed (the barrier's
// current phase parity differs from it). A pipeline waits microseconds; a
// wait that outlasts 2^26 polls is a deadlock, and traps (the launch fails
// with an error the host reads) rather than holding the card forever.
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls == (1u << 26)) __trap();
}

// -------------------------------------------------------------- cp.async
// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes 16 zero bytes
// and reads nothing
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued so far has
// landed (noinc: the arrival is one of the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// commit this thread's cp.async copies issued since the last commit as one
// group; wait until at most N of its groups are still in flight (the
// copies of the others are then visible to this thread)
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------- TMA
// one arrival on `bar` that also expects `bytes` more of asynchronous
// copies to complete on it in the current phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// the tensor map's box at coordinates (c0, c1, c2) -> shared memory at
// `dst`, laid out as the map's swizzle says; its bytes complete on `bar`.
// Elements outside the tensor are written as zeros (and counted).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// order this thread's view of shared memory (generic proxy: plain and
// cp.async writes) before its later async-proxy accesses (wgmma operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Move registers between warpgroups (sm_90a): every warp of the calling
// warpgroup lowers (dec) or raises (inc) its per-thread limit to N; an inc
// waits until the block has the registers free. Only in a kernel whose
// roles split once and never reconverge, or ptxas ignores it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (in 16-byte units) and the 128-byte swizzle (layout type 1). The
// operand's 8-row x 128-byte swizzle atoms must sit at 1024-byte aligned
// addresses (base offset 0).
//  K-major (A here): rows of 64 bf16 along K; sbo = 1024 bytes between
//    8-row groups; lbo unused (1). The k-th 16-wide K step starts 32 k
//    bytes further.
//  N-major (B here, transposed by the instruction): rows of 64 bf16 along
//    N, one per k; sbo = 1024 bytes between 8-k groups; lbo = the bytes
//    between 64-column atoms. The k-th K step starts 16 * 128 k bytes
//    further.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo16,
                                               uint32_t sbo16) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo16 & 0x3FFFu) << 16) |
         ((uint64_t)(sbo16 & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16 x bf16 -> fp32, A K-major and B N-major (imm-trans-b 1), both from
// shared memory; scale_d 0 overwrites d, 1 accumulates.
// d (64 x 64 fp32, the m16n8 fragment layout repeated over n) += A (64
// x 16, K-major, from desc_a) * B (16 x 64, N-major, from desc_b)
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128 fp32, the m16n8 fragment layout repeated over n) += A (64
// x 16, K-major, from desc_a) * B (16 x 128, N-major, from desc_b)
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


// ------------------------------------------------- flash-attention backward
// 4-byte global -> shared copy through L1; src_bytes 0 writes 4 zero bytes
// and reads nothing (for rows of fp32 vectors at any alignment)
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// keep the compiler from reusing an A fragment's registers while an
// asynchronous MMA may still read them
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define HOPPER_ACC8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_OUT8(d, i)                                                  \
  "=&f"(d[i]), "=&f"(d[i + 1]), "=&f"(d[i + 2]), "=&f"(d[i + 3]),          \
      "=&f"(d[i + 4]), "=&f"(d[i + 5]), "=&f"(d[i + 6]), "=&f"(d[i + 7])
#define HOPPER_OUT32(d)                                                    \
  HOPPER_OUT8(d, 0), HOPPER_OUT8(d, 8), HOPPER_OUT8(d, 16), HOPPER_OUT8(d, 24)
#define HOPPER_OUT64(d)                                                    \
  HOPPER_OUT32(d), HOPPER_OUT8(d, 32), HOPPER_OUT8(d, 40),                 \
      HOPPER_OUT8(d, 48), HOPPER_OUT8(d, 56)
#define HOPPER_ACC32(d)                                                    \
  HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
#define HOPPER_ACC64(d)                                                    \
  HOPPER_ACC32(d), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40),                 \
      HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)

// bf16 x bf16 -> fp32 with both operands K-major in shared memory
// (imm-trans-b 0: B is read as it lies, N rows of K). The K-major
// descriptor of B is built as A's (sbo = 1024 bytes between 8-row groups,
// K steps of 32 bytes within a 64-column block).
// d (64 x 64) += A (64 x 16) * B (64 x 16)^T
__device__ __forceinline__ void wgmma_m64n64k16_bf16_kk(float (&d)[32],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64) = A (64 x 16) * B (64 x 16)^T, the same operands: d is
// written only (scale-d 0), so its old values need not stay live.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_kk_first(
    float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d (64 x 128) += A (64 x 16) * B (128 x 16)^T, both K-major in shared
// memory (imm-trans-b 0), as wgmma_m64n64k16_bf16_kk
__device__ __forceinline__ void wgmma_m64n128k16_bf16_kk(float (&d)[64],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 128) = A (64 x 16) * B (128 x 16)^T, d written only (scale-d 0)
__device__ __forceinline__ void wgmma_m64n128k16_bf16_kk_first(
    float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_OUT64(d)
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// A from registers (the m16n8k16 A fragment of each warp's 16 rows: four
// bf16 pairs), B N-major in shared memory, read through imm-trans-b 1 as in
// wgmma_m64n64k16_bf16; always accumulates.
// d (64 x 64) += A (64 x 16) * B (16 x 64)
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, N-major)
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HOPPER_ACC64
#undef HOPPER_ACC32
#undef HOPPER_ACC8
#undef HOPPER_OUT64
#undef HOPPER_OUT32
#undef HOPPER_OUT8

// ------------------------------------------- flash-attention tile helpers
// 2^x on the special-function unit (ex2.approx.ftz: relative error about
// 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator columns 16 kk .. 16 kk + 15 of a wgmma m64nN fragment
// (x = acc + 8 kk) re-packed as the A fragment of a product whose k
// dimension is those columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* x) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

// Shared-memory tiles. A tile of R rows x D bf16 columns lies as D/64
// column blocks of R rows x 128 bytes, 128-byte swizzled from a 1024-byte
// aligned base: 16-byte chunk c (0-7) of row r of block cb at
// cb * R * 128 + r * 128 + ((c ^ (r % 8)) * 16), as a TMA copy with
// 128-byte swizzle writes a box of 64 columns. One copy serves both
// readings: K-major (rows along the product's K: the tile is an A operand,
// or a B operand read with imm-trans-b 0) and N-major (rows along K, columns
// along N: a B operand read through imm-trans-b 1).

// K-major descriptor of K step kk (16 columns) of rows row0.. of a tile of
// R rows: sbo 1024 bytes between 8-row groups, 32 bytes a K step within a
// 64-column block.
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  return sw128_desc(tile + (kk >> 2) * (R * 128) + row0 * 128 + (kk & 3) * 32,
                    1, 64);
}

// N-major descriptor of K step kk (16 rows) of a tile of R rows: sbo 1024
// bytes between 8-row groups, lbo R * 128 bytes between 64-column blocks.
template <int R>
__device__ __forceinline__ uint64_t nmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, R * 128 / 16, 64);
}

// acc (64 x D) += A (64 x 16, registers) * K step kk of a tile of R rows,
// read N-major
template <int D, int R>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[4], uint32_t tile,
                                       int kk) {
  if constexpr (D == 128)
    wgmma_m64n128k16_bf16_rs(acc, a, nmajor_desc<R>(tile, kk));
  else
    wgmma_m64n64k16_bf16_rs(acc, a, nmajor_desc<R>(tile, kk));
}

// ----------------------------------------------------------- grid barrier
// Every block of a cooperative launch (all blocks resident at once) waits
// here until all have arrived; writes before it are visible to every block
// after it (read them with __ldcg: L1 is not coherent). `bar` is two
// unsigned words in device memory, zero before the first launch that uses
// them: an arrival count, which the last arrival puts back to 0, and a
// generation number that it then advances. So the words are ready for the
// next barrier and the next launch, as long as launches that share them
// run one after another (one stream). A wait that outlasts 2^26 polls of
// at least 64 ns (over 4 s) is a deadlock, and traps.
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      for (unsigned int polls = 0; *gen == g; ++polls) {
        if (polls == (1u << 26)) __trap();
        __nanosleep(64);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace hopper
