// Tensor-core building blocks for Hopper (sm_90a), shared by the port's
// kernels: shared-memory tiles in the 128-byte swizzle, the wgmma matrix
// descriptor for them, m64nNk16 bf16 products (N = 64 or 128) with A from
// shared memory or from registers, the conversion of an fp32 accumulator
// into A-register fragments, and a ring of cp.async stages.
//
// Layout. A tile of R rows by C two-byte columns (C a multiple of 64) is
// stored as C/64 column blocks, each R rows of 128 bytes, one block after
// the other. Within a block, 16-byte chunk j of row r sits at chunk
// j ^ (r % 8): the 128-byte swizzle, so that eight threads reading one
// column of eight rows hit eight banks. Every block starts on a 1024-byte
// boundary (one swizzle atom of 8 rows), as the swizzle is applied on the
// address bits. The same stored tile serves wgmma two ways:
//
// * K-major (rows are M or N, columns are the reduction K), as A or B:
//   the descriptor of k-step s (16 columns) points at column block s / 4
//   plus 32 bytes per step within it; SBO = 1024 (8 rows), LBO unused.
// * MN-major (rows are K, columns are N), as B with the transpose bit:
//   k-step s starts 16 rows (2048 bytes) further; SBO = 1024 (8 K-rows),
//   LBO = R * 128 (from one 64-column block to the next, for N = 128).
//
// Fragments. Thread l of warp w in the warpgroup holds, of a 64 x N fp32
// accumulator, element i at row 16 w + l / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (l % 4) + i % 2. Columns 16 s .. 16 s + 15 are elements
// 8 s .. 8 s + 7, which packed in pairs are exactly the four registers of
// the A fragment of k-step s in a product whose K runs over those columns
// (FlashAttention-3's observation): S = Q K^T turns into the A of P V
// without passing through shared memory.
//
// Ordering. wgmma runs asynchronously: fence() before the first product
// of a batch (after the registers it reads or accumulates were written),
// commit() after the batch, wait<N>() before the accumulators are read,
// and fence_operands() on every register the batch read or wrote right
// after the wait, so that the compiler neither reads an accumulator nor
// reuses an A register before the hardware is done with it. Shared memory
// written by cp.async is made visible to wgmma (the async proxy) by
// fence_proxy_async() in each writing thread before the block's barrier.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

constexpr int kWarpgroup = 128;   // threads that issue one wgmma together
constexpr int kAtomBytes = 1024;  // 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of two-byte element (row, col) in a swizzled tile of `rows`
// rows (see Layout above).
__device__ __forceinline__ uint32_t sw128(int row, int col, int rows) {
  const int blk = col >> 6, chunk = (col & 63) >> 3;
  return blk * rows * 128 + row * 128 + ((chunk ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

// ------------------------------------------------------- cp.async ring

// 16 bytes from global to shared memory; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, for arrays whose rows are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A ring of STAGES shared-memory stages fed by cp.async, one commit group
// per tile, in which the block's threads both load and compute:
//
//   for s in [0, STAGES - 1): load tile s into stage s; Ring::push();
//   for i in [0, n):
//     Ring::pop();           // tile i has landed, in every thread's view
//                            // and wgmma's; every thread is done with
//                            // tile i - 1
//     load tile i + STAGES - 1 (if any) into stage (i - 1) % STAGES;
//     Ring::push();          // always, so the group count stays aligned
//     compute on stage i % STAGES, wgmma waited before the next pop
//   Ring::drain();
//
// The loads of the next STAGES - 1 tiles overlap each tile's products. No
// mbarrier: with no producer warp, the commit groups and one block
// barrier a tile order everything.
template <int STAGES>
struct Ring {
  static_assert(STAGES >= 2, "a ring has at least two stages");
  static __device__ __forceinline__ void push() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  static __device__ __forceinline__ void pop() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    fence_proxy_async();
    __syncthreads();
  }
  static __device__ __forceinline__ void drain() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
};

// ------------------------------------------------------------- wgmma

// Matrix descriptor of a 128-byte-swizzled operand at shared address
// `addr` (bits 0-13 address / 16, 16-29 LBO / 16, 32-45 SBO / 16, 62-63
// layout 1 = 128-byte swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand, k-step s, of a tile at `tile` (any row count).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows,
                                                int s) {
  return desc_sw128(tile + (s >> 2) * rows * 128 + (s & 3) * 32, 16,
                    kAtomBytes);
}

// MN-major operand (transpose bit set), k-step s, of a tile of `rows`
// K-rows.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows,
                                                 int s) {
  return desc_sw128(tile + s * 16 * 128, rows * 128, kAtomBytes);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Row and column of accumulator element i held by this thread (see
// Fragments above); threadIdx.x is the thread's rank in its warpgroup.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// Two fp32 as one register of two bf16 (lower column in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void split_hi_lo(const float (&x)[32],
                                            uint32_t (&hi)[16],
                                            uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A from registers
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A from registers
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

}  // namespace hopper
