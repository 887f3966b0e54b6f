// The attention loop on Hopper's tensor cores (sm_90a), shared by the
// flash forward (hvd_flash_fwd_tc, flash_attention.cu) and the paged
// tiled kernel (paged_attention_tc_kernel, paged_attention.cu): one
// warpgroup owns 64 query rows and consumes one tile of 64 keys a step,
// each tile going through these stages (attend, below, overlaps them):
//
//   S = Q K^T     one wgmma batch from shared memory, both operands
//                 K-major [64][HD] tiles in the 128-byte swizzle
//                 (hopper_mma.cuh); the first k-step overwrites the
//                 accumulator (scale-d 0).
//   softmax       online, in registers, in base 2: thread l of warp w
//                 holds 16 scores of rows acc_row(0) and acc_row(2); the
//                 row max combines over the 4 threads of a quad with two
//                 shuffles. The running max m2 is kept in units of S c
//                 (c = softmax scale * log2 e) and starts at a finite
//                 floor, so a row with no live key yet never forms
//                 -inf - (-inf): its P is 2^-inf = 0 and its rescale
//                 2^0 = 1. P = 2^(S c - m2) by one FMA and ex2.approx. A
//                 masked score enters as -inf, on edge tiles only; the
//                 interior takes a copy of the step with no compare.
//   rescale       O and the thread's part of the row sum l by
//                 2^(m2,old - m2,new).
//   O += P V      P from registers (the S accumulator is laid out as the
//                 A fragment), V an MN-major [64][HD] tile through the
//                 descriptor's transpose bit. P goes in as a bf16 pair,
//                 hi = bf16(P) and lo = bf16(P - hi), two products into
//                 one fp32 accumulator: one bf16 P (2^-9 relative a term)
//                 puts O = P V outside one bf16 rounding of the plain
//                 version on thousands of outputs, the pair (2^-17) at
//                 a few hundredths of an ulp
//                 (tests/test_torch_attention_fwd_tc.py emulates both).
//
// The quad's partial row sums are added once, after the last tile
// (finish); o = O / max(l, 1e-30) and lse = (m2 + log2 l) ln 2 follow.
// The kernels differ only in where the query and key rows come from.

#pragma once

#include <math.h>

#include "hopper_mma.cuh"

namespace attn {

constexpr int kM = 64;  // query rows of a block (wgmma's M), keys a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kFloor = -1e30f;  // m2 of a row with no live key yet
constexpr unsigned kWarp = 0xffffffffu;  // shuffle mask: the whole warp

// 2^x by the special-function unit (about 2 ulp; 2^-inf = 0), so that P
// takes one FMA and one MUFU a score and no branch.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc += (hi + lo) B over 64 rows of K, B an MN-major [64][N] tile.
template <int N>
__device__ __forceinline__ void issue_hi_lo(float (&acc)[N],
                                            const uint32_t (&hi)[16],
                                            const uint32_t (&lo)[16],
                                            uint32_t b) {
#pragma unroll
  for (int k = 0; k < kM / 16; ++k) {
    const uint64_t desc = hopper::desc_mnmajor(b, kM, k);
    hopper::wgmma_rs<1>(acc, hi + 4 * k, desc, 1);
    hopper::wgmma_rs<1>(acc, lo + 4 * k, desc, 1);
  }
}

// Issues S = A B^T, 64 x 64 over head_dim HD, both operands K-major
// tiles in shared memory; the caller fences before and commits after.
template <int HD>
__device__ __forceinline__ void issue_scores(uint32_t a, uint32_t b,
                                             float (&s)[32]) {
#pragma unroll
  for (int k = 0; k < HD / 16; ++k)
    hopper::wgmma_ss<0, 0>(s, hopper::desc_kmajor(a, kM, k),
                           hopper::desc_kmajor(b, kM, k), k > 0);
}

// The online-softmax state of the thread's rows acc_row(0), acc_row(2).
struct Rows {
  float m2[2];  // running max of S c; kFloor until a live key
  float l[2];   // this thread's part of the running sum of P
  __device__ __forceinline__ void init() {
    m2[0] = m2[1] = kFloor;
    l[0] = l[1] = 0.f;
  }
  // after the last tile: the row sums over the quad
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      l[h2] += __shfl_xor_sync(kWarp, l[h2], 1);
      l[h2] += __shfl_xor_sync(kWarp, l[h2], 2);
    }
  }
  // natural-log logsumexp of row h2 (after finish); a row with no live
  // key gets -1e30 + log(1e-30), as the plain version
  __device__ __forceinline__ float lse(int h2) const {
    return l[h2] > 0.f ? (m2[h2] + log2f(l[h2])) * kLn2
                       : kFloor + logf(1e-30f);
  }
};

// S becomes P in place; st and alpha (the rescale of each row) follow.
// With EDGE, a score whose key (k0 + its column) lies outside its row's
// [first, last] enters as -inf.
template <bool EDGE>
__device__ __forceinline__ void softmax(float (&s)[32], float c, int k0,
                                        const int (&first)[2],
                                        const int (&last)[2], Rows& st,
                                        float (&alpha)[2]) {
  if (EDGE) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h2 = (i >> 1) & 1, key = k0 + hopper::acc_col(i);
      s[i] = key >= first[h2] && key <= last[h2] ? s[i] : -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h2 = (i >> 1) & 1;
    mx[h2] = fmaxf(mx[h2], s[i]);
  }
  float neg_m[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(kWarp, mx[h2], 1));
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(kWarp, mx[h2], 2));
    const float m_new = fmaxf(st.m2[h2], mx[h2] * c);  // c > 0
    alpha[h2] = exp2_approx(st.m2[h2] - m_new);
    st.m2[h2] = m_new;
    neg_m[h2] = -m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h2 = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], c, neg_m[h2]));
    sum[h2] += s[i];
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) st.l[h2] = st.l[h2] * alpha[h2] + sum[h2];
}

// Issues the cp.async of N [64][HD] bf16 tiles into the 128-byte swizzle:
// where row(rr, off) is true, row rr of tile n comes from base[n] + off
// (in elements), else it is zero-filled. The tiles of one call share
// each row's offset (K and V through one page-table lookup).
// Consecutive threads copy consecutive 16-byte chunks of a row.
template <int HD, int N, typename Row>
__device__ __forceinline__ void load_rows(
    const uint32_t (&dst)[N], const __nv_bfloat16* const (&base)[N],
    const Row& row) {
  constexpr int CPR = HD / 8;  // chunks a row
#pragma unroll
  for (int it = 0; it < kM * CPR / hopper::kWarpgroup; ++it) {
    const int i = it * hopper::kWarpgroup + threadIdx.x;
    const int rr = i / CPR, c = (i % CPR) * 8;
    long long off = 0;
    const bool ok = row(rr, off);
#pragma unroll
    for (int n = 0; n < N; ++n)
      hopper::cp_async16(dst[n] + hopper::sw128(rr, c, kM),
                         ok ? base[n] + off + c : base[n], ok);
  }
}

// The epilogue (after st.finish()): o = O / max(l, 1e-30) of the thread's
// rows, rounded once to bf16; where out_row(rr, dst) is true, row rr
// (acc_row) goes to dst.
template <int HD, typename OutRow>
__device__ __forceinline__ void store_out(const float (&acc)[HD / 2],
                                          const Rows& st,
                                          const OutRow& out_row) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    __nv_bfloat16* dst = nullptr;
    const float l_safe = fmaxf(st.l[(i >> 1) & 1], 1e-30f);
    if (out_row(hopper::acc_row(i), dst))
      *reinterpret_cast<__nv_bfloat162*>(dst + hopper::acc_col(i)) =
          __floats2bfloat162_rn(acc[i] / l_safe, acc[i + 1] / l_safe);
  }
}

// Every cp.async of this thread landed, visible to wgmma and to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  hopper::fence_proxy_async();
  __syncthreads();
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

constexpr int kStages = 3;  // the ring of (k, v) tiles

// The walk over nk key tiles, tile j holding keys k_begin + 64 j on, for
// the query tile at `sq` (its cp.async issued by the caller, not yet
// committed). `load(j, stage)` issues tile j's cp.async, k at `stage` and
// v at `stage` + the tile's bytes, into a ring of kStages stages at
// `ring`; `edge(k0)` says whether some mask cuts the tile at k0.
//
// Software-pipelined within the warpgroup (FlashAttention-3's
// intra-warpgroup overlap): the products of S for tile j + 1 and of
// O += P V for tile j are issued together, and the softmax of tile j + 1
// runs while P V of tile j is still on the tensor cores. Tile j + 2's
// loads overlap all of it: the stage they overwrite held tile j - 1,
// whose products every thread has waited before the barrier, hence three
// stages. The last tile's P V is peeled off the loop: with the S product
// issued under a condition inside it, ptxas serialized the products
// (C7514) and the loop ran slower than with no overlap at all.
template <int HD, typename Load, typename Edge>
__device__ __forceinline__ void attend(uint32_t sq, uint32_t ring, int nk,
                                       int k_begin, const Load& load,
                                       const Edge& edge,
                                       const int (&first)[2],
                                       const int (&last)[2], float c,
                                       Rows& st, float (&acc)[HD / 2]) {
  constexpr uint32_t kTile = kM * HD * 2;
  auto stage = [&](int j) { return ring + (j % kStages) * 2 * kTile; };
  if (nk > 0) load(0, stage(0));
  cp_async_commit();  // the query tile and tile 0
  if (nk > 1) load(1, stage(1));
  cp_async_commit();
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  hopper::fence_proxy_async();
  __syncthreads();
  if (nk <= 0) return;

  float s[32], alpha[2];
  hopper::fence();
  issue_scores<HD>(sq, stage(0), s);
  hopper::commit();
  hopper::wait<0>();
  hopper::fence_operands(s);
  if (edge(k_begin))
    softmax<true>(s, c, k_begin, first, last, st, alpha);
  else
    softmax<false>(s, c, k_begin, first, last, st, alpha);
  // acc is zero: its rescale is moot

  uint32_t hi[16], lo[16];
  for (int j = 0; j + 1 < nk; ++j) {
    cp_async_wait_all();  // tile j + 1 landed; tile j - 1 consumed
    if (j + 2 < nk) load(j + 2, stage(j + 2));
    cp_async_commit();
    hopper::split_hi_lo(s, hi, lo);
    hopper::fence_operands(acc);
    hopper::fence();
    issue_scores<HD>(sq, stage(j + 1), s);
    hopper::commit();
    issue_hi_lo(acc, hi, lo, stage(j) + kTile);
    hopper::commit();
    hopper::wait<1>();  // S of tile j + 1; P V of tile j may run on
    hopper::fence_operands(s);
    const int k0 = k_begin + (j + 1) * kM;
    if (edge(k0))
      softmax<true>(s, c, k0, first, last, st, alpha);
    else
      softmax<false>(s, c, k0, first, last, st, alpha);
    hopper::wait<0>();
    hopper::fence_operands(acc);
    hopper::fence_operands(hi);
    hopper::fence_operands(lo);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
  // the last tile's P V
  hopper::split_hi_lo(s, hi, lo);
  hopper::fence();
  issue_hi_lo(acc, hi, lo, stage(nk - 1) + kTile);
  hopper::commit();
  hopper::wait<0>();
  hopper::fence_operands(acc);
  hopper::fence_operands(hi);
  hopper::fence_operands(lo);
}

}  // namespace attn
