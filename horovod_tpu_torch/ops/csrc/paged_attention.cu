// Paged attention for Hopper (sm_90a): attention of the queries against
// the paged KV pool, read through the page table without gathering it.
//
// Replaces the Pallas kernel `_kernel` of
// horovod_tpu/ops/paged_attention.py (`paged_attention`, pallas_call at
// line 308). It computes the same function: query row `start + i` of a
// slot attends keys `<= start + i` and `< lengths[slot] + t`, page-table
// entries are clamped to `num_pages - 1`, the `r = h / kvh` query heads of
// a KV head share one read of each K/V page, and the softmax is online in
// fp32 with the denominator floored at 1e-30. Scores are the fp32 product
// divided by sqrt(head_dim), masked with -1e30, as in the reference.
//
// What bounds it: device-memory bytes. At decode (t = 1) the blocks of
// a (slot, KV head) read that slot's live K/V bytes once, so the floor is
// the live K/V bytes over 3.35 TB/s. The TPU kernel's sequential page grid
// with its state in VMEM scratch does not carry over; there are three
// kernels here, all reading each page index from the table in global
// memory and keeping m, l and the output accumulator in registers. The
// wrapper picks one by a single rule (kernel_variant in
// ops/paged_attention.py) on the packed rows of a (slot, KV head), rows =
// t * r, and the type:
//
// * paged_decode_kernel, rows <= 4 (every decode step of an MHA model),
//   split over keys: one block of four warps per (split, KV head, slot),
//   a split being a fixed run of table pages (64 keys at 16-token
//   pages), so the grid comes from the table's width and the host never
//   reads the lengths. A split past its slot's live keys exits at once;
//   the `decode` case of chip_smoke.py keeps 608 of 2048 blocks live
//   where one block a (KV head, slot) gave 128. In a block, G
//   neighbouring lanes share a key row, each loading 16 bytes of it, so
//   a warp reads 32 / G whole rows at once, and two such rounds of K and
//   V are in flight before any is used (more rounds a thread cost more
//   registers than the extra bytes in flight gained, and wider splits
//   fewer blocks: PERF.md, measured in turns). The rows'
//   products stay on the CUDA cores (a few FLOPs a byte). Each lane
//   group keeps an online softmax state, the block merges its groups in
//   shared memory, and each live split writes m, l and its fp32
//   accumulator to a workspace; the last live split of a (slot, KV
//   head), found by an atomic ticket, merges them, weighing each by
//   exp(m_i - M). A slot with one live split writes its output directly.
// * paged_attention_tc_kernel, rows > 4 in bf16 at head_dim 64 or 128
//   (prefill chunks, wide GQA groups): one warpgroup per (tile of 64
//   packed rows, KV head, slot) on the tensor cores, the tile step of
//   attention_tc.cuh that the flash forward shares (S by wgmma, the online
//   softmax in registers, P as a bf16 hi/lo pair into O += P V, one
//   tile's S overlapped with the previous tile's P V). Its K/V rows come
//   through the page table into a three-stage cp.async ring of swizzled
//   tiles, 64 keys a tile (4 pages of 16 tokens; any page size runs),
//   zero-filled past the block's last key, so the loads of the next tile
//   overlap this tile's products. What bounded the CUDA-core kernel
//   below was re-reading every page once per 16 rows (16 times for a
//   256-row chunk) and the products on the CUDA cores; this one reads each
//   page once per 64 rows. At a 256-row GPT-2 medium chunk it is ~19x its
//   byte bound all the same: 64 blocks (4 row tiles x 16 KV heads) leave
//   half of the 132 SMs idle, and the time is one block's chain of up to
//   9 key tiles (PERF.md); splitting the keys over blocks is the next
//   step.
// * paged_attention_kernel, rows > 4 otherwise (the fp32 serve, fp16,
//   other head dims): one block per (tile of 16 query rows, KV head, slot)
//   walks the slot's live keys 32 per step, staging K and V in shared
//   memory as fp32 for its four warps of four rows, on the CUDA cores.
//
// Tiling the query rows lets a 1024-row prefill chunk run, which the
// TPU's VMEM budget refused. Keys past the slot's frontier, and under the
// causal mask past a tile's last query row, are never read.
//
// Plain C interface, loaded with ctypes: the caller passes device pointers,
// the device index and its current stream, and gets cudaGetLastError()
// back.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tc.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                      // keys per step, one per lane
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// Eight consecutive elements to fp32: one 16-byte load for the 2-byte
// types, two for fp32. The caller guarantees 16-byte alignment
// (head_dim % 8 == 0 and pool base pointers aligned).
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  static_assert(sizeof(T) == 2, "2-byte element types only");
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = to_f32(e[j]);
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// NC = ceil(head_dim / 32): output columns each lane owns (lane + 32 * i).
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int t, int h, int kvh, int d,
                       int num_pages, int page_tokens, int n_logical,
                       int causal) {
  extern __shared__ float smem[];
  const int r = h / kvh;
  const int rows = t * r;  // packed rows: row g is query ti = g / r,
                           // head kv * r + g % r
  const int slot = blockIdx.z;
  const int kv = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int start = lengths[slot];
  const int kv_len = start + t;
  int n_keys = min(kv_len, n_logical * page_tokens);
  if (causal) {
    const int last_row = min(row0 + kRows, rows) - 1;
    n_keys = min(n_keys, start + last_row / r + 1);
  }

  float* qs = smem;                    // [kRows][d]
  float* ks = qs + kRows * d;          // [kKeys][d + 1], padded: no bank
                                       // conflicts when lanes walk keys
  float* vs = ks + kKeys * (d + 1);    // [kKeys][d]

  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
    const int row = i / d;
    const int c = i - row * d;
    const int g = row0 + row;
    float x = 0.f;
    if (g < rows) {
      const int ti = g / r;
      const int head = kv * r + (g - ti * r);
      x = to_f32(q[((size_t)(slot * t + ti) * h + head) * d + c]);
    }
    qs[i] = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
  }

  const float sqrt_d = sqrtf((float)d);
  const int chunks = d >> 3;
  const int32_t* table_row = page_table + (size_t)slot * n_logical;
  const float* q_warp = qs + warp * kRowsPerWarp * d;

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();  // the previous step's K/V (and the q tile) are done
    for (int i = threadIdx.x; i < kKeys * chunks; i += blockDim.x) {
      const int kk = i / chunks;
      const int c = (i - kk * chunks) * 8;
      const int key = k0 + kk;
      float kf[8], vf[8];
      if (key < n_keys) {
        const int lp = key / page_tokens;
        const int page = min(max(table_row[lp], 0), num_pages - 1);
        const size_t off =
            (((size_t)page * page_tokens + (key - lp * page_tokens)) * kvh +
             kv) * d + c;
        load8(k_pool + off, kf);
        load8(v_pool + off, vf);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[kk * (d + 1) + c + j] = kf[j];
        vs[kk * d + c + j] = vf[j];
      }
    }
    __syncthreads();

    // lane = key within the step: each lane scores its key against the
    // warp's rows, reading K once for all of them
    const int key = k0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float* k_row = ks + lane * (d + 1);
    for (int c = 0; c < d; ++c) {
      const float kc = k_row[c];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        s[rr] = fmaf(q_warp[rr * d + c], kc, s[rr]);
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int g = row0 + warp * kRowsPerWarp + rr;
      if (g < rows) {  // uniform across the warp
        const int q_pos = start + g / r;
        float sc = s[rr] / sqrt_d;
        if (key >= n_keys || (causal && key > q_pos)) sc = kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(sc));
        const float p = expf(sc - m_new);
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(p);
        float pv[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) pv[i] = 0.f;
        for (int j = 0; j < kKeys; ++j) {
          const float pj = __shfl_sync(kFullMask, p, j);
          const float* v_row = vs + j * d;
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const int c = lane + 32 * i;
            if (c < d) pv[i] = fmaf(pj, v_row[c], pv[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[rr][i] = acc[rr][i] * alpha + pv[i];
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int g = row0 + warp * kRowsPerWarp + rr;
    if (g < rows) {
      const int ti = g / r;
      const int head = kv * r + (g - ti * r);
      const float l_safe = fmaxf(l[rr], 1e-30f);
      T* o = out + ((size_t)(slot * t + ti) * h + head) * d;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (c < d) o[c] = from_f32<T>(acc[rr][i] / l_safe);
      }
    }
  }
}

// ------------------------------------------------- decode, split over keys

namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 4;  // packed rows a (slot, KV head)

// The decode kernel's layout, the same for every instantiation:
// G lanes share a key row, each taking 16-byte chunks gl, gl + G, ...
// (CPL of them) of it, so a warp reads 32 / G key rows at once, each
// as whole 16-byte pieces on neighbouring lanes; U such rounds of the
// block's four warps are loaded before any is used. Shape holds the
// call's sizes.
struct Shape {
  int b, t, h, kvh, d, num_pages, page_tokens, n_logical, split_pages,
      n_splits, causal;
};

// The workspace of one call: for each (slot, KV head, split, row) the
// split's softmax state, m and l, then its unnormalised fp32
// accumulator of d values. Only splits that hold live keys write it.
__device__ __forceinline__ size_t state_index(const Shape& s, int slot,
                                              int kv, int split) {
  return ((size_t)slot * s.kvh + kv) * s.n_splits + split;
}

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = to_f32(e[j]);
  }
}

// out = sum_s acc_s exp(m_s - M) / max(sum_s l_s exp(m_s - M), 1e-30)
// over the slot's live splits, M their largest m, cast once to T: an
// online merge, kMergeLoads splits' states loaded at once by each
// thread (one L2 latency for up to that many splits). Run by the last
// live split's block; reads the workspace through L2 (other blocks
// wrote it).
constexpr int kMergeLoads = 8;

template <typename T>
__device__ void merge_splits(const Shape& s, const float* ws, T* out,
                             int slot, int kv, int live_splits, int rows) {
  const int r = s.h / s.kvh;
  const size_t acc0 = (size_t)s.b * s.kvh * s.n_splits * 2 * kMaxRows;
  const size_t base = state_index(s, slot, kv, 0);
  for (int idx = threadIdx.x; idx < rows * s.d; idx += kThreads) {
    const int rr = idx / s.d;
    const int col = idx - rr * s.d;
    float big = kNegInf, den = 0.f, num = 0.f;
    for (int sp0 = 0; sp0 < live_splits; sp0 += kMergeLoads) {
      float mv[kMergeLoads], lv[kMergeLoads], av[kMergeLoads];
#pragma unroll
      for (int j = 0; j < kMergeLoads; ++j) {
        const size_t si = base + sp0 + j;
        const bool live = sp0 + j < live_splits;
        mv[j] = live ? __ldcg(ws + si * 2 * kMaxRows + 2 * rr) : kNegInf;
        lv[j] = live ? __ldcg(ws + si * 2 * kMaxRows + 2 * rr + 1) : 0.f;
        av[j] = live ? __ldcg(ws + acc0 + (si * kMaxRows + rr) * s.d + col)
                     : 0.f;
      }
      float nb = big;
#pragma unroll
      for (int j = 0; j < kMergeLoads; ++j) nb = fmaxf(nb, mv[j]);
      const float alpha = expf(big - nb);
      den *= alpha;
      num *= alpha;
#pragma unroll
      for (int j = 0; j < kMergeLoads; ++j) {
        const float w = expf(mv[j] - nb);
        den += lv[j] * w;
        num += av[j] * w;
      }
      big = nb;
    }
    const int ti = rr / r;
    const int head = kv * r + (rr - ti * r);
    out[((size_t)(slot * s.t + ti) * s.h + head) * s.d + col] =
        from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

// One block per (split, KV head, slot): the split's keys, split_pages
// pages of the slot's table, for the slot's <= 4 packed rows. A split
// past the slot's live keys exits at once. A slot with one live split
// writes its output directly; otherwise every live split writes its
// state to the workspace, and the last of them, found by an atomic
// ticket a (slot, KV head) that the block taking it resets, merges
// them (one launch: in turns on the card it beat a second merge
// launch, PERF.md).
template <typename T, int G, int CPL, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ ws,
                    unsigned* __restrict__ tickets, const Shape s) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KPI = 32 / G;           // key rows a warp reads at once
  constexpr int ROUND = kWarps * KPI;   // key rows the block reads at once
  constexpr int U = 2;                  // rounds loaded at once
  constexpr int P = ROUND;              // partial states a block merges
  constexpr int DMAX = G * CPL * VEC;   // widest row this layout takes
  __shared__ float sm_ml[P][R][2];
  __shared__ float sm_acc[P][R][DMAX];
  __shared__ int last;

  const int split = blockIdx.x, kv = blockIdx.y, slot = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane % G, gi = lane / G;
  const int pid = warp * KPI + gi;
  const int r = s.h / s.kvh, rows = s.t * r;
  const int C = s.d / VEC;  // 16-byte chunks in a row
  const int split_keys = s.split_pages * s.page_tokens;
  const int key0 = split * split_keys;
  const int32_t* table_row = page_table + (size_t)slot * s.n_logical;

  // the first round's page-table entries and the length load together
  int page_raw[U];
  auto fetch_pages = [&](int j0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = key0 + j0 + u * ROUND + pid;
      page_raw[u] =
          table_row[min(key / s.page_tokens, s.n_logical - 1)];
    }
  };
  fetch_pages(0);
  const int start = lengths[slot];
  const int n_keys = min(start + s.t, s.n_logical * s.page_tokens);
  if (key0 >= n_keys) return;  // past the slot's live keys: no state
  const int live_splits = (n_keys + split_keys - 1) / split_keys;
  const int key_end = min(key0 + split_keys, n_keys);

  // this lane's chunks of the rows' queries, in fp32
  float qf[R][CPL][VEC];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int ti = rr / r;
    const T* q_row =
        q + ((size_t)(slot * s.t + ti) * s.h + kv * r + (rr - ti * r)) * s.d;
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci) {
      const int c = gl + G * ci;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qf[rr][ci][e] =
            (rr < rows && c < C) ? to_f32(q_row[c * VEC + e]) : 0.f;
    }
  }

  float m[R], l[R], acc[R][CPL][VEC];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[rr][ci][e] = 0.f;
  }
  const float sqrt_d = sqrtf((float)s.d);

  for (int j0 = 0; key0 + j0 < key_end; j0 += U * ROUND) {
    if (j0) fetch_pages(j0);
    // U rounds of K and V rows in flight before any is used
    uint4 kr[U][CPL], vr[U][CPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = key0 + j0 + u * ROUND + pid;
      ok[u] = key < key_end;
      const int lp = key / s.page_tokens;
      const int page = min(max(page_raw[u], 0), s.num_pages - 1);
      const size_t off =
          (((size_t)page * s.page_tokens + (key - lp * s.page_tokens)) *
               s.kvh + kv) * s.d;
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const int c = gl + G * ci;
        if (ok[u] && c < C) {
          kr[u][ci] = __ldg(reinterpret_cast<const uint4*>(
              k_pool + off + (size_t)c * VEC));
          vr[u][ci] = __ldg(reinterpret_cast<const uint4*>(
              v_pool + off + (size_t)c * VEC));
        } else {
          kr[u][ci] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][ci] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    // scores: the lane's part of each dot product, summed over the G
    // lanes of the key row (every lane ends with the same sum)
    float sc[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr) sc[u][rr] = 0.f;
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        float kf[VEC];
        unpack16<T>(kr[u][ci], kf);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            sc[u][rr] = fmaf(qf[rr][ci][e], kf[e], sc[u][rr]);
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          sc[u][rr] += __shfl_xor_sync(kFullMask, sc[u][rr], o);
    }
    // online softmax over the U keys, row by row; a masked key adds
    // p = 0 outright, so a row that sees none keeps an empty state
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      if (rr >= rows) break;  // uniform across the block
      const int bound = s.causal ? start + rr / r : key_end;
      float big = m[rr];
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = key0 + j0 + u * ROUND + pid;
        valid[u] = ok[u] && key <= bound;
        sc[u][rr] = valid[u] ? sc[u][rr] / sqrt_d : kNegInf;
        big = fmaxf(big, sc[u][rr]);
      }
      const float alpha = expf(m[rr] - big);
      l[rr] *= alpha;
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[rr][ci][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = valid[u] ? expf(sc[u][rr] - big) : 0.f;
        l[rr] += p;
#pragma unroll
        for (int ci = 0; ci < CPL; ++ci) {
          float vf[VEC];
          unpack16<T>(vr[u][ci], vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[rr][ci][e] = fmaf(p, vf[e], acc[rr][ci][e]);
        }
      }
      m[rr] = big;
    }
  }

  // merge the block's P partial states (one per key-row group)
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    if (gl == 0) {
      sm_ml[pid][rr][0] = m[rr];
      sm_ml[pid][rr][1] = l[rr];
    }
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[pid][rr][(gl + G * ci) * VEC + e] = acc[rr][ci][e];
  }
  __syncthreads();
  const size_t acc0 = (size_t)s.b * s.kvh * s.n_splits * 2 * kMaxRows;
  const size_t si = state_index(s, slot, kv, split);
  for (int idx = threadIdx.x; idx < rows * s.d; idx += kThreads) {
    const int rr = idx / s.d;
    const int col = idx - rr * s.d;
    float big = kNegInf;
#pragma unroll 4
    for (int p = 0; p < P; ++p) big = fmaxf(big, sm_ml[p][rr][0]);
    float den = 0.f, num = 0.f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float w = expf(sm_ml[p][rr][0] - big);
      den += sm_ml[p][rr][1] * w;
      num += sm_acc[p][rr][col] * w;
    }
    if (live_splits == 1) {
      const int ti = rr / r;
      const int head = kv * r + (rr - ti * r);
      out[((size_t)(slot * s.t + ti) * s.h + head) * s.d + col] =
          from_f32<T>(num / fmaxf(den, 1e-30f));
    } else {
      ws[acc0 + (si * kMaxRows + rr) * s.d + col] = num;
      if (col == 0) {
        ws[si * 2 * kMaxRows + 2 * rr] = big;
        ws[si * 2 * kMaxRows + 2 * rr + 1] = den;
      }
    }
  }
  if (live_splits == 1) return;
  __threadfence();  // this split's state, visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* tk = tickets + (size_t)slot * s.kvh + kv;
    last = atomicAdd(tk, 1u) == (unsigned)(live_splits - 1);
    if (last) *tk = 0u;  // every other live split has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_splits<T>(s, ws, out, slot, kv, live_splits, rows);
}

template <typename T, int G, int CPL, int R>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int32_t* table, const int32_t* lengths, void* out,
                   float* ws, unsigned* tickets, const Shape& s,
                   cudaStream_t stream) {
  paged_decode_kernel<T, G, CPL, R>
      <<<dim3(s.n_splits, s.kvh, s.b), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool), table, lengths,
          static_cast<T*>(out), ws, tickets, s);
  return cudaGetLastError();
}

// G = 16-byte chunks of a row rounded up to a power of two, at most 32;
// CPL = chunks a lane then takes (2 only for fp32 rows over 128 wide);
// R = 1 for one packed row, else 4.
template <typename T, int G, int CPL>
cudaError_t by_rows(int rows, const void* q, const void* k, const void* v,
                    const int32_t* table, const int32_t* lengths, void* out,
                    float* ws, unsigned* tickets, const Shape& s,
                    cudaStream_t st) {
  if (rows == 1)
    return launch<T, G, CPL, 1>(q, k, v, table, lengths, out, ws, tickets,
                                s, st);
  return launch<T, G, CPL, 4>(q, k, v, table, lengths, out, ws, tickets, s,
                              st);
}

template <typename T>
cudaError_t dispatch(int rows, const void* q, const void* k, const void* v,
                     const int32_t* table, const int32_t* lengths, void* out,
                     float* ws, unsigned* tickets, const Shape& s,
                     cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = s.d / VEC;
#define HVD_DECODE(G, CPL)                                                   \
  return by_rows<T, G, CPL>(rows, q, k, v, table, lengths, out, ws, tickets, \
                            s, st)
  if (chunks <= 1) HVD_DECODE(1, 1);
  if (chunks <= 2) HVD_DECODE(2, 1);
  if (chunks <= 4) HVD_DECODE(4, 1);
  if (chunks <= 8) HVD_DECODE(8, 1);
  if (chunks <= 16) HVD_DECODE(16, 1);
  if (chunks <= 32) HVD_DECODE(32, 1);
  if constexpr (sizeof(T) == 4) {
    if (chunks <= 64) HVD_DECODE(32, 2);
  }
#undef HVD_DECODE
  return cudaErrorInvalidValue;
}

}  // namespace dec

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int32_t* page_table;
  const int32_t* lengths;
  void* out;
  int b, t, h, kvh, d, num_pages, page_tokens, n_logical, causal;
};

// The tiled kernel a call takes (the wrapper's rule, kernel_variant in
// ops/paged_attention.py, for more than kRowsPerWarp packed rows a
// (slot, KV head); at most that many take hvd_paged_decode): on the
// tensor cores for bf16 at head_dim 64 or 128, else on the CUDA cores.
enum Variant { kTiled = 1, kTiledTc = 2 };

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ------------------------------------------------ tiled, on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kM = attn::kM;  // packed query rows a block, keys a tile

template <int HD>
struct Geo {
  static constexpr int TILE = kM * HD * 2;  // bytes of one [64][HD] tile
  // q, then attn::attend's ring of (k, v)
  static constexpr int SMEM =
      hopper::kAtomBytes + (1 + 2 * attn::kStages) * TILE;
};

// One block per (tile of 64 packed rows, KV head, slot), heaviest causal
// tiles first: packed row g is query g / r of head kv r + g % r, at
// position start + g / r. The block's queries are loaded once; its keys
// come 64 a tile through the page table into attn::attend's cp.async
// ring (attention_tc.cuh; 16-byte chunks into the 128-byte swizzle,
// zero-filled past the block's last key). A page of any size: key j of a
// tile is pool row (clamp(table[slot][j / pt]) pt + j % pt) kvh + kv.
template <int HD>
__global__ void __launch_bounds__(hopper::kWarpgroup, 1)
paged_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k_pool,
                          const bf16* __restrict__ v_pool,
                          const int32_t* __restrict__ page_table,
                          const int32_t* __restrict__ lengths,
                          bf16* __restrict__ out, int t, int h, int kvh,
                          int num_pages, int page_tokens, int n_logical,
                          int causal) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem[];
  const uint32_t sq = (hopper::smem_u32(smem) + hopper::kAtomBytes - 1) &
                      ~(uint32_t)(hopper::kAtomBytes - 1);
  const uint32_t ring = sq + G::TILE;

  const int r = h / kvh;
  const int rows = t * r;
  const int slot = blockIdx.z, kv = blockIdx.y;
  const int tile = causal ? (int)(gridDim.x - 1 - blockIdx.x)
                          : (int)blockIdx.x;
  const int row0 = tile * kM;
  const int start = lengths[slot];
  const int frontier = min(start + t, n_logical * page_tokens);
  int n_keys = frontier;  // keys any row of the block attends
  if (causal) {
    const int last_row = min(row0 + kM, rows) - 1;
    n_keys = min(n_keys, start + last_row / r + 1);
  }
  const int nk = n_keys > 0 ? (n_keys + kM - 1) / kM : 0;
  const int32_t* table_row = page_table + (size_t)slot * n_logical;

  // the keys rows acc_row(0), acc_row(2) attend; packed rows past `rows`
  // attend none
  int first[2] = {0, 0}, last[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int g = row0 + hopper::acc_row(2 * h2);
    last[h2] = frontier - 1;
    if (causal) last[h2] = min(last[h2], start + g / r);
    if (g >= rows) last[h2] = -1;
  }
  const int first_pos = start + row0 / r;  // the block's earliest query

  attn::Rows st;
  st.init();
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  // the block's queries; rows past the packed rows zero-filled. Packed
  // row g lies at element ((slot t + g / r) h + kv r + g % r) HD.
  auto q_row = [&](int g) {
    const int ti = g / r;
    return (((long long)slot * t + ti) * h + kv * r + (g - ti * r)) * HD;
  };
  {
    const uint32_t dst[1] = {sq};
    const bf16* const src[1] = {q};
    attn::load_rows<HD>(dst, src, [&](int rr, long long& off) {
      const bool ok = row0 + rr < rows;
      if (ok) off = q_row(row0 + rr);
      return ok;
    });
  }
  attn::attend<HD>(
      sq, ring, nk, 0,
      [&](int j, uint32_t stage) {
        const uint32_t dst[2] = {stage, stage + G::TILE};
        const bf16* const src[2] = {k_pool, v_pool};
        attn::load_rows<HD>(dst, src, [&](int rr, long long& off) {
          const int key = j * kM + rr;
          const bool ok = key < n_keys;
          if (ok) {
            const int lp = key / page_tokens;
            const int page = min(max(table_row[lp], 0), num_pages - 1);
            off = (((long long)page * page_tokens + (key - lp * page_tokens)) *
                       kvh + kv) * HD;
          }
          return ok;
        });
      },
      [&](int k0) {
        return k0 + kM > n_keys || (causal && k0 + kM - 1 > first_pos);
      },
      first, last,
      // scores divided by sqrt(head_dim) after the product, as the
      // reference
      attn::kLog2e / sqrtf((float)HD), st, acc);
  st.finish();
  attn::store_out<HD>(acc, st, [&](int rr, bf16*& dst) {
    const bool ok = row0 + rr < rows;
    if (ok) dst = out + q_row(row0 + rr);
    return ok;
  });
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = Geo<HD>::SMEM;
  cudaError_t e = allow_smem(paged_attention_tc_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  const int rows = a.t * (a.h / a.kvh);
  paged_attention_tc_kernel<HD>
      <<<dim3((rows + kM - 1) / kM, a.kvh, a.b), hopper::kWarpgroup, smem,
         stream>>>(static_cast<const bf16*>(a.q),
                   static_cast<const bf16*>(a.k_pool),
                   static_cast<const bf16*>(a.v_pool), a.page_table,
                   a.lengths, static_cast<bf16*>(a.out), a.t, a.h, a.kvh,
                   a.num_pages, a.page_tokens, a.n_logical, a.causal);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int NC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  cudaError_t e;
  const int rows = a.t * (a.h / a.kvh);
  const dim3 grid((rows + kRows - 1) / kRows, a.kvh, a.b);
  const size_t smem =
      sizeof(float) * ((size_t)kRows * a.d + (size_t)kKeys * (a.d + 1) +
                       (size_t)kKeys * a.d);
  if ((e = allow_smem(paged_attention_kernel<T, NC>, smem)) != cudaSuccess)
    return e;
  paged_attention_kernel<T, NC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.page_table, a.lengths,
      static_cast<T*>(a.out), a.t, a.h, a.kvh, a.d, a.num_pages,
      a.page_tokens, a.n_logical, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, Variant variant, cudaStream_t stream) {
  if (variant == kTiledTc) {
    if (!std::is_same<T, __nv_bfloat16>::value) return cudaErrorInvalidValue;
    if (a.d == 64) return tc::launch<64>(a, stream);
    if (a.d == 128) return tc::launch<128>(a, stream);
    return cudaErrorInvalidValue;
  }
  switch ((a.d + 31) / 32) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 6: return launch<T, 6>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; variant: a Variant,
// which the call must suit (tensor cores: bf16 at head_dim 64 or 128).
// Every tensor contiguous; q
// and out [b, t, h, d], pools [num_pages, page_tokens, kvh, d],
// page_table [b, n_logical] int32, lengths [b] int32. Returns a
// cudaError_t code (0 = launched).
extern "C" int hvd_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* page_table,
                                   const void* lengths, void* out, int b,
                                   int t, int h, int kvh, int d,
                                   int num_pages, int page_tokens,
                                   int n_logical, int causal, int variant,
                                   int dtype, int device, void* stream) {
  if (b <= 0 || t <= 0) return cudaSuccess;
  if (kvh <= 0 || h % kvh || d <= 0 || d % 8 || d > kMaxHeadDim ||
      num_pages <= 0 || page_tokens <= 0 || n_logical <= 0 ||
      kvh > 65535 || b > 65535 || variant < kTiled || variant > kTiledTc)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Args a{q, k_pool, v_pool,
               static_cast<const int32_t*>(page_table),
               static_cast<const int32_t*>(lengths), out, b, t, h, kvh, d,
               num_pages, page_tokens, n_logical, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Variant v = static_cast<Variant>(variant);
  switch (dtype) {
    case 0: return dispatch<float>(a, v, s);
    case 1: return dispatch<__nv_bfloat16>(a, v, s);
    case 2: return dispatch<__half>(a, v, s);
    default: return cudaErrorInvalidValue;
  }
}

// The decode kernel, for at most 4 packed rows t * h / kvh a (slot, KV
// head). Tensors as hvd_paged_attention's, plus `ws`, an fp32 workspace
// of b * kvh * n_splits * (8 + 4 d) values that the call overwrites, and
// `tickets`, b * kvh zeroed words that the call leaves zeroed. `params`,
// on the host: b, t, h, kvh, d, num_pages, page_tokens, n_logical,
// split_pages, n_splits (= ceil(n_logical / split_pages)), causal,
// dtype, device.
extern "C" int hvd_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* page_table,
                                const void* lengths, void* out, void* ws,
                                void* tickets, const int* params,
                                void* stream) {
  const dec::Shape s{params[0], params[1], params[2], params[3],
                     params[4], params[5], params[6], params[7],
                     params[8], params[9], params[10]};
  const int dtype = params[11], device = params[12];
  if (s.b <= 0 || s.t <= 0) return cudaSuccess;
  if (s.kvh <= 0 || s.h % s.kvh || s.d <= 0 || s.d % 8 ||
      s.d > kMaxHeadDim || s.num_pages <= 0 || s.page_tokens <= 0 ||
      s.n_logical <= 0 || s.kvh > 65535 || s.b > 65535 ||
      s.split_pages <= 0 ||
      s.n_splits != (s.n_logical + s.split_pages - 1) / s.split_pages ||
      s.t * (s.h / s.kvh) > dec::kMaxRows)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int rows = s.t * (s.h / s.kvh);
  const int32_t* table = static_cast<const int32_t*>(page_table);
  const int32_t* lens = static_cast<const int32_t*>(lengths);
  float* w = static_cast<float*>(ws);
  unsigned* tk = static_cast<unsigned*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dec::dispatch<float>(rows, q, k_pool, v_pool, table, lens, out,
                                  w, tk, s, st);
    case 1:
      return dec::dispatch<__nv_bfloat16>(rows, q, k_pool, v_pool, table,
                                          lens, out, w, tk, s, st);
    case 2:
      return dec::dispatch<__half>(rows, q, k_pool, v_pool, table, lens,
                                   out, w, tk, s, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
