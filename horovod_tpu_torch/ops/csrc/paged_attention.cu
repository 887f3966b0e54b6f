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
// What bounds it: device-memory bytes. At decode (t = 1) one block per
// (slot, KV head) reads that slot's live K/V bytes once, so the floor is
// the live K/V bytes over 3.35 TB/s. The TPU kernel's sequential page grid
// with its state in VMEM scratch does not carry over; there are three
// kernels here, all reading each page index from the table in global
// memory and keeping m, l and the output accumulator in registers. The
// wrapper picks one by a single rule (kernel_variant in
// ops/paged_attention.py) on the packed rows of a (slot, KV head), rows =
// t * r, and the type:
//
// * paged_decode_kernel, rows <= 4 (every decode step of an MHA model).
//   One block per (KV head, slot); its 16 warps take the same rows and
//   split the slot's keys, warp w walking 32-key chunks w, w + 16, ... A
//   lane scores its own key straight from device memory, and the PV
//   product reads V rows coalesced across the lanes, eight rows' loads
//   issued before any is used. The loop has no block barrier, so sixteen
//   chains of loads are in flight per block. The warps' partial softmax
//   states are merged through shared memory at the end.
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
constexpr int kDecodeWarps = 16;               // key-splitting warps
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

// At most kRowsPerWarp packed rows per (slot, KV head); grid (1, kvh, b).
// Masked keys get p = 0 outright: a warp's chunk can lie wholly past a
// row's causal bound, and its state must then stay empty (m = -1e30,
// l = 0) so the merge weighs it by exp(-1e30 - M) = 0.
template <typename T, int NC>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    T* __restrict__ out, int t, int h, int kvh, int d,
                    int num_pages, int page_tokens, int n_logical,
                    int causal) {
  extern __shared__ float smem[];
  const int r = h / kvh;
  const int rows = t * r;
  const int slot = blockIdx.z;
  const int kv = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = lengths[slot];
  const int n_keys = min(start + t, n_logical * page_tokens);

  float* qs = smem;                                   // [4][d]
  float* merge_m = qs + kRowsPerWarp * d;             // [warps][4]
  float* merge_l = merge_m + kDecodeWarps * kRowsPerWarp;
  float* merge_acc = merge_l + kDecodeWarps * kRowsPerWarp;  // [warps][4][d]

  for (int i = threadIdx.x; i < kRowsPerWarp * d; i += blockDim.x) {
    const int g = i / d;
    const int c = i - g * d;
    float x = 0.f;
    if (g < rows) {
      const int ti = g / r;
      const int head = kv * r + (g - ti * r);
      x = to_f32(q[((size_t)(slot * t + ti) * h + head) * d + c]);
    }
    qs[i] = x;
  }
  __syncthreads();

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
  }
  const float sqrt_d = sqrtf((float)d);
  const int32_t* table_row = page_table + (size_t)slot * n_logical;

  for (int k0 = warp * kKeys; k0 < n_keys; k0 += kDecodeWarps * kKeys) {
    const int key = k0 + lane;
    const bool live = key < n_keys;
    long long off = 0;  // element offset of this lane's key row
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    if (live) {
      const int lp = key / page_tokens;
      const int page = min(max(table_row[lp], 0), num_pages - 1);
      off = (((long long)page * page_tokens + (key - lp * page_tokens)) *
                 kvh + kv) * d;
      const T* k_row = k_pool + off;
#pragma unroll 4
      for (int c = 0; c < d; c += 8) {
        float kf[8];
        load8(k_row + c, kf);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr)
            s[rr] = fmaf(qs[rr * d + c + j], kf[j], s[rr]);
      }
    }
    float p[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      p[rr] = 0.f;
      if (rr < rows) {  // uniform across the warp
        const bool ok = live && (!causal || key <= start + rr / r);
        const float sc = ok ? s[rr] / sqrt_d : kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(sc));
        p[rr] = ok ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(p[rr]);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[rr][i] *= alpha;
        m[rr] = m_new;
      }
    }
    // PV: VB keys' V rows are loaded before any is used, so VB loads
    // are in flight at once instead of one latency per key
    constexpr int VB = NC <= 4 ? 8 : 4;
    const int n_live = min(kKeys, n_keys - k0);
    for (int j0 = 0; j0 < n_live; j0 += VB) {
      float vv[VB][NC];
#pragma unroll
      for (int jj = 0; jj < VB; ++jj) {
        const long long off_j = __shfl_sync(kFullMask, off, j0 + jj);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = lane + 32 * i;
          vv[jj][i] = (j0 + jj < n_live && c < d)
                          ? to_f32(v_pool[off_j + c]) : 0.f;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        if (rr >= rows) break;  // uniform across the warp
#pragma unroll
        for (int jj = 0; jj < VB; ++jj) {
          const float pj = __shfl_sync(kFullMask, p[rr], j0 + jj);
#pragma unroll
          for (int i = 0; i < NC; ++i)
            acc[rr][i] = fmaf(pj, vv[jj][i], acc[rr][i]);
        }
      }
    }
  }

  // merge the warps' partial states: warp rr finishes row rr
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      merge_m[warp * kRowsPerWarp + rr] = m[rr];
      merge_l[warp * kRowsPerWarp + rr] = l[rr];
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) merge_acc[(warp * kRowsPerWarp + rr) * d + c] = acc[rr][i];
    }
  __syncthreads();
  if (warp >= rows) return;
  const int rr = warp;
  float m_all = kNegInf;
  for (int w = 0; w < kDecodeWarps; ++w)
    m_all = fmaxf(m_all, merge_m[w * kRowsPerWarp + rr]);
  float l_all = 0.f;
  float o[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) o[i] = 0.f;
  for (int w = 0; w < kDecodeWarps; ++w) {
    const float scale = expf(merge_m[w * kRowsPerWarp + rr] - m_all);
    l_all += merge_l[w * kRowsPerWarp + rr] * scale;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) o[i] += merge_acc[(w * kRowsPerWarp + rr) * d + c] * scale;
    }
  }
  const int ti = rr / r;
  const int head = kv * r + (rr - ti * r);
  const float l_safe = fmaxf(l_all, 1e-30f);
  T* dst = out + ((size_t)(slot * t + ti) * h + head) * d;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < d) dst[c] = from_f32<T>(o[i] / l_safe);
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int32_t* page_table;
  const int32_t* lengths;
  void* out;
  int b, t, h, kvh, d, num_pages, page_tokens, n_logical, causal;
};

// The kernel a call takes (the wrapper's rule, kernel_variant in
// ops/paged_attention.py): the decode kernel for at most kRowsPerWarp
// packed rows a (slot, KV head), the tiled kernel for more, on the
// tensor cores for bf16 at head_dim 64 or 128.
enum Variant { kDecode = 0, kTiled = 1, kTiledTc = 2 };

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
cudaError_t launch(const Args& a, Variant variant, cudaStream_t stream) {
  cudaError_t e;
  if (variant == kDecode) {
    const size_t smem =
        sizeof(float) * ((size_t)kRowsPerWarp * a.d +
                         2 * kDecodeWarps * kRowsPerWarp +
                         (size_t)kDecodeWarps * kRowsPerWarp * a.d);
    if ((e = allow_smem(paged_decode_kernel<T, NC>, smem)) != cudaSuccess)
      return e;
    paged_decode_kernel<T, NC>
        <<<dim3(1, a.kvh, a.b), kDecodeWarps * 32, smem, stream>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
            static_cast<const T*>(a.v_pool), a.page_table, a.lengths,
            static_cast<T*>(a.out), a.t, a.h, a.kvh, a.d, a.num_pages,
            a.page_tokens, a.n_logical, a.causal);
    return cudaGetLastError();
  }
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
    case 1: return launch<T, 1>(a, variant, stream);
    case 2: return launch<T, 2>(a, variant, stream);
    case 3: return launch<T, 3>(a, variant, stream);
    case 4: return launch<T, 4>(a, variant, stream);
    case 5: return launch<T, 5>(a, variant, stream);
    case 6: return launch<T, 6>(a, variant, stream);
    case 7: return launch<T, 7>(a, variant, stream);
    case 8: return launch<T, 8>(a, variant, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; variant: a Variant,
// which the call must suit (decode: at most 4 packed rows a KV head;
// tensor cores: bf16 at head_dim 64 or 128). Every tensor contiguous; q
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
      kvh > 65535 || b > 65535 || variant < kDecode || variant > kTiledTc ||
      (variant == kDecode && t * (h / kvh) > kRowsPerWarp))
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

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
