// Flash attention for Hopper (sm_90a): the forward, the backward's delta
// pass and the backward's two kernels, the forward and both backward
// kernels in two variants, fp32 statistics and accumulators whatever the
// input type.
//
// Replaces the three Pallas kernels of horovod_tpu/ops/flash_attention.py:
//
// * hvd_flash_fwd(_tc) <- `_fwd_kernel`, pallas_call at line 513
//   (_flash_fwd): o = softmax(scale * q k^T) v with the online softmax,
//   and the per-row lse = m + log(max(l, 1e-30)). The CUDA-core kernel
//   scales q before the product and runs P V in fp32, as there; the
//   tensor-core one scales after and carries P as a bf16 pair (below).
// * hvd_flash_bwd_dq  <- `_dq_kernel`, pallas_call at line 621
//   (_flash_bwd_impl): P = exp(scale * q k^T - lse) recomputed from the saved
//   lse, dS = P * (dO v^T - delta), dQ = scale * dS k.
// * hvd_flash_bwd_dkv <- `_dkv_kernel`, pallas_call at line 633: per key tile,
//   dV += P^T dO and dK += scale * dS^T q over the query tiles of every query
//   head of the key's GQA group (the group sum happens here; K/V are never
//   repeated).
// * hvd_flash_bwd_delta: delta = rowsum(dO * O) per (batch-head, row) in
//   fp32, once per backward; both backward kernels read it. `_dq_kernel`
//   computes it inside; here one pass serves dQ and dK/dV alike, where the
//   dK/dV kernel used to recompute it for every (key tile, query tile).
//
// Masks, as the reference's: causal (key <= query), per-sequence `lengths`
// (keys at or past the length never attended; in the backward, padded query
// rows get P = 0), and a causal sliding `window` (query - key < window). The
// loop bounds clamp to them as `_causal_bound`, `_length_bound` and
// `_window_start` do, and the ragged last tile is masked, so any sequence
// length runs. A masked score contributes P = 0 outright (the reference gets
// the same from exp(-1e30 - m) once a row has seen a live key).
//
// What bounds them on this card: at GPT-2 medium's training shape (b 8,
// h 16, t 512, d 64, causal, bf16) the forward moves 33.8 MB (10.1 us at
// 3.35 TB/s) against 4.3 GFLOP (4.4 us at the bf16 tensor-core peak), dQ
// 42.5 MB (12.7 us) against 6.4 GFLOP (6.5 us), dK/dV 50.9 MB (15.2 us)
// against 8.6 GFLOP (8.7 us), the delta pass 17.0 MB (5.1 us): on paper
// bytes bound all four. In practice the tensor-core kernels take 2.7x to
// 3.9x those bounds (the forward 3.4x): each warpgroup walks its tiles as
// one chain (wait for the tile, first products, softmax or P and dS,
// second products, wait) and two or three warpgroups an SM, all that the
// registers allow, overlap too little of it (PERF.md).
//
// Two variants of the forward and of each backward kernel; the wrapper
// picks one by a single rule on (dtype, head_dim):
//
// * Tensor cores (`*_tc`, bf16 with head_dim 64 or 128): one warpgroup of
//   128 threads per block owns 64 rows (forward, dQ: query rows; dK/dV:
//   keys), the tiles it keeps (forward: q; dQ: q and dO; dK/dV: k and v)
//   loaded once, the tiles it walks (forward, dQ: k and v; dK/dV: q, dO
//   and the rows' lse and delta) brought by 16-byte cp.async into a ring
//   of two stages (hopper_mma.cuh; the forward's attn::attend keeps three
//   and overlaps one tile's S with the previous tile's P V): the next
//   tile's loads overlap this tile's products. A third stage in the
//   backward was measured and bought nothing; there is no producer warp,
//   so no mbarrier either. All operands stay bf16 in
//   shared memory in the 128-byte swizzle, each tile stored once: the same
//   layout is K-major for the first products (S = q k^T and dP = dO v^T,
//   or their transposes in dK/dV: wgmma m64n64k16 from shared memory, one
//   batch) and MN-major, through the descriptor's transpose bit, for the
//   second ones (o += P v; dQ += dS k; dV += P^T dO and dK += dS^T q:
//   wgmma m64n{64,128}k16 with A from registers, the fp32 accumulator of S
//   being laid out as the A fragment). P and dS never touch shared memory;
//   accumulators, the softmax state, lse, delta and the masks' bounds stay
//   in registers. The forward is the tile step of attention_tc.cuh (the
//   online softmax in base 2 from a finite floor, so a row with no live
//   key yet forms no -inf - (-inf)), which the paged kernel shares.
//   Precision: P and dS are formed in fp32, as the reference does (P =
//   2^(s scale log2 e - lse log2 e) by one FMA and ex2.approx, about 2^-19
//   relative), and the second products take them as a bf16 pair hi =
//   bf16(x), lo = bf16(x - hi), two wgmma into one fp32 accumulator: about
//   2^-17 relative per term where one bf16 operand gives 2^-9, which would
//   break the one-bf16-rounding agreement with the plain version on
//   outputs that are sums of hundreds of cancelling terms
//   (tests/test_torch_flash_tc.py and test_torch_attention_fwd_tc.py
//   emulate both). It costs one more product in the forward (3 in all)
//   and dQ (4), and two in dK/dV (6).
//   Masks: a tile that crosses the causal diagonal, the window's edge, a
//   sequence's length or t compares each score with its row's attended
//   range, [first, last], computed once per block; interior tiles take a
//   copy of the loop with no compare. The step has no branch a score:
//   a masked score enters the exponent as -inf. (With a branch a score and
//   expf's slow path, the first version took 1.5 times as long.)
//   Register budget (ptxas, sm_90a): the forward 163 at d 64 (three blocks
//   an SM), 240 at d 128; dQ 167 and 241; dK/dV 215 (two blocks) and 255
//   at d 128, which spills 80 bytes. Capping registers for a fourth block
//   made dQ slower. Shared memory: the forward 57 KB (d 64) and 113 KB
//   (d 128), dQ 49 and 97 KB, dK/dV 51 and 99 KB.
// * CUDA cores (fp32, fp16 and other head dims, any multiple of 8 up to
//   256): a block of 256 threads stages 64x64 tiles (32x32 past head_dim
//   128) of its operands in shared memory as fp32, the ones read along
//   head_dim transposed, so that each of the 16x16 threads reads 4-wide
//   vectors and does 16 multiply-adds per two shared loads in every
//   product; fp32 FMAs (67 TFLOP/s peak) bound it.
//
// Both: the grid is Hopper's, not the TPU's sequential one: one block per
// (batch-head, query tile) for the forward and dQ, one per (batch-kv-head,
// key tile) for dK/dV, all independent, heaviest causal tiles first. The
// sequential grid axis of the Pallas kernels becomes the loop inside a
// block. Tensors are read through their (batch, seq, head) strides in the
// model's [b, t, h, d] layout: q, k and v straight out of the fused qkv
// projection, with no transposed copy.
//
// Plain C interface, loaded with ctypes: every entry point takes the same
// arguments (an array of tensor pointers, an array of element strides, an
// array of sizes, the dtype code, the device and its stream) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "attention_tc.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = row group, tx = column group
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// Tile geometry by head_dim: NJ = ceil(d / 64) groups of 64 columns.
template <int NJ>
struct Tile {
  static constexpr int B = NJ <= 2 ? 64 : 32;  // rows (and keys) per tile
  static constexpr int R = B / 16;             // rows (keys) per thread
  static constexpr int DP = 64 * NJ;           // head_dim padded
};

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

// Eight consecutive elements to fp32: one 16-byte load for the 2-byte types,
// two for fp32. The wrapper guarantees 16-byte alignment.
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

// N consecutive fp32 from shared memory (N = 2 or 4, aligned).
template <int N>
__device__ __forceinline__ void lds(const float* p, float* out);
template <>
__device__ __forceinline__ void lds<4>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void lds<2>(const float* p, float* out) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = v.x; out[1] = v.y;
}
template <int N>
__device__ __forceinline__ void sts(float* p, const float* in);
template <>
__device__ __forceinline__ void sts<4>(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
template <>
__device__ __forceinline__ void sts<2>(float* p, const float* in) {
  *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
}

// max / sum over the 16 lanes of a half-warp (the threads of one row group)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // forward output (read by the backward)
  const void* dout;  // dO
  void* out;         // forward: o; dQ kernel: dq; dK/dV kernel: dk
  void* out2;        // dK/dV kernel: dv
  float* lse;        // [b * h, t] fp32
  const int* lengths;  // [b] or null
  float* delta;      // [b * h, t] fp32 rowsum(dO * O): the backward's input
  // element strides (batch, seq, head) of q, k, v, o, dO, out, out2
  long long sq[3], sk[3], sv[3], so[3], sdo[3], s1[3], s2[3];
  int b, t, h, kvh, d, causal, window;  // window 0 = none
  float scale;
};

__device__ __forceinline__ int seq_len(const Params& p, int bi) {
  return p.lengths ? min(max(p.lengths[bi], 0), p.t) : p.t;
}

// Whether query row q attends key col k (rows and cols past t are tile
// padding); `pad_rows` also drops query rows at or past the length.
__device__ __forceinline__ bool attends(const Params& p, int q, int k, int len,
                                        bool pad_rows) {
  if (q >= p.t || k >= len) return false;  // len <= t
  if (pad_rows && q >= len) return false;
  if (p.causal && k > q) return false;
  if (p.window && q - k >= p.window) return false;
  return true;
}

// Rows [row0, row0 + B) of one (batch, head) slice with seq stride `st`, as
// fp32 times `mul`, transposed into dst[c][row] (row stride B). Rows past t
// and columns past d are 0. Consecutive threads take consecutive rows, so
// the shared-memory writes are conflict-free.
template <typename T, int B, int DP>
__device__ __forceinline__ void stage_t(const T* base, long long st, int row0,
                                        int t, int d, float mul, float* dst) {
  for (int i = threadIdx.x; i < B * (DP / 8); i += kThreads) {
    const int r = i % B, c = (i / B) * 8;
    float x[8];
    if (row0 + r < t && c < d) {
      load8(base + (row0 + r) * st + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * B + r] = x[j] * mul;
  }
}

// The same rows kept row-major: dst[row][c] (row stride DP); consecutive
// threads take consecutive 8-column chunks, coalesced in device memory.
template <typename T, int B, int DP>
__device__ __forceinline__ void stage_rows(const T* base, long long st,
                                           int row0, int t, int d,
                                           float* dst) {
  for (int i = threadIdx.x; i < B * (DP / 8); i += kThreads) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    float x[8];
    if (row0 + r < t && c < d) {
      load8(base + (row0 + r) * st + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    sts<4>(dst + r * DP + c, x);
    sts<4>(dst + r * DP + c + 4, x + 4);
  }
}

// ---------------------------------------------------------------- forward

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int B = Tile<NJ>::B, R = Tile<NJ>::R, DP = Tile<NJ>::DP;
  extern __shared__ float smem[];
  float* qt = smem;          // [DP][B] q^T, scaled
  float* kt = qt + DP * B;   // [DP][B] k^T
  float* vs = kt + DP * B;   // [B][DP] v
  float* pt = vs + B * DP;   // [B][B]  P^T: pt[key][row]

  const int n_tiles = (p.t + B - 1) / B;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * B;  // heavy tiles first
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h, kv = hi / (p.h / p.kvh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int len = seq_len(p, bi);

  const T* qb = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[2];
  const T* kb = static_cast<const T*>(p.k) + bi * p.sk[0] + kv * p.sk[2];
  const T* vb = static_cast<const T*>(p.v) + bi * p.sv[0] + kv * p.sv[2];

  int k_end = len;
  if (p.causal) k_end = min(k_end, q0 + B);
  int k_begin = 0;
  if (p.window) k_begin = max(0, q0 - p.window + 1) / B * B;

  stage_t<T, B, DP>(qb, p.sq[1], q0, p.t, p.d, p.scale, qt);

  float m[R], l[R], acc[R][NJ][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NJ; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += B) {
    __syncthreads();  // the previous tile's reads are done
    stage_t<T, B, DP>(kb, p.sk[1], k0, p.t, p.d, 1.f, kt);
    stage_rows<T, B, DP>(vb, p.sv[1], k0, p.t, p.d, vs);
    __syncthreads();

    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < p.d; ++c) {
      float a[R], bb[R];
      lds<R>(qt + c * B + ty * R, a);
      lds<R>(kt + c * B + tx * R, bb);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
      bool ok[R];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ok[j] = attends(p, row, k0 + tx * R + j, len, false);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NJ; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float col[R];
#pragma unroll
      for (int i = 0; i < R; ++i) col[i] = s[i][j];
      sts<R>(pt + (tx * R + j) * B + ty * R, col);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float pr[R];
      lds<R>(pt + kk * B + ty * R, pr);
#pragma unroll
      for (int g = 0; g < NJ; ++g) {
        float vv[4];
        lds<4>(vs + kk * DP + g * 64 + tx * 4, vv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g][e] = fmaf(pr[i], vv[e], acc[i][g][e]);
      }
    }
  }

  T* ob = static_cast<T*>(p.out) + bi * p.s1[0] + hi * p.s1[2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= p.t) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = ob + row * p.s1[1];
#pragma unroll
    for (int g = 0; g < NJ; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = g * 64 + tx * 4 + e;
        if (c < p.d) orow[c] = from_f32<T>(acc[i][g][e] / l_safe);
      }
    if (tx == 0) p.lse[(long long)bh * p.t + row] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------- backward dQ

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int B = Tile<NJ>::B, R = Tile<NJ>::R, DP = Tile<NJ>::DP;
  extern __shared__ float smem[];
  float* qt = smem;           // [DP][B] q^T
  float* dot = qt + DP * B;   // [DP][B] dO^T
  float* kt = dot + DP * B;   // [DP][B] k^T
  float* vt = kt + DP * B;    // [DP][B] v^T
  float* ks = vt + DP * B;    // [B][DP] k
  float* dst = ks + B * DP;   // [B][B]  dS^T: dst[key][row]

  const int n_tiles = (p.t + B - 1) / B;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * B;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h, kv = hi / (p.h / p.kvh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int len = seq_len(p, bi);
  const bool pad_rows = p.lengths != nullptr;

  const T* qb = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[2];
  const T* kb = static_cast<const T*>(p.k) + bi * p.sk[0] + kv * p.sk[2];
  const T* vb = static_cast<const T*>(p.v) + bi * p.sv[0] + kv * p.sv[2];
  const T* dob =
      static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[2];

  int k_end = len;
  if (p.causal) k_end = min(k_end, q0 + B);
  if (pad_rows && q0 >= len) k_end = 0;  // every row padded: dq = 0
  int k_begin = 0;
  if (p.window) k_begin = max(0, q0 - p.window + 1) / B * B;

  stage_t<T, B, DP>(qb, p.sq[1], q0, p.t, p.d, 1.f, qt);
  stage_t<T, B, DP>(dob, p.sdo[1], q0, p.t, p.d, 1.f, dot);
  float lse[R], delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    lse[i] = row < p.t ? p.lse[(long long)bh * p.t + row] : 0.f;
    delta[i] = row < p.t ? p.delta[(long long)bh * p.t + row] : 0.f;
  }

  float acc[R][NJ][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int g = 0; g < NJ; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += B) {
    __syncthreads();
    stage_t<T, B, DP>(kb, p.sk[1], k0, p.t, p.d, 1.f, kt);
    stage_t<T, B, DP>(vb, p.sv[1], k0, p.t, p.d, 1.f, vt);
    stage_rows<T, B, DP>(kb, p.sk[1], k0, p.t, p.d, ks);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < p.d; ++c) {
      float a[R], da[R], kk[R], vv[R];
      lds<R>(qt + c * B + ty * R, a);
      lds<R>(dot + c * B + ty * R, da);
      lds<R>(kt + c * B + tx * R, kk);
      lds<R>(vt + c * B + tx * R, vv);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float col[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + ty * R + i;
        const bool ok = attends(p, row, k0 + tx * R + j, len, pad_rows);
        const float pij = ok ? expf(p.scale * s[i][j] - lse[i]) : 0.f;
        col[i] = pij * (dp[i][j] - delta[i]);
      }
      sts<R>(dst + (tx * R + j) * B + ty * R, col);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float dr[R];
      lds<R>(dst + kk * B + ty * R, dr);
#pragma unroll
      for (int g = 0; g < NJ; ++g) {
        float kv4[4];
        lds<4>(ks + kk * DP + g * 64 + tx * 4, kv4);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g][e] = fmaf(dr[i], kv4[e], acc[i][g][e]);
      }
    }
  }

  T* dqb = static_cast<T*>(p.out) + bi * p.s1[0] + hi * p.s1[2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= p.t) continue;
    T* drow = dqb + row * p.s1[1];
#pragma unroll
    for (int g = 0; g < NJ; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = g * 64 + tx * 4 + e;
        if (c < p.d) drow[c] = from_f32<T>(p.scale * acc[i][g][e]);
      }
  }
}

// ---------------------------------------------------------- backward dK/dV

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int B = Tile<NJ>::B, R = Tile<NJ>::R, DP = Tile<NJ>::DP;
  extern __shared__ float smem[];
  float* kt = smem;            // [DP][B] k^T (this block's key tile)
  float* vt = kt + DP * B;     // [DP][B] v^T
  float* qt = vt + DP * B;     // [DP][B] q^T (current query tile)
  float* dot = qt + DP * B;    // [DP][B] dO^T
  float* qs = dot + DP * B;    // [B][DP] q
  float* dos = qs + B * DP;    // [B][DP] dO
  float* pq = dos + B * DP;    // [B][B]  P: pq[query][key]
  float* dsq = pq + B * B;     // [B][B]  dS: dsq[query][key]
  float* lse_s = dsq + B * B;  // [B]
  float* delta_s = lse_s + B;  // [B]

  const int k0 = (int)blockIdx.x * B;  // early key tiles see most queries
  const int bkv = blockIdx.y;
  const int bi = bkv / p.kvh, kv = bkv % p.kvh;
  const int r = p.h / p.kvh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int len = seq_len(p, bi);
  const bool pad_rows = p.lengths != nullptr;

  const T* kb = static_cast<const T*>(p.k) + bi * p.sk[0] + kv * p.sk[2];
  const T* vb = static_cast<const T*>(p.v) + bi * p.sv[0] + kv * p.sv[2];

  // query rows that can see a key of this tile
  int q_begin = p.causal ? k0 : 0;
  int q_end = pad_rows ? len : p.t;
  if (p.window) q_end = min(q_end, k0 + B - 1 + p.window);
  if (k0 >= len) q_end = q_begin;  // every key padded: dk = dv = 0
  q_begin = q_begin / B * B;

  stage_t<T, B, DP>(kb, p.sk[1], k0, p.t, p.d, 1.f, kt);
  stage_t<T, B, DP>(vb, p.sv[1], k0, p.t, p.d, 1.f, vt);

  float dk[R][NJ][4], dv[R][NJ][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int g = 0; g < NJ; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][g][e] = dv[i][g][e] = 0.f;

  for (int gm = 0; gm < r; ++gm) {
    const int hi = kv * r + gm;
    const int bh = bi * p.h + hi;
    const T* qb = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[2];
    const T* dob =
        static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[2];
    for (int q0 = q_begin; q0 < q_end; q0 += B) {
      __syncthreads();  // the previous query tile's reads are done
      stage_t<T, B, DP>(qb, p.sq[1], q0, p.t, p.d, 1.f, qt);
      stage_t<T, B, DP>(dob, p.sdo[1], q0, p.t, p.d, 1.f, dot);
      stage_rows<T, B, DP>(qb, p.sq[1], q0, p.t, p.d, qs);
      stage_rows<T, B, DP>(dob, p.sdo[1], q0, p.t, p.d, dos);
      if (threadIdx.x < B) {  // lse and delta of the tile's rows
        const int row = q0 + threadIdx.x;
        const long long at = (long long)bh * p.t + row;
        lse_s[threadIdx.x] = row < p.t ? p.lse[at] : 0.f;
        delta_s[threadIdx.x] = row < p.t ? p.delta[at] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows = keys (ty), cols = queries (tx)
      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < p.d; ++c) {
        float ka[R], va[R], qa[R], da[R];
        lds<R>(kt + c * B + ty * R, ka);
        lds<R>(vt + c * B + ty * R, va);
        lds<R>(qt + c * B + tx * R, qa);
        lds<R>(dot + c * B + tx * R, da);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
            dp[i][j] = fmaf(va[i], da[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ql = tx * R + j;
        const float lse_j = lse_s[ql], delta_j = delta_s[ql];
        float pc[R], dc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const bool ok = attends(p, q0 + ql, k0 + ty * R + i, len, pad_rows);
          pc[i] = ok ? expf(p.scale * s[i][j] - lse_j) : 0.f;
          dc[i] = pc[i] * (dp[i][j] - delta_j);
        }
        sts<R>(pq + ql * B + ty * R, pc);
        sts<R>(dsq + ql * B + ty * R, dc);
      }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < B; ++qq) {
        float pr[R], dr[R];
        lds<R>(pq + qq * B + ty * R, pr);
        lds<R>(dsq + qq * B + ty * R, dr);
#pragma unroll
        for (int g = 0; g < NJ; ++g) {
          float d4[4], q4[4];
          lds<4>(dos + qq * DP + g * 64 + tx * 4, d4);
          lds<4>(qs + qq * DP + g * 64 + tx * 4, q4);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv[i][g][e] = fmaf(pr[i], d4[e], dv[i][g][e]);
              dk[i][g][e] = fmaf(dr[i], q4[e], dk[i][g][e]);
            }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.out) + bi * p.s1[0] + kv * p.s1[2];
  T* dvb = static_cast<T*>(p.out2) + bi * p.s2[0] + kv * p.s2[2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty * R + i;
    if (key >= p.t) continue;
    T* krow = dkb + key * p.s1[1];
    T* vrow = dvb + key * p.s2[1];
#pragma unroll
    for (int g = 0; g < NJ; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = g * 64 + tx * 4 + e;
        if (c < p.d) {
          krow[c] = from_f32<T>(p.scale * dk[i][g][e]);
          vrow[c] = from_f32<T>(dv[i][g][e]);
        }
      }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ------------------------------------------------------- backward delta

constexpr int kDeltaLanes = 8;  // threads per row, 8 elements each

// delta[bh, row] = rowsum(dO * O) in fp32; rows walked in memory order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const Params p) {
  const long long rows = (long long)p.b * p.t * p.h;
  const long long row =
      (long long)blockIdx.x * (kThreads / kDeltaLanes) +
      threadIdx.x / kDeltaLanes;
  const int sub = threadIdx.x % kDeltaLanes;
  float acc = 0.f;
  int bi = 0, ti = 0, hi = 0;
  if (row < rows) {
    hi = (int)(row % p.h);
    ti = (int)((row / p.h) % p.t);
    bi = (int)(row / ((long long)p.h * p.t));
    const T* orow = static_cast<const T*>(p.o) + bi * p.so[0] +
                    ti * p.so[1] + hi * p.so[2];
    const T* drow = static_cast<const T*>(p.dout) + bi * p.sdo[0] +
                    ti * p.sdo[1] + hi * p.sdo[2];
    for (int c = sub * 8; c < p.d; c += kDeltaLanes * 8) {
      float a[8], b[8];
      load8(orow + c, a);
      load8(drow + c, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(b[j], a[j], acc);
    }
  }
#pragma unroll
  for (int o = kDeltaLanes / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, o);
  if (row < rows && sub == 0)
    p.delta[((long long)bi * p.h + hi) * p.t + ti] = acc;
}

// ------------------------------- forward and backward on the tensor cores

enum Kind { kFwd, kDq, kDkv, kDelta, kFwdTc, kDqTc, kDkvTc };

namespace tc {

using bf16 = __nv_bfloat16;
using attn::exp2_approx;
using attn::issue_hi_lo;
using attn::kLog2e;
constexpr int kM = attn::kM;  // wgmma's M: query rows (forward, dQ) or
                              // keys (dK/dV)
constexpr int kStages = 2;   // the ring of walked tiles
constexpr int kThreadsTc = hopper::kWarpgroup;

template <int HD>
struct Geo {
  static constexpr int TILE = kM * HD * 2;  // bytes of one [64][HD] tile
  static constexpr int KSTEPS = HD / 16;    // k-steps over head_dim
  // forward: q, then attn::attend's ring of (k, v)
  static constexpr int FWD_SMEM =
      hopper::kAtomBytes + (1 + 2 * attn::kStages) * TILE;
  // dQ: q, dO, then the ring of (k, v)
  static constexpr int DQ_SMEM =
      hopper::kAtomBytes + (2 + 2 * kStages) * TILE;
  // dK/dV: k, v, then the ring of (q, dO, lse and delta of 64 rows)
  static constexpr int DKV_STAGE = 2 * TILE + hopper::kAtomBytes;
  static constexpr int DKV_SMEM =
      hopper::kAtomBytes + 2 * TILE + kStages * DKV_STAGE;
};

// Rows [row0, row0 + 64) of one (batch, head) slice with seq stride `st`
// into the swizzled tile at `dst`; rows at or past t are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long long st, int row0, int t) {
  const uint32_t dsts[1] = {dst};
  const bf16* const bases[1] = {base};
  attn::load_rows<HD>(dsts, bases, [&](int r, long long& off) {
    off = (long long)(row0 + r) * st;
    return row0 + r < t;
  });
}

// The first products of a tile: S = A B^T and dP = A2 B2^T, each 64 x 64
// over head_dim, every operand a K-major tile in shared memory, one batch.
// The first k-step overwrites the accumulators (scale-d 0): zeroing them
// with ordinary moves would make ptxas wait between the two products.
template <int HD>
__device__ __forceinline__ void scores(uint32_t a, uint32_t b, uint32_t a2,
                                       uint32_t b2, float (&s)[32],
                                       float (&dp)[32]) {
  hopper::fence();
#pragma unroll
  for (int k = 0; k < Geo<HD>::KSTEPS; ++k)
    hopper::wgmma_ss<0, 0>(s, hopper::desc_kmajor(a, kM, k),
                           hopper::desc_kmajor(b, kM, k), k > 0);
#pragma unroll
  for (int k = 0; k < Geo<HD>::KSTEPS; ++k)
    hopper::wgmma_ss<0, 0>(dp, hopper::desc_kmajor(a2, kM, k),
                           hopper::desc_kmajor(b2, kM, k), k > 0);
  hopper::commit();
  hopper::wait<0>();
  hopper::fence_operands(s);
  hopper::fence_operands(dp);
}

__device__ __forceinline__ uint32_t align_atom(uint32_t a) {
  return (a + hopper::kAtomBytes - 1) & ~(uint32_t)(hopper::kAtomBytes - 1);
}

// The keys query row q attends, [first, last] (empty when last < first):
// `attends` as a range, so that a masked tile compares twice a score.
__device__ __forceinline__ void key_range(const Params& p, int q, int len,
                                          bool pad_rows, int& first,
                                          int& last) {
  first = p.window ? max(0, q - p.window + 1) : 0;
  last = len - 1;
  if (p.causal) last = min(last, q);
  if (q >= p.t || (pad_rows && q >= len)) last = -1;
}

// The query rows that attend key k, [first, last].
__device__ __forceinline__ void query_range(const Params& p, int k, int len,
                                            bool pad_rows, int& first,
                                            int& last) {
  first = p.causal ? k : 0;
  last = (pad_rows ? len : p.t) - 1;
  if (p.window) last = min(last, k + p.window - 1);
  if (k >= len) last = -1;
}

// Whether a (query tile, key tile) pair has a pair that some mask drops.
__device__ __forceinline__ bool edge_tile(const Params& p, int q0, int k0,
                                          int len, bool pad_rows) {
  return q0 + kM > p.t || k0 + kM > len || (pad_rows && q0 + kM > len) ||
         (p.causal && k0 + kM - 1 > q0) ||
         (p.window && q0 + kM - 1 - k0 >= p.window);
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_bwd_dq_tc_kernel(const Params p) {
  using G = Geo<HD>;
  using Ring = hopper::Ring<kStages>;
  extern __shared__ uint8_t smem[];
  const uint32_t sq = align_atom(hopper::smem_u32(smem));
  const uint32_t sdo = sq + G::TILE;
  const uint32_t ring = sdo + G::TILE;  // stage s: k, then v

  const int n_tiles = (p.t + kM - 1) / kM;
  const int q0 = (n_tiles - 1 - (int)blockIdx.y) * kM;  // heavy tiles first
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h, kv = hi / (p.h / p.kvh);
  const int len = seq_len(p, bi);
  const bool pad_rows = p.lengths != nullptr;

  const bf16* qb = static_cast<const bf16*>(p.q) + bi * p.sq[0] +
                   hi * p.sq[2];
  const bf16* kb = static_cast<const bf16*>(p.k) + bi * p.sk[0] +
                   kv * p.sk[2];
  const bf16* vb = static_cast<const bf16*>(p.v) + bi * p.sv[0] +
                   kv * p.sv[2];
  const bf16* dob = static_cast<const bf16*>(p.dout) + bi * p.sdo[0] +
                    hi * p.sdo[2];

  int k_end = len;
  if (p.causal) k_end = min(k_end, q0 + kM);
  if (pad_rows && q0 >= len) k_end = 0;  // every row padded: dq = 0
  const int k_begin = p.window ? max(0, q0 - p.window + 1) / kM * kM : 0;
  const int nk = k_end > k_begin ? (k_end - k_begin + kM - 1) / kM : 0;

  auto load_kv = [&](int j) {
    const uint32_t stage = ring + (j % kStages) * 2 * G::TILE;
    load_tile<HD>(stage, kb, p.sk[1], k_begin + j * kM, p.t);
    load_tile<HD>(stage + G::TILE, vb, p.sv[1], k_begin + j * kM, p.t);
  };
  load_tile<HD>(sq, qb, p.sq[1], q0, p.t);
  load_tile<HD>(sdo, dob, p.sdo[1], q0, p.t);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nk) load_kv(j);
    Ring::push();
  }

  // this thread's two rows, acc_row(0) and acc_row(2): lse log2(e),
  // delta and the keys each attends
  float lse2[2], delta[2];
  int first[2], last[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + hopper::acc_row(2 * h2);
    const long long at = (long long)bh * p.t + row;
    lse2[h2] = row < p.t ? p.lse[at] * kLog2e : 0.f;
    delta[h2] = row < p.t ? p.delta[at] : 0.f;
    key_range(p, row, len, pad_rows, first[h2], last[h2]);
  }
  const float c = p.scale * kLog2e;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    Ring::pop();
    if (j + kStages - 1 < nk) load_kv(j + kStages - 1);
    Ring::push();
    const int k0 = k_begin + j * kM;
    const uint32_t sk = ring + (j % kStages) * 2 * G::TILE;
    const uint32_t sv = sk + G::TILE;

    float s[32], dp[32];
    scores<HD>(sq, sk, sdo, sv, s, dp);
    // s becomes dS = P (dP - delta); masks only on tiles some mask cuts
    if (edge_tile(p, q0, k0, len, pad_rows)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h2 = (i >> 1) & 1, key = k0 + hopper::acc_col(i);
        const float x = key >= first[h2] && key <= last[h2]
                            ? fmaf(s[i], c, -lse2[h2]) : -INFINITY;
        s[i] = exp2_approx(x) * (dp[i] - delta[h2]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h2 = (i >> 1) & 1;
        s[i] = exp2_approx(fmaf(s[i], c, -lse2[h2])) * (dp[i] - delta[h2]);
      }
    }
    uint32_t ds_hi[16], ds_lo[16];
    hopper::split_hi_lo(s, ds_hi, ds_lo);
    hopper::fence();
    issue_hi_lo(acc, ds_hi, ds_lo, sk);  // dQ += dS k
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_operands(acc);
    hopper::fence_operands(ds_hi);
    hopper::fence_operands(ds_lo);
  }
  Ring::drain();

  bf16* dqb = static_cast<bf16*>(p.out) + bi * p.s1[0] + hi * p.s1[2];
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = q0 + hopper::acc_row(i);
    if (row < p.t)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * p.s1[1] +
                                         hopper::acc_col(i)) =
          __floats2bfloat162_rn(p.scale * acc[i], p.scale * acc[i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_bwd_dkv_tc_kernel(const Params p) {
  using G = Geo<HD>;
  using Ring = hopper::Ring<kStages>;
  extern __shared__ uint8_t smem[];
  const uint32_t smem0 = hopper::smem_u32(smem);
  const uint32_t sk = align_atom(smem0);
  const uint32_t sv = sk + G::TILE;
  const uint32_t ring = sv + G::TILE;  // stage s: q, dO, lse, delta

  const int k0 = (int)blockIdx.y * kM;  // early key tiles see most queries
  const int bkv = blockIdx.x;
  const int bi = bkv / p.kvh, kv = bkv % p.kvh;
  const int r = p.h / p.kvh;
  const int len = seq_len(p, bi);
  const bool pad_rows = p.lengths != nullptr;

  const bf16* kb = static_cast<const bf16*>(p.k) + bi * p.sk[0] +
                   kv * p.sk[2];
  const bf16* vb = static_cast<const bf16*>(p.v) + bi * p.sv[0] +
                   kv * p.sv[2];

  // query rows that can see a key of this tile
  int q_begin = p.causal ? k0 : 0;
  int q_end = pad_rows ? len : p.t;
  if (p.window) q_end = min(q_end, k0 + kM - 1 + p.window);
  if (k0 >= len) q_end = q_begin;  // every key padded: dk = dv = 0
  q_begin = q_begin / kM * kM;
  const int nq = q_end > q_begin ? (q_end - q_begin + kM - 1) / kM : 0;
  const int n = r * nq;  // query tiles of the whole GQA group

  auto load_q = [&](int j) {
    const uint32_t stage = ring + (j % kStages) * G::DKV_STAGE;
    const int hi = kv * r + j / nq, q0 = q_begin + (j % nq) * kM;
    const long long bh = (long long)bi * p.h + hi;
    load_tile<HD>(stage, static_cast<const bf16*>(p.q) + bi * p.sq[0] +
                             hi * p.sq[2], p.sq[1], q0, p.t);
    load_tile<HD>(stage + G::TILE, static_cast<const bf16*>(p.dout) +
                                       bi * p.sdo[0] + hi * p.sdo[2],
                  p.sdo[1], q0, p.t);
    // lse (threads 0-63) and delta (64-127) of the 64 rows, 4 bytes each:
    // a row of [b * h, t] starts 16-byte aligned only when t % 4 == 0
    const int row = q0 + threadIdx.x % kM;
    const bool ok = row < p.t;
    const float* src = (threadIdx.x < kM ? p.lse : p.delta) + bh * p.t +
                       (ok ? row : 0);
    hopper::cp_async4(stage + 2 * G::TILE + threadIdx.x * 4, src, ok);
  };
  load_tile<HD>(sk, kb, p.sk[1], k0, p.t);
  load_tile<HD>(sv, vb, p.sv[1], k0, p.t);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n) load_q(j);
    Ring::push();
  }

  int first[2], last[2];  // the query rows keys acc_row(0), acc_row(2) see
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
    query_range(p, k0 + hopper::acc_row(2 * h2), len, pad_rows, first[h2],
                last[h2]);
  const float c = p.scale * kLog2e;

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    Ring::pop();
    if (j + kStages - 1 < n) load_q(j + kStages - 1);
    Ring::push();
    const int q0 = q_begin + (j % nq) * kM;
    const uint32_t sq = ring + (j % kStages) * G::DKV_STAGE;
    const uint32_t sdo = sq + G::TILE;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (sq + 2 * G::TILE - smem0));
    const float* delta_s = lse_s + kM;

    float s[32], dp[32];  // S^T and dP^T: rows keys, columns queries
    scores<HD>(sk, sq, sv, sdo, s, dp);
    // lse log2(e) and delta of this thread's 16 query columns, column
    // acc_col(i) at (i / 4) * 2 + i % 2
    float lse2[16], delta[16];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = hopper::acc_col(4 * n8);
      const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
      lse2[2 * n8] = l.x * kLog2e;
      lse2[2 * n8 + 1] = l.y * kLog2e;
      delta[2 * n8] = dl.x;
      delta[2 * n8 + 1] = dl.y;
    }
    // s becomes P^T, dp dS^T; masks only on tiles some mask cuts
    if (edge_tile(p, q0, k0, len, pad_rows)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h2 = (i >> 1) & 1, cj = (i >> 2) * 2 + (i & 1);
        const int query = q0 + hopper::acc_col(i);
        const float x = query >= first[h2] && query <= last[h2]
                            ? fmaf(s[i], c, -lse2[cj]) : -INFINITY;
        s[i] = exp2_approx(x);
        dp[i] = s[i] * (dp[i] - delta[cj]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cj = (i >> 2) * 2 + (i & 1);
        s[i] = exp2_approx(fmaf(s[i], c, -lse2[cj]));
        dp[i] = s[i] * (dp[i] - delta[cj]);
      }
    }
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    hopper::split_hi_lo(s, p_hi, p_lo);
    hopper::split_hi_lo(dp, ds_hi, ds_lo);
    hopper::fence();
    issue_hi_lo(dv, p_hi, p_lo, sdo);   // dV += P^T dO
    issue_hi_lo(dk, ds_hi, ds_lo, sq);  // dK += dS^T q
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_operands(dk);
    hopper::fence_operands(dv);
    hopper::fence_operands(p_hi);
    hopper::fence_operands(p_lo);
    hopper::fence_operands(ds_hi);
    hopper::fence_operands(ds_lo);
  }
  Ring::drain();

  bf16* dkb = static_cast<bf16*>(p.out) + bi * p.s1[0] + kv * p.s1[2];
  bf16* dvb = static_cast<bf16*>(p.out2) + bi * p.s2[0] + kv * p.s2[2];
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int key = k0 + hopper::acc_row(i), c = hopper::acc_col(i);
    if (key < p.t) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * p.s1[1] + c) =
          __floats2bfloat162_rn(p.scale * dk[i], p.scale * dk[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * p.s2[1] + c) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

// The forward on the tensor cores: one warpgroup a (batch-head, 64-row
// query tile), the query tile loaded once, the (k, v) tiles walked by
// attn::attend (attention_tc.cuh) over the bounds dQ walks (causal,
// lengths, window, the ragged last tile). Padded query rows attend as in
// the reference's forward (pad_rows false).
template <int HD>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_fwd_tc_kernel(const Params p) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem[];
  const uint32_t sq = align_atom(hopper::smem_u32(smem));
  const uint32_t ring = sq + G::TILE;

  const int n_tiles = (p.t + kM - 1) / kM;
  const int q0 = (n_tiles - 1 - (int)blockIdx.y) * kM;  // heavy tiles first
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h, kv = hi / (p.h / p.kvh);
  const int len = seq_len(p, bi);

  const bf16* qb = static_cast<const bf16*>(p.q) + bi * p.sq[0] +
                   hi * p.sq[2];
  const bf16* kb = static_cast<const bf16*>(p.k) + bi * p.sk[0] +
                   kv * p.sk[2];
  const bf16* vb = static_cast<const bf16*>(p.v) + bi * p.sv[0] +
                   kv * p.sv[2];

  int k_end = len;
  if (p.causal) k_end = min(k_end, q0 + kM);
  const int k_begin = p.window ? max(0, q0 - p.window + 1) / kM * kM : 0;
  const int nk = k_end > k_begin ? (k_end - k_begin + kM - 1) / kM : 0;

  int first[2], last[2];  // the keys rows acc_row(0), acc_row(2) attend
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
    key_range(p, q0 + hopper::acc_row(2 * h2), len, false, first[h2],
              last[h2]);

  attn::Rows st;
  st.init();
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  load_tile<HD>(sq, qb, p.sq[1], q0, p.t);
  attn::attend<HD>(
      sq, ring, nk, k_begin,
      [&](int j, uint32_t stage) {
        load_tile<HD>(stage, kb, p.sk[1], k_begin + j * kM, p.t);
        load_tile<HD>(stage + G::TILE, vb, p.sv[1], k_begin + j * kM, p.t);
      },
      [&](int k0) { return edge_tile(p, q0, k0, len, false); }, first, last,
      p.scale * kLog2e, st, acc);
  st.finish();

  bf16* ob = static_cast<bf16*>(p.out) + bi * p.s1[0] + hi * p.s1[2];
  attn::store_out<HD>(acc, st, [&](int r, bf16*& dst) {
    dst = ob + (q0 + r) * p.s1[1];
    return q0 + r < p.t;
  });
  if (threadIdx.x % 4 == 0) {  // one thread of the quad writes lse
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = q0 + hopper::acc_row(2 * h2);
      if (row < p.t) p.lse[(long long)bh * p.t + row] = st.lse(h2);
    }
  }
}

template <int HD>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t stream) {
  const int tiles = (p.t + kM - 1) / kM;
  cudaError_t e;
  if (kind == kFwdTc) {
    constexpr size_t smem = Geo<HD>::FWD_SMEM;
    if ((e = allow_smem(flash_fwd_tc_kernel<HD>, smem)) != cudaSuccess)
      return e;
    flash_fwd_tc_kernel<HD>
        <<<dim3(p.b * p.h, tiles), kThreadsTc, smem, stream>>>(p);
  } else if (kind == kDqTc) {
    constexpr size_t smem = Geo<HD>::DQ_SMEM;
    if ((e = allow_smem(flash_bwd_dq_tc_kernel<HD>, smem)) != cudaSuccess)
      return e;
    flash_bwd_dq_tc_kernel<HD>
        <<<dim3(p.b * p.h, tiles), kThreadsTc, smem, stream>>>(p);
  } else {
    constexpr size_t smem = Geo<HD>::DKV_SMEM;
    if ((e = allow_smem(flash_bwd_dkv_tc_kernel<HD>, smem)) != cudaSuccess)
      return e;
    flash_bwd_dkv_tc_kernel<HD>
        <<<dim3(p.b * p.kvh, tiles), kThreadsTc, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------- launch

template <int NJ>
size_t smem_bytes(Kind kind) {
  constexpr size_t B = Tile<NJ>::B, DP = Tile<NJ>::DP;
  switch (kind) {
    case kFwd: return sizeof(float) * (3 * DP * B + B * B);
    case kDq: return sizeof(float) * (5 * DP * B + B * B);
    default: return sizeof(float) * (6 * DP * B + 2 * B * B + 2 * B);
  }
}

template <typename T, int NJ>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t stream) {
  constexpr int B = Tile<NJ>::B;
  const size_t smem = smem_bytes<NJ>(kind);
  const int tiles = (p.t + B - 1) / B;
  cudaError_t e;
  if (kind == kFwd) {
    if ((e = allow_smem(flash_fwd_kernel<T, NJ>, smem)) != cudaSuccess)
      return e;
    flash_fwd_kernel<T, NJ>
        <<<dim3(tiles, p.b * p.h), kThreads, smem, stream>>>(p);
  } else if (kind == kDq) {
    if ((e = allow_smem(flash_bwd_dq_kernel<T, NJ>, smem)) != cudaSuccess)
      return e;
    flash_bwd_dq_kernel<T, NJ>
        <<<dim3(tiles, p.b * p.h), kThreads, smem, stream>>>(p);
  } else if (kind == kDkv) {
    if ((e = allow_smem(flash_bwd_dkv_kernel<T, NJ>, smem)) != cudaSuccess)
      return e;
    flash_bwd_dkv_kernel<T, NJ>
        <<<dim3(tiles, p.b * p.kvh), kThreads, smem, stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(Kind kind, const Params& p, cudaStream_t stream) {
  if (kind == kDelta) {
    const long long rows = (long long)p.b * p.t * p.h;
    const int per_block = kThreads / kDeltaLanes;
    flash_bwd_delta_kernel<T>
        <<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0,
           stream>>>(p);
    return cudaGetLastError();
  }
  if (kind == kFwdTc || kind == kDqTc || kind == kDkvTc) {
    // the tensor-core kernels: bf16, head_dim 64 or 128 (the wrapper's rule)
    if (!std::is_same<T, __nv_bfloat16>::value) return cudaErrorInvalidValue;
    if (p.d == 64) return tc::launch<64>(kind, p, stream);
    if (p.d == 128) return tc::launch<128>(kind, p, stream);
    return cudaErrorInvalidValue;
  }
  switch ((p.d + 63) / 64) {
    case 1: return launch<T, 1>(kind, p, stream);
    case 2: return launch<T, 2>(kind, p, stream);
    case 3: return launch<T, 3>(kind, p, stream);
    case 4: return launch<T, 4>(kind, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// tensors: q, k, v, o, dO, out, out2, lse, lengths (null = none), delta
// strides: 3 per tensor (batch, seq, head) for q, k, v, o, dO, out, out2
// dims: b, t, h, kvh, d, causal, window
int run(Kind kind, void* const* tensors, const long long* strides,
        const int* dims, int dtype, int device, void* stream) {
  Params p;
  p.q = tensors[0];
  p.k = tensors[1];
  p.v = tensors[2];
  p.o = tensors[3];
  p.dout = tensors[4];
  p.out = tensors[5];
  p.out2 = tensors[6];
  p.lse = static_cast<float*>(tensors[7]);
  p.lengths = static_cast<const int*>(tensors[8]);
  p.delta = static_cast<float*>(tensors[9]);
  long long* dst[7] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.s1, p.s2};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  p.b = dims[0];
  p.t = dims[1];
  p.h = dims[2];
  p.kvh = dims[3];
  p.d = dims[4];
  p.causal = dims[5];
  p.window = dims[6];
  if (p.b <= 0 || p.t <= 0) return cudaSuccess;
  if (p.kvh <= 0 || p.h % p.kvh || p.d <= 0 || p.d % 8 ||
      p.d > kMaxHeadDim || p.window < 0 || (long long)p.b * p.h > 65535)
    return cudaErrorInvalidValue;
  p.scale = (float)(1.0 / sqrt((double)p.d));  // as Python's 1 / d ** 0.5
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(kind, p, s);
    case 1: return dispatch<__nv_bfloat16>(kind, p, s);
    case 2: return dispatch<__half>(kind, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int hvd_flash_fwd(void* const* tensors, const long long* strides,
                             const int* dims, int dtype, int device,
                             void* stream) {
  return run(kFwd, tensors, strides, dims, dtype, device, stream);
}

extern "C" int hvd_flash_fwd_tc(void* const* tensors, const long long* strides,
                                const int* dims, int dtype, int device,
                                void* stream) {
  return run(kFwdTc, tensors, strides, dims, dtype, device, stream);
}

extern "C" int hvd_flash_bwd_dq(void* const* tensors,
                                const long long* strides, const int* dims,
                                int dtype, int device, void* stream) {
  return run(kDq, tensors, strides, dims, dtype, device, stream);
}

extern "C" int hvd_flash_bwd_dkv(void* const* tensors,
                                 const long long* strides, const int* dims,
                                 int dtype, int device, void* stream) {
  return run(kDkv, tensors, strides, dims, dtype, device, stream);
}

extern "C" int hvd_flash_bwd_delta(void* const* tensors,
                                   const long long* strides, const int* dims,
                                   int dtype, int device, void* stream) {
  return run(kDelta, tensors, strides, dims, dtype, device, stream);
}

extern "C" int hvd_flash_bwd_dq_tc(void* const* tensors,
                                   const long long* strides, const int* dims,
                                   int dtype, int device, void* stream) {
  return run(kDqTc, tensors, strides, dims, dtype, device, stream);
}

extern "C" int hvd_flash_bwd_dkv_tc(void* const* tensors,
                                    const long long* strides,
                                    const int* dims, int dtype, int device,
                                    void* stream) {
  return run(kDkvTc, tensors, strides, dims, dtype, device, stream);
}

extern "C" const char* hvd_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
