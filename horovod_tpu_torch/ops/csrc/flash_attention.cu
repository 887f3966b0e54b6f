// Flash attention for Hopper (sm_90a): the FlashAttention-2 forward and its
// two backward kernels, fp32 statistics and accumulators whatever the input
// type.
//
// Replaces the three Pallas kernels of horovod_tpu/ops/flash_attention.py:
//
// * hvd_flash_fwd     <- `_fwd_kernel`, pallas_call at line 513 (_flash_fwd):
//   o = softmax(scale * q k^T) v with the online softmax, and the per-row
//   lse = m + log(max(l, 1e-30)). q is scaled before the product and P V
//   runs in fp32, as there.
// * hvd_flash_bwd_dq  <- `_dq_kernel`, pallas_call at line 621
//   (_flash_bwd_impl): P = exp(scale * q k^T - lse) recomputed from the saved
//   lse, dS = P * (dO v^T - rowsum(dO * O)), dQ = scale * dS k.
// * hvd_flash_bwd_dkv <- `_dkv_kernel`, pallas_call at line 633: per key tile,
//   dV += P^T dO and dK += scale * dS^T q over the query tiles of every query
//   head of the key's GQA group (the group sum happens here; K/V are never
//   repeated).
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
// h 16, t 512, d 64, causal, bf16) each kernel moves ~34-59 MB, about 10-18 us
// at 3.35 TB/s, against 4.3-8.6 GFLOP, 4-9 us at the bf16 tensor-core peak:
// bytes bound them. This first version runs its products on the CUDA cores
// in fp32 (67 TFLOP/s peak), so in practice the multiply-adds bound it; the
// design keeps them fed from shared memory:
//
// * The grid is Hopper's, not the TPU's sequential one: one block per
//   (batch-head, query tile) for the forward and dQ, one per (batch-kv-head,
//   key tile) for dK/dV, all independent, heaviest causal tiles first. The
//   sequential grid axis of the Pallas kernels becomes the loop inside a block.
// * A block stages 64x64 tiles (32x32 past head_dim 128) of its operands in
//   shared memory as fp32, the ones read along head_dim transposed, so that
//   each of the 16x16 threads reads 4-wide vectors and does 16 multiply-adds
//   per two shared loads in every product. The softmax state (m, l) and the
//   output accumulator stay in registers; row reductions are half-warp
//   shuffles.
// * Tensors are read through their (batch, seq, head) strides in the model's
//   [b, t, h, d] layout: q, k and v straight out of the fused qkv projection,
//   with no transposed copy. head_dim is any multiple of 8 up to 256.
//
// wgmma on TMA-staged bf16 tiles is later work (ROADMAP B5/B6).
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

// rowsum(dO * O) of row `row` over this thread's columns tx, tx + 16, ...,
// summed across the half-warp: every lane of the row group gets the total.
template <typename T>
__device__ __forceinline__ float row_delta(const Params& p, const T* ob,
                                           const T* dob, int row, int tx) {
  float acc = 0.f;
  if (row < p.t) {
    const T* orow = ob + row * p.so[1];
    const T* drow = dob + row * p.sdo[1];
    for (int c = tx; c < p.d; c += 16)
      acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
  }
  return half_sum(acc);
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
  const T* ob = static_cast<const T*>(p.o) + bi * p.so[0] + hi * p.so[2];
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
    delta[i] = row_delta(p, ob, dob, row, tx);
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
  constexpr int TPR = kThreads / B;  // threads per query row for delta
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
    const T* ob = static_cast<const T*>(p.o) + bi * p.so[0] + hi * p.so[2];
    const T* dob =
        static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[2];
    for (int q0 = q_begin; q0 < q_end; q0 += B) {
      __syncthreads();  // the previous query tile's reads are done
      stage_t<T, B, DP>(qb, p.sq[1], q0, p.t, p.d, 1.f, qt);
      stage_t<T, B, DP>(dob, p.sdo[1], q0, p.t, p.d, 1.f, dot);
      stage_rows<T, B, DP>(qb, p.sq[1], q0, p.t, p.d, qs);
      stage_rows<T, B, DP>(dob, p.sdo[1], q0, p.t, p.d, dos);
      {
        // delta and lse of the tile's rows: TPR threads per row
        const int row_l = threadIdx.x / TPR, sub = threadIdx.x % TPR;
        const int row = q0 + row_l;
        float acc = 0.f;
        if (row < p.t) {
          const T* orow = ob + row * p.so[1];
          const T* drow = dob + row * p.sdo[1];
          for (int c = sub; c < p.d; c += TPR)
            acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          acc += __shfl_xor_sync(kFullMask, acc, o);
        if (sub == 0) {
          delta_s[row_l] = acc;
          lse_s[row_l] = row < p.t ? p.lse[(long long)bh * p.t + row] : 0.f;
        }
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

// ---------------------------------------------------------------- launch

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <int NJ>
size_t smem_bytes(Kind kind) {
  constexpr size_t B = Tile<NJ>::B, DP = Tile<NJ>::DP;
  switch (kind) {
    case kFwd: return sizeof(float) * (3 * DP * B + B * B);
    case kDq: return sizeof(float) * (5 * DP * B + B * B);
    default: return sizeof(float) * (6 * DP * B + 2 * B * B + 2 * B);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  } else {
    if ((e = allow_smem(flash_bwd_dkv_kernel<T, NJ>, smem)) != cudaSuccess)
      return e;
    flash_bwd_dkv_kernel<T, NJ>
        <<<dim3(tiles, p.b * p.kvh), kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(Kind kind, const Params& p, cudaStream_t stream) {
  switch ((p.d + 63) / 64) {
    case 1: return launch<T, 1>(kind, p, stream);
    case 2: return launch<T, 2>(kind, p, stream);
    case 3: return launch<T, 3>(kind, p, stream);
    case 4: return launch<T, 4>(kind, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// tensors: q, k, v, o, dO, out, out2, lse, lengths (null = none)
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

extern "C" const char* hvd_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
