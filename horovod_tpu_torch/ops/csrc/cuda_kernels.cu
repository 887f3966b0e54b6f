// Wire kernels for Hopper (sm_90a): the scale-cast, the two int8
// stochastic quantizers and the two passes of the Adasum combine.
//
// Replaces the Pallas kernels of horovod_tpu/ops/pallas_kernels.py, whose
// docstring names the reference's horovod/common/ops/cuda/cuda_kernels.cu
// as their model:
//
// * scale_cast (pallas_call at line 84, `_scale_cast_kernel`):
//   (float32(x) * s).astype(out), int8/f32/bf16/f16 in, f32/bf16/f16 out,
//   `s` read from device memory. `int8_dequantize` is this kernel.
// * int8_quantize (line 133, `_quantize_int8_body`): one scale
//   max(absmax, 1e-30) / 127 for the whole tensor (the product with
//   fp32(1/127) that XLA makes of the JAX wrapper's division), then each value
//   rounded stochastically to floor(x / scale) + (u < frac), clipped to
//   [-128, 127]. Two launches, no host sync between them: an absmax
//   pass writing one maximum a block (max is order-free, so it is exact),
//   and the rounding pass, which folds those into the scale. Both move
//   16 bytes a thread a load.
// * int8_block_quantize (line 221, the same body): one scale per `block`
//   elements of each row of a [rows, cols] view, blocks never crossing a
//   row, the short tail block of a row zero-padded for the absmax only.
//   One pass: a group of G threads owns a block, finds its absmax by
//   shuffles (and shared memory past a warp), then rounds the block,
//   whose bytes it has just read (L1/L2 hits, one HBM pass). G is the
//   block size rounded up to a power of two, at most 128, so a block of 1
//   or 3 takes one or four threads and a CTA of 128 threads holds 128/G
//   blocks; a block wider than 128 is walked in a loop.
// * adasum_pair (lines 304 and 315: `_adasum_dots_kernel`,
//   `_adasum_apply_kernel`): [a.b, a.a, b.b] with fp32 accumulation, then
//   ca * a + cb * b. The TPU kernel carries the three sums across its
//   sequential grid in SMEM; here blocks run in parallel, so the dots are
//   a deterministic two-stage reduction: per-CTA partials over a grid
//   whose size depends on n alone, then one CTA sums them in a fixed
//   order. No float atomics, so the same inputs give the same bits on
//   every rank and every run. The apply kernel computes the coefficients
//   1 - dot / (2 |a|^2) and 1 - dot / (2 |b|^2), each 1 where its norm is
//   0, from the three sums in device memory.
//
// Randomness. The TPU draws its bits from its own PRNG inside the kernel.
// Here `u` is a pure function of (seed, stream, element index): element i
// takes word i % 4 of Philox4x32-10 with counter (i / 4, 0, 0) and key
// (seed, stream), and u = (bits >> 8) * 2^-24. The plain PyTorch versions
// compute the same Philox in integer ops, and every division here is IEEE
// (no fast-math flags), so kernel and plain version agree bit for bit.
//
// What bounds them: device-memory bytes. Each reads its inputs once and
// writes its outputs once, with a few dozen integer operations per element
// for Philox (computed once per four elements); the per-tensor quantizer
// reads x twice, and its rounding pass is bound by that arithmetic (one
// Philox call a quad, an IEEE division an element), not by its bytes.
// The per-tensor quantizer loads 16 bytes a thread; the others load one
// element a thread, coalesced across a warp.
//
// Plain C interface, loaded with ctypes: device pointers, the device index
// and the caller's current stream in; cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // grid-stride kernels
constexpr int kBlockThreads = 128;  // block quantizer CTA
constexpr int kMaxGrid = 4096;
constexpr int kDotsMaxGrid = 1024;  // partials buffer: 3 x 1024 floats
constexpr unsigned kFullMask = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

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

// Philox4x32-10 (Salmon et al., SC 2011), the Random123 round function.
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The four words of quad `qi` (elements 4 qi .. 4 qi + 3).
__device__ __forceinline__ void quad_words(int64_t qi, uint32_t seed,
                                           uint32_t stream, uint32_t* w) {
  const uint64_t c = static_cast<uint64_t>(qi);
  const uint4 r = philox(static_cast<uint32_t>(c),
                         static_cast<uint32_t>(c >> 32), 0u, 0u, seed,
                         stream);
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}

// floor(x / scale) + (u < frac), clipped to [-128, 127].
__device__ __forceinline__ int8_t stochastic_round(float x, float scale,
                                                   uint32_t bits) {
  const float s = x / scale;
  const float f = floorf(s);
  const float frac = s - f;
  const float u = static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;
  float r = f + (u < frac ? 1.0f : 0.0f);
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rz(r));
}

// max(absmax, 1e-30) / 127 as XLA computes the JAX wrapper's division:
// a product with the fp32 reciprocal of 127.
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float scale_of(float absmax) {
  return fmaxf(absmax, 1e-30f) * kInv127;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

int grid_for(int64_t work, int threads, int cap) {
  int64_t g = (work + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > cap) g = cap;
  return static_cast<int>(g);
}

// ------------------------------------------------------------ scale_cast

template <typename Ti, typename To>
__global__ void __launch_bounds__(kThreads)
scale_cast_kernel(const Ti* __restrict__ x, const float* __restrict__ s,
                  To* __restrict__ out, int64_t n) {
  const float sc = *s;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step)
    out[i] = from_f32<To>(to_f32(x[i]) * sc);
}

template <typename Ti>
cudaError_t scale_cast_out(const void* x, const float* s, void* out,
                           int out_dtype, int64_t n, cudaStream_t st) {
  const int grid = grid_for(n, kThreads, kMaxGrid);
  const Ti* xi = static_cast<const Ti*>(x);
  switch (out_dtype) {
    case kF32:
      scale_cast_kernel<Ti, float><<<grid, kThreads, 0, st>>>(
          xi, s, static_cast<float*>(out), n);
      break;
    case kBF16:
      scale_cast_kernel<Ti, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
          xi, s, static_cast<__nv_bfloat16*>(out), n);
      break;
    case kF16:
      scale_cast_kernel<Ti, __half><<<grid, kThreads, 0, st>>>(
          xi, s, static_cast<__half*>(out), n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// --------------------------------------------------- per-tensor quantize
//
// Two passes over x, both in 16-byte accesses (4 fp32 or 8 two-byte
// values a thread a load; the int8 values of a load stored as one 4- or
// 8-byte word). The absmax pass writes one maximum a block into a
// partials buffer (max is order-free, so no atomics and no memset); the
// rounding pass's blocks each fold those partials into the scale. The
// absmax pass runs near the memory rate; the rounding pass is bound by
// its arithmetic, one Philox4x32-10 call a quad and an IEEE division an
// element, not by its bytes: walking it backwards, so that it starts on
// what the absmax pass left in L2, and one cooperative launch keeping
// part of x in shared memory across a grid-wide sync were both no
// faster in turns on the card (PERF.md).

constexpr int kQuantThreads = 256;
constexpr int kQuantMaxGrid = 1024;  // the partials buffer: this many floats
constexpr int kUnroll = 4;  // 16-byte loads a thread in flight

// 16 bytes of T as fp32 values: 4 for fp32, 8 for the two-byte types.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

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

template <typename T>
__device__ __forceinline__ float absmax16(const uint4& raw, float m) {
  float f[Vec16<T>::N];
  unpack16<T>(raw, f);
#pragma unroll
  for (int j = 0; j < Vec16<T>::N; ++j) m = fmaxf(m, fabsf(f[j]));
  return m;
}

// Round the 16 bytes of vector v (elements N v ..) and store their int8
// values as one word: one Philox call a quad, as element i takes word
// i % 4 of quad i / 4.
template <typename T>
__device__ __forceinline__ void round16(const uint4& raw, int64_t v,
                                        float scale, int8_t* q,
                                        uint32_t seed, uint32_t stream) {
  constexpr int N = Vec16<T>::N;
  float f[N];
  unpack16<T>(raw, f);
  uint32_t packed[N / 4];
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    uint32_t w[4];
    quad_words(v * (N / 4) + g, seed, stream, w);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= static_cast<uint32_t>(static_cast<uint8_t>(
                  stochastic_round(f[4 * g + j], scale, w[j])))
              << (8 * j);
    packed[g] = word;
  }
  if constexpr (N == 4) {
    reinterpret_cast<uint32_t*>(q)[v] = packed[0];
  } else {
    reinterpret_cast<uint2*>(q)[v] = make_uint2(packed[0], packed[1]);
  }
}

// The elements past the last whole vector, one a thread, scalar.
template <typename T>
__device__ __forceinline__ void round_tail(const T* x, int64_t n,
                                           float scale, int8_t* q,
                                           uint32_t seed, uint32_t stream) {
  const int64_t i = n / Vec16<T>::N * Vec16<T>::N + threadIdx.x;
  if (i < n) {
    uint32_t w[4];
    quad_words(i >> 2, seed, stream, w);
    q[i] = stochastic_round(to_f32(x[i]), scale, w[i & 3]);
  }
}

__device__ __forceinline__ float block_max(float m, float* part) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, part[w]);
  __syncthreads();  // part may be reused
  return m;
}

// Pass 1: block b's maximum |x| into partials[b].
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
absmax_kernel(const T* __restrict__ x, int64_t n,
              float* __restrict__ partials) {
  __shared__ float part[kQuantThreads / 32];
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int64_t nv = n / Vec16<T>::N;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float m = 0.0f;
  int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; v + (kUnroll - 1) * step < nv; v += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = __ldg(xv + v + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = absmax16<T>(raw[u], m);
  }
  for (; v < nv; v += step) m = absmax16<T>(__ldg(xv + v), m);
  if (blockIdx.x == 0) {
    const int64_t i = nv * Vec16<T>::N + threadIdx.x;
    if (i < n) m = fmaxf(m, fabsf(to_f32(x[i])));
  }
  m = block_max(m, part);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// Pass 2: the scale from the partials, then the values.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const T* __restrict__ x, int64_t n,
                const float* __restrict__ partials, int n_partials,
                float* __restrict__ scale_out, int8_t* __restrict__ q,
                uint32_t seed, uint32_t stream) {
  __shared__ float part[kQuantThreads / 32];
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += blockDim.x)
    m = fmaxf(m, partials[i]);
  const float scale = scale_of(block_max(m, part));
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int64_t nv = n / Vec16<T>::N;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; g + (kUnroll - 1) * step < nv; g += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      raw[u] = __ldg(xv + g + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      round16<T>(raw[u], g + u * step, scale, q, seed, stream);
  }
  for (; g < nv; g += step)
    round16<T>(__ldg(xv + g), g, scale, q, seed, stream);
  if (blockIdx.x == gridDim.x - 1) round_tail<T>(x, n, scale, q, seed, stream);
}

template <typename T>
cudaError_t quantize(const void* x, int64_t n, float* partials,
                     float* scale, int8_t* q, uint32_t seed, uint32_t stream,
                     cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int64_t nv = n / Vec16<T>::N;
  const int grid = grid_for(nv > 0 ? nv : 1, kQuantThreads, kQuantMaxGrid);
  absmax_kernel<T><<<grid, kQuantThreads, 0, st>>>(xt, n, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  quantize_kernel<T><<<grid, kQuantThreads, 0, st>>>(
      xt, n, partials, grid, scale, q, seed, stream);
  return cudaGetLastError();
}

// ------------------------------------------------------- block quantize

// G threads per block of `block` elements; kBlockThreads / G blocks per CTA.
template <typename T, int G>
__global__ void __launch_bounds__(kBlockThreads)
block_quantize_kernel(const T* __restrict__ x, int64_t rows, int64_t cols,
                      int64_t block, int64_t nb, int8_t* __restrict__ q,
                      float* __restrict__ scales, uint32_t seed,
                      uint32_t stream) {
  constexpr int kPer = kBlockThreads / G;
  __shared__ float part[kBlockThreads / 32];
  const int g = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kPer + g;
  const bool live = blk < rows * nb;
  int64_t s = 0, e = 0;
  if (live) {
    const int64_t row = blk / nb;
    const int64_t jb = blk - row * nb;
    const int64_t c0 = jb * block;
    const int64_t c1 = c0 + block < cols ? c0 + block : cols;
    s = row * cols + c0;
    e = row * cols + c1;
  }
  // absmax of the block; the tail's zero padding never raises it
  float m = 0.0f;
  for (int64_t i = s + lane; i < e; i += G) m = fmaxf(m, fabsf(to_f32(x[i])));
  if (G <= 32) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));
  } else {
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
    __syncthreads();
    const int w0 = (g * G) >> 5;
#pragma unroll
    for (int w = 0; w < G / 32; ++w) m = fmaxf(m, part[w0 + w]);
  }
  const float scale = scale_of(m);
  if (!live) return;
  if (lane == 0) scales[blk] = scale;
  // round, by quads of the flat index so each Philox call serves 4 values
  const int64_t q1 = (e + 3) >> 2;
  for (int64_t qi = (s >> 2) + lane; qi < q1; qi += G) {
    uint32_t w[4];
    quad_words(qi, seed, stream, w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = 4 * qi + j;
      if (i >= s && i < e) q[i] = stochastic_round(to_f32(x[i]), scale, w[j]);
    }
  }
}

template <typename T, int G>
cudaError_t block_quantize_g(const void* x, int64_t rows, int64_t cols,
                             int64_t block, int8_t* q, float* scales,
                             uint32_t seed, uint32_t stream,
                             cudaStream_t st) {
  const int64_t nb = (cols + block - 1) / block;
  const int64_t ctas = (rows * nb + kBlockThreads / G - 1) /
                       (kBlockThreads / G);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  block_quantize_kernel<T, G><<<static_cast<unsigned>(ctas), kBlockThreads,
                                0, st>>>(static_cast<const T*>(x), rows,
                                         cols, block, nb, q, scales, seed,
                                         stream);
  return cudaGetLastError();
}

template <typename T>
cudaError_t block_quantize(const void* x, int64_t rows, int64_t cols,
                           int64_t block, int8_t* q, float* scales,
                           uint32_t seed, uint32_t stream, cudaStream_t st) {
#define HVD_BQ(G)                                                         \
  return block_quantize_g<T, G>(x, rows, cols, block, q, scales, seed,    \
                                stream, st)
  if (block <= 1) HVD_BQ(1);
  if (block <= 2) HVD_BQ(2);
  if (block <= 4) HVD_BQ(4);
  if (block <= 8) HVD_BQ(8);
  if (block <= 16) HVD_BQ(16);
  if (block <= 32) HVD_BQ(32);
  if (block <= 64) HVD_BQ(64);
  HVD_BQ(128);
#undef HVD_BQ
}

// ---------------------------------------------------------------- adasum

template <typename T>
__global__ void __launch_bounds__(kThreads)
dots_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    int64_t n, float* __restrict__ partials) {
  __shared__ float part[3][kThreads / 32];
  float ab = 0.0f, aa = 0.0f, bb = 0.0f;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step) {
    const float x = to_f32(a[i]);
    const float y = to_f32(b[i]);
    ab += x * y;
    aa += x * x;
    bb += y * y;
  }
  ab = warp_sum(ab);
  aa = warp_sum(aa);
  bb = warp_sum(bb);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = ab;
    part[1][warp] = aa;
    part[2][warp] = bb;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float v = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) v += part[threadIdx.x][w];
    partials[threadIdx.x * gridDim.x + blockIdx.x] = v;
  }
}

// One CTA: out[k] = sum of partials[k][0 .. grid), in a fixed order.
__global__ void __launch_bounds__(kThreads)
dots_final_kernel(const float* __restrict__ partials, int grid,
                  float* __restrict__ out) {
  __shared__ float part[kThreads / 32];
  for (int k = 0; k < 3; ++k) {
    float v = 0.0f;
    for (int i = threadIdx.x; i < grid; i += kThreads)
      v += partials[k * grid + i];
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) t += part[w];
      out[k] = t;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ dots, T* __restrict__ out,
             int64_t n) {
  const float dot = dots[0], aa = dots[1], bb = dots[2];
  const float ca = 1.0f - (aa > 0.0f ? dot / (2.0f * aa) : 0.0f);
  const float cb = 1.0f - (bb > 0.0f ? dot / (2.0f * bb) : 0.0f);
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step)
    out[i] = from_f32<T>(ca * to_f32(a[i]) + cb * to_f32(b[i]));
}

template <typename T>
cudaError_t dots(const void* a, const void* b, int64_t n, float* partials,
                 float* out, cudaStream_t st) {
  // the grid depends on n alone, so the sum order does too
  const int grid = grid_for(n, kThreads * 8, kDotsMaxGrid);
  dots_partial_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), n, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dots_final_kernel<<<1, kThreads, 0, st>>>(partials, grid, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply(const void* a, const void* b, const float* d, void* out,
                  int64_t n, cudaStream_t st) {
  apply_kernel<T><<<grid_for(n, kThreads, kMaxGrid), kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), d,
      static_cast<T*>(out), n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hvd_scale_cast(const void* x, int in_dtype, const void* scale,
                              void* out, int out_dtype, long long n,
                              int device, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  switch (in_dtype) {
    case kF32: return scale_cast_out<float>(x, s, out, out_dtype, n, st);
    case kBF16:
      return scale_cast_out<__nv_bfloat16>(x, s, out, out_dtype, n, st);
    case kF16: return scale_cast_out<__half>(x, s, out, out_dtype, n, st);
    case kI8: return scale_cast_out<int8_t>(x, s, out, out_dtype, n, st);
    default: return cudaErrorInvalidValue;
  }
}

// x 16-byte aligned, q 8-byte aligned; `partials` holds kQuantMaxGrid
// floats of scratch.
extern "C" int hvd_int8_quantize(const void* x, int dtype, long long n,
                                 void* partials, void* scale, void* q,
                                 unsigned seed, unsigned stream_id,
                                 int device, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  float* sc = static_cast<float*>(scale);
  int8_t* qv = static_cast<int8_t*>(q);
  switch (dtype) {
    case kF32:
      return quantize<float>(x, n, part, sc, qv, seed, stream_id, st);
    case kBF16:
      return quantize<__nv_bfloat16>(x, n, part, sc, qv, seed, stream_id,
                                     st);
    case kF16:
      return quantize<__half>(x, n, part, sc, qv, seed, stream_id, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int hvd_int8_block_quantize(const void* x, int dtype,
                                       long long rows, long long cols,
                                       long long block, void* q,
                                       void* scales, unsigned seed,
                                       unsigned stream_id, int device,
                                       void* stream) {
  if (block < 1) return cudaErrorInvalidValue;
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qv = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scales);
  switch (dtype) {
    case kF32:
      return block_quantize<float>(x, rows, cols, block, qv, sc, seed,
                                   stream_id, st);
    case kBF16:
      return block_quantize<__nv_bfloat16>(x, rows, cols, block, qv, sc,
                                           seed, stream_id, st);
    case kF16:
      return block_quantize<__half>(x, rows, cols, block, qv, sc, seed,
                                    stream_id, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int hvd_adasum_dots(const void* a, const void* b, int dtype,
                               long long n, void* partials, void* out,
                               int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case kF32: return dots<float>(a, b, n, p, o, st);
    case kBF16: return dots<__nv_bfloat16>(a, b, n, p, o, st);
    case kF16: return dots<__half>(a, b, n, p, o, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int hvd_adasum_apply(const void* a, const void* b,
                                const void* dots_in, void* out, int dtype,
                                long long n, int device, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dots_in);
  switch (dtype) {
    case kF32: return apply<float>(a, b, d, out, n, st);
    case kBF16: return apply<__nv_bfloat16>(a, b, d, out, n, st);
    case kF16: return apply<__half>(a, b, d, out, n, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* hvd_wire_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
