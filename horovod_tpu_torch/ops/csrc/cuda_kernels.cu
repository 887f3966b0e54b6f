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
//   One pass that reads x from device memory once: at the blocks the
//   paths use (512), a warp owns a block and keeps it in registers from
//   its absmax to its rounding; smaller and larger blocks take the
//   variants described at the kernels below.
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
// Philox call a quad, an IEEE division an element), not by its bytes;
// the block quantizer does the same arithmetic on one read.
// The quantizers load 16 bytes a thread; the others load one element a
// thread, coalesced across a warp.
//
// Plain C interface, loaded with ctypes: device pointers, the device index
// and the caller's current stream in; cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // grid-stride kernels
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

// The int8 values of N rounded values f of one vector whose first quad is
// quad0, packed four to a word: one Philox call a quad.
template <int N>
__device__ __forceinline__ void pack_vec(const float* f, int64_t quad0,
                                         float scale, uint32_t seed,
                                         uint32_t stream, uint32_t* packed) {
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    uint32_t w[4];
    quad_words(quad0 + g, seed, stream, w);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= static_cast<uint32_t>(static_cast<uint8_t>(
                  stochastic_round(f[4 * g + j], scale, w[j])))
              << (8 * j);
    packed[g] = word;
  }
}

// Round the 16 bytes of vector v (elements N v ..) of x.
template <typename T>
__device__ __forceinline__ void round16(const uint4& raw, int64_t v,
                                        float scale, int8_t* q,
                                        uint32_t seed, uint32_t stream) {
  constexpr int N = Vec16<T>::N;
  float f[N];
  unpack16<T>(raw, f);
  uint32_t packed[N / 4];
  pack_vec<N>(f, v * (N / 4), scale, seed, stream, packed);
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
//
// One scale per `block` elements of each row of a [rows, cols] view
// (rows = 1 for the flat form). Four variants; the wrapper picks one from
// the block size alone (`block_quantize_variant` in ops/cuda_kernels.py)
// and the entry below refuses a variant that cannot take the block:
//
// * warp (32 <= block <= 2048), the main path's (block 512): a warp owns
//   a block and keeps it in registers from its absmax to its rounding, so
//   every byte of x is read from device memory once. Lane l takes the
//   block's 16-byte vectors l, l + 32, l + 64, ..., so each warp
//   instruction reads 512 contiguous bytes, and issues all of them before
//   the first use; the absmax is a lane maximum and five xor shuffles (no
//   shared memory); lane 0 writes the scale. A CTA holds 8 warps, each its
//   own block, on a grid sized from the number of blocks. K, the vector
//   slots a lane has, is a template parameter: at most 17 (2048 fp32
//   values a warp, 68 registers of data a lane).
// * lanes (block < 32): G = the block size rounded up to a power of two
//   threads a block, 32 / G blocks a warp, the absmax by shuffles within
//   each G-lane segment; x is read again for the rounding (from L1).
// * cta (2048 < block <= 8192): a CTA of 256 threads a block, the block
//   staged in 32 KB of shared memory as fp32 between the absmax and the
//   rounding: one read.
// * cta_reread (block > 8192): as cta, but the rounding reads the block
//   again (from L2) instead of from shared memory.
//
// Element i of the flat [rows * cols] index lies in vector i / N (N = 16 /
// sizeof(T)) and takes word i % 4 of Philox quad i / 4, so a vector holds
// whole quads and, when x's base is 16-byte aligned, is one 16-byte load
// wherever a block starts. Only a block's first and last vector can be
// partial (a row length or block size that is not a multiple of N): those
// take predicated scalar loads, zero elsewhere (the absmax ignores zeros),
// and byte stores of the block's own elements; a vector two blocks share
// is loaded by both, and each writes only its own. Interior vectors do no
// per-element test and store their int8 values as one word. A base that
// is not 16-byte aligned (`aligned` false, the wrapper's rule) takes
// scalar loads for every vector. Offsets inside a block are 32-bit in the
// warp variant.
//
// What bounds it: one Philox4x32-10 call a quad and an IEEE division an
// element, as in the per-tensor quantizer's rounding pass, near the byte
// bound of one read of x and one write of the values and scales.

constexpr int kLanesThreads = 128;  // lanes variant CTA
constexpr int kWarpCtaThreads = 256;  // warp variant CTA: 8 blocks
constexpr int kCtaThreads = 256;  // cta variants: one block a CTA
constexpr int kWarpMaxBlock = 2048;
constexpr int kStageMax = 8192;  // fp32 values staged by the cta variant

enum BlockVariant { kLanes = 0, kWarp = 1, kCta = 2, kCtaReread = 3 };

// Where block `blk` lies: its first vector v0, the elements of v0 before
// it (head), head plus its length (span), and the vectors it touches.
struct BlockSpan {
  int64_t v0, head, span, nv;
};

// Row and block-in-row of flat block `blk`: none for one row, a 32-bit
// division while the count fits.
__device__ __forceinline__ void row_of(int64_t blk, int64_t nb,
                                       int64_t nblocks, int64_t* row,
                                       int64_t* jb) {
  *row = 0;
  if (nb != nblocks)
    *row = nblocks <= 0xffffffffLL
               ? static_cast<uint32_t>(blk) / static_cast<uint32_t>(nb)
               : blk / nb;
  *jb = blk - *row * nb;
}

template <int N>
__device__ __forceinline__ BlockSpan block_span(int64_t blk, int64_t cols,
                                                int64_t block, int64_t nb,
                                                int64_t nblocks) {
  int64_t row, jb;
  row_of(blk, nb, nblocks, &row, &jb);
  const int64_t c0 = jb * block;
  const int64_t len = c0 + block < cols ? block : cols - c0;
  const int64_t s = row * cols + c0;
  BlockSpan b;
  b.v0 = s / N;
  b.head = s - b.v0 * N;
  b.span = b.head + len;
  b.nv = (b.span + N - 1) / N;
  return b;
}

// Elements lo .. lo + N - 1 of xb that lie in [head, span), one scalar
// load each; zero bits (+0 in every type) elsewhere.
template <typename T>
__device__ __forceinline__ uint4 load_part(const T* xb, int64_t lo,
                                           int64_t head, int64_t span) {
  constexpr int N = Vec16<T>::N;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int64_t i = lo + j;
    if (i >= head && i < span) {
      if constexpr (sizeof(T) == 4) {
        w[j] = __ldg(reinterpret_cast<const unsigned int*>(xb) + i);
      } else {
        w[j / 2] |= static_cast<uint32_t>(__ldg(
                        reinterpret_cast<const unsigned short*>(xb) + i))
                    << (16 * (j & 1));
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store a vector's packed values at qv (local offset lo from the block's
// first vector): one word for a whole vector, else a byte for each of its
// elements in [head, span) (a block's first and last vector, which the
// neighbouring block may share).
template <int N>
__device__ __forceinline__ void store_vec(const uint32_t* packed, int8_t* qv,
                                          int64_t lo, int64_t head,
                                          int64_t span) {
  if (lo >= head && lo + N <= span) {
    if constexpr (N == 4)
      *reinterpret_cast<uint32_t*>(qv) = packed[0];
    else
      *reinterpret_cast<uint2*>(qv) = make_uint2(packed[0], packed[1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (lo + j >= head && lo + j < span)
        qv[j] = static_cast<int8_t>(packed[j / 4] >> (8 * (j % 4)));
  }
}

// warp variant: a warp a block in registers. K - 1 slots a lane hold an
// aligned whole block, and their values are rounded unconditionally (a
// slot past the block rounds zeros and stores nothing), so that their
// Philox chains interleave. A block that starts inside a vector touches
// one vector more (129 of 512 fp32), which lane 0 holds in slot K - 1 and
// rounds in a round of its own. (Handing those vectors to one round of
// the CTA's first warp, through shared memory and a barrier, was slower
// on the card: PERF.md.)
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kWarpCtaThreads)
block_quantize_warp_kernel(const T* __restrict__ x, int64_t cols,
                           int64_t block, int64_t nb, int64_t nblocks,
                           int8_t* __restrict__ q,
                           float* __restrict__ scales, uint32_t seed,
                           uint32_t stream) {
  constexpr int N = Vec16<T>::N;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) *
                          (kWarpCtaThreads / 32) +
                      (threadIdx.x >> 5);
  if (blk >= nblocks) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const BlockSpan b = block_span<N>(blk, cols, block, nb, nblocks);
  const int head = static_cast<int>(b.head);
  const int span = static_cast<int>(b.span);
  const int nv = static_cast<int>(b.nv);
  const T* xb = x + b.v0 * N;
  int8_t* qb = q + b.v0 * N;
  const int64_t quad0 = b.v0 * (N / 4);
  uint4 raw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = lane + 32 * k;
    const int lo = v * N;
    if (VEC && lo >= head && lo + N <= span)
      raw[k] = __ldg(reinterpret_cast<const uint4*>(xb) + v);
    else if (v < nv)
      raw[k] = load_part<T>(xb, lo, head, span);
    else
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) m = absmax16<T>(raw[k], m);
  const float scale = scale_of(warp_max(m));
  if (lane == 0) scales[blk] = scale;
  uint32_t packed[K][N / 4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k == K - 1 && 32 * k >= nv) break;  // warp-uniform
    float f[N];
    unpack16<T>(raw[k], f);
    pack_vec<N>(f, quad0 + (lane + 32 * k) * (N / 4), scale, seed, stream,
                packed[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = lane + 32 * k;
    if (v < nv) store_vec<N>(packed[k], qb + v * N, v * N, head, span);
  }
}

// lanes variant: G threads a block, kLanesThreads / G blocks a CTA.
template <typename T, int G>
__global__ void __launch_bounds__(kLanesThreads)
block_quantize_lanes_kernel(const T* __restrict__ x, int64_t cols,
                            int64_t block, int64_t nb, int64_t nblocks,
                            int8_t* __restrict__ q,
                            float* __restrict__ scales, uint32_t seed,
                            uint32_t stream) {
  constexpr int kPer = kLanesThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t blk =
      static_cast<int64_t>(blockIdx.x) * kPer + threadIdx.x / G;
  const bool live = blk < nblocks;
  int64_t s = 0, e = 0;
  if (live) {
    int64_t row, jb;
    row_of(blk, nb, nblocks, &row, &jb);
    const int64_t c0 = jb * block;
    s = row * cols + c0;
    e = row * cols + (c0 + block < cols ? c0 + block : cols);
  }
  float m = 0.0f;
  for (int64_t i = s + lane; i < e; i += G) m = fmaxf(m, fabsf(to_f32(x[i])));
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)  // within each G-lane segment
    m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));
  const float scale = scale_of(m);
  if (!live) return;
  if (lane == 0) scales[blk] = scale;
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

// cta variants: a CTA a block; STAGED keeps it in shared memory as fp32.
template <typename T, bool STAGED, bool VEC>
__global__ void __launch_bounds__(kCtaThreads)
block_quantize_cta_kernel(const T* __restrict__ x, int64_t cols,
                          int64_t block, int64_t nb, int64_t nblocks,
                          int8_t* __restrict__ q, float* __restrict__ scales,
                          uint32_t seed, uint32_t stream) {
  constexpr int N = Vec16<T>::N;
  __shared__ float part[kCtaThreads / 32];
  __shared__ __align__(16) float stage[STAGED ? kStageMax + 2 * N : 4];
  const int64_t blk = blockIdx.x;
  const BlockSpan b = block_span<N>(blk, cols, block, nb, nblocks);
  const T* xb = x + b.v0 * N;
  int8_t* qb = q + b.v0 * N;
  const int64_t quad0 = b.v0 * (N / 4);
  float m = 0.0f;
  for (int64_t v = threadIdx.x; v < b.nv; v += kCtaThreads) {
    const int64_t lo = v * N;
    const uint4 raw = VEC && lo >= b.head && lo + N <= b.span
                          ? __ldg(reinterpret_cast<const uint4*>(xb) + v)
                          : load_part<T>(xb, lo, b.head, b.span);
    m = absmax16<T>(raw, m);
    if constexpr (STAGED) {
      float f[N];
      unpack16<T>(raw, f);
#pragma unroll
      for (int j = 0; j < N; j += 4)
        *reinterpret_cast<float4*>(stage + lo + j) =
            make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
  }
  const float scale = scale_of(block_max(m, part));  // orders the stage
  if (threadIdx.x == 0) scales[blk] = scale;
  for (int64_t v = threadIdx.x; v < b.nv; v += kCtaThreads) {
    const int64_t lo = v * N;
    float f[N];
    if constexpr (STAGED) {
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        const float4 s4 = *reinterpret_cast<const float4*>(stage + lo + j);
        f[j] = s4.x;
        f[j + 1] = s4.y;
        f[j + 2] = s4.z;
        f[j + 3] = s4.w;
      }
    } else {
      unpack16<T>(VEC && lo >= b.head && lo + N <= b.span
                      ? __ldg(reinterpret_cast<const uint4*>(xb) + v)
                      : load_part<T>(xb, lo, b.head, b.span),
                  f);
    }
    uint32_t packed[N / 4];
    pack_vec<N>(f, quad0 + v * (N / 4), scale, seed, stream, packed);
    store_vec<N>(packed, qb + lo, lo, b.head, b.span);
  }
}

template <typename T, int K>
cudaError_t launch_warp(const T* x, int64_t cols, int64_t block,
                        int64_t nb, int64_t nblocks, bool aligned,
                        int8_t* q, float* scales, uint32_t seed,
                        uint32_t stream, cudaStream_t st) {
  const int64_t ctas = (nblocks + kWarpCtaThreads / 32 - 1) /
                       (kWarpCtaThreads / 32);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(ctas);
  if (aligned)
    block_quantize_warp_kernel<T, K, true><<<grid, kWarpCtaThreads, 0, st>>>(
        x, cols, block, nb, nblocks, q, scales, seed, stream);
  else
    block_quantize_warp_kernel<T, K, false><<<grid, kWarpCtaThreads, 0,
                                              st>>>(
        x, cols, block, nb, nblocks, q, scales, seed, stream);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_lanes(const T* x, int64_t cols, int64_t block,
                         int64_t nb, int64_t nblocks, int8_t* q,
                         float* scales, uint32_t seed, uint32_t stream,
                         cudaStream_t st) {
  const int64_t ctas = (nblocks + kLanesThreads / G - 1) /
                       (kLanesThreads / G);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  block_quantize_lanes_kernel<T, G><<<static_cast<unsigned>(ctas),
                                      kLanesThreads, 0, st>>>(
      x, cols, block, nb, nblocks, q, scales, seed, stream);
  return cudaGetLastError();
}

template <typename T, bool STAGED>
cudaError_t launch_cta(const T* x, int64_t cols, int64_t block, int64_t nb,
                       int64_t nblocks, bool aligned, int8_t* q,
                       float* scales, uint32_t seed, uint32_t stream,
                       cudaStream_t st) {
  if (nblocks > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (aligned)
    block_quantize_cta_kernel<T, STAGED, true><<<grid, kCtaThreads, 0, st>>>(
        x, cols, block, nb, nblocks, q, scales, seed, stream);
  else
    block_quantize_cta_kernel<T, STAGED, false><<<grid, kCtaThreads, 0,
                                                  st>>>(
        x, cols, block, nb, nblocks, q, scales, seed, stream);
  return cudaGetLastError();
}

template <typename T>
cudaError_t block_quantize(const void* xv, int64_t rows, int64_t cols,
                           int64_t block, int variant, bool aligned,
                           int8_t* q, float* scales, uint32_t seed,
                           uint32_t stream, cudaStream_t st) {
  constexpr int N = Vec16<T>::N;
  const T* x = static_cast<const T*>(xv);
  const int64_t nb = (cols + block - 1) / block;
  const int64_t nblocks = rows * nb;
  switch (variant) {
    case kLanes:
#define HVD_LANES(G) \
  return launch_lanes<T, G>(x, cols, block, nb, nblocks, q, scales, seed, \
                            stream, st)
      if (block <= 1) HVD_LANES(1);
      if (block <= 2) HVD_LANES(2);
      if (block <= 4) HVD_LANES(4);
      if (block <= 8) HVD_LANES(8);
      if (block <= 16) HVD_LANES(16);
      HVD_LANES(32);
#undef HVD_LANES
    case kWarp: {
      if (block > kWarpMaxBlock) return cudaErrorInvalidValue;
      // K - 1 slots a lane hold an aligned whole block's vectors
      const int64_t k = ((block + N - 1) / N + 31) / 32 + 1;
#define HVD_WARP(K)                                                        \
  return launch_warp<T, K>(x, cols, block, nb, nblocks, aligned, q, scales, \
                           seed, stream, st)
      if (k <= 2) HVD_WARP(2);
      if (k <= 3) HVD_WARP(3);
      if (k <= 5) HVD_WARP(5);
      if (k <= 9) HVD_WARP(9);
      HVD_WARP(17);
#undef HVD_WARP
    }
    case kCta:
      if (block > kStageMax) return cudaErrorInvalidValue;
      return launch_cta<T, true>(x, cols, block, nb, nblocks, aligned, q,
                                 scales, seed, stream, st);
    case kCtaReread:
      return launch_cta<T, false>(x, cols, block, nb, nblocks, aligned, q,
                                  scales, seed, stream, st);
    default:
      return cudaErrorInvalidValue;
  }
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

// `variant` is a BlockVariant, picked by the wrapper from the block size;
// `aligned` says x's base is 16-byte aligned (q is always).
extern "C" int hvd_int8_block_quantize(const void* x, int dtype,
                                       long long rows, long long cols,
                                       long long block, int variant,
                                       int aligned, void* q, void* scales,
                                       unsigned seed, unsigned stream_id,
                                       int device, void* stream) {
  if (block < 1) return cudaErrorInvalidValue;
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qv = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scales);
  switch (dtype) {
    case kF32:
      return block_quantize<float>(x, rows, cols, block, variant,
                                   aligned != 0, qv, sc, seed, stream_id,
                                   st);
    case kBF16:
      return block_quantize<__nv_bfloat16>(x, rows, cols, block, variant,
                                           aligned != 0, qv, sc, seed,
                                           stream_id, st);
    case kF16:
      return block_quantize<__half>(x, rows, cols, block, variant,
                                    aligned != 0, qv, sc, seed, stream_id,
                                    st);
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
