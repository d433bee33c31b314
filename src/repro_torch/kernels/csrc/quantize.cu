// Blocked int8 affine quantization of a flat f32 vector on Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quantize.py
// (quantize_int8_blocked, _kernel): for x (n,) f32 cut into blocks of
// `block` elements (the last one short, read as if zero-padded),
// scale[b] = max(absmax(block b), 1e-12) / 127 in f32 and
// q = clip(round_half_even(x / scale[b]), -127, 127) as int8.
//
// What bounds it: bytes. At the FEMNIST CNN's n = 6,603,710 and block
// 1024 it reads 26.4 MB and writes 6.6 MB of codes and 26 KB of scales:
// 9.9 us at 3.35 TB/s, about the time of a launch. So the design does
// nothing but that one pass, in one launch: no pad copy (the short last
// block is masked here), no plan, no memset, no scratch.
//
// - block <= 1024 (quantize_warp_kernel): one warp a block, 8 blocks a
//   CTA. A lane holds its share of the block in registers (at most 8
//   float4 words at block 1024, loaded with streaming hints, all in
//   flight at once), so every element is read once: the block's max by
//   warp shuffles, then the codes from the registers.
// - block > 1024 (quantize_cta_kernel): one CTA of 1024 threads a block,
//   the max through shared memory, then the codes from a second read
//   (from L2 for blocks that fit there). No runtime path uses it.
// - Vector path (kVec) where x is 16-byte and q 4-byte aligned and block
//   is a multiple of 4, so that every block starts on a word: float4
//   loads, codes stored a 32-bit word (4 codes) at a time; the last
//   block's cut word element by element. Any other base or block size
//   takes the scalar path (one element a load, one code a store). The
//   wrapper chooses the path (kernels/quantize.py quantize_plan) and the
//   launcher refuses a vector path whose alignment does not hold.
// - |x|'s max is taken on the bits with the sign cleared: for
//   non-negative floats the integer order is the float order, and any
//   NaN orders above +inf, so a NaN propagates into the scale as it does
//   through jnp.max. x / s is __fdiv_rn, rounding rintf (half to even,
//   never roundf): no fast math anywhere.
//
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpBlock = 1024;  // the largest block one warp takes
constexpr int kWords = kWarpBlock / 4 / 32;  // float4 words a lane holds
constexpr int kWarpCta = 256;     // 8 warps, 8 blocks, a CTA
constexpr int kCtaThreads = 1024;

__device__ __forceinline__ unsigned absbits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ float scale_of(unsigned bits) {
  const float a = __uint_as_float(bits);
  // a < floor is false for NaN, so NaN passes through (jnp.maximum)
  const float m = (a < 1e-12f) ? 1e-12f : a;
  return __fdiv_rn(m, 127.0f);
}

__device__ __forceinline__ int code(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
}

// four codes packed in a word, the first in the low byte
__device__ __forceinline__ uint32_t code4(float4 v, float s) {
  return (uint32_t)(code(v.x, s) & 0xff) |
         (uint32_t)(code(v.y, s) & 0xff) << 8 |
         (uint32_t)(code(v.z, s) & 0xff) << 16 |
         (uint32_t)(code(v.w, s) & 0xff) << 24;
}

__device__ __forceinline__ unsigned max4(float4 v) {
  return max(max(absbits(v.x), absbits(v.y)),
             max(absbits(v.z), absbits(v.w)));
}

// the word of elements [e, e + 4) cut by the end `len` (zeros past it)
__device__ __forceinline__ float4 cut_word(const float* x, int e, int len) {
  return make_float4(e < len ? x[e] : 0.f, e + 1 < len ? x[e + 1] : 0.f,
                     e + 2 < len ? x[e + 2] : 0.f,
                     e + 3 < len ? x[e + 3] : 0.f);
}

__device__ __forceinline__ void store_cut(int8_t* q, int e, int len,
                                          uint32_t c) {
  for (int j = 0; j < 4 && e + j < len; ++j) q[e + j] = (int8_t)(c >> 8 * j);
}

template <bool kVec>
__global__ void __launch_bounds__(kWarpCta)
    quantize_warp_kernel(const float* __restrict__ x, int64_t n, int block,
                         int64_t nb, int8_t* __restrict__ q,
                         float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      (int64_t)blockIdx.x * (kWarpCta / 32) + (threadIdx.x >> 5);
  if (b >= nb) return;
  const int64_t e0 = b * block;
  const int len = (int)min((int64_t)block, n - e0);
  const float* xb = x + e0;
  int8_t* qb = q + e0;
  unsigned m = 0u;
  if constexpr (kVec) {
    // words [0, nw) whole; word nw cut by the end of a short last block
    const int nw = len >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    float4 v[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = lane + 32 * k;
      v[k] = w < nw ? __ldcs(x4 + w)
                    : (w == nw ? cut_word(xb, 4 * w, len)
                               : make_float4(0.f, 0.f, 0.f, 0.f));
      m = max(m, max4(v[k]));
    }
    const float s = scale_of(__reduce_max_sync(0xffffffffu, m));
    if (lane == 0) scale[b] = s;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = lane + 32 * k;
      if (w < nw)
        __stcs(reinterpret_cast<unsigned*>(qb) + w, code4(v[k], s));
      else if (w == nw)
        store_cut(qb, 4 * w, len, code4(v[k], s));
    }
  } else {
    float v[4 * kWords];
#pragma unroll
    for (int k = 0; k < 4 * kWords; ++k) {
      const int e = lane + 32 * k;
      v[k] = e < len ? xb[e] : 0.f;
      m = max(m, absbits(v[k]));
    }
    const float s = scale_of(__reduce_max_sync(0xffffffffu, m));
    if (lane == 0) scale[b] = s;
#pragma unroll
    for (int k = 0; k < 4 * kWords; ++k) {
      const int e = lane + 32 * k;
      if (e < len) qb[e] = (int8_t)code(v[k], s);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kCtaThreads)
    quantize_cta_kernel(const float* __restrict__ x, int64_t n, int block,
                        int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ unsigned red[kCtaThreads / 32];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t e0 = b * block;
  const int len = (int)min((int64_t)block, n - e0);
  const float* xb = x + e0;
  int8_t* qb = q + e0;
  const int nw = len >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(xb);
  unsigned m = 0u;
  if constexpr (kVec) {
    for (int w = tid; w <= nw; w += kCtaThreads)
      m = max(m, max4(w < nw ? x4[w] : cut_word(xb, 4 * w, len)));
  } else {
    for (int e = tid; e < len; e += kCtaThreads) m = max(m, absbits(xb[e]));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  m = __reduce_max_sync(0xffffffffu, red[tid & 31]);
  const float s = scale_of(m);
  if (tid == 0) scale[b] = s;
  if constexpr (kVec) {
    for (int w = tid; w < nw; w += kCtaThreads)
      __stcs(reinterpret_cast<unsigned*>(qb) + w, code4(__ldcs(x4 + w), s));
    if (tid == 0 && 4 * nw < len)
      store_cut(qb, 4 * nw, len, code4(cut_word(xb, 4 * nw, len), s));
  } else {
    for (int e = tid; e < len; e += kCtaThreads)
      qb[e] = (int8_t)code(xb[e], s);
  }
}

}  // namespace

extern "C" {

// x: (n,) f32; q: (n,) int8; scale: (ceil(n / block),) f32. vec 1 takes
// the vector path, which needs x 16-byte and q 4-byte aligned and block
// a multiple of 4 (cudaErrorMisalignedAddress otherwise). One launch, no
// memset. Returns the CUDA error code (0 on success).
int quantize_int8_blocked_launch(const void* x, long long n, int block,
                                 int vec, void* q, void* scale,
                                 void* stream) {
  if (n < 0 || block < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (vec && ((uintptr_t)x % 16 || (uintptr_t)q % 4 || block % 4))
    return (int)cudaErrorMisalignedAddress;
  const int64_t nb = (n + block - 1) / block;
  const float* xp = static_cast<const float*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block <= kWarpBlock) {
    const int64_t ctas = (nb + kWarpCta / 32 - 1) / (kWarpCta / 32);
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (vec)
      quantize_warp_kernel<true><<<(unsigned)ctas, kWarpCta, 0, s>>>(
          xp, n, block, nb, qp, sp);
    else
      quantize_warp_kernel<false><<<(unsigned)ctas, kWarpCta, 0, s>>>(
          xp, n, block, nb, qp, sp);
  } else {
    if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (vec)
      quantize_cta_kernel<true><<<(unsigned)nb, kCtaThreads, 0, s>>>(
          xp, n, block, qp, sp);
    else
      quantize_cta_kernel<false><<<(unsigned)nb, kCtaThreads, 0, s>>>(
          xp, n, block, qp, sp);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
