// Cold-row codec on Hopper: encode the streamed slab's (S, T) f32 rows
// for the cold client store, and decode them back.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cold_codec.py:
// _segment_absmax (_absmax_kernel) and _elementwise (_affine_enc_kernel,
// _affine_dec_kernel, _cast_kernel). Byte for byte the host codec
// core.compress.encode_cold_rows / decode_cold_rows:
// - int8: per (row, FlatLayout segment) s = max(absmax(seg), 1e-12) / 127
//   in f32, q = clip(round_half_even(x / s), -127, 127); decode q * s;
// - f16: the IEEE cast both ways (round to nearest even on the way in);
// - f32 is the identity and launches nothing (the wrapper's business).
//
// What bounds it: bytes. At the streamed FEMNIST-CNN slab (S = 64,
// T = 6,603,710) the int8 encode must read 1.69 GB and write 0.42 GB
// (0.63 ms at 3.35 TB/s); this two-pass design reads the rows twice
// (absmax, then quantize), so it sits near 1.8x that. Decode reads
// 0.42 GB and writes 1.69 GB.
//
// Design:
// - Segments are very uneven (32 columns to 6.4 M). The TPU version ran
//   one grid per segment; here every pass is ONE launch over all
//   segments: the wrapper cuts each row into tiles that never cross a
//   segment boundary and passes the tile table (start column, length,
//   segment, first-tile flag); block b handles tile b % ntiles of row
//   b / ntiles. Rows are in the same 1-D grid, so any S fits.
// - absmax: a tile's max is folded into its (row, segment) slot with
//   atomicMax on the bits of |x| (sign bit cleared). For non-negative
//   floats the integer order is the float order, so the result does not
//   depend on block order; and any NaN orders above +inf, so a NaN
//   propagates into the scale as it does through numpy's max. The
//   scratch slots are zeroed (cudaMemsetAsync) before the pass.
// - quantize / dequantize: each block reads its slot once, computes the
//   scale with IEEE division (__fdiv_rn), and the first tile of each
//   segment writes it out. x / s is __fdiv_rn, rounding rintf (half to
//   even, never roundf), decode __fmul_rn: no fast math anywhere.
// - Threads stride a tile with scalar loads and stores, so a warp moves
//   32 consecutive elements: coalesced with no vector alignment needed
//   (T = 6,603,710 is not a multiple of 4, so rows after the first are
//   not 16-byte aligned).
// - Offsets are 64-bit: S * T passes 2^31 for a 256-row slab of the
//   wider models.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Tile {
  int64_t start;  // first column of the tile in the row
  int32_t len;    // columns in the tile (> 0)
  int32_t seg;    // segment the tile lies in
};

__device__ __forceinline__ Tile load_tile(const int64_t* tiles, int64_t t) {
  // two int64 per tile: tiles[2t] = start, tiles[2t + 1] = len (bits
  // 0-30) | first-tile-of-its-segment flag (bit 31) | seg (bits 32-63)
  Tile out;
  out.start = tiles[2 * t];
  const int64_t packed = tiles[2 * t + 1];
  out.len = (int32_t)(packed & 0x7fffffff);
  out.seg = (int32_t)(packed >> 32);
  return out;
}

__device__ __forceinline__ bool first_of_segment(const int64_t* tiles,
                                                 int64_t t) {
  return (tiles[2 * t + 1] & 0x80000000LL) != 0;
}

__device__ __forceinline__ float scale_of(unsigned bits) {
  const float a = __uint_as_float(bits);
  // a < floor is false for NaN, so NaN passes through (numpy's maximum)
  const float m = (a < 1e-12f) ? 1e-12f : a;
  return __fdiv_rn(m, 127.0f);
}

__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const float* __restrict__ x, int64_t ncols,
                  const int64_t* __restrict__ tiles, int64_t ntiles,
                  int nseg, unsigned* __restrict__ amax) {
  const int64_t b = blockIdx.x;
  const int64_t row = b / ntiles;
  const int64_t t = b - row * ntiles;
  const Tile tile = load_tile(tiles, t);
  const float* p = x + row * ncols + tile.start;
  unsigned m = 0u;
#pragma unroll 4
  for (int i = threadIdx.x; i < tile.len; i += kThreads)
    m = max(m, __float_as_uint(p[i]) & 0x7fffffffu);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = (lane < kWarps) ? part[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(amax + row * nseg + tile.seg, m);
  }
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, int64_t ncols,
                    const int64_t* __restrict__ tiles, int64_t ntiles,
                    int nseg, const unsigned* __restrict__ amax,
                    int8_t* __restrict__ q, float* __restrict__ scale) {
  const int64_t b = blockIdx.x;
  const int64_t row = b / ntiles;
  const int64_t t = b - row * ntiles;
  const Tile tile = load_tile(tiles, t);
  const float s = scale_of(amax[row * nseg + tile.seg]);
  if (threadIdx.x == 0 && first_of_segment(tiles, t))
    scale[row * nseg + tile.seg] = s;
  const int64_t base = row * ncols + tile.start;
  const float* p = x + base;
  int8_t* o = q + base;
#pragma unroll 4
  for (int i = threadIdx.x; i < tile.len; i += kThreads) {
    float v = rintf(__fdiv_rn(p[i], s));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    o[i] = (int8_t)(int)v;
  }
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scale, int64_t ncols,
                      const int64_t* __restrict__ tiles, int64_t ntiles,
                      int nseg, float* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const int64_t row = b / ntiles;
  const int64_t t = b - row * ntiles;
  const Tile tile = load_tile(tiles, t);
  const float s = scale[row * nseg + tile.seg];
  const int64_t base = row * ncols + tile.start;
  const int8_t* p = q + base;
  float* o = out + base;
#pragma unroll 4
  for (int i = threadIdx.x; i < tile.len; i += kThreads)
    o[i] = __fmul_rn((float)p[i], s);
}

__global__ void __launch_bounds__(kThreads)
    to_half_kernel(const float* __restrict__ x, __half* __restrict__ out,
                   int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    out[i] = __float2half_rn(x[i]);
}

__global__ void __launch_bounds__(kThreads)
    from_half_kernel(const __half* __restrict__ x, float* __restrict__ out,
                     int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    out[i] = __half2float(x[i]);
}

// blocks of a tiled pass, or 0 when the grid would not fit
int64_t tiled_blocks(int64_t rows, int64_t ntiles) {
  if (rows < 1 || ntiles < 1) return 0;
  const int64_t blocks = rows * ntiles;
  return blocks > 0x7fffffffLL ? 0 : blocks;
}

// blocks of a grid-stride cast: 8 waves of 132 SMs x 8 blocks, fewer for
// small inputs
unsigned cast_blocks(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 8 * 8;
  return (unsigned)(want < cap ? want : cap);
}

}  // namespace

extern "C" {

// x: (rows, ncols) f32; tiles: (ntiles, 2) int64 (see load_tile); amax:
// rows * nseg uint32 scratch; q: (rows, ncols) int8; scale: (rows, nseg)
// f32. Two launches (absmax, quantize) after a memset of the scratch.
// Returns the CUDA error code (0 on success).
int cold_encode_int8_launch(const void* x, long long rows, long long ncols,
                            const void* tiles, long long ntiles, int nseg,
                            void* amax, void* q, void* scale, void* stream) {
  if (rows == 0 || ncols == 0) return (int)cudaSuccess;
  const int64_t blocks = tiled_blocks(rows, ntiles);
  if (blocks == 0 || nseg < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(amax, 0, (size_t)rows * nseg * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  absmax_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(x), ncols,
      static_cast<const int64_t*>(tiles), ntiles, nseg,
      static_cast<unsigned*>(amax));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quantize_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(x), ncols,
      static_cast<const int64_t*>(tiles), ntiles, nseg,
      static_cast<const unsigned*>(amax), static_cast<int8_t*>(q),
      static_cast<float*>(scale));
  return (int)cudaGetLastError();
}

// q: (rows, ncols) int8; scale: (rows, nseg) f32; out: (rows, ncols) f32.
int cold_decode_int8_launch(const void* q, const void* scale, long long rows,
                            long long ncols, const void* tiles,
                            long long ntiles, int nseg, void* out,
                            void* stream) {
  if (rows == 0 || ncols == 0) return (int)cudaSuccess;
  const int64_t blocks = tiled_blocks(rows, ntiles);
  if (blocks == 0 || nseg < 1) return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), ncols,
      static_cast<const int64_t*>(tiles), ntiles, nseg,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// n elements; to_half 1 casts f32 -> f16 (x f32, out f16), 0 the reverse.
int cold_cast_launch(const void* x, void* out, long long n, int to_half,
                     void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (to_half)
    to_half_kernel<<<cast_blocks(n), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<__half*>(out), n);
  else
    from_half_kernel<<<cast_blocks(n), kThreads, 0, s>>>(
        static_cast<const __half*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
