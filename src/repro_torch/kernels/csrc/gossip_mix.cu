// Gossip mixing boundary on Hopper: out[i, c] = sum_j W[i, j] * Y[j, c].
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_mix.py
// gossip_mix_flat (and the in-place blocked pass _mix_rows_blocked that
// served the same boundary off the TPU). Y is the flat (n, T) model bank,
// one device model per row; W is a (k, n) row-applied mixing operator: the
// square eq. 11 boundary (k == n) or the rectangular edge-model projection.
//
// What bounds it: one pass reads the bank once and writes the result once.
// At the FEMNIST-CNN main path (n = k = 64, T = 6,603,710, f32) that is
// 3.38 GB, about 1.0 ms at 3.35 TB/s, against 2*k*n*T = 54 GFLOP, about
// 0.8 ms at 67 TFLOP/s of FP32 on the CUDA cores. The pass is close to
// balanced, so the design keeps every arithmetic instruction a fused
// multiply-add and reads W from shared memory with 16-byte loads that
// feed two columns each.
//
// Design:
// - W is staged once per block in shared memory, transposed and zero
//   padded to KB rows: ws[j * KB + i] = W[i, j].
// - Each thread owns kCols columns, spaced kThreads apart, so every load
//   and store of a warp touches 32 consecutive elements (coalesced, no
//   vector alignment needed: T need not be a multiple of anything).
// - A thread keeps its kCols * KB sums in registers, reads all n input
//   rows of its columns, and only then writes its k output rows. No other
//   thread reads or writes those columns, so out may alias Y when k == n:
//   the in-place boundary needs no second bank-sized buffer.
// - Sums are f32 and run over j in ascending order; the result is
//   rounded to Y's type (f32 or bf16, round to nearest even).
// - Indices are 64-bit: n * T exceeds 2^31 for wider models.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kCols = 2;       // columns owned by one thread
constexpr int kMaxRows = 64;   // largest n and k the kernel takes

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int KB>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_kernel(const float* __restrict__ W, const T* Y, T* out, int n,
                      int k, int64_t ncols) {
  __shared__ __align__(16) float ws[kMaxRows * KB];
  for (int e = threadIdx.x; e < n * KB; e += kThreads) {
    const int j = e / KB;
    const int i = e - j * KB;
    ws[e] = (i < k) ? W[(int64_t)i * n + j] : 0.f;
  }
  __syncthreads();

  const int64_t first =
      (int64_t)blockIdx.x * (kThreads * kCols) + threadIdx.x;
  int64_t col[kCols];
  bool live[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    col[c] = first + (int64_t)c * kThreads;
    live[c] = col[c] < ncols;
  }

  float acc[kCols][KB];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int i = 0; i < KB; ++i) acc[c][i] = 0.f;

#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    float y[kCols];
    const T* row = Y + (int64_t)j * ncols;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      y[c] = live[c] ? load_f32(row + col[c]) : 0.f;
    const float4* w4 = reinterpret_cast<const float4*>(ws + j * KB);
#pragma unroll
    for (int i4 = 0; i4 < KB / 4; ++i4) {
      const float4 w = w4[i4];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[c][4 * i4 + 0] = fmaf(w.x, y[c], acc[c][4 * i4 + 0]);
        acc[c][4 * i4 + 1] = fmaf(w.y, y[c], acc[c][4 * i4 + 1]);
        acc[c][4 * i4 + 2] = fmaf(w.z, y[c], acc[c][4 * i4 + 2]);
        acc[c][4 * i4 + 3] = fmaf(w.w, y[c], acc[c][4 * i4 + 3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KB; ++i) {
    if (i < k) {
      T* orow = out + (int64_t)i * ncols;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (live[c]) store_f32(orow + col[c], acc[c][i]);
    }
  }
}

template <typename T>
cudaError_t launch(const float* W, const T* Y, T* out, int n, int k,
                   int64_t ncols, cudaStream_t stream) {
  const int64_t per_block = kThreads * kCols;
  const dim3 grid((unsigned)((ncols + per_block - 1) / per_block));
  const dim3 block(kThreads);
  if (k <= 4)
    gossip_mix_kernel<T, 4><<<grid, block, 0, stream>>>(W, Y, out, n, k, ncols);
  else if (k <= 8)
    gossip_mix_kernel<T, 8><<<grid, block, 0, stream>>>(W, Y, out, n, k, ncols);
  else if (k <= 16)
    gossip_mix_kernel<T, 16><<<grid, block, 0, stream>>>(W, Y, out, n, k, ncols);
  else if (k <= 32)
    gossip_mix_kernel<T, 32><<<grid, block, 0, stream>>>(W, Y, out, n, k, ncols);
  else
    gossip_mix_kernel<T, 64><<<grid, block, 0, stream>>>(W, Y, out, n, k, ncols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// W: (k, n) f32 row-major; Y: (n, ncols); out: (k, ncols), may equal Y
// when k == n. dtype 0 is f32, 1 is bf16 (Y and out). Returns the CUDA
// error code of the launch (0 on success); n or k above kMaxRows (the
// wrapper's MAX_ROWS) is refused as cudaErrorInvalidValue.
int gossip_mix_rows_launch(const void* W, const void* Y, void* out, int n,
                           int k, long long ncols, int dtype, void* stream) {
  if (n < 1 || n > kMaxRows || k < 1 || k > kMaxRows || ncols < 0)
    return (int)cudaErrorInvalidValue;
  if (out == Y && k != n) return (int)cudaErrorInvalidValue;
  if (ncols == 0) return (int)cudaSuccess;
  if ((ncols + kThreads * kCols - 1) / (kThreads * kCols) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  if (dtype == 0)
    return (int)launch(w, static_cast<const float*>(Y),
                       static_cast<float*>(out), n, k, ncols, s);
  if (dtype == 1)
    return (int)launch(w, static_cast<const __nv_bfloat16*>(Y),
                       static_cast<__nv_bfloat16*>(out), n, k, ncols, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
