// The Mamba-2 SSD intra-chunk block on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// ssd_intra_chunk (_kernel), the intra-chunk block of models.ssm.
// ssd_chunked. For one chunk (bk) and one head (h), with cum = cumsum(a)
// over the chunk:
//   L[i,j]     = exp(cum_i - cum_j) for i >= j, else 0
//   y[i,p]     = sum_j (C_i . B_j) L[i,j] dt_j x[j,p]
//   state[n,p] = sum_j B[j,n] exp(cum_end - cum_j) dt_j x[j,p]
// Both outputs are f32; x, B and C are f32 or bf16, a and dt f32. The
// states feed the inter-chunk recurrence directly.
//
// What bounds it: at the Zamba2-2.7B prefill shape (BK = 32 chunks, H = 80,
// C = 256, P = N = 64, x/B/C bf16) one launch must move 301 MB (x 84 MB in,
// y 168 MB and the states 42 MB out), 0.090 ms at 3.35 TB/s, against 16.3
// GFLOP over the lower triangle with C.B^T shared across heads (0.016 ms
// on the bf16 tensor cores): bytes bound it. The f32 operands of the two
// products with x go in as bf16 hi + lo pairs, which doubles that tensor
// work, and every entry of L is an exp: a design that does these per
// (chunk, head) in small blocks, waiting on its loads, is bound by its
// instruction stream instead (0.361 ms, of which the loads alone 0.094
// ms, on an H100 80GB HBM3 at 700 W). bf16 inputs take the tensor-core
// kernel (ssd_intra_chunk_mma_kernel, below), which keeps the loads in
// flight under the products, forms C.B^T once per chunk and writes whole
// rows; they must have 16-byte aligned rows (pointers, and strides that
// are multiples of 8 elements), or the launch is refused. f32 inputs take
// the CUDA-core kernel (ssd_intra_chunk_kernel), exact to f32 rounding.
//
// Common to both kernels:
// - The TPU kernel holds the whole C x C = 256 x 256 f32 decay tile in
//   VMEM (256 KB, more than a block's shared memory); here the chunk is
//   cut into tiles on or below the diagonal only: tiles above it are
//   never formed, and L is formed only where j <= i (the exp of a
//   positive difference above the diagonal, inf, then inf * 0 = NaN in a
//   naive product, is never used; those entries are 0, as the
//   reference's where() makes them).
// - cum is a prefix sum over the chunk in the block. Its order of
//   additions differs from XLA's cumsum.
// - Every array is read through its strides (last axis contiguous), so
//   the model's (B, K, C, H, P) layout of x and y needs no transpose.
//
// The CUDA-core kernel (f32 only, 256 threads, one block a (bk, h)):
// 64-row tiles of i, 64-column tiles of j <= i; G = C_i . B_j over n in
// chunks of 64 (4x4 scores a thread, float4 loads from transposed
// tiles); M = G * L * dt_j goes to shared memory transposed; y
// accumulates 4 rows x P/16 columns a thread over the j tiles, then is
// written once; the states, a second pass over the chunk, N/16 x P/16
// sums a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows i (and columns j) of one tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLD = kTile + 4;  // leading dimension of the transposed tiles
constexpr int kMaxChunk = 256;  // largest chunk length taken

struct Args {
  const void* x;
  const float* a;
  const void* Bm;
  const void* Cm;
  const float* dt;
  float* y;
  float* st;
  int BK, H, C, P, N;
  // element strides; the last axis of x, B, C, y and st is contiguous
  int64_t x_sb, x_sh, x_sc;  // x (bk, h, c, p)
  int64_t a_sb, a_sh, a_sc;  // a (bk, h, c)
  int64_t d_sb, d_sh, d_sc;  // dt (bk, h, c)
  int64_t B_sb, B_sc;        // B (bk, c, n)
  int64_t C_sb, C_sc;        // C (bk, c, n)
  int64_t y_sb, y_sh, y_sc;  // y (bk, h, c, p)
  int64_t s_sb, s_sh, s_sn;  // states (bk, h, n, p)
};

// cum = inclusive prefix sum of a over the chunk (warp shuffles, then the
// warp totals, in rounds of NT elements), dts = dt and wdec = exp(cum_end
// - cum) dt, all in shared memory; ends with a barrier.
template <int NT>
__device__ __forceinline__ void chunk_cumsum(const Args& g, int bk, int h,
                                             float* cum, float* dts,
                                             float* wdec, float* warp_sums) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < g.C; base += NT) {
    const int c = base + tid;
    float v = 0.f;
    if (c < g.C) {
      v = g.a[bk * g.a_sb + h * g.a_sh + c * g.a_sc];
      dts[c] = g.dt[bk * g.d_sb + h * g.d_sh + c * g.d_sc];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < NW ? warp_sums[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < NW; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += t;
      }
      if (lane < NW) warp_sums[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += warp_sums[warp - 1];
    if (c < g.C) cum[c] = v + carry;
    carry += warp_sums[NW - 1];
    __syncthreads();  // warp_sums is rewritten by the next round
  }
  const float cend = cum[g.C - 1];
  for (int c = tid; c < g.C; c += NT) wdec[c] = expf(cend - cum[c]) * dts[c];
  __syncthreads();
}

template <int NR, int PC>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_chunk_kernel(const Args g) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = 16 * PC;
  constexpr int N = 16 * NR;
  const int C = g.C;
  float* cum = smem;                // [kMaxChunk] cumsum(a)
  float* dts = cum + kMaxChunk;     // [kMaxChunk] dt
  float* wdec = dts + kMaxChunk;    // [kMaxChunk] exp(cum_end - cum) dt
  float* cs = wdec + kMaxChunk;     // [64][kLD] C tile, transposed [n][i]
  float* bs = cs + kTile * kLD;     // [64][kLD] B tile, transposed [n][j]
  float* ms = bs + kTile * kLD;     // [64][kLD] masked scores, [j][i]
  float* xs = ms + kTile * kLD;     // [64][P]   x tile
  float* ws = xs + kTile * P;       // [64][N]   weighted B tile

  const int h = blockIdx.x;
  const int bk = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  __shared__ float warp_sums[kThreads / 32];
  chunk_cumsum<kThreads>(g, bk, h, cum, dts, wdec, warp_sums);

  const float* xb =
      static_cast<const float*>(g.x) + bk * g.x_sb + h * g.x_sh;
  const float* Bb = static_cast<const float*>(g.Bm) + bk * g.B_sb;
  const float* Cb = static_cast<const float*>(g.Cm) + bk * g.C_sb;
  const int nt = C / kTile;

  // ---- y: lower-triangular tiles (it, jt <= it) ----
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kTile;
    float acc[4][PC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[i][c] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int n0 = 0; n0 < N; n0 += kTile) {
        const int nc = min(kTile, N - n0);
        __syncthreads();  // readers of cs/bs, ms and xs are done
        for (int e = tid; e < kTile * nc; e += kThreads) {
          const int r = e / nc;
          const int n = e - r * nc;
          cs[n * kLD + r] = Cb[(int64_t)(i0 + r) * g.C_sc + n0 + n];
          bs[n * kLD + r] = Bb[(int64_t)(j0 + r) * g.B_sc + n0 + n];
        }
        __syncthreads();
#pragma unroll 4
        for (int n = 0; n < nc; ++n) {
          const float4 ca =
              *reinterpret_cast<const float4*>(cs + n * kLD + ty * 4);
          const float4 bb =
              *reinterpret_cast<const float4*>(bs + n * kLD + tx * 4);
          const float cv[4] = {ca.x, ca.y, ca.z, ca.w};
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
      }
      // M = G * L * dt_j below and on the diagonal, 0 above it
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = j0 + tx * 4 + j;
          sc[i][j] = jj <= ii ? sc[i][j] * expf(cum[ii] - cum[jj]) * dts[jj]
                              : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(ms + (tx * 4 + j) * kLD + ty * 4) =
            make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      for (int e = tid; e < kTile * P; e += kThreads) {
        const int r = e / P;
        const int p = e - r * P;
        xs[r * P + p] = xb[(int64_t)(j0 + r) * g.x_sc + p];
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float4 mm = *reinterpret_cast<const float4*>(ms + j * kLD + ty * 4);
        const float mv[4] = {mm.x, mm.y, mm.z, mm.w};
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const float xv = xs[j * P + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(mv[i], xv, acc[i][c]);
        }
      }
    }
    float* yb = g.y + bk * g.y_sb + h * g.y_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* yrow = yb + (int64_t)(i0 + ty * 4 + i) * g.y_sc;
#pragma unroll
      for (int c = 0; c < PC; ++c) yrow[tx + 16 * c] = acc[i][c];
    }
  }

  // ---- states: (B * exp(cum_end - cum) * dt)^T x over the whole chunk ----
  float sacc[NR][PC];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < PC; ++c) sacc[r][c] = 0.f;
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // readers of xs and ws are done
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int r = e / N;
      const int n = e - r * N;
      ws[r * N + n] =
          Bb[(int64_t)(j0 + r) * g.B_sc + n] * wdec[j0 + r];
    }
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int r = e / P;
      const int p = e - r * P;
      xs[r * P + p] = xb[(int64_t)(j0 + r) * g.x_sc + p];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float xv[PC];
#pragma unroll
      for (int c = 0; c < PC; ++c) xv[c] = xs[j * P + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float w = ws[j * N + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < PC; ++c) sacc[r][c] = fmaf(w, xv[c], sacc[r][c]);
      }
    }
  }
  float* sb = g.st + bk * g.s_sb + h * g.s_sh;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float* srow = sb + (int64_t)(ty + 16 * r) * g.s_sn;
#pragma unroll
    for (int c = 0; c < PC; ++c) srow[tx + 16 * c] = sacc[r][c];
  }
}

// ---- bf16 on the tensor cores: mma.sync.m16n8k16 ----
//
// ssd_intra_chunk_mma_kernel: a persistent grid of one block of 8 warps
// on each SM; block b walks a contiguous run of the BK * H (chunk, head)
// units, heads fastest, so one chunk serves many heads in a row.
// - C.B^T is formed once per chunk, not once per head: the chunk is cut
//   into 16-row strips, warp w owns strips w and C/16 - 1 - w (17 16x16
//   blocks on or below the diagonal at C = 256, the same count for every
//   warp) and keeps its blocks of C.B^T in registers across the heads.
//   B (for the states) stays in shared memory; C is read only then.
// - x, a and dt of the next head are in flight (cp.async, 16 bytes a
//   copy for x) while the current head is computed: two x buffers when
//   they fit in shared memory (every P <= 64 shape), else one.
// - Per head, a warp turns each of its blocks into M = G * L * dt_j (0
//   above the diagonal; the exp of a positive exponent there is never
//   used), splits it into bf16 hi + lo, and multiplies by x_j (ldmatrix
//   .trans fragments) into the strip's y sums; a strip's 16 rows of y go
//   through the warp's staging tile in shared memory and out as whole
//   row segments in 16-byte streaming stores. Then the states, (B *
//   exp(cum_end - cum) * dt)^T x, also hi + lo: a warp sums 16 rows n
//   over a share of the chunk's rows j (8 / (N / 16) warps a strip of n
//   when N < 128), and the shares meet in the staging tiles, so that
//   each hi + lo operand is formed once; written the same way.
// - cum, dt and exp(cum_end - cum) dt of the head are one warp's scan
//   over the chunk, between two block barriers. The exps of L are
//   ex2.approx of the scaled cum (relative error about 2^-22, below the
//   hi + lo products' 2^-16).
// - The products of a block are issued hi for every column tile, then
//   lo, so that no mma waits on the one before it: with 8 warps an SM
//   there are few other warps to hide that latency.
// C.B^T is a product of bf16 inputs, exact in the f32 sums of mma.sync.
// The two products with x take f32 operands (M and B exp(cum_end - cum)
// dt, as the reference computes them in f32), so those go in as bf16
// pairs hi + lo, two products each, which holds them to about 2^-16 of
// their size.

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMaxBlocks = kMaxChunk / 16 + 1;  // 16x16 blocks a warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8q..8q+7 give the rows of matrix q
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t as_u32(const __nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as a bf16 pair plus the bf16 pair of what that rounding left out
__device__ __forceinline__ void split_f32(float x, float y, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows x W bf16 from src (row stride src_ld) to dst (row pitch ld),
// 16 bytes a copy, in flight until cp_async_wait_all
template <int W>
__device__ __forceinline__ void issue_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           int64_t src_ld, int rows) {
  constexpr int CH = W / 8;
  for (int e = threadIdx.x; e < rows * CH; e += kMmaThreads) {
    const int r = e / CH;
    const int c = e - r * CH;
    cp_async16(dst + r * ld + c * 8, src + r * src_ld + c * 8);
  }
}

// one warp: cum2 = cumsum(a) * log2(e), dts = dt and wdec = exp(cum_end -
// cum) dt over the chunk, from a and dt as loaded; lane l owns C / 32
// consecutive entries
__device__ __forceinline__ void chunk_scan(const float* araw,
                                           const float* draw, int C,
                                           float* cum2, float* dts,
                                           float* wdec) {
  const int lane = threadIdx.x & 31;
  const int E = C / 32;
  float v[kMaxChunk / 32];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxChunk / 32; ++e)
    if (e < E) {
      run += araw[lane * E + e];
      v[e] = run;
    }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.f;
  const float cend = __shfl_sync(0xffffffffu, tot, 31);
#pragma unroll
  for (int e = 0; e < kMaxChunk / 32; ++e)
    if (e < E) {
      const int c = lane * E + e;
      const float cv = v[e] + excl;
      const float d = draw[c];
      cum2[c] = cv * kLog2e;
      dts[c] = d;
      wdec[c] = expf(cend - cv) * d;
    }
}

// acc (16 rows x P, m16n8 fragments) += M x_j for the 16x16 block (strip
// s, block k) whose C.B^T is gb
template <int PN, int LDP>
__device__ __forceinline__ void y_block(float (&acc)[PN][4],
                                        const float (&gb)[8], int s, int k,
                                        const float* cum2, const float* dts,
                                        const __nv_bfloat16* xt, int lane) {
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int j0 = 16 * k;
  const float ci0 = cum2[16 * s + gr];
  const float ci1 = cum2[16 * s + gr + 8];
  const float2 cj0 = *reinterpret_cast<const float2*>(cum2 + j0 + 2 * tg);
  const float2 cj8 = *reinterpret_cast<const float2*>(cum2 + j0 + 8 + 2 * tg);
  const float2 d0 = *reinterpret_cast<const float2*>(dts + j0 + 2 * tg);
  const float2 d8 = *reinterpret_cast<const float2*>(dts + j0 + 8 + 2 * tg);
  float m[8];
  m[0] = gb[0] * ex2(ci0 - cj0.x) * d0.x;  // row gr, column 2 tg
  m[1] = gb[1] * ex2(ci0 - cj0.y) * d0.y;
  m[2] = gb[2] * ex2(ci1 - cj0.x) * d0.x;  // row gr + 8
  m[3] = gb[3] * ex2(ci1 - cj0.y) * d0.y;
  m[4] = gb[4] * ex2(ci0 - cj8.x) * d8.x;  // column 2 tg + 8
  m[5] = gb[5] * ex2(ci0 - cj8.y) * d8.y;
  m[6] = gb[6] * ex2(ci1 - cj8.x) * d8.x;
  m[7] = gb[7] * ex2(ci1 - cj8.y) * d8.y;
  if (k == s) {  // the diagonal block: 0 where j > i
    m[0] = 2 * tg <= gr ? m[0] : 0.f;
    m[1] = 2 * tg + 1 <= gr ? m[1] : 0.f;
    m[4] = 0.f;
    m[5] = 0.f;
    m[6] = 2 * tg <= gr ? m[6] : 0.f;
    m[7] = 2 * tg + 1 <= gr ? m[7] : 0.f;
  }
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_f32(m[2 * i], m[2 * i + 1], hi[i], lo[i]);
  const __nv_bfloat16* xr =
      xt + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP + (lane >> 4) * 8;
  uint32_t b[PN / 2][4];
#pragma unroll
  for (int pp = 0; pp < PN / 2; ++pp) ldsm_x4_t(b[pp], xr + pp * 16);
  // the hi products of every column tile, then the lo ones: no product
  // waits on the one before it
#pragma unroll
  for (int pp = 0; pp < PN / 2; ++pp) {
    mma_bf16(acc[2 * pp], hi, b[pp][0], b[pp][1]);
    mma_bf16(acc[2 * pp + 1], hi, b[pp][2], b[pp][3]);
  }
#pragma unroll
  for (int pp = 0; pp < PN / 2; ++pp) {
    mma_bf16(acc[2 * pp], lo, b[pp][0], b[pp][1]);
    mma_bf16(acc[2 * pp + 1], lo, b[pp][2], b[pp][3]);
  }
}

// 16 rows x W f32 of m16n8 fragments into the warp's staging tile (row
// pitch W + 8)
template <int W>
__device__ __forceinline__ void stage_frags(const float (&acc)[W / 8][4],
                                            float* stage, int lane) {
  constexpr int LDS = W + 8;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nd = 0; nd < W / 8; ++nd) {
    *reinterpret_cast<float2*>(stage + gr * LDS + nd * 8 + 2 * tg) =
        make_float2(acc[nd][0], acc[nd][1]);
    *reinterpret_cast<float2*>(stage + (gr + 8) * LDS + nd * 8 + 2 * tg) =
        make_float2(acc[nd][2], acc[nd][3]);
  }
  __syncwarp();
}

// the sum of the 16 x W staging tiles stage + i * gap (i < parts) to dst
// (row stride ld), whole row segments in 16-byte streaming stores
template <int W>
__device__ __forceinline__ void sum_rows(const float* stage, int gap,
                                         int parts, float* dst, int64_t ld,
                                         int lane) {
  constexpr int LDS = W + 8;
  constexpr int LPR = W / 4;    // lanes a row
  constexpr int RPI = 32 / LPR; // rows a store instruction
  const int c = 4 * (lane % LPR);
#pragma unroll
  for (int r = lane / LPR; r < 16; r += RPI) {
    float4 v = *reinterpret_cast<const float4*>(stage + r * LDS + c);
    for (int i = 1; i < parts; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(stage + i * gap + r * LDS + c);
      v.x += t.x, v.y += t.y, v.z += t.z, v.w += t.w;
    }
    __stcs(reinterpret_cast<float4*>(dst + r * ld + c), v);
  }
}

// 16 rows x W f32 of m16n8 fragments through the warp's staging tile to
// dst (row stride ld)
template <int W>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 8][4],
                                           float* stage, float* dst,
                                           int64_t ld, int lane) {
  stage_frags<W>(acc, stage, lane);
  sum_rows<W>(stage, 0, 1, dst, ld, lane);
}

// NK = N / 16, PN = P / 8; nbuf x buffers (1 or 2)
template <int NK, int PN>
__global__ void __launch_bounds__(kMmaThreads, 1)
    ssd_intra_chunk_mma_kernel(const Args g, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int N = 16 * NK;
  constexpr int P = 8 * PN;
  constexpr int LDN = N + 8;  // row pitch of the B and C tiles (bf16)
  constexpr int LDP = P + 8;  // row pitch of the x tiles (bf16)
  float* cum2 = reinterpret_cast<float*>(smem_raw);  // cumsum(a) log2(e)
  float* dts = cum2 + kMaxChunk;                     // dt
  float* wdec = dts + kMaxChunk;                     // exp(cum_end-cum) dt
  float* araw = wdec + kMaxChunk;                    // [2][C] a as loaded
  float* draw = araw + 2 * kMaxChunk;                // [2][C] dt as loaded
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(draw + 2 * kMaxChunk);
  __nv_bfloat16* xs = bs + kMaxChunk * LDN;          // [nbuf][C][LDP]
  // C of the chunk while C.B^T is formed, else the warps' staging tiles
  unsigned char* region =
      reinterpret_cast<unsigned char*>(xs + nbuf * kMaxChunk * LDP);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(region);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(region) + warp * 16 * (P + 8);
  const int C = g.C;
  const int ns = C / 16;        // 16-row strips of the chunk
  const bool has_y = warp < ns / 2;
  const int sa = warp;          // this warp's strips: sa (blocks 0..sa)
  const int sb = ns - 1 - warp; // and sb (blocks 0..sb)
  const int nblk = ns + 1;
  const int64_t units = (int64_t)g.BK * g.H;
  const int64_t u0 = units * blockIdx.x / gridDim.x;
  const int64_t u1 = units * (blockIdx.x + 1) / gridDim.x;

  // x, a and dt of unit u into buffer buf
  auto issue_unit = [&](int64_t u, int buf) {
    const int64_t bk = u / g.H;
    const int64_t h = u - bk * g.H;
    issue_rows<P>(xs + buf * kMaxChunk * LDP, LDP,
                  static_cast<const __nv_bfloat16*>(g.x) + bk * g.x_sb +
                      h * g.x_sh,
                  g.x_sc, C);
    const float* a = g.a + bk * g.a_sb + h * g.a_sh;
    const float* d = g.dt + bk * g.d_sb + h * g.d_sh;
    for (int c = threadIdx.x; c < C; c += kMmaThreads) {
      cp_async4(araw + buf * kMaxChunk + c, a + c * g.a_sc);
      cp_async4(draw + buf * kMaxChunk + c, d + c * g.d_sc);
    }
  };

  float gq[kMaxBlocks][8];  // this warp's blocks of C.B^T, current chunk
  int64_t cur_bk = -1;
  if (nbuf == 2 && u0 < u1) {
    issue_unit(u0, 0);
    cp_async_commit();
  }
  for (int64_t u = u0; u < u1; ++u) {
    const int buf = nbuf == 2 ? (int)((u - u0) & 1) : 0;
    const int64_t bk = u / g.H;
    const int64_t h = u - bk * g.H;
    if (nbuf == 1) {
      __syncthreads();  // the x buffer is free
      issue_unit(u, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // unit u's inputs landed; unit u - 1 is done
    if (bk != cur_bk) {
      cur_bk = bk;
      issue_rows<N>(bs, LDN,
                    static_cast<const __nv_bfloat16*>(g.Bm) + bk * g.B_sb,
                    g.B_sc, C);
      issue_rows<N>(cs, LDN,
                    static_cast<const __nv_bfloat16*>(g.Cm) + bk * g.C_sb,
                    g.C_sc, C);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (has_y) {
#pragma unroll
        for (int b = 0; b < kMaxBlocks; ++b) {
          if (b < nblk) {
            const int s = b <= sa ? sa : sb;
            const int k = b <= sa ? b : b - sa - 1;
#pragma unroll
            for (int e = 0; e < 8; ++e) gq[b][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < NK; ++kk) {
              uint32_t af[4], bf[4];
              ldsm_x4(af, cs + (16 * s + (lane & 15)) * LDN + 16 * kk +
                              (lane >> 4) * 8);
              ldsm_x4(bf, bs + (16 * k + (lane >> 4) * 8 + (lane & 7)) * LDN +
                              16 * kk + ((lane >> 3) & 1) * 8);
              mma_bf16(gq[b], af, bf[0], bf[1]);
              mma_bf16(gq[b] + 4, af, bf[2], bf[3]);
            }
          }
        }
      }
      __syncthreads();  // C's tile becomes the staging tiles again
    }
    if (nbuf == 2 && u + 1 < u1) {
      issue_unit(u + 1, buf ^ 1);
      cp_async_commit();
    }
    if (warp == 0)
      chunk_scan(araw + buf * kMaxChunk, draw + buf * kMaxChunk, C, cum2, dts,
                 wdec);
    __syncthreads();
    const __nv_bfloat16* xt = xs + buf * kMaxChunk * LDP;

    // ---- y: strip sa, then strip sb ----
    if (has_y) {
      float* yb = g.y + bk * g.y_sb + h * g.y_sh;
      float acc[PN][4];
#pragma unroll
      for (int nd = 0; nd < PN; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
#pragma unroll
      for (int b = 0; b < kMaxBlocks; ++b)
        if (b <= sa) y_block<PN, LDP>(acc, gq[b], sa, b, cum2, dts, xt, lane);
      store_rows<P>(acc, stage, yb + (int64_t)(16 * sa) * g.y_sc, g.y_sc,
                    lane);
#pragma unroll
      for (int nd = 0; nd < PN; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
#pragma unroll
      for (int b = 0; b < kMaxBlocks; ++b)
        if (b > sa && b < nblk)
          y_block<PN, LDP>(acc, gq[b], sb, b - sa - 1, cum2, dts, xt, lane);
      store_rows<P>(acc, stage, yb + (int64_t)(16 * sb) * g.y_sc, g.y_sc,
                    lane);
    }

    // ---- states: warp w sums the rows n of strip w mod NK over the
    // blocks jb = w / NK (mod kParts) of the chunk, all P columns (every
    // strip its own warp when NK >= 8); the parts of a strip meet in
    // shared memory, so each hi + lo operand is formed once ----
    constexpr int kParts = NK >= kMmaWarps ? 1 : kMmaWarps / NK;
    const int part = kParts == 1 ? 0 : warp / NK;
    for (int strip = kParts == 1 ? warp : warp % NK; strip < NK;
         strip += kMmaWarps) {
      const int n0 = 16 * strip;
      const int tg = lane & 3;
      float sacc[PN][4];
#pragma unroll
      for (int nd = 0; nd < PN; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nd][e] = 0.f;
      for (int jb = part; jb < ns; jb += kParts) {
        const int j0 = 16 * jb;
        uint32_t bt[4];  // B^T: rows n, columns j
        ldsm_x4_t(bt, bs + (j0 + (lane >> 4) * 8 + (lane & 7)) * LDN + n0 +
                          ((lane >> 3) & 1) * 8);
        const float2 w0 = *reinterpret_cast<const float2*>(wdec + j0 + 2 * tg);
        const float2 w8 =
            *reinterpret_cast<const float2*>(wdec + j0 + 8 + 2 * tg);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 w = i < 2 ? w0 : w8;
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&bt[i]));
          split_f32(f.x * w.x, f.y * w.y, hi[i], lo[i]);
        }
        const __nv_bfloat16* xr =
            xt + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
            (lane >> 4) * 8;
        uint32_t b[PN / 2][4];
#pragma unroll
        for (int pp = 0; pp < PN / 2; ++pp) ldsm_x4_t(b[pp], xr + pp * 16);
#pragma unroll
        for (int pp = 0; pp < PN / 2; ++pp) {
          mma_bf16(sacc[2 * pp], hi, b[pp][0], b[pp][1]);
          mma_bf16(sacc[2 * pp + 1], hi, b[pp][2], b[pp][3]);
        }
#pragma unroll
        for (int pp = 0; pp < PN / 2; ++pp) {
          mma_bf16(sacc[2 * pp], lo, b[pp][0], b[pp][1]);
          mma_bf16(sacc[2 * pp + 1], lo, b[pp][2], b[pp][3]);
        }
      }
      float* dst = g.st + bk * g.s_sb + h * g.s_sh + n0 * g.s_sn;
      stage_frags<P>(sacc, stage, lane);
      if (kParts > 1)  // the strip's warps: strip + i * NK, i < kParts
        asm volatile("bar.sync %0, %1;" ::"r"(1 + strip),
                     "r"(32 * kParts) : "memory");
      if (part == 0)
        sum_rows<P>(stage, 16 * (P + 8) * NK, kParts, dst, g.s_sn, lane);
    }
  }
}

template <int NK, int PN>
cudaError_t launch_mma_t(const Args& g, cudaStream_t stream) {
  constexpr int N = 16 * NK;
  constexpr int P = 8 * PN;
  const size_t vec = 7 * kMaxChunk * sizeof(float);
  const size_t btile = (size_t)kMaxChunk * (N + 8) * sizeof(__nv_bfloat16);
  const size_t xtile = (size_t)kMaxChunk * (P + 8) * sizeof(__nv_bfloat16);
  const size_t stage = (size_t)kMmaWarps * 16 * (P + 8) * sizeof(float);
  const size_t region = btile > stage ? btile : stage;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int nbuf = 2;
  size_t smem = vec + btile + 2 * xtile + region;
  if (smem > (size_t)optin) {
    nbuf = 1;
    smem -= xtile;
  }
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_intra_chunk_mma_kernel<NK, PN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t units = (int64_t)g.BK * g.H;
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  ssd_intra_chunk_mma_kernel<NK, PN>
      <<<grid, kMmaThreads, smem, stream>>>(g, nbuf);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_mma_n(const Args& g, cudaStream_t stream) {
  switch (g.P) {
    case 32: return launch_mma_t<NK, 4>(g, stream);
    case 64: return launch_mma_t<NK, 8>(g, stream);
    case 128: return launch_mma_t<NK, 16>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_mma(const Args& g, cudaStream_t stream) {
  switch (g.N) {
    case 16: return launch_mma_n<1>(g, stream);
    case 32: return launch_mma_n<2>(g, stream);
    case 64: return launch_mma_n<4>(g, stream);
    case 128: return launch_mma_n<8>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the tensor-core kernel copies rows of x, B and C in 16-byte pieces and
// writes y and the states 16 bytes a store
bool mma_ok(const Args& g) {
  const void* in[3] = {g.x, g.Bm, g.Cm};
  for (const void* p : in)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const void* out[2] = {g.y, g.st};
  for (const void* p : out)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const int64_t in_strides[7] = {g.x_sb, g.x_sh, g.x_sc, g.B_sb,
                                 g.B_sc, g.C_sb, g.C_sc};
  for (int64_t st : in_strides)
    if (st % 8 != 0) return false;
  const int64_t out_strides[6] = {g.y_sb, g.y_sh, g.y_sc,
                                  g.s_sb, g.s_sh, g.s_sn};
  for (int64_t st : out_strides)
    if (st % 4 != 0) return false;
  return true;
}

template <int NR, int PC>
cudaError_t launch_t(const Args& g, cudaStream_t stream) {
  const int smem = (int)((3 * kMaxChunk + 3 * kTile * kLD +
                          kTile * 16 * PC + kTile * 16 * NR) *
                         sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel<NR, PC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)g.H, (unsigned)g.BK);
  ssd_intra_chunk_kernel<NR, PC><<<grid, kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <int NR>
cudaError_t launch_n(const Args& g, cudaStream_t stream) {
  switch (g.P) {
    case 32: return launch_t<NR, 2>(g, stream);
    case 64: return launch_t<NR, 4>(g, stream);
    case 128: return launch_t<NR, 8>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch(const Args& g, cudaStream_t stream) {
  switch (g.N) {
    case 16: return launch_n<1>(g, stream);
    case 32: return launch_n<2>(g, stream);
    case 64: return launch_n<4>(g, stream);
    case 128: return launch_n<8>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: BK, H, C, P, N, then the element strides x (bk, h, c), a (bk, h,
// c), dt (bk, h, c), B (bk, c), C (bk, c), y (bk, h, c), states (bk, h, n)
// (24 values). dtype of x, B and C: 0 = f32, 1 = bf16; a and dt are f32,
// y and the states f32. Takes C a multiple of 64 up to 256, N in {16, 32,
// 64, 128}, P in {32, 64, 128}. Returns the CUDA error of the launch;
// cudaErrorInvalidValue for a shape, or a bf16 layout, that no kernel
// takes.
extern "C" int ssd_intra_chunk_launch(const void* x, const float* a,
                                      const void* Bm, const void* Cm,
                                      const float* dt, float* y, float* st,
                                      const long long* dims, int dtype,
                                      void* stream) {
  Args g;
  g.x = x;
  g.a = a;
  g.Bm = Bm;
  g.Cm = Cm;
  g.dt = dt;
  g.y = y;
  g.st = st;
  g.BK = (int)dims[0];
  g.H = (int)dims[1];
  g.C = (int)dims[2];
  g.P = (int)dims[3];
  g.N = (int)dims[4];
  g.x_sb = dims[5];
  g.x_sh = dims[6];
  g.x_sc = dims[7];
  g.a_sb = dims[8];
  g.a_sh = dims[9];
  g.a_sc = dims[10];
  g.d_sb = dims[11];
  g.d_sh = dims[12];
  g.d_sc = dims[13];
  g.B_sb = dims[14];
  g.B_sc = dims[15];
  g.C_sb = dims[16];
  g.C_sc = dims[17];
  g.y_sb = dims[18];
  g.y_sh = dims[19];
  g.y_sc = dims[20];
  g.s_sb = dims[21];
  g.s_sh = dims[22];
  g.s_sn = dims[23];
  if (g.C < kTile || g.C > kMaxChunk || g.C % kTile != 0 || g.BK < 1 ||
      g.H < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch(g, s);
  if (dtype == 1 && mma_ok(g)) return (int)launch_mma(g, s);
  return (int)cudaErrorInvalidValue;
}
