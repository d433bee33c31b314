// The Mamba-2 SSD intra-chunk block on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// ssd_intra_chunk (_kernel), the intra_fn of models.ssm.ssd_chunked. For
// one chunk (bk) and one head (h), with cum = cumsum(a) over the chunk:
//   L[i,j]     = exp(cum_i - cum_j) for i >= j, else 0
//   y[i,p]     = sum_j (C_i . B_j) L[i,j] dt_j x[j,p]
//   state[n,p] = sum_j B[j,n] exp(cum_end - cum_j) dt_j x[j,p]
// Both outputs are f32; x, B and C are f32 or bf16, a and dt f32.
//
// What bounds it: at the Zamba2-2.7B prefill shape (BK = 32 chunks, H = 80,
// C = 256, P = N = 64, x/B/C bf16) one launch must move 301 MB (x 84 MB in,
// y 168 MB and the states 42 MB out), 0.090 ms at 3.35 TB/s, against 16.3
// GFLOP over the lower triangle with C.B^T shared across heads (0.016 ms
// on the bf16 tensor cores): bytes bound it. bf16 inputs take the
// tensor-core kernel (ssd_intra_chunk_mma_kernel, mma.sync); they must
// have 16-byte aligned rows (pointers, and strides that are multiples of
// 8 elements), or the launch is refused. f32 inputs take the CUDA-core
// kernel (ssd_intra_chunk_kernel), exact to f32 rounding. Both recompute
// C.B^T for every head; sharing it across heads, and feeding the states
// to the recurrence, are later work.
//
// Design, common to both kernels:
// - One block owns one (bk, h). The TPU kernel holds the whole C x C =
//   256 x 256 f32 decay tile in VMEM (256 KB, more than a block's shared
//   memory); here the chunk is cut into 64-row tiles of i and, for each,
//   64-column tiles of j <= i only: tiles above the diagonal are never
//   formed.
// - cum is a prefix sum over the chunk in the block (warp shuffles, then
//   the warp totals). Its order of additions differs from XLA's cumsum.
// - L is formed only where j <= i: the exp of a positive difference above
//   the diagonal (inf, then inf * 0 = NaN in a naive product) is never
//   taken; those entries are 0, as the reference's where() makes them.
// - The states take a second pass over the chunk: B weighted by
//   exp(cum_end - cum_j) dt_j, times x.
// - Every array is read through its strides (last axis contiguous), so
//   the model's (B, K, C, H, P) layout of x and y needs no transpose.
//
// The CUDA-core kernel (f32 only, 256 threads): G = C_i . B_j over n in
// chunks of 64 (4x4 scores a thread, float4 loads from transposed tiles);
// M = G * L * dt_j goes to shared memory transposed; y accumulates 4 rows
// x P/16 columns a thread over the j tiles, then is written once; the
// states N/16 x P/16 sums a thread.

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
// One block of 4 warps owns one (bk, h); a warp owns 16 rows of each
// 64-row tile of i (and, for the states, 16 rows n). C.B^T is a product
// of bf16 inputs, exact in the f32 sums of mma.sync. The two products
// with x take f32 operands (M = G L dt and B exp(cum_end - cum) dt, as
// the reference computes them in f32), so those go in as bf16 pairs hi +
// lo, two products each, which holds them to about 2^-16 of their size.

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 in one register, the first in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
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

// 64 rows of W bf16 from src (row stride src_ld) into dst (row pitch ld),
// 16 bytes a load
template <int W>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           int64_t src_ld) {
  constexpr int CH = W / 8;
  for (int e = threadIdx.x; e < kTile * CH; e += kMmaThreads) {
    const int r = e / CH;
    const int c = e - r * CH;
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * src_ld + c * 8);
  }
}

// NK = N / 16, PN = P / 8
template <int NK, int PN>
__global__ void __launch_bounds__(kMmaThreads)
    ssd_intra_chunk_mma_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int N = 16 * NK;
  constexpr int P = 8 * PN;
  constexpr int LDN = N + 8;  // row pitch of the B and C tiles (bf16)
  constexpr int LDP = P + 8;  // row pitch of the x tile (bf16)
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* dts = cum + kMaxChunk;
  float* wdec = dts + kMaxChunk;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(wdec + kMaxChunk);
  __nv_bfloat16* bs = cs + kTile * LDN;  // [64][LDN] B rows j
  __nv_bfloat16* xs = bs + kTile * LDN;  // [64][LDP] x rows j

  const int h = blockIdx.x;
  const int bk = blockIdx.y;
  __shared__ float warp_sums[kMmaThreads / 32];
  chunk_cumsum<kMmaThreads>(g, bk, h, cum, dts, wdec, warp_sums);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // fragment row (and row + 8)
  const int tg = lane & 3;   // fragment column pair
  const __nv_bfloat16* xb =
      static_cast<const __nv_bfloat16*>(g.x) + bk * g.x_sb + h * g.x_sh;
  const __nv_bfloat16* Bb = static_cast<const __nv_bfloat16*>(g.Bm) + bk * g.B_sb;
  const __nv_bfloat16* Cb = static_cast<const __nv_bfloat16*>(g.Cm) + bk * g.C_sb;
  const int nt = g.C / kTile;
  const int r0 = warp * 16 + gr;

  // ---- y: lower-triangular tiles (it, jt <= it) ----
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kTile;
    __syncthreads();  // readers of cs, bs and xs are done
    stage_rows<N>(cs, LDN, Cb + (int64_t)i0 * g.C_sc, g.C_sc);
    __syncthreads();
    uint32_t cf[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      cf[kk][0] = lds32(cs + r0 * LDN + kk * 16 + tg * 2);
      cf[kk][1] = lds32(cs + (r0 + 8) * LDN + kk * 16 + tg * 2);
      cf[kk][2] = lds32(cs + r0 * LDN + kk * 16 + 8 + tg * 2);
      cf[kk][3] = lds32(cs + (r0 + 8) * LDN + kk * 16 + 8 + tg * 2);
    }
    float acc[PN][4];
#pragma unroll
    for (int nd = 0; nd < PN; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // readers of bs and xs are done
      stage_rows<N>(bs, LDN, Bb + (int64_t)j0 * g.B_sc, g.B_sc);
      stage_rows<P>(xs, LDP, xb + (int64_t)j0 * g.x_sc, g.x_sc);
      __syncthreads();

      // G = C_i . B_j^T, then M = G * L * dt_j, 0 above the diagonal
      float sc[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const __nv_bfloat16* br = bs + (nb * 8 + gr) * LDN + kk * 16 + tg * 2;
          mma_bf16(sc[nb], cf[kk], lds32(br), lds32(br + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = i0 + r0 + (e >> 1) * 8;
          const int jj = j0 + nb * 8 + tg * 2 + (e & 1);
          sc[nb][e] = jj <= ii
                          ? sc[nb][e] * expf(cum[ii] - cum[jj]) * dts[jj]
                          : 0.f;
        }
      }
      // y += M x_j
#pragma unroll
      for (int k16 = 0; k16 < kTile / 16; ++k16) {
        uint32_t hi[4], lo[4];
        split_f32(sc[2 * k16][0], sc[2 * k16][1], hi[0], lo[0]);
        split_f32(sc[2 * k16][2], sc[2 * k16][3], hi[1], lo[1]);
        split_f32(sc[2 * k16 + 1][0], sc[2 * k16 + 1][1], hi[2], lo[2]);
        split_f32(sc[2 * k16 + 1][2], sc[2 * k16 + 1][3], hi[3], lo[3]);
        const __nv_bfloat16* xr = xs + (k16 * 16 + tg * 2) * LDP + gr;
#pragma unroll
        for (int nd = 0; nd < PN; ++nd) {
          const __nv_bfloat16* xc = xr + nd * 8;
          const uint32_t b0 = pack2(xc[0], xc[LDP]);
          const uint32_t b1 = pack2(xc[8 * LDP], xc[9 * LDP]);
          mma_bf16(acc[nd], hi, b0, b1);
          mma_bf16(acc[nd], lo, b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* yrow = g.y + bk * g.y_sb + h * g.y_sh +
                    (int64_t)(i0 + r0 + i * 8) * g.y_sc + tg * 2;
#pragma unroll
      for (int nd = 0; nd < PN; ++nd)
        *reinterpret_cast<float2*>(yrow + nd * 8) =
            make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]);
    }
  }

  // ---- states: (B * wdec)^T x over the chunk, 16 rows n a warp a pass ----
  for (int pass = 0; pass * 4 < NK; ++pass) {
    const int rb = pass * 4 + warp;  // this warp's rows n = 16 rb + ...
    float sacc[PN][4];
#pragma unroll
    for (int nd = 0; nd < PN; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nd][e] = 0.f;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // readers of bs and xs are done
      stage_rows<N>(bs, LDN, Bb + (int64_t)j0 * g.B_sc, g.B_sc);
      stage_rows<P>(xs, LDP, xb + (int64_t)j0 * g.x_sc, g.x_sc);
      __syncthreads();
      if (rb < NK) {
        const int n = rb * 16 + gr;
#pragma unroll
        for (int k16 = 0; k16 < kTile / 16; ++k16) {
          const int jl = k16 * 16 + tg * 2;  // local j of a0; a4 is jl + 8
          const float w0 = wdec[j0 + jl], w1 = wdec[j0 + jl + 1];
          const float w8 = wdec[j0 + jl + 8], w9 = wdec[j0 + jl + 9];
          const __nv_bfloat16* b = bs + jl * LDN + n;
          uint32_t hi[4], lo[4];
          split_f32(__bfloat162float(b[0]) * w0,
                    __bfloat162float(b[LDN]) * w1, hi[0], lo[0]);
          split_f32(__bfloat162float(b[8]) * w0,
                    __bfloat162float(b[LDN + 8]) * w1, hi[1], lo[1]);
          split_f32(__bfloat162float(b[8 * LDN]) * w8,
                    __bfloat162float(b[9 * LDN]) * w9, hi[2], lo[2]);
          split_f32(__bfloat162float(b[8 * LDN + 8]) * w8,
                    __bfloat162float(b[9 * LDN + 8]) * w9, hi[3], lo[3]);
          const __nv_bfloat16* xr = xs + jl * LDP + gr;
#pragma unroll
          for (int nd = 0; nd < PN; ++nd) {
            const __nv_bfloat16* xc = xr + nd * 8;
            const uint32_t b0 = pack2(xc[0], xc[LDP]);
            const uint32_t b1 = pack2(xc[8 * LDP], xc[9 * LDP]);
            mma_bf16(sacc[nd], hi, b0, b1);
            mma_bf16(sacc[nd], lo, b0, b1);
          }
        }
      }
    }
    if (rb < NK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* srow = g.st + bk * g.s_sb + h * g.s_sh +
                      (int64_t)(rb * 16 + gr + i * 8) * g.s_sn + tg * 2;
#pragma unroll
        for (int nd = 0; nd < PN; ++nd)
          *reinterpret_cast<float2*>(srow + nd * 8) =
              make_float2(sacc[nd][2 * i], sacc[nd][2 * i + 1]);
      }
    }
  }
}

template <int NK, int PN>
cudaError_t launch_mma_t(const Args& g, cudaStream_t stream) {
  const int smem = (int)(3 * kMaxChunk * sizeof(float) +
                         (2 * kTile * (16 * NK + 8) + kTile * (8 * PN + 8)) *
                             sizeof(__nv_bfloat16));
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_mma_kernel<NK, PN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)g.H, (unsigned)g.BK);
  ssd_intra_chunk_mma_kernel<NK, PN><<<grid, kMmaThreads, smem, stream>>>(g);
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

// the tensor-core kernel stages rows of x, B and C as 16-byte chunks and
// writes y and the states in pairs
bool mma_ok(const Args& g) {
  const void* in[3] = {g.x, g.Bm, g.Cm};
  for (const void* p : in)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const void* out[2] = {g.y, g.st};
  for (const void* p : out)
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return false;
  const int64_t in_strides[5] = {g.x_sb, g.x_sh, g.x_sc, g.B_sc, g.C_sc};
  for (int64_t st : in_strides)
    if (st % 8 != 0) return false;
  const int64_t in_bk[2] = {g.B_sb, g.C_sb};
  for (int64_t st : in_bk)
    if (st % 8 != 0) return false;
  const int64_t out_strides[6] = {g.y_sb, g.y_sh, g.y_sc,
                                  g.s_sb, g.s_sh, g.s_sn};
  for (int64_t st : out_strides)
    if (st % 2 != 0) return false;
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
