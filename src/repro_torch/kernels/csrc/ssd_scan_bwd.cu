// The backward of the Mamba-2 SSD intra-chunk block on Hopper.
//
// Replaces no Pallas kernel: the TPU kernel (src/repro/kernels/ssd_scan.py)
// has no backward, and the reference trains through XLA's autodiff of its
// einsum path (src/repro/models/ssm.py, the intra-chunk block of
// ssd_chunked). This is the gradient of csrc/ssd_scan.cu. Per chunk (bk)
// and head (h), with cum = cumsum(a), L[i,j] = exp(cum_i - cum_j) for
// i >= j (else 0), S = C B^T, M = S * L * dt_j, w_j = exp(cum_end - cum_j)
// dt_j and G = dy x^T (i >= j):
//   dx     = M^T dy + w * (B dst)
//   dS     = G * L * dt_j,  D = sum_h dS
//   dC     = D B,  dB = D^T C + sum_h w * (x dst^T)
//   ddt_j  = sum_i (G * S * L)_ij + exp(cum_end - cum_j) x_j . (B_j dst)
//   dcum_i = sum_j (G * M)_ij - sum_k (G * M)_ki (+ the states' terms)
//   da     = reverse cumsum of dcum
//
// The states as N more rows. state[n,:] = sum_j B[j,n] w_j x_j is y of a
// row at the chunk's end (cum_i = cum_end, no mask) whose C is the unit
// vector e_n. So the backward runs over C + N rows i: the chunk's own and
// N "virtual" rows, whose dy is dst, whose S[n, j] is B[j, n] and whose L
// is exp(cum_end - cum_j). Every formula above then holds as written: the
// virtual rows give dx its w * (B dst), ddt and dcum their states' terms
// (their row sums go to cum_end), and D's virtual rows are sum_h w * (x
// dst^T), dB's second term (C = I there). Without a states gradient there
// are no virtual rows.
//
// Four kernels a call, no atomics (every sum in one fixed order, so a call
// is bitwise repeatable):
// 1. ssd_scan_bwd_scores: S^T of every 16 x 16 block on or below the
//    diagonal, and of the virtual blocks, once a chunk (the heads share
//    it), in f32, laid out in the order of an m16n8 accumulator fragment
//    (lane-major, 8 values a lane) so that a warp reads a block in two
//    16-byte loads a lane.
// 2. ssd_scan_bwd_chunk: one block a (chunk, head), 16 warps. x of the
//    head is in shared memory; the row strips of dy (16 rows, then the
//    virtual rows' dst) stream through a double buffer, all warps in
//    step. Warp k owns column strip k (at row strip s it has a block when
//    k <= s, and at every virtual strip: a step costs one block, 16 +
//    N/16 steps at C = 256) and works in the transposed layout (rows j,
//    columns i): for each block it forms G^T = x_j dy_i^T, then M, dS,
//    G*S*L and G*M elementwise, accumulates dx_j += M^T dy (the
//    accumulator fragment of M^T is the A operand of the next product),
//    ddt_j and the column sums of G*M in registers, leaves the row sums
//    of G*M in shared memory (one slot a block and row), and writes dS^T
//    of the block for this head. The last step turns the row and column
//    sums into dcum and da (one warp's reverse scan).
// 3. ssd_scan_bwd_headsum: D = sum_h dS in head order, into (C + N) x C.
// 4. ssd_scan_bwd_dbdc: dC = D B and dB = D^T C + D_virtual^T, f32 sums on
//    the CUDA cores (C^2 N multiply-adds a chunk, beside H C^2 P for the
//    head products).
//
// Types: x, B and C are f32 or bf16 (one type), a, dt, dy and dst f32; dx
// is written in x's type, dB and dC in B's, da and ddt in f32. bf16 runs
// the two products with x on the tensor cores (mma.sync.m16n8k16): x is
// bf16 already; dy (f32) goes in as bf16 hi + lo, and M (f32) too, three
// products for M^T dy (hi hi, lo hi, hi lo), which holds both to about
// 2^-16 of their size. f32 takes the same kernels with those two products
// on the CUDA cores, exact to f32 rounding.
//
// What bounds it: at mamba2-2.7b's training shape (BK 32, H 80, C 256,
// P 64, N 128, bf16) the function must move x, dy, dst and dx (84 + 168 +
// 84 + 84 MB) and little else, 438 MB in all, 0.131 ms at 3.35 TB/s,
// against 43.8 GFLOP over the lower triangle (0.044 ms on the bf16 tensor
// cores): bytes bound it. This design also writes dS^T of every head (f32,
// 264 blocks of 1 KB a (chunk, head) there: 0.69 GB), which the head sum
// of kernel 3 reads back; D held across a block's heads, (C^2/2 + N C)
// f32, does not fit in a block's registers. On an NVIDIA H100 80GB HBM3
// at 700 W a call took 1.607 ms there, 8% of the bound (chip_smoke.py
// phase 2d), the two products a third of the per-(chunk, head) kernel
// and the dS stores under 1% (kernel_ablations.py). The dS^T tiles above
// the diagonal are never formed, and exp(cum_i - cum_j) is taken only
// where i >= j (its exponent may be positive above, and inf * 0 is NaN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;         // ssd_scan_bwd_chunk: one a strip
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 256;

struct Args {
  const void* x;
  const float* a;
  const void* Bm;
  const void* Cm;
  const float* dt;
  const float* dy;
  const float* dst;  // null: no states gradient, no virtual rows
  void* dx;
  float* da;         // (BK, H, C) contiguous
  void* dB;          // (BK, C, N) contiguous, B's type
  void* dC;          // (BK, C, N) contiguous, C's type
  float* ddt;        // (BK, H, C) contiguous
  float* S;          // (BK, nblk, 256): S^T blocks, fragment order
  float* Dh;         // (BK, H, nblk, 256): dS^T blocks of each head
  float* Dsum;       // (BK, C + N, C): sum over the heads, [i][j]
  int BK, H, C, P, N;
  int ns, nv, nreal, nblk;  // row strips, virtual strips, blocks
  int64_t x_sb, x_sh, x_sc;
  int64_t a_sb, a_sh, a_sc;
  int64_t d_sb, d_sh, d_sc;
  int64_t B_sb, B_sc;
  int64_t C_sb, C_sc;
  int64_t g_sb, g_sh, g_sc;  // dy
  int64_t s_sb, s_sh, s_sn;  // dst
  int64_t o_sb, o_sh, o_sc;  // dx
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// element r (0..7) of lane l of an m16n8 accumulator pair (16 x 16):
// its row and column in the block
__device__ __forceinline__ int frag_row(int lane, int r) {
  return (lane >> 2) + 8 * ((r >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int lane, int r) {
  return 2 * (lane & 3) + (r & 1) + 8 * (r >> 2);
}

// block b of a chunk: its row strip s (>= ns for the virtual rows) and
// column strip k
__device__ __forceinline__ void block_strips(const Args& g, int b, int& s,
                                             int& k) {
  if (b < g.nreal) {
    s = 0;
    while ((s + 1) * (s + 2) / 2 <= b) ++s;
    k = b - s * (s + 1) / 2;
  } else {
    const int v = (b - g.nreal) / g.ns;
    s = g.ns + v;
    k = b - g.nreal - v * g.ns;
  }
}

// ---- 1. S^T of each block, once a chunk ----
// one block of 256 threads a 16 x 16 block: the strips of C and B go
// through shared memory in f32, then each thread sums one entry over n
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_scan_bwd_scores(const Args g) {
  __shared__ float cs[16][129];
  __shared__ float bs[16][129];
  const int b = blockIdx.x;
  const int64_t bk = blockIdx.y;
  int s, k;
  block_strips(g, b, s, k);
  const bool virt = s >= g.ns;
  const T* Bb = static_cast<const T*>(g.Bm) + bk * g.B_sb;
  const T* Cb = static_cast<const T*>(g.Cm) + bk * g.C_sb;
  for (int e = threadIdx.x; e < 16 * g.N; e += 256) {
    const int r = e / g.N;
    const int n = e - r * g.N;
    bs[r][n] = to_f32(Bb[(int64_t)(16 * k + r) * g.B_sc + n]);
    if (!virt) cs[r][n] = to_f32(Cb[(int64_t)(16 * s + r) * g.C_sc + n]);
  }
  __syncthreads();
  const int lane = threadIdx.x >> 3;
  const int r = threadIdx.x & 7;
  const int jr = frag_row(lane, r);
  const int ic = frag_col(lane, r);
  float v;
  if (!virt) {
    v = 0.f;
    for (int n = 0; n < g.N; ++n) v = fmaf(cs[ic][n], bs[jr][n], v);
  } else {
    v = bs[jr][16 * (s - g.ns) + ic];
  }
  g.S[(bk * g.nblk + b) * 256 + threadIdx.x] = v;
}

// ---- 2. the per-(chunk, head) kernel ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

// shared memory of ssd_scan_bwd_chunk, in floats: the vectors, the row
// sums, then the x tile and the row-strip buffers (see chunk_smem_bytes)
struct Smem {
  float* cum;   // [C] cumsum(a)
  float* dts;   // [C] dt
  float* ddt;   // [C] ddt_j
  float* csum;  // [C] sum_i (G M)_ij
  float* dcum;  // [C]
  float* rs;    // [ns][C] row sums of G M, one slot a column strip
  float* rsv;   // [ns][N] the same for the virtual rows
  void* xs;     // [C][LDX] x of the head
  void* buf;    // row strips: bf16 [2][hi, lo][16][LDX]; f32 [2][16][LDX]
  float* mst;   // f32 only: [warps][16][17] M^T of a block
};

template <typename T>
__host__ __device__ constexpr int x_pitch(int P) {
  return sizeof(T) == 2 ? P + 8 : P + 4;
}

template <typename T>
__host__ __device__ inline size_t chunk_smem_bytes(int C, int N, int P) {
  const int ns = C / 16;
  size_t f = 5 * (size_t)C + (size_t)ns * C + (size_t)ns * N;
  size_t bytes = f * 4;
  bytes = (bytes + 15) / 16 * 16;
  const int ld = x_pitch<T>(P);
  bytes += (size_t)C * ld * sizeof(T);
  bytes += (sizeof(T) == 2 ? 4 : 2) * (size_t)16 * ld * sizeof(T);
  if (sizeof(T) == 4) bytes += (size_t)kWarps * 16 * 17 * 4;
  return bytes;
}

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* raw, int C, int N,
                                      int P) {
  Smem m;
  const int ns = C / 16;
  float* f = reinterpret_cast<float*>(raw);
  m.cum = f;
  m.dts = m.cum + C;
  m.ddt = m.dts + C;
  m.csum = m.ddt + C;
  m.dcum = m.csum + C;
  m.rs = m.dcum + C;
  m.rsv = m.rs + ns * C;
  size_t off = (5 * (size_t)C + (size_t)ns * C + (size_t)ns * N) * 4;
  off = (off + 15) / 16 * 16;
  const int ld = x_pitch<T>(P);
  m.xs = raw + off;
  off += (size_t)C * ld * sizeof(T);
  m.buf = raw + off;
  off += (sizeof(T) == 2 ? 4 : 2) * (size_t)16 * ld * sizeof(T);
  m.mst = reinterpret_cast<float*>(raw + off);
  return m;
}

// this thread's share of row strip t (16 rows of dy, or of dst for a
// virtual strip), f32: P / 32 values
template <int P>
__device__ __forceinline__ void load_strip(const Args& g, int64_t bk,
                                           int64_t h, int t,
                                           float (&v)[P * 16 / kThreads]) {
  const float* src;
  int64_t ld;
  if (t < g.ns) {
    src = g.dy + bk * g.g_sb + h * g.g_sh + (int64_t)(16 * t) * g.g_sc;
    ld = g.g_sc;
  } else {
    src = g.dst + bk * g.s_sb + h * g.s_sh +
          (int64_t)(16 * (t - g.ns)) * g.s_sn;
    ld = g.s_sn;
  }
#pragma unroll
  for (int q = 0; q < P * 16 / kThreads; ++q) {
    const int e = threadIdx.x + kThreads * q;
    const int r = e / P;
    const int p = e - r * P;
    v[q] = src[r * ld + p];
  }
}

// this thread's share of a strip into buffer `which`: bf16 hi and lo
// planes, or f32
template <typename T, int P>
__device__ __forceinline__ void store_strip(
    const Smem& m, int which, const float (&v)[P * 16 / kThreads]) {
  constexpr int LD = x_pitch<T>(P);
#pragma unroll
  for (int q = 0; q < P * 16 / kThreads; ++q) {
    const int e = threadIdx.x + kThreads * q;
    const int r = e / P;
    const int p = e - r * P;
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat16* hi =
          static_cast<__nv_bfloat16*>(m.buf) + (2 * which) * 16 * LD;
      __nv_bfloat16* lo = hi + 16 * LD;
      const __nv_bfloat16 h = __float2bfloat16_rn(v[q]);
      hi[r * LD + p] = h;
      lo[r * LD + p] = __float2bfloat16_rn(v[q] - __bfloat162float(h));
    } else {
      static_cast<float*>(m.buf)[(which * 16 + r) * LD + p] = v[q];
    }
  }
}

// one 16 x 16 block (row strip s, column strip k) of one head for the
// warp that owns column strip k: see the file's note. acc: dx_j (16 x P
// m16n8 fragments); dd, cs: ddt_j and the column sums of G*M for rows gr
// and gr + 8
// S^T of block (s, k) (precomputed, fragment order): this lane's 8
__device__ __forceinline__ void load_scores(const Args& g, int64_t bk, int s,
                                            int k, float (&sv)[8]) {
  const int b = s >= g.ns ? g.nreal + (s - g.ns) * g.ns + k
                          : s * (s + 1) / 2 + k;
  const float4* sp = reinterpret_cast<const float4*>(
      g.S + (bk * g.nblk + b) * 256 + (threadIdx.x & 31) * 8);
  const float4 s0 = sp[0], s1 = sp[1];
  sv[0] = s0.x, sv[1] = s0.y, sv[2] = s0.z, sv[3] = s0.w;
  sv[4] = s1.x, sv[5] = s1.y, sv[6] = s1.z, sv[7] = s1.w;
}

template <typename T, int P>
__device__ __forceinline__ void block_step(const Args& g, const Smem& m,
                                           int64_t bk, int64_t h, int s,
                                           int k, int which,
                                           const float (&sv)[8],
                                           float (&acc)[P / 8][4],
                                           float (&dd)[2], float (&cs)[2]) {
  constexpr int PN = P / 8;
  constexpr int LD = x_pitch<T>(P);
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const bool virt = s >= g.ns;
  const int b = virt ? g.nreal + (s - g.ns) * g.ns + k : s * (s + 1) / 2 + k;

  // G^T = x_j . dy_i over p
  float gt[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) gt[r] = 0.f;
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat16* xs = static_cast<const __nv_bfloat16*>(m.xs);
    const __nv_bfloat16* hi =
        static_cast<const __nv_bfloat16*>(m.buf) + (2 * which) * 16 * LD;
    const __nv_bfloat16* lo = hi + 16 * LD;
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t af[4], bh[4], bl[4];
      ldsm_x4(af, xs + (16 * k + (lane & 15)) * LD + 16 * kk +
                      (lane >> 4) * 8);
      const int off = ((lane >> 4) * 8 + (lane & 7)) * LD + 16 * kk +
                      ((lane >> 3) & 1) * 8;
      ldsm_x4(bh, hi + off);
      ldsm_x4(bl, lo + off);
      mma_bf16(gt, af, bh[0], bh[1]);
      mma_bf16(gt + 4, af, bh[2], bh[3]);
      mma_bf16(gt, af, bl[0], bl[1]);
      mma_bf16(gt + 4, af, bl[2], bl[3]);
    }
  } else {
    const float* xs = static_cast<const float*>(m.xs);
    const float* dyf = static_cast<const float*>(m.buf) + which * 16 * LD;
    const float* x0 = xs + (16 * k + gr) * LD;
    const float* x8 = x0 + 8 * LD;
    const float* d0 = dyf + (2 * tg) * LD;
    for (int p = 0; p < P; ++p) {
      const float xa = x0[p], xb = x8[p];
      const float e0 = d0[p], e1 = d0[LD + p];
      const float e8 = d0[8 * LD + p], e9 = d0[9 * LD + p];
      gt[0] = fmaf(xa, e0, gt[0]);
      gt[1] = fmaf(xa, e1, gt[1]);
      gt[2] = fmaf(xb, e0, gt[2]);
      gt[3] = fmaf(xb, e1, gt[3]);
      gt[4] = fmaf(xa, e8, gt[4]);
      gt[5] = fmaf(xa, e9, gt[5]);
      gt[6] = fmaf(xb, e8, gt[6]);
      gt[7] = fmaf(xb, e9, gt[7]);
    }
  }

  // elementwise: M, dS, G*S*L and G*M; exp only where i >= j
  const float cend = m.cum[g.C - 1];
  float mt[8], ds[8];
  float rsum[2] = {0.f, 0.f}, rgm[2] = {0.f, 0.f};
  float colgm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = 16 * k + frag_row(lane, r);
    const int ic = frag_col(lane, r);
    float ci;
    bool valid;
    if (virt) {
      ci = cend;
      valid = true;
    } else {
      ci = m.cum[16 * s + ic];
      valid = 16 * s + ic >= j;
    }
    const float L = valid ? expf(ci - m.cum[j]) : 0.f;
    const float dtj = m.dts[j];
    const float sl = sv[r] * L;
    mt[r] = sl * dtj;
    ds[r] = gt[r] * L * dtj;
    const float gsl = gt[r] * sl;
    const float gm = gsl * dtj;
    rsum[(r >> 1) & 1] += gsl;
    rgm[(r >> 1) & 1] += gm;
    colgm[(r & 1) + 2 * (r >> 2)] += gm;
  }

  // dS^T of this head's block, fragment order
  {
    float4* dp = reinterpret_cast<float4*>(
        g.Dh + (((int64_t)bk * g.H + h) * g.nblk + b) * 256 + lane * 8);
    dp[0] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    dp[1] = make_float4(ds[4], ds[5], ds[6], ds[7]);
  }

  // row sums over the block's columns i (rows j: this warp's own)
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rsum[t] += __shfl_xor_sync(0xffffffffu, rsum[t], off);
      rgm[t] += __shfl_xor_sync(0xffffffffu, rgm[t], off);
    }
    dd[t] += rsum[t];
    cs[t] += rgm[t];
  }
  // column sums over the block's rows j: one slot a (column strip, row i)
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      colgm[c] += __shfl_xor_sync(0xffffffffu, colgm[c], off);
  }
  if (gr == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ic = 2 * tg + (c & 1) + 8 * (c >> 1);
      if (virt)
        m.rsv[k * g.N + 16 * (s - g.ns) + ic] = colgm[c];
      else
        m.rs[k * g.C + 16 * s + ic] = colgm[c];
    }
  }

  // dx_j += M^T dy over the block's rows i
  if constexpr (sizeof(T) == 2) {
    uint32_t mh[4], ml[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_f32(mt[2 * q], mt[2 * q + 1], mh[q], ml[q]);
    const __nv_bfloat16* hi =
        static_cast<const __nv_bfloat16*>(m.buf) + (2 * which) * 16 * LD;
    const __nv_bfloat16* lo = hi + 16 * LD;
    const int off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int pp = 0; pp < PN / 2; ++pp) {
      uint32_t bh[4], bl[4];
      ldsm_x4_t(bh, hi + off + pp * 16);
      ldsm_x4_t(bl, lo + off + pp * 16);
      mma_bf16(acc[2 * pp], mh, bh[0], bh[1]);
      mma_bf16(acc[2 * pp + 1], mh, bh[2], bh[3]);
      mma_bf16(acc[2 * pp], ml, bh[0], bh[1]);
      mma_bf16(acc[2 * pp + 1], ml, bh[2], bh[3]);
      mma_bf16(acc[2 * pp], mh, bl[0], bl[1]);
      mma_bf16(acc[2 * pp + 1], mh, bl[2], bl[3]);
    }
  } else {
    float* mst = m.mst + (threadIdx.x >> 5) * 16 * 17;
    const float* dyf = static_cast<const float*>(m.buf) + which * 16 * LD;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 8; ++r)
      mst[frag_row(lane, r) * 17 + frag_col(lane, r)] = mt[r];
    __syncwarp();
#pragma unroll
    for (int nd = 0; nd < PN; ++nd) {
      const int p = 8 * nd + 2 * tg;
      float a0 = acc[nd][0], a1 = acc[nd][1], a2 = acc[nd][2],
            a3 = acc[nd][3];
      for (int i = 0; i < 16; ++i) {
        const float m0 = mst[gr * 17 + i], m8 = mst[(gr + 8) * 17 + i];
        const float y0 = dyf[i * LD + p], y1 = dyf[i * LD + p + 1];
        a0 = fmaf(m0, y0, a0);
        a1 = fmaf(m0, y1, a1);
        a2 = fmaf(m8, y0, a2);
        a3 = fmaf(m8, y1, a3);
      }
      acc[nd][0] = a0, acc[nd][1] = a1, acc[nd][2] = a2, acc[nd][3] = a3;
    }
  }
}

// dx rows of column strip k from the accumulator fragments, in x's type
template <typename T, int P>
__device__ __forceinline__ void store_dx(const Args& g, int64_t bk,
                                         int64_t h, int k,
                                         const float (&acc)[P / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  T* base = static_cast<T*>(g.dx) + bk * g.o_sb + h * g.o_sh;
  T* r0 = base + (int64_t)(16 * k + gr) * g.o_sc;
  T* r8 = r0 + 8 * g.o_sc;
#pragma unroll
  for (int nd = 0; nd < P / 8; ++nd) {
    const int p = 8 * nd + 2 * tg;
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<__nv_bfloat162*>(r0 + p) =
          __floats2bfloat162_rn(acc[nd][0], acc[nd][1]);
      *reinterpret_cast<__nv_bfloat162*>(r8 + p) =
          __floats2bfloat162_rn(acc[nd][2], acc[nd][3]);
    } else {
      r0[p] = acc[nd][0];
      r0[p + 1] = acc[nd][1];
      r8[p] = acc[nd][2];
      r8[p + 1] = acc[nd][3];
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_bwd_chunk(const Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int PN = P / 8;
  constexpr int LD = x_pitch<T>(P);
  const Smem m = carve<T>(smem_raw, g.C, g.N, P);
  const int64_t h = blockIdx.x;
  const int64_t bk = blockIdx.y;
  const int C = g.C;
  const int ns = g.ns;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x;

  // x of the head into shared memory
  {
    const T* xb = static_cast<const T*>(g.x) + bk * g.x_sb + h * g.x_sh;
    if constexpr (sizeof(T) == 2) {
      constexpr int CH = P / 8;  // 16-byte pieces a row
      for (int e = tid; e < C * CH; e += kThreads) {
        const int r = e / CH;
        const int c = e - r * CH;
        *reinterpret_cast<uint4*>(static_cast<T*>(m.xs) + r * LD + 8 * c) =
            *reinterpret_cast<const uint4*>(xb + r * g.x_sc + 8 * c);
      }
    } else {
      for (int e = tid; e < C * P; e += kThreads) {
        const int r = e / P;
        const int p = e - r * P;
        static_cast<T*>(m.xs)[r * LD + p] = xb[r * g.x_sc + p];
      }
    }
  }
  // a, dt; the first row strip
  for (int c = tid; c < C; c += kThreads) {
    m.dts[c] = g.dt[bk * g.d_sb + h * g.d_sh + c * g.d_sc];
    m.dcum[c] = g.a[bk * g.a_sb + h * g.a_sh + c * g.a_sc];
  }
  {
    float v[P * 16 / kThreads];
    load_strip<P>(g, bk, h, 0, v);
    store_strip<T, P>(m, 0, v);
  }
  __syncthreads();
  // cum = cumsum(a): warp 0, lane l owns C / 32 consecutive entries
  if (warp == 0) {
    const int E = C / 32;
    float v[kMaxChunk / 32];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxChunk / 32; ++e)
      if (e < E) {
        run += m.dcum[lane * E + e];
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
#pragma unroll
    for (int e = 0; e < kMaxChunk / 32; ++e)
      if (e < E) m.cum[lane * E + e] = v[e] + excl;
  }
  __syncthreads();

  // the warp's column strip k = warp
  const bool owns = warp < ns;
  const int k = warp;
  float acc[PN][4];
  float dd[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < PN; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // step s holds block (s, k) when k <= s (every virtual step holds
  // one); its S^T and its row strip are loaded a step ahead
  const int R = ns + g.nv;
  float sv[8];
  if (owns && k == 0) load_scores(g, bk, 0, k, sv);
  for (int s = 0; s < R; ++s) {
    const int which = s & 1;
    float v[P * 16 / kThreads], nsv[8];
    if (s + 1 < R) {
      load_strip<P>(g, bk, h, s + 1, v);
      if (owns && (s + 1 >= ns || k <= s + 1))
        load_scores(g, bk, s + 1, k, nsv);
    }
    if (owns && (s >= ns || k <= s))
      block_step<T, P>(g, m, bk, h, s, k, which, sv, acc, dd, cs);
    if (s + 1 < R) {
      store_strip<T, P>(m, which ^ 1, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) sv[e] = nsv[e];
    }
    __syncthreads();
  }

  if (owns) {
    store_dx<T, P>(g, bk, h, k, acc);
    if ((lane & 3) == 0) {
      const int gr = lane >> 2;
      m.ddt[16 * k + gr] = dd[0];
      m.ddt[16 * k + gr + 8] = dd[1];
      m.csum[16 * k + gr] = cs[0];
      m.csum[16 * k + gr + 8] = cs[1];
    }
  }
  __syncthreads();
  // the virtual rows' row sums, all of which go to the chunk's last row:
  // warp 0 adds them in a fixed order (per lane, then a fixed tree) and
  // leaves the total in rsv[0]
  if (g.nv && warp == 0) {
    float t = 0.f;
    for (int e = lane; e < ns * g.N; e += 32) t += m.rsv[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) m.rsv[0] = t;
  }
  __syncthreads();

  // dcum_i = sum_k rs[k][i] - csum_i (+ the virtual rows' total at the
  // chunk's last row); ddt out
  const int64_t vec = (bk * g.H + h) * C;
  for (int i = tid; i < C; i += kThreads) {
    float t = 0.f;
    for (int k = 0; k <= i / 16; ++k) t += m.rs[k * C + i];
    if (i == C - 1 && g.nv) t += m.rsv[0];
    m.dcum[i] = t - m.csum[i];
    g.ddt[vec + i] = m.ddt[i];
  }
  __syncthreads();
  // da = reverse cumsum of dcum: warp 0, lane l owns C / 32 entries
  if (warp == 0) {
    const int E = C / 32;
    float v[kMaxChunk / 32];
    float run = 0.f;
#pragma unroll
    for (int e = kMaxChunk / 32 - 1; e >= 0; --e)
      if (e < E) {
        run += m.dcum[lane * E + e];
        v[e] = run;
      }
    float tot = run;  // suffix sums over the lanes above
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, tot, off);
      if (lane + off < 32) tot += t;
    }
    float excl = __shfl_down_sync(0xffffffffu, tot, 1);
    if (lane == 31) excl = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxChunk / 32; ++e)
      if (e < E) g.da[vec + lane * E + e] = v[e] + excl;
  }
}

// ---- 3. D = sum over the heads, in head order ----
__global__ void __launch_bounds__(256) ssd_scan_bwd_headsum(const Args g) {
  const int b = blockIdx.x;
  const int64_t bk = blockIdx.y;
  int s, k;
  block_strips(g, b, s, k);
  const int lane = threadIdx.x >> 3;
  const int r = threadIdx.x & 7;
  const float* src = g.Dh + (bk * g.H * g.nblk + b) * 256 + threadIdx.x;
  const int64_t hs = (int64_t)g.nblk * 256;
  float t = 0.f;
  for (int h = 0; h < g.H; ++h) t += src[h * hs];
  const int j = 16 * k + frag_row(lane, r);
  const int i = 16 * s + frag_col(lane, r);  // virtual rows follow C
  g.Dsum[(bk * (g.C + g.N) + i) * g.C + j] = t;
}

// ---- 4. dC = D B, dB = D^T C + the virtual rows ----
template <typename T>
__global__ void __launch_bounds__(256) ssd_scan_bwd_dbdc(const Args g) {
  const int64_t bk = blockIdx.y;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= g.C * g.N) return;
  const int row = e / g.N;
  const int n = e - row * g.N;
  const float* D = g.Dsum + bk * (g.C + g.N) * g.C;
  float t = 0.f;
  if (blockIdx.z == 0) {  // dC[i][n] = sum_{j <= i} D[i][j] B[j][n]
    const T* Bb = static_cast<const T*>(g.Bm) + bk * g.B_sb + n;
    for (int j = 0; j <= row; ++j)
      t = fmaf(D[row * g.C + j], to_f32(Bb[j * g.B_sc]), t);
    static_cast<T*>(g.dC)[(bk * g.C + row) * g.N + n] = from_f32<T>(t);
  } else {  // dB[j][n] = sum_{i >= j} D[i][j] C[i][n] + D[C + n][j]
    const T* Cb = static_cast<const T*>(g.Cm) + bk * g.C_sb + n;
    for (int i = row; i < g.C; ++i)
      t = fmaf(D[i * g.C + row], to_f32(Cb[i * g.C_sc]), t);
    if (g.nv) t += D[(g.C + n) * g.C + row];
    static_cast<T*>(g.dB)[(bk * g.C + row) * g.N + n] = from_f32<T>(t);
  }
}

template <typename T, int P>
cudaError_t launch_chunk(const Args& g, cudaStream_t stream) {
  const size_t smem = chunk_smem_bytes<T>(g.C, g.N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_chunk<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_chunk<T, P>
      <<<dim3((unsigned)g.H, (unsigned)g.BK), kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const Args& g, cudaStream_t stream) {
  ssd_scan_bwd_scores<T>
      <<<dim3((unsigned)g.nblk, (unsigned)g.BK), 256, 0, stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (g.P) {
    case 32: err = launch_chunk<T, 32>(g, stream); break;
    case 64: err = launch_chunk<T, 64>(g, stream); break;
    case 128: err = launch_chunk<T, 128>(g, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_headsum<<<dim3((unsigned)g.nblk, (unsigned)g.BK), 256, 0,
                         stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_dbdc<T><<<dim3((unsigned)((g.C * g.N + 255) / 256),
                              (unsigned)g.BK, 2),
                         256, 0, stream>>>(g);
  return cudaGetLastError();
}

// the bf16 kernel copies rows of x in 16-byte pieces and writes dx two
// elements a store
bool bf16_ok(const Args& g) {
  if (reinterpret_cast<uintptr_t>(g.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g.dx) % 4 != 0)
    return false;
  const int64_t in_strides[3] = {g.x_sb, g.x_sh, g.x_sc};
  for (int64_t st : in_strides)
    if (st % 8 != 0) return false;
  const int64_t out_strides[3] = {g.o_sb, g.o_sh, g.o_sc};
  for (int64_t st : out_strides)
    if (st % 2 != 0) return false;
  return true;
}

}  // namespace

// Floats of workspace a call needs: the S^T blocks, each head's dS^T
// blocks and the head sum.
extern "C" long long ssd_scan_bwd_workspace(long long BK, long long H,
                                            long long C, long long N,
                                            int has_dst) {
  const long long ns = C / 16;
  const long long nblk = ns * (ns + 1) / 2 + (has_dst ? N / 16 * ns : 0);
  return BK * nblk * 256 + BK * H * nblk * 256 + BK * (C + N) * C;
}

// dims: BK, H, C, P, N, then the element strides x (bk, h, c), a (bk, h,
// c), dt (bk, h, c), B (bk, c), C (bk, c), dy (bk, h, c), dst (bk, h, n),
// dx (bk, h, c) (22 values). dtype of x, B, C, dx, dB and dC: 0 = f32,
// 1 = bf16. dst may be null (no states gradient). ws: the floats of
// ssd_scan_bwd_workspace. Takes C a multiple of 64 up to 256, N in {16,
// 32, 64, 128}, P in {32, 64, 128}; the last axis of every array
// contiguous. Returns the CUDA error of the launches;
// cudaErrorInvalidValue for a shape, or a bf16 layout, that no kernel
// takes.
extern "C" int ssd_scan_bwd_launch(const void* x, const float* a,
                                   const void* Bm, const void* Cm,
                                   const float* dt, const float* dy,
                                   const float* dst, void* dx, float* da,
                                   void* dB, void* dC, float* ddt,
                                   float* ws, const long long* dims,
                                   int dtype, void* stream) {
  Args g;
  g.x = x;
  g.a = a;
  g.Bm = Bm;
  g.Cm = Cm;
  g.dt = dt;
  g.dy = dy;
  g.dst = dst;
  g.dx = dx;
  g.da = da;
  g.dB = dB;
  g.dC = dC;
  g.ddt = ddt;
  g.BK = (int)dims[0];
  g.H = (int)dims[1];
  g.C = (int)dims[2];
  g.P = (int)dims[3];
  g.N = (int)dims[4];
  const long long* st = dims + 5;
  g.x_sb = st[0], g.x_sh = st[1], g.x_sc = st[2];
  g.a_sb = st[3], g.a_sh = st[4], g.a_sc = st[5];
  g.d_sb = st[6], g.d_sh = st[7], g.d_sc = st[8];
  g.B_sb = st[9], g.B_sc = st[10];
  g.C_sb = st[11], g.C_sc = st[12];
  g.g_sb = st[13], g.g_sh = st[14], g.g_sc = st[15];
  g.s_sb = st[16], g.s_sh = st[17], g.s_sn = st[18];
  g.o_sb = st[19], g.o_sh = st[20], g.o_sc = st[21];
  if (g.C < 64 || g.C > kMaxChunk || g.C % 64 != 0 || g.BK < 1 ||
      g.H < 1 || g.BK > 65535 || g.H > 65535 ||
      (g.N != 16 && g.N != 32 && g.N != 64 && g.N != 128) ||
      (g.P != 32 && g.P != 64 && g.P != 128))
    return (int)cudaErrorInvalidValue;
  g.ns = g.C / 16;
  g.nv = dst ? g.N / 16 : 0;
  g.nreal = g.ns * (g.ns + 1) / 2;
  g.nblk = g.nreal + g.nv * g.ns;
  g.S = ws;
  g.Dh = g.S + (size_t)g.BK * g.nblk * 256;
  g.Dsum = g.Dh + (size_t)g.BK * g.H * g.nblk * 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_all<float>(g, s);
  if (dtype == 1 && bf16_ok(g)) return (int)launch_all<__nv_bfloat16>(g, s);
  return (int)cudaErrorInvalidValue;
}
