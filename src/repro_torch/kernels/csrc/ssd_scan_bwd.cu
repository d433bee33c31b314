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
// The decomposition. B and C are shared by all H heads, as a kv head's k
// and v are shared by its query heads, so D is summed over the heads on
// chip, as flash_attention_bwd.cu sums dK and dV: a block owns a (chunk,
// 64-wide column tile jt of j, head group) and loops over the group's
// heads. Its rows i are the row tiles it >= jt of the chunk and the
// virtual rows, in 64-row tiles ("positions": the real tiles jt..C/64-1,
// then the virtual ones). For each head it forms, tile by tile and in the
// transposed layout (rows j, columns i), G^T, M^T, dS^T, G*S*L and G*M,
// and keeps:
//   - dx_j += M^T dy, complete in the block (written once a head);
//   - ddt_j and the row sums of (G*M)^T (the -sum_k (G*M)_kj term of
//     dcum_j), complete in the block;
//   - the column sums of (G*M)^T, dcum's first term, a partial over the
//     column tiles, and the virtual rows' total (which goes to the
//     chunk's last row): written to `part` (one row a (chunk, head,
//     column tile));
//   - D^T of each position summed over the group's heads in shared
//     memory (f32), written to the workspace once a group.
// Three kernels a call, no float atomics (every sum in one fixed order, so
// a call repeats bit for bit):
// 1. ssd_scan_bwd_tiles (bf16, below) or ssd_scan_bwd_tiles_f32: the
//    above. Grid (column tile, chunk, head group), column tiles slowest,
//    so the longest (tile 0: C + N rows) run first over the whole grid,
//    which evens out the blocks' unequal work better than running the
//    column tiles of a (chunk, group) together for dy's reuse in L2 does
//    (kernel_ablations.py times the other order).
// 2. ssd_scan_bwd_dbdc: dB = D^T C + D_virtual and dC = D B from the
//    groups' partials, summed in group order as a 64 x 64 tile of D is
//    read (f32 on the CUDA cores: C^2 N multiply-adds a chunk, beside
//    H C^2 P for the head products).
// 3. ssd_scan_bwd_da: dcum = the column tiles' partials in order, then
//    da, its reverse cumulative sum (one warp a (chunk, head)).
// The groups: as few as leave kTargetBlocks blocks (4 an SM of an H100)
// in kernel 1, from the shape alone, so the sums' order, and the bits, do
// not depend on the card: 5 groups of 16 heads at mamba2-2.7b's and
// zamba2-2.7b's training shapes (32 chunks of 256, 80 heads).
//
// bf16: one block of two warpgroups on an SM (226 of the 227 KB of shared
// memory a block may take at P = 64, of which D^T of the six positions
// at C = 256, N = 128 is 96 KB; about 250 registers a thread). The
// warpgroups take a head's positions in
// turns (even and odd), so each owns the D^T of its positions and no sum
// races; when a head has an odd number of positions the last, a virtual
// one, goes to them in turns head by head.
// - Copies are TMA (cp.async.bulk.tensor) over 4-D tensor maps of the
//   given strides, so the model's (B, K, C, H, P) layout needs no
//   transpose: B_j and the row tiles of C once a block, x_j once a head
//   (16-column boxes, 32-byte swizzle, wgmma's layout, a head ahead),
//   and each warpgroup's dy or dst tiles as raw f32 rows into its own
//   stages of a ring, two tiles ahead, issued by one of its threads.
//   There is no producer warpgroup: with one, ptxas holds every thread to
//   168 registers (384 threads), and the consumers spilled 1.4 KB.
// - A warpgroup splits its f32 tile in place into bf16 hi + lo boxes of
//   the same layout, then:
//   G^T = x_j dy_i^T as SS wgmma (m64n64k16 over P, hi then lo);
//   the elementwise terms on the 32 accumulator values of a thread;
//   dx_j += M^T dy as RS wgmma, M^T's accumulator fragments split into
//   bf16 hi + lo as the A operand (hi hi, lo hi, hi lo);
//   dS^T added into the position's D^T in shared memory, the column sums
//   of G*M reduce-scattered over the warp's rows.
//   S^T = B_j C_i^T (SS wgmma, bf16 inputs, exact in f32) of a
//   warpgroup's real positions is formed once a block and kept in
//   registers; the virtual rows' S^T is B_j itself, read from shared
//   memory.
// - L below the diagonal is exp(cum_i - cum_i0) exp(cum_i0 - cum_j), i0
//   the row tile's first row: the first factor once a head (u, in the
//   head's vectors), the second once a tile and row, both at most 1; the
//   diagonal tile takes ex2 of the log2-scaled difference where i >= j.
// - One warp scans each head's a and dt into cum log2(e), dt, exp(cum_end
//   - cum) and u at the end of the head before, from a copy (cp.async)
//   issued a head ahead: a and dt come strided by H in the model's
//   layout.
// - At a head's end the two warpgroups meet (named barriers): the second
//   hands its dx_j partial through shared memory and the first adds it
//   and writes dx in bf16; the second writes ddt and the dcum partials.
// The f32 operands (dy, dst, M) go in as bf16 hi + lo pairs, which holds
// each product to about 2^-16 of its size; every sum is f32.
// f32 (the parity runs) takes the same decomposition on the CUDA cores
// (ssd_scan_bwd_tiles_f32: 256 threads, a 4 x 4 block of each 64 x 64
// tile a thread), exact to f32 rounding.
//
// What bounds it: at mamba2-2.7b's training shape (BK 32, H 80, C 256,
// P 64, N 128, bf16) the function must move x, dy, dst and dx (84 + 168 +
// 84 + 84 MB) and little else, 438 MB in all, 0.131 ms at 3.35 TB/s,
// against 43.8 GFLOP over the lower triangle (0.044 ms on the bf16 tensor
// cores): bytes bound it. This design reads each dy tile once for each
// column tile at or left of it and each dst tile once for every column
// tile (755 MB of tile copies), adds D's group partials (5 x 9.4 MB
// written and read again) and the part rows (10.5 MB), and runs 2.6
// times the bound's tensor work (hi + lo operands, whole 64 x 64
// diagonal tiles). A design with one block a (chunk, head) in 16 x 16
// blocks of mma.sync, every head's dS^T stored and summed by a kernel of
// its own, took 1.607 ms there on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 2d).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxChunk = 256;
constexpr int kT = 64;                      // rows and columns of a tile
constexpr int kMaxTiles = kMaxChunk / kT + 2;  // positions: C/64 + N/64
constexpr int kTargetBlocks = 528;          // 4 blocks an SM of an H100
constexpr float kLog2e = 1.4426950408889634f;

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
  float* Dws;        // (groups, BK, C, ld): D^T [j][i] of each group
  float* part;       // (BK, H, ntj, C): dcum partials of each column tile
  int BK, H, C, P, N;
  int ntj;           // column tiles, C / 64
  int nv;            // virtual row tiles, ceil(N / 64), or 0
  int groups;        // head groups
  int ld;            // row length of Dws: C + 64 nv
  int64_t x_sb, x_sh, x_sc;
  int64_t a_sb, a_sh, a_sc;
  int64_t d_sb, d_sh, d_sc;
  int64_t B_sb, B_sc;
  int64_t C_sb, C_sc;
  int64_t g_sb, g_sh, g_sc;  // dy
  int64_t s_sb, s_sh, s_sn;  // dst
  int64_t o_sb, o_sh, o_sc;  // dx
};

// head groups of a (BK, C, H) call: the fewest that leave kTargetBlocks
// blocks in the tiles kernel
int head_groups(long long BK, long long C, long long H) {
  const long long base = BK * (C / kT);
  long long G = (kTargetBlocks + base - 1) / base;
  if (G > H) G = H;
  return G < 1 ? 1 : (int)G;
}

// block b of the tiles kernels: its chunk, head group and column tile,
// the column tiles slowest, so that the longest (tile 0, C + N rows) run
// first over the whole grid
__device__ __forceinline__ void block_coords(const Args& g, int& bk, int& grp,
                                             int& jt) {
  const int b = blockIdx.x;
  const int per = g.BK * g.groups;
  jt = b / per;
  const int rest = b - jt * per;
  grp = rest % g.groups;
  bk = rest / g.groups;
}

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

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// cum = cumsum(a) of one (chunk, head), by one warp: lane l owns C / 32
// consecutive entries of a and dt (element strides as_, ds_). Writes cum
// (times `scale`), dt and exp(cum_end - cum) for c < C.
__device__ __forceinline__ void warp_scan(int C, const float* ap,
                                          int64_t as_, const float* dp,
                                          int64_t ds_, float scale,
                                          float* cum, float* dts, float* ev) {
  const int lane = threadIdx.x & 31;
  const int E = C / 32;
  float v[kMaxChunk / 32];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxChunk / 32; ++e)
    if (e < E) {
      run += ap[(int64_t)(lane * E + e) * as_];
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
      cum[c] = cv * scale;
      dts[c] = dp[(int64_t)c * ds_];
      ev[c] = expf(cend - cv);
    }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// ---- bf16: TMA + wgmma, two warpgroups ----
//
// Accumulator fragments of wgmma.m64nNk16 (g = lane / 4, tg = lane % 4,
// warp w of the warpgroup): x[4 nb + e] is row 16 w + g + 8 (e >> 1),
// column 8 nb + 2 tg + (e & 1). Rows are j (the block's column tile),
// columns i (a position's rows). A tile of bf16 is 16-column boxes of 64
// rows x 32 bytes, 32-byte swizzled (the 16-byte half of a row flips on
// bit 2 of the row), which wgmma reads K-major (sw32_desc(box, 16, 256))
// and N-major (sw32_desc(box + 16 rows, box size, 256)).

constexpr int kBox = kT * 32;              // one 16-column bf16 box
constexpr int kWarpgroups = 2;               // warpgroups
constexpr int kBf16Threads = 128 * kWarpgroups;
constexpr int kNS = kT / 2;                // accumulator values a thread

template <int P>
struct Layout {
  static constexpr int kXBufs = P == 128 ? 1 : 2;
  static constexpr int kStage = kT * P * 4;  // raw f32 tile = hi + lo boxes
  static constexpr int kStages = 65536 / kStage;  // 8, 4, 2
  static constexpr int kXTile = P / 16 * kBox;
  static constexpr int kVecs = 4 * kMaxChunk * 4;  // cum2, dt, e, u
  static constexpr int kD = 0;               // D^T of each position, f32
  static constexpr int kB = kD + kMaxTiles * kT * kT * 4;
  static constexpr int kX = kB + 8 * kBox;   // B_j: N / 16 boxes
  static constexpr int kRing = kX + kXBufs * kXTile;  // also C's tiles
  static constexpr int kXch = kRing + kStages * kStage;  // dx partial
  static constexpr int kVec = kXch + kT * 64 * 4;    // [2] heads' vectors
  static constexpr int kStaging = kVec + 2 * kVecs;  // the next a, dt
  static constexpr int kRs = kStaging + 2 * kMaxChunk * 4;  // [pos][w][64]
  static constexpr int kRow = kRs + kMaxTiles * 4 * kT * 4;  // [wg][2][64]
  static constexpr int kMisc = kRow + 2 * 2 * kT * 4;
  static constexpr int kBar = kMisc + 16;
  // B_j and C's tiles, x[2], the ring's stages [8]
  static constexpr int kBytes = kBar + 8 * 11;
  static_assert(kStages * kStage >= 4 * 8 * kBox, "C's tiles fit the ring");
};

// mbar_wait that traps (a launch failure the wrapper raises) instead of
// hanging the card if a phase never completes: 2^34 cycles, seconds
__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the rank-4 tensor maps of the tiles kernel: logical dims (inner, rows,
// heads, chunks); slot[d] is the map dimension that holds logical dim d
struct MapSlots {
  int8_t row, head, bk;
};

__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         MapSlots sl, uint32_t bar, int col,
                                         int row, int head, int bk) {
  auto at = [&](int m) {
    return sl.row == m ? row : sl.head == m ? head : bk;
  };
  tma_load_4d(dst, map, bar, col, at(1), at(2), at(3));
}

struct Maps {
  MapSlots x, b, c, dy, dst;
};

// G^T = x_j dy_i^T over P (async, committed): hi then lo
template <int P>
__device__ __forceinline__ void issue_g(float (&acc)[kNS], uint32_t xt,
                                        uint32_t hi, uint32_t lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    Wgmma<kT>::ss(acc, sw32_desc(xt + kk * kBox, 16, 256),
                  sw32_desc(hi + kk * kBox, 16, 256), kk > 0);
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    Wgmma<kT>::ss(acc, sw32_desc(xt + kk * kBox, 16, 256),
                  sw32_desc(lo + kk * kBox, 16, 256), 1);
  wgmma_commit();
}

// dx_j += M^T dy over the tile's rows (async, committed): hi hi, lo hi,
// hi lo
template <int P>
__device__ __forceinline__ void issue_dx(float (&dx)[P / 2],
                                         const uint32_t (&mh)[4][4],
                                         const uint32_t (&ml)[4][4],
                                         uint32_t hi, uint32_t lo) {
  wgmma_fence();
#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16) {
    const uint64_t dh = sw32_desc(hi + k16 * 16 * 32, kBox, 256);
    const uint64_t dl = sw32_desc(lo + k16 * 16 * 32, kBox, 256);
    Wgmma<P>::rs(dx, mh[k16], dh);
    Wgmma<P>::rs(dx, ml[k16], dh);
    Wgmma<P>::rs(dx, mh[k16], dl);
  }
  wgmma_commit();
}

// the raw f32 tile of stage `st` (rows x P, packed) as bf16 hi + lo boxes
// in the same bytes, rows >= nrows zero; by one warpgroup
template <int P>
__device__ __forceinline__ void split_tile(unsigned char* st, int nrows,
                                           int t, int bar_id) {
  constexpr int Q = P / 4;        // float4 a row
  constexpr int CH = kT * Q / 128;  // float4 a thread
  constexpr int kLo = P / 16 * kBox;
  const float4* raw = reinterpret_cast<const float4*>(st);
  float4 v[CH];
#pragma unroll
  for (int u = 0; u < CH; ++u) {
    const int e = t + 128 * u;
    v[u] = e / Q < nrows ? raw[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  named_sync(bar_id, 128);  // every read of the raw tile is done
#pragma unroll
  for (int u = 0; u < CH; ++u) {
    const int e = t + 128 * u;
    const int r = e / Q;
    const int col = 4 * (e - r * Q);
    const int w16 = col & 15;
    const int off = (col >> 4) * kBox + r * 32 +
                    ((((w16 >> 3) ^ (r >> 2)) & 1) << 4) + (w16 & 7) * 2;
    uint32_t h0, l0, h1, l1;
    split_f32(v[u].x, v[u].y, h0, l0);
    split_f32(v[u].z, v[u].w, h1, l1);
    *reinterpret_cast<uint2*>(st + off) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(st + kLo + off) = make_uint2(l0, l1);
  }
  fence_proxy_async();  // the boxes are read by wgmma (the async proxy)
  named_sync(bar_id, 128);
}

// (B[j][n], B[j][n + 1]) of the B_j tile in shared memory (n even, < N)
__device__ __forceinline__ float2 b_pair(const unsigned char* bs, int j,
                                         int n) {
  const int w16 = n & 15;
  const int off = (n >> 4) * kBox + j * 32 +
                  ((((w16 >> 3) ^ (j >> 2)) & 1) << 4) + (w16 & 7) * 2;
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(bs + off));
}

// What a warpgroup keeps a head: dx_j's fragments, and the row sums of
// G*S*L and G*M of the thread's rows j (16 w + g, + 8)
template <int P>
struct HeadSums {
  float dx[P / 2];
  float rowg[2], rowm[2];
};

// the kinds of a position: a row tile below the column tile, the one on
// it (the mask), a tile of virtual rows
enum { kBelow = 0, kDiagonal = 1, kVirtual = 2 };

// The elementwise terms of one position on the accumulator (G^T): M^T's
// fragments split into hi + lo, dS^T added into the position's D^T in
// shared memory (float4 k of thread t at [k][t], so that a warp's
// accesses are contiguous; stored on the group's first head), the row
// sums of G*S*L and G*M, and the column sums of G*M reduced over the
// warp's 16 rows into rs. kBelow and kDiagonal take S^T from s,
// kVirtual from B_j. L of a tile below is exp(cum_i - cum_i0)
// exp(cum_i0 - cum_j) with i0 its first row
// (both factors at most 1: u_i from the vectors, v_j once a tile), of
// the diagonal tile ex2 of the log2-scaled difference where i >= j (its
// exponent may be positive above, and inf * 0 is NaN), of the virtual
// rows exp(cum_end - cum_j).
template <int KIND>
__device__ __forceinline__ void elementwise(
    const float (&acc)[kNS], const float (&s)[kNS],
    const unsigned char* bs, const float* vec,
    const float (&cj)[2], const float (&dtj)[2], const float (&ej)[2],
    int it, int v, int N, int w, int lane, uint32_t (&mh)[4][4],
    uint32_t (&ml)[4][4], float (&rowg)[2], float (&rowm)[2], float* rs,
    float4* dpos, int t, bool first) {
  const int g8 = lane >> 2;
  const int tg = lane & 3;
  const int jl0 = 16 * w + g8;  // the thread's first local row j
  const float* cum2 = vec;
  const float* u = vec + 3 * kMaxChunk;
  float vj[2] = {0.f, 0.f}, ld[2] = {0.f, 0.f};
  float cols[4];  // column sums of G*M of a pair of column groups
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (KIND == kBelow) vj[r] = ex2(cum2[kT * it] - cj[r]);
    if constexpr (KIND == kVirtual) vj[r] = ej[r];
    ld[r] = vj[r] * dtj[r];
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int il = 8 * nb + 2 * tg;
    float2 ci = make_float2(0.f, 0.f);
    if constexpr (KIND == kBelow)
      ci = *reinterpret_cast<const float2*>(u + kT * it + il);
    if constexpr (KIND == kDiagonal)
      ci = *reinterpret_cast<const float2*>(cum2 + kT * it + il);
    float2 sp[2];
    if constexpr (KIND == kVirtual) {
      const int n = kT * v + il;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        sp[r] = n < N ? b_pair(bs, jl0 + 8 * r, n) : make_float2(0.f, 0.f);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        sp[r] = make_float2(s[4 * nb + 2 * r], s[4 * nb + 2 * r + 1]);
    }
    float* col = cols + 2 * (nb & 1);
    if ((nb & 1) == 0) cols[0] = cols[1] = cols[2] = cols[3] = 0.f;
    float ds[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float cb = b ? ci.y : ci.x;
        float L, Ld;
        if constexpr (KIND == kBelow) {
          L = cb * vj[r];
          Ld = cb * ld[r];
        } else if constexpr (KIND == kDiagonal) {
          L = il + b < jl0 + 8 * r ? 0.f : ex2(cb - cj[r]);
          Ld = L * dtj[r];
        } else {
          L = vj[r];
          Ld = ld[r];
        }
        const float gv = acc[4 * nb + 2 * r + b];
        const float sv = b ? sp[r].y : sp[r].x;
        const float gs = gv * sv;
        m[b] = sv * Ld;
        ds[2 * r + b] = gv * Ld;
        rowg[r] = fmaf(gs, L, rowg[r]);
        rowm[r] = fmaf(gs, Ld, rowm[r]);
        col[b] = fmaf(gs, Ld, col[b]);
      }
      split_f32(m[0], m[1], mh[nb >> 1][2 * (nb & 1) + r],
                ml[nb >> 1][2 * (nb & 1) + r]);
    }
    float4 d = make_float4(ds[0], ds[1], ds[2], ds[3]);
    if (!first) {
      const float4 o = dpos[nb * 128 + t];
      d.x += o.x, d.y += o.y, d.z += o.z, d.w += o.w;
    }
    dpos[nb * 128 + t] = d;
    if (nb & 1) {
      // the four sums of columns (nb - 1, nb) x (b = 0, 1) over the
      // warp's 16 rows, reduce-scattered over the 8 lanes of a column
      // group: g bit 2 picks the nb, bit 1 the b, bit 0 holds a copy
      const bool hi2 = g8 & 4, hi1 = g8 & 2;
      float keep0 = hi2 ? cols[2] : cols[0], keep1 = hi2 ? cols[3] : cols[1];
      keep0 += __shfl_xor_sync(0xffffffffu, hi2 ? cols[0] : cols[2], 16);
      keep1 += __shfl_xor_sync(0xffffffffu, hi2 ? cols[1] : cols[3], 16);
      float z = hi1 ? keep1 : keep0;
      z += __shfl_xor_sync(0xffffffffu, hi1 ? keep0 : keep1, 8);
      z += __shfl_xor_sync(0xffffffffu, z, 4);
      if ((g8 & 1) == 0)
        rs[8 * (nb - 1 + (hi2 ? 1 : 0)) + 2 * tg + (hi1 ? 1 : 0)] = z;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kBf16Threads, 1)
    ssd_scan_bwd_tiles(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmb,
                       const __grid_constant__ CUtensorMap tmc,
                       const __grid_constant__ CUtensorMap tmdy,
                       const __grid_constant__ CUtensorMap tmdst,
                       const Maps maps, const Args g) {
  using L = Layout<P>;
  using bf = __nv_bfloat16;
  extern __shared__ unsigned char tiles_smem_raw[];
  const uint32_t raw = smem_u32(tiles_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = tiles_smem_raw + (base - raw);
  const uint32_t bar_bc = base + L::kBar;
  const uint32_t bar_x = bar_bc + 8;
  const uint32_t bar_full = bar_x + 16;
  constexpr int SW = L::kStages / kWarpgroups;  // ring stages a warpgroup
  constexpr int XB = L::kXBufs;

  int bk, grp, jt;
  block_coords(g, bk, grp, jt);
  const int h0 = (int)((int64_t)grp * g.H / g.groups);
  const int hpb = (int)((int64_t)(grp + 1) * g.H / g.groups) - h0;
  const int nr = g.ntj - jt;          // real positions
  const int npos = nr + g.nv;         // positions a head
  const int NB = g.N / 16;            // 16-column boxes of B and C
  const int vrows = g.N < kT ? g.N : kT;  // rows of a virtual tile
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x - 128 * c;
  const int w = t >> 5;
  const int lane = t & 31;
  const int g8 = lane >> 2;
  const int tg = lane & 3;
  const int jl[2] = {16 * w + g8, 16 * w + g8 + 8};  // local rows j
  const unsigned char* bs = sm + L::kB;
  float* dsm = reinterpret_cast<float*>(sm + L::kD);
  float* rsm = reinterpret_cast<float*>(sm + L::kRs);
  float* rowv = reinterpret_cast<float*>(sm + L::kRow);
  float* xch = reinterpret_cast<float*>(sm + L::kXch);
  float* misc = reinterpret_cast<float*>(sm + L::kMisc);
  float* vecs = reinterpret_cast<float*>(sm + L::kVec);
  float* vec = vecs;  // the first head's
  // this warpgroup's positions a head: c, c + 2, ...; when a head has an
  // odd number of positions and the last is virtual (its S^T is B_j, in
  // shared memory), the last goes to the two warpgroups in turns, head by
  // head, which evens out their work
  const int mine = (npos - c + 1) / 2;
  const bool alt = (npos & 1) && g.nv > 0;
  const int ntiles = alt ? hpb / 2 * npos + (hpb & 1) * mine : hpb * mine;

  // x of head hh into its buffer (one thread)
  auto load_x = [&](int hh) {
    const int xb = hh % XB;
    mbar_expect_tx(bar_x + 8 * xb, L::kXTile);
    for (int kk = 0; kk < P / 16; ++kk)
      tma_tile(base + L::kX + xb * L::kXTile + kk * kBox, &tmx, maps.x,
               bar_x + 8 * xb, 16 * kk, kT * jt, h0 + hh, bk);
  };
  // this warpgroup's n-th tile (dy or dst rows) into its stage (one
  // thread)
  auto load_tile = [&](int n) {
    int hh, q;
    if (alt) {  // npos tiles a pair of heads, mine of them in the first
      const int pair = n / npos;
      const int r = n - pair * npos;
      hh = 2 * pair + (r >= mine);
      q = r >= mine ? r - mine : r;
    } else {
      hh = n / mine;
      q = n - hh * mine;
    }
    const int p = min(c + 2 * q, npos - 1);
    const int s = c * SW + n % SW;
    const uint32_t dst = base + L::kRing + s * L::kStage;
    if (p < nr) {
      mbar_expect_tx(bar_full + 8 * s, kT * P * 4);
      tma_tile(dst, &tmdy, maps.dy, bar_full + 8 * s, 0, kT * (jt + p),
               h0 + hh, bk);
    } else {
      mbar_expect_tx(bar_full + 8 * s, vrows * P * 4);
      tma_tile(dst, &tmdst, maps.dst, bar_full + 8 * s, 0, kT * (p - nr),
               h0 + hh, bk);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_bc, 1);
    for (int b = 0; b < XB; ++b) mbar_init(bar_x + 8 * b, 1);
    for (int s = 0; s < L::kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // B_j and the real row tiles of C (into the ring), x of the first
    // heads
    mbar_expect_tx(bar_bc, (1 + nr) * NB * kBox);
    for (int kb = 0; kb < NB; ++kb)
      tma_tile(base + L::kB + kb * kBox, &tmb, maps.b, bar_bc, 16 * kb,
               kT * jt, 0, bk);
    for (int p = 0; p < nr; ++p)
      for (int kb = 0; kb < NB; ++kb)
        tma_tile(base + L::kRing + (p * NB + kb) * kBox, &tmc, maps.c,
                 bar_bc, 16 * kb, kT * (jt + p), 0, bk);
    for (int hh = 0; hh < XB && hh < hpb; ++hh) load_x(hh);
  }
  // one warp (the second of the second warpgroup) scans each head's a
  // and dt into cum log2(e), dt, exp(cum_end - cum) and u = exp(cum -
  // cum at the start of its row tile), a head ahead, into the vectors of
  // the head's parity; the a and dt it scans wait in the staging
  // (cp.async), issued a head before that
  float* stg = reinterpret_cast<float*>(sm + L::kStaging);
  const bool scanner = c == 1 && w == 1;
  auto vectors = [&](int64_t h, bool staged, float* vec) {
    if (staged) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      warp_scan(g.C, stg, 1, stg + kMaxChunk, 1, kLog2e, vec,
                vec + kMaxChunk, vec + 2 * kMaxChunk);
    } else {
      warp_scan(g.C, g.a + bk * g.a_sb + h * g.a_sh, g.a_sc,
                g.dt + bk * g.d_sb + h * g.d_sh, g.d_sc, kLog2e, vec,
                vec + kMaxChunk, vec + 2 * kMaxChunk);
    }
    __syncwarp();
    for (int i = lane; i < g.C; i += 32)
      vec[3 * kMaxChunk + i] = ex2(vec[i] - vec[i & ~(kT - 1)]);
  };
  auto stage = [&](int64_t h) {
    const float* ap = g.a + bk * g.a_sb + h * g.a_sh;
    const float* dp = g.dt + bk * g.d_sb + h * g.d_sh;
    for (int i = lane; i < g.C; i += 32) {
      cp_async4(smem_u32(stg + i), ap + (int64_t)i * g.a_sc);
      cp_async4(smem_u32(stg + kMaxChunk + i), dp + (int64_t)i * g.d_sc);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (scanner) {
    vectors(h0, false, vec);
    if (hpb > 1) stage(h0 + 1);
  }

  // S^T = B_j C_i^T of this warpgroup's real positions (c, c + 2)
  float sreg[2][kNS];
  wait_bar(bar_bc, 0);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = c + 2 * q;
    if (p < nr) {
      wgmma_fence();
      for (int kb = 0; kb < NB; ++kb)
        Wgmma<kT>::ss(sreg[q], sw32_desc(base + L::kB + kb * kBox, 16, 256),
                      sw32_desc(base + L::kRing + (p * NB + kb) * kBox, 16,
                                256),
                      kb > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sreg[q]);
    }
  }
  __syncthreads();  // C's tiles are read; the first head's vectors are in
  if (t == 0)
    for (int n = 0; n < SW && n < ntiles; ++n) load_tile(n);

  for (int hh = 0, n = 0; hh < hpb; ++hh) {
    const int h = h0 + hh;
    const int xb = hh % XB;
    const uint32_t xt = base + L::kX + xb * L::kXTile;
    float* vec = vecs + (hh & 1) * (L::kVecs / 4);
    if (scanner && hh + 1 < hpb) {  // the next head's, into the other half
      vectors(h + 1, true, vecs + ((hh + 1) & 1) * (L::kVecs / 4));
      if (hh + 2 < hpb) stage(h + 2);
    }
    HeadSums<P> hs;
#pragma unroll
    for (int i = 0; i < P / 2; ++i) hs.dx[i] = 0.f;
    hs.rowg[0] = hs.rowg[1] = hs.rowm[0] = hs.rowm[1] = 0.f;
    float cj[2], dtj[2], ej[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = kT * jt + jl[r];
      cj[r] = vec[j];
      dtj[r] = vec[kMaxChunk + j];
      ej[r] = vec[2 * kMaxChunk + j];
    }
    wait_bar(bar_x + 8 * xb, (hh / XB) & 1);

    const int count = alt && (hh & 1) ? npos - mine : mine;
#pragma unroll 1
    for (int q = 0; q < count; ++q) {
      const int p = min(c + 2 * q, npos - 1);
      const int s = c * SW + n % SW;
      const uint32_t hi = base + L::kRing + s * L::kStage;
      const uint32_t lo = hi + P / 16 * kBox;
      wait_bar(bar_full + 8 * s, (n / SW) & 1);
      split_tile<P>(sm + L::kRing + s * L::kStage, p < nr ? kT : vrows, t,
                    2 + c);
      float acc[kNS];
      issue_g<P>(acc, xt, hi, lo);
      wgmma_wait<0>();
      fence_regs(acc);
      uint32_t mh[4][4], ml[4][4];
      float* rs = rsm + (p * 4 + w) * kT;
      float4* dpos = reinterpret_cast<float4*>(dsm + p * kT * kT);
      if (p >= nr)
        elementwise<kVirtual>(acc, sreg[0], bs, vec, cj, dtj, ej, 0, p - nr,
                              g.N, w, lane, mh, ml, hs.rowg, hs.rowm, rs,
                              dpos, t, hh == 0);
      else if (p == 0)
        elementwise<kDiagonal>(acc, sreg[0], bs, vec, cj, dtj, ej, jt, 0,
                               g.N, w, lane, mh, ml, hs.rowg, hs.rowm, rs,
                               dpos, t, hh == 0);
      else if (q == 0)
        elementwise<kBelow>(acc, sreg[0], bs, vec, cj, dtj, ej, jt + p, 0,
                            g.N, w, lane, mh, ml, hs.rowg, hs.rowm, rs, dpos,
                            t, hh == 0);
      else
        elementwise<kBelow>(acc, sreg[1], bs, vec, cj, dtj, ej, jt + p, 0,
                            g.N, w, lane, mh, ml, hs.rowg, hs.rowm, rs, dpos,
                            t, hh == 0);
      issue_dx<P>(hs.dx, mh, ml, hi, lo);
      wgmma_wait<0>();
      fence_regs(hs.dx);
      fence_regs(mh);
      fence_regs(ml);
      named_sync(2 + c, 128);  // the stage is read: refill it
      if (t == 0 && n + SW < ntiles) load_tile(n + SW);
      ++n;
    }

    // ---- the head's end: the two warpgroups meet ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        hs.rowg[r] += __shfl_xor_sync(0xffffffffu, hs.rowg[r], off);
        hs.rowm[r] += __shfl_xor_sync(0xffffffffu, hs.rowm[r], off);
      }
      if (tg == 0) {
        rowv[(2 * c) * kT + jl[r]] = hs.rowg[r];
        rowv[(2 * c + 1) * kT + jl[r]] = hs.rowm[r];
      }
    }
    constexpr int kRounds = P > 64 ? P / 64 : 1;
    constexpr int kND = P / 8 / kRounds;  // column groups of 8 a round
#pragma unroll
    for (int rd = 0; rd < kRounds; ++rd) {
      if (c == 1) {
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          const int f = 4 * (rd * kND + nd);
          reinterpret_cast<float4*>(xch)[nd * 128 + t] = make_float4(
              hs.dx[f], hs.dx[f + 1], hs.dx[f + 2], hs.dx[f + 3]);
        }
      }
      named_sync(1, kBf16Threads);
      // x_j and the vectors of this head are no longer read
      if (rd == 0 && threadIdx.x == 0 && hh + XB < hpb) load_x(hh + XB);
      if (c == 0) {
        bf* out = static_cast<bf*>(g.dx) + bk * g.o_sb + (int64_t)h * g.o_sh;
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          const int f = 4 * (rd * kND + nd);
          const float4 o = reinterpret_cast<const float4*>(xch)[nd * 128 + t];
          const int p = 8 * (rd * kND + nd) + 2 * tg;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 v = r ? make_float2(hs.dx[f + 2] + o.z,
                                             hs.dx[f + 3] + o.w)
                               : make_float2(hs.dx[f] + o.x,
                                             hs.dx[f + 1] + o.y);
            *reinterpret_cast<uint32_t*>(
                out + (int64_t)(kT * jt + jl[r]) * g.o_sc + p) =
                pack_f32(v.x, v.y);
          }
        }
      } else if (rd == 0) {
        // ddt_j, and dcum's partial of this column tile: the column sums
        // of G*M over the tile's rows j, minus the row sums of the own
        // columns, plus the virtual rows' total at the chunk's last row
        if (w == 0) {
          float tot = 0.f;
          for (int p = nr; p < npos; ++p)
            for (int ww = 0; ww < 4; ++ww)
              for (int i = lane; i < kT; i += 32)
                tot += rsm[(p * 4 + ww) * kT + i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            tot += __shfl_xor_sync(0xffffffffu, tot, off);
          if (lane == 0) misc[0] = tot;
        }
        named_sync(3, 128);
        const int64_t unit = (int64_t)bk * g.H + h;
        if (t < kT)
          g.ddt[unit * g.C + kT * jt + t] = rowv[t] + rowv[2 * kT + t];
        float* part = g.part + (unit * g.ntj + jt) * g.C + kT * jt;
        for (int il = t; il < kT * nr; il += 128) {
          const int p = il / kT;
          const int ic = il - p * kT;
          float v = 0.f;
#pragma unroll
          for (int ww = 0; ww < 4; ++ww) v += rsm[(p * 4 + ww) * kT + ic];
          if (p == 0) v -= rowv[kT + ic] + rowv[3 * kT + ic];
          if (kT * jt + il == g.C - 1) v += misc[0];
          part[il] = v;
        }
      }
      named_sync(1, kBf16Threads);
    }
  }

  // D^T of this warpgroup's positions, the group's partial, into Dws
  float* dws = g.Dws + ((int64_t)grp * g.BK + bk) * g.C * g.ld;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int p = c + 2 * q;
    if (p < npos) {
      const float4* d4 = reinterpret_cast<const float4*>(dsm + p * kT * kT);
      const int i0 = p < nr ? kT * (jt + p) : g.C + kT * (p - nr);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float4 v = d4[nb * 128 + t];
        const int i = i0 + 8 * nb + 2 * tg;
        *reinterpret_cast<float2*>(dws + (int64_t)(kT * jt + jl[0]) * g.ld +
                                   i) = make_float2(v.x, v.y);
        *reinterpret_cast<float2*>(dws + (int64_t)(kT * jt + jl[1]) * g.ld +
                                   i) = make_float2(v.z, v.w);
      }
    }
  }
}

// ---- f32 on the CUDA cores ----
//
// 256 threads as 16 x 16: thread (ty, tx) owns rows j = 4 ty + a and
// columns i = 4 tx + b (a, b < 4) of every 64 x 64 tile in the transposed
// layout, and columns p = tx + 16 c of dx_j.

constexpr int kF32Threads = 256;
constexpr int kLD = kT + 4;

struct F32Layout {
  // floats
  static constexpr int kD = 0;                       // [pos][16][256]
  static constexpr int kXT = kMaxTiles * kT * kT;    // [P][kLD] x_j^T
  static constexpr int kYT = kXT + 128 * kLD;        // [P][kLD] dy_i^T
  static constexpr int kMs = kYT + 128 * kLD;        // [i][kLD] M^T
  static constexpr int kBT = kMs + kT * kLD;         // [32][kLD] B_j^T
  static constexpr int kCT = kBT + 32 * kLD;         // [32][kLD] C_i^T
  static constexpr int kVec = kCT + 32 * kLD;        // cum, dt, e
  static constexpr int kRs = kVec + 3 * kMaxChunk;   // [pos][8][64]
  static constexpr int kRow = kRs + kMaxTiles * 8 * kT;  // [2][64]
  static constexpr int kMisc = kRow + 2 * kT;
  static constexpr int kFloats = kMisc + 4;
};

template <int P>
__global__ void __launch_bounds__(kF32Threads, 1)
    ssd_scan_bwd_tiles_f32(const Args g) {
  using L = F32Layout;
  constexpr int PC = P / 16;
  extern __shared__ __align__(16) float fsm[];
  float* dsm = fsm + L::kD;
  float* xT = fsm + L::kXT;
  float* yT = fsm + L::kYT;
  float* ms = fsm + L::kMs;
  float* bT = fsm + L::kBT;
  float* cT = fsm + L::kCT;
  float* cum = fsm + L::kVec;
  float* dts = cum + kMaxChunk;
  float* ev = dts + kMaxChunk;
  float* rsm = fsm + L::kRs;
  float* rowv = fsm + L::kRow;
  float* misc = fsm + L::kMisc;

  int bk, grp, jt;
  block_coords(g, bk, grp, jt);
  const int h0 = (int)((int64_t)grp * g.H / g.groups);
  const int hpb = (int)((int64_t)(grp + 1) * g.H / g.groups) - h0;
  const int nr = g.ntj - jt;
  const int npos = nr + g.nv;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* Bb = static_cast<const float*>(g.Bm) + bk * g.B_sb;
  const float* Cb = static_cast<const float*>(g.Cm) + bk * g.C_sb;
  const int j0 = kT * jt;

  for (int hh = 0; hh < hpb; ++hh) {
    const int h = h0 + hh;
    __syncthreads();  // the previous head's readers are done
    const float* xb = static_cast<const float*>(g.x) + bk * g.x_sb +
                      (int64_t)h * g.x_sh;
    for (int e = tid; e < kT * P; e += kF32Threads) {
      const int r = e / P;
      const int p = e - r * P;
      xT[p * kLD + r] = xb[(int64_t)(j0 + r) * g.x_sc + p];
    }
    if (warp == 0)
      warp_scan(g.C, g.a + bk * g.a_sb + (int64_t)h * g.a_sh, g.a_sc,
                g.dt + bk * g.d_sb + (int64_t)h * g.d_sh, g.d_sc, 1.f,
                cum, dts, ev);
    __syncthreads();
    float dx[4][PC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < PC; ++q) dx[a][q] = 0.f;
    float rowg[4] = {0.f, 0.f, 0.f, 0.f}, rowm[4] = {0.f, 0.f, 0.f, 0.f};

    for (int p = 0; p < npos; ++p) {
      const bool real = p < nr;
      const int it = jt + p;
      const int v = p - nr;
      // the tile's rows of dy (or dst), transposed; rows past N zero
      const float* src;
      int64_t ld;
      int nrows = kT;
      if (real) {
        src = g.dy + bk * g.g_sb + (int64_t)h * g.g_sh +
              (int64_t)(kT * it) * g.g_sc;
        ld = g.g_sc;
      } else {
        src = g.dst + bk * g.s_sb + (int64_t)h * g.s_sh +
              (int64_t)(kT * v) * g.s_sn;
        ld = g.s_sn;
        nrows = min(kT, g.N - kT * v);
      }
      __syncthreads();  // the previous tile's readers of yT and ms are done
      for (int e = tid; e < kT * P; e += kF32Threads) {
        const int r = e / P;
        const int pp = e - r * P;
        yT[pp * kLD + r] = r < nrows ? src[r * ld + pp] : 0.f;
      }
      // S^T: B_j C_i^T over n in chunks of 32 (real), or B_j (virtual)
      float sv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sv[a][b] = 0.f;
      if (real) {
        for (int n0 = 0; n0 < g.N; n0 += 32) {
          const int nc = min(32, g.N - n0);
          __syncthreads();
          for (int e = tid; e < kT * nc; e += kF32Threads) {
            const int r = e / nc;
            const int n = e - r * nc;
            bT[n * kLD + r] = Bb[(int64_t)(j0 + r) * g.B_sc + n0 + n];
            cT[n * kLD + r] = Cb[(int64_t)(kT * it + r) * g.C_sc + n0 + n];
          }
          __syncthreads();
          for (int n = 0; n < nc; ++n) {
            const float4 bv = *reinterpret_cast<const float4*>(bT + n * kLD + 4 * ty);
            const float4 cv = *reinterpret_cast<const float4*>(cT + n * kLD + 4 * tx);
            const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
            const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) sv[a][b] = fmaf(b4[a], c4[b], sv[a][b]);
          }
        }
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int n = kT * v + 4 * tx + b;
            sv[a][b] = n < g.N ? Bb[(int64_t)(j0 + 4 * ty + a) * g.B_sc + n]
                               : 0.f;
          }
      }
      __syncthreads();  // yT is complete
      // G^T = x_j . dy_i over p
      float gt[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) gt[a][b] = 0.f;
      for (int pp = 0; pp < P; ++pp) {
        const float4 xv = *reinterpret_cast<const float4*>(xT + pp * kLD + 4 * ty);
        const float4 yv = *reinterpret_cast<const float4*>(yT + pp * kLD + 4 * tx);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
        const float y4[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) gt[a][b] = fmaf(x4[a], y4[b], gt[a][b]);
      }
      // the elementwise terms; exp only where i >= j
      float col[4] = {0.f, 0.f, 0.f, 0.f};
      float* dpos = dsm + p * kT * kT;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + 4 * ty + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float L;
          if (real) {
            const int i = kT * it + 4 * tx + b;
            L = i >= j ? expf(cum[i] - cum[j]) : 0.f;
          } else {
            L = ev[j];
          }
          const float sl = sv[a][b] * L;
          const float gsl = gt[a][b] * sl;
          const float gm = gsl * dts[j];
          rowg[a] += gsl;
          rowm[a] += gm;
          col[b] += gm;
          ms[(4 * tx + b) * kLD + 4 * ty + a] = sl * dts[j];
          const float ds = gt[a][b] * L * dts[j];
          float* d = dpos + (4 * a + b) * kF32Threads + tid;
          *d = hh == 0 ? ds : *d + ds;
        }
      }
      // the column sums of G*M over the tile's rows: ty pairs in a warp
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        col[b] += __shfl_xor_sync(0xffffffffu, col[b], 16);
        if (lane < 16) rsm[(p * 8 + warp) * kT + 4 * tx + b] = col[b];
      }
      __syncthreads();  // ms is complete
      // dx_j += M^T dy over the tile's rows i
      for (int i = 0; i < kT; ++i) {
        const float4 mv = *reinterpret_cast<const float4*>(ms + i * kLD + 4 * ty);
        const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int q = 0; q < PC; ++q) {
          const float y = yT[(tx + 16 * q) * kLD + i];
#pragma unroll
          for (int a = 0; a < 4; ++a) dx[a][q] = fmaf(m4[a], y, dx[a][q]);
        }
      }
    }

    // ---- the head's end ----
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        rowg[a] += __shfl_xor_sync(0xffffffffu, rowg[a], off);
        rowm[a] += __shfl_xor_sync(0xffffffffu, rowm[a], off);
      }
      if (tx == 0) {
        rowv[4 * ty + a] = rowg[a];
        rowv[kT + 4 * ty + a] = rowm[a];
      }
    }
    float* out = static_cast<float*>(g.dx) + bk * g.o_sb + (int64_t)h * g.o_sh;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < PC; ++q)
        out[(int64_t)(j0 + 4 * ty + a) * g.o_sc + tx + 16 * q] = dx[a][q];
    if (warp == 0) {
      float tot = 0.f;
      for (int p = nr; p < npos; ++p)
        for (int ww = 0; ww < 8; ++ww)
          for (int i = lane; i < kT; i += 32) tot += rsm[(p * 8 + ww) * kT + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tot += __shfl_xor_sync(0xffffffffu, tot, off);
      if (lane == 0) misc[0] = tot;
    }
    __syncthreads();
    const int64_t unit = (int64_t)bk * g.H + h;
    if (tid < kT) g.ddt[unit * g.C + j0 + tid] = rowv[tid];
    float* part = g.part + (unit * g.ntj + jt) * g.C + j0;
    for (int il = tid; il < kT * nr; il += kF32Threads) {
      const int p = il / kT;
      const int ic = il - p * kT;
      float v = 0.f;
      for (int ww = 0; ww < 8; ++ww) v += rsm[(p * 8 + ww) * kT + ic];
      if (p == 0) v -= rowv[kT + ic];
      if (j0 + il == g.C - 1) v += misc[0];
      part[il] = v;
    }
  }

  float* dws = g.Dws + ((int64_t)grp * g.BK + bk) * g.C * g.ld;
  for (int p = 0; p < npos; ++p) {
    const int i0 = p < nr ? kT * (jt + p) : g.C + kT * (p - nr);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        dws[(int64_t)(j0 + 4 * ty + a) * g.ld + i0 + 4 * tx + b] =
            dsm[p * kT * kT + (4 * a + b) * kF32Threads + tid];
  }
}

// ---- 2. dB = D^T C + D_virtual, dC = D B ----
// a block a 64-row tile of dB (kind 0: rows j) or dC (kind 1: rows i) of
// one chunk; D^T's 64 x 64 tiles summed over the groups in group order
// as they are read; 256 threads, rows 4 ty + a and columns tx + 16 c a
// thread
template <typename T>
__global__ void __launch_bounds__(256) ssd_scan_bwd_dbdc(const Args g) {
  __shared__ float xs[32][kLD];      // [k][r]
  __shared__ float ys[32][128 + 4];  // [k][n]
  const int tile = blockIdx.x;
  const int NC = g.N / 16;
  const int kind = blockIdx.y;
  const int64_t bk = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t gstride = (int64_t)g.BK * g.C * g.ld;
  const float* D = g.Dws + bk * g.C * g.ld;
  const T* Y = static_cast<const T*>(kind == 0 ? g.Cm : g.Bm) +
               bk * (kind == 0 ? g.C_sb : g.B_sb);
  const int64_t ysc = kind == 0 ? g.C_sc : g.B_sc;
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  // kind 0: k runs over i in row tiles tile..ntj-1; kind 1: over j in
  // column tiles 0..tile
  const int kt0 = kind == 0 ? tile : 0;
  const int kt1 = kind == 0 ? g.ntj : tile + 1;
  for (int kt = kt0; kt < kt1; ++kt) {
    for (int half = 0; half < 2; ++half) {
      const int k0 = kT * kt + 32 * half;
      __syncthreads();
      // 8 entries a thread, each group's 8 loads in flight together
      int ks[8], rs[8];
      int64_t at[8];
      float sum[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = tid + 256 * u;
        if (kind == 0) {  // xs[k][r] = D^T[j = row r][i = k]
          rs[u] = e >> 5;
          ks[u] = e & 31;
          at[u] = (int64_t)(kT * tile + rs[u]) * g.ld + k0 + ks[u];
        } else {          // xs[k][r] = D^T[j = k][i = row r]
          ks[u] = e >> 6;
          rs[u] = e & 63;
          at[u] = (int64_t)(k0 + ks[u]) * g.ld + kT * tile + rs[u];
        }
        sum[u] = 0.f;
      }
      for (int g0 = 0; g0 < g.groups; g0 += 4) {  // 32 loads in flight
        float part[4][8];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int u = 0; u < 8; ++u)
            part[k][u] = g0 + k < g.groups ? D[(g0 + k) * gstride + at[u]]
                                           : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int u = 0; u < 8; ++u) sum[u] += part[k][u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) xs[ks[u]][rs[u]] = sum[u];
      for (int e = tid; e < 32 * g.N; e += 256) {
        const int k = e / g.N;
        const int n = e - k * g.N;
        ys[k][n] = to_f32(Y[(int64_t)(k0 + k) * ysc + n]);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < 32; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < NC) {
            const float y = ys[k][tx + 16 * c];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(x4[a], y, acc[a][c]);
          }
      }
    }
  }
  T* out = static_cast<T*>(kind == 0 ? g.dB : g.dC) + bk * g.C * g.N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = kT * tile + 4 * ty + a;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = tx + 16 * c;
      if (c < NC) {
        float v = acc[a][c];
        if (kind == 0 && g.nv) {  // dB's states term: D^T's virtual rows
          float s = 0.f;
          for (int gr = 0; gr < g.groups; ++gr)
            s += D[gr * gstride + (int64_t)row * g.ld + g.C + n];
          v += s;
        }
        out[(int64_t)row * g.N + n] = from_f32<T>(v);
      }
    }
  }
}

// ---- 3. dcum from the column tiles' partials, da its reverse cumsum ----
// one warp a (chunk, head): lane l owns C / 32 consecutive entries
__global__ void __launch_bounds__(256) ssd_scan_bwd_da(const Args g) {
  const int64_t unit = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (unit >= (int64_t)g.BK * g.H) return;
  const int lane = threadIdx.x & 31;
  const int E = g.C / 32;
  const float* part = g.part + unit * g.ntj * g.C;
  float v[kMaxChunk / 32];
  float run = 0.f;
#pragma unroll
  for (int e = kMaxChunk / 32 - 1; e >= 0; --e)
    if (e < E) {
      const int c = lane * E + e;
      float d = 0.f;
      for (int jt = 0; jt <= c / kT; ++jt) d += part[jt * g.C + c];
      run += d;
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
    if (e < E) g.da[unit * g.C + lane * E + e] = v[e] + excl;
}

// ---- host side ----

template <typename T>
cudaError_t launch_finish(const Args& g, cudaStream_t stream) {
  ssd_scan_bwd_dbdc<T><<<dim3((unsigned)g.ntj, 2, (unsigned)g.BK), 256, 0,
                         stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t units = (int64_t)g.BK * g.H;
  ssd_scan_bwd_da<<<(unsigned)((units + 7) / 8), 256, 0, stream>>>(g);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_f32(const Args& g, cudaStream_t stream) {
  const size_t smem = F32Layout::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_tiles_f32<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_tiles_f32<P><<<(unsigned)(g.BK * g.groups * g.ntj),
                              kF32Threads, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finish<float>(g, stream);
}

// a rank-4 map of logical dims (inner, rows, heads, chunks) with element
// strides (rows, heads, chunks), the inner dim contiguous: dims of size 1
// go last with a packed stride, the others in order of their strides;
// box (box_inner, box_rows, 1, 1)
bool encode_tiles(CUtensorMap* map, MapSlots* sl, bool bf16, const void* ptr,
                  const int64_t (&size)[4], const int64_t (&stride)[4],
                  int box_inner, int box_rows, bool swizzle) {
  const int64_t e = bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  int order[3] = {1, 2, 3};
  auto key = [&](int d) {
    return size[d] == 1 ? INT64_MAX : stride[d];
  };
  for (int i = 1; i < 3; ++i)
    for (int k = i; k > 0 && key(order[k]) < key(order[k - 1]); --k) {
      const int tmp = order[k];
      order[k] = order[k - 1];
      order[k - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)size[0], 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)box_inner, 1, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  int8_t slot[4] = {0, 0, 0, 0};
  int64_t packed = (size[0] * e + 15) / 16 * 16;
  for (int m = 1; m < 4; ++m) {
    const int d = order[m - 1];
    slot[d] = (int8_t)m;
    dims[m] = (cuuint64_t)size[d];
    if (d == 1) box[m] = (cuuint32_t)box_rows;
    const int64_t sb = size[d] == 1 ? packed : stride[d] * e;
    if (sb <= 0 || sb % 16 != 0 || sb >= (int64_t(1) << 40)) return false;
    strides[m - 1] = (cuuint64_t)sb;
    packed = sb * size[d];
  }
  sl->row = slot[1];
  sl->head = slot[2];
  sl->bk = slot[3];
  EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int P>
cudaError_t launch_bf16(const Args& g, cudaStream_t stream) {
  // Once a thread and device: the shared-memory attribute (a runtime
  // call, which also makes the device's context current on this thread,
  // as cuTensorMapEncodeTiled needs: autograd runs a backward on a thread
  // of its own)
  const size_t smem = Layout<P>::kBytes + 1024;
  static thread_local int ready_on = -1;
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (ready_on != dev) {
    if ((err = cudaFuncSetAttribute(
             ssd_scan_bwd_tiles<P>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return err;
    ready_on = dev;
  }
  CUtensorMap tx, tb, tc, tdy, tdst;
  Maps maps;
  const int64_t xs[4] = {g.P, g.C, g.H, g.BK};
  const int64_t xst[4] = {1, g.x_sc, g.x_sh, g.x_sb};
  const int64_t bs[4] = {g.N, g.C, 1, g.BK};
  const int64_t bst[4] = {1, g.B_sc, g.N, g.B_sb};
  const int64_t cst[4] = {1, g.C_sc, g.N, g.C_sb};
  const int64_t yst[4] = {1, g.g_sc, g.g_sh, g.g_sb};
  const int64_t ss[4] = {g.P, g.N, g.H, g.BK};
  const int64_t sst[4] = {1, g.s_sn, g.s_sh, g.s_sb};
  const int vrows = g.N < kT ? g.N : kT;
  if (!encode_tiles(&tx, &maps.x, true, g.x, xs, xst, 16, kT, true) ||
      !encode_tiles(&tb, &maps.b, true, g.Bm, bs, bst, 16, kT, true) ||
      !encode_tiles(&tc, &maps.c, true, g.Cm, bs, cst, 16, kT, true) ||
      !encode_tiles(&tdy, &maps.dy, false, g.dy, xs, yst, g.P, kT, false))
    return cudaErrorInvalidValue;
  if (g.dst != nullptr) {
    if (!encode_tiles(&tdst, &maps.dst, false, g.dst, ss, sst, g.P, vrows,
                      false))
      return cudaErrorInvalidValue;
  } else {
    tdst = tdy;
    maps.dst = maps.dy;
  }
  ssd_scan_bwd_tiles<P><<<(unsigned)(g.BK * g.groups * g.ntj), kBf16Threads,
                          smem, stream>>>(tx, tb, tc, tdy, tdst, maps, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finish<__nv_bfloat16>(g, stream);
}

// the bf16 kernel's layouts: 16-byte aligned rows of x, B, C (as the
// forward takes them), dy and dst (f32) for its tensor maps, positive
// strides that are multiples of 16 bytes on every axis longer than 1;
// dx written two elements a store
bool bf16_ok(const Args& g) {
  auto fits = [](int64_t st, int64_t size, int64_t e) {
    return size == 1 || (st > 0 && st * e % 16 == 0);
  };
  if (!fits(g.x_sb, g.BK, 2) || !fits(g.x_sh, g.H, 2) ||
      !fits(g.x_sc, g.C, 2) || !fits(g.B_sb, g.BK, 2) ||
      !fits(g.B_sc, g.C, 2) || !fits(g.C_sb, g.BK, 2) ||
      !fits(g.C_sc, g.C, 2) || !fits(g.g_sb, g.BK, 4) ||
      !fits(g.g_sh, g.H, 4) || !fits(g.g_sc, g.C, 4))
    return false;
  if (g.dst != nullptr &&
      (!fits(g.s_sb, g.BK, 4) || !fits(g.s_sh, g.H, 4) ||
       !fits(g.s_sn, g.N, 4)))
    return false;
  if (reinterpret_cast<uintptr_t>(g.dx) % 4 != 0) return false;
  const int64_t out_strides[3] = {g.o_sb, g.o_sh, g.o_sc};
  for (int64_t st : out_strides)
    if (st % 2 != 0) return false;
  return true;
}

}  // namespace

// Floats of workspace a call needs: D^T's partial of each head group and
// the dcum partials of each column tile.
extern "C" long long ssd_scan_bwd_workspace(long long BK, long long H,
                                            long long C, long long N,
                                            int has_dst) {
  const long long nv = has_dst ? (N + kT - 1) / kT : 0;
  return (long long)head_groups(BK, C, H) * BK * C * (C + kT * nv) +
         BK * H * (C / kT) * C;
}

// dims: BK, H, C, P, N, then the element strides x (bk, h, c), a (bk, h,
// c), dt (bk, h, c), B (bk, c), C (bk, c), dy (bk, h, c), dst (bk, h, n),
// dx (bk, h, c) (22 values). dtype of x, B, C, dx, dB and dC: 0 = f32,
// 1 = bf16. dst may be null (no states gradient). ws: the floats of
// ssd_scan_bwd_workspace. Takes C a multiple of 64 up to 256, N in {16,
// 32, 64, 128}, P in {32, 64, 128}; the last axis of every array
// contiguous. Three launches on `stream`. Returns the CUDA error of the
// launches; cudaErrorInvalidValue for a shape, or a bf16 layout, that no
// kernel takes.
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
  if (g.C < kT || g.C > kMaxChunk || g.C % kT != 0 || g.BK < 1 ||
      g.H < 1 || g.BK > 65535 || g.H > 65535 ||
      (g.N != 16 && g.N != 32 && g.N != 64 && g.N != 128) ||
      (g.P != 32 && g.P != 64 && g.P != 128))
    return (int)cudaErrorInvalidValue;
  g.ntj = g.C / kT;
  g.nv = dst ? (g.N + kT - 1) / kT : 0;
  g.groups = head_groups(g.BK, g.C, g.H);
  g.ld = g.C + kT * g.nv;
  g.Dws = ws;
  g.part = ws + (size_t)g.groups * g.BK * g.C * g.ld;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (g.P) {
      case 32: return (int)launch_f32<32>(g, s);
      case 64: return (int)launch_f32<64>(g, s);
      default: return (int)launch_f32<128>(g, s);
    }
  }
  if (dtype != 1 || !bf16_ok(g)) return (int)cudaErrorInvalidValue;
  switch (g.P) {
    case 32: return (int)launch_bf16<32>(g, s);
    case 64: return (int)launch_bf16<64>(g, s);
    default: return (int)launch_bf16<128>(g, s);
  }
}
