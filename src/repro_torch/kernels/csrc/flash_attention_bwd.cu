// The backward of flash attention on Hopper: dQ, dK and dV from q, k, v,
// the forward's output o, the output's gradient dO and the forward's
// per-row logsumexp.
//
// The reference trains its language models through XLA's autodiff of its
// plain attention (src/repro/models/layers.py attention_core); its Pallas
// kernel (src/repro/kernels/flash_attention.py flash_attention) has no
// backward. The port sends every attention on the card through its
// forward kernel (flash_attention.cu), so this kernel is that forward's
// gradient, and the port's counterpart of the reference's autodiff.
//
// For one (batch, head), query rows i and keys j, with s_ij = q_i.k_j *
// scale masked to -1e30 as the forward masks it (causal band, sliding
// window, q_offset, the sequence ends):
//   P_ij  = exp(s_ij - lse_i)             (recomputed, one tile at a time)
//   D_i   = sum_d dO_id O_id
//   dV_j  = sum_i P_ij dO_i
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i.
// A kv head's dK and dV sum over its H / Hkv query heads (GQA).
//
// Two launches (three for bf16 when a kv head's query heads are split
// over blocks), no float atomics, so every sum runs in one fixed order
// and a run repeats bit for bit:
// 1. dq kernel — a block owns a run of query rows of one head: it
//    computes D_i (written out for launch 2), then loops over the key
//    tiles the mask leaves, recomputing S and dP, and writes dQ once.
// 2. dkdv kernel — a block owns a run of keys of one kv head and loops
//    over the query tiles the mask leaves, of all its query heads in turn
//    (f32), or of a group of them (bf16); with more than one group a
//    third kernel sums the groups' f32 partials in head order.
// Each recomputes the scores it needs: 7 products of the forward's size
// instead of FlashAttention-2's 5, the price of no float atomics across
// blocks. Rows with no valid key at all (only a window shorter than a
// row's distance past the last key makes one; the models never do) are
// outside what the forward matches, and so here too.
//
// What bounds it: at the qwen2-0.5b training shape (4 x 2048 tokens, 14
// query and 2 kv heads of 64, bf16, causal) the five products the
// gradient needs are 75.2 GFLOP (0.076 ms at the bf16 tensor-core peak)
// against 67.6 MB of inputs and outputs (0.020 ms): operations bound it,
// and only wgmma reaches Hopper's tensor-core rate. So bf16 runs as the
// forward's bf16 kernel does (flash_attention.cu; the Hopper helpers
// are shared in hopper.cuh), warp-specialised:
// - a producer warpgroup (one thread of it; setmaxnreg gives its
//   registers to the consumers: 24 against 240) issues every copy with
//   cp.async.bulk.tensor over the forward's 4-D tensor maps of the
//   (B, S, H, D) strides, into a ring of stages guarded by mbarriers;
// - two consumer warpgroups run wgmma, 64 of the block's 128 own rows
//   each, on the 64-row tiles the producer streams.
// Every tile arrives once, in 16-column boxes with the 32-byte swizzle,
// and serves both of its products: a box is wgmma's K-major operand over
// D (the score products) and its N-major operand with D as N (the
// accumulating products), as the forward's v tile is.
// - dq kernel: own q and dO, streamed k and v. S = Q K^T and dP = dO V^T
//   as SS wgmma into f32 registers; P and dS formed there (exp2 of one
//   FMA a score, the log2-domain logsumexp); dS rounded once to bf16
//   into the A-register fragment layout; dQ += dS K as RS wgmma.
// - dkdv kernel: own k and v, streamed q, dO and the rows' (lse, D_i)
//   that launch 1 wrote. S^T = K Q^T and dP^T = V dO^T (SS); P^T and
//   dS^T in registers, each rounded once to bf16; dV += P^T dO and
//   dK += dS^T Q (RS).
// P and dS are rounded to bf16 exactly once, before their second
// product, as the plain bf16 attention rounds its probabilities; every
// sum is f32. Masks are evaluated only on tiles that cut the causal
// band, the window or a sequence end. Blocks of the longest causal runs
// start first. The kv head's query heads go to one dkdv block when that
// still leaves 4 blocks an SM; otherwise they are split into groups
// whose f32 partials the third kernel sums in head order.
// f32 runs on the CUDA cores (256 threads, a 4 x 4 block of each 64 x 64
// tile a thread), exact to f32 rounding, for the parity checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr int kT = 64;  // query rows and keys of a tile (f32)
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;     // dO
  const float* lse;  // (B, H, Sq)
  // D_i: (B, H, Sq) f32 written by launch 1 (f32); bf16: (B * H, 2,
  // Sq_pad), each row's lse in log2 units, then its D_i
  float* delta;
  void* dq;          // (B, Sq, H, D) contiguous
  void* dk;          // (B, Sk, Hkv, D) contiguous
  void* dv;          // (B, Sk, Hkv, D) contiguous
  int B, H, Hkv, Sq, Sk, D;
  int causal, window, q_offset;
  int Sq_pad;        // Sq rounded up to the dq kernel's rows a block
  float scale;
  // element strides of (batch, seq, head); the last axis is contiguous
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh, g_sb, g_ss, g_sh;
};

// the forward's mask: query row `row`, key `key`
__device__ __forceinline__ bool allowed(const BwdArgs& a, int row, int key) {
  if (row >= a.Sq || key >= a.Sk) return false;
  const int qpos = a.q_offset + row;
  if (a.causal && qpos < key) return false;
  if (a.window > 0 && qpos - key >= a.window) return false;
  return true;
}

// tiles [begin, end) of bk keys holding a valid key for some row of the
// nrows query rows at q0 (the forward's loop bounds)
__device__ __forceinline__ void key_tiles(const BwdArgs& a, int q0, int nrows,
                                          int bk, int& begin, int& end) {
  const int rows = min(nrows, a.Sq - q0);
  const int qpos_lo = a.q_offset + q0;
  const int qpos_hi = qpos_lo + rows - 1;
  begin = 0;
  end = (a.Sk + bk - 1) / bk;
  if (a.causal) end = min(end, qpos_hi / bk + 1);
  if (a.window > 0 && qpos_lo - a.window + 1 > 0)
    begin = min(end, (qpos_lo - a.window + 1) / bk);
}

// tiles [begin, end) of bq query rows holding a valid row for some key
// of the nkeys keys at k0
__device__ __forceinline__ void query_tiles(const BwdArgs& a, int k0,
                                            int nkeys, int bq, int& begin,
                                            int& end) {
  const int nq = (a.Sq + bq - 1) / bq;
  begin = 0;
  end = nq;
  // causal: a row sees key k0 once q_offset + row >= k0
  if (a.causal && k0 - a.q_offset > 0) begin = min(nq, (k0 - a.q_offset) / bq);
  // window: row q still sees key k0 + nkeys - 1 while
  // q_offset + q - (k0 + nkeys - 1) < window
  if (a.window > 0) {
    const int last = a.window + k0 + nkeys - 2 - a.q_offset;  // largest q
    end = last < 0 ? 0 : min(nq, last / bq + 1);
  }
  if (begin > end) begin = end;
}

// ---- f32 on the CUDA cores ----
//
// 256 threads as 16 x 16: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of a
// tile's 64 x 64 products and its columns 4 tx .. 4 tx + 3; the rows' sums
// over the head size keep column tx + 16 c of each of the 4 rows.

constexpr int kThreads = 256;
constexpr int kLD = kT + 4;  // leading dimension of the transposed tiles

// dst[d * kLD + r] = src row r (of `rows` valid), column d, as f32
__device__ __forceinline__ void load_t(float* dst, const float* src,
                                       int64_t ss, int r0, int nrows, int D) {
  for (int e = threadIdx.x; e < kT * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    dst[d * kLD + r] = r0 + r < nrows ? src[(int64_t)(r0 + r) * ss + d] : 0.f;
  }
}

// s[i][j] = sum_d at[d][4 ty + i] bt[d][4 tx + j] over transposed tiles
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* at,
                                         const float* bt, int D, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(at + d * kLD + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(bt + d * kLD + tx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_f32(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* qt = smem;           // [D][kLD] q tile, transposed
  float* gt = qt + D * kLD;   // [D][kLD] dO tile, transposed
  float* kt_ = gt + D * kLD;  // [D][kLD] k tile, transposed
  float* vt = kt_ + D * kLD;  // [D][kLD] v tile, transposed
  float* dst = vt + D * kLD;  // [kT][kLD] dS, transposed ([key][row])

  const int nq = (a.Sq + kT - 1) / kT;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kT;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* gp = static_cast<const float*>(a.g) + b * a.g_sb + h * a.g_sh;
  const float* op = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int64_t rowbase = ((int64_t)b * a.H + h) * a.Sq;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_t(qt, qp, a.q_ss, q0, a.Sq, D);
  load_t(gt, gp, a.g_ss, q0, a.Sq, D);

  // D_i = rowsum(dO o) and lse_i of the thread's 4 rows (a half-warp a
  // row group), D_i written for the dkdv launch
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float acc = 0.f;
    if (row < a.Sq)
      for (int d = tx; d < D; d += 16)
        acc = fmaf(gp[(int64_t)row * a.g_ss + d], op[(int64_t)row * a.o_ss + d],
                   acc);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    dl[i] = acc;
    lse[i] = row < a.Sq ? a.lse[rowbase + row] : 0.f;
    if (row < a.Sq && tx == 0) a.delta[rowbase + row] = acc;
  }

  int kt_begin, kt_end;
  key_tiles(a, q0, kT, kT, kt_begin, kt_end);
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int t = kt_begin; t < kt_end; ++t) {
    const int k0 = t * kT;
    __syncthreads();  // the previous tile's readers are done
    load_t(kt_, kp, a.k_ss, k0, a.Sk, D);
    load_t(vt, vp, a.v_ss, k0, a.Sk, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(s, qt, kt_, D, ty, tx);
    tile_dot(dp, gt, vt, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = allowed(a, row, k0 + tx * 4 + j)
                            ? expf(s[i][j] * a.scale - lse[i])
                            : 0.f;
        s[i][j] = p * (dp[i][j] - dl[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + (tx * 4 + j) * kLD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(dst + j * kLD + ty * 4);
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float kv = kt_[col * kLD + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(xv[i], kv, acc[i][c]);
        }
      }
    }
  }

  float* dqp = static_cast<float*>(a.dq) + ((int64_t)b * a.Sq * a.H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < a.Sq) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) dqp[(int64_t)row * a.H * D + col] = acc[i][c] * a.scale;
      }
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_f32(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* kt_ = smem;          // [D][kLD] k tile, transposed ([d][key])
  float* vt = kt_ + D * kLD;  // [D][kLD] v tile, transposed
  float* qt = vt + D * kLD;   // [D][kLD] q tile, transposed ([d][row])
  float* gt = qt + D * kLD;   // [D][kLD] dO tile, transposed
  float* pt = gt + D * kLD;   // [kT][kLD] P^T by row: [row][key]
  float* dst = pt + kT * kLD; // [kT][kLD] dS^T by row: [row][key]
  float* lse_s = dst + kT * kLD;  // [kT]
  float* dl_s = lse_s + kT;       // [kT]

  const int k0 = blockIdx.x * kT;  // the causal band's longest first
  const int b = blockIdx.y / a.Hkv;
  const int hk = blockIdx.y - b * a.Hkv;
  const int G = a.H / a.Hkv;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_t(kt_, kp, a.k_ss, k0, a.Sk, D);
  load_t(vt, vp, a.v_ss, k0, a.Sk, D);
  int qt_begin, qt_end;
  query_tiles(a, k0, kT, kT, qt_begin, qt_end);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* gp = static_cast<const float*>(a.g) + b * a.g_sb + h * a.g_sh;
    const int64_t rowbase = ((int64_t)b * a.H + h) * a.Sq;
    for (int t = qt_begin; t < qt_end; ++t) {
      const int q0 = t * kT;
      __syncthreads();  // the previous tile's readers are done
      load_t(qt, qp, a.q_ss, q0, a.Sq, D);
      load_t(gt, gp, a.g_ss, q0, a.Sq, D);
      if (threadIdx.x < kT) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.Sq ? a.lse[rowbase + row] : 0.f;
        dl_s[threadIdx.x] = row < a.Sq ? a.delta[rowbase + row] : 0.f;
      }
      __syncthreads();
      // keys 4 ty + i against rows 4 tx + j
      float s[4][4], dp[4][4];
      tile_dot(s, kt_, qt, D, ty, tx);
      tile_dot(dp, vt, gt, D, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j;
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = allowed(a, q0 + r, k0 + ty * 4 + i)
                     ? expf(s[i][j] * a.scale - lse_s[r])
                     : 0.f;
          ds[i] = p[i] * (dp[i][j] - dl_s[r]);
        }
        *reinterpret_cast<float4*>(pt + r * kLD + ty * 4) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(dst + r * kLD + ty * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kT; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(pt + r * kLD + ty * 4);
        const float4 y = *reinterpret_cast<const float4*>(dst + r * kLD + ty * 4);
        const float pv[4] = {x.x, x.y, x.z, x.w};
        const float dv_[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = tx + 16 * c;
          if (col < D) {
            const float gv = gt[col * kLD + r];
            const float qv = qt[col * kLD + r];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv[i][c] = fmaf(pv[i], gv, dv[i][c]);
              dk[i][c] = fmaf(dv_[i], qv, dk[i][c]);
            }
          }
        }
      }
    }
  }

  const int64_t kstride = (int64_t)a.Hkv * D;
  float* dkp = static_cast<float*>(a.dk) + ((int64_t)b * a.Sk * a.Hkv + hk) * D;
  float* dvp = static_cast<float*>(a.dv) + ((int64_t)b * a.Sk * a.Hkv + hk) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key < a.Sk) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          dkp[(int64_t)key * kstride + col] = dk[i][c] * a.scale;
          dvp[(int64_t)key * kstride + col] = dv[i][c];
        }
      }
    }
  }
}

// ---- bf16 on Hopper's tensor cores: TMA + wgmma, warp-specialised ----
//
// Both kernels share one shape: a block owns kOwn = 128 rows of one side
// (query rows in the dq kernel, keys in the dkdv kernel), two consumer
// warpgroups take 64 of them each, and the producer streams kTile = 64
// rows of the other side a stage. Accumulator fragments of
// wgmma.m64nNk16 (g = lane / 4, tg = lane % 4, warp w of the
// warpgroup): x[4 nb + e] is row 16 w + g + 8 (e >> 1), column
// 8 nb + 2 tg + (e & 1); two adjacent column groups of a 64-wide
// accumulator, packed to bf16, are the A-register fragment of one
// 16-deep step, so the scores feed the accumulating products directly.

constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kBwdThreads = 128 * (kConsumers + 1);  // and the producer
// registers a thread after setmaxnreg: a sub-partition holds one warp of
// each warpgroup, and they share 504 of its 512 registers a lane
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kOwn = 64 * kConsumers;  // the block's own rows
constexpr int kTile = 64;              // rows of a streamed tile
constexpr int kStages = 2;             // ring depth of the streamed tiles
constexpr int kOwnBox = kOwn * 32;     // one 16-column box of an own tile
constexpr int kTileBox = kTile * 32;   // one 16-column box of a tile
constexpr int kNS = kTile / 2;         // scores a consumer thread holds
constexpr int kK16 = kTile / 16;       // 16-deep steps over a tile's rows

template <int DK>
struct BwdLayout {
  // own tiles, DK boxes each: q and dO (dq kernel), k and v (dkdv)
  static constexpr int kA = 0;
  static constexpr int kB = kA + DK * kOwnBox;
  // streamed tiles, stages x DK boxes each: k and v (dq), q and dO (dkdv)
  static constexpr int kX = kB + DK * kOwnBox;
  static constexpr int kY = kX + kStages * DK * kTileBox;
  // dkdv: stages x the tile rows' lse (log2 units) and D_i, f32
  static constexpr int kStat = kY + kStages * DK * kTileBox;
  static constexpr int kBar = kStat + kStages * 2 * kTile * 4;
  // own_full, x_full[stages], y_full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
};

// scores of the warpgroup's 64 own rows against a streamed tile (async):
// DK k-steps of m64n64k16, both operands K-major from their boxes
template <int DK>
__device__ __forceinline__ void issue_scores(float (&s)[kNS], uint32_t own,
                                             uint32_t tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    Wgmma<kTile>::ss(s, sw32_desc(own + kk * kOwnBox, 16, 256),
                     sw32_desc(tile + kk * kTileBox, 16, 256), kk > 0);
  wgmma_commit();
}

// acc += X T (async, not committed): X the 64 x kTile bf16 fragments in
// registers, T a streamed tile as the N-major operand (its rows the
// product's K, its D columns N: next 16 columns one box on)
template <int DK>
__device__ __forceinline__ void issue_acc(float (&acc)[8 * DK],
                                          const uint32_t (&x)[kK16][4],
                                          uint32_t tile) {
#pragma unroll
  for (int k16 = 0; k16 < kK16; ++k16)
    Wgmma<16 * DK>::rs(acc, x[k16],
                       sw32_desc(tile + k16 * 16 * 32, kTileBox, 256));
}

// f32 scores as the bf16 A fragments of kK16 16-deep steps, each value
// rounded once
__device__ __forceinline__ void to_frag(const float (&s)[kNS],
                                        uint32_t (&x)[kK16][4]) {
#pragma unroll
  for (int k16 = 0; k16 < kK16; ++k16)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[k16][j] = pack_f32(s[8 * k16 + 2 * j], s[8 * k16 + 2 * j + 1]);
}

__device__ __forceinline__ void init_barriers(uint32_t bar_own) {
  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_own + 8 + 8 * s, 1);                    // x_full
      mbar_init(bar_own + 8 + 8 * (kStages + s), 1);        // y_full
      mbar_init(bar_own + 8 + 8 * (2 * kStages + s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// dQ of kOwn query rows of one head, and each row's (lse, D_i) for the
// dkdv kernel. Grid (B * H, row blocks), the longest causal rows first.
template <int DK>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_attention_bwd_dq(const __grid_constant__ CUtensorMap tmq,
                           const __grid_constant__ CUtensorMap tmg,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv,
                           const BwdArgs a, const float scale_log2) {
  using L = BwdLayout<DK>;
  using bf = __nv_bfloat16;
  constexpr int D = 16 * DK;
  extern __shared__ unsigned char bwd_smem_raw[];
  // swizzled boxes want their 256-byte pattern aligned: align to 1024
  const uint32_t base = (smem_u32(bwd_smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + L::kBar;
  const uint32_t bar_x = bar_own + 8;
  const uint32_t bar_y = bar_x + 8 * kStages;
  const uint32_t bar_e = bar_y + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.Sq + kOwn - 1) / kOwn;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kOwn;
  int kt_begin, kt_end;
  key_tiles(a, q0, kOwn, kTile, kt_begin, kt_end);
  init_barriers(bar_own);

  if (threadIdx.x >= kConsumers * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_own, 2 * DK * kOwnBox);
      for (int kk = 0; kk < DK; ++kk) {
        tma_load_4d(base + L::kA + kk * kOwnBox, &tmq, bar_own, 16 * kk, h,
                    q0, b);
        tma_load_4d(base + L::kB + kk * kOwnBox, &tmg, bar_own, 16 * kk, h,
                    q0, b);
      }
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(bar_e + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_x + 8 * s, DK * kTileBox);
        for (int kk = 0; kk < DK; ++kk)
          tma_load_4d(base + L::kX + (s * DK + kk) * kTileBox, &tmk,
                      bar_x + 8 * s, 16 * kk, hk, kt * kTile, b);
        mbar_expect_tx(bar_y + 8 * s, DK * kTileBox);
        for (int kk = 0; kk < DK; ++kk)
          tma_load_4d(base + L::kY + (s * DK + kk) * kTileBox, &tmv,
                      bar_y + 8 * s, 16 * kk, hk, kt * kTile, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x - 128 * c;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int r0 = q0 + 64 * c + 16 * warp + g;  // and r0 + 8

  // D_i and lse_i (log2 units) of the thread's two rows: the quad of
  // threads sharing a row splits its 16-byte chunks; written out for
  // the dkdv kernel (zeros past Sq, up to Sq_pad)
  float lse2[2], dl[2];
  {
    const bf* gp = static_cast<const bf*>(a.g) + b * a.g_sb + h * a.g_sh;
    const bf* op = static_cast<const bf*>(a.o) + b * a.o_sb + h * a.o_sh;
    float* stat = a.delta + (int64_t)bh * 2 * a.Sq_pad;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      float acc = 0.f;
      if (row < a.Sq)
        for (int j = tg; j < 2 * DK; j += 4) {
          const uint4 gv = *reinterpret_cast<const uint4*>(
              gp + (int64_t)row * a.g_ss + 8 * j);
          const uint4 ov = *reinterpret_cast<const uint4*>(
              op + (int64_t)row * a.o_ss + 8 * j);
          const bf* gx = reinterpret_cast<const bf*>(&gv);
          const bf* ox = reinterpret_cast<const bf*>(&ov);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc = fmaf(__bfloat162float(gx[i]), __bfloat162float(ox[i]), acc);
        }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dl[r] = acc;
      lse2[r] = row < a.Sq ? a.lse[(int64_t)bh * a.Sq + row] * kLog2e : 0.f;
      if (tg == 0) {
        stat[row] = lse2[r];
        stat[a.Sq_pad + row] = acc;
      }
    }
  }

  const int wg_lo = a.q_offset + q0 + 64 * c;  // the warpgroup's first row
  const int qpos[2] = {a.q_offset + r0, a.q_offset + r0 + 8};
  float dq[8 * DK];
#pragma unroll
  for (int i = 0; i < 8 * DK; ++i) dq[i] = 0.f;
  const uint32_t q_own = base + L::kA + c * 64 * 32;
  const uint32_t g_own = base + L::kB + c * 64 * 32;

  mbar_wait(bar_own, 0);
  for (int it = 0; it < kt_end - kt_begin; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = (kt_begin + it) * kTile;
    const uint32_t k_tile = base + L::kX + s * DK * kTileBox;
    const uint32_t v_tile = base + L::kY + s * DK * kTileBox;
    float sc[kNS], dp[kNS];
    mbar_wait(bar_x + 8 * s, parity);
    issue_scores<DK>(sc, q_own, k_tile);  // S = Q K^T
    mbar_wait(bar_y + 8 * s, parity);
    issue_scores<DK>(dp, g_own, v_tile);  // dP = dO V^T
    wgmma_wait<1>();
    fence_regs(sc);
    // P = 2^(s scale log2(e) - lse log2(e)); masked scores give 0
#pragma unroll
    for (int i = 0; i < kNS; ++i)
      sc[i] = ex2(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]));
    const bool cut = k0 + kTile > a.Sk ||
                     (a.causal && k0 + kTile - 1 > wg_lo) ||
                     (a.window > 0 && wg_lo + 63 - k0 >= a.window);
    if (cut) {
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int qp = qpos[(i >> 1) & 1];
        const int key = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
        bool ok = key < a.Sk;
        if (a.causal) ok = ok && qp >= key;
        if (a.window > 0) ok = ok && qp - key < a.window;
        if (!ok) sc[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < kNS; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
    uint32_t ds[kK16][4];
    to_frag(dp, ds);
    wgmma_fence();
    issue_acc<DK>(dq, ds, k_tile);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(ds);
    mbar_arrive(bar_e + 8 * s);
  }

  bf* dqp = static_cast<bf*>(a.dq) + ((int64_t)b * a.Sq * a.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < a.Sq) {
      bf* out = dqp + (int64_t)row * a.H * D + 2 * tg;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<uint32_t*>(out + 8 * nd) =
            pack_f32(dq[4 * nd + 2 * r] * a.scale,
                     dq[4 * nd + 2 * r + 1] * a.scale);
    }
  }
}

// dK and dV of kOwn keys of one kv head from `hpb` of its query heads.
// Grid (B * Hkv * groups, key blocks), key block 0 (the longest causal
// run) first. With one group (`part` null) they go to dk and dv in bf16;
// with several, group j's f32 sums go to slot (b, key, hk * groups + j)
// of two (B, Sk, Hkv * groups, D) arrays in `part`.
template <int DK>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_attention_bwd_dkdv(const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             const __grid_constant__ CUtensorMap tmq,
                             const __grid_constant__ CUtensorMap tmg,
                             const BwdArgs a, const float scale_log2,
                             const int hpb, float* part) {
  using L = BwdLayout<DK>;
  using bf = __nv_bfloat16;
  constexpr int D = 16 * DK;
  extern __shared__ unsigned char bwd_smem_raw[];
  const uint32_t raw = smem_u32(bwd_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_own = base + L::kBar;
  const uint32_t bar_x = bar_own + 8;
  const uint32_t bar_y = bar_x + 8 * kStages;
  const uint32_t bar_e = bar_y + 8 * kStages;

  const int groups = a.H / a.Hkv / hpb;
  const int b = blockIdx.x / (a.Hkv * groups);
  const int hg = blockIdx.x - b * a.Hkv * groups;  // hk * groups + group
  const int hk = hg / groups;
  const int h0 = hk * (a.H / a.Hkv) + (hg - hk * groups) * hpb;
  const int k0 = blockIdx.y * kOwn;
  int qt_begin, qt_end;
  query_tiles(a, k0, kOwn, kTile, qt_begin, qt_end);
  const int nt = qt_end - qt_begin;  // tiles a head
  init_barriers(bar_own);

  if (threadIdx.x >= kConsumers * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_own, 2 * DK * kOwnBox);
      for (int kk = 0; kk < DK; ++kk) {
        tma_load_4d(base + L::kA + kk * kOwnBox, &tmk, bar_own, 16 * kk, hk,
                    k0, b);
        tma_load_4d(base + L::kB + kk * kOwnBox, &tmv, bar_own, 16 * kk, hk,
                    k0, b);
      }
      for (int it = 0; it < hpb * nt; ++it) {
        const int hh = it / nt;
        const int h = h0 + hh;
        const int q0 = (qt_begin + it - hh * nt) * kTile;
        const float* stat = a.delta + (int64_t)(b * a.H + h) * 2 * a.Sq_pad;
        const int s = it % kStages;
        const uint32_t st = base + L::kStat + s * 2 * kTile * 4;
        mbar_wait(bar_e + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_x + 8 * s, DK * kTileBox + kTile * 4);
        for (int kk = 0; kk < DK; ++kk)
          tma_load_4d(base + L::kX + (s * DK + kk) * kTileBox, &tmq,
                      bar_x + 8 * s, 16 * kk, h, q0, b);
        bulk_load(st, stat + q0, kTile * 4, bar_x + 8 * s);
        mbar_expect_tx(bar_y + 8 * s, DK * kTileBox + kTile * 4);
        for (int kk = 0; kk < DK; ++kk)
          tma_load_4d(base + L::kY + (s * DK + kk) * kTileBox, &tmg,
                      bar_y + 8 * s, 16 * kk, h, q0, b);
        bulk_load(st + kTile * 4, stat + a.Sq_pad + q0, kTile * 4,
                  bar_y + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x - 128 * c;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int kw = k0 + 64 * c;  // the warpgroup's first key
  const int keys[2] = {kw + 16 * warp + g, kw + 16 * warp + g + 8};
  const float* stats =
      reinterpret_cast<const float*>(bwd_smem_raw + (base - raw) + L::kStat);
  float dk[8 * DK], dv[8 * DK];
#pragma unroll
  for (int i = 0; i < 8 * DK; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_own = base + L::kA + c * 64 * 32;
  const uint32_t v_own = base + L::kB + c * 64 * 32;

  mbar_wait(bar_own, 0);
  for (int it = 0; it < hpb * nt; ++it) {
    const int hh = it / nt;
    const int q0 = (qt_begin + it - hh * nt) * kTile;
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const uint32_t q_tile = base + L::kX + s * DK * kTileBox;
    const uint32_t g_tile = base + L::kY + s * DK * kTileBox;
    const float* lse2 = stats + s * 2 * kTile + 2 * tg;
    const float* dl = lse2 + kTile;
    float st[kNS], dpt[kNS];
    mbar_wait(bar_x + 8 * s, parity);
    issue_scores<DK>(st, k_own, q_tile);  // S^T = K Q^T
    mbar_wait(bar_y + 8 * s, parity);
    issue_scores<DK>(dpt, v_own, g_tile);  // dP^T = V dO^T
    wgmma_wait<1>();
    fence_regs(st);
    // P^T: column 8 nb + 2 tg + (e & 1) is query row q0 + that
#pragma unroll
    for (int nb = 0; nb < kNS / 4; ++nb) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * nb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * nb + e] =
            ex2(fmaf(st[4 * nb + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
    }
    const bool cut = q0 + kTile > a.Sq || kw + 64 > a.Sk ||
                     (a.causal && a.q_offset + q0 < kw + 63) ||
                     (a.window > 0 &&
                      a.q_offset + q0 + kTile - 1 - kw >= a.window);
    if (cut) {
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int row = q0 + 8 * (i >> 2) + 2 * tg + (i & 1);
        const int key = keys[(i >> 1) & 1];
        const int qp = a.q_offset + row;
        bool ok = row < a.Sq && key < a.Sk;
        if (a.causal) ok = ok && qp >= key;
        if (a.window > 0) ok = ok && qp - key < a.window;
        if (!ok) st[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int nb = 0; nb < kNS / 4; ++nb) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * nb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * nb + e] = st[4 * nb + e] *
                          (dpt[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
    }
    uint32_t pf[kK16][4], dsf[kK16][4];
    to_frag(st, pf);
    to_frag(dpt, dsf);
    wgmma_fence();
    issue_acc<DK>(dv, pf, g_tile);   // dV += P^T dO
    issue_acc<DK>(dk, dsf, q_tile);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pf);
    fence_regs(dsf);
    mbar_arrive(bar_e + 8 * s);
  }

  const int hkg = a.Hkv * groups;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= a.Sk) continue;
    if (part == nullptr) {
      const int64_t at =
          (((int64_t)b * a.Sk + keys[r]) * a.Hkv + hk) * D + 2 * tg;
      bf* ko = static_cast<bf*>(a.dk) + at;
      bf* vo = static_cast<bf*>(a.dv) + at;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<uint32_t*>(ko + 8 * nd) =
            pack_f32(dk[4 * nd + 2 * r] * a.scale,
                     dk[4 * nd + 2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(vo + 8 * nd) =
            pack_f32(dv[4 * nd + 2 * r], dv[4 * nd + 2 * r + 1]);
      }
    } else {
      const int64_t at =
          (((int64_t)b * a.Sk + keys[r]) * hkg + hg) * D + 2 * tg;
      float* pk = part + at;
      float* pv = part + (int64_t)a.B * a.Sk * hkg * D + at;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<float2*>(pk + 8 * nd) =
            make_float2(dk[4 * nd + 2 * r] * a.scale,
                        dk[4 * nd + 2 * r + 1] * a.scale);
        *reinterpret_cast<float2*>(pv + 8 * nd) =
            make_float2(dv[4 * nd + 2 * r], dv[4 * nd + 2 * r + 1]);
      }
    }
  }
}

// dk and dv (bf16) as the sums, in head order, of the `groups` f32
// partials of each kv head: four elements of (B, Sk, Hkv, D) a thread
__global__ void __launch_bounds__(256)
    flash_attention_bwd_sum_heads(const BwdArgs a, const float* part,
                                  const int groups) {
  const int64_t n = (int64_t)a.B * a.Sk * a.Hkv * a.D / 4;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d4 = (int)(i % (a.D / 4));
  const int64_t bsk = i / (a.D / 4);  // (b * Sk + key) * Hkv + hk
  const float* pk = part + bsk * groups * a.D + 4 * d4;
  const float* pv = pk + (int64_t)a.B * a.Sk * a.Hkv * groups * a.D;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int j = 0; j < groups; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(pk + (int64_t)j * a.D);
    const float4 y = *reinterpret_cast<const float4*>(pv + (int64_t)j * a.D);
    sk = make_float4(sk.x + x.x, sk.y + x.y, sk.z + x.z, sk.w + x.w);
    sv = make_float4(sv.x + y.x, sv.y + y.y, sv.z + y.z, sv.w + y.w);
  }
  const int64_t at = bsk * a.D + 4 * d4;
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.dk) + at) =
      make_uint2(pack_f32(sk.x, sk.y), pack_f32(sk.z, sk.w));
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.dv) + at) =
      make_uint2(pack_f32(sv.x, sv.y), pack_f32(sv.z, sv.w));
}

// ---- host side ----

template <typename K, typename... X>
cudaError_t run(K kernel, dim3 grid, int threads, size_t smem,
                cudaStream_t stream, X... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch_f32(const BwdArgs& a, cudaStream_t stream) {
  const dim3 gq((unsigned)((a.Sq + kT - 1) / kT), (unsigned)(a.B * a.H));
  const dim3 gk((unsigned)((a.Sk + kT - 1) / kT), (unsigned)(a.B * a.Hkv));
  const size_t sq = (size_t)(4 * a.D * kLD + kT * kLD) * sizeof(float);
  const size_t sk =
      (size_t)(4 * a.D * kLD + 2 * kT * kLD + 2 * kT) * sizeof(float);
  cudaError_t err =
      run(flash_attention_bwd_dq_f32<DC>, gq, kThreads, sq, stream, a);
  if (err != cudaSuccess) return err;
  return run(flash_attention_bwd_dkdv_f32<DC>, gk, kThreads, sk, stream, a);
}

// query heads a dkdv block takes: all of its kv head's when that still
// leaves 4 blocks an SM (enough for the causal band's unequal blocks to
// even out), else the largest divisor of H / Hkv that does, else one
constexpr int kBlocksPerSm = 4;

int heads_per_block(const BwdArgs& a, int sms) {
  const int G = a.H / a.Hkv;
  const int64_t kblocks = (int64_t)a.B * a.Hkv * ((a.Sk + kOwn - 1) / kOwn);
  for (int hpb = G; hpb > 1; --hpb)
    if (G % hpb == 0 && kblocks * (G / hpb) >= kBlocksPerSm * sms) return hpb;
  return 1;
}

template <int DK>
cudaError_t launch_bf16(const BwdArgs& a, float* part, cudaStream_t stream) {
  // Once a thread and device: the shared-memory attributes (runtime
  // calls, which also make the device's context current on this thread,
  // as cuTensorMapEncodeTiled needs: autograd runs a backward on a
  // thread of its own) and the SM count.
  const size_t smem = BwdLayout<DK>::kBytes + 1024;
  static thread_local int ready_on = -1, sms = 0;
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (ready_on != dev) {
    if ((err = cudaFuncSetAttribute(
             flash_attention_bwd_dq<DK>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             flash_attention_bwd_dkdv<DK>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    ready_on = dev;
  }
  // the dq kernel's maps: q and dO in kOwn-row boxes, k and v in kTile;
  // the dkdv kernel's the other way round
  CUtensorMap q_own, g_own, k_tile, v_tile, k_own, v_own, q_tile, g_tile;
  if (!encode_bshd(&q_own, a.q, a.B, a.Sq, a.H, a.D, a.q_sb, a.q_ss, a.q_sh,
                   kOwn) ||
      !encode_bshd(&g_own, a.g, a.B, a.Sq, a.H, a.D, a.g_sb, a.g_ss, a.g_sh,
                   kOwn) ||
      !encode_bshd(&q_tile, a.q, a.B, a.Sq, a.H, a.D, a.q_sb, a.q_ss,
                   a.q_sh, kTile) ||
      !encode_bshd(&g_tile, a.g, a.B, a.Sq, a.H, a.D, a.g_sb, a.g_ss,
                   a.g_sh, kTile) ||
      !encode_bshd(&k_own, a.k, a.B, a.Sk, a.Hkv, a.D, a.k_sb, a.k_ss,
                   a.k_sh, kOwn) ||
      !encode_bshd(&v_own, a.v, a.B, a.Sk, a.Hkv, a.D, a.v_sb, a.v_ss,
                   a.v_sh, kOwn) ||
      !encode_bshd(&k_tile, a.k, a.B, a.Sk, a.Hkv, a.D, a.k_sb, a.k_ss,
                   a.k_sh, kTile) ||
      !encode_bshd(&v_tile, a.v, a.B, a.Sk, a.Hkv, a.D, a.v_sb, a.v_ss,
                   a.v_sh, kTile))
    return cudaErrorInvalidValue;
  const float scale_log2 = a.scale * kLog2e;
  const dim3 gq((unsigned)(a.B * a.H), (unsigned)((a.Sq + kOwn - 1) / kOwn));
  flash_attention_bwd_dq<DK><<<gq, kBwdThreads, smem, stream>>>(
      q_own, g_own, k_tile, v_tile, a, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hpb = heads_per_block(a, sms);
  const int groups = a.H / a.Hkv / hpb;
  float* p = groups == 1 ? nullptr : part;
  const dim3 gk((unsigned)(a.B * a.Hkv * groups),
                (unsigned)((a.Sk + kOwn - 1) / kOwn));
  flash_attention_bwd_dkdv<DK><<<gk, kBwdThreads, smem, stream>>>(
      k_own, v_own, q_tile, g_tile, a, scale_log2, hpb, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p == nullptr) return err;
  const int64_t n = (int64_t)a.B * a.Sk * a.Hkv * a.D / 4;
  flash_attention_bwd_sum_heads<<<(unsigned)((n + 255) / 256), 256, 0,
                                  stream>>>(a, p, groups);
  return cudaGetLastError();
}

cudaError_t launch(const BwdArgs& a, float* part, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    switch ((a.D + 15) / 16) {
      case 1: return launch_f32<1>(a, s);
      case 2: return launch_f32<2>(a, s);
      case 3: return launch_f32<3>(a, s);
      case 4: return launch_f32<4>(a, s);
      case 5: return launch_f32<5>(a, s);
      case 6: return launch_f32<6>(a, s);
      case 7: return launch_f32<7>(a, s);
      case 8: return launch_f32<8>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (a.D % 16 != 0) return cudaErrorInvalidValue;
  switch (a.D / 16) {
    case 1: return launch_bf16<1>(a, part, s);
    case 2: return launch_bf16<2>(a, part, s);
    case 3: return launch_bf16<3>(a, part, s);
    case 4: return launch_bf16<4>(a, part, s);
    case 5: return launch_bf16<5>(a, part, s);
    case 6: return launch_bf16<6>(a, part, s);
    case 7: return launch_bf16<7>(a, part, s);
    case 8: return launch_bf16<8>(a, part, s);
    default: return cudaErrorInvalidValue;
  }
}

// the layouts the bf16 kernel's tensor maps describe: D a multiple of
// 16, 16-byte aligned pointers, strides of the axes longer than 1
// positive multiples of 8 elements below 2^39 elements
bool bf16_ok(const BwdArgs& a) {
  if (a.D % 16 != 0) return false;
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.g, a.dq, a.dk, a.dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const int64_t strides[15] = {a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss,
                               a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.o_sb,
                               a.o_ss, a.o_sh, a.g_sb, a.g_ss, a.g_sh};
  const int sizes[15] = {a.B, a.Sq, a.H,  a.B, a.Sk, a.Hkv, a.B, a.Sk,
                         a.Hkv, a.B, a.Sq, a.H, a.B, a.Sq, a.H};
  for (int i = 0; i < 15; ++i) {
    if (sizes[i] == 1) continue;
    const int64_t st = strides[i];
    if (st <= 0 || st % 8 != 0 || st >= (int64_t(1) << 39)) return false;
  }
  return true;
}

}  // namespace

// The floats of f32 scratch `delta` that flash_attention_bwd_launch needs:
// each row's (lse, D_i), padded to the dQ kernel's blocks of kOwn rows.
extern "C" long long flash_attention_bwd_delta_floats(long long B,
                                                      long long H,
                                                      long long Sq) {
  return B * H * 2 * ((Sq + kOwn - 1) / kOwn * kOwn);
}

// dims: B, H, Hkv, Sq, Sk, D, causal, window, q_offset, then the element
// strides of (batch, seq, head) of q, k, v, o and dO, then delta's length
// in floats (25 values). lse is the forward's (B, H, Sq) f32 logsumexp;
// delta is f32 scratch of at least flash_attention_bwd_delta_floats
// floats, and a shorter one is refused; part, for
// bf16 with H > Hkv, 2 x (B, Sk, H, D) f32 scratch (else unused). dq
// (B, Sq, H, D) and dk, dv (B, Sk, Hkv, D) are contiguous, of the
// inputs' dtype: 0 = f32, 1 = bf16. Two or three launches on `stream`.
// Returns the CUDA error of the launches (0 on success);
// cudaErrorInvalidValue for a shape or a bf16 layout that the kernels do
// not take.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const float* lse,
                                          float* delta, float* part, void* dq,
                                          void* dk, void* dv,
                                          const long long* dims,
                                          int dtype, void* stream) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.g = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = (int)dims[0];
  a.H = (int)dims[1];
  a.Hkv = (int)dims[2];
  a.Sq = (int)dims[3];
  a.Sk = (int)dims[4];
  a.D = (int)dims[5];
  a.causal = (int)dims[6];
  a.window = (int)dims[7];
  a.q_offset = (int)dims[8];
  a.Sq_pad = (a.Sq + kOwn - 1) / kOwn * kOwn;
  int64_t* st[15] = {&a.q_sb, &a.q_ss, &a.q_sh, &a.k_sb, &a.k_ss,
                     &a.k_sh, &a.v_sb, &a.v_ss, &a.v_sh, &a.o_sb,
                     &a.o_ss, &a.o_sh, &a.g_sb, &a.g_ss, &a.g_sh};
  for (int i = 0; i < 15; ++i) *st[i] = dims[9 + i];
  // the forward's scale: the f32 rounding of 1/sqrt(D)
  a.scale = (float)(1.0 / sqrt((double)a.D));
  if (a.D < 1 || a.D > kMaxD || a.Hkv < 1 || a.H % a.Hkv != 0 ||
      a.Sq < 1 || a.Sk < 1 || a.q_offset < 0 || a.B * a.H > 65535 ||
      dims[24] < flash_attention_bwd_delta_floats(a.B, a.H, a.Sq))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !bf16_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && a.H != a.Hkv && part == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch(a, part, dtype, static_cast<cudaStream_t>(stream));
}
