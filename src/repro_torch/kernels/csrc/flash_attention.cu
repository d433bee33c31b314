// Flash attention on Hopper: online-softmax attention over tiles of keys.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (_kernel), reached through ops.flash_attention_bshd from
// the full-sequence forward (layers.attention_core). For one (batch, head)
// and query rows i: o_i = sum_j softmax_j(s_ij) v_j with s_ij = q_i.k_j /
// sqrt(D), masked to -1e30 outside the causal band, the sliding window and
// the sequence ends; query position = q_offset + i.
//
// What bounds it: two matrix products per key tile. At the Zamba2-2.7B
// prefill shape (batch*heads = 64, S = 4096, D = 80, bf16, causal) the
// causal band needs 4*BH*D*S(S+1)/2 = 171.8 GFLOP, 0.174 ms at the bf16
// tensor-core peak, against 168 MB of q, k, v and o (0.050 ms):
// operations bound it. So bf16 inputs run on Hopper's tensor cores with
// wgmma, fed by TMA from a producer warp (flash_attention_tma_kernel, the
// FlashAttention-3 structure; below). The tensor maps take a head size
// that is a multiple of 16 (at most 128), 16-byte aligned pointers and
// strides that are positive multiples of 8 elements; the launch of any
// other bf16 layout is refused. f32 inputs take the CUDA-core kernel
// (flash_attention_kernel), held to the f32 FMA rate (67 TFLOP/s) and
// exact to f32 rounding.
//
// Common to both kernels:
// - A block owns a run of query rows of one (batch, head) and loops over
//   key tiles in order, keeping the running max m, the sum l and the
//   output sums in f32 registers: the loop replaces the TPU's sequential
//   third grid axis. Blocks of the causal diagonal's far end (the most
//   tiles) are scheduled first.
// - Masking keeps the reference's semantics: masked scores are -1e30, and
//   a row whose first tiles are all masked takes exp(0) terms there that
//   the first valid tile's correction exp(-1e30 - m) clears. Key tiles
//   wholly above the diagonal or wholly outside the window, for every
//   row of the block, are skipped; that leaves every row with a valid
//   key unchanged.
// - Heads map to kv heads by h / (H / Hkv) (GQA), and q, k, v and o are
//   read and written through their strides, so the (B, S, H, D) layout of
//   the model needs no repeat or transpose.
// - Output o = acc / max(l, 1e-30), written in q's type (f32 or bf16,
//   round to nearest even).
//
// The CUDA-core kernel (f32 only, 256 threads, 64 query rows, 64-key
// tiles):
// - The q tile (transposed, [d][row]) stays in shared memory; each key
//   tile is staged as k transposed ([d][key]) and v ([key][d]).
// - S = Q K^T: each thread computes a 4x4 block of scores from float4
//   loads. Row max and row sum reduce over the 16 threads of a row (one
//   half-warp) with shuffles.
// - P V: probabilities go to shared memory transposed; each thread keeps
//   4 rows x ceil(D/16) columns (col = tx + 16c) of acc, so D need not be
//   a power of two (80 here; the sweep has 64 and 128).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block (CUDA-core kernel)
constexpr int kBK = 64;        // keys per tile (CUDA-core kernel)
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLD = kBQ + 4;   // leading dimension of the transposed tiles
constexpr int kMaxD = 128;     // largest head size taken
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) logsumexp of each query row, or null
  int B, H, Hkv, Sq, Sk, D;
  int causal, window, q_offset;
  float scale;
  // element strides of (batch, seq, head); the last axis is contiguous
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
};

template <int DC>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* qs = smem;              // [D][kLD]   q tile, transposed
  float* ks = qs + D * kLD;      // [D][kLD]   k tile, transposed
  float* vs = ks + D * kLD;      // [kBK][D]   v tile
  float* ps = vs + kBK * D;      // [kBK][kLD] probabilities, transposed

  const int nq = (a.Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const float* qp =
      static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp =
      static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp =
      static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = q0 + r;
    qs[d * kLD + r] =
        row < a.Sq ? qp[(int64_t)row * a.q_ss + d] : 0.f;
  }

  // key tiles that hold a valid key for some row of the block
  const int rows = min(kBQ, a.Sq - q0);
  const int qpos_lo = a.q_offset + q0;
  const int qpos_hi = qpos_lo + rows - 1;
  int kt_begin = 0;
  int kt_end = (a.Sk + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, qpos_hi / kBK + 1);
  if (a.window > 0 && qpos_lo - a.window + 1 > 0)
    kt_begin = (qpos_lo - a.window + 1) / kBK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < a.Sk) {
        kv = kp[(int64_t)key * a.k_ss + d];
        vv = vp[(int64_t)key * a.v_ss + d];
      }
      ks[d * kLD + j] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + d * kLD + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(ks + d * kLD + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const int qpos = a.q_offset + row;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool ok = kpos < a.Sk && row < a.Sq;
        if (a.causal) ok = ok && qpos >= kpos;
        if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * kLD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + j * kLD + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = vs[j * D + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < a.Sq) {
      const float den = fmaxf(l[i], 1e-30f);
      if (a.lse != nullptr && tx == 0)
        a.lse[((int64_t)b * a.H + h) * a.Sq + row] = m[i] + logf(l[i]);
      float* orow = op + (int64_t)row * a.o_ss;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) orow[col] = acc[i][c] / den;
      }
    }
  }
}

// ---- bf16 on Hopper's tensor cores: TMA + wgmma, warp-specialised ----
//
// One block owns 192 query rows of one (batch, head): three consumer
// warpgroups compute 64 of the rows each, and a producer warpgroup (one
// thread of it) issues every copy and gives its registers to the
// consumers (setmaxnreg: 32 against 160). The producer loads the q tile
// once and 64-key tiles of k and v into a kStages-deep ring with
// cp.async.bulk.tensor over 4-D tensor maps (D, heads, sequence, batch)
// built on the host from the (B, S, H, D) strides; the kv head of head h
// is the map's head coordinate h / (H / Hkv), so nothing is repeated or
// transposed, and rows past Sq or Sk arrive as zeros.
//
// A row is D = 16 DK bf16 (160 bytes at D = 80), more than the 128-byte
// box of the 128-byte swizzle. So each tile is loaded as DK boxes of 16
// columns (32 bytes a row) with the 32-byte swizzle: box kk holds exactly
// the 16-deep k-step kk of Q K^T, whose operands (q as A, k as B, both
// K-major) are wgmma's canonical 32-byte-swizzled K-major layout (8-row
// groups 256 bytes apart). For P V, v is the B operand with N = D: box
// kk holds output columns 16 kk .. 16 kk + 15, the N-major 32-byte-swizzled
// layout with the next 16 columns one box further (leading offset) and
// the next 8 keys 256 bytes further (stride offset).
//
// A consumer warpgroup per key tile:
// - S = Q K^T: DK wgmma.m64n64k16 from shared memory into 32 f32
//   registers a thread (two rows, 16 keys each);
// - online softmax in registers, in the log2 domain (log2(e) folded into
//   the scale, ex2.approx; one FMA and one exp a score on tiles that cut
//   no band); the reference's -1e30 sentinel, causal band, window and
//   q_offset, masks applied only on tiles that cut them;
// - P V: the score fragments are the A-operand layout of
//   wgmma.m64nDk16 with A in registers; P goes in as a bf16 pair hi + lo
//   (two products) because the reference multiplies p and v in f32 and
//   rounding p alone to bf16 moves an output by up to one bf16 step of its
//   size (past the 2e-2 tolerance at |o| >= 4);
// - then it releases the stage to the producer.
// The three consumer warpgroups interleave on the SM, so one's softmax
// runs under the others' products; at D = 80 three warpgroups on 64-key
// tiles measured faster on the H100 than two on 128-key tiles, and
// explicit turns between warpgroups, or issuing the next tile's Q K^T
// before this tile's softmax, slower (PERF.md, PR 14). Blocks of the
// longest causal rows start first (grid y reversed, every head of them
// before the next row block).

constexpr int kConsumers = 3;      // consumer warpgroups, 64 rows each
constexpr int kTmaThreads = 128 * (kConsumers + 1);  // and the producer
// registers a thread after setmaxnreg: a sub-partition holds one warp of
// each warpgroup, and they share 512 registers a lane (32 + 3 x 160)
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kTmaBQ = 64 * kConsumers;  // query rows a block
constexpr int kTmaBK = 64;         // keys a tile
constexpr int kTmaStages = 2;      // k/v ring depth
constexpr int kQBox = kTmaBQ * 32;  // one 16-column box of the q tile
constexpr int kBox = kTmaBK * 32;   // one 16-column box of a k or v tile
constexpr int kNS = kTmaBK / 2;     // scores a thread holds
constexpr int kK16 = kTmaBK / 16;   // 16-key steps of P V

template <int DK>
struct TmaLayout {
  static constexpr int kQ = 0;                               // DK boxes
  static constexpr int kK = kQ + DK * kQBox;                 // stages x DK
  static constexpr int kV = kK + kTmaStages * DK * kBox;     // stages x DK
  static constexpr int kBar = kV + kTmaStages * DK * kBox;
  // q_full, k_full[stages], v_full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kTmaStages);
};

// S = Q K^T of one tile (async): DK k-steps of m64n128k16, q and k from
// their 32-byte-swizzled boxes
template <int DK>
__device__ __forceinline__ void issue_qk(float (&sc)[kNS], uint32_t q_box,
                                         uint32_t k_box) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    Wgmma<kTmaBK>::ss(sc, sw32_desc(q_box + kk * kQBox, 16, 256),
                   sw32_desc(k_box + kk * kBox, 16, 256), kk > 0);
  wgmma_commit();
}

// o += P V of one tile (async): 8 key steps of m64nDk16, P from
// registers as hi + lo, v N-major (next 16 columns one box on)
template <int DK>
__device__ __forceinline__ void issue_pv(float (&o)[8 * DK],
                                         const uint32_t (&phi)[kK16][4],
                                         const uint32_t (&plo)[kK16][4],
                                         uint32_t v_box) {
  wgmma_fence();
#pragma unroll
  for (int k16 = 0; k16 < kK16; ++k16) {
    const uint64_t dv = sw32_desc(v_box + k16 * 16 * 32, kBox, 256);
    Wgmma<16 * DK>::rs(o, plo[k16], dv);
    Wgmma<16 * DK>::rs(o, phi[k16], dv);
  }
  wgmma_commit();
}

// the probabilities of one tile as the A fragments of its 8 16-key
// steps, bf16 hi + lo: sc[4 nb + e] is key 8 nb + 2 tg + (e & 1)
__device__ __forceinline__ void split_p(const float (&sc)[kNS],
                                        uint32_t (&phi)[kK16][4],
                                        uint32_t (&plo)[kK16][4]) {
#pragma unroll
  for (int k16 = 0; k16 < kK16; ++k16)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_f32(sc[8 * k16 + 2 * j], sc[8 * k16 + 2 * j + 1], phi[k16][j],
                plo[k16][j]);
}

// The online softmax of one consumer thread: its two rows' running max
// m (log2 domain) and sum l. run() turns a tile's raw scores into
// probabilities in place and returns the two rows' corrections for o.
struct Softmax {
  float m[2], l[2];
  float scale_log2;
  int row_pos;  // position of the thread's first row
  int wg_lo;    // position of the warpgroup's first row
  int tg, Sk, causal, window;

  __device__ __forceinline__ void init(const Args& a, int r0, int tg_,
                                       int wg_lo_, float scale_log2_) {
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    scale_log2 = scale_log2_;
    row_pos = a.q_offset + r0;
    wg_lo = wg_lo_;
    tg = tg_;
    Sk = a.Sk;
    causal = a.causal;
    window = a.window;
  }

  // A tile that cuts no row's band takes p = 2^(s scale - m) in one FMA;
  // a tile that does goes through the reference's -1e30 sentinel.
  __device__ __forceinline__ void run(float (&sc)[kNS], int k0,
                                      float (&corr)[2]) {
    const bool cut = k0 + kTmaBK > Sk || (causal && k0 + kTmaBK - 1 > wg_lo) ||
                     (window > 0 && wg_lo + 63 - k0 >= window);
    float rmax[2] = {kNegInf, kNegInf};
    if (cut) {
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int qpos = row_pos + 8 * ((i >> 1) & 1);
        const int kpos = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
        bool ok = kpos < Sk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        sc[i] = ok ? sc[i] * scale_log2 : kNegInf;
        rmax[(i >> 1) & 1] = fmaxf(rmax[(i >> 1) & 1], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kNS; ++i)
        rmax[(i >> 1) & 1] = fmaxf(rmax[(i >> 1) & 1], sc[i]);
      rmax[0] *= scale_log2;
      rmax[1] *= scale_log2;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
      const float m_new = fmaxf(m[r], rmax[r]);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    if (cut) {
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
        rsum[(i >> 1) & 1] += sc[i];
      }
    } else {
      const float nm[2] = {-m[0], -m[1]};
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, nm[(i >> 1) & 1]));
        rsum[(i >> 1) & 1] += sc[i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * corr[r] + rsum[r];
    }
  }
};

template <int DK>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_attention_tma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const Args a, const float scale_log2) {
  using L = TmaLayout<DK>;
  constexpr int D = 16 * DK;
  extern __shared__ unsigned char tma_smem_raw[];
  // swizzled boxes want their 256-byte pattern aligned: align to 1024
  const uint32_t raw = smem_u32(tma_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_k + 8 * kTmaStages;
  const uint32_t bar_e = bar_v + 8 * kTmaStages;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.Sq + kTmaBQ - 1) / kTmaBQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kTmaBQ;

  // key tiles that hold a valid key for some row of the block
  const int rows = min(kTmaBQ, a.Sq - q0);
  const int qpos_lo = a.q_offset + q0;
  const int qpos_hi = qpos_lo + rows - 1;
  int kt_begin = 0;
  int kt_end = (a.Sk + kTmaBK - 1) / kTmaBK;
  if (a.causal) kt_end = min(kt_end, qpos_hi / kTmaBK + 1);
  if (a.window > 0 && qpos_lo - a.window + 1 > 0)
    kt_begin = min(kt_end, (qpos_lo - a.window + 1) / kTmaBK);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // ---- producer: warpgroup 2, one thread; its registers go to the
    // consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, DK * kQBox);
      for (int kk = 0; kk < DK; ++kk)
        tma_load_4d(base + L::kQ + kk * kQBox, &tq, bar_q, 16 * kk, h, q0, b);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int s = it % kTmaStages;
        mbar_wait(bar_e + 8 * s, ((it / kTmaStages) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, DK * kBox);
        for (int kk = 0; kk < DK; ++kk)
          tma_load_4d(base + L::kK + (s * DK + kk) * kBox, &tk, bar_k + 8 * s,
                      16 * kk, hk, kt * kTmaBK, b);
        mbar_expect_tx(bar_v + 8 * s, DK * kBox);
        for (int kk = 0; kk < DK; ++kk)
          tma_load_4d(base + L::kV + (s * DK + kk) * kBox, &tv, bar_v + 8 * s,
                      16 * kk, hk, kt * kTmaBK, b);
      }
    }
  } else {
    // ---- consumers: rows q0 + 64 c .. q0 + 64 c + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128;
    const int t = threadIdx.x - 128 * c;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int r0 = q0 + 64 * c + 16 * warp + g;  // and r0 + 8
    Softmax sm;
    sm.init(a, r0, tg, a.q_offset + q0 + 64 * c, scale_log2);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const uint32_t q_box = base + L::kQ + c * 64 * 32;
    const uint32_t k_box = base + L::kK;
    const uint32_t v_box = base + L::kV;

    // Per tile: S = Q K^T, the softmax, P V. The consumer warpgroups
    // run this independently, so one's softmax can run under the others'
    // products.
    mbar_wait(bar_q, 0);
    for (int it = 0; it < kt_end - kt_begin; ++it) {
      const int s = it % kTmaStages;
      const uint32_t parity = (it / kTmaStages) & 1;
      float sc[kNS];
      mbar_wait(bar_k + 8 * s, parity);
      issue_qk<DK>(sc, q_box, k_box + s * DK * kBox);
      wgmma_wait_all();
      fence_regs(sc);
      float corr[2];
      sm.run(sc, (kt_begin + it) * kTmaBK, corr);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      uint32_t phi[kK16][4], plo[kK16][4];
      split_p(sc, phi, plo);
      mbar_wait(bar_v + 8 * s, parity);
      issue_pv<DK>(o, phi, plo, v_box + s * DK * kBox);
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(phi);
      fence_regs(plo);
      mbar_arrive(bar_e + 8 * s);
    }
    const float l[2] = {sm.l[0], sm.l[1]};
    // o = acc / max(l, 1e-30) in bf16: o[4 nd + e] is row r0 + 8 (e >> 1),
    // column 8 nd + 2 tg + (e & 1)
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                        h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < a.Sq) {
        const float den = fmaxf(l[r], 1e-30f);
        // the row's logsumexp in the natural base (m is in log2 units)
        if (a.lse != nullptr && tg == 0)
          a.lse[((int64_t)b * a.H + h) * a.Sq + row] =
              (sm.m[r] + log2f(l[r])) * 0.6931471805599453f;
        __nv_bfloat16* orow = op + (int64_t)row * a.o_ss + 2 * tg;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
          *reinterpret_cast<uint32_t*>(orow + 8 * nd) =
              pack_f32(o[4 * nd + 2 * r] / den, o[4 * nd + 2 * r + 1] / den);
      }
    }
  }
}

// ---- host side of the TMA kernel ----

template <int DK>
cudaError_t launch_tma_t(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, a.q, a.B, a.Sq, a.H, a.D, a.q_sb, a.q_ss, a.q_sh,
                   kTmaBQ) ||
      !encode_bshd(&tk, a.k, a.B, a.Sk, a.Hkv, a.D, a.k_sb, a.k_ss, a.k_sh,
                   kTmaBK) ||
      !encode_bshd(&tv, a.v, a.B, a.Sk, a.Hkv, a.D, a.v_sb, a.v_ss, a.v_sh,
                   kTmaBK))
    return cudaErrorInvalidValue;
  const int smem = TmaLayout<DK>::kBytes + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tma_kernel<DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.B * a.H),
                  (unsigned)((a.Sq + kTmaBQ - 1) / kTmaBQ));
  const float scale_log2 = a.scale * 1.4426950408889634f;
  flash_attention_tma_kernel<DK><<<grid, kTmaThreads, smem, stream>>>(
      tq, tk, tv, a, scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_tma(const Args& a, cudaStream_t stream) {
  switch (a.D / 16) {
    case 1: return launch_tma_t<1>(a, stream);
    case 2: return launch_tma_t<2>(a, stream);
    case 3: return launch_tma_t<3>(a, stream);
    case 4: return launch_tma_t<4>(a, stream);
    case 5: return launch_tma_t<5>(a, stream);
    case 6: return launch_tma_t<6>(a, stream);
    case 7: return launch_tma_t<7>(a, stream);
    case 8: return launch_tma_t<8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the layouts the tensor maps describe: D a multiple of 16, 16-byte
// aligned pointers, strides of the dimensions longer than 1 positive
// multiples of 8 elements (16 bytes) below 2^39 elements
bool tma_ok(const Args& a) {
  if (a.D % 16 != 0) return false;
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const int64_t strides[12] = {a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh,
                               a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh};
  const int sizes[12] = {a.B, a.Sq, a.H, a.B, a.Sk, a.Hkv,
                         a.B, a.Sk, a.Hkv, a.B, a.Sq, a.H};
  for (int i = 0; i < 12; ++i) {
    if (sizes[i] == 1) continue;
    const int64_t st = strides[i];
    if (st <= 0 || st % 8 != 0 || st >= (int64_t(1) << 39)) return false;
  }
  return true;
}

template <int DC>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  const int smem =
      (int)((2 * a.D * kLD + kBK * a.D + kBK * kLD) * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.Sq + kBQ - 1) / kBQ), (unsigned)(a.B * a.H));
  flash_attention_kernel<DC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch ((a.D + 15) / 16) {
    case 1: return launch_t<1>(a, stream);
    case 2: return launch_t<2>(a, stream);
    case 3: return launch_t<3>(a, stream);
    case 4: return launch_t<4>(a, stream);
    case 5: return launch_t<5>(a, stream);
    case 6: return launch_t<6>(a, stream);
    case 7: return launch_t<7>(a, stream);
    case 8: return launch_t<8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}


}  // namespace

// dims: B, H, Hkv, Sq, Sk, D, causal, window, q_offset, then the element
// strides of (batch, seq, head) of q, k, v and o (21 values).
// dtype: 0 = f32, 1 = bf16 (q, k, v and o alike). lse, when not null,
// receives each query row's logsumexp of its scaled, masked scores (f32,
// (B, H, Sq) contiguous), which the backward (flash_attention_bwd.cu)
// recomputes the probabilities from. Returns the CUDA error of the launch
// (0 on success); cudaErrorInvalidValue for a shape, or a bf16 layout,
// that no kernel takes.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const long long* dims, int dtype,
                                      void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.B = (int)dims[0];
  a.H = (int)dims[1];
  a.Hkv = (int)dims[2];
  a.Sq = (int)dims[3];
  a.Sk = (int)dims[4];
  a.D = (int)dims[5];
  a.causal = (int)dims[6];
  a.window = (int)dims[7];
  a.q_offset = (int)dims[8];
  a.q_sb = dims[9];
  a.q_ss = dims[10];
  a.q_sh = dims[11];
  a.k_sb = dims[12];
  a.k_ss = dims[13];
  a.k_sh = dims[14];
  a.v_sb = dims[15];
  a.v_ss = dims[16];
  a.v_sh = dims[17];
  a.o_sb = dims[18];
  a.o_ss = dims[19];
  a.o_sh = dims[20];
  // the reference multiplies f32 scores by the f32 rounding of 1/sqrt(D)
  a.scale = (float)(1.0 / sqrt((double)a.D));
  if (a.D < 1 || a.D > kMaxD || a.Hkv < 1 || a.H % a.Hkv != 0 ||
      a.Sq < 1 || a.Sk < 1 || a.q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch(a, s);
  if (dtype == 1 && tma_ok(a)) return (int)launch_tma(a, s);
  return (int)cudaErrorInvalidValue;
}
