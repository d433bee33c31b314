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
// operations bound it. So bf16 inputs run both products on the tensor
// cores with mma.sync (flash_attention_mma_kernel); they must have a head
// size that is a multiple of 16, 16-byte aligned pointers and strides
// that are multiples of 8 elements, or the launch is refused. f32 inputs
// take the CUDA-core kernel (flash_attention_kernel), held to the f32 FMA
// rate (67 TFLOP/s) and exact to f32 rounding. wgmma and TMA are later
// work.
//
// Design, common to both kernels:
// - One block owns 64 query rows of one (batch, head) and loops over
//   64-key tiles in order, keeping the running max m, the sum l and the
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
// The CUDA-core kernel (f32 only, 256 threads):
// - The q tile (transposed, [d][row]) stays in shared memory; each key
//   tile is staged as k transposed ([d][key]) and v ([key][d]).
// - S = Q K^T: each thread computes a 4x4 block of scores from float4
//   loads. Row max and row sum reduce over the 16 threads of a row (one
//   half-warp) with shuffles.
// - P V: probabilities go to shared memory transposed; each thread keeps
//   4 rows x ceil(D/16) columns (col = tx + 16c) of acc, so D need not be
//   a power of two (80 here; the sweep has 64 and 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLD = kBQ + 4;   // leading dimension of the transposed tiles
constexpr int kMaxD = 128;     // largest head size taken
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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
      float* orow = op + (int64_t)row * a.o_ss;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) orow[col] = acc[i][c] / den;
      }
    }
  }
}

// ---- bf16 on the tensor cores: mma.sync.m16n8k16 ----
//
// One block of 4 warps owns 64 query rows (16 a warp) of one (batch,
// head); per 64-key tile a warp computes its 16 x 64 scores with
// mma.sync (q fragments kept in registers for the whole loop, k read from
// shared memory), runs the online softmax on the accumulator fragments
// (each thread holds 2 rows; a row's 64 scores are spread over the 4
// threads of a quad and reduce with two shuffles), and multiplies the
// probabilities into v, again with mma.sync: the score fragments of two
// 8-key blocks are exactly the A fragment of one 16-key step. The
// reference multiplies p and v in f32; rounding p to bf16 would move an
// output by up to one bf16 step of its size (0.03 at |o| >= 4, past the
// 2e-2 tolerance), so p goes in as a bf16 pair hi + lo, two products,
// which holds it to about 2^-16. m, l and o stay f32. Tiles and masks as
// in the CUDA-core kernel above.

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

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

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// (x, y) as a bf16 pair plus the bf16 pair of what that rounding left
// out: hi + lo holds x and y to about 2^-16 of their size
__device__ __forceinline__ void split_f32(float x, float y, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack_f32(x - hf.x, y - hf.y);
}

template <int DK>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(const Args a) {
  constexpr int D = 16 * DK;    // head size
  constexpr int DN = 2 * DK;    // 8-column blocks of the output
  constexpr int CH = D / 8;     // 16-byte chunks a row
  constexpr int LD = D + 8;     // row pitch of the tiles (bf16)
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * LD];  // q, then k tiles
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * LD];

  const int nq = (a.Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row of a fragment (and row + 8)
  const int tg = lane & 3;  // column pair of a fragment

  for (int e = tid; e < kBQ * CH; e += kMmaThreads) {
    const int r = e / CH;
    const int c = e - r * CH;
    const int row = q0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.Sq)
      v = *reinterpret_cast<const uint4*>(qp + (int64_t)row * a.q_ss + c * 8);
    *reinterpret_cast<uint4*>(ks + r * LD + c * 8) = v;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    qf[kk][0] = lds32(ks + r0 * LD + kk * 16 + tg * 2);
    qf[kk][1] = lds32(ks + (r0 + 8) * LD + kk * 16 + tg * 2);
    qf[kk][2] = lds32(ks + r0 * LD + kk * 16 + 8 + tg * 2);
    qf[kk][3] = lds32(ks + (r0 + 8) * LD + kk * 16 + 8 + tg * 2);
  }

  const int rows = min(kBQ, a.Sq - q0);
  const int qpos_lo = a.q_offset + q0;
  const int qpos_hi = qpos_lo + rows - 1;
  int kt_begin = 0;
  int kt_end = (a.Sk + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, qpos_hi / kBK + 1);
  if (a.window > 0 && qpos_lo - a.window + 1 > 0)
    kt_begin = (qpos_lo - a.window + 1) / kBK;

  // rows q0 + r0 (fragment elements 0, 1) and q0 + r0 + 8 (elements 2, 3)
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[DN][4];
#pragma unroll
  for (int nd = 0; nd < DN; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // q fragments and the previous tile are read
    for (int e = tid; e < kBK * CH; e += kMmaThreads) {
      const int j = e / CH;
      const int c = e - j * CH;
      const int key = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < a.Sk) {
        kv = *reinterpret_cast<const uint4*>(kp + (int64_t)key * a.k_ss + c * 8);
        vv = *reinterpret_cast<const uint4*>(vp + (int64_t)key * a.v_ss + c * 8);
      }
      *reinterpret_cast<uint4*>(ks + j * LD + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + j * LD + c * 8) = vv;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const __nv_bfloat16* kr = ks + (nb * 8 + g) * LD + kk * 16 + tg * 2;
        mma_bf16(s[nb], qf[kk], lds32(kr), lds32(kr + 8));
      }
    }

    float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + (e >> 1) * 8;
        const int qpos = a.q_offset + row;
        const int kpos = k0 + nb * 8 + tg * 2 + (e & 1);
        bool ok = kpos < a.Sk && row < a.Sq;
        if (a.causal) ok = ok && qpos >= kpos;
        if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
        s[nb][e] = ok ? s[nb][e] * a.scale : kNegInf;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], s[nb][e]);
      }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 2));
      const float m_new = fmaxf(m[i], rmax[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e >> 1]);
        rsum[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l[i] = l[i] * corr[i] + rsum[i];
    }
#pragma unroll
    for (int nd = 0; nd < DN; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }

#pragma unroll
    for (int k16 = 0; k16 < kBK / 16; ++k16) {
      // the A fragment of this 16-key step, as hi + lo bf16 parts
      uint32_t hi[4], lo[4];
      split_f32(s[2 * k16][0], s[2 * k16][1], hi[0], lo[0]);
      split_f32(s[2 * k16][2], s[2 * k16][3], hi[1], lo[1]);
      split_f32(s[2 * k16 + 1][0], s[2 * k16 + 1][1], hi[2], lo[2]);
      split_f32(s[2 * k16 + 1][2], s[2 * k16 + 1][3], hi[3], lo[3]);
      const __nv_bfloat16* vr = vs + (k16 * 16 + tg * 2) * LD + g;
#pragma unroll
      for (int nd = 0; nd < DN; ++nd) {
        const __nv_bfloat16* vc = vr + nd * 8;
        const uint32_t b0 = pack2(vc[0], vc[LD]);
        const uint32_t b1 = pack2(vc[8 * LD], vc[9 * LD]);
        mma_bf16(o[nd], hi, b0, b1);
        mma_bf16(o[nd], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + i * 8;
    if (row < a.Sq) {
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = op + (int64_t)row * a.o_ss + tg * 2;
#pragma unroll
      for (int nd = 0; nd < DN; ++nd)
        *reinterpret_cast<uint32_t*>(orow + nd * 8) =
            pack_f32(o[nd][2 * i] / den, o[nd][2 * i + 1] / den);
    }
  }
}

template <int DK>
cudaError_t launch_mma_t(const Args& a, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.Sq + kBQ - 1) / kBQ), (unsigned)(a.B * a.H));
  flash_attention_mma_kernel<DK><<<grid, kMmaThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  switch (a.D / 16) {
    case 1: return launch_mma_t<1>(a, stream);
    case 2: return launch_mma_t<2>(a, stream);
    case 3: return launch_mma_t<3>(a, stream);
    case 4: return launch_mma_t<4>(a, stream);
    case 5: return launch_mma_t<5>(a, stream);
    case 6: return launch_mma_t<6>(a, stream);
    case 7: return launch_mma_t<7>(a, stream);
    case 8: return launch_mma_t<8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the tensor-core kernel reads rows as 16-byte chunks and writes pairs
bool mma_ok(const Args& a) {
  if (a.D % 16 != 0) return false;
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const int64_t strides[12] = {a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh,
                               a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh};
  for (int64_t st : strides)
    if (st % 8 != 0) return false;
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
// dtype: 0 = f32, 1 = bf16 (q, k, v and o alike). Returns the CUDA error
// of the launch (0 on success); cudaErrorInvalidValue for a shape, or a
// bf16 layout, that no kernel takes.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* dims, int dtype,
                                      void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
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
  if (dtype == 1 && mma_ok(a)) return (int)launch_mma(a, s);
  return (int)cudaErrorInvalidValue;
}
