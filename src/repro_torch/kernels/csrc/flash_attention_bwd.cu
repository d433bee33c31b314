// The backward of flash attention on Hopper: dQ, dK and dV from q, k, v,
// the forward's output o, the output's gradient dO and the forward's
// per-row logsumexp, in FlashAttention-2's scheme.
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
// Two launches (three for bf16 with GQA), no atomics, so the sums run in
// one fixed order:
// 1. dq kernel — a block owns 64 query rows of one head: it computes D_i
//    (written out for launch 2), then loops over the key tiles the mask
//    leaves, recomputing P and dP, and writes dQ once.
// 2. dkdv kernel — a block owns 64 keys and loops over the query tiles
//    the mask leaves: of one kv head and all its query heads in turn (f32),
//    or of one query head (bf16), whose f32 partials a third kernel sums
//    over the kv head's query heads in head order.
// Each recomputes the scores it needs: 7 products of the forward's size
// instead of FlashAttention-2's 5, for no float atomics across blocks.
// Rows with no valid key at all (only a window shorter than a row's
// distance past the last key makes one; the models never do) are
// outside what the forward matches, and so here too.
//
// What bounds it: at the qwen2-0.5b training shape (4 x 2048 tokens, 14
// query and 2 kv heads of 64, bf16, causal) the five products the
// gradient needs are 75.2 GFLOP (0.076 ms at the bf16 tensor-core peak)
// against about 67 MB of inputs and outputs (0.020 ms): operations bound
// it. bf16 therefore runs on the tensor cores with mma.sync.m16n8k16
// (f32 sums; P and dS rounded to bf16 as the A operand of the second
// product, as the plain bf16 attention rounds its probabilities), each
// warp owning 16 rows of a 64 x 64 tile. The first version is plain:
// tiles staged in shared memory by all threads (16-byte loads, padded
// rows so that fragment reads and ldmatrix are free of bank conflicts),
// no pipeline, no wgmma or TMA. f32 runs on the CUDA cores (256 threads, a 4 x 4 block
// of each 64 x 64 tile a thread), exact to f32 rounding, for the parity
// checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;
constexpr int kT = 64;  // query rows and keys of a tile

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;     // dO
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq): D_i, written by launch 1
  void* dq;          // (B, Sq, H, D) contiguous
  void* dk;          // (B, Sk, Hkv, D) contiguous
  void* dv;          // (B, Sk, Hkv, D) contiguous
  int B, H, Hkv, Sq, Sk, D;
  int causal, window, q_offset;
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

// key tiles [begin, end) holding a valid key for some row of the query
// tile at q0 (the forward's loop bounds)
__device__ __forceinline__ void key_tiles(const BwdArgs& a, int q0, int& begin,
                                          int& end) {
  const int rows = min(kT, a.Sq - q0);
  const int qpos_lo = a.q_offset + q0;
  const int qpos_hi = qpos_lo + rows - 1;
  begin = 0;
  end = (a.Sk + kT - 1) / kT;
  if (a.causal) end = min(end, qpos_hi / kT + 1);
  if (a.window > 0 && qpos_lo - a.window + 1 > 0)
    begin = min(end, (qpos_lo - a.window + 1) / kT);
}

// query tiles [begin, end) holding a valid row for some key of the key
// tile at k0
__device__ __forceinline__ void query_tiles(const BwdArgs& a, int k0,
                                            int& begin, int& end) {
  const int nq = (a.Sq + kT - 1) / kT;
  begin = 0;
  end = nq;
  // causal: a row sees key k0 once q_offset + row >= k0
  if (a.causal && k0 - a.q_offset > 0) begin = min(nq, (k0 - a.q_offset) / kT);
  // window: row q0 still sees key k0 + kT - 1 while
  // q_offset + q0 - (k0 + kT - 1) < window
  if (a.window > 0) {
    const int last = a.window + k0 + kT - 2 - a.q_offset;  // largest q0 + 0
    end = last < 0 ? 0 : min(nq, last / kT + 1);
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
    dq_f32_kernel(const BwdArgs a) {
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
  key_tiles(a, q0, kt_begin, kt_end);
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
    dkdv_f32_kernel(const BwdArgs a) {
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
  query_tiles(a, k0, qt_begin, qt_end);

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

// ---- bf16 on the tensor cores: mma.sync.m16n8k16, f32 sums ----
//
// 128 threads, 4 warps; warp w owns rows 16 w .. 16 w + 15 of the block's
// 64-row side. Fragments (g = lane / 4, t = lane % 4): A (16 x 16, row
// major) {r g, c 2t..2t+1}, {r g+8, c 2t..}, {r g, c 2t+8..}, {r g+8, c
// 2t+8..}; B (16 x 8) {k 2t..2t+1, n g}, {k 2t+8.., n g}; C (16 x 8) {r g,
// c 2t}, {r g, c 2t+1}, {r g+8, c 2t}, {r g+8, c 2t+1}. Two C tiles side
// by side are, packed to bf16, the A fragment of a 16-deep step.
//
// Shared tiles are bf16, row-major, rows padded to D + 8 elements: a
// fragment read (one 32-bit word a lane) and an ldmatrix (eight 16-byte
// rows) each touch 32 different banks. The first product of a tile reads
// both operands along D; the second takes its B operand (the tile's rows
// as K) through ldmatrix .trans, so no transposed copy is staged.
//
// The dkdv launch gives each block one query head: a kv head's H / Hkv
// blocks of a key tile write f32 partial dK and dV to scratch, and a third
// kernel sums them in head order into bf16 (no atomics). A block's loop
// is then at most Sq / 64 tiles long, not H / Hkv times that.

constexpr int kMThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices, transposed: lanes 8 j .. 8 j + 7 give the
// addresses of matrix j's rows
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows r0 .. r0 + kT - 1 of a (seq, D) bf16 slice with row stride ss into
// `rm` ([row][ld]); rows past `nrows` are zeros. 16-byte loads: D a
// multiple of 8, the slice 16-byte aligned with ss a multiple of 8.
__device__ __forceinline__ void load_bf16(__nv_bfloat16* rm, int ld,
                                          const __nv_bfloat16* src, int64_t ss,
                                          int r0, int nrows, int D) {
  const int chunks = D / 8;
  for (int e = threadIdx.x; e < kT * chunks; e += kMThreads) {
    const int r = e / chunks;
    const int c8 = (e - r * chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * ss + c8);
    *reinterpret_cast<uint4*>(rm + r * ld + c8) = v;
  }
}

// c[n] (n = 0..7, 8 columns each) = A_w (16 x D, rows 16 w.. of `am`) times
// the transpose of `bm`'s 64 rows: one 16 x 64 tile of scores a warp
template <int DK>
__device__ __forceinline__ void rows_dot(float (&c)[8][4],
                                         const __nv_bfloat16* am,
                                         const __nv_bfloat16* bm, int ld,
                                         int w, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const __nv_bfloat16* ar = am + (16 * w + g) * ld + 16 * kk + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * ld), ld32(ar + 8),
                            ld32(ar + 8 * ld + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* br = bm + (8 * n + g) * ld + 16 * kk + 2 * t;
      mma_bf16(c[n], af, ld32(br), ld32(br + 8));
    }
  }
}

// acc[n] (n < D / 8) += X (16 x 64, the C tiles x packed to bf16) times
// the row-major 64 x D tile `rm` (its rows the product's K), B fragments
// by ldmatrix .trans: lane l addresses row 16 kk + 8 ((l / 8) & 1) + l % 8
// of column tile n + l / 16
template <int DK>
__device__ __forceinline__ void acc_dot(float (&acc)[2 * DK][4],
                                        const float (&x)[8][4],
                                        const __nv_bfloat16* rm, int ld,
                                        int lane) {
  const int mat = lane >> 3;
  const int row = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t af[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const __nv_bfloat16* base =
        rm + (16 * kk + (mat & 1) * 8 + row) * ld + 8 * (mat >> 1);
#pragma unroll
    for (int n = 0; n < 2 * DK; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, base + 8 * n);
      mma_bf16(acc[n], af, b[0], b[1]);
      mma_bf16(acc[n + 1], af, b[2], b[3]);
    }
  }
}

template <int DK>
struct MmaLayout {
  static constexpr int D = 16 * DK;
  static constexpr int kLR = D + 8;      // leading dimension, row-major
  static constexpr int kRow = kT * kLR;  // elements of a row-major tile
};

template <int DK>
__global__ void __launch_bounds__(kMThreads)
    dq_bf16_kernel(const BwdArgs a) {
  using L = MmaLayout<DK>;
  using bf = __nv_bfloat16;
  constexpr int D = L::D;
  extern __shared__ __align__(16) unsigned char raw[];
  bf* qs = reinterpret_cast<bf*>(raw);
  bf* gs = qs + L::kRow;  // dO
  bf* ks = gs + L::kRow;
  bf* vs = ks + L::kRow;
  float* dl_s = reinterpret_cast<float*>(vs + L::kRow);  // [kT]: D_i

  const int nq = (a.Sq + kT - 1) / kT;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kT;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const bf* qp = static_cast<const bf*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf* gp = static_cast<const bf*>(a.g) + b * a.g_sb + h * a.g_sh;
  const bf* op = static_cast<const bf*>(a.o) + b * a.o_sb + h * a.o_sh;
  const bf* kp = static_cast<const bf*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf* vp = static_cast<const bf*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int64_t rowbase = ((int64_t)b * a.H + h) * a.Sq;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_bf16(qs, L::kLR, qp, a.q_ss, q0, a.Sq, D);
  load_bf16(gs, L::kLR, gp, a.g_ss, q0, a.Sq, D);

  // D_i of the block's 64 rows, two threads a row, into dl_s and out
  // for the dkdv launch; then lse_i and D_i of the thread's two fragment
  // rows (16 w + g and + 8) into registers
  {
    const int r = threadIdx.x >> 1;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < a.Sq)
      for (int d = (threadIdx.x & 1) * 8; d < D; d += 16) {
        const uint4 gv =
            *reinterpret_cast<const uint4*>(gp + (int64_t)row * a.g_ss + d);
        const uint4 ov =
            *reinterpret_cast<const uint4*>(op + (int64_t)row * a.o_ss + d);
        const bf* gx = reinterpret_cast<const bf*>(&gv);
        const bf* ox = reinterpret_cast<const bf*>(&ov);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc = fmaf(__bfloat162float(gx[i]), __bfloat162float(ox[i]), acc);
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      dl_s[r] = acc;
      if (row < a.Sq) a.delta[rowbase + row] = acc;
    }
  }
  __syncthreads();
  float lse[2], dl[2];
  int rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + 16 * w + g + 8 * r;
    lse[r] = rows[r] < a.Sq ? a.lse[rowbase + rows[r]] : 0.f;
    dl[r] = dl_s[16 * w + g + 8 * r];
  }

  int kt_begin, kt_end;
  key_tiles(a, q0, kt_begin, kt_end);
  float acc[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous tile's readers are done
    load_bf16(ks, L::kLR, kp, a.k_ss, k0, a.Sk, D);
    load_bf16(vs, L::kLR, vp, a.v_ss, k0, a.Sk, D);
    __syncthreads();
    float s[8][4], dp[8][4];
    rows_dot<DK>(s, qs, ks, L::kLR, w, g, t);
    rows_dot<DK>(dp, gs, vs, L::kLR, w, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const float p = allowed(a, rows[r], key)
                            ? __expf(s[n][e] * a.scale - lse[r])
                            : 0.f;
        s[n][e] = p * (dp[n][e] - dl[r]);
      }
    acc_dot<DK>(acc, s, ks, L::kLR, lane);  // dQ += dS K
  }

  bf* dqp = static_cast<bf*>(a.dq) + ((int64_t)b * a.Sq * a.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < a.Sq) {
      bf* out = dqp + (int64_t)rows[r] * a.H * D + 2 * t;
#pragma unroll
      for (int n = 0; n < 2 * DK; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            pack_bf16(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
    }
  }
}

// dK and dV of one key tile from one query head h. With GQA (`part` not
// null) they are f32 partials at (b, key, h) of two (B, Sk, H, D) arrays;
// without, bf16 at (b, key, h) of dk and dv.
template <int DK>
__global__ void __launch_bounds__(kMThreads)
    dkdv_bf16_kernel(const BwdArgs a, float* part) {
  using L = MmaLayout<DK>;
  using bf = __nv_bfloat16;
  constexpr int D = L::D;
  extern __shared__ __align__(16) unsigned char raw[];
  bf* ks = reinterpret_cast<bf*>(raw);
  bf* vs = ks + L::kRow;
  bf* qs = vs + L::kRow;
  bf* gs = qs + L::kRow;
  float* lse_s = reinterpret_cast<float*>(gs + L::kRow);
  float* dl_s = lse_s + kT;

  const int k0 = blockIdx.x * kT;  // the causal band's longest first
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const bf* kp = static_cast<const bf*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf* vp = static_cast<const bf*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bf* qp = static_cast<const bf*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf* gp = static_cast<const bf*>(a.g) + b * a.g_sb + h * a.g_sh;
  const int64_t rowbase = ((int64_t)b * a.H + h) * a.Sq;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_bf16(ks, L::kLR, kp, a.k_ss, k0, a.Sk, D);
  load_bf16(vs, L::kLR, vp, a.v_ss, k0, a.Sk, D);
  int qt_begin, qt_end;
  query_tiles(a, k0, qt_begin, qt_end);
  const int keys[2] = {k0 + 16 * w + g, k0 + 16 * w + g + 8};

  float dk[2 * DK][4], dv[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();  // the previous tile's readers are done
    load_bf16(qs, L::kLR, qp, a.q_ss, q0, a.Sq, D);
    load_bf16(gs, L::kLR, gp, a.g_ss, q0, a.Sq, D);
    if (threadIdx.x < kT) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < a.Sq ? a.lse[rowbase + row] : 0.f;
      dl_s[threadIdx.x] = row < a.Sq ? a.delta[rowbase + row] : 0.f;
    }
    __syncthreads();
    // S^T and dP^T: the warp's 16 keys against the tile's 64 rows
    float s[8][4], dp[8][4];
    rows_dot<DK>(s, ks, qs, L::kLR, w, g, t);
    rows_dot<DK>(dp, vs, gs, L::kLR, w, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * n + 2 * t + (e & 1);  // row within the tile
        const float p = allowed(a, q0 + r, keys[e >> 1])
                            ? __expf(s[n][e] * a.scale - lse_s[r])
                            : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dl_s[r]);
      }
    acc_dot<DK>(dv, s, gs, L::kLR, lane);   // dV += P^T dO
    acc_dot<DK>(dk, dp, qs, L::kLR, lane);  // dK += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= a.Sk) continue;
    if (part != nullptr) {
      const int64_t at = (((int64_t)b * a.Sk + keys[r]) * a.H + h) * D + 2 * t;
      float* pk = part + at;
      float* pv = part + (int64_t)a.B * a.Sk * a.H * D + at;
#pragma unroll
      for (int n = 0; n < 2 * DK; ++n) {
        *reinterpret_cast<float2*>(pk + 8 * n) =
            make_float2(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
        *reinterpret_cast<float2*>(pv + 8 * n) =
            make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    } else {
      const int64_t at = (((int64_t)b * a.Sk + keys[r]) * a.Hkv + hk) * D +
                         2 * t;
      bf* ko = static_cast<bf*>(a.dk) + at;
      bf* vo = static_cast<bf*>(a.dv) + at;
#pragma unroll
      for (int n = 0; n < 2 * DK; ++n) {
        *reinterpret_cast<uint32_t*>(ko + 8 * n) =
            pack_bf16(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(vo + 8 * n) =
            pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// dk and dv (bf16) as the sums, in head order, of the H / Hkv query
// heads' f32 partials: one thread an element of (B, Sk, Hkv, D)
__global__ void __launch_bounds__(256)
    sum_heads_kernel(const BwdArgs a, const float* part) {
  const int64_t n = (int64_t)a.B * a.Sk * a.Hkv * a.D;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int G = a.H / a.Hkv;
  const int d = (int)(i % a.D);
  const int64_t bsk = i / a.D;  // (b * Sk + key) * Hkv + hk
  const int hk = (int)(bsk % a.Hkv);
  const int64_t bs = bsk / a.Hkv;
  const float* pk = part + (bs * a.H + (int64_t)hk * G) * a.D + d;
  const float* pv = pk + (int64_t)a.B * a.Sk * a.H * a.D;
  float sk = 0.f, sv = 0.f;
  for (int j = 0; j < G; ++j) {
    sk += pk[(int64_t)j * a.D];
    sv += pv[(int64_t)j * a.D];
  }
  static_cast<__nv_bfloat16*>(a.dk)[i] = __float2bfloat16_rn(sk);
  static_cast<__nv_bfloat16*>(a.dv)[i] = __float2bfloat16_rn(sv);
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
  cudaError_t err = run(dq_f32_kernel<DC>, gq, kThreads, sq, stream, a);
  if (err != cudaSuccess) return err;
  return run(dkdv_f32_kernel<DC>, gk, kThreads, sk, stream, a);
}

template <int DK>
cudaError_t launch_bf16(const BwdArgs& a, float* part, cudaStream_t stream) {
  using L = MmaLayout<DK>;
  const dim3 gq((unsigned)((a.Sq + kT - 1) / kT), (unsigned)(a.B * a.H));
  const dim3 gk((unsigned)((a.Sk + kT - 1) / kT), (unsigned)(a.B * a.H));
  const size_t sq = (size_t)4 * L::kRow * sizeof(__nv_bfloat16) +
                    kT * sizeof(float);
  const size_t sk = (size_t)4 * L::kRow * sizeof(__nv_bfloat16) +
                    2 * kT * sizeof(float);
  float* p = a.H == a.Hkv ? nullptr : part;
  cudaError_t err = run(dq_bf16_kernel<DK>, gq, kMThreads, sq, stream, a);
  if (err != cudaSuccess) return err;
  err = run(dkdv_bf16_kernel<DK>, gk, kMThreads, sk, stream, a, p);
  if (err != cudaSuccess || p == nullptr) return err;
  const int64_t n = (int64_t)a.B * a.Sk * a.Hkv * a.D;
  sum_heads_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a, p);
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

// the layouts the bf16 kernels' 16-byte loads take: D a multiple of 16,
// 16-byte aligned pointers, strides of the axes longer than 1 positive
// multiples of 8 elements
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
    if (strides[i] <= 0 || strides[i] % 8 != 0) return false;
  }
  return true;
}

}  // namespace

// dims: B, H, Hkv, Sq, Sk, D, causal, window, q_offset, then the element
// strides of (batch, seq, head) of q, k, v, o and dO (24 values). lse is
// the forward's (B, H, Sq) f32 logsumexp; delta is (B, H, Sq) f32 scratch;
// part, for bf16 with H > Hkv, 2 x (B, Sk, H, D) f32 scratch (else unused).
// dq (B, Sq, H, D) and dk, dv (B, Sk, Hkv, D) are contiguous, of the
// inputs' dtype: 0 = f32, 1 = bf16. Two launches on `stream`. Returns the
// CUDA error of the launches (0 on success); cudaErrorInvalidValue for a
// shape or a bf16 layout that the kernels do not take.
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
  int64_t* st[15] = {&a.q_sb, &a.q_ss, &a.q_sh, &a.k_sb, &a.k_ss,
                     &a.k_sh, &a.v_sb, &a.v_ss, &a.v_sh, &a.o_sb,
                     &a.o_ss, &a.o_sh, &a.g_sb, &a.g_ss, &a.g_sh};
  for (int i = 0; i < 15; ++i) *st[i] = dims[9 + i];
  // the forward's scale: the f32 rounding of 1/sqrt(D)
  a.scale = (float)(1.0 / sqrt((double)a.D));
  if (a.D < 1 || a.D > kMaxD || a.Hkv < 1 || a.H % a.Hkv != 0 ||
      a.Sq < 1 || a.Sk < 1 || a.q_offset < 0 || a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !bf16_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && a.H != a.Hkv && part == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch(a, part, dtype, static_cast<cudaStream_t>(stream));
}
