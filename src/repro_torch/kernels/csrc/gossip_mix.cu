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
// 3.38 GB, about 1.0 ms at 3.35 TB/s, against 2*k*n*T = 54 GFLOP, 0.8 ms
// on the CUDA cores' FP32 FMAs: so the products go to the tensor cores,
// and a producer warpgroup keeps several tiles of loads in flight.
//
// Design:
// - Persistent grid, one block an SM: a producer warpgroup and two
//   consumer warpgroups walk column tiles of kC = 128 columns (tile t,
//   t + gridDim.x, ...). No two blocks share a column, and a warpgroup
//   holds all n rows of its 64 columns in registers before it writes any
//   of its k output rows there, so out may alias Y when k == n: the
//   in-place boundary needs no second bank-sized buffer.
// - Loads: the producer copies each tile's (n x kC) slab into a
//   kStages-deep ring with cp.async, each thread's copies completing on
//   the stage's mbarrier. A consumer frees a stage as soon as the slab is
//   in its registers, so up to 3 tiles (102 KB at n = 64, f32) are in
//   flight; more stages leave less L1 to the 8-byte cp.async copies and
//   ran slower on the H100 (PERF.md, PR 14). A
//   bank row starts only as aligned as T allows (the FEMNIST CNN's T =
//   6,603,710 is 2 mod 4: 8-byte rows at f32), so no 2-D tensor map (16-
//   byte row strides) and no TMA box (16-byte aligned starts) describes
//   it: the wrapper picks the copy width (16, 8 or 4 bytes; 2 at bf16,
//   through registers) from T and the pointers. Rows past n and columns
//   past T are zero-filled. Rows are padded to kLD columns, so the
//   fragment loads below are free of bank conflicts.
// - Products: out^T = Y^T W^T on wgmma m64nNk8 TF32, A = Y^T from
//   registers (each consumer warpgroup's 64 columns), B = W from shared
//   memory (K-major, staged once per block), N = k rounded up to 8. TF32
//   wgmma needs a K-major B, so the bank (N-major) cannot be the B
//   operand; transposing the product makes it A. f32 holds through three
//   passes, Y_hi W_hi + Y_lo W_hi + Y_hi W_lo with x_hi = x rounded to
//   TF32 and x_lo = x - x_hi (truncated to TF32 by the tensor core), f32
//   sums: about 2^-21 of each product, inside the 1e-5 tolerance. bf16 Y
//   is exact in TF32: two passes.
// - Stores: each consumer warpgroup puts its k x 64 results in shared
//   memory, rounded to Y's type (f32 or bf16, round to nearest even), and
//   writes them as whole row segments with the copy width of the loads.
// - Indices are 64-bit where they address the bank.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kC = 128;             // columns of a tile
constexpr int kLD = kC + 8;         // row pitch of a staged tile (elements)
constexpr int kMaxRows = 64;        // largest n and k the kernel takes
constexpr int kStages = 3;          // depth of the load ring
constexpr int kOutLD = 64 + 4;      // row pitch of a warpgroup's output
constexpr int kThreads = 384;       // two consumer warpgroups + producer
constexpr int kProducers = 128;

template <typename T>
struct Smem {
  static constexpr int kStage = kMaxRows * kLD * (int)sizeof(T);
  static constexpr int kW = kStages * kStage;                // W hi, W lo
  static constexpr int kOut = kW + 2 * kMaxRows * kMaxRows * 4;
  static constexpr int kOutWG = kMaxRows * kOutLD * (int)sizeof(T);
  static constexpr int kBar = kOut + 2 * kOutWG;             // 2 warpgroups
  static constexpr int kBytes = kBar + 16 * kStages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrives on the barrier once this thread's earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// async copy of BYTES (4, 8 or 16) from global to shared; a dead copy
// zero-fills the destination without reading
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool live) {
  const int n = live ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
}

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// descriptor of W's K-major, unswizzled B tile: 8 x 16-byte core
// matrices, the next 4 K positions 128 bytes on, the next 8 N rows
// 16 core matrices (2 KB) on
__device__ __forceinline__ uint64_t w_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(2048 >> 4) << 32);
}

// W's byte offset of (output row i, input row j) in that layout
__device__ __forceinline__ int w_offset(int i, int j) {
  return ((i >> 3) * 16 + (j >> 2)) * 128 + (i & 7) * 16 + (j & 3) * 4;
}

template <int N> struct Tf32Mma;

// d += A (64 x 8, registers) * B (8 x N, shared, K-major) on TF32,
// f32 accumulators
template <> struct Tf32Mma<8> {
  static __device__ __forceinline__ void rs(float (&d)[4],
                                            const float (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
          "l"(db), "r"(1));
  }
};

template <> struct Tf32Mma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const float (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
          "l"(db), "r"(1));
  }
};

template <> struct Tf32Mma<24> {
  static __device__ __forceinline__ void rs(float (&d)[12],
                                            const float (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
          "l"(db), "r"(1));
  }
};

template <> struct Tf32Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const float (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
          "l"(db), "r"(1));
  }
};

template <> struct Tf32Mma<40> {
  static __device__ __forceinline__ void rs(float (&d)[20],
                                            const float (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
          "l"(db), "r"(1));
  }
};

template <> struct Tf32Mma<48> {
  static __device__ __forceinline__ void rs(float (&d)[24],
                                            const float (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
          "l"(db), "r"(1));
  }
};

template <> struct Tf32Mma<56> {
  static __device__ __forceinline__ void rs(float (&d)[28],
                                            const float (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
          "l"(db), "r"(1));
  }
};

template <> struct Tf32Mma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const float (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
          "l"(db), "r"(1));
  }
};


__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The producer's share of one tile: rows [0, rows) of kC columns into the
// stage at `buf`, copies of BYTES spread over the producer warpgroup.
// BYTES == 2 (bf16 rows only 2-byte aligned) goes through registers:
// cp.async copies at least 4 bytes.
template <typename T, int BYTES>
__device__ __forceinline__ void load_tile(T* buf, const T* Y, int n, int rows,
                                          int64_t ncols, int64_t tile,
                                          int tp) {
  constexpr int V = BYTES / (int)sizeof(T);  // elements a copy
  constexpr int VPR = kC / V;                // copies a row
  const int64_t c0 = tile * kC;
  for (int e = tp; e < rows * VPR; e += kProducers) {
    const int j = e / VPR;
    const int c = (e - j * VPR) * V;
    const bool live = j < n && c0 + c < ncols;
    const T* src = live ? Y + (int64_t)j * ncols + c0 + c : Y;
    T* dst = buf + j * kLD + c;
    if constexpr (BYTES == 2) {
      const unsigned short v =
          live ? *reinterpret_cast<const unsigned short*>(src) : 0;
      *reinterpret_cast<unsigned short*>(dst) = v;
    } else {
      cp_async<BYTES>(smem_u32(dst), src, live);
    }
  }
}

// A consumer warpgroup's k output rows of its 64 columns from `stg` to
// `out` at column c0: copies of BYTES (a row segment starts as aligned as
// the bank's rows, for which the wrapper chose BYTES), clipped at ncols.
template <typename T, int BYTES>
__device__ __forceinline__ void store_rows(T* out, const T* stg, int k,
                                           int64_t ncols, int64_t c0, int t) {
  constexpr int V = BYTES / (int)sizeof(T);
  constexpr int VPR = 64 / V;
  using Word = typename std::conditional<
      BYTES == 16, uint4,
      typename std::conditional<
          BYTES == 8, uint2,
          typename std::conditional<BYTES == 4, uint32_t,
                                    unsigned short>::type>::type>::type;
  for (int e = t; e < k * VPR; e += 128) {
    const int i = e / VPR;
    const int cc = (e - i * VPR) * V;
    if (c0 + cc >= ncols) continue;
    const T* src = stg + i * kOutLD + cc;
    T* dst = out + (int64_t)i * ncols + c0 + cc;
    if constexpr (V == 1) {
      *dst = *src;
    } else {
      // the staging row pitch is 4-element aligned only: gather the copy
      Word w;
      T* wp = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int v = 0; v < V; ++v) wp[v] = src[v];
      *reinterpret_cast<Word*>(dst) = w;
    }
  }
}

// a consumer warpgroup's own barrier (0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <typename T, int NB, int BYTES>
__global__ void __launch_bounds__(kThreads, 1)
    gossip_mix_kernel(const float* __restrict__ W, const T* Y, T* out, int n,
                      int k, int64_t ncols) {
  using L = Smem<T>;
  constexpr int N = 8 * NB;                // output rows, padded
  constexpr bool kSplitY = sizeof(T) == 4;  // bf16 Y is exact in TF32
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_full = base + L::kBar;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int64_t ntiles = (ncols + kC - 1) / kC;
  const int kpad = (n + 7) & ~7;

  // W hi and lo, K-major (input rows j past n and output rows past k: 0)
  for (int e = threadIdx.x; e < kMaxRows * kMaxRows; e += kThreads) {
    const int i = e / kMaxRows;
    const int j = e - i * kMaxRows;
    const float w = (i < k && j < n) ? W[i * n + j] : 0.f;
    const float hi = tf32_round(w);
    *reinterpret_cast<float*>(smem + L::kW + w_offset(i, j)) = hi;
    *reinterpret_cast<float*>(smem + L::kW + kMaxRows * kMaxRows * 4 +
                              w_offset(i, j)) = w - hi;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, kProducers);
      mbar_init(bar_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // W's generic-proxy writes, before wgmma reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup ----
    const int tp = threadIdx.x - 256;
    int it = 0;
    for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
      const int s = it % kStages;
      mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
      load_tile<T, BYTES>(reinterpret_cast<T*>(smem + s * L::kStage), Y, n,
                          kpad, ncols, tile, tp);
      if constexpr (BYTES == 2)
        mbar_arrive(bar_full + 8 * s);
      else
        mbar_arrive_cp_async(bar_full + 8 * s);
    }
  } else {
    // ---- consumers: warpgroup c takes columns 64 c .. 64 c + 63 ----
    const int c = threadIdx.x / 128;
    const int t = threadIdx.x - 128 * c;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int col = 64 * c + 16 * warp + g;  // fragment columns col, col + 8
    const uint32_t w_hi = base + L::kW;
    const uint32_t w_lo = w_hi + kMaxRows * kMaxRows * 4;
    T* stg = reinterpret_cast<T*>(smem + L::kOut + c * L::kOutWG);
    int it = 0;
    for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
      const int s = it % kStages;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      const T* stage = reinterpret_cast<const T*>(smem + s * L::kStage);
      // A = Y^T fragments of every k-step: rows (M) col, col + 8; K
      // (bank rows) 8 ks + tg, 8 ks + tg + 4
      float a[8][4];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (8 * ks < n) {
          const T* r0 = stage + (8 * ks + tg) * kLD + col;
          const T* r1 = r0 + 4 * kLD;
          a[ks][0] = to_f32(r0[0]);
          a[ks][1] = to_f32(r0[8]);
          a[ks][2] = to_f32(r1[0]);
          a[ks][3] = to_f32(r1[8]);
        }
      }
      mbar_arrive(bar_empty + 8 * s);  // the slab is in registers

      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      float ah[8][4], al[8][4];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[ks][e] = kSplitY ? tf32_round(a[ks][e]) : a[ks][e];
          al[ks][e] = a[ks][e] - ah[ks][e];
        }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (8 * ks < n) {
          const uint32_t off = ks * 256;
          if constexpr (kSplitY)
            Tf32Mma<N>::rs(acc, al[ks], w_desc(w_hi + off));
          Tf32Mma<N>::rs(acc, ah[ks], w_desc(w_lo + off));
          Tf32Mma<N>::rs(acc, ah[ks], w_desc(w_hi + off));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);

      // acc[4 nb + e] is column col + 8 (e >> 1) of output row
      // 8 nb + 2 tg + (e & 1): into this warpgroup's staging rows
      wg_sync(1 + c);  // its previous tile's rows are written out
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * nb + 2 * tg + (e & 1);
          if (i < k)
            store_f32(stg + i * kOutLD + 16 * warp + g + 8 * (e >> 1),
                      acc[4 * nb + e]);
        }
      wg_sync(1 + c);
      store_rows<T, BYTES>(out, stg, k, ncols, tile * kC + 64 * c, t);
    }
  }
}

template <typename T, int NB, int BYTES>
cudaError_t launch_t(const float* W, const T* Y, T* out, int n, int k,
                     int64_t ncols, cudaStream_t stream) {
  const int smem = Smem<T>::kBytes;
  auto kernel = gossip_mix_kernel<T, NB, BYTES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (ncols + kC - 1) / kC;
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  kernel<<<grid, kThreads, smem, stream>>>(W, Y, out, n, k, ncols);
  return cudaGetLastError();
}

template <typename T, int NB>
cudaError_t launch_w(const float* W, const T* Y, T* out, int n, int k,
                     int64_t ncols, int bytes, cudaStream_t stream) {
  switch (bytes) {
    case 16: return launch_t<T, NB, 16>(W, Y, out, n, k, ncols, stream);
    case 8: return launch_t<T, NB, 8>(W, Y, out, n, k, ncols, stream);
    case 4: return launch_t<T, NB, 4>(W, Y, out, n, k, ncols, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_t<T, NB, 2>(W, Y, out, n, k, ncols, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const float* W, const T* Y, T* out, int n, int k,
                   int64_t ncols, int bytes, cudaStream_t stream) {
  // the copy width must divide a row and both base pointers
  if (bytes < (int)sizeof(T) || (ncols * (int64_t)sizeof(T)) % bytes != 0 ||
      reinterpret_cast<uintptr_t>(Y) % bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % bytes != 0)
    return cudaErrorInvalidValue;
  switch ((k + 7) / 8) {
    case 1: return launch_w<T, 1>(W, Y, out, n, k, ncols, bytes, stream);
    case 2: return launch_w<T, 2>(W, Y, out, n, k, ncols, bytes, stream);
    case 3: return launch_w<T, 3>(W, Y, out, n, k, ncols, bytes, stream);
    case 4: return launch_w<T, 4>(W, Y, out, n, k, ncols, bytes, stream);
    case 5: return launch_w<T, 5>(W, Y, out, n, k, ncols, bytes, stream);
    case 6: return launch_w<T, 6>(W, Y, out, n, k, ncols, bytes, stream);
    case 7: return launch_w<T, 7>(W, Y, out, n, k, ncols, bytes, stream);
    case 8: return launch_w<T, 8>(W, Y, out, n, k, ncols, bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// W: (k, n) f32 row-major; Y: (n, ncols); out: (k, ncols), may equal Y
// when k == n. dtype 0 is f32, 1 is bf16 (Y and out). copy_bytes is the
// width of one copy (16, 8, 4, or 2 at bf16): it must divide a row's
// bytes and both pointers (the wrapper's copy_bytes). Returns the CUDA error
// code of the launch (0 on success); n or k above kMaxRows (the wrapper's
// MAX_ROWS), or a copy width that does not fit, is refused as
// cudaErrorInvalidValue.
int gossip_mix_rows_launch(const void* W, const void* Y, void* out, int n,
                           int k, long long ncols, int dtype, int copy_bytes,
                           void* stream) {
  if (n < 1 || n > kMaxRows || k < 1 || k > kMaxRows || ncols < 0)
    return (int)cudaErrorInvalidValue;
  if (out == Y && k != n) return (int)cudaErrorInvalidValue;
  if (ncols == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  if (dtype == 0)
    return (int)launch(w, static_cast<const float*>(Y),
                       static_cast<float*>(out), n, k, ncols, copy_bytes, s);
  if (dtype == 1)
    return (int)launch(w, static_cast<const __nv_bfloat16*>(Y),
                       static_cast<__nv_bfloat16*>(out), n, k, ncols,
                       copy_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
