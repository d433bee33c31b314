// Cold-row codec on Hopper: encode the streamed slab's (S, T) f32 rows
// for the cold client store, and decode them back.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cold_codec.py:
// _segment_absmax (_absmax_kernel) and _elementwise (_affine_enc_kernel,
// _affine_dec_kernel, _cast_kernel). Byte for byte the host codec
// core.compress.encode_cold_rows / decode_cold_rows:
// - int8: per (row, FlatLayout segment) s = max(absmax(seg), 1e-12) / 127
//   in f32, q = clip(round_half_even(x / s), -127, 127); decode q * s;
// - f16: the IEEE cast both ways (round to nearest even on the way in);
// - f32 is the identity and launches nothing (the wrapper's business).
//
// What bounds it: bytes. At the streamed FEMNIST-CNN slab (S = 64,
// T = 6,603,710) the int8 encode must read 1.69 GB and write 0.42 GB
// (0.63 ms at 3.35 TB/s). A segment's scale needs the whole segment
// before its first code, so a design in two passes (absmax, then
// quantize: 1.52 ms on an H100 80GB HBM3 at 700 W) reads the rows
// twice. This one
// reads them once: every element stays on chip between its absmax and
// its code. Decode reads 0.42 GB and writes 1.69 GB.
//
// The int8 encode (encode_int8_kernel), one launch:
// - The wrapper plans tasks (cold_codec.encode_plan) of at most kSlice =
//   57,344 columns, one block's shared memory (224 KiB): runs of whole
//   small segments (one segment or many), or one slice of a larger
//   segment. One block of 1024 threads
//   on each SM takes tasks in order from a ticket counter.
// - A task's elements go to shared memory as they are read (16-byte
//   loads of the 4-aligned words, streaming), with the running max of
//   |x| in registers. A task of one whole segment turns that max into
//   its scale at once: no atomics, no second read. A task of several
//   segments takes each segment's max from shared memory, a warp a
//   segment.
// - The slices of a larger segment (the FEMNIST CNN's 126,976- and
//   6,422,528-column ones, cut into 3 and 112) are held on chip by as
//   many blocks at once: each folds its max into the segment's slot
//   (atomicMax on the bits of |x|) and counts itself in, then waits for
//   the count, then codes its slice from shared memory. The launch is
//   cooperative, so every block of the grid is resident, and a group's
//   slices are consecutive tickets of at most one grid: a block waits
//   only for tickets already handed out to running blocks, which reach
//   the count without waiting themselves. A block takes its next ticket
//   only after its group is complete. A segment with more slices than
//   the grid has blocks is coded in two rounds of tickets instead (max,
//   then codes from device memory): the only case that reads twice.
// - A code is v * (1 / s) rounded, checked against the tie: within
//   2^-10 of one, the IEEE quotient is taken instead (see code4()).
// - The next task's ticket and descriptor are fetched, and its elements
//   prefetched into L2 (cp.async.bulk.prefetch, 32 KiB a request: 30 MB
//   for the 132 blocks, within the 50 MB L2), while the current task
//   writes its codes: the reads of one task run under the codes of the
//   one before, and its loads into shared memory then come from L2.
// - Codes are written a 32-bit word (4 codes) a store where the word
//   lies inside the task, a byte a store at its two ends: rows start at
//   row * T bytes, which for the FEMNIST CNN's T = 6,603,710 is only
//   2-byte aligned, so the word grid is the one of the whole (S, T)
//   array (x 16-byte and q 4-byte aligned, checked by the wrapper), on
//   which element e's float4 and its code word share the index e / 4.
// - |x|'s max is taken on the bits with the sign cleared: for
//   non-negative floats the integer order is the float order, and any
//   NaN orders above +inf, so a NaN propagates into the scale as it does
//   through numpy's max. x / s is __fdiv_rn, rounding rintf (half to
//   even, never roundf): no fast math anywhere.
// - The scratch (group maxima and counts, the ticket) is zeroed by one
//   memset before the launch.
//
// The int8 decode: ONE launch over all segments, driven by a table of
// column tiles that never cross a segment boundary (start column,
// length, segment); block b handles tile b % ntiles of row b / ntiles.
// Threads stride a tile with scalar loads and stores, so a warp moves 32
// consecutive elements: coalesced with no vector alignment needed.
// Decode is __fmul_rn.
//
// The f16 casts (cast_kernel), one streaming launch each way over the
// (S, T) array as one flat run, bounded by bytes (6 of them an element:
// 2.54 GB at the slab, 0.757 ms):
// - A thread casts one group of 4 elements: one float4 (16 bytes) on the
//   f32 side, 4 halves (8 bytes) on the f16 side where the two pointers
//   line up, which at the slab's fresh allocations they do; a warp moves
//   512 contiguous bytes of f32 and 256 of f16 an instruction. The grid
//   is a block of 256 threads for every 256 groups, left to the block
//   scheduler. On the H100 that measured faster than a grid of 8 blocks
//   an SM striding the array, and plain loads and stores faster than
//   streaming cache hints (__ldcs / __stcs; both in
//   kernel_ablations.py). Several groups in flight a thread, 16-byte
//   f16 accesses (two float4 a thread) and a bulk store of a block's
//   output from shared memory were tried and were no faster.
// - Both sides are aligned at one element only where their element
//   residues (the f32 pointer's mod 4, the f16 pointer's mod 4) agree. A
//   row view of a slab with T = 2 mod 4 starts 8 bytes past a 16-byte
//   boundary while the output is fresh: there the f16 side falls back to
//   one half an access, while the f32 side keeps its float4 (on the H100
//   the fallback measured as fast as the packed stores at the slab:
//   kernel_ablations.py). The wrapper plans that (cold_codec.cast_plan):
//   a scalar head of fewer than 4 elements that brings the f32 side onto
//   a 16-byte boundary, whole groups, then a scalar tail. The launcher
//   refuses a plan whose alignment does not hold.
// - The arithmetic is __float2half_rn (round to nearest even, no flush
//   of subnormals, overflow to +-inf) and __half2float, bit for bit the
//   results of Tensor.to and of the host codec's numpy cast.
//
// Offsets are 64-bit: S * T passes 2^31 for a 256-row slab of the wider
// models.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Tile {
  int64_t start;  // first column of the tile in the row
  int32_t len;    // columns in the tile (> 0)
  int32_t seg;    // segment the tile lies in
};

__device__ __forceinline__ Tile load_tile(const int64_t* tiles, int64_t t) {
  // two int64 per tile: tiles[2t] = start, tiles[2t + 1] = len (bits
  // 0-31) | seg (bits 32-63)
  Tile out;
  out.start = tiles[2 * t];
  const int64_t packed = tiles[2 * t + 1];
  out.len = (int32_t)(packed & 0xffffffff);
  out.seg = (int32_t)(packed >> 32);
  return out;
}

__device__ __forceinline__ float scale_of(unsigned bits) {
  const float a = __uint_as_float(bits);
  // a < floor is false for NaN, so NaN passes through (numpy's maximum)
  const float m = (a < 1e-12f) ? 1e-12f : a;
  return __fdiv_rn(m, 127.0f);
}

// ---- the int8 encode, one pass ----

constexpr int kEncThreads = 1024;
constexpr int kEncWarps = kEncThreads / 32;
constexpr int kSlice = 57344;    // f32 columns of one task (224 KiB)
constexpr int kMaxUnits = 128;   // segments of one task

// task kinds: the elements stay on chip; the max only; the codes only,
// read again from device memory
enum { kResident = 0, kMaxOnly = 1, kCodesOnly = 2 };

struct Task {
  int64_t e0;     // first element (row * T + column)
  int32_t n;      // elements (<= kSlice)
  int32_t nunits; // whole segments in it, or 1 for a slice of one
  int32_t u0;     // its first segment in the unit table
  int32_t kind;
  int32_t gslot;  // slot of its group of slices in the scratch
  int32_t gsize;  // slices in the group; 1 for a whole segment
};

__device__ __forceinline__ Task unpack_task(const long long* p) {
  // four int64 a task: e0; n | nunits << 32; u0 | kind << 32;
  // gslot | gsize << 32
  Task k;
  k.e0 = p[0];
  k.n = (int32_t)(p[1] & 0xffffffff);
  k.nunits = (int32_t)(p[1] >> 32);
  k.u0 = (int32_t)(p[2] & 0xffffffff);
  k.kind = (int32_t)(p[2] >> 32);
  k.gslot = (int32_t)(p[3] & 0xffffffff);
  k.gsize = (int32_t)(p[3] >> 32);
  return k;
}

__device__ __forceinline__ unsigned absbits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// The codes of four elements, clip(rint(v / s), -127, 127) with v / s
// the IEEE quotient, packed in a word (the first in the low byte).
// v * r (r = 1 / s rounded) is within 2e-5 of v / s wherever |v / s| <=
// 127.5, as it is for every element of s's segment: unless that lands
// within 2^-10 of a tie, both round to the same integer; near a tie the
// quotient is taken exactly.
__device__ __forceinline__ uint32_t code4(const float (&v)[4],
                                          const float (&s)[4],
                                          const float (&r)[4]) {
  float f[4];
  bool tie = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float qf = v[j] * r[j];
    f[j] = rintf(qf);
    tie |= fabsf(qf - f[j]) > 0.4990234375f;
  }
  if (tie) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = rintf(__fdiv_rn(v[j], s[j]));
  }
  int c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    c[j] = (int)fminf(fmaxf(f[j], -127.0f), 127.0f);
  // cvt.pack.sat.s8.s32.b32 d, a, b, c: d = b | a << 8 | c << 16
  uint32_t upper, word;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;"
      : "=r"(upper) : "r"(c[3]), "r"(c[2]), "r"(0u));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;"
      : "=r"(word) : "r"(c[1]), "r"(c[0]), "r"(upper));
  return word;
}

// tid 0: the next task's ticket and descriptor (its four words, then its
// first segment's start and packed length and slot) into s_next; and its
// inside words on their way into L2 (bulk prefetches of 32 KiB), so that
// its reads overlap this task's codes
__device__ __forceinline__ void fetch_task(
    unsigned* ticket, const int64_t* __restrict__ tasks, int64_t ntasks,
    const int64_t* __restrict__ units, const float* __restrict__ x,
    long long* s_next) {
  const int64_t t = atomicAdd(ticket, 1u);
  s_next[0] = t;
  if (t >= ntasks) return;
  const int64_t* p = tasks + 4 * t;
  int64_t d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s_next[1 + i] = d[i] = p[i];
  const int64_t u0 = d[2] & 0xffffffff;
  if ((d[2] >> 32) != kCodesOnly) {
    const int64_t e0 = d[0];
    const int64_t ea = (e0 + 3) & ~3LL;
    const int64_t eb = (e0 + (d[1] & 0xffffffff)) & ~3LL;
    for (int64_t e = ea; e < eb; e += 8192) {
      const int64_t n = eb - e < 8192 ? eb - e : 8192;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                   ::"l"(x + e), "r"((unsigned)(4 * n)) : "memory");
    }
  }
  s_next[5] = units[2 * u0];
  s_next[6] = units[2 * u0 + 1];
}

__global__ void __launch_bounds__(kEncThreads, 1)
    encode_int8_kernel(const float* __restrict__ x,
                       const int64_t* __restrict__ tasks, int64_t ntasks,
                       const int64_t* __restrict__ units,
                       unsigned* __restrict__ scratch, int ngroups,
                       int8_t* __restrict__ q, float* __restrict__ scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* buf = reinterpret_cast<float*>(smem_raw);  // [kSlice + 4]
  float* uscale = buf + kSlice + 4;                 // [kMaxUnits]
  float* urcp = uscale + kMaxUnits;                 // [kMaxUnits]
  int* ubeg = reinterpret_cast<int*>(urcp + kMaxUnits);  // [kMaxUnits+1]
  __shared__ unsigned red[kEncWarps];
  __shared__ long long s_next[7];  // ticket, task, its first segment
  unsigned* gmax = scratch;
  unsigned* gcount = scratch + ngroups;
  unsigned* ticket = scratch + 2 * ngroups;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* x4 = reinterpret_cast<const float4*>(x);

  if (tid == 0) fetch_task(ticket, tasks, ntasks, units, x, s_next);
  __syncthreads();
  while (s_next[0] < ntasks) {
    const Task k = unpack_task(s_next + 1);
    const int64_t ustart = s_next[5];
    const int64_t upacked = s_next[6];
    const int64_t end = k.e0 + k.n;
    const int64_t base = k.e0 & ~3LL;  // element of buf[0]
    const int64_t w0 = base >> 2;      // words [w0, w1) hold the task
    const int64_t w1 = (end + 3) >> 2;
    const int64_t wa = (k.e0 + 3) >> 2;  // words [wa, wb) lie inside it
    const int64_t wb = end >> 2;
    unsigned m = 0u;
    if (k.kind != kCodesOnly) {
      // the inside words, 8 loads in flight a thread (from L2 where the
      // task before this one prefetched them)
      for (int64_t w = wa + tid; w < wb; w += 8 * kEncThreads) {
        float4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (w + i * kEncThreads < wb) v[i] = __ldcs(x4 + w + i * kEncThreads);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (w + i * kEncThreads < wb) {
            m = max(max(max(absbits(v[i].x), absbits(v[i].y)),
                        max(absbits(v[i].z), absbits(v[i].w))), m);
            if (k.kind == kResident)
              *reinterpret_cast<float4*>(
                  buf + ((w + i * kEncThreads - w0) << 2)) = v[i];
          }
      }
      // the (at most two) words cut by its ends: word w0 by thread 0,
      // word w1 - 1 by thread 1 when it is another word
      const int64_t w = tid == 0 ? w0 : w1 - 1;
      if (tid < 2 && (w < wa || w >= wb) && (tid == 0 || w != w0)) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t e = (w << 2) + j;
          v[j] = (e >= k.e0 && e < end) ? x[e] : 0.f;
          m = max(m, absbits(v[j]));
        }
        if (k.kind == kResident)
          *reinterpret_cast<float4*>(buf + ((w - w0) << 2)) =
              make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (k.nunits == 1) {
      // one segment, or one slice of one: the block's max
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) red[warp] = m;
      __syncthreads();
      if (warp == 0) {
        m = __reduce_max_sync(0xffffffffu, red[lane]);
        if (lane == 0) {
          if (k.gsize > 1) {
            if (k.kind != kCodesOnly) {
              atomicMax(gmax + k.gslot, m);
              __threadfence();
              atomicAdd(gcount + k.gslot, 1u);
            }
            if (k.kind != kMaxOnly) {
              while (atomicAdd(gcount + k.gslot, 0u) < (unsigned)k.gsize)
                __nanosleep(32);
              __threadfence();
              m = atomicMax(gmax + k.gslot, 0u);
            }
          }
          const float s = scale_of(m);
          uscale[0] = s;
          urcp[0] = __frcp_rn(s);
          ubeg[0] = 0;
          ubeg[1] = kSlice + 4;
          // the segment's first slice writes its scale
          if (k.kind != kMaxOnly && ustart == k.e0) scale[upacked >> 32] = s;
        }
      }
    } else {
      // whole segments: a warp each, from shared memory
      __syncthreads();
      for (int i = warp; i < k.nunits; i += kEncWarps) {
        const int64_t us = i == 0 ? ustart : units[2 * (k.u0 + i)];
        const int64_t packed = i == 0 ? upacked : units[2 * (k.u0 + i) + 1];
        const int len = (int)(packed & 0xffffffff);
        const float* seg = buf + (us - base);
        unsigned mm = 0u;
        for (int c = lane; c < len; c += 32) mm = max(mm, absbits(seg[c]));
        mm = __reduce_max_sync(0xffffffffu, mm);
        if (lane == 0) {
          const float s = scale_of(mm);
          uscale[i] = s;
          urcp[i] = __frcp_rn(s);
          ubeg[i] = (int)(us - base);
          scale[packed >> 32] = s;
        }
      }
      if (tid == 0) ubeg[k.nunits] = kSlice + 4;
    }
    __syncthreads();
    if (tid == 0) fetch_task(ticket, tasks, ntasks, units, x, s_next);

    // the codes
    const bool codes = k.kind != kMaxOnly;
    // this thread's segment, moving forward: its scale, reciprocal and
    // end in registers
    int ui = 0;
    float us = uscale[0], ur = urcp[0];
    int uend = ubeg[1];
    auto code_word = [&](int64_t w) {
      const int64_t e = w << 2;
      const int rel = (int)(e - base);
      const bool inside = w >= wa && w < wb;
      float v[4];
      if (k.kind == kResident) {
        const float4 v4 = *reinterpret_cast<const float4*>(buf + rel);
        v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
      } else if (inside) {
        const float4 v4 = __ldcs(x4 + w);
        v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = (e + j >= k.e0 && e + j < end) ? x[e + j] : 0.f;
      }
      float sj[4], rj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k.nunits > 1)
          while (rel + j >= uend) {
            ++ui;
            us = uscale[ui];
            ur = urcp[ui];
            uend = ubeg[ui + 1];
          }
        sj[j] = us;
        rj[j] = ur;
      }
      const uint32_t c = code4(v, sj, rj);
      if (inside) {
        *reinterpret_cast<uint32_t*>(q + e) = c;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e + j >= k.e0 && e + j < end) q[e + j] = (int8_t)(c >> (8 * j));
      }
    };
    if (codes)
      for (int64_t w = w0 + tid; w < w1; w += kEncThreads) code_word(w);
    __syncthreads();  // buf is read: the next task may fill it
  }
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scale, int64_t ncols,
                      const int64_t* __restrict__ tiles, int64_t ntiles,
                      int nseg, float* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const int64_t row = b / ntiles;
  const int64_t t = b - row * ntiles;
  const Tile tile = load_tile(tiles, t);
  const float s = scale[row * nseg + tile.seg];
  const int64_t base = row * ncols + tile.start;
  const int8_t* p = q + base;
  float* o = out + base;
#pragma unroll 4
  for (int i = threadIdx.x; i < tile.len; i += kThreads)
    o[i] = __fmul_rn((float)p[i], s);
}

// ---- the f16 casts: one streaming pass each way ----

constexpr int kCastThreads = 256;

// two f16 bits in a word, `a` in the low half (round to nearest even)
__device__ __forceinline__ uint32_t half2_bits(float a, float b) {
  return (uint32_t)__half_as_ushort(__float2half_rn(a)) |
         (uint32_t)__half_as_ushort(__float2half_rn(b)) << 16;
}

__device__ __forceinline__ float half_at(uint32_t w, int hi) {
  return __half2float(__ushort_as_half((unsigned short)(w >> (16 * hi))));
}

template <bool kToHalf>
__device__ __forceinline__ void cast_one(float* f32, unsigned short* f16,
                                         int64_t e) {
  if constexpr (kToHalf)
    f16[e] = __half_as_ushort(__float2half_rn(f32[e]));
  else
    f32[e] = __half2float(__ushort_as_half(f16[e]));
}

// One cast of n elements, f32 -> f16 (kToHalf) or back. Elements [0,
// head) and those after the last whole group go one a thread; between
// them groups of 4 elements, one a thread: the f32 side one float4, the
// f16 side one 8-byte access (kWide) or 4 of one half, every access
// aligned (the plan, cold_codec.cast_plan, chose head and kWide for the
// two pointers).
template <bool kToHalf, bool kWide>
__global__ void __launch_bounds__(kCastThreads)
    cast_kernel(float* __restrict__ f32, unsigned short* __restrict__ f16,
                int64_t n, int64_t head) {
  const int64_t tid = (int64_t)blockIdx.x * kCastThreads + threadIdx.x;
  const int64_t ng = (n - head) / 4;
  const int64_t end = head + 4 * ng;
  // the scalar ends, fewer than 4 elements each
  if (tid < head) cast_one<kToHalf>(f32, f16, tid);
  if (tid < n - end) cast_one<kToHalf>(f32, f16, end + tid);
  float4* x4 = reinterpret_cast<float4*>(f32 + head);
  unsigned short* h0 = f16 + head;
  for (int64_t g = tid; g < ng; g += (int64_t)gridDim.x * kCastThreads) {
    unsigned short* h = h0 + 4 * g;
    if constexpr (kToHalf) {
      const float4 v = x4[g];
      const uint32_t lo = half2_bits(v.x, v.y), hi = half2_bits(v.z, v.w);
      if constexpr (kWide) {
        *reinterpret_cast<uint2*>(h) = make_uint2(lo, hi);
      } else {
        h[0] = (unsigned short)(lo & 0xffff);
        h[1] = (unsigned short)(lo >> 16);
        h[2] = (unsigned short)(hi & 0xffff);
        h[3] = (unsigned short)(hi >> 16);
      }
    } else {
      uint32_t lo, hi;
      if constexpr (kWide) {
        const uint2 v = *reinterpret_cast<const uint2*>(h);
        lo = v.x, hi = v.y;
      } else {
        lo = (uint32_t)h[0] | (uint32_t)h[1] << 16;
        hi = (uint32_t)h[2] | (uint32_t)h[3] << 16;
      }
      x4[g] = make_float4(half_at(lo, 0), half_at(lo, 1), half_at(hi, 0),
                          half_at(hi, 1));
    }
  }
}

// blocks of a tiled pass, or 0 when the grid would not fit
int64_t tiled_blocks(int64_t rows, int64_t ntiles) {
  if (rows < 1 || ntiles < 1) return 0;
  const int64_t blocks = rows * ntiles;
  return blocks > 0x7fffffffLL ? 0 : blocks;
}

constexpr size_t kEncSmem = (kSlice + 4 + 2 * kMaxUnits) * sizeof(float) +
                            (kMaxUnits + 1) * sizeof(int);

// blocks of the encode's cooperative grid: every one resident at once
cudaError_t encode_grid(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(encode_int8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kEncSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, encode_int8_kernel, kEncThreads, kEncSmem);
  *blocks = sms * per_sm;
  return err;
}

template <bool kToHalf, bool kWide>
cudaError_t launch_cast(const void* x, void* out, int64_t n, int64_t head,
                        cudaStream_t s) {
  float* f32 = static_cast<float*>(const_cast<void*>(kToHalf ? x : out));
  unsigned short* f16 =
      static_cast<unsigned short*>(const_cast<void*>(kToHalf ? out : x));
  // a group a thread; at least one block for the scalar ends
  const int64_t groups = (n - head) / 4;
  int64_t blocks = (groups + kCastThreads - 1) / kCastThreads;
  blocks = blocks < 1 ? 1 : blocks > 0x7fffffffLL ? 0x7fffffffLL : blocks;
  cast_kernel<kToHalf, kWide><<<(unsigned)blocks, kCastThreads, 0, s>>>(
      f32, f16, n, head);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the int8 encode's grid on the current device (0 if the
// kernel cannot be resident): the largest group of slices that may stay
// on chip at once.
int cold_encode_int8_grid(void) {
  int blocks = 0;
  return encode_grid(&blocks) == cudaSuccess ? blocks : 0;
}

// x: (rows, ncols) f32, 16-byte aligned; tasks: (ntasks, 4) int64 and
// units: (nunits, 2) int64 (start element, length | scale slot << 32) of
// cold_codec.encode_plan, whose resident groups hold at most max_group
// slices; scratch: 2 * ngroups + 1 uint32; q: (rows, ncols) int8, 4-byte
// aligned; scale: (rows, nseg) f32. One memset, one cooperative launch.
// Returns the CUDA error code (0 on success); cudaErrorInvalidValue if a
// resident group would not fit in the grid.
int cold_encode_int8_launch(const void* x, const void* tasks,
                            long long ntasks, const void* units,
                            void* scratch, int ngroups, int max_group,
                            void* q, void* scale, void* stream) {
  if (ntasks == 0) return (int)cudaSuccess;
  int blocks = 0;
  cudaError_t err = encode_grid(&blocks);
  if (err != cudaSuccess) return (int)err;
  if (ntasks < 0 || ngroups < 0 || blocks < 1 || max_group > blocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0,
                        (size_t)(2 * ngroups + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  if (ntasks < blocks) blocks = (int)ntasks;
  const float* xp = static_cast<const float*>(x);
  const int64_t* tp = static_cast<const int64_t*>(tasks);
  int64_t nt = ntasks;
  const int64_t* up = static_cast<const int64_t*>(units);
  unsigned* sp = static_cast<unsigned*>(scratch);
  int8_t* qp = static_cast<int8_t*>(q);
  float* scp = static_cast<float*>(scale);
  void* args[] = {&xp, &tp, &nt, &up, &sp, &ngroups, &qp, &scp};
  err = cudaLaunchCooperativeKernel((const void*)encode_int8_kernel,
                                    dim3((unsigned)blocks),
                                    dim3(kEncThreads), args, kEncSmem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// q: (rows, ncols) int8; scale: (rows, nseg) f32; out: (rows, ncols) f32.
int cold_decode_int8_launch(const void* q, const void* scale, long long rows,
                            long long ncols, const void* tiles,
                            long long ntiles, int nseg, void* out,
                            void* stream) {
  if (rows == 0 || ncols == 0) return (int)cudaSuccess;
  const int64_t blocks = tiled_blocks(rows, ntiles);
  if (blocks == 0 || nseg < 1) return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), ncols,
      static_cast<const int64_t*>(tiles), ntiles, nseg,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// n elements; to_half 1 casts f32 -> f16 (x f32, out f16), 0 the reverse.
// halves (4 or 1) and head (< 4) are cold_codec.cast_plan's for the two
// pointers: from element `head` on, the f32 side is 16-byte aligned and
// the f16 side 2 * halves-byte aligned wherever a whole group follows
// (cudaErrorMisalignedAddress otherwise). One launch.
int cold_cast_launch(const void* x, void* out, long long n, int to_half,
                     int halves, long long head, void* stream) {
  if (n < 0 || head < 0 || head > 3 || (n > 0 && head > n) ||
      (halves != 4 && halves != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t p32 = (uintptr_t)(to_half ? x : out) + 4 * head;
  const uintptr_t p16 = (uintptr_t)(to_half ? out : x) + 2 * head;
  if (n - head >= 4 && (p32 % 16 || p16 % (2 * halves)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halves == 4)
    return (int)(to_half ? launch_cast<true, true>(x, out, n, head, s)
                         : launch_cast<false, true>(x, out, n, head, s));
  return (int)(to_half ? launch_cast<true, false>(x, out, n, head, s)
                       : launch_cast<false, false>(x, out, n, head, s));
}

}  // extern "C"
