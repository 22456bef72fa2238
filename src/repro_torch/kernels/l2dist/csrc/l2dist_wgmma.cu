// Exact squared L2 distances on Hopper's tensor cores (sm_90a), f32,
// bf16 or 8-bit integer inputs, f32 output.
//
// Replaces the Pallas TPU kernel repro/kernels/l2dist/l2dist.py::l2dist
// (_l2_kernel, which widens its inputs to f32) for f32 of every width,
// bf16 of every width (odd ones copied by a kernel of the same launch
// into rows zero-padded to a multiple of 8) and 8-bit integers (uint8 or
// int8 each, d <= 128 with d % 4 == 0: SIFT1B's uint8 at 128, SPACEV1B's
// int8 at 100) as they are; l2dist/ops.py states the rule, its wrapper
// casting other dtypes first (other 8-bit widths to bf16, exact there):
//     out[b, n] = (|q_b|^2 - 2 q_b.v_n) + |v_n|^2        (B, N) f32.
//
// What bounds it on an H100 SXM: bytes.  At the ground-truth chunk
// (B = 256, N = 2^20, D = 128) it must read q and v once and write the
// output once: in f32 (256*128 + 2^20*128)*4 + 256*2^20*4 B = 1.61 GB,
// 0.481 ms at 3.35 TB/s; in bf16 the inputs take half, 1.34 GB, 0.401 ms;
// in bf16 at SPACEV1B's d = 100, 1.28 GB, 0.383 ms.  The 1.07 GB output
// is most of each.  The products are 68.7 GFLOP:
// three times that in 3xTF32 take 0.417 ms at the dense TF32 rate (495
// TFLOP/s); once in bf16 (each product exact in f32) 0.069 ms at 989
// TFLOP/s.  SIFT1B's uint8 takes a quarter of f32's input bytes: 1.21
// GB, 0.361 ms (the products 0.035 ms at int8's 1,979 TOPS); SPACEV1B's
// int8 at d = 100, 1.18 GB, 0.352 ms.  The f32 CUDA cores alone could not go below 1.03 ms.  At
// GIST1M's d = 960 (the smoke's streamed call) f32 is bound by operations:
// 515 GFLOP, in 3xTF32 3.12 ms against 1.52 ms for its 5.1 GB; bf16 by
// bytes: 3.09 GB, 0.921 ms, against 0.52 ms for one bf16 product.
//
// Products.  f32: wgmma m64n128k8 in TF32, three times per k-step; each
// operand is split as hi = tf32(x) (round to nearest), lo = tf32(x - hi),
// and hi*lo + lo*hi + hi*hi is summed into the f32 accumulator (the lo*lo
// term is below f32's resolution of the sum).  bf16: one wgmma
// m64n128k16 per k-step straight from the loaded tiles, no split.  On
// integer data below 2^8 (exact in both types) every product and partial
// sum is an integer below 2^24, so the result equals the plain version's
// bit for bit.  The norms are __fmaf_rn sums of the (widened) squares
// taken from the tiles the kernel reads; the epilogue rounds each step,
// as ref.py::l2dist_ref does.  8-bit: one wgmma m64n128k32.s32 per
// k-step on u8 or s8 operands as loaded (wgmma takes all four mixes,
// CUTLASS's cute/arch/mma_sm90_gmma.hpp lists them; the toolkit ships no
// PTX ISA document), int32 sums, norms by dp4a, and the epilogue's
// |q|^2 - 2 q.v + |v|^2 in int32, converted to f32 once.  For d <= 128
// every value of u8 or s8 alone is below 128 * 255^2 = 8,323,200 < 2^24,
// so exact in f32 and equal to the plain version's bit for bit; a mix
// (|q - v| up to 383) reaches 18.8M, where |q|^2 - 2 q.v is still below
// 2^24, so the plain version rounds once, at its last add, as the one
// conversion does: bit for bit too.
//
// Design: a persistent grid, one block an SM (l2dist/ops.py::l2_plan):
// block (x, y) owns the 128 queries of tile y and walks the 128-vector
// tiles x, x + grid_x, ...; the blocks of one x walk the same vector
// tiles at the same time, so each tile comes from HBM about once.  Up to
// d = 128 a producer warp loads the query tile once (all of d in
// 128-byte-wide, 128-byte swizzled k-slices: 32 f32, 64 bf16 or 128 8-bit
// columns, so an 8-bit tile is one slice) and streams the vector tiles'
// k-slices through a ring (3 stages in f32, whose slices also need a lo
// buffer; 4 in bf16 and 8-bit), behind full / empty mbarriers.  f32 with
// d % 4 == 0 and 8-bit with d % 16 == 0 (rows on 16 bytes) load by TMA,
// which fills rows and columns past B, N and d with zeros.  bf16, and
// f32 and 8-bit of other widths, load by cp.async, which takes rows on 4 bytes (SPACEV1B's
// d = 100 in bf16: rows of 200 bytes, which no tensor map takes): the
// producer warp's 32 lanes copy the slices in granules of 16 bytes (row
// stride % 16 == 0), 8 or 4 (bf16 by the widest its stride allows, f32
// by 4, 8-bit by 8 or 4), straight into the same swizzled layout, zero-filling the rows
// past B and N and the granules past d (so a stage that held another
// k-slice reads zeros there), and each lane's
// cp.async.mbarrier.arrive.noinc counts on the full barrier.  At d = 128
// the 16-byte granules took 0.7099 / 0.7067 ms against TMA's 0.7183 /
// 0.7146 (kernel_ab, H100 80GB HBM3, 700 W), so bf16 has no TMA load
// path.  Launches off the 16-byte stride count as
// l2dist_wgmma[bf16,off16] and l2dist_wgmma[int8,off16], 8-bit ones on it
// as l2dist_wgmma[int8].
//
// Above d = 128 the query tile (983 KB at d = 960 in f32, hi and lo) does
// not fit, so the query tile is streamed (kStream): each ring stage holds
// one k-slice of the block's 128 queries and the same k-slice of the
// vector tile, behind one full barrier (TMA: expect_tx of all the
// stage's loads; cp.async: the lanes arrive after all their copies), and
// the accumulators stay in registers across all d / kBK slices.  The q
// slices are read again for every vector tile, from L2 (the whole query
// set is under 1 MB).  A prologue kernel, launched first on the same
// stream, writes the query norms and, in f32, q's TF32 hi and lo parts
// once, so the main kernel loads q hi and lo as they are and splits only
// the v slices: at d = 960 in f32 splitting each q slice as it landed
// took 7.71 ms, the prologue's split 5.97 (kernel_ab, H100 80GB HBM3, 700
// W).  bf16 rows on 16 bytes (d % 8 == 0) load by TMA here: the producer
// warp's cp.async copies, as the resident path loads them, took 3.17 ms
// at d = 960 against TMA's 1.41 (same call), the one warp's issue rate
// the limit once the query slices come again for every tile.  Ring: f32
// 3 stages x (q hi, q lo, v hi, v lo) 64 KB = 192 KB; bf16 6 x (q, v)
// 32 KB = 192 KB, its finished tiles written as f32's are.  Launches
// count as l2dist_wgmma[d>128] and l2dist_wgmma[bf16,d>128].
//
// The two consumer warpgroups take the block's vector tiles in turns
// (ping-pong).  In f32 they split the resident query tile once; then one
// splits each v slice of its tile that has landed (hi in place, lo into a
// second buffer of the same layout), fences the generic-proxy stores for
// the async proxy, synchronises on a named barrier and issues the slice's
// 24 wgmmas (two 64-query halves), splitting the next slice while they
// run.
// In bf16 it only sums the slice's squares and issues its 8 wgmmas (8-bit:
// the same, its squares by dp4a).  It
// hands a slice back to the producer once its wgmmas are done; meanwhile
// the other writes its finished 128 x 128 tile out, so the output, most
// of the bound, leaves while the tensor cores work.  f32 writes it as
// float2 pairs straight from the accumulators' layout (a warp writes
// whole 32-byte row segments).  bf16 and 8-bit, whose smaller tiles leave
// 128 KB of shared memory free, stage the tile there in TMA's swizzled layout and
// write it with eight TMA stores of 64 rows x 128 bytes (whole cache
// lines), where N % 4 == 0 lets TMA address the output's rows; on the
// chunk that took 0.71 ms against 0.83 for the float2 stores (kernel_ab,
// H100 80GB HBM3, 700 W).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                   // queries per block
constexpr int kBN = 128;                   // vectors per tile
constexpr int kMaxD = 128;                 // the resident query tile's width
constexpr int kSliceBytes = 128 * 128;     // 128 rows x 128 B, q or v
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kHalfBytes = 64 * kBN * 4;   // 64 rows of a finished tile

// The shapes of one instantiation of kElem-byte elements: f32 (4, 3xTF32),
// bf16 (2, one product) or 8-bit integers (1, one integer product); the
// query tile resident (d <= 128) or streamed with the vectors (kStream;
// f32 and bf16 only)
template <int kElem, bool kStream>
struct Cfg {
  static constexpr bool kF32 = kElem == 4;
  static constexpr int kBK = 128 / kElem;      // columns of a k-slice
  static constexpr int kSlices = kStream ? 0 : kMaxD / kBK;  // resident q
  static constexpr int kBufs = kF32 ? 2 : 1;   // hi, and lo in f32
  // depth of the ring; a stage holds a v slice, streamed also a q slice
  static constexpr int kStages = kF32 ? 3 : (kStream ? 6 : 4);
  static constexpr int kOps = kStream ? 2 : 1;
  // the slices a stage's loads fill: v hi; streamed also q hi, and in f32
  // q lo (split by the prologue); v lo is the consumer's
  static constexpr int kLoads = kStream ? (kF32 ? 3 : 2) : 1;
  // resident bf16 and 8-bit: each warpgroup stages its finished tile (two
  // 64-row halves of 32 KB) for the TMA stores; f32 has no room left for
  // it, and streamed bf16 spends it on a deeper ring
  static constexpr int kStageBytes = !kF32 && !kStream ? 4 * kHalfBytes : 0;
  // dynamic shared memory, 1024-byte aligned: resident, q hi | q lo
  // (kSlices each) | v hi | v lo (kStages each); streamed, q hi | v hi |
  // q lo | v lo (kStages each); then the staging.  224 KB of the 227
  // resident (8-bit: 208 KB, its query tile and a vector tile one slice
  // each), 192 KB streamed
  static constexpr int kSmemBytes =
      kBufs * (kSlices + kOps * kStages) * kSliceBytes + kStageBytes + 1024;
  // barriers: the q tile, full [stage], empty [stage] (a stage goes to
  // one warpgroup), turn [warpgroup] (whose products run next)
  static constexpr int kBarQ = 0, kBarFull = 1, kBarEmpty = 1 + kStages,
                       kBarTurn = 1 + 2 * kStages,
                       kNumBars = 3 + 2 * kStages;
};

// d (64 x 128, f32) (+)= A (64 x 16, smem) * B (128 x 16, smem)^T in
// bf16, both K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, s32) (+)= A (64 x 32, smem) * B (128 x 32, smem)^T on
// 8-bit integers, both K-major, exact; kMix: bit 1 set where A is s8
// (else u8), bit 0 where B is; accumulate = 0 overwrites d
#define L2_MMA_I8(A, B)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n128k32.s32." A "." B    \
               " " R64 ", %64, %65, p;\n}\n"                              \
               : D64I                                                    \
               : "l"(da), "l"(db), "r"(accumulate))
template <int kMix>
__device__ __forceinline__ void mma_i8(int (&d)[64], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (kMix == 0) L2_MMA_I8("u8", "u8");
  else if constexpr (kMix == 1) L2_MMA_I8("u8", "s8");
  else if constexpr (kMix == 2) L2_MMA_I8("s8", "u8");
  else L2_MMA_I8("s8", "s8");
}
#undef L2_MMA_I8

// the accumulators, norms and their sums: int32 for 8-bit integers (exact),
// f32 otherwise
template <int kElem> struct Acc { using T = float; };
template <> struct Acc<1> { using T = int; };
__device__ __forceinline__ float add2(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ int add2(int a, int b) { return a + b; }
// a distance from its terms, rounded at each step in f32 as
// ref.py::l2dist_ref does; in int32 exact, then converted once (below
// 2^24 for d <= 128, so the same value)
__device__ __forceinline__ float dist_of(float qn, float dot, float vn) {
  return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, dot)), vn);
}
__device__ __forceinline__ float dist_of(int qn, int dot, int vn) {
  return __int2float_rn(qn - 2 * dot + vn);
}

// The producer warp's copy of k-slice s (the 128 bytes at 128 s of each
// row: 64 bf16 or 32 f32 columns) of rows row0 .. row0 + 127 of a (rows, d)
// matrix of kElem-byte elements into a 128-row slice in TMA's 128-byte
// swizzle, by cp.async granules of kGran bytes (16, 8 or 4): a pass takes
// 32 / (128 / kGran) rows, a lane one granule.  Every byte of the slice is
// written: granules past d and rows past `rows` are zero-filled, so a ring
// stage that held another k-slice before reads zeros past d.
template <int kGran, int kElem>
__device__ __forceinline__ void copy_slice(uint32_t dst,
                                           const uint8_t* __restrict__ src,
                                           int rows, int row0, int d, int s,
                                           int lane) {
  constexpr int kSlots = 128 / kGran;        // granules of a 128-byte row
  constexpr int kRowsPerPass = 32 / kSlots;
  const int row_bytes = kElem * d;
  const int granules = min(128, row_bytes - 128 * s) / kGran;
  const int gi = lane % kSlots;
  const bool in_d = gi < granules;
  const int col = in_d ? 128 * s + gi * kGran : 0;   // byte in the source row
  const int in_row = gi * kGran;                     // byte in the slice's row
#pragma unroll 4
  for (int r = lane / kSlots; r < 128; r += kRowsPerPass) {
    const int gr = row0 + r;
    const bool ok = in_d && gr < rows;
    cp_async<kGran>(
        dst + r * 128 + ((((in_row >> 4) ^ (r & 7))) << 4) + (in_row & 15),
        src + (long long)(ok ? gr : 0) * row_bytes + col, ok ? kGran : 0);
  }
}

// Splits one landed 128-row f32 k-slice (1024 chunks of 16 bytes) among
// kT threads: x -> hi = tf32(x) in place and lo = tf32(x - hi) at the same
// offset of lo (the same swizzled layout).  Thread t takes chunks
// t + kT i, of rows t / 8 + (kT / 8) i; sq[i] sums the squares of the
// elements it saw of that row.
template <int kT>
__device__ __forceinline__ void split_slice(float4* hi, float4* lo, int t,
                                            float (&sq)[1024 / kT]) {
#pragma unroll
  for (int i = 0; i < 1024 / kT; ++i) {
    const float4 x = hi[t + kT * i];
    sq[i] = __fmaf_rn(x.x, x.x, sq[i]);
    sq[i] = __fmaf_rn(x.y, x.y, sq[i]);
    sq[i] = __fmaf_rn(x.z, x.z, sq[i]);
    sq[i] = __fmaf_rn(x.w, x.w, sq[i]);
    const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y),
                                 tf32_rna(x.z), tf32_rna(x.w));
    hi[t + kT * i] = h;
    lo[t + kT * i] = make_float4(
        tf32_rna(__fsub_rn(x.x, h.x)), tf32_rna(__fsub_rn(x.y, h.y)),
        tf32_rna(__fsub_rn(x.z, h.z)), tf32_rna(__fsub_rn(x.w, h.w)));
  }
}

// The same walk over a landed bf16 k-slice, which stays as it is: sq[i]
// sums the squares of the eight values of each chunk, widened to f32.
template <int kT>
__device__ __forceinline__ void square_slice(const uint4* tile, int t,
                                             float (&sq)[1024 / kT]) {
#pragma unroll
  for (int i = 0; i < 1024 / kT; ++i) {
    const uint4 x = tile[t + kT * i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = __uint_as_float(w[j] << 16);
      const float hi = __uint_as_float(w[j] & 0xffff0000u);
      sq[i] = __fmaf_rn(lo, lo, sq[i]);
      sq[i] = __fmaf_rn(hi, hi, sq[i]);
    }
  }
}

// The same walk over a landed 8-bit k-slice: sq[i] sums the squares of
// the sixteen values of each chunk in int32 (exact), four at a time by
// dp4a; kSigned: s8, else u8.
template <int kT, bool kSigned>
__device__ __forceinline__ void square_slice_i8(const uint4* tile, int t,
                                                int (&sq)[1024 / kT]) {
#pragma unroll
  for (int i = 0; i < 1024 / kT; ++i) {
    const uint4 x = tile[t + kT * i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sq[i] = kSigned ? __dp4a((int)w[j], (int)w[j], sq[i])
                      : (int)__dp4a(w[j], w[j], (unsigned)sq[i]);
  }
}

// The squares of a landed slice into sq; in f32 also its split, fenced
// for the wgmmas that read it.  kSigned: 8-bit values are s8.
template <int kElem, bool kSigned, int kT>
__device__ __forceinline__ void take_slice(
    uint8_t* hi, uint8_t* lo, int t,
    typename Acc<kElem>::T (&sq)[1024 / kT]) {
  if constexpr (kElem == 1) {
    square_slice_i8<kT, kSigned>(reinterpret_cast<const uint4*>(hi), t, sq);
  } else if constexpr (kElem == 2) {
    square_slice<kT>(reinterpret_cast<const uint4*>(hi), t, sq);
  } else {
    split_slice<kT>(reinterpret_cast<float4*>(hi),
                    reinterpret_cast<float4*>(lo), t, sq);
    fence_proxy_async();
  }
}

// the eight threads of a row add their sums; the first stores the norm
template <int kT, class T>
__device__ __forceinline__ void store_norms(const T (&sq)[1024 / kT],
                                            T* norm, int t) {
#pragma unroll
  for (int i = 0; i < 1024 / kT; ++i) {
    T s = sq[i];
    s = add2(s, __shfl_xor_sync(0xffffffffu, s, 1));
    s = add2(s, __shfl_xor_sync(0xffffffffu, s, 2));
    s = add2(s, __shfl_xor_sync(0xffffffffu, s, 4));
    if ((t & 7) == 0) norm[t / 8 + (kT / 8) * i] = s;
  }
}

// named barriers (hopper.cuh named_sync): 1 for both consumer
// warpgroups, 2 + w for warpgroup w

// Writes the 64 x 128 block of a finished tile held in acc: element
// 4j + 2h + e is (row + 8h, column 8j + 2 quad + e), `row` this thread's
// first global row, `v0` the tile's first vector: out = (|q|^2 - 2 q.v) +
// |v|^2 (dist_of).  A warp writes whole 32-byte row segments, as float2
// pairs where n is even.
template <class T>
__device__ __forceinline__ void store_tile(const T (&acc)[64],
                                           float* __restrict__ out,
                                           const T* vn, const T (&qn)[2],
                                           int row, int v0, int quad, int b,
                                           int n) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= b) continue;
    float* orow = out + (long long)(row + 8 * h) * n;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      const int gc = v0 + col;
      const float o0 = dist_of(qn[h], acc[4 * j + 2 * h], vn[col]);
      const float o1 = dist_of(qn[h], acc[4 * j + 2 * h + 1], vn[col + 1]);
      if ((n & 1) == 0 && gc + 1 < n) {
        *reinterpret_cast<float2*>(orow + gc) = make_float2(o0, o1);
      } else {
        if (gc < n) orow[gc] = o0;
        if (gc + 1 < n) orow[gc + 1] = o1;
      }
    }
  }
}

// The same 64 x 128 block, computed as store_tile does, into shared
// memory as TMA stores it: four boxes of 64 rows x 32 columns (128 B a
// row, the 16-byte chunk c of row r at c ^ (r % 8), the 128-byte
// swizzle), so a warp's float2 writes meet no bank twice.  `ra` is the
// thread's first row of the half.
template <class T>
__device__ __forceinline__ void stage_tile(const T (&acc)[64], uint8_t* stg,
                                           const T* vn, const T (&qn)[2],
                                           int ra, int quad) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      const float o0 = dist_of(qn[h], acc[4 * j + 2 * h], vn[col]);
      const float o1 = dist_of(qn[h], acc[4 * j + 2 * h + 1], vn[col + 1]);
      const int chunk = 2 * (j % 4) + quad / 2;
      *reinterpret_cast<float2*>(stg + (j / 4) * 8192 + r * 128 +
                                 ((chunk ^ (r & 7)) << 4) + (quad & 1) * 8) =
          make_float2(o0, o1);
    }
  }
}

// kElem: 4 f32, 2 bf16, 1 8-bit integers (kMix: bit 1 set where q is
// s8, else u8; bit 0 for v).  kGran: 0 loads by TMA (f32 where d % 4 ==
// 0, streamed bf16 where d % 8 == 0, 8-bit where d % 16 == 0); 16, 8 or 4
// by cp.async granules of that many bytes, from qg (qlog: streamed f32's
// q lo) and vg.  kStream: d > 128, the query tile's k-slices ride the
// ring with the vectors' instead of staying resident; qn_g holds the
// prologue's query norms.
template <int kElem, int kGran, bool kStream, int kMix>
__global__ void __launch_bounds__(kThreads, 1)
l2dist_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_qlo,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_out,
                    const uint8_t* __restrict__ qg,
                    const uint8_t* __restrict__ qlog,
                    const uint8_t* __restrict__ vg,
                    const float* __restrict__ qn_g,
                    float* __restrict__ out, int b, int n, int d,
                    int tma_out) {
  static_assert(kGran != 0 || kElem != 2 || kStream,
                "resident bf16 loads by cp.async");
  static_assert(kElem != 1 || !kStream, "8-bit rows are at most 128 wide");
  using C = Cfg<kElem, kStream>;
  using T = typename Acc<kElem>::T;
  constexpr bool kBf16 = kElem == 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[C::kNumBars];
  __shared__ T qn_s[kBM];
  __shared__ T vn_s[2][kBN];               // each warpgroup's current tile
  uint8_t* base = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                              smem_u32(smem_raw));
  // the query k-slice s that the products of ring stage st read (resident:
  // slice s of the tile; streamed: the stage's own), and the stage's
  // vector slice; lo parts in f32 only
  auto q_hi = [&](int s, int st) {
    return base + (kStream ? st : s) * kSliceBytes;
  };
  auto q_lo = [&](int s, int st) {
    return base + (kStream ? 2 * C::kStages + st : C::kSlices + s) *
                      kSliceBytes;
  };
  auto v_hi = [&](int st) {
    return base + (C::kBufs * C::kSlices + (kStream ? C::kStages : 0) + st) *
                      kSliceBytes;
  };
  auto v_lo = [&](int st) {
    return base + (kStream ? 3 * C::kStages + st
                           : 2 * C::kSlices + C::kStages + st) *
                      kSliceBytes;
  };
  // half h of warpgroup w's staged tile (resident bf16)
  auto stg = [&](int w, int h) {
    return base + C::kBufs * (C::kSlices + C::kOps * C::kStages) *
                      kSliceBytes +
           (2 * w + h) * kHalfBytes;
  };
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const int t = threadIdx.x;
  const int q0 = blockIdx.y * kBM;
  const int n_vt = (n + kBN - 1) / kBN;
  const int ns = (d + C::kBK - 1) / C::kBK;
  // a TMA load arrives once with its bytes; cp.async, once a producer lane
  constexpr int kLoadArrivals = kGran ? 32 : 1;
  if (t == 0) {
    mbar_init(bar(C::kBarQ), kLoadArrivals);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar(C::kBarFull + st), kLoadArrivals);
      mbar_init(bar(C::kBarEmpty + st), 4);    // the warps of one warpgroup
    }
    mbar_init(bar(C::kBarTurn), 4);
    mbar_init(bar(C::kBarTurn + 1), 4);
    fence_mbar_init();
  }
  __syncthreads();

  if (t >= kConsumers) {                               // producer warp
    // cp.async: its 32 lanes copy; TMA: one lane issues the loads
    const int lane = t - kConsumers;
    if (!kGran && lane != 0) return;
    if constexpr (!kStream) {                  // the resident query tile
      if constexpr (kGran != 0) {
        for (int s = 0; s < ns; ++s)
          copy_slice<kGran, kElem>(smem_u32(q_hi(s, 0)), qg, b, q0, d, s,
                                   lane);
        cp_async_arrive(bar(C::kBarQ));   // once its copies have landed
      } else {
        mbar_expect_tx(bar(C::kBarQ), ns * kSliceBytes);
        for (int s = 0; s < ns; ++s)
          tma_load_2d(smem_u32(q_hi(s, 0)), &map_q, bar(C::kBarQ),
                      s * C::kBK, q0);
      }
    }
    int g = 0;                                         // slices issued
    for (int vt = blockIdx.x; vt < n_vt; vt += gridDim.x) {
      for (int s = 0; s < ns; ++s, ++g) {
        const int st = g % C::kStages;
        if (g >= C::kStages)
          mbar_wait(bar(C::kBarEmpty + st), ((g / C::kStages) - 1) & 1);
        // streamed: one full barrier covers the stage's q and v slices
        if constexpr (kGran != 0) {
          if constexpr (kStream) {
            copy_slice<kGran, kElem>(smem_u32(q_hi(s, st)), qg, b, q0, d, s,
                                     lane);
            if constexpr (!kBf16)
              copy_slice<kGran, kElem>(smem_u32(q_lo(s, st)), qlog, b, q0, d,
                                       s, lane);
          }
          copy_slice<kGran, kElem>(smem_u32(v_hi(st)), vg, n, vt * kBN, d,
                                   s, lane);
          cp_async_arrive(bar(C::kBarFull + st));
        } else {
          const uint32_t full = bar(C::kBarFull + st);
          mbar_expect_tx(full, C::kLoads * kSliceBytes);
          if constexpr (kStream) {
            tma_load_2d(smem_u32(q_hi(s, st)), &map_q, full, s * C::kBK, q0);
            if constexpr (!kBf16)
              tma_load_2d(smem_u32(q_lo(s, st)), &map_qlo, full, s * C::kBK,
                          q0);
          }
          tma_load_2d(smem_u32(v_hi(st)), &map_v, full, s * C::kBK,
                      vt * kBN);
        }
      }
    }
    return;
  }

  // ---- the query tile's norms: resident, both warpgroups take them from
  // the tile (and, in f32, split it); streamed, the prologue's
  if constexpr (kStream) {
    if (t < kBM) qn_s[t] = q0 + t < b ? qn_g[q0 + t] : 0.f;
  } else {
    mbar_wait(bar(C::kBarQ), 0);
    if constexpr (!C::kF32 && kGran != 0) fence_proxy_async();
    T sq[4] = {0, 0, 0, 0};
    for (int s = 0; s < ns; ++s)
      take_slice<kElem, (kMix & 2) != 0, kConsumers>(q_hi(s, 0), q_lo(s, 0),
                                                     t, sq);
    store_norms<kConsumers>(sq, qn_s, t);
  }
  named_sync(1, kConsumers);

  // ---- warpgroup wg: the block's tiles wg, wg + 2, ... (vector tiles
  // blockIdx.x + i * gridDim.x), all 128 queries, in two 64-row halves.
  // The warpgroups take turns: one takes and multiplies its tile's
  // slices while the other writes its finished tile out, so the slices
  // are taken from the ring in the order they were loaded (a wait on a
  // full barrier is never two phases ahead of it).
  const int wg = t / 128, wt = t % 128, lane = t % 32, quad = lane % 4;
  const int ra = 16 * (wt / 32) + lane / 4;   // rows ra, ra + 8 of a half
  const T qn[2][2] = {{qn_s[ra], qn_s[ra + 8]},
                      {qn_s[64 + ra], qn_s[64 + ra + 8]}};
  T* vn = vn_s[wg];
  T acc0[64], acc1[64];                       // query rows 0-63, 64-127
  for (int i = wg; (int)(blockIdx.x + i * gridDim.x) < n_vt; i += 2) {
    const int vt = blockIdx.x + i * gridDim.x;
    if (i > 0) mbar_wait(bar(C::kBarTurn + wg), ((i - 1) / 2) & 1);
    T vsq[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int s = 0; s < ns; ++s) {
      const int g = i * ns + s;               // the slice's place in the ring
      const int st = g % C::kStages;
      mbar_wait(bar(C::kBarFull + st), (g / C::kStages) & 1);
      if constexpr (kGran != 0) fence_proxy_async();   // cp.async's copies
      take_slice<kElem, (kMix & 1) != 0, 128>(v_hi(st), v_lo(st), wt, vsq);
      // f32: every split store is in before the wgmmas read the slice.
      // All: before the last slice's norms, the warpgroup is done with
      // its last epilogue, which read vn.
      if (C::kF32 || s == ns - 1) named_sync(2 + wg, 128);
      if (s == ns - 1) store_norms<128>(vsq, vn, wt);
      // k-step kk reads 32 bytes at kk * 32 of every 128-byte row (8 f32,
      // 16 bf16 or 32 8-bit columns); the second half of the queries
      // starts 64 rows (8 KB) on
      const uint32_t a_hi = smem_u32(q_hi(s, st)), b_hi = smem_u32(v_hi(st));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = kk * 32;
        const int acc = s > 0 || kk > 0;
        const uint64_t bh = desc(b_hi + off, 16, 1024);
        if constexpr (kElem == 1) {
          mma_i8<kMix>(acc0, desc(a_hi + off, 16, 1024), bh, acc);
          mma_i8<kMix>(acc1, desc(a_hi + 8192 + off, 16, 1024), bh, acc);
        } else if constexpr (kBf16) {
          mma_bf16(acc0, desc(a_hi + off, 16, 1024), bh, acc);
          mma_bf16(acc1, desc(a_hi + 8192 + off, 16, 1024), bh, acc);
        } else {
          const uint32_t a_lo = smem_u32(q_lo(s, st));
          const uint64_t bl = desc(smem_u32(v_lo(st)) + off, 16, 1024);
          mma_tf32(acc0, desc(a_hi + off, 16, 1024), bl, acc);
          mma_tf32(acc0, desc(a_lo + off, 16, 1024), bh, 1);
          mma_tf32(acc0, desc(a_hi + off, 16, 1024), bh, 1);
          mma_tf32(acc1, desc(a_hi + 8192 + off, 16, 1024), bl, acc);
          mma_tf32(acc1, desc(a_lo + 8192 + off, 16, 1024), bh, 1);
          mma_tf32(acc1, desc(a_hi + 8192 + off, 16, 1024), bh, 1);
        }
      }
      wgmma_commit();
      if (s > 0) {              // the previous slice's products are done
        wgmma_wait<1>();
        if (lane == 0)
          mbar_arrive(bar(C::kBarEmpty + (g - 1) % C::kStages));
      }
    }
    if (lane == 0) mbar_arrive(bar(C::kBarTurn + (wg ^ 1)));   // its turn
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    if (lane == 0)
      mbar_arrive(bar(C::kBarEmpty + (i * ns + ns - 1) % C::kStages));
    const bool staged = C::kStageBytes && tma_out;
    // the staging is free once the last tile's stores have read it
    if (staged && wt == 0) bulk_wait<0, true>();
    named_sync(2 + wg, 128);                  // the tile's norms are stored
    if (staged) {
      stage_tile(acc0, stg(wg, 0), vn, qn[0], ra, quad);
      stage_tile(acc1, stg(wg, 1), vn, qn[1], ra, quad);
      fence_proxy_async();
      named_sync(2 + wg, 128);
      if (wt == 0) {                          // TMA clips rows and columns
        for (int h = 0; h < 2; ++h)           // past b and n
          for (int box = 0; box < 4; ++box)
            tma_store_2d(&map_out, smem_u32(stg(wg, h)) + box * 8192,
                         vt * kBN + 32 * box, q0 + 64 * h);
        bulk_commit();
      }
    } else {
      store_tile(acc0, out, vn, qn[0], q0 + ra, vt * kBN, quad, b, n);
      store_tile(acc1, out, vn, qn[1], q0 + 64 + ra, vt * kBN, quad, b, n);
    }
  }
  if (C::kStageBytes && tma_out && wt == 0) bulk_wait<0, false>();
}

// The streamed launches' prologue: the squared norm of each query row
// (__fmaf_rn sums over the row's lanes, then across the warp) and, in f32,
// its split into hi = tf32(x) and lo = tf32(x - hi), written once for the
// main kernel to load with the vectors' slices.  One warp a row.
template <bool kBf16>
__global__ void __launch_bounds__(256)
l2dist_prologue_kernel(const void* __restrict__ q, float* __restrict__ qn,
                       float* __restrict__ hi, float* __restrict__ lo, int b,
                       int d) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= b) return;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const long long i = (long long)row * d + c;
    float x;
    if constexpr (kBf16)
      x = __uint_as_float(
          (uint32_t)static_cast<const uint16_t*>(q)[i] << 16);
    else
      x = static_cast<const float*>(q)[i];
    sq = __fmaf_rn(x, x, sq);
    if constexpr (!kBf16) {
      const float h = tf32_rna(x);
      hi[i] = h;
      lo[i] = tf32_rna(__fsub_rn(x, h));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
  if (lane == 0) qn[row] = sq;
}

// Rows of ws bf16 at src (any 2-byte boundary) copied into rows of wd >
// ws (a multiple of 8) at dst, the columns past ws zero: the odd bf16
// widths' route (l2dist_wgmma[bf16,odd]), whose rows lie on 2 bytes,
// which no cp.async granule takes, padded to rows on 16 bytes, which the
// widest granule takes.  A warp a row (as many warps as rows, up to 2^23),
// each lane one 4-byte word of it at a time: both the reads and the
// writes run along the row.
__global__ void __launch_bounds__(256)
l2dist_pad_rows_kernel(const uint16_t* __restrict__ src,
                       uint32_t* __restrict__ dst, int rows, int ws,
                       int wd) {
  const int half = wd / 2, lane = threadIdx.x & 31;
  for (long long r = blockIdx.x * 8LL + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * 8LL) {
    const uint16_t* s = src + r * ws;
    uint32_t* o = dst + r * half;
    for (int c = lane; c < half; c += 32) {
      const uint32_t lo = 2 * c < ws ? __ldg(s + 2 * c) : 0u;
      const uint32_t hi = 2 * c + 1 < ws ? __ldg(s + 2 * c + 1) : 0u;
      o[c] = lo | (hi << 16);
    }
  }
}

cudaError_t pad_rows(const void* src, const void* dst, int rows, int ws,
                     int wd, cudaStream_t st) {
  const int blocks = (rows + 7) / 8 < (1 << 20) ? (rows + 7) / 8 : 1 << 20;
  l2dist_pad_rows_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const uint16_t*>(src),
      static_cast<uint32_t*>(const_cast<void*>(dst)), rows, ws, wd);
  return cudaGetLastError();
}

// (rows, d) f32, bf16 or 8-bit, row-major, boxes of 128 rows x 128
// bytes (32 f32, 64 bf16 or 128 8-bit columns), 128-byte swizzle; rows
// past `rows` and columns past d read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int d,
              int elem_bytes) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), 128};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out (b, n) f32 as 32-column x 64-row boxes, 128-byte swizzle: the TMA
// stores of the staged tiles; needs n % 4 == 0 (a 16-byte row stride)
bool make_out_map(CUtensorMap* map, float* out, int b, int n) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one launch's tensor maps, pointers and sizes
struct Launch {
  CUtensorMap mq, mqlo, mv, mo;   // TMA loads: q (or its hi), q lo, v; out
  const void *q, *qlo, *v;        // streamed f32: q's hi and lo parts
  const float* qn;                // streamed: the query norms
  float* out;
  int b, n, d, grid_x, tma_out;
};

template <int kElem, int kGran, bool kStream, int kMix = 0>
cudaError_t launch(const Launch& a, cudaStream_t stream) {
  constexpr int smem = Cfg<kElem, kStream>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      l2dist_wgmma_kernel<kElem, kGran, kStream, kMix>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.grid_x, (a.b + kBM - 1) / kBM);
  l2dist_wgmma_kernel<kElem, kGran, kStream, kMix>
      <<<grid, kThreads, smem, stream>>>(
          a.mq, a.mqlo, a.mv, a.mo, static_cast<const uint8_t*>(a.q),
          static_cast<const uint8_t*>(a.qlo),
          static_cast<const uint8_t*>(a.v), a.qn, a.out, a.b, a.n, a.d,
          a.tma_out);
  return cudaGetLastError();
}

// the resident query tile up to d = 128, streamed above, for the cp.async
// granule kGran (f32: 4, bf16: 2)
template <int kElem, int kGran>
cudaError_t launch_d(const Launch& a, cudaStream_t stream) {
  return a.d > kMaxD ? launch<kElem, kGran, true>(a, stream)
                     : launch<kElem, kGran, false>(a, stream);
}

// 8-bit rows (d <= 128, d % 4 == 0): by TMA where d % 16 == 0, else by
// the widest cp.async granule the row stride allows
template <int kMix>
cudaError_t launch_i8(const Launch& a, cudaStream_t stream) {
  if (a.d % 16 == 0) return launch<1, 0, false, kMix>(a, stream);
  if (a.d % 8 == 0) return launch<1, 8, false, kMix>(a, stream);
  return launch<1, 4, false, kMix>(a, stream);
}

}  // namespace

// queries (b, d) and vectors (n, d), both f32 (kind = 0; loaded by TMA
// where d % 4 == 0, else by 4-byte cp.async granules), both bf16 (kind =
// 1; d even, loaded by cp.async, streamed with d % 8 == 0 by TMA) or both
// 8-bit integers (kind = 2 + 2 * (q is s8) + (v is s8), else u8; d <= 128
// with d % 4 == 0, loaded by TMA where d % 16 == 0, else by 8- or 4-byte
// cp.async granules), row-major, each 16-byte
// aligned, any d (the query tile resident up to 128, streamed above); out
// (b, n) f32; grid_x blocks for each 128-query tile (l2dist/ops.py::
// l2_plan).  Above d = 128, scratch (16-byte aligned) takes the
// prologue's output: the b query norms, padded to a multiple of 4, then
// in f32 q's hi and lo parts (b x d each); null otherwise.  q_odd and
// v_odd: null, or (the odd bf16 widths) rows of d_odd bf16 on any 2-byte
// boundary, copied first into queries and vectors (rows of d, a multiple
// of 8, the columns past d_odd zero, which add nothing to any sum).
// Returns a cudaError_t.
extern "C" int l2dist_wgmma(const void* queries, const void* vectors,
                            const void* q_odd, const void* v_odd,
                            float* out, float* scratch, int b, int n, int d,
                            int d_odd, int grid_x, int kind, void* stream) {
  const bool streamed = d > kMaxD;
  const bool odd = q_odd != nullptr;
  const bool bf16 = kind == 1, i8 = kind >= 2;
  const int elem = i8 ? 1 : bf16 ? 2 : 4;
  if (b < 1 || n < 1 || d < 1 || kind < 0 || kind > 5 || (bf16 && d % 2) ||
      (i8 && (streamed || d % 4 || odd)) || grid_x < 1 ||
      (b + kBM - 1) / kBM > 65535 || (streamed && !scratch) ||
      (odd && (!bf16 || !v_odd || d % 8 || d_odd < 1 || d_odd >= d)) ||
      ((reinterpret_cast<uintptr_t>(queries) |
        reinterpret_cast<uintptr_t>(vectors) |
        reinterpret_cast<uintptr_t>(scratch)) & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (odd) {                           // the padded copies first
    cudaError_t e = pad_rows(q_odd, queries, b, d_odd, d, st);
    if (e == cudaSuccess) e = pad_rows(v_odd, vectors, n, d_odd, d, st);
    if (e != cudaSuccess) return (int)e;
  }
  Launch a = {};
  a.q = queries;
  a.v = vectors;
  a.out = out;
  a.b = b;
  a.n = n;
  a.d = d;
  a.grid_x = grid_x;
  if (streamed) {
    float* hi = scratch + ((b + 3) & ~3);
    float* lo = hi + (long long)b * d;
    if (bf16)
      l2dist_prologue_kernel<true><<<(b + 7) / 8, 256, 0, st>>>(
          queries, scratch, hi, lo, b, d);
    else
      l2dist_prologue_kernel<false><<<(b + 7) / 8, 256, 0, st>>>(
          queries, scratch, hi, lo, b, d);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    a.qn = scratch;
    if (!bf16) {
      a.q = hi;
      a.qlo = lo;
    }
  }
  // TMA loads where rows lie on 16 bytes: f32 with d % 4 == 0, streamed
  // bf16 with d % 8 == 0, 8-bit with d % 16 == 0 (resident bf16 loads by
  // cp.async throughout)
  const bool tma_in = i8     ? d % 16 == 0
                      : bf16 ? streamed && d % 8 == 0
                             : d % 4 == 0;
  if (tma_in && (!make_map(&a.mq, a.q, b, d, elem) ||
                 !make_map(&a.mv, vectors, n, d, elem) ||
                 (streamed && !bf16 &&
                  !make_map(&a.mqlo, a.qlo, b, d, elem))))
    return (int)cudaErrorInvalidValue;
  // resident bf16 and 8-bit write their tiles by TMA where out's rows
  // start on 16 bytes
  a.tma_out = elem < 4 && !streamed && n % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  if (a.tma_out && !make_out_map(&a.mo, out, b, n))
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 2: return (int)launch_i8<0>(a, st);
    case 3: return (int)launch_i8<1>(a, st);
    case 4: return (int)launch_i8<2>(a, st);
    case 5: return (int)launch_i8<3>(a, st);
    default: break;
  }
  if (!bf16)
    return (int)(tma_in ? launch_d<4, 0>(a, st) : launch_d<4, 4>(a, st));
  if (tma_in) return (int)launch<2, 0, true>(a, st);
  // else the widest cp.async granule the row stride (2 d bytes) allows
  if (d % 8 == 0) return (int)launch<2, 16, false>(a, st);
  if (d % 4 == 0) return (int)launch_d<2, 8>(a, st);
  return (int)launch_d<2, 4>(a, st);
}
