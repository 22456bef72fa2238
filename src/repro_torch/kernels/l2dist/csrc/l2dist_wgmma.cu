// Exact squared L2 distances on Hopper's tensor cores (sm_90a), f32.
//
// Replaces the Pallas TPU kernel repro/kernels/l2dist/l2dist.py::l2dist
// (_l2_kernel) for f32 inputs of width d % 4 == 0, d <= 128
// (l2dist/ops.py::l2_kernel; bf16 and other widths run on l2dist.cu):
//     out[b, n] = (|q_b|^2 - 2 q_b.v_n) + |v_n|^2        (B, N) f32.
//
// What bounds it on an H100 SXM: bytes.  At the ground-truth chunk
// (B = 256, N = 2^20, D = 128) it must read q and v once and write the
// output once, (256*128 + 2^20*128 + 256*2^20) * 4 B = 1.61 GB: 0.481 ms
// at 3.35 TB/s; the 1.07 GB output is most of it.  Its product, in
// 3xTF32, is 3 * 68.7 GFLOP: 0.417 ms at the dense TF32 tensor-core rate
// (495 TFLOP/s).  The f32 CUDA cores alone could not go below 1.03 ms.
//
// The product runs on wgmma m64n128k8 in TF32, three times per k-step:
// each operand is split as hi = tf32(x) (round to nearest), lo = tf32(x -
// hi), and hi*lo + lo*hi + hi*hi is summed into the f32 accumulator (the
// lo*lo term is below f32's resolution of the sum).  On integer data
// below 2^11 (SIFT's uint8) lo is 0, every product and partial sum is an
// integer below 2^24, so the result equals the plain version's bit for
// bit.  The norms are __fmaf_rn sums of squares taken from the tiles
// the kernel reads; the epilogue rounds each step, as
// ref.py::l2dist_ref does.
//
// Design: a persistent grid, one block an SM (l2dist/ops.py::l2_plan):
// block (x, y) owns the 128 queries of tile y and walks the 128-vector
// tiles x, x + grid_x, ...; the blocks of one x walk the same vector
// tiles at the same time, so each tile comes from HBM about once.  A
// producer warp loads the query tile once (all of d: 32-column, 128-byte
// swizzled k-slices) and streams the vector tiles' k-slices through a
// three-stage ring, all by TMA behind full / empty mbarriers; TMA fills
// rows and columns past B, N and d with zeros.  The two consumer
// warpgroups split the query tile once and then take the block's vector
// tiles in turns (ping-pong): one splits each slice of its tile that has
// landed (hi in place, lo into a second buffer of the same layout),
// fences the generic-proxy stores for the async proxy, synchronises on a
// named barrier and issues the slice's 24 wgmmas (two 64-query halves),
// splitting the next slice while they run, and hands a slice back to
// the producer once its wgmmas are done; meanwhile the other writes its
// finished 128 x 128 tile out as float2 pairs straight from the
// accumulators' layout (a warp writes whole 32-byte row segments).  So
// the output, most of the bound, leaves while the tensor cores work.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                   // queries per block
constexpr int kBN = 128;                   // vectors per tile
constexpr int kBK = 32;                    // floats of one 128-byte k-slice
constexpr int kMaxD = 128;                 // the resident query tile's width
constexpr int kSlices = kMaxD / kBK;
constexpr int kSliceBytes = 128 * kBK * 4; // 128 rows x 128 B, q or v
constexpr int kStages = 3;                 // depth of the vector-slice ring
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
// dynamic shared memory: q hi | q lo (kSlices each) | v hi | v lo
// (kStages each), 1024-byte aligned: 224 KB of the 227 KB
constexpr int kSmemBytes =
    (2 * kSlices + 2 * kStages) * kSliceBytes + 1024;
// barriers: the q tile, full [stage], empty [stage] (a stage goes to one
// warpgroup), turn [warpgroup] (whose products run next)
constexpr int kBarQ = 0, kBarFull = 1, kBarEmpty = 1 + kStages,
              kBarTurn = 1 + 2 * kStages, kNumBars = 3 + 2 * kStages;

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d (64 x 128, f32) (+)= A (64 x 8, smem) * B (128 x 8, smem)^T in TF32,
// both K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", %64, %65, p, 1, 1;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// Splits one landed 128-row k-slice (1024 chunks of 16 bytes) among kT
// threads: x -> hi = tf32(x) in place and lo = tf32(x - hi) at the same
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

// the eight threads of a row add their sums; the first stores the norm
template <int kT>
__device__ __forceinline__ void store_norms(const float (&sq)[1024 / kT],
                                            float* norm, int t) {
#pragma unroll
  for (int i = 0; i < 1024 / kT; ++i) {
    float s = sq[i];
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 4));
    if ((t & 7) == 0) norm[t / 8 + (kT / 8) * i] = s;
  }
}

// named barriers: 1 for both consumer warpgroups, 2 + w for warpgroup w
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Writes the 64 x 128 block of a finished tile held in acc: element
// 4j + 2h + e is (row + 8h, column 8j + 2 quad + e), `row` this thread's
// first global row, `v0` the tile's first vector: out = (|q|^2 - 2 q.v) +
// |v|^2, each step rounded.  A warp writes whole 32-byte row segments,
// as float2 pairs where n is even.
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           float* __restrict__ out,
                                           const float* vn,
                                           const float (&qn)[2], int row,
                                           int v0, int quad, int b, int n) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= b) continue;
    float* orow = out + (long long)(row + 8 * h) * n;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      const int gc = v0 + col;
      const float o0 = __fadd_rn(
          __fsub_rn(qn[h], __fmul_rn(2.f, acc[4 * j + 2 * h])), vn[col]);
      const float o1 = __fadd_rn(
          __fsub_rn(qn[h], __fmul_rn(2.f, acc[4 * j + 2 * h + 1])),
          vn[col + 1]);
      if ((n & 1) == 0 && gc + 1 < n) {
        *reinterpret_cast<float2*>(orow + gc) = make_float2(o0, o1);
      } else {
        if (gc < n) orow[gc] = o0;
        if (gc + 1 < n) orow[gc + 1] = o1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
l2dist_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_v,
                    float* __restrict__ out, int b, int n, int d) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  __shared__ float qn_s[kBM];
  __shared__ float vn_s[2][kBN];           // each warpgroup's current tile
  uint8_t* base = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                              smem_u32(smem_raw));
  auto q_hi = [&](int s) {
    return reinterpret_cast<float4*>(base + s * kSliceBytes);
  };
  auto q_lo = [&](int s) {
    return reinterpret_cast<float4*>(base + (kSlices + s) * kSliceBytes);
  };
  auto v_hi = [&](int st) {
    return reinterpret_cast<float4*>(base +
                                     (2 * kSlices + st) * kSliceBytes);
  };
  auto v_lo = [&](int st) {
    return reinterpret_cast<float4*>(
        base + (2 * kSlices + kStages + st) * kSliceBytes);
  };
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const int t = threadIdx.x;
  const int q0 = blockIdx.y * kBM;
  const int n_vt = (n + kBN - 1) / kBN;
  const int ns = (d + kBK - 1) / kBK;
  if (t == 0) {
    mbar_init(bar(kBarQ), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar(kBarFull + st), 1);
      mbar_init(bar(kBarEmpty + st), 4);    // the warps of one warpgroup
    }
    mbar_init(bar(kBarTurn), 4);
    mbar_init(bar(kBarTurn + 1), 4);
    fence_mbar_init();
  }
  __syncthreads();

  if (t >= kConsumers) {                               // producer warp
    if (t == kConsumers) {
      mbar_expect_tx(bar(kBarQ), ns * kSliceBytes);
      for (int s = 0; s < ns; ++s)
        tma_load_2d(smem_u32(q_hi(s)), &map_q, bar(kBarQ), s * kBK, q0);
      int g = 0;                                       // slices issued
      for (int vt = blockIdx.x; vt < n_vt; vt += gridDim.x) {
        for (int s = 0; s < ns; ++s, ++g) {
          const int st = g % kStages;
          if (g >= kStages)
            mbar_wait(bar(kBarEmpty + st), ((g / kStages) - 1) & 1);
          mbar_expect_tx(bar(kBarFull + st), kSliceBytes);
          tma_load_2d(smem_u32(v_hi(st)), &map_v, bar(kBarFull + st),
                      s * kBK, vt * kBN);
        }
      }
    }
    return;
  }

  // ---- both warpgroups: the query tile, split once
  mbar_wait(bar(kBarQ), 0);
  {
    float sq[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < ns; ++s) split_slice<kConsumers>(q_hi(s), q_lo(s), t,
                                                         sq);
    store_norms<kConsumers>(sq, qn_s, t);
  }
  fence_proxy_async();
  named_sync(1, kConsumers);

  // ---- warpgroup wg: the block's tiles wg, wg + 2, ... (vector tiles
  // blockIdx.x + i * gridDim.x), all 128 queries, in two 64-row halves.
  // The warpgroups take turns: one splits and multiplies its tile's
  // slices while the other writes its finished tile out, so the slices
  // are taken from the ring in the order they were loaded (a wait on a
  // full barrier is never two phases ahead of it).
  const int wg = t / 128, wt = t % 128, lane = t % 32, quad = lane % 4;
  const int ra = 16 * (wt / 32) + lane / 4;   // rows ra, ra + 8 of a half
  const float qn[2][2] = {{qn_s[ra], qn_s[ra + 8]},
                          {qn_s[64 + ra], qn_s[64 + ra + 8]}};
  float* vn = vn_s[wg];
  float acc0[64], acc1[64];                   // query rows 0-63, 64-127
  for (int i = wg; (int)(blockIdx.x + i * gridDim.x) < n_vt; i += 2) {
    const int vt = blockIdx.x + i * gridDim.x;
    if (i > 0) mbar_wait(bar(kBarTurn + wg), ((i - 1) / 2) & 1);
    float vsq[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < ns; ++s) {
      const int g = i * ns + s;               // the slice's place in the ring
      const int st = g % kStages;
      mbar_wait(bar(kBarFull + st), (g / kStages) & 1);
      split_slice<128>(v_hi(st), v_lo(st), wt, vsq);
      fence_proxy_async();
      named_sync(2 + wg, 128);
      // after the barrier: the warpgroup is done with its last epilogue
      if (s == ns - 1) store_norms<128>(vsq, vn, wt);
      // k-step kk reads 32 bytes at kk * 32 of every 128-byte row; the
      // second half of the queries starts 64 rows (8 KB) on
      const uint32_t a_hi = smem_u32(q_hi(s)), a_lo = smem_u32(q_lo(s));
      const uint32_t b_hi = smem_u32(v_hi(st)), b_lo = smem_u32(v_lo(st));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint32_t off = kk * 32;
        const uint64_t bh = desc(b_hi + off, 16, 1024);
        const uint64_t bl = desc(b_lo + off, 16, 1024);
        mma_tf32(acc0, desc(a_hi + off, 16, 1024), bl, s > 0 || kk > 0);
        mma_tf32(acc0, desc(a_lo + off, 16, 1024), bh, 1);
        mma_tf32(acc0, desc(a_hi + off, 16, 1024), bh, 1);
        mma_tf32(acc1, desc(a_hi + 8192 + off, 16, 1024), bl,
                 s > 0 || kk > 0);
        mma_tf32(acc1, desc(a_lo + 8192 + off, 16, 1024), bh, 1);
        mma_tf32(acc1, desc(a_hi + 8192 + off, 16, 1024), bh, 1);
      }
      wgmma_commit();
      if (s > 0) {              // the previous slice's products are done
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(bar(kBarEmpty + (g - 1) % kStages));
      }
    }
    if (lane == 0) mbar_arrive(bar(kBarTurn + (wg ^ 1)));   // its turn
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    if (lane == 0) mbar_arrive(bar(kBarEmpty + (i * ns + ns - 1) % kStages));
    named_sync(2 + wg, 128);                  // the tile's norms are stored
    store_tile(acc0, out, vn, qn[0], q0 + ra, vt * kBN, quad, b, n);
    store_tile(acc1, out, vn, qn[1], q0 + 64 + ra, vt * kBN, quad, b, n);
  }
}

// (rows, d) f32, row-major, 32-column x 128-row boxes, 128-byte swizzle;
// rows past `rows` and columns past d read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int d) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, 128};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// queries (b, d) and vectors (n, d), f32, row-major, each 16-byte aligned,
// d % 4 == 0 and d <= 128; out (b, n) f32; grid_x blocks for each
// 128-query tile (l2dist/ops.py::l2_plan).  Returns a cudaError_t.
extern "C" int l2dist_wgmma(const void* queries, const void* vectors,
                            float* out, int b, int n, int d, int grid_x,
                            void* stream) {
  if (b < 1 || n < 1 || d < 4 || d > kMaxD || d % 4 || grid_x < 1 ||
      (b + kBM - 1) / kBM > 65535 ||
      ((reinterpret_cast<uintptr_t>(queries) |
        reinterpret_cast<uintptr_t>(vectors)) & 15u))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mv;
  if (!make_map(&mq, queries, b, d) || !make_map(&mv, vectors, n, d))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      l2dist_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(grid_x, (b + kBM - 1) / kBM);
  l2dist_wgmma_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(mq, mv, out, b,
                                                             n, d);
  return (int)cudaGetLastError();
}
