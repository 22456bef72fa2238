// Dense batch ADC scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pq_adc/pq_adc.py::
// pq_adc_scan_batch (_adc_batch_kernel): codes (N, M) uint8 and the LUTs
// of B queries (B, M, K) f32 give ADC distances (B, N) f32,
//     out[b, n] = sum_m luts[b, m, codes[n, m]],
// added in order m = 0, 1, ... from 0.0 (the plain version's order,
// ref.py::pq_adc_batch_ref), one rounding per add.
//
// What bounds it on an H100 SXM: the shared-memory lookups, not HBM.  At
// the serving window (B = 64 queries, a 32,768-row bucket, M = 32) it
// moves 1 MB of codes, 2 MB of LUTs and 8 MB of output, 0.0034 ms at
// 3.35 TB/s, but makes B*N*M = 67M random lookups into 1 KB tables.  An
// SM serves one shared-memory wavefront a clock: 32 lookups without bank
// conflicts (8 us over 132 SMs at 1.98 GHz), but a warp whose 32 lanes
// look up 32 random codes meets about 3.5-way conflicts (about 28 us).
//
// Design: the TPU kernel keeps all B LUTs in VMEM (2 MB at B = 64) and
// streams code tiles once.  A Hopper block has at most 227 KB of shared
// memory and one LUT is M*K*4 = 32 KB at M = 32, so a block holds one tile
// of at most kMaxQ queries' LUTs, the queries split into `tiles` tiles
// whose sizes differ by at most one (6 or 7 at B = 64).  The grid is one
// wave of one block per SM (ops.py::dense_plan sizes it): grid.y blocks
// walk the tiles, grid.x blocks stride over the rows of each, so a block
// fills its LUT tile once per tile it owns and then scans N / grid.x rows.
// The fill is one asynchronous bulk copy per query (cp.async.bulk into
// shared memory, completion counted in bytes on an mbarrier) when the
// tile is 16-byte aligned, else 4-byte cp.async; each thread loads its
// first code row before it waits for the fill.  1,024 threads a block (32
// warps an SM) keep enough lookups in flight to hide their latency.
// Eight lanes share a row, lane q summing query q's distance, so a warp
// scans four rows at once; the lanes of a row read the same (m, code)
// entry of up to seven LUTs, which a pad of kPad floats after each LUT
// puts in seven different banks.  Four rows then conflict only where
// their codes agree mod 4: about 2.1 wavefronts for 28 lookups (13 a
// clock, about 20 us at the serving window).  A row's codes are read as
// 16-byte vectors when M is a multiple of 16 (the eight lanes' reads of
// one row coalesce); a lane's stores of consecutive rows fill 16 bytes
// of its query's output row at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxQ = 8;             // queries a tile holds (ops.py)
constexpr int kGroup = 8;            // lanes on one row: one a query
constexpr int kRowsPerPass = kThreads / kGroup;
constexpr int kPad = 4;              // floats between two queries' LUTs

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// waits for the phase of the given parity to complete; traps after about
// ten seconds (a lost arrival or copy) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// Copies the nq LUTs of one tile (nq * mk floats from src) into lut_s,
// each LUT kPad floats after the last, asynchronously; returns when the
// copy has landed.  Called by every
// thread of the block, after every thread is done with the previous tile.
__device__ __forceinline__ void fill_tile(float* lut_s, const float* src,
                                          int nq, int mk, uint64_t* bar,
                                          uint32_t parity) {
  const uint32_t bytes = (uint32_t)mk * 4u;
  const bool bulk = (bytes & 15u) == 0 &&
                    (reinterpret_cast<uintptr_t>(src) & 15u) == 0;
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint32_t b = smem_u32(bar);
      // the block's earlier generic reads of lut_s come before these
      // async-proxy writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(bytes * (uint32_t)nq) : "memory");
      for (int q = 0; q < nq; ++q)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            ::"r"(smem_u32(lut_s + (size_t)q * (mk + kPad))),
              "l"(src + (size_t)q * mk), "r"(bytes), "r"(b)
            : "memory");
    }
    mbar_wait(smem_u32(bar), parity);
  } else {
    for (int i = threadIdx.x; i < nq * mk; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   ::"r"(smem_u32(lut_s + i + (i / mk) * kPad)), "l"(src + i)
                   : "memory");
    asm volatile("cp.async.commit_group;\n"
                 "cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads, 1)
adc_scan_batch_kernel(const uint8_t* __restrict__ codes,
                      const float* __restrict__ luts,
                      float* __restrict__ out, int n, int m, int k, int b,
                      int tiles) {
  extern __shared__ __align__(16) float lut_s[];   // (nq, m*k + kPad)
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(smem_u32(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int mk = m * k;
  const int q = threadIdx.x % kGroup;              // query within the tile
  const long long stride = (long long)gridDim.x * kRowsPerPass;
  uint32_t parity = 0;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int q0 = (int)((long long)b * tile / tiles);
    const int nq = (int)((long long)b * (tile + 1) / tiles) - q0;
    long long r =
        (long long)blockIdx.x * kRowsPerPass + threadIdx.x / kGroup;
    // the first row's first 32 codes travel while the LUT tile fills
    uint4 first0 = make_uint4(0, 0, 0, 0), first1 = first0;
    if (kVec16 && r < n) {
      const uint4* row = reinterpret_cast<const uint4*>(codes + r * m);
      first0 = __ldg(row);
      if (m > 16) first1 = __ldg(row + 1);
    }
    __syncthreads();                 // every thread is done with lut_s
    fill_tile(lut_s, luts + (size_t)q0 * mk, nq, mk, &bar, parity);
    parity ^= 1u;
    if (q >= nq) continue;           // a lane of a tile's missing query
    const float* lut = lut_s + (size_t)q * (mk + kPad);

    for (bool head = true; r < n; r += stride, head = false) {
      float acc = 0.f;
      const uint8_t* row = codes + r * m;
      if (kVec16) {
        for (int c = 0; c < m; c += 16) {
          const uint4 v =
              head && c == 0    ? first0
              : head && c == 16 ? first1
                                : __ldg(reinterpret_cast<const uint4*>(row + c));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
          const float* l = lut + c * k;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            acc = __fadd_rn(acc, l[j * k + ((w[j >> 2] >> (8 * (j & 3))) &
                                            0xff)]);
        }
      } else {
        for (int c = 0; c < m; ++c)
          acc = __fadd_rn(acc, lut[c * k + __ldg(row + c)]);
      }
      out[(size_t)(q0 + q) * n + r] = acc;
    }
  }
}

template <bool kVec16>
cudaError_t launch(const uint8_t* codes, const float* luts, float* out,
                   int n, int m, int k, int b, int tiles, int grid_x,
                   int grid_y, cudaStream_t stream) {
  const int q_max = (b + tiles - 1) / tiles;
  const size_t smem = (size_t)q_max * (m * k + kPad) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      adc_scan_batch_kernel<kVec16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  adc_scan_batch_kernel<kVec16>
      <<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(
          codes, luts, out, n, m, k, b, tiles);
  return cudaGetLastError();
}

}  // namespace

// tiles: query tiles, each of ceil or floor(b / tiles) <= kMaxQ queries
// (ceil(b / tiles) * (m * k + 4) * 4 bytes of shared memory); grid_x blocks
// stride over the rows of a tile, grid_y blocks walk the tiles
// (ops.py::dense_plan keeps grid_x * grid_y within one wave); vec16:
// m % 16 == 0 and codes 16-byte aligned.  Returns a cudaError_t.
extern "C" int adc_scan_batch(const uint8_t* codes, const float* luts,
                              float* out, int n, int m, int k, int b,
                              int tiles, int grid_x, int grid_y, int vec16,
                              void* stream) {
  if (n < 1 || b < 1 || tiles < 1 || tiles > b ||
      (b + tiles - 1) / tiles > kMaxQ || grid_x < 1 || grid_y < 1 ||
      grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec16 ? launch<true>(codes, luts, out, n, m, k, b, tiles,
                                    grid_x, grid_y, s)
                     : launch<false>(codes, luts, out, n, m, k, b, tiles,
                                     grid_x, grid_y, s));
}
