// Single-query ADC scan + running top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pq_adc/pq_adc.py::
// pq_adc_scan_topk (_adc_topk_kernel).  Inputs: codes (N, M) uint8, one
// query's LUT (M, K) f32.  A row's distance is sum_m lut[m, code_m] added
// in order from 0.0 (adc_common.cuh::adc_row, ref.py::pq_adc_ref's
// order), and the public result (pq_adc/ops.py::pq_adc_topk) is the first
// min(topk, N) of a stable (dist, row) sort of all N rows.  The TPU kernel
// gets there block by block: it scores 2,048 rows, sets the rows past N to
// +inf and keeps the block's top-k.
//
// What bounds it on an H100 SXM: bytes.  At N = 10M, M = 32, topk = 512 it
// must read 320 MB of codes and write 512 pairs: 0.096 ms at 3.35 TB/s,
// against 0.005 ms for its N*M f32 adds at 67 TFLOP/s.  Its 320M LUT
// lookups, random within each 1 KB LUT row (about 3.5-way bank conflicts),
// hold the scan itself near adc_scan.cu's pace.  The port's first form
// followed the TPU grid, one block per 2,048 rows, bitonic-sorted all
// 2,048 keys of every block (66 passes behind a barrier each) and wrote
// 512 pairs a block for the wrapper to merge: 11x its bound.
//
// Design: a persistent grid (pq_adc/ops.py::topk_plan, two blocks an SM).
// Block i owns rows [i*rows, (i+1)*rows), in ascending order across
// blocks, and copies the LUT into shared memory once.  It keeps its best
// tk (<= 2,048) keys so far in a shared buffer of 4,096 (dist, row) slots
// and their worst, tau (the block's tk-th key; (+inf, INT_MAX) until tk
// keys are in), beside it.  A round scores 2,048 rows, four a thread:
// with M = 16 or 32 (16-byte aligned) a thread loads all four rows' codes
// before it scores any, so four rows' loads are in flight at once.  A row
// whose key is below tau is appended to the buffer (one atomic a warp);
// keys compare as (dist, row), so ties keep the lower row.  One barrier a
// round sums the warps' appends.  When fewer free slots are left than a
// round can fill, the block compacts: a radix select finds the tk-th key
// (eight passes of 8-bit digits over the keys as ordered integers, each a
// shared histogram and one warp's scan), the tk keys up to it move to the
// front, unordered, and tau becomes it.  No sort runs until the block's
// end, where one bitonic sort orders its tk keys.  A bitonic sort at every
// compaction instead took 0.19 ms of 0.37 at 10M rows (kernel_ab.py, H100
// 80GB HBM3, 700 W): its shared-memory traffic competed with the other
// block's LUT lookups.
// Rows in random order pass tau ever more rarely, so a block compacts
// about three times at 10M rows; rows in descending distance pass every
// time and compact every round or two, slower but still exact.  The block
// writes its tk pairs ordered by (dist, row), the last block padded with
// (+inf, INT_MAX) where it holds fewer than tk rows; the wrapper merges
// grid * tk pairs with a stable sort, whose order (blocks in ascending
// rows, each by (dist, row)) gives the (dist, row) order of all N rows.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "adc_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 4;
constexpr int kRound = kThreads * kRowsPerThread;   // rows a round
constexpr int kBuf = 2 * kRound;                    // candidate slots
constexpr int kMaxTk = kBuf - kRound;               // keys a block keeps
constexpr int kWarps = kThreads / 32;

// (dist, row) as one unsigned integer of the same order: the float's bits
// made monotone (-0 taken as +0; distances are never NaN), then the row
__device__ __forceinline__ uint64_t key_bits(float d, int r) {
  uint32_t u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (uint32_t)r;
}
__device__ __forceinline__ float key_dist(uint64_t key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// What compact() shares between its threads.
struct Select {
  unsigned hist[256];
  uint64_t prefix;        // the digits of the tk-th key found so far
  unsigned need;          // its rank among the keys that match them
  int kept;
};

// All threads, c > tk keys in the buffer (all distinct: rows differ):
// finds the tk-th smallest by a radix select, eight digits of 8 bits from
// the top of key_bits (each pass a histogram of the keys that match the
// digits found so far, then one warp finds the next digit), moves the tk
// keys up to it to the front of the buffer, unordered, and sets tau to
// it.  Returns tk.
__device__ __noinline__ int compact(float* key_d, int* key_p, int c, int tk,
                                    Select& sel, int* cnt, float* tau_d,
                                    int* tau_p) {
  const int t = threadIdx.x, lane = t % 32;
  for (int i = t; i < 256; i += kThreads) sel.hist[i] = 0;
  if (t == 0) {
    sel.prefix = 0;
    sel.need = tk;
    sel.kept = 0;
  }
  __syncthreads();
  for (int shift = 56; shift >= 0; shift -= 8) {
    const uint64_t prefix = sel.prefix;
    for (int i = t; i < c; i += kThreads) {
      const uint64_t key = key_bits(key_d[i], key_p[i]);
      if (shift == 56 || (key ^ prefix) >> (shift + 8) == 0)
        atomicAdd(&sel.hist[(key >> shift) & 255], 1u);
    }
    __syncthreads();
    if (t < 32) {                      // lane takes digits 8 lane .. + 7
      unsigned h[8], sum = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        h[b] = sel.hist[8 * lane + b];
        sel.hist[8 * lane + b] = 0;    // ready for the next pass
        sum += h[b];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned need = sel.need;
      unsigned below = incl - sum;
      if (below < need && need <= incl) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (below + h[b] >= need) {
            sel.prefix = prefix | ((uint64_t)(8 * lane + b) << shift);
            sel.need = need - below;
            break;
          }
          below += h[b];
        }
      }
    }
    __syncthreads();
  }
  const uint64_t tau = sel.prefix;     // the tk-th key itself
  float d[kBuf / kThreads];
  int r[kBuf / kThreads];
#pragma unroll
  for (int j = 0; j < kBuf / kThreads; ++j) {
    const int i = t + j * kThreads;
    d[j] = i < c ? key_d[i] : INFINITY;
    r[j] = i < c ? key_p[i] : -1;
  }
  __syncthreads();                     // every key read before any moves
#pragma unroll
  for (int j = 0; j < kBuf / kThreads; ++j) {
    if (r[j] >= 0 && key_bits(d[j], r[j]) <= tau) {
      const int slot = atomicAdd(&sel.kept, 1);
      key_d[slot] = d[j];
      key_p[slot] = r[j];
    }
  }
  if (t == 0) {
    *cnt = tk;
    *tau_d = key_dist(tau);
    *tau_p = (int)(uint32_t)tau;
  }
  __syncthreads();
  return tk;
}

// kChunks: the M / 16 code chunks of a row, all loaded before any row of
// the round is scored (M % 16 == 0, codes 16-byte aligned); 0 for any
// other M, scored by adc_row a byte at a time.
template <int kChunks>
__global__ void __launch_bounds__(kThreads, 2)
adc_scan_topk_kernel(const uint8_t* __restrict__ codes,
                     const float* __restrict__ lut, float* __restrict__ vals,
                     int32_t* __restrict__ ids, int n, int m, int k, int rows,
                     int tk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);        // m*k
  float* key_d = lut_s + m * k;                         // kBuf
  int* key_p = reinterpret_cast<int*>(key_d + kBuf);    // kBuf
  __shared__ int cnt;                                   // slots taken
  __shared__ float tau_d;
  __shared__ int tau_p;
  __shared__ int warp_cnt[2][kWarps];   // a round's appends, by parity
  __shared__ Select sel;
  for (int i = threadIdx.x; i < m * k; i += kThreads) lut_s[i] = lut[i];
  if (threadIdx.x == 0) {
    cnt = 0;
    tau_d = INFINITY;
    tau_p = INT_MAX;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * rows;
  const int r1 = (int)min((long long)n, (long long)r0 + rows);
  int c = 0;                       // the block's count, the same in all
  for (int base = r0, parity = 0; base < r1;
       base += kRound, parity ^= 1) {
    // rows base + u * kThreads + t: a warp reads 32 consecutive rows
    float dist[kRowsPerThread];
    if constexpr (kChunks > 0) {
      uint4 code[kRowsPerThread][kChunks];
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) {
        const int r = base + u * kThreads + threadIdx.x;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch)
          code[u][ch] = r < r1 ? __ldg(reinterpret_cast<const uint4*>(
                                           codes + (size_t)r * m) + ch)
                               : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch)
          acc = adc::add16(acc, code[u][ch], lut_s + 16 * ch * k, k);
        dist[u] = acc;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRowsPerThread; ++u) {
        const int r = base + u * kThreads + threadIdx.x;
        dist[u] = r < r1 ? adc::adc_row(codes + (size_t)r * m, lut_s, m, k,
                                        0)
                         : 0.f;
      }
    }
    // a row whose key beats tau goes to the buffer, one atomic per warp
    int appended = 0;                  // by this warp, in every lane
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int r = base + u * kThreads + threadIdx.x;
      const bool pass = r < r1 && adc::key_greater(tau_d, tau_p, dist[u], r);
      const unsigned mask = __ballot_sync(0xffffffffu, pass);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int slot = 0;
        if (lane == leader) slot = atomicAdd(&cnt, __popc(mask));
        slot = __shfl_sync(0xffffffffu, slot, leader);
        if (pass) {
          slot += __popc(mask & ((1u << lane) - 1u));
          key_d[slot] = dist[u];
          key_p[slot] = r;
        }
        appended += __popc(mask);
      }
    }
    // one barrier a round: the warps' counts (this round's parity, so the
    // next round's writes cannot meet a late reader) give every thread
    // the block's count
    if (lane == 0) warp_cnt[parity][warp] = appended;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += warp_cnt[parity][w];
    if (c > kBuf - kRound)             // the next round might not fit
      c = compact(key_d, key_p, c, tk, sel, &cnt, &tau_d, &tau_p);
  }
  if (c > tk) c = compact(key_d, key_p, c, tk, sel, &cnt, &tau_d, &tau_p);
  int size = 2;                        // the kept keys, sorted
  while (size < c) size <<= 1;
  for (int i = c + threadIdx.x; i < size; i += kThreads) {
    key_d[i] = INFINITY;
    key_p[i] = INT_MAX;
  }
  __syncthreads();
  adc::bitonic_sort(key_d, key_p, size);

  const size_t out0 = (size_t)blockIdx.x * tk;
  for (int j = threadIdx.x; j < tk; j += kThreads) {
    vals[out0 + j] = j < c ? key_d[j] : INFINITY;
    ids[out0 + j] = j < c ? key_p[j] : INT_MAX;
  }
}

template <int kChunks>
cudaError_t launch(const uint8_t* codes, const float* lut, float* vals,
                   int32_t* ids, int n, int m, int k, int grid, int rows,
                   int tk, cudaStream_t stream) {
  const size_t smem = (size_t)m * k * sizeof(float) + (size_t)kBuf * 8;
  cudaError_t e = cudaFuncSetAttribute(
      adc_scan_topk_kernel<kChunks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  adc_scan_topk_kernel<kChunks><<<grid, kThreads, smem, stream>>>(
      codes, lut, vals, ids, n, m, k, rows, tk);
  return cudaGetLastError();
}

}  // namespace

// grid blocks of `rows` rows each (the last may hold fewer), tk <=
// min(rows, 2048) (pq_adc/ops.py::topk_plan); vals/ids hold grid * tk.
// vec16: m % 16 == 0 and codes 16-byte aligned.  Returns a cudaError_t.
extern "C" int adc_scan_topk(const uint8_t* codes, const float* lut,
                             float* vals, int32_t* ids, int n, int m, int k,
                             int grid, int rows, int tk, int vec16,
                             void* stream) {
  if (n < 1 || m < 1 || k < 1 || grid < 1 || rows < 1 || tk < 1 ||
      tk > rows || tk > kMaxTk || (long long)grid * rows < n ||
      (long long)(grid - 1) * rows >= n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec16 && m == 16)
    return (int)launch<1>(codes, lut, vals, ids, n, m, k, grid, rows, tk, st);
  if (vec16 && m == 32)
    return (int)launch<2>(codes, lut, vals, ids, n, m, k, grid, rows, tk, st);
  return (int)launch<0>(codes, lut, vals, ids, n, m, k, grid, rows, tk, st);
}
