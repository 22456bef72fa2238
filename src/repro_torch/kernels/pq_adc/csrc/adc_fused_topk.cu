// Fused LUT build -> ADC scan -> top-k for Hopper (sm_90a), one launch per
// scan window, its merge inside the launch.
//
// Replaces the Pallas TPU kernel repro/kernels/pq_adc/pq_adc.py::
// pq_adc_scan_fused (_adc_fused_kernel), in f32 and with lut_int8=True,
// together with the merge of its blocks in ops.pq_adc_fused_topk.  Inputs:
// rows (B, S) int32 candidate row ids per query (ascending, -1 = pad),
// codes (N, M) uint8, queries (B, M*dsub) f32, codebooks (M, K, dsub) f32.
// Output: each query's first tk = min(topk, S) pairs of a stable sort of
// its slots by distance, ascending by (dist, slot), ties to the lowest
// slot (the lowest row, as lax.top_k keeps the lowest index); a pad or a
// row >= N scores +inf.  Positions past a query's valid rows come back as
// (+inf, -1).  (That is the plain version's answer whenever the pads
// follow the valid rows, as the executor lays them out and ascending rows
// put rows >= N, or no valid row's distance is +inf.)
//
// Arithmetic (the plain version's, ref.py / ops.py, operation for
// operation; built with -fmad=false so nothing else is contracted):
//   LUT[m, k]  = (c0-q0)^2, then fma((cj-qj), (cj-qj), acc) for j >= 1
//   int8:  scale = max(hi - lo, 1e-12) * (1/255);  q = rint((lut-lo)/scale)
//          - 128;  term = fma(q + 128, scale, lo), taken once per entry at
//          build time (the same bits as per lookup)
//   dist       = sum over m in order from 0.0, one rounding per add.
//
// What bounds it on an H100 SXM: bytes, and few of them.  On the smoke's
// first serving window (B = 64, S = 1,024, about 500 valid rows a query,
// M = 32, K = 256, dsub = 4, topk 512) it must read 256 KB of row ids,
// 1 MB of code rows gathered from a 320 MB table, the queries and a 128 KB
// codebook, and write 256 KB of pairs: 0.0005 ms at 3.35 TB/s.  Its
// operations (the LUT build, B*M*K*dsub*3, and one add a valid slot and
// subquantizer) take under 0.0004 ms at the f32 rate.  What sets its time
// is latency (scripts/fused_phases.py on an H100 80GB HBM3 at 700 W,
// 0.0148 ms f32 in all): a cluster launch that does nothing 0.0026 ms,
// the LUT build with its exchange 0.0049, the scan (one round trip of
// row id, then code row) 0.0021, the sort 0.0024, the merge 0.0026.
//
// Design.  One thread block cluster of `cluster` CTAs a query (grid
// (cluster, B); ops.py::fused_plan: at most 8, about two CTAs an SM over
// the batch, 4 at B = 64).  The query's 32-slot chunks are dealt to its
// CTAs in turn, so each holds its share of the valid rows, which lead the
// pads.
//  1. LUT: CTA r builds subquantizers [r*M/c, (r+1)*M/c) only, one entry
//     a thread a subquantizer, eight subquantizers' codebook entries in
//     flight (one 16-byte load an entry at dsub = 4), and stores each
//     entry into its own LUT and, through distributed shared memory
//     (DSMEM), into the other CTAs' (after a cluster barrier that it
//     arrived at on entry, so every CTA has started); int8 quantises each
//     of its rows first (warp j a row's min/max, then the divide and the
//     dequantised entry).  A cluster barrier ends the exchange.
//  2. Scan: tiles of 32 chunks (1,024 slots), four slots a thread: the
//     four row ids, then all four code rows (16-byte loads where M % 16
//     == 0 and the codes are aligned, else the widest the row allows:
//     8 bytes at DEEP1B's M = 24, one at SPACEV1B's 25), then the sums.
//     A valid slot whose key (dist, slot), as one ordered 64-bit integer,
//     is below the CTA's threshold tau is appended to a key buffer (one
//     shared atomic a warp).  When the next tile might not fit, a radix
//     select keeps the keep = min(tk, slots) smallest and makes the
//     largest of them tau.
//  3. Select before sorting: a CTA with more than keep keys selects keep
//     of them (8-bit digits from the top, stopping at the first digit
//     whose keys are all needed); then it sorts its keys, padded to a
//     power of two: a bitonic sort whose strides below 32 run within a
//     warp by __shfl_xor_sync, one barrier for each larger stride.
//  4. Merge in the launch: each CTA pushes its sorted keys and their
//     count into every other CTA's inbox (DSMEM stores); after a cluster
//     barrier a key's output position is its index in its own list plus,
//     for each other CTA, the number of that CTA's keys below it (a binary
//     search in the inbox).  A key whose position is below tk is in the
//     query's top tk (a CTA's list holds its best tk), so each position
//     gets one writer; positions from the cluster's key count to tk get
//     (+inf, -1).  No CTA touches another's shared memory after that
//     barrier, so none waits for its peers to exit.
// The spill route (ops.py::fused_route, where fused_plan's inbox or key
// buffer does not fit: a large tk over a long window): `ctas` CTAs a
// query, a multiple of the cluster (which still shares the LUT build),
// each taking at most 4,096 slots, so its buffer holds all of them and
// it never selects mid-scan; step 4 writes each CTA's sorted keys and
// their count to a global scratch the wrapper allocates instead of the
// peers' inboxes, and a second kernel on the same stream (grid (ctas, B),
// one block a CTA's list) places each key by the same rank: its index
// plus, for each other list of the query (read into shared memory one at
// a time), the number of that list's keys below it (a binary search); a
// key stops searching once its position passes tk.  Shared memory a CTA:
// the LUT and the key buffer, no inbox.  The merge reads each list once
// for every other list of the query: ctas^2 * keep keys, from L2.
// The PR 12 form of this kernel took one block per 2,048 slots (64
// blocks at the serving window, each rebuilding its query's whole LUT),
// bitonic-sorted every slot behind a barrier per pass, and left the
// wrapper a torch.sort and a gather: 0.0776 ms in all, 0.0410 of it the
// kernel (scripts/kernel_ab.py, same card).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerThread = 4;               // a tile's slots a thread
constexpr int kTile = kThreads * kSlotsPerThread;
constexpr int kMaxCluster = 8;                   // portable cluster size
constexpr int kKeysPerThread = 16;               // compaction's registers
constexpr int kMaxCap = kThreads * kKeysPerThread;  // keys a CTA buffers
constexpr int kRowsPerPass = 8;                  // LUT rows a build pass

// (dist, slot) as one unsigned integer of the same order: the float's
// bits made monotone (-0 taken as +0; distances are never NaN), then the
// slot
__device__ __forceinline__ uint64_t key_of(float d, int slot) {
  uint32_t u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (uint32_t)slot;
}
__device__ __forceinline__ float key_dist(uint64_t key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}
__device__ __forceinline__ int key_slot(uint64_t key) {
  return (int)(uint32_t)key;
}

// What the block's threads share besides the dynamic buffers.
struct Shared {
  unsigned hist[256];                 // radix select's digit counts
  float lo[kRowsPerPass];             // int8: a build pass's row minima
  float hi[kRowsPerPass];             // and maxima
  uint64_t prefix;                    // the digits of the selected key
  unsigned long long tau;             // a key must be below it to enter
  unsigned need;                      // its rank among keys matching them
  int done;                           // the digits so far select keep keys
  int kept;
  int cnt;                            // keys in the buffer
  int in_cnt[kMaxCluster - 1];        // keys each other CTA pushed here
};

// The two halves of a cluster barrier: arrive, without ordering memory,
// then wait.  Between them a CTA's work goes on; after the wait every CTA
// of the cluster has started, so its shared memory may be written.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One LUT entry: the squared distance of a codebook entry (dsub floats at
// c) to the query's sub-vector q, both read from global memory (the
// sub-vector is the same address for the whole block: one transaction).
__device__ __forceinline__ float lut_entry(const float* __restrict__ c,
                                           const float* __restrict__ q,
                                           int dsub, bool vec4) {
  if (vec4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(c));
    const float4 w = __ldg(reinterpret_cast<const float4*>(q));
    const float d0 = __fsub_rn(v.x, w.x);
    float acc = __fmul_rn(d0, d0);
    const float d1 = __fsub_rn(v.y, w.y);
    acc = __fmaf_rn(d1, d1, acc);
    const float d2 = __fsub_rn(v.z, w.z);
    acc = __fmaf_rn(d2, d2, acc);
    const float d3 = __fsub_rn(v.w, w.w);
    return __fmaf_rn(d3, d3, acc);
  }
  const float d0 = __fsub_rn(__ldg(c), __ldg(q));
  float acc = __fmul_rn(d0, d0);
  for (int j = 1; j < dsub; ++j) {
    const float dj = __fsub_rn(__ldg(c + j), __ldg(q + j));
    acc = __fmaf_rn(dj, dj, acc);
  }
  return acc;
}

// Rows [m0, m1) of the query's LUT (q: its M*dsub floats) into lut
// (row-major, k entries a row) of every CTA of the cluster, thread t
// computing entry t of each, eight rows' loads in flight, each entry
// stored to this CTA's LUT and the others'.  int8: each row quantised and
// dequantised as the plain version does, warp j finding the minimum and
// maximum of a pass's row j.  Completes the cluster barrier the kernel
// arrived at before its first store to another CTA.
template <bool kInt8>
__device__ __forceinline__ void build_rows(
    float* lut, const float* __restrict__ q,
    const float* __restrict__ codebooks, int m0, int m1, int k, int dsub,
    Shared& sh, const cg::cluster_group& cluster) {
  static_assert(kRowsPerPass == kWarps, "a warp a row of a pass");
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  float* peer[kMaxCluster - 1];        // the other CTAs' LUTs
#pragma unroll
  for (int o = 1; o < kMaxCluster; ++o)
    peer[o - 1] = cluster.map_shared_rank(lut, (rank + o) & (c - 1));
  auto put = [&](int i, float x) {
    lut[i] = x;
#pragma unroll
    for (int o = 1; o < kMaxCluster; ++o)
      if (o < c) peer[o - 1][i] = x;
  };
  const int t = threadIdx.x;
  bool started = false;                // the cluster's CTAs all running
  const bool vec4 = dsub == 4 &&
      ((reinterpret_cast<uintptr_t>(codebooks) |
        reinterpret_cast<uintptr_t>(q)) & 15) == 0;
  for (int mb = m0; mb < m1; mb += kRowsPerPass) {
    float v[kRowsPerPass];
#pragma unroll
    for (int j = 0; j < kRowsPerPass; ++j) {
      const int mm = mb + j;
      v[j] = (mm < m1 && t < k)
                 ? lut_entry(codebooks + ((size_t)mm * k + t) * dsub,
                             q + mm * dsub, dsub, vec4)
                 : 0.f;
    }
    if (!started) {
      cluster_wait();
      started = true;
    }
    if constexpr (!kInt8) {
#pragma unroll
      for (int j = 0; j < kRowsPerPass; ++j)
        if (mb + j < m1 && t < k) put((mb + j) * k + t, v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerPass; ++j)
        if (mb + j < m1 && t < k) lut[(mb + j) * k + t] = v[j];
      __syncthreads();
      const int lane = t & 31, j = t >> 5, mm = mb + j;
      if (mm < m1) {
        float lo = INFINITY, hi = -INFINITY;
        for (int kk = lane; kk < k; kk += 32) {
          lo = fminf(lo, lut[mm * k + kk]);
          hi = fmaxf(hi, lut[mm * k + kk]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
          hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        if (lane == 0) {
          sh.lo[j] = lo;
          sh.hi[j] = hi;
        }
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kRowsPerPass; ++jj) {
        if (mb + jj >= m1 || t >= k) continue;
        const float lo = sh.lo[jj];
        const float scale =
            __fmul_rn(fmaxf(__fsub_rn(sh.hi[jj], lo), 1e-12f),
                      1.0f / 255.0f);
        const float tq = __fdiv_rn(__fsub_rn(v[jj], lo), scale);
        const int8_t q8 = (int8_t)(int)__fsub_rn(rintf(tq), 128.f);
        put((mb + jj) * k + t,
            __fmaf_rn(__fadd_rn((float)q8, 128.f), scale, lo));
      }
      __syncthreads();                 // lo/hi read before the next pass
    }
  }
  if (!started) cluster_wait();
}

// The first min(len, 16) bytes at p (len a multiple of W, p W-aligned),
// read W bytes at a time; the rest 0.
template <int W>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        int len) {
  if constexpr (W == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int h = 0; h < 16 / W; ++h) {
      if (h * W >= len) break;
      if constexpr (W == 8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + h);
        w[2 * h] = v.x;
        w[2 * h + 1] = v.y;
      } else if constexpr (W == 4) {
        w[h] = __ldg(reinterpret_cast<const unsigned*>(p) + h);
      } else if constexpr (W == 2) {
        w[h >> 1] |= (uint32_t)__ldg(reinterpret_cast<const uint16_t*>(p) +
                                     h) << (16 * (h & 1));
      } else {
        w[h >> 2] |= (uint32_t)__ldg(p + h) << (8 * (h & 3));
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Adds to acc the entries of min(len, 16) consecutive LUT rows (lut at the
// first) that the code bytes of v select, in order, one rounding each.
__device__ __forceinline__ float add16(float acc, uint4 v, const float* lut,
                                       int k, int len) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j >= len) break;
    acc = __fadd_rn(acc, lut[j * k + ((w[j >> 2] >> (8 * (j & 3))) & 0xff)]);
  }
  return acc;
}

// All threads; c > keep keys in buf (distinct: slots differ).  A radix
// select, 8-bit digits from the top: each pass a histogram of the keys
// that match the digits found so far, then one warp finds the digit of
// the keep-th key.  As soon as that digit's keys are all needed (at the
// last digit at the latest), the keep keys at or below the digits found
// move to the front of buf, unordered, and the largest of them becomes
// tau.
__device__ __noinline__ void compact(uint64_t* buf, int c, int keep,
                                     Shared& sh) {
  const int t = threadIdx.x, lane = t & 31;
  for (int i = t; i < 256; i += kThreads) sh.hist[i] = 0;
  if (t == 0) {
    sh.prefix = 0;
    sh.need = keep;
    sh.kept = 0;
    sh.done = 0;
    sh.tau = 0;
  }
  __syncthreads();
  int shift = 56;
  for (;; shift -= 8) {
    const uint64_t prefix = sh.prefix;
    for (int i = t; i < c; i += kThreads) {
      const uint64_t key = buf[i];
      if (shift == 56 || (key ^ prefix) >> (shift + 8) == 0)
        atomicAdd(&sh.hist[(key >> shift) & 255], 1u);
    }
    __syncthreads();
    if (t < 32) {                      // lane takes digits 8 lane .. + 7
      unsigned h[8], sum = 0;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        h[d] = sh.hist[8 * lane + d];
        sh.hist[8 * lane + d] = 0;     // ready for the next pass
        sum += h[d];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned need = sh.need;
      unsigned below = incl - sum;
      if (below < need && need <= incl) {
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          if (below + h[d] >= need) {
            sh.prefix = prefix | ((uint64_t)(8 * lane + d) << shift);
            sh.need = need - below;
            sh.done = h[d] == need - below;
            break;
          }
          below += h[d];
        }
      }
    }
    __syncthreads();
    if (sh.done || shift == 0) break;
  }
  const uint64_t top = sh.prefix >> shift;   // the digits found
  uint64_t v[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = t + j * kThreads;
    v[j] = i < c ? buf[i] : ~0ull;
  }
  __syncthreads();                     // every key read before any moves
  unsigned long long most = 0;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const bool take = t + j * kThreads < c && (v[j] >> shift) <= top;
    const unsigned mask = __ballot_sync(0xffffffffu, take);
    if (mask) {
      const int leader = __ffs(mask) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(&sh.kept, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, leader);
      if (take) {
        buf[at + __popc(mask & ((1u << lane) - 1u))] = v[j];
        most = v[j] > most ? v[j] : most;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, most, o);
    most = y > most ? y : most;
  }
  if (lane == 0) atomicMax(&sh.tau, most);
  if (t == 0) sh.cnt = keep;
  __syncthreads();
}

// One compare-exchange of a bitonic network between element i (this
// lane's) and i ^ stride (the lane's at xor stride), ascending where
// (i & size) == 0.
__device__ __forceinline__ uint64_t exchange(uint64_t x, int i, int size,
                                             int stride) {
  const uint64_t y = __shfl_xor_sync(0xffffffffu, x, stride);
  const bool up = (i & size) == 0, low = (i & stride) == 0;
  return (low == up) ? (x < y ? x : y) : (x < y ? y : x);
}

// All threads, buf written and synchronised before: sorts buf[0, n), n a
// power of two >= 32, ascending.  Strides below 32 run in registers across
// a warp's lanes; each larger stride is one pass over shared memory.
__device__ __forceinline__ void sort_keys(uint64_t* buf, int n) {
  const int t = threadIdx.x;
  for (int i = t; i < n; i += kThreads) {
    uint64_t x = buf[i];
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        x = exchange(x, i, size, stride);
    buf[i] = x;
  }
  __syncthreads();
  for (int size = 64; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
      for (int p = t; p < n / 2; p += kThreads) {
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const uint64_t a = buf[i], b = buf[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[i + stride] = a;
        }
      }
      __syncthreads();
    }
    for (int i = t; i < n; i += kThreads) {
      uint64_t x = buf[i];
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1)
        x = exchange(x, i, size, stride);
      buf[i] = x;
    }
    __syncthreads();
  }
}

// W: the width of the code loads (M % W == 0, codes W-aligned).  kSpill:
// the spill route, gridDim.x CTAs a query, each writing its sorted keys to
// spill (keep a CTA) and their count to spill_cnt instead of merging.
template <int W, bool kInt8, bool kSpill>
__global__ void __launch_bounds__(kThreads, 3)
adc_fused_topk_kernel(const int32_t* __restrict__ rows,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ queries,
                      const float* __restrict__ codebooks,
                      float* __restrict__ vals, int32_t* __restrict__ ids,
                      uint64_t* __restrict__ spill,
                      int* __restrict__ spill_cnt,
                      int s, int n, int m, int k, int dsub, int tk,
                      int slots, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);           // m*k, to 4
  uint64_t* buf = reinterpret_cast<uint64_t*>(lut + ((m * k + 3) & ~3));
  uint64_t* inbox = buf + cap;         // (c - 1) * keep: the others' keys
  __shared__ Shared sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31;
  const int32_t* qrows = rows + (size_t)b * s;
  const int keep = min(tk, slots);
  // the query's CTAs: its cluster, or on the spill route every CTA of
  // the grid's row (a multiple of the cluster); qr: this one's place
  const int g = kSpill ? (int)gridDim.x : c;
  const int qr = kSpill ? (int)blockIdx.x : rank;
  // the query's 32-slot chunks are dealt to the CTAs in turn, so each
  // gets its share of the valid rows, which lead the pads
  const int chunks = (s + 31) / 32;
  const int own = qr < chunks ? (chunks - qr + g - 1) / g : 0;

  // 1. this CTA's rows of the query's LUT, into every CTA's LUT (stores
  // to the others once the cluster's CTAs have all started)
  cluster_arrive_relaxed();
  if (t == 0) {
    sh.cnt = 0;
    sh.tau = ~0ull;
  }
  build_rows<kInt8>(lut, queries + (size_t)b * m * dsub, codebooks,
                    rank * m / c, (rank + 1) * m / c, k, dsub, sh, cluster);
  cluster.sync();                      // every CTA's rows pushed

  // 2. the CTA's tiles of 32 chunks (chunk ch of the CTA is the query's
  // chunk ch * g + qr): a thread's four row ids, then the first 32 bytes
  // of their four code rows, all in flight before any is summed; then the
  // valid keys below tau appended
  const int warp = t >> 5;
  uint64_t tau = ~0ull;
  for (int base = 0; base < own; base += kTile / 32) {
    int p[kSlotsPerThread], r[kSlotsPerThread];
    bool valid[kSlotsPerThread];
    uint4 lo[kSlotsPerThread], hi[kSlotsPerThread];
#pragma unroll
    for (int u = 0; u < kSlotsPerThread; ++u) {
      const int ch = base + u * kWarps + warp;
      p[u] = (ch * g + qr) * 32 + lane;
      r[u] = ch < own && p[u] < s ? __ldg(qrows + p[u]) : -1;
    }
#pragma unroll
    for (int u = 0; u < kSlotsPerThread; ++u) {
      valid[u] = r[u] >= 0 && r[u] < n;
      const uint8_t* row = codes + (size_t)(valid[u] ? r[u] : 0) * m;
      lo[u] = valid[u] ? load16<W>(row, m) : make_uint4(0, 0, 0, 0);
      hi[u] = valid[u] && m > 16 ? load16<W>(row + 16, m - 16)
                                 : make_uint4(0, 0, 0, 0);
    }
    uint64_t key[kSlotsPerThread];
    bool take[kSlotsPerThread];
#pragma unroll
    for (int u = 0; u < kSlotsPerThread; ++u) {
      float dist = 0.f;
      if (valid[u]) {
        dist = add16(dist, lo[u], lut, k, m);
        if (m > 16) dist = add16(dist, hi[u], lut + 16 * k, k, m - 16);
        const uint8_t* row = codes + (size_t)r[u] * m;
        for (int off = 32; off < m; off += 16)
          dist = add16(dist, load16<W>(row + off, m - off), lut + off * k,
                       k, m - off);
      }
      key[u] = key_of(dist, p[u]);
      take[u] = valid[u] && key[u] < tau;
    }
#pragma unroll
    for (int u = 0; u < kSlotsPerThread; ++u) {
      const unsigned mask = __ballot_sync(0xffffffffu, take[u]);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&sh.cnt, __popc(mask));
        at = __shfl_sync(0xffffffffu, at, leader);
        if (take[u]) buf[at + __popc(mask & ((1u << lane) - 1u))] = key[u];
      }
    }
    __syncthreads();
    const int next = min(kTile, (own - base - kTile / 32) * 32);
    if (next > 0 && sh.cnt + next > cap) compact(buf, sh.cnt, keep, sh);
    tau = sh.tau;
    __syncthreads();                   // read before the next appends
  }

  // 3. keep the CTA's best keep keys, sorted
  int cnt = sh.cnt;
  if (cnt > keep) {
    compact(buf, cnt, keep, sh);
    cnt = keep;
  }
  if (cnt > 0) {
    int size = 32;
    while (size < cnt) size <<= 1;
    for (int i = cnt + t; i < size; i += kThreads) buf[i] = ~0ull;
    __syncthreads();
    sort_keys(buf, size);
  }

  if constexpr (kSpill) {
    // 4'. the sorted keys and their count to the scratch; the merge
    // kernel places them.  No CTA reads another's shared memory after
    // the LUT exchange's barrier, so none waits for its peers to exit.
    const size_t at = (size_t)b * g + qr;
    for (int i = t; i < cnt; i += kThreads) spill[at * keep + i] = buf[i];
    if (t == 0) spill_cnt[at] = cnt;
    return;
  }

  // 4. the sorted keys pushed to the other CTAs of the cluster (slot
  // rank - (rank > q) of CTA q's inbox) and, after the barrier, each
  // key's place among all of them: its index plus, for each other CTA,
  // the number of that CTA's keys below it.  No CTA reads another's
  // shared memory after the barrier.
  uint64_t* dst[kMaxCluster - 1];
#pragma unroll
  for (int o = 1; o < kMaxCluster; ++o) {
    const int q = (rank + o) & (c - 1);
    dst[o - 1] = cluster.map_shared_rank(inbox, q) +
                 (size_t)(rank - (rank > q)) * keep;
    if (t == 0 && o < c)
      *cluster.map_shared_rank(&sh.in_cnt[rank - (rank > q)], q) = cnt;
  }
  for (int i = t; i < cnt; i += kThreads) {
    const uint64_t x = buf[i];
#pragma unroll
    for (int o = 1; o < kMaxCluster; ++o)
      if (o < c) dst[o - 1][i] = x;
  }
  cluster.sync();
  int total = cnt;
  for (int q = 0; q + 1 < c; ++q) total += sh.in_cnt[q];
  float* qvals = vals + (size_t)b * tk;
  int32_t* qids = ids + (size_t)b * tk;
  for (int i = t; i < cnt; i += kThreads) {
    const uint64_t x = buf[i];
    const int row = __ldg(qrows + key_slot(x));
    int pos = i;
    for (int q = 0; q + 1 < c; ++q) {
      const uint64_t* list = inbox + (size_t)q * keep;
      int lo = 0, hi = sh.in_cnt[q];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (list[mid] < x) lo = mid + 1;
        else hi = mid;
      }
      pos += lo;
    }
    if (pos < tk) {
      qvals[pos] = key_dist(x);
      qids[pos] = row;
    }
  }
  for (int p = total + rank * kThreads + t; p < tk; p += c * kThreads) {
    qvals[p] = INFINITY;
    qids[p] = -1;
  }
}


// The spill route's merge: block (own, b) places the keys of CTA own's
// sorted list of query b (lists: keep keys a CTA, counts: their number)
// among the query's other lists by rank, as step 4 does in the launch,
// and writes (dist, row) at each position below tk; positions from the
// query's key count to tk get (+inf, -1), dealt over the query's blocks.
__global__ void __launch_bounds__(kThreads)
adc_fused_merge_kernel(const uint64_t* __restrict__ lists,
                       const int* __restrict__ counts,
                       const int32_t* __restrict__ rows,
                       float* __restrict__ vals, int32_t* __restrict__ ids,
                       int s, int tk, int keep) {
  extern __shared__ uint64_t other[];  // one other list at a time
  const int b = blockIdx.y, own = blockIdx.x, g = gridDim.x;
  const int t = threadIdx.x;
  const uint64_t* qlists = lists + (size_t)b * g * keep;
  const int* qcounts = counts + (size_t)b * g;
  const int cnt = qcounts[own];
  uint64_t key[kKeysPerThread];
  int pos[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = t + j * kThreads;
    key[j] = i < cnt ? qlists[(size_t)own * keep + i] : ~0ull;
    pos[j] = i;
  }
  int total = 0;
  for (int h = 0; h < g; ++h) {
    const int ch = qcounts[h];
    total += ch;
    if (h == own || ch == 0) continue;
    __syncthreads();                   // the last list searched by all
    for (int i = t; i < ch; i += kThreads)
      other[i] = qlists[(size_t)h * keep + i];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (t + j * kThreads >= cnt || pos[j] >= tk) continue;
      int lo = 0, hi = ch;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (other[mid] < key[j]) lo = mid + 1;
        else hi = mid;
      }
      pos[j] += lo;
    }
  }
  float* qvals = vals + (size_t)b * tk;
  int32_t* qids = ids + (size_t)b * tk;
  const int32_t* qrows = rows + (size_t)b * s;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    if (t + j * kThreads >= cnt || pos[j] >= tk) continue;
    qvals[pos[j]] = key_dist(key[j]);
    qids[pos[j]] = __ldg(qrows + key_slot(key[j]));
  }
  for (int p = total + own * kThreads + t; p < tk; p += g * kThreads) {
    qvals[p] = INFINITY;
    qids[p] = -1;
  }
}

// What every launch of the kernel shares.
struct Args {
  const int32_t* rows;
  const uint8_t* codes;
  const float* queries;
  const float* codebooks;
  float* vals;
  int32_t* ids;
  uint64_t* spill;                     // null: the one-launch route
  int* spill_cnt;
  int b, s, n, m, k, dsub, tk, cluster, ctas, slots, cap;
};

template <int W, bool kInt8, bool kSpill>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t keep = a.tk < a.slots ? a.tk : a.slots;
  const size_t smem = (size_t)((a.m * a.k + 3) & ~3) * 4 +
                      (size_t)a.cap * 8 +
                      (kSpill ? 0 : (size_t)(a.cluster - 1) * keep * 8);
  auto kernel = adc_fused_topk_kernel<W, kInt8, kSpill>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ctas, a.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a.rows, a.codes, a.queries,
                         a.codebooks, a.vals, a.ids, a.spill, a.spill_cnt,
                         a.s, a.n, a.m, a.k, a.dsub, a.tk, a.slots, a.cap);
  if (e != cudaSuccess) return e;
  if constexpr (kSpill) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    adc_fused_merge_kernel<<<dim3(a.ctas, a.b), kThreads, keep * 8,
                             stream>>>(a.spill, a.spill_cnt, a.rows, a.vals,
                                       a.ids, a.s, a.tk, (int)keep);
  }
  return cudaGetLastError();
}

template <bool kInt8, bool kSpill>
cudaError_t dispatch(int width, const Args& a, cudaStream_t st) {
  switch (width) {
    case 16: return launch<16, kInt8, kSpill>(a, st);
    case 8: return launch<8, kInt8, kSpill>(a, st);
    case 4: return launch<4, kInt8, kSpill>(a, st);
    case 2: return launch<2, kInt8, kSpill>(a, st);
    default: return launch<1, kInt8, kSpill>(a, st);
  }
}

}  // namespace

// `ctas` CTAs a query in clusters of `cluster` (a power of two up to 8;
// ctas == cluster on the one-launch route, a multiple of it on the spill
// route), the query's 32-slot chunks dealt to them in turn, slots =
// ceil(ceil(S/32) / ctas) * 32 the most a CTA takes; cap: the keys a CTA
// buffers, a multiple of 32, at most 4,096, at least max(32,
// pow2ceil(keep)), and at least slots or keep + 1,024, keep = min(tk,
// slots) (ops.py::fused_plan, ops.py::fused_route); width: the code loads'
// bytes (M % width == 0, codes width-aligned).  spill (ctas * B * keep
// keys) and spill_cnt (ctas * B ints): the spill route's scratch, null on
// the one-launch route.  vals/ids hold (B, tk).  Returns a cudaError_t.
extern "C" int adc_fused_topk(const int32_t* rows, const uint8_t* codes,
                              const float* queries, const float* codebooks,
                              float* vals, int32_t* ids, void* spill,
                              void* spill_cnt, int b, int s, int n, int m,
                              int k, int dsub, int tk, int cluster, int ctas,
                              int slots, int cap, int width, int lut_int8,
                              void* stream) {
  const int keep = tk < slots ? tk : slots;
  int pow2 = 32;
  while (pow2 < keep) pow2 <<= 1;
  const bool spilled = spill != nullptr;
  if (b < 1 || b > 65535 || s < 1 || n < 0 || m < 1 || k < 1 || k > 256 ||
      dsub < 1 || tk < 1 || tk > s || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) || ctas < 1 ||
      ctas % cluster || (!spilled && ctas != cluster) ||
      (spilled && spill_cnt == nullptr) ||
      slots != ((s + 31) / 32 + ctas - 1) / ctas * 32 ||
      cap % 32 || cap > kMaxCap ||
      cap < pow2 || (cap < slots && cap < keep + kTile) ||
      (width != 1 && width != 2 && width != 4 && width != 8 &&
       width != 16) || m % width)
    return (int)cudaErrorInvalidValue;
  const Args a{rows, codes, queries, codebooks, vals, ids,
               static_cast<uint64_t*>(spill), static_cast<int*>(spill_cnt),
               b, s, n, m, k, dsub, tk, cluster, ctas, slots, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (spilled)
    return (int)(lut_int8 ? dispatch<true, true>(width, a, st)
                          : dispatch<false, true>(width, a, st));
  return (int)(lut_int8 ? dispatch<true, false>(width, a, st)
                        : dispatch<false, false>(width, a, st));
}
