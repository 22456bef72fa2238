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
// buffer does not fit: a large tk over a long window; counted as
// adc_fused_topk[spill]) is one launch of adc_fused_spill_kernel, the
// same cluster a query and the same steps 1 and 2 (its scan pipelined two
// tiles deep), with the select made across the cluster: CTA buffers of
// up to 16,384 keys hold all their slots where they fit (at B = 64, S =
// 32,768: 4 CTAs of 8,192), else the cluster selects its best keep every
// (cap - keep) / kTile tiles; after the scan a radix select of the
// query's keep-th key (dist, slot), keep = min(tk, cap / 2), 8-bit digits
// from the top, each CTA's digit counts summed through DSMEM, so the
// CTAs together keep exactly min(keep, valid) keys; each sorts its own
// (about keep / cluster), copies the others' sorted keys (DSMEM) into an
// inbox in the free half of its buffer, and a key's position is its
// index plus, for each other CTA, the number of that CTA's keys below it
// (a binary search in the inbox).  No global scratch, no second kernel;
// where tk passes keep (a long window and a large tk at once),
// rounds repeat the scan above the last round's largest key.  Its first
// form (8 CTAs a query of at most 4,096 slots, each bitonic-sorting all
// of its keys, sorted lists through a global scratch to a merge kernel
// reading ctas^2 * keep keys a query) took 0.2635 ms at B = 64, S =
// 32,768, tk = 4,096 in f32: launch 0.0026, LUT 0.0090, scan 0.0907,
// sort 0.0799, scratch write 0.0087, merge kernel 0.0680
// (scripts/fused_phases.py --spill on that form's source, H100 80GB
// HBM3, 700 W).
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
// maximum of a pass's row j (in sh.lo, sh.hi).  Completes the cluster
// barrier the kernel arrived at before its first store to another CTA.
template <bool kInt8, class Sh>
__device__ __forceinline__ void build_rows(
    float* lut, const float* __restrict__ q,
    const float* __restrict__ codebooks, int m0, int m1, int k, int dsub,
    Sh& sh, const cg::cluster_group& cluster) {
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

// A thread's share of one tile of 32 of a CTA's chunks: its four slots
// (p), their row ids (r) and the first 32 bytes of their code rows.
struct Tile {
  int p[kSlotsPerThread], r[kSlotsPerThread];
  uint4 lo[kSlotsPerThread], hi[kSlotsPerThread];
};

// The row ids of the tile from the CTA's chunk `base` (chunk ch of the CTA
// is the query's chunk ch * g + qr, own of them; -1 past them).
__device__ __forceinline__ void tile_ids(Tile& x,
                                         const int32_t* __restrict__ qrows,
                                         int base, int own, int g, int qr,
                                         int s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const int ch = base + u * kWarps + warp;
    x.p[u] = (ch * g + qr) * 32 + lane;
    x.r[u] = ch < own && x.p[u] < s ? __ldg(qrows + x.p[u]) : -1;
  }
}

// The first 32 bytes of the valid rows' codes.
template <int W>
__device__ __forceinline__ void tile_codes(Tile& x,
                                           const uint8_t* __restrict__ codes,
                                           int n, int m) {
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const bool valid = x.r[u] >= 0 && x.r[u] < n;
    const uint8_t* row = codes + (size_t)(valid ? x.r[u] : 0) * m;
    x.lo[u] = valid ? load16<W>(row, m) : make_uint4(0, 0, 0, 0);
    x.hi[u] = valid && m > 16 ? load16<W>(row + 16, m - 16)
                              : make_uint4(0, 0, 0, 0);
  }
}

// The tile's distances summed, then each valid key (dist, slot) below tau
// (and, kLower, above lower) appended to buf at cnt (one shared atomic a
// warp).
template <int W, bool kLower>
__device__ __forceinline__ void tile_append(
    const Tile& x, const uint8_t* __restrict__ codes, const float* lut,
    uint64_t* buf, int& cnt, int n, int m, int k, uint64_t lower,
    uint64_t tau) {
  const int lane = threadIdx.x & 31;
  uint64_t key[kSlotsPerThread];
  bool take[kSlotsPerThread];
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const bool valid = x.r[u] >= 0 && x.r[u] < n;
    float dist = 0.f;
    if (valid) {
      dist = add16(dist, x.lo[u], lut, k, m);
      if (m > 16) dist = add16(dist, x.hi[u], lut + 16 * k, k, m - 16);
      const uint8_t* row = codes + (size_t)x.r[u] * m;
      for (int off = 32; off < m; off += 16)
        dist = add16(dist, load16<W>(row + off, m - off), lut + off * k, k,
                     m - off);
    }
    key[u] = key_of(dist, x.p[u]);
    take[u] = valid && key[u] < tau && (!kLower || key[u] > lower);
  }
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const unsigned mask = __ballot_sync(0xffffffffu, take[u]);
    if (mask) {
      const int leader = __ffs(mask) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(&cnt, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, leader);
      if (take[u]) buf[at + __popc(mask & ((1u << lane) - 1u))] = key[u];
    }
  }
}

// One tile in turn: a thread's four row ids, then their code rows, all
// in flight before any is summed; then the keys below tau appended.
template <int W>
__device__ __forceinline__ void scan_tile(
    const int32_t* __restrict__ qrows, const uint8_t* __restrict__ codes,
    const float* lut, uint64_t* buf, int& cnt, int base, int own, int g,
    int qr, int s, int n, int m, int k, uint64_t tau) {
  Tile x;
  tile_ids(x, qrows, base, own, g, qr, s);
  tile_codes<W>(x, codes, n, m);
  tile_append<W, false>(x, codes, lut, buf, cnt, n, m, k, 0, tau);
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

// W: the width of the code loads (M % W == 0, codes W-aligned).
template <int W, bool kInt8>
__global__ void __launch_bounds__(kThreads, 3)
adc_fused_topk_kernel(const int32_t* __restrict__ rows,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ queries,
                      const float* __restrict__ codebooks,
                      float* __restrict__ vals, int32_t* __restrict__ ids,
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
  // the query's 32-slot chunks are dealt to the CTAs in turn, so each
  // gets its share of the valid rows, which lead the pads
  const int chunks = (s + 31) / 32;
  const int own = rank < chunks ? (chunks - rank + c - 1) / c : 0;

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

  // 2. the CTA's tiles of 32 chunks, the valid keys below tau appended
  uint64_t tau = ~0ull;
  for (int base = 0; base < own; base += kTile / 32) {
    scan_tile<W>(qrows, codes, lut, buf, sh.cnt, base, own, c, rank, s, n,
                 m, k, tau);
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


// ---- the spill route: one cluster a query, selected across the cluster

constexpr int kSpillMaxCap = 16384;   // keys a CTA of the spill route holds
constexpr int kHistWords = 3 * 256;   // two histograms and their sums

// What a spill route CTA's threads share besides the dynamic buffers.
struct SpillShared {
  float lo[kRowsPerPass];             // int8: a build pass's row minima
  float hi[kRowsPerPass];             // and maxima
  uint64_t prefix;                    // the digits of the selected key
  unsigned need;                      // its rank among keys matching them
  int done;                           // 1: the digits so far select want
                                      // keys; 2: the cluster holds fewer
  int kept;
  int cnt;                            // keys in the buffer
  int n_pub;                          // this CTA's sorted keys (the peers
                                      // search them)
};

// All threads of every CTA of the cluster, each with the cnt keys of its
// buf (distinct across the cluster).  A radix select of the cluster's
// want-th smallest key, 8-bit digits from the top: each pass every CTA
// counts the digits of its keys that match the digits found so far into
// hist[pass & 1]; after a cluster barrier each CTA sums the cluster's
// counts (thread t digit t, through DSMEM) and one warp finds the digit,
// the same in every CTA.  A CTA clears the other histogram once the
// barrier shows every CTA has read it; `pass` runs on across calls, so
// each call starts on a clear one.  As soon as the digits found select
// exactly want keys (at the last digit at the latest), each CTA moves its
// keys at or below them to the front of buf, unordered, and the function
// returns their number and lowers tau to the least key above the digits
// where that is lower (every key of the cluster's best want is below it).
// Where the cluster holds no more than want keys, it keeps them all (tau
// unchanged).
__device__ __forceinline__ int cluster_select(uint64_t* buf, int cnt, int want,
                                           unsigned* hist, int& pass,
                                           uint64_t& tau, SpillShared& sh,
                                           const cg::cluster_group& cluster) {
  const int t = threadIdx.x, lane = t & 31;
  const int c = (int)cluster.num_blocks();
  unsigned* tot = hist + 512;
  static_assert(kThreads == 256, "a thread a digit");
  if (t == 0) {
    sh.prefix = 0;
    sh.need = want;
    sh.done = 0;
  }
  int shift = 56;
  for (bool first = true;; shift -= 8, first = false) {
    unsigned* h = hist + (pass & 1) * 256;
    const uint64_t prefix = sh.prefix;
    for (int i = t; i < cnt; i += kThreads) {
      const uint64_t key = buf[i];
      if (shift == 56 || (key ^ prefix) >> (shift + 8) == 0)
        atomicAdd(&h[(key >> shift) & 255], 1u);
    }
    cluster.sync();                    // every CTA's counts in
    unsigned sum = 0;
    for (int q = 0; q < c; ++q) sum += cluster.map_shared_rank(h, q)[t];
    tot[t] = sum;
    hist[((pass + 1) & 1) * 256 + t] = 0;   // read by all before the barrier
    ++pass;
    __syncthreads();
    if (t < 32) {                      // lane takes digits 8 lane .. + 7
      unsigned d8[8], part = 0;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        d8[d] = tot[8 * lane + d];
        part += d8[d];
      }
      unsigned incl = part;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned need = sh.need;
      unsigned below = incl - part;
      if (first && __shfl_sync(0xffffffffu, incl, 31) <= need) {
        if (lane == 0) sh.done = 2;
      } else if (below < need && need <= incl) {
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          if (below + d8[d] >= need) {
            sh.prefix = prefix | ((uint64_t)(8 * lane + d) << shift);
            sh.need = need - below;
            sh.done = d8[d] == need - below;
            break;
          }
          below += d8[d];
        }
      }
    }
    __syncthreads();
    if (sh.done || shift == 0) break;
  }
  if (sh.done == 2) return cnt;
  const uint64_t top = sh.prefix >> shift;   // the digits found
  if (top < (~0ull >> shift) && ((top + 1) << shift) < tau)
    tau = (top + 1) << shift;
  // move the keys at or below them to the front, kKeysPerThread a thread
  // at a time (a key moves only to a place already read)
  if (t == 0) sh.kept = 0;
  for (int base = 0; base < cnt; base += kMaxCap) {
    uint64_t v[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int i = base + t + j * kThreads;
      v[j] = i < cnt ? buf[i] : ~0ull;
    }
    __syncthreads();                   // this part read before any moves
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const bool take = base + t + j * kThreads < cnt && (v[j] >> shift) <= top;
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&sh.kept, __popc(mask));
        at = __shfl_sync(0xffffffffu, at, leader);
        if (take) buf[at + __popc(mask & ((1u << lane) - 1u))] = v[j];
      }
    }
  }
  __syncthreads();
  return sh.kept;
}

// The spill route (ops.py::fused_route): where fused_plan's inbox or key
// buffer does not fit.  One cluster of `cluster` CTAs a query (grid
// (cluster, B)), the query's 32-slot chunks dealt in turn as on the
// one-launch route, the LUT built and exchanged as there.  Each CTA
// buffers its valid keys (cap of them, a power of two); where its slots
// fit (slots <= cap) it buffers them all, else after every (cap - want) /
// kTile tiles the cluster selects its want best (cluster_select) and each
// CTA keeps its share of them, its tau the cluster's.  After the scan the
// cluster selects the query's want best, want = min(keep, tk - base), so
// the CTAs together hold exactly that many (or all the valid keys); each
// sorts its own (about want / cluster) and copies the others' sorted keys
// into an inbox past its own (keep <= cap / 2 leaves the room), then each
// key's output position is base + its index + for each other CTA the
// number of that CTA's keys below it, a binary search in the inbox.
// Where the query's tk passes keep (a long window and a large tk at
// once), rounds repeat the scan for the next keep keys, above the last
// round's largest.  No global scratch; positions from the query's valid
// keys to tk get (+inf, -1).
template <int W, bool kInt8>
__global__ void __launch_bounds__(kThreads, 2)
adc_fused_spill_kernel(const int32_t* __restrict__ rows,
                       const uint8_t* __restrict__ codes,
                       const float* __restrict__ queries,
                       const float* __restrict__ codebooks,
                       float* __restrict__ vals, int32_t* __restrict__ ids,
                       int s, int n, int m, int k, int dsub, int tk,
                       int slots, int keep, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);           // m*k, to 4
  uint64_t* buf = reinterpret_cast<uint64_t*>(lut + ((m * k + 3) & ~3));
  unsigned* hist = reinterpret_cast<unsigned*>(buf + cap);   // kHistWords
  __shared__ SpillShared sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int32_t* qrows = rows + (size_t)b * s;
  const int chunks = (s + 31) / 32;
  const int own = rank < chunks ? (chunks - rank + c - 1) / c : 0;
  const int tiles = (slots / 32 + kTile / 32 - 1) / (kTile / 32);

  // 1. the LUT, as on the one-launch route
  cluster_arrive_relaxed();
  for (int i = t; i < 512; i += kThreads) hist[i] = 0;
  build_rows<kInt8>(lut, queries + (size_t)b * m * dsub, codebooks,
                    rank * m / c, (rank + 1) * m / c, k, dsub, sh, cluster);
  cluster.sync();                      // every CTA's rows pushed

  float* qvals = vals + (size_t)b * tk;
  int32_t* qids = ids + (size_t)b * tk;
  const uint64_t* peer[kMaxCluster];   // every CTA's sorted keys
  const int* peer_n[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    peer[q] = cluster.map_shared_rank(buf, q < c ? q : 0);
    peer_n[q] = cluster.map_shared_rank(&sh.n_pub, q < c ? q : 0);
  }
  int pass = 0, base = 0;
  uint64_t lower = 0;                  // keys at or below it came before
  for (;;) {
    const int want = min(keep, tk - base);
    // 2. the scan; with more slots than the buffer holds, a cluster
    // select after every `every` tiles (each CTA then holds <= want)
    const int every = slots > cap ? (cap - want) / kTile : tiles;
    // A pipeline two tiles deep: tile j's sums while tile j + 1's code
    // rows and tile j + 2's row ids are in flight
    uint64_t tau = ~0ull;
    if (t == 0) sh.cnt = 0;
    __syncthreads();
    constexpr int kStep = kTile / 32;  // chunks a tile
    Tile cur, next;
    tile_ids(cur, qrows, 0, own, c, rank, s);
    tile_codes<W>(cur, codes, n, m);
    tile_ids(next, qrows, kStep, own, c, rank, s);
    for (int j = 0; j < tiles; ++j) {
      tile_codes<W>(next, codes, n, m);
      Tile after;
      tile_ids(after, qrows, (j + 2) * kStep, own, c, rank, s);
      tile_append<W, true>(cur, codes, lut, buf, sh.cnt, n, m, k, lower,
                           tau);
      __syncthreads();
      if ((j + 1) % every == 0 && j + 1 < tiles) {
        const int kept = cluster_select(buf, sh.cnt, want, hist, pass, tau,
                                        sh, cluster);
        if (t == 0) sh.cnt = kept;
        __syncthreads();
      }
      cur = next;
#pragma unroll
      for (int u = 0; u < kSlotsPerThread; ++u) {
        next.p[u] = after.p[u];
        next.r[u] = after.r[u];
      }
    }
    // 3. the cluster's best want, each CTA's share sorted
    const int cnt = cluster_select(buf, sh.cnt, want, hist, pass, tau, sh,
                                   cluster);
    int size = 32;
    while (size < cnt) size <<= 1;
    for (int i = cnt + t; i < size; i += kThreads) buf[i] = ~0ull;
    __syncthreads();
    sort_keys(buf, size);
    if (t == 0) sh.n_pub = cnt;
    cluster.sync();                    // every CTA's keys sorted
    // 4. the other CTAs' sorted keys copied (DSMEM) into this CTA's inbox,
    // the buffer past its own (want - cnt keys at most, cap / 2 of room);
    // then each key's position: its index plus, for each other CTA, the
    // number of that CTA's keys below it (a binary search in the inbox)
    uint64_t* inbox = buf + size;
    int nq[kMaxCluster], from[kMaxCluster], total = 0, at = 0;
    uint64_t largest = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      nq[q] = q < c ? *peer_n[q] : 0;
      total += nq[q];
      if (nq[q] > 0) {
        const uint64_t x = peer[q][nq[q] - 1];
        largest = x > largest ? x : largest;
      }
      from[q] = at;
      if (q != rank) at += nq[q];
    }
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q == rank) continue;
      for (int i = t; i < nq[q]; i += kThreads)
        inbox[from[q] + i] = peer[q][i];
    }
    cluster.sync();                    // no CTA reads another's keys now
    for (int i = t; i < cnt; i += kThreads) {
      const uint64_t x = buf[i];
      int pos = base + i;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q == rank || nq[q] == 0) continue;
        const uint64_t* list = inbox + from[q];
        int lo = 0, hi = nq[q];
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (list[mid] < x) lo = mid + 1;
          else hi = mid;
        }
        pos += lo;
      }
      qvals[pos] = key_dist(x);
      qids[pos] = __ldg(qrows + key_slot(x));
    }
    base += total;
    if (total < want || base >= tk) break;
    lower = largest;
  }
  for (int p = base + rank * kThreads + t; p < tk; p += c * kThreads) {
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
  int b, s, n, m, k, dsub, tk, cluster, slots, keep, cap;
};

template <int W, bool kInt8, bool kSpill>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t lut = (size_t)((a.m * a.k + 3) & ~3) * 4;
  const size_t smem =
      lut + (size_t)a.cap * 8 +
      (kSpill ? kHistWords * 4 : (size_t)(a.cluster - 1) * a.keep * 8);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if constexpr (kSpill) {
    auto kernel = adc_fused_spill_kernel<W, kInt8>;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&cfg, kernel, a.rows, a.codes, a.queries,
                           a.codebooks, a.vals, a.ids, a.s, a.n, a.m, a.k,
                           a.dsub, a.tk, a.slots, a.keep, a.cap);
  } else {
    auto kernel = adc_fused_topk_kernel<W, kInt8>;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&cfg, kernel, a.rows, a.codes, a.queries,
                           a.codebooks, a.vals, a.ids, a.s, a.n, a.m, a.k,
                           a.dsub, a.tk, a.slots, a.cap);
  }
  if (e != cudaSuccess) return e;
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

// One thread block cluster of `cluster` CTAs a query (a power of two up
// to 8), the query's 32-slot chunks dealt to them in turn, slots =
// ceil(ceil(S/32) / cluster) * 32 the most a CTA takes; width: the code
// loads' bytes (M % width == 0, codes width-aligned).  spill = 0, the
// one-launch route (ops.py::fused_plan): keep = min(tk, slots); cap, the
// keys a CTA buffers, a multiple of 32, at most 4,096, at least max(32,
// pow2ceil(keep)), and at least slots or keep + 1,024.  spill = 1, the
// spill route (ops.py::fused_route): cap a power of two from 64 to
// 16,384, at least slots or keep + 1,024; keep <= min(tk, cap / 2) the
// keys a round selects (so a CTA's sorted share and its inbox, the other
// CTAs' shares, fit the buffer together).  vals/ids hold (B, tk).  Returns a cudaError_t.
extern "C" int adc_fused_topk(const int32_t* rows, const uint8_t* codes,
                              const float* queries, const float* codebooks,
                              float* vals, int32_t* ids, int b, int s, int n,
                              int m, int k, int dsub, int tk, int cluster,
                              int slots, int keep, int cap, int width,
                              int lut_int8, int spill, void* stream) {
  int pow2 = 32;
  while (pow2 < keep) pow2 <<= 1;
  const bool route_ok =
      spill ? cap >= 64 && cap <= kSpillMaxCap && (cap & (cap - 1)) == 0 &&
                  keep >= 1 && keep <= tk && keep <= cap / 2 &&
                  (cap >= slots || cap >= keep + kTile)
            : keep == (tk < slots ? tk : slots) && cap % 32 == 0 &&
                  cap <= kMaxCap && cap >= pow2 &&
                  (cap >= slots || cap >= keep + kTile);
  if (b < 1 || b > 65535 || s < 1 || n < 0 || m < 1 || k < 1 || k > 256 ||
      dsub < 1 || tk < 1 || tk > s || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) || !route_ok ||
      slots != ((s + 31) / 32 + cluster - 1) / cluster * 32 ||
      (width != 1 && width != 2 && width != 4 && width != 8 &&
       width != 16) || m % width)
    return (int)cudaErrorInvalidValue;
  const Args a{rows, codes, queries, codebooks, vals, ids, b, s, n, m, k,
               dsub, tk, cluster, slots, keep, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (spill)
    return (int)(lut_int8 ? dispatch<true, true>(width, a, st)
                          : dispatch<false, true>(width, a, st));
  return (int)(lut_int8 ? dispatch<true, false>(width, a, st)
                        : dispatch<false, false>(width, a, st));
}
