// GQA flash-attention forward on Hopper's tensor cores (sm_90a), f32 in
// 3xTF32.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/flash_attn.py::
// flash_attention_fwd (_flash_kernel) for f32 inputs with dh % 4 == 0,
// dh <= 256 (flash_attn/ops.py::flash_kernel routes bf16 to
// flash_attn_fwd_wgmma.cu; its wrapper pads other head widths with zero
// columns to a multiple of 4 and casts other dtypes first).
// q (B, S, H, dh), k (B, T, Hk, dh) and v (B, T, Hk, dv), dv <= dh, give
// o (B, S, H, dv) f32:
//     o[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h / G]) v[b, t, h / G]
// with G = H / Hk query heads per KV head (no KV copy per query head).
// dv < dh is MLA's prefill (DeepSeek-V2: q and k 192 wide, v 128).
// The TPU kernel's semantics (its _flash_kernel): causal
// masking aligned at the top left (key t kept for query s where t <= s,
// also when S != T); masked scores and the running max start at -1e30; the
// running (m, l, acc) are f32; the output is acc / max(l, 1e-30); KV tiles
// wholly above the diagonal are skipped; keys past T (the ragged last
// tile) score -inf and weigh exactly 0.  q is scaled in f32 before the
// product, by scale * log2(e), so the softmax works in base 2 (ex2.approx)
// on the same function, with the mask constant and the running-max start
// at -1e30 there too.
//
// What bounds it on an H100 SXM: operations.  At Qwen3-0.6B's attention
// widths (H = 16, Hk = 8, dh = 128), B = 1, S = T = 4096, causal, the two
// products are 68.7 GFLOP; in 3xTF32 each is done three times, 206 GFLOP,
// 0.4165 ms at the dense TF32 rate (495 TFLOP/s); its bytes (q, k, v, o:
// 100 MB in f32) take 0.03 ms.  A single TF32 product (10-bit mantissa)
// would move the scores by ~1e-3 and break the f32 tolerance (2e-5); the
// f32 CUDA cores alone could not go below 1.03 ms.
//
// Products in 3xTF32: each operand is split as hi = tf32(x) (round to
// nearest), lo = tf32(x - hi), and hi*lo + lo*hi + hi*hi is summed into
// the f32 accumulators (hopper.cuh).  TF32 wgmma takes both operands
// K-major and, unlike bf16, has no transpose bit, so:
//   * S = Q K^T (m64n32k8): Q and K both run along dh.  Q hi is kept in
//     registers (A from registers: kDh / 2 a thread), Q lo is split in
//     place in shared memory (A from shared memory), so two of the three
//     score products read only their B operand from shared memory; K hi
//     in place, K lo in a second buffer (B).
//   * O += P V (m64nDk8, D = kDv): P's A operand comes from registers.  The
//     f32 accumulator of S holds keys 2q, 2q + 1 of each 8-key group (q =
//     lane % 4), while a TF32 A fragment holds columns q and q + 4; since
//     the product sums over keys in any order, the k-th column of a group
//     is taken to be key pi(k) = 2k (k < 4), 2(k - 4) + 1 (k >= 4), so P's
//     registers feed the wgmma as they are (no shuffle, no trip through
//     shared memory).  V, whose rows run along dv, is MN-major for this
//     product, so the pass that splits it writes it transposed (dv rows
//     of 32 keys, key pi(k) at column k) in the 128-byte swizzle, hi over
//     the landed tile and lo into a second buffer.  The V^T rows of a
//     32-column box land in that box's own space, so the pass goes box by
//     box, each rewritten once all its values are read (8 values a
//     thread).  P is split in registers.
//
// Design (flash_fwd_tf32_kernel<kDh, kDv>): one block owns 64 query rows
// of one (batch, query head); two consumer warpgroups each take every
// other 32-key KV tile of those rows (tiles wg, wg + 2, ...) with their
// own running (m, l, acc), and merge the two at the end (through shared
// memory), so one's softmax and splits run under the other's products.
// A producer warpgroup (one thread issues the loads) issues TMA loads
// (4-d tensor maps, 128-byte swizzle, 32-column boxes) of the q tile once
// and of K and V tiles into a ring of stages, K and V with barriers of
// their own (full barriers in transaction bytes, empty barriers that the
// four warps of the consuming warpgroup arrive on).  A warpgroup splits
// K, issues S = Q K^T, splits and transposes V (at kDh = 192 on the CUDA
// cores while that product runs; at kDh <= 128 before it, which keeps
// fewer registers live), releases K once S is in (so the next K of the
// stage lands under the softmax and P V), and V once P V is in.  Before a
// warpgroup waits for tile j's K or V it waits for tile j - kStages, the
// last one in that stage, to have released it, so a full-barrier wait is
// never two phases ahead.  ptxas sizes the kernel to 168 registers a
// thread, and setmaxnreg (24 for the producer, 240 for the consumers)
// does not lift that for the consumers' code; at (192, 128) Q hi (96), O
// (64) and S (16) exceed it, and it spills.  With a producer warp (288
// threads, the same 168) the kernel read 8-15% slower
// (scripts/kernel_ab.py, PERF.md section 6).  Blocks are ordered with the
// longest causal q tiles first.
//
// Instances (kDh, kDv): (32, 32), the narrow kernel below; (64, 64) and
// (128, 128), 3 stages (shared memory q 32 KB + 3 x (K hi, K lo, V^T hi,
// V^T lo) 64 KB = 224 KB at 128, 112 KB at 64); (192, 128), DeepSeek-V2's
// MLA: Q K^T at K = 192 (24 k8 steps), P V at N = 128 (m64n128k8), Q hi
// 96 registers and O 64 a thread, 2 stages (q 48 KB + 2 x (K 24 + K lo 24
// + V^T 16 + V^T lo 16) KB = 208 KB); (256, 256), the wide kernel below.
// The rule (the C entry point's, flash_attn/ops.py::flash_plan's): dh <=
// 32 (so dv <= 32) runs on (32, 32), 32 < dh <= 64 on (64, 64), 64 < dh
// <= 128 on (128, 128) (dh = 96 at 4/3 of its own work), 128 < dh <= 192
// with dv <= 128 on (192, 128), the rest on (256, 256); dh and dv are the
// widths after rounding up to a multiple of 4.  The tensor maps take the
// true dh (q, K) and dv (V) as their inner extent and the caller's element
// strides of the batch, row and head axes (the last axis unit-stride; TMA
// needs the base and every stride on 16 bytes: dh % 4 == 0, dv % 4 == 0,
// strides % 4 == 0), so views such as the q, k and v split from one (B, S,
// 3H, dh) tensor are read as they lie, and TMA fills the columns past dh
// or dv of a 32-column box with zeros (never a neighbouring head's).  A
// box that would lie
// wholly past dh or dv (the last q/K box at dh <= 96; a V box past dv) is
// never loaded: its space in the q tile and in every stage's K or V is
// cleared once at the start, and stays zero, because the splits turn
// zeros into zeros (K hi and lo; the V^T rows past dv, which come from
// zero columns, land in that same space).  Zero columns add nothing to a
// score, and the output columns past dv are not stored.  At the MLA shape
// (B = 1, S = T = 4096, H = Hk = 16, causal) the products are 85.9 GFLOP,
// 257.7 as 3xTF32: 0.5207 ms at the TF32 rate.
//
// 192 < dh <= 256, or dv > 128 (the kDh = 256 kernel,
// flash_fwd_tf32_wide_kernel).  The layout above does not fit: O alone is
// 128 floats a thread, Q hi another 128, and a 32-key stage 128 KB beside
// a 64 KB q tile.  So the two warpgroups split the head width instead of
// the keys: both take every KV tile of the block's 64 rows, warpgroup w
// the columns [128 w, 128 w + 128) of q, K and V.  Each computes its
// partial scores over its 128 columns (its 64 Q hi registers, Q lo in
// place in shared memory, K hi and lo of its half: m64n16k8 in 3xTF32),
// the two hand their partial S to each other through shared memory (8
// floats a thread, double buffered by tile parity, one barrier of both
// warpgroups a tile), both run the same online softmax on the sum, and
// each accumulates O for its own 128 columns (64 registers, m64n128k8): no
// merge at the end, and no product is done twice.  KV tiles hold 16 keys
// in a 2-stage ring: a stage is K (16 KB, hi in place), K lo, V (landed,
// then V^T hi in place) and V^T lo; V^T has rows of 16 keys (64 bytes), so
// it takes the 64-byte swizzle (chunk ^ ((row >> 1) & 3), 512-byte
// atoms).  Each warpgroup splits and transposes only its own half of a
// stage.  Shared memory: q 64 KB + 2 x 64 KB + 16 KB for the exchange =
// 208 KB.  V's tensor map takes the true dv here too, its boxes past dv
// cleared once.
//
// dh <= 32 (the narrow kernel, flash_fwd_tf32_narrow_kernel; BERT4Rec's
// two heads of 32 at B = 512, S = T = 200 are its shape).  There the
// layout above wastes most of its work: (64, 64) runs both products at 64
// wide, the four blocks of a (batch, head) each load and split the same K
// and V, and a 64-row block meets 200 keys in 7 tiles shared by two
// warpgroups, so its set-up and merge are as long as its products.  So a
// unit of work is a (batch, KV head) with the query rows of its G query
// heads, as up to four 64-row q tiles (tile u = q tile * G + query head;
// chunks of four consecutive u where there are more); four consumer
// warpgroups (512 threads, at most 128 registers each) take one q tile
// each over all the unit's keys, with their own (m, l, acc), so nothing is
// merged.  K and V come in 40-key tiles (200 = 5 x 40): TMA lands raw K
// and V (a 32-column box each) in a ring of 3 stages, and the block's 16
// warps split each tile once, one tile ahead, under the S product (warps
// 0-4 transpose V into V^T hi and lo, 8 keys of one column a thread;
// warps 5-14 split K, a float4 a thread); every warpgroup reads the split
// tile: S = Q K^T by m64n40k8 (K = 32: four k-steps), O += P V by
// m64n32k8 (five k-steps; V^T in two 32-key boxes, the second holding
// keys 32..39).  Barriers a stage: full (TMA bytes of raw K and V), split
// (16 warps: the split buffers are in), empty (16 warps: their products
// are done).  Q hi lives in registers and Q lo in place of the warpgroup's
// q tile (the S product reads it there, the tile released at the unit's
// end), and every warpgroup issues its products on every tile (the
// causal mask zeroes the keys past its rows; a warpgroup without a q tile
// computes on whatever its slot holds and stores nothing): with Q lo in
// registers too, or a branch around a wgmma, or a call in the function
// (__fdiv_rn's slow path: the output is scaled by rcp(l) instead), ptxas
// serialises every wgmma of the kernel (its advisories C7512, C7518:
// each product waits for the one before).  The 3xTF32
// split takes three instructions (tf32_hi below) where cvt.rna takes
// four for hi and four more for lo.  Lane 0 of warp 15, which has no
// share of the split, issues the loads after its split share, from
// cursors in shared memory: KV tiles up to three ahead (the raw stage of
// tile j is free once the split barrier of tile j has passed), and the
// next unit's q tiles into the other of two q buffers once the unit two
// before has released it (tested, not waited for; at a unit's start it
// waits if it must, which every other warp can let pass), with the unit's
// coordinates beside them in shared memory, so the consumers divide
// nothing.  The grid is persistent (a block an SM, the units in turn,
// longest causal chunks first), so the next unit's loads and splits run
// under this one's products and its output stores.  Shared memory: 2 x 32
// KB of q + 3 x (raw K 5, raw V 5, K hi 5, K lo 5, V^T hi 8, V^T lo 8) KB
// = 172 KB.  At BERT4Rec's shape: 1,024 units, 7.8 a block, 28% of the
// score rows padding (200 -> 256 rows), none of the keys.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_lse.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;               // query rows per block
constexpr int kBKV = 32;              // keys per KV tile
constexpr int kConsumerThreads = 256; // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;   // + one producer warp
// flash_fwd_tf32_kernel: a producer warpgroup, and the registers a thread
// of each role holds after setmaxnreg (of the 168 each at launch)
constexpr int kSplitThreads = kConsumerThreads + 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBox = 32;              // f32 columns per 128-byte TMA box
constexpr float kNegInf = -1e30f;     // the TPU kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// barriers: q, then per stage full K, full V, empty K, empty V (the 256
// kernel's stages use full K and empty K for K and V together)
constexpr int kMaxStages = 3;
constexpr int kBarQ = 0, kBarFullK = 1, kBarFullV = 1 + kMaxStages,
              kBarEmptyK = 1 + 2 * kMaxStages,
              kBarEmptyV = 1 + 3 * kMaxStages, kNumBars = 1 + 4 * kMaxStages;

template <int kDh, int kDv>
struct Cfg {
  static constexpr int kStages = kDh > 128 ? 2 : 3;       // KV ring depth
  static constexpr int kBoxes = kDh / kBox;               // q, K boxes a row
  static constexpr int kVBoxes = kDv / kBox;              // V boxes a row
  static constexpr int kQBytes = kBoxes * kBQ * 128;      // the q tile
  static constexpr int kKBytes = kBoxes * kBKV * 128;     // K hi or K lo
  static constexpr int kVBytes = kVBoxes * kBKV * 128;    // V (V^T) hi or lo
  // a stage: K hi (landed, split in place) | K lo | V, then V^T hi (in
  // place) | V^T lo; V^T is kDv rows x 128 B (32 keys), kVBytes too
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kVBytes;
  static constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + 1024;
  static constexpr int kOr = kDv / 2;        // O registers a thread
  static constexpr int kQr = kDh / 2;        // Q hi registers a thread
  // V^T written before S is issued (fewer registers live), or under it
  static constexpr bool kVFirst = kDh <= 128;
  static_assert(kStages <= kMaxStages && kOr * 128 * 4 <= kQBytes,
                "the merge hands O over through the q tile's space");
};

// d (64 x 32) (+)= A (64 x 8, smem) * B (32 x 8, smem)^T in TF32, both
// K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
      ", %16, %17, p, 1, 1;\n}\n"
      : D16
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 32) += A (64 x 8, registers) * B (32 x 8, smem)^T in TF32
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x N) += A (64 x 8, registers) * B (N x 8, smem)^T in TF32, N = 128
// or 64
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// whether the phase of the given parity has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// 1 / x within an ulp (MUFU.RCP), no call
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barriers (hopper.cuh named_sync): 1 for both consumer
// warpgroups, 2 + w for warpgroup w

// byte offset of element (r, c) of a tile of 32-column, 128-byte-swizzled
// boxes of `rows` rows each (TMA's layout)
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c / kBox) * rows * 128 + r * 128 +
         ((((c % kBox) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// the key (0..31 of a tile) at k-position k of V^T and of P's A
// fragments: 2k for k % 8 < 4, 2(k - 4) + 1 for the rest of each group
__device__ __forceinline__ int key_of(int k) {
  return (k & ~7) + ((k & 7) < 4 ? 2 * (k & 7) : 2 * ((k & 7) - 4) + 1);
}

// S = Q K^T of one 32-key tile in 3xTF32, issued and committed: dh / 8
// k-steps; step kk reads 32 bytes at (kk % 4) * 32 of the 128-byte rows of
// box kk / 4 (Q lo at qa, K hi at kha, K lo at kla; Q hi from registers)
template <int kDh>
__device__ __forceinline__ void issue_qk(float (&s)[16],
                                         const uint32_t (&q_hi)[kDh / 2],
                                         uint32_t qa, uint32_t kha,
                                         uint32_t kla) {
#pragma unroll
  for (int r = 0; r < 16; ++r) s[r] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 8; ++kk) {
    const uint32_t qoff = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * kBKV * 128 + (kk % 4) * 32;
    const uint64_t dkh = desc(kha + koff, 16, 1024);
    mma_rs_n32(s, &q_hi[4 * kk], desc(kla + koff, 16, 1024));
    mma_ss_n32(s, desc(qa + qoff, 16, 1024), dkh, 1);
    mma_rs_n32(s, &q_hi[4 * kk], dkh);
  }
  wgmma_commit();
}

// V (landed at vh, kDv columns in 32-column boxes) split and transposed
// into V^T hi (over it) and V^T lo (at vl), box by box: the V^T rows of a
// box's columns land in that box's own space, so a box is rewritten once
// all its values are read.  Thread t of warpgroup wg takes column 32 c +
// t % 32 of box c, keys kb .. kb + 7, kb = 8 (t / 32)
template <int kDv>
__device__ __forceinline__ void split_v(uint8_t* vh, uint8_t* vl, int t,
                                        int wg) {
  const int kb = 8 * (t / 32);
#pragma unroll
  for (int c = 0; c < kDv / kBox; ++c) {
    const int n = 32 * c + t % 32;
    float vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vals[e] = *reinterpret_cast<const float*>(vh + swz(kb + e, n, kBKV));
    named_sync(2 + wg, 128);                // every value of box c is read
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int p0 = kb + 4 * g;            // k-positions p0 .. p0 + 3
      float hv[4], lv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = vals[key_of(4 * g + e)];   // kb % 8 == 0
        hv[e] = tf32_rna(x);
        lv[e] = tf32_rna(__fsub_rn(x, hv[e]));
      }
      const uint32_t off = n * 128 + ((((p0 >> 2) ^ (n & 7))) << 4);
      *reinterpret_cast<float4*>(vh + off) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(vl + off) =
          make_float4(lv[0], lv[1], lv[2], lv[3]);
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);                  // V^T hi and lo are in
}

// ------------------------------------------------------------------ kernel
template <int kDh, int kDv>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      float* __restrict__ o, float* __restrict__ lse,
                      int s_len, int t_len, int h_q, int h_kv, int dh, int dv,
                      float q_scale, int causal) {
  using C = Cfg<kDh, kDv>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  uint8_t* base = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                              smem_u32(smem_raw));
  uint8_t* q_s = base;
  auto k_hi = [&](int st) { return q_s + C::kQBytes + st * C::kStageBytes; };
  auto k_lo = [&](int st) { return k_hi(st) + C::kKBytes; };
  auto v_hi = [&](int st) { return k_hi(st) + 2 * C::kKBytes; };
  auto v_lo = [&](int st) { return v_hi(st) + C::kVBytes; };
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const int tid = threadIdx.x;
  const int n_qt = (s_len + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBQ;   // longest first
  const int bb = blockIdx.x / h_q, h = blockIdx.x % h_q;
  const int kh = h / (h_q / h_kv);
  const int q_last = min(q0 + kBQ, s_len) - 1;
  const int n_kv_all = (t_len + kBKV - 1) / kBKV;
  const int n_kv = causal ? min(n_kv_all, q_last / kBKV + 1) : n_kv_all;
  const int nb = (dh + kBox - 1) / kBox;            // q, K boxes TMA loads
  const int nbv = (dv + kBox - 1) / kBox;           // V boxes TMA loads

  if (tid == 0) {
    mbar_init(bar(kBarQ), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar(kBarFullK + st), 1);
      mbar_init(bar(kBarFullV + st), 1);
      mbar_init(bar(kBarEmptyK + st), 4);  // the warps of one warpgroup
      mbar_init(bar(kBarEmptyV + st), 4);
    }
    fence_mbar_init();
  }
  // the boxes past nb (q, K) and past nbv (V): zeros in the q tile and in
  // each stage's K and V
  auto clear = [&](uint8_t* p, int bytes) {
    for (int i = tid; i < bytes / 16; i += kSplitThreads)
      reinterpret_cast<float4*>(p)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  for (int c = nb; c < C::kBoxes; ++c) {
    clear(q_s + c * kBQ * 128, kBQ * 128);
    for (int st = 0; st < kStages; ++st)
      clear(k_hi(st) + c * kBKV * 128, kBKV * 128);
  }
  for (int c = nbv; c < C::kVBoxes; ++c)
    for (int st = 0; st < kStages; ++st)
      clear(v_hi(st) + c * kBKV * 128, kBKV * 128);
  __syncthreads();

  // one branch a role, never joined again, so ptxas sizes each by its
  // setmaxnreg; the warpgroup index made warp-uniform to its eyes
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {                                     // producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumerThreads) {
      mbar_expect_tx(bar(kBarQ), nb * kBQ * 128);
      for (int c = 0; c < nb; ++c)
        tma_load_4d(smem_u32(q_s) + c * kBQ * 128, &map_q, bar(kBarQ),
                    c * kBox, h, q0, bb);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kStages;
        const uint32_t ph = ((j / kStages) - 1) & 1;   // of tile j - kStages
        if (j >= kStages) mbar_wait(bar(kBarEmptyK + st), ph);
        mbar_expect_tx(bar(kBarFullK + st), nb * kBKV * 128);
        for (int c = 0; c < nb; ++c)
          tma_load_4d(smem_u32(k_hi(st)) + c * kBKV * 128, &map_k,
                      bar(kBarFullK + st), c * kBox, kh, j * kBKV, bb);
        if (j >= kStages) mbar_wait(bar(kBarEmptyV + st), ph);
        mbar_expect_tx(bar(kBarFullV + st), nbv * kBKV * 128);
        for (int c = 0; c < nbv; ++c)
          tma_load_4d(smem_u32(v_hi(st)) + c * kBKV * 128, &map_v,
                      bar(kBarFullV + st), c * kBox, kh, j * kBKV, bb);
      }
    }
  } else {
    // ---- consumer warpgroup wg: KV tiles wg, wg + 2, ... of all 64 rows
    setmaxnreg_inc<kConsumerRegs>();
    const int t = tid % 128;
    const int lane = t % 32, quad = lane % 4;
    const int ra = 16 * (t / 32) + lane / 4;      // tile rows ra, ra + 8

    // Q hi into registers as TF32 A fragments: k-step kk holds (ra, 8 kk +
    // quad), (ra + 8, ..), (ra, 8 kk + quad + 4), (ra + 8, ..); both
    // warpgroups read the scaled q before Q lo is split in place
    uint32_t q_hi[C::kQr];
    mbar_wait(bar(kBarQ), 0);
#pragma unroll
    for (int kk = 0; kk < kDh / 8; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ra + 8 * (i & 1), c = 8 * kk + quad + 4 * (i >> 1);
        const float x =
            __fmul_rn(*reinterpret_cast<const float*>(q_s + swz(r, c, kBQ)),
                      q_scale);
        q_hi[4 * kk + i] = __float_as_uint(tf32_rna(x));
      }
    }
    named_sync(1, kConsumerThreads);
    {
      auto lo = [&](float v) {
        const float y = __fmul_rn(v, q_scale);
        return tf32_rna(__fsub_rn(y, tf32_rna(y)));
      };
      for (int i = tid; i < C::kQBytes / 16; i += kConsumerThreads) {
        float4* p = reinterpret_cast<float4*>(q_s) + i;
        const float4 x = *p;
        *p = make_float4(lo(x.x), lo(x.y), lo(x.z), lo(x.w));
      }
    }
    fence_proxy_async();
    named_sync(1, kConsumerThreads);

    float o_acc[C::kOr];
#pragma unroll
    for (int i = 0; i < C::kOr; ++i) o_acc[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    const int row_a = q0 + ra;
    const uint32_t qa = smem_u32(q_s);

    for (int j = wg; j < n_kv; j += 2) {
      const int st = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      // tile j - kStages, the stage's last, released its K (by the other
      // warpgroup where kStages is odd), so its load had landed: the wait
      // below is for tile j's phase
      if (j >= kStages) mbar_wait(bar(kBarEmptyK + st), ph ^ 1);
      mbar_wait(bar(kBarFullK + st), ph);

      // ---- split K in place (hi) and into K lo
      {
        float4* kh4 = reinterpret_cast<float4*>(k_hi(st));
        float4* kl4 = reinterpret_cast<float4*>(k_lo(st));
#pragma unroll
        for (int i = 0; i < C::kKBytes / 16 / 128; ++i) {
          const float4 x = kh4[t + 128 * i];
          const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y),
                                        tf32_rna(x.z), tf32_rna(x.w));
          kh4[t + 128 * i] = hi;
          kl4[t + 128 * i] = make_float4(
              tf32_rna(__fsub_rn(x.x, hi.x)), tf32_rna(__fsub_rn(x.y, hi.y)),
              tf32_rna(__fsub_rn(x.z, hi.z)), tf32_rna(__fsub_rn(x.w, hi.w)));
        }
        fence_proxy_async();
        named_sync(2 + wg, 128);              // the split K is in
      }

      // ---- S = Q K^T issued, and V split and transposed into V^T: at
      // kDh = 192 under that product, at kDh <= 128 before it
      float s[16];
      const uint32_t kha = smem_u32(k_hi(st)), kla = smem_u32(k_lo(st));
      auto wait_v = [&] {
        if (j >= kStages) mbar_wait(bar(kBarEmptyV + st), ph ^ 1);
        mbar_wait(bar(kBarFullV + st), ph);
      };
      if constexpr (C::kVFirst) {
        wait_v();
        split_v<kDv>(v_hi(st), v_lo(st), t, wg);
        issue_qk<kDh>(s, q_hi, qa, kha, kla);
      } else {
        issue_qk<kDh>(s, q_hi, qa, kha, kla);
        wait_v();
        split_v<kDv>(v_hi(st), v_lo(st), t, wg);
      }

      wgmma_wait_all();
      fence_regs(s);
      if (lane == 0) mbar_arrive(bar(kBarEmptyK + st));  // K free

      // ---- online softmax, base 2; element r: row ra (r & 2 == 0) or
      // ra + 8, key j*kBKV + 8*(r/4) + 2*quad + (r & 1)
      const int k0 = j * kBKV;
      const bool edge = k0 + kBKV > t_len || (causal && k0 + kBKV - 1 > q0);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float x = s[r];
        if (edge) {
          const int kp = k0 + 8 * (r / 4) + 2 * quad + (r & 1);
          const int qp = row_a + ((r & 2) ? 8 : 0);
          if (kp >= t_len) x = -INFINITY;
          else if (causal && kp > qp) x = kNegInf;
        }
        s[r] = x;
        if (r & 2) mx_b = fmaxf(mx_b, x);
        else mx_a = fmaxf(mx_a, x);
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = ex2(__fsub_rn(m_a, mn_a));
      const float corr_b = ex2(__fsub_rn(m_b, mn_b));
      m_a = mn_a;
      m_b = mn_b;
      // P as TF32 A fragments: k-step c holds elements 4c, 4c + 2 (rows ra,
      // ra + 8 at key 2 quad: column quad) and 4c + 1, 4c + 3 (key 2 quad +
      // 1: column quad + 4), split into hi and lo
      float sum_a = 0.f, sum_b = 0.f;
      uint32_t p_hi[16], p_lo[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = ex2(__fsub_rn(s[r], (r & 2) ? mn_b : mn_a));
        if (r & 2) sum_b = __fadd_rn(sum_b, p);
        else sum_a = __fadd_rn(sum_a, p);
        const float hi = tf32_rna(p);
        const int slot = 4 * (r / 4) + ((r & 2) ? 1 : 0) + ((r & 1) ? 2 : 0);
        p_hi[slot] = __float_as_uint(hi);
        p_lo[slot] = __float_as_uint(tf32_rna(__fsub_rn(p, hi)));
      }
      l_a = __fadd_rn(__fmul_rn(l_a, corr_a), sum_a);
      l_b = __fadd_rn(__fmul_rn(l_b, corr_b), sum_b);
#pragma unroll
      for (int r = 0; r < C::kOr; ++r)
        o_acc[r] = __fmul_rn(o_acc[r], (r & 2) ? corr_b : corr_a);

      // ---- O += P V: four k-steps of 8 keys; step c reads 32 bytes at c *
      // 32 of V^T's 128-byte rows
      const uint32_t vha = smem_u32(v_hi(st)), vla = smem_u32(v_lo(st));
      fence_regs(o_acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kBKV / 8; ++c) {
        const uint64_t dvh = desc(vha + c * 32, 16, 1024);
        const uint64_t dvl = desc(vla + c * 32, 16, 1024);
        if constexpr (kDv == 128) {
          mma_rs_n128(o_acc, &p_hi[4 * c], dvl);
          mma_rs_n128(o_acc, &p_lo[4 * c], dvh);
          mma_rs_n128(o_acc, &p_hi[4 * c], dvh);
        } else {
          mma_rs_n64(o_acc, &p_hi[4 * c], dvl);
          mma_rs_n64(o_acc, &p_lo[4 * c], dvh);
          mma_rs_n64(o_acc, &p_hi[4 * c], dvh);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
      if (lane == 0) mbar_arrive(bar(kBarEmptyV + st));  // V free
    }

    // ---- merge: warpgroup 1 hands (m, l, acc) to warpgroup 0 through the
    // q tile's space and stage 0's (no product reads them any more, no load
    // is left), thread t to thread t
    named_sync(1, kConsumerThreads);
    float* xo = reinterpret_cast<float*>(q_s);
    float (*ml_s)[128] = reinterpret_cast<float (*)[128]>(k_hi(0));
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < C::kOr; ++r) xo[r * 128 + t] = o_acc[r];
      ml_s[0][t] = m_a;
      ml_s[1][t] = m_b;
      ml_s[2][t] = l_a;
      ml_s[3][t] = l_b;
    }
    named_sync(1, kConsumerThreads);
    if (wg == 1) return;
    const float m1a = ml_s[0][t], m1b = ml_s[1][t];
    const float ma = fmaxf(m_a, m1a), mb = fmaxf(m_b, m1b);
    const float c0a = ex2(__fsub_rn(m_a, ma)), c1a = ex2(__fsub_rn(m1a, ma));
    const float c0b = ex2(__fsub_rn(m_b, mb)), c1b = ex2(__fsub_rn(m1b, mb));
    l_a = __fadd_rn(__fmul_rn(l_a, c0a), __fmul_rn(ml_s[2][t], c1a));
    l_b = __fadd_rn(__fmul_rn(l_b, c0b), __fmul_rn(ml_s[3][t], c1b));
    // the quad's partial row sums, then acc / max(l, 1e-30)
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l_a = __fadd_rn(l_a, __shfl_xor_sync(0xffffffffu, l_a, sh));
      l_b = __fadd_rn(l_b, __shfl_xor_sync(0xffffffffu, l_b, sh));
    }
    const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
    flash_lse::store_rows(lse, ((long long)bb * h_q + h) * s_len, row_a,
                          s_len, quad, ma, la, mb, lb);
    const long long row_stride = (long long)h_q * dv;
    float* ob = o + ((long long)bb * s_len * h_q + h) * dv;
#pragma unroll
    for (int r = 0; r < C::kOr; r += 2) {
      const bool b_row = r & 2;
      const int row = row_a + (b_row ? 8 : 0);
      const int col = 8 * (r / 4) + 2 * quad;   // dv % 4 == 0: col + 1 < dv too
      if (row >= s_len || col >= dv) continue;
      const float c0 = b_row ? c0b : c0a, c1 = b_row ? c1b : c1a;
      const float l = b_row ? lb : la;
      const float v0 = __fadd_rn(__fmul_rn(o_acc[r], c0),
                                 __fmul_rn(xo[r * 128 + t], c1));
      const float v1 = __fadd_rn(__fmul_rn(o_acc[r + 1], c0),
                                 __fmul_rn(xo[(r + 1) * 128 + t], c1));
      *reinterpret_cast<float2*>(ob + row * row_stride + col) =
          make_float2(__fdiv_rn(v0, l), __fdiv_rn(v1, l));
    }
  }
}


// ---------------------------------- kernel, dh <= 256 (and dv > 128)
constexpr int kWideDh = 256;
constexpr int kWideBKV = 16;                   // keys per KV tile
constexpr int kWideStages = 2;
constexpr int kWideBoxes = kWideDh / kBox;     // 8 boxes of 32 columns
constexpr int kWideQBytes = kWideBoxes * kBQ * 128;          // 64 KB
constexpr int kWideBoxBytes = kWideBKV * 128;                // 2 KB
constexpr int kWideKvBytes = kWideBoxes * kWideBoxBytes;     // 16 KB
constexpr int kWideStageBytes = 4 * kWideKvBytes;            // 64 KB
constexpr int kWideXBytes = 2 * 2 * 8 * 128 * 4;             // 16 KB
constexpr int kWideSmemBytes =
    kWideQBytes + kWideStages * kWideStageBytes + kWideXBytes + 1024;

// d (64 x 16) (+)= A (64 x 8, smem) * B (16 x 8, smem)^T in TF32, both
// K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_ss_n16(float (&d)[8], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 16) += A (64 x 8, registers) * B (16 x 8, smem)^T in TF32
__device__ __forceinline__ void mma_rs_n16(float (&d)[8], const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           float* __restrict__ o, float* __restrict__ lse,
                           int s_len, int t_len, int h_q, int h_kv, int dh,
                           int dv, float q_scale, int causal) {
  constexpr int kBKV = kWideBKV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  uint8_t* base = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                              smem_u32(smem_raw));
  uint8_t* q_s = base;
  auto k_hi = [&](int st) {
    return q_s + kWideQBytes + st * kWideStageBytes;
  };
  auto k_lo = [&](int st) { return k_hi(st) + kWideKvBytes; };
  auto v_hi = [&](int st) { return k_hi(st) + 2 * kWideKvBytes; };
  auto v_lo = [&](int st) { return k_hi(st) + 3 * kWideKvBytes; };
  // the partial scores: [tile parity][warpgroup][element][thread]
  float* xs = reinterpret_cast<float*>(q_s + kWideQBytes +
                                       kWideStages * kWideStageBytes);
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const int tid = threadIdx.x;
  const int n_qt = (s_len + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBQ;   // longest first
  const int bb = blockIdx.x / h_q, h = blockIdx.x % h_q;
  const int kh = h / (h_q / h_kv);
  const int q_last = min(q0 + kBQ, s_len) - 1;
  const int n_kv_all = (t_len + kBKV - 1) / kBKV;
  const int n_kv = causal ? min(n_kv_all, q_last / kBKV + 1) : n_kv_all;
  const int nb = (dh + kBox - 1) / kBox;            // q, K boxes TMA loads
  const int nbv = (dv + kBox - 1) / kBox;           // V boxes TMA loads

  if (tid == 0) {
    mbar_init(bar(kBarQ), 1);
    for (int st = 0; st < kWideStages; ++st) {
      mbar_init(bar(kBarFullK + st), 1);
      mbar_init(bar(kBarEmptyK + st), 8);  // the warps of both warpgroups
    }
    fence_mbar_init();
  }
  // the boxes past nb (q, K) and past nbv (V): zeros in the q tile and in
  // each stage's K and V
  auto clear = [&](uint8_t* p, int bytes) {
    for (int i = tid; i < bytes / 16; i += kThreads)
      reinterpret_cast<float4*>(p)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  for (int c = nb; c < kWideBoxes; ++c) {
    clear(q_s + c * kBQ * 128, kBQ * 128);
    for (int st = 0; st < kWideStages; ++st)
      clear(k_hi(st) + c * kWideBoxBytes, kWideBoxBytes);
  }
  for (int c = nbv; c < kWideBoxes; ++c)
    for (int st = 0; st < kWideStages; ++st)
      clear(v_hi(st) + c * kWideBoxBytes, kWideBoxBytes);
  __syncthreads();

  if (tid >= kConsumerThreads) {                     // producer warp
    if (tid == kConsumerThreads) {
      mbar_expect_tx(bar(kBarQ), nb * kBQ * 128);
      for (int c = 0; c < nb; ++c)
        tma_load_4d(smem_u32(q_s) + c * kBQ * 128, &map_q, bar(kBarQ),
                    c * kBox, h, q0, bb);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kWideStages;
        if (j >= kWideStages)
          mbar_wait(bar(kBarEmptyK + st), ((j / kWideStages) - 1) & 1);
        mbar_expect_tx(bar(kBarFullK + st), (nb + nbv) * kWideBoxBytes);
        for (int c = 0; c < nb; ++c)
          tma_load_4d(smem_u32(k_hi(st)) + c * kWideBoxBytes, &map_k,
                      bar(kBarFullK + st), c * kBox, kh, j * kBKV, bb);
        for (int c = 0; c < nbv; ++c)
          tma_load_4d(smem_u32(v_hi(st)) + c * kWideBoxBytes, &map_v,
                      bar(kBarFullK + st), c * kBox, kh, j * kBKV, bb);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: columns [128 wg, 128 wg + 128) of all 64
  // rows and every KV tile
  const int wg = tid / 128, t = tid % 128;
  const int lane = t % 32, quad = lane % 4;
  const int ra = 16 * (t / 32) + lane / 4;      // tile rows ra, ra + 8
  const int c0 = 128 * wg;                      // the warpgroup's columns
  const int box0 = 4 * wg;                      // and 32-column boxes

  // Q hi of the warpgroup's columns into registers as TF32 A fragments
  // (k-step kk: columns c0 + 8 kk ..), then its Q lo in place: hi takes
  // part in two of the three score products, so from registers it halves
  // the shared-memory A operand reads of the small m64n16k8 products
  uint32_t q_hi[64];
  mbar_wait(bar(kBarQ), 0);
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ra + 8 * (i & 1);
      const int c = c0 + 8 * kk + quad + 4 * (i >> 1);
      const float x =
          __fmul_rn(*reinterpret_cast<const float*>(q_s + swz(r, c, kBQ)),
                    q_scale);
      q_hi[4 * kk + i] = __float_as_uint(tf32_rna(x));
    }
  }
  named_sync(2 + wg, 128);
  {
    auto lo = [&](float v) {
      const float y = __fmul_rn(v, q_scale);
      return tf32_rna(__fsub_rn(y, tf32_rna(y)));
    };
    float4* half = reinterpret_cast<float4*>(q_s + box0 * kBQ * 128);
    for (int i = t; i < 4 * kBQ * 8; i += 128) {
      const float4 x = half[i];
      half[i] = make_float4(lo(x.x), lo(x.y), lo(x.z), lo(x.w));
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);

  float o_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o_acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const int row_a = q0 + ra;
  const uint32_t qa = smem_u32(q_s);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kWideStages;
    mbar_wait(bar(kBarFullK + st), (j / kWideStages) & 1);

    // ---- this warpgroup's half of the stage: K split in place (hi) and
    // into K lo; V (column c0 + t) transposed into V^T row t of the half
    float4* kh4 = reinterpret_cast<float4*>(k_hi(st) +
                                            box0 * kWideBoxBytes);
    float4* kl4 = reinterpret_cast<float4*>(k_lo(st) +
                                            box0 * kWideBoxBytes);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = kh4[t + 128 * i];
      const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y),
                                    tf32_rna(x.z), tf32_rna(x.w));
      kh4[t + 128 * i] = hi;
      kl4[t + 128 * i] = make_float4(
            tf32_rna(__fsub_rn(x.x, hi.x)), tf32_rna(__fsub_rn(x.y, hi.y)),
            tf32_rna(__fsub_rn(x.z, hi.z)), tf32_rna(__fsub_rn(x.w, hi.w)));
    }
    float vals[kBKV];
#pragma unroll
    for (int e = 0; e < kBKV; ++e)
      vals[e] = *reinterpret_cast<const float*>(
          v_hi(st) + swz(e, c0 + t, kBKV));
    named_sync(2 + wg, 128);                // every V value of the half read
    uint8_t* vh = v_hi(st) + box0 * kWideBoxBytes + t * 64;
    uint8_t* vl = v_lo(st) + box0 * kWideBoxBytes + t * 64;
#pragma unroll
    for (int c = 0; c < kBKV / 4; ++c) {     // k-positions 4c .. 4c + 3
      float hv[4], lv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = vals[key_of(4 * c + e)];
        hv[e] = tf32_rna(x);
        lv[e] = tf32_rna(__fsub_rn(x, hv[e]));
      }
      const int off = (c ^ ((t >> 1) & 3)) << 4;   // 64-byte swizzle
      *reinterpret_cast<float4*>(vh + off) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(vl + off) =
          make_float4(lv[0], lv[1], lv[2], lv[3]);
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);                // the split half is in

    // ---- partial S = Q K^T over the warpgroup's 128 columns: 16
    // k-steps; step kk reads 32 bytes at (kk % 4) * 32 of box box0 + kk / 4
    // (Q lo there, Q hi from registers)
    float s[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = 0.f;
    const uint32_t kha = smem_u32(k_hi(st)), kla = smem_u32(k_lo(st));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int box = box0 + kk / 4;
      const uint32_t qoff = box * kBQ * 128 + (kk % 4) * 32;
      const uint32_t koff = box * kWideBoxBytes + (kk % 4) * 32;
      const uint64_t dkh = desc(kha + koff, 16, 1024);
      mma_rs_n16(s, &q_hi[4 * kk], desc(kla + koff, 16, 1024));
      mma_ss_n16(s, desc(qa + qoff, 16, 1024), dkh, 1);
      mma_rs_n16(s, &q_hi[4 * kk], dkh);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // ---- the two partial scores summed (a + b == b + a, so both
    // warpgroups hold the same bits), through a buffer of the tile's
    // parity: the other warpgroup read this tile's values before it
    // reached the next tile's barrier
    float* mine = xs + ((j & 1) * 2 + wg) * 8 * 128;
    float* theirs = xs + ((j & 1) * 2 + (1 - wg)) * 8 * 128;
#pragma unroll
    for (int r = 0; r < 8; ++r) mine[r * 128 + t] = s[r];
    named_sync(1, kConsumerThreads);
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = __fadd_rn(s[r], theirs[r * 128 + t]);

    // ---- online softmax, base 2; element r: row ra (r & 2 == 0) or
    // ra + 8, key j*kBKV + 8*(r/4) + 2*quad + (r & 1)
    const int k0 = j * kBKV;
    const bool edge = k0 + kBKV > t_len || (causal && k0 + kBKV - 1 > q0);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float x = s[r];
      if (edge) {
        const int kp = k0 + 8 * (r / 4) + 2 * quad + (r & 1);
        const int qp = row_a + ((r & 2) ? 8 : 0);
        if (kp >= t_len) x = -INFINITY;
        else if (causal && kp > qp) x = kNegInf;
      }
      s[r] = x;
      if (r & 2) mx_b = fmaxf(mx_b, x);
      else mx_a = fmaxf(mx_a, x);
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = ex2(__fsub_rn(m_a, mn_a));
    const float corr_b = ex2(__fsub_rn(m_b, mn_b));
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t p_hi[8], p_lo[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float p = ex2(__fsub_rn(s[r], (r & 2) ? mn_b : mn_a));
      if (r & 2) sum_b = __fadd_rn(sum_b, p);
      else sum_a = __fadd_rn(sum_a, p);
      const float hi = tf32_rna(p);
      const int slot = 4 * (r / 4) + ((r & 2) ? 1 : 0) + ((r & 1) ? 2 : 0);
      p_hi[slot] = __float_as_uint(hi);
      p_lo[slot] = __float_as_uint(tf32_rna(__fsub_rn(p, hi)));
    }
    l_a = __fadd_rn(__fmul_rn(l_a, corr_a), sum_a);
    l_b = __fadd_rn(__fmul_rn(l_b, corr_b), sum_b);
#pragma unroll
    for (int r = 0; r < 64; ++r)
      o_acc[r] = __fmul_rn(o_acc[r], (r & 2) ? corr_b : corr_a);

    // ---- O += P V over the warpgroup's columns: two k-steps of 8 keys;
    // step c reads 32 bytes at c * 32 of the half's 64-byte V^T rows
    const uint32_t vha = smem_u32(v_hi(st)) + box0 * kWideBoxBytes;
    const uint32_t vla = smem_u32(v_lo(st)) + box0 * kWideBoxBytes;
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBKV / 8; ++c) {
      const uint64_t dvh = desc_sw64(vha + c * 32, 16, 512);
      const uint64_t dvl = desc_sw64(vla + c * 32, 16, 512);
      mma_rs_n128(o_acc, &p_hi[4 * c], dvl);
      mma_rs_n128(o_acc, &p_lo[4 * c], dvh);
      mma_rs_n128(o_acc, &p_hi[4 * c], dvh);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    if (lane == 0) mbar_arrive(bar(kBarEmptyK + st));  // stage free
  }

  // ---- the quad's partial row sums, then acc / max(l, 1e-30) into the
  // warpgroup's columns
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a = __fadd_rn(l_a, __shfl_xor_sync(0xffffffffu, l_a, sh));
    l_b = __fadd_rn(l_b, __shfl_xor_sync(0xffffffffu, l_b, sh));
  }
  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
  if (wg == 0)       // both warpgroups hold the rows' (m, l)
    flash_lse::store_rows(lse, ((long long)bb * h_q + h) * s_len, row_a,
                          s_len, quad, m_a, la, m_b, lb);
  const long long row_stride = (long long)h_q * dv;
  float* ob = o + ((long long)bb * s_len * h_q + h) * dv;
#pragma unroll
  for (int r = 0; r < 64; r += 2) {
    const bool b_row = r & 2;
    const int row = row_a + (b_row ? 8 : 0);
    const int col = c0 + 8 * (r / 4) + 2 * quad;  // dv % 4 == 0: col + 1 too
    if (row >= s_len || col >= dv) continue;
    const float l = b_row ? lb : la;
    *reinterpret_cast<float2*>(ob + row * row_stride + col) =
        make_float2(__fdiv_rn(o_acc[r], l), __fdiv_rn(o_acc[r + 1], l));
  }
}

// ------------------------------------------------ kernel, dh <= 32
constexpr int kNWgs = 4;                        // consumer warpgroups
constexpr int kNThreads = kNWgs * 128;          // 512, no producer
constexpr int kNWarps = kNThreads / 32;
constexpr int kNBKV = 40;                       // keys per KV tile
constexpr int kNStages = 3;
constexpr int kNAhead = 1;                      // tiles split ahead
constexpr int kNQTile = kBQ * 128;              // one 64-row q tile, 8 KB
constexpr int kNQBytes = kNWgs * kNQTile;       // a unit's q tiles, 32 KB
constexpr int kNKvBytes = kNBKV * 128;          // raw K or V, K hi or lo
constexpr int kNVtBox = 32 * 128;               // V^T: 32 rows of 32 keys
constexpr int kNVtBytes = 2 * kNVtBox;          // keys 0..31, 32..39
constexpr int kNStageBytes = 4 * kNKvBytes + 2 * kNVtBytes;     // 36 KB
constexpr int kNSmemBytes = 2 * kNQBytes + kNStages * kNStageBytes + 1024;
constexpr int kNVWarps = kNBKV / 8;             // warps that split V
constexpr int kNKWarps = kNKvBytes / 16 / 32;   // warps that split K
static_assert(kNVWarps + kNKWarps < kNWarps, "the split's warps");
// lane 0 of the last warp, which has no share of the split, issues loads
constexpr int kNLoader = kNThreads - 32;
static_assert(kNAhead < kNStages, "a stage split ahead is not in use");
// barriers: q landed and q read (two buffers each), then per stage full
// (raw K and V landed), split (the split buffers written), empty (their
// products done)
constexpr int kNBarFullQ = 0, kNBarQFree = 2, kNBarFull = 4,
              kNBarSplit = kNBarFull + kNStages,
              kNBarEmpty = kNBarSplit + kNStages,
              kNNumBars = kNBarEmpty + kNStages;

#define R20                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19}"
#define D20 D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
// d (64 x 40) += A (64 x 8, registers) * B (40 x 8, smem)^T in TF32
__device__ __forceinline__ void mma_rs_n40(float (&d)[20], const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 " R20
      ", {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : D20
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 40) += A (64 x 8, smem) * B (40 x 8, smem)^T in TF32
__device__ __forceinline__ void mma_ss_n40(float (&d)[20], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 " R20
      ", %20, %21, p, 1, 1;\n}\n"
      : D20
      : "l"(da), "l"(db), "r"(1));
}

// The 3xTF32 split in three instructions: hi = x rounded to TF32, to
// nearest with ties away from zero (cvt.rna's result for every finite x:
// the bits plus half a TF32 ulp, the 13 low bits cleared; cvt.rna itself
// takes four, an infinity test among them), lo = x - hi exactly (13 bits
// at most), left as it is: the tensor cores read the top 19 bits of a TF32
// operand, so lo is truncated there, within 2^-21 of x (rounded, 2^-22)
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// the TF32 lo part of v * scale
__device__ __forceinline__ float q_lo(float v, float scale) {
  const float y = __fmul_rn(v, scale);
  return __fsub_rn(y, tf32_hi(y));
}

// where the units lie: unit `it` is chunk c (counted from the last, so the
// longest causal chunks run first) of (batch, KV head) bh
struct NarrowUnits {
  int s_len, h_kv, causal, g, n_u, n_ch, n_bh, n_kv_all;
  __device__ NarrowUnits(int s, int t, int h, int hk, int c, int bh)
      : s_len(s), h_kv(hk), causal(c), g(h / hk),
        n_u(g * ((s + kBQ - 1) / kBQ)), n_ch((n_u + kNWgs - 1) / kNWgs),
        n_bh(bh), n_kv_all((t + kNBKV - 1) / kNBKV) {}
  __device__ int chunk(int it) const { return n_ch - 1 - it / n_bh; }
  // the KV tiles q tile u needs (all but causal)
  __device__ int kv_of(int u) const {
    if (!causal) return n_kv_all;
    const int last = min((u / g) * kBQ + kBQ, s_len) - 1;
    return min(n_kv_all, last / kNBKV + 1);
  }
  // the KV tiles unit `it` streams: its last q tile's
  __device__ int kv_tiles(int it) const {
    return kv_of(min(kNWgs * chunk(it) + kNWgs - 1, n_u - 1));
  }
};

// a unit's coordinates, written by the loader with its q tiles: batch,
// KV tiles, and each warpgroup's query head and first row (-1: no q tile)
struct NarrowUnit {
  int bb, n_kv, h[kNWgs], q0[kNWgs];
};

// the loader's cursors: the next KV tile to load is the jj-th of unit it
// (batch bb, KV head kh; kv tiles) and the block's j-th; the next q tiles
// to load are those of unit qit, the block's qn-th
struct NarrowCursor {
  int it, jj, j, bb, kh, kv, qn, qit;
  __device__ void locate(const NarrowUnits& U) {
    const int bh = it % U.n_bh;
    bb = bh / U.h_kv;
    kh = bh % U.h_kv;
    kv = U.kv_tiles(it);
  }
};

__global__ void __launch_bounds__(kNThreads, 1)
flash_fwd_tf32_narrow_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             float* __restrict__ o, float* __restrict__ lse,
                             int s_len, int t_len, int h_q, int h_kv, int dv,
                             float q_scale, int causal, int n_bh) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNNumBars];
  uint8_t* base = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                              smem_u32(smem_raw));
  auto q_buf = [&](int n) { return base + (n & 1) * kNQBytes; };
  auto raw_k = [&](int st) {
    return base + 2 * kNQBytes + st * kNStageBytes;
  };
  auto raw_v = [&](int st) { return raw_k(st) + kNKvBytes; };
  auto k_hi = [&](int st) { return raw_k(st) + 2 * kNKvBytes; };
  auto k_lo = [&](int st) { return raw_k(st) + 3 * kNKvBytes; };
  auto vt_hi = [&](int st) { return raw_k(st) + 4 * kNKvBytes; };
  auto vt_lo = [&](int st) { return vt_hi(st) + kNVtBytes; };
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const NarrowUnits U(s_len, t_len, h_q, h_kv, causal, n_bh);
  const int n_items = U.n_bh * U.n_ch;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128, quad = lane % 4;
  const int ra = 16 * (t / 32) + lane / 4;        // tile rows ra, ra + 8

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar(kNBarFullQ + i), 1);
      mbar_init(bar(kNBarQFree + i), kNWarps);
    }
    for (int st = 0; st < kNStages; ++st) {
      mbar_init(bar(kNBarFull + st), 1);
      mbar_init(bar(kNBarSplit + st), kNWarps);
      mbar_init(bar(kNBarEmpty + st), kNWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // ---- the loads, kNLoader's (the cursors in shared memory, so no other
  // thread holds registers for them, the coordinates computed once a unit)
  __shared__ NarrowCursor cursor;
  // the q tiles of the block's qn-th unit, unit qit, into buffer qn % 2,
  // and its coordinates beside them (visible to the warps that wait for
  // the tiles: the expect_tx arrival releases them)
  __shared__ NarrowUnit units[2];
  auto load_q = [&](int qn, int qit) {
    const int c = U.chunk(qit), bh = qit % U.n_bh;
    const int bb = bh / h_kv, kh = bh % h_kv;
    const int nt = min(kNWgs, U.n_u - kNWgs * c);
    NarrowUnit& un = units[qn & 1];
    un.bb = bb;
    un.n_kv = U.kv_tiles(qit);
    for (int w = 0; w < kNWgs; ++w) {
      const int u = kNWgs * c + w;
      un.h[w] = kh * U.g + u % U.g;
      un.q0[w] = w < nt ? (u / U.g) * kBQ : -1;
    }
    const uint32_t fq = bar(kNBarFullQ + (qn & 1));
    mbar_expect_tx(fq, nt * kNQTile);
    for (int w = 0; w < nt; ++w)
      tma_load_4d(smem_u32(q_buf(qn)) + w * kNQTile, &map_q, fq, 0, un.h[w],
                  un.q0[w], bb);
  };
  // once the loader has passed tile j's split barrier (j = -1: none yet)
  // in the block's n-th unit: every KV tile up to j + kNStages (the raw
  // stage of tile j is free), then the q tiles of unit n + 1 if the unit
  // two before it has released their buffer (else at a later call, or at
  // their unit's start)
  auto pump = [&](int j, int n) {
    NarrowCursor x = cursor;
    while (x.it < n_items && x.j <= j + kNStages) {
      const int st = x.j % kNStages;
      mbar_expect_tx(bar(kNBarFull + st), 2 * kNKvBytes);
      tma_load_4d(smem_u32(raw_k(st)), &map_k, bar(kNBarFull + st), 0, x.kh,
                  x.jj * kNBKV, x.bb);
      tma_load_4d(smem_u32(raw_v(st)), &map_v, bar(kNBarFull + st), 0, x.kh,
                  x.jj * kNBKV, x.bb);
      ++x.j;
      if (++x.jj == x.kv) {
        x.jj = 0;
        x.it += gridDim.x;
        if (x.it < n_items) x.locate(U);
      }
    }
    if (x.qn <= n + 1 && x.qit < n_items &&
        (x.qn < 2 ||
         mbar_test(bar(kNBarQFree + (x.qn & 1)), ((x.qn - 2) >> 1) & 1))) {
      load_q(x.qn++, x.qit);
      x.qit += gridDim.x;
    }
    cursor = x;
  };
  // at the start of the block's n-th unit: its q tiles, if no call loaded
  // them, once the unit two before has released their buffer (every warp
  // can finish that unit without the loader)
  auto load_own_q = [&](int n) {
    NarrowCursor x = cursor;
    for (; x.qn <= n; x.qit += gridDim.x) {
      if (x.qn >= 2)
        mbar_wait(bar(kNBarQFree + (x.qn & 1)), ((x.qn - 2) >> 1) & 1);
      load_q(x.qn++, x.qit);
    }
    cursor = x;
  };

  // ---- a warp's share of splitting the block's j-th KV tile, once the
  // stage's tile before it is released and the raw tile has landed:
  // warps 0..4 transpose V (column `lane`, keys 8 w .. 8 w + 7) into V^T
  // hi and lo, key pi(k) of each 8-key group at column k, keys 32..39 in
  // the second box; warps 5..14 split K (a float4 a thread, the layout
  // kept) into K hi and K lo; warp 15 only waits and arrives
  auto split = [&](int j) {
    const int st = j % kNStages;
    if (j >= kNStages)
      mbar_wait(bar(kNBarEmpty + st), ((j / kNStages) - 1) & 1);
    mbar_wait(bar(kNBarFull + st), (j / kNStages) & 1);
    if (warp < kNVWarps) {
      const int n = lane, kb = 8 * warp;
      float vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vals[e] = *reinterpret_cast<const float*>(raw_v(st) +
                                                  swz(kb + e, n, kNBKV));
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int p0 = kb + 4 * g;            // k-positions p0 .. p0 + 3
        float hv[4], lv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = vals[key_of(4 * g + e)];
          hv[e] = tf32_hi(x);
          lv[e] = __fsub_rn(x, hv[e]);
        }
        const uint32_t off = (p0 / 32) * kNVtBox + n * 128 +
                             ((((p0 % 32) >> 2) ^ (n & 7)) << 4);
        *reinterpret_cast<float4*>(vt_hi(st) + off) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<float4*>(vt_lo(st) + off) =
            make_float4(lv[0], lv[1], lv[2], lv[3]);
      }
    } else if (warp < kNVWarps + kNKWarps) {
      const int i = (warp - kNVWarps) * 32 + lane;
      const float4 x = reinterpret_cast<const float4*>(raw_k(st))[i];
      const float4 hi = make_float4(tf32_hi(x.x), tf32_hi(x.y),
                                    tf32_hi(x.z), tf32_hi(x.w));
      reinterpret_cast<float4*>(k_hi(st))[i] = hi;
      reinterpret_cast<float4*>(k_lo(st))[i] =
          make_float4(__fsub_rn(x.x, hi.x), __fsub_rn(x.y, hi.y),
                      __fsub_rn(x.z, hi.z), __fsub_rn(x.w, hi.w));
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kNBarSplit + st));
  };

  // the block's KV tiles, all its units'
  int n_tiles = 0;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x)
    n_tiles += U.kv_tiles(it);
  if (tid == kNLoader) {
    cursor.it = cursor.qit = blockIdx.x;
    cursor.jj = cursor.j = cursor.qn = 0;
    cursor.locate(U);
    load_own_q(0);
    pump(-1, 0);
  }
  __syncwarp();
  for (int jn = 0; jn < kNAhead && jn < n_tiles; ++jn) split(jn);

  int j = 0;                                       // the block's KV tile
  for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {

    // Q hi (scaled) into registers as TF32 A fragments: k-step kk holds
    // (ra, 8 kk + quad), (ra + 8, ..), (ra, 8 kk + quad + 4), (ra + 8, ..);
    // then Q lo in place of the warpgroup's q tile (the S product reads it
    // from there), the tile released at the unit's end.  A warpgroup
    // without a q tile computes on whatever its slot holds and stores
    // nothing
    uint8_t* qs = q_buf(n) + wg * kNQTile;
    uint32_t q_hi[16];
    if (tid == kNLoader) load_own_q(n);
    __syncwarp();
    mbar_wait(bar(kNBarFullQ + (n & 1)), (n >> 1) & 1);
    const NarrowUnit& un = units[n & 1];
    const int bb = un.bb, n_kv = un.n_kv, h = un.h[wg], q0 = un.q0[wg];
    const bool act = q0 >= 0;                     // this warpgroup's q tile
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ra + 8 * (i & 1), col = 8 * kk + quad + 4 * (i >> 1);
        q_hi[4 * kk + i] = __float_as_uint(tf32_hi(__fmul_rn(
            *reinterpret_cast<const float*>(qs + swz(r, col, kBQ)),
            q_scale)));
      }
    }
    named_sync(2 + wg, 128);                  // the tile's values are read
#pragma unroll
    for (int i = 0; i < kNQTile / 16 / 128; ++i) {
      float4* p = reinterpret_cast<float4*>(qs) + t + 128 * i;
      const float4 x = *p;
      *p = make_float4(q_lo(x.x, q_scale), q_lo(x.y, q_scale),
                       q_lo(x.z, q_scale), q_lo(x.w, q_scale));
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);                  // Q lo is in
    const uint32_t qa = smem_u32(qs);

    float o_acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o_acc[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    const int row_a = q0 + ra;

    for (int jj = 0; jj < n_kv; ++jj, ++j) {
      const int st = j % kNStages;
      mbar_wait(bar(kNBarSplit + st), (j / kNStages) & 1);

      // ---- S = Q K^T in 3xTF32 (m64n40k8, four k-steps), issued; tile j
      // + kNAhead split and the loads issued under it.  Every warpgroup
      // issues its products on every tile (no branch around a wgmma: ptxas
      // would serialise them all), and masks the keys its rows do not see
      float s[20];
#pragma unroll
      for (int r = 0; r < 20; ++r) s[r] = 0.f;
      const uint32_t kha = smem_u32(k_hi(st)), kla = smem_u32(k_lo(st));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dkh = desc(kha + kk * 32, 16, 1024);
        mma_rs_n40(s, &q_hi[4 * kk], desc(kla + kk * 32, 16, 1024));
        mma_ss_n40(s, desc(qa + kk * 32, 16, 1024), dkh);
        mma_rs_n40(s, &q_hi[4 * kk], dkh);
      }
      wgmma_commit();
      if (j + kNAhead < n_tiles) split(j + kNAhead);
      if (tid == kNLoader) pump(j, n);
      __syncwarp();

      {
        wgmma_wait_all();
        fence_regs(s);
        // ---- online softmax, base 2; element r: row ra (r & 2 == 0) or
        // ra + 8, key k0 + 8 (r / 4) + 2 quad + (r & 1)
        const int k0 = jj * kNBKV;
        const bool edge =
            k0 + kNBKV > t_len || (causal && k0 + kNBKV - 1 > q0);
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int r = 0; r < 20; ++r) {
          float x = s[r];
          if (edge) {
            const int kp = k0 + 8 * (r / 4) + 2 * quad + (r & 1);
            const int qp = row_a + ((r & 2) ? 8 : 0);
            if (kp >= t_len) x = -INFINITY;
            else if (causal && kp > qp) x = kNegInf;
          }
          s[r] = x;
          if (r & 2) mx_b = fmaxf(mx_b, x);
          else mx_a = fmaxf(mx_a, x);
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float corr_a = ex2(__fsub_rn(m_a, mn_a));
        const float corr_b = ex2(__fsub_rn(m_b, mn_b));
        m_a = mn_a;
        m_b = mn_b;
        // P as TF32 A fragments (k-step c: elements 4c .. 4c + 3, keys 2
        // quad and 2 quad + 1 at columns quad and quad + 4), hi and lo
        float sum_a = 0.f, sum_b = 0.f;
        uint32_t p_hi[20], p_lo[20];
#pragma unroll
        for (int r = 0; r < 20; ++r) {
          const float p = ex2(__fsub_rn(s[r], (r & 2) ? mn_b : mn_a));
          if (r & 2) sum_b = __fadd_rn(sum_b, p);
          else sum_a = __fadd_rn(sum_a, p);
          const float hi = tf32_hi(p);
          const int slot = 4 * (r / 4) + ((r & 2) ? 1 : 0) + ((r & 1) ? 2 : 0);
          p_hi[slot] = __float_as_uint(hi);
          p_lo[slot] = __float_as_uint(__fsub_rn(p, hi));
        }
        l_a = __fadd_rn(__fmul_rn(l_a, corr_a), sum_a);
        l_b = __fadd_rn(__fmul_rn(l_b, corr_b), sum_b);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          o_acc[r] = __fmul_rn(o_acc[r], (r & 2) ? corr_b : corr_a);

        // ---- O += P V (m64n32k8): five k-steps of 8 keys; step c reads
        // 32 bytes at (c % 4) * 32 of box c / 4's 128-byte V^T rows
        const uint32_t vha = smem_u32(vt_hi(st)), vla = smem_u32(vt_lo(st));
        fence_regs(o_acc);
        wgmma_fence();
#pragma unroll
        for (int cc = 0; cc < kNBKV / 8; ++cc) {
          const uint32_t off = (cc / 4) * kNVtBox + (cc % 4) * 32;
          const uint64_t dvh = desc(vha + off, 16, 1024);
          mma_rs_n32(o_acc, &p_hi[4 * cc], desc(vla + off, 16, 1024));
          mma_rs_n32(o_acc, &p_lo[4 * cc], dvh);
          mma_rs_n32(o_acc, &p_hi[4 * cc], dvh);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(kNBarEmpty + st));   // stage read
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kNBarQFree + (n & 1)));  // q tile free

    // ---- the quad's partial row sums, then acc / max(l, 1e-30)
    if (act) {
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        l_a = __fadd_rn(l_a, __shfl_xor_sync(0xffffffffu, l_a, sh));
        l_b = __fadd_rn(l_b, __shfl_xor_sync(0xffffffffu, l_b, sh));
      }
      const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
      flash_lse::store_rows(lse, ((long long)bb * h_q + h) * s_len, row_a,
                            s_len, quad, m_a, la, m_b, lb);
      // acc * (1 / l): __fdiv_rn's slow path is a call, and ptxas
      // serialises every wgmma of a function that makes one
      const float ia = rcp(la), ib = rcp(lb);
      const long long row_stride = (long long)h_q * dv;
      float* ob = o + ((long long)bb * s_len * h_q + h) * dv;
#pragma unroll
      for (int r = 0; r < 16; r += 2) {
        const bool b_row = r & 2;
        const int row = row_a + (b_row ? 8 : 0);
        const int col = 8 * (r / 4) + 2 * quad;   // dv % 4 == 0: col + 1 too
        if (row >= s_len || col >= dv) continue;
        const float il = b_row ? ib : ia;
        *reinterpret_cast<float2*>(ob + row * row_stride + col) =
            make_float2(__fmul_rn(o_acc[r], il), __fmul_rn(o_acc[r + 1], il));
      }
    }
  }
}

// ------------------------------------------------------------------ host
// element strides of an operand's batch, row and head axes (its last axis
// unit-stride)
struct Strides {
  long long batch, row, head;
};

// (batch, len, heads, width) f32 at the given element strides, 32-column x
// rows boxes, 128-byte swizzle; rows past len and columns past width read
// as zeros
bool make_map(CUtensorMap* map, const void* ptr, int batch, int len,
              int heads, int width, int rows, Strides st) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.head * 4,
                                 (cuuint64_t)st.row * 4,
                                 (cuuint64_t)st.batch * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kDh, int kDv>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int s, int t, int h, int hk, int dh,
                   int dv, float scale, int causal, Strides qs, Strides ks,
                   Strides vs, cudaStream_t stream) {
  constexpr bool kWide = kDh > 192, kNarrow = kDh == 32;
  constexpr int rows = kWide ? kWideBKV : kNarrow ? kNBKV : kBKV;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, s, h, dh, kBQ, qs) ||
      !make_map(&mk, k, b, t, hk, dh, rows, ks) ||
      !make_map(&mv, v, b, t, hk, dv, rows, vs))
    return cudaErrorInvalidValue;
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  cudaError_t e;
  if constexpr (kNarrow) {
    // a persistent grid: a block an SM, or one a unit where there are fewer
    const int n_qt = (s + kBQ - 1) / kBQ;
    const long long units =
        (long long)b * hk * ((h / hk * (long long)n_qt + kNWgs - 1) / kNWgs);
    if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
    int dev, sms;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_fwd_tf32_narrow_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kNSmemBytes);
    if (e != cudaSuccess) return e;
    flash_fwd_tf32_narrow_kernel<<<(int)(units < sms ? units : sms),
                                   kNThreads, kNSmemBytes, stream>>>(
        mq, mk, mv, static_cast<float*>(o), lse, s, t, h, hk, dv,
        scale * kLog2e, causal, b * hk);
  } else if constexpr (kWide) {
    e = cudaFuncSetAttribute(flash_fwd_tf32_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWideSmemBytes);
    if (e != cudaSuccess) return e;
    flash_fwd_tf32_wide_kernel<<<grid, kThreads, kWideSmemBytes, stream>>>(
        mq, mk, mv, static_cast<float*>(o), lse, s, t, h, hk, dh, dv,
        scale * kLog2e, causal);
  } else {
    constexpr int smem = Cfg<kDh, kDv>::kSmemBytes;
    e = cudaFuncSetAttribute(flash_fwd_tf32_kernel<kDh, kDv>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    flash_fwd_tf32_kernel<kDh, kDv><<<grid, kSplitThreads, smem, stream>>>(
        mq, mk, mv, static_cast<float*>(o), lse, s, t, h, hk, dh, dv,
        scale * kLog2e, causal);
  }
  return cudaGetLastError();
}

// strides the tensor maps take: positive, on 16 bytes
bool tma_strides(const Strides& x) {
  return x.batch > 0 && x.row > 0 && x.head > 0 &&
         (x.batch | x.row | x.head) % 4 == 0;
}

}  // namespace

// q (b, s, h, dh), k (b, t, hk, dh), v (b, t, hk, dv) f32, each with its
// last axis unit-stride and the element strides of its batch, row and head
// axes given (q_sb, q_sr, q_sh, ...; each a positive multiple of 4, the
// base 16-byte aligned: views need no copy); o (b, s, h, dv) contiguous
// f32; h % hk == 0, dh % 4 == 0, dh <= 256, dv % 4 == 0, dv <= dh.  lse:
// null, or (b, h, s) f32 that receives each row's natural-log logsumexp
// (flash_lse.cuh).  Instances: dh <= 32 -> (32, 32); dh <= 64 -> (64, 64);
// dh <= 128 -> (128, 128); dh <= 192 with dv <= 128 -> (192, 128); else
// (256, 256).  Returns a cudaError_t.
extern "C" int flash_attn_fwd_tf32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int s, int t, int h, int hk, int dh,
                                   int dv, float scale, int causal,
                                   long long q_sb, long long q_sr,
                                   long long q_sh, long long k_sb,
                                   long long k_sr, long long k_sh,
                                   long long v_sb, long long v_sr,
                                   long long v_sh, void* stream) {
  float* ls = static_cast<float*>(lse);
  const Strides qs{q_sb, q_sr, q_sh}, ks{k_sb, k_sr, k_sh},
      vs{v_sb, v_sr, v_sh};
  if (b < 1 || s < 1 || t < 1 || hk < 1 || h % hk || dh < 4 || dh % 4 ||
      dh > 256 || dv < 4 || dv % 4 || dv > dh ||
      (long long)b * h > 0x7fffffffLL || (s + kBQ - 1) / kBQ > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15u))
    return (int)cudaErrorInvalidValue;
  if (!tma_strides(qs) || !tma_strides(ks) || !tma_strides(vs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // dv > 128 or dh > 192: the 256 kernel
  if (dv > 128 || dh > 192)
    return (int)launch<256, 256>(q, k, v, o, ls, b, s, t, h, hk, dh, dv,
                                 scale, causal, qs, ks, vs, st);
  if (dh > 128)
    return (int)launch<192, 128>(q, k, v, o, ls, b, s, t, h, hk, dh, dv,
                                 scale, causal, qs, ks, vs, st);
  if (dh > 64)
    return (int)launch<128, 128>(q, k, v, o, ls, b, s, t, h, hk, dh, dv,
                                 scale, causal, qs, ks, vs, st);
  return (int)(dh > 32 ? launch<64, 64>(q, k, v, o, ls, b, s, t, h, hk, dh,
                                        dv, scale, causal, qs, ks, vs, st)
                       : launch<32, 32>(q, k, v, o, ls, b, s, t, h, hk, dh,
                                        dv, scale, causal, qs, ks, vs, st));
}
