// GQA flash-attention forward on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/flash_attn.py::
// flash_attention_fwd (_flash_kernel) for bf16 inputs with dh % 8 == 0,
// dh <= 256 (flash_attn/ops.py::flash_kernel routes f32 to
// flash_attn_fwd_tf32.cu; its wrapper pads other head widths with zero
// columns to a multiple of 8 and casts other dtypes first).
// q (B, S, H, dh), k (B, T, Hk, dh) and v (B, T, Hk, dv), dv <= dh, give
// o (B, S, H, dv):
//     o[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h / G]) v[b, t, h / G]
// with G = H / Hk query heads per KV head (no KV copy per query head).
// dv < dh is MLA's prefill (DeepSeek-V2: q and k 192 wide, v 128), which
// the Pallas kernel's caller, the model's blockwise_attention, takes.
// The TPU kernel's semantics (its _flash_kernel): causal
// masking aligned at the top left (key t kept for query s where t <= s,
// also when S != T); masked scores and the running max start at -1e30; the
// running (m, l, acc) are f32 and rescaled for every KV tile; the output is
// acc / max(l, 1e-30); KV tiles wholly above the diagonal are skipped; keys
// past T (the ragged last tile) score -inf and weigh exactly 0.  The scale
// is applied to the f32 scores the tensor cores return (q is not rounded
// again); the softmax works in base 2 on scale * log2(e) * (q . k), the
// same function, with the mask constant and the running-max start at -1e30
// there too.
//
// What bounds it on an H100 SXM: operations.  At Qwen3-0.6B's attention
// widths (H = 16, Hk = 8, dh = 128), B = 1, S = T = 4096, causal, the two
// products are 68.7 GFLOP: 0.0695 ms at the dense bf16 tensor-core rate
// (989 TFLOP/s); its bytes (q, k, v, o: 50 MB) take 0.015 ms.  The
// softmax's 134M exponentials take about 0.03 ms of the SFU (16 a clock an
// SM), so they have to overlap the products.
//
// Layout: one block owns 128 query rows of one (batch, query head), two
// consumer warpgroups of 64 rows each; both take every KV tile.  TMA loads
// (tensor maps built on the host with cuTensorMapEncodeTiled, 128-byte
// swizzle, 64-column boxes) bring the q tile once and K and V tiles into a
// ring of stages with full barriers (K and V apart, transaction bytes)
// and empty barriers that the eight consumer warps arrive on.  Each
// consumer warpgroup computes S = Q K^T with wgmma.mma_async (Q and K both
// K-major in swizzled shared memory), keeps the online softmax on the f32
// accumulator fragments in registers (quad shuffles for the row max, a
// per-thread partial row sum reduced once at the end), converts P to bf16
// in registers, where the accumulator layout of S is the A-operand layout
// of the next product, and computes O += P V with the register-A form of
// wgmma, V read as a transposed (MN-major) B operand from the same
// swizzled tiles.  P never touches shared memory.  Blocks are ordered
// with the longest causal q tiles first.
//
// Schedule (flash_fwd_wgmma_pp_kernel, every instance with kDv <= 128),
// FlashAttention-3's: a producer warpgroup (one thread issues the loads;
// setmaxnreg lowers it to 24 registers and raises the consumers to 240,
// though ptxas still sizes the consumers' code to 168); the ring's K and
// V released apart (K once its S is in, V once its P V is in), so the
// loads of a stage start a tile early; within a warpgroup, S of tile j is
// issued together with P V of tile j - 1 and waited for with wgmma
// wait_group 1, so the softmax of tile j runs while P V of tile j - 1 is on
// the tensor cores (wait_group 0, then O is rescaled and P rewritten);
// between the two warpgroups, turns: each issues its products only after
// the other has issued its own (named barriers 1 and 2: one warpgroup's
// 128 threads wait with bar.sync, the other's 128 arrive with bar.arrive;
// warpgroup 0 first, n_kv + 1 turns each), so one's softmax runs under
// the other's products.  S, P and O must fit in those 168 registers: 96-key
// tiles at kDv = 128 (S 48 floats, P 24 registers, O 64; 128 keys spill
// and serialise the wgmma pipeline, 112 spill), 128-key tiles at kDv = 64;
// as many stages as shared memory holds, at most 4.  (256, 256) keeps the
// serial loop (flash_fwd_wgmma_kernel: a producer warp, a two-stage ring,
// each tile S, softmax, P V in turn with wait_group 0): O is 128 floats a
// thread there, and on the loop above it spilled and ran slower
// (scripts/kernel_ab.py, PERF.md section 6).
//
// Head widths: four instances, (kDh, kDv) = (64, 64), (128, 128),
// (192, 128) and (256, 256); dh <= 64 runs on the first, 64 < dh <= 128 on
// the second, 128 < dh <= 192 with dv <= 128 on the third, the rest on the
// last.  The tensor maps take the true dh (q, K) and dv (V) as their inner
// extent (TMA needs every global stride on 16 bytes: dh % 8 == 0, dv % 8
// == 0), so TMA fills the columns past them of every tile with zeros:
// they add nothing to a score, and the output columns they give are not
// stored.  A box wholly past dh or dv (the last at dh <= 192 on the 256
// instance) is never loaded: its space in the q tile and in every stage's
// K or V is cleared once at the start and stays zero.  scale is the
// caller's, 1/sqrt(dh) by default.  kDv is the N of the P V product and
// the width of the V tiles and of O, kDh the K of the Q K^T product and
// the width of the q and K tiles.
//
// (192, 128) is DeepSeek-V2's MLA: Q K^T at K = 192 in 12 k16 steps of
// m64n96k16, P V as m64n128k16; shared memory q 48 KB + 2 stages x (K 36
// + V 24) KB = 168 KB.  At the MLA shape (B = 1, S = T = 4096, H = Hk =
// 16, causal) the products are 85.9 GFLOP, 0.087 ms at the bf16
// tensor-core rate; padding v to 192 and running the 256 instance would be
// 137.4 GFLOP.  (128, 128): 96-key tiles, 4 stages (32 + 4 x 48 KB);
// (64, 64): 128-key tiles, 4 stages (16 + 4 x 32 KB).
//
// (256, 256): O is 128 floats a thread, so the KV tiles hold 32 keys (S
// 16 floats, P 8 registers, O += P V as m64n256k16; 64-key tiles spilled
// more registers and ran slower, scripts/kernel_ab.py, PERF.md section
// 6); shared memory q 64 KB + 2 stages x (K + V) 32 KB = 128 KB, one block
// an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_lse.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;              // query rows per block
constexpr int kStages = 2;            // KV ring depth
constexpr int kConsumerThreads = 256; // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;   // + one producer warp
constexpr int kBox = 64;              // bf16 columns per 128-byte TMA box
constexpr int kBoxBytes = kBQ * kBox * 2;         // 128 rows x 128 B of q
constexpr float kNegInf = -1e30f;     // the TPU kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// barriers: q, full K [stage], full V [stage], empty [stage]
constexpr int kBarQ = 0, kBarK = 1, kBarV = 1 + kStages,
              kBarEmpty = 1 + 2 * kStages, kNumBars = 1 + 3 * kStages;

constexpr int kKvTile = 32;           // keys per KV tile of the serial loop

// d (64 x N, f32) (+)= A (64 x 16, smem) * B (N x 16, smem)^T, both
// K-major, N = 128, 96 or 32; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}
#define D48 D32, D8(32), D8(40)
#define R48                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47}"
__device__ __forceinline__ void mma_ss(float (&d)[48], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " R48
      ", %48, %49, p, 1, 1, 0, 0;\n}\n"
      : D48
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : D16
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, registers) * B (16 x N, smem, MN-major),
// N = 256, 128 or 64
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " R128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------ kernel
// The serial loop (the header's last paragraph: (256, 256) runs it)
template <int kDh, int kDv>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int s_len, int t_len,
                       int h_q, int h_kv, int dh, int dv, float scale_log2,
                       int causal) {
  constexpr int kBKV = kKvTile;                     // keys per KV tile
  constexpr int kHalves = kDh / kBox;               // boxes per q or K row
  constexpr int kVHalves = kDv / kBox;              // boxes per V row
  constexpr int kTileBytes = kHalves * kBoxBytes;   // the q tile
  constexpr int kKvBoxBytes = kBKV * kBox * 2;      // a K or V box
  constexpr int kKvBytes = kHalves * kKvBoxBytes;   // a K tile
  constexpr int kVBytes = kVHalves * kKvBoxBytes;   // a V tile
  constexpr int kOr = kDv / 2;                      // O registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  // tiles: q | K[0] K[1] | V[0] V[1], each 1024-byte aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kTileBytes;
  const uint32_t v_s = k_s + kStages * kKvBytes;
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
  const int nb = (dh + kBox - 1) / kBox;            // q/K boxes TMA loads
  const int nbv = (dv + kBox - 1) / kBox;           // V boxes TMA loads

  if (tid == 0) {
    mbar_init(bar(kBarQ), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar(kBarK + st), 1);
      mbar_init(bar(kBarV + st), 1);
      mbar_init(bar(kBarEmpty + st), kConsumerThreads / 32);
    }
    fence_mbar_init();
  }
  // the boxes past nb (q and K) and past nbv (V): zeros in the q tile and
  // in each stage's K and V, written before any wgmma reads them
  const uint32_t raw = smem_u32(smem_raw);
  auto clear = [&](uint32_t addr, int bytes) {
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (addr - raw));
    for (int i = tid; i < bytes / 16; i += kThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  };
  for (int c = nb; c < kHalves; ++c) {
    clear(q_s + c * kBoxBytes, kBoxBytes);
    for (int st = 0; st < kStages; ++st)
      clear(k_s + st * kKvBytes + c * kKvBoxBytes, kKvBoxBytes);
  }
  for (int c = nbv; c < kVHalves; ++c)
    for (int st = 0; st < kStages; ++st)
      clear(v_s + st * kVBytes + c * kKvBoxBytes, kKvBoxBytes);
  if (nb < kHalves || nbv < kVHalves) fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumerThreads) {                     // producer warp
    if (tid == kConsumerThreads) {
      mbar_expect_tx(bar(kBarQ), nb * kBoxBytes);
      for (int c = 0; c < nb; ++c)
        tma_load_4d(q_s + c * kBoxBytes, &map_q, bar(kBarQ), c * kBox, h,
                    q0, bb);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kStages;
        if (j >= kStages)
          mbar_wait(bar(kBarEmpty + st), ((j / kStages) - 1) & 1);
        const uint32_t kd = k_s + st * kKvBytes, vd = v_s + st * kVBytes;
        mbar_expect_tx(bar(kBarK + st), nb * kKvBoxBytes);
        for (int c = 0; c < nb; ++c)
          tma_load_4d(kd + c * kKvBoxBytes, &map_k, bar(kBarK + st),
                      c * kBox, kh, j * kBKV, bb);
        mbar_expect_tx(bar(kBarV + st), nbv * kKvBoxBytes);
        for (int c = 0; c < nbv; ++c)
          tma_load_4d(vd + c * kKvBoxBytes, &map_v, bar(kBarV + st),
                      c * kBox, kh, j * kBKV, bb);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int wg = tid / 128, t = tid % 128;
  const int lane = t % 32, quad = lane % 4;
  const int row_a = q0 + 64 * wg + 16 * (t / 32) + lane / 4;  // rows a, a + 8
  const int wg_row0 = q0 + 64 * wg;
  float o_acc[kOr];
#pragma unroll
  for (int i = 0; i < kOr; ++i) o_acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  mbar_wait(bar(kBarQ), 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const uint32_t kt = k_s + st * kKvBytes, vt = v_s + st * kVBytes;

    // S = Q K^T: dh / 16 steps of k16; step kk reads 32 bytes at
    // (kk % 4) * 32 of the 128-byte rows of box kk / 4
    float s[kBKV / 2];
    mbar_wait(bar(kBarK + st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      mma_ss(s, desc(q_s + (kk / 4) * kBoxBytes + off + wg * 64 * 128, 16,
                     1024),
             desc(kt + (kk / 4) * kKvBoxBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax, base 2; element r: row a (r & 2 == 0) or a + 8,
    // key j*kBKV + 8*(r/4) + 2*quad + (r & 1)
    const int k0 = j * kBKV;
    const bool edge = k0 + kBKV > t_len ||
                      (causal && k0 + kBKV - 1 > wg_row0);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int r = 0; r < kBKV / 2; ++r) {
      float x = s[r] * scale_log2;
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
    const float corr_a = ex2(m_a - mn_a), corr_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t p[kBKV / 4];
#pragma unroll
    for (int r = 0; r < kBKV / 2; r += 2) {
      const float mr = (r & 2) ? mn_b : mn_a;
      const float p0 = ex2(s[r] - mr), p1 = ex2(s[r + 1] - mr);
      if (r & 2) sum_b += p0 + p1;
      else sum_a += p0 + p1;
      p[r / 2] = pack_bf16(p0, p1);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int r = 0; r < kOr; ++r) o_acc[r] *= (r & 2) ? corr_b : corr_a;

    // O += P V: kBKV / 16 steps; step kk takes the four registers of P
    // that hold keys 16 kk .. 16 kk + 15 and V rows 16 kk .. (2 KB on);
    // N = kDv runs across the boxes, kKvBoxBytes apart
    mbar_wait(bar(kBarV + st), ph);
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
      mma_rs(o_acc, &p[4 * kk], desc(vt + kk * 2048, kKvBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    if (lane == 0) mbar_arrive(bar(kBarEmpty + st));  // stage free
  }

  // the quad's partial row sums, then o / max(l, 1e-30)
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  flash_lse::store_rows(lse, ((long long)bb * h_q + h) * s_len, row_a, s_len,
                        quad, m_a, l_a, m_b, l_b);
  const long long row_stride = (long long)h_q * dv;
  __nv_bfloat16* ob = o + ((long long)bb * s_len * h_q + h) * dv;
#pragma unroll
  for (int r = 0; r < kOr; r += 2) {
    const int row = row_a + ((r & 2) ? 8 : 0);
    const int col = 8 * (r / 4) + 2 * quad;   // dv % 8 == 0: col + 1 < dv too
    if (row >= s_len || col >= dv) continue;
    const float inv = (r & 2) ? inv_b : inv_a;
    *reinterpret_cast<__nv_bfloat162*>(ob + row * row_stride + col) =
        __floats2bfloat162_rn(o_acc[r] * inv, o_acc[r + 1] * inv);
  }
}

// ---------------------------------------- steps of the pipelined loop
// the running row maxima and sums of a thread's rows a and a + 8
struct RowState {
  float m_a, m_b, l_a, l_b;
};

// S (+)= Q K^T of one KV tile, issued and committed: kDh / 16 steps of
// k16; step kk reads 32 bytes at (kk % 4) * 32 of the 128-byte rows of
// box kk / 4 (q_a: the warpgroup's 64 rows of the q tile; k_t: the K
// tile, boxes kKvBoxBytes apart)
template <int kDh, int kKvBoxBytes, int kN>
__device__ __forceinline__ void issue_qk(float (&s)[kN], uint32_t q_a,
                                         uint32_t k_t) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    mma_ss(s, desc(q_a + (kk / 4) * kBoxBytes + off, 16, 1024),
           desc(k_t + (kk / 4) * kKvBoxBytes + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V of one KV tile of kBKV keys, issued and committed: kBKV / 16
// steps; step kk takes the four registers of P that hold keys 16 kk ..
// 16 kk + 15 and V rows 16 kk .. (2 KB on); N runs across V's boxes,
// kKvBoxBytes apart
template <int kBKV, int kKvBoxBytes, int kOr>
__device__ __forceinline__ void issue_pv(float (&o)[kOr],
                                         const uint32_t (&p)[kBKV / 4],
                                         uint32_t v_t) {
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk)
    mma_rs(o, &p[4 * kk], desc(v_t + kk * 2048, kKvBoxBytes, 1024));
  wgmma_commit();
}

// the online softmax of KV tile j in place, base 2: s becomes the tile's
// weights, their sums go into l, and (corr_a, corr_b) are the factors O
// is to be rescaled by.  Element r: row a (r & 2 == 0) or a + 8, key
// j*kBKV + 8*(r/4) + 2*quad + (r & 1)
template <int kBKV>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBKV / 2], RowState& rs, float& corr_a, float& corr_b, int j,
    int t_len, int causal, int wg_row0, int row_a, int quad,
    float scale_log2) {
  const int k0 = j * kBKV;
  const bool edge = k0 + kBKV > t_len || (causal && k0 + kBKV - 1 > wg_row0);
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int r = 0; r < kBKV / 2; ++r) {
    float x = s[r] * scale_log2;
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
  const float mn_a = fmaxf(rs.m_a, mx_a), mn_b = fmaxf(rs.m_b, mx_b);
  corr_a = ex2(rs.m_a - mn_a);
  corr_b = ex2(rs.m_b - mn_b);
  rs.m_a = mn_a;
  rs.m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int r = 0; r < kBKV / 2; r += 2) {
    const float mr = (r & 2) ? mn_b : mn_a;
    s[r] = ex2(s[r] - mr);
    s[r + 1] = ex2(s[r + 1] - mr);
    if (r & 2) sum_b += s[r] + s[r + 1];
    else sum_a += s[r] + s[r + 1];
  }
  rs.l_a = rs.l_a * corr_a + sum_a;
  rs.l_b = rs.l_b * corr_b + sum_b;
}

// once P V of the tile before is in: O rescaled, and P, the weights in
// bf16, packed in registers (the accumulator layout of S is the A-operand
// layout of P V)
template <int kBKV, int kOr>
__device__ __forceinline__ void rescale_and_pack(float (&o)[kOr],
                                                 uint32_t (&p)[kBKV / 4],
                                                 const float (&s)[kBKV / 2],
                                                 float corr_a, float corr_b) {
#pragma unroll
  for (int r = 0; r < kOr; ++r) o[r] *= (r & 2) ? corr_b : corr_a;
#pragma unroll
  for (int r = 0; r < kBKV / 2; r += 2) p[r / 2] = pack_bf16(s[r], s[r + 1]);
}

// ------------------------------------------------- kernel, pipelined loop
// The schedule of the header (every instance with kDv <= 128).
constexpr int kPpThreads = 384;       // two consumer warpgroups + producer
constexpr int kPpProducerRegs = 24, kPpConsumerRegs = 240;
constexpr int kPpMaxStages = 4;
constexpr int kPpBarFullK = 1, kPpBarFullV = 1 + kPpMaxStages,
              kPpBarEmptyK = 1 + 2 * kPpMaxStages,
              kPpBarEmptyV = 1 + 3 * kPpMaxStages,
              kPpNumBars = 1 + 4 * kPpMaxStages;
// keys per KV tile of the (kDh, kDv) instance on this loop (S, P and O
// within ptxas's 168 registers a thread: 128 keys spill at kDv = 128), and
// the ring's stages: as many as 227 KB hold beside the q tile (and 2 KB
// for the alignment and the barriers), at most kPpMaxStages
template <int kDh, int kDv>
constexpr int kPpKvTile = kDv > 64 ? 96 : 128;
template <int kDh, int kDv>
constexpr int kPpFit = (227 * 1024 - 2048 - kBQ * kDh * 2) /
                       (kPpKvTile<kDh, kDv> * (kDh + kDv) * 2);
template <int kDh, int kDv>
constexpr int kPpStages =
    kPpFit<kDh, kDv> < kPpMaxStages ? kPpFit<kDh, kDv> : kPpMaxStages;

template <int kDh, int kDv>
__global__ void __launch_bounds__(kPpThreads, 1)
flash_fwd_wgmma_pp_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int s_len,
                          int t_len, int h_q, int h_kv, int dh, int dv,
                          float scale_log2, int causal) {
  constexpr int kBKV = kPpKvTile<kDh, kDv>;         // keys per KV tile
  constexpr int kStages = kPpStages<kDh, kDv>;      // KV ring depth
  constexpr int kHalves = kDh / kBox;               // boxes per q or K row
  constexpr int kVHalves = kDv / kBox;              // boxes per V row
  constexpr int kTileBytes = kHalves * kBoxBytes;   // the q tile
  constexpr int kKvBoxBytes = kBKV * kBox * 2;      // a K or V box
  constexpr int kKvBytes = kHalves * kKvBoxBytes;   // a K tile
  constexpr int kVBytes = kVHalves * kKvBoxBytes;   // a V tile
  constexpr int kOr = kDv / 2;                      // O registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kPpNumBars];
  // tiles: q | K[0] .. K[kStages - 1] | V[0] .., each 1024-byte aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kTileBytes;
  const uint32_t v_s = k_s + kStages * kKvBytes;
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
  const int nb = (dh + kBox - 1) / kBox;            // q/K boxes TMA loads
  const int nbv = (dv + kBox - 1) / kBox;           // V boxes TMA loads

  if (tid == 0) {
    mbar_init(bar(kBarQ), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar(kPpBarFullK + st), 1);
      mbar_init(bar(kPpBarFullV + st), 1);
      mbar_init(bar(kPpBarEmptyK + st), kConsumerThreads / 32);
      mbar_init(bar(kPpBarEmptyV + st), kConsumerThreads / 32);
    }
    fence_mbar_init();
  }
  // the boxes past nb (q and K) and past nbv (V): zeros, as above
  const uint32_t raw = smem_u32(smem_raw);
  auto clear = [&](uint32_t addr, int bytes) {
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (addr - raw));
    for (int i = tid; i < bytes / 16; i += kPpThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  };
  for (int c = nb; c < kHalves; ++c) {
    clear(q_s + c * kBoxBytes, kBoxBytes);
    for (int st = 0; st < kStages; ++st)
      clear(k_s + st * kKvBytes + c * kKvBoxBytes, kKvBoxBytes);
  }
  for (int c = nbv; c < kVHalves; ++c)
    for (int st = 0; st < kStages; ++st)
      clear(v_s + st * kVBytes + c * kKvBoxBytes, kKvBoxBytes);
  if (nb < kHalves || nbv < kVHalves) fence_proxy_async();
  __syncthreads();

  // one branch a role, never joined again, so ptxas sizes each by its
  // setmaxnreg; the warpgroup index made warp-uniform to its eyes
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {                                     // producer warpgroup
    setmaxnreg_dec<kPpProducerRegs>();
    if (tid == kConsumerThreads) {
      mbar_expect_tx(bar(kBarQ), nb * kBoxBytes);
      for (int c = 0; c < nb; ++c)
        tma_load_4d(q_s + c * kBoxBytes, &map_q, bar(kBarQ), c * kBox, h,
                    q0, bb);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kStages;
        const uint32_t ph = ((j / kStages) - 1) & 1;   // of tile j - kStages
        if (j >= kStages) mbar_wait(bar(kPpBarEmptyK + st), ph);
        mbar_expect_tx(bar(kPpBarFullK + st), nb * kKvBoxBytes);
        for (int c = 0; c < nb; ++c)
          tma_load_4d(k_s + st * kKvBytes + c * kKvBoxBytes, &map_k,
                      bar(kPpBarFullK + st), c * kBox, kh, j * kBKV, bb);
        if (j >= kStages) mbar_wait(bar(kPpBarEmptyV + st), ph);
        mbar_expect_tx(bar(kPpBarFullV + st), nbv * kKvBoxBytes);
        for (int c = 0; c < nbv; ++c)
          tma_load_4d(v_s + st * kVBytes + c * kKvBoxBytes, &map_v,
                      bar(kPpBarFullV + st), c * kBox, kh, j * kBKV, bb);
      }
    }
  } else {
    setmaxnreg_inc<kPpConsumerRegs>();

    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    const int t = tid % 128;
    const int lane = t % 32, quad = lane % 4;
    const int row_a = q0 + 64 * wg + 16 * (t / 32) + lane / 4;  // rows a, a + 8
    const int wg_row0 = q0 + 64 * wg;
    float o_acc[kOr];
#pragma unroll
    for (int i = 0; i < kOr; ++i) o_acc[i] = 0.f;
    RowState rows{kNegInf, kNegInf, 0.f, 0.f};
    float s[kBKV / 2];
    uint32_t p[kBKV / 4];

    // turns: warpgroup w issues its products after the other has issued its
    // own (named barrier 1 + w: its 128 threads wait, the other's 128
    // arrive); warpgroup 0 goes first, and each takes n_kv + 1 turns
    const uint32_t q_wg = q_s + wg * 64 * 128;        // its 64 rows of q
    if (wg == 1) named_arrive(1, kConsumerThreads);
    mbar_wait(bar(kBarQ), 0);
    float corr_a, corr_b;
    named_sync(1 + wg, kConsumerThreads);              // turn 0: S of tile 0
    wgmma_fence();
    mbar_wait(bar(kPpBarFullK), 0);
    issue_qk<kDh, kKvBoxBytes>(s, q_wg, k_s);
    named_arrive(2 - wg, kConsumerThreads);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(bar(kPpBarEmptyK));     // K of tile 0 free
    softmax_tile<kBKV>(s, rows, corr_a, corr_b, 0, t_len, causal, wg_row0,
                       row_a, quad, scale_log2);
    rescale_and_pack<kBKV>(o_acc, p, s, corr_a, corr_b);
    for (int j = 1; j < n_kv; ++j) {                   // turn j: S j, P V j-1
      const int st = j % kStages, sv = (j - 1) % kStages;
      named_sync(1 + wg, kConsumerThreads);
      fence_regs(o_acc);
      wgmma_fence();
      mbar_wait(bar(kPpBarFullK + st), (j / kStages) & 1);
      issue_qk<kDh, kKvBoxBytes>(s, q_wg, k_s + st * kKvBytes);
      mbar_wait(bar(kPpBarFullV + sv), ((j - 1) / kStages) & 1);
      issue_pv<kBKV, kKvBoxBytes>(o_acc, p, v_s + sv * kVBytes);
      named_arrive(2 - wg, kConsumerThreads);
      wgmma_wait<1>();                                 // S of tile j is in
      fence_regs(s);
      if (lane == 0) mbar_arrive(bar(kPpBarEmptyK + st));
      softmax_tile<kBKV>(s, rows, corr_a, corr_b, j, t_len, causal, wg_row0,
                         row_a, quad, scale_log2);
      wgmma_wait<0>();                                 // P V of tile j - 1
      fence_regs(o_acc);
      if (lane == 0) mbar_arrive(bar(kPpBarEmptyV + sv));
      rescale_and_pack<kBKV>(o_acc, p, s, corr_a, corr_b);
    }
    {                                                  // turn n_kv: P V last
      const int sv = (n_kv - 1) % kStages;
      named_sync(1 + wg, kConsumerThreads);
      fence_regs(o_acc);
      wgmma_fence();
      mbar_wait(bar(kPpBarFullV + sv), ((n_kv - 1) / kStages) & 1);
      issue_pv<kBKV, kKvBoxBytes>(o_acc, p, v_s + sv * kVBytes);
      if (wg == 0) named_arrive(2, kConsumerThreads);
      wgmma_wait<0>();
      fence_regs(o_acc);
    }
    float l_a = rows.l_a, l_b = rows.l_b;

    // the quad's partial row sums, then o / max(l, 1e-30)
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
    flash_lse::store_rows(lse, ((long long)bb * h_q + h) * s_len, row_a,
                          s_len, quad, rows.m_a, l_a, rows.m_b, l_b);
    const long long row_stride = (long long)h_q * dv;
    __nv_bfloat16* ob = o + ((long long)bb * s_len * h_q + h) * dv;
#pragma unroll
    for (int r = 0; r < kOr; r += 2) {
      const int row = row_a + ((r & 2) ? 8 : 0);
      const int col = 8 * (r / 4) + 2 * quad;   // dv % 8 == 0: col + 1 < dv too
      if (row >= s_len || col >= dv) continue;
      const float inv = (r & 2) ? inv_b : inv_a;
      *reinterpret_cast<__nv_bfloat162*>(ob + row * row_stride + col) =
          __floats2bfloat162_rn(o_acc[r] * inv, o_acc[r + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------ host
// (batch, len, heads, dh) bf16, 64-column x rows boxes, 128-byte swizzle;
// rows past len and columns past dh read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int batch, int len,
              int heads, int dh, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)len * heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the instances that run the pipelined loop: all but (256, 256), whose O
// of 128 floats a thread spills there (148 bytes) and ran slower than on
// the loop above (scripts/kernel_ab.py, PERF.md section 6)
template <int kDh, int kDv>
constexpr bool kPipelined = kDv <= 128;

template <int kDh, int kDv>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int s, int t, int h, int hk, int dh,
                   int dv, float scale, int causal, cudaStream_t stream) {
  constexpr bool kPp = kPipelined<kDh, kDv>;
  constexpr int kBKV = kPp ? kPpKvTile<kDh, kDv> : kKvTile;
  constexpr int kRing = kPp ? kPpStages<kDh, kDv> : kStages;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, s, h, dh, kBQ) ||
      !make_map(&mk, k, b, t, hk, dh, kBKV) ||
      !make_map(&mv, v, b, t, hk, dv, kBKV))
    return cudaErrorInvalidValue;
  const int smem = (kBQ * kDh + kRing * kBKV * (kDh + kDv)) * 2 + 1024;
  const auto kernel = [] {
    if constexpr (kPp) return flash_fwd_wgmma_pp_kernel<kDh, kDv>;
    else return flash_fwd_wgmma_kernel<kDh, kDv>;
  }();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  kernel<<<grid, kPp ? kPpThreads : kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, s, t, h, hk, dh, dv,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// q (b, s, h, dh), k (b, t, hk, dh), v (b, t, hk, dv), o (b, s, h, dv),
// contiguous bf16, each 16-byte aligned; h % hk == 0, dh % 8 == 0,
// dh <= 256, dv % 8 == 0, dv <= dh.  lse: null, or (b, h, s) f32 that
// receives each row's natural-log logsumexp (flash_lse.cuh).  Returns a
// cudaError_t.
extern "C" int flash_attn_fwd_wgmma(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int b,
                                    int s, int t, int h, int hk, int dh,
                                    int dv, float scale, int causal,
                                    void* stream) {
  float* ls = static_cast<float*>(lse);
  if (b < 1 || s < 1 || t < 1 || hk < 1 || h % hk || dh < 8 || dh % 8 ||
      dh > 256 || dv < 8 || dv % 8 || dv > dh ||
      (long long)b * h > 0x7fffffffLL || (s + kBQ - 1) / kBQ > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // dv > 128 or dh > 192: the 256 instance
  if (dv > 128 || dh > 192)
    return (int)launch<256, 256>(q, k, v, o, ls, b, s, t, h, hk, dh, dv,
                                 scale, causal, st);
  if (dh > 128)
    return (int)launch<192, 128>(q, k, v, o, ls, b, s, t, h, hk, dh, dv,
                                 scale, causal, st);
  return (int)(dh > 64 ? launch<128, 128>(q, k, v, o, ls, b, s, t, h, hk, dh,
                                          dv, scale, causal, st)
                       : launch<64, 64>(q, k, v, o, ls, b, s, t, h, hk, dh,
                                        dv, scale, causal, st));
}
