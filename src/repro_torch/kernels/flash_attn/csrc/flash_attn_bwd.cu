// GQA flash-attention backward (the VJP) on Hopper's tensor cores (sm_90a):
// bf16 wgmma on operands split into bf16 terms, f32 sums.
//
// Replaces no Pallas kernel: the reference differentiates its attention
// with a jax.custom_vjp whose backward, repro/models/layers.py::_flash_bwd,
// is plain jnp (XLA's fusions on the TPU).  It is written by hand because
// the port's forward is a kernel (flash_attn_fwd_{wgmma,tf32}.cu), so its
// torch.autograd.Function needs a backward of its own, and the plain
// backward (kernels/flash_attn/ref.py::flash_attn_bwd_ref) materialises a
// (B, Hk, G, S, 512) f32 score block per KV block and launches about ten
// ops a block.  The semantics are _flash_bwd's, from the logsumexp the
// forward saved (O(S) residuals; no score matrix in device memory):
//     D[s]  = sum_d dO[s, d] O[s, d]
//     P     = exp(scale * q . k - lse[s])        (0 where masked)
//     dV[t] = sum_s P[s, t] dO[s]
//     dP    = dO . v
//     dS    = P (dP - D[s])
//     dQ[s] = scale sum_t dS[s, t] k[t],  dK[t] = scale sum_s dS[s, t] q[s]
// with G = H / Hk query heads per KV head (dK and dV sum over the G heads),
// causal masking aligned at the top left (key t kept for query s where
// t <= s), q at offset 0, one width d = dh = dv <= 128, d % 8 == 0 (the
// wrapper pads other widths with zero columns, which give zero gradient
// columns, cut off after).
//
// What bounds it on an H100 SXM: operations.  At Qwen3-0.6B's attention
// widths (H 16, Hk 8, dh 128), B = 1, S = T = 4096, causal, each product
// over the kept (s, t) pairs is 34.4 GFLOP; the five of the semantics
// (S, dP, dV, dK, dQ) are 171.9 GFLOP: 1.04 ms as 3xTF32 at 495 TFLOP/s,
// 0.174 ms in bf16 at 989; its bytes (q, k, v, o, dO, lse read once, dq,
// dk, dv written once: 168 MB in f32) take 0.05 ms.
//
// Precision.  The reference computes in f32, and the kernel keeps that on
// bf16 tensor cores by splitting operands into bf16 terms, x = x0 + x1 +
// x2 with x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (24 bits
// of mantissa, f32's), and forming each product only for the term pairs
// (i, j) with i + j <= 2 (the dropped pairs are below f32's resolution of
// the sum); the products are exact, the sums f32.  Two instances of one
// template <kD, kTerms>, kTerms the terms of q, k, v and dO:
//   * kTerms = 1, bf16 inputs: q, k, v and dO are bf16 already (exact), so
//     S and dP take one pass each; P and dS are split into three terms in
//     registers (one bf16 P, as SDPA's bf16 backward rounds it, gives
//     gradients 2.7e-3 off in relative L2, two terms 8.6e-5, three none:
//     tests/test_torch_flash_bwd.py emulates it), so dV, dK and dQ take
//     three passes each: 13 passes of 34.4 GFLOP at row 6b's shape.
//     Gradients are written in bf16, rounded once from the f32 sums.
//   * kTerms = 3, f32 inputs: every operand in three terms, six passes a
//     product: 42 passes.  The split of q, k, v and dO is made once, by the
//     first kernel, into term planes in a scratch buffer the wrapper
//     allocates (3 x bf16 = 6 bytes an element, 151 MB at row 6b's shape,
//     about 0.08 ms of traffic); TMA then loads bf16 terms only, so the
//     dK/dV block fits its 64 keys' K and V (48 KB each in three terms) and
//     two stages of 32-row Q and dO tiles (24 KB each) in 192 KB, with no
//     f32 landing buffer.  (3xTF32, the forward's scheme, would need
//     transposed copies of Q and dO as well, TF32 wgmma having no
//     transpose bit: 256 KB, past the 227 KB a block may have.)
//   Gradients are written in f32.
//
// Three kernels, no atomics, every sum in a fixed order, so a gradient is
// the same bit for bit from run to run:
//   * bwd_prep_kernel: D, one warp a (b, s, h) row, four elements a lane,
//     in the inputs' dtype; with kTerms = 3 also the term planes of q, k,
//     v and dO, a row of each a warp;
//   * bwd_dkdv_kernel: one block a (b, kh, 64-key tile), one warpgroup
//     (128 threads, so ptxas may give a thread 255 registers: the 288- and
//     384-thread forwards sit at 168).  K and V stay in shared memory while
//     Q and dO tiles of 32 rows stream through a ring filled by TMA (4-d
//     tensor maps, 128-byte swizzle, kernels/hopper.cuh), the loads issued
//     by thread 0 as stages free up, over the G query heads and the query
//     tiles that reach its keys (causally: from the tile of its first key
//     on).  For each tile it computes S^T = K Q^T and dP^T = V dO^T (M = 64
//     keys, Q and dO the K-major B operand), so that P^T and dS^T come out
//     in the accumulator layout, which is the A-operand layout from
//     registers of dV += P^T dO and dK += dS^T Q; there dO and Q are the B
//     operand read MN-major (the bf16 transpose bit) from the same tiles.
//     dK and dV (64 + 64 f32 a thread) stay in registers over the loop;
//   * bwd_dq_kernel: one block a (b, h, 64-query tile), one warpgroup; Q
//     and dO resident, K and V tiles of 32 keys streamed as above; S = Q K^T
//     and dP = dO V^T, then dQ += dS K with dS's terms from registers as A
//     and K read MN-major.
// Both passes recompute S and dP (seven products where five would do).
// Blocks run longest first (the key tiles nearest the top, the query tiles
// nearest the bottom).  P is exp(scale S - lse) by expf, masked elements 0;
// every element step rounds on its own (the build passes -fmad=false).
//
// Sums.  The tensor cores' f32 accumulation is not f32's round to nearest:
// summed over all of a key tile's queries (thousands of wgmma steps) dK
// and dV came out 4.7e-5 off the plain f32 version in relative L2 at row
// 6b's shape (dQ, over fewer steps, 8.3e-6).  So every chain of wgmma
// steps starts from zero and stays short, and the kernel adds its result
// to a running sum in registers with __fadd_rn (promote): a tile's dV, dK
// or dQ (6 steps in bf16, 12 in f32), and S and dP each in two chains
// (the small term pairs and the large one; in bf16 the two halves of d).
// That leaves the f32 rounding of the running sums, about 5e-7 off the
// exact gradient in f32, below the plain f32 version's own 1.9e-6
// (chip_smoke.py phase 12, PERF.md).  dK/dV keeps one tile's product (64
// floats a thread) beside its two running sums, so it issues dV's chain
// and dK's one after the other.
//
// Shared memory at kD = 128: 193 KB in f32 (one block an SM); in bf16 97 KB
// for dK/dV (four stages, two blocks an SM: 252 registers) and 65 KB for
// dQ (two stages and at most 168 registers: three blocks an SM).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;          // one consumer warpgroup a block
constexpr int kRows = 64;              // keys (dK/dV) or queries (dQ) a block
constexpr int kBox = 64;               // bf16 columns of a 128-byte TMA box
constexpr int kMaxStages = 4;
constexpr int kSmemCap = 227 * 1024;   // shared memory a block may have
constexpr int kPrepThreads = 256;

// Sizes of the <kD, kTerms> instance.  A tensor's tile is kTerms term
// planes, each kD / 64 boxes of rows x 128 bytes, each box 1024-byte
// aligned for the 128-byte swizzle.
template <int kD, int kTerms>
struct Cfg {
  static constexpr int kBoxes = kD / kBox;
  static constexpr int kBn = 32;                     // rows of a streamed tile
  static constexpr int kResBox = kRows * 128;        // bytes of a resident box
  static constexpr int kResTerm = kBoxes * kResBox;
  static constexpr int kRes = kTerms * kResTerm;     // one resident tensor
  static constexpr int kStrBox = kBn * 128;
  static constexpr int kStrTerm = kBoxes * kStrBox;
  static constexpr int kStr = kTerms * kStrTerm;     // one streamed tensor
  static constexpr int kFit = (kSmemCap - 2048 - 2 * kRes) / (2 * kStr);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 2 * kRes + kStages * 2 * kStr + 1024;
  // the dQ pass in bf16: two stages (65 KB) and at most 168 registers, so
  // three blocks share an SM (its element steps wait on latency, and more
  // warps hide more of it: 10% faster than two blocks of four stages)
  static constexpr int kStagesQ = kTerms == 1 ? 2 : kStages;
  static constexpr int kSmemQ = 2 * kRes + kStagesQ * 2 * kStr + 1024;
  static constexpr int kMinBlocksQ = kTerms == 1 ? 3 : 1;
  static constexpr int kAcc = kD / 2;     // f32 of a 64 x kD sum a thread
  static constexpr int kSc = kBn / 2;     // f32 of a 64 x kBn score tile
};

// the gradients' type: bf16 for bf16 inputs, f32 for f32
template <int kTerms>
using Out = std::conditional_t<kTerms == 1, __nv_bfloat16, float>;

// barriers: the resident tiles, full [stage], empty [stage]
constexpr int kBarRes = 0, kBarFull = 1, kBarEmpty = 1 + kMaxStages,
              kNumBars = 1 + 2 * kMaxStages;

// d (64 x 32, f32) (+)= A (64 x 16, smem) * B (32 x 16, smem)^T, both
// K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : D16
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) (+)= A (64 x 16, registers) * B (16 x N, smem,
// MN-major), N = 128 or 64; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// sum += d, each element rounded on its own (f32, round to nearest)
template <int kN>
__device__ __forceinline__ void promote(float (&sum)[kN],
                                        const float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) sum[i] = __fadd_rn(sum[i], d[i]);
}

// s = sum over the term pairs (a, b), a + b <= 2, of A_a B_b^T, smallest
// terms first: A the 64-row resident tile (term planes kResTerm apart), B a
// streamed tile (kStrTerm apart), both K-major; kD / 16 k-steps a pair,
// step kk reading 32 bytes at (kk % 4) * 32 of the 128-byte rows of box
// kk / 4.  In two chains, each from zero, which the caller adds (the
// tensor cores' f32 sum loses more the longer a chain runs): sa the small
// pairs (three terms) or the first half of the k-steps (one term), sb the
// rest.  Issued, not committed.
template <int kD, int kTerms, int kN>
__device__ __forceinline__ void issue_scores(float (&sa)[kN],
                                             float (&sb)[kN], uint32_t a,
                                             uint32_t b) {
  using C = Cfg<kD, kTerms>;
  int acc_a = 0, acc_b = 0;
#pragma unroll
  for (int o = 2; o >= 0; --o)
#pragma unroll
    for (int ta = 0; ta < kTerms; ++ta) {
      const int tb = o - ta;
      if (tb < 0 || tb >= kTerms) continue;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = desc(
            a + ta * C::kResTerm + (kk / 4) * C::kResBox + off, 16, 1024);
        const uint64_t db = desc(
            b + tb * C::kStrTerm + (kk / 4) * C::kStrBox + off, 16, 1024);
        if (kTerms == 3 ? o == 0 : kk >= kD / 32) {
          mma_ss(sb, da, db, acc_b);
          acc_b = 1;
        } else {
          mma_ss(sa, da, db, acc_a);
          acc_a = 1;
        }
      }
    }
}

// d = sum over the term pairs (a, b), a + b <= 2, of X_a B_b, smallest
// terms first: X's three terms in registers as A (x[a][4 kk ..] the 16
// columns of k-step kk), B a streamed tile of kBn rows read MN-major (step
// kk: rows 16 kk .., 2 KB on; N = kD across the boxes, kStrBox apart).
// Issued, not committed.  The caller adds d to its running sum (promote):
// the tensor cores' own f32 accumulation over thousands of steps lost 4.7e-5
// relative in dK and dV at row 6b's shape, a short chain a tile does not.
template <int kD, int kTerms, int kN>
__device__ __forceinline__ void issue_grad(
    float (&d)[kN], const uint32_t (&x)[3][Cfg<kD, kTerms>::kSc / 2],
    uint32_t b) {
  using C = Cfg<kD, kTerms>;
  int acc = 0;
#pragma unroll
  for (int o = 2; o >= 0; --o)
#pragma unroll
    for (int ta = 0; ta < 3; ++ta) {
      const int tb = o - ta;
      if (tb < 0 || tb >= kTerms) continue;
#pragma unroll
      for (int kk = 0; kk < C::kBn / 16; ++kk) {
        mma_rs(d, &x[ta][4 * kk],
               desc(b + tb * C::kStrTerm + kk * 2048, C::kStrBox, 1024),
               acc);
        acc = 1;
      }
    }
}

// x[t][r / 2] = term t of (v[r], v[r + 1]), packed as an A-fragment
// register (the accumulator layout of the 64 x kN scores is the A-operand
// layout of the product over their columns): v = x0 + x1 + x2
template <int kN>
__device__ __forceinline__ void split_pack(const float (&v)[kN],
                                           uint32_t (&x)[3][kN / 2]) {
#pragma unroll
  for (int r = 0; r < kN; r += 2) {
    float a = v[r], b = v[r + 1];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // one cvt
      x[t][r / 2] = *reinterpret_cast<const uint32_t*>(&h);
      a = __fsub_rn(a, __low2float(h));
      b = __fsub_rn(b, __high2float(h));
    }
  }
}

// P and dS in place of the scores s and dp of a 64 x kN tile: element r
// at row row_a (+ 8 where r & 2), column col0 + 8 (r / 4) + 2 quad + (r &
// 1).  kKeysRows: rows are keys and columns queries (the dK/dV pass: lse
// and D by column, index 2 (r / 4) + (r & 1)); else rows are queries (lse
// and D by row, index (r & 2) / 2).
template <int kN, bool kKeysRows>
__device__ __forceinline__ void probs(float (&s)[kN], float (&dp)[kN],
                                      const float* lse_v, const float* dl_v,
                                      int row_a, int col0, int s_len,
                                      int t_len, int causal, float scale,
                                      int quad) {
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    const int row = row_a + ((r & 2) ? 8 : 0);
    const int col = col0 + 8 * (r / 4) + 2 * quad + (r & 1);
    const int key = kKeysRows ? row : col, qry = kKeysRows ? col : row;
    const int li = kKeysRows ? 2 * (r / 4) + (r & 1) : (r & 2) / 2;
    const bool keep = qry < s_len && key < t_len && (!causal || key <= qry);
    const float p =
        keep ? expf(__fsub_rn(__fmul_rn(s[r], scale), lse_v[li])) : 0.f;
    s[r] = p;
    dp[r] = __fmul_rn(p, __fsub_rn(dp[r], dl_v[li]));
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// scale * acc, the warpgroup's 64 x kD sum, to rows row_a (+ 8) (those <
// n_rows) of one head of a (b, len, heads, d) tensor whose row row0 is at
// dst: element r at column 8 (r / 4) + 2 quad + (r & 1), columns < d
template <int kAcc, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           long long row_stride, int row_a,
                                           int n_rows, int d, int quad,
                                           float scale,
                                           const float (&acc)[kAcc]) {
#pragma unroll
  for (int r = 0; r < kAcc; r += 2) {
    const int row = row_a + ((r & 2) ? 8 : 0);
    const int col = 8 * (r / 4) + 2 * quad;   // d % 8 == 0: col + 1 < d too
    if (row >= n_rows || col >= d) continue;
    store2(dst + row * row_stride + col, __fmul_rn(acc[r], scale),
           __fmul_rn(acc[r + 1], scale));
  }
}

// ------------------------------------------------------------- kernels
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

// the three terms of four elements, to dst, dst + plane, dst + 2 plane
__device__ __forceinline__ void split_store(float4 x,
                                            __nv_bfloat16* __restrict__ dst,
                                            long long plane) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  uint32_t w[3][2];
  split_pack(v, w);
#pragma unroll
  for (int t = 0; t < 3; ++t)
    *reinterpret_cast<uint2*>(dst + t * plane) = make_uint2(w[t][0], w[t][1]);
}

// D = rowsum(dO * O), a warp a (b, s, h) row; with kTerms = 3 also the
// term planes of q and dO (that row) and of k and v (row `row` of theirs)
template <typename T, int kTerms>
__global__ void __launch_bounds__(kPrepThreads)
bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const T* __restrict__ dout, float* __restrict__ delta,
                __nv_bfloat16* __restrict__ q3,
                __nv_bfloat16* __restrict__ do3,
                __nv_bfloat16* __restrict__ k3,
                __nv_bfloat16* __restrict__ v3, long long rows_q,
                long long rows_kv, int s_len, int h_q, int d) {
  const long long row = (long long)blockIdx.x * (kPrepThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32, c = 4 * lane;
  if (row < rows_q) {                              // (b, s, h)
    float acc = 0.f;
    if (c < d) {
      const float4 a = load4(o + row * d + c);
      const float4 g = load4(dout + row * d + c);
      acc = __fmaf_rn(a.x, g.x, acc);
      acc = __fmaf_rn(a.y, g.y, acc);
      acc = __fmaf_rn(a.z, g.z, acc);
      acc = __fmaf_rn(a.w, g.w, acc);
      if constexpr (kTerms == 3) {
        split_store(g, do3 + row * d + c, rows_q * d);
        split_store(load4(q + row * d + c), q3 + row * d + c, rows_q * d);
      }
    }
#pragma unroll
    for (int sh = 16; sh >= 1; sh >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, sh));
    if (lane == 0) {
      const long long h = row % h_q, bs = row / h_q;
      const long long b = bs / s_len, s = bs % s_len;
      delta[(b * h_q + h) * s_len + s] = acc;
    }
  }
  if constexpr (kTerms == 3) {
    if (row < rows_kv && c < d) {                  // (b, t, hk)
      split_store(load4(k + row * d + c), k3 + row * d + c, rows_kv * d);
      split_store(load4(v + row * d + c), v3 + row * d + c, rows_kv * d);
    }
  }
}

// One block a (b, kh, 64-key tile): dK and dV of those keys (header).
// Maps: K and V in 64-row boxes, Q and dO in kBn-row boxes, the term
// planes as the outer coordinate (term a of batch bb at a * b + bb).
template <int kD, int kTerms>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_do,
                const float* __restrict__ lse,
                const float* __restrict__ delta, Out<kTerms>* __restrict__ dk,
                Out<kTerms>* __restrict__ dv, int b, int s_len, int t_len,
                int h_q, int h_kv, int d, float scale, int causal) {
  using C = Cfg<kD, kTerms>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  // K | V | stage 0: Q, dO | stage 1 ..., each 1024-byte aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + C::kRes, str_s = base + 2 * C::kRes;
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int bb = blockIdx.x / h_kv, kh = blockIdx.x % h_kv;
  const int g_n = h_q / h_kv;
  const int k0 = blockIdx.y * kRows;               // key tiles, longest first
  const int n_qt = (s_len + C::kBn - 1) / C::kBn;
  const int it0 = causal ? min(k0 / C::kBn, n_qt) : 0;  // tiles reaching k0
  const int n_it = n_qt - it0;
  const int n_iter = g_n * n_it;                    // (head, query tile)

  // thread 0: Q and dO of iteration i into stage i % kStages
  auto load_tiles = [&](int i) {
    const int st = i % C::kStages;
    const int h = kh * g_n + i / n_it, q0 = (it0 + i % n_it) * C::kBn;
    const uint32_t dst = str_s + st * 2 * C::kStr;
    mbar_expect_tx(bar(kBarFull + st), 2 * C::kStr);
    for (int a = 0; a < kTerms; ++a)
      for (int c = 0; c < C::kBoxes; ++c) {
        const uint32_t off = a * C::kStrTerm + c * C::kStrBox;
        tma_load_4d(dst + off, &map_q, bar(kBarFull + st), c * kBox, h, q0,
                    a * b + bb);
        tma_load_4d(dst + C::kStr + off, &map_do, bar(kBarFull + st),
                    c * kBox, h, q0, a * b + bb);
      }
  };
  if (tid == 0) {
    mbar_init(bar(kBarRes), 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar(kBarFull + st), 1);
      mbar_init(bar(kBarEmpty + st), kThreads / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar(kBarRes), 2 * C::kRes);
    for (int a = 0; a < kTerms; ++a)
      for (int c = 0; c < C::kBoxes; ++c) {
        const uint32_t off = a * C::kResTerm + c * C::kResBox;
        tma_load_4d(k_s + off, &map_k, bar(kBarRes), c * kBox, kh, k0,
                    a * b + bb);
        tma_load_4d(v_s + off, &map_v, bar(kBarRes), c * kBox, kh, k0,
                    a * b + bb);
      }
    for (int i = 0; i < min(C::kStages, n_iter); ++i) load_tiles(i);
  }

  float dk_acc[C::kAcc], dv_acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int row_a = k0 + 16 * warp + lane / 4;      // keys row_a, row_a + 8
  mbar_wait(bar(kBarRes), 0);
  for (int i = 0; i < n_iter; ++i) {
    const int st = i % C::kStages;
    const uint32_t ph = (i / C::kStages) & 1;
    const int h = kh * g_n + i / n_it, q0 = (it0 + i % n_it) * C::kBn;
    const uint32_t q_t = str_s + st * 2 * C::kStr, do_t = q_t + C::kStr;

    // S^T = K Q^T, dP^T = V dO^T (64 keys x kBn queries)
    float s[C::kSc], dp[C::kSc], s2[C::kSc], dp2[C::kSc];
    mbar_wait(bar(kBarFull + st), ph);
    wgmma_fence();
    issue_scores<kD, kTerms>(s, s2, k_s, q_t);
    issue_scores<kD, kTerms>(dp, dp2, v_s, do_t);
    wgmma_commit();
    // lse and D of the thread's columns (queries q0 + 8 j' + 2 quad + e)
    // while the products run
    float lse_v[C::kBn / 4], dl_v[C::kBn / 4];
    const long long lrow = ((long long)bb * h_q + h) * s_len;
#pragma unroll
    for (int j = 0; j < C::kBn / 4; ++j) {
      const int qs = q0 + 8 * (j / 2) + 2 * quad + (j & 1);
      lse_v[j] = qs < s_len ? lse[lrow + qs] : 0.f;
      dl_v[j] = qs < s_len ? delta[lrow + qs] : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(s2);
    fence_regs(dp2);
    promote(s, s2);
    promote(dp, dp2);
    probs<C::kSc, true>(s, dp, lse_v, dl_v, row_a, q0, s_len, t_len, causal,
                        scale, quad);

    // dV += P^T dO, then dK += dS^T Q: P^T, then dS^T, in three terms as
    // A, each tile's product in `part`, promoted into the running sum
    uint32_t xt[3][C::kSc / 2];
    float part[C::kAcc];
    split_pack(s, xt);
    wgmma_fence();
    issue_grad<kD, kTerms>(part, xt, do_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    promote(dv_acc, part);
    split_pack(dp, xt);
    wgmma_fence();
    issue_grad<kD, kTerms>(part, xt, q_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    promote(dk_acc, part);
    if (lane == 0) mbar_arrive(bar(kBarEmpty + st));   // stage free
    if (tid == 0 && i + C::kStages < n_iter) {
      mbar_wait(bar(kBarEmpty + st), ph);
      load_tiles(i + C::kStages);
    }
  }
  const long long row_stride = (long long)h_kv * d;
  const long long out = ((long long)bb * t_len * h_kv + kh) * d;
  store_rows(dk + out, row_stride, row_a, t_len, d, quad, scale, dk_acc);
  store_rows(dv + out, row_stride, row_a, t_len, d, quad, 1.f, dv_acc);
}

// One block a (b, h, 64-query tile): dQ of those queries (header).  Maps:
// Q and dO in 64-row boxes, K and V in kBn-row boxes.
template <int kD, int kTerms>
__global__ void __launch_bounds__(kThreads, Cfg<kD, kTerms>::kMinBlocksQ)
bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const float* __restrict__ lse, const float* __restrict__ delta,
              Out<kTerms>* __restrict__ dq, int b, int s_len, int t_len,
              int h_q, int h_kv, int d, float scale, int causal) {
  using C = Cfg<kD, kTerms>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  // Q | dO | stage 0: K, V | stage 1 ..., each 1024-byte aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::kRes, str_s = base + 2 * C::kRes;
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int bb = blockIdx.x / h_q, h = blockIdx.x % h_q;
  const int kh = h / (h_q / h_kv);
  const int n_qt = (s_len + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kRows;   // longest first
  const int q_last = min(q0 + kRows, s_len) - 1;
  const int n_kt = (t_len + C::kBn - 1) / C::kBn;
  const int n_iter = causal ? min(n_kt, q_last / C::kBn + 1) : n_kt;

  // thread 0: K and V of key tile j into stage j % kStages
  auto load_tiles = [&](int j) {
    const int st = j % C::kStagesQ;
    const uint32_t dst = str_s + st * 2 * C::kStr;
    mbar_expect_tx(bar(kBarFull + st), 2 * C::kStr);
    for (int a = 0; a < kTerms; ++a)
      for (int c = 0; c < C::kBoxes; ++c) {
        const uint32_t off = a * C::kStrTerm + c * C::kStrBox;
        tma_load_4d(dst + off, &map_k, bar(kBarFull + st), c * kBox, kh,
                    j * C::kBn, a * b + bb);
        tma_load_4d(dst + C::kStr + off, &map_v, bar(kBarFull + st),
                    c * kBox, kh, j * C::kBn, a * b + bb);
      }
  };
  if (tid == 0) {
    mbar_init(bar(kBarRes), 1);
    for (int st = 0; st < C::kStagesQ; ++st) {
      mbar_init(bar(kBarFull + st), 1);
      mbar_init(bar(kBarEmpty + st), kThreads / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar(kBarRes), 2 * C::kRes);
    for (int a = 0; a < kTerms; ++a)
      for (int c = 0; c < C::kBoxes; ++c) {
        const uint32_t off = a * C::kResTerm + c * C::kResBox;
        tma_load_4d(q_s + off, &map_q, bar(kBarRes), c * kBox, h, q0,
                    a * b + bb);
        tma_load_4d(do_s + off, &map_do, bar(kBarRes), c * kBox, h, q0,
                    a * b + bb);
      }
    for (int j = 0; j < min(C::kStagesQ, n_iter); ++j) load_tiles(j);
  }

  float dq_acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dq_acc[i] = 0.f;
  const int row_a = q0 + 16 * warp + lane / 4;      // queries row_a, + 8
  const long long lrow = ((long long)bb * h_q + h) * s_len;
  float lse_v[2], dl_v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qs = row_a + 8 * e;
    lse_v[e] = qs < s_len ? lse[lrow + qs] : 0.f;
    dl_v[e] = qs < s_len ? delta[lrow + qs] : 0.f;
  }
  mbar_wait(bar(kBarRes), 0);
  for (int j = 0; j < n_iter; ++j) {
    const int st = j % C::kStagesQ;
    const uint32_t ph = (j / C::kStagesQ) & 1;
    const uint32_t k_t = str_s + st * 2 * C::kStr, v_t = k_t + C::kStr;

    // S = Q K^T, dP = dO V^T (64 queries x kBn keys)
    float s[C::kSc], dp[C::kSc], s2[C::kSc], dp2[C::kSc];
    mbar_wait(bar(kBarFull + st), ph);
    wgmma_fence();
    issue_scores<kD, kTerms>(s, s2, q_s, k_t);
    issue_scores<kD, kTerms>(dp, dp2, do_s, v_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(s2);
    fence_regs(dp2);
    promote(s, s2);
    promote(dp, dp2);
    probs<C::kSc, false>(s, dp, lse_v, dl_v, row_a, j * C::kBn, s_len,
                         t_len, causal, scale, quad);

    // dQ += dS K: dS in three terms as A, K read MN-major, the tile's
    // product in `part`, promoted into the running sum
    uint32_t xt[3][C::kSc / 2];
    float part[C::kAcc];
    split_pack(dp, xt);
    wgmma_fence();
    issue_grad<kD, kTerms>(part, xt, k_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    promote(dq_acc, part);
    if (lane == 0) mbar_arrive(bar(kBarEmpty + st));   // stage free
    if (tid == 0 && j + C::kStagesQ < n_iter) {
      mbar_wait(bar(kBarEmpty + st), ph);
      load_tiles(j + C::kStagesQ);
    }
  }
  const long long row_stride = (long long)h_q * d;
  Out<kTerms>* out = dq + ((long long)bb * s_len * h_q + h) * d;
  store_rows(out, row_stride, row_a, s_len, d, quad, scale, dq_acc);
}

// ------------------------------------------------------------------ host
// (batch, len, heads, d) bf16, 64-column x rows boxes, 128-byte swizzle;
// rows past len and columns past d read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int batch, int len,
              int heads, int d, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)len * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, int kTerms>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta,
                   __nv_bfloat16* scratch, int b, int s, int t, int h,
                   int hk, int d, float scale, int causal,
                   cudaStream_t stream) {
  using C = Cfg<kD, kTerms>;
  using In = std::conditional_t<kTerms == 1, __nv_bfloat16, float>;
  using O = Out<kTerms>;
  const long long rows_q = (long long)b * s * h;
  const long long rows_kv = (long long)b * t * hk;
  // the bf16 planes the products read: the inputs themselves, or their
  // terms in the scratch (q, dO, k, v, each kTerms planes)
  const void *qp = q, *dop = dout, *kp = k, *vp = v;
  __nv_bfloat16 *q3 = nullptr, *do3 = nullptr, *k3 = nullptr, *v3 = nullptr;
  if constexpr (kTerms == 3) {
    q3 = scratch;
    do3 = q3 + 3 * rows_q * d;
    k3 = do3 + 3 * rows_q * d;
    v3 = k3 + 3 * rows_kv * d;
    qp = q3, dop = do3, kp = k3, vp = v3;
  }
  const long long rows = rows_q > rows_kv ? rows_q : rows_kv;
  const long long blocks = (rows + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  bwd_prep_kernel<In, kTerms><<<(unsigned)blocks, kPrepThreads, 0, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(k),
      static_cast<const In*>(v), static_cast<const In*>(o),
      static_cast<const In*>(dout), delta, q3, do3, k3, v3, rows_q, rows_kv,
      s, h, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int nb = b * kTerms;                // term a of batch bb: a * b + bb
  CUtensorMap mk_r, mv_r, mq_s, mdo_s, mq_r, mdo_r, mk_s, mv_s;
  if (!make_map(&mk_r, kp, nb, t, hk, d, kRows) ||
      !make_map(&mv_r, vp, nb, t, hk, d, kRows) ||
      !make_map(&mq_s, qp, nb, s, h, d, C::kBn) ||
      !make_map(&mdo_s, dop, nb, s, h, d, C::kBn) ||
      !make_map(&mq_r, qp, nb, s, h, d, kRows) ||
      !make_map(&mdo_r, dop, nb, s, h, d, kRows) ||
      !make_map(&mk_s, kp, nb, t, hk, d, C::kBn) ||
      !make_map(&mv_s, vp, nb, t, hk, d, C::kBn))
    return cudaErrorInvalidValue;

  e = cudaFuncSetAttribute(bwd_dkdv_kernel<kD, kTerms>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem);
  if (e != cudaSuccess) return e;
  bwd_dkdv_kernel<kD, kTerms><<<dim3(b * hk, (t + kRows - 1) / kRows),
                                kThreads, C::kSmem, stream>>>(
      mk_r, mv_r, mq_s, mdo_s, lse, delta, static_cast<O*>(dk),
      static_cast<O*>(dv), b, s, t, h, hk, d, scale, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  e = cudaFuncSetAttribute(bwd_dq_kernel<kD, kTerms>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmemQ);
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<kD, kTerms><<<dim3(b * h, (s + kRows - 1) / kRows), kThreads,
                              C::kSmemQ, stream>>>(
      mq_r, mdo_r, mk_s, mv_s, lse, delta, static_cast<O*>(dq), b, s, t, h,
      hk, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (b, s, h, d); k, v, dk, dv (b, t, hk, d); lse and delta
// (b, h, s) f32: contiguous, each 16-byte aligned; lse the forward's
// natural-log logsumexp, delta scratch the call overwrites.  terms = 1:
// q, k, v, o, dout bf16, dq, dk, dv written in bf16, scratch unused;
// terms = 3: all f32, scratch 6 (b s h + b t hk) d bf16 for the term
// planes.  h % hk == 0, 8 <= d <= 128, d % 8 == 0.  Returns a cudaError_t.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* delta, void* scratch, int b, int s, int t,
                              int h, int hk, int d, float scale, int causal,
                              int terms, void* stream) {
  if (b < 1 || s < 1 || t < 1 || hk < 1 || h % hk || d < 8 || d % 8 ||
      d > 128 || (terms != 1 && terms != 3) ||
      (terms == 3 && scratch == nullptr) ||
      (long long)b * h > 0x7fffffffLL || (long long)b * terms > 0x7fffffffLL ||
      (s + kRows - 1) / kRows > 65535 || (t + kRows - 1) / kRows > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
        reinterpret_cast<uintptr_t>(scratch)) &
       15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  __nv_bfloat16* sc = static_cast<__nv_bfloat16*>(scratch);
#define FLASH_BWD_LAUNCH(D, TERMS)                                          \
  launch<D, TERMS>(q, k, v, o, dout, ls, dq, dk, dv, dl, sc, b, s, t, h, hk, \
                   d, scale, causal, st)
  if (terms == 1)
    return (int)(d > 64 ? FLASH_BWD_LAUNCH(128, 1) : FLASH_BWD_LAUNCH(64, 1));
  return (int)(d > 64 ? FLASH_BWD_LAUNCH(128, 3) : FLASH_BWD_LAUNCH(64, 3));
#undef FLASH_BWD_LAUNCH
}
