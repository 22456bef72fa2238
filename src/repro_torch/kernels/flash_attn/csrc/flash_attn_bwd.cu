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
//     D[s]  = sum_e dO[s, e] O[s, e]               (over v's width)
//     P     = exp(scale * q . k - lse[s])        (0 where masked)
//     dV[t] = sum_s P[s, t] dO[s]
//     dP    = dO . v
//     dS    = P (dP - D[s])
//     dQ[s] = scale sum_t dS[s, t] k[t],  dK[t] = scale sum_s dS[s, t] q[s]
// with G = H / Hk query heads per KV head (dK and dV sum over the G heads),
// causal masking aligned at the top left (key t kept for query s where
// t <= s), q at offset 0, q and k d wide, v, O and dO d_v <= d wide, both
// multiples of 8 (the wrapper pads other widths with zero columns, which
// give zero gradient columns, cut off after).  Instances (kD, kDv): (32,
// 32), the narrow kernel at the end (f32 inputs, q/k at most 32 wide, at
// most 256 keys: BERT4Rec's training shape); (64, 64), (128, 128) and
// (192, 128), DeepSeek-V2's MLA (q/k 192, v 128); any other width runs on
// the smallest of the last three that holds it, its tensor maps at the
// true widths, so TMA reads the columns past them as zeros.
//
// What bounds it on an H100 SXM: operations.  At Qwen3-0.6B's attention
// widths (H 16, Hk 8, dh 128), B = 1, S = T = 4096, causal, each product
// over the kept (s, t) pairs is 34.4 GFLOP; the five of the semantics
// (S, dP, dV, dK, dQ) are 171.9 GFLOP: 1.04 ms as 3xTF32 at 495 TFLOP/s,
// 0.174 ms in bf16 at 989; its bytes (q, k, v, o, dO, lse read once, dq,
// dk, dv written once: 168 MB in f32) take 0.05 ms.  At the MLA shape (H =
// Hk = 16, q/k 192, v 128) the five are 2 (3 * 192 + 2 * 128) FLOP a kept
// pair, 223.4 GFLOP: 1.354 ms as 3xTF32, 0.226 ms in bf16.
//
// Precision.  The reference computes in f32, and the kernel keeps that on
// bf16 tensor cores by splitting operands into bf16 terms, x = x0 + x1 +
// x2 with x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (24 bits
// of mantissa, f32's), and forming each product only for the term pairs
// (i, j) with i + j <= 2 (the dropped pairs are below f32's resolution of
// the sum); the products are exact, the sums f32.  Instances of one
// template <kD, kDv, kTerms>, kTerms the terms of q, k, v and dO:
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
//   * bwd_prep_kernel: D, one warp a (b, s, h) row, four elements a lane
//     (a second pass past 128 columns), in the inputs' dtype; with kTerms =
//     3 also the term planes of q, k (d wide), v and dO (d_v wide), a row
//     of each a warp;
//   * bwd_dkdv_kernel: one block a (b, kh, 64-key tile), one warpgroup
//     (128 threads, so ptxas may give a thread 255 registers: the 288- and
//     384-thread forwards sit at 168).  K and V stay in shared memory while
//     Q and dO tiles of kBn rows stream through a ring filled by TMA (4-d
//     tensor maps, 128-byte swizzle, kernels/hopper.cuh), the loads issued
//     by thread 0 as stages free up, over the G query heads and the query
//     tiles that reach its keys (causally: from the tile of its first key
//     on).  For each tile it computes S^T = K Q^T and dP^T = V dO^T (M = 64
//     keys, Q and dO the K-major B operand), so that P^T and dS^T come out
//     in the accumulator layout, which is the A-operand layout from
//     registers of dV += P^T dO and dK += dS^T Q; there dO and Q are the B
//     operand read MN-major (the bf16 transpose bit) from the same tiles.
//     dK and dV (kD / 2 + kDv / 2 f32 a thread) stay in registers;
//   * bwd_dq_kernel: one block a (b, h, 64-query tile), one warpgroup; Q
//     and dO resident, K and V tiles of kBn keys streamed as above; S = Q
//     K^T and dP = dO V^T, then dQ += dS K with dS's terms from registers as
//     A and K read MN-major;
//   * bwd_dkdv_duo_kernel, bwd_dq_duo_kernel: the same two passes for the
//     (192, 128) instance on two warpgroups a block (below).
// Both passes recompute S and dP (seven products where five would do).
// Blocks run longest first (the key tiles nearest the top, the query tiles
// nearest the bottom).  P is exp(scale S - lse) by expf (in base 2 by
// ex2.approx in the (192, 128) instance, below), masked elements 0; every
// element step rounds on its own (the build passes -fmad=false).
//
// Sums.  The tensor cores' f32 accumulation is not f32's round to nearest:
// summed over all of a key tile's queries (thousands of wgmma steps) dK
// and dV came out 4.7e-5 off the plain f32 version in relative L2 at row
// 6b's shape (dQ, over fewer steps, 8.3e-6).  So every chain of wgmma
// steps starts from zero and stays short, and the kernel adds its result
// to a running sum in registers with __fadd_rn (promote): a tile's dV, dK
// or dQ (3 N / 16 steps in bf16, 6 N / 16 in f32, N the streamed rows of
// a tile), and S and dP each in two chains
// (the small term pairs and the large one; in bf16 the two halves of the
// width).  That leaves the f32 rounding of the running sums, about 5e-7
// off the exact gradient in f32, below the plain f32 version's own 1.9e-6
// (chip_smoke.py phase 12, PERF.md).  The one-warpgroup dK/dV keeps one
// tile's product beside its two running sums, so it issues dV's chain and
// dK's one after the other.
//
// Shared memory and registers.  (128, 128): 193 KB in f32 (one block an
// SM); in bf16 97 KB for dK/dV (four stages, two blocks an SM: 252
// registers) and 65 KB for dQ (two stages and at most 168 registers: three
// blocks an SM).  (64, 64) and (128, 128) stream 32-row tiles.
//
// The (192, 128) instance, DeepSeek-V2's MLA (q/k 192, v 128), runs two
// consumer warpgroups a block (256 threads, so ptxas may still give a
// thread 255 registers), parted by product, not by rows: at 64 rows a
// warpgroup, one that held both of dK/dV's sums would hold dK's 96 floats
// and dV's 64 a thread beside a tile's products (the one-warpgroup kernel
// that ran it spilled at 255).  In both passes warpgroup 0 forms S (K Q^T
// in dK/dV, Q K^T in dQ) and P, and warpgroup 1 dP and then dS, P handed
// to it through shared memory in f32 (both hold a tile in the same
// accumulator layout, so thread t of one writes what thread t of the other
// reads: 64 x N x 4 bytes, no bank conflict).  In dK/dV warpgroup 0 then
// sums dV (64 floats a thread) and warpgroup 1 dK (96): 192 + 128 columns
// of products a tile each.  In dQ warpgroup 1 sums all of dQ (96 floats)
// and warpgroup 0, which holds no sum, issues the next tile's S as soon as
// P is formed, so that S runs under warpgroup 1's dS and dQ (192 and 128 +
// 192 columns: handing dS back to split dQ's columns between the two read
// slower).
// The two run apart, one's element steps (the exponentials, dS, the
// splits) under the other's products, ordered by named barriers 1 (P in)
// and 2 (P read, before the hand-off is written again).  A 192-column sum
// takes its product in slices, two in flight, one promoted while the next
// runs (grad192_into).  No thread waits for a stage to free: each of the
// eight warps counts its release of a stage in shared memory, and the warp
// whose release is the last refills it at once (flash_attn_fwd_wgmma.cu's
// scheme; the one-warpgroup kernels' loading thread waits on the stage's
// empty barrier and holds its warp).  Blocks run in groups of two (b,
// head) pairs, each group longest first (block_pos).
//   Streamed rows: the widest of 64, 32 and 16 at which two stages fit
// beside the resident tiles and the hand-off (64 at most: a 64 x 64 tile's
// two score chains take 64 floats a thread).  bf16: K and V (or Q and dO)
// 40 KB, a 64-row stage 40 KB, the hand-off 16 KB: 64 rows (m64n64k16
// score products), four stages, 217 KB.  f32: the three-term residency
// takes 120 KB and a 32-row stage 60 KB, so two of them do not fit: 16
// rows (m64n16k16), three stages, 215 KB.  One block an SM.
//   Element steps, which on bf16 inputs took as long as the products: P is
// 2^(scale log2(e) S - lse log2(e)) by ex2.approx, each factor and step
// rounded once (the forward's base 2; expf's range reduction was a large
// share of the element steps); on bf16 inputs the terms of P and dS are
// cut by truncation (split_cut: as exact as rounding, without the
// conversions) and S^T reads K from registers (its A fragments loaded once
// a block), not shared memory.  The one-warpgroup instances keep expf and
// rounded terms.
//
// The narrow instance (bwd_narrow_kernel): f32 inputs with q/k at most 32
// wide over at most 256 keys, BERT4Rec's training shape (B 16,384 a
// microbatch, S = T = 200, H = Hk = 2, dh 32).  There the (64, 64)
// instance spent half of every product on zero columns, ran 131,072
// blocks a pass whose set-up was as long as their work, formed S and dP
// twice, and wrote and read back 5 GB of term planes.  Here a unit of
// work is a (batch, KV head) with all its G S query rows and T keys, on
// one block of four warpgroups (512 threads, at most 128 registers each);
// the grid is persistent (a block an SM, the units in turn).  Warpgroup w
// keeps keys [64 w, 64 w + 64) of K and V resident in shared memory in
// three bf16 terms (the A operands of its scores; its K also the B
// operand of its share of dQ), loaded from device memory by its own
// threads at the unit's start (each key's row read once; the next unit's
// rows prefetched into L2 at this one's start), rows past T zero.  The
// unit's query rows stream in stages of 32 rows of one query head (heads
// outer): every thread loads its two columns of one row of q, dO and O
// one stage ahead into registers (so the loads run under this stage's
// products), then, once its warpgroup's dV and dK have read the stage,
// splits q and dO into three bf16 terms in the other of two stage
// buffers and sums its row's D = rowsum(dO O) with the row's other
// 15 threads by shuffles in a fixed order (no prep kernel, no scratch);
// a barrier a buffer (16 warps arrive) publishes the stage.  Each
// warpgroup, for each stage:
//   * S^T = K Q^T and dP^T = V dO^T (m64n32k16 on SW64 tiles: 64 keys x
//     32 queries, K = 32: two k-steps, six term pairs, one chain of twelve
//     steps each, the small pairs first: two chains, as the other
//     instances keep, took 32 more registers and spilled), so P^T =
//     2^(S^T scale2 - lse2) (ex2.approx, lse2 = lse log2(e) formed with
//     the stage) and dS^T = P^T (dP^T - D) come out in the accumulator
//     layout, the A layout from registers of
//   * dV += P^T dO and dK += dS^T Q (m64n32k16, B the stage's dO and Q
//     read MN-major through the transpose bit; twelve steps a product,
//     from zero, promoted into the running f32 sums): each input row is
//     read once and S and dP are formed once, five products in all;
//   * dS^T's three terms into the warpgroup's 12 KB slice, then its dQ
//     share over its 64 keys, dS K, by mma.sync m16n8k16 (wgmma's M is
//     64 and a stage has 32 query rows): warp w takes queries 16 (w & 1)
//     .. and columns 16 (w >> 1) .., A (dS) and B (K) from shared memory
//     by ldmatrix.trans, a 16-key step at a time from zero, promoted; the
//     32 x 32 f32 partial into one of two partial buffers, and a barrier
//     a buffer (16 warps arrive);
//   * warpgroup j % 4 (j the block's stage) waits for the stage's four
//     partials, sums them in order w = 0 .. 3 and writes dQ's 32 rows: dQ
//     is complete inside the block, with no atomics.
// At the unit's end each warpgroup writes its keys' dK (scaled) and dV.
// No sum depends on timing, so a gradient repeats bit for bit.  The
// stage and partial buffers need no empty barriers: a thread passes
// stage j's full barrier only after every thread has split stage j, which
// each does in stage j - 1 after its products have read that stage's
// buffer, and after its stage j - 2 (its dQ sum included) is done.
// Padding: the keys as M pad T to 256 (200 -> 256, 28%); the query rows
// to a multiple of 32 (200 -> 224, 12%); no column is padded at dh 32.
// Shared memory (one block an SM): K and V 2 x 48 KB, two stages 2 x 12
// KB, the dS^T slices 48 KB, two sets of partials 2 x 16 KB, the stages'
// lse2 and D 0.5 KB, 1 KB of alignment: 201.5 KB.  Registers: the 128 a
// thread of a 512-thread block may have (ptxas: 128, 48 bytes spilled; no
// wgmma serialised: every warpgroup issues every product, no branch
// around a wgmma, no call).  Registers bound the design: each of these
// spilled more and read slower at BERT4Rec's shape: two score chains;
// three stage buffers, a stage split one stage early; dK's A from the
// dS^T slice, issued with dV in one group; K's (and V's) A fragments in
// registers; the last warp to publish a stage's partial summing its dQ;
// the sum one stage late.  Bound at BERT4Rec's shape: the five products,
// 419 GFLOP, 1.26 T as 3xTF32: 2.54 ms at 495 TFLOP/s (6.7 GB of inputs
// and outputs, 2.0 ms).

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
constexpr int kDuoThreads = 256;       // (192, 128): two
constexpr int kRows = 64;              // keys (dK/dV) or queries (dQ) a block
constexpr int kBox = 64;               // bf16 columns of a 128-byte TMA box
constexpr int kMaxStages = 4;
constexpr int kSmemCap = 227 * 1024;   // shared memory a block may have
constexpr int kSmemHalf = 113 * 1024;  // a block's share where two fit an SM
constexpr int kPrepThreads = 256;

// Sizes of the <kD, kDv, kTerms> instance up to kD = 128.  A tensor's tile
// is kTerms term planes, each width / 64 boxes of rows x 128 bytes, each
// box 1024-byte aligned for the 128-byte swizzle: q and k kD wide (kBoxes
// boxes), v and dO kDv wide (kBoxesV).  Each kernel keeps one of each
// width resident (K and V, or Q and dO) and streams the other two, a stage
// holding both, in 32-row tiles.
template <int kD, int kDv, int kTerms>
struct Cfg {
  static constexpr int kBoxes = kD / kBox;
  static constexpr int kBoxesV = kDv / kBox;
  static constexpr int kResBox = kRows * 128;        // bytes of a resident box
  static constexpr int kResTerm = kBoxes * kResBox;
  static constexpr int kResTermV = kBoxesV * kResBox;
  static constexpr int kRes = kTerms * kResTerm;     // resident K or Q
  static constexpr int kResV = kTerms * kResTermV;   // resident V or dO
  static constexpr int kResAll = kRes + kResV;
  static constexpr int kBn = 32;                     // rows of a streamed tile
  static constexpr int kStrBox = kBn * 128;
  static constexpr int kStrTerm = kBoxes * kStrBox;
  static constexpr int kStrTermV = kBoxesV * kStrBox;
  static constexpr int kStr = kTerms * kStrTerm;     // streamed Q or K
  static constexpr int kStrV = kTerms * kStrTermV;   // streamed dO or V
  static constexpr int kStage = kStr + kStrV;
  // f32: as many stages as one block an SM holds; bf16: as many as leave
  // room for two blocks an SM
  static constexpr int kFit =
      ((kTerms == 1 ? kSmemHalf : kSmemCap) - 2048 - kResAll) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kResAll + kStages * kStage + 1024;
  // the dQ pass in bf16: two stages (65 KB at kD = 128) and at most 168
  // registers, so three blocks share an SM (its element steps wait on
  // latency, and more warps hide more of it: 10% faster than two blocks of
  // four stages)
  static constexpr bool kThreeQ = kTerms == 1;
  static constexpr int kStagesQ = kThreeQ ? 2 : kStages;
  static constexpr int kSmemQ = kResAll + kStagesQ * kStage + 1024;
  static constexpr int kMinBlocksQ = kThreeQ ? 3 : 1;
  static constexpr int kAcc = kD / 2;     // f32 of a 64 x kD sum a thread
  static constexpr int kAccV = kDv / 2;   // f32 of a 64 x kDv sum
  static constexpr int kSc = kBn / 2;     // f32 of a 64 x kBn score tile
  static_assert(kDv <= kD && kD <= 128 && kD % kBox == 0 && kDv % kBox == 0,
                "widths");
  static_assert(kStages >= 2 && kSmem <= kSmemCap && kSmemQ <= kSmemCap,
                "shared memory");
};

// Sizes of the (192, 128) instance's two-warpgroup kernels (the header),
// laid out as Cfg's, and the 64 x kBn f32 hand-off after the ring.
// Bytes of its resident tiles, of a stage of n streamed rows (q/k three
// boxes a term, v/dO two) and of the hand-off of a 64 x n tile:
constexpr int duo_res(int terms) { return terms * 5 * kRows * 128; }
constexpr int duo_stage(int terms, int n) { return terms * 5 * n * 128; }
constexpr int duo_hand(int n) { return kRows * n * 4; }
// two stages of n rows fit beside them, the 1 KB of alignment and 2 KB
// for the static barriers
constexpr bool duo_fits(int terms, int n) {
  return duo_res(terms) + 2 * duo_stage(terms, n) + duo_hand(n) + 1024 +
             2048 <= kSmemCap;
}
template <int kTerms>
struct Duo {
  static constexpr int kD = 192, kDv = 128;
  static constexpr int kBoxes = kD / kBox, kBoxesV = kDv / kBox;
  static constexpr int kResBox = kRows * 128;
  static constexpr int kResTerm = kBoxes * kResBox;
  static constexpr int kResTermV = kBoxesV * kResBox;
  static constexpr int kRes = kTerms * kResTerm;     // resident K or Q
  static constexpr int kResAll = duo_res(kTerms);
  // streamed rows: the widest that fits two stages (the header)
  static constexpr int kBn = duo_fits(kTerms, 64)   ? 64
                             : duo_fits(kTerms, 32) ? 32
                                                    : 16;
  static constexpr int kStrBox = kBn * 128;
  static constexpr int kStrTerm = kBoxes * kStrBox;
  static constexpr int kStrTermV = kBoxesV * kStrBox;
  static constexpr int kStr = kTerms * kStrTerm;     // streamed Q or K
  static constexpr int kStage = duo_stage(kTerms, kBn);
  static constexpr int kHand = duo_hand(kBn);
  static constexpr int kFit =
      (kSmemCap - 2048 - kResAll - kHand - 1024) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kResAll + kStages * kStage + kHand + 1024;
  static constexpr int kSc = kBn / 2;     // f32 of a 64 x kBn score tile
  static_assert(kResAll == kRes + kTerms * kResTermV &&
                    kStage == kStr + kTerms * kStrTermV,
                "layout");
  static_assert(kStages >= 2 && kSmem <= kSmemCap - 2048, "shared memory");
};

// The launch of the <kD, kDv, kTerms> instance, both passes: threads a
// block, streamed rows, and the stages and dynamic shared memory of the
// dK/dV and the dQ kernels (every block takes kRows rows).
// flash_attn/ops.py::flash_bwd_schedule states the same numbers, and
// flash_attn_bwd_schedule below reports these.
template <int kD, int kDv, int kTerms, bool kTwo = (kD > 128)>
struct Schedule {
  using C = Cfg<kD, kDv, kTerms>;
  static constexpr int kBlock = kThreads, kBn = C::kBn;
  static constexpr int kStages = C::kStages, kSmem = C::kSmem;
  static constexpr int kStagesQ = C::kStagesQ, kSmemQ = C::kSmemQ;
};
template <int kD, int kDv, int kTerms>
struct Schedule<kD, kDv, kTerms, true> {
  using C = Duo<kTerms>;
  static_assert(kD == C::kD && kDv == C::kDv, "widths");
  static constexpr int kBlock = kDuoThreads, kBn = C::kBn;
  static constexpr int kStages = C::kStages, kSmem = C::kSmem;
  static constexpr int kStagesQ = C::kStages, kSmemQ = C::kSmem;
};

// the gradients' type: bf16 for bf16 inputs, f32 for f32
template <int kTerms>
using Out = std::conditional_t<kTerms == 1, __nv_bfloat16, float>;

// barriers: the resident tiles, full [stage], empty [stage]
constexpr int kBarRes = 0, kBarFull = 1, kBarEmpty = 1 + kMaxStages,
              kNumBars = 1 + 2 * kMaxStages;

// d (64 x N, f32) (+)= A (64 x 16, smem) * B (N x 16, smem)^T, both
// K-major, N = 64, 32 or 16; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32
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
__device__ __forceinline__ void mma_ss(float (&d)[8], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : D8(0)
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

// sum[off + i] += d[i], each element rounded on its own (f32, round to
// nearest); off a constant once the caller's loop is unrolled
template <int kS, int kN>
__device__ __forceinline__ void promote(float (&sum)[kS],
                                        const float (&d)[kN], int off = 0) {
#pragma unroll
  for (int i = 0; i < kN; ++i) sum[off + i] = __fadd_rn(sum[off + i], d[i]);
}

// s = sum over the term pairs (a, b), a + b <= 2, of A_a B_b^T, smallest
// terms first, over a width of kW columns: A the 64-row resident tile
// (term planes kW / 64 boxes of 8 KB apart), B a streamed tile of kBn rows
// (kW / 64 boxes of kBn x 128 bytes a term), both K-major; kW / 16 k-steps
// a pair, step kk reading 32 bytes at (kk % 4) * 32 of the 128-byte rows
// of box kk / 4.  In two chains, each from zero, which the caller adds
// (the tensor cores' f32 sum loses more the longer a chain runs): sa the
// small pairs (three terms) or the first half of the k-steps (one term),
// sb the rest.  Issued, not committed.
template <int kW, int kTerms, int kBn, int kN>
__device__ __forceinline__ void issue_scores(float (&sa)[kN],
                                             float (&sb)[kN], uint32_t a,
                                             uint32_t b) {
  constexpr int kATerm = kW / kBox * kRows * 128;
  constexpr int kBBox = kBn * 128, kBTerm = kW / kBox * kBBox;
  int acc_a = 0, acc_b = 0;
#pragma unroll
  for (int o = 2; o >= 0; --o)
#pragma unroll
    for (int ta = 0; ta < kTerms; ++ta) {
      const int tb = o - ta;
      if (tb < 0 || tb >= kTerms) continue;
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da =
            desc(a + ta * kATerm + (kk / 4) * (kRows * 128) + off, 16, 1024);
        const uint64_t db =
            desc(b + tb * kBTerm + (kk / 4) * kBBox + off, 16, 1024);
        if (kTerms == 3 ? o == 0 : kk >= kW / 32) {
          mma_ss(sb, da, db, acc_b);
          acc_b = 1;
        } else {
          mma_ss(sa, da, db, acc_a);
          acc_a = 1;
        }
      }
    }
}

// part = the product X B over kN columns, X (64 x kBn) in three terms in
// registers as A (x[a][4 kk ..] the 16 columns of k-step kk), B the
// columns of a streamed tile of kBn rows from its box at b on, read
// MN-major (step kk: rows 16 kk .., 2 KB on; its columns in boxes kBn x
// 128 bytes apart, term planes term_bytes apart): over the term pairs (a,
// b), a + b <= 2, smallest first, one chain from zero (the tensor cores'
// own f32 accumulation over thousands of steps lost 4.7e-5 relative in dK
// and dV at row 6b's shape; a short chain a tile does not).  Issued, not
// committed.
template <int kN, int kTerms, int kBn>
__device__ __forceinline__ void issue_grad(float (&part)[kN / 2],
                                           const uint32_t (&x)[3][kBn / 4],
                                           uint32_t b, uint32_t term_bytes) {
  int acc = 0;
#pragma unroll
  for (int o = 2; o >= 0; --o)
#pragma unroll
    for (int ta = 0; ta < 3; ++ta) {
      const int tb = o - ta;
      if (tb < 0 || tb >= kTerms) continue;
#pragma unroll
      for (int kk = 0; kk < kBn / 16; ++kk) {
        mma_rs(part, &x[ta][4 * kk],
               desc(b + tb * term_bytes + kk * 2048, kBn * 128, 1024), acc);
        acc = 1;
      }
    }
}

// sum += the product X B over a width of kW columns (issue_grad over the
// tile's first kW / 64 boxes), committed, waited for and added to the
// running sum (promote)
template <int kW, int kTerms, int kBn>
__device__ __forceinline__ void grad_into(float (&sum)[kW / 2],
                                          const uint32_t (&x)[3][kBn / 4],
                                          uint32_t b) {
  float part[kW / 2];
  wgmma_fence();
  issue_grad<kW, kTerms, kBn>(part, x, b, kW / kBox * kBn * 128);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
  promote(sum, part);
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

// ------------------------------------- helpers of the (192, 128) instance
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P in place of the scores s of a 64 x kN tile, elements as probs, in base
// 2: P = 2^(s scale2 - lse2), scale2 = scale log2(e) and lse2 = lse log2(e)
// (each rounded once), masked elements 0; the mask is read only where the
// tile is on an edge (a ragged end or the causal diagonal)
template <int kN, bool kKeysRows>
__device__ __forceinline__ void p_tile(float (&s)[kN], const float* lse2_v,
                                       int row_a, int col0, int s_len,
                                       int t_len, int causal, float scale2,
                                       int quad, bool edge) {
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    const int li = kKeysRows ? 2 * (r / 4) + (r & 1) : (r & 2) / 2;
    const float p = ex2(__fsub_rn(__fmul_rn(s[r], scale2), lse2_v[li]));
    bool keep = true;
    if (edge) {
      const int row = row_a + ((r & 2) ? 8 : 0);
      const int col = col0 + 8 * (r / 4) + 2 * quad + (r & 1);
      const int key = kKeysRows ? row : col, qry = kKeysRows ? col : row;
      keep = qry < s_len && key < t_len && (!causal || key <= qry);
    }
    s[r] = keep ? p : 0.f;
  }
}

// split_pack's terms cut by truncation: x0 = x with its low 16 bits
// cleared, x1 the same of x - x0, x2 of x - x0 - x1 (each subtraction
// exact), so x = x0 + x1 + x2 exactly, as with rounding, in full-rate
// integer steps where split_pack takes three conversions a pair (a
// quarter-rate unit): the terms of P and dS on bf16 inputs, whose products
// take every term pair
template <int kN>
__device__ __forceinline__ void split_cut(const float (&v)[kN],
                                          uint32_t (&x)[3][kN / 2]) {
#pragma unroll
  for (int r = 0; r < kN; r += 2) {
    float a = v[r], b = v[r + 1];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const uint32_t ua = __float_as_uint(a) & 0xffff0000u;
      const uint32_t ub = __float_as_uint(b) & 0xffff0000u;
      x[t][r / 2] = __byte_perm(ua, ub, 0x7632);   // (a hi, b hi)
      if (t < 2) {
        a = __fsub_rn(a, __uint_as_float(ua));
        b = __fsub_rn(b, __uint_as_float(ub));
      }
    }
  }
}

// the terms of P or dS: cut on bf16 inputs (kTerms = 1), rounded on f32
// ones, whose three-term products drop the pairs i + j > 2 (split_pack's
// terms, as the prep kernel's)
template <int kTerms, int kN>
__device__ __forceinline__ void split_terms(const float (&v)[kN],
                                            uint32_t (&x)[3][kN / 2]) {
  if constexpr (kTerms == 1) split_cut(v, x);
  else split_pack(v, x);
}

// d (64 x 64, f32) (+)= A (64 x 16, registers) * B (64 x 16, smem)^T, B
// K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_rs_k(float (&d)[32], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// the A fragments of a resident 64 x kW bf16 tile (boxes of 64 rows x 128
// bytes, 128-byte swizzle) in the wgmma A-operand layout: k-step kk in
// f[4 kk ..], (row, col) then (row + 8, col), (row, col + 8), (row + 8, col
// + 8), row 16 warp + lane / 4, col 16 kk + 2 (lane % 4)
template <int kW>
__device__ __forceinline__ void load_afrag(uint32_t (&f)[kW / 4],
                                           const uint8_t* tile, int warp,
                                           int lane) {
  const int r0 = 16 * warp + lane / 4, q = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kW / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8;
      const int col = (kk % 4) * 16 + (i >> 1) * 8 + 2 * q;
      const int off = (kk / 4) * (kRows * 128) + row * 128 +
                      (((col / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
      f[4 * kk + i] = *reinterpret_cast<const uint32_t*>(tile + off);
    }
}

// issue_scores for one term with A from registers (f, load_afrag's) and N
// = 64: the same two chains (the halves of the k-steps), A not read from
// shared memory again each tile.  Issued, not committed.
template <int kW, int kBn>
__device__ __forceinline__ void issue_scores_rs(float (&sa)[32],
                                                float (&sb)[32],
                                                const uint32_t (&f)[kW / 4],
                                                uint32_t b) {
  static_assert(kBn == 64, "N = 64");
#pragma unroll
  for (int kk = 0; kk < kW / 16; ++kk) {
    const uint64_t db = desc(b + (kk / 4) * (kBn * 128) + (kk % 4) * 32, 16,
                             1024);
    if (kk >= kW / 32) mma_rs_k(sb, &f[4 * kk], db, kk > kW / 32);
    else mma_rs_k(sa, &f[4 * kk], db, kk > 0);
  }
}

// sum (64 x 192) += X B over the three boxes of a streamed tile at b,
// issue_grad's product in slices, two in flight, one promoted while the
// next runs: in bf16 three of 64 columns, in f32 128 + 64 (each read the
// faster of the two there)
template <int kTerms, int kBn>
__device__ __forceinline__ void grad192_into(float (&sum)[96],
                                             const uint32_t (&x)[3][kBn / 4],
                                             uint32_t b, uint32_t term_bytes) {
  constexpr uint32_t kB = kBn * 128;                 // a box
  if constexpr (kTerms == 1) {
    float pa[32], pb[32];
    wgmma_fence();
    issue_grad<64, kTerms, kBn>(pa, x, b, term_bytes);
    wgmma_commit();
    issue_grad<64, kTerms, kBn>(pb, x, b + kB, term_bytes);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(pa);
    promote(sum, pa, 0);
    wgmma_fence();
    issue_grad<64, kTerms, kBn>(pa, x, b + 2 * kB, term_bytes);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(pb);
    promote(sum, pb, 32);
    wgmma_wait<0>();
    fence_regs(pa);
    promote(sum, pa, 64);
  } else {
    float pa[64], pb[32];
    wgmma_fence();
    issue_grad<128, kTerms, kBn>(pa, x, b, term_bytes);
    wgmma_commit();
    issue_grad<64, kTerms, kBn>(pb, x, b + 2 * kB, term_bytes);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(pa);
    promote(sum, pa, 0);
    wgmma_wait<0>();
    fence_regs(pb);
    promote(sum, pb, 64);
  }
}

// This block's (batch, head) pair and row tile: the blocks of a 1-d grid
// run in groups of kGroup pairs, each group's tiles longest first, so the
// blocks in flight stream the tiles of few heads (more of them found in
// L2: two pairs a group read faster than all pairs at once)
constexpr int kGroup = 2;
struct BlockPos {
  int bh, tile;
};
__device__ __forceinline__ BlockPos block_pos(int n_bh, int n_tiles) {
  const int l = blockIdx.x;
  const int grp = l / (kGroup * n_tiles), within = l % (kGroup * n_tiles);
  const int n = min(kGroup, n_bh - grp * kGroup);
  return {grp * kGroup + within % n, within / n};
}

// one of the eight warps' release of a stage it has read (its wgmma_wait
// has returned), counted in shared memory: true for the last release of
// the tile, whose warp then refills the stage (the fences order every
// warp's reads before the count and the count before the refill)
__device__ __forceinline__ bool last_release(uint32_t* count) {
  constexpr uint32_t kWarps = kDuoThreads / 32;
  __threadfence_block();
  const bool last = atomicAdd(count, 1u) % kWarps == kWarps - 1;
  if (last) __threadfence_block();
  return last;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// scale * acc, the warpgroup's 64 x w sum, to rows row_a (+ 8) (those <
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

// D = rowsum(dO * O) over d_v, a warp a (b, s, h) row; with kTerms = 3 also
// the term planes of q (d wide) and dO (d_v wide) of that row and of k and
// v (row `row` of theirs); a lane takes columns 4 lane + 128 i
template <typename T, int kTerms>
__global__ void __launch_bounds__(kPrepThreads)
bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const T* __restrict__ dout, float* __restrict__ delta,
                __nv_bfloat16* __restrict__ q3,
                __nv_bfloat16* __restrict__ do3,
                __nv_bfloat16* __restrict__ k3,
                __nv_bfloat16* __restrict__ v3, long long rows_q,
                long long rows_kv, int s_len, int h_q, int d, int d_v) {
  const long long row = (long long)blockIdx.x * (kPrepThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row < rows_q) {                              // (b, s, h)
    float acc = 0.f;
    for (int c = 4 * lane; c < d_v; c += 128) {
      const float4 a = load4(o + row * d_v + c);
      const float4 g = load4(dout + row * d_v + c);
      acc = __fmaf_rn(a.x, g.x, acc);
      acc = __fmaf_rn(a.y, g.y, acc);
      acc = __fmaf_rn(a.z, g.z, acc);
      acc = __fmaf_rn(a.w, g.w, acc);
      if constexpr (kTerms == 3)
        split_store(g, do3 + row * d_v + c, rows_q * d_v);
    }
    if constexpr (kTerms == 3)
      for (int c = 4 * lane; c < d; c += 128)
        split_store(load4(q + row * d + c), q3 + row * d + c, rows_q * d);
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
    if (row < rows_kv) {                           // (b, t, hk)
      for (int c = 4 * lane; c < d; c += 128)
        split_store(load4(k + row * d + c), k3 + row * d + c, rows_kv * d);
      for (int c = 4 * lane; c < d_v; c += 128)
        split_store(load4(v + row * d_v + c), v3 + row * d_v + c,
                    rows_kv * d_v);
    }
  }
}

// One block a (b, kh, 64-key tile): dK and dV of those keys (header).
// Maps: K and V in 64-row boxes, Q and dO in kBn-row boxes, the term
// planes as the outer coordinate (term a of batch bb at a * b + bb).
template <int kD, int kDv, int kTerms>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_do,
                const float* __restrict__ lse,
                const float* __restrict__ delta, Out<kTerms>* __restrict__ dk,
                Out<kTerms>* __restrict__ dv, int b, int s_len, int t_len,
                int h_q, int h_kv, int d, int d_v, float scale, int causal) {
  using C = Cfg<kD, kDv, kTerms>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  // K | V | stage 0: Q, dO | stage 1 ..., each 1024-byte aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + C::kRes, str_s = base + C::kResAll;
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
    const uint32_t dst = str_s + st * C::kStage;
    mbar_expect_tx(bar(kBarFull + st), C::kStage);
    for (int a = 0; a < kTerms; ++a) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_4d(dst + a * C::kStrTerm + c * C::kStrBox, &map_q,
                    bar(kBarFull + st), c * kBox, h, q0, a * b + bb);
      for (int c = 0; c < C::kBoxesV; ++c)
        tma_load_4d(dst + C::kStr + a * C::kStrTermV + c * C::kStrBox,
                    &map_do, bar(kBarFull + st), c * kBox, h, q0, a * b + bb);
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
    mbar_expect_tx(bar(kBarRes), C::kResAll);
    for (int a = 0; a < kTerms; ++a) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_4d(k_s + a * C::kResTerm + c * C::kResBox, &map_k,
                    bar(kBarRes), c * kBox, kh, k0, a * b + bb);
      for (int c = 0; c < C::kBoxesV; ++c)
        tma_load_4d(v_s + a * C::kResTermV + c * C::kResBox, &map_v,
                    bar(kBarRes), c * kBox, kh, k0, a * b + bb);
    }
    for (int i = 0; i < min(C::kStages, n_iter); ++i) load_tiles(i);
  }

  float dk_acc[C::kAcc], dv_acc[C::kAccV];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::kAccV; ++i) dv_acc[i] = 0.f;
  const int row_a = k0 + 16 * warp + lane / 4;      // keys row_a, row_a + 8
  mbar_wait(bar(kBarRes), 0);
  for (int i = 0; i < n_iter; ++i) {
    const int st = i % C::kStages;
    const uint32_t ph = (i / C::kStages) & 1;
    const int h = kh * g_n + i / n_it, q0 = (it0 + i % n_it) * C::kBn;
    const uint32_t q_t = str_s + st * C::kStage, do_t = q_t + C::kStr;

    // S^T = K Q^T, dP^T = V dO^T (64 keys x kBn queries)
    float s[C::kSc], dp[C::kSc], s2[C::kSc], dp2[C::kSc];
    mbar_wait(bar(kBarFull + st), ph);
    wgmma_fence();
    issue_scores<kD, kTerms, C::kBn>(s, s2, k_s, q_t);
    issue_scores<kDv, kTerms, C::kBn>(dp, dp2, v_s, do_t);
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

    // dV += P^T dO, then dK += dS^T Q: P^T, then dS^T, in three terms as A
    uint32_t xt[3][C::kSc / 2];
    split_pack(s, xt);
    grad_into<kDv, kTerms, C::kBn>(dv_acc, xt, do_t);
    split_pack(dp, xt);
    grad_into<kD, kTerms, C::kBn>(dk_acc, xt, q_t);
    if (lane == 0) mbar_arrive(bar(kBarEmpty + st));   // stage free
    if (tid == 0 && i + C::kStages < n_iter) {
      mbar_wait(bar(kBarEmpty + st), ph);
      load_tiles(i + C::kStages);
    }
  }
  const long long out = (long long)bb * t_len * h_kv + kh;   // row of (bb, 0, kh)
  store_rows(dk + out * d, (long long)h_kv * d, row_a, t_len, d, quad, scale,
             dk_acc);
  store_rows(dv + out * d_v, (long long)h_kv * d_v, row_a, t_len, d_v, quad,
             1.f, dv_acc);
}

// One block a (b, h, 64-query tile): dQ of those queries (header).  Maps:
// Q and dO in 64-row boxes, K and V in kBn-row boxes.
template <int kD, int kDv, int kTerms>
__global__ void __launch_bounds__(kThreads,
                                  Cfg<kD, kDv, kTerms>::kMinBlocksQ)
bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const float* __restrict__ lse, const float* __restrict__ delta,
              Out<kTerms>* __restrict__ dq, int b, int s_len, int t_len,
              int h_q, int h_kv, int d, float scale, int causal) {
  using C = Cfg<kD, kDv, kTerms>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  // Q | dO | stage 0: K, V | stage 1 ..., each 1024-byte aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::kRes, str_s = base + C::kResAll;
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

  // thread 0: K and V of key tile j into stage j % kStagesQ
  auto load_tiles = [&](int j) {
    const int st = j % C::kStagesQ;
    const uint32_t dst = str_s + st * C::kStage;
    mbar_expect_tx(bar(kBarFull + st), C::kStage);
    for (int a = 0; a < kTerms; ++a) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_4d(dst + a * C::kStrTerm + c * C::kStrBox, &map_k,
                    bar(kBarFull + st), c * kBox, kh, j * C::kBn, a * b + bb);
      for (int c = 0; c < C::kBoxesV; ++c)
        tma_load_4d(dst + C::kStr + a * C::kStrTermV + c * C::kStrBox,
                    &map_v, bar(kBarFull + st), c * kBox, kh, j * C::kBn,
                    a * b + bb);
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
    mbar_expect_tx(bar(kBarRes), C::kResAll);
    for (int a = 0; a < kTerms; ++a) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_4d(q_s + a * C::kResTerm + c * C::kResBox, &map_q,
                    bar(kBarRes), c * kBox, h, q0, a * b + bb);
      for (int c = 0; c < C::kBoxesV; ++c)
        tma_load_4d(do_s + a * C::kResTermV + c * C::kResBox, &map_do,
                    bar(kBarRes), c * kBox, h, q0, a * b + bb);
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
    const uint32_t k_t = str_s + st * C::kStage, v_t = k_t + C::kStr;

    // S = Q K^T, dP = dO V^T (64 queries x kBn keys)
    float s[C::kSc], dp[C::kSc], s2[C::kSc], dp2[C::kSc];
    mbar_wait(bar(kBarFull + st), ph);
    wgmma_fence();
    issue_scores<kD, kTerms, C::kBn>(s, s2, q_s, k_t);
    issue_scores<kDv, kTerms, C::kBn>(dp, dp2, do_s, v_t);
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

    // dQ += dS K: dS in three terms as A, K read MN-major
    uint32_t xt[3][C::kSc / 2];
    split_pack(dp, xt);
    grad_into<kD, kTerms, C::kBn>(dq_acc, xt, k_t);
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

// The (192, 128) instance's dK/dV pass (the header): one block a (b, kh,
// 64-key tile), warpgroup 0 S^T = K Q^T, P^T and dV += P^T dO, warpgroup
// 1 dP^T = V dO^T, dS^T and dK += dS^T Q.  Maps as bwd_dkdv_kernel's; a
// 1-d grid (block_pos).
template <int kTerms>
__global__ void __launch_bounds__(kDuoThreads, 1)
bwd_dkdv_duo_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    Out<kTerms>* __restrict__ dk, Out<kTerms>* __restrict__ dv,
                    int b, int s_len, int t_len, int h_q, int h_kv, int d,
                    int d_v, float scale, int causal) {
  using C = Duo<kTerms>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  __shared__ uint32_t released[kMaxStages];
  // K | V | stage 0: Q, dO | stage 1 ... | the hand-off
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + C::kRes, str_s = base + C::kResAll;
  float* hand = reinterpret_cast<float*>(
      smem_raw + (str_s + C::kStages * C::kStage - raw));
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);   // warp-uniform
  const int t = tid % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
  const BlockPos pos = block_pos(b * h_kv, (t_len + kRows - 1) / kRows);
  const int bb = pos.bh / h_kv, kh = pos.bh % h_kv;
  const int g_n = h_q / h_kv;
  const int k0 = pos.tile * kRows;                 // key tiles, longest first
  const int n_qt = (s_len + C::kBn - 1) / C::kBn;
  const int it0 = causal ? min(k0 / C::kBn, n_qt) : 0;  // tiles reaching k0
  const int n_it = n_qt - it0;
  const int n_iter = g_n * n_it;                    // (head, query tile)

  // Q and dO of iteration i into stage i % kStages
  auto load_tiles = [&](int i) {
    const int st = i % C::kStages;
    const int h = kh * g_n + i / n_it, q0 = (it0 + i % n_it) * C::kBn;
    const uint32_t dst = str_s + st * C::kStage;
    mbar_expect_tx(bar(kBarFull + st), C::kStage);
    for (int a = 0; a < kTerms; ++a) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_4d(dst + a * C::kStrTerm + c * C::kStrBox, &map_q,
                    bar(kBarFull + st), c * kBox, h, q0, a * b + bb);
      for (int c = 0; c < C::kBoxesV; ++c)
        tma_load_4d(dst + C::kStr + a * C::kStrTermV + c * C::kStrBox,
                    &map_do, bar(kBarFull + st), c * kBox, h, q0, a * b + bb);
    }
  };
  if (tid == 0) {
    mbar_init(bar(kBarRes), 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar(kBarFull + st), 1);
      released[st] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar(kBarRes), C::kResAll);
    for (int a = 0; a < kTerms; ++a) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_4d(k_s + a * C::kResTerm + c * C::kResBox, &map_k,
                    bar(kBarRes), c * kBox, kh, k0, a * b + bb);
      for (int c = 0; c < C::kBoxesV; ++c)
        tma_load_4d(v_s + a * C::kResTermV + c * C::kResBox, &map_v,
                    bar(kBarRes), c * kBox, kh, k0, a * b + bb);
    }
    for (int i = 0; i < min(C::kStages, n_iter); ++i) load_tiles(i);
  }
  // this warp has read iteration i's stage: the last of the eight warps'
  // releases refills it with iteration i + kStages
  auto release = [&](int i) {
    if (lane == 0 && last_release(&released[i % C::kStages]) &&
        i + C::kStages < n_iter)
      load_tiles(i + C::kStages);
  };

  const int row_a = k0 + 16 * warp + lane / 4;      // keys row_a, row_a + 8
  const long long out = (long long)bb * t_len * h_kv + kh;  // (bb, 0, kh)
  mbar_wait(bar(kBarRes), 0);
  if (wg == 0) {
    // S^T, P^T (handed over), dV += P^T dO; on bf16 inputs K's A
    // fragments stay in registers, so S^T reads only Q from shared memory
    uint32_t kf[kTerms == 1 ? C::kD / 4 : 1];
    if constexpr (kTerms == 1)
      load_afrag<C::kD>(kf, smem_raw + (k_s - raw), warp, lane);
    const float scale2 = __fmul_rn(scale, kLog2e);
    float dv_acc[C::kDv / 2];
#pragma unroll
    for (int i = 0; i < C::kDv / 2; ++i) dv_acc[i] = 0.f;
    for (int i = 0; i < n_iter; ++i) {
      const int st = i % C::kStages;
      const int h = kh * g_n + i / n_it, q0 = (it0 + i % n_it) * C::kBn;
      const uint32_t q_t = str_s + st * C::kStage, do_t = q_t + C::kStr;
      float s[C::kSc], s2[C::kSc];
      mbar_wait(bar(kBarFull + st), (i / C::kStages) & 1);
      wgmma_fence();
      if constexpr (kTerms == 1)
        issue_scores_rs<C::kD, C::kBn>(s, s2, kf, q_t);
      else
        issue_scores<C::kD, kTerms, C::kBn>(s, s2, k_s, q_t);
      wgmma_commit();
      // lse of the thread's columns (queries q0 + 8 j' + 2 quad + e), in
      // base 2, while the products run
      float lse2_v[C::kBn / 4];
      const long long lrow = ((long long)bb * h_q + h) * s_len;
#pragma unroll
      for (int j = 0; j < C::kBn / 4; ++j) {
        const int qs = q0 + 8 * (j / 2) + 2 * quad + (j & 1);
        lse2_v[j] = qs < s_len ? __fmul_rn(lse[lrow + qs], kLog2e) : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(s2);
      promote(s, s2);
      const bool edge = q0 + C::kBn > s_len || k0 + kRows > t_len ||
                        (causal && k0 + kRows - 1 > q0);
      p_tile<C::kSc, true>(s, lse2_v, row_a, q0, s_len, t_len, causal,
                           scale2, quad, edge);
      if (i > 0) named_sync(2, kDuoThreads);       // P of i - 1 read
#pragma unroll
      for (int r = 0; r < C::kSc; ++r) hand[r * 128 + t] = s[r];
      named_arrive(1, kDuoThreads);                // P in
      uint32_t xt[3][C::kSc / 2];
      split_terms<kTerms>(s, xt);
      float part[C::kDv / 2];
      wgmma_fence();
      issue_grad<C::kDv, kTerms, C::kBn>(part, xt, do_t, C::kStrTermV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      promote(dv_acc, part);
      release(i);
    }
    store_rows(dv + out * d_v, (long long)h_kv * d_v, row_a, t_len, d_v, quad,
               1.f, dv_acc);
  } else {
    // dP^T, dS^T, dK += dS^T Q
    float dk_acc[C::kD / 2];
#pragma unroll
    for (int i = 0; i < C::kD / 2; ++i) dk_acc[i] = 0.f;
    for (int i = 0; i < n_iter; ++i) {
      const int st = i % C::kStages;
      const int h = kh * g_n + i / n_it, q0 = (it0 + i % n_it) * C::kBn;
      const uint32_t q_t = str_s + st * C::kStage, do_t = q_t + C::kStr;
      float dp[C::kSc], dp2[C::kSc];
      mbar_wait(bar(kBarFull + st), (i / C::kStages) & 1);
      wgmma_fence();
      issue_scores<C::kDv, kTerms, C::kBn>(dp, dp2, v_s, do_t);
      wgmma_commit();
      float dl_v[C::kBn / 4];
      const long long lrow = ((long long)bb * h_q + h) * s_len;
#pragma unroll
      for (int j = 0; j < C::kBn / 4; ++j) {
        const int qs = q0 + 8 * (j / 2) + 2 * quad + (j & 1);
        dl_v[j] = qs < s_len ? delta[lrow + qs] : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      fence_regs(dp2);
      promote(dp, dp2);
      named_sync(1, kDuoThreads);                  // P in
#pragma unroll
      for (int r = 0; r < C::kSc; ++r)
        dp[r] = __fmul_rn(hand[r * 128 + t],
                          __fsub_rn(dp[r], dl_v[2 * (r / 4) + (r & 1)]));
      if (i + 1 < n_iter) named_arrive(2, kDuoThreads);   // P read
      uint32_t xt[3][C::kSc / 2];
      split_terms<kTerms>(dp, xt);
      grad192_into<kTerms, C::kBn>(dk_acc, xt, q_t, C::kStrTerm);
      release(i);
    }
    store_rows(dk + out * d, (long long)h_kv * d, row_a, t_len, d, quad,
               scale, dk_acc);
  }
}

// The (192, 128) instance's dQ pass (the header): one block a (b, h,
// 64-query tile), warpgroup 0 S = Q K^T and P (handed over), issuing the
// next tile's S as soon as P is formed; warpgroup 1 dP = dO V^T, dS and
// dQ += dS K.  Maps as bwd_dq_kernel's; a 1-d grid (block_pos).
template <int kTerms>
__global__ void __launch_bounds__(kDuoThreads, 1)
bwd_dq_duo_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  Out<kTerms>* __restrict__ dq, int b, int s_len, int t_len,
                  int h_q, int h_kv, int d, float scale, int causal) {
  using C = Duo<kTerms>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  __shared__ uint32_t released[kMaxStages];
  // Q | dO | stage 0: K, V | stage 1 ... | the hand-off
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::kRes, str_s = base + C::kResAll;
  float* hand = reinterpret_cast<float*>(
      smem_raw + (str_s + C::kStages * C::kStage - raw));
  const uint32_t bar0 = smem_u32(bars);
  auto bar = [&](int i) { return bar0 + 8u * (uint32_t)i; };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);   // warp-uniform
  const int t = tid % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
  const int n_qt = (s_len + kRows - 1) / kRows;
  const BlockPos pos = block_pos(b * h_q, n_qt);
  const int bb = pos.bh / h_q, h = pos.bh % h_q;
  const int kh = h / (h_q / h_kv);
  const int q0 = (n_qt - 1 - pos.tile) * kRows;     // longest first
  const int q_last = min(q0 + kRows, s_len) - 1;
  const int n_kt = (t_len + C::kBn - 1) / C::kBn;
  const int n_iter = causal ? min(n_kt, q_last / C::kBn + 1) : n_kt;

  // K and V of key tile j into stage j % kStages
  auto load_tiles = [&](int j) {
    const int st = j % C::kStages;
    const uint32_t dst = str_s + st * C::kStage;
    mbar_expect_tx(bar(kBarFull + st), C::kStage);
    for (int a = 0; a < kTerms; ++a) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_4d(dst + a * C::kStrTerm + c * C::kStrBox, &map_k,
                    bar(kBarFull + st), c * kBox, kh, j * C::kBn, a * b + bb);
      for (int c = 0; c < C::kBoxesV; ++c)
        tma_load_4d(dst + C::kStr + a * C::kStrTermV + c * C::kStrBox,
                    &map_v, bar(kBarFull + st), c * kBox, kh, j * C::kBn,
                    a * b + bb);
    }
  };
  if (tid == 0) {
    mbar_init(bar(kBarRes), 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar(kBarFull + st), 1);
      released[st] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar(kBarRes), C::kResAll);
    for (int a = 0; a < kTerms; ++a) {
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_4d(q_s + a * C::kResTerm + c * C::kResBox, &map_q,
                    bar(kBarRes), c * kBox, h, q0, a * b + bb);
      for (int c = 0; c < C::kBoxesV; ++c)
        tma_load_4d(do_s + a * C::kResTermV + c * C::kResBox, &map_do,
                    bar(kBarRes), c * kBox, h, q0, a * b + bb);
    }
    for (int j = 0; j < min(C::kStages, n_iter); ++j) load_tiles(j);
  }
  auto release = [&](int j) {
    if (lane == 0 && last_release(&released[j % C::kStages]) &&
        j + C::kStages < n_iter)
      load_tiles(j + C::kStages);
  };

  const int row_a = q0 + 16 * warp + lane / 4;      // queries row_a, + 8
  const long long lrow = ((long long)bb * h_q + h) * s_len;
  mbar_wait(bar(kBarRes), 0);
  if (wg == 0) {
    // S and P (handed over); the next tile's S issued once P is formed
    float lse2_v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qs = row_a + 8 * e;
      lse2_v[e] = qs < s_len ? __fmul_rn(lse[lrow + qs], kLog2e) : 0.f;
    }
    const float scale2 = __fmul_rn(scale, kLog2e);
    float s[C::kSc], s2[C::kSc];
    mbar_wait(bar(kBarFull), 0);
    wgmma_fence();
    issue_scores<C::kD, kTerms, C::kBn>(s, s2, q_s, str_s);
    wgmma_commit();
    for (int j = 0; j < n_iter; ++j) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(s2);
      release(j);
      promote(s, s2);
      const int c0 = j * C::kBn;
      const bool edge = q0 + kRows > s_len || c0 + C::kBn > t_len ||
                        (causal && c0 + C::kBn - 1 > q0);
      p_tile<C::kSc, false>(s, lse2_v, row_a, c0, s_len, t_len, causal,
                            scale2, quad, edge);
      if (j > 0) named_sync(2, kDuoThreads);       // P of j - 1 read
#pragma unroll
      for (int r = 0; r < C::kSc; ++r) hand[r * 128 + t] = s[r];
      named_arrive(1, kDuoThreads);                // P in
      if (j + 1 < n_iter) {
        const int sn = (j + 1) % C::kStages;
        mbar_wait(bar(kBarFull + sn), ((j + 1) / C::kStages) & 1);
        wgmma_fence();
        issue_scores<C::kD, kTerms, C::kBn>(s, s2, q_s,
                                            str_s + sn * C::kStage);
        wgmma_commit();
      }
    }
  } else {
    // dP, dS, dQ += dS K
    float dl_v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qs = row_a + 8 * e;
      dl_v[e] = qs < s_len ? delta[lrow + qs] : 0.f;
    }
    float dq_acc[C::kD / 2];
#pragma unroll
    for (int i = 0; i < C::kD / 2; ++i) dq_acc[i] = 0.f;
    for (int j = 0; j < n_iter; ++j) {
      const int st = j % C::kStages;
      const uint32_t k_t = str_s + st * C::kStage, v_t = k_t + C::kStr;
      float dp[C::kSc], dp2[C::kSc];
      mbar_wait(bar(kBarFull + st), (j / C::kStages) & 1);
      wgmma_fence();
      issue_scores<C::kDv, kTerms, C::kBn>(dp, dp2, do_s, v_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
      fence_regs(dp2);
      promote(dp, dp2);
      named_sync(1, kDuoThreads);                  // P in
#pragma unroll
      for (int r = 0; r < C::kSc; ++r)
        dp[r] = __fmul_rn(hand[r * 128 + t],
                          __fsub_rn(dp[r], dl_v[(r & 2) / 2]));
      if (j + 1 < n_iter) named_arrive(2, kDuoThreads);   // P read
      uint32_t xt[3][C::kSc / 2];
      split_terms<kTerms>(dp, xt);
      grad192_into<kTerms, C::kBn>(dq_acc, xt, k_t, C::kStrTerm);
      release(j);
    }
    store_rows(dq + ((long long)bb * s_len * h_q + h) * d, (long long)h_q * d,
               row_a, s_len, d, quad, scale, dq_acc);
  }
}

// ------------------------------------------- the narrow instance, q/k <= 32
// (the header's last section).  Shared memory, from a 1024-byte aligned
// base: K's three terms (256 rows of 64 bytes each), V's, two stages (Q's
// three terms and dO's, 32 rows each), the four warpgroups' dS^T terms (64
// keys x 32 queries each), two sets of the four warpgroups' dQ partials
// (32 x 32 f32 each), and two stages' lse2 and D (32 floats each).
constexpr int kNWgs = 4;                       // warpgroups: 64 keys each
constexpr int kNThreads = kNWgs * 128;         // 512: 128 registers a thread
constexpr int kNWarps = kNThreads / 32;
constexpr int kNKeys = kNWgs * kRows;          // 256 keys resident at most
constexpr int kNQ = 32;                        // query rows a stage
constexpr int kNWidth = 32;                    // columns of every tile
constexpr int kNKTerm = kNKeys * 64;           // a term of K or V, 16 KB
constexpr int kNSlice = kRows * 64;            // a warpgroup's 64 keys of it
constexpr int kNQTerm = kNQ * 64;              // a term of a stage's Q or dO
constexpr int kNStage = 6 * kNQTerm;           // Q and dO, three terms each
constexpr int kNDsTerm = kRows * kNQ * 2;      // a term of a warpgroup's dS^T
constexpr int kNPart = kNQ * kNWidth * 4;      // a warpgroup's dQ partial
constexpr int kNOffV = 3 * kNKTerm;
constexpr int kNOffStage = 6 * kNKTerm;
constexpr int kNOffDs = kNOffStage + 2 * kNStage;
constexpr int kNOffPart = kNOffDs + kNWgs * 3 * kNDsTerm;
constexpr int kNOffRows = kNOffPart + 2 * kNWgs * kNPart;
constexpr int kNSmem = kNOffRows + 2 * 2 * kNQ * 4 + 1024;
static_assert(kNSmem + 1024 <= kSmemCap, "shared memory");

// byte offset of bf16 column c (even) of row r in a tile of 64-byte rows,
// 64-byte swizzle (16-byte chunk c / 8 ^ (r / 2) % 4, 512-byte atoms; the
// tile 512-byte aligned): the layout wgmma's SW64 descriptors read
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return r * 64 + ((((c >> 3) ^ (r >> 1)) & 3) << 4) + (c & 7) * 2;
}

// d (64 x 32, f32) (+)= A (64 x 16, registers) * B (16 x 32, smem,
// MN-major); accumulate = 0 overwrites d
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t* a,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (16 x 8, f32) += A (16 x 16, row) * B (16 x 8, col), bf16: one warp
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: lane l gives the address of row l %
// 8 of matrix l / 8
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// sum (64 x 32) += X B: X (64 keys x 32 queries, P^T or dS^T) in three terms
// in registers as A, B a stage's 32-row term tile (dO or Q) read MN-major
// (k-step kk: its rows 16 kk .., 1 KB on); over the term pairs a + b <= 2,
// smallest first, one chain from zero, committed, waited for and promoted
__device__ __forceinline__ void grad_narrow(float (&sum)[16],
                                            const uint32_t (&x)[3][8],
                                            uint32_t b) {
  float part[16];
  wgmma_fence();
  int acc = 0;
#pragma unroll
  for (int o = 2; o >= 0; --o)
#pragma unroll
    for (int ta = 0; ta <= o; ++ta) {
      const int tb = o - ta;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        mma_rs_n32(part, &x[ta][4 * kk],
                   desc_sw64(b + tb * kNQTerm + kk * 1024, kNQTerm, 512), acc);
        acc = 1;
      }
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
  promote(sum, part);
}

// S^T or dP^T of a warpgroup's 64 keys and a stage's 32 queries (A the
// keys' slice of a resident term plane, B a stage's 32-row term tile, both
// K-major, SW64): two k-steps over the six term pairs, the small pairs
// first, one chain of twelve steps from zero (two chains, as the other
// instances keep, took 32 more registers and spilled).  Issued, not
// committed.
__device__ __forceinline__ void issue_scores_narrow(float (&s)[16],
                                                    uint32_t a, uint32_t b) {
  int acc = 0;
#pragma unroll
  for (int o = 2; o >= 0; --o)
#pragma unroll
    for (int ta = 0; ta <= o; ++ta)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        mma_ss(s, desc_sw64(a + ta * kNKTerm + kk * 32, 16, 512),
               desc_sw64(b + (o - ta) * kNQTerm + kk * 32, 16, 512), acc);
        acc = 1;
      }
}

// the narrow kernel's arguments: q (b, s, h, d), k (b, t, hk, d), v (b, t,
// hk, d_v), o and dout (b, s, h, d_v) f32 at the element strides of their
// batch, row and head axes; lse (b, h, s); dq, dk, dv contiguous
struct NarrowArgs {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv;
  long long q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh;
  long long o_sb, o_sr, o_sh, g_sb, g_sr, g_sh;
  int s_len, t_len, h_q, h_kv, d, d_v, causal, n_units;
  float scale, scale2;
};

// a stage's loads: thread tid takes row tid / 16 of the stage's 32, columns
// 2 (tid % 16) and the next, of q, dO and O, and the row's lse (tid % 16
// == 0)
struct NarrowLoad {
  float2 q, g, o;
  float lse;
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One block an SM, the (batch, KV head) units in turn (the header)
__global__ void __launch_bounds__(kNThreads, 1)
bwd_narrow_kernel(const __grid_constant__ NarrowArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[4];   // full [2], dq in [2]
  uint8_t* base = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                              smem_u32(smem_raw));
  const uint32_t sb = smem_u32(base);
  const uint32_t bar0 = smem_u32(bars);
  auto full = [&](int p) { return bar0 + 8u * (uint32_t)p; };
  auto dq_in = [&](int p) { return bar0 + 8u * (uint32_t)(2 + p); };

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);   // warp-uniform
  const int t = tid % 128, warp = t / 32, quad = lane % 4;
  const int n_qt = (a.s_len + kNQ - 1) / kNQ;
  const int g_n = a.h_q / a.h_kv;
  const int n_st = g_n * n_qt;                     // stages a unit
  const int d = a.d, d_v = a.d_v;

  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      mbar_init(full(p), kNWarps);
      mbar_init(dq_in(p), kNWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // stage i of unit it into registers (zeros past the rows and columns,
  // and for a unit past the last)
  auto load_stage = [&](int it, int i) {
    NarrowLoad x{{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, 0.f};
    if (it >= a.n_units) return x;
    const int bb = it / a.h_kv, kh = it % a.h_kv;
    const int h = kh * g_n + i / n_qt, s = (i % n_qt) * kNQ + tid / 16;
    const int c = 2 * (tid % 16);
    if (s < a.s_len) {
      if (c < d) x.q = ld2(a.q + bb * a.q_sb + s * a.q_sr + h * a.q_sh + c);
      if (c < d_v) {
        x.g = ld2(a.dout + bb * a.g_sb + s * a.g_sr + h * a.g_sh + c);
        x.o = ld2(a.o + bb * a.o_sb + s * a.o_sr + h * a.o_sh + c);
      }
      if (c == 0) x.lse = a.lse[((long long)bb * a.h_q + h) * a.s_len + s];
    }
    return x;
  };
  // a stage's registers split into buffer p: Q's and dO's terms, lse2 =
  // lse log2(e) and D = rowsum(dO O) (the row's 16 threads, lanes of one
  // half-warp, summed in a fixed order); then one arrival a warp on full(p)
  auto store_stage = [&](const NarrowLoad& x, int p) {
    uint8_t* st = base + kNOffStage + p * kNStage;
    const int r = tid / 16, c = 2 * (tid % 16);
    float dl = __fadd_rn(__fmul_rn(x.g.x, x.o.x), __fmul_rn(x.g.y, x.o.y));
#pragma unroll
    for (int sh = 8; sh >= 1; sh >>= 1)
      dl = __fadd_rn(dl, __shfl_xor_sync(0xffffffffu, dl, sh));
    const float vq[2] = {x.q.x, x.q.y}, vg[2] = {x.g.x, x.g.y};
    uint32_t tq[3][1], tg[3][1];
    split_pack(vq, tq);
    split_pack(vg, tg);
#pragma unroll
    for (int tt = 0; tt < 3; ++tt) {
      *reinterpret_cast<uint32_t*>(st + tt * kNQTerm + sw64(r, c)) = tq[tt][0];
      *reinterpret_cast<uint32_t*>(st + (3 + tt) * kNQTerm + sw64(r, c)) =
          tg[tt][0];
    }
    if (c == 0) {
      float* rows = reinterpret_cast<float*>(base + kNOffRows) + p * 2 * kNQ;
      rows[r] = __fmul_rn(x.lse, kLog2e);
      rows[kNQ + r] = dl;
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(full(p));
  };
  // the warpgroup's 64 keys of unit it: K and V from device memory (thread
  // t: rows t / 8 + 16 i, columns 4 (t % 8) ..), three terms each into the
  // resident planes (zeros past t_len and the widths)
  auto load_kv = [&](int it) {
    const int bb = it / a.h_kv, kh = it % a.h_kv;
    const int c = 4 * (t % 8);
    float4 kx[4], vx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kRows * wg + t / 8 + 16 * i;
      const bool in = key < a.t_len;
      kx[i] = in && c < d ? ld4(a.k + bb * a.k_sb + key * a.k_sr +
                                kh * a.k_sh + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      vx[i] = in && c < d_v ? ld4(a.v + bb * a.v_sb + key * a.v_sr +
                                  kh * a.v_sh + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    named_sync(1 + wg, 128);        // the last unit's reads of the slice done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t / 8 + 16 * i;
      const float vk[4] = {kx[i].x, kx[i].y, kx[i].z, kx[i].w};
      const float vv[4] = {vx[i].x, vx[i].y, vx[i].z, vx[i].w};
      uint32_t tk[3][2], tv[3][2];
      split_pack(vk, tk);
      split_pack(vv, tv);
#pragma unroll
      for (int tt = 0; tt < 3; ++tt) {
        *reinterpret_cast<uint2*>(base + tt * kNKTerm + wg * kNSlice +
                                  sw64(row, c)) = make_uint2(tk[tt][0],
                                                             tk[tt][1]);
        *reinterpret_cast<uint2*>(base + kNOffV + tt * kNKTerm +
                                  wg * kNSlice + sw64(row, c)) =
            make_uint2(tv[tt][0], tv[tt][1]);
      }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);        // the slice is in
  };
  // the next unit's K and V rows of the warpgroup into L2 (thread t: row t
  // % 64 of K, t < 64, or of V), so load_kv finds them there
  auto prefetch_kv = [&](int it) {
    if (it >= a.n_units) return;
    const int bb = it / a.h_kv, kh = it % a.h_kv;
    const int key = kRows * wg + t % 64;
    if (key >= a.t_len) return;
    const float* p = t < 64 ? a.k + bb * a.k_sb + key * a.k_sr + kh * a.k_sh
                            : a.v + bb * a.v_sb + key * a.v_sr + kh * a.v_sh;
    prefetch_l2(p);
    prefetch_l2(p + (t < 64 ? d : d_v) - 1);
  };

  store_stage(load_stage(blockIdx.x, 0), 0);
  const uint32_t k_s = sb + wg * kNSlice, v_s = sb + kNOffV + wg * kNSlice;
  const uint32_t ds_s = sb + kNOffDs + wg * 3 * kNDsTerm;
  uint8_t* ds_p = base + kNOffDs + wg * 3 * kNDsTerm;
  const int rk = 16 * warp + lane / 4;             // slice rows rk, rk + 8
  int j = 0;                                       // the block's stage
  for (int it = blockIdx.x; it < a.n_units; it += gridDim.x) {
    const int bb = it / a.h_kv, kh = it % a.h_kv;
    prefetch_kv(it + gridDim.x);
    load_kv(it);
    float dk_acc[16], dv_acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    for (int i = 0; i < n_st; ++i, ++j) {
      const int p = j & 1;
      const uint32_t ph = (j >> 1) & 1;
      const int h = kh * g_n + i / n_qt, q0 = (i % n_qt) * kNQ;
      const uint32_t q_s = sb + kNOffStage + p * kNStage;
      const uint32_t g_s = q_s + 3 * kNQTerm;

      // S^T = K Q^T, dP^T = V dO^T (64 keys x 32 queries)
      float s[16], dp[16];
      mbar_wait(full(p), ph);
      wgmma_fence();
      issue_scores_narrow(s, k_s, q_s);
      issue_scores_narrow(dp, v_s, g_s);
      wgmma_commit();
      // the next stage's loads, in flight until this one's end
      const bool more = i + 1 < n_st;
      const NarrowLoad nx = load_stage(more ? it : it + gridDim.x,
                                       more ? i + 1 : 0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = 2^(S scale2 - lse2) and dS = P (dP - D) in place: element r at
      // key rk (+ 8 where r & 2), query q0 + c
      const float* rows =
          reinterpret_cast<const float*>(base + kNOffRows) + p * 2 * kNQ;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int c = 8 * (r / 4) + 2 * quad + (r & 1);
        const int key = kRows * wg + rk + ((r & 2) ? 8 : 0), qry = q0 + c;
        const bool keep = qry < a.s_len && key < a.t_len &&
                          (!a.causal || key <= qry);
        const float pr = ex2(__fsub_rn(__fmul_rn(s[r], a.scale2), rows[c]));
        s[r] = keep ? pr : 0.f;
        dp[r] = __fmul_rn(s[r], __fsub_rn(dp[r], rows[kNQ + c]));
      }

      // dV += P^T dO, dK += dS^T Q (three terms of P^T, then dS^T, as A)
      uint32_t xt[3][8];
      split_pack(s, xt);
      grad_narrow(dv_acc, xt, g_s);
      split_pack(dp, xt);
      grad_narrow(dk_acc, xt, q_s);

      // the next stage into the other buffer, now that this warpgroup has
      // read this stage's (every thread is past this stage's full barrier,
      // so every thread has read the stage before and summed its dQ)
      if (more || it + (int)gridDim.x < a.n_units) store_stage(nx, p ^ 1);

      // dS^T's terms into the warpgroup's slice (its last reads done)
      named_sync(1 + wg, 128);
#pragma unroll
      for (int tt = 0; tt < 3; ++tt)
#pragma unroll
        for (int r = 0; r < 16; r += 2)
          *reinterpret_cast<uint32_t*>(
              ds_p + tt * kNDsTerm +
              sw64(rk + ((r & 2) ? 8 : 0), 8 * (r / 4) + 2 * quad)) =
              xt[tt][r / 2];
      named_sync(1 + wg, 128);

      // the warpgroup's dQ partial over its 64 keys, dS K by mma.sync: warp
      // w the queries 16 (w & 1) .., columns 16 (w >> 1) ..; a 16-key step
      // at a time from zero, promoted
      const int mb = warp & 1, nb = warp >> 1;
      const int i8 = lane / 8, r8 = lane % 8;
      float dq_acc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        uint32_t af[3][4], bf[3][4];
#pragma unroll
        for (int tt = 0; tt < 3; ++tt) {
          ldsm_t(af[tt], ds_s + tt * kNDsTerm +
                             sw64(16 * ks + r8 + 8 * (i8 >> 1),
                                  16 * mb + 8 * (i8 & 1)));
          ldsm_t(bf[tt], k_s + tt * kNKTerm +
                             sw64(16 * ks + r8 + 8 * (i8 & 1),
                                  16 * nb + 8 * (i8 >> 1)));
        }
        float part[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int o = 2; o >= 0; --o)
#pragma unroll
          for (int ta = 0; ta <= o; ++ta)
#pragma unroll
            for (int n = 0; n < 2; ++n)
              mma16816(part[n], af[ta], bf[o - ta][2 * n],
                       bf[o - ta][2 * n + 1]);
#pragma unroll
        for (int n = 0; n < 2; ++n) promote(dq_acc[n], part[n]);
      }
      float* part_p = reinterpret_cast<float*>(base + kNOffPart) +
                      (p * kNWgs + wg) * (kNPart / 4);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int qr = 16 * mb + lane / 4, col = 16 * nb + 8 * n + 2 * quad;
        *reinterpret_cast<float2*>(part_p + qr * kNWidth + col) =
            make_float2(dq_acc[n][0], dq_acc[n][1]);
        *reinterpret_cast<float2*>(part_p + (qr + 8) * kNWidth + col) =
            make_float2(dq_acc[n][2], dq_acc[n][3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_in(p));

      // warpgroup j % 4 sums the stage's four partials in order and writes
      // dQ (thread t: query t / 4, columns 8 (t % 4) ..)
      if (wg == (j & 3)) {
        mbar_wait(dq_in(p), ph);
        const int qr = t / 4, col = 8 * (t % 4);
        const float* pp = reinterpret_cast<const float*>(base + kNOffPart) +
                          p * kNWgs * (kNPart / 4) + qr * kNWidth + col;
        float sum[8];
#pragma unroll
        for (int w = 0; w < kNWgs; ++w) {
          const float4 x0 = *reinterpret_cast<const float4*>(pp);
          const float4 x1 = *reinterpret_cast<const float4*>(pp + 4);
          const float v8[8] = {x0.x, x0.y, x0.z, x0.w,
                               x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            sum[e] = w == 0 ? v8[e] : __fadd_rn(sum[e], v8[e]);
          pp += kNPart / 4;
        }
        const int sq = q0 + qr;
        if (sq < a.s_len && col < d) {
          float* dst = a.dq + (((long long)bb * a.s_len + sq) * a.h_q + h) * d +
                       col;
          *reinterpret_cast<float4*>(dst) =
              make_float4(__fmul_rn(sum[0], a.scale), __fmul_rn(sum[1], a.scale),
                          __fmul_rn(sum[2], a.scale), __fmul_rn(sum[3], a.scale));
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(__fmul_rn(sum[4], a.scale), __fmul_rn(sum[5], a.scale),
                          __fmul_rn(sum[6], a.scale), __fmul_rn(sum[7], a.scale));
        }
      }

    }
    const long long out = (long long)bb * a.t_len * a.h_kv + kh;  // (bb, 0, kh)
    store_rows(a.dk + out * d, (long long)a.h_kv * d, kRows * wg + rk,
               a.t_len, d, quad, a.scale, dk_acc);
    store_rows(a.dv + out * d_v, (long long)a.h_kv * d_v, kRows * wg + rk,
               a.t_len, d_v, quad, 1.f, dv_acc);
  }
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

template <int kD, int kDv, int kTerms>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta,
                   __nv_bfloat16* scratch, int b, int s, int t, int h,
                   int hk, int d, int d_v, float scale, int causal,
                   cudaStream_t stream) {
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
    k3 = do3 + 3 * rows_q * d_v;
    v3 = k3 + 3 * rows_kv * d;
    qp = q3, dop = do3, kp = k3, vp = v3;
  }
  const long long rows = rows_q > rows_kv ? rows_q : rows_kv;
  const long long blocks = (rows + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  bwd_prep_kernel<In, kTerms><<<(unsigned)blocks, kPrepThreads, 0, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(k),
      static_cast<const In*>(v), static_cast<const In*>(o),
      static_cast<const In*>(dout), delta, q3, do3, k3, v3, rows_q, rows_kv,
      s, h, d, d_v);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int nb = b * kTerms;                // term a of batch bb: a * b + bb
  using P = Schedule<kD, kDv, kTerms>;
  CUtensorMap mk_r, mv_r, mq_s, mdo_s, mq_r, mdo_r, mk_s, mv_s;
  if (!make_map(&mk_r, kp, nb, t, hk, d, kRows) ||
      !make_map(&mv_r, vp, nb, t, hk, d_v, kRows) ||
      !make_map(&mq_s, qp, nb, s, h, d, P::kBn) ||
      !make_map(&mdo_s, dop, nb, s, h, d_v, P::kBn) ||
      !make_map(&mq_r, qp, nb, s, h, d, kRows) ||
      !make_map(&mdo_r, dop, nb, s, h, d_v, kRows) ||
      !make_map(&mk_s, kp, nb, t, hk, d, P::kBn) ||
      !make_map(&mv_s, vp, nb, t, hk, d_v, P::kBn))
    return cudaErrorInvalidValue;

  // the (192, 128) instance on its two-warpgroup kernels, the others on
  // the one-warpgroup ones
  const auto dkdv = [] {
    if constexpr (kD > 128) return bwd_dkdv_duo_kernel<kTerms>;
    else return bwd_dkdv_kernel<kD, kDv, kTerms>;
  }();
  const auto dqk = [] {
    if constexpr (kD > 128) return bwd_dq_duo_kernel<kTerms>;
    else return bwd_dq_kernel<kD, kDv, kTerms>;
  }();
  // grids: (pairs, tiles), or one dimension for the two-warpgroup kernels
  // (block_pos)
  const int tk = (t + kRows - 1) / kRows, tq = (s + kRows - 1) / kRows;
  const dim3 g_kv = kD > 128 ? dim3(b * hk * tk) : dim3(b * hk, tk);
  const dim3 g_q = kD > 128 ? dim3(b * h * tq) : dim3(b * h, tq);
  e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           P::kSmem);
  if (e != cudaSuccess) return e;
  dkdv<<<g_kv, P::kBlock, P::kSmem, stream>>>(
      mk_r, mv_r, mq_s, mdo_s, lse, delta, static_cast<O*>(dk),
      static_cast<O*>(dv), b, s, t, h, hk, d, d_v, scale, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           P::kSmemQ);
  if (e != cudaSuccess) return e;
  dqk<<<g_q, P::kBlock, P::kSmemQ, stream>>>(
      mq_r, mdo_r, mk_s, mv_s, lse, delta, static_cast<O*>(dq), b, s, t, h,
      hk, d, scale, causal);
  return cudaGetLastError();
}

// the narrow instance: one kernel, 512 threads, 256 keys resident, 32-row
// stages, two of them (reported for both passes)
cudaError_t launch_narrow(const NarrowArgs& args, int units,
                          cudaStream_t stream) {
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_narrow_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kNSmem);
  if (e != cudaSuccess) return e;
  bwd_narrow_kernel<<<units < sms ? units : sms, kNThreads, kNSmem, stream>>>(
      args);
  return cudaGetLastError();
}

template <int kD, int kDv, int kTerms>
void schedule(int* out) {
  using P = Schedule<kD, kDv, kTerms>;
  const int v[10] = {P::kBlock, kRows, P::kBn, P::kStages,  P::kSmem,
                     P::kBlock, kRows, P::kBn, P::kStagesQ, P::kSmemQ};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

}  // namespace

// q, dq (b, s, h, d); o, dout (b, s, h, d_v); k, dk (b, t, hk, d); v, dv
// (b, t, hk, d_v); lse and delta (b, h, s) f32, each 16-byte aligned; lse
// the forward's natural-log logsumexp, delta scratch the call overwrites.
// The instance: with terms = 3, d <= 32 and t <= 256 the narrow one (the
// header), which reads q, k, v, o and dout at the element strides of their
// batch, row and head axes (q_sb, q_sr, q_sh, ...; each a positive multiple
// of 4: views need no copy), writes dq, dk and dv contiguous in f32, and
// uses neither delta nor scratch (either may be null).  Otherwise every
// tensor is contiguous (the strides are not read) and: terms = 1: q, k, v,
// o, dout bf16, dq, dk, dv written in bf16, scratch unused; terms = 3: all
// f32, scratch 3 (b s h + b t hk) (d + d_v) bf16 for the term planes;
// (64, 64) where d and d_v are at most 64, else (128, 128) where both are
// at most 128, else (192, 128).  h % hk == 0; d and d_v multiples of 8, 8
// <= d_v <= d, and d <= 128, or d <= 192 with d_v <= 128.  Returns a
// cudaError_t.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* delta, void* scratch, int b, int s, int t,
                              int h, int hk, int d, int d_v, float scale,
                              int causal, int terms, long long q_sb,
                              long long q_sr, long long q_sh, long long k_sb,
                              long long k_sr, long long k_sh, long long v_sb,
                              long long v_sr, long long v_sh, long long o_sb,
                              long long o_sr, long long o_sh, long long g_sb,
                              long long g_sr, long long g_sh, void* stream) {
  const bool narrow = terms == 3 && d <= kNWidth && t <= kNKeys;
  if (b < 1 || s < 1 || t < 1 || hk < 1 || h % hk || d_v < 8 || d % 8 ||
      d_v % 8 || d_v > d || d > 192 || (d > 128 && d_v > 128) ||
      (terms != 1 && terms != 3) ||
      (terms == 3 && !narrow && scratch == nullptr) ||
      (long long)b * h > 0x7fffffffLL || (long long)b * terms > 0x7fffffffLL ||
      (s + kRows - 1) / kRows > 65535 || (t + kRows - 1) / kRows > 65535 ||
      (long long)b * h * ((s + kRows - 1) / kRows) > 0x7fffffffLL ||
      (long long)b * hk * ((t + kRows - 1) / kRows) > 0x7fffffffLL ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
        reinterpret_cast<uintptr_t>(scratch)) &
       15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  if (narrow) {
    const long long strides[15] = {q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb,
                                   v_sr, v_sh, o_sb, o_sr, o_sh, g_sb, g_sr,
                                   g_sh};
    for (long long x : strides)
      if (x <= 0 || x % 4) return (int)cudaErrorInvalidValue;
    NarrowArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(o),
                 static_cast<const float*>(dout), ls, static_cast<float*>(dq),
                 static_cast<float*>(dk), static_cast<float*>(dv),
                 q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh,
                 o_sb, o_sr, o_sh, g_sb, g_sr, g_sh,
                 s, t, h, hk, d, d_v, causal, b * hk, scale, scale * kLog2e};
    return (int)launch_narrow(a, b * hk, st);
  }
  float* dl = static_cast<float*>(delta);
  __nv_bfloat16* sc = static_cast<__nv_bfloat16*>(scratch);
#define FLASH_BWD_LAUNCH(D, DV, TERMS)                                       \
  launch<D, DV, TERMS>(q, k, v, o, dout, ls, dq, dk, dv, dl, sc, b, s, t, h, \
                       hk, d, d_v, scale, causal, st)
  const int inst = d <= 64 ? 0 : d <= 128 ? 1 : 2;
  if (terms == 1)
    return (int)(inst == 0   ? FLASH_BWD_LAUNCH(64, 64, 1)
                 : inst == 1 ? FLASH_BWD_LAUNCH(128, 128, 1)
                             : FLASH_BWD_LAUNCH(192, 128, 1));
  return (int)(inst == 0   ? FLASH_BWD_LAUNCH(64, 64, 3)
               : inst == 1 ? FLASH_BWD_LAUNCH(128, 128, 3)
                           : FLASH_BWD_LAUNCH(192, 128, 3));
#undef FLASH_BWD_LAUNCH
}

// The launch of instance (kd, kdv) with `terms` terms into out[0..10):
// for the dK/dV kernel, then the dQ kernel, threads a block, rows a
// block, streamed rows, stages, dynamic shared-memory bytes (what
// ops.py::flash_bwd_schedule states); the narrow instance (32, 32), one
// kernel in three terms, reports its launch for both.  Returns a
// cudaError_t: invalid for an instance or a term count the kernel does not
// have.
extern "C" int flash_attn_bwd_schedule(int kd, int kdv, int terms,
                                       int* out) {
  if (terms != 1 && terms != 3) return (int)cudaErrorInvalidValue;
  const bool one = terms == 1;
  if (kd == kNWidth && kdv == kNWidth && !one) {
    const int v[5] = {kNThreads, kNKeys, kNQ, 2, kNSmem};
    for (int i = 0; i < 10; ++i) out[i] = v[i % 5];
  } else if (kd == 64 && kdv == 64)
    one ? schedule<64, 64, 1>(out) : schedule<64, 64, 3>(out);
  else if (kd == 128 && kdv == 128)
    one ? schedule<128, 128, 1>(out) : schedule<128, 128, 3>(out);
  else if (kd == 192 && kdv == 128)
    one ? schedule<192, 128, 1>(out) : schedule<192, 128, 3>(out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}
