// GQA flash-attention forward on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/flash_attn.py::
// flash_attention_fwd (_flash_kernel) for bf16 inputs with dh in {64, 128}
// (flash_attn/ops.py::flash_kernel routes f32 and other head widths to
// flash_attn_fwd.cu).  q (B, S, H, dh), k and v (B, T, Hk, dh) give
// o (B, S, H, dh):
//     o[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h / G]) v[b, t, h / G]
// with G = H / Hk query heads per KV head (no KV copy per query head).
// The TPU kernel's semantics, as flash_attn_fwd.cu states them: causal
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
// Design: one block owns 128 query rows of one (batch, query head):
// two consumer warpgroups of 64 rows each and one producer warp.  The
// producer issues TMA loads (tensor maps built on the host with
// cuTensorMapEncodeTiled, 128-byte swizzle, 64-column boxes) of the q tile
// once and of 128-key K and V tiles into a two-stage ring, each stage with
// full barriers (K and V apart, transaction bytes) and an empty barrier
// that the eight consumer warps arrive on.  Each consumer warpgroup
// computes S = Q K^T with wgmma.mma_async m64n128k16 (Q and K both K-major
// in swizzled shared memory), keeps the online softmax on the f32
// accumulator fragments in registers (quad shuffles for the row max, a
// per-thread partial row sum reduced once at the end), converts P to bf16
// in registers, where the accumulator layout of S is the A-operand layout
// of the next product, and computes O += P V with the register-A form of
// wgmma, V read as a transposed (MN-major) B operand from the same
// swizzled tiles.  P never touches shared memory.  While one warpgroup
// runs its softmax the other's products keep the tensor cores busy.
// Blocks are ordered with the longest causal q tiles first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;              // query rows per block
constexpr int kBKV = 128;             // keys per KV tile
constexpr int kStages = 2;            // KV ring depth
constexpr int kConsumerThreads = 256; // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;   // + one producer warp
constexpr int kBox = 64;              // bf16 columns per 128-byte TMA box
constexpr int kBoxBytes = 128 * kBox * 2;         // 128 rows x 128 B
constexpr float kNegInf = -1e30f;     // the TPU kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// barriers: q, full K [stage], full V [stage], empty [stage]
constexpr int kBarQ = 0, kBarK = 1, kBarV = 1 + kStages,
              kBarEmpty = 1 + 2 * kStages, kNumBars = 1 + 3 * kStages;

// d (64 x 128, f32) (+)= A (64 x 16, smem) * B (128 x 16, smem)^T, both
// K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, registers) * B (16 x N, smem, MN-major)
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a,
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
template <int kDh>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, int s_len, int t_len,
                       int h_q, int h_kv, float scale_log2, int causal) {
  constexpr int kHalves = kDh / kBox;               // boxes per row
  constexpr int kTileBytes = kHalves * kBoxBytes;   // one q, K or V tile
  constexpr int kDv = kDh / 2;                      // O registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];
  // tiles: q | K[0] K[1] | V[0] V[1], each 1024-byte aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kTileBytes;
  const uint32_t v_s = k_s + kStages * kTileBytes;
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

  if (tid == 0) {
    mbar_init(bar(kBarQ), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar(kBarK + st), 1);
      mbar_init(bar(kBarV + st), 1);
      mbar_init(bar(kBarEmpty + st), kConsumerThreads / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {                     // producer warp
    if (tid == kConsumerThreads) {
      mbar_expect_tx(bar(kBarQ), kTileBytes);
      for (int c = 0; c < kHalves; ++c)
        tma_load_4d(q_s + c * kBoxBytes, &map_q, bar(kBarQ), c * kBox, h,
                    q0, bb);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kStages;
        if (j >= kStages)
          mbar_wait(bar(kBarEmpty + st), ((j / kStages) - 1) & 1);
        const uint32_t kd = k_s + st * kTileBytes, vd = v_s + st * kTileBytes;
        mbar_expect_tx(bar(kBarK + st), kTileBytes);
        for (int c = 0; c < kHalves; ++c)
          tma_load_4d(kd + c * kBoxBytes, &map_k, bar(kBarK + st),
                      c * kBox, kh, j * kBKV, bb);
        mbar_expect_tx(bar(kBarV + st), kTileBytes);
        for (int c = 0; c < kHalves; ++c)
          tma_load_4d(vd + c * kBoxBytes, &map_v, bar(kBarV + st),
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
  float o_acc[kDv];
#pragma unroll
  for (int i = 0; i < kDv; ++i) o_acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  mbar_wait(bar(kBarQ), 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const uint32_t kt = k_s + st * kTileBytes, vt = v_s + st * kTileBytes;

    // S = Q K^T: dh / 16 steps of k16; step kk reads 32 bytes at
    // (kk % 4) * 32 of the 128-byte rows of box kk / 4
    float s[64];
    mbar_wait(bar(kBarK + st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      mma_ss_n128(s, desc(q_s + off + wg * 64 * 128, 16, 1024),
                  desc(kt + off, 16, 1024), kk > 0);
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
    for (int r = 0; r < 64; ++r) {
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
    uint32_t p[32];
#pragma unroll
    for (int r = 0; r < 64; r += 2) {
      const float mr = (r & 2) ? mn_b : mn_a;
      const float p0 = ex2(s[r] - mr), p1 = ex2(s[r + 1] - mr);
      if (r & 2) sum_b += p0 + p1;
      else sum_a += p0 + p1;
      p[r / 2] = pack_bf16(p0, p1);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int r = 0; r < kDv; ++r) o_acc[r] *= (r & 2) ? corr_b : corr_a;

    // O += P V: kBKV / 16 steps; step kk takes the four registers of P
    // that hold keys 16 kk .. 16 kk + 15 and V rows 16 kk .. (2 KB on)
    mbar_wait(bar(kBarV + st), ph);
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      const uint64_t dv = desc(vt + kk * 2048, kBoxBytes, 1024);
      if constexpr (kDh == 128) mma_rs_n128(o_acc, &p[4 * kk], dv);
      else mma_rs_n64(o_acc, &p[4 * kk], dv);
    }
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
  const long long row_stride = (long long)h_q * kDh;
  __nv_bfloat16* ob = o + ((long long)bb * s_len * h_q + h) * kDh;
#pragma unroll
  for (int r = 0; r < kDv; r += 2) {
    const int row = row_a + ((r & 2) ? 8 : 0);
    if (row >= s_len) continue;
    const float inv = (r & 2) ? inv_b : inv_a;
    const int col = 8 * (r / 4) + 2 * quad;
    *reinterpret_cast<__nv_bfloat162*>(ob + row * row_stride + col) =
        __floats2bfloat162_rn(o_acc[r] * inv, o_acc[r + 1] * inv);
  }
}

// ------------------------------------------------------------------ host
// (batch, len, heads, dh) bf16, 64-column x rows boxes, 128-byte swizzle;
// rows past len read as zeros
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

template <int kDh>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int t, int h, int hk, float scale,
                   int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, s, h, kDh, kBQ) ||
      !make_map(&mk, k, b, t, hk, kDh, kBKV) ||
      !make_map(&mv, v, b, t, hk, kDh, kBKV))
    return cudaErrorInvalidValue;
  const int smem = (1 + 2 * kStages) * (kDh / kBox) * kBoxBytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<kDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  flash_fwd_wgmma_kernel<kDh><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, t, h, hk,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// q (b, s, h, dh), k and v (b, t, hk, dh), o (b, s, h, dh), contiguous
// bf16, each 16-byte aligned; h % hk == 0, dh 64 or 128.  Returns a
// cudaError_t.
extern "C" int flash_attn_fwd_wgmma(const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int t, int h, int hk, int dh, float scale,
                                    int causal, void* stream) {
  if (b < 1 || s < 1 || t < 1 || hk < 1 || h % hk || (dh != 64 && dh != 128)
      || (long long)b * h > 0x7fffffffLL || (s + kBQ - 1) / kBQ > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dh == 128 ? launch<128>(q, k, v, o, b, s, t, h, hk, scale,
                                       causal, st)
                         : launch<64>(q, k, v, o, b, s, t, h, hk, scale,
                                      causal, st));
}
