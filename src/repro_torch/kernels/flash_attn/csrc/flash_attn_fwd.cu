// GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/flash_attn.py::
// flash_attention_fwd (_flash_kernel).  q (B, S, H, dh), k and v
// (B, T, Hk, dh), f32 or bf16, give o (B, S, H, dh) in q's type:
//     o[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h / G]) v[b, t, h / G]
// with G = H / Hk query heads per KV head (no KV copy per query head).
// Like the TPU kernel: q is scaled in f32 before the product; the running
// max starts at -1e30 and causally masked scores (k_pos > q_pos, positions
// aligned at the top left even when S != T) are set to -1e30; the running
// (m, l, acc) are f32 and rescaled by exp(m_prev - m_new) for every KV
// tile; the output is acc / max(l, 1e-30); KV tiles wholly above the
// diagonal are skipped.  Keys past T (the ragged last tile) score -inf and
// weigh exactly 0.
//
// What bounds it on an H100 SXM: operations.  At Qwen3-0.6B's S, T, H
// and Hk (H = 16, Hk = 8), B = 1, S = T = 4096, causal, at dh = 256 (a
// width no model of the repo has; the smoke's full-width call) the two
// products are 4*S*T*dh*H/2 = 137.4 GFLOP: 0.833 ms in 3xTF32 on the
// tensor cores (three TF32 products at 495 TFLOP/s, the card's fastest
// form exact in f32), 2.05 ms at the f32 CUDA-core rate (67 TFLOP/s) this
// form uses; its bytes (q, k, v, o: 201 MB in f32) take 0.06 ms.  Head
// widths up to 128 whose rows lie on TMA's 16-byte stride (f32 dh % 4 ==
// 0, bf16 dh % 8 == 0) run on the tensor cores instead
// (flash_attn/ops.py::flash_kernel): bf16 on flash_attn_fwd_wgmma.cu, f32
// in 3xTF32 on flash_attn_fwd_tf32.cu.  This kernel serves every other
// head width, 1 <= dh <= 256, in f32 and bf16.
//
// Design: the TPU grid (B, Hk, G, S/bq, T/bk) walks KV blocks in order on
// one core and carries (m, l, acc) in VMEM between grid steps.  Hopper
// blocks run in parallel, so one block owns one (q tile, b, kv head,
// group) and loops over the KV tiles itself, keeping (m, l, acc) in
// registers.  Blocks are ordered with the longest causal q tiles first.
// Tiles are 64 queries x 64 keys; 256 threads as a 16 x 16 grid (ty, tx).
// Shared memory holds the scaled q tile, one KV tile (first K, then V
// over the same space) and the P tile, all f32, rows of dh rounded up to a
// multiple of 4 (the columns past dh zero, so float4 reads take any dh)
// and padded by 4 floats: 85 KB at dh = 128, two blocks an SM; 147 KB at
// dh = 256, one.  Thread (ty, tx) computes scores for rows ty + 16i and
// keys tx + 16j (i, j < 4), so the 16 threads of a row reduce its max and
// sum with warp shuffles, and the float4 reads of K rows fall in distinct
// banks; it accumulates output rows ty + 16i, columns 4tx + 64r .. + 3
// (r < kR: 2 up to dh = 128, 4 up to 256, 64 sums a thread, which is why
// the wider instance asks for one block an SM).  The inner products are
// __fmaf_rn chains over the head dimension, softmax uses expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // queries per tile
constexpr int kBKV = 64;          // keys per tile
constexpr int kMaxDh = 256;
constexpr int kLdp = kBKV + 4;    // padded row of the P tile
constexpr float kNegInf = -1e30f; // the TPU kernel's _NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// rows [t0, t0 + kBKV) of one head of a (B, T, Hk, dh) tensor into dst
// (rows of ld floats), columns dh .. dh4 - 1 (dh rounded up to 4) and rows
// past t_len as zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int t0,
                                          int t_len, int dh, int dh4) {
  for (int e = threadIdx.x; e < kBKV * dh4; e += kThreads) {
    const int r = e / dh4, c = e - r * dh4;
    const int t = t0 + r;
    dst[r * ld + c] =
        t < t_len && c < dh ? to_f32(src[t * row_stride + c]) : 0.f;
  }
}

// kR: 64-column groups of the output a thread accumulates (dh <= 64 kR)
template <typename T, int kR>
__global__ void __launch_bounds__(kThreads, kR <= 2 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s_len,
                 int t_len, int h_q, int h_kv, int dh, float scale,
                 int causal) {
  extern __shared__ __align__(16) float smem[];
  const int dh4 = (dh + 3) & ~3;
  const int ld = dh4 + 4;
  float* qs = smem;                 // kBQ x ld
  float* kvs = qs + kBQ * ld;       // kBKV x ld
  float* ps = kvs + kBKV * ld;      // kBQ x kLdp

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int group = h_q / h_kv;
  const int n_qt = (s_len + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int g = blockIdx.y;
  const int bb = blockIdx.z / h_kv, kh = blockIdx.z % h_kv;
  const int h = kh * group + g;

  const long long q_stride = (long long)h_q * dh;     // between positions
  const long long kv_stride = (long long)h_kv * dh;
  const T* qb = q + ((long long)bb * s_len * h_q + h) * dh;
  const T* kb = k + ((long long)bb * t_len * h_kv + kh) * dh;
  const T* vb = v + ((long long)bb * t_len * h_kv + kh) * dh;
  T* ob = o + ((long long)bb * s_len * h_q + h) * dh;

  for (int e = tid; e < kBQ * dh4; e += kThreads) {
    const int r = e / dh4, c = e - r * dh4;
    const int sp = q0 + r;
    qs[r * ld + c] = sp < s_len && c < dh
                         ? __fmul_rn(to_f32(qb[sp * q_stride + c]), scale)
                         : 0.f;
  }

  float m_r[4], l_r[4], acc[4][4 * kR];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kR; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query are masked for every row
  const int kv_end = causal ? min(t_len, q0 + kBQ) : t_len;
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();                      // kvs and ps free again
    load_tile(kvs, ld, kb, kv_stride, k0, t_len, dh, dh4);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < dh4; c += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * ld + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&kvs[(tx + 16 * j) * ld + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = __fmaf_rn(qa[i].x, ka[j].x, sc[i][j]);
          x = __fmaf_rn(qa[i].y, ka[j].y, x);
          x = __fmaf_rn(qa[i].z, ka[j].z, x);
          sc[i][j] = __fmaf_rn(qa[i].w, ka[j].w, x);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= t_len) sc[i][j] = -INFINITY;
        else if (causal && kp > qp) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_r[i], row_max(mx));
      const float corr = expf(__fsub_rn(m_r[i], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(sc[i][j], m_new));
        sum = __fadd_rn(sum, p);
        ps[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
      }
      l_r[i] = __fadd_rn(__fmul_rn(l_r[i], corr), row_sum(sum));
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kR; ++c)
        acc[i][c] = __fmul_rn(acc[i][c], corr);
    }
    __syncthreads();                      // K done, P written
    load_tile(kvs, ld, vb, kv_stride, k0, t_len, dh, dh4);
    __syncthreads();

    for (int j = 0; j < kBKV; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * kLdp + j]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = &kvs[(j + u) * ld];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int c = 64 * r + 4 * tx;
          if (c >= dh) continue;
          const float4 vv = *reinterpret_cast<const float4*>(&vrow[c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                          : u == 2 ? pa[i].z : pa[i].w;
            acc[i][4 * r + 0] = __fmaf_rn(p, vv.x, acc[i][4 * r + 0]);
            acc[i][4 * r + 1] = __fmaf_rn(p, vv.y, acc[i][4 * r + 1]);
            acc[i][4 * r + 2] = __fmaf_rn(p, vv.z, acc[i][4 * r + 2]);
            acc[i][4 * r + 3] = __fmaf_rn(p, vv.w, acc[i][4 * r + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sp = q0 + ty + 16 * i;
    if (sp >= s_len) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);
    T* orow = ob + sp * q_stride;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int c = 64 * r + 4 * tx;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < dh)
          orow[c + e] = from_f32<T>(__fdiv_rn(acc[i][4 * r + e], denom));
    }
  }
}

template <typename T, int kR>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int t, int h, int hk, int dh, float scale,
                   int causal, cudaStream_t stream) {
  const int ld = ((dh + 3) & ~3) + 4;
  const int smem = ((kBQ + kBKV) * ld + kBQ * kLdp) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s + kBQ - 1) / kBQ, h / hk, b * hk);
  flash_fwd_kernel<T, kR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, t, h, hk, dh, scale,
      causal);
  return cudaGetLastError();
}

// the instance of 64-column groups kR that covers dh
template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      int b, int s, int t, int h, int hk, int dh, float scale,
                      int causal, cudaStream_t stream) {
  return dh <= 128 ? launch<T, 2>(q, k, v, o, b, s, t, h, hk, dh, scale,
                                  causal, stream)
                   : launch<T, 4>(q, k, v, o, b, s, t, h, hk, dh, scale,
                                  causal, stream);
}

}  // namespace

// q (b, s, h, dh), k and v (b, t, hk, dh), o (b, s, h, dh), contiguous,
// all f32 (bf16 = 0) or all bf16 (bf16 = 1); h % hk == 0, 1 <= dh <= 256.
// Returns a cudaError_t.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int b, int s, int t, int h, int hk,
                              int dh, int bf16, float scale, int causal,
                              void* stream) {
  if (b < 1 || s < 1 || t < 1 || hk < 1 || h % hk || dh < 1 ||
      dh > kMaxDh || b * hk > 65535 || h / hk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, b, s, t, h, hk,
                                               dh, scale, causal, st)
                    : launch_dh<float>(q, k, v, o, b, s, t, h, hk, dh, scale,
                                       causal, st));
}
