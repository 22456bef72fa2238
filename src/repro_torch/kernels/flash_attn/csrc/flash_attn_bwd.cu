// GQA flash-attention backward (the VJP) on Hopper's CUDA cores, f32.
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
// t <= s), q at offset 0.  q, k, v, o and dO are f32 (the wrapper converts
// bf16 and other dtypes, as the reference computes its backward in f32),
// one width d = dh = dv <= 128, d % 4 == 0 (the wrapper pads other widths
// with zero columns, which give zero gradient columns, cut off after).
//
// What bounds it on an H100 SXM: operations.  At Qwen3-0.6B's attention
// widths (H 16, Hk 8, dh 128), B = 1, S = T = 4096, causal, the five
// products (S and dP recomputed once, dV, dK, dQ) are 171.8 GFLOP: 1.04 ms
// as 3xTF32 at 495 TFLOP/s (0.174 ms in bf16 at 989); its bytes (q, k, v,
// o, dO, lse read once, dq, dk, dv written once: 168 MB) take 0.05 ms.
// This first kernel runs on the f32 CUDA cores (67 TFLOP/s: 2.56 ms at
// best for those five products) and recomputes S and dP in both passes
// (seven products, 240.5 GFLOP, 3.59 ms at that rate); the tensor cores
// (wgmma, TMA) and one recompute are later work (ROADMAP queue 2).
//
// Three kernels, no atomics, so a gradient is the same bit for bit from
// run to run; every sum runs in a fixed order, each multiply-add written
// as __fmaf_rn (the build passes -fmad=false):
//   * bwd_delta_kernel: D, one warp a (b, s, h) row, a float4 a lane;
//   * bwd_dkdv_kernel: one block a (b, kh, 64-key tile); K and V tiles stay
//     in shared memory while the block loops over the G query heads and
//     the 64-row query tiles that reach its keys (causally: from the tile
//     of its first key on), recomputing S = Q K^T and dP = dO V^T, then P
//     and dS, which go through shared memory to dV += P^T dO and dK +=
//     dS^T Q, accumulated in registers;
//   * bwd_dq_kernel: one block a (b, h, 64-row query tile); Q and dO stay
//     in shared memory while it loops over the key tiles up to the diagonal,
//     recomputing S, dP, P and dS (transposed into shared memory) for dQ +=
//     dS K.
// 256 threads a block.  The score tiles (64 x 64) give each thread 4 x 4
// elements, rows ty + 16 i and columns tx + 16 j (ty = tid / 16, tx = tid
// % 16), so its K (or V) rows are read as float4s along d from rows whose
// 132-float (or 68-float) strides put 8 neighbouring threads in distinct
// banks; the output tiles (64 x kD) give each thread 4 rows, 4 tx .. 4 tx
// + 3 (one float4 of a P or dS row), and kD / 16 columns, 4 ty + 64 hh ..
// + 3.  Blocks run longest first (the key tiles nearest the top, the query
// tiles nearest the bottom).  Shared memory at kD = 128: 166.5 KB (dK, dV)
// and 149.5 KB (dQ), one block an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;                 // rows of a query or key tile
constexpr int kThreads = 256;
constexpr int kPLd = kB + 4;           // row stride of a P or dS tile

template <int kD>
struct Cfg {
  static constexpr int kLd = kD + 4;          // row stride of a q/k/v tile
  static constexpr int kNc = kD / 16;         // output columns a thread
  static constexpr int kTile = kB * kLd;      // floats of a q/k/v tile
};

// rows [row0, row0 + kB) of one head of a (b, len, heads, d) tensor into a
// tile of kD columns: rows past n_rows and columns past d as zeros
template <int kD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          long long row_stride, int n_rows,
                                          int d) {
  constexpr int kC4 = kD / 4;
  for (int i = threadIdx.x; i < kB * kC4; i += kThreads) {
    const int r = i / kC4, c = 4 * (i % kC4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && c < d)
      x = *reinterpret_cast<const float4*>(src + r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * Cfg<kD>::kLd + c) = x;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] b[tx + 16 j][d] over two tiles
template <int kD>
__device__ __forceinline__ void score_tile(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int ty, int tx,
                                           float (&acc)[4][4]) {
  constexpr int kLd = Cfg<kD>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 a4[4], b4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a4[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b4[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = __fmaf_rn(a4[i].x, b4[j].x, s);
        s = __fmaf_rn(a4[i].y, b4[j].y, s);
        s = __fmaf_rn(a4[i].z, b4[j].z, s);
        s = __fmaf_rn(a4[i].w, b4[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[j][e] += sum_r p[r][4 tx + j] x[r][col(e)], col(e) = 4 ty + 64 (e /
// 4) + e % 4: the thread's rows of P^T X (p a kB x kB tile of stride kPLd,
// x a kB x kD tile)
template <int kD>
__device__ __forceinline__ void acc_tile(const float* __restrict__ p,
                                         const float* __restrict__ x,
                                         int ty, int tx,
                                         float (&acc)[4][Cfg<kD>::kNc]) {
  constexpr int kLd = Cfg<kD>::kLd, kNc = Cfg<kD>::kNc;
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    const float4 p4 = *reinterpret_cast<const float4*>(p + r * kPLd + 4 * tx);
    const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
    float xv[kNc];
#pragma unroll
    for (int hh = 0; hh < kNc / 4; ++hh) {
      const float4 x4 =
          *reinterpret_cast<const float4*>(x + r * kLd + 4 * ty + 64 * hh);
      xv[4 * hh] = x4.x;
      xv[4 * hh + 1] = x4.y;
      xv[4 * hh + 2] = x4.z;
      xv[4 * hh + 3] = x4.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < kNc; ++e) acc[j][e] = __fmaf_rn(pv[j], xv[e], acc[j][e]);
  }
}

// rows row0 + 4 tx + j (< n_rows) of one head: scale * acc, columns < d
template <int kD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           long long row_stride, int n_rows,
                                           int d, int ty, int tx, float scale,
                                           const float (&acc)[4][Cfg<kD>::kNc]) {
  constexpr int kNc = Cfg<kD>::kNc;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * tx + j;
    if (r >= n_rows) continue;
#pragma unroll
    for (int hh = 0; hh < kNc / 4; ++hh) {
      const int c = 4 * ty + 64 * hh;
      if (c >= d) continue;
      *reinterpret_cast<float4*>(dst + r * row_stride + c) = make_float4(
          __fmul_rn(acc[j][4 * hh], scale), __fmul_rn(acc[j][4 * hh + 1], scale),
          __fmul_rn(acc[j][4 * hh + 2], scale),
          __fmul_rn(acc[j][4 * hh + 3], scale));
    }
  }
}

// P and dS of the thread's 4 x 4 scores at rows q0 + ty + 16 i, keys k0 +
// tx + 16 j, from S (unscaled q . k), dP and the rows' lse and D
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* __restrict__ lse_s,
                                      const float* __restrict__ dl_s, int q0,
                                      int k0, int s_len, int t_len, int causal,
                                      float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty + 16 * i, rg = q0 + rl;
    const float lse = lse_s[rl], dl = dl_s[rl];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cg = k0 + tx + 16 * j;
      const bool keep = rg < s_len && cg < t_len && (!causal || cg <= rg);
      const float p =
          keep ? expf(__fsub_rn(__fmul_rn(s[i][j], scale), lse)) : 0.f;
      s[i][j] = p;
      dp[i][j] = __fmul_rn(p, __fsub_rn(dp[i][j], dl));
    }
  }
}

// ------------------------------------------------------------- kernels
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, long long n_rows, int s_len,
                 int h_q, int d) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;          // (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  float acc = 0.f;
  if (4 * lane < d) {
    const float4 a = *reinterpret_cast<const float4*>(o + row * d + 4 * lane);
    const float4 g =
        *reinterpret_cast<const float4*>(dout + row * d + 4 * lane);
    acc = __fmaf_rn(a.x, g.x, acc);
    acc = __fmaf_rn(a.y, g.y, acc);
    acc = __fmaf_rn(a.z, g.z, acc);
    acc = __fmaf_rn(a.w, g.w, acc);
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

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int s_len,
                int t_len, int h_q, int h_kv, int d, float scale, int causal) {
  using C = Cfg<kD>;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + C::kTile;
  float* q_s = v_s + C::kTile;
  float* do_s = q_s + C::kTile;
  float* p_s = do_s + C::kTile;
  float* ds_s = p_s + kB * kPLd;
  float* lse_s = ds_s + kB * kPLd;
  float* dl_s = lse_s + kB;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bb = blockIdx.x / h_kv, kh = blockIdx.x % h_kv;
  const int g_n = h_q / h_kv;
  const int k0 = blockIdx.y * kB;                // key tiles, longest first
  const int n_keys = min(kB, t_len - k0);
  const long long kv_stride = (long long)h_kv * d, q_stride = (long long)h_q * d;
  load_tile<kD>(k_s, k + ((long long)bb * t_len + k0) * kv_stride + kh * d,
                kv_stride, n_keys, d);
  load_tile<kD>(v_s, v + ((long long)bb * t_len + k0) * kv_stride + kh * d,
                kv_stride, n_keys, d);

  float acc_k[4][C::kNc], acc_v[4][C::kNc];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < C::kNc; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  const int n_qt = (s_len + kB - 1) / kB;
  const int it0 = causal ? k0 / kB : 0;          // query tiles reaching k0
  for (int g = 0; g < g_n; ++g) {
    const int h = kh * g_n + g;
    for (int it = it0; it < n_qt; ++it) {
      const int q0 = it * kB, n_q = min(kB, s_len - q0);
      __syncthreads();                           // the last tile is read
      const long long off = ((long long)bb * s_len + q0) * q_stride + h * d;
      load_tile<kD>(q_s, q + off, q_stride, n_q, d);
      load_tile<kD>(do_s, dout + off, q_stride, n_q, d);
      if (tid < kB) {
        const long long row = ((long long)bb * h_q + h) * s_len + q0 + tid;
        lse_s[tid] = tid < n_q ? lse[row] : 0.f;
        dl_s[tid] = tid < n_q ? delta[row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      score_tile<kD>(q_s, k_s, ty, tx, s);
      score_tile<kD>(do_s, v_s, ty, tx, dp);
      probs(s, dp, lse_s, dl_s, q0, k0, s_len, t_len, causal, scale, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_s[(ty + 16 * i) * kPLd + tx + 16 * j] = s[i][j];
          ds_s[(ty + 16 * i) * kPLd + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      acc_tile<kD>(p_s, do_s, ty, tx, acc_v);    // dV += P^T dO
      acc_tile<kD>(ds_s, q_s, ty, tx, acc_k);    // dK += dS^T Q
    }
  }
  const long long out = ((long long)bb * t_len + k0) * kv_stride + kh * d;
  store_rows<kD>(dk + out, kv_stride, n_keys, d, ty, tx, scale, acc_k);
  store_rows<kD>(dv + out, kv_stride, n_keys, d, ty, tx, 1.f, acc_v);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int s_len, int t_len, int h_q,
              int h_kv, int d, float scale, int causal) {
  using C = Cfg<kD>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + C::kTile;
  float* k_s = do_s + C::kTile;
  float* v_s = k_s + C::kTile;
  float* dst_s = v_s + C::kTile;                 // dS^T: [key][row]
  float* lse_s = dst_s + kB * kPLd;
  float* dl_s = lse_s + kB;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bb = blockIdx.x / h_q, h = blockIdx.x % h_q;
  const int kh = h / (h_q / h_kv);
  const int n_qt = (s_len + kB - 1) / kB;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kB;   // longest first
  const int n_q = min(kB, s_len - q0);
  const long long kv_stride = (long long)h_kv * d, q_stride = (long long)h_q * d;
  const long long off = ((long long)bb * s_len + q0) * q_stride + h * d;
  load_tile<kD>(q_s, q + off, q_stride, n_q, d);
  load_tile<kD>(do_s, dout + off, q_stride, n_q, d);
  if (tid < kB) {
    const long long row = ((long long)bb * h_q + h) * s_len + q0 + tid;
    lse_s[tid] = tid < n_q ? lse[row] : 0.f;
    dl_s[tid] = tid < n_q ? delta[row] : 0.f;
  }
  float acc[4][C::kNc];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < C::kNc; ++e) acc[j][e] = 0.f;

  const int n_kt_all = (t_len + kB - 1) / kB;
  const int q_last = q0 + n_q - 1;
  const int n_kt = causal ? min(n_kt_all, q_last / kB + 1) : n_kt_all;
  for (int jt = 0; jt < n_kt; ++jt) {
    const int k0 = jt * kB, n_keys = min(kB, t_len - k0);
    __syncthreads();                             // the last tile is read
    const long long koff = ((long long)bb * t_len + k0) * kv_stride + kh * d;
    load_tile<kD>(k_s, k + koff, kv_stride, n_keys, d);
    load_tile<kD>(v_s, v + koff, kv_stride, n_keys, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tile<kD>(q_s, k_s, ty, tx, s);
    score_tile<kD>(do_s, v_s, ty, tx, dp);
    probs(s, dp, lse_s, dl_s, q0, k0, s_len, t_len, causal, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst_s[(tx + 16 * j) * kPLd + ty + 16 * i] = dp[i][j];
    __syncthreads();
    acc_tile<kD>(dst_s, k_s, ty, tx, acc);       // dQ += dS K
  }
  store_rows<kD>(dq + off, q_stride, n_q, d, ty, tx, scale, acc);
}

template <int kD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   float* dq, float* dk, float* dv, float* delta, int b,
                   int s, int t, int h, int hk, int d, float scale,
                   int causal, cudaStream_t stream) {
  using C = Cfg<kD>;
  const long long rows = (long long)b * s * h;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  bwd_delta_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      o, dout, delta, rows, s, h, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int smem_kv = (4 * C::kTile + 2 * kB * kPLd + 2 * kB) * 4;
  e = cudaFuncSetAttribute(bwd_dkdv_kernel<kD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_kv);
  if (e != cudaSuccess) return e;
  bwd_dkdv_kernel<kD><<<dim3(b * hk, (t + kB - 1) / kB), kThreads, smem_kv,
                        stream>>>(q, k, v, dout, lse, delta, dk, dv, s, t, h,
                                  hk, d, scale, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int smem_q = (4 * C::kTile + kB * kPLd + 2 * kB) * 4;
  e = cudaFuncSetAttribute(bwd_dq_kernel<kD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_q);
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<kD><<<dim3(b * h, (s + kB - 1) / kB), kThreads, smem_q,
                      stream>>>(q, k, v, dout, lse, delta, dq, s, t, h, hk,
                                d, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (b, s, h, d); k, v, dk, dv (b, t, hk, d); lse and delta
// (b, h, s): contiguous f32, each 16-byte aligned; lse the forward's
// natural-log logsumexp, delta scratch the call overwrites; h % hk == 0,
// 4 <= d <= 128, d % 4 == 0.  Returns a cudaError_t.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* delta, int b, int s, int t, int h, int hk,
                              int d, float scale, int causal, void* stream) {
  if (b < 1 || s < 1 || t < 1 || hk < 1 || h % hk || d < 4 || d % 4 ||
      d > 128 || (long long)b * h > 0x7fffffffLL ||
      (s + kB - 1) / kB > 65535 || (t + kB - 1) / kB > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) &
       15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  return (int)(d > 64
      ? launch<128>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(dq), w(dk),
                    w(dv), w(delta), b, s, t, h, hk, d, scale, causal, st)
      : launch<64>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(dq), w(dk),
                   w(dv), w(delta), b, s, t, h, hk, d, scale, causal, st));
}
