// Exact squared L2 distances for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/l2dist/l2dist.py::l2dist
// (_l2_kernel) for bf16 of odd width: queries (B, D) and vectors (N, D),
// bf16, give
//     out[b, n] = (|q_b|^2 - 2 q_b.v_n) + |v_n|^2        (B, N) f32,
// with the inputs widened to f32 and every sum in f32 on the CUDA cores:
// no tensor-core product, no library call.  The dot product and the norms
// are __fmaf_rn chains over d = 0, 1, ...; the epilogue rounds each step,
// as ref.py::l2dist_ref does.  It serves the widths the tensor-core kernel
// (l2dist_wgmma.cu) does not take (l2dist/ops.py::l2_kernel): rows of an
// odd bf16 width lie on 2-byte boundaries, which no cp.async granule
// takes.
//
// What bounds it on an H100 SXM: bytes.  At the ground-truth chunk cut to
// d = 101 (B = 256, N = 2^20, the smoke's full-width call) it reads 212 MB
// and writes 1.07 GB: 0.384 ms at 3.35 TB/s; its 54 GFLOP of products
// take 0.055 ms once in bf16 on the tensor cores (each exact in f32).
// This form, on the CUDA cores at 67 TFLOP/s, cannot go below 0.81 ms.
//
// Design: the TPU kernel is one MXU product per (bq, bn) tile with D
// whole.  Here a block of 256 threads owns a 128 x 128 output tile and
// walks D in steps of 16: it stages the 128 x 16 slices of queries and of
// vectors in shared memory (transposed, rows padded by 4 floats so the
// stores meet at most 2-way bank conflicts), and each thread keeps an
// 8 x 8 sub-tile of sums in registers, reading four float4 values of
// shared memory for every 64 multiply-adds.  Threads 0..127 also sum the
// squares of their query row, threads 128..255 of their vector row, from
// the same slices, so the norms cost no extra pass over memory.  The
// epilogue writes float4 rows where N % 4 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;          // queries per block
constexpr int kBN = 128;          // vectors per block
constexpr int kBK = 16;           // depth of one staged slice
constexpr int kLd = kBM + 4;      // padded row of the staged slices

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__global__ void __launch_bounds__(kThreads, 2)
l2dist_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
              int b, int n, int d) {
  __shared__ __align__(16) float qs[kBK][kLd];
  __shared__ __align__(16) float vs[kBK][kLd];
  __shared__ float qn_s[kBM];
  __shared__ float vn_s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.y * kBM;
  const long long n0 = (long long)blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float norm = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kBK, col = e % kBK;
      const int kk = k0 + col;
      const long long gq = m0 + row, gv = n0 + row;
      qs[col][row] = (gq < b && kk < d) ? to_f32(q[gq * d + kk]) : 0.f;
      vs[col][row] = (gv < n && kk < d) ? to_f32(v[gv * d + kk]) : 0.f;
    }
    __syncthreads();
    {
      const float* own = tid < kBM ? &qs[0][tid] : &vs[0][tid - kBM];
#pragma unroll
      for (int c = 0; c < kBK; ++c)
        norm = __fmaf_rn(own[c * kLd], own[c * kLd], norm);
    }
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(&qs[c][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&qs[c][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&vs[c][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&vs[c][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kBM) qn_s[tid] = norm; else vn_s[tid - kBM] = norm;
  __syncthreads();

  const bool vec = (n & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int li = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const long long gi = m0 + li;
    if (gi >= b) continue;
    const float qn = qn_s[li];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lj = half * 64 + tx * 4;
      const long long gj = n0 + lj;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, acc[i][half * 4 + j])),
                         vn_s[lj + j]);
      float* dst = out + gi * n + gj;
      if (vec && gj + 3 < n) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gj + j < n) dst[j] = o[j];
      }
    }
  }
}

}  // namespace

// queries (b, d) and vectors (n, d), both bf16, row-major; out (b, n)
// f32.  Returns a cudaError_t.
extern "C" int l2dist(const void* queries, const void* vectors, float* out,
                      int b, int n, int d, void* stream) {
  if (b < 1 || n < 1 || d < 1 || (b + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (b + kBM - 1) / kBM);
  l2dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(queries),
      static_cast<const __nv_bfloat16*>(vectors), out, b, n, d);
  return (int)cudaGetLastError();
}
