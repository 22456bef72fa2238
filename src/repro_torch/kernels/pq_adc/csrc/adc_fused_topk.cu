// Fused LUT build -> ADC scan -> block-local top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pq_adc/pq_adc.py::
// pq_adc_scan_fused (_adc_fused_kernel), in f32 and with lut_int8=True.
// Inputs: rows (B, S) int32 candidate row ids per query (ascending, -1 =
// pad), codes (N, M) uint8, queries (B, M*dsub) f32, codebooks
// (M, K, dsub) f32.  Block (seg, b) scores slots [seg*block_s,
// (seg+1)*block_s) of query b and writes its tk best (dist, row) pairs,
// ordered by (dist, slot): ties go to the lowest slot, i.e. the lowest row,
// as lax.top_k keeps the lowest index.  Pads come out as (+inf, -1).  The
// wrapper (ops.py::pq_adc_fused_topk) merges the blocks with a stable sort.
//
// Arithmetic (the plain version's, ref.py / ops.py, operation for
// operation; built with -fmad=false so nothing else is contracted):
//   LUT[m, k]  = (c0-q0)^2, then fma((cj-qj), (cj-qj), acc) for j >= 1
//   int8:  scale = max(hi - lo, 1e-12) * (1/255);  q = rint((lut-lo)/scale)
//          - 128;  term = fma(q + 128, scale, lo)
//   dist       = sum over m in order from 0.0, one rounding per add.
//
// What bounds it on an H100 SXM: bytes, and few of them.  Per query it
// reads S row ids and S code rows (4 + M bytes a slot, gathered) and
// writes nb*tk pairs; at the serving window (B = 64, S = 2^16, M = 32)
// that is about 150 MB: 0.05 ms at 3.35 TB/s.  Its operations (the LUT
// build, B*M*K*dsub*3, and B*S*M adds) are under 0.01 ms of the f32 rate.
//
// Design: the Pallas kernel builds the (B, M, K) LUT once at grid step 0
// and carries it in VMEM across its sequential grid.  Hopper blocks run
// in parallel and carry nothing, so every block rebuilds its query's LUT
// in shared memory (M*K*dsub*3 = 98K flops and a 128 KB codebook read from
// L2 at M = 32, K = 256) before it scans.  The block-local top-k is a
// bitonic sort of the block_s (dist, slot) keys in shared memory; only tk
// pairs leave the block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "adc_common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
adc_fused_topk_kernel(const int32_t* __restrict__ rows,
                      const uint8_t* __restrict__ codes,
                      const float* __restrict__ queries,
                      const float* __restrict__ codebooks,
                      float* __restrict__ vals, int32_t* __restrict__ ids,
                      int s, int n, int m, int k, int dsub, int block_s,
                      int tk, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);          // m*k
  float* key_d = lut + m * k;                           // block_s
  int* key_p = reinterpret_cast<int*>(key_d + block_s);  // block_s
  float* scale_s = reinterpret_cast<float*>(key_p + block_s);  // m (int8)
  float* zp_s = scale_s + m;                            // m (int8)
  int8_t* lut8 = reinterpret_cast<int8_t*>(zp_s + m);   // m*k (int8)

  const int b = blockIdx.y;
  const int seg = blockIdx.x;
  const int mk = m * k;
  const float* q = queries + (size_t)b * m * dsub;

  // 1. this query's LUT
  for (int i = threadIdx.x; i < mk; i += blockDim.x) {
    const float* c = codebooks + (size_t)i * dsub;
    const float* qq = q + (i / k) * dsub;
    const float d0 = __fsub_rn(c[0], qq[0]);
    float acc = __fmul_rn(d0, d0);
    for (int j = 1; j < dsub; ++j) {
      const float dj = __fsub_rn(c[j], qq[j]);
      acc = __fmaf_rn(dj, dj, acc);
    }
    lut[i] = acc;
  }
  __syncthreads();
  if (kInt8) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int mm = warp; mm < m; mm += blockDim.x >> 5) {
      float lo = INFINITY, hi = -INFINITY;
      for (int kk = lane; kk < k; kk += 32) {
        lo = fminf(lo, lut[mm * k + kk]);
        hi = fmaxf(hi, lut[mm * k + kk]);
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) {
        scale_s[mm] = __fmul_rn(fmaxf(__fsub_rn(hi, lo), 1e-12f),
                                1.0f / 255.0f);
        zp_s[mm] = lo;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < mk; i += blockDim.x) {
      const int mm = i / k;
      const float t = __fdiv_rn(__fsub_rn(lut[i], zp_s[mm]), scale_s[mm]);
      lut8[i] = (int8_t)(int)__fsub_rn(rintf(t), 128.f);
    }
    __syncthreads();
  }

  // 2. ADC distance of each slot; pads (-1, or past S) score +inf
  const int32_t* qrows = rows + (size_t)b * s;
  const int p0 = seg * block_s;
  for (int i = threadIdx.x; i < block_s; i += blockDim.x) {
    const int p = p0 + i;
    const int r = p < s ? qrows[p] : -1;
    float acc = INFINITY;
    if (r >= 0 && r < n) {
      const uint8_t* code = codes + (size_t)r * m;
      acc = 0.f;
      for (int c = 0; c < m; c += 16) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (vec16) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(code + c));
          w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int mm = c + j;
          if (mm >= m) break;
          const int cd = vec16 ? (w[j >> 2] >> (8 * (j & 3))) & 0xff
                               : __ldg(code + mm);
          float term;
          if (kInt8)
            term = __fmaf_rn(__fadd_rn((float)lut8[mm * k + cd], 128.f),
                             scale_s[mm], zp_s[mm]);
          else
            term = lut[mm * k + cd];
          acc = __fadd_rn(acc, term);
        }
      }
    }
    key_d[i] = acc;
    key_p[i] = p;
  }
  __syncthreads();

  // 3. bitonic sort of the block_s keys, ascending by (dist, slot)
  adc::bitonic_sort(key_d, key_p, block_s);

  // 4. the block's tk best pairs
  const int nb = (s + block_s - 1) / block_s;
  const size_t out0 = (size_t)b * nb * tk + (size_t)seg * tk;
  for (int j = threadIdx.x; j < tk; j += blockDim.x) {
    const int p = key_p[j];
    int r = p < s ? qrows[p] : -1;
    if (r >= n) r = -1;
    vals[out0 + j] = key_d[j];
    ids[out0 + j] = r;
  }
}

template <bool kInt8>
cudaError_t launch(const int32_t* rows, const uint8_t* codes,
                   const float* queries, const float* codebooks, float* vals,
                   int32_t* ids, int b, int s, int n, int m, int k, int dsub,
                   int block_s, int tk, int vec16, cudaStream_t stream) {
  size_t smem = (size_t)m * k * 4 + (size_t)block_s * 8;
  if (kInt8) smem += (size_t)m * 8 + (size_t)m * k;
  cudaError_t e = cudaFuncSetAttribute(
      adc_fused_topk_kernel<kInt8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s + block_s - 1) / block_s, b);
  adc_fused_topk_kernel<kInt8><<<grid, kThreads, smem, stream>>>(
      rows, codes, queries, codebooks, vals, ids, s, n, m, k, dsub, block_s,
      tk, vec16);
  return cudaGetLastError();
}

}  // namespace

// block_s: a power of two; tk <= block_s; vals/ids hold
// (B, ceil(S/block_s)*tk).  vec16: m % 16 == 0 and codes 16-byte aligned.
// Returns a cudaError_t.
extern "C" int adc_fused_topk(const int32_t* rows, const uint8_t* codes,
                              const float* queries, const float* codebooks,
                              float* vals, int32_t* ids, int b, int s, int n,
                              int m, int k, int dsub, int block_s, int tk,
                              int lut_int8, int vec16, void* stream) {
  if (block_s < 1 || (block_s & (block_s - 1)) || tk < 1 || tk > block_s)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(lut_int8
      ? launch<true>(rows, codes, queries, codebooks, vals, ids, b, s, n, m,
                     k, dsub, block_s, tk, vec16, st)
      : launch<false>(rows, codes, queries, codebooks, vals, ids, b, s, n, m,
                      k, dsub, block_s, tk, vec16, st));
}
