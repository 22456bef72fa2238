// Single-query ADC scan + block-local top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pq_adc/pq_adc.py::
// pq_adc_scan_topk (_adc_topk_kernel).  Inputs: codes (N, M) uint8, one
// query's LUT (M, K) f32.  Block i scores rows [i*block_n, (i+1)*block_n)
// (sum_m lut[m, code_m] in order from 0.0, as ref.py::pq_adc_ref), sets
// the rows past N to +inf BEFORE its top-k (the padding-eviction fix of
// the TPU kernel: a mostly-padding last block must not push real rows out
// of its tk), and writes its tk best (dist, row) pairs ordered by
// (dist, row), so ties keep the lower row as lax.top_k does.  The wrapper
// (ops.py::pq_adc_topk) merges the blocks with a stable sort and keeps
// min(topk, N).
//
// What bounds it on an H100 SXM: bytes.  At N = 10M, M = 32, block_n =
// 2048 and tk = 512 it reads 320 MB of codes and writes 4,883 * 512 pairs
// (20 MB): 0.10 ms at 3.35 TB/s.  This form is held well above that by its
// block-local sort: a bitonic sort of block_n keys is block_n/2 *
// log2(block_n) * (log2(block_n)+1)/2 compare-exchanges in shared memory
// (67k per block, 330M in all at 10M rows), where the TPU kernel's
// lax.top_k had the VPU's sort.  A selection that keeps only tk keys
// is the next step.
//
// Design: one block per block_n rows, as the TPU grid; each block copies
// the LUT (32 KB at M = 32) into shared memory, scores its rows (one
// thread per row, 16-byte code loads when M % 16 == 0) into (dist, row)
// keys beside it, sorts them (adc_common.cuh, shared with
// adc_fused_topk.cu) and writes the first tk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "adc_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
adc_scan_topk_kernel(const uint8_t* __restrict__ codes,
                     const float* __restrict__ lut, float* __restrict__ vals,
                     int32_t* __restrict__ ids, int n, int m, int k,
                     int block_n, int tk, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);        // m*k
  float* key_d = lut_s + m * k;                         // block_n
  int* key_p = reinterpret_cast<int*>(key_d + block_n);  // block_n
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) lut_s[i] = lut[i];
  __syncthreads();

  const int row0 = blockIdx.x * block_n;
  for (int i = threadIdx.x; i < block_n; i += blockDim.x) {
    const int r = row0 + i;
    key_d[i] = r < n ? adc::adc_row(codes + (size_t)r * m, lut_s, m, k, vec16)
                     : INFINITY;
    key_p[i] = r;
  }
  __syncthreads();
  adc::bitonic_sort(key_d, key_p, block_n);

  const size_t out0 = (size_t)blockIdx.x * tk;
  for (int j = threadIdx.x; j < tk; j += blockDim.x) {
    vals[out0 + j] = key_d[j];
    ids[out0 + j] = key_p[j];
  }
}

}  // namespace

// block_n: a power of two, tk <= block_n; vals/ids hold
// ceil(n/block_n)*tk; rows past n come out as (+inf, row).  vec16: m % 16
// == 0 and codes 16-byte aligned.  Returns a cudaError_t.
extern "C" int adc_scan_topk(const uint8_t* codes, const float* lut,
                             float* vals, int32_t* ids, int n, int m, int k,
                             int block_n, int tk, int vec16, void* stream) {
  if (n < 1 || block_n < 1 || (block_n & (block_n - 1)) || tk < 1 ||
      tk > block_n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * k * sizeof(float) + (size_t)block_n * 8;
  cudaError_t e = cudaFuncSetAttribute(
      adc_scan_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(((long long)n + block_n - 1) / block_n);
  adc_scan_topk_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      codes, lut, vals, ids, n, m, k, block_n, tk, vec16);
  return (int)cudaGetLastError();
}
