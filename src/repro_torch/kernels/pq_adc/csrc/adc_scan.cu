// Single-query ADC scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pq_adc/pq_adc.py::
// pq_adc_scan (_adc_kernel): codes (N, M) uint8 and one query's LUT
// (M, K) f32 give ADC distances (N,) f32,
//     out[n] = sum_m lut[m, codes[n, m]],
// added in order m = 0, 1, ... from 0.0 (ref.py::pq_adc_ref's order), so
// the kernel gives the plain version's bits.
//
// What bounds it on an H100 SXM: bytes.  At N = 10M, M = 32 it reads
// N*M = 320 MB of codes and writes N*4 = 40 MB: 0.11 ms at 3.35 TB/s,
// against 0.005 ms for its N*M f32 adds at 67 TFLOP/s.  The lookups go to
// shared memory, random within each 1 KB LUT row (about 3.5-way bank
// conflicts for 32 random codes over 32 banks): an estimated 0.13 ms at
// 1.98 GHz on 132 SMs, close beside the byte bound.
//
// Design: the TPU kernel pins the LUT in VMEM across a sequential grid of
// code tiles.  Here every block copies the LUT into shared memory once
// (M*K*4 = 32 KB at M = 32) and then walks the rows with a grid stride:
// the grid is as many blocks as the card holds at once (the launch asks
// the occupancy calculator), so the LUT is copied some 900 times in all
// (30 MB from L2), not once per tile, and every SM is busy to the end.
// A thread reads its code row as 16-byte vectors when M is a multiple of
// 16; neighbouring threads write neighbouring outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const uint8_t* __restrict__ codes,
                const float* __restrict__ lut, float* __restrict__ out,
                long long n, int m, int k, int vec16) {
  extern __shared__ float lut_s[];   // (m, k)
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) lut_s[i] = lut[i];
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += step)
    out[r] = adc::adc_row(codes + r * m, lut_s, m, k, vec16);
}

}  // namespace

// vec16: m % 16 == 0 and codes 16-byte aligned.  Returns a cudaError_t.
extern "C" int adc_scan(const uint8_t* codes, const float* lut, float* out,
                        int n, int m, int k, int vec16, void* stream) {
  if (n < 1 || m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int smem = m * k * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      adc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, adc_scan_kernel, kThreads, smem)) != cudaSuccess)
    return (int)e;
  const long long need = ((long long)n + kThreads - 1) / kThreads;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < full ? need : full);
  adc_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, lut, out, n, m, k, vec16);
  return (int)cudaGetLastError();
}
