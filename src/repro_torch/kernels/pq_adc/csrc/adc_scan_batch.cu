// Dense batch ADC scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pq_adc/pq_adc.py::
// pq_adc_scan_batch (_adc_batch_kernel): codes (N, M) uint8 and the LUTs
// of B queries (B, M, K) f32 give ADC distances (B, N) f32,
//     out[b, n] = sum_m luts[b, m, codes[n, m]],
// added in order m = 0, 1, ... from 0.0 (the plain version's order,
// ref.py::pq_adc_batch_ref).
//
// What bounds it on an H100 SXM: bytes.  At the serving window (B = 64
// queries, a candidate bucket of N = 2^21 rows, M = 32) it writes
// B*N*4 = 512 MB and reads N*M = 64 MB of codes: 0.17 ms at 3.35 TB/s,
// against 0.06 ms for its B*N*M = 4.3e9 f32 adds at 67 TFLOP/s.  The
// lookups behind those adds go to shared memory, 32 a clock on each of the
// 132 SMs: about 0.5 ms at 1.98 GHz, so this form of the kernel is held
// to the shared-memory rate before HBM.
//
// Design: the TPU kernel keeps all B LUTs in VMEM (2 MB at B = 64) and
// streams code tiles once.  A Hopper block has at most 227 KB of shared
// memory, and one LUT is M*K*4 = 32 KB at M = 32, so a block holds a tile
// of up to kMaxQ queries' LUTs (6 at M = 32) and the grid's second
// dimension walks the query tiles; each code row is read once per query
// tile (B/6 = 11 times at B = 64: 0.7 GB, still under the output's bytes).
// Each block owns rows_per_block rows (the wrapper picks it: up to 8192,
// so that filling the LUT tile from L2, up to 227 KB, stays small beside
// the rows it scans, and down to 256 so that a small bucket still gives
// every SM a block).  A thread reads its
// code row as 16-byte vectors when M is a multiple of 16 and keeps one f32
// accumulator per query in registers; neighbouring threads write
// neighbouring outputs, so the stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 8;             // accumulators a thread holds (ops.py)

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
adc_scan_batch_kernel(const uint8_t* __restrict__ codes,
                      const float* __restrict__ luts,
                      float* __restrict__ out, int n, int m, int k, int b,
                      int qb, int rows_per_block) {
  extern __shared__ float lut_s[];   // (nq, m, k)
  const int q0 = blockIdx.y * qb;
  const int nq = min(qb, b - q0);
  const int mk = m * k;
  const float* src = luts + (size_t)q0 * mk;
  for (int i = threadIdx.x; i < nq * mk; i += blockDim.x) lut_s[i] = src[i];
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row_end = min((long long)n, row0 + rows_per_block);
  for (long long r = row0 + threadIdx.x; r < row_end; r += blockDim.x) {
    float acc[kMaxQ];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.f;
    const uint8_t* row = codes + r * m;
    if (kVec16) {
      for (int c = 0; c < m; c += 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + c));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int code = (w[j >> 2] >> (8 * (j & 3))) & 0xff;
          const float* l = lut_s + (c + j) * k + code;
#pragma unroll
          for (int q = 0; q < kMaxQ; ++q)
            if (q < nq) acc[q] = __fadd_rn(acc[q], l[q * mk]);
        }
      }
    } else {
      for (int c = 0; c < m; ++c) {
        const float* l = lut_s + c * k + __ldg(row + c);
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q)
          if (q < nq) acc[q] = __fadd_rn(acc[q], l[q * mk]);
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q)
      if (q < nq) out[(size_t)(q0 + q) * n + r] = acc[q];
  }
}

template <bool kVec16>
cudaError_t launch(const uint8_t* codes, const float* luts, float* out,
                   int n, int m, int k, int b, int qb, int rows_per_block,
                   cudaStream_t stream) {
  const size_t smem = (size_t)qb * m * k * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      adc_scan_batch_kernel<kVec16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block,
                  (b + qb - 1) / qb);
  adc_scan_batch_kernel<kVec16><<<grid, kThreads, smem, stream>>>(
      codes, luts, out, n, m, k, b, qb, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// qb: queries per block (1..kMaxQ, qb*m*k*4 bytes of shared memory);
// rows_per_block >= 1; vec16: m % 16 == 0 and codes 16-byte aligned.
// Returns a cudaError_t.
extern "C" int adc_scan_batch(const uint8_t* codes, const float* luts,
                              float* out, int n, int m, int k, int b, int qb,
                              int rows_per_block, int vec16, void* stream) {
  if (qb < 1 || qb > kMaxQ || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec16 ? launch<true>(codes, luts, out, n, m, k, b, qb,
                                    rows_per_block, s)
                     : launch<false>(codes, luts, out, n, m, k, b, qb,
                                     rows_per_block, s));
}
