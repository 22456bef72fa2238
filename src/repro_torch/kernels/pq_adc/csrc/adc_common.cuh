// Device helpers shared by the ADC kernels of this directory.
//
// adc_row:      one code row's ADC distance against a LUT in shared
//               memory, sum_m lut[m, code_m] added in order m = 0, 1, ...
//               from 0.0 (ref.py::pq_adc_batch_ref's order), one rounding
//               per add; add16 adds one 16-byte chunk of it.
// bitonic_sort: an ascending sort of n (dist, pos) keys in shared memory
//               by (dist, pos), so equal distances keep the lower
//               position, as lax.top_k keeps the lower index.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adc {

// Adds to acc the entries of 16 consecutive LUT rows (lut points at the
// first) that the 16 code bytes of v select, in order, one rounding each.
__device__ __forceinline__ float add16(float acc, uint4 v, const float* lut,
                                       int k) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int code = (w[j >> 2] >> (8 * (j & 3))) & 0xff;
    acc = __fadd_rn(acc, lut[j * k + code]);
  }
  return acc;
}

// row: the M code bytes of one row; vec16: M % 16 == 0 and row 16-byte
// aligned, so the row is read as 16-byte vectors.
__device__ __forceinline__ float adc_row(const uint8_t* __restrict__ row,
                                         const float* lut, int m, int k,
                                         int vec16) {
  float acc = 0.f;
  if (vec16) {
    for (int c = 0; c < m; c += 16)
      acc = add16(acc, __ldg(reinterpret_cast<const uint4*>(row + c)),
                  lut + c * k, k);
  } else {
    for (int c = 0; c < m; ++c) acc = __fadd_rn(acc, lut[c * k + __ldg(row + c)]);
  }
  return acc;
}

__device__ __forceinline__ bool key_greater(float da, int pa, float db,
                                            int pb) {
  return da > db || (da == db && pa > pb);
}

// All threads of the block call it; n is a power of two.  The keys must be
// written and synchronised before; they are sorted and synchronised after.
__device__ __forceinline__ void bitonic_sort(float* key_d, int* key_p, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool ascending = (i & size) == 0;
          const float di = key_d[i], dj = key_d[j];
          const int pi = key_p[i], pj = key_p[j];
          if (key_greater(di, pi, dj, pj) == ascending) {
            key_d[i] = dj; key_d[j] = di;
            key_p[i] = pj; key_p[j] = pi;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace adc
