// Hopper (sm_90a) helpers shared by the tensor-core kernels
// (flash_attn/csrc/flash_attn_fwd_wgmma.cu, flash_attn_fwd_tf32.cu,
// l2dist/csrc/l2dist_wgmma.cu): mbarriers, TMA tile loads and stores,
// cp.async granules that arrive on an mbarrier, named barriers, register
// reallocation (setmaxnreg), wgmma shared-memory descriptors, the wgmma
// fence / commit / wait, the TF32 split and the
// shared-memory TF32 product of the 3xTF32 kernels, and the driver's
// cuTensorMapEncodeTiled found through the runtime (so no library links
// -lcuda).  kernels/build.py puts this directory on every source's include
// path and hashes this file into the name of every library that includes
// it, so an edit here rebuilds those.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}
// waits for the phase of the given parity to complete; traps after about
// ten seconds (a lost arrival or copy) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}
// after one thread's mbar_init calls, before any thread uses the barriers
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ------------------------------------------------------------------- TMA
// one box of a tensor map into shared memory; completion counted in bytes
// on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of shared memory into a tensor map's tile (rows and columns
// past the tensor are not written); completion tracked by bulk groups
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's bulk groups still read their
// shared memory (kRead) or are not yet complete
template <int N, bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- cp.async
// one granule of kBytes (4, 8 or 16) from global into shared memory; the
// bytes past src_bytes (kBytes or 0) are filled with zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               ::"r"(dst), "l"(src), "n"(kBytes), "r"(src_bytes)
               : "memory");
}
// one arrival on the mbarrier once this thread's earlier cp.async copies
// have landed; it counts toward the arrivals the barrier was set up for
// (noinc), so a barrier fed by a warp's copies is initialised with 32
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}

// named barrier `id` (0 is __syncthreads') over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// an arrival on named barrier `id` that does not wait (the other threads
// of its `threads` wait there with named_sync)
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the registers a thread of this warpgroup holds, lowered or raised to N
// (a multiple of 8 in 24 .. 256; every thread of the warpgroup executes
// it, and a raise waits until lowered registers free enough)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// shared-memory stores of this thread visible to the async proxy (wgmma
// operand reads, TMA) once the threads that read next have synchronised
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------------- wgmma
// shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// the same with the 64-byte swizzle (rows of 64 bytes, 8-row atoms of 512)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (desc(addr, lbo, sbo) & ~(3ull << 62)) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ------------------------------------------------------------------ TF32
// 3xTF32: x = hi + lo with hi = tf32(x) (round to nearest) and lo =
// tf32(x - hi); a product is summed as hi*hi + hi*lo + lo*hi (lo*lo is
// below f32's resolution of the sum)
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// operand lists of the accumulator registers d[0..N) for wgmma's inline asm
#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D16 D8(0), D8(8)
#define D32 D16, D8(16), D8(24)
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define D128 D64, D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), \
             D8(112), D8(120)
// the same for the int32 accumulators of integer wgmma
#define D8I(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
               "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define D64I D8I(0), D8I(8), D8I(16), D8I(24), D8I(32), D8I(40), D8I(48), \
             D8I(56)
#define R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define R64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

#define R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, " \
  "%109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"

// d (64 x 128, f32) (+)= A (64 x 8, smem) * B (128 x 8, smem)^T in TF32,
// both K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", %64, %65, p, 1, 1;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no -lcuda; null if the driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace hopper
