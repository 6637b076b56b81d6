// Tensor Memory Accelerator (TMA) helpers: the host-side tensor-map encoder
// and the device-side 2-D, 4-D and 5-D tile loads that csrc/conv2_pool.cu (the
// stem tail's halo tiles), csrc/roi_pool.cu (the forward's channel slice of
// the feature map) and csrc/int8_conv.cu (the conv's input and weight
// tiles) share, with the mbarrier operations a TMA load completes on.  (csrc/vgg_stem.cuh and csrc/nms.cu keep their own mbarrier helpers:
// tools/torch_stem_variants.py and tools/torch_nms_walk_probe.py build
// private copies of those files alone.)
//
// A tensor map is encoded on the host by libcuda's cuTensorMapEncodeTiled,
// looked up through the CUDA runtime, so no library here links libcuda
// itself.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the barrier at `bar` expecting `count` arrivals, made
// visible to the async proxy that completes transactions on it.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA request: the box of the 4-D tensor `map` at coordinates (c0, c1,
// c2, c3), innermost first, into shared memory at `dst` (128-byte
// aligned), completing `bar`'s transaction count by the box's bytes
// (elements outside the tensor arrive as zeros and count too).
__device__ __forceinline__ void load_4d(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1, int c2,
                                        int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// One TMA request: the box of the 5-D tensor `map` at (c0, ..., c4), as
// load_4d.
__device__ __forceinline__ void load_5d(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1, int c2,
                                        int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// One TMA request: the box of the 2-D tensor `map` at (c0, c1), as
// load_4d.
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime; null if it
// is missing.
inline EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                       cudaEnableDefault, &res) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                              cudaEnableDefault, &res) != cudaSuccess)
    return nullptr;
#endif
  return res == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(fn)
             : nullptr;
}

}  // namespace tma
