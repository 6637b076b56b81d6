// The VGG stem tail for Hopper (sm_90a): conv1_2 (64 -> 64, 3x3 SAME) +
// bias + ReLU + 2x2/2 max-pool from the bf16 conv1_1 activation;
// a1 [B, H, W, 64] bf16 NHWC -> [B, H/2, W/2, 64] f32.
//
// Replaces the TPU kernel wssdl_bus_tpu/ops/conv2_pool_pallas.py:
// _tail_kernel (wrapper vgg_conv2_pool) and computes what it computes:
// y = relu(sum a1 * bf16(w2) + b2) with SAME zeros outside the image, then
// the 2x2/2 VALID max-pool, f32 out.  The order of sums and the bit-exact
// contract with the plain version ops/conv2_pool.py:vgg_conv2_pool_plain
// are the fused stem's (vgg_stem.cuh).  The Pallas kernel's pair-packed
// 128-lane layout and its structural-zero weight blocks exist for the TPU's
// matrix unit and are not carried over.
//
// What bounds it: operations.  2 * B * H * W * 64 * 576 flops, 292.6 GFLOP
// at the served batch of 8 at 608 x 816: 0.30 ms at 989 TFLOP/s of dense
// bf16, against 0.23 ms to read the 508 MB bf16 activation and write the
// pooled output.  Like the fused stem, this first kernel runs f32 FMAs on
// the SIMT cores to keep one fixed order of sums.  One block per 16 x 16
// tile of outputs loads its 18 x 18 x 64 halo tile of a1 once (coalesced:
// 128 contiguous bytes a pixel), and the pooled tile is the only write.

#include "vgg_stem.cuh"

namespace {

using namespace vgg_stem;

__global__ void __launch_bounds__(kThreads, 2)
    stem_tail_kernel(const __nv_bfloat16* __restrict__ a1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, int h, int w,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a1s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ws = reinterpret_cast<float*>(smem + kA1Bytes);
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;

  // the halo tile: rows y0-1 .. y0+16, columns x0-1 .. x0+16; 0 outside
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int k = threadIdx.x; k < kHalo * kHalo * kC; k += kThreads) {
    const int c = k & (kC - 1);
    const int pix = k >> 6;
    const int r = pix / kHalo;
    const int col = pix - r * kHalo;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + col;
    __nv_bfloat16 v = zero;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = a1[(((size_t)b * h + gy) * w + gx) * kC + c];
    a1s[c * kHalo * kHalo + pix] = v;
  }

  conv12_pool(a1s, ws, w2, b2, b, blockIdx.y * kPooled,
              blockIdx.x * kPooled, h / 2, w / 2, out);
}

}  // namespace

extern "C" {

// a1 [batch, h, w, 64] bf16 NHWC, w2 [3, 3, 64, 64] f32 HWIO, b2 [64] f32,
// out [batch, h/2, w/2, 64] f32 (16-byte aligned); h and w even.  Launches
// on `stream`, does not synchronise, returns the cudaError_t of the launch.
int wssdl_vgg_conv2_pool(const void* a1, const float* w2, const float* b2,
                         int batch, int h, int w, float* out,
                         cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (h % 2 || w % 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kStemSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  stem_tail_kernel<<<grid, kThreads, kStemSmemBytes, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(a1), w2, b2, h, w, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
