// The VGG stem tail for Hopper (sm_90a): conv1_2 (64 -> 64, 3x3 SAME) +
// bias + ReLU + 2x2/2 max-pool from the bf16 conv1_1 activation;
// a1 [B, H, W, 64] bf16 NHWC -> [B, H/2, W/2, 64] f32.
//
// Replaces the TPU kernel wssdl_bus_tpu/ops/conv2_pool_pallas.py:
// _tail_kernel (wrapper vgg_conv2_pool) and computes what it computes:
// y = relu(sum a1 * bf16(w2) + b2) with SAME zeros outside the image, then
// the 2x2/2 VALID max-pool, f32 out.  The Pallas kernel's pair-packed
// 128-lane layout and its structural-zero weight blocks exist for the TPU's
// matrix unit and are not carried over.
//
// What bounds it: operations.  2 * B * H * W * 64 * 576 flops, 292.6 GFLOP
// at the served batch of 8 at 608 x 816: 0.30 ms at 989 TFLOP/s of dense
// bf16, against 0.23 ms to read the 508 MB bf16 activation and write the
// pooled output.  The products run on the tensor cores (vgg_stem.cuh: an
// implicit GEMM on wgmma, two consumer warpgroups).  One producer warp
// fetches each 18 x 18 x 64 halo tile with a single TMA request into the
// free one of two buffers; TMA's zero fill at coordinates outside the
// tensor is the SAME padding, and its 128-byte swizzle is the layout the
// consumers' ldmatrix reads without bank conflicts.  Only a1 and the pooled
// output touch device memory.  Numerics: vgg_stem.cuh (f32 reassociation
// of exact bf16 products against ops/conv2_pool.py:vgg_conv2_pool_plain).

#include "tma.cuh"
#include "vgg_stem.cuh"

namespace {

using namespace vgg_stem;

constexpr int kThreads = kConsumerThreads + 32;   // + the producer warp
constexpr size_t kSmemBytes = kSmemSlack + kStemScratch;

__global__ void __launch_bounds__(kThreads, 1)
    stem_tail_kernel(const __grid_constant__ CUtensorMap a1_map,
                     const __nv_bfloat16* __restrict__ wpk,
                     const float* __restrict__ b2, int batch, int h, int w,
                     float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  block_setup(smem, wpk, 1);
  const int ntx = (w + kTile - 1) / kTile;
  const int nty = (h + kTile - 1) / kTile;
  const int ntiles = batch * nty * ntx;

  if (threadIdx.x >= kConsumerThreads) {            // the producer warp
    if (threadIdx.x != kConsumerThreads) return;
    int it = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
      const TileCoord tc = tile_coord(t, ntx, nty);
      producer_acquire(smem, it);
      const uint32_t full = full_bar(smem, it & 1);
      mbar_arrive_expect_tx(full, kHaloBytes);
      tma::load_4d(smem_u32(smem + kBufOff + (it & 1) * kBufBytes),
                   &a1_map, full, 0, tc.x0 - 1, tc.y0 - 1, tc.b);
    }
  } else {
    consumer_loop(smem, b2, ntx, nty, ntiles, h / 2, w / 2, out);
  }
}

}  // namespace

extern "C" {

// a1 [batch, h, w, 64] bf16 NHWC (16-byte aligned), wpk [9, 64, 64] bf16
// (tap, c_out, c_in: ops/conv2_pool.py:pack_conv2_weights_bf16), b2 [64]
// f32, out [batch, h/2, w/2, 64] f32; h and w even.  Launches on `stream`,
// does not synchronise, returns the cudaError_t of the set-up and launch.
int wssdl_vgg_conv2_pool(const void* a1, const void* wpk, const float* b2,
                         int batch, int h, int w, float* out,
                         cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (h % 2 || w % 2) return (int)cudaErrorInvalidValue;
  static tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // dims innermost first: channel, column, row, image; the box is one
  // image's 18 x 18 halo tile, all 64 channels (128 bytes: the swizzle row)
  const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)kC * 2, (cuuint64_t)w * kC * 2,
                                 (cuuint64_t)h * w * kC * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kC, kHalo, kHalo, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(a1),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = batch * ((h + kTile - 1) / kTile) *
                     ((w + kTile - 1) / kTile);
  stem_tail_kernel<<<persistent_grid(ntiles), kThreads, kSmemBytes, stream>>>(
      map, reinterpret_cast<const __nv_bfloat16*>(wpk), b2, batch, h, w, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
