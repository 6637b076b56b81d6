// The fused VGG stem for Hopper (sm_90a): conv1_1 (3 -> 64, 3x3 SAME) +
// bias + ReLU, conv1_2 (64 -> 64) + bias + ReLU, 2x2/2 max-pool, in one
// kernel; x [B, H, W, 3] f32 NHWC -> [B, H/2, W/2, 64] f32.
//
// Replaces the TPU kernel wssdl_bus_tpu/ops/conv1_pallas.py:_stem_kernel
// (wrapper vgg_stem_fused) and computes what it computes:
//   * xb = bf16(x), w1b = bf16(w1); a1 = relu(sum xb * w1b + b1) with SAME
//     zero padding of x; a1b = bf16(a1), and a1b = 0 OUTSIDE the image
//     (conv1_2 sees SAME zeros, not conv1_1 of the padded extension: the
//     Pallas kernel's halo rule, conv1_pallas.py:173-187);
//   * y = relu(sum a1b * bf16(w2) + b2), then the 2x2/2 VALID max-pool.
//
// What bounds it: operations.  2 * B * H * W * 64 * (27 + 576) flops, 306
// GFLOP at the served batch of 8 at 608 x 816: 0.31 ms at the H100's 989
// TFLOP/s of dense bf16, against 0.09 ms to move x in and the pooled output
// out.  conv1_2 (95% of the flops) runs on the tensor cores as the tail's
// implicit GEMM (vgg_stem.cuh: two consumer warpgroups on wgmma).  conv1_1
// stays on the SIMT cores in the plain version's fixed order, (dy, dx, c)
// ascending from 0.0 with fmaf, then the bias, the ReLU and the bf16
// rounding, so the a1 tile is bit for bit the plain version's and only
// conv1_2's sum is reassociated.  A producer warpgroup computes the next
// tile's 18 x 18 x 64 a1 (from a 20 x 20 x 3 input patch whose global
// loads it issues, branch-free, one tile ahead) into the free one of two
// halo buffers while the consumers run the current tile's products.
// conv1_1's weights sit in registers (two channels a lane); a warp walks a
// halo row four pixels a step, each input value one 32-bit shared-memory
// word that the whole warp reads.  Only x and the pooled output touch
// device memory.  Measured on an NVIDIA H100 80GB HBM3 at 700 W, at the
// served batch of 8: this producer alone takes ~0.7-0.8 ms (conv1_1's
// 8.7 G f32 FMAs with the halo, one warp per scheduler) and the consumers
// alone ~0.53 ms; together ~1.1 ms: the SIMT conv1_1 and its interference
// with the tensor-core consumers bound the kernel, not the tensor cores.

#include "vgg_stem.cuh"

namespace {

using namespace vgg_stem;

constexpr int kProducerThreads = 128;             // one producer warpgroup
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr int kIn = kTile + 4;       // input patch side: 2 halo pixels a side
constexpr int kPatch = kIn * kIn * 3;                         // 1200 floats
constexpr int kPatchPerThread =
    (kPatch + kProducerThreads - 1) / kProducerThreads;       // 10
constexpr uint32_t kXsOff = kStemScratch;                     // [kPatch] f32
constexpr size_t kSmemBytes = kSmemSlack + kXsOff + kPatch * 4;

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducerThreads) : "memory");
}

// The patch of tile tc (rows y0-2 .. y0+17, columns x0-2 .. x0+17, 3
// channels) into registers: element tid + kProducerThreads k of the patch
// in r[k], raw,
// and whether it lies inside the image in bit k of `inside`.  The loads
// have no branch and nothing here uses their values, so they stay in
// flight while conv1_1 runs; store_patch rounds them to bf16.
__device__ __forceinline__ void load_patch(float (&r)[kPatchPerThread],
                                           uint32_t& inside,
                                           const float* __restrict__ x,
                                           TileCoord tc, int h, int w,
                                           int tid) {
  inside = 0u;
#pragma unroll
  for (int k = 0; k < kPatchPerThread; ++k) {
    const int e = tid + kProducerThreads * k;
    const int row = e / (kIn * 3);
    const int rem = e - row * kIn * 3;
    const int gy = tc.y0 - 2 + row;
    const int gx = tc.x0 - 2 + rem / 3;
    const bool in =
        e < kPatch && gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t off = in ? (((size_t)tc.b * h + gy) * w + gx) * 3 + rem % 3
                          : 0;
    r[k] = __ldg(x + off);
    inside |= (uint32_t)in << k;
  }
}

__device__ __forceinline__ void store_patch(const float (&r)[kPatchPerThread],
                                            uint32_t inside, float* xs,
                                            int tid) {
#pragma unroll
  for (int k = 0; k < kPatchPerThread; ++k)
    if (tid + kProducerThreads * k < kPatch)
      xs[tid + kProducerThreads * k] =
          (inside >> k) & 1u ? bf16_round(r[k]) : 0.f;
}

// conv1_1 of tile tc from the staged patch into the halo buffer `buf`.
// Lane cp of producer warp pw owns channels 2cp and 2cp+1 (their 27 x 2
// bf16-rounded weights wr and biases br live in its registers) and walks
// halo rows pw, pw+4, ...: four pixels a step (eight independent sums),
// from a window of six patch columns (3 rows x 3 channels each) of which
// each step loads four.  Every shared-memory read is one 32-bit word that
// the whole warp shares, and a pixel's 64 outputs go out as one 128-byte
// row.
__device__ __forceinline__ void conv1_1_tile(unsigned char* buf,
                                             const float* xs,
                                             const float (&wr)[27][2],
                                             const float (&br)[2],
                                             TileCoord tc, int h, int w,
                                             int pw, int cp) {
  const uint32_t lane_off = (cp & 3) * 4;
  for (int hy = pw; hy < kHalo; hy += 4) {
    const int gy = tc.y0 - 1 + hy;
    if (gy < 0 || gy >= h) {            // the whole row is SAME zeros
      for (int hx = 0; hx < kHalo; ++hx)
        *reinterpret_cast<uint32_t*>(buf + swz(hy * kHalo + hx, cp >> 2) +
                                     lane_off) = 0u;
      continue;
    }
    const float* xrow = xs + hy * kIn * 3;      // patch rows hy .. hy+2
    float win[8][9];                            // [column & 7][3 dy + ci]
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        win[c][k] = xrow[((k / 3) * kIn + c) * 3 + k % 3];
#pragma unroll
    for (int q = 0; q < kHalo; q += 4) {
      const int n = kHalo - q < 4 ? kHalo - q : 4;     // pixels this step
#pragma unroll
      for (int c = q + 2; c < q + n + 2; ++c)
#pragma unroll
        for (int k = 0; k < 9; ++k)
          win[c & 7][k] = xrow[((k / 3) * kIn + c) * 3 + k % 3];
      float acc[4][2];
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[p][0] = acc[p][1] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
#pragma unroll
            for (int p = 0; p < n; ++p) {
              const float xv = win[(q + p + dx) & 7][3 * dy + ci];
              const int k = (dy * 3 + dx) * 3 + ci;
              acc[p][0] = fmaf(xv, wr[k][0], acc[p][0]);
              acc[p][1] = fmaf(xv, wr[k][1], acc[p][1]);
            }
#pragma unroll
      for (int p = 0; p < n; ++p) {
        const int hx = q + p;
        const int gx = tc.x0 - 1 + hx;
        uint32_t v = 0u;
        if (gx >= 0 && gx < w) {
          const __nv_bfloat162 b2v =
              __floats2bfloat162_rn(fmaxf(acc[p][0] + br[0], 0.f),
                                    fmaxf(acc[p][1] + br[1], 0.f));
          v = *reinterpret_cast<const uint32_t*>(&b2v);
        }
        *reinterpret_cast<uint32_t*>(buf + swz(hy * kHalo + hx, cp >> 2) +
                                     lane_off) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    stem_fused_kernel(const float* __restrict__ x,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ wpk,
                      const float* __restrict__ b2, int batch, int h, int w,
                      float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* xs = reinterpret_cast<float*>(smem + kXsOff);
  block_setup(smem, wpk, kProducerThreads);
  const int ntx = (w + kTile - 1) / kTile;
  const int nty = (h + kTile - 1) / kTile;
  const int ntiles = batch * nty * ntx;

  if (threadIdx.x >= kConsumerThreads) {        // the producer warpgroup
    const int tid = threadIdx.x - kConsumerThreads;
    const int cp = tid & 31;
    float wr[27][2], br[2];
#pragma unroll
    for (int k = 0; k < 27; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        wr[k][e] = bf16_round(w1[k * kC + 2 * cp + e]);
    br[0] = b1[2 * cp];
    br[1] = b1[2 * cp + 1];
    float r[kPatchPerThread];
    uint32_t inside;
    int t = blockIdx.x;
    load_patch(r, inside, x, tile_coord(t, ntx, nty), h, w, tid);
    store_patch(r, inside, xs, tid);
    producer_sync();
    for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
      const int next = t + gridDim.x;
      if (next < ntiles)          // in flight while this tile's a1 is made
        load_patch(r, inside, x, tile_coord(next, ntx, nty), h, w, tid);
      producer_acquire(smem, it);
      conv1_1_tile(smem + kBufOff + (it & 1) * kBufBytes, xs, wr, br,
                   tile_coord(t, ntx, nty), h, w, tid >> 5, cp);
      mbar_arrive(full_bar(smem, it & 1));
      producer_sync();            // every thread is done with xs
      if (next < ntiles) store_patch(r, inside, xs, tid);
      producer_sync();
    }
  } else {
    consumer_loop(smem, b2, ntx, nty, ntiles, h / 2, w / 2, out);
  }
}

}  // namespace

extern "C" {

// x [batch, h, w, 3] f32 NHWC, w1 [3, 3, 3, 64] f32 HWIO, b1 and b2 [64]
// f32, wpk [9, 64, 64] bf16 (tap, c_out, c_in: ops/conv2_pool.py:
// pack_conv2_weights_bf16), out [batch, h/2, w/2, 64] f32; h and w even.
// Launches on `stream`, does not synchronise, returns the cudaError_t of
// the launch.
int wssdl_vgg_stem_fused(const float* x, const float* w1, const float* b1,
                         const void* wpk, const float* b2, int batch, int h,
                         int w, float* out, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (h % 2 || w % 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = batch * ((h + kTile - 1) / kTile) *
                     ((w + kTile - 1) / kTile);
  stem_fused_kernel<<<persistent_grid(ntiles), kThreads, kSmemBytes,
                      stream>>>(x, w1, b1,
                                reinterpret_cast<const __nv_bfloat16*>(wpk),
                                b2, batch, h, w, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
