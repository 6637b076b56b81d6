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
// Order of sums: each output's taps (dy, dx, c) ascending from 0.0, then
// the bias, then the ReLU; the plain version ops/conv1.py:vgg_stem_plain
// sums in the same order, so the two agree bit for bit (vgg_stem.cuh).
//
// What bounds it: operations.  2 * B * H * W * 64 * (27 + 576) flops, 306
// GFLOP at the served batch of 8 at 608 x 816: 0.31 ms at the H100's 989
// TFLOP/s of dense bf16 on the tensor cores, against 0.09 ms to move x in
// and the pooled output out.  This first kernel runs the products as f32
// FMAs on the SIMT cores (67 TFLOP/s peak), which keeps one fixed order of
// sums and so the bit-exact contract; the tensor-core design (wgmma) is a
// later PR's.  Its design keeps everything but x and the pooled output out
// of device memory: one block per 16 x 16 tile of conv1_2 outputs stages
// the 20 x 20 x 3 input patch, computes the 18 x 18 x 64 conv1_1 tile into
// shared memory in bf16 (exact: the values are rounded to bf16 anyway),
// then runs conv1_2 + pool from shared memory (vgg_stem.cuh), each thread
// holding 2 x 2 outputs x 16 channels in registers.

#include "vgg_stem.cuh"

namespace {

using namespace vgg_stem;

constexpr int kIn = kTile + 4;   // input patch side: 2 halo pixels a side

__global__ void __launch_bounds__(kThreads, 2)
    stem_fused_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2, int h, int w,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a1s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ws = reinterpret_cast<float*>(smem + kA1Bytes);
  // while conv1_1 runs, ws holds the input patch and the conv1_1 kernel
  float* xs = ws;                          // [kIn][kIn][3]
  float* w1s = ws + kIn * kIn * 3;         // [27][64]
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile;       // first conv1_2 output row
  const int x0 = blockIdx.x * kTile;

  // the input patch: rows y0-2 .. y0+17, columns x0-2 .. x0+17, in bf16
  for (int k = threadIdx.x; k < kIn * kIn * 3; k += kThreads) {
    const int r = k / (kIn * 3);
    const int rem = k - r * kIn * 3;
    const int c = rem / 3;
    const int ch = rem - c * 3;
    const int gy = y0 - 2 + r;
    const int gx = x0 - 2 + c;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = bf16_round(x[(((size_t)b * h + gy) * w + gx) * 3 + ch]);
    xs[k] = v;
  }
  for (int k = threadIdx.x; k < 27 * kC; k += kThreads)
    w1s[k] = bf16_round(w1[k]);
  __syncthreads();

  // conv1_1 over the 18 x 18 halo tile; 0 outside the image
  for (int k = threadIdx.x; k < kHalo * kHalo * kC; k += kThreads) {
    const int co = k & (kC - 1);
    const int pix = k >> 6;
    const int r = pix / kHalo;
    const int c = pix - r * kHalo;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + c;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      float acc = 0.f;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            acc = fmaf(xs[((r + dy) * kIn + c + dx) * 3 + ci],
                       w1s[((dy * 3 + dx) * 3 + ci) * kC + co], acc);
      v = fmaxf(acc + b1[co], 0.f);
    }
    a1s[co * kHalo * kHalo + pix] = __float2bfloat16_rn(v);
  }

  conv12_pool(a1s, ws, w2, b2, b, blockIdx.y * kPooled,
              blockIdx.x * kPooled, h / 2, w / 2, out);
}

}  // namespace

extern "C" {

// x [batch, h, w, 3] f32 NHWC, w1 [3, 3, 3, 64] and w2 [3, 3, 64, 64] f32
// HWIO, b1 and b2 [64] f32, out [batch, h/2, w/2, 64] f32 (16-byte
// aligned); h and w even.  Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch.
int wssdl_vgg_stem_fused(const float* x, const float* w1, const float* b1,
                         const float* w2, const float* b2, int batch, int h,
                         int w, float* out, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  if (h % 2 || w % 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kStemSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  stem_fused_kernel<<<grid, kThreads, kStemSmemBytes, stream>>>(
      x, w1, b1, w2, b2, h, w, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
