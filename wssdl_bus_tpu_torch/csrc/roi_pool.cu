// ROI max pooling forward, written as the flat fc6 operand, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel wssdl_bus_tpu/ops/roi_pool_pallas.py:_fc_fwd_kernel
// (public wrappers roi_pool_fc_image / roi_pool_fc), and is the counterpart
// of _fwd_kernel (roi_pool_image / roi_pool_grouped) as well: the output
// [B, P, Ph, Pw, C] is contiguous NHWC, so the flat [B, P, Ph*Pw*C] operand
// is a free view of the same bytes.
//
// Semantics, exactly those of ops/roi_pool_pallas.py:49-81 and the plain
// version wssdl_bus_tpu_torch/ops/roi_pool.py:roi_pool:
//   * ROI corners quantised as q = floor(v * scale + 0.5) in f32;
//   * roi_w = max(rew - rsw + 1, 1), the same for h;
//   * bin k along an axis spans [lo, hi) with
//       lo = (k * size) / pooled + start
//       hi = ((k + 1) * size + pooled - 1) / pooled + start   ("gpu", 0)
//       hi = ((k + 1) * size) / pooled + start                ("cpu", 1)
//     both clipped to [0, limit];
//   * an empty bin writes 0.
// Max is exact, so the result equals the plain version bit for bit.
//
// What bounds it: the output.  At P = 300 ROIs, 7 x 7 bins and C = 512 an
// image writes 300 * 49 * 512 * 4 B = 30.1 MB and reads a 38 x 51 x 512 f32
// map (4 MB) that stays in L2, so the kernel is bound by device-memory
// bandwidth on its writes.
//
// Design: the Pallas kernel pools separably (rows, then columns) because
// Mosaic only slices unaligned windows along untiled axes.  On the card the
// bin window is just a loop: one block per (ROI, bin), threads over
// channels.  With C % 4 == 0 each thread owns a float4 of channels, so a warp
// reads 512 contiguous bytes of one feature cell and writes 512 contiguous
// bytes of the output row: every access is a full 16-byte-per-thread,
// coalesced transaction.  The ROI's quantisation and bin edges are a few
// integer operations each block recomputes from the ROI row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ int quantize(float v, float scale) {
  return (int)floorf(__fadd_rn(__fmul_rn(v, scale), 0.5f));
}

// Bin k's [lo, hi) along one axis, clipped to [0, limit].  k, size and
// pooled are non-negative (size >= 1), so every operand of the integer
// divisions is non-negative and C's truncation equals Python's floor.
__device__ __forceinline__ void bin_edges(int k, int start, int size,
                                          int pooled, int limit, int flavor,
                                          int* lo, int* hi) {
  int l = (k * size) / pooled + start;
  int h = flavor == 0 ? ((k + 1) * size + pooled - 1) / pooled + start
                      : ((k + 1) * size) / pooled + start;
  *lo = min(max(l, 0), limit);
  *hi = min(max(h, 0), limit);
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

__global__ void roi_pool_fwd_kernel(const float4* __restrict__ feat,
                                    const float* __restrict__ rois, int p,
                                    int h, int w, int c4, int pooled_h,
                                    int pooled_w, float spatial_scale,
                                    int flavor, float4* __restrict__ out) {
  const int bp = blockIdx.x;   // b * p + roi
  const int bin = blockIdx.y;  // i * pooled_w + j
  const int b = bp / p;
  const int i = bin / pooled_w;
  const int j = bin - i * pooled_w;

  const float* roi = rois + (size_t)bp * 4;
  const int rsw = quantize(roi[0], spatial_scale);
  const int rsh = quantize(roi[1], spatial_scale);
  const int rew = quantize(roi[2], spatial_scale);
  const int reh = quantize(roi[3], spatial_scale);
  const int roi_w = max(rew - rsw + 1, 1);
  const int roi_h = max(reh - rsh + 1, 1);
  int hlo, hhi, wlo, whi;
  bin_edges(i, rsh, roi_h, pooled_h, h, flavor, &hlo, &hhi);
  bin_edges(j, rsw, roi_w, pooled_w, w, flavor, &wlo, &whi);
  const bool empty = hhi <= hlo || whi <= wlo;

  const float4* fb = feat + (size_t)b * h * w * c4;
  float4* ob = out + ((size_t)bp * pooled_h * pooled_w + bin) * c4;
  for (int c = threadIdx.x; c < c4; c += blockDim.x) {
    float4 m;
    if (empty) {
      m = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      m = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      for (int y = hlo; y < hhi; ++y) {
        const float4* row = fb + (size_t)y * w * c4 + c;
        for (int x = wlo; x < whi; ++x) m = max4(m, row[(size_t)x * c4]);
      }
    }
    ob[c] = m;
  }
}

}  // namespace

extern "C" {

// feat [batch, h, w, c] f32 NHWC (c % 4 == 0, 16-byte aligned), rois
// [batch, p, 4] f32 (x1, y1, x2, y2 in input-image pixels; ROI r of image b
// pools against image b), out [batch, p, pooled_h, pooled_w, c] f32
// (16-byte aligned).  flavor 0 = "gpu" bin edges, 1 = "cpu".  Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch.
int wssdl_roi_pool_fwd(const float* feat, const float* rois, int batch, int h,
                       int w, int c, int p, int pooled_h, int pooled_w,
                       float spatial_scale, int flavor, float* out,
                       cudaStream_t stream) {
  if (batch <= 0 || p <= 0) return 0;
  const int c4 = c / 4;
  int threads = ((c4 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const dim3 grid(batch * p, pooled_h * pooled_w);
  roi_pool_fwd_kernel<<<grid, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(feat), rois, p, h, w, c4, pooled_h,
      pooled_w, spatial_scale, flavor, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
