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
//
// ---------------------------------------------------------------------------
// Backward (roi_pool_bwd_kernel, after roi_rows_active_kernel): the VJP of
// the pool with respect to feat.  Replaces the TPU kernel
// wssdl_bus_tpu/ops/roi_pool_pallas.py:_bwd_kernel (reached from
// roi_pool_fc's f32 VJP, _fc_vjp_bwd) and computes what it computes, which
// is not what amax's autograd computes:
//   * for a non-empty bin (i, j) and channel c, w* is the first column of
//     the bin whose column maximum (over the bin's rows) equals the bin
//     maximum, h* the first row of the bin attaining that column maximum;
//     g[r, i, j, c] goes to dfeat[b, h*, w*, c] whole; empty bins add
//     nothing;
//   * a ROI whose whole cotangent row is zero adds nothing and is skipped
//     (in the weak group only the MIL-selected ROI of each bag has a
//     nonzero row: about 1 of 2000).
// Bins of one ROI overlap by a row or column under the "gpu" edges, and
// ROIs overlap each other, so contributions meet on cells.  The design is
// deterministic instead of atomic: one block owns the slice (image b,
// channels 4*cg .. 4*cg+3) of dfeat in shared memory, walks the active ROIs
// in ascending order and adds in the Pallas kernel's order (bin rows i
// ascending; within a row, the cotangents of bins sharing a column summed
// in j order first).  The result equals the plain version
// (ops/roi_pool.py:roi_pool_grad) bit for bit.
//
// What bounds it: reading the cotangent.  Finding the zero rows reads all
// of it once, 2000 x 49 x 512 x 4 B = 200 MB per weak image, in a separate
// coalesced pass (roi_rows_active_kernel, one block per ROI row); the
// scatter then reads only the active rows, the feature cells of their bins
// (from L2: a 38 x 51 x 512 map is 4 MB) and writes dfeat once.
//
// ---------------------------------------------------------------------------
// The bf16 output option (roi_pool_fc(..., out_dtype=bfloat16)): instances
// of the same three kernels on other element types, no new design.
//   * Forward: the output is bf16(max(feat)); rounding is monotone, so it
//     commutes with max and the f32 forward rounds at the store (to
//     nearest, ties to even, as torch's and XLA's casts).  Half the bytes
//     written: 0.04 ms of its 0.08 ms bound at the served batch.
//   * Backward: replaces wssdl_bus_tpu/ops/roi_pool_pallas.py:
//     _fc_bwd_kernel (the VJP of the bf16 output, reached through
//     _fc_vjp_bwd) and computes what it computes: the active-row pass and
//     the walk read the bf16 cotangent (upcast exactly in register; a row is
//     active when any 16-bit value has a nonzero exponent or mantissa, i.e.
//     != 0 or NaN); the argmax routing ranks bf16(feat), rounded in register
//     from the f32 map, so the ties rounding creates go to the first column,
//     then the first row, as in the f32 kernel; dfeat accumulates in f32.
//     _fc_bwd_kernel's placement and order of sums are _bwd_kernel's (both
//     take the first argmax column of each bin's column maxima, sum the
//     cotangents of a bin row's bins that share a column in j order, then
//     add that sum at the column's first max row), so the f32 kernel's walk
//     serves unchanged.  What bounds it: reading the cotangent, now half the
//     bytes (200.7 MB for the weak group of a combined step).

#include <cuda_bf16.h>
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

// Four channels in the output / cotangent element type: float4 (f32) or
// uint2 (four bf16, element 0 in the low half of .x).
__device__ __forceinline__ float4 to_float4(float4 v) { return v; }

__device__ __forceinline__ float4 to_float4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void from_float4(float4 m, float4* out) {
  *out = m;
}

__device__ __forceinline__ void from_float4(float4 m, uint2* out) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(m.x, m.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(m.z, m.w);
  *out = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                    *reinterpret_cast<const unsigned*>(&hi));
}

__device__ __forceinline__ bool any_nonzero(float4 v) {
  return (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
}

__device__ __forceinline__ bool any_nonzero(uint2 v) {
  return ((v.x | v.y) & 0x7fff7fffu) != 0u;   // != +-0, NaN included
}

// bf16(v) in f32, to nearest, ties to even; the identity for kRound false.
template <bool kRound>
__device__ __forceinline__ float4 route_value(float4 v) {
  if (!kRound) return v;
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

template <typename OutVec>
__global__ void roi_pool_fwd_kernel(const float4* __restrict__ feat,
                                    const float* __restrict__ rois, int p,
                                    int h, int w, int c4, int pooled_h,
                                    int pooled_w, float spatial_scale,
                                    int flavor, OutVec* __restrict__ out) {
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
  OutVec* ob = out + ((size_t)bp * pooled_h * pooled_w + bin) * c4;
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
    from_float4(m, ob + c);
  }
}

// One block per cotangent row (b * p + roi): active[row] = 1 if any of
// its `row4` four-channel vectors has a nonzero (or NaN) entry.
template <typename GVec>
__global__ void roi_rows_active_kernel(const GVec* __restrict__ g, int row4,
                                       int* __restrict__ active) {
  const GVec* row = g + (size_t)blockIdx.x * row4;
  int any = 0;
  for (int k = threadIdx.x; k < row4; k += blockDim.x)
    any |= any_nonzero(row[k]);
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) active[blockIdx.x] = any;
}

// Grid (c4, batch): block (cg, b) owns dfeat[b, :, :, 4cg .. 4cg+3].
// blockDim.x is a multiple of 32 and at most 1024.
// Dynamic shared memory: the owned slice [h * w] float4, then for a batch
// of `rb` ROIs x `nb` bins the chosen cell of each lane (int4, -1 = empty
// bin) and its cotangent (float4), then the compacted ROI list.
// GVec: the cotangent's element type; kRound: rank bf16(feat) (the bf16
// output's VJP) instead of feat.
template <typename GVec, bool kRound>
__global__ void roi_pool_bwd_kernel(const float4* __restrict__ feat,
                                    const float* __restrict__ rois,
                                    const GVec* __restrict__ g,
                                    const int* __restrict__ active, int p,
                                    int h, int w, int c4, int pooled_h,
                                    int pooled_w, float spatial_scale,
                                    int flavor, int rb,
                                    float4* __restrict__ dfeat) {
  extern __shared__ float4 smem[];
  const int cg = blockIdx.x;
  const int b = blockIdx.y;
  const int hw = h * w;
  const int nb = pooled_h * pooled_w;
  float* acc = reinterpret_cast<float*>(smem);                 // [hw][4]
  int4* pos = reinterpret_cast<int4*>(smem + hw);              // [rb * nb]
  float4* gv = smem + hw + rb * nb;                            // [rb * nb]
  int* list = reinterpret_cast<int*>(smem + hw + 2 * rb * nb); // [blockDim]
  __shared__ int n_list;
  __shared__ int warp_n[32];

  for (int k = threadIdx.x; k < hw; k += blockDim.x)
    smem[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float4* fb = feat + (size_t)b * hw * c4 + cg;
  for (int base = 0; base < p; base += blockDim.x) {
    // compact this chunk's active ROIs, in ascending order
    const int r_mine = base + threadIdx.x;
    const int is_active = r_mine < p && active[(size_t)b * p + r_mine];
    const unsigned ballot = __ballot_sync(0xffffffffu, is_active);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
        const int m = warp_n[k];
        warp_n[k] = n;
        n += m;
      }
      n_list = n;
    }
    __syncthreads();
    if (is_active)
      list[warp_n[warp] + __popc(ballot & ((1u << lane) - 1u))] = r_mine;
    __syncthreads();
    const int n_act = n_list;
    for (int k0 = 0; k0 < n_act; k0 += rb) {
      // phase 1: each thread finds one (ROI, bin)'s cells for 4 channels
      const int t = threadIdx.x;
      const int slot = t / nb;
      if (slot < rb && k0 + slot < n_act) {
        const int bin = t - slot * nb;
        const int r = list[k0 + slot];
        const size_t bp = (size_t)b * p + r;
        const float* roi = rois + bp * 4;
        const int rsw = quantize(roi[0], spatial_scale);
        const int rsh = quantize(roi[1], spatial_scale);
        const int rew = quantize(roi[2], spatial_scale);
        const int reh = quantize(roi[3], spatial_scale);
        const int roi_w = max(rew - rsw + 1, 1);
        const int roi_h = max(reh - rsh + 1, 1);
        const int i = bin / pooled_w;
        const int j = bin - i * pooled_w;
        int hlo, hhi, wlo, whi;
        bin_edges(i, rsh, roi_h, pooled_h, h, flavor, &hlo, &hhi);
        bin_edges(j, rsw, roi_w, pooled_w, w, flavor, &wlo, &whi);
        int4 cell = make_int4(-1, -1, -1, -1);
        if (hhi > hlo && whi > wlo) {
          float4 best = make_float4(0.f, 0.f, 0.f, 0.f);
          int4 bh = make_int4(0, 0, 0, 0), bw = bh;
          for (int x = wlo; x < whi; ++x) {
            // column max over the bin's rows, and its first row
            float4 cm =
                route_value<kRound>(fb[((size_t)hlo * w + x) * c4]);
            int4 ch = make_int4(hlo, hlo, hlo, hlo);
            for (int y = hlo + 1; y < hhi; ++y) {
              const float4 v =
                  route_value<kRound>(fb[((size_t)y * w + x) * c4]);
              if (v.x > cm.x) { cm.x = v.x; ch.x = y; }
              if (v.y > cm.y) { cm.y = v.y; ch.y = y; }
              if (v.z > cm.z) { cm.z = v.z; ch.z = y; }
              if (v.w > cm.w) { cm.w = v.w; ch.w = y; }
            }
            // the first column whose max is the bin max
            const bool first = x == wlo;
            if (first || cm.x > best.x) {
              best.x = cm.x; bh.x = ch.x; bw.x = x;
            }
            if (first || cm.y > best.y) {
              best.y = cm.y; bh.y = ch.y; bw.y = x;
            }
            if (first || cm.z > best.z) {
              best.z = cm.z; bh.z = ch.z; bw.z = x;
            }
            if (first || cm.w > best.w) {
              best.w = cm.w; bh.w = ch.w; bw.w = x;
            }
          }
          cell = make_int4(bh.x * w + bw.x, bh.y * w + bw.y,
                           bh.z * w + bw.z, bh.w * w + bw.w);
        }
        pos[t] = cell;
        gv[t] = to_float4(g[(bp * nb + bin) * c4 + cg]);
      }
      __syncthreads();
      // phase 2: one thread per channel adds in the Pallas kernel's order
      if (threadIdx.x < 4) {
        const int lane = threadIdx.x;
        const int* pl = reinterpret_cast<const int*>(pos);
        const float* gl = reinterpret_cast<const float*>(gv);
        const int n_slots = min(rb, n_act - k0);
        for (int s = 0; s < n_slots; ++s) {
          for (int i = 0; i < pooled_h; ++i) {
            const int row0 = s * nb + i * pooled_w;
            unsigned done = 0;
            for (int j = 0; j < pooled_w; ++j) {
              if (done & (1u << j)) continue;
              const int cj = pl[(row0 + j) * 4 + lane];
              if (cj < 0) continue;
              float sum = gl[(row0 + j) * 4 + lane];
              for (int j2 = j + 1; j2 < pooled_w; ++j2) {
                if (pl[(row0 + j2) * 4 + lane] == cj) {
                  sum += gl[(row0 + j2) * 4 + lane];
                  done |= 1u << j2;
                }
              }
              acc[cj * 4 + lane] += sum;
            }
          }
        }
      }
      __syncthreads();
    }
  }
  float4* ob = dfeat + (size_t)b * hw * c4 + cg;
  for (int k = threadIdx.x; k < hw; k += blockDim.x)
    ob[(size_t)k * c4] = smem[k];
}

// The forward on OutVec's element type; see wssdl_roi_pool_fwd.
template <typename OutVec>
int launch_forward(const float* feat, const float* rois, int batch, int h,
                   int w, int c, int p, int pooled_h, int pooled_w,
                   float spatial_scale, int flavor, void* out,
                   cudaStream_t stream) {
  if (batch <= 0 || p <= 0) return 0;
  const int c4 = c / 4;
  int threads = ((c4 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const dim3 grid(batch * p, pooled_h * pooled_w);
  roi_pool_fwd_kernel<OutVec><<<grid, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(feat), rois, p, h, w, c4, pooled_h,
      pooled_w, spatial_scale, flavor, reinterpret_cast<OutVec*>(out));
  return (int)cudaGetLastError();
}

// The backward for a GVec cotangent; see wssdl_roi_pool_bwd.
template <typename GVec, bool kRound>
int launch_backward(const float* feat, const float* rois, const void* g,
                    int batch, int h, int w, int c, int p, int pooled_h,
                    int pooled_w, float spatial_scale, int flavor,
                    int* active, float* dfeat, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  if (pooled_w > 32) return (int)cudaErrorInvalidValue;
  const int c4 = c / 4;
  const int nb = pooled_h * pooled_w;
  const int threads = 256;
  const int rb = threads / nb;
  if (rb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)h * w + 2 * (size_t)rb * nb) * sizeof(float4)
                      + threads * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      roi_pool_bwd_kernel<GVec, kRound>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const GVec* gv = reinterpret_cast<const GVec*>(g);
  if (p > 0) {
    roi_rows_active_kernel<GVec><<<batch * p, 256, 0, stream>>>(gv, nb * c4,
                                                               active);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(c4, batch);
  roi_pool_bwd_kernel<GVec, kRound><<<grid, threads, smem, stream>>>(
      reinterpret_cast<const float4*>(feat), rois, gv, active, p, h, w, c4,
      pooled_h, pooled_w, spatial_scale, flavor, rb,
      reinterpret_cast<float4*>(dfeat));
  return (int)cudaGetLastError();
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
  return launch_forward<float4>(feat, rois, batch, h, w, c, p, pooled_h,
                                pooled_w, spatial_scale, flavor, out, stream);
}

// The same with a bf16 out (8-byte aligned).
int wssdl_roi_pool_fwd_bf16(const float* feat, const float* rois, int batch,
                            int h, int w, int c, int p, int pooled_h,
                            int pooled_w, float spatial_scale, int flavor,
                            void* out, cudaStream_t stream) {
  return launch_forward<uint2>(feat, rois, batch, h, w, c, p, pooled_h,
                               pooled_w, spatial_scale, flavor, out, stream);
}

// The backward.  feat [batch, h, w, c] and rois as for the forward, g the
// cotangent [batch, p, pooled_h, pooled_w, c] f32 (16-byte aligned), active
// an int scratch of batch * p entries, dfeat [batch, h, w, c] f32 (16-byte
// aligned; every element is written).  pooled_w <= 32.  Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launches
// (cudaErrorInvalidValue when the owned dfeat slice does not fit in shared
// memory).
int wssdl_roi_pool_bwd(const float* feat, const float* rois, const float* g,
                       int batch, int h, int w, int c, int p, int pooled_h,
                       int pooled_w, float spatial_scale, int flavor,
                       int* active, float* dfeat, cudaStream_t stream) {
  return launch_backward<float4, false>(feat, rois, g, batch, h, w, c, p,
                                        pooled_h, pooled_w, spatial_scale,
                                        flavor, active, dfeat, stream);
}

// The backward of the bf16 output: g bf16 (8-byte aligned), routing on
// bf16(feat) (feat stays f32), dfeat f32.
int wssdl_roi_pool_bwd_bf16(const float* feat, const float* rois,
                            const void* g, int batch, int h, int w, int c,
                            int p, int pooled_h, int pooled_w,
                            float spatial_scale, int flavor, int* active,
                            float* dfeat, cudaStream_t stream) {
  return launch_backward<uint2, true>(feat, rois, g, batch, h, w, c, p,
                                      pooled_h, pooled_w, spatial_scale,
                                      flavor, active, dfeat, stream);
}

}  // extern "C"
