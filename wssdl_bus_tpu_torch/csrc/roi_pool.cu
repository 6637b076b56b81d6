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
//   * an empty bin writes +0;
//   * a NaN in a bin's window makes the bin NaN (max.NaN), as torch.amax
//     and jnp.max do.
// Max is exact, so the result equals the plain version bit for bit.
//
// What bounds it: the output.  At P = 300 ROIs, 7 x 7 bins and C = 512 an
// image writes 300 * 49 * 512 * 4 B = 30.1 MB and reads a 38 x 51 x 512 f32
// map (4 MB), so the kernel is bound by device-memory bandwidth on its
// writes.  Bins overlap (the "gpu" edges share a row or column between
// neighbours) and ROIs overlap each other: summed over its 49 bins a served
// ROI's windows cover ~170 cells, not the ~51 of its own area, so a design
// that reads every window from global memory moves ~3.5x the output's bytes
// through L2 (the first design: one block per (ROI, bin)).
//
// Design (the shared-memory path): grid (channel slice, ROI block, image).
// A block stages feat[b, :, :, c0 : c0 + cs] into shared memory with TMA
// (a 4-D tensor map over [B, H, W, C], one request per box of at most 256
// rows and columns, all completing on one mbarrier), computes its ROIs'
// quantised bin edges once into shared memory meanwhile, then one thread
// per (ROI, bin, 4 channels) takes the max over the window from shared
// memory and stores 16 bytes (8 for bf16).  The wrapper
// (ops/roi_pool_cuda.py:forward_plan) picks cs = 16 channels (64-byte
// cells: 124 KB at the served 38 x 51 map) where the slice fits the 227 KB
// a block may use, else 8, then 4; a last slice past C is zero-filled by TMA
// and never read.  Each window cell then leaves L2 once per (ROI block,
// slice) instead of once per bin covering it.  With the window in shared
// memory the loop over it, not the stores, is what is left: a block of 16
// channels holds its SM alone, and each cell's load is a shared-memory
// round trip with bank conflicts (two 64-byte cells a phase).  So a block
// runs 1024 threads, its index math divides by constants only (7 x 7
// bins, kVS vectors a slice), the window is walked four loads at a time,
// and blocks are few: each stages its whole slice, so the ROIs are cut
// into about one wave of blocks.
//
// Maps whose 4-channel slice does not fit (H * W above ~14,500 cells) take
// the direct path: the first design, one block per (ROI, bin), threads over
// channels, the window read from global memory.  The wrapper picks the
// path by shape alone.
//
// ---------------------------------------------------------------------------
// Backward: the VJP of the pool with respect to feat.  Replaces the TPU
// kernel wssdl_bus_tpu/ops/roi_pool_pallas.py:_bwd_kernel (reached from
// roi_pool_fc's f32 VJP, _fc_vjp_bwd) and computes what it computes, which
// is not what amax's autograd computes:
//   * for a non-empty bin (i, j) and channel c, w* is the first column of
//     the bin whose column maximum (over the bin's rows) equals the bin
//     maximum, h* the first row of the bin attaining that column maximum;
//     g[r, i, j, c] goes to dfeat[b, h*, w*, c] whole; empty bins add
//     nothing.  That holds while the bin row's window (the h / 7 + 2 map
//     rows from min(lo, h - span) the Pallas kernels read, masked by adding
//     -1e30 outside the bin) holds no NaN and no value past +-2^96.  Where
//     it does, the routing is the Pallas kernels' literally: per column the
//     first NaN-or-max row of the window, then over all w columns the first
//     NaN-or-max (jnp.argmax takes the first NaN): a NaN takes the bin's
//     cotangent wherever it lies in the window, outside the bin or the ROI.
//     An empty bin's non-finite cotangent (times 0: NaN) lands likewise.
//     A first pass flags the map rows that hold such values; only the bin
//     rows whose window holds one pay for the wide routing and gather;
//   * a ROI whose whole cotangent row is zero adds nothing and is skipped
//     (in the weak group only the MIL-selected ROI of each bag has a
//     nonzero row: about 1 of 2000); the f32 kernel skips it per channel
//     block of 256 channels, also where the block holds a NaN (the Pallas
//     kernel's sum(|g|) > 0 is then false);
//   * the order of sums, per cell: ROIs ascending; within a ROI, bin rows i
//     ascending; within a row, the cotangents of the bins whose chosen cell
//     it is, summed in j order first (ops/roi_pool.py:roi_pool_grad).
// Bins of one ROI overlap by a row or column under the "gpu" edges, and
// ROIs overlap each other, so contributions meet on cells.
//
// What bounds it: reading the cotangent (401 MB f32 for the weak group of
// a combined step, 0.12 ms) and, for the active rows, reading their window
// cells (feat stays in L2: a 38 x 56 x 512 map is 4.4 MB) and writing
// dfeat once.  Its Pallas form carries dfeat in VMEM across a sequential
// grid, and its first port walked the ROIs serially in one block per
// (image, 4 channels): 128 blocks, the sums on 4 threads of 256.  This
// design is a deterministic gather in four launches, exact by construction,
// no atomics on the sums, every one parallel over thousands of threads:
//   1. roi_rows_scan_kernel: one block per cotangent row flags the rows
//      (and the f32 channel blocks) to list: the coalesced read of all of
//      g; one block per map row flags the rows that hold a NaN;
//   2. roi_rows_compact_kernel: one block compacts the flagged rows into an
//      ascending list with each image's first position, on the device, so
//      the later passes see a dense list without a host sync;
//   3. roi_argmax_kernel: over (listed row, bin) items, grid-stride, threads
//      over channels (a warp reads a window cell as 512 contiguous bytes),
//      the chosen cell of each (row, bin, channel) into a table (int16 cell
//      indices where h * w fits: 200 MB at most for the weak group);
//   4. roi_gather_kernel: over (2 x 4 cell tile, 128 channels, image); the
//      block compacts the listed rows whose bins overlap its tile, then a
//      warp per cell walks them in order and adds, per bin row holding the
//      cell, the j-ordered sum of the cotangents of the bins that chose it
//      to a register accumulator: roi_pool_grad's order for that cell.
//      dfeat is written once, coalesced.
// The result equals the plain version bit for bit.
//
// ---------------------------------------------------------------------------
// The bf16 output option (roi_pool_fc(..., out_dtype=bfloat16)): instances
// of the same kernels on other element types, no new design.
//   * Forward: the output is bf16(max(feat)); rounding is monotone, so it
//     commutes with max and both forward paths round at the store (to
//     nearest, ties to even, as torch's and XLA's casts; a NaN stays NaN).
//     On the shared-memory path a thread keeps its 4 channels (an 8-byte
//     store; a 16-channel slice still writes whole 32-byte sectors):
//     with 8 a thread, a shared-memory phase of a warp's loads touches
//     twice the cells, and bank conflicts made the store slower.  Half
//     the bytes written.
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
//     add that sum at the column's first max row), so the f32 kernels'
//     passes serve unchanged.  What bounds it: reading the cotangent, now
//     half the bytes (200.7 MB for the weak group of a combined step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tma.cuh"

namespace {

// Largest h * w whose cell indices the backward's argmax table holds in
// int16 (-1 marks an empty bin).
constexpr int kShortCells = 32767;

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

// NaN-propagating max (PTX max.NaN, sm_80 and later); fmaxf drops a NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y), max_nan(a.z, b.z),
                     max_nan(a.w, b.w));
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

// bf16(v) in f32, to nearest, ties to even; the identity for kRound false.
template <bool kRound>
__device__ __forceinline__ float4 route_value(float4 v) {
  if (!kRound) return v;
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

// The first pass's tests of one cotangent vector, on the bits: any entry
// nonzero (NaN included), any not finite, any NaN.
struct GFlags {
  bool nonzero, nonfinite;
};

__device__ __forceinline__ GFlags gflags(float4 v) {
  const unsigned a = __float_as_uint(v.x) & 0x7fffffffu;
  const unsigned b = __float_as_uint(v.y) & 0x7fffffffu;
  const unsigned c = __float_as_uint(v.z) & 0x7fffffffu;
  const unsigned d = __float_as_uint(v.w) & 0x7fffffffu;
  return {(a | b | c | d) != 0u, max(max(a, b), max(c, d)) >= 0x7f800000u};
}

__device__ __forceinline__ GFlags gflags(uint2 v) {
  const unsigned e = 0x7f800000u, e16 = 0x7f80u;
  return {((v.x | v.y) & 0x7fff7fffu) != 0u,
          (v.x & e) == e || (v.x & e16) == e16 || (v.y & e) == e ||
              (v.y & e16) == e16};
}

__device__ __forceinline__ bool any_nan(float4 v) {
  return isnan(v.x) | isnan(v.y) | isnan(v.z) | isnan(v.w);
}

__device__ __forceinline__ bool all_finite(float4 v) {
  return isfinite(v.x) & isfinite(v.y) & isfinite(v.z) & isfinite(v.w);
}

// A map value near which the backward's routing may leave a bin: a NaN
// (the Pallas argmax takes the first NaN), or a value beyond +-2^96, where
// the -1e30 the Pallas kernels add outside a bin no longer ranks every
// outside cell below every inside one.
__device__ __forceinline__ bool routes_out(float4 v) {
  const float kLimit = 7.9228162514264338e28f;   // 2^96
  return any_nan(v) | (fabsf(v.x) > kLimit) | (fabsf(v.y) > kLimit) |
         (fabsf(v.z) > kLimit) | (fabsf(v.w) > kLimit);
}

// The direct path: one block per (ROI, bin), threads over four-channel
// vectors, the window read from global memory.
template <typename OutVec>
__global__ void roi_pool_fwd_direct_kernel(const float4* __restrict__ feat,
                                           const float* __restrict__ rois,
                                           int p, int h, int w, int c4,
                                           int pooled_h, int pooled_w,
                                           float spatial_scale, int flavor,
                                           OutVec* __restrict__ out) {
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

// ---- the forward's shared-memory path ---------------------------------
constexpr int kFwdThreads = 1024;
constexpr int kBoxMax = 256;     // a TMA box's largest dimension
constexpr int kPooled = 7;       // bins a side, every caller's

// How one image's channel slice is staged: TMA boxes of bh rows x bw
// columns x cs channels, nby down and nbx across, each into its own
// 128-byte aligned region of `region` bytes.  A map at most kBoxMax wide
// is cut into near-equal bands of whole rows (one box when it is at most
// kBoxMax tall); a wider one into a box per row, cut into near-equal
// pieces.  Cells of a box past the map's edge arrive as zeros and are never
// read.  ops/roi_pool_cuda.py:staged_tile_bytes mirrors this.
struct FwdTile {
  int bh, bw, nby, nbx, cell, region;
};

inline FwdTile fwd_tile(int h, int w, int cs) {
  FwdTile t;
  if (w <= kBoxMax) {
    t.nbx = 1;
    t.bw = w;
    t.nby = (h + kBoxMax - 1) / kBoxMax;
    t.bh = (h + t.nby - 1) / t.nby;
  } else {
    t.nby = h;
    t.bh = 1;
    t.nbx = (w + kBoxMax - 1) / kBoxMax;
    t.bw = (w + t.nbx - 1) / t.nbx;
  }
  t.cell = cs * 4;
  t.region = (t.bh * t.bw * t.cell + 127) / 128 * 128;
  return t;
}

// Dynamic shared memory: up to 128 bytes to align the base, the staged
// tile, the mbarrier (16 bytes), then each ROI's bin edges packed as
// lo | hi << 16: rows [rblk][kPooled], then columns [rblk][kPooled].
inline size_t fwd_smem_bytes(const FwdTile& t, int rblk) {
  return 128 + (size_t)t.nby * t.nbx * t.region + 16 +
         (size_t)rblk * 2 * kPooled * sizeof(unsigned);
}

// Byte offset of cell (y, x) in a tile of several boxes.
__device__ __forceinline__ int cell_offset(const FwdTile& t, int y, int x) {
  return ((y / t.bh) * t.nbx + x / t.bw) * t.region +
         ((y % t.bh) * t.bw + x % t.bw) * t.cell;
}

// Four channels of the output: f32, or bf16 rounded to nearest, ties to
// even (8 bytes).
__device__ __forceinline__ void store_out(float* o, float4 m) {
  *reinterpret_cast<float4*>(o) = m;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* o, float4 m) {
  from_float4(m, reinterpret_cast<uint2*>(o));
}

// Block (slice, ROI block, image): stages feat[b, :, :, c0 : c0 + cs]
// (one TMA request per box, thread 0), computes its ROIs' bin edges
// meanwhile, then walks (ROI, bin) pairs.  Thread t owns the four channels
// v = t % kVS of the slice (kVS = cs / 4; lanes past C in the last slice
// idle) and pairs t / kVS, t / kVS + kFwdThreads / kVS, ..., so kVS
// neighbouring threads store one (ROI, bin)'s 64 (f32) or 32 (bf16)
// contiguous bytes of a 16-channel slice, and every index is a constant
// division.  The window is walked in 2 x 2 steps whose second row and
// column are clamped to the window (max is idempotent: a cell read twice
// changes nothing), four independent loads in flight a step.  kOneBox: the
// tile is one box, cell (y, x) at (y * w + x) * cell.  Bins are kPooled x
// kPooled; the wrapper sends other sizes to the direct path.
template <typename OutT, int kVS, bool kOneBox>
__global__ void __launch_bounds__(kFwdThreads)
    roi_pool_fwd_smem_kernel(const __grid_constant__ CUtensorMap feat_map,
                             const float* __restrict__ rois, int p, int h,
                             int w, int c, int rblk, float spatial_scale,
                             int flavor, FwdTile tile,
                             OutT* __restrict__ out) {
  constexpr int kNb = kPooled * kPooled;
  constexpr int kCs = kVS * 4;
  extern __shared__ unsigned char fwd_smem_raw[];
  const uint32_t raw = tma::smem_u32(fwd_smem_raw);
  unsigned char* tile_s = fwd_smem_raw + (((raw + 127u) & ~127u) - raw);
  const int nbox = tile.nby * tile.nbx;
  const int tile_bytes = nbox * tile.region;
  const uint32_t bar = tma::smem_u32(tile_s + tile_bytes);
  unsigned* hedge = reinterpret_cast<unsigned*>(tile_s + tile_bytes + 16);
  unsigned* wedge = hedge + rblk * kPooled;

  const int c0 = blockIdx.x * kCs;
  const int r0 = blockIdx.y * rblk;
  const int b = blockIdx.z;
  const int nr = min(rblk, p - r0);

  if (threadIdx.x == 0) {
    tma::mbar_init(bar, 1);
    tma::mbar_arrive_expect_tx(
        bar, (uint32_t)(nbox * tile.bh * tile.bw * tile.cell));
    for (int ky = 0; ky < tile.nby; ++ky)
      for (int kx = 0; kx < tile.nbx; ++kx)
        tma::load_4d(
            tma::smem_u32(tile_s + (ky * tile.nbx + kx) * tile.region),
            &feat_map, bar, c0, kx * tile.bw, ky * tile.bh, b);
  }
  for (int k = threadIdx.x; k < nr; k += kFwdThreads) {
    const float* roi = rois + ((size_t)b * p + r0 + k) * 4;
    const int rsw = quantize(roi[0], spatial_scale);
    const int rsh = quantize(roi[1], spatial_scale);
    const int roi_w = max(quantize(roi[2], spatial_scale) - rsw + 1, 1);
    const int roi_h = max(quantize(roi[3], spatial_scale) - rsh + 1, 1);
    int lo, hi;
    for (int i = 0; i < kPooled; ++i) {
      bin_edges(i, rsh, roi_h, kPooled, h, flavor, &lo, &hi);
      hedge[k * kPooled + i] = (unsigned)lo | ((unsigned)hi << 16);
      bin_edges(i, rsw, roi_w, kPooled, w, flavor, &lo, &hi);
      wedge[k * kPooled + i] = (unsigned)lo | ((unsigned)hi << 16);
    }
  }
  __syncthreads();            // the edges, and the barrier's init
  tma::mbar_wait(bar, 0);     // the tile

  const int v = threadIdx.x % kVS;
  if (c0 + v * 4 >= c) return;              // past C in the last slice
  const float4* fv = reinterpret_cast<const float4*>(tile_s) + v;
  auto cell = [&](int y, int x) {
    return kOneBox ? fv[(y * w + x) * kVS]
                   : fv[cell_offset(tile, y, x) / 16];
  };
  OutT* ov = out + ((size_t)b * p + r0) * kNb * c + c0 + v * 4;
  for (int kb = threadIdx.x / kVS; kb < nr * kNb;
       kb += kFwdThreads / kVS) {
    const int k = kb / kNb;
    const int bin = kb - k * kNb;
    const int i = bin / kPooled;
    const int j = bin - i * kPooled;
    const unsigned he = hedge[k * kPooled + i];
    const unsigned we = wedge[k * kPooled + j];
    const int hlo = he & 0xffffu, hhi = he >> 16;
    const int wlo = we & 0xffffu, whi = we >> 16;
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    if (hhi > hlo && whi > wlo) {
      m = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      for (int y = hlo; y < hhi; y += 2) {
        const int y1 = min(y + 1, hhi - 1);
        for (int x = wlo; x < whi; x += 2) {
          const int x1 = min(x + 1, whi - 1);
          m = max4(m, max4(max4(cell(y, x), cell(y, x1)),
                           max4(cell(y1, x), cell(y1, x1))));
        }
      }
    }
    store_out(ov + (size_t)kb * c, m);
  }
}

// Blocks a map row in the first pass: the map's read spread over as many
// blocks as the cotangent's, so neither part waits on the other.
constexpr int kMapParts = 4;

// The first pass, over the cotangent and the map.
// Blocks [0, rows), one per cotangent row q = b * p + roi:
//   * active[q] = 1 when the row is listed.  kBlocks (the f32 kernel,
//     _bwd_kernel): when a channel block of cb4 four-channel vectors has a
//     nonzero entry and no NaN (its sum(|g|) > 0), each such block flagged
//     in blk_active[q * nblk + blk]; channels past nblk blocks never count.
//     Else (bf16, _fc_bwd_kernel): when any entry is nonzero or NaN.
//   * gspec[q]: bit i set when an empty bin of bin row i has a non-finite
//     entry: g * 0 is then NaN, and the Pallas kernels add it at a cell
//     chosen over the bin row's whole window, outside the ROI.
// Blocks [rows, rows + batch * h * kMapParts), kMapParts a map row (b, y):
// rowflag[(b * h + y) * kMapParts + part] = 1 when that part of the row
// holds a value that routes_out (after route_value).
template <typename GVec, bool kBlocks, bool kRound>
__global__ void roi_rows_scan_kernel(const GVec* __restrict__ g,
                                     const float4* __restrict__ feat,
                                     const float* __restrict__ rois,
                                     int rows, int h, int w, int c4,
                                     int pooled_h, int pooled_w,
                                     float spatial_scale, int flavor,
                                     int cb4, int nblk,
                                     int* __restrict__ active,
                                     unsigned char* __restrict__ blk_active,
                                     int* __restrict__ gspec,
                                     int* __restrict__ rowflag) {
  __shared__ unsigned s_nz[32], s_nan[32];
  __shared__ unsigned long long s_nf[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x >= rows) {
    // kMapParts blocks a map row, each a contiguous part of it
    const int by = (blockIdx.x - rows) / kMapParts;
    const int part = (blockIdx.x - rows) % kMapParts;
    const int n = w * c4, k0 = n * part / kMapParts;
    const int k1 = n * (part + 1) / kMapParts;
    const float4* row = feat + (size_t)by * n;
    int any = 0;
#pragma unroll 4
    for (int k = k0 + tid; k < k1; k += blockDim.x)
      any |= routes_out(route_value<kRound>(row[k]));
    any = __syncthreads_or(any);
    if (tid == 0) rowflag[by * kMapParts + part] = any;
    return;
  }
  const int q = blockIdx.x;
  const int nb = pooled_h * pooled_w;
  const GVec* gr = g + (size_t)q * nb * c4;
  // nf: the bins with a non-finite entry (bit min(bin, 63)); which of them
  // are empty is worked out only when there is one
  unsigned nz = 0u, nan = 0u;
  unsigned long long nf = 0ull;
  // k = bin * c4 + cg, carried from one k to the next (k += blockDim.x)
  // without divisions; the channel block changes only when cg does (never
  // where c4 divides blockDim.x)
  const int step_bins = blockDim.x / c4, step_cg = blockDim.x % c4;
  int cg = tid % c4, bin = tid / c4;
  int blk = kBlocks ? cg / cb4 : 0;
#pragma unroll 4
  for (int k = tid; k < nb * c4; k += blockDim.x) {
    const GVec v = gr[k];
    const GFlags fl = gflags(v);
    const unsigned bit = 1u << blk;
    if (fl.nonzero) nz |= bit;
    if (fl.nonfinite) {
      nf |= 1ull << min(bin, 63);
      if (kBlocks && any_nan(to_float4(v))) nan |= bit;
    }
    cg += step_cg;
    bin += step_bins;
    if (cg >= c4) {
      cg -= c4;
      ++bin;
    }
    if (kBlocks && step_cg) blk = cg / cb4;
  }
  nz = __reduce_or_sync(0xffffffffu, nz);
  nan = __reduce_or_sync(0xffffffffu, nan);
  const unsigned nf_lo = __reduce_or_sync(0xffffffffu, (unsigned)nf);
  const unsigned nf_hi = __reduce_or_sync(0xffffffffu, (unsigned)(nf >> 32));
  if (lane == 0) {
    s_nz[warp] = nz;
    s_nan[warp] = nan;
    s_nf[warp] = (unsigned long long)nf_hi << 32 | nf_lo;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned act = 0u, nans = 0u;
    unsigned long long bins_nf = 0ull;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
      act |= s_nz[k];
      nans |= s_nan[k];
      bins_nf |= s_nf[k];
    }
    if (kBlocks) {
      act &= ~nans & ((1u << nblk) - 1u);
      for (int k = 0; k < nblk; ++k)
        blk_active[(size_t)q * nblk + k] = (act >> k) & 1u;
    }
    active[q] = act != 0u;
    int spec = 0;
    if (bins_nf) {
      const float* roi = rois + (size_t)q * 4;
      const int rsw = quantize(roi[0], spatial_scale);
      const int rsh = quantize(roi[1], spatial_scale);
      const int roi_w = max(quantize(roi[2], spatial_scale) - rsw + 1, 1);
      const int roi_h = max(quantize(roi[3], spatial_scale) - rsh + 1, 1);
      for (int b2 = 0; b2 < nb; ++b2) {
        if (!(bins_nf >> min(b2, 63) & 1ull)) continue;
        const int i = b2 / pooled_w, j = b2 - i * pooled_w;
        int hlo, hhi, wlo, whi;
        bin_edges(i, rsh, roi_h, pooled_h, h, flavor, &hlo, &hhi);
        bin_edges(j, rsw, roi_w, pooled_w, w, flavor, &wlo, &whi);
        if (hhi <= hlo || whi <= wlo) spec |= 1 << i;
      }
    }
    gspec[q] = spec;
  }
}

// One block of 1024 threads: the flagged rows of all images, compacted in
// ascending order into list[0 .. total), and img_start[b] = the position of
// image b's first listed row (img_start[batch] = total).  Launched even for
// p == 0, so that the later passes read valid counts without a host sync.
// Also, a warp per image, cnt[b * (h + 1) + y] = the number of map rows
// above y that rowflag marks, so a window's rows are tested in two reads.
__global__ void __launch_bounds__(1024)
    roi_rows_compact_kernel(const int* __restrict__ active, int batch, int p,
                            const int* __restrict__ rowflag, int h,
                            int* __restrict__ list,
                            int* __restrict__ img_start,
                            int* __restrict__ cnt) {
  __shared__ int warp_n[32];
  __shared__ int s_base, s_chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = batch * p;
  for (int b = warp; rows > 0 && b < batch; b += blockDim.x >> 5) {
    int run = 0;
    for (int y0 = 0; y0 < h; y0 += 32) {
      const int y = y0 + lane;
      int f = 0;
      for (int part = 0; y < h && part < kMapParts; ++part)
        f |= rowflag[(b * h + y) * kMapParts + part];
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (y < h) cnt[b * (h + 1) + y] = run + __popc(bal & ((1u << lane) - 1u));
      run += __popc(bal);
    }
    if (lane == 0) cnt[b * (h + 1) + h] = run;
  }
  if (tid == 0) s_base = 0;
  if (p == 0)
    for (int b = tid; b <= batch; b += blockDim.x) img_start[b] = 0;
  __syncthreads();
  for (int base = 0; base < rows; base += blockDim.x) {
    const int q = base + tid;
    const int a = q < rows && active[q];
    const unsigned bal = __ballot_sync(0xffffffffu, a);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
        const int m = warp_n[k];
        warp_n[k] = n;
        n += m;
      }
      s_chunk = n;
    }
    __syncthreads();
    const int pos = s_base + warp_n[warp] + __popc(bal & ((1u << lane) - 1u));
    if (a) list[pos] = q;
    if (q < rows && q % p == 0) img_start[q / p] = pos;
    __syncthreads();
    if (tid == 0) s_base += s_chunk;
  }
  __syncthreads();
  if (tid == 0 && p > 0) img_start[batch] = s_base;
}

// Four channels' chosen cells: int16 when every cell index h*w+x fits,
// else int32; -1 marks an empty bin.
__device__ __forceinline__ void store_cells(int4 v, short4* out) {
  *out = make_short4((short)v.x, (short)v.y, (short)v.z, (short)v.w);
}
__device__ __forceinline__ void store_cells(int4 v, int4* out) { *out = v; }
__device__ __forceinline__ int4 load_cells(const short4* p) {
  const short4 v = *p;
  return make_int4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ int4 load_cells(const int4* p) { return *p; }

// The argmax pass's blocks: at most 128 threads, seven blocks an SM (at
// most 72 registers a thread).
constexpr int kArgmaxThreads = 128;
constexpr int kArgmaxBlocks = 7;

// NaN-first ranking, as jnp.argmax: v beats best when it is larger, or a
// NaN where best is not; ties (two NaNs included) keep the earlier.
__device__ __forceinline__ bool beats(float v, float best) {
  return v > best || (isnan(v) && !isnan(best));
}

__device__ __forceinline__ float4 add4(float4 v, float o) {
  return make_float4(__fadd_rn(v.x, o), __fadd_rn(v.y, o), __fadd_rn(v.z, o),
                     __fadd_rn(v.w, o));
}

// The Pallas kernels' routing, literally: bin row i reads the span_h map
// rows from sh, each masked by adding -1e30 outside [hlo, hhi); per column
// the first (NaN-first) max row; then over all w columns, masked by adding
// -1e30 outside [wlo, whi), the first (NaN-first) max column.  -> the four
// channels' cells h* * w + w*, anywhere in the window's rows.
template <bool kRound>
__device__ int4 route_window(const float4* fb, int cg, int c4, int w, int sh,
                             int span_h, int hlo, int hhi, int wlo, int whi) {
  const float kOut = -1e30f;
  float4 best = make_float4(0.f, 0.f, 0.f, 0.f);
  int4 bh = make_int4(0, 0, 0, 0), bw = bh;
  for (int x = 0; x < w; ++x) {
    float4 cm = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 ch = make_int4(sh, sh, sh, sh);
    for (int y = sh; y < sh + span_h; ++y) {
      const float4 v =
          add4(route_value<kRound>(fb[((size_t)y * w + x) * c4 + cg]),
               y >= hlo && y < hhi ? 0.f : kOut);
      if (y == sh) { cm = v; continue; }
      if (beats(v.x, cm.x)) { cm.x = v.x; ch.x = y; }
      if (beats(v.y, cm.y)) { cm.y = v.y; ch.y = y; }
      if (beats(v.z, cm.z)) { cm.z = v.z; ch.z = y; }
      if (beats(v.w, cm.w)) { cm.w = v.w; ch.w = y; }
    }
    cm = add4(cm, x >= wlo && x < whi ? 0.f : kOut);
    const bool first = x == 0;
    if (first || beats(cm.x, best.x)) { best.x = cm.x; bh.x = ch.x; bw.x = x; }
    if (first || beats(cm.y, best.y)) { best.y = cm.y; bh.y = ch.y; bw.y = x; }
    if (first || beats(cm.z, best.z)) { best.z = cm.z; bh.z = ch.z; bw.z = x; }
    if (first || beats(cm.w, best.w)) { best.w = cm.w; bh.w = ch.w; bw.w = x; }
  }
  return make_int4(bh.x * w + bw.x, bh.y * w + bw.y, bh.z * w + bw.z,
                   bh.w * w + bw.w);
}

// The argmax pass: for each (listed row k, bin) and four channels, the cell
// h*·W + w* the bin's cotangent goes to, ranking route_value<kRound>(feat).
// Where no map row of the bin row's window routes_out (cnt), that is the
// first column of the bin whose column maximum is the bin maximum and the
// first row attaining it, read from the bin alone; else route_window.  An
// empty bin gets -1, or route_window's cell when its cotangent is not
// finite (gspec, then the entry).  Every listed row's cells are written,
// also those of an f32 channel block the row does not list (the gather
// skips them).  The item (k, bin 0) also writes spec_k[k]: bit i for each
// bin row whose cells may lie outside the ROI (a window row that
// routes_out, or gspec).  Grid-stride over the total(k) x bin items, whose
// count only the device knows; threads over channels, so a warp reads each
// window cell as 512 contiguous bytes, as the forward does.
template <typename GVec, typename Cell4, bool kRound>
__global__ void __launch_bounds__(kArgmaxThreads, kArgmaxBlocks)
    roi_argmax_kernel(const float4* __restrict__ feat,
                      const float* __restrict__ rois,
                      const GVec* __restrict__ g,
                      const int* __restrict__ list,
                      const int* __restrict__ img_start,
                      const int* __restrict__ gspec,
                      const int* __restrict__ cnt, int batch, int p, int h,
                      int w, int c4, int pooled_h, int pooled_w,
                      float spatial_scale, int flavor, int span_h,
                      int* __restrict__ spec_k, Cell4* __restrict__ table) {
  const int nb = pooled_h * pooled_w;
  const long long total = (long long)img_start[batch] * nb;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const int k = (int)(item / nb);
    const int bin = (int)(item - (long long)k * nb);
    const int row = list[k];
    const int b = row / p;
    const float* roi = rois + (size_t)row * 4;
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
    const int* cb = cnt + (size_t)b * (h + 1);
    const int sh = min(hlo, h - span_h);
    const int hend = min(hhi, sh + span_h);
    // the routing decision's loads; the bin's scan below runs without
    // waiting for them, and is redone over the window where they say so
    const bool window_out = cb[sh + span_h] > cb[sh];
    const int gs = gspec[row];
    const bool nonempty = hhi > hlo && whi > wlo;
    const float4* fb = feat + (size_t)b * h * w * c4;
    Cell4* out = table + ((size_t)k * nb + bin) * c4;
    for (int cg = threadIdx.x; cg < c4; cg += blockDim.x) {
      int4 cell = make_int4(-1, -1, -1, -1);
      if (nonempty) {
        float4 best = make_float4(0.f, 0.f, 0.f, 0.f);
        int4 bh = make_int4(0, 0, 0, 0), bw = bh;
        for (int x = wlo; x < whi; ++x) {
          // column max over the bin's rows inside the window, and its first
          // row (a bin taller than the window, of a ROI taller than the
          // map, is cut at the window's end, as in the Pallas kernels)
          float4 cm =
              route_value<kRound>(fb[((size_t)hlo * w + x) * c4 + cg]);
          int4 ch = make_int4(hlo, hlo, hlo, hlo);
          for (int y = hlo + 1; y < hend; ++y) {
            const float4 v =
                route_value<kRound>(fb[((size_t)y * w + x) * c4 + cg]);
            if (v.x > cm.x) { cm.x = v.x; ch.x = y; }
            if (v.y > cm.y) { cm.y = v.y; ch.y = y; }
            if (v.z > cm.z) { cm.z = v.z; ch.z = y; }
            if (v.w > cm.w) { cm.w = v.w; ch.w = y; }
          }
          // the first column whose max is the bin max
          const bool first = x == wlo;
          if (first || cm.x > best.x) { best.x = cm.x; bh.x = ch.x; bw.x = x; }
          if (first || cm.y > best.y) { best.y = cm.y; bh.y = ch.y; bw.y = x; }
          if (first || cm.z > best.z) { best.z = cm.z; bh.z = ch.z; bw.z = x; }
          if (first || cm.w > best.w) { best.w = cm.w; bh.w = ch.w; bw.w = x; }
        }
        cell = make_int4(bh.x * w + bw.x, bh.y * w + bw.y, bh.z * w + bw.z,
                         bh.w * w + bw.w);
      }
      if (nonempty ? window_out
                   : (gs >> i & 1) &&
                         !all_finite(to_float4(
                             g[((size_t)row * nb + bin) * c4 + cg])))
        cell = route_window<kRound>(fb, cg, c4, w, sh, span_h, hlo, hhi, wlo,
                                    whi);
      store_cells(cell, out + cg);
    }
    if (bin == 0 && threadIdx.x == 0) {
      int mask = gs;
      for (int ii = 0; ii < pooled_h; ++ii) {
        int lo, hi;
        bin_edges(ii, rsh, roi_h, pooled_h, h, flavor, &lo, &hi);
        const int s0 = min(lo, h - span_h);
        if (cb[s0 + span_h] > cb[s0]) mask |= 1 << ii;
      }
      spec_k[k] = mask;
    }
  }
}

constexpr int kGatherH = 2;        // cells of a gather tile: 2 rows
constexpr int kGatherW = 4;        // x 4 columns
constexpr int kGatherWarps = 8;    // 256 threads; a warp per cell
constexpr int kGatherThreads = 32 * kGatherWarps;

__device__ __forceinline__ float add_if(bool hit, float s, float v) {
  return hit ? __fadd_rn(s, v) : s;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The gather pass.  Grid (tiles, channel slices of 128, batch): block
// (tile, slice, b) owns dfeat[b, tile's cells, 128 channels] and writes it
// once.  Lane l of a warp holds channels 4 * (32 * slice + l) .. + 3 of one
// cell.  For each chunk of the image's listed rows (ascending), the block
// first compacts the rows whose cells may fall in its tile into shared
// memory, with their bin edges; then each warp, for each of its cells,
// walks them in order and adds, per bin row i (ascending) holding the
// cell's row, the sum in j order of the cotangents of the bins j whose
// chosen cell it is: roi_pool_grad's order of sums for that cell.
// kBlocks: a channel block the row does not list adds nothing.  A bin row
// that spec_k marks may have its cells anywhere in its window rows, across
// the whole width: it reaches the tiles of that band, and every bin of the
// row is read, adding g * ne (ne = 0 for an empty bin: g * 0, a NaN for a
// non-finite g).
// Dynamic shared memory: slot[chunk], row[chunk], spec[chunk], then hlo,
// hhi [chunk][pooled_h] and wlo, whi [chunk][pooled_w] (int).
template <typename GVec, typename Cell4, bool kBlocks>
__global__ void __launch_bounds__(kGatherThreads)
    roi_gather_kernel(const float* __restrict__ rois,
                      const GVec* __restrict__ g,
                      const int* __restrict__ list,
                      const int* __restrict__ img_start,
                      const int* __restrict__ spec_k,
                      const unsigned char* __restrict__ blk_active,
                      const Cell4* __restrict__ table, int h, int w, int c4,
                      int pooled_h, int pooled_w, float spatial_scale,
                      int flavor, int span_h, int cb4, int nblk, int chunk,
                      float4* __restrict__ dfeat) {
  extern __shared__ int gsm[];
  int* slot = gsm;
  int* row_s = slot + chunk;
  int* spec_s = row_s + chunk;
  int* hlo_s = spec_s + chunk;
  int* hhi_s = hlo_s + chunk * pooled_h;
  int* wlo_s = hhi_s + chunk * pooled_h;
  int* whi_s = wlo_s + chunk * pooled_w;
  __shared__ int warp_n[kGatherWarps];
  __shared__ int s_n;

  const int tiles_x = (w + kGatherW - 1) / kGatherW;
  const int ty0 = (blockIdx.x / tiles_x) * kGatherH;
  const int tx0 = (blockIdx.x % tiles_x) * kGatherW;
  const int ty1 = min(ty0 + kGatherH, h), tx1 = min(tx0 + kGatherW, w);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = blockIdx.y * 32 + lane;
  const bool has_c = cg < c4;
  // the block's 128 channels lie in one channel block (cb4 is c4 or 64)
  const int blk = blockIdx.y * 32 / cb4;
  const int nb = pooled_h * pooled_w;
  const int k0 = img_start[b], k1 = img_start[b + 1];
  float4* ob = dfeat + (size_t)b * h * w * c4;

  bool first = true;
  for (int base = k0; first || base < k1; base += chunk) {
    // compact this chunk's rows that may reach the tile, in ascending order
    const int k = base + tid;
    bool hit = false;
    int rsw = 0, rsh = 0, roi_w = 1, roi_h = 1, spec = 0, row = 0;
    if (tid < chunk && k < k1) {
      row = list[k];
      const float* roi = rois + (size_t)row * 4;
      rsw = quantize(roi[0], spatial_scale);
      rsh = quantize(roi[1], spatial_scale);
      roi_w = max(quantize(roi[2], spatial_scale) - rsw + 1, 1);
      roi_h = max(quantize(roi[3], spatial_scale) - rsh + 1, 1);
      // bins' lo and hi are non-decreasing in the bin index: their union
      // spans [lo of bin 0, hi of the last bin)
      int ylo, yhi, xlo, xhi, dummy;
      bin_edges(0, rsh, roi_h, pooled_h, h, flavor, &ylo, &dummy);
      bin_edges(pooled_h - 1, rsh, roi_h, pooled_h, h, flavor, &dummy, &yhi);
      bin_edges(0, rsw, roi_w, pooled_w, w, flavor, &xlo, &dummy);
      bin_edges(pooled_w - 1, rsw, roi_w, pooled_w, w, flavor, &dummy, &xhi);
      hit = ylo < ty1 && yhi > ty0 && xlo < tx1 && xhi > tx0;
      spec = spec_k[k];
      for (int i = 0; spec && !hit && i < pooled_h; ++i) {
        if (!(spec >> i & 1)) continue;
        int lo;
        bin_edges(i, rsh, roi_h, pooled_h, h, flavor, &lo, &dummy);
        const int s0 = min(lo, h - span_h);
        hit = s0 < ty1 && s0 + span_h > ty0;
      }
      // a channel block the row does not list adds nothing here
      if (kBlocks)
        hit = hit && blk < nblk && blk_active[(size_t)row * nblk + blk];
    }
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int q = 0; q < kGatherWarps; ++q) {
        const int m = warp_n[q];
        warp_n[q] = n;
        n += m;
      }
      s_n = n;
    }
    __syncthreads();
    if (hit) {
      const int e = warp_n[warp] + __popc(bal & ((1u << lane) - 1u));
      slot[e] = k;
      row_s[e] = row;
      spec_s[e] = spec;
      for (int i = 0; i < pooled_h; ++i)
        bin_edges(i, rsh, roi_h, pooled_h, h, flavor,
                  &hlo_s[e * pooled_h + i], &hhi_s[e * pooled_h + i]);
      for (int j = 0; j < pooled_w; ++j)
        bin_edges(j, rsw, roi_w, pooled_w, w, flavor,
                  &wlo_s[e * pooled_w + j], &whi_s[e * pooled_w + j]);
    }
    __syncthreads();
    const int n_list = s_n;

    for (int cell = warp; cell < kGatherH * kGatherW; cell += kGatherWarps) {
      const int y = ty0 + cell / kGatherW, x = tx0 + cell % kGatherW;
      if (y >= h || x >= w) continue;
      const int me = y * w + x;
      float4* op = ob + (size_t)me * c4 + cg;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!first && has_c) acc = *op;
      for (int e = 0; e < n_list && has_c; ++e) {
        const int* hl = hlo_s + e * pooled_h;
        const int* hh = hhi_s + e * pooled_h;
        const int* wl = wlo_s + e * pooled_w;
        const int* wh = whi_s + e * pooled_w;
        const int spec = spec_s[e];
        if (!spec && (y < hl[0] || y >= hh[pooled_h - 1] || x < wl[0] ||
                      x >= wh[pooled_w - 1]))
          continue;
        const Cell4* tk = table + (size_t)slot[e] * nb * c4 + cg;
        const GVec* gk = g + (size_t)row_s[e] * nb * c4 + cg;
        for (int i = 0; i < pooled_h; ++i) {
          const bool wide = spec >> i & 1;
          if (wide) {
            // a marked bin row: its cells may lie anywhere in its window
            const int s0 = min(hl[i], h - span_h);
            if (y < s0 || y >= s0 + span_h) continue;
          } else {
            if (hl[i] > y) {
              if (!(spec >> i)) break;   // no marked row below
              continue;
            }
            if (y >= hh[i]) continue;
          }
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int j = 0; j < pooled_w; ++j) {
            if (!wide) {
              if (wl[j] > x) break;
              if (x >= wh[j]) continue;
            }
            const int bin = i * pooled_w + j;
            const int4 cc = load_cells(tk + (size_t)bin * c4);
            const bool hx = cc.x == me, hy = cc.y == me, hz = cc.z == me,
                       hw = cc.w == me;
            if (hx | hy | hz | hw) {
              float4 gv = to_float4(gk[(size_t)bin * c4]);
              if (hh[i] <= hl[i] || wh[j] <= wl[j])   // g * ne, ne = 0
                gv = make_float4(__fmul_rn(gv.x, 0.f), __fmul_rn(gv.y, 0.f),
                                 __fmul_rn(gv.z, 0.f), __fmul_rn(gv.w, 0.f));
              s = make_float4(add_if(hx, s.x, gv.x), add_if(hy, s.y, gv.y),
                              add_if(hz, s.z, gv.z), add_if(hw, s.w, gv.w));
            }
          }
          acc = add4(acc, s);
        }
      }
      if (has_c) *op = acc;
    }
    first = false;
    __syncthreads();
  }
}

// The direct path on OutVec's element type; see wssdl_roi_pool_fwd.
template <typename OutVec>
int launch_forward_direct(const float* feat, const float* rois, int batch,
                          int h, int w, int c, int p, int pooled_h,
                          int pooled_w, float spatial_scale, int flavor,
                          void* out, cudaStream_t stream) {
  const int c4 = c / 4;
  int threads = ((c4 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const dim3 grid(batch * p, pooled_h * pooled_w);
  roi_pool_fwd_direct_kernel<OutVec><<<grid, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(feat), rois, p, h, w, c4, pooled_h,
      pooled_w, spatial_scale, flavor, reinterpret_cast<OutVec*>(out));
  return (int)cudaGetLastError();
}

// The shared-memory path's kernel for kVS four-channel vectors a slice.
template <typename OutT, int kVS>
int launch_forward_smem_vs(const CUtensorMap& map, const float* rois,
                           int batch, int h, int w, int c, int p, int rblk,
                           float spatial_scale, int flavor,
                           const FwdTile& tile, size_t smem, void* out,
                           cudaStream_t stream) {
  auto kernel = tile.nby * tile.nbx == 1
                    ? roi_pool_fwd_smem_kernel<OutT, kVS, true>
                    : roi_pool_fwd_smem_kernel<OutT, kVS, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + 4 * kVS - 1) / (4 * kVS), (p + rblk - 1) / rblk,
                  batch);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      map, rois, p, h, w, c, rblk, spatial_scale, flavor, tile,
      reinterpret_cast<OutT*>(out));
  return (int)cudaGetLastError();
}

// The shared-memory path, slices of cs channels (16, 8 or 4), blocks of
// rblk ROIs, 7 x 7 bins.
template <typename OutT>
int launch_forward_smem(const float* feat, const float* rois, int batch,
                        int h, int w, int c, int p, int pooled_h,
                        int pooled_w, float spatial_scale, int flavor, int cs,
                        int rblk, void* out, cudaStream_t stream) {
  if (pooled_h != kPooled || pooled_w != kPooled ||
      (cs != 16 && cs != 8 && cs != 4) || rblk <= 0 || h >= 32768 ||
      w >= 32768)
    return (int)cudaErrorInvalidValue;
  static tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const FwdTile tile = fwd_tile(h, w, cs);
  const size_t smem = fwd_smem_bytes(tile, rblk);
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // dims innermost first: channel, column, row, image; the box is a band
  // of the map (or a piece of a row), cs channels deep
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 4, (cuuint64_t)w * c * 4,
                                 (cuuint64_t)h * w * c * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cs, (cuuint32_t)tile.bw,
                             (cuuint32_t)tile.bh, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
             const_cast<float*>(feat), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto launch = cs == 16  ? launch_forward_smem_vs<OutT, 4>
                : cs == 8 ? launch_forward_smem_vs<OutT, 2>
                          : launch_forward_smem_vs<OutT, 1>;
  return launch(map, rois, batch, h, w, c, p, rblk, spatial_scale, flavor,
                tile, smem, out, stream);
}

// The f32 backward's channel block (_c_block(c, backward=True)).
constexpr int kBwdBlock = 256;

// The backward for a GVec cotangent with Cell4 argmax entries; see
// wssdl_roi_pool_bwd.  The f32 instance (!kRound) lists channel blocks.
template <typename GVec, bool kRound, typename Cell4>
int launch_backward_cells(const float* feat, const float* rois, const void* g,
                          int batch, int h, int w, int c, int p, int pooled_h,
                          int pooled_w, float spatial_scale, int flavor,
                          int* work, void* table, float* dfeat,
                          cudaStream_t stream) {
  constexpr bool kBlocks = !kRound;
  const int c4 = c / 4;
  const int nb = pooled_h * pooled_w;
  const int rows = batch * p;
  const int span_h = min(h / pooled_h + 2, h);
  const int cb4 = kBlocks ? min(c, kBwdBlock) / 4 : c4;
  const int nblk = kBlocks ? c / min(c, kBwdBlock) : 1;
  if (pooled_h > 31 || nblk > 31) return (int)cudaErrorInvalidValue;
  int* active = work;
  int* list = active + rows;
  int* img_start = list + rows;
  int* gspec = img_start + batch + 1;
  int* spec_k = gspec + rows;
  int* rowflag = spec_k + rows;
  int* cnt = rowflag + batch * h * kMapParts;
  unsigned char* blk_active =
      reinterpret_cast<unsigned char*>(cnt + batch * (h + 1));
  const GVec* gv = reinterpret_cast<const GVec*>(g);
  const float4* fv = reinterpret_cast<const float4*>(feat);
  cudaError_t err;
  if (rows > 0) {
    roi_rows_scan_kernel<GVec, kBlocks, kRound>
        <<<rows + batch * h * kMapParts, 256, 0, stream>>>(
            gv, fv, rois, rows, h, w, c4, pooled_h, pooled_w, spatial_scale,
            flavor, cb4, nblk, active, blk_active, gspec, rowflag);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  roi_rows_compact_kernel<<<1, 1024, 0, stream>>>(active, batch, p, rowflag,
                                                  h, list, img_start, cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  Cell4* cells = reinterpret_cast<Cell4*>(table);
  if (rows > 0) {
    int threads = ((c4 + 31) / 32) * 32;
    threads = threads < 32 ? 32
                           : (threads > kArgmaxThreads ? kArgmaxThreads
                                                       : threads);
    const long long items = (long long)rows * nb;
    const int grid = (int)(items < 132 * 16 ? items : 132 * 16);
    roi_argmax_kernel<GVec, Cell4, kRound><<<grid, threads, 0, stream>>>(
        fv, rois, gv, list, img_start, gspec, cnt, batch, p, h, w, c4,
        pooled_h, pooled_w, spatial_scale, flavor, span_h, spec_k, cells);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // the gather's shared memory: a chunk of rows' slots, marks, bin edges
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  const size_t per_row = (3 + 2 * (size_t)(pooled_h + pooled_w)) * sizeof(int);
  // 128 rows a chunk: 15 KB at 7 x 7 bins, so eight blocks fit an SM
  int chunk = kGatherThreads / 2;
  while (chunk > 32 && chunk * per_row + 256 > (size_t)optin) chunk /= 2;
  const size_t smem = chunk * per_row;
  if (smem + 256 > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int tiles = ((h + kGatherH - 1) / kGatherH) *
                    ((w + kGatherW - 1) / kGatherW);
  const dim3 grid(tiles, (c4 + 31) / 32, batch);
  auto gather = roi_gather_kernel<GVec, Cell4, kBlocks>;
  err = cudaFuncSetAttribute(gather,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  gather<<<grid, kGatherThreads, smem, stream>>>(
      rois, gv, list, img_start, spec_k, blk_active, cells, h, w, c4,
      pooled_h, pooled_w, spatial_scale, flavor, span_h, cb4, nblk, chunk,
      reinterpret_cast<float4*>(dfeat));
  return (int)cudaGetLastError();
}

template <typename GVec, bool kRound>
int launch_backward(const float* feat, const float* rois, const void* g,
                    int batch, int h, int w, int c, int p, int pooled_h,
                    int pooled_w, float spatial_scale, int flavor, int* work,
                    void* table, float* dfeat, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  if (pooled_h <= 0 || pooled_w <= 0) return (int)cudaErrorInvalidValue;
  if (h * w <= kShortCells)
    return launch_backward_cells<GVec, kRound, short4>(
        feat, rois, g, batch, h, w, c, p, pooled_h, pooled_w, spatial_scale,
        flavor, work, table, dfeat, stream);
  return launch_backward_cells<GVec, kRound, int4>(
      feat, rois, g, batch, h, w, c, p, pooled_h, pooled_w, spatial_scale,
      flavor, work, table, dfeat, stream);
}

}  // namespace

extern "C" {

// feat [batch, h, w, c] f32 NHWC (c % 4 == 0, 16-byte aligned), rois
// [batch, p, 4] f32 (x1, y1, x2, y2 in input-image pixels; ROI r of image b
// pools against image b), out [batch, p, pooled_h, pooled_w, c] f32
// (16-byte aligned).  flavor 0 = "gpu" bin edges, 1 = "cpu".  cs > 0: the
// shared-memory path (7 x 7 bins) with slices of cs = 16, 8 or 4 channels
// and blocks of rblk ROIs; cs == 0: the direct path.  Launches on
// `stream`, does not synchronise, returns the cudaError_t of the set-up and
// launch (cudaErrorInvalidValue if the slice does not fit shared memory).
int wssdl_roi_pool_fwd(const float* feat, const float* rois, int batch, int h,
                       int w, int c, int p, int pooled_h, int pooled_w,
                       float spatial_scale, int flavor, int cs, int rblk,
                       float* out, cudaStream_t stream) {
  if (batch <= 0 || p <= 0 || c <= 0) return 0;
  if (cs == 0)
    return launch_forward_direct<float4>(feat, rois, batch, h, w, c, p,
                                         pooled_h, pooled_w, spatial_scale,
                                         flavor, out, stream);
  return launch_forward_smem<float>(feat, rois, batch, h, w, c, p, pooled_h,
                                   pooled_w, spatial_scale, flavor, cs, rblk,
                                   out, stream);
}

// The same with a bf16 out (8-byte aligned).
int wssdl_roi_pool_fwd_bf16(const float* feat, const float* rois, int batch,
                            int h, int w, int c, int p, int pooled_h,
                            int pooled_w, float spatial_scale, int flavor,
                            int cs, int rblk, void* out, cudaStream_t stream) {
  if (batch <= 0 || p <= 0 || c <= 0) return 0;
  if (cs == 0)
    return launch_forward_direct<uint2>(feat, rois, batch, h, w, c, p,
                                        pooled_h, pooled_w, spatial_scale,
                                        flavor, out, stream);
  return launch_forward_smem<__nv_bfloat16>(
      feat, rois, batch, h, w, c, p, pooled_h, pooled_w, spatial_scale,
      flavor, cs, rblk, out, stream);
}

// The backward.  feat [batch, h, w, c] and rois as for the forward, g the
// cotangent [batch, p, pooled_h, pooled_w, c] f32 (16-byte aligned), work an
// int scratch of 4 * batch * p + batch + 1 + batch * (5 * h + 1) +
// ceil(batch * p * nblk / 4) entries, nblk = c / min(c, 256) (row flags, the
// compacted row list, each image's first list position, the rows' marks,
// the map rows' flags and counts, the channel blocks' flags), table a
// scratch of
// batch * p * pooled_h * pooled_w * c cell indices (int16 when
// h * w <= 32767, else int32; 16-byte aligned), dfeat [batch, h, w, c] f32
// (16-byte aligned; every element is written).  Launches on `stream`, does
// not synchronise, returns the cudaError_t of the launches.
int wssdl_roi_pool_bwd(const float* feat, const float* rois, const float* g,
                       int batch, int h, int w, int c, int p, int pooled_h,
                       int pooled_w, float spatial_scale, int flavor,
                       int* work, void* table, float* dfeat,
                       cudaStream_t stream) {
  return launch_backward<float4, false>(feat, rois, g, batch, h, w, c, p,
                                        pooled_h, pooled_w, spatial_scale,
                                        flavor, work, table, dfeat, stream);
}

// The backward of the bf16 output: g bf16 (8-byte aligned), routing on
// bf16(feat) (feat stays f32), dfeat f32.
int wssdl_roi_pool_bwd_bf16(const float* feat, const float* rois,
                            const void* g, int batch, int h, int w, int c,
                            int p, int pooled_h, int pooled_w,
                            float spatial_scale, int flavor, int* work,
                            void* table, float* dfeat, cudaStream_t stream) {
  return launch_backward<uint2, true>(feat, rois, g, batch, h, w, c, p,
                                      pooled_h, pooled_w, spatial_scale,
                                      flavor, work, table, dfeat, stream);
}

}  // extern "C"
