// Greedy NMS keep-mask over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel wssdl_bus_tpu/ops/nms_pallas.py:_nms_kernel
// (public wrapper nms_keep_pallas).  Contract, identical to the plain
// version wssdl_bus_tpu_torch/ops/nms.py:nms_mask: boxes arrive sorted by
// descending score; box i is kept iff it is valid and no KEPT box j < i has
//   inter / (area_i + area_j - inter) >= thresh
// with +1 pixel extents, inter = max(min(x2)-max(x1)+1, 0) * (same in y) and
// IEEE single-precision arithmetic.  Invalid boxes are never kept and never
// suppress.  The keep set is exact: every float operation below goes through
// the _rn intrinsics and the file is built with -fmad=false, because a
// contracted FMA or an approximate divide flips boxes that sit on the
// threshold.
//
// What bounds it: at N = 6000 boxes an image needs about 18 M IoU pairs
// (~15 f32 operations each), a few microseconds of the card's f32 rate, and
// reads under 100 KB.  The real limit is greedy NMS's sequential dependency:
// whether box i survives depends on every earlier decision.
//
// Design (the two-phase bitmask NMS): the Pallas kernel walks blocks of rows
// in order on one TensorCore, with a VMEM keep vector and an intra-block
// Jacobi fixpoint.  Here the parallel part and the sequential part are split:
//   1. nms_mask_kernel: a 2-D grid of 64 x 64 tiles over the upper triangle.
//      A thread owns one row box, compares it with 64 column boxes staged in
//      shared memory, and writes one 64-bit word: bit j is set iff column j
//      comes after the row, is valid, and overlaps it at >= thresh.  The
//      whole matrix is N * ceil(N/64) * 8 bytes (4.5 MB at N = 6000) and
//      stays in the 50 MB L2 cache for the second phase.
//   2. nms_walk_kernel: one block per image walks the rows 64 at a time.  A
//      "removed" bitset lives in shared memory.  Thread 0 settles the 64 rows
//      of a tile serially from the tile's diagonal words (staged in shared
//      memory), then all threads OR the kept rows' words into the rest of
//      the bitset in parallel.  The serial part is 64 shared-memory steps per
//      tile; everything that scales with N*N is in phase 1.
// A batch dimension rides on gridDim.z (phase 1) and gridDim.x (phase 2), so
// one call serves every image of a step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // boxes per mask word and per phase-1 tile
constexpr int kWalkThreads = 128;

typedef unsigned long long u64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes_t,
                                const uint8_t* __restrict__ valid, int n,
                                int words, float thresh,
                                u64* __restrict__ mask) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  // rows only suppress later columns: tiles below the diagonal are all zero
  // and phase 2 never reads them
  if (col_tile < row_tile) return;
  const int b = blockIdx.z;
  const float* bx = boxes_t + (size_t)b * 4 * n;
  const uint8_t* vb = valid + (size_t)b * n;

  __shared__ float cx1[kTile], cy1[kTile], cx2[kTile], cy2[kTile];
  __shared__ float carea[kTile];
  __shared__ uint8_t cvalid[kTile];

  const int t = threadIdx.x;
  const int col0 = col_tile * kTile;
  const int ncols = min(kTile, n - col0);
  if (t < ncols) {
    const int j = col0 + t;
    const float x1 = bx[j], y1 = bx[n + j], x2 = bx[2 * n + j],
                y2 = bx[3 * n + j];
    cx1[t] = x1;
    cy1[t] = y1;
    cx2[t] = x2;
    cy2[t] = y2;
    carea[t] = box_area(x1, y1, x2, y2);
    cvalid[t] = vb[j];
  }
  __syncthreads();

  const int i = row_tile * kTile + t;
  if (i >= n) return;
  const float rx1 = bx[i], ry1 = bx[n + i], rx2 = bx[2 * n + i],
              ry2 = bx[3 * n + i];
  const float rarea = box_area(rx1, ry1, rx2, ry2);
  u64 bits = 0;
  // on the diagonal tile only the columns after row i count
  const int jstart = (col_tile == row_tile) ? t + 1 : 0;
  for (int j = jstart; j < ncols; ++j) {
    const float iw = fmaxf(
        __fadd_rn(__fsub_rn(fminf(rx2, cx2[j]), fmaxf(rx1, cx1[j])), 1.0f),
        0.0f);
    const float ih = fmaxf(
        __fadd_rn(__fsub_rn(fminf(ry2, cy2[j]), fmaxf(ry1, cy1[j])), 1.0f),
        0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float iou =
        __fdiv_rn(inter, __fsub_rn(__fadd_rn(rarea, carea[j]), inter));
    if (cvalid[j] && iou >= thresh) bits |= 1ull << j;
  }
  mask[((size_t)b * n + i) * words + col_tile] = bits;
}

__global__ void nms_walk_kernel(const u64* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n,
                                int words, uint8_t* __restrict__ keep) {
  extern __shared__ u64 removed[];  // [words]
  __shared__ u64 diag[kTile];
  __shared__ uint8_t svalid[kTile];
  __shared__ u64 s_kept;

  const int b = blockIdx.x;
  const u64* mb = mask + (size_t)b * n * words;
  const uint8_t* vb = valid + (size_t)b * n;
  uint8_t* kb = keep + (size_t)b * n;
  const int t = threadIdx.x;

  for (int w = t; w < words; w += blockDim.x) removed[w] = 0;
  __syncthreads();

  for (int tile = 0; tile < words; ++tile) {
    const int row0 = tile * kTile;
    const int nrows = min(kTile, n - row0);
    if (t < nrows) {
      diag[t] = mb[(size_t)(row0 + t) * words + tile];
      svalid[t] = vb[row0 + t];
    }
    __syncthreads();
    if (t == 0) {
      u64 rem = removed[tile];
      u64 kept = 0;
      for (int r = 0; r < nrows; ++r) {
        if (svalid[r] && !((rem >> r) & 1ull)) {
          kept |= 1ull << r;
          rem |= diag[r];
        }
      }
      s_kept = kept;
    }
    __syncthreads();
    const u64 kept = s_kept;
    if (t < nrows) kb[row0 + t] = (uint8_t)((kept >> t) & 1ull);
    for (int w = tile + 1 + t; w < words; w += blockDim.x) {
      u64 acc = removed[w];
      u64 k = kept;
      while (k) {
        const int r = __ffsll((long long)k) - 1;
        k &= k - 1;
        acc |= mb[(size_t)(row0 + r) * words + w];
      }
      removed[w] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes_t [batch, 4, n] f32 (x1; y1; x2; y2 rows, columns score-descending),
// valid [batch, n] uint8 0/1, mask scratch [batch, n, ceil(n/64)] uint64,
// keep [batch, n] uint8 0/1 out.  Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launches.
int wssdl_nms_keep(const float* boxes_t, const uint8_t* valid, int batch,
                   int n, float thresh, u64* mask, uint8_t* keep,
                   cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  const dim3 grid1(words, words, batch);
  nms_mask_kernel<<<grid1, kTile, 0, stream>>>(boxes_t, valid, n, words,
                                               thresh, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)words * sizeof(u64);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_walk_kernel<<<batch, kWalkThreads, smem, stream>>>(mask, valid, n,
                                                         words, keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
