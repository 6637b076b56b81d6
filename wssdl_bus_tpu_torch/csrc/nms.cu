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
// threshold.  The IoU is symmetric bit for bit (min, max, + and * commute in
// IEEE arithmetic), so either box of a pair may be the "row".
//
// What bounds it: at N = 6000 boxes an image needs about 18 M IoU pairs
// (~15 f32 operations each), a few microseconds of the card's f32 rate, and
// reads under 100 KB.  The real limit is greedy NMS's sequential dependency:
// whether box i survives depends on every earlier decision.  The design
// splits the work into a parallel part and one serial walk per image, and
// takes the memory's latency and the bulk of the bit-ORs off the walk's
// serial path.  Invalid boxes drop out first, so both parts see only the
// valid ones (64% of the training step's candidates, 84% when serving).
//
//   1. nms_compact_kernel: one block per image lists its valid boxes in
//      order (float4 boxes and their positions) and writes keep = 0 for the
//      invalid ones.
//   2. nms_mask_kernel: 256-thread blocks over the upper triangle of 256 x
//      256 blocks of listed boxes.  A thread owns one row box and compares
//      it with 4 column tiles of 64 boxes staged in shared memory, writing
//      one 64-bit word per tile: bit j is set iff column j overlaps the row
//      at >= thresh.  For thresh >= 2^-100 nearly every pair is decided
//      without a division, exactly (see suppresses); the rest, and every
//      pair when thresh is smaller or not positive, take the _rn division.
//      The word on the diagonal tile is the row's "column word" (bits j < i
//      of its own tile: the boxes that would suppress it).  The store, in
//      the order the walk reads it: tile row t's row words t+1 .. w-1 in
//      column chunks of at most `cw` words, each chunk [64 rows][width],
//      then every tile's 64 column words.  An image of w tiles stores
//      64 * w(w+1)/2 words: at most 2.3 MB at N = 6000 and 9.1 MB at
//      12000, so the training step's three images take at most 27 MB of
//      the 50 MB L2.
//   3. nms_walk_kernel: one block per image walks the tiles in order with
//      a "removed" bitset in shared memory.  Each tile costs
//        - the settle, inside warp 0 from registers: lane l holds the
//          column words of rows l and l + 32 (loaded during the previous
//          tile) and the Pallas kernel's Jacobi fixpoint runs on ballots,
//          kept_i = free_i & !(col_i & K), as many trips as the tile's
//          suppression chain is deep (nms_pallas.py:89-103);
//        - the OR of the kept rows' words into `removed` by all 256
//          threads, a column each, over the list of kept rows, from
//          shared memory: the tile row's chunks stream through a
//          two-stage ring, each chunk one cp.async.bulk copy (TMA's bulk
//          engine) signalled on an mbarrier and issued two chunks ahead,
//          so tile t+1's rows land while tile t is settled and ORed.  A
//          chunk is at most 64 x 187 words (94 KB) at N = 12000, and N
//          whose rows do not fit take more chunks per tile, never another
//          path.
//      On the H100 this block-wide lockstep beat every split of the walk
//      that was tried: warp 0 a tile ahead of the others, deeper rings of
//      smaller copies, a copy per row, loads straight from L2, and passes
//      relayed through registers (PERF.md).
//      At the end the block writes the keep flags back to the boxes'
//      positions.
// The batch rides on gridDim.x (1, 3) and gridDim.y (2), so one call serves
// every image of a step.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // boxes per mask word and per tile
constexpr int kSuper = 4;          // tiles per side of a mask block
constexpr int kMaskThreads = kTile * kSuper;
constexpr int kCompactThreads = 1024;
constexpr int kWalkThreads = 256;
constexpr int kStages = 2;         // the walk's ring of chunks

typedef unsigned long long u64;

// Words of an image's store before tile row t's row words: 64 * (words - 1
// - s) for each row s < t.  The column words follow the last tile row.
__host__ __device__ inline long long row_base(int t, int words) {
  const long long tt = t, w = words;
  return kTile * (tt * (w - 1) - tt * (tt - 1) / 2);
}

__host__ __device__ inline long long store_words(int words) {
  return (long long)kTile * words * (words + 1) / 2;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// The listed boxes of image b: [count[b]] float4 boxes and their positions.
__global__ void __launch_bounds__(kCompactThreads)
    nms_compact_kernel(const float* __restrict__ boxes_t,
                       const uint8_t* __restrict__ valid, int n,
                       float4* __restrict__ lbox, int* __restrict__ order,
                       int* __restrict__ count, uint8_t* __restrict__ keep) {
  __shared__ int warp_n[kCompactThreads / 32];
  __shared__ int s_total;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* bx = boxes_t + (size_t)b * 4 * n;
  int base = 0;
  for (int q0 = 0; q0 < n; q0 += kCompactThreads) {
    const int q = q0 + tid;
    const bool v = q < n && valid[(size_t)b * n + q];
    if (q < n && !v) keep[(size_t)b * n + q] = 0;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {   // exclusive scan of the warps' counts
      const int m = warp_n[lane];
      int incl = m;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      warp_n[lane] = incl - m;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    if (v) {
      const int pos = base + warp_n[warp] + __popc(bal & ((1u << lane) - 1u));
      order[(size_t)b * n + pos] = q;
      lbox[(size_t)b * n + pos] =
          make_float4(bx[q], bx[n + q], bx[2 * n + q], bx[3 * n + q]);
    }
    base += s_total;
    __syncthreads();
  }
  if (tid == 0) count[b] = base;
}

// RN(inter / u) >= thresh, the plain version's test, exactly.  With kFast
// (thresh a normal float >= 2^-100), nearly every pair is decided without
// the division: when inter > 0 then 0 < inter <= u (RN is monotone, so
// inter <= min(area_i, area_j)), and with tu = RN(thresh * u) >= 2^-100,
// d = RN(inter - tu) and e = tu * 2^-20 (exact):
//   d >  e  implies inter - thresh*u > 0 (tu is within 2^-24 relative of
//           thresh*u), so inter / u > thresh and RN of it is >= thresh;
//   d < -e  implies inter / u < thresh * (1 - 2^-21), below the midpoint
//           between thresh and its predecessor (at most 2^-24 * thresh
//           under it), so RN of it is < thresh.
// A disjoint pair (inter == 0: IoU 0, -0 or NaN) is never a hit.  What is
// left, IoUs within about 2^-20 of thresh and unscaled cases (u <= 0, inf,
// NaN), takes the division.
template <bool kFast>
__device__ __forceinline__ bool suppresses(float4 r, float rarea, float4 c,
                                           float carea, float thresh) {
  const float iw = fmaxf(
      __fadd_rn(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 1.0f), 0.0f);
  const float ih = fmaxf(
      __fadd_rn(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 1.0f), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float u = __fsub_rn(__fadd_rn(rarea, carea), inter);
  if (kFast) {
    const float tu = __fmul_rn(thresh, u);
    const float d = __fsub_rn(inter, tu);
    const float e = __fmul_rn(tu, 0x1p-20f);
    const bool scaled = tu >= 0x1p-100f;
    if (scaled && d > e) return true;
    if ((scaled && d < -e) || inter == 0.0f) return false;
  }
  return __fdiv_rn(inter, u) >= thresh;
}

// The row box against one tile of 64 staged columns: bit j per column.
template <bool kFast>
__device__ __forceinline__ u64 tile_bits(float4 r, float rarea,
                                         const float4* cbox,
                                         const float* carea, float thresh) {
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int jj = 0; jj < kTile; ++jj) {
    const unsigned hit =
        suppresses<kFast>(r, rarea, cbox[jj], carea[jj], thresh);
    if (jj < 32)
      lo |= hit << jj;
    else
      hi |= hit << (jj - 32);
  }
  return ((u64)hi << 32) | lo;
}

// Grid (super blocks of the largest image, batch); an image with fewer
// listed boxes leaves the blocks past its own triangle idle.
template <bool kFast>
__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float4* __restrict__ lbox,
                    const int* __restrict__ count, int n, int cw,
                    float thresh, u64* __restrict__ mask) {
  // blockIdx.x -> super block (R, G), R <= G, rows of S - R blocks each
  const int supers_n = (n + kMaskThreads - 1) / kMaskThreads;
  int rem = blockIdx.x, R = 0;
  while (rem >= supers_n - R) {
    rem -= supers_n - R;
    ++R;
  }
  const int G = R + rem;
  const int b = blockIdx.y;
  const int nv = count[b];
  const int words = (nv + kTile - 1) / kTile;
  if (G * kSuper >= words) return;
  const float4* lb = lbox + (size_t)b * n;
  u64* mb = mask + (size_t)b * store_words((n + kTile - 1) / kTile);

  __shared__ float4 cbox[kMaskThreads];
  __shared__ float carea[kMaskThreads];
  const int t = threadIdx.x;
  const int j = G * kMaskThreads + t;
  const float4 c = j < nv ? lb[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  cbox[t] = c;
  carea[t] = box_area(c);
  __syncthreads();
  const int i = R * kMaskThreads + t;
  if (i >= nv) return;
  const int rt = i / kTile;
  const int r = i % kTile;
  const float4 rb = lb[i];
  const float rarea = box_area(rb);
  const int width = words - 1 - rt;
  for (int cc = 0; cc < kSuper; ++cc) {
    const int ct = G * kSuper + cc;
    if (ct >= words) break;
    if (ct < rt) continue;
    const u64 bits = tile_bits<kFast>(rb, rarea, cbox + cc * kTile,
                                      carea + cc * kTile, thresh);
    if (ct == rt) {   // the column word: j < i
      mb[row_base(words, words) + (size_t)rt * kTile + r] =
          bits & ((1ull << r) - 1ull);
    } else {
      const int q = ct - rt - 1;
      const int k = q / cw;
      const int wk = min(cw, width - k * cw);
      mb[row_base(rt, words) + (size_t)kTile * k * cw + (size_t)r * wk +
         (q - k * cw)] = bits;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Thread 0's cursor over the chunks (t, k) of the row words, in the walk's
// order: tile rows t = 0 .. words-2, chunks k of cw columns each.
struct ChunkCursor {
  int t = 0, k = 0;

  // Bulk-copy the next chunk (if any) into `dst`, completing on `bar`.
  __device__ void issue(const u64* mb, int words, int cw, u64* dst,
                        uint32_t bar) {
    if (t >= words - 1) return;
    const int width = words - 1 - t;
    const int wk = min(cw, width - k * cw);
    const uint32_t bytes = (uint32_t)(kTile * wk * sizeof(u64));
    const u64* src = mb + row_base(t, words) + (size_t)kTile * k * cw;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
    if ((k + 1) * cw >= width) {
      ++t;
      k = 0;
    } else {
      ++k;
    }
  }
};

__device__ __forceinline__ u64 ballot64(bool lo, bool hi) {
  return (u64)__ballot_sync(0xffffffffu, lo) |
         ((u64)__ballot_sync(0xffffffffu, hi) << 32);
}

// Dynamic shared memory: the stages' mbarriers, removed[words] and
// kept[words] of the largest image, then (128-byte aligned, at `stage_off`)
// the stages of 64 * cw words.
__global__ void __launch_bounds__(kWalkThreads)
    nms_walk_kernel(const u64* __restrict__ mask,
                    const int* __restrict__ order,
                    const int* __restrict__ count, int n, int cw,
                    int stage_off, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int words_n = (n + kTile - 1) / kTile;
  u64* bars = reinterpret_cast<u64*>(smem);
  u64* removed = bars + kStages;
  u64* kept_all = removed + words_n;
  u64* stage = reinterpret_cast<u64*>(smem + stage_off);
  __shared__ int s_list[kTile], s_nk;   // the tile's kept rows

  const int b = blockIdx.x;
  const int nv = count[b];
  if (nv == 0) return;
  const int words = (nv + kTile - 1) / kTile;
  const u64* mb = mask + (size_t)b * store_words(words_n);
  const u64* cols = mb + row_base(words, words);
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t bar0 = smem_u32(bars);

  // the last tile's rows past nv start removed
  for (int w = tid; w < words; w += blockDim.x)
    removed[w] = w < words - 1 || nv % kTile == 0
                     ? 0ull
                     : ~0ull << (nv % kTile);
  ChunkCursor cursor;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * s)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages; ++s)
      cursor.issue(mb, words, cw, stage + s * kTile * cw, bar0 + 8 * s);
  }
  // warp 0's column words of rows lane and lane + 32, a tile ahead
  u64 col0 = 0, col1 = 0;
  if (tid < 32) {
    col0 = cols[lane];
    col1 = cols[lane + 32];
  }
  __syncthreads();

  int ci = 0;   // chunks consumed
  for (int t = 0; t < words; ++t) {
    if (tid < 32) {
      // settle the tile: the Jacobi fixpoint from "every free row kept"
      const u64 rem = removed[t];
      const bool f0 = !((rem >> lane) & 1ull);
      const bool f1 = !((rem >> (lane + 32)) & 1ull);
      u64 kept = ballot64(f0, f1);
      while (true) {
        const u64 next = ballot64(f0 && !(col0 & kept), f1 && !(col1 & kept));
        if (next == kept) break;
        kept = next;
      }
      if ((kept >> lane) & 1ull)
        s_list[__popcll(kept & ((1ull << lane) - 1ull))] = lane;
      if ((kept >> (lane + 32)) & 1ull)
        s_list[__popcll(kept & ((1ull << (lane + 32)) - 1ull))] = lane + 32;
      if (lane == 0) {
        s_nk = __popcll(kept);
        kept_all[t] = kept;
      }
      if (t + 1 < words) {
        col0 = cols[(size_t)(t + 1) * kTile + lane];
        col1 = cols[(size_t)(t + 1) * kTile + lane + 32];
      }
    }
    __syncthreads();
    // the kept rows' words into `removed`, chunk by chunk of the tile row
    const int nk = s_nk;
    const int width = words - 1 - t;
    for (int q0 = 0; q0 < width; q0 += cw) {
      const int wk = min(cw, width - q0);
      const int slot = ci % kStages;
      mbar_wait(bar0 + 8 * slot, (ci / kStages) & 1);
      const u64* st = stage + slot * kTile * cw;
      for (int c = tid; c < wk; c += blockDim.x) {
        u64 acc = removed[t + 1 + q0 + c];
#pragma unroll 4
        for (int kk = 0; kk < nk; ++kk) acc |= st[s_list[kk] * wk + c];
        removed[t + 1 + q0 + c] = acc;
      }
      __syncthreads();
      if (tid == 0)
        cursor.issue(mb, words, cw, stage + slot * kTile * cw,
                     bar0 + 8 * slot);
      ++ci;
    }
  }

  // the keep flags, back at the listed boxes' positions
  const int* ob = order + (size_t)b * n;
  uint8_t* kb = keep + (size_t)b * n;
  for (int i = tid; i < nv; i += blockDim.x)
    kb[ob[i]] = (kept_all[i / kTile] >> (i % kTile)) & 1ull;
}

// Byte offsets of the scratch's parts for `batch` images of n boxes: the
// mask store, the listed boxes, their positions, the counts.
struct Scratch {
  size_t mask, lbox, order, count, total;
  Scratch(int batch, int n) {
    const size_t words = (n + kTile - 1) / kTile;
    mask = 0;
    lbox = (size_t)batch * store_words((int)words) * sizeof(u64);
    order = lbox + (size_t)batch * n * sizeof(float4);
    count = order + (size_t)batch * n * sizeof(int);
    total = count + (size_t)batch * sizeof(int);
  }
};

}  // namespace

extern "C" {

// Bytes of scratch wssdl_nms_keep takes for `batch` images of n boxes.
long long wssdl_nms_scratch_bytes(int batch, int n) {
  return batch > 0 && n > 0 ? (long long)Scratch(batch, n).total : 0;
}

// boxes_t [batch, 4, n] f32 (x1; y1; x2; y2 rows, columns score-descending),
// valid [batch, n] uint8 0/1, scratch of wssdl_nms_scratch_bytes(batch, n)
// bytes (16-byte aligned), keep [batch, n] uint8 0/1 out.  Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launches
// (cudaErrorInvalidValue when the walk's bitsets do not fit in shared
// memory).
int wssdl_nms_keep(const float* boxes_t, const uint8_t* valid, int batch,
                   int n, float thresh, void* scratch, uint8_t* keep,
                   cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the walk's shared memory: mbarriers, removed and kept bitsets, then
  // two stages of 64 * cw words; cw is as wide as fits, at most a whole
  // tile row of the largest image
  const int stage_off =
      ((kStages + 2 * words) * (int)sizeof(u64) + 127) / 128 * 128;
  const int bytes_per_cw = kStages * kTile * (int)sizeof(u64);
  // (less 512 bytes for the kernel's static shared memory)
  const int cw = min(max(words - 1, 1), (optin - 512 - stage_off) / bytes_per_cw);
  if (cw < 1) return (int)cudaErrorInvalidValue;
  const int smem = stage_off + cw * bytes_per_cw;

  const Scratch parts(batch, n);
  char* base = static_cast<char*>(scratch);
  u64* mask = reinterpret_cast<u64*>(base + parts.mask);
  float4* lbox = reinterpret_cast<float4*>(base + parts.lbox);
  int* order = reinterpret_cast<int*>(base + parts.order);
  int* count = reinterpret_cast<int*>(base + parts.count);

  nms_compact_kernel<<<batch, kCompactThreads, 0, stream>>>(
      boxes_t, valid, n, lbox, order, count, keep);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int supers = (n + kMaskThreads - 1) / kMaskThreads;
  const dim3 grid(supers * (supers + 1) / 2, batch);
  if (thresh >= 0x1p-100f && thresh <= FLT_MAX)
    nms_mask_kernel<true><<<grid, kMaskThreads, 0, stream>>>(
        lbox, count, n, cw, thresh, mask);
  else
    nms_mask_kernel<false><<<grid, kMaskThreads, 0, stream>>>(
        lbox, count, n, cw, thresh, mask);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(nms_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  nms_walk_kernel<<<batch, kWalkThreads, smem, stream>>>(
      mask, order, count, n, cw, stage_off, keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
