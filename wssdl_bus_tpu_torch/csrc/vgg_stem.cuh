// The part of the VGG stem kernels that csrc/conv1.cu (the fused stem, #6)
// and csrc/conv2_pool.cu (the stem tail, #7) share: conv1_2 (64 -> 64, 3x3
// SAME) + bias + ReLU + 2x2/2 max-pool over a bf16 conv1_1 halo tile held in
// shared memory, f32 out, as an implicit GEMM on Hopper's tensor cores.
//
// What bounds the two kernels: operations.  conv1_2 is 2 * 576 flops per
// output pixel and channel, 292.6 GFLOP at the served batch of 8 at
// 608 x 816: 0.30 ms at the H100's 989 TFLOP/s of dense bf16, against 0.23
// ms to read a bf16 a1 and write the pooled f32 output.  The design puts
// those products on the tensor cores with wgmma:
//
//   * GEMM: M = the 256 conv1_2 outputs of a 16 x 16 tile, N = the 64
//     output channels, K = 576 = 9 taps x 64 input channels.  Tap (dy, dx)
//     reads the same halo tile shifted by whole pixels, so A is never
//     materialised: ldmatrix gives each lane its own pixel row (any
//     pixel + tap offset), and the fragments feed wgmma.m64n64k16 with A
//     in registers.  B is the packed conv1_2 kernel (tap, c_out, c_in)
//     in bf16 (ops/conv2_pool.py:pack_conv2_weights_bf16), 72 KB, loaded
//     into shared memory once per block in the 128-byte-swizzled K-major
//     layout that wgmma's descriptor reads.
//   * Halo tile: 18 x 18 pixels x 64 channels bf16, one pixel per 128-byte
//     row, its eight 16-byte chunks XOR-ed with (pixel & 7) (TMA's 128-byte
//     swizzle): the eight consecutive pixels of one ldmatrix hit eight
//     different bank groups.  Pixels outside the image are 0 (SAME zeros).
//   * Persistent grid, one block per SM: two consumer warpgroups (each 128
//     of the tile's 256 outputs: 2 x m64 blocks, 64 f32 accumulators a
//     thread) and a producer that fills the other of two halo buffers while
//     the consumers work (TMA in #7, conv1_1 on the SIMT cores in #6),
//     handed over by mbarriers (full: the tile is there; empty: the
//     consumers are done with it).
//   * Epilogue in registers: a warp's 16 M rows are 8 columns of image row
//     y (rows 0-7) and the same columns of row y+1 (rows 8-15), so the
//     vertical pair of the pool is in one thread and the horizontal pair
//     is lanes 4 apart (one shuffle).  relu(max(v) + b) equals max(relu(v
//     + b)) bit for bit (rounding is monotone), and each pooled pixel's 64
//     channels go out as 32-byte sectors.
//
// Numerics (the contract with the plain versions in ops/conv1.py and
// ops/conv2_pool.py): both factors of every product are bf16 values, so
// each product is exact; wgmma sums them in its own order, with f32
// accumulators, so against the plain versions' fixed (dy, dx, c) order the
// kernels agree to f32 reassociation (within 1e-5 of the output's largest
// magnitude), and bit for bit wherever every partial sum is exact (a dyadic
// grid).  Bias, ReLU and pool follow the plain order.
//
// Shared memory (dynamic; the base rounded up to 1024 bytes, which the
// swizzle and the wgmma descriptor need):
//   [0, 73728)                  B: 9 taps x 64 c_out rows x 128 bytes
//   [73728, +2 x 41984)         two halo buffers (41472 bytes each, padded
//                               to a multiple of 1024)
//   [157696, +32)               mbarriers full[2], empty[2]
//   then the kernel's own scratch (kStemScratch).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vgg_stem {

constexpr int kTile = 16;                 // conv1_2 outputs per tile side
constexpr int kHalo = kTile + 2;          // conv1_1 tile side
constexpr int kC = 64;                    // channels of conv1_1 / conv1_2
constexpr int kConsumerThreads = 256;     // two warpgroups
constexpr uint32_t kRowBytes = kC * 2;    // one pixel's 64 bf16 channels
constexpr uint32_t kWBytes = 9 * kC * kRowBytes;               // 73,728
constexpr uint32_t kHaloBytes = kHalo * kHalo * kRowBytes;     // 41,472
constexpr uint32_t kBufBytes = (kHaloBytes + 1023) / 1024 * 1024;
constexpr uint32_t kBufOff = kWBytes;
constexpr uint32_t kBarOff = kBufOff + 2 * kBufBytes;
constexpr uint32_t kStemScratch = kBarOff + 32;
constexpr size_t kSmemSlack = 1024;       // for rounding the base up

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the byte offset, in a buffer of 128-byte rows aligned to 1024, of 16-byte
// chunk `chunk` of row `row`
__device__ __forceinline__ uint32_t swz(uint32_t row, uint32_t chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// ---- mbarriers ---------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
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

// ---- wgmma -------------------------------------------------------------
// K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row atoms
// of 1024 bytes (stride byte offset), leading byte offset unused.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses to `d` across an asm boundary
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += a[64 x 16] (registers, bf16) * b[16 x 64] (descriptor)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ---- block set-up ------------------------------------------------------
// The 1024-aligned base of the dynamic shared memory.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// Every thread of the block: B into shared memory (swizzled), the
// barriers initialised (full: `full_count` arrivals, empty: the consumer
// threads).  Ends with __syncthreads.
__device__ __forceinline__ void block_setup(
    unsigned char* smem, const __nv_bfloat16* __restrict__ wpk,
    uint32_t full_count) {
  const uint4* src = reinterpret_cast<const uint4*>(wpk);
  for (int k = threadIdx.x; k < 9 * kC * 8; k += blockDim.x) {
    const int row = k >> 3;             // tap * 64 + c_out
    const int chunk = k & 7;            // 8 input channels
    *reinterpret_cast<uint4*>(smem + swz(row, chunk)) = src[k];
  }
  const uint32_t bars = smem_u32(smem + kBarOff);
  if (threadIdx.x == 0) {
    mbar_init(bars, full_count);
    mbar_init(bars + 8, full_count);
    mbar_init(bars + 16, kConsumerThreads);
    mbar_init(bars + 24, kConsumerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // B was written by ordinary stores and is read by wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ uint32_t full_bar(unsigned char* smem, int s) {
  return smem_u32(smem + kBarOff) + 8 * s;
}
__device__ __forceinline__ uint32_t empty_bar(unsigned char* smem, int s) {
  return smem_u32(smem + kBarOff) + 16 + 8 * s;
}

// Tile `t` of the grid walk: image b, first conv1_2 row y0 and column x0.
struct TileCoord {
  int b, y0, x0;
};
__device__ __forceinline__ TileCoord tile_coord(int t, int ntx, int nty) {
  const int tx = t % ntx;
  const int r = t / ntx;
  return {r / nty, (r % nty) * kTile, tx * kTile};
}

// ---- the consumers -----------------------------------------------------
// One consumer warpgroup `g` (0 or 1) on halo buffer `buf` (shared
// address): conv1_2 of its 128 outputs (tile rows 8g .. 8g+7, all 16
// columns), then arrives on `empty`, then bias + ReLU + pool into out
// [batch, hp, wp, 64].  All 128 threads of the warpgroup call it.
__device__ __forceinline__ void consume_tile(
    uint32_t buf, uint32_t wsm, uint32_t empty, const float* __restrict__ b2,
    int g, TileCoord tc, int hp, int wp, float* __restrict__ out) {
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // ldmatrix: lane -> (matrix j, row rr); matrix j covers M rows
  // 8 (j & 1) .. +7 and channels 8 (j >> 1) .. +7 of a k16 step
  const int j = lane >> 3;
  const int rr = lane & 7;
  const int ry = 8 * g + 2 * warp + (j & 1);      // tile row of this M row

  float acc[2][32];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap - 3 * dy;
    uint32_t a[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint32_t p = (ry + dy) * kHalo + 8 * m + rr + dx;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(a[m][kk], buf + swz(p, 2 * kk + (j >> 1)));
    }
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < 2; ++m) fence_acc(acc[m]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(wsm + tap * kC * kRowBytes + kk * 32);
#pragma unroll
      for (int m = 0; m < 2; ++m) wgmma_m64n64k16(acc[m], a[m][kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < 2; ++m) fence_acc(acc[m]);
  }
  mbar_arrive(empty);

  // accumulator (m, 4i + e): M row 16 warp + lane/4 + 8 (e >> 1), i.e.
  // tile row 8g + 2 warp + (e >> 1), column 8m + lane/4; channel
  // 8i + 2 (lane & 3) + (e & 1)
  const int py = tc.y0 / 2 + 4 * g + warp;
  const int odd = (lane >> 2) & 1;      // the partner (lane ^ 4) is col ^ 1
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float v[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float t = fmaxf(acc[m][4 * i + e], acc[m][4 * i + 2 + e]);
        v[i][e] = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 4));
      }
    const int px = tc.x0 / 2 + 4 * m + (lane >> 3);
    if (py < hp && px < wp) {
      float* o = out + (((size_t)tc.b * hp + py) * wp + px) * kC + c0;
      // both partners hold the pooled values: each stores half the chunks
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 2 * q + odd;
        const float lo = odd ? v[2 * q + 1][0] : v[2 * q][0];
        const float hi = odd ? v[2 * q + 1][1] : v[2 * q][1];
        const float2 bias = *reinterpret_cast<const float2*>(b2 + 8 * i + c0);
        *reinterpret_cast<float2*>(o + 8 * i) =
            make_float2(fmaxf(lo + bias.x, 0.f), fmaxf(hi + bias.y, 0.f));
      }
    }
  }
}

// The consumers' loop over the block's tiles (warpgroups 0 and 1).
__device__ __forceinline__ void consumer_loop(unsigned char* smem,
                                              const float* __restrict__ b2,
                                              int ntx, int nty, int ntiles,
                                              int hp, int wp,
                                              float* __restrict__ out) {
  const int g = threadIdx.x >> 7;
  const uint32_t wsm = smem_u32(smem);
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    mbar_wait(full_bar(smem, s), (it >> 1) & 1);
    consume_tile(smem_u32(smem + kBufOff + s * kBufBytes), wsm,
                 empty_bar(smem, s), b2, g, tile_coord(t, ntx, nty), hp, wp,
                 out);
  }
}

// The producer's wait before it refills buffer it & 1.
__device__ __forceinline__ void producer_acquire(unsigned char* smem,
                                                 int it) {
  mbar_wait(empty_bar(smem, it & 1), ((it >> 1) & 1) ^ 1);
}

// The persistent grid: one block per SM, at most one per tile.
inline int persistent_grid(int ntiles) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  return ntiles < sms ? ntiles : sms;
}

}  // namespace vgg_stem
