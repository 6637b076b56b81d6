// The part of the VGG stem kernels that csrc/conv1.cu (the fused stem) and
// csrc/conv2_pool.cu (the stem tail) share: conv1_2 (64 -> 64, 3x3 SAME) +
// bias + ReLU + 2x2/2 max-pool over a bf16 conv1_1 tile held in shared
// memory, f32 out.
//
// Block tile: 8 x 8 pooled outputs = 16 x 16 conv1_2 outputs, all 64
// channels, 256 threads.  Warp `py` owns pooled row py of the tile; lane
// (px = lane & 7, g = lane >> 3) owns pooled pixel (py, px) and channels
// 16g .. 16g+15, i.e. the 2 x 2 conv1_2 outputs under that pixel for 16
// channels: 64 f32 accumulators in registers.
//
// Order of sums (the contract with the plain versions in ops/conv1.py and
// ops/conv2_pool.py): every output sums its 576 taps (dy, dx, c) in
// ascending order starting from 0.0, then adds the bias, then takes the
// ReLU.  Both factors of every product are bf16 values, so the product is
// exact in f32 and fmaf(a, w, acc) rounds once, exactly as acc + a * w
// does: the kernels equal their plain versions bit for bit.
//
// Shared memory (dynamic, kStemSmemBytes):
//   a1s  [64][18][18] bf16, channel-planar: conv1_1 output rows y0-1 ..
//        y0+16 and columns x0-1 .. x0+16 of the image, 0 outside it.  In
//        a warp the eight px lanes read eight neighbouring even columns:
//        eight consecutive 32-bit words, no bank conflict; the four g
//        lanes of a pixel read the same word (broadcast);
//   ws   [3][64][64] f32: the conv1_2 kernel of one dy, bf16-rounded,
//        restaged for each dy (a float4 of four output channels per load,
//        the same for all px lanes: broadcast).
// 41,472 + 49,152 B: two blocks fit on an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vgg_stem {

constexpr int kTile = 16;                 // conv1_2 outputs per tile side
constexpr int kPooled = kTile / 2;        // pooled outputs per tile side
constexpr int kHalo = kTile + 2;          // conv1_1 tile side
constexpr int kC = 64;                    // channels of conv1_1 / conv1_2
constexpr int kThreads = 256;
constexpr int kGroup = 16;                // output channels per thread
constexpr size_t kA1Bytes = (size_t)kC * kHalo * kHalo * 2;
constexpr size_t kWsBytes = (size_t)3 * kC * kC * 4;
constexpr size_t kStemSmemBytes = kA1Bytes + kWsBytes;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// conv1_2 + b2 + ReLU + pool from the a1s tile; writes the tile's pooled
// outputs that fall inside [hp, wp] to out [batch, hp, wp, 64] f32.
// (tile_y, tile_x): the tile's first pooled row and column.  Every thread
// of the block calls it (it synchronises).
__device__ __forceinline__ void conv12_pool(
    const __nv_bfloat16* __restrict__ a1s, float* __restrict__ ws,
    const float* __restrict__ w2, const float* __restrict__ b2, int b,
    int tile_y, int tile_x, int hp, int wp, float* __restrict__ out) {
  const int py = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int px = lane & 7;
  const int g = lane >> 3;

  float acc[4][kGroup];
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int k = 0; k < kGroup; ++k) acc[o][k] = 0.f;

  for (int dy = 0; dy < 3; ++dy) {
    __syncthreads();  // the previous dy's ws (or the caller's a1s) is done
    const float* w2dy = w2 + (size_t)dy * 3 * kC * kC;
    for (int k = threadIdx.x; k < 3 * kC * kC; k += kThreads)
      ws[k] = bf16_round(w2dy[k]);
    __syncthreads();
    for (int dx = 0; dx < 3; ++dx) {
      const __nv_bfloat16* ap = a1s + (2 * py + dy) * kHalo + 2 * px + dx;
      const float4* wp4 =
          reinterpret_cast<const float4*>(ws + dx * kC * kC + g * kGroup);
#pragma unroll 2
      for (int c = 0; c < kC; ++c) {
        const __nv_bfloat16* p = ap + c * kHalo * kHalo;
        const float a00 = __bfloat162float(p[0]);
        const float a01 = __bfloat162float(p[1]);
        const float a10 = __bfloat162float(p[kHalo]);
        const float a11 = __bfloat162float(p[kHalo + 1]);
        float wv[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup / 4; ++q) {
          const float4 t = wp4[c * (kC / 4) + q];
          wv[4 * q] = t.x;
          wv[4 * q + 1] = t.y;
          wv[4 * q + 2] = t.z;
          wv[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          acc[0][k] = fmaf(a00, wv[k], acc[0][k]);
          acc[1][k] = fmaf(a01, wv[k], acc[1][k]);
          acc[2][k] = fmaf(a10, wv[k], acc[2][k]);
          acc[3][k] = fmaf(a11, wv[k], acc[3][k]);
        }
      }
    }
  }

  const int y = tile_y + py;
  const int x = tile_x + px;
  if (y >= hp || x >= wp) return;
  float* o = out + (((size_t)b * hp + y) * wp + x) * kC + g * kGroup;
#pragma unroll
  for (int q = 0; q < kGroup / 4; ++q) {
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const float bias = b2[g * kGroup + k];
      const float v0 = fmaxf(acc[0][k] + bias, 0.f);
      const float v1 = fmaxf(acc[1][k] + bias, 0.f);
      const float v2 = fmaxf(acc[2][k] + bias, 0.f);
      const float v3 = fmaxf(acc[3][k] + bias, 0.f);
      r[e] = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
    }
    reinterpret_cast<float4*>(o)[q] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

}  // namespace vgg_stem
