// The int8 convolution of int8 serving for Hopper (sm_90a), with its
// epilogue:  y = [relu](float(acc) * scale[o] + bias[o]),
// acc = sum over (dy, dx, ci) of xq[b, oy*s - pt + dy, ox*s - pl + dx, ci]
//       * w[o, dy, dx, ci]   (s8 x s8 -> s32, zeros outside the image),
// written as f32, or, given the next layer's input scale s_next (a device
// pointer), as that layer's int8 input  q = clamp(rint(y / s_next), -127,
// 127).  xq [B, H, W, Cin] int8 NHWC; w packed [Cout, Kpad] int8 (taps in
// (dy, dx, ci) order, zero-padded: ops/int8_conv.py:pack_weight); scale,
// bias [Cout] f32; out [B, Ho, Wo, Cout] f32 or int8 NHWC.  TF "SAME" pads
// (top / left given, asymmetric at stride 2).
//
// No TPU kernel is replaced: the JAX package computes this conv with XLA's
// s8 x s8 -> s32 lax.conv_general_dilated(preferred_element_type=int32)
// (wssdl_bus_tpu/models/quantize.py:127, called at :158-160 and :259-261),
// and PyTorch has no int8 convolution that returns the int32 accumulator.
//
// What bounds it: operations for the 3x3 layers (2 * M * Cout * K int8
// operations at 1,979 TOP/s dense), bytes for the Cin = 3 layers and the
// 1x1 ones (each input byte read once, each output written once: 1 byte
// with s_next, 4 without).  The design:
//
//   * Implicit GEMM, M = output pixels, N = Cout, K = kh * kw * Cin, on
//     wgmma.mma_async m64nNk32 s8 (N = 64 or 128) with both operands
//     K-major in shared memory, in TMA's 128-byte swizzle (a stage holds
//     128 channels of one tap) where Cin % 128 == 0, else the 64-byte one
//     (64 channels).
//   * The M tile is 256 output pixels, a patch of bn images x bh rows x bw
//     columns (ops/int8_conv_cuda.py:tile_plan picks it per shape: several
//     whole images where they are small).  Its A operand for one (tap,
//     channel block) is ONE TMA box of the NHWC input at (c0, ox0*s - pl +
//     dx, oy0*s - pt + dy, n0), traversed at the conv's stride (TMA element
//     strides); TMA's zero fill outside the tensor is TF-SAME's padding,
//     asymmetric pads included.  B is one box of the packed weights at
//     (tap * Cin + c0, co0).
//   * Persistent grid, one block per SM: one producer thread keeps a ring
//     of stages in flight (full / empty mbarriers), two consumer
//     warpgroups (128 rows each, two m64 blocks) issue the wgmmas and
//     release each stage once the next one's products are issued.  Tiles
//     of 128 rows, with half the products a stage, ran several times
//     slower: the per-stage synchronisation is not hidden.
//   * 3x3 convs at stride 1 from 64 channels (VGG16 conv1_2 / conv2_1,
//     ResNet group0), whose stages hold two k-steps and whose output is
//     large against their products, take the halo path below: the input
//     halo once a tile instead of A once a tap, the whole kernel resident,
//     and three warpgroups on items of their own, so that epilogues run
//     under another warpgroup's products.
//   * Cin = 3 (VGG16 conv1_1, K = 27; ResNet conv0, K = 147) has a path of
//     its own: one 256-pixel tile a block; the block stages its input patch
//     (halo included) in shared memory once, each thread builds one im2col
//     row of A from it through a per-k offset table, and two warpgroups run
//     the ceil(K / 32) k-steps that hold real K.
//   * Epilogue in registers: multiply then add with explicit
//     round-to-nearest intrinsics (the plain version's and the JAX
//     package's two roundings), ReLU, and for int8 out the IEEE quotient
//     (PyTorch's quantize step divides by a 0-d device tensor truly; here
//     a multiply by the reciprocal and two exact-remainder corrections,
//     quotient()) rounded half to even (rintf).
//     The int8 codes of four lanes are exchanged so that each lane stores
//     8 bytes, one 32-byte sector a quad.
//
// Exactness: the int32 sum is exact in any order, so the output equals
// ops/int8_conv.py:int8_conv_plain bit for bit, with and without s_next.

#include "tma.cuh"
#include "vgg_stem.cuh"

namespace {

using tma::smem_u32;
using vgg_stem::aligned_smem;
using vgg_stem::wgmma_commit;
using vgg_stem::wgmma_fence;

constexpr int kCB = 64;               // K bytes of a 64-byte-swizzled row
constexpr int kRows = 256;            // the TMA path's M tile: 2 x 2 x m64
constexpr int kRingBytes = 196608;    // its ring of stages, at most 8
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kSmallThreads = 256;    // the Cin = 3 path: 2 warpgroups,
                                      // a thread an M row
constexpr int kPatchMax = 8192;       // its staged input patch, bytes
constexpr int kSmallKpad = 192;       // its largest Kpad (3 x 64)

struct Shape {
  int batch, h, w, cin, ho, wo, cout, kh, kw, stride, pad_t, pad_l, kpad;
  int relu;
  int bw, bh, bn;        // the M tile: bn images x bh rows x bw columns
  int mt_x, mt_y, mt_n;  // M tiles along columns, rows, images
};

struct Tile {
  int n0, oy0, ox0, co0;
};

// Tile t: N tiles fastest (the blocks in flight share their A boxes in L2),
// then columns, rows, images.
__device__ __forceinline__ Tile tile_at(int t, const Shape& s, int bn_cols) {
  const int nt = s.cout / bn_cols;
  Tile c;
  c.co0 = (t % nt) * bn_cols;
  int m = t / nt;
  c.ox0 = (m % s.mt_x) * s.bw;
  m /= s.mt_x;
  c.oy0 = (m % s.mt_y) * s.bh;
  c.n0 = (m / s.mt_y) * s.bn;
  return c;
}

// The byte offset of 16-byte chunk `chunk` of row `row` in a tile of 64-byte
// rows aligned to 512 bytes, in the 64-byte swizzle (TMA's and wgmma's).
__device__ __forceinline__ uint32_t sw64(uint32_t row, uint32_t chunk) {
  return row * kCB + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// K-major operand in the CB-byte swizzle (CB = 64 or 128): rows of CB
// bytes, 8-row atoms of 8 CB bytes (stride byte offset), leading byte
// offset unused; layout type 2 (64-byte) or 1 (128-byte swizzle).
template <int CB>
__device__ __forceinline__ uint64_t desc_sw(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * CB >> 4) << 32) |
         ((uint64_t)(CB == 128 ? 1 : 2) << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to `d` across an asm boundary
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 64] += a[64 x 32] * b[32 x 64], s8 x s8 -> s32, both K-major
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] += a[64 x 32] * b[32 x 128], s8 x s8 -> s32, both K-major
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int (&d)[BN / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k32(d, da, db);
  else
    wgmma_m64n64k32(d, da, db);
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         int relu) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? (v > 0.f ? v : 0.f) : v;
}

// RN(y / s), the IEEE quotient, wherever rounding it to an integer and the
// clamp to [-127, 127] can tell it from a neighbour (|y / s| < 512), from
// r = RN(1 / s): q0 = RN(y r) is within two ulps of it, and each step
// q + RN(y - q s) r (the remainder exact in the fma) brings it closer, the
// second to RN(y / s) (Markstein's theorem; s and the quotient normal,
// 2^-100 <= s <= 2^100).  Elsewhere q0, which clamps, or rounds to 0, as
// the quotient does.  A true division (__fdiv_rn) costs more than all the
// rest of the kernel at VGG16's int8-out layers.
__device__ __forceinline__ float quotient(float y, float s, float r) {
  float q = __fmul_rn(y, r);
  if (fabsf(q) < 512.f) {
    q = __fmaf_rn(__fmaf_rn(-q, s, y), r, q);
    q = __fmaf_rn(__fmaf_rn(-q, s, y), r, q);
  }
  return q;
}

// clamp(rint(y / s), -127, 127) as a byte, r = RN(1 / s):
// ops/int8_conv.py:quantize
__device__ __forceinline__ uint32_t requant(float y, float s, float r) {
  const float q = fminf(fmaxf(rintf(quotient(y, s, r)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(q);
}

// The output offset of output pixel (n, oy, ox), channel co0, or -1 for a
// pixel outside the output.
__device__ __forceinline__ long long pixel_at(const Shape& s, int n, int oy,
                                              int ox, int co0) {
  return n < s.batch && oy < s.ho && ox < s.wo
             ? (((long long)n * s.ho + oy) * s.wo + ox) * s.cout + co0
             : -1;
}

// Accumulator (mi, 4i + e) of a warpgroup holds M row 64 mi + 16 warp +
// lane/4 + 8 (e >> 1) of its m64 blocks, channel 8i + 2 (lane & 3) + (e & 1)
// of the N tile.  patch_pixels: the output offsets of this thread's M rows
// where the tile's rows row0 + ... are its patch's pixels in (n, y, x)
// order (rows past bw bh bn: -1).
template <int MI>
__device__ __forceinline__ void patch_pixels(int row0, const Shape& s,
                                             const Tile& tc,
                                             long long (&pix)[MI][2]) {
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 64 * mi + 16 * warp + (lane >> 2) + 8 * half;
      const int yq = r / s.bw;
      pix[mi][half] = r < s.bw * s.bh * s.bn
                          ? pixel_at(s, tc.n0 + yq / s.bh,
                                     tc.oy0 + yq % s.bh, tc.ox0 + r % s.bw,
                                     tc.co0)
                          : -1;
    }
}

// The epilogue of one warpgroup's accumulators (MI m64 blocks) into out
// [batch, ho, wo, cout] (f32, or int8 with s_next), each M row to its
// offset in `pix` (-1: dropped), channels from co0.  Channel groups
// outermost: each scale / bias pair is loaded once for the thread's 2 MI
// rows.
template <int MI, int BN, bool kI8>
__device__ __forceinline__ void store_tile(const int (&acc)[MI][BN / 2],
                                           const long long (&pix)[MI][2],
                                           const Shape& s, int co0,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           float s_next,
                                           void* __restrict__ out) {
  const int q = threadIdx.x & 3;
  if constexpr (kI8) {
    const float r_next = __frcp_rn(s_next);
    int8_t* o = static_cast<int8_t*>(out);
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      float2 sc[4], bi[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int c = co0 + 8 * (4 * j + g) + 2 * q;
        sc[g] = __ldg(reinterpret_cast<const float2*>(scale + c));
        bi[g] = __ldg(reinterpret_cast<const float2*>(bias + c));
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // p[g]: this lane's two codes of channel group 4j + g
          uint32_t p[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int e = 4 * (4 * j + g) + 2 * half;
            p[g] = requant(dequant(acc[mi][e], sc[g].x, bi[g].x, s.relu),
                           s_next, r_next) |
                   requant(dequant(acc[mi][e + 1], sc[g].y, bi[g].y, s.relu),
                           s_next, r_next) << 8;
          }
          // a 4 x 4 transpose of 16-bit pairs across the quad: lane q ends
          // with group 4j + q's eight codes
          const uint32_t w0 = p[0] | p[1] << 16, w1 = p[2] | p[3] << 16;
          const bool odd = q & 1;
          const uint32_t snd = odd ? ((w0 & 0xffffu) | (w1 << 16))
                                   : ((w0 >> 16) | (w1 & 0xffff0000u));
          const uint32_t rcv = __shfl_xor_sync(0xffffffffu, snd, 1);
          const uint32_t a0 = odd ? ((rcv & 0xffffu) | (w0 & 0xffff0000u))
                                  : ((w0 & 0xffffu) | (rcv << 16));
          const uint32_t a1 = odd ? ((rcv >> 16) | (w1 & 0xffff0000u))
                                  : ((w1 & 0xffffu) | (rcv & 0xffff0000u));
          const bool hi = q & 2;
          const uint32_t rcv2 = __shfl_xor_sync(0xffffffffu, hi ? a0 : a1, 2);
          if (pix[mi][half] >= 0)
            *reinterpret_cast<uint2*>(o + pix[mi][half] + 8 * (4 * j + q)) =
                hi ? make_uint2(rcv2, a1) : make_uint2(a0, rcv2);
        }
    }
  } else {
    float* o = static_cast<float*>(out);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 8 * i + 2 * q;
      const float2 sc =
          __ldg(reinterpret_cast<const float2*>(scale + co0 + c));
      const float2 bi =
          __ldg(reinterpret_cast<const float2*>(bias + co0 + c));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 4 * i + 2 * half;
          const float v0 = dequant(acc[mi][e], sc.x, bi.x, s.relu);
          const float v1 = dequant(acc[mi][e + 1], sc.y, bi.y, s.relu);
          if (pix[mi][half] >= 0)
            *reinterpret_cast<float2*>(o + pix[mi][half] + c) =
                make_float2(v0, v1);
        }
    }
  }
}

// ---- the TMA path (Cin % 64 == 0) ---------------------------------------
// A stage is one tap's CB channels (CB = 128 where Cin % 128 == 0, else
// 64): A, 256 rows x CB bytes, then B, BN rows x CB bytes, in the CB-byte
// swizzle; as many stages as fit kRingBytes (at most 8), then the full and
// empty mbarriers.
template <int BN, int CB>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (kRows + BN) * CB;
}

template <int BN, int CB>
__host__ __device__ constexpr int ring_stages() {
  return kRingBytes / stage_bytes<BN, CB>() < 8
             ? kRingBytes / stage_bytes<BN, CB>()
             : 8;
}

template <int BN, int CB>
__host__ __device__ constexpr size_t tma_smem_bytes() {
  return 1024 + ring_stages<BN, CB>() * stage_bytes<BN, CB>() +
         16 * ring_stages<BN, CB>();
}

template <int BN, int CB, bool kI8>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float* __restrict__ out_scale,
                         void* __restrict__ out, const Shape s) {
  constexpr uint32_t kA = kRows * CB;
  constexpr uint32_t kStage = stage_bytes<BN, CB>();
  constexpr int kStages = ring_stages<BN, CB>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(aligned_smem(smem_raw));
  const uint32_t full0 = base + kStages * kStage;   // full[i]: full0 + 8 i
  const uint32_t empty0 = full0 + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      tma::mbar_init(full0 + 8 * i, 1);
      tma::mbar_init(empty0 + 8 * i, kConsumers / 32);   // a lane a warp
    }
  }
  __syncthreads();
  const int ntiles = s.mt_x * s.mt_y * s.mt_n * (s.cout / BN);
  const int kc = s.cin / CB;                // channel blocks a tap
  const int kiters = s.kh * s.kw * kc;

  if (threadIdx.x >= kConsumers) {          // the producer
    if (threadIdx.x != kConsumers) return;
    const uint32_t tx = (uint32_t)(s.bw * s.bh * s.bn + BN) * CB;
    int it = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tc = tile_at(t, s, BN);
      const int ix0 = tc.ox0 * s.stride - s.pad_l;
      const int iy0 = tc.oy0 * s.stride - s.pad_t;
      for (int k = 0; k < kiters; ++k, ++it) {
        const int st = it % kStages;
        tma::mbar_wait(empty0 + 8 * st, ((it / kStages) & 1) ^ 1);
        const int tap = k / kc, cb = k - tap * kc;
        const int dy = tap / s.kw, dx = tap - dy * s.kw;
        const uint32_t full = full0 + 8 * st;
        const uint32_t a = base + st * kStage;
        tma::mbar_arrive_expect_tx(full, tx);
        tma::load_4d(a, &x_map, full, cb * CB, ix0 + dx, iy0 + dy, tc.n0);
        tma::load_2d(a + kA, &w_map, full, tap * s.cin + cb * CB, tc.co0);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const bool arrives = (threadIdx.x & 31) == 0;
  const float s_next = kI8 ? __ldg(out_scale) : 0.f;
  int acc[2][BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tc = tile_at(t, s, BN);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0;
    int prev = 0;
    for (int k = 0; k < kiters; ++k, ++it) {
      const int st = it % kStages;
      tma::mbar_wait(full0 + 8 * st, (it / kStages) & 1);
      const uint32_t a = base + st * kStage + wg * (128 * CB);
      const uint32_t b = base + st * kStage + kA;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) fence_acc(acc[mi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CB / 32; ++kk) {
        const uint64_t db = desc_sw<CB>(b + 32 * kk);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          wgmma_k32<BN>(acc[mi], desc_sw<CB>(a + mi * 64 * CB + 32 * kk), db);
      }
      wgmma_commit();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) fence_acc(acc[mi]);
      if (k > 0) {
        wgmma_wait<1>();                    // stage `prev` has been read
        if (arrives) tma::mbar_arrive(empty0 + 8 * prev);
      }
      prev = st;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) fence_acc(acc[mi]);
    if (arrives) tma::mbar_arrive(empty0 + 8 * prev);
    long long pix[2][2];
    patch_pixels<2>(wg * 128, s, tc, pix);
    store_tile<2, BN, kI8>(acc, pix, s, tc.co0, scale, bias, s_next, out);
  }
}

// ---- the halo path (3x3 at stride 1, Cin == 64, Cout 64 or 128) -----------
// A work item is 8 x 16 output pixels of one image by 64 output channels,
// two 8 x 8 m64 blocks of a warpgroup; three warpgroups take the block's
// items in turns, so that two run their epilogues while one runs its
// products.  A is never re-read per tap: the tile's 10 x 18 input halo
// arrives once (for all its 64-channel items), as four planes of 16-byte
// channel chunks (one TMA box each, zero fill outside the image), and a
// tap's A operand is a window of it: in wgmma's unswizzled K-major layout
// an 8 x 16-byte core matrix is 8 consecutive pixels of one plane row, the
// next chunk the next plane (leading byte offset) and the next 8 rows the
// next halo row (stride byte offset), at any pixel offset.  All 9 taps of
// B (the whole kernel: 64 Cin) stay in shared memory.
constexpr int kHaloTH = 8, kHaloTW = 16;            // a work item's pixels
constexpr int kHaloH = kHaloTH + 2, kHaloW = kHaloTW + 2;
constexpr uint32_t kPlane = (kHaloH * kHaloW * 16 + 127) / 128 * 128;
constexpr uint32_t kHalo = 4 * kPlane;              // 64 channels
constexpr int kHaloStages = 6;
constexpr int kHaloWGs = 3;                         // consumer warpgroups
constexpr int kHaloThreads = 128 * kHaloWGs + 32;   // + the producer warp

__host__ __device__ constexpr size_t halo_smem_bytes(int cout) {
  return 1024 + 9 * cout * kCB + kHaloStages * kHalo +
         8 * (2 * kHaloStages + 1);
}

// K-major, no swizzle: core matrices of 8 rows x 16 bytes, the next K
// chunk at `lbo` bytes, the next 8 rows at `sbo` bytes
__device__ __forceinline__ uint64_t desc_plain(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <bool kI8>
__global__ void __launch_bounds__(kHaloThreads, 1)
    int8_conv_halo_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const float* __restrict__ out_scale,
                          void* __restrict__ out, const Shape s) {
  const int nh = s.cout / 64;               // 64-channel items a tile
  const uint32_t kB = 9 * s.cout * kCB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(aligned_smem(smem_raw));
  const uint32_t halo0 = base + kB;
  const uint32_t full0 = halo0 + kHaloStages * kHalo;   // full[i]: + 8 i
  const uint32_t empty0 = full0 + 8 * kHaloStages;
  const uint32_t wbar = empty0 + 8 * kHaloStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kHaloStages; ++i) {
      tma::mbar_init(full0 + 8 * i, 1);
      tma::mbar_init(empty0 + 8 * i, 4 * nh);   // a lane a warp of each item
    }
    tma::mbar_init(wbar, 1);
  }
  __syncthreads();
  const int tx = (s.wo + kHaloTW - 1) / kHaloTW;
  const int ty = (s.ho + kHaloTH - 1) / kHaloTH;
  const int ntiles = s.batch * ty * tx;

  if (threadIdx.x >= 128 * kHaloWGs) {     // the producer
    if (threadIdx.x != 128 * kHaloWGs) return;
    tma::mbar_arrive_expect_tx(wbar, kB);
    for (int tap = 0; tap < 9; ++tap)
      tma::load_2d(base + tap * s.cout * kCB, &w_map, wbar, tap * kCB, 0);
    int it = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
      const int st = it % kHaloStages;
      const int x0 = (t % tx) * kHaloTW, y0 = (t / tx % ty) * kHaloTH;
      tma::mbar_wait(empty0 + 8 * st, ((it / kHaloStages) & 1) ^ 1);
      tma::mbar_arrive_expect_tx(full0 + 8 * st, 4 * 16 * kHaloH * kHaloW);
      for (int c = 0; c < 4; ++c)
        tma::load_5d(halo0 + st * kHalo + c * kPlane, &x_map, full0 + 8 * st,
                     0, c, x0 - 1, y0 - 1, t / (tx * ty));
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const float s_next = kI8 ? __ldg(out_scale) : 0.f;
  tma::mbar_wait(wbar, 0);
  int acc[2][32];
  // item k of this block: its tile it = k / nh (the block's it-th tile),
  // output channels 64 (k % nh) ..
  for (int k = wg;; k += kHaloWGs) {
    const int it = k / nh, co0 = 64 * (k - it * nh);
    const int t = blockIdx.x + it * gridDim.x;
    if (t >= ntiles) break;
    const int st = it % kHaloStages;
    const int x0 = (t % tx) * kHaloTW, y0 = (t / tx % ty) * kHaloTH;
    tma::mbar_wait(full0 + 8 * st, (it / kHaloStages) & 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mi][i] = 0;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) fence_acc(acc[mi]);
    wgmma_fence();
    const uint32_t halo = halo0 + st * kHalo;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t db =
            desc_sw<kCB>(base + (tap * s.cout + co0) * kCB + 32 * kk);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          wgmma_m64n64k32(acc[mi],
                          desc_plain(halo + 2 * kk * kPlane +
                                         (dy * kHaloW + 8 * mi + dx) * 16,
                                     kPlane, kHaloW * 16),
                          db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) fence_acc(acc[mi]);
    if (lane == 0) tma::mbar_arrive(empty0 + 8 * st);
    // M row r = 8 g + i of block mi: pixel (y0 + g, x0 + 8 mi + i)
    long long pix[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        pix[mi][half] = pixel_at(s, t / (tx * ty), y0 + 2 * warp + half,
                                 x0 + 8 * mi + (lane >> 2), co0);
    store_tile<2, 64, kI8>(acc, pix, s, co0, scale, bias, s_next, out);
  }
}

// ---- the Cin = 3 path (Cout == 64, Kpad <= 192) ---------------------------
// Shared memory, sized by the shape (so that several blocks fit an SM): A
// [Kpad/64][256 rows][64 bytes], B [Kpad/64][64][64], the input patch (bn x
// ph x pw x Cin bytes, rounded up to 16), the offset table [Kpad] ints.
__host__ __device__ inline int small_patch_bytes(const Shape& s) {
  const int ph = (s.bh - 1) * s.stride + s.kh;
  const int pw = (s.bw - 1) * s.stride + s.kw;
  return (s.bn * ph * pw * s.cin + 15) / 16 * 16;
}

inline size_t small_smem_bytes(const Shape& s) {
  return 1024 + (size_t)s.kpad * (kSmallThreads + 64) +
         small_patch_bytes(s) + 4 * s.kpad;
}

template <bool kI8>
__global__ void __launch_bounds__(kSmallThreads)
    int8_conv_small_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ wpk,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ out_scale,
                           void* __restrict__ out, const Shape s) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = aligned_smem(smem_raw);
  const int nkb = s.kpad / kCB;
  unsigned char* bs = as + nkb * kSmallThreads * kCB;
  int8_t* patch = reinterpret_cast<int8_t*>(bs + nkb * 64 * kCB);
  int* koff = reinterpret_cast<int*>(patch + small_patch_bytes(s));
  const Tile tc = tile_at(blockIdx.x, s, 64);
  const int tid = threadIdx.x;
  const int ph = (s.bh - 1) * s.stride + s.kh;
  const int pw = (s.bw - 1) * s.stride + s.kw;
  const int k_real = s.kh * s.kw * s.cin;

  // B: the 64 rows of packed weights, 16 bytes a thread-step
  const int chunks = s.kpad / 16;
  for (int j = tid; j < 64 * chunks; j += kSmallThreads) {
    const int o = j / chunks, c = j - o * chunks;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                              wpk + (size_t)(tc.co0 + o) * s.kpad) + c);
    *reinterpret_cast<uint4*>(bs + (c >> 2) * (64 * kCB) + sw64(o, c & 3)) =
        v;
  }
  // the input patch of the tile, halo included, zeros outside the image;
  // unrolled, so that a thread's loads are in flight together
  const int iy0 = tc.oy0 * s.stride - s.pad_t;
  const int gx0 = (tc.ox0 * s.stride - s.pad_l) * s.cin;
  const int prow = pw * s.cin, wrow = s.w * s.cin;
#pragma unroll 4
  for (int j = tid; j < s.bn * ph * prow; j += kSmallThreads) {
    const int pr = j / prow, gb = gx0 + (j - pr * prow);
    const int n = tc.n0 + pr / ph, iy = iy0 + pr % ph;
    patch[j] = n < s.batch && iy >= 0 && iy < s.h && gb >= 0 && gb < wrow
                   ? x[((size_t)n * s.h + iy) * wrow + gb]
                   : (int8_t)0;
  }
  // k -> its byte in a pixel's window of the patch (-1: the zero padding)
  for (int k = tid; k < s.kpad; k += kSmallThreads) {
    int v = -1;
    if (k < k_real) {
      const int tap = k / s.cin, ci = k - tap * s.cin;
      const int dy = tap / s.kw, dx = tap - dy * s.kw;
      v = (dy * pw + dx) * s.cin + ci;
    }
    koff[k] = v;
  }
  __syncthreads();
  // A: thread r builds row r, pixel (n, y, x) of the tile, 4 K bytes at a
  // time, only the k-steps that hold real K
  const int nk32 = (k_real + 31) / 32;
  {
    const int r = tid;
    int rb = -1;                            // the pixel's window in the patch
    if (r < s.bw * s.bh * s.bn) {
      const int yq = r / s.bw;
      rb = (((yq / s.bh) * ph + (yq % s.bh) * s.stride) * pw +
            (r % s.bw) * s.stride) * s.cin;
    }
    for (int k0 = 0; k0 < 32 * nk32; k0 += 4) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int ko = koff[k0 + b];
        if (rb >= 0 && ko >= 0)
          word |= (uint32_t)(uint8_t)patch[rb + ko] << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(as + (k0 >> 6) * (kSmallThreads * kCB) +
                                   sw64(r, (k0 >> 4) & 3) + (k0 & 15)) = word;
    }
  }
  // A and B were written by ordinary stores and are read by wgmma (async
  // proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  int acc[2][32];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mi][i] = 0;
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  wgmma_fence();
  // warpgroup wg: rows 128 wg .. +127
  const uint32_t a0 = smem_u32(as) + (threadIdx.x >> 7) * (128 * kCB);
  const uint32_t b0 = smem_u32(bs);
#pragma unroll 1
  for (int ks = 0; ks < nk32; ++ks) {
    const uint32_t a = a0 + (ks >> 1) * (kSmallThreads * kCB) + (ks & 1) * 32;
    const uint64_t db =
        desc_sw<kCB>(b0 + (ks >> 1) * (64 * kCB) + (ks & 1) * 32);
    wgmma_m64n64k32(acc[0], desc_sw<kCB>(a), db);
    wgmma_m64n64k32(acc[1], desc_sw<kCB>(a + 64 * kCB), db);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  const float s_next = kI8 ? __ldg(out_scale) : 0.f;
  long long pix[2][2];
  patch_pixels<2>((threadIdx.x >> 7) * 128, s, tc, pix);
  store_tile<2, 64, kI8>(acc, pix, s, 0, scale, bias, s_next, out);
}

// ---- launch ------------------------------------------------------------
template <int BN, int CB, bool kI8>
cudaError_t launch_tma(const void* x, const void* wpk, const float* scale,
                       const float* bias, const float* out_scale, void* out,
                       const Shape& s, cudaStream_t stream) {
  static tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr CUtensorMapSwizzle kSwizzle =
      CB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // the input: dims innermost first (channel, column, row, image); one box
  // is a CB-channel block of bn x bh x bw pixels at the conv's stride
  const cuuint64_t xdims[4] = {(cuuint64_t)s.cin, (cuuint64_t)s.w,
                               (cuuint64_t)s.h, (cuuint64_t)s.batch};
  const cuuint64_t xstrides[3] = {(cuuint64_t)s.cin,
                                  (cuuint64_t)s.w * s.cin,
                                  (cuuint64_t)s.h * s.w * s.cin};
  const cuuint32_t xbox[4] = {(cuuint32_t)CB, (cuuint32_t)(s.bw * s.stride),
                              (cuuint32_t)(s.bh * s.stride),
                              (cuuint32_t)s.bn};
  const cuuint32_t xstep[4] = {1, (cuuint32_t)s.stride, (cuuint32_t)s.stride,
                               1};
  // the packed weights [cout, kpad]: one box is CB K bytes of BN rows
  const cuuint64_t wdims[2] = {(cuuint64_t)s.kpad, (cuuint64_t)s.cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)s.kpad};
  const cuuint32_t wbox[2] = {(cuuint32_t)CB, (cuuint32_t)BN};
  const cuuint32_t wstep[2] = {1, 1};
  CUtensorMap xm, wm;
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
             xdims, xstrides, xbox, xstep, CU_TENSOR_MAP_INTERLEAVE_NONE,
             kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wpk),
             wdims, wstrides, wbox, wstep, CU_TENSOR_MAP_INTERLEAVE_NONE,
             kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  constexpr size_t smem = tma_smem_bytes<BN, CB>();
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_tma_kernel<BN, CB, kI8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = s.mt_x * s.mt_y * s.mt_n * (s.cout / BN);
  int8_conv_tma_kernel<BN, CB, kI8>
      <<<vgg_stem::persistent_grid(ntiles), kThreads, smem, stream>>>(
          xm, wm, scale, bias, out_scale, out, s);
  return cudaGetLastError();
}

template <bool kI8>
cudaError_t launch_halo(const void* x, const void* wpk, const float* scale,
                        const float* bias, const float* out_scale, void* out,
                        const Shape& s, cudaStream_t stream) {
  static tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the input as 16-byte channel chunks: dims innermost first (byte,
  // chunk, column, row, image); one box is one chunk of a 10 x 18 halo
  const cuuint64_t xdims[5] = {16, (cuuint64_t)s.cin / 16, (cuuint64_t)s.w,
                               (cuuint64_t)s.h, (cuuint64_t)s.batch};
  const cuuint64_t xstrides[4] = {16, (cuuint64_t)s.cin,
                                  (cuuint64_t)s.w * s.cin,
                                  (cuuint64_t)s.h * s.w * s.cin};
  const cuuint32_t xbox[5] = {16, 1, kHaloW, kHaloH, 1};
  const cuuint32_t xstep[5] = {1, 1, 1, 1, 1};
  // the packed weights: one box is one tap's 64 K bytes of every row
  const cuuint64_t wdims[2] = {(cuuint64_t)s.kpad, (cuuint64_t)s.cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)s.kpad};
  const cuuint32_t wbox[2] = {(cuuint32_t)kCB, (cuuint32_t)s.cout};
  const cuuint32_t wstep[2] = {1, 1};
  CUtensorMap xm, wm;
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x),
             xdims, xstrides, xbox, xstep, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wpk),
             wdims, wstrides, wbox, wstep, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const size_t smem = halo_smem_bytes(s.cout);
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_halo_kernel<kI8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = s.batch * ((s.ho + kHaloTH - 1) / kHaloTH) *
                     ((s.wo + kHaloTW - 1) / kHaloTW);
  int8_conv_halo_kernel<kI8>
      <<<vgg_stem::persistent_grid(ntiles), kHaloThreads, smem, stream>>>(
          xm, wm, scale, bias, out_scale, out, s);
  return cudaGetLastError();
}

// The halo path's shapes: 3x3 at stride 1, 64 input channels, 64 or 128
// output channels (ops/int8_conv_cuda.py:tile_plan: path "halo").
inline bool halo_shape(int kh, int kw, int stride, int cin, int cout) {
  return kh == 3 && kw == 3 && stride == 1 && cin == kCB &&
         (cout == 64 || cout == 128);
}

template <bool kI8>
cudaError_t launch_small(const void* x, const void* wpk, const float* scale,
                         const float* bias, const float* out_scale, void* out,
                         const Shape& s, cudaStream_t stream) {
  const size_t smem = small_smem_bytes(s);
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_small_kernel<kI8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = s.mt_x * s.mt_y * s.mt_n;
  int8_conv_small_kernel<kI8><<<ntiles, kSmallThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wpk), scale,
      bias, out_scale, out, s);
  return cudaGetLastError();
}

template <bool kI8>
cudaError_t launch(const void* x, const void* wpk, const float* scale,
                   const float* bias, const float* out_scale, void* out,
                   const Shape& s, cudaStream_t stream) {
  if (s.cin % kCB) return launch_small<kI8>(x, wpk, scale, bias, out_scale,
                                            out, s, stream);
  const bool wide = s.cout % 128 == 0, deep = s.cin % 128 == 0;
  if (halo_shape(s.kh, s.kw, s.stride, s.cin, s.cout))
    return launch_halo<kI8>(x, wpk, scale, bias, out_scale, out, s, stream);
  if (deep)
    return wide ? launch_tma<128, 128, kI8>(x, wpk, scale, bias, out_scale,
                                            out, s, stream)
                : launch_tma<64, 128, kI8>(x, wpk, scale, bias, out_scale,
                                           out, s, stream);
  return wide ? launch_tma<128, 64, kI8>(x, wpk, scale, bias, out_scale, out,
                                         s, stream)
              : launch_tma<64, 64, kI8>(x, wpk, scale, bias, out_scale, out,
                                        s, stream);
}

}  // namespace

extern "C" {

// x [batch, h, w, cin] int8 NHWC (16-byte aligned), wpk [cout, kpad] int8,
// scale / bias [cout] f32, out [batch, ho, wo, cout]: int8 where out_scale
// (a device pointer to one f32) is given, else f32.  The M tile (bw, bh,
// bn, rows) from ops/int8_conv_cuda.py:tile_plan.  A 3x3 conv at stride 1
// of cin == 64 to cout 64 or 128 (the halo path: bw 16, bh 8, bn 1, rows
// 128); else cin % 64 == 0 (the TMA path: kpad == kh * kw * cin, rows 256,
// bw * stride and bh * stride <= 256), or cin < 16 (the small path: cout ==
// 64, kpad <= 192, rows 256, the patch within 8192 bytes); cout % 64 == 0,
// bw * bh * bn <= rows.  Launches on `stream`, does not synchronise, returns the
// cudaError_t of the set-up and launch.
int wssdl_int8_conv(const void* x, const void* wpk, const float* scale,
                    const float* bias, const float* out_scale, void* out,
                    int batch, int h, int w, int cin, int ho, int wo,
                    int cout, int kh, int kw, int stride, int pad_t,
                    int pad_l, int kpad, int relu, int bw, int bh, int bn,
                    int rows, cudaStream_t stream) {
  const int k_real = kh * kw * cin;
  bool ok = cout > 0 && cout % 64 == 0 && kpad % kCB == 0 &&
            kpad >= k_real && cin > 0 && stride > 0 && bw > 0 && bh > 0 &&
            bn > 0 && bw * bh * bn <= rows;
  if (halo_shape(kh, kw, stride, cin, cout))
    ok = ok && kpad == k_real && rows == kHaloTH * kHaloTW &&
         bw == kHaloTW && bh == kHaloTH && bn == 1;
  else if (cin % kCB == 0)
    ok = ok && kpad == k_real && rows == kRows &&
         bw * stride <= 256 && bh * stride <= 256 && bn <= 256;
  else
    ok = ok && cin < 16 && cout == 64 && kpad <= kSmallKpad &&
         rows == kSmallThreads &&
         bn * ((bh - 1) * stride + kh) * ((bw - 1) * stride + kw) * cin <=
             kPatchMax;
  if (!ok) return (int)cudaErrorInvalidValue;
  if ((long long)batch * ho * wo == 0) return 0;
  const Shape s{batch, h,  w,      cin,   ho,    wo,   cout,
                kh,    kw, stride, pad_t, pad_l, kpad, relu,
                bw,    bh, bn,     (wo + bw - 1) / bw,
                (ho + bh - 1) / bh, (batch + bn - 1) / bn};
  const cudaError_t err =
      out_scale ? launch<true>(x, wpk, scale, bias, out_scale, out, s, stream)
                : launch<false>(x, wpk, scale, bias, out_scale, out, s,
                                stream);
  return (int)err;
}

}  // extern "C"
