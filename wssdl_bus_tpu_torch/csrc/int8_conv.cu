// The int8 convolution of int8 serving for Hopper (sm_90a), with its f32
// epilogue:  out = [relu](float(acc) * scale[o] + bias[o]),
// acc = sum over (dy, dx, ci) of xq[b, oy*s - pt + dy, ox*s - pl + dx, ci]
//       * w[o, dy, dx, ci]   (s8 x s8 -> s32, zeros outside the image).
// xq [B, H, W, Cin] int8 NHWC; w packed [Cout, Kpad] int8 (taps in (dy, dx,
// ci) order, zero-padded: ops/int8_conv.py:pack_weight); scale, bias [Cout]
// f32; out [B, Ho, Wo, Cout] f32 NHWC.  TF "SAME" pads (top / left given,
// asymmetric at stride 2).
//
// No TPU kernel is replaced: the JAX package computes this conv with XLA's
// s8 x s8 -> s32 lax.conv_general_dilated(preferred_element_type=int32)
// (wssdl_bus_tpu/models/quantize.py:127, called at :158-160 and :259-261),
// and PyTorch has no int8 convolution that returns the int32 accumulator.
//
// What bounds it: operations for the 3x3 layers of VGG16 and the ResNet
// groups (2 * M * Cout * K int8 operations at 1,979 TOP/s dense), bytes
// for conv1_1 / conv0 (Cin = 3: K = 27 / 147, each output pixel's 64 f32
// outputs written once).  Design, simple first: an implicit GEMM (M =
// output pixels, N = Cout, K = kh * kw * Cin) on mma.sync m16n8k32 s8
// tiles from shared memory; 128 x BN x 64-byte block tiles (BN = 128, or
// 64 where Cout is not a multiple of 128), eight warps, double-buffered
// with cp.async.  Where Cin % 16 == 0 each 16-byte chunk of an A row is 16
// channels of one input pixel (one cp.async, zero-filled outside the
// image); Cin = 3 gathers byte by byte.  Rows are padded to 80 bytes, so
// the fragment loads hit 32 distinct banks.  The epilogue multiplies and
// then adds with explicit round-to-nearest intrinsics (two roundings, the
// plain version's and the JAX package's arithmetic), so the output equals
// ops/int8_conv.py:int8_conv_plain bit for bit: the int32 sum is exact in
// any order.  wgmma, TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;               // output pixels per block
constexpr int kBK = 64;                // K bytes per shared-memory tile
constexpr int kLd = kBK + 16;          // padded row, bytes
constexpr int kThreads = 256;

struct Shape {
  int batch, h, w, cin, ho, wo, cout, kh, kw, stride, pad_t, pad_l, kpad;
  int relu;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;       // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ wpk,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ out,
                     const Shape s) {
  constexpr int kWarpsN = BN / 32;
  constexpr int kWarpsM = 8 / kWarpsN;
  constexpr int kWM = kBM / kWarpsM;       // rows of one warp's tile
  constexpr int kMI = kWM / 16;            // m16 tiles per warp
  constexpr int kNI = 4;                   // n8 tiles per warp (32 columns)
  constexpr int kBRows = BN / 64;          // B chunk rows per thread
  __shared__ __align__(16) int8_t As[2][kBM * kLd];
  __shared__ __align__(16) int8_t Bs[2][BN * kLd];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const long long hw_out = (long long)s.ho * s.wo;
  const long long m_total = hw_out * s.batch;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int k_real = s.kh * s.kw * s.cin;

  // this thread's A rows (tid / 4 and + 64) and 16-byte chunk (tid % 4)
  const int kc = tid & 3;
  long long a_img[2];
  int a_iy[2], a_ix[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + i * 64;
    a_ok[i] = m < m_total;
    const long long mm = a_ok[i] ? m : 0;
    const long long b = mm / hw_out;
    const long long r = mm - b * hw_out;
    const int oy = (int)(r / s.wo), ox = (int)(r - (long long)oy * s.wo);
    a_img[i] = b * s.h;
    a_iy[i] = oy * s.stride - s.pad_t;
    a_ix[i] = ox * s.stride - s.pad_l;
  }

  auto load_tile = [&](int kt, int buf) {
    const int kbase = kt * kBK + kc * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int8_t* dst = &As[buf][((tid >> 2) + i * 64) * kLd + kc * 16];
      if constexpr (kVec) {
        // 16 channels of one input pixel (Cin % 16 == 0)
        const int tap = kbase / s.cin, ci = kbase - tap * s.cin;
        const int dy = tap / s.kw, dx = tap - dy * s.kw;
        const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
        const bool valid = a_ok[i] && kbase < k_real && iy >= 0 &&
                           iy < s.h && ix >= 0 && ix < s.w;
        const int8_t* src =
            valid ? x + (((a_img[i] + iy) * s.w + ix) * s.cin + ci) : x;
        cp_async16(smem_u32(dst), src, valid);
      } else {
        uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = kbase + j;
          if (!a_ok[i] || k >= k_real) continue;
          const int tap = k / s.cin, ci = k - tap * s.cin;
          const int dy = tap / s.kw, dx = tap - dy * s.kw;
          const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
          if (iy < 0 || iy >= s.h || ix < 0 || ix >= s.w) continue;
          const uint32_t v = (uint8_t)x[((a_img[i] + iy) * s.w + ix) * s.cin
                                        + ci];
          word[j >> 2] |= v << ((j & 3) * 8);
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      const int row = (tid >> 2) + j * 64;
      cp_async16(smem_u32(&Bs[buf][row * kLd + kc * 16]),
                 wpk + (long long)(n0 + row) * s.kpad + kbase, true);
    }
  };

  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int g = lane >> 2, t = lane & 3;
  const int ktiles = s.kpad / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) load_tile(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();                   // tile kt has landed
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const int8_t* p = &As[buf][(wm * kWM + mi * 16 + g) * kLd + ks + t * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int8_t* p = &Bs[buf][(wn * 32 + ni * 8 + g) * kLd + ks + t * 4];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();                     // buf is free for tile kt + 2
  }

  // epilogue: C fragment rows g and g + 8, columns 2t and 2t + 1
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + t * 2;
    const float sc0 = scale[col], sc1 = scale[col + 1];
    const float bi0 = bias[col], bi1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * kWM + mi * 16 + g + half * 8;
        if (m >= m_total) continue;
        float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * half]),
                                       sc0), bi0);
        float v1 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + 1]), sc1), bi1);
        if (s.relu) {
          v0 = v0 > 0.f ? v0 : 0.f;
          v1 = v1 > 0.f ? v1 : 0.f;
        }
        *reinterpret_cast<float2*>(out + m * s.cout + col) =
            make_float2(v0, v1);
      }
    }
  }
}

template <int BN>
cudaError_t launch(const int8_t* x, const int8_t* wpk, const float* scale,
                   const float* bias, float* out, const Shape& s,
                   cudaStream_t stream) {
  const long long m = (long long)s.batch * s.ho * s.wo;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)(s.cout / BN));
  if (s.cin % 16 == 0)
    int8_conv_kernel<BN, true><<<grid, kThreads, 0, stream>>>(
        x, wpk, scale, bias, out, s);
  else
    int8_conv_kernel<BN, false><<<grid, kThreads, 0, stream>>>(
        x, wpk, scale, bias, out, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch, h, w, cin] int8 NHWC (16-byte aligned), wpk [cout, kpad] int8,
// scale / bias [cout] f32, out [batch, ho, wo, cout] f32; cout % 64 == 0,
// kpad % 64 == 0 and kpad >= kh * kw * cin.  Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch.
int wssdl_int8_conv(const void* x, const void* wpk, const float* scale,
                    const float* bias, float* out, int batch, int h, int w,
                    int cin, int ho, int wo, int cout, int kh, int kw,
                    int stride, int pad_t, int pad_l, int kpad, int relu,
                    cudaStream_t stream) {
  if (cout % 64 || kpad % kBK || kpad < kh * kw * cin || cin <= 0 ||
      stride <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * ho * wo == 0) return 0;
  const Shape s{batch, h,  w,     cin,   ho,    wo,   cout,
                kh,    kw, stride, pad_t, pad_l, kpad, relu};
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wpk);
  const cudaError_t err =
      cout % 128 == 0 ? launch<128>(xp, wp, scale, bias, out, s, stream)
                      : launch<64>(xp, wp, scale, bias, out, s, stream);
  return (int)err;
}

}  // extern "C"
