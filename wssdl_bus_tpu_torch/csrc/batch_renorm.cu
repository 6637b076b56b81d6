// Training-mode BatchRenorm (+ ReLU) for Hopper (sm_90a): a forward and a
// backward of two passes over the tensor each.
//
// No TPU kernel is replaced: the JAX package's BatchRenorm
// (wssdl_bus_tpu/models/layers.py) is jnp code that XLA fuses on the TPU.
// In PyTorch the same function ran as a chain of some 25 elementwise and
// reduction ops a forward and as many a backward, most of them PyTorch's
// non-vectorised elementwise kernel (a [1, C, 1, 1] view broadcast against
// a channels_last tensor), which filled most of a ResNet training step's
// device time.
//
// x [M, C] f32 is the NHWC view of a channels_last NCHW tensor (M = N*H*W).
// The arithmetic is ops/batch_renorm.py's plain version:
//   mean, var      the batch moments over M, the var biased
//   sigma_b        sqrt(var + eps);  sigma_m = sqrt(ra_var + eps)
//   r, d           sigma_b / sigma_m, (mean - ra_mean) / sigma_m (constants
//                  to the gradient)
//   a, c           gamma * r / sigma_b, beta + gamma * d
//   y              (x - mean) * a + c, then ReLU (y <= 0 -> 0) with relu
//   ra_mean/ra_var momentum * ra + (1 - momentum) * batch, in place, where
//                  update holds (read before they are written)
// and in the backward, with g = dy (relu: 0 where y <= 0, y recomputed as
// above) and xhat = (x - mean) * inv, inv = 1 / sigma_b:
//   s1, s2         sum g, sum g * xhat
//   dbeta, dgamma  s1, r * s2 + d * s1
//   dx             a * ((g - s1 / M) - xhat * (s2 / M))
// The file is built with -fmad=false, so a * b + c is two roundings here as
// in the plain version's separate PyTorch ops.
//
// What bounds it: bytes.  A few operations an element against 4 bytes of
// f32; the forward must read x twice (the statistics, then the output) and
// write y, 12 bytes an element, and the backward read x and dy twice and
// write dx, 20 bytes.  Nothing else goes to device memory: the backward
// keeps only x and six per-channel vectors (mean, inv, r, d, a, c), never
// y, x - mean, xhat or a ReLU mask.  The design:
//
//   * Every pass over the tensor is one grid of 256-thread blocks.  A
//     thread owns V adjacent channels (V = 4, one 16-byte load, where C %
//     4 == 0 and the tensors are 16-byte aligned; else V = 1); a block is
//     cs channel groups wide (at most 256 channels) and `lanes` rows deep,
//     so a warp reads whole 512-byte runs of a row, or of consecutive rows
//     where C is narrow.  The grid is (C / (cs*V) channel slices) x (row
//     tiles), ops/batch_renorm_cuda.py:plan: the tiles are as many as make
//     four blocks an SM on the 132 SMs (one wave, four resident: the
//     launch bounds hold each thread to 64 registers), fewer only where a
//     lane would not get kBatch rows.
//   * The statistics pass keeps a count, mean and M2 a channel in
//     registers: it loads kBatch rows at once (the loads in flight), takes
//     their mean and M2 exactly in two passes over the registers, and
//     merges them (Chan et al.).  The lanes of a block merge in a fixed
//     tree in shared memory, the block writes its tile's mean and M2 to a
//     [tiles][2][C] scratch, and a warp a channel merges the tiles in a
//     fixed order (strided over the lanes, then a shuffle tree).  No
//     E[x^2] - mean^2, and no float atomics: a run repeats bit for bit.
//   * The finalize folds the statistics into the per-channel vectors, so
//     the output pass is three operations an element; the backward's sums
//     take the same tiling and the same fixed-order merge as plain sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a block of the passes over the tensor
constexpr int kMinBlocks = 4;   // blocks an SM: 64 registers a thread
constexpr int kBatch = 8;       // rows the statistics pass loads at once
constexpr int kUnroll = 4;      // rows the output pass loads at once
constexpr int kUnrollGrad = 2;  // rows the backward's passes load at once
constexpr unsigned kFull = 0xffffffffu;

// The per-channel vectors the forward's finalize writes ([6][C]).
enum { kMean = 0, kInv, kR, kD, kA, kC };

struct Geo {
  long long rows;      // M
  int channels;        // C
  int cs;              // channel groups a block (blockDim.x = cs * lanes)
  int lanes;           // rows a block reads side by side
  long long rpt;       // rows a tile (the last tile may hold fewer)
};

// This thread's place in a pass: channel group g (first channel ch), lane,
// and its tile's rows [r0, r1).
struct Place {
  int g, ch, lane;
  long long r0, r1;
};

template <int V>
__device__ __forceinline__ Place place(const Geo& geo) {
  Place p;
  const int tx = threadIdx.x % geo.cs;
  p.lane = threadIdx.x / geo.cs;
  p.g = blockIdx.x * geo.cs + tx;
  p.ch = p.g * V;
  p.r0 = (long long)blockIdx.y * geo.rpt;
  p.r1 = min(geo.rows, p.r0 + geo.rpt);
  return p;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

// Merge (nb, mb, qb) into (n, mu, m2): counts, means and sums of squared
// deviations of two disjoint sets of rows (Chan et al.); an empty side
// leaves the other as it is.
template <int V>
__device__ __forceinline__ void chan(float& n, float (&mu)[V], float (&m2)[V],
                                     float nb, const float (&mb)[V],
                                     const float (&qb)[V]) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
#pragma unroll
    for (int j = 0; j < V; ++j) { mu[j] = mb[j]; m2[j] = qb[j]; }
    return;
  }
  const float nt = n + nb;
  const float w = nb / nt;
  const float w2 = n * w;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float delta = mb[j] - mu[j];
    mu[j] = mu[j] + delta * w;
    m2[j] = m2[j] + qb[j] + delta * delta * w2;
  }
  n = nt;
}

// y = (x - mean) * a + c, the forward's output before the ReLU; the
// backward recomputes it for the ReLU's mask with the same operations.
__device__ __forceinline__ float affine(float x, float mean, float a,
                                        float c) {
  return (x - mean) * a + c;
}

// Pass 1 of the forward: each block's tile mean and M2 of its channels ->
// part [tiles][2][C].
template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
br_stats(const float* __restrict__ x, Geo geo, float* __restrict__ part) {
  __shared__ float sh[kThreads * 9];
  const Place p = place<V>(geo);
  const int groups = geo.channels / V;
  const int C = geo.channels;
  float n = 0.f, mu[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) { mu[j] = 0.f; m2[j] = 0.f; }
  if (p.g < groups) {
    const long long step = (long long)geo.lanes * kBatch;
    for (long long base = p.r0 + p.lane; base < p.r1; base += step) {
      float v[kBatch][V];
      int nb = 0;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const long long r = base + (long long)k * geo.lanes;
        if (r < p.r1) {
          load<V>(x + r * C + p.ch, v[k]);
          nb = k + 1;
        }
      }
      // the batch's mean and M2, merged as chan() does (nb > 0; with n
      // == 0 the weights are exactly 1 and 0)
      const float fnb = (float)nb;
      const float nt = n + fnb;
      const float w = fnb / nt;
      const float w2 = n * w;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (k < nb) s = s + v[k][j];
        // kBatch is a power of two: the product is the quotient
        const float bm = nb == kBatch ? s * (1.f / kBatch) : s / fnb;
        float q = 0.f;
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (k < nb) {
            const float t = v[k][j] - bm;
            q = q + t * t;
          }
        const float delta = bm - mu[j];
        mu[j] = mu[j] + delta * w;
        m2[j] = m2[j] + q + delta * delta * w2;
      }
      n = nt;
    }
  }
  // the block's lanes merge in a fixed tree: lane l takes lane l + s
  const int tid = threadIdx.x, nth = blockDim.x;
  float* sn = sh;
  float* smu = sh + nth;
  float* sm2 = smu + V * nth;
  sn[tid] = n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    smu[j * nth + tid] = mu[j];
    sm2[j * nth + tid] = m2[j];
  }
  for (int s = 1; s < geo.lanes; s <<= 1) {
    __syncthreads();
    if (p.lane % (2 * s) == 0 && p.lane + s < geo.lanes) {
      const int o = tid + s * geo.cs;
      float ob[V], oq[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ob[j] = smu[j * nth + o];
        oq[j] = sm2[j * nth + o];
      }
      chan<V>(n, mu, m2, sn[o], ob, oq);
      sn[tid] = n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        smu[j * nth + tid] = mu[j];
        sm2[j * nth + tid] = m2[j];
      }
    }
  }
  if (p.lane == 0 && p.g < groups) {
    float* out = part + (long long)blockIdx.y * 2 * C + p.ch;
    store<V>(out, mu);
    store<V>(out + C, m2);
  }
}

// Pass 1 of the backward: each block's tile sums s1 = sum g and s2 = sum g
// * xhat of its channels -> part [tiles][2][C].
template <int V, bool RELU>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
br_grad_sums(const float* __restrict__ x, const float* __restrict__ dy,
             const float* __restrict__ vecs, Geo geo,
             float* __restrict__ part) {
  __shared__ float sh[kThreads * 8];
  const Place p = place<V>(geo);
  const int groups = geo.channels / V;
  const int C = geo.channels;
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) { s1[j] = 0.f; s2[j] = 0.f; }
  if (p.g < groups) {
    float mean[V], inv[V], a[V], c[V];
    load<V>(vecs + kMean * C + p.ch, mean);
    load<V>(vecs + kInv * C + p.ch, inv);
    load<V>(vecs + kA * C + p.ch, a);
    load<V>(vecs + kC * C + p.ch, c);
    const long long step = (long long)geo.lanes * kUnrollGrad;
    for (long long base = p.r0 + p.lane; base < p.r1; base += step) {
      float xv[kUnrollGrad][V], gv[kUnrollGrad][V];
#pragma unroll
      for (int k = 0; k < kUnrollGrad; ++k) {
        const long long r = base + (long long)k * geo.lanes;
        if (r < p.r1) {
          load<V>(x + r * C + p.ch, xv[k]);
          load<V>(dy + r * C + p.ch, gv[k]);
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float b1 = 0.f, b2 = 0.f;
#pragma unroll
        for (int k = 0; k < kUnrollGrad; ++k)
          if (base + (long long)k * geo.lanes < p.r1) {
            float g = gv[k][j];
            if (RELU && affine(xv[k][j], mean[j], a[j], c[j]) <= 0.f)
              g = 0.f;
            const float xh = (xv[k][j] - mean[j]) * inv[j];
            b1 = b1 + g;
            b2 = b2 + g * xh;
          }
        s1[j] = s1[j] + b1;
        s2[j] = s2[j] + b2;
      }
    }
  }
  const int tid = threadIdx.x, nth = blockDim.x;
  float* t1 = sh;
  float* t2 = sh + V * nth;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    t1[j * nth + tid] = s1[j];
    t2[j * nth + tid] = s2[j];
  }
  for (int s = 1; s < geo.lanes; s <<= 1) {
    __syncthreads();
    if (p.lane % (2 * s) == 0 && p.lane + s < geo.lanes) {
      const int o = tid + s * geo.cs;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] = s1[j] + t1[j * nth + o];
        s2[j] = s2[j] + t2[j * nth + o];
        t1[j * nth + tid] = s1[j];
        t2[j * nth + tid] = s2[j];
      }
    }
  }
  if (p.lane == 0 && p.g < groups) {
    float* out = part + (long long)blockIdx.y * 2 * C + p.ch;
    store<V>(out, s1);
    store<V>(out + C, s2);
  }
}

// The forward's finalize: a warp a channel merges the tiles' statistics,
// folds them into vecs [6][C] and updates the running statistics.
__global__ void br_finalize(const float* __restrict__ part, int tiles,
                            long long rows, long long rpt, int C,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta, float* ra_mean,
                            float* ra_var, int update, float momentum,
                            float keep, float eps, float* __restrict__ vecs) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= C) return;     // whole warps: blockDim.x is a multiple of 32
  float n = 0.f, mu[1] = {0.f}, m2[1] = {0.f};
  for (int t = lane; t < tiles; t += 32) {
    const long long r0 = (long long)t * rpt;
    const float nb = (float)(min(rows, r0 + rpt) - r0);
    const float mb[1] = {part[(long long)t * 2 * C + c]};
    const float qb[1] = {part[((long long)t * 2 + 1) * C + c]};
    chan<1>(n, mu, m2, nb, mb, qb);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(kFull, n, off);
    const float mb[1] = {__shfl_down_sync(kFull, mu[0], off)};
    const float qb[1] = {__shfl_down_sync(kFull, m2[0], off)};
    if (lane + off < 32) chan<1>(n, mu, m2, nb, mb, qb);
  }
  if (lane != 0) return;
  const float mean = mu[0];
  const float var = m2[0] / (float)rows;
  const float sigma_b = sqrtf(var + eps);
  const float rm = ra_mean[c], rv = ra_var[c];
  const float sigma_m = sqrtf(rv + eps);
  const float r = sigma_b / sigma_m;
  const float d = (mean - rm) / sigma_m;
  vecs[kMean * C + c] = mean;
  vecs[kInv * C + c] = 1.f / sigma_b;
  vecs[kR * C + c] = r;
  vecs[kD * C + c] = d;
  vecs[kA * C + c] = gamma[c] * r / sigma_b;
  vecs[kC * C + c] = beta[c] + gamma[c] * d;
  if (update) {
    ra_mean[c] = momentum * rm + keep * mean;
    ra_var[c] = momentum * rv + keep * var;
  }
}

// The backward's finalize: a warp a channel sums the tiles' s1 and s2 ->
// dbeta, dgamma and coef [2][C] = (s1 / M, s2 / M).
__global__ void br_grad_finalize(const float* __restrict__ part, int tiles,
                                 long long rows, int C,
                                 const float* __restrict__ vecs,
                                 float* __restrict__ dgamma,
                                 float* __restrict__ dbeta,
                                 float* __restrict__ coef) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= C) return;
  float s1 = 0.f, s2 = 0.f;
  for (int t = lane; t < tiles; t += 32) {
    s1 = s1 + part[(long long)t * 2 * C + c];
    s2 = s2 + part[((long long)t * 2 + 1) * C + c];
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float o1 = __shfl_down_sync(kFull, s1, off);
    const float o2 = __shfl_down_sync(kFull, s2, off);
    if (lane + off < 32) { s1 = s1 + o1; s2 = s2 + o2; }
  }
  if (lane != 0) return;
  const float fm = (float)rows;
  dbeta[c] = s1;
  dgamma[c] = vecs[kR * C + c] * s2 + vecs[kD * C + c] * s1;
  coef[c] = s1 / fm;
  coef[C + c] = s2 / fm;
}

// Pass 2 of the forward: y = (x - mean) * a + c (+ ReLU).
template <int V, bool RELU>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
br_apply(const float* __restrict__ x, const float* __restrict__ vecs, Geo geo,
         float* __restrict__ y) {
  const Place p = place<V>(geo);
  const int C = geo.channels;
  if (p.g >= C / V) return;
  float mean[V], a[V], c[V];
  load<V>(vecs + kMean * C + p.ch, mean);
  load<V>(vecs + kA * C + p.ch, a);
  load<V>(vecs + kC * C + p.ch, c);
  const long long step = (long long)geo.lanes * kUnroll;
  for (long long base = p.r0 + p.lane; base < p.r1; base += step) {
    float v[kUnroll][V];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long r = base + (long long)k * geo.lanes;
      if (r < p.r1) load<V>(x + r * C + p.ch, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long r = base + (long long)k * geo.lanes;
      if (r < p.r1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = affine(v[k][j], mean[j], a[j], c[j]);
          v[k][j] = RELU && t <= 0.f ? 0.f : t;
        }
        store<V>(y + r * C + p.ch, v[k]);
      }
    }
  }
}

// Pass 2 of the backward: dx = a * ((g - s1 / M) - xhat * (s2 / M)).
template <int V, bool RELU>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
br_grad_x(const float* __restrict__ x, const float* __restrict__ dy,
          const float* __restrict__ vecs, const float* __restrict__ coef,
          Geo geo, float* __restrict__ dx) {
  const Place p = place<V>(geo);
  const int C = geo.channels;
  if (p.g >= C / V) return;
  float mean[V], inv[V], a[V], c[V], p1[V], p2[V];
  load<V>(vecs + kMean * C + p.ch, mean);
  load<V>(vecs + kInv * C + p.ch, inv);
  load<V>(vecs + kA * C + p.ch, a);
  load<V>(vecs + kC * C + p.ch, c);
  load<V>(coef + p.ch, p1);
  load<V>(coef + C + p.ch, p2);
  const long long step = (long long)geo.lanes * kUnrollGrad;
  for (long long base = p.r0 + p.lane; base < p.r1; base += step) {
    float xv[kUnrollGrad][V], gv[kUnrollGrad][V];
#pragma unroll
    for (int k = 0; k < kUnrollGrad; ++k) {
      const long long r = base + (long long)k * geo.lanes;
      if (r < p.r1) {
        load<V>(x + r * C + p.ch, xv[k]);
        load<V>(dy + r * C + p.ch, gv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnrollGrad; ++k) {
      const long long r = base + (long long)k * geo.lanes;
      if (r < p.r1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float g = gv[k][j];
          if (RELU && affine(xv[k][j], mean[j], a[j], c[j]) <= 0.f)
            g = 0.f;
          const float xh = (xv[k][j] - mean[j]) * inv[j];
          gv[k][j] = a[j] * ((g - p1[j]) - xh * p2[j]);
        }
        store<V>(dx + r * C + p.ch, gv[k]);
      }
    }
  }
}

bool geo_ok(const Geo& geo, int vec, int tiles) {
  return (vec == 1 || vec == 4) && geo.rows > 0 && geo.channels > 0 &&
         geo.channels % vec == 0 && geo.cs > 0 && geo.lanes > 0 &&
         geo.cs * geo.lanes <= kThreads && geo.rpt > 0 && tiles > 0 &&
         tiles <= 65535 && (long long)(tiles - 1) * geo.rpt < geo.rows &&
         (long long)tiles * geo.rpt >= geo.rows;
}

dim3 pass_grid(const Geo& geo, int vec, int tiles) {
  const int groups = geo.channels / vec;
  return dim3((groups + geo.cs - 1) / geo.cs, tiles);
}

dim3 warp_grid(int C) { return dim3((C * 32 + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// The forward: x [rows, C] f32 (16-byte aligned where vec == 4), gamma,
// beta, ra_mean, ra_var [C] f32, part a scratch of tiles * 2 * C floats,
// vecs [6][C] out (mean, 1 / sigma_b, r, d, a, c), y [rows, C] out.  The
// plan (vec, cs, lanes, tiles, rpt) is ops/batch_renorm_cuda.py:plan's.
// Launches three kernels on `stream` (statistics, finalize, output), does
// not synchronise, returns the first cudaError_t (cudaErrorInvalidValue
// for a plan it does not take).
int wssdl_batch_renorm_fwd(const float* x, const float* gamma,
                           const float* beta, float* ra_mean, float* ra_var,
                           int update, float momentum, float keep, float eps,
                           int relu, long long rows, int C, int vec, int cs,
                           int lanes, int tiles, long long rpt, float* part,
                           float* vecs, float* y, cudaStream_t stream) {
  const Geo geo{rows, C, cs, lanes, rpt};
  if (!geo_ok(geo, vec, tiles)) return (int)cudaErrorInvalidValue;
  const dim3 grid = pass_grid(geo, vec, tiles);
  const dim3 block(cs * lanes);
  if (vec == 4)
    br_stats<4><<<grid, block, 0, stream>>>(x, geo, part);
  else
    br_stats<1><<<grid, block, 0, stream>>>(x, geo, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  br_finalize<<<warp_grid(C), kThreads, 0, stream>>>(
      part, tiles, rows, rpt, C, gamma, beta, ra_mean, ra_var, update,
      momentum, keep, eps, vecs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec == 4 && relu)
    br_apply<4, true><<<grid, block, 0, stream>>>(x, vecs, geo, y);
  else if (vec == 4)
    br_apply<4, false><<<grid, block, 0, stream>>>(x, vecs, geo, y);
  else if (relu)
    br_apply<1, true><<<grid, block, 0, stream>>>(x, vecs, geo, y);
  else
    br_apply<1, false><<<grid, block, 0, stream>>>(x, vecs, geo, y);
  return (int)cudaGetLastError();
}

// The backward: x and dy [rows, C] f32 (16-byte aligned where vec == 4),
// vecs the forward's, part a scratch of tiles * 2 * C floats, coef a
// scratch of 2 * C, dgamma and dbeta [C] out, dx [rows, C] out.  Launches
// three kernels (sums, finalize, dx), as wssdl_batch_renorm_fwd.
int wssdl_batch_renorm_bwd(const float* x, const float* dy, const float* vecs,
                           int relu, long long rows, int C, int vec, int cs,
                           int lanes, int tiles, long long rpt, float* part,
                           float* coef, float* dgamma, float* dbeta,
                           float* dx, cudaStream_t stream) {
  const Geo geo{rows, C, cs, lanes, rpt};
  if (!geo_ok(geo, vec, tiles)) return (int)cudaErrorInvalidValue;
  const dim3 grid = pass_grid(geo, vec, tiles);
  const dim3 block(cs * lanes);
  if (vec == 4 && relu)
    br_grad_sums<4, true><<<grid, block, 0, stream>>>(x, dy, vecs, geo, part);
  else if (vec == 4)
    br_grad_sums<4, false><<<grid, block, 0, stream>>>(x, dy, vecs, geo, part);
  else if (relu)
    br_grad_sums<1, true><<<grid, block, 0, stream>>>(x, dy, vecs, geo, part);
  else
    br_grad_sums<1, false><<<grid, block, 0, stream>>>(x, dy, vecs, geo, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  br_grad_finalize<<<warp_grid(C), kThreads, 0, stream>>>(
      part, tiles, rows, C, vecs, dgamma, dbeta, coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec == 4 && relu)
    br_grad_x<4, true><<<grid, block, 0, stream>>>(x, dy, vecs, coef, geo, dx);
  else if (vec == 4)
    br_grad_x<4, false><<<grid, block, 0, stream>>>(x, dy, vecs, coef, geo, dx);
  else if (relu)
    br_grad_x<1, true><<<grid, block, 0, stream>>>(x, dy, vecs, coef, geo, dx);
  else
    br_grad_x<1, false><<<grid, block, 0, stream>>>(x, dy, vecs, coef, geo, dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
