// Native host-side runtime kernels of the PyTorch/CUDA port.
//
// The port's own copy of the JAX package's native/wssdl_native.cc (the
// code is the same, so both give the same bits): greedy NMS, dense IoU /
// unidirectional-overlap matrices, and the image-preparation hot loops
// (bilinear resize, rotation, brightness/contrast), the host half of the
// reference detector's Cython/C++ components (its nms/cpu_nms.pyx,
// utils/bbox.pyx, utils/bbox_ui.pyx and utils/blob.py).  They serve the
// HOST paths: per-class NMS at evaluation time, metric computation and the
// data pipeline's image preparation.
//
// Exposed as a plain C ABI consumed via ctypes
// (wssdl_bus_tpu_torch/native/__init__.py), built with g++ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Greedy IoU NMS over score-DESC-sorted dets [n, 5] = (x1,y1,x2,y2,score).
// keep_out must hold n ints; returns number kept.  +1 pixel-extent areas.
int wssdl_nms(const float* dets, int n, float thresh, int* keep_out) {
  std::vector<float> areas(n);
  std::vector<char> suppressed(n, 0);
  for (int i = 0; i < n; ++i) {
    const float* d = dets + 5 * i;
    areas[i] = (d[2] - d[0] + 1.f) * (d[3] - d[1] + 1.f);
  }
  int n_keep = 0;
  for (int i = 0; i < n; ++i) {
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float* a = dets + 5 * i;
    for (int j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const float* b = dets + 5 * j;
      const float iw =
          std::min(a[2], b[2]) - std::max(a[0], b[0]) + 1.f;
      if (iw <= 0.f) continue;
      const float ih =
          std::min(a[3], b[3]) - std::max(a[1], b[1]) + 1.f;
      if (ih <= 0.f) continue;
      const float inter = iw * ih;
      const float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr >= thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// Dense IoU matrix: boxes [n,4] x query [k,4] -> out [n,k].
void wssdl_bbox_overlaps(const float* boxes, int n, const float* query,
                         int k, float* out) {
  for (int j = 0; j < k; ++j) {
    const float* q = query + 4 * j;
    const float qa = (q[2] - q[0] + 1.f) * (q[3] - q[1] + 1.f);
    for (int i = 0; i < n; ++i) {
      const float* b = boxes + 4 * i;
      const float iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1.f;
      float v = 0.f;
      if (iw > 0.f) {
        const float ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1.f;
        if (ih > 0.f) {
          const float ba = (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f);
          const float ua = ba + qa - iw * ih;
          v = iw * ih / ua;
        }
      }
      out[i * k + j] = v;
    }
  }
}

// Unidirectional overlap: intersection / area(box_i)  (bbox_ui.pyx:12-47).
void wssdl_bbox_overlaps_ui(const float* boxes, int n, const float* query,
                            int k, float* out) {
  for (int j = 0; j < k; ++j) {
    const float* q = query + 4 * j;
    for (int i = 0; i < n; ++i) {
      const float* b = boxes + 4 * i;
      const float iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1.f;
      float v = 0.f;
      if (iw > 0.f) {
        const float ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1.f;
        if (ih > 0.f) {
          const float ba = (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f);
          v = iw * ih / ba;
        }
      }
      out[i * k + j] = v;
    }
  }
}

// Bilinear resize of a single-channel float image [h,w] -> [oh,ow].
// Matches PIL.Image.resize(..., BILINEAR): separable triangle-filter
// resampling with half-pixel centers; on downscale the filter support is
// scaled by the ratio (antialiasing), on upscale it is the classic 2-tap
// bilinear.  Weights are precomputed per output row/column.
namespace {

struct ResampleAxis {
  std::vector<int> lo;        // first source index per output index
  std::vector<int> count;     // taps per output index
  std::vector<float> weight;  // [out, max_taps] row-major, normalized
  int max_taps = 0;
};

ResampleAxis build_axis(int in_size, int out_size) {
  ResampleAxis ax;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // triangle filter radius
  ax.max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  ax.lo.resize(out_size);
  ax.count.resize(out_size);
  ax.weight.assign(static_cast<size_t>(out_size) * ax.max_taps, 0.f);
  for (int o = 0; o < out_size; ++o) {
    const double center = (o + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    int hi = static_cast<int>(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    ax.lo[o] = lo;
    ax.count[o] = hi - lo;
    double total = 0.0;
    for (int i = lo; i < hi; ++i) {
      const double x = (i - center + 0.5) / filterscale;
      const double wv = (std::abs(x) < 1.0) ? 1.0 - std::abs(x) : 0.0;
      ax.weight[static_cast<size_t>(o) * ax.max_taps + (i - lo)] =
          static_cast<float>(wv);
      total += wv;
    }
    if (total > 0.0) {
      for (int t = 0; t < ax.count[o]; ++t)
        ax.weight[static_cast<size_t>(o) * ax.max_taps + t] /=
            static_cast<float>(total);
    }
  }
  return ax;
}

}  // namespace

void wssdl_resize_bilinear(const float* src, int h, int w, float* dst,
                           int oh, int ow) {
  const ResampleAxis ay = build_axis(h, oh);
  const ResampleAxis axx = build_axis(w, ow);
  // horizontal pass: [h, ow]
  std::vector<float> tmp(static_cast<size_t>(h) * ow);
  for (int y = 0; y < h; ++y) {
    const float* row = src + static_cast<size_t>(y) * w;
    for (int ox = 0; ox < ow; ++ox) {
      const float* wv =
          &axx.weight[static_cast<size_t>(ox) * axx.max_taps];
      float acc = 0.f;
      for (int t = 0; t < axx.count[ox]; ++t)
        acc += row[axx.lo[ox] + t] * wv[t];
      tmp[static_cast<size_t>(y) * ow + ox] = acc;
    }
  }
  // vertical pass: [oh, ow]
  for (int oy = 0; oy < oh; ++oy) {
    const float* wv = &ay.weight[static_cast<size_t>(oy) * ay.max_taps];
    for (int ox = 0; ox < ow; ++ox) {
      float acc = 0.f;
      for (int t = 0; t < ay.count[oy]; ++t)
        acc += tmp[static_cast<size_t>(ay.lo[oy] + t) * ow + ox] * wv[t];
      dst[static_cast<size_t>(oy) * ow + ox] = acc;
    }
  }
}

// Rotation about the image center by `degrees`, bilinear, constant fill
// (scipy.ndimage.rotate(reshape=False, order=1, mode='constant') semantics).
void wssdl_rotate_bilinear(const float* src, int h, int w, float degrees,
                           float cval, float* dst) {
  // scipy.ndimage.rotate's positive angle is counter-clockwise in array
  // (row, col) coordinates — the inverse map below needs the negation.
  const float rad = -degrees * 3.14159265358979323846f / 180.f;
  const float c = std::cos(rad), s = std::sin(rad);
  const float cy = 0.5f * (h - 1), cx = 0.5f * (w - 1);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      // inverse-map output pixel into source coordinates
      const float dy = y - cy, dx = x - cx;
      const float sy = c * dy - s * dx + cy;
      const float sx = s * dy + c * dx + cx;
      float v = cval;
      if (sy >= -1.f && sy <= static_cast<float>(h) &&
          sx >= -1.f && sx <= static_cast<float>(w)) {
        const int y0 = static_cast<int>(std::floor(sy));
        const int x0 = static_cast<int>(std::floor(sx));
        const float wy = sy - y0, wx = sx - x0;
        auto at = [&](int yy, int xx) -> float {
          if (yy < 0 || yy >= h || xx < 0 || xx >= w) return cval;
          return src[yy * w + xx];
        };
        const float top = at(y0, x0) * (1.f - wx) + at(y0, x0 + 1) * wx;
        const float bot = at(y0 + 1, x0) * (1.f - wx) + at(y0 + 1, x0 + 1) * wx;
        v = top * (1.f - wy) + bot * wy;
      }
      dst[y * w + x] = v;
    }
  }
}

// Fused brightness shift + contrast scale about the mean, clipped to [0,1]
// (blob.py:50-58 semantics: brightness first, then contrast about the
// post-brightness mean).
void wssdl_brightness_contrast(float* im, int n, float delta, float factor,
                               int apply_brightness, int apply_contrast) {
  if (apply_brightness) {
    for (int i = 0; i < n; ++i)
      im[i] = std::min(1.f, std::max(0.f, im[i] + delta));
  }
  if (apply_contrast) {
    double acc = 0.0;
    for (int i = 0; i < n; ++i) acc += im[i];
    const float mean = static_cast<float>(acc / n);
    for (int i = 0; i < n; ++i) {
      const float v = (im[i] - mean) * factor + mean;
      im[i] = std::min(1.f, std::max(0.f, v));
    }
  }
}

}  // extern "C"
