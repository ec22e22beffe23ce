// Image arithmetic of the host input pipeline that needs no third-party
// header: Pillow's resampler on 8-bit images and PNG row unfiltering.
//
// dqvq_resample reproduces Pillow's `Image.resize` on an 8-bit image of 1 to
// 4 channels bit for bit (libImaging/Resample.c, and for NEAREST the affine
// scaling of Geometry.c that `_resize` takes): the filter's coefficients in
// double, normalised by their sum, fixed point with 22 fractional bits, each
// output (2^21 + sum k * p) >> 22 clipped to 0..255; the horizontal pass
// first, each pass only where that size changes. Channels are independent,
// as Pillow's bands are.
//
// dqvq_png_unfilter undoes the five PNG filter types (None, Sub, Up, Average,
// Paeth) of an inflated 8-bit, non-interlaced image.
//
// Build (native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off image_core.cpp

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kNearest = 0;   // PIL.Image.NEAREST
constexpr int kBilinear = 2;  // PIL.Image.BILINEAR
constexpr int kBicubic = 3;   // PIL.Image.BICUBIC
constexpr int kPrecisionBits = 32 - 8 - 2;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // (xmin, count) per output
  std::vector<int32_t> kk;   // ksize fixed-point weights per output
};

// Resample.c precompute_coeffs + normalize_coeffs_8bpc, box (0, in_size).
Coeffs precompute(int in_size, int out_size, int filter) {
  double (*fn)(double) = filter == kBicubic ? bicubic_filter : bilinear_filter;
  const double filter_support = filter == kBicubic ? 2.0 : 1.0;
  const float in0 = 0.0f, in1 = static_cast<float>(in_size);
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = filter_support * filterscale;
  Coeffs c;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(2 * static_cast<size_t>(out_size));
  c.kk.resize(static_cast<size_t>(out_size) * c.ksize);
  std::vector<double> k(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    int x = 0;
    for (; x < xmax; ++x) {
      const double w = fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (; x < c.ksize; ++x) k[x] = 0;
    for (x = 0; x < c.ksize; ++x) {
      c.kk[static_cast<size_t>(xx) * c.ksize + x] =
          k[x] < 0 ? static_cast<int32_t>(-0.5 + k[x] * (1 << kPrecisionBits))
                   : static_cast<int32_t>(0.5 + k[x] * (1 << kPrecisionBits));
    }
    c.bounds[2 * xx] = xmin;
    c.bounds[2 * xx + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t in) {
  const int32_t v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// rows [y0, y0 + rows) of src (h x w x ch) -> dst (rows x ow x ch)
void horizontal(const uint8_t* src, int w, int ch, int y0, int rows, uint8_t* dst, int ow,
                const Coeffs& c) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* in = src + (static_cast<long>(y0 + y) * w) * ch;
    uint8_t* out = dst + static_cast<long>(y) * ow * ch;
    for (int xx = 0; xx < ow; ++xx) {
      const int xmin = c.bounds[2 * xx], xmax = c.bounds[2 * xx + 1];
      const int32_t* k = &c.kk[static_cast<size_t>(xx) * c.ksize];
      for (int b = 0; b < ch; ++b) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x) ss += in[(x + xmin) * ch + b] * k[x];
        out[xx * ch + b] = clip8(ss);
      }
    }
  }
}

// src (h x w x ch), rows offset by y_shift in the bounds -> dst (oh x w x ch)
void vertical(const uint8_t* src, int w, int ch, int y_shift, uint8_t* dst, int oh,
              const Coeffs& c) {
  const long row = static_cast<long>(w) * ch;
  for (int yy = 0; yy < oh; ++yy) {
    const int ymin = c.bounds[2 * yy] - y_shift, ymax = c.bounds[2 * yy + 1];
    const int32_t* k = &c.kk[static_cast<size_t>(yy) * c.ksize];
    uint8_t* out = dst + yy * row;
    for (long i = 0; i < row; ++i) {
      int32_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y) ss += src[(y + ymin) * row + i] * k[y];
      out[i] = clip8(ss);
    }
  }
}

// Geometry.c ImagingScaleAffine (fill on): nearest neighbour over the whole box.
void nearest(const uint8_t* src, int h, int w, int ch, uint8_t* dst, int oh, int ow) {
  const double ax = static_cast<double>(static_cast<float>(w)) / ow;
  const double ay = static_cast<double>(static_cast<float>(h)) / oh;
  std::vector<int> xin(ow, 0);
  int xmin = ow, xmax = 0;
  double xo = ax * 0.5;
  for (int x = 0; x < ow; ++x) {
    const int xi = xo < 0.0 ? -1 : static_cast<int>(xo);
    if (xi >= 0 && xi < w) {
      xmax = x + 1;
      if (x < xmin) xmin = x;
      xin[x] = xi;
    }
    xo += ax;
  }
  double yo = ay * 0.5;
  for (int y = 0; y < oh; ++y) {
    const int yi = yo < 0.0 ? -1 : static_cast<int>(yo);
    uint8_t* out = dst + static_cast<long>(y) * ow * ch;
    std::memset(out, 0, static_cast<size_t>(ow) * ch);
    if (yi >= 0 && yi < h) {
      const uint8_t* in = src + static_cast<long>(yi) * w * ch;
      for (int x = xmin; x < xmax; ++x) std::memcpy(out + x * ch, in + xin[x] * ch, ch);
    }
    yo += ay;
  }
}

}  // namespace

extern "C" {

// src (h, w, ch) uint8 -> dst (oh, ow, ch), ch 1..4, filter 0 (NEAREST),
// 2 (BILINEAR) or 3 (BICUBIC), PIL's numbering. Returns 0, or -1 for bad
// arguments.
int dqvq_resample(const uint8_t* src, int h, int w, int ch, uint8_t* dst, int oh, int ow,
                  int filter) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1 || ch < 1 || ch > 4) return -1;
  if (filter != kNearest && filter != kBilinear && filter != kBicubic) return -1;
  if (oh == h && ow == w) {
    std::memcpy(dst, src, static_cast<size_t>(h) * w * ch);
    return 0;
  }
  if (filter == kNearest) {
    nearest(src, h, w, ch, dst, oh, ow);
    return 0;
  }
  const bool need_h = ow != w, need_v = oh != h;
  const Coeffs cv = precompute(h, oh, filter);
  if (!need_h) {
    vertical(src, w, ch, 0, dst, oh, cv);
    return 0;
  }
  const Coeffs ch_ = precompute(w, ow, filter);
  if (!need_v) {
    horizontal(src, w, ch, 0, h, dst, ow, ch_);
    return 0;
  }
  // the horizontal pass over the source rows the vertical pass reads
  const int y_first = cv.bounds[0];
  const int y_last = cv.bounds[2 * oh - 2] + cv.bounds[2 * oh - 1];
  std::vector<uint8_t> tmp(static_cast<size_t>(y_last - y_first) * ow * ch);
  horizontal(src, w, ch, y_first, y_last - y_first, tmp.data(), ow, ch_);
  vertical(tmp.data(), ow, ch, y_first, dst, oh, cv);
  return 0;
}

// raw: h rows of (1 filter byte + row_bytes); out: h * row_bytes. bpp: bytes
// per pixel (1..4 at 8 bits). Returns 0, -1 if raw is short, -2 on an unknown
// filter type.
int dqvq_png_unfilter(const uint8_t* raw, long raw_len, int h, long row_bytes, int bpp,
                      uint8_t* out) {
  if (raw_len < static_cast<long>(h) * (row_bytes + 1)) return -1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + static_cast<long>(y) * (row_bytes + 1);
    const uint8_t type = line[0];
    ++line;
    uint8_t* cur = out + static_cast<long>(y) * row_bytes;
    const uint8_t* prev = y ? cur - row_bytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(cur, line, row_bytes);
        break;
      case 1:
        for (long i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (long i = 0; i < row_bytes; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0, up = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(line[i] + pred);
        }
        break;
      default:
        return -2;
    }
  }
  return 0;
}

}  // extern "C"
