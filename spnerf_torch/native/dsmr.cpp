// Native DSM registration: NaN-aware multiscale NCC + shift resampling.
//
// The JAX package's C++ copy (spnerf_tpu/native/dsmr.cpp) of the reference
// SP-NeRF's numba kernels (modules/dsmr.py: valnan, downsample2x_, mean_std,
// apply_shift_), exposed through a C ABI for ctypes. Single-channel (H, W)
// double rasters, row-major, NaN = nodata. Host code: the registration runs
// on the CPU beside the device.
//
// Built with g++ at first use by spnerf_torch/evaluation/registration.py.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

struct Raster {
  const double* data;
  int h, w;
  inline double at(int j, int i) const {
    if (i < 0 || i >= w || j < 0 || j >= h)
      return std::numeric_limits<double>::quiet_NaN();
    return data[static_cast<int64_t>(j) * w + i];
  }
};

// NaN-aware 2x downsample: mean of finite values in each 2x2 block.
void downsample2x(const std::vector<double>& in, int h, int w,
                  std::vector<double>& out, int& oh, int& ow) {
  oh = (h + 1) / 2;
  ow = (w + 1) / 2;
  out.assign(static_cast<size_t>(oh) * ow,
             std::numeric_limits<double>::quiet_NaN());
  Raster r{in.data(), h, w};
  for (int j = 0; j < oh; ++j) {
    for (int i = 0; i < ow; ++i) {
      double s = 0.0;
      int n = 0;
      for (int dj = 0; dj < 2; ++dj)
        for (int di = 0; di < 2; ++di) {
          double v = r.at(2 * j + dj, 2 * i + di);
          if (std::isfinite(v)) {
            s += v;
            ++n;
          }
        }
      if (n > 0) out[static_cast<size_t>(j) * ow + i] = s / n;
    }
  }
}

struct Moments {
  double muu = 0, muv = 0, sigu = 0, sigv = 0, xcorr = 0;
  int64_t count = 0;
};

// Moments of ref and sec-shifted-by-(dx,dy) over finite overlapping pixels.
Moments moments(const Raster& u, const Raster& v, int dx, int dy) {
  Moments m;
  double su = 0, sv = 0, suu = 0, svv = 0, suv = 0;
  for (int j = 0; j < u.h; ++j) {
    for (int i = 0; i < u.w; ++i) {
      double a = u.at(j, i);
      double b = v.at(j + dy, i + dx);
      if (std::isfinite(a) && std::isfinite(b)) {
        su += a;
        sv += b;
        suu += a * a;
        svv += b * b;
        suv += a * b;
        ++m.count;
      }
    }
  }
  if (m.count == 0) return m;
  double n = static_cast<double>(m.count);
  m.muu = su / n;
  m.muv = sv / n;
  m.sigu = std::sqrt(std::max(0.0, suu / n - m.muu * m.muu));
  m.sigv = std::sqrt(std::max(0.0, svv / n - m.muv * m.muv));
  m.xcorr = suv / n - m.muu * m.muv;
  return m;
}

double ncc(const Raster& u, const Raster& v, int dx, int dy) {
  Moments m = moments(u, v, dx, dy);
  if (m.count == 0 || m.sigu <= 0 || m.sigv <= 0)
    return -std::numeric_limits<double>::infinity();
  return m.xcorr / (m.sigu * m.sigv);
}

void search_ncc(const Raster& u, const Raster& v, int irange, int& dx, int& dy) {
  double best = -std::numeric_limits<double>::infinity();
  int bx = dx, by = dy;
  for (int y = dy - irange; y <= dy + irange; ++y)
    for (int x = dx - irange; x <= dx + irange; ++x) {
      double c = ncc(u, v, x, y);
      if (c > best) {
        best = c;
        bx = x;
        by = y;
      }
    }
  dx = bx;
  dy = by;
}

void recursive_ncc(const std::vector<double>& u, const std::vector<double>& v,
                   int h, int w, int irange, int& dx, int& dy) {
  if (std::min(h, w) > 100) {
    std::vector<double> su, sv;
    int oh, ow;
    downsample2x(u, h, w, su, oh, ow);
    downsample2x(v, h, w, sv, oh, ow);
    dx /= 2;
    dy /= 2;
    recursive_ncc(su, sv, oh, ow, irange, dx, dy);
    dx *= 2;
    dy *= 2;
  }
  Raster ru{u.data(), h, w}, rv{v.data(), h, w};
  search_ncc(ru, rv, irange, dx, dy);
}

}  // namespace

extern "C" {

void dsmr_compute_shift(const double* ref, const double* sec, int h, int w,
                        int irange, int scaling, int* out_dx, int* out_dy,
                        double* out_a, double* out_b) {
  std::vector<double> u(ref, ref + static_cast<size_t>(h) * w);
  std::vector<double> v(sec, sec + static_cast<size_t>(h) * w);
  int dx = 0, dy = 0;
  recursive_ncc(u, v, h, w, irange, dx, dy);
  Raster ru{u.data(), h, w}, rv{v.data(), h, w};
  Moments m = moments(ru, rv, dx, dy);
  double a = (scaling && m.sigv > 0) ? m.sigu / m.sigv : 1.0;
  double b = m.muu - m.muv * a;
  *out_dx = dx;
  *out_dy = dy;
  *out_a = a;
  *out_b = b;
}

void dsmr_apply_shift(const double* in, double* out, int h, int w, int dx,
                      int dy, double a, double b) {
  Raster v{in, h, w};
  for (int j = 0; j < h; ++j)
    for (int i = 0; i < w; ++i)
      out[static_cast<int64_t>(j) * w + i] = a * v.at(j + dy, i + dx) + b;
}

}  // extern "C"
