// Native host-side image decode + crop + resize for the data pipeline.
//
// The reference leans on torch's native DataLoader machinery for its host
// pipeline; this is the rebuild's C++ counterpart for the expensive part of
// a sample: JPEG decode (libjpeg, the same codec PIL uses) and the
// RandomResizedCrop resample.  Geometry and randomness stay in Python (the
// crop box is computed by data/augment.py with the checkpointable RNG);
// this module only executes (decode, crop, resize) in one pass.
//
// The resampler mirrors PIL's antialiased bilinear (triangle filter whose
// support scales with the downscale ratio, separable horizontal+vertical,
// coefficients normalized per output pixel) so the opt-in native path stays
// distribution-equivalent to the PIL path (tests pin the tolerance).
//
// Exposed C ABI (ctypes, see data/native_image.py):
//   decode_info(buf, len, &w, &h)                      -> 0 ok
//   decode_crop_resize(buf, len, left, top, cw, ch,
//                      out_w, out_h, out_rgb)          -> 0 ok
// Non-JPEG payloads and exotic colorspaces return nonzero; callers fall
// back to PIL.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer to RGB8.  Returns false on any decode problem.
bool decode_rgb(const uint8_t* buf, long len, std::vector<uint8_t>& out,
                int& width, int& height) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr to RGB
  if (!jpeg_start_decompress(&cinfo) || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  width = static_cast<int>(cinfo.output_width);
  height = static_cast<int>(cinfo.output_height);
  out.resize(static_cast<size_t>(width) * height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + static_cast<size_t>(cinfo.output_scanline) * width * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// One axis of PIL-style antialiased bilinear: for each output index compute
// the contributing input range [bounds] and normalized triangle weights.
struct AxisCoeffs {
  std::vector<int> xmin;      // first contributing input index
  std::vector<int> xsize;     // number of contributing inputs
  std::vector<std::vector<float>> weights;
};

AxisCoeffs precompute(int in0, int in1, int in_limit, int out_size) {
  // crop interval [in0, in1) resampled to out_size, clamped to [0, in_limit)
  AxisCoeffs c;
  c.xmin.resize(out_size);
  c.xsize.resize(out_size);
  c.weights.resize(out_size);
  const double scale = double(in1 - in0) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // bilinear support = 1
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(
        std::min(double(in_limit), std::ceil(center + support)));
    std::vector<float> w;
    w.reserve(xmax - xmin);
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double arg = (x + 0.5 - center) / filterscale;
      double v = (std::abs(arg) < 1.0) ? 1.0 - std::abs(arg) : 0.0;
      w.push_back(static_cast<float>(v));
      total += v;
    }
    if (total <= 0.0) {  // degenerate: nearest pixel
      int x = std::min(std::max(int(center), 0), in_limit - 1);
      xmin = x;
      w.assign(1, 1.0f);
      total = 1.0;
    }
    for (auto& v : w) v = static_cast<float>(v / total);
    // trim zero-weight edges so inner loops stay tight
    while (w.size() > 1 && w.front() == 0.0f) {
      w.erase(w.begin());
      ++xmin;
    }
    while (w.size() > 1 && w.back() == 0.0f) w.pop_back();
    c.xmin[xx] = xmin;
    c.xsize[xx] = static_cast<int>(w.size());
    c.weights[xx] = std::move(w);
  }
  return c;
}

inline uint8_t clip8(float v) {
  int i = static_cast<int>(v + 0.5f);
  return static_cast<uint8_t>(std::min(255, std::max(0, i)));
}

}  // namespace

extern "C" {

// Parse image dimensions without a full decode.  0 = ok.
int decode_info(const uint8_t* buf, long len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + crop box (left, top, cw, ch; cw/ch <= 0 = full image) + resize to
// (out_w, out_h).  out must hold out_h*out_w*3 bytes.  0 = ok.
int decode_crop_resize(const uint8_t* buf, long len, int left, int top,
                       int cw, int ch, int out_w, int out_h, uint8_t* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_rgb(buf, len, rgb, w, h)) return 1;
  if (cw <= 0 || ch <= 0) {
    left = 0;
    top = 0;
    cw = w;
    ch = h;
  }
  if (left < 0 || top < 0 || left + cw > w || top + ch > h) return 2;
  if (out_w <= 0 || out_h <= 0) return 3;

  AxisCoeffs hc = precompute(left, left + cw, w, out_w);
  AxisCoeffs vc = precompute(top, top + ch, h, out_h);

  // only the rows the vertical pass reads need the horizontal pass (PIL's
  // ImagingResample does the same restriction)
  int y_lo = h, y_hi = 0;
  for (int yy = 0; yy < out_h; ++yy) {
    y_lo = std::min(y_lo, vc.xmin[yy]);
    y_hi = std::max(y_hi, vc.xmin[yy] + vc.xsize[yy]);
  }

  // horizontal pass: rows [y_lo, y_hi) of [h, w, 3] -> [*, out_w, 3] float
  std::vector<float> tmp(static_cast<size_t>(h) * out_w * 3);
  for (int y = y_lo; y < y_hi; ++y) {
    const uint8_t* row = rgb.data() + static_cast<size_t>(y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const auto& wts = hc.weights[xx];
      const int x0 = hc.xmin[xx];
      float r = 0, g = 0, b = 0;
      for (int i = 0; i < hc.xsize[xx]; ++i) {
        const uint8_t* px = row + (x0 + i) * 3;
        const float wt = wts[i];
        r += wt * px[0];
        g += wt * px[1];
        b += wt * px[2];
      }
      trow[xx * 3 + 0] = r;
      trow[xx * 3 + 1] = g;
      trow[xx * 3 + 2] = b;
    }
  }
  // vertical pass: [h, out_w, 3] -> [out_h, out_w, 3] uint8
  for (int yy = 0; yy < out_h; ++yy) {
    const auto& wts = vc.weights[yy];
    const int y0 = vc.xmin[yy];
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w * 3; ++xx) {
      float acc = 0;
      for (int i = 0; i < vc.xsize[yy]; ++i) {
        acc += wts[i] * tmp[static_cast<size_t>(y0 + i) * out_w * 3 + xx];
      }
      orow[xx] = clip8(acc);
    }
  }
  return 0;
}

}  // extern "C"
