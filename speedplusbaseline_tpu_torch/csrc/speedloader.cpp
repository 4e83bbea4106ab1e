// speedloader: the native decode core of the data loader (a copy of
// speedplusbaseline_tpu/native/speedloader.cpp; the code below is unchanged).
//
// It fuses JPEG decode (libjpeg, with DCT-domain downscaling), RoI crop and
// bilinear resize into one C call that writes uint8 HWC RGB into a
// caller-owned buffer (uint8 so the host->device copy ships 4x fewer bytes
// than float32; the [0,1] normalization runs on the device). Python calls it
// through ctypes, which releases the GIL during the call, so the loader's
// thread pool decodes on several host cores at once.
//
// Build: speedplusbaseline_tpu_torch/native/loader.py compiles it with the
// host C++ compiler at first use into build/native/<digest>/.
// API (all functions return 0 on success, negative on error):
//   decode_crop_resize_file(path, xmin, ymin, w, h, out_w, out_h, out_ptr)
//   decode_crop_resize_mem(buf, len, ...)
//   image_size_file(path, &w, &h)

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

// Decode a JPEG (from memory) to RGB8. Picks the largest libjpeg DCT scale
// (8/8, 8/4, 8/2, 8/1 denominators) that still covers the requested crop at
// the output resolution, so 1920x1200 frames that end up as 224x224 crops
// never fully decode. Returns decoded buffer + dims.
int decode_rgb(const uint8_t* data, size_t len, int min_scale_w, int min_scale_h,
               std::vector<uint8_t>* out, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain downscale: denom in {1,2,4,8}, keep >= requested min dims.
  if (min_scale_w > 0 && min_scale_h > 0) {
    int denom = 1;
    while (denom < 8) {
      int next = denom * 2;
      if ((int)cinfo.image_width / next >= min_scale_w &&
          (int)cinfo.image_height / next >= min_scale_h) {
        denom = next;
      } else {
        break;
      }
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }

  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize((size_t)(*w) * (*h) * 3);
  uint8_t* base = out->data();
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = base + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Bilinear sample of the crop rect [x0, x0+cw) x [y0, y0+ch) from an RGB8
// image (with edge clamping), resized to (out_w, out_h), rounded to uint8.
void crop_resize_bilinear(const uint8_t* img, int w, int h,
                          float x0, float y0, float cw, float ch,
                          int out_w, int out_h, uint8_t* out) {
  const float sx = cw / out_w;
  const float sy = ch / out_h;
  for (int oy = 0; oy < out_h; ++oy) {
    // align_corners=False convention (matches cv2.resize / PIL).
    float fy = y0 + (oy + 0.5f) * sy - 0.5f;
    int iy0 = (int)std::floor(fy);
    float wy = fy - iy0;
    int iy1 = iy0 + 1;
    iy0 = std::clamp(iy0, 0, h - 1);
    iy1 = std::clamp(iy1, 0, h - 1);
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = x0 + (ox + 0.5f) * sx - 0.5f;
      int ix0 = (int)std::floor(fx);
      float wx = fx - ix0;
      int ix1 = ix0 + 1;
      ix0 = std::clamp(ix0, 0, w - 1);
      ix1 = std::clamp(ix1, 0, w - 1);
      const uint8_t* p00 = img + ((size_t)iy0 * w + ix0) * 3;
      const uint8_t* p01 = img + ((size_t)iy0 * w + ix1) * 3;
      const uint8_t* p10 = img + ((size_t)iy1 * w + ix0) * 3;
      const uint8_t* p11 = img + ((size_t)iy1 * w + ix1) * 3;
      uint8_t* dst = out + ((size_t)oy * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1.0f - wx) + p01[c] * wx;
        float bot = p10[c] * (1.0f - wx) + p11[c] * wx;
        dst[c] = (uint8_t)(top * (1.0f - wy) + bot * wy + 0.5f);
      }
    }
  }
}

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(n);
  size_t got = std::fread(buf->data(), 1, n, f);
  std::fclose(f);
  return got == (size_t)n ? 0 : -1;
}

}  // namespace

extern "C" {

// Crop rect given in ORIGINAL image pixel coordinates; handles the DCT-scale
// factor internally. Output: out_h x out_w x 3 uint8 RGB.
int decode_crop_resize_mem(const uint8_t* data, size_t len,
                           float xmin, float ymin, float cw, float ch,
                           int out_w, int out_h, uint8_t* out) {
  // Minimum decoded size so the crop still has >= out resolution.
  int need_w = cw > 0 ? (int)(out_w * 1.0f) : out_w;
  int need_h = ch > 0 ? (int)(out_h * 1.0f) : out_h;
  // Conservative: require the full-image scale to keep crop >= out size.
  // scale s shrinks crop to cw*s; need cw*s >= out_w -> decode width
  // >= W * out_w / cw.
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  jpeg_decompress_struct probe;  // quick header probe for dims
  ErrorMgr jerr;
  probe.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&probe);
    return -2;
  }
  jpeg_create_decompress(&probe);
  jpeg_mem_src(&probe, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&probe, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&probe);
    return -3;
  }
  int full_w = probe.image_width, full_h = probe.image_height;
  jpeg_destroy_decompress(&probe);

  if (cw <= 0 || ch <= 0) {
    xmin = 0; ymin = 0; cw = (float)full_w; ch = (float)full_h;
  }
  // Required decoded dims so that the crop region maps to >= out pixels.
  need_w = (int)std::ceil((float)full_w * out_w / std::max(cw, 1.0f));
  need_h = (int)std::ceil((float)full_h * out_h / std::max(ch, 1.0f));
  need_w = std::min(need_w, full_w);
  need_h = std::min(need_h, full_h);

  int rc = decode_rgb(data, len, need_w, need_h, &rgb, &w, &h);
  if (rc != 0) return rc;

  float fscale_x = (float)w / full_w;
  float fscale_y = (float)h / full_h;
  crop_resize_bilinear(rgb.data(), w, h,
                       xmin * fscale_x, ymin * fscale_y,
                       cw * fscale_x, ch * fscale_y,
                       out_w, out_h, out);
  return 0;
}

int decode_crop_resize_file(const char* path,
                            float xmin, float ymin, float cw, float ch,
                            int out_w, int out_h, uint8_t* out) {
  std::vector<uint8_t> buf;
  if (read_file(path, &buf) != 0) return -1;
  return decode_crop_resize_mem(buf.data(), buf.size(), xmin, ymin, cw, ch,
                                out_w, out_h, out);
}

int image_size_file(const char* path, int* w, int* h) {
  std::vector<uint8_t> buf;
  if (read_file(path, &buf) != 0) return -1;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf.data(), buf.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
