// JPEG decoding for the host input pipeline (libjpeg), the port's own copy of
// the JAX package's `native/host_pipeline.cpp`:
//   * dqvq_decode_jpeg / dqvq_jpeg_dims: RGB decode with libjpeg's DCT-domain
//     downscale (scale_denom 1, 2, 4, 8) and the header's dimensions, as there;
//   * dqvq_jpeg_header / dqvq_decode_jpeg_full: the full-size decode into the
//     mode Pillow opens the file in (1 component: L, 3: RGB, 4: CMYK stored
//     inverted, Pillow's "CMYK;I" raw mode, which assumes Adobe's convention),
//     with libjpeg's message on failure;
//   * dqvq_jpeg_version: the libjpeg the library was built against.
// The resize, crop and flip are in image_core.cpp (Pillow's resampler), which
// needs no third-party header, so PNG files are read where libjpeg is absent.
//
// Build (native/__init__.py, at first use):
//   g++ -O3 -shared -fPIC -std=c++17 host_pipeline.cpp -ljpeg

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>

#include <jpeglib.h>

extern "C" {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
  char* msg;  // libjpeg's message on failure, when the caller gave a buffer
  int msg_cap;
};

static void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  if (err->msg && err->msg_cap > 0) {
    char buffer[JMSG_LENGTH_MAX];
    (*cinfo->err->format_message)(cinfo, buffer);
    std::snprintf(err->msg, err->msg_cap, "%s", buffer);
  }
  longjmp(err->setjmp_buffer, 1);
}

static void init_errors(jpeg_decompress_struct* cinfo, ErrMgr* jerr, char* msg, int msg_cap) {
  cinfo->err = jpeg_std_error(&jerr->pub);
  jerr->pub.error_exit = error_exit;
  jerr->msg = msg;
  jerr->msg_cap = msg_cap;
  if (msg && msg_cap > 0) msg[0] = '\0';
}

// Decode a JPEG from memory into an RGB uint8 buffer.
// scale_denom in {1,2,4,8} applies libjpeg's DCT-domain downscale (nearly
// free) — callers pick the largest denom that keeps min(h,w) >= target.
// Returns 0 on success; fills *out_h/*out_w. out must hold
// ceil(h/denom)*ceil(w/denom)*3 bytes.
int dqvq_decode_jpeg(const uint8_t* buf, long len, int scale_denom,
                     uint8_t* out, long out_cap, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  init_errors(&cinfo, &jerr, nullptr, 0);
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const long row_bytes = static_cast<long>(w) * 3;
  if (row_bytes * h > out_cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<long>(cinfo.output_scanline) * row_bytes;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return 0;
}

// Read just the dimensions (for choosing scale_denom / crop geometry).
int dqvq_jpeg_dims(const uint8_t* buf, long len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  init_errors(&cinfo, &jerr, nullptr, 0);
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// The header's dimensions and component count; libjpeg's message in msg on
// failure (-1), -2 for a stream without an image.
int dqvq_jpeg_header(const uint8_t* buf, long len, int* h, int* w, int* components,
                     char* msg, int msg_cap) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  init_errors(&cinfo, &jerr, msg, msg_cap);
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  *components = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Full-size decode as Pillow decodes the file: space 0 RGB (3 bytes a pixel),
// 1 grey (1 byte), 2 CMYK (4 bytes, every value inverted: 255 - v, as Pillow's
// "CMYK;I" unpacker stores it). out must hold h * w * bytes-per-pixel bytes.
// Returns 0 on success; -1 with libjpeg's message in msg; -3 if out is small.
int dqvq_decode_jpeg_full(const uint8_t* buf, long len, int space, uint8_t* out,
                          long out_cap, int* out_h, int* out_w, char* msg, int msg_cap) {
  static const J_COLOR_SPACE kSpaces[3] = {JCS_RGB, JCS_GRAYSCALE, JCS_CMYK};
  static const int kBytes[3] = {3, 1, 4};
  if (space < 0 || space > 2) return -4;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  init_errors(&cinfo, &jerr, msg, msg_cap);
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = kSpaces[space];
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const long row_bytes = static_cast<long>(w) * kBytes[space];
  if (row_bytes * h > out_cap || cinfo.output_components != kBytes[space]) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<long>(cinfo.output_scanline) * row_bytes;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (space == 2) {
    const long n = row_bytes * h;
    for (long i = 0; i < n; ++i) out[i] = static_cast<uint8_t>(255 - out[i]);
  }
  *out_h = h;
  *out_w = w;
  return 0;
}

// JPEG_LIB_VERSION of the headers, and libjpeg-turbo's version number
// (e.g. 2001005 for 2.1.5; 0 for another libjpeg).
void dqvq_jpeg_version(int* lib_version, int* turbo_version) {
  *lib_version = JPEG_LIB_VERSION;
#ifdef LIBJPEG_TURBO_VERSION_NUMBER
  *turbo_version = LIBJPEG_TURBO_VERSION_NUMBER;
#else
  *turbo_version = 0;
#endif
}

}  // extern "C"
