// Native image I/O for opengpc_tpu (libpng-backed).
//
// Host-side runtime component: fast PNG decode/encode feeding the device
// pipeline, the counterpart of the reference's native PNG layer
// (/root/reference/lib/gpc/buffer.hpp:197-474).  Exposed through a plain
// C ABI and loaded from Python via ctypes (opengpc_tpu/io/png.py).
//
// Data layout: row-major, tightly packed, channels interleaved.  16-bit
// samples are returned big-endian (network order), matching libpng's
// native stream order; the Python wrapper reassembles them.

#include <png.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

void ogpc_free(void* p) { free(p); }

// Returns malloc'd pixel buffer or nullptr on failure.
uint8_t* ogpc_png_read(const char* path, int* out_w, int* out_h, int* out_ch,
                       int* out_depth) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  unsigned char header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return nullptr;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return nullptr;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(fp);
    return nullptr;
  }
  uint8_t* data = nullptr;
  png_bytep* rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    free(data);
    free(rows);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return nullptr;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  // Normalize: palette -> RGB, gray<8 -> 8-bit.
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  depth = png_get_bit_depth(png, info);
  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);

  data = static_cast<uint8_t*>(malloc(rowbytes * h));
  rows = static_cast<png_bytep*>(malloc(sizeof(png_bytep) * h));
  if (!data || !rows) longjmp(png_jmpbuf(png), 1);
  for (png_uint_32 y = 0; y < h; y++) rows[y] = data + y * rowbytes;
  png_read_image(png, rows);
  png_read_end(png, nullptr);

  free(rows);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  *out_w = static_cast<int>(w);
  *out_h = static_cast<int>(h);
  *out_ch = channels;
  *out_depth = depth;
  return data;
}

// channels: 1 (gray) or 3 (RGB); 8-bit only.  Returns 0 on success.
int ogpc_png_write(const char* path, const uint8_t* data, int w, int h, int channels) {
  if (channels != 1 && channels != 3) return 1;
  FILE* fp = fopen(path, "wb");
  if (!fp) return 1;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return 1;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return 1;
  }
  png_bytep* rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    free(rows);
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return 1;
  }
  png_init_io(png, fp);
  png_set_IHDR(png, info, w, h, 8,
               channels == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_BASE, PNG_FILTER_TYPE_BASE);
  png_write_info(png, info);
  rows = static_cast<png_bytep*>(malloc(sizeof(png_bytep) * h));
  if (!rows) longjmp(png_jmpbuf(png), 1);
  size_t stride = static_cast<size_t>(w) * channels;
  for (int y = 0; y < h; y++) rows[y] = const_cast<uint8_t*>(data) + y * stride;
  png_write_image(png, rows);
  png_write_end(png, nullptr);
  free(rows);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

}  // extern "C"
