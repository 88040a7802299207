// Native PNG decode/encode for the host side of satlas_sr_tpu_torch.
//
// The port's own copy of the JAX package's libpng codec: fast, GIL-free image
// IO feeding the card's input pipeline. Built with g++ at first use and bound
// with ctypes by satlas_sr_tpu_torch/utils/native_png.py. Gray/RGB/RGBA/
// palette inputs are normalised to 8-bit with alpha stripped (16-bit keeps the
// high byte), matching the framework's HWC-uint8 convention.

#include <png.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Normalise to 8-bit gray/RGB (alpha stripped) and read every row into a
// malloc'd height*rowbytes buffer — the shared back half of the file and
// in-memory decoders (png_read_info must already have run). Installs its own
// longjmp target: a truncated IDAT longjmps out of png_read_image, which
// would skip C++ destructors and leave non-volatile locals indeterminate, so
// the pixel buffer and row-pointer array are plain malloc'd volatile slots
// reclaimed here on error. Returns 0 on success (caller owns *out_buf),
// 4 on decode error, 5 on OOM.
int read_normalised_rows(png_structp png, png_infop info, int* out_c,
                         unsigned char** out_buf) {
  unsigned char* volatile buf = nullptr;
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    free(rows);
    free(buf);
    return 4;
  }

  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  // Unconditional: strips the source's own alpha AND the tRNS-derived one
  // (a palette+tRNS image is PALETTE color_type — no ALPHA mask bit — yet
  // expands to RGBA above; a conditional strip would leak 4 channels out of
  // the "8-bit gray/RGB" contract). No-op when no alpha is present.
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  png_uint_32 height = png_get_image_height(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  buf = static_cast<unsigned char*>(malloc(height * rowbytes));
  rows = static_cast<png_bytep*>(malloc(height * sizeof(png_bytep)));
  if (!buf || !rows) {
    free(rows);
    free(buf);
    return 5;
  }
  for (png_uint_32 y = 0; y < height; ++y) rows[y] = buf + y * rowbytes;
  png_read_image(png, rows);
  free(rows);

  *out_c = png_get_channels(png, info);
  *out_buf = buf;
  return 0;
}

}  // namespace

extern "C" {

// Decode `path` into a malloc'd H*W*C uint8 buffer. Returns 0 on success.
int pngio_read(const char* path, int* out_h, int* out_w, int* out_c,
               void** out_buf) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;

  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return 2;
  }

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return 3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(fp);
    return 3;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 4;
  }

  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);

  int channels = 0;
  unsigned char* buf = nullptr;
  int rc = read_normalised_rows(png, info, &channels, &buf);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  if (rc) return rc;

  *out_h = static_cast<int>(height);
  *out_w = static_cast<int>(width);
  *out_c = channels;
  *out_buf = buf;
  return 0;
}

void pngio_free(void* buf) { free(buf); }

// Batched multi-threaded decode: one Python->C call per batch instead of one
// per file (the reference's DataLoader-worker role, fully native). Each file
// decodes on a C++ thread-pool worker; per-file results land in the caller's
// arrays. rc[i] != 0 marks a failed file (its h/w/c/buf are undefined);
// callers free each successful buf with pngio_free.
int pngio_read_many(const char** paths, int n, int* hs, int* ws, int* cs,
                    void** bufs, int* rcs, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      bufs[i] = nullptr;
      rcs[i] = pngio_read(paths[i], &hs[i], &ws[i], &cs[i], &bufs[i]);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return 0;
}

// Encode an H*W*C uint8 buffer (C in {1,3}) to `path`. Returns 0 on success.
int pngio_write(const char* path, const void* data, int h, int w, int c) {
  if (c != 1 && c != 3) return 1;
  FILE* fp = fopen(path, "wb");
  if (!fp) return 2;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return 3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return 3;
  }
  // Same longjmp discipline as read_normalised_rows: rows is plain malloc
  // behind a volatile slot so a mid-write libpng error neither skips a
  // destructor nor frees an indeterminate pointer.
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    free(rows);
    fclose(fp);
    return 4;
  }

  png_init_io(png, fp);
  png_set_IHDR(png, info, w, h, 8,
               c == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  // Favor throughput over ratio: the pipeline writes thousands of tiles.
  png_set_compression_level(png, 1);
  png_write_info(png, info);

  const auto* base = static_cast<const unsigned char*>(data);
  rows = static_cast<png_bytep*>(malloc(h * sizeof(png_bytep)));
  if (!rows) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return 5;
  }
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<png_bytep>(base + static_cast<size_t>(y) * w * c);
  png_write_image(png, rows);
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  free(rows);
  fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// In-memory codec: for bytes that arrive without a file (a serving front end).
// Decoding/encoding here (GIL-free via ctypes) keeps a single-threaded host
// from spending its core in PIL/zlib Python-side plumbing.

namespace {

struct MemReader {
  const unsigned char* data;
  size_t len;
  size_t pos;
};

void mem_read_cb(png_structp png, png_bytep out, png_size_t n) {
  auto* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->len) png_error(png, "png: read past end of buffer");
  memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

struct MemWriter {
  unsigned char* data;
  size_t len;
  size_t cap;
};

void mem_write_cb(png_structp png, png_bytep in, png_size_t n) {
  auto* w = static_cast<MemWriter*>(png_get_io_ptr(png));
  if (w->len + n > w->cap) {
    size_t cap = w->cap ? w->cap * 2 : 65536;
    while (cap < w->len + n) cap *= 2;
    auto* p = static_cast<unsigned char*>(realloc(w->data, cap));
    if (!p) png_error(png, "png: out of memory");
    w->data = p;
    w->cap = cap;
  }
  memcpy(w->data + w->len, in, n);
  w->len += n;
}

void mem_flush_cb(png_structp) {}

// The mem codec decodes UNTRUSTED request bytes (serving): keep libpng's
// default longjmp recovery but drop its stderr chatter per malformed body.
void silent_error_cb(png_structp png, png_const_charp) {
  longjmp(png_jmpbuf(png), 1);
}
void silent_warning_cb(png_structp, png_const_charp) {}

}  // namespace

// Decode in-memory PNG bytes into a malloc'd H*W*C uint8 buffer (same
// normalisation as pngio_read). If max_pixels > 0 and the header announces
// more than that many pixels, aborts BEFORE decompressing pixel data and
// returns 6 (a small body can inflate to hundreds of MB decoded — servers
// must bound it pre-decode). Returns 0 on success.
int pngio_decode(const void* data, size_t len, long long max_pixels,
                 int* out_h, int* out_w, int* out_c, void** out_buf) {
  if (len < 8 ||
      png_sig_cmp(static_cast<png_const_bytep>(data), 0, 8))
    return 2;

  png_structp png = png_create_read_struct(
      PNG_LIBPNG_VER_STRING, nullptr, silent_error_cb, silent_warning_cb);
  if (!png) return 3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 3;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 4;
  }

  MemReader reader{static_cast<const unsigned char*>(data), len, 0};
  png_set_read_fn(png, &reader, mem_read_cb);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  if (max_pixels > 0 &&
      static_cast<long long>(width) * static_cast<long long>(height) >
          max_pixels) {
    png_destroy_read_struct(&png, &info, nullptr);
    *out_h = static_cast<int>(height);
    *out_w = static_cast<int>(width);
    return 6;
  }

  int channels = 0;
  unsigned char* buf = nullptr;
  int rc = read_normalised_rows(png, info, &channels, &buf);
  png_destroy_read_struct(&png, &info, nullptr);
  if (rc) return rc;

  *out_h = static_cast<int>(height);
  *out_w = static_cast<int>(width);
  *out_c = channels;
  *out_buf = buf;
  return 0;
}

// Encode an H*W*C uint8 buffer (C in {1,3}) into a malloc'd PNG byte buffer
// (caller frees with pngio_free). `level` is the zlib compression level
// (0-9); serving uses 1 — same throughput-over-ratio choice as pngio_write.
int pngio_encode(const void* data, int h, int w, int c, int level,
                 void** out_buf, size_t* out_len) {
  if (c != 1 && c != 3) return 1;
  png_structp png = png_create_write_struct(
      PNG_LIBPNG_VER_STRING, nullptr, silent_error_cb, silent_warning_cb);
  if (!png) return 3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    return 3;
  }
  MemWriter writer{nullptr, 0, 0};
  // `writer` is grown via realloc inside mem_write_cb after setjmp; reading
  // it directly in the error path would read an indeterminate (possibly
  // register-restored stale) value after longjmp. The volatile pointer
  // forces a memory load of the CURRENT struct, so free() gets the live
  // buffer, not a pre-realloc one (double-free) or setjmp-time nullptr
  // (leak). rows follows the same malloc-behind-volatile discipline as
  // read_normalised_rows.
  MemWriter* volatile wp = &writer;
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    free(rows);
    free(wp->data);
    return 4;
  }

  png_set_write_fn(png, &writer, mem_write_cb, mem_flush_cb);
  png_set_IHDR(png, info, w, h, 8,
               c == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  if (level < 0) level = 0;
  if (level > 9) level = 9;
  png_set_compression_level(png, level);
  png_write_info(png, info);

  const auto* base = static_cast<const unsigned char*>(data);
  rows = static_cast<png_bytep*>(malloc(h * sizeof(png_bytep)));
  if (!rows) {
    png_destroy_write_struct(&png, &info);
    free(writer.data);
    return 5;
  }
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<png_bytep>(base + static_cast<size_t>(y) * w * c);
  png_write_image(png, rows);
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  free(rows);

  *out_buf = writer.data;
  *out_len = writer.len;
  return 0;
}

}  // extern "C"
