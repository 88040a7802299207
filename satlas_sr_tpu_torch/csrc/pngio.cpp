// Native PNG decode/encode for the host side of satlas_sr_tpu_torch, on zlib
// alone (no libpng): chunks, inflate/deflate and the five row filters are
// done here. Built with g++ at first use and bound with ctypes by
// satlas_sr_tpu_torch/utils/native_png.py; every entry point runs without the
// GIL (ctypes releases it).
//
// Decode normalises to 8-bit HWC with the colour rules of utils/imgio.py,
// which are libpng's with png_set_strip_16, png_set_palette_to_rgb,
// png_set_expand_gray_1_2_4_to_8, png_set_tRNS_to_alpha and
// png_set_strip_alpha:
//   gray (0) -> 1 channel, gray < 8 bits scaled to 0..255 by bit replication;
//   RGB (2) -> 3; palette (3) -> RGB from PLTE (tRNS only adds alpha, which
//   is dropped); gray+alpha (4) -> 1; RGBA (6) -> 3; 16-bit -> the high byte.
// Adam7-interlaced files are not decoded here: they return PNGIO_INTERLACED
// and the caller decodes them another way.
//
// Encode writes 8-bit gray or RGB, non-interlaced, choosing each row's filter
// by libpng's heuristic (least sum of the filtered bytes read as signed), and
// deflates at the caller's zlib level with libpng's Z_FILTERED strategy.
//
// Return codes: 0 ok; 1 cannot open the file (read) or channels not 1/3
// (write); 2 not a PNG signature; 4 malformed or truncated data (bad CRC,
// chunk order, header values, zlib stream, too little image data) or a write
// error; 5 out of memory; 6 more pixels than max_pixels (checked from IHDR,
// before any pixel data is inflated); 7 interlaced.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <thread>
#include <vector>

namespace {

enum {
  PNGIO_OK = 0,
  PNGIO_OPEN = 1,
  PNGIO_SIGNATURE = 2,
  PNGIO_CORRUPT = 4,
  PNGIO_NOMEM = 5,
  PNGIO_TOO_LARGE = 6,
  PNGIO_INTERLACED = 7,
};

const unsigned char kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};
const uint32_t kMaxSide = 1000000;  // libpng's default user limit on width and height

inline uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

inline void put_be32(unsigned char* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = v >> 16;
  p[2] = v >> 8;
  p[3] = v;
}

inline uint32_t chunk_type(const char* s) { return be32(reinterpret_cast<const unsigned char*>(s)); }

struct Header {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
};

// Samples per pixel in the file, and channels after normalisation.
int file_samples(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

int out_channels(int color_type) { return (color_type == 0 || color_type == 4) ? 1 : 3; }

bool valid_depth(int color_type, int depth) {
  switch (color_type) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
  }
  return false;
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo row filters in place over h rows of (1 + stride) bytes; bpp is the
// filter's byte distance (bytes per complete pixel, at least 1).
bool unfilter(unsigned char* raw, size_t h, size_t stride, size_t bpp) {
  const size_t pitch = stride + 1;
  std::vector<unsigned char> zeros(stride, 0);
  for (size_t y = 0; y < h; ++y) {
    unsigned char* row = raw + y * pitch;
    unsigned char* cur = row + 1;
    const unsigned char* prev = y ? raw + (y - 1) * pitch + 1 : zeros.data();
    switch (row[0]) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) cur[i] += prev[i];
        break;
      case 3:
        for (size_t i = 0; i < bpp && i < stride; ++i) cur[i] += prev[i] >> 1;
        for (size_t i = bpp; i < stride; ++i) cur[i] += (cur[i - bpp] + prev[i]) >> 1;
        break;
      case 4:
        for (size_t i = 0; i < bpp && i < stride; ++i) cur[i] += prev[i];  // paeth(0, b, 0) = b
        for (size_t i = bpp; i < stride; ++i)
          cur[i] += paeth(cur[i - bpp], prev[i], prev[i - bpp]);
        break;
      default:
        return false;
    }
  }
  return true;
}

// One unfiltered row -> w * out_channels 8-bit samples.
void convert_row(const unsigned char* in, unsigned char* out, const Header& hd,
                 const unsigned char* palette) {
  const uint32_t w = hd.width;
  const int depth = hd.bit_depth;
  switch (hd.color_type) {
    case 0:
      if (depth == 8) {
        memcpy(out, in, w);
      } else if (depth == 16) {
        for (uint32_t x = 0; x < w; ++x) out[x] = in[2 * x];
      } else {
        // bit replication, as png_set_expand_gray_1_2_4_to_8
        const int per_byte = 8 / depth, mask = (1 << depth) - 1;
        const int scale = 255 / mask;
        for (uint32_t x = 0; x < w; ++x) {
          int shift = 8 - depth * (1 + int(x % per_byte));
          out[x] = static_cast<unsigned char>(((in[x / per_byte] >> shift) & mask) * scale);
        }
      }
      break;
    case 2:
      if (depth == 8) {
        memcpy(out, in, size_t(w) * 3);
      } else {
        for (size_t i = 0; i < size_t(w) * 3; ++i) out[i] = in[2 * i];
      }
      break;
    case 3: {
      const int per_byte = 8 / depth, mask = (1 << depth) - 1;
      for (uint32_t x = 0; x < w; ++x) {
        int idx = depth == 8 ? in[x]
                             : (in[x / per_byte] >> (8 - depth * (1 + int(x % per_byte)))) & mask;
        memcpy(out + 3 * size_t(x), palette + 3 * idx, 3);
      }
      break;
    }
    case 4: {
      const int step = depth == 8 ? 2 : 4;
      for (uint32_t x = 0; x < w; ++x) out[x] = in[size_t(step) * x];
      break;
    }
    case 6: {
      const int bytes = depth == 8 ? 1 : 2;
      for (uint32_t x = 0; x < w; ++x)
        for (int c = 0; c < 3; ++c) out[3 * size_t(x) + c] = in[(4 * size_t(x) + c) * bytes];
      break;
    }
  }
}

int decode(const unsigned char* data, size_t len, long long max_pixels, int* out_h, int* out_w,
           int* out_c, void** out_buf) {
  if (len < 8 || memcmp(data, kSignature, 8) != 0) return PNGIO_SIGNATURE;
  Header hd;
  unsigned char palette[256 * 3] = {0};  // an index past PLTE's end reads black
  bool have_header = false, have_plte = false, idat_done = false, ended = false;
  int result = PNGIO_OK;
  std::vector<unsigned char> raw;
  size_t filled = 0;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  bool z_open = false, z_end = false;

  size_t pos = 8;
  while (!ended) {
    if (len - pos < 12) { result = PNGIO_CORRUPT; break; }
    const uint32_t n = be32(data + pos);
    const uint32_t type = be32(data + pos + 4);
    if (n > 0x7fffffffu || len - pos - 12 < n) { result = PNGIO_CORRUPT; break; }
    const unsigned char* body = data + pos + 8;
    const bool critical = !(data[pos + 4] & 0x20);
    const uint32_t crc = uint32_t(crc32(crc32(0L, Z_NULL, 0), data + pos + 4, n + 4));
    pos += 12 + size_t(n);
    if (crc != be32(body + n)) {
      if (critical) { result = PNGIO_CORRUPT; break; }
      continue;  // libpng's default: an ancillary chunk with a bad CRC is dropped
    }
    if (!have_header && type != chunk_type("IHDR")) { result = PNGIO_CORRUPT; break; }
    if (type == chunk_type("IHDR")) {
      if (have_header || n != 13) { result = PNGIO_CORRUPT; break; }
      hd.width = be32(body);
      hd.height = be32(body + 4);
      hd.bit_depth = body[8];
      hd.color_type = body[9];
      hd.interlace = body[12];
      if (hd.width == 0 || hd.height == 0 || hd.width > kMaxSide || hd.height > kMaxSide ||
          !valid_depth(hd.color_type, hd.bit_depth) || body[10] != 0 || body[11] != 0 ||
          hd.interlace > 1) {
        result = PNGIO_CORRUPT;
        break;
      }
      have_header = true;
      *out_h = int(hd.height);
      *out_w = int(hd.width);
      if (max_pixels > 0 && (long long)hd.width * (long long)hd.height > max_pixels) {
        result = PNGIO_TOO_LARGE;
        break;
      }
      if (hd.interlace) { result = PNGIO_INTERLACED; break; }
    } else if (type == chunk_type("PLTE")) {
      if (have_plte || z_open || n % 3 || n == 0 || n > 768) {
        result = PNGIO_CORRUPT;
        break;
      }
      memcpy(palette, body, n);
      have_plte = true;
    } else if (type == chunk_type("IDAT")) {
      if (idat_done || (hd.color_type == 3 && !have_plte)) { result = PNGIO_CORRUPT; break; }
      if (!z_open) {
        const size_t stride = (size_t(hd.width) * file_samples(hd.color_type) * hd.bit_depth + 7) / 8;
        const size_t total = size_t(hd.height) * (stride + 1);
        try {
          raw.resize(total);
        } catch (const std::exception&) {
          result = PNGIO_NOMEM;
          break;
        }
        if (inflateInit(&zs) != Z_OK) { result = PNGIO_NOMEM; break; }
        z_open = true;
      }
      if (z_end || filled == raw.size()) continue;  // trailing data after the image: ignored
      zs.next_in = const_cast<unsigned char*>(body);
      zs.avail_in = n;
      while (zs.avail_in && !z_end && filled < raw.size()) {
        const size_t room = raw.size() - filled;
        const uInt chunk = room > 0x40000000u ? 0x40000000u : uInt(room);
        zs.next_out = raw.data() + filled;
        zs.avail_out = chunk;
        int rc = inflate(&zs, Z_NO_FLUSH);
        filled += chunk - zs.avail_out;
        if (rc == Z_STREAM_END) {
          z_end = true;
        } else if (rc != Z_OK && !(rc == Z_BUF_ERROR && zs.avail_out == 0)) {
          result = PNGIO_CORRUPT;
          break;
        }
      }
      if (result) break;
    } else {
      if (z_open) idat_done = true;  // IDAT chunks must be consecutive
      if (type == chunk_type("IEND")) {
        ended = true;
      } else if (critical) {
        result = PNGIO_CORRUPT;  // an unknown critical chunk
        break;
      }
    }
  }
  if (z_open) inflateEnd(&zs);
  if (result) return result;
  if (!z_open || filled != raw.size()) return PNGIO_CORRUPT;  // no or too little image data

  const size_t stride = raw.size() / hd.height - 1;
  const size_t bpp = (size_t(file_samples(hd.color_type)) * hd.bit_depth + 7) / 8;
  if (!unfilter(raw.data(), hd.height, stride, bpp)) return PNGIO_CORRUPT;
  const int c = out_channels(hd.color_type);
  const size_t out_row = size_t(hd.width) * c;
  auto* buf = static_cast<unsigned char*>(malloc(out_row * hd.height));
  if (!buf) return PNGIO_NOMEM;
  for (size_t y = 0; y < hd.height; ++y)
    convert_row(raw.data() + y * (stride + 1) + 1, buf + y * out_row, hd, palette);
  *out_c = c;
  *out_buf = buf;
  return PNGIO_OK;
}

// ---------------------------------------------------------------- encode

inline unsigned signed_abs(unsigned char v) { return v < 128 ? v : 256u - v; }

// Filter one row into out (1 + stride bytes, filter byte first), choosing the
// filter with the least sum of |byte as signed|, as libpng does by default
// for 8-bit non-palette images. prev is the previous unfiltered row (zeros
// for the first).
void filter_row(const unsigned char* cur, const unsigned char* prev, size_t stride, size_t bpp,
                unsigned char* out, unsigned char* scratch) {
  unsigned long best_sum = ~0ul;
  for (int f = 0; f < 5; ++f) {
    unsigned char* dst = f == 0 ? scratch : scratch + f * stride;
    unsigned long sum = 0;
    for (size_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
      unsigned char v;
      switch (f) {
        case 0: v = cur[i]; break;
        case 1: v = cur[i] - a; break;
        case 2: v = cur[i] - b; break;
        case 3: v = cur[i] - ((a + b) >> 1); break;
        default: v = cur[i] - paeth(a, b, c); break;
      }
      dst[i] = v;
      sum += signed_abs(v);
    }
    if (sum < best_sum) {
      best_sum = sum;
      out[0] = static_cast<unsigned char>(f);
      memcpy(out + 1, dst, stride);
    }
  }
}

struct Buffer {
  unsigned char* data = nullptr;
  size_t len = 0, cap = 0;
  bool reserve(size_t extra) {
    if (len + extra <= cap) return true;
    size_t want = cap ? cap * 2 : 65536;
    while (want < len + extra) want *= 2;
    auto* p = static_cast<unsigned char*>(realloc(data, want));
    if (!p) return false;
    data = p;
    cap = want;
    return true;
  }
  // one chunk: length, type, body, CRC over type and body
  bool chunk(const char* type, const unsigned char* body, size_t n) {
    if (!reserve(n + 12)) return false;
    put_be32(data + len, uint32_t(n));
    memcpy(data + len + 4, type, 4);
    if (n) memcpy(data + len + 8, body, n);
    put_be32(data + len + 8 + n, uint32_t(crc32(crc32(0L, Z_NULL, 0), data + len + 4, uInt(n + 4))));
    len += n + 12;
    return true;
  }
};

int encode(const unsigned char* img, int h, int w, int c, int level, Buffer* out) {
  if (c != 1 && c != 3) return PNGIO_OPEN;
  if (h <= 0 || w <= 0) return PNGIO_CORRUPT;
  if (level < 0) level = 0;
  if (level > 9) level = 9;
  const size_t stride = size_t(w) * c;
  std::vector<unsigned char> filtered, scratch, zeros;
  try {
    filtered.resize(size_t(h) * (stride + 1));
    scratch.resize(5 * stride);
    zeros.assign(stride, 0);
  } catch (const std::exception&) {
    return PNGIO_NOMEM;
  }
  for (int y = 0; y < h; ++y)
    filter_row(img + size_t(y) * stride, y ? img + size_t(y - 1) * stride : zeros.data(), stride,
               size_t(c), filtered.data() + size_t(y) * (stride + 1), scratch.data());

  unsigned char ihdr[13];
  put_be32(ihdr, uint32_t(w));
  put_be32(ihdr + 4, uint32_t(h));
  ihdr[8] = 8;
  ihdr[9] = c == 1 ? 0 : 2;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  if (!out->reserve(8)) return PNGIO_NOMEM;
  memcpy(out->data, kSignature, 8);
  out->len = 8;
  if (!out->chunk("IHDR", ihdr, 13)) return PNGIO_NOMEM;

  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, 15, 8, Z_FILTERED) != Z_OK) return PNGIO_NOMEM;
  // IDAT chunks of at most 1 MiB, deflated straight into the output buffer
  const size_t kIdat = 1 << 20;
  zs.next_in = filtered.data();
  size_t left = filtered.size();
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    if (!out->reserve(kIdat + 12)) { deflateEnd(&zs); return PNGIO_NOMEM; }
    unsigned char* body = out->data + out->len + 8;
    zs.next_out = body;
    zs.avail_out = uInt(kIdat);
    while (zs.avail_out && rc != Z_STREAM_END) {
      const uInt take = left > 0x40000000u ? 0x40000000u : uInt(left);
      if (zs.avail_in == 0 && take) {
        zs.avail_in = take;
        left -= take;
      }
      rc = deflate(&zs, left || zs.avail_in ? Z_NO_FLUSH : Z_FINISH);
      if (rc != Z_OK && rc != Z_STREAM_END && rc != Z_BUF_ERROR) { deflateEnd(&zs); return PNGIO_CORRUPT; }
    }
    const size_t n = kIdat - zs.avail_out;
    put_be32(out->data + out->len, uint32_t(n));
    memcpy(out->data + out->len + 4, "IDAT", 4);
    put_be32(body + n, uint32_t(crc32(crc32(0L, Z_NULL, 0), out->data + out->len + 4, uInt(n + 4))));
    out->len += n + 12;
  }
  deflateEnd(&zs);
  if (!out->chunk("IEND", nullptr, 0)) return PNGIO_NOMEM;
  return PNGIO_OK;
}

}  // namespace

extern "C" {

// Decode `path` into a malloc'd H*W*C uint8 buffer. Returns 0 on success.
int pngio_read(const char* path, int* out_h, int* out_w, int* out_c, void** out_buf) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return PNGIO_OPEN;
  long size = -1;
  if (fseek(fp, 0, SEEK_END) == 0) size = ftell(fp);
  if (size < 0 || fseek(fp, 0, SEEK_SET) != 0) {
    fclose(fp);
    return PNGIO_OPEN;
  }
  auto* bytes = static_cast<unsigned char*>(malloc(size ? size_t(size) : 1));
  if (!bytes) {
    fclose(fp);
    return PNGIO_NOMEM;
  }
  const bool ok = fread(bytes, 1, size_t(size), fp) == size_t(size);
  fclose(fp);
  int rc = ok ? decode(bytes, size_t(size), 0, out_h, out_w, out_c, out_buf) : PNGIO_OPEN;
  free(bytes);
  return rc;
}

void pngio_free(void* buf) { free(buf); }

// Batched multi-threaded decode: one call per batch; each file decodes on a
// C++ thread-pool worker. rcs[i] != 0 marks a failed file (its h/w/c/buf are
// undefined); callers free each successful buf with pngio_free.
int pngio_read_many(const char** paths, int n, int* hs, int* ws, int* cs, void** bufs, int* rcs,
                    int n_threads) {
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

// Decode in-memory PNG bytes (same rules as pngio_read). With max_pixels > 0
// a header announcing more pixels returns 6, with out_h/out_w set, before
// any pixel data is inflated.
int pngio_decode(const void* data, size_t len, long long max_pixels, int* out_h, int* out_w,
                 int* out_c, void** out_buf) {
  return decode(static_cast<const unsigned char*>(data), len, max_pixels, out_h, out_w, out_c,
                out_buf);
}

// Encode an H*W*C uint8 buffer (C in {1,3}) into a malloc'd PNG byte buffer
// (caller frees with pngio_free) at zlib `level` (0-9).
int pngio_encode(const void* data, int h, int w, int c, int level, void** out_buf,
                 size_t* out_len) {
  Buffer out;
  int rc = encode(static_cast<const unsigned char*>(data), h, w, c, level, &out);
  if (rc) {
    free(out.data);
    return rc;
  }
  *out_buf = out.data;
  *out_len = out.len;
  return PNGIO_OK;
}

// Encode an H*W*C uint8 buffer (C in {1,3}) to `path` at zlib level 1, the
// throughput-over-ratio choice for the thousands of tiles a run writes.
int pngio_write(const char* path, const void* data, int h, int w, int c) {
  Buffer out;
  int rc = encode(static_cast<const unsigned char*>(data), h, w, c, 1, &out);
  if (rc) {
    free(out.data);
    return rc;
  }
  FILE* fp = fopen(path, "wb");
  if (!fp) {
    free(out.data);
    return 2;
  }
  const bool ok = fwrite(out.data, 1, out.len, fp) == out.len;
  free(out.data);
  return (fclose(fp) == 0 && ok) ? PNGIO_OK : PNGIO_CORRUPT;
}

}  // extern "C"
