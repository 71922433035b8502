// A host BMP decoder for the port's data readers, equal byte for byte to
// Pillow's ``Image.open(f).convert("RGB")`` (PIL/BmpImagePlugin.py): the
// headers it reads (OS/2 core, info, v2-v5), its palette rules (a palette
// of gray ramp entries reads as mode L or 1, a short palette leaves black
// entries, more than 256 entries is refused), its raw unpackers (1, 4 and 8
// bit indices, 16 bit 555 and 565, 24 bit, 32 bit under every bitfield
// layout it accepts, alpha dropped), rows bottom-up or top-down, and its
// Python RLE8/RLE4 decoder with its quirks (a delta reads four bytes, an
// absolute RLE4 run of odd length loses its last pixel, runs align on the
// file's even offsets, a stream that ends before the image is full is
// refused). Whatever Pillow refuses (a header of another size, an unknown
// depth or compression, data that ends early) returns BMP_CORRUPT with a
// message.
//
// No global mutable state: the loader's threads call it at once.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int BMP_OK = 0;
constexpr int BMP_CORRUPT = 1;
constexpr uint64_t kMaxPixels = 2ull * 89478485;  // 2 x Image.MAX_IMAGE_PIXELS

struct Failure {
  int code;
};

struct Bmp {
  const uint8_t* data;
  size_t size;
  char* err;
  int errlen;

  uint64_t width = 0, height = 0;
  int bits = 0;
  int direction = -1;  // -1: the first row stored is the bottom one
  uint64_t offset = 0;
  bool rle = false, rle4 = false;
  char mode = 'P';       // P, L, 1 (mode "1"), R (RGB)
  const char* raw = "";  // Pillow's raw mode
  std::vector<uint8_t> palette;  // RGB triplets, 256 of them, black past the file's
  uint64_t stride = 0;

  [[noreturn]] void fail(const char* fmt, ...) const {
    if (err && errlen > 0) {
      va_list ap;
      va_start(ap, fmt);
      std::vsnprintf(err, errlen, fmt, ap);
      va_end(ap);
    }
    throw Failure{BMP_CORRUPT};
  }

  uint32_t u32(size_t at) const {
    return data[at] | (data[at + 1] << 8) | (data[at + 2] << 16) |
           (static_cast<uint32_t>(data[at + 3]) << 24);
  }
  int u16(size_t at) const { return data[at] | (data[at + 1] << 8); }

  void header() {
    if (size < 2 || data[0] != 'B' || data[1] != 'M') fail("not a BMP file");
    if (size < 18) fail("truncated BMP: the file ends inside its header");
    offset = u32(10);
    uint32_t header_size = u32(14);
    // Pillow reads the rest of the header before it checks its size
    if (header_size >= 4 && header_size - 4 > size - 18)
      fail("truncated BMP: the file ends inside its header");
    size_t hd = 18, pos = 14 + static_cast<size_t>(header_size);
    int pad = 4;
    uint32_t compression = 0, colors = 0;
    uint32_t masks[4] = {0, 0, 0, 0};
    if (header_size == 12) {
      width = u16(hd);
      height = u16(hd + 2);
      bits = u16(hd + 6);
      pad = 3;
    } else if (header_size == 40 || header_size == 52 || header_size == 56 ||
               header_size == 64 || header_size == 108 || header_size == 124) {
      bool y_flip = data[hd + 7] == 0xFF;
      direction = y_flip ? 1 : -1;
      width = u32(hd);
      height = y_flip ? (1ull << 32) - u32(hd + 4) : u32(hd + 4);
      bits = u16(hd + 10);
      compression = u32(hd + 12);
      colors = u32(hd + 28);
      if (compression == 3) {
        if (header_size - 4 >= 48) {
          int n = header_size - 4 >= 52 ? 4 : 3;
          for (int i = 0; i < n; i++) masks[i] = u32(hd + 36 + 4 * i);
        } else {  // a 40-byte header: three masks follow it
          if (pos + 12 > size) fail("truncated BMP: the file ends inside its bitfields");
          for (int i = 0; i < 3; i++) masks[i] = u32(pos + 4 * i);
          pos += 12;
        }
      }
    } else {
      fail("a BMP header of %u bytes: Pillow reads 12, 40, 52, 56, 64, 108 or 124",
           header_size);
    }
    if (width == 0 || height == 0) fail("an empty BMP image");
    uint64_t ncolors = colors ? colors : (bits <= 16 ? 1ull << bits : 0);
    if (offset == 14 + static_cast<uint64_t>(header_size) && bits <= 8) offset += 4 * ncolors;
    switch (bits) {
      case 1: raw = "P;1"; break;
      case 4: raw = "P;4"; break;
      case 8: raw = "P"; break;
      case 16: raw = "BGR;15"; mode = 'R'; break;
      case 24: raw = "BGR"; mode = 'R'; break;
      case 32: raw = "BGRX"; mode = 'R'; break;
      default: fail("a BMP of %d bits a pixel: Pillow reads 1, 4, 8, 16, 24 and 32", bits);
    }
    if (compression == 3) {
      uint32_t r = masks[0], g = masks[1], b = masks[2], a = masks[3];
      auto is = [&](uint32_t r2, uint32_t g2, uint32_t b2, uint32_t a2) {
        return r == r2 && g == g2 && b == b2 && a == a2;
      };
      const char* layout = nullptr;
      if (bits == 32) {
        if (is(0xFF0000, 0xFF00, 0xFF, 0)) layout = "BGRX";
        else if (is(0xFF000000, 0xFF0000, 0xFF00, 0)) layout = "XBGR";
        else if (is(0xFF000000, 0xFF00, 0xFF, 0)) layout = "BGXR";
        else if (is(0xFF000000, 0xFF0000, 0xFF00, 0xFF)) layout = "ABGR";
        else if (is(0xFF, 0xFF00, 0xFF0000, 0xFF000000)) layout = "RGBA";
        else if (is(0xFF0000, 0xFF00, 0xFF, 0xFF000000)) layout = "BGRA";
        else if (is(0xFF000000, 0xFF00, 0xFF, 0xFF0000)) layout = "BGAR";
        else if (is(0, 0, 0, 0)) layout = "BGRA";
      } else if (bits == 24) {
        if (r == 0xFF0000 && g == 0xFF00 && b == 0xFF) layout = "BGR";
      } else if (bits == 16) {
        if (r == 0xF800 && g == 0x7E0 && b == 0x1F) layout = "BGR;16";
        else if (r == 0x7C00 && g == 0x3E0 && b == 0x1F) layout = "BGR;15";
      }
      if (!layout) fail("a BMP bitfields layout Pillow does not read");
      raw = layout;
    } else if (compression == 1 || compression == 2) {
      rle = true;
      rle4 = compression == 2;
    } else if (compression != 0) {
      fail("a BMP of compression %u: Pillow reads raw, RLE8, RLE4 and bitfields", compression);
    }
    if (mode == 'P') {
      if (ncolors == 0 || ncolors > 65536) fail("a BMP palette of %llu colours",
                                               static_cast<unsigned long long>(ncolors));
      size_t want = pad * ncolors;
      size_t got = pos < size ? std::min(want, size - pos) : 0;  // Pillow's read may come short
      const uint8_t* pal = data + std::min(pos, size);
      bool gray = true;
      for (uint64_t i = 0; i < ncolors && gray; i++) {
        uint8_t v = ncolors == 2 ? (i ? 255 : 0) : static_cast<uint8_t>(i);
        size_t at = i * pad;
        gray = at + 3 <= got && pal[at] == v && pal[at + 1] == v && pal[at + 2] == v;
      }
      if (gray) {
        mode = ncolors == 2 ? '1' : 'L';
        raw = ncolors == 2 ? "1" : "L";
      } else {
        size_t entries = got / pad;
        if (entries > 256) fail("a BMP palette of %zu entries: Pillow reads 256", entries);
        palette.assign(256 * 3, 0);
        for (size_t i = 0; i < entries; i++) {
          palette[3 * i] = pal[i * pad + 2];
          palette[3 * i + 1] = pal[i * pad + 1];
          palette[3 * i + 2] = pal[i * pad];
        }
      }
      pos += got;
    }
    if (offset == 0) offset = pos;  // Pillow's `offset or fp.tell()`
    if (width * height > kMaxPixels)
      fail("a BMP of %llu x %llu pixels: over Pillow's decompression-bomb limit",
           static_cast<unsigned long long>(width), static_cast<unsigned long long>(height));
    if (rle && mode != 'P' && mode != 'L') fail("an RLE BMP of %d bits a pixel", bits);
    stride = ((width * bits + 31) >> 3) & ~3ull;
  }

  int raw_bits() const {
    if (!std::strcmp(raw, "1") || !std::strcmp(raw, "P;1")) return 1;
    if (!std::strcmp(raw, "P;4")) return 4;
    if (!std::strcmp(raw, "P") || !std::strcmp(raw, "L")) return 8;
    if (!std::strcmp(raw, "BGR;15") || !std::strcmp(raw, "BGR;16")) return 16;
    if (!std::strcmp(raw, "BGR")) return 24;
    return 32;
  }

  // one index or gray level per pixel to RGB
  void put_index(uint8_t* px, int v) const {
    if (mode == 'P') {
      std::memcpy(px, &palette[3 * v], 3);
    } else {
      uint8_t g = mode == '1' ? (v ? 255 : 0) : v;
      px[0] = px[1] = px[2] = g;
    }
  }

  void unpack_row(const uint8_t* in, uint8_t* out) const {
    const uint64_t w = width;
    if (!std::strcmp(raw, "1") || !std::strcmp(raw, "P;1")) {
      for (uint64_t x = 0; x < w; x++) put_index(out + 3 * x, (in[x >> 3] >> (7 - (x & 7))) & 1);
    } else if (!std::strcmp(raw, "P;4")) {
      for (uint64_t x = 0; x < w; x++)
        put_index(out + 3 * x, (x & 1) ? in[x >> 1] & 15 : in[x >> 1] >> 4);
    } else if (raw_bits() == 8) {
      for (uint64_t x = 0; x < w; x++) put_index(out + 3 * x, in[x]);
    } else if (raw_bits() == 16) {
      bool six = !std::strcmp(raw, "BGR;16");
      for (uint64_t x = 0; x < w; x++) {
        int p = in[2 * x] | (in[2 * x + 1] << 8);
        uint8_t* o = out + 3 * x;
        o[2] = (p & 31) * 255 / 31;
        if (six) {
          o[1] = ((p >> 5) & 63) * 255 / 63;
          o[0] = ((p >> 11) & 31) * 255 / 31;
        } else {
          o[1] = ((p >> 5) & 31) * 255 / 31;
          o[0] = ((p >> 10) & 31) * 255 / 31;
        }
      }
    } else if (raw_bits() == 24) {
      for (uint64_t x = 0; x < w; x++) {
        out[3 * x] = in[3 * x + 2];
        out[3 * x + 1] = in[3 * x + 1];
        out[3 * x + 2] = in[3 * x];
      }
    } else {
      // the byte of R, G and B in each 32-bit layout Pillow names
      int r = 2, g = 1, b = 0;
      if (!std::strcmp(raw, "XBGR") || !std::strcmp(raw, "ABGR")) r = 3, g = 2, b = 1;
      else if (!std::strcmp(raw, "BGXR") || !std::strcmp(raw, "BGAR")) r = 3, g = 1, b = 0;
      else if (!std::strcmp(raw, "RGBA")) r = 0, g = 1, b = 2;
      for (uint64_t x = 0; x < w; x++) {
        out[3 * x] = in[4 * x + r];
        out[3 * x + 1] = in[4 * x + g];
        out[3 * x + 2] = in[4 * x + b];
      }
    }
  }

  void decode_raw(uint8_t* out) const {
    uint64_t row_bytes = (raw_bits() * width + 7) / 8;
    if (stride < row_bytes) fail("a BMP whose rows are shorter than its pixels need");
    uint64_t need = (height - 1) * stride + row_bytes;
    if (offset > size || need > size - offset)
      fail("truncated BMP: the file ends inside its pixel data");
    for (uint64_t i = 0; i < height; i++) {
      uint64_t y = direction < 0 ? height - 1 - i : i;
      unpack_row(data + offset + i * stride, out + y * width * 3);
    }
  }

  // Pillow's BmpRleDecoder, quirks included
  void decode_rle(uint8_t* out) const {
    const uint64_t w = width, total = width * height;
    std::vector<uint8_t> px;
    px.reserve(total);
    size_t pos = offset;
    auto avail = [&]() -> size_t { return pos < size ? size - pos : 0; };
    uint64_t x = 0;
    while (px.size() < total) {
      if (avail() < 2) break;
      int count = data[pos], byte = data[pos + 1];
      pos += 2;
      if (count) {  // encoded mode
        uint64_t n = count;
        if (x + n > w) n = x < w ? w - x : 0;
        for (uint64_t i = 0; i < n; i++)
          px.push_back(rle4 ? ((i & 1) ? byte & 15 : byte >> 4) : byte);
        x += n;
      } else if (byte == 0) {  // end of line
        while (px.size() % w) px.push_back(0);
        x = 0;
      } else if (byte == 1) {  // end of bitmap
        break;
      } else if (byte == 2) {  // delta: Pillow reads two bytes, then the two it uses
        if (avail() < 2) break;
        pos += 2;
        if (avail() < 2) fail("truncated BMP: the file ends inside an RLE delta");
        uint64_t right = data[pos], up = data[pos + 1];
        pos += 2;
        px.resize(px.size() + right + up * w, 0);
        x = px.size() % w;
      } else {  // absolute mode
        size_t want = rle4 ? byte / 2 : byte;
        size_t got = std::min(want, avail());
        for (size_t i = 0; i < got; i++) {
          int v = data[pos + i];
          if (rle4) {
            px.push_back(v >> 4);
            px.push_back(v & 15);
          } else {
            px.push_back(v);
          }
        }
        pos += got;
        if (got < want) break;
        x += byte;
        if (pos % 2) pos++;  // word alignment from the start of the file
      }
    }
    if (px.size() < total) fail("a BMP whose RLE data ends before the image is full");
    for (uint64_t i = 0; i < height; i++) {
      uint64_t y = direction < 0 ? height - 1 - i : i;
      for (uint64_t xx = 0; xx < w; xx++) put_index(out + (y * w + xx) * 3, px[i * w + xx]);
    }
  }
};

void write_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// out: height, width, bits a pixel, RLE (0/1). Returns 0, or BMP_CORRUPT.
int bmp_info(const uint8_t* data, size_t size, int* out, char* err, int errlen) {
  try {
    Bmp b{data, size, err, errlen};
    b.header();
    out[0] = static_cast<int>(b.height);
    out[1] = static_cast<int>(b.width);
    out[2] = b.bits;
    out[3] = b.rle;
    return BMP_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    write_error(err, errlen, "BMP decoder: out of memory");
    return BMP_CORRUPT;
  }
}

// Decodes into out (height x width x 3 RGB); out_size must match.
int bmp_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                   int errlen) {
  try {
    Bmp b{data, size, err, errlen};
    b.header();
    if (out_size != b.width * b.height * 3) b.fail("output buffer of the wrong size");
    if (b.rle)
      b.decode_rle(out);
    else
      b.decode_raw(out);
    return BMP_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    write_error(err, errlen, "BMP decoder: out of memory");
    return BMP_CORRUPT;
  }
}

}  // extern "C"
