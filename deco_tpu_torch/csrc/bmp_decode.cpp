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
// The same bitmap reader decodes the formats that wrap one: a DIB (a BMP
// without its file header, Pillow's DibImageFile), a Windows cursor
// (CurImagePlugin: the largest cursor of the directory, its height halved)
// and the bitmap frames of a Windows icon (IcoImagePlugin: the largest
// entry, then the lowest bit depth; the height halved; the AND mask, or the
// alpha bytes of a 32-bit entry, must be in the file, as Pillow reads them
// though RGB drops them). An icon's PNG frames are the caller's
// (data/ico.py decodes them with utils/png.py).
//
// No global mutable state: the loader's threads call it at once.

#include <algorithm>
#include <cmath>
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
    bitmap(14, u32(10));
    check_pixels(height);
  }

  // Pillow's decompression-bomb check, on the size it opens
  void check_pixels(uint64_t rows) const {
    if (width * rows > kMaxPixels)
      fail("a BMP of %llu x %llu pixels: over Pillow's decompression-bomb limit",
           static_cast<unsigned long long>(width), static_cast<unsigned long long>(rows));
  }

  // BmpImageFile._bitmap: the info header at hpos; file_offset is the BMP
  // file header's data offset, 0 where there is none (the data then follows
  // the header, its bitfields and its palette)
  void bitmap(size_t hpos, uint64_t file_offset) {
    offset = file_offset;
    if (hpos > size || size - hpos < 4) fail("truncated bitmap: the file ends inside its header");
    uint32_t header_size = u32(hpos);
    // Pillow reads the rest of the header before it checks its size
    if (header_size >= 4 && header_size - 4 > size - hpos - 4)
      fail("truncated BMP: the file ends inside its header");
    size_t hd = hpos + 4, pos = hpos + std::max<size_t>(header_size, 4);
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

// CurImagePlugin._open: the cursor whose width and height both exceed
// those of every cursor taken before it (the first to start), read as a
// bitmap at its offset, its height halved. Returns 0 (no PNG frame).
size_t open_cur(Bmp& b) {
  const uint8_t* data = b.data;
  const size_t size = b.size;
  if (size < 6 || std::memcmp(data, "\0\0\2\0", 4) != 0) b.fail("not a CUR file");
  const int count = data[4] | (data[5] << 8);
  size_t pos = 6, m = 0, mlen = 0;  // the entry taken: its position and the bytes read of it
  for (int i = 0; i < count; i++) {
    size_t len = pos < size ? std::min<size_t>(16, size - pos) : 0;
    if (mlen == 0) {
      m = pos;
      mlen = len;
    } else {
      if (len < 1) b.fail("truncated CUR: the file ends inside its directory");
      if (data[pos] > data[m]) {
        if (len < 2 || mlen < 2) b.fail("truncated CUR: the file ends inside its directory");
        if (data[pos + 1] > data[m + 1]) {
          m = pos;
          mlen = len;
        }
      }
    }
    pos += len;
  }
  if (mlen == 0) b.fail("a CUR file with no cursor");
  if (mlen < 16) b.fail("truncated CUR: the file ends inside its directory");
  size_t at = b.u32(m + 12);
  b.bitmap(at ? at : pos, 0);  // an offset of 0 reads on from the directory
  b.height /= 2;
  if (b.height == 0) b.fail("an empty CUR image");
  b.check_pixels(b.height);
  return 0;
}

// IcoFile and IcoImageFile: the entry of the largest area, then the lowest
// colour depth, then the first. Returns the offset of a PNG frame (decoded
// by the caller), or 0 where the frame is a bitmap, which b then reads.
size_t open_ico(Bmp& b) {
  const uint8_t* data = b.data;
  const size_t size = b.size;
  if (size < 6 || std::memcmp(data, "\0\0\1\0", 4) != 0) b.fail("not an ICO file");
  const int count = data[4] | (data[5] << 8);
  if (count == 0) b.fail("an ICO file with no image");
  if (size - 6 < 16ull * count) b.fail("truncated ICO: the file ends inside its directory");
  size_t best = 0;
  uint64_t best_square = 0;
  int best_depth = 0;
  for (int i = 0; i < count; i++) {
    const size_t e = 6 + 16 * static_cast<size_t>(i);
    const uint64_t w = data[e] ? data[e] : 256, h = data[e + 1] ? data[e + 1] : 256;
    const int colors = data[e + 2], bpp = data[e + 6] | (data[e + 7] << 8);
    // color_depth = bpp or (nb_color != 0 and ceil(log(nb_color, 2))) or 256
    int depth = bpp;
    if (!depth && colors) depth = static_cast<int>(std::ceil(std::log(colors) / std::log(2.0)));
    if (!depth) depth = 256;
    if (i == 0 || w * h > best_square || (w * h == best_square && depth < best_depth)) {
      best = e;
      best_square = w * h;
      best_depth = depth;
    }
  }
  const uint32_t entry_bpp = data[best + 6] | (data[best + 7] << 8);
  const uint64_t entry_size = b.u32(best + 8), entry_offset = b.u32(best + 12);
  static const uint8_t kPng[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (entry_offset + 8 <= size && std::memcmp(data + entry_offset, kPng, 8) == 0)
    return entry_offset;
  b.bitmap(entry_offset, 0);  // DibImageFile at the entry's offset
  b.check_pixels(b.height);
  b.height = b.height / 2;  // the XOR image; the AND mask follows it
  if (b.height == 0) b.fail("an empty ICO image");
  const uint64_t w = b.width, h = b.height;
  if (entry_bpp == 32) {  // the alpha bytes of the BGRA rows
    if (b.offset > size || w * h * 4 > size - b.offset)
      b.fail("truncated ICO: the file ends inside its alpha bytes");
  } else {  // the AND mask: rows of 32-bit words, ending where the entry ends
    const uint64_t stride = (w + 31) / 32 * 4, total = stride * h;
    // Pillow's raw decoder needs every row but the last one's padding
    const uint64_t need = (h - 1) * stride + (w + 7) / 8;
    if (entry_offset + entry_size < total || entry_offset + entry_size - total > size ||
        need > size - (entry_offset + entry_size - total))
      b.fail("truncated ICO: the file ends inside its AND mask");
  }
  return 0;
}

void write_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

// The four formats share these: opens b as the format does
template <typename Open>
int info_of(const uint8_t* data, size_t size, int* out, char* err, int errlen, Open open) {
  try {
    Bmp b{data, size, err, errlen};
    out[3] = static_cast<int>(open(b));
    out[0] = static_cast<int>(b.height);
    out[1] = static_cast<int>(b.width);
    out[2] = b.bits;
    return BMP_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    write_error(err, errlen, "BMP decoder: out of memory");
    return BMP_CORRUPT;
  }
}

template <typename Open>
int decode_of(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
              int errlen, Open open) {
  try {
    Bmp b{data, size, err, errlen};
    if (open(b)) b.fail("an icon frame that is a PNG");
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

size_t open_dib(Bmp& b) {
  b.bitmap(0, 0);
  b.check_pixels(b.height);
  return 0;
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

// A DIB (a BMP without its file header), a CUR and an ICO: out as
// bmp_info's, but that out[3] is, for an icon, the offset of a PNG frame
// (0 for a bitmap frame; its decode then fails) and 0 for the others.
int dib_info(const uint8_t* data, size_t size, int* out, char* err, int errlen) {
  return info_of(data, size, out, err, errlen, open_dib);
}
int dib_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                   int errlen) {
  return decode_of(data, size, out, out_size, err, errlen, open_dib);
}
int cur_info(const uint8_t* data, size_t size, int* out, char* err, int errlen) {
  return info_of(data, size, out, err, errlen, open_cur);
}
int cur_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                   int errlen) {
  return decode_of(data, size, out, out_size, err, errlen, open_cur);
}
int ico_info(const uint8_t* data, size_t size, int* out, char* err, int errlen) {
  return info_of(data, size, out, err, errlen, open_ico);
}
int ico_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                   int errlen) {
  return decode_of(data, size, out, out_size, err, errlen, open_ico);
}

}  // extern "C"
