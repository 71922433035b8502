// PNG pixel decoder of the port's data layer: host C++17, no libpng.
//
// The caller (utils/png.py) parses the chunks and inflates the image data
// with Python's zlib; this file does the per-byte work that follows, and
// gives what Pillow's `Image.open(f).convert("RGB")` gives:
//   - the five row filters (None, Sub, Up, Average, Paeth), with the
//     filter unit of max(1, bits per pixel / 8) bytes;
//   - Adam7 interlace (every non-zero interlace byte, as Pillow reads it);
//   - colour types 0, 2, 3, 4 and 6 at every bit depth the standard allows;
//   - the RGB Pillow's modes convert to: 1-bit gray 0 or 255, 2- and 4-bit
//     gray scaled by 85 and 17, 16-bit gray ("I;16") clipped to 255,
//     16-bit colour and 16-bit gray + alpha their high byte, alpha dropped;
//   - palette images through the PLTE entries, an index past the last
//     entry (or an image without PLTE) black.
// tRNS changes no RGB value, so it is not read here.
//
// A filter type past 4, or image data shorter than the image, returns
// PNG_CORRUPT with a message in the caller's buffer.
//
// No global mutable state: the loader's threads call it at once.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int PNG_OK = 0;
constexpr int PNG_CORRUPT = 1;

void copy_message(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

// Undo one row's filter in place of `cur` (the raw row after its filter
// byte); `prior` is the previous unfiltered row of the pass, or zeros.
bool unfilter_row(int kind, const uint8_t* raw, const uint8_t* prior, uint8_t* cur,
                  size_t stride, size_t bpp) {
  switch (kind) {
    case 0:
      std::memcpy(cur, raw, stride);
      return true;
    case 1:
      for (size_t i = 0; i < stride; ++i)
        cur[i] = static_cast<uint8_t>(raw[i] + (i >= bpp ? cur[i - bpp] : 0));
      return true;
    case 2:
      for (size_t i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(raw[i] + prior[i]);
      return true;
    case 3:
      for (size_t i = 0; i < stride; ++i) {
        const int a = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = static_cast<uint8_t>(raw[i] + ((a + prior[i]) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < stride; ++i) {
        const int a = i >= bpp ? cur[i - bpp] : 0;
        const int b = prior[i];
        const int c = i >= bpp ? prior[i - bpp] : 0;
        const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
        const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[i] = static_cast<uint8_t>(raw[i] + pred);
      }
      return true;
    default:
      return false;
  }
}

struct Format {
  int width, height, depth, color;
  const uint8_t* palette;  // n_palette RGB entries
  int n_palette;

  int channels() const {
    switch (color) {
      case 0: return 1;
      case 2: return 3;
      case 3: return 1;
      case 4: return 2;
      default: return 4;  // 6
    }
  }
  size_t bits() const { return static_cast<size_t>(channels()) * depth; }
  size_t stride(size_t w) const { return (w * bits() + 7) / 8; }
  size_t bpp() const { return std::max<size_t>(1, bits() / 8); }
};

// The sample of `depth` bits at index i of a packed row (depth < 8).
inline int packed_sample(const uint8_t* row, size_t i, int depth) {
  const size_t bit = i * depth;
  return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
}

// One unfiltered row of n pixels into RGB at out, out_step bytes apart.
void expand_row(const Format& f, const uint8_t* row, size_t n, uint8_t* out, size_t out_step) {
  const int d = f.depth;
  for (size_t x = 0; x < n; ++x, out += out_step) {
    uint8_t r, g, b;
    switch (f.color) {
      case 0:
        if (d == 16) {
          const int v = (row[2 * x] << 8) | row[2 * x + 1];
          r = static_cast<uint8_t>(std::min(v, 255));
        } else if (d == 8) {
          r = row[x];
        } else {
          r = static_cast<uint8_t>(packed_sample(row, x, d) * (255 / ((1 << d) - 1)));
        }
        g = b = r;
        break;
      case 2: {
        const size_t s = d == 16 ? 2 : 1;
        r = row[3 * s * x];
        g = row[3 * s * x + s];
        b = row[3 * s * x + 2 * s];
        break;
      }
      case 3: {
        const int i = d == 8 ? row[x] : packed_sample(row, x, d);
        if (i < f.n_palette) {
          r = f.palette[3 * i];
          g = f.palette[3 * i + 1];
          b = f.palette[3 * i + 2];
        } else {
          r = g = b = 0;
        }
        break;
      }
      case 4:
        r = g = b = row[(d == 16 ? 4 : 2) * x];
        break;
      default: {  // 6
        const size_t s = d == 16 ? 2 : 1;
        r = row[4 * s * x];
        g = row[4 * s * x + s];
        b = row[4 * s * x + 2 * s];
        break;
      }
    }
    out[0] = r;
    out[1] = g;
    out[2] = b;
  }
}

// Adam7: (x0, y0, dx, dy) of each pass
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                              {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

}  // namespace

extern "C" {

// Undo the filters of `rows` rows of `stride` bytes, each led by its filter
// byte in raw (rows x (stride + 1) bytes), into out (rows x stride).
int png_unfilter(const uint8_t* raw, size_t size, int rows, size_t stride, int bpp,
                 uint8_t* out, char* err, int errlen) {
  if (size < static_cast<size_t>(rows) * (stride + 1)) {
    copy_message("png: image data is shorter than its rows", err, errlen);
    return PNG_CORRUPT;
  }
  std::vector<uint8_t> zeros(stride, 0);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const uint8_t* prior = y ? out + (y - 1) * stride : zeros.data();
    if (!unfilter_row(line[0], line + 1, prior, out + y * stride, stride, bpp)) {
      copy_message("png: unknown row filter", err, errlen);
      return PNG_CORRUPT;
    }
  }
  return PNG_OK;
}

// The image as (height, width, 3) uint8 RGB into out, from its inflated
// data (size bytes, at least what the image needs; the rest is ignored).
int png_decode_rgb(const uint8_t* data, size_t size, int width, int height, int depth,
                   int color, int interlace, const uint8_t* palette, int n_palette,
                   uint8_t* out, char* err, int errlen) {
  const Format f{width, height, depth, color, palette, n_palette};
  const int passes = interlace ? 7 : 1;
  size_t pos = 0;
  std::vector<uint8_t> rows[2];
  for (int p = 0; p < passes; ++p) {
    const int x0 = interlace ? kAdam7[p][0] : 0, y0 = interlace ? kAdam7[p][1] : 0;
    const int dx = interlace ? kAdam7[p][2] : 1, dy = interlace ? kAdam7[p][3] : 1;
    const size_t pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
    const size_t ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no filter bytes
    const size_t stride = f.stride(pw);
    rows[0].assign(stride, 0);
    rows[1].assign(stride, 0);
    for (size_t y = 0; y < ph; ++y) {
      if (size < pos + stride + 1) {
        copy_message("png: image data is truncated", err, errlen);
        return PNG_CORRUPT;
      }
      uint8_t* cur = rows[y & 1].data();
      const uint8_t* prior = rows[(y + 1) & 1].data();
      if (!unfilter_row(data[pos], data + pos + 1, prior, cur, stride, f.bpp())) {
        char msg[64];
        std::snprintf(msg, sizeof msg, "png: unknown row filter %d", data[pos]);
        copy_message(msg, err, errlen);
        return PNG_CORRUPT;
      }
      pos += stride + 1;
      uint8_t* dst = out + ((y0 + y * dy) * static_cast<size_t>(width) + x0) * 3;
      expand_row(f, cur, pw, dst, 3 * static_cast<size_t>(dx));
    }
  }
  return PNG_OK;
}

}  // extern "C"
