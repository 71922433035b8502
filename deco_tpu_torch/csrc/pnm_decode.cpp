// A host PNM decoder for the port's data readers, equal byte for byte to
// Pillow's ``Image.open(f).convert("RGB")`` (PIL/PpmImagePlugin.py):
//   - the header as Pillow reads it: a magic of up to six bytes (P1-P6,
//     Pf, and Pillow's own P0CMYK, PyP, PyRGBA and PyCMYK), then tokens of
//     at most 10 bytes, where a comment runs from '#' to the end of its
//     line and may sit inside a token; Python's int() and float() parse
//     them;
//   - raw data (P4-P6, Pf and Pillow's own) at maxval 255 read as they are,
//     at 65535 as 16-bit gray (mode I); at another maxval through
//     PpmDecoder: each sample, of 1 or 2 bytes, scaled by Python's
//     round(v / maxval * 255) (65535 in mode I) and clipped;
//   - plain data (P1-P3) through PpmPlainDecoder, in its blocks of
//     ImageFile.SAFEBLOCK bytes, with its comment and token rules;
//   - each mode to RGB as Pillow converts it: 1, L and I (clipped to 255)
//     as gray, RGBA without its alpha, CMYK by cmyk2rgb, F (Pf: 32-bit
//     floats, bottom row first) truncated and clipped, P (no palette) as
//     black.
// What Pillow refuses (an unknown magic, colour PFM "PF", a bad token, a
// sample over maxval in plain data, data that ends early) returns 1 with a
// message.
//
// No global mutable state: the loader's threads call it at once.

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int PNM_OK = 0;
constexpr int PNM_CORRUPT = 1;
constexpr uint64_t kMaxPixels = 2ull * 89478485;  // 2 x Image.MAX_IMAGE_PIXELS
constexpr size_t kSafeBlock = 1024 * 1024;         // ImageFile.SAFEBLOCK

struct Failure {
  int code;
};

inline bool is_space(int c) {  // Python's bytes whitespace
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r';
}

// Python's int() of ASCII bytes, base 10: a sign, then digits with single
// underscores between them. False if it would raise.
bool python_int(const std::string& t, int64_t& v) {
  size_t i = 0;
  bool neg = false;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) neg = t[i++] == '-';
  if (i >= t.size()) return false;
  v = 0;
  bool digit_before = false;
  for (; i < t.size(); i++) {
    char c = t[i];
    if (c == '_') {
      if (!digit_before || i + 1 >= t.size() || t[i + 1] == '_') return false;
      digit_before = false;
      continue;
    }
    if (c < '0' || c > '9') return false;
    v = v * 10 + (c - '0');  // at most 10 bytes: no overflow
    digit_before = true;
  }
  if (!digit_before) return false;
  if (neg) v = -v;
  return true;
}

// Python's float() of ASCII bytes: a sign, then inf, infinity or nan (any
// case), or a decimal with an exponent, digits grouped by single
// underscores. False if it would raise.
bool python_float(const std::string& t, double& v) {
  size_t i = 0;
  std::string s;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) s += t[i++];
  std::string rest = t.substr(i), low;
  for (char c : rest) low += static_cast<char>(c >= 'A' && c <= 'Z' ? c - 'A' + 'a' : c);
  if (low == "inf" || low == "infinity" || low == "nan") {
    v = std::strtod((s + low).c_str(), nullptr);
    return true;
  }
  // digits [. digits] [e [sign] digits], at least one mantissa digit
  auto digits = [&](size_t& p, bool& any) {
    bool prev_digit = false;
    for (; p < t.size(); p++) {
      char c = t[p];
      if (c >= '0' && c <= '9') {
        s += c;
        any = prev_digit = true;
      } else if (c == '_') {
        if (!prev_digit || p + 1 >= t.size() || t[p + 1] < '0' || t[p + 1] > '9') return false;
        prev_digit = false;
      } else {
        break;
      }
    }
    return true;
  };
  bool mant = false, frac = false;
  if (!digits(i, mant)) return false;
  if (i < t.size() && t[i] == '.') {
    s += t[i++];
    if (i < t.size() && t[i] == '_') return false;
    if (!digits(i, frac)) return false;
  }
  if (!mant && !frac) return false;
  if (i < t.size() && (t[i] == 'e' || t[i] == 'E')) {
    s += t[i++];
    if (i < t.size() && (t[i] == '+' || t[i] == '-')) s += t[i++];
    bool exp = false;
    if (i < t.size() && t[i] == '_') return false;
    if (!digits(i, exp) || !exp) return false;
  }
  if (i != t.size()) return false;
  v = std::strtod(s.c_str(), nullptr);
  return true;
}

// Python's round(x): halves to even
inline int64_t py_round(double x) { return static_cast<int64_t>(std::nearbyint(x)); }

inline uint8_t clip8(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

struct Pnm {
  const uint8_t* data;
  size_t size;
  char* err;
  int errlen;

  size_t pos = 0;
  std::string magic;
  char mode = 0;  // '1', 'L', 'I', 'R' (RGB), 'A' (RGBA), 'C' (CMYK), 'F', 'P'
  int bands = 1;
  int64_t width = 0, height = 0, maxval = 255;
  bool plain = false, scaled = false, big_endian_float = true;

  [[noreturn]] void fail(const char* fmt, ...) const {
    if (err && errlen > 0) {
      va_list ap;
      va_start(ap, fmt);
      std::vsnprintf(err, errlen, fmt, ap);
      va_end(ap);
    }
    throw Failure{PNM_CORRUPT};
  }

  // PpmImageFile._read_token
  std::string token() {
    std::string t;
    while (t.size() <= 10) {
      if (pos >= size) break;
      int c = data[pos++];
      if (is_space(c)) {
        if (t.empty()) continue;
        break;
      }
      if (c == '#') {  // to the end of the line, inside a token too
        while (pos < size) {
          int d = data[pos++];
          if (d == '\r' || d == '\n') break;
        }
        continue;
      }
      t += static_cast<char>(c);
    }
    if (t.empty()) fail("a PNM header that ends early");
    if (t.size() > 10) fail("a PNM header token of more than 10 bytes");
    return t;
  }

  int64_t int_token() {
    std::string t = token();
    int64_t v;
    if (!python_int(t, v)) fail("a PNM header token that is not an integer");
    return v;
  }

  void header() {
    if (size < 2 || data[0] != 'P' || !std::strchr("0123456fy", data[1]) || data[1] == 0)
      fail("not a PNM file");
    for (int i = 0; i < 6 && pos < size; i++) {  // _read_magic
      int c = data[pos++];
      if (is_space(c)) break;
      magic += static_cast<char>(c);
    }
    static const struct {
      const char* magic;
      char mode;
      int bands;
    } kModes[] = {{"P1", '1', 1}, {"P2", 'L', 1},     {"P3", 'R', 3},     {"P4", '1', 1},
                  {"P5", 'L', 1}, {"P6", 'R', 3},     {"P0CMYK", 'C', 4}, {"Pf", 'F', 1},
                  {"PyP", 'P', 1}, {"PyRGBA", 'A', 4}, {"PyCMYK", 'C', 4}};
    for (const auto& m : kModes)
      if (magic == m.magic) mode = m.mode, bands = m.bands;
    if (!mode) fail("not a PPM file");
    plain = magic == "P1" || magic == "P2" || magic == "P3";
    width = int_token();
    height = int_token();
    if (mode == 'F') {
      double scale = 0;
      if (!python_float(token(), scale)) fail("a PFM scale that is not a number");
      if (scale == 0.0 || !std::isfinite(scale)) fail("a PFM scale that is zero or not finite");
      big_endian_float = scale > 0;
    } else if (mode != '1') {
      maxval = int_token();
      if (maxval <= 0 || maxval >= 65536) fail("a PNM maxval of %lld", static_cast<long long>(maxval));
      if (maxval > 255 && mode == 'L') mode = 'I';
      scaled = !plain && maxval != 255 && !(maxval == 65535 && mode == 'I');
    }
    if (width <= 0 || height <= 0) fail("an empty PNM image");
    if (static_cast<uint64_t>(width) * static_cast<uint64_t>(height) > kMaxPixels)
      fail("a PNM of %lld x %lld pixels: over Pillow's decompression-bomb limit",
           static_cast<long long>(width), static_cast<long long>(height));
  }

  // --- the samples, one int per band as Pillow stores the mode ------------

  // raw data: L, RGB, RGBA, CMYK, P at 255; I;16B; 1;I; F
  void raw(std::vector<int64_t>& px, std::vector<float>& fl) const {
    const uint64_t w = width, h = height;
    uint64_t stride = mode == '1' ? (w + 7) / 8
                    : mode == 'F' ? 4 * w
                    : mode == 'I' ? 2 * w
                                  : w * bands;
    if (pos > size || h * stride > size - pos) fail("truncated PNM: the file ends inside its data");
    const uint8_t* d = data + pos;
    if (mode == 'F') {
      fl.resize(w * h);
      for (uint64_t r = 0; r < h; r++) {
        const uint8_t* row = d + (h - 1 - r) * stride;  // the bottom row first
        for (uint64_t x = 0; x < w; x++) {
          const uint8_t* b = row + 4 * x;
          uint32_t u = big_endian_float ? (uint32_t(b[0]) << 24 | b[1] << 16 | b[2] << 8 | b[3])
                                        : (uint32_t(b[3]) << 24 | b[2] << 16 | b[1] << 8 | b[0]);
          std::memcpy(&fl[r * w + x], &u, 4);
        }
      }
      return;
    }
    px.resize(w * h * bands);
    for (uint64_t r = 0; r < h; r++) {
      const uint8_t* row = d + r * stride;
      int64_t* out = px.data() + r * w * bands;
      if (mode == '1') {
        for (uint64_t x = 0; x < w; x++) out[x] = (row[x >> 3] >> (7 - (x & 7))) & 1 ? 0 : 255;
      } else if (mode == 'I') {
        for (uint64_t x = 0; x < w; x++) out[x] = row[2 * x] << 8 | row[2 * x + 1];
      } else {
        for (uint64_t i = 0; i < w * bands; i++) out[i] = row[i];
      }
    }
  }

  // PpmDecoder: samples of 1 or 2 bytes at another maxval, scaled
  void ppm(std::vector<int64_t>& px) const {
    const int in_bytes = maxval < 256 ? 1 : 2;
    const int64_t out_max = mode == 'I' ? 65535 : 255;
    const uint64_t total = static_cast<uint64_t>(width) * height * bands;
    const size_t pixel = static_cast<size_t>(in_bytes) * bands;
    size_t avail = pos < size ? size - pos : 0;
    if (avail / pixel * bands < total) fail("not enough PNM image data");
    px.resize(total);
    const uint8_t* d = data + pos;
    for (uint64_t i = 0; i < total; i++) {
      int64_t v = in_bytes == 1 ? d[i] : (d[2 * i] << 8 | d[2 * i + 1]);
      px[i] = std::min<int64_t>(out_max, py_round(static_cast<double>(v) / maxval * out_max));
    }
  }

  // PpmPlainDecoder, block by block
  struct Plain {
    const Pnm& p;
    size_t at;
    bool comment_spans = false;

    std::string read_block() {
      size_t n = at < p.size ? std::min(kSafeBlock, p.size - at) : 0;
      std::string b(reinterpret_cast<const char*>(p.data) + at, n);
      at += n;
      return b;
    }
    static long find_comment_end(const std::string& b, size_t start) {
      size_t a = b.find('\n', start), c = b.find('\r', start);
      long la = a == std::string::npos ? -1 : static_cast<long>(a);
      long lc = c == std::string::npos ? -1 : static_cast<long>(c);
      return la * lc > 0 ? std::min(la, lc) : std::max(la, lc);
    }
    std::string ignore_comments(std::string block) {
      if (comment_spans) {
        while (!block.empty()) {
          long end = find_comment_end(block, 0);
          if (end != -1) {
            block = block.substr(end + 1);
            break;
          }
          block = read_block();
        }
      }
      comment_spans = false;
      for (;;) {
        size_t start = block.find('#');
        if (start == std::string::npos) break;
        long end = find_comment_end(block, start);
        if (end != -1) {
          block = block.substr(0, start) + block.substr(end + 1);
        } else {
          block = block.substr(0, start);
          comment_spans = true;
          break;
        }
      }
      return block;
    }
  };

  void plain_bitonal(std::vector<int64_t>& px) const {
    Plain pl{*this, pos};
    const uint64_t total = static_cast<uint64_t>(width) * height;
    px.clear();
    px.reserve(total);
    while (px.size() != total) {
      std::string block = pl.read_block();
      if (block.empty()) break;
      block = pl.ignore_comments(block);
      std::vector<int64_t> got;
      for (char c : block) {
        if (is_space(static_cast<uint8_t>(c))) continue;
        if (c != '0' && c != '1') fail("an invalid token in plain PBM data");
        got.push_back(c == '0' ? 255 : 0);
      }
      for (int64_t v : got) {
        if (px.size() == total) break;
        px.push_back(v);
      }
    }
    if (px.size() != total) fail("not enough PNM image data");
  }

  void plain_blocks(std::vector<int64_t>& px) const {
    Plain pl{*this, pos};
    const int64_t out_max = mode == 'I' ? 65535 : 255;
    const uint64_t total = static_cast<uint64_t>(width) * height * bands;
    px.clear();
    px.reserve(total);
    std::string half;
    while (px.size() != total) {
      std::string block = pl.read_block();
      if (block.empty()) {
        if (half.empty()) break;
        block = " ";  // flushes the half token
      }
      block = pl.ignore_comments(block);
      if (!half.empty()) {
        block = half + block;
        half.clear();
      }
      std::vector<std::string> tokens;
      for (size_t i = 0; i < block.size();) {
        while (i < block.size() && is_space(static_cast<uint8_t>(block[i]))) i++;
        size_t j = i;
        while (j < block.size() && !is_space(static_cast<uint8_t>(block[j]))) j++;
        if (j > i) tokens.push_back(block.substr(i, j - i));
        i = j;
      }
      if (!block.empty() && !is_space(static_cast<uint8_t>(block.back()))) {
        half = tokens.back();  // the block may split it
        tokens.pop_back();
        if (half.size() > 10) fail("a token of more than 10 bytes in plain PNM data");
      }
      for (const std::string& t : tokens) {
        if (t.size() > 10) fail("a token of more than 10 bytes in plain PNM data");
        int64_t v;
        if (!python_int(t, v)) fail("a token that is not an integer in plain PNM data");
        if (v < 0) fail("a negative sample in plain PNM data");
        if (v > maxval) fail("a sample over maxval in plain PNM data");
        px.push_back(py_round(static_cast<double>(v) / maxval * out_max));
        if (px.size() == total) break;
      }
    }
    if (px.size() != total) fail("not enough PNM image data");
  }

  void decode(uint8_t* out) const {
    std::vector<int64_t> px;
    std::vector<float> fl;
    if (plain && mode == '1')
      plain_bitonal(px);
    else if (plain)
      plain_blocks(px);
    else if (scaled)
      ppm(px);
    else
      raw(px, fl);
    const uint64_t n = static_cast<uint64_t>(width) * height;
    for (uint64_t i = 0; i < n; i++) {
      uint8_t* o = out + 3 * i;
      switch (mode) {
        case 'F': {  // F -> L: truncated, clipped, NaN to 0
          float v = fl[i];
          uint8_t g = std::isnan(v) || v <= 0.0f ? 0 : (v >= 255.0f ? 255 : static_cast<uint8_t>(v));
          o[0] = o[1] = o[2] = g;
          break;
        }
        case 'R':
        case 'A':
          for (int c = 0; c < 3; c++) o[c] = static_cast<uint8_t>(px[i * bands + c]);
          break;
        case 'C': {  // cmyk2rgb
          int nk = 255 - static_cast<int>(px[i * 4 + 3]);
          for (int c = 0; c < 3; c++)
            o[c] = clip8(nk - muldiv255(static_cast<int>(px[i * 4 + c]), nk));
          break;
        }
        case 'P':  // a palette image with no palette: every index is black
          o[0] = o[1] = o[2] = 0;
          break;
        default:  // 1, L and I: gray, I clipped
          o[0] = o[1] = o[2] = clip8(px[i]);
      }
    }
  }
};

}  // namespace

extern "C" {

// out: height, width, the number of Pillow's mode ('1', 'L', 'I', ...), plain (0/1).
int pnm_info(const uint8_t* data, size_t size, int* out, char* err, int errlen) {
  try {
    Pnm p{data, size, err, errlen};
    p.header();
    out[0] = static_cast<int>(p.height);
    out[1] = static_cast<int>(p.width);
    out[2] = p.mode;
    out[3] = p.plain;
    return PNM_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    if (err && errlen > 0) std::snprintf(err, errlen, "PNM decoder: out of memory");
    return PNM_CORRUPT;
  }
}

// Decodes into out (height x width x 3 RGB); out_size must match.
int pnm_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                   int errlen) {
  try {
    Pnm p{data, size, err, errlen};
    p.header();
    if (out_size != static_cast<uint64_t>(p.width) * p.height * 3)
      p.fail("output buffer of the wrong size");
    p.decode(out);
    return PNM_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    if (err && errlen > 0) std::snprintf(err, errlen, "PNM decoder: out of memory");
    return PNM_CORRUPT;
  }
}

}  // extern "C"
