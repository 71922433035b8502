// A host GIF decoder for the port's data readers: the first frame, equal
// byte for byte to Pillow's ``Image.open(f).convert("RGB")``
// (PIL/GifImagePlugin.py over its C LZW decoder, GifDecode.c). It follows
// Pillow where the format leaves room:
// - the blocks before the first image descriptor are read as Pillow reads
//   them (extensions and their sub-blocks, stray bytes skipped one by one);
// - a colour table that is the gray ramp (entry i = (i, i, i)) reads as
//   mode L, and so does a local one, whatever the global table;
// - the canvas grows to hold a frame that passes the logical screen, and
//   outside the frame it holds the graphic-control transparency index, else
//   index 0, through the palette (entries past the table are black);
// - Pillow's LZW decoder: codes grow when the next free entry reaches the
//   code mask, a code past the next free entry is refused, and an end code
//   stops the decode only at the end of the data read so far: Pillow feeds
//   its decoder 65,536 bytes at a time and takes up the codes after an end
//   code if more data follows (else the file is "truncated"); a sub-block
//   is decoded only once the file holds all of it;
// - interlaced rows in Pillow's pass order, which ends with the last row
//   of the last pass, whatever data follows.
// What Pillow refuses returns GIF_CORRUPT with a message.
//
// No global mutable state: the loader's threads call it at once.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int GIF_OK = 0;
constexpr int GIF_CORRUPT = 1;
constexpr uint64_t kMaxPixels = 2ull * 89478485;  // 2 x Image.MAX_IMAGE_PIXELS
constexpr size_t kChunk = 65536;                  // ImageFile.decodermaxblock
constexpr int kTable = 4096;

struct Failure {
  int code;
};

struct Gif {
  const uint8_t* data;
  size_t size;
  char* err;
  int errlen;
  size_t pos = 0;

  int width = 0, height = 0;               // the canvas
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;      // the first frame's extent
  bool interlace = false;
  int transparency = -1;
  int bits = 0;                            // LZW minimum code size
  size_t offset = 0;                       // the LZW data's first block
  bool paletted = false;                   // mode P, else L
  uint8_t palette[256 * 3] = {};

  [[noreturn]] void fail(const char* fmt, ...) const {
    if (err && errlen > 0) {
      va_list ap;
      va_start(ap, fmt);
      std::vsnprintf(err, errlen, fmt, ap);
      va_end(ap);
    }
    throw Failure{GIF_CORRUPT};
  }

  // fp.read(n): as many bytes as are left, at most n
  size_t read(size_t n, const uint8_t** at) {
    size_t got = pos < size ? std::min(n, size - pos) : 0;
    *at = data + std::min(pos, size);
    pos += got;
    return got;
  }
  int read_byte() {  // -1 at the end of the file
    return pos < size ? data[pos++] : -1;
  }
  // GifImageFile.data(): a sub-block's bytes, or none (size 0 or the end)
  bool sub_block(const uint8_t** at, size_t* len) {
    int n = read_byte();
    if (n <= 0) return false;
    *len = read(n, at);
    return true;
  }
  static bool palette_needed(const uint8_t* p, size_t len, const Gif& g) {
    for (size_t i = 0; i < len; i += 3) {
      // Pillow's chained comparison, IndexError included
      if (p[i] != i / 3) return true;
      if (i + 1 >= len) g.fail("corrupt GIF: a colour table cut short");
      if (p[i + 1] != p[i]) return true;
      if (i + 2 >= len) g.fail("corrupt GIF: a colour table cut short");
      if (p[i + 2] != p[i]) return true;
    }
    return false;
  }

  void header() {
    if (size < 6 || (std::memcmp(data, "GIF87a", 6) && std::memcmp(data, "GIF89a", 6)))
      fail("not a GIF file");
    if (size < 13) fail("truncated GIF: the file ends inside its screen descriptor");
    width = data[6] | (data[7] << 8);
    height = data[8] | (data[9] << 8);
    int flags = data[10];
    pos = 13;
    bool global = false;
    uint8_t global_palette[256 * 3] = {};
    if (flags & 128) {
      const uint8_t* p;
      size_t n = read(3u << ((flags & 7) + 1), &p);
      if (palette_needed(p, n, *this)) {
        global = true;
        std::memcpy(global_palette, p, n);
      }
    }
    int b = read_byte();
    if (b < 0 || b == ';') fail("a GIF without an image");
    bool found = false, local_seen = false, local = false;
    uint8_t local_palette[256 * 3] = {};
    int frame_transparency = -1;
    for (;;) {
      if (b == -2) b = read_byte();  // -2: the next byte is to be read
      if (b < 0 || b == ';') break;
      if (b == '!') {
        int label = read_byte();
        const uint8_t* block = nullptr;
        size_t len = 0;
        bool have = sub_block(&block, &len);
        if (label < 0) fail("truncated GIF: the file ends inside an extension");
        if (label == 249 && have) {
          if (len < 3) fail("corrupt GIF: a short graphic control extension");
          if (block[0] & 1) {
            if (len < 4) fail("corrupt GIF: a short graphic control extension");
            frame_transparency = block[3];
          }
        } else if (label == 254) {
          while (have && len) have = sub_block(&block, &len);  // the comment
          b = -2;
          continue;
        } else if (label == 255 && have && len >= 11 &&
                   !std::memcmp(block, "NETSCAPE2.0", 11)) {
          sub_block(&block, &len);  // the loop count, which the first frame ignores
        }
        while (sub_block(&block, &len) && len) {
        }
      } else if (b == ',') {
        const uint8_t* s;
        if (read(9, &s) < 9) fail("truncated GIF: the file ends inside an image descriptor");
        x0 = s[0] | (s[1] << 8);
        y0 = s[2] | (s[3] << 8);
        x1 = x0 + (s[4] | (s[5] << 8));
        y1 = y0 + (s[6] | (s[7] << 8));
        if (x1 > width || y1 > height) {
          width = std::max(x1, width);
          height = std::max(y1, height);
          if (static_cast<uint64_t>(width) * height > kMaxPixels)
            fail("a GIF of %d x %d pixels: over Pillow's decompression-bomb limit", width, height);
        }
        int fl = s[8];
        interlace = fl & 64;
        if (fl & 128) {
          const uint8_t* p;
          size_t n = read(3u << ((fl & 7) + 1), &p);
          local_seen = true;
          local = palette_needed(p, n, *this);
          if (local) std::memcpy(local_palette, p, n);
        }
        int code_size = read_byte();
        if (code_size < 0) fail("truncated GIF: the file ends before the image data");
        bits = code_size;
        offset = pos;
        found = true;
        break;
      }
      b = -2;
    }
    if (!found) fail("a GIF without an image");
    transparency = frame_transparency;
    if (local_seen) {
      paletted = local;
      if (local) std::memcpy(palette, local_palette, sizeof palette);
    } else {
      paletted = global;
      if (global) std::memcpy(palette, global_palette, sizeof palette);
    }
    if (width <= 0 || height <= 0) fail("an empty GIF image");
    if (static_cast<uint64_t>(width) * height > kMaxPixels)
      fail("a GIF of %d x %d pixels: over Pillow's decompression-bomb limit", width, height);
    // decoder.setimage: an extent from x 0 to x 0 means the whole image
    if (x0 == 0 && x1 == 0) {
      x1 = width;
      y0 = 0;
      y1 = height;
    }
    if (x1 - x0 <= 0 || x1 > width || y1 - y0 <= 0 || y1 > height)
      fail("corrupt GIF: the frame's tile lies outside the image");
  }

  void decode(uint8_t* out) {
    // the canvas as indices (mode P or L): the transparency index, else 0
    std::vector<uint8_t> canvas(static_cast<size_t>(width) * height,
                                transparency >= 0 ? transparency : 0);
    if (offset >= size) fail("truncated GIF: the file ends before the image data");
    if (bits > 12) fail("corrupt GIF: an LZW code size of %d", bits);
    const size_t avail = size - offset;
    size_t chunks = 1;
    auto buffer_end = [&]() { return offset + std::min(chunks * kChunk, avail); };
    auto more = [&](const char* what) {  // ImageFile.load reads the next chunk
      if (buffer_end() >= size) fail("truncated GIF: %s", what);
      chunks++;
    };

    const int clear = 1 << bits, end = clear + 1;
    uint8_t table_data[kTable];
    uint16_t link[kTable];
    uint8_t stack[kTable];
    int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
    int state = 2;  // 2: the first code after a clear; 3: after it
    int lastcode = 0, lastdata = 0;
    uint32_t bitbuffer = 0;
    int bitcount = 0;
    size_t q = offset;  // the next byte to read
    size_t blocksize = 0;

    const int xsize = x1 - x0, ysize = y1 - y0;
    int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
    // writes one pixel; false once the last row of the last pass is done
    auto put = [&](int v) -> bool {
      canvas[static_cast<size_t>(y + y0) * width + x0 + x] = v;
      if (++x < xsize) return true;
      x = 0;
      y += step;
      while (y >= ysize) {
        switch (pass) {
          case 1: y = 4; pass = 2; break;
          case 2: step = 4; y = 2; pass = 3; break;
          case 3: step = 2; y = 1; pass = 0; break;
          default: return false;
        }
      }
      return true;
    };

    bool done = false;
    while (!done) {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= static_cast<uint32_t>(data[q++]) << bitcount;
          bitcount += 8;
          blocksize--;
        } else {
          // a new sub-block, started only once the data read holds all of it
          while (q >= buffer_end() || q + 1 + data[q] > buffer_end())
            more("the file ends inside the image data");
          blocksize = data[q++];
        }
      }
      int c = bitbuffer & codemask;
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) {
          state = 2;
          next = clear + 2;
          codesize = bits + 1;
          codemask = (1 << codesize) - 1;
        }
        continue;
      }
      if (c == end) {  // ends the decode at the end of the data read so far
        more("an LZW end code before the image is complete");
        continue;
      }
      int n = 0;  // the string: lastdata, then stack[kTable - n ..]
      if (state == 2) {
        if (c > clear) fail("corrupt GIF: broken LZW data");
        lastdata = lastcode = c;
        state = 3;
      } else {
        int thiscode = c;
        if (c > next) fail("corrupt GIF: broken LZW data");
        if (c == next) {
          if (n >= kTable) fail("corrupt GIF: broken LZW data");
          stack[kTable - ++n] = lastdata;
          c = lastcode;
        }
        while (c >= clear) {
          if (n >= kTable || c >= kTable) fail("corrupt GIF: broken LZW data");
          stack[kTable - ++n] = table_data[c];
          c = link[c];
        }
        lastdata = c;
        if (next < kTable) {
          table_data[next] = c;
          link[next] = lastcode;
          if (next == codemask && codesize < 12) {
            codesize++;
            codemask = (1 << codesize) - 1;
          }
          next++;
        }
        lastcode = thiscode;
      }
      if (!put(lastdata)) break;
      for (int i = kTable - n; i < kTable; i++) {
        if (!put(stack[i])) {
          done = true;
          break;
        }
      }
    }
    for (size_t i = 0; i < canvas.size(); i++) {
      int v = canvas[i];
      if (paletted) {
        std::memcpy(out + 3 * i, palette + 3 * v, 3);
      } else {
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = v;
      }
    }
  }
};

void write_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// out: height, width, paletted (mode P: 1, mode L: 0), interlaced.
int gif_info(const uint8_t* data, size_t size, int* out, char* err, int errlen) {
  try {
    Gif g{data, size, err, errlen};
    g.header();
    out[0] = g.height;
    out[1] = g.width;
    out[2] = g.paletted;
    out[3] = g.interlace;
    return GIF_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    write_error(err, errlen, "GIF decoder: out of memory");
    return GIF_CORRUPT;
  }
}

// Decodes the first frame into out (height x width x 3 RGB); out_size must match.
int gif_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                   int errlen) {
  try {
    Gif g{data, size, err, errlen};
    g.header();
    if (out_size != static_cast<size_t>(g.width) * g.height * 3)
      g.fail("output buffer of the wrong size");
    g.decode(out);
    return GIF_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    write_error(err, errlen, "GIF decoder: out of memory");
    return GIF_CORRUPT;
  }
}

}  // extern "C"
