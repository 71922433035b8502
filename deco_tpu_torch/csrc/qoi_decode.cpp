// A host QOI decoder for the port's data readers, equal byte for byte to
// Pillow's ``Image.open(f).convert("RGB")`` (PIL/QoiImagePlugin.py, its
// Python QoiDecoder): the op stream (RGB, RGBA, INDEX, DIFF, LUMA, RUN)
// from a previous pixel of (0, 0, 0, 255) and a 64-entry index of
// (0, 0, 0, 0) hashed by (3r + 5g + 7b + 11a) % 64, which every op but RUN
// updates; a file of 3 channels is RGB, of any other count RGBA, whose
// alpha RGB drops. As in Pillow, the end marker is not read and the last
// run may overrun the image. A stream that ends before the image is full
// (or inside an op) returns 1 with a message, as Pillow raises there.
//
// No global mutable state: the loader's threads call it at once.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int QOI_OK = 0;
constexpr int QOI_CORRUPT = 1;
constexpr uint64_t kMaxPixels = 2ull * 89478485;  // 2 x Image.MAX_IMAGE_PIXELS
constexpr size_t kHeader = 14;

struct Header {
  uint64_t width, height;
  int channels;
};

const char* header(const uint8_t* data, size_t size, Header& h) {
  if (size < 4 || std::memcmp(data, "qoif", 4) != 0) return "not a QOI file";
  // Pillow reads the channel byte; the colour-space byte may be missing
  if (size < 13) return "truncated QOI: the file ends inside its header";
  auto be32 = [&](size_t at) {
    return static_cast<uint64_t>(data[at]) << 24 | data[at + 1] << 16 | data[at + 2] << 8 |
           data[at + 3];
  };
  h.width = be32(4);
  h.height = be32(8);
  h.channels = data[12] == 3 ? 3 : 4;
  if (h.width == 0 || h.height == 0) return "an empty QOI image";
  if (h.width * h.height > kMaxPixels)
    return "a QOI image over Pillow's decompression-bomb limit";
  return nullptr;
}

void write_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// out: height, width, channels (3 or 4), 0.
int qoi_info(const uint8_t* data, size_t size, int* out, char* err, int errlen) {
  Header h;
  if (const char* msg = header(data, size, h)) {
    write_error(err, errlen, msg);
    return QOI_CORRUPT;
  }
  out[0] = static_cast<int>(h.height);
  out[1] = static_cast<int>(h.width);
  out[2] = h.channels;
  out[3] = 0;
  return QOI_OK;
}

// Decodes into out (height x width x 3 RGB); out_size must match.
int qoi_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                   int errlen) {
  Header h;
  if (const char* msg = header(data, size, h)) {
    write_error(err, errlen, msg);
    return QOI_CORRUPT;
  }
  const uint64_t total = h.width * h.height;
  if (out_size != total * 3) {
    write_error(err, errlen, "output buffer of the wrong size");
    return QOI_CORRUPT;
  }
  uint8_t index[64][4];
  std::memset(index, 0, sizeof(index));
  uint8_t prev[4] = {0, 0, 0, 255};
  size_t pos = kHeader;
  uint64_t done = 0;
  auto ends = [&](size_t need) { return pos > size || size - pos < need; };
  while (done < total) {
    if (ends(1)) {
      write_error(err, errlen, "truncated QOI: the file ends before the image is full");
      return QOI_CORRUPT;
    }
    const int op = data[pos++];
    uint8_t v[4];
    if (op == 0xFE || op == 0xFF) {  // RGB (the previous alpha), RGBA
      const size_t n = op == 0xFE ? 3 : 4;
      if (ends(n)) {
        write_error(err, errlen, "truncated QOI: the file ends inside an op");
        return QOI_CORRUPT;
      }
      std::memcpy(v, prev, 4);
      std::memcpy(v, data + pos, n);
      pos += n;
    } else if ((op >> 6) == 0) {  // INDEX
      std::memcpy(v, index[op & 63], 4);
    } else if ((op >> 6) == 1) {  // DIFF
      v[0] = static_cast<uint8_t>(prev[0] + ((op >> 4) & 3) - 2);
      v[1] = static_cast<uint8_t>(prev[1] + ((op >> 2) & 3) - 2);
      v[2] = static_cast<uint8_t>(prev[2] + (op & 3) - 2);
      v[3] = prev[3];
    } else if ((op >> 6) == 2) {  // LUMA
      if (ends(1)) {
        write_error(err, errlen, "truncated QOI: the file ends inside an op");
        return QOI_CORRUPT;
      }
      const int second = data[pos++];
      const int dg = (op & 63) - 32;
      v[0] = static_cast<uint8_t>(prev[0] + dg + ((second >> 4) - 8));
      v[1] = static_cast<uint8_t>(prev[1] + dg);
      v[2] = static_cast<uint8_t>(prev[2] + dg + ((second & 15) - 8));
      v[3] = prev[3];
    } else {  // RUN of the previous pixel: neither it nor the index change
      for (int i = (op & 63) + 1; i > 0 && done < total; i--, done++)
        std::memcpy(out + 3 * done, prev, 3);
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(index[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    std::memcpy(out + 3 * done++, v, 3);
  }
  return QOI_OK;
}

}  // extern "C"
