// A host WebP decoder for the port's data readers, equal byte for byte to
// Pillow's ``Image.open(f).convert("RGB")``. Pillow opens every WebP through
// libwebp's WebPAnimDecoder (PIL/WebPImagePlugin.py), so this source follows
// that path (libwebp 1.6, its x86 build):
// - the demuxer's checks of the RIFF container (chunk sizes against the RIFF
//   size, the VP8X flags, canvas and frame bounds, ALPH before the image, no
//   bytes left over after the last chunk);
// - the first frame, composed as WebPAnimDecoder composes a key frame: the
//   canvas zeroed, the frame decoded into its rectangle (alpha is dropped by
//   convert("RGB"), so the rectangle's RGB is the frame's);
// - VP8L (RFC 9649): prefix codes and meta prefix codes, LZ77 with the
//   distance map, the colour cache and the four transforms, with libwebp's
//   bit reader, so a stream that runs out of bits fails where libwebp's does;
// - VP8 (RFC 6386): the boolean decoder, segments, quantisers, token
//   partitions, intra prediction (unfiltered neighbours and libwebp's edge
//   samples), the inverse WHT and DCT (the full 4x4 inverse DCT in 16-bit
//   lanes as libwebp's SSE2 code computes it, the DC-only and three-
//   coefficient ones in 32 bits as its C code), the normal and simple loop
//   filters, then libwebp's "fancy" chroma upsampling and its fixed-point
//   YUV to RGB;
// - ALPH (raw, or VP8L-compressed with libwebp's 8-bit path where it takes
//   it) decoded only as far as it decides whether libwebp fails.
// What Pillow refuses returns WEBP_CORRUPT with a message.
//
// No global mutable state: the loader's threads call it at once.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int WEBP_OK = 0;
constexpr int WEBP_CORRUPT = 1;
constexpr uint64_t kMaxPixels = 2ull * 89478485;  // 2 x Image.MAX_IMAGE_PIXELS
constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;

struct Failure {
  int code;
};

struct Err {
  char* buf;
  int len;
  [[noreturn]] void fail(const char* fmt, ...) const {
    if (buf && len > 0) {
      va_list ap;
      va_start(ap, fmt);
      std::vsnprintf(buf, len, fmt, ap);
      va_end(ap);
    }
    throw Failure{WEBP_CORRUPT};
  }
};

uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
bool tag(const uint8_t* p, const char* t) { return std::memcmp(p, t, 4) == 0; }

// The tables of RFC 6386 (VP8), in libwebp's index order, and RFC 9649's
// distance map.
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ---- VP8L ---------------------------------------------------------------

// libwebp's VP8LBitReader: a 64-bit window refilled a byte at a time; it is
// at its end once more bits were taken than the stream holds
struct BitReaderL {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  bool eos = false;

  void init(const uint8_t* start, size_t length) {
    len = length;
    val = 0;
    bit_pos = 0;
    eos = false;
    size_t n = std::min<size_t>(length, 8);
    for (size_t i = 0; i < n; i++) val |= static_cast<uint64_t>(start[i]) << (8 * i);
    pos = n;
    buf = start;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= static_cast<uint64_t>(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t prefetch() const { return static_cast<uint32_t>(val >> (bit_pos & 63)); }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}
uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}
int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: 0 for an invalid code (all lengths zero,
// over-subscribed, or incomplete with more than one symbol), else the
// table's size; root (when given) must hold the largest table
int build_table(HCode* root, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0}, offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
  int total_size = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {
    if (root) replicate(root, 1, total_size, HCode{0, sorted[0]});
    return total_size;
  }
  HCode* table = root;
  uint32_t low = 0xffffffffu, mask = total_size - 1, key = 0;
  int num_nodes = 1, num_open = 1, table_bits = root_bits, table_size = 1 << table_bits;
  int symbol = 0, len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (!root) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size,
                HCode{static_cast<uint8_t>(len), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root) {
          root[low].bits = static_cast<uint8_t>(table_bits + root_bits);
          root[low].value = static_cast<uint16_t>((table - root) - low);
        }
      }
      if (root)
        replicate(&table[key >> root_bits], step, table_size,
                  HCode{static_cast<uint8_t>(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  return total_size;
}

// the code's table, or an empty vector for an invalid code
std::vector<HCode> make_table(int root_bits, const int* lengths, int n) {
  int size = build_table(nullptr, root_bits, lengths, n);
  if (size == 0) return {};
  // the first pass may undercount the second-level tables; the real pass
  // writes into room for the largest code's
  std::vector<HCode> table((1 << root_bits) + (1 << kMaxCodeLength));
  size = build_table(table.data(), root_bits, lengths, n);
  table.resize(size);
  return table;
}

int read_symbol(const HCode* table, BitReaderL& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kRootBits) - 1);
  int nbits = table->bits - kRootBits;
  if (nbits > 0) {
    br.bit_pos += kRootBits;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24, kNumDistanceCodes = 40;
constexpr int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, 256, 256, 256,
                                  kNumDistanceCodes};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};

struct HTreeGroup {
  std::vector<HCode> trees[5];
};

struct Meta {
  int cache_bits = 0;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  std::vector<HTreeGroup> groups;
  std::vector<int> group_of;  // the Huffman image's group -> groups[] (-1: unused)
  // every group libwebp keeps codes R, B and A of one symbol (its 8-bit
  // alpha path); it keeps them all unless it remaps the groups
  bool rba_trivial = true;

  const HTreeGroup& group_at(int x, int y) const {
    if (huffman_bits == 0) return groups[0];
    uint32_t g = huffman_image[huffman_xsize * (y >> huffman_bits) + (x >> huffman_bits)];
    return groups[group_of[g]];
  }
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct TransformL {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
uint32_t average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}
uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
int add_sub_full(int a, int b, int c) { return clip255(static_cast<uint32_t>(a + b - c)); }
uint32_t clamped_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const int a = add_sub_full(c0 >> 24, c1 >> 24, c2 >> 24);
  const int r = add_sub_full((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_full((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_full(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return (static_cast<uint32_t>(a) << 24) | (r << 16) | (g << 8) | b;
}
int add_sub_half(int a, int b) { return clip255(static_cast<uint32_t>(a + (a - b) / 2)); }
uint32_t clamped_add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = add_sub_half(ave >> 24, c2 >> 24);
  const int r = add_sub_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_half(ave & 0xff, c2 & 0xff);
  return (static_cast<uint32_t>(a) << 24) | (r << 16) | (g << 8) | b;
}
int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
// the 14 predictors (and 14, 15 as 0) of a pixel from its left and top row
uint32_t predict(int mode, const uint32_t* left, const uint32_t* top) {
  switch (mode) {
    case 1: return *left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(*left, top[1]), top[0]);
    case 6: return average2(*left, top[-1]);
    case 7: return average2(*left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(*left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], *left, top[-1]);
    case 12: return clamped_add_sub_full(*left, top[0], top[-1]);
    case 13: return clamped_add_sub_half(*left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

int8_t s8(uint32_t v) { return static_cast<int8_t>(static_cast<uint8_t>(v)); }
int color_delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

// out = the transform's inverse of in, (ysize rows of t.xsize)
void inverse_transform(const TransformL& t, const std::vector<uint32_t>& in,
                       std::vector<uint32_t>& out) {
  const int w = t.xsize, h = t.ysize;
  out.resize(static_cast<size_t>(w) * h);
  switch (t.type) {
    case SUBTRACT_GREEN:
      for (size_t i = 0; i < out.size(); i++) {
        const uint32_t argb = in[i], green = (argb >> 8) & 0xff;
        uint32_t rb = argb & 0x00ff00ffu;
        rb += (green << 16) | green;
        out[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      break;
    case PREDICTOR: {
      const int tiles_per_row = sub_sample(w, t.bits);
      for (int y = 0; y < h; y++) {
        const uint32_t* src = in.data() + static_cast<size_t>(y) * w;
        uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
        if (y == 0) {
          dst[0] = add_pixels(src[0], 0xff000000u);
          for (int x = 1; x < w; x++) dst[x] = add_pixels(src[x], dst[x - 1]);
          continue;
        }
        const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
        dst[0] = add_pixels(src[0], dst[-w]);
        for (int x = 1; x < w; x++) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          dst[x] = add_pixels(src[x], predict(mode, dst + x - 1, dst + x - w));
        }
      }
      break;
    }
    case CROSS_COLOR: {
      const int tiles_per_row = sub_sample(w, t.bits);
      for (int y = 0; y < h; y++) {
        const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
        for (int x = 0; x < w; x++) {
          const uint32_t code = codes[x >> t.bits];
          const int8_t g2r = s8(code), g2b = s8(code >> 8), r2b = s8(code >> 16);
          const size_t i = static_cast<size_t>(y) * w + x;
          const uint32_t argb = in[i];
          const int8_t green = s8(argb >> 8);
          int new_red = (argb >> 16) & 0xff, new_blue = argb & 0xff;
          new_red += color_delta(g2r, green);
          new_red &= 0xff;
          new_blue += color_delta(g2b, green);
          new_blue += color_delta(r2b, static_cast<int8_t>(new_red));
          new_blue &= 0xff;
          out[i] = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
        }
      }
      break;
    }
    case COLOR_INDEXING: {
      const int bits_per_pixel = 8 >> t.bits, count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      const int in_w = sub_sample(w, t.bits);
      for (int y = 0; y < h; y++) {
        const uint32_t* src = in.data() + static_cast<size_t>(y) * in_w;
        uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
        uint32_t packed = 0;
        for (int x = 0; x < w; x++) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = t.data[packed & bit_mask];
          packed >>= bits_per_pixel;
        }
      }
      break;
    }
  }
}

int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4, xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}
int copy_value(int symbol, BitReaderL& br) {  // a length or a distance
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + br.read(extra_bits) + 1;
}

struct VP8LDecoder {
  BitReaderL br;
  TransformL transforms[4];
  int next_transform = 0;
  unsigned transforms_seen = 0;
  int width = 0, height = 0;  // of the coded image, after the transforms that pack it
  Meta meta;

  bool read_code_lengths(const int* code_length_code_lengths, int num_symbols,
                         int* code_lengths) {
    std::vector<HCode> table = make_table(7, code_length_code_lengths, 19);
    if (table.empty()) return false;
    int max_symbol;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(length_nbits);
      if (max_symbol > num_symbols) return false;
    } else {
      max_symbol = num_symbols;
    }
    int symbol = 0, prev_code_len = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br.fill();
      const HCode& p = table[br.prefetch() & 0x7f];
      br.bit_pos += p.bits;
      const int code_len = p.value;
      if (code_len < 16) {
        code_lengths[symbol++] = code_len;
        if (code_len != 0) prev_code_len = code_len;
      } else {
        static const int kExtraBits[3] = {2, 3, 7}, kRepeatOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = br.read(kExtraBits[slot]) + kRepeatOffsets[slot];
        if (symbol + repeat > num_symbols) return false;
        const int length = code_len == 16 ? prev_code_len : 0;
        while (repeat-- > 0) code_lengths[symbol++] = length;
      }
    }
    return true;
  }

  // one prefix code: its table (empty when only checked) or false;
  // symbols: how many it codes
  bool read_code(int alphabet_size, int* code_lengths, std::vector<HCode>* out,
                 int* symbols) {
    const int simple = br.read(1);
    std::memset(code_lengths, 0, alphabet_size * sizeof(int));
    bool ok;
    if (simple) {
      const int num_symbols = br.read(1) + 1;
      const int first_len = br.read(1);
      int symbol = br.read(first_len == 0 ? 1 : 8);
      code_lengths[symbol] = 1;
      if (num_symbols == 2) {
        symbol = br.read(8);
        code_lengths[symbol] = 1;
      }
      ok = true;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
      ok = read_code_lengths(cl_lengths, alphabet_size, code_lengths);
    }
    ok = ok && !br.eos;
    if (!ok) return false;
    *symbols = 0;
    for (int i = 0; i < alphabet_size; i++) *symbols += code_lengths[i] > 0;
    if (out) {
      *out = make_table(kRootBits, code_lengths, alphabet_size);
      return !out->empty();
    }
    return build_table(nullptr, kRootBits, code_lengths, alphabet_size) != 0;
  }

  bool read_huffman_codes(int xsize, int ysize, int cache_bits, bool allow_recursion,
                          Meta& m) {
    int num_groups_max = 1;
    if (allow_recursion && br.read(1)) {
      const int precision = 2 + br.read(3);
      const int hx = sub_sample(xsize, precision), hy = sub_sample(ysize, precision);
      std::vector<uint32_t> image;
      if (!decode_image_stream(hx, hy, false, &image)) return false;
      m.huffman_bits = precision;
      m.huffman_xsize = hx;
      for (uint32_t& v : image) {
        v = (v >> 8) & 0xffff;
        num_groups_max = std::max<int>(num_groups_max, v + 1);
      }
      m.huffman_image.swap(image);
    }
    if (br.eos) return false;
    // groups[] keeps the used groups in the order of their index
    m.group_of.assign(num_groups_max, -1);
    if (m.huffman_bits == 0) {
      m.group_of[0] = 0;
    } else {
      for (uint32_t v : m.huffman_image) m.group_of[v] = 0;
      int n = 0;
      for (int& g : m.group_of)
        if (g == 0) g = n++;
    }
    const bool remapped = num_groups_max > 1000 || num_groups_max > xsize * ysize;
    const int max_alphabet = kAlphabetSize[0] + (cache_bits > 0 ? 1 << cache_bits : 0);
    std::vector<int> code_lengths(max_alphabet);
    for (int i = 0; i < num_groups_max; ++i) {
      const bool used = m.group_of[i] >= 0;
      HTreeGroup group;
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabetSize[j], symbols = 0;
        if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
        if (!read_code(alphabet, code_lengths.data(), used ? &group.trees[j] : nullptr,
                       &symbols))
          return false;
        if ((used || !remapped) && (j == RED || j == BLUE || j == ALPHA) && symbols > 1)
          m.rba_trivial = false;
      }
      if (used) m.groups.push_back(std::move(group));
    }
    return true;
  }

  // libwebp's DecodeImageData: false on a bad reference or a stream that
  // ends before the last pixel
  bool decode_pixels(std::vector<uint32_t>& data, int w, int h, const Meta& m) {
    BitReaderL& b = br;
    const int total = w * h;
    const int cache_size = m.cache_bits ? 1 << m.cache_bits : 0;
    std::vector<uint32_t> cache(cache_size, 0);
    const uint32_t hash_shift = 32 - m.cache_bits;
    int pos = 0, last_cached = 0, col = 0, row = 0;
    auto cache_up_to = [&](int end) {
      for (; last_cached < end; ++last_cached)
        cache[(0x1e35a7bdu * data[last_cached]) >> hash_shift] = data[last_cached];
    };
    const HTreeGroup* g = total ? &m.group_at(0, 0) : nullptr;
    const int mask = m.huffman_bits ? (1 << m.huffman_bits) - 1 : -1;
    auto advance = [&]() {
      ++pos;
      if (++col >= w) {
        col = 0;
        ++row;
        if (cache_size) cache_up_to(pos);
      }
    };
    while (pos < total) {
      if ((col & mask) == 0) g = &m.group_at(col, row);
      b.fill();
      const int code = read_symbol(g->trees[GREEN].data(), b);
      if (b.at_end()) break;
      if (code < kNumLiteralCodes) {
        const int red = read_symbol(g->trees[RED].data(), b);
        b.fill();
        const int blue = read_symbol(g->trees[BLUE].data(), b);
        const int alpha = read_symbol(g->trees[ALPHA].data(), b);
        if (b.at_end()) break;
        data[pos] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
        advance();
      } else if (code < kNumLiteralCodes + kNumLengthCodes) {
        const int length = copy_value(code - kNumLiteralCodes, b);
        const int dist_symbol = read_symbol(g->trees[DIST].data(), b);
        b.fill();
        const int dist = plane_code_to_distance(w, copy_value(dist_symbol, b));
        if (b.at_end()) break;
        if (pos < dist || total - pos < length) return false;
        for (int i = 0; i < length; i++) data[pos + i] = data[pos + i - dist];
        pos += length;
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
        if (col & mask) g = &m.group_at(col, row);
        if (cache_size) cache_up_to(pos);
      } else if (code < kNumLiteralCodes + kNumLengthCodes + cache_size) {
        cache_up_to(pos);
        data[pos] = cache[code - kNumLiteralCodes - kNumLengthCodes];
        advance();
      } else {
        return false;
      }
    }
    return !b.at_end();
  }

  bool read_transform(int& xsize, int ysize) {
    const int type = br.read(2);
    if (transforms_seen & (1u << type)) return false;
    transforms_seen |= 1u << type;
    TransformL& t = transforms[next_transform++];
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    switch (type) {
      case PREDICTOR:
      case CROSS_COLOR:
        t.bits = 2 + br.read(3);
        return decode_image_stream(sub_sample(t.xsize, t.bits), sub_sample(t.ysize, t.bits),
                                   false, &t.data);
      case COLOR_INDEXING: {
        const int num_colors = br.read(8) + 1;
        const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        xsize = sub_sample(t.xsize, bits);
        t.bits = bits;
        std::vector<uint32_t> colors;
        if (!decode_image_stream(num_colors, 1, false, &colors)) return false;
        // the colour map as deltas, then black transparent past its end
        const int final_num_colors = 1 << (8 >> bits);
        t.data.assign(final_num_colors, 0);
        uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* src = reinterpret_cast<const uint8_t*>(colors.data());
        std::memcpy(dst, src, 4);
        for (int i = 4; i < 4 * num_colors; ++i) dst[i] = (src[i] + dst[i - 4]) & 0xff;
        return true;
      }
      default:
        return true;
    }
  }

  // libwebp's DecodeImageStream; level 0 (the image itself) keeps its
  // prefix codes in meta and decodes no pixels here
  bool decode_image_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out) {
    int txsize = xsize;
    bool ok = true;
    if (level0) {
      while (ok && br.read(1)) ok = read_transform(txsize, ysize);
    }
    int cache_bits = 0;
    if (ok && br.read(1)) {
      cache_bits = br.read(4);
      ok = cache_bits >= 1 && cache_bits <= 11;
    }
    if (!ok) return false;
    Meta m;
    m.cache_bits = cache_bits;
    if (!read_huffman_codes(txsize, ysize, cache_bits, level0, m)) return false;
    if (level0) {
      width = txsize;
      height = ysize;
      meta = std::move(m);
      return true;
    }
    out->assign(static_cast<size_t>(txsize) * ysize, 0);
    return decode_pixels(*out, txsize, ysize, m) && !br.eos;
  }

  // the pixels of the level-0 image, inverse transforms applied
  bool decode_argb(std::vector<uint32_t>& argb) {
    std::vector<uint32_t> data(static_cast<size_t>(width) * height);
    if (!decode_pixels(data, width, height, meta)) return false;
    std::vector<uint32_t> tmp;
    for (int n = next_transform - 1; n >= 0; --n) {
      inverse_transform(transforms[n], data, tmp);
      data.swap(tmp);
    }
    argb.swap(data);
    return true;
  }

  // libwebp's DecodeAlphaData (the 8-bit path of an ALPH stream that only
  // indexes colours): the last symbol may run past the end of the data
  bool decode_alpha_8b() {
    const int w = width, total = width * height;
    int pos = 0, col = 0, row = 0;
    const Meta& m = meta;
    const int mask = m.huffman_bits ? (1 << m.huffman_bits) - 1 : -1;
    const HTreeGroup* g = total ? &m.group_at(0, 0) : nullptr;
    std::vector<uint8_t> data(total);
    while (!br.eos && pos < total) {
      if ((col & mask) == 0) g = &m.group_at(col, row);
      br.fill();
      const int code = read_symbol(g->trees[GREEN].data(), br);
      if (code < kNumLiteralCodes) {
        data[pos++] = static_cast<uint8_t>(code);
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else if (code < kNumLiteralCodes + kNumLengthCodes) {
        const int length = copy_value(code - kNumLiteralCodes, br);
        const int dist_symbol = read_symbol(g->trees[DIST].data(), br);
        br.fill();
        const int dist = plane_code_to_distance(w, copy_value(dist_symbol, br));
        if (pos >= dist && total - pos >= length) {
          for (int i = 0; i < length; i++) data[pos + i] = data[pos + i - dist];
        } else {
          return false;
        }
        pos += length;
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
        if (pos < total && (col & mask)) g = &m.group_at(col, row);
      } else {
        return false;
      }
      br.eos = br.at_end();
    }
    br.eos = br.at_end();
    return !(br.eos && pos < total);
  }
};

// VP8LGetInfo: the signature, size and version of a VP8L image header
bool vp8l_header(BitReaderL& br, const uint8_t* data, size_t size, int* w, int* h) {
  if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return false;
  br.init(data, size);
  if (br.read(8) != 0x2f) return false;
  *w = br.read(14) + 1;
  *h = br.read(14) + 1;
  br.read(1);  // the alpha hint
  if (br.read(3) != 0) return false;
  return !br.eos;
}

// the VP8L image of a w x h frame: false where libwebp's decode fails
bool vp8l_decode(const uint8_t* data, size_t size, int w, int h, std::vector<uint32_t>& argb) {
  VP8LDecoder dec;
  int w2, h2;
  if (!vp8l_header(dec.br, data, size, &w2, &h2) || w2 != w || h2 != h) return false;
  if (!dec.decode_image_stream(w, h, true, nullptr)) return false;
  return dec.decode_argb(argb);
}

// an ALPH payload of a w x h frame: false where libwebp fails on it
bool alpha_ok(const uint8_t* data, size_t size, int w, int h) {
  if (size <= 1) return false;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            rsrv = (data[0] >> 6) & 3;
  (void)filter;  // every 2-bit value names a filter; none of them can fail
  if (method > 1 || pre > 1 || rsrv != 0) return false;
  if (method == 0) return size - 1 >= static_cast<size_t>(w) * h;
  VP8LDecoder dec;
  dec.br.init(data + 1, size - 1);
  if (!dec.decode_image_stream(w, h, true, nullptr)) return false;
  if (dec.next_transform == 1 && dec.transforms[0].type == COLOR_INDEXING &&
      dec.meta.cache_bits == 0 && dec.meta.rba_trivial)
    return dec.decode_alpha_8b();
  std::vector<uint32_t> argb;
  return dec.decode_argb(argb);
}

// ---- VP8 ----------------------------------------------------------------

// libwebp's VP8BitReader (its 64-bit build): 56 bits at a time while eight
// bytes remain, then a byte at a time, and eof once it needs a byte past
// the end. The wide loads matter: on a stream whose value leaves the
// coder's range (corrupt data), the shifted value drops its top bits as
// libwebp's does.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* buf_max = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 255 - 1;
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    buf_max = size >= 8 ? start + size - 8 + 1 : start;
    value = 0;
    bits = -8;
    range = 255 - 1;
    eof = false;
    load();
  }
  void load() {
    if (buf < buf_max) {
      uint64_t in = 0;
      for (int i = 0; i < 8; i++) in = (in << 8) | buf[i];
      buf += 7;
      value = (in >> 8) | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * prob) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 7;
    for (uint32_t x = r; x > 1; x >>= 1) shift--;  // 7 ^ floor(log2(r))
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= static_cast<uint32_t>(get_bit(0x80)) << nbits;
    return v;
  }
  int get_signed_value(int nbits) {
    const int v = get_value(nbits);
    return get_bit(0x80) ? -v : v;
  }
};

constexpr int BPS = 32;  // libwebp's work-buffer stride
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
// libwebp's intra modes: the 4x4 ones, then DC without top, left or both
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

uint8_t clip_8b(int v) { return !(v & ~0xff) ? v : v < 0 ? 0 : 255; }

// the full 4x4 inverse DCT as libwebp's SSE2 Transform computes it: every
// sum in a 16-bit lane, products through _mm_mulhi_epi16
int16_t w16(int v) { return static_cast<int16_t>(v); }
int16_t mulhi(int16_t a, int k) { return w16((static_cast<int>(a) * k) >> 16); }
void idct_full(const int16_t* in, uint8_t* dst) {
  const int k1 = 20091, k2 = -30068;
  int16_t tmp[4][4];  // [output row of the vertical pass][column]
  for (int c = 0; c < 4; c++) {
    const int16_t in0 = in[c], in1 = in[4 + c], in2 = in[8 + c], in3 = in[12 + c];
    const int16_t a = w16(in0 + in2), b = w16(in0 - in2);
    const int16_t cc = w16(w16(in1 - in3) + w16(mulhi(in1, k2) - mulhi(in3, k1)));
    const int16_t d = w16(w16(in1 + in3) + w16(mulhi(in1, k1) + mulhi(in3, k2)));
    tmp[0][c] = w16(a + d);
    tmp[1][c] = w16(b + cc);
    tmp[2][c] = w16(b - cc);
    tmp[3][c] = w16(a - d);
  }
  for (int r = 0; r < 4; r++) {
    const int16_t t0 = tmp[r][0], t1 = tmp[r][1], t2 = tmp[r][2], t3 = tmp[r][3];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t cc = w16(w16(t1 - t3) + w16(mulhi(t1, k2) - mulhi(t3, k1)));
    const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, k1) + mulhi(t3, k2)));
    const int16_t out[4] = {w16(a + d), w16(b + cc), w16(b - cc), w16(a - d)};
    for (int x = 0; x < 4; x++) {
      const int v = dst[r * BPS + x] + (out[x] >> 3);
      dst[r * BPS + x] = v < 0 ? 0 : v > 255 ? 255 : v;
    }
  }
}
int mul1(int a) { return ((a * 20091) >> 16) + a; }
int mul2(int a) { return (a * 35468) >> 16; }
void idct_ac3(const int16_t* in, uint8_t* dst) {  // libwebp's C TransformAC3
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; y++) {
    const int dc = rows[y];
    const int v[4] = {dc + d1, dc + c1, dc - c1, dc - d1};
    for (int x = 0; x < 4; x++) dst[y * BPS + x] = clip_8b(dst[y * BPS + x] + (v[x] >> 3));
  }
}
void idct_dc(const int16_t* in, uint8_t* dst) {  // libwebp's C TransformDC
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++) dst[y * BPS + x] = clip_8b(dst[y * BPS + x] + (dc >> 3));
}
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = w16((a0 + a1) >> 3);
    out[16] = w16((a3 + a2) >> 3);
    out[32] = w16((a0 - a1) >> 3);
    out[48] = w16((a3 - a2) >> 3);
    out += 64;
  }
}

// the intra predictors of libwebp's dec.c, on a block at dst (stride BPS)
#define AVG3(a, b, c) static_cast<uint8_t>(((a) + 2 * (b) + (c) + 2) >> 2)
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]
void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      const int v = top[x] + dst[-1] - top[-1];
      dst[x] = v < 0 ? 0 : v > 255 ? 255 : v;
    }
    dst += BPS;
  }
}
void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; y++) std::memset(dst + y * BPS, v, size);
}
void predict_4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int rows[4] = {AVG3(X, I, J), AVG3(I, J, K), AVG3(J, K, L), AVG3(K, L, L)};
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, rows[i], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
  }
}
#undef DST
#undef AVG2
#undef AVG3

// 16x16 luma (size 16) or 8x8 chroma (size 8), after CheckMode
void predict_block(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, dc >> (shift + 1));
      break;
    }
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    default: fill(dst, size, 0x80); break;
  }
}
int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
  }
  return mode;
}

// the loop filters of libwebp's dec.c
int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // VP8ksclip1
int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2
uint8_t clip1(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }      // VP8kclip1
void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
}
void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip1(p1 + a3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a3);
}
void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip1(p2 + a3);
  p[-2 * step] = clip1(p1 + a2);
  p[-step] = clip1(p0 + a1);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a2);
  p[2 * step] = clip1(q2 - a3);
}
bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int step, int along, int thresh) {  // 16 pixels
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * along, step, thresh2)) do_filter2(p + i * along, step);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4 = 0, uvmode = 0, segment = 0, skip = 0;
  uint8_t imodes[16];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct VP8Decoder {
  Err* e;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br, parts[8];
  int num_parts_minus_one = 0;
  // segment and filter headers
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segments_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
  // the planes, mb-aligned
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> Y, U, V;
  std::vector<FInfo> finfo;

  [[noreturn]] void fail(const char* msg) const { e->fail("corrupt WebP (VP8): %s", msg); }

  void headers(const uint8_t* buf, size_t size) {
    if (size < 4) fail("truncated header");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) fail("incorrect keyframe parameters");
    if (!show) fail("frame not displayable");
    buf += 3;
    size -= 3;
    if (!key_frame) fail("not a key frame");
    if (size < 7) fail("cannot parse picture header");
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) fail("bad code word");
    width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    if (partition_length > size) fail("bad partition length");
    br.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get_value(1);  // colour space
    br.get_value(1);  // clamping type
    // segment header
    use_segment = br.get_value(1);
    if (use_segment) {
      update_map = br.get_value(1);
      if (br.get_value(1)) {
        absolute_delta = br.get_value(1);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) segments_proba[s] = br.get_value(1) ? br.get_value(8) : 255;
    } else {
      update_map = 0;
    }
    if (br.eof) fail("cannot parse segment header");
    // filter header
    simple = br.get_value(1);
    level = br.get_value(6);
    sharpness = br.get_value(3);
    use_lf_delta = br.get_value(1);
    if (use_lf_delta && br.get_value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail("cannot parse filter header");
    // partitions
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    num_parts_minus_one = (1 << br.get_value(2)) - 1;
    const size_t last_part = num_parts_minus_one;
    if (size < 3 * last_part) fail("cannot parse partitions");
    const uint8_t* part_start = buf + last_part * 3;
    size_t size_left = size - last_part * 3;
    for (size_t p = 0; p < last_part; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last_part].init(part_start, size_left);
    if (part_start >= buf_end) fail("cannot parse partitions");
    // quantisers
    const int base_q0 = br.get_value(7);
    const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.get_value(1);  // update_proba, ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[i]) ? br.get_value(8)
                                                                  : kCoeffsProba0[i];
          }
    use_skip_proba = br.get_value(1);
    if (use_skip_proba) skip_p = br.get_value(8);
  }

  void filter_strengths() {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(BoolReader& b, MBData& block, uint8_t* top, uint8_t* left) {
    if (update_map) {
      block.segment = !b.get_bit(segments_proba[0]) ? b.get_bit(segments_proba[1])
                                                    : b.get_bit(segments_proba[2]) + 2;
    } else {
      block.segment = 0;
    }
    if (use_skip_proba) block.skip = b.get_bit(skip_p);
    block.is_i4x4 = !b.get_bit(145);
    if (!block.is_i4x4) {
      const int ymode = b.get_bit(156) ? (b.get_bit(128) ? B_TM : B_HE)
                                       : (b.get_bit(163) ? B_VE : B_DC);
      block.imodes[0] = ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          ymode = !b.get_bit(prob[0])   ? B_DC
                  : !b.get_bit(prob[1]) ? B_TM
                  : !b.get_bit(prob[2]) ? B_VE
                  : !b.get_bit(prob[3])
                      ? (!b.get_bit(prob[4]) ? B_HE : (!b.get_bit(prob[5]) ? B_RD : B_VR))
                      : (!b.get_bit(prob[6])
                             ? B_LD
                             : (!b.get_bit(prob[7]) ? B_VL
                                                    : (!b.get_bit(prob[8]) ? B_HD : B_HU)));
          top[x] = ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = ymode;
      }
    }
    block.uvmode = !b.get_bit(142)   ? B_DC
                   : !b.get_bit(114) ? B_VE
                   : b.get_bit(183)  ? B_TM
                                     : B_HE;
  }

  int large_value(BoolReader& b, const uint8_t* p) {
    int v;
    if (!b.get_bit(p[3])) {
      if (!b.get_bit(p[4])) {
        v = 2;
      } else {
        v = 3 + b.get_bit(p[5]);
      }
    } else {
      if (!b.get_bit(p[6])) {
        if (!b.get_bit(p[7])) {
          v = 5 + b.get_bit(159);
        } else {
          v = 7 + 2 * b.get_bit(165);
          v += b.get_bit(145);
        }
      } else {
        const int bit1 = b.get_bit(p[8]);
        const int bit0 = b.get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.get_bit(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  // the position of the last non-zero coefficient plus one
  int coeffs(BoolReader& b, int t, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[t][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!b.get_bit(p[0])) return n;
      while (!b.get_bit(p[1])) {
        p = proba[t][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!b.get_bit(p[2])) {
        v = 1;
        p = proba[t][kBands[n + 1]][1];
      } else {
        v = large_value(b, p);
        p = proba[t][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(b.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
    return nz_coeffs;
  }

  // libwebp's ParseResiduals; true when no coefficient was coded
  bool residuals(BoolReader& b, MBData& block, uint8_t& top_nz, uint8_t& top_nz_dc,
                 uint8_t& left_nz, uint8_t& left_nz_dc) {
    const Quant& q = dqm[block.segment];
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof block.coeffs);
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_nz_dc + left_nz_dc;
      const int nz = coeffs(b, 1, ctx, q.y2, 0, dc);
      top_nz_dc = left_nz_dc = nz > 0;
      if (nz > 1) {
        iwht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f, non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(b, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = top_nz >> (4 + ch);
      lnz = left_nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(b, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    top_nz = static_cast<uint8_t>(out_t_nz);
    left_nz = static_cast<uint8_t>(out_l_nz);
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  static void luma_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    switch (bits >> 30) {
      case 3: idct_full(src, dst); break;
      case 2: idct_ac3(src, dst); break;
      case 1: idct_dc(src, dst); break;
      default: break;
    }
  }
  static void uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if (!(bits & 0xff)) return;
    if (bits & 0xaa) {
      idct_full(src, dst);
      idct_full(src + 16, dst + 4);
      idct_full(src + 32, dst + 4 * BPS);
      idct_full(src + 48, dst + 4 * BPS + 4);
    } else {
      if (src[0]) idct_dc(src, dst);
      if (src[16]) idct_dc(src + 16, dst + 4);
      if (src[32]) idct_dc(src + 32, dst + 4 * BPS);
      if (src[48]) idct_dc(src + 48, dst + 4 * BPS + 4);
    }
  }

  // libwebp's ReconstructRow: prediction from unfiltered neighbours kept in
  // a work buffer, then the residuals; the row goes into the planes
  void reconstruct_row(int mb_y, const std::vector<MBData>& row, std::vector<uint8_t>& yuv_b,
                       std::vector<uint8_t>& top_y, std::vector<uint8_t>& top_u,
                       std::vector<uint8_t>& top_v) {
    const int kYOff = BPS * 1 + 8, kUOff = kYOff + BPS * 16 + BPS, kVOff = kUOff + 16;
    uint8_t* const y_dst = yuv_b.data() + kYOff;
    uint8_t* const u_dst = yuv_b.data() + kUOff;
    uint8_t* const v_dst = yuv_b.data() + kVOff;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& block = row[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      uint8_t* ty = &top_y[mb_x * 16];
      uint8_t* tu = &top_u[mb_x * 8];
      uint8_t* tv = &top_v[mb_x * 8];
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, ty, 16);
        std::memcpy(u_dst - BPS, tu, 8);
        std::memcpy(v_dst - BPS, tv, 8);
      }
      uint32_t bits = block.non_zero_y;
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            std::memset(top_right, ty[15], 4);
          } else {
            std::memcpy(top_right, ty + 16, 4);
          }
        }
        for (int r = 1; r <= 3; r++) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict_4(block.imodes[n], dst);
          luma_transform(bits, block.coeffs + n * 16, dst);
        }
      } else {
        predict_block(check_mode(mb_x, mb_y, block.imodes[0]), y_dst, 16);
        if (bits != 0)
          for (int n = 0; n < 16; ++n, bits <<= 2)
            luma_transform(bits, block.coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
      predict_block(uv_mode, u_dst, 8);
      predict_block(uv_mode, v_dst, 8);
      uv_transform(block.non_zero_uv >> 0, block.coeffs + 16 * 16, u_dst);
      uv_transform(block.non_zero_uv >> 8, block.coeffs + 20 * 16, v_dst);
      if (mb_y < mb_h - 1) {
        std::memcpy(ty, y_dst + 15 * BPS, 16);
        std::memcpy(tu, u_dst + 7 * BPS, 8);
        std::memcpy(tv, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&Y[(static_cast<size_t>(mb_y) * 16 + j) * ystride + mb_x * 16],
                    y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[(static_cast<size_t>(mb_y) * 8 + j) * uvstride + mb_x * 8],
                    u_dst + j * BPS, 8);
        std::memcpy(&V[(static_cast<size_t>(mb_y) * 8 + j) * uvstride + mb_x * 8],
                    v_dst + j * BPS, 8);
      }
    }
  }

  void loop_filter(int mb_x, int mb_y) {
    const FInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y_dst = &Y[static_cast<size_t>(mb_y) * 16 * ystride + mb_x * 16];
    if (filter_type == 1) {
      if (mb_x > 0) simple_filter(y_dst, 1, ystride, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; k++) simple_filter(y_dst + 4 * k, 1, ystride, limit);
      if (mb_y > 0) simple_filter(y_dst, ystride, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; k++) simple_filter(y_dst + 4 * k * ystride, ystride, 1, limit);
      return;
    }
    uint8_t* u_dst = &U[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8];
    uint8_t* v_dst = &V[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8];
    const int il = f.ilevel, hv = f.hev_thresh, ys = ystride, uvs = uvstride;
    if (mb_x > 0) {
      filter_loop(y_dst, 1, ys, 16, limit + 4, il, hv, true);
      filter_loop(u_dst, 1, uvs, 8, limit + 4, il, hv, true);
      filter_loop(v_dst, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; k++) filter_loop(y_dst + 4 * k, 1, ys, 16, limit, il, hv, false);
      filter_loop(u_dst + 4, 1, uvs, 8, limit, il, hv, false);
      filter_loop(v_dst + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
      filter_loop(y_dst, ys, 1, 16, limit + 4, il, hv, true);
      filter_loop(u_dst, uvs, 1, 8, limit + 4, il, hv, true);
      filter_loop(v_dst, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; k++)
        filter_loop(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      filter_loop(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      filter_loop(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
  }

  // the frame's Y, U and V planes, filtered
  void decode(const uint8_t* data, size_t size) {
    headers(data, size);
    filter_strengths();
    ystride = mb_w * 16;
    uvstride = mb_w * 8;
    Y.assign(static_cast<size_t>(ystride) * mb_h * 16, 0);
    U.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
    V.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
    finfo.assign(static_cast<size_t>(mb_w) * mb_h, FInfo());
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC), top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
    std::vector<uint8_t> yuv_b(BPS * 17 + BPS * 9, 0);
    std::vector<uint8_t> top_y(16 * mb_w + 4, 0), top_u(8 * mb_w, 0), top_v(8 * mb_w, 0);
    std::vector<MBData> row(mb_w);
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        parse_intra_mode(br, row[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) fail("premature end of partition 0");
      BoolReader& tokens = parts[mb_y & num_parts_minus_one];
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& block = row[mb_x];
        bool skip = use_skip_proba ? block.skip : false;
        if (!skip) {
          skip = residuals(tokens, block, top_nz[mb_x], top_nz_dc[mb_x], left_nz, left_nz_dc);
        } else {
          left_nz = top_nz[mb_x] = 0;
          if (!block.is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
          block.non_zero_y = 0;
          block.non_zero_uv = 0;
        }
        if (filter_type > 0) {
          FInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
          f = fstrengths[block.segment][block.is_i4x4];
          f.inner |= !skip;
        }
        if (tokens.eof) fail("premature end of file");
      }
      reconstruct_row(mb_y, row, yuv_b, top_y, top_u, top_v);
    }
    if (filter_type > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) loop_filter(mb_x, mb_y);
  }
};

// libwebp's fixed-point YUV to RGB
int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
uint8_t clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's UpsampleRgbaLinePair: two rows of Y between two rows of U/V
// (bottom_y null: one row); out rows of 3 bytes a pixel, stride ostride
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + (2 * x - 1) * 3);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 3);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + (len - 1) * 3);
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + (len - 1) * 3);
  }
}

// the decoded frame as RGB (w x h x 3, row stride ostride bytes)
void vp8_to_rgb(const VP8Decoder& d, uint8_t* out, size_t ostride) {
  const int w = d.width, h = d.height;
  const uint8_t* Y = d.Y.data();
  const uint8_t* U = d.U.data();
  const uint8_t* V = d.V.data();
  const size_t ys = d.ystride, uvs = d.uvstride;
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
  int y = 1;
  for (; y + 1 < h; y += 2) {
    const size_t k = (y + 1) / 2;
    upsample_pair(Y + y * ys, Y + (y + 1) * ys, U + (k - 1) * uvs, V + (k - 1) * uvs,
                  U + k * uvs, V + k * uvs, out + y * ostride, out + (y + 1) * ostride, w);
  }
  if (y < h) {  // the last row of an even height
    const size_t k = (h / 2) - 1;
    upsample_pair(Y + y * ys, nullptr, U + k * uvs, V + k * uvs, U + k * uvs, V + k * uvs,
                  out + y * ostride, nullptr, w);
  }
}

// ---- the container, as libwebp's demuxer and WebPAnimDecoder read it -----

constexpr uint32_t kAlphaFlag = 0x10, kAnimationFlag = 0x02, kValidFlags = 0x3E;

struct Frame {
  int x_offset = 0, y_offset = 0, width = 0, height = 0;
  size_t image_offset = 0, image_size = 0;  // the image chunk, header and padding included
  size_t alpha_offset = 0, alpha_size = 0;
  bool complete = false;
  int frame_num = 0;
};

struct WebP {
  Err e{nullptr, 0};
  const uint8_t* data = nullptr;
  size_t riff_end = 0, start = 0;  // libwebp's MemBuffer: the parse position
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  bool ext = false;
  int num_frames = 0;
  std::vector<Frame> frames;

  size_t avail() const { return riff_end - start; }
  bool size_invalid(size_t n) const { return n > riff_end - start; }

  // WebPGetFeatures on an image chunk: its width and height, or false
  bool chunk_features(size_t offset, size_t size, int* w, int* h) const {
    const uint8_t* p = data + offset;
    if (size < 12) return false;
    const uint32_t declared = le32(p + 4);
    const uint8_t* bits = p + 8;
    const size_t n = size - 8;
    if (tag(p, "VP8 ")) {
      if (n < 10) return false;
      if (bits[3] != 0x9d || bits[4] != 0x01 || bits[5] != 0x2a) return false;
      const uint32_t b = bits[0] | (bits[1] << 8) | (bits[2] << 16);
      if ((b & 1) || ((b >> 1) & 7) > 3 || !((b >> 4) & 1) || (b >> 5) >= declared) return false;
      *w = ((bits[7] << 8) | bits[6]) & 0x3fff;
      *h = ((bits[9] << 8) | bits[8]) & 0x3fff;
      return *w != 0 && *h != 0;
    }
    BitReaderL br;
    return vp8l_header(br, bits, n, w, h);
  }

  enum Status { OK, MORE, ERROR };

  // libwebp's StoreFrame: the image-bearing chunks from the parse position
  Status store_frame(int frame_num, uint32_t min_size, Frame& f) {
    int alpha_chunks = 0, image_chunks = 0;
    if (avail() < 8 || avail() < min_size) return MORE;
    Status status = OK;
    bool done = false;
    do {
      const size_t chunk_start = start;
      const uint8_t* fourcc = data + start;
      const uint32_t payload = le32(data + start + 4);
      start += 8;
      if (payload > kMaxChunkPayload) return ERROR;
      const uint32_t padded = payload + (payload & 1);
      const size_t available = std::min<size_t>(padded, avail());
      const size_t chunk_size = 8 + available;
      if (size_invalid(padded)) return ERROR;
      if (tag(fourcc, "ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha_offset = chunk_start;
        f.alpha_size = chunk_size;
        f.frame_num = frame_num;
        start += available;
      } else if ((tag(fourcc, "VP8L") || tag(fourcc, "VP8 ")) && image_chunks == 0) {
        if (tag(fourcc, "VP8L") && alpha_chunks > 0) return ERROR;
        int w, h;
        if (!chunk_features(chunk_start, chunk_size, &w, &h)) return ERROR;
        ++image_chunks;
        f.image_offset = chunk_start;
        f.image_size = chunk_size;
        f.width = w;
        f.height = h;
        f.frame_num = frame_num;
        f.complete = true;
        start += available;
      } else {
        if (tag(fourcc, "VP8L") && alpha_chunks > 0 && image_chunks == 0) return ERROR;
        start -= 8;
        done = true;
      }
      if (start == riff_end) {
        done = true;
      } else if (avail() < 8) {
        status = MORE;
      }
    } while (!done && status == OK);
    return status;
  }

  bool add_frame(const Frame& f) {
    if (!frames.empty() && !frames.back().complete) return false;
    frames.push_back(f);
    return true;
  }

  Status parse_single_image() {
    if (!frames.empty()) return ERROR;
    if (size_invalid(8)) return ERROR;
    if (avail() < 8) return MORE;
    Frame f;
    Status status = store_frame(1, 0, f);
    if (status != ERROR) {
      if (!(flags & kAlphaFlag) && f.alpha_size > 0) f.alpha_offset = f.alpha_size = 0;
      if (!ext && f.width > 0 && f.height > 0) {
        canvas_w = f.width;
        canvas_h = f.height;
      }
      if (!add_frame(f)) {
        status = ERROR;
      } else {
        num_frames = 1;
      }
    }
    return status;
  }

  Status parse_animation_frame(uint32_t frame_chunk_size) {
    const bool is_animation = flags & kAnimationFlag;
    if (size_invalid(16)) return ERROR;
    if (frame_chunk_size < 16) return ERROR;
    if (avail() < 16) return MORE;
    const uint32_t anmf_payload = frame_chunk_size - 16;
    Frame f;
    const uint8_t* p = data + start;
    f.x_offset = 2 * static_cast<int>(le24(p));
    f.y_offset = 2 * static_cast<int>(le24(p + 3));
    f.width = 1 + static_cast<int>(le24(p + 6));
    f.height = 1 + static_cast<int>(le24(p + 9));
    start += 16;
    if (static_cast<uint64_t>(f.width) * f.height >= (1ull << 32)) return ERROR;
    const size_t start_offset = start;
    Status status = store_frame(num_frames + 1, anmf_payload, f);
    if (status != ERROR && start - start_offset > anmf_payload) status = ERROR;
    if (status != ERROR && is_animation && f.frame_num > 0) {
      if (add_frame(f)) {
        ++num_frames;
      } else {
        status = ERROR;
      }
    }
    return status;
  }

  Status parse_vp8x() {
    if (avail() < 8) return MORE;
    ext = true;
    start += 4;
    uint32_t vp8x_size = le32(data + start);
    start += 4;
    if (vp8x_size > kMaxChunkPayload) return ERROR;
    if (vp8x_size < 10) return ERROR;
    vp8x_size += vp8x_size & 1;
    if (size_invalid(vp8x_size)) return ERROR;
    if (avail() < vp8x_size) return MORE;
    flags = data[start];
    canvas_w = 1 + static_cast<int>(le24(data + start + 4));
    canvas_h = 1 + static_cast<int>(le24(data + start + 7));
    if (static_cast<uint64_t>(canvas_w) * canvas_h >= (1ull << 32)) return ERROR;
    start += vp8x_size;
    if (size_invalid(8)) return ERROR;
    if (avail() < 8) return MORE;
    // ParseVP8XChunks
    const bool is_animation = flags & kAnimationFlag;
    int anim_chunks = 0;
    Status status = OK;
    do {
      const uint8_t* fourcc = data + start;
      const uint32_t chunk_size = le32(data + start + 4);
      start += 8;
      if (chunk_size > kMaxChunkPayload) return ERROR;
      const uint32_t padded = chunk_size + (chunk_size & 1);
      if (size_invalid(padded)) return ERROR;
      if (tag(fourcc, "VP8X")) {
        return ERROR;
      } else if (tag(fourcc, "ALPH") || tag(fourcc, "VP8 ") || tag(fourcc, "VP8L")) {
        if (anim_chunks > 0 || is_animation) return ERROR;
        start -= 8;
        status = parse_single_image();
      } else if (tag(fourcc, "ANIM")) {
        if (padded < 6) return ERROR;
        if (avail() < padded) {
          status = MORE;
        } else {
          ++anim_chunks;  // a second ANIM is skipped as libwebp skips it
          start += padded;
        }
      } else if (tag(fourcc, "ANMF")) {
        if (anim_chunks == 0) return ERROR;
        status = parse_animation_frame(padded);
      } else {  // ICCP, EXIF, XMP and unknown chunks are skipped
        if (padded <= avail()) {
          start += padded;
        } else {
          status = MORE;
        }
      }
      if (start == riff_end) break;
      if (avail() < 8) status = MORE;
    } while (status == OK);
    return status;
  }

  bool valid_extended() const {
    const bool is_animation = flags & kAnimationFlag;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (frames.empty()) return false;
    if (flags & ~kValidFlags) return false;
    for (const Frame& f : frames) {
      if (!is_animation && f.frame_num > 1) return false;
      if (!f.complete) return false;  // no partial frame in a complete file
      if (f.alpha_size > 0 && f.alpha_offset > f.image_offset) return false;
      if (f.width <= 0 || f.height <= 0) return false;
      if (!is_animation) {
        if (f.x_offset != 0 || f.y_offset != 0 || f.width != canvas_w ||
            f.height != canvas_h)
          return false;
      } else {
        if (f.x_offset < 0 || f.y_offset < 0 || f.width + f.x_offset > canvas_w ||
            f.height + f.y_offset > canvas_h)
          return false;
      }
    }
    return true;
  }

  // WebPDemux on the whole file; then the canvas size
  void demux(size_t size) {
    if (size < 20) e.fail("truncated WebP: %zu bytes", size);
    if (!tag(data, "RIFF") || !tag(data + 8, "WEBP")) e.fail("not a WebP file");
    const uint32_t riff_size = le32(data + 4);
    if (riff_size < 8 || riff_size > kMaxChunkPayload) e.fail("corrupt WebP: RIFF size %u", riff_size);
    riff_end = static_cast<size_t>(riff_size) + 8;
    if (size < riff_end) e.fail("truncated WebP: the file ends inside its RIFF chunk");
    start = 12;
    Status status = ERROR;
    bool valid = false;
    const uint8_t* fourcc = data + 12;
    if (tag(fourcc, "VP8 ") || tag(fourcc, "VP8L")) {
      status = parse_single_image();
      valid = canvas_w > 0 && canvas_h > 0 && !frames.empty() && frames[0].width > 0 &&
              frames[0].height > 0;
    } else if (tag(fourcc, "VP8X")) {
      status = parse_vp8x();
      valid = valid_extended();
    }
    if (status != OK || !valid) e.fail("corrupt WebP: libwebp's demuxer refuses it");
    if (static_cast<uint64_t>(canvas_w) * canvas_h > kMaxPixels)
      e.fail("a WebP of %d x %d pixels: over Pillow's decompression-bomb limit", canvas_w,
             canvas_h);
  }

  // WebPDecode of the first frame's payload into out at its offset
  void decode_frame(uint8_t* out) {
    const Frame& f = frames[0];
    size_t frag_start = f.image_offset, frag_size = f.image_size;
    if (f.alpha_size > 0) {
      frag_start = f.alpha_offset;
      frag_size += f.alpha_size + (f.image_offset - (f.alpha_offset + f.alpha_size));
    }
    const uint8_t* p = data + frag_start;
    size_t n = frag_size;
    if (n < 12) e.fail("corrupt WebP: a truncated frame");
    const uint8_t* alpha = nullptr;
    size_t alpha_size = 0;
    if (tag(p, "ALPH")) {  // ParseOptionalChunks up to the image chunk
      for (;;) {
        if (n < 8) e.fail("corrupt WebP: a truncated frame");
        const uint32_t csize = le32(p + 4);
        if (csize > kMaxChunkPayload) e.fail("corrupt WebP: chunk size");
        const size_t disk = (8 + static_cast<size_t>(csize) + 1) & ~static_cast<size_t>(1);
        if (tag(p, "VP8 ") || tag(p, "VP8L")) break;
        if (n < disk) e.fail("corrupt WebP: a truncated frame");
        if (tag(p, "ALPH")) {
          alpha = p + 8;
          alpha_size = csize;
        }
        p += disk;
        n -= disk;
      }
    }
    if (n < 8) e.fail("corrupt WebP: a truncated frame");
    const bool lossless = tag(p, "VP8L");
    const uint32_t declared = le32(p + 4);
    if (declared > n - 8) e.fail("corrupt WebP: the image chunk is cut short");
    p += 8;
    n -= 8;
    uint8_t* dst = out + (static_cast<size_t>(f.y_offset) * canvas_w + f.x_offset) * 3;
    const size_t stride = static_cast<size_t>(canvas_w) * 3;
    if (lossless) {
      std::vector<uint32_t> argb;
      if (!vp8l_decode(p, n, f.width, f.height, argb)) e.fail("corrupt WebP: bad VP8L data");
      for (int y = 0; y < f.height; y++)
        for (int x = 0; x < f.width; x++) {
          const uint32_t v = argb[static_cast<size_t>(y) * f.width + x];
          uint8_t* o = dst + y * stride + x * 3;
          o[0] = (v >> 16) & 0xff;
          o[1] = (v >> 8) & 0xff;
          o[2] = v & 0xff;
        }
      return;
    }
    VP8Decoder d;
    d.e = &e;
    d.decode(p, n);
    if (d.width != f.width || d.height != f.height) e.fail("corrupt WebP: frame size");
    if (alpha && !alpha_ok(alpha, alpha_size, d.width, d.height))
      e.fail("corrupt WebP: bad ALPH data");
    vp8_to_rgb(d, dst, stride);
  }
};

void write_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// out: height, width (the canvas), frames, lossless (the first frame's).
int webp_info(const uint8_t* data, size_t size, int* out, char* err, int errlen) {
  try {
    WebP w;
    w.e = Err{err, errlen};
    w.data = data;
    w.demux(size);
    out[0] = w.canvas_h;
    out[1] = w.canvas_w;
    out[2] = w.num_frames;
    out[3] = tag(data + w.frames[0].image_offset, "VP8L");
    return WEBP_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    write_error(err, errlen, "WebP decoder: out of memory");
    return WEBP_CORRUPT;
  }
}

// Decodes the first frame onto its canvas, out (height x width x 3 RGB);
// out_size must match.
int webp_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                    int errlen) {
  try {
    WebP w;
    w.e = Err{err, errlen};
    w.data = data;
    w.demux(size);
    if (out_size != static_cast<size_t>(w.canvas_w) * w.canvas_h * 3)
      w.e.fail("output buffer of the wrong size");
    std::memset(out, 0, out_size);
    w.decode_frame(out);
    return WEBP_OK;
  } catch (const Failure& f) {
    return f.code;
  } catch (...) {
    write_error(err, errlen, "WebP decoder: out of memory");
    return WEBP_CORRUPT;
  }
}

}  // extern "C"
