// JPEG decoder of the port's data layer: host C++17, no libjpeg.
//
// It decodes what Pillow's `Image.open(f).convert("RGB")` decodes through
// libjpeg-turbo 3.1's defaults, and gives the same bytes:
//   - baseline and extended-sequential Huffman JPEG, 8-bit, one or several
//     scans; progressive Huffman JPEG (spectral selection, successive
//     approximation, EOB runs); restart intervals;
//   - arithmetic-coded JPEG, sequential (SOF9) and progressive (SOF10): the
//     QM coder of T.81 Annex D as jdarith.c decodes it, with the DAC
//     conditioning (L, U, Kx), statistics reset at each scan and restart,
//     and the DC context from the previous difference's class;
//   - lossless JPEG (SOF3, jdlhuff.c, jddiffct.c, jdlossls.c): predictors
//     1-7, the point transform, the first row and each restart predicted
//     from 2^(7 - Pt), differences of classes 0-16 summed in 16 bits and
//     cut to 8-bit samples; no colour conversion (three components are
//     RGB; YCbCr and YCCK are refused, as libjpeg refuses them) and no fancy
//     upsampling (a lossless data unit is one sample);
//   - 1, 3 and 4 components and any integral ratio of sampling factors;
//   - the ISLOW integer IDCT of jidctint.c, in the 16- and 32-bit
//     arithmetic of libjpeg-turbo's x86 SIMD build (equal to jidctint.c on
//     every valid stream; on a corrupt one it wraps and saturates as the
//     SIMD code does);
//   - block smoothing of a progressive image whose scans leave one of the
//     first nine AC coefficients unfinished (jdcoefct.c smoothing_ok and
//     decompress_smooth_data: estimates from the DC values of the 5 x 5
//     blocks around, into a copy of each block; Pillow decodes in one pass,
//     so the coefficient bits are those after the last scan, or before it
//     for the rows a cut-short last scan left);
//   - libjpeg-turbo's fancy upsampling (jdsample.c): the h2v1 and h2v2
//     triangle filters with their alternating biases where the downsampled
//     row is wider than 2 samples, the h1v2 filter, and replication for
//     every other ratio; the rows past the component's height repeat its
//     last row, as jdmainct.c's context pointers do;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c; grayscale copied
//     into three channels; the colour space chosen as jdapimin.c chooses it
//     (a JFIF APP0 means YCbCr; else an Adobe APP14 transform of 0 means
//     RGB; else component ids 'R','G','B' mean RGB, and so do any ids in a
//     lossless frame); four components as CMYK, or YCCK -> CMYK where the
//     Adobe transform is not 0, then read inverted as Pillow's "CMYK;I" raw
//     mode does and turned into RGB by Pillow's cmyk2rgb.
// EXIF orientation is not applied (Pillow's open does not apply it).
//
// Corrupt entropy-coded data is decoded as libjpeg-turbo decodes it, with
// the warnings Pillow ignores: a bad Huffman code reads 17 bits and gives
// the symbol 0 (jdhuff.c jpeg_huff_decode); a Huffman segment whose data
// ends before its last MCU feeds zero bits to the MCU that ran short and
// leaves the rest of the segment's MCUs unread (insufficient_data; a
// lossless scan's differences are then zero from a reset predictor); the
// arithmetic decoder reads zeros after a marker, and after a bad code
// (a magnitude or spectral overflow) leaves the rest of the segment as it
// is; restart markers out of sequence resynchronise as jdmarker.c
// jpeg_resync_to_restart does.
//
// What Pillow refuses returns JPEG_CORRUPT: a truncated stream, corrupt
// headers, samples of other than 8 bits (Pillow refuses them at open),
// hierarchical JPEG (SOF5-7, SOF13-15, DHP and EXP, which libjpeg-turbo
// refuses), lossless arithmetic coding (SOF11, which it has no decoder
// for), and arithmetic-coded data past the bytes Pillow had handed libjpeg
// (its reads are 65,536 bytes, and jdarith.c cannot suspend for more). The
// message goes into the caller's buffer.
//
// No global mutable state: the loader's threads call it at once.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <vector>

namespace {

constexpr int JPEG_OK = 0;
constexpr int JPEG_CORRUPT = 1;
constexpr int JPEG_TRUNCATED = 3;  // returned as JPEG_CORRUPT

// what jpeg_info reports as the frame's kind (data/jpeg.py KINDS)
constexpr int KIND_LOSSLESS = 3, KIND_ARITH = 4, KIND_ARITH_PROGRESSIVE = 5;

struct Failure {
  int code;
  char msg[200];
};

[[noreturn]] void fail(int code, const char* fmt, ...) {
  Failure f;
  f.code = code;
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(f.msg, sizeof(f.msg), fmt, ap);
  va_end(ap);
  throw f;
}

// zigzag -> natural order, with 16 guard entries for corrupt run lengths
// (jutils.c jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the QM coder's probability estimation states, ITU-T T.81 Table D.2, as
// jaricom.c packs them: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS; state 113 is the fixed estimate of 0.5 (T.851 Table 5)
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

// Pillow hands libjpeg the file in reads of this many bytes
constexpr size_t kRead = 65536;

constexpr int kLookBits = 9;
// Pillow refuses images of more than 2 x Image.MAX_IMAGE_PIXELS pixels
// (DecompressionBombError); so does the decoder, before it allocates
constexpr long kMaxPixels = 2L * 89478485;

struct Huffman {
  bool defined = false;  // by a DHT segment, or the standard table
  bool built = false;    // checked and derived at the first scan that reads it
  uint8_t bits[17];
  uint8_t vals[256];
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
};

// jdhuff.c jpeg_make_d_derived_tbl
void build_huffman(Huffman& h, bool is_dc, int max_dc = 15) {
  const uint8_t* bits = h.bits;
  const uint8_t* vals = h.vals;
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail(JPEG_CORRUPT, "bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      h.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += bits[l];
      h.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  std::memcpy(h.huffval, vals, sizeof(h.huffval));
  std::memset(h.look_len, 0, sizeof(h.look_len));
  std::memset(h.look_val, 0, sizeof(h.look_val));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 1; i <= bits[l]; i++, p++) {
      int lookbits = static_cast<int>(huffcode[p]) << (kLookBits - l);
      for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--) {
        h.look_len[lookbits] = static_cast<uint8_t>(l);
        h.look_val[lookbits] = vals[p];
        lookbits++;
      }
    }
  }
  if (is_dc)
    for (int i = 0; i < numsymbols; i++)
      if (vals[i] > max_dc) fail(JPEG_CORRUPT, "bad DC Huffman table");
  h.built = true;
}

// Entropy-coded data: unstuffs FF00, stops at a marker, after which it
// feeds zero bits as libjpeg does; reading one of those zero bits marks
// the segment short (jdhuff.c jpeg_fill_bit_buffer). Running off the end
// of the file is a truncated file (Pillow's suspending source raises
// there).
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;  // left-aligned
  int bits = 0;
  int zeros = 0;  // zero bits fed after the marker, at the tail of buf
  int marker = 0;  // the marker that ended the segment, 0 if none yet
  bool insufficient = false;  // a zero bit was read: the rest of the segment is skipped
  bool zeros_at_end = false;  // the end of the file feeds zero bits (see Replay)
  bool ff_run_is_marker = false;  // as libjpeg's fast path reads FF FF (see Replay)
  std::vector<int8_t>* reads = nullptr;  // if set: each code's length, each value's -bits

  // one more byte of the segment into buf (a step of jpeg_fill_bit_buffer)
  void load_byte() {
    uint32_t c = 0;
    bool zero = marker != 0;
    if (!zero) {
      if (!ff_run_is_marker)  // FF FF .. 00 is one FF byte to the slow path
        while (pos + 1 < size && data[pos] == 0xFF && data[pos + 1] == 0xFF) pos++;
      if (pos >= size || (data[pos] == 0xFF && pos + 1 >= size)) {
        // the file ends inside a scan: fed as zeros where Replay decides
        // whether libjpeg got this far
        if (!zeros_at_end) fail(JPEG_TRUNCATED, "truncated JPEG: the file ends inside a scan");
        pos = size;
        zero = true;
      } else if (data[pos] != 0xFF) {
        c = data[pos++];
      } else if (data[pos + 1] == 0) {
        c = 0xFF;
        pos += 2;
      } else {
        marker = data[pos + 1];
        pos += 2;
        zero = true;
      }
    }
    if (zero) zeros += 8;
    buf |= static_cast<uint64_t>(c) << (56 - bits);
    bits += 8;
  }
  void fill() {
    while (bits <= 56) {
      if (marker == 0 && pos < size && data[pos] != 0xFF) {  // the common byte
        buf |= static_cast<uint64_t>(data[pos++]) << (56 - bits);
        bits += 8;
      } else {
        load_byte();
      }
    }
  }
  inline uint32_t peek16() {
    if (bits < 16) fill();
    return static_cast<uint32_t>(buf >> 48);
  }
  inline void skip(int n) {
    buf <<= n;
    bits -= n;
    if (bits < zeros) {
      insufficient = true;
      zeros = bits;
    }
  }
  inline int get(int n) {  // n in 0..16
    if (n == 0) return 0;
    if (reads) reads->push_back(static_cast<int8_t>(-n));
    if (bits < n) fill();
    int v = static_cast<int>(buf >> (64 - n));
    skip(n);
    return v;
  }
  inline int bit() { return get(1); }
  inline int decode(const Huffman& h) {
    uint32_t look = peek16();
    int idx = static_cast<int>(look >> (16 - kLookBits));
    int len = h.look_len[idx];
    if (len) {
      if (reads) reads->push_back(static_cast<int8_t>(len));
      skip(len);
      return h.look_val[idx];
    }
    for (int l = kLookBits + 1; l <= 16; l++) {
      int32_t code = static_cast<int32_t>(look >> (16 - l));
      if (code <= h.maxcode[l]) {
        if (reads) reads->push_back(static_cast<int8_t>(l));
        skip(l);
        return h.huffval[(code + h.valoffset[l]) & 0xFF];
      }
    }
    // a bad code: libjpeg warns, drops 17 bits and takes the symbol 0
    if (reads) reads->push_back(17);
    if (bits < 17) fill();
    skip(17);
    return 0;
  }
  void reset() {  // at a restart marker: drop the bits left
    buf = 0;
    bits = 0;
    zeros = 0;
  }
};

// libjpeg-turbo's bit buffer as Pillow drives it, replayed over each MCU's
// reads, for a single-scan image whose entropy-coded data runs to the end
// of the file with no marker after it. Such a file decodes in Pillow if
// libjpeg finishes the scan without asking for a byte past the end, and is
// "truncated" if it asks, which turns on when jdhuff.c refills: the slow
// path (jpeg_fill_bit_buffer) loads bytes until 57 bits are buffered,
// when fewer than 8 are left for a code or fewer than n for n value bits;
// the fast path (decode_mcu_fast), taken where Pillow's buffer still holds
// 512 bytes per block of the MCU and no restart interval is set, loads 6
// bytes whenever 16 bits or fewer are left, and hands an MCU that meets a
// marker back to the slow path. Pillow hands libjpeg the file in reads of
// 65,536 bytes and retries an MCU that ran out of them with the next read.
struct Replay {
  struct OutOfBuffer {};
  const uint8_t* data;
  size_t size;
  size_t pos;         // libjpeg's source position
  size_t bufend;      // the bytes Pillow has handed over
  int left = 0;       // bits_left
  bool marker = false;
  bool fast_marker = false;
  size_t fast_bytes;  // 512 x blocks in an MCU
  bool restarts;
  bool onepass;       // a single-scan image: libjpeg zeroes the MCU before each try
  size_t pos0 = 0;    // the state at the current MCU's start
  int left0 = 0;
  std::vector<int8_t> reads;

  Replay(const uint8_t* d, size_t n, size_t start, int blocks, bool has_restarts, bool single)
      : data(d), size(n), pos(start), fast_bytes(512u * blocks), restarts(has_restarts),
        onepass(single) {
    bufend = kRead;
    while (bufend < start) bufend += kRead;
  }
  int byte() {
    if (pos >= bufend || pos >= size) {
      if (bufend >= size) fail(JPEG_TRUNCATED, "truncated JPEG: the file ends inside a scan");
      throw OutOfBuffer{};
    }
    return data[pos++];
  }
  void fill(int nbits) {  // jpeg_fill_bit_buffer
    if (!marker) {
      while (left < 57) {
        int c = byte();
        if (c == 0xFF) {
          do c = byte();
          while (c == 0xFF);
          if (c != 0) {
            marker = true;
            break;
          }
        }
        left += 8;
      }
      if (!marker) return;
    }
    if (nbits > left) left = 57;  // zeros
  }
  void slow(int r) {
    if (r < 0) {  // value bits
      if (left < -r) fill(-r);
      left += r;
      return;
    }
    if (left < 8) {  // HUFF_DECODE: too few bits for the lookahead
      fill(0);
      if (left < 8) {
        for (int i = 0; i < r; i++) {
          if (left < 1) fill(1);
          left--;
        }
        return;
      }
    }
    if (r <= 8) {
      left -= r;
      return;
    }
    if (left < 9) fill(9);  // jpeg_huff_decode from 9 bits, then one at a time
    left -= 9;
    for (int i = 9; i < r; i++) {
      if (left < 1) fill(1);
      left--;
    }
  }
  void fast_fill() {  // FILL_BIT_BUFFER_FAST: 6 x GET_BYTE
    for (int i = 0; i < 6; i++) {
      int c0 = data[pos], c1 = data[pos + 1];
      pos++;
      left += 8;
      if (c0 == 0xFF) {
        pos++;
        if (c1 != 0) {
          fast_marker = true;
          pos -= 2;
        }
      }
    }
  }
  // after a restart: the bit buffer emptied, the reader at the position
  // after the marker it read (Pillow's reads extended to reach it)
  void restart(size_t reader_pos, bool marker_kept) {
    left = 0;
    pos = reader_pos;
    marker = marker_kept;
    while (bufend < pos) bufend += kRead;
  }
  // jdhuff.c decode_mcu over this MCU's reads. The fast path takes FF FF
  // for a marker where the slow path reads FF FF .. 00 as an FF byte; an
  // MCU whose fast try meets one is decoded again by the slow path over
  // the coefficients the fast try wrote. Returns whether the MCU keeps
  // them: its last try (a single-scan image) or any try did so.
  bool mcu() {
    pos0 = pos;
    left0 = left;
    bool keep_fast = false;
    for (;;) {
      bool marker0 = marker;
      try {
        if (onepass) keep_fast = false;
        if (!restarts && !marker && std::min(bufend, size) - pos >= fast_bytes) {
          fast_marker = false;
          for (int8_t r : reads) {
            if (left <= 16) fast_fill();
            left -= r < 0 ? -r : r;
          }
          if (!fast_marker) break;
          keep_fast = true;
          pos = pos0;
          left = left0;
        }
        for (int8_t r : reads) slow(r);
        break;
      } catch (const OutOfBuffer&) {  // Pillow reads on and libjpeg tries the MCU again
        pos = pos0;
        left = left0;
        marker = marker0;
        bufend += kRead;
      }
    }
    reads.clear();
    return keep_fast;
  }
};

// the standard tables of the JPEG standard, section K.3 (jstdhuff.c)
struct StdTable {
  uint8_t bits[17];
  uint8_t vals[162];
};
const StdTable kStdDc[2] = {
    {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0}, {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}},
    {{0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}, {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}}};
const StdTable kStdAc[2] = {
    {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
     {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
      0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
      0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
      0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
      0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
      0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
      0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
      0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
      0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
      0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
      0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
      0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}},
    {{0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77},
     {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
      0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
      0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
      0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
      0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
      0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
      0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
      0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
      0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
      0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
      0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
      0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}}};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int dw, dh;            // downsampled size in samples
  int bw, bh;            // blocks with data (ceil of dw, dh over 8)
  int bstride, brows;    // allocated blocks (whole MCUs)
  std::vector<int16_t> coef;  // bstride * brows * 64
  std::vector<uint8_t> samples;  // lossless: dh rows of dw samples
  uint16_t quant[64];
  bool latched = false;
  bool scanned = false;  // by a scan
  int dc_table = 0, ac_table = 0;
  int coef_bits[64];  // progressive: the Al of each coefficient's last scan, -1 before
  int prev_bits[64];  // ... and before that scan (jdphuff.c, jdarith.c start_pass)
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bstride + bx) * 64;
  }
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;

  bool have_frame = false, progressive = false, arith = false, lossless = false;
  int kind = 0;  // 0 baseline, 1 extended sequential, 2 progressive, KIND_*
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcusx = 0, mcusy = 0;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int scans = 0;
  bool multiscan = false;
  // the conditioning of each arithmetic-coding table (DAC; reset at SOI)
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  // the bytes Pillow has handed libjpeg: it reads on where libjpeg suspends,
  // which jdarith.c cannot do (JERR_CANT_SUSPEND)
  size_t handed = kRead;
  // the last iMCU row of the last scan that began with data left
  // (jdcoefct.c consume_data's last_good_iMCU_row)
  int last_good_imcu = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {
    std::memset(dac_l, 0, sizeof(dac_l));
    std::memset(dac_u, 1, sizeof(dac_u));
    std::memset(dac_k, 5, sizeof(dac_k));
  }

  int byte() {
    if (pos >= size) fail(JPEG_TRUNCATED, "truncated JPEG: the file ends inside its headers");
    return data[pos++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }
  // the next marker code, skipping stray bytes and fill bytes (jdmarker.c next_marker)
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  // a marker segment's payload: [start, start + len); a length under 2
  // reads as 0 where libjpeg skips the segment (skipped), else it is an
  // error. Before the first scan the segment must be whole (Pillow's own
  // parser reads it); after it libjpeg reads it as it goes: at() fails
  // where the file ends.
  size_t segment(int& len, bool skipped = false) {
    len = u16() - 2;
    if (len < 0) {
      if (!skipped) fail(JPEG_CORRUPT, "corrupt JPEG: bad marker length");
      len = 0;
    }
    if (scans == 0 && pos + static_cast<size_t>(len) > size)
      fail(JPEG_TRUNCATED, "truncated JPEG: the file ends inside a marker segment");
    size_t start = pos;
    pos += len;
    return start;
  }
  int at(size_t i) const {
    if (i >= size) fail(JPEG_TRUNCATED, "truncated JPEG: the file ends inside a marker segment");
    return data[i];
  }

  // jdmarker.c get_dqt: any precision but 0 is 16-bit
  void read_dqt() {
    int len;
    size_t p = segment(len);
    long length = len;
    while (length > 0) {
      int n = at(p++);
      int prec = n >> 4;
      n &= 15;
      if (n > 3) fail(JPEG_CORRUPT, "corrupt JPEG: quantization table %d", n);
      for (int i = 0; i < 64; i++) {
        int q = prec ? (at(p) << 8) | at(p + 1) : at(p);
        p += prec ? 2 : 1;
        qt[n][kNatural[i]] = static_cast<uint16_t>(q);
      }
      qt_defined[n] = true;
      length -= prec ? 129 : 65;
    }
    if (length != 0) fail(JPEG_CORRUPT, "corrupt JPEG: bad quantization table length");
  }

  // jdmarker.c get_dht
  void read_dht() {
    int len;
    size_t p = segment(len);
    long length = len;
    while (length > 16) {
      int index = at(p++);
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = static_cast<uint8_t>(at(p++));
        count += bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) fail(JPEG_CORRUPT, "corrupt JPEG: bad Huffman table");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; i++) vals[i] = static_cast<uint8_t>(at(p++));
      length -= count;
      bool is_ac = index & 0x10;
      int th = is_ac ? index - 0x10 : index;
      if (th > 3) fail(JPEG_CORRUPT, "corrupt JPEG: Huffman table index 0x%02X", index);
      // checked and derived when a scan reads it, as jdhuff.c does
      Huffman& h = is_ac ? ac[th] : dc[th];
      std::memcpy(h.bits, bits, sizeof(h.bits));
      std::memcpy(h.vals, vals, sizeof(h.vals));
      h.defined = true;
      h.built = false;
    }
    if (length != 0) fail(JPEG_CORRUPT, "corrupt JPEG: bad Huffman table length");
  }

  void read_app(int code) {
    int len;
    size_t p = segment(len, true);
    if (scans) return;  // the colour space is settled
    if (code == 0xE0 && len >= 14 && std::memcmp(data + p, "JFIF\0", 5) == 0) saw_jfif = true;
    if (code == 0xEE && len >= 12 && std::memcmp(data + p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = data[p + 11];
    }
  }

  void read_sof(int code) {
    int len;
    size_t p = segment(len);
    if (len < 6) fail(JPEG_CORRUPT, "corrupt JPEG: short frame header");
    int precision = data[p];
    height = (data[p + 1] << 8) | data[p + 2];
    width = (data[p + 3] << 8) | data[p + 4];
    ncomp = data[p + 5];
    progressive = code == 0xC2 || code == 0xCA;
    arith = code >= 0xC9;
    lossless = code == 0xC3;
    kind = code <= 0xC2 ? code - 0xC0
                        : (lossless ? KIND_LOSSLESS : (progressive ? KIND_ARITH_PROGRESSIVE : KIND_ARITH));
    // Pillow reads the precision of every SOFn at open and refuses all but 8
    if (precision != 8) fail(JPEG_CORRUPT, "a JPEG of %d-bit samples: Pillow reads 8", precision);
    if (code == 0xCB)  // libjpeg-turbo has no lossless arithmetic decoder
      fail(JPEG_CORRUPT, "a lossless arithmetic-coded JPEG (SOF11): libjpeg refuses it");
    if ((code > 0xC3 && code < 0xC9) || code > 0xCB)  // SOF5-7, SOF13-15: differential frames
      fail(JPEG_CORRUPT, "a hierarchical JPEG (SOF%d): libjpeg refuses it", code - 0xC0);
    if (height == 0)
      fail(JPEG_CORRUPT, "a JPEG whose height comes in a DNL marker (libjpeg refuses it too)");
    if (width == 0 || ncomp == 0) fail(JPEG_CORRUPT, "corrupt JPEG: an empty image");
    if (static_cast<long>(width) * height > kMaxPixels)
      fail(JPEG_CORRUPT, "a JPEG of %d x %d pixels: over Pillow's decompression-bomb limit",
           width, height);
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(JPEG_CORRUPT, "a JPEG of %d components: Pillow reads 1, 3 or 4", ncomp);
    if (len < 6 + 3 * ncomp) fail(JPEG_CORRUPT, "corrupt JPEG: short frame header");
    comps.resize(ncomp);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comps[i];
      c.id = data[p + 6 + 3 * i];
      c.h = data[p + 7 + 3 * i] >> 4;
      c.v = data[p + 7 + 3 * i] & 15;
      c.tq = data[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail(JPEG_CORRUPT, "corrupt JPEG: sampling factors %dx%d", c.h, c.v);
      if (c.tq > 3) fail(JPEG_CORRUPT, "corrupt JPEG: quantization table %d", c.tq);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    // the data unit: an 8 x 8 block, or one sample of a lossless frame
    const int du = lossless ? 1 : 8;
    mcusx = (width + du * hmax - 1) / (du * hmax);
    mcusy = (height + du * vmax - 1) / (du * vmax);
    have_frame = true;
  }

  void allocate() {
    for (Component& c : comps) {
      c.dw = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bstride = mcusx * c.h;
      c.brows = mcusy * c.v;
      if (lossless)
        c.samples.assign(static_cast<size_t>(c.dw) * c.dh, 0);
      else
        c.coef.assign(static_cast<size_t>(c.bstride) * c.brows * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = c.prev_bits[k] = -1;
    }
  }

  // the header up to the frame: enough for jpeg_info
  void read_header() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(JPEG_CORRUPT, "not a JPEG file");
    pos = 2;
    while (!have_frame) handle_marker(next_marker());
  }

  // returns false at EOI
  bool handle_marker(int code) {
    bool sof = code >= 0xC0 && code <= 0xCF && code != 0xC4 && code != 0xC8 && code != 0xCC;
    if (sof && have_frame) fail(JPEG_CORRUPT, "corrupt JPEG: a second frame header");
    switch (code) {
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        read_sof(code);
        return true;
      case 0xDE: case 0xDF:  // DHP, EXP: libjpeg reads them as unknown markers
        fail(JPEG_CORRUPT, "a hierarchical JPEG (marker 0x%02X): libjpeg refuses it", code);
      case 0xC4:
        read_dht();
        return true;
      case 0xDB:
        read_dqt();
        return true;
      case 0xDD: {
        int len;
        size_t p = segment(len);
        if (len != 2) fail(JPEG_CORRUPT, "corrupt JPEG: bad DRI length");
        restart_interval = (at(p) << 8) | at(p + 1);
        return true;
      }
      case 0xDA:
        read_scan();
        return true;
      case 0xD9:
        return false;
      case 0xD8:
        fail(JPEG_CORRUPT, "corrupt JPEG: a second SOI");
      case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
      case 0xD6: case 0xD7:
        return true;  // standalone markers
      default:
        if ((code >= 0xE0 && code <= 0xEF)) {
          read_app(code);
          return true;
        }
        if (code == 0xFE || code == 0xDC) {  // COM, and DNL: skipped as libjpeg does
          int len;
          segment(len, true);
          return true;
        }
        if (code == 0xCC) {  // DAC (jdmarker.c get_dac)
          int len;
          size_t p = segment(len);
          long length = len;
          while (length > 0) {
            int index = at(p++), val = at(p++);
            length -= 2;
            if (index > 31 || (index < 16 && (val & 15) > (val >> 4)))
              fail(JPEG_CORRUPT, "corrupt JPEG: bad arithmetic-coding table");
            if (index >= 16) {
              dac_k[index - 16] = static_cast<uint8_t>(val);
            } else {
              dac_l[index] = static_cast<uint8_t>(val & 15);
              dac_u[index] = static_cast<uint8_t>(val >> 4);
            }
          }
          if (length != 0) fail(JPEG_CORRUPT, "corrupt JPEG: bad DAC length");
          return true;
        }
        fail(JPEG_CORRUPT, "corrupt JPEG: unknown marker 0x%02X", code);
    }
  }

  // --- scans ---------------------------------------------------------------

  Component* scomp[4];
  int ns = 0, ss = 0, se = 0, ah = 0, al = 0;
  int eobrun = 0;
  int pred[4];
  int mcu_pred[4];  // pred at the current MCU's start

  void need_table(Huffman& h, int slot, bool is_dc) {
    if (!h.defined) {  // jdphuff.c sets no standard tables
      if (slot > 1 || progressive) fail(JPEG_CORRUPT, "corrupt JPEG: undefined Huffman table");
      const StdTable& t = is_dc ? kStdDc[slot] : kStdAc[slot];
      std::memcpy(h.bits, t.bits, sizeof(h.bits));
      std::memset(h.vals, 0, sizeof(h.vals));
      std::memcpy(h.vals, t.vals, sizeof(t.vals));
      h.defined = true;
    }
    if (!h.built) build_huffman(h, is_dc, lossless ? 16 : 15);
  }

  void read_scan() {
    if (!have_frame) fail(JPEG_CORRUPT, "corrupt JPEG: a scan before the frame header");
    int len;
    size_t p = segment(len);  // jdmarker.c get_sos
    ns = len < 1 ? 0 : at(p);
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail(JPEG_CORRUPT, "corrupt JPEG: bad scan header");
    for (int i = 0; i < ns; i++) {
      int cid = at(p + 1 + 2 * i);
      int tables = at(p + 2 + 2 * i);
      Component* found = nullptr;  // the first of that id not yet in the scan
      for (Component& c : comps) {
        bool taken = false;
        for (int j = 0; j < i; j++) taken |= scomp[j] == &c;
        if (c.id == cid && !taken) {
          found = &c;
          break;
        }
      }
      if (!found) fail(JPEG_CORRUPT, "corrupt JPEG: a scan of unknown component %d", cid);
      found->dc_table = tables >> 4;
      found->ac_table = tables & 15;
      found->scanned = true;
      scomp[i] = found;
    }
    ss = at(p + 1 + 2 * ns);
    se = at(p + 2 + 2 * ns);
    ah = at(p + 3 + 2 * ns) >> 4;
    al = at(p + 3 + 2 * ns) & 15;
    // jdinput.c: a second scan where the first held every component of a
    // sequential frame
    if (scans > 0 && !multiscan)
      fail(JPEG_CORRUPT, "corrupt JPEG: a second scan where EOI was expected");
    if (scans == 0) allocate();
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += scomp[i]->h * scomp[i]->v;
      if (blocks > 10) fail(JPEG_CORRUPT, "corrupt JPEG: more than 10 blocks in an MCU");
    }
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (se < ss || se > 63 || ns != 1) bad = true;
      }
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) fail(JPEG_CORRUPT, "corrupt JPEG: bad progression parameters");
      for (int i = 0; i < ns; i++) {
        Component& c = *scomp[i];
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          c.prev_bits[k] = scans > 0 ? c.coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
      }
    }
    // jdlossls.c start_pass_lossless: Ss is the predictor, Al the point transform
    if (lossless && (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7))
      fail(JPEG_CORRUPT, "corrupt JPEG: bad lossless scan parameters");
    // quantization tables latch at a component's first scan (jdinput.c), but
    // for a lossless frame, which has none
    for (int i = 0; i < ns && !lossless; i++) {
      Component& c = *scomp[i];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail(JPEG_CORRUPT, "corrupt JPEG: undefined quantization table");
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.latched = true;
      }
    }
    // the tables this scan reads must exist; slots 0 and 1 default to the
    // standard tables, as libjpeg-turbo's std_huff_tables sets them for
    // Motion-JPEG streams that omit them
    for (int i = 0; i < ns && !arith; i++) {
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !lossless && (!progressive || ss > 0);
      int dct = scomp[i]->dc_table, act = scomp[i]->ac_table;
      if ((need_dc && dct > 3) || (need_ac && act > 3))
        fail(JPEG_CORRUPT, "corrupt JPEG: Huffman table index");
      if (need_dc) need_table(dc[dct], dct, true);
      if (need_ac) need_table(ac[act], act, false);
    }
    if (scans == 0) multiscan = progressive || ns < ncomp;
    if (arith)
      decode_scan_arith();
    else if (lossless)
      decode_scan_lossless();
    else
      decode_scan();
    scans++;
  }

  // from position p: whether a marker other than RSTn ends the
  // entropy-coded data, and whether the data holds FF FF .. 00
  void scan_data(size_t p, bool& marker_follows, bool& ff_runs) const {
    marker_follows = ff_runs = false;
    for (;;) {
      const void* ff = std::memchr(data + p, 0xFF, size - p);
      if (!ff) return;
      p = static_cast<const uint8_t*>(ff) - data + 1;
      bool run = false;
      for (; p < size && data[p] == 0xFF; p++) run = true;
      if (p >= size) return;
      int c = data[p++];
      if (c == 0) {
        ff_runs |= run;
      } else if (c < 0xD0 || c > 0xD7) {
        marker_follows = true;
        return;
      }
    }
  }

  // What libjpeg's fast path wrote into an MCU it met FF FF in (Replay):
  // the MCU decoded again from its start, libjpeg's bit buffer there
  // (Replay's pos0 and left0), reading FF FF as a marker; it fills the
  // coefficients the slow decode left at zero.
  template <typename EachBlock>
  void fast_path_writes(const BitReader& start, const Replay& rp, EachBlock each_block) {
    BitReader fr = start;
    fr.reads = nullptr;
    fr.marker = 0;
    fr.zeros = 0;
    if (fr.bits >= rp.left0) {
      fr.buf = rp.left0 ? fr.buf & (~uint64_t{0} << (64 - rp.left0)) : 0;
      fr.bits = rp.left0;
      fr.pos = rp.pos0;
    } else {
      while (fr.pos < rp.pos0) fr.load_byte();
    }
    fr.ff_run_is_marker = true;
    int saved[4];
    std::memcpy(saved, pred, sizeof(saved));
    std::memcpy(pred, mcu_pred, sizeof(saved));
    each_block([&](Component& c, int ci, int16_t* blk) {
      int16_t fast[64] = {0};
      decode_block(fr, c, ci, fast);
      for (int k = 1; k < 64; k++)
        if (blk[k] == 0) blk[k] = fast[k];
    });
    std::memcpy(pred, saved, sizeof(saved));
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart, from the
  // marker the entropy decoder met (0 if none) and the data at p, which
  // ends at limit (failing with code there): a marker other than the
  // expected RSTn is skipped (a marker below SOF0, or one of the two RSTn
  // before it), kept for the next segment, which then reads as empty (any
  // other marker, or one of the two RSTn after it), or taken as the
  // expected one. Returns the marker kept, 0 if none.
  int read_restart(int marker, size_t& p, size_t limit, int next_rst, int code) {
    auto next_marker_in_data = [&]() {  // jdmarker.c next_marker
      for (;;) {
        if (p >= limit) fail(code, "truncated JPEG: a missing restart marker");
        int c = data[p++];
        if (c != 0xFF) continue;
        int c2;
        do {
          if (p >= limit) fail(code, "truncated JPEG: a missing restart marker");
          c2 = data[p++];
        } while (c2 == 0xFF);
        if (c2 != 0) return c2;
      }
    };
    if (marker == 0) marker = next_marker_in_data();
    int want = 0xD0 + next_rst;
    while (marker != 0 && marker != want) {
      int m = marker;
      bool rst = m >= 0xD0 && m <= 0xD7;
      if (rst && (m == 0xD0 + ((next_rst + 1) & 7) || m == 0xD0 + ((next_rst + 2) & 7)))
        break;  // kept
      if (m < 0xC0 ||
          (rst && (m == 0xD0 + ((next_rst + 7) & 7) || m == 0xD0 + ((next_rst + 6) & 7)))) {
        marker = next_marker_in_data();  // skipped
        continue;
      }
      if (!rst) break;  // kept
      marker = want;  // too far away: taken as the expected one
    }
    return marker == want ? 0 : marker;
  }

  void decode_scan() {
    BitReader br{data, size, pos};
    // Replay follows libjpeg's bit buffer where it shows: a single-scan
    // image whose data runs to the end of the file (where Pillow calls it
    // truncated), and a sequential scan whose data holds FF FF .. 00 (which
    // libjpeg's fast path reads otherwise)
    std::unique_ptr<Replay> replay;
    bool marker_follows, ff_runs;
    scan_data(pos, marker_follows, ff_runs);
    bool to_the_end = !multiscan && !marker_follows;
    if (to_the_end || (!progressive && ff_runs && restart_interval == 0)) {
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += ns > 1 ? scomp[i]->h * scomp[i]->v : 1;
      replay = std::make_unique<Replay>(data, size, pos, blocks, restart_interval != 0,
                                        !multiscan);
      br.zeros_at_end = to_the_end;
      br.reads = &replay->reads;
    }
    // one MCU: each_block(fn) calls fn(component, index in the scan, block)
    auto mcu = [&](int imcu_row, auto each_block) {
      if (br.insufficient) return;  // the MCU stays as it was
      last_good_imcu = imcu_row;
      BitReader start;
      if (replay) {
        start = br;
        std::memcpy(mcu_pred, pred, sizeof(mcu_pred));
      }
      each_block([&](Component& c, int ci, int16_t* blk) { decode_block(br, c, ci, blk); });
      if (replay && replay->mcu()) fast_path_writes(start, *replay, each_block);
    };
    for (int i = 0; i < 4; i++) pred[i] = 0;
    eobrun = 0;
    int restarts_left = restart_interval;
    int next_rst = 0;
    // jdhuff.c process_restart
    auto restart = [&]() {
      br.reset();
      br.marker = read_restart(br.marker, br.pos, size, next_rst, JPEG_TRUNCATED);
      if (replay) replay->restart(br.pos, br.marker != 0);
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < 4; i++) pred[i] = 0;
      eobrun = 0;
      restarts_left = restart_interval;
      if (br.marker == 0) br.insufficient = false;
    };

    if (ns == 1) {
      Component& c = *scomp[0];
      for (int by = 0; by < c.bh; by++) {
        for (int bx = 0; bx < c.bw; bx++) {
          if (restart_interval) {
            if (restarts_left == 0) restart();
            restarts_left--;
          }
          mcu(by / c.v, [&](auto fn) { fn(c, 0, c.block(bx, by)); });
        }
      }
    } else {
      for (int my = 0; my < mcusy; my++) {
        for (int mx = 0; mx < mcusx; mx++) {
          if (restart_interval) {
            if (restarts_left == 0) restart();
            restarts_left--;
          }
          mcu(my, [&](auto fn) {
            for (int i = 0; i < ns; i++) {
              Component& c = *scomp[i];
              for (int y = 0; y < c.v; y++)
                for (int x = 0; x < c.h; x++) fn(c, i, c.block(mx * c.h + x, my * c.v + y));
            }
          });
        }
      }
    }
    // the position after the scan's data: at its ending marker, if read
    pos = br.pos;
    if (br.marker != 0) pos -= 2;  // let the marker loop read it again
  }

  // the DC predictor: it wraps in sequential mode, where only its low 16
  // bits reach the block (jdhuff.c); a progressive scan that overflows it
  // is an error (jdphuff.c JERR_BAD_DCT_COEF)
  void add_dc(int ci, int diff) {
    if (progressive && ((pred[ci] >= 0 && diff > INT32_MAX - pred[ci]) ||
                        (pred[ci] < 0 && diff < INT32_MIN - pred[ci])))
      fail(JPEG_CORRUPT, "corrupt JPEG data: DC coefficient out of range");
    pred[ci] = static_cast<int32_t>(static_cast<uint32_t>(pred[ci]) + static_cast<uint32_t>(diff));
  }

  void decode_block(BitReader& br, Component& c, int ci, int16_t* blk) {
    if (!progressive) {
      const Huffman& dct = dc[c.dc_table];
      const Huffman& act = ac[c.ac_table];
      int s = br.decode(dct);
      if (s) s = extend(br.get(s), s);
      add_dc(ci, s);
      blk[0] = static_cast<int16_t>(pred[ci]);
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {
      if (ah == 0) {
        int s = br.decode(dc[c.dc_table]);
        if (s) s = extend(br.get(s), s);
        add_dc(ci, s);
        blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred[ci]) << al);
      } else if (br.bit()) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    if (ah == 0) {  // AC first
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      const Huffman& act = ac[c.ac_table];
      for (int k = ss; k <= se; k++) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(br.get(s), s)) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      const Huffman& act = ac[c.ac_table];
      for (; k <= se; k++) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit()) {
              if ((*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit()) {
          if ((*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
      }
      eobrun--;
    }
  }

  // --- arithmetic-coded scans (jdarith.c) --------------------------------

  // the QM decoder over a scan's data: it reads a byte only when it needs
  // one, and once it meets a marker it reads zeros
  struct Arith {
    const uint8_t* data;
    size_t limit;  // the end of what Pillow has handed libjpeg
    size_t pos;
    int marker = 0;
    int64_t c = 0, a = 0;
    int ct = -16;  // -16: 2 bytes to read first; -1: a bad code left the segment

    int byte() {  // libjpeg cannot suspend here: past the bytes handed over is an error
      if (pos >= limit)
        fail(JPEG_CORRUPT, "arithmetic-coded data past the bytes Pillow had handed libjpeg");
      return data[pos++];
    }
    int decode(uint8_t* st) {  // arith_decode
      while (a < 0x8000) {  // D.2.6: renormalise, reading bytes
        if (--ct < 0) {
          int d = 0;
          if (!marker) {
            d = byte();
            if (d == 0xFF) {
              do d = byte();
              while (d == 0xFF);
              if (d == 0) {
                d = 0xFF;
              } else {
                marker = d;
                d = 0;
              }
            }
          }
          c = (c << 8) | d;
          if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the 2 bytes read
        }
        a <<= 1;
      }
      int sv = *st;
      uint32_t qe = kAritab[sv & 0x7F];
      int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
      qe >>= 16;
      int64_t temp = a - qe;  // D.2.4 and D.2.5
      a = temp;
      temp <<= ct;
      if (c >= temp) {
        c -= temp;
        if (a < qe) {  // conditional exchange
          a = qe;
          *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
        } else {
          a = qe;
          *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
          sv ^= 0x80;
        }
      } else if (a < 0x8000) {
        if (a < qe) {
          *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
          sv ^= 0x80;
        } else {
          *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
        }
      }
      return sv >> 7;
    }
    void reset() {
      c = a = 0;
      ct = -16;
    }
  };

  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};  // the fixed estimate of 0.5
  int dc_context[4];

  // a DC difference (F.1.4.4.1, Figures F.19-F.24); false on a bad code
  bool arith_dc_diff(Arith& ar, int tbl, int ci, int& v) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    v = 0;
    if (ar.decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {  // magnitude overflow
          ar.ct = -1;
          return false;
        }
        st++;
      }
    }
    if (m < static_cast<int>((1L << dac_l[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > static_cast<int>((1L << dac_u[tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // AC coefficients k0..k1 (F.1.4.4.2, G.1.3.2), shifted left by shift
  bool arith_ac(Arith& ar, int tbl, int k0, int k1, int shift, int16_t* blk) {
    for (int k = k0; k <= k1; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) {  // spectral overflow
          ar.ct = -1;
          return false;
        }
      }
      int sign = ar.decode(fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= dac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {  // magnitude overflow
            ar.ct = -1;
            return false;
          }
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << shift);
    }
    return true;
  }

  // one block of an arithmetic-coded scan; false on a bad code
  bool decode_block_arith(Arith& ar, Component& c, int ci, int16_t* blk) {
    int v;
    if (!progressive || (ss == 0 && ah == 0)) {
      if (!arith_dc_diff(ar, c.dc_table, ci, v)) return false;
      pred[ci] = (pred[ci] + v) & 0xFFFF;
      blk[0] = static_cast<int16_t>(static_cast<uint32_t>(pred[ci]) << (progressive ? al : 0));
      return progressive || arith_ac(ar, c.ac_table, 1, 63, 0, blk);
    }
    if (ss == 0) {  // DC refinement: the next bit, at the fixed estimate
      if (ar.decode(fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      return true;
    }
    if (ah == 0) return arith_ac(ar, c.ac_table, ss, se, al, blk);
    // AC refinement (decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = -p1;
    const int tbl = c.ac_table;
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ar.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = static_cast<int16_t>(ar.decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {  // spectral overflow
          ar.ct = -1;
          return false;
        }
      }
    }
    return true;
  }

  void decode_scan_arith() {
    // libjpeg reads this scan's data from what Pillow handed it while it
    // read the markers up to here, in reads of kRead bytes
    handed = std::max(handed, (pos + kRead - 1) / kRead * kRead);
    Arith ar{data, std::min(handed, size), pos};
    auto reset_stats = [&]() {  // at the scan's start and at each restart
      for (int i = 0; i < ns; i++) {
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(dc_stats[scomp[i]->dc_table], 0, sizeof(dc_stats[0]));
          pred[i] = dc_context[i] = 0;
        }
        if (!progressive || ss) std::memset(ac_stats[scomp[i]->ac_table], 0, sizeof(ac_stats[0]));
      }
    };
    reset_stats();
    int restarts_left = restart_interval, next_rst = 0;
    auto start_mcu = [&](int imcu_row) {
      if (restart_interval) {
        if (restarts_left == 0) {
          ar.marker = read_restart(ar.marker, ar.pos, ar.limit, next_rst, JPEG_CORRUPT);
          next_rst = (next_rst + 1) & 7;
          reset_stats();
          ar.reset();
          restarts_left = restart_interval;
        }
        restarts_left--;
      }
      last_good_imcu = imcu_row;
      return ar.ct != -1;  // after a bad code, the segment's MCUs stay as they are
    };
    if (ns == 1) {
      Component& c = *scomp[0];
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          if (start_mcu(by / c.v)) decode_block_arith(ar, c, 0, c.block(bx, by));
    } else {
      for (int my = 0; my < mcusy; my++) {
        for (int mx = 0; mx < mcusx; mx++) {
          if (!start_mcu(my)) continue;
          bool ok = true;
          for (int i = 0; i < ns && ok; i++) {
            Component& c = *scomp[i];
            for (int y = 0; y < c.v && ok; y++)
              for (int x = 0; x < c.h && ok; x++)
                ok = decode_block_arith(ar, c, i, c.block(mx * c.h + x, my * c.v + y));
          }
        }
      }
    }
    pos = ar.pos;
    if (ar.marker != 0) pos -= 2;
  }

  // --- lossless scans (jdlhuff.c, jddiffct.c, jdlossls.c) -------------------

  void decode_scan_lossless() {
    BitReader br{data, size, pos};
    std::unique_ptr<Replay> replay;
    bool marker_follows, ff_runs;
    scan_data(pos, marker_follows, ff_runs);
    const bool inter = ns > 1;
    if (!multiscan && !marker_follows) {  // see decode_scan; jdlhuff.c has no fast path
      int samples = 0;
      for (int i = 0; i < ns; i++) samples += inter ? scomp[i]->h * scomp[i]->v : 1;
      replay = std::make_unique<Replay>(data, size, pos, samples, true, true);
      br.zeros_at_end = true;
      br.reads = &replay->reads;
    }
    const int per_row = inter ? mcusx : scomp[0]->dw;  // MCUs in an MCU row
    if (restart_interval % per_row)
      fail(JPEG_CORRUPT, "corrupt JPEG: a lossless restart interval of %d MCUs in rows of %d",
           restart_interval, per_row);
    const int rows_per_restart = restart_interval / per_row;
    const int init = 1 << (8 - al - 1);
    // each scan component's differences of one iMCU row, and its last
    // undifferenced row; first[] is jdlossls.c's undifference_first_row,
    // set for every component at the scan's start and at each restart
    std::vector<int> diff[4], prev[4], cur[4];
    bool first[4] = {true, true, true, true};
    for (int i = 0; i < ns; i++) {
      Component& c = *scomp[i];
      diff[i].assign(static_cast<size_t>(c.v) * std::max(mcusx * c.h, c.dw), 0);
      prev[i].assign(c.dw, 0);
      cur[i].assign(c.dw, 0);
    }
    auto comp_index = [&](const Component* c) { return static_cast<int>(c - comps.data()); };
    auto decode_diff = [&](const Huffman& h) {
      int s = br.decode(h);
      if (s == 0) return 0;
      if (s == 16) return 32768;
      return extend(br.get(s), s);
    };
    int rows_left = rows_per_restart, next_rst = 0;
    for (int r0 = 0; r0 < mcusy; r0++) {
      const Component& c0 = *scomp[0];
      int last_rows = c0.dh % c0.v ? c0.dh % c0.v : c0.v;
      int mcu_rows = inter ? 1 : (r0 < mcusy - 1 ? c0.v : last_rows);
      for (int y = 0; y < mcu_rows; y++) {
        if (restart_interval) {
          if (rows_left == 0) {
            br.reset();
            br.marker = read_restart(br.marker, br.pos, size, next_rst, JPEG_TRUNCATED);
            if (replay) replay->restart(br.pos, br.marker != 0);
            next_rst = (next_rst + 1) & 7;
            if (br.marker == 0) br.insufficient = false;
            for (int k = 0; k < 4; k++) first[k] = true;
            rows_left = rows_per_restart;
          }
        }
        if (br.insufficient) {  // out of data: zero differences from the predictor reset
          for (int i = 0; i < ns; i++) {
            size_t stride = diff[i].size() / scomp[i]->v;
            if (inter)
              std::fill(diff[i].begin(), diff[i].end(), 0);
            else
              std::fill(diff[i].begin() + y * stride, diff[i].begin() + (y + 1) * stride, 0);
          }
          for (int k = 0; k < 4; k++) first[k] = true;
        } else {
          for (int mx = 0; mx < per_row; mx++) {
            if (inter) {
              for (int i = 0; i < ns; i++) {
                const Component& c = *scomp[i];
                size_t stride = diff[i].size() / c.v;
                for (int yy = 0; yy < c.v; yy++)
                  for (int xx = 0; xx < c.h; xx++)
                    diff[i][yy * stride + mx * c.h + xx] = decode_diff(dc[c.dc_table]);
              }
            } else {
              diff[0][y * (diff[0].size() / c0.v) + mx] = decode_diff(dc[c0.dc_table]);
            }
            if (replay) replay->mcu();
          }
        }
        if (restart_interval) rows_left--;
      }
      // undifference and scale each row of the iMCU row
      for (int i = 0; i < ns; i++) {
        Component& c = *scomp[i];
        const int ci = comp_index(&c), w = c.dw;
        const size_t stride = diff[i].size() / c.v;
        int rows = r0 < mcusy - 1 ? c.v : (c.dh % c.v ? c.dh % c.v : c.v);
        for (int r = 0; r < rows; r++) {
          const int* d = diff[i].data() + r * stride;
          const int* up = prev[i].data();
          int* out = cur[i].data();
          if (first[ci]) {
            int ra = (d[0] + init) & 0xFFFF;
            out[0] = ra;
            for (int x = 1; x < w; x++) out[x] = ra = (d[x] + ra) & 0xFFFF;
            first[ci] = false;
          } else {
            int rb = up[0], ra = (d[0] + rb) & 0xFFFF;
            out[0] = ra;
            for (int x = 1; x < w; x++) {
              int rc = rb;
              rb = up[x];
              int p;
              switch (ss) {
                case 1: p = ra; break;
                case 2: p = rb; break;
                case 3: p = rc; break;
                case 4: p = ra + rb - rc; break;
                case 5: p = ra + ((rb - rc) >> 1); break;
                case 6: p = rb + ((ra - rc) >> 1); break;
                default: p = (ra + rb) >> 1; break;
              }
              out[x] = ra = (d[x] + p) & 0xFFFF;
            }
          }
          uint8_t* row = c.samples.data() + static_cast<size_t>(r0 * c.v + r) * w;
          for (int x = 0; x < w; x++) row[x] = static_cast<uint8_t>(out[x] << al);
          std::swap(prev[i], cur[i]);
        }
      }
    }
    pos = br.pos;
    if (br.marker != 0) pos -= 2;
  }

  // after read_header: the scans up to EOI; for a single-scan image, the file may end (with
  // no EOI) once its scan is read: Pillow's libjpeg has every row by then,
  // and only a marker it refuses stops it
  void read_all() {
    try {
      while (handle_marker(next_marker())) {
      }
    } catch (const Failure& f) {
      if (f.code != JPEG_TRUNCATED || scans == 0 || multiscan) throw;
    }
    if (scans == 0) fail(JPEG_CORRUPT, "corrupt JPEG: no scan before EOI");
  }
};

// --- ISLOW IDCT (jidctint.c, as libjpeg-turbo's x86 SIMD computes it) -----
//
// Pillow's libjpeg-turbo on x86-64 runs jidctint-sse2/avx2.asm. On every
// block a valid stream gives it equals jidctint.c; on the large
// coefficients of corrupt data it differs, and this is what it does:
// coefficient x quantizer and the sums in0 +- in4, in7 + in3 and
// in5 + in1 wrap to 16 bits; products and the other sums are 32-bit;
// pass 1 rounds, shifts and saturates into a 16-bit workspace (a block
// whose rows 1-7 are all zero takes in0 x q0 << 2, wrapped to 16 bits,
// down every column); pass 2 saturates to 16 and then 8 bits around 128.

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
// the pairs of constants the SIMD code multiplies (pmaddwd) with
constexpr int32_t F054 = 4433, F130 = 4433 + 6270, F054_M184 = 4433 - 15137,
                  F117 = 9633, F117_M196 = 9633 - 16069, F117_M039 = 9633 - 3196,
                  F029_M089 = 2446 - 7373, M089 = -7373, F150_M089 = 12299 - 7373,
                  F205_M256 = 16819 - 20995, M256 = -20995, F307_M256 = 25172 - 20995;

inline int16_t w16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}
// (x + 2^(n-1)) >> n in 32 bits (paddd, psrad)
inline int32_t descale(int32_t x, int n) { return add32(x, 1 << (n - 1)) >> n; }

// one 8-point pass over 16-bit inputs d[0..7]; writes the 8 outputs,
// descaled by n, to be saturated by the caller (packssdw to 16 bits after
// pass 1; to 16 and then 8 bits, which is to 8 bits, after pass 2)
inline void idct_pass(const int16_t d[8], int n, int32_t o[8]) {
  int32_t z2 = d[2], z3 = d[6];
  int32_t tmp3 = z2 * F130 + z3 * F054;
  int32_t tmp2 = z2 * F054 + z3 * F054_M184;
  int32_t tmp0 = static_cast<int32_t>(static_cast<uint32_t>(w16(d[0] + d[4])) << CONST_BITS);
  int32_t tmp1 = static_cast<int32_t>(static_cast<uint32_t>(w16(d[0] - d[4])) << CONST_BITS);
  int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  int32_t t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
  int32_t o3 = w16(t0 + t2), o4 = w16(t1 + t3);
  int32_t z3o = o3 * F117_M196 + o4 * F117;
  int32_t z4o = o3 * F117 + o4 * F117_M039;
  int32_t a0 = add32(t0 * F029_M089 + t3 * M089, z3o);
  int32_t a3 = add32(t0 * M089 + t3 * F150_M089, z4o);
  int32_t a1 = add32(t1 * F205_M256 + t2 * M256, z4o);
  int32_t a2 = add32(t1 * M256 + t2 * F307_M256, z3o);
  o[0] = descale(add32(tmp10, a3), n);
  o[7] = descale(sub32(tmp10, a3), n);
  o[1] = descale(add32(tmp11, a2), n);
  o[6] = descale(sub32(tmp11, a2), n);
  o[2] = descale(add32(tmp12, a1), n);
  o[5] = descale(sub32(tmp12, a1), n);
  o[3] = descale(add32(tmp13, a0), n);
  o[4] = descale(sub32(tmp13, a0), n);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];  // ws[8 * c + r]: column c's output r
  bool ac_zero = true;
  for (int i = 8; i < 64; i++) ac_zero &= in[i] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; c++) {
      int16_t v =
          w16(static_cast<int32_t>(static_cast<uint32_t>(w16(in[c] * q[c])) << PASS1_BITS));
      for (int r = 0; r < 8; r++) ws[8 * c + r] = v;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
          ip[48] == 0 && ip[56] == 0) {  // what idct_pass gives for it, without the work
        int16_t v = sat16(4 * w16(ip[0] * q[c]));
        for (int r = 0; r < 8; r++) ws[8 * c + r] = v;
      } else {
        int16_t d[8];
        for (int r = 0; r < 8; r++) d[r] = w16(ip[8 * r] * q[8 * r + c]);
        int32_t o[8];
        idct_pass(d, CONST_BITS - PASS1_BITS, o);
        for (int r = 0; r < 8; r++) ws[8 * c + r] = sat16(o[r]);
      }
    }
  }
  for (int r = 0; r < 8; r++) {
    int16_t d[8];
    int32_t o[8];
    bool zero = true;
    for (int c = 0; c < 8; c++) {
      d[c] = ws[8 * c + r];
      zero &= c == 0 || d[c] == 0;
    }
    if (zero) {  // what idct_pass gives for it, without the work
      int32_t v = (d[0] + 16) >> 5;
      for (int c = 0; c < 8; c++) o[c] = v;
    } else {
      idct_pass(d, CONST_BITS + PASS1_BITS + 3, o);
    }
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    for (int c = 0; c < 8; c++)
      op[c] = static_cast<uint8_t>((o[c] < -128 ? -128 : (o[c] > 127 ? 127 : o[c])) + 128);
  }
}

// One component's samples at its own resolution: (bh*8) rows of bw*8.
std::vector<uint8_t> component_plane(Component& c) {
  int stride = c.bw * 8;
  std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.bh * 8);
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++)
      idct_islow(c.block(bx, by), c.quant, plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8,
                 stride);
  return plane;
}

// --- block smoothing (jdcoefct.c decompress_smooth_data) -------------------
//
// libjpeg-turbo smooths a progressive image whose scans leave one of the
// first nine AC coefficients unfinished: it estimates the coefficients that
// are still zero (and, where no AC coefficient was sent, the DC) from the
// DC values of the 5 x 5 blocks around, into a copy of each block.

// jdcoefct.c smoothing_ok, after the last scan (Pillow decodes in one pass)
bool smoothing_ok(const Decoder& d) {
  if (!d.progressive) return false;
  bool useful = false;
  for (const Component& c : d.comps) {
    if (!c.latched) return false;
    const uint16_t* q = c.quant;
    if (!q[0] || !q[1] || !q[8] || !q[16] || !q[9] || !q[2] || !q[3] || !q[10] || !q[17] ||
        !q[24])
      return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; k++) useful |= c.coef_bits[k] != 0;
  }
  return useful;
}

// the estimate of a coefficient whose quantizer is q from num, limited to
// what its unsent bits below Al can hold
inline int16_t smooth_pred(int64_t num, int64_t q, int Al) {
  int pred = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
  if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
  return static_cast<int16_t>(num >= 0 ? pred : -pred);
}

// one block's estimates into ws; dc[1..25] are the DC values of the 5 x 5
// blocks around it, row by row (dc[13] its own)
void smooth_block(int16_t* ws, const int* dc, const int* bits, const uint16_t* q,
                  bool change_dc) {
  const int64_t Q00 = q[0];
  int Al;
  auto DC = [&](int i) { return dc[i]; };
  if ((Al = bits[1]) != 0 && ws[1] == 0) {
    int64_t num = Q00 * (change_dc ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
                                      13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) -
                                      38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) -
                                      13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) + DC(25))
                                   : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
    ws[1] = smooth_pred(num, q[1], Al);
  }
  if ((Al = bits[2]) != 0 && ws[8] == 0) {
    int64_t num = Q00 * (change_dc ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) +
                                      13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) -
                                      13 * DC(17) - 38 * DC(18) - 13 * DC(19) + DC(20) + DC(21) +
                                      3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25))
                                   : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
    ws[8] = smooth_pred(num, q[8], Al);
  }
  if ((Al = bits[3]) != 0 && ws[16] == 0) {
    int64_t num = Q00 * (change_dc ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
                                      14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) +
                                      2 * DC(19) + DC(23))
                                   : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
    ws[16] = smooth_pred(num, q[16], Al);
  }
  if ((Al = bits[4]) != 0 && ws[9] == 0) {
    int64_t num = Q00 * (change_dc ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) +
                                      9 * DC(19) + DC(21) - DC(25))
                                   : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) -
                                      DC(20) + DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) -
                                      10 * DC(9)));
    ws[9] = smooth_pred(num, q[9], Al);
  }
  if ((Al = bits[5]) != 0 && ws[2] == 0) {
    int64_t num = Q00 * (change_dc ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
                                      14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) -
                                      5 * DC(18) + 2 * DC(19))
                                   : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15)));
    ws[2] = smooth_pred(num, q[2], Al);
  }
  if (!change_dc) return;
  if ((Al = bits[6]) != 0 && ws[3] == 0)
    ws[3] = smooth_pred(Q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) - DC(19)), q[3], Al);
  if ((Al = bits[7]) != 0 && ws[10] == 0)
    ws[10] = smooth_pred(Q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) - DC(19)), q[10], Al);
  if ((Al = bits[8]) != 0 && ws[17] == 0)
    ws[17] = smooth_pred(Q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) - DC(19)), q[17], Al);
  if ((Al = bits[9]) != 0 && ws[24] == 0)
    ws[24] = smooth_pred(Q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) - DC(19)), q[24], Al);
  // the DC itself, a weighted mean of the 25 (the weights sum to 256)
  int64_t num = Q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) - 6 * DC(6) +
                       6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) - 8 * DC(11) +
                       42 * DC(12) + 152 * DC(13) + 42 * DC(14) - 8 * DC(15) - 6 * DC(16) +
                       6 * DC(17) + 42 * DC(18) + 6 * DC(19) - 6 * DC(20) - 2 * DC(21) -
                       6 * DC(22) - 8 * DC(23) - 6 * DC(24) - 2 * DC(25));
  ws[0] = smooth_pred(num, q[0], 0);
}

// component_plane with each block smoothed. The rows above and below a
// block are those of jdcoefct.c, which counts the blocks of the last iMCU
// row as though every iMCU row held that many: where that row is short, a
// neighbour that exists can read as the edge, replicated.
std::vector<uint8_t> component_plane_smoothed(const Decoder& d, Component& c) {
  const int stride = c.bw * 8;
  std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.bh * 8);
  int prev_bits[10];
  for (int k = 0; k < 10; k++) prev_bits[k] = d.scans > 1 ? c.prev_bits[k] : -1;
  for (int R = 0; R < d.mcusy; R++) {
    const int block_rows = R < d.mcusy - 1 ? c.v : (c.bh % c.v ? c.bh % c.v : c.v);
    // an iMCU row after the last good one of an incomplete last scan takes
    // the coefficient bits from before that scan
    const int* bits = R > d.last_good_imcu ? prev_bits : c.coef_bits;
    bool change_dc = true;  // DC interpolation, where no AC coefficient was sent
    for (int k = 1; k < 10; k++) change_dc &= bits[k] == -1;
    const int image_block_rows = block_rows * d.mcusy;
    for (int b = 0; b < block_rows; b++) {
      const int by = R * c.v + b, ib = R * block_rows + b;
      int rows[5];
      rows[2] = by;
      rows[1] = ib > 0 ? by - 1 : by;
      rows[0] = ib > 1 ? by - 2 : rows[1];
      rows[3] = ib < image_block_rows - 1 ? by + 1 : by;
      rows[4] = ib < image_block_rows - 2 ? by + 2 : rows[3];
      int reg[5][5];  // the DC values at columns bx-2..bx+2 of each row
      for (int r = 0; r < 5; r++)
        for (int x = 0; x < 5; x++) reg[r][x] = c.block(0, rows[r])[0];
      const int last = c.bw - 1;
      for (int bx = 0; bx < c.bw; bx++) {
        if (bx == 0 && bx < last)
          for (int r = 0; r < 5; r++) reg[r][3] = reg[r][4] = c.block(1, rows[r])[0];
        if (bx + 1 < last)
          for (int r = 0; r < 5; r++) reg[r][4] = c.block(bx + 2, rows[r])[0];
        int dc[26];
        for (int r = 0; r < 5; r++)
          for (int x = 0; x < 5; x++) dc[1 + 5 * r + x] = reg[r][x];
        int16_t ws[64];
        std::memcpy(ws, c.block(bx, by), sizeof(ws));
        smooth_block(ws, dc, bits, c.quant, change_dc);
        idct_islow(ws, c.quant, plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8,
                   stride);
        for (int r = 0; r < 5; r++)
          for (int x = 0; x < 4; x++) reg[r][x] = reg[r][x + 1];
      }
    }
  }
  return plane;
}

// --- upsampling (jdsample.c) to the full (height, width) -------------------

// plane: the component's samples, rows of stride bytes; fancy: libjpeg's
// default, which is off for a lossless frame (its data units are single
// samples), where every ratio replicates
void upsample(const Decoder& d, const Component& c, const uint8_t* plane, int stride, bool fancy,
              std::vector<uint8_t>& full) {
  const int W = d.width, H = d.height;
  const int hf = d.hmax / c.h, vf = d.vmax / c.v;
  full.resize(static_cast<size_t>(W) * H);
  auto in_row = [&](int r) { return plane + static_cast<size_t>(r) * stride; };
  const int dw = c.dw, dh = c.dh;
  std::vector<int> colsum(dw + 2);
  std::vector<uint8_t> row(2 * dw + 2);
  if (hf == 1 && vf == 1) {
    for (int y = 0; y < H; y++) std::memcpy(&full[static_cast<size_t>(y) * W], in_row(y), W);
  } else if (!fancy) {
    for (int y = 0; y < H; y++) {
      const uint8_t* in = in_row(y / vf);
      uint8_t* out = &full[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; x++) out[x] = in[x / hf];
    }
  } else if (hf == 2 && vf == 1 && dw > 2) {  // h2v1 fancy
    for (int y = 0; y < H; y++) {
      const uint8_t* in = in_row(y);
      for (int j = 0; j < dw; j++) {
        int t = in[j] * 3;
        int left = in[j > 0 ? j - 1 : 0], right = in[j + 1 < dw ? j + 1 : dw - 1];
        row[2 * j] = static_cast<uint8_t>((t + left + 1) >> 2);
        row[2 * j + 1] = static_cast<uint8_t>((t + right + 2) >> 2);
      }
      std::memcpy(&full[static_cast<size_t>(y) * W], row.data(), W);
    }
  } else if (hf == 1 && vf == 2) {  // h1v2 fancy
    for (int y = 0; y < H; y++) {
      int i = y >> 1, v = y & 1;
      int nb = v ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      const uint8_t* a = in_row(i);
      const uint8_t* b = in_row(nb);
      int bias = v ? 2 : 1;
      uint8_t* out = &full[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; x++) out[x] = static_cast<uint8_t>((a[x] * 3 + b[x] + bias) >> 2);
    }
  } else if (hf == 2 && vf == 2 && dw > 2) {  // h2v2 fancy
    for (int y = 0; y < H; y++) {
      int i = y >> 1, v = y & 1;
      int nb = v ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      const uint8_t* a = in_row(i);
      const uint8_t* b = in_row(nb);
      for (int j = 0; j < dw; j++) colsum[j + 1] = a[j] * 3 + b[j];
      colsum[0] = colsum[1];
      colsum[dw + 1] = colsum[dw];
      for (int j = 0; j < dw; j++) {
        int t = colsum[j + 1] * 3;
        row[2 * j] = static_cast<uint8_t>((t + colsum[j] + 8) >> 4);
        row[2 * j + 1] = static_cast<uint8_t>((t + colsum[j + 2] + 7) >> 4);
      }
      std::memcpy(&full[static_cast<size_t>(y) * W], row.data(), W);
    }
  } else {  // replication (h2v1/h2v2 at a width of 2 or less, int_upsample)
    for (int y = 0; y < H; y++) {
      const uint8_t* in = in_row(y / vf);
      uint8_t* out = &full[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; x++) out[x] = in[x / hf];
    }
  }
}

// --- colour (jdcolor.c, Pillow's Unpack.c and Convert.c) -------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SCALEBITS = 16;
    constexpr int32_t ONE_HALF = 1 << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1L << SCALEBITS) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables tables;  // built once, thread-safe (C++11 statics)
  return tables;
}

inline uint8_t clip255(int x) { return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x)); }
inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// d after read_header
void decode_to_rgb(Decoder& d, uint8_t* out) {
  d.read_all();
  const int W = d.width, H = d.height;
  const size_t npix = static_cast<size_t>(W) * H;
  // libjpeg-turbo converts no colour in a lossless frame: one whose
  // components are YCbCr or YCCK is refused (JERR_CONVERSION_NOTIMPL)
  if (d.lossless && ((d.ncomp == 3 && (d.saw_jfif || (d.saw_adobe && d.adobe_transform != 0))) ||
                     (d.ncomp == 4 && d.saw_adobe && d.adobe_transform != 0)))
    fail(JPEG_CORRUPT, "a lossless JPEG in YCbCr or YCCK: libjpeg converts no colour there");
  // a lossless frame's samples of several scans wait in arrays libjpeg does
  // not zero: reading those of a component no scan wrote is an error
  // (jmemmgr.c JERR_BAD_VIRTUAL_ACCESS)
  for (const Component& c : d.comps)
    if (d.lossless && !c.scanned) fail(JPEG_CORRUPT, "a lossless JPEG with a component no scan holds");
  std::vector<std::vector<uint8_t>> full(d.ncomp);
  const bool smooth = smoothing_ok(d);
  for (int i = 0; i < d.ncomp; i++) {
    Component& c = d.comps[i];
    if (d.hmax % c.h || d.vmax % c.v)
      fail(JPEG_CORRUPT, "sampling factors of a fractional ratio (libjpeg refuses them too)");
    if (d.lossless) {
      upsample(d, c, c.samples.data(), c.dw, false, full[i]);
      continue;
    }
    std::vector<uint8_t> plane = smooth ? component_plane_smoothed(d, c) : component_plane(c);
    upsample(d, c, plane.data(), c.bw * 8, true, full[i]);
  }
  for (Component& c : d.comps) {
    c.coef.clear();
    c.coef.shrink_to_fit();
  }
  if (d.ncomp == 1) {
    const uint8_t* g = full[0].data();
    for (size_t p = 0; p < npix; p++) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = g[p];
    return;
  }
  const YccTables& t = ycc_tables();
  if (d.ncomp == 3) {
    bool rgb;
    if (d.saw_jfif)
      rgb = false;
    else if (d.saw_adobe)
      rgb = d.adobe_transform == 0;
    else  // jdapimin.c: a lossless frame is RGB whatever its ids
      rgb = d.lossless || (d.comps[0].id == 82 && d.comps[1].id == 71 && d.comps[2].id == 66);
    const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
    if (rgb) {
      for (size_t p = 0; p < npix; p++) {
        out[3 * p] = c0[p];
        out[3 * p + 1] = c1[p];
        out[3 * p + 2] = c2[p];
      }
      return;
    }
    for (size_t p = 0; p < npix; p++) {
      int y = c0[p], cb = c1[p], cr = c2[p];
      out[3 * p] = clip255(y + t.cr_r[cr]);
      out[3 * p + 1] = clip255(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      out[3 * p + 2] = clip255(y + t.cb_b[cb]);
    }
    return;
  }
  // four components: CMYK, or YCCK converted to CMYK by libjpeg
  bool ycck = d.saw_adobe && d.adobe_transform != 0;
  const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data(),
                *c3 = full[3].data();
  for (size_t p = 0; p < npix; p++) {
    int cmyk[3];
    if (ycck) {
      int y = c0[p], cb = c1[p], cr = c2[p];
      cmyk[0] = clip255(255 - (y + t.cr_r[cr]));
      cmyk[1] = clip255(255 - (y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
      cmyk[2] = clip255(255 - (y + t.cb_b[cb]));
    } else {
      cmyk[0] = c0[p];
      cmyk[1] = c1[p];
      cmyk[2] = c2[p];
    }
    // Pillow reads the samples inverted ("CMYK;I"), then cmyk2rgb gives
    // nk - nk * c / 255 with nk = 255 - k; on the raw samples nk is k
    int nk = c3[p];
    for (int ch = 0; ch < 3; ch++) out[3 * p + ch] = clip255(nk - muldiv255(255 - cmyk[ch], nk));
  }
}

void copy_message(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// (height, width, components, kind) of a JPEG's frame; kind is 0 for
// baseline, 1 for extended sequential, 2 for progressive, 3 for lossless,
// 4 for arithmetic-coded sequential, 5 for arithmetic-coded progressive.
int jpeg_info(const uint8_t* data, size_t size, int* info, char* err, int errlen) {
  try {
    Decoder d(data, size);
    d.read_header();
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    info[3] = d.kind;
    return JPEG_OK;
  } catch (const Failure& f) {
    copy_message(f.msg, err, errlen);
    return f.code == JPEG_TRUNCATED ? JPEG_CORRUPT : f.code;
  } catch (const std::bad_alloc&) {
    copy_message("out of memory", err, errlen);
    return JPEG_CORRUPT;
  }
}

// The image as (height, width, 3) uint8 RGB into out (out_size bytes).
int jpeg_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                    int errlen) {
  try {
    Decoder d(data, size);
    d.read_header();
    if (static_cast<size_t>(d.width) * d.height * 3 != out_size) {
      copy_message("the output buffer does not hold height x width x 3 bytes", err, errlen);
      return JPEG_CORRUPT;
    }
    decode_to_rgb(d, out);
    return JPEG_OK;
  } catch (const Failure& f) {
    copy_message(f.msg, err, errlen);
    return f.code == JPEG_TRUNCATED ? JPEG_CORRUPT : f.code;
  } catch (const std::bad_alloc&) {
    copy_message("out of memory", err, errlen);
    return JPEG_CORRUPT;
  }
}

}  // extern "C"
