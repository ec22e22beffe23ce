// A baseline and progressive JPEG decoder that gives libjpeg-turbo's pixels
// (JPEG_LIB_VERSION 62, the JAX package's decoder), for machines without
// libjpeg. It needs no third-party header. It follows libjpeg's decode path:
//   * Huffman entropy decoding, sequential (SOF0 / SOF1) and progressive
//     (SOF2: DC first / refine, AC first / refine with EOB runs), restart
//     intervals; the quantisation table latched at a component's first scan;
//   * arithmetic entropy decoding (jdarith.c), sequential (SOF9) and
//     progressive (SOF10): the QM coder's registers, 64 DC and 256 AC
//     statistics bins per table, the conditioning bounds of the DAC marker
//     (L 0, U 1, Kx 5 without one), the bins and the DC context reset at
//     every restart marker; a marker or the end of the data inside a scan
//     supplies zeros, as libjpeg does;
//   * the accurate integer IDCT (jidctint.c, jpeg_idct_islow) and, with DCT
//     scaling, the reduced-size ones (jidctred.c: 4x4, 2x2, 1x1), each
//     clamped through libjpeg's post-IDCT range-limit table;
//   * libjpeg's choice of each component's scaled block size (a chroma
//     component is scaled up by the IDCT where the ratio allows, jdmaster.c),
//     and its upsampling (jdsample.c): full size, fancy (triangle) h2v1, h1v2
//     and h2v2 with the top and bottom rows replicated as context, plain
//     replication where fancy does not apply (1/8 scale, 2 or fewer columns);
//   * colour conversion (jdcolor.c): YCbCr -> RGB by libjpeg's fixed-point
//     tables, grey -> RGB, RGB copy, YCCK -> CMYK, CMYK copy; the colour space
//     from the JFIF / Adobe markers or the component ids
//     (jdapimin.c default_decompress_parms).
// Lossless JPEG (SOF3, SOF11), the differential processes and 12-bit samples
// are refused with libjpeg's messages.
//
// Entries (extern "C"):
//   dqvq_jpeg_port_header(buf, len, &h, &w, &components, msg, cap)
//   dqvq_jpeg_port_decode(buf, len, denom, space, out, cap, &h, &w, msg, cap)
//     space 0: RGB (3 bytes a pixel; fails for 4 components, as libjpeg's
//     colour conversion does); 1: grey (1 component); 2: CMYK stored
//     inverted (255 - v), as Pillow's "CMYK;I" raw mode stores it.
//   dqvq_jpeg_port_coefficients(buf, len, dims, out, cap, msg, cap) -> count
//     every component's quantised coefficients, (rows, columns) of blocks in
//     dims, 64 a block in natural order, as libjpeg's jpeg_read_coefficients.
//
// Build: part of the image_core library (native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr int kMaxComponents = 4;

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};  // past the end: corrupt data

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t huffval[256];
  // 8-bit lookahead: (length << 8) | symbol, 0 where the code is longer
  uint16_t look[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // blocks holding image samples
  int blocks_w = 0, blocks_h = 0;                 // allocated (whole MCUs)
  std::vector<int16_t> coef;                      // blocks_w * blocks_h * 64
  uint16_t quant[64];                             // natural order, latched at first scan
  bool quant_latched = false;
  int dc_pred = 0;
  int eob_run = 0;
  int dc_context = 0;  // arithmetic coding: the DC statistics' conditioning offset
  // progression status by zigzag index (jdphuff.c / jdarith.c start_pass): the Al of the
  // last scan that read the coefficient (-1: none yet), and its value before the last scan
  // of this component that covered it
  int coef_bits[64];
  int prev_bits[64];
};

constexpr int kArithTables = 16;
constexpr int kDcStatBins = 64, kAcStatBins = 256;

// jaricom.c jpeg_aritab (ITU-T T.81 Table D.2): Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed probability 0.5
#define V(i, qe, nlps, nmps, sw) \
  ((static_cast<int64_t>(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),      V(1, 0x2586, 14, 2, 0),     V(2, 0x1114, 16, 3, 0),
    V(3, 0x080b, 18, 4, 0),     V(4, 0x03d8, 20, 5, 0),     V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),     V(7, 0x006f, 28, 8, 0),     V(8, 0x0036, 30, 9, 0),
    V(9, 0x001a, 33, 10, 0),    V(10, 0x000d, 35, 11, 0),   V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),   V(13, 0x0001, 12, 13, 0),   V(14, 0x5a7f, 15, 15, 1),
    V(15, 0x3f25, 36, 16, 0),   V(16, 0x2cf2, 38, 17, 0),   V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),   V(19, 0x1182, 42, 20, 0),   V(20, 0x0cef, 43, 21, 0),
    V(21, 0x09a1, 45, 22, 0),   V(22, 0x072f, 46, 23, 0),   V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),   V(25, 0x0303, 51, 26, 0),   V(26, 0x0240, 52, 27, 0),
    V(27, 0x01b1, 54, 28, 0),   V(28, 0x0144, 56, 29, 0),   V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),   V(31, 0x008a, 60, 32, 0),   V(32, 0x0068, 62, 33, 0),
    V(33, 0x004e, 63, 34, 0),   V(34, 0x003b, 32, 35, 0),   V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),   V(37, 0x484c, 64, 38, 0),   V(38, 0x3a0d, 65, 39, 0),
    V(39, 0x2ef1, 67, 40, 0),   V(40, 0x261f, 68, 41, 0),   V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),   V(43, 0x1518, 72, 44, 0),   V(44, 0x1177, 73, 45, 0),
    V(45, 0x0e74, 74, 46, 0),   V(46, 0x0bfb, 75, 47, 0),   V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),   V(49, 0x0706, 79, 50, 0),   V(50, 0x05cd, 48, 51, 0),
    V(51, 0x04de, 50, 52, 0),   V(52, 0x040f, 50, 53, 0),   V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),   V(55, 0x025c, 53, 56, 0),   V(56, 0x01f8, 54, 57, 0),
    V(57, 0x01a4, 55, 58, 0),   V(58, 0x0160, 56, 59, 0),   V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),   V(61, 0x00cb, 59, 62, 0),   V(62, 0x00ab, 61, 63, 0),
    V(63, 0x008f, 61, 32, 0),   V(64, 0x5b12, 65, 65, 1),   V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),   V(67, 0x37d8, 82, 68, 0),   V(68, 0x2fe8, 83, 69, 0),
    V(69, 0x293c, 84, 70, 0),   V(70, 0x2379, 86, 71, 0),   V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),   V(73, 0x174e, 72, 74, 0),   V(74, 0x1424, 72, 75, 0),
    V(75, 0x119c, 74, 76, 0),   V(76, 0x0f6b, 74, 77, 0),   V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),   V(79, 0x0a40, 77, 48, 0),   V(80, 0x5832, 80, 81, 1),
    V(81, 0x4d1c, 88, 82, 0),   V(82, 0x438e, 89, 83, 0),   V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),   V(85, 0x2eae, 92, 86, 0),   V(86, 0x299a, 93, 87, 0),
    V(87, 0x2516, 86, 71, 0),   V(88, 0x5570, 88, 89, 1),   V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),   V(91, 0x3e22, 97, 92, 0),   V(92, 0x3824, 99, 93, 0),
    V(93, 0x32b4, 99, 94, 0),   V(94, 0x2e17, 93, 86, 0),   V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),  V(97, 0x47e5, 102, 98, 0),  V(98, 0x41cf, 103, 99, 0),
    V(99, 0x3c3d, 104, 100, 0), V(100, 0x375e, 99, 93, 0),  V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0),
    V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1),
    V(111, 0x5522, 112, 109, 0), V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

std::string hex2(int v) {
  char buf[8];
  std::snprintf(buf, sizeof(buf), "0x%02x", v);
  return buf;
}

class Decoder {
 public:
  Decoder(const uint8_t* data, long len) : d_(data), n_(len) {}

  void read_header();
  void decode_scans();
  enum ColorSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK };
  // the colour space of the data (jdapimin.c default_decompress_parms)
  ColorSpace color_space() const;
  // refuses an output `space` libjpeg has no conversion to, before any scan is read
  void check_conversion(int space) const;
  // output: (out_h, out_w, channels) for `space` at 1/denom
  void output(int denom, int space, uint8_t* out, long cap, int* out_h, int* out_w);

  int width = 0, height = 0, ncomp = 0;
  bool progressive = false;
  bool arithmetic = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  Component comp[kMaxComponents];
  int hmax = 1, vmax = 1;

 private:
  // ------------------------------------------------------------- markers
  int byte() {
    if (pos_ < n_) return d_[pos_++];
    // past the end of the data after the header: a fake EOI marker, again and
    // again, as libjpeg's memory source supplies (a cut marker segment reads it)
    if (!fake_eoi_) throw JpegError("Premature end of JPEG file");
    return (fake_phase_++ & 1) ? 0xD9 : 0xFF;
  }
  int word() {
    int a = byte();
    return (a << 8) | byte();
  }
  int next_marker() {
    // skip to 0xFF, then past fill bytes
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  void skip_segment() {
    int len = word();
    if (len < 2) throw JpegError("Bogus marker length");
    pos_ += len - 2;
    if (pos_ > n_) {
      if (!fake_eoi_) throw JpegError("Premature end of JPEG file");
      pos_ = n_;
    }
  }
  void read_app(int marker);
  void read_dqt();
  void read_dht();
  void read_sof(int marker);
  void read_sos();
  void read_dri() {
    if (word() != 4) throw JpegError("Bogus DRI length");
    restart_interval_ = word();
  }
  void read_dac();

  // ----------------------------------------------------------- bit reader
  void reset_bits() {
    bitbuf_ = 0;
    bits_ = 0;
    fake_bits_ = 0;
    hit_marker_ = false;
  }
  void fill(int need) {
    while (bits_ < need) {
      int c = 0;
      bool fake = true;
      if (!hit_marker_ && pos_ < n_) {
        c = d_[pos_];
        if (c == 0xFF) {
          int c2 = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
          if (c2 == 0) {
            pos_ += 2;
            fake = false;
          } else {  // a marker: feed zeros from here on, as libjpeg does
            hit_marker_ = true;
            c = 0;
          }
        } else {
          ++pos_;
          fake = false;
        }
      }
      bitbuf_ = (bitbuf_ << 8) | static_cast<uint32_t>(c);
      bits_ += 8;
      if (fake) fake_bits_ += 8;
    }
  }
  // whether decoding has read past the real data (the zeros are the newest bits)
  bool past_data() const { return bits_ < fake_bits_; }
  int get_bits(int n) {
    if (n == 0) return 0;
    fill(n);
    bits_ -= n;
    return static_cast<int>((bitbuf_ >> bits_) & ((1u << n) - 1));
  }
  int get_bit() { return get_bits(1); }
  int decode_huff(const Huffman& t) {
    fill(16);
    const int peek = static_cast<int>((bitbuf_ >> (bits_ - 8)) & 0xFF);
    const uint16_t e = t.look[peek];
    if (e) {
      bits_ -= e >> 8;
      return e & 0xFF;
    }
    int l = 9;
    int code = static_cast<int>((bitbuf_ >> (bits_ - 9)) & 0x1FF);
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = static_cast<int>((bitbuf_ >> (bits_ - l)) & ((1u << l) - 1));
    }
    if (l > 16) {  // corrupt data: libjpeg returns 0 and warns
      bits_ -= 16;
      return 0;
    }
    bits_ -= l;
    return t.huffval[(code + t.valoffset[l]) & 0xFF];
  }
  static int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }
  void restart();
  bool smoothing_ok(int (*cur)[10], int (*prev)[10]) const;
  void smooth_row(const Component& c, int by, const int* bits, int16_t* blocks) const;

  // ------------------------------------------ arithmetic decoder (jdarith.c)
  int arith_byte();
  int arith_decode(uint8_t* st);
  void arith_reset_scan_stats();
  int arith_dc_diff(Component& c);
  int arith_ac_value(uint8_t* st, int k, int tbl);
  void arith_block_sequential(Component& c, int16_t* blk);
  void arith_block_dc_first(Component& c, int16_t* blk);
  void arith_block_dc_refine(int16_t* blk);
  void arith_block_ac_first(Component& c, int16_t* blk);
  void arith_block_ac_refine(Component& c, int16_t* blk);

  // --------------------------------------------------------------- scans
  void decode_scan();
  void decode_block_sequential(Component& c, int16_t* blk);
  void decode_block_dc_first(Component& c, int16_t* blk);
  void decode_block_dc_refine(int16_t* blk);
  void decode_block_ac_first(Component& c, int16_t* blk);
  void decode_block_ac_refine(Component& c, int16_t* blk);
  void decode_block(Component& c, int16_t* blk);

  const uint8_t* d_;
  long n_;
  long pos_ = 0;
  bool fake_eoi_ = false;
  int fake_phase_ = 0;
  uint32_t bitbuf_ = 0;
  int bits_ = 0;
  bool hit_marker_ = false;
  int restart_interval_ = 0;
  int next_restart_ = 0;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  bool frame_seen_ = false;
  // arithmetic coding: DAC conditioning (libjpeg's defaults at SOI), the
  // statistics bins, the QM coder's registers (ct -1: a bad code, the rest of
  // the restart interval decodes nothing)
  uint8_t dac_l_[kArithTables], dac_u_[kArithTables], dac_k_[kArithTables];
  uint8_t dc_stats_[kArithTables][kDcStatBins], ac_stats_[kArithTables][kAcStatBins];
  uint8_t fixed_bin_[4] = {113, 0, 0, 0};
  int64_t ar_c_ = 0, ar_a_ = 0;
  int ar_ct_ = -16;
  // Huffman data that ran out inside a scan: the rest of the segment is left
  // as it is (jdhuff.c / jdphuff.c insufficient_data); zero bits fed past a
  // marker or the end of the data, and whether decoding consumed one
  int fake_bits_ = 0;
  bool insufficient_ = false;
  // scans read, and the last iMCU row that the latest scan started with data
  // left (libjpeg-turbo's master->last_good_iMCU_row)
  int scans_ = 0;
  int last_good_imcu_ = 0;
  // the current scan
  int scan_n_ = 0;
  int scan_comp_[kMaxComponents];
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int mcus_x_ = 0, mcus_y_ = 0;
};

void Decoder::read_app(int marker) {
  int len = word();
  if (len < 2) throw JpegError("Bogus marker length");
  const long start = pos_, end = pos_ + len - 2;
  if (end > n_) throw JpegError("Premature end of JPEG file");
  const uint8_t* p = d_ + start;
  const int n = len - 2;
  if (marker == 0xE0 && n >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) saw_jfif = true;
  if (marker == 0xEE && n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
    saw_adobe = true;
    adobe_transform = p[11];
  }
  pos_ = end;
}

// The segment readers count the bytes left by the segment's length, as
// jdmarker.c does, so a segment cut by the end of the data reads the fake EOI
// bytes in place of the rest.
void Decoder::read_dqt() {
  long left = word() - 2;
  while (left > 0) {
    int pq = byte();
    int prec = pq >> 4, tq = pq & 15;
    if (tq > 3) throw JpegError("Bogus DQT index");
    for (int i = 0; i < 64; ++i) {
      int v = prec ? word() : byte();
      qt_[tq][kNaturalOrder[i]] = static_cast<uint16_t>(v);
    }
    left -= prec ? 129 : 65;
    qt_defined_[tq] = true;
  }
  if (left != 0) throw JpegError("Bogus DQT length");
}

void Decoder::read_dht() {
  long left = word() - 2;
  while (left > 16) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (th > 3 || tc > 1) throw JpegError("Bogus DHT index");
    uint8_t bits[17];
    int count = 0;
    bits[0] = 0;
    for (int i = 1; i <= 16; ++i) {
      bits[i] = static_cast<uint8_t>(byte());
      count += bits[i];
    }
    left -= 17;
    if (count > 256 || count > left) throw JpegError("Bogus Huffman table definition");
    Huffman& t = tc ? ac_[th] : dc_[th];
    std::memset(t.huffval, 0, sizeof(t.huffval));
    for (int i = 0; i < count; ++i) t.huffval[i] = static_cast<uint8_t>(byte());
    left -= count;
    // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) throw JpegError("Bogus Huffman table definition");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        t.valoffset[l] = p - huffcode[p];
        p += bits[l];
        t.maxcode[l] = huffcode[p - 1];
      } else {
        t.maxcode[l] = -1;
      }
    }
    t.valoffset[17] = 0;
    t.maxcode[17] = 0x7FFFFFFF;
    std::memset(t.look, 0, sizeof(t.look));
    p = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        int lookbits = huffcode[p] << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; --ctr, ++lookbits)
          t.look[lookbits] = static_cast<uint16_t>((l << 8) | t.huffval[p]);
      }
    }
    t.defined = true;
  }
  if (left != 0) throw JpegError("Bogus DHT length");
}

void Decoder::read_sof(int marker) {
  if (frame_seen_) throw JpegError("Invalid JPEG file structure: two SOF markers");
  frame_seen_ = true;
  progressive = marker == 0xC2 || marker == 0xCA;
  arithmetic = marker == 0xC9 || marker == 0xCA;
  int len = word();
  int precision = byte();
  height = word();
  width = word();
  ncomp = byte();
  if (precision != 8) throw JpegError("Unsupported JPEG data precision " + std::to_string(precision));
  if (len != 8 + 3 * ncomp || ncomp < 1 || ncomp > kMaxComponents)
    throw JpegError("Bogus SOF marker length");
  if (width <= 0 || height <= 0) throw JpegError("Empty JPEG image (DNL not supported)");
  hmax = vmax = 1;
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp[i];
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      throw JpegError("Bogus sampling factors");
    hmax = c.h > hmax ? c.h : hmax;
    vmax = c.v > vmax ? c.v : vmax;
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = c.prev_bits[k] = -1;
  }
  mcus_x_ = (width + 8 * hmax - 1) / (8 * hmax);
  mcus_y_ = (height + 8 * vmax - 1) / (8 * vmax);
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp[i];
    c.width_in_blocks = static_cast<int>((static_cast<long>(width) * c.h + 8 * hmax - 1) / (8 * hmax));
    c.height_in_blocks = static_cast<int>((static_cast<long>(height) * c.v + 8 * vmax - 1) / (8 * vmax));
    c.blocks_w = mcus_x_ * c.h;
    c.blocks_h = mcus_y_ * c.v;
  }
}

void Decoder::read_header() {
  if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) throw JpegError("Not a JPEG file: starts with " +
                                                                std::to_string(n_ ? d_[0] : -1));
  pos_ = 2;
  for (int i = 0; i < kArithTables; ++i) {  // jdmarker.c get_soi
    dac_l_[i] = 0;
    dac_u_[i] = 1;
    dac_k_[i] = 5;
  }
  for (;;) {
    int m = next_marker();
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
      read_sof(m);
    } else if (m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
      // lossless, differential, JPG: jdmarker.c JERR_SOF_UNSUPPORTED
      throw JpegError("Unsupported JPEG process: SOF type " + hex2(m));
    } else if (m == 0xCC) {
      read_dac();
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      read_dri();
    } else if (m == 0xE0 || m == 0xEE) {
      read_app(m);
    } else if (m == 0xDA) {
      if (!frame_seen_) throw JpegError("Improper call to JPEG library in state 201: SOS before SOF");
      pos_ -= 2;  // decode_scans reads the SOS again
      return;
    } else if (m == 0xD9) {
      throw JpegError("JPEG datastream contains no image");
    } else if (m == 0xD8) {
      throw JpegError("Invalid JPEG file structure: two SOI markers");
    } else if (m >= 0xD0 && m <= 0xD7) {
      // stray restart marker: ignore
    } else {
      skip_segment();
    }
  }
}

void Decoder::read_sos() {
  int len = word();
  scan_n_ = byte();
  if (len != 6 + 2 * scan_n_ || scan_n_ < 1 || scan_n_ > kMaxComponents)
    throw JpegError("Bogus SOS marker length");
  for (int i = 0; i < scan_n_; ++i) {
    int id = byte(), tables = byte();
    int ci = -1;
    for (int k = 0; k < ncomp; ++k)
      if (comp[k].id == id) ci = k;
    if (ci < 0) throw JpegError("Invalid component ID in SOS");
    scan_comp_[i] = ci;
    comp[ci].dc_tbl = tables >> 4;
    comp[ci].ac_tbl = tables & 15;
    // arithmetic tables 0..15 need no definition (their bins start at zero)
    if (!arithmetic && (comp[ci].dc_tbl > 3 || comp[ci].ac_tbl > 3))
      throw JpegError("Bogus Huffman table index");
  }
  ss_ = byte();
  se_ = byte();
  int a = byte();
  ah_ = a >> 4;
  al_ = a & 15;
  if (!progressive) {
    ss_ = 0;
    se_ = 63;
    ah_ = al_ = 0;
  } else if (ss_ > se_ || se_ > 63 || al_ > 13 || (ss_ == 0 && se_ != 0) ||
             (ss_ > 0 && scan_n_ != 1)) {
    throw JpegError("Invalid progressive parameters");
  }
  ++scans_;
  if (progressive) {  // jdphuff.c / jdarith.c start_pass: the progression status
    for (int i = 0; i < scan_n_; ++i) {
      Component& c = comp[scan_comp_[i]];
      for (int k = ss_ < 1 ? ss_ : 1; k <= (se_ > 9 ? se_ : 9); ++k)
        c.prev_bits[k] = scans_ > 1 ? c.coef_bits[k] : 0;
      for (int k = ss_; k <= se_; ++k) c.coef_bits[k] = al_;
    }
  }
  for (int i = 0; i < scan_n_; ++i) {
    Component& c = comp[scan_comp_[i]];
    if (!c.quant_latched) {  // jdinput.c latch_quant_tables
      if (!qt_defined_[c.tq]) throw JpegError("Quantization table 0x0" + std::to_string(c.tq) +
                                              " was not defined");
      std::memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
      c.quant_latched = true;
    }
    if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
    if (arithmetic) continue;
    const bool need_dc = ss_ == 0 && ah_ == 0;
    const bool need_ac = se_ > 0 || !progressive;
    if ((need_dc && !dc_[c.dc_tbl].defined) || (need_ac && !ac_[c.ac_tbl].defined))
      throw JpegError("Huffman table 0x0" + std::to_string(need_dc ? c.dc_tbl : c.ac_tbl) +
                      " was not defined");
  }
}

void Decoder::restart() {
  // jdhuff.c process_restart: discard the bits left, read the RSTn marker
  reset_bits();
  while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7)) {
    if (d_[pos_] == 0xFF && d_[pos_ + 1] != 0 && d_[pos_ + 1] != 0xFF) break;  // another marker
    ++pos_;
  }
  if (pos_ + 1 < n_ && d_[pos_] == 0xFF && d_[pos_ + 1] == 0xD0 + next_restart_) {
    pos_ += 2;
    insufficient_ = false;  // a data segment follows (left set before any other marker)
  }
  next_restart_ = (next_restart_ + 1) & 7;
  for (int i = 0; i < ncomp; ++i) {
    comp[i].dc_pred = 0;
    comp[i].eob_run = 0;
  }
  if (arithmetic) arith_reset_scan_stats();  // jdarith.c process_restart
}

void Decoder::decode_block_sequential(Component& c, int16_t* blk) {
  const Huffman& dc = dc_[c.dc_tbl];
  const Huffman& ac = ac_[c.ac_tbl];
  int s = decode_huff(dc);
  if (s) s = extend(get_bits(s), s);
  c.dc_pred += s;
  blk[0] = static_cast<int16_t>(c.dc_pred);
  for (int k = 1; k < 64; ++k) {
    int rs = decode_huff(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNaturalOrder[k]] = static_cast<int16_t>(extend(get_bits(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void Decoder::decode_block_dc_first(Component& c, int16_t* blk) {
  int s = decode_huff(dc_[c.dc_tbl]);
  if (s) s = extend(get_bits(s), s);
  c.dc_pred += s;
  blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al_);
}

void Decoder::decode_block_dc_refine(int16_t* blk) {
  if (get_bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
}

void Decoder::decode_block_ac_first(Component& c, int16_t* blk) {
  if (c.eob_run > 0) {
    --c.eob_run;
    return;
  }
  const Huffman& ac = ac_[c.ac_tbl];
  for (int k = ss_; k <= se_; ++k) {
    int rs = decode_huff(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kNaturalOrder[k]] =
          static_cast<int16_t>(static_cast<unsigned>(extend(get_bits(s), s)) << al_);
    } else {
      if (r == 15) {
        k += 15;
      } else {
        c.eob_run = 1 << r;
        if (r) c.eob_run += get_bits(r);
        --c.eob_run;
        break;
      }
    }
  }
}

void Decoder::decode_block_ac_refine(Component& c, int16_t* blk) {
  const int p1 = 1 << al_;
  const int m1 = -1 * (1 << al_);
  const Huffman& ac = ac_[c.ac_tbl];
  int k = ss_;
  if (c.eob_run == 0) {
    for (; k <= se_; ++k) {
      int rs = decode_huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bit() ? p1 : m1;
      } else if (r != 15) {
        c.eob_run = 1 << r;
        if (r) c.eob_run += get_bits(r);
        break;
      }
      do {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef != 0) {
          if (get_bit() && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= se_);
      if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
    }
  }
  if (c.eob_run > 0) {
    for (; k <= se_; ++k) {
      int16_t* coef = blk + kNaturalOrder[k];
      if (*coef != 0 && get_bit() && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    --c.eob_run;
  }
}

void Decoder::decode_block(Component& c, int16_t* blk) {
  if (arithmetic) {
    if (!progressive)
      arith_block_sequential(c, blk);
    else if (ss_ == 0)
      ah_ == 0 ? arith_block_dc_first(c, blk) : arith_block_dc_refine(blk);
    else
      ah_ == 0 ? arith_block_ac_first(c, blk) : arith_block_ac_refine(c, blk);
    return;
  }
  if (!progressive) {
    decode_block_sequential(c, blk);
  } else if (ss_ == 0) {
    if (ah_ == 0)
      decode_block_dc_first(c, blk);
    else
      decode_block_dc_refine(blk);
  } else if (ah_ == 0) {
    decode_block_ac_first(c, blk);
  } else {
    decode_block_ac_refine(c, blk);
  }
}

void Decoder::decode_scan() {
  reset_bits();
  next_restart_ = 0;
  for (int i = 0; i < ncomp; ++i) {
    comp[i].dc_pred = 0;
    comp[i].eob_run = 0;
  }
  if (arithmetic) arith_reset_scan_stats();  // jdarith.c start_pass
  insufficient_ = false;
  int restarts_left = restart_interval_;
  // one MCU, unless the Huffman data already ran out in this segment (the
  // arithmetic decoder reads zeros to the end instead, jdarith.c)
  auto mcu = [&](auto&& blocks) {
    if (insufficient_) return;
    blocks();
    if (!arithmetic && past_data()) insufficient_ = true;
  };
  // an iMCU row that starts with data left counts as good (libjpeg-turbo 3.1.3's
  // rows past it are smoothed with the progression status before this scan)
  auto row_start = [&](int imcu) {
    if (!insufficient_) last_good_imcu_ = imcu;
  };
  auto mcu_boundary = [&]() {
    if (restart_interval_) {
      if (restarts_left == 0) {
        restart();
        restarts_left = restart_interval_;
      }
      --restarts_left;
    }
  };
  if (scan_n_ == 1) {  // non-interleaved: the component's own blocks in raster order
    Component& c = comp[scan_comp_[0]];
    for (int by = 0; by < c.height_in_blocks; ++by) {
      if (by % c.v == 0) row_start(by / c.v);
      for (int bx = 0; bx < c.width_in_blocks; ++bx) {
        mcu_boundary();
        mcu([&] { decode_block(c, &c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64]); });
      }
    }
  } else {
    for (int my = 0; my < mcus_y_; ++my) {
      row_start(my);
      for (int mx = 0; mx < mcus_x_; ++mx) {
        mcu_boundary();
        mcu([&] {
          for (int i = 0; i < scan_n_; ++i) {
            Component& c = comp[scan_comp_[i]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                const size_t bx = static_cast<size_t>(mx) * c.h + x;
                const size_t by = static_cast<size_t>(my) * c.v + y;
                decode_block(c, &c.coef[(by * c.blocks_w + bx) * 64]);
              }
          }
        });
      }
    }
  }
  // to the next marker
  while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0 &&
                            !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7)))
    ++pos_;
}

void Decoder::decode_scans() {
  fake_eoi_ = true;
  for (;;) {
    int m;
    try {
      m = next_marker();
    } catch (const JpegError&) {
      if (pos_ < n_) throw;
      break;  // the data ends between markers: libjpeg's memory source reads an EOI there
    }
    if (m == 0xDA) {
      read_sos();
      decode_scan();
    } else if (m == 0xD9) {
      break;
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      read_dri();
    } else if (m == 0xCC) {
      read_dac();
    } else if (m >= 0xD0 && m <= 0xD7) {
      // stray restart marker
    } else if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
      throw JpegError("Invalid JPEG file structure: two SOF markers");
    } else {
      skip_segment();
    }
    if (pos_ >= n_) break;  // no EOI: libjpeg warns and ends the image
  }
  for (int i = 0; i < ncomp; ++i)
    if (comp[i].coef.empty()) comp[i].coef.assign(static_cast<size_t>(comp[i].blocks_w) * comp[i].blocks_h * 64, 0);
}

// ---------------------------------------------------------- block smoothing
// jdcoefct.c (libjpeg-turbo 2.1 and later; PIL 12.1.0 bundles 3.1.3):
// a progressive image whose low AC coefficients are not all known to full
// precision is output through decompress_smooth_data, which estimates the
// coefficients AC01, AC10, AC20, AC11, AC02 (and, when only DC is known,
// also AC03, AC12, AC21, AC30 and the DC itself) of each block that are
// still zero from the DC values of its 5x5 neighbourhood.

// zigzag k = 1..9 -> natural position, and the quantiser positions Q01 ... Q30
constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// smoothing_ok: every component scanned with a quantiser whose DC and first nine
// AC entries are nonzero, and some of those AC coefficients not known exactly;
// latches the progression status (cur) and, for rows the last scan did not
// complete with real data, the status before it (prev)
bool Decoder::smoothing_ok(int (*cur)[10], int (*prev)[10]) const {
  if (!progressive) return false;
  bool useful = false;
  for (int ci = 0; ci < ncomp; ++ci) {
    const Component& c = comp[ci];
    if (!c.quant_latched) return false;
    for (int k = 0; k < 10; ++k)
      if (c.quant[kSmoothPos[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    cur[ci][0] = c.coef_bits[0];
    for (int k = 1; k < 10; ++k) {
      prev[ci][k] = scans_ > 1 ? c.prev_bits[k] : -1;
      cur[ci][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// the prediction of one coefficient from `num` = Q00 * (the DC kernel's sum),
// with the coefficient's quantiser q, limited to what its Al bits can hold
inline int16_t predict(long long num, long long q, int al) {
  int pred;
  if (num >= 0) {
    pred = static_cast<int>(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = static_cast<int>(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return static_cast<int16_t>(pred);
}

// the blocks of component block row `by`, smoothed, into `out` (64 a block)
void Decoder::smooth_row(const Component& c, int by, const int* bits, int16_t* out) const {
  const int total = mcus_y_, last = total - 1;
  const int imcu = by / c.v, block_row = by % c.v;
  // decompress_smooth_data counts the block rows of the last iMCU row as that
  // row's own (height_in_blocks % v) in both of these
  int block_rows = c.v;
  if (imcu >= last && c.height_in_blocks % c.v) block_rows = c.height_in_blocks % c.v;
  const int image_block_rows = block_rows * total;
  const int image_block_row = imcu * block_rows + block_row;
  auto row = [&](int y) { return &c.coef[static_cast<size_t>(y) * c.blocks_w * 64]; };
  const int16_t* cur = row(by);
  const int16_t* prev = image_block_row > 0 ? row(by - 1) : cur;
  const int16_t* prev2 = image_block_row > 1 ? row(by - 2) : prev;
  const int16_t* next = image_block_row < image_block_rows - 1 ? row(by + 1) : cur;
  const int16_t* next2 = image_block_row < image_block_rows - 2 ? row(by + 2) : next;
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                         bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                         bits[9] == -1;
  const long long Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16],
                  Q11 = c.quant[9], Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10],
                  Q21 = c.quant[17], Q30 = c.quant[24];
  // the 5x5 DC values, DC01..DC25 row by row, in sliding registers
  int d[26];
  for (int k = 1; k <= 5; ++k) d[k] = prev2[0];
  for (int k = 6; k <= 10; ++k) d[k] = prev[0];
  for (int k = 11; k <= 15; ++k) d[k] = cur[0];
  for (int k = 16; k <= 20; ++k) d[k] = next[0];
  for (int k = 21; k <= 25; ++k) d[k] = next2[0];
  const int last_col = c.width_in_blocks - 1;
  const int16_t* rows[5] = {prev2, prev, cur, next, next2};
  for (int bx = 0; bx <= last_col; ++bx) {
    int16_t* ws = out + static_cast<size_t>(bx) * 64;
    std::memcpy(ws, cur + static_cast<size_t>(bx) * 64, 64 * sizeof(int16_t));
    if (bx == 0 && bx < last_col)
      for (int r = 0; r < 5; ++r) d[5 * r + 4] = rows[r][(bx + 1) * 64];
    if (bx + 1 < last_col)
      for (int r = 0; r < 5; ++r) d[5 * r + 5] = rows[r][(bx + 2) * 64];
    int al;
    long long num;
    if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
      num = Q00 * (change_dc
                       ? (-d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] +
                          3 * d[10] - 3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] -
                          3 * d[16] + 13 * d[17] - 13 * d[19] + 3 * d[20] - d[21] - d[22] +
                          d[24] + d[25])
                       : (-7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]));
      ws[1] = predict(num, Q01, al);
    }
    if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
      num = Q00 * (change_dc
                       ? (-d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] +
                          38 * d[8] + 13 * d[9] - d[10] + d[16] - 13 * d[17] - 38 * d[18] -
                          13 * d[19] + d[20] + d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] + d[25])
                       : (-7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]));
      ws[8] = predict(num, Q10, al);
    }
    if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
      num = Q00 * (change_dc
                       ? (d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] -
                          5 * d[14] + 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23])
                       : (-d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]));
      ws[16] = predict(num, Q20, al);
    }
    if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
      num = Q00 * (change_dc
                       ? (-d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] -
                          d[25])
                       : (d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] -
                          d[24] + d[4] - d[6] + 10 * d[7] - 10 * d[9]));
      ws[9] = predict(num, Q11, al);
    }
    if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
      num = Q00 * (change_dc
                       ? (2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] +
                          7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19])
                       : (-d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]));
      ws[2] = predict(num, Q02, al);
    }
    if (change_dc) {
      if ((al = bits[6]) != 0 && ws[3] == 0) {  // AC03
        num = Q00 * (d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
        ws[3] = predict(num, Q03, al);
      }
      if ((al = bits[7]) != 0 && ws[10] == 0) {  // AC12
        num = Q00 * (d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
        ws[10] = predict(num, Q12, al);
      }
      if ((al = bits[8]) != 0 && ws[17] == 0) {  // AC21
        num = Q00 * (d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
        ws[17] = predict(num, Q21, al);
      }
      if ((al = bits[9]) != 0 && ws[24] == 0) {  // AC30
        num = Q00 * (d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
        ws[24] = predict(num, Q30, al);
      }
      // the DC itself, a 5x5 kernel summing to 256 (no Al limit)
      num = Q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] + 6 * d[7] +
                   42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] + 152 * d[13] +
                   42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
                   6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]);
      ws[0] = predict(num, Q00, 0);
    }
    for (int r = 0; r < 5; ++r)  // the registers move one column on
      for (int k = 1; k <= 4; ++k) d[5 * r + k] = d[5 * r + k + 1];
  }
}

// ------------------------------------------------- arithmetic decoding

void Decoder::read_dac() {  // jdmarker.c get_dac
  int len = word() - 2;
  while (len > 0) {
    int index = byte(), val = byte();
    len -= 2;
    if (index >= 2 * kArithTables) throw JpegError("Bogus DAC index " + std::to_string(index));
    if (index >= kArithTables) {
      dac_k_[index - kArithTables] = static_cast<uint8_t>(val);
    } else {
      dac_l_[index] = static_cast<uint8_t>(val & 0x0F);
      dac_u_[index] = static_cast<uint8_t>(val >> 4);
      if (dac_l_[index] > dac_u_[index]) throw JpegError("Bogus DAC value " + hex2(val));
    }
  }
  if (len != 0) throw JpegError("Bogus marker length");
}

void Decoder::arith_reset_scan_stats() {
  // the bins of the scan's tables and its DC predictions to zero, the coder
  // to read two fresh bytes (start_pass / process_restart)
  for (int i = 0; i < scan_n_; ++i) {
    Component& c = comp[scan_comp_[i]];
    if (!progressive || (ss_ == 0 && ah_ == 0)) {
      std::memset(dc_stats_[c.dc_tbl], 0, kDcStatBins);
      c.dc_pred = 0;
      c.dc_context = 0;
    }
    if (!progressive || ss_ != 0) std::memset(ac_stats_[c.ac_tbl], 0, kAcStatBins);
  }
  ar_c_ = 0;
  ar_a_ = 0;
  ar_ct_ = -16;
  hit_marker_ = false;
}

int Decoder::arith_byte() {
  // a byte of the entropy-coded segment: 0xFF 0x00 is 0xFF; a marker (or the
  // end of the data, where libjpeg's memory source inserts an EOI) gives
  // zeros from there on and stays unread
  if (hit_marker_) return 0;
  if (pos_ >= n_) {
    hit_marker_ = true;
    return 0;
  }
  int data = d_[pos_++];
  if (data != 0xFF) return data;
  long p = pos_;
  while (p < n_ && d_[p] == 0xFF) ++p;  // extra 0xFF bytes
  if (p < n_ && d_[p] == 0) {
    pos_ = p + 1;
    return 0xFF;
  }
  pos_ = p - 1;  // at the marker's last 0xFF
  hit_marker_ = true;
  return 0;
}

int Decoder::arith_decode(uint8_t* st) {
  // jdarith.c arith_decode: renormalisation and data input (T.81 D.2.6), then
  // the decision and the probability estimate (D.2.4, D.2.5)
  while (ar_a_ < 0x8000) {
    if (--ar_ct_ < 0) {
      ar_c_ = (ar_c_ << 8) | arith_byte();
      if ((ar_ct_ += 8) < 0)
        if (++ar_ct_ == 0) ar_a_ = 0x8000;  // two initial bytes read: A is 0x10000 below
    }
    ar_a_ <<= 1;
  }
  int sv = *st;
  int64_t qe = kAritab[sv & 0x7F];
  const int nl = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  const int nm = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  int64_t temp = ar_a_ - qe;
  ar_a_ = temp;
  temp <<= ar_ct_;
  if (ar_c_ >= temp) {
    ar_c_ -= temp;
    if (ar_a_ < qe) {  // conditional LPS exchange
      ar_a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    } else {
      ar_a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (ar_a_ < 0x8000) {  // conditional MPS exchange
    if (ar_a_ < qe) {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

int Decoder::arith_dc_diff(Component& c) {
  // T.81 F.19, F.21-F.24: the DC difference, and the next context (F.1.4.4.1.2);
  // a magnitude overflow sets ct to -1 and returns 0
  uint8_t* stats = dc_stats_[c.dc_tbl];
  uint8_t* st = stats + c.dc_context;
  if (arith_decode(st) == 0) {
    c.dc_context = 0;
    return 0;
  }
  const int sign = arith_decode(st + 1);
  st += 2 + sign;
  int m = arith_decode(st);
  if (m != 0) {
    st = stats + 20;  // X1
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) {
        ar_ct_ = -1;
        return 0;
      }
      st += 1;
    }
  }
  if (m < static_cast<int>((1L << dac_l_[c.dc_tbl]) >> 1))
    c.dc_context = 0;
  else if (m > static_cast<int>((1L << dac_u_[c.dc_tbl]) >> 1))
    c.dc_context = 12 + sign * 4;
  else
    c.dc_context = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

int Decoder::arith_ac_value(uint8_t* st, int k, int tbl) {
  // F.21-F.24 for an AC coefficient known to be nonzero (`st` at its bins);
  // 0 with ct -1 on a magnitude overflow
  const int sign = arith_decode(fixed_bin_);
  st += 2;
  int m = arith_decode(st);
  if (m != 0 && arith_decode(st)) {
    m <<= 1;
    st = ac_stats_[tbl] + (k <= dac_k_[tbl] ? 189 : 217);
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) {
        ar_ct_ = -1;
        return 0;
      }
      st += 1;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

void Decoder::arith_block_sequential(Component& c, int16_t* blk) {
  if (ar_ct_ == -1) return;
  const int diff = arith_dc_diff(c);
  if (ar_ct_ == -1) return;
  c.dc_pred = (c.dc_pred + diff) & 0xFFFF;
  blk[0] = static_cast<int16_t>(c.dc_pred);
  const int tbl = c.ac_tbl;
  for (int k = 1; k <= 63; ++k) {
    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
    if (arith_decode(st)) break;  // EOB
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > 63) {
        ar_ct_ = -1;  // spectral overflow
        return;
      }
    }
    const int v = arith_ac_value(st, k, tbl);
    if (ar_ct_ == -1) return;
    blk[kNaturalOrder[k]] = static_cast<int16_t>(v);
  }
}

void Decoder::arith_block_dc_first(Component& c, int16_t* blk) {
  if (ar_ct_ == -1) return;
  const int diff = arith_dc_diff(c);
  if (ar_ct_ == -1) return;
  c.dc_pred += diff;
  blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al_);
}

void Decoder::arith_block_dc_refine(int16_t* blk) {
  if (arith_decode(fixed_bin_)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
}

void Decoder::arith_block_ac_first(Component& c, int16_t* blk) {
  if (ar_ct_ == -1) return;
  const int tbl = c.ac_tbl;
  for (int k = ss_; k <= se_; ++k) {
    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
    if (arith_decode(st)) break;  // EOB
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > se_) {
        ar_ct_ = -1;
        return;
      }
    }
    const int v = arith_ac_value(st, k, tbl);
    if (ar_ct_ == -1) return;
    blk[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al_);
  }
}

void Decoder::arith_block_ac_refine(Component& c, int16_t* blk) {
  if (ar_ct_ == -1) return;
  const int tbl = c.ac_tbl;
  const int p1 = 1 << al_;
  const int m1 = -1 * (1 << al_);
  int kex = se_;  // the previous stage's end of block
  for (; kex > 0; --kex)
    if (blk[kNaturalOrder[kex]]) break;
  for (int k = ss_; k <= se_; ++k) {
    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
    if (k > kex && arith_decode(st)) break;  // EOB
    for (;;) {
      int16_t* coef = blk + kNaturalOrder[k];
      if (*coef) {  // nonzero before: one correction bit
        if (arith_decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (arith_decode(st + 1)) {  // newly nonzero
        *coef = static_cast<int16_t>(arith_decode(fixed_bin_) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se_) {
        ar_ct_ = -1;
        return;
      }
    }
  }
}

// ------------------------------------------------------------------ IDCT
using Jlong = int64_t;
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int kRangeMask = 1023;
inline Jlong fix(double x) { return static_cast<Jlong>(x * (1L << kConstBits) + 0.5); }
inline Jlong descale(Jlong x, int n) { return (x + (static_cast<Jlong>(1) << (n - 1))) >> n; }

struct RangeLimit {
  // libjpeg's post-IDCT table (jdmaster.c prepare_range_limit_table),
  // indexed by (value & 1023) with value centred on 0
  uint8_t idct[1024];
  RangeLimit() {
    for (int k = 0; k < 1024; ++k) {
      if (k < 128) idct[k] = static_cast<uint8_t>(k + 128);
      else if (k < 512) idct[k] = 255;
      else if (k < 896) idct[k] = 0;
      else idct[k] = static_cast<uint8_t>(k - 896);
    }
  }
};
const RangeLimit kRange;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// The 8x8, 4x4 and 2x2 IDCTs follow libjpeg-turbo's x86 SIMD ones
// (jidctint-avx2.asm / -sse2.asm, jidctred-sse2.asm), which the JAX route's
// libjpeg-turbo runs, down to their integer widths: the dequantisation is a
// 16-bit product (pmullw), some sums are 16-bit (paddw), the products are
// pairs summed in 32 bits (pmaddwd) and added with 32-bit wrap (paddd), the
// first pass is stored saturated to int16 (packssdw; the 2x2 keeps it in 32
// bits), and the output is
// saturated to [-128, 127] and centred (packsswb, paddb 128). Where no value
// leaves its range this is jidctint.c / jidctred.c bit for bit; only corrupt
// data (a cut file's zeros) reaches the wraps and saturations. The 1x1 IDCT
// has no SIMD version: C, with the range-limit table.
inline int16_t deq(int16_t coef, uint16_t q) {
  return static_cast<int16_t>(static_cast<uint16_t>(static_cast<int32_t>(coef) * q));
}
inline int16_t add16(int a, int b) { return static_cast<int16_t>(static_cast<uint16_t>(a + b)); }
inline int16_t sat16(int32_t v) {
  return static_cast<int16_t>(v > 32767 ? 32767 : (v < -32768 ? -32768 : v));
}
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
// pmaddwd: two int16 products summed (exact in 32 bits)
inline int32_t madd(int16_t a, int ca, int16_t b, int cb) {
  return static_cast<int32_t>(a) * ca + static_cast<int32_t>(b) * cb;
}
// psrad after adding the rounding constant (paddd)
inline int32_t descale32(int32_t x, int n) { return add32(x, 1 << (n - 1)) >> n; }
// packssdw, packsswb, paddb CENTERJSAMP
inline uint8_t out8(int32_t v) {
  int s = sat16(v);
  s = s > 127 ? 127 : (s < -128 ? -128 : s);
  return static_cast<uint8_t>(s + 128);
}
inline int32_t widen_shift(int16_t v, int n) { return static_cast<int32_t>(v) * (1 << n); }

// one 8-point islow IDCT of `in` (the SIMD order of operations), before descaling
void islow_1d(const int16_t* in, int32_t* out) {
  const int F0_298 = static_cast<int>(fix(0.298631336)), F0_390 = static_cast<int>(fix(0.390180644)),
            F0_541 = static_cast<int>(fix(0.541196100)), F0_765 = static_cast<int>(fix(0.765366865)),
            F0_899 = static_cast<int>(fix(0.899976223)), F1_175 = static_cast<int>(fix(1.175875602)),
            F1_501 = static_cast<int>(fix(1.501321110)), F1_847 = static_cast<int>(fix(1.847759065)),
            F1_961 = static_cast<int>(fix(1.961570560)), F2_053 = static_cast<int>(fix(2.053119869)),
            F2_562 = static_cast<int>(fix(2.562915447)), F3_072 = static_cast<int>(fix(3.072711026));
  // even part
  const int32_t tmp3 = madd(in[2], F0_541 + F0_765, in[6], F0_541);
  const int32_t tmp2 = madd(in[2], F0_541, in[6], F0_541 - F1_847);
  const int32_t tmp0 = widen_shift(add16(in[0], in[4]), kConstBits);
  const int32_t tmp1 = widen_shift(add16(in[0], -in[4]), kConstBits);
  const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  // odd part: t0..t3 = in7, in5, in3, in1
  const int16_t z3 = add16(in[7], in[3]), z4 = add16(in[5], in[1]);
  const int32_t Z3 = madd(z3, F1_175 - F1_961, z4, F1_175);
  const int32_t Z4 = madd(z3, F1_175, z4, F1_175 - F0_390);
  const int32_t T0 = add32(madd(in[7], F0_298 - F0_899, in[1], -F0_899), Z3);
  const int32_t T3 = add32(madd(in[7], -F0_899, in[1], F1_501 - F0_899), Z4);
  const int32_t T1 = add32(madd(in[5], F2_053 - F2_562, in[3], -F2_562), Z4);
  const int32_t T2 = add32(madd(in[5], -F2_562, in[3], F3_072 - F2_562), Z3);
  out[0] = add32(tmp10, T3);
  out[7] = sub32(tmp10, T3);
  out[1] = add32(tmp11, T2);
  out[6] = sub32(tmp11, T2);
  out[2] = add32(tmp12, T1);
  out[5] = sub32(tmp12, T1);
  out[3] = add32(tmp13, T0);
  out[4] = sub32(tmp13, T0);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];  // pass 1's int16 workspace, row-major
  bool ac_zero = true;  // rows 1..7 of the whole block (the SIMD tests all columns at once)
  for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
  for (int c = 0; c < 8; ++c) {
    if (ac_zero) {  // psllw: a 16-bit shift of the dequantised DC
      const int16_t dc = static_cast<int16_t>(static_cast<uint16_t>(deq(in[c], q[c])) << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
      continue;
    }
    int16_t col[8];
    int32_t t[8];
    for (int r = 0; r < 8; ++r) col[r] = deq(in[8 * r + c], q[8 * r + c]);
    islow_1d(col, t);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16(descale32(t[r], kConstBits - kPass1Bits));
  }
  for (int r = 0; r < 8; ++r) {
    int32_t t[8];
    islow_1d(ws + 8 * r, t);
    uint8_t* op = out + static_cast<long>(r) * stride;
    for (int c = 0; c < 8; ++c) op[c] = out8(descale32(t[c], kConstBits + kPass1Bits + 3));
  }
}

// the 4-point IDCT of jidctred.c on in[0..7] (in[4] unused), before descaling
void idct4_1d(const int16_t* in, int32_t* out) {
  const int F0_211 = static_cast<int>(fix(0.211164243)), F0_509 = static_cast<int>(fix(0.509795579)),
            F0_601 = static_cast<int>(fix(0.601344887)), F0_765 = static_cast<int>(fix(0.765366865)),
            F0_899 = static_cast<int>(fix(0.899976223)), F1_061 = static_cast<int>(fix(1.061594337)),
            F1_451 = static_cast<int>(fix(1.451774981)), F1_847 = static_cast<int>(fix(1.847759065)),
            F2_172 = static_cast<int>(fix(2.172734803)), F2_562 = static_cast<int>(fix(2.562915447));
  const int32_t tmp0 = widen_shift(in[0], kConstBits + 1);
  const int32_t tmp2 = madd(in[2], F1_847, in[6], -F0_765);
  const int32_t tmp10 = add32(tmp0, tmp2), tmp12 = sub32(tmp0, tmp2);
  const int32_t o0 = add32(madd(in[7], -F0_211, in[5], F1_451), madd(in[3], -F2_172, in[1], F1_061));
  const int32_t o2 = add32(madd(in[7], -F0_509, in[5], -F0_601), madd(in[3], F0_899, in[1], F2_562));
  out[0] = add32(tmp10, o2);
  out[3] = sub32(tmp10, o2);
  out[1] = add32(tmp12, o0);
  out[2] = sub32(tmp12, o0);
}

void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int16_t ws[32];  // 4 rows of 8 (column 4 unused)
  bool ac_zero = true;  // rows 1, 2, 3, 5, 6, 7 (jidctred-sse2.asm's zero-column test)
  for (int r = 1; r < 8 && ac_zero; ++r)
    for (int c = 0; c < 8 && ac_zero && r != 4; ++c) ac_zero = in[8 * r + c] == 0;
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;
    if (ac_zero) {
      const int16_t dc = static_cast<int16_t>(static_cast<uint16_t>(deq(in[c], q[c])) << kPass1Bits);
      for (int r = 0; r < 4; ++r) ws[8 * r + c] = dc;
      continue;
    }
    int16_t col[8];
    int32_t t[4];
    for (int r = 0; r < 8; ++r) col[r] = deq(in[8 * r + c], q[8 * r + c]);
    idct4_1d(col, t);
    for (int r = 0; r < 4; ++r) ws[8 * r + c] = sat16(descale32(t[r], kConstBits - kPass1Bits + 1));
  }
  for (int r = 0; r < 4; ++r) {
    int32_t t[4];
    idct4_1d(ws + 8 * r, t);
    uint8_t* op = out + static_cast<long>(r) * stride;
    for (int c = 0; c < 4; ++c) op[c] = out8(descale32(t[c], kConstBits + kPass1Bits + 3 + 1));
  }
}

inline int32_t mul32(int32_t a, int c) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(c));
}

// the 2-point IDCT of jidctred.c on in[0], in[1], in[3], in[5], in[7], before
// descaling, in 32-bit wrapping arithmetic: the 2x2 keeps its first pass in 32
// bits (no int16 pack between the passes; seen on a cut file's DC of 16,595)
void idct2_1d(const int32_t* in, int32_t* out) {
  const int F0_720 = static_cast<int>(fix(0.720959822)), F0_850 = static_cast<int>(fix(0.850430095)),
            F1_272 = static_cast<int>(fix(1.272758580)), F3_624 = static_cast<int>(fix(3.624509785));
  const int32_t tmp10 = mul32(in[0], 1 << (kConstBits + 2));
  const int32_t tmp0 = add32(add32(mul32(in[1], F3_624), mul32(in[3], -F1_272)),
                             add32(mul32(in[5], F0_850), mul32(in[7], -F0_720)));
  out[0] = add32(tmp10, tmp0);
  out[1] = sub32(tmp10, tmp0);
}

void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[16];  // 2 rows of 8 (columns 2, 4, 6 unused)
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    int32_t col[8];
    int32_t t[2];
    for (int r = 0; r < 8; ++r) col[r] = deq(in[8 * r + c], q[8 * r + c]);
    idct2_1d(col, t);
    for (int r = 0; r < 2; ++r) ws[8 * r + c] = descale32(t[r], kConstBits - kPass1Bits + 2);
  }
  for (int r = 0; r < 2; ++r) {
    int32_t t[2];
    idct2_1d(ws + 8 * r, t);
    uint8_t* op = out + static_cast<long>(r) * stride;
    for (int c = 0; c < 2; ++c) op[c] = out8(descale32(t[c], kConstBits + kPass1Bits + 3 + 2));
  }
}

void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
  int dc = static_cast<int>(static_cast<Jlong>(in[0]) * q[0]);
  dc = static_cast<int>(descale(dc, 3));
  out[0] = kRange.idct[dc & kRangeMask];
}

// ------------------------------------------------------- colour tables
struct YccTables {
  int cr_r[256], cb_b[256];
  Jlong cr_g[256], cb_g[256];
  YccTables() {
    const int scalebits = 16;
    const Jlong one_half = static_cast<Jlong>(1) << (scalebits - 1);
    auto fx = [](double x) { return static_cast<Jlong>(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fx(1.40200) * x + one_half) >> scalebits);
      cb_b[i] = static_cast<int>((fx(1.77200) * x + one_half) >> scalebits);
      cr_g[i] = (-fx(0.71414)) * x;
      cb_g[i] = (-fx(0.34414)) * x + one_half;
    }
  }
};
const YccTables kYcc;

// A component's samples at output scale, after libjpeg's upsampling.
struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[static_cast<size_t>(y) * w + x]; }
};

long div_up(long a, long b) { return (a + b - 1) / b; }

Decoder::ColorSpace Decoder::color_space() const {
  if (ncomp == 1) return kGray;
  if (ncomp == 3) {
    if (saw_jfif) return kYCbCr;
    if (saw_adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return kRGB;  // 'R' 'G' 'B'
    return kYCbCr;
  }
  if (ncomp == 4) return saw_adobe ? (adobe_transform == 0 ? kCMYK : kYCCK) : kCMYK;
  throw JpegError("Bogus number of components");
}

void Decoder::check_conversion(int space) const {
  const ColorSpace cs = color_space();
  if (space < 0 || space > 2 || (space == 0 && !(cs == kGray || cs == kYCbCr || cs == kRGB)) ||
      (space == 1 && cs != kGray) || (space == 2 && !(cs == kCMYK || cs == kYCCK)))
    throw JpegError("Unsupported color conversion request");
}

void Decoder::output(int denom, int space, uint8_t* out, long cap, int* out_h, int* out_w) {
  if (denom != 1 && denom != 2 && denom != 4 && denom != 8) throw JpegError("Bogus scale");
  check_conversion(space);
  const ColorSpace cs = color_space();
  const int channels = space == 0 ? 3 : (space == 1 ? 1 : 4);
  const int ow = static_cast<int>(div_up(width, denom));
  const int oh = static_cast<int>(div_up(height, denom));
  if (static_cast<long>(ow) * oh * channels > cap) throw JpegError("output buffer too small");

  int cur_bits[kMaxComponents][10], prev_bits[kMaxComponents][10];
  const bool smooth = smoothing_ok(cur_bits, prev_bits);
  // each component's IDCT size (jdmaster.c: chroma scaled up by the IDCT where it can)
  const int smin = 8 / denom;
  Plane up[kMaxComponents];
  for (int ci = 0; ci < ncomp; ++ci) {
    Component& c = comp[ci];
    int s = smin;
    while (s < 8 && (hmax * smin) % (c.h * s * 2) == 0 && (vmax * smin) % (c.v * s * 2) == 0)
      s *= 2;
    void (*idct)(const int16_t*, const uint16_t*, uint8_t*, int) =
        s == 8 ? idct_islow : (s == 4 ? idct_4x4 : (s == 2 ? idct_2x2 : idct_1x1));
    Plane p;
    p.w = c.width_in_blocks * s;
    p.h = c.height_in_blocks * s;
    p.px.assign(static_cast<size_t>(p.w) * p.h, 0);
    std::vector<int16_t> smoothed(smooth ? static_cast<size_t>(c.width_in_blocks) * 64 : 0);
    for (int by = 0; by < c.height_in_blocks; ++by) {
      const int16_t* blocks = &c.coef[static_cast<size_t>(by) * c.blocks_w * 64];
      if (smooth) {  // rows after the last scan's last good iMCU row: the status before it
        smooth_row(c, by, by / c.v > last_good_imcu_ ? prev_bits[ci] : cur_bits[ci],
                   smoothed.data());
        blocks = smoothed.data();
      }
      for (int bx = 0; bx < c.width_in_blocks; ++bx)
        idct(blocks + static_cast<size_t>(bx) * 64, c.quant,
             &p.px[static_cast<size_t>(by) * s * p.w + static_cast<size_t>(bx) * s], p.w);
    }
    // upsampling (jdsample.c jinit_upsampler)
    const int dw = static_cast<int>(div_up(static_cast<long>(width) * c.h * s, hmax * 8L));
    const int dh = static_cast<int>(div_up(static_cast<long>(height) * c.v * s, vmax * 8L));
    const int h_in = c.h * s / smin, v_in = c.v * s / smin;
    const bool fancy_ok = smin > 1;
    Plane& u = up[ci];
    u.w = ow;
    u.h = oh;
    u.px.assign(static_cast<size_t>(ow) * oh, 0);
    auto row_at = [&](int y) { return y < 0 ? 0 : (y >= dh ? dh - 1 : y); };
    if (h_in == hmax && v_in == vmax) {
      for (int y = 0; y < oh; ++y)
        std::memcpy(&u.px[static_cast<size_t>(y) * ow], &p.px[static_cast<size_t>(y) * p.w], ow);
    } else if (h_in * 2 == hmax && v_in == vmax && fancy_ok && dw > 2) {  // h2v1 fancy
      std::vector<uint8_t> row(2 * static_cast<size_t>(dw));
      for (int y = 0; y < oh; ++y) {
        const uint8_t* in = &p.px[static_cast<size_t>(y) * p.w];
        row[0] = in[0];
        row[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          const int v3 = in[x] * 3;
          row[2 * x] = static_cast<uint8_t>((v3 + in[x - 1] + 1) >> 2);
          row[2 * x + 1] = static_cast<uint8_t>((v3 + in[x + 1] + 2) >> 2);
        }
        row[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        row[2 * dw - 1] = in[dw - 1];
        std::memcpy(&u.px[static_cast<size_t>(y) * ow], row.data(), ow);
      }
    } else if (h_in == hmax && v_in * 2 == vmax && fancy_ok) {  // h1v2 fancy
      for (int y = 0; y < oh; ++y) {
        const int yi = y / 2;
        const bool below = y & 1;
        const uint8_t* in0 = &p.px[static_cast<size_t>(row_at(yi)) * p.w];
        const uint8_t* in1 = &p.px[static_cast<size_t>(row_at(below ? yi + 1 : yi - 1)) * p.w];
        const int bias = below ? 2 : 1;
        for (int x = 0; x < ow; ++x)
          u.px[static_cast<size_t>(y) * ow + x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else if (h_in * 2 == hmax && v_in * 2 == vmax && fancy_ok && dw > 2) {  // h2v2 fancy
      std::vector<uint8_t> row(2 * static_cast<size_t>(dw));
      for (int y = 0; y < oh; ++y) {
        const int yi = y / 2;
        const bool below = y & 1;
        const uint8_t* in0 = &p.px[static_cast<size_t>(row_at(yi)) * p.w];
        const uint8_t* in1 = &p.px[static_cast<size_t>(row_at(below ? yi + 1 : yi - 1)) * p.w];
        int thiscol = in0[0] * 3 + in1[0];
        int nextcol = in0[1] * 3 + in1[1];
        row[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
        row[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < dw - 1; ++x) {
          nextcol = in0[x + 1] * 3 + in1[x + 1];
          row[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          row[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        row[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        row[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
        std::memcpy(&u.px[static_cast<size_t>(y) * ow], row.data(), ow);
      }
    } else if (hmax % h_in == 0 && vmax % v_in == 0) {  // replication
      const int hx = hmax / h_in, vx = vmax / v_in;
      for (int y = 0; y < oh; ++y) {
        const uint8_t* in = &p.px[static_cast<size_t>(y / vx) * p.w];
        for (int x = 0; x < ow; ++x) u.px[static_cast<size_t>(y) * ow + x] = in[x / hx];
      }
    } else {
      throw JpegError("Fractional sampling not implemented yet");
    }
  }

  // colour conversion (jdcolor.c)
  for (int y = 0; y < oh; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * ow * channels;
    const uint8_t* c0 = &up[0].px[static_cast<size_t>(y) * ow];
    if (space == 1) {
      std::memcpy(o, c0, ow);
      continue;
    }
    if (cs == kGray) {
      for (int x = 0; x < ow; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
      continue;
    }
    const uint8_t* c1 = &up[1].px[static_cast<size_t>(y) * ow];
    const uint8_t* c2 = &up[2].px[static_cast<size_t>(y) * ow];
    if (cs == kRGB) {
      for (int x = 0; x < ow; ++x) {
        o[3 * x] = c0[x];
        o[3 * x + 1] = c1[x];
        o[3 * x + 2] = c2[x];
      }
    } else if (cs == kYCbCr) {
      for (int x = 0; x < ow; ++x) {
        const int yy = c0[x], cb = c1[x], cr = c2[x];
        o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
      }
    } else {
      const uint8_t* c3 = &up[3].px[static_cast<size_t>(y) * ow];
      for (int x = 0; x < ow; ++x) {
        uint8_t cmyk[4];
        if (cs == kCMYK) {
          cmyk[0] = c0[x];
          cmyk[1] = c1[x];
          cmyk[2] = c2[x];
        } else {  // YCCK -> CMYK
          const int yy = c0[x], cb = c1[x], cr = c2[x];
          cmyk[0] = clamp255(255 - (yy + kYcc.cr_r[cr]));
          cmyk[1] = clamp255(255 - (yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
          cmyk[2] = clamp255(255 - (yy + kYcc.cb_b[cb]));
        }
        cmyk[3] = c3[x];
        for (int k = 0; k < 4; ++k) o[4 * x + k] = static_cast<uint8_t>(255 - cmyk[k]);
      }
    }
  }
  *out_h = oh;
  *out_w = ow;
}

void write_msg(char* msg, int cap, const char* what) {
  if (msg && cap > 0) std::snprintf(msg, cap, "%s", what);
}

}  // namespace

extern "C" {

int dqvq_jpeg_port_header(const uint8_t* buf, long len, int* h, int* w, int* components,
                          char* msg, int msg_cap) {
  try {
    Decoder dec(buf, len);
    dec.read_header();
    *h = dec.height;
    *w = dec.width;
    *components = dec.ncomp;
    return 0;
  } catch (const std::exception& e) {
    write_msg(msg, msg_cap, e.what());
    return -1;
  }
}

int dqvq_jpeg_port_decode(const uint8_t* buf, long len, int denom, int space, uint8_t* out,
                          long out_cap, int* out_h, int* out_w, char* msg, int msg_cap) {
  try {
    Decoder dec(buf, len);
    dec.read_header();
    dec.check_conversion(space);
    dec.decode_scans();
    dec.output(denom, space, out, out_cap, out_h, out_w);
    return 0;
  } catch (const std::exception& e) {
    write_msg(msg, msg_cap, e.what());
    return -1;
  }
}

long dqvq_jpeg_port_coefficients(const uint8_t* buf, long len, int* dims, int16_t* out, long cap,
                                 char* msg, int msg_cap) {
  try {
    Decoder dec(buf, len);
    dec.read_header();
    dec.decode_scans();
    long n = 0;
    for (int i = 0; i < dec.ncomp; ++i) {
      const Component& c = dec.comp[i];
      dims[2 * i] = c.height_in_blocks;
      dims[2 * i + 1] = c.width_in_blocks;
      for (int by = 0; by < c.height_in_blocks; ++by)
        for (int bx = 0; bx < c.width_in_blocks; ++bx, n += 64)
          if (n + 64 <= cap)
            std::memcpy(out + n, &c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64],
                        64 * sizeof(int16_t));
    }
    return n;
  } catch (const std::exception& e) {
    write_msg(msg, msg_cap, e.what());
    return -1;
  }
}

}  // extern "C"
