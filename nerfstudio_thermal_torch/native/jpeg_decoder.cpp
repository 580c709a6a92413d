// Baseline and progressive JPEG decoder that computes what libjpeg(-turbo)
// gives with its default decompression settings, byte for byte:
//   - SOF0 / SOF1, Huffman coding, 8-bit samples, 1 or 3 components,
//     sampling factors 1-2 (4:4:4, 4:2:2, 4:2:0, 4:4:0) and any other
//     integral ratio (box replication), one or several sequential scans,
//     restart intervals; APPn and COM segments are skipped (no EXIF
//     rotation is applied);
//   - SOF2 (progressive, Huffman-coded) with the same samples, components
//     and samplings (jdphuff.c): DC first and refinement scans, AC
//     spectral selection with successive approximation and EOB runs,
//     restart intervals. The coefficients are kept for the whole image
//     and go through the same IDCT, upsampling and colour conversion once
//     the last scan is read. A progression that leaves one of the first
//     nine AC coefficients short of full precision is block-smoothed as
//     libjpeg-turbo's decompress_smooth_data does (jdcoefct.c: the missing
//     low AC coefficients estimated from the DC values of the 5 x 5 blocks
//     around, and the DC too where no AC coefficient arrived);
//   - 4 components: CMYK, or YCCK (an Adobe marker with transform 2, or
//     any transform but 0) converted to CMYK (jdcolor.c,
//     ycck_cmyk_convert), each sample then inverted as Pillow's "CMYK;I"
//     raw mode does;
//   - each component's quantization table latched at its first scan
//     (jdinput.c, latch_quant_tables);
//   - the accurate integer IDCT (jidctint.c, jpeg_idct_islow);
//   - fancy (triangle) upsampling for h2v1, h2v2 (jdsample.c; box
//     replication when the downsampled width is 2 or less, as there) and
//     h1v2;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c, and libjpeg's
//     choice of colour space (JFIF / Adobe markers, component ids).
//   - SOF9 / SOF10 (arithmetic coding, sequential and progressive;
//     jdarith.c): the QM decoder with ITU T.81's state table, DAC
//     conditioning, restart intervals;
//   - SOF3 (lossless, Huffman-coded; jdlhuff.c, jddiffct.c, jdlossls.c): predictors 1-7,
//     a point transform, restart intervals of whole MCU rows, subsampled
//     components (an interleaved scan's MCUs of h x v samples, replicated,
//     not fancy-upsampled, as libjpeg-turbo does without a DCT); the
//     samples then take the same colour conversion.
// Hierarchical frames, arithmetic-coded lossless ones and 12-bit samples
// return 1 with the marker named in the message.
//
// C interface (loaded with ctypes by data/jpeg.py):
//   int jpeg_decoder_abi_version();
//   int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out,
//                   size_t out_size, int* dims, char* err, int err_size);
//   int jpeg_decode_color(..., the same, int color);
// jpeg_decode_color sets the colour handling as libtiff's JPEG codec does
// for a JPEG-compressed TIFF strip: color 1 converts YCbCr to RGB
// (JPEGCOLORMODE_RGB), color 0 takes every component as it is (JCS_UNKNOWN:
// no conversion, a 4-component image not inverted), color 2 also
// replicates subsampled components instead of fancy-upsampling them (the
// planes libtiff's old-style JPEG codec hands its RGBA reader);
// jpeg_decode decides from the markers, as libjpeg does by default.
// dims receives {height, width, channels} (channels 1, 3 or 4). With out == nullptr only the
// header is read and dims filled. Returns 0 on success, 1 for an
// unsupported feature, 2 for a malformed stream or a too-small buffer.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string msg;
};

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // extra entries for a corrupt run past the end (as libjpeg)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // canonical decoding tables (jdhuff.c's maxcode / valoffset)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (code length << 8) | value, 0 where longer
  uint16_t look[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;  // table selectors of the current scan
  int blocks_w = 0, blocks_h = 0;  // allocated coefficient blocks
  int width = 0, height = 0;  // downsampled size in samples
  std::vector<int16_t> coefs;
  // lossless (SOF3): the reconstructed samples, before the point transform's shift
  std::vector<uint16_t> samples;
  int point_transform = 0;
  int dc_pred = 0;
  int dc_context = 0;  // arithmetic coding: the DC statistics' conditioning (F.1.4.4.1.2)
  uint16_t q[64];  // the quantization table, latched at the first scan
  bool q_latched = false;
  // per spectral position: the Al of the last scan that carried it, -1
  // before any did (jdphuff.c's coef_bits)
  int coef_bits[64];
  // coef_bits of positions 0-9 before the last scan that touched them
  // (jdphuff.c's second half of cinfo->coef_bits)
  int prev_coef_bits[10];
  Component() {
    std::fill(coef_bits, coef_bits + 64, -1);
    std::fill(prev_coef_bits, prev_coef_bits + 10, -1);
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : p_(data), end_(data + size) {}

  void header_only() { parse(false); }
  void decode() { parse(true); }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return static_cast<int>(comps_.size()); }
  void write(uint8_t* out) const;
  bool converts() const;
  void set_color(int color) { color_ = color; }

 private:
  // -1: libjpeg's default from the markers; 0: none; 1: YCbCr -> RGB; 2: none, and the chroma
  // replicated instead of fancy-upsampled
  int color_ = -1;
  const uint8_t* p_;
  const uint8_t* end_;
  int width_ = 0, height_ = 0;
  int hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  bool frame_seen_ = false, jfif_ = false, adobe_ = false, progressive_ = false, lossless_ = false;
  bool arith_ = false;  // SOF9 / SOF10: arithmetic coding (jdarith.c)
  // the arithmetic decoder: conditioning (DAC; defaults L 0, U 1, K 5),
  // statistics bins, the C / A registers and bit counter, the fixed bin
  uint8_t dc_l_[4] = {0, 0, 0, 0}, dc_u_[4] = {1, 1, 1, 1}, ac_k_[4] = {5, 5, 5, 5};
  uint8_t dc_stats_[4][64], ac_stats_[4][256], fixed_bin_ = 113;
  int64_t ac_c_ = 0, ac_a_ = 0;
  int ac_ct_ = -16;
  bool ac_marker_ = false;
  std::vector<Component*> scan_;
  int scan_ss_ = 0, scan_ah_ = 0;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int scans_ = 0;  // scans read so far (libjpeg's input_scan_number)
  int eobrun_ = 0;  // progressive AC scans: blocks left in the current EOB run
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;

  // bit reader state of the entropy-coded segment
  uint64_t bits_ = 0;
  int nbits_ = 0;
  bool hit_marker_ = false;

  [[noreturn]] static void fail(int code, const std::string& msg) { throw Error{code, msg}; }

  uint8_t byte() {
    if (p_ >= end_) fail(2, "unexpected end of data");
    return *p_++;
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void parse(bool decode_scans);
  void read_sof(int marker);
  void read_dht(int length);
  void read_dqt(int length);
  void read_sos(bool decode_scans);
  void read_app(int marker, int length);
  void read_dac(int length);
  void arith_reset();
  int arith_decode(uint8_t* st);
  int arith_dc_diff(Component& c);
  void arith_block(Component& c, int16_t* block);
  void arith_dc_first(Component& c, int16_t* block, int al);
  void arith_dc_refine(int16_t* block, int al);
  void arith_ac_first(const Component& c, int16_t* block, int ss, int se, int al);
  void arith_ac_refine(const Component& c, int16_t* block, int ss, int se, int al);

  void fill_bits();
  int get_bits(int n);
  int decode_huffman(const Huffman& h);
  void reset_bits() {
    bits_ = 0;
    nbits_ = 0;
    hit_marker_ = false;
  }
  void decode_block(Component& c, int16_t* block);
  void decode_dc_first(Component& c, int16_t* block, int al);
  void decode_dc_refine(int16_t* block, int al);
  void decode_ac_first(const Component& c, int16_t* block, int ss, int se, int al);
  void decode_ac_refine(const Component& c, int16_t* block, int ss, int se, int al);
  bool process_restart();
  bool smoothing_ok() const;
  void decode_lossless_scan(const std::vector<Component*>& scan, int psv, int pt);

  void idct_component(const Component& c, bool smooth, std::vector<uint8_t>& plane, int& stride) const;
  void idct_smoothed(const Component& c, std::vector<uint8_t>& plane, int stride) const;
  void upsample(const Component& c, const std::vector<uint8_t>& plane, int stride, std::vector<uint8_t>& full) const;
};

void build_huffman(Huffman& h, const uint8_t counts[16], const uint8_t* vals, int nvals) {
  h.defined = true;
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  int huffsize[257], huffcode[257];
  for (int len = 1; len <= 16; ++len)
    for (int i = 0; i < counts[len - 1]; ++i) huffsize[k++] = len;
  huffsize[k] = 0;
  k = 0;
  int si = huffsize[0];
  while (huffsize[k]) {
    while (huffsize[k] == si) huffcode[k++] = code++;
    code <<= 1;
    ++si;
  }
  k = 0;
  for (int len = 1; len <= 16; ++len) {
    if (counts[len - 1]) {
      h.valoffset[len] = k - huffcode[k];
      k += counts[len - 1];
      h.maxcode[len] = huffcode[k - 1];
    } else {
      h.maxcode[len] = -1;
    }
  }
  h.maxcode[17] = 0x7FFFFFFF;
  std::memset(h.look, 0, sizeof(h.look));
  k = 0;
  for (int len = 1; len <= 9; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i, ++k) {
      int lookbits = huffcode[k] << (9 - len);
      for (int ctr = 1 << (9 - len); ctr > 0; --ctr) h.look[lookbits++] = static_cast<uint16_t>((len << 8) | h.vals[k]);
    }
  }
}

void Decoder::parse(bool decode_scans) {
  if (end_ - p_ < 2 || p_[0] != 0xFF || p_[1] != 0xD8) fail(2, "not a JPEG file (no SOI marker)");
  p_ += 2;
  for (;;) {
    // find the next marker, skipping fill bytes
    uint8_t b = byte();
    if (b != 0xFF) fail(2, "marker expected");
    int marker;
    do {
      marker = byte();
    } while (marker == 0xFF);
    if (marker == 0xD9) break;  // EOI
    if (marker >= 0xD0 && marker <= 0xD7) continue;  // a stray RSTn
    if (marker == 0x01) continue;  // TEM
    int length = u16();
    if (length < 2 || end_ - p_ < length - 2) fail(2, "truncated marker segment");
    const uint8_t* next = p_ + length - 2;
    switch (marker) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        progressive_ = marker == 0xC2;
        read_sof(marker);
        if (!decode_scans) return;
        break;
      case 0xC3:
        lossless_ = true;
        read_sof(marker);
        if (!decode_scans) return;
        break;
      case 0xC5:
      case 0xC6:
      case 0xC7: {
        char buf[96];
        std::snprintf(buf, sizeof(buf), "hierarchical JPEG (SOF%d) is not supported", marker - 0xC0);
        fail(1, buf);
      }
      case 0xC9:
      case 0xCA:
        arith_ = true;
        progressive_ = marker == 0xCA;
        read_sof(marker);
        if (!decode_scans) return;
        break;
      case 0xCB:
        fail(1, "arithmetic-coded lossless JPEG (SOF11) is not supported");
      case 0xCD:
      case 0xCE:
      case 0xCF: {
        char buf[96];
        std::snprintf(buf, sizeof(buf), "arithmetic-coded JPEG (SOF%d) is not supported", marker - 0xC0);
        fail(1, buf);
      }
      case 0xCC:
        read_dac(length - 2);
        break;
      case 0xC4:
        read_dht(length - 2);
        break;
      case 0xDB:
        read_dqt(length - 2);
        break;
      case 0xDD:
        if (length != 4) fail(2, "bad DRI length");
        restart_interval_ = u16();
        break;
      case 0xDA:
        if (!frame_seen_) fail(2, "SOS before SOF");
        read_sos(decode_scans);
        continue;  // read_sos leaves p_ at the marker after the scan
      case 0xDC:
        if (height_ == 0) fail(1, "a DNL-defined image height is not supported");
        break;
      default:
        if (marker >= 0xE0 && marker <= 0xEF) read_app(marker, length - 2);
        // COM, JPG and other APPn: skipped
        break;
    }
    p_ = next;
  }
  if (!frame_seen_) fail(2, "no frame (SOF) in the file");
}

// jdcoefct.c's smoothing_ok on the final coefficient bits: libjpeg smooths
// the blocks of a progressive image when every component's DC is known,
// the quantizers it reads are nonzero and one of the first nine AC
// coefficients is not known to full precision.
bool Decoder::smoothing_ok() const {
  if (!progressive_) return false;
  bool useful = false;
  for (const auto& c : comps_) {
    if (!c.q_latched) return false;
    for (int k = 0; k < 10; ++k)
      if (c.q[kNaturalOrder[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

void Decoder::read_app(int marker, int length) {
  const uint8_t* d = p_;
  if (marker == 0xE0 && length >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) jfif_ = true;
  if (marker == 0xEE && length >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
    adobe_ = true;
    adobe_transform_ = d[11];
  }
}

void Decoder::read_sof(int marker) {
  (void)marker;
  if (frame_seen_) fail(2, "more than one frame");
  int precision = byte();
  if (precision != 8) {
    char buf[96];
    std::snprintf(buf, sizeof(buf), "%d-bit JPEG samples are not supported", precision);
    fail(1, buf);
  }
  height_ = u16();
  width_ = u16();
  int nf = byte();
  if (nf != 1 && nf != 3 && nf != 4) fail(1, "JPEG with " + std::to_string(nf) + " components is not supported");
  if (width_ <= 0) fail(2, "zero image width");
  comps_.resize(nf);
  for (auto& c : comps_) {
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(2, "bad component parameters");
  }
  for (auto& c : comps_) {
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  frame_seen_ = true;
  if (height_ == 0) return;
  mcus_x_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
  mcus_y_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
  for (auto& c : comps_) {
    if (hmax_ % c.h || vmax_ % c.v) fail(1, "fractional sampling factors are not supported");
    c.width = static_cast<int>((static_cast<long>(width_) * c.h + hmax_ - 1) / hmax_);
    c.height = static_cast<int>((static_cast<long>(height_) * c.v + vmax_ - 1) / vmax_);
    c.blocks_w = mcus_x_ * c.h;
    c.blocks_h = mcus_y_ * c.v;
  }
}

void Decoder::read_dht(int length) {
  while (length > 0) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail(2, "bad Huffman table id");
    uint8_t counts[16];
    int total = 0;
    for (int i = 0; i < 16; ++i) {
      counts[i] = byte();
      total += counts[i];
    }
    if (total > 256) fail(2, "bad Huffman table");
    uint8_t vals[256];
    for (int i = 0; i < total; ++i) vals[i] = byte();
    build_huffman(tc == 0 ? dc_[th] : ac_[th], counts, vals, total);
    length -= 17 + total;
  }
  if (length != 0) fail(2, "bad DHT length");
}

void Decoder::read_dqt(int length) {
  while (length > 0) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3 || pq > 1) fail(2, "bad quantization table");
    for (int k = 0; k < 64; ++k) qt_[tq][kNaturalOrder[k]] = static_cast<uint16_t>(pq ? u16() : byte());
    qt_defined_[tq] = true;
    length -= 1 + 64 * (pq + 1);
  }
  if (length != 0) fail(2, "bad DQT length");
}

void Decoder::fill_bits() {
  while (nbits_ <= 56) {
    uint32_t b = 0;
    if (!hit_marker_ && p_ < end_) {
      b = *p_;
      if (b == 0xFF) {
        // 0xFF 0x00 is a stuffed 0xFF; anything else is a marker: stop and
        // feed zeros from here on, as libjpeg does
        const uint8_t* q = p_ + 1;
        while (q < end_ && *q == 0xFF) ++q;
        if (q < end_ && *q == 0x00) {
          p_ = q + 1;
        } else {
          hit_marker_ = true;
          b = 0;
        }
      } else {
        ++p_;
      }
    }
    bits_ |= static_cast<uint64_t>(b) << (56 - nbits_);
    nbits_ += 8;
  }
}

int Decoder::get_bits(int n) {
  if (n == 0) return 0;
  if (nbits_ < n) fill_bits();
  int v = static_cast<int>(bits_ >> (64 - n));
  bits_ <<= n;
  nbits_ -= n;
  return v;
}

int Decoder::decode_huffman(const Huffman& h) {
  if (nbits_ < 16) fill_bits();
  int look = static_cast<int>(bits_ >> (64 - 9));
  int entry = h.look[look];
  if (entry) {
    int len = entry >> 8;
    bits_ <<= len;
    nbits_ -= len;
    return entry & 0xFF;
  }
  int len = 10;
  int code = static_cast<int>(bits_ >> (64 - 10));
  while (len <= 16 && code > h.maxcode[len]) {
    ++len;
    code = static_cast<int>(bits_ >> (64 - len));
  }
  if (len > 16) fail(2, "corrupt Huffman code");
  bits_ <<= len;
  nbits_ -= len;
  return h.vals[(code + h.valoffset[len]) & 0xFF];
}

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

void Decoder::decode_block(Component& c, int16_t* block) {
  const Huffman& dc = dc_[c.td];
  const Huffman& ac = ac_[c.ta];
  int s = decode_huffman(dc);
  int diff = 0;
  if (s) {
    if (s > 16) fail(2, "bad DC magnitude");
    diff = extend(get_bits(s), s);
  }
  c.dc_pred += diff;
  block[0] = static_cast<int16_t>(c.dc_pred);
  for (int k = 1; k < 64; ++k) {
    int rs = decode_huffman(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int v = extend(get_bits(s), s);
      block[kNaturalOrder[k]] = static_cast<int16_t>(v);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// ---- jdphuff.c: the four progressive scan kinds ---------------------------

void Decoder::decode_dc_first(Component& c, int16_t* block, int al) {
  int s = decode_huffman(dc_[c.td]);
  int diff = 0;
  if (s) {
    if (s > 16) fail(2, "bad DC magnitude");
    diff = extend(get_bits(s), s);
  }
  c.dc_pred += diff;
  block[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
}

void Decoder::decode_dc_refine(int16_t* block, int al) {
  if (get_bits(1)) block[0] = static_cast<int16_t>(block[0] | (1 << al));
}

void Decoder::decode_ac_first(const Component& c, int16_t* block, int ss, int se, int al) {
  if (eobrun_ > 0) {
    --eobrun_;
    return;
  }
  const Huffman& ac = ac_[c.ta];
  for (int k = ss; k <= se; ++k) {
    int rs = decode_huffman(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      int v = extend(get_bits(s), s);
      block[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    } else if (r == 15) {
      k += 15;  // ZRL
    } else {  // EOBr: this block and 2^r - 1 + (r appended bits) more
      eobrun_ = 1 << r;
      if (r) eobrun_ += get_bits(r);
      --eobrun_;
      break;
    }
  }
}

void Decoder::decode_ac_refine(const Component& c, int16_t* block, int ss, int se, int al) {
  const int p1 = 1 << al, m1 = -p1;
  // a correction bit for an already nonzero coefficient: 1 adds one more
  // bit of magnitude
  auto correct = [&](int16_t* coef) {
    if (get_bits(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
  };
  int k = ss;
  if (eobrun_ == 0) {
    const Huffman& ac = ac_[c.ta];
    for (; k <= se; ++k) {
      int rs = decode_huffman(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        // a newly nonzero coefficient, magnitude 1 at this bit (s != 1 is
        // corrupt; libjpeg warns and goes on)
        s = get_bits(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        break;  // the rest of the band goes through the EOB run below
      }
      // skip r zero coefficients (s == 0: 16 of them, ZRL), correcting the
      // nonzero ones passed on the way
      do {
        int16_t* coef = block + kNaturalOrder[k];
        if (*coef != 0) {
          correct(coef);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) block[kNaturalOrder[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se; ++k) {
      int16_t* coef = block + kNaturalOrder[k];
      if (*coef != 0) correct(coef);
    }
    --eobrun_;
  }
}

bool Decoder::process_restart() {
  // discard the partial byte, find the marker, expect RSTn
  reset_bits();
  while (p_ + 1 < end_ && !(p_[0] == 0xFF && p_[1] != 0x00 && p_[1] != 0xFF)) ++p_;
  if (p_ + 1 < end_ && p_[1] >= 0xD0 && p_[1] <= 0xD7) {
    p_ += 2;
    for (auto& c : comps_) c.dc_pred = 0;
    eobrun_ = 0;
    if (arith_) arith_reset();
    return true;
  }
  fail(2, "restart marker expected");
}

void Decoder::read_sos(bool decode_scans) {
  int ns = byte();
  if (ns < 1 || ns > 4) fail(2, "bad scan component count");
  std::vector<Component*> scan;
  for (int i = 0; i < ns; ++i) {
    int cid = byte();
    int t = byte();
    Component* found = nullptr;
    for (auto& c : comps_)
      if (c.id == cid) found = &c;
    if (!found) fail(2, "scan names an unknown component");
    found->td = t >> 4;
    found->ta = t & 15;
    if (found->td > 3 || found->ta > 3) fail(2, "bad Huffman table selector");
    scan.push_back(found);
  }
  const int ss = byte(), se = byte(), ahal = byte();
  const int ah = ahal >> 4, al = ahal & 15;
  // the tables the scan decodes with: both for a sequential scan, the DC
  // table for a progressive DC first scan, the AC table for an AC scan
  const bool need_dc = !arith_ && (!progressive_ || (ss == 0 && ah == 0));
  const bool need_ac = !arith_ && !lossless_ && (!progressive_ || ss > 0);
  for (auto* c : scan)
    if ((need_dc && !dc_[c->td].defined) || (need_ac && !ac_[c->ta].defined))
      fail(2, "scan uses an undefined Huffman table");
  if (progressive_) {
    // jdphuff.c start_pass_phuff_decoder's checks
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) fail(2, "bad progressive scan parameters");
  }
  if (lossless_ && (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7)) fail(2, "bad lossless scan parameters");
  if (!decode_scans) return;
  if (height_ == 0) fail(1, "a DNL-defined image height is not supported");
  ++scans_;
  if (lossless_) {
    decode_lossless_scan(scan, ss, al);
    return;
  }
  for (auto* c : scan) {
    if (!c->q_latched) {
      if (!qt_defined_[c->tq]) fail(2, "component uses an undefined quantization table");
      std::memcpy(c->q, qt_[c->tq], sizeof(c->q));
      c->q_latched = true;
    }
    if (c->coefs.empty()) c->coefs.assign(static_cast<size_t>(c->blocks_w) * c->blocks_h * 64, 0);
    c->dc_pred = 0;
    if (progressive_) {
      for (int k = std::min(ss, 1); k <= std::max(se, 9) && k < 10; ++k) c->prev_coef_bits[k] = scans_ > 1 ? c->coef_bits[k] : 0;
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
  }
  eobrun_ = 0;
  reset_bits();
  scan_ = scan;
  scan_ss_ = ss;
  scan_ah_ = ah;
  if (arith_) arith_reset();
  auto decode_one = [&](Component& c, int16_t* block) {
    if (arith_) {
      if (!progressive_)
        arith_block(c, block);
      else if (ss == 0)
        ah == 0 ? arith_dc_first(c, block, al) : arith_dc_refine(block, al);
      else
        ah == 0 ? arith_ac_first(c, block, ss, se, al) : arith_ac_refine(c, block, ss, se, al);
    } else if (!progressive_)
      decode_block(c, block);
    else if (ss == 0)
      ah == 0 ? decode_dc_first(c, block, al) : decode_dc_refine(block, al);
    else
      ah == 0 ? decode_ac_first(c, block, ss, se, al) : decode_ac_refine(c, block, ss, se, al);
  };
  int restarts_left = restart_interval_;
  auto block_at = [](Component* c, int bx, int by) {
    return c->coefs.data() + (static_cast<size_t>(by) * c->blocks_w + bx) * 64;
  };
  if (ns == 1) {
    // non-interleaved: one block per MCU over the component's own extent
    Component* c = scan[0];
    int bw = (c->width + 7) / 8, bh = (c->height + 7) / 8;
    for (int by = 0; by < bh; ++by) {
      for (int bx = 0; bx < bw; ++bx) {
        if (restart_interval_) {
          if (restarts_left == 0) {
            process_restart();
            restarts_left = restart_interval_;
          }
          --restarts_left;
        }
        decode_one(*c, block_at(c, bx, by));
      }
    }
  } else {
    for (int my = 0; my < mcus_y_; ++my) {
      for (int mx = 0; mx < mcus_x_; ++mx) {
        if (restart_interval_) {
          if (restarts_left == 0) {
            process_restart();
            restarts_left = restart_interval_;
          }
          --restarts_left;
        }
        for (auto* c : scan)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h) decode_one(*c, block_at(c, mx * c->h + h, my * c->v + v));
      }
    }
  }
  // leave p_ at the marker that ends the scan
  while (p_ + 1 < end_ && !(p_[0] == 0xFF && p_[1] != 0x00 && !(p_[1] >= 0xD0 && p_[1] <= 0xD7) && p_[1] != 0xFF))
    ++p_;
  while (p_ + 1 < end_ && p_[0] == 0xFF && p_[1] == 0xFF) ++p_;
  reset_bits();
}

// ---- jdarith.c: arithmetic decoding (SOF9, SOF10) --------------------------

// jaritab.c: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS
// (ITU T.81 Table D.2), with state 113, the fixed estimate of one half
#define QV(qe, nlps, nmps, sw) ((int64_t(qe) << 16) | (int64_t(nmps) << 8) | (int64_t(sw) << 7) | (nlps))
const int64_t kAriTab[114] = {
    QV(0x5a1d, 1, 1, 1),     QV(0x2586, 14, 2, 0),    QV(0x1114, 16, 3, 0),    QV(0x080b, 18, 4, 0),
    QV(0x03d8, 20, 5, 0),    QV(0x01da, 23, 6, 0),    QV(0x00e5, 25, 7, 0),    QV(0x006f, 28, 8, 0),
    QV(0x0036, 30, 9, 0),    QV(0x001a, 33, 10, 0),   QV(0x000d, 35, 11, 0),   QV(0x0006, 9, 12, 0),
    QV(0x0003, 10, 13, 0),   QV(0x0001, 12, 13, 0),   QV(0x5a7f, 15, 15, 1),   QV(0x3f25, 36, 16, 0),
    QV(0x2cf2, 38, 17, 0),   QV(0x207c, 39, 18, 0),   QV(0x17b9, 40, 19, 0),   QV(0x1182, 42, 20, 0),
    QV(0x0cef, 43, 21, 0),   QV(0x09a1, 45, 22, 0),   QV(0x072f, 46, 23, 0),   QV(0x055c, 48, 24, 0),
    QV(0x0406, 49, 25, 0),   QV(0x0303, 51, 26, 0),   QV(0x0240, 52, 27, 0),   QV(0x01b1, 54, 28, 0),
    QV(0x0144, 56, 29, 0),   QV(0x00f5, 57, 30, 0),   QV(0x00b7, 59, 31, 0),   QV(0x008a, 60, 32, 0),
    QV(0x0068, 62, 33, 0),   QV(0x004e, 63, 34, 0),   QV(0x003b, 32, 35, 0),   QV(0x002c, 33, 9, 0),
    QV(0x5ae1, 37, 37, 1),   QV(0x484c, 64, 38, 0),   QV(0x3a0d, 65, 39, 0),   QV(0x2ef1, 67, 40, 0),
    QV(0x261f, 68, 41, 0),   QV(0x1f33, 69, 42, 0),   QV(0x19a8, 70, 43, 0),   QV(0x1518, 72, 44, 0),
    QV(0x1177, 73, 45, 0),   QV(0x0e74, 74, 46, 0),   QV(0x0bfb, 75, 47, 0),   QV(0x09f8, 77, 48, 0),
    QV(0x0861, 78, 49, 0),   QV(0x0706, 79, 50, 0),   QV(0x05cd, 48, 51, 0),   QV(0x04de, 50, 52, 0),
    QV(0x040f, 50, 53, 0),   QV(0x0363, 51, 54, 0),   QV(0x02d4, 52, 55, 0),   QV(0x025c, 53, 56, 0),
    QV(0x01f8, 54, 57, 0),   QV(0x01a4, 55, 58, 0),   QV(0x0160, 56, 59, 0),   QV(0x0125, 57, 60, 0),
    QV(0x00f6, 58, 61, 0),   QV(0x00cb, 59, 62, 0),   QV(0x00ab, 61, 63, 0),   QV(0x008f, 61, 32, 0),
    QV(0x5b12, 65, 65, 1),   QV(0x4d04, 80, 66, 0),   QV(0x412c, 81, 67, 0),   QV(0x37d8, 82, 68, 0),
    QV(0x2fe8, 83, 69, 0),   QV(0x293c, 84, 70, 0),   QV(0x2379, 86, 71, 0),   QV(0x1edf, 87, 72, 0),
    QV(0x1aa9, 87, 73, 0),   QV(0x174e, 72, 74, 0),   QV(0x1424, 72, 75, 0),   QV(0x119c, 74, 76, 0),
    QV(0x0f6b, 74, 77, 0),   QV(0x0d51, 75, 78, 0),   QV(0x0bb6, 77, 79, 0),   QV(0x0a40, 77, 48, 0),
    QV(0x5832, 80, 81, 1),   QV(0x4d1c, 88, 82, 0),   QV(0x438e, 89, 83, 0),   QV(0x3bdd, 90, 84, 0),
    QV(0x34ee, 91, 85, 0),   QV(0x2eae, 92, 86, 0),   QV(0x299a, 93, 87, 0),   QV(0x2516, 86, 71, 0),
    QV(0x5570, 88, 89, 1),   QV(0x4ca9, 95, 90, 0),   QV(0x44d9, 96, 91, 0),   QV(0x3e22, 97, 92, 0),
    QV(0x3824, 99, 93, 0),   QV(0x32b4, 99, 94, 0),   QV(0x2e17, 93, 86, 0),   QV(0x56a8, 95, 96, 1),
    QV(0x4f46, 101, 97, 0),  QV(0x47e5, 102, 98, 0),  QV(0x41cf, 103, 99, 0),  QV(0x3c3d, 104, 100, 0),
    QV(0x375e, 99, 93, 0),   QV(0x5231, 105, 102, 0), QV(0x4c0f, 106, 103, 0), QV(0x4639, 107, 104, 0),
    QV(0x415e, 103, 99, 0),  QV(0x5627, 105, 106, 1), QV(0x50e7, 108, 107, 0), QV(0x4b85, 109, 103, 0),
    QV(0x5597, 110, 109, 0), QV(0x504f, 111, 107, 0), QV(0x5a10, 110, 111, 1), QV(0x5522, 112, 109, 0),
    QV(0x59eb, 112, 111, 1), QV(0x5a1d, 113, 113, 0)};
#undef QV

void Decoder::read_dac(int length) {
  while (length >= 2) {
    int tc_tb = byte(), v = byte();
    length -= 2;
    int tc = tc_tb >> 4, tb = tc_tb & 15;
    if (tc > 1 || tb > 3) fail(2, "bad DAC table");
    if (tc == 0) {
      dc_l_[tb] = static_cast<uint8_t>(v & 15);
      dc_u_[tb] = static_cast<uint8_t>(v >> 4);
      if (dc_l_[tb] > dc_u_[tb]) fail(2, "bad DAC value");
    } else {
      if (v < 1 || v > 63) fail(2, "bad DAC value");
      ac_k_[tb] = static_cast<uint8_t>(v);
    }
  }
  if (length != 0) fail(2, "bad DAC length");
}

// jdarith.c start_pass / process_restart: the bins of the scan's tables
// cleared, the DC predictions and contexts zeroed, the registers reset
void Decoder::arith_reset() {
  for (auto* c : scan_) {
    if (!progressive_ || (scan_ss_ == 0 && scan_ah_ == 0)) {
      std::memset(dc_stats_[c->td], 0, sizeof(dc_stats_[0]));
      c->dc_pred = 0;
      c->dc_context = 0;
    }
    if (!progressive_ || scan_ss_ > 0) std::memset(ac_stats_[c->ta], 0, sizeof(ac_stats_[0]));
  }
  ac_c_ = 0;
  ac_a_ = 0;
  ac_ct_ = -16;  // two bytes to read before the first decision
  ac_marker_ = false;
}

// jdarith.c arith_decode: one binary decision in bin *st (D.2.4-D.2.6)
int Decoder::arith_decode(uint8_t* st) {
  while (ac_a_ < 0x8000) {
    if (--ac_ct_ < 0) {
      int data = 0;  // past a marker the data are zeros
      if (!ac_marker_ && p_ < end_) {
        data = *p_++;
        if (data == 0xFF) {
          while (p_ < end_ && *p_ == 0xFF) ++p_;
          if (p_ < end_ && *p_ == 0) {
            ++p_;
          } else {
            --p_;  // leave p_ at the marker
            ac_marker_ = true;
            data = 0;
          }
        }
      }
      ac_c_ = (ac_c_ << 8) | data;
      if ((ac_ct_ += 8) < 0)
        if (++ac_ct_ == 0) ac_a_ = 0x8000;  // two initial bytes read
    }
    ac_a_ <<= 1;
  }
  int sv = *st;
  int64_t qe = kAriTab[sv & 0x7F];
  const int nl = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  const int nm = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  int64_t temp = ac_a_ - qe;
  ac_a_ = temp;
  temp <<= ac_ct_;
  if (ac_c_ >= temp) {
    ac_c_ -= temp;
    if (ac_a_ < qe) {  // conditional LPS exchange
      ac_a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    } else {
      ac_a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (ac_a_ < 0x8000) {  // conditional MPS exchange
    if (ac_a_ < qe) {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

// F.1.4.4.1 / Figures F.19-F.24: a DC difference, its bins chosen by the
// conditioning category of the component's last one
int Decoder::arith_dc_diff(Component& c) {
  uint8_t* stats = dc_stats_[c.td];
  uint8_t* st = stats + c.dc_context;
  if (arith_decode(st) == 0) {
    c.dc_context = 0;
    return 0;
  }
  const int sign = arith_decode(st + 1);
  st += 2 + sign;
  int m = arith_decode(st);
  if (m != 0) {
    st = stats + 20;
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) fail(2, "corrupt arithmetic-coded DC difference");
      ++st;
    }
  }
  if (m < static_cast<int>((1L << dc_l_[c.td]) >> 1))
    c.dc_context = 0;
  else if (m > static_cast<int>((1L << dc_u_[c.td]) >> 1))
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

void Decoder::arith_block(Component& c, int16_t* block) {
  c.dc_pred = (c.dc_pred + arith_dc_diff(c)) & 0xFFFF;
  block[0] = static_cast<int16_t>(c.dc_pred);
  arith_ac_first(c, block, 1, 63, 0);
}

void Decoder::arith_dc_first(Component& c, int16_t* block, int al) {
  c.dc_pred += arith_dc_diff(c);
  block[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
}

void Decoder::arith_dc_refine(int16_t* block, int al) {
  if (arith_decode(&fixed_bin_)) block[0] = static_cast<int16_t>(block[0] | (1 << al));
}

void Decoder::arith_ac_first(const Component& c, int16_t* block, int ss, int se, int al) {
  uint8_t* stats = ac_stats_[c.ta];
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = stats + 3 * (k - 1);
    if (arith_decode(st)) break;  // end of block
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > se) fail(2, "corrupt arithmetic-coded AC data");
    }
    const int sign = arith_decode(&fixed_bin_);
    st += 2;
    int m = arith_decode(st);
    if (m != 0 && arith_decode(st)) {
      m <<= 1;
      st = stats + (k <= ac_k_[c.ta] ? 189 : 217);
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) fail(2, "corrupt arithmetic-coded AC data");
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    block[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
  }
}

void Decoder::arith_ac_refine(const Component& c, int16_t* block, int ss, int se, int al) {
  uint8_t* stats = ac_stats_[c.ta];
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  int kex = se;
  for (; kex > 0; --kex)
    if (block[kNaturalOrder[kex]]) break;
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = stats + 3 * (k - 1);
    if (k > kex && arith_decode(st)) break;  // end of block
    for (;;) {
      int16_t* coef = block + kNaturalOrder[k];
      if (*coef) {  // previously nonzero: a correction bit
        if (arith_decode(st + 2)) *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1 : *coef + p1);
        break;
      }
      if (arith_decode(st + 1)) {  // newly nonzero
        *coef = static_cast<int16_t>(arith_decode(&fixed_bin_) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) fail(2, "corrupt arithmetic-coded AC refinement");
    }
  }
}

// ---- jdlhuff.c / jdlossls.c: lossless (SOF3) ------------------------------

// Each sample is its prediction from the reconstructed neighbours (Ra left,
// Rb above, Rc above-left; predictor `psv`) plus a Huffman-coded difference,
// modulo 2^16; the first row of the image and of each restart interval
// predicts 2^(7 - pt) at its first sample and Ra after it, the first column
// Rb. The output sample is the reconstruction shifted left by the point
// transform `pt`, as an 8-bit sample.
void Decoder::decode_lossless_scan(const std::vector<Component*>& scan, int psv, int pt) {
  // an interleaved scan codes MCUs of h x v samples of each component (the
  // padding past a component's edge coded too), a single component's scan
  // one sample at a time (jddiffct.c)
  const bool interleaved = scan.size() > 1;
  const int mcus_x = interleaved ? (width_ + hmax_ - 1) / hmax_ : scan[0]->width;
  const int mcus_y = interleaved ? (height_ + vmax_ - 1) / vmax_ : scan[0]->height;
  for (auto* c : scan) {
    c->samples.assign(static_cast<size_t>(c->width) * c->height, 0);
    c->point_transform = pt;
  }
  if (restart_interval_ && restart_interval_ % mcus_x != 0)
    fail(1, "a lossless JPEG whose restart interval is not a whole number of rows is not supported");
  reset_bits();
  const int rows_per_restart = restart_interval_ ? restart_interval_ / mcus_x : 0;
  std::vector<std::vector<int>> diffs(scan.size());
  int first_mcu_row = 0;
  for (int my = 0; my < mcus_y; ++my) {
    if (rows_per_restart && my > 0 && my % rows_per_restart == 0) {
      process_restart();
      first_mcu_row = my;
    }
    for (size_t i = 0; i < scan.size(); ++i) {
      const int mw = interleaved ? scan[i]->h : 1, mh = interleaved ? scan[i]->v : 1;
      diffs[i].assign(static_cast<size_t>(mcus_x) * mw * mh, 0);
    }
    for (int mx = 0; mx < mcus_x; ++mx) {
      for (size_t i = 0; i < scan.size(); ++i) {
        const int mw = interleaved ? scan[i]->h : 1, mh = interleaved ? scan[i]->v : 1;
        for (int yy = 0; yy < mh; ++yy)
          for (int xx = 0; xx < mw; ++xx) {
            int s = decode_huffman(dc_[scan[i]->td]);
            int diff = 0;
            if (s == 16) {
              diff = 32768;
            } else if (s) {
              if (s > 16) fail(2, "bad lossless difference magnitude");
              diff = extend(get_bits(s), s);
            }
            diffs[i][static_cast<size_t>(yy) * mcus_x * mw + mx * mw + xx] = diff;
          }
      }
    }
    for (size_t i = 0; i < scan.size(); ++i) {
      Component* c = scan[i];
      const int W = c->width, mw = interleaved ? c->h : 1, mh = interleaved ? c->v : 1;
      for (int yy = 0; yy < mh; ++yy) {
        const int y = my * mh + yy;
        if (y >= c->height) break;
        uint16_t* row = c->samples.data() + static_cast<size_t>(y) * W;
        const uint16_t* up = row - W;
        const int* d = diffs[i].data() + static_cast<size_t>(yy) * mcus_x * mw;
        for (int x = 0; x < W; ++x) {
          int64_t pred;
          if (y == first_mcu_row * mh) {
            pred = x == 0 ? (1 << (7 - pt)) : row[x - 1];
          } else if (x == 0) {
            pred = up[0];
          } else {
            const int64_t ra = row[x - 1], rb = up[x], rc = up[x - 1];
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
          }
          row[x] = static_cast<uint16_t>((pred + d[x]) & 0xFFFF);
        }
      }
    }
  }
  while (p_ + 1 < end_ && !(p_[0] == 0xFF && p_[1] != 0x00 && !(p_[1] >= 0xD0 && p_[1] <= 0xD7) && p_[1] != 0xFF))
    ++p_;
  while (p_ + 1 < end_ && p_[0] == 0xFF && p_[1] == 0xFF) ++p_;
  reset_bits();
}

// ---- jidctint.c: jpeg_idct_islow ----------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// libjpeg's IDCT range limit: the low 10 bits of the descaled value, read
// as signed, plus the centre sample 128, clamped to [0, 255]
inline uint8_t range_limit(int64_t x) {
  int v = ((static_cast<int>(x) & 1023) ^ 512) - 512 + 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* in = coef + col;
    const uint16_t* qt = q + col;
    int* w = ws + col;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = static_cast<int>(static_cast<int64_t>(in[0]) * qt[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(in[16]) * qt[16];
    int64_t z3 = static_cast<int64_t>(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(in[0]) * qt[0];
    z3 = static_cast<int64_t>(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(in[56]) * qt[56];
    tmp1 = static_cast<int64_t>(in[40]) * qt[40];
    tmp2 = static_cast<int64_t>(in[24]) * qt[24];
    tmp3 = static_cast<int64_t>(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + static_cast<size_t>(row) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dc = range_limit(descale(w[0], kPass1Bits + 3));
      for (int i = 0; i < 8; ++i) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = range_limit(descale(tmp10 + tmp3, sh));
    o[7] = range_limit(descale(tmp10 - tmp3, sh));
    o[1] = range_limit(descale(tmp11 + tmp2, sh));
    o[6] = range_limit(descale(tmp11 - tmp2, sh));
    o[2] = range_limit(descale(tmp12 + tmp1, sh));
    o[5] = range_limit(descale(tmp12 - tmp1, sh));
    o[3] = range_limit(descale(tmp13 + tmp0, sh));
    o[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

void Decoder::idct_component(const Component& c, bool smooth, std::vector<uint8_t>& plane, int& stride) const {
  int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8;
  stride = bw * 8;
  plane.assign(static_cast<size_t>(stride) * bh * 8, 0);
  if (lossless_) {
    if (c.samples.empty()) return;
    for (int y = 0; y < c.height; ++y)
      for (int x = 0; x < c.width; ++x)
        plane[static_cast<size_t>(y) * stride + x] =
            static_cast<uint8_t>(c.samples[static_cast<size_t>(y) * c.width + x] << c.point_transform);
    return;
  }
  if (c.coefs.empty()) return;  // no scan carried this component
  if (smooth) {
    idct_smoothed(c, plane, stride);
    return;
  }
  const uint16_t* q = c.q;
  for (int by = 0; by < bh; ++by)
    for (int bx = 0; bx < bw; ++bx)
      idct_islow(c.coefs.data() + (static_cast<size_t>(by) * c.blocks_w + bx) * 64, q,
                 plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
}

// ---- jdcoefct.c, decompress_smooth_data ---------------------------------

// one estimated coefficient: round(num / (Q << 8)) away from zero
// (num carries the 2^7 bias), clamped below 2^Al when Al > 0
inline int16_t smoothed(int64_t num, int64_t q, int al) {
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

void Decoder::idct_smoothed(const Component& c, std::vector<uint8_t>& plane, int stride) const {
  const int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8;  // width_in_blocks, height_in_blocks
  const int last_row = mcus_y_ - 1, last_col = bw - 1;
  const int* bits = c.coef_bits;
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 && bits[5] == -1 &&
                         bits[6] == -1 && bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9], Q02 = c.q[2];
  const int64_t Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
  auto dc_at = [&](int row, int col) -> int {
    col = col < 0 ? 0 : (col > last_col ? last_col : col);
    return c.coefs[(static_cast<size_t>(row) * c.blocks_w + col) * 64];
  };
  int16_t ws[64];
  for (int r = 0; r <= last_row; ++r) {
    int block_rows = c.v;
    if (r == last_row) {
      block_rows = bh % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int image_block_rows = block_rows * mcus_y_;
    for (int br = 0; br < block_rows; ++br) {
      const int row = r * c.v + br;
      if (row >= bh) break;
      const int ib = r * block_rows + br;
      const int prev = ib > 0 ? row - 1 : row;
      const int prev2 = ib > 1 ? row - 2 : prev;
      const int next = ib < image_block_rows - 1 ? row + 1 : row;
      const int next2 = ib < image_block_rows - 2 ? row + 2 : next;
      const int rows[5] = {prev2, prev, row, next, next2};
      for (int b = 0; b <= last_col; ++b) {
        int DC[26];  // DC[1..25]: the 5 x 5 neighbourhood, row-major
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) DC[1 + 5 * i + j] = dc_at(rows[i], b - 2 + j);
        const int16_t* blk = c.coefs.data() + (static_cast<size_t>(row) * c.blocks_w + b) * 64;
        std::memcpy(ws, blk, sizeof(ws));
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {
          int64_t num = Q00 * (change_dc ? (-DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] - 13 * DC[9] +
                                            3 * DC[10] - 3 * DC[11] + 38 * DC[12] - 38 * DC[14] + 3 * DC[15] -
                                            3 * DC[16] + 13 * DC[17] - 13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] +
                                            DC[24] + DC[25])
                                         : (-7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15]));
          ws[1] = smoothed(num, Q01, al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {
          int64_t num = Q00 * (change_dc ? (-DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] - DC[6] + 13 * DC[7] +
                                            38 * DC[8] + 13 * DC[9] - DC[10] + DC[16] - 13 * DC[17] - 38 * DC[18] -
                                            13 * DC[19] + DC[20] + DC[21] + 3 * DC[22] + 3 * DC[23] + 3 * DC[24] +
                                            DC[25])
                                         : (-7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23]));
          ws[8] = smoothed(num, Q10, al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {
          int64_t num = Q00 * (change_dc ? (DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] - 14 * DC[13] -
                                            5 * DC[14] + 2 * DC[17] + 7 * DC[18] + 2 * DC[19] + DC[23])
                                         : (-DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] - DC[23]));
          ws[16] = smoothed(num, Q20, al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {
          int64_t num = Q00 * (change_dc ? (-DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] + 9 * DC[19] +
                                            DC[21] - DC[25])
                                         : (DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] - DC[20] + DC[22] -
                                            DC[24] + DC[4] - DC[6] + 10 * DC[7] - 10 * DC[9]));
          ws[9] = smoothed(num, Q11, al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {
          int64_t num = Q00 * (change_dc ? (2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] - 14 * DC[13] +
                                            7 * DC[14] + DC[15] + 2 * DC[17] - 5 * DC[18] + 2 * DC[19])
                                         : (-DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] - DC[15]));
          ws[2] = smoothed(num, Q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)
            ws[3] = smoothed(Q00 * (DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] - DC[19]), Q03, al);
          if ((al = bits[7]) != 0 && ws[10] == 0)
            ws[10] = smoothed(Q00 * (DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] - DC[19]), Q12, al);
          if ((al = bits[8]) != 0 && ws[17] == 0)
            ws[17] = smoothed(Q00 * (DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] - DC[19]), Q21, al);
          if ((al = bits[9]) != 0 && ws[24] == 0)
            ws[24] = smoothed(Q00 * (DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] - DC[19]), Q30, al);
          int64_t num = Q00 * (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] - 6 * DC[6] + 6 * DC[7] +
                               42 * DC[8] + 6 * DC[9] - 6 * DC[10] - 8 * DC[11] + 42 * DC[12] + 152 * DC[13] +
                               42 * DC[14] - 8 * DC[15] - 6 * DC[16] + 6 * DC[17] + 42 * DC[18] + 6 * DC[19] -
                               6 * DC[20] - 2 * DC[21] - 6 * DC[22] - 8 * DC[23] - 6 * DC[24] - 2 * DC[25]);
          ws[0] = smoothed(num, Q00, 0);
        }
        idct_islow(ws, c.q, plane.data() + static_cast<size_t>(row) * 8 * stride + b * 8, stride);
      }
    }
  }
}

// ---- jdsample.c --------------------------------------------------------

void Decoder::upsample(const Component& c, const std::vector<uint8_t>& plane, int stride,
                       std::vector<uint8_t>& full) const {
  const int W = width_, H = height_;
  const int fx = hmax_ / c.h, fy = vmax_ / c.v;
  const int dw = c.width, dh = c.height;
  full.assign(static_cast<size_t>(W) * H, 0);
  auto in = [&](int y, int x) -> int { return plane[static_cast<size_t>(y) * stride + x]; };
  std::vector<uint8_t> row(static_cast<size_t>(dw) * fx + 2);
  if (fx == 1 && fy == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(&full[static_cast<size_t>(y) * W], &plane[static_cast<size_t>(y) * stride], W);
    return;
  }
  if (color_ != 2 && !lossless_ && fx == 2 && fy == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; ++y) {
      uint8_t* o = row.data();
      int v = in(y, 0);
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + in(y, 1) + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = in(y, x) * 3;
        *o++ = static_cast<uint8_t>((v + in(y, x - 1) + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + in(y, x + 1) + 2) >> 2);
      }
      v = in(y, dw - 1);
      *o++ = static_cast<uint8_t>((v * 3 + in(y, dw - 2) + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
      std::memcpy(&full[static_cast<size_t>(y) * W], row.data(), W);
    }
    return;
  }
  if (color_ != 2 && !lossless_ && fx == 2 && fy == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int iy = y / 2;
      int ny = (y % 2 == 0) ? (iy > 0 ? iy - 1 : 0) : (iy + 1 < dh ? iy + 1 : dh - 1);
      auto colsum = [&](int x) { return in(iy, x) * 3 + in(ny, x); };
      uint8_t* o = row.data();
      int thiscolsum = colsum(0), nextcolsum = colsum(1), lastcolsum;
      *o++ = static_cast<uint8_t>((thiscolsum * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
      lastcolsum = thiscolsum;
      thiscolsum = nextcolsum;
      for (int x = 2; x < dw; ++x) {
        nextcolsum = colsum(x);
        *o++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
        *o++ = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
        lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
      }
      *o++ = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
      *o++ = static_cast<uint8_t>((thiscolsum * 4 + 7) >> 4);
      std::memcpy(&full[static_cast<size_t>(y) * W], row.data(), W);
    }
    return;
  }
  if (color_ != 2 && !lossless_ && fx == 1 && fy == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int iy = y / 2;
      bool upper = y % 2 == 0;
      int ny = upper ? (iy > 0 ? iy - 1 : 0) : (iy + 1 < dh ? iy + 1 : dh - 1);
      int bias = upper ? 1 : 2;
      for (int x = 0; x < W; ++x)
        full[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>((in(iy, x) * 3 + in(ny, x) + bias) >> 2);
    }
    return;
  }
  // h2v1 / h2v2 with a downsampled width of 2 or less, and every other
  // integral ratio: box replication
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) full[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(in(y / fy, x / fx));
}

// ---- jdcolor.c ---------------------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// libjpeg's default colour space (jdapimin.c): for 3 components YCbCr
// (converted to RGB) after a JFIF marker, after an Adobe marker with a
// transform other than 0, or without either unless the component ids are
// 'R', 'G', 'B'; for 4 components YCCK (converted to CMYK) after an Adobe
// marker with a transform other than 0
bool Decoder::converts() const {
  if (color_ >= 0) return color_ == 1 && comps_.size() == 3;
  if (comps_.size() == 4) return adobe_ && adobe_transform_ != 0;
  if (comps_.size() != 3) return false;
  if (jfif_) return true;
  if (adobe_) return adobe_transform_ != 0;
  return !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);
}

void Decoder::write(uint8_t* out) const {
  // libjpeg-turbo converts no colours of a lossless image (JERR_CONVERSION_NOTIMPL)
  if (lossless_ && converts()) fail(1, "a lossless JPEG that needs a colour conversion (libjpeg refuses it too)");
  const size_t n = static_cast<size_t>(width_) * height_;
  std::vector<std::vector<uint8_t>> full(comps_.size());
  const bool smooth = smoothing_ok();
  for (size_t i = 0; i < comps_.size(); ++i) {
    std::vector<uint8_t> plane;
    int stride = 0;
    idct_component(comps_[i], smooth, plane, stride);
    upsample(comps_[i], plane, stride, full[i]);
  }
  if (comps_.size() == 1) {
    std::memcpy(out, full[0].data(), n);
    return;
  }
  static const YccTables t;
  if (comps_.size() == 4 && (color_ == 0 || color_ == 2)) {
    for (size_t i = 0; i < n; ++i)
      for (int k = 0; k < 4; ++k) out[4 * i + k] = full[k][i];
    return;
  }
  if (comps_.size() == 4) {
    // Pillow's "CMYK;I" inverts
    if (converts()) {
      for (size_t i = 0; i < n; ++i) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        out[4 * i + 0] = static_cast<uint8_t>(255 - clamp8(255 - (y + t.cr_r[cr])));
        out[4 * i + 1] = static_cast<uint8_t>(255 - clamp8(255 - (y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16))));
        out[4 * i + 2] = static_cast<uint8_t>(255 - clamp8(255 - (y + t.cb_b[cb])));
        out[4 * i + 3] = static_cast<uint8_t>(255 - full[3][i]);
      }
    } else {
      for (size_t i = 0; i < n; ++i)
        for (int k = 0; k < 4; ++k) out[4 * i + k] = static_cast<uint8_t>(255 - full[k][i]);
    }
    return;
  }
  if (!converts()) {
    for (size_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
    return;
  }
  for (size_t i = 0; i < n; ++i) {
    int y = full[0][i], cb = full[1][i], cr = full[2][i];
    out[3 * i + 0] = clamp8(y + t.cr_r[cr]);
    out[3 * i + 1] = clamp8(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp8(y + t.cb_b[cb]);
  }
}

void set_error(char* err, int err_size, const std::string& msg) {
  if (err && err_size > 0) {
    std::snprintf(err, static_cast<size_t>(err_size), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" int jpeg_decoder_abi_version() { return 1; }

extern "C" int jpeg_decode_color(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, int* dims,
                                 char* err, int err_size, int color) {
  try {
    Decoder d(data, size);
    d.set_color(color);
    if (out == nullptr) {
      d.header_only();
    } else {
      d.decode();
    }
    dims[0] = d.height();
    dims[1] = d.width();
    dims[2] = d.channels();
    if (out != nullptr) {
      size_t need = static_cast<size_t>(dims[0]) * dims[1] * dims[2];
      if (out_size < need) {
        set_error(err, err_size, "output buffer too small");
        return 2;
      }
      d.write(out);
    }
    return 0;
  } catch (const Error& e) {
    set_error(err, err_size, e.msg);
    return e.code;
  } catch (const std::exception& e) {
    set_error(err, err_size, e.what());
    return 2;
  }
}

extern "C" int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, int* dims, char* err,
                           int err_size) {
  return jpeg_decode_color(data, size, out, out_size, dims, err, err_size, -1);
}
