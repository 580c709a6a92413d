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
//     nine AC coefficients short of full precision, where libjpeg would
//     smooth the blocks (jdcoefct.c, block smoothing), returns 1;
//   - each component's quantization table latched at its first scan
//     (jdinput.c, latch_quant_tables);
//   - the accurate integer IDCT (jidctint.c, jpeg_idct_islow);
//   - fancy (triangle) upsampling for h2v1, h2v2 (jdsample.c; box
//     replication when the downsampled width is 2 or less, as there) and
//     h1v2;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c, and libjpeg's
//     choice of colour space (JFIF / Adobe markers, component ids).
// Lossless, hierarchical and arithmetic-coded frames, 12-bit samples and
// 4-component (CMYK / YCCK) images return 1 with the marker named in the
// message.
//
// C interface (loaded with ctypes by data/jpeg.py):
//   int jpeg_decoder_abi_version();
//   int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out,
//                   size_t out_size, int* dims, char* err, int err_size);
// dims receives {height, width, channels}. With out == nullptr only the
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
  int dc_pred = 0;
  uint16_t q[64];  // the quantization table, latched at the first scan
  bool q_latched = false;
  // per spectral position: the Al of the last scan that carried it, -1
  // before any did (jdphuff.c's coef_bits)
  int coef_bits[64];
  Component() { std::fill(coef_bits, coef_bits + 64, -1); }
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : p_(data), end_(data + size) {}

  void header_only() { parse(false); }
  void decode() { parse(true); }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return static_cast<int>(comps_.size()) == 1 ? 1 : 3; }
  void write(uint8_t* out) const;

 private:
  const uint8_t* p_;
  const uint8_t* end_;
  int width_ = 0, height_ = 0;
  int hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  bool frame_seen_ = false, jfif_ = false, adobe_ = false, progressive_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
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
  void check_no_smoothing() const;

  void idct_component(const Component& c, std::vector<uint8_t>& plane, int& stride) const;
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
        fail(1, "lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7: {
        char buf[96];
        std::snprintf(buf, sizeof(buf), "hierarchical JPEG (SOF%d) is not supported", marker - 0xC0);
        fail(1, buf);
      }
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF: {
        char buf[96];
        std::snprintf(buf, sizeof(buf), "arithmetic-coded JPEG (SOF%d) is not supported", marker - 0xC0);
        fail(1, buf);
      }
      case 0xCC:
        fail(1, "arithmetic-coded JPEG (DAC) is not supported");
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
  if (decode_scans && progressive_) check_no_smoothing();
}

// jdcoefct.c's smoothing_ok on the final coefficient bits: libjpeg smooths
// the blocks of a progressive image when every component's DC is known,
// the quantizers it reads are nonzero and one of the first nine AC
// coefficients is not known to full precision.
void Decoder::check_no_smoothing() const {
  static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (const auto& c : comps_) {
    if (!c.q_latched) return;
    for (int pos : kQPos)
      if (c.q[pos] == 0) return;
    if (c.coef_bits[0] < 0) return;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  if (useful)
    fail(1, "a progressive JPEG whose scans leave low AC coefficients short of full precision "
            "(libjpeg's block smoothing) is not supported");
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
  if (nf == 4) fail(1, "4-component (CMYK / YCCK) JPEG is not supported");
  if (nf != 1 && nf != 3) fail(1, "JPEG with " + std::to_string(nf) + " components is not supported");
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
  const bool need_dc = !progressive_ || (ss == 0 && ah == 0), need_ac = !progressive_ || ss > 0;
  for (auto* c : scan)
    if ((need_dc && !dc_[c->td].defined) || (need_ac && !ac_[c->ta].defined))
      fail(2, "scan uses an undefined Huffman table");
  if (progressive_) {
    // jdphuff.c start_pass_phuff_decoder's checks
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) fail(2, "bad progressive scan parameters");
  }
  if (!decode_scans) return;
  if (height_ == 0) fail(1, "a DNL-defined image height is not supported");
  for (auto* c : scan) {
    if (!c->q_latched) {
      if (!qt_defined_[c->tq]) fail(2, "component uses an undefined quantization table");
      std::memcpy(c->q, qt_[c->tq], sizeof(c->q));
      c->q_latched = true;
    }
    if (c->coefs.empty()) c->coefs.assign(static_cast<size_t>(c->blocks_w) * c->blocks_h * 64, 0);
    c->dc_pred = 0;
    if (progressive_)
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
  }
  eobrun_ = 0;
  reset_bits();
  auto decode_one = [&](Component& c, int16_t* block) {
    if (!progressive_)
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

void Decoder::idct_component(const Component& c, std::vector<uint8_t>& plane, int& stride) const {
  int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8;
  stride = bw * 8;
  plane.assign(static_cast<size_t>(stride) * bh * 8, 0);
  if (c.coefs.empty()) return;  // no scan carried this component
  const uint16_t* q = c.q;
  for (int by = 0; by < bh; ++by)
    for (int bx = 0; bx < bw; ++bx)
      idct_islow(c.coefs.data() + (static_cast<size_t>(by) * c.blocks_w + bx) * 64, q,
                 plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
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
  if (fx == 2 && fy == 1 && dw > 2) {  // h2v1_fancy_upsample
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
  if (fx == 2 && fy == 2 && dw > 2) {  // h2v2_fancy_upsample
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
  if (fx == 1 && fy == 2) {  // h1v2_fancy_upsample
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

void Decoder::write(uint8_t* out) const {
  const size_t n = static_cast<size_t>(width_) * height_;
  std::vector<std::vector<uint8_t>> full(comps_.size());
  for (size_t i = 0; i < comps_.size(); ++i) {
    std::vector<uint8_t> plane;
    int stride = 0;
    idct_component(comps_[i], plane, stride);
    upsample(comps_[i], plane, stride, full[i]);
  }
  if (comps_.size() == 1) {
    std::memcpy(out, full[0].data(), n);
    return;
  }
  // libjpeg's default colour space for 3 components (jdapimin.c)
  bool ycc;
  if (jfif_) {
    ycc = true;
  } else if (adobe_) {
    ycc = adobe_transform_ != 0;
  } else {
    int c0 = comps_[0].id, c1 = comps_[1].id, c2 = comps_[2].id;
    ycc = !(c0 == 82 && c1 == 71 && c2 == 66);  // 'R', 'G', 'B'
  }
  if (!ycc) {
    for (size_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
    return;
  }
  static const YccTables t;
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

extern "C" int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, int* dims, char* err,
                           int err_size) {
  try {
    Decoder d(data, size);
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
