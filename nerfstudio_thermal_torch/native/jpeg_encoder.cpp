// Baseline JPEG encoder that computes what libjpeg(-turbo) writes with
// Pillow's settings for `Image.save(format="JPEG", quality=q)` of an RGB
// image, byte for byte:
//   - the JFIF APP0 header (version 1.01, density 1:1, no thumbnail), the
//     two quantization tables, SOF0, the four standard Huffman tables and
//     one interleaved scan, each table in its own marker, in libjpeg's
//     order;
//   - libjpeg's quality scaling of its standard tables (jcparam.c), 8-bit
//     entries (baseline);
//   - the fixed-point RGB -> YCbCr tables of jccolor.c;
//   - 4:2:0 chroma with h2v2 downsampling and its alternating 1, 2 bias
//     (jcsample.c); the image is padded by replicating its last column and
//     row, as jcsample.c / jcprepct.c pad it;
//   - the accurate integer forward DCT (jfdctint.c, jpeg_fdct_islow) and
//     rounded quantization (jcdctmgr.c);
//   - the dummy blocks of jccoefct.c past the right and bottom edges of a
//     component (zero AC, the DC of the block to the left);
//   - the standard Huffman tables (jstdhuff.c), no restart markers.
// Greyscale images are given as RGB with equal channels, as the caller
// repeats them.
//
// C interface (loaded with ctypes by data/jpeg.py):
//   int jpeg_encoder_abi_version();
//   int jpeg_encode(const uint8_t* rgb, int height, int width, int quality,
//                   uint8_t* out, size_t out_cap, size_t* out_size);
// rgb is [height, width, 3] row-major. The file is written to out when it
// fits in out_cap bytes; *out_size always receives its size. Returns 0 on
// success, 1 when out_cap was too small (call again with *out_size bytes),
// 2 for invalid arguments.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kStdLuminanceQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kStdChrominanceQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts by length 1-16, then the symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int count;
  uint32_t code[256];
  int size[256];

  HuffTable(const uint8_t* b, const uint8_t* v) : bits(b), vals(v), count(0) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    // canonical codes (jchuff.c jpeg_make_c_derived_tbl)
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = c++;
        size[vals[k]] = len;
      }
      c <<= 1;
    }
    count = k;
  }
};

// jcparam.c: jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
void scaled_table(const int* basic, int quality, int* out) {
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long temp = (static_cast<long>(basic[i]) * scale + 50L) / 100L;
    out[i] = static_cast<int>(std::min(std::max(temp, 1L), 255L));
  }
}

// jfdctint.c, jpeg_fdct_islow: in place on [8][8] samples centred on 0;
// the outputs are scaled up by 8
void fdct_islow(int32_t* data) {
  const int kConstBits = 13, kPass1Bits = 2;
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    const int stride = pass == 0 ? 1 : 8;
    const int step = pass == 0 ? 8 : 1;
    const int odd_shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t* d = data + ctr * step;
      int64_t tmp0 = d[0 * stride] + d[7 * stride];
      int64_t tmp7 = d[0 * stride] - d[7 * stride];
      int64_t tmp1 = d[1 * stride] + d[6 * stride];
      int64_t tmp6 = d[1 * stride] - d[6 * stride];
      int64_t tmp2 = d[2 * stride] + d[5 * stride];
      int64_t tmp5 = d[2 * stride] - d[5 * stride];
      int64_t tmp3 = d[3 * stride] + d[4 * stride];
      int64_t tmp4 = d[3 * stride] - d[4 * stride];

      int64_t tmp10 = tmp0 + tmp3;
      int64_t tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2;
      int64_t tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0 * stride] = static_cast<int32_t>((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4 * stride] = static_cast<int32_t>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        d[0 * stride] = descale(tmp10 + tmp11, kPass1Bits);
        d[4 * stride] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      d[2 * stride] = descale(z1 + tmp13 * F0765, odd_shift);
      d[6 * stride] = descale(z1 + tmp12 * -F1847, odd_shift);

      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6;
      int64_t z3 = tmp4 + tmp6;
      int64_t z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      d[7 * stride] = descale(tmp4 + z1 + z3, odd_shift);
      d[5 * stride] = descale(tmp5 + z2 + z4, odd_shift);
      d[3 * stride] = descale(tmp6 + z2 + z3, odd_shift);
      d[1 * stride] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

// A component plane padded by replication: `stride` samples a row
struct Plane {
  int width = 0, height = 0;  // padded size
  std::vector<uint8_t> data;
  uint8_t at(int y, int x) const { return data[static_cast<size_t>(y) * width + x]; }
};

// Replicate the last column and row of an [h][w] plane out to [ph][pw]
Plane padded(const std::vector<uint8_t>& src, int h, int w, int ph, int pw) {
  Plane p;
  p.width = pw;
  p.height = ph;
  p.data.resize(static_cast<size_t>(ph) * pw);
  for (int y = 0; y < ph; ++y) {
    const uint8_t* row = &src[static_cast<size_t>(std::min(y, h - 1)) * w];
    uint8_t* out = &p.data[static_cast<size_t>(y) * pw];
    std::memcpy(out, row, w);
    std::fill(out + w, out + pw, row[w - 1]);
  }
  return p;
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>* out) : out_(out) {}

  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((uint32_t{1} << size) - 1));
    bits_ += size;
    while (bits_ >= 8) {
      uint8_t byte = static_cast<uint8_t>(acc_ >> (bits_ - 8));
      out_->push_back(byte);
      if (byte == 0xFF) out_->push_back(0);  // byte stuffing
      bits_ -= 8;
    }
    acc_ &= (uint64_t{1} << bits_) - 1;
  }

  // fill a partial byte with ones (jchuff.c flush_bits)
  void flush() {
    if (bits_ > 0) put(0x7F, 8 - bits_);
  }

 private:
  std::vector<uint8_t>* out_;
  uint64_t acc_ = 0;
  int bits_ = 0;
};

int bit_length(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int32_t* block, int* last_dc, const HuffTable& dc,
                  const HuffTable& ac) {
  int temp = block[0] - *last_dc;
  *last_dc = block[0];
  int temp2 = temp;
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = bit_length(temp);
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = block[kZigzag[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = bit_length(temp);
    int sym = (r << 4) + nbits;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

// The quantized coefficients of the 8x8 block of `p` at block (by, bx)
void block_coefs(const Plane& p, int by, int bx, const int* qtable, int32_t* out) {
  int32_t data[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) data[y * 8 + x] = static_cast<int32_t>(p.at(by * 8 + y, bx * 8 + x)) - 128;
  fdct_islow(data);
  for (int i = 0; i < 64; ++i) {
    const int32_t q = qtable[i] << 3;
    int32_t t = data[i];
    if (t < 0) {
      t = -((-t + (q >> 1)) / q);
    } else {
      t = (t + (q >> 1)) / q;
    }
    out[i] = t;
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dqt(std::vector<uint8_t>& o, int index, const int* table) {
  o.push_back(0xFF);
  o.push_back(0xDB);
  put16(o, 67);
  o.push_back(static_cast<uint8_t>(index));
  for (int i = 0; i < 64; ++i) o.push_back(static_cast<uint8_t>(table[kZigzag[i]]));
}

void put_dht(std::vector<uint8_t>& o, int index, const HuffTable& t) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + t.count);
  o.push_back(static_cast<uint8_t>(index));
  for (int i = 0; i < 16; ++i) o.push_back(t.bits[i]);
  for (int i = 0; i < t.count; ++i) o.push_back(t.vals[i]);
}

std::vector<uint8_t> encode(const uint8_t* rgb, int h, int w, int quality) {
  // jccolor.c rgb_ycc_convert: 16-bit fixed point, Cb / Cr rounded with
  // 0.5 - epsilon
  const int64_t kScale = 16, kHalf = int64_t{1} << (kScale - 1), kOffset = int64_t{128} << kScale;
  auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
  const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
  const int64_t rcb = fix(0.16874), gcb = fix(0.33126), half = fix(0.5);
  const int64_t gcr = fix(0.41869), bcr = fix(0.08131);
  const size_t n = static_cast<size_t>(h) * w;
  std::vector<uint8_t> ys(n), cbs(n), crs(n);
  for (size_t i = 0; i < n; ++i) {
    const int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    ys[i] = static_cast<uint8_t>((ry * r + gy * g + by * b + kHalf) >> kScale);
    cbs[i] = static_cast<uint8_t>((-rcb * r - gcb * g + half * b + kOffset + kHalf - 1) >> kScale);
    crs[i] = static_cast<uint8_t>((half * r - gcr * g - bcr * b + kOffset + kHalf - 1) >> kScale);
  }

  // component geometry (jcmaster.c): Y at 2x2, Cb / Cr at 1x1
  const int mcus_x = (w + 15) / 16, mcus_y = (h + 15) / 16;
  const int y_bw = (w + 7) / 8, y_bh = (h + 7) / 8;
  const int c_w = (w + 1) / 2, c_h = (h + 1) / 2;
  const int c_bw = (c_w + 7) / 8, c_bh = (c_h + 7) / 8;  // == mcus_x, mcus_y
  const int pw = mcus_x * 16, ph = mcus_y * 16;
  Plane yp = padded(ys, h, w, ph, pw);
  // chroma: replicate to the downsampler's input size, average 2x2 with
  // the alternating bias, then replicate the last downsampled row
  Plane chroma[2];
  const std::vector<uint8_t>* full[2] = {&cbs, &crs};
  for (int c = 0; c < 2; ++c) {
    Plane in = padded(*full[c], h, w, 2 * c_h, 2 * c_bw * 8);
    std::vector<uint8_t> down(static_cast<size_t>(c_h) * c_bw * 8);
    for (int oy = 0; oy < c_h; ++oy) {
      int bias = 1;
      for (int ox = 0; ox < c_bw * 8; ++ox) {
        const int s = in.at(2 * oy, 2 * ox) + in.at(2 * oy, 2 * ox + 1) + in.at(2 * oy + 1, 2 * ox) +
                      in.at(2 * oy + 1, 2 * ox + 1);
        down[static_cast<size_t>(oy) * c_bw * 8 + ox] = static_cast<uint8_t>((s + bias) >> 2);
        bias ^= 3;
      }
    }
    chroma[c] = padded(down, c_h, c_bw * 8, c_bh * 8, c_bw * 8);
  }

  int qlum[64], qchrom[64];
  scaled_table(kStdLuminanceQuant, quality, qlum);
  scaled_table(kStdChrominanceQuant, quality, qchrom);
  static const HuffTable dc_lum(kDcLumBits, kDcVals), dc_chrom(kDcChromBits, kDcVals);
  static const HuffTable ac_lum(kAcLumBits, kAcLumVals), ac_chrom(kAcChromBits, kAcChromVals);

  std::vector<uint8_t> o;
  o.reserve(n / 2 + 1024);
  const uint8_t header[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                            0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), header, header + sizeof(header));
  put_dqt(o, 0, qlum);
  put_dqt(o, 1, qchrom);
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 17);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 9);
  put_dht(o, 0x00, dc_lum);
  put_dht(o, 0x10, ac_lum);
  put_dht(o, 0x01, dc_chrom);
  put_dht(o, 0x11, ac_chrom);
  const uint8_t sos[14] = {0xFF, 0xDA, 0x00, 0x0C, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + 14);

  BitWriter bw(&o);
  int last_dc[3] = {0, 0, 0};
  int32_t blocks[4][64];
  int32_t cblock[64];
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      // Y: 2x2 blocks; past the component's blocks (jccoefct.c) a block is
      // a dummy: zero AC and the DC of the block before it in the MCU
      for (int yi = 0; yi < 2; ++yi) {
        const int by_ = 2 * my + yi;
        for (int xi = 0; xi < 2; ++xi) {
          const int bx_ = 2 * mx + xi;
          int32_t* blk = blocks[2 * yi + xi];
          if (by_ < y_bh && bx_ < y_bw) {
            block_coefs(yp, by_, bx_, qlum, blk);
          } else {
            std::memset(blk, 0, sizeof(blocks[0]));
            // a bottom dummy row copies the last block of the row above;
            // a right dummy the block to its left
            blk[0] = by_ < y_bh ? blocks[2 * yi + xi - 1][0] : blocks[1][0];
          }
        }
      }
      for (int b = 0; b < 4; ++b) encode_block(bw, blocks[b], &last_dc[0], dc_lum, ac_lum);
      for (int c = 0; c < 2; ++c) {
        block_coefs(chroma[c], my, mx, qchrom, cblock);
        encode_block(bw, cblock, &last_dc[1 + c], dc_chrom, ac_chrom);
      }
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace

extern "C" {

int jpeg_encoder_abi_version() { return 1; }

int jpeg_encode(const uint8_t* rgb, int height, int width, int quality, uint8_t* out, size_t out_cap,
                size_t* out_size) {
  if (rgb == nullptr || out_size == nullptr || height < 1 || width < 1 || height > 65535 || width > 65535)
    return 2;
  std::vector<uint8_t> bytes = encode(rgb, height, width, quality);
  *out_size = bytes.size();
  if (out == nullptr || bytes.size() > out_cap) return 1;
  std::memcpy(out, bytes.data(), bytes.size());
  return 0;
}

}  // extern "C"
