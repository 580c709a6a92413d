// Per-pixel loops of the image formats that data/raster_formats.py reads
// (netpbm, TGA, QOI, SGI, PCX / DCX, Sun raster, DDS), computing what
// Pillow's np.asarray(Image.open(path)) gives; the headers are parsed in
// Python, these loops take the pixel data:
//   - plain (ASCII) netpbm samples as Pillow's PpmPlainDecoder: comments run
//     from '#' through the line's end and join the tokens around them, each
//     value rescaled to round(v / maxval * out_max) (round half to even);
//     P1's bytes '0' / '1' need no whitespace between them;
//   - the run-length codes of TGA (a run stays inside its row, a literal
//     may run on into the next), Sun raster (0x80 0x00 is a literal 0x80,
//     0x80 n v n + 1 copies; runs cross rows), PCX (a run past the row's
//     end is an overrun) and SGI (one code stream per row and channel, from
//     the offset tables, 8- or 16-bit, with Pillow's bounds);
//   - IM's N-bit float samples as Pillow's "bit" decoder;
//   - QOI as Pillow's QoiDecoder (its index table starts at zeros, a run
//     leaves the table as it is);
//   - the BCn blocks of DDS as Pillow's bcn decoder: BC1-BC3 (BC2 and BC3
//     colour blocks always four-colour), BC4, BC5 (unsigned and signed),
//     BC6H (unsigned and signed half floats, clamped to [0, 1] and scaled by
//     255, truncated; a signed block's deltas are added and masked but not
//     sign-extended again) and BC7 (its eight modes), into RGBA / L / RGB
//     pixels; a signed BC5 block's blue is 128.
//
// C interface (loaded with ctypes by data/raster_formats.py): each returns 0
// on success, 1 for an unsupported variant, 2 for malformed data and 3 when
// the data ends early.
//   int raster_codecs_abi_version();
//   int netpbm_plain_decode(const uint8_t* src, size_t n, int bitonal, int maxval, int out_max,
//                           int32_t* dst, size_t count);
//   int tga_rle_decode(const uint8_t* src, size_t n, int pixel_bytes, size_t row_bytes, int rows,
//                      uint8_t* dst);
//   int sun_rle_decode(const uint8_t* src, size_t n, size_t row_bytes, int rows, uint8_t* dst);
//   int pcx_rle_decode(const uint8_t* src, size_t n, size_t row_bytes, int rows, uint8_t* dst);
//   int sgi_rle_decode(const uint8_t* file, size_t n, int bpc, int width, int height, int channels,
//                      uint8_t* dst);
//   int bit_decode(const uint8_t* src, size_t n, int bits, int width, int height, float* dst);
//   int qoi_decode(const uint8_t* src, size_t n, int channels, size_t pixels, uint8_t* dst);
//   int bcn_decode(const uint8_t* src, size_t n, int kind, int sign, int width, int height, uint8_t* dst);

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0, kUnsupported = 1, kCorrupt = 2, kTruncated = 3;

bool is_space(uint8_t c) { return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r'; }

// ---- BCn ---------------------------------------------------------------

struct Rgba {
  uint8_t r, g, b, a;
};

Rgba decode_565(uint16_t x) {
  Rgba c;
  int r = (x & 0xf800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7e0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1f) << 3;
  b |= b >> 5;
  c.r = static_cast<uint8_t>(r);
  c.g = static_cast<uint8_t>(g);
  c.b = static_cast<uint8_t>(b);
  c.a = 0xff;
  return c;
}

void decode_bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  uint16_t c0 = src[0] | (src[1] << 8), c1 = src[2] | (src[3] << 8);
  uint32_t lut = src[4] | (src[5] << 8) | (src[6] << 16) | (static_cast<uint32_t>(src[7]) << 24);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {static_cast<uint8_t>((2 * r0 + r1) / 3), static_cast<uint8_t>((2 * g0 + g1) / 3),
            static_cast<uint8_t>((2 * b0 + b1) / 3), 0xff};
    p[3] = {static_cast<uint8_t>((r0 + 2 * r1) / 3), static_cast<uint8_t>((g0 + 2 * g1) / 3),
            static_cast<uint8_t>((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {static_cast<uint8_t>((r0 + r1) / 2), static_cast<uint8_t>((g0 + g1) / 2),
            static_cast<uint8_t>((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC3's alpha / BC4 / BC5 channel block into byte `o` of 16 pixels of
// `stride` bytes; signed blocks are shifted by 128
void decode_bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0, a1;
  if (sign) {
    a0 = static_cast<int8_t>(src[0]) + 128;
    a1 = static_cast<int8_t>(src[1]) + 128;
  } else {
    a0 = src[0];
    a1 = src[1];
  }
  uint32_t lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  uint32_t lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  uint8_t a[8];
  a[0] = static_cast<uint8_t>(a0);
  a[1] = static_cast<uint8_t>(a1);
  if (a0 > a1) {
    for (int k = 1; k <= 6; k++) a[k + 1] = static_cast<uint8_t>(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k <= 4; k++) a[k + 1] = static_cast<uint8_t>(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

// BC7 (and BC6H's partitions): the mode table, partitions and anchors
struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                              {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                              {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                              {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
const uint16_t kBc7Si2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8,
    0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110,
    0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696,
    0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720,
    0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kBc7Si3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
const uint8_t kBc7Ai0[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                             15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                             15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                             6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kBc7Ai1[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                             3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                             8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                             3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kBc7Ai2[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                             15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                             15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                             15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) { return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4; }

int subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kBc7Si2[partition] >> n);
  if (ns == 3) return 3 & (kBc7Si3[partition] >> (2 * n));
  return 0;
}

int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

int get_bits(const uint8_t* src, int bit, int count) {
  if (!count) return 0;
  int by = bit >> 3;
  bit &= 7;
  if (bit + count <= 8) return (src[by] >> bit) & ((1 << count) - 1);
  int x = src[by] | (src[by + 1] << 8);
  return (x >> bit) & ((1 << count) - 1);
}

uint8_t expand_quantized(uint8_t v, int bits) {
  v = static_cast<uint8_t>(v << (8 - bits));
  return static_cast<uint8_t>(v | (v >> bits));
}

void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = static_cast<uint8_t>((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = static_cast<uint8_t>((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = static_cast<uint8_t>((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = static_cast<uint8_t>((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void decode_bc7_block(Rgba* col, const uint8_t* src) {
  if (!src[0]) {  // no mode bit: opaque black
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(src[0] & (1 << bit))) bit++;
  const Bc7Mode& info = kBc7Modes[bit];
  bit++;
  int cb = info.cb, ab = info.ab;
  const uint8_t* cw = weights(info.ib);
  const uint8_t* aw = weights((ab && info.ib2) ? info.ib2 : info.ib);
  auto load = [&](int n) {
    int v = get_bits(src, bit, n);
    bit += n;
    return v;
  };
  int partition = load(info.pb), rotation = load(info.rb), index_sel = load(info.isb);
  int numep = info.ns << 1;
  Rgba ep[6];
  for (int i = 0; i < numep; i++) ep[i].r = static_cast<uint8_t>(load(cb));
  for (int i = 0; i < numep; i++) ep[i].g = static_cast<uint8_t>(load(cb));
  for (int i = 0; i < numep; i++) ep[i].b = static_cast<uint8_t>(load(cb));
  for (int i = 0; i < numep; i++) ep[i].a = static_cast<uint8_t>(ab ? load(ab) : 255);
  auto with_p = [](uint8_t& x, int p) { x = static_cast<uint8_t>((x << 1) | p); };
  if (info.epb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) {
      int p = load(1);
      with_p(ep[i].r, p);
      with_p(ep[i].g, p);
      with_p(ep[i].b, p);
      if (ab) with_p(ep[i].a, p);
    }
  }
  if (info.spb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i += 2) {
      int p = load(1);
      for (int j = 0; j < 2; j++) {
        with_p(ep[i + j].r, p);
        with_p(ep[i + j].g, p);
        with_p(ep[i + j].b, p);
        if (ab) with_p(ep[i + j].a, p);
      }
    }
  }
  for (int i = 0; i < numep; i++) {
    ep[i].r = expand_quantized(ep[i].r, cb);
    ep[i].g = expand_quantized(ep[i].g, cb);
    ep[i].b = expand_quantized(ep[i].b, cb);
    if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
  }
  int cibit = bit;
  int aibit = cibit + 16 * info.ib - info.ns;
  for (int i = 0; i < 16; i++) {
    int s = subset(info.ns, partition, i) << 1;
    int ib = info.ib;
    if (i == 0) {
      ib--;
    } else if (info.ns == 2) {
      if (i == kBc7Ai0[partition]) ib--;
    } else if (info.ns == 3) {
      if (s == 2) {
        if (i == kBc7Ai1[partition]) ib--;
      } else if (s == 4) {
        if (i == kBc7Ai2[partition]) ib--;
      }
    }
    int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && info.ib2) {
      int ib2 = info.ib2;
      if (i == 0) ib2--;
      int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    uint8_t* swap = rotation == 1 ? &col[i].r : rotation == 2 ? &col[i].g : rotation == 3 ? &col[i].b : nullptr;
    if (swap) {
      uint8_t v = *swap;
      *swap = col[i].a;
      col[i].a = v;
    }
  }
}

// BC6H: the 14 modes (subsets, transformed, partition bits, endpoint bits,
// delta bits of r / g / b) and where each header bit goes: endpoint k
// (r0, g0, b0, r1, g1, b1, r2, g2, b2, r3, g3, b3) bit b as k * 16 + b
struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode kBc6Modes[14] = {{2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
                               {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
                               {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
                               {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
                               {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
// each mode's header after its mode bits, as (endpoint, high bit, low bit)
// fields in storage order; a field with high < low is stored reversed
struct Field {
  int ep, hi, lo;
};
enum { R0, G0, B0, R1, G1, B1, R2, G2, B2, R3, G3, B3 };
const std::vector<std::vector<Field>> kBc6Layouts = {
    {{G2, 4, 4}, {B2, 4, 4}, {B3, 4, 4}, {R0, 9, 0}, {G0, 9, 0}, {B0, 9, 0}, {R1, 4, 0}, {G3, 4, 4}, {G2, 3, 0},
     {G1, 4, 0}, {B3, 0, 0}, {G3, 3, 0}, {B1, 4, 0}, {B3, 1, 1}, {B2, 3, 0}, {R2, 4, 0}, {B3, 2, 2}, {R3, 4, 0},
     {B3, 3, 3}},
    {{G2, 5, 5}, {G3, 4, 4}, {G3, 5, 5}, {R0, 6, 0}, {B3, 0, 0}, {B3, 1, 1}, {B2, 4, 4}, {G0, 6, 0}, {B2, 5, 5},
     {B3, 2, 2}, {G2, 4, 4}, {B0, 6, 0}, {B3, 3, 3}, {B3, 5, 5}, {B3, 4, 4}, {R1, 5, 0}, {G2, 3, 0}, {G1, 5, 0},
     {G3, 3, 0}, {B1, 5, 0}, {B2, 3, 0}, {R2, 5, 0}, {R3, 5, 0}},
    {{R0, 9, 0}, {G0, 9, 0}, {B0, 9, 0}, {R1, 4, 0}, {R0, 10, 10}, {G2, 3, 0}, {G1, 3, 0}, {G0, 10, 10},
     {B3, 0, 0}, {G3, 3, 0}, {B1, 3, 0}, {B0, 10, 10}, {B3, 1, 1}, {B2, 3, 0}, {R2, 4, 0}, {B3, 2, 2}, {R3, 4, 0},
     {B3, 3, 3}},
    {{R0, 9, 0}, {G0, 9, 0}, {B0, 9, 0}, {R1, 3, 0}, {R0, 10, 10}, {G3, 4, 4}, {G2, 3, 0}, {G1, 4, 0},
     {G0, 10, 10}, {G3, 3, 0}, {B1, 3, 0}, {B0, 10, 10}, {B3, 1, 1}, {B2, 3, 0}, {R2, 3, 0}, {B3, 0, 0},
     {B3, 2, 2}, {R3, 3, 0}, {G2, 4, 4}, {B3, 3, 3}},
    {{R0, 9, 0}, {G0, 9, 0}, {B0, 9, 0}, {R1, 3, 0}, {R0, 10, 10}, {B2, 4, 4}, {G2, 3, 0}, {G1, 3, 0},
     {G0, 10, 10}, {B3, 0, 0}, {G3, 3, 0}, {B1, 4, 0}, {B0, 10, 10}, {B2, 3, 0}, {R2, 3, 0}, {B3, 1, 1},
     {B3, 2, 2}, {R3, 3, 0}, {B3, 4, 4}, {B3, 3, 3}},
    {{R0, 8, 0}, {B2, 4, 4}, {G0, 8, 0}, {G2, 4, 4}, {B0, 8, 0}, {B3, 4, 4}, {R1, 4, 0}, {G3, 4, 4}, {G2, 3, 0},
     {G1, 4, 0}, {B3, 0, 0}, {G3, 3, 0}, {B1, 4, 0}, {B3, 1, 1}, {B2, 3, 0}, {R2, 4, 0}, {B3, 2, 2}, {R3, 4, 0},
     {B3, 3, 3}},
    {{R0, 7, 0}, {G3, 4, 4}, {B2, 4, 4}, {G0, 7, 0}, {B3, 2, 2}, {G2, 4, 4}, {B0, 7, 0}, {B3, 3, 3}, {B3, 4, 4},
     {R1, 5, 0}, {G2, 3, 0}, {G1, 4, 0}, {B3, 0, 0}, {G3, 3, 0}, {B1, 4, 0}, {B3, 1, 1}, {B2, 3, 0}, {R2, 5, 0},
     {R3, 5, 0}},
    {{R0, 7, 0}, {B3, 0, 0}, {B2, 4, 4}, {G0, 7, 0}, {G2, 5, 5}, {G2, 4, 4}, {B0, 7, 0}, {G3, 5, 5}, {B3, 4, 4},
     {R1, 4, 0}, {G3, 4, 4}, {G2, 3, 0}, {G1, 5, 0}, {G3, 3, 0}, {B1, 4, 0}, {B3, 1, 1}, {B2, 3, 0}, {R2, 4, 0},
     {B3, 2, 2}, {R3, 4, 0}, {B3, 3, 3}},
    {{R0, 7, 0}, {B3, 1, 1}, {B2, 4, 4}, {G0, 7, 0}, {B2, 5, 5}, {G2, 4, 4}, {B0, 7, 0}, {B3, 5, 5}, {B3, 4, 4},
     {R1, 4, 0}, {G3, 4, 4}, {G2, 3, 0}, {G1, 4, 0}, {B3, 0, 0}, {G3, 3, 0}, {B1, 5, 0}, {B2, 3, 0}, {R2, 4, 0},
     {B3, 2, 2}, {R3, 4, 0}, {B3, 3, 3}},
    {{R0, 5, 0}, {G3, 4, 4}, {B3, 0, 0}, {B3, 1, 1}, {B2, 4, 4}, {G0, 5, 0}, {G2, 5, 5}, {B2, 5, 5}, {B3, 2, 2},
     {G2, 4, 4}, {B0, 5, 0}, {G3, 5, 5}, {B3, 3, 3}, {B3, 5, 5}, {B3, 4, 4}, {R1, 5, 0}, {G2, 3, 0}, {G1, 5, 0},
     {G3, 3, 0}, {B1, 5, 0}, {B2, 3, 0}, {R2, 5, 0}, {R3, 5, 0}},
    {{R0, 9, 0}, {G0, 9, 0}, {B0, 9, 0}, {R1, 9, 0}, {G1, 9, 0}, {B1, 9, 0}},
    {{R0, 9, 0}, {G0, 9, 0}, {B0, 9, 0}, {R1, 8, 0}, {R0, 10, 10}, {G1, 8, 0}, {G0, 10, 10}, {B1, 8, 0},
     {B0, 10, 10}},
    {{R0, 9, 0}, {G0, 9, 0}, {B0, 9, 0}, {R1, 7, 0}, {R0, 10, 11}, {G1, 7, 0}, {G0, 10, 11}, {B1, 7, 0},
     {B0, 10, 11}},
    {{R0, 9, 0}, {G0, 9, 0}, {B0, 9, 0}, {R1, 3, 0}, {R0, 10, 15}, {G1, 3, 0}, {G0, 10, 15}, {B1, 3, 0},
     {B0, 10, 15}},
};

// per mode, the endpoint bit that each header bit sets (k * 16 + b)
std::vector<std::vector<uint8_t>> bc6_packings() {
  std::vector<std::vector<uint8_t>> out;
  for (const auto& layout : kBc6Layouts) {
    std::vector<uint8_t> bits;
    for (const Field& f : layout) {
      if (f.hi >= f.lo) {
        for (int b = f.lo; b <= f.hi; b++) bits.push_back(static_cast<uint8_t>(f.ep * 16 + b));
      } else {  // stored from its high bit down: [10:11] is bit 11 then bit 10
        for (int b = f.lo; b >= f.hi; b--) bits.push_back(static_cast<uint8_t>(f.ep * 16 + b));
      }
    }
    out.push_back(bits);
  }
  return out;
}

void sign_extend(uint16_t* v, int prec) {
  int x = *v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  *v = static_cast<uint16_t>(x);
}

int bc6_unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = static_cast<int16_t>(v);
  if (prec >= 16) return x;
  bool s = false;
  if (x < 0) {
    s = true;
    x = -x;
  }
  if (x != 0) {
    if (x >= (1 << (prec - 1)) - 1)
      x = 0x7fff;
    else
      x = ((x << 15) + 0x4000) >> (prec - 1);
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = static_cast<uint32_t>(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= static_cast<uint32_t>(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float(static_cast<uint16_t>(0x8000 | (((-v) * 31) / 32)));
    return half_to_float(static_cast<uint16_t>((v * 31) / 32));
  }
  return half_to_float(static_cast<uint16_t>((v * 31) / 64));
}

uint8_t bc6_clamp(float value) {
  if (value < 0.0f) return 0;
  if (value > 1.0f) return 255;
  return static_cast<uint8_t>(value * 255.0f);
}

void bc6_lerp(Rgba* col, const int* e0, const int* e1, int s, bool sign) {
  int t = 64 - s;
  col->r = bc6_clamp(bc6_finalize((e0[0] * t + e1[0] * s) >> 6, sign));
  col->g = bc6_clamp(bc6_finalize((e0[1] * t + e1[1] * s) >> 6, sign));
  col->b = bc6_clamp(bc6_finalize((e0[2] * t + e1[2] * s) >> 6, sign));
  col->a = 255;
}

void decode_bc6_block(Rgba* col, const uint8_t* src, bool sign, const std::vector<std::vector<uint8_t>>& packings) {
  int bit = 5, ib = 3;
  int mode = src[0] & 0x1f;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
    ib = 4;
  }
  if (mode >= 14) {  // a reserved mode: every pixel 0
    std::memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const Bc6Mode& info = kBc6Modes[mode];
  const uint8_t* cw = weights(ib);
  int numep = info.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {0};
  const auto& packing = packings[mode];
  for (size_t i = 0; i < packing.size(); i++) {
    int dw = packing[i] >> 4, di = packing[i] & 15;
    ep[dw] = static_cast<uint16_t>(ep[dw] | (get_bit(src, bit + static_cast<int>(i)) << di));
  }
  bit += static_cast<int>(packing.size());
  int partition = get_bits(src, bit, info.pb);
  bit += info.pb;
  int mask = (1 << info.epb) - 1;
  if (sign) {
    for (int k = 0; k < 3; k++) sign_extend(&ep[k], info.epb);
  }
  if (sign || info.tr) {
    for (int i = 3; i < numep; i += 3) {
      sign_extend(&ep[i], info.rb);
      sign_extend(&ep[i + 1], info.gb);
      sign_extend(&ep[i + 2], info.bb);
    }
  }
  if (info.tr) {  // the sums are masked and, as Pillow leaves them, not sign-extended again
    for (int i = 3; i < numep; i++) ep[i] = static_cast<uint16_t>((ep[i] + ep[i % 3]) & mask);
  }
  int ueps[12];
  for (int i = 0; i < numep; i++) ueps[i] = bc6_unquantize(ep[i], info.epb, sign);
  for (int i = 0; i < 16; i++) {
    int s = subset(info.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0 || (info.ns == 2 && i == kBc7Ai0[partition])) ib2--;
    int i0 = get_bits(src, bit, ib2);
    bit += ib2;
    bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
  }
}

}  // namespace

extern "C" int raster_codecs_abi_version() { return 1; }

extern "C" int netpbm_plain_decode(const uint8_t* src, size_t n, int bitonal, int maxval, int out_max, int32_t* dst,
                                   size_t count) {
  // comments removed ('#' through the next CR or LF, which goes too), then
  // whitespace-separated tokens
  std::vector<uint8_t> text;
  text.reserve(n);
  for (size_t i = 0; i < n; i++) {
    if (src[i] == '#') {
      while (i < n && src[i] != '\n' && src[i] != '\r') i++;
      continue;
    }
    text.push_back(src[i]);
  }
  size_t got = 0;
  size_t i = 0;
  const size_t m = text.size();
  while (got < count) {
    while (i < m && is_space(text[i])) i++;
    if (i >= m) return kTruncated;
    if (bitonal) {  // every byte is a token: '0' white (255), '1' black (0)
      if (text[i] != '0' && text[i] != '1') return kCorrupt;
      dst[got++] = text[i] == '0' ? 255 : 0;
      i++;
      continue;
    }
    size_t start = i;
    while (i < m && !is_space(text[i])) i++;
    if (i - start > 10) return kCorrupt;
    size_t p = start;
    if (text[p] == '+' || text[p] == '-') p++;
    if (p == i) return kCorrupt;
    long long value = 0;
    for (; p < i; p++) {
      if (text[p] < '0' || text[p] > '9') return kCorrupt;
      value = value * 10 + (text[p] - '0');
    }
    if (text[start] == '-' && value != 0) return kCorrupt;  // negative
    if (value > maxval) return kCorrupt;
    dst[got++] = static_cast<int32_t>(std::nearbyint(static_cast<double>(value) / maxval * out_max));
  }
  return kOk;
}

extern "C" int tga_rle_decode(const uint8_t* src, size_t n, int pixel_bytes, size_t row_bytes, int rows,
                              uint8_t* dst) {
  const size_t total = row_bytes * static_cast<size_t>(rows);
  size_t pos = 0, i = 0;
  while (pos < total) {
    if (i >= n) return kTruncated;
    size_t len = static_cast<size_t>(pixel_bytes) * ((src[i] & 0x7f) + 1);
    if (src[i] & 0x80) {
      if (i + 1 + pixel_bytes > n) return kTruncated;
      if (pos % row_bytes + len > row_bytes) return kCorrupt;  // a run stays in its row
      for (size_t k = 0; k < len; k += pixel_bytes) std::memcpy(dst + pos + k, src + i + 1, pixel_bytes);
      pos += len;
      i += 1 + pixel_bytes;
    } else {
      if (i + 1 + len > n) return kTruncated;
      size_t take = len < total - pos ? len : total - pos;
      std::memcpy(dst + pos, src + i + 1, take);
      pos += take;
      i += 1 + len;
    }
  }
  return kOk;
}

extern "C" int sun_rle_decode(const uint8_t* src, size_t n, size_t row_bytes, int rows, uint8_t* dst) {
  const size_t total = row_bytes * static_cast<size_t>(rows);
  size_t pos = 0, i = 0;
  while (pos < total) {
    if (i >= n) return kTruncated;
    if (src[i] == 0x80) {
      if (i + 2 > n) return kTruncated;
      if (src[i + 1] == 0) {
        dst[pos++] = 0x80;
        i += 2;
        continue;
      }
      if (i + 3 > n) return kTruncated;
      size_t len = static_cast<size_t>(src[i + 1]) + 1;
      if (len > total - pos) len = total - pos;
      std::memset(dst + pos, src[i + 2], len);
      pos += len;
      i += 3;
    } else {
      dst[pos++] = src[i++];
    }
  }
  return kOk;
}

extern "C" int pcx_rle_decode(const uint8_t* src, size_t n, size_t row_bytes, int rows, uint8_t* dst) {
  const size_t total = row_bytes * static_cast<size_t>(rows);
  size_t pos = 0, i = 0;
  while (pos < total) {
    if (i >= n) return kTruncated;
    if ((src[i] & 0xC0) == 0xC0) {
      if (i + 2 > n) return kTruncated;
      size_t len = src[i] & 0x3F;
      if (pos % row_bytes + len > row_bytes) return kCorrupt;  // a run past the row's end
      std::memset(dst + pos, src[i + 1], len);
      pos += len;
      i += 2;
    } else {
      dst[pos++] = src[i++];
    }
  }
  return kOk;
}

extern "C" int sgi_rle_decode(const uint8_t* file, size_t n, int bpc, int width, int height, int channels,
                              uint8_t* dst) {
  // dst: [height][width][channels] samples of bpc bytes (big-endian), in
  // the file's row order (bottom row first). As Pillow's decoder: the row
  // lengths of the table count codes, not bytes (a negative one none); a code stream may run to
  // one byte before the file's end; a row stream that ends at its last
  // allowed code with a run stops the whole decode (the rows after it stay
  // 0); rows reuse one buffer, so a row left short keeps the last row's
  // samples.
  if (n < 512) return kTruncated;
  const uint8_t* data = file + 512;
  const long long last = static_cast<long long>(n) - 512 - 1;  // the last byte a code may read
  const size_t tables = static_cast<size_t>(height) * channels;
  if (static_cast<long long>(n) - 512 < static_cast<long long>(8 * tables)) return kCorrupt;
  auto be32 = [&](size_t p) {
    return (static_cast<uint32_t>(data[p]) << 24) | (data[p + 1] << 16) | (data[p + 2] << 8) | data[p + 3];
  };
  const size_t step = static_cast<size_t>(channels) * bpc, row_bytes = step * width;
  std::vector<uint8_t> row(row_bytes, 0);
  for (int y = 0; y < height; y++) {
    for (int z = 0; z < channels; z++) {
      size_t t = static_cast<size_t>(z) * height + y;
      uint32_t start = be32(4 * t);
      long long codes = static_cast<int32_t>(be32(4 * (tables + t)));  // signed: a negative length reads nothing
      if (start < 512) return kCorrupt;
      long long src = start - 512;
      uint8_t* dest = row.data() + static_cast<size_t>(z) * bpc;
      int x = 0;
      for (; codes > 0; codes--) {
        if (src + bpc - 1 > last) return kCorrupt;
        int pixel = data[src + bpc - 1];  // a 16-bit code's low byte
        src += bpc;
        if (codes == 1 && pixel != 0) return kOk;  // Pillow stops decoding here
        int count = pixel & 0x7f;
        if (!count) break;
        if (x + count > width) return kCorrupt;
        if (pixel & 0x80) {
          if (src + static_cast<long long>(count) * bpc > last) return kCorrupt;
          for (int k = 0; k < count; k++, x++, src += bpc) std::memcpy(dest + x * step, data + src, bpc);
        } else {
          if (src + (bpc == 1 ? 0 : 2) > last) return kCorrupt;  // Pillow's 16-bit test asks one byte more
          for (int k = 0; k < count; k++, x++) std::memcpy(dest + x * step, data + src, bpc);
          src += bpc;
        }
      }
    }
    std::memcpy(dst + static_cast<size_t>(y) * row_bytes, row.data(), row_bytes);
  }
  return kOk;
}

extern "C" int bit_decode(const uint8_t* src, size_t n, int bits, int width, int height, float* dst) {
  // Pillow's "bit" decoder as IM's "L*N" images use it (N not 8, 16, 32):
  // N-bit unsigned samples, the bit buffer filled from the low end, rows
  // starting on a byte; dst [height][width] in the file's row order
  if (bits < 1 || bits >= 32) return kUnsupported;
  const unsigned long long mask = (1ull << bits) - 1;
  unsigned long long buffer = 0;
  int count = 0, x = 0, y = 0;
  for (size_t i = 0; i < n; i++) {
    const uint8_t byte = src[i];
    buffer |= static_cast<unsigned long long>(byte) << count;
    count += 8;
    while (count >= bits) {
      const unsigned long long value = buffer & mask;
      if (count > 32)  // Pillow's buffer overflow: refilled from the last byte
        buffer = byte >> (8 - (count - bits));
      else
        buffer >>= bits;
      count -= bits;
      dst[static_cast<size_t>(y) * width + x] = static_cast<float>(value);
      if (++x >= width) {
        if (++y >= height) return kOk;
        x = 0;
        count = 0;  // each row starts on a byte
      }
    }
  }
  return kTruncated;
}

extern "C" int qoi_decode(const uint8_t* src, size_t n, int channels, size_t pixels, uint8_t* dst) {
  uint8_t index[64][4];
  std::memset(index, 0, sizeof(index));
  uint8_t px[4] = {0, 0, 0, 255};
  size_t i = 0, done = 0;
  auto emit = [&](const uint8_t* v) {
    std::memcpy(dst + done * channels, v, channels);
    done++;
  };
  auto remember = [&]() { std::memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4); };
  while (done < pixels) {
    if (i >= n) return kTruncated;
    uint8_t b = src[i++];
    if (b == 0xfe) {
      if (i + 3 > n) return kTruncated;
      std::memcpy(px, src + i, 3);
      i += 3;
    } else if (b == 0xff) {
      if (i + 4 > n) return kTruncated;
      std::memcpy(px, src + i, 4);
      i += 4;
    } else if ((b >> 6) == 0) {
      std::memcpy(px, index[b & 63], 4);
    } else if ((b >> 6) == 1) {
      px[0] = static_cast<uint8_t>(px[0] + ((b >> 4) & 3) - 2);
      px[1] = static_cast<uint8_t>(px[1] + ((b >> 2) & 3) - 2);
      px[2] = static_cast<uint8_t>(px[2] + (b & 3) - 2);
    } else if ((b >> 6) == 2) {
      if (i >= n) return kTruncated;
      uint8_t b2 = src[i++];
      int dg = (b & 63) - 32;
      px[0] = static_cast<uint8_t>(px[0] + dg + ((b2 >> 4) & 15) - 8);
      px[1] = static_cast<uint8_t>(px[1] + dg);
      px[2] = static_cast<uint8_t>(px[2] + dg + (b2 & 15) - 8);
    } else {  // a run: the table stays as it is
      size_t run = (b & 63) + 1;
      for (size_t k = 0; k < run && done < pixels; k++) emit(px);
      continue;
    }
    remember();
    emit(px);
  }
  return kOk;
}

extern "C" int bcn_decode(const uint8_t* src, size_t n, int kind, int sign, int width, int height, uint8_t* dst) {
  // kind 1-7 (BC1 ... BC7); dst: [height][width][bytes a pixel] of the
  // mode (RGBA for 1-3 and 7, L for 4, RGB for 5 and 6)
  const int block_bytes = (kind == 1 || kind == 4) ? 8 : 16;
  const int out_bytes = kind == 4 ? 1 : (kind == 5 || kind == 6) ? 3 : 4;
  const int bw = (width + 3) / 4, bh = (height + 3) / 4;
  if (static_cast<size_t>(bw) * bh * block_bytes > n) return kTruncated;
  std::vector<std::vector<uint8_t>> packings;
  if (kind == 6) packings = bc6_packings();
  Rgba col[16];
  uint8_t lum[16];
  const uint8_t* block = src;
  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++, block += block_bytes) {
      std::memset(col, 0, sizeof(col));
      switch (kind) {
        case 1:
          decode_bc1_color(col, block, false);
          break;
        case 2:
          decode_bc1_color(col, block + 8, true);
          for (int k = 0; k < 16; k++) {
            int v = 0xf & (block[(k * 4) >> 3] >> ((k * 4) & 7));
            col[k].a = static_cast<uint8_t>((v << 4) | v);
          }
          break;
        case 3:
          decode_bc1_color(col, block + 8, true);
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), block, 4, 3, false);
          break;
        case 4:
          decode_bc3_alpha(lum, block, 1, 0, sign != 0);
          break;
        case 5:  // a signed block's blue is signed 0
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), block, 4, 0, sign != 0);
          decode_bc3_alpha(reinterpret_cast<uint8_t*>(col), block + 8, 4, 1, sign != 0);
          if (sign) {
            for (int k = 0; k < 16; k++) col[k].b = 128;
          }
          break;
        case 6:
          decode_bc6_block(col, block, sign != 0, packings);
          break;
        case 7:
          decode_bc7_block(col, block);
          break;
        default:
          return kUnsupported;
      }
      for (int k = 0; k < 16; k++) {
        int x = bx * 4 + (k & 3), y = by * 4 + (k >> 2);
        if (x >= width || y >= height) continue;
        uint8_t* out = dst + (static_cast<size_t>(y) * width + x) * out_bytes;
        if (kind == 4) {
          out[0] = lum[k];
        } else {
          const uint8_t px[4] = {col[k].r, col[k].g, col[k].b, col[k].a};
          std::memcpy(out, px, out_bytes);
        }
      }
    }
  }
  return kOk;
}
