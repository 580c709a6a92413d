// Byte-level decoders of the image formats that data/image_formats.py reads
// (TIFF, BMP and GIF), computing what Pillow's np.asarray(Image.open(path))
// gives; the file structure (IFDs, headers, palettes, modes) is parsed in
// Python, these loops take the compressed bytes:
//   - TIFF LZW as libtiff's LZWDecode (MSB-first codes of 9-12 bits, the
//     code width grows one code early, 256 clears, 257 ends); the old-style
//     LSB-first variant returns 1;
//   - PackBits (TIFF compression 32773);
//   - BMP RLE8 / RLE4 as Pillow's BmpRleDecoder, quirks included: a delta
//     escape consumes four bytes, an odd RLE4 absolute run reads count / 2
//     bytes, and the word alignment is of the absolute file position;
//   - GIF LZW (LSB-first codes, the width grows after code 2^n - 1 is
//     added, 12 bits at most) with its four interlace passes, written into
//     the frame's rectangle of a canvas; a terminator block or the end code
//     leaves the rest of the rectangle as it was.
//
//   - Zstandard frames (RFC 8878; TIFF compression 50000);
//   - CCITT modified Huffman, T.4 and T.6 bilevel rows (TIFF compressions
//     2, 3 and 4), one byte a pixel, 1 for black.
//
// C interface (loaded with ctypes by data/image_formats.py): each returns 0
// on success, 1 for an unsupported variant, 2 for malformed data.
//   int image_codecs_abi_version();
//   int tiff_lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written);
//   int packbits_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written);
//   int bmp_rle_decode(const uint8_t* src, size_t n, size_t file_pos, int width, int height, int rle4,
//                      uint8_t* dst, size_t cap, size_t* length);
//   int gif_lzw_decode(const uint8_t* src, size_t n, int bits, int interlace, int x0, int y0, int w,
//                      int h, int canvas_w, uint8_t* canvas);
//   int zstd_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written);
//   int ccitt_decode(const uint8_t* src, size_t n, int width, int rows, int scheme, int t4options,
//                    uint8_t* dst, size_t cap, size_t* written_rows);

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// A dictionary of strings as (prefix code, last byte, first byte, length).
struct LzwTable {
  std::vector<int> prefix, length;
  std::vector<uint8_t> last, first;
  explicit LzwTable(int size) : prefix(size, -1), length(size, 0), last(size, 0), first(size, 0) {}
  void root(int code) {
    prefix[code] = -1;
    length[code] = 1;
    last[code] = first[code] = static_cast<uint8_t>(code);
  }
  void add(int code, int pre, uint8_t byte) {
    prefix[code] = pre;
    length[code] = length[pre] + 1;
    last[code] = byte;
    first[code] = first[pre];
  }
  // the string of `code`, written backwards from its end
  template <class Put>
  void emit(int code, Put put) const {
    int n = length[code];
    for (int i = n - 1, c = code; i >= 0; --i, c = prefix[c]) put(i, last[c]);
  }
};

}  // namespace

extern "C" int image_codecs_abi_version() { return 2; }

extern "C" int tiff_lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written) {
  *written = 0;
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return 1;  // old-style (LSB-first) LZW
  const int kClear = 256, kEnd = 257;
  LzwTable t(4096);
  for (int c = 0; c < 256; ++c) t.root(c);
  size_t bitpos = 0, out = 0;
  const size_t nbits = n * 8;
  int width = 9, next = 258, prev = -1;
  for (;;) {
    if (bitpos + width > nbits) break;  // the data ends without an end code
    int code = 0;
    for (int i = 0; i < width; ++i, ++bitpos) code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEnd) break;
    if (code == kClear) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    int entry;
    if (prev < 0) {
      if (code > 255) return 2;
      entry = code;
    } else if (code < next) {
      entry = code;
      if (next < 4096) t.add(next++, prev, t.first[code]);
    } else if (code == next && next < 4096) {
      t.add(next++, prev, t.first[prev]);
      entry = code;
    } else {
      return 2;
    }
    const size_t len = static_cast<size_t>(t.length[entry]);
    t.emit(entry, [&](int i, uint8_t b) {
      if (out + i < cap) dst[out + i] = b;
    });
    out += len;
    prev = entry;
    if (next + 1 >= (1 << width) && width < 12) ++width;  // one code early, as libtiff
    if (out >= cap) break;
  }
  *written = out < cap ? out : cap;
  return 0;
}

extern "C" int packbits_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written) {
  size_t i = 0, out = 0;
  while (i < n && out < cap) {
    int c = static_cast<int8_t>(src[i++]);
    if (c >= 0) {
      for (int k = 0; k <= c && i < n; ++k, ++i)
        if (out < cap) dst[out++] = src[i];
    } else if (c != -128) {
      if (i >= n) break;
      uint8_t b = src[i++];
      for (int k = 0; k < 1 - c && out < cap; ++k) dst[out++] = b;
    }
  }
  *written = out;
  return 0;
}

extern "C" int bmp_rle_decode(const uint8_t* src, size_t n, size_t file_pos, int width, int height, int rle4,
                              uint8_t* dst, size_t cap, size_t* length) {
  const size_t dest = static_cast<size_t>(width) * height;
  size_t len = 0, pos = 0;
  int x = 0;
  auto push = [&](uint8_t v) {
    if (len < cap) dst[len] = v;
    ++len;
  };
  while (len < dest) {
    if (pos + 2 > n) break;
    int num = src[pos], byte = src[pos + 1];
    pos += 2;
    if (num) {  // encoded mode
      if (x + num > width) num = width - x > 0 ? width - x : 0;
      for (int i = 0; i < num; ++i) push(rle4 ? static_cast<uint8_t>(i % 2 == 0 ? byte >> 4 : byte & 15) : byte);
      x += num;
    } else if (byte == 0) {  // end of line
      while (len % width != 0) push(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: Pillow reads two bytes, then the offsets from the two after them
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) return 2;
      int right = src[pos], up = src[pos + 1];
      pos += 2;
      for (size_t i = 0; i < static_cast<size_t>(right) + static_cast<size_t>(up) * width; ++i) push(0);
      x = static_cast<int>(len % width);
    } else {  // absolute mode
      size_t count = rle4 ? byte / 2 : byte;
      size_t got = count < n - pos ? count : n - pos;
      for (size_t i = 0; i < got; ++i) {
        uint8_t v = src[pos + i];
        if (rle4) {
          push(v >> 4);
          push(v & 15);
        } else {
          push(v);
        }
      }
      pos += got;
      if (got < count) break;
      x += byte;
      if ((file_pos + pos) % 2 != 0) ++pos;
    }
  }
  *length = len;
  return 0;
}

extern "C" int gif_lzw_decode(const uint8_t* src, size_t n, int bits, int interlace, int x0, int y0, int w, int h,
                              int canvas_w, uint8_t* canvas) {
  if (bits < 1 || bits > 11) return 2;
  if (w <= 0 || h <= 0) return 0;
  // the sub-blocks' data, up to the terminator block
  std::vector<uint8_t> data;
  for (size_t pos = 0; pos < n;) {
    size_t len = src[pos++];
    if (len == 0) break;
    if (len > n - pos) len = n - pos;
    data.insert(data.end(), src + pos, src + pos + len);
    pos += len;
  }
  const int clear = 1 << bits, end = clear + 1;
  LzwTable t(4096);
  for (int c = 0; c < clear; ++c) t.root(c);
  int codesize = bits + 1, next = clear + 2, prev = -1;
  size_t bitpos = 0;
  const size_t nbits = data.size() * 8;
  int x = 0, y = 0, pass = interlace ? 1 : 0, step = interlace ? 8 : 1;
  bool done = false;
  auto put = [&](uint8_t v) {
    if (done) return;
    canvas[static_cast<size_t>(y0 + y) * canvas_w + x0 + x] = v;
    if (++x < w) return;
    x = 0;
    y += step;
    while (y >= h) {
      if (pass == 1) {
        y = 4;
        pass = 2;
      } else if (pass == 2) {
        y = 2;
        step = 4;
        pass = 3;
      } else if (pass == 3) {
        y = 1;
        step = 2;
        pass = 4;
      } else {
        done = true;
        return;
      }
    }
  };
  std::vector<uint8_t> str;
  while (!done) {
    if (bitpos + codesize > nbits) break;
    int code = 0;
    for (int i = 0; i < codesize; ++i, ++bitpos) code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << i;
    if (code == clear) {
      codesize = bits + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == end) break;
    int entry;
    if (prev < 0) {
      if (code >= clear) return 2;
      entry = code;
    } else if (code < next) {
      entry = code;
      if (next < 4096) {
        t.add(next, prev, t.first[code]);
        if (next == (1 << codesize) - 1 && codesize < 12) ++codesize;
        ++next;
      }
    } else if (code == next && next < 4096) {
      t.add(next, prev, t.first[prev]);
      entry = code;
      if (next == (1 << codesize) - 1 && codesize < 12) ++codesize;
      ++next;
    } else {
      return 2;
    }
    str.resize(static_cast<size_t>(t.length[entry]));
    t.emit(entry, [&](int i, uint8_t b) { str[static_cast<size_t>(i)] = b; });
    for (uint8_t v : str) put(v);
    prev = entry;
  }
  return 0;
}

// ---- Zstandard (RFC 8878), TIFF compression 50000 ----------------------
//
// Frames (and skippable frames) one after another; raw, RLE and compressed
// blocks; literals raw, RLE or Huffman-coded (1 or 4 streams, the tree
// described by FSE-coded or direct weights, or repeated); sequences with
// predefined, RLE, FSE-coded or repeated tables, the three repeat
// offsets. No dictionaries (returns 1); the content checksum is skipped.

namespace zstd {

struct Corrupt {};
struct Unsupported {};

// LSB-first bits read forwards (FSE table descriptions)
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      size_t b = pos + i;
      if (b / 8 < n) v |= static_cast<uint32_t>((p[b / 8] >> (b % 8)) & 1) << i;
    }
    return v;
  }
  void skip(int k) { pos += k; }
};

// A backward bitstream: read from the end, past the final byte's highest
// set bit; a read below the start gives zeros (the pos goes negative)
struct BackwardBits {
  const uint8_t* p;
  int64_t pos;
  BackwardBits(const uint8_t* src, size_t n) : p(src) {
    if (n == 0 || src[n - 1] == 0) throw Corrupt{};
    int hb = 7;
    while (!((src[n - 1] >> hb) & 1)) --hb;
    pos = static_cast<int64_t>(8 * (n - 1) + hb);
  }
  uint64_t read(int k) {
    if (k == 0) return 0;
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
  uint64_t peek(int k) const {
    uint64_t v = 0;
    for (int i = 0; i < k; ++i) {
      int64_t b = pos - k + i;
      if (b >= 0) v |= static_cast<uint64_t>((p[b / 8] >> (b % 8)) & 1) << i;
    }
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

inline int highbit(uint32_t v) {
  int r = 0;
  while (v >>= 1) ++r;
  return r;
}

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct Fse {
  int log = 0;
  std::vector<FseEntry> table;
  void build(const std::vector<int>& norm, int accuracy) {
    log = accuracy;
    const int size = 1 << accuracy;
    table.assign(size, FseEntry{0, 0, 0});
    std::vector<int> next(norm.size());
    int high = size - 1;
    for (size_t s = 0; s < norm.size(); ++s) {
      if (norm[s] == -1) {
        table[high--].symbol = static_cast<uint16_t>(s);
        next[s] = 1;
      } else {
        next[s] = norm[s];
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int position = 0;
    for (size_t s = 0; s < norm.size(); ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        table[position].symbol = static_cast<uint16_t>(s);
        do position = (position + step) & mask;
        while (position > high);
      }
    }
    if (position != 0) throw Corrupt{};
    for (int u = 0; u < size; ++u) {
      const int s = table[u].symbol;
      const int x = next[s]++;
      const int bits = accuracy - highbit(static_cast<uint32_t>(x));
      table[u].bits = static_cast<uint8_t>(bits);
      table[u].base = static_cast<uint16_t>((x << bits) - size);
    }
  }
  void rle(int symbol) {
    log = 0;
    table.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
  }
};

// FSE_readNCount: a table description at `src`; returns the bytes used
size_t read_fse(const uint8_t* src, size_t n, int max_symbol, int max_log, Fse& fse) {
  ForwardBits in{src, n};
  const int accuracy = static_cast<int>(in.peek(4)) + 5;
  in.skip(4);
  if (accuracy > max_log) throw Corrupt{};
  int remaining = (1 << accuracy) + 1, threshold = 1 << accuracy, bits = accuracy + 1;
  std::vector<int> norm;
  bool previous0 = false;
  while (remaining > 1 && static_cast<int>(norm.size()) <= max_symbol) {
    if (previous0) {
      int repeat;
      do {
        repeat = static_cast<int>(in.peek(2));
        in.skip(2);
        for (int i = 0; i < repeat; ++i) norm.push_back(0);
      } while (repeat == 3);
      if (static_cast<int>(norm.size()) > max_symbol) throw Corrupt{};
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const uint32_t v = in.peek(bits);
    if (static_cast<int>(v & (threshold - 1)) < max) {
      count = static_cast<int>(v & (threshold - 1));
      in.skip(bits - 1);
    } else {
      count = static_cast<int>(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      in.skip(bits);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm.push_back(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --bits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || in.pos > 8 * n) throw Corrupt{};
  fse.build(norm, accuracy);
  return (in.pos + 7) / 8;
}

struct FseState {
  const Fse* fse;
  uint32_t state = 0;
  void init(BackwardBits& in) { state = static_cast<uint32_t>(in.read(fse->log)); }
  int symbol() const { return fse->table[state].symbol; }
  void update(BackwardBits& in) {
    const FseEntry& e = fse->table[state];
    state = e.base + static_cast<uint32_t>(in.read(e.bits));
  }
};

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;  // indexed by max_bits peeked bits
  bool ready = false;
  void build(const std::vector<int>& weights) {
    // the last weight completes the sum to a power of two
    uint32_t total = 0;
    for (int w : weights)
      if (w) total += 1u << (w - 1);
    if (total == 0) throw Corrupt{};
    max_bits = highbit(total) + 1;
    const uint32_t left = (1u << max_bits) - total;
    if (left & (left - 1)) throw Corrupt{};
    std::vector<int> w = weights;
    w.push_back(highbit(left) + 1);
    if (max_bits > 11) throw Corrupt{};
    std::vector<uint32_t> rank(max_bits + 2, 0);
    for (int x : w) ++rank[x];
    uint32_t start = 0;
    for (int k = 1; k <= max_bits; ++k) {
      const uint32_t cur = start;
      start += rank[k] << (k - 1);
      rank[k] = cur;
    }
    symbol.assign(1u << max_bits, 0);
    bits.assign(1u << max_bits, 0);
    for (size_t s = 0; s < w.size(); ++s) {
      if (!w[s]) continue;
      const uint32_t len = (1u << w[s]) >> 1;
      for (uint32_t u = rank[w[s]]; u < rank[w[s]] + len; ++u) {
        symbol[u] = static_cast<uint8_t>(s);
        bits[u] = static_cast<uint8_t>(max_bits + 1 - w[s]);
      }
      rank[w[s]] += len;
    }
    ready = true;
  }
  void decode(const uint8_t* src, size_t n, uint8_t* out, size_t count) const {
    BackwardBits in(src, n);
    for (size_t i = 0; i < count; ++i) {
      const uint32_t v = static_cast<uint32_t>(in.peek(max_bits));
      out[i] = symbol[v];
      in.pos -= bits[v];
    }
    if (in.pos != 0) throw Corrupt{};
  }
};

// the tree description; returns the bytes used
size_t read_huffman(const uint8_t* src, size_t n, Huffman& huf) {
  if (n < 1) throw Corrupt{};
  const int header = src[0];
  std::vector<int> weights;
  size_t used;
  if (header < 128) {
    used = 1 + static_cast<size_t>(header);
    if (used > n) throw Corrupt{};
    Fse fse;
    const size_t t = read_fse(src + 1, header, 255, 6, fse);
    if (t >= static_cast<size_t>(header)) throw Corrupt{};
    BackwardBits in(src + 1 + t, header - t);
    FseState s1{&fse}, s2{&fse};
    s1.init(in);
    s2.init(in);
    while (true) {
      if (weights.size() > 255) throw Corrupt{};
      weights.push_back(s1.symbol());
      s1.update(in);
      if (in.overflowed()) {
        weights.push_back(s2.symbol());
        break;
      }
      weights.push_back(s2.symbol());
      s2.update(in);
      if (in.overflowed()) {
        weights.push_back(s1.symbol());
        break;
      }
    }
  } else {
    const int count = header - 127;
    used = 1 + static_cast<size_t>((count + 1) / 2);
    if (used > n) throw Corrupt{};
    for (int i = 0; i < count; ++i) weights.push_back((src[1 + i / 2] >> (i % 2 ? 0 : 4)) & 15);
  }
  huf.build(weights);
  return used;
}

const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,   12,   13,   14,    15,    16,    18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,  14,   15,   16,   17,   18,    19,    20,
                              21, 22, 23, 24, 25, 26, 27, 28,  29,  30,  31,  32,   33,   34,   35,   37,    39,    41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
  std::vector<uint8_t>& out;
  Huffman huf;
  Fse ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;

  explicit Frame(std::vector<uint8_t>& o) : out(o) {}

  size_t read_literals(const uint8_t* src, size_t n) {
    if (n < 1) throw Corrupt{};
    const int type = src[0] & 3, format = (src[0] >> 2) & 3;
    if (type < 2) {
      size_t regen, head;
      if (format == 0 || format == 2) {
        regen = src[0] >> 3;
        head = 1;
      } else if (format == 1) {
        if (n < 2) throw Corrupt{};
        regen = (src[0] >> 4) | (static_cast<size_t>(src[1]) << 4);
        head = 2;
      } else {
        if (n < 3) throw Corrupt{};
        regen = (src[0] >> 4) | (static_cast<size_t>(src[1]) << 4) | (static_cast<size_t>(src[2]) << 12);
        head = 3;
      }
      if (type == 0) {
        if (head + regen > n) throw Corrupt{};
        literals.assign(src + head, src + head + regen);
        return head + regen;
      }
      if (head + 1 > n) throw Corrupt{};
      literals.assign(regen, src[head]);
      return head + 1;
    }
    size_t head;
    int bits;
    if (format < 2) {
      head = 3;
      bits = 10;
    } else {
      head = format == 2 ? 4 : 5;
      bits = format == 2 ? 14 : 18;
    }
    if (n < head) throw Corrupt{};
    uint64_t v = 0;
    for (size_t i = 0; i < head; ++i) v |= static_cast<uint64_t>(src[i]) << (8 * i);
    v >>= 4;
    const size_t regen = static_cast<size_t>(v & ((1u << bits) - 1));
    const size_t size = static_cast<size_t>((v >> bits) & ((1u << bits) - 1));
    const bool four = format != 0;
    if (head + size > n) throw Corrupt{};
    const uint8_t* p = src + head;
    size_t left = size;
    if (type == 2) {
      const size_t t = read_huffman(p, left, huf);
      p += t;
      left -= t;
    } else if (!huf.ready) {
      throw Corrupt{};
    }
    literals.assign(regen, 0);
    if (!four) {
      huf.decode(p, left, literals.data(), regen);
    } else {
      if (left < 6) throw Corrupt{};
      const size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
      if (6 + s1 + s2 + s3 > left) throw Corrupt{};
      const size_t s4 = left - 6 - s1 - s2 - s3;
      const size_t per = (regen + 3) / 4;
      if (3 * per > regen) throw Corrupt{};
      const uint8_t* q = p + 6;
      huf.decode(q, s1, literals.data(), per);
      huf.decode(q + s1, s2, literals.data() + per, per);
      huf.decode(q + s1 + s2, s3, literals.data() + 2 * per, per);
      huf.decode(q + s1 + s2 + s3, s4, literals.data() + 3 * per, regen - 3 * per);
    }
    return head + size;
  }

  size_t read_table(const uint8_t* src, size_t n, int mode, Fse& fse, const int* dflt, int dflt_n, int dflt_log,
                    int max_symbol, int max_log) {
    if (mode == 0) {
      fse.build(std::vector<int>(dflt, dflt + dflt_n), dflt_log);
      return 0;
    }
    if (mode == 1) {
      if (n < 1 || src[0] > max_symbol) throw Corrupt{};
      fse.rle(src[0]);
      return 1;
    }
    if (mode == 2) return read_fse(src, n, max_symbol, max_log, fse);
    if (fse.table.empty()) throw Corrupt{};
    return 0;
  }

  void block(const uint8_t* src, size_t n) {
    const size_t lit = read_literals(src, n);
    const uint8_t* p = src + lit;
    size_t left = n - lit;
    if (left < 1) throw Corrupt{};
    size_t count = p[0];
    size_t head = 1;
    if (count >= 128 && count < 255) {
      if (left < 2) throw Corrupt{};
      count = ((count - 128) << 8) + p[1];
      head = 2;
    } else if (count == 255) {
      if (left < 3) throw Corrupt{};
      count = p[1] + (static_cast<size_t>(p[2]) << 8) + 0x7F00;
      head = 3;
    }
    p += head;
    left -= head;
    size_t lit_pos = 0;
    if (count > 0) {
      if (left < 1) throw Corrupt{};
      const int modes = p[0];
      if (modes & 3) throw Corrupt{};
      ++p;
      --left;
      size_t t = read_table(p, left, (modes >> 6) & 3, ll, kLLDefault, 36, 6, 35, 9);
      p += t;
      left -= t;
      t = read_table(p, left, (modes >> 4) & 3, of, kOFDefault, 29, 5, 31, 8);
      p += t;
      left -= t;
      t = read_table(p, left, (modes >> 2) & 3, ml, kMLDefault, 53, 6, 52, 9);
      p += t;
      left -= t;
      BackwardBits in(p, left);
      FseState sl{&ll}, so{&of}, sm{&ml};
      sl.init(in);
      so.init(in);
      sm.init(in);
      for (size_t i = 0; i < count; ++i) {
        const int oc = so.symbol(), mc = sm.symbol(), lc = sl.symbol();
        if (oc > 31 || mc > 52 || lc > 35) throw Corrupt{};
        const uint32_t ov = (1u << oc) + static_cast<uint32_t>(in.read(oc));
        const size_t mlen = kMLBase[mc] + in.read(kMLBits[mc]);
        const size_t llen = kLLBase[lc] + in.read(kLLBits[lc]);
        uint32_t offset;
        if (ov > 3) {
          offset = ov - 3;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        } else {
          const int idx = static_cast<int>(ov) - 1 + (llen == 0 ? 1 : 0);
          if (idx == 0) {
            offset = rep[0];
          } else {
            offset = idx < 3 ? rep[idx] : rep[0] - 1;
            if (offset == 0) throw Corrupt{};
            if (idx > 1) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = offset;
          }
        }
        if (i + 1 < count) {
          sl.update(in);
          sm.update(in);
          so.update(in);
        }
        if (lit_pos + llen > literals.size()) throw Corrupt{};
        out.insert(out.end(), literals.begin() + lit_pos, literals.begin() + lit_pos + llen);
        lit_pos += llen;
        if (offset > out.size()) throw Corrupt{};
        size_t from = out.size() - offset;
        for (size_t k = 0; k < mlen; ++k) out.push_back(out[from + k]);
      }
      if (in.pos != 0) throw Corrupt{};
    }
    out.insert(out.end(), literals.begin() + lit_pos, literals.end());
  }
};

// one frame at src; returns its size
size_t frame(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  if (n < 4) throw Corrupt{};
  const uint32_t magic = src[0] | (src[1] << 8) | (src[2] << 16) | (static_cast<uint32_t>(src[3]) << 24);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) throw Corrupt{};
    const size_t size = src[4] | (src[5] << 8) | (src[6] << 16) | (static_cast<size_t>(src[7]) << 24);
    if (8 + size > n) throw Corrupt{};
    return 8 + size;
  }
  if (magic != 0xFD2FB528u || n < 5) throw Corrupt{};
  const int desc = src[4];
  const int fcs_flag = desc >> 6, single = (desc >> 5) & 1, checksum = (desc >> 2) & 1, dict_flag = desc & 3;
  if (desc & 8) throw Corrupt{};
  size_t p = 5 + (single ? 0 : 1);
  static const int kDictBytes[4] = {0, 1, 2, 4};
  uint32_t dict = 0;
  for (int i = 0; i < kDictBytes[dict_flag]; ++i) dict |= static_cast<uint32_t>(src[p + i]) << (8 * i);
  if (dict != 0) throw Unsupported{};
  p += kDictBytes[dict_flag];
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  p += fcs_flag == 0 ? (single ? 1 : 0) : kFcsBytes[fcs_flag];
  Frame f(out);
  while (true) {
    if (p + 3 > n) throw Corrupt{};
    const uint32_t h = src[p] | (src[p + 1] << 8) | (src[p + 2] << 16);
    p += 3;
    const bool last = h & 1;
    const int type = (h >> 1) & 3;
    const size_t size = h >> 3;
    if (type == 0) {
      if (p + size > n) throw Corrupt{};
      out.insert(out.end(), src + p, src + p + size);
      p += size;
    } else if (type == 1) {
      if (p + 1 > n) throw Corrupt{};
      out.insert(out.end(), size, src[p]);
      p += 1;
    } else if (type == 2) {
      if (p + size > n) throw Corrupt{};
      f.block(src + p, size);
      p += size;
    } else {
      throw Corrupt{};
    }
    if (last) break;
  }
  if (checksum) p += 4;
  if (p > n) throw Corrupt{};
  return p;
}

}  // namespace zstd

extern "C" int zstd_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written) {
  std::vector<uint8_t> out;
  try {
    size_t p = 0;
    while (p < n && out.size() < cap) p += zstd::frame(src + p, n - p, out);
  } catch (const zstd::Unsupported&) {
    return 1;
  } catch (const zstd::Corrupt&) {
    return 2;
  }
  const size_t k = out.size() < cap ? out.size() : cap;
  std::memcpy(dst, out.data(), k);
  *written = k;
  return 0;
}

// ---- CCITT bilevel coding, TIFF compressions 2, 3 and 4 ----------------
//
// As libtiff's fax decoder (tif_fax3.c) gives the rows: modified Huffman
// (2: each row byte-aligned, no EOL), T.4 (3: every row after an EOL,
// found as libtiff's SYNC_EOL finds it, then 1-D or, with T4Options bit 0,
// a tag bit choosing 1-D or 2-D) and T.6 (4: 2-D rows against the previous
// row, all white above the first). One byte a pixel, 1 for black. The
// uncompressed-mode extension returns 1.

namespace ccitt {

struct Code {
  int len;
  uint16_t bits;
  int run;
};

// (length, code, run length) of the white and black terminating codes
// (runs 0-63), make-up codes (64-1728) and the shared extended make-up
// codes (1792-2560), ITU-T T.4 tables 2 and 3
const char* kWhite[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100", "00111", "01000",
    "001000", "000011", "110100", "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
    "0000011", "0000100", "0101000", "0101011", "0010011", "0100100", "0011000", "00000010", "00000011",
    "00011010", "00011011", "00010010", "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000", "01011001", "01011010",
    "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
const char* kWhiteMakeup[] = {"11011",     "10010",     "010111",    "0110111",   "00110110",  "00110111",
                              "01100100",  "01100101",  "01101000",  "01100111",  "011001100", "011001101",
                              "011010010", "011010011", "011010100", "011010101", "011010110", "011010111",
                              "011011000", "011011001", "011011010", "011011011", "010011000", "010011001",
                              "010011010", "011000",    "010011011"};
const char* kBlack[] = {
    "0000110111",   "010",          "11",           "10",           "011",          "0011",
    "0010",         "00011",        "000101",       "000100",       "0000100",      "0000101",
    "0000111",      "00000100",     "00000111",     "000011000",    "0000010111",   "0000011000",
    "0000001000",   "00001100111",  "00001101000",  "00001101100",  "00000110111",  "00000101000",
    "00000010111",  "00000011000",  "000011001010", "000011001011", "000011001100", "000011001101",
    "000001101000", "000001101001", "000001101010", "000001101011", "000011010010", "000011010011",
    "000011010100", "000011010101", "000011010110", "000011010111", "000001101100", "000001101101",
    "000011011010", "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100", "000000110111",
    "000000111000", "000000100111", "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
const char* kBlackMakeup[] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",  "000000110011",  "000000110100",
    "000000110101",  "0000001101100", "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100", "0000001110101", "0000001110110",
    "0000001110111", "0000001010010", "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* kExtended[] = {"00000001000",  "00000001100",  "00000001101",  "000000010010", "000000010011",
                           "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
                           "000000011101", "000000011110", "000000011111"};

constexpr int kPeek = 13;

// a lookup of kPeek bits -> (run, length); length 0 where no code fits
struct Table {
  std::vector<int16_t> run;
  std::vector<uint8_t> len;
  explicit Table(bool black) : run(1 << kPeek, 0), len(1 << kPeek, 0) {
    auto add = [&](const char* s, int r) {
      const int n = static_cast<int>(std::strlen(s));
      int code = 0;
      for (int i = 0; i < n; ++i) code = code * 2 + (s[i] - '0');
      for (int u = code << (kPeek - n); u < (code + 1) << (kPeek - n); ++u) {
        run[u] = static_cast<int16_t>(r);
        len[u] = static_cast<uint8_t>(n);
      }
    };
    const char** term = black ? kBlack : kWhite;
    const char** makeup = black ? kBlackMakeup : kWhiteMakeup;
    for (int i = 0; i < 64; ++i) add(term[i], i);
    for (int i = 0; i < 27; ++i) add(makeup[i], 64 * (i + 1));
    for (int i = 0; i < 13; ++i) add(kExtended[i], 1792 + 64 * i);
  }
};

struct Bad {
  int code;
};

struct Bits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed, MSB first
  int peek(int k) const {
    int v = 0;
    for (int i = 0; i < k; ++i) {
      const size_t b = pos + i;
      v = v * 2 + (b / 8 < n ? (p[b / 8] >> (7 - b % 8)) & 1 : 0);
    }
    return v;
  }
  void skip(int k) { pos += k; }
  bool done() const { return pos >= 8 * n; }
  void align() { pos = (pos + 7) & ~static_cast<size_t>(7); }
};

// libtiff's SYNC_EOL: eleven zeros (searched bit by bit), any more zeros, the one
void sync_eol(Bits& in) {
  while (in.peek(11) != 0) {
    if (in.done()) throw Bad{2};
    in.skip(1);
  }
  in.skip(11);
  while (in.peek(1) == 0) {
    if (in.done()) throw Bad{2};
    in.skip(1);
  }
  in.skip(1);
}

// a run: make-up codes, then a terminating one
int run(Bits& in, const Table& t) {
  int total = 0;
  while (true) {
    const int v = in.peek(kPeek);
    if (!t.len[v] || in.done()) throw Bad{2};
    in.skip(t.len[v]);
    total += t.run[v];
    if (t.run[v] < 64) return total;
  }
}

struct Row {
  int width;
  std::vector<int> changes;  // positions where the colour changes, white first
  void fill(uint8_t* row, int from, int to, int color) {
    if (to > width) to = width;
    if (from < 0) from = 0;
    for (int x = from; x < to; ++x) row[x] = static_cast<uint8_t>(color);
  }
};

void expand1d(Bits& in, const Table& white, const Table& black, Row& r, uint8_t* row) {
  r.changes.clear();
  int a0 = 0, color = 0;
  while (a0 < r.width) {
    const int n = run(in, color ? black : white);
    r.fill(row, a0, a0 + n, color);
    a0 += n;
    if (a0 < r.width) r.changes.push_back(a0);
    color ^= 1;
  }
}

void expand2d(Bits& in, const Table& white, const Table& black, const std::vector<int>& ref, Row& r, uint8_t* row) {
  std::vector<int> cur;
  const int width = r.width;
  int a0 = -1, color = 0;
  size_t k = 0;  // the reference changes before k lie at or left of a0
  auto b1_at = [&](int a, int c, size_t& i) {
    // the first change of the reference line right of a, to the colour opposite c
    while (i < ref.size() && (ref[i] <= a || static_cast<int>(i % 2) != c)) ++i;
    return i < ref.size() ? ref[i] : width;
  };
  while (a0 < width) {
    size_t i = k > 0 ? k - 1 : 0;
    const int b1 = b1_at(a0, color, i);
    const int b2 = i + 1 < ref.size() ? ref[i + 1] : width;
    k = i;
    const int v = in.peek(7);
    if (in.done()) throw Bad{2};
    if (v >> 6 == 1) {  // V0: 1
      in.skip(1);
      r.fill(row, a0, b1, color);
      a0 = b1;
    } else if (v >> 4 == 3 || v >> 4 == 2) {  // VR1 011, VL1 010
      in.skip(3);
      const int a1 = b1 + (v >> 4 == 3 ? 1 : -1);
      r.fill(row, a0, a1, color);
      a0 = a1;
    } else if (v >> 4 == 1) {  // H: 001
      in.skip(3);
      const int start = a0 < 0 ? 0 : a0;
      const int n1 = run(in, color ? black : white);
      const int n2 = run(in, color ? white : black);
      r.fill(row, start, start + n1, color);
      r.fill(row, start + n1, start + n1 + n2, color ^ 1);
      a0 = start + n1 + n2;
      if (start + n1 < width) cur.push_back(start + n1);
      if (a0 < width) cur.push_back(a0);
      continue;
    } else if (v >> 3 == 1) {  // P: 0001
      in.skip(4);
      r.fill(row, a0, b2, color);
      a0 = b2;
      continue;
    } else if (v >> 1 == 3 || v >> 1 == 2) {  // VR2 000011, VL2 000010
      in.skip(6);
      const int a1 = b1 + (v >> 1 == 3 ? 2 : -2);
      r.fill(row, a0, a1, color);
      a0 = a1;
    } else if (v == 3 || v == 2) {  // VR3 0000011, VL3 0000010
      in.skip(7);
      const int a1 = b1 + (v == 3 ? 3 : -3);
      r.fill(row, a0, a1, color);
      a0 = a1;
    } else if (v == 1) {  // 0000001xxx: an extension (uncompressed mode)
      throw Bad{1};
    } else {
      throw Bad{2};
    }
    // a vertical mode: a1 is a change
    if (a0 < 0) a0 = 0;
    if (a0 < width) cur.push_back(a0);
    color ^= 1;
  }
  r.changes.swap(cur);
}

}  // namespace ccitt

extern "C" int ccitt_decode(const uint8_t* src, size_t n, int width, int rows, int scheme, int t4options,
                            uint8_t* dst, size_t cap, size_t* written_rows) {
  static const ccitt::Table white(false), black(true);
  *written_rows = 0;
  if (width <= 0 || rows < 0 || static_cast<size_t>(width) * rows > cap) return 2;
  if (scheme == 3 && (t4options & 2)) return 1;  // uncompressed mode allowed
  ccitt::Bits in{src, n};
  ccitt::Row r{width, {}};
  std::vector<int> ref;  // the row above: all white
  try {
    for (int y = 0; y < rows; ++y) {
      uint8_t* row = dst + static_cast<size_t>(y) * width;
      if (scheme == 2) {
        ccitt::expand1d(in, white, black, r, row);
        in.align();
      } else if (scheme == 3) {
        ccitt::sync_eol(in);
        bool one_d = true;
        if (t4options & 1) {
          one_d = in.peek(1) == 1;
          in.skip(1);
        }
        if (one_d)
          ccitt::expand1d(in, white, black, r, row);
        else
          ccitt::expand2d(in, white, black, ref, r, row);
      } else if (scheme == 4) {
        ccitt::expand2d(in, white, black, ref, r, row);
      } else {
        return 1;
      }
      ref = r.changes;
      *written_rows = static_cast<size_t>(y) + 1;
    }
  } catch (const ccitt::Bad& e) {
    return e.code;
  }
  return 0;
}
