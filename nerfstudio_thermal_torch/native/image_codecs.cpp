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
// C interface (loaded with ctypes by data/image_formats.py): each returns 0
// on success, 1 for an unsupported variant, 2 for malformed data.
//   int image_codecs_abi_version();
//   int tiff_lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written);
//   int packbits_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written);
//   int bmp_rle_decode(const uint8_t* src, size_t n, size_t file_pos, int width, int height, int rle4,
//                      uint8_t* dst, size_t cap, size_t* length);
//   int gif_lzw_decode(const uint8_t* src, size_t n, int bits, int interlace, int x0, int y0, int w,
//                      int h, int canvas_w, uint8_t* canvas);

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

extern "C" int image_codecs_abi_version() { return 1; }

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
