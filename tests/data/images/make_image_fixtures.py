"""Write the TIFF, BMP, GIF, JPEG and WebP fixtures of this directory and
their manifest.

Run from the repository root on a machine with Pillow and zstandard:

    python tests/data/images/make_image_fixtures.py

Pillow writes what it can (TIFF through libtiff with LZW, Deflate and
PackBits; BMP at 1, 8 and 24 bits; GIF, interlaced or not; progressive
and CMYK JPEG; WebP). The rest is built here byte by byte: TIFFs in both
byte orders, tiled, planar, with predictors 2 and 3 and fill order 2
(`write_tiff`, with its own TIFF LZW and PackBits encoders); BMPs with
core, V4 and V5 headers, RLE8 / RLE4, 16-bit 5-5-5 / 5-6-5, 32-bit and
top-down rows (`write_bmp`); GIFs with a local palette, a frame that grows
the canvas and a transparent index (the LZW data is Pillow's, re-wrapped);
a YCCK JPEG (a CMYK file whose Adobe marker says transform 2);
progressive JPEGs cut after their first scans, which libjpeg block-smooths;
lossless (SOF3) JPEGs, each predictor, a point transform, restart
intervals, one scan per component (`lossless_jpeg`); arithmetic-coded
JPEGs, sequential and progressive, with restarts, DAC conditioning and a
cut progression (`arith_jpeg`: the quantized DCT of smooth planes through
libjpeg's QM coder, `ArithEncoder`); and the refusal
witnesses: a 12-bit JPEG, a hierarchical (SOF5) one and a lossless YCbCr
one (libjpeg-turbo converts no colours of a lossless image), which Pillow
refuses too. `tiffs_codecs` adds TIFFs with JPEG (Pillow's, and YCbCr
4:2:0 strips and tiles built from Pillow's JPEG encoder with a
JPEGTables tag), old-style JPEG, LZMA, Zstandard, CCITT (Pillow's, both
fill orders), CMYK, CIELAB and YCbCr data units, I;12, PA, RGBa;16,
planar 16-bit, all orientations and BigTIFF; `webps` lossless, lossy,
alpha (hand-built ALPH chunks for each unfilter) and animated WebP.

manifest.json records, per file, Pillow's mode and the SHA-256, shape and
dtype of `np.asarray(Image.open(path))`; "pillow_raises" marks a file
Pillow refuses (the port refuses each of them too).
Existing files come out byte-identical on a machine with the same Pillow.
"""

import hashlib
import io
import json
import lzma
import struct
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent


def smooth(h: int, w: int, c: int, seed: int = 0, scale: float = 90.0, noise: float = 6.0) -> np.ndarray:
    """A smooth float image around 128 with a little noise, [h, w, c]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) for k in range(c)], -1) * scale + 128
    return base + rng.normal(0, noise, (h, w, c))


def u8(h, w, c, seed=0):
    return np.clip(smooth(h, w, c, seed), 0, 255).astype(np.uint8)


# ---- TIFF ---------------------------------------------------------------


def lzw_encode_tiff(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes, a clear code first,
    the width grows when the next free code passes the width's largest."""
    out, acc, nacc = bytearray(), 0, 0
    width, table, nxt = 9, {}, 258

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8

    def grow():
        nonlocal nxt, width, table
        nxt += 1
        if nxt == 4094:
            put(256)
            table, nxt, width = {}, 258, 9
        elif nxt > (1 << width) - 1:
            width += 1

    put(256)
    prefix = None
    for b in data:
        if prefix is None:
            prefix = b
            continue
        key = (prefix, b)
        if key in table:
            prefix = table[key]
            continue
        put(prefix)
        table[key] = nxt
        grow()
        prefix = b
    if prefix is not None:
        put(prefix)
        grow()
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def write_tiff(path: Path, img: np.ndarray, *, order: str = "<", photometric: int, bits: int, sample_format: int = 1,
               extra=(), compression: int = 1, predictor: int = 1, planar: int = 1, tile=None, rows_per_strip=None,
               fill: int = 1, colormap=None, tags=None, coder=None, big: bool = False) -> None:
    """A one-page TIFF of sample values [H, W, S]. `coder` encodes a strip
    or tile of samples [rows, cw, S] itself (JPEG, or a codec libtiff does
    not have); `tags` adds entries {tag: (type, values)}; `big` writes a
    BigTIFF."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, s = img.shape
    planes = s if planar == 2 else 1
    sc = s // planes
    dt = np.dtype({(8, 1): "u1", (16, 1): "u2", (32, 1): "u4", (16, 2): "i2", (32, 2): "i4", (32, 3): "f4"}.get(
        (bits, sample_format), "u1")).newbyteorder(order)

    def pack(chunk: np.ndarray) -> bytes:  # [rows, cw, sc] values -> stored bytes
        rows, cw = chunk.shape[:2]
        if coder is not None:
            return coder(chunk)
        if bits == 12:
            flat = chunk.reshape(rows, -1).astype(np.uint16)
            flat = np.concatenate([flat, np.zeros((rows, flat.shape[1] % 2), np.uint16)], 1).reshape(rows, -1, 2)
            a, b = flat[..., 0], flat[..., 1]
            raw = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1).astype(np.uint8).tobytes()
        elif bits < 8:
            flat = chunk.reshape(rows, -1).astype(np.uint8)
            pad = (-flat.shape[1] * bits) % 8 // bits
            flat = np.concatenate([flat, np.zeros((rows, pad), np.uint8)], 1).reshape(rows, -1, 8 // bits)
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            raw = (flat << shifts).sum(-1).astype(np.uint8).tobytes()
        elif predictor == 3:
            be = chunk.reshape(rows, -1).astype(">f4").view(np.uint8).reshape(rows, -1, 4)
            planes_ = be.transpose(0, 2, 1).reshape(rows, -1).astype(np.int32)
            diff = planes_.copy()
            diff[:, sc:] = planes_[:, sc:] - planes_[:, :-sc]
            raw = (diff & 0xFF).astype(np.uint8).tobytes()
        else:
            vals = chunk.astype(dt)
            if predictor == 2:
                v = chunk.astype(np.int64)
                d = v.copy()
                d[:, 1:] = v[:, 1:] - v[:, :-1]
                vals = (d % (1 << bits)).astype(dt)
            raw = vals.tobytes()
        if compression == 5:
            raw = lzw_encode_tiff(raw)
        elif compression in (8, 32946):
            raw = zlib.compress(raw, 9)
        elif compression == 32773:
            raw = packbits_encode(raw)
        elif compression == 34925:
            raw = lzma.compress(raw)
        elif compression == 50000:
            import zstandard  # only in this script, to write fixtures

            raw = zstandard.ZstdCompressor(level=19).compress(raw)
        return raw.translate(REVERSED) if fill == 2 else raw

    chunks = []
    for p in range(planes):
        src = img[..., p * sc:(p + 1) * sc]
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, sc), img.dtype)
                    part = src[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(pack(t))
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                chunks.append(pack(src[y:y + rps]))
    head = struct.pack(order + "2sHHHQ", b"II" if order == "<" else b"MM", 43, 8, 0, 0) if big else struct.pack(
        order + "2sHI", b"II" if order == "<" else b"MM", 42, 0)
    data = bytearray(head)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\0"
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * s), 259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [s]), 284: (3, [planar])}
    if fill != 1:
        entries[266] = (3, [fill])
    if tile:
        entries.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (4, offsets), 325: (4, [len(c) for c in chunks])})
    else:
        entries.update({273: (4, offsets), 278: (4, [rows_per_strip or h]), 279: (4, [len(c) for c in chunks])})
    if predictor != 1:
        entries[317] = (3, [predictor])
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if extra:
        entries[338] = (3, list(extra))
    if sample_format != 1:
        entries[339] = (3, [sample_format] * s)
    for tag, value in (tags or {}).items():
        entries[tag] = value(chunks) if callable(value) else value
    ifd_at = len(data)
    word, count, entry = ("Q", "Q", 20) if big else ("I", "H", 12)
    struct.pack_into(order + word, data, 8 if big else 4, ifd_at)
    overflow_at = ifd_at + struct.calcsize(count) + entry * len(entries) + struct.calcsize(word)
    ifd, overflow = bytearray(struct.pack(order + count, len(entries))), bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        if big and tag in (273, 279, 324, 325):
            typ = 16
        fmt = {1: "B", 7: "B", 3: "H", 4: "I", 5: "II", 16: "Q"}[typ]
        raw = struct.pack(order + fmt[0] * len(vals), *vals)
        count = len(vals) // len(fmt)
        if len(raw) <= struct.calcsize(word):
            ifd += struct.pack(order + "HH" + word, tag, typ, count) + raw.ljust(struct.calcsize(word), b"\0")
        else:
            ifd += struct.pack(order + "HH" + word + word, tag, typ, count, overflow_at + len(overflow))
            overflow += raw + (b"\0" if len(raw) % 2 else b"")
    data += ifd + struct.pack(order + word, 0) + overflow
    path.write_bytes(bytes(data))


def tiffs() -> dict:
    grey16 = np.clip(smooth(23, 37, 1, 1, scale=20000, noise=300) * 100 + 20000, 0, 65535).astype(np.uint16)
    rgb = u8(21, 30, 3, 2)
    rgba = np.concatenate([rgb, u8(21, 30, 1, 3)], -1)
    depth = (smooth(19, 27, 1, 4, scale=1.5, noise=0.01) / 40 + 0.2).astype(np.float32)
    ints = (smooth(13, 17, 1, 5, scale=3e4, noise=10) * 1000 - 5e7).astype(np.int32)
    grey8 = u8(17, 22, 1, 6)
    bits1 = (u8(18, 29, 1, 7) > 128).astype(np.uint8)
    pal = (u8(15, 19, 1, 8) // 16).astype(np.uint8)
    cmap = [(i * 4099) % 65536 for i in range(3 * 16)]
    pal8 = u8(15, 19, 1, 9)
    cmap8 = [(i * 9973) % 65536 for i in range(3 * 256)]
    out = {
        # Pillow's writer (libtiff for the compressed ones)
        "tiff_pillow_grey16.tif": lambda p: Image.fromarray(grey16[..., 0]).save(p),
        "tiff_pillow_grey16_deflate.tif": lambda p: Image.fromarray(grey16[..., 0]).save(p, compression="tiff_deflate"),
        "tiff_pillow_grey16_lzw.tif": lambda p: Image.fromarray(grey16[..., 0]).save(p, compression="tiff_lzw"),
        "tiff_pillow_rgb_lzw.tif": lambda p: Image.fromarray(rgb).save(p, compression="tiff_lzw"),
        "tiff_pillow_rgba_packbits.tif": lambda p: Image.fromarray(rgba).save(p, compression="packbits"),
        "tiff_pillow_float_adobe_deflate.tif": lambda p: Image.fromarray(depth[..., 0]).save(
            p, compression="tiff_adobe_deflate"),
        "tiff_pillow_float.tif": lambda p: Image.fromarray(depth[..., 0]).save(p),
        "tiff_pillow_int32.tif": lambda p: Image.fromarray(ints[..., 0]).save(p, compression="tiff_deflate"),
        "tiff_pillow_l_lzw.tif": lambda p: Image.fromarray(grey8[..., 0]).save(p, compression="tiff_lzw"),
        "tiff_pillow_1bit.tif": lambda p: Image.fromarray(bits1[..., 0].astype(bool)).save(p),
        "tiff_pillow_la.tif": lambda p: Image.fromarray(rgba[..., 2:], "LA").save(p),
        "tiff_pillow_p.tif": lambda p: pillow_p(pal8[..., 0], bytes(v % 256 for v in cmap8)).save(
            p, compression="tiff_deflate"),
        # written here
        "tiff_mm_grey16.tif": lambda p: write_tiff(p, grey16, order=">", photometric=1, bits=16),
        "tiff_mm_grey16_deflate_pred2.tif": lambda p: write_tiff(p, grey16, order=">", photometric=1, bits=16,
                                                                 compression=8, predictor=2, rows_per_strip=5),
        "tiff_ii_grey16_lzw_pred2_tiled.tif": lambda p: write_tiff(p, grey16, photometric=1, bits=16, compression=5,
                                                                   predictor=2, tile=(16, 16)),
        "tiff_ii_grey16_whiteiszero.tif": lambda p: write_tiff(p, grey16, photometric=0, bits=16, rows_per_strip=7),
        "tiff_ii_grey16_packbits.tif": lambda p: write_tiff(p, grey16, photometric=1, bits=16, compression=32773,
                                                            rows_per_strip=4),
        "tiff_ii_float_pred3.tif": lambda p: write_tiff(p, depth, photometric=1, bits=32, sample_format=3,
                                                        compression=8, predictor=3, rows_per_strip=6),
        "tiff_mm_float_pred3_lzw.tif": lambda p: write_tiff(p, depth, order=">", photometric=1, bits=32,
                                                            sample_format=3, compression=5, predictor=3),
        "tiff_mm_float.tif": lambda p: write_tiff(p, depth, order=">", photometric=1, bits=32, sample_format=3),
        "tiff_mm_float_tiled_deflate.tif": lambda p: write_tiff(p, depth, order=">", photometric=1, bits=32,
                                                                sample_format=3, compression=32946, tile=(16, 16)),
        "tiff_mm_int32_deflate.tif": lambda p: write_tiff(p, ints, order=">", photometric=1, bits=32, sample_format=2,
                                                          compression=8),
        "tiff_mm_int16_signed.tif": lambda p: write_tiff(p, (ints // 70000).astype(np.int16), order=">",
                                                         photometric=1, bits=16, sample_format=2),
        "tiff_mm_int16_signed_lzw.tif": lambda p: write_tiff(p, (ints // 70000).astype(np.int16), order=">",
                                                             photometric=1, bits=16, sample_format=2, compression=5),
        "tiff_ii_int16_signed_pred2.tif": lambda p: write_tiff(p, (ints // 70000).astype(np.int16), photometric=1,
                                                               bits=16, sample_format=2, compression=8, predictor=2),
        "tiff_mm_rgb_planar_deflate.tif": lambda p: write_tiff(p, rgb, order=">", photometric=2, bits=8, planar=2,
                                                               compression=8, rows_per_strip=8),
        "tiff_ii_rgb_planar.tif": lambda p: write_tiff(p, rgb, photometric=2, bits=8, planar=2, rows_per_strip=8),
        "tiff_ii_rgb_tiled_planar_lzw.tif": lambda p: write_tiff(p, rgb, photometric=2, bits=8, planar=2,
                                                                 compression=5, tile=(16, 16)),
        # libtiff ignores the predictor of a PackBits file (and Pillow of an uncompressed one)
        "tiff_mm_rgb_pred2_packbits.tif": lambda p: write_tiff(p, rgb, order=">", photometric=2, bits=8,
                                                               compression=32773, predictor=2, rows_per_strip=3),
        "tiff_ii_rgb_pred2_uncompressed.tif": lambda p: write_tiff(p, rgb, photometric=2, bits=8, predictor=2),
        "tiff_ii_rgb16.tif": lambda p: write_tiff(p, rgb.astype(np.uint16) * 257 + 3, photometric=2, bits=16),
        "tiff_mm_rgb16_deflate.tif": lambda p: write_tiff(p, rgb.astype(np.uint16) * 257 + 3, order=">",
                                                          photometric=2, bits=16, compression=8),
        "tiff_ii_rgba_assoc.tif": lambda p: write_tiff(p, np.minimum(rgba, rgba[..., 3:]), photometric=2, bits=8,
                                                       extra=(1,)),
        "tiff_ii_rgba_unassoc_lzw.tif": lambda p: write_tiff(p, rgba, photometric=2, bits=8, extra=(2,),
                                                             compression=5),
        "tiff_ii_rgbx.tif": lambda p: write_tiff(p, rgba, photometric=2, bits=8, extra=(0,)),
        "tiff_ii_la_deflate.tif": lambda p: write_tiff(p, rgba[..., 1:3], photometric=1, bits=8, extra=(2,),
                                                       compression=8),
        "tiff_mm_l_whiteiszero.tif": lambda p: write_tiff(p, grey8, order=">", photometric=0, bits=8),
        "tiff_ii_l_fill2_lzw.tif": lambda p: write_tiff(p, grey8, photometric=1, bits=8, compression=5, fill=2),
        "tiff_ii_l4.tif": lambda p: write_tiff(p, grey8 // 16, photometric=1, bits=4),
        "tiff_mm_l2_whiteiszero_deflate.tif": lambda p: write_tiff(p, grey8 // 64, order=">", photometric=0, bits=2,
                                                                   compression=8),
        "tiff_ii_1bit_whiteiszero_packbits.tif": lambda p: write_tiff(p, bits1, photometric=0, bits=1,
                                                                      compression=32773, rows_per_strip=5),
        "tiff_mm_1bit_fill2.tif": lambda p: write_tiff(p, bits1, order=">", photometric=1, bits=1, fill=2),
        "tiff_ii_palette4_lzw.tif": lambda p: write_tiff(p, pal, photometric=3, bits=4, compression=5, colormap=cmap),
        "tiff_mm_palette8_tiled.tif": lambda p: write_tiff(p, pal8, order=">", photometric=3, bits=8, tile=(16, 16),
                                                           colormap=cmap8),
    }
    return out


# ---- TIFF: compressions, photometrics and layouts that libtiff reads -----


def split_jpeg(data: bytes):
    """(a JPEGTables stream: SOI, the DQT and DHT segments, EOI; the
    abbreviated stream: SOI, the frame and scans, EOI) of a JPEG."""
    tables, frame, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while data[pos + 1] != 0xDA:
        size = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + size]
        if data[pos + 1] in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= data[pos + 1] <= 0xEF:
            frame += seg
        pos += 2 + size
    return bytes(tables + b"\xff\xd9"), bytes(frame + data[pos:])


def jpeg_coder(subsampling: int, quality: int = 90):
    """A write_tiff coder of JPEG strips or tiles (Pillow's encoder), their
    tables kept for the JPEGTables tag (`coder.tables`)."""
    def coder(chunk: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(chunk[..., 0] if chunk.shape[-1] == 1 else chunk).save(
            buf, "JPEG", quality=quality, subsampling=subsampling)
        coder.tables, stream = split_jpeg(buf.getvalue())
        return stream

    return coder


def jpeg_tiff(path: Path, img: np.ndarray, photometric: int, subsampling: int, **kw) -> None:
    coder = jpeg_coder(subsampling)
    tags = {347: lambda chunks: (7, list(coder.tables))}
    if photometric == 6:
        tags[530] = (3, [2, 2] if subsampling == 2 else [1, 1])
    write_tiff(path, img, photometric=photometric, bits=8, compression=7, coder=coder, tags=tags, **kw)


def patch_tag(path: Path, tag: int, value: int) -> None:
    """Set a short tag of a little-endian classic TIFF's first IFD in place."""
    data = bytearray(path.read_bytes())
    off = struct.unpack("<I", data[4:8])[0]
    for i in range(struct.unpack("<H", data[off:off + 2])[0]):
        p = off + 2 + 12 * i
        if struct.unpack("<H", data[p:p + 2])[0] == tag:
            struct.pack_into("<HHIH", data, p, tag, 3, 1, value)
    path.write_bytes(bytes(data))


def old_jpeg_tiff(path: Path, img: np.ndarray) -> None:
    """Compression 6: one strip that is a whole JPEG, JPEGInterchangeFormat
    pointing at it."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    jpg = buf.getvalue()
    write_tiff(path, img, photometric=6, bits=8, compression=6, coder=lambda chunk: jpg,
               tags={513: lambda chunks: (4, [8]), 514: (4, [len(jpg)])})


def ycbcr_units_tiff(path: Path, ycc: np.ndarray, sub, compression: int, **kw) -> None:
    """Photometric YCbCr, not JPEG-compressed: each strip as data units of
    sub[0] x sub[1] luma samples then Cb and Cr (the chroma the mean of the
    unit, the padding past the image zero)."""
    h, v = sub

    def coder(chunk):
        rows, cw = chunk.shape[:2]
        uy, ux = -(-rows // v), -(-cw // h)
        pad = np.zeros((uy * v, ux * h, 3), np.float64)
        pad[:rows, :cw] = chunk
        blocks = pad.reshape(uy, v, ux, h, 3).transpose(0, 2, 1, 3, 4)
        luma = blocks[..., 0].reshape(uy, ux, v * h)
        chroma = blocks[..., 1:].mean((2, 3))
        raw = np.concatenate([luma, chroma], -1).round().astype(np.uint8).tobytes()
        return lzw_encode_tiff(raw) if compression == 5 else zlib.compress(raw, 9)

    write_tiff(path, ycc, photometric=6, bits=8, compression=compression, coder=coder,
               tags={530: (3, list(sub)), **kw.pop("tags", {})}, **kw)


def foreign_tiff(path: Path, img: np.ndarray, compression: int, fmt: str, **kw) -> None:
    """A strip coded with a codec Pillow 12.1's libtiff (4.7) lacks: WebP, JPEG 2000."""
    def coder(chunk):
        buf = io.BytesIO()
        Image.fromarray(chunk).save(buf, fmt, **kw)
        return buf.getvalue()

    write_tiff(path, img, photometric=2, bits=8, compression=compression, coder=coder)


def ccitt(path: Path, bits: np.ndarray, compression: str, fill: int = 1, t4: int = None) -> None:
    info = {} if fill == 1 else {266: 2}
    if t4 is not None:
        info[292] = t4
    Image.fromarray(bits.astype(bool)).save(path, compression=compression, tiffinfo=info)


def tiffs_codecs() -> dict:
    grey8 = u8(17, 22, 1, 50)
    rgb = u8(9, 13, 3, 51)
    grey16 = np.clip(smooth(19, 27, 1, 52, scale=20000, noise=300) * 100 + 20000, 0, 65535).astype(np.uint16)
    thermal = np.clip(smooth(24, 32, 1, 53, scale=3000, noise=40) + 29000, 0, 65535).astype(np.uint16)
    signed = (smooth(13, 17, 1, 54, scale=9000, noise=50) - 128).astype(np.int16)
    depth = (smooth(15, 21, 1, 55, scale=1.5, noise=0.01) / 40 + 0.2).astype(np.float32)
    cmyk = u8(14, 18, 4, 56)
    lab = u8(13, 19, 3, 57)
    y, x = np.mgrid[0:37, 0:61]
    mask = (np.sin(x / 5.0) * np.cos(y / 7.0) + np.random.default_rng(58).normal(0, 0.3, x.shape)) > 0.2
    tall = u8(12, 20, 3, 59)
    out = {
        # orientations: 2-4 flip, 5-8 transpose (a 32 x 40 file comes back 40 x 32)
        **{f"tiff_orient{o}_l.tif": lambda p, o=o: write_tiff(p, grey8, photometric=1, bits=8,
                                                              tags={274: (3, [o])}) for o in (2, 3, 4)},
        **{f"tiff_orient{o}_rgb_lzw.tif": lambda p, o=o: write_tiff(p, rgb, photometric=2, bits=8, compression=5,
                                                                    rows_per_strip=8, tags={274: (3, [o])})
           for o in (2, 3, 4)},
        "tiff_orient5_rgb.tif": lambda p: write_tiff(p, tall, photometric=2, bits=8, tags={274: (3, [5])}),
        "tiff_orient6_grey16_zstd.tif": lambda p: write_tiff(p, grey16, photometric=1, bits=16, compression=50000,
                                                             predictor=2, tags={274: (3, [6])}),
        "tiff_orient7_l_deflate.tif": lambda p: write_tiff(p, grey8, photometric=1, bits=8, compression=8,
                                                           tags={274: (3, [7])}),
        "tiff_orient8_rgb_tiled.tif": lambda p: write_tiff(p, tall, photometric=2, bits=8, tile=(16, 16),
                                                           tags={274: (3, [8])}),
        # JPEG (259 = 7): Pillow's (RGB, grey), and by hand: YCbCr 4:2:0 strips with a short last one, tiles
        "tiff_pillow_rgb_jpeg.tif": lambda p: Image.fromarray(rgb).save(p, compression="jpeg", quality=85),
        "tiff_pillow_l_jpeg.tif": lambda p: Image.fromarray(grey8[..., 0]).save(p, compression="jpeg"),
        "tiff_ycbcr420_jpeg_strips.tif": lambda p: jpeg_tiff(p, u8(37, 45, 3, 60), 6, 2, rows_per_strip=16),
        "tiff_rgb_jpeg_tiled.tif": lambda p: jpeg_tiff(p, u8(37, 45, 3, 61), 2, 0, tile=(16, 16)),
        "tiff_old_jpeg.tif": lambda p: old_jpeg_tiff(p, u8(16, 24, 3, 62)),
        "tiff_old_jpeg_odd.tif": lambda p: old_jpeg_tiff(p, u8(15, 21, 3, 68)),
        # LZMA and Zstandard, with predictors; big-endian 16-bit signed and float samples
        "tiff_pillow_grey16_lzma_pred2.tif": lambda p: Image.fromarray(grey16[..., 0]).save(
            p, compression="lzma", tiffinfo={317: 2}),
        "tiff_pillow_thermal16_zstd_pred2.tif": lambda p: Image.fromarray(thermal[..., 0]).save(
            p, compression="zstd", tiffinfo={317: 2}),
        "tiff_pillow_rgb_zstd.tif": lambda p: Image.fromarray(rgb).save(p, compression="zstd"),
        "tiff_pillow_rgb_lzma.tif": lambda p: Image.fromarray(rgb).save(p, compression="lzma"),
        "tiff_mm_grey16_zstd.tif": lambda p: write_tiff(p, grey16, order=">", photometric=1, bits=16,
                                                        compression=50000, rows_per_strip=7),
        "tiff_mm_int16_signed_lzma.tif": lambda p: write_tiff(p, signed, order=">", photometric=1, bits=16,
                                                              sample_format=2, compression=34925),
        "tiff_mm_int16_signed_zstd_pred2.tif": lambda p: write_tiff(p, signed, order=">", photometric=1, bits=16,
                                                                    sample_format=2, compression=50000, predictor=2),
        "tiff_mm_float_zstd_pred3.tif": lambda p: write_tiff(p, depth, order=">", photometric=1, bits=32,
                                                             sample_format=3, compression=50000, predictor=3),
        "tiff_ii_float_lzma.tif": lambda p: write_tiff(p, depth, photometric=1, bits=32, sample_format=3,
                                                       compression=34925, tile=(16, 16)),
        # CCITT (bilevel masks): modified Huffman, T.4 1-D and 2-D, T.6, both fill orders
        **{f"tiff_ccitt_{name}_fill{fill}.tif": lambda p, c=c, fill=fill, t4=t4: ccitt(p, mask, c, fill, t4)
           for name, c, t4 in (("rle", "tiff_ccitt", None), ("g3_1d", "group3", None), ("g3_2d", "group3", 1),
                               ("g4", "group4", None)) for fill in (1, 2)},
        "tiff_ccitt_g3_2d_eolalign.tif": lambda p: ccitt(p, mask, "group3", 1, 5),
        "tiff_ccitt_g4_whiteiszero.tif": lambda p: (ccitt(p, mask, "group4"), patch_tag(p, 262, 0)),
        # CMYK and CIELAB, each codec; YCbCr that is not JPEG-compressed
        **{f"tiff_pillow_cmyk_{c or 'raw'}.tif": lambda p, c=c: Image.fromarray(cmyk, "CMYK").save(p, compression=c)
           for c in (None, "tiff_lzw", "packbits", "tiff_deflate", "lzma", "zstd", "jpeg")},
        "tiff_mm_cmyk16.tif": lambda p: write_tiff(p, cmyk.astype(np.uint16) * 257 + 5, order=">", photometric=5,
                                                   bits=16),
        **{f"tiff_pillow_lab_{c or 'raw'}.tif": lambda p, c=c: Image.fromarray(lab, "LAB").save(p, compression=c)
           for c in (None, "tiff_lzw", "tiff_deflate", "lzma", "zstd")},
        "tiff_pillow_ycbcr_raw.tif": lambda p: Image.fromarray(rgb).convert("YCbCr").save(p),
        "tiff_pillow_ycbcr_lzw.tif": lambda p: Image.fromarray(rgb).convert("YCbCr").save(p, compression="tiff_lzw"),
        "tiff_ycbcr22_units_lzw.tif": lambda p: ycbcr_units_tiff(p, u8(15, 21, 3, 69), (2, 2), 5, rows_per_strip=6),
        "tiff_ycbcr21_units_deflate_refbw.tif": lambda p: ycbcr_units_tiff(
            p, u8(11, 17, 3, 70), (2, 1), 8, tags={532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}),
        # raw modes: 12-bit grey (I;16), palette + alpha, premultiplied 16-bit RGBA
        "tiff_ii_grey12.tif": lambda p: write_tiff(p, (grey16 >> 4)[:, :25], photometric=1, bits=12,
                                                   rows_per_strip=6),
        "tiff_ii_grey12_lzw.tif": lambda p: write_tiff(p, (grey16 >> 4), photometric=1, bits=12, compression=5),
        "tiff_ii_pa.tif": lambda p: write_tiff(p, np.concatenate([(grey8 // 16), u8(17, 22, 1, 63)], -1)[:9, :13],
                                               photometric=3, bits=8, extra=(2,),
                                               colormap=[(i * 4099) % 65536 for i in range(3 * 256)]),
        "tiff_ii_rgba16_assoc.tif": lambda p: write_tiff(
            p, (lambda a: np.concatenate([np.minimum(a[..., :3], a[..., 3:]), a[..., 3:]], -1))(
                u8(13, 17, 4, 64).astype(np.uint16) * 257), photometric=2, bits=16, extra=(1,)),
        "tiff_mm_rgba16_assoc_zstd.tif": lambda p: write_tiff(
            p, (lambda a: np.concatenate([np.minimum(a[..., :3], a[..., 3:]), a[..., 3:]], -1))(
                u8(13, 17, 4, 65).astype(np.uint16) * 257 + 2), order=">", photometric=2, bits=16, extra=(1,),
            compression=50000),
        # uncompressed planar files that Pillow unpacks plane by plane with 8-bit / native-float letters
        "tiff_ii_rgb16_planar.tif": lambda p: write_tiff(p, rgb.astype(np.uint16) * 257 + 9, photometric=2,
                                                         bits=16, planar=2, rows_per_strip=8),
        "tiff_mm_rgb16_planar_tiled.tif": lambda p: write_tiff(p, rgb.astype(np.uint16) * 300, order=">",
                                                               photometric=2, bits=16, planar=2, tile=(16, 16)),
        "tiff_mm_float_planar.tif": lambda p: write_tiff(p, depth, order=">", photometric=1, bits=32,
                                                         sample_format=3, planar=2),
        # BigTIFF (8-byte offsets)
        "tiff_pillow_bigtiff_rgb.tif": lambda p: Image.fromarray(rgb).save(p, big_tiff=True),
        "tiff_bigtiff_ii_grey16_zstd.tif": lambda p: write_tiff(p, grey16, photometric=1, bits=16,
                                                                compression=50000, rows_per_strip=5, big=True),
        # Pillow 12.1 cannot open a big-endian BigTIFF
        "tiff_bigtiff_mm_grey16.tif": lambda p: write_tiff(p, grey16[:5, :7], order=">", photometric=1, bits=16,
                                                           big=True),
        # what Pillow 12.1's libtiff cannot decode: WebP and JPEG 2000 strips
        "tiff_webp_strip.tif": lambda p: foreign_tiff(p, u8(16, 24, 3, 66), 50001, "WEBP", lossless=True),
        "tiff_jpeg2000_strip.tif": lambda p: foreign_tiff(p, u8(16, 24, 3, 67), 34712, "JPEG2000"),
    }
    return out


# ---- WebP ---------------------------------------------------------------


def riff(chunks) -> bytes:
    body = b"".join(tag + struct.pack("<I", len(data)) + data + (b"\0" if len(data) % 2 else b"")
                    for tag, data in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def webp_chunks(data: bytes):
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def filtered_alpha(alpha: np.ndarray, method: int) -> bytes:
    """An ALPH chunk of raw (uncompressed) alpha under filter `method`
    (1 horizontal, 2 vertical, 3 gradient), as libwebp's unfilters undo."""
    a = alpha.astype(np.int32)
    h, w = a.shape
    res = np.zeros_like(a)
    for yy in range(h):
        for xx in range(w):
            if yy == 0:
                pred = 0 if xx == 0 else a[0, xx - 1]
            elif method == 1:
                pred = a[yy - 1, 0] if xx == 0 else a[yy, xx - 1]
            elif method == 2:
                pred = a[yy - 1, xx]
            else:
                pred = a[yy - 1, 0] if xx == 0 else min(max(a[yy, xx - 1] + a[yy - 1, xx] - a[yy - 1, xx - 1], 0), 255)
            res[yy, xx] = (a[yy, xx] - pred) % 256
    return bytes([method << 2]) + res.astype(np.uint8).tobytes()


def lossy_with_alpha(rgb: np.ndarray, alpha: np.ndarray, method: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "WEBP", quality=80)
    vp8 = dict(webp_chunks(buf.getvalue()))[b"VP8 "]
    h, w = alpha.shape
    vp8x = struct.pack("<I", 0x10) + struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3]
    return riff([(b"VP8X", vp8x), (b"ALPH", filtered_alpha(alpha, method)), (b"VP8 ", vp8)])


def webps() -> dict:
    rgb = u8(40, 56, 3, 70)
    rgba = np.concatenate([u8(20, 28, 3, 71), np.clip(u8(20, 28, 1, 72).astype(int) * 2 - 100, 0, 255).astype(
        np.uint8)], -1)  # alpha 0, 255 and between
    frames = [Image.fromarray(u8(24, 32, 3, 73 + k)) for k in range(3)]

    def save(p, img, **kw):
        Image.fromarray(img).save(p, "WEBP", **kw)

    return {
        "webp_lossless_rgba.webp": lambda p: save(p, rgba, lossless=True),
        "webp_lossless_palette.webp": lambda p: save(p, (u8(30, 41, 3, 74) // 64 * 85).astype(np.uint8),
                                                     lossless=True),
        "webp_lossy.webp": lambda p: save(p, rgb, quality=80),
        "webp_lossy_q20_odd.webp": lambda p: save(p, u8(37, 51, 3, 75), quality=20, method=6),
        "webp_lossy_alpha.webp": lambda p: save(p, rgba, quality=75),
        "webp_lossy_alpha_q30.webp": lambda p: save(p, rgba, quality=90, alpha_quality=30),
        **{f"webp_lossy_alpha_filter{m}.webp": lambda p, m=m: p.write_bytes(
            lossy_with_alpha(rgba[..., :3], rgba[..., 3], m)) for m in (1, 2, 3)},
        "webp_animated.webp": lambda p: frames[0].save(p, "WEBP", save_all=True, append_images=frames[1:],
                                                       quality=70, duration=100),
    }


# ---- BMP ----------------------------------------------------------------


def rle_encode(idx: np.ndarray, rle4: bool) -> bytes:
    """BI_RLE8 / BI_RLE4 rows bottom-up: encoded runs, absolute runs of
    three or more pixels (an even count for RLE4), end of line / bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        row = [int(v) for v in row]
        i, n = 0, len(row)
        while i < n:
            j = i
            if rle4:
                while j + 2 < n and j - i < 253 and row[j + 2] == row[j]:
                    j += 1
                run = j - i + 2 if j > i else 1
                run = min(run, n - i)
            else:
                while j < n and j - i < 255 and row[j] == row[i]:
                    j += 1
                run = j - i
            if run >= 3 or (rle4 and run >= 2) or n - i < 4:
                a = row[i]
                b = row[i + 1] if rle4 and i + 1 < n else a
                out += bytes([run, (a << 4 | b) if rle4 else a])
                i += run
                continue
            k = min(n - i, 16)
            if rle4 and k % 2:
                k -= 1
            lit = row[i:i + k]
            out += bytes([0, k])
            if rle4:
                out += bytes((lit[m] << 4) | lit[m + 1] for m in range(0, k, 2))
                nbytes = k // 2
            else:
                out += bytes(lit)
                nbytes = k
            if nbytes % 2:
                out += b"\0"
            i += k
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def write_bmp(path: Path, *, width: int, height: int, bits: int, pixels: bytes, header: int = 40, compression: int = 0,
              palette: bytes = b"", masks=(), top_down: bool = False, colors: int = 0) -> None:
    """A BMP of the given header size; `pixels` are the stored rows."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        h = -height if top_down else height
        info = struct.pack("<IiiHHIIiiII", header, width, h, 1, bits, compression, len(pixels), 2835, 2835, colors, 0)
        if header >= 52:
            info += struct.pack("<III", *(list(masks) + [0, 0, 0])[:3])
        if header >= 56:
            info += struct.pack("<I", (list(masks) + [0, 0, 0, 0])[3])
        info = info.ljust(header, b"\0")
        if header == 40 and masks:
            info += struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(palette)
    head = b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
    path.write_bytes(head + info + palette + pixels)


def rows_bytes(rows: np.ndarray, top_down: bool = False) -> bytes:
    """Stored rows [H, B] uint8, each padded to 4 bytes, bottom-up unless top-down."""
    stride = (rows.shape[1] + 3) & ~3
    pad = np.zeros((rows.shape[0], stride), np.uint8)
    pad[:, :rows.shape[1]] = rows
    return (pad if top_down else pad[::-1]).tobytes()


def pillow_p(idx: np.ndarray, palette: bytes) -> Image.Image:
    im = Image.fromarray(idx, "P")
    im.putpalette(palette[:768])
    return im


def bmps() -> dict:
    rgb = u8(13, 19, 3, 10)
    idx8 = (u8(14, 21, 1, 11)[..., 0] // 8).astype(np.uint8)
    idx4 = (u8(14, 21, 1, 12)[..., 0] // 32).astype(np.uint8)
    pal256 = bytes(np.random.default_rng(13).integers(0, 256, 256 * 4, dtype=np.uint8))
    pal16 = bytes(np.random.default_rng(14).integers(0, 256, 16 * 4, dtype=np.uint8))
    bgr = rgb[..., ::-1]
    p555 = ((rgb[..., 0].astype(np.uint16) >> 3) << 10) | ((rgb[..., 1].astype(np.uint16) >> 3) << 5) | (
        rgb[..., 2] >> 3)
    p565 = ((rgb[..., 0].astype(np.uint16) >> 3) << 11) | ((rgb[..., 1].astype(np.uint16) >> 2) << 5) | (
        rgb[..., 2] >> 3)
    alpha = u8(13, 19, 1, 15)
    bits1 = (u8(11, 35, 1, 16)[..., 0] > 128).astype(np.uint8)
    packed1 = np.packbits(bits1, axis=1)
    return {
        "bmp_pillow_rgb.bmp": lambda p: Image.fromarray(rgb).save(p),
        "bmp_pillow_l.bmp": lambda p: Image.fromarray(rgb[..., 0]).save(p),
        "bmp_pillow_p.bmp": lambda p: pillow_p(idx8, pal256).save(p),
        "bmp_pillow_1bit.bmp": lambda p: Image.fromarray(bits1.astype(bool)).save(p),
        "bmp_rgb24_topdown.bmp": lambda p: write_bmp(p, width=19, height=13, bits=24, top_down=True,
                                                     pixels=rows_bytes(bgr.reshape(13, -1), True)),
        "bmp_rgb24_core.bmp": lambda p: write_bmp(p, width=19, height=13, bits=24, header=12,
                                                  pixels=rows_bytes(bgr.reshape(13, -1))),
        "bmp_rgb32_v4.bmp": lambda p: write_bmp(p, width=19, height=13, bits=32, header=108, pixels=rows_bytes(
            np.concatenate([bgr, alpha], -1).reshape(13, -1))),
        "bmp_rgba32_v5_bitfields.bmp": lambda p: write_bmp(
            p, width=19, height=13, bits=32, header=124, compression=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
            pixels=rows_bytes(np.concatenate([bgr, alpha], -1).reshape(13, -1))),
        "bmp_xbgr32_bitfields.bmp": lambda p: write_bmp(
            p, width=19, height=13, bits=32, compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00),
            pixels=rows_bytes(np.concatenate([alpha, rgb], -1).reshape(13, -1))),
        "bmp_rgb555.bmp": lambda p: write_bmp(p, width=19, height=13, bits=16,
                                              pixels=rows_bytes(p555.astype("<u2").view(np.uint8).reshape(13, -1))),
        "bmp_rgb565_bitfields.bmp": lambda p: write_bmp(
            p, width=19, height=13, bits=16, compression=3, masks=(0xF800, 0x7E0, 0x1F),
            pixels=rows_bytes(p565.astype("<u2").view(np.uint8).reshape(13, -1))),
        "bmp_rle8.bmp": lambda p: write_bmp(p, width=21, height=14, bits=8, compression=1, palette=pal256,
                                            pixels=rle_encode(idx8, False)),
        "bmp_rle4.bmp": lambda p: write_bmp(p, width=21, height=14, bits=4, compression=2, palette=pal16,
                                            pixels=rle_encode(idx4, True)),
        "bmp_pal4.bmp": lambda p: write_bmp(p, width=21, height=14, bits=4, palette=pal16, pixels=rows_bytes(
            ((idx4[:, 0::2] << 4) | np.pad(idx4[:, 1::2], ((0, 0), (0, 1)))[:, :idx4[:, 0::2].shape[1]]))),
        "bmp_pal1_topdown.bmp": lambda p: write_bmp(p, width=35, height=11, bits=1, top_down=True,
                                                    palette=bytes([10, 20, 30, 0, 200, 150, 100, 0]),
                                                    pixels=rows_bytes(packed1, True)),
        "bmp_pal4_grey_ramp.bmp": lambda p: write_bmp(
            p, width=13, height=6, bits=4, colors=16, palette=b"".join(bytes([i, i, i, 0]) for i in range(16)),
            pixels=rows_bytes((u8(6, 14, 1, 17)[..., 0] // 16).reshape(6, 7, 2).astype(np.uint8) @ np.array(
                [16, 1], np.uint8))),
        "bmp_pal8_core.bmp": lambda p: write_bmp(p, width=21, height=14, bits=8, header=12,
                                                 palette=bytes(b for i in range(256) for b in pal256[4 * i:4 * i + 3]),
                                                 pixels=rows_bytes(idx8)),
    }


# ---- GIF ----------------------------------------------------------------


def pillow_gif_data(idx: np.ndarray, palette: bytes, interlace: bool) -> bytes:
    """The LZW code size byte and data sub-blocks Pillow writes for indices."""
    im = Image.fromarray(idx, "P")
    im.putpalette(palette)
    buf = io.BytesIO()
    im.save(buf, "GIF", interlace=interlace, optimize=False)
    data = buf.getvalue()
    pos = data.index(b",", 13 + 3 * 256 if data[10] & 128 else 13)
    pos += 10
    if data[pos - 1] & 128:
        pos += 3 << ((data[pos - 1] & 7) + 1)
    end = pos + 1
    while data[end]:
        end += 1 + data[end]
    return data[pos:end + 1]


def write_gif(path: Path, size, frame, idx: np.ndarray, *, global_palette=None, local_palette=None, interlace=False,
              transparency=None) -> None:
    gflags = 0
    gp = b""
    if global_palette is not None:
        gflags = 0x80 | 7
        gp = global_palette.ljust(768, b"\0")
    out = b"GIF89a" + struct.pack("<HHBBB", size[0], size[1], gflags, 0, 0) + gp
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1]) + b"\0\0" + bytes([transparency]) + b"\0"
    x0, y0 = frame
    h, w = idx.shape
    fflags = (0x40 if interlace else 0) | (0x87 if local_palette is not None else 0)
    out += b"," + struct.pack("<HHHHB", x0, y0, w, h, fflags)
    if local_palette is not None:
        out += local_palette.ljust(768, b"\0")
    out += pillow_gif_data(idx, (local_palette or global_palette or bytes(range(256)) * 3).ljust(768, b"\0"),
                           interlace) + b";"
    path.write_bytes(out)


def gifs() -> dict:
    idx = (u8(23, 31, 1, 20)[..., 0] // 4).astype(np.uint8)
    noise = np.random.default_rng(21).integers(0, 256, (40, 37), dtype=np.uint8)
    pal = bytes(np.random.default_rng(22).integers(0, 256, 768, dtype=np.uint8))
    grey = bytes(v for i in range(256) for v in (i, i, i))

    def pillow(p, arr, interlace, mode="P"):
        im = Image.fromarray(arr, mode)
        if mode == "P":
            im.putpalette(pal)
        im.save(p, interlace=interlace)

    return {
        "gif_pillow.gif": lambda p: pillow(p, idx, False),
        "gif_pillow_interlaced.gif": lambda p: pillow(p, idx, True),
        "gif_pillow_noise.gif": lambda p: pillow(p, noise, True),
        "gif_pillow_l.gif": lambda p: pillow(p, noise[:7, :5], False, "L"),
        "gif_local_palette_offset.gif": lambda p: write_gif(p, (24, 20), (3, 2), idx[:16, :18], local_palette=pal),
        "gif_grows_canvas_transparent.gif": lambda p: write_gif(p, (20, 10), (5, 4), idx[:17, :19],
                                                                global_palette=pal, interlace=True, transparency=9),
        "gif_identity_local_palette.gif": lambda p: write_gif(p, (18, 16), (0, 0), noise[:16, :18],
                                                              global_palette=pal, local_palette=grey),
    }


# ---- JPEG ---------------------------------------------------------------


def cut_scans(data: bytes, scans: int) -> bytes:
    """The file up to its first `scans` scans, then EOI."""
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:starts[scans]] + b"\xff\xd9"


def cut_progressive(path: Path, img: np.ndarray, scans: int, **kw) -> None:
    """A progressive JPEG of Pillow's kept up to its first `scans` scans."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True, **kw)
    data = buf.getvalue()
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    path.write_bytes(data[:starts[scans]] + b"\xff\xd9")


def cmyk_jpeg(img: np.ndarray, transform: int = None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", **kw)
    data = bytearray(buf.getvalue())
    if transform is not None:
        at = data.index(b"Adobe")
        data[at + 11] = transform
    return bytes(data)


def patched_sof(img: np.ndarray, marker: int, precision: int = 8) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    at = data.index(b"\xff\xc0")
    data[at + 1] = marker
    data[at + 4] = precision
    return bytes(data)


# the standard luminance DC table (ITU T.81 K.3): code lengths of categories 0-11
DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_VALS = tuple(range(12))


def huffman_codes(bits, vals) -> dict:
    codes, code, k = {}, 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            codes[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def lossless_jpeg(img: np.ndarray, predictor: int, pt: int = 0, restart_rows: int = 0, rgb_ids: bool = False,
                  scans: str = "interleaved") -> bytes:
    """A lossless (SOF3) 8-bit JPEG of uint8 [H, W] or [H, W, 3], Huffman-coded
    with the standard DC table: one interleaved scan or one scan per
    component; a JFIF marker (YCbCr) unless `rgb_ids` names the components
    R, G, B (no colour conversion)."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, nc = img.shape
    red = (img.astype(np.int64) >> pt)
    codes = huffman_codes(DC_BITS, DC_VALS)

    def diffs(c):  # [h, w] differences of component c, as the decoder predicts
        x = red[..., c]
        out = np.zeros((h, w), np.int64)
        first = 0
        for y in range(h):
            if restart_rows and y and y % restart_rows == 0:
                first = y
            for i in range(w):
                if y == first:
                    pred = (1 << (7 - pt)) if i == 0 else x[y, i - 1]
                elif i == 0:
                    pred = x[y - 1, 0]
                else:
                    ra, rb, rc = int(x[y, i - 1]), int(x[y - 1, i]), int(x[y - 1, i - 1])
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                            7: (ra + rb) >> 1}[predictor]
                d = (int(x[y, i]) - int(pred)) & 0xFFFF
                out[y, i] = d - 65536 if d >= 32768 else d
        return out

    d = [diffs(c) for c in range(nc)]

    def entropy(comps) -> bytes:
        out, acc, nacc = bytearray(), 0, 0

        def put(v, n):
            nonlocal acc, nacc
            acc, nacc = (acc << n) | v, nacc + n
            while nacc >= 8:
                b = (acc >> (nacc - 8)) & 0xFF
                out.append(b)
                if b == 0xFF:
                    out.append(0)
                nacc -= 8

        def flush():
            nonlocal acc, nacc
            if nacc:
                put((1 << (8 - nacc)) - 1, 8 - nacc)

        marker = 0
        for y in range(h):
            if restart_rows and y and y % restart_rows == 0:
                flush()
                out.extend(bytes([0xFF, 0xD0 + marker % 8]))
                marker += 1
            for i in range(w):
                for c in comps:
                    v = int(d[c][y, i])
                    s = abs(v).bit_length()
                    code, n = codes[s]
                    put(code, n)
                    if s:
                        put(v if v > 0 else v + (1 << s) - 1, s)
        flush()
        return bytes(out)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    ids = [ord(ch) for ch in "RGB"] if rgb_ids else list(range(1, nc + 1))
    out = b"\xff\xd8"
    if not rgb_ids:
        out += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    out += seg(0xC3, struct.pack(">BHHB", 8, h, w, nc) + b"".join(bytes([i, 0x11, 0]) for i in ids))
    out += seg(0xC4, bytes([0x00]) + bytes(DC_BITS) + bytes(DC_VALS))
    if restart_rows:
        out += seg(0xDD, struct.pack(">H", restart_rows * w))
    groups = [list(range(nc))] if scans == "interleaved" else [[c] for c in range(nc)]
    for comps in groups:
        out += seg(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], 0x00]) for c in comps)
                   + bytes([predictor, 0, pt]))
        out += entropy(comps)
    return out + b"\xff\xd9"


# ITU T.81 Table D.2 as libjpeg's jaritab.c packs it: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS), with state 113 the fixed estimate of one half
QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0),
    (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0), (0x001a, 33, 10, 0),
    (0x000d, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0),
    (0x002c, 33, 9, 0), (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0),
    (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1),
    (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0), (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0), (0x34ee, 91, 85, 0),
    (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0),
    (0x56a8, 95, 96, 1), (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504f, 111, 107, 0),
    (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
]
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
          21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
          60, 61, 54, 47, 55, 62, 63]
AC0 = 2 * 64  # ArithEncoder.bins: DC bins of table t at 64 t, AC bins at AC0 + 256 t, then the fixed bin
FIXED = AC0 + 2 * 256


class ArithEncoder:
    """libjpeg's jcarith.c QM encoder: arith_encode and its termination, the
    bins as one flat array (state index | MPS << 7)."""

    def __init__(self):
        self.out = bytearray()
        self.bins = [0] * (FIXED + 1)
        self.reset()

    def reset(self):
        self.c, self.a, self.ct, self.sc, self.zc, self.buffer = 0, 0x10000, 11, 0, 0, -1
        self.bins[:FIXED] = [0] * FIXED
        self.bins[FIXED] = 113

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: int, val: int) -> None:
        sv = self.bins[st]
        qe, nl, nm, sw = QE[sv & 0x7F]
        nl = (sw << 7) | nl
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            self.bins[st] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            self.bins[st] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        while self.sc:
                            self._emit(0xFF)
                            self._emit(0)
                            self.sc -= 1
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                while self.sc:
                    self._emit(0xFF)
                    self._emit(0)
                    self.sc -= 1
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        out = bytes(self.out)
        self.out = bytearray()
        self.zc = 0
        return out


def arith_jpeg(planes, sampling, *, progressive: bool, restart: int = 0, dac=None, qscale: int = 1) -> bytes:
    """An arithmetic-coded JPEG (SOF9 sequential or SOF10 progressive, with
    libjpeg's default progression) of the quantized DCT coefficients of
    float sample planes [h_c, w_c] (component c at `sampling[c]` = (h, v)).
    Every bin layout, decision order and conditioning is jdarith.c's."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height = planes[0].shape[0] * vmax // sampling[0][1]
    width = planes[0].shape[1] * hmax // sampling[0][0]
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    q = np.clip((1 + np.add.outer(np.arange(8), np.arange(8))) * qscale, 1, 255)
    n = len(planes)
    dc_l, dc_u, ac_k = [0, 0], [1, 1], [5, 5]
    for tc, tb, v in dac or ():
        if tc == 0:
            dc_l[tb], dc_u[tb] = v & 15, v >> 4
        else:
            ac_k[tb] = v
    tbl = [0] + [1] * (n - 1)
    coefs = []
    from scipy.fft import dctn
    for c, plane in enumerate(planes):
        bw, bh = mx * sampling[c][0], my * sampling[c][1]
        padded = np.pad(plane, ((0, bh * 8 - plane.shape[0]), (0, bw * 8 - plane.shape[1])), mode="edge") - 128
        blocks = padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        d = dctn(blocks, type=2, norm="ortho", axes=(2, 3))
        coefs.append(np.clip(np.round(d / q), -1000, 1000).astype(np.int64).reshape(bh, bw, 64)[..., ZIGZAG])
    ids = list(range(1, n + 1))

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8" + (seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0") if n == 3 else b"")
    out += seg(0xDB, b"".join(bytes([t]) + bytes(int(v) for v in q.ravel()[ZIGZAG]) for t in sorted(set(tbl))))
    out += seg(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, height, width, n)
               + b"".join(bytes([ids[c], sampling[c][0] << 4 | sampling[c][1], tbl[c]]) for c in range(n)))
    if dac:
        out += seg(0xCC, b"".join(bytes([tc << 4 | tb, v]) for tc, tb, v in dac))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    if not progressive:
        script = [(list(range(n)), 0, 63, 0, 0)]
    elif n == 1:
        script = [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), ([0], 0, 0, 1, 0),
                  ([0], 1, 63, 1, 0)]
    else:
        script = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
                  ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0),
                  ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]
    enc = ArithEncoder()
    for comps, ss, se, ah, al in script:
        out += seg(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], tbl[c] << 4 | tbl[c]]) for c in comps)
                   + bytes([ss, se, ah << 4 | al]))
        enc.reset()
        last, ctx = [0] * n, [0] * n

        def dc_diff(c, v):
            base = tbl[c] * 64
            st = base + ctx[c]
            if v == 0:
                enc.encode(st, 0)
                ctx[c] = 0
                return
            enc.encode(st, 1)
            sign = int(v < 0)
            enc.encode(st + 1, sign)
            st += 2 + sign
            t = abs(v) - 1
            m = 1 << (t.bit_length() - 1) if t else 0
            if t:
                enc.encode(st, 1)
                st, cur = base + 20, 1
                while cur < m:
                    enc.encode(st, 1)
                    cur <<= 1
                    st += 1
                enc.encode(st, 0)
            else:
                enc.encode(st, 0)
            if m < (1 << dc_l[tbl[c]]) >> 1:
                ctx[c] = 0
            elif m > (1 << dc_u[tbl[c]]) >> 1:
                ctx[c] = 12 + sign * 4
            else:
                ctx[c] = 4 + sign * 4
            st += 14
            while m := m >> 1:
                enc.encode(st, int(bool(t & m)))

        def ac_first(c, blk, ss, se, al):
            base = AC0 + 256 * tbl[c]
            vals = [(abs(int(blk[k])) >> al) * (1 if blk[k] >= 0 else -1) for k in range(64)]
            ke = max([k for k in range(ss, se + 1) if vals[k]] or [ss - 1])
            k = ss
            while k <= ke:
                st = base + 3 * (k - 1)
                enc.encode(st, 0)
                while vals[k] == 0:
                    enc.encode(st + 1, 0)
                    st += 3
                    k += 1
                enc.encode(st + 1, 1)
                enc.encode(FIXED, int(vals[k] < 0))
                st += 2
                t = abs(vals[k]) - 1
                m = 1 << (t.bit_length() - 1) if t else 0
                if t == 0:
                    enc.encode(st, 0)
                elif m == 1:
                    enc.encode(st, 1)
                    enc.encode(st, 0)
                else:
                    enc.encode(st, 1)
                    enc.encode(st, 1)
                    st, cur = base + (189 if k <= ac_k[tbl[c]] else 217), 2
                    while cur < m:
                        enc.encode(st, 1)
                        cur <<= 1
                        st += 1
                    enc.encode(st, 0)
                st += 14
                while m := m >> 1:
                    enc.encode(st, int(bool(t & m)))
                k += 1
            if k <= se:
                enc.encode(base + 3 * (k - 1), 1)

        def ac_refine(c, blk, ss, se, al):
            base = AC0 + 256 * tbl[c]
            mags = [abs(int(blk[k])) for k in range(64)]
            ke = max([k for k in range(ss, se + 1) if mags[k] >> al] or [ss - 1])
            kex = max([k for k in range(ss, se + 1) if mags[k] >> (al + 1)] or [0])
            k = ss
            while k <= ke:
                st = base + 3 * (k - 1)
                if k > kex:
                    enc.encode(st, 0)
                while True:
                    if mags[k] >> (al + 1):
                        enc.encode(st + 2, (mags[k] >> al) & 1)
                        break
                    if mags[k] >> al:
                        enc.encode(st + 1, 1)
                        enc.encode(FIXED, int(blk[k] < 0))
                        break
                    enc.encode(st + 1, 0)
                    st += 3
                    k += 1
                k += 1
            if k <= se:
                enc.encode(base + 3 * (k - 1), 1)

        def block(c, by, bx):
            blk = coefs[c][by, bx]
            if not progressive:
                dc = int(blk[0])
                dc_diff(c, ((dc - last[c] + 32768) & 0xFFFF) - 32768)
                last[c] = dc
                ac_first(c, blk, 1, 63, 0)
            elif ss == 0 and ah == 0:
                dc = int(blk[0]) >> al
                dc_diff(c, dc - last[c])
                last[c] = dc
            elif ss == 0:
                enc.encode(FIXED, (int(blk[0]) >> al) & 1)
            elif ah == 0:
                ac_first(c, blk, ss, se, al)
            else:
                ac_refine(c, blk, ss, se, al)

        if len(comps) == 1:
            c = comps[0]
            units = [(c, by, bx) for by in range(-(-planes[c].shape[0] // 8)) for bx in range(-(-planes[c].shape[1] // 8))]
            mcus = [[u] for u in units]
        else:
            mcus = [[(c, yy * sampling[c][1] + v, xx * sampling[c][0] + h) for c in comps for v in range(sampling[c][1])
                     for h in range(sampling[c][0])] for yy in range(my) for xx in range(mx)]
        data = b""
        for i, mcu in enumerate(mcus):
            if restart and i and i % restart == 0:
                data += enc.finish() + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                enc.reset()
                last, ctx = [0] * n, [0] * n
            for unit in mcu:
                block(*unit)
        out += data + enc.finish()
    return out + b"\xff\xd9"


def jpegs() -> dict:
    rgb = u8(40, 56, 3, 30)
    odd = u8(37, 45, 3, 31)
    grey = u8(33, 41, 1, 32)[..., 0]
    cmyk = u8(24, 32, 4, 33)
    out = {
        "jpeg_cmyk.jpg": lambda p: p.write_bytes(cmyk_jpeg(cmyk, quality=90)),
        "jpeg_ycck.jpg": lambda p: p.write_bytes(cmyk_jpeg(cmyk, transform=2, quality=90)),
        "jpeg_cmyk_420.jpg": lambda p: p.write_bytes(cmyk_jpeg(u8(27, 35, 4, 34), transform=2, subsampling=2)),
        "jpeg_12bit.jpg": lambda p: p.write_bytes(patched_sof(u8(8, 8, 3, 35), 0xC1, 12)),
        "jpeg_hierarchical.jpg": lambda p: p.write_bytes(patched_sof(u8(8, 8, 3, 36), 0xC5)),
        "webp_lossless.webp": lambda p: Image.fromarray(rgb[:9, :11]).save(p, lossless=True),
    }
    lossless_rgb, lossless_grey = u8(13, 17, 3, 37), u8(11, 14, 1, 38)[..., 0]
    for pred in range(1, 8):
        out[f"jpeg_lossless_rgb_p{pred}.jpg"] = lambda p, q=pred: p.write_bytes(
            lossless_jpeg(lossless_rgb, q, rgb_ids=True))
    out.update({
        "jpeg_lossless_grey_p4_pt2.jpg": lambda p: p.write_bytes(lossless_jpeg(lossless_grey, 4, pt=2)),
        "jpeg_lossless_grey_p7_restart.jpg": lambda p: p.write_bytes(lossless_jpeg(lossless_grey, 7, restart_rows=3)),
        "jpeg_lossless_rgb_p6_pt1_scans.jpg": lambda p: p.write_bytes(
            lossless_jpeg(lossless_rgb, 6, pt=1, rgb_ids=True, scans="separate")),
        "jpeg_lossless_rgb_p5_restart.jpg": lambda p: p.write_bytes(
            lossless_jpeg(lossless_rgb, 5, restart_rows=2, rgb_ids=True)),
        # YCbCr (a JFIF marker): libjpeg-turbo converts no colours of a lossless image, so Pillow refuses it
        "jpeg_lossless_ycc.jpg": lambda p: p.write_bytes(lossless_jpeg(lossless_rgb, 1)),
        # SOF11 over Huffman-coded data (this script has no arithmetic lossless encoder): Pillow's libjpeg fails on
        # the data, the port refuses the frame
        "jpeg_lossless_arith_marker.jpg": lambda p: p.write_bytes(
            lossless_jpeg(lossless_grey, 1).replace(b"\xff\xc3", b"\xff\xcb", 1)),
        # a 2 x 2 sampling factor on a lossless frame's first component (its data coded for 1 x 1)
        "jpeg_lossless_subsampled.jpg": lambda p: p.write_bytes(subsampled_lossless(lossless_jpeg(
            lossless_rgb, 1, rgb_ids=True))),
    })
    def planes(h, w, sampling, seed):
        hmax, vmax = max(a for a, _ in sampling), max(b for _, b in sampling)
        return [smooth(-(-h * v // vmax), -(-w * a // hmax), 1, seed + i, noise=12.0)[..., 0]
                for i, (a, b) in enumerate(sampling) for v in [b]]

    out.update({
        "jpeg_arith_grey.jpg": lambda p: p.write_bytes(arith_jpeg(planes(29, 35, [(1, 1)], 40), [(1, 1)],
                                                                  progressive=False)),
        "jpeg_arith_420_restart.jpg": lambda p: p.write_bytes(arith_jpeg(
            planes(37, 45, [(2, 2), (1, 1), (1, 1)], 41), [(2, 2), (1, 1), (1, 1)], progressive=False, restart=3)),
        "jpeg_arith_444_dac.jpg": lambda p: p.write_bytes(arith_jpeg(
            planes(24, 40, [(1, 1)] * 3, 42), [(1, 1)] * 3, progressive=False, dac=[(0, 0, 0x52), (1, 0, 12),
                                                                                    (0, 1, 0x10), (1, 1, 3)])),
        "jpeg_arith_progressive_420.jpg": lambda p: p.write_bytes(arith_jpeg(
            planes(40, 56, [(2, 2), (1, 1), (1, 1)], 43), [(2, 2), (1, 1), (1, 1)], progressive=True)),
        "jpeg_arith_progressive_grey_restart.jpg": lambda p: p.write_bytes(arith_jpeg(
            planes(33, 41, [(1, 1)], 44), [(1, 1)], progressive=True, restart=5, qscale=2)),
        "jpeg_arith_progressive_422_cut.jpg": lambda p: p.write_bytes(cut_scans(arith_jpeg(
            planes(30, 38, [(2, 1), (1, 1), (1, 1)], 45), [(2, 1), (1, 1), (1, 1)], progressive=True), 4)),
    })
    for scans in (1, 2, 3, 4, 6, 8):
        out[f"jpeg_progressive_cut{scans}.jpg"] = lambda p, s=scans: cut_progressive(p, rgb, s, quality=80)
    for scans in (1, 3, 5):
        out[f"jpeg_progressive_odd_cut{scans}.jpg"] = lambda p, s=scans: cut_progressive(
            p, odd, s, quality=60, subsampling=1)
    for scans in (1, 2, 4):
        out[f"jpeg_progressive_grey_cut{scans}.jpg"] = lambda p, s=scans: cut_progressive(p, grey, s, quality=85)
    return out


def subsampled_lossless(data: bytes) -> bytes:
    """A lossless frame whose first component claims 2 x 2 sampling."""
    b = bytearray(data)
    i = data.index(b"\xff\xc3")
    b[i + 11] = 0x22
    return bytes(b)


def record(path: Path) -> dict:
    try:
        im = Image.open(path)
        arr = np.ascontiguousarray(np.asarray(im))
    except Exception as e:  # noqa: BLE001 - the refusal is the record
        return {"pillow_raises": type(e).__name__}
    rec = {"mode": im.mode, "sha256": hashlib.sha256(arr.tobytes()).hexdigest(), "shape": list(arr.shape),
           "dtype": str(arr.dtype)}
    return rec


def main() -> None:
    manifest = {}
    for group in (tiffs(), tiffs_codecs(), bmps(), gifs(), jpegs(), webps()):
        for name, write in group.items():
            write(ROOT / name)
            manifest[name] = record(ROOT / name)
    (ROOT / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    print(f"{len(manifest)} files, {sum((ROOT / n).stat().st_size for n in manifest)} bytes")


if __name__ == "__main__":
    main()
