"""The image formats Pillow opens beyond PNG, JPEG, TIFF, BMP, GIF and WebP,
decoded as Pillow decodes them (Pillow is not on the card's machine): each
decoder returns what `np.asarray(Image.open(path))` gives, with Pillow's
mode, so that resizing follows Pillow's rules.

- netpbm (PpmImagePlugin): P1-P6, plain and raw, and Pillow's P0CMYK /
  PyP / PyRGBA / PyCMYK; maxval 1-65535: 8-bit grey and colour rescaled
  to 0-255, 16-bit grey to mode "I" (int32) on 0-65535, each value
  round(v / maxval * top) (half to even); P1 / P4 mode "1" (bool); "Pf"
  grey PFM float32, its rows bottom-up, little-endian for a negative
  scale. "PF", "P7" and maxval 0 or above 65535 are refused, as Pillow
  refuses them.
- TGA: image types 1 / 2 / 3 and RLE 9 / 10 / 11 at 1 (uncompressed), 8,
  16 (grey + alpha, or 5-5-5 colour with its top bit a transparent flag),
  24 and 32 bits; colour-mapped files give their indices; either origin.
- QOI: every op (Pillow's decoder: the index table starts at zeros).
- SGI: verbatim and RLE, 1, 3 and 4 channels, 8 and 16 bits (16-bit
  samples give their high byte, modes "L" / "RGB" / "RGBA").
- PCX (1 bit, 1-bit planes x 2 / 4, 8-bit grey or palette, 24-bit as 3
  planes) and DCX (its first page).
- ICO (the entry Pillow's IcoFile picks: the largest, then the fewest
  colours; BMP entries made RGBA with their AND mask or 32-bit alpha, PNG
  entries as they are) and CUR (the largest cursor's bitmap, no mask).
- DDS: uncompressed layouts by their bit masks (RGB, RGBA, L, LA, P8,
  DX10 R8G8B8A8) and BC1 (DXT1) - BC7 (BC4 / BC5 unsigned and signed,
  BC6H unsigned and signed), the first mip level.
- IM (the "Image type:" text header; 1, L, P, RGB, I, F and the other
  line-interleaved layouts of Pillow's table) and Sun raster (types 0, 1,
  3, 4, 5 and RLE 2; 1, 4, 8, 24 and 32 bits; colour maps give indices).

The per-pixel loops (plain netpbm, the TGA / Sun / PCX / SGI run lengths,
QOI and the BCn blocks) are host C++ (native/raster_codecs.cpp), built with
g++ at first use; when it cannot be built, decoding raises. A variant that
these decoders do not read, and one that Pillow refuses, raises
NotImplementedError naming the format and the variant.
"""

import ctypes
import math
import re
import struct
from typing import Optional, Tuple

import numpy as np

from nerfstudio_thermal_torch.data.native_build import NATIVE_DIR, build_library

SOURCE = NATIVE_DIR / "raster_codecs.cpp"
_lib = None


def load_library():
    """The codec library, built at first use; raises when it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(str(build_library(SOURCE, "libraster_codecs")))
        except Exception as e:
            raise RuntimeError(f"the raster codecs ({SOURCE.name}) could not be built or loaded: {e}") from e
        if lib.raster_codecs_abi_version() != 1:
            raise RuntimeError("the raster codec library has an unexpected ABI version")
        p, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        for name, args in (("netpbm_plain_decode", [p, sz, i, i, i, p, sz]),
                           ("tga_rle_decode", [p, sz, i, sz, i, p]),
                           ("sun_rle_decode", [p, sz, sz, i, p]),
                           ("pcx_rle_decode", [p, sz, sz, i, p]),
                           ("sgi_rle_decode", [p, sz, i, i, i, i, p]),
                           ("qoi_decode", [p, sz, i, sz, p]),
                           ("bit_decode", [p, sz, i, i, i, p]),
                           ("bcn_decode", [p, sz, i, i, i, i, p])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _refuse(path, what: str):
    raise NotImplementedError(f"{path}: {what} (Pillow refuses it too)")


def _run(name: str, what: str, path, *args) -> None:
    """Call a codec; its failures raise NotImplementedError (Pillow fails on
    the same data)."""
    rc = getattr(load_library(), name)(*args)
    if rc == 1:
        raise NotImplementedError(f"{path}: {what} is not supported")
    if rc == 2:
        _refuse(path, f"corrupt {what} data")
    if rc == 3:
        _refuse(path, f"truncated {what} data")


def _buf(data: bytes, start: int = 0) -> Tuple[ctypes.c_void_p, int]:
    """A pointer to data[start:] without a copy, and its length."""
    view = np.frombuffer(data, np.uint8)[start:]
    return view.ctypes.data_as(ctypes.c_void_p), view.size


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _raw(data: bytes, offset: int, size: int, path, what: str) -> np.ndarray:
    if offset + size > len(data):
        _refuse(path, f"truncated {what} data")
    return np.frombuffer(data, np.uint8, size, offset)


def _bits(rows: np.ndarray, width: int, inverted: bool = False) -> np.ndarray:
    """MSB-first bit rows [H, stride] -> Pillow's mode "1" array [H, W]
    ("1;I" inverted: a 0 bit is white)."""
    from nerfstudio_thermal_torch.data.image_formats import _bilevel

    on = np.unpackbits(rows, axis=1)[:, :width]
    return _bilevel(on == 0 if inverted else on != 0)


def _unpack4(rows: np.ndarray, width: int) -> np.ndarray:
    return np.stack([rows >> 4, rows & 15], -1).reshape(rows.shape[0], -1)[:, :width]


# ---- identification --------------------------------------------------------

_DIB_SIZES = (12, 40, 52, 56, 64, 108, 124)


def _i32be(b: bytes, o: int = 0) -> int:
    return struct.unpack(">I", b[o:o + 4])[0] if len(b) >= o + 4 else -1


def _i32le(b: bytes, o: int = 0) -> int:
    return struct.unpack("<I", b[o:o + 4])[0] if len(b) >= o + 4 else -1


def _i16le(b: bytes, o: int = 0) -> int:
    return struct.unpack("<H", b[o:o + 2])[0] if len(b) >= o + 2 else -1


# Pillow's openers after Image.init() that the port does not decode, each
# with its _accept test of the file's first 16 bytes (those whose _open can
# fail over to the next opener are tested by their headers, _OWN_TESTS)
_QUEUED = {
    "AVIF": lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
    "BLP": lambda p: p.startswith((b"BLP1", b"BLP2")),
    "EPS": lambda p: p.startswith(b"%!PS") or _i32le(p) == 0xC6D3D0C5,
    "FITS": lambda p: p.startswith(b"SIMPLE"),
    "FLI": lambda p: len(p) >= 16 and _i16le(p, 4) in (0xAF11, 0xAF12) and _i16le(p, 14) in (0, 3),
    "FTEX": lambda p: p.startswith(b"FTEX"),
    "JPEG2000": lambda p: p.startswith((b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
    "ICNS": lambda p: p.startswith(b"icns"),
    "MCIDAS": lambda p: p.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
    "MSP": lambda p: p.startswith((b"DanM", b"LinS")),
    "PIXAR": lambda p: p.startswith(b"\200\350\000\000"),
    "PSD": lambda p: p.startswith(b"8BPS"),
    "XBM": lambda p: p.lstrip().startswith(b"#define"),
    "XPM": lambda p: p.startswith(b"/* XPM */"),
    "XVTHUMB": lambda p: p.startswith(b"P7 332"),
}
# stubs: Pillow identifies them and has no decoder for them here
_STUBS = {
    "BUFR": lambda p: p.startswith((b"BUFR", b"ZCZC")),
    "GRIB": lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
    "HDF5": lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"),
}
# Image.ID after Image.init(), the preinit openers (BMP, DIB, GIF, JPEG,
# PPM, PNG; tried first) left out
_ID_ORDER = ("AVIF", "BLP", "BUFR", "CUR", "PCX", "DCX", "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR", "GRIB", "HDF5",
             "JPEG2000", "ICNS", "ICO", "IM", "IMT", "IPTC", "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD",
             "QOI", "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")


def identify(data: bytes) -> Optional[str]:
    """The opener Pillow would open the file with, tried in Pillow's
    order: the preinit plugins, then Image.ID, each by its _accept test and,
    where its _open can fail with the exceptions Image.open moves on from,
    by its header. Lower-case names are the kinds the port reads; upper-case
    ones Pillow opens and the port refuses."""
    p = data[:16]
    if p[:2] == b"BM":
        return "bmp"
    if _i32le(p) in _DIB_SIZES:
        return "dib"
    if p[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if p[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if _ppm_accept(data):
        return "ppm"
    if p[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    for name in _ID_ORDER:
        if name in _QUEUED:
            if _QUEUED[name](p):
                return name
        elif name in _STUBS:
            if _STUBS[name](p):
                return name
        elif name == "TIFF":
            if p[:4] in _TIFF_PREFIXES:
                return "tiff"
        elif name == "WEBP":
            if p[:4] == b"RIFF" and p[8:12] == b"WEBP":
                return "webp"
        elif _OWN_TESTS[name](data):
            return name if name in _HEADER_ONLY else name.lower()
    return None


# ---- netpbm ----------------------------------------------------------------

_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
              b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_WHITESPACE = b" \t\n\x0b\x0c\r"
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def _ppm_magic(data: bytes) -> Tuple[bytes, int]:
    """PpmImageFile._read_magic: up to six bytes, ended by whitespace
    (consumed); the magic and the position after it."""
    magic = b""
    pos = 0
    for _ in range(6):
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    return magic, pos


def _ppm_accept(data: bytes) -> bool:
    return len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy" and _ppm_magic(data)[0] in _PPM_MODES


def _ppm_token(data: bytes, pos: int, path) -> Tuple[bytes, int]:
    """PpmImageFile._read_token: whitespace skipped, a comment runs through
    its CR or LF (and joins the bytes around it), at most 10 bytes."""
    token = b""
    while len(token) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\r", b"\n"):
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        _refuse(path, "a netpbm header that ends early")
    if len(token) > 10:
        _refuse(path, f"a netpbm header token longer than 10 bytes ({token[:11]!r})")
    return token, pos


def _ppm_int(token: bytes, path) -> int:
    if not re.fullmatch(rb"[+-]?[0-9]+", token):
        _refuse(path, f"a netpbm header value {token!r} that is not an integer")
    return int(token)


def _ppm_layout(data: bytes, path) -> dict:
    magic, pos = _ppm_magic(data)
    if magic not in _PPM_MODES:
        raise NotImplementedError(f"{path}: netpbm magic {magic!r} (Pillow does not open it)")
    mode = _PPM_MODES[magic]
    tok, pos = _ppm_token(data, pos, path)
    width = _ppm_int(tok, path)
    tok, pos = _ppm_token(data, pos, path)
    height = _ppm_int(tok, path)
    if width <= 0 or height <= 0:
        raise NotImplementedError(f"{path}: a netpbm image of {width} x {height} pixels (Pillow does not open it)")
    layout = {"magic": magic, "width": width, "height": height, "mode": mode, "plain": magic in (b"P1", b"P2", b"P3"),
              "maxval": None, "scale": None}
    if mode == "F":
        tok, pos = _ppm_token(data, pos, path)
        try:
            scale = float(tok)
        except ValueError:
            _refuse(path, f"a PFM scale {tok!r} that is not a number")
        if scale == 0.0 or not math.isfinite(scale):
            _refuse(path, "a PFM scale of 0 or not finite")
        layout["scale"] = scale
    elif mode != "1":
        tok, pos = _ppm_token(data, pos, path)
        maxval = _ppm_int(tok, path)
        if not 0 < maxval < 65536:
            _refuse(path, f"a netpbm maxval of {maxval}")
        if maxval > 255 and mode == "L":
            layout["mode"] = "I"
        layout["maxval"] = maxval
    layout["offset"] = pos
    return layout


def ppm_size(data: bytes, path) -> Tuple[int, int]:
    layout = _ppm_layout(data, path)
    return layout["width"], layout["height"]


def decode_ppm(data: bytes, path) -> Tuple[np.ndarray, str]:
    layout = _ppm_layout(data, path)
    w, h, mode, off = layout["width"], layout["height"], layout["mode"], layout["offset"]
    bands = _BANDS[mode]
    shape = (h, w) if bands == 1 else (h, w, bands)
    if mode == "F":  # rows stored bottom-up
        e = "<" if layout["scale"] < 0 else ">"
        vals = _raw(data, off, 4 * w * h, path, "PFM").view(f"{e}f4").reshape(h, w)[::-1]
        return np.ascontiguousarray(vals.astype(np.float32)), mode
    top = 65535 if mode == "I" else 255
    if layout["plain"]:
        count = w * h * bands
        out = np.zeros(count, np.int32)
        src, n = _buf(data, off)
        _run("netpbm_plain_decode", "plain netpbm", path, src, n, int(mode == "1"), layout["maxval"] or 1, top,
             _ptr(out), count)
        if mode == "1":
            from nerfstudio_thermal_torch.data.image_formats import _bilevel

            return _bilevel(out.reshape(shape) != 0), mode
        return out.astype(np.int32 if mode == "I" else np.uint8).reshape(shape), mode
    if mode == "1":
        stride = (w + 7) // 8
        rows = _raw(data, off, stride * h, path, "P4").reshape(h, stride)
        return _bits(rows, w, inverted=True), mode
    maxval = layout["maxval"]
    if maxval == 255:
        return _raw(data, off, w * h * bands, path, "netpbm").reshape(shape).copy(), mode
    if maxval == 65535 and mode == "I":
        return _raw(data, off, 2 * w * h, path, "netpbm").view(">u2").reshape(shape).astype(np.int32), mode
    # Pillow's PpmDecoder: round(v / maxval * top) (half to even), at most top
    wide = maxval > 255
    raw = _raw(data, off, (1 + wide) * w * h * bands, path, "netpbm")
    vals = (raw.view(">u2") if wide else raw).astype(np.float64)
    scaled = np.minimum(np.rint(vals / maxval * top), top)
    return scaled.astype(np.int32 if mode == "I" else np.uint8).reshape(shape), mode


# ---- TGA -------------------------------------------------------------------

_TGA_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
            (2, 32): "BGRA"}


def _tga_header(data: bytes) -> Optional[dict]:
    """TgaImageFile._open's header, or None where it raises SyntaxError (so
    that Pillow tries the next opener)."""
    if len(data) < 18:
        return None
    id_len, cmap_type, image_type = data[0], data[1], data[2]
    width, height = _i16le(data, 12), _i16le(data, 14)
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or width <= 0 or height <= 0 or depth not in (1, 8, 16, 24, 32):
        return None
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        return None
    offset = 18 + id_len
    if cmap_type:
        map_len, map_depth = _i16le(data, 5), data[7]
        if map_depth not in (16, 24, 32):
            return None
        offset += map_len * map_depth // 8
    return {"width": width, "height": height, "mode": mode, "type": image_type, "depth": depth,
            "bottom_up": not flags & 0x20, "flip": bool(flags & 0x10), "offset": offset,
            "map_depth": data[7] if cmap_type else 0}


def tga_size(data: bytes, path) -> Tuple[int, int]:
    head = _tga_header(data)
    return head["width"], head["height"]


def _bgr15(vals: np.ndarray) -> np.ndarray:
    """BGRA;15Z 16-bit pixels -> RGBA: 5-bit channels * 255 // 31, alpha 0
    where the top bit is set."""
    v = vals.astype(np.int32)
    r, g, b = ((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31
    a = np.where(v & 0x8000, 0, 255)
    return np.stack([r, g, b, a], -1).astype(np.uint8)


def decode_tga(data: bytes, path) -> Tuple[np.ndarray, str]:
    head = _tga_header(data)
    w, h, mode, depth = head["width"], head["height"], head["mode"], head["depth"]
    key = (head["type"] & 7, depth)
    if key not in _TGA_RAW:
        _refuse(path, f"a TGA of image type {head['type']} at {depth} bits")
    rawmode = _TGA_RAW[key]
    if rawmode == "P" and mode == "L":
        _refuse(path, "a colour-mapped TGA without a colour map")
    if head["map_depth"] == 32:
        _refuse(path, "a TGA colour map of 32-bit entries")
    if head["map_depth"] and mode in ("1", "RGB", "RGBA"):
        _refuse(path, f"a colour map on a TGA of mode {mode}")
    row_bytes = (w * depth + 7) // 8
    if head["type"] & 8:
        if depth == 1:
            _refuse(path, "a 1-bit RLE TGA")
        buf = np.zeros(row_bytes * h, np.uint8)
        src, n = _buf(data, head["offset"])
        _run("tga_rle_decode", "TGA RLE", path, src, n, depth // 8, row_bytes, h, _ptr(buf))
        rows = buf.reshape(h, row_bytes)
    else:
        rows = _raw(data, head["offset"], row_bytes * h, path, "TGA").reshape(h, row_bytes)
    if rawmode == "1":
        arr = _bits(rows, w)
    elif rawmode in ("P", "L"):
        arr = rows
    elif rawmode == "LA":
        arr = rows.reshape(h, w, 2)
    elif rawmode == "BGRA;15Z":
        arr = _bgr15(rows.copy().view("<u2"))
    else:
        px = rows.reshape(h, w, depth // 8)
        arr = px[..., [2, 1, 0, 3]] if depth == 32 else px[..., ::-1]
    if head["bottom_up"]:
        arr = arr[::-1]
    if head["flip"]:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr), mode


# ---- QOI -------------------------------------------------------------------


def qoi_size(data: bytes, path) -> Tuple[int, int]:
    return _i32be(data, 4), _i32be(data, 8)


def decode_qoi(data: bytes, path) -> Tuple[np.ndarray, str]:
    if len(data) < 14:
        _refuse(path, "a truncated QOI header")
    w, h = qoi_size(data, path)
    channels = 3 if data[12] == 3 else 4
    out = np.zeros((h, w, channels), np.uint8)
    src, n = _buf(data, 14)
    _run("qoi_decode", "QOI", path, src, n, channels, w * h, _ptr(out))
    return out, "RGB" if channels == 3 else "RGBA"


# ---- SGI -------------------------------------------------------------------

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B", (1, 3, 3): "RGB",
              (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def _sgi_layout(data: bytes, path) -> dict:
    if len(data) < 512:
        _refuse(path, "a truncated SGI header")
    compression, bpc = data[2], data[3]
    dimension, w, h, z = struct.unpack(">4H", data[4:12])
    if (bpc, dimension, z) not in _SGI_MODES:
        _refuse(path, f"an SGI image of {bpc} bytes a sample, dimension {dimension}, {z} channels")
    if compression not in (0, 1):
        _refuse(path, f"SGI compression {compression}")
    return {"width": w, "height": h, "bpc": bpc, "channels": len(_SGI_MODES[(bpc, dimension, z)].split(";")[0]),
            "mode": _SGI_MODES[(bpc, dimension, z)].split(";")[0], "rle": compression == 1}


def sgi_size(data: bytes, path) -> Tuple[int, int]:
    layout = _sgi_layout(data, path)
    return layout["width"], layout["height"]


def decode_sgi(data: bytes, path) -> Tuple[np.ndarray, str]:
    layout = _sgi_layout(data, path)
    w, h, bpc, c = layout["width"], layout["height"], layout["bpc"], layout["channels"]
    if layout["rle"]:
        px = np.zeros((h, w, c, bpc), np.uint8)
        src, n = _buf(data)
        _run("sgi_rle_decode", "SGI RLE", path, src, n, bpc, w, h, c, _ptr(px))
        samples = px[..., 0]  # a 16-bit sample's high byte
    else:
        planes = _raw(data, 512, w * h * c * bpc, path, "SGI").reshape(c, h, w, bpc)
        samples = planes[..., 0].transpose(1, 2, 0)
    arr = samples[::-1]  # rows stored bottom-up
    return np.ascontiguousarray(arr[..., 0] if c == 1 else arr), layout["mode"]


# ---- PCX / DCX -------------------------------------------------------------


def _pcx_header(data: bytes, start: int) -> Optional[dict]:
    """PcxImageFile._open's header at `start`, or None where it raises
    SyntaxError."""
    s = data[start:start + 68]
    if len(s) < 68 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        return None
    x0, y0, x1, y1 = struct.unpack("<4H", s[4:12])
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        return None
    return {"version": s[1], "bits": s[3], "planes": s[65], "stride": _i16le(s, 66), "width": x1 + 1 - x0,
            "height": y1 + 1 - y0, "offset": start + 128}


def _pcx_layout(data: bytes, start: int, path) -> dict:
    head = _pcx_header(data, start)
    bits, planes, version = head["bits"], head["planes"], head["version"]
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
    elif version == 5 and bits == 8 and planes == 1:
        if len(data) < 769:  # Pillow seeks to 769 bytes before the end, and fails
            _refuse(path, "an 8-bit PCX shorter than a palette")
        mode = rawmode = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            if any(tail[i * 3 + 1:i * 3 + 4] != bytes([i]) * 3 for i in range(256)):
                mode = rawmode = "P"
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        _refuse(path, f"a PCX of {planes} planes of {bits} bits (version {version})")
    stride = (head["width"] * bits + 7) // 8
    if head["stride"] != stride:
        stride += stride % 2
    return {**head, "mode": mode, "rawmode": rawmode, "row_bytes": planes * stride,
            "unpack_bits": {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}[rawmode]}


def _dcx_page(data: bytes) -> int:
    return _i32le(data, 4)


def pcx_size(data: bytes, path) -> Tuple[int, int]:
    head = _pcx_header(data, 0)
    return head["width"], head["height"]


def dcx_size(data: bytes, path) -> Tuple[int, int]:
    head = _pcx_header(data, _dcx_page(data))
    return head["width"], head["height"]


def _decode_pcx_at(data: bytes, start: int, path) -> Tuple[np.ndarray, str]:
    layout = _pcx_layout(data, start, path)
    w, h, nbytes = layout["width"], layout["height"], layout["row_bytes"]
    if (w * layout["unpack_bits"] + 7) // 8 > nbytes:
        _refuse(path, "a PCX row longer than its stride")
    buf = np.zeros(nbytes * h, np.uint8)
    src, n = _buf(data, layout["offset"])
    _run("pcx_rle_decode", "PCX RLE", path, src, n, nbytes, h, _ptr(buf))
    rows = buf.reshape(h, nbytes)
    planes = rows.reshape(h, layout["planes"], nbytes // layout["planes"])  # one stride apart
    rawmode = layout["rawmode"]
    if rawmode == "1":
        arr = _bits(planes[:, 0], w)
    elif rawmode in ("L", "P"):
        arr = planes[:, 0, :w]
    elif rawmode == "RGB;L":
        # Pillow's decoder moves the planes to `w` bytes apart only where the row's bytes are no
        # multiple of `w`; its unpacker reads them `w` apart
        step = nbytes // (nbytes // w) if nbytes % w and nbytes > w else w
        arr = np.stack([rows[:, k * step:k * step + w] for k in range(3)], -1)
    else:  # P;2L / P;4L: bit planes one stride apart, plane k worth 2^k
        arr = sum((_bits(planes[:, k], w) != 0).astype(np.uint8) << k for k in range(planes.shape[1]))
    return np.ascontiguousarray(arr if rawmode == "1" else arr.astype(np.uint8)), layout["mode"]


def decode_pcx(data: bytes, path) -> Tuple[np.ndarray, str]:
    return _decode_pcx_at(data, 0, path)


def decode_dcx(data: bytes, path) -> Tuple[np.ndarray, str]:
    return _decode_pcx_at(data, _dcx_page(data), path)


# ---- ICO / CUR / DIB ----------------------------------------------------------


def _ico_entry(data: bytes, path) -> dict:
    """The entry IcoImageFile loads: sorted by colour depth, then (stably)
    by area, largest first."""
    entries = []
    for i in range(_i16le(data, 4)):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            _refuse(path, "a truncated ICO directory")
        w, h, colours = s[0] or 256, s[1] or 256, s[2]
        bpp = _i16le(s, 6)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append({"width": w, "height": h, "bpp": bpp, "size": _i32le(s, 8), "offset": _i32le(s, 12),
                        "depth": depth})
    if not entries:
        _refuse(path, "an ICO without entries")
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["width"] * e["height"], reverse=True)
    return entries[0]


def _cur_offset(data: bytes) -> Optional[int]:
    """CurImageFile._open's pick: the first entry, replaced by any later
    one larger in both its width and height bytes; the offset of its
    bitmap, or None where Pillow's pick fails (and Pillow tries the next
    opener)."""
    best = b""
    for i in range(max(_i16le(data, 4), 0)):
        s = data[6 + 16 * i:22 + 16 * i]
        if not best:
            best = s
        elif not s or (s[0] > best[0] and (len(s) < 2 or len(best) < 2)):
            return None  # Pillow's IndexError
        elif s[0] > best[0] and s[1] > best[1]:
            best = s
    return _i32le(best, 12) if len(best) >= 16 else None


def _is_png(data: bytes, offset: int) -> bool:
    return data[offset:offset + 8] == b"\x89PNG\r\n\x1a\n"


def _bitmap(data: bytes, start: int, path, raw_alpha: bool = False, halve: bool = True) -> Tuple[bytes, dict]:
    """The DIB at `start` and its layout, an icon's or cursor's height
    halved (the AND mask's rows follow the colour rows); what Pillow cannot
    read raises NotImplementedError."""
    from nerfstudio_thermal_torch.data import image_formats

    try:
        dib, layout = image_formats.dib_layout(data, start, path, raw_alpha)
    except (ValueError, struct.error) as e:
        _refuse(path, f"a truncated bitmap header ({e})")
    if halve:
        layout["height"] = int(layout["height"] / 2)
    return dib, layout


def _bitmap_pixels(dib: bytes, layout: dict, path) -> np.ndarray:
    from nerfstudio_thermal_torch.data import image_formats

    try:
        return image_formats.bmp_pixels(dib, layout, path)
    except ValueError as e:
        _refuse(path, str(e).split(": ", 1)[-1])


def _bitmap_opens(data: bytes, start: Optional[int], halve_first: bool) -> bool:
    """False where Pillow's BMP header reader, run on the DIB at `start`,
    fails in a way that makes Image.open try the next opener (a short read,
    a size of 0); True where it reads, or raises out of Image.open."""
    from nerfstudio_thermal_torch.data import image_formats

    if start is None or len(data) < start + 4:
        return False
    try:
        _, layout = image_formats.dib_layout(data, start, None)
    except struct.error:
        return False
    except (ValueError, NotImplementedError):
        return True
    height = int(layout["height"] / 2) if halve_first else layout["height"]
    return layout["width"] > 0 and height > 0


def _ico_opens(data: bytes) -> bool:
    if data[:4] != b"\0\0\1\0" or _i16le(data, 4) <= 0 or len(data) < 6 + 16 * _i16le(data, 4):
        return False
    start = _ico_entry(data, None)["offset"]
    return _is_png(data, start) or _bitmap_opens(data, start, halve_first=False)


def ico_size(data: bytes, path) -> Tuple[int, int]:
    entry = _ico_entry(data, path)
    if _is_png(data, entry["offset"]):
        from nerfstudio_thermal_torch.data.datasets import png_bytes_size

        return png_bytes_size(data[entry["offset"]:])
    layout = _bitmap(data, entry["offset"], path)[1]
    return layout["width"], layout["height"]


def _to_rgba(arr: np.ndarray, mode: str, layout: dict) -> np.ndarray:
    """Image.convert("RGBA") of a decoded bitmap."""
    if mode == "RGBA":
        return arr
    if mode in ("1", "L"):
        grey = arr.astype(np.uint8) * np.uint8(255) if mode == "1" else arr
        rgb = np.repeat(grey[..., None], 3, -1)
    elif mode == "P":
        pal = np.frombuffer(layout["palette"], np.uint8)
        pal = pal[:len(pal) // layout["padding"] * layout["padding"]].reshape(-1, layout["padding"])[:, 2::-1]
        table = np.zeros((256, 3), np.uint8)
        table[:min(256, len(pal))] = pal[:256]
        rgb = table[arr]
    else:
        rgb = arr
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)


def decode_ico(data: bytes, path) -> Tuple[np.ndarray, str]:
    entry = _ico_entry(data, path)
    start = entry["offset"]
    if _is_png(data, start):
        from nerfstudio_thermal_torch.data.datasets import decode_png_bytes

        return decode_png_bytes(data[start:], path)
    dib, layout = _bitmap(data, start, path)
    arr = _bitmap_pixels(dib, layout, path)
    w, h = layout["width"], layout["height"]
    if entry["bpp"] == 32:  # the colour rows' fourth bytes, bottom-up
        alpha = _raw(dib, layout["offset"], w * h * 4, path, "ICO alpha")[3::4].reshape(h, w)[::-1]
    else:  # the AND mask, rows padded to 32 bits, bottom-up; a clear bit is opaque
        w32 = w + (32 - w % 32) % 32
        total = w32 * h // 8
        mask = _raw(data, start + entry["size"] - total, total, path, "ICO mask").reshape(h, w32 // 8)
        alpha = np.where(_bits(mask, w, inverted=True)[::-1], 255, 0).astype(np.uint8)
    rgba = _to_rgba(arr, layout["mode"], layout).copy()
    rgba[..., 3] = alpha
    return rgba, "RGBA"


def _cur_bitmap(data: bytes, path) -> Tuple[bytes, dict]:
    start = _cur_offset(data)
    return _bitmap(data, start, path, raw_alpha=start == 22)


def cur_size(data: bytes, path) -> Tuple[int, int]:
    layout = _cur_bitmap(data, path)[1]
    return layout["width"], layout["height"]


def decode_cur(data: bytes, path) -> Tuple[np.ndarray, str]:
    dib, layout = _cur_bitmap(data, path)
    return _bitmap_pixels(dib, layout, path), layout["mode"]


def dib_size(data: bytes, path) -> Tuple[int, int]:
    layout = _bitmap(data, 0, path, halve=False)[1]
    return layout["width"], layout["height"]


def decode_dib(data: bytes, path) -> Tuple[np.ndarray, str]:
    dib, layout = _bitmap(data, 0, path, halve=False)
    return _bitmap_pixels(dib, layout, path), layout["mode"]


# ---- DDS -------------------------------------------------------------------

_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PAL8, _DDPF_RGB, _DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FourCC -> (mode, BCn, signed)
_DDS_FOURCC = {b"DXT1": ("RGBA", 1, 0), b"DXT3": ("RGBA", 2, 0), b"DXT5": ("RGBA", 3, 0), b"BC4U": ("L", 4, 0),
               b"ATI1": ("L", 4, 0), b"BC5S": ("RGB", 5, 1), b"BC5U": ("RGB", 5, 0), b"ATI2": ("RGB", 5, 0)}
# DXGI format -> (mode, BCn (0: raw RGBA), signed)
_DXGI = {70: ("RGBA", 1, 0), 71: ("RGBA", 1, 0), 73: ("RGBA", 2, 0), 74: ("RGBA", 2, 0), 76: ("RGBA", 3, 0),
         77: ("RGBA", 3, 0), 79: ("L", 4, 0), 80: ("L", 4, 0), 82: ("RGB", 5, 0), 83: ("RGB", 5, 0),
         84: ("RGB", 5, 1), 95: ("RGB", 6, 0), 96: ("RGB", 6, 1), 97: ("RGBA", 7, 0), 98: ("RGBA", 7, 0),
         99: ("RGBA", 7, 0), 27: ("RGBA", 0, 0), 28: ("RGBA", 0, 0), 29: ("RGBA", 0, 0)}


def _dds_layout(data: bytes, path) -> dict:
    if len(data) < 128:
        _refuse(path, "a truncated DDS header")
    if _i32le(data, 4) != 124:
        _refuse(path, f"a DDS header of {_i32le(data, 4)} bytes")
    height, width = _i32le(data, 12), _i32le(data, 16)
    pfflags, fourcc, bitcount = _i32le(data, 80), data[84:88], _i32le(data, 88)
    layout = {"width": width, "height": height, "offset": 128, "bcn": 0, "sign": 0, "masks": None}
    if pfflags & _DDPF_RGB:
        count = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        layout.update(mode="RGBA" if count == 4 else "RGB", masks=struct.unpack(f"<{count}I", data[92:92 + 4 * count]),
                      bitcount=bitcount)
    elif pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            layout["mode"] = "L"
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            layout["mode"] = "LA"
        else:
            _refuse(path, f"a {bitcount}-bit luminance DDS")
    elif pfflags & _DDPF_PAL8:
        layout.update(mode="P", offset=128 + 1024)
    elif pfflags & _DDPF_FOURCC:
        if fourcc == b"DX10":
            fmt = _i32le(data, 128)
            if fmt not in _DXGI:
                _refuse(path, f"a DDS of DXGI format {fmt}")
            mode, bcn, sign = _DXGI[fmt]
            layout["offset"] = 148
        elif fourcc in _DDS_FOURCC:
            mode, bcn, sign = _DDS_FOURCC[fourcc]
        else:
            _refuse(path, f"a DDS of pixel format {fourcc!r}")
        layout.update(mode=mode, bcn=bcn, sign=sign)
    else:
        _refuse(path, f"a DDS of pixel format flags {pfflags:#x}")
    return layout


def dds_size(data: bytes, path) -> Tuple[int, int]:
    layout = _dds_layout(data, path)
    return layout["width"], layout["height"]


def decode_dds(data: bytes, path) -> Tuple[np.ndarray, str]:
    layout = _dds_layout(data, path)
    w, h, mode, off = layout["width"], layout["height"], layout["mode"], layout["offset"]
    bands = {"L": 1, "LA": 2, "P": 1, "RGB": 3, "RGBA": 4}[mode]
    shape = (h, w) if bands == 1 else (h, w, bands)
    if layout["bcn"]:
        out = np.zeros(shape, np.uint8)
        src, n = _buf(data, off)
        _run("bcn_decode", f"DDS BC{layout['bcn']}", path, src, n, layout["bcn"], layout["sign"], w, h, _ptr(out))
        return out, mode
    if layout["masks"] is not None:
        # Pillow's DdsRgbDecoder: each masked value shifted down, divided by
        # the mask's maximum, times 255, truncated; a short file reads zeros
        nbytes = layout["bitcount"] // 8
        raw = np.frombuffer(data, np.uint8)[off:off + nbytes * w * h]
        raw = np.concatenate([raw, np.zeros(nbytes * w * h - raw.size, np.uint8)]).reshape(-1, nbytes)
        value = np.zeros(w * h, np.uint64)
        for k in range(nbytes):
            value |= raw[:, k].astype(np.uint64) << np.uint64(8 * k)
        chans = []
        for mask in layout["masks"]:
            shift = 0
            if mask:
                while (mask >> (shift + 1)) << (shift + 1) == mask:
                    shift += 1
            total = mask >> shift
            if not total:
                chans.append(np.zeros(w * h, np.uint8))
                continue
            v = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
            chans.append((v / total * 255).astype(np.uint8))
        return np.stack(chans, -1).reshape(shape), mode
    return _raw(data, off, w * h * bands, path, "DDS").reshape(shape).copy(), mode


# ---- IM --------------------------------------------------------------------

_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
    "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _IM_OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name",
            "Scale (x,y)", "Image size (x*y)", "Image type")
_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# the raw modes read here: bits a pixel, dtype, channels line-interleaved
_IM_SAMPLES = {"F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4",
               "I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32S": "<i4", "I;32": "<i4"}
_IM_LINES = {"RGB;L": 3, "LA;L": 2, "PA;L": 2, "RGBA;L": 4, "RGBX;L": 4, "CMYK;L": 4, "YCbCr;L": 3}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _im_header(data: bytes) -> Optional[dict]:
    """ImImageFile._open's header, or None where it raises SyntaxError."""
    if b"\n" not in data[:100]:
        return None
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode = "L"
    known = 0
    pos = 0
    while True:
        c = data[pos:pos + 1]
        pos += 1
        if c == b"\r":
            continue
        if not c or c in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s = c + data[pos:end]
        pos = end
        if len(s) > 100:
            return None
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            return None
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError:
                return {"error": f"an IM header value {v!r}"}
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        known += k in _IM_TAGS
    if not known:
        return None
    while c and not c.startswith(b"\x1a"):
        c = data[pos:pos + 1]
        pos += 1
    if not c:
        return None
    size = info["Image size (x*y)"]
    if not (isinstance(size, tuple) and len(size) == 2 and all(isinstance(x, int) and x > 0 for x in size)):
        return None
    return {"size": size, "mode": info["Image type"], "rawmode": rawmode, "lut": "Lut" in info, "offset": pos}


def im_size(data: bytes, path) -> Tuple[int, int]:
    return _im_header(data)["size"]


def decode_im(data: bytes, path) -> Tuple[np.ndarray, str]:
    head = _im_header(data)
    if "error" in head:
        _refuse(path, head["error"])
    (w, h), mode, rawmode, off = head["size"], head["mode"], head["rawmode"], head["offset"]
    if head["lut"]:  # a palette; a grey or RGB image's lookup table Pillow keeps but does not apply
        pal = np.frombuffer(data, np.uint8, 768, off) if off + 768 <= len(data) else None
        if pal is None:
            _refuse(path, "a truncated IM palette")
        off += 768
        grey = np.array_equal(pal[:256], pal[256:512]) and np.array_equal(pal[:256], pal[512:])
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
    if rawmode == "PA;L" and mode == "LA":
        _refuse(path, "an IM image of type PA without a palette")
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
        out = np.zeros((h, w), np.float32)
        src, n = _buf(data, off)
        _run("bit_decode", f"{rawmode[2:]}-bit IM", path, src, n, int(rawmode[2:]), w, h, _ptr(out))
        return np.ascontiguousarray(out[::-1]), mode
    if rawmode in ("RGB;T", "RYB;T"):  # three planes: green, red, blue
        g, r, b = _raw(data, off, 3 * w * h, path, "IM").reshape(3, h, w)
        return np.ascontiguousarray(np.stack([r, g, b], -1)[::-1]), mode
    if rawmode in ("1", "P;2", "P;4", "L", "P", "RGB"):
        bits = {"1": 1, "P;2": 2, "P;4": 4, "RGB": 24}.get(rawmode, 8)
        stride = (w * bits + 7) // 8
        rows = _raw(data, off, stride * h, path, "IM").reshape(h, stride)
        if rawmode == "1":
            arr = _bits(rows, w)
        elif rawmode == "P;4":
            arr = _unpack4(rows, w)
        elif rawmode == "P;2":
            arr = np.stack([(rows >> s) & 3 for s in (6, 4, 2, 0)], -1).reshape(h, -1)[:, :w]
        elif rawmode == "RGB":
            arr = rows.reshape(h, w, 3)
        else:
            arr = rows[:, :w]
    elif rawmode in _IM_SAMPLES:
        dt = np.dtype(_IM_SAMPLES[rawmode])
        vals = _raw(data, off, dt.itemsize * w * h, path, "IM").view(dt).reshape(h, w)
        if mode == "F":
            arr = vals.astype(np.float32)
        elif mode == "I":
            arr = vals.astype(np.int32)
        else:  # I;16 / I;16L / I;16B keep their bytes
            arr = vals.copy()
    elif rawmode in _IM_LINES:
        n = _IM_LINES[rawmode]
        arr = _raw(data, off, n * w * h, path, "IM").reshape(h, n, w).transpose(0, 2, 1)
        if rawmode == "RGBX;L":
            arr = arr[..., :3]
    else:
        raise NotImplementedError(f"{path}: IM raw mode {rawmode} is not supported")
    return np.ascontiguousarray(arr[::-1]), mode  # rows stored bottom-up


# ---- Sun raster ------------------------------------------------------------


def _sun_header(data: bytes) -> Optional[dict]:
    """SunImageFile._open's header, or None where it raises SyntaxError."""
    if len(data) < 32 or _i32be(data) != 0x59A66A95:
        return None
    w, h, depth, _, file_type, pal_type, pal_len = struct.unpack(">7I", data[4:32])
    modes = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"), 24: ("RGB", "RGB" if file_type == 3 else "BGR"),
             32: ("RGB", "RGBX" if file_type == 3 else "BGRX")}
    if depth not in modes:
        return None
    mode, rawmode = modes[depth]
    if pal_len:
        if pal_len > 1024 or pal_type != 1:
            return None
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
        else:
            mode = "?"  # Pillow gives a 1-bit or RGB image a palette, and fails on it
    if file_type not in (0, 1, 2, 3, 4, 5):
        return None
    return {"width": w, "height": h, "depth": depth, "mode": mode, "rawmode": rawmode, "rle": file_type == 2,
            "offset": 32 + pal_len}


def sun_size(data: bytes, path) -> Tuple[int, int]:
    head = _sun_header(data)
    return head["width"], head["height"]


def decode_sun(data: bytes, path) -> Tuple[np.ndarray, str]:
    head = _sun_header(data)
    w, h, depth, rawmode = head["width"], head["height"], head["depth"], head["rawmode"]
    if head["mode"] == "?":
        _refuse(path, f"a {depth}-bit Sun raster with a colour map")
    if head["rle"]:  # Pillow's RLE rows are not padded to 16 bits
        stride = (w * depth + 7) // 8
        buf = np.zeros(stride * h, np.uint8)
        src, n = _buf(data, head["offset"])
        _run("sun_rle_decode", "Sun RLE", path, src, n, stride, h, _ptr(buf))
        rows = buf.reshape(h, stride)
    else:  # rows padded to 16 bits; the last row needs no padding
        stride, used = (w * depth + 15) // 16 * 2, (w * depth + 7) // 8
        need = stride * (h - 1) + used
        raw = _raw(data, head["offset"], need, path, "Sun raster")
        rows = np.concatenate([raw, np.zeros(stride - used, np.uint8)]).reshape(h, stride)
    if rawmode == "1;I":
        arr = _bits(rows, w, inverted=True)
    elif rawmode == "L;4":
        arr = _unpack4(rows, w) * np.uint8(17)
    elif rawmode == "P;4":
        arr = _unpack4(rows, w)
    elif depth == 8:
        arr = rows[:, :w]
    else:
        px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)
        arr = px[..., :3] if rawmode.startswith("RGB") else px[..., 2::-1]
    return np.ascontiguousarray(arr), head["mode"]


# ---- the header tests of the openers without an _accept ---------------------


def _imt_header(data: bytes) -> bool:
    """ImtImageFile._open: a text header of "width" / "height" / "pixel n8"
    lines ended by a form feed, which sets a size and a mode."""
    if b"\n" not in data[:100]:
        return False
    size, mode, pos = [0, 0], None, 0
    while pos < len(data):
        c = data[pos:pos + 1]
        pos += 1
        if c == b"\x0c":
            return mode is not None and size[0] > 0 and size[1] > 0
        end = data.find(b"\n", pos)
        line = c + (data[pos:] if end < 0 else data[pos:end])
        pos = len(data) if end < 0 else end + 1
        if len(line) == 1 or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = re.match(rb"([a-z]*) ([^ \r\n]*)", line)
        if not m:
            break
        k, v = m.group(1, 2)
        if k in (b"width", b"height"):
            try:
                size[k == b"height"] = int(v)
            except ValueError:
                return True  # Pillow raises from int(): refused either way
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return mode is not None and size[0] > 0 and size[1] > 0


def _iptc_header(data: bytes) -> bool:
    """IptcImageFile._open's field loop; True where it gets past it (Pillow
    then reads the fields, or raises)."""
    pos = 0
    while True:
        s = data[pos:pos + 5]
        if not s.strip(b"\x00"):
            return True
        if len(s) < 5 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False
        if (s[1], s[2]) == (8, 10):
            return True
        size = s[3]
        pos += 5
        if size > 132:
            return True
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes(data[pos:pos + size - 128], "big")
            pos += s[3] - 128
        else:
            size = struct.unpack(">H", s[3:5])[0]
        pos += size


def _mpeg_header(data: bytes) -> bool:
    """MpegImageFile._open: the sequence header's 12-bit width and height,
    both above 0."""
    if data[:4] != b"\x00\x00\x01\xb3" or len(data) < 7:
        return False
    return (data[4] << 4 | data[5] >> 4) > 0 and ((data[5] & 15) << 8 | data[6]) > 0


def _wmf_header(data: bytes) -> bool:
    """WmfStubImageFile._open: a placeable metafile with a standard header,
    or an enhanced one, of a size above 0 (a zero unit or frame makes
    Pillow raise, which refuses the file as well)."""
    s = data[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        if len(s) < 16:
            return False
        x0, y0, x1, y1, inch = struct.unpack("<hhhhH", s[6:16])
        if inch == 0:
            return True
        if s[22:26] != b"\x01\x00\t\x00":
            return False
        size = ((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch)
    elif s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack("<8i", s[8:40])
        if f2 == f0 or f3 == f1:
            return True
        size = (x1 - x0, y1 - y0)
    else:
        return False
    return size[0] > 0 and size[1] > 0


def _gbr_header(data: bytes) -> bool:
    """GbrImageFile._open's header tests (its _accept takes most files whose
    first words are a size of 20 or more and 1 or 2)."""
    if len(data) < 20:
        return False
    size, version, width, height, depth = struct.unpack(">5I", data[:20])
    if size < 20 or version not in (1, 2) or width == 0 or height == 0 or depth not in (1, 4):
        return False
    return version == 1 or data[20:24] == b"GIMP"


def _spider_header(data: bytes) -> bool:
    """SpiderImageFile._open: 27 floats (big-endian, else little-endian)
    that look like a 2-D Spider header."""
    if len(data) < 108:
        return False
    for e in ">", "<":
        h = (99,) + struct.unpack(f"{e}27f", data[:108])
        try:
            if not all(math.isfinite(h[i]) and h[i] == int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
                continue
        except (ValueError, OverflowError):
            continue
        if int(h[5]) not in (1, 3, -11, -12, -21, -22) or int(h[22]) != int(h[13]) * int(h[23]):
            continue
        if int(h[22]) == 0:
            continue
        return int(h[5]) == 1
    return False


_OWN_TESTS = {
    "CUR": lambda d: d[:4] == b"\0\0\2\0" and _bitmap_opens(d, _cur_offset(d), halve_first=True),
    "PCX": lambda d: _pcx_header(d, 0) is not None,
    "DCX": lambda d: _i32le(d) == 0x3ADE68B1 and _pcx_header(d, max(_dcx_page(d), 0)) is not None,
    "DDS": lambda d: d[:4] == b"DDS " and len(d) >= 8,  # shorter: Pillow's struct.error
    "GBR": _gbr_header,
    "MPEG": _mpeg_header,
    "WMF": _wmf_header,
    "ICO": _ico_opens,
    "IM": lambda d: _im_header(d) is not None,
    "IMT": _imt_header,
    "IPTC": _iptc_header,
    "PCD": lambda d: d[2048:2052] == b"PCD_",
    "QOI": lambda d: d[:4] == b"qoif" and len(d) >= 13,
    "SGI": lambda d: len(d) >= 12 and struct.unpack(">H", d[:2])[0] == 474,
    "SPIDER": _spider_header,
    "SUN": lambda d: _sun_header(d) is not None,
    "TGA": lambda d: _tga_header(d) is not None,
}

# the openers tested by their headers that the port does not decode
_HEADER_ONLY = ("GBR", "IMT", "IPTC", "MPEG", "PCD", "SPIDER", "WMF")
# Pillow's openers that the port refuses, and why
REFUSED = {**{k: "queued, not yet ported" for k in (*_QUEUED, "GBR", "IMT", "IPTC", "PCD", "SPIDER")},
           **{k: "Pillow has no decoder for it here either" for k in (*_STUBS, "MPEG", "WMF")},
           "EPS": "Pillow needs Ghostscript to load it"}
