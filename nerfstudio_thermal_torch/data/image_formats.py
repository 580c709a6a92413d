"""TIFF, BMP and GIF decoding as Pillow decodes them (Pillow is not on the
card's machine): each decoder returns what `np.asarray(Image.open(path))`
gives, with Pillow's mode, so that resizing can follow Pillow's rules.

- TIFF, first page: II and MM byte order, classic and (little-endian)
  BigTIFF, strips and tiles; compression none, PackBits, LZW, Deflate (8
  and 32946), LZMA (the standard library) and Zstandard with predictor 2,
  and 3 for floats; JPEG (7: each strip's abbreviated stream behind the
  JPEGTables stream, through data/jpeg.py, YCbCr converted to RGB as
  libtiff asks libjpeg to, other photometrics taken as they are); CCITT
  modified Huffman, T.4 (1-D and 2-D) and T.6 bilevel rows; old-style
  JPEG (6) and YCbCr data units of the other codecs as libtiff's RGBA
  reader gives them (the chroma replicated, libtiff's YCbCr -> RGB
  tables); planar configuration 1 and 2 (Pillow reads an uncompressed
  planar file plane by plane, each with one 8-bit or float letter of the
  raw mode, whatever its bits); WhiteIsZero, BlackIsZero, RGB, palette,
  CMYK and CIELAB; 1-, 2-, 4-, 8-, 12- and 16-bit samples, 32-bit int and
  float samples, extra alpha samples (premultiplied 16-bit too); every
  orientation, applied as Pillow's exif_transpose. The mode comes from a
  copy of Pillow's table of (byte order, photometric, sample format, fill
  order, bits, extra samples). Pillow decodes uncompressed files itself
  and compressed ones through libtiff, which hands over samples in the
  host's byte order: a compressed big-endian file of 32-bit or signed
  16-bit samples is therefore read with its bytes swapped, and so it is
  here.
- BMP: core, INFO, V2-V5 headers; 1, 4, 8, 16, 24 and 32 bits per pixel;
  BI_RGB, RLE8, RLE4 and the BITFIELDS layouts Pillow accepts; bottom-up
  and top-down rows; palettes that are a grey ramp give mode "L" (or
  "1" for black and white; a 4-bit file's rows read as 8-bit samples, as
  Pillow reads them), others "P".
- GIF: the first frame (LZW, interlaced or not, global or local palette),
  as indices (mode "P", or "L" where the palette is the identity ramp),
  on a canvas grown to the frame's extent, filled with the transparent
  index where the frame has one. An identity local palette under another
  global one gives Pillow's mode "L" over a palette image, which Pillow
  refuses to resize: its mode here is "L:P".

The byte loops (LZW, PackBits, Zstandard, CCITT, the BMP RLE decoder) are host C++
(native/image_codecs.cpp), built with g++ like the JPEG decoder; when it
cannot be built, decoding raises (there is no other decoder). A variant
Pillow reads and these decoders do not raises NotImplementedError naming
it; so does one Pillow refuses.
"""

import ctypes
import functools
import lzma
import struct
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from nerfstudio_thermal_torch.data.native_build import NATIVE_DIR, build_library

SOURCE = NATIVE_DIR / "image_codecs.cpp"
_lib = None


def load_library():
    """The codec library, built at first use; raises when it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(str(build_library(SOURCE, "libimage_codecs")))
        except Exception as e:
            raise RuntimeError(f"the image codecs ({SOURCE.name}) could not be built or loaded: {e}") from e
        if lib.image_codecs_abi_version() != 2:
            raise RuntimeError("the image codec library has an unexpected ABI version")
        size_p = ctypes.POINTER(ctypes.c_size_t)
        for name in ("tiff_lzw_decode", "packbits_decode", "zstd_decode"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, size_p]
        lib.bmp_rle_decode.restype = ctypes.c_int
        lib.bmp_rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, size_p]
        lib.gif_lzw_decode.restype = ctypes.c_int
        lib.gif_lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, *([ctypes.c_int] * 7), ctypes.c_void_p]
        lib.ccitt_decode.restype = ctypes.c_int
        lib.ccitt_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, *([ctypes.c_int] * 4), ctypes.c_void_p,
                                     ctypes.c_size_t, size_p]
        _lib = lib
    return _lib


def _check(rc: int, what: str, path) -> None:
    if rc == 1:
        raise NotImplementedError(f"{path}: {what} is not supported")
    if rc != 0:
        raise ValueError(f"{path}: corrupt {what} data")


def _bilevel(on: np.ndarray) -> np.ndarray:
    """Pillow's array of a mode "1" image: bool, its true bytes 255 (the
    mode stores 0 / 255 and NumPy reads them as bool)."""
    return np.ascontiguousarray(on.astype(np.uint8) * np.uint8(255)).view(np.bool_)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _byte_codec(name: str, raw: bytes, size: int, path) -> np.ndarray:
    out = np.zeros(size, np.uint8)
    written = ctypes.c_size_t(0)
    _check(getattr(load_library(), name)(raw, len(raw), _ptr(out), size, ctypes.byref(written)),
           name.split("_decode")[0].replace("_", " "), path)
    if written.value < size:
        raise ValueError(f"{path}: {name.split('_')[0]} data ends {size - written.value} bytes short")
    return out


# ---- TIFF ------------------------------------------------------------------

II, MM = b"II", b"MM"
# Pillow's TiffImagePlugin.OPEN_INFO, the entries of the photometric
# interpretations read here: (byte order, photometric, sample format, fill
# order, bits per sample, extra samples) -> (mode, raw mode)
_OPEN_INFO: Dict[tuple, Tuple[str, str]] = {}
for _bo in (II, MM):
    for _fill, _r in ((1, ""), (2, "R")):
        _OPEN_INFO.update({
            (_bo, 0, (1,), _fill, (1,), ()): ("1", "1;I" + _r),
            (_bo, 1, (1,), _fill, (1,), ()): ("1", "1" + (";R" if _r else "")),
            (_bo, 0, (1,), _fill, (2,), ()): ("L", "L;2I" + _r),
            (_bo, 1, (1,), _fill, (2,), ()): ("L", "L;2" + _r),
            (_bo, 0, (1,), _fill, (4,), ()): ("L", "L;4I" + _r),
            (_bo, 1, (1,), _fill, (4,), ()): ("L", "L;4" + _r),
            (_bo, 0, (1,), _fill, (8,), ()): ("L", "L;I" + _r),
            (_bo, 1, (1,), _fill, (8,), ()): ("L", "L" + (";R" if _r else "")),
            (_bo, 2, (1,), _fill, (8, 8, 8), ()): ("RGB", "RGB" + (";R" if _r else "")),
            (_bo, 3, (1,), _fill, (1,), ()): ("P", "P;1" + _r),
            (_bo, 3, (1,), _fill, (2,), ()): ("P", "P;2" + _r),
            (_bo, 3, (1,), _fill, (4,), ()): ("P", "P;4" + _r),
        })
    _OPEN_INFO.update({
        (_bo, 1, (2,), 1, (8,), ()): ("L", "L"),
        (_bo, 1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
        (_bo, 3, (1,), 1, (8,), ()): ("P", "P"),
        (_bo, 3, (1,), 2, (8,), ()): ("P", "P;R"),
        (_bo, 3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
        (_bo, 3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
        (_bo, 5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
        (_bo, 5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
        (_bo, 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
        (_bo, 6, (1,), 1, (8,), ()): ("L", "L"),
        (_bo, 6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
        (_bo, 8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
    })
    _e = "L" if _bo == II else "B"
    _OPEN_INFO.update({
        (_bo, 2, (1,), 1, (16, 16, 16), ()): ("RGB", f"RGB;16{_e}"),
        (_bo, 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", f"RGBA;16{_e}"),
        (_bo, 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", f"RGBX;16{_e}"),
        (_bo, 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", f"RGBa;16{_e}"),
        (_bo, 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", f"RGBA;16{_e}"),
        (_bo, 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", f"CMYK;16{_e}"),
        (_bo, 0, (3,), 1, (32,), ()): ("F", "F;32BF" if _bo == MM else "F;32F"),
        (_bo, 1, (3,), 1, (32,), ()): ("F", "F;32BF" if _bo == MM else "F;32F"),
        (_bo, 1, (2,), 1, (16,), ()): ("I", "I;16BS" if _bo == MM else "I;16S"),
        (_bo, 1, (2,), 1, (32,), ()): ("I", "I;32BS" if _bo == MM else "I;32S"),
    })
_OPEN_INFO.update({
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
})
# the one-letter raw modes with which Pillow reads the planes of an
# uncompressed planar file, and their bits per sample
_PLANE_BITS = {"1": 1, "L": 8, "P": 8, "R": 8, "G": 8, "B": 8, "A": 8, "X": 8, "F": 32}
_BYTE_CODECS = {5: "LZW", 32773: "PackBits", 8: "Deflate", 32946: "Deflate", 34925: "LZMA", 50000: "Zstandard"}
_CCITT = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4"}
_COMPRESSIONS = {1: "none", 6: "old-style JPEG", 7: "JPEG", **_BYTE_CODECS, **_CCITT}
_COMPRESSION_NAMES = {34712: "JPEG 2000", 50001: "WebP"}
# libtiff runs the horizontal and floating-point predictors with these codecs
_PREDICTED = (5, 8, 32946, 34925, 50000)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
          13: "I", 16: "Q", 17: "q", 18: "Q"}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _tiff_tags(data: bytes, path) -> Tuple[bytes, Dict[int, tuple]]:
    """The first IFD's tags, of a classic TIFF (4-byte offsets, 12-byte
    entries) or a BigTIFF (8-byte offsets, 20-byte entries)."""
    order = data[:2]
    e = "<" if order == II else ">"
    big = data[2:4] in (b"\x00\x2b", b"\x2b\x00")
    if big and order == MM:
        raise NotImplementedError(f"{path}: a big-endian BigTIFF (Pillow refuses it too)")
    if big:
        if struct.unpack(e + "HH", data[4:8]) != (8, 0):
            raise ValueError(f"{path}: a BigTIFF header with offsets of another size")
        off, word, head, entry = struct.unpack(e + "Q", data[8:16])[0], "Q", "Q", 20
    else:
        if struct.unpack(e + "H", data[2:4])[0] != 42:
            raise NotImplementedError(f"{path}: a TIFF header with a wrong magic number is not supported")
        off, word, head, entry = struct.unpack(e + "I", data[4:8])[0], "I", "H", 12
    hsize, wsize = struct.calcsize(head), struct.calcsize(word)
    if off + hsize > len(data):
        raise ValueError(f"{path}: TIFF IFD offset out of the file")
    (count,) = struct.unpack(e + head, data[off:off + hsize])
    tags = {}
    for i in range(count):
        p = off + hsize + entry * i
        tag, typ, n = struct.unpack(e + "HH" + word, data[p:p + 4 + wsize])
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(e + fmt) * n
        value = p + 4 + wsize
        if size <= wsize:
            raw = data[value:value + size]
        else:
            (voff,) = struct.unpack(e + word, data[value:value + wsize])
            raw = data[voff:voff + size]
        if len(raw) < size:
            raise ValueError(f"{path}: TIFF tag {tag} out of the file")
        values = struct.unpack(e + fmt * n, raw)
        if typ in (5, 10):  # rationals, as libtiff reads them
            values = tuple(a / b if b else 0.0 for a, b in zip(values[0::2], values[1::2]))
        tags[tag] = values
    return order, tags


def _first(tags, tag, default):
    return tags[tag][0] if tag in tags else default


def _tiff_layout(data: bytes, path) -> dict:
    """The first IFD, resolved as Pillow resolves it: size, mode, raw mode
    and how the samples are stored."""
    order, tags = _tiff_tags(data, path)
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{path}: TIFF without its dimensions")
    width, height = _first(tags, 256, 0), _first(tags, 257, 0)
    compression = _first(tags, 259, 1)
    # Pillow takes an old-style JPEG file for YCbCr, whatever it says
    photo = 6 if compression == 6 else _first(tags, 262, 0)
    fill = _first(tags, 266, 1)
    planar = _first(tags, 284, 1)
    sample_format = tags.get(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    spp = _first(tags, 277, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{path}: TIFF samples and bits per sample disagree")
    if compression in _COMPRESSION_NAMES:
        raise NotImplementedError(f"{path}: {_COMPRESSION_NAMES[compression]} TIFF is not supported")
    if compression not in _COMPRESSIONS:
        raise NotImplementedError(f"{path}: TIFF compression {compression} is not supported")
    key = (order, photo, tuple(sample_format), fill, tuple(bps), tuple(extra))
    if key not in _OPEN_INFO:
        raise NotImplementedError(f"{path}: TIFF of {key[1:]} (photometric, sample format, fill order, bits, "
                                  "extra samples) is not a mode Pillow reads")
    mode, rawmode = _OPEN_INFO[key]
    if fill == 2:  # libtiff and Pillow's ";R" raw modes both reverse the stored bits
        rawmode = _OPEN_INFO[key[:3] + (1,) + key[4:]][1]
    if photo == 6 and (compression == 1 or planar != 1 or spp != 3):
        # Pillow reads an uncompressed one itself and fails ("image file is truncated")
        raise NotImplementedError(f"{path}: an uncompressed or planar YCbCr TIFF (Pillow refuses it too)")
    if compression == 6 and not (513 in tags and 514 in tags):
        raise NotImplementedError(f"{path}: an old-style JPEG TIFF without JPEGInterchangeFormat is not supported")
    if compression == 7 and (planar != 1 or bps[0] != 8):
        raise NotImplementedError(f"{path}: a JPEG-compressed TIFF of {bps[0]}-bit planar-{planar} samples "
                                  "is not supported")
    if compression in _CCITT and bps != (1,):
        raise ValueError(f"{path}: a {_CCITT[compression]} TIFF of {bps[0]}-bit samples")
    if len(set(bps)) != 1:
        raise NotImplementedError(f"{path}: TIFF samples of different widths are not supported")
    plane_modes = None
    if planar == 2 and compression == 1:
        # Pillow reads each plane itself, with one letter of the raw mode
        plane_modes = rawmode[:spp]
        if (any(m not in _PLANE_BITS for m in plane_modes) or mode in ("I;16", "I;16B", "I", "LAB")
                or bps[0] not in (1, 8, 16, 32) or (bps[0] == 1) != (mode == "1")):
            raise NotImplementedError(f"{path}: an uncompressed planar TIFF of raw mode {rawmode} is not supported")
    if 273 in tags:
        offsets, counts = tags[273], tags.get(279)
        cw, ch = width, _first(tags, 278, height)
    elif 324 in tags:
        offsets, counts = tags[324], tags.get(325)
        cw, ch = _first(tags, 322, 0), _first(tags, 323, 0)
    else:
        raise ValueError(f"{path}: TIFF without strips or tiles")
    if cw <= 0 or ch <= 0:
        raise ValueError(f"{path}: bad TIFF strip or tile size")
    tables = tags.get(347)
    return {"order": order, "width": width, "height": height, "mode": mode, "rawmode": rawmode,
            "compression": compression, "predictor": _first(tags, 317, 1), "planar": planar, "spp": spp,
            "bits": bps[0], "float": sample_format == (3,), "signed": sample_format == (2,), "fill": fill,
            "tiled": 324 in tags and 273 not in tags, "offsets": offsets, "counts": counts, "cw": cw, "ch": ch,
            "colormap": tags.get(320), "photometric": photo, "orientation": _first(tags, 274, 1),
            "t4options": _first(tags, 292, 0), "jpeg_tables": bytes(tables) if tables else b"",
            "plane_modes": plane_modes, "ycbcr_sub": tags.get(530, (2, 2)),
            "ycbcr_coeffs": tags.get(529, (0.299, 0.587, 0.114)),
            "refbw": tags.get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)),
            "interchange": (_first(tags, 513, 0), _first(tags, 514, 0))}


def tiff_size(data: bytes, path) -> Tuple[int, int]:
    layout = _tiff_layout(data, path)
    if layout["orientation"] in (5, 6, 7, 8):  # Pillow's size is the transposed image's
        return layout["height"], layout["width"]
    return layout["width"], layout["height"]


def _dtype(bits: int, is_float: bool, order: bytes) -> np.dtype:
    e = "<" if order == II else ">"
    return np.dtype(f"{e}f4") if is_float else np.dtype({8: "u1", 16: f"{e}u2", 32: f"{e}u4"}[bits])


def _unpack_bits(rows_u8: np.ndarray, bits: int, count: int) -> np.ndarray:
    """MSB-first packed samples of `bits` (1, 2, 4 or 12) -> [rows, count]."""
    rows = rows_u8.shape[0]
    if bits == 12:
        b = rows_u8[:, :(count + 1) // 2 * 3].astype(np.uint16)
        if b.shape[1] < (count + 1) // 2 * 3:  # an odd count: the last pair is half stored
            b = np.concatenate([b, np.zeros((rows, (count + 1) // 2 * 3 - b.shape[1]), np.uint16)], 1)
        b = b.reshape(rows, -1, 3)
        pairs = np.stack([(b[..., 0] << 4) | (b[..., 1] >> 4), ((b[..., 1] & 15) << 8) | b[..., 2]], -1)
        return pairs.reshape(rows, -1)[:, :count]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows_u8[..., None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows, -1)[:, :count].astype(np.uint8)


def _tiff_bytes(layout: dict, raw: bytes, size: int, path) -> np.ndarray:
    """A strip's or tile's `size` stored bytes, decompressed."""
    compression = layout["compression"]
    if compression == 1:
        if len(raw) < size:
            raise ValueError(f"{path}: TIFF strip or tile is truncated")
        return np.frombuffer(raw, np.uint8, size)
    if compression == 5:
        return _byte_codec("tiff_lzw_decode", raw, size, path)
    if compression == 32773:
        return _byte_codec("packbits_decode", raw, size, path)
    if compression == 50000:
        return _byte_codec("zstd_decode", raw, size, path)
    if compression == 34925:
        try:
            buf = lzma.LZMADecompressor().decompress(raw, size)
        except lzma.LZMAError as e:
            raise ValueError(f"{path}: corrupt LZMA data: {e}") from e
    else:
        try:
            buf = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt Deflate data: {e}") from e
    if len(buf) < size:
        raise ValueError(f"{path}: {_BYTE_CODECS[compression]} data ends {size - len(buf)} bytes short")
    return np.frombuffer(buf, np.uint8)


def _tiff_chunk(layout: dict, raw: bytes, rows: int, samples: int, path) -> np.ndarray:
    """One strip or tile: [rows, cw * samples] sample values (uint8 for 1-8
    bits, unpacked, unscaled; uint16 / uint32 / float32 otherwise), from
    its stored bytes."""
    bits, cw = layout["bits"], layout["cw"]
    compression = layout["compression"]
    if layout["fill"] == 2:  # libtiff reverses the stored bytes; Pillow's raw modes ";R" the same
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    if compression == 7:
        return _tiff_jpeg_chunk(layout, raw, rows, samples, path)
    if compression in _CCITT:
        return _tiff_ccitt_chunk(layout, raw, rows, path)
    row_bytes = (cw * samples * bits + 7) // 8
    rows_u8 = _tiff_bytes(layout, raw, row_bytes * rows, path).reshape(rows, row_bytes)
    # libtiff runs a predictor with these codecs only (PackBits ignores it), and Pillow reads an
    # uncompressed file itself, without one
    predictor = layout["predictor"] if compression in _PREDICTED else 1
    if predictor == 3:
        if not layout["float"] or bits != 32:
            raise NotImplementedError(f"{path}: TIFF predictor 3 on {bits}-bit non-float samples is not supported")
        acc = rows_u8.reshape(rows, -1, samples).cumsum(1, dtype=np.uint8).reshape(rows, row_bytes)
        planes = acc.reshape(rows, 4, cw * samples)  # most significant byte plane first
        return planes.transpose(0, 2, 1).copy().view(">f4").reshape(rows, cw * samples).astype(np.float32)
    if bits < 8 or bits == 12:
        if predictor != 1:
            raise NotImplementedError(f"{path}: TIFF predictor {predictor} on {bits}-bit samples is not supported")
        return _unpack_bits(rows_u8, bits, cw * samples)
    vals = rows_u8.view(_dtype(bits, layout["float"], layout["order"])).reshape(rows, cw * samples)
    vals = vals.astype(vals.dtype.newbyteorder("="))
    if predictor == 2:
        if layout["float"]:
            raise NotImplementedError(f"{path}: TIFF predictor 2 on float samples is not supported")
        vals = vals.reshape(rows, cw, samples).cumsum(1, dtype=vals.dtype).reshape(rows, cw * samples)
    elif predictor != 1:
        raise NotImplementedError(f"{path}: TIFF predictor {predictor} is not supported")
    return vals


def _tiff_jpeg_chunk(layout: dict, raw: bytes, rows: int, samples: int, path) -> np.ndarray:
    """A JPEG-compressed strip or tile, as libtiff's JPEG codec decodes it
    for Pillow: the JPEGTables stream (tag 347, its EOI dropped) ahead of
    the strip's abbreviated stream (its SOI dropped); YCbCr converted to
    RGB by libjpeg (Pillow asks for JPEGCOLORMODE_RGB), every other
    photometric's components taken as they are."""
    from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_bytes

    tables = layout["jpeg_tables"]
    stream = tables[:-2] + raw[2:] if len(tables) > 4 and raw[:2] == b"\xff\xd8" else raw
    arr = decode_jpeg_bytes(stream, path, convert=layout["photometric"] == 6)
    arr = arr.reshape(arr.shape[0], arr.shape[1], -1)
    if arr.shape[1] != layout["cw"] or arr.shape[0] < rows or arr.shape[2] != samples:
        raise ValueError(f"{path}: a JPEG strip or tile of {arr.shape}, expected {rows} x {layout['cw']} x {samples}")
    return arr[:rows].reshape(rows, -1)


def _tiff_ccitt_chunk(layout: dict, raw: bytes, rows: int, path) -> np.ndarray:
    """A CCITT-coded strip or tile (modified Huffman, T.4 1-D / 2-D, T.6)
    as libtiff's fax decoder gives it: [rows, cw] samples, 1 where a
    black run was coded, whatever the photometric (which then reads the
    samples: a WhiteIsZero file's 1 is black, a BlackIsZero file's white)."""
    cw = layout["cw"]
    out = np.zeros(rows * cw, np.uint8)
    written = ctypes.c_size_t(0)
    rc = load_library().ccitt_decode(raw, len(raw), cw, rows, layout["compression"], layout["t4options"],
                                     _ptr(out), out.size, ctypes.byref(written))
    _check(rc, _CCITT[layout["compression"]], path)
    if written.value < rows:
        raise ValueError(f"{path}: {_CCITT[layout['compression']]} data ends {rows - written.value} rows short")
    return out.reshape(rows, cw)


def _tiff_plane(layout: dict, raw: bytes, letter: str, rows: int, width: int, stride: int, path) -> np.ndarray:
    """An uncompressed planar file's strip or tile as Pillow reads it
    itself: `rows` rows of `stride` bytes, each unpacked with the plane's
    one-letter raw mode (8-bit letters whatever the file's bits; "F" a
    native float)."""
    bits = _PLANE_BITS[letter]
    stride = stride or (width * bits + 7) // 8
    if len(raw) < stride * rows:
        raise ValueError(f"{path}: TIFF strip or tile is truncated")
    buf = np.frombuffer(raw, np.uint8, stride * rows).reshape(rows, stride)
    if bits == 1:
        return _unpack_bits(buf, 1, width)
    if letter == "F":
        return buf[:, :4 * width].copy().view("<f4").astype(np.float32)
    return buf[:, :width]


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's unpackRGBa: colour * 255 / alpha (truncated, clipped), all
    zero where alpha is 0."""
    a = rgba[..., 3:].astype(np.int64)
    color = rgba[..., :3].astype(np.int64)
    color = np.where(a == 255, color, np.clip(color * 255 // np.maximum(a, 1), 0, 255))
    out = np.concatenate([color, a], -1)
    return np.where(a == 0, 0, out).astype(np.uint8)


def orient(arr: np.ndarray, orientation: int) -> np.ndarray:
    """Pillow's ImageOps.exif_transpose of an array [H, W, ...] by an
    EXIF / TIFF orientation (1-8; other values leave it as it is)."""
    if orientation == 2:
        arr = arr[:, ::-1]
    elif orientation == 3:
        arr = arr[::-1, ::-1]
    elif orientation == 4:
        arr = arr[::-1]
    elif orientation == 5:
        arr = arr.swapaxes(0, 1)
    elif orientation == 6:
        arr = np.rot90(arr, -1)
    elif orientation == 7:
        arr = arr[::-1, ::-1].swapaxes(0, 1)
    elif orientation == 8:
        arr = np.rot90(arr, 1)
    return np.ascontiguousarray(arr)


@functools.lru_cache(maxsize=8)
def _ycbcr_tables(refbw: tuple, luma: tuple):
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c): its float arithmetic and
    16-bit fixed point, as tables of Y, Cr -> R, Cb -> B, Cr / Cb -> G."""
    f = np.float32
    fix = lambda x: int(np.floor(np.float64(x) * 65536 + 0.5))  # noqa: E731
    lr, lg, lb = f(luma[0]), f(luma[1]), f(luma[2])
    f1 = f(2) - f(2) * lr
    f2 = lr * f1 / lg
    f3 = f(2) - f(2) * lb
    f4 = lb * f3 / lg
    d1, d2 = fix(min(max(f1, 0), 2)), -fix(min(max(f2, 0), 2))
    d3, d4 = fix(min(max(f3, 0), 2)), -fix(min(max(f4, 0), 2))
    rb = [f(v) for v in refbw]

    def code2v(c, black, white, span):  # Code2V, clamped to +-4096 and truncated
        v = f(c - int(black)) * f(span) / f(white - black if white - black != 0 else 1)
        return int(min(max(v, f(-4096)), f(4096)))

    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        cr = code2v(i - 128, rb[4] - 128, rb[5] - 128, 127)
        cb = code2v(i - 128, rb[2] - 128, rb[3] - 128, 127)
        tabs[:, i] = ((d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768,
                      code2v(i, rb[0], rb[1], 255))
    return tabs


def _ycbcr_to_rgb(ycc: np.ndarray, layout: dict) -> np.ndarray:
    """libtiff's TIFFYCbCrtoRGB of uint8 [H, W, 3] Y, Cb, Cr samples."""
    cr_r, cb_b, cr_g, cb_g, y_tab = _ycbcr_tables(tuple(layout["refbw"]), tuple(layout["ycbcr_coeffs"]))
    y, cb, cr = (ycc[..., k].astype(np.intp) for k in range(3))
    rgb = [y_tab[y] + cr_r[cr], y_tab[y] + ((cb_g[cb] + cr_g[cr]) >> 16), y_tab[y] + cb_b[cb]]
    return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)


def _ycbcr_units(layout: dict, raw: bytes, rows: int, path) -> np.ndarray:
    """A non-JPEG YCbCr strip or tile of data units (h x v luma samples,
    then Cb and Cr) -> [rows, cw, 3] Y, Cb, Cr, each chroma sample
    replicated over its unit, as libtiff's RGBA reader puts it."""
    h, v = layout["ycbcr_sub"]
    cw = layout["cw"]
    ux, uy = -(-cw // h), -(-rows // v)
    units = _tiff_bytes(layout, raw, ux * uy * (h * v + 2), path).reshape(uy, ux, h * v + 2)
    luma = units[..., :h * v].reshape(uy, ux, v, h).transpose(0, 2, 1, 3).reshape(uy * v, ux * h)
    chroma = np.repeat(np.repeat(units[..., h * v:], v, 0), h, 1)
    return np.concatenate([luma[..., None], chroma], -1)[:rows, :cw]


def decode_tiff(data: bytes, path) -> Tuple[np.ndarray, str]:
    layout = _tiff_layout(data, path)
    if layout["photometric"] == 6 and layout["compression"] != 7:
        return orient(_decode_ycbcr(data, layout, path), layout["orientation"]), layout["mode"]
    width, height, spp = layout["width"], layout["height"], layout["spp"]
    planes = spp if layout["planar"] == 2 and spp > 1 else 1
    samples = spp // planes
    cw, ch = layout["cw"], layout["ch"]
    across, down = (-(-width // cw), -(-height // ch)) if layout["tiled"] else (1, -(-height // ch))
    offsets, counts = layout["offsets"], layout["counts"]
    if len(offsets) < across * down * planes:
        raise ValueError(f"{path}: TIFF has {len(offsets)} strips or tiles, {across * down * planes} expected")
    if counts is None:
        if layout["compression"] != 1:
            raise NotImplementedError(f"{path}: compressed TIFF without byte counts is not supported")
        counts = [len(data)] * len(offsets)
    plane_modes = layout["plane_modes"]
    image = None
    for i in range(across * down * planes):
        plane, rest = divmod(i, across * down)
        ty, tx = divmod(rest, across)
        y0, x0 = ty * ch, tx * cw
        rows = ch if layout["tiled"] else min(ch, height - y0)
        raw = data[offsets[i]:offsets[i] + counts[i]]
        if plane_modes is not None:
            letter = plane_modes[plane]
            overhang = x0 + cw > width
            stride = cw * layout["bits"] * spp // 8 // spp if overhang else 0
            chunk = _tiff_plane(layout, raw, letter, rows, cw, stride, path)
        else:
            chunk = _tiff_chunk(layout, raw, rows, samples, path)
        if image is None:
            image = np.zeros((height, width, spp), chunk.dtype)
        chunk = chunk.reshape(rows, cw, samples)
        h, w = min(rows, height - y0), min(cw, width - x0)
        image[y0:y0 + h, x0:x0 + w, plane * samples:(plane + 1) * samples] = chunk[:h, :w]
    if plane_modes is not None:
        arr = _planar_mode(image, layout)
    else:
        arr = _tiff_mode(image, layout)
    return orient(arr, layout["orientation"]), layout["mode"]


def _decode_ycbcr(data: bytes, layout: dict, path) -> np.ndarray:
    """YCbCr that Pillow reads through libtiff's RGBA interface (not
    JPEG-compressed): an old-style JPEG's interchange stream decoded to
    its planes with the chroma replicated (libtiff's OJPEG codec hands
    over raw planes), or data units of any byte codec; then libtiff's
    YCbCr -> RGB."""
    width, height = layout["width"], layout["height"]
    if layout["compression"] == 6:
        from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_bytes

        start, size = layout["interchange"]
        ycc = decode_jpeg_bytes(data[start:start + size], path, convert="replicate")
        if ycc.ndim != 3 or ycc.shape[2] != 3 or ycc.shape[0] < height or ycc.shape[1] < width:
            raise ValueError(f"{path}: an old-style JPEG stream of {ycc.shape} for a {width}x{height} image")
        return _ycbcr_to_rgb(ycc[:height, :width], layout)
    if layout["predictor"] != 1:
        raise NotImplementedError(f"{path}: a predictor on YCbCr data units is not supported")
    cw, ch = layout["cw"], layout["ch"]
    across, down = (-(-width // cw), -(-height // ch)) if layout["tiled"] else (1, -(-height // ch))
    ycc = np.zeros((height, width, 3), np.uint8)
    for i in range(across * down):
        ty, tx = divmod(i, across)
        y0, x0 = ty * ch, tx * cw
        rows = ch if layout["tiled"] else min(ch, height - y0)
        raw = data[layout["offsets"][i]:layout["offsets"][i] + layout["counts"][i]]
        if layout["fill"] == 2:
            raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        chunk = _ycbcr_units(layout, raw, rows, path)
        h, w = min(rows, height - y0), min(cw, width - x0)
        ycc[y0:y0 + h, x0:x0 + w] = chunk[:h, :w]
    return _ycbcr_to_rgb(ycc, layout)


def _planar_mode(v: np.ndarray, layout: dict) -> np.ndarray:
    """The planes Pillow unpacked itself, one letter each, -> the mode's
    array (an "X" plane fills nothing; an RGBA / LA image of 8-bit planes
    keeps its alpha as stored)."""
    mode, letters = layout["mode"], layout["plane_modes"]
    if mode == "1":
        return _bilevel(v[..., 0] != 0)
    if mode == "F":
        return v[..., 0].astype(np.float32)
    channels = {"RGB": 3, "RGBA": 4, "LA": 2, "L": 1, "P": 1, "PA": 2}[mode]
    out = np.zeros(v.shape[:2] + (channels,), np.uint8)
    slot = {"R": 0, "G": 1, "B": 2, "A": channels - 1, "L": 0, "P": 0}
    for k, letter in enumerate(letters):
        if letter != "X":
            out[..., slot[letter]] = v[..., k]
    return out[..., 0] if channels == 1 else out


def _tiff_mode(v: np.ndarray, layout: dict) -> np.ndarray:
    """Sample values [H, W, spp] -> Pillow's array of the file's mode."""
    raw, mode = layout["rawmode"], layout["mode"]
    base = raw.split(";")[0]
    if mode == "1":
        return _bilevel(v[..., 0] == 0 if raw.startswith("1;I") else v[..., 0] != 0)
    if mode == "L":
        scale = {1: 1, 2: 0x55, 4: 0x11, 8: 1}[layout["bits"]]
        top = (1 << layout["bits"]) - 1
        vals = top - v[..., 0] if raw.endswith("I") else v[..., 0]
        return (vals.astype(np.int32) * scale).astype(np.uint8)
    if mode in ("I;16", "I;16B"):
        return v[..., 0].astype("<u2" if mode == "I;16" else ">u2")
    if mode == "P":
        return v[..., 0].astype(np.uint8)
    if mode in ("I", "F"):
        x = v[..., 0]
        if layout["compression"] != 1 and raw in ("F;32BF", "I;32BS", "I;16BS"):
            # libtiff gives the samples in the host's order; Pillow reads them as big-endian
            x = x.byteswap()
        if raw.startswith("I;16"):
            return x.astype(np.int16).astype(np.int32)
        return x.view(np.int32) if mode == "I" else x.astype(np.float32)
    if ";16" in raw:
        v = (v >> 8).astype(np.uint8)  # Pillow keeps the high byte of 16-bit colour
    if mode in ("LA", "PA"):
        return v[..., :2].astype(np.uint8)
    if mode == "RGB":
        return v[..., :3].astype(np.uint8)
    if mode in ("LAB", "CMYK"):
        return v[..., :len(mode)].astype(np.uint8)
    rgba = v[..., :4].astype(np.uint8)
    return _unpremultiply(rgba) if base in ("RGBa", "RGBaX", "RGBaXX") else rgba


# ---- BMP -------------------------------------------------------------------

_BMP_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
                 32: ("RGB", "BGRX")}
_BMP_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _bmp_layout(data: bytes, path, raw_alpha: bool = False) -> dict:
    """Pillow's BmpImageFile._bitmap: size, mode, raw mode, where the pixels
    start and how they are stored. A pixel offset of 0 (a DIB has none)
    means right after the header, masks and palette; `raw_alpha` reads a
    32-bit BI_RGB file's fourth byte as alpha (Pillow does so for a CUR
    whose bitmap starts at byte 22)."""
    u32 = lambda p: struct.unpack("<I", data[p:p + 4])[0]  # noqa: E731
    u16 = lambda p: struct.unpack("<H", data[p:p + 2])[0]  # noqa: E731
    if len(data) < 18:
        raise ValueError(f"{path}: truncated BMP header")
    offset, header_size = u32(10), u32(14)
    if len(data) < 14 + header_size:
        raise ValueError(f"{path}: truncated BMP header")
    pos = 14 + header_size  # the file position after the header
    direction = -1
    masks = None
    if header_size == 12:
        width, height, bits, compression, padding, colors = u16(18), u16(20), u16(24), 0, 3, 0
    elif header_size in (40, 52, 56, 64, 108, 124):
        y_flip = data[25] == 0xFF
        direction = 1 if y_flip else -1
        width = u32(18)
        height = 2**32 - u32(22) if y_flip else u32(22)
        bits, compression, colors, padding = u16(28), u32(30), u32(46), 4
        if compression == 3:
            if header_size >= 52:
                masks = [u32(54 + 4 * k) for k in range(3)] + [u32(66) if header_size >= 56 else 0]
            else:
                masks = [u32(pos + 4 * k) for k in range(3)] + [0]
                pos += 12
    else:
        raise NotImplementedError(f"{path}: BMP header of {header_size} bytes (Pillow refuses it too)")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_BIT2MODE:
        raise NotImplementedError(f"{path}: {bits}-bit BMP (Pillow refuses it too)")
    mode, rawmode = _BMP_BIT2MODE[bits]
    rle = False
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in _BMP_MASK_MODES:
            raise NotImplementedError(f"{path}: BMP bitfields layout {key} (Pillow refuses it too)")
        rawmode = _BMP_MASK_MODES[key]
        if bits == 32 and "A" in rawmode:
            mode = "RGBA"
    elif compression == 0 and bits == 32 and raw_alpha:
        mode, rawmode = "RGBA", "BGRA"
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise NotImplementedError(f"{path}: BMP compression {compression} (Pillow refuses it too)")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise NotImplementedError(f"{path}: BMP palette of {colors} colours (Pillow refuses it too)")
        palette = data[pos:pos + padding * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(palette[i * padding:i * padding + 3] == bytes([v % 256]) * 3 for i, v in enumerate(ramp))
        if grey:
            mode = rawmode = "1" if colors == 2 else "L"
    if rle and mode == "1":
        raise NotImplementedError(f"{path}: a black-and-white RLE BMP (Pillow cannot unpack it)")
    if rle and bits > 8:
        raise NotImplementedError(f"{path}: a {bits}-bit RLE BMP (Pillow cannot unpack it)")
    if offset == 0:
        offset = pos + (padding * colors if bits <= 8 else 0)
    return {"width": width, "height": height, "bits": bits, "mode": mode, "rawmode": rawmode, "offset": offset,
            "direction": direction, "rle4": compression == 2 if rle else None, "palette": palette,
            "padding": padding}


def bmp_size(data: bytes, path) -> Tuple[int, int]:
    layout = _bmp_layout(data, path)
    return layout["width"], layout["height"]


def _bmp_pixels(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """Raw rows [H, stride] -> Pillow's pixels for the raw mode."""
    if rawmode in ("P;1", "1"):
        out = np.unpackbits(rows, axis=1)[:, :width]
        return _bilevel(out) if rawmode == "1" else out
    if rawmode == "P;4":
        return np.stack([rows >> 4, rows & 15], -1).reshape(rows.shape[0], -1)[:, :width]
    if rawmode == "P":
        return rows[:, :width]
    if rawmode == "L":
        # a 4-bit grey-ramp palette too: Pillow unpacks raw mode "L" at 8 bits, `width` bytes from
        # each row's start, running on into the next stored row (zeros past the data)
        h, stride = rows.shape
        flat = np.concatenate([rows.reshape(-1), np.zeros(width, np.uint8)])
        return flat[np.arange(h)[:, None] * stride + np.arange(width)[None]]
    if rawmode.startswith("BGR;1"):
        p = rows[:, :2 * width].astype(np.int32)
        p = (p[:, 0::2] | (p[:, 1::2] << 8))
        if rawmode == "BGR;15":
            r, g, b = ((p >> 10) & 31) * 255 // 31, ((p >> 5) & 31) * 255 // 31, (p & 31) * 255 // 31
        else:
            r, g, b = ((p >> 11) & 31) * 255 // 31, ((p >> 5) & 63) * 255 // 63, (p & 31) * 255 // 31
        return np.stack([r, g, b], -1).astype(np.uint8)
    n = len(rawmode)
    px = rows[:, :n * width].reshape(rows.shape[0], width, n)
    order = [rawmode.index(c) for c in ("RGBA" if "A" in rawmode else "RGB")]
    return px[..., order]


def decode_bmp(data: bytes, path) -> Tuple[np.ndarray, str]:
    layout = _bmp_layout(data, path)
    return bmp_pixels(data, layout, path), layout["mode"]


def dib_layout(data: bytes, start: int, path, raw_alpha: bool = False) -> Tuple[bytes, dict]:
    """A DIB (a bitmap without its file header: ICO and CUR entries, DIB
    files) whose header starts at `start`: the DIB behind a 14-byte file
    header whose pixel offset is 0, and its layout (offsets into those
    bytes)."""
    dib = b"BM" + bytes(12) + data[start:]
    layout = _bmp_layout(dib, path, raw_alpha)
    layout["file_shift"] = start - 14  # an RLE bitmap aligns its codes to the file's positions
    return dib, layout


def bmp_pixels(data: bytes, layout: dict, path) -> np.ndarray:
    """The pixels of a BMP laid out by _bmp_layout, in Pillow's array of
    its mode."""
    w, h, off = layout["width"], layout["height"], layout["offset"]
    if layout["rle4"] is not None:
        cap = w * h
        out = np.zeros(cap, np.uint8)
        length = ctypes.c_size_t(0)
        rc = load_library().bmp_rle_decode(data[off:], len(data) - off, off + layout.get("file_shift", 0), w, h,
                                           int(layout["rle4"]), _ptr(out), cap, ctypes.byref(length))
        _check(rc, "BMP RLE", path)
        if length.value < cap:
            raise ValueError(f"{path}: not enough image data in the RLE BMP")
        pix = out.reshape(h, w)
    else:
        stride = ((w * layout["bits"] + 31) >> 3) & ~3
        need = stride * (h - 1) + (w * layout["bits"] + 7) // 8  # the last row stored needs no padding
        if off + need > len(data):
            raise ValueError(f"{path}: truncated BMP pixel data")
        rows = np.zeros(stride * h, np.uint8)
        rows[:need] = np.frombuffer(data, np.uint8, need, off)
        pix = _bmp_pixels(rows.reshape(h, stride), layout["rawmode"], w)
    if layout["direction"] == -1:
        pix = pix[::-1]
    return np.ascontiguousarray(pix)


# ---- GIF -------------------------------------------------------------------


def _identity_palette(p: bytes) -> bool:
    """GifImageFile._is_palette_needed, negated."""
    return all(i // 3 == p[i] == p[i + 1] == p[i + 2] for i in range(0, len(p) - 2, 3)) and len(p) % 3 == 0


def _gif_frame(data: bytes, path) -> dict:
    """The first frame's descriptor, as GifImageFile._open and _seek(0)."""
    if len(data) < 13:
        raise ValueError(f"{path}: truncated GIF header")
    size = list(struct.unpack("<HH", data[6:10]))
    flags = data[10]
    pos = 13
    global_palette = False
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        global_palette = not _identity_palette(data[pos:pos + n])
        pos += n

    def blocks(p):  # skip data sub-blocks; returns the position after the terminator
        while p < len(data) and data[p]:
            p += 1 + data[p]
        return p + 1

    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise NotImplementedError(f"{path}: a GIF with no image (Pillow refuses it too)")
        s = data[pos]
        pos += 1
        if s == 0x21:  # extension
            label = data[pos] if pos < len(data) else 0
            pos += 1
            if label == 249 and pos < len(data) and data[pos] >= 4:
                block = data[pos + 1:pos + 1 + data[pos]]
                if block[0] & 1:
                    transparency = block[3]
            pos = blocks(pos)
        elif s == 0x2C:  # image descriptor
            x0, y0, w, h = struct.unpack("<HHHH", data[pos:pos + 8])
            fflags = data[pos + 8]
            pos += 9
            size = [max(x0 + w, size[0]), max(y0 + h, size[1])]
            palette = None
            if fflags & 128:
                n = 3 << ((fflags & 7) + 1)
                palette = not _identity_palette(data[pos:pos + n])
                pos += n
            bits = data[pos]
            frame_palette = palette if palette is not None else global_palette
            mode = "P" if frame_palette else "L"
            if palette is False and global_palette:
                mode = "L:P"  # Pillow's mode "L" over a palette image, which it cannot resize
            return {"size": tuple(size), "extent": (x0, y0, w, h), "interlace": bool(fflags & 64), "bits": bits,
                    "offset": pos + 1, "mode": mode, "transparency": transparency}


def gif_size(data: bytes, path) -> Tuple[int, int]:
    return _gif_frame(data, path)["size"]


def decode_gif(data: bytes, path) -> Tuple[np.ndarray, str]:
    frame = _gif_frame(data, path)
    width, height = frame["size"]
    fill = frame["transparency"] if frame["transparency"] is not None else 0
    canvas = np.full((height, width), fill, np.uint8)
    x0, y0, w, h = frame["extent"]
    off = frame["offset"]
    rc = load_library().gif_lzw_decode(data[off:], len(data) - off, frame["bits"], int(frame["interlace"]), x0, y0,
                                       w, h, width, _ptr(canvas))
    _check(rc, "GIF LZW", path)
    return canvas, frame["mode"]
