"""JPEG decoding and encoding through the port's own decoder (baseline and
progressive) and baseline encoder
(nerfstudio_thermal_torch/native/jpeg_{decoder,encoder}.cpp).

Each source is compiled with g++ into build/native/ at first use and loaded
with ctypes. It computes what Pillow's `np.asarray(Image.open(path))`
gives with libjpeg-turbo's default settings: [H, W] uint8 for a greyscale
file, [H, W, 3] RGB otherwise, with no EXIF rotation. There is no
fallback: when the library cannot be built or loaded, decoding raises. A
feature outside the decoder's scope (lossless, hierarchical or arithmetic
coding, 12-bit samples, CMYK, a progressive file that libjpeg would
block-smooth) raises NotImplementedError naming it.

`encode_jpeg` writes what Pillow's `Image.save(format="JPEG", quality=q)`
writes for an RGB image with libjpeg-turbo's defaults (4:2:0, the ISLOW
DCT, the standard Huffman tables, a JFIF header): the viewer streams its
frames with it, since the card's machine has no Pillow. It too raises
when its library cannot be built or loaded.
"""

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from nerfstudio_thermal_torch.data.native_build import NATIVE_DIR, build_library

SOURCE = NATIVE_DIR / "jpeg_decoder.cpp"
ENCODER_SOURCE = NATIVE_DIR / "jpeg_encoder.cpp"
_lib = None
_encoder = None


def load_library():
    """The decoder library, built at first use; raises when it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(str(build_library(SOURCE, "libjpeg_decoder")))
        except Exception as e:
            raise RuntimeError(f"the JPEG decoder ({SOURCE.name}) could not be built or loaded: {e}") from e
        if lib.jpeg_decoder_abi_version() != 1:
            raise RuntimeError("the JPEG decoder library has an unexpected ABI version")
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
        ]
        _lib = lib
    return _lib


def _call(data: bytes, out, out_size: int, path) -> Tuple[int, int, int]:
    dims = (ctypes.c_int * 3)()
    err = ctypes.create_string_buffer(256)
    rc = load_library().jpeg_decode(data, len(data), out, out_size, dims, err, len(err))
    if rc == 1:
        raise NotImplementedError(f"{path}: {err.value.decode()}")
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    return dims[0], dims[1], dims[2]


def decode_jpeg(path) -> np.ndarray:
    """A JPEG as uint8 [H, W] (greyscale) or [H, W, 3] (RGB)."""
    return decode_jpeg_bytes(Path(path).read_bytes(), path)


def decode_jpeg_bytes(data: bytes, name="<bytes>") -> np.ndarray:
    """`decode_jpeg` of a file's bytes; `name` labels errors."""
    h, w, c = _call(data, None, 0, name)
    out = np.empty((h, w, c), np.uint8)
    _call(data, out.ctypes.data_as(ctypes.c_void_p), out.nbytes, name)
    return out[..., 0] if c == 1 else out


def load_encoder():
    """The encoder library, built at first use; raises when it cannot be
    built or loaded."""
    global _encoder
    if _encoder is None:
        try:
            lib = ctypes.CDLL(str(build_library(ENCODER_SOURCE, "libjpeg_encoder")))
        except Exception as e:
            raise RuntimeError(f"the JPEG encoder ({ENCODER_SOURCE.name}) could not be built or loaded: {e}") from e
        if lib.jpeg_encoder_abi_version() != 1:
            raise RuntimeError("the JPEG encoder library has an unexpected ABI version")
        lib.jpeg_encode.restype = ctypes.c_int
        lib.jpeg_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        _encoder = lib
    return _encoder


def encode_jpeg(image: np.ndarray, quality: int = 85) -> bytes:
    """A baseline JPEG of uint8 [H, W, 3] (RGB), [H, W, 1] or [H, W]
    (greyscale, repeated to 3 channels first, as the JAX viewer does),
    equal bytes to Pillow's at the same quality."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_jpeg takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3):
        raise ValueError(f"encode_jpeg takes [H, W, 3] or [H, W, 1] pixels, got {img.shape}")
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    lib = load_encoder()
    size = ctypes.c_size_t(0)
    cap = img.nbytes // 2 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.jpeg_encode(img.ctypes.data_as(ctypes.c_void_p), h, w, int(quality),
                             out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(size))
        if rc == 0:
            return out[: size.value].tobytes()
        if rc != 1:
            raise ValueError(f"encode_jpeg: cannot encode a {w}x{h} image")
        cap = size.value


def jpeg_size(path) -> Tuple[int, int]:
    """(width, height) from the frame header."""
    h, w, _ = _call(Path(path).read_bytes(), None, 0, path)
    return w, h
