"""JPEG decoding through the port's own baseline decoder
(nerfstudio_thermal_torch/native/jpeg_decoder.cpp).

The source is compiled with g++ into build/native/ at first use and loaded
with ctypes. It computes what Pillow's `np.asarray(Image.open(path))`
gives with libjpeg-turbo's default settings: [H, W] uint8 for a greyscale
file, [H, W, 3] RGB otherwise, with no EXIF rotation. There is no
fallback: when the library cannot be built or loaded, decoding raises. A
feature outside the decoder's scope (progressive, lossless, hierarchical
or arithmetic coding, 12-bit samples, CMYK) raises NotImplementedError
naming it.
"""

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from nerfstudio_thermal_torch.data.native_build import NATIVE_DIR, build_library

SOURCE = NATIVE_DIR / "jpeg_decoder.cpp"
_lib = None


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
    data = Path(path).read_bytes()
    h, w, c = _call(data, None, 0, path)
    out = np.empty((h, w, c), np.uint8)
    _call(data, out.ctypes.data_as(ctypes.c_void_p), out.nbytes, path)
    return out[..., 0] if c == 1 else out


def jpeg_size(path) -> Tuple[int, int]:
    """(width, height) from the frame header."""
    h, w, _ = _call(Path(path).read_bytes(), None, 0, path)
    return w, h
