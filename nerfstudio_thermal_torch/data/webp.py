"""WebP decoding through the port's own decoder
(nerfstudio_thermal_torch/native/webp_decoder.cpp), compiled with g++ into
build/native/ at first use and loaded with ctypes, as the JPEG decoder is.

It computes what Pillow's `np.asarray(Image.open(path))` gives (Pillow
decodes WebP through libwebp's animation decoder): lossless (VP8L) and
lossy (VP8, with libwebp's fancy chroma upsampling and YUV -> RGB
conversion) images, VP8X files with an alpha chunk, and an animation's
first frame on its canvas. The array is [H, W, 4] (mode "RGBA", straight
alpha) when the file says it has alpha, else [H, W, 3] ("RGB"). There is
no fallback: when the library cannot be built or loaded, decoding raises.
"""

import ctypes
from typing import Tuple

import numpy as np

from nerfstudio_thermal_torch.data.native_build import NATIVE_DIR, build_library

SOURCE = NATIVE_DIR / "webp_decoder.cpp"
_lib = None


def load_library():
    """The decoder library, built at first use; raises when it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(str(build_library(SOURCE, "libwebp_decoder")))
        except Exception as e:
            raise RuntimeError(f"the WebP decoder ({SOURCE.name}) could not be built or loaded: {e}") from e
        if lib.webp_decoder_abi_version() != 1:
            raise RuntimeError("the WebP decoder library has an unexpected ABI version")
        lib.webp_decode.restype = ctypes.c_int
        lib.webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def _call(data: bytes, out, out_size: int, path) -> Tuple[int, int, int]:
    dims = (ctypes.c_int * 3)()
    err = ctypes.create_string_buffer(256)
    rc = load_library().webp_decode(data, len(data), out, out_size, dims, err, len(err))
    if rc == 1:
        raise NotImplementedError(f"{path}: {err.value.decode()}")
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    return dims[0], dims[1], dims[2]


def decode_webp(data: bytes, path="<bytes>") -> Tuple[np.ndarray, str]:
    """(uint8 [H, W, 3 or 4], Pillow's mode "RGB" or "RGBA") of a file's bytes."""
    h, w, c = _call(data, None, 0, path)
    out = np.empty((h, w, c), np.uint8)
    _call(data, out.ctypes.data_as(ctypes.c_void_p), out.nbytes, path)
    return out, "RGBA" if c == 4 else "RGB"


def webp_size(data: bytes, path="<bytes>") -> Tuple[int, int]:
    """(width, height) of the canvas, from the headers."""
    h, w, _ = _call(data, None, 0, path)
    return w, h

