"""Image datasets, host side (counterpart of nerfstudio_thermal_tpu/data/datasets.py).

Images load as float32 [H, W, 3 or 4] in [0, 1]; greyscale is replicated
to 3 channels (thermal PNGs are grey; the RGBT packing later takes channel
0). PNGs are decoded here with the standard library's zlib, so the port
needs no imaging package: 8- and 16-bit, grey, grey+alpha, RGB and RGBA,
non-interlaced, all five row filters. `is_thermal` comes per image from
the dataparser's metadata.
"""

import struct
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import DataparserOutputs

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def png_size(path) -> Tuple[int, int]:
    """(width, height) from the IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters. raw: the inflated stream, rows of one
    filter byte plus `stride` bytes."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype == 1:  # sub: a running sum per byte of the pixel
            cur = np.empty_like(line)
            for j in range(bpp):
                cur[j::bpp] = np.cumsum(line[j::bpp]) & 0xFF
        elif ftype in (3, 4):  # average, paeth: sequential along the row
            cur = line.copy()
            up = prev
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(up[i])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (int(cur[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(path) -> np.ndarray:
    """A PNG as uint8 or uint16 [H, W, C] (C = samples per pixel)."""
    data = Path(path).read_bytes()
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise NotImplementedError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNGs are not supported")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pixels = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16).reshape(height, width, channels)
    return pixels.reshape(height, width, channels)


def load_image(path, scale_factor: float = 1.0) -> np.ndarray:
    """An image as float32 [H, W, 3 or 4] in [0, 1]."""
    if scale_factor != 1.0:
        raise NotImplementedError("camera_res_scale_factor != 1 is not ported yet")
    if Path(path).suffix.lower() != ".png":
        raise NotImplementedError(f"{path}: the port reads PNG images only")
    arr = decode_png(path)
    img = arr.astype(np.float32) / (65535.0 if arr.dtype == np.uint16 else 255.0)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] == 2:  # grey + alpha
        img = np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]], -1)
    return img


class InputDataset:
    """Dataset over the dataparser outputs; images load lazily and stay
    cached in host memory."""

    def __init__(self, dataparser_outputs: DataparserOutputs, scale_factor: float = 1.0):
        self._dataparser_outputs = dataparser_outputs
        self.scale_factor = scale_factor
        self.cameras = dataparser_outputs.cameras
        self.metadata = dataparser_outputs.metadata
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self._dataparser_outputs.image_filenames)

    @property
    def image_filenames(self):
        return self._dataparser_outputs.image_filenames

    def get_image(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            self._cache[idx] = load_image(
                self._dataparser_outputs.image_filenames[idx], self.scale_factor
            )
        return self._cache[idx]

    @property
    def is_thermal(self) -> np.ndarray:
        vals = self.metadata.get("is_thermal")
        if vals is None:
            return np.zeros((len(self),), np.float32)
        return np.asarray(vals, np.float32)
