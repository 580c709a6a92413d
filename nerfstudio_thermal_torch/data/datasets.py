"""Image datasets, host side (counterpart of nerfstudio_thermal_tpu/data/datasets.py).

Images load as float32 [H, W, 3 or 4] in [0, 1]; greyscale is replicated
to 3 channels (thermal PNGs are grey; the RGBT packing later takes channel
0). The JAX package reads them with Pillow; the port decodes them itself,
so it needs no imaging package, and gives what `np.asarray(Image.open(p))`
gives, choosing the decoder by the file's first bytes as Pillow does:
- PNG with the standard library's zlib: 1- to 16-bit, grey, grey+alpha,
  RGB, RGBA and palette (the indices, as Pillow's mode "P"), Adam7
  interlacing, all five row filters; 16-bit colour keeps its high byte
  as Pillow does, 16-bit grey stays uint16;
- JPEG with the port's decoder (data/jpeg.py), CMYK / YCCK included
  (4 channels, inverted as Pillow's "CMYK;I");
- TIFF, BMP and GIF with data/image_formats.py (16-bit grey TIFF is
  uint16, float TIFF float32, 32-bit int TIFF int32; CMYK and CIELAB
  TIFFs give 4 and 3 channels, as Pillow gives them to the JAX loader);
- WebP with the port's decoder (data/webp.py): lossless, lossy, alpha,
  an animation's first frame;
each raising when its native library cannot be built: no other decoder
stands in. `camera_res_scale_factor` resizes as Pillow's BILINEAR,
computed in numpy (`resize_like_pil`) per Pillow's mode (palette and
1-bit images with NEAREST), and, as in the JAX package, the cameras are
not rescaled with it. Depth, normal and semantic images load as the JAX
package's `get_depth`, `get_normal` and `get_semantics` do.
`is_thermal` comes per image from the dataparser's metadata.
"""

import math
import struct
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import DataparserOutputs

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


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


def _unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """[H, stride] packed samples of 1, 2 or 4 bits -> [H, width] uint8."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    out = (rows[..., None] >> shifts) & ((1 << depth) - 1)
    return out.reshape(rows.shape[0], -1)[:, :width].astype(np.uint8)


# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows [H, stride] -> samples [H, width, channels]: uint8
    (1-, 2- and 4-bit samples unpacked, unscaled) or uint16."""
    if depth < 8:
        return _unpack_bits(rows, width, depth)[..., None]
    if depth == 16:
        return rows.view(">u2").reshape(rows.shape[0], width, channels).astype(np.uint16)
    return rows.reshape(rows.shape[0], width, channels)


def decode_png(path) -> np.ndarray:
    """A PNG as Pillow's `np.asarray` gives it, with a channel axis: uint8
    [H, W, C], or uint16 [H, W, 1] for 16-bit grey. Palette images give
    their indices; 16-bit colour its high byte (16-bit grey+alpha as
    Pillow's RGBA: grey, grey, grey, alpha); 2- and 4-bit grey scaled to 8
    bits, 1-bit grey 0 / 1 (Pillow's mode "1"). An Adam7-interlaced file's
    seven passes are each unfiltered as an image of their own and scattered
    into place."""
    return _decode_png_data(Path(path).read_bytes(), path)


def decode_png_bytes(data: bytes, path) -> Tuple[np.ndarray, str]:
    """(a PNG's bytes as Pillow's `np.asarray` gives them, its mode)."""
    arr = _decode_png_data(data, path)
    return (arr[..., 0] if arr.shape[-1] == 1 else arr), _png_mode(data[:26])


def png_bytes_size(data: bytes) -> Tuple[int, int]:
    return struct.unpack(">II", data[16:24])


def _decode_png_data(data: bytes, path) -> np.ndarray:
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    allowed = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if ctype not in _CHANNELS or depth not in allowed:
        raise NotImplementedError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    bpp = max(bits // 8, 1)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        samples = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no bytes, not even filter bytes
            pstride = (pw * bits + 7) // 8
            rows = _unfilter(raw[pos : pos + ph * (pstride + 1)], ph, pstride, bpp)
            pos += ph * (pstride + 1)
            samples[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
    else:
        samples = _samples(_unfilter(raw, height, (width * bits + 7) // 8, bpp), width, depth, channels)
    if depth < 8:
        if ctype == 0 and depth > 1:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        return samples
    if depth == 16:
        if ctype == 0:
            return samples
        high = (samples >> 8).astype(np.uint8)
        return np.concatenate([np.repeat(high[..., :1], 3, -1), high[..., 1:]], -1) if ctype == 4 else high
    return samples


def _png_mode(head: bytes) -> str:
    depth, ctype = head[24], head[25]
    if ctype == 3:
        return "P"
    if ctype == 0:
        return {1: "1", 16: "I;16"}.get(depth, "L")
    return {2: "RGB", 4: "RGBA" if depth == 16 else "LA", 6: "RGBA"}[ctype]


def _format(path):
    """(the kind of decoder, the file's bytes, the module that decodes it)."""
    from nerfstudio_thermal_torch.data import image_formats, raster_formats

    data = Path(path).read_bytes()
    kind = raster_formats.identify(data)
    if kind is None:
        raise NotImplementedError(f"{path}: not an image format that Pillow or the port reads")
    if kind.isupper():
        raise NotImplementedError(f"{path}: {kind} is not supported ({raster_formats.REFUSED[kind]})")
    return kind, data, image_formats if kind in ("tiff", "bmp", "gif") else raster_formats


# Image.MAX_IMAGE_PIXELS: Image.open refuses more than twice as many pixels
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def _size(kind: str, data: bytes, module, path) -> Tuple[int, int]:
    if kind == "png":
        return png_bytes_size(data)
    if kind == "jpeg":
        from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_header

        return decode_jpeg_header(data, path)
    if kind == "webp":
        from nerfstudio_thermal_torch.data.webp import webp_size

        return webp_size(data, path)
    return getattr(module, f"{kind}_size")(data, path)


def image_size(path) -> Tuple[int, int]:
    """(width, height) from the file's header."""
    return _size(*_format(path), path)


def read_image(path) -> Tuple[np.ndarray, str]:
    """(the file as Pillow's `np.asarray(Image.open(path))` gives it, its
    Pillow mode): [H, W] for one channel, [H, W, C] otherwise. Like
    Image.open, it refuses an image of more than 2 * MAX_IMAGE_PIXELS
    pixels (a decompression bomb) before decoding it."""
    kind, data, module = _format(path)
    width, height = _size(kind, data, module, path)
    if width * height > 2 * MAX_IMAGE_PIXELS:
        raise NotImplementedError(f"{path}: {width} x {height} pixels, over Pillow's decompression-bomb limit of "
                                  f"{2 * MAX_IMAGE_PIXELS} (Pillow refuses it too)")
    if kind == "png":
        return decode_png_bytes(data, path)
    if kind == "jpeg":
        from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_bytes

        arr = decode_jpeg_bytes(data, path)
        return arr, "L" if arr.ndim == 2 else {3: "RGB", 4: "CMYK"}[arr.shape[-1]]
    if kind == "webp":
        from nerfstudio_thermal_torch.data.webp import decode_webp

        return decode_webp(data, path)
    return getattr(module, f"decode_{kind}")(data, path)


def read_image_array(path) -> np.ndarray:
    """The file as Pillow's `np.asarray(Image.open(path))` gives it: [H, W]
    for one channel, [H, W, C] otherwise."""
    return read_image(path)[0]


# ---- Pillow's Image.resize(size, BILINEAR), in numpy ----------------------

_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the triangle filter (support 1,
    widened by the scale when shrinking): per output index the first input
    index, the tap count and the normalised double weights [out, ksize]."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ww = 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            w = 1.0 - t if t < 1.0 else 0.0
            kk[xx, x] = w
            ww += w
        if ww != 0.0:
            kk[xx, :xmax] /= ww
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _resample_axis(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` (0: rows, vertical; 1: columns, horizontal):
    uint8 with 22-bit fixed-point weights, rounded and clipped as Pillow's
    8bpc passes; uint16 (either byte order) with double weights rounded
    half up (16bpc); int32 with double weights rounded half away from zero
    and float32 summed in doubles, each stored back at its type (32bpc)."""
    with np.errstate(invalid="ignore", over="ignore"):  # float images may hold inf / nan, as Pillow's do
        return _resample_pass(arr, out_size, axis)


def _resample_pass(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = arr.shape[axis]
    bounds, kk = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(arr, axis, 0)
    eight_bit = arr.dtype == np.uint8
    if eight_bit:
        weights = np.where(kk < 0, -0.5 + kk * (1 << _PRECISION_BITS), 0.5 + kk * (1 << _PRECISION_BITS))
        weights = weights.astype(np.int64)  # C's (int) truncation
        acc = np.full((out_size, *src.shape[1:]), 1 << (_PRECISION_BITS - 1), np.int64)
    else:
        acc = np.zeros((out_size, *src.shape[1:]), np.float64)
    for x in range(kk.shape[1]):
        valid = x < bounds[:, 1]
        idx = np.where(valid, bounds[:, 0] + x, 0)
        w = weights[:, x] if eight_bit else kk[:, x]
        w = w.reshape(-1, *([1] * (src.ndim - 1)))
        valid = valid.reshape(w.shape)
        acc = acc + np.where(valid, src[idx].astype(acc.dtype) * w, 0)
    if eight_bit:
        out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    elif arr.dtype.kind == "u":
        out = np.clip(np.floor(acc + 0.5), 0, 65535).astype(arr.dtype)
    elif arr.dtype.kind == "i":
        out = (np.sign(acc) * np.floor(np.abs(acc) + 0.5)).astype(np.int32)
    else:
        out = acc.astype(np.float32)
    return np.moveaxis(out, 0, axis)


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's nearest-neighbour scale: the source coordinate starts at
    scale / 2 and advances by the scale, summed one step at a time in
    doubles; truncated to an index."""
    scale = in_size / out_size
    steps = np.full(out_size, scale, np.float64)
    steps[0] = scale * 0.5
    return np.minimum(np.cumsum(steps).astype(np.int64), in_size - 1)


def resize_like_pil(arr: np.ndarray, width: int, height: int, mode: Optional[str] = None) -> np.ndarray:
    """`np.asarray(Image.fromarray(arr, mode).resize((width, height),
    Image.BILINEAR))` for the arrays the decoders give: uint8 [H, W] (L),
    [H, W, 2] (LA, or PA), [H, W, 3] (RGB, or LAB, whose a* and b* Pillow
    resamples as signed) and [H, W, 4] (RGBA, or CMYK when `mode` says so;
    LA and RGBA are resampled with premultiplied alpha, as Pillow's La /
    RGBa, PA and CMYK band by band), uint16 [H, W] (I;16, and I;16B, whose bytes
    Pillow resamples as little-endian), int32 (I) and float32 (F); palette
    indices and 1-bit images (modes "P" and "1") with NEAREST, as Pillow
    resizes them whatever the filter asked. Mode "L:P" and a size of 0
    raise, as Pillow does."""
    if width <= 0 or height <= 0:
        raise ValueError("height and width must be > 0")
    if mode in ("P", "1"):
        return resize_nearest_like_pil(arr, width, height)
    if mode == "L:P":
        raise ValueError("image has wrong mode (Pillow's 'L' GIF over a palette image cannot be resized)")
    if arr.dtype == np.dtype(">u2"):
        # Pillow's 16-bit resampling reads and writes I;16B as little-endian
        return resize_like_pil(arr.view("<u2"), width, height, "I;16").view(">u2")
    if mode == "LAB":
        # Pillow resamples a* and b* as the signed values they are
        signed = np.array([0, 128, 128], np.uint8)
        return resize_like_pil(arr ^ signed, width, height, "RGB") ^ signed
    h, w = arr.shape[:2]
    if (w, h) == (width, height):
        return arr.copy()
    # LA and RGBA are resampled premultiplied; PA and CMYK band by band
    alpha = arr.ndim == 3 and arr.shape[-1] in (2, 4) and mode not in ("CMYK", "PA")
    if alpha:
        a = arr[..., -1:].astype(np.int64)
        tmp = arr[..., :-1].astype(np.int64) * a + 128
        arr = np.concatenate([((tmp >> 8) + tmp) >> 8, a], -1).astype(np.uint8)
    out = arr
    if width != w:
        out = _resample_axis(out, width, 1)
    if height != h:
        out = _resample_axis(out, height, 0)
    if alpha:
        a = out[..., -1:].astype(np.int64)
        color = out[..., :-1].astype(np.int64)
        un = np.clip(255 * color // np.maximum(a, 1), 0, 255)
        color = np.where((a == 255) | (a == 0), color, un)
        out = np.concatenate([color, a], -1).astype(np.uint8)
    return out


def resize_nearest_like_pil(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's resize of a palette ("P") or 1-bit image: NEAREST."""
    ys = _nearest_indices(arr.shape[0], height)
    xs = _nearest_indices(arr.shape[1], width)
    return arr[ys][:, xs]


def load_image(path, scale_factor: float = 1.0) -> np.ndarray:
    """An image as float32 [H, W, 3 or 4] in [0, 1]; resized by
    `scale_factor` to (int(w * s), int(h * s)) as Pillow's BILINEAR. As in
    the JAX package only native-order uint16 is divided by 65535, every
    other type by 255 (a float or big-endian 16-bit TIFF too)."""
    arr, mode = read_image(path)
    if scale_factor != 1.0:
        h, w = arr.shape[:2]
        arr = resize_like_pil(arr, int(w * scale_factor), int(h * scale_factor), mode)
    img = arr.astype(np.float32) / (65535.0 if arr.dtype == np.uint16 else 255.0)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
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

    def get_depth(self, idx: int) -> Optional[np.ndarray]:
        """Depth [H, W, 1] in scene units (a 16-bit PNG or an npy, times
        depth_unit_scale_factor), or None without depth files."""
        depth_files = self.metadata.get("depth_filenames")
        if not depth_files:
            return None
        scale = float(self.metadata.get("depth_unit_scale_factor", 1e-3))
        path = depth_files[idx]
        if str(path).endswith(".npy"):
            depth = np.load(path).astype(np.float32)
        else:
            depth = read_image_array(path).astype(np.float32)
        if depth.ndim == 2:
            depth = depth[..., None]
        return depth * scale

    def get_normal(self, idx: int) -> Optional[np.ndarray]:
        """The monocular normal prior [H, W, 3] in [-1, 1] (an npy in
        [0, 1], channels first or last, or an 8-bit image), or None."""
        files = self.metadata.get("normal_filenames")
        if not files:
            return None
        path = files[idx]
        if str(path).endswith(".npy"):
            n = np.load(path).astype(np.float32)
        else:
            n = read_image_array(path).astype(np.float32) / 255.0
        if n.ndim == 3 and n.shape[0] == 3 and n.shape[-1] != 3:
            n = np.moveaxis(n, 0, -1)
        return n * 2.0 - 1.0

    def get_semantics(self, idx: int) -> Optional[np.ndarray]:
        """Integer class labels [H, W] from the label images of
        metadata["semantics"]["filenames"] (the first channel), or None."""
        sem = self.metadata.get("semantics")
        if not sem or not sem.get("filenames"):
            return None
        arr = read_image_array(sem["filenames"][idx])
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr.astype(np.int32)

    def get_is_thermal(self, idx: int) -> float:
        vals = self.metadata.get("is_thermal")
        return float(vals[idx]) if vals is not None else 0.0

    @property
    def is_thermal(self) -> np.ndarray:
        vals = self.metadata.get("is_thermal")
        if vals is None:
            return np.zeros((len(self),), np.float32)
        return np.asarray(vals, np.float32)

    def preload(self):
        """Load every image into the cache now."""
        for i in range(len(self)):
            self.get_image(i)


# the reference's class name (thermal_dataset.py)
ThermalDataset = InputDataset
