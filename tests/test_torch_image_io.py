"""The port's image loading against Pillow and the JAX package's loader, on
the CPU.

- The JPEG decoder (native/jpeg_decoder.cpp, built with g++ at first use)
  against `np.asarray(Image.open(p))` on files Pillow (and, for the 4:4:0
  and 4:1:1 samplings Pillow cannot write, OpenCV) writes in the test:
  4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, greyscale, restart intervals,
  quality 50 and 95, sizes from 1x1 to 130x77 with partial MCUs. Equal
  bytes in every mode (no tolerance).
- Progressive files (RGB 4:4:4, 4:2:2, 4:2:0, greyscale, odd sizes,
  restart intervals) decode to Pillow's bytes and `load_image` of each
  equals the JAX package's; CMYK files raise NotImplementedError naming
  what they are; a decoder that cannot be built raises on every JPEG (no
  fallback).
- `camera_res_scale_factor`: `load_image(p, s)` against the JAX package's
  (Pillow's `resize(..., BILINEAR)`) at 0.5, 0.25 and 0.37 and for 1.5,
  for L, LA, RGB, RGBA, 16-bit grey, JPEG and palette images: equal.
- PNGs Pillow reads in its own way: palette (the indices, 1- to 8-bit),
  1/2/4-bit grey, 16-bit RGB / RGBA / grey+alpha (the high byte): equal
  to the JAX loader. Adam7-interlaced PNGs (written here: Pillow cannot
  write them) of colour types 0/2/3/4/6 at 8 bits, 16-bit grey and
  1/2/4-bit grey, with every filter type: equal to Pillow's array and to
  the JAX loader.
- `get_depth`, `get_normal`, `get_semantics` against the JAX
  InputDataset's on 16-bit PNG and npy depth, npy (channels first and
  last) and PNG normals, palette and RGB label PNGs: equal.
- The committed fixtures of tests/data/jpeg/ (JPEG and PNG): Pillow's
  decode of each matches its manifest entry (hash, shape), and the port's
  decode does too.
"""

import hashlib
import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.datasets import load_image as jax_load_image

from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.data import jpeg
from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import DataparserOutputs
from nerfstudio_thermal_torch.data.datasets import InputDataset, decode_png, image_size, load_image, read_image_array

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
SIZES = [(1, 1), (2, 3), (3, 2), (9, 17), (23, 37), (48, 64), (77, 130)]


def smooth(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) for k in range(c)], -1) * 100 + 128
    return np.clip(base + rng.normal(0, 20, (h, w, c)), 0, 255).astype(np.uint8)


def _pillow(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("mode", ["444", "422", "420", "grey"])
def test_jpeg_matches_pillow(tmp_path, hw, mode):
    h, w = hw
    arr = smooth(h, w, 3 if mode != "grey" else 1)
    im = Image.fromarray(arr if mode != "grey" else arr[..., 0])
    kw = {} if mode == "grey" else {"subsampling": {"444": 0, "422": 1, "420": 2}[mode]}
    for quality in (50, 95):
        for restart in (0, 2):
            p = tmp_path / f"q{quality}_r{restart}.jpg"
            im.save(p, quality=quality, **kw, **({"restart_marker_blocks": restart} if restart else {}))
            want = _pillow(p)
            got = jpeg.decode_jpeg(p)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{mode} q{quality} restart {restart}")
            assert image_size(p) == (w, h)


@pytest.mark.parametrize("factor", ["440", "411"])
def test_jpeg_other_samplings_match_pillow(tmp_path, factor):
    cv2 = __import__("cv2")
    for h, w in SIZES[2:]:
        p = tmp_path / f"{factor}_{h}x{w}.jpg"
        cv2.imwrite(str(p), smooth(h, w, 3)[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")])
        np.testing.assert_array_equal(jpeg.decode_jpeg(p), _pillow(p), err_msg=f"{factor} {h}x{w}")


# progressive files decode as Pillow does; CMYK and a truncated header raise
UNSUPPORTED_CASES = [
    ("progressive_444", (16, 24), {"subsampling": 0}),
    ("progressive_422", (23, 37), {"subsampling": 1}),
    ("progressive_420", (48, 64), {"subsampling": 2}),
    ("progressive_420_odd", (77, 130), {"subsampling": 2, "quality": 50}),
    ("progressive_420_1x1", (1, 1), {"subsampling": 2}),
    ("progressive_420_restart", (23, 37), {"subsampling": 2, "restart_marker_blocks": 2}),
    ("progressive_444_restart", (9, 17), {"subsampling": 0, "restart_marker_blocks": 1, "quality": 95}),
    ("progressive_grey", (23, 37), {}),
    ("progressive_grey_restart", (48, 64), {"restart_marker_blocks": 3}),
    ("cmyk", (8, 8), {}),
    ("junk", (0, 0), {}),
]


@pytest.mark.parametrize("case,hw,kw", UNSUPPORTED_CASES, ids=[c[0] for c in UNSUPPORTED_CASES])
def test_unsupported_jpegs_raise(tmp_path, case, hw, kw):
    p = tmp_path / f"{case}.jpg"
    if case == "cmyk":
        Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(p)
        with pytest.raises(NotImplementedError, match="CMYK"):
            load_image(p)
        return
    if case == "junk":
        p.write_bytes(b"\xff\xd8\xff\xc0\x00")
        with pytest.raises(ValueError):
            load_image(p)
        return
    grey = case.startswith("progressive_grey")
    arr = smooth(*hw, 3)
    Image.fromarray(arr[..., 0] if grey else arr).save(p, progressive=True, **kw)
    assert b"\xff\xc2" in p.read_bytes()
    want = _pillow(p)
    got = jpeg.decode_jpeg(p)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert image_size(p) == (hw[1], hw[0])
    for s in (1.0, 0.5) if min(hw) > 1 else (1.0,):
        np.testing.assert_array_equal(load_image(p, s), jax_load_image(p, s), err_msg=f"scale {s}")


def test_progressive_jpeg_that_libjpeg_would_smooth_raises(tmp_path):
    """A progression cut after its first scans leaves AC coefficients short
    of full precision, where libjpeg smooths the blocks: the decoder
    refuses it rather than give other bytes than Pillow."""
    Image.fromarray(smooth(40, 56, 3)).save(tmp_path / "full.jpg", progressive=True, quality=80)
    data = (tmp_path / "full.jpg").read_bytes()
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    (tmp_path / "cut.jpg").write_bytes(data[:scans[2]] + b"\xff\xd9")
    with pytest.raises(NotImplementedError, match="block smoothing"):
        jpeg.decode_jpeg(tmp_path / "cut.jpg")
    np.testing.assert_array_equal(jpeg.decode_jpeg(tmp_path / "full.jpg"), _pillow(tmp_path / "full.jpg"))


def test_jpeg_without_a_decoder_raises(tmp_path, monkeypatch):
    """No fallback: when the library cannot be built, a JPEG does not load."""
    Image.fromarray(smooth(8, 8, 3)).save(tmp_path / "a.jpg")

    def no_compiler(source, stem):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(jpeg, "build_library", no_compiler)
    with pytest.raises(RuntimeError, match="could not be built"):
        load_image(tmp_path / "a.jpg")


def _write_png(path, rows: np.ndarray, width: int, depth: int, ctype: int, palette: bytes = None):
    """A PNG from packed rows (uint8, or >u2 for 16-bit samples)."""
    h = rows.shape[0]
    raw = rows.astype(">u2").tobytes() if depth == 16 else rows.astype(np.uint8).tobytes()
    stride = len(raw) // h
    data = b"".join(b"\x00" + raw[i * stride:(i + 1) * stride] for i in range(h))

    def chunk(kind, body):
        return len(body).to_bytes(4, "big") + kind + body + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big")

    header = width.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([depth, ctype, 0, 0, 0])
    body = chunk(b"IHDR", header) + (chunk(b"PLTE", palette) if palette else b"")
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _pack(idx: np.ndarray, depth: int) -> np.ndarray:
    if depth == 8:
        return idx
    per = 8 // depth
    pad = (-idx.shape[1]) % per
    p = np.concatenate([idx, np.zeros((idx.shape[0], pad), np.uint8)], 1).reshape(idx.shape[0], -1, per)
    packed = np.zeros(p.shape[:2], np.uint8)
    for k in range(per):
        packed |= (p[..., k] << (8 - depth * (k + 1))).astype(np.uint8)
    return packed


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """PNG-filter packed rows [h, stride] (uint8), row r with type r % 5."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r, row in enumerate(rows.astype(np.int32)):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pa, pb, pc = (np.abs(left + prev - upleft - v) for v in (left, prev, upleft))
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) >> 1, paeth][r % 5]
        out.append(bytes([r % 5]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _write_adam7_png(path, img: np.ndarray, depth: int, ctype: int, palette: bytes = None):
    """An Adam7-interlaced PNG of samples [H, W, C] (uint8, or uint16 at
    16 bits): each pass packed and filtered as an image of its own."""
    h, w, c = img.shape
    data = b""
    for x0, y0, dx, dy in ADAM7:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = np.frombuffer(sub.astype(">u2").tobytes(), np.uint8).reshape(sub.shape[0], -1)
        else:
            rows = _pack(sub.reshape(sub.shape[0], -1).astype(np.uint8), depth)
        data += _filter_rows(rows, max(c * depth // 8, 1))

    def chunk(kind, body):
        return len(body).to_bytes(4, "big") + kind + body + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big")

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([depth, ctype, 0, 0, 1])
    body = chunk(b"IHDR", header) + (chunk(b"PLTE", palette) if palette else b"")
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


# (colour type, bits, channels)
ADAM7_CASES = [(0, 8, 1), (2, 8, 3), (3, 8, 1), (4, 8, 2), (6, 8, 4), (0, 16, 1), (0, 1, 1), (0, 2, 1), (0, 4, 1)]


@pytest.mark.parametrize("ctype,depth,c", ADAM7_CASES, ids=[f"type{t}_{d}bit" for t, d, _ in ADAM7_CASES])
def test_interlaced_pngs_match_pillow_and_jax(tmp_path, ctype, depth, c):
    rng = np.random.default_rng(10 * ctype + depth)
    top = 16 if ctype == 3 else 1 << depth
    palette = bytes(rng.integers(0, 256, 48).astype(np.uint8)) if ctype == 3 else None
    for h, w in ((1, 1), (2, 3), (5, 1), (9, 13), (23, 37)):
        img = rng.integers(0, top, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)
        p = tmp_path / f"{h}x{w}.png"
        _write_adam7_png(p, img, depth, ctype, palette)
        assert Image.open(p).info.get("interlace") == 1
        # Pillow's mode "1" array is bool; the port gives 0 / 1 as uint8, interlaced or not
        want = _pillow(p).astype(np.uint8) if depth == 1 else _pillow(p)
        got = read_image_array(p)
        assert got.dtype == want.dtype and got.shape == want.shape, (h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(load_image(p), jax_load_image(p), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_and_low_bit_pngs_match_jax(tmp_path, depth):
    rng = np.random.default_rng(depth)
    idx = rng.integers(0, min(16, 2**depth), (9, 13)).astype(np.uint8)
    palette = bytes(rng.integers(0, 256, 3 * min(16, 2**depth)).astype(np.uint8))
    for ctype in (3, 0):
        p = tmp_path / f"c{ctype}.png"
        _write_png(p, _pack(idx, depth), 13, depth, ctype, palette if ctype == 3 else None)
        np.testing.assert_array_equal(read_image_array(p), _pillow(p).astype(np.uint8))
        for s in (1.0, 0.5, 0.37):
            np.testing.assert_array_equal(load_image(p, s), jax_load_image(p, s), err_msg=f"{ctype} {s}")


def test_sixteen_bit_colour_pngs_match_jax(tmp_path):
    """Pillow reads 16-bit RGB, RGBA and grey+alpha PNGs as 8-bit (their
    high byte; grey+alpha as RGBA) and 16-bit grey as uint16; the port's
    decoder gives the same."""
    rng = np.random.default_rng(0)
    for ctype, c in ((0, 1), (2, 3), (4, 2), (6, 4)):
        p = tmp_path / f"c{ctype}.png"
        _write_png(p, rng.integers(0, 65536, (5, 6 * c)).astype(np.uint16), 6, 16, ctype)
        want = _pillow(p)
        got = read_image_array(p)
        assert got.dtype == want.dtype and got.shape == want.shape, ctype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(load_image(p), jax_load_image(p))


@pytest.mark.parametrize("scale", [0.5, 0.25, 0.37, 1.5])
def test_resize_matches_pillow_bilinear(tmp_path, scale):
    rng = np.random.default_rng(1)
    arrays = {
        "l.png": rng.integers(0, 256, (61, 83), dtype=np.uint8),
        "la.png": rng.integers(0, 256, (61, 83, 2), dtype=np.uint8),
        "rgb.png": smooth(61, 83, 3),
        "rgba.png": rng.integers(0, 256, (61, 83, 4), dtype=np.uint8),
        "grey16.png": rng.integers(0, 65536, (61, 83), dtype=np.uint16),
    }
    for name, arr in arrays.items():
        Image.fromarray(arr).save(tmp_path / name)
    Image.fromarray(smooth(61, 83, 3)).save(tmp_path / "rgb.jpg", quality=90)
    for p in sorted(tmp_path.iterdir()):
        got, want = load_image(p, scale), jax_load_image(p, scale)
        assert got.shape == want.shape, p.name
        np.testing.assert_array_equal(got, want, err_msg=p.name)


def _dataset(cls, tmp_path, metadata):
    cams = dict(camera_to_worlds=np.zeros((2, 3, 4), np.float32), fx=np.ones(2, np.float32),
                fy=np.ones(2, np.float32), cx=np.ones(2, np.float32), cy=np.ones(2, np.float32),
                width=np.full(2, 8, np.int32), height=np.full(2, 6, np.int32))
    if cls is JaxDataset:
        from nerfstudio_thermal_tpu.cameras.cameras import Cameras as JaxCameras
        from nerfstudio_thermal_tpu.data.dataparsers.base_dataparser import DataparserOutputs as JaxOutputs

        return cls(JaxOutputs([tmp_path / "a.png"] * 2, JaxCameras(**cams), np.zeros((2, 3)), metadata=metadata))
    cameras = Cameras(**{k: torch.as_tensor(v) for k, v in cams.items()})
    return cls(DataparserOutputs([tmp_path / "a.png"] * 2, cameras, np.zeros((2, 3)), metadata=metadata))


def test_depth_normal_semantics_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 65536, (6, 8), dtype=np.uint16)).save(tmp_path / "d0.png")
    np.save(tmp_path / "d1.npy", rng.uniform(0, 5, (6, 8)).astype(np.float32))
    np.save(tmp_path / "n0.npy", rng.uniform(0, 1, (3, 6, 8)).astype(np.float32))
    Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)).save(tmp_path / "n1.png")
    pal = Image.fromarray(rng.integers(0, 5, (6, 8), dtype=np.uint8), "P")
    pal.putpalette([int(v) for v in rng.integers(0, 256, 15)])
    pal.save(tmp_path / "s0.png")
    Image.fromarray(rng.integers(0, 7, (6, 8, 3), dtype=np.uint8)).save(tmp_path / "s1.png")
    metadata = {
        "depth_filenames": [tmp_path / "d0.png", tmp_path / "d1.npy"],
        "depth_unit_scale_factor": 2e-3,
        "normal_filenames": [tmp_path / "n0.npy", tmp_path / "n1.png"],
        "semantics": {"filenames": [tmp_path / "s0.png", tmp_path / "s1.png"]},
    }
    port, ref = _dataset(InputDataset, tmp_path, metadata), _dataset(JaxDataset, tmp_path, metadata)
    for i in range(2):
        for getter in ("get_depth", "get_normal", "get_semantics"):
            got, want = getattr(port, getter)(i), getattr(ref, getter)(i)
            assert got.dtype == want.dtype and got.shape == want.shape, (getter, i)
            np.testing.assert_array_equal(got, want, err_msg=f"{getter} {i}")
    empty = _dataset(InputDataset, tmp_path, {})
    assert empty.get_depth(0) is None and empty.get_normal(0) is None and empty.get_semantics(0) is None


def _manifest():
    return json.loads((FIXTURES / "manifest.json").read_text())


def test_fixture_manifest_is_pillows_decode():
    """Pillow's decode of every committed fixture hashes to its manifest
    entry (the card's machine, which has no Pillow, checks against these)."""
    manifest = _manifest()
    assert set(manifest) == {p.relative_to(FIXTURES).as_posix() for p in [*FIXTURES.rglob("*.jpg"),
                                                                          *FIXTURES.rglob("*.png")]}
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file()) < 1 << 20
    for name, rec in manifest.items():
        arr = np.ascontiguousarray(_pillow(FIXTURES / name))
        assert hashlib.sha256(arr.tobytes()).hexdigest() == rec["sha256"], name
        assert list(arr.shape) == rec["shape"] and str(arr.dtype) == rec["dtype"], name


def test_port_decodes_the_fixtures_to_the_manifest():
    for name, rec in _manifest().items():
        if rec.get("port_raises"):
            with pytest.raises(NotImplementedError):
                jpeg.decode_jpeg(FIXTURES / name)
            continue
        arr = read_image_array(FIXTURES / name)
        assert hashlib.sha256(arr.tobytes()).hexdigest() == rec["sha256"], name
        assert list(arr.shape) == rec["shape"], name
