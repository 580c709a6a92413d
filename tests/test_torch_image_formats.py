"""TIFF (every compression Pillow 12.1's libtiff decodes: none, PackBits, LZW,
Deflate, JPEG, LZMA, Zstandard, CCITT RLE / T.4 / T.6; CMYK and CIELAB;
orientations; BigTIFF), BMP, GIF, WebP (lossless, lossy, alpha, animated)
and the remaining JPEG modes (CMYK / YCCK, block-smoothed progressions,
lossless, arithmetic-coded) through the port's decoders, against Pillow
and the JAX package's loader, on the committed fixtures of
tests/data/images/.

- Each fixture decodes bitwise to `np.asarray(Image.open(p))` (dtype,
  shape, bytes, Pillow's mode) and to its manifest entry, which the card's
  machine (no Pillow) checks against.
- `load_image(p, s)` equals the JAX package's for s in {1, 0.5}: Pillow's
  BILINEAR for L, LA, RGB, RGBA, CMYK, I;16, I;16B (resampled as Pillow
  does, little-endian), I and F; NEAREST for P and 1; the JAX loader's
  division by 255 of float and big-endian 16-bit images kept. Where Pillow
  refuses the resize, both raise.
- A file Pillow refuses (12-bit and hierarchical JPEG, a lossless JPEG
  that needs a colour conversion, WebP and JPEG 2000 strips in a TIFF, an
  uncompressed YCbCr TIFF, a big-endian BigTIFF, unknown bytes) the port
  refuses too, with NotImplementedError.
- The format comes from the first bytes, not the suffix; `image_size`
  equals Pillow's size; the depth of a float32 TIFF loads as JAX's
  `get_depth`; the codec library has no fallback.
"""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerfstudio_thermal_tpu.data.dataparsers.base_dataparser import DataparserOutputs as JaxOutputs
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.datasets import load_image as jax_load_image
from nerfstudio_thermal_torch.data import image_formats, webp
from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import DataparserOutputs
from nerfstudio_thermal_torch.data.datasets import InputDataset, image_size, load_image, read_image

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
READ = sorted(k for k, v in MANIFEST.items() if "sha256" in v)
REFUSED = sorted(k for k, v in MANIFEST.items() if "sha256" not in v)


def _pillow(path):
    return np.asarray(Image.open(path))


def test_manifest_is_pillows_decode():
    files = {p.name for p in FIXTURES.iterdir() if p.suffix not in (".py", ".json")}
    assert set(MANIFEST) == files
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 300_000
    kinds = {name.split("_")[0] for name in READ}
    assert kinds == {"tiff", "bmp", "gif", "jpeg", "webp"}
    for name, rec in MANIFEST.items():
        if "pillow_raises" in rec:
            with pytest.raises(Exception):
                _pillow(FIXTURES / name)
            continue
        im = Image.open(FIXTURES / name)
        arr = np.ascontiguousarray(np.asarray(im))
        assert hashlib.sha256(arr.tobytes()).hexdigest() == rec["sha256"], name
        assert (list(arr.shape), str(arr.dtype), im.mode) == (rec["shape"], rec["dtype"], rec["mode"]), name


@pytest.mark.parametrize("name", READ)
def test_fixture_decodes_to_pillows_array(name):
    path, rec = FIXTURES / name, MANIFEST[name]
    arr, mode = read_image(path)
    want = _pillow(path)
    assert (arr.dtype, arr.shape, mode.split(":")[0]) == (want.dtype, want.shape, rec["mode"])
    assert arr.tobytes() == np.ascontiguousarray(want).tobytes()
    assert hashlib.sha256(arr.tobytes()).hexdigest() == rec["sha256"]
    assert image_size(path) == Image.open(path).size


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("name", READ)
def test_load_image_matches_jax(name, scale):
    path = FIXTURES / name
    try:
        want = jax_load_image(path, scale)
    except ValueError:  # Pillow cannot resize it ("L" over a palette image)
        assert scale != 1.0
        with pytest.raises(ValueError, match="wrong mode"):
            load_image(path, scale)
        return
    got = load_image(path, scale)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", REFUSED)
def test_refused_fixture(name):
    path, rec = FIXTURES / name, MANIFEST[name]
    with pytest.raises(NotImplementedError):
        read_image(path)
    with pytest.raises(NotImplementedError):
        load_image(path)
    assert "pillow_raises" in rec
    with pytest.raises(Exception):
        jax_load_image(path)


def test_unknown_bytes_are_refused_by_both(tmp_path):
    p = tmp_path / "noise.tif"
    p.write_bytes(b"\x00\x01\x02\x03 not an image" * 4)
    with pytest.raises(NotImplementedError, match="not an image format"):
        load_image(p)
    with pytest.raises(Exception):
        jax_load_image(p)


def test_format_comes_from_the_bytes_not_the_suffix(tmp_path):
    """A PNG named .jpg, a TIFF named .png, a BMP named .tif: each loads as
    Pillow loads it."""
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)).save(tmp_path / "a.png")
    shutil.copy(tmp_path / "a.png", tmp_path / "png.jpg")
    shutil.copy(FIXTURES / "tiff_pillow_grey16_deflate.tif", tmp_path / "tiff.png")
    shutil.copy(FIXTURES / "bmp_rle8.bmp", tmp_path / "bmp.tif")
    for name in ("png.jpg", "tiff.png", "bmp.tif"):
        for s in (1.0, 0.5):
            want = jax_load_image(tmp_path / name, s)
            got = load_image(tmp_path / name, s)
            assert got.tobytes() == want.tobytes() and got.shape == want.shape, (name, s)


def test_float_tiff_depth_matches_jax_get_depth(tmp_path):
    """depth-nerfacto's float32 TIFF depth maps (and 16-bit ones) load as
    the JAX package's get_depth loads them."""
    names = ["tiff_pillow_float_adobe_deflate.tif", "tiff_ii_float_pred3.tif", "tiff_pillow_grey16_lzw.tif"]
    meta = {"depth_filenames": [FIXTURES / n for n in names], "depth_unit_scale_factor": 0.25}
    files = [FIXTURES / "bmp_pillow_rgb.bmp"] * len(names)
    box = np.zeros((2, 3), np.float32)
    port = InputDataset(DataparserOutputs(image_filenames=files, cameras=None, scene_box=box, metadata=meta))
    jax_ds = JaxDataset(JaxOutputs(image_filenames=files, cameras=None, scene_box=box, metadata=meta))
    for i in range(len(names)):
        got, want = port.get_depth(i), jax_ds.get_depth(i)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape and got.shape[-1] == 1
        np.testing.assert_array_equal(got, want)


def test_codecs_without_a_compiler_raise(monkeypatch):
    """No fallback: when the codec library cannot be built, an LZW TIFF, an
    RLE BMP and a GIF do not load."""
    def no_compiler(source, stem):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(image_formats, "_lib", None)
    monkeypatch.setattr(image_formats, "build_library", no_compiler)
    for name in ("tiff_pillow_rgb_lzw.tif", "bmp_rle4.bmp", "gif_pillow.gif", "tiff_pillow_thermal16_zstd_pred2.tif",
                 "tiff_ccitt_g4_fill1.tif"):
        with pytest.raises(RuntimeError, match="could not be built"):
            load_image(FIXTURES / name)


def test_webp_without_a_compiler_raises(monkeypatch):
    """No fallback for WebP either."""
    def no_compiler(source, stem):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(webp, "_lib", None)
    monkeypatch.setattr(webp, "build_library", no_compiler)
    for name in ("webp_lossy.webp", "webp_lossless_rgba.webp"):
        with pytest.raises(RuntimeError, match="could not be built"):
            load_image(FIXTURES / name)


# a scene of this slice's formats: RGB as lossy WebP, thermal as 16-bit Zstandard TIFF with
# predictor 2, a CMYK frame, and frames turned by orientations 3 and 6
SLICE_FRAMES = ["webp_lossy.webp", "tiff_pillow_thermal16_zstd_pred2.tif", "tiff_pillow_cmyk_zstd.tif",
                "tiff_orient3_rgb_lzw.tif", "tiff_orient6_grey16_zstd.tif"]


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("name", SLICE_FRAMES)
def test_slice_frames_load_as_the_jax_dataset_loads_them(name, scale):
    """InputDataset.get_image of both packages on the same file, at
    camera_res_scale_factor 1 and 0.5: equal arrays, tolerance 0 (the
    port's resize computes Pillow's rounding, so nothing is left to
    tolerate); a CMYK frame enters as four channels, as in JAX."""
    box = np.zeros((2, 3), np.float32)
    files = [FIXTURES / name]
    port = InputDataset(DataparserOutputs(image_filenames=files, cameras=None, scene_box=box, metadata={}), scale)
    jax_ds = JaxDataset(JaxOutputs(image_filenames=files, cameras=None, scene_box=box, metadata={}), scale)
    got, want = port.get_image(0), jax_ds.get_image(0)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if "cmyk" in name:
        assert got.shape[-1] == 4
