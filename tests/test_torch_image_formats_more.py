"""The image formats Pillow opens beyond PNG / JPEG / TIFF / BMP / GIF /
WebP (netpbm with PFM, TGA, QOI, SGI, PCX / DCX, ICO / CUR, DDS BC1-BC7
and uncompressed, IM, Sun raster, DIB) through the port's decoders, against
Pillow and the JAX package's loader, on the fixtures of
tests/data/images_more/ and on the scene writer of phase 25 of
chip_smoke.py (tests/data/formats_scene/make_scene.py).

- Each fixture decodes bitwise to `np.asarray(Image.open(p))` (dtype,
  shape, bytes, Pillow's mode) and to its manifest entry; `image_size`
  equals Pillow's size.
- `load_image(p, s)` equals the JAX package's for s in {1, 0.5}: the
  16-bit PGM (mode "I") divided by 255 as JAX divides it, P1 / P4 bitmaps
  read as bool and resized with NEAREST.
- `get_depth` on PFM and 16-bit PGM depth maps equals JAX's.
- A file Pillow refuses (PF, P7, maxval 70000 and 0, a truncated RLE TGA,
  a TGA run across rows, the BUFR / GRIB / HDF5 / MPEG stubs Pillow opens
  but cannot load, ...) the port refuses with NotImplementedError.
- The opener comes from the bytes in Pillow's order: a CUR is not an ICO,
  a PCX-looking prefix that fails PCX's test opens as TGA, bytes that pass
  TGA's header test open as TGA, a netpbm file is one whatever its suffix;
  every one of Pillow's openers is either decoded or refused by name.
- The codec library has no fallback.
"""

import hashlib
import importlib.util
import io
import json
import math
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.data.dataparsers.base_dataparser import DataparserOutputs as JaxOutputs
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.datasets import load_image as jax_load_image
from nerfstudio_thermal_torch.data import raster_formats
from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import DataparserOutputs
from nerfstudio_thermal_torch.data.datasets import InputDataset, image_size, load_image, read_image

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = DATA / "images_more"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
READ = sorted(k for k, v in MANIFEST.items() if "sha256" in v)
REFUSED = sorted(k for k, v in MANIFEST.items() if "sha256" not in v)
KINDS = {"ppm", "tga", "qoi", "sgi", "pcx", "dcx", "ico", "cur", "dds", "im", "sun", "dib"}


def _scene_writer():
    spec = importlib.util.spec_from_file_location("make_scene", DATA / "formats_scene" / "make_scene.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    want = np.ascontiguousarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


def test_manifest_is_pillows_decode():
    files = {p.name for p in FIXTURES.iterdir() if p.suffix not in (".py", ".json")}
    assert set(MANIFEST) == files
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p.is_file()) <= 60_000
    assert {name.split("_")[0] for name in READ} == KINDS
    for name, rec in MANIFEST.items():
        if "pillow_raises" in rec:
            with pytest.raises(Exception):
                np.asarray(Image.open(FIXTURES / name))
            continue
        im = Image.open(FIXTURES / name)
        arr = np.ascontiguousarray(np.asarray(im))
        assert hashlib.sha256(arr.tobytes()).hexdigest() == rec["sha256"], name
        assert (list(arr.shape), str(arr.dtype), im.mode) == (rec["shape"], rec["dtype"], rec["mode"]), name


@pytest.mark.parametrize("name", READ)
def test_fixture_decodes_to_pillows_array(name):
    path, rec = FIXTURES / name, MANIFEST[name]
    arr, mode = read_image(path)
    assert mode == rec["mode"]
    assert _same(arr, np.asarray(Image.open(path)))
    assert hashlib.sha256(arr.tobytes()).hexdigest() == rec["sha256"]
    assert image_size(path) == Image.open(path).size


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("name", READ)
def test_load_image_matches_jax(name, scale):
    path = FIXTURES / name
    if min(Image.open(path).size) * scale < 1:  # Pillow refuses to resize to nothing
        with pytest.raises(ValueError):
            jax_load_image(path, scale)
        with pytest.raises(ValueError, match="must be > 0"):
            load_image(path, scale)
        return
    want, got = jax_load_image(path, scale), load_image(path, scale)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_reference_quirks_of_the_jax_loader():
    """A 16-bit PGM opens as mode "I" (int32 on 0-65535), which the JAX
    loader divides by 255, not 65535; maxval 100 rescales 50 to 128; P1 /
    P4 bitmaps are bool."""
    arr, mode = read_image(FIXTURES / "ppm_p5_16bit.pgm")
    assert (mode, arr.dtype) == ("I", np.int32) and arr.max() > 255
    np.testing.assert_array_equal(load_image(FIXTURES / "ppm_p5_16bit.pgm")[..., 0], arr.astype(np.float32) / 255)
    assert read_image(FIXTURES / "ppm_p5_maxval100.pgm")[0][0, 0] == 128
    for name in ("ppm_p1_plain.pbm", "ppm_p4.pbm"):
        arr, mode = read_image(FIXTURES / name)
        assert (mode, arr.dtype) == ("1", np.bool_)
    pfm, mode = read_image(FIXTURES / "ppm_pf_le.pfm")
    assert (mode, pfm.dtype) == ("F", np.float32)


def test_depth_maps_match_jax_get_depth():
    """depth-nerfacto's PFM and 16-bit PGM depth maps load as the JAX
    package's get_depth loads them."""
    names = ["ppm_pf_le.pfm", "ppm_pf_be.pfm", "ppm_p5_16bit.pgm", "ppm_p5_maxval1000.pgm"]
    meta = {"depth_filenames": [FIXTURES / n for n in names], "depth_unit_scale_factor": 0.25}
    files = [FIXTURES / "ppm_p6.ppm"] * len(names)
    box = np.zeros((2, 3), np.float32)
    port = InputDataset(DataparserOutputs(image_filenames=files, cameras=None, scene_box=box, metadata=meta))
    jax_ds = JaxDataset(JaxOutputs(image_filenames=files, cameras=None, scene_box=box, metadata=meta))
    for i in range(len(names)):
        got, want = port.get_depth(i), jax_ds.get_depth(i)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape and got.shape[-1] == 1
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_fixture(name):
    path = FIXTURES / name
    kind = name.split("_")[0]
    stub = kind.upper() if kind in ("bufr", "grib", "hdf5", "mpeg") else ""
    with pytest.raises(NotImplementedError, match=stub or None):  # a stub is refused by its name
        read_image(path)
    with pytest.raises(NotImplementedError):
        load_image(path)
    with pytest.raises(Exception):
        jax_load_image(path)


def _opened_alike(path: Path, fmt: str) -> None:
    im = Image.open(path)
    assert im.format == fmt
    arr, mode = read_image(path)
    assert mode == im.mode and _same(arr, np.asarray(im))
    for s in (1.0, 0.5):
        assert load_image(path, s).tobytes() == jax_load_image(path, s).tobytes()


def test_cur_is_not_an_ico(tmp_path):
    """The same directory and bitmaps as a cursor (type 2: the bitmap as it
    is) and as an icon (type 1: RGBA with the AND mask)."""
    data = (FIXTURES / "cur_two.cur").read_bytes()
    (tmp_path / "a.ico").write_bytes(data)
    (tmp_path / "b.cur").write_bytes(data[:2] + b"\1\0" + data[4:])
    _opened_alike(tmp_path / "a.ico", "CUR")
    _opened_alike(tmp_path / "b.cur", "ICO")


def test_pcx_looking_prefix_opens_as_tga(tmp_path):
    """A first byte of 10 with a second byte PCX's test refuses (1): the
    bytes pass TGA's header test (an id of 10 bytes, a colour map, image
    type 1), so Pillow opens a TGA."""
    head = bytes([10, 1, 1, 0, 0, 4, 0, 24, 0, 0, 0, 0, 7, 0, 5, 0, 8, 0x20])
    (tmp_path / "f.pcx").write_bytes(head + bytes(range(10)) + bytes(range(12)) + bytes(i % 4 for i in range(35)))
    _opened_alike(tmp_path / "f.pcx", "TGA")


def test_header_check_decides_tga(tmp_path):
    """Seeded bytes behind a valid TGA header open as TGA; with a depth TGA
    refuses (15) no opener takes them."""
    rng = np.random.default_rng(3)
    head = bytearray([0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 0, 4, 0, 24, 0])
    body = rng.integers(0, 256, 72, dtype=np.uint8).tobytes()
    (tmp_path / "noise.bin").write_bytes(bytes(head) + body)
    _opened_alike(tmp_path / "noise.bin", "TGA")
    head[16] = 15
    (tmp_path / "bad.bin").write_bytes(bytes(head) + body)
    with pytest.raises(Exception):
        Image.open(tmp_path / "bad.bin")
    with pytest.raises(NotImplementedError, match="not an image format"):
        read_image(tmp_path / "bad.bin")


def test_netpbm_with_a_wrong_suffix(tmp_path):
    for name, suffix in (("ppm_p5_16bit.pgm", ".png"), ("ppm_pf_be.pfm", ".tif"), ("sun_rle8.ras", ".jpg")):
        path = tmp_path / f"frame{suffix}"
        path.write_bytes((FIXTURES / name).read_bytes())
        _opened_alike(path, Image.open(FIXTURES / name).format)


def test_every_pillow_opener_is_read_or_refused_by_name():
    Image.init()
    read = {"BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "TIFF", "WEBP", "TGA", "QOI", "SGI", "PCX", "DCX", "ICO", "CUR",
            "DDS", "IM", "SUN"}
    assert len(Image.ID) == 43
    assert set(Image.ID) == read | set(raster_formats.REFUSED)
    assert not read & set(raster_formats.REFUSED)


def test_bcn_fixtures_cover_every_mode():
    """The BC7 fixture holds all 8 modes, each BC6H fixture all 14 modes
    and a reserved one."""
    bc7 = np.frombuffer((FIXTURES / "dds_bc7.dds").read_bytes()[148:], np.uint8).reshape(-1, 16)
    assert {(int(b) & -int(b)).bit_length() - 1 for b in bc7[:, 0]} == set(range(8))
    for name in ("dds_bc6h_uf16.dds", "dds_bc6h_sf16.dds"):
        blocks = np.frombuffer((FIXTURES / name).read_bytes()[148:], np.uint8).reshape(-1, 16)
        modes = {int(b & 3) if b & 3 < 2 else int(b & 31) for b in blocks[:, 0]}
        assert modes == {0, 1, *range(2, 31, 4), 3, 7, 11, 15, 19}


def test_scene_writer_matches_pillow(tmp_path):
    """Phase 25's writer (no Pillow, no port decoder) at a small size: each
    file's source array is Pillow's decode and the port's."""
    writer = _scene_writer()
    sources = {("rgbt", k): v for k, v in writer.write_thermal_scene(
        tmp_path / "rgbt", seed=5, rgb_hw=(12, 17), thermal_hw=(13, 17)).items()}
    sources.update({("depth", k): v for k, v in writer.write_depth_scene(
        tmp_path / "depth", seed=5, num=4, hw=(9, 14)).items()})
    kinds = set()
    for (scene, name), (arr, mode) in sources.items():
        im = Image.open(tmp_path / scene / name)
        assert im.mode == mode and _same(arr, np.asarray(im)), name
        got, got_mode = read_image(tmp_path / scene / name)
        assert got_mode == mode and _same(got, arr), name
        kinds.add(Path(name).suffix)
    assert kinds == {".ppm", ".qoi", ".tga", ".sgi", ".pcx", ".pgm", ".pfm"}
    frames = json.loads((tmp_path / "rgbt" / "transforms.json").read_text())["frames"]
    assert sum(f["is_thermal"] for f in frames) == writer.PAIRS and len(frames) == 2 * writer.PAIRS


def test_scene_writer_dds_is_every_bc7_mode(tmp_path):
    writer = _scene_writer()
    blocks = writer.bc7_blocks(np.random.default_rng(1), 16)
    data = writer.dds_bc7(blocks, 13, 13)
    (tmp_path / "a.dds").write_bytes(data)
    assert _same(read_image(tmp_path / "a.dds")[0], np.asarray(Image.open(tmp_path / "a.dds")))
    assert math.prod(np.asarray(Image.open(tmp_path / "a.dds")).shape) == 13 * 13 * 4


def _random_file(kind: str, rng: np.random.Generator) -> bytes:
    """A small file of `kind` with seeded header fields and bytes, valid or
    not: corrupt and truncated ones exercise the decoders' bounds and
    Pillow's quirks (SGI row lengths read as signed counts of codes, PCX
    bit planes one stride apart, a Sun raster's unpadded last row, TGA
    colour maps on grey images, ...)."""
    def r(n):
        return rng.integers(0, 256, max(n, 0), dtype=np.uint8).tobytes()

    def pick(*options):
        return options[int(rng.integers(0, len(options)))]

    w, h = int(rng.integers(1, 9)), int(rng.integers(1, 6))
    if kind == "tga":
        depth, cmap = pick(1, 8, 16, 24, 32), int(rng.integers(0, 2))
        n, md = (int(rng.integers(0, 5)), pick(16, 24, 32)) if cmap else (0, 0)
        head = struct.pack("<BBBHHBHHHHBB", int(rng.integers(0, 3)), cmap, pick(1, 2, 3, 9, 10, 11), 0, n, md, 0, 0, w,
                           h, depth, pick(0, 0x10, 0x20, 0x30, 8))
        return head + r(int(rng.integers(0, 3)) + n * md // 8 + int(rng.integers(0, w * h * 5)))
    if kind == "pcx":
        bits, planes = pick((1, 1), (1, 2), (1, 4), (8, 1), (8, 3), (2, 1))
        head = (struct.pack("<BBBBHHHHHH", 10, pick(5, 0, 2, 3), 1, bits, 0, 0, w - 1, h - 1, 72, 72) + r(48)
                + struct.pack("<BBHH", 0, planes, (w * bits + 7) // 8 + int(rng.integers(0, 2)), 1).ljust(64, b"\0"))
        body = bytes(0xC0 | int(rng.integers(0, 4)) if rng.random() < 0.3 else int(rng.integers(0, 0xC0))
                     for _ in range(int(rng.integers(0, 100))))
        return head + body + (b"\x0c" + r(768) if rng.random() < 0.7 else b"")
    if kind == "sun":
        depth, file_type = pick(1, 4, 8, 24, 32), pick(0, 1, 2, 3)
        pal = r(3 * int(rng.integers(1, 5))) if rng.random() < 0.3 else b""
        body = r(int(rng.integers(0, w * h * 5)))
        if file_type == 2:
            body = b"".join(bytes([0x80, int(rng.integers(0, 6)), int(rng.integers(0, 256))]) if rng.random() < 0.3
                            else r(1) for _ in range(int(rng.integers(0, 60))))
        return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), file_type, int(bool(pal)), len(pal)) + pal + body
    if kind == "sgi":
        pixels = rng.integers(0, 256, (h, w, pick(1, 3, 4)), dtype=np.uint8)
        data = bytearray(_scene_writer().sgi(pixels[..., 0] if pixels.shape[2] == 1 else pixels,
                                             rle=bool(rng.integers(0, 2))))
        if rng.random() < 0.5:  # one byte of the tables or codes changed
            data[int(rng.integers(512, len(data)))] = int(rng.integers(0, 256))
        return bytes(data[:int(rng.integers(len(data) - 8, len(data) + 1))])
    if kind == "ppm":
        magic, maxval = pick(b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf"), pick(1, 7, 100, 255, 256, 1000, 65535)
        head = magic + b"\n%d %d\n" % (w, h) + (b"%d\n" % maxval if magic in (b"P2", b"P3", b"P5", b"P6") else b"")
        head += pick(b"-1.0\n", b"1.0\n") if magic == b"Pf" else b""
        if magic in (b"P1", b"P2", b"P3"):
            n = w * h * (3 if magic == b"P3" else 1) + int(rng.integers(-1, 2))
            top = 2 if magic == b"P1" else maxval + 1
            tokens = b" ".join(b"%d" % int(rng.integers(0, top)) for _ in range(max(n, 0)))
            return head + tokens.replace(b" ", b"#c\n", 1)  # a comment joining two tokens
        return head + r(int(rng.integers(0, w * h * 8)))
    if kind == "dds":
        fourcc = pick(b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"BC5U", b"BC5S", b"DX10")
        masks = [int(rng.integers(0, 2**16)) for _ in range(4)]
        pf = pick(struct.pack("<II4sI4I", 32, 4, fourcc, 0, 0, 0, 0, 0),
                  struct.pack("<II4sI4I", 32, pick(0x40, 0x41), bytes(4), pick(16, 24, 32), *masks),
                  struct.pack("<II4sI4I", 32, pick(0x20000, 0x20001, 0x20), bytes(4), pick(8, 16), 0, 0, 0, 0))
        dx10 = struct.pack("<5I", pick(71, 74, 77, 80, 83, 84, 95, 96, 98, 28), 3, 0, 1, 0) if b"DX10" in pf else b""
        return (struct.pack("<4sIIIIIII", b"DDS ", 124, 0x1007, h, w, 0, 0, 1) + bytes(44) + pf + bytes(20) + dx10
                + r(int(rng.integers(0, 400))))
    if kind in ("ico", "cur"):
        bits = pick(1, 4, 8, 16, 24, 32)
        colours = int(rng.integers(0, 5)) if bits <= 8 else 0
        dib = (struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, pick(0, 0, 0, 1, 2), 0, 0, 0, colours, 0)
               + r((colours or (1 << bits)) * 4 if bits <= 8 else 0)
               + r((((w * bits + 31) >> 3) & ~3) * h + (w + 31) // 32 * 4 * h + int(rng.integers(-8, 4))))
        return (struct.pack("<HHHBBBBHHII", 0, 1 if kind == "ico" else 2, 1, w, h, colours, 0, 1, pick(0, bits, 32),
                            len(dib), 22) + dib)
    # IM
    image_type = pick("0 1", "L 1", "Greyscale", "RGB", "B2", "B4", "X 24", "L 32 S", "L 32 F", "LA", "PA", "RGBA",
                      "RGBX", "CMYK", "YCC", "L 8S", "L 16", "L 16S", "L 32F", "L 16B", "L 32S", "L*12", "RGB3")
    head = f"Image type: {image_type} image\r\nImage size (x*y): {w}*{h}\r\n".encode()
    head += b"Lut: 1\r\n" if rng.random() < 0.3 else b""
    return head.ljust(511, b"\0") + b"\x1a" + (r(768) if b"Lut" in head else b"") + r(int(rng.integers(0, w * h * 5)))


@pytest.mark.parametrize("kind", ["tga", "pcx", "sun", "sgi", "ppm", "dds", "ico", "cur", "im"])
def test_seeded_files_decode_or_fail_as_pillow(kind, tmp_path):
    """60 seeded files a kind: where Pillow decodes one, the port gives its
    array and mode bitwise; where Pillow raises, the port raises
    NotImplementedError."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    path = tmp_path / "f"
    for i in range(60):
        data = _random_file(kind, rng)
        path.write_bytes(data)
        try:
            im = Image.open(path)
            want, want_mode = np.asarray(im), im.mode
        except Exception:
            with pytest.raises(NotImplementedError):
                read_image(path)
            continue
        arr, mode = read_image(path)
        assert mode == want_mode and _same(arr, want), (kind, i, data[:32])


def test_bitmaps_read_as_pillow_reads_them(tmp_path):
    """BMP repairs: the last row stored needs no padding (Pillow's raw
    decoder stops at its last pixel), an RLE bitmap of more than 8 bits is
    refused (Pillow cannot unpack it), and a DIB's RLE codes align to the
    file's positions."""
    rgb = np.arange(45, dtype=np.uint8).reshape(3, 5, 3)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "BMP")
    (tmp_path / "short.bmp").write_bytes(buf.getvalue()[:-1])
    _opened_alike(tmp_path / "short.bmp", "BMP")
    rle24 = bytearray(buf.getvalue())
    rle24[30] = 1
    (tmp_path / "rle24.bmp").write_bytes(bytes(rle24))
    with pytest.raises(Exception):
        np.asarray(Image.open(tmp_path / "rle24.bmp"))
    with pytest.raises(NotImplementedError, match="24-bit RLE"):
        read_image(tmp_path / "rle24.bmp")
    # an 8-bit RLE icon at an odd offset, whose absolute run ends on an odd position
    pal = bytes(range(16))
    codes = bytes([0, 3, 1, 2, 3, 0, 2, 4]) + bytes([0, 0]) + bytes([3, 1, 0, 0])
    dib = struct.pack("<IiiHHIIiiII", 40, 3, 4, 1, 8, 1, len(codes), 0, 0, 4, 0) + pal + codes + bytes(8)
    ico = struct.pack("<HHHBBBBHHII", 0, 1, 1, 3, 2, 4, 0, 1, 8, len(dib), 23) + b"\0" + dib
    (tmp_path / "rle.ico").write_bytes(ico)
    _opened_alike(tmp_path / "rle.ico", "ICO")


def test_raster_codecs_without_a_compiler_raise(monkeypatch):
    """No fallback: when the codec library cannot be built, an RLE TGA, a
    QOI, an RLE SGI, a PCX, a plain PGM, an RLE Sun raster and a BC7 DDS do
    not load."""
    def no_compiler(source, stem):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(raster_formats, "_lib", None)
    monkeypatch.setattr(raster_formats, "build_library", no_compiler)
    for name in ("tga_rle_rgb24.tga", "qoi_rgb.qoi", "sgi_rle_rgb.sgi", "pcx_rgb.pcx", "ppm_p2_plain_maxval100.pgm",
                 "sun_rle24.ras", "dds_bc7.dds"):
        with pytest.raises(RuntimeError, match="could not be built"):
            load_image(FIXTURES / name)
    assert raster_formats.identify((FIXTURES / "dds_bc7.dds").read_bytes()) == "dds"
