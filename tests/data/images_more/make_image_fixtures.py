"""Write the netpbm, TGA, QOI, SGI, PCX / DCX, ICO / CUR, DDS, IM, Sun and
DIB fixtures of this directory and manifest.json (per file Pillow's mode
and the SHA-256, shape and dtype of `np.asarray(Image.open(path))`, or
"pillow_raises"), from seed 0. Run with Pillow:

    python tests/data/images_more/make_image_fixtures.py

Pillow writes what it can; the rest is built here byte by byte, with the
encoders of tests/data/formats_scene/make_scene.py where they fit (plain
netpbm, rescaled maxvals, TGA maps and origins, RLE TGA / SGI / PCX, PCX
bit planes, DCX, ICO AND masks, CUR, BCn blocks with each BC7 / BC6H mode
forced, DDS bit masks, Sun rasters) as are the refusal witnesses.
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent / "formats_scene"))

import make_scene as enc  # noqa: E402

rng = np.random.default_rng(0)
H, W = 5, 7
FILES = {}


def rand(*shape, hi=256, dtype=np.uint8):
    return rng.integers(0, hi, shape, dtype=dtype)


def smooth(h, w, c):
    """Runs and steps with a few random pixels."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x // 3 * 20 + k * 60 + y) % 256 for k in range(c)], -1)
    img[rng.random((h, w)) < 0.2] = rand(c)
    return img.astype(np.uint8)


def pil(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# ---- netpbm


def plain(magic: bytes, vals: np.ndarray, maxval=None, width=W, height=H) -> bytes:
    """Plain netpbm with comments between header tokens and in the data."""
    head = magic + b"\n# a comment\n%d %d\n" % (width, height) + (b"%d\n" % maxval if maxval else b"")
    rows = [b" ".join(b"%d" % v for v in row) for row in vals.reshape(height, -1)]
    return head + b"\n# data\n".join(rows) + b"\n"


grey = rand(H, W)
FILES["ppm_p1_plain.pbm"] = (b"P1\n#c\n7 5\n" + b"\n".join(b"".join(b"%d" % v for v in r) for r in rand(H, W, hi=2))
                             + b"\n")
v1000 = rand(H, W, hi=1001, dtype=np.int64)
FILES["ppm_p2_plain_maxval1000.pgm"] = plain(b"P2", v1000, 1000)
v100 = rand(H, W, hi=101, dtype=np.int64)
v100[0, :3] = 50, 49, 51  # 50 / 100 * 255 = 127.5 rounds to even, 128
FILES["ppm_p2_plain_maxval100.pgm"] = plain(b"P2", v100, 100)
FILES["ppm_p3_plain.ppm"] = plain(b"P3", rand(H, W, 3), 255)
FILES["ppm_p4.pbm"] = pil(Image.fromarray(rand(H, W, hi=2).astype(bool)), "PPM")
FILES["ppm_p5.pgm"] = pil(Image.fromarray(grey), "PPM")
FILES["ppm_p5_maxval100.pgm"] = b"P5 7 5 100\n" + v100.astype(np.uint8).tobytes()
FILES["ppm_p5_maxval1000.pgm"] = b"P5\n7 5\n1000\n" + v1000.astype(">u2").tobytes()
FILES["ppm_p5_16bit.pgm"] = pil(Image.fromarray(rand(H, W, hi=65536, dtype=np.uint16)), "PPM")
FILES["ppm_p5_header_comments.pgm"] = b"P5\n#x\n7#y\n 5\n2#z\n55\n" + grey.tobytes()
FILES["ppm_p6.ppm"] = pil(Image.fromarray(rand(H, W, 3)), "PPM")
FILES["ppm_p6_16bit.ppm"] = b"P6\n7 5\n65535\n" + rand(H, W, 3, hi=65536, dtype=np.uint16).astype(">u2").tobytes()
FILES["ppm_p6_maxval300.ppm"] = b"P6\n7 5\n300\n" + rand(H, W, 3, hi=301, dtype=np.uint16).astype(">u2").tobytes()
FILES["ppm_pf_le.pfm"] = pil(Image.fromarray(rng.normal(size=(H, W)).astype(np.float32)), "PPM")
FILES["ppm_pf_be.pfm"] = enc.pfm(rng.normal(size=(H, W)).astype(np.float32) * 100, 2.5)
FILES["ppm_pyrgba.pnm"] = b"PyRGBA\n7 5\n255\n" + rand(H, W, 4).tobytes()
# refused: colour PFM and PAM (no opener accepts them), maxvals out of range
FILES["ppm_pf_colour.pfm"] = b"PF\n1 1\n-1.0\n" + bytes(12)
FILES["ppm_p7.pam"] = (b"P7\nWIDTH 7\nHEIGHT 5\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n" + grey.tobytes())
FILES["ppm_p5_maxval70000.pgm"] = b"P5\n7 5\n70000\n" + bytes(4)
FILES["ppm_p5_maxval0.pgm"] = b"P5\n7 5\n0\n" + bytes(4)

# ---- TGA


def tga_head(image_type, depth, flags=0, cmap=None, map_depth=0, w=W, h=H, id_len=0):
    n = 0 if cmap is None else len(cmap) // (map_depth // 8)
    return (struct.pack("<BBBHHBHHHHBB", id_len, int(cmap is not None), image_type, 0, n, map_depth, 0, 0, w, h,
                        depth, flags) + bytes(id_len) + (cmap or b""))


rgb, rgba = smooth(H, W, 3), smooth(H, W, 4)
FILES["tga_rgb24.tga"] = pil(Image.fromarray(rgb), "TGA")
FILES["tga_rgba32_top.tga"] = pil(Image.fromarray(rgba), "TGA", orientation=1)
FILES["tga_grey8.tga"] = pil(Image.fromarray(grey), "TGA")
FILES["tga_1bit.tga"] = pil(Image.fromarray(rand(H, W, hi=2).astype(bool)), "TGA")
FILES["tga_la16.tga"] = pil(Image.fromarray(rand(H, W, 2), "LA"), "TGA")
FILES["tga_pal8_map24.tga"] = pil(Image.fromarray(rgb).quantize(6), "TGA")
FILES["tga_pal8_map16_id.tga"] = tga_head(1, 8, 0x20, rand(12).tobytes(), 16, id_len=3) + rand(H, W, hi=6).tobytes()
FILES["tga_pal8_map32.tga"] = tga_head(1, 8, 0, rand(24).tobytes(), 32) + rand(H, W, hi=6).tobytes()
FILES["tga_bgr15.tga"] = tga_head(2, 16) + rand(H, W, 2).tobytes()
FILES["tga_flip_h.tga"] = tga_head(2, 24, 0x10) + rand(H, W, 3).tobytes()
FILES["tga_flip_hv.tga"] = tga_head(3, 8, 0x30) + rand(H, W).tobytes()
FILES["tga_rle_rgb24.tga"] = pil(Image.fromarray(rgb), "TGA", compression="tga_rle")
FILES["tga_rle_pal8.tga"] = pil(Image.fromarray(rgb).quantize(6), "TGA", compression="tga_rle")
FILES["tga_rle_rgba32_top.tga"] = enc.tga(rgba, bottom_up=False)
FILES["tga_rle_grey8.tga"] = enc.tga(smooth(H, W, 1)[..., 0])
# literal packets of 10 and 25 pixels running on into the next rows, then runs
FILES["tga_rle_literal_rows.tga"] = (tga_head(11, 8) + bytes([9]) + rand(10).tobytes() + bytes([24])
                                     + rand(25).tobytes())
FILES["tga_rle_bgr15.tga"] = tga_head(10, 16) + b"".join(bytes([0x86]) + rand(2).tobytes() for _ in range(H))
# refused
FILES["tga_rle_truncated.tga"] = tga_head(11, 8) + bytes([0x86, 7, 0x86])
FILES["tga_rle_run_across_rows.tga"] = tga_head(11, 8) + bytes([0x89, 7]) + bytes([0x98, 3])
FILES["tga_pal8_no_map.tga"] = tga_head(1, 8) + rand(H, W).tobytes()
FILES["tga_rgb8.tga"] = tga_head(2, 8) + rand(H, W).tobytes()

# ---- QOI

FILES["qoi_rgb.qoi"] = pil(Image.fromarray(smooth(9, 11, 3)), "QOI")
FILES["qoi_rgba.qoi"] = pil(Image.fromarray(smooth(9, 11, 4)), "QOI")

# ---- SGI

FILES["sgi_rgb.sgi"] = pil(Image.fromarray(rgb), "SGI")
FILES["sgi_l.sgi"] = pil(Image.fromarray(grey), "SGI")
FILES["sgi_rgb16.sgi"] = pil(Image.fromarray(smooth(3, 5, 3)), "SGI", bpc=2)
FILES["sgi_l16.sgi"] = enc.sgi(rand(3, 5, hi=65536, dtype=np.uint16), rle=False, bpc=2)
FILES["sgi_rle_rgb.sgi"] = enc.sgi(smooth(3, 5, 3))
FILES["sgi_rle_rgba.sgi"] = enc.sgi(smooth(3, 5, 4))
FILES["sgi_rle_l.sgi"] = enc.sgi(smooth(H, W, 1)[..., 0])
FILES["sgi_rle_rgb16.sgi"] = enc.sgi(smooth(3, 5, 3).astype(np.uint16) * 257 + 3, bpc=2)
FILES["sgi_dim1.sgi"] = enc.sgi(grey[:1], rle=False)[:4] + struct.pack(">H", 1) + enc.sgi(grey[:1], rle=False)[6:]
FILES["sgi_la_refused.sgi"] = enc.sgi(rand(1, 1, 2), rle=False)

# ---- PCX / DCX


def pcx_head(bits, planes, stride, w=W, h=H, version=5, palette16=b""):
    return (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72) + palette16.ljust(48, b"\0")
            + struct.pack("<BBHH", 0, planes, stride, 1).ljust(64, b"\0"))


def pcx_literal(rows: bytes) -> bytes:
    """Every byte as a run of one (always valid)."""
    return b"".join(bytes([0xC1, b]) for b in rows)


FILES["pcx_rgb.pcx"] = pil(Image.fromarray(rgb), "PCX")
FILES["pcx_l.pcx"] = pil(Image.fromarray(grey), "PCX")
FILES["pcx_1bit.pcx"] = pil(Image.fromarray(rand(H, 9, hi=2).astype(bool)), "PCX")
FILES["pcx_p8.pcx"] = pil(Image.fromarray(rgb).quantize(6), "PCX")
FILES["pcx_ega_4planes.pcx"] = pcx_head(1, 4, 2, w=9, palette16=rand(48).tobytes()) + pcx_literal(rand(H * 8).tobytes())
FILES["pcx_cga_2planes.pcx"] = pcx_head(1, 2, 2, w=11) + pcx_literal(rand(H * 4).tobytes())
FILES["pcx_4bit_refused.pcx"] = pcx_head(4, 1, 4) + pcx_literal(rand(H * 4).tobytes())
pages = [enc.pcx(smooth(3, 5, 3)), enc.pcx(smooth(2, 3, 3))]
FILES["dcx_two_pages.dcx"] = (struct.pack("<I3I", 0x3ADE68B1, 16, 16 + len(pages[0]), 0) + pages[0] + pages[1])

# ---- ICO / CUR


def dib(arr: np.ndarray, bits: int, palette=None) -> bytes:
    """A bottom-up BI_RGB DIB of height 2 * h (colour rows, then an AND mask
    of seeded bits) for an icon or cursor."""
    h, w = arr.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    if bits == 32:
        rows[:, :4 * w] = arr[..., [2, 1, 0, 3]].reshape(h, -1)
    elif bits == 24:
        rows[:, :3 * w] = arr[..., ::-1].reshape(h, -1)
    else:
        per = 8 // bits
        packed = np.zeros((h, (w + per - 1) // per * per), np.uint8)
        packed[:, :w] = arr
        packed = packed.reshape(h, -1, per)
        vals = sum(packed[..., k].astype(np.int32) << (8 - bits * (k + 1)) for k in range(per))
        rows[:, :vals.shape[1]] = vals
    mask_stride = ((w + 31) >> 5) * 4
    mask = rand(h, mask_stride)
    colours = 0 if palette is None else len(palette) // 4
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, colours, 0)
    return head + (palette or b"") + rows[::-1].tobytes() + mask.tobytes()


def icondir(entries, kind=1) -> bytes:
    """An ICONDIR of (width, height, bpp, colours, image bytes) entries."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    offset = 6 + 16 * len(entries)
    body = b""
    for w, h, bpp, colours, data in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, 1, bpp, len(data), offset + len(body))
        body += data
    return out + body


FILES["ico_png.ico"] = pil(Image.fromarray(smooth(8, 8, 4)), "ICO", sizes=[(8, 8), (4, 4)])
FILES["ico_bmp32.ico"] = pil(Image.fromarray(smooth(8, 8, 4)), "ICO", sizes=[(8, 8)], bitmap_format="bmp")
FILES["ico_bmp8.ico"] = pil(Image.fromarray(smooth(8, 8, 3)).quantize(12), "ICO", sizes=[(8, 8)], bitmap_format="bmp")
FILES["ico_bmp24_mask.ico"] = icondir([(9, 6, 24, 0, dib(rand(6, 9, 3), 24))])
FILES["ico_bmp4_mask.ico"] = icondir([(9, 6, 4, 16, dib(rand(6, 9, hi=16), 4, rand(64).tobytes()))])
FILES["ico_bmp1_mask.ico"] = icondir([(33, 3, 1, 2, dib(rand(3, 33, hi=2), 1, rand(8).tobytes()))])
# the same size at 24 and 4 bits: Pillow loads the fewest colours; a larger 4-bit entry first
FILES["ico_pick.ico"] = icondir([(8, 8, 24, 0, dib(rand(8, 8, 3), 24)),
                                 (8, 8, 4, 16, dib(rand(8, 8, hi=16), 4, rand(64).tobytes())),
                                 (4, 4, 24, 0, dib(rand(4, 4, 3), 24))])
FILES["cur_two.cur"] = icondir([(4, 4, 8, 0, dib(rand(4, 4, hi=4), 8, rand(16).tobytes())),
                                (7, 5, 8, 0, dib(rand(5, 7, hi=4), 8, rand(16).tobytes()))], kind=2)
FILES["cur_32bit.cur"] = icondir([(7, 5, 32, 0, dib(rand(5, 7, 4), 32))], kind=2)

# ---- DDS


def dds(w, h, body, fourcc=b"", dxgi=None, pfflags=0x4, bitcount=0, masks=(0, 0, 0, 0)):
    head = struct.pack("<4sIIIIIII", b"DDS ", 124, 0x1007, h, w, 0, 0, 1) + bytes(44)
    head += struct.pack("<II4sI4I", 32, pfflags, b"DX10" if dxgi is not None else fourcc.ljust(4, b"\0"), bitcount,
                        *masks) + bytes(20)
    return head + (struct.pack("<5I", dxgi, 3, 0, 1, 0) if dxgi is not None else b"") + body


def bc6h_blocks(count):
    """Seeded BC6H blocks, block k of mode k % 15 (mode 14: the reserved
    bits 10011)."""
    blocks = rand(count, 16)
    codes = [0, 1] + [2 + 4 * k for k in range(8)] + [3, 7, 11, 15, 19]
    for k in range(count):
        c = codes[k % 15]
        blocks[k, 0] = (blocks[k, 0] & (0xFC if c < 2 else 0xE0)) | c
    return blocks.tobytes()


FILES["dds_dxt1.dds"] = pil(Image.fromarray(smooth(H, W, 4)), "DDS", pixel_format="DXT1")
FILES["dds_dxt3.dds"] = pil(Image.fromarray(smooth(H, W, 4)), "DDS", pixel_format="DXT3")
FILES["dds_dxt5.dds"] = pil(Image.fromarray(smooth(H, W, 4)), "DDS", pixel_format="DXT5")
FILES["dds_bc5.dds"] = pil(Image.fromarray(smooth(H, W, 3)), "DDS", pixel_format="BC5")
FILES["dds_rgba.dds"] = pil(Image.fromarray(rgba), "DDS")
FILES["dds_rgb.dds"] = pil(Image.fromarray(rgb), "DDS")
FILES["dds_l.dds"] = pil(Image.fromarray(grey), "DDS")
FILES["dds_la.dds"] = pil(Image.fromarray(rand(H, W, 2), "LA"), "DDS")
FILES["dds_bc1_random_dx10.dds"] = dds(W, H, rand(4, 8).tobytes(), dxgi=71)
FILES["dds_bc4.dds"] = dds(W, H, rand(4, 8).tobytes(), b"BC4U")
FILES["dds_bc5s.dds"] = dds(W, H, rand(4, 16).tobytes(), b"BC5S")
FILES["dds_bc7.dds"] = dds(13, 13, enc.bc7_blocks(rng, 16).tobytes() + bytes(0), dxgi=98)
FILES["dds_bc6h_uf16.dds"] = dds(15, 15, bc6h_blocks(16), dxgi=95)
FILES["dds_bc6h_sf16.dds"] = dds(15, 15, bc6h_blocks(16), dxgi=96)
FILES["dds_rgb565.dds"] = dds(W, H, rand(H, W, 2).tobytes(), pfflags=0x40, bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0))
FILES["dds_argb4444.dds"] = dds(W, H, rand(H, W, 2).tobytes(), pfflags=0x41, bitcount=16,
                                masks=(0xF00, 0xF0, 0xF, 0xF000))
FILES["dds_p8.dds"] = dds(W, H, rand(1024).tobytes() + rand(H, W).tobytes(), pfflags=0x20, bitcount=8)
FILES["dds_rgba8_dx10.dds"] = dds(W, H, rand(H, W, 4).tobytes(), dxgi=28)
FILES["dds_bc1_srgb_refused.dds"] = dds(W, H, rand(4, 8).tobytes(), dxgi=72)
FILES["dds_fourcc_refused.dds"] = dds(W, H, rand(4, 8).tobytes(), b"ATC ")

# ---- IM

FILES["im_rgb.im"] = pil(Image.fromarray(rgb), "IM")
FILES["im_1.im"] = pil(Image.fromarray(rand(H, 10, hi=2).astype(bool)), "IM")
FILES["im_f.im"] = pil(Image.fromarray(rng.normal(size=(H, W)).astype(np.float32)), "IM")
FILES["im_i.im"] = pil(Image.fromarray(rand(H, W, hi=2**31, dtype=np.int32) - 2**30), "IM")
FILES["im_p.im"] = pil(Image.fromarray(rgb).quantize(6), "IM")
FILES["im_i16b.im"] = pil(Image.fromarray(rand(H, W, hi=65536, dtype=np.uint16)).convert("I;16B"), "IM")
FILES["im_ycc.im"] = pil(Image.fromarray(rgb).convert("YCbCr"), "IM")
FILES["im_uint32_as_float.im"] = (b"Image type: L 32 F image\r\nImage size (x*y): 7*5\r\n".ljust(511, b"\0") + b"\x1a"
                                  + rand(H, W, hi=2**32, dtype=np.uint64).astype("<u4").tobytes())

# ---- Sun raster


def sun(depth, file_type, body, w=W, h=H, palette=b""):
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), file_type, 1 if palette else 0,
                       len(palette)) + palette + body


def sun_rows(arr, depth):
    h, w = arr.shape[:2]
    stride = (w * depth + 15) // 16 * 2
    rows = np.zeros((h, stride), np.uint8)
    flat = np.packbits(arr, axis=1) if depth == 1 else arr.reshape(h, -1)
    rows[:, :flat.shape[1]] = flat
    return rows.tobytes()


FILES["sun_bgr24.ras"] = sun(24, 1, sun_rows(rand(H, W, 3), 24))
FILES["sun_rgb24_type3.ras"] = sun(24, 3, sun_rows(rand(H, W, 3), 24))
FILES["sun_bgrx32.ras"] = sun(32, 1, sun_rows(rand(H, W, 4), 32))
FILES["sun_grey8.ras"] = sun(8, 1, sun_rows(grey, 8))
FILES["sun_pal8.ras"] = sun(8, 1, sun_rows(rand(H, W, hi=4), 8), palette=rand(12).tobytes())
FILES["sun_1bit.ras"] = sun(1, 1, sun_rows(rand(H, 11, hi=2).astype(bool), 1), w=11)
FILES["sun_grey4.ras"] = sun(4, 1, sun_rows(rand(H, 4), 8), w=8)
FILES["sun_rle8.ras"] = sun(8, 2, bytes([0x80, 0, 0x80, 9, 5]) + rand(8).tobytes() + bytes([0x80, 14, 200])
                            + rand(10).tobytes())
FILES["sun_rle24.ras"] = sun(24, 2, bytes([0x80, 20, 7]) + rand(84).tobytes())
FILES["sun_depth16_refused.ras"] = sun(16, 1, bytes(2 * H * W))

# ---- DIB and Pillow's stubs

FILES["dib_rgb.dib"] = pil(Image.fromarray(rgb), "DIB")
FILES["bufr_stub.bufr"] = b"BUFR" + bytes(4)
FILES["grib_stub.grib"] = b"GRIB\0\0\0\x01"
FILES["hdf5_stub.h5"] = b"\x89HDF\r\n\x1a\n"
FILES["mpeg_stub.mpg"] = b"\x00\x00\x01\xb3\x00\x70\x05\x00"


def record(path: Path) -> dict:
    try:
        im = Image.open(path)
        arr = np.ascontiguousarray(np.asarray(im))
    except Exception:
        return {"pillow_raises": True}
    return {"dtype": str(arr.dtype), "mode": im.mode, "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "shape": list(arr.shape)}


def main() -> None:
    for p in ROOT.iterdir():
        if p.suffix not in (".py", ".json"):
            p.unlink()
    manifest = {}
    for name, data in FILES.items():
        (ROOT / name).write_bytes(data)
        manifest[name] = record(ROOT / name)
    lines = ",\n".join(f"{json.dumps(k)}:{json.dumps(v, sort_keys=True, separators=(',', ':'))}"
                        for k, v in sorted(manifest.items()))
    (ROOT / "manifest.json").write_text("{\n" + lines + "\n}\n")
    size = sum(p.stat().st_size for p in ROOT.iterdir())
    print(f"{len(manifest)} files ({sum('pillow_raises' in v for v in manifest.values())} refused), {size} bytes")


if __name__ == "__main__":
    main()
