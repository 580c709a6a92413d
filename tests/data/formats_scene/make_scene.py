"""Write scenes in the netpbm, QOI, TGA, SGI and PCX formats from a seed,
with encoders of this file (numpy only: neither Pillow nor the port's
decoders).

- `write_thermal_scene(root, seed)`: the ThermalNerf layout (transforms.json,
  images/, images_thermal/) of a ray-traced sphere ring, RGB frames as raw
  PPM (P6), QOI, RLE TGA, RLE SGI and PCX, thermal frames as P5 PGM at
  maxval 255 (even frames) and 200 (odd frames, which Pillow rescales);
- `write_depth_scene(root, seed)`: the Nerfstudio layout with RGB frames as
  PPM and a depth map per frame in millimetres, as grey PFM (even frames,
  float32, unrounded) and 16-bit PGM (odd frames, maxval 65535, rounded);
- `write_1080p(root, seed)`: one 1920x1080 file of each format whose decode
  chip_smoke.py times (16-bit PGM, PFM, QOI, RLE TGA; a BC7 DDS of seeded
  blocks, every mode).

Each writer returns {relative path: (the array `np.asarray(Image.open(p))`
gives, Pillow's mode)}; tests/test_torch_image_formats_more.py holds these
to Pillow's decodes of the files, and chip_smoke.py (phase 25) the port's
decodes to them. The sphere's pixels carry seeded noise, so that the RLE
and QOI encoders write literals and runs, diffs and full pixels.

Run from the repository root to write both scenes into a directory:

    python tests/data/formats_scene/make_scene.py OUT_DIR [--seed N]
"""

import argparse
import json
import struct
from pathlib import Path

import numpy as np

PAIRS = 8
RGB_HW, THERMAL_HW, DEPTH_HW = (240, 320), (256, 320), (480, 640)
DEPTH_FRAMES = 10
# the RGB frames' formats, by frame
RGB_FORMATS = ("ppm", "qoi", "tga", "sgi", "pcx", "ppm", "qoi", "tga")
THERMAL_MAXVAL = (255, 200)  # even frames, odd frames


# ---- encoders ----------------------------------------------------------------


def pnm(arr: np.ndarray, maxval: int = 255) -> bytes:
    """Raw netpbm: P5 for [H, W], P6 for [H, W, 3]; 16-bit big-endian
    samples when maxval > 255."""
    magic = b"P5" if arr.ndim == 2 else b"P6"
    h, w = arr.shape[:2]
    body = arr.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return magic + b"\n%d %d\n%d\n" % (w, h, maxval) + body


def pfm(arr: np.ndarray, scale: float = -1.0) -> bytes:
    """Grey PFM ("Pf") of float32 [H, W]: rows bottom-up, little-endian for
    a negative scale."""
    h, w = arr.shape
    e = "<" if scale < 0 else ">"
    return b"Pf\n%d %d\n%s\n" % (w, h, repr(float(scale)).encode()) + arr[::-1].astype(f"{e}f4").tobytes()


def runs(row: np.ndarray):
    """(start, length) of the runs of equal items of [N, ...]."""
    flat = row.reshape(len(row), -1)
    change = np.ones(len(row), bool)
    change[1:] = (flat[1:] != flat[:-1]).any(1)
    starts = np.flatnonzero(change)
    return starts, np.diff(np.append(starts, len(row)))


def packets(row: np.ndarray, longest: int):
    """A row of items as ("run", item, n) and ("literal", items) packets of
    at most `longest` items: runs of two or more, literals of the rest."""
    out, pending = [], []
    for s, n in zip(*runs(row)):
        if n == 1:
            pending.append(row[s])
            continue
        while pending:
            out.append(("literal", pending[:longest]))
            pending = pending[longest:]
        while n > 0:
            k = min(n, longest)
            if k == 1:
                pending.append(row[s])
            else:
                out.append(("run", row[s], k))
            n -= k
    while pending:
        out.append(("literal", pending[:longest]))
        pending = pending[longest:]
    return out


def tga(arr: np.ndarray, rle: bool = True, bottom_up: bool = True) -> bytes:
    """TGA of uint8 [H, W] (grey, type 3 / 11) or [H, W, 3 / 4] (BGR(A),
    type 2 / 10); RLE packets stay inside their rows."""
    h, w = arr.shape[:2]
    grey = arr.ndim == 2
    px = (arr[..., None] if grey else arr[..., [2, 1, 0, 3][:arr.shape[2]]]).astype(np.uint8)
    depth = 8 * px.shape[2]
    rows = px[::-1] if bottom_up else px
    image_type = (3 if grey else 2) + (8 if rle else 0)
    flags = (0 if bottom_up else 0x20) | (8 if depth == 32 else 0)
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, image_type, 0, 0, 0, 0, 0, w, h, depth, flags)
    if not rle:
        return head + rows.tobytes()
    body = bytearray()
    for row in rows:
        for p in packets(row, 128):
            if p[0] == "run":
                body += bytes([0x80 | (p[2] - 1)]) + p[1].tobytes()
            else:
                body += bytes([len(p[1]) - 1]) + b"".join(x.tobytes() for x in p[1])
    return head + bytes(body)


def sgi(arr: np.ndarray, rle: bool = True, bpc: int = 1) -> bytes:
    """SGI of [H, W] or [H, W, 3 / 4] samples (uint8, or uint16 for bpc 2):
    channels planar, rows bottom-up; RLE rows through the offset tables."""
    h, w = arr.shape[:2]
    planes = (arr[..., None] if arr.ndim == 2 else arr).transpose(2, 0, 1)[:, ::-1]
    z = planes.shape[0]
    dt = ">u2" if bpc == 2 else np.uint8
    head = struct.pack(">HBBHHHH", 474, int(rle), bpc, 3 if z > 1 else 2, w, h, z)
    head += struct.pack(">II", 0, 255 if bpc == 1 else 65535)
    head = head.ljust(512, b"\0")
    if not rle:
        return head + planes.astype(dt).tobytes()
    starts, lengths, body = [], [], bytearray()
    offset = 512 + 8 * z * h
    for plane in planes:
        for row in plane:
            code = bytearray()
            for p in packets(row.astype(dt), 127):
                if p[0] == "run":
                    code += np.array([p[2]], dt).tobytes() + p[1].tobytes()
                else:
                    code += np.array([0x80 | len(p[1])], dt).tobytes() + b"".join(x.tobytes() for x in p[1])
            code += bytes(bpc)
            starts.append(offset + len(body))
            lengths.append(len(code))
            body += code
    return head + struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *lengths) + bytes(body)


def pcx(arr: np.ndarray) -> bytes:
    """Version-5 PCX of uint8 [H, W] (8-bit grey, a linear grey palette at
    the end) or [H, W, 3] (three 8-bit planes); rows of an even stride, each
    plane's bytes run-length coded (runs of up to 63, a byte of 0xC0 or
    more always as a run)."""
    h, w = arr.shape[:2]
    planes = 1 if arr.ndim == 2 else 3
    stride = w + w % 2
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 72, 72) + bytes(48)
    head += struct.pack("<BBHH", 0, planes, stride, 1).ljust(64, b"\0")
    body = bytearray()
    for y in range(h):
        for k in range(planes):
            line = np.zeros(stride, np.uint8)
            line[:w] = arr[y] if planes == 1 else arr[y, :, k]
            for s, n in zip(*runs(line)):
                v = int(line[s])
                while n > 0:
                    m = min(n, 63)
                    if m == 1 and v < 0xC0:
                        body.append(v)
                    else:
                        body += bytes([0xC0 | m, v])
                    n -= m
    tail = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes() if planes == 1 else b""
    return head + bytes(body) + tail


def qoi(arr: np.ndarray) -> bytes:
    """QOI of uint8 [H, W, 3 / 4] with the run, diff, luma, RGB and RGBA ops
    (no index op), vectorised."""
    h, w, c = arr.shape
    px = np.concatenate([arr.reshape(-1, c), np.full((h * w, 4 - c), 255, np.uint8)], 1).astype(np.int16)
    prev = np.concatenate([[[0, 0, 0, 255]], px[:-1]])
    same = (px == prev).all(1)
    d = ((px - prev + 128) % 256) - 128  # wrapped differences
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    n = len(px)
    ops = np.zeros((n, 5), np.uint8)
    size = np.zeros(n, np.int64)
    rgba = ~same & (d[:, 3] != 0)
    diff = ~same & ~rgba & (np.abs(d[:, :3] + 0.5) < 2).all(1)
    luma = (~same & ~rgba & ~diff & (dg >= -32) & (dg <= 31) & (dr - dg >= -8) & (dr - dg <= 7) & (db - dg >= -8)
            & (db - dg <= 7))
    rgb = ~same & ~rgba & ~diff & ~luma
    ops[rgba, 0], ops[rgba, 1:] = 0xFF, px[rgba]
    size[rgba] = 5
    ops[rgb, 0], ops[rgb, 1:4] = 0xFE, px[rgb, :3]
    size[rgb] = 4
    ops[diff, 0] = 0x40 | ((dr[diff] + 2) << 4) | ((dg[diff] + 2) << 2) | (db[diff] + 2)
    size[diff] = 1
    ops[luma, 0] = 0x80 | (dg[luma] + 32)
    ops[luma, 1] = ((dr[luma] - dg[luma] + 8) << 4) | (db[luma] - dg[luma] + 8)
    size[luma] = 2
    # runs of repeated pixels: a run op at every 62nd pixel of a run
    starts, lengths = runs(same.astype(np.int8))
    for s, k in zip(starts, lengths):
        if same[s]:
            first = np.arange(s, s + k, 62)
            ops[first, 0] = 0xC0 | (np.minimum(62, s + k - first) - 1)
            size[first] = 1
    body = ops[np.arange(5)[None] < size[:, None]].tobytes()
    return b"qoif" + struct.pack(">IIBB", w, h, c, 0) + body + b"\0" * 7 + b"\x01"


def dds_bc7(blocks: np.ndarray, width: int, height: int) -> bytes:
    """A DX10 DDS (DXGI BC7_UNORM) of 16-byte BC7 blocks."""
    head = struct.pack("<4sIIIIIII", b"DDS ", 124, 0x1007, height, width, blocks.size, 0, 1) + bytes(44)
    head += struct.pack("<II4sI", 32, 0x4, b"DX10", 0) + bytes(16) + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    return head + struct.pack("<5I", 98, 3, 0, 1, 0) + blocks.tobytes()


def bc7_blocks(rng: np.random.Generator, count: int, mode: int = None) -> np.ndarray:
    """Seeded random BC7 blocks with their mode bits forced: block k gets
    mode `mode`, or k % 8."""
    blocks = rng.integers(0, 256, (count, 16), dtype=np.uint8)
    modes = np.full(count, mode) if mode is not None else np.arange(count) % 8
    low = blocks[:, 0].astype(np.int32)
    blocks[:, 0] = ((low << 1 << modes) | (1 << modes)) & 0xFF  # mode m: m zero bits, then a one
    return blocks


# ---- scenes ------------------------------------------------------------------


def look_at(eye: np.ndarray) -> np.ndarray:
    """OpenGL camera-to-world looking at the origin, z up."""
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, eye
    return c2w


def trace(c2w: np.ndarray, w: int, h: int, focal: float):
    """Unit-sphere hits of the camera's rays: (hit mask, surface point,
    ray direction, z-depth)."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    cam = np.stack([(xs - w / 2) / focal, -(ys - h / 2) / focal, -np.ones_like(xs)], -1)
    norm = np.linalg.norm(cam, axis=-1)
    d = (cam @ c2w[:3, :3].T) / norm[..., None]
    o = c2w[:3, 3]
    b = d @ o
    disc = b * b - (o @ o - 1.0)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return disc > 0, o + t[..., None] * d, d, np.where(disc > 0, t / norm, 0.0)


def sphere(c2w, w, h, rng: np.random.Generator, thermal: bool) -> np.ndarray:
    """A checkered (RGB) or smoothly warm (thermal) sphere over a gradient
    sky, uint8, with noise of +-3 on the sphere."""
    hit, n, d, _ = trace(c2w, w, h, 0.8 * w)
    shade = 0.35 + 0.65 * np.clip(n @ np.array([0.5, 0.3, 0.8]) / np.linalg.norm([0.5, 0.3, 0.8]), 0, 1)
    if thermal:
        value = np.where(hit, 0.35 + 0.45 * (0.5 + 0.5 * n[..., 2]) * shade, 0.08 + 0.04 * d[..., 2])[..., None]
    else:
        checker = (np.floor(np.arctan2(n[..., 1], n[..., 0]) / (np.pi / 6))
                   + np.floor(np.arccos(np.clip(n[..., 2], -1, 1)) / (np.pi / 6))) % 2
        colour = np.where(checker[..., None] > 0, [0.9, 0.45, 0.15], [0.15, 0.55, 0.85]) * shade[..., None]
        sky = np.stack([0.55 + 0.2 * d[..., 2], 0.65 + 0.2 * d[..., 2], 0.8 + 0.1 * d[..., 2]], -1)
        value = np.where(hit[..., None], colour, sky)
    img = np.clip(value, 0, 1) * 255 + np.where(hit[..., None], rng.integers(-3, 4, value.shape), 0)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if thermal else img


def rescaled(v: np.ndarray, maxval: int, top: int = 255) -> np.ndarray:
    """Pillow's netpbm rescaling: round(v / maxval * top), half to even."""
    return np.rint(v.astype(np.float64) / maxval * top)


def camera(i: int, num: int, w: int, h: int) -> dict:
    ang = 2 * np.pi * i / num
    c2w = look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2]))
    focal = 0.8 * w
    return {"transform_matrix": c2w.tolist(), "fl_x": focal, "fl_y": focal, "cx": w / 2, "cy": h / 2, "w": w, "h": h}


def write_rgb(path: Path, kind: str, img: np.ndarray) -> None:
    path.write_bytes({"ppm": pnm, "qoi": qoi, "tga": tga, "sgi": sgi, "pcx": pcx}[kind](img))


def write_thermal_scene(root: Path, seed: int = 25, pairs: int = PAIRS, rgb_hw=RGB_HW, thermal_hw=THERMAL_HW) -> dict:
    rng = np.random.default_rng(seed)
    frames, sources = [], {}
    for thermal, (h, w), sub in ((False, rgb_hw, "images"), (True, thermal_hw, "images_thermal")):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for i in range(pairs):
            cam = camera(i, pairs, w, h)
            img = sphere(np.array(cam["transform_matrix"]), w, h, rng, thermal)
            if thermal:
                maxval = THERMAL_MAXVAL[i % 2]
                name = f"images_thermal/frame_{i:04d}.pgm"
                stored = np.round(img.astype(np.float64) * maxval / 255).astype(np.uint8)
                (root / name).write_bytes(pnm(stored, maxval))
                sources[name] = (rescaled(stored, maxval).astype(np.uint8), "L")
            else:
                kind = RGB_FORMATS[i % len(RGB_FORMATS)]
                name = f"images/frame_{i:04d}.{kind}"
                write_rgb(root / name, kind, img)
                sources[name] = (img, "RGB")
            frames.append({"file_path": name, **cam, "is_thermal": int(thermal)})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    return sources


def write_depth_scene(root: Path, seed: int = 25, num: int = DEPTH_FRAMES, hw=DEPTH_HW) -> dict:
    rng = np.random.default_rng(seed)
    h, w = hw
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "depths").mkdir(parents=True, exist_ok=True)
    frames, sources = [], {}
    for i in range(num):
        cam = camera(i, num, w, h)
        c2w = np.array(cam["transform_matrix"])
        img = sphere(c2w, w, h, rng, False)
        (root / f"images/frame_{i:04d}.ppm").write_bytes(pnm(img))
        sources[f"images/frame_{i:04d}.ppm"] = (img, "RGB")
        z_mm = trace(c2w, w, h, 0.8 * w)[3] * 1000.0
        if i % 2 == 0:
            name = f"depths/frame_{i:04d}.pfm"
            (root / name).write_bytes(pfm(z_mm.astype(np.float32)))
            sources[name] = (z_mm.astype(np.float32), "F")
        else:
            name = f"depths/frame_{i:04d}.pgm"
            z16 = np.rint(z_mm).astype(np.uint16)
            (root / name).write_bytes(pnm(z16, 65535))
            sources[name] = (z16.astype(np.int32), "I")
        frames.append({"file_path": f"images/frame_{i:04d}.ppm", "depth_file_path": name, **cam})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    return sources


def write_1080p(root: Path, seed: int = 25) -> dict:
    """The 1920x1080 files whose decodes chip_smoke.py times; the DDS has
    no source array (its BC7 blocks are random), only its shape."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    cam = camera(1, PAIRS, 1920, 1080)
    c2w = np.array(cam["transform_matrix"])
    rgb = sphere(c2w, 1920, 1080, rng, False)
    depth = (trace(c2w, 1920, 1080, 0.8 * 1920)[3] * 1000.0).astype(np.float32)
    grey16 = sphere(c2w, 1920, 1080, rng, True).astype(np.uint16) * 257
    files = {"grey16.pgm": (pnm(grey16, 65535), (grey16.astype(np.int32), "I")),
             "depth.pfm": (pfm(depth), (depth, "F")),
             "rgb.qoi": (qoi(rgb), (rgb, "RGB")),
             "rgb_rle.tga": (tga(rgb), (rgb, "RGB")),
             "bc7.dds": (dds_bc7(bc7_blocks(rng, 480 * 270), 1920, 1080), (None, "RGBA"))}
    for name, (data, _) in files.items():
        (root / name).write_bytes(data)
    return {name: source for name, (_, source) in files.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out", type=Path)
    parser.add_argument("--seed", type=int, default=25)
    args = parser.parse_args()
    thermal = write_thermal_scene(args.out / "rgbt", args.seed)
    depth = write_depth_scene(args.out / "depth", args.seed)
    print(f"{len(thermal)} + {len(depth)} files written under {args.out}")


if __name__ == "__main__":
    main()
