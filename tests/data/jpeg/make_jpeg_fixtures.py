"""Write the JPEG fixtures of this directory and their manifest.

Run from the repository root on a machine with Pillow and OpenCV:

    python tests/data/jpeg/make_jpeg_fixtures.py

- small frames in each supported sampling (4:4:4, 4:2:2, 4:2:0 by Pillow;
  4:4:0 and 4:1:1 by OpenCV), greyscale, a restart interval, quality 50
  and 95, and odd sizes (partial MCUs);
- one 1920x1080 frame (quality 90) to time a full-HD decode;
- progressive files: RGB 4:2:0, RGB 4:2:0 at an odd size with a restart
  interval, greyscale, and a 1920x1080 frame (quality 90) to time a
  progressive full-HD decode against a baseline one;
- one CMYK file, which the port's decoder refuses;
- interlaced.png: an Adam7-interlaced 8-bit RGB PNG (Pillow cannot write
  one; `write_interlaced_png` does, with every filter type);
- colmap_sphere/: eight 320x240 views of the smoke test's textured sphere
  (images/frame_*.jpg) with a COLMAP reconstruction of their cameras
  (colmap/sparse/0/cameras.bin, images.bin: one PINHOLE camera).

manifest.json records, per file (JPEG and PNG), the SHA-256 and shape of Pillow's
`np.asarray(Image.open(path))`, which the port's decoder must reproduce
(the card's machine has no Pillow, so the hashes travel with the files).
"""

import hashlib
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parents[2]))


def pillow_record(path: Path) -> dict:
    from PIL import Image

    arr = np.ascontiguousarray(np.asarray(Image.open(path)))
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(), "shape": list(arr.shape), "dtype": str(arr.dtype)}


def smooth(h: int, w: int, c: int, seed: int = 0, noise: float = 6.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 37.0 + k) * np.cos(y / 23.0 - k) for k in range(c)], -1) * 90 + 128
    return np.clip(base + rng.normal(0, noise, (h, w, c)), 0, 255).astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def write_interlaced_png(path: Path, img: np.ndarray) -> None:
    """An Adam7-interlaced 8-bit RGB PNG of uint8 [H, W, 3]; row r of each
    pass is filtered with filter type r % 5."""
    def paeth(a, b, c):
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))

    data = b""
    for x0, y0, dx, dy in ADAM7:
        sub = img[y0::dy, x0::dx].astype(np.int32)
        if sub.size == 0:
            continue
        rows = sub.reshape(sub.shape[0], -1)
        prev = np.zeros(rows.shape[1], np.int32)
        for r, row in enumerate(rows):
            left = np.concatenate([np.zeros(3, np.int32), row[:-3]])
            upleft = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
            pred = [0, left, prev, (left + prev) >> 1, paeth(left, prev, upleft)][r % 5]
            data += bytes([r % 5]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
            prev = row

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 2, 0, 0, 1)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(data))
                     + chunk(b"IEND", b""))


def rotmat2qvec(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = r.flat
    k = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_colmap_sphere(root: Path, n: int = 8, w: int = 320, h: int = 240) -> None:
    from PIL import Image

    from chip_smoke import look_at, render_sphere

    images = root / "images"
    sparse = root / "colmap" / "sparse" / "0"
    images.mkdir(parents=True, exist_ok=True)
    sparse.mkdir(parents=True, exist_ok=True)
    focal = 0.8 * w
    # nerfstudio world -> COLMAP world: the inverse of the parser's row swap and flip
    world = np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])
    records = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        c2w = look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2]))
        Image.fromarray(render_sphere(c2w, w, h, focal, False)).save(images / f"frame_{i:04d}.jpg", quality=90)
        c2w_gl = np.eye(4)
        c2w_gl[:3] = world.T @ c2w[:3]
        c2w_cv = c2w_gl.copy()
        c2w_cv[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w_cv)
        records.append((i + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], f"frame_{i:04d}.jpg"))
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))  # PINHOLE
        f.write(struct.pack("<dddd", focal, focal, w / 2, h / 2))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(records)))
        for image_id, q, t, name in records:
            f.write(struct.pack("<idddddddi", image_id, *q, *t, 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def main() -> None:
    import cv2
    from PIL import Image

    small = smooth(48, 64, 3)
    odd = smooth(23, 37, 3, seed=1)
    files = {
        "rgb_444_q95.jpg": lambda p: Image.fromarray(small).save(p, quality=95, subsampling=0),
        "rgb_422_q50.jpg": lambda p: Image.fromarray(small).save(p, quality=50, subsampling=1),
        "rgb_420_q75.jpg": lambda p: Image.fromarray(small).save(p, quality=75, subsampling=2),
        "rgb_420_odd_37x23.jpg": lambda p: Image.fromarray(odd).save(p, quality=80, subsampling=2),
        "rgb_420_restart.jpg": lambda p: Image.fromarray(odd).save(p, quality=85, subsampling=2,
                                                                   restart_marker_blocks=2),
        "grey_q90.jpg": lambda p: Image.fromarray(small[..., 0]).save(p, quality=90),
        "rgb_440_q85.jpg": lambda p: cv2.imwrite(str(p), odd[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
        "rgb_411_q85.jpg": lambda p: cv2.imwrite(str(p), small[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]),
        "frame_1920x1080.jpg": lambda p: Image.fromarray(smooth(1080, 1920, 3, seed=2)).save(p, quality=90),
        "progressive.jpg": lambda p: Image.fromarray(small).save(p, quality=75, progressive=True),
        "progressive_420_restart.jpg": lambda p: Image.fromarray(odd).save(
            p, quality=85, subsampling=2, progressive=True, restart_marker_blocks=2),
        "progressive_grey.jpg": lambda p: Image.fromarray(small[..., 0]).save(p, quality=90, progressive=True),
        "progressive_1920x1080.jpg": lambda p: Image.fromarray(smooth(1080, 1920, 3, seed=3, noise=1.0)).save(
            p, quality=90, progressive=True),
        "cmyk.jpg": lambda p: Image.fromarray(np.concatenate([small, small[..., :1]], -1), "CMYK").save(
            p, quality=90),
        "interlaced.png": lambda p: write_interlaced_png(p, odd),
    }
    for name, write in files.items():
        write(ROOT / name)
    write_colmap_sphere(ROOT / "colmap_sphere")
    manifest = {}
    for path in sorted([*ROOT.rglob("*.jpg"), *ROOT.rglob("*.png")]):
        rec = pillow_record(path)
        if path.name == "cmyk.jpg":
            rec["port_raises"] = "NotImplementedError"
        manifest[path.relative_to(ROOT).as_posix()] = rec
    (ROOT / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
