"""Write the JPEG fixtures of this directory and their manifest.

Run from the repository root on a machine with Pillow and OpenCV:

    python tests/data/jpeg/make_jpeg_fixtures.py

- small frames in each supported sampling (4:4:4, 4:2:2, 4:2:0 by Pillow;
  4:4:0 and 4:1:1 by OpenCV), greyscale, a restart interval, quality 50
  and 95, and odd sizes (partial MCUs);
- one 1920x1080 frame (quality 90) to time a full-HD decode;
- one progressive file, which the port's baseline decoder refuses;
- colmap_sphere/: eight 320x240 views of the smoke test's textured sphere
  (images/frame_*.jpg) with a COLMAP reconstruction of their cameras
  (colmap/sparse/0/cameras.bin, images.bin: one PINHOLE camera).

manifest.json records, per file, the SHA-256 and shape of Pillow's
`np.asarray(Image.open(path))`, which the port's decoder must reproduce
(the card's machine has no Pillow, so the hashes travel with the files).
"""

import hashlib
import json
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parents[2]))


def pillow_record(path: Path) -> dict:
    from PIL import Image

    arr = np.ascontiguousarray(np.asarray(Image.open(path)))
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(), "shape": list(arr.shape), "dtype": str(arr.dtype)}


def smooth(h: int, w: int, c: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 37.0 + k) * np.cos(y / 23.0 - k) for k in range(c)], -1) * 90 + 128
    return np.clip(base + rng.normal(0, 6, (h, w, c)), 0, 255).astype(np.uint8)


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
    }
    for name, write in files.items():
        write(ROOT / name)
    write_colmap_sphere(ROOT / "colmap_sphere")
    manifest = {}
    for path in sorted(ROOT.rglob("*.jpg")):
        rec = pillow_record(path)
        if path.name == "progressive.jpg":
            rec["port_raises"] = "NotImplementedError"
        manifest[path.relative_to(ROOT).as_posix()] = rec
    (ROOT / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
