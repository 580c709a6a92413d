"""Write the WebP / TIFF sphere scene of this directory and its manifest.

Run from the repository root on a machine with Pillow and zstandard:

    python tests/data/webp_tiff_scene/make_scene.py

chip_smoke.py's sphere scene (its `render_sphere` and camera ring), with
the frames in the formats a user may bring that only Pillow read before:
- images/: RGB 320x240 as lossy WebP (quality 90), frame 5 as a
  JPEG-compressed TIFF;
- images_thermal/: thermal 320x256 as 16-bit grey TIFF (value * 257),
  Zstandard with the horizontal predictor, frame 3 LZMA;
- 1080p/: one 1920x1080 file of each decode chip_smoke.py times (lossy
  and lossless WebP, JPEG-in-TIFF, 16-bit Zstandard and LZMA TIFF with
  predictor 2, a CCITT Group 4 mask).

manifest.json records, per file, Pillow's mode and the SHA-256, shape and
dtype of `np.asarray(Image.open(path))`, which the card's machine (no
Pillow) checks the port's decodes against.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parents[2]))

from chip_smoke import look_at, render_sphere  # noqa: E402

PAIRS = 8
RGB_HW, THERMAL_HW = (240, 320), (256, 320)


def thermal16(img: np.ndarray) -> np.ndarray:
    return img[..., 0].astype(np.uint16) * 257


def save_rgb(path: Path, img: np.ndarray) -> None:
    if path.suffix == ".webp":
        Image.fromarray(img).save(path, "WEBP", quality=90)
    else:
        Image.fromarray(img).save(path, compression="jpeg", quality=90)


def save_thermal(path: Path, img16: np.ndarray, compression: str) -> None:
    Image.fromarray(img16).save(path, compression=compression, tiffinfo={317: 2})


def record(path: Path) -> dict:
    im = Image.open(path)
    arr = np.ascontiguousarray(np.asarray(im))
    return {"mode": im.mode, "sha256": hashlib.sha256(arr.tobytes()).hexdigest(), "shape": list(arr.shape),
            "dtype": str(arr.dtype)}


def main() -> None:
    frames, manifest = [], {}
    for thermal, (h, w), sub in ((False, RGB_HW, "images"), (True, THERMAL_HW, "images_thermal")):
        (ROOT / sub).mkdir(exist_ok=True)
        for i in range(PAIRS):
            ang = 2 * np.pi * i / PAIRS
            c2w = look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2]))
            focal = 0.8 * w
            img = render_sphere(c2w, w, h, focal, thermal)
            if thermal:
                name = f"frame_{i:04d}.tif"
                save_thermal(ROOT / sub / name, thermal16(img), "lzma" if i == 3 else "zstd")
            else:
                name = f"frame_{i:04d}.{'tif' if i == 5 else 'webp'}"
                save_rgb(ROOT / sub / name, img)
            frames.append({"file_path": f"{sub}/{name}", "transform_matrix": c2w.tolist(), "fl_x": focal,
                           "fl_y": focal, "cx": w / 2, "cy": h / 2, "w": w, "h": h, "is_thermal": int(thermal)})
            manifest[f"{sub}/{name}"] = record(ROOT / sub / name)
    (ROOT / "transforms.json").write_text(json.dumps({"frames": frames}))
    big = ROOT / "1080p"
    big.mkdir(exist_ok=True)
    c2w = look_at(np.array([3.0, 0.5, 1.2]))
    rgb = render_sphere(c2w, 1920, 1080, 0.8 * 1920, False)
    t16 = thermal16(render_sphere(c2w, 1920, 1080, 0.8 * 1920, True))
    Image.fromarray(rgb).save(big / "lossy.webp", "WEBP", quality=90)
    Image.fromarray(rgb).save(big / "lossless.webp", "WEBP", lossless=True)
    Image.fromarray(rgb).save(big / "jpeg.tif", compression="jpeg", quality=90)
    save_thermal(big / "thermal16_zstd.tif", t16, "zstd")
    save_thermal(big / "thermal16_lzma.tif", t16, "lzma")
    Image.fromarray(t16 > 20000).save(big / "mask_g4.tif", compression="group4")
    for p in sorted(big.iterdir()):
        manifest[f"1080p/{p.name}"] = record(p)
    (ROOT / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    print(f"{len(manifest)} files, {sum((ROOT / n).stat().st_size for n in manifest)} bytes")


if __name__ == "__main__":
    main()
