"""EyefulTower dataset conversion to the nerfstudio transforms.json format.
(a copy of nerfstudio_thermal_tpu/process_data/eyeful_utils.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/scripts/downloads/eyeful_tower.py:56-294`
(EyefulTowerDownload). The download itself is AWS-S3 + awscli and needs
network egress; the conversion from EyefulTower's `cameras.json` /
`splits.json` to transforms.json is pure metadata work and lives here so it
runs offline against already-downloaded captures:

- per-image intrinsics from cameras.json KRT entries (column-major K),
  rescaled to the chosen resolution tier (:225-235),
- distortion remap: RadialAndTangential -> OPENCV [k1 k2 p1 p2 k3],
  Fisheye -> OPENCV_FISHEYE [k1 k2 k3 p1 p2] with a per-capture crop radius
  (:166-202, :46-53),
- pose: column-major world-from-camera T -> c2w, axes permuted to
  nerfstudio's +Z-up world ([2,0,1] row order) with y/z columns negated
  (:253-257),
- train/val splits surfaced as train_filenames / val_filenames (:264-267),
- uniform frame subsampling helper (:269-294).
"""

import copy
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

EYEFUL_CAPTURES = (
    "apartment", "kitchen", "office1a", "office1b", "office2",
    "office_view1", "office_view2", "riverview", "seating_area",
    "table", "workshop",
)

# Per-capture fisheye crop radii (fraction of image) avoiding the camera-rig
# base in V1 fisheye captures (reference eyeful_tower.py:46-53).
FISHEYE_CROP_RADII = {
    "office1a": 0.43,
    "office2": 0.45,
    "seating_area": 0.375,
    "table": 0.45,
    "workshop": 0.45,
}

# resolution tier -> (folder, width, height, extension)
RESOLUTIONS = {
    "jpeg_1k": ("images-jpeg-1k", 684, 1024, "jpg"),
    "jpeg_2k": ("images-jpeg-2k", 1368, 2048, "jpg"),
    "jpeg_4k": ("images-jpeg-4k", 2736, 4096, "jpg"),
    "jpeg_8k": ("images-jpeg", 5784, 8660, "jpg"),
    "exr_1k": ("images-1k", 684, 1024, "exr"),
    "exr_2k": ("images-2k", 1368, 2048, "exr"),
}


def _oriented(target_w: int, target_h: int, orig_w: int, orig_h: int) -> Tuple[int, int]:
    """Match the target resolution's orientation (portrait/landscape) to the
    source image's (the tier sizes are given portrait-first)."""
    lo, hi = sorted((target_w, target_h))
    return (hi, lo) if orig_w > orig_h else (lo, hi)


def eyeful_to_nerfstudio_transforms(
    capture_name: str,
    cameras: dict,
    splits: dict,
    target_width: int,
    target_height: int,
    extension: str = "jpg",
) -> dict:
    """EyefulTower cameras.json + splits.json -> transforms.json dict."""
    models = {c["distortionModel"] for c in cameras["KRT"]}
    if len(models) != 1:
        raise ValueError(f"mixed distortion models in capture: {sorted(models)}")
    model = models.pop()

    out: dict = {}
    if model == "RadialAndTangential":
        out["camera_model"] = "OPENCV"
    elif model == "Fisheye":
        out["camera_model"] = "OPENCV_FISHEYE"
        if capture_name in FISHEYE_CROP_RADII:
            out["fisheye_crop_radius"] = FISHEYE_CROP_RADII[capture_name]
    else:
        raise NotImplementedError(f"unsupported distortion model {model}")

    split_members = {k: set(v) for k, v in splits.items()}
    by_split: Dict[str, list] = {k: [] for k in split_members}

    frames = []
    for cam in cameras["KRT"]:
        file_path = f"{cam['cameraId']}.{extension}"
        for split, members in split_members.items():
            if cam["cameraId"] in members:
                by_split[split].append(file_path)

        w, h = _oriented(target_width, target_height, cam["width"], cam["height"])
        sx, sy = w / cam["width"], h / cam["height"]
        K = np.asarray(cam["K"], dtype=np.float64).T  # stored column-major

        frame = {
            "file_path": file_path,
            "w": w,
            "h": h,
            "fl_x": K[0, 0] * sx,
            "fl_y": K[1, 1] * sy,
            "cx": K[0, 2] * sx,
            "cy": K[1, 2] * sy,
        }
        d = cam["distortion"]
        if model == "RadialAndTangential":
            # stored [k1, k2, p1, p2, k3]
            frame.update(k1=d[0], k2=d[1], k3=d[4], k4=0.0, p1=d[2], p2=d[3])
        else:
            # fisheye: stored [k1, k2, k3, _, _, _, p1, p2]
            frame.update(k1=d[0], k2=d[1], k3=d[2], p1=d[6], p2=d[7])

        T = np.asarray(cam["T"], dtype=np.float64).T  # column-major w2c
        c2w = np.linalg.inv(T)
        c2w = c2w[[2, 0, 1, 3], :]  # z-up world
        c2w[:, 1:3] *= -1  # OpenCV -> OpenGL camera axes
        frame["transform_matrix"] = c2w.tolist()
        frames.append(frame)

    out["frames"] = sorted(frames, key=lambda f: f["file_path"])
    out["train_filenames"] = by_split.get("train", [])
    out["val_filenames"] = by_split.get("test", [])
    return out


def subsample_transforms(transforms: dict, n: int) -> dict:
    """Uniformly keep n frames (and prune the splits accordingly,
    reference eyeful_tower.py:269-294)."""
    total = len(transforms["frames"])
    keep = np.round(np.linspace(0, total - 1, min(n, total))).astype(int)
    out = copy.deepcopy(transforms)
    out["frames"] = [transforms["frames"][i] for i in keep]
    kept_files = {f["file_path"] for f in out["frames"]}
    for key in ("train_filenames", "val_filenames"):
        out[key] = sorted(set(transforms.get(key, ())) & kept_files)
    return out


def process_eyeful_capture(
    capture_dir: Path,
    resolution: str = "jpeg_2k",
    subsample: Optional[int] = None,
) -> Path:
    """Write transforms.json for an already-downloaded EyefulTower capture
    directory (containing cameras.json + splits.json)."""
    capture_dir = Path(capture_dir)
    cameras = json.loads((capture_dir / "cameras.json").read_text())
    splits = json.loads((capture_dir / "splits.json").read_text())
    folder, w, h, ext = RESOLUTIONS[resolution]
    transforms = eyeful_to_nerfstudio_transforms(
        capture_dir.name, cameras, splits, w, h, ext
    )
    if subsample:
        transforms = subsample_transforms(transforms, subsample)
    # image paths live under the resolution folder
    for f in transforms["frames"]:
        f["file_path"] = f"{folder}/{f['file_path']}"
    for key in ("train_filenames", "val_filenames"):
        transforms[key] = [f"{folder}/{p}" for p in transforms[key]]
    dest = capture_dir / "transforms.json"
    dest.write_text(json.dumps(transforms, indent=2))
    return dest
