"""COLMAP SfM wrapper + reconstruction -> transforms.json.
(a copy of nerfstudio_thermal_tpu/process_data/colmap_utils.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/process_data/colmap_utils.py` —
feature_extractor / matcher / mapper / bundle_adjuster subprocesses
(:95-196), including the fork's fixed calibrated intrinsics passthrough
(`--ImageReader.camera_params` from camera_matrix/dist_coeffs, :137-142);
`parse_colmap_camera_params` (:197-330) and `colmap_to_json` with the
COLMAP->OpenGL world conversion and `applied_transform` bookkeeping.

COLMAP is an external host binary; absence raises a clear error only when an
SfM run is actually requested.
"""

import json
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from nerfstudio_thermal_torch.data.utils.colmap_parsing_utils import (
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
)
from nerfstudio_thermal_torch.process_data.process_data_utils import CameraModel


def colmap_available(colmap_cmd: str = "colmap") -> bool:
    return shutil.which(colmap_cmd) is not None


def run_command(cmd: str, verbose: bool = False):
    out = subprocess.run(
        cmd, shell=True, capture_output=not verbose, text=True, check=False
    )
    if out.returncode != 0:
        raise RuntimeError(
            f"command failed ({out.returncode}): {cmd}\n{out.stderr if not verbose else ''}"
        )


def run_colmap(
    image_dir: Path,
    colmap_dir: Path,
    camera_model: CameraModel,
    camera_mask_path: Optional[Path] = None,
    gpu: bool = False,
    verbose: bool = False,
    matching_method: str = "sequential",
    refine_intrinsics: bool = True,
    colmap_cmd: str = "colmap",
    camera_matrix: Optional[np.ndarray] = None,
    dist_coeffs: Optional[np.ndarray] = None,
) -> None:
    """Feature extraction -> matching -> mapping -> refinement."""
    if not colmap_available(colmap_cmd):
        raise RuntimeError(
            f"COLMAP binary '{colmap_cmd}' not found on PATH. Install COLMAP "
            "or provide a transforms.json with known poses."
        )

    colmap_dir = Path(colmap_dir)
    colmap_dir.mkdir(parents=True, exist_ok=True)
    (colmap_dir / "database.db").unlink(missing_ok=True)

    feature_cmd = [
        f"{colmap_cmd} feature_extractor",
        f"--database_path {colmap_dir / 'database.db'}",
        f"--image_path {image_dir}",
        "--ImageReader.single_camera 1",
        f"--ImageReader.camera_model {camera_model.value}",
        f"--SiftExtraction.use_gpu {int(gpu)}",
    ]
    if camera_mask_path is not None:
        feature_cmd.append(f"--ImageReader.camera_mask_path {camera_mask_path}")
    if camera_matrix is not None:
        # Fork addition: fix calibrated intrinsics (reference :137-142).
        assert dist_coeffs is not None
        fx, fy, cx, cy = (
            camera_matrix[0, 0], camera_matrix[1, 1],
            camera_matrix[0, 2], camera_matrix[1, 2],
        )
        k1, k2, p1, p2 = np.asarray(dist_coeffs).squeeze()[:4]
        params = ",".join(map(str, [fx, fy, cx, cy, k1, k2, p1, p2]))
        feature_cmd.append(f'--ImageReader.camera_params "{params}"')
    run_command(" ".join(feature_cmd), verbose=verbose)

    matcher_cmd = [
        f"{colmap_cmd} {matching_method}_matcher",
        f"--database_path {colmap_dir / 'database.db'}",
        f"--SiftMatching.use_gpu {int(gpu)}",
    ]
    run_command(" ".join(matcher_cmd), verbose=verbose)

    sparse_dir = colmap_dir / "sparse"
    sparse_dir.mkdir(parents=True, exist_ok=True)
    run_command(
        f"{colmap_cmd} mapper --database_path {colmap_dir / 'database.db'} "
        f"--image_path {image_dir} --output_path {sparse_dir} "
        "--Mapper.ba_global_function_tolerance=1e-6",
        verbose=verbose,
    )
    if refine_intrinsics:
        run_command(
            f"{colmap_cmd} bundle_adjuster --input_path {sparse_dir}/0 "
            f"--output_path {sparse_dir}/0 "
            "--BundleAdjustment.refine_principal_point 1",
            verbose=verbose,
        )


def parse_colmap_camera_params(camera) -> Dict[str, Any]:
    """COLMAP camera -> transforms.json intrinsics (reference :197-330,
    OPENCV-family models)."""
    out: Dict[str, Any] = {"w": camera.width, "h": camera.height}
    p = camera.params
    model = camera.model
    if model == "SIMPLE_PINHOLE":
        out.update(fl_x=float(p[0]), fl_y=float(p[0]), cx=float(p[1]), cy=float(p[2]),
                   k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    elif model == "PINHOLE":
        out.update(fl_x=float(p[0]), fl_y=float(p[1]), cx=float(p[2]), cy=float(p[3]),
                   k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    elif model == "SIMPLE_RADIAL":
        out.update(fl_x=float(p[0]), fl_y=float(p[0]), cx=float(p[1]), cy=float(p[2]),
                   k1=float(p[3]), k2=0.0, p1=0.0, p2=0.0)
    elif model == "RADIAL":
        out.update(fl_x=float(p[0]), fl_y=float(p[0]), cx=float(p[1]), cy=float(p[2]),
                   k1=float(p[3]), k2=float(p[4]), p1=0.0, p2=0.0)
    elif model == "OPENCV":
        out.update(fl_x=float(p[0]), fl_y=float(p[1]), cx=float(p[2]), cy=float(p[3]),
                   k1=float(p[4]), k2=float(p[5]), p1=float(p[6]), p2=float(p[7]))
    elif model == "OPENCV_FISHEYE":
        out.update(fl_x=float(p[0]), fl_y=float(p[1]), cx=float(p[2]), cy=float(p[3]),
                   k1=float(p[4]), k2=float(p[5]), k3=float(p[6]), k4=float(p[7]))
        out["camera_model"] = "OPENCV_FISHEYE"
        return out
    else:
        raise NotImplementedError(f"unsupported COLMAP camera model {model}")
    out["camera_model"] = "OPENCV"
    return out


def colmap_to_json(
    recon_dir: Path,
    output_dir: Path,
    image_rename_map: Optional[Dict[str, str]] = None,
) -> int:
    """COLMAP sparse reconstruction -> transforms.json
    (reference colmap_utils.py:506-600)."""
    recon_dir = Path(recon_dir)
    cameras = read_cameras_binary(recon_dir / "cameras.bin")
    images = read_images_binary(recon_dir / "images.bin")

    frames = []
    for im_id, im_data in images.items():
        rotation = qvec2rotmat(im_data.qvec)
        translation = im_data.tvec.reshape(3, 1)
        w2c = np.concatenate([rotation, translation], 1)
        w2c = np.concatenate([w2c, np.array([[0, 0, 0, 1]])], 0)
        c2w = np.linalg.inv(w2c)
        # COLMAP camera coords -> OpenGL
        c2w[0:3, 1:3] *= -1
        # world: swap y and z, flip z
        c2w = c2w[np.array([0, 2, 1, 3]), :]
        c2w[2, :] *= -1

        name = im_data.name
        if image_rename_map is not None:
            name = image_rename_map.get(name, name)
        frame = {
            "file_path": (Path("images") / name).as_posix(),
            "transform_matrix": c2w.tolist(),
            "colmap_im_id": im_id,
        }
        frames.append(frame)

    if len(cameras) != 1:
        raise RuntimeError("expected a single COLMAP camera (single_camera 1)")
    out = parse_colmap_camera_params(next(iter(cameras.values())))
    out["frames"] = frames

    # world transform applied relative to original COLMAP coords
    applied_transform = np.eye(4)[:3]
    applied_transform = applied_transform[np.array([0, 2, 1]), :]
    applied_transform[2, :] *= -1
    out["applied_transform"] = applied_transform.tolist()

    with open(Path(output_dir) / "transforms.json", "w", encoding="utf-8") as f:
        json.dump(out, f, indent=4)
    return len(frames)
