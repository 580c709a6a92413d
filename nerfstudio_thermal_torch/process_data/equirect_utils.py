"""Equirectangular -> perspective planar projections (for 360 captures).
(a copy of nerfstudio_thermal_tpu/process_data/equirect_utils.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/process_data/equirect_utils.py`
(`equirect2persp:86-158` — OmniCV-style spherical remap,
`generate_planar_projections_from_equirectangular:233-321` — 8/14-view
yaw-pitch rigs with crop-aware bounds,
`compute_resolution_from_equirect:323-338`). The reference runs the remap on
CUDA via torch grid_sample; this is host-side preprocessing, so numpy builds
the sampling grid and cv2.remap interpolates.
"""

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def _rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Euler-Rodrigues rotation (reference equirect_utils.py:31-54)."""
    axis = axis / np.sqrt(axis @ axis)
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array(
        [
            [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
            [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
            [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc],
        ]
    )


def equirect2persp(
    img: np.ndarray, fov: float, theta: float, phi: float, hd: int, wd: int
) -> np.ndarray:
    """Perspective view (yaw `theta`, pitch `phi`, both degrees) from an
    equirectangular image [H, W, C] (reference :86-158)."""
    import cv2  # host-only: OpenCV is not on the card's machine

    equ_h, equ_w = img.shape[:2]
    equ_cx, equ_cy = equ_w / 2.0, equ_h / 2.0
    wfov = fov
    hfov = float(hd) / wd * wfov
    c_x, c_y = wd / 2.0, hd / 2.0

    w_interval = 2 * np.tan(np.deg2rad(wfov / 2.0)) / wd
    h_interval = 2 * np.tan(np.deg2rad(hfov / 2.0)) / hd

    x_map = np.ones((hd, wd), np.float32)
    y_map = np.tile((np.arange(wd) - c_x) * w_interval, (hd, 1))
    z_map = -np.tile((np.arange(hd) - c_y) * h_interval, (wd, 1)).T
    D = np.sqrt(x_map**2 + y_map**2 + z_map**2)
    xyz = np.stack([x_map / D, y_map / D, z_map / D], -1).reshape(-1, 3)

    z_axis = np.array([0.0, 0.0, 1.0])
    y_axis = np.array([0.0, 1.0, 0.0])
    R1 = _rotation_matrix(z_axis, np.deg2rad(theta))
    R2 = _rotation_matrix(R1 @ y_axis, np.deg2rad(-phi))
    xyz = (R2 @ (R1 @ xyz.T)).T

    lat = np.arcsin(np.clip(xyz[:, 2], -1, 1))
    t = np.arctan2(xyz[:, 1], xyz[:, 0])  # handles all quadrants
    lon = t.reshape(hd, wd) / np.pi * 180
    lat = -lat.reshape(hd, wd) / np.pi * 180
    lon = (lon / 180 * equ_cx + equ_cx).astype(np.float32)
    lat = (lat / 90 * equ_cy + equ_cy).astype(np.float32)
    return cv2.remap(
        img, lon, lat, interpolation=cv2.INTER_CUBIC,
        borderMode=cv2.BORDER_WRAP,
    )


def _crop_bound_arr_vertical(
    bound_arr: List[float], fov: float, crop_factor
) -> List[Optional[float]]:
    """(reference :161-230): drop/shift vertical bounds for top/bottom crops."""
    top, bottom = crop_factor[0], crop_factor[1]
    out: List[Optional[float]] = list(bound_arr)
    if bottom > 0:
        chopped = 180 * bottom
        new_bottom = 90 - chopped - fov / 2
        out[0] = None if (out[0] is not None and out[0] < -new_bottom) else out[0]
    if top > 0:
        chopped = 180 * top
        new_top = -90 + chopped + fov / 2
        out[2] = None if (out[2] is not None and out[2] > -new_top + fov) else out[2]
    return out


def compute_resolution_from_equirect(image_dir: Path, num_images: int) -> Tuple[int, int]:
    """(reference :323-338): num_images * res^2 = H * W."""
    import cv2  # host-only: OpenCV is not on the card's machine

    for name in os.listdir(image_dir):
        if name.lower().endswith((".jpg", ".png", ".jpeg", ".tiff", ".tif")):
            im = cv2.imread(str(Path(image_dir) / name))
            r = int(np.sqrt(im.shape[0] * im.shape[1] / num_images))
            return (r, r)
    raise ValueError("no images found in the directory")


def generate_planar_projections_from_equirectangular(
    image_dir: Path,
    planar_image_size: Tuple[int, int],
    samples_per_im: int,
    crop_factor: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
) -> Path:
    """(reference :233-321): 8-view (fov 120) or 14-view (fov 110) rigs."""
    import cv2  # host-only: OpenCV is not on the card's machine

    for c in crop_factor:
        if c < 0 or c > 1:
            raise ValueError("crop factors must be in [0, 1]")
    left_bound, right_bound = -180.0, 180.0
    if crop_factor[3] > 0:
        left_bound = -180 + 360 * crop_factor[3]
    if crop_factor[2] > 0:
        right_bound = 180 - 360 * crop_factor[2]

    if samples_per_im == 8:
        fov = 120.0
        bound_arr = _crop_bound_arr_vertical([-45.0, 0.0, 45.0], fov, crop_factor)
        steps = (180.0, 90.0, 180.0)  # bottom, middle, top yaw steps
    elif samples_per_im == 14:
        fov = 110.0
        bound_arr = _crop_bound_arr_vertical([-45.0, 0.0, 45.0], fov, crop_factor)
        steps = (90.0, 60.0, 90.0)
    else:
        raise ValueError("samples_per_im must be 8 or 14")

    yaw_pitch_pairs = []
    if bound_arr[1] is not None:
        for yaw in np.arange(left_bound, right_bound, steps[1]):
            yaw_pitch_pairs.append((float(yaw), bound_arr[1]))
    if bound_arr[2] is not None:
        for yaw in np.arange(left_bound, right_bound, steps[2]):
            yaw_pitch_pairs.append((float(yaw), bound_arr[2]))
    if bound_arr[0] is not None:
        for yaw in np.arange(left_bound, right_bound, steps[0]):
            yaw_pitch_pairs.append((float(yaw), bound_arr[0]))

    image_dir = Path(image_dir)
    output_dir = image_dir / "planar_projections"
    output_dir.mkdir(exist_ok=True)
    for name in sorted(os.listdir(image_dir)):
        if not name.lower().endswith((".jpg", ".png", ".jpeg", ".tiff", ".tif")):
            continue
        im = cv2.imread(str(image_dir / name))
        for count, (yaw, pitch) in enumerate(yaw_pitch_pairs):
            pers = equirect2persp(
                im, fov, yaw, pitch, planar_image_size[1], planar_image_size[0]
            )
            cv2.imwrite(str(output_dir / f"{Path(name).stem}_{count}.jpg"), pers)
    return output_dir
