"""Circle-grid RGB <-> thermal calibration (host side, OpenCV).
(a copy of nerfstudio_thermal_tpu/process_data/calibration_utils.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/process_data/calibration_utils.py` —
asymmetric 4x11 circle grid with 3.8 cm center-center spacing hard-coded in
OpenCV coords (:11-29, made configurable here), blob-detector +
findCirclesGrid with separate RGB/thermal binarization and automatic
image-inversion retry (`circle_detect:32-185`), per-camera intrinsics via
cv2.calibrateCamera with 5 calibration modes (`estimate_intrinsics:188-312`),
and joint cv2.stereoCalibrate for the RGB->thermal rigid transform
(the *second* `calibrate_rgb_thermal` definition at :568-731 — the reference
shadows an earlier one at :444; only the later is live behavior).

One repair over the JAX package's copy: `circle_detect` returns its
centres as [N, 1, 2] whatever OpenCV's version (OpenCV 5's
findCirclesGrid gives [N, 2], on which the JAX package's
`estimate_intrinsics` fails in cv2.norm).
"""

import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".tiff", ".bmp", ".gif")


def get_calibration_target_circle_centers(
    center_center_cm: float = 3.8, cols: int = 11, rows: int = 4
) -> np.ndarray:
    """3D circle centers of the asymmetric grid (reference :11-29).
    Default: 1.5 cm circles at 3.8 cm center-center spacing."""
    c_c = center_center_cm
    objpoints = []
    for col in range(cols):
        ypt = c_c / 2 * col
        for row in range(rows):
            xpt = c_c * row + (c_c / 2 if col % 2 else 0.0)
            objpoints.append([ypt, xpt, 0.0])
    return np.array(objpoints, dtype=np.float32)


def _blob_detector(is_thermal: bool):
    import cv2  # host-only: OpenCV is not on the card's machine

    params = cv2.SimpleBlobDetector_Params()
    params.filterByColor = True
    params.minThreshold = 128
    params.filterByArea = True
    params.filterByConvexity = True
    params.minConvexity = 0.80
    params.filterByInertia = False
    params.minInertiaRatio = 0.01
    if not is_thermal:
        params.minArea = 400
        params.filterByCircularity = False
        params.minCircularity = 0.8
    else:
        params.minArea = 150
        params.filterByCircularity = True
        params.minCircularity = 0.5
    return cv2.SimpleBlobDetector_create(params)


def circle_detect(
    captured_img: np.ndarray,
    num_circles: Tuple[int, int] = (4, 11),
    is_thermal: bool = False,
    invert_img: bool = False,
) -> Tuple[Optional[np.ndarray], bool]:
    """Detect asymmetric circle-grid centers; retries with the image inverted
    on failure (reference circle_detect:32-185)."""
    import cv2  # host-only: OpenCV is not on the card's machine

    img = captured_img.copy()
    if img.ndim > 2:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)

    if not is_thermal:
        img = cv2.medianBlur(img, 5)
    else:
        img = cv2.medianBlur(img, 5)
        img = cv2.bilateralFilter(img, 9, 35, 35)
    if invert_img:
        img = cv2.bitwise_not(img)
    img = cv2.adaptiveThreshold(
        img, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, 121, 10
    )
    img = cv2.GaussianBlur(img, (5, 5), 0, 0)

    detector = _blob_detector(is_thermal)
    found_dots, centers = cv2.findCirclesGrid(
        img,
        patternSize=num_circles,
        blobDetector=detector,
        flags=cv2.CALIB_CB_ASYMMETRIC_GRID + cv2.CALIB_CB_CLUSTERING,
    )
    if not found_dots and not invert_img:
        return circle_detect(
            captured_img, num_circles=num_circles, is_thermal=is_thermal, invert_img=True
        )
    if centers is not None:
        # OpenCV 5 returns [N, 2]; calibrateCamera's image points and
        # cv2.norm against projectPoints want OpenCV 4's [N, 1, 2]
        centers = centers.reshape(-1, 1, 2)
    return centers, bool(found_dots)


def _calibration_flags(
    force_tangential_zero: bool, force_k1_k2_zero: bool, force_k3_zero: bool
) -> int:
    import cv2  # host-only: OpenCV is not on the card's machine

    flags = 0
    if force_tangential_zero:
        flags += cv2.CALIB_ZERO_TANGENT_DIST
    if force_k3_zero:
        flags += cv2.CALIB_FIX_K3
    if force_k1_k2_zero:
        flags += cv2.CALIB_FIX_K1 + cv2.CALIB_FIX_K2
    return flags


def estimate_intrinsics(
    image_file_names: Sequence[str],
    marker_coordinates: np.ndarray,
    imgsize: Tuple[int, int] = (320, 320),
    intrinsic_calibration_mode: int = 2,
    force_tangential_distortion_coeffs_to_zero: bool = True,
    force_radial_distortion_coeff_K1_K2_to_zero: bool = False,
    force_radial_distortion_coeff_K3_to_zero: bool = True,
    upsample_size: Optional[Tuple[int, int]] = None,
) -> dict:
    """Per-camera intrinsics from circle-grid detections
    (reference estimate_intrinsics:188-312). Modes:
    0 free; 1 fix principal point; 2 fix fx==fy; 3 both; 4 fx==fy, no guess.
    """
    import cv2  # host-only: OpenCV is not on the card's machine

    upsample_ratio = 1.0
    if upsample_size is not None:
        upsample_ratio = upsample_size[0] / imgsize[0]
        imgsize = upsample_size

    objpoints, imgpoints = [], []
    valid = np.zeros(len(image_file_names))
    for k, fname in enumerate(image_file_names):
        img = cv2.imread(str(fname))
        is_thermal = "thermal" in os.path.basename(str(fname))
        corners, found = circle_detect(img, is_thermal=is_thermal)
        if found:
            objpoints.append(marker_coordinates)
            imgpoints.append(corners * upsample_ratio)
            valid[k] = 1

    flags = _calibration_flags(
        force_tangential_distortion_coeffs_to_zero,
        force_radial_distortion_coeff_K1_K2_to_zero,
        force_radial_distortion_coeff_K3_to_zero,
    )

    if intrinsic_calibration_mode == 0:
        ret, mtx, dist, rvecs, tvecs = cv2.calibrateCamera(
            objpoints, imgpoints, imgsize, None, None, flags=flags
        )
    elif intrinsic_calibration_mode == 4:
        flags += cv2.CALIB_FIX_ASPECT_RATIO
        ret, mtx, dist, rvecs, tvecs = cv2.calibrateCamera(
            objpoints, imgpoints, imgsize, None, None, flags=flags
        )
    else:
        mtx = np.array(
            [
                [1000.0, 0.0, imgsize[0] / 2.0],
                [0.0, 1000.0, imgsize[1] / 2.0],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )
        if intrinsic_calibration_mode == 1:
            flags += cv2.CALIB_USE_INTRINSIC_GUESS + cv2.CALIB_FIX_PRINCIPAL_POINT
        elif intrinsic_calibration_mode == 2:
            flags += cv2.CALIB_USE_INTRINSIC_GUESS + cv2.CALIB_FIX_ASPECT_RATIO
        elif intrinsic_calibration_mode == 3:
            flags += (
                cv2.CALIB_USE_INTRINSIC_GUESS
                + cv2.CALIB_FIX_ASPECT_RATIO
                + cv2.CALIB_FIX_PRINCIPAL_POINT
            )
        ret, mtx, dist, rvecs, tvecs = cv2.calibrateCamera(
            objpoints, imgpoints, imgsize, mtx, None, flags=flags
        )

    mean_error = 0.0
    for k in range(len(objpoints)):
        projected, _ = cv2.projectPoints(objpoints[k], rvecs[k], tvecs[k], mtx, dist)
        mean_error += cv2.norm(imgpoints[k], projected, cv2.NORM_L2) / len(projected)
    if objpoints:
        mean_error /= len(objpoints)

    return {
        "camera_matrix": mtx,
        "distortion_coeffs": dist,
        "rvecs": rvecs,
        "tvecs": tvecs,
        "rmse": mean_error,
        "valid_image_idx": valid,
    }


def _image_files(folders: Sequence) -> List[str]:
    out = []
    for folder in folders:
        for f in sorted(os.listdir(folder)):
            p = os.path.join(folder, f)
            if os.path.isfile(p) and f.lower().endswith(IMAGE_SUFFIXES):
                out.append(p)
    return sorted(out)


def calibrate_camera(
    folders: Sequence,
    intrinsic_calibration_mode: int = 2,
    upsample_size: Optional[Tuple[int, int]] = None,
    **kwargs,
) -> dict:
    """Intrinsics over all grid images in folders (reference :361-441)."""
    import cv2  # host-only: OpenCV is not on the card's machine

    files = _image_files(folders)
    imgsize = cv2.imread(files[0]).shape[:2]
    return estimate_intrinsics(
        files,
        get_calibration_target_circle_centers(),
        imgsize=imgsize,
        intrinsic_calibration_mode=intrinsic_calibration_mode,
        upsample_size=upsample_size,
        **kwargs,
    )


def calibrate_rgb_thermal(
    rgb_folders: Sequence,
    thermal_folders: Sequence,
    intrinsic_calibration_mode: int = 2,
    force_tangential_distortion_coeffs_to_zero: bool = False,
    force_radial_distortion_coeff_K1_K2_to_zero: bool = False,
    force_radial_distortion_coeff_K3_to_zero: bool = True,
    upsample_thermal: bool = False,
) -> dict:
    """Joint RGB/thermal calibration: per-camera intrinsics then
    cv2.stereoCalibrate for the rigid RGB->thermal transform
    (reference calibrate_rgb_thermal:568-731)."""
    import cv2  # host-only: OpenCV is not on the card's machine

    rgb_files = _image_files(rgb_folders)
    thermal_files = _image_files(thermal_folders)
    assert all(
        rgb_files[i].replace("rgb", "thermal") == thermal_files[i]
        for i in range(len(rgb_files))
    ), "rgb and thermal calibration filenames must pair up"

    rgb_imgsize = cv2.imread(rgb_files[0]).shape[:2]
    thermal_imgsize = cv2.imread(thermal_files[0]).shape[:2]
    if upsample_thermal:
        upsample_size = rgb_imgsize
        upsample_ratio = rgb_imgsize[0] / thermal_imgsize[0]
    else:
        upsample_size = None
        upsample_ratio = 1.0

    marker_coordinates = get_calibration_target_circle_centers()

    objpoints, rgb_imgpoints, thermal_imgpoints = [], [], []
    for rf, tf in zip(rgb_files, thermal_files):
        rgb_corners, rgb_found = circle_detect(cv2.imread(rf), is_thermal=False)
        t_corners, t_found = circle_detect(cv2.imread(tf), is_thermal=True)
        if rgb_found and t_found:
            objpoints.append(marker_coordinates)
            rgb_imgpoints.append(rgb_corners)
            thermal_imgpoints.append(t_corners * upsample_ratio)
    print(f"found rgb+thermal dots for {len(objpoints)} / {len(rgb_files)} images")

    flags = _calibration_flags(
        force_tangential_distortion_coeffs_to_zero,
        force_radial_distortion_coeff_K1_K2_to_zero,
        force_radial_distortion_coeff_K3_to_zero,
    )

    result_rgb = calibrate_camera(
        rgb_folders,
        intrinsic_calibration_mode=intrinsic_calibration_mode,
        force_tangential_distortion_coeffs_to_zero=force_tangential_distortion_coeffs_to_zero,
        force_radial_distortion_coeff_K1_K2_to_zero=force_radial_distortion_coeff_K1_K2_to_zero,
        force_radial_distortion_coeff_K3_to_zero=force_radial_distortion_coeff_K3_to_zero,
    )
    result_thermal = calibrate_camera(
        thermal_folders,
        intrinsic_calibration_mode=intrinsic_calibration_mode,
        force_tangential_distortion_coeffs_to_zero=force_tangential_distortion_coeffs_to_zero,
        force_radial_distortion_coeff_K1_K2_to_zero=force_radial_distortion_coeff_K1_K2_to_zero,
        force_radial_distortion_coeff_K3_to_zero=force_radial_distortion_coeff_K3_to_zero,
        upsample_size=upsample_size,
    )

    flags += cv2.CALIB_FIX_ASPECT_RATIO + cv2.CALIB_USE_INTRINSIC_GUESS
    ret, mtx_rgb, dist_rgb, mtx_thermal, dist_thermal, R, T, E, F = cv2.stereoCalibrate(
        objpoints,
        rgb_imgpoints,
        thermal_imgpoints,
        result_rgb["camera_matrix"],
        result_rgb["distortion_coeffs"],
        result_thermal["camera_matrix"],
        result_thermal["distortion_coeffs"],
        rgb_imgsize,
        flags=flags,
    )

    M = np.identity(4)
    M[:3, 3] = T.squeeze()
    M[:3, :3] = R

    return {
        "camera_matrix_rgb": mtx_rgb,
        "camera_matrix_thermal": mtx_thermal,
        "distortion_coeffs_rgb": dist_rgb,
        "distortion_coeffs_thermal": dist_thermal,
        "rgb_thermal_transform": M,
        "thermal_rgb_transform": np.linalg.inv(M),
        "rmse": ret,
    }
