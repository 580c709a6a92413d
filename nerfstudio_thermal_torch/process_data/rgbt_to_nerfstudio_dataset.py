"""`ns-process-data rgbt`: FLIR captures -> trainable RGB+thermal dataset.
(a copy of nerfstudio_thermal_tpu/process_data/rgbt_to_nerfstudio_dataset.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/process_data/rgbt_to_nerfstudio_dataset.py:17-275`:
1. extract raw RGB + temperature images from FLIR JPEGs (exiftool);
2. circle-grid stereo calibration -> RGB/thermal intrinsics + distortion +
   the RGB->thermal rigid transform;
3. COLMAP on RGB with fixed calibrated intrinsics;
4. metric scale fix from a known image pair (the reference hard-codes frames
   3 & 4 at 1 ft apart, :221-232 — configurable here with the same default);
5. rewrite transforms.json with per-frame intrinsics, thermal frames at pose
   M_rgb @ M_world_colmap @ M_thermal_rgb @ M_colmap_world, and is_thermal
   flags (:239-273).
"""

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from nerfstudio_thermal_torch.process_data import (
    calibration_utils,
    colmap_utils,
    flir_utils,
    process_data_utils,
)
from nerfstudio_thermal_torch.process_data.images_to_nerfstudio_dataset import (
    ImagesToNerfstudioDataset,
)
from nerfstudio_thermal_torch.process_data.process_data_utils import CAMERA_MODELS


@dataclass
class RGBTToNerfstudioDataset(ImagesToNerfstudioDataset):
    """Process FLIR RGB+thermal captures into a thermal nerfstudio dataset."""

    calibration_data: Optional[List[Path]] = None
    """Paths to directories containing circle-grid calibration captures."""
    thermal_data: Optional[Path] = None
    """Thermal image dir; None = extracted alongside RGB from FLIR JPEGs."""
    eval_thermal_data: Optional[Path] = None
    upsample_thermal: bool = False
    skip_calibration_processing: bool = False
    scale_pair: tuple = ("images/frame_00003.png", "images/frame_00004.png")
    """Image pair with known real-world separation for the metric scale fix
    (the reference hard-codes this pair, :221-224)."""
    scale_pair_distance_cm: float = 12.0 * 2.54
    """Real-world distance between the scale_pair camera centers (1 ft)."""

    def __post_init__(self) -> None:
        self.data = Path(self.data)
        if not self.skip_image_processing:
            flir_utils.extract_raws_from_dir(
                self.data, upsample_thermal=self.upsample_thermal
            )
            self.data = self.data.parent / (self.data.name + "_raw") / "rgb"
        elif self.thermal_data is None:
            self.data = self.data / "images"
        super().__post_init__()
        if self.thermal_data is None:
            if not self.skip_image_processing:
                self.thermal_data = self.data.parent / "thermal"
            else:
                self.thermal_data = self.data.parent / "images_thermal"
        self.mat_rgb = None
        self.dist_rgb = None

    @staticmethod
    def _rgb_to_thermal_path(path: str) -> str:
        return path.replace("images", "images_thermal")

    @property
    def thermal_image_dir(self) -> Path:
        return self.output_dir / "images_thermal"

    def _run_colmap(self, mask_path: Optional[Path] = None):
        """COLMAP with calibrated RGB intrinsics fixed (reference :59-114)."""
        self.absolute_colmap_path.mkdir(parents=True, exist_ok=True)
        image_dir = self.data if self.skip_image_processing else self.image_dir
        colmap_utils.run_colmap(
            image_dir=image_dir,
            colmap_dir=self.absolute_colmap_path,
            camera_model=CAMERA_MODELS[self.camera_type],
            camera_mask_path=mask_path,
            gpu=self.gpu,
            verbose=self.verbose,
            matching_method=self.matching_method,
            colmap_cmd=self.colmap_cmd,
            camera_matrix=self.mat_rgb,
            dist_coeffs=self.dist_rgb,
        )

    def main(self) -> None:
        cal_result = None
        if self.calibration_data is not None:
            if not self.skip_calibration_processing:
                for path in self.calibration_data:
                    flir_utils.extract_raws_from_dir(path, normalize_per_image=True)
            cal_rgb_dirs = [f"{p}_raw/rgb" for p in self.calibration_data]
            cal_thermal_dirs = [f"{p}_raw/thermal" for p in self.calibration_data]
            cal_result = calibration_utils.calibrate_rgb_thermal(
                cal_rgb_dirs,
                cal_thermal_dirs,
                intrinsic_calibration_mode=4,
                force_radial_distortion_coeff_K3_to_zero=True,
                upsample_thermal=self.upsample_thermal,
            )
            self.mat_rgb = cal_result["camera_matrix_rgb"]
            self.dist_rgb = cal_result["distortion_coeffs_rgb"]

        # RGB processing + COLMAP (with fixed intrinsics when calibrated)
        super().main()

        # Copy thermal images next to the RGB ones
        if not self.skip_image_processing:
            process_data_utils.copy_images(
                self.thermal_data,
                image_dir=self.thermal_image_dir,
                crop_factor=self.crop_factor,
                image_prefix="frame_train_" if self.eval_data is not None else "frame_",
                verbose=self.verbose,
                num_downscales=0,
                same_dimensions=self.same_dimensions,
                keep_image_dir=False,
            )
            if self.eval_data is not None:
                process_data_utils.copy_images(
                    self.eval_thermal_data,
                    image_dir=self.thermal_image_dir,
                    crop_factor=self.crop_factor,
                    image_prefix="frame_eval_",
                    verbose=self.verbose,
                    num_downscales=0,
                    same_dimensions=self.same_dimensions,
                    keep_image_dir=True,
                )

        self.append_thermal_frames(cal_result)
        print("done processing thermal data")

    def append_thermal_frames(self, cal_result) -> None:
        """Rewrite transforms.json with thermal frames (reference :166-273)."""
        import cv2  # host-only: OpenCV is not on the card's machine

        tpath = self.output_dir / "transforms.json"
        file_data = json.loads(tpath.read_text())

        first_thermal = self.output_dir / self._rgb_to_thermal_path(
            file_data["frames"][0]["file_path"]
        )
        h_thermal, w_thermal = cv2.imread(str(first_thermal)).shape[:2]

        rgb_camera_params = {"w": file_data["w"], "h": file_data["h"]}
        thermal_camera_params = {"w": w_thermal, "h": h_thermal}

        M_colmap_world = np.identity(4)
        M_world_colmap = np.identity(4)
        M_thermal_rgb = np.identity(4)
        world_colmap_scale = 1.0

        if cal_result is not None:
            mat_rgb, mat_thermal = (
                cal_result["camera_matrix_rgb"], cal_result["camera_matrix_thermal"],
            )
            dist_rgb = np.asarray(cal_result["distortion_coeffs_rgb"]).squeeze()
            dist_thermal = np.asarray(cal_result["distortion_coeffs_thermal"]).squeeze()
            k1r, k2r, p1r, p2r = dist_rgb[:4]
            k1t, k2t, p1t, p2t = dist_thermal[:4]
            rgb_camera_params.update(
                fl_x=float(mat_rgb[0, 0]), fl_y=float(mat_rgb[1, 1]),
                cx=float(mat_rgb[0, 2]), cy=float(mat_rgb[1, 2]),
                k1=float(k1r), k2=float(k2r), p1=float(p1r), p2=float(p2r),
            )
            thermal_camera_params.update(
                fl_x=float(mat_thermal[0, 0]), fl_y=float(mat_thermal[1, 1]),
                cx=float(mat_thermal[0, 2]), cy=float(mat_thermal[1, 2]),
                k1=float(k1t), k2=float(k2t), p1=float(p1t), p2=float(p2t),
            )

            # Metric scale from a known-baseline image pair (reference :221-232).
            img1, img2 = self.scale_pair
            frame1 = next((x for x in file_data["frames"] if x["file_path"] == img1), None)
            frame2 = next((x for x in file_data["frames"] if x["file_path"] == img2), None)
            if frame1 is not None and frame2 is not None:
                M1 = np.array(frame1["transform_matrix"])
                M2 = np.array(frame2["transform_matrix"])
                colmap_distance = np.linalg.norm(
                    (M1 - M2) @ np.array([0.0, 0.0, 0.0, 1.0])
                )
                world_colmap_scale = colmap_distance / self.scale_pair_distance_cm
                for i in range(3):
                    M_world_colmap[i, i] = world_colmap_scale
                    M_colmap_world[i, i] = 1.0 / world_colmap_scale
            else:
                print(
                    f"warning: scale pair {self.scale_pair} not found; leaving "
                    "metric scale at 1"
                )
            M_thermal_rgb = cal_result["thermal_rgb_transform"]

        camera_params = thermal_camera_params.keys()

        thermal_frames = []
        for i, frame in enumerate(file_data["frames"]):
            thermal_frame = {
                "file_path": self._rgb_to_thermal_path(frame["file_path"]),
                "transform_matrix": (
                    np.array(frame["transform_matrix"])
                    @ M_world_colmap
                    @ M_thermal_rgb
                    @ M_colmap_world
                ).tolist(),
                "colmap_im_id": frame.get("colmap_im_id", i)
                + len(file_data["frames"]),
                "is_thermal": 1,
            }
            for param in camera_params:
                thermal_frame[param] = thermal_camera_params[param]
            thermal_frames.append(thermal_frame)

            file_data["frames"][i]["is_thermal"] = 0
            for param in camera_params:
                file_data["frames"][i][param] = rgb_camera_params.get(
                    param, file_data.get(param)
                )

        file_data["frames"] += thermal_frames
        for param in camera_params:
            file_data.pop(param, None)

        tpath.write_text(json.dumps(file_data, indent=4))
