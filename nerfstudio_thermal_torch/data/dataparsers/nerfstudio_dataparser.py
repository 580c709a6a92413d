"""Nerfstudio-format (transforms.json) dataparser and its ThermalNerf
variant (counterpart of nerfstudio_thermal_tpu/data/dataparsers/
nerfstudio_dataparser.py).

Frames sorted by resolved filename, per-frame or global intrinsics and
distortion, orientation/centering/auto-scaling of poses, eval split modes,
downscale folder redirection (image sizes read from the PNG header),
per-frame `metadata_keys`, and the applied_transform/applied_scale
round-trip. The cameras are the port's, as CPU tensors.
"""

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Literal, Optional, Tuple

import numpy as np
import torch

from nerfstudio_thermal_torch.cameras import camera_utils
from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType
from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
)
from nerfstudio_thermal_torch.data.utils.dataparsers_utils import (
    get_train_eval_split_all,
    get_train_eval_split_filename,
    get_train_eval_split_fraction,
    get_train_eval_split_interval,
)

MAX_AUTO_RESOLUTION = 1600

CAMERA_MODEL_TO_TYPE = {
    "SIMPLE_PINHOLE": CameraType.PERSPECTIVE,
    "PINHOLE": CameraType.PERSPECTIVE,
    "SIMPLE_RADIAL": CameraType.PERSPECTIVE,
    "RADIAL": CameraType.PERSPECTIVE,
    "OPENCV": CameraType.PERSPECTIVE,
    "OPENCV_FISHEYE": CameraType.FISHEYE,
    "EQUIRECTANGULAR": CameraType.EQUIRECTANGULAR,
    "OMNIDIRECTIONALSTEREO_L": CameraType.OMNIDIRECTIONALSTEREO_L,
    "OMNIDIRECTIONALSTEREO_R": CameraType.OMNIDIRECTIONALSTEREO_R,
    "VR180_L": CameraType.VR180_L,
    "VR180_R": CameraType.VR180_R,
    "FISHEYE624": CameraType.FISHEYE624,
}


@dataclass
class NerfstudioDataParserConfig(DataParserConfig):
    """(reference nerfstudio_dataparser.py:44-87)."""

    data: Path = Path()
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: Literal["pca", "up", "vertical", "none"] = "up"
    center_method: Literal["poses", "focus", "none"] = "poses"
    auto_scale_poses: bool = True
    eval_mode: Literal["fraction", "filename", "interval", "all"] = "fraction"
    train_split_fraction: float = 0.9
    eval_interval: int = 8
    depth_unit_scale_factor: float = 1e-3


class Nerfstudio(DataParser):
    config: NerfstudioDataParserConfig

    def __init__(self, config: NerfstudioDataParserConfig):
        super().__init__(config)
        self.downscale_factor = config.downscale_factor

    def _get_fname(self, filepath: Path, data_dir: Path, downsample_folder_prefix="images_") -> Path:
        """Resolve a frame path, redirecting into the downscale folder."""
        if self.downscale_factor is None:
            test_img = data_dir / filepath
            df = 0
            if test_img.exists():
                try:
                    from nerfstudio_thermal_torch.data.datasets import image_size

                    w, h = image_size(test_img)
                    while max(h, w) // (2 ** (df + 1)) > MAX_AUTO_RESOLUTION and (
                        data_dir / f"{downsample_folder_prefix}{2 ** (df + 1)}" / filepath.name
                    ).exists():
                        df += 1
                except Exception:
                    df = 0
            self.downscale_factor = 2**df
        if self.downscale_factor > 1:
            return data_dir / f"{downsample_folder_prefix}{self.downscale_factor}" / filepath.name
        return data_dir / filepath

    def _generate_dataparser_outputs(self, split: str = "train", metadata_keys: Tuple[str, ...] = ()):
        cfg = self.config
        data = Path(cfg.data)
        if data.suffix == ".json":
            meta = json.loads(data.read_text())
            data_dir = data.parent
        else:
            meta = json.loads((data / "transforms.json").read_text())
            data_dir = data

        fx_fixed = "fl_x" in meta
        fy_fixed = "fl_y" in meta
        cx_fixed = "cx" in meta
        cy_fixed = "cy" in meta
        height_fixed = "h" in meta
        width_fixed = "w" in meta
        distort_fixed = any(
            k in meta for k in ("k1", "k2", "k3", "p1", "p2", "distortion_params")
        )

        # sort the frames by resolved fname (reference :125-132)
        fnames = [
            self._get_fname(Path(frame["file_path"]), data_dir)
            for frame in meta["frames"]
        ]
        inds = np.argsort([str(f) for f in fnames])
        frames = [meta["frames"][i] for i in inds]

        def frame_distortion(src):
            if "distortion_params" in src:
                return np.asarray(src["distortion_params"], np.float32)
            return camera_utils.get_distortion_params(
                k1=float(src.get("k1", 0)), k2=float(src.get("k2", 0)),
                k3=float(src.get("k3", 0)), k4=float(src.get("k4", 0)),
                p1=float(src.get("p1", 0)), p2=float(src.get("p2", 0)),
            )

        image_filenames, mask_filenames, depth_filenames, poses = [], [], [], []
        fx, fy, cx, cy, height, width, distort = [], [], [], [], [], [], []
        for frame in frames:
            fname = self._get_fname(Path(frame["file_path"]), data_dir)
            image_filenames.append(fname)
            if "depth_file_path" in frame:
                depth_filenames.append(
                    self._get_fname(Path(frame["depth_file_path"]), data_dir, "depths_")
                )
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
            if not fx_fixed:
                fx.append(float(frame["fl_x"]))
            if not fy_fixed:
                fy.append(float(frame["fl_y"]))
            if not cx_fixed:
                cx.append(float(frame["cx"]))
            if not cy_fixed:
                cy.append(float(frame["cy"]))
            if not height_fixed:
                height.append(int(frame["h"]))
            if not width_fixed:
                width.append(int(frame["w"]))
            if not distort_fixed:
                distort.append(frame_distortion(frame))
            if "mask_path" in frame:
                mask_filenames.append(
                    self._get_fname(Path(frame["mask_path"]), data_dir, "masks_")
                )

        # split selection (reference :196-229)
        if f"{split}_filenames" in meta:
            split_filenames = set(
                str(self._get_fname(Path(x), data_dir)) for x in meta[f"{split}_filenames"]
            )
            indices = np.array(
                [i for i, p in enumerate(image_filenames) if str(p) in split_filenames],
                np.int32,
            )
        else:
            if cfg.eval_mode == "fraction":
                i_train, i_eval = get_train_eval_split_fraction(
                    image_filenames, cfg.train_split_fraction
                )
            elif cfg.eval_mode == "filename":
                i_train, i_eval = get_train_eval_split_filename(image_filenames)
            elif cfg.eval_mode == "interval":
                i_train, i_eval = get_train_eval_split_interval(
                    image_filenames, cfg.eval_interval
                )
            elif cfg.eval_mode == "all":
                i_train, i_eval = get_train_eval_split_all(image_filenames)
            else:
                raise ValueError(f"unknown eval mode {cfg.eval_mode}")
            indices = i_train if split == "train" else i_eval

        orientation_method = meta.get("orientation_override", cfg.orientation_method)
        poses = np.stack(poses)
        poses, transform_matrix = camera_utils.auto_orient_and_center_poses(
            poses, method=orientation_method, center_method=cfg.center_method
        )

        scale_factor = 1.0
        if cfg.auto_scale_poses:
            scale_factor /= float(np.max(np.abs(poses[:, :3, 3])))
        scale_factor *= cfg.scale_factor
        poses[:, :3, 3] *= scale_factor

        image_filenames = [image_filenames[i] for i in indices]
        mask_filenames = [mask_filenames[i] for i in indices] if mask_filenames else []
        depth_filenames = (
            [depth_filenames[i] for i in indices] if depth_filenames else []
        )
        poses = poses[indices]

        aabb = cfg.scene_scale * np.array(
            [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32
        )

        camera_type = CAMERA_MODEL_TO_TYPE.get(
            meta.get("camera_model", ""), CameraType.PERSPECTIVE
        )

        def fixed_or_per_frame(fixed, key, values, dtype=np.float32):
            if fixed:
                return np.full((len(indices),), float(meta[key]), dtype)
            return np.asarray(values, dtype)[indices]

        fx_arr = fixed_or_per_frame(fx_fixed, "fl_x", fx)
        fy_arr = fixed_or_per_frame(fy_fixed, "fl_y", fy)
        cx_arr = fixed_or_per_frame(cx_fixed, "cx", cx)
        cy_arr = fixed_or_per_frame(cy_fixed, "cy", cy)
        h_arr = fixed_or_per_frame(height_fixed, "h", height, np.int32).astype(np.int32)
        w_arr = fixed_or_per_frame(width_fixed, "w", width, np.int32).astype(np.int32)
        if distort_fixed:
            dist_arr = np.tile(frame_distortion(meta), (len(indices), 1))
        else:
            dist_arr = np.stack(distort)[indices]

        scaling = 1.0 / (self.downscale_factor or 1)
        arrays = dict(
            camera_to_worlds=poses[:, :3, :4].astype(np.float32),
            fx=(fx_arr * scaling).astype(np.float32),
            fy=(fy_arr * scaling).astype(np.float32),
            cx=(cx_arr * scaling).astype(np.float32),
            cy=(cy_arr * scaling).astype(np.float32),
            width=(w_arr * scaling).astype(np.int32),
            height=(h_arr * scaling).astype(np.int32),
            distortion_params=dist_arr.astype(np.float32),
            camera_type=np.full((len(indices),), camera_type.value, np.int32),
        )
        cameras = Cameras(**{k: torch.as_tensor(v) for k, v in arrays.items()})

        # applied_transform / applied_scale round-trip (reference :320-346)
        applied_transform = None
        if "applied_transform" in meta:
            applied_transform = np.asarray(meta["applied_transform"], np.float32)
        elif (data_dir / "colmap/sparse/0").exists():
            applied_transform = np.asarray(
                [[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, -1, 0]], np.float32
            )
        if applied_transform is not None:
            dataparser_transform_matrix = (
                np.vstack([transform_matrix, [0, 0, 0, 1]])
                @ np.vstack([applied_transform, [0, 0, 0, 1]])
            )[:3]
        else:
            dataparser_transform_matrix = transform_matrix
        if "applied_scale" in meta:
            scale_factor *= float(meta["applied_scale"])

        metadata = {
            "depth_filenames": depth_filenames or None,
            "depth_unit_scale_factor": cfg.depth_unit_scale_factor,
        }
        for key in metadata_keys:
            vals = [frame[key] for frame in frames]
            metadata[key] = [vals[i] for i in indices]

        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=aabb,
            mask_filenames=mask_filenames or None,
            dataparser_transform=dataparser_transform_matrix.astype(np.float32),
            dataparser_scale=scale_factor,
            metadata=metadata,
        )


@dataclass
class ThermalNerfDataParserConfig(NerfstudioDataParserConfig):
    """The ThermalNerf dataset layout (images/ and images_thermal/)."""


class ThermalNerf(Nerfstudio):
    """Nerfstudio parser that requests per-frame `is_thermal` and redirects
    downscale folders per modality."""

    config: ThermalNerfDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", metadata_keys: Tuple[str, ...] = ()):
        return super()._generate_dataparser_outputs(
            split=split, metadata_keys=("is_thermal",) + tuple(metadata_keys)
        )

    def _get_fname(self, filepath: Path, data_dir: Path, downsample_folder_prefix="images_") -> Path:
        if downsample_folder_prefix == "images_":
            downsample_folder_prefix = f"{filepath.parent.name}_"
        return super()._get_fname(filepath, data_dir, downsample_folder_prefix=downsample_folder_prefix)
