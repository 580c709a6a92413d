"""Instant-NGP format dataparser (counterpart of
nerfstudio_thermal_tpu/data/dataparsers/instant_ngp_dataparser.py): one
transforms.json (or an explicit .json path) with shared intrinsics, the
focal length from fl_x / x_fov / camera_angle_x (`get_focal_lengths`),
aabb_scale -> scene box, scene_scale on the camera origins, and the
fraction / filename / interval / all eval splits. Frames whose image is
missing are skipped; the image size comes from the first image's header
when the file gives none.
"""

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from nerfstudio_thermal_torch.cameras.cameras import CameraType
from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    make_cameras,
)
from nerfstudio_thermal_torch.data.utils.dataparsers_utils import (
    get_train_eval_split_all,
    get_train_eval_split_filename,
    get_train_eval_split_fraction,
    get_train_eval_split_interval,
)


@dataclass
class InstantNGPDataParserConfig(DataParserConfig):
    data: Path = Path("data/ours/posterv2")
    scene_scale: float = 0.3333
    eval_mode: str = "fraction"  # fraction | filename | interval | all
    train_split_fraction: float = 0.9
    eval_interval: int = 8


def get_focal_lengths(meta: dict) -> tuple:
    """(fl_x, fl_y) from the focal lengths or fields of view of a
    transforms.json; fl_y is fl_x unless a y field of view is given."""

    def fov_to_focal(rad, res):
        return 0.5 * res / np.tan(0.5 * rad)

    fl_x = fl_y = 0.0
    if "fl_x" in meta:
        fl_x = meta["fl_x"]
    elif "x_fov" in meta:
        fl_x = fov_to_focal(np.deg2rad(meta["x_fov"]), meta["w"])
    elif "camera_angle_x" in meta:
        fl_x = fov_to_focal(meta["camera_angle_x"], meta["w"])
    if "camera_angle_y" not in meta and "y_fov" not in meta:
        fl_y = fl_x
    else:
        if "fl_y" in meta:
            fl_y = meta["fl_y"]
        elif "y_fov" in meta:
            fl_y = fov_to_focal(np.deg2rad(meta["y_fov"]), meta["h"])
        elif "camera_angle_y" in meta:
            fl_y = fov_to_focal(meta["camera_angle_y"], meta["h"])
    if fl_x == 0 or fl_y == 0:
        raise AttributeError("Focal length cannot be calculated from transforms.json")
    return fl_x, fl_y


class InstantNGP(DataParser):
    config: InstantNGPDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        from nerfstudio_thermal_torch.data.datasets import image_size

        data = Path(self.config.data)
        if data.suffix == ".json":
            meta = json.loads(data.read_text())
            data_dir = data.parent
        else:
            meta = json.loads((data / "transforms.json").read_text())
            data_dir = data

        image_filenames, mask_filenames, poses = [], [], []
        for frame in meta["frames"]:
            fname = data_dir / Path(frame["file_path"])
            if not fname.exists():
                fname = data_dir / Path(frame["file_path"] + ".png")
            if not fname.exists():
                continue
            if "w" not in meta:
                w0, h0 = image_size(fname)
                meta["w"] = w0
                meta.setdefault("h", h0)
            image_filenames.append(fname)
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
            if "mask_path" in frame:
                mask_filenames.append(data_dir / Path(frame["mask_path"]))
        assert image_filenames, "no images found via transforms.json file_paths"
        poses = np.stack(poses)
        poses[:, :3, 3] *= self.config.scene_scale

        cfg = self.config
        if cfg.eval_mode == "fraction":
            i_train, i_eval = get_train_eval_split_fraction(image_filenames, cfg.train_split_fraction)
        elif cfg.eval_mode == "filename":
            i_train, i_eval = get_train_eval_split_filename(image_filenames)
        elif cfg.eval_mode == "interval":
            i_train, i_eval = get_train_eval_split_interval(image_filenames, cfg.eval_interval)
        elif cfg.eval_mode == "all":
            i_train, i_eval = get_train_eval_split_all(image_filenames)
        else:
            raise ValueError(f"unknown eval mode {cfg.eval_mode}")
        indices = i_train if split == "train" else i_eval

        image_filenames = [image_filenames[i] for i in indices]
        mask_filenames = [mask_filenames[i] for i in indices] if mask_filenames else None
        poses = poses[np.asarray(indices)]

        dist = np.array([meta.get(k, 0.0) for k in ("k1", "k2", "k3", "k4", "p1", "p2")], np.float32)
        aabb_scale = 0.5 * meta.get("aabb_scale", 1)
        fl_x, fl_y = get_focal_lengths(meta)
        w, h = int(meta["w"]), int(meta["h"])
        cam_type = CameraType.FISHEYE if meta.get("is_fisheye", False) else CameraType.PERSPECTIVE
        n = len(image_filenames)
        cameras = make_cameras(
            camera_to_worlds=poses[:, :3, :4].astype(np.float32),
            fx=np.full((n,), fl_x, np.float32),
            fy=np.full((n,), fl_y, np.float32),
            cx=np.full((n,), float(meta.get("cx", 0.5 * w)), np.float32),
            cy=np.full((n,), float(meta.get("cy", 0.5 * h)), np.float32),
            width=np.full((n,), w, np.int32),
            height=np.full((n,), h, np.int32),
            distortion_params=np.tile(dist, (n, 1)),
            camera_type=np.full((n,), cam_type.value, np.int32),
        )
        aabb = np.array([[-aabb_scale] * 3, [aabb_scale] * 3], np.float32)
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=aabb,
            mask_filenames=mask_filenames,
            dataparser_scale=self.config.scene_scale,
        )
