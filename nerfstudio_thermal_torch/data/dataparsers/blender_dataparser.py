"""Blender-synthetic (NeRF lego-style) dataparser (counterpart of
nerfstudio_thermal_tpu/data/dataparsers/blender_dataparser.py):
transforms_{train,val,test}.json with a global camera_angle_x, scene box
[-1.5, 1.5], scale `scale_factor` on the camera origins. The image size
comes from the first image's header.
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


@dataclass
class BlenderDataParserConfig(DataParserConfig):
    data: Path = Path("data/blender/lego")
    scale_factor: float = 1.0
    alpha_color: str = "white"


def split_meta(data: Path, split: str) -> dict:
    """transforms_{split}.json, transforms_test.json where the split has
    no file of its own."""
    split_name = {"train": "train", "val": "val", "test": "test"}.get(split, "val")
    meta_path = data / f"transforms_{split_name}.json"
    if not meta_path.exists():  # some sets only ship train + test
        meta_path = data / "transforms_test.json"
    return json.loads(meta_path.read_text())


def frame_filename(data: Path, frame: dict) -> Path:
    fname = data / Path(frame["file_path"].replace("./", "") + ".png")
    if not fname.exists():
        fname = data / Path(frame["file_path"].replace("./", ""))
    return fname


class Blender(DataParser):
    config: BlenderDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        from nerfstudio_thermal_torch.data.datasets import image_size

        data = Path(self.config.data)
        meta = split_meta(data, split)
        image_filenames = [frame_filename(data, frame) for frame in meta["frames"]]
        poses = np.stack([np.asarray(frame["transform_matrix"], np.float32) for frame in meta["frames"]])
        poses = poses[:, :3, :4] * 1.0
        poses[:, :3, 3] *= self.config.scale_factor

        w, h = image_size(image_filenames[0])
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        n = len(image_filenames)
        cameras = make_cameras(
            camera_to_worlds=poses.astype(np.float32),
            fx=np.full((n,), focal, np.float32),
            fy=np.full((n,), focal, np.float32),
            cx=np.full((n,), w / 2, np.float32),
            cy=np.full((n,), h / 2, np.float32),
            width=np.full((n,), w, np.int32),
            height=np.full((n,), h, np.int32),
            distortion_params=np.zeros((n, 6), np.float32),
            camera_type=np.full((n,), CameraType.PERSPECTIVE.value, np.int32),
        )
        aabb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=aabb,
            dataparser_scale=self.config.scale_factor,
        )
