"""SDFStudio-format dataparser (counterpart of
nerfstudio_thermal_tpu/data/dataparsers/sdfstudio_dataparser.py):
meta_data.json with per-frame `intrinsics` / `camtoworld`, the OpenCV ->
nerfstudio axis flip, optional up-orientation, the scene box from the
file's `scene_box.aabb`, and the monocular depth / normal priors and
foreground masks surfaced through the metadata (read by the dataset's
get_depth / get_normal).
"""

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from nerfstudio_thermal_torch.cameras.camera_utils import auto_orient_and_center_poses
from nerfstudio_thermal_torch.cameras.cameras import CameraType
from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    make_cameras,
)


@dataclass
class SDFStudioDataParserConfig(DataParserConfig):
    data: Path = Path("data/DTU/scan65")
    include_mono_prior: bool = False
    depth_unit_scale_factor: float = 1e-3
    include_foreground_mask: bool = False
    downscale_factor: int = 1
    scene_scale: float = 2.0
    skip_every_for_val_split: int = 1
    auto_orient: bool = True


class SDFStudio(DataParser):
    config: SDFStudioDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        import json

        data = Path(self.config.data)
        meta = json.loads((data / "meta_data.json").read_text())

        indices = list(range(len(meta["frames"])))
        if split != "train" and self.config.skip_every_for_val_split > 1:
            indices = indices[:: self.config.skip_every_for_val_split]
        index_set = set(indices)

        image_filenames, depth_filenames, normal_filenames, mask_filenames = [], [], [], []
        fx, fy, cx, cy, c2ws = [], [], [], [], []
        for i, frame in enumerate(meta["frames"]):
            if i not in index_set:
                continue
            image_filenames.append(data / frame["rgb_path"])
            if frame.get("mono_depth_path") and frame.get("mono_normal_path"):
                depth_filenames.append(data / frame["mono_depth_path"])
                normal_filenames.append(data / frame["mono_normal_path"])
            if frame.get("foreground_mask"):
                mask_filenames.append(data / frame["foreground_mask"])
            K = np.asarray(frame["intrinsics"], np.float32)
            fx.append(K[0, 0])
            fy.append(K[1, 1])
            cx.append(K[0, 2])
            cy.append(K[1, 2])
            c2ws.append(np.asarray(frame["camtoworld"], np.float32))

        c2ws = np.stack(c2ws)
        c2ws[:, 0:3, 1:3] *= -1  # OpenCV -> nerfstudio camera axes

        transform = np.eye(4, dtype=np.float32)[:3]
        if self.config.auto_orient:
            c2ws, transform = auto_orient_and_center_poses(c2ws[:, :3, :4], method="up", center_method="none")
        else:
            c2ws = c2ws[:, :3, :4]

        aabb = np.asarray(meta["scene_box"]["aabb"], np.float32)
        h, w = int(meta["height"]), int(meta["width"])
        n = len(image_filenames)
        cameras = make_cameras(
            camera_to_worlds=c2ws.astype(np.float32),
            fx=np.asarray(fx, np.float32),
            fy=np.asarray(fy, np.float32),
            cx=np.asarray(cx, np.float32),
            cy=np.asarray(cy, np.float32),
            width=np.full((n,), w, np.int32),
            height=np.full((n,), h, np.int32),
            distortion_params=np.zeros((n, 6), np.float32),
            camera_type=np.full((n,), CameraType.PERSPECTIVE.value, np.int32),
        )
        if self.config.include_mono_prior:
            assert meta.get("has_mono_prior"), f"no mono prior in {data}"
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_box=aabb,
            mask_filenames=mask_filenames or None,
            dataparser_transform=np.asarray(transform, np.float32),
            metadata={
                "depth_filenames": depth_filenames or None,
                "normal_filenames": normal_filenames or None,
                "include_mono_prior": self.config.include_mono_prior,
                "depth_unit_scale_factor": self.config.depth_unit_scale_factor,
            },
        )
