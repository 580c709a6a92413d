"""Minimal dataparser (counterpart of
nerfstudio_thermal_tpu/data/dataparsers/minimal_dataparser.py): a
{split}.npz bundle with image_filenames, cameras_to_worlds [N, 3 or 4, 4]
and optional fx / fy / cx / cy / width / height / scene_box; eval splits
fall back to val.npz, then train.npz. Without width and height the size
comes from the first image's header.
"""

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
class MinimalDataParserConfig(DataParserConfig):
    data: Path = Path("data/minimal")


class MinimalDataParser(DataParser):
    config: MinimalDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        from nerfstudio_thermal_torch.data.datasets import image_size

        data = Path(self.config.data)
        filepath = data / f"{split}.npz"
        if not filepath.exists():
            for candidate in ("val.npz", "train.npz"):
                if (data / candidate).exists():
                    filepath = data / candidate
                    break
        d = np.load(filepath, allow_pickle=True)

        image_filenames = [data / f for f in d["image_filenames"].tolist()]
        poses = np.asarray(d["cameras_to_worlds"], np.float32)[:, :3, :4]
        n = len(image_filenames)

        def arr(key, default=None):
            if key in d:
                return np.broadcast_to(np.asarray(d[key], np.float32), (n,)).astype(np.float32).copy()
            return np.full((n,), default, np.float32)

        width = np.asarray(d["width"], np.int32) if "width" in d else None
        height = np.asarray(d["height"], np.int32) if "height" in d else None
        if width is None or height is None:
            w, h = image_size(image_filenames[0])
            width = np.full((n,), w, np.int32)
            height = np.full((n,), h, np.int32)
        else:
            width = np.broadcast_to(width, (n,)).astype(np.int32).copy()
            height = np.broadcast_to(height, (n,)).astype(np.int32).copy()

        cameras = make_cameras(
            camera_to_worlds=poses,
            fx=arr("fx", float(width[0])),
            fy=arr("fy", float(width[0])),
            cx=arr("cx", float(width[0]) / 2),
            cy=arr("cy", float(height[0]) / 2),
            width=width,
            height=height,
            distortion_params=np.zeros((n, 6), np.float32),
            camera_type=np.full((n,), CameraType.PERSPECTIVE.value, np.int32),
        )
        aabb = (np.asarray(d["scene_box"], np.float32) if "scene_box" in d
                else np.array([[-1, -1, -1], [1, 1, 1]], np.float32))
        return DataparserOutputs(image_filenames=image_filenames, cameras=cameras, scene_box=aabb)
