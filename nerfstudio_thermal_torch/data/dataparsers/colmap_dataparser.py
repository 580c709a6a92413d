"""COLMAP dataparser (counterpart of
nerfstudio_thermal_tpu/data/dataparsers/colmap_dataparser.py): reads a
sparse reconstruction (cameras.bin, images.bin under
<data>/<colmap_path>) directly, converts COLMAP's camera and world axes to
nerfstudio's, then orients, centers and auto-scales the poses as the
nerfstudio parser does. Images (usually JPEG) are read from
<data>/<images_path>.
"""

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from nerfstudio_thermal_torch.cameras import camera_utils
from nerfstudio_thermal_torch.cameras.cameras import CameraType
from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    make_cameras,
)
from nerfstudio_thermal_torch.data.utils.colmap_parsing_utils import (
    parse_colmap_camera_params,
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
)
from nerfstudio_thermal_torch.data.utils.dataparsers_utils import get_train_eval_split_fraction


@dataclass
class ColmapDataParserConfig(DataParserConfig):
    data: Path = Path()
    colmap_path: Path = Path("colmap/sparse/0")
    images_path: Path = Path("images")
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    scene_scale: float = 1.0
    train_split_fraction: float = 0.9


def colmap_c2w(qvec, tvec) -> np.ndarray:
    """World-to-camera (COLMAP) -> camera-to-world [3, 4] in nerfstudio's
    camera axes (OpenGL) and world axes (y and z swapped, z flipped)."""
    w2c = np.concatenate([qvec2rotmat(qvec), np.asarray(tvec).reshape(3, 1)], 1)
    w2c = np.concatenate([w2c, np.array([[0, 0, 0, 1]])], 0)
    c2w = np.linalg.inv(w2c)
    c2w[0:3, 1:3] *= -1
    c2w = c2w[np.array([0, 2, 1, 3]), :]
    c2w[2, :] *= -1
    return c2w[:3]


class ColmapDataParser(DataParser):
    config: ColmapDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        cfg = self.config
        recon = Path(cfg.data) / cfg.colmap_path
        cameras_colmap = read_cameras_binary(recon / "cameras.bin")
        images = read_images_binary(recon / "images.bin")

        frames = [(im.name, colmap_c2w(im.qvec, im.tvec), im.camera_id)
                  for _, im in sorted(images.items(), key=lambda kv: kv[1].name)]
        image_filenames = [Path(cfg.data) / cfg.images_path / n for n, _, _ in frames]
        poses = np.stack([p for _, p, _ in frames]).astype(np.float32)

        i_train, i_eval = get_train_eval_split_fraction(image_filenames, cfg.train_split_fraction)
        indices = i_train if split == "train" else i_eval

        poses, transform = camera_utils.auto_orient_and_center_poses(
            poses, method=cfg.orientation_method, center_method=cfg.center_method
        )
        scale = 1.0
        if cfg.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3])))
        poses[:, :3, 3] *= scale

        fx, fy, cx, cy, ws, hs, dists, types = [], [], [], [], [], [], [], []
        for _, _, cam_id in frames:
            p = parse_colmap_camera_params(cameras_colmap[cam_id])
            fx.append(p["fl_x"])
            fy.append(p["fl_y"])
            cx.append(p["cx"])
            cy.append(p["cy"])
            ws.append(p["w"])
            hs.append(p["h"])
            dists.append(camera_utils.get_distortion_params(
                k1=p.get("k1", 0), k2=p.get("k2", 0), k3=p.get("k3", 0),
                k4=p.get("k4", 0), p1=p.get("p1", 0), p2=p.get("p2", 0),
            ))
            types.append(CameraType.FISHEYE.value if p.get("camera_model") == "OPENCV_FISHEYE"
                         else CameraType.PERSPECTIVE.value)

        sel = np.asarray(indices)
        cameras = make_cameras(
            camera_to_worlds=poses[sel].astype(np.float32),
            fx=np.asarray(fx, np.float32)[sel],
            fy=np.asarray(fy, np.float32)[sel],
            cx=np.asarray(cx, np.float32)[sel],
            cy=np.asarray(cy, np.float32)[sel],
            width=np.asarray(ws, np.int32)[sel],
            height=np.asarray(hs, np.int32)[sel],
            distortion_params=np.stack(dists).astype(np.float32)[sel],
            camera_type=np.asarray(types, np.int32)[sel],
        )
        aabb = cfg.scene_scale * np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in indices],
            cameras=cameras,
            scene_box=aabb,
            dataparser_transform=transform.astype(np.float32),
            dataparser_scale=scale,
        )
