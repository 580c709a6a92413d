"""Cameras and ray generation (counterpart of nerfstudio_thermal_tpu/cameras/cameras.py).

This slice carries the perspective camera with OpenCV radial + tangential
distortion. Conventions match the JAX package: image coords are (y, x)
pixel centres (+0.5); camera space is OpenGL (+x right, +y up, -z forward),
with the OpenCV -> OpenGL y flip after undistortion; pixel_area comes from
unit-offset ray differentials. The other camera types (fisheye,
equirectangular, stereo, VR180, orthophoto, fisheye624) raise
NotImplementedError until a later slice ports them.
"""

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional

import torch

from nerfstudio_thermal_torch.cameras import camera_utils
from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.utils import poses as pose_utils


class CameraType(Enum):
    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3
    OMNIDIRECTIONALSTEREO_L = 4
    OMNIDIRECTIONALSTEREO_R = 5
    VR180_L = 6
    VR180_R = 7
    ORTHOPHOTO = 8
    FISHEYE624 = 9


@dataclass
class Cameras:
    """Batched camera intrinsics/extrinsics, tensors of shape [N, ...]."""

    camera_to_worlds: torch.Tensor  # [N, 3, 4]
    fx: torch.Tensor  # [N]
    fy: torch.Tensor  # [N]
    cx: torch.Tensor  # [N]
    cy: torch.Tensor  # [N]
    width: torch.Tensor  # [N] int
    height: torch.Tensor  # [N] int
    distortion_params: Optional[torch.Tensor] = None  # [N, 6]
    camera_type: Optional[torch.Tensor] = None  # [N] int
    times: Optional[torch.Tensor] = None  # [N]
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)

    def __post_init__(self):
        if self.camera_type is not None and bool(
            (self.camera_type != CameraType.PERSPECTIVE.value).any()
        ):
            raise NotImplementedError(
                "only perspective cameras are ported; the other camera types "
                "come with a later slice of the port"
            )

    def __len__(self):
        return self.camera_to_worlds.shape[0]

    def to(self, device) -> "Cameras":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        moved["metadata"] = {k: v.to(device) for k, v in self.metadata.items()}
        return dataclasses.replace(self, **moved)

    def generate_rays(
        self,
        camera_indices: torch.Tensor,  # [...] int
        coords: torch.Tensor,  # [..., 2] (y, x) pixel-centre coords
        camera_opt_to_camera: Optional[torch.Tensor] = None,  # [..., 3, 4]
        disable_distortion: bool = False,
    ) -> RayBundle:
        """World-space rays for (camera, pixel) pairs."""
        idx = camera_indices.long()
        y = coords[..., 0]
        x = coords[..., 1]
        fx, fy = self.fx[idx], self.fy[idx]
        cx, cy = self.cx[idx], self.cy[idx]

        def make_coord(dx_pix, dy_pix):
            return torch.stack([(x - cx + dx_pix) / fx, (y - cy + dy_pix) / fy], dim=-1)

        # base coord and the two unit-offset coords for ray differentials
        coord_stack = torch.stack(
            [make_coord(0.0, 0.0), make_coord(1.0, 0.0), make_coord(0.0, 1.0)], dim=0
        )  # [3, ..., 2]
        if not disable_distortion and self.distortion_params is not None:
            dist = self.distortion_params[idx]
            coord_stack = camera_utils.radial_and_tangential_undistort(
                coord_stack, dist[None, ..., :6]
            )

        # OpenCV -> OpenGL y flip
        cxs = coord_stack[..., 0]
        cys = -coord_stack[..., 1]
        directions_stack = torch.stack([cxs, cys, -torch.ones_like(cxs)], dim=-1)

        c2w = self.camera_to_worlds[idx]
        if camera_opt_to_camera is not None:
            c2w = pose_utils.multiply(c2w, camera_opt_to_camera)
        rotation = c2w[..., :3, :3]
        directions_stack = torch.sum(directions_stack[..., None, :] * rotation[None], dim=-1)
        directions_stack, directions_norm = camera_utils.normalize_with_norm(
            directions_stack, -1
        )

        origins = c2w[..., :3, 3]
        directions = directions_stack[0]
        dx = torch.sqrt(torch.sum((directions - directions_stack[1]) ** 2, dim=-1))
        dy = torch.sqrt(torch.sum((directions - directions_stack[2]) ** 2, dim=-1))
        pixel_area = (dx * dy)[..., None]

        times = self.times[idx][..., None] if self.times is not None else None
        metadata = {k: v[idx] for k, v in self.metadata.items()}
        metadata["directions_norm"] = directions_norm[0].detach()
        return RayBundle(
            origins=origins,
            directions=directions,
            pixel_area=pixel_area,
            camera_indices=idx[..., None],
            times=times,
            metadata=metadata,
        )
