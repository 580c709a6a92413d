"""Cameras and ray generation (counterpart of nerfstudio_thermal_tpu/cameras/cameras.py).

Every camera type of the JAX package: perspective, fisheye (equidistant),
equirectangular, the two omnidirectional-stereo eyes, the two VR180 eyes,
orthophoto and fisheye624. Conventions match the JAX package: image
coords are (y, x) pixel centres (+0.5); camera space is OpenGL (+x right,
+y up, -z forward), with the OpenCV -> OpenGL y flip after undistortion
and before the direction math; pixel_area comes from unit-offset ray
differentials. A batch may mix camera types: each ray takes its type's
directions and origins through `torch.where`, as the JAX package selects
with `jnp.where`. A type's branch is computed only when a camera of the
batch's `Cameras` has that type (`present_types`, read once when the
Cameras is built), so a perspective-only batch runs the perspective math
alone.
"""

import dataclasses
import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, FrozenSet, Optional

import torch

from nerfstudio_thermal_torch.cameras import camera_utils
from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.utils import poses as pose_utils

VR_IPD = 0.064  # metres between the eyes of the stereo camera types


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


_ODS = (CameraType.OMNIDIRECTIONALSTEREO_L.value, CameraType.OMNIDIRECTIONALSTEREO_R.value)
_VR180 = (CameraType.VR180_L.value, CameraType.VR180_R.value)
_RIGHT_EYE = (CameraType.OMNIDIRECTIONALSTEREO_R.value, CameraType.VR180_R.value)


def _is(cam_type: torch.Tensor, values) -> torch.Tensor:
    out = torch.zeros_like(cam_type, dtype=torch.bool)
    for v in values:
        out = out | (cam_type == v)
    return out


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
    distortion_params: Optional[torch.Tensor] = None  # [N, 6], or [N, 12+] for fisheye624
    camera_type: Optional[torch.Tensor] = None  # [N] int
    times: Optional[torch.Tensor] = None  # [N]
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)
    present_types: FrozenSet[int] = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.camera_type is None:
            self.present_types = frozenset({CameraType.PERSPECTIVE.value})
        else:
            self.present_types = frozenset(int(v) for v in torch.unique(self.camera_type.cpu()).tolist())

    def __len__(self):
        return self.camera_to_worlds.shape[0]

    @property
    def image_height(self) -> torch.Tensor:
        return self.height

    @property
    def image_width(self) -> torch.Tensor:
        return self.width

    def to(self, device) -> "Cameras":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if f.init and isinstance(getattr(self, f.name), torch.Tensor)
        }
        moved["metadata"] = {k: v.to(device) for k, v in self.metadata.items()}
        return dataclasses.replace(self, **moved)

    def rescale_output_resolution(self, scaling_factor: float) -> "Cameras":
        """Intrinsics and image size scaled by `scaling_factor` (sizes
        truncated to int, as the JAX package does)."""
        return dataclasses.replace(
            self,
            fx=self.fx * scaling_factor,
            fy=self.fy * scaling_factor,
            cx=self.cx * scaling_factor,
            cy=self.cy * scaling_factor,
            width=(self.width.float() * scaling_factor).to(self.width.dtype),
            height=(self.height.float() * scaling_factor).to(self.height.dtype),
        )

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
        present = self.present_types
        has = lambda *values: any(v in present for v in values)  # noqa: E731
        if self.camera_type is None:
            cam_type = torch.full_like(idx, CameraType.PERSPECTIVE.value)
        else:
            cam_type = self.camera_type[idx]

        def make_coord(dx_pix, dy_pix):
            return torch.stack([(x - cx + dx_pix) / fx, (y - cy + dy_pix) / fy], dim=-1)

        # base coord and the two unit-offset coords for ray differentials
        coord_stack = torch.stack(
            [make_coord(0.0, 0.0), make_coord(1.0, 0.0), make_coord(0.0, 1.0)], dim=0
        )  # [3, ..., 2]
        dist = self.distortion_params[idx] if self.distortion_params is not None else None
        if not disable_distortion and dist is not None:
            undistorted = camera_utils.radial_and_tangential_undistort(coord_stack, dist[None, ..., :6])
            # equirectangular never undistorts; fisheye624 unprojects raw
            # pixels with its own model below
            keep = _is(cam_type, (CameraType.EQUIRECTANGULAR.value, CameraType.FISHEYE624.value))
            coord_stack = torch.where(keep[None, ..., None], coord_stack, undistorted)

        # OpenCV -> OpenGL y flip, before the direction math
        coord_stack = coord_stack * torch.tensor([1.0, -1.0], dtype=coord_stack.dtype, device=coord_stack.device)
        cxs = coord_stack[..., 0]
        cys = coord_stack[..., 1]
        ct = cam_type[None, ..., None]

        directions_stack = torch.stack([cxs, cys, -torch.ones_like(cxs)], dim=-1)  # perspective
        if has(CameraType.FISHEYE.value):
            theta = torch.clamp(torch.sqrt(cxs**2 + cys**2), 1e-9, math.pi)
            sin_over_theta = torch.sin(theta) / theta
            fish = torch.stack([cxs * sin_over_theta, cys * sin_over_theta, -torch.cos(theta)], dim=-1)
            directions_stack = torch.where(ct == CameraType.FISHEYE.value, fish, directions_stack)
        # equirectangular and the stereo eyes: phi from the flipped y
        ephi = math.pi * (0.5 - cys)
        if has(CameraType.EQUIRECTANGULAR.value, *_ODS):
            etheta = -math.pi * cxs
            equi = torch.stack(
                [-torch.sin(etheta) * torch.sin(ephi), torch.cos(ephi), -torch.cos(etheta) * torch.sin(ephi)], dim=-1
            )
            is_equi = _is(ct, (CameraType.EQUIRECTANGULAR.value, *_ODS))
            directions_stack = torch.where(is_equi, equi, directions_stack)
        if has(*_VR180):
            # equirectangular with the azimuth halved to +-90 degrees
            vtheta = -math.pi * cxs / 2.0
            vr180 = torch.stack(
                [-torch.sin(vtheta) * torch.sin(ephi), torch.cos(ephi), -torch.cos(vtheta) * torch.sin(ephi)], dim=-1
            )
            directions_stack = torch.where(_is(ct, _VR180), vr180, directions_stack)
        if has(CameraType.ORTHOPHOTO.value):
            ortho = torch.tensor([0.0, 0.0, -1.0], dtype=cxs.dtype, device=cxs.device).expand_as(directions_stack)
            directions_stack = torch.where(ct == CameraType.ORTHOPHOTO.value, ortho, directions_stack)
        if dist is not None and dist.shape[-1] >= 12 and has(CameraType.FISHEYE624.value):
            pix_stack = torch.stack(
                [torch.stack([x, y], -1), torch.stack([x + 1.0, y], -1), torch.stack([x, y + 1.0], -1)], dim=0
            )
            camera_params = torch.cat([fx[..., None], fy[..., None], cx[..., None], cy[..., None], dist[..., :12]], -1)
            f624 = camera_utils.fisheye624_unproject(pix_stack, camera_params[None])
            directions_stack = torch.where(ct == CameraType.FISHEYE624.value, f624, directions_stack)

        c2w = self.camera_to_worlds[idx]
        if camera_opt_to_camera is not None:
            c2w = pose_utils.multiply(c2w, camera_opt_to_camera)
        rotation = c2w[..., :3, :3]
        directions_stack = torch.sum(directions_stack[..., None, :] * rotation[None], dim=-1)
        directions_stack, directions_norm = camera_utils.normalize_with_norm(directions_stack, -1)

        origins = c2w[..., :3, 3]
        if has(CameraType.ORTHOPHOTO.value):
            # origins move on the image plane (y back to the OpenCV sense)
            grid = torch.stack([coord_stack[0, ..., 0], -coord_stack[0, ..., 1], torch.zeros_like(cx)], dim=-1)
            ortho_origins = origins + torch.einsum("...ij,...j->...i", rotation, grid)
            origins = torch.where((cam_type == CameraType.ORTHOPHOTO.value)[..., None], ortho_origins, origins)
        if has(*_ODS, *_VR180):
            # ODS rays start on a horizontal circle of radius IPD / 2 (phase
            # from the pixel's azimuth), VR180 rays at a fixed eye offset
            eye_sign = torch.where(_is(cam_type, _RIGHT_EYE), 1.0, -1.0)[..., None]
            ods_theta = -math.pi * (x - cx) / fx
            ods_offset = eye_sign * (VR_IPD / 2.0) * torch.stack(
                [torch.cos(ods_theta), torch.zeros_like(ods_theta), -torch.sin(ods_theta)], dim=-1
            )
            unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=origins.dtype, device=origins.device)
            vr180_offset = eye_sign * (VR_IPD / 2.0) * unit_x
            stereo_offset = torch.where(
                _is(cam_type, _ODS)[..., None], ods_offset,
                torch.where(_is(cam_type, _VR180)[..., None], vr180_offset, torch.zeros_like(ods_offset)),
            )
            origins = origins + torch.einsum("...ij,...j->...i", rotation, stereo_offset)

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
