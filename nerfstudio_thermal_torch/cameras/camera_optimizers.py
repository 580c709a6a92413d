"""Camera pose optimizers, applied at eval
(counterpart of nerfstudio_thermal_tpu/cameras/camera_optimizers.py).

Modes: off, SO3xR3, SE3, shared_SO3xR3; `penalty_scale < 0` turns an
optimizer off. The only parameter is `pose_adjustment` ([num_cameras, 6],
or [1, 6] when shared), zero at init. Cameras listed as non-trainable get
the identity correction. The pose regularizers and metrics arrive with the
training slice.
"""

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.lie_groups import exp_map_SE3, exp_map_SO3xR3
from nerfstudio_thermal_torch.cameras.rays import RayBundle


@dataclass
class CameraOptimizerConfig:
    mode: str = "off"  # off | SO3xR3 | SE3 | shared_SO3xR3
    penalty_scale: float = 1.0
    """Multiplier on the pose regularizer. -1 turns the optimizer off."""

    def resolved_mode(self) -> str:
        return "off" if self.penalty_scale < 0 else self.mode


class CameraOptimizer(nn.Module):
    """Learnable pose deltas applied to ray bundles."""

    def __init__(
        self,
        mode: str,
        num_cameras: int,
        non_trainable_camera_indices: Tuple[int, ...] = (),
    ) -> None:
        super().__init__()
        if mode not in ("off", "SO3xR3", "SE3", "shared_SO3xR3"):
            raise ValueError(f"unknown camera optimizer mode {mode}")
        self.mode = mode
        self.num_cameras = num_cameras
        self.non_trainable_camera_indices = tuple(non_trainable_camera_indices)
        if mode != "off":
            n = 1 if mode == "shared_SO3xR3" else num_cameras
            self.pose_adjustment = nn.Parameter(torch.zeros(n, 6))

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """[R] camera indices -> [R, 3, 4] correction matrices."""
        adj = self.pose_adjustment
        eye = torch.eye(4, dtype=adj.dtype, device=adj.device)[:3, :4]
        if self.mode == "shared_SO3xR3":
            return exp_map_SO3xR3(adj)[0].expand(*indices.shape, 3, 4)
        mats = exp_map_SO3xR3(adj) if self.mode == "SO3xR3" else exp_map_SE3(adj)
        if self.non_trainable_camera_indices:
            frozen = torch.zeros(self.num_cameras, dtype=torch.bool, device=adj.device)
            frozen[list(self.non_trainable_camera_indices)] = True
            mats = torch.where(frozen[:, None, None], eye, mats)
        return mats[indices.long()]

    def apply_to_raybundle(self, bundle: RayBundle) -> RayBundle:
        """A new bundle with corrected origins and directions."""
        if self.mode == "off":
            return bundle
        corr = self(bundle.camera_indices[..., 0])
        origins = bundle.origins + corr[..., :3, 3]
        directions = torch.einsum("...ij,...j->...i", corr[..., :3, :3], bundle.directions)
        return bundle.replace(origins=origins, directions=directions)


def build_camera_optimizer(
    config: CameraOptimizerConfig,
    num_cameras: int,
    non_trainable_camera_indices: Tuple[int, ...] = (),
) -> CameraOptimizer:
    return CameraOptimizer(
        mode=config.resolved_mode(),
        num_cameras=num_cameras,
        non_trainable_camera_indices=tuple(non_trainable_camera_indices),
    )
