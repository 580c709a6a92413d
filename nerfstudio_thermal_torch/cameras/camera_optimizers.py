"""Camera pose optimizers
(counterpart of nerfstudio_thermal_tpu/cameras/camera_optimizers.py).

Modes: off, SO3xR3, SE3, shared_SO3xR3; `penalty_scale < 0` turns an
optimizer off, and the regularizer uses its absolute value. The only
parameter is `pose_adjustment` ([num_cameras, 6], or [1, 6] when shared),
zero at init. Cameras listed as non-trainable get the identity correction,
so their rows receive zero gradients. `suffix` names the optimizer's
metrics and loss term.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.lie_groups import exp_map_SE3, exp_map_SO3xR3
from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.utils.math import safe_norm


@dataclass
class CameraOptimizerConfig:
    mode: str = "off"  # off | SO3xR3 | SE3 | shared_SO3xR3
    trans_l2_penalty: float = 1e-2
    rot_l2_penalty: float = 1e-3
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
        suffix: str = "",
        trans_l2_penalty: float = 1e-2,
        rot_l2_penalty: float = 1e-3,
        penalty_scale: float = 1.0,
    ) -> None:
        super().__init__()
        self.suffix = suffix
        self.trans_l2_penalty = trans_l2_penalty
        self.rot_l2_penalty = rot_l2_penalty
        self.penalty_scale = penalty_scale
        if mode not in ("off", "SO3xR3", "SE3", "shared_SO3xR3"):
            raise ValueError(f"unknown camera optimizer mode {mode}")
        self.mode = mode
        self.num_cameras = num_cameras
        self.non_trainable_camera_indices = tuple(non_trainable_camera_indices)
        if mode != "off":
            n = 1 if mode == "shared_SO3xR3" else num_cameras
            self.pose_adjustment = nn.Parameter(torch.zeros(n, 6))
        # built once, so applying the optimizer copies nothing to the device
        frozen = torch.zeros(num_cameras, dtype=torch.bool)
        frozen[list(self.non_trainable_camera_indices)] = True
        self.register_buffer("frozen", frozen, persistent=False)

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """[R] camera indices -> [R, 3, 4] correction matrices."""
        adj = self.pose_adjustment
        eye = torch.eye(4, dtype=adj.dtype, device=adj.device)[:3, :4]
        if self.mode == "shared_SO3xR3":
            return exp_map_SO3xR3(adj)[0].expand(*indices.shape, 3, 4)
        mats = exp_map_SO3xR3(adj) if self.mode == "SO3xR3" else exp_map_SE3(adj)
        if self.non_trainable_camera_indices:
            mats = torch.where(self.frozen[:, None, None], eye, mats)
        return mats[indices.long()]

    def apply_to_raybundle(self, bundle: RayBundle) -> RayBundle:
        """A new bundle with corrected origins and directions."""
        if self.mode == "off":
            return bundle
        corr = self(bundle.camera_indices[..., 0])
        origins = bundle.origins + corr[..., :3, 3]
        directions = torch.einsum("...ij,...j->...i", corr[..., :3, :3], bundle.directions)
        return bundle.replace(origins=origins, directions=directions)

    def regularization_loss(self) -> torch.Tensor:
        """L2 pose penalty; safe_norm keeps the gradient at the zero init
        finite (zero), as torch's norm subgradient does."""
        adj = self.pose_adjustment
        return (
            torch.mean(safe_norm(adj[:, :3])) * self.trans_l2_penalty
            + torch.mean(safe_norm(adj[:, 3:])) * self.rot_l2_penalty
        ) * self.penalty_scale

    def metrics(self) -> Dict[str, torch.Tensor]:
        adj = self.pose_adjustment.detach()
        return {
            f"camera_opt_translation{self.suffix}": torch.linalg.norm(adj[:, :3]),
            f"camera_opt_rotation{self.suffix}": torch.linalg.norm(adj[:, 3:]),
        }


def build_camera_optimizer(
    config: CameraOptimizerConfig,
    num_cameras: int,
    non_trainable_camera_indices: Tuple[int, ...] = (),
    suffix: str = "",
) -> CameraOptimizer:
    return CameraOptimizer(
        mode=config.resolved_mode(),
        num_cameras=num_cameras,
        non_trainable_camera_indices=tuple(non_trainable_camera_indices),
        suffix=suffix,
        trans_l2_penalty=config.trans_l2_penalty,
        rot_l2_penalty=config.rot_l2_penalty,
        penalty_scale=abs(config.penalty_scale),
    )
