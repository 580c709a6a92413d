"""Pose (3x4 [R|t]) utilities (counterpart of nerfstudio_thermal_tpu/utils/poses.py)."""

import torch


def to4x4(pose: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] with bottom row (0, 0, 0, 1)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype, device=pose.device)
    bottom = bottom.expand(*pose.shape[:-2], 1, 4)
    return torch.cat([pose, bottom], dim=-2)


def multiply(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """Compose two [..., 3, 4] poses: pose_a @ pose_b as 3x4."""
    return (to4x4(pose_a) @ to4x4(pose_b))[..., :3, :4]
