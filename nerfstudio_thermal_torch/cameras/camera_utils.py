"""Camera math helpers (counterpart of the ray-generation part of
nerfstudio_thermal_tpu/cameras/camera_utils.py)."""

from typing import Tuple

import torch


def _residual_and_jacobian(x, y, xd, yd, distortion_params):
    """OpenCV radial (k1..k4) + tangential (p1, p2) model residuals."""
    k1 = distortion_params[..., 0]
    k2 = distortion_params[..., 1]
    k3 = distortion_params[..., 2]
    k4 = distortion_params[..., 3]
    p1 = distortion_params[..., 4]
    p2 = distortion_params[..., 5]

    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))

    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd

    d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r

    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(
    coords: torch.Tensor,
    distortion_params: torch.Tensor,
    eps: float = 1e-3,
    max_iterations: int = 10,
) -> torch.Tensor:
    """Invert the OpenCV distortion model by a fixed count of Newton steps.
    coords [..., 2]."""
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _residual_and_jacobian(
            x, y, xd, yd, distortion_params
        )
        denom = fy_x * fx_y - fx_x * fy_y
        x_num = fx * fy_y - fy * fx_y
        y_num = fy * fx_x - fx * fy_x
        ok = torch.abs(denom) > eps
        zero = torch.zeros_like(denom)
        x = x + torch.where(ok, x_num / denom, zero)
        y = y + torch.where(ok, y_num / denom, zero)
    return torch.stack([x, y], dim=-1)


def normalize_with_norm(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize and also return the norm (keepdim)."""
    norm = torch.linalg.norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=1e-12), norm
