"""Lie-group exponential maps for pose optimization
(counterpart of nerfstudio_thermal_tpu/cameras/lie_groups.py).

Tangent vector = [translation (3), rotation (3)] -> [R | t] as [..., 3, 4].
"""

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrices."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def exp_map_SO3xR3(tangent_vector: torch.Tensor) -> torch.Tensor:
    """SO(3) x R^3: rotation by Rodrigues, translation verbatim."""
    log_rot = tangent_vector[..., 3:]
    nrms = torch.sum(log_rot * log_rot, dim=-1)
    rot_angles = torch.sqrt(torch.clamp(nrms, min=1e-4))
    inv = 1.0 / rot_angles
    fac1 = inv * torch.sin(rot_angles)
    fac2 = inv * inv * (1.0 - torch.cos(rot_angles))
    skews = _skew(log_rot)
    skews_sq = skews @ skews
    eye = torch.eye(3, dtype=tangent_vector.dtype, device=tangent_vector.device)
    rot = fac1[..., None, None] * skews + fac2[..., None, None] * skews_sq + eye
    return torch.cat([rot, tangent_vector[..., :3, None]], dim=-1)


def exp_map_SE3(tangent_vector: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3)."""
    lin = tangent_vector[..., :3]
    ang = tangent_vector[..., 3:]

    theta2 = torch.sum(ang * ang, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    near_zero = theta < 1e-2
    one = torch.ones_like(theta)
    theta_nz = torch.where(near_zero, one, theta)
    theta2_nz = torch.where(near_zero, one, theta2)
    theta3_nz = theta_nz * theta2_nz

    sine = torch.sin(theta)
    cosine = torch.where(near_zero, 8.0 / (4.0 + theta2) - 1.0, torch.cos(theta))
    sine_by_theta = torch.where(near_zero, 0.5 * cosine + 0.5, sine / theta_nz)
    one_minus_cos_by_t2 = torch.where(
        near_zero, 0.5 * sine_by_theta, (1.0 - cosine) / theta2_nz
    )

    outer = ang[..., :, None] * ang[..., None, :]
    skews = _skew(ang)
    eye = torch.eye(3, dtype=tangent_vector.dtype, device=tangent_vector.device)
    rot = (
        one_minus_cos_by_t2[..., None, None] * outer
        + cosine[..., None, None] * eye
        + sine_by_theta[..., None, None] * skews
    )

    sbt_t = torch.where(near_zero, 1.0 - theta2 / 6.0, sine_by_theta)
    omc_t = torch.where(near_zero, 0.5 - theta2 / 24.0, one_minus_cos_by_t2)
    tms_t = torch.where(
        near_zero, 1.0 / 6.0 - theta2 / 120.0, (theta - sine) / theta3_nz
    )

    cross = torch.linalg.cross(ang, lin, dim=-1)
    ang_dot_lin = torch.sum(ang * lin, dim=-1, keepdim=True)
    trans = (
        sbt_t[..., None] * lin
        + omc_t[..., None] * cross
        + tms_t[..., None] * ang * ang_dot_lin
    )
    return torch.cat([rot, trans[..., :, None]], dim=-1)
