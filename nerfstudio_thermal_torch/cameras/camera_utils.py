"""Camera math helpers (counterpart of the ray-generation and pose parts
of nerfstudio_thermal_tpu/cameras/camera_utils.py): the OpenCV
undistortion and the fisheye624 unprojection for ray generation, and the
numpy pose orientation and centering the dataparsers call."""

from typing import Tuple

import numpy as np
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


def fisheye624_unproject(pix: torch.Tensor, camera_params: torch.Tensor, max_iters: int = 5) -> torch.Tensor:
    """Pixels to OpenGL camera-space directions (z = -1 plane) under the
    Fisheye624 model (radial k0..k5, tangential p0 p1, thin prism s0..s3).
    It has no analytic inverse: two Newton solves of `max_iters` fixed
    iterations, one inverting the tangential and thin-prism terms, one the
    radial polynomial for theta.

    pix [..., 2] (u, v); camera_params [..., 16] [fx fy cx cy k0..k5 p0 p1 s0..s3]."""
    eps = 1e-6
    ks = [camera_params[..., 4 + i] for i in range(6)]
    p0, p1 = camera_params[..., 10], camera_params[..., 11]
    s0, s1, s2, s3 = (camera_params[..., 12 + i] for i in range(4))
    uv_dist = (pix - camera_params[..., 2:4]) / camera_params[..., 0:2]

    def distort_est(xr, yr):
        xr_sq, yr_sq = xr * xr, yr * yr
        rd_sq = xr_sq + yr_sq
        rd_4 = rd_sq * rd_sq
        u = xr + (2.0 * xr_sq + rd_sq) * p0 + 2.0 * xr * yr * p1 + s0 * rd_sq + s1 * rd_4
        v = yr + (2.0 * yr_sq + rd_sq) * p1 + 2.0 * xr * yr * p0 + s2 * rd_sq + s3 * rd_4
        return u, v

    xr, yr = uv_dist[..., 0], uv_dist[..., 1]
    for _ in range(max_iters):
        u, v = distort_est(xr, yr)
        sq_norm = xr * xr + yr * yr
        t1 = 2.0 * (s0 + 2.0 * s1 * sq_norm)
        t2 = 2.0 * (s2 + 2.0 * s3 * sq_norm)
        a = 1.0 + 6.0 * xr * p0 + 2.0 * yr * p1 + xr * t1
        b = 2.0 * (xr * p1 + yr * p0) + yr * t1
        c = 2.0 * (xr * p1 + yr * p0) + xr * t2
        d = 1.0 + 6.0 * yr * p1 + 2.0 * xr * p0 + yr * t2
        det = a * d - b * c
        e, f = uv_dist[..., 0] - u, uv_dist[..., 1] - v
        xr, yr = xr + (d * e - b * f) / det, yr + (-c * e + a * f) / det

    xr_yr = torch.stack([xr, yr], dim=-1)
    xr_yr_norm = torch.linalg.norm(xr_yr, dim=-1)
    th = xr_yr_norm
    for _ in range(max_iters):
        th_radial = torch.ones_like(th)
        dthd_th = torch.ones_like(th)
        for k in range(6):
            th_radial = th_radial + ks[k] * th ** (2 + k * 2)
            dthd_th = dthd_th + (3.0 + 2.0 * k) * ks[k] * th ** (2 + k * 2)
        th_radial = th_radial * th
        step = (xr_yr_norm - th_radial) / dthd_th
        step = torch.where(torch.abs(dthd_th) > eps, step, torch.sign(step) * eps * 10.0)
        th = th + step

    close = (torch.abs(th) < eps) & (torch.abs(xr_yr_norm) < eps)
    scale = torch.where(close, torch.ones_like(th), torch.tan(th) / torch.clamp(xr_yr_norm, min=eps))[..., None]
    ray_dir = xr_yr * scale
    # OpenCV -> OpenGL: flip y and z
    return torch.stack([ray_dir[..., 0], -ray_dir[..., 1], -torch.ones_like(th)], dim=-1)


def normalize_with_norm(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize and also return the norm (keepdim)."""
    norm = torch.linalg.norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=1e-12), norm


# ---------------------------------------------------------------------------
# Host-side (numpy) pose utilities used by the dataparsers.
# ---------------------------------------------------------------------------


def focus_of_attention_np(poses: np.ndarray, initial_focus: np.ndarray) -> np.ndarray:
    """Least-squares focus point of the cameras that look at it."""
    active_directions = -poses[:, :3, 2:3]
    active_origins = poses[:, :3, 3:4]
    focus_pt = initial_focus
    active = (
        np.sum(active_directions.squeeze(-1) * (focus_pt - active_origins.squeeze(-1)), axis=-1) > 0
    )
    done = False
    while np.sum(active) > 1 and not done:
        active_o = active_origins[active]
        active_d = active_directions[active]
        m = np.eye(3) - active_d * np.transpose(active_d, (0, 2, 1))
        mt_m = np.transpose(m, (0, 2, 1)) @ m
        # pinv: parallel view directions make mt_m singular
        focus_pt = np.linalg.pinv(mt_m.mean(0)) @ (mt_m @ active_o).mean(0)[:, 0]
        new_active = (
            np.sum(active_directions.squeeze(-1) * (focus_pt - active_origins.squeeze(-1)), axis=-1) > 0
        )
        if np.array_equal(active, new_active):
            done = True
        active = new_active
    return focus_pt


def _rotation_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:
        eps = (np.random.default_rng(0).random(3) - 0.5) * 0.01
        return _rotation_matrix_np(a + eps, b)
    s = np.linalg.norm(v)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (s**2 + 1e-8))


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_method: str = "poses"
) -> Tuple[np.ndarray, np.ndarray]:
    """Orient and center camera poses. Methods: up / vertical (as up) /
    none; centers: poses / focus / none. poses [N, 4, 4] or [N, 3, 4];
    returns (oriented [N, 3, 4], applied transform [3, 4])."""
    if poses.shape[-2] == 3:
        bottom = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (poses.shape[0], 1, 1))
        poses = np.concatenate([poses, bottom], axis=-2)
    origins = poses[..., :3, 3]
    mean_origin = origins.mean(0)
    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention_np(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unknown center_method {center_method}")
    if method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        rotation = _rotation_matrix_np(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate([rotation, rotation @ -translation[..., None]], axis=-1)
    elif method == "none":
        transform = np.eye(4)[:3]
        transform[:3, 3] = -translation
    else:
        raise ValueError(f"unknown orient method {method}")
    oriented = np.einsum("ij,njk->nik", np.vstack([transform, [0, 0, 0, 1]]), poses)[:, :3]
    return oriented, transform


def get_distortion_params(
    k1: float = 0.0, k2: float = 0.0, k3: float = 0.0, k4: float = 0.0, p1: float = 0.0, p2: float = 0.0
) -> np.ndarray:
    """OpenCV distortion params in the [k1 k2 k3 k4 p1 p2] layout."""
    return np.array([k1, k2, k3, k4, p1, p2], dtype=np.float32)
