"""Camera trajectories for rendering (counterpart of
nerfstudio_thermal_tpu/cameras/camera_paths.py, a copy of its host numpy:
quaternion slerp and squad, Kochanek-Bartels tangents, the spline path,
the interpolated path between cameras and the spiral path).

The paths are computed in numpy on the host and returned as the port's
`Cameras` of CPU tensors; `render_camera_device` moves them to the model's
device.
"""

from typing import Optional

import numpy as np
import torch

from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _cameras(**arrays) -> Cameras:
    return Cameras(**{k: torch.as_tensor(v) for k, v in arrays.items()})


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    dot = float(np.dot(q0, q1))
    if dot < 0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta0 = np.arccos(np.clip(dot, -1, 1))
    theta = theta0 * t
    s0 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta0)
    s1 = np.sin(theta) / np.sin(theta0)
    return s0 * q0 + s1 * q1


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    if w < 1e-8:
        # fallback for 180-degree rotations
        i = int(np.argmax(np.diag(r)))
        q = np.zeros(4)
        q[1 + i] = 1.0
        return q
    x = (r[2, 1] - r[1, 2]) / (4 * w)
    y = (r[0, 2] - r[2, 0]) / (4 * w)
    z = (r[1, 0] - r[0, 1]) / (4 * w)
    return np.array([w, x, y, z])


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _quat_log(q: np.ndarray) -> np.ndarray:
    """Log map of a unit quaternion -> pure-imaginary vector [3]."""
    q = q / np.linalg.norm(q)
    v = q[1:]
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.zeros(3)
    return v / n * np.arccos(np.clip(q[0], -1.0, 1.0))


def _quat_exp(v: np.ndarray) -> np.ndarray:
    """Exp map of a pure-imaginary vector [3] -> unit quaternion."""
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    return np.concatenate([[np.cos(n)], v / n * np.sin(n)])


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w0, x0, y0, z0 = a
    w1, x1, y1, z1 = b
    return np.array(
        [
            w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
            w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
            w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
            w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
        ]
    )


def _quat_conj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _squad_controls(qs: np.ndarray, loop: bool = False) -> np.ndarray:
    """Inner quadrangle points for C1 spherical spline interpolation
    (Shoemake squad): a_i = q_i * exp(-(log(q_i^-1 q_{i+1}) +
    log(q_i^-1 q_{i-1})) / 4). With loop=True neighbors wrap so the seam
    keyframes get two-sided tangents. Neighbors are hemisphere-aligned to
    q_i before the log (q and -q are the same rotation): consecutive
    keyframes are pre-aligned by the caller, but the wrap pair is not."""
    n = len(qs)
    ctrl = np.zeros_like(qs)
    for i in range(n):
        qm = qs[(i - 1) % n] if loop else qs[max(i - 1, 0)]
        qp = qs[(i + 1) % n] if loop else qs[min(i + 1, n - 1)]
        if np.dot(qs[i], qm) < 0:
            qm = -qm
        if np.dot(qs[i], qp) < 0:
            qp = -qp
        inv = _quat_conj(qs[i])
        arg = -(_quat_log(_quat_mul(inv, qp)) + _quat_log(_quat_mul(inv, qm))) / 4.0
        ctrl[i] = _quat_mul(qs[i], _quat_exp(arg))
    return ctrl


def _squad(q0, a0, a1, q1, t: float) -> np.ndarray:
    """squad(q0,a0,a1,q1; t) = slerp(slerp(q0,q1,t), slerp(a0,a1,t), 2t(1-t))."""
    return _slerp(_slerp(q0, q1, t), _slerp(a0, a1, t), 2 * t * (1 - t))


def _kb_tangents(values: np.ndarray, tension: float, loop: bool) -> np.ndarray:
    """Kochanek-Bartels tangents with continuity=bias=0:
    m_i = (1 - tension)/2 * (v_{i+1} - v_{i-1}). Endpoints clamp (non-loop)
    or wrap (loop). values: [K, ...]."""
    prev = np.roll(values, 1, axis=0)
    nxt = np.roll(values, -1, axis=0)
    if not loop:
        prev = np.concatenate([values[:1], values[:-1]], axis=0)
        nxt = np.concatenate([values[1:], values[-1:]], axis=0)
    return (1.0 - tension) / 2.0 * (nxt - prev)


def _hermite(p0, p1, m0, m1, t: float):
    t2, t3 = t * t, t * t * t
    return (
        (2 * t3 - 3 * t2 + 1) * p0
        + (t3 - 2 * t2 + t) * m0
        + (-2 * t3 + 3 * t2) * p1
        + (t3 - t2) * m1
    )


def interpolate_camera_path_spline(
    poses,
    fovs=None,
    durations=None,
    fps: float = 24.0,
    seconds: Optional[float] = None,
    loop: bool = False,
    tension: float = 0.0,
):
    """Spline camera-path interpolation as the render panel does it:
    Kochanek-Bartels splines over positions and fov, a spherical spline
    over orientations, per-keyframe transition durations mapped
    monotonically with PCHIP, optional loop.

    poses: [K] list/array of [3,4] c2w keyframes.
    fovs: [K] per-keyframe fov in degrees (lerped by the same spline), or None.
    durations: [K-1] (or [K] when loop) seconds per transition; uniform from
        `seconds` when None.
    Returns (poses [T,3,4] float32, fovs [T] float32) with T = round(fps *
    total_duration).
    """
    poses = np.asarray(poses, np.float32).reshape(-1, 3, 4)
    k = len(poses)
    if fovs is None:
        fovs = np.full((k,), 60.0, np.float32)
    fovs = np.asarray(fovs, np.float32)
    nseg = k if loop else k - 1
    if durations is None:
        total = float(seconds) if seconds else max(nseg, 1) * 2.0
        durations = np.full((max(nseg, 1),), total / max(nseg, 1), np.float32)
    durations = np.clip(np.asarray(durations, np.float32), 1e-3, None)
    if k == 1:
        t_total = float(durations.sum())
        n = max(int(round(fps * t_total)), 1)
        return np.repeat(poses, n, 0), np.repeat(fovs, n)

    # monotone time -> spline-parameter mapping: PCHIP keeps the
    # constant-speed-per-segment timing smooth
    from scipy.interpolate import PchipInterpolator

    cum = np.concatenate([[0.0], np.cumsum(durations[:nseg])])
    t_total = float(cum[-1])
    idx = np.arange(nseg + 1, dtype=np.float64)
    if loop:
        # pad so the wrap transition is smooth at both ends
        interp = PchipInterpolator(
            np.concatenate([[-durations[-1]], cum, [t_total + durations[0]]]),
            np.concatenate([[-1.0], idx, [nseg + 1.0]]),
        )
    else:
        interp = PchipInterpolator(cum, idx)

    positions = poses[:, :, 3]
    pos_m = _kb_tangents(positions, tension, loop)
    fov_m = _kb_tangents(fovs, tension, loop)
    qs = np.stack([_rot_to_quat(p[:3, :3]) for p in poses])
    for i in range(1, k):  # hemisphere-align for stable splines
        if np.dot(qs[i - 1], qs[i]) < 0:
            qs[i] = -qs[i]
    ctrl = _squad_controls(qs, loop=loop)

    n = max(int(round(fps * t_total)), 1)
    out_poses = np.zeros((n, 3, 4), np.float32)
    out_fovs = np.zeros((n,), np.float32)
    for j in range(n):
        u = float(np.clip(interp(j / fps), 0.0, nseg - 1e-6))
        i = int(u)
        t = u - i
        i1 = (i + 1) % k
        pos = _hermite(positions[i], positions[i1], pos_m[i], pos_m[i1], t)
        fov = _hermite(fovs[i], fovs[i1], fov_m[i], fov_m[i1], t)
        q = _squad(qs[i], ctrl[i], ctrl[i1], qs[i1], t)
        out_poses[j, :3, :3] = _quat_to_rot(q)
        out_poses[j, :3, 3] = pos
        out_fovs[j] = fov
    return out_poses, out_fovs


def get_interpolated_camera_path(
    cameras: Cameras, steps: int, order_poses: bool = False,
    indices: Optional[np.ndarray] = None,
) -> Cameras:
    """Interpolate between the given cameras (positions lerp, rotations
    slerp, intrinsics lerp), `steps` frames in all, split evenly over the
    segments; `indices` picks the cameras to pass through (ns-render's
    --rgb-poses-only)."""
    c2w = _np(cameras.camera_to_worlds)
    fx = _np(cameras.fx)
    fy = _np(cameras.fy)
    cx = _np(cameras.cx)
    cy = _np(cameras.cy)
    w = _np(cameras.width)
    h = _np(cameras.height)
    if indices is not None:
        c2w, fx, fy, cx, cy, w, h = (
            a[indices] for a in (c2w, fx, fy, cx, cy, w, h)
        )
    n = c2w.shape[0]
    if n < 2:
        reps = max(steps, 1)
        return _cameras(
            camera_to_worlds=np.repeat(c2w, reps, 0),
            fx=np.repeat(fx, reps), fy=np.repeat(fy, reps),
            cx=np.repeat(cx, reps), cy=np.repeat(cy, reps),
            width=np.repeat(w, reps), height=np.repeat(h, reps),
            camera_type=np.full((reps,), CameraType.PERSPECTIVE.value, np.int32),
        )
    per_seg = max(steps // (n - 1), 1)
    out_c2w, out_fx, out_fy, out_cx, out_cy = [], [], [], [], []
    for i in range(n - 1):
        q0 = _rot_to_quat(c2w[i, :3, :3])
        q1 = _rot_to_quat(c2w[i + 1, :3, :3])
        for s in range(per_seg):
            t = s / per_seg
            rot = _quat_to_rot(_slerp(q0, q1, t))
            trans = (1 - t) * c2w[i, :3, 3] + t * c2w[i + 1, :3, 3]
            pose = np.concatenate([rot, trans[:, None]], axis=-1)
            out_c2w.append(pose)
            out_fx.append((1 - t) * fx[i] + t * fx[i + 1])
            out_fy.append((1 - t) * fy[i] + t * fy[i + 1])
            out_cx.append((1 - t) * cx[i] + t * cx[i + 1])
            out_cy.append((1 - t) * cy[i] + t * cy[i + 1])
    k = len(out_c2w)
    return _cameras(
        camera_to_worlds=np.stack(out_c2w).astype(np.float32),
        fx=np.asarray(out_fx, np.float32),
        fy=np.asarray(out_fy, np.float32),
        cx=np.asarray(out_cx, np.float32),
        cy=np.asarray(out_cy, np.float32),
        width=np.full((k,), int(w[0]), np.int32),
        height=np.full((k,), int(h[0]), np.int32),
        camera_type=np.full((k,), CameraType.PERSPECTIVE.value, np.int32),
    )


def get_spiral_path(
    camera_c2w: np.ndarray, fx: float, fy: float, cx: float, cy: float,
    width: int, height: int, steps: int = 30, radius: float = 0.1,
    rots: int = 2, zrate: float = 0.5,
) -> Cameras:
    """`steps` cameras on a spiral around a central camera, each looking at
    a point in front of it."""
    up = camera_c2w[:3, 1]
    focal = min(fx, fy)
    target = camera_c2w[:3, 3] - camera_c2w[:3, 2] * focal * 0.01

    poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, steps + 1)[:-1]:
        center = (
            camera_c2w[:3, 3]
            + radius * (np.cos(theta) * camera_c2w[:3, 0] + np.sin(theta) * camera_c2w[:3, 1])
            - radius * np.sin(theta * zrate) * camera_c2w[:3, 2]
        )
        forward = target - center
        forward = forward / np.linalg.norm(forward)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, forward)
        pose = np.stack([right, true_up, -forward, center], axis=-1)
        poses.append(pose)
    k = len(poses)
    return _cameras(
        camera_to_worlds=np.stack(poses).astype(np.float32),
        fx=np.full((k,), fx, np.float32),
        fy=np.full((k,), fy, np.float32),
        cx=np.full((k,), cx, np.float32),
        cy=np.full((k,), cy, np.float32),
        width=np.full((k,), width, np.int32),
        height=np.full((k,), height, np.int32),
        camera_type=np.full((k,), CameraType.PERSPECTIVE.value, np.int32),
    )
