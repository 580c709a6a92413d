"""Checks shared by the export tests on the CPU (against JAX) and on the
card (against the CPU): seeded TSDF inputs and the voxels whose projection
lies on a decision's edge. Imports no JAX."""

import numpy as np

from tests.fixtures import look_at

BORDER_EPS = 1e-4  # pixels, world units: f32 projections of |u| < 64 round within ~1e-5
BORDER_SHARE = 0.5  # of the touched voxels at least this share is compared
VALUE_TOL = 1e-5


def host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def tsdf_inputs(seed=0, b=4, h=24, w=32):
    rng = np.random.default_rng(seed)
    c2w = np.stack([look_at(np.array([2.2 * np.cos(a), 2.2 * np.sin(a), z]))
                    for a, z in zip(rng.uniform(0, 2 * np.pi, b), rng.uniform(-0.5, 0.8, b))]).astype(np.float32)
    K = np.repeat(np.array([[24, 0, 16], [0, 24, 12], [0, 0, 1]], np.float32)[None], b, 0)
    depth = (2.0 + 0.2 * rng.standard_normal((b, h, w))).astype(np.float32)
    depth[:, :2] = 0.0  # pixels with no depth fuse nothing
    color = rng.random((b, h, w, 3)).astype(np.float32)
    return c2w, K, depth, color


def borderline_voxels(tsdf, c2w, K, depths, eps=BORDER_EPS):
    """[X, Y, Z] bool: voxels whose projection into some image lies within
    eps (float64) of a decision's edge: a pixel boundary or the image's
    border (u or v an integer: `round(u - 0.5)` changes there), z = 0, or
    the truncation (dist = -trunc). There the packages' f32 products,
    rounded differently, may decide either way."""
    dims = tsdf.values.shape
    idx = np.stack(np.meshgrid(*(np.arange(d) for d in dims), indexing="ij"), -1).reshape(-1, 3)
    pts = np.float64(tsdf.origin) + idx * np.float64(tsdf.voxel_size)
    flags = np.zeros(len(pts), bool)
    for i in range(len(c2w)):
        w2c = np.linalg.inv(np.float64(c2w[i]))
        cam = (pts @ w2c[:3, :3].T + w2c[:3, 3]) * [1.0, -1.0, -1.0]
        z = cam[:, 2]
        uv = (cam / np.where(z == 0, 1e-9, z)[:, None]) @ np.float64(K[i]).T
        h, w = depths[i].shape
        ui = np.clip(np.round(uv[:, 0] - 0.5), 0, w - 1).astype(int)
        vi = np.clip(np.round(uv[:, 1] - 0.5), 0, h - 1).astype(int)
        dist = depths[i][vi, ui] - np.linalg.norm(cam, axis=-1)
        seen = (z > -eps) & (uv[:, 0] > -eps) & (uv[:, 0] < w + eps) & (uv[:, 1] > -eps) & (uv[:, 1] < h + eps)
        edge = (np.abs(uv[:, :2] - np.round(uv[:, :2])) < eps).any(-1) | (np.abs(dist + tsdf.truncation) < eps)
        flags |= (seen & edge) | (np.abs(z) < eps)
    return flags.reshape(dims)


def assert_volumes_match(got, want, c2w, K, depths):
    """Values, weights and colours equal within VALUE_TOL at every voxel
    but the borderline ones."""
    values, weights, colors = (host(getattr(got, k)) for k in ("values", "weights", "colors"))
    want_values, want_weights, want_colors = (host(getattr(want, k)) for k in ("values", "weights", "colors"))
    same = (weights == want_weights) & (np.abs(values - want_values) <= VALUE_TOL)
    same &= np.abs(colors - want_colors).max(-1) <= VALUE_TOL
    border = borderline_voxels(want, c2w, K, depths)
    touched = int((want_weights > 0).sum())
    assert touched > 0.1 * want_weights.size and set(np.unique(want_weights)) <= {0.0, 1.0}
    assert not (~same & ~border).any(), np.argwhere(~same & ~border)[:5]
    assert ((want_weights > 0) & ~border).sum() >= BORDER_SHARE * touched, (int(border.sum()), touched)
    return same
