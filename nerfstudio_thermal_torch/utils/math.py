"""Math helpers (counterpart of nerfstudio_thermal_tpu/utils/math.py).

`cumsum` carries the semantics of the JAX package's `cumsum_mxu`, which
writes the prefix sum as a triangular matmul for the TPU's matrix unit.
Here it is `torch.cumsum`: the same sums in another order, so the two
agree to f32 rounding, not bitwise. `safe_norm` and the masked `psnr` serve
the training losses and metrics; `psnr` and `ssim` also score whole eval
images, on whatever device the image lives on.
`conical_frustum_to_gaussian_diag` and `expected_sin` are MipNeRF's
integrated positional encoding's halves, in the JAX package's op order.
`generate_polyhedron_basis` (the Fourier-feature encoding's basis) is a
numpy copy of the JAX package's.
"""

import itertools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def cumsum(x: torch.Tensor, dim: int = -1, exclusive: bool = False) -> torch.Tensor:
    """Inclusive or exclusive prefix sum along `dim`."""
    out = torch.cumsum(x, dim=dim)
    if exclusive:
        out = torch.cat(
            [torch.zeros_like(out.narrow(dim, 0, 1)), out.narrow(dim, 0, out.shape[dim] - 1)],
            dim=dim,
        )
    return out


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize; vectors with norm below eps are returned unchanged."""
    s = torch.sum(v * v, dim=-1, keepdim=True)
    safe = s > eps * eps
    nrm = torch.sqrt(torch.where(safe, s, torch.ones_like(s)))
    return torch.where(safe, v / nrm, v)


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero (not NaN) gradient at x == 0 (double-where)."""
    s = torch.sum(x * x, dim=dim)
    nonzero = s > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, s, torch.ones_like(s))), torch.zeros_like(s))


def conical_frustum_to_gaussian_diag(origins, directions, starts, ends, radius):
    """Gaussian approximation of a conical frustum: (means [..., 3],
    cov_diag [..., 3]), the diagonal being all the integrated positional
    encoding reads."""
    mu = (starts + ends) / 2.0
    hw = (ends - starts) / 2.0
    means = origins + directions * (mu + (2.0 * mu * hw**2.0) / (3.0 * mu**2.0 + hw**2.0))
    dir_variance = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / (3 * mu**2 + hw**2) ** 2)
    radius_variance = radius**2 * ((mu**2) / 4 + (5 / 12) * hw**2 - 4 / 15 * (hw**4) / (3 * mu**2 + hw**2))
    # diag(cov) = dir_var * d_i^2 + radius_var * (1 - d_i^2 / |d|^2)
    d_sq = directions**2
    d_mag_sq = torch.clamp(torch.sum(d_sq, dim=-1, keepdim=True), min=1e-10)
    cov_diag = dir_variance * d_sq + radius_variance * (1.0 - d_sq / d_mag_sq)
    return means, cov_diag


def expected_sin(x_means: torch.Tensor, x_vars: torch.Tensor) -> torch.Tensor:
    """E[sin(y)] for y ~ N(x_means, x_vars)."""
    return torch.exp(-0.5 * x_vars) * torch.sin(x_means)


def psnr(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Peak signal-to-noise ratio, data range 1.0. The mask broadcasts over
    elements (masked PSNR = PSNR of the masked subset)."""
    se = (pred - target) ** 2
    if mask is None:
        mse = torch.mean(se)
    else:
        mask = torch.broadcast_to(mask, se.shape)
        mse = torch.sum(se * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(
    pred: torch.Tensor,  # [H, W, C] in [0, 1]
    target: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity over a full image (Wang et al. 2004): the mean
    of the SSIM map, a separable Gaussian window with valid padding along H
    and then W, per channel."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    g = _gaussian_kernel(kernel_size, sigma, pred.device)
    channels = pred.shape[-1]
    kh = g.view(1, 1, -1, 1).expand(channels, 1, -1, 1)
    kw = g.view(1, 1, 1, -1).expand(channels, 1, 1, -1)

    def blur(img):  # [H, W, C] -> [C, H - k + 1, W - k + 1], channels apart
        x = img.permute(2, 0, 1).unsqueeze(0)
        return F.conv2d(F.conv2d(x, kh, groups=channels), kw, groups=channels)[0]

    pred = pred.float()
    target = target.float()
    mu_x = blur(pred)
    mu_y = blur(target)
    mu_xx = blur(pred * pred)
    mu_yy = blur(target * target)
    mu_xy = blur(pred * target)

    sigma_x = mu_xx - mu_x**2
    sigma_y = mu_yy - mu_y**2
    sigma_xy = mu_xy - mu_x * mu_y

    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


# Polyhedron bases for Fourier features (MipNeRF-360; reference
# utils/math.py:366-520, adapted from multinerf geopoly)


def _columnwise_sq_dist(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    sx = np.sum(x**2, 0)
    sy = np.sum(y**2, 0)
    return sx[:, None] + sy[None, :] - 2 * x.T @ y


def _tesselate_geodesic(verts: np.ndarray, faces: np.ndarray, v: int, eps: float = 1e-4) -> np.ndarray:
    if v < 1:
        raise ValueError("tesselation factor must be >= 1")
    weights = []
    for i in range(v + 1):
        for j in range(v + 1 - i):
            weights.append((i, j, v - (i + j)))
    weights = np.asarray(weights, np.float64) / v
    out = []
    for face in faces:
        nv = weights @ verts[face]
        nv /= np.sqrt(np.sum(nv**2, 1, keepdims=True))
        out.append(nv)
    out = np.concatenate(out, 0)
    sq = _columnwise_sq_dist(out.T, out.T)
    assignment = np.array([np.min(np.argwhere(d <= eps)) for d in sq])
    return out[np.unique(assignment)]


def generate_polyhedron_basis(
    basis_shape: str = "octahedron",
    angular_tesselation: int = 1,
    remove_symmetries: bool = True,
    eps: float = 1e-4,
) -> np.ndarray:
    """3D Fourier basis from a tesselated polyhedron: [n, 3] f32 (the last
    axis flipped, as in the reference)."""
    if basis_shape == "icosahedron":
        a = (math.sqrt(5) + 1) / 2
        verts = np.asarray(
            [(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a),
             (0, a, 1), (0, a, -1), (0, -a, 1), (0, -a, -1),
             (a, 1, 0), (-a, 1, 0), (a, -1, 0), (-a, -1, 0)],
            np.float64,
        ) / math.sqrt(a + 2)
        faces = np.asarray(
            [(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
             (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3),
             (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6), (0, 1, 6),
             (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11)]
        )
        verts = _tesselate_geodesic(verts, faces, angular_tesselation, eps)
    elif basis_shape == "octahedron":
        verts = np.asarray(
            [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0)],
            np.float64,
        )
        corners = np.asarray(list(itertools.product([-1, 1], repeat=3)), np.float64)
        pairs = np.argwhere(_columnwise_sq_dist(corners.T, verts.T) == 2)
        faces = np.sort(pairs[:, 1].reshape(3, -1).T, 1)
        verts = _tesselate_geodesic(verts, faces, angular_tesselation, eps)
    else:
        raise ValueError(f"unknown basis shape {basis_shape}")

    if remove_symmetries:
        match = _columnwise_sq_dist(verts.T, -verts.T) < eps
        verts = verts[np.any(np.triu(match), 1)]
    return verts[:, ::-1].astype(np.float32)
