"""Poisson surface reconstruction from an oriented point cloud
(counterpart of nerfstudio_thermal_tpu/exporter/poisson.py).

The regular-grid form of Kazhdan et al. 2006, eq. 2: the indicator chi
whose gradient best matches the splatted normal field V solves
laplacian(chi) = div(V); the mesh is chi's isosurface at the mean
indicator value over the input samples. On a regular grid the Poisson
equation diagonalises under the DFT, so the solve is three forward FFTs
and one inverse, here `torch.fft` on the model's device (cuFFT on the
card), in float32 / complex64 as the JAX package's `jnp.fft`. The
trilinear splat (`np.add.at`) and the isosurface extraction stay on the
host, as there.
"""

import math
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from nerfstudio_thermal_torch.exporter.exporter_utils import generate_point_cloud, write_ply_mesh
from nerfstudio_thermal_torch.exporter.marching_cubes import _trilinear, marching_cubes


def _splat_trilinear(grid: np.ndarray, idx: np.ndarray, values: np.ndarray):
    """Scatter-add values [N, C] into grid [D, D, D, C] at fractional
    indices idx [N, 3] with trilinear weights."""
    D = grid.shape[0]
    i0 = np.floor(idx).astype(np.int64)
    f = idx - i0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                gi = np.clip(i0 + np.array([dx, dy, dz]), 0, D - 1)
                np.add.at(grid, (gi[:, 0], gi[:, 1], gi[:, 2]), w[:, None] * values)


def fftfreq(n: int, device: Union[str, torch.device]) -> torch.Tensor:
    """The DFT's sample frequencies (cycles per sample) in float32, each an
    integer over float32(n), as jnp.fft.fftfreq forms them."""
    k = torch.cat([torch.arange(0, (n - 1) // 2 + 1), torch.arange(-(n // 2), 0)]).to(torch.float32)
    return k.to(device) / torch.tensor(float(n), device=device)


@torch.no_grad()
def solve_indicator(V: np.ndarray, h: np.float32, smooth_sigma: float, device: Union[str, torch.device]) -> np.ndarray:
    """The indicator chi [D, D, D] (float32, on the host) whose Laplacian is
    the divergence of the splatted normal field V [D, D, D, 3], with the
    zero-mean gauge, solved by FFT on `device`."""
    resolution = V.shape[0]
    Vt = torch.as_tensor(V, device=device)
    # mild Gaussian smoothing in the Fourier domain stabilises sparse
    # splats (the octree basis's intrinsic smoothing)
    k = fftfreq(resolution, device)  # cycles per voxel
    kx, ky, kz = torch.meshgrid(k, k, k, indexing="ij")
    if smooth_sigma > 0:
        gauss = torch.exp(-2 * (math.pi * smooth_sigma) ** 2 * (kx**2 + ky**2 + kz**2))
    else:
        gauss = 1.0

    # div(V) and the inverse Laplacian, both through the DFT of the centred
    # finite-difference stencils: d/dx -> i sin(2 pi k) / h, laplacian ->
    # -(4 / h^2) sum sin^2(pi k); the scalars in float32 as numpy forms them
    Fx = torch.fft.fftn(Vt[..., 0])
    Fy = torch.fft.fftn(Vt[..., 1])
    Fz = torch.fft.fftn(Vt[..., 2])
    h_f = float(h)

    def i_sin(kk):
        return 1j * torch.sin(2 * math.pi * kk) / h_f

    div_hat = (i_sin(kx) * Fx + i_sin(ky) * Fy + i_sin(kz) * Fz) * gauss
    scale = float(-4.0 / h**2)
    lap_eig = scale * (
        torch.sin(math.pi * kx) ** 2 + torch.sin(math.pi * ky) ** 2 + torch.sin(math.pi * kz) ** 2
    )
    lap_eig[0, 0, 0] = 1.0  # zero-mean gauge
    chi_hat = div_hat / lap_eig
    chi_hat[0, 0, 0] = 0.0
    return torch.real(torch.fft.ifftn(chi_hat)).to(torch.float32).cpu().numpy()


def poisson_reconstruct(
    points: np.ndarray,  # [N, 3]
    normals: np.ndarray,  # [N, 3] outward-oriented
    device: Union[str, torch.device],
    resolution: int = 128,
    padding: float = 0.1,
    smooth_sigma: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reconstruct a watertight mesh, the solve on `device`. Returns
    (vertices, faces, normals)."""
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    nrm = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(nrm, 1e-12)

    bb_min = points.min(0)
    bb_max = points.max(0)
    extent = (bb_max - bb_min).max() * (1 + 2 * padding)
    center = (bb_min + bb_max) / 2
    origin = center - extent / 2
    h = extent / (resolution - 1)

    idx = (points - origin) / h  # fractional grid coordinates

    # splat the normal field V (one vector per voxel)
    V = np.zeros((resolution,) * 3 + (3,), np.float32)
    _splat_trilinear(V, idx, normals)
    chi = solve_indicator(V, h, smooth_sigma, device)

    # iso level: the mean indicator value at the input samples (Kazhdan sec. 4)
    level = float(np.mean(_trilinear(chi, idx)))
    return marching_cubes(
        chi, level=level, origin=origin, spacing=np.full(3, h, np.float32),
        gradient_direction="descent",  # chi is larger inside
    )


def export_poisson_mesh(
    model,
    cameras,
    output_dir: Path,
    num_points: Optional[int] = 500000,
    resolution: int = 128,
    min_accumulation: float = 0.5,
    stride: int = 4,
    filename: str = "poisson_mesh.ply",
) -> Path:
    """Point cloud (with finite-difference normals from the expected depth)
    -> Poisson mesh, solved on the model's device."""
    points, colors, normals = generate_point_cloud(
        model, cameras, min_accumulation=min_accumulation, stride=stride, return_normals=True,
    )
    if num_points is not None and len(points) > num_points:
        sel = np.random.default_rng(0).choice(len(points), num_points, replace=False)
        points, colors, normals = points[sel], colors[sel], normals[sel]
    verts, faces, vnormals = poisson_reconstruct(points, normals, model.device, resolution=resolution)
    out = Path(output_dir) / filename
    write_ply_mesh(out, verts, faces, normals=vnormals)
    return out
