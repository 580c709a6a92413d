"""TSDF fusion: integrate rendered depth and colour maps into a truncated
signed-distance volume and extract a mesh
(counterpart of nerfstudio_thermal_tpu/exporter/tsdf_utils.py).

The volume lives on the model's device as torch tensors. Each image is one
dense update: every voxel is projected into the camera, samples the depth
and colour maps at its nearest pixel, and blends into the running weighted
average, line for line as the JAX package's eager update. The voxel
centres are built once on the host (`voxel_world_coords`) and moved to
the device; each camera's inverse pose is taken on the host. The mesh is
the copied marching cubes of the clamped volume on the host, coloured by
trilinear lookup into the colour volume.
"""

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from nerfstudio_thermal_torch.exporter.exporter_utils import render_cameras_for_export, write_ply_mesh
from nerfstudio_thermal_torch.exporter.marching_cubes import _trilinear, marching_cubes


@dataclass
class TSDF:
    """Dense TSDF volume on `values.device`: values / weights [X, Y, Z],
    colors [X, Y, Z, 3]; voxel_size and origin [3] on the host."""

    values: torch.Tensor
    weights: torch.Tensor
    colors: torch.Tensor
    voxel_size: np.ndarray  # [3]
    origin: np.ndarray  # [3]
    truncation_margin: float = 5.0
    _points: Optional[torch.Tensor] = field(default=None, init=False, repr=False)

    @property
    def truncation(self) -> float:
        return float(self.voxel_size[0]) * self.truncation_margin

    @staticmethod
    def from_aabb(aabb: np.ndarray, volume_dims, device: Union[str, torch.device]) -> "TSDF":
        """aabb [[min], [max]] (2, 3); volume_dims [3] ints."""
        aabb = np.asarray(aabb, np.float32)
        dims = tuple(int(d) for d in np.asarray(volume_dims, np.int64))
        origin = aabb[0]
        voxel_size = (aabb[1] - aabb[0]) / np.asarray(dims, np.int64)
        values = -torch.ones(dims, dtype=torch.float32, device=device)
        weights = torch.zeros(dims, dtype=torch.float32, device=device)
        colors = torch.zeros(dims + (3,), dtype=torch.float32, device=device)
        return TSDF(values, weights, colors, voxel_size, origin)

    def voxel_world_coords(self) -> np.ndarray:
        """[X, Y, Z, 3] world coordinates of the voxels: voxel (i, j, k) at
        origin + (i, j, k) * voxel_size."""
        dims = self.values.shape
        grid = np.stack(
            np.meshgrid(np.arange(dims[0]), np.arange(dims[1]), np.arange(dims[2]), indexing="ij"), axis=-1
        ).astype(np.float32)
        return self.origin[None, None, None] + grid * self.voxel_size[None, None, None]

    def voxel_points(self) -> torch.Tensor:
        """voxel_world_coords as float32 [X * Y * Z, 3] on the volume's
        device, built once."""
        if self._points is None:
            self._points = torch.as_tensor(
                self.voxel_world_coords(), dtype=torch.float32, device=self.values.device
            ).reshape(-1, 3)
        return self._points

    @torch.no_grad()
    def integrate_tsdf(
        self,
        c2w: np.ndarray,  # [B, 4, 4] OpenGL / nerfstudio convention
        K: np.ndarray,  # [B, 3, 3]
        depth_images: np.ndarray,  # [B, H, W]
        color_images: Optional[np.ndarray] = None,  # [B, H, W, 3]
    ) -> None:
        """Fuse a batch of depth (and colour) maps, one dense update per
        image."""
        device = self.values.device
        values, weights, colors = self.values, self.weights, self.colors
        shape = values.shape
        pts = self.voxel_points()
        trunc = self.truncation
        flip = torch.tensor([1.0, -1.0, -1.0], device=device)
        H, W = depth_images.shape[1:3]

        for i in range(c2w.shape[0]):
            w2c = torch.as_tensor(np.linalg.inv(c2w[i]), dtype=torch.float32, device=device)
            cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
            # nerfstudio cameras look down -z with +y up; flip to the
            # +z-forward, +y-down pinhole frame
            cam = cam * flip
            voxel_depth = torch.linalg.norm(cam, dim=-1)  # distance, not z
            z = cam[:, 2]
            Ki = torch.as_tensor(K[i], dtype=torch.float32, device=device)
            uv = (cam / torch.where(z == 0, 1e-9, z)[:, None]) @ Ki.T
            u = uv[:, 0]
            v = uv[:, 1]
            # round half to even, as jnp.round
            ui = torch.round(u - 0.5).to(torch.int32).clamp(0, W - 1).long()
            vi = torch.round(v - 0.5).to(torch.int32).clamp(0, H - 1).long()
            in_view = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)

            dimg = torch.as_tensor(depth_images[i], dtype=torch.float32, device=device)
            sampled_depth = dimg[vi, ui]
            dist = sampled_depth - voxel_depth
            tsdf_vals = torch.clamp(dist / trunc, -1.0, 1.0)
            valid = in_view & (voxel_depth > 0) & (sampled_depth > 0) & (dist > -trunc)

            new_w = valid.float()
            total_w = weights.reshape(-1) + new_w
            safe = torch.where(total_w == 0, 1.0, total_w)
            merged = (values.reshape(-1) * weights.reshape(-1) + tsdf_vals * new_w) / safe
            values = torch.where(valid, merged, values.reshape(-1)).reshape(shape)

            if color_images is not None:
                cimg = torch.as_tensor(color_images[i], dtype=torch.float32, device=device)
                sampled_c = cimg[vi, ui]
                merged_c = (
                    colors.reshape(-1, 3) * weights.reshape(-1)[:, None] + sampled_c * new_w[:, None]
                ) / safe[:, None]
                colors = torch.where(valid[:, None], merged_c, colors.reshape(-1, 3)).reshape(shape + (3,))

            weights = torch.where(valid, torch.clamp(total_w, max=1.0), weights.reshape(-1)).reshape(shape)

        self.values, self.weights, self.colors = values, weights, colors

    def get_mesh(self):
        """Marching cubes over the clamped TSDF on the host, vertex colours
        by trilinear lookup. Returns (verts, faces, normals, colors)."""
        values = self.values.cpu().numpy()
        verts_idx, faces, normals = marching_cubes(np.clip(values, -1, 1), level=0.0, gradient_direction="ascent")
        if len(verts_idx) == 0:
            return verts_idx, faces, normals, np.zeros((0, 3), np.float32)
        colors = self.colors.cpu().numpy()
        cols = np.stack([_trilinear(colors[..., c], verts_idx) for c in range(3)], axis=-1)
        verts = self.origin[None] + verts_idx * self.voxel_size[None]
        return verts.astype(np.float32), faces, normals, cols


def export_tsdf_mesh(
    model,
    cameras,
    output_dir: Path,
    downscale_factor: int = 2,
    depth_output_name: str = "depth",
    rgb_output_name: str = "rgb",
    resolution: Union[int, List[int]] = 128,
    bounding_box_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0),
    bounding_box_max: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    filename: str = "tsdf_mesh.ply",
) -> Path:
    """Render the cameras, fuse them into a TSDF on the model's device and
    write a PLY mesh."""
    aabb = np.asarray([bounding_box_min, bounding_box_max], np.float32)
    dims = np.asarray([resolution] * 3) if isinstance(resolution, int) else np.asarray(resolution)
    tsdf = TSDF.from_aabb(aabb, dims, device=model.device)

    rgbs, depths, c2ws, Ks = render_cameras_for_export(
        model, cameras, rgb_output_name=rgb_output_name, depth_output_name=depth_output_name,
        downscale_factor=downscale_factor,
    )
    # per-modality image resolutions vary, so integrate image by image
    for i in range(len(c2ws)):
        tsdf.integrate_tsdf(c2ws[i:i + 1], Ks[i:i + 1], depths[i][None], color_images=rgbs[i][None])

    verts, faces, normals, cols = tsdf.get_mesh()
    out = Path(output_dir) / filename
    write_ply_mesh(out, verts, faces, normals=normals, colors=cols)
    return out
