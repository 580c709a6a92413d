"""The TensoRF field (counterpart of nerfstudio_thermal_tpu/fields/tensorf_field.py).

Vector-matrix decomposition: density and colour features are, per axis
k, the product of a plane lookup over two coordinates and a line lookup
over the third, summed over the rank components (density) or projected by
a linear basis into an appearance vector (colour), which a 2 x 128 MLP
with a sigmoid output reads beside the direction's frequency encoding.
The lookups are the JAX package's bilinear and linear interpolations as
row gathers: corners floor(u) clipped to the grid and floor(u) + 1
clipped, weights u - floor(u) (so a point on the last row takes that row
with weight 1). Positions are normalised to the scene box; density is
zeroed outside the open box (0, 1)^3, colour is not.

The grids' shapes follow `resolution`. A grid whose shape differs from it
(a checkpoint written after an upsample, loaded into a field built at the
config's resolution) loads, and the field's next evaluation raises, as the
JAX package's does at its next apply.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.data.scene_box import SceneBox
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.ops.encodings import NeRFEncoding
from nerfstudio_thermal_torch.ops.mlp import MLP, dense, variance_scaling_

# (plane axes, line axis) per component, TensoRF's matMode / vecMode
_PLANE_AXES = ((0, 1), (0, 2), (1, 2))
_LINE_AXES = (2, 1, 0)
GRID_KEYS = ("density_planes", "density_lines", "color_planes", "color_lines")


def _corners(u: torch.Tensor, r: int):
    u0 = torch.clamp(torch.floor(u).long(), 0, r - 1)
    return u0, torch.clamp(u0 + 1, max=r - 1), (u - u0)[..., None]


def bilinear_plane(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """plane [R, R, C]; u, v in [0, R - 1] -> [N, C]."""
    r = plane.shape[0]
    u0, u1, fu = _corners(u, r)
    v0, v1, fv = _corners(v, r)
    flat = plane.reshape(r * r, -1)
    p00, p01 = flat[u0 * r + v0], flat[u0 * r + v1]
    p10, p11 = flat[u1 * r + v0], flat[u1 * r + v1]
    return p00 * (1 - fu) * (1 - fv) + p01 * (1 - fu) * fv + p10 * fu * (1 - fv) + p11 * fu * fv


def linear_line(line: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """line [R, C]; w in [0, R - 1] -> [N, C]."""
    w0, w1, fw = _corners(w, line.shape[0])
    return line[w0] * (1 - fw) + line[w1] * fw


class TensoRFField(nn.Module):
    def __init__(
        self,
        aabb,
        resolution: int = 128,
        density_components: int = 16,
        color_components: int = 48,
        appearance_dim: int = 27,
        head_mlp_layers: int = 2,
        head_mlp_width: int = 128,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32), persistent=False)
        self.resolution = resolution
        self.compute_dtype = compute_dtype
        r, cd, cc = resolution, density_components, color_components
        self.density_planes = nn.Parameter(torch.empty(3, r, r, cd))
        self.density_lines = nn.Parameter(torch.empty(3, r, cd))
        self.color_planes = nn.Parameter(torch.empty(3, r, r, cc))
        self.color_lines = nn.Parameter(torch.empty(3, r, cc))
        self.basis = nn.Linear(3 * cc, appearance_dim, bias=False)  # `basis/kernel` in the JAX tree
        self.direction_encoding = NeRFEncoding(
            in_dim=3, num_frequencies=2, min_freq_exp=0.0, max_freq_exp=1.0, include_input=True
        )
        self.mlp_head = MLP(
            in_dim=appearance_dim + self.direction_encoding.out_dim,
            num_layers=head_mlp_layers,
            layer_width=head_mlp_width,
            out_dim=3,
            out_activation="sigmoid",
            compute_dtype=compute_dtype,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Grids from N(0, 0.1^2), the basis lecun-normal, the head's flax
        initializers."""
        with torch.no_grad():
            for name in GRID_KEYS:
                p = getattr(self, name)
                p.copy_(torch.randn(p.shape, generator=generator) * 0.1)
            variance_scaling_(self.basis.weight, 1.0, generator)
        self.mlp_head.reset_parameters(generator)

    def set_grid(self, name: str, value: torch.Tensor) -> nn.Parameter:
        """Replace grid `name` by a new parameter holding `value`."""
        param = nn.Parameter(value.to(device=self.aabb.device, dtype=torch.float32))
        setattr(self, name, param)
        return param

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a grid of another shape loads as it is (the next evaluation raises)
        for name in GRID_KEYS:
            value = state_dict.get(prefix + name)
            if value is not None and tuple(value.shape) != tuple(getattr(self, name).shape):
                self.set_grid(name, torch.empty(value.shape))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _check_grids(self) -> None:
        r = self.resolution
        for name in GRID_KEYS:
            p = getattr(self, name)
            expected = (3, r, r, p.shape[-1]) if name.endswith("planes") else (3, r, p.shape[-1])
            if tuple(p.shape) != expected:
                raise ValueError(
                    f'TensoRFField: parameter "{name}" has shape {tuple(p.shape)}, but the field is built at '
                    f"resolution {r}, which declares {expected} (a checkpoint written after a grid upsample does "
                    "not load into a field built at the config's resolution)"
                )

    def _normalized(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        norm = SceneBox.get_normalized_positions(positions, self.aabb)
        selector = torch.all((norm > 0.0) & (norm < 1.0), dim=-1)
        return torch.clamp(norm, 0.0, 1.0), selector

    @staticmethod
    def _vm_features(norm_flat: torch.Tensor, planes: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
        """[N, 3] normalised -> [N, 3, C] per-axis plane x line products."""
        coords = norm_flat * (planes.shape[1] - 1)
        feats = []
        for k in range(3):
            i, j = _PLANE_AXES[k]
            p = bilinear_plane(planes[k], coords[:, i], coords[:, j])
            v = linear_line(lines[k], coords[:, _LINE_AXES[k]])
            feats.append(p * v)
        return torch.stack(feats, dim=1)

    def get_density(self, positions: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        self._check_grids()
        shape = positions.shape[:-1]
        norm, selector = self._normalized(positions)
        feats = self._vm_features(norm.reshape(-1, 3), self.density_planes, self.density_lines)
        density = torch.relu(torch.sum(feats, dim=(1, 2))).reshape(*shape, 1)
        return density * selector[..., None], None

    def density_fn(self, positions: torch.Tensor) -> torch.Tensor:
        return self.get_density(positions)[0]

    def forward(self, ray_samples: RaySamples, train: bool = True) -> Dict[FieldHeadNames, torch.Tensor]:
        positions = ray_samples.get_positions()
        shape = positions.shape[:-1]
        density, _ = self.get_density(positions)
        norm, _ = self._normalized(positions)
        flat = norm.reshape(-1, 3)
        color_feats = self._vm_features(flat, self.color_planes, self.color_lines).reshape(flat.shape[0], -1)
        zero_bias = torch.zeros(self.basis.out_features, device=flat.device)
        appearance = dense(color_feats.to(self.compute_dtype), self.basis.weight, zero_bias, self.compute_dtype)
        d = self.direction_encoding(
            ray_samples.directions[..., None, :].expand(*shape, 3).reshape(-1, 3)
        ).to(self.compute_dtype)
        rgb = self.mlp_head(torch.cat([appearance, d], dim=-1)).float().reshape(*shape, 3)
        return {FieldHeadNames.DENSITY: density, FieldHeadNames.RGB: rgb}
