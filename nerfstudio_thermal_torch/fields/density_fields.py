"""Proposal density fields (counterpart of nerfstudio_thermal_tpu/fields/density_fields.py).

This slice carries `MLPDensityField`, the frequency-encoded proposal field
of the `*-tpu` configurations. Its MLPs are 64 wide, so they fail the
fused-MLP gate and run eagerly, with the encoding computed outside the MLP
layers. The hash-grid `HashMLPDensityField` arrives with the hash-grid
slice of the port (`thermal-nerfacto`).
"""

import torch
from torch import nn

from nerfstudio_thermal_torch.fields.base_field import normalize_positions
from nerfstudio_thermal_torch.ops.activations import trunc_exp
from nerfstudio_thermal_torch.ops.mlp import MLP


class HashMLPDensityField(nn.Module):
    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "HashMLPDensityField needs the hash-grid kernels, which arrive with "
            "the hash-grid slice of the port (thermal-nerfacto)"
        )


class MLPDensityField(nn.Module):
    """Frequency-encoded MLP density field."""

    def __init__(
        self,
        aabb,
        num_layers: int = 2,
        hidden_dim: int = 64,
        num_frequencies: int = 6,
        average_init_density: float = 1.0,
        use_spatial_distortion: bool = True,
        compute_dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        fused_raymarch: bool = False,
    ) -> None:
        super().__init__()
        if fused_raymarch:
            raise NotImplementedError(
                "the fused ray-march kernel (fused_ray_mlp) is not ported yet"
            )
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32), persistent=False)
        self.average_init_density = average_init_density
        self.use_spatial_distortion = use_spatial_distortion
        self.mlp = MLP(
            in_dim=3,
            num_layers=num_layers,
            layer_width=hidden_dim,
            out_dim=1,
            compute_dtype=compute_dtype,
            fused=use_pallas,
            freq_encoding=(num_frequencies, 0.0, num_frequencies - 1.0, True),
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, positions: torch.Tensor = None, ray_samples=None) -> torch.Tensor:
        """World positions [..., 3] (or ray_samples) -> density [..., 1] f32."""
        if positions is None:
            positions = ray_samples.get_positions()
        positions, selector = normalize_positions(positions, self.aabb, self.use_spatial_distortion)
        h = self.mlp(positions.reshape(-1, 3))
        density_before = h.reshape(*positions.shape[:-1], 1).float()
        density = self.average_init_density * trunc_exp(density_before)
        return density * selector[..., None]
