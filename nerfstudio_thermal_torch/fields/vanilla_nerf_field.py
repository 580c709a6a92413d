"""The classic NeRF field (counterpart of nerfstudio_thermal_tpu/fields/vanilla_nerf_field.py).

Frequency encodings of the position (10 frequencies, or MipNeRF's
integrated encoding of the conical frustums' gaussians with
`use_integrated_encoding`) and of the direction (4), both with the input
appended; an 8 x 256 base MLP with a skip at layer 4 whose last layer is
256 wide too; a Dense(1) density head, softplus in f32; a 2 x 128 colour
head with a sigmoid output on concat([base, direction encoding]).

`use_pallas` runs the base stack (and only it) as one fused-MLP call: the
hand-written kernels on the card (rows 1 and 2 of the kernel table, with
an input encoded outside the kernel, 63 or 99 wide, in the compute dtype),
their plain versions on the CPU. Params are f32; compute runs in
`compute_dtype`.
"""

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.ops.encodings import NeRFEncoding
from nerfstudio_thermal_torch.ops.mlp import MLP, dense, variance_scaling_


class NeRFField(nn.Module):
    def __init__(
        self,
        position_num_frequencies: int = 10,
        direction_num_frequencies: int = 4,
        base_mlp_num_layers: int = 8,
        base_mlp_layer_width: int = 256,
        head_mlp_num_layers: int = 2,
        head_mlp_layer_width: int = 128,
        skip_connections: Sequence[int] = (4,),
        use_integrated_encoding: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
    ) -> None:
        super().__init__()
        self.use_integrated_encoding = use_integrated_encoding
        self.compute_dtype = compute_dtype
        self.position_encoding = NeRFEncoding(
            in_dim=3, num_frequencies=position_num_frequencies, min_freq_exp=0.0,
            max_freq_exp=position_num_frequencies - 1, include_input=True,
        )
        self.direction_encoding = NeRFEncoding(
            in_dim=3, num_frequencies=direction_num_frequencies, min_freq_exp=0.0,
            max_freq_exp=direction_num_frequencies - 1, include_input=True,
        )
        self.mlp_base = MLP(
            in_dim=self.position_encoding.out_dim,
            num_layers=base_mlp_num_layers,
            layer_width=base_mlp_layer_width,
            out_dim=base_mlp_layer_width,
            skip_connections=skip_connections,
            compute_dtype=compute_dtype,
            fused=use_pallas,
        )
        self.density_head = nn.Linear(base_mlp_layer_width, 1)
        self.mlp_head = MLP(
            in_dim=base_mlp_layer_width + self.direction_encoding.out_dim,
            num_layers=head_mlp_num_layers,
            layer_width=head_mlp_layer_width,
            out_dim=3,
            out_activation="sigmoid",
            compute_dtype=compute_dtype,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: lecun-normal kernels, zero biases."""
        self.mlp_base.reset_parameters(generator)
        with torch.no_grad():
            variance_scaling_(self.density_head.weight, 1.0, generator)
            self.density_head.bias.zero_()
        self.mlp_head.reset_parameters(generator)

    def forward(self, ray_samples: RaySamples, train: bool = True) -> Dict[FieldHeadNames, torch.Tensor]:
        if self.use_integrated_encoding:
            means, cov_diag = ray_samples.get_gaussian_blob()
            shape = means.shape[:-1]
            enc = self.position_encoding(means.reshape(-1, 3), covs=cov_diag.reshape(-1, 3))
        else:
            positions = ray_samples.get_positions()
            shape = positions.shape[:-1]
            enc = self.position_encoding(positions.reshape(-1, 3))
        base = self.mlp_base(enc.to(self.compute_dtype))
        density = F.softplus(
            dense(base, self.density_head.weight, self.density_head.bias, self.compute_dtype).float()
        ).reshape(*shape, 1)
        d = self.direction_encoding(
            ray_samples.directions[..., None, :].expand(*shape, 3).reshape(-1, 3)
        ).to(self.compute_dtype)
        rgb = self.mlp_head(torch.cat([base, d], dim=-1)).float().reshape(*shape, 3)
        return {FieldHeadNames.DENSITY: density, FieldHeadNames.RGB: rgb}
