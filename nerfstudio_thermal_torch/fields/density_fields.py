"""Proposal density fields (counterpart of nerfstudio_thermal_tpu/fields/density_fields.py).

`HashMLPDensityField` is the proposal field of `thermal-nerfacto`: the
hash-grid encoding (ops/encodings.py `HashEncoding`, the hand-written hash
kernels on CUDA) feeding a narrow eager MLP, or with `use_linear` a single
Dense layer (`Dense_0` in the JAX tree). `MLPDensityField` is the
frequency-encoded proposal field of the `*-tpu` configurations. Its MLPs
are 64 wide, so they fail the fused-MLP gate and run eagerly, with the
encoding computed outside the MLP layers, unless `fused_raymarch` is set:
then a call with ray samples runs the fused ray-march kernel
(ops/cuda/fused_ray.py), positions, contraction, selector, encoding and
MLP in one call, with input gradients only when
`fused_raymarch_input_grads` asks for them.
"""

import torch
from torch import nn

from nerfstudio_thermal_torch.fields.base_field import normalize_positions, ray_march_inputs
from nerfstudio_thermal_torch.ops.activations import trunc_exp
from nerfstudio_thermal_torch.ops.encodings import HashEncoding
from nerfstudio_thermal_torch.ops.mlp import MLP, dense, variance_scaling_


class HashMLPDensityField(nn.Module):
    """Hash-grid density field: world positions -> density [..., 1] f32."""

    def __init__(
        self,
        aabb,
        num_layers: int = 2,
        hidden_dim: int = 64,
        use_linear: bool = False,
        num_levels: int = 8,
        max_res: int = 1024,
        base_res: int = 16,
        log2_hashmap_size: int = 18,
        features_per_level: int = 2,
        average_init_density: float = 1.0,
        use_spatial_distortion: bool = True,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32), persistent=False)
        self.use_linear = use_linear
        self.average_init_density = average_init_density
        self.use_spatial_distortion = use_spatial_distortion
        self.compute_dtype = compute_dtype
        self.encoding = HashEncoding(
            num_levels=num_levels,
            min_res=base_res,
            max_res=max_res,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=features_per_level,
            compute_dtype=compute_dtype,
        )
        if use_linear:
            self.linear = nn.Linear(self.encoding.out_dim, 1)
        else:
            self.mlp = MLP(
                in_dim=self.encoding.out_dim,
                num_layers=num_layers,
                layer_width=hidden_dim,
                out_dim=1,
                compute_dtype=compute_dtype,
            )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoding.reset_parameters(generator)
        if self.use_linear:
            with torch.no_grad():
                variance_scaling_(self.linear.weight, 1.0, generator)
                self.linear.bias.zero_()
        else:
            self.mlp.reset_parameters(generator)

    def forward(self, positions: torch.Tensor = None, ray_samples=None) -> torch.Tensor:
        """World positions [..., 3] (or ray_samples) -> density [..., 1] f32."""
        if positions is None:
            positions = ray_samples.get_positions()
        positions, selector = normalize_positions(positions, self.aabb, self.use_spatial_distortion)
        encoded = self.encoding(positions.reshape(-1, 3))
        if self.use_linear:
            h = dense(encoded, self.linear.weight, self.linear.bias, self.compute_dtype)
        else:
            h = self.mlp(encoded)
        density_before = h.reshape(*positions.shape[:-1], 1).float()
        density = self.average_init_density * trunc_exp(density_before)
        return density * selector[..., None]


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
        fused_raymarch_input_grads: bool = True,
        fused_raymarch: bool = False,
    ) -> None:
        super().__init__()
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32), persistent=False)
        self.average_init_density = average_init_density
        self.use_spatial_distortion = use_spatial_distortion
        self.fused_raymarch = fused_raymarch
        self.mlp = MLP(
            in_dim=3,
            num_layers=num_layers,
            layer_width=hidden_dim,
            out_dim=1,
            compute_dtype=compute_dtype,
            fused=use_pallas,
            freq_encoding=(num_frequencies, 0.0, num_frequencies - 1.0, True),
            ray_input_grads=fused_raymarch_input_grads,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mlp.reset_parameters(generator)

    def fuses_rays(self) -> bool:
        """Whether a call with ray samples runs the fused ray march."""
        return self.fused_raymarch and self.use_spatial_distortion and self.mlp.will_fuse_rays()

    def forward(self, positions: torch.Tensor = None, ray_samples=None) -> torch.Tensor:
        """World positions [..., 3] (or ray_samples) -> density [..., 1] f32."""
        if ray_samples is not None and self.fuses_rays():
            sample_shape = ray_samples.starts.shape[:-1]
            h = self.mlp.forward_rays(*ray_march_inputs(ray_samples), sample_shape[-1]).reshape(*sample_shape, 2)
            density = self.average_init_density * trunc_exp(h[..., :1].float())
            return density * h[..., 1:].float()
        if positions is None:
            positions = ray_samples.get_positions()
        positions, selector = normalize_positions(positions, self.aabb, self.use_spatial_distortion)
        h = self.mlp(positions.reshape(-1, 3))
        density_before = h.reshape(*positions.shape[:-1], 1).float()
        density = self.average_init_density * trunc_exp(density_before)
        return density * selector[..., None]
