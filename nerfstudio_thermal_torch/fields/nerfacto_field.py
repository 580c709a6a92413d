"""Nerfacto field with a frequency-encoded base MLP
(counterpart of nerfstudio_thermal_tpu/fields/nerfacto_field.py).

This slice carries `field_encoding="freq"`: contraction -> (x + 2) / 4 ->
in-box selector -> frequency encoding + deep MLP -> f32 trunc_exp density;
the colour head takes SH(direction) ++ geo features ++ appearance embedding.
With `use_pallas` the base MLP passes the fused-MLP gate and its encoding
runs inside the fused kernel. The hash-grid base field arrives with the
training slice of `thermal-nerfacto`; the fused ray-march and whole-field
kernels are later work. `ThermalNerfactoField` is the same module with
`num_channels` in {1, 3, 4}.
"""

from typing import Dict, Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames, normalize_positions
from nerfstudio_thermal_torch.ops.activations import trunc_exp
from nerfstudio_thermal_torch.ops.encodings import NeRFEncoding, SHEncoding
from nerfstudio_thermal_torch.ops.mlp import MLP


class NerfactoField(nn.Module):
    def __init__(
        self,
        aabb,
        num_images: int,
        geo_feat_dim: int = 15,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
        appearance_embedding_dim: int = 32,
        use_average_appearance_embedding: bool = False,
        use_spatial_distortion: bool = True,
        average_init_density: float = 1.0,
        num_channels: int = 3,
        num_semantic_classes: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        fused_raymarch: bool = False,
        fused_field: bool = False,
        field_encoding: str = "hash",
        freq_num_frequencies: int = 10,
        freq_num_layers: int = 8,
        freq_hidden_dim: int = 256,
        freq_use_skip: bool = True,
        freq_final_init_scale: float = 1.0,
    ) -> None:
        super().__init__()
        if field_encoding != "freq":
            raise NotImplementedError(
                "the hash-grid base field needs the hash-grid kernels, which "
                "arrive with the training slice of thermal-nerfacto"
            )
        if fused_raymarch or fused_field:
            raise NotImplementedError(
                "the fused ray-march and whole-field kernels (fused_ray_mlp, "
                "fused_field_mlp) are not ported yet"
            )
        if num_semantic_classes > 0:
            raise NotImplementedError("the semantic head is not ported yet")
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32), persistent=False)
        self.num_images = num_images
        self.geo_feat_dim = geo_feat_dim
        self.appearance_embedding_dim = appearance_embedding_dim
        self.use_average_appearance_embedding = use_average_appearance_embedding
        self.use_spatial_distortion = use_spatial_distortion
        self.average_init_density = average_init_density
        self.num_channels = num_channels
        self.use_pallas = use_pallas

        self.direction_encoding = SHEncoding(levels=4)
        nf = freq_num_frequencies
        self.position_encoding = NeRFEncoding(
            in_dim=3, num_frequencies=nf, min_freq_exp=0.0, max_freq_exp=nf - 1,
            include_input=True,
        )
        # With use_pallas the encoding runs inside the fused kernel; otherwise
        # get_density applies position_encoding before the MLP.
        self.mlp_base_net = MLP(
            in_dim=3 if use_pallas else self.position_encoding.out_dim,
            num_layers=freq_num_layers,
            layer_width=freq_hidden_dim,
            out_dim=1 + geo_feat_dim,
            skip_connections=(freq_num_layers // 2,) if freq_use_skip else (),
            compute_dtype=compute_dtype,
            fused=use_pallas,
            final_init_scale=freq_final_init_scale,
            freq_encoding=(nf, 0.0, nf - 1.0, True) if use_pallas else None,
        )
        if appearance_embedding_dim > 0:
            self.embedding_appearance = nn.Parameter(
                torch.empty(num_images, appearance_embedding_dim)
            )
        self.mlp_head = MLP(
            in_dim=self.direction_encoding.out_dim + geo_feat_dim + appearance_embedding_dim,
            num_layers=num_layers_color,
            layer_width=hidden_dim_color,
            out_dim=num_channels,
            out_activation="sigmoid",
            compute_dtype=compute_dtype,
            fused=use_pallas,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX initializers: lecun-normal MLPs (the base MLP's last layer
        scaled), zero biases, N(0, 1) appearance table."""
        self.mlp_base_net.reset_parameters(generator)
        self.mlp_head.reset_parameters(generator)
        if self.appearance_embedding_dim > 0:
            with torch.no_grad():
                nn.init.normal_(self.embedding_appearance, 0.0, 1.0, generator=generator)

    def get_density(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """World positions [..., 3] -> (density [..., 1] f32, geo features)."""
        positions, selector = normalize_positions(positions, self.aabb, self.use_spatial_distortion)
        flat = positions.reshape(-1, 3)
        if not self.use_pallas:
            flat = self.position_encoding(flat)
        h = self.mlp_base_net(flat)
        h = h.reshape(*positions.shape[:-1], h.shape[-1])
        density_before, geo_feat = h[..., :1], h[..., 1:]
        density = self.average_init_density * trunc_exp(density_before.float())
        return density * selector[..., None], geo_feat

    def density_fn(self, positions: torch.Tensor) -> torch.Tensor:
        return self.get_density(positions)[0]

    def get_density_from_rays(self, ray_samples: RaySamples) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.get_density(ray_samples.get_positions())

    def get_outputs(self, ray_samples: RaySamples, geo_feat: torch.Tensor, train: bool = True) -> torch.Tensor:
        """Colour head: SH(dir) ++ geo_feat ++ appearance -> MLP -> sigmoid."""
        sample_shape = ray_samples.starts.shape[:-1]
        num_samples = sample_shape[-1]
        d = self.direction_encoding(ray_samples.directions)
        d = d.reshape(-1, d.shape[-1]).repeat_interleave(num_samples, dim=0)
        parts = [d, geo_feat.reshape(-1, self.geo_feat_dim).float()]
        if self.appearance_embedding_dim > 0:
            cam_idx = ray_samples.camera_indices[..., 0].reshape(-1)
            table = self.embedding_appearance
            if train:
                emb = table[cam_idx.long()]
            elif self.use_average_appearance_embedding:
                emb = table.mean(dim=0).expand(cam_idx.shape[0], -1)
            else:
                emb = torch.zeros(
                    cam_idx.shape[0], self.appearance_embedding_dim,
                    dtype=table.dtype, device=table.device,
                )
            parts.append(emb.repeat_interleave(num_samples, dim=0))
        rgb = self.mlp_head(torch.cat(parts, dim=-1))
        return rgb.reshape(*sample_shape, self.num_channels).float()

    def forward(self, ray_samples: RaySamples, train: bool = True) -> Dict[FieldHeadNames, torch.Tensor]:
        density, geo_feat = self.get_density_from_rays(ray_samples)
        rgb = self.get_outputs(ray_samples, geo_feat, train=train)
        return {FieldHeadNames.DENSITY: density, FieldHeadNames.RGB: rgb}


ThermalNerfactoField = NerfactoField
