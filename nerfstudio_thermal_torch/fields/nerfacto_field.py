"""Nerfacto field (counterpart of nerfstudio_thermal_tpu/fields/nerfacto_field.py).

Density: contraction -> (x + 2) / 4 -> in-box selector -> base network ->
f32 trunc_exp density. The base network is either the hash grid feeding a
narrow eager MLP (`field_encoding="hash"`, or any value but "freq" as in
the JAX module: `mlp_base`, ops/mlp.py `MLPWithHashEncoding`, the
hand-written hash kernels on CUDA), or a frequency encoding + deep MLP
(`field_encoding="freq"`: `mlp_base_net`;
with `use_pallas` it passes the fused-MLP gate and its encoding runs inside
the fused kernel). The colour head takes SH(direction) ++ geo features ++
appearance embedding. With `fused_raymarch`, `get_density_from_rays` runs
the fused ray-march kernel (positions, contraction, selector, encoding and
the base MLP in one call); with `fused_field` as well, the whole field
(ray march, base MLP, SH, appearance embedding and colour head) is one
whole-field kernel call (ops/cuda/fused_ray.py). Where the configuration
cannot fuse (a hash field, no contraction, use_pallas off, no appearance
embedding), both fall back to the unfused path silently, as the JAX
module does. The semantic head is later work and raises.
`ThermalNerfactoField` is the same module with `num_channels` in {1, 3, 4}.
"""

from typing import Dict, Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames, normalize_positions, ray_march_inputs
from nerfstudio_thermal_torch.ops.activations import trunc_exp
from nerfstudio_thermal_torch.ops.cuda.fused_ray import fused_field_mlp
from nerfstudio_thermal_torch.ops.encodings import NeRFEncoding, SHEncoding
from nerfstudio_thermal_torch.ops.mlp import MLP, MLPWithHashEncoding


def density_tv_points(aabb: torch.Tensor, uniforms: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """The density TV loss's base-network inputs: points aabb[0] + extent *
    uniforms ([P, 3] in [0, 1)) and their 6 axis neighbours one extent /
    voxel_size away, [7 P, 3] (the points, then the neighbour blocks), each
    zeroed unless it lies in (0, 1)^3 in world coordinates."""
    scaled = aabb[0] + (aabb[1] - aabb[0]) * uniforms.float()
    width = (aabb[1] - aabb[0]) / voxel_size
    offsets = torch.tensor(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype=torch.float32, device=scaled.device,
    )
    neighbors = scaled[None] - offsets[:, None, :] * width
    points = torch.cat([scaled[None], neighbors], dim=0).reshape(-1, 3)
    selector = torch.all((points > 0.0) & (points < 1.0), dim=-1)
    return points * selector[..., None]


class NerfactoField(nn.Module):
    def __init__(
        self,
        aabb,
        num_images: int,
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        num_levels: int = 16,
        base_res: int = 16,
        max_res: int = 2048,
        log2_hashmap_size: int = 19,
        num_layers_color: int = 3,
        features_per_level: int = 2,
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
        self.fused_raymarch = fused_raymarch
        self.fused_field = fused_field
        self.num_semantic_classes = num_semantic_classes
        self.field_encoding = field_encoding

        self.direction_encoding = SHEncoding(levels=4)
        if field_encoding != "freq":
            self.mlp_base = MLPWithHashEncoding(
                num_levels=num_levels,
                min_res=base_res,
                max_res=max_res,
                log2_hashmap_size=log2_hashmap_size,
                features_per_level=features_per_level,
                num_layers=num_layers,
                layer_width=hidden_dim,
                out_dim=1 + geo_feat_dim,
                compute_dtype=compute_dtype,
            )
        else:
            nf = freq_num_frequencies
            self.position_encoding = NeRFEncoding(
                in_dim=3, num_frequencies=nf, min_freq_exp=0.0, max_freq_exp=nf - 1,
                include_input=True,
            )
            # With use_pallas the encoding runs inside the fused kernel;
            # otherwise get_density applies position_encoding before the MLP.
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
        """JAX initializers: U(-1e-3, 1e-3) hash tables, lecun-normal MLPs
        (the freq base MLP's last layer scaled), zero biases, N(0, 1)
        appearance table."""
        self.base_network.reset_parameters(generator)
        self.mlp_head.reset_parameters(generator)
        if self.appearance_embedding_dim > 0:
            with torch.no_grad():
                nn.init.normal_(self.embedding_appearance, 0.0, 1.0, generator=generator)

    def get_density(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """World positions [..., 3] -> (density [..., 1] f32, geo features)."""
        positions, selector = normalize_positions(positions, self.aabb, self.use_spatial_distortion)
        flat = positions.reshape(-1, 3)
        if self.field_encoding == "freq" and not self.use_pallas:
            flat = self.position_encoding(flat)
        h = self.base_network(flat)
        h = h.reshape(*positions.shape[:-1], h.shape[-1])
        density_before, geo_feat = h[..., :1], h[..., 1:]
        density = self.average_init_density * trunc_exp(density_before.float())
        return density * selector[..., None], geo_feat

    @property
    def base_network(self) -> nn.Module:
        """The density network: `mlp_base` (hash) or `mlp_base_net` (freq)."""
        return self.mlp_base_net if self.field_encoding == "freq" else self.mlp_base

    def density_fn(self, positions: torch.Tensor) -> torch.Tensor:
        return self.get_density(positions)[0]

    def _fuses_rays(self) -> bool:
        return (
            self.fused_raymarch
            and self.field_encoding == "freq"
            and self.use_spatial_distortion
            and self.use_pallas
            and self.mlp_base_net.will_fuse_rays()
        )

    def get_density_from_rays(self, ray_samples: RaySamples) -> Tuple[torch.Tensor, torch.Tensor]:
        """Density and geo features at the samples' midpoints: the fused ray
        march when the configuration fuses, else get_density at the
        positions (the same function)."""
        if not self._fuses_rays():
            return self.get_density(ray_samples.get_positions())
        sample_shape = ray_samples.starts.shape[:-1]
        origins, dirs, mids = ray_march_inputs(ray_samples)
        h = self.mlp_base_net.forward_rays(origins, dirs, mids, sample_shape[-1])
        h = h.reshape(*sample_shape, h.shape[-1])
        density = self.average_init_density * trunc_exp(h[..., :1].float())
        return density * h[..., -1:].float(), h[..., 1:-1]

    def get_outputs(self, ray_samples: RaySamples, geo_feat: torch.Tensor, train: bool = True) -> torch.Tensor:
        """Colour head: SH(dir) ++ geo_feat ++ appearance -> MLP -> sigmoid."""
        sample_shape = ray_samples.starts.shape[:-1]
        num_samples = sample_shape[-1]
        d = self.direction_encoding(ray_samples.directions)
        d = d.reshape(-1, d.shape[-1]).repeat_interleave(num_samples, dim=0)
        parts = [d, geo_feat.reshape(-1, self.geo_feat_dim).float()]
        if self.appearance_embedding_dim > 0:
            emb = self._appearance(ray_samples.camera_indices[..., 0].reshape(-1), train)
            parts.append(emb.repeat_interleave(num_samples, dim=0))
        rgb = self.mlp_head(torch.cat(parts, dim=-1))
        return rgb.reshape(*sample_shape, self.num_channels).float()

    def _appearance(self, cam_idx: torch.Tensor, train: bool) -> torch.Tensor:
        """Per-ray embeddings: the camera's row in training, else the table's
        mean (use_average_appearance_embedding) or zeros."""
        table = self.embedding_appearance
        if train:
            return table[cam_idx.long()]
        if self.use_average_appearance_embedding:
            return table.mean(dim=0).expand(cam_idx.shape[0], -1)
        return torch.zeros(cam_idx.shape[0], self.appearance_embedding_dim, dtype=table.dtype, device=table.device)

    def _fused_field_ok(self) -> bool:
        return (
            self.fused_field
            and self._fuses_rays()
            and self.appearance_embedding_dim > 0
            and self.num_semantic_classes == 0
        )

    def _fused_field_forward(self, ray_samples: RaySamples, train: bool) -> Dict[FieldHeadNames, torch.Tensor]:
        """The whole field in one whole-field kernel call: the same function
        as get_density_from_rays + get_outputs."""
        sample_shape = ray_samples.starts.shape[:-1]
        origins, dirs, mids = ray_march_inputs(ray_samples)
        emb = self._appearance(ray_samples.camera_indices[..., 0].reshape(-1), train)
        mlp = self.mlp_base_net
        base_ws, base_bs = mlp.export_params()
        head_ws, head_bs = self.mlp_head.export_params()
        out = fused_field_mlp(
            origins, dirs, mids, emb, base_ws, base_bs, head_ws, head_bs, sample_shape[-1],
            mlp.skip_connections, mlp.freq_encoding, mlp.compute_dtype,
            (mlp.pack_cache, self.mlp_head.pack_cache),
        )
        c = self.num_channels
        out = out.reshape(*sample_shape, c + 2)
        density = self.average_init_density * trunc_exp(out[..., c : c + 1].float()) * out[..., c + 1 :].float()
        return {FieldHeadNames.DENSITY: density, FieldHeadNames.RGB: out[..., :c].float()}

    def forward(self, ray_samples: RaySamples, train: bool = True) -> Dict[FieldHeadNames, torch.Tensor]:
        if self._fused_field_ok():
            return self._fused_field_forward(ray_samples, train)
        density, geo_feat = self.get_density_from_rays(ray_samples)
        rgb = self.get_outputs(ray_samples, geo_feat, train=train)
        return {FieldHeadNames.DENSITY: density, FieldHeadNames.RGB: rgb}

    def sample_and_density(self, uniforms: torch.Tensor, voxel_size: float) -> torch.Tensor:
        """Densities at points and their 6 axis neighbours, for the density
        TV loss (`density_tv_points`): [7 P, 1], the points first, then the
        neighbour blocks. As in the JAX module (and the reference's
        get_density_only), the world positions feed the base network
        directly: no contraction, the in-(0, 1)^3 selector on the world
        coordinates, no average_init_density."""
        positions = density_tv_points(self.aabb, uniforms, voxel_size)
        if self.field_encoding == "freq" and not self.use_pallas:
            positions = self.position_encoding(positions)
        h = self.base_network(positions)
        return trunc_exp(h[..., :1].float())


ThermalNerfactoField = NerfactoField
