"""Nerfacto, eval path (counterpart of nerfstudio_thermal_tpu/models/nerfacto.py).

Collider -> proposal hierarchy -> field -> compositing. The training step
(losses, anneal and proposal-update schedules, jittered sampling) arrives
with the training slice; `get_outputs(train=True)` raises until then.
"""

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.camera_optimizers import (
    CameraOptimizerConfig,
    build_camera_optimizer,
)
from nerfstudio_thermal_torch.cameras.rays import RayBundle, RaySamples
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.density_fields import HashMLPDensityField, MLPDensityField
from nerfstudio_thermal_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.ray_samplers import proposal_sample
from nerfstudio_thermal_torch.model_components.scene_colliders import NearFarCollider
from nerfstudio_thermal_torch.models.base_model import Model, ModelConfig


@dataclass
class NerfactoModelConfig(ModelConfig):
    """Field names and defaults as in the JAX package's config. Only the
    fields the eval path reads are here; the training slice adds the loss,
    schedule and hash-grid fields."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    hidden_dim_color: int = 64
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: List[Dict] = dataclass_field(
        default_factory=lambda: [
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128, "use_linear": False},
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256, "use_linear": False},
        ]
    )
    proposal_initial_sampler: str = "piecewise"  # piecewise | uniform
    use_appearance_embedding: bool = True
    use_average_appearance_embedding: bool = True
    disable_scene_contraction: bool = False
    appearance_embed_dim: int = 32
    average_init_density: float = 1.0
    camera_optimizer: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="SO3xR3")
    )
    compute_dtype: str = "float32"  # "bfloat16" for the MLPs
    use_pallas: bool = False
    """Run base MLPs that pass the fused-MLP gate through the fused kernel."""
    fused_raymarch: bool = False
    fused_field: bool = False
    fused_raymarch_proposals: bool = False
    field_encoding: str = "hash"  # "hash" | "freq"
    freq_num_frequencies: int = 10
    freq_num_layers: int = 8
    freq_hidden_dim: int = 256
    freq_use_skip: bool = True
    freq_final_init_scale: float = 1.0


def _check_eval(train: bool) -> None:
    if train:
        raise NotImplementedError("the training forward arrives with the training slice of the port")


class NerfactoModel(Model):
    config: NerfactoModelConfig

    def _field_kwargs(self) -> Dict:
        cfg = self.config
        return dict(
            aabb=self.scene_aabb,
            num_images=self.num_train_data,
            hidden_dim_color=cfg.hidden_dim_color,
            use_spatial_distortion=not cfg.disable_scene_contraction,
            use_average_appearance_embedding=cfg.use_average_appearance_embedding,
            appearance_embedding_dim=cfg.appearance_embed_dim if cfg.use_appearance_embedding else 0,
            compute_dtype=self.compute_dtype,
            use_pallas=cfg.use_pallas,
            fused_raymarch=cfg.fused_raymarch,
            fused_field=cfg.fused_field,
            field_encoding=cfg.field_encoding,
            freq_num_frequencies=cfg.freq_num_frequencies,
            freq_num_layers=cfg.freq_num_layers,
            freq_hidden_dim=cfg.freq_hidden_dim,
            freq_use_skip=cfg.freq_use_skip,
            freq_final_init_scale=cfg.freq_final_init_scale,
        )

    def _build_proposal_nets(self) -> nn.ModuleList:
        cfg = self.config
        args_list = cfg.proposal_net_args_list
        return nn.ModuleList(
            self._build_proposal_net(args_list[min(i, len(args_list) - 1)])
            for i in range(cfg.num_proposal_iterations)
        )

    def _populate_common(self) -> None:
        """Compute dtype, collider and the (RGB) proposal networks."""
        cfg = self.config
        if cfg.use_same_proposal_network:
            raise NotImplementedError("use_same_proposal_network is not ported yet")
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.collider = NearFarCollider(cfg.near_plane, cfg.far_plane)
        self.proposal_networks = self._build_proposal_nets()

    def populate_modules(self) -> None:
        cfg = self.config
        self._populate_common()
        self.field = NerfactoField(
            **self._field_kwargs(), average_init_density=cfg.average_init_density, num_channels=3
        )
        self.camera_optimizer = build_camera_optimizer(cfg.camera_optimizer, self.num_train_data)

    def _build_proposal_net(self, args: Dict) -> nn.Module:
        """A proposal density field from a proposal_net_args_list entry;
        {"encoding": "freq"} selects MLPDensityField."""
        cfg = self.config
        args = dict(args)
        if args.pop("encoding", "hash") != "freq":
            return HashMLPDensityField(**args)
        for k in ("log2_hashmap_size", "num_levels", "max_res", "use_linear", "features_per_level"):
            args.pop(k, None)
        return MLPDensityField(
            aabb=self.scene_aabb,
            use_spatial_distortion=not cfg.disable_scene_contraction,
            average_init_density=cfg.average_init_density,
            compute_dtype=self.compute_dtype,
            use_pallas=cfg.use_pallas,
            fused_raymarch=cfg.fused_raymarch_proposals,
            **args,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fields and proposal nets from the seeded generator; camera
        adjustments start at zero."""
        self.field.reset_parameters(generator)
        for net in self.proposal_networks:
            net.reset_parameters(generator)

    @staticmethod
    def _density_fns(nets: nn.ModuleList):
        return [lambda samples, net=net: net(ray_samples=samples) for net in nets]

    def _sample(self, bundle: RayBundle, nets: nn.ModuleList):
        cfg = self.config
        return proposal_sample(
            bundle,
            self._density_fns(nets),
            num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
            num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
            initial_spacing_kind="uniform" if cfg.proposal_initial_sampler == "uniform" else "piecewise",
        )

    def _get_outputs_for_field(
        self,
        field: NerfactoField,
        ray_samples: RaySamples,
        weights_list,
        ray_samples_list,
        keep_sample_rgb: bool = False,
    ):
        """Per-field eval render. keep_sample_rgb also returns the per-sample
        colour as "rgb_samples", so removal rendering reuses it instead of
        running the field again."""
        cfg = self.config
        field_outputs = field(ray_samples, train=False)
        weights = ray_samples.get_weights(field_outputs[FieldHeadNames.DENSITY])
        weights_list = weights_list + [weights]
        ray_samples_list = ray_samples_list + [ray_samples]
        outputs = {
            "rgb": renderers.render_rgb(
                field_outputs[FieldHeadNames.RGB], weights,
                background_color=cfg.background_color, train=False,
            ),
            "accumulation": renderers.render_accumulation(weights),
            "depth": renderers.render_depth_median(weights, ray_samples),
            "expected_depth": renderers.render_depth_expected(weights, ray_samples),
            "density": field_outputs[FieldHeadNames.DENSITY],
        }
        if keep_sample_rgb:
            outputs["rgb_samples"] = field_outputs[FieldHeadNames.RGB]
        for i in range(cfg.num_proposal_iterations):
            outputs[f"prop_depth_{i}"] = renderers.render_depth_median(
                weights_list[i], ray_samples_list[i]
            )
        return outputs, weights_list, ray_samples_list

    def get_outputs(self, ray_bundle: RayBundle, *, train: bool = False) -> Dict[str, torch.Tensor]:
        _check_eval(train)
        ray_samples, weights_list, ray_samples_list = self._sample(ray_bundle, self.proposal_networks)
        outputs, _, _ = self._get_outputs_for_field(
            self.field, ray_samples, weights_list, ray_samples_list
        )
        return outputs
