"""Nerfacto (counterpart of nerfstudio_thermal_tpu/models/nerfacto.py).

Collider -> proposal hierarchy -> field -> compositing, for eval and for
training. Training adds jittered sampling, the proposal-weight anneal and
the proposal update schedule (`proposal_anneal`, `proposal_updated`: pure
functions of the step, computed on the host in f32 as the JAX package
computes them in its step), the metrics and the losses.
"""

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.camera_optimizers import (
    CameraOptimizerConfig,
    build_camera_optimizer,
)
from nerfstudio_thermal_torch.cameras.rays import RayBundle, RaySamples, map_tensors
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.density_fields import HashMLPDensityField, MLPDensityField
from nerfstudio_thermal_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.losses import (
    distortion_loss,
    interlevel_loss,
    mse_loss,
)
from nerfstudio_thermal_torch.model_components.ray_samplers import proposal_sample
from nerfstudio_thermal_torch.model_components.scene_colliders import NearFarCollider
from nerfstudio_thermal_torch.models.base_model import Model, ModelConfig
from nerfstudio_thermal_torch.utils.math import psnr


@dataclass
class NerfactoModelConfig(ModelConfig):
    """Field names and defaults as in the JAX package's config."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    num_levels: int = 16
    base_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    proposal_camera_gradients: bool = True
    """Let camera-pose gradients flow through the proposal density fields.
    False detaches the samples before the proposal fields only."""
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: List[Dict] = dataclass_field(
        default_factory=lambda: [
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128, "use_linear": False},
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256, "use_linear": False},
        ]
    )
    proposal_initial_sampler: str = "piecewise"  # piecewise | uniform
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    use_proposal_weight_anneal: bool = True
    use_appearance_embedding: bool = True
    use_average_appearance_embedding: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    disable_scene_contraction: bool = False
    use_gradient_scaling: bool = False
    appearance_embed_dim: int = 32
    average_init_density: float = 1.0
    camera_optimizer: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="SO3xR3")
    )
    compute_dtype: str = "float32"  # "bfloat16" for the MLPs
    use_pallas: bool = False
    """Run base MLPs that pass the fused-MLP gate through the fused kernel."""
    fused_raymarch: bool = False
    """The freq field's get_density_from_rays through the fused ray-march
    kernel (positions, contraction, encoding and base MLP in one call)."""
    fused_field: bool = False
    """With fused_raymarch: the whole freq field (ray march, base MLP, SH,
    appearance embedding and colour head) through the whole-field kernel."""
    fused_raymarch_proposals: bool = False
    """The freq proposal fields through the fused ray-march kernel."""
    field_encoding: str = "hash"  # "hash" | "freq"
    freq_num_frequencies: int = 10
    freq_num_layers: int = 8
    freq_hidden_dim: int = 256
    freq_use_skip: bool = True
    freq_final_init_scale: float = 1.0


def proposal_anneal(step: int, max_iters: int, slope: float) -> float:
    """Proposal weight anneal (https://arxiv.org/pdf/2111.12077 eq. 18),
    in f32."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max_iters), f32(0), f32(1))
    return float(f32(slope) * frac / ((f32(slope) - f32(1)) * frac + f32(1)))


def proposal_update_schedule(step: int, warmup: int, update_every: int) -> float:
    """Steps between proposal-gradient updates, in f32."""
    f32 = np.float32
    return float(np.clip(f32(step) * f32(update_every / warmup), f32(1), f32(update_every)))


def proposal_updated(step: int, steps_since_update: int, warmup: int, update_every: int) -> Tuple[bool, int]:
    """Whether this step sends gradients to the proposal nets, and the
    counter's next value."""
    sched = proposal_update_schedule(step, warmup, update_every)
    updated = bool(steps_since_update > sched or step < 10)
    return updated, (0 if updated else steps_since_update) + 1


class NerfactoModel(Model):
    config: NerfactoModelConfig

    def _field_kwargs(self) -> Dict:
        cfg = self.config
        return dict(
            aabb=self.scene_aabb,
            num_images=self.num_train_data,
            hidden_dim=cfg.hidden_dim,
            num_levels=cfg.num_levels,
            max_res=cfg.max_res,
            base_res=cfg.base_res,
            features_per_level=cfg.features_per_level,
            log2_hashmap_size=cfg.log2_hashmap_size,
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
        if cfg.use_gradient_scaling:
            raise NotImplementedError("use_gradient_scaling is not ported yet")
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
        """A proposal density field from a proposal_net_args_list entry:
        HashMLPDensityField, or MLPDensityField for {"encoding": "freq"}."""
        cfg = self.config
        args = dict(args)
        if args.pop("encoding", "hash") != "freq":
            return HashMLPDensityField(
                aabb=self.scene_aabb,
                use_spatial_distortion=not cfg.disable_scene_contraction,
                average_init_density=cfg.average_init_density,
                compute_dtype=self.compute_dtype,
                **args,
            )
        for k in ("log2_hashmap_size", "num_levels", "max_res", "use_linear", "features_per_level"):
            args.pop(k, None)
        return MLPDensityField(
            aabb=self.scene_aabb,
            use_spatial_distortion=not cfg.disable_scene_contraction,
            average_init_density=cfg.average_init_density,
            compute_dtype=self.compute_dtype,
            use_pallas=cfg.use_pallas,
            fused_raymarch=cfg.fused_raymarch_proposals,
            fused_raymarch_input_grads=cfg.proposal_camera_gradients,
            **args,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fields and proposal nets from the seeded generator; camera
        adjustments start at zero."""
        self.field.reset_parameters(generator)
        for net in self.proposal_networks:
            net.reset_parameters(generator)

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        """The JAX package's param groups (= optimizer groups), in the
        order of its param tree; optimizers that are off have none."""
        groups = {}
        for name, attr in (
            ("fields", "field"),
            ("proposal_networks", "proposal_networks"),
            ("camera_opt", "camera_optimizer"),
            ("fields_thermal", "field_thermal"),
            ("proposal_networks_thermal", "proposal_networks_thermal"),
            ("camera_opt_thermal", "camera_optimizer_thermal"),
            ("shared_camera_opt_thermal", "shared_camera_optimizer_thermal"),
            ("shared_camera_opt", "shared_camera_optimizer"),
        ):
            module = getattr(self, attr, None)
            params = list(module.parameters()) if module is not None else []
            if params:
                groups[name] = params
        return groups

    def _density_fns(self, nets: nn.ModuleList):
        detach = not self.config.proposal_camera_gradients

        def fn(samples, net):
            return net(ray_samples=map_tensors(samples, torch.Tensor.detach) if detach else samples)

        return [lambda samples, net=net: fn(samples, net) for net in nets]

    def _sample(
        self,
        bundle: RayBundle,
        nets: nn.ModuleList,
        train: bool = False,
        anneal: float = 1.0,
        updated: bool = True,
        uniforms: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        cfg = self.config
        return proposal_sample(
            bundle,
            self._density_fns(nets),
            num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
            num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
            initial_spacing_kind="uniform" if cfg.proposal_initial_sampler == "uniform" else "piecewise",
            single_jitter=cfg.use_single_jitter,
            anneal=anneal,
            updated=updated,
            train=train,
            uniforms=uniforms,
            generator=generator,
        )

    def _get_outputs_for_field(
        self,
        field: NerfactoField,
        ray_samples: RaySamples,
        weights_list,
        ray_samples_list,
        train: bool = False,
        keep_sample_rgb: bool = False,
    ):
        """Per-field render. keep_sample_rgb (eval) also returns the
        per-sample colour as "rgb_samples", so removal rendering reuses it
        instead of running the field again. The proposal depth maps are
        eval outputs, as in the JAX package."""
        cfg = self.config
        field_outputs = field(ray_samples, train=train)
        weights = ray_samples.get_weights(field_outputs[FieldHeadNames.DENSITY])
        weights_list = weights_list + [weights]
        ray_samples_list = ray_samples_list + [ray_samples]
        outputs = {
            "rgb": renderers.render_rgb(
                field_outputs[FieldHeadNames.RGB], weights,
                background_color=cfg.background_color, train=train,
            ),
            "accumulation": renderers.render_accumulation(weights),
            "depth": renderers.render_depth_median(weights, ray_samples).detach(),
            "expected_depth": renderers.render_depth_expected(weights, ray_samples),
            "density": field_outputs[FieldHeadNames.DENSITY],
        }
        if train:
            return outputs, weights_list, ray_samples_list
        if keep_sample_rgb:
            outputs["rgb_samples"] = field_outputs[FieldHeadNames.RGB]
        for i in range(cfg.num_proposal_iterations):
            outputs[f"prop_depth_{i}"] = renderers.render_depth_median(
                weights_list[i], ray_samples_list[i]
            )
        return outputs, weights_list, ray_samples_list

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        *,
        train: bool = False,
        anneal: float = 1.0,
        updated: bool = True,
        uniforms: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """uniforms: {"rgb": one jitter draw per sampling level}."""
        if train:
            ray_bundle = self.camera_optimizer.apply_to_raybundle(ray_bundle)
        ray_samples, weights_list, ray_samples_list = self._sample(
            ray_bundle, self.proposal_networks, train, anneal, updated,
            (uniforms or {}).get("rgb"), generator,
        )
        outputs, weights_list, ray_samples_list = self._get_outputs_for_field(
            self.field, ray_samples, weights_list, ray_samples_list, train=train
        )
        if train:
            outputs["weights_list"] = weights_list
            outputs["ray_samples_list"] = ray_samples_list
        return outputs

    def _active_camera_optimizers(self):
        return [self.camera_optimizer] if self.camera_optimizer.mode != "off" else []

    def get_metrics_dict(self, outputs, batch, train: bool = True) -> Dict[str, torch.Tensor]:
        gt_rgb = renderers.blend_background_rgb(batch["image"])
        metrics = {"psnr": psnr(outputs["rgb"], gt_rgb)}
        if train:
            metrics["distortion"] = distortion_loss(outputs["weights_list"], outputs["ray_samples_list"])
            for opt in self._active_camera_optimizers():
                metrics.update(opt.metrics())
        return metrics

    def get_loss_dict(
        self, outputs, batch, metrics_dict, *, train: bool = True,
        background_uniforms: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        pred_rgb, gt_rgb = renderers.blend_background_for_loss_rgb(
            outputs["rgb"], outputs["accumulation"], batch["image"],
            background_color=cfg.background_color, uniforms=background_uniforms,
        )
        loss_dict = {"rgb_loss": mse_loss(gt_rgb, pred_rgb)}
        if train:
            loss_dict["interlevel_loss"] = cfg.interlevel_loss_mult * interlevel_loss(
                outputs["weights_list"], outputs["ray_samples_list"]
            )
            loss_dict["distortion_loss"] = cfg.distortion_loss_mult * metrics_dict["distortion"]
            for opt in self._active_camera_optimizers():
                loss_dict[f"camera_opt_regularizer{opt.suffix}"] = opt.regularization_loss()
        return loss_dict
