"""ThermalNerfacto, eval path in separate density mode
(counterpart of nerfstudio_thermal_tpu/models/thermal_nerfacto.py).

Two full pipelines, RGB and thermal, each with its own proposal stack and
field; each modality's rays go through its shared camera optimizer (off
unless configured). Eval also runs the cross-field densities (each field
at the other's samples) and the "removal" renderings, which keep only the
samples whose RGB and thermal densities agree and reuse the per-sample
colours of the render passes: the base MLP runs 4 times per chunk.

The other density modes (rgb_only, shared), the losses and the training
forward arrive with the training slice.
"""

from dataclasses import dataclass, field as dataclass_field
from typing import Dict

import torch

from nerfstudio_thermal_torch.cameras.camera_optimizers import (
    CameraOptimizerConfig,
    build_camera_optimizer,
)
from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.fields.nerfacto_field import ThermalNerfactoField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.models.nerfacto import (
    NerfactoModel,
    NerfactoModelConfig,
    _check_eval,
)


@dataclass
class ThermalNerfactoModelConfig(NerfactoModelConfig):
    density_mode: str = "separate"  # rgb_only | shared | separate
    removal_min_density_diff: float = 0.05
    fused_modalities: bool = False
    camera_optimizer_thermal: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="SO3xR3", penalty_scale=10)
    )
    shared_camera_optimizer: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="shared_SO3xR3", penalty_scale=-1)
    )
    shared_camera_optimizer_thermal: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="shared_SO3xR3", penalty_scale=-1)
    )


def _removal(density, cross_density, rgb_samples, ray_samples, diff, background_color):
    """Composite only the samples whose relative cross-spectral density
    difference is below `diff`. A zero density gives an infinite ratio
    (never kept) instead of NaN."""
    ratio = torch.where(
        density > 0,
        cross_density / torch.clamp(density, min=1e-30),
        torch.full_like(density, float("inf")),
    )
    mask = torch.abs(1.0 - ratio) < diff
    weights = ray_samples.get_weights(density * mask)
    return renderers.render_rgb(rgb_samples, weights, background_color=background_color, train=False)


class ThermalNerfactoModel(NerfactoModel):
    config: ThermalNerfactoModelConfig

    def populate_modules(self) -> None:
        cfg = self.config
        if cfg.density_mode != "separate":
            raise NotImplementedError(
                f"density_mode={cfg.density_mode!r} arrives with the training slice; "
                "this slice ports 'separate'"
            )
        if cfg.fused_modalities:
            raise NotImplementedError("fused_modalities is a training path, not ported yet")
        self._populate_common()
        self.field = ThermalNerfactoField(**self._field_kwargs(), num_channels=3)
        self.field_thermal = ThermalNerfactoField(**self._field_kwargs(), num_channels=1)
        self.proposal_networks_thermal = self._build_proposal_nets()

        # each modality's optimizers are frozen on the other modality's cameras
        is_thermal = list(self.metadata.get("is_thermal", [0] * self.num_train_data))
        thermal_idx = tuple(i for i, t in enumerate(is_thermal) if t != 0)
        rgb_idx = tuple(i for i, t in enumerate(is_thermal) if t == 0)
        n = self.num_train_data
        self.camera_optimizer = build_camera_optimizer(
            cfg.camera_optimizer, n, non_trainable_camera_indices=thermal_idx
        )
        self.camera_optimizer_thermal = build_camera_optimizer(
            cfg.camera_optimizer_thermal, n, non_trainable_camera_indices=rgb_idx
        )
        self.shared_camera_optimizer = build_camera_optimizer(
            cfg.shared_camera_optimizer, n, non_trainable_camera_indices=thermal_idx
        )
        self.shared_camera_optimizer_thermal = build_camera_optimizer(
            cfg.shared_camera_optimizer_thermal, n, non_trainable_camera_indices=rgb_idx
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        self.field_thermal.reset_parameters(generator)
        for net in self.proposal_networks_thermal:
            net.reset_parameters(generator)

    def get_outputs(self, ray_bundle: RayBundle, *, train: bool = False) -> Dict[str, torch.Tensor]:
        _check_eval(train)
        cfg = self.config

        bundle_rgb = self.shared_camera_optimizer.apply_to_raybundle(ray_bundle)
        ray_samples, weights_list, ray_samples_list = self._sample(bundle_rgb, self.proposal_networks)
        outputs, _, _ = self._get_outputs_for_field(
            self.field, ray_samples, weights_list, ray_samples_list, keep_sample_rgb=True
        )

        bundle_t = self.shared_camera_optimizer_thermal.apply_to_raybundle(ray_bundle)
        ray_samples_t, weights_list_t, ray_samples_list_t = self._sample(
            bundle_t, self.proposal_networks_thermal
        )
        thermal_outputs, _, _ = self._get_outputs_for_field(
            self.field_thermal, ray_samples_t, weights_list_t, ray_samples_list_t,
            keep_sample_rgb=True,
        )
        for k, v in thermal_outputs.items():
            outputs[f"{k}_thermal"] = v

        # cross-field densities: each field at the other field's samples
        outputs["density2"], _ = self.field.get_density_from_rays(ray_samples_t)
        outputs["density2_thermal"], _ = self.field_thermal.get_density_from_rays(ray_samples)

        diff = cfg.removal_min_density_diff
        rgb_samples = outputs.pop("rgb_samples")
        rgb_samples_t = outputs.pop("rgb_samples_thermal")
        outputs["removal"] = _removal(
            outputs["density"], outputs["density2_thermal"], rgb_samples[..., :3],
            ray_samples, diff, cfg.background_color,
        )
        # Reference quirk kept on purpose: removal_thermal composites the
        # thermal densities with the RGB hierarchy's sample deltas.
        outputs["removal_thermal"] = _removal(
            outputs["density_thermal"], outputs["density2"], rgb_samples_t[..., :1],
            ray_samples, diff, cfg.background_color,
        )
        return outputs
