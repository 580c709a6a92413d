"""Base surface model: SDF field, background field and surface rendering
(counterpart of nerfstudio_thermal_tpu/models/base_surface_model.py).

The SDF field (fields/sdf_field.py) behind an AABB collider (near plane
0.05; a near-far collider with `overwrite_near_far_plane`); a subclass
samples the rays and evaluates the field (`sample_and_forward_field`: the
samples, the field's outputs, the weights from NeuS's alphas and the
transmittance left behind the last sample). An optional background
NeRFField ("mlp": 10 position and 4 direction frequencies, the eager path
as in JAX) is sampled in linear disparity from each ray's far bound out
to `far_plane_bg` and composited as rgb + bg_transmittance * rgb_bg. The
outputs add the composited normal (unnormalised) and `normal_vis`; the
training metrics `s_val` (exp(10 variance)); the losses are the L1 colour
loss, the eikonal loss on the SDF gradients, the foreground-mask BCE of
the weight sums (with an `fg_mask` batch) and the monocular normal and
depth priors (with `normal` and `depth` / `depth_image` batches and their
multipliers above 0). A data-parallel rank (`shard`) contributes its
share of each per-ray mean and s_val once; the depth prior, which fits
one scale and shift over the global batch, is computed on the gathered
global batch (parallel/mesh.py `gather`, `whole`).

Training draws its jitter from `uniforms` when given: {"rgb": the
sampler's draws, "background": [the background sampler's, [R, S_bg +
1]]}, so a test can pass the JAX package's; else from `generator`.
"""

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.camera_optimizers import CameraOptimizerConfig
from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.sdf_field import SDFField
from nerfstudio_thermal_torch.fields.vanilla_nerf_field import NeRFField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.losses import (
    l1_loss,
    monosdf_normal_loss,
    scale_and_shift_invariant_depth_loss,
)
from nerfstudio_thermal_torch.model_components.ray_samplers import spaced_sample
from nerfstudio_thermal_torch.model_components.scene_colliders import AABBBoxCollider, NearFarCollider
from nerfstudio_thermal_torch.models.base_model import Model, ModelConfig
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class SurfaceModelConfig(ModelConfig):
    """Field names and defaults as in the JAX package's config."""

    near_plane: float = 0.05
    far_plane: float = 4.0
    far_plane_bg: float = 1000.0
    background_color: str = "black"
    use_average_appearance_embedding: bool = False
    eikonal_loss_mult: float = 0.1
    fg_mask_loss_mult: float = 0.01
    mono_normal_loss_mult: float = 0.0
    mono_depth_loss_mult: float = 0.0
    background_model: str = "mlp"  # mlp | none
    num_samples_outside: int = 32
    overwrite_near_far_plane: bool = False
    compute_dtype: str = "float32"
    sdf_num_layers: int = 8
    sdf_hidden_dim: int = 256
    sdf_geo_feat_dim: int = 256
    sdf_num_layers_color: int = 4
    sdf_hidden_dim_color: int = 256
    sdf_bias: float = 0.8
    sdf_beta_init: float = 0.1
    sdf_use_grid_feature: bool = False
    sdf_inside_outside: bool = True
    use_appearance_embedding: bool = False
    appearance_embed_dim: int = 32
    camera_optimizer: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="off")
    )


class SurfaceModel(Model):
    """Subclasses implement `sample_and_forward_field`."""

    config: SurfaceModelConfig

    def populate_modules(self) -> None:
        cfg = self.config
        self.field = SDFField(
            aabb=self.scene_aabb,
            num_images=self.num_train_data,
            num_layers=cfg.sdf_num_layers,
            hidden_dim=cfg.sdf_hidden_dim,
            geo_feat_dim=cfg.sdf_geo_feat_dim,
            num_layers_color=cfg.sdf_num_layers_color,
            hidden_dim_color=cfg.sdf_hidden_dim_color,
            bias=cfg.sdf_bias,
            beta_init=cfg.sdf_beta_init,
            use_grid_feature=cfg.sdf_use_grid_feature,
            inside_outside=cfg.sdf_inside_outside,
            use_appearance_embedding=cfg.use_appearance_embedding,
            use_average_appearance_embedding=cfg.use_average_appearance_embedding,
            appearance_embedding_dim=cfg.appearance_embed_dim,
        )
        if cfg.overwrite_near_far_plane:
            self.collider = NearFarCollider(cfg.near_plane, cfg.far_plane)
        else:
            self.collider = AABBBoxCollider(self.scene_aabb, near_plane=0.05)
        self.field_background = (
            NeRFField(position_num_frequencies=10, direction_num_frequencies=4)
            if cfg.background_model == "mlp" else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)
        if self.field_background is not None:
            self.field_background.reset_parameters(generator)

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        """The JAX package's param groups: fields, field_background and
        (neus-facto) proposal_networks."""
        groups = {}
        for name, attr in (("fields", "field"), ("field_background", "field_background"),
                           ("proposal_networks", "proposal_networks")):
            module = getattr(self, attr, None)
            if module is not None:
                groups[name] = list(module.parameters())
        return groups

    def sample_and_forward_field(self, ray_bundle: RayBundle, *, train: bool, uniforms, generator,
                                 cos_anneal_ratio: float, anneal: float = 1.0,
                                 shard: Optional[RayShard] = None) -> Dict:
        raise NotImplementedError

    def sdf_fn(self, positions: torch.Tensor) -> torch.Tensor:
        """World positions [..., 3] -> the SDF [...] (marching-cubes export)."""
        return self.field.get_sdf_at(positions)[..., 0]

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        *,
        train: bool = False,
        uniforms: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
        generator: Optional[torch.Generator] = None,
        cos_anneal_ratio: float = 1.0,
        anneal: float = 1.0,
        shard: Optional[RayShard] = None,
        **_,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        uniforms = uniforms or {}
        s = self.sample_and_forward_field(
            ray_bundle, train=train, uniforms=uniforms.get("rgb"), generator=generator,
            cos_anneal_ratio=cos_anneal_ratio, anneal=anneal, shard=shard,
        )
        field_outputs, ray_samples, weights = s["field_outputs"], s["ray_samples"], s["weights"]
        rgb = renderers.render_rgb(field_outputs[FieldHeadNames.RGB], weights, background_color="black", train=train)
        normal = renderers.render_normals(field_outputs[FieldHeadNames.NORMALS], weights, normalize=False)
        outputs = {
            "rgb": rgb,
            "accumulation": renderers.render_accumulation(weights),
            "depth": renderers.render_depth_expected(weights, ray_samples),
            "normal": normal,
            "normal_vis": (normal + 1.0) / 2.0,
        }
        if self.field_background is not None:
            bg_bundle = ray_bundle.replace(nears=ray_bundle.fars, fars=torch.ones_like(ray_bundle.fars) * cfg.far_plane_bg)
            bg_samples = spaced_sample(
                bg_bundle, cfg.num_samples_outside, spacing_kind="lindisp", train_stratified=True,
                single_jitter=False, train=train, uniforms=uniforms.get("background", [None])[0],
                generator=generator, shard=shard,
            )
            bg_out = self.field_background(bg_samples, train=train)
            w_bg = bg_samples.get_weights(bg_out[FieldHeadNames.DENSITY])
            rgb_bg = renderers.render_rgb(bg_out[FieldHeadNames.RGB], w_bg, background_color=cfg.background_color,
                                          train=train)
            outputs["bg_rgb"] = rgb_bg
            outputs["bg_accumulation"] = renderers.render_accumulation(w_bg)
            outputs["bg_depth"] = renderers.render_depth_expected(w_bg, bg_samples)
            outputs["rgb"] = rgb + s["bg_transmittance"] * rgb_bg
        if train:
            outputs["eik_grad"] = field_outputs[FieldHeadNames.GRADIENT]
            outputs["weights"] = weights
            if "weights_list" in s:
                outputs["weights_list"] = s["weights_list"]
                outputs["ray_samples_list"] = s["ray_samples_list"]
        elif "weights_list" in s:
            for i in range(len(s["weights_list"]) - 1):
                outputs[f"prop_depth_{i}"] = renderers.render_depth_median(
                    s["weights_list"][i], s["ray_samples_list"][i]
                )
        return outputs

    def get_metrics_dict(self, outputs, batch, train: bool = True,
                         shard: Optional[RayShard] = None) -> Dict[str, torch.Tensor]:
        shard = self._shard(shard, batch)
        metrics = {"psnr": shard.psnr(outputs["rgb"], renderers.blend_background_rgb(batch["image"]))}
        if train:
            metrics["s_val"] = shard.once(torch.exp(self.field.variance.detach() * 10.0))
        return metrics

    def get_loss_dict(
        self, outputs, batch, metrics_dict, *, train: bool = True,
        background_uniforms: Optional[torch.Tensor] = None, shard: Optional[RayShard] = None, **_,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        shard = self._shard(shard, batch)
        weight = shard.weight
        pred, gt = renderers.blend_background_for_loss_rgb(
            outputs["rgb"], outputs["accumulation"], batch["image"],
            background_color=cfg.background_color, uniforms=background_uniforms,
        )
        loss_dict = {"rgb_loss": l1_loss(gt, pred) * weight}
        if not train:
            return loss_dict
        grad = outputs["eik_grad"]
        # a fixed number of samples a ray: a per-ray mean
        loss_dict["eikonal_loss"] = (
            torch.mean((torch.linalg.vector_norm(grad, dim=-1) - 1.0) ** 2) * cfg.eikonal_loss_mult
        ) * weight
        if "fg_mask" in batch and cfg.fg_mask_loss_mult > 0:
            fg = batch["fg_mask"].float()
            w_sum = torch.clamp(torch.sum(outputs["weights"], dim=-2)[..., 0], 1e-3, 1 - 1e-3)
            bce = -(fg * torch.log(w_sum) + (1 - fg) * torch.log(1 - w_sum))
            loss_dict["fg_mask_loss"] = torch.mean(bce) * cfg.fg_mask_loss_mult * weight
        if "normal" in batch and cfg.mono_normal_loss_mult > 0:
            loss_dict["normal_loss"] = cfg.mono_normal_loss_mult * monosdf_normal_loss(
                outputs["normal"], batch["normal"]
            ) * weight
        depth_key = "depth" if "depth" in batch else ("depth_image" if "depth_image" in batch else None)
        if depth_key is not None and cfg.mono_depth_loss_mult > 0:
            # one scale and shift over the first `rows` rays of the global
            # batch, gradient terms between rays rows / 32 apart: no sum over
            # rays, so every rank computes it on the gathered global batch
            depth_gt = shard.gather(batch[depth_key].reshape(-1)) * 50 + 0.5
            depth_pred = shard.gather(outputs["depth"].reshape(-1))
            rows = max(depth_pred.shape[0] // 32, 1) * 32
            mask = torch.ones((1, 32, rows // 32), dtype=torch.bool, device=depth_pred.device)
            loss_dict["depth_loss"] = shard.whole(cfg.mono_depth_loss_mult * scale_and_shift_invariant_depth_loss(
                depth_pred[:rows].reshape(1, 32, -1), depth_gt[:rows].reshape(1, 32, -1), mask, alpha=0.5, scales=1,
            ))
        return loss_dict
