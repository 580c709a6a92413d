"""Instant-NGP (counterpart of nerfstudio_thermal_tpu/models/instant_ngp.py).

A hash-grid NerfactoField evaluated at `num_samples_per_ray` uniform
samples between the AABB collider's bounds, with occupancy-grid empty-space
skipping by masking: in training the grid (the trainer's `extra`, updated
before the forward every `grid_update_every` steps, step 0 included)
zeroes the densities of samples in cells at or below `alpha_thre`, and the
model reports the mean count of live samples per ray
(`num_samples_per_ray`), which the dynamic-batch pipeline reads. Renders
get no grid: every sample is evaluated. The loss is the RGB MSE against
the background-blended GT (`random` by default: the background is drawn
per step, as the thermal model's). A data-parallel rank draws the same
grid points as every other rank (so the grids stay equal), contributes
its share of the rays' MSE and live-sample mean, and hands its sampler
the shard.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.losses import mse_loss
from nerfstudio_thermal_torch.model_components.occupancy_grid import (
    OccupancyGridState,
    create_occupancy_grid,
    occupancy_mask,
    update_occupancy_grid,
)
from nerfstudio_thermal_torch.model_components.ray_samplers import spaced_sample
from nerfstudio_thermal_torch.model_components.scene_colliders import AABBBoxCollider
from nerfstudio_thermal_torch.models.base_model import Model, ModelConfig
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class InstantNGPModelConfig(ModelConfig):
    """Field names and defaults as in the JAX package's config."""

    num_samples_per_ray: int = 192
    grid_resolution: int = 128
    grid_update_every: int = 16
    alpha_thre: float = 1e-2
    background_color: str = "random"
    near_plane: float = 0.05
    far_plane: float = 1000.0
    num_levels: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    compute_dtype: str = "float32"
    use_pallas: bool = False
    disable_scene_contraction: bool = False
    appearance_embed_dim: int = 32


class InstantNGPModel(Model):
    config: InstantNGPModelConfig

    def populate_modules(self) -> None:
        cfg = self.config
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.field = NerfactoField(
            aabb=self.scene_aabb,
            num_images=self.num_train_data,
            num_levels=cfg.num_levels,
            max_res=cfg.max_res,
            log2_hashmap_size=cfg.log2_hashmap_size,
            use_spatial_distortion=not cfg.disable_scene_contraction,
            appearance_embedding_dim=cfg.appearance_embed_dim,
            compute_dtype=self.compute_dtype,
            use_pallas=cfg.use_pallas,
        )
        self.collider = AABBBoxCollider(self.scene_aabb, near_plane=cfg.near_plane)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        return {"fields": list(self.field.parameters())}

    # the trainer's extra-state hooks -------------------------------------

    def init_extra_state(self) -> OccupancyGridState:
        return create_occupancy_grid(self.config.grid_resolution, self.scene_aabb.tolist(), device=self.device)

    def update_extra_state(self, extra: OccupancyGridState, step: int, generator=None, draws=None):
        """The grid update on every grid_update_every-th step (step 0
        included), from the parameters as they are before this step's
        update; `draws` = (idx, jitter) replaces the generator's draws."""
        if step % self.config.grid_update_every != 0:
            return extra
        return self.update_grid(extra, generator, *(draws or (None, None)))

    def extra_forward_kwargs(self, extra) -> Dict[str, OccupancyGridState]:
        return {"occupancy_grid": extra}

    @torch.no_grad()
    def update_grid(self, grid: OccupancyGridState, generator=None, idx=None, jitter=None) -> OccupancyGridState:
        return update_occupancy_grid(grid, self.field.density_fn, generator, idx=idx, jitter=jitter)

    # forward, metrics, losses ------------------------------------------

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        *,
        train: bool = False,
        uniforms: Optional[Dict[str, List[torch.Tensor]]] = None,
        generator: Optional[torch.Generator] = None,
        occupancy_grid: Optional[OccupancyGridState] = None,
        shard: Optional[RayShard] = None,
        **_,
    ) -> Dict[str, torch.Tensor]:
        """uniforms: {"rgb": [the sampler's jitter, [R, S + 1]]}."""
        cfg = self.config
        samples = spaced_sample(
            ray_bundle, cfg.num_samples_per_ray, spacing_kind="uniform", train=train,
            uniforms=(uniforms or {}).get("rgb", [None])[0], generator=generator, shard=shard,
        )
        field_out = self.field(samples, train=train)
        density = field_out[FieldHeadNames.DENSITY]
        live_samples_per_ray = None
        if occupancy_grid is not None:
            mask = occupancy_mask(occupancy_grid, samples.get_positions(), cfg.alpha_thre)
            density = density * mask
            live_samples_per_ray = torch.mean(torch.sum(mask[..., 0], dim=-1))
            if shard is not None:
                live_samples_per_ray = live_samples_per_ray * shard.weight
        weights = samples.get_weights(density)
        out = {
            "rgb": renderers.render_rgb(field_out[FieldHeadNames.RGB], weights, cfg.background_color, train=train),
            "accumulation": renderers.render_accumulation(weights),
            "depth": renderers.render_depth_median(weights, samples),
            "expected_depth": renderers.render_depth_expected(weights, samples),
        }
        if train and live_samples_per_ray is not None:
            out["num_samples_per_ray"] = live_samples_per_ray
        return out

    def get_metrics_dict(
        self, outputs, batch, train: bool = True, shard: Optional[RayShard] = None
    ) -> Dict[str, torch.Tensor]:
        gt = renderers.blend_background_rgb(batch["image"])
        metrics = {"psnr": self._shard(shard, batch).psnr(outputs["rgb"], gt)}
        if "num_samples_per_ray" in outputs:
            metrics["num_samples_per_ray"] = outputs["num_samples_per_ray"]
        return metrics

    def get_loss_dict(
        self, outputs, batch, metrics_dict, *, train: bool = True,
        background_uniforms: Optional[torch.Tensor] = None, shard: Optional[RayShard] = None, **_,
    ) -> Dict[str, torch.Tensor]:
        pred, gt = renderers.blend_background_for_loss_rgb(
            outputs["rgb"], outputs["accumulation"], batch["image"],
            background_color=self.config.background_color, uniforms=background_uniforms,
        )
        return {"rgb_loss": mse_loss(gt, pred) * self._shard(shard, batch).weight}
