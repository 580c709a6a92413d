"""Vanilla NeRF (counterpart of nerfstudio_thermal_tpu/models/vanilla_nerf.py).

Two frequency-encoded NeRFFields: the coarse one at 64 uniform samples
between the near and far planes, the fine one at the pdf resample of 128
more, the coarse bins included; a white background; the MSE of both
renders against the background-blended GT. `use_pallas` runs each field's
8 x 256 base stack through the fused-MLP kernels.

Training draws two jitters, the uniform sampler's and the pdf sampler's
(the JAX model splits its key into those two); `uniforms={"rgb": [u, p]}`
passes them in, as a test passes the JAX package's draws. A data-parallel
rank (`shard`) hands its samplers the shard and contributes its share of
both MSEs; the PSNRs are the global batch's.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.vanilla_nerf_field import NeRFField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.losses import mse_loss
from nerfstudio_thermal_torch.model_components.ray_samplers import pdf_sample, spaced_sample
from nerfstudio_thermal_torch.model_components.scene_colliders import NearFarCollider
from nerfstudio_thermal_torch.models.base_model import Model, ModelConfig
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class VanillaModelConfig(ModelConfig):
    """Field names and defaults as in the JAX package's config."""

    num_coarse_samples: int = 64
    num_importance_samples: int = 128
    background_color: str = "white"
    near_plane: float = 2.0
    far_plane: float = 6.0
    compute_dtype: str = "float32"
    use_pallas: bool = False


def two_draws(uniforms: Optional[Dict[str, Sequence[torch.Tensor]]]):
    """The uniform and the pdf sampler's jitter from {"rgb": [u, p]}."""
    draws = (uniforms or {}).get("rgb")
    return (None, None) if draws is None else tuple(draws)


def coarse_fine(model, field_coarse: NeRFField, field_fine: NeRFField, ray_bundle: RayBundle, train: bool,
                include_original: bool, uniforms, generator, shard: Optional[RayShard] = None):
    """The two passes: uniform samples through field_coarse, their pdf
    resample through field_fine. Returns (coarse samples, weights, field
    outputs) and the same of the fine pass."""
    cfg = model.config
    u_coarse, u_pdf = two_draws(uniforms)
    samples_u = spaced_sample(ray_bundle, cfg.num_coarse_samples, spacing_kind="uniform", train=train,
                              uniforms=u_coarse, generator=generator, shard=shard)
    out_c = field_coarse(samples_u, train=train)
    w_c = samples_u.get_weights(out_c[FieldHeadNames.DENSITY])
    samples_pdf = pdf_sample(ray_bundle, samples_u, w_c, cfg.num_importance_samples,
                             include_original=include_original, train=train, uniforms=u_pdf, generator=generator,
                             shard=shard)
    out_f = field_fine(samples_pdf, train=train)
    w_f = samples_pdf.get_weights(out_f[FieldHeadNames.DENSITY])
    return (samples_u, w_c, out_c), (samples_pdf, w_f, out_f)


class NeRFModel(Model):
    config: VanillaModelConfig

    def _compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32

    def populate_modules(self) -> None:
        cfg = self.config
        dtype = self._compute_dtype()
        # the JAX param tree's fields/{coarse, fine}
        self.field = nn.ModuleDict({
            "coarse": NeRFField(compute_dtype=dtype, use_pallas=cfg.use_pallas),
            "fine": NeRFField(compute_dtype=dtype, use_pallas=cfg.use_pallas),
        })
        self.collider = NearFarCollider(cfg.near_plane, cfg.far_plane)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for f in self.field.values():
            f.reset_parameters(generator)

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        return {"fields": list(self.field.parameters())}

    def get_outputs(
        self, ray_bundle: RayBundle, *, train: bool = False,
        uniforms: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
        generator: Optional[torch.Generator] = None, shard: Optional[RayShard] = None, **_,
    ) -> Dict[str, torch.Tensor]:
        """uniforms: {"rgb": [the uniform sampler's jitter [R, 65], the pdf
        sampler's [R, 129]]}."""
        bg = self.config.background_color
        (samples_u, w_c, out_c), (samples_pdf, w_f, out_f) = coarse_fine(
            self, self.field["coarse"], self.field["fine"], ray_bundle, train, True, uniforms, generator, shard
        )
        rgb_coarse = renderers.render_rgb(out_c[FieldHeadNames.RGB], w_c, bg, train=train)
        rgb_fine = renderers.render_rgb(out_f[FieldHeadNames.RGB], w_f, bg, train=train)
        acc_c, acc_f = renderers.render_accumulation(w_c), renderers.render_accumulation(w_f)
        depth_c = renderers.render_depth_median(w_c, samples_u)
        depth_f = renderers.render_depth_median(w_f, samples_pdf)
        return {
            "rgb_coarse": rgb_coarse,
            "rgb_fine": rgb_fine,
            "rgb": rgb_fine,
            "accumulation_coarse": acc_c,
            "accumulation_fine": acc_f,
            "accumulation": acc_f,
            "depth_coarse": depth_c,
            "depth_fine": depth_f,
            "depth": depth_f,
            "expected_depth": renderers.render_depth_expected(w_f, samples_pdf),
        }

    def get_metrics_dict(
        self, outputs, batch, train: bool = True, shard: Optional[RayShard] = None
    ) -> Dict[str, torch.Tensor]:
        shard = self._shard(shard, batch)
        gt = renderers.blend_background_rgb(batch["image"])
        return {"psnr": shard.psnr(outputs["rgb_fine"], gt), "psnr_coarse": shard.psnr(outputs["rgb_coarse"], gt)}

    def get_loss_dict(self, outputs, batch, metrics_dict, *, train: bool = True,
                      shard: Optional[RayShard] = None, **_) -> Dict[str, torch.Tensor]:
        weight = self._shard(shard, batch).weight
        gt = renderers.blend_background_rgb(batch["image"])
        return {
            "rgb_loss_coarse": mse_loss(outputs["rgb_coarse"], gt) * weight,
            "rgb_loss_fine": mse_loss(outputs["rgb_fine"], gt) * weight,
        }
