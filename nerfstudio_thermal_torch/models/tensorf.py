"""TensoRF (counterpart of nerfstudio_thermal_tpu/models/tensorf.py).

The VM-decomposed TensoRFField between the AABB collider's bounds: 200
uniform samples through its density alone, then the pdf resample of 50
(the uniform bins included) through the whole field; the RGB MSE against
the background-blended GT plus, in training, the L1 of the density planes
and lines times l1_reg_mult.

The grids grow during training on the host, as in the JAX package: after
each step of `upsampling_iters` (the trainer's `_maybe_refine` asks
`wants_host_refinement`), `refine_host` resamples every plane and line
linearly along each grid axis to the next resolution of a log schedule
from `resolution` to `final_resolution` (numpy, float64, then f32),
swaps the new grids into the field and the optimizer, with zero Adam
moments for them and the group's step count kept, and rebuilds the field
at the new resolution. Jitters as vanilla NeRF's: {"rgb": [u, p]}. A
data-parallel rank contributes its share of the MSE and the L1, which
reads the parameters only, once; every rank upsamples alike.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.tensorf_field import GRID_KEYS, TensoRFField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.losses import mse_loss
from nerfstudio_thermal_torch.model_components.ray_samplers import pdf_sample, spaced_sample
from nerfstudio_thermal_torch.model_components.scene_colliders import AABBBoxCollider
from nerfstudio_thermal_torch.models.base_model import Model, ModelConfig
from nerfstudio_thermal_torch.models.vanilla_nerf import two_draws
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class TensoRFModelConfig(ModelConfig):
    """Field names and defaults as in the JAX package's config."""

    num_uniform_samples: int = 200
    num_samples: int = 50
    resolution: int = 128
    """Initial VM grid resolution."""
    final_resolution: int = 300
    upsampling_iters: Tuple[int, ...] = (2000, 3000, 4000, 5500, 7000)
    """Steps after which the grids are resampled toward final_resolution on
    a log schedule, on the host (refine_host)."""
    density_components: int = 16
    color_components: int = 48
    appearance_dim: int = 27
    l1_reg_mult: float = 5e-4
    background_color: str = "white"
    near_plane: float = 2.0
    far_plane: float = 6.0
    compute_dtype: str = "float32"
    use_pallas: bool = False


def lin1d(x: np.ndarray, axis: int, r_old: int, new_r: int) -> np.ndarray:
    """Linear resample of `x` along `axis` from r_old to new_r samples, in
    float64 (the JAX package's numpy arithmetic)."""
    xi = np.linspace(0, r_old - 1, new_r)
    i0 = np.floor(xi).astype(int)
    i1 = np.minimum(i0 + 1, r_old - 1)
    f = xi - i0
    a = np.take(x, i0, axis=axis)
    b = np.take(x, i1, axis=axis)
    shape = [1] * x.ndim
    shape[axis] = new_r
    f = f.reshape(shape)
    return a * (1 - f) + b * f


def resize_grid(x: np.ndarray, new_r: int) -> np.ndarray:
    """A plane [3, r, r, C] along both grid axes, a line [3, r, C] along
    its one, to new_r; f32."""
    r = x.shape[1]
    if x.ndim == 4:
        return lin1d(lin1d(x, 1, r, new_r), 2, r, new_r).astype(np.float32)
    return lin1d(x, 1, r, new_r).astype(np.float32)


class TensoRFModel(Model):
    config: TensoRFModelConfig

    def populate_modules(self) -> None:
        cfg = self.config
        self.field = TensoRFField(
            aabb=self.scene_aabb,
            resolution=cfg.resolution,
            density_components=cfg.density_components,
            color_components=cfg.color_components,
            appearance_dim=cfg.appearance_dim,
            compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
        )
        self.collider = AABBBoxCollider(self.scene_aabb, near_plane=cfg.near_plane)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        return {"fields": list(self.field.parameters())}

    # the grid upsampling, on the host ----------------------------------

    def resolution_schedule(self) -> Dict[int, int]:
        """{step: resolution after it}: log-spaced from resolution to
        final_resolution, rounded, the first left out."""
        cfg = self.config
        n = len(cfg.upsampling_iters)
        res = np.rint(
            np.exp(np.linspace(np.log(cfg.resolution), np.log(cfg.final_resolution), n + 1))
        ).astype(np.int64)[1:]
        return {int(s): int(r) for s, r in zip(cfg.upsampling_iters, res)}

    def wants_host_refinement(self, step: int) -> bool:
        return step in self.resolution_schedule()

    @torch.no_grad()
    def refine_host(self, optimizers, step: int) -> None:
        """Resample every grid to the schedule's resolution of `step`, hand
        the new parameters to `optimizers` (their moments start at zero,
        the step count stays) and rebuild the field at that resolution."""
        new_r = self.resolution_schedule()[step]
        swapped = {}
        for name in GRID_KEYS:
            old = getattr(self.field, name)
            grid = resize_grid(old.detach().cpu().numpy(), new_r)
            swapped[old] = self.field.set_grid(name, torch.from_numpy(grid))
        optimizers.replace_params(swapped)
        self.field.resolution = new_r
        print(f"tensorf: upsampled VM grids to {new_r}^2 at step {step}")

    # forward, metrics, losses ------------------------------------------

    def get_outputs(
        self, ray_bundle: RayBundle, *, train: bool = False,
        uniforms: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
        generator: Optional[torch.Generator] = None, shard: Optional[RayShard] = None, **_,
    ) -> Dict[str, torch.Tensor]:
        """uniforms: {"rgb": [the uniform sampler's jitter [R, 201], the pdf
        sampler's [R, 51]]}."""
        cfg = self.config
        u_coarse, u_pdf = two_draws(uniforms)
        coarse = spaced_sample(ray_bundle, cfg.num_uniform_samples, spacing_kind="uniform", train=train,
                               uniforms=u_coarse, generator=generator, shard=shard)
        w_c = coarse.get_weights(self.field.density_fn(coarse.get_positions()))
        fine = pdf_sample(ray_bundle, coarse, w_c, cfg.num_samples, include_original=True, train=train,
                          uniforms=u_pdf, generator=generator, shard=shard)
        out = self.field(fine, train=train)
        w = fine.get_weights(out[FieldHeadNames.DENSITY])
        return {
            "rgb": renderers.render_rgb(out[FieldHeadNames.RGB], w, cfg.background_color, train=train),
            "accumulation": renderers.render_accumulation(w),
            "depth": renderers.render_depth_median(w, fine),
            "expected_depth": renderers.render_depth_expected(w, fine),
        }

    def get_metrics_dict(
        self, outputs, batch, train: bool = True, shard: Optional[RayShard] = None
    ) -> Dict[str, torch.Tensor]:
        return {"psnr": self._shard(shard, batch).psnr(outputs["rgb"], renderers.blend_background_rgb(batch["image"]))}

    def get_loss_dict(self, outputs, batch, metrics_dict, *, train: bool = True,
                      shard: Optional[RayShard] = None, **_) -> Dict[str, torch.Tensor]:
        shard = self._shard(shard, batch)
        loss_dict = {
            "rgb_loss": mse_loss(outputs["rgb"], renderers.blend_background_rgb(batch["image"])) * shard.weight
        }
        if train and self.config.l1_reg_mult > 0:
            f = self.field
            l1 = torch.mean(torch.abs(f.density_planes)) + torch.mean(torch.abs(f.density_lines))
            loss_dict["l1_reg"] = shard.once(self.config.l1_reg_mult * l1)
        return loss_dict
