"""MipNeRF (counterpart of nerfstudio_thermal_tpu/models/mipnerf.py).

One NeRFField shared by both passes, with the integrated positional
encoding of the conical frustums' gaussians (16 position frequencies, 4
direction frequencies): 128 uniform samples, then the pdf resample of 128
without the coarse bins; the MSE of both renders. Parameters live under
fields/ directly, as in the JAX tree. The jitters are vanilla NeRF's two.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.vanilla_nerf_field import NeRFField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.scene_colliders import NearFarCollider
from nerfstudio_thermal_torch.models.vanilla_nerf import NeRFModel, VanillaModelConfig, coarse_fine
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class MipNerfModelConfig(VanillaModelConfig):
    num_coarse_samples: int = 128
    num_importance_samples: int = 128


class MipNerfModel(NeRFModel):
    config: MipNerfModelConfig

    def populate_modules(self) -> None:
        cfg = self.config
        self.field = NeRFField(
            use_integrated_encoding=True, position_num_frequencies=16, direction_num_frequencies=4,
            compute_dtype=self._compute_dtype(), use_pallas=cfg.use_pallas,
        )
        self.collider = NearFarCollider(cfg.near_plane, cfg.far_plane)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        return {"fields": list(self.field.parameters())}

    def get_outputs(
        self, ray_bundle: RayBundle, *, train: bool = False,
        uniforms: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
        generator: Optional[torch.Generator] = None, shard: Optional[RayShard] = None, **_,
    ) -> Dict[str, torch.Tensor]:
        """uniforms: {"rgb": [the uniform sampler's jitter [R, 129], the pdf
        sampler's [R, 129]]}."""
        bg = self.config.background_color
        (samples_u, w_c, out_c), (samples_pdf, w_f, out_f) = coarse_fine(
            self, self.field, self.field, ray_bundle, train, False, uniforms, generator, shard
        )
        rgb_coarse = renderers.render_rgb(out_c[FieldHeadNames.RGB], w_c, bg, train=train)
        rgb_fine = renderers.render_rgb(out_f[FieldHeadNames.RGB], w_f, bg, train=train)
        return {
            "rgb_coarse": rgb_coarse,
            "rgb_fine": rgb_fine,
            "rgb": rgb_fine,
            "accumulation": renderers.render_accumulation(w_f),
            "accumulation_coarse": renderers.render_accumulation(w_c),
            "depth": renderers.render_depth_median(w_f, samples_pdf),
            "depth_coarse": renderers.render_depth_median(w_c, samples_u),
            "expected_depth": renderers.render_depth_expected(w_f, samples_pdf),
        }
