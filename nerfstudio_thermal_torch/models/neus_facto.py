"""NeuS-facto: NeuS surface rendering on nerfacto's proposal sampling
(counterpart of nerfstudio_thermal_tpu/models/neus_facto.py).

Two hash-grid proposal density fields (`HashMLPDensityField`, 5 levels,
T 2^17, contracted) give the (256, 96) proposal samples through
`proposal_sample` with `updated=True` on every step (the proposals always
get gradients); the SDF field then gives NeuS's alphas on the final 48
samples. The interlevel loss joins the surface losses; the cos anneal is
NeuS's. Jitter: {"rgb": one draw per sampling level}.
"""

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RayBundle, get_weights_and_transmittance_from_alphas
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_thermal_torch.model_components.losses import interlevel_loss
from nerfstudio_thermal_torch.model_components.ray_samplers import proposal_sample
from nerfstudio_thermal_torch.models.neus import NeuSModel, NeuSModelConfig
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class NeuSFactoModelConfig(NeuSModelConfig):
    """Field names and defaults as in the JAX package's config."""

    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_neus_samples_per_ray: int = 48
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: List[Dict] = dataclass_field(
        default_factory=lambda: [
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 64},
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256},
        ]
    )
    interlevel_loss_mult: float = 1.0
    use_proposal_weight_anneal: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True


class NeuSFactoModel(NeuSModel):
    config: NeuSFactoModelConfig

    def populate_modules(self) -> None:
        super().populate_modules()
        cfg = self.config
        n_unique = 1 if cfg.use_same_proposal_network else cfg.num_proposal_iterations
        nets = []
        for i in range(n_unique):
            args = dict(cfg.proposal_net_args_list[min(i, len(cfg.proposal_net_args_list) - 1)])
            args.pop("use_linear", None)
            nets.append(HashMLPDensityField(aabb=self.scene_aabb, use_spatial_distortion=True, **args))
        self.proposal_networks = nn.ModuleList(nets)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        for net in self.proposal_networks:
            net.reset_parameters(generator)

    def _density_fns(self):
        nets = self.proposal_networks
        picked = [nets[min(i, len(nets) - 1)] for i in range(self.config.num_proposal_iterations)]
        return [lambda samples, net=net: net(ray_samples=samples) for net in picked]

    def sample_and_forward_field(self, ray_bundle: RayBundle, *, train: bool, uniforms, generator,
                                 cos_anneal_ratio: float, anneal: float = 1.0,
                                 shard: Optional[RayShard] = None) -> Dict:
        cfg = self.config
        ray_samples, weights_list, ray_samples_list = proposal_sample(
            ray_bundle,
            self._density_fns(),
            num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
            num_nerf_samples_per_ray=cfg.num_neus_samples_per_ray,
            initial_spacing_kind="uniform",
            single_jitter=cfg.use_single_jitter,
            anneal=anneal,
            updated=True,
            train=train,
            uniforms=uniforms,
            generator=generator,
            shard=shard,
        )
        field_outputs = self.field(ray_samples, train=train, return_alphas=True, cos_anneal_ratio=cos_anneal_ratio)
        weights, transmittance = get_weights_and_transmittance_from_alphas(field_outputs[FieldHeadNames.ALPHA])
        return {
            "ray_samples": ray_samples,
            "field_outputs": field_outputs,
            "weights": weights,
            "bg_transmittance": transmittance[:, -1, :],
            "weights_list": weights_list + [weights],
            "ray_samples_list": ray_samples_list + [ray_samples],
        }

    def get_loss_dict(self, outputs, batch, metrics_dict, *, train: bool = True,
                      shard: Optional[RayShard] = None, **kwargs) -> Dict[str, torch.Tensor]:
        loss_dict = super().get_loss_dict(outputs, batch, metrics_dict, train=train, shard=shard, **kwargs)
        if train:
            loss_dict["interlevel_loss"] = self.config.interlevel_loss_mult * interlevel_loss(
                outputs["weights_list"], outputs["ray_samples_list"]
            ) * self._shard(shard, batch).weight
        return loss_dict
