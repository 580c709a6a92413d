"""Depth-nerfacto (counterpart of nerfstudio_thermal_tpu/models/depth_nerfacto.py).

Nerfacto with depth supervision: in training, a batch's `depth_image`
(the dataset's depth at each ray's pixel, in scene units) adds
depth_loss_mult times the DS-NeRF or URF depth loss on the last sampling
level's weights and samples; a z-depth is turned into a ray distance with
the bundle's `directions_norm`. Every batch with depths also reports
`depth_mae`, the mean |expected depth - depth| over pixels with a depth.
A data-parallel rank contributes the depth loss's per-ray mean times its
share of the rays and `depth_mae`'s masked sum over the global count.

As in the JAX package, the decaying sigma reads `batch.get("step", 0)`
and no sampler puts a step in the batch, so with should_decay_sigma the
sigma stays at starting_depth_sigma.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from nerfstudio_thermal_torch.model_components.losses import depth_loss
from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class DepthNerfactoModelConfig(NerfactoModelConfig):
    """Field names and defaults as in the JAX package's config."""

    depth_loss_mult: float = 1e-3
    is_euclidean_depth: bool = False
    depth_sigma: float = 0.01
    should_decay_sigma: bool = False
    starting_depth_sigma: float = 0.2
    sigma_decay_rate: float = 0.99985
    depth_loss_type: str = "ds_nerf"  # ds_nerf | urf


class DepthNerfactoModel(NerfactoModel):
    config: DepthNerfactoModelConfig

    def _sigma(self, step) -> torch.Tensor:
        """The depth loss's sigma at `step`, in f32."""
        cfg = self.config
        if not cfg.should_decay_sigma:
            return torch.tensor(cfg.depth_sigma, dtype=torch.float32)
        rate = torch.tensor(cfg.sigma_decay_rate, dtype=torch.float32)
        decayed = cfg.starting_depth_sigma * rate ** torch.as_tensor(step, dtype=torch.float32)
        return torch.clamp(decayed, min=cfg.depth_sigma)

    def get_outputs(self, ray_bundle, *, train: bool = False, **kwargs) -> Dict[str, torch.Tensor]:
        outputs = super().get_outputs(ray_bundle, train=train, **kwargs)
        norm = ray_bundle.metadata.get("directions_norm")
        outputs["directions_norm"] = torch.ones_like(outputs["expected_depth"]) if norm is None else norm
        if train:
            outputs["ray_samples_final"] = outputs["ray_samples_list"][-1]
        return outputs

    def get_loss_dict(self, outputs, batch, metrics_dict, *, train: bool = True,
                      shard: Optional[RayShard] = None, **kwargs) -> Dict[str, torch.Tensor]:
        loss_dict = super().get_loss_dict(outputs, batch, metrics_dict, train=train, shard=shard, **kwargs)
        if train and "depth_image" in batch:
            sigma = self._sigma(batch.get("step", 0)).to(outputs["expected_depth"].device)
            loss_dict["depth_loss"] = self.config.depth_loss_mult * depth_loss(
                weights=outputs["weights_list"][-1],
                ray_samples=outputs["ray_samples_final"],
                termination_depth=batch["depth_image"],
                predicted_depth=outputs["expected_depth"],
                sigma=sigma,
                directions_norm=outputs["directions_norm"],
                is_euclidean=self.config.is_euclidean_depth,
                depth_loss_type=self.config.depth_loss_type,
            ) * self._shard(shard, batch).weight
        return loss_dict

    def get_metrics_dict(
        self, outputs, batch, train: bool = True, shard: Optional[RayShard] = None
    ) -> Dict[str, torch.Tensor]:
        metrics = super().get_metrics_dict(outputs, batch, train=train, shard=shard)
        if "depth_image" in batch:
            mask = batch["depth_image"] > 0
            err = torch.abs(outputs["expected_depth"] - batch["depth_image"])
            count = self._shard(shard, batch).global_sum(mask.sum())
            metrics["depth_mae"] = torch.sum(err * mask) / torch.clamp(count, min=1)
        return metrics
