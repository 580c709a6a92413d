"""Dynamic ray-batch sizing for occupancy-grid models (counterpart of
nerfstudio_thermal_tpu/pipelines/dynamic_batch.py).

The ray batch is scaled so that the live (unmasked) samples per step stay
near `target_num_samples`: empty space skipped by the occupancy grid makes
rays cheap, so the batch grows. As in the JAX package the size is
quantised to powers of two between the min and max rays (Python's `round`
of the log2, so 2.5 rounds to 2), and it is adjusted only every
`update_every` steps, the only steps on which the model's live-sample
scalar (`num_samples_per_ray`) is read on the host.
"""

from dataclasses import dataclass
from math import log2

import numpy as np

from nerfstudio_thermal_torch.pipelines.base_pipeline import VanillaPipeline


@dataclass
class DynamicBatchPipelineConfig:
    target_num_samples: int = 1 << 18
    """Target volumetric samples per train step."""
    max_num_rays_per_batch: int = 1 << 14
    min_num_rays_per_batch: int = 1 << 10
    update_every: int = 16
    """Steps between batch-size adjustments."""


def next_batch_size(config: DynamicBatchPipelineConfig, samples_per_ray: float):
    """The power-of-two ray count for a live-sample mean, or None where the
    mean is not finite and positive (the batch stays as it is)."""
    if not np.isfinite(samples_per_ray) or samples_per_ray <= 0:
        return None
    desired = config.target_num_samples / samples_per_ray
    desired = min(max(desired, config.min_num_rays_per_batch), config.max_num_rays_per_batch)
    bucket = 1 << round(log2(desired))
    return int(min(max(bucket, config.min_num_rays_per_batch), config.max_num_rays_per_batch))


class DynamicBatchPipeline(VanillaPipeline):
    def __init__(self, datamanager, model, config: DynamicBatchPipelineConfig = None):
        super().__init__(datamanager, model)
        self.dynamic_config = config or DynamicBatchPipelineConfig()

    def after_train_iteration(self, scalars, step: int) -> None:
        cfg = self.dynamic_config
        if step % cfg.update_every != 0:
            return
        spr = scalars.get("num_samples_per_ray")
        if spr is None:
            return
        bucket = next_batch_size(cfg, float(spr))
        if bucket is not None:
            self.datamanager.num_rays_override = bucket
