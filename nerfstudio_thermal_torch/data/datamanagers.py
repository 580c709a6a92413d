"""Data manager (counterpart of nerfstudio_thermal_tpu/data/datamanagers.py).

`VanillaDataManager` owns the train and eval datasets and the train pixel
sampler, and gives one host batch per step (the eval batches come with the
eval surface). Ray generation happens in the
train step, on the device. The C++ batch sampler and the prefetching
manager of the JAX package are later work: `use_native_sampler` is off
here and raises if set.
"""

from dataclasses import dataclass
from typing import Dict

import numpy as np

from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import DataParser
from nerfstudio_thermal_torch.data.datasets import InputDataset
from nerfstudio_thermal_torch.data.pixel_samplers import PixelSampler, PixelSamplerConfig


@dataclass
class VanillaDataManagerConfig:
    train_num_rays_per_batch: int = 4096
    eval_num_rays_per_batch: int = 4096
    patch_size: int = 1
    camera_res_scale_factor: float = 1.0
    seed: int = 0
    use_native_sampler: bool = False
    """The JAX package's C++ batch sampler; not ported yet."""


class VanillaDataManager:
    def __init__(self, config: VanillaDataManagerConfig, dataparser: DataParser, test_split: str = "val"):
        if config.use_native_sampler:
            raise NotImplementedError("the native batch sampler is not ported yet")
        self.config = config
        self.dataparser = dataparser
        self.train_dataparser_outputs = dataparser.get_dataparser_outputs(split="train")
        self.eval_dataparser_outputs = dataparser.get_dataparser_outputs(split=test_split)
        self.train_dataset = InputDataset(self.train_dataparser_outputs, config.camera_res_scale_factor)
        self.eval_dataset = InputDataset(self.eval_dataparser_outputs, config.camera_res_scale_factor)
        self.train_pixel_sampler = PixelSampler(
            PixelSamplerConfig(config.train_num_rays_per_batch, config.patch_size),
            self.train_dataset, seed=config.seed,
        )

    @property
    def train_cameras(self):
        return self.train_dataset.cameras

    def next_train(self, step: int) -> Dict[str, np.ndarray]:
        return self.train_pixel_sampler.sample(self.config.train_num_rays_per_batch, step=step)
