"""Data manager (counterpart of nerfstudio_thermal_tpu/data/datamanagers.py).

`VanillaDataManager` owns the train and eval datasets and their pixel
samplers (the eval one seeded with seed + 1), and gives one host batch per
training step, eval ray batches, and whole eval images in turn. Ray
generation happens in the train step, on the device. As
in the JAX package, `use_native_sampler` (on by default) samples through
the C++ batch sampler (data/native_sampler.py) when the dataset qualifies
and the library builds, and through the Python PixelSampler otherwise. The
prefetching manager of the JAX package is later work.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
    use_native_sampler: bool = True
    """Use the C++ batch sampler (native/batch_sampler.cpp) for the per-step
    host hot path when it builds and the dataset has no extra per-pixel
    channels (depth/semantics); falls back to the Python sampler otherwise."""


class VanillaDataManager:
    def __init__(self, config: VanillaDataManagerConfig, dataparser: DataParser, test_split: str = "val"):
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
        self.eval_pixel_sampler = PixelSampler(
            PixelSamplerConfig(config.eval_num_rays_per_batch, config.patch_size),
            self.eval_dataset, seed=config.seed + 1,
        )
        self._eval_image_index = 0
        self.num_rays_override: Optional[int] = None
        """Rays of the next training batches when set (the dynamic-batch
        pipeline sets it); the config's train_num_rays_per_batch otherwise."""
        self._native = self._try_native_sampler() if config.use_native_sampler else None

    def _try_native_sampler(self):
        """The C++ sampler when the dataset qualifies (no per-pixel sidecar
        channels, one channel count) and the library builds, else None."""
        md = self.train_dataset.metadata
        if (md.get("depth_filenames") or md.get("normal_filenames")
                or (md.get("semantics") and md["semantics"].get("filenames"))):
            return None
        try:
            from nerfstudio_thermal_torch.data.native_sampler import NativeBatchSampler, native_available

            if not native_available():
                return None
            images = [self.train_dataset.get_image(i) for i in range(len(self.train_dataset))]
            if len({im.shape[-1] for im in images}) != 1:
                return None
            return NativeBatchSampler(
                images, self.train_dataset.is_thermal, patch_size=self.config.patch_size, seed=self.config.seed
            )
        except Exception:
            return None

    @property
    def uses_native_sampler(self) -> bool:
        return self._native is not None

    @property
    def train_cameras(self):
        return self.train_dataset.cameras

    @property
    def eval_cameras(self):
        return self.eval_dataset.cameras

    def next_train(self, step: int) -> Dict[str, np.ndarray]:
        n = self.num_rays_override or self.config.train_num_rays_per_batch
        if self._native is not None:
            return self._native.sample(n, step=step)
        return self.train_pixel_sampler.sample(n, step=step)

    def next_eval(self, step: int) -> Dict[str, np.ndarray]:
        return self.eval_pixel_sampler.sample(step=step)

    def next_eval_image(self, step: int) -> Tuple[int, Dict[str, np.ndarray]]:
        """(camera index, {"image": [H, W, C], "is_thermal": float}), cycling
        over the eval set."""
        idx = self._eval_image_index
        self._eval_image_index = (self._eval_image_index + 1) % len(self.eval_dataset)
        return idx, {"image": self.eval_dataset.get_image(idx), "is_thermal": self.eval_dataset.get_is_thermal(idx)}
