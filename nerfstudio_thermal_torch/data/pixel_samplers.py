"""Pixel samplers, host side (counterpart of nerfstudio_thermal_tpu/data/pixel_samplers.py).

Uniform or patch_size x patch_size patch sampling over the cached images,
equal ray counts per image (which balances RGB and thermal images in a
thermal dataset), per-ray `is_thermal` from the per-image metadata. With a
step the draw is a pure function of (seed, step), through numpy's
`default_rng((seed, step))`, so it gives the JAX package's batches exactly
and a resumed run replays the same batches.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from nerfstudio_thermal_torch.data.datasets import InputDataset


@dataclass
class PixelSamplerConfig:
    num_rays_per_batch: int = 4096
    patch_size: int = 1
    """>1 samples whole patch_size x patch_size patches (the thermal model
    needs 2 for its TV and cross-channel losses)."""


class PixelSampler:
    """Samples (camera, y, x) and the GT values from an InputDataset."""

    def __init__(self, config: PixelSamplerConfig, dataset: InputDataset, seed: int = 0):
        self.config = config
        self.dataset = dataset
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        p = config.patch_size
        self.num_rays_per_batch = (config.num_rays_per_batch // (p * p)) * (p * p)
        if dataset.metadata.get("depth_filenames"):
            raise NotImplementedError("depth supervision is not ported yet")

    def _sample_in_image(self, idx: int, num_rays: int, rng) -> np.ndarray:
        """[num_rays, 2] integer (y, x) in one image."""
        h, w = self.dataset.get_image(idx).shape[:2]
        p = self.config.patch_size
        if p <= 1:
            ys = rng.integers(0, h, num_rays)
            xs = rng.integers(0, w, num_rays)
            return np.stack([ys, xs], -1)
        n_patches = num_rays // (p * p)
        # patch top-left uniform in [0, dim - p)
        ys0 = rng.uniform(0, h - p, n_patches).astype(np.int64)
        xs0 = rng.uniform(0, w - p, n_patches).astype(np.int64)
        dy, dx = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
        ys = (ys0[:, None, None] + dy).reshape(-1)
        xs = (xs0[:, None, None] + dx).reshape(-1)
        return np.stack([ys, xs], -1)

    def sample(self, num_rays: Optional[int] = None, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """A ray batch: equal ray counts per image, patch-aligned:
        {"ray_indices": [R, 3] int32 (camera, y, x), "image": [R, C] f32,
        "is_thermal": [R] f32}."""
        rng = np.random.default_rng((self.seed, step)) if step is not None else self.rng
        num_rays = num_rays or self.num_rays_per_batch
        n_images = len(self.dataset)
        if n_images == 0:
            raise ValueError("cannot sample rays from an empty dataset")
        p = self.config.patch_size
        unit = p * p
        per_image = max(unit, (num_rays // n_images) // unit * unit)

        cams, coords = [], []
        total = 0
        order = rng.permutation(n_images)
        for j, idx in enumerate(order):
            want = min(per_image, num_rays - total)
            if j == len(order) - 1:
                want = num_rays - total
            want = (want // unit) * unit
            if want <= 0:
                continue
            yx = self._sample_in_image(int(idx), want, rng)
            cams.append(np.full((want,), idx, np.int64))
            coords.append(yx)
            total += want
            if total >= num_rays:
                break
        # top up from random images if short (small datasets)
        while total < num_rays:
            idx = int(rng.integers(0, n_images))
            yx = self._sample_in_image(idx, unit, rng)
            cams.append(np.full((unit,), idx, np.int64))
            coords.append(yx)
            total += unit

        cam_idx = np.concatenate(cams)[:num_rays]
        yx = np.concatenate(coords)[:num_rays]
        channels = self.dataset.get_image(int(cam_idx[0])).shape[-1]
        image_vals = np.empty((num_rays, channels), np.float32)
        for idx in np.unique(cam_idx):
            m = cam_idx == idx
            img = self.dataset.get_image(int(idx))
            image_vals[m] = img[yx[m, 0], yx[m, 1]]
        return {
            "ray_indices": np.concatenate([cam_idx[:, None], yx], axis=-1).astype(np.int32),
            "image": image_vals,
            "is_thermal": self.dataset.is_thermal[cam_idx].astype(np.float32),
        }
