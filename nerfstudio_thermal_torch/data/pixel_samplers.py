"""Pixel samplers, host side (counterpart of nerfstudio_thermal_tpu/data/pixel_samplers.py).

Uniform or patch_size x patch_size patch sampling over the cached images,
equal ray counts per image (which balances RGB and thermal images in a
thermal dataset), per-ray `is_thermal` from the per-image metadata. With a
step the draw is a pure function of (seed, step), through numpy's
`default_rng((seed, step))`, so it gives the JAX package's batches exactly
and a resumed run replays the same batches. A dataset with depth files
adds each ray's `depth_image` [R, 1], one with normal files its `normal`
[R, 3] (the surface models' prior) and one with semantic label images its
`semantics` [R] int32 (semantic-nerfw).
`PairPixelSampler` draws neighbouring pixel pairs for the depth-ranking
loss.
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
        "is_thermal": [R] f32}, and "depth_image" [R, 1] f32 with depth
        files, "normal" [R, 3] f32 with normal files, "semantics" [R]
        int32 with semantic label images."""
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
        batch = {
            "ray_indices": np.concatenate([cam_idx[:, None], yx], axis=-1).astype(np.int32),
            "image": image_vals,
            "is_thermal": self.dataset.is_thermal[cam_idx].astype(np.float32),
        }
        if self.dataset.metadata.get("depth_filenames"):
            depth = np.zeros((num_rays, 1), np.float32)
            for idx in np.unique(cam_idx):
                m = cam_idx == idx
                depth[m] = self.dataset.get_depth(int(idx))[yx[m, 0], yx[m, 1]][:, :1]
            batch["depth_image"] = depth
        if self.dataset.metadata.get("normal_filenames"):
            normal = np.zeros((num_rays, 3), np.float32)
            for idx in np.unique(cam_idx):
                n = self.dataset.get_normal(int(idx))
                if n is not None:
                    m = cam_idx == idx
                    normal[m] = n[yx[m, 0], yx[m, 1]]
            batch["normal"] = normal
        sem = self.dataset.metadata.get("semantics")
        if sem and sem.get("filenames"):
            labels = np.zeros((num_rays,), np.int32)
            for idx in np.unique(cam_idx):
                m = cam_idx == idx
                labels[m] = self.dataset.get_semantics(int(idx))[yx[m, 0], yx[m, 1]]
            batch["semantics"] = labels
        return batch


class PatchPixelSampler(PixelSampler):
    """PixelSampler under the reference's patch sampler's name: the patch
    layout follows config.patch_size."""


class PairPixelSampler(PixelSampler):
    """Pixels in pairs, an anchor and a neighbour within `radius`, laid out
    [anchor, neighbour, anchor, neighbour, ...]: the layout of
    depth_ranking_loss."""

    def __init__(self, config: PixelSamplerConfig, dataset: InputDataset, seed: int = 0, radius: int = 2):
        super().__init__(config, dataset, seed)
        self.radius = radius
        self.num_rays_per_batch = config.num_rays_per_batch // 2 * 2

    def _sample_in_image(self, idx: int, num_rays: int, rng) -> np.ndarray:
        h, w = self.dataset.get_image(idx).shape[:2]
        r = self.radius
        n_pairs = max(num_rays // 2, 1)
        ys = rng.integers(r, max(h - r, r + 1), n_pairs)
        xs = rng.integers(r, max(w - r, r + 1), n_pairs)
        dy = rng.integers(-r, r + 1, n_pairs)
        dx = rng.integers(-r, r + 1, n_pairs)
        yx = np.empty((n_pairs * 2, 2), np.int64)
        yx[0::2, 0], yx[0::2, 1] = ys, xs
        yx[1::2, 0], yx[1::2, 1] = np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)
        return yx[:num_rays]
