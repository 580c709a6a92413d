"""Data manager (counterpart of nerfstudio_thermal_tpu/data/datamanagers.py).

`VanillaDataManager` owns the train and eval datasets and their pixel
samplers (the eval one seeded with seed + 1), and gives one host batch per
training step, eval ray batches, and whole eval images in turn. Ray
generation happens in the train step, on the device. As
in the JAX package, `use_native_sampler` (on by default) samples through
the C++ batch sampler (data/native_sampler.py) when the dataset qualifies
and the library builds, and through the Python PixelSampler otherwise.
`FullImageDatamanager` gives splatfacto one whole image a step and
`RandomCamerasDataManager` gives generfacto one random camera pose a
step. `PrefetchingDataManager` keeps a queue of host batches filled by a
worker thread; as in the JAX package, no method config selects it.
"""

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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

    def num_train_data(self) -> int:
        return len(self.train_dataset)


@dataclass
class FullImageDatamanagerConfig(VanillaDataManagerConfig):
    cache_images_type: str = "uint8"  # uint8 | float32


class FullImageDatamanager(VanillaDataManager):
    """Whole-image batches for rasterization methods (splatfacto): one full
    training image and its camera index a step, in a random permutation
    per epoch that is a pure function of (seed, epoch), so a resumed run
    replays the same order. Images are cached at first use, as uint8 by
    default (each read back as x / 255 in f32)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._image_cache: Dict[Tuple[str, int], np.ndarray] = {}

    def _cached_image(self, dataset, tag: str, idx: int) -> np.ndarray:
        key = (tag, idx)
        if key not in self._image_cache:
            img = dataset.get_image(idx)
            if self.config.cache_images_type == "uint8":
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            self._image_cache[key] = img
        img = self._image_cache[key]
        if img.dtype == np.uint8:
            return img.astype(np.float32) / 255.0
        return img

    def next_train(self, step: int) -> Dict[str, np.ndarray]:
        n = len(self.train_dataset)
        epoch, pos = divmod(step, n)
        idx = int(np.random.default_rng((self.config.seed, epoch)).permutation(n)[pos])
        return {
            "image": self._cached_image(self.train_dataset, "train", idx),
            "camera_index": np.asarray(idx, np.int32),
            "is_thermal": self.train_dataset.get_is_thermal(idx),
        }

    def next_eval(self, step: int) -> Dict[str, np.ndarray]:
        idx = step % len(self.eval_dataset)
        return {
            "image": self._cached_image(self.eval_dataset, "eval", idx),
            "camera_index": np.asarray(idx, np.int32),
            "is_thermal": self.eval_dataset.get_is_thermal(idx),
        }


@dataclass
class RandomCamerasDataManagerConfig(VanillaDataManagerConfig):
    """Random spherical cameras for generative (text-to-3D) training."""

    radius_mean: float = 2.5
    radius_std: float = 0.1
    focal_range: Tuple[float, float] = (0.7, 1.35)
    vertical_rotation_range: Tuple[float, float] = (-90.0, 0.0)
    jitter_std: float = 0.01
    resolution: int = 64


class _NoParserOutputs:
    """What a generative run has in place of parser outputs: no metadata, the
    [-1, 1]^3 box, an empty transform."""

    metadata: Dict = {}
    scene_box = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)

    def as_dict(self) -> Dict:
        return {}


class RandomCamerasDataManager:
    """One random camera pose a step and no images. The eval "dataset" is a
    fixed ring of 8 look-at cameras for renders; `next_eval_image` raises
    (there is no ground truth)."""

    def __init__(self, config: RandomCamerasDataManagerConfig, dataparser=None, test_split: str = "val"):
        from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType

        self.config = config
        self._eval_image_index = 0
        res = config.resolution
        n_eval = 8
        angles = np.linspace(0, 2 * np.pi, n_eval, endpoint=False)
        c2ws = np.stack([self._look_at(config.radius_mean * np.array([np.cos(a), np.sin(a), 0.4])) for a in angles])
        focal = res * 1.0

        def full(v, dtype=torch.float32):
            return torch.full((n_eval,), v, dtype=dtype)

        self._cams = Cameras(
            camera_to_worlds=torch.as_tensor(c2ws.astype(np.float32)),
            fx=full(focal), fy=full(focal), cx=full(res / 2), cy=full(res / 2),
            width=full(res, torch.int32), height=full(res, torch.int32),
            distortion_params=torch.zeros((n_eval, 6)),
            camera_type=full(CameraType.PERSPECTIVE.value, torch.int32),
        )
        self.train_dataparser_outputs = _NoParserOutputs()
        self.train_dataset = [None]  # len() == 1 (no images)
        self.eval_dataset = [None] * n_eval

    @staticmethod
    def _look_at(eye, target=np.zeros(3), up=np.array([0.0, 0.0, 1.0])):
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / max(np.linalg.norm(right), 1e-9)
        true_up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)[:3]
        c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3] = right, true_up, -fwd, eye
        return c2w

    @property
    def train_cameras(self):
        return self._cams

    @property
    def eval_cameras(self):
        return self._cams

    def next_train(self, step: int) -> Dict[str, np.ndarray]:
        """A random spherical pose and its view angles, a pure function of
        (seed, step) so a resumed run replays it."""
        cfg = self.config
        r = np.random.default_rng((cfg.seed, step))
        vertical = r.uniform(*cfg.vertical_rotation_range)  # degrees
        central = r.uniform(0.0, 360.0)
        radius = r.normal(cfg.radius_mean, cfg.radius_std)
        v = np.deg2rad(vertical)
        h = np.deg2rad(central)
        eye = radius * np.array([np.cos(h) * np.cos(v), np.sin(h) * np.cos(v), -np.sin(v)])
        eye = eye + r.normal(0, cfg.jitter_std, 3)
        c2w = self._look_at(eye)
        focal = r.uniform(*cfg.focal_range) * cfg.resolution
        return {
            "c2w": c2w.astype(np.float32),
            "focal": np.float32(focal),
            "vertical": np.float32(-vertical),  # the reference's sign: positive = overhead
            "central": np.float32(central),
        }

    def next_eval(self, step: int) -> Dict[str, np.ndarray]:
        return self.next_train(step)

    def next_eval_image(self, step: int):
        raise NotImplementedError("generative training has no GT images")

    def num_train_data(self) -> int:
        return 1


class PrefetchingDataManager(VanillaDataManager):
    """A `VanillaDataManager` whose training batches come from a queue of
    `queue_size` that a daemon worker thread keeps filled, each tagged
    (generation, step). The worker claims its step under `_step_lock`
    before it samples, and `set_start_step` bumps the generation and drains
    the queue under the same lock, so a batch drawn for an abandoned stream
    is dropped on dequeue. A batch drawn for a later step than asked (a
    rewind) is stashed and served when that step comes; the step asked is
    sampled inline meanwhile. Every batch is the stateless (seed, step)
    batch of `VanillaDataManager.next_train`. The worker makes host numpy
    batches only: no CUDA call."""

    def __init__(self, *args, queue_size: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self._queue: "queue.Queue[Tuple[int, int, Dict[str, np.ndarray]]]" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._prefetch_step = 0
        self._gen = 0  # the realignment generation; guarded by _step_lock
        self._step_lock = threading.Lock()
        self._lookahead = None  # a stashed future-tagged batch (trainer thread only)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def set_start_step(self, step: int):
        """Restart the stream at `step` (after a checkpoint load): queued
        batches are dropped, and so is any batch the worker is drawing now
        (it was claimed under the old generation)."""
        with self._step_lock:
            self._gen += 1
            self._prefetch_step = int(step)
            # drained under the same lock: the worker cannot claim a step of
            # the new generation (and enqueue a batch swallowed here) before
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        self._lookahead = None

    def _worker(self):
        while not self._stop.is_set():
            with self._step_lock:
                s = self._prefetch_step
                gen = self._gen
                self._prefetch_step = s + 1
            batch = VanillaDataManager.next_train(self, s)
            while not self._stop.is_set():
                try:
                    self._queue.put((gen, s, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def _current_gen(self) -> int:
        with self._step_lock:
            return self._gen

    def next_train(self, step: int) -> Dict[str, np.ndarray]:
        if self._lookahead is not None:
            gen, tag, batch = self._lookahead
            if gen != self._current_gen() or tag < step:
                self._lookahead = None
            elif tag == step:
                self._lookahead = None
                return batch
            else:  # still ahead of `step`
                return super().next_train(step)
        while True:
            gen, tag, batch = self._queue.get()
            if gen != self._current_gen() or tag < step:
                continue
            if tag == step:
                return batch
            # the stream ran ahead of a rewind: keep the batch for its step
            # and draw this one inline (the draw is stateless in (seed, step))
            self._lookahead = (gen, tag, batch)
            return super().next_train(step)

    def close(self):
        self._stop.set()

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()
