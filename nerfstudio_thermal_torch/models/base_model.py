"""Model base class and full-frame rendering
(counterpart of nerfstudio_thermal_tpu/models/base_model.py).

A Model is an nn.Module: its submodules hold the parameters, grouped as
the JAX package's top-level param groups (fields, proposal_networks,
camera_opt, ...). The constructor builds the modules, draws their initial
values from a seeded torch.Generator on the CPU (so a seed gives the same
weights on every device), then moves them to `device`, which defaults to
CUDA and raises when CUDA is absent.

`render_camera_device` renders one camera in chunks of
`eval_num_rays_per_chunk` rays; the last chunk is padded by repeating the
last pixel coordinate, so every chunk has the same shape, and the outputs
are trimmed afterwards. Only per-ray outputs ([chunk, C]) are kept.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.utils.precision import pin_precision, resolve_device


@dataclass
class ModelConfig:
    eval_num_rays_per_chunk: int = 4096


class Model(nn.Module):
    def __init__(
        self,
        config: ModelConfig,
        scene_aabb: np.ndarray,  # [2, 3]
        num_train_data: int,
        metadata: Optional[Dict[str, Any]] = None,
        *,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ) -> None:
        pin_precision()
        device = resolve_device(device)
        super().__init__()
        self.config = config
        self.scene_aabb = np.asarray(scene_aabb, np.float32)
        self.num_train_data = num_train_data
        self.metadata = metadata or {}
        self.collider = None
        self.populate_modules()
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def populate_modules(self) -> None:
        raise NotImplementedError

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def get_outputs(self, ray_bundle: RayBundle, *, train: bool = False, **kwargs) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def forward(self, ray_bundle: RayBundle, *, train: bool = False, **kwargs) -> Dict[str, torch.Tensor]:
        """Collider, then get_outputs (training takes the anneal, update
        flags and jitter draws as keyword arguments)."""
        if self.collider is not None:
            ray_bundle = self.collider(ray_bundle, train=train)
        return self.get_outputs(ray_bundle, train=train, **kwargs)

    @torch.no_grad()
    def get_outputs_for_camera(
        self,
        cameras: Cameras,
        camera_index: int,
        width: Optional[int] = None,
        height: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Render a full image from camera `camera_index`: {name: [h, w, C]}
        numpy arrays on the host."""
        h = int(height if height is not None else cameras.height[camera_index])
        w = int(width if width is not None else cameras.width[camera_index])
        outputs = self.render_camera_device(cameras, camera_index, width=w, height=h)
        return {k: v.cpu().numpy().reshape(h, w, -1) for k, v in outputs.items()}

    @torch.no_grad()
    def render_camera_device(
        self,
        cameras: Cameras,
        camera_index: int,
        width: Optional[int] = None,
        height: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """Full-frame render that stays on the model's device: per-ray
        outputs as flat [h * w, C] tensors."""
        pin_precision()
        device = self.device
        cameras = cameras.to(device)
        h = int(height if height is not None else cameras.height[camera_index])
        w = int(width if width is not None else cameras.width[camera_index])
        chunk = self.config.eval_num_rays_per_chunk
        n = h * w
        pad = (-n) % chunk
        n_chunks = (n + pad) // chunk
        ys, xs = torch.meshgrid(
            torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
        )
        coords = torch.stack([ys, xs], dim=-1).reshape(-1, 2).float() + 0.5
        if pad:
            coords = torch.cat([coords, coords[-1:].expand(pad, 2)], dim=0)
        idx = torch.full((chunk,), camera_index, dtype=torch.long, device=device)
        outs: Dict[str, torch.Tensor] = {}
        for c in range(n_chunks):
            bundle = cameras.generate_rays(idx, coords[c * chunk : (c + 1) * chunk])
            out = self.forward(bundle, train=False)
            for k, v in out.items():
                if v.dim() != 2:
                    continue  # per-sample tensors are loss-path payload
                if k not in outs:
                    outs[k] = torch.empty((n_chunks * chunk, v.shape[1]), dtype=v.dtype, device=device)
                outs[k][c * chunk : (c + 1) * chunk] = v
        return {k: v[:n] for k, v in outs.items()}
