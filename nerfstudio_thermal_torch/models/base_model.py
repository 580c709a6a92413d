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
are trimmed afterwards. Per-ray outputs ([chunk, C]) are kept; per-sample
outputs ([chunk, S, 1], such as the densities) only with
`include_per_sample`, and `crop_aabb` limits every ray to its segment
inside a box. `render_ray_bundle_chunked` renders a flat ray bundle the
same way.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.cameras.rays import RayBundle, map_all_tensors
from nerfstudio_thermal_torch.parallel.mesh import RayShard
from nerfstudio_thermal_torch.utils.precision import pin_precision, resolve_device


def crop_near_far(origins: torch.Tensor, directions: torch.Tensor, aabb: torch.Tensor):
    """Ray / box slab intersection -> (nears, fars) [..., 1], fars clamped
    to nears where a ray misses the box (it renders as background). A
    near-zero direction component keeps its sign: replacing a tiny negative
    component with +eps would flip that axis's slab interval."""
    d_safe = torch.where(directions >= 0.0, torch.clamp(directions, min=1e-10), torch.clamp(directions, max=-1e-10))
    inv = 1.0 / d_safe
    t1 = (aabb[0] - origins) * inv
    t2 = (aabb[1] - origins) * inv
    nears = torch.clamp(torch.amax(torch.minimum(t1, t2), dim=-1, keepdim=True), min=0.0)
    fars = torch.amin(torch.maximum(t1, t2), dim=-1, keepdim=True)
    return nears, torch.maximum(fars, nears)


def _keep(v, include_per_sample: bool) -> bool:
    """Per-ray outputs always; per-sample ones ([chunk, S, 1]) on request.
    Non-tensor outputs (lists of a training path) never."""
    return isinstance(v, torch.Tensor) and v.dim() in ((2, 3) if include_per_sample else (2,))


@dataclass
class ModelConfig:
    enable_collider: bool = True
    collider_near: float = 2.0
    collider_far: float = 6.0
    """The collider fields, with the JAX package's defaults; as there, no
    model of the port reads them (nerfacto bounds its rays by near_plane
    and far_plane)."""
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

    # Auxiliary training state the trainer carries beside the parameters
    # (instant-ngp's occupancy grid): made once, updated at the start of
    # each train step (draws from the step's generator, or `draws` where a
    # test passes them), handed to the train step's forward as keywords.
    def init_extra_state(self) -> Any:
        return None

    def update_extra_state(self, extra: Any, step: int, generator=None, draws=None) -> Any:
        return extra

    def extra_forward_kwargs(self, extra: Any) -> Dict[str, Any]:
        return {}

    @staticmethod
    def _shard(shard: Optional[RayShard], batch: Dict[str, torch.Tensor]) -> RayShard:
        """A data-parallel rank's shard (parallel/mesh.py), or a single
        process's trivial one over its batch."""
        return shard if shard is not None else RayShard.full(len(batch["image"]))

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
        crop_aabb=None,
        include_per_sample: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Render a full image from camera `camera_index`: {name: [h, w, C]}
        numpy arrays on the host (per-sample outputs [h, w, S])."""
        h = int(height if height is not None else cameras.height[camera_index])
        w = int(width if width is not None else cameras.width[camera_index])
        outputs = self.render_camera_device(
            cameras, camera_index, width=w, height=h, crop_aabb=crop_aabb, include_per_sample=include_per_sample
        )
        return {k: v.cpu().numpy().reshape(h, w, -1) for k, v in outputs.items()}

    @torch.no_grad()
    def render_camera_device(
        self,
        cameras: Cameras,
        camera_index: int,
        width: Optional[int] = None,
        height: Optional[int] = None,
        crop_aabb=None,
        include_per_sample: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Full-frame render that stays on the model's device: per-ray
        outputs as flat [h * w, C] tensors, and with `include_per_sample`
        per-sample outputs as [h * w, S, 1]. crop_aabb: a [2, 3] world-space
        box; each ray renders only its segment inside it."""
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
        aabb = None
        if crop_aabb is not None:
            aabb = torch.as_tensor(np.asarray(crop_aabb, np.float32).reshape(2, 3), device=device)
        outs: Dict[str, torch.Tensor] = {}
        for c in range(n_chunks):
            bundle = cameras.generate_rays(idx, coords[c * chunk : (c + 1) * chunk])
            if aabb is not None:
                nears, fars = crop_near_far(bundle.origins, bundle.directions, aabb)
                bundle = bundle.replace(nears=nears, fars=fars)
            self._store_chunk(outs, self.forward(bundle, train=False), c, chunk, n_chunks, include_per_sample)
        return {k: v[:n] for k, v in outs.items()}

    @torch.no_grad()
    def render_ray_bundle_chunked(self, bundle: RayBundle, include_per_sample: bool = False) -> Dict[str, torch.Tensor]:
        """Render a flat ray bundle ([n, ...] tensors) in chunks of
        `eval_num_rays_per_chunk`, the last padded by repeating the last
        ray, and cut back to n: per-ray outputs [n, C] (and per-sample ones
        [n, S, 1] with `include_per_sample`)."""
        pin_precision()
        chunk = self.config.eval_num_rays_per_chunk
        n = bundle.origins.shape[0]
        pad = (-n) % chunk
        n_chunks = (n + pad) // chunk
        if pad:
            bundle = map_all_tensors(bundle, lambda t: torch.cat([t, t[-1:].expand(pad, *t.shape[1:])], dim=0))
        outs: Dict[str, torch.Tensor] = {}
        for c in range(n_chunks):
            part = map_all_tensors(bundle, lambda t: t[c * chunk : (c + 1) * chunk])
            self._store_chunk(outs, self.forward(part, train=False), c, chunk, n_chunks, include_per_sample)
        return {k: v[:n] for k, v in outs.items()}

    @staticmethod
    def _store_chunk(outs, out, c: int, chunk: int, n_chunks: int, include_per_sample: bool) -> None:
        for k, v in out.items():
            if not _keep(v, include_per_sample):
                continue
            if k not in outs:
                outs[k] = torch.empty((n_chunks * chunk, *v.shape[1:]), dtype=v.dtype, device=v.device)
            outs[k][c * chunk : (c + 1) * chunk] = v
