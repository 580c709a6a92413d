"""Ray containers (counterpart of nerfstudio_thermal_tpu/cameras/rays.py).

Frustums are flattened into `RaySamples` (starts/ends/origins/directions)
as in the JAX package; `Frustums` is the name the reference gives the
geometric part and is kept as an alias. Containers are immutable in use:
`dataclasses.replace` makes a corrected copy.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from nerfstudio_thermal_torch.utils.math import cumsum


def spacing_fn(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Spacing warp s(t)."""
    if kind == "uniform":
        return x
    if kind == "lindisp":
        return 1.0 / x
    if kind == "sqrt":
        return torch.sqrt(x)
    if kind == "log":
        return torch.log(x)
    if kind == "piecewise":
        return torch.where(x < 1, x / 2.0, 1.0 - 1.0 / (2.0 * x))
    raise ValueError(f"unknown spacing kind {kind}")


def spacing_fn_inv(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Inverse spacing warp t(s)."""
    if kind == "uniform":
        return x
    if kind == "lindisp":
        return 1.0 / x
    if kind == "sqrt":
        return x**2
    if kind == "log":
        return torch.exp(x)
    if kind == "piecewise":
        return torch.where(x < 0.5, 2.0 * x, 1.0 / (2.0 - 2.0 * x))
    raise ValueError(f"unknown spacing kind {kind}")


@dataclass
class RayBundle:
    """A batch of rays; all leading dims are the ray batch shape."""

    origins: torch.Tensor  # [..., 3]
    directions: torch.Tensor  # [..., 3] unit
    pixel_area: torch.Tensor  # [..., 1]
    camera_indices: torch.Tensor  # [..., 1] int
    nears: Optional[torch.Tensor] = None  # [..., 1]
    fars: Optional[torch.Tensor] = None  # [..., 1]
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)
    times: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.origins.shape[:-1]

    def replace(self, **changes) -> "RayBundle":
        return dataclasses.replace(self, **changes)

    def get_ray_samples(
        self,
        bin_starts: torch.Tensor,  # [..., S, 1] euclidean
        bin_ends: torch.Tensor,
        spacing_starts: torch.Tensor,  # [..., S, 1] in [0, 1]
        spacing_ends: torch.Tensor,
        spacing_kind: str,
        s_near: torch.Tensor,  # [..., 1]
        s_far: torch.Tensor,
    ) -> "RaySamples":
        return RaySamples(
            origins=self.origins,
            directions=self.directions,
            pixel_area=self.pixel_area,
            camera_indices=self.camera_indices,
            starts=bin_starts,
            ends=bin_ends,
            spacing_starts=spacing_starts,
            spacing_ends=spacing_ends,
            s_near=s_near,
            s_far=s_far,
            spacing_kind=spacing_kind,
            metadata=self.metadata,
            times=self.times,
        )


@dataclass
class RaySamples:
    """Samples along a ray batch: [..., S] sample dims, ray tensors broadcast."""

    origins: torch.Tensor  # [..., 3]
    directions: torch.Tensor  # [..., 3]
    pixel_area: torch.Tensor  # [..., 1]
    camera_indices: torch.Tensor  # [..., 1]
    starts: torch.Tensor  # [..., S, 1] euclidean bin starts
    ends: torch.Tensor  # [..., S, 1]
    spacing_starts: torch.Tensor  # [..., S, 1]
    spacing_ends: torch.Tensor  # [..., S, 1]
    s_near: torch.Tensor  # [..., 1]
    s_far: torch.Tensor  # [..., 1]
    spacing_kind: str = "uniform"
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)
    times: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.starts.shape[:-1]

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    def get_positions(self) -> torch.Tensor:
        """Sample midpoints in world space."""
        mids = (self.starts + self.ends) / 2.0
        return self.origins[..., None, :] + self.directions[..., None, :] * mids

    def spacing_to_euclidean(self, s: torch.Tensor) -> torch.Tensor:
        return spacing_fn_inv(self.spacing_kind, s * self.s_far + (1.0 - s) * self.s_near)

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        """Alpha-compositing weights: transmittance from the exclusive
        prefix sum of delta * density."""
        return get_weights(self.deltas, densities)


# The reference names the geometric half of RaySamples a Frustums; here the
# two are one container.
Frustums = RaySamples


def map_tensors(container, fn):
    """A copy of a ray container with `fn` applied to each tensor field."""
    return dataclasses.replace(
        container,
        **{
            f.name: fn(getattr(container, f.name))
            for f in dataclasses.fields(container)
            if isinstance(getattr(container, f.name), torch.Tensor)
        },
    )


def get_weights(deltas: torch.Tensor, densities: torch.Tensor) -> torch.Tensor:
    """[..., S, 1] deltas and densities -> [..., S, 1] weights."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    trans = torch.exp(-cumsum(delta_density, dim=-2, exclusive=True))
    return torch.nan_to_num(alphas * trans)
