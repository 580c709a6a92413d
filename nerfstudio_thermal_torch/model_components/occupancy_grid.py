"""Occupancy grid for empty-space skipping (counterpart of
nerfstudio_thermal_tpu/model_components/occupancy_grid.py).

As in the JAX package, occupancy masks instead of packing: every ray keeps
its fixed sample count, and densities are zeroed where the grid marks
space empty, which zeroes their compositing weights. The grid is a dense
[res^3] EMA of sampled densities, carried in the trainer's state (its
`extra`) and updated before the forward of every `grid_update_every`-th
step. It starts at zero, so until updates have covered a cell every
sample there is masked.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch


@dataclass
class OccupancyGridState:
    densities: torch.Tensor  # [res^3] EMA of density samples
    resolution: int = 128
    aabb: Tuple = ((-1, -1, -1), (1, 1, 1))


def create_occupancy_grid(resolution: int = 128, aabb=((-1, -1, -1), (1, 1, 1)), device="cpu") -> OccupancyGridState:
    return OccupancyGridState(
        densities=torch.zeros((resolution**3,), dtype=torch.float32, device=device),
        resolution=resolution,
        aabb=tuple(tuple(float(v) for v in row) for row in aabb),
    )


def _aabb(grid: OccupancyGridState, device) -> torch.Tensor:
    return torch.tensor(grid.aabb, dtype=torch.float32, device=device)


def _cell_index(grid: OccupancyGridState, positions: torch.Tensor) -> torch.Tensor:
    """World positions [..., 3] -> flat cell indices; the cell coordinates
    are truncated toward zero, then clipped into the grid."""
    aabb = _aabb(grid, positions.device)
    res = grid.resolution
    norm = (positions - aabb[0]) / (aabb[1] - aabb[0])
    cell = torch.clamp((norm * res).to(torch.int32), 0, res - 1).long()
    return (cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]


def update_occupancy_grid(
    grid: OccupancyGridState,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator] = None,
    num_samples: int = 2**18,
    ema_decay: float = 0.95,
    idx: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
) -> OccupancyGridState:
    """EMA-update a random subset of cells: `num_samples` cell indices
    (with repeats) and a uniform jitter in each, drawn from `generator` or
    given as `idx` [n] and `jitter` [n, 3]; the grid decays by `ema_decay`
    and each drawn cell keeps the max of its decayed value and the densities
    sampled in it."""
    res = grid.resolution
    device = grid.densities.device
    aabb = _aabb(grid, device)
    if idx is None:
        idx = torch.randint(0, res**3, (num_samples,), generator=generator, device=device)
    if jitter is None:
        jitter = torch.rand((idx.shape[0], 3), generator=generator, device=device)
    idx = idx.to(device=device, dtype=torch.long)
    cz = idx % res
    cy = (idx // res) % res
    cx = idx // (res * res)
    cell = torch.stack([cx, cy, cz], -1).float()
    positions = aabb[0] + (cell + jitter.to(device)) / res * (aabb[1] - aabb[0])
    density = density_fn(positions)[..., 0].float()
    decayed = grid.densities * ema_decay
    updated = decayed.scatter_reduce(0, idx, density, reduce="amax", include_self=True)
    return dataclasses.replace(grid, densities=updated)


def occupancy_mask(grid: OccupancyGridState, positions: torch.Tensor, threshold: float = 1e-2) -> torch.Tensor:
    """[..., 3] world positions -> float {0, 1} mask [..., 1]."""
    occ = grid.densities[_cell_index(grid, positions)] > threshold
    return occ.float()[..., None]
