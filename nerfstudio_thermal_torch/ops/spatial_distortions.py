"""Scene contraction (counterpart of nerfstudio_thermal_tpu/ops/spatial_distortions.py).

f(x) = x if ||x|| < 1 else (2 - 1/||x||) x/||x||. With order=inf the space
contracts into the cube of side 4; order=None is the L2 ball of radius 2.
"""

import math
from typing import Optional

import torch


class SceneContraction:
    def __init__(self, order: Optional[float] = None) -> None:
        self.order = order

    def __call__(self, positions: torch.Tensor) -> torch.Tensor:
        if self.order is None:
            mag = torch.linalg.norm(positions, dim=-1, keepdim=True)
        elif self.order == math.inf:
            mag = torch.amax(torch.abs(positions), dim=-1, keepdim=True)
        else:
            mag = torch.linalg.norm(positions, ord=self.order, dim=-1, keepdim=True)
        safe_mag = torch.clamp(mag, min=1e-12)
        contracted = (2.0 - 1.0 / safe_mag) * (positions / safe_mag)
        return torch.where(mag < 1.0, positions, contracted)
