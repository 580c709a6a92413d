"""Scene AABB (counterpart of nerfstudio_thermal_tpu/data/scene_box.py)."""

from dataclasses import dataclass

import torch


@dataclass
class SceneBox:
    """Axis-aligned scene box. aabb: [2, 3] = [[min], [max]]."""

    aabb: torch.Tensor

    @staticmethod
    def get_normalized_positions(positions: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
        """World positions -> [0, 1]^3 with respect to the aabb."""
        return (positions - aabb[0]) / (aabb[1] - aabb[0])
