"""Ray generator (counterpart of nerfstudio_thermal_tpu/model_components/ray_generators.py)."""

import torch

from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.cameras.rays import RayBundle


class RayGenerator:
    def __init__(self, cameras: Cameras):
        self.cameras = cameras

    def __call__(self, ray_indices: torch.Tensor) -> RayBundle:
        """ray_indices: [R, 3] int (camera, row, col) -> rays through the
        pixel centres (+0.5)."""
        coords = ray_indices[:, 1:].float() + 0.5  # (y, x)
        return self.cameras.generate_rays(ray_indices[:, 0], coords)
