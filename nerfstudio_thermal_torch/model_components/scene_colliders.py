"""Scene colliders (counterpart of nerfstudio_thermal_tpu/model_components/scene_colliders.py).

This slice carries `NearFarCollider`, the collider of the nerfacto family.
"""

import torch

from nerfstudio_thermal_torch.cameras.rays import RayBundle


def _combine_bounds(ray_bundle: RayBundle, nears: torch.Tensor, fars: torch.Tensor) -> RayBundle:
    """Intersect collider bounds with bounds already on the bundle; an empty
    intersection collapses to near == far (zero-weight samples)."""
    if ray_bundle.nears is not None:
        nears = torch.maximum(nears, ray_bundle.nears)
    if ray_bundle.fars is not None:
        fars = torch.minimum(fars, ray_bundle.fars)
    fars = torch.maximum(fars, nears)
    return ray_bundle.replace(nears=nears, fars=fars)


class NearFarCollider:
    """Fixed near/far planes; at eval the near plane resets to 0 unless
    reset_near_plane is off."""

    def __init__(self, near_plane: float, far_plane: float, reset_near_plane: bool = True):
        self.near_plane = near_plane
        self.far_plane = far_plane
        self.reset_near_plane = reset_near_plane

    def __call__(self, ray_bundle: RayBundle, train: bool = True) -> RayBundle:
        ones = torch.ones_like(ray_bundle.origins[..., 0:1])
        near = self.near_plane if (train or not self.reset_near_plane) else 0.0
        return _combine_bounds(ray_bundle, ones * near, ones * self.far_plane)
