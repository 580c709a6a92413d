"""Scene colliders (counterpart of nerfstudio_thermal_tpu/model_components/scene_colliders.py).

`NearFarCollider` (the nerfacto family), `AABBBoxCollider` (instant-ngp:
ray-box slab intersection, near clipped to the near plane in training) and
`SphereCollider` (rays that miss the sphere get near = far). Each
intersects its bounds with any the bundle already carries.
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


class AABBBoxCollider:
    """Near/far from the ray's intersection with an axis-aligned box; a
    direction component under 1e-10 in magnitude is replaced by 1e-10."""

    def __init__(self, aabb, near_plane: float = 0.0):
        self.aabb = torch.as_tensor(aabb, dtype=torch.float32)
        self.near_plane = near_plane

    def __call__(self, ray_bundle: RayBundle, train: bool = True) -> RayBundle:
        dirs, origins = ray_bundle.directions, ray_bundle.origins
        if self.aabb.device != origins.device:
            self.aabb = self.aabb.to(origins.device)
        aabb = self.aabb
        inv = 1.0 / torch.where(torch.abs(dirs) < 1e-10, torch.full_like(dirs, 1e-10), dirs)
        t1 = (aabb[0] - origins) * inv
        t2 = (aabb[1] - origins) * inv
        nears = torch.amax(torch.minimum(t1, t2), dim=-1, keepdim=True)
        fars = torch.amin(torch.maximum(t1, t2), dim=-1, keepdim=True)
        near_plane = self.near_plane if train else 0.0
        nears = torch.clamp(nears, min=near_plane)
        fars = torch.maximum(fars, nears + 1e-6)
        return _combine_bounds(ray_bundle, nears, fars)


class SphereCollider:
    """Near/far from the ray's intersection with a sphere; rays that miss
    it get near = near plane and far = near plane + 1e-6 (zero-weight
    samples)."""

    def __init__(self, center, radius: float, near_plane: float = 0.0):
        self.center = torch.as_tensor(center, dtype=torch.float32)
        self.radius = radius
        self.near_plane = near_plane

    def __call__(self, ray_bundle: RayBundle, train: bool = True) -> RayBundle:
        if self.center.device != ray_bundle.origins.device:
            self.center = self.center.to(ray_bundle.origins.device)
        o = ray_bundle.origins - self.center
        d = ray_bundle.directions
        a = torch.sum(d * d, dim=-1, keepdim=True)
        b = 2.0 * torch.sum(o * d, dim=-1, keepdim=True)
        c = torch.sum(o * o, dim=-1, keepdim=True) - self.radius**2
        disc = b * b - 4 * a * c
        hit = disc > 0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        nears = (-b - sq) / (2 * a)
        fars = (-b + sq) / (2 * a)
        near_plane = self.near_plane if train else 0.0
        nears = torch.clamp(nears, min=near_plane)
        nears = torch.where(hit, nears, torch.full_like(nears, near_plane))
        fars = torch.where(hit, torch.maximum(fars, nears + 1e-6), torch.full_like(fars, near_plane + 1e-6))
        return _combine_bounds(ray_bundle, nears, fars)
