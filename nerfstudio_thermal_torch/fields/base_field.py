"""Field base helpers (counterpart of nerfstudio_thermal_tpu/fields/base_field.py)."""

from enum import Enum

import torch

from nerfstudio_thermal_torch.data.scene_box import SceneBox
from nerfstudio_thermal_torch.ops.spatial_distortions import SceneContraction


class FieldHeadNames(Enum):
    """Possible field outputs."""

    RGB = "rgb"
    SH = "sh"
    DENSITY = "density"
    NORMALS = "normals"
    PRED_NORMALS = "pred_normals"
    UNCERTAINTY = "uncertainty"
    TRANSIENT_RGB = "transient_rgb"
    TRANSIENT_DENSITY = "transient_density"
    SEMANTICS = "semantics"
    SDF = "sdf"
    ALPHA = "alpha"
    GRADIENT = "gradient"


def normalize_positions(positions: torch.Tensor, aabb: torch.Tensor, use_spatial_distortion: bool):
    """World positions -> [0, 1]^3 field coordinates and the in-box selector.

    With the inf-norm scene contraction the cube of side 4 maps to the unit
    cube by (x + 2) / 4; without it the aabb does. Positions outside the
    unit cube are zeroed and deselected."""
    if use_spatial_distortion:
        positions = (SceneContraction(order=float("inf"))(positions) + 2.0) / 4.0
    else:
        positions = SceneBox.get_normalized_positions(positions, aabb)
    selector = torch.all((positions > 0.0) & (positions < 1.0), dim=-1)
    return positions * selector[..., None], selector


def ray_march_inputs(ray_samples):
    """What the fused ray-march kernels take from ray samples: origins and
    directions [R, 3] (one per ray) and the sample midpoints [R * S, 1]."""
    mids = ((ray_samples.starts + ray_samples.ends) * 0.5).reshape(-1, 1)
    return ray_samples.origins.reshape(-1, 3), ray_samples.directions.reshape(-1, 3), mids
