"""Volume-rendering compositors (counterpart of nerfstudio_thermal_tpu/model_components/renderers.py).

This slice carries the eval renderers of the nerfacto family: RGB (any
channel count) with the `last_sample` or a named background, accumulation,
median depth and expected depth.
"""

from typing import Union

import torch

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.model_components.ray_samplers import take_below_above
from nerfstudio_thermal_torch.utils.math import cumsum

BACKGROUND_COLORS = {
    "white": (1.0, 1.0, 1.0),
    "black": (0.0, 0.0, 0.0),
    "red": (1.0, 0.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
}


def _bg_color(background_color: Union[str, torch.Tensor], num_channels: int, like: torch.Tensor):
    if isinstance(background_color, str):
        rgb = BACKGROUND_COLORS[background_color]
        # RGBT backgrounds have thermal channel 0
        vals = rgb + (0.0,) * (num_channels - 3) if num_channels >= 3 else rgb[:num_channels]
        return torch.tensor(vals, dtype=like.dtype, device=like.device)
    return background_color


def combine_rgb(
    rgb: torch.Tensor,  # [..., S, C]
    weights: torch.Tensor,  # [..., S, 1]
    background_color: Union[str, torch.Tensor] = "random",
) -> torch.Tensor:
    """Composite samples; 'random' blends nothing here (as if black)."""
    comp = torch.sum(weights * rgb, dim=-2)
    acc = torch.sum(weights, dim=-2)
    if isinstance(background_color, str) and background_color == "random":
        return comp
    if isinstance(background_color, str) and background_color == "last_sample":
        bg = rgb[..., -1, :]
    else:
        bg = _bg_color(background_color, rgb.shape[-1], rgb)
    return comp + bg * (1.0 - acc)


def render_rgb(
    rgb: torch.Tensor,
    weights: torch.Tensor,
    background_color: Union[str, torch.Tensor] = "random",
    train: bool = True,
) -> torch.Tensor:
    if not train:
        rgb = torch.nan_to_num(rgb)
    out = combine_rgb(rgb, weights, background_color)
    if not train:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights, dim=-2)


def render_depth_median(weights: torch.Tensor, ray_samples: RaySamples) -> torch.Tensor:
    """Distance at which the cumulative weight reaches 0.5."""
    steps = (ray_samples.starts + ray_samples.ends) / 2.0  # [..., S, 1]
    cumulative = cumsum(weights[..., 0], dim=-1)  # [..., S]
    split = torch.full((*weights.shape[:-2], 1), 0.5, dtype=weights.dtype, device=weights.device)
    _, median_depth = take_below_above(cumulative, split, steps[..., 0], side="left")
    return median_depth


def render_depth_expected(weights: torch.Tensor, ray_samples: RaySamples) -> torch.Tensor:
    """Expected depth, clipped to the range of sample midpoints of the whole
    batch (as in the JAX package, the clip bounds are batch-global)."""
    eps = 1e-10
    steps = (ray_samples.starts + ray_samples.ends) / 2.0
    depth = torch.sum(weights * steps, dim=-2) / (torch.sum(weights, dim=-2) + eps)
    return torch.clamp(depth, torch.min(steps), torch.max(steps))
