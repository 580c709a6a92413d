"""Volume-rendering compositors (counterpart of nerfstudio_thermal_tpu/model_components/renderers.py).

The renderers of the nerfacto family: RGB (any channel count) with the
`last_sample`, `random` or a named background, accumulation, median depth
and expected depth, the surface models' composited normals; and the background blending of the GT and predicted
RGBT batches for the thermal losses and metrics. A `random` background is
an optional tensor of uniforms, as the samplers take their jitter.
"""

from typing import Optional, Tuple, Union

import torch

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.model_components.ray_samplers import take_below_above
from nerfstudio_thermal_torch.utils.math import cumsum, safe_normalize
from nerfstudio_thermal_torch.utils.rgbt_utils import rgb_to_rgbt_image

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


def render_normals(normals: torch.Tensor, weights: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Weight-composited normals [..., 3]; `normalize` with a finite
    gradient at a zero sum (an all-background ray)."""
    n = torch.sum(weights * normals, dim=-2)
    return safe_normalize(n) if normalize else n


def render_uncertainty(betas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weight-composited uncertainty: betas and weights [..., S, 1] -> [..., 1]."""
    return torch.sum(weights * betas, dim=-2)


def blend_background_rgb(
    image: torch.Tensor, background_color: Union[str, torch.Tensor] = "black"
) -> torch.Tensor:
    """Blend the background into an RGBA GT image; RGB passes through."""
    if image.shape[-1] < 4:
        return image
    rgb, opacity = image[..., :3], image[..., 3:]
    if isinstance(background_color, str) and background_color in ("last_sample", "random"):
        background_color = "black"
    bg = _bg_color(background_color, 3, image)
    return rgb * opacity + bg * (1.0 - opacity)


def blend_background_rgbt(
    image: torch.Tensor,
    is_thermal: torch.Tensor,
    background_color: Union[str, torch.Tensor] = "black",
) -> torch.Tensor:
    """A 3-channel GT batch as RGBT by is_thermal, blending the background
    when the image is RGBA."""
    if image.shape[-1] < 4:
        return rgb_to_rgbt_image(image, is_thermal)
    opacity = image[..., 3:]
    rgbt = rgb_to_rgbt_image(image, is_thermal)
    if isinstance(background_color, str) and background_color in ("last_sample", "random"):
        background_color = "black"
    bg = _bg_color(background_color, 4, image)
    return rgbt * opacity + bg * (1.0 - opacity)


def _loss_background(
    pred_image: torch.Tensor,
    pred_accumulation: torch.Tensor,
    background_color: Union[str, torch.Tensor],
    uniforms: Optional[torch.Tensor],
):
    if isinstance(background_color, str) and background_color == "last_sample":
        return pred_image, "black"
    if isinstance(background_color, str) and background_color == "random":
        if uniforms is None:
            raise ValueError("a random background needs its uniforms (shape of the prediction)")
        return pred_image + uniforms * (1.0 - pred_accumulation), uniforms
    return pred_image, background_color


def blend_background_for_loss_rgb(
    pred_image: torch.Tensor,
    pred_accumulation: torch.Tensor,
    gt_image: torch.Tensor,
    background_color: Union[str, torch.Tensor] = "last_sample",
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred, gt) adjusted for the background mode; `random` draws its
    background from `uniforms` (the shape of pred_image)."""
    pred_image, bg = _loss_background(pred_image, pred_accumulation, background_color, uniforms)
    return pred_image, blend_background_rgb(gt_image, bg)


def blend_background_for_loss_rgbt(
    pred_image: torch.Tensor,  # [..., 4]
    pred_accumulation: torch.Tensor,  # [..., 1]
    gt_image: torch.Tensor,  # [..., 3] or [..., 4] (RGBA)
    is_thermal: torch.Tensor,  # [...]
    background_color: Union[str, torch.Tensor] = "last_sample",
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred RGBT, gt RGBT) for the loss."""
    pred_image, bg = _loss_background(pred_image, pred_accumulation, background_color, uniforms)
    return pred_image, blend_background_rgbt(gt_image, is_thermal, bg)
