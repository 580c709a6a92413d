"""RGBT packing (counterpart of nerfstudio_thermal_tpu/utils/rgbt_utils.py).

A per-ray 3-channel GT batch becomes 4-channel RGBT with is_thermal: the
RGB channels are zeroed on thermal pixels, channel 3 takes channel 0 of
thermal pixels.
"""

import torch


def rgb_to_rgbt_image(image: torch.Tensor, is_thermal: torch.Tensor) -> torch.Tensor:
    """[..., 3] + is_thermal [...] -> [..., 4]."""
    is_rgb = (1.0 - is_thermal)[..., None]
    rgb = image[..., :3] * is_rgb
    t = (image[..., 0] * is_thermal)[..., None]
    return torch.cat([rgb, t], dim=-1)
