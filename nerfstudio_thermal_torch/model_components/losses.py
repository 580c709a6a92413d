"""Losses of the nerfacto family and the thermal cross-spectral losses
(counterpart of nerfstudio_thermal_tpu/model_components/losses.py).

This slice carries what the thermal-nerfacto training step uses: mse, l1,
`masked_mean`, the proposal (interlevel) and distortion losses, and the
2x2-patch thermal losses (`tv_pixel_loss`, `pixel_grad`,
`cross_channel_loss`). As in the JAX package, the patch losses are masked
means over the static 2x2 patch layout, each patch modality-pure. The
density TV loss waits for the hash-grid slice (it samples the hash field).
"""

from typing import List

import torch

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.model_components.ray_samplers import take_below_above
from nerfstudio_thermal_torch.utils.math import cumsum

EPS = 1.0e-7


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the elements where mask is 1."""
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def ray_samples_to_sdist(ray_samples: RaySamples) -> torch.Tensor:
    """Bin edges in the normalized spacing domain, [R, S + 1]."""
    return torch.cat(
        [ray_samples.spacing_starts[..., 0], ray_samples.spacing_ends[..., -1:, 0]], dim=-1
    )


def outer(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """Sum of the y1 histogram mass within each t0 interval."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), cumsum(y1, dim=-1)], dim=-1)
    cy1_lo, _ = take_below_above(t1_starts, t0_starts, cy1[..., :-1])
    _, cy1_hi = take_below_above(t1_ends, t0_ends, cy1[..., 1:])
    return cy1_hi - cy1_lo


def lossfun_outer(t, w, t_env, w_env):
    """Proposal bound violation."""
    w_outer = outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + EPS)


def interlevel_loss(weights_list: List[torch.Tensor], ray_samples_list: List[RaySamples]):
    """MipNeRF-360 proposal loss; the last level is held fixed."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1][..., 0].detach()
    loss = 0.0
    for ray_samples, weights in zip(ray_samples_list[:-1], weights_list[:-1]):
        sdist = ray_samples_to_sdist(ray_samples)
        loss = loss + torch.mean(lossfun_outer(c, w, sdist, weights[..., 0]))
    return loss


def lossfun_distortion(t, w):
    """MipNeRF-360 distortion in s-space, in its O(S) form: with the
    midpoints ut ascending, sum_ij w_i w_j |ut_i - ut_j| =
    2 sum_i w_i (ut_i W_i - U_i), W and U exclusive prefix sums of w and
    w ut."""
    ut = (t[..., 1:] + t[..., :-1]) / 2.0
    w_acc = cumsum(w, dim=-1, exclusive=True)
    wut_acc = cumsum(w * ut, dim=-1, exclusive=True)
    loss_inter = 2.0 * torch.sum(w * (ut * w_acc - wut_acc), dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def distortion_loss(weights_list: List[torch.Tensor], ray_samples_list: List[RaySamples]):
    """Distortion of the final level."""
    c = ray_samples_to_sdist(ray_samples_list[-1])
    w = weights_list[-1][..., 0]
    return torch.mean(lossfun_distortion(c, w))


def tv_pixel_loss(pred_thermal: torch.Tensor, is_thermal: torch.Tensor) -> torch.Tensor:
    """2x2-patch total variation of the predicted thermal at RGB pixels.
    pred_thermal [N, 1] in flattened 2x2-patch order."""
    patch_size = 2
    patches = pred_thermal.reshape(-1, patch_size**2)
    rgb_mask = (1.0 - is_thermal).reshape(-1, patch_size**2)[:, 0]
    tv = (
        torch.abs(patches[:, 0] - patches[:, 1])
        + torch.abs(patches[:, 0] - patches[:, 2])
        + torch.abs(patches[:, 1] - patches[:, 3])
        + torch.abs(patches[:, 2] - patches[:, 3])
    )
    return masked_mean(tv, rgb_mask) / patch_size**2


def pixel_grad(img: torch.Tensor, patch_size: int = 2) -> torch.Tensor:
    """2x2-patch finite differences: img [N, 1] -> [4, N / 4]."""
    patches = img.reshape(-1, patch_size**2)
    return torch.stack(
        [
            patches[:, 1] - patches[:, 0],
            patches[:, 2] - patches[:, 0],
            patches[:, 3] - patches[:, 1],
            patches[:, 3] - patches[:, 2],
        ]
    )


def cross_channel_loss(
    pred_thermal: torch.Tensor, gt_rgb: torch.Tensor, is_thermal: torch.Tensor
) -> torch.Tensor:
    """L1 between the 2x2-patch gradients of the predicted thermal and of
    the grayscale GT RGB, at RGB pixels."""
    patch_size = 2
    rgb_mask = (1.0 - is_thermal).reshape(-1, patch_size**2)[:, 0]
    gt_gray = torch.mean(gt_rgb, dim=-1, keepdim=True)
    diff = torch.abs(pixel_grad(pred_thermal, patch_size) - pixel_grad(gt_gray, patch_size))
    per_patch = diff[0] + diff[1] + diff[2] + diff[3]
    return masked_mean(per_patch, rgb_mask) / patch_size**2
