"""Losses of the nerfacto family and the thermal cross-spectral losses
(counterpart of nerfstudio_thermal_tpu/model_components/losses.py).

The port carries what the nerfacto and thermal-nerfacto training steps
use: mse, l1, `masked_mean`, the proposal (interlevel) and distortion
losses, the radiance-field gradient scaling, the density TV loss and the
2x2-patch thermal losses (`tv_pixel_loss`, `pixel_grad`,
`cross_channel_loss`), and depth-nerfacto's depth losses (DS-NeRF, URF)
with SparseNeRF's depth ranking, and the surface models' monocular
priors (MonoSDF's normal loss, the scale- and shift-invariant depth loss).
As in the JAX package, the patch losses
are masked means over the static 2x2 patch layout, each patch
modality-pure.
"""

from typing import List, Optional

import torch

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.model_components.ray_samplers import take_below_above
from nerfstudio_thermal_torch.utils.math import cumsum, safe_normalize

EPS = 1.0e-7


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def masked_mean(values: torch.Tensor, mask: torch.Tensor, count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the elements where mask is 1. `count` replaces the mask's
    sum (a data-parallel rank passes the global count, parallel/mesh.py)."""
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask) if count is None else count, min=1.0)


def patch_rgb_mask(is_thermal: torch.Tensor, patch_size: int = 2) -> torch.Tensor:
    """1 for each patch_size x patch_size patch of RGB pixels: the mask of
    the patch losses' masked means."""
    return (1.0 - is_thermal).reshape(-1, patch_size**2)[:, 0]


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


def orientation_loss(weights: torch.Tensor, normals: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """Ref-NeRF's orientation loss per ray: the weighted squared part of
    each sample's normal that faces away from the camera. weights
    [..., S, 1], normals [..., S, 3], viewdirs [..., 3] -> [...]."""
    n_dot_v = torch.sum(normals * -viewdirs[..., None, :], dim=-1)
    return torch.sum(weights[..., 0] * torch.minimum(n_dot_v.new_zeros(()), n_dot_v) ** 2, dim=-1)


def pred_normal_loss(weights: torch.Tensor, normals: torch.Tensor, pred_normals: torch.Tensor) -> torch.Tensor:
    """The weighted disagreement (1 - cos) of the predicted and the density
    normals per ray: weights [..., S, 1], normals [..., S, 3] -> [...]."""
    return torch.sum(weights[..., 0] * (1.0 - torch.sum(normals * pred_normals, dim=-1)), dim=-1)


class _ScaleGradient(torch.autograd.Function):
    """Identity forward; the backward multiplies the cotangent by `scaling`
    (JAX's `_scale_gradient` custom_vjp)."""

    @staticmethod
    def forward(ctx, value, scaling):
        ctx.save_for_backward(scaling)
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        (scaling,) = ctx.saved_tensors
        return g * scaling, None


def scale_gradients_by_distance_squared(field_outputs: dict, ray_samples: RaySamples) -> dict:
    """Radiance-field gradient scaling for unbiased near-camera training:
    each output's gradient times clamp(mid-distance^2, 0, 1) per sample."""
    ray_dist = (ray_samples.starts + ray_samples.ends) / 2.0
    scaling = torch.clamp(ray_dist**2, 0.0, 1.0).detach()
    return {k: _ScaleGradient.apply(v, scaling) for k, v in field_outputs.items()}


def tv_density_loss(densities: torch.Tensor, num_samples: int) -> torch.Tensor:
    """L1 between the densities at points and at their 6 neighbour offsets;
    densities [7 * num_samples, 1], the points first, then the 6 neighbour
    blocks."""
    base = densities[:num_samples]
    reps = densities[num_samples:].shape[0] // num_samples
    return torch.mean(torch.abs(densities[num_samples:] - base.repeat(reps, 1)))


def tv_pixel_loss(
    pred_thermal: torch.Tensor, is_thermal: torch.Tensor, count: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """2x2-patch total variation of the predicted thermal at RGB pixels.
    pred_thermal [N, 1] in flattened 2x2-patch order; `count`: the RGB
    patches the mean divides by (default: this batch's)."""
    patch_size = 2
    patches = pred_thermal.reshape(-1, patch_size**2)
    rgb_mask = patch_rgb_mask(is_thermal, patch_size)
    tv = (
        torch.abs(patches[:, 0] - patches[:, 1])
        + torch.abs(patches[:, 0] - patches[:, 2])
        + torch.abs(patches[:, 1] - patches[:, 3])
        + torch.abs(patches[:, 2] - patches[:, 3])
    )
    return masked_mean(tv, rgb_mask, count) / patch_size**2


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
    pred_thermal: torch.Tensor, gt_rgb: torch.Tensor, is_thermal: torch.Tensor,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """L1 between the 2x2-patch gradients of the predicted thermal and of
    the grayscale GT RGB, at RGB pixels (`count`: as tv_pixel_loss's)."""
    patch_size = 2
    rgb_mask = patch_rgb_mask(is_thermal, patch_size)
    gt_gray = torch.mean(gt_rgb, dim=-1, keepdim=True)
    diff = torch.abs(pixel_grad(pred_thermal, patch_size) - pixel_grad(gt_gray, patch_size))
    per_patch = diff[0] + diff[1] + diff[2] + diff[3]
    return masked_mean(per_patch, rgb_mask, count) / patch_size**2


# Depth supervision ------------------------------------------------------

URF_SIGMA_SCALE_FACTOR = 3.0


def ds_nerf_depth_loss(weights, termination_depth, steps, lengths, sigma):
    """Depth-supervised NeRF's loss (Deng et al. 2022). As in the JAX
    package the gaussian's exponent divides by 2 sigma, not 2 sigma^2."""
    depth_mask = (termination_depth > 0).float()
    loss = -torch.log(weights + EPS) * torch.exp(-((steps - termination_depth[:, None]) ** 2) / (2 * sigma)) * lengths
    loss = torch.sum(loss, dim=-2) * depth_mask
    return torch.mean(loss)


def urban_radiance_field_depth_loss(weights, termination_depth, predicted_depth, steps, sigma):
    """Urban Radiance Fields' lidar losses (Rematas et al. 2022): expected
    depth, line-of-sight near the surface and empty space before it."""
    depth_mask = (termination_depth > 0).float()
    expected_depth_loss = (termination_depth - predicted_depth) ** 2
    std = sigma / URF_SIGMA_SCALE_FACTOR
    term = termination_depth[:, None]
    log_prob = -0.5 * ((steps - term) / std) ** 2 - torch.log(std * torch.sqrt(torch.tensor(2.0 * torch.pi)))
    near_mask = (steps <= term + sigma) & (steps >= term - sigma)
    near = torch.sum(near_mask * (weights - torch.exp(log_prob)) ** 2, dim=-2)
    empty_mask = steps < term - sigma
    empty = torch.sum(empty_mask * weights**2, dim=-2)
    return torch.mean((expected_depth_loss + near + empty) * depth_mask)


def depth_loss(
    weights,
    ray_samples: RaySamples,
    termination_depth,
    predicted_depth,
    sigma,
    directions_norm,
    is_euclidean: bool,
    depth_loss_type: str = "ds_nerf",
):
    """The depth loss of `depth_loss_type` (ds_nerf | urf). A z-depth
    (is_euclidean False) becomes a distance along the ray by the
    direction's norm before normalisation."""
    if not is_euclidean:
        termination_depth = termination_depth * directions_norm
    steps = (ray_samples.starts + ray_samples.ends) / 2.0
    if depth_loss_type == "ds_nerf":
        lengths = ray_samples.ends - ray_samples.starts
        return ds_nerf_depth_loss(weights, termination_depth, steps, lengths, sigma)
    if depth_loss_type == "urf":
        return urban_radiance_field_depth_loss(weights, termination_depth, predicted_depth, steps, sigma)
    raise NotImplementedError(f"depth loss type {depth_loss_type}")


def depth_ranking_loss(rendered_depth: torch.Tensor, gt_depth: torch.Tensor) -> torch.Tensor:
    """SparseNeRF's depth ranking over PairPixelSampler's [anchor,
    neighbour, ...] rays: the mean margin of the pairs whose rendered order
    disagrees with the GT's (NaN when none does)."""
    m = 1e-4
    dpt_diff = gt_depth[::2, :] - gt_depth[1::2, :]
    out_diff = rendered_depth[::2, :] - rendered_depth[1::2, :] + m
    differing_signs = torch.sign(dpt_diff) != torch.sign(out_diff)
    per = torch.where(differing_signs, out_diff * torch.sign(out_diff), torch.full_like(out_diff, float("nan")))
    return torch.nanmean(per)


def monosdf_normal_loss(normal_pred: torch.Tensor, normal_gt: torch.Tensor) -> torch.Tensor:
    """MonoSDF's normal prior: the L1 and the angular (1 - cos) distance of
    the unit normals, each a mean over the rays."""
    p, g = safe_normalize(normal_pred), safe_normalize(normal_gt)
    l1 = torch.mean(torch.sum(torch.abs(p - g), dim=-1))
    cos = torch.mean(1.0 - torch.sum(p * g, dim=-1))
    return l1 + cos


def normalized_depth_scale_and_shift(prediction: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """The least-squares scale and shift that align `prediction` to
    `target` over the masked entries, per leading index ([B, ...] in, [B]
    out); 0 and 0 where the system is singular (|det| <= 1e-12)."""
    dims = tuple(range(1, prediction.dim()))
    m = mask.to(prediction.dtype)
    a00 = torch.sum(m * prediction * prediction, dims)
    a01 = torch.sum(m * prediction, dims)
    a11 = torch.sum(m, dims)
    b0 = torch.sum(m * prediction * target, dims)
    b1 = torch.sum(m * target, dims)
    det = a00 * a11 - a01 * a01
    safe = torch.abs(det) > 1e-12
    det_s = torch.where(safe, det, torch.ones_like(det))
    scale = torch.where(safe, (a11 * b0 - a01 * b1) / det_s, torch.zeros_like(det))
    shift = torch.where(safe, (-a01 * b0 + a00 * b1) / det_s, torch.zeros_like(det))
    return scale, shift


def scale_and_shift_invariant_depth_loss(
    prediction: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, alpha: float = 0.5, scales: int = 4
) -> torch.Tensor:
    """MiDaS's scale- and shift-invariant depth loss on [B, H, W]: the
    prediction aligned per batch row, the masked MSE, plus alpha times the
    multi-scale gradient term (every 2^s-th pixel, s < scales)."""
    scale, shift = normalized_depth_scale_and_shift(prediction, target, mask)
    pred = prediction * scale[:, None, None] + shift[:, None, None]
    m = mask.to(pred.dtype)
    denom = torch.clamp(torch.sum(m), min=1.0)
    data = torch.sum(m * (pred - target) ** 2) / denom
    reg = 0.0
    for s in range(scales):
        step = 2**s
        p, t, mm = pred[:, ::step, ::step], target[:, ::step, ::step], m[:, ::step, ::step]
        diff = (p - t) * mm
        gx = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * mm[:, :, 1:] * mm[:, :, :-1]
        gy = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * mm[:, 1:, :] * mm[:, :-1, :]
        reg = reg + (torch.sum(gx) + torch.sum(gy)) / denom
    return data + alpha * reg
