"""Ray samplers, eval mode (counterpart of nerfstudio_thermal_tpu/model_components/ray_samplers.py).

The JAX package writes its sorted lookups as gather-free comparison counts
(`take_below_above`) for the TPU. Here they are `torch.searchsorted` plus a
gather, which select the same elements: with `right=True` an entry equal to
the query counts as below it, exactly as the comparison `a <= v` does, and
indices clamp to the first/last element as the masked reductions do.

Stratified jitter is a training feature and arrives with the training
slice; these samplers are deterministic.
"""

from typing import Callable, List, Sequence, Tuple

import torch

from nerfstudio_thermal_torch.cameras.rays import RayBundle, RaySamples, spacing_fn, spacing_fn_inv
from nerfstudio_thermal_torch.utils.math import cumsum


def take_below_above(
    a: torch.Tensor,  # [..., M] sorted ascending
    v: torch.Tensor,  # [..., K] queries
    values: torch.Tensor,  # [..., M] aligned with a
    side: str = "right",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """values at clip(searchsorted(a, v) - 1) and clip(searchsorted(a, v))."""
    idx = torch.searchsorted(a.contiguous(), v.contiguous(), right=side == "right")
    m = a.shape[-1]
    below = torch.gather(values, -1, torch.clamp(idx - 1, min=0))
    above = torch.gather(values, -1, torch.clamp(idx, max=m - 1))
    return below, above


def _check_eval(train: bool) -> None:
    if train:
        raise NotImplementedError(
            "stratified (training) sampling arrives with the training slice of the port"
        )


def spaced_sample(
    ray_bundle: RayBundle,
    num_samples: int,
    spacing_kind: str = "uniform",
    train: bool = False,
) -> RaySamples:
    """Samples evenly spaced in the warped spacing domain."""
    _check_eval(train)
    num_rays = ray_bundle.origins.shape[0]
    bins = torch.linspace(
        0.0, 1.0, num_samples + 1, dtype=torch.float32, device=ray_bundle.origins.device
    )[None, :].expand(num_rays, num_samples + 1)
    s_near = spacing_fn(spacing_kind, ray_bundle.nears)  # [R, 1]
    s_far = spacing_fn(spacing_kind, ray_bundle.fars)
    euclidean_bins = spacing_fn_inv(spacing_kind, bins * s_far + (1.0 - bins) * s_near)
    return ray_bundle.get_ray_samples(
        bin_starts=euclidean_bins[..., :-1, None],
        bin_ends=euclidean_bins[..., 1:, None],
        spacing_starts=bins[..., :-1, None],
        spacing_ends=bins[..., 1:, None],
        spacing_kind=spacing_kind,
        s_near=s_near,
        s_far=s_far,
    )


def pdf_sample(
    ray_bundle: RayBundle,
    ray_samples: RaySamples,
    weights: torch.Tensor,  # [R, S, 1]
    num_samples: int,
    include_original: bool = True,
    histogram_padding: float = 0.01,
    train: bool = False,
    eps: float = 1e-5,
) -> RaySamples:
    """Inverse-CDF resampling in the spacing domain."""
    _check_eval(train)
    num_bins = num_samples + 1
    w = weights[..., 0] + histogram_padding  # [R, S]
    weights_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.relu(eps - weights_sum)
    w = w + padding / w.shape[-1]
    weights_sum = weights_sum + padding

    pdf = w / weights_sum
    cdf = torch.clamp(cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, S+1]

    u = torch.linspace(
        0.0, 1.0 - 1.0 / num_bins, num_bins, dtype=torch.float32, device=cdf.device
    )
    u = (u + 1.0 / (2 * num_bins)).expand(*cdf.shape[:-1], num_bins)

    existing_bins = torch.cat(
        [ray_samples.spacing_starts[..., 0], ray_samples.spacing_ends[..., -1:, 0]], dim=-1
    )  # [R, S+1]
    cdf_g0, cdf_g1 = take_below_above(cdf, u, cdf)
    bins_g0, bins_g1 = take_below_above(cdf, u, existing_bins)

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0.0, 1.0)
    bins = bins_g0 + t * (bins_g1 - bins_g0)
    if include_original:
        bins, _ = torch.sort(torch.cat([existing_bins, bins], dim=-1), dim=-1)
    bins = bins.detach()

    euclidean_bins = ray_samples.spacing_to_euclidean(bins)
    return ray_bundle.get_ray_samples(
        bin_starts=euclidean_bins[..., :-1, None],
        bin_ends=euclidean_bins[..., 1:, None],
        spacing_starts=bins[..., :-1, None],
        spacing_ends=bins[..., 1:, None],
        spacing_kind=ray_samples.spacing_kind,
        s_near=ray_samples.s_near,
        s_far=ray_samples.s_far,
    )


def proposal_sample(
    ray_bundle: RayBundle,
    density_fns: Sequence[Callable[[RaySamples], torch.Tensor]],
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96),
    num_nerf_samples_per_ray: int = 48,
    initial_spacing_kind: str = "piecewise",
    anneal: float = 1.0,
    train: bool = False,
) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
    """Hierarchical proposal sampling: one density fn per proposal level,
    each fed the RaySamples of its level; `anneal` exponentiates the weights
    between levels. Returns (final samples, weights list, samples list)."""
    _check_eval(train)
    n = len(num_proposal_samples_per_ray)
    if len(density_fns) != n:
        raise ValueError(f"{len(density_fns)} density fns for {n} proposal levels")
    weights_list: List[torch.Tensor] = []
    samples_list: List[RaySamples] = []
    weights = None
    ray_samples = None
    for i_level in range(n + 1):
        is_prop = i_level < n
        num_samples = num_proposal_samples_per_ray[i_level] if is_prop else num_nerf_samples_per_ray
        if i_level == 0:
            ray_samples = spaced_sample(ray_bundle, num_samples, spacing_kind=initial_spacing_kind)
        else:
            ray_samples = pdf_sample(
                ray_bundle, ray_samples, torch.pow(weights, anneal), num_samples,
                include_original=False,
            )
        if is_prop:
            density = density_fns[i_level](ray_samples)
            weights = ray_samples.get_weights(density)
            weights_list.append(weights)
            samples_list.append(ray_samples)
    return ray_samples, weights_list, samples_list
