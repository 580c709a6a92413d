"""NeuS: neural implicit surfaces by volume rendering
(counterpart of nerfstudio_thermal_tpu/models/neus.py).

`neus_sample`: uniform samples, then `num_up_sample_steps` rounds that
evaluate the SDF at the samples (no gradient), turn it into alphas with a
fixed variance (`rendering_sdf_with_fixed_inv_s`, base_variance * 2^it),
draw `num_samples_importance / num_up_sample_steps` new samples from those
weights and merge them in (`merge_ray_samples`: the sorted union in the
spacing domain). The field then gives NeuS's alphas at the merged samples,
composited with the 1e-7 transmittance. Each of the 1 + num_up_sample_steps
jitter draws can be passed in (`uniforms`), as the JAX package's key
splits give them.

The cos anneal rides in the trainer's extra state (`CosAnneal`, the step,
updated at the start of each step): the forward gets cos_anneal_ratio =
min(1, step / anneal_end) in f32; outside training the ratio is 1.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from nerfstudio_thermal_torch.cameras.rays import RayBundle, RaySamples, get_weights_and_transmittance_from_alphas
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.model_components.ray_samplers import pdf_sample, spaced_sample
from nerfstudio_thermal_torch.models.base_surface_model import SurfaceModel, SurfaceModelConfig
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class NeuSModelConfig(SurfaceModelConfig):
    """Field names and defaults as in the JAX package's config."""

    num_samples: int = 64
    num_samples_importance: int = 64
    num_up_sample_steps: int = 4
    base_variance: float = 64.0
    perturb: bool = True
    anneal_end: int = 50000


@dataclass
class CosAnneal:
    """The trainer's extra state of the NeuS models: the step."""

    step: int = 0


def rendering_sdf_with_fixed_inv_s(ray_samples: RaySamples, sdf: torch.Tensor, inv_s: float) -> torch.Tensor:
    """NeuS's alpha between consecutive samples with a fixed variance:
    sdf [R, S] -> alpha [R, S - 1]."""
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    deltas = ray_samples.deltas[:, :-1, 0]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (deltas + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.clamp(torch.minimum(prev_cos, cos_val), -1e3, 0.0)
    prev_esti = mid_sdf - cos_val * deltas * 0.5
    next_esti = mid_sdf + cos_val * deltas * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    return (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)


def merge_ray_samples(ray_bundle: RayBundle, s1: RaySamples, s2: RaySamples) -> RaySamples:
    """The sorted union of two sample sets' bin starts in the spacing
    domain, closed by the larger last end; no gradient."""
    starts1, starts2 = s1.spacing_starts[..., 0], s2.spacing_starts[..., 0]
    ends = torch.maximum(s1.spacing_ends[..., -1:, 0], s2.spacing_ends[..., -1:, 0])
    bins, _ = torch.sort(torch.cat([starts1, starts2], dim=-1), dim=-1)
    bins = torch.cat([bins, ends], dim=-1).detach()
    euclidean_bins = s1.spacing_to_euclidean(bins)
    return ray_bundle.get_ray_samples(
        bin_starts=euclidean_bins[..., :-1, None],
        bin_ends=euclidean_bins[..., 1:, None],
        spacing_starts=bins[..., :-1, None],
        spacing_ends=bins[..., 1:, None],
        spacing_kind=s1.spacing_kind,
        s_near=s1.s_near,
        s_far=s1.s_far,
    )


def neus_sample(
    ray_bundle: RayBundle,
    sdf_fn: Callable[[RaySamples], torch.Tensor],
    num_samples: int = 64,
    num_samples_importance: int = 64,
    num_up_sample_steps: int = 4,
    base_variance: float = 64.0,
    single_jitter: bool = True,
    train: bool = False,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    shard: Optional[RayShard] = None,
) -> RaySamples:
    """SDF-guided iterative upsampling; `uniforms` holds the 1 +
    num_up_sample_steps jitter draws (the uniform sampler's, then each
    round's); `shard`: a data-parallel rank's (ray_samplers.py)."""
    if uniforms is not None and len(uniforms) != num_up_sample_steps + 1:
        raise ValueError(f"{len(uniforms)} uniform draws for {num_up_sample_steps + 1} sampling rounds")
    draws = list(uniforms) if uniforms is not None else [None] * (num_up_sample_steps + 1)
    jitter = dict(single_jitter=single_jitter, train=train, generator=generator, shard=shard)
    ray_samples = spaced_sample(ray_bundle, num_samples, spacing_kind="uniform", train_stratified=True,
                                uniforms=draws[0], **jitter)
    for it in range(num_up_sample_steps):
        with torch.no_grad():
            sdf = sdf_fn(ray_samples)[..., 0]
        alphas = rendering_sdf_with_fixed_inv_s(ray_samples, sdf, base_variance * 2**it)
        weights, _ = get_weights_and_transmittance_from_alphas(alphas[..., None])
        weights = torch.cat([weights, torch.zeros_like(weights[:, :1])], dim=1)
        new_samples = pdf_sample(
            ray_bundle, ray_samples, weights, num_samples_importance // num_up_sample_steps,
            include_original=False, histogram_padding=1e-5, uniforms=draws[it + 1], **jitter,
        )
        ray_samples = merge_ray_samples(ray_bundle, ray_samples, new_samples)
    return ray_samples


def cos_anneal_ratio(step: int, anneal_end: int) -> float:
    """min(1, step / anneal_end) in f32."""
    f32 = np.float32
    return float(np.minimum(f32(1.0), f32(step) / f32(max(anneal_end, 1))))


class NeuSModel(SurfaceModel):
    config: NeuSModelConfig

    # the cos anneal through the trainer's extra-state hooks ------------

    def init_extra_state(self) -> CosAnneal:
        return CosAnneal()

    def update_extra_state(self, extra: CosAnneal, step: int, generator=None, draws=None) -> CosAnneal:
        return dataclasses.replace(extra, step=int(step))

    def extra_forward_kwargs(self, extra: Optional[CosAnneal]) -> Dict[str, float]:
        if extra is None:
            return {}
        return {"cos_anneal_ratio": cos_anneal_ratio(extra.step, self.config.anneal_end)}

    def sample_and_forward_field(self, ray_bundle: RayBundle, *, train: bool, uniforms, generator,
                                 cos_anneal_ratio: float, anneal: float = 1.0,
                                 shard: Optional[RayShard] = None) -> Dict:
        cfg = self.config
        ray_samples = neus_sample(
            ray_bundle, self.field.get_sdf,
            num_samples=cfg.num_samples,
            num_samples_importance=cfg.num_samples_importance,
            num_up_sample_steps=cfg.num_up_sample_steps,
            base_variance=cfg.base_variance,
            train=train, uniforms=uniforms, generator=generator, shard=shard,
        )
        field_outputs = self.field(ray_samples, train=train, return_alphas=True, cos_anneal_ratio=cos_anneal_ratio)
        weights, transmittance = get_weights_and_transmittance_from_alphas(field_outputs[FieldHeadNames.ALPHA])
        return {
            "ray_samples": ray_samples,
            "field_outputs": field_outputs,
            "weights": weights,
            "bg_transmittance": transmittance[:, -1, :],
        }
