"""ThermalNerfacto, eval and training
(counterpart of nerfstudio_thermal_tpu/models/thermal_nerfacto.py).

Three density modes, the paper's ablations among them:
- `separate` (the default): two full pipelines, RGB and thermal, each with
  its own proposal stack and field; each modality's rays go through its
  shared camera optimizer (off unless configured) and, in training, its
  per-camera optimizer (frozen on the other modality's cameras). The
  cross-field densities (each field at the other's samples) feed the
  cross-spectral density loss in training, on a ray prefix of
  `density_loss_rays_fraction`, and the "removal" renderings at eval,
  which keep only the samples whose RGB and thermal densities agree and
  reuse the per-sample colours of the render passes. The base MLP runs 4
  times per step or eval chunk.
- `shared`: one field with a 4-channel RGBT head ("rgbt", split into "rgb"
  and "rgb_thermal"), one proposal stack, the RGB camera optimizers only.
- `rgb_only`: one 3-channel field; the thermal loss, pixel TV and
  cross-channel losses and the thermal PSNR are left out.

The density TV losses (`tv_rgb_loss_mult`, `tv_thermal_loss_mult`; the
thermal one in separate mode only) sample `num_density_tv_samples` points
in the aabb with their 6 neighbours (`NerfactoField.sample_and_density`).

A data-parallel rank (`shard`, a parallel/mesh.py `RayShard`) returns
its contributions to the global batch's losses and metrics, which sum
over the ranks to them: nerfacto's (models/nerfacto.py), the patch
losses' masked means over the global count, the cross-density prefix's k
from the global ray count (a rank evaluates its own rows of it, possibly
none), the density TV loss on the main rank only, and the masked PSNRs
from summed squared errors. Its samplers draw the global batch's jitter
and keep its rows. Without a shard the model runs the same code over
`RayShard.full` (every row, weight 1, nothing to reduce), which gives
the plain values bit for bit.

`fused_modalities` (separate mode; off by default as in the JAX package,
where it vmaps both modalities' training pipelines over one stacked axis)
gives the thermal field a 3-channel head, channel 0 the thermal value, so
that its parameters have the RGB field's layout. The port runs it on the
sequential path: every field and proposal net is a kernel launched once
per modality with that modality's weights either way, and JAX's fused
outputs are the sequential outputs of the same parameters and jitter.
"""

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, Optional, Sequence

import torch

from nerfstudio_thermal_torch.cameras.camera_optimizers import (
    CameraOptimizerConfig,
    build_camera_optimizer,
)
from nerfstudio_thermal_torch.cameras.rays import RayBundle, map_tensors
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.fields.nerfacto_field import ThermalNerfactoField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.losses import (
    cross_channel_loss,
    distortion_loss,
    interlevel_loss,
    l1_loss,
    mse_loss,
    patch_rgb_mask,
    scale_gradients_by_distance_squared,
    tv_density_loss,
    tv_pixel_loss,
)
from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class ThermalNerfactoModelConfig(NerfactoModelConfig):
    density_loss_mult: float = 5e-5
    density_mode: str = "separate"  # rgb_only | shared | separate
    rgb_density_loss_mult: float = 0.01
    density_loss_rays_fraction: float = 1.0
    """Fraction of the (randomly ordered) ray batch the cross-spectral
    density L1 sees in training: the cross evals run on the first
    max(int(R * frac) // 256 * 256, min(256, R)) rays."""
    thermal_loss_mult: float = 100.0
    tv_rgb_loss_mult: float = 0.0
    tv_thermal_loss_mult: float = 0.0
    num_density_tv_samples: int = 5000
    tv_pixel_loss_mult: float = 1e-6
    cross_channel_loss_mult: float = 1e-6
    removal_min_density_diff: float = 0.05
    use_proposal_thermal_weight_anneal: bool = False
    fused_modalities: bool = False
    camera_optimizer_thermal: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="SO3xR3", penalty_scale=10)
    )
    shared_camera_optimizer: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="shared_SO3xR3", penalty_scale=-1)
    )
    shared_camera_optimizer_thermal: CameraOptimizerConfig = dataclass_field(
        default_factory=lambda: CameraOptimizerConfig(mode="shared_SO3xR3", penalty_scale=-1)
    )


def _removal(density, cross_density, rgb_samples, ray_samples, diff, background_color):
    """Composite only the samples whose relative cross-spectral density
    difference is below `diff`. A zero density gives an infinite ratio
    (never kept) instead of NaN."""
    ratio = torch.where(
        density > 0,
        cross_density / torch.clamp(density, min=1e-30),
        torch.full_like(density, float("inf")),
    )
    mask = torch.abs(1.0 - ratio) < diff
    weights = ray_samples.get_weights(density * mask)
    return renderers.render_rgb(rgb_samples, weights, background_color=background_color, train=False)


def draw_tv_uniforms(num_points: int, generator: torch.Generator) -> torch.Tensor:
    """The density TV loss's points, U[0, 1) [num_points, 3] from the
    step's generator (the JAX package draws them from its loss key)."""
    return torch.rand((num_points, 3), generator=generator, device=generator.device)


class ThermalNerfactoModel(NerfactoModel):
    config: ThermalNerfactoModelConfig

    def cross_density_rays(self, num_rays: int, train: bool) -> int:
        """The cross-spectral density loss's ray prefix of a batch of
        num_rays (training: density_loss_rays_fraction; eval: every ray)."""
        frac = self.config.density_loss_rays_fraction if train else 1.0
        return max(int(num_rays * frac) // 256 * 256, min(256, num_rays)) if frac < 1.0 else num_rays

    def populate_modules(self) -> None:
        cfg = self.config
        if cfg.density_mode not in ("separate", "shared", "rgb_only"):
            raise ValueError(f"density_mode={cfg.density_mode!r}: one of separate, shared, rgb_only")
        self._populate_common()
        separate = cfg.density_mode == "separate"
        self.output_suffixes = ("", "_thermal") if separate else ("",)
        self.field = ThermalNerfactoField(
            **self._field_kwargs(), num_channels=3 + (cfg.density_mode == "shared")
        )

        # each modality's optimizers are frozen on the other modality's cameras
        is_thermal = list(self.metadata.get("is_thermal", [0] * self.num_train_data))
        thermal_idx = tuple(i for i, t in enumerate(is_thermal) if t != 0)
        rgb_idx = tuple(i for i, t in enumerate(is_thermal) if t == 0)
        n = self.num_train_data
        self.camera_optimizer = build_camera_optimizer(
            cfg.camera_optimizer, n, non_trainable_camera_indices=thermal_idx
        )
        self.shared_camera_optimizer = build_camera_optimizer(
            cfg.shared_camera_optimizer, n, non_trainable_camera_indices=thermal_idx,
            suffix="_shared",
        )
        if not separate:
            return
        # fused_modalities: a 3-channel head, channel 0 the thermal value
        self.field_thermal = ThermalNerfactoField(
            **self._field_kwargs(), num_channels=3 if cfg.fused_modalities else 1
        )
        # one net per iteration, use_same_proposal_network or not (as in JAX)
        self.proposal_networks_thermal = self._build_proposal_nets(shared=False)
        self.camera_optimizer_thermal = build_camera_optimizer(
            cfg.camera_optimizer_thermal, n, non_trainable_camera_indices=rgb_idx,
            suffix="_thermal",
        )
        self.shared_camera_optimizer_thermal = build_camera_optimizer(
            cfg.shared_camera_optimizer_thermal, n, non_trainable_camera_indices=rgb_idx,
            suffix="_shared_thermal",
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        if self.config.density_mode == "separate":
            self.field_thermal.reset_parameters(generator)
            for net in self.proposal_networks_thermal:
                net.reset_parameters(generator)

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        *,
        train: bool = False,
        anneal: float = 1.0,
        updated: bool = True,
        anneal_thermal: float = 1.0,
        updated_thermal: bool = True,
        uniforms: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
        generator: Optional[torch.Generator] = None,
        shard: Optional[RayShard] = None,
    ) -> Dict[str, torch.Tensor]:
        """uniforms: {"rgb": [...], "thermal": [...]}, one jitter draw per
        sampling level of each modality (training); without them the
        jitter comes from `generator` (rgb's levels, then thermal's). With
        `shard` the jitter is its rows of the global batch's draw and the
        cross densities cover its rows of the global prefix (the keys are
        absent when it has none)."""
        cfg = self.config
        separate = cfg.density_mode == "separate"
        uniforms = uniforms or {}

        bundle_rgb = self.shared_camera_optimizer.apply_to_raybundle(ray_bundle)
        if train:
            bundle_rgb = self.camera_optimizer.apply_to_raybundle(bundle_rgb)
        ray_samples, weights_list, ray_samples_list = self._sample(
            bundle_rgb, self.proposal_networks, train, anneal, updated,
            uniforms.get("rgb"), generator, shard,
        )
        outputs, weights_list, ray_samples_list = self._get_outputs_for_field(
            self.field, ray_samples, weights_list, ray_samples_list, train=train,
            keep_sample_rgb=separate,
        )
        if train:
            outputs["weights_list"] = weights_list
            outputs["ray_samples_list"] = ray_samples_list
        if cfg.density_mode == "shared":
            rgbt = outputs["rgb"]
            outputs["rgbt"] = rgbt
            outputs["rgb"] = rgbt[..., :3]
            outputs["rgb_thermal"] = rgbt[..., 3:]
        if not separate:
            return outputs

        bundle_t = self.shared_camera_optimizer_thermal.apply_to_raybundle(ray_bundle)
        if train:
            bundle_t = self.camera_optimizer_thermal.apply_to_raybundle(bundle_t)
        ray_samples_t, weights_list_t, ray_samples_list_t = self._sample(
            bundle_t, self.proposal_networks_thermal, train, anneal_thermal, updated_thermal,
            uniforms.get("thermal"), generator, shard,
        )
        thermal_outputs, weights_list_t, ray_samples_list_t = self._get_outputs_for_field(
            self.field_thermal, ray_samples_t, weights_list_t, ray_samples_list_t, train=train,
            keep_sample_rgb=True,
        )
        for k, v in thermal_outputs.items():
            # fused_modalities pads the thermal head to 3 channels
            outputs[f"{k}_thermal"] = v[..., :1] if k == "rgb" else v

        if cfg.density_loss_mult > 0 or not train:
            # cross-field densities: each field at the other field's samples,
            # in training on a ray prefix (rays are randomly ordered)
            rows = shard or RayShard.full(ray_bundle.origins.shape[0])
            k = rows.prefix(self.cross_density_rays(rows.num_rays, train))
            prefix = lambda t: t[:k]  # noqa: E731
            samples_t_k, samples_k = map_tensors(ray_samples_t, prefix), map_tensors(ray_samples, prefix)
            for name, field, samples in (
                ("density2", self.field, samples_t_k),
                ("density2_thermal", self.field_thermal, samples_k),
            ) if k > 0 else ():
                density, _ = field.get_density_from_rays(samples)
                if cfg.use_gradient_scaling:
                    density = scale_gradients_by_distance_squared(
                        {FieldHeadNames.DENSITY: density}, samples
                    )[FieldHeadNames.DENSITY]
                outputs[name] = density

        if train:
            outputs["weights_list_thermal"] = weights_list_t
            outputs["ray_samples_list_thermal"] = ray_samples_list_t
            return outputs

        diff = cfg.removal_min_density_diff
        rgb_samples = outputs.pop("rgb_samples")
        rgb_samples_t = outputs.pop("rgb_samples_thermal")
        outputs["removal"] = _removal(
            outputs["density"], outputs["density2_thermal"], rgb_samples[..., :3],
            ray_samples, diff, cfg.background_color,
        )
        # Reference quirk kept on purpose: removal_thermal composites the
        # thermal densities with the RGB hierarchy's sample deltas.
        outputs["removal_thermal"] = _removal(
            outputs["density_thermal"], outputs["density2"], rgb_samples_t[..., :1],
            ray_samples, diff, cfg.background_color,
        )
        return outputs

    def _active_camera_optimizers(self):
        opts = (
            self.camera_optimizer,
            self.shared_camera_optimizer,
            getattr(self, "camera_optimizer_thermal", None),
            getattr(self, "shared_camera_optimizer_thermal", None),
        )
        return [opt for opt in opts if opt is not None and opt.mode != "off"]

    def get_metrics_dict(
        self, outputs, batch, train: bool = True, shard: Optional[RayShard] = None
    ) -> Dict[str, torch.Tensor]:
        is_thermal = batch["is_thermal"]
        shard = self._shard(shard, batch)
        gt = renderers.blend_background_rgbt(
            batch["image"], is_thermal, background_color=self.config.background_color
        )
        metrics = {"psnr_rgb": shard.psnr(outputs["rgb"], gt[..., :3], (1.0 - is_thermal)[..., None])}
        if self.config.density_mode != "rgb_only":
            metrics["psnr_thermal"] = shard.psnr(outputs["rgb_thermal"], gt[..., 3:], is_thermal[..., None])
        if train:
            metrics["distortion"] = sum(
                distortion_loss(outputs[f"weights_list{s}"], outputs[f"ray_samples_list{s}"])
                for s in self.output_suffixes
            ) * shard.weight
            metrics.update(self._camera_metrics(shard))
        return metrics

    def _tv_density(self, field, key: str, tv_uniforms, generator, shard: RayShard) -> Optional[torch.Tensor]:
        """The density TV loss of one field (unscaled), at tv_uniforms[key]
        ([P, 3] in [0, 1)) or at points drawn from `generator`; None when
        neither is given (the JAX package skips it without a loss key).
        A rank other than the main one draws the points and contributes 0."""
        cfg = self.config
        n = cfg.num_density_tv_samples
        uniforms = (tv_uniforms or {}).get(key)
        if uniforms is None:
            if generator is None:
                return None
            uniforms = draw_tv_uniforms(n, generator)
        if not shard.main:
            return torch.zeros((), device=field.aabb.device)
        dens = field.sample_and_density(uniforms.to(field.aabb.device), float(cfg.max_res))
        return tv_density_loss(dens, n)

    def get_loss_dict(
        self, outputs, batch, metrics_dict, *, train: bool = True,
        background_uniforms: Optional[torch.Tensor] = None,
        tv_uniforms: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        shard: Optional[RayShard] = None,
    ) -> Dict[str, torch.Tensor]:
        """tv_uniforms: {"rgb": [P, 3], "thermal": [P, 3]}, the density TV
        loss's points (training); without them they come from `generator`.
        With `shard`: this rank's contributions (the module docstring)."""
        cfg = self.config
        is_thermal = batch["is_thermal"]
        shard = self._shard(shard, batch)
        weight = shard.weight
        rgb_only = cfg.density_mode == "rgb_only"
        thermal = torch.zeros_like(outputs["rgb"][..., :1]) if rgb_only else outputs["rgb_thermal"]
        pred4 = torch.cat([outputs["rgb"], thermal], dim=-1)
        pred_rgb, gt_rgb = renderers.blend_background_for_loss_rgbt(
            pred4, outputs["accumulation"], batch["image"], is_thermal,
            background_color=cfg.background_color, uniforms=background_uniforms,
        )
        loss_dict = {}
        if train:
            tv_fields = [("tv_rgb_loss", cfg.tv_rgb_loss_mult, "field", "rgb")]
            if cfg.density_mode == "separate":
                tv_fields.append(("tv_thermal_loss", cfg.tv_thermal_loss_mult, "field_thermal", "thermal"))
            for name, mult, attr, key in tv_fields:
                if mult > 0:
                    tv = self._tv_density(getattr(self, attr), key, tv_uniforms, generator, shard)
                    if tv is not None:
                        loss_dict[name] = mult * tv
        # masked channels, mean over the whole batch (as the reference does)
        rgb_mask = (1.0 - is_thermal)[:, None]
        loss_dict["rgb_loss"] = mse_loss(gt_rgb[..., :3] * rgb_mask, pred_rgb[..., :3] * rgb_mask) * weight
        if not rgb_only:
            t_mask = is_thermal[:, None]
            loss_dict["thermal_loss"] = cfg.thermal_loss_mult * mse_loss(
                gt_rgb[..., 3:] * t_mask, pred_rgb[..., 3:] * t_mask
            ) * weight
        if cfg.density_mode == "separate" and cfg.density_loss_mult > 0 and "density2" not in outputs:
            # no row of this rank lies in the global prefix
            loss_dict["density_loss"] = outputs["rgb"].new_zeros(())
        elif cfg.density_mode == "separate" and cfg.density_loss_mult > 0:
            # cross-spectral density L1 with the asymmetric detach; the cross
            # evals may cover a ray prefix
            d2, d2t = outputs["density2"], outputs["density2_thermal"]
            k = d2.shape[0]
            d, dt = outputs["density"][:k], outputs["density_thermal"][:k]
            if cfg.rgb_density_loss_mult == 1:
                density_loss = l1_loss(d2, dt) + l1_loss(d, d2t)
                loss_dict["density_loss"] = cfg.density_loss_mult * density_loss
            else:
                density_loss = l1_loss(d2.detach(), dt) + l1_loss(d.detach(), d2t)
                density_loss_rgb = l1_loss(d2, dt.detach()) + l1_loss(d, d2t.detach())
                loss_dict["density_loss"] = cfg.density_loss_mult * (
                    density_loss + cfg.rgb_density_loss_mult * density_loss_rgb
                )
            # this rank's rows' share of the mean over the global prefix
            loss_dict["density_loss"] = loss_dict["density_loss"] * (
                k / self.cross_density_rays(shard.num_rays, train)
            )
        if not rgb_only and (cfg.tv_pixel_loss_mult > 0 or cfg.cross_channel_loss_mult > 0):
            # the patch losses' masked means divide by the global batch's RGB patches
            count = shard.global_sum(torch.sum(patch_rgb_mask(is_thermal)))
        if not rgb_only and cfg.tv_pixel_loss_mult > 0:
            loss_dict["tv_pixel_loss"] = cfg.tv_pixel_loss_mult * tv_pixel_loss(pred_rgb[..., 3:], is_thermal, count)
        if not rgb_only and cfg.cross_channel_loss_mult > 0:
            loss_dict["cross_channel_loss"] = cfg.cross_channel_loss_mult * cross_channel_loss(
                pred_rgb[..., 3:], gt_rgb[..., :3], is_thermal, count
            )
        if train:
            il = 0.0
            dl = 0.0
            for s in self.output_suffixes:
                il = il + cfg.interlevel_loss_mult * interlevel_loss(
                    outputs[f"weights_list{s}"], outputs[f"ray_samples_list{s}"]
                )
                # the JAX package adds the summed distortion once per modality
                dl = dl + cfg.distortion_loss_mult * metrics_dict["distortion"]
            loss_dict["interlevel_loss"] = il * weight
            loss_dict["distortion_loss"] = dl  # the distortion metric is this rank's contribution already
            loss_dict.update(self._camera_losses(shard))
        return loss_dict
