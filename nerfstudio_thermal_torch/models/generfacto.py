"""Generfacto: text-to-3D by score distillation over a nerfacto-style field
(counterpart of nerfstudio_thermal_tpu/models/generfacto.py).

One training step renders a whole low-resolution image (render_resolution
squared rays) from the batch's random camera: a sphere collider, two hash
proposal grids, the hash `NerfactoField` (12 levels, T 2^19, to 256, no
appearance embedding, f32) with a density blob tapered over `taper_range`,
a 2 x 32 background MLP on a 4-frequency direction encoding, lambertian
shading under a random light, a random background half the time, and the
guidance's loss on the shaded image. The normals are minus the normalised
position gradient of the field's density: `torch.autograd.grad` of the
density at the samples, with its graph in training, so the orientation and
shading terms differentiate it again (the hash grid's `_HashEncodeBwdPos`
node and its VJP, `hash_encode_bwd_pos_vjp` on the card). One forward of
the field at the samples gives the density, the normals and the colour
(the JAX package runs the field three times for the same values).

The step's five draws (the light's normal, the shade and choice uniforms,
the background colour and the sampler's jitter) come from the trainer's
generator, or from `draws` where a test passes the JAX package's. The
schedules (taper, orientation weight, normals and shading start) are
functions of the step, in f32 as in the JAX step. As there, the opacity
penalty is multiplied by `opacity_loss_mult` twice, the orientation term
counts from `start_normals_training` (a zero weight before it), and an
eval render is the fixed render_resolution square whatever the camera's
size.
"""

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_thermal_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_thermal_torch.model_components import renderers
from nerfstudio_thermal_torch.model_components.losses import distortion_loss, interlevel_loss, orientation_loss
from nerfstudio_thermal_torch.model_components.ray_samplers import proposal_sample
from nerfstudio_thermal_torch.model_components.scene_colliders import SphereCollider
from nerfstudio_thermal_torch.models.base_model import Model, ModelConfig
from nerfstudio_thermal_torch.models.nerfacto import proposal_anneal
from nerfstudio_thermal_torch.ops.encodings import NeRFEncoding
from nerfstudio_thermal_torch.ops.mlp import MLP
from nerfstudio_thermal_torch.utils.math import safe_normalize

DRAW_KEYS = ("light", "shade", "background", "choice", "uniforms")
EVAL_STEP = 10**9  # an eval render's step: every schedule at its end


@dataclass
class GenerfactoModelConfig(ModelConfig):
    """Fields and defaults as in the JAX package's config."""

    prompt: str = "a high quality photo of a ripe pineapple"
    background_color: str = "white"
    orientation_loss_mult: Tuple[float, float] = (0.001, 10.0)
    orientation_loss_mult_range: Tuple[int, int] = (0, 15000)
    random_light_source: bool = True
    initialize_density: bool = True
    taper_range: Tuple[int, int] = (0, 1000)
    taper_strength: Tuple[float, float] = (1.0, 0.0)
    sphere_collider: bool = True
    random_background: bool = True
    target_transmittance_start: float = 0.4
    target_transmittance_end: float = 0.7
    transmittance_end_schedule: int = 1500
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    num_proposal_iterations: int = 2
    proposal_net_args_list: List[Dict] = dataclass_field(
        default_factory=lambda: [
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128},
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256},
        ]
    )
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 500
    use_single_jitter: bool = True
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 1.0
    start_normals_training: int = 1000
    start_lambertian_training: int = 1000
    opacity_penalty: bool = True
    opacity_loss_mult: float = 1.0
    max_res: int = 256
    top_prompt: str = ", overhead view"
    side_prompt: str = ", side view"
    front_prompt: str = ", front view"
    back_prompt: str = ", back view"
    guidance_scale: float = 20.0
    diffusion_model: str = "colormatch"  # colormatch | stablediffusion
    render_resolution: int = 64
    """Train-render side length."""
    hidden_dim: int = 64
    num_levels: int = 12
    log2_hashmap_size: int = 19
    compute_dtype: str = "float32"
    enable_collider: bool = False


def _ramp(step: int, span: Tuple[int, int], values: Tuple[float, float]) -> float:
    """values[0] -> values[1] linearly over span, clipped; in f32 as the JAX
    step computes it from its int32 step."""
    f32 = np.float32
    t0, t1 = span
    v0, v1 = values
    frac = np.clip(f32(step - t0) / f32(max(t1 - t0, 1)), f32(0), f32(1))
    return float(f32(v0) + f32(v1 - v0) * frac)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: maximum then minimum, the gradient split at a tie."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


class GenerfactoModel(Model):
    config: GenerfactoModelConfig
    is_generative = True

    def populate_modules(self) -> None:
        cfg = self.config
        compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.field = NerfactoField(
            aabb=self.scene_aabb,
            num_images=1,
            hidden_dim=cfg.hidden_dim,
            num_levels=cfg.num_levels,
            max_res=cfg.max_res,
            log2_hashmap_size=cfg.log2_hashmap_size,
            appearance_embedding_dim=0,
            use_spatial_distortion=True,
            num_channels=3,
            compute_dtype=compute_dtype,
        )
        # the background colour from the ray direction
        self.bg_encoding = NeRFEncoding(
            in_dim=3, num_frequencies=4, min_freq_exp=0.0, max_freq_exp=3.0, include_input=True
        )
        self.field_background = MLP(
            in_dim=self.bg_encoding.out_dim, num_layers=2, layer_width=32, out_dim=3,
            out_activation="sigmoid", compute_dtype=compute_dtype,
        )
        self.proposal_networks = nn.ModuleList(
            HashMLPDensityField(
                aabb=self.scene_aabb, use_spatial_distortion=True,
                **{k: v for k, v in args.items() if k != "use_linear"},
            )
            for args in cfg.proposal_net_args_list[: cfg.num_proposal_iterations]
        )
        self.collider = SphereCollider(center=(0.0, 0.0, 0.0), radius=1.0) if cfg.sphere_collider else None
        self.guidance = None  # built at first use (it may need external weights)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)
        self.field_background.reset_parameters(generator)
        for net in self.proposal_networks:
            net.reset_parameters(generator)

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        return {
            "fields": list(self.field.parameters()),
            "field_background": list(self.field_background.parameters()),
            "proposal_networks": list(self.proposal_networks.parameters()),
        }

    def get_guidance(self):
        if self.guidance is None:
            from nerfstudio_thermal_torch.generative.guidance import build_guidance

            cfg = self.config
            kwargs = (
                {"guidance_scale": cfg.guidance_scale, "sd_version": "1-5"}
                if cfg.diffusion_model == "stablediffusion" else {}
            )
            self.guidance = build_guidance(cfg.diffusion_model, **kwargs)
            p = cfg.prompt
            self.prompt_embeddings = self.guidance.embed_prompts(
                p, p + cfg.top_prompt, p + cfg.side_prompt, p + cfg.front_prompt, p + cfg.back_prompt
            )
        return self.guidance

    def _density_and_normals(self, positions: torch.Tensor, train: bool):
        """(density [..., 1], geo features, normals [..., 3]) at world
        positions: one forward of the field's density network, and the
        normals minus the normalised gradient of the summed density (each
        sample's own), with its graph in training."""
        with torch.enable_grad():
            x = positions.detach().requires_grad_(True)
            density, geo = self.field.get_density(x)
            (grad,) = torch.autograd.grad(density, x, grad_outputs=torch.ones_like(density), create_graph=train)
        return density, geo, -safe_normalize(grad)

    def _draws(self, draws: Optional[Dict], generator: Optional[torch.Generator], device) -> Dict:
        """The step's five draws: `draws` as given, or from the generator in
        the order light, shade, background, choice (the sampler draws its
        own jitter)."""
        if draws is not None:
            return {k: draws.get(k) for k in DRAW_KEYS}
        return {
            "light": torch.randn(3, generator=generator, device=device),
            "shade": torch.rand((), generator=generator, device=device),
            "background": torch.rand(3, generator=generator, device=device),
            "choice": torch.rand((), generator=generator, device=device),
            "uniforms": None,
        }

    def generative_forward(
        self, batch, *, step: int, train: bool = True, draws: Optional[Dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict:
        """Render the res x res image of the batch's camera (c2w [3, 4],
        focal) and every generfacto output. draws: {"light": (3,) normal,
        "shade": (), "background": (3,), "choice": () uniforms, "uniforms":
        the sampler's jitter, one [R, 1] draw per level}."""
        cfg = self.config
        res = cfg.render_resolution
        device = self.device
        c2w = batch["c2w"].to(device)
        focal = torch.as_tensor(batch["focal"], dtype=torch.float32, device=device)
        ys, xs = torch.meshgrid(
            torch.arange(res, dtype=torch.float32, device=device) + 0.5,
            torch.arange(res, dtype=torch.float32, device=device) + 0.5,
            indexing="ij",
        )
        dirs_cam = torch.stack([(xs - res / 2) / focal, -(ys - res / 2) / focal, -torch.ones_like(xs)], -1)
        dirs_cam = dirs_cam.reshape(-1, 3)
        dirs_cam = dirs_cam / torch.linalg.vector_norm(dirs_cam, dim=-1, keepdim=True)
        dirs = dirs_cam @ c2w[:3, :3].T
        n = res * res
        bundle = RayBundle(
            origins=c2w[:3, 3].expand(n, 3),
            directions=dirs,
            pixel_area=((1.0 / focal) ** 2).expand(n, 1),
            camera_indices=torch.zeros((n, 1), dtype=torch.int32, device=device),
        )
        if self.collider is not None:
            bundle = self.collider(bundle, train=train)
        d = self._draws(draws, generator, device) if train else {}

        ray_samples, weights_list, ray_samples_list = proposal_sample(
            bundle,
            [lambda samples, net=net: net(ray_samples=samples) for net in self.proposal_networks],
            num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
            num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
            initial_spacing_kind="uniform",
            single_jitter=cfg.use_single_jitter,
            anneal=proposal_anneal(step, cfg.proposal_weights_anneal_max_num_iters, cfg.proposal_weights_anneal_slope),
            updated=True,
            train=train,
            uniforms=d.get("uniforms"),
            generator=generator,
        )
        positions = ray_samples.get_positions()
        density, geo, normals = self._density_and_normals(positions, train)
        rgb_raw = self.field.get_outputs(ray_samples, geo, train=train)

        # the density blob and its taper; a smoothed norm, as the cameras
        # look through the origin
        if cfg.initialize_density:
            strength = _ramp(step, cfg.taper_range, cfg.taper_strength)
            r = torch.sqrt(torch.sum(positions**2, dim=-1) + 1e-8)
            blob = strength * (-torch.exp(r / 0.4) + 2)[..., None]
            density = torch.maximum(density + blob, density.new_zeros(()))

        weights = ray_samples.get_weights(density)
        weights_list = weights_list + [weights]
        ray_samples_list = ray_samples_list + [ray_samples]

        accumulation = _clip(torch.nan_to_num(renderers.render_accumulation(weights)), 0.0, 1.0)
        depth = renderers.render_depth_expected(weights, ray_samples)
        rgb = renderers.render_rgb(rgb_raw, weights, background_color="black", train=train)
        rendered_normals = renderers.render_normals(normals, weights)

        bg_rgb = self.field_background(self.bg_encoding(dirs).float())
        accum_inv = 1.0 - accumulation
        background = accum_inv * bg_rgb

        outputs = {
            "rgb": accumulation * rgb + background,
            "accumulation": accumulation,
            "depth": depth,
            "expected_depth": depth,
            "normals": rendered_normals,
            "background_rgb": bg_rgb,
            "rendered_orientation_loss": orientation_loss(weights.detach(), normals, dirs),
        }
        if cfg.opacity_penalty:
            outputs["opacity_loss"] = torch.sqrt(torch.sum(weights, dim=-2) ** 2 + 0.01) * cfg.opacity_loss_mult
        if not train:
            return outputs

        # lambertian shading under a random light, and a random background
        # half the time
        eye = c2w[:3, 3]
        light_d = safe_normalize(eye + d["light"] if cfg.random_light_source else eye)
        lambertian = _clip(torch.sum(rendered_normals * light_d, dim=-1, keepdim=True), 0.0, 1.0)
        on = torch.as_tensor(step >= cfg.start_lambertian_training, device=device) & (d["shade"] > 0.75)
        shading_weight = torch.where(on, 0.9, 0.0)
        shade = (1.0 - shading_weight) + shading_weight * lambertian
        shaded = accumulation * rgb * shade
        shaded_albedo = accumulation * rgb * ((1.0 - shading_weight) + shading_weight * shade.detach())
        use_rand_bg = (d["choice"] < 0.5) & torch.as_tensor(cfg.random_background, device=device)
        bg_used = torch.where(use_rand_bg, accum_inv * d["background"][None], background)
        outputs["train_output"] = torch.where(
            shading_weight > 0,
            torch.where(d["choice"] > 0.5, shaded, shaded_albedo + bg_used),
            accumulation * rgb + bg_used,
        )
        outputs["weights_list"] = weights_list
        outputs["ray_samples_list"] = ray_samples_list
        return outputs

    def generative_loss(self, outputs, batch, *, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.config
        res = cfg.render_resolution
        train_normals = step >= cfg.start_normals_training
        mult = _ramp(step, cfg.orientation_loss_mult_range, cfg.orientation_loss_mult) if train_normals else 0.0
        loss_dict = {"orientation_loss": mult * torch.mean(outputs["rendered_orientation_loss"])}
        if cfg.opacity_penalty:
            loss_dict["opacity_loss"] = cfg.opacity_loss_mult * torch.mean(outputs["opacity_loss"])
        guidance = self.get_guidance()
        loss_dict["sds_loss"] = guidance.sds_loss(
            self.prompt_embeddings, outputs["train_output"].reshape(res, res, 3),
            vertical=batch["vertical"], horizontal=batch["central"], guidance_scale=cfg.guidance_scale,
        )
        loss_dict["distortion_loss"] = cfg.distortion_loss_mult * distortion_loss(
            outputs["weights_list"], outputs["ray_samples_list"]
        )
        loss_dict["interlevel_loss"] = cfg.interlevel_loss_mult * interlevel_loss(
            outputs["weights_list"], outputs["ray_samples_list"]
        )
        return loss_dict

    @torch.no_grad()
    def render_camera_device(self, cameras, camera_index: int, width=None, height=None, crop_aabb=None,
                             include_per_sample: bool = False) -> Dict[str, torch.Tensor]:
        """The fixed res x res render of a stored camera (its pose and fx),
        [res, res, C] on the device; width, height, crop_aabb and
        include_per_sample are accepted and ignored, as in the JAX package."""
        batch = {"c2w": cameras.camera_to_worlds[camera_index], "focal": cameras.fx[camera_index]}
        out = self.generative_forward(batch, step=EVAL_STEP, train=False)
        res = self.config.render_resolution
        return {
            k: v.reshape(res, res, -1)
            for k, v in out.items()
            if k in ("rgb", "accumulation", "depth", "expected_depth", "normals")
        }

    @torch.no_grad()
    def get_outputs_for_camera(self, cameras, camera_index: int, width=None, height=None, crop_aabb=None,
                               include_per_sample: bool = False) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.render_camera_device(cameras, camera_index).items()}
