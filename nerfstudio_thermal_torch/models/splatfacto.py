"""Splatfacto: 3D Gaussian Splatting
(counterpart of nerfstudio_thermal_tpu/models/splatfacto.py).

Gaussians live in fixed-capacity parameters (`max_num_gaussians` rows)
with an `alive` mask in the trainer's extra state; refinement (split,
duplicate, cull, opacity reset) edits rows in place every `refine_every`
steps, filling free slots, so no shape ever changes. A frame is one
projection of every gaussian (EWA: J W cov3d W^T J^T + 0.3 I), SH colours
from the camera centre, and one of two rasterizers:
`ops/splat_tiles.py` (the default: per-tile lists) or the chunked scan
(`rasterize`, every gaussian at every pixel, through
`ops/splat_compose.py`'s two-pass backward). Both are torch ops: the JAX
package computes them in XLA, with no Pallas kernel.

As in the JAX package:
- the densification signal is the accumulated norm of the loss gradient
  of the 3-D means (`track_refinement_stats`), not the reference's
  screen-space one;
- `sh_degree_interval` and the three screen-size settings are read
  nowhere;
- `seed_points` come only from a parser's `points3D_xyz`, which no parser
  writes, so every run starts from the `num_random` random cube;
- renders outside the training step use `_host_alive`, a snapshot that
  `init_extra_state` and the trainer's refinement set and a checkpoint
  load does not: a reloaded run renders, evaluates and exports with the
  initial mask.
The refinement runs on the parameters' device and matches the JAX
package's host numpy step for step: the same cull / split / duplicate
sets, `np.random.default_rng(step)`'s normal draws in the same order (one
vectorised draw of the same sequence), new rows in the same free slots,
the same opacity reset, and the first and second Adam moments of every
touched row zeroed in every group (the counts kept).
"""

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.models.base_model import Model, ModelConfig
from nerfstudio_thermal_torch.ops.splat_compose import composite_chunks
from nerfstudio_thermal_torch.ops.splat_tiles import rasterize_tiles
from nerfstudio_thermal_torch.utils.math import psnr, ssim

PARAM_KEYS = ("xyz", "features_dc", "features_rest", "opacities", "scales", "quats")
SH_C0 = 0.28209479177387814


@dataclass
class SplatfactoModelConfig(ModelConfig):
    """Fields and defaults as in the JAX package's config."""

    warmup_length: int = 500
    refine_every: int = 100
    resolution_schedule: int = 250
    background_color: str = "random"  # random | black | white
    num_downscales: int = 0
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    continue_cull_post_densification: bool = True
    reset_alpha_every: int = 30
    densify_grad_thresh: float = 0.0002
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    sh_degree_interval: int = 1000
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    random_init: bool = False
    num_random: int = 50000
    random_scale: float = 10.0
    ssim_lambda: float = 0.2
    stop_split_at: int = 15000
    sh_degree: int = 3
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 10.0
    rasterize_mode: str = "classic"  # classic | antialiased
    max_num_gaussians: int = 300000
    """Fixed gaussian capacity (dead slots are masked)."""
    rasterize_chunk: int = 256
    """Gaussians composited per scan step (memory = H*W*chunk floats)."""
    rasterizer: str = "tiles"  # scan | tiles
    """"tiles": per-tile lists (ops/splat_tiles.py); "scan": every gaussian
    at every pixel (the reference the tiles are held to)."""
    tile_capacity: int = 512
    """Max gaussians composited per 16x16 tile; over-full tiles drop the
    farthest."""
    tile_window: int = 4
    """Candidate-tile window per gaussian: covers up to a (window*16)^2 px
    footprint."""
    enable_collider: bool = False


@dataclass
class SplatfactoState:
    """The trainer's extra state for splatfacto: the alive mask and the
    densification statistics."""

    alive: torch.Tensor  # [cap] bool
    grad_accum: torch.Tensor  # [cap] f32
    grad_count: torch.Tensor  # [cap] f32
    max_radii: torch.Tensor  # [cap] f32
    step: torch.Tensor  # int32 scalar


# ---------------------------------------------------------------------------
# math helpers
# ---------------------------------------------------------------------------


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] (wxyz) -> [N, 3, 3]."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2)], -1),
        ],
        -2,
    )


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis values up to `degree` for unit dirs [..., 3] ->
    [..., (degree+1)^2] (gsplat's convention)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-0.4886025119029199 * y, 0.4886025119029199 * z, -0.4886025119029199 * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.31539156525252005 * (2 * zz - xx - yy),
            -1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            -0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            -0.4570457994644658 * y * (4 * zz - xx - yy),
            0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy),
            -0.4570457994644658 * x * (4 * zz - xx - yy),
            1.445305721320277 * z * (xx - yy),
            -0.5900435899266435 * x * (xx - 3 * yy),
        ]
    return torch.stack(out, dim=-1)


def camera_points(means: torch.Tensor, c2w: torch.Tensor):
    """(R_w2c, the means in the camera's +z forward / +y down frame)."""
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=means.device))
    R_w2c = flip @ c2w[:3, :3].T
    t_w2c = -R_w2c @ c2w[:3, 3]
    return R_w2c, means @ R_w2c.T + t_w2c


def project_gaussians(means, scales, quats, c2w, fx, fy, cx, cy, W: int, H: int, rasterize_mode: str = "classic"):
    """EWA splatting projection. means [N, 3], scales [N, 3] (exp'd),
    quats [N, 4], c2w [3, 4] (OpenGL). Returns (xys [N, 2], depths [N],
    conics [N, 3] (a, b, c of the inverse covariance), radii [N], comp [N]
    the antialiased opacity compensation)."""
    R_w2c, p_cam = camera_points(means, c2w)
    z = p_cam[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, z.new_tensor(1e-6), z)

    Rg = quat_to_rotmat(quats)
    M = Rg * scales[:, None, :]  # R @ diag(s)
    cov3d = M @ M.transpose(-1, -2)

    x, y = p_cam[:, 0], p_cam[:, 1]
    zero = torch.zeros_like(z)
    J = torch.stack(
        [
            torch.stack([fx / z_safe, zero, -fx * x / z_safe**2], -1),
            torch.stack([zero, fy / z_safe, -fy * y / z_safe**2], -1),
        ],
        -2,
    )
    T = J @ R_w2c[None]
    cov2d = T @ cov3d @ T.transpose(-1, -2)
    det_raw = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    cov2d = cov2d + 0.3 * torch.eye(2, device=means.device)[None]
    a, b, c = cov2d[:, 0, 0], cov2d[:, 0, 1], cov2d[:, 1, 1]
    det = a * c - b * b
    det_safe = torch.where(det <= 0, det.new_tensor(1e-6), det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)
    if rasterize_mode == "antialiased":
        comp = torch.sqrt(torch.maximum(det_raw, det_raw.new_tensor(1e-12)) / det_safe)
    else:
        comp = torch.ones_like(det)
    # 3-sigma screen radius from the larger eigenvalue
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.maximum(mid**2 - det_safe, zero))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lam1, zero)))

    xys = torch.stack([fx * x / z_safe + cx, fy * y / z_safe + cy], -1)
    radius = torch.where(z > 0.01, radius, zero)
    return xys, z, conic, radius, comp


def rasterize(xys, depths, conics, radii, opacities, colors, alive, H: int, W: int, background, chunk: int = 256):
    """Front-to-back alpha compositing over depth-sorted gaussians: one sort
    over N, then the chunked scan of ops/splat_compose.py. Returns (rgb
    [H, W, 3], alpha [H, W, 1], depth [H, W, 1])."""
    n = xys.shape[0]
    inf = depths.new_tensor(float("inf"))
    order = torch.sort(torch.where(alive & (radii > 0), depths, inf), stable=True).indices
    xys = xys[order]
    conics = conics[order]
    radii = radii[order]
    opac = (opacities * alive.to(opacities.dtype))[order]
    cols = colors[order]
    deps = depths[order]

    dev = xys.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)

    pad = (-n) % chunk
    if pad:
        xys = torch.cat([xys, xys.new_zeros((pad, 2))], 0)
        conics = torch.cat([conics, conics.new_ones((pad, 3))], 0)
        radii = torch.cat([radii, radii.new_zeros((pad,))], 0)
        opac = torch.cat([opac, opac.new_zeros((pad,))], 0)
        cols = torch.cat([cols, cols.new_zeros((pad, cols.shape[-1]))], 0)
        deps = torch.cat([deps, deps.new_full((pad,), 1e10)], 0)
    n_chunks = (n + pad) // chunk
    rgb, dep, trans = composite_chunks(
        pix,
        xys.reshape(n_chunks, chunk, 2),
        conics.reshape(n_chunks, chunk, 3),
        radii.reshape(n_chunks, chunk),
        opac.reshape(n_chunks, chunk),
        cols.reshape(n_chunks, chunk, -1),
        deps.reshape(n_chunks, chunk),
    )
    accum = 1.0 - trans
    rgb = rgb + trans[:, None] * background[None, :]
    dep = dep / torch.clamp(accum[:, None], min=1e-10)
    return rgb.reshape(H, W, -1), accum.reshape(H, W, 1), dep.reshape(H, W, 1)


def _clip(x: torch.Tensor, lo: Optional[float], hi: Optional[float]) -> torch.Tensor:
    """jnp.clip: maximum then minimum, the gradient split at a tie."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def _logit(x: float) -> float:
    return float(np.log(x / (1 - x)))


def avg_knn_dist(pts: torch.Tensor, k: int = 3, sample: int = 4096, rows: int = 8192) -> torch.Tensor:
    """Mean distance to the k nearest points of a subsample (the rows of
    np.random.default_rng(0).choice), skipping the nearest, as the JAX
    package does: for a point outside the subsample that nearest is not
    itself. Exact differences (no matmul distance), `rows` points at a time."""
    n = pts.shape[0]
    if n <= 1:
        return pts.new_full((n,), 0.1)
    pick = np.random.default_rng(0).choice(n, min(n, sample), replace=False)
    ref = pts[torch.as_tensor(pick, device=pts.device)]
    kk = min(k + 1, ref.shape[0])
    out = []
    for r0 in range(0, n, rows):
        d = torch.cdist(pts[r0 : r0 + rows], ref, compute_mode="donot_use_mm_for_euclid_dist")
        out.append(torch.topk(d, kk, dim=1, largest=False, sorted=True).values[:, 1:kk].mean(dim=1))
    return torch.cat(out)


# ---------------------------------------------------------------------------


class SplatfactoModel(Model):
    """Fixed-capacity gaussian pools; one parameter per optimizer group."""

    config: SplatfactoModelConfig
    is_rasterization = True  # the trainer builds an image step

    def __init__(self, *args, seed_points=None, **kwargs):
        self.seed_points = seed_points
        self._host_alive: Optional[torch.Tensor] = None
        super().__init__(*args, **kwargs)
        # init scales from the mean 3-NN distance, on the model's device
        with torch.no_grad():
            d3 = avg_knn_dist(self.xyz[: self.num_init])
            self.scales[: self.num_init] = torch.log(torch.clamp(d3, min=1e-6))[:, None]

    @property
    def num_sh_bases(self) -> int:
        return (self.config.sh_degree + 1) ** 2

    def populate_modules(self) -> None:
        cap = self.config.max_num_gaussians
        self.xyz = nn.Parameter(torch.zeros(cap, 3))
        self.features_dc = nn.Parameter(torch.zeros(cap, 3))
        self.features_rest = nn.Parameter(torch.zeros(cap, self.num_sh_bases - 1, 3))
        self.opacities = nn.Parameter(torch.zeros(cap))
        self.scales = nn.Parameter(torch.zeros(cap, 3))
        self.quats = nn.Parameter(torch.zeros(cap, 4))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init: seed points (or a uniform cube of num_random
        points with uniform DC colours), the rest of the pool zero with
        scales -5, identity quaternions, opacity 0.1; scales of the live
        rows from the 3-NN distance once the model is on its device."""
        cfg = self.config
        cap = cfg.max_num_gaussians
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
            if self.seed_points is not None and not cfg.random_init:
                pts, cols = self.seed_points
                n = min(len(pts), cap)
                self.xyz[:n] = torch.as_tensor(np.asarray(pts[:n], np.float32))
                self.features_dc[:n] = torch.as_tensor((np.asarray(cols[:n], np.float32) - 0.5) / SH_C0)
            else:
                n = min(cfg.num_random, cap)
                self.xyz[:n] = (torch.rand(n, 3, generator=generator) - 0.5) * cfg.random_scale
                self.features_dc[:n] = torch.rand(n, 3, generator=generator)
            self.num_init = n
            self.scales.fill_(-5.0)
            self.quats[:, 0] = 1.0
            self.opacities.fill_(_logit(0.1))

    def param_groups(self) -> Dict[str, List[nn.Parameter]]:
        return {k: [getattr(self, k)] for k in PARAM_KEYS}

    # --- extra state: alive mask + densification statistics -------------

    def init_extra_state(self) -> SplatfactoState:
        cap = self.config.max_num_gaussians
        dev = self.device
        alive = torch.zeros(cap, dtype=torch.bool, device=dev)
        alive[: self.num_init] = True
        self._host_alive = alive.clone()
        zeros = lambda: torch.zeros(cap, device=dev)  # noqa: E731
        return SplatfactoState(alive, zeros(), zeros(), zeros(), torch.zeros((), dtype=torch.int32, device=dev))

    def update_extra_state(self, extra, step: int, generator=None, draws=None):
        return dataclasses.replace(extra, step=torch.full_like(extra.step, step))

    def track_refinement_stats(self, extra: SplatfactoState, xyz_grad: torch.Tensor, radii: torch.Tensor):
        """Accumulate the norm of each seen gaussian's mean gradient and its
        largest screen radius."""
        gnorm = torch.linalg.vector_norm(xyz_grad, dim=-1)
        seen = radii > 0
        zero = gnorm.new_zeros(())
        return dataclasses.replace(
            extra,
            grad_accum=extra.grad_accum + torch.where(seen, gnorm, zero),
            grad_count=extra.grad_count + seen.float(),
            max_radii=torch.maximum(extra.max_radii, torch.where(seen, radii, zero)),
        )

    def extra_forward_kwargs(self, extra) -> Dict:
        return {"alive": extra.alive} if extra is not None else {}

    # --- rendering -------------------------------------------------------

    def render_camera(
        self,
        cameras: Cameras,
        camera_index,
        *,
        alive: torch.Tensor,
        train: bool = True,
        background_uniforms: Optional[torch.Tensor] = None,
        width: Optional[int] = None,
        height: Optional[int] = None,
        sh_degree: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """One frame of camera `camera_index` at (height, width) (by default
        the camera's own). A random background ((3,) in [0, 1), the train
        step's draw) applies in training only."""
        cfg = self.config
        i = camera_index
        H = int(height) if height is not None else int(cameras.height[int(i)])
        W = int(width) if width is not None else int(cameras.width[int(i)])
        c2w = cameras.camera_to_worlds[i]
        fx, fy, cx, cy = cameras.fx[i], cameras.fy[i], cameras.cx[i], cameras.cy[i]

        # A gaussian behind the near plane (z <= 0.01) gets radius 0 and is
        # never composited, but near the camera plane its projection
        # overflows (inf, then NaN), and autograd's 0 x NaN would leave NaN
        # in its rows' gradients, which JAX's compiled step does not show:
        # those rows take no gradient through the projection.
        with torch.no_grad():
            in_front = camera_points(self.xyz, c2w)[1][:, 2] > 0.01
        keep = lambda p: torch.where(in_front.reshape(-1, *(1,) * (p.dim() - 1)), p, p.detach())  # noqa: E731
        means = self.xyz
        scales = torch.exp(keep(self.scales))
        opac = torch.sigmoid(self.opacities)
        xys, depths, conics, radii, comp = project_gaussians(
            keep(means), scales, keep(self.quats), c2w, fx, fy, cx, cy, W, H, rasterize_mode=cfg.rasterize_mode
        )
        opac = opac * comp

        # SH colours from the camera centre's direction
        deg = cfg.sh_degree if sh_degree is None else sh_degree
        viewdir = means - c2w[:3, 3]
        viewdir = viewdir / torch.clamp(torch.linalg.vector_norm(viewdir, dim=-1, keepdim=True), min=1e-9)
        basis = sh_basis(deg, viewdir)
        n_active = (deg + 1) ** 2
        feats = torch.cat([self.features_dc[:, None, :], self.features_rest], dim=1)[:, :n_active]
        colors = _clip(torch.einsum("nb,nbc->nc", basis, feats) + 0.5, 0.0, None)

        if train and cfg.background_color == "random" and background_uniforms is not None:
            background = background_uniforms
        elif cfg.background_color == "white":
            background = means.new_ones(3)
        else:
            background = means.new_zeros(3)

        if cfg.rasterizer == "tiles":
            rgb, accum, depth = rasterize_tiles(
                xys, depths, conics, radii, opac, colors, alive, H, W, background,
                capacity=cfg.tile_capacity, window=cfg.tile_window,
            )
        else:
            rgb, accum, depth = rasterize(
                xys, depths, conics, radii, opac, colors, alive, H, W, background, chunk=cfg.rasterize_chunk
            )
        return {
            "rgb": _clip(rgb, 0.0, 1.0),
            "accumulation": accum,
            "depth": depth,
            "expected_depth": depth,
            "background": background,
            "radii": radii,
        }

    def _alive(self) -> torch.Tensor:
        if self._host_alive is not None:
            # the snapshot the trainer keeps (refinement changes it)
            return self._host_alive.to(self.device)
        return torch.ones(self.config.max_num_gaussians, dtype=torch.bool, device=self.device)

    @torch.no_grad()
    def render_camera_device(self, cameras: Cameras, camera_index: int, width=None, height=None, crop_aabb=None,
                             include_per_sample: bool = False):
        """A whole frame on the device: {name: [h, w, C]}. crop_aabb and
        include_per_sample are ray-model options a rasterizer has no use
        for: ignored, as in the JAX package."""
        out = self.render_camera(
            cameras.to(self.device), camera_index, alive=self._alive(), train=False, width=width, height=height
        )
        return {k: v for k, v in out.items() if k not in ("background", "radii")}

    # --- losses / metrics --------------------------------------------------

    def get_metrics_dict(self, outputs, batch, train: bool = True) -> Dict[str, torch.Tensor]:
        return {"psnr": psnr(outputs["rgb"], batch["image"][..., :3])}

    def get_loss_dict(self, outputs, batch, metrics_dict, *, train: bool = True, **kwargs) -> Dict[str, torch.Tensor]:
        """L1 + ssim_lambda * (1 - SSIM), and the optional scale
        regularisation."""
        cfg = self.config
        gt = batch["image"][..., :3]
        pred = outputs["rgb"]
        l1 = torch.mean(torch.abs(gt - pred))
        simloss = 1.0 - ssim(pred, gt)
        loss = {"main_loss": (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * simloss}
        if train and cfg.use_scale_regularization:
            s = torch.exp(self.scales)
            ratio = torch.maximum(
                s.amax(-1) / torch.maximum(s.amin(-1), s.new_tensor(1e-8)), s.new_tensor(cfg.max_gauss_ratio)
            )
            loss["scale_reg"] = 0.1 * torch.mean(ratio - cfg.max_gauss_ratio)
        return loss

    # --- refinement --------------------------------------------------------

    def wants_host_refinement(self, step: int) -> bool:
        cfg = self.config
        return step > cfg.warmup_length and step % cfg.refine_every == 0 and step < cfg.stop_split_at

    @torch.no_grad()
    def refine_host(self, optimizers, step: int, extra: SplatfactoState) -> SplatfactoState:
        """Densify (split / duplicate), cull and periodically reset the
        opacities, in place on the parameters and the optimizers' moments.
        Returns the new extra state."""
        cfg = self.config
        dev = self.device
        p = {k: getattr(self, k).detach() for k in PARAM_KEYS}
        alive = extra.alive.clone()
        avg_grad = extra.grad_accum / torch.clamp(extra.grad_count, min=1.0)
        scales = torch.exp(p["scales"])
        max_scale = scales.amax(-1)
        opac = 1 / (1 + torch.exp(-p["opacities"]))

        cull = alive & (opac < cfg.cull_alpha_thresh)
        if step > cfg.refine_every * cfg.reset_alpha_every:
            cull |= alive & (max_scale > cfg.cull_scale_thresh)
        alive &= ~cull

        high_grad = avg_grad > cfg.densify_grad_thresh
        split = alive & high_grad & (max_scale > cfg.densify_size_thresh)
        dup = alive & high_grad & (max_scale <= cfg.densify_size_thresh)
        free = torch.nonzero(~alive)[:, 0]
        dup_idx = torch.nonzero(dup)[:, 0]
        split_idx = torch.nonzero(split)[:, 0]
        ns = cfg.n_split_samples
        n_split = split_idx.shape[0]

        # new rows: the duplicates in index order, then each split gaussian's
        # n_split_samples samples; the normal draws in that order
        draws = np.random.default_rng(step).normal(size=(n_split, ns, 3))
        split_rep = split_idx.repeat_interleave(ns)
        src = torch.cat([dup_idx, split_rep])
        new = {k: p[k][src].clone() for k in PARAM_KEYS}
        if n_split:
            R = quat_to_rotmat(p["quats"][split_idx]).double()
            s = scales[split_idx].double()
            offset = torch.einsum("nij,nsj->nsi", R, torch.as_tensor(draws, device=dev) * s[:, None, :])
            nd = dup_idx.shape[0]
            new["xyz"][nd:] = (p["xyz"][split_rep].double() + offset.reshape(-1, 3)).float()
            shrunk = torch.log(torch.clamp(scales[split_idx] / 1.6, min=1e-8))
            new["scales"][nd:] = shrunk.repeat_interleave(ns, dim=0)
            p["scales"][split_idx] = shrunk

        n_fit = min(src.shape[0], free.shape[0])
        slots = free[:n_fit]
        for k in PARAM_KEYS:
            p[k][slots] = new[k][:n_fit]
        alive[slots] = True

        reset_interval = cfg.reset_alpha_every * cfg.refine_every
        if step % reset_interval == 0 and step > 0:
            reset_val = _logit(min(2 * cfg.cull_alpha_thresh, 0.99))
            torch.minimum(p["opacities"], p["opacities"].new_tensor(reset_val), out=p["opacities"])

        touched = torch.zeros_like(alive)
        touched[slots] = True
        touched |= cull
        reset_adam_slots(optimizers, touched)
        zeros = torch.zeros_like(extra.grad_accum)
        return dataclasses.replace(extra, alive=alive, grad_accum=zeros, grad_count=zeros.clone(),
                                   max_radii=zeros.clone())


def reset_adam_slots(optimizers, touched: torch.Tensor) -> None:
    """Zero the first and second moments (and a gradient accumulator's
    mean) at the touched rows of every tensor whose leading dim is the
    capacity; the counts stay."""
    cap = touched.shape[0]
    keep = ~touched
    tensors = [t for opt in optimizers.groups.values() for t in opt.mu + opt.nu]
    tensors += [t for acc in getattr(optimizers, "acc", {}).values() for t in acc]
    for t in tensors:
        if t.dim() >= 1 and t.shape[0] == cap:
            t.mul_(keep.reshape((cap,) + (1,) * (t.dim() - 1)).to(t.dtype))
