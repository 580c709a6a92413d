"""Tile-binned gaussian-splat rasterization
(counterpart of nerfstudio_thermal_tpu/ops/splat_tiles.py).

Instead of evaluating every gaussian at every pixel (the scan rasterizer
in models/splatfacto.py, O(H W N)), gaussians are binned to fixed-capacity
per-tile lists and each tile composites only its own list, O(H W K):

- **Binning** (`bin_gaussians`) is one masked stable depth sort and one
  stable sort of the [N * window^2] (gaussian, candidate tile) pairs laid
  out depth-major, so every tile's segment is depth-ordered; segment
  starts are `searchsorted` on the sorted tile ids (the JAX package counts
  ids below each threshold: the same numbers). The lists are the JAX
  package's exactly, with the same floor / clip arithmetic.
- **Per-tile gather**: a fixed-capacity [T, K] row gather; an over-full
  tile drops its farthest gaussians.
- **Compositing** (`rasterize_tiles`) runs `tiles_per_step` tiles at a
  time: the exclusive log-transmittance is a cumulative sum of
  log1p(-alpha) (the JAX package's strictly-upper triangular product: the
  same sums in another order), colour and depth are f32 batched matrix
  products. Each chunk runs under `torch.utils.checkpoint`, so the
  backward recomputes its [TC, P, K] alphas instead of keeping them for
  every tile. `tiles_per_step` only chunks the work; the port's default
  is larger than the JAX package's 16 to cut launches.

The result matches `models.splatfacto.rasterize` up to summation order
whenever no tile overflows `capacity` and no gaussian's 3.5-sigma box
exceeds its window^2 candidate tiles.
"""

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint


def count_below(sorted_ids: torch.Tensor, num_thresholds: int) -> torch.Tensor:
    """counts[t] = #(ids < t) for t in [0, num_thresholds), of ascending ids."""
    th = torch.arange(num_thresholds, dtype=sorted_ids.dtype, device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, th, right=False)


def bin_gaussians(
    xys: torch.Tensor,  # [N, 2] screen-space centres (detached here)
    depths: torch.Tensor,  # [N]
    radii: torch.Tensor,  # [N] 3-sigma pixel radii (0 = dead)
    valid: torch.Tensor,  # [N] bool
    H: int,
    W: int,
    tile_h: int,
    tile_w: int,
    capacity: int,
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-capacity per-tile gaussian lists, front to back per tile.

    Returns (gauss_idx [T, K] rows into the depth-sorted gaussians,
    slot_mask [T, K] bool, order [N] the depth sort's permutation)."""
    tx_n = -(-W // tile_w)
    ty_n = -(-H // tile_h)
    num_tiles = tx_n * ty_n
    d = window * window
    dev = xys.device

    inf = depths.new_tensor(float("inf"))
    order = torch.sort(torch.where(valid, depths.detach(), inf), stable=True).indices
    xy = xys.detach()[order]
    rad = radii.detach()[order]
    val = valid[order]

    # 7/6 * ceil(3 sigma) >= 3.5 sigma: covers alpha > 1/255 for opacity <= 1
    rb = torch.ceil(rad * (7.0 / 6.0))
    x, y = xy[:, 0], xy[:, 1]
    x0 = torch.floor((x - rb) / tile_w).to(torch.int32)
    x1 = torch.floor((x + rb) / tile_w).to(torch.int32)
    y0 = torch.floor((y - rb) / tile_h).to(torch.int32)
    y1 = torch.floor((y + rb) / tile_h).to(torch.int32)
    # window^2 candidate tiles centred on the gaussian's own tile, clamped
    # into the bbox (a big gaussian loses the tiles beyond its window)
    tcx = torch.floor(x / tile_w).to(torch.int32)
    tcy = torch.floor(y / tile_h).to(torch.int32)
    lox = torch.minimum(torch.maximum(tcx - window // 2, x0), torch.maximum(x0, x1 - window + 1))
    loy = torch.minimum(torch.maximum(tcy - window // 2, y0), torch.maximum(y0, y1 - window + 1))

    j = torch.arange(d, dtype=torch.int32, device=dev)
    tx = lox[:, None] + (j % window)[None, :]  # [N, d]
    ty = loy[:, None] + (j // window)[None, :]
    ok = (
        val[:, None]
        & (tx >= 0) & (tx < tx_n) & (ty >= 0) & (ty < ty_n)
        & (tx <= x1[:, None]) & (ty <= y1[:, None])
    )
    tile_id = torch.where(ok, ty * tx_n + tx, torch.full_like(tx, num_tiles))

    # depth-major layout + stable sort by tile == per-tile depth order
    flat = tile_id.reshape(-1)
    m = flat.shape[0]
    sorted_ids, cand = torch.sort(flat, stable=True)

    starts = count_below(sorted_ids, num_tiles + 1)
    k_iota = torch.arange(capacity, dtype=starts.dtype, device=dev)
    idx = starts[:-1, None] + k_iota[None, :]  # [T, K]
    slot_mask = idx < starts[1:, None]
    cand_tk = cand[torch.clamp(idx, 0, m - 1)]
    gauss_idx = torch.div(cand_tk, d, rounding_mode="floor")  # row into the depth-sorted arrays
    return gauss_idx, slot_mask, order


def _tile_body(tf, msk, tid, tx_n: int, tile_w: int, tile_h: int, num_ch: int):
    """One chunk of tiles: tf [TC, K, F], msk [TC, K], tid [TC] ->
    (rgb [TC, P, C], accum [TC, P], dep [TC, P], trans [TC, P])."""
    p = tile_h * tile_w
    iota = torch.arange(p, dtype=torch.float32, device=tf.device)
    px_off = torch.remainder(iota, tile_w) + 0.5
    py_off = torch.div(iota, tile_w, rounding_mode="floor") + 0.5
    cx, cy = tf[..., 0], tf[..., 1]
    ca, cb, cc = tf[..., 2], tf[..., 3], tf[..., 4]
    copa = tf[..., 5]
    ccol = tf[..., 6 : 6 + num_ch]
    cdep = tf[..., 6 + num_ch]

    pixx = torch.remainder(tid, tx_n).float()[:, None] * tile_w + px_off[None, :]
    pixy = torch.div(tid, tx_n, rounding_mode="floor").float()[:, None] * tile_h + py_off[None, :]
    dx = pixx[:, :, None] - cx[:, None, :]  # [TC, P, K]
    dy = pixy[:, :, None] - cy[:, None, :]
    power = -0.5 * (ca[:, None, :] * dx * dx + cc[:, None, :] * dy * dy) - cb[:, None, :] * dx * dy
    zero = power.new_zeros(())
    alpha = torch.minimum(power.new_tensor(0.999), copa[:, None, :] * torch.exp(torch.minimum(power, zero)))
    alpha = torch.where(alpha > 1.0 / 255.0, alpha, zero)
    alpha = alpha * msk[:, None, :]
    log1m = torch.log1p(-alpha)
    incl = torch.cumsum(log1m, dim=-1)
    log_t = incl - log1m  # exclusive: sum_{j < k} log(1 - a_j)
    w = torch.exp(log_t) * alpha  # [TC, P, K]
    rgb = torch.matmul(w, ccol)  # [TC, P, C]
    dep = torch.matmul(w, cdep[..., None])[..., 0]
    trans = torch.exp(log_t[..., -1] + log1m[..., -1])  # the full product
    return rgb, 1.0 - trans, dep, trans


def rasterize_tiles(
    xys: torch.Tensor,
    depths: torch.Tensor,
    conics: torch.Tensor,
    radii: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    alive: torch.Tensor,
    H: int,
    W: int,
    background: torch.Tensor,
    tile_h: int = 16,
    tile_w: int = 16,
    capacity: int = 512,
    window: int = 4,
    tiles_per_step: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tile-binned front-to-back compositing; `models.splatfacto.rasterize`'s
    contract: (rgb [H, W, C], alpha [H, W, 1], depth [H, W, 1])."""
    num_ch = colors.shape[-1]
    tx_n = -(-W // tile_w)
    ty_n = -(-H // tile_h)
    num_tiles = tx_n * ty_n
    p = tile_h * tile_w

    valid = alive & (radii > 0)
    gauss_idx, slot_mask, order = bin_gaussians(xys, depths, radii, valid, H, W, tile_h, tile_w, capacity, window)

    # depth-sorted, differentiable feature rows [N, 2+3+1+C+1]
    opac = opacities * alive.to(opacities.dtype)
    feats = torch.cat([xys, conics, opac[:, None], colors, depths[:, None]], dim=-1)[order]
    tile_feats = feats[gauss_idx]  # [T, K, F]
    msk = slot_mask.to(feats.dtype)
    tile_ids = torch.arange(num_tiles, device=xys.device)

    track = torch.is_grad_enabled() and tile_feats.requires_grad
    parts = []
    for t0 in range(0, num_tiles, tiles_per_step):
        args = (tile_feats[t0 : t0 + tiles_per_step], msk[t0 : t0 + tiles_per_step],
                tile_ids[t0 : t0 + tiles_per_step], tx_n, tile_w, tile_h, num_ch)
        parts.append(checkpoint(_tile_body, *args, use_reentrant=False) if track else _tile_body(*args))
    rgb, accum, dep, trans = (torch.cat(xs, dim=0) for xs in zip(*parts))

    def assemble(x, ch):
        # [T, P(, ch)] -> [H, W, ch]
        x = x.reshape(ty_n, tx_n, tile_h, tile_w, ch)
        x = x.permute(0, 2, 1, 3, 4).reshape(ty_n * tile_h, tx_n * tile_w, ch)
        return x[:H, :W]

    rgb = assemble(rgb, num_ch)
    accum = assemble(accum[..., None], 1)
    dep = assemble(dep[..., None], 1)
    trans = assemble(trans[..., None], 1)
    rgb = rgb + trans * background[None, None, :]
    dep = dep / torch.clamp(accum, min=1e-10)
    return rgb, accum, dep
