"""Memory-bounded alpha compositing for the scan splat rasterizer
(counterpart of nerfstudio_thermal_tpu/ops/splat_compose.py).

`composite_chunks` composites depth-sorted, chunked gaussians front to
back over every pixel: the forward is the naive scan (an in-chunk
exclusive cumprod, a carried per-pixel transmittance, colour and depth
accumulated by f32 matrix products) and saves only its inputs. Its
backward is the JAX package's O(P)-residual two-pass scheme instead of
autograd of the scan, which would keep a [P, chunk] alpha tensor per chunk:

- pass 1 recomputes each chunk's alphas and sums log(1 - alpha) per pixel
  into the total log-transmittance lT (an O(P) carry);
- pass 2 walks the chunks back to front carrying (lT after the chunk, S),
  S the suffix sum over later gaussians of w_j (c_j . g_rgb + d_j g_dep)
  plus T_final g_trans; each chunk recovers its entry transmittance in
  log space (a subtraction: alpha <= 0.999 keeps log1p(-alpha) finite)
  and gives
      d out / d colour_g = w_g,
      d out / d alpha_g = T_g u_g - S_g / (1 - alpha_g),
  with alpha's own VJP (to the centres, conics and opacities) taken by
  autograd of the recomputed chunk alpha.

`composite_chunks_plain` is the same forward as plain PyTorch, autograd of
the naive scan (cumprod, no custom backward): what the two-pass backward is
held against.
"""

from typing import Tuple

import torch


def chunk_alpha(pix, cxys, cconic, copa, crad) -> torch.Tensor:
    """A chunk's alpha matrix [P, C]: the naive body's math."""
    d = pix[:, None, :] - cxys[None, :, :]  # [P, C, 2]
    power = -0.5 * (cconic[None, :, 0] * d[..., 0] ** 2 + cconic[None, :, 2] * d[..., 1] ** 2) - (
        cconic[None, :, 1] * d[..., 0] * d[..., 1]
    )
    zero = power.new_zeros(())
    alpha = torch.minimum(power.new_tensor(0.999), copa[None, :] * torch.exp(torch.minimum(power, zero)))
    alpha = torch.where((crad > 0)[None, :], alpha, zero)
    return torch.where(alpha > 1.0 / 255.0, alpha, zero)


def _scan(pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c):
    """The naive front-to-back scan: (rgb [P, ch], dep [P, 1], trans [P])."""
    p = pix.shape[0]
    rgb = xys_c.new_zeros((p, cols_c.shape[-1]))
    dep = xys_c.new_zeros((p, 1))
    trans = xys_c.new_ones((p,))
    for g in range(xys_c.shape[0]):
        alpha = chunk_alpha(pix, xys_c[g], conics_c[g], opac_c[g], radii_c[g])
        one_minus = 1.0 - alpha
        t_in = torch.cumprod(torch.cat([torch.ones_like(one_minus[:, :1]), one_minus[:, :-1]], 1), dim=1)
        w = trans[:, None] * t_in * alpha
        rgb = rgb + w @ cols_c[g]
        dep = dep + w @ deps_c[g][:, None]
        trans = trans * torch.prod(one_minus, dim=1)
    return rgb, dep, trans


class _CompositeChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c):
        ctx.save_for_backward(pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c)
        return _scan(pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c)

    @staticmethod
    def backward(ctx, g_rgb, g_dep, g_trans):
        pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c = ctx.saved_tensors
        n_chunks = xys_c.shape[0]
        # pass 1: the total log-transmittance of every pixel
        lt = xys_c.new_zeros((pix.shape[0],))
        for g in range(n_chunks):
            alpha = chunk_alpha(pix, xys_c[g], conics_c[g], opac_c[g], radii_c[g])
            lt = lt + torch.sum(torch.log1p(-alpha), dim=1)
        s = torch.exp(lt) * g_trans
        lt_after = lt
        d_xys, d_conics, d_opac = torch.zeros_like(xys_c), torch.zeros_like(conics_c), torch.zeros_like(opac_c)
        d_cols, d_deps = torch.zeros_like(cols_c), torch.zeros_like(deps_c)
        # pass 2: back to front, carrying (lT after the chunk, suffix S)
        for g in reversed(range(n_chunks)):
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_(True) for t in (xys_c[g], conics_c[g], opac_c[g])]
                alpha = chunk_alpha(pix, inputs[0], inputs[1], inputs[2], radii_c[g])
            a = alpha.detach()
            log1m = torch.log1p(-a)
            lt_entry = lt_after - torch.sum(log1m, dim=1)
            t_g = torch.exp(lt_entry[:, None] + torch.cumsum(log1m, dim=1) - log1m)
            w = t_g * a
            u = g_rgb @ cols_c[g].T + g_dep * deps_c[g][None, :]
            wu = w * u
            suffix = s[:, None] + (torch.sum(wu, dim=1, keepdim=True) - torch.cumsum(wu, dim=1))
            g_alpha = t_g * u - suffix / (1.0 - a)
            # culled entries (alpha == 0) get suffix / 1 here; alpha's own
            # VJP (the where cull) zeroes it
            d_xys[g], d_conics[g], d_opac[g] = torch.autograd.grad(alpha, inputs, g_alpha)
            d_cols[g] = w.T @ g_rgb
            d_deps[g] = (w.T @ g_dep)[:, 0]
            lt_after = lt_entry
            s = s + torch.sum(wu, dim=1)
        return (torch.zeros_like(pix), d_xys, d_conics, torch.zeros_like(radii_c), d_opac, d_cols, d_deps)


def composite_chunks(pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c) -> Tuple[torch.Tensor, ...]:
    """Front-to-back composite of depth-sorted chunked gaussians.

    pix [P, 2] pixel centres (their cotangent is zero); the rest are
    [n_chunks, C, ...] chunked, depth-sorted, padded gaussian attributes
    (pad rows have radius 0 or opacity 0). Returns (rgb_raw [P, ch],
    dep_raw [P, 1], trans [P]): the un-normalised colour and depth sums and
    the final transmittance; the caller blends the background and
    normalises the depth."""
    return _CompositeChunks.apply(pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c)


def composite_chunks_plain(pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c) -> Tuple[torch.Tensor, ...]:
    """composite_chunks's function by autograd of the naive scan."""
    return _scan(pix, xys_c, conics_c, radii_c, opac_c, cols_c, deps_c)
