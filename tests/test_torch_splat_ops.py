"""The splat ops of the port against the JAX package, on the CPU.

- `quat_to_rotmat`, `sh_basis` (degrees 0-3) and `project_gaussians`
  (classic and antialiased) give JAX's values: max abs difference over
  max abs value 1e-6 (the same f32 formulas).
- `composite_chunks` (the scan compositor's autograd.Function): forward
  within 1e-5 relative L2 of JAX's custom VJP, its VJP within 1e-4 of
  JAX's custom VJP and of jax.grad of the naive scan; the port's plain
  version (autograd of the naive scan) within 1e-4 of its two-pass
  backward.
- `bin_gaussians`: gauss_idx, slot_mask and order equal to JAX's, with
  depth ties and dead slots in the scene.
- `rasterize_tiles`: forward within 3e-5 of JAX's (abs), gradients of the
  centres, opacities and colours within 1e-4 relative L2; the port's tiles
  against the port's scan (JAX's own test's tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.models import splatfacto as jsplat
from nerfstudio_thermal_tpu.ops import splat_compose as jcompose
from nerfstudio_thermal_tpu.ops import splat_tiles as jtiles

from nerfstudio_thermal_torch.models import splatfacto as tsplat
from nerfstudio_thermal_torch.ops import splat_compose as tcompose
from nerfstudio_thermal_torch.ops import splat_tiles as ttiles
from tests.test_torch_train import rel_l2

torch.set_num_threads(1)

H, W = 40, 56  # not multiples of the 16-px tile: edge tiles are cropped
TILE_KW = dict(tile_h=16, tile_w=16, capacity=192, window=4)


def max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def t(x):
    return torch.tensor(np.asarray(x))


def _gaussians(n=64, seed=0):
    r = np.random.default_rng(seed)
    means = r.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    scales = np.exp(r.uniform(-3.5, -1.5, (n, 3))).astype(np.float32)
    quats = r.normal(size=(n, 4)).astype(np.float32)
    eye = np.array([0.3, -0.4, 2.5])
    from tests.fixtures import look_at

    c2w = look_at(eye)[:3].astype(np.float32)
    return means, scales, quats, c2w


def test_quat_and_sh_basis_match_jax():
    r = np.random.default_rng(1)
    q = r.normal(size=(50, 4)).astype(np.float32)
    assert max_rel(tsplat.quat_to_rotmat(t(q)), jax.jit(jsplat.quat_to_rotmat)(q)) <= 1e-6
    dirs = r.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for deg in range(4):
        got = tsplat.sh_basis(deg, t(dirs))
        assert got.shape == (50, (deg + 1) ** 2)
        assert max_rel(got, jsplat.sh_basis(deg, jnp.asarray(dirs))) <= 1e-6, deg


@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_project_gaussians_matches_jax(mode):
    means, scales, quats, c2w = _gaussians()
    means[0] = c2w[:, 3] + 0.5 * c2w[:, 2]  # behind the camera: radius 0
    args = (50.0, 52.0, W / 2, H / 2, W, H)
    want = jsplat.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), jnp.asarray(c2w), *args, rasterize_mode=mode
    )
    got = tsplat.project_gaussians(
        t(means), t(scales), t(quats), t(c2w), *(torch.tensor(a, dtype=torch.float32) for a in args[:4]),
        W, H, rasterize_mode=mode,
    )
    for name, a, b in zip(("xys", "depths", "conics", "radii", "comp"), got, want):
        assert max_rel(a, b) <= 1e-6, name
    assert float(got[3][0]) == 0.0


def _compose_scene(n, h, w, chunk, seed=0, opaque=False):
    r = np.random.default_rng(seed)
    pad = (-n) % chunk
    m = n + pad
    xys = r.uniform([-4, -4], [w + 4, h + 4], (m, 2)).astype(np.float32)
    sig = r.uniform(0.8, 3.0, m).astype(np.float32)
    conic = np.zeros((m, 3), np.float32)
    conic[:, 0] = 1.0 / sig**2
    conic[:, 2] = 1.0 / sig**2
    conic[:, 1] = r.uniform(-0.05, 0.05, m).astype(np.float32)
    radii = np.ceil(3.0 * sig).astype(np.float32)
    lo, hi = (0.7, 0.999) if opaque else (0.05, 0.9)
    opac = r.uniform(lo, hi, m).astype(np.float32)
    cols = r.uniform(0, 1, (m, 3)).astype(np.float32)
    deps = np.sort(r.uniform(0.5, 8.0, m).astype(np.float32))
    radii[n:] = 0.0
    opac[n:] = 0.0
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32) + 0.5, np.arange(w, dtype=np.float32) + 0.5, indexing="ij")
    pix = np.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    nc = m // chunk
    chunks = (xys.reshape(nc, chunk, 2), conic.reshape(nc, chunk, 3), radii.reshape(nc, chunk),
              opac.reshape(nc, chunk), cols.reshape(nc, chunk, 3), deps.reshape(nc, chunk))
    wr = np.random.default_rng(seed + 1)
    cot = (wr.normal(size=(h * w, 3)).astype(np.float32), wr.normal(size=(h * w, 1)).astype(np.float32),
           wr.normal(size=(h * w,)).astype(np.float32))
    return pix, chunks, cot


DIFF = (1, 2, 4, 5, 6)  # xys, conics, opacities, colours, depths


@pytest.mark.parametrize("opaque,nchunks", [(False, 3), (True, 1), (True, 4)])
def test_composite_chunks_matches_jax(opaque, nchunks):
    chunk = 16
    pix, chunks, cot = _compose_scene(nchunks * chunk - 5, 12, 14, chunk, seed=nchunks, opaque=opaque)
    jargs = tuple(jnp.asarray(a) for a in (pix, *chunks))
    out, vjp = jax.vjp(jcompose.composite_chunks, *jargs)
    _, vjp_naive = jax.vjp(lambda *a: jcompose._composite_fwd(*a)[0], *jargs)
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    naive = vjp_naive(tuple(jnp.asarray(c) for c in cot))

    targs = [t(a).requires_grad_(i in DIFF) for i, a in enumerate((pix, *chunks))]
    got = tcompose.composite_chunks(*targs)
    for g, w in zip(got, out):
        assert rel_l2(g.detach(), w) <= 1e-5
    grads = torch.autograd.grad(got, [targs[i] for i in DIFF], [t(c) for c in cot])
    plain = torch.autograd.grad(tcompose.composite_chunks_plain(*targs), [targs[i] for i in DIFF], [t(c) for c in cot])
    for i, g, p in zip(DIFF, grads, plain):
        assert rel_l2(g, want[i]) <= 1e-4, i
        assert rel_l2(g, naive[i]) <= 1e-4, i
        assert rel_l2(p, g) <= 1e-4, i


def _raster_scene(n=160, seed=0, radius_px=5.0, ties=True):
    r = np.random.default_rng(seed)
    xys = r.uniform([-4, -4], [W + 4, H + 4], (n, 2)).astype(np.float32)
    depths = r.uniform(0.5, 5.0, n).astype(np.float32)
    if ties:
        depths[10:20] = depths[5]  # depth ties: the stable sort keeps index order
        xys[10:14] = xys[5]
    sig = r.uniform(0.8, radius_px / 3.0, n).astype(np.float32)
    conic = np.zeros((n, 3), np.float32)
    conic[:, 0] = 1.0 / sig**2
    conic[:, 2] = 1.0 / sig**2
    conic[:, 1] = r.uniform(-0.2, 0.2, n) / sig**2
    radii = np.ceil(3.0 * sig).astype(np.float32)
    radii[30:34] = 0.0  # behind the camera
    opac = r.uniform(0.05, 1.0, n).astype(np.float32)
    colors = r.uniform(0, 1, (n, 3)).astype(np.float32)
    alive = r.uniform(0, 1, n) > 0.1  # dead slots
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    return xys, depths, conic, radii, opac, colors, alive, bg


@pytest.mark.parametrize("capacity,window", [(192, 4), (8, 2)])
def test_bin_gaussians_equals_jax(capacity, window):
    xys, depths, _, radii, _, _, alive, _ = _raster_scene(seed=7)
    valid = alive & (radii > 0)
    want = jax.jit(jtiles.bin_gaussians, static_argnums=(4, 5, 6, 7, 8, 9))(
        jnp.asarray(xys), jnp.asarray(depths), jnp.asarray(radii), jnp.asarray(valid), H, W, 16, 16, capacity, window
    )
    got = ttiles.bin_gaussians(t(xys), t(depths), t(radii), t(valid), H, W, 16, 16, capacity, window)
    for name, a, b in zip(("gauss_idx", "slot_mask", "order"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _raster_loss(rgb, acc, dep, wimg):
    return (rgb * wimg).sum() + 0.1 * acc.sum() + 0.01 * (dep * (acc > 1e-3)).sum()


def test_rasterize_tiles_matches_jax():
    xys, depths, conic, radii, opac, colors, alive, bg = _raster_scene(n=120, seed=3)
    wimg = np.random.default_rng(9).uniform(0, 1, (H, W, 3)).astype(np.float32)

    def jloss(xys, opac, colors):
        rgb, acc, dep = jtiles.rasterize_tiles(xys, jnp.asarray(depths), jnp.asarray(conic), jnp.asarray(radii), opac,
                                               colors, jnp.asarray(alive), H, W, jnp.asarray(bg), tiles_per_step=4,
                                               **TILE_KW)
        return jnp.sum(rgb * wimg) + 0.1 * jnp.sum(acc) + 0.01 * jnp.sum(jnp.where(acc > 1e-3, dep, 0.0)), (rgb, acc)

    (_, (jrgb, jacc)), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(xys), jnp.asarray(opac), jnp.asarray(colors)
    )
    leaves = [t(a).requires_grad_(True) for a in (xys, opac, colors)]
    rgb, acc, dep = ttiles.rasterize_tiles(leaves[0], t(depths), t(conic), t(radii), leaves[1], leaves[2], t(alive),
                                           H, W, t(bg), tiles_per_step=3, **TILE_KW)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb), atol=3e-5)
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(jacc), atol=3e-5)
    grads = torch.autograd.grad(_raster_loss(rgb, acc, dep, t(wimg)), leaves)
    for name, g, w in zip(("xys", "opac", "colors"), grads, jgrads):
        assert rel_l2(g, w) <= 1e-4, name


def test_port_tiles_match_port_scan():
    """The port's two rasterizers on the same scene (no tile overflows):
    rgb and accumulation within 2e-5, depth within 1e-3 where covered,
    gradients within 5e-4 (JAX's own test's tolerances)."""
    xys, depths, conic, radii, opac, colors, alive, bg = _raster_scene(n=80, seed=3, ties=False)
    wimg = t(np.random.default_rng(9).uniform(0, 1, (H, W, 3)).astype(np.float32))
    outs = {}
    for name, fn in (("scan", lambda *a: tsplat.rasterize(*a, chunk=64)),
                     ("tiles", lambda *a: ttiles.rasterize_tiles(*a, **TILE_KW, tiles_per_step=4))):
        leaves = [t(a).requires_grad_(True) for a in (xys, opac, colors)]
        rgb, acc, dep = fn(leaves[0], t(depths), t(conic), t(radii), leaves[1], leaves[2], t(alive), H, W, t(bg))
        outs[name] = (rgb.detach(), acc.detach(), dep.detach(),
                      torch.autograd.grad(_raster_loss(rgb, acc, dep, wimg), leaves))
    (rs, as_, ds, gs), (rt, at, dt, gt) = outs["scan"], outs["tiles"]
    torch.testing.assert_close(rt, rs, atol=2e-5, rtol=0)
    torch.testing.assert_close(at, as_, atol=2e-5, rtol=0)
    m = as_[..., 0] > 1e-3
    torch.testing.assert_close(dt[..., 0][m], ds[..., 0][m], atol=1e-3, rtol=0)
    for a, b in zip(gt, gs):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=0)
