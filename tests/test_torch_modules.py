"""Module-level parity of the PyTorch port against the JAX package, on the CPU.

Every case feeds the same numpy inputs (and, where there are parameters,
the same JAX-initialised parameters carried over with
nerfstudio_thermal_torch.utils.jax_params) to the JAX module and to its
port.

Tolerances, with their reasons:
- F32 = 1e-5 (atol and rtol) for f32 arithmetic that both frameworks do in
  the same order up to reassociation (sums, prefix sums, matmuls, sin of
  moderate arguments).
- BF16 = 2e-2 for modules that round to bf16 per layer: one rounding that
  lands on the other side of a bf16 step (2^-8 relative) moves the output
  by about that much.
- Sorted lookups are compared exactly: `torch.searchsorted(right=True)`
  must pick the same elements as the JAX comparison count at ties.
"""

import ast
import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.cameras import cameras as jcams
from nerfstudio_thermal_tpu.cameras import camera_optimizers as jcopt
from nerfstudio_thermal_tpu.cameras import lie_groups as jlie
from nerfstudio_thermal_tpu.cameras import rays as jrays
from nerfstudio_thermal_tpu.fields import density_fields as jdf
from nerfstudio_thermal_tpu.fields import nerfacto_field as jnf
from nerfstudio_thermal_tpu.model_components import ray_generators as jrg
from nerfstudio_thermal_tpu.model_components import ray_samplers as jrs
from nerfstudio_thermal_tpu.model_components import renderers as jrend
from nerfstudio_thermal_tpu.model_components import scene_colliders as jcol
from nerfstudio_thermal_tpu.ops import activations as jact
from nerfstudio_thermal_tpu.ops import encodings as jenc
from nerfstudio_thermal_tpu.ops import mlp as jmlp
from nerfstudio_thermal_tpu.ops import spatial_distortions as jsd
from nerfstudio_thermal_tpu.utils import math as jmath

from nerfstudio_thermal_torch.cameras import camera_optimizers as tcopt
from nerfstudio_thermal_torch.cameras import cameras as tcams
from nerfstudio_thermal_torch.cameras import lie_groups as tlie
from nerfstudio_thermal_torch.cameras import rays as trays
from nerfstudio_thermal_torch.fields import density_fields as tdf
from nerfstudio_thermal_torch.fields import nerfacto_field as tnf
from nerfstudio_thermal_torch.model_components import ray_generators as trg
from nerfstudio_thermal_torch.model_components import ray_samplers as trs
from nerfstudio_thermal_torch.model_components import renderers as trend
from nerfstudio_thermal_torch.model_components import scene_colliders as tcol
from nerfstudio_thermal_torch.ops import activations as tact
from nerfstudio_thermal_torch.ops import encodings as tenc
from nerfstudio_thermal_torch.ops import mlp as tmlp
from nerfstudio_thermal_torch.ops import spatial_distortions as tsd
from nerfstudio_thermal_torch.utils import jax_params
from nerfstudio_thermal_torch.utils import math as tmath

torch.set_num_threads(1)

F32 = 1e-5
BF16 = 2e-2
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
ROOT = Path(__file__).resolve().parents[1]


def close(got, want, tol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def t(a):
    return torch.as_tensor(np.array(a))


def unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def bundles(seed=0, n=24, num_cameras=4):
    """The same rays as a JAX RayBundle and a port RayBundle."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = unit_dirs(rng, n)
    area = np.full((n, 1), 1e-6, np.float32)
    idx = rng.integers(0, num_cameras, (n, 1)).astype(np.int32)
    jb = jrays.RayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                         pixel_area=jnp.asarray(area), camera_indices=jnp.asarray(idx))
    tb = trays.RayBundle(origins=t(o), directions=t(d), pixel_area=t(area),
                         camera_indices=t(idx).long())
    return jb, tb


def carried(jax_module, port_module, params):
    """Carry the JAX module's params into the port module."""
    jax_params.load_module(port_module, jax.tree.map(np.asarray, params), "test")


# ----------------------------------------------------------------- ops


def test_trunc_exp_forward_and_clamped_gradient():
    x = np.linspace(-20.0, 20.0, 41, dtype=np.float32)
    want = jact.trunc_exp(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(jact.trunc_exp(v)))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = tact.trunc_exp(xt)
    got.sum().backward()
    close(got, want, 1e-6)
    close(xt.grad, want_g, 1e-6)


@pytest.mark.parametrize("order", [None, math.inf])
def test_scene_contraction(order):
    x = np.random.default_rng(1).normal(scale=2.0, size=(64, 3)).astype(np.float32)
    x[0] = 0.0
    want = jsd.SceneContraction(order=jnp.inf if order else None)(jnp.asarray(x))
    close(tsd.SceneContraction(order=order)(t(x)), want)


@pytest.mark.parametrize("include_input", [True, False])
def test_nerf_encoding(include_input):
    x = np.random.default_rng(2).uniform(0, 1, (50, 3)).astype(np.float32)
    kw = dict(in_dim=3, num_frequencies=7, min_freq_exp=0.0, max_freq_exp=6.0, include_input=include_input)
    want = jenc.NeRFEncoding(**kw).apply({}, jnp.asarray(x))
    got = tenc.NeRFEncoding(**kw)(t(x))
    assert got.shape[-1] == tenc.NeRFEncoding(**kw).out_dim
    # sin of arguments up to 2*pi*64: f32 argument rounding ~1e-5
    close(got, want, 5e-5)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_sh_encoding(levels):
    d = unit_dirs(np.random.default_rng(3), 40)
    close(tenc.SHEncoding(levels)(t(d)), jenc.sh_encoding(jnp.asarray(d), levels))


@pytest.mark.parametrize("exclusive", [False, True])
def test_cumsum_and_safe_normalize(exclusive):
    """cumsum against the triangular-matmul cumsum_mxu (same sums in another
    order: F32 tolerance); safe_normalize including zero vectors."""
    x = np.random.default_rng(15).uniform(0, 2, (6, 4, 33)).astype(np.float32)
    for axis in (-1, 1):
        close(tmath.cumsum(t(x), dim=axis, exclusive=exclusive),
              jmath.cumsum_mxu(jnp.asarray(x), axis=axis, exclusive=exclusive))
    v = np.random.default_rng(16).normal(size=(20, 3)).astype(np.float32)
    v[:3] = 0.0
    close(tmath.safe_normalize(t(v)), jmath.safe_normalize(jnp.asarray(v)))


# -------------------------------------------------------------- cameras


def _camera_arrays(rng):
    """Three perspective cameras with nonzero OpenCV distortion."""
    n_cam = 3
    c2w = np.zeros((n_cam, 3, 4), np.float32)
    for i in range(n_cam):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w[i, :, :3] = q * np.sign(np.linalg.det(q))
        c2w[i, :, 3] = rng.uniform(-1, 1, 3)
    intr = dict(
        fx=np.array([40.0, 55.0, 30.0], np.float32), fy=np.array([42.0, 50.0, 31.0], np.float32),
        cx=np.array([16.0, 20.0, 12.0], np.float32), cy=np.array([12.0, 14.0, 10.0], np.float32),
        width=np.array([32, 40, 24], np.int32), height=np.array([24, 28, 20], np.int32),
        distortion_params=np.array(
            [[0.05, -0.02, 0.003, 0.0, 0.001, -0.002],
             [-0.1, 0.01, 0.0, 0.0, 0.0, 0.0],
             [0.0, 0.0, 0.0, 0.0, 0.002, 0.001]], np.float32),
        camera_type=np.ones(n_cam, np.int32),
    )
    cams = dict(camera_to_worlds=c2w, **intr)
    jc = jcams.Cameras(**{k: jnp.asarray(v) for k, v in cams.items()})
    tc = tcams.Cameras(**{k: t(v) for k, v in cams.items()})
    return jc, tc


def _close_rays(got, want):
    close(got.origins, want.origins)
    close(got.directions, want.directions)
    close(got.pixel_area, want.pixel_area, 1e-4)  # a product of two small differences
    close(got.metadata["directions_norm"], want.metadata["directions_norm"])
    np.testing.assert_array_equal(got.camera_indices.numpy(), np.asarray(want.camera_indices))


@pytest.mark.parametrize("with_pose_correction", [False, True])
def test_generate_rays_with_distortion(with_pose_correction):
    rng = np.random.default_rng(4)
    jc, tc = _camera_arrays(rng)
    idx = rng.integers(0, 3, 50).astype(np.int32)
    coords = (rng.uniform(0, 20, (50, 2)) + 0.5).astype(np.float32)
    opt = None
    if with_pose_correction:
        tangent = (rng.normal(size=(50, 6)) * 0.05).astype(np.float32)
        opt = np.asarray(jlie.exp_map_SO3xR3(jnp.asarray(tangent)))
        close(tlie.exp_map_SO3xR3(t(tangent)), opt)
    want = jax.jit(jc.generate_rays)(
        jnp.asarray(idx), jnp.asarray(coords), None if opt is None else jnp.asarray(opt)
    )
    got = tc.generate_rays(t(idx), t(coords), None if opt is None else t(opt))
    _close_rays(got, want)


def test_ray_generator():
    rng = np.random.default_rng(17)
    jc, tc = _camera_arrays(rng)
    ray_indices = np.stack(
        [rng.integers(0, 3, 40), rng.integers(0, 20, 40), rng.integers(0, 24, 40)], -1
    ).astype(np.int32)
    want = jrg.RayGenerator(jc)(jnp.asarray(ray_indices))
    got = trg.RayGenerator(tc)(t(ray_indices))
    _close_rays(got, want)


def test_non_perspective_cameras_raise():
    with pytest.raises(NotImplementedError):
        tcams.Cameras(
            camera_to_worlds=torch.zeros(1, 3, 4), fx=torch.ones(1), fy=torch.ones(1),
            cx=torch.ones(1), cy=torch.ones(1), width=torch.ones(1), height=torch.ones(1),
            camera_type=torch.tensor([tcams.CameraType.FISHEYE.value]),
        )


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3", "shared_SO3xR3"])
def test_camera_optimizer_apply(mode):
    rng = np.random.default_rng(5)
    n_cam = 4
    adj = (rng.normal(size=(1 if mode.startswith("shared") else n_cam, 6)) * 0.1).astype(np.float32)
    adj[0, 3:] *= 1e-3  # SE3's near-zero branch
    frozen = (1, 3)
    jopt = jcopt.CameraOptimizer(mode=mode, num_cameras=n_cam, non_trainable_camera_indices=frozen)
    topt = tcopt.CameraOptimizer(mode, n_cam, non_trainable_camera_indices=frozen)
    carried(jopt, topt, {"pose_adjustment": adj})
    jb, tb = bundles(5, num_cameras=n_cam)
    want = jopt.apply({"params": {"pose_adjustment": jnp.asarray(adj)}}, jb, method=jopt.apply_to_raybundle)
    got = topt.apply_to_raybundle(tb)
    close(got.origins, want.origins)
    close(got.directions, want.directions)


# ------------------------------------------------------------- sampling


def test_take_below_above_ties():
    a = np.array([[0.0, 0.25, 0.5, 0.5, 0.5, 1.0], [0.0, 0.0, 0.3, 0.6, 0.6, 0.9]], np.float32)
    v = np.array([[-0.1, 0.0, 0.25, 0.5, 0.75, 1.0, 1.2], [0.0, 0.3, 0.6, 0.61, 0.9, 0.95, -1.0]], np.float32)
    values = np.cumsum(np.random.default_rng(6).uniform(0, 1, a.shape), -1).astype(np.float32)
    for side in ("left", "right"):
        want = jrs.take_below_above(jnp.asarray(a), jnp.asarray(v), jnp.asarray(values), side)
        got = trs.take_below_above(t(a), t(v), t(values), side)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _density_fields(seed, dtype):
    jfield = jdf.MLPDensityField(aabb=AABB, num_layers=3, hidden_dim=16, num_frequencies=4,
                                 compute_dtype=dtype, use_pallas=True)
    pos = jnp.asarray(np.random.default_rng(seed).uniform(-2, 2, (8, 4, 3)).astype(np.float32))
    params = jax.jit(jfield.init)(jax.random.PRNGKey(seed), pos)["params"]
    tfield = tdf.MLPDensityField(AABB, num_layers=3, hidden_dim=16, num_frequencies=4,
                                 compute_dtype=getattr(torch, jnp.dtype(dtype).name), use_pallas=True)
    carried(jfield, tfield, params)
    return jfield, params, tfield


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32), (jnp.bfloat16, BF16)])
def test_mlp_density_field(dtype, tol):
    jfield, params, tfield = _density_fields(7, dtype)
    pos = np.random.default_rng(8).uniform(-3, 3, (10, 5, 3)).astype(np.float32)
    want = jax.jit(jfield.apply)({"params": params}, jnp.asarray(pos))
    close(tfield(t(pos)), want, tol)


def test_proposal_sample_eval():
    nets = [_density_fields(s, jnp.float32) for s in (9, 10)]
    jb, tb = bundles(11)
    jb = jcol.NearFarCollider(0.05, 1000.0)(jb, train=False)
    tb = tcol.NearFarCollider(0.05, 1000.0)(tb, train=False)
    jfns = [lambda s, f=f, p=p: f.apply({"params": p}, ray_samples=s) for f, p, _ in nets]
    tfns = [lambda s, f=tf: f(ray_samples=s) for _, _, tf in nets]
    kw = dict(num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=6,
              initial_spacing_kind="piecewise")
    js, jw, _ = jax.jit(lambda b: jrs.proposal_sample(b, jfns, train=False, **kw))(jb)
    ts, tw, _ = trs.proposal_sample(tb, tfns, **kw)
    close(ts.starts, js.starts, 1e-4)  # euclidean bins reach ~1000: rtol governs
    close(ts.ends, js.ends, 1e-4)
    close(ts.spacing_starts, js.spacing_starts)
    for g, w in zip(tw, jw):
        close(g, w)


def test_renderers():
    rng = np.random.default_rng(12)
    r, s = 20, 9
    starts = np.sort(rng.uniform(0.1, 4.0, (r, s + 1)), -1).astype(np.float32)
    dens = rng.uniform(0, 3, (r, s, 1)).astype(np.float32)
    rgb = rng.uniform(0, 1, (r, s, 3)).astype(np.float32)
    common = dict(spacing_starts=np.zeros((r, s, 1), np.float32), spacing_ends=np.ones((r, s, 1), np.float32),
                  s_near=np.zeros((r, 1), np.float32), s_far=np.ones((r, 1), np.float32),
                  origins=np.zeros((r, 3), np.float32), directions=unit_dirs(rng, r),
                  pixel_area=np.ones((r, 1), np.float32), camera_indices=np.zeros((r, 1), np.int32))
    jsamp = jrays.RaySamples(starts=jnp.asarray(starts[:, :-1, None]), ends=jnp.asarray(starts[:, 1:, None]),
                             **{k: jnp.asarray(v) for k, v in common.items()})
    tsamp = trays.RaySamples(starts=t(starts[:, :-1, None]), ends=t(starts[:, 1:, None]),
                             **{k: t(v) for k, v in common.items()})
    jw = jsamp.get_weights(jnp.asarray(dens))
    tw = tsamp.get_weights(t(dens))
    close(tw, jw)
    for bg in ("last_sample", "white", "random"):
        close(trend.render_rgb(t(rgb), tw, bg, train=False), jrend.render_rgb(jnp.asarray(rgb), jw, bg, train=False))
    close(trend.render_accumulation(tw), jrend.render_accumulation(jw))
    close(trend.render_depth_median(tw, tsamp), jrend.render_depth_median(jw, jsamp))
    close(trend.render_depth_expected(tw, tsamp), jrend.render_depth_expected(jw, jsamp))


# --------------------------------------------------------------- fields


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32), (jnp.bfloat16, BF16)])
@pytest.mark.parametrize("skips", [(), (2,)])
def test_eager_mlp(dtype, tol, skips):
    x = np.random.default_rng(13).normal(size=(30, 12)).astype(np.float32)
    jm = jmlp.MLP(num_layers=4, layer_width=32, out_dim=5, skip_connections=skips,
                  out_activation=jax.nn.sigmoid, compute_dtype=dtype)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tm = tmlp.MLP(12, 4, 32, 5, skip_connections=skips, out_activation="sigmoid",
                  compute_dtype=getattr(torch, jnp.dtype(dtype).name))
    jax_params.load_mlp(tm, jax.tree.map(np.asarray, params))
    close(tm(t(x)), jm.apply({"params": params}, jnp.asarray(x)), tol)


def _ray_samples(seed, r=12, s=5):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.05, 5.0, (r, s + 1)), -1).astype(np.float32)
    vals = dict(origins=rng.uniform(-0.5, 0.5, (r, 3)).astype(np.float32), directions=unit_dirs(rng, r),
                pixel_area=np.ones((r, 1), np.float32), camera_indices=rng.integers(0, 3, (r, 1)).astype(np.int32),
                spacing_starts=np.zeros((r, s, 1), np.float32), spacing_ends=np.ones((r, s, 1), np.float32),
                s_near=np.zeros((r, 1), np.float32), s_far=np.ones((r, 1), np.float32))
    js = jrays.RaySamples(starts=jnp.asarray(starts[:, :-1, None]), ends=jnp.asarray(starts[:, 1:, None]),
                          **{k: jnp.asarray(v) for k, v in vals.items()})
    ts = trays.RaySamples(starts=t(starts[:, :-1, None]), ends=t(starts[:, 1:, None]),
                          **{k: t(v) for k, v in vals.items()})
    return js, ts


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (jnp.bfloat16, BF16)])
def test_thermal_nerfacto_field(use_pallas, dtype, tol):
    """freq field: 4 x 128 base MLP passes the fused gate (Pallas in JAX,
    the plain version of the CUDA kernel here) when use_pallas is set."""
    kw = dict(num_images=3, hidden_dim_color=16, appearance_embedding_dim=4,
              use_average_appearance_embedding=True, num_channels=1, use_pallas=use_pallas,
              field_encoding="freq", freq_num_frequencies=4, freq_num_layers=4, freq_hidden_dim=128,
              freq_final_init_scale=0.1)
    jfield = jnf.ThermalNerfactoField(aabb=AABB, compute_dtype=dtype, **kw)
    js, ts = _ray_samples(14)
    params = jax.jit(lambda k, s: jfield.init(k, s, train=True))(jax.random.PRNGKey(2), js)["params"]
    tfield = tnf.ThermalNerfactoField(AABB, compute_dtype=getattr(torch, jnp.dtype(dtype).name), **kw)
    carried(jfield, tfield, params)
    heads = (jnf.FieldHeadNames.DENSITY, jnf.FieldHeadNames.RGB)
    want = jax.jit(lambda p, s: [jfield.apply({"params": p}, s, train=False)[h] for h in heads])(params, js)
    got = tfield(ts, train=False)
    for head, w in zip(heads, want):
        close(got[getattr(tnf.FieldHeadNames, head.name)], w, tol)


def test_hash_fields_raise():
    """The hash fields build; the semantic head, which they do not carry
    yet, raises. The fused ray-march and whole-field knobs do not apply to
    a hash field: as in the JAX module, it computes what it computes
    without them (the positions path)."""
    assert tnf.NerfactoField(AABB, num_images=2, field_encoding="hash", log2_hashmap_size=10).field_encoding == "hash"
    assert tdf.HashMLPDensityField(aabb=AABB, log2_hashmap_size=10).encoding.out_dim == 16
    with pytest.raises(NotImplementedError, match="semantic head"):
        tnf.NerfactoField(AABB, num_images=2, log2_hashmap_size=10, num_semantic_classes=3)
    plain = tnf.NerfactoField(AABB, num_images=3, log2_hashmap_size=10, num_levels=4)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    fused = tnf.NerfactoField(AABB, num_images=3, log2_hashmap_size=10, num_levels=4, fused_raymarch=True,
                              fused_field=True)
    fused.load_state_dict(plain.state_dict())
    _, ts = _ray_samples(16)
    with torch.no_grad():
        want, got = plain(ts, train=True), fused(ts, train=True)
        torch.testing.assert_close(fused.get_density_from_rays(ts), plain.get_density_from_rays(ts), rtol=0, atol=0)
    for head in want:
        torch.testing.assert_close(got[head], want[head], rtol=0, atol=0)


def test_carry_over_rejects_mismatched_trees():
    tm = tmlp.MLP(4, 2, 8, 1)
    good = {"Dense_0": {"kernel": np.zeros((4, 8)), "bias": np.zeros(8)},
            "Dense_1": {"kernel": np.zeros((8, 1)), "bias": np.zeros(1)}}
    jax_params.load_mlp(tm, good)
    with pytest.raises(KeyError):
        jax_params.load_mlp(tm, {**good, "Dense_2": good["Dense_1"]})
    with pytest.raises(ValueError):
        jax_params.load_mlp(tm, {**good, "Dense_1": {"kernel": np.zeros((8, 2)), "bias": np.zeros(1)}})


# --------------------------------------------------------------- guards


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "nerfstudio_thermal_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    banned = ("jax", "jaxlib", "flax", "optax", "nerfstudio_thermal_tpu")
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in banned, f"{f.relative_to(ROOT)} imports {mod}"
