"""vanilla-nerf, mipnerf and tensorf against the JAX package, on the CPU.

Tolerances, and why:
- The conical-frustum gaussians and `get_gaussian_blob`: the same f32
  formulas; XLA may contract a product and a sum into one FMA, so rel
  1e-6 (a few ulps) with an absolute floor of 1e-7 on the variances.
- The integrated encoding on the same means and variances: both packages
  take the sin of the same f32 arguments ((2 pi x) 2^k, plus pi / 2), and
  both CPU sines are within an ulp at any argument (|sin_jax - sin_torch|
  read <= 6e-8 up to 2e6 rad), so 2^-22 absolute.
- The NeRFField, whose positions (or gaussian means) the two packages
  compute in f32 each: a one-ulp difference in x moves the argument of
  frequency k by 2 pi 2^k ulp(x), up to ~0.1 rad at 2^15 (mipnerf's
  top frequency). The encoding is held to that bound, each entry to
  exp(-var / 2) 2 pi 2^k |x| 2^-22 + 2^-22 (IPE_SLACK below), and the
  field's outputs and parameter gradients to 1e-4 (f32) and 2e-2 (bf16)
  rel (tests/test_torch_fused_mlp.py's reasons: exact f32 products in
  another order; one flipped bf16 rounding moves a layer by 2^-8). The
  test's pixel areas damp the top frequencies (exp(-var / 2) < 1e-30 at
  2^15), as a real camera's do.
- The TensoRFField: the same gathers and f32 blends, rel 1e-5; bf16 head
  2e-2.
- `refine_host`: the same numpy resample (float64, then f32), so the new
  grids are bitwise JAX's; moments zero, counts kept; the next step then
  at tests/test_torch_train.py's LOSS_TOL / GRAD_TOL.
- One f32 training step of each method through setup_trainer from the JAX
  model's params, batch and both jitter draws (the model's key split into
  the uniform and the pdf sampler's): losses and metrics rel 1e-4, the
  gradient (JAX's first Adam moment / 0.1) rel L2 1e-3 and the moments
  (tests/test_torch_train.py's tolerances).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.cameras import rays as jrays
from nerfstudio_thermal_tpu.configs.dataparser_configs import build_dataparser as jax_build_dataparser
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.method_configs import resolve_model_class as jax_resolve_model_class
from nerfstudio_thermal_tpu.configs.method_configs import setup_trainer as jax_setup_trainer
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSampler as JaxSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSamplerConfig as JaxSamplerConfig
from nerfstudio_thermal_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step
from nerfstudio_thermal_tpu.fields import tensorf_field as jtf
from nerfstudio_thermal_tpu.fields import vanilla_nerf_field as jvf
from nerfstudio_thermal_tpu.ops import encodings as jenc
from nerfstudio_thermal_tpu.utils import math as jmath

from nerfstudio_thermal_torch.cameras import rays as trays
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config
from nerfstudio_thermal_torch.fields import tensorf_field as ttf
from nerfstudio_thermal_torch.fields import vanilla_nerf_field as tvf
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.models.tensorf import TensoRFModel, resize_grid
from nerfstudio_thermal_torch.ops import encodings as tenc
from nerfstudio_thermal_torch.scripts import eval as ns_eval
from nerfstudio_thermal_torch.scripts import render as ns_render
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils import jax_params
from nerfstudio_thermal_torch.utils import math as tmath
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.test_all_methods_train import make_blender_fixture
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, adam_state, flat, port_moments, rel_l2

torch.set_num_threads(1)

GAUSS_TOL = 1e-6
SIN_TOL = 2.0**-22
IPE_SLACK = 2.0**-22
FIELD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TENSORF_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NUM_RAYS = 16
BLENDER = ("vanilla-nerf", "mipnerf", "tensorf")
AABB = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def samples(seed, r=6, s=5, area=1e-4, spread=1.0):
    """The same RaySamples in both packages: origins near a sphere of
    radius 4 looking inwards (a blender camera's rays), bins in [2, 6].
    Origins, directions and bin edges are dyadic (multiples of 2^-4, 2^-6
    and 2^-6), so o + d (s + e) / 2 is exact in f32 and both packages'
    positions are the same bits: the field tests then see no encoding
    difference, which the top frequencies would amplify."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(r, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + rng.normal(scale=0.2 * spread, size=(r, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (np.round(o * 16) / 16).astype(np.float32), (np.round(d * 64) / 64).astype(np.float32)
    edges = (np.round(np.sort(rng.uniform(2.0, 6.0, (r, s + 1)), -1) * 64) / 64).astype(np.float32)
    vals = dict(origins=o, directions=d, pixel_area=np.full((r, 1), area, np.float32),
                camera_indices=np.zeros((r, 1), np.int32), spacing_starts=np.zeros((r, s, 1), np.float32),
                spacing_ends=np.ones((r, s, 1), np.float32), s_near=np.full((r, 1), 2.0, np.float32),
                s_far=np.full((r, 1), 6.0, np.float32))
    js = jrays.RaySamples(starts=jnp.asarray(edges[:, :-1, None]), ends=jnp.asarray(edges[:, 1:, None]),
                          **{k: jnp.asarray(v) for k, v in vals.items()})
    ts = trays.RaySamples(starts=t(edges[:, :-1, None]), ends=t(edges[:, 1:, None]),
                          **{k: t(v) for k, v in vals.items()})
    return js, ts


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---- the integrated positional encoding -------------------------------------


def test_conical_frustum_gaussians_match_jax():
    rng = np.random.default_rng(0)
    o = rng.normal(size=(40, 1, 3)).astype(np.float32)
    d = rng.normal(size=(40, 1, 3)).astype(np.float32)
    d[:3] = 0.0  # a zero direction: |d|^2 clamps to 1e-10
    starts = rng.uniform(0.0, 5.0, (40, 7, 1)).astype(np.float32)
    ends = starts + rng.uniform(1e-4, 0.5, (40, 7, 1)).astype(np.float32)
    radius = rng.uniform(1e-4, 1e-2, (40, 1, 1)).astype(np.float32)
    want = jmath.conical_frustum_to_gaussian_diag(*map(jnp.asarray, (o, d, starts, ends, radius)))
    got = tmath.conical_frustum_to_gaussian_diag(*map(t, (o, d, starts, ends, radius)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), np.asarray(w), rtol=GAUSS_TOL, atol=1e-7)
    x_m, x_v = rng.normal(size=(2, 50)).astype(np.float32) * 3
    np.testing.assert_allclose(np32(tmath.expected_sin(t(x_m), t(np.abs(x_v)))),
                               np.asarray(jmath.expected_sin(jnp.asarray(x_m), jnp.asarray(np.abs(x_v)))),
                               rtol=0, atol=SIN_TOL)


def test_gaussian_blob_matches_jax():
    js, ts = samples(1, area=2.5e-5)
    for g, w in zip(ts.get_gaussian_blob(), js.get_gaussian_blob()):
        assert g.shape == w.shape == (6, 5, 3)
        np.testing.assert_allclose(np32(g), np.asarray(w), rtol=GAUSS_TOL, atol=1e-7)


@pytest.mark.parametrize("num_frequencies", [4, 16])
@pytest.mark.parametrize("include_input", [True, False])
def test_integrated_encoding_matches_jax(num_frequencies, include_input):
    """The same means and variances in both packages: the integrated
    encoding within SIN_TOL, with JAX's variance (no 2 pi, freq^2) and its
    layout [damped sin..., damped cos..., x]; without covs the plain
    encoding is unchanged."""
    rng = np.random.default_rng(num_frequencies)
    x = rng.uniform(-6.0, 6.0, (300, 3)).astype(np.float32)
    var = (10.0 ** rng.uniform(-12, -2, (300, 3))).astype(np.float32)
    kw = dict(in_dim=3, num_frequencies=num_frequencies, min_freq_exp=0.0, max_freq_exp=num_frequencies - 1,
              include_input=include_input)
    jm, tm = jenc.NeRFEncoding(**kw), tenc.NeRFEncoding(**kw)
    want = np.asarray(jm.apply({}, jnp.asarray(x), covs=jnp.asarray(var)))
    got = np32(tm(t(x), covs=t(var)))
    assert got.shape == want.shape == (300, tm.out_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=SIN_TOL)
    # the damping is real: where var 4^k > 100 the top frequency is gone
    damped = var[:, 2] * 4.0 ** (num_frequencies - 1) > 100
    assert damped.any() == (num_frequencies == 16)
    assert np.abs(want[damped, 3 * num_frequencies - 1]).max(initial=0.0) < 1e-6
    np.testing.assert_allclose(np32(tm(t(x))), np.asarray(jm.apply({}, jnp.asarray(x))), rtol=0, atol=SIN_TOL)


# ---- NeRFField --------------------------------------------------------------


def _field_pair(integrated, dtype, fused, seed=3):
    freqs = 16 if integrated else 10
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jfield = jvf.NeRFField(use_integrated_encoding=integrated, position_num_frequencies=freqs,
                           compute_dtype=jdtype, use_pallas=fused)
    tfield = tvf.NeRFField(use_integrated_encoding=integrated, position_num_frequencies=freqs,
                           compute_dtype=getattr(torch, dtype), use_pallas=fused)
    js, ts = samples(seed)
    params = jax.jit(lambda k, s: jfield.init(k, s, train=True))(jax.random.PRNGKey(seed), js)["params"]
    jax_params.load_module(tfield, jax.tree.map(np.asarray, params), "fields")
    return jfield, tfield, params, js, ts


def _ipe_bound(ts, freqs):
    """Per entry of the position encoding, the reach of one ulp of x."""
    means, var = ts.get_gaussian_blob()
    x, v = means.reshape(-1, 3).double(), var.reshape(-1, 3).double()
    f = 2.0 ** torch.arange(freqs, dtype=torch.float64)
    reach = (torch.exp(-0.5 * v[:, :, None] * f**2) * 2 * np.pi * f * x.abs()[:, :, None]).reshape(x.shape[0], -1)
    return (torch.cat([reach, reach, torch.zeros_like(x)], -1) * 2.0**-22 + IPE_SLACK).numpy()


@pytest.mark.parametrize("integrated", [False, True], ids=["nerf", "mipnerf"])
def test_position_encoding_of_the_field_matches_jax(integrated):
    """The field's position encoding on its own samples: the positions
    (or gaussians) each package computes, encoded, within one ulp of x's
    reach at each frequency (derived per entry, see the module doc)."""
    freqs = 16 if integrated else 10
    js, ts = samples(5)
    enc_kw = dict(in_dim=3, num_frequencies=freqs, min_freq_exp=0.0, max_freq_exp=freqs - 1, include_input=True)
    if integrated:
        jm, jv = js.get_gaussian_blob()
        want = jenc.NeRFEncoding(**enc_kw).apply({}, jm.reshape(-1, 3), covs=jv.reshape(-1, 3))
        m, v = ts.get_gaussian_blob()
        got = tenc.NeRFEncoding(**enc_kw)(m.reshape(-1, 3), covs=v.reshape(-1, 3))
        bound = _ipe_bound(ts, freqs)
    else:
        want = jenc.NeRFEncoding(**enc_kw).apply({}, js.get_positions().reshape(-1, 3))
        x = ts.get_positions().reshape(-1, 3)
        got = tenc.NeRFEncoding(**enc_kw)(x)
        f = 2.0 ** np.arange(freqs)
        reach = (2 * np.pi * f * np.abs(np32(x))[:, :, None]).reshape(x.shape[0], -1) * 2.0**-22
        bound = np.concatenate([reach, reach, np.zeros_like(np32(x))], -1) + IPE_SLACK
    assert np.all(np.abs(np32(got) - np.asarray(want)) <= bound)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("integrated", [False, True], ids=["nerf", "mipnerf"])
def test_nerf_field_matches_jax(integrated, dtype, fused):
    """NeRFField at full width (8 x 256, skip 4, last layer 256; 2 x 128
    head): density and rgb, and every parameter's gradient of a weighted
    sum of both. fused: JAX's base stack runs the Pallas fused MLP in
    interpret mode, the port's the fused MLP's plain version (the CUDA
    kernels' yardstick) on a 63- or 99-wide encoded input."""
    jfield, tfield, params, js, ts = _field_pair(integrated, dtype, fused)
    assert tfield.mlp_base._fusable() == fused
    rng = np.random.default_rng(9)
    wd, wr = rng.normal(size=(6, 5, 1)).astype(np.float32), rng.normal(size=(6, 5, 3)).astype(np.float32)

    heads = (jvf.FieldHeadNames.DENSITY, jvf.FieldHeadNames.RGB)

    def jloss(p):
        out = jfield.apply({"params": p}, js, train=True)
        return jnp.sum(out[heads[0]] * wd) + jnp.sum(out[heads[1]] * wr), [out[h] for h in heads]

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    got = tfield(ts, train=True)
    loss = torch.sum(got[FieldHeadNames.DENSITY] * t(wd)) + torch.sum(got[FieldHeadNames.RGB] * t(wr))
    loss.backward()
    tol = FIELD_TOL[dtype]
    for head, w in zip(heads, want):
        g = np32(got[getattr(FieldHeadNames, head.name)])
        assert rel_l2(g, np.asarray(w)) <= tol, head
    grads, want_g = flat(jax_params.export_module(tfield, grads=True)), flat(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want_g)
    if fused:
        assert "mlp_base/Dense_4_kernel" in grads  # the fused layout, 319 x 256 (or 355 x 256)
    got_g = np.concatenate([grads[k].ravel() for k in sorted(want_g)])
    want_all = np.concatenate([want_g[k].ravel() for k in sorted(want_g)])
    assert rel_l2(got_g, want_all) <= GRAD_TOL[dtype], rel_l2(got_g, want_all)


# ---- TensoRFField -------------------------------------------------------------


def _tensorf_pair(dtype, resolution=9, seed=4):
    kw = dict(resolution=resolution, density_components=4, color_components=6, appearance_dim=5, head_mlp_width=16)
    jfield = jtf.TensoRFField(aabb=tuple(map(tuple, AABB.tolist())),
                              compute_dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16, **kw)
    tfield = ttf.TensoRFField(AABB, compute_dtype=getattr(torch, dtype), **kw)
    js, ts = samples(seed, r=10, s=6, spread=4.0)
    params = jax.jit(lambda k, s: jfield.init(k, s, train=True))(jax.random.PRNGKey(seed), js)["params"]
    jax_params.load_module(tfield, jax.tree.map(np.asarray, params), "fields")
    return jfield, tfield, params, js, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensorf_field_matches_jax(dtype):
    """Density (masked outside the open box), rgb (not masked) and every
    gradient; the samples leave the box, and points on the box's faces,
    corners and last grid rows are looked up exactly (clip and floor)."""
    jfield, tfield, params, js, ts = _tensorf_pair(dtype)
    rng = np.random.default_rng(1)
    wd, wr = rng.normal(size=(10, 6, 1)).astype(np.float32), rng.normal(size=(10, 6, 3)).astype(np.float32)

    heads = (jtf.FieldHeadNames.DENSITY, jtf.FieldHeadNames.RGB)

    def jloss(p):
        out = jfield.apply({"params": p}, js, train=True)
        return jnp.sum(out[heads[0]] * wd) + jnp.sum(out[heads[1]] * wr), [out[h] for h in heads]

    (_, (dens, rgb)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    got = tfield(ts, train=True)
    (torch.sum(got[FieldHeadNames.DENSITY] * t(wd)) + torch.sum(got[FieldHeadNames.RGB] * t(wr))).backward()
    dens = np.asarray(dens)
    assert (dens == 0).any() and (dens > 0).any()  # some samples outside the box, some inside
    tol = TENSORF_TOL[dtype]
    np.testing.assert_allclose(np32(got[FieldHeadNames.DENSITY]), dens, rtol=tol, atol=tol)
    np.testing.assert_allclose(np32(got[FieldHeadNames.RGB]), np.asarray(rgb), rtol=tol, atol=tol)
    grads, want_g = flat(jax_params.export_module(tfield, grads=True)), flat(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want_g) and "basis/kernel" in grads
    for k in want_g:
        assert rel_l2(grads[k], want_g[k]) <= max(tol, 1e-4), k
    # faces, corners and the box's edges: the clip and floor of both
    pts = np.concatenate([AABB, AABB.mean(0, keepdims=True), [[1.5, -1.5, 0.3], [1.4999999, 1.5, -1.5],
                                                               [-1.6, 0.0, 0.0], [0.0, 0.0, 1.6]]]).astype(np.float32)
    want_d = jfield.apply({"params": params}, jnp.asarray(pts), method=jfield.density_fn)
    np.testing.assert_allclose(np32(tfield.density_fn(t(pts))), np.asarray(want_d), rtol=tol, atol=tol)


def test_tensorf_lookups_match_jax():
    rng = np.random.default_rng(2)
    plane, line = rng.normal(size=(7, 7, 3)).astype(np.float32), rng.normal(size=(7, 3)).astype(np.float32)
    u = np.concatenate([rng.uniform(-1, 8, 50), [0.0, 6.0, 5.9999995, 3.0]]).astype(np.float32)
    v = np.concatenate([rng.uniform(-1, 8, 50), [6.0, 0.0, 6.0, 2.5]]).astype(np.float32)
    np.testing.assert_allclose(np32(ttf.bilinear_plane(t(plane), t(u), t(v))),
                               np.asarray(jtf._bilinear_plane(jnp.asarray(plane), jnp.asarray(u), jnp.asarray(v))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np32(ttf.linear_line(t(line), t(u))),
                               np.asarray(jtf._linear_line(jnp.asarray(line), jnp.asarray(u))), rtol=1e-6, atol=1e-6)


# ---- the four methods' training steps ----------------------------------------


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    return make_blender_fixture(tmp_path_factory.mktemp("blender"), n=3, hw=(12, 16))


def tiny(name, m):
    """Cut a blender method's samples (and TensoRF's grids); the NeRF
    fields keep their full widths."""
    m.compute_dtype = "float32"
    m.eval_num_rays_per_chunk = 64
    for attr, val in (("num_coarse_samples", 6), ("num_importance_samples", 5), ("num_uniform_samples", 10),
                      ("num_samples", 4), ("resolution", 8), ("final_resolution", 12), ("density_components", 3),
                      ("color_components", 4), ("appearance_dim", 5)):
        if hasattr(m, attr):
            setattr(m, attr, val)
    return m


def _method(get, name, scene, rays=NUM_RAYS):
    method = get(name)
    tiny(name, method.model)
    method.datamanager.train_num_rays_per_batch = rays
    method.datamanager.use_native_sampler = False
    method.dataparser.data = scene
    method.data = scene
    return method


class JaxRun:
    """The JAX model, its params and a jitted train step of one method."""

    def __init__(self, name, scene, seed=0):
        self.method = _method(jax_method_config, name, scene)
        parsed = jax_build_dataparser(self.method.dataparser).get_dataparser_outputs("train")
        self.dataset = JaxDataset(parsed)
        self.cameras = jax.tree.map(jnp.asarray, parsed.cameras)
        metadata = dict(parsed.metadata)
        metadata["is_thermal"] = list(self.dataset.is_thermal)
        self.model = jax_resolve_model_class(self.method.model)(self.method.model, parsed.scene_box,
                                                                len(self.dataset), metadata)
        self.params = jax.jit(self.model.init_params)(jax.random.PRNGKey(seed))
        self.tx = jax_build_optimizer(self.method.optimizers, self.params)
        core = jax_make_ray_train_step(self.model, self.tx)
        self.step_fn = jax.jit(lambda state, batch: core(state, batch, self.cameras))

    def state(self):
        return JaxTrainState(
            params=self.params, opt_state=self.tx.init(self.params), step=jnp.asarray(0, jnp.int32),
            steps_since_update=jnp.asarray(0, jnp.int32), steps_since_update_thermal=jnp.asarray(0, jnp.int32),
            rng=jax.random.PRNGKey(42), extra=None,
        )

    def batch(self, step):
        return JaxSampler(JaxSamplerConfig(NUM_RAYS, 1), self.dataset, seed=0).sample(step=step)


def two_draws(rng, m, rays=NUM_RAYS):
    """A coarse / fine model's jitter in the step that starts from key
    `rng`: key_model split into the uniform and the pdf sampler's keys."""
    _, key_model, _, _ = jax.random.split(rng, 4)
    k_u, k_pdf = jax.random.split(key_model)
    coarse = getattr(m, "num_coarse_samples", getattr(m, "num_uniform_samples", None))
    fine = getattr(m, "num_importance_samples", getattr(m, "num_samples", None))
    return {"rgb": [torch.tensor(np.asarray(jax.random.uniform(k_u, (rays, coarse + 1)))),
                    torch.tensor(np.asarray(jax.random.uniform(k_pdf, (rays, fine + 1))))]}


def assert_step_matches(new_state, want, trainer, got, count=1):
    """Every loss and metric, the gradient (from JAX's first moment after
    its first update) and both moments."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(float(got[k])), k
        assert abs(float(got[k]) - w) <= LOSS_TOL["float32"] * max(abs(w), 1e-3), (k, float(got[k]), w)
    jcount, mu, nu = adam_state(new_state.opt_state, "fields")
    assert jcount == count == trainer.optimizers.groups["fields"].count
    if count == 1:
        grads = flat(export_jax_tree(trainer.model, grads=True))
        jax_grads = flat({"fields": jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        assert set(grads) == set(jax_grads)
        got_g = np.concatenate([grads[k].ravel() for k in sorted(jax_grads)])
        want_g = np.concatenate([jax_grads[k].ravel() for k in sorted(jax_grads)])
        assert rel_l2(got_g, want_g) <= GRAD_TOL["float32"], rel_l2(got_g, want_g)
    for which, moment in (("mu", mu), ("nu", nu)):
        got_m, want_m = flat(port_moments(trainer, which)), flat({"fields": jax.tree.map(np.asarray, moment)})
        a = np.concatenate([got_m[k].ravel() for k in sorted(want_m)])
        b = np.concatenate([want_m[k].ravel() for k in sorted(want_m)])
        assert rel_l2(a, b) <= 2 * GRAD_TOL["float32"], which  # nu is the square of the gradient


def port_trainer(name, scene, params, tmp_path):
    trainer = setup_trainer(_method(get_method_config, name, scene), base_dir=tmp_path, device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, params))
    trainer.setup()
    return trainer


@pytest.fixture
def low_frequencies(monkeypatch):
    """vanilla-nerf's fields at 4 position frequencies in both packages.
    At the method's 10 the two packages' ray positions differ by ulps
    (each its own ray generation and pdf cumsum) and the top frequency, 2
    pi 2^9 rad per unit, amplifies that through the relu masks to ~2% of
    the base stack's gradient (measured; the card-vs-CPU effect of
    ROADMAP C4). test_nerf_field_matches_jax holds the full-width field on
    identical positions instead."""
    import functools

    import nerfstudio_thermal_torch.models.vanilla_nerf as tvn
    import nerfstudio_thermal_tpu.models.vanilla_nerf as jvn

    monkeypatch.setattr(jvn, "NeRFField", functools.partial(jvf.NeRFField, position_num_frequencies=4))
    monkeypatch.setattr(tvn, "NeRFField", functools.partial(tvf.NeRFField, position_num_frequencies=4))


@pytest.mark.parametrize("name", BLENDER)
def test_train_step_matches_jax(blender, name, tmp_path, request):
    if name == "vanilla-nerf":
        request.getfixturevalue("low_frequencies")
    run = JaxRun(name, blender)
    state = run.state()
    batch = run.batch(0)
    new_state, want = run.step_fn(state, batch)
    trainer = port_trainer(name, blender, run.params, tmp_path)
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              uniforms=two_draws(state.rng, run.method.model))
    assert_step_matches(new_state, want, trainer, got)


def test_vanilla_nerf_use_pallas_step_matches_jax(blender, tmp_path, low_frequencies):
    """use_pallas: JAX's two base stacks through the Pallas fused MLP
    (interpret mode, flat param names), the port's through the fused MLP's
    plain version; the same step as the eager one."""
    jm = jax_method_config("vanilla-nerf")
    run = JaxRun.__new__(JaxRun)
    run.method = _method(lambda n: jm, "vanilla-nerf", blender)
    run.method.model.use_pallas = True
    parsed = jax_build_dataparser(run.method.dataparser).get_dataparser_outputs("train")
    run.dataset = JaxDataset(parsed)
    run.cameras = jax.tree.map(jnp.asarray, parsed.cameras)
    run.model = jax_resolve_model_class(run.method.model)(run.method.model, parsed.scene_box, len(run.dataset), {})
    run.params = jax.jit(run.model.init_params)(jax.random.PRNGKey(1))
    run.tx = jax_build_optimizer(run.method.optimizers, run.params)
    core = jax_make_ray_train_step(run.model, run.tx)
    state = run.state()
    batch = run.batch(2)
    new_state, want = jax.jit(lambda st, b: core(st, b, run.cameras))(state, batch)
    assert "Dense_0_kernel" in run.params["fields"]["coarse"]["mlp_base"]
    method = _method(get_method_config, "vanilla-nerf", blender)
    method.model.use_pallas = True
    trainer = setup_trainer(method, base_dir=tmp_path, device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, run.params))
    trainer.setup()
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              uniforms=two_draws(state.rng, method.model))
    assert_step_matches(new_state, want, trainer, got)


# ---- TensoRF's grid upsampling ------------------------------------------------


def _refine_runs(blender, tmp_path, iters=(1, 2)):
    """A JAX trainer and the port's, from the same params, with the grids
    upsampled after steps `iters`."""
    jm = _method(jax_method_config, "tensorf", blender)
    jm.model.upsampling_iters = iters
    jm.trainer.steps_per_eval_batch = jm.trainer.steps_per_eval_image = jm.trainer.steps_per_eval_all_images = 0
    jm.trainer.num_devices = 1
    jtrainer = jax_setup_trainer(jm, base_dir=tmp_path / "jax")
    jtrainer.setup()
    pm = _method(get_method_config, "tensorf", blender)
    pm.model.upsampling_iters = iters
    trainer = setup_trainer(pm, base_dir=tmp_path / "port", device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, jtrainer.state.params))
    trainer.setup()
    return jtrainer, trainer


def test_resolution_schedule_matches_jax(blender):
    for iters, res, final in (((2000, 3000, 4000, 5500, 7000), 128, 300), ((1, 2), 8, 12), ((5,), 16, 17)):
        jm, pm = jax_method_config("tensorf").model, get_method_config("tensorf").model
        for m in (jm, pm):
            m.upsampling_iters, m.resolution, m.final_resolution = iters, res, final
        aabb = AABB
        jmodel = jax_resolve_model_class(jm)(jm, aabb, 3, {})
        model = TensoRFModel(pm, aabb, 3, device="cpu")
        assert model.resolution_schedule() == jmodel._resolution_schedule()
        assert all(model.wants_host_refinement(s) == jmodel.wants_host_refinement(s) for s in range(-1, 8000, 250))
    assert model.resolution_schedule() == {5: 17}


def test_refine_host_matches_jax(blender, tmp_path):
    """Three steps with the grids upsampled after steps 1 and 2 (8 -> 10 ->
    12), JAX's jitter passed to the port, each step and each upsample from
    JAX's parameters: every step's losses and moments match (the last runs
    on the twice-resampled grids); after each upsample the grids equal
    JAX's bitwise, every grid's Adam moments are zero in both, the other
    moments and the count are kept."""
    jtrainer, trainer = _refine_runs(blender, tmp_path)
    sampler = JaxSampler(JaxSamplerConfig(NUM_RAYS, 1), jtrainer.datamanager.train_dataset, seed=0)
    for step in range(3):
        rng = jnp.asarray(np.asarray(jtrainer.state.rng))  # the step donates the state's buffers
        batch = sampler.sample(step=step)
        jtrainer.state, want = jtrainer._train_step_jit(jtrainer.state, batch)
        got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                                  uniforms=two_draws(rng, trainer.model.config))
        assert_step_matches(jtrainer.state, want, trainer, got, count=step + 1)
        # the refinement from the same parameters (Adam's +-lr moves of
        # entries with tiny gradients would differ), so the next step also
        # starts from JAX's
        load_jax_params(trainer.model, jax.tree.map(np.asarray, jtrainer.state.params))
        mu_before = flat(port_moments(trainer, "mu"))
        jtrainer._maybe_refine(step)
        trainer._maybe_refine(step)
        count, jmu, _ = adam_state(jtrainer.state.opt_state, "fields")
        assert trainer.optimizers.groups["fields"].count == count == step + 1
        params = flat(export_jax_tree(trainer.model))
        jparams = flat(jax.tree.map(np.asarray, jtrainer.state.params))
        for k in jparams:
            if k.split("/")[1] in ttf.GRID_KEYS:
                np.testing.assert_array_equal(params[k], jparams[k], err_msg=k)
        r = trainer.model.field.resolution
        assert r == {0: 8, 1: 10, 2: 12}[step] and params["fields/density_planes"].shape == (3, r, r, 3)
        if step == 0:
            continue
        mu = flat(port_moments(trainer, "mu"))
        for k, v in flat({"fields": jax.tree.map(np.asarray, jmu)}).items():
            if k.split("/")[1] in ttf.GRID_KEYS:
                assert v.shape == mu[k].shape and not v.any() and not mu[k].any(), k
            else:
                np.testing.assert_array_equal(mu[k], mu_before[k], err_msg=k)


def test_resize_grid_keeps_the_corners():
    """Align-corners linear resampling: each grid axis keeps its first and
    last rows; f32 out."""
    rng = np.random.default_rng(0)
    plane, line = rng.normal(size=(3, 7, 7, 2)).astype(np.float32), rng.normal(size=(3, 7, 5)).astype(np.float32)
    ends = [0, -1]
    for new_r in (7, 9, 16):
        got = resize_grid(plane, new_r)
        assert got.dtype == np.float32 and got.shape == (3, new_r, new_r, 2)
        np.testing.assert_array_equal(got[:, ends][:, :, ends], plane[:, ends][:, :, ends])
        got = resize_grid(line, new_r)
        assert got.dtype == np.float32 and got.shape == (3, new_r, 5)
        np.testing.assert_array_equal(got[:, ends], line[:, ends])


# ---- the entry points ----------------------------------------------------------

SCRIPT_FLAGS = {
    "mipnerf": ["--pipeline.model.num-coarse-samples", "6", "--pipeline.model.num-importance-samples", "5"],
    "tensorf": ["--pipeline.model.num-uniform-samples", "10", "--pipeline.model.num-samples", "4",
                "--pipeline.model.resolution", "8", "--pipeline.model.final-resolution", "12",
                "--pipeline.model.density-components", "3", "--pipeline.model.color-components", "4",
                "--pipeline.model.appearance-dim", "5"],
}


def _ns_train(name, scene, out, steps, extra=()):
    argv = [name, "--data", str(scene), "--output-dir", str(out), "--experiment-name", "t",
            "--max-num-iterations", str(steps), "--steps-per-eval-batch", "2", "--steps-per-eval-image", "2",
            "--steps-per-eval-all-images", str(steps), "--pipeline.model.compute-dtype", "float32",
            "--pipeline.model.eval-num-rays-per-chunk", "512", "--pipeline.datamanager.train-num-rays-per-batch", "32",
            "--pipeline.datamanager.eval-num-rays-per-batch", "32", *SCRIPT_FLAGS[name], *extra]
    assert ns_train.main(argv, device="cpu") == 0
    (run,) = (out / "t" / name).glob("*")
    return run


@pytest.fixture(scope="module")
def blender_32(tmp_path_factory):
    return make_blender_fixture(tmp_path_factory.mktemp("blender32"), n=3, hw=(32, 40))  # LPIPS: >= 16 px a side


def test_scripts_round_trip_mipnerf(blender_32, tmp_path):
    """ns-train writes a mipnerf run (evals every 2 steps), ns-eval reloads
    its config.yml and checkpoint and scores the eval images, ns-render
    renders them."""
    run = _ns_train("mipnerf", blender_32, tmp_path / "out", 4)
    config = load_config(run / "config.yml")
    assert type(config.model).__name__ == "MipNerfModelConfig" and type(config.dataparser).__name__ == "BlenderDataParserConfig"
    events = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
    evals = [e for e in events if "eval/eval_rgb_loss_fine" in e]
    assert evals and all(np.isfinite(e["eval/eval_rgb_loss_fine"]) for e in evals)
    out = tmp_path / "eval.json"
    assert ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(out)], device="cpu") == 0
    results = json.loads(out.read_text())["results"]
    assert np.isfinite(results["psnr_rgb"]) and np.isfinite(results["ssim_rgb"])
    frames = tmp_path / "frames"
    assert ns_render.main(["dataset", "--load-config", str(run / "config.yml"), "--output-path", str(frames),
                           "--rendered-output-names", "rgb", "depth"], device="cpu") == 0
    assert len(list(frames.rglob("*.png"))) >= 2


def test_tensorf_reload_after_an_upsample_fails_as_in_jax(blender, blender_32, tmp_path):
    """A TensoRF checkpoint written after a grid upsample (upsampling_iters
    (2, 4), saved at step 5 with 12^2 grids) reloads into a field built at
    the config's resolution (8) in both packages: JAX's orbax restore and
    the port's load take the saved shapes, and the first apply raises (JAX:
    flax's ScopeParamShapeError naming density_planes; the port: a
    ValueError naming it), for ns-eval and for a resumed ns-train alike. A
    run that ends before its first upsample reloads and evaluates."""
    jm = _method(jax_method_config, "tensorf", blender)
    jm.model.upsampling_iters = (2, 4)
    jm.trainer.max_num_iterations = 5
    jm.trainer.steps_per_eval_batch = jm.trainer.steps_per_eval_image = jm.trainer.steps_per_eval_all_images = 0
    jm.trainer.num_devices = 1
    jtrainer = jax_setup_trainer(copy.deepcopy(jm), base_dir=tmp_path / "jax")
    jtrainer.setup()
    jtrainer.train()
    assert jtrainer.state.params["fields"]["density_planes"].shape == (3, 12, 12, 3)
    jm.trainer.load_dir = tmp_path / "jax" / "nerfstudio_models"
    reloaded = jax_setup_trainer(copy.deepcopy(jm), base_dir=tmp_path / "jax_eval")
    reloaded.setup()
    assert reloaded.state.params["fields"]["density_planes"].shape == (3, 12, 12, 3)
    with pytest.raises(Exception, match="density_planes"):
        reloaded.pipeline.get_average_eval_image_metrics(reloaded.state.params)

    run = _ns_train("tensorf", blender_32, tmp_path / "out", 5, ["--pipeline.model.upsampling-iters", "2,4"])
    ckpt = torch.load(next((run / "nerfstudio_models").glob("*.ckpt")), weights_only=True)
    assert tuple(ckpt["model"]["field.density_planes"].shape) == (3, 12, 12, 3)
    with pytest.raises(ValueError, match="density_planes.*resolution 8"):
        ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(tmp_path / "e.json")],
                     device="cpu")
    config = load_config(run / "config.yml")
    config.trainer.load_dir = run / "nerfstudio_models"
    config.trainer.max_num_iterations = 7
    trainer = setup_trainer(config, base_dir=tmp_path / "resumed", device="cpu")
    trainer.setup()
    assert trainer.model.field.density_planes.shape == (3, 12, 12, 3) and trainer.model.field.resolution == 8
    assert trainer.optimizers.groups["fields"].mu[0].shape == trainer.optimizers.groups["fields"].params[0].shape
    with pytest.raises(ValueError, match="density_planes"):
        trainer.train()

    early = _ns_train("tensorf", blender_32, tmp_path / "early", 3, ["--pipeline.model.upsampling-iters", "5,6"])
    out = tmp_path / "early.json"
    assert ns_eval.main(["--load-config", str(early / "config.yml"), "--output-path", str(out)], device="cpu") == 0
    assert np.isfinite(json.loads(out.read_text())["results"]["psnr_rgb"])
