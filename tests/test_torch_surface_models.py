"""neus and neus-facto against the JAX package, on the CPU.

- `rendering_sdf_with_fixed_inv_s`, `merge_ray_samples` and `neus_sample`
  (a sphere's SDF, JAX's jitter rebuilt from its key splits: split(key,
  1 + num_up_sample_steps)) on the same numpy rays: rel 1e-5 (f32 sums
  and sigmoids in other orders; the sample positions come out of the
  same sorted pdf lookups).
- One f32 training step of each method from the JAX model's params (the
  SDF grid's layer-0 rows perturbed and its table scaled, as in
  tests/test_torch_sdf_field.py, so that the grid gets a gradient), batch
  and jitter: neus's draws split(key_model, 1 + num_up_sample_steps) for
  its sampler and uniform(key_model, (R, S_bg + 1)) for the background;
  neus-facto's split(key_model, 3) for the proposal sampler. Every loss
  and metric, every group's gradient (JAX's first Adam moment / 0.1) and
  both moments. Tolerances: losses rel 1e-4 (LOSS_TOL of
  tests/test_torch_train.py); gradients rel L2 2e-3 per group, twice
  GRAD_TOL, since the SDF's second derivative through softplus(100 x) /
  100 scales XLA's and torch's different roundings of exp, log and the
  products by up to 100 (tests/test_torch_sdf_field.py measures the
  field alone); the moments at twice that (nu is the square).
- The eval outputs of a camera's rays (train=False: cos anneal 1, no
  jitter, the normals taken under torch.no_grad through enable_grad):
  each output's largest error within 5e-4 of its largest entry
  (tests/test_torch_sdf_field.py's FIELD and its reasons; measured <=
  2.7e-4, neus's normals) on the rays whose final samples both packages
  place within 1e-5. An inverse-CDF lookup into a nearly flat CDF step
  turns a rounding difference of the SDF into a moved sample (measured:
  neus moves 2 rays of 40, by 1.7e-5 and 3.7e-3; neus-facto none), so up
  to a tenth of the rays may move, and those are held to finite
  outputs.
- The cos anneal through the trainer's extra state against the JAX
  step's ratio, exactly (both f32 divisions).
- The mono priors: a neus-facto step on an sdfstudio-format scene with
  `mono_normal_loss_mult` and `mono_depth_loss_mult` above 0 (normal and
  depth_image batches), at the step tolerances: every loss, and the
  gradient and moments of the fields group, on which the priors act.
- ns-train -> ns-eval -> ns-render of each method on the CPU.

The SDF grid and the background field have no size knobs in the configs,
so both packages' surface model is patched to a 4-level, 2^10-row,
64-max-res grid (the JAX config's 16 levels of 2^19 rows would make each
CPU step take minutes) and a 3 x 32 background NeRFField (its 10 and 4
frequencies kept).
"""

import functools
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
from nerfstudio_thermal_tpu.data.dataparsers.sdfstudio_dataparser import (
    SDFStudioDataParserConfig as JaxSDFStudioConfig,
)
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSampler as JaxSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSamplerConfig as JaxSamplerConfig
from nerfstudio_thermal_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step
from nerfstudio_thermal_tpu.fields import sdf_field as jsdf
from nerfstudio_thermal_tpu.fields import vanilla_nerf_field as jvf
from nerfstudio_thermal_tpu.model_components.ray_generators import RayGenerator as JaxRayGenerator
from nerfstudio_thermal_tpu.models import base_surface_model as jbsm
from nerfstudio_thermal_tpu.models import neus as jneus

from nerfstudio_thermal_torch.cameras import rays as trays
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config
from nerfstudio_thermal_torch.data.dataparsers.sdfstudio_dataparser import SDFStudioDataParserConfig
from nerfstudio_thermal_torch.fields import sdf_field as tsdf
from nerfstudio_thermal_torch.fields import vanilla_nerf_field as tvf
from nerfstudio_thermal_torch.model_components.ray_generators import RayGenerator
from nerfstudio_thermal_torch.models import base_surface_model as tbsm
from nerfstudio_thermal_torch.models import neus as tneus
from nerfstudio_thermal_torch.scripts import eval as ns_eval
from nerfstudio_thermal_torch.scripts import render as ns_render
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import look_at, make_synthetic_rgbt_dataset
from tests.test_torch_train import LOSS_TOL, adam_state, flat, port_moments, rel_l2
from tests.torch_parallel_worker import BACKGROUND, NEUS_FACTO, SDF_GRID, flatten, run_ranks

torch.set_num_threads(1)

SAMPLER_TOL = 1e-5
STEP_GRAD_TOL = 2e-3
EVAL_TOL = 5e-4
MOVED_RAYS = 0.1
NUM_RAYS = 64
METHODS = ("neus", "neus-facto")


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def small_sdf_grid(monkeypatch):
    """Both packages' surface models with the small SDF grid and a 3 x 32
    background NeRFField (its frequencies kept)."""
    monkeypatch.setattr(jbsm, "SDFField", functools.partial(jsdf.SDFField, **SDF_GRID))
    monkeypatch.setattr(tbsm, "SDFField", functools.partial(tsdf.SDFField, **SDF_GRID))
    monkeypatch.setattr(jbsm, "NeRFField", functools.partial(jvf.NeRFField, **BACKGROUND))
    monkeypatch.setattr(tbsm, "NeRFField", functools.partial(tvf.NeRFField, **BACKGROUND))


def tiny(name, m):
    """Cut a surface method's widths and samples."""
    m.eval_num_rays_per_chunk = 64
    if name == "neus":
        m.sdf_num_layers, m.sdf_hidden_dim, m.sdf_geo_feat_dim = 5, 96, 16  # the skip at layer 4 runs
        m.sdf_num_layers_color, m.sdf_hidden_dim_color = 2, 16
        m.num_samples, m.num_samples_importance, m.num_up_sample_steps, m.num_samples_outside = 8, 8, 2, 6
    else:
        m.sdf_hidden_dim, m.sdf_geo_feat_dim, m.sdf_hidden_dim_color = 32, 8, 16
        m.num_proposal_samples_per_ray, m.num_neus_samples_per_ray = (12, 8), 6
        m.proposal_net_args_list = [dict(a, log2_hashmap_size=10) for a in m.proposal_net_args_list]
    return m


def method(get, name, scene, parser=None):
    m = get(name)
    tiny(name, m.model)
    if parser is not None:
        m.dataparser = parser
    m.datamanager.train_num_rays_per_batch = NUM_RAYS
    m.datamanager.use_native_sampler = False
    m.dataparser.data = scene
    m.data = scene
    return m


def perturbed(params, seed=7):
    """The geometric init zeroes layer 0's rows past x (a first step would
    give the grid no gradient) and the table starts at U(-1e-3, 1e-3):
    perturb those rows and scale the table, so that the grid matters."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    f = dict(params["fields"])
    k = f["glin0"]["kernel"]
    f["glin0"] = dict(f["glin0"], kernel=(k + rng.normal(scale=0.05, size=k.shape)).astype(np.float32))
    if "grid_encoding" in f:
        f["grid_encoding"] = {"hash_table": f["grid_encoding"]["hash_table"] * 100.0}
    return dict(params, fields=f)


class JaxRun:
    """The JAX model, its params and a jitted train step of one method."""

    def __init__(self, name, scene, parser=None, configure=None):
        self.method = method(jax_method_config, name, scene, parser)
        if configure is not None:
            configure(self.method.model)
        parsed = jax_build_dataparser(self.method.dataparser).get_dataparser_outputs("train")
        self.dataset = JaxDataset(parsed)
        self.cameras = jax.tree.map(jnp.asarray, parsed.cameras)
        metadata = dict(parsed.metadata)
        metadata["is_thermal"] = list(self.dataset.is_thermal)
        self.model = jax_resolve_model_class(self.method.model)(self.method.model, parsed.scene_box,
                                                                len(self.dataset), metadata)
        self.params = perturbed(jax.jit(self.model.init_params)(jax.random.PRNGKey(0)))
        self.tx = jax_build_optimizer(self.method.optimizers, self.params)
        core = jax_make_ray_train_step(self.model, self.tx)
        self.step_fn = jax.jit(lambda state, batch: core(state, batch, self.cameras))

    def state(self, step=0):
        params = jax.tree.map(jnp.asarray, self.params)
        return JaxTrainState(
            params=params, opt_state=self.tx.init(params), step=jnp.asarray(step, jnp.int32),
            steps_since_update=jnp.asarray(0, jnp.int32), steps_since_update_thermal=jnp.asarray(0, jnp.int32),
            rng=jax.random.PRNGKey(42), extra=None,
        )

    def batch(self, step):
        return JaxSampler(JaxSamplerConfig(NUM_RAYS, 1), self.dataset, seed=0).sample(step=step)

    def uniforms(self, rng):
        """The port's `uniforms` for the JAX step that starts from key `rng`."""
        _, key_model, _, _ = jax.random.split(rng, 4)
        m = self.method.model
        if hasattr(m, "num_proposal_samples_per_ray"):
            keys = jax.random.split(key_model, len(m.num_proposal_samples_per_ray) + 1)
            return {"rgb": [t(jax.random.uniform(k, (NUM_RAYS, 1))) for k in keys]}
        keys = jax.random.split(key_model, m.num_up_sample_steps + 1)
        return {"rgb": [t(jax.random.uniform(k, (NUM_RAYS, 1))) for k in keys],
                "background": [t(jax.random.uniform(key_model, (NUM_RAYS, m.num_samples_outside + 1)))]}


_RUNS = {}


def jax_run(name, scene):
    """One JaxRun per method on the module's scene (its params and
    compiled step are shared by the step and eval tests)."""
    if (name, scene) not in _RUNS:
        _RUNS[name, scene] = JaxRun(name, scene)
    return _RUNS[name, scene]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4, rgb_hw=(32, 40),
                                       t_hw=(32, 36))


def port_trainer(name, scene, params, tmp_path, parser=None):
    trainer = setup_trainer(method(get_method_config, name, scene, parser), base_dir=tmp_path, device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, params))
    trainer.setup()
    return trainer


def assert_step_matches(new_state, want, trainer, got, groups=None):
    """Every loss and metric; each group's gradient (of `groups`, default
    all) and both Adam moments."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(float(got[k])), k
        assert abs(float(got[k]) - w) <= LOSS_TOL["float32"] * max(abs(w), 1e-3), (k, float(got[k]), w)
    grads = flat(export_jax_tree(trainer.model, grads=True))
    assert {k.split("/")[0] for k in grads} == set(trainer.model.param_groups())
    for group in sorted(groups or trainer.model.param_groups()):
        count, mu, nu = adam_state(new_state.opt_state, group)
        assert count == 1 == trainer.optimizers.groups[group].count
        jax_grads = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        got_g = np.concatenate([grads[k].ravel() for k in sorted(jax_grads)])
        want_g = np.concatenate([jax_grads[k].ravel() for k in sorted(jax_grads)])
        assert np.abs(want_g).max() > 0, group
        assert rel_l2(got_g, want_g) <= STEP_GRAD_TOL, (group, rel_l2(got_g, want_g))
        for which, moment in (("mu", mu), ("nu", nu)):
            got_m, want_m = flat(port_moments(trainer, which)), flat({group: jax.tree.map(np.asarray, moment)})
            a = np.concatenate([got_m[k].ravel() for k in sorted(want_m)])
            b = np.concatenate([want_m[k].ravel() for k in sorted(want_m)])
            assert rel_l2(a, b) <= 2 * STEP_GRAD_TOL, (group, which, rel_l2(a, b))


# ---- the NeuS sampler --------------------------------------------------------


def bundles(seed, r=16):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(r, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (-2.0 * d + rng.normal(scale=0.1, size=(r, 3))).astype(np.float32)
    vals = dict(origins=o, directions=d, pixel_area=np.full((r, 1), 1e-4, np.float32),
                camera_indices=np.zeros((r, 1), np.int32), nears=np.full((r, 1), 0.5, np.float32),
                fars=np.full((r, 1), 3.5, np.float32))
    return (jrays.RayBundle(**{k: jnp.asarray(v) for k, v in vals.items()}),
            trays.RayBundle(**{k: t(v) for k, v in vals.items()}))


def sphere_sdf(pkg, ray_samples):
    """A sphere of radius 0.8 at the frustum starts, [R, S, 1]."""
    pos = ray_samples.origins[..., None, :] + ray_samples.directions[..., None, :] * ray_samples.starts
    norm = jnp.linalg.norm(pos, axis=-1, keepdims=True) if pkg is jnp else torch.linalg.vector_norm(
        pos, dim=-1, keepdim=True)
    return norm - 0.8


def test_rendering_sdf_with_fixed_inv_s_matches_jax():
    jb, tb = bundles(0)
    rng = np.random.default_rng(1)
    edges = np.sort(rng.uniform(0.5, 3.5, (16, 11)), -1).astype(np.float32)
    sdf = rng.normal(scale=0.5, size=(16, 10)).astype(np.float32)
    kw = dict(spacing_starts=edges[:, :-1, None], spacing_ends=edges[:, 1:, None], spacing_kind="uniform",
              s_near=np.full((16, 1), 0.5, np.float32), s_far=np.full((16, 1), 3.5, np.float32))
    js = jb.get_ray_samples(bin_starts=jnp.asarray(edges[:, :-1, None]), bin_ends=jnp.asarray(edges[:, 1:, None]),
                            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    ts = tb.get_ray_samples(bin_starts=t(edges[:, :-1, None]), bin_ends=t(edges[:, 1:, None]),
                            **{k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    for inv_s in (64.0, 512.0):
        want = jneus.rendering_sdf_with_fixed_inv_s(js, jnp.asarray(sdf), inv_s)
        got = tneus.rendering_sdf_with_fixed_inv_s(ts, t(sdf), inv_s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SAMPLER_TOL, atol=SAMPLER_TOL)
    wj, tj = jrays.get_weights_and_transmittance_from_alphas(jnp.asarray(sdf[..., None] ** 2 / 4))
    wt, tt = trays.get_weights_and_transmittance_from_alphas(t(sdf[..., None] ** 2 / 4))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=SAMPLER_TOL, atol=1e-7)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=SAMPLER_TOL, atol=1e-7)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_neus_sample_and_merge_match_jax(train):
    jb, tb = bundles(2)
    key = jax.random.PRNGKey(3)
    kw = dict(num_samples=8, num_samples_importance=12, num_up_sample_steps=3, base_variance=64.0, train=train)
    want = jax.jit(lambda b, k: jneus.neus_sample(b, functools.partial(sphere_sdf, jnp), rng=k, **kw))(jb, key)
    uniforms = [t(jax.random.uniform(k, (16, 1))) for k in jax.random.split(key, 4)] if train else None
    got = tneus.neus_sample(tb, functools.partial(sphere_sdf, torch), uniforms=uniforms, **kw)
    for name in ("starts", "ends", "spacing_starts", "spacing_ends"):
        assert getattr(got, name).shape == (16, 20, 1)
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=SAMPLER_TOL,
                                   atol=SAMPLER_TOL)
    # merging keeps both sets' starts, sorted, and the larger end
    half = tneus.merge_ray_samples(tb, got, got)
    jhalf = jneus.merge_ray_samples(jb, want, want)
    np.testing.assert_allclose(half.spacing_starts.numpy(), np.asarray(jhalf.spacing_starts), rtol=SAMPLER_TOL,
                               atol=SAMPLER_TOL)
    assert half.starts.shape == (16, 40, 1) and bool((torch.diff(half.spacing_starts[..., 0]) >= 0).all())


# ---- training steps ------------------------------------------------------------


@pytest.mark.parametrize("name", METHODS)
def test_train_step_matches_jax(name, scene, tmp_path, small_sdf_grid):
    run = jax_run(name, scene)
    state = run.state()
    batch = run.batch(0)
    new_state, want = run.step_fn(state, batch)
    assert {"eikonal_loss", "rgb_loss", "s_val"} <= set(want)
    trainer = port_trainer(name, scene, run.params, tmp_path)
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              uniforms=run.uniforms(state.rng))
    assert_step_matches(new_state, want, trainer, got)
    assert trainer.state.extra == tneus.CosAnneal(step=0)


@pytest.mark.parametrize("name", METHODS)
def test_eval_outputs_match_jax(name, scene, tmp_path, small_sdf_grid):
    """Every eval output of 40 rays of a camera. A ray whose final samples
    the two packages place apart (an inverse-CDF lookup into a flat CDF
    step amplifies a rounding difference of the SDF) is held only to
    finite outputs; the others to EVAL_TOL, and at most MOVED_RAYS of the
    rays may move."""
    run = jax_run(name, scene)
    trainer = port_trainer(name, scene, run.params, tmp_path)
    idx = np.stack([np.zeros(40), np.arange(40) % 32, (np.arange(40) * 7) % 40], -1).astype(np.int32)
    params = jax.tree.map(jnp.asarray, run.params)
    jbundle = JaxRayGenerator(run.cameras)(jnp.asarray(idx))
    want = jax.jit(lambda p, b: run.model.forward(p, b, train=False))(params, jbundle)
    jsamples = jax.jit(lambda p, b: run.model.sample_and_forward_field(
        p, run.model.collider(b, train=False), train=False, rng=None, cos_anneal_ratio=1.0)["ray_samples"].starts)(
        params, jbundle)
    bundle = RayGenerator(trainer.cameras)(t(idx))
    with torch.no_grad():
        got = trainer.model(bundle, train=False)
        samples = trainer.model.sample_and_forward_field(
            trainer.model.collider(bundle, train=False), train=False, uniforms=None, generator=None,
            cos_anneal_ratio=1.0)["ray_samples"].starts
    same = np.abs(samples.numpy() - np.asarray(jsamples)).max(axis=(1, 2)) <= 1e-5
    assert (~same).sum() <= MOVED_RAYS * len(same), (~same).sum()
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all(), k
        err = np.abs(g - w)[same].max()
        assert err <= EVAL_TOL * max(np.abs(w).max(), 1e-6), (k, err)


def test_cos_anneal_matches_jax(scene, tmp_path, small_sdf_grid):
    """The ratio the step's forward gets, through the trainer's extra
    state, against the JAX step's: min(1, step / anneal_end), exactly."""
    trainer = setup_trainer(method(get_method_config, "neus", scene), base_dir=tmp_path, device="cpu")
    jm = jax_method_config("neus").model
    jmodel = jneus.NeuSModel(jm, np.asarray([[-1.0] * 3, [1.0] * 3], np.float32), 3, {})
    model = trainer.model
    extra = model.init_extra_state()
    for step in (0, 1, 7, 1234, 49999, 50000, 70000):
        extra = model.update_extra_state(extra, step)
        jextra = jmodel.update_extra_state(None, None, jnp.asarray(step, jnp.int32), None)
        want = float(jmodel.extra_forward_kwargs(jextra)["cos_anneal_ratio"])
        assert model.extra_forward_kwargs(extra)["cos_anneal_ratio"] == want, step
    assert model.extra_forward_kwargs(extra)["cos_anneal_ratio"] == 1.0


def sdfstudio_scene(root, frames=5, hw=(16, 20)):
    """An sdfstudio-format scene with monocular priors: wide-angle cameras
    (fx 12) on a ring of radius 2 looking at the origin, random RGB frames,
    depth priors that vary across each frame and unit normals stored in [0,
    1]. The wide view spreads the rays' rendered depths, which the
    scale-and-shift alignment of the depth loss needs (over nearly equal
    depths its 2 x 2 system is singular to f32 rounding)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    h, w = hw
    k = [[12.0, 0, w / 2, 0], [0, 12.0, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    entries = []
    for i in range(frames):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(root / f"im_{i}.png")
        np.save(root / f"depth_{i}.npy", rng.uniform(0.5, 3.0, (h, w)).astype(np.float32))
        n = rng.normal(size=(h, w, 3))
        np.save(root / f"normal_{i}.npy", ((n / np.linalg.norm(n, axis=-1, keepdims=True) + 1) / 2).astype(np.float32))
        c2w = look_at(2.0 * np.array([np.cos(i), np.sin(i), 0.5]))
        entries.append({"rgb_path": f"im_{i}.png", "intrinsics": k, "camtoworld": c2w.tolist(),
                        "mono_depth_path": f"depth_{i}.npy", "mono_normal_path": f"normal_{i}.npy"})
    meta = {"height": h, "width": w, "scene_box": {"aabb": [[-1, -1, -1], [1, 1, 1]]}, "frames": entries,
            "has_mono_prior": True}
    (root / "meta_data.json").write_text(json.dumps(meta))
    return root


def mono_priors(m):
    m.mono_normal_loss_mult, m.mono_depth_loss_mult = 0.05, 0.1


@pytest.fixture(scope="module")
def mono_jax(tmp_path_factory):
    """JAX's neus-facto step on an sdfstudio-format scene with its
    monocular normal and depth priors (compiled once for the one-process
    and the two-rank tests), with the small SDF grid: the scene, the
    parameters, the step's batch and jitter, and its new state and
    scalars."""
    data = tmp_path_factory.mktemp("sdf")
    sdfstudio_scene(data)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbsm, "SDFField", functools.partial(jsdf.SDFField, **SDF_GRID))
        mp.setattr(jbsm, "NeRFField", functools.partial(jvf.NeRFField, **BACKGROUND))
        run = JaxRun("neus-facto", data, JaxSDFStudioConfig(include_mono_prior=True), configure=mono_priors)
        state = run.state()
        batch = run.batch(0)
        new_state, want = run.step_fn(state, batch)
    return {"data": data, "params": run.params, "batch": batch, "uniforms": run.uniforms(state.rng),
            "new_state": new_state, "want": want}


def mono_method(data):
    m = method(get_method_config, "neus-facto", data, SDFStudioDataParserConfig(include_mono_prior=True))
    mono_priors(m.model)
    return m


def test_mono_priors_step_matches_jax(tmp_path, small_sdf_grid, mono_jax):
    """neus-facto on an sdfstudio-format scene with its monocular normal
    and depth priors: the normal and depth_image batches reach the
    normal_loss and depth_loss, as in JAX."""
    batch, want = mono_jax["batch"], mono_jax["want"]
    assert batch["normal"].shape == (NUM_RAYS, 3) and batch["depth_image"].shape == (NUM_RAYS, 1)
    assert {"normal_loss", "depth_loss"} <= set(want)
    trainer = setup_trainer(mono_method(mono_jax["data"]), base_dir=tmp_path / "run", device="cpu")
    load_jax_params(trainer.model, mono_jax["params"])
    trainer.setup()
    port_batch = trainer.datamanager.next_train(0)
    for k, v in batch.items():
        np.testing.assert_array_equal(port_batch[k], v, err_msg=k)
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              uniforms=mono_jax["uniforms"])
    # the priors act on the fields group; on this scene the proposals'
    # gradient (the interlevel loss's alone, as in the step test above) is
    # ~1e-8 against the fields' ~1e2, below f32's resolution of the sums
    assert_step_matches(mono_jax["new_state"], want, trainer, got, groups=["fields"])


def test_mono_priors_two_ranks_match_jax(tmp_path, mono_jax):
    """The same step in two gloo ranks (tests/torch_parallel_worker.py),
    each with half of the rays: the depth prior fits one scale and shift
    over the whole batch and its gradient terms straddle the ranks' rows,
    so each rank computes it on the gathered global batch. The global
    scalars and the summed gradient of the fields group are JAX's
    one-device step's, within the one-process test's tolerances."""
    m = mono_method(mono_jax["data"])
    fields = {f"model.{k}": getattr(m.model, k) for k in (*NEUS_FACTO, "eval_num_rays_per_chunk",
                                                          "mono_normal_loss_mult", "mono_depth_loss_mult")}
    fields = {k: list(v) if isinstance(v, tuple) else v for k, v in fields.items()}
    fields.update({"datamanager.train_num_rays_per_batch": NUM_RAYS, "datamanager.use_native_sampler": False})
    carry = {f"params/{k}": v for k, v in flatten(jax.tree.map(np.asarray, mono_jax["params"])).items()}
    for name, draws in mono_jax["uniforms"].items():
        carry.update({f"uniforms/0/{name}/{i}": u.numpy() for i, u in enumerate(draws)})
    np.savez(tmp_path / "carry.npz", **carry)
    spec = {"method": "neus-facto", "fields": fields, "data": str(mono_jax["data"]), "steps": 1,
            "carry": str(tmp_path / "carry.npz"), "small_surface_fields": True, "sdfstudio_mono_prior": True,
            "grads": True}
    run_ranks(spec, tmp_path / "ranks", world=2)
    (got,) = json.loads((tmp_path / "ranks" / "losses.json").read_text())
    want = mono_jax["want"]
    assert set(got) == set(want) and {"normal_loss", "depth_loss"} <= set(got)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(got[k]), k
        assert abs(got[k] - w) <= LOSS_TOL["float32"] * max(abs(w), 1e-3), (k, got[k], w)
    _, mu, _ = adam_state(mono_jax["new_state"].opt_state, "fields")
    want_g = flat({"fields": jax.tree.map(lambda x: np.asarray(x) / 0.1, mu)})
    got_g = dict(np.load(tmp_path / "ranks" / "grads.npz"))
    a = np.concatenate([got_g[k].ravel() for k in sorted(want_g)])
    b = np.concatenate([want_g[k].ravel() for k in sorted(want_g)])
    assert np.abs(b).max() > 0
    assert rel_l2(a, b) <= STEP_GRAD_TOL, rel_l2(a, b)


# ---- the entry points -------------------------------------------------------------

SCRIPT_FLAGS = {
    "neus": ["--pipeline.model.sdf-num-layers", "5", "--pipeline.model.sdf-hidden-dim", "96",
             "--pipeline.model.sdf-geo-feat-dim", "16", "--pipeline.model.sdf-num-layers-color", "2",
             "--pipeline.model.sdf-hidden-dim-color", "16", "--pipeline.model.num-samples", "8",
             "--pipeline.model.num-samples-importance", "8", "--pipeline.model.num-up-sample-steps", "2",
             "--pipeline.model.num-samples-outside", "6"],
    "neus-facto": ["--pipeline.model.sdf-hidden-dim", "32", "--pipeline.model.sdf-geo-feat-dim", "8",
                   "--pipeline.model.sdf-hidden-dim-color", "16", "--pipeline.model.num-proposal-samples-per-ray",
                   "12,8", "--pipeline.model.num-neus-samples-per-ray", "6"],
}


@pytest.mark.parametrize("name", METHODS)
def test_scripts_round_trip(name, scene, tmp_path, small_sdf_grid):
    """ns-train (evals every 2 steps) writes a run, ns-eval reloads its
    config.yml and checkpoint and scores the eval images, ns-render renders
    rgb, depth and the normals."""
    out = tmp_path / "out"
    argv = [name, "--data", str(scene), "--output-dir", str(out), "--experiment-name", "t",
            "--max-num-iterations", "4", "--steps-per-eval-batch", "2", "--steps-per-eval-image", "2",
            "--steps-per-eval-all-images", "4", "--pipeline.model.eval-num-rays-per-chunk", "512",
            "--pipeline.datamanager.train-num-rays-per-batch", "64",
            "--pipeline.datamanager.eval-num-rays-per-batch", "64",
            "--pipeline.datamanager.dataparser.train-split-fraction", "0.5", *SCRIPT_FLAGS[name]]
    assert ns_train.main(argv, device="cpu") == 0
    (run,) = (out / "t" / name).glob("*")
    config = load_config(run / "config.yml")
    assert type(config.model).__name__ == {"neus": "NeuSModelConfig", "neus-facto": "NeuSFactoModelConfig"}[name]
    events = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
    evals = [e for e in events if "eval/eval_rgb_loss" in e]
    assert len(evals) == 1 and np.isfinite(evals[0]["eval/eval_rgb_loss"])
    ckpt = torch.load(next((run / "nerfstudio_models").glob("*.ckpt")), weights_only=True)
    assert ckpt["extra"] == {"step": 3}
    result = tmp_path / "eval.json"
    assert ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(result)], device="cpu") == 0
    scores = json.loads(result.read_text())["results"]
    assert np.isfinite(scores["psnr_rgb"]) and np.isfinite(scores["ssim_rgb"])
    frames = tmp_path / "frames"
    assert ns_render.main(["dataset", "--load-config", str(run / "config.yml"), "--output-path", str(frames),
                           "--rendered-output-names", "rgb", "depth", "normal_vis"], device="cpu") == 0
    assert len(list(frames.rglob("*.png"))) >= 3
