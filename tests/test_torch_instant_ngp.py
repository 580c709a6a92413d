"""instant-ngp and instant-ngp-bounded against the JAX package, on the CPU.

- AABBBoxCollider and SphereCollider give JAX's near / far on the same
  rays (hits, misses, near-zero direction components, bounds already on
  the bundle), in training and at eval: 1e-6 abs (f32, same formulas).
- `update_occupancy_grid` with the same field params and JAX's own draws
  (its `idx` and `jitter`, rebuilt from the split of the update's key)
  gives JAX's grid (rel 1e-5: the f32 hash field of two frameworks), and
  `occupancy_mask` / `_cell_index` JAX's cells on points inside, outside
  and on the edge of the box (exact).
- One f32 training step of each method from the JAX model's params, batch
  and draws (the jitter from key_model, the grid's from key_extra, the
  random background from key_loss): losses and metrics rel 1e-4,
  `num_samples_per_ray` exact, the field's gradient (JAX's first Adam
  moment / 0.1) rel L2 1e-3, the Adam moments, and the grid after step
  0's update (rel 1e-5) -- tests/test_torch_train.py's tolerances.
- DynamicBatchPipeline gives JAX's bucket sequence for the same scalars
  (exact: Python's round of the same log2).
- A CPU setup_trainer -> train() run whose num_rays_override changes
  under the dynamic-batch pipeline saves its grid with the checkpoint; a
  resumed trainer restores grid and override source.
- ns-train / ns-eval / ns-render round trip of an instant-ngp-bounded run.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.cameras.rays import RayBundle as JaxRayBundle
from nerfstudio_thermal_tpu.configs.dataparser_configs import build_dataparser as jax_build_dataparser
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.serialization import to_dict as jax_to_dict
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSampler as JaxSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSamplerConfig as JaxSamplerConfig
from nerfstudio_thermal_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step
from nerfstudio_thermal_tpu.model_components import occupancy_grid as jax_grid
from nerfstudio_thermal_tpu.model_components import scene_colliders as jax_colliders
from nerfstudio_thermal_tpu.models.instant_ngp import InstantNGPModel as JaxInstantNGPModel
from nerfstudio_thermal_tpu.pipelines.dynamic_batch import DynamicBatchPipeline as JaxDynamicBatchPipeline
from nerfstudio_thermal_tpu.pipelines.dynamic_batch import DynamicBatchPipelineConfig as JaxDynamicConfig

from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.configs.method_configs import descriptions, get_method_config, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config, save_config, to_dict
from nerfstudio_thermal_torch.data.dataparsers.instant_ngp_dataparser import InstantNGP
from nerfstudio_thermal_torch.data.dataparsers.nerfstudio_dataparser import Nerfstudio
from nerfstudio_thermal_torch.model_components import occupancy_grid
from nerfstudio_thermal_torch.model_components import scene_colliders
from nerfstudio_thermal_torch.models.instant_ngp import InstantNGPModel
from nerfstudio_thermal_torch.pipelines.dynamic_batch import DynamicBatchPipeline, DynamicBatchPipelineConfig
from nerfstudio_thermal_torch.scripts import eval as ns_eval
from nerfstudio_thermal_torch.scripts import render as ns_render
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils.jax_params import export_jax_extra, export_jax_tree, load_jax_extra, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_all_methods_train import make_ingp_fixture
from tests.test_torch_config_cli import _port_tags
from tests.test_torch_configs import _field_differences
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, adam_state, flat, port_moments, rel_l2

torch.set_num_threads(1)

METHODS = ["instant-ngp", "instant-ngp-bounded"]
NUM_RAYS = 32
GRID_TOL = 1e-5  # rel: the grid holds f32 densities of the two frameworks' hash fields
COLLIDER_TOL = 1e-6  # abs: the same f32 formulas


def tiny_ngp(model_config, dtype="float32"):
    m = model_config
    m.num_levels = 4
    m.log2_hashmap_size = 10
    m.max_res = 64
    m.num_samples_per_ray = 16
    m.grid_resolution = 16
    m.appearance_embed_dim = 4
    m.eval_num_rays_per_chunk = 64
    m.compute_dtype = dtype
    return m


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return {
        "instant-ngp": make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("ns"), num_pairs=3),
        "instant-ngp-bounded": make_ingp_fixture(tmp_path_factory.mktemp("ingp"), n=5),
    }


def _method(get, name, scene):
    method = get(name)
    tiny_ngp(method.model)
    method.datamanager.train_num_rays_per_batch = NUM_RAYS
    method.datamanager.use_native_sampler = False  # the batches are JAX's Python sampler's
    method.dataparser.data = scene
    method.data = scene
    return method


# ---- configs ---------------------------------------------------------------


@pytest.mark.parametrize("name", METHODS)
def test_config_equals_jax(name, tmp_path):
    port, want = get_method_config(name), jax_method_config(name)
    assert _field_differences(type(port), type(want), name, port, want) == []
    assert to_dict(port) == _port_tags(jax_to_dict(want))
    assert descriptions[name] == want.description
    save_config(port, tmp_path / "config.yml")
    assert load_config(tmp_path / "config.yml") == port


def test_train_help_lists_instant_ngp(capsys):
    assert ns_train.main(["--help"], device="cpu") == 0
    out = capsys.readouterr().out
    for name in METHODS:
        assert f"  {name:24s} {descriptions[name]}" in out, name


def test_setup_trainer_builds_the_parser_and_pipeline(scenes, tmp_path):
    for name, parser in (("instant-ngp", Nerfstudio), ("instant-ngp-bounded", InstantNGP)):
        trainer = setup_trainer(_method(get_method_config, name, scenes[name]), base_dir=tmp_path / name, device="cpu")
        assert type(trainer.datamanager.dataparser) is parser
        assert type(trainer.model) is InstantNGPModel
        assert type(trainer.pipeline) is DynamicBatchPipeline
        assert set(trainer.model.param_groups()) == {"fields"}


# ---- colliders --------------------------------------------------------------


def _rays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4, 0] = 0.0  # axis-parallel rays
    d[4:8, 1] = 1e-12
    d[8:12, 2] = -1e-12
    return o, d


@pytest.mark.parametrize("kind", ["aabb", "sphere"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("prior_bounds", [False, True])
def test_colliders_match_jax(kind, train, prior_bounds):
    o, d = _rays()
    nears = fars = None
    if prior_bounds:
        nears = np.full((o.shape[0], 1), 0.5, np.float32)
        fars = np.full((o.shape[0], 1), 3.0, np.float32)
    aabb = np.array([[-1.0, -0.8, -1.2], [1.0, 0.9, 1.1]], np.float32)
    if kind == "aabb":
        jc, pc = jax_colliders.AABBBoxCollider(jnp.asarray(aabb), 0.05), scene_colliders.AABBBoxCollider(aabb, 0.05)
    else:
        jc = jax_colliders.SphereCollider([0.1, -0.2, 0.0], 1.3, 0.05)
        pc = scene_colliders.SphereCollider([0.1, -0.2, 0.0], 1.3, 0.05)
    jb = jc(JaxRayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d), pixel_area=jnp.ones((o.shape[0], 1)),
                         camera_indices=jnp.zeros((o.shape[0], 1), jnp.int32), nears=None if nears is None else jnp.asarray(nears),
                         fars=None if fars is None else jnp.asarray(fars)), train=train)
    pb = pc(RayBundle(origins=torch.tensor(o), directions=torch.tensor(d), pixel_area=torch.ones(o.shape[0], 1),
                      camera_indices=torch.zeros(o.shape[0], 1, dtype=torch.long), nears=None if nears is None else torch.tensor(nears),
                      fars=None if fars is None else torch.tensor(fars)), train=train)
    for key in ("nears", "fars"):
        np.testing.assert_allclose(getattr(pb, key).numpy(), np.asarray(getattr(jb, key)), atol=COLLIDER_TOL,
                                   rtol=0, err_msg=key)


# ---- occupancy grid ---------------------------------------------------------


def _jax_model(name, scene, params_seed=0):
    jm = _method(jax_method_config, name, scene)
    parsed = jax_build_dataparser(jm.dataparser).get_dataparser_outputs("train")
    dataset = JaxDataset(parsed)
    model = JaxInstantNGPModel(jm.model, parsed.scene_box, len(dataset), {})
    params = jax.jit(model.init_params)(jax.random.PRNGKey(params_seed))
    return jm, parsed, dataset, model, params


def _grid_draws(key, res, n=2**18):
    """JAX's update_occupancy_grid draws from its key: idx, then jitter."""
    k1, k2 = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k1, (n,), 0, res**3))
    jitter = np.asarray(jax.random.uniform(k2, (n, 3)))
    return torch.tensor(idx), torch.tensor(jitter)


@pytest.mark.parametrize("name", METHODS)
def test_grid_update_and_mask_match_jax(scenes, name):
    jm, parsed, dataset, jmodel, params = _jax_model(name, scenes[name])
    model = InstantNGPModel(get_method_config(name).model.__class__(**vars(jm.model)), parsed.scene_box,
                            len(dataset), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    res = jm.model.grid_resolution
    grid, jgrid = model.init_extra_state(), jmodel.init_extra_state()
    for i in range(2):  # two updates: the second decays the first
        key = jax.random.PRNGKey(7 + i)
        jgrid = jax.jit(jmodel.update_grid)(params, jgrid, key)
        grid = model.update_grid(grid, None, *_grid_draws(key, res))
        want = np.asarray(jgrid.densities)
        assert rel_l2(grid.densities.numpy(), want) <= GRID_TOL
    np.testing.assert_allclose(grid.densities.numpy(), want, rtol=GRID_TOL, atol=1e-7)

    rng = np.random.default_rng(3)
    lo, hi = parsed.scene_box
    pts = rng.uniform(lo - 0.5, hi + 0.5, (500, 3)).astype(np.float32)
    pts[:8] = np.stack([lo, hi, lo + 1e-7, hi - 1e-7, (lo + hi) / 2, lo - 1, hi + 1, [0.0, 0.0, 0.0]])
    want_idx = np.asarray(jax_grid._cell_index(jgrid, jnp.asarray(pts)))
    np.testing.assert_array_equal(occupancy_grid._cell_index(grid, torch.tensor(pts)).numpy(), want_idx)
    # the mask on the port's grid against JAX's mask of the same grid
    same = jgrid.replace(densities=jnp.asarray(grid.densities.numpy()))
    for thr in (1e-2, float(np.median(want))):
        np.testing.assert_array_equal(occupancy_grid.occupancy_mask(grid, torch.tensor(pts), thr).numpy(),
                                      np.asarray(jax_grid.occupancy_mask(same, jnp.asarray(pts), thr)))


@pytest.mark.parametrize("name", METHODS)
def test_masked_forward_matches_jax(scenes, name):
    """A JAX grid (two updates, then half its cells emptied) carried into
    the port by load_jax_extra: the training forward through the mask gives
    JAX's outputs (rel 1e-4) and the same live-sample count; the eval
    forward passes no grid in either package."""
    jm, parsed, dataset, jmodel, params = _jax_model(name, scenes[name])
    model = InstantNGPModel(get_method_config(name).model.__class__(**vars(jm.model)), parsed.scene_box,
                            len(dataset), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    jgrid = jmodel.init_extra_state()
    for i in range(2):
        jgrid = jax.jit(jmodel.update_grid)(params, jgrid, jax.random.PRNGKey(11 + i))
    dens = np.asarray(jgrid.densities).copy()
    dens[np.random.default_rng(0).random(dens.shape) < 0.5] = 0.0
    jgrid = jgrid.replace(densities=jnp.asarray(dens))
    grid = load_jax_extra(model.init_extra_state(), jgrid)
    np.testing.assert_array_equal(export_jax_extra(grid)["densities"], dens)

    cams = jax.tree.map(jnp.asarray, parsed.cameras)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, len(dataset), NUM_RAYS)
    coords = np.stack([rng.uniform(0, 12, NUM_RAYS), rng.uniform(0, 16, NUM_RAYS)], -1).astype(np.float32)
    jbundle = cams.generate_rays(jnp.asarray(idx), jnp.asarray(coords))
    bundle = model_cameras(parsed).generate_rays(torch.tensor(idx), torch.tensor(coords))
    key = jax.random.PRNGKey(5)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (NUM_RAYS, jm.model.num_samples_per_ray + 1))))
    want = jmodel.forward(params, jbundle, train=True, rng=key, occupancy_grid=jgrid)
    got = model(bundle, train=True, uniforms={"rgb": [u]}, occupancy_grid=grid)
    assert float(got["num_samples_per_ray"]) == float(want["num_samples_per_ray"])
    assert 0 < float(want["num_samples_per_ray"]) < jm.model.num_samples_per_ray
    for k in ("rgb", "accumulation", "expected_depth"):
        assert rel_l2(got[k].detach().numpy(), np.asarray(want[k])) <= LOSS_TOL["float32"], k
    want_eval = jmodel.forward(params, jbundle, train=False)
    got_eval = model(bundle, train=False)
    assert "num_samples_per_ray" not in got_eval
    for k in ("rgb", "accumulation"):
        assert rel_l2(got_eval[k].detach().numpy(), np.asarray(want_eval[k])) <= LOSS_TOL["float32"], k


def model_cameras(parsed):
    from nerfstudio_thermal_torch.cameras.cameras import Cameras

    return Cameras(**{f: torch.as_tensor(np.asarray(getattr(parsed.cameras, f)))
                      for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height",
                                "distortion_params", "camera_type")})


def test_fresh_grid_masks_everything():
    """The grid starts at zero: before any update every sample is masked."""
    grid = occupancy_grid.create_occupancy_grid(8, [[-1, -1, -1], [1, 1, 1]])
    pts = torch.rand(100, 3) * 2 - 1
    assert float(occupancy_grid.occupancy_mask(grid, pts).sum()) == 0.0


# ---- one training step ------------------------------------------------------


@pytest.mark.parametrize("name", METHODS)
def test_train_step_matches_jax(scenes, name, tmp_path):
    jm, parsed, dataset, jmodel, params = _jax_model(name, scenes[name])
    cameras = jax.tree.map(jnp.asarray, parsed.cameras)
    tx = jax_build_optimizer(jm.optimizers, params)
    core = jax_make_ray_train_step(jmodel, tx)
    state = JaxTrainState(
        params=params, opt_state=tx.init(params), step=jnp.asarray(0, jnp.int32),
        steps_since_update=jnp.asarray(0, jnp.int32), steps_since_update_thermal=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(42), extra=jmodel.init_extra_state(),
    )
    batch = JaxSampler(JaxSamplerConfig(NUM_RAYS, 1), dataset, seed=0).sample(step=0)
    new_state, want = jax.jit(lambda st, b: core(st, b, cameras))(state, batch)

    trainer = setup_trainer(_method(get_method_config, name, scenes[name]), base_dir=tmp_path, device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, params))
    trainer.setup()
    _, key_model, key_loss, key_extra = jax.random.split(state.rng, 4)
    samples = jm.model.num_samples_per_ray
    uniforms = {"rgb": [torch.tensor(np.asarray(jax.random.uniform(key_model, (NUM_RAYS, samples + 1))))]}
    background = None
    if jm.model.background_color == "random":
        background = torch.tensor(np.asarray(jax.random.uniform(key_loss, (NUM_RAYS, 3))))
    draws = _grid_draws(key_extra, jm.model.grid_resolution)
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()}, uniforms=uniforms,
                              background_uniforms=background, extra_draws=draws)

    assert set(got) == set(want) == {"loss", "rgb_loss", "psnr", "num_samples_per_ray"}
    assert float(got["num_samples_per_ray"]) == float(want["num_samples_per_ray"])
    assert 0 < float(want["num_samples_per_ray"]) <= samples
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= LOSS_TOL["float32"] * max(abs(float(w)), 1e-3), (k, float(got[k]))
    np.testing.assert_allclose(export_jax_extra(trainer.state.extra)["densities"],
                               np.asarray(new_state.extra.densities), rtol=GRID_TOL, atol=1e-7)
    count, mu, nu = adam_state(new_state.opt_state, "fields")
    assert count == 1
    grads = flat(export_jax_tree(trainer.model, grads=True))
    jax_grads = flat({"fields": jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
    assert set(grads) == set(jax_grads)
    got_g = np.concatenate([grads[k].ravel() for k in sorted(jax_grads)])
    want_g = np.concatenate([jax_grads[k].ravel() for k in sorted(jax_grads)])
    assert rel_l2(got_g, want_g) <= GRAD_TOL["float32"]
    for which, jax_moment in (("mu", mu), ("nu", nu)):
        got_m = flat(port_moments(trainer, which))
        want_m = flat({"fields": jax.tree.map(np.asarray, jax_moment)})
        a = np.concatenate([got_m[k].ravel() for k in sorted(want_m)])
        b = np.concatenate([want_m[k].ravel() for k in sorted(want_m)])
        assert rel_l2(a, b) <= 2 * GRAD_TOL["float32"], which  # nu is the square of the gradient


# ---- dynamic batch ----------------------------------------------------------


class _DM:
    def __init__(self):
        self.num_rays_override = None


def test_dynamic_batch_buckets_match_jax():
    cfg_args = dict(target_num_samples=1 << 18, max_num_rays_per_batch=1 << 14, min_num_rays_per_batch=1 << 10,
                    update_every=4)
    port = DynamicBatchPipeline(_DM(), None, DynamicBatchPipelineConfig(**cfg_args))
    ref = JaxDynamicBatchPipeline(_DM(), None, JaxDynamicConfig(**cfg_args))
    scalars = [192.0, 0.0, float("nan"), 3.0, 100.0, 45.2548, 45.25484, 64.0, 22.6274, 1e6, -1.0, 11.3, 181.0]
    seq_port, seq_ref = [], []
    for step, spr in enumerate(x for s in scalars for x in (s, s, s, s)):
        for pipe, seq in ((port, seq_port), (ref, seq_ref)):
            pipe.after_train_iteration({"num_samples_per_ray": torch.tensor(spr)}, step)
            seq.append(pipe.datamanager.num_rays_override)
    assert seq_port == seq_ref
    assert len(set(seq_port)) > 3
    # no scalar: the batch stays
    port.after_train_iteration({}, 0)
    assert port.datamanager.num_rays_override == seq_port[-1]


def test_dynamic_batch_reads_the_scalar_only_on_update_steps():
    class Tripwire:
        def __float__(self):
            raise AssertionError("read on a step that is not an update step")

    pipe = DynamicBatchPipeline(_DM(), None, DynamicBatchPipelineConfig(update_every=16))
    for step in range(1, 16):
        pipe.after_train_iteration({"num_samples_per_ray": Tripwire()}, step)
    assert pipe.datamanager.num_rays_override is None


# ---- the trainer -------------------------------------------------------------


def test_train_run_resizes_saves_and_restores_the_grid(scenes, tmp_path):
    method = _method(get_method_config, "instant-ngp-bounded", scenes["instant-ngp-bounded"])
    method.trainer.max_num_iterations = 9
    method.trainer.steps_per_save = 4
    method.trainer.steps_per_log = 1
    method.trainer.steps_per_eval_batch = method.trainer.steps_per_eval_image = 0
    method.trainer.steps_per_eval_all_images = 0
    method.dynamic_batch = DynamicBatchPipelineConfig(target_num_samples=2048, max_num_rays_per_batch=256,
                                                      min_num_rays_per_batch=16, update_every=2)
    method.model.grid_update_every = 4
    trainer = setup_trainer(method, base_dir=tmp_path / "run", device="cpu")
    trainer.setup()
    assert float(trainer.state.extra.densities.abs().sum()) == 0.0
    sizes, grids = [], []
    iteration = trainer.train_iteration

    def recording(step):
        out = iteration(step)
        sizes.append(trainer.datamanager.next_train(step)["ray_indices"].shape[0])
        grids.append(trainer.state.extra.densities.clone())
        return out

    trainer.train_iteration = recording
    trainer.train()
    assert sizes[0] != NUM_RAYS and len(set(sizes)) >= 1
    assert trainer.datamanager.num_rays_override in (16, 32, 64, 128, 256)
    # the logged rays/s counts the override (rays/s x s/iteration = the rays)
    logged = [json.loads(line) for line in (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    logged = [r for r in logged if "train/Train Rays / Sec" in r]
    assert [r["step"] for r in logged] == list(range(9))
    for r in logged:
        rays = r["train/Train Rays / Sec"] * r["train/Train Iter (time)"]
        assert rays == pytest.approx(sizes[r["step"]], rel=1e-6), r["step"]
    # the grid moves on steps 0, 4 and 8 only
    moved = [i for i in range(1, len(grids)) if not torch.equal(grids[i], grids[i - 1])]
    assert float(grids[0].abs().sum()) > 0 and moved == [4, 8]
    ckpt = torch.load(sorted((tmp_path / "run" / "nerfstudio_models").glob("*.ckpt"))[-1], weights_only=True)
    assert torch.equal(ckpt["extra"]["densities"], trainer.state.extra.densities)

    method.trainer.load_dir = tmp_path / "run" / "nerfstudio_models"
    resumed = setup_trainer(method, base_dir=tmp_path / "run2", device="cpu")
    resumed.setup()
    assert resumed.state.step == 9
    assert torch.equal(resumed.state.extra.densities, trainer.state.extra.densities)
    assert resumed.state.extra.resolution == trainer.state.extra.resolution


def test_scripts_round_trip_bounded(tmp_path):
    scene = make_ingp_fixture(tmp_path / "scene", n=5, hw=(32, 40))  # LPIPS needs >= 16 px a side
    flags = ["--model.num-levels", "4", "--model.log2-hashmap-size", "10", "--model.max-res", "64",
             "--model.num-samples-per-ray", "16", "--model.grid-resolution", "16",
             "--model.appearance-embed-dim", "4", "--pipeline.model.eval-num-rays-per-chunk", "256",
             "--model.compute-dtype", "float32", "--datamanager.train-num-rays-per-batch", "32",
             "--pipeline.datamanager.eval-num-rays-per-batch", "32",
             "--pipeline.datamanager.dataparser.train-split-fraction", "0.6"]
    argv = ["instant-ngp-bounded", "--data", str(scene), "--output-dir", str(tmp_path / "out"), "--experiment-name", "t",
            "--max-num-iterations", "4", "--steps-per-eval-batch", "2", "--steps-per-eval-image", "2",
            "--steps-per-eval-all-images", "4", *flags]
    assert ns_train.main(argv, device="cpu") == 0
    (run,) = (tmp_path / "out").glob("t/instant-ngp-bounded/*")
    config = load_config(run / "config.yml")
    assert type(config.dataparser).__name__ == "InstantNGPDataParserConfig"
    assert config.model.background_color == "black" and config.dynamic_batch is not None
    out = tmp_path / "eval.json"
    assert ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(out)], device="cpu") == 0
    results = json.loads(out.read_text())["results"]
    assert np.isfinite(results["psnr_rgb"])
    frames = tmp_path / "frames"
    assert ns_render.main(["dataset", "--load-config", str(run / "config.yml"), "--output-path", str(frames),
                           "--rendered-output-names", "rgb", "depth"], device="cpu") == 0
    assert len(list(frames.rglob("*.png"))) >= 2
