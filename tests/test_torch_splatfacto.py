"""splatfacto against the JAX package, on the CPU.

Both packages set up the same tiny run (96 random gaussians in a pool of
160, tests/fixtures.make_synthetic_rgbt_dataset through the Nerfstudio
parser at 16 x 20 pixels, f32); the port's model gets the JAX trainer's
parameters through `load_jax_params`.

- The registration equals the JAX package's; `setup_trainer` builds the
  FullImageDatamanager and a SplatfactoModel with no seed points (no
  parser writes `points3D_xyz`: the random cube).
- `render_camera` (tiles and scan): rgb, accumulation and depth within
  3e-5 (abs; depth where covered), radii equal.
- One whole-image train step against JAX's `_build_image_train_step`,
  with its background draw: loss 1e-4 relative, the six groups' gradients
  (JAX's first moment / 0.1) and moments 1e-3 relative L2, grad_accum 1e-3,
  grad_count and max_radii equal; grad_accum is the norm of the means'
  gradient where a gaussian was seen.
- `refine_host` at a step that culls (opacity and scale), splits,
  duplicates, overflows the free slots and resets opacities: alive equal,
  parameters within 1e-6, the touched rows' moments zero, the counts kept;
  the vectorised normal draws are the JAX loop's sequence.
- FullImageDatamanager's image order and images equal JAX's.
- ns-train -> ns-eval -> ns-render -> ns-export gaussian-splat: the PLY's
  bytes equal JAX's from the same parameters.
- Gaussians at the camera plane (their projection overflows) take no
  gradient, as in JAX's compiled step.
- Pinned hazards: the reloaded `_host_alive` is the initial mask in both
  packages; every frame renders at camera 0's size (a smaller frame fails
  in the loss in both); sh_degree_interval and the screen-size settings
  change nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.method_configs import resolve_model_class as jax_resolve
from nerfstudio_thermal_tpu.configs.method_configs import setup_trainer as jax_setup_trainer
from nerfstudio_thermal_tpu.configs.serialization import save_config as jax_save_config
from nerfstudio_thermal_tpu.configs.serialization import to_dict as jax_to_dict
from nerfstudio_thermal_tpu.scripts import exporter as jax_export
from nerfstudio_thermal_tpu.utils import eval_utils as jax_eval_utils

from nerfstudio_thermal_torch.configs.method_configs import descriptions, get_method_config, resolve_model_class
from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config, save_config, to_dict
from nerfstudio_thermal_torch.data.datamanagers import FullImageDatamanager
from nerfstudio_thermal_torch.models.splatfacto import PARAM_KEYS, SplatfactoModel
from nerfstudio_thermal_torch.scripts import eval as ns_eval
from nerfstudio_thermal_torch.scripts import exporter
from nerfstudio_thermal_torch.scripts import render as ns_render
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils.eval_utils import eval_setup
from nerfstudio_thermal_torch.utils.jax_params import (
    export_jax_extra,
    export_jax_moments,
    export_jax_tree,
    load_jax_extra,
    load_jax_moments,
    load_jax_params,
)
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_config_cli import _port_tags
from tests.test_torch_configs import _field_differences
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, adam_state, rel_l2

torch.set_num_threads(1)

HW = (16, 20)
CAP, NUM = 160, 96
REFINE_STEP = 12  # refine_every 2, reset_alpha_every 3: scale cull and opacity reset
RENDER_TOL = 3e-5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=3, rgb_hw=HW, t_hw=HW)


def tiny_splat(method, scene):
    m = method.model
    m.num_random, m.max_num_gaussians, m.random_scale = NUM, CAP, 1.5
    m.refine_every, m.reset_alpha_every, m.warmup_length = 2, 3, 4
    method.data = method.dataparser.data = scene
    method.dataparser.train_split_fraction = 0.5
    method.datamanager.use_native_sampler = False
    return method


def jax_trainer_setup(method, base_dir):
    """The JAX package's setup_trainer and setup (splatfacto's init_params
    runs numpy on the host: not jitted)."""
    trainer = jax_setup_trainer(method, base_dir=base_dir)
    trainer.setup()
    return trainer


@pytest.fixture(scope="module")
def pair(scene, tmp_path_factory):
    """(JAX trainer, the port's trainer with its parameters), built once."""
    root = tmp_path_factory.mktemp("splat")
    jt = jax_trainer_setup(tiny_splat(jax_method_config("splatfacto"), scene), root / "jax")
    trainer = setup_trainer(tiny_splat(get_method_config("splatfacto"), scene), base_dir=root / "port", device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, jt.host_params()))
    trainer.setup()
    trainer.state.extra = load_jax_extra(trainer.state.extra, jax.tree.map(np.asarray, jt.state.extra))
    return jt, trainer


def test_config_equals_jax(tmp_path):
    port, want = get_method_config("splatfacto"), jax_method_config("splatfacto")
    assert _field_differences(type(port), type(want), "splatfacto", port, want) == []
    assert to_dict(port) == _port_tags(jax_to_dict(want))
    assert descriptions["splatfacto"] == want.description
    assert resolve_model_class(port.model).__name__ == jax_resolve(want.model).__name__ == "SplatfactoModel"
    save_config(port, tmp_path / "config.yml")
    assert load_config(tmp_path / "config.yml") == port


def test_setup_builds_the_full_image_manager_without_seed_points(pair):
    jt, trainer = pair
    assert type(trainer.datamanager) is FullImageDatamanager
    model = trainer.model
    assert type(model) is SplatfactoModel and model.seed_points is None and jt.model.seed_points is None
    assert model.num_init == jt.model._num_init == NUM
    assert set(model.param_groups()) == set(PARAM_KEYS) == set(jt.host_params())
    np.testing.assert_array_equal(model._host_alive.numpy(), np.asarray(jt.model._host_alive))


def test_init_scales_match_jax(scene, pair, tmp_path):
    """The 3-NN scale init of the port's own random points equals JAX's
    _avg_knn_dist on them."""
    from nerfstudio_thermal_tpu.models.splatfacto import _avg_knn_dist

    _, trainer = pair
    fresh = setup_trainer(tiny_splat(get_method_config("splatfacto"), scene), base_dir=tmp_path, device="cpu").model
    pts = fresh.xyz.detach().numpy()[:NUM]
    want = np.log(np.maximum(_avg_knn_dist(pts), 1e-6))
    np.testing.assert_allclose(fresh.scales.detach().numpy()[:NUM], np.repeat(want[:, None], 3, 1), rtol=1e-6)
    assert np.all(fresh.scales.detach().numpy()[NUM:] == -5.0)


@pytest.mark.parametrize("rasterizer", ["tiles", "scan"])
def test_render_camera_matches_jax(pair, rasterizer):
    jt, trainer = pair
    jm, model = jt.model, trainer.model
    jm.config.rasterizer = model.config.rasterizer = rasterizer
    try:
        cams = trainer.datamanager.train_cameras
        jcams = jax.tree.map(jnp.asarray, jt.datamanager.train_cameras)
        alive = np.array(jt.state.extra["alive"])
        want = jm.render_camera(jt.state.params, jcams, 1, alive=jnp.asarray(alive), train=False)
        got = model.render_camera(cams, 1, alive=torch.as_tensor(alive), train=False)
    finally:
        jm.config.rasterizer = model.config.rasterizer = "tiles"
    for k in ("rgb", "accumulation"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=RENDER_TOL, err_msg=k)
    covered = np.asarray(want["accumulation"])[..., 0] > 1e-3
    np.testing.assert_allclose(got["depth"].detach().numpy()[..., 0][covered],
                               np.asarray(want["depth"])[..., 0][covered], rtol=1e-4)
    np.testing.assert_array_equal(got["radii"].detach().numpy(), np.asarray(want["radii"]))


def test_gaussians_at_the_camera_plane_take_no_gradient(pair):
    """Gaussians a hair in front of or behind the camera plane overflow in
    the projection (inf, then NaN); they are never composited, and JAX's
    compiled gradient gives their rows zeros. The port's too (eager
    autograd would give NaN), and every other row JAX's within 1e-4."""
    jt, trainer = pair
    jm, model = jt.model, trainer.model
    cams = trainer.datamanager.train_cameras
    c2w = cams.camera_to_worlds[1].numpy()
    params = {k: np.array(v) for k, v in jt.state.params.items()}
    plane = np.arange(6)
    offsets = np.array([1e-5, -1e-5, 1e-4, -1e-4, 3e-5, 0.0])  # along the view axis
    params["xyz"][plane] = c2w[:, 3] + np.array([0.4, -0.3, 0.2]) @ c2w[:, :3].T - offsets[:, None] * c2w[:, 2]
    params["scales"][plane] = np.log(0.3)
    alive = np.array(jt.state.extra["alive"])
    jcams = jax.tree.map(jnp.asarray, jt.datamanager.train_cameras)

    def jloss(p):
        h, w = HW
        return jnp.mean(jm.render_camera(p, jcams, 1, alive=jnp.asarray(alive), train=False, width=w,
                                         height=h)["rgb"])

    want = jax.jit(jax.grad(jloss))({k: jnp.asarray(v) for k, v in params.items()})
    load_jax_params(model, params)
    try:
        model.zero_grad()
        model.render_camera(cams, 1, alive=torch.as_tensor(alive), train=False)["rgb"].mean().backward()
        got = export_jax_tree(model, grads=True)
    finally:
        model.zero_grad()
        load_jax_params(model, jax.tree.map(np.asarray, jt.state.params))
    for k in PARAM_KEYS:
        assert np.isfinite(got[k]).all() and np.isfinite(np.asarray(want[k])).all(), k
        assert np.all(got[k][plane] == 0), k
        assert rel_l2(got[k], want[k]) <= GRAD_TOL["float32"], k


@pytest.fixture(scope="module")
def stepped(pair):
    """Both trainers after one train step on JAX's batch of step 0, with
    JAX's background draw; (JAX state before, JAX state after, scalars of
    each)."""
    jt, trainer = pair
    before = jt.state
    _, key_model, _ = jax.random.split(before.rng, 3)
    background = np.asarray(jax.random.uniform(key_model, (3,)))
    batch = jt.datamanager.next_train(0)
    jbatch = jax.device_put({k: np.asarray(v) for k, v in batch.items()})
    after, jscalars = jt._train_step_jit(before, jbatch)
    jt.state = after
    scalars = trainer._train_step(trainer.state, {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()},
                                  background_uniforms=torch.as_tensor(background))
    return before, after, jscalars, scalars


def test_image_train_step_matches_jax(pair, stepped):
    jt, trainer = pair
    _, after, jscalars, scalars = stepped
    for k in ("loss", "main_loss", "psnr"):
        assert abs(float(scalars[k]) - float(jscalars[k])) <= LOSS_TOL["float32"] * abs(float(jscalars[k])), k
    grads = export_jax_tree(trainer.model, grads=True)
    mu, nu = export_jax_moments(trainer.model, trainer.optimizers, "mu"), export_jax_moments(
        trainer.model, trainer.optimizers, "nu")
    for name in PARAM_KEYS:
        count, jmu, jnu = adam_state(after.opt_state, name)
        assert count == trainer.optimizers.groups[name].count == 1
        assert rel_l2(grads[name], np.asarray(jmu) / np.float32(0.1)) <= GRAD_TOL["float32"], name
        assert rel_l2(mu[name], jmu) <= GRAD_TOL["float32"], name
        assert rel_l2(nu[name], jnu) <= GRAD_TOL["float32"], name
    extra, jextra = export_jax_extra(trainer.state.extra), jax.tree.map(np.asarray, after.extra)
    assert rel_l2(extra["grad_accum"], jextra["grad_accum"]) <= GRAD_TOL["float32"]
    for k in ("grad_count", "max_radii", "alive", "step"):
        np.testing.assert_array_equal(extra[k], jextra[k], err_msg=k)
    # the densification signal: the norm of the 3-D means' gradient
    seen = extra["grad_count"] > 0
    assert seen.any() and not seen.all()
    norm = np.linalg.norm(grads["xyz"], axis=-1)
    np.testing.assert_allclose(extra["grad_accum"][seen], norm[seen], rtol=1e-6)
    assert np.all(extra["grad_accum"][~seen] == 0)


def _refine_inputs(params, extra):
    """Make the step cull (opacity and scale), split, duplicate and
    overflow the free slots."""
    p = {k: np.array(v) for k, v in params.items()}
    e = {k: np.array(v) for k, v in extra.items()}
    p["opacities"][:NUM] = 0.0
    p["opacities"][20:30] = -8.0  # transparent: culled
    p["scales"][:NUM] = np.log(0.05)  # split where the gradient is high
    p["scales"][30:34] = np.log(0.9)  # too big: culled after reset_alpha_every refinements
    p["scales"][40:55] = np.log(0.001)  # duplicated
    e["grad_accum"][:] = 0.0
    e["grad_accum"][:NUM] = 1.0  # 67 split (134 rows) and 15 duplicated: more than the 78 free slots
    e["grad_count"][:] = 1.0
    return p, e


def test_refine_host_matches_jax(pair, stepped):
    jt, trainer = pair
    _, after, _, _ = stepped
    p, e = _refine_inputs(after.params, after.extra)
    want_p, want_opt, want_e = jt.model.refine_host(p, after.opt_state, e, REFINE_STEP)

    model, opt = trainer.model, trainer.optimizers
    load_jax_params(model, p)
    for which in ("mu", "nu"):
        load_jax_moments(model, opt, which, {k: np.asarray(adam_state(after.opt_state, k)[1 + (which == "nu")])
                                             for k in PARAM_KEYS})
    counts = {k: g.count for k, g in opt.groups.items()}
    extra = model.refine_host(opt, REFINE_STEP, load_jax_extra(trainer.state.extra, e))

    alive, want_alive = extra.alive.numpy(), np.asarray(want_e["alive"])
    np.testing.assert_array_equal(alive, want_alive)
    assert alive.sum() == CAP  # 14 culled, every free slot filled
    got = export_jax_tree(model)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want_p[k]), atol=1e-6, rtol=0, err_msg=k)
    assert np.all(got["opacities"] <= np.log(0.2 / 0.8) + 1e-7)  # the opacity reset
    touched = ~np.asarray(e["alive"]) | (np.arange(CAP) >= 20) & (np.arange(CAP) < 34)
    for which in ("mu", "nu"):
        moments = export_jax_moments(model, opt, which)
        for k in PARAM_KEYS:
            _, jmu, jnu = adam_state(want_opt, k)
            want = np.asarray(jnu if which == "nu" else jmu)
            np.testing.assert_array_equal(moments[k], want, err_msg=(which, k))
            assert np.all(moments[k][touched] == 0), (which, k)
    assert counts == {k: g.count for k, g in opt.groups.items()}
    for k in ("grad_accum", "grad_count", "max_radii"):
        assert float(getattr(extra, k).abs().sum()) == 0.0


def test_vectorised_split_draws_are_the_loop_sequence():
    for step in (12, 300, 4100):
        loop = np.random.default_rng(step)
        want = np.stack([np.stack([loop.normal(size=3) for _ in range(2)]) for _ in range(7)])
        np.testing.assert_array_equal(np.random.default_rng(step).normal(size=(7, 2, 3)), want)


def test_full_image_order_matches_jax(pair):
    jt, trainer = pair
    dm, jdm = trainer.datamanager, jt.datamanager
    n = len(dm.train_dataset)
    for step in range(2 * n + 1):
        got, want = dm.next_train(step), jdm.next_train(step)
        assert int(got["camera_index"]) == int(want["camera_index"]), step
        np.testing.assert_array_equal(got["image"], want["image"])
    assert int(dm.next_eval(1)["camera_index"]) == int(jdm.next_eval(1)["camera_index"])


def test_settings_read_nowhere_change_nothing(pair):
    """sh_degree_interval and the three screen-size settings: no line of the
    model reads them, and a render is the same whatever their values (as
    in JAX)."""
    import inspect

    from nerfstudio_thermal_torch.models import splatfacto

    source = inspect.getsource(splatfacto)
    for name in ("sh_degree_interval", "cull_screen_size", "split_screen_size", "stop_screen_size_at"):
        assert f".{name}" not in source and f"{name}:" in source, name  # a field, never read
    _, trainer = pair
    model = trainer.model
    cams = trainer.datamanager.train_cameras
    base = model.render_camera(cams, 0, alive=model._alive(), train=False)["rgb"].detach()
    saved = dataclasses.replace(model.config)
    try:
        model.config.sh_degree_interval, model.config.cull_screen_size = 1, 1e-9
        model.config.split_screen_size, model.config.stop_screen_size_at = 1e-9, 0
        torch.testing.assert_close(model.render_camera(cams, 0, alive=model._alive(), train=False)["rgb"], base,
                                   rtol=0, atol=0)
    finally:
        model.config = saved


def test_every_frame_renders_at_camera_0s_size(scene, tmp_path):
    """A frame smaller than camera 0 fails in the loss in both packages."""
    small = make_synthetic_rgbt_dataset(tmp_path / "mixed", num_pairs=2, rgb_hw=HW, t_hw=(12, 16))
    jt = jax_trainer_setup(tiny_splat(jax_method_config("splatfacto"), small), tmp_path / "jax")
    trainer = setup_trainer(tiny_splat(get_method_config("splatfacto"), small), base_dir=tmp_path / "port",
                            device="cpu")
    trainer.setup()
    heights = trainer.datamanager.train_cameras.height.tolist()
    idx = heights.index(min(heights))
    assert min(heights) < heights[0]
    batch = jt.datamanager.next_train(0)
    batch = {**batch, "camera_index": np.asarray(idx, np.int32),
             "image": trainer.datamanager.train_dataset.get_image(idx)}
    with pytest.raises(TypeError):
        jt._train_step_jit(jt.state, jax.device_put({k: np.asarray(v) for k, v in batch.items()}))
    with pytest.raises(RuntimeError, match="size"):
        trainer._train_step(trainer.state, {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()})


# ---- the entry points ----------------------------------------------------------

FLAGS = ["--pipeline.model.num-random", str(NUM), "--pipeline.model.max-num-gaussians", str(CAP),
         "--pipeline.model.random-scale", "1.5", "--pipeline.model.warmup-length", "2",
         "--pipeline.model.refine-every", "3", "--pipeline.model.densify-grad-thresh", "1e-7",
         "--max-num-iterations", "7", "--trainer.steps-per-eval-image", "3",
         "--trainer.steps-per-eval-all-images", "6", "--trainer.steps-per-save", "100",
         "--pipeline.datamanager.use-native-sampler", "False",
         "--pipeline.datamanager.dataparser.train-split-fraction", "0.5"]


def test_entry_points_and_gaussian_splat_bytes(tmp_path, capsys):
    scene = make_synthetic_rgbt_dataset(tmp_path / "scene", num_pairs=3, rgb_hw=(32, 32), t_hw=(32, 32))  # LPIPS
    out = tmp_path / "out"
    assert ns_train.main(["splatfacto", "--data", str(scene), "--output-dir", str(out), *FLAGS], device="cpu") == 0
    (run,) = out.glob("*/splatfacto/*")
    config = run / "config.yml"
    assert ns_eval.main(["--load-config", str(config), "--output-path", str(tmp_path / "eval.json")],
                        device="cpu") == 0
    assert "psnr_rgb" in capsys.readouterr().out
    assert ns_render.main(["dataset", "--load-config", str(config), "--output-path", str(tmp_path / "frames"),
                           "--rendered-output-names", "rgb", "depth"], device="cpu") == 0
    assert sorted(p.name for p in (tmp_path / "frames").iterdir()) == ["depth", "rgb"]
    assert exporter.main(["gaussian-splat", "--load-config", str(config), "--output-dir", str(tmp_path / "port")],
                         device="cpu") == 0

    # the trained run refined (alive changed) and the reload kept the initial mask
    _, trainer = eval_setup(config, device="cpu")
    saved = trainer.state.extra.alive
    initial = torch.arange(CAP) < NUM
    assert not torch.equal(saved, initial)
    assert torch.equal(trainer.model._host_alive, initial)

    # JAX: a run holding the port's trained parameters and the same checkpoint mask
    method = tiny_splat(jax_method_config("splatfacto"), scene)
    jt = jax_trainer_setup(method, tmp_path / "jax")
    extra = {**jt.state.extra, "alive": jnp.asarray(saved.numpy())}
    jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, export_jax_tree(trainer.model)), extra=extra)
    jax_save_config(method, tmp_path / "jax" / "config.yml")
    jt.save_checkpoint(7)
    _, jreload, _ = jax_eval_utils.eval_setup(tmp_path / "jax" / "config.yml")
    np.testing.assert_array_equal(np.asarray(jreload.state.extra["alive"]), saved.numpy())
    np.testing.assert_array_equal(np.asarray(jreload.pipeline.model._host_alive), initial.numpy())  # stale in JAX too
    assert jax_export.main(["gaussian-splat", "--load-config", str(tmp_path / "jax" / "config.yml"),
                            "--output-dir", str(tmp_path / "jax_out")]) == 0
    got, want = (tmp_path / "port" / "splat.ply").read_bytes(), (tmp_path / "jax_out" / "splat.ply").read_bytes()
    assert got == want
    assert f"element vertex {NUM}".encode() in got
