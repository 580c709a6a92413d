"""The port's training step against the JAX package's, on the CPU.

A tiny thermal-nerfacto-tpu (`tiny()` of test_torch_render: a 4 x 128 base
MLP, so both packages still take the fused-MLP path) on
tests/fixtures.make_synthetic_rgbt_dataset, 64 rays in 2x2 patches. Both
packages parse the same scene and sample the same batch; the port's model
gets the JAX model's parameters through `load_jax_params`, and its
sampling jitter is JAX's own draws, rebuilt from the step's key splits
(trainer -> thermal model -> proposal sampler) and passed in. Gradients
are compared in the JAX layout through `export_jax_tree`; JAX's are read
from its Adam state after one step from zero moments (mu = 0.1 g).

Tolerances:
- f32 compute: losses and metrics rel 1e-4; each group's gradient rel L2
  1e-3; Adam moments and parameters after two steps rel L2 1e-3. The two
  sides do the same f32 arithmetic in other orders (prefix sums, matmuls,
  reductions), and a near-zero gradient entry can carry a larger relative
  error than the sums it comes from.
- bf16 compute: losses rel 2e-2, gradients rel L2 5e-2: the MLPs round
  every layer to bf16, and the two frameworks can round one value to
  neighbouring bf16 numbers.
- Step counts, the anneal and update schedules and batches are exact; a
  learning rate is the same f32 formula, to one ulp (the exp and log of
  XLA and of PyTorch may differ in the last bit).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.data.datasets import load_image as jax_load_image
from nerfstudio_thermal_tpu.data.dataparsers.nerfstudio_dataparser import ThermalNerf as JaxParser
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSampler as JaxSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSamplerConfig as JaxSamplerConfig
from nerfstudio_thermal_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step
from nerfstudio_thermal_tpu.model_components import ray_samplers as jax_samplers
from nerfstudio_thermal_tpu.models import nerfacto as jax_nerfacto
from nerfstudio_thermal_tpu.models.nerfacto import NerfactoModel as JaxNerfactoModel
from nerfstudio_thermal_tpu.models.thermal_nerfacto import ThermalNerfactoModel as JaxModel

from nerfstudio_thermal_torch.cameras.camera_optimizers import CameraOptimizerConfig
from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.cameras.rays import RayBundle, RaySamples
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.data.datasets import decode_png, load_image
from nerfstudio_thermal_torch.engine.optimizers import Adam, build_optimizer
from nerfstudio_thermal_torch.engine.trainer import TrainState, make_ray_train_step
from nerfstudio_thermal_torch.model_components import ray_samplers
from nerfstudio_thermal_torch.models import nerfacto
from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_render import tiny

torch.set_num_threads(1)

NUM_RAYS = 64
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
LR_ULP = 2.0**-23  # one f32 ulp: exp/log of two math libraries


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4)


def _method(get, dtype, scene, name="thermal-nerfacto-tpu", cut=tiny):
    method = get(name)
    cut(method.model, dtype)
    method.datamanager.train_num_rays_per_batch = NUM_RAYS
    method.dataparser.data = scene
    method.data = scene
    return method


class JaxSide:
    """The JAX model, optimizer and jitted train step of one dtype."""

    def __init__(self, scene, dtype, name="thermal-nerfacto-tpu", cut=tiny):
        self.method = _method(jax_method_config, dtype, scene, name, cut)
        parsed = JaxParser(self.method.dataparser).get_dataparser_outputs("train")
        self.dataset = JaxDataset(parsed)
        self.cameras = jax.tree.map(jnp.asarray, parsed.cameras)
        self.model = JaxModel(
            self.method.model, parsed.scene_box, len(self.dataset),
            {"is_thermal": list(self.dataset.is_thermal)},
        )
        self.params = jax.jit(self.model.init_params)(jax.random.PRNGKey(0))
        self.tx = jax_build_optimizer(self.method.optimizers, self.params)
        core = jax_make_ray_train_step(self.model, self.tx)
        self.step_fn = jax.jit(lambda state, batch: core(state, batch, self.cameras))

    def state(self, step=0, ssu=0):
        return JaxTrainState(
            params=self.params, opt_state=self.tx.init(self.params),
            step=jnp.asarray(step, jnp.int32), steps_since_update=jnp.asarray(ssu, jnp.int32),
            steps_since_update_thermal=jnp.asarray(0, jnp.int32),
            rng=jax.random.PRNGKey(42), extra=None,
        )

    def batch(self, step):
        sampler = JaxSampler(JaxSamplerConfig(NUM_RAYS, 2), self.dataset, seed=0)
        return sampler.sample(step=step)

    def uniforms(self, rng):
        """The jitter draws of the step that starts from key `rng`."""
        _, key_model, _, _ = jax.random.split(rng, 4)
        levels = len(self.method.model.num_proposal_samples_per_ray) + 1
        out = {}
        for name, key in zip(("rgb", "thermal"), jax.random.split(key_model)):
            keys = jax.random.split(key, levels)
            out[name] = [torch.tensor(np.asarray(jax.random.uniform(k, (NUM_RAYS, 1)))) for k in keys]
        return out


_JAX_SIDES = {}


def jax_side(scene, dtype) -> JaxSide:
    if dtype not in _JAX_SIDES:
        _JAX_SIDES[dtype] = JaxSide(scene, dtype)
    return _JAX_SIDES[dtype]


def adam_state(opt_state, name):
    """(count, mu, nu) of one group in the optax multi-transform state."""
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)  # noqa: E731
    adam = [s for s in jax.tree_util.tree_leaves(opt_state.inner_states[name], is_leaf=is_adam) if is_adam(s)][0]
    return int(adam.count), adam.mu[name], adam.nu[name]


def port_trainer(scene, dtype, tmp_path, jax_params=None, name="thermal-nerfacto-tpu", cut=tiny):
    method = _method(get_method_config, dtype, scene, name, cut)
    trainer = setup_trainer(method, base_dir=tmp_path, device="cpu")
    if jax_params is not None:
        load_jax_params(trainer.model, jax.tree.map(np.asarray, jax_params))
    trainer.setup()
    return trainer


def port_moments(trainer, which):
    """A group's Adam moments in the JAX layout (via the .grad slots)."""
    saved = {id(p): p.grad for p in trainer.model.parameters()}
    for opt in trainer.optimizers.groups.values():
        for p, m in zip(opt.params, getattr(opt, which)):
            p.grad = m.clone()
    tree = export_jax_tree(trainer.model, grads=True)
    for p in trainer.model.parameters():
        p.grad = saved[id(p)]
    return tree


def test_pixel_sampler_batches_match_jax(scene, tmp_path):
    """Same scene, same (seed, step): identical batches, and the two
    dataparsers give the same cameras."""
    js = jax_side(scene, "float32")
    trainer = port_trainer(scene, "float32", tmp_path)
    for step in (0, 1, 7):
        want, got = js.batch(step), trainer.datamanager.next_train(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "distortion_params"):
        np.testing.assert_allclose(
            getattr(trainer.cameras, name).numpy(), np.asarray(getattr(js.cameras, name)), rtol=1e-6, err_msg=name
        )


@pytest.mark.parametrize("step", [0, 9, 10, 11, 1000, 5000])
def test_schedules_and_proposal_updates_match_jax(step):
    """Anneal, update schedule and proposal_updated agree exactly with the
    JAX package's f32 values, both learning-rate schedules to one ulp."""
    assert nerfacto.proposal_anneal(step, 1000, 10.0) == float(jax_nerfacto.proposal_anneal(jnp.int32(step), 1000, 10.0))
    assert nerfacto.proposal_update_schedule(step, 5000, 5) == float(
        jax_nerfacto.proposal_update_schedule(jnp.int32(step), 5000, 5)
    )
    for ssu in (0, 1, 2, 5, 6):
        upd, nxt = jax_nerfacto.proposal_updated(jnp.int32(step), jnp.int32(ssu), 5000, 5)
        assert nerfacto.proposal_updated(step, ssu, 5000, 5) == (bool(upd), int(nxt))
    jax_groups = jax_method_config("thermal-nerfacto-tpu").optimizers
    for name, gc in get_method_config("thermal-nerfacto-tpu").optimizers.items():
        jgc = jax_groups[name]
        assert (gc.optimizer.lr, gc.optimizer.eps) == (jgc.optimizer.lr, jgc.optimizer.eps)
        got = gc.scheduler.make(gc.optimizer.lr)(step)
        want = float(jgc.scheduler.make(jgc.optimizer.lr)(step))
        assert abs(got - want) <= LR_ULP * want, (name, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(scene, tmp_path, dtype):
    """One step from the same params, batch and jitter: every loss term and
    metric, and every group's gradient, in the JAX layout."""
    js = jax_side(scene, dtype)
    state = js.state()
    batch = js.batch(0)
    new_state, want = js.step_fn(state, batch)

    trainer = port_trainer(scene, dtype, tmp_path, js.params)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = trainer._train_step(trainer.state, tbatch, uniforms=js.uniforms(state.rng))

    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(float(got[k])), k
        assert abs(float(got[k]) - w) <= LOSS_TOL[dtype] * max(abs(w), 1e-3), (k, float(got[k]), w)

    grads = flat(export_jax_tree(trainer.model, grads=True))
    assert {k.split("/")[0] for k in grads} == set(js.params)
    for group in js.params:
        count, mu, _ = adam_state(new_state.opt_state, group)
        assert count == 1 == trainer.optimizers.groups[group].count
        jax_grads = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        got_g = np.concatenate([grads[k].ravel() for k in sorted(jax_grads)])
        want_g = np.concatenate([jax_grads[k].ravel() for k in sorted(jax_grads)])
        assert np.isfinite(got_g).all(), group
        assert rel_l2(got_g, want_g) <= GRAD_TOL[dtype], (group, rel_l2(got_g, want_g))
    # frozen camera rows get zero gradients, not none
    is_thermal = np.asarray(js.dataset.is_thermal) > 0
    assert not grads["camera_opt/pose_adjustment"][is_thermal].any()
    assert not grads["camera_opt_thermal/pose_adjustment"][~is_thermal].any()
    assert (trainer.state.step, int(new_state.step)) == (1, 1)
    assert trainer.state.steps_since_update == int(new_state.steps_since_update)


def test_two_steps_with_a_skipped_proposal_update_match_jax(scene, tmp_path):
    """Step 100 updates the proposal nets, step 101 does not (their
    gradients are zero there). optax still decays their moments and moves
    them with the momentum, and counts the step; the port must too (where
    torch.optim.Adam would skip a parameter without .grad). Adam moments,
    counts and parameters after both steps match."""
    js = jax_side(scene, "float32")
    state = js.state(step=100, ssu=2)
    trainer = port_trainer(scene, "float32", tmp_path, js.params)
    trainer.state.step, trainer.state.steps_since_update = 100, 2
    flags = []
    for i in range(2):
        batch = js.batch(100 + i)
        flags.append(nerfacto.proposal_updated(trainer.state.step, trainer.state.steps_since_update, 5000, 5)[0])
        uniforms = js.uniforms(state.rng)
        state, _ = js.step_fn(state, batch)
        trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()}, uniforms=uniforms)
    assert flags == [True, False]
    assert trainer.model.proposal_networks[0].mlp.layers[0].weight.grad is None  # no gradient at step 101
    mu_port, nu_port = flat(port_moments(trainer, "mu")), flat(port_moments(trainer, "nu"))
    params_port = flat(export_jax_tree(trainer.model))
    for group in js.params:
        count, mu, nu = adam_state(state.opt_state, group)
        assert count == 2 == trainer.optimizers.groups[group].count
        for which, want_tree, got in (("mu", mu, mu_port), ("nu", nu, nu_port), ("params", state.params[group], params_port)):
            want = flat({group: jax.tree.map(np.asarray, want_tree)})
            w = np.concatenate([want[k].ravel() for k in sorted(want)])
            g = np.concatenate([got[k].ravel() for k in sorted(want)])
            assert rel_l2(g, w) <= 1e-3, (group, which, rel_l2(g, w))


def test_adam_counts_a_parameter_without_gradient():
    """The optax semantics on one tensor: a step without .grad still decays
    the moments and applies the momentum."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = Adam([p], lambda step: 0.1, eps=1e-15)
    p.grad = torch.full((3,), 2.0)
    opt.step()
    after_first = p.detach().clone()
    p.grad = None
    opt.step()
    assert opt.count == 2
    np.testing.assert_allclose(opt.mu[0].numpy(), 0.9 * 0.2, rtol=1e-6)
    assert (p.detach() < after_first).all()  # momentum moved it


def test_checkpoint_round_trip(scene, tmp_path):
    """save_checkpoint / load restore params, Adam state, counters and the
    jitter generator exactly: the next step is the same."""
    trainer = port_trainer(scene, "float32", tmp_path / "a")
    for step in range(3):
        trainer.train_iteration(step)
    path = trainer.save_checkpoint(3)
    method = _method(get_method_config, "float32", scene)
    method.trainer.load_dir = path.parent
    other = setup_trainer(method, base_dir=tmp_path / "b", device="cpu")
    other.setup()
    assert other._start_step == 3
    assert (other.state.step, other.state.steps_since_update) == (trainer.state.step, trainer.state.steps_since_update)
    assert torch.equal(other.state.generator.get_state(), trainer.state.generator.get_state())
    for (k, a), b in zip(trainer.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), k
    a, b = trainer.train_iteration(3), other.train_iteration(3)
    for k in a:
        assert float(a[k]) == float(b[k]), k


def test_training_loss_falls(scene, tmp_path):
    """50 CPU steps of the tiny model through Trainer.train: the loss of the
    last 10 steps is below that of the first 10, and train() saves at the
    end."""
    method = _method(get_method_config, "float32", scene)
    method.trainer.max_num_iterations = 50
    trainer = setup_trainer(method, base_dir=tmp_path, device="cpu")
    trainer.setup()
    losses = []
    step_fn = trainer._train_step
    trainer._train_step = lambda state, batch: losses.append(step_fn(state, batch)["loss"]) or {"loss": losses[-1]}
    trainer.train()
    assert len(losses) == 50 and all(np.isfinite(float(v)) for v in losses)
    assert np.mean([float(v) for v in losses[-10:]]) < np.mean([float(v) for v in losses[:10]])
    assert (tmp_path / "nerfstudio_models" / "step-000000050.ckpt").exists()


def test_take_below_above_ties_match_jax():
    """searchsorted(right=True) + gather selects what the JAX package's
    comparison count selects, at exact ties and in flat CDF stretches."""
    cdf = np.array([[0.0, 0.25, 0.25, 0.5, 0.75, 0.75, 1.0], [0.0, 0.0, 0.5, 0.5, 0.5, 1.0, 1.0]], np.float32)
    u = np.array([[0.0, 0.25, 0.5, 0.6, 0.75, 1.0], [0.0, 0.1, 0.5, 0.5, 0.99, 1.0]], np.float32)
    vals = np.cumsum(np.ones_like(cdf), -1).astype(np.float32)
    for side in ("right", "left"):
        want = jax_samplers.take_below_above(jnp.asarray(cdf), jnp.asarray(u), jnp.asarray(vals), side=side)
        got = ray_samplers.take_below_above(torch.as_tensor(cdf), torch.as_tensor(u), torch.as_tensor(vals), side=side)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pdf_sample_with_flat_cdf_matches_jax():
    """Inverse-CDF resampling where weights are exactly zero (flat CDF
    stretches, 0/0 interpolation) and the queries fall on CDF values."""
    from nerfstudio_thermal_tpu.cameras.rays import RayBundle as JaxBundle

    rng = np.random.default_rng(5)
    r, s = 6, 7
    w = rng.uniform(0, 1, (r, s, 1)).astype(np.float32)
    w[:, 1:3] = 0.0
    w[0] = 0.0
    starts = np.sort(rng.uniform(0, 1, (r, s + 1)), -1).astype(np.float32)
    starts[:, 0], starts[:, -1] = 0.0, 1.0
    common = dict(
        origins=np.zeros((r, 3), np.float32), directions=np.tile([[0.0, 0.0, 1.0]], (r, 1)).astype(np.float32),
        pixel_area=np.ones((r, 1), np.float32), camera_indices=np.zeros((r, 1), np.int32),
        nears=np.full((r, 1), 0.1, np.float32), fars=np.full((r, 1), 4.0, np.float32),
    )
    samples = dict(
        starts=starts[:, :-1, None], ends=starts[:, 1:, None],
        spacing_starts=starts[:, :-1, None], spacing_ends=starts[:, 1:, None],
        s_near=common["nears"], s_far=common["fars"],
    )
    jb = JaxBundle(**{k: jnp.asarray(v) for k, v in common.items()})
    js = jb.get_ray_samples(
        bin_starts=jnp.asarray(samples["starts"]), bin_ends=jnp.asarray(samples["ends"]),
        spacing_starts=jnp.asarray(samples["spacing_starts"]), spacing_ends=jnp.asarray(samples["spacing_ends"]),
        spacing_kind="uniform", s_near=jnp.asarray(samples["s_near"]), s_far=jnp.asarray(samples["s_far"]),
    )
    want = jax_samplers.pdf_sample(jb, js, jnp.asarray(w), 3, include_original=False, histogram_padding=0.0, train=False)
    tb = RayBundle(**{k: torch.as_tensor(v) for k, v in common.items()})
    ts = RaySamples(
        origins=tb.origins, directions=tb.directions, pixel_area=tb.pixel_area, camera_indices=tb.camera_indices,
        spacing_kind="uniform", **{k: torch.as_tensor(v) for k, v in samples.items()},
    )
    got = ray_samplers.pdf_sample(tb, ts, torch.as_tensor(w), 3, include_original=False, histogram_padding=0.0)
    np.testing.assert_allclose(got.spacing_starts.numpy(), np.asarray(want.spacing_starts), atol=1e-6)
    np.testing.assert_allclose(got.spacing_ends.numpy(), np.asarray(want.spacing_ends), atol=1e-6)


def test_load_image_matches_jax_without_pil(scene, tmp_path):
    """The port's zlib PNG decoder against the JAX package's PIL loader: the
    fixture's frames, and 8/16-bit grey, grey+alpha, RGB and RGBA files."""
    files = sorted(scene.glob("images*/*.png"))[:3]
    rng = np.random.default_rng(0)
    for name, arr in (
        ("grey8.png", rng.integers(0, 256, (9, 11), dtype=np.uint8)),
        ("grey16.png", rng.integers(0, 65536, (9, 11), dtype=np.uint16)),
        ("la.png", rng.integers(0, 256, (9, 11, 2), dtype=np.uint8)),
        ("rgb.png", rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)),
        ("rgba.png", rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)),
        ("smooth.png", (np.add.outer(np.arange(40), np.arange(30)) % 256).astype(np.uint8)),
    ):
        Image.fromarray(arr).save(tmp_path / name)
        files.append(tmp_path / name)
    for f in files:
        got, want = load_image(f), jax_load_image(f)
        assert got.dtype == np.float32 and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert decode_png(tmp_path / "grey16.png").dtype == np.uint16


def test_cameras_are_the_ports(scene, tmp_path):
    """setup_trainer hands the trainer the port's Cameras and one Adam per
    param group the model has."""
    trainer = port_trainer(scene, "float32", tmp_path)
    assert isinstance(trainer.cameras, Cameras)
    assert trainer.cameras.camera_to_worlds.dtype == torch.float32
    assert set(trainer.optimizers.groups) == set(trainer.model.param_groups())


def test_nerfacto_train_step_matches_jax(scene):
    """The single-modality nerfacto model's train branch (its losses,
    metrics and camera regularizer) through both packages'
    make_ray_train_step, f32, from the JAX nerfacto-tpu config cut like
    tiny(): every scalar and the three groups' gradients."""
    js = jax_side(scene, "float32")
    jmethod = jax_method_config("nerfacto-tpu")
    jcfg = tiny(jmethod.model, "float32")
    jmodel = JaxNerfactoModel(jcfg, np.asarray([[-1.0] * 3, [1.0] * 3], np.float32), len(js.dataset), {})
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))
    tx = jax_build_optimizer(jmethod.optimizers, params)
    core = jax_make_ray_train_step(jmodel, tx)
    state = JaxTrainState(
        params=params, opt_state=tx.init(params), step=jnp.asarray(0, jnp.int32),
        steps_since_update=jnp.asarray(0, jnp.int32), steps_since_update_thermal=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(7), extra=None,
    )
    batch = js.batch(3)
    new_state, want = jax.jit(lambda st, b: core(st, b, js.cameras))(state, batch)

    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(NerfactoModelConfig)}
    fields["camera_optimizer"] = CameraOptimizerConfig(**dataclasses.asdict(jcfg.camera_optimizer))
    model = NerfactoModel(NerfactoModelConfig(**fields), jmodel.scene_aabb, len(js.dataset), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    groups = get_method_config("thermal-nerfacto-tpu").optimizers
    optimizers = build_optimizer({k: groups[k] for k in params}, model.param_groups())
    cam_names = ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "distortion_params", "camera_type")
    cameras = Cameras(**{k: torch.tensor(np.asarray(getattr(js.cameras, k))) for k in cam_names})
    _, key_model, _, _ = jax.random.split(state.rng, 4)
    keys = jax.random.split(key_model, len(jcfg.num_proposal_samples_per_ray) + 1)
    uniforms = {"rgb": [torch.tensor(np.asarray(jax.random.uniform(k, (NUM_RAYS, 1)))) for k in keys]}
    got = make_ray_train_step(model, optimizers, cameras)(
        TrainState(generator=torch.Generator()), {k: torch.as_tensor(v) for k, v in batch.items()}, uniforms=uniforms
    )

    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= LOSS_TOL["float32"] * max(abs(float(w)), 1e-3), k
    grads = flat(export_jax_tree(model, grads=True))
    for group in params:
        _, mu, _ = adam_state(new_state.opt_state, group)
        jax_grads = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        got_g = np.concatenate([grads[k].ravel() for k in sorted(jax_grads)])
        want_g = np.concatenate([jax_grads[k].ravel() for k in sorted(jax_grads)])
        assert rel_l2(got_g, want_g) <= GRAD_TOL["float32"], (group, rel_l2(got_g, want_g))
