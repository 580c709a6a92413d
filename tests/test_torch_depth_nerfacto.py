"""depth-nerfacto, its depth losses and the depth / pair samplers against the
JAX package, on the CPU.

Tolerances, and why:
- The depth losses and depth_ranking_loss on the same inputs: the same f32
  formulas (exp, log, sums over a few samples), rel 1e-6 with an absolute
  floor of 1e-7, their gradients likewise (1e-5: sums of products).
- The samplers: the same numpy generator and the same gathers, so the
  batches are equal exactly.
- One f32 training step of a tiny depth-nerfacto (tests/test_torch_hash_slice.py's
  `tiny_hash` widths) from the JAX model's params, batch and jitter:
  tests/test_torch_train.py's LOSS_TOL and GRAD_TOL (rel 1e-4 on every
  loss and metric, rel L2 1e-3 on every group's gradient).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.cameras import rays as jrays
from nerfstudio_thermal_tpu.configs.dataparser_configs import build_dataparser as jax_build_dataparser
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.pixel_samplers import PairPixelSampler as JaxPairSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSampler as JaxSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSamplerConfig as JaxSamplerConfig
from nerfstudio_thermal_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step
from nerfstudio_thermal_tpu.model_components import losses as jlosses
from nerfstudio_thermal_tpu.models.depth_nerfacto import DepthNerfactoModel as JaxDepthNerfactoModel

from nerfstudio_thermal_torch.cameras import rays as trays
from nerfstudio_thermal_torch.configs.dataparser_configs import build_dataparser
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.data.datasets import InputDataset
from nerfstudio_thermal_torch.data.pixel_samplers import PairPixelSampler, PixelSampler, PixelSamplerConfig
from nerfstudio_thermal_torch.model_components import losses
from nerfstudio_thermal_torch.models.depth_nerfacto import DepthNerfactoModel
from nerfstudio_thermal_torch.scripts import eval as ns_eval
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import look_at
from tests.test_torch_hash_slice import tiny_hash
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, adam_state, flat, rel_l2

torch.set_num_threads(1)

LOSS_FN_TOL = 1e-6
LOSS_GRAD_TOL = 1e-5
NUM_RAYS = 32


def write_depth_scene(root: Path, n=4, hw=(32, 40)) -> Path:
    """A Nerfstudio-layout scene with a 16-bit depth PNG (millimetres) per
    frame, a third of the pixels without depth (0); 32 x 40 frames (LPIPS
    needs >= 32 px a side)."""
    (root / "images").mkdir(parents=True)
    (root / "depths").mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(n):
        angle = 2 * np.pi * i / n
        c2w = look_at(2.0 * np.array([np.cos(angle), np.sin(angle), 0.3]))
        Image.fromarray((rng.uniform(size=(*hw, 3)) * 255).astype(np.uint8)).save(root / "images" / f"f_{i}.png")
        depth_mm = rng.uniform(1000, 3000, size=hw).astype(np.uint16)
        depth_mm[rng.uniform(size=hw) < 0.3] = 0
        Image.fromarray(depth_mm, mode="I;16").save(root / "depths" / f"f_{i}.png")
        frames.append({"file_path": f"images/f_{i}.png", "depth_file_path": f"depths/f_{i}.png",
                       "transform_matrix": c2w.tolist(), "fl_x": 28.0, "fl_y": 28.0, "cx": hw[1] / 2,
                       "cy": hw[0] / 2, "w": hw[1], "h": hw[0]})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    return root


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_depth_scene(tmp_path_factory.mktemp("depth") / "scene")


def t(a):
    return torch.as_tensor(np.array(a))


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---- the depth losses ------------------------------------------------------------


def _loss_inputs(seed=0, r=24, s=7):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0.5, 4.0, (r, s + 1)), -1).astype(np.float32)
    w = rng.dirichlet(np.ones(s), r).astype(np.float32)[..., None] * 0.9
    term = rng.uniform(0.5, 4.0, (r, 1)).astype(np.float32)
    term[:3] = 0.0  # rays without depth
    term[3] = edges[3, 2]  # on a sample edge
    pred = rng.uniform(0.5, 4.0, (r, 1)).astype(np.float32)
    norm = rng.uniform(0.8, 1.3, (r, 1)).astype(np.float32)
    vals = dict(origins=np.zeros((r, 3), np.float32), directions=np.ones((r, 3), np.float32),
                pixel_area=np.ones((r, 1), np.float32), camera_indices=np.zeros((r, 1), np.int32),
                spacing_starts=np.zeros((r, s, 1), np.float32), spacing_ends=np.ones((r, s, 1), np.float32),
                s_near=np.zeros((r, 1), np.float32), s_far=np.ones((r, 1), np.float32))
    js = jrays.RaySamples(starts=jnp.asarray(edges[:, :-1, None]), ends=jnp.asarray(edges[:, 1:, None]),
                          **{k: jnp.asarray(v) for k, v in vals.items()})
    ts = trays.RaySamples(starts=t(edges[:, :-1, None]), ends=t(edges[:, 1:, None]), **{k: t(v) for k, v in vals.items()})
    return js, ts, w, term, pred, norm


@pytest.mark.parametrize("kind", ["ds_nerf", "urf"])
@pytest.mark.parametrize("euclidean", [False, True])
@pytest.mark.parametrize("sigma", [0.01, 0.2])
def test_depth_loss_matches_jax(kind, euclidean, sigma):
    """depth_loss (and through it ds_nerf_depth_loss and
    urban_radiance_field_depth_loss): value and gradients with respect to
    the weights and the predicted depth."""
    js, ts, w, term, pred, norm = _loss_inputs()

    def jfn(w_, p_):
        return jlosses.depth_loss(w_, js, jnp.asarray(term), p_, jnp.asarray(sigma, jnp.float32), jnp.asarray(norm),
                                  euclidean, kind)

    want, (jgw, jgp) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(pred))
    tw, tp = t(w).requires_grad_(True), t(pred).requires_grad_(True)
    got = losses.depth_loss(tw, ts, t(term), tp, torch.tensor(sigma), t(norm), euclidean, kind)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_FN_TOL, atol=1e-7)
    np.testing.assert_allclose(np32(tw.grad), np.asarray(jgw), rtol=LOSS_GRAD_TOL, atol=1e-7)
    gp = np.zeros_like(pred) if tp.grad is None else np32(tp.grad)  # ds_nerf does not read it
    np.testing.assert_allclose(gp, np.asarray(jgp), rtol=LOSS_GRAD_TOL, atol=1e-7)
    with pytest.raises(NotImplementedError):
        losses.depth_loss(tw, ts, t(term), tp, torch.tensor(sigma), t(norm), euclidean, "sparse")


def test_ds_nerf_loss_divides_by_two_sigma():
    """The reference behaviour the port keeps: exp(-(s - d)^2 / (2 sigma)),
    not / (2 sigma^2)."""
    _, ts, w, term, _, _ = _loss_inputs(1)
    steps = np32((ts.starts + ts.ends) / 2)
    lengths = np32(ts.ends - ts.starts)
    sigma = 0.2
    per_ray = np.sum(-np.log(w + losses.EPS) * np.exp(-((steps - term[:, None]) ** 2) / (2 * sigma)) * lengths, axis=-2)
    want = np.mean(per_ray * (term > 0))
    got = losses.ds_nerf_depth_loss(t(w), t(term), t(steps), t(lengths), torch.tensor(sigma))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    per_ray_sq = np.sum(-np.log(w + losses.EPS) * np.exp(-((steps - term[:, None]) ** 2) / (2 * sigma**2)) * lengths,
                        axis=-2)
    assert abs(float(got) - np.mean(per_ray_sq * (term > 0))) > 1e-2 * want


@pytest.mark.parametrize("agree", [False, True])
def test_depth_ranking_loss_matches_jax(agree):
    """SparseNeRF's ranking loss over [anchor, neighbour] pairs; where every
    pair's rendered order agrees with the GT's, both give NaN."""
    rng = np.random.default_rng(3)
    gt = rng.uniform(1, 3, (40, 1)).astype(np.float32)
    rendered = (gt + (0.0 if agree else rng.normal(scale=0.3, size=(40, 1)))).astype(np.float32)
    if agree:
        rendered[1::2] = rendered[0::2] - np.abs(gt[0::2] - gt[1::2]) * np.sign(gt[0::2] - gt[1::2]) - 1e-3 * np.sign(
            gt[0::2] - gt[1::2])
    want = jlosses.depth_ranking_loss(jnp.asarray(rendered), jnp.asarray(gt))
    want_g = jax.grad(lambda r: jnp.nan_to_num(jlosses.depth_ranking_loss(r, jnp.asarray(gt))))(jnp.asarray(rendered))
    tr = t(rendered).requires_grad_(True)
    got = losses.depth_ranking_loss(tr, t(gt))
    if agree:
        assert np.isnan(float(want)) and np.isnan(float(got))
        return
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_FN_TOL)
    got.backward()
    np.testing.assert_allclose(np32(tr.grad), np.asarray(want_g), rtol=LOSS_GRAD_TOL, atol=1e-7)


# ---- the samplers ------------------------------------------------------------------


def _datasets(scene):
    jparsed = jax_build_dataparser(jax_method_config("depth-nerfacto").dataparser.__class__(data=scene))
    parsed = build_dataparser(get_method_config("depth-nerfacto").dataparser.__class__(data=scene))
    return (JaxDataset(jparsed.get_dataparser_outputs("train")), InputDataset(parsed.get_dataparser_outputs("train")))


@pytest.mark.parametrize("pair", [False, True], ids=["pixels", "pairs"])
def test_sampler_batches_match_jax(scene, pair):
    """The depth batches (and PairPixelSampler's [anchor, neighbour]
    layout) equal JAX's for the same seed and step."""
    jds, ds = _datasets(scene)
    jcls, cls = (JaxPairSampler, PairPixelSampler) if pair else (JaxSampler, PixelSampler)
    jsampler = jcls(JaxSamplerConfig(NUM_RAYS + 1, 1), jds, seed=3)
    sampler = cls(PixelSamplerConfig(NUM_RAYS + 1, 1), ds, seed=3)
    assert sampler.num_rays_per_batch == jsampler.num_rays_per_batch
    for step in (0, 7):
        want, got = jsampler.sample(step=step), sampler.sample(step=step)
        assert set(got) == set(want) == {"ray_indices", "image", "is_thermal", "depth_image"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["depth_image"].shape == (sampler.num_rays_per_batch, 1) and (got["depth_image"] == 0).any()
    if pair:
        yx = got["ray_indices"][:, 1:]
        assert np.all(np.abs(yx[0::2] - yx[1::2]) <= 2)
        assert np.all(got["ray_indices"][0::2, 0] == got["ray_indices"][1::2, 0])


def test_depth_data_skips_the_native_sampler(scene, tmp_path):
    method = get_method_config("depth-nerfacto")
    method.data = scene
    tiny_hash(method.model, "float32")
    trainer = setup_trainer(method, base_dir=tmp_path, device="cpu")
    assert method.datamanager.use_native_sampler and not trainer.datamanager.uses_native_sampler
    assert type(trainer.model) is DepthNerfactoModel
    batch = trainer.datamanager.next_train(0)
    assert batch["depth_image"].shape == (4096, 1)


# ---- the training step --------------------------------------------------------------


def _configs(name, scene, **model):
    out = []
    for get in (jax_method_config, get_method_config):
        m = get(name)
        tiny_hash(m.model, "float32")
        for k, v in model.items():
            setattr(m.model, k, v)
        m.datamanager.train_num_rays_per_batch = NUM_RAYS
        m.datamanager.use_native_sampler = False
        m.dataparser.data = scene
        m.data = scene
        out.append(m)
    return out


STEP_CASES = {
    "ds_nerf": dict(),
    "urf": dict(depth_loss_type="urf", depth_sigma=0.05),
    "decay": dict(should_decay_sigma=True, is_euclidean_depth=True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(scene, tmp_path, case):
    """One f32 step at step 1000 (the proposal nets' warm-up and the sigma
    decay both read a step): every loss (depth_loss included) and metric
    (depth_mae included), and all three groups' gradients. With
    should_decay_sigma, both packages read batch.get("step", 0), which no
    sampler fills: the sigma is starting_depth_sigma at any step."""
    jm, pm = _configs("depth-nerfacto", scene, **STEP_CASES[case])
    parsed = jax_build_dataparser(jm.dataparser).get_dataparser_outputs("train")
    dataset = JaxDataset(parsed)
    cameras = jax.tree.map(jnp.asarray, parsed.cameras)
    jmodel = JaxDepthNerfactoModel(jm.model, parsed.scene_box, len(dataset), {})
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    tx = jax_build_optimizer(jm.optimizers, params)
    core = jax_make_ray_train_step(jmodel, tx)
    step = 1000
    state = JaxTrainState(
        params=params, opt_state=tx.init(params), step=jnp.asarray(step, jnp.int32),
        steps_since_update=jnp.asarray(0, jnp.int32), steps_since_update_thermal=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(42), extra=None,
    )
    batch = JaxSampler(JaxSamplerConfig(NUM_RAYS, 1), dataset, seed=0).sample(step=4)
    new_state, want = jax.jit(lambda st, b: core(st, b, cameras))(state, batch)

    trainer = setup_trainer(pm, base_dir=tmp_path, device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, params))
    trainer.setup()
    trainer.state.step = step
    _, key_model, _, _ = jax.random.split(state.rng, 4)
    keys = jax.random.split(key_model, len(jm.model.num_proposal_samples_per_ray) + 1)
    uniforms = {"rgb": [torch.tensor(np.asarray(jax.random.uniform(k, (NUM_RAYS, 1)))) for k in keys]}
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()}, uniforms=uniforms)

    assert {"depth_loss", "depth_mae", "rgb_loss", "interlevel_loss"} <= set(want)
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(float(got[k])), k
        assert abs(float(got[k]) - w) <= LOSS_TOL["float32"] * max(abs(w), 1e-3), (k, float(got[k]), w)
    grads = flat(export_jax_tree(trainer.model, grads=True))
    for group in params:
        count, mu, _ = adam_state(new_state.opt_state, group)
        assert count == 1 == trainer.optimizers.groups[group].count
        jax_grads = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        got_g = np.concatenate([grads[k].ravel() for k in sorted(jax_grads)])
        want_g = np.concatenate([jax_grads[k].ravel() for k in sorted(jax_grads)])
        assert rel_l2(got_g, want_g) <= GRAD_TOL["float32"], (group, rel_l2(got_g, want_g))
    if case == "decay":
        cfg = pm.model
        assert float(trainer.model._sigma(0)) == float(jmodel._sigma(0)) == np.float32(cfg.starting_depth_sigma)
        assert float(trainer.model._sigma(step)) == pytest.approx(float(jmodel._sigma(step)), rel=1e-6)
        assert float(trainer.model._sigma(step)) < cfg.starting_depth_sigma


def test_depth_mae_and_directions_norm(scene, tmp_path):
    """depth_mae skips pixels without depth (0 when none has one); the
    outputs carry the bundle's directions_norm, ones without it."""
    _, pm = _configs("depth-nerfacto", scene)
    trainer = setup_trainer(pm, base_dir=tmp_path, device="cpu")
    model = trainer.model
    outputs = {"expected_depth": t([[1.0], [2.0], [3.0]]), "rgb": torch.zeros(3, 3)}
    batch = {"image": torch.zeros(3, 3), "depth_image": t([[1.5], [0.0], [2.0]])}
    assert float(model.get_metrics_dict(outputs, batch, train=False)["depth_mae"]) == pytest.approx(0.75)
    empty = model.get_metrics_dict(outputs, {**batch, "depth_image": torch.zeros(3, 1)}, train=False)
    assert float(empty["depth_mae"]) == 0.0
    cams = trainer.datamanager.train_cameras
    bundle = cams.generate_rays(torch.zeros(8, dtype=torch.long), torch.rand(8, 2) * 10)
    with torch.no_grad():
        out = model(bundle, train=False)
        torch.testing.assert_close(out["directions_norm"], bundle.metadata["directions_norm"])
        bare = model(bundle.replace(metadata={}), train=False)
    assert torch.equal(bare["directions_norm"], torch.ones(8, 1))


def test_ns_train_and_eval_depth_nerfacto(scene, tmp_path):
    """ns-train on the depth scene (the eval batches carry depth_image:
    eval_depth_mae), then ns-eval of the run."""
    flags = ["--model.num-levels", "3", "--model.base-res", "4", "--model.max-res", "32",
             "--model.log2-hashmap-size", "9", "--model.hidden-dim", "16", "--model.hidden-dim-color", "16",
             "--model.appearance-embed-dim", "4", "--model.num-proposal-samples-per-ray", "8,6",
             "--model.num-nerf-samples-per-ray", "4", "--model.compute-dtype", "float32",
             "--pipeline.model.eval-num-rays-per-chunk", "256", "--datamanager.train-num-rays-per-batch", "32",
             "--pipeline.datamanager.eval-num-rays-per-batch", "32",
             "--pipeline.datamanager.dataparser.train-split-fraction", "0.75"]
    argv = ["depth-nerfacto", "--data", str(scene), "--output-dir", str(tmp_path / "out"), "--experiment-name", "t",
            "--max-num-iterations", "4", "--steps-per-eval-batch", "2", "--steps-per-eval-image", "2",
            "--steps-per-eval-all-images", "4", *flags]
    assert ns_train.main(argv, device="cpu") == 0
    (run,) = (tmp_path / "out").glob("t/depth-nerfacto/*")
    events = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
    train = [e for e in events if "train/depth_loss" in e]
    assert train and all(np.isfinite(e["train/depth_loss"]) and np.isfinite(e["train/depth_mae"]) for e in train)
    assert any(np.isfinite(e.get("eval/eval_depth_mae", np.nan)) for e in events)
    out = tmp_path / "eval.json"
    assert ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(out)], device="cpu") == 0
    assert np.isfinite(json.loads(out.read_text())["results"]["psnr_rgb"])


def test_write_png_16_bit_depth_round_trips(tmp_path):
    """The port's PNG writer's 16-bit grey output (the smoke's depth maps)
    reads back through the port's reader and Pillow unchanged."""
    from nerfstudio_thermal_torch.data.datasets import read_image_array
    from nerfstudio_thermal_torch.utils.writer import write_png

    depth = np.random.default_rng(0).integers(0, 65536, (9, 13, 1)).astype(np.uint16)
    write_png(tmp_path / "d.png", depth)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "d.png")), depth[..., 0])
    np.testing.assert_array_equal(read_image_array(tmp_path / "d.png").reshape(9, 13), depth[..., 0])
    with pytest.raises(ValueError):
        write_png(tmp_path / "rgb16.png", np.zeros((2, 2, 3), np.uint16))
