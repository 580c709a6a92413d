"""semantic-nerfw against the JAX package, on the CPU.

- The hash field's semantic head (a 2 x 64 MLP over the geo features,
  detached unless `pass_semantic_gradients`) with the JAX params carried
  across: the per-sample logits against eager JAX within 1e-5 (F32 of
  tests/test_torch_modules.py; measured 3e-8), which parameters its
  gradient reaches (the base network only with pass_semantic_gradients),
  and each reached parameter's gradient against jitted JAX (the VJP of
  the logits' squares) within rel L2 3e-4: XLA's fused program rounds the
  hash field's exp and products its own way (its logits read 2.6e-5 from
  eager JAX's) and the gradients measured <= 1.04e-4.
- One f32 training step on a Sitcoms3D-format scene with semantic label
  images (labels 0-2 for 2 classes: a label outside the classes adds 0 to
  the cross-entropy in both packages), from the JAX model's params, batch
  and jitter: every loss and metric (semantics_loss among them) rel 1e-4,
  every group's gradient rel L2 1e-3 and both Adam moments
  (tests/test_torch_train.py's tolerances and reasons).
- `semantics_colormap`: the metadata's colours, or default_rng(0)'s
  uniform ones without them, exactly; the rendered colormap of each ray is
  its argmax's colour.
- ns-train -> ns-eval -> ns-render on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.configs.dataparser_configs import build_dataparser as jax_build_dataparser
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.data.dataparsers.scene_parsers import Sitcoms3DDataParserConfig as JaxSitcomsConfig
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSampler as JaxSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSamplerConfig as JaxSamplerConfig
from nerfstudio_thermal_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step
from nerfstudio_thermal_tpu.fields import nerfacto_field as jnf
from nerfstudio_thermal_tpu.models.semantic_nerfw import SemanticNerfWModel as JaxSemanticModel

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config
from nerfstudio_thermal_torch.data.dataparsers.scene_parsers import Sitcoms3DDataParserConfig
from nerfstudio_thermal_torch.fields import nerfacto_field as tnf
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.models.semantic_nerfw import SemanticNerfWModel, semantic_colors
from nerfstudio_thermal_torch.scripts import eval as ns_eval
from nerfstudio_thermal_torch.scripts import render as ns_render
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils import jax_params
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_hash_slice import tiny_hash
from tests.test_torch_modules import _ray_samples
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, adam_state, flat, port_moments, rel_l2

torch.set_num_threads(1)

F32 = 1e-5
HEAD_GRAD = 3e-4
NUM_RAYS = 64
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def sitcoms_scene(root, frames=4):
    """A Sitcoms3D-format scene: 20 x 15 frames (full-resolution
    intrinsics 80 x 60, downscale 4) on a line looking along +z, label
    images of 0, 1 and 2 under segmentations_4/thing/ and two classes."""
    rng = np.random.default_rng(0)
    entries = []
    for i in range(frames):
        (root / "images_4").mkdir(parents=True, exist_ok=True)
        (root / "segmentations_4" / "thing").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (15, 20, 3), np.uint8)).save(root / "images_4" / f"im{i}.png")
        labels = (rng.integers(0, 8, (15, 20)) % 3).astype(np.uint8)
        Image.fromarray(labels).save(root / "segmentations_4" / "thing" / f"im{i}.png")
        c2w = np.eye(4)
        c2w[0, 3], c2w[2, 3] = i * 0.3, 1.5
        entries.append({"image_name": f"im{i}.png", "intrinsics": [[80.0, 0, 40.0], [0, 80.0, 30.0], [0, 0, 1]],
                        "camtoworld": c2w.tolist()})
    (root / "cameras.json").write_text(json.dumps({"frames": entries, "bbox": [[-2, -1, -1], [2, 1, 1]]}))
    (root / "panoptic_classes.json").write_text(json.dumps(
        {"thing": ["person", "sofa"], "thing_colors": [[255, 0, 0], [0, 255, 0]]}))
    return root


def method(get, parser_cls, scene):
    m = get("semantic-nerfw")
    tiny_hash(m.model, "float32")
    m.dataparser = parser_cls(data=scene)
    m.datamanager.train_num_rays_per_batch = NUM_RAYS
    m.datamanager.use_native_sampler = False
    m.data = scene
    return m


# ---- the semantic head ----------------------------------------------------------


@pytest.mark.parametrize("pass_gradients", [False, True])
def test_semantic_head_matches_jax(pass_gradients):
    kw = dict(num_images=3, num_levels=4, log2_hashmap_size=8, hidden_dim=16, hidden_dim_color=16,
              appearance_embedding_dim=4, num_semantic_classes=5, pass_semantic_gradients=pass_gradients)
    jfield = jnf.NerfactoField(aabb=tuple(map(tuple, AABB.tolist())), **kw)
    js, ts = _ray_samples(3)
    params = jax.jit(lambda k, s: jfield.init(k, s, train=True))(jax.random.PRNGKey(1), js)["params"]
    params = jax.tree.map(np.asarray, params)
    params["mlp_base"]["encoding"]["hash_table"] = params["mlp_base"]["encoding"]["hash_table"] * 300.0
    tfield = tnf.NerfactoField(AABB, **kw)
    jax_params.load_module(tfield, params, "fields")

    def semantics(p, s):
        return jfield.apply({"params": p}, s, train=True)[jnf.FieldHeadNames.SEMANTICS]

    want_sem = semantics(params, js)  # eager: XLA's fused program rounds its own way (below)
    _, vjp = jax.vjp(jax.jit(semantics), params, js)
    want = jax.tree.map(np.asarray, vjp(2.0 * want_sem)[0])
    sem = tfield(ts, train=True)[FieldHeadNames.SEMANTICS]
    assert sem.shape == (12, 5, 5) and sem.dtype == torch.float32
    np.testing.assert_allclose(sem.detach().numpy(), np.asarray(want_sem), rtol=F32, atol=F32)
    torch.sum(sem**2).backward()
    got = flat(jax_params.export_module(tfield, grads=True))
    want = flat(want)
    reached = {k for k, v in want.items() if np.abs(v).max() > 0}
    assert {k for k, v in got.items() if np.abs(v).max() > 0} == reached
    assert any(k.startswith("mlp_base") for k in reached) == pass_gradients
    for k in reached:
        assert rel_l2(got[k], want[k]) <= HEAD_GRAD, (k, rel_l2(got[k], want[k]))


# ---- the colormap ----------------------------------------------------------------


def test_semantics_colormap_matches_jax():
    """The metadata's colours, else default_rng(0)'s, as JAX builds them;
    each ray's colour is that of the argmax of its logits."""
    colors = np.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], np.float32)
    for metadata in ({"semantics": {"classes": ["a", "b", "c"], "colors": colors}}, {},
                     {"semantics": {"classes": ["a", "b", "c", "d"]}}):
        m = get_method_config("semantic-nerfw").model
        tiny_hash(m, "float32")
        model = SemanticNerfWModel(m, AABB, 2, metadata, device="cpu")
        jmodel = JaxSemanticModel(jax_method_config("semantic-nerfw").model, AABB, 2, metadata)
        np.testing.assert_array_equal(model.semantic_colormap.numpy(), jmodel.semantic_colormap)
        np.testing.assert_array_equal(semantic_colors(metadata), jmodel.semantic_colormap)
        assert model.num_semantic_classes == jmodel.num_semantic_classes == max(len(
            metadata.get("semantics", {}).get("classes", [])), 1)
    logits = torch.tensor([[0.1, 2.0, -1.0, 0.0], [3.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 5.0]])
    outputs = {}
    model._add_field_outputs(outputs, {FieldHeadNames.SEMANTICS: logits[:, None, :]}, torch.ones(3, 1, 1))
    np.testing.assert_array_equal(outputs["semantics_colormap"].numpy(), jmodel.semantic_colormap[[1, 0, 3]])


# ---- one training step -------------------------------------------------------------


@pytest.fixture(scope="module")
def sitcoms(tmp_path_factory):
    return sitcoms_scene(tmp_path_factory.mktemp("sitcoms"))


def test_train_step_matches_jax(sitcoms, tmp_path):
    jm = method(jax_method_config, JaxSitcomsConfig, sitcoms)
    parsed = jax_build_dataparser(jm.dataparser).get_dataparser_outputs("train")
    dataset = JaxDataset(parsed)
    cameras = jax.tree.map(jnp.asarray, parsed.cameras)
    metadata = dict(parsed.metadata)
    metadata["is_thermal"] = list(dataset.is_thermal)
    jmodel = JaxSemanticModel(jm.model, parsed.scene_box, len(dataset), metadata)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    params["fields"]["mlp_base"]["encoding"]["hash_table"] = params["fields"]["mlp_base"]["encoding"]["hash_table"] * 300
    tx = jax_build_optimizer(jm.optimizers, params)
    core = jax_make_ray_train_step(jmodel, tx)
    state = JaxTrainState(
        params=params, opt_state=tx.init(params), step=jnp.asarray(0, jnp.int32),
        steps_since_update=jnp.asarray(0, jnp.int32), steps_since_update_thermal=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(42), extra=None,
    )
    batch = JaxSampler(JaxSamplerConfig(NUM_RAYS, 1), dataset, seed=0).sample(step=0)
    assert batch["semantics"].dtype == np.int32 and set(np.unique(batch["semantics"])) == {0, 1, 2}
    new_state, want = jax.jit(lambda st, b: core(st, b, cameras))(state, batch)
    assert "semantics_loss" in want

    trainer = setup_trainer(method(get_method_config, Sitcoms3DDataParserConfig, sitcoms), base_dir=tmp_path,
                            device="cpu")
    load_jax_params(trainer.model, params)
    trainer.setup()
    port_batch = trainer.datamanager.next_train(0)
    for k, v in batch.items():
        np.testing.assert_array_equal(port_batch[k], v, err_msg=k)
    _, key_model, _, _ = jax.random.split(state.rng, 4)
    keys = jax.random.split(key_model, len(jm.model.num_proposal_samples_per_ray) + 1)
    uniforms = {"rgb": [t(jax.random.uniform(k, (NUM_RAYS, 1))) for k in keys]}
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()}, uniforms=uniforms)
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= LOSS_TOL["float32"] * max(abs(float(w)), 1e-3), (k, float(got[k]),
                                                                                                 float(w))
    grads = flat(export_jax_tree(trainer.model, grads=True))
    assert {k.split("/")[0] for k in grads} == set(params)
    for group in params:
        _, mu, nu = adam_state(new_state.opt_state, group)
        jax_grads = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        got_g = np.concatenate([grads[k].ravel() for k in sorted(jax_grads)])
        want_g = np.concatenate([jax_grads[k].ravel() for k in sorted(jax_grads)])
        assert rel_l2(got_g, want_g) <= GRAD_TOL["float32"], (group, rel_l2(got_g, want_g))
        for which, moment in (("mu", mu), ("nu", nu)):
            got_m, want_m = flat(port_moments(trainer, which)), flat({group: jax.tree.map(np.asarray, moment)})
            a = np.concatenate([got_m[k].ravel() for k in sorted(want_m)])
            b = np.concatenate([want_m[k].ravel() for k in sorted(want_m)])
            assert rel_l2(a, b) <= 2 * GRAD_TOL["float32"], (group, which)
    assert np.abs(grads["fields/mlp_semantics/Dense_0/kernel"]).max() > 0


# ---- the entry points ---------------------------------------------------------------


def test_scripts_round_trip(tmp_path):
    """ns-train on a Nerfstudio scene (no semantic labels: one class, the
    fallback colours), ns-eval, and ns-render of rgb and
    semantics_colormap."""
    scene = make_synthetic_rgbt_dataset(tmp_path / "scene", num_pairs=4, rgb_hw=(32, 40), t_hw=(32, 36))
    out = tmp_path / "out"
    argv = ["semantic-nerfw", "--data", str(scene), "--output-dir", str(out), "--experiment-name", "t",
            "--max-num-iterations", "4", "--steps-per-eval-batch", "2", "--steps-per-eval-image", "2",
            "--steps-per-eval-all-images", "4", "--pipeline.model.compute-dtype", "float32",
            "--pipeline.model.num-levels", "3", "--pipeline.model.log2-hashmap-size", "9",
            "--pipeline.model.num-proposal-samples-per-ray", "8,6", "--pipeline.model.num-nerf-samples-per-ray", "4",
            "--pipeline.model.eval-num-rays-per-chunk", "512", "--pipeline.datamanager.train-num-rays-per-batch", "64",
            "--pipeline.datamanager.eval-num-rays-per-batch", "64",
            "--pipeline.datamanager.dataparser.train-split-fraction", "0.5"]
    assert ns_train.main(argv, device="cpu") == 0
    (run,) = (out / "t" / "semantic-nerfw").glob("*")
    assert type(load_config(run / "config.yml").model).__name__ == "SemanticNerfWModelConfig"
    result = tmp_path / "eval.json"
    assert ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(result)], device="cpu") == 0
    assert np.isfinite(json.loads(result.read_text())["results"]["psnr_rgb"])
    frames = tmp_path / "frames"
    assert ns_render.main(["dataset", "--load-config", str(run / "config.yml"), "--output-path", str(frames),
                           "--rendered-output-names", "rgb", "semantics_colormap"], device="cpu") == 0
    assert len(list(frames.rglob("*.png"))) >= 2
