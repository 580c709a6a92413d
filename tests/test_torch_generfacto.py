"""generfacto against the JAX package, on the CPU.

A tiny configuration (a 16 x 16 render, a 4-level T 2^10 field grid and
two 4-level proposal grids, (8, 6) + 4 samples); the port's model gets
the JAX model's parameters through `load_jax_params`, and the five draws
of JAX's step (light, shade, background, choice and the sampler's
jitter, rebuilt from the split of its key) are passed to the port.

- The registration equals the JAX package's; `setup_trainer` builds the
  RandomCamerasDataManager and a GenerfactoModel without data.
- RandomCamerasDataManager: the batches of every step and the eval ring
  equal JAX's; `next_eval_image` raises in both.
- ColorMatchGuidance, `select_view_embedding` (every quadrant, overhead)
  and the Stable Diffusion shell give JAX's values and messages.
- `generative_forward` in training (shading and normals on) and at eval:
  every output within 1e-5 relative L2.
- One train step with the normals and lambertian terms on, against JAX's
  `_build_generative_train_step`: losses within 1e-5 relative, each
  group's gradient (JAX's first moment / 0.1) within 1e-4 relative L2.
  The step differentiates the position gradient again (the hash grid's
  `_HashEncodeBwdPos` backward).
- ns-train without --data, then ns-render of the eval ring from its
  checkpoint; ns-eval raises as in JAX (no ground truth); without CUDA
  ns-train raises instead of running on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.method_configs import method_configs as jax_method_configs
from nerfstudio_thermal_tpu.configs.method_configs import resolve_model_class as jax_resolve
from nerfstudio_thermal_tpu.configs.method_configs import setup_trainer as jax_setup_trainer
from nerfstudio_thermal_tpu.configs.serialization import to_dict as jax_to_dict
from nerfstudio_thermal_tpu.data.datamanagers import RandomCamerasDataManager as JaxRandomCameras
from nerfstudio_thermal_tpu.generative import guidance as jguidance

from nerfstudio_thermal_torch.configs.method_configs import _METHODS, descriptions, get_method_config, resolve_model_class
from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config, save_config, to_dict
from nerfstudio_thermal_torch.data.datamanagers import RandomCamerasDataManager
from nerfstudio_thermal_torch.generative import guidance
from nerfstudio_thermal_torch.models.generfacto import GenerfactoModel
from nerfstudio_thermal_torch.scripts import eval as ns_eval
from nerfstudio_thermal_torch.scripts import render as ns_render
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.test_torch_config_cli import _port_tags
from tests.test_torch_configs import _field_differences
from tests.test_torch_train import adam_state, flat, rel_l2

torch.set_num_threads(1)

RES = 16
OUT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TINY_PROPOSALS = [
    {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 4, "max_res": 32},
    {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 4, "max_res": 64},
]


def tiny_gen(method, shading: bool = True):
    m = method.model
    m.render_resolution = RES
    m.num_levels, m.log2_hashmap_size, m.max_res, m.hidden_dim = 4, 10, 64, 16
    m.proposal_net_args_list = [dict(a) for a in TINY_PROPOSALS]
    m.num_proposal_samples_per_ray, m.num_nerf_samples_per_ray = (8, 6), 4
    if shading:
        m.start_normals_training = m.start_lambertian_training = 0
    method.datamanager.resolution = RES
    return method


def jax_draws(key_model, model_cfg):
    """The five draws of JAX's generative_forward from its key."""
    k_light, k_shade, k_bg, k_sample, k_choice = jax.random.split(key_model, 5)
    levels = len(model_cfg.num_proposal_samples_per_ray) + 1
    keys = jax.random.split(k_sample, levels)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return {
        "light": t(jax.random.normal(k_light, (3,))),
        "shade": t(jax.random.uniform(k_shade, ())),
        "background": t(jax.random.uniform(k_bg, (3,))),
        "choice": t(jax.random.uniform(k_choice, ())),
        "uniforms": [t(jax.random.uniform(k, (RES * RES, 1))) for k in keys],
    }


def shaded_key(seed: int) -> jax.Array:
    """The first key from PRNGKey(seed) on whose step the shaded branch
    runs (shade > 0.75, choice > 0.5): the lambertian term then reaches
    the loss, and through it the normals' second derivative."""
    while True:
        key = jax.random.PRNGKey(seed)
        _, key_model, _ = jax.random.split(key, 3)
        _, k_shade, _, _, k_choice = jax.random.split(key_model, 5)
        if float(jax.random.uniform(k_shade, ())) > 0.75 and float(jax.random.uniform(k_choice, ())) > 0.5:
            return key
        seed += 1


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX trainer, the port's trainer with its parameters)."""
    root = tmp_path_factory.mktemp("gen")
    jt = jax_setup_trainer(tiny_gen(jax_method_config("generfacto")), base_dir=root / "jax")
    jt.model.init_params = jax.jit(jt.model.init_params)
    jt.setup()
    # one compiled program per mode for the tests' forwards and eval renders
    jt.model.generative_forward = jax.jit(jt.model.generative_forward, static_argnames=("train",))
    trainer = setup_trainer(tiny_gen(get_method_config("generfacto")), base_dir=root / "port", device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, jt.host_params()))
    trainer.setup()
    return jt, trainer


def test_config_equals_jax(tmp_path):
    port, want = get_method_config("generfacto"), jax_method_config("generfacto")
    assert _field_differences(type(port), type(want), "generfacto", port, want) == []
    assert to_dict(port) == _port_tags(jax_to_dict(want))
    assert descriptions["generfacto"] == want.description
    # as in JAX, the config resolves to NerfactoModel; setup_trainer builds the model itself
    assert resolve_model_class(port.model).__name__ == jax_resolve(want.model).__name__
    save_config(port, tmp_path / "config.yml")
    assert load_config(tmp_path / "config.yml") == port
    # with generfacto and splatfacto, the port registers every method of the JAX package
    assert set(_METHODS) == set(jax_method_configs)


def test_setup_builds_random_cameras_without_data(pair):
    jt, trainer = pair
    assert type(trainer.datamanager) is RandomCamerasDataManager and type(trainer.model) is GenerfactoModel
    assert set(trainer.model.param_groups()) == set(jt.host_params()) == {"fields", "field_background",
                                                                          "proposal_networks"}


def test_random_cameras_match_jax():
    cfg, jcfg = get_method_config("generfacto").datamanager, jax_method_config("generfacto").datamanager
    cfg.seed = jcfg.seed = 3
    dm, jdm = RandomCamerasDataManager(cfg), JaxRandomCameras(jcfg)
    for step in (0, 1, 7, 12345):
        got, want = dm.next_train(step), jdm.next_train(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "camera_type"):
        np.testing.assert_array_equal(getattr(dm.eval_cameras, name).numpy(), np.asarray(getattr(jdm.eval_cameras,
                                                                                                    name)), name)
    assert len(dm.eval_dataset) == len(jdm.eval_dataset) == 8 and dm.num_train_data() == 1
    assert dm.train_dataparser_outputs.as_dict() == jdm.train_dataparser_outputs.as_dict() == {}
    for m in (dm, jdm):
        with pytest.raises(NotImplementedError, match="no GT images"):
            m.next_eval_image(0)


def test_guidance_matches_jax(monkeypatch):
    emb, jemb = guidance.ColorMatchGuidance().embed_prompts(*"abcde"), jguidance.ColorMatchGuidance().embed_prompts(
        *"abcde")
    for k in jemb:
        np.testing.assert_array_equal(emb[k].numpy(), np.asarray(jemb[k]))
    image = np.random.default_rng(0).uniform(0, 1, (RES, RES, 3)).astype(np.float32)
    for vertical in (10.0, 40.0, 45.0):
        for horizontal in (0.0, 44.9, 45.0, 100.0, 135.0, 200.0, 225.0, 300.0, 315.0, 359.0, -30.0, 400.0):
            got = guidance.select_view_embedding(emb, vertical, horizontal)
            want = jguidance.select_view_embedding(jemb, jnp.float32(vertical), jnp.float32(horizontal))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            loss = guidance.ColorMatchGuidance().sds_loss(emb, torch.tensor(image), vertical=vertical,
                                                          horizontal=horizontal, guidance_scale=20.0)
            jloss = jguidance.ColorMatchGuidance().sds_loss(jemb, jnp.asarray(image), vertical=vertical,
                                                            horizontal=horizontal, guidance_scale=20.0)
            assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    monkeypatch.delenv("NS_SD_WEIGHTS", raising=False)
    sd, jsd = guidance.build_guidance("stablediffusion"), jguidance.build_guidance("stablediffusion")
    assert sd.available() is jsd.available() is False
    for g in (sd, jsd):
        with pytest.raises(RuntimeError, match="NS_SD_WEIGHTS"):
            g.embed_prompts(*"abcde")
        with pytest.raises(NotImplementedError, match="diffusers runtime"):
            g.sds_loss({}, None, vertical=0.0, horizontal=0.0)
    for build in (guidance.build_guidance, jguidance.build_guidance):
        with pytest.raises(ValueError, match="unknown guidance"):
            build("no-such-guidance")


def _batch(jt, step):
    return jt.datamanager.next_train(step)


def _compare_outputs(got, want, keys):
    for k in keys:
        g = got[k].detach().numpy().reshape(np.asarray(want[k]).shape)
        assert rel_l2(g, want[k]) <= OUT_TOL, (k, rel_l2(g, want[k]))


@pytest.mark.parametrize("train", [True, False])
def test_generative_forward_matches_jax(pair, train):
    jt, trainer = pair
    jm, model = jt.model, trainer.model
    batch = _batch(jt, 3)
    _, key, _ = jax.random.split(shaded_key(5), 3)
    step = 40
    want = jm.generative_forward(jt.state.params, jax.tree.map(jnp.asarray, batch), step=jnp.asarray(step),
                                 train=train, rng=key)
    tbatch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    got = model.generative_forward(tbatch, step=step, train=train, draws=jax_draws(key, model.config))
    keys = ["rgb", "accumulation", "depth", "expected_depth", "normals", "background_rgb",
            "rendered_orientation_loss", "opacity_loss"] + (["train_output"] if train else [])
    _compare_outputs(got, want, keys)


def test_eval_render_matches_jax(pair):
    jt, trainer = pair
    cams = trainer.datamanager.eval_cameras
    got = trainer.model.get_outputs_for_camera(cams, 2)
    want = jt.model.get_outputs_for_camera(jt.state.params, jt.datamanager.eval_cameras, 2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape == (RES, RES, want[k].shape[-1])
        assert rel_l2(got[k], want[k]) <= OUT_TOL, k


def test_train_step_with_normals_and_shading_matches_jax(pair):
    jt, trainer = pair
    before = jt.state.replace(rng=shaded_key(0))
    _, key_model, _ = jax.random.split(before.rng, 3)
    batch = _batch(jt, 0)
    after, jscalars = jt._train_step_jit(before, jax.device_put({k: np.asarray(v) for k, v in batch.items()}))
    jt.state = after
    scalars = trainer._train_step(trainer.state, {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()},
                                  draws=jax_draws(key_model, trainer.model.config))
    assert set(scalars) == set(jscalars)
    for k in jscalars:
        assert abs(float(scalars[k]) - float(jscalars[k])) <= LOSS_TOL * abs(float(jscalars[k])) + 1e-12, k
    assert float(jscalars["orientation_loss"]) > 0
    grads = flat(export_jax_tree(trainer.model, grads=True))
    for group in ("fields", "field_background", "proposal_networks"):
        _, jmu, _ = adam_state(after.opt_state, group)
        want = flat(jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), jmu), group)
        assert set(want) == {k for k in grads if k.startswith(group + "/")}
        for k, w in want.items():
            assert rel_l2(grads[k], w) <= GRAD_TOL, (k, rel_l2(grads[k], w))


def test_train_without_data_then_render(tmp_path, capsys, monkeypatch):
    out = tmp_path / "out"
    flags = ["--pipeline.model.render-resolution", str(RES), "--pipeline.model.num-levels", "4",
             "--pipeline.model.log2-hashmap-size", "10", "--pipeline.model.max-res", "64",
             "--pipeline.model.num-proposal-samples-per-ray", "8,6", "--pipeline.model.num-nerf-samples-per-ray", "4",
             "--pipeline.datamanager.resolution", str(RES), "--max-num-iterations", "3", "--output-dir", str(out)]
    assert ns_train.main(["generfacto", *flags], device="cpu") == 0
    (run,) = out.glob("generfacto/generfacto/*")
    assert (run / "dataparser_transforms.json").read_text() == "{}"
    (ckpt,) = (run / "nerfstudio_models").glob("step-*.ckpt")
    assert ckpt.name == "step-000000003.ckpt"
    frames = tmp_path / "frames"
    assert ns_render.main(["dataset", "--load-config", str(run / "config.yml"), "--output-path", str(frames),
                           "--rendered-output-names", "rgb", "normals"], device="cpu") == 0
    for name in ("rgb", "normals"):
        assert len(list((frames / name).glob("*.png"))) == 8
    with pytest.raises(NotImplementedError, match="no GT images"):
        ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(tmp_path / "e.json")],
                     device="cpu")
    assert ns_train.main(["splatfacto", "--output-dir", str(out)], device="cpu") == 2  # other methods need --data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # the card by default, no CPU fallback
        ns_train.main(["generfacto", *flags])
