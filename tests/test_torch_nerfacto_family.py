"""The nerfacto family (`nerfacto`, `nerfacto-tpu`, `nerfacto-big`,
`nerfacto-huge`) and the new config classes of the port against the JAX
package, on the CPU.

- Each registration's config equals the JAX package's field for field
  (class names and values, recursively), its `to_dict` tree too, and its
  description; `setup_trainer` gives it the Nerfstudio dataparser and a
  NerfactoModel; `scripts.train --help` lists the six methods.
- config.yml round trips (PyYAML reads the file back to the same tree,
  `load_config` gives back an equal config) for each registration and for
  a config holding RAdamOptimizerConfig, MultiStepSchedulerConfig and
  CosineDecaySchedulerConfig; the same flag lists (density mode, optimizer
  type, clipping, weight decay, accumulation, TV loss, shared proposal
  net) give equal trees in both CLIs.
- One f32 training step of a tiny nerfacto-tpu (the 4 x 128 base MLP of
  tests/test_torch_render.py's `tiny`, through the fused-MLP path) on the
  Nerfstudio parse of the synthetic scene, from the JAX model's params,
  batch and jitter: every loss and metric rel 1e-4, every group's
  gradient rel L2 1e-3 (tests/test_torch_train.py's tolerances and
  reasons).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from nerfstudio_thermal_tpu.configs import cli as jax_cli
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.serialization import to_dict as jax_to_dict
from nerfstudio_thermal_tpu.data.dataparsers.nerfstudio_dataparser import Nerfstudio as JaxNerfstudio
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSampler as JaxSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSamplerConfig as JaxSamplerConfig
from nerfstudio_thermal_tpu.engine import optimizers as jax_optimizers
from nerfstudio_thermal_tpu.engine import schedulers as jax_schedulers
from nerfstudio_thermal_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step
from nerfstudio_thermal_tpu.models.nerfacto import NerfactoModel as JaxNerfactoModel

from nerfstudio_thermal_torch.configs import cli
from nerfstudio_thermal_torch.configs.method_configs import descriptions, get_method_config, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config, save_config, to_dict
from nerfstudio_thermal_torch.data.dataparsers.nerfstudio_dataparser import Nerfstudio, ThermalNerf
from nerfstudio_thermal_torch.engine import optimizers, schedulers
from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel
from nerfstudio_thermal_torch.scripts import train as train_script
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_config_cli import _port_tags
from tests.test_torch_configs import _field_differences
from tests.test_torch_render import tiny
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, _method, adam_state, flat, rel_l2

torch.set_num_threads(1)

FAMILY = ["nerfacto", "nerfacto-tpu", "nerfacto-big", "nerfacto-huge"]
NUM_RAYS = 64
FLAGS = [
    ["--pipeline.model.density-mode", "shared", "--model.tv-rgb-loss-mult", "0.1"],
    ["--pipeline.model.density-mode", "rgb_only", "--model.use-gradient-scaling", "True"],
    ["--optimizers.fields.optimizer.optimizer-type", "radam", "--optimizers.fields.optimizer.max-norm", "1.0"],
    ["--optimizers.proposal-networks.optimizer.weight-decay", "0.01", "--trainer.gradient-accumulation-steps", "2"],
    ["--optimizers.fields.scheduler.max-steps", "500", "--optimizers.fields.scheduler.warmup-steps", "10"],
    ["--model.use-same-proposal-network", "True", "--model.num-density-tv-samples", "100",
     "--model.tv-thermal-loss-mult", "0.2"],
]


@pytest.mark.parametrize("name", FAMILY)
def test_config_equals_jax(name):
    port, want = get_method_config(name), jax_method_config(name)
    assert _field_differences(type(port), type(want), name, port, want) == []
    assert to_dict(port) == _port_tags(jax_to_dict(want))
    assert descriptions[name] == want.description
    assert type(port.model).__name__ == "NerfactoModelConfig"


@pytest.mark.parametrize("name", FAMILY)
def test_param_trees_carry_both_ways(name):
    """Each nerfacto config's JAX param tree (its widths; the hash tables cut
    to 2^10 rows a level) loads into the port's NerfactoModel and exports
    back unchanged, layouts included (the fused base MLP's flat layout in
    nerfacto-tpu, the huge model's 7-level proposal grid)."""
    jm, pm = jax_method_config(name).model, get_method_config(name).model
    for m in (jm, pm):
        m.log2_hashmap_size = min(m.log2_hashmap_size, 10)
        m.proposal_net_args_list = [dict(a, log2_hashmap_size=10) if "log2_hashmap_size" in a else dict(a)
                                    for a in m.proposal_net_args_list]
    aabb = np.asarray([[-1.0] * 3, [1.0] * 3], np.float32)
    jmodel = JaxNerfactoModel(jm, aabb, 3, {})
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(2)))
    model = NerfactoModel(pm, aabb, 3, device="cpu")
    load_jax_params(model, params)
    assert set(model.param_groups()) == set(params)
    back, want = flat(export_jax_tree(model)), flat(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_train_help_lists_the_six_methods(capsys):
    assert train_script.main(["--help"], device="cpu") == 0
    out = capsys.readouterr().out
    for name in FAMILY + ["thermal-nerfacto", "thermal-nerfacto-tpu"]:
        assert f"  {name:24s} {descriptions[name]}" in out, name


def _with_new_classes(pkg_opt, pkg_sched, config):
    config.optimizers["fields"] = pkg_opt.OptimizerGroupConfig(
        optimizer=pkg_opt.RAdamOptimizerConfig(lr=1e-2, eps=1e-15, max_norm=1.0),
        scheduler=pkg_sched.CosineDecaySchedulerConfig(warm_up_end=10, max_steps=1000),
    )
    config.optimizers["camera_opt"] = pkg_opt.OptimizerGroupConfig(
        optimizer=pkg_opt.AdamOptimizerConfig(lr=1e-3, eps=1e-15, weight_decay=1e-2),
        scheduler=pkg_sched.MultiStepSchedulerConfig(milestones=(100, 200), gamma=0.5),
    )
    return config


@pytest.mark.parametrize("name", FAMILY + ["new-classes"])
def test_config_yml_round_trip(tmp_path, name):
    if name == "new-classes":
        config = _with_new_classes(optimizers, schedulers, get_method_config("thermal-nerfacto"))
        want = _with_new_classes(jax_optimizers, jax_schedulers, jax_method_config("thermal-nerfacto"))
        assert to_dict(config) == _port_tags(jax_to_dict(want))
    else:
        config = get_method_config(name)
    path = tmp_path / "config.yml"
    save_config(config, path)
    assert yaml.safe_load(path.read_text()) == to_dict(config)
    loaded = load_config(path)
    assert loaded == config
    assert isinstance(loaded.model.num_proposal_samples_per_ray, tuple)


@pytest.mark.parametrize("flags", FLAGS, ids=[f[0].split(".")[-1] + "-" + f[-2].split(".")[-1] for f in FLAGS])
def test_cli_flags_match_jax(flags):
    config, rest = cli.apply_cli_overrides(get_method_config("thermal-nerfacto"), list(flags))
    jax_config, jax_rest = jax_cli.apply_cli_overrides(jax_method_config("thermal-nerfacto"), list(flags))
    assert rest == jax_rest == []
    assert to_dict(config) == _port_tags(jax_to_dict(jax_config))
    assert to_dict(config) != to_dict(get_method_config("thermal-nerfacto"))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4)


def test_setup_trainer_takes_the_nerfstudio_parser(scene, tmp_path):
    for name, parser, model in (("nerfacto-tpu", Nerfstudio, NerfactoModel), ("thermal-nerfacto-tpu", ThermalNerf, None)):
        method = _method(get_method_config, "float32", scene, name, tiny)
        trainer = setup_trainer(method, base_dir=tmp_path / name, device="cpu")
        assert type(trainer.datamanager.dataparser) is parser
        if model is not None:
            assert type(trainer.model) is model
            assert set(trainer.model.param_groups()) == {"fields", "proposal_networks", "camera_opt"}


def test_nerfacto_tpu_train_step_matches_jax(scene, tmp_path):
    jm = jax_method_config("nerfacto-tpu")
    tiny(jm.model, "float32")
    jm.dataparser.data = scene
    parsed = JaxNerfstudio(jm.dataparser).get_dataparser_outputs("train")
    dataset = JaxDataset(parsed)
    cameras = jax.tree.map(jnp.asarray, parsed.cameras)
    jmodel = JaxNerfactoModel(jm.model, parsed.scene_box, len(dataset), {})
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    tx = jax_build_optimizer(jm.optimizers, params)
    core = jax_make_ray_train_step(jmodel, tx)
    state = JaxTrainState(
        params=params, opt_state=tx.init(params), step=jnp.asarray(0, jnp.int32),
        steps_since_update=jnp.asarray(0, jnp.int32), steps_since_update_thermal=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(42), extra=None,
    )
    batch = JaxSampler(JaxSamplerConfig(NUM_RAYS, 1), dataset, seed=0).sample(step=0)
    new_state, want = jax.jit(lambda st, b: core(st, b, cameras))(state, batch)

    method = _method(get_method_config, "float32", scene, "nerfacto-tpu", tiny)
    trainer = setup_trainer(method, base_dir=tmp_path, device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, params))
    trainer.setup()
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(trainer.cameras, k).numpy(), np.asarray(getattr(cameras, k)), rtol=1e-6)
    _, key_model, _, _ = jax.random.split(state.rng, 4)
    keys = jax.random.split(key_model, len(jm.model.num_proposal_samples_per_ray) + 1)
    uniforms = {"rgb": [torch.tensor(np.asarray(jax.random.uniform(k, (NUM_RAYS, 1)))) for k in keys]}
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()}, uniforms=uniforms)
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= LOSS_TOL["float32"] * max(abs(float(w)), 1e-3), (k, float(got[k]), float(w))
    grads = flat(export_jax_tree(trainer.model, grads=True))
    assert {k.split("/")[0] for k in grads} == set(params)
    for group in params:
        _, mu, _ = adam_state(new_state.opt_state, group)
        jax_grads = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        got_g = np.concatenate([grads[k].ravel() for k in sorted(jax_grads)])
        want_g = np.concatenate([jax_grads[k].ravel() for k in sorted(jax_grads)])
        assert rel_l2(got_g, want_g) <= GRAD_TOL["float32"], (group, rel_l2(got_g, want_g))
