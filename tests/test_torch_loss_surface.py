"""thermal-nerfacto's density TV loss, gradient scaling and one shared proposal net, through the port against the JAX package, on the CPU.

- The density TV loss (`tv_rgb_loss_mult`, `tv_thermal_loss_mult` > 0):
  `NerfactoField.sample_and_density` at uniform points, some outside the
  unit box, against the JAX field's at the same points (the hash field and
  the tpu variant's fused base MLP); and one training step whose TV points
  are JAX's own draws (uniform(fold_in(loss key, 1 or 2), (P, 3)) of the
  step's loss key) passed to the port.
- `use_gradient_scaling`: one training step (every field output's and
  cross density's gradient scaled by clamp(mid-distance^2, 0, 1)).
- `use_same_proposal_network`: two steps, the first updating the proposal
  net and the second not, with one proposal net called by both proposal
  iterations (param subtree "0"); moments, counts and parameters after
  both steps.

Tolerances are those of tests/test_torch_train.py: losses rel 1e-4 (f32),
gradients and moments rel L2 1e-3 (f32): the same f32 arithmetic in other
orders. The densities at the TV points: rel 1e-5 (f32 MLPs, the same
trunc_exp). Parameters after steps are compared where JAX's gradient is not
rounding noise, as tests/test_torch_density_modes.py explains.
"""

import numpy as np
import jax
import pytest
import torch

from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.models.thermal_nerfacto import ThermalNerfactoModel as JModel

from nerfstudio_thermal_torch.configs.method_configs import get_method_config
from nerfstudio_thermal_torch.model_components.losses import tv_density_loss
from nerfstudio_thermal_torch.models import nerfacto
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_density_modes import assert_step_matches, cat, NOISE
from tests.test_torch_hash_slice import tiny_hash
from tests.test_torch_render import AABB, tiny
from tests.test_torch_train import JaxSide, adam_state, flat, port_moments, port_trainer, rel_l2

torch.set_num_threads(1)

TV_POINTS = 50
TV_MULT = 0.5


def with_settings(cut, **settings):
    def f(m, dtype):
        cut(m, dtype)
        for k, v in settings.items():
            setattr(m, k, v)
        return m

    return f


TV = dict(tv_rgb_loss_mult=TV_MULT, tv_thermal_loss_mult=TV_MULT, num_density_tv_samples=TV_POINTS)
SAME_PROPOSAL = dict(
    use_same_proposal_network=True,
    proposal_net_args_list=[
        {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 16, "use_linear": False},
    ],
)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4)


def jax_tv_uniforms(rng):
    """The TV points the JAX step draws from its loss key."""
    _, _, key_loss, _ = jax.random.split(rng, 4)
    return {name: torch.tensor(np.asarray(jax.random.uniform(jax.random.fold_in(key_loss, i), (TV_POINTS, 3))))
            for name, i in (("rgb", 1), ("thermal", 2))}


@pytest.mark.parametrize("method,cut", [("thermal-nerfacto", tiny_hash), ("thermal-nerfacto-tpu", tiny)],
                         ids=["hash", "tpu"])
def test_sample_and_density_matches_jax(method, cut):
    """[7 P, 1] densities at P points (a quarter outside the aabb's unit box
    or the box itself) and their neighbours, and the TV loss on them."""
    meta = {"is_thermal": [0, 1]}
    jmodel = JModel(cut(jax_method_config(method).model, "float32"), AABB, num_train_data=2, metadata=meta)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 300.0 if "hash_table" in jax.tree_util.keystr(path) else x, params)
    model = ThermalNerfactoModel(cut(get_method_config(method).model, "float32"), AABB, 2, meta, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    key = jax.random.PRNGKey(5)
    want = jmodel.field.apply({"params": params["fields"]}, key, 203, 32.0, method=jmodel.field.sample_and_density)
    uniforms = torch.tensor(np.asarray(jax.random.uniform(key, (203, 3))))
    with torch.no_grad():
        got = model.field.sample_and_density(uniforms, 32.0)
    assert got.shape == (7 * 203, 1)
    points = np.asarray(AABB)[0] + (np.asarray(AABB)[1] - np.asarray(AABB)[0]) * uniforms.numpy()
    assert 0 < np.mean(np.any((points <= 0) | (points >= 1), -1)) < 1  # both sides of the selector
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    from nerfstudio_thermal_tpu.model_components.losses import tv_density_loss as jax_tv

    assert abs(float(tv_density_loss(got, 203)) - float(jax_tv(want, 203))) <= 1e-5 * float(jax_tv(want, 203))


@pytest.mark.parametrize("method,cut,settings", [
    ("thermal-nerfacto", tiny_hash, TV),
    ("thermal-nerfacto-tpu", tiny, TV),
    ("thermal-nerfacto", tiny_hash, dict(use_gradient_scaling=True)),
    ("thermal-nerfacto", tiny_hash, dict(use_gradient_scaling=True, density_mode="shared")),
], ids=["tv-hash", "tv-tpu", "gradient-scaling", "gradient-scaling-shared"])
def test_train_step_matches_jax(scene, tmp_path, method, cut, settings):
    """One f32 step: losses (the two TV losses among them), every gradient,
    both moments and the parameters."""
    cut = with_settings(cut, **settings)
    js = JaxSide(scene, "float32", method, cut)
    state = js.state()
    batch = js.batch(0)
    new_state, want = js.step_fn(state, batch)
    trainer = port_trainer(scene, "float32", tmp_path, js.params, method, cut)
    tv = jax_tv_uniforms(state.rng) if settings is TV else None
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              uniforms=js.uniforms(state.rng), tv_uniforms=tv)
    assert_step_matches(js, new_state, want, trainer, got, "float32")
    assert ("tv_rgb_loss" in got and "tv_thermal_loss" in got) == (settings is TV)


def test_train_step_draws_its_own_tv_points(scene, tmp_path):
    """Without injected points the port draws them from the state's
    generator: finite TV losses, and the generator moves."""
    trainer = port_trainer(scene, "float32", tmp_path, None, "thermal-nerfacto", with_settings(tiny_hash, **TV))
    before = trainer.state.generator.get_state()
    out = trainer.train_iteration(0)
    assert np.isfinite(float(out["tv_rgb_loss"])) and np.isfinite(float(out["tv_thermal_loss"]))
    assert not torch.equal(before, trainer.state.generator.get_state())


def test_same_proposal_network_over_a_skipped_update_matches_jax(scene, tmp_path):
    """Steps 100 (proposal update) and 101 (none) with one RGB proposal net
    for both iterations: one subtree "0", one call per iteration, and after
    both steps the moments, counts and parameters of every group."""
    cut = with_settings(tiny_hash, **SAME_PROPOSAL)
    js = JaxSide(scene, "float32", "thermal-nerfacto", cut)
    assert set(js.params["proposal_networks"]) == {"0"}
    assert set(js.params["proposal_networks_thermal"]) == {"0", "1"}  # the thermal stack is not shared
    state = js.state(step=100, ssu=2)
    trainer = port_trainer(scene, "float32", tmp_path, js.params, "thermal-nerfacto", cut)
    assert len(trainer.model.proposal_networks) == 1 and len(trainer.model.proposal_networks_thermal) == 2
    calls = []
    hook = trainer.model.proposal_networks[0].register_forward_hook(lambda *a: calls.append(1))
    trainer.state.step, trainer.state.steps_since_update = 100, 2
    flags = []
    for i in range(2):
        batch = js.batch(100 + i)
        flags.append(nerfacto.proposal_updated(trainer.state.step, trainer.state.steps_since_update, 5000, 5)[0])
        uniforms = js.uniforms(state.rng)
        state, _ = js.step_fn(state, batch)
        trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()}, uniforms=uniforms)
    hook.remove()
    assert flags == [True, False] and len(calls) == 4  # two iterations a step
    mu_port, nu_port = flat(port_moments(trainer, "mu")), flat(port_moments(trainer, "nu"))
    params_port = flat(export_jax_tree(trainer.model))
    for group in js.params:
        count, mu, nu = adam_state(state.opt_state, group)
        assert count == 2 == trainer.optimizers.groups[group].count
        keys = sorted(flat({group: jax.tree.map(np.asarray, mu)}))
        for which, want_tree, got in (("mu", mu, mu_port), ("nu", nu, nu_port)):
            want = flat({group: jax.tree.map(np.asarray, want_tree)})
            assert rel_l2(cat(got, keys), cat(want, keys)) <= 1e-3, (group, which, rel_l2(cat(got, keys), cat(want, keys)))
        want_p = cat(flat({group: jax.tree.map(np.asarray, state.params[group])}), keys)
        mu_w = flat({group: jax.tree.map(np.asarray, mu)})
        noise = np.concatenate([(0 < np.abs(mu_w[k]).ravel()) & (np.abs(mu_w[k]).ravel() <= NOISE * np.abs(mu_w[k]).max())
                                for k in keys])
        got_p = cat(params_port, keys)
        assert rel_l2(got_p[~noise], want_p[~noise]) <= 1e-3, (group, "params", rel_l2(got_p[~noise], want_p[~noise]))
        assert noise.mean() < 0.5, (group, noise.mean())
