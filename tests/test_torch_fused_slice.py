"""thermal-nerfacto-tpu with the fused ray-march and whole-field kernels, through the port against the JAX package, on the CPU.

The tiny thermal-nerfacto-tpu of tests/test_torch_render.py (`tiny`: a
4 x 128 base MLP, 2 x 16 frequency proposals, few samples) with the three
knobs `bench.py` sets for its fused candidates: `fused_raymarch`,
`fused_field` and `fused_raymarch_proposals`. The JAX model runs the
Pallas `fused_ray_mlp` (four proposal fields, two cross densities) and
`fused_field_mlp` (two fields) in interpret mode; the port runs the plain
versions of its kernels through the same autograd nodes that launch the
kernels on the card. The port's model gets the JAX model's parameters
through `load_jax_params`, whose flat layouts (the proposal MLPs and the
colour heads run inside fused kernels) must export back unchanged.

- Render: an 8 x 7 image with a distorted camera in 16-ray chunks through
  each package's `get_outputs_for_camera`: every image output within 1e-4
  (f32) / 2e-2 (bf16), the tolerances of tests/test_torch_render.py.
- Training: one step of 64 rays from the same params, batch and jitter
  draws (the harness of tests/test_torch_train.py): every loss and metric
  within LOSS_TOL, every group's gradient and both Adam moments within
  GRAD_TOL (rel L2), with that file's reasons.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.models.thermal_nerfacto import ThermalNerfactoModel as JModel

from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.configs.method_configs import get_method_config
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_render import AABB, H, TOL, W, camera_arrays, tiny
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, JaxSide, adam_state, flat, port_moments, port_trainer, rel_l2

torch.set_num_threads(1)

METHOD = "thermal-nerfacto-tpu"
KNOBS = ("fused_raymarch", "fused_field", "fused_raymarch_proposals")


def tiny_fused(m, dtype):
    """`tiny` with the three fused knobs on."""
    tiny(m, dtype)
    for knob in KNOBS:
        setattr(m, knob, True)
    return m


def test_defaults_keep_the_knobs_off_and_params_round_trip():
    """Both packages ship thermal-nerfacto-tpu with the three knobs off.
    With them on, the JAX params (flat layouts for the proposal MLPs and
    colour heads) load into the port and export back to the same tree, and
    every fused module takes its fused path."""
    for m in (get_method_config(METHOD).model, jax_method_config(METHOD).model):
        assert not any(getattr(m, k) for k in KNOBS)
    meta = {"is_thermal": [0, 1]}
    jmodel = JModel(tiny_fused(jax_method_config(METHOD).model, "float32"), AABB, num_train_data=2, metadata=meta)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
    model = ThermalNerfactoModel(tiny_fused(get_method_config(METHOD).model, "float32"), AABB, 2, meta, device="cpu")
    load_jax_params(model, params)
    assert all(f._fused_field_ok() for f in (model.field, model.field_thermal))
    assert all(n.fuses_rays() for n in (*model.proposal_networks, *model.proposal_networks_thermal))
    back, want = flat(export_jax_tree(model)), flat(params)
    assert set(back) == set(want)
    assert "proposal_networks/0/mlp/Dense_0_kernel" in want and "fields/mlp_head/Dense_2_kernel" in want
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_render_matches_jax(dtype):
    meta = {"is_thermal": [0, 1]}
    jmodel = JModel(tiny_fused(jax_method_config(METHOD).model, dtype), AABB, num_train_data=2, metadata=meta)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    model = ThermalNerfactoModel(tiny_fused(get_method_config(METHOD).model, dtype), AABB, 2, meta, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))

    cams = camera_arrays()
    want = jmodel.get_outputs_for_camera(params, JCameras(**{k: jnp.asarray(v) for k, v in cams.items()}), 0)
    counters = (fm.fused_mlp, fr.fused_ray_mlp, fr.fused_field_mlp)
    before = [c.launches for c in counters]
    got = model.get_outputs_for_camera(Cameras(**{k: torch.as_tensor(v) for k, v in cams.items()}), 0)
    assert [c.launches for c in counters] == before  # the CPU runs the plain versions

    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == (H, W, w.shape[-1]), k
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], np.asarray(w), atol=TOL[dtype], rtol=TOL[dtype], err_msg=k)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_train_step_matches_jax(scene, tmp_path, dtype):
    """One step from the same params, batch and jitter: losses and metrics,
    each group's gradient, both Adam moments."""
    js = JaxSide(scene, dtype, METHOD, tiny_fused)
    state = js.state()
    batch = js.batch(0)
    new_state, want = js.step_fn(state, batch)

    trainer = port_trainer(scene, dtype, tmp_path, js.params, METHOD, tiny_fused)
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              uniforms=js.uniforms(state.rng))
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(float(got[k])), k
        assert abs(float(got[k]) - w) <= LOSS_TOL[dtype] * max(abs(w), 1e-3), (k, float(got[k]), w)

    grads = flat(export_jax_tree(trainer.model, grads=True))
    assert {k.split("/")[0] for k in grads} == set(js.params)
    mu_port, nu_port = flat(port_moments(trainer, "mu")), flat(port_moments(trainer, "nu"))
    cat = lambda tree, keys: np.concatenate([tree[k].ravel() for k in keys])  # noqa: E731
    for group in js.params:
        count, mu, nu = adam_state(new_state.opt_state, group)
        assert count == 1 == trainer.optimizers.groups[group].count
        want_g = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        keys = sorted(want_g)
        assert np.isfinite(cat(grads, keys)).all(), group
        assert rel_l2(cat(grads, keys), cat(want_g, keys)) <= GRAD_TOL[dtype], (group, rel_l2(cat(grads, keys), cat(want_g, keys)))
        for which, want_m, got_m in (("mu", mu, mu_port), ("nu", nu, nu_port)):
            w = flat({group: jax.tree.map(np.asarray, want_m)})
            assert rel_l2(cat(got_m, keys), cat(w, keys)) <= GRAD_TOL[dtype], (group, which)
    assert trainer.state.steps_since_update == int(new_state.steps_since_update)
