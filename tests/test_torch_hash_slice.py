"""thermal-nerfacto (the hash-grid method) through the port against the JAX package, on the CPU.

A tiny thermal-nerfacto (`tiny_hash`: 3-level base grid of 2^9 rows per
level feeding a 2 x 16 MLP; 2-level proposal grids of 2^8 rows, one with a
2 x 8 MLP and one with `use_linear`; few samples) with the JAX model's
parameters carried over by `load_jax_params`. The JAX model on the CPU
takes the XLA `hash_encode` route, the spec; the port takes the plain
versions of its hash kernels.

- Render: an 8 x 7 image with a distorted camera, in 16-ray chunks (the
  last padded), through each package's `get_outputs_for_camera`; the hash
  tables are scaled up from their +-1e-3 init so that the densities vary.
  Every image output within 1e-4 (f32: measured ~1e-7) or 2e-2 (bf16: one
  bf16 rounding flip in an MLP layer moves an output by about a bf16 step).
- Training: one step of 64 rays on tests/fixtures.make_synthetic_rgbt_dataset
  from the same params, batch and jitter draws (the harness of
  tests/test_torch_train.py): every loss and metric (rel 1e-4 f32, 2e-2
  bf16), every param group's gradient and every hash table's gradient
  (rel L2 1e-3 f32, 5e-2 bf16), and both Adam moments after the step. The
  reasons are those of tests/test_torch_train.py: the same f32 arithmetic
  in other orders (scatter-adds among them), and bf16 rounding flips.
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
from nerfstudio_thermal_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_render import AABB, H, W, camera_arrays
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, JaxSide, adam_state, flat, port_moments, port_trainer, rel_l2

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
METHOD = "thermal-nerfacto"


def tiny_hash(m, dtype):
    m.num_levels = 3
    m.base_res = 4
    m.max_res = 32
    m.log2_hashmap_size = 9
    m.hidden_dim = 16
    m.hidden_dim_color = 16
    m.appearance_embed_dim = 4
    m.num_proposal_samples_per_ray = (8, 6)
    m.num_nerf_samples_per_ray = 4
    m.eval_num_rays_per_chunk = 16
    m.proposal_net_args_list = [
        {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 16, "use_linear": False},
        {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 32, "use_linear": True},
    ]
    m.compute_dtype = dtype
    return m


def test_thermal_nerfacto_is_the_hash_method():
    """The port's config is the JAX package's: hash fields and proposals,
    bf16, no Pallas, the whole batch for the density loss, (256, 96) + 48
    samples, camera gradients through the proposal fields; it builds."""
    m, jm = get_method_config(METHOD).model, jax_method_config(METHOD).model
    for k in ("field_encoding", "compute_dtype", "use_pallas", "density_loss_rays_fraction", "num_levels",
              "base_res", "max_res", "log2_hashmap_size", "features_per_level", "hidden_dim",
              "num_proposal_samples_per_ray", "num_nerf_samples_per_ray", "proposal_camera_gradients",
              "proposal_net_args_list", "density_mode"):
        assert getattr(m, k) == getattr(jm, k), k
    assert (m.field_encoding, m.use_pallas, m.density_loss_rays_fraction) == ("hash", False, 1.0)
    assert tuple(m.num_proposal_samples_per_ray) == (256, 96) and m.num_nerf_samples_per_ray == 48
    model = ThermalNerfactoModel(tiny_hash(m, "bfloat16"), AABB, 2, {"is_thermal": [0, 1]}, device="cpu")
    assert all(isinstance(n, HashMLPDensityField) for n in (*model.proposal_networks, *model.proposal_networks_thermal))
    assert model.field.mlp_base.encoding.hash_table.shape == (3 * 2**9, 2)


def _scaled_tables(params, factor=300.0):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * factor if path[-1].key == "hash_table" else x, params
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_render_matches_jax(dtype):
    meta = {"is_thermal": [0, 1]}
    jmodel = JModel(tiny_hash(jax_method_config(METHOD).model, dtype), AABB, num_train_data=2, metadata=meta)
    params = _scaled_tables(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
    model = ThermalNerfactoModel(tiny_hash(get_method_config(METHOD).model, dtype), AABB, 2, meta, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))

    cams = camera_arrays()
    want = jmodel.get_outputs_for_camera(params, JCameras(**{k: jnp.asarray(v) for k, v in cams.items()}), 0)
    before = th.hash_encode_fwd.launches
    got = model.get_outputs_for_camera(Cameras(**{k: torch.as_tensor(v) for k, v in cams.items()}), 0)
    assert th.hash_encode_fwd.launches == before  # the CPU runs the plain version

    assert set(got) == set(want)
    for k in ("rgb", "rgb_thermal", "accumulation", "depth", "removal", "removal_thermal"):
        assert k in got
    assert np.ptp(got["accumulation"]) > 1e-3  # the scaled tables give varying densities
    for k, w in want.items():
        assert got[k].shape == (H, W, w.shape[-1]), k
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], np.asarray(w), atol=TOL[dtype], rtol=TOL[dtype], err_msg=k)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_train_step_matches_jax(scene, tmp_path, dtype):
    """One step from the same params, batch and jitter: losses and metrics,
    each group's gradient and each hash table's, Adam moments."""
    js = JaxSide(scene, dtype, METHOD, tiny_hash)
    state = js.state()
    batch = js.batch(0)
    new_state, want = js.step_fn(state, batch)

    trainer = port_trainer(scene, dtype, tmp_path, js.params, METHOD, tiny_hash)
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              uniforms=js.uniforms(state.rng))
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(float(got[k])), k
        assert abs(float(got[k]) - w) <= LOSS_TOL[dtype] * max(abs(w), 1e-3), (k, float(got[k]), w)

    grads = flat(export_jax_tree(trainer.model, grads=True))
    tables = sorted(k for k in grads if k.endswith("hash_table"))
    assert len(tables) == 6  # two base fields, four proposal fields
    # every table but the thermal hierarchy's last proposal gets a gradient
    # in this step (that one gets exact zeros, in the JAX step too)
    assert sum(np.abs(grads[k]).max() > 0 for k in tables) >= 5
    assert {k.split("/")[0] for k in grads} == set(js.params)
    mu_port, nu_port = flat(port_moments(trainer, "mu")), flat(port_moments(trainer, "nu"))
    for group in js.params:
        count, mu, nu = adam_state(new_state.opt_state, group)
        assert count == 1 == trainer.optimizers.groups[group].count
        want_g = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        cat = lambda tree, keys: np.concatenate([tree[k].ravel() for k in keys])  # noqa: E731
        keys = sorted(want_g)
        assert np.isfinite(cat(grads, keys)).all(), group
        assert rel_l2(cat(grads, keys), cat(want_g, keys)) <= GRAD_TOL[dtype], (group, rel_l2(cat(grads, keys), cat(want_g, keys)))
        for k in keys:
            if k.endswith("hash_table"):
                assert rel_l2(grads[k], want_g[k]) <= GRAD_TOL[dtype], (k, rel_l2(grads[k], want_g[k]))
        for which, want_m, got_m in (("mu", mu, mu_port), ("nu", nu, nu_port)):
            w = flat({group: jax.tree.map(np.asarray, want_m)})
            assert rel_l2(cat(got_m, keys), cat(w, keys)) <= GRAD_TOL[dtype], (group, which)
    assert trainer.state.steps_since_update == int(new_state.steps_since_update)
