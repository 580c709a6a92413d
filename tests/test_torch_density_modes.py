"""thermal-nerfacto's density ablations (`shared`, `rgb_only`) through the port against the JAX package, on the CPU.

The paper's two ablations of the default `separate` mode: `shared` (one
field with a 4-channel RGBT head, one proposal stack, the RGB camera
optimizers only) and `rgb_only` (one 3-channel field, no thermal loss,
pixel TV, cross-channel loss or thermal PSNR). Each runs on the hash
method (`tiny_hash` of tests/test_torch_hash_slice.py: the JAX model takes
the XLA hash encoding, the port the plain versions of its hash kernels)
and on thermal-nerfacto-tpu with its three fused knobs (`tiny_fused` of
tests/test_torch_fused_slice.py: JAX's Pallas kernels in interpret mode,
the port the plain versions of its ray-march and whole-field kernels; in
`shared` the whole-field kernel's output is [N, 4 + 2]); `shared` also on
thermal-nerfacto-tpu without the knobs (`tiny` of
tests/test_torch_render.py: the fused-MLP base and the eager 4-channel
head).

- Training: one step of 64 rays from the same params, batch and jitter
  draws (the harness of tests/test_torch_train.py): every loss and metric
  (rel 1e-4 f32, 2e-2 bf16), every group's gradient, both Adam moments
  and the parameters after the step (rel L2 1e-3 f32, 5e-2 bf16), with
  that file's reasons (the same f32 arithmetic in other orders; bf16
  rounding flips). The parameters are compared where JAX's gradient is 0
  or exceeds 1e-4 of its tensor's largest entry: with eps 1e-15, Adam's
  first step moves every entry by +-lr whatever the gradient's size, so
  the sign of a tiny gradient picks the direction, and tiny gradients are
  where the two sides differ most (rounding noise of ~1e-15 on the hash
  tables; a relu unit at its kink, 1e-9 in one package and 0 in the other,
  in the base MLP); such entries must be fewer than half (up to 13%
  measured).
- Eval: an 8 x 7 image with a distorted camera in 16-ray chunks through
  each package's `get_outputs_for_camera`, every image output within 1e-4
  (f32) / 2e-2 (bf16) (tests/test_torch_render.py's tolerances), and the
  pipelines' image metrics of an RGB and a thermal image from the same
  outputs (JAX's, tiled to 64 x 70 for SSIM and LPIPS) within 1e-5 relative,
  1e-5 absolute below 1 (tests/test_torch_eval_metrics.py's).
- The parameter trees (the 4-channel head's last Dense, the groups each
  mode has) load into the port and export back unchanged.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.models.thermal_nerfacto import ThermalNerfactoModel as JModel
from nerfstudio_thermal_tpu.pipelines.base_pipeline import VanillaPipeline as JaxPipeline

from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.configs.method_configs import get_method_config
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
from nerfstudio_thermal_torch.pipelines.base_pipeline import VanillaPipeline
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_fused_slice import tiny_fused
from tests.test_torch_hash_slice import tiny_hash
from tests.test_torch_render import AABB, H, TOL, W, camera_arrays, tiny
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, JaxSide, adam_state, flat, port_moments, port_trainer, rel_l2

torch.set_num_threads(1)

METRIC_TOL = 1e-5
NOISE = 1e-4  # gradient entries below this share of their tensor's largest are noise
CASES = [
    ("thermal-nerfacto", tiny_hash, "shared"),
    ("thermal-nerfacto", tiny_hash, "rgb_only"),
    ("thermal-nerfacto-tpu", tiny_fused, "shared"),
    ("thermal-nerfacto-tpu", tiny_fused, "rgb_only"),
    ("thermal-nerfacto-tpu", tiny, "shared"),
]
IDS = ["hash-shared", "hash-rgb_only", "fused-shared", "fused-rgb_only", "tpu-shared"]


def with_mode(cut, mode):
    def f(m, dtype):
        cut(m, dtype)
        m.density_mode = mode
        return m

    return f


def cat(tree, keys):
    return np.concatenate([tree[k].ravel() for k in keys])


def assert_step_matches(js, new_state, want, trainer, got, dtype):
    """Every loss and metric; every group's gradient (JAX's from its first
    Adam moment), both moments and the parameters after the step."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert np.isfinite(float(got[k])), k
        assert abs(float(got[k]) - w) <= LOSS_TOL[dtype] * max(abs(w), 1e-3), (k, float(got[k]), w)
    grads = flat(export_jax_tree(trainer.model, grads=True))
    assert {k.split("/")[0] for k in grads} == set(js.params) == set(trainer.optimizers.groups)
    mu_port, nu_port = flat(port_moments(trainer, "mu")), flat(port_moments(trainer, "nu"))
    params_port = flat(export_jax_tree(trainer.model))
    for group in js.params:
        count, mu, nu = adam_state(new_state.opt_state, group)
        assert count == 1 == trainer.optimizers.groups[group].count
        want_g = flat({group: jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)})
        keys = sorted(want_g)
        assert np.isfinite(cat(grads, keys)).all(), group
        assert rel_l2(cat(grads, keys), cat(want_g, keys)) <= GRAD_TOL[dtype], (group, rel_l2(cat(grads, keys), cat(want_g, keys)))
        for which, want_t, got_t in (("mu", mu, mu_port), ("nu", nu, nu_port)):
            w = flat({group: jax.tree.map(np.asarray, want_t)})
            assert rel_l2(cat(got_t, keys), cat(w, keys)) <= GRAD_TOL[dtype], (group, which, rel_l2(cat(got_t, keys), cat(w, keys)))
        w = flat({group: jax.tree.map(np.asarray, new_state.params[group])})
        noise = np.concatenate([(0 < np.abs(want_g[k]).ravel()) & (np.abs(want_g[k]).ravel() <= NOISE * np.abs(want_g[k]).max())
                                for k in keys])
        got_p, want_p = cat(params_port, keys), cat(w, keys)
        assert rel_l2(got_p[~noise], want_p[~noise]) <= GRAD_TOL[dtype], (group, "params", rel_l2(got_p[~noise], want_p[~noise]))
        assert noise.mean() < 0.5, (group, noise.mean())
    assert trainer.state.steps_since_update == int(new_state.steps_since_update)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4)


@pytest.mark.parametrize("method,cut,mode", CASES, ids=IDS)
def test_params_carry_both_ways(method, cut, mode):
    """The JAX tree of each mode (no thermal field, proposals or thermal
    camera optimizers; the shared head's last Dense 4 wide) loads into the
    port and exports back unchanged."""
    meta = {"is_thermal": [0, 1]}
    jmodel = JModel(with_mode(cut, mode)(jax_method_config(method).model, "float32"), AABB, num_train_data=2,
                    metadata=meta)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
    model = ThermalNerfactoModel(with_mode(cut, mode)(get_method_config(method).model, "float32"), AABB, 2, meta,
                                 device="cpu")
    assert not any(k.endswith("_thermal") for k in params) and {"fields", "proposal_networks"} <= set(params)
    load_jax_params(model, params)
    assert set(model.param_groups()) == set(params)
    back, want = flat(export_jax_tree(model)), flat(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    head = [k for k in want if k.startswith("fields/mlp_head/") and "kernel" in k]
    assert want[sorted(head)[-1]].shape[-1] == 3 + (mode == "shared")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method,cut,mode", CASES, ids=IDS)
def test_train_step_matches_jax(scene, tmp_path, method, cut, mode, dtype):
    js = JaxSide(scene, dtype, method, with_mode(cut, mode))
    state = js.state()
    batch = js.batch(0)
    new_state, want = js.step_fn(state, batch)
    trainer = port_trainer(scene, dtype, tmp_path, js.params, method, with_mode(cut, mode))
    got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              uniforms=js.uniforms(state.rng))
    assert_step_matches(js, new_state, want, trainer, got, dtype)
    assert ("psnr_thermal" in got) == (mode == "shared")
    assert ("thermal_loss" in got) == (mode == "shared")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method,cut,mode", CASES, ids=IDS)
def test_eval_outputs_and_metrics_match_jax(method, cut, mode, dtype):
    meta = {"is_thermal": [0, 1]}
    jmodel = JModel(with_mode(cut, mode)(jax_method_config(method).model, dtype), AABB, num_train_data=2,
                    metadata=meta)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    model = ThermalNerfactoModel(with_mode(cut, mode)(get_method_config(method).model, dtype), AABB, 2, meta,
                                 device="cpu")
    if method == "thermal-nerfacto":
        # scale the hash tables up from their +-1e-3 init so that densities vary
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: x * 300.0 if "hash_table" in jax.tree_util.keystr(path) else x, params)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    cams = camera_arrays()
    want = jmodel.get_outputs_for_camera(params, JCameras(**{k: jnp.asarray(v) for k, v in cams.items()}), 0)
    got = model.get_outputs_for_camera(Cameras(**{k: torch.as_tensor(v) for k, v in cams.items()}), 0)
    assert set(got) == set(want)
    assert ("rgbt" in got) == (mode == "shared") and ("rgb_thermal" in got) == (mode == "shared")
    for k, w in want.items():
        assert got[k].shape == (H, W, w.shape[-1]), k
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], np.asarray(w), atol=TOL[dtype], rtol=TOL[dtype], err_msg=k)

    # the pipelines' image metrics, RGB and thermal, from the same (JAX's)
    # outputs tiled 8 x 10 (SSIM's window and LPIPS's VGG need the size)
    rng = np.random.default_rng(3)
    tile = lambda x: np.tile(np.asarray(x, np.float32), (8, 10, 1))  # noqa: E731
    for is_thermal in (0.0, 1.0):
        gt = rng.uniform(0, 1, (8 * H, 10 * W, 3)).astype(np.float32)
        batch = {"image": gt, "is_thermal": np.float32(is_thermal)}
        jm, _ = JaxPipeline.compute_image_metrics(None, {k: tile(v) for k, v in want.items()}, batch, 0)
        pm, _ = VanillaPipeline.compute_image_metrics(
            None, {k: torch.as_tensor(tile(v)) for k, v in want.items()}, batch)
        assert set(pm) == set(jm)
        if is_thermal and mode == "rgb_only":
            assert set(pm) == {"_num_rays"}  # no thermal head, no thermal metric
        for k in jm:
            assert abs(pm[k] - jm[k]) <= METRIC_TOL * max(abs(jm[k]), 1.0), (k, pm[k], jm[k])
