"""`fused_modalities` against the JAX package's `_get_outputs_fused` (both
modalities' pipelines vmapped over a stacked [2] axis) on the CPU. The
port runs the flag on its sequential path with a 3-channel thermal head.

Tiny thermal-nerfacto (hash fields, `tiny_hash`) and thermal-nerfacto-tpu
(freq fields through the fused-MLP wrapper's plain version, `tiny`), f32,
in separate mode. The port's model gets the JAX model's parameters
through `load_jax_params`, and JAX's jitter draws (rebuilt from its key
splits: RGB, then thermal, one key per sampling level). Tolerances are
those of the JAX package's own fused-vs-sequential test
(tests/models/test_thermal_nerfacto.py): outputs 2e-5 absolute and
relative; every group's gradient of the summed losses atol 5e-5, rtol
5e-4 (the same f32 arithmetic in other orders and layouts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.cameras.rays import RayBundle as JaxBundle
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.models.thermal_nerfacto import ThermalNerfactoModel as JaxModel

from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_hash_slice import tiny_hash
from tests.test_torch_render import tiny

torch.set_num_threads(1)

OUT_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4
R = 16
META = {"is_thermal": [0, 1, 0, 1]}
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
CUTS = {"thermal-nerfacto": tiny_hash, "thermal-nerfacto-tpu": tiny}
COMPARED = ("rgb", "rgb_thermal", "density", "density_thermal", "accumulation", "accumulation_thermal",
            "depth", "depth_thermal", "expected_depth", "expected_depth_thermal", "density2", "density2_thermal")


def _config(get, name, **overrides):
    cfg = CUTS[name](get(name).model, "float32")
    cfg.fused_modalities = True
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _inputs():
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    bundle = dict(
        origins=rng.uniform(-0.1, 0.1, (R, 3)).astype(np.float32), directions=dirs,
        pixel_area=np.full((R, 1), 1e-6, np.float32), camera_indices=rng.integers(0, 4, (R, 1)).astype(np.int32),
    )
    batch = dict(image=rng.uniform(size=(R, 3)).astype(np.float32),
                 is_thermal=np.repeat(np.array([0.0, 1.0], np.float32), R // 2))
    return bundle, batch


def _jax_uniforms(rng, levels):
    out = {}
    for name, key in zip(("rgb", "thermal"), jax.random.split(rng)):
        out[name] = [torch.tensor(np.asarray(jax.random.uniform(k, (R, 1)))) for k in jax.random.split(key, levels)]
    return out


def _port_step(model, bundle, batch, uniforms):
    """Outputs and summed losses of one training forward, and the gradient
    of the losses in the JAX layout."""
    model.zero_grad(set_to_none=True)
    tb = RayBundle(**{k: torch.as_tensor(v) for k, v in bundle.items()})
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = model(tb, train=True, uniforms=uniforms)
    metrics = model.get_metrics_dict(out, tbatch, train=True)
    losses = model.get_loss_dict(out, tbatch, metrics, train=True)
    sum(losses[k] for k in sorted(losses)).backward()
    return out, losses, export_jax_tree(model, grads=True)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("name,overrides", [
    ("thermal-nerfacto", {}),
    ("thermal-nerfacto", dict(use_gradient_scaling=True, proposal_camera_gradients=False)),
    ("thermal-nerfacto-tpu", {}),
    ("thermal-nerfacto-tpu", dict(fused_raymarch=True, fused_field=True, fused_raymarch_proposals=True)),
    ("thermal-nerfacto-tpu", dict(use_gradient_scaling=True, proposal_camera_gradients=False)),
], ids=["hash", "hash+scaling+detached-proposals", "tpu", "tpu+fused-knobs", "tpu+scaling+detached-proposals"])
def test_fused_modalities_matches_jax(name, overrides):
    """One training forward and backward: the port's path against JAX's
    vmapped `_get_outputs_fused`, same parameters and jitter."""
    jcfg = _config(jax_method_config, name, **overrides)
    jmodel = JaxModel(jcfg, AABB, num_train_data=4, metadata=META)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    bundle, batch = _inputs()
    jbundle = JaxBundle(**{k: jnp.asarray(v) for k, v in bundle.items()})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        out = jmodel.forward(p, jbundle, train=True, rng=rng)
        metrics = jmodel.get_metrics_dict(p, out, jbatch, train=True)
        losses = jmodel.get_loss_dict(p, out, jbatch, metrics, train=True, rng=rng)
        return sum(jax.tree.leaves(losses)), (out, losses)

    (_, (want, want_losses)), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = ThermalNerfactoModel(_config(get_method_config, name, **overrides), AABB, 4, META, device="cpu")
    assert model.field_thermal.num_channels == 3
    load_jax_params(model, jax.tree.map(np.asarray, params))
    levels = len(jcfg.num_proposal_samples_per_ray) + 1
    got, got_losses, got_grads = _port_step(model, bundle, batch, _jax_uniforms(rng, levels))

    assert got["rgb_thermal"].shape == (R, 1)
    for k in COMPARED:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=OUT_TOL, rtol=OUT_TOL,
                                   err_msg=k)
    assert set(got_losses) == set(want_losses)
    for k, w in want_losses.items():
        np.testing.assert_allclose(float(got_losses[k].detach()), float(w), atol=OUT_TOL, rtol=OUT_TOL, err_msg=k)
    assert set(got_grads) == set(want_grads)
    for group, w in want_grads.items():
        g = _flat(got_grads[group])
        assert np.isfinite(g).all(), group
        np.testing.assert_allclose(g, _flat(w), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=group)


def test_fused_training_follows_the_one_channel_head(tmp_path):
    """Three trainer steps with the flag on (3-channel thermal head) and
    with it off, the off run's parameters copied from the on run's with
    the thermal head cut to channel 0: the thermal outputs read channel 0
    only, so the runs agree step for step, every loss and metric, and the
    other two channels, with no gradient, stay where they started."""
    scene = make_synthetic_rgbt_dataset(tmp_path / "scene", num_pairs=4)
    trainers = []
    for fused in (True, False):
        method = get_method_config("thermal-nerfacto")
        tiny_hash(method.model, "float32")
        method.model.fused_modalities = fused
        method.data = method.dataparser.data = scene
        method.datamanager.train_num_rays_per_batch = 32
        method.datamanager.use_native_sampler = False
        trainer = setup_trainer(method, base_dir=tmp_path / str(fused), device="cpu")
        trainer.setup()
        trainers.append(trainer)
    wide, narrow = trainers
    head = "field_thermal.mlp_head.layers.2."
    state = {k: v[:1] if k.startswith(head) else v for k, v in wide.model.state_dict().items()}
    assert wide.model.state_dict()[head + "weight"].shape[0] == 3
    narrow.model.load_state_dict(state)
    start = {k: v.clone() for k, v in wide.model.state_dict().items() if k.startswith(head)}
    for step in range(3):
        a, b = wide.train_iteration(step), narrow.train_iteration(step)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(float(a[k]), float(b[k]), atol=1e-5, rtol=1e-4, err_msg=f"step {step} {k}")
    for k, v in start.items():
        np.testing.assert_array_equal(wide.model.state_dict()[k][1:].numpy(), v[1:].numpy(), err_msg=k)
