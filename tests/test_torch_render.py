"""The port's render path as a whole against the JAX package, on the CPU.

A tiny thermal-nerfacto-tpu (4 x 128 base MLP, so the fused-MLP gate still
routes JAX through the Pallas kernel and the port through the fused-MLP
wrapper's plain version; few samples) renders a 8 x 7 image in chunks of
16 rays, the last chunk padded, through each package's
`get_outputs_for_camera`. The port's model gets the JAX model's parameters
through the carry-over function. The camera has nonzero distortion.

Tolerances on every image output:
- f32 compute: 1e-4 (measured ~5e-7): the same arithmetic up to sum order
  in prefix sums, matmuls and sorted lookups.
- bf16 compute: 2e-2 (measured ~4e-3, one bf16 step at 0.5): the MLPs
  round to bf16 per layer and the two frameworks can round one value to
  neighbouring bf16 numbers, which moves colours by about one bf16 step.
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
from nerfstudio_thermal_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)

AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
W, H = 8, 7


def tiny(model_config, dtype):
    m = model_config
    m.freq_num_layers = 4
    m.freq_hidden_dim = 128
    m.freq_num_frequencies = 4
    m.num_proposal_samples_per_ray = (8, 6)
    m.num_nerf_samples_per_ray = 4
    m.eval_num_rays_per_chunk = 16
    m.appearance_embed_dim = 4
    m.hidden_dim_color = 16
    m.proposal_net_args_list = [
        {"encoding": "freq", "hidden_dim": 16, "num_layers": 2, "num_frequencies": 3},
        {"encoding": "freq", "hidden_dim": 16, "num_layers": 2, "num_frequencies": 4},
    ]
    m.compute_dtype = dtype
    return m


def camera_arrays():
    c2w = np.eye(4, dtype=np.float32)[:3][None].copy()
    c2w[:, 0, 3] = 2.0
    return dict(
        camera_to_worlds=c2w,
        fx=np.full((1,), 9.0, np.float32), fy=np.full((1,), 10.0, np.float32),
        cx=np.full((1,), W / 2, np.float32), cy=np.full((1,), H / 2, np.float32),
        width=np.full((1,), W, np.int32), height=np.full((1,), H, np.int32),
        distortion_params=np.array([[0.05, -0.01, 0.002, 0.0, 0.001, -0.002]], np.float32),
        camera_type=np.ones((1,), np.int32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_matches_jax(dtype):
    jcfg = tiny(jax_method_config("thermal-nerfacto-tpu").model, dtype)
    assert jcfg.use_pallas and jcfg.field_encoding == "freq"
    meta = {"is_thermal": [0, 1]}
    jmodel = JModel(jcfg, AABB, num_train_data=2, metadata=meta)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    model = ThermalNerfactoModel(
        tiny(get_method_config("thermal-nerfacto-tpu").model, dtype), AABB, 2, meta, device="cpu"
    )
    assert model.field.mlp_base_net._fusable()
    load_jax_params(model, jax.tree.map(np.asarray, params))

    cams = camera_arrays()
    want = jmodel.get_outputs_for_camera(params, JCameras(**{k: jnp.asarray(v) for k, v in cams.items()}), 0)
    before = fm.fused_mlp.launches
    got = model.get_outputs_for_camera(Cameras(**{k: torch.as_tensor(v) for k, v in cams.items()}), 0)
    assert fm.fused_mlp.launches == before  # the CPU runs the plain version

    assert set(got) == set(want)
    for k in ("rgb", "rgb_thermal", "accumulation", "depth", "removal", "removal_thermal"):
        assert k in got
    for k, w in want.items():
        assert got[k].shape == (H, W, w.shape[-1]), k
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], np.asarray(w), atol=TOL[dtype], rtol=TOL[dtype], err_msg=k)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without device= the model goes to CUDA; with CUDA absent it raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny(get_method_config("thermal-nerfacto-tpu").model, "float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ThermalNerfactoModel(cfg, AABB, 2, {"is_thermal": [0, 1]})


def test_precision_pinned_by_entry_points():
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = tiny(get_method_config("thermal-nerfacto-tpu").model, "float32")
    ThermalNerfactoModel(cfg, AABB, 2, {"is_thermal": [0, 1]}, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert torch.get_float32_matmul_precision() == "highest"


def test_unported_paths_raise(tmp_path):
    """What the port does not carry yet raises and names its slice or says
    it is not ported: a shared proposal network, the shared and rgb_only
    density modes, and the trainer's eval cadences."""
    from tests.fixtures import make_synthetic_rgbt_dataset
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer

    cfg = tiny(get_method_config("thermal-nerfacto-tpu").model, "float32")
    cfg.use_same_proposal_network = True
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ThermalNerfactoModel(cfg, AABB, 2, device="cpu")
    for mode in ("shared", "rgb_only"):
        cfg = tiny(get_method_config("thermal-nerfacto-tpu").model, "float32")
        cfg.density_mode = mode
        with pytest.raises(NotImplementedError, match="later slice"):
            ThermalNerfactoModel(cfg, AABB, 2, {"is_thermal": [0, 1]}, device="cpu")
    with pytest.raises(KeyError):
        get_method_config("no-such-method")

    method = get_method_config("thermal-nerfacto-tpu")
    tiny(method.model, "float32")
    method.data = make_synthetic_rgbt_dataset(tmp_path / "scene", num_pairs=4)
    method.dataparser.eval_mode = "all"  # eval images exist
    method.datamanager.train_num_rays_per_batch = 16
    method.trainer.max_num_iterations = 3
    method.trainer.steps_per_eval_batch = 2
    trainer = setup_trainer(method, base_dir=tmp_path / "run", device="cpu")
    trainer.setup()
    with pytest.raises(NotImplementedError, match="eval-surface slice"):
        trainer.train()


@torch.no_grad()
def test_seeded_init_follows_jax_initializers():
    """Same seed -> same weights; lecun-normal std, the base MLP's last layer
    scaled by freq_final_init_scale, zero biases, N(0, 1) appearance table,
    zero camera adjustments."""
    cfg = get_method_config("thermal-nerfacto-tpu").model
    a = ThermalNerfactoModel(cfg, AABB, 2, {"is_thermal": [0, 1]}, device="cpu", seed=3)
    b = ThermalNerfactoModel(cfg, AABB, 2, {"is_thermal": [0, 1]}, device="cpu", seed=3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    layers = a.field.mlp_base_net.layers
    w1 = layers[1].weight
    assert abs(w1.std().item() - (1 / 256) ** 0.5) < 0.1 * (1 / 256) ** 0.5
    assert w1.abs().max().item() <= 2 * (1 / 256) ** 0.5 / 0.87962566103423978 + 1e-6
    assert abs(layers[-1].weight.std().item() - 0.1 * (1 / 256) ** 0.5) < 0.02 * (1 / 256) ** 0.5
    assert all(float(layer.bias.abs().max()) == 0.0 for layer in layers)
    emb = a.field.embedding_appearance
    assert emb.shape == (2, 32)
    assert float(a.camera_optimizer.pose_adjustment.abs().max()) == 0.0
