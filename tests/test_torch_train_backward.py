"""The training step's backward differentiates the optimized parameters only.

`make_ray_train_step` calls `loss.backward(inputs=trained_params(...))`, as
JAX's step differentiates its params alone. Two port trainers of one
configuration, built from the same seed, take one step on the same batch
and jitter: one as the trainer runs it, one with a plain `loss.backward()`
(`trained_params` patched to None). Every parameter's gradient is bitwise
equal between the two (None where the graph does not reach it), for tiny
neus-facto (the SDF's normals differentiate a detached leaf of the sample
positions), tiny thermal-nerfacto with its camera optimizers on (the
hash grids' position gradients feed the camera gradients) and tiny tensorf
at the step after a grid upsample (the upsample swaps the parameters in
the optimizer groups, so the step must differentiate the new ones).

The restricted backward forms no gradient for neus-facto's detached
positions: the step calls the hash position gradient once (the normals',
under create_graph) and its VJP with d_pos2 not asked for, where a plain
backward calls the position gradient twice and asks the VJP for d_pos2.
The port is held against itself here; the JAX parity tests
(tests/test_torch_surface_models.py, tests/test_torch_hash_slice.py and
the others) hold the step against JAX.
"""

import functools

import pytest
import torch

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.engine import trainer as trainer_module
from nerfstudio_thermal_torch.fields import sdf_field as tsdf
from nerfstudio_thermal_torch.models import base_surface_model as tbsm
from nerfstudio_thermal_torch.fields.tensorf_field import GRID_KEYS
from nerfstudio_thermal_torch.ops import encodings
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_all_methods_train import make_blender_fixture

torch.set_num_threads(1)

NUM_RAYS = 64
SDF_GRID = dict(num_levels=4, log2_hashmap_size=10, max_res=64)


def tiny(name, m):
    m.eval_num_rays_per_chunk = 64
    if name == "neus-facto":
        m.sdf_hidden_dim, m.sdf_geo_feat_dim, m.sdf_hidden_dim_color = 32, 8, 16
        m.num_proposal_samples_per_ray, m.num_neus_samples_per_ray = (12, 8), 6
        m.proposal_net_args_list = [dict(a, log2_hashmap_size=10) for a in m.proposal_net_args_list]
    elif name == "tensorf":
        m.num_uniform_samples, m.num_samples, m.resolution, m.final_resolution = 10, 4, 8, 12
        m.density_components, m.color_components, m.appearance_dim = 3, 4, 5
        m.upsampling_iters = (0,)  # 8 -> 12 after step 0
        m.compute_dtype = "float32"
    else:
        m.num_levels, m.base_res, m.max_res, m.log2_hashmap_size = 3, 4, 32, 9
        m.hidden_dim = m.hidden_dim_color = 16
        m.appearance_embed_dim = 4
        m.num_proposal_samples_per_ray, m.num_nerf_samples_per_ray = (8, 6), 4
        m.proposal_net_args_list = [
            {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 16, "use_linear": False},
            {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 32, "use_linear": True},
        ]
        m.compute_dtype = "float32"
    return m


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4, rgb_hw=(32, 40),
                                       t_hw=(32, 36))


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    return make_blender_fixture(tmp_path_factory.mktemp("blender"), n=3, hw=(12, 16))


@pytest.fixture
def small_sdf_grid(monkeypatch):
    monkeypatch.setattr(tbsm, "SDFField", functools.partial(tsdf.SDFField, **SDF_GRID))


def make_trainer(name, scene, base_dir):
    m = get_method_config(name)
    tiny(name, m.model)
    m.datamanager.train_num_rays_per_batch = NUM_RAYS
    m.datamanager.use_native_sampler = False
    m.dataparser.data = scene
    m.data = scene
    trainer = setup_trainer(m, base_dir=base_dir, device="cpu")
    trainer.setup()
    field = getattr(trainer.model.field, "grid_encoding", None)
    if field is not None:
        # the geometric init zeroes layer 0's grid rows (the grid would get
        # no gradient): perturb them and scale the table, seeded
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            kernel = trainer.model.field.geo_layers[0].kernel
            kernel.add_(torch.randn(kernel.shape, generator=gen) * 0.05)
            field.hash_table.mul_(100.0)
    return trainer


def spy(monkeypatch):
    """Record each call of the plain position gradient and of its VJP (the
    VJP's need_pos)."""
    calls = {"bwd_pos": 0, "vjp_need_pos": []}
    bwd_pos, vjp = encodings.hash_encode_bwd_pos_plain, encodings.hash_encode_bwd_pos_vjp_plain

    def counted_bwd_pos(*args, **kwargs):
        calls["bwd_pos"] += 1
        return bwd_pos(*args, **kwargs)

    def counted_vjp(*args):
        calls["vjp_need_pos"].append(args[8])
        return vjp(*args)

    monkeypatch.setattr(encodings, "hash_encode_bwd_pos_plain", counted_bwd_pos)
    monkeypatch.setattr(encodings, "hash_encode_bwd_pos_vjp_plain", counted_vjp)
    return calls


def step_grads(trainer, batch, monkeypatch, restricted):
    """One training step; each parameter's gradient (None where it has
    none) and the spy's record."""
    with monkeypatch.context() as mp:
        if not restricted:
            mp.setattr(trainer_module, "trained_params", lambda optimizers: None)
        calls = spy(mp)
        trainer._train_step(trainer.state, batch)
    return {name: (None if p.grad is None else p.grad.clone()) for name, p in trainer.model.named_parameters()}, calls


def next_batch(trainer):
    return {k: torch.as_tensor(v) for k, v in trainer.datamanager.next_train(trainer.state.step).items()}


@pytest.mark.parametrize("name", ["neus-facto", "thermal-nerfacto", "tensorf"])
def test_restricted_backward_gives_the_same_gradients(name, request, tmp_path, small_sdf_grid, monkeypatch):
    data = request.getfixturevalue("blender" if name == "tensorf" else "scene")
    runs = {}
    for restricted in (True, False):
        trainer = make_trainer(name, data, tmp_path / str(restricted))
        if name == "tensorf":
            # step 0 and the upsample after it: step 1 differentiates new grids
            step_grads(trainer, next_batch(trainer), monkeypatch, restricted)
            trainer._maybe_refine(0)
            assert trainer.model.field.resolution == 12
        runs[restricted] = step_grads(trainer, next_batch(trainer), monkeypatch, restricted)
    (got, got_calls), (want, want_calls) = runs[True], runs[False]
    assert set(got) == set(want)
    reached = 0
    for key, w in want.items():
        a = got[key]
        assert (a is None) == (w is None), key
        if w is not None:
            assert torch.equal(a, w), (key, float((a - w).abs().max()))
            reached += bool(w.abs().max() > 0)
    assert reached > len(want) // 2
    if name == "tensorf":
        assert all(got[f"field.{k}"] is not None and got[f"field.{k}"].shape[-2] == 12 for k in GRID_KEYS)
    elif name == "thermal-nerfacto":
        assert any(k.startswith("camera_optimizer") and got[k] is not None and bool(got[k].abs().max() > 0)
                   for k in got), sorted(got)
    else:
        assert got["field.grid_encoding.hash_table"].abs().max() > 0
        # the normals' position gradient only; the VJP forms dg and d_table
        assert got_calls == {"bwd_pos": 1, "vjp_need_pos": [False]}
        # a plain backward also differentiates the detached sample positions
        assert want_calls == {"bwd_pos": 2, "vjp_need_pos": [True]}
