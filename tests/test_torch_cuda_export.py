"""The export path's torch parts on the card against the CPU.

These tests need a CUDA device; without one every test skips with a
reason. The module imports no JAX, so it runs on a machine with a card
and no JAX installation:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_export.py

- The TSDF update of seeded depth and colour maps: values and colours
  within 1e-5 at every voxel off a decision's edge
  (tests/torch_export_checks.py; f32 products in another order may pick
  the other pixel or side there), and get_mesh of the card's volume is
  the CPU's mesh of the same arrays.
- The Poisson solve (cuFFT) of one splat: chi within relative L2 1e-5 of
  the CPU's, and the frequencies equal.
- evaluate_sdf_grid of a full-width neus-facto field (its weights and
  hash table perturbed from the geometric init, whose zeroed rows would
  hide the grid) through the exporter's field callable: the card's grid
  within 1e-4 of the CPU's plain path (f32 both), with one row-8 launch a
  slab and no other kernel.
"""

import copy

import numpy as np
import pytest
import torch

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, resolve_model_class
from nerfstudio_thermal_torch.exporter import marching_cubes as mc
from nerfstudio_thermal_torch.exporter import poisson
from nerfstudio_thermal_torch.exporter import tsdf_utils
from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th
from nerfstudio_thermal_torch.scripts import exporter
from nerfstudio_thermal_torch.utils.precision import pin_precision
from tests.torch_export_checks import assert_volumes_match, host, tsdf_inputs

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

CHI_TOL = 1e-5
SDF_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_precision()
    return torch.device("cuda")


@pytest.mark.parametrize("dims", [(64, 64, 64), (48, 80, 32)])
def test_tsdf_update_on_the_card_matches_the_cpu(cuda, dims):
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    c2w, K, depth, color = tsdf_inputs(seed=dims[1], b=6, h=48, w=64)
    K = K * np.array([[2], [2], [1]], np.float32)
    volumes = {}
    for device in ("cpu", cuda):
        t = tsdf_utils.TSDF.from_aabb(aabb, dims, device=device)
        for i in range(len(c2w)):
            t.integrate_tsdf(c2w[i:i + 1], K[i:i + 1], depth[i][None], color_images=color[i][None])
        volumes[str(device)] = t
    got, want = volumes["cuda"], volumes["cpu"]
    assert got.values.device.type == "cuda"
    assert_volumes_match(got, want, c2w, K, depth)
    got.values, got.weights, got.colors = (getattr(want, k).clone() for k in ("values", "weights", "colors"))
    for g, w in zip(got.get_mesh(), want.get_mesh()):
        np.testing.assert_array_equal(g, w)


def test_poisson_solve_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    d = rng.standard_normal((20000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    points = (0.6 * d).astype(np.float32)
    h = np.float32(1.5 / 127)
    V = np.zeros((128, 128, 128, 3), np.float32)
    poisson._splat_trilinear(V, (points + 0.75) / h, d.astype(np.float32))
    np.testing.assert_array_equal(host(poisson.fftfreq(128, cuda)), host(poisson.fftfreq(128, "cpu")))
    want = poisson.solve_indicator(V, h, 1.0, "cpu")
    got = poisson.solve_indicator(V, h, 1.0, cuda)
    assert np.linalg.norm(got - want) <= CHI_TOL * np.linalg.norm(want)
    verts, faces, normals = poisson.poisson_reconstruct(points, d, cuda, resolution=64)
    assert len(faces) > 0 and np.isfinite(verts).all()
    assert np.abs(np.linalg.norm(verts, axis=-1) - 0.6).max() < 0.1


def test_sdf_grid_on_the_card_matches_the_plain_path(cuda):
    config = get_method_config("neus-facto").model
    aabb = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    cpu = resolve_model_class(config)(config, aabb, num_train_data=2, metadata={}, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in cpu.field.named_parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
            if "hash_table" in name:
                p.mul_(100.0)
    card = copy.deepcopy(cpu).to(cuda)
    want, _, _ = mc.evaluate_sdf_grid(exporter.field_callable(cpu)[0], 72, (-1.0,) * 3, (1.0,) * 3)
    th.hash_encode_fwd.launches = 0
    got, _, _ = mc.evaluate_sdf_grid(exporter.field_callable(card)[0], 72, (-1.0,) * 3, (1.0,) * 3)
    assert th.hash_encode_fwd.launches == -(-72 // (262144 // 72**2))
    assert np.isfinite(got).all() and got.std() > 1e-3
    np.testing.assert_allclose(got, want, atol=SDF_TOL, rtol=0)
