"""ns-export and ns-texture on a surface method: the port's commands
against the JAX package's on a tiny neus-facto run, on the CPU.

Each package writes a run directory of the same tiny neus-facto (`tiny`
and the small SDF grid of tests/test_torch_surface_models.py, the scene
of tests/test_torch_eval.py; the port's model carries the JAX parameters
through `load_jax_params`). Its geometric init makes the SDF a sphere, so
the level-0 isosurface exists. `marching-cubes` meshes the model's
`sdf_fn` (no fallback), `texture` bakes that mesh with the normals'
position gradient on the render path, and ns-texture, `tsdf` and
`cameras` run as on thermal-nerfacto; `pointcloud` and `poisson` need the
"expected_depth" output, which the surface models do not render, and
raise KeyError in both packages. Tolerances are those of
tests/test_torch_exporters.py; the SDF grid: 1e-5 absolute (values
within ~1 of zero).
"""

import functools

import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.exporter import exporter_utils as jeu
from nerfstudio_thermal_tpu.exporter import marching_cubes as jmc
from nerfstudio_thermal_tpu.fields import sdf_field as jsdf
from nerfstudio_thermal_tpu.models import base_surface_model as jbsm
from nerfstudio_thermal_tpu.scripts import exporter as jax_export
from nerfstudio_thermal_tpu.scripts import texture as jax_texture

from nerfstudio_thermal_torch.configs.method_configs import get_method_config
from nerfstudio_thermal_torch.exporter import exporter_utils as eu
from nerfstudio_thermal_torch.exporter import marching_cubes as mc
from nerfstudio_thermal_torch.fields import sdf_field as tsdf
from nerfstudio_thermal_torch.models import base_surface_model as tbsm
from nerfstudio_thermal_torch.scripts import exporter, texture
from tests.test_torch_exporters import (
    CHUNK,
    assert_meshes_close,
    assert_textures_close,
    run_both,
    scene,  # noqa: F401  (the module's scene fixture)
    shared_jax_eval_setup,  # noqa: F401  (the module's memoized JAX eval_setup)
    write_runs,
)
from tests.test_torch_surface_models import SDF_GRID, method

torch.set_num_threads(1)

SDF_TOL = 1e-5


def surface_method(get, scene):
    m = method(get, "neus-facto", scene)
    m.model.eval_num_rays_per_chunk = CHUNK
    m.dataparser.train_split_fraction = 0.5  # eval cameras for pointcloud
    return m


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory, shared_jax_eval_setup):  # noqa: F811
    """The neus-facto runs, with both packages' SDF fields on the small
    grid while the module's tests reload them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbsm, "SDFField", functools.partial(jsdf.SDFField, **SDF_GRID))
        mp.setattr(tbsm, "SDFField", functools.partial(tsdf.SDFField, **SDF_GRID))
        yield write_runs(lambda: surface_method(jax_method_config, scene),
                         lambda: surface_method(get_method_config, scene), tmp_path_factory.mktemp("neus-facto"),
                         shared_jax_eval_setup)


def test_sdf_grid_and_marching_cubes_match_jax(runs, tmp_path, capsys):
    jax_model, params, model = runs[2:]
    box = ((-1.0,) * 3, (1.0,) * 3)
    want, _, _ = jmc.evaluate_sdf_grid(lambda p: np.asarray(jax_model.sdf_fn(params, p)).reshape(-1), 24, *box)
    got, _, _ = mc.evaluate_sdf_grid(exporter.field_callable(model)[0], 24, *box)
    np.testing.assert_allclose(got, want, atol=SDF_TOL, rtol=0)
    assert got.min() < 0 < got.max()
    want_dir, got_dir = run_both(runs, tmp_path, ["marching-cubes", "--resolution", "24"])
    assert "retrying" not in capsys.readouterr().out
    name = "sdf_marching_cubes_mesh.ply"
    assert_meshes_close(eu.read_ply_mesh(got_dir / name), jeu.read_ply_mesh(want_dir / name))


def test_texture_export_matches_jax(runs, tmp_path):
    want, got = run_both(runs, tmp_path, ["texture", "--resolution", "12", "--px-per-uv-triangle", "4"])
    assert_textures_close(got, want)


def test_ns_texture_matches_jax(runs, tmp_path):
    verts, faces, normals = mc.generate_mesh_with_multires_marching_cubes(
        lambda p: np.linalg.norm(p, axis=-1) - 0.6, resolution=12)
    mesh = tmp_path / "sphere.ply"
    eu.write_ply_mesh(mesh, verts, faces, normals=normals)
    want, got = run_both(runs, tmp_path, ["--input-mesh-filename", str(mesh), "--px-per-uv-triangle", "3"],
                         jax_main=jax_texture.main, port_main=texture.main)
    assert (got / "mesh.obj").read_bytes() == (want / "mesh.obj").read_bytes()
    assert_textures_close(got, want)


def test_tsdf_and_cameras_match_jax(runs, tmp_path):
    want, got = run_both(runs, tmp_path / "tsdf", ["tsdf", "--resolution", "24", "--downscale-factor", "4"])
    assert_meshes_close(eu.read_ply_mesh(got / "tsdf_mesh.ply"), jeu.read_ply_mesh(want / "tsdf_mesh.ply"))
    want, got = run_both(runs, tmp_path / "cameras", ["cameras"])
    assert (got / "cameras.json").read_bytes() == (want / "cameras.json").read_bytes()


def test_pointcloud_needs_expected_depth_in_both(runs, tmp_path):
    jax_config, port_config = runs[:2]
    with pytest.raises(KeyError, match="expected_depth"):
        jax_export.main(["pointcloud", "--load-config", str(jax_config), "--output-dir", str(tmp_path / "j")])
    with pytest.raises(KeyError, match="expected_depth"):
        exporter.main(["pointcloud", "--load-config", str(port_config), "--output-dir", str(tmp_path / "p")],
                      device="cpu")
