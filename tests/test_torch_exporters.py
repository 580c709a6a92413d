"""ns-export and ns-texture, the port's `exporter/` and scripts against the
JAX package's, on the CPU.

The copied numpy modules are held to the JAX package's outputs on seeded
inputs: marching cubes (a sphere and a random grid), the PLY and OBJ
writers (bytes), the texel mapping. The torch parts on the same inputs:
the TSDF update and the Poisson solve. Then a tiny f32 thermal-nerfacto
run (`tiny_hash` widths, the scene of tests/test_torch_eval.py) is written
as a run directory by each package, the port's model carrying the JAX
parameters through `load_jax_params`; its hash tables are scaled by
HASH_SCALE so that the density varies across the box (at its initial
U(-1e-3, 1e-3) the field is flat to ~1e-4 and a marching-cubes vertex
moves by ~1e-3 of a cell for a 1e-7 difference in density). Each
package's `main` then runs every mode and ns-texture, and the files are
compared (tests/test_torch_export_surface.py does the same for
neus-facto).

Tolerances:
- marching cubes, the writers, the texel mapping, the PLY / OBJ of the
  same mesh, cameras.json: exact (bytes or arrays equal);
- the TSDF volume from the same maps and cameras: values and colours
  within 1e-5 at every voxel whose projection (in float64) lies farther
  than BORDER_EPS (tests/torch_export_checks.py) from each of its decisions' edges: a pixel boundary or
  the image's border, z = 0, the truncation (at least BORDER_SHARE of the
  touched voxels are compared). At the borderline voxels (cameras that
  look at the grid's centre put whole planes of voxels on a pixel
  boundary) the packages' f32 products,
  which round differently, may pick the other pixel or side; the mesh
  export's volume is held the same way;
- the Poisson indicator chi: relative L2 1e-5 (two FFT libraries); the
  port's marching cubes of JAX's chi at JAX's level: JAX's mesh;
- point clouds: the same count, points within 1e-5, 8-bit colours
  within one level; the density grid: relative 1e-5;
- exported meshes (each package's own grid or volume): vertex and face
  counts within MESH_COUNT, and at least MESH_NEAR of each mesh's vertices
  within MESH_TOL (world units, ~1/60 of a 24^3 cell) of the other's;
- texture.png: the port's (decoded by data/datasets.py:decode_png) within
  one 8-bit level of JAX's (decoded by Pillow); OBJ numbers within 1e-5.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import cKDTree

from nerfstudio_thermal_tpu.configs.method_configs import method_configs as JAX_METHODS
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.method_configs import resolve_model_class as jax_resolve_model_class
from nerfstudio_thermal_tpu.configs.serialization import save_config as jax_save_config
from nerfstudio_thermal_tpu.exporter import exporter_utils as jeu
from nerfstudio_thermal_tpu.exporter import marching_cubes as jmc
from nerfstudio_thermal_tpu.exporter import poisson as jpoisson
from nerfstudio_thermal_tpu.exporter import texture_utils as jtex
from nerfstudio_thermal_tpu.exporter import tsdf_utils as jtsdf
from nerfstudio_thermal_tpu.scripts import exporter as jax_export
from nerfstudio_thermal_tpu.scripts import texture as jax_texture
from nerfstudio_thermal_tpu.utils import eval_utils as jax_eval_utils

from nerfstudio_thermal_torch.configs.method_configs import _METHODS, get_method_config, resolve_model_class
from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
from nerfstudio_thermal_torch.configs.serialization import save_config
from nerfstudio_thermal_torch.data.datasets import decode_png
from nerfstudio_thermal_torch.exporter import exporter_utils as eu
from nerfstudio_thermal_torch.exporter import marching_cubes as mc
from nerfstudio_thermal_torch.exporter import poisson
from nerfstudio_thermal_torch.exporter import texture_utils as tex
from nerfstudio_thermal_torch.exporter import tsdf_utils
from nerfstudio_thermal_torch.scripts import exporter, texture
from nerfstudio_thermal_torch.utils.jax_params import load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_eval import RGB_HW, T_HW, _method, jax_trainer_setup
from tests.torch_export_checks import VALUE_TOL, assert_volumes_match, tsdf_inputs

torch.set_num_threads(1)

CHI_TOL = 1e-5
GRID_TOL = 1e-5
MESH_TOL = 1.5e-3
MESH_NEAR = 0.99
MESH_COUNT = 0.01
HASH_SCALE = 1000.0
CHUNK = 4096  # rays a render chunk: the same numbers as any chunk, fewer eager launches on the CPU


# ---- the copied numpy modules --------------------------------------------------


def sphere_grid(r=20, radius=0.6):
    xs = np.linspace(-1, 1, r, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    return np.sqrt(gx**2 + gy**2 + gz**2) - radius


@pytest.mark.parametrize("kind", ["sphere", "random"])
def test_marching_cubes_equals_jax(kind):
    grid = sphere_grid() if kind == "sphere" else np.random.default_rng(0).standard_normal((9, 11, 10)).astype(
        np.float32)
    kw = dict(origin=np.array([-1, -1, -1], np.float32), spacing=np.full(3, 2 / 19, np.float32))
    for direction in ("ascent", "descent"):
        want = jmc.marching_cubes(grid, level=0.1, gradient_direction=direction, **kw)
        got = mc.marching_cubes(grid, level=0.1, gradient_direction=direction, **kw)
        assert len(want[1]) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    sdf = lambda p: np.linalg.norm(p, axis=-1) - 0.5  # noqa: E731
    for g, w in zip(mc.generate_mesh_with_multires_marching_cubes(sdf, resolution=18),
                    jmc.generate_mesh_with_multires_marching_cubes(sdf, resolution=18)):
        np.testing.assert_array_equal(g, w)


def test_writers_equal_jax_bytes(tmp_path):
    rng = np.random.default_rng(1)
    pts, cols, nrm = (rng.standard_normal((50, 3)).astype(np.float32) for _ in range(3))
    cols = np.abs(cols) / 2
    faces = rng.integers(0, 50, (30, 3))
    uv = rng.random((30, 3, 2)).astype(np.float32)
    for name, (jf, pf), args in (
        ("cloud.ply", (jeu.write_ply, eu.write_ply), (pts, cols, nrm)),
        ("cloud_plain.ply", (jeu.write_ply, eu.write_ply), (pts,)),
        ("mesh.ply", (jeu.write_ply_mesh, eu.write_ply_mesh), (pts, faces, nrm, cols)),
        ("mesh_plain.ply", (jeu.write_ply_mesh, eu.write_ply_mesh), (pts, faces)),
        ("mesh.obj", (jtex.write_obj, tex.write_obj), (pts, faces, uv, "mesh.mtl")),
        ("mesh_plain.obj", (jtex.write_obj, tex.write_obj), (pts, faces)),
    ):
        for writer, pkg in ((jf, "jax"), (pf, "port")):
            (tmp_path / pkg).mkdir(exist_ok=True)  # the OBJ writer makes no directory
            writer(tmp_path / pkg / name, *args)
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    p, c = eu.read_ply(tmp_path / "port" / "cloud.ply")
    np.testing.assert_array_equal(p, pts)
    np.testing.assert_array_equal(c, (np.clip(cols, 0, 1) * 255).astype(np.uint8) / 255.0)
    for g, w in zip(eu.read_ply(tmp_path / "port" / "cloud.ply"), jeu.read_ply(tmp_path / "jax" / "cloud.ply")):
        np.testing.assert_array_equal(g, w)
    v, f = eu.read_ply_mesh(tmp_path / "port" / "mesh.ply")
    np.testing.assert_array_equal(v, pts)
    np.testing.assert_array_equal(f, faces)
    for g, w in zip(eu.read_ply_mesh(tmp_path / "port" / "mesh_plain.ply"),
                    jeu.read_ply_mesh(tmp_path / "jax" / "mesh_plain.ply")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("num_faces,px", [(1, 8), (7, 4), (50, 3)])
def test_texel_mapping_equals_jax(num_faces, px):
    got, want = tex.unwrap_mesh_per_face(num_faces, px), jtex.unwrap_mesh_per_face(num_faces, px)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for g, w in zip(tex._texel_to_face(*got[1:3], got[3], px, num_faces),
                    jtex._texel_to_face(*want[1:3], want[3], px, num_faces)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="empty mesh"):
        tex.unwrap_mesh_per_face(0)


# ---- the torch parts on the same inputs -----------------------------------------


@pytest.mark.parametrize("dims", [(24, 24, 24), (20, 28, 16)])
def test_tsdf_volume_matches_jax(dims):
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    want = jtsdf.TSDF.from_aabb(aabb, dims)
    got = tsdf_utils.TSDF.from_aabb(aabb, dims, device="cpu")
    c2w, K, depth, color = tsdf_inputs()
    want.integrate_tsdf(c2w, K, depth, color)
    got.integrate_tsdf(c2w, K, depth, color)
    assert_volumes_match(got, want, c2w, K, depth)
    # equal volumes give equal meshes
    got.values, got.weights, got.colors = (torch.tensor(getattr(want, k)) for k in ("values", "weights", "colors"))
    for g, w in zip(got.get_mesh(), want.get_mesh()):
        np.testing.assert_array_equal(g, w)


def sphere_samples(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (0.7 * d + [0.1, -0.2, 0.05]).astype(np.float32), d.astype(np.float32)


def test_poisson_matches_jax(monkeypatch):
    """chi against JAX's (captured where JAX hands it to marching cubes),
    the port's extractor on JAX's chi, and the two meshes."""
    seen = {}
    inner = jmc.marching_cubes

    def recording(grid, level, **kw):
        seen.update(chi=np.array(grid), level=level, kw=kw)
        return inner(grid, level=level, **kw)

    monkeypatch.setattr(jmc, "marching_cubes", recording)
    points, normals = sphere_samples()
    want = jpoisson.poisson_reconstruct(points, normals, resolution=32)
    got = poisson.poisson_reconstruct(points, normals, "cpu", resolution=32)

    # the port's chi on the same splat
    pts = np.asarray(points, np.float32)
    bb_min, bb_max = pts.min(0), pts.max(0)
    extent = (bb_max - bb_min).max() * (1 + 2 * 0.1)
    origin = (bb_min + bb_max) / 2 - extent / 2
    h = extent / 31
    V = np.zeros((32, 32, 32, 3), np.float32)
    poisson._splat_trilinear(V, (pts - origin) / h, normals / np.linalg.norm(normals, axis=-1, keepdims=True))
    chi = poisson.solve_indicator(V, h, 1.0, "cpu")
    assert np.linalg.norm(chi - seen["chi"]) <= CHI_TOL * np.linalg.norm(seen["chi"])
    np.testing.assert_array_equal(poisson.fftfreq(32, "cpu").numpy(), np.asarray(jnp.fft.fftfreq(32)))

    for g, w in zip(mc.marching_cubes(seen["chi"], level=seen["level"], **seen["kw"]), want):
        np.testing.assert_array_equal(g, w)
    assert_meshes_close(got[:2], want[:2])


def assert_meshes_close(got, want, tol=MESH_TOL):
    """(vertices, faces) pairs: counts within MESH_COUNT, and MESH_NEAR of
    each mesh's vertices within tol of the other's."""
    (gv, gf), (wv, wf) = got, want
    assert len(wf) > 0 and len(gf) > 0
    assert abs(len(gv) - len(wv)) <= MESH_COUNT * len(wv), (len(gv), len(wv))
    assert abs(len(gf) - len(wf)) <= MESH_COUNT * len(wf), (len(gf), len(wf))
    assert gf.max() < len(gv)
    for a, b in ((gv, wv), (wv, gv)):
        dist, _ = cKDTree(b).query(a)
        assert (dist <= tol).mean() >= MESH_NEAR, (float((dist <= tol).mean()), float(dist.max()))


def test_density_and_sdf_fns_agree_with_jax():
    """The marching-cubes exporter meshes `sdf_fn` where a model has it,
    else `density_fn` (instant-ngp, vanilla-nerf, mipnerf and tensorf have
    neither in JAX, and fail there as here)."""
    assert set(_METHODS) <= set(JAX_METHODS)
    for name in _METHODS:
        cls = resolve_model_class(get_method_config(name).model)
        jax_cls = jax_resolve_model_class(jax_method_config(name).model)
        for attr in ("density_fn", "sdf_fn"):
            assert hasattr(cls, attr) == hasattr(jax_cls, attr), (name, attr)


# ---- the commands on a tiny thermal-nerfacto run --------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4, rgb_hw=RGB_HW, t_hw=T_HW)


def scale_hash_tables(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * HASH_SCALE if "hash_table" in jax.tree_util.keystr(path) else v, params)


def write_runs(get_jax, get_port, root, jax_runs, params_fn=None):
    """(JAX run's config.yml, the port's config.yml, the JAX model and its
    params, the port's model) holding the same parameters. The JAX trainer
    that wrote its run is the one JAX's commands get (`jax_runs`, the
    memo of shared_jax_eval_setup): it holds the checkpoint's parameters,
    so a reload would only compile them again."""
    jax_method = get_jax()
    jax_trainer = jax_trainer_setup(jax_method, root / "jax")
    if params_fn is not None:
        jax_trainer.state = jax_trainer.state.replace(params=params_fn(jax_trainer.state.params))
    jax_save_config(jax_method, root / "jax" / "config.yml")
    jax_trainer.save_checkpoint(0)
    method = get_port()
    trainer = setup_trainer(method, base_dir=root / "port", device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, jax_trainer.host_params()))
    trainer.setup()
    save_config(method, root / "port" / "config.yml")
    trainer.save_checkpoint(0)
    jax_runs[str(root / "jax" / "config.yml"), None] = (jax_method, jax_trainer, jax_trainer.host_params())
    return (root / "jax" / "config.yml", root / "port" / "config.yml", jax_trainer.pipeline.model,
            jax_trainer.host_params(), trainer.model)


@pytest.fixture(scope="module")
def shared_jax_eval_setup():
    """JAX's ns-export and ns-texture reload a run once per module: its
    eval_setup, memoized by config path, hands every command the same
    trainer (the exporters only read it), so its jitted renders compile
    once. Yields the memo. The port's commands reload their run on every
    call."""
    inner, memo = jax_eval_utils.eval_setup, {}

    def eval_setup(config_path, load_step=None):
        key = (str(config_path), load_step)
        if key not in memo:
            memo[key] = inner(config_path, load_step)
        return memo[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_eval_utils, "eval_setup", eval_setup)
        yield memo


def thermal_method(get, scene):
    method = _method(get, "thermal-nerfacto", scene)
    method.model.eval_num_rays_per_chunk = CHUNK
    return method


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory, shared_jax_eval_setup):
    return write_runs(lambda: thermal_method(jax_method_config, scene), lambda: thermal_method(get_method_config, scene),
                      tmp_path_factory.mktemp("thermal-nerfacto"), shared_jax_eval_setup, scale_hash_tables)


def run_both(runs, tmp_path, args, jax_main=jax_export.main, port_main=exporter.main):
    """Each package's command on its run; (JAX's output dir, the port's)."""
    jax_config, port_config = runs[:2]
    mode = [args[0]] if args and not args[0].startswith("--") else []
    rest = args[len(mode):]
    assert jax_main([*mode, "--load-config", str(jax_config), "--output-dir", str(tmp_path / "jax"), *rest]) == 0
    assert port_main([*mode, "--load-config", str(port_config), "--output-dir", str(tmp_path / "port"), *rest],
                     device="cpu") == 0
    want, got = tmp_path / "jax", tmp_path / "port"
    assert sorted(p.name for p in got.iterdir()) == sorted(p.name for p in want.iterdir())
    return want, got


def assert_clouds_close(got_path, want_path):
    (gp, gc), (wp, wc) = eu.read_ply(got_path), jeu.read_ply(want_path)
    assert len(gp) == len(wp) > 0
    np.testing.assert_allclose(gp, wp, atol=VALUE_TOL, rtol=0)
    assert np.abs(np.round(gc * 255) - np.round(wc * 255)).max() <= 1


def assert_textures_close(got_dir, want_dir):
    assert (got_dir / "mesh.mtl").read_bytes() == (want_dir / "mesh.mtl").read_bytes()
    g, w = decode_png(got_dir / "texture.png"), np.asarray(Image.open(want_dir / "texture.png"))
    assert g.shape == w.shape and g.dtype == np.uint8
    assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    got_lines, want_lines = ((d / "mesh.obj").read_text().splitlines() for d in (got_dir, want_dir))
    assert len(got_lines) == len(want_lines)
    for gl, wl in zip(got_lines, want_lines):
        gt, wt = gl.split(), wl.split()
        assert gt[0] == wt[0] and len(gt) == len(wt), (gl, wl)
        if gt[0] in ("v", "vt"):
            np.testing.assert_allclose(np.float64(gt[1:]), np.float64(wt[1:]), atol=VALUE_TOL, rtol=0)
        else:
            assert gl == wl


def test_cameras_json_equals_jax(runs, tmp_path):
    want, got = run_both(runs, tmp_path, ["cameras"])
    assert (got / "cameras.json").read_bytes() == (want / "cameras.json").read_bytes()
    frames = json.loads((got / "cameras.json").read_text())
    assert len(frames) == 4 and set(frames[0]) == {"camera_to_world", "fx", "fy", "cx", "cy", "width", "height"}


@pytest.mark.parametrize("args", [["--min-accumulation", "0.0"], ["--use-thermal-color", "true", "--min-accumulation",
                                                                  "0.0"], []], ids=["rgb", "thermal-color", "default"])
def test_pointcloud_matches_jax(runs, tmp_path, args):
    want, got = run_both(runs, tmp_path, ["pointcloud", *args])
    assert_clouds_close(got / "point_cloud.ply", want / "point_cloud.ply")


def test_thermal_colour_is_rgb_thermal(runs, tmp_path):
    """--use-thermal-color colours the points by the thermal render (grey)
    and not by the RGB one."""
    _, port_config = runs[:2]
    for flag, name in (("false", "rgb"), ("true", "thermal")):
        assert exporter.main(["pointcloud", "--load-config", str(port_config), "--output-dir", str(tmp_path / name),
                              "--min-accumulation", "0.0", "--use-thermal-color", flag], device="cpu") == 0
    _, rgb = eu.read_ply(tmp_path / "rgb" / "point_cloud.ply")
    _, thermal = eu.read_ply(tmp_path / "thermal" / "point_cloud.ply")
    assert np.array_equal(thermal[:, 0], thermal[:, 1]) and np.array_equal(thermal[:, 1], thermal[:, 2])
    assert not np.array_equal(rgb, thermal)


def test_tsdf_mesh_matches_jax(runs, tmp_path, monkeypatch):
    """The volumes (each package's own renders) as the unit test holds
    them, then the meshes: every vertex whose cell has no differing voxel
    lies within MESH_TOL of a vertex of the other mesh."""
    seen = {}
    for cls, key in ((jtsdf.TSDF, "jax"), (tsdf_utils.TSDF, "port")):
        def get_mesh(self, inner=cls.get_mesh, key=key):
            seen[key] = self
            return inner(self)

        monkeypatch.setattr(cls, "get_mesh", get_mesh)

    def renders(*args, inner=jeu.render_cameras_for_export, **kw):
        seen["renders"] = inner(*args, **kw)
        return seen["renders"]

    monkeypatch.setattr(jeu, "render_cameras_for_export", renders)
    want, got = run_both(runs, tmp_path, ["tsdf", "--resolution", "24", "--downscale-factor", "4"])
    _, depths, c2w, K = seen["renders"]
    same = assert_volumes_match(seen["port"], seen["jax"], c2w, K, depths)
    meshes = eu.read_ply_mesh(got / "tsdf_mesh.ply"), jeu.read_ply_mesh(want / "tsdf_mesh.ply")
    assert abs(len(meshes[0][1]) - len(meshes[1][1])) <= MESH_COUNT * len(meshes[1][1])
    for (a, _), (b, _) in (meshes, meshes[::-1]):
        clear = clear_vertices(a, seen["jax"], same)
        assert clear.mean() >= 0.9, clear.mean()
        dist, _ = cKDTree(b).query(a[clear])
        assert dist.max() <= MESH_TOL, dist.max()


def clear_vertices(verts, tsdf, same):
    """Vertices whose cell's eight voxels all agree between the packages."""
    idx = (verts - tsdf.origin) / tsdf.voxel_size
    lo = np.clip(np.floor(idx).astype(int), 0, np.array(same.shape) - 2)
    clear = np.ones(len(verts), bool)
    for corner in itertools.product((0, 1), repeat=3):
        c = lo + corner
        clear &= same[c[:, 0], c[:, 1], c[:, 2]]
    return clear


def test_poisson_mesh_matches_jax(runs, tmp_path):
    want, got = run_both(runs, tmp_path, ["poisson", "--resolution", "32", "--min-accumulation", "0.0"])
    assert_meshes_close(eu.read_ply_mesh(got / "poisson_mesh.ply"), jeu.read_ply_mesh(want / "poisson_mesh.ply"))


def test_density_grid_and_marching_cubes_match_jax(runs, tmp_path, capsys):
    """The density grid of each model, then the command: the default level
    (-15) misses this field, so both fall back to the median level."""
    jax_model, params, model = runs[2:]
    box = ((-1.0,) * 3, (1.0,) * 3)
    want, _, _ = jmc.evaluate_sdf_grid(
        lambda p: -np.asarray(jax_model.density_fn(params, jnp.asarray(p))).reshape(-1), 24, *box)
    got, _, _ = mc.evaluate_sdf_grid(exporter.field_callable(model)[0], 24, *box)
    np.testing.assert_allclose(got, want, rtol=GRID_TOL, atol=0)
    assert got.std() > 1e-2 * np.abs(got).mean()
    want_dir, got_dir = run_both(runs, tmp_path, ["marching-cubes", "--resolution", "24"])
    assert capsys.readouterr().out.count("retrying at the median field value") == 2
    name = "sdf_marching_cubes_mesh.ply"
    assert_meshes_close(eu.read_ply_mesh(got_dir / name), jeu.read_ply_mesh(want_dir / name))


def test_texture_export_matches_jax(runs, tmp_path):
    want, got = run_both(runs, tmp_path, ["texture", "--resolution", "8", "--px-per-uv-triangle", "4"])
    assert_textures_close(got, want)


def test_ns_texture_matches_jax(runs, tmp_path):
    """ns-texture of one mesh file (a decimated sphere): the same OBJ
    bytes (same vertices, same atlas) and the texture within a level."""
    verts, faces, normals = mc.generate_mesh_with_multires_marching_cubes(
        lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=16)
    mesh = tmp_path / "sphere.ply"
    eu.write_ply_mesh(mesh, verts, faces, normals=normals)
    want, got = run_both(runs, tmp_path, ["--input-mesh-filename", str(mesh), "--target-num-faces", "300"],
                         jax_main=jax_texture.main, port_main=texture.main)
    assert (got / "mesh.obj").read_bytes() == (want / "mesh.obj").read_bytes()
    assert_textures_close(got, want)
    assert sum(line.startswith("f ") for line in (got / "mesh.obj").read_text().splitlines()) == 300


def test_usage_errors_return_2_in_both(runs, tmp_path, capsys):
    """gaussian-splat (no splatfacto model), an unknown mode and an unknown
    flag return 2 in both packages; both print the same usage."""
    jax_config, port_config = runs[:2]
    for argv in (["gaussian-splat"], ["no-such-mode"], ["pointcloud", "--no-such-flag", "1"]):
        for main, config, kw in ((jax_export.main, jax_config, {}), (exporter.main, port_config, {"device": "cpu"})):
            assert main([*argv, "--load-config", str(config), "--output-dir", str(tmp_path)], **kw) == 2, argv
    for mains in ((jax_export.main, exporter.main), (jax_texture.main, texture.main)):
        usage = []
        for main in mains:
            capsys.readouterr()
            assert main(["--help"]) == 0
            usage.append(capsys.readouterr().out)
        assert usage[0] == usage[1] and usage[0].startswith("usage: ns-")
    for main in (jax_export.main, exporter.main):
        assert main(["pointcloud"]) == 2
    for main in (jax_texture.main, texture.main):
        assert main(["--load-config", str(port_config)]) == 2
        assert main(["--no-such-flag", "1"]) == 2


def test_export_defaults_to_cuda(runs, monkeypatch, tmp_path):
    """Without device= the commands run on the card; with CUDA absent they
    raise instead of running on the CPU."""
    _, port_config = runs[:2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exporter.main(["cameras", "--load-config", str(port_config), "--output-dir", str(tmp_path)])
    verts, faces, _ = mc.generate_mesh_with_multires_marching_cubes(lambda p: np.linalg.norm(p, axis=-1) - 0.5, 8)
    eu.write_ply_mesh(tmp_path / "m.ply", verts, faces)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texture.main(["--load-config", str(port_config), "--input-mesh-filename", str(tmp_path / "m.ply"),
                      "--output-dir", str(tmp_path)])


def test_decimate_equals_jax():
    rng = np.random.default_rng(3)
    verts = rng.standard_normal((40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (90, 3))
    for target in (None, 200, 90, 31):
        for g, w in zip(texture._decimate(verts, faces, target), jax_texture._decimate(verts, faces, target)):
            np.testing.assert_array_equal(g, w)
    assert len(texture._decimate(verts, faces, 31)[1]) == 31
