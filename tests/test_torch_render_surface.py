"""The render surface's building blocks, the port against the JAX package,
on the CPU: the camera paths, the colormap tables, the crop box, and the
frame and bundle renders with their options.

Tolerances:
- camera paths: 1e-6 (the same numpy code on the same float32 inputs);
- colormap tables: exact (both are matplotlib's 256 entries, the port's
  carried as constants);
- crop_near_far: 1e-6 relative (one division and a few min / max);
- renders (a tiny thermal-nerfacto-tpu, f32, as tests/test_torch_render.py
  holds its renders): 1e-4, the same arithmetic up to sum order (with the
  crop box, the expected depths of the rays that hit it);
- the chunked bundle render against one unchunked forward: 1e-4, except
  the expected depths: like the JAX package's, they clip to the sample
  range of the whole batch, which a chunk narrows (compared where the
  clip does not act).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.cameras import camera_paths as jpaths
from nerfstudio_thermal_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.models import base_model as jbase
from nerfstudio_thermal_tpu.models.thermal_nerfacto import ThermalNerfactoModel as JModel
from nerfstudio_thermal_tpu.utils import colormaps as jcolormaps

from nerfstudio_thermal_torch.cameras import camera_paths
from nerfstudio_thermal_torch.cameras.cameras import Cameras
from nerfstudio_thermal_torch.configs.method_configs import get_method_config
from nerfstudio_thermal_torch.models import base_model
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
from nerfstudio_thermal_torch.utils import colormaps
from nerfstudio_thermal_torch.utils.jax_params import load_jax_params
from tests.test_torch_render import AABB, H, W, camera_arrays, tiny

torch.set_num_threads(1)

PATH_TOL = 1e-6
RENDER_TOL = 1e-4
CROP = np.array([[-0.6, -0.5, -0.4], [0.5, 0.6, 0.7]], np.float32)
META = {"is_thermal": [0, 1]}


def _poses(rng, k):
    poses = np.zeros((k, 3, 4), np.float32)
    for i in range(k):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        poses[i, :, :3] = q * np.sign(np.linalg.det(q))
        poses[i, :, 3] = rng.uniform(-2, 2, 3)
    return poses


def _path_cameras(rng, k):
    return dict(
        camera_to_worlds=_poses(rng, k),
        fx=rng.uniform(30, 40, k).astype(np.float32), fy=rng.uniform(30, 40, k).astype(np.float32),
        cx=rng.uniform(15, 17, k).astype(np.float32), cy=rng.uniform(11, 13, k).astype(np.float32),
        width=np.full((k,), 32, np.int32), height=np.full((k,), 24, np.int32),
        camera_type=np.ones((k,), np.int32),
    )


def _assert_cameras_equal(got: Cameras, want):
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "camera_type"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=PATH_TOL, rtol=PATH_TOL, err_msg=name)


@pytest.mark.parametrize("loop", [False, True])
def test_spline_camera_path_matches_jax(loop):
    rng = np.random.default_rng(1 + loop)
    poses = _poses(rng, 4)
    fovs = rng.uniform(40, 70, 4).astype(np.float32)
    durations = rng.uniform(0.5, 2.0, 4 if loop else 3).astype(np.float32)
    want = jpaths.interpolate_camera_path_spline(poses, fovs, durations, fps=12.0, loop=loop, tension=0.2)
    got = camera_paths.interpolate_camera_path_spline(poses, fovs, durations, fps=12.0, loop=loop, tension=0.2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=PATH_TOL, rtol=PATH_TOL)


@pytest.mark.parametrize("indices", [None, [0, 2, 3]], ids=["all", "picked"])
def test_interpolated_camera_path_matches_jax(indices):
    arrays = _path_cameras(np.random.default_rng(3), 4)
    idx = None if indices is None else np.asarray(indices)
    want = jpaths.get_interpolated_camera_path(JCameras(**arrays), steps=9, indices=idx)
    got = camera_paths.get_interpolated_camera_path(
        Cameras(**{k: torch.as_tensor(v) for k, v in arrays.items()}), steps=9, indices=idx
    )
    assert len(got) == len(want)
    _assert_cameras_equal(got, want)


def test_spiral_path_matches_jax():
    c2w = _poses(np.random.default_rng(4), 1)[0]
    want = jpaths.get_spiral_path(c2w, 35.0, 36.0, 16.0, 12.0, 32, 24, steps=30)
    got = camera_paths.get_spiral_path(c2w, 35.0, 36.0, 16.0, 12.0, 32, 24, steps=30)
    assert len(got) == len(want) == 30
    _assert_cameras_equal(got, want)


@pytest.mark.parametrize("name", ["magma", "inferno", "plasma", "cividis"])
def test_colormap_table_equals_jax(name):
    ramp = np.linspace(0, 1, 1000, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(colormaps.apply_float_colormap(ramp, name),
                                  jcolormaps.apply_float_colormap(ramp, name))
    options = dict(colormap=name, normalize=True, invert=True)
    image = np.random.default_rng(0).random((5, 6, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        colormaps.apply_colormap(image, colormaps.ColormapOptions(**options)),
        jcolormaps.apply_colormap(image, jcolormaps.ColormapOptions(**options)),
    )


def test_crop_near_far_matches_jax():
    """Rays from inside and outside the box, with components that are
    exactly zero, tiny positive and tiny negative (the sign must survive
    the near-zero clamp), and rays that miss (far clamped to near)."""
    rng = np.random.default_rng(6)
    origins = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    directions = rng.normal(size=(64, 3)).astype(np.float32)
    directions[:8, 0] = 0.0
    directions[8:16, 1] = -1e-12
    directions[16:24, 2] = 1e-12
    directions[24:32, :2] = -1e-11
    origins[24:32] = [0.0, 0.0, -1.0]  # inside the box's x-y range, on the z axis
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    want = jbase.crop_near_far(jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(CROP))
    got = base_model.crop_near_far(torch.as_tensor(origins), torch.as_tensor(directions), torch.as_tensor(CROP))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PATH_TOL, atol=0)
    nears, fars = (g.numpy() for g in got)
    assert (fars >= nears).all() and (nears >= 0).all()
    assert (fars > nears).any() and (fars == nears).any()  # some rays hit the box, some miss


@pytest.fixture(scope="module")
def models():
    jcfg = tiny(jax_method_config("thermal-nerfacto-tpu").model, "float32")
    jmodel = JModel(jcfg, AABB, num_train_data=2, metadata=META)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    model = ThermalNerfactoModel(tiny(get_method_config("thermal-nerfacto-tpu").model, "float32"), AABB, 2, META,
                                 device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jmodel, params, model


@pytest.mark.parametrize("crop,per_sample", [(True, False), (False, True), (True, True)],
                         ids=["crop_aabb", "include_per_sample", "both"])
def test_render_options_match_jax(models, crop, per_sample):
    """get_outputs_for_camera (render_camera_device) with crop_aabb and with
    include_per_sample: the same outputs, per-sample ones ([h, w, S]) only
    when asked for."""
    jmodel, params, model = models
    cams = camera_arrays()
    kwargs = dict(crop_aabb=CROP if crop else None, include_per_sample=per_sample)
    want = jmodel.get_outputs_for_camera(params, JCameras(**{k: jnp.asarray(v) for k, v in cams.items()}), 0,
                                         **kwargs)
    got = model.get_outputs_for_camera(Cameras(**{k: torch.as_tensor(v) for k, v in cams.items()}), 0, **kwargs)
    assert set(got) == set(want)
    assert ("density" in got) == per_sample and ("density2_thermal" in got) == per_sample
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        if k.startswith("expected_depth") and crop:
            # a ray that misses the box has near == far: its expected depth
            # is a ratio of two rounding residues (~1e-7 / 1e-7), which
            # XLA's fused arithmetic and PyTorch's round differently
            hit = np.asarray(want["accumulation" + k[len("expected_depth"):]]) > 1e-3
            got[k], w = got[k][hit], w[hit]
        np.testing.assert_allclose(got[k], w, atol=RENDER_TOL, rtol=RENDER_TOL, err_msg=k)
    if crop:
        plain = model.get_outputs_for_camera(Cameras(**{k: torch.as_tensor(v) for k, v in cams.items()}), 0)
        assert not np.allclose(plain["accumulation"], got["accumulation"])


def test_render_ray_bundle_chunked_matches_one_forward(models):
    """A flat bundle of 50 rays in chunks of 16 (the last padded) against one
    forward over all 50."""
    _, _, model = models
    cams = Cameras(**{k: torch.as_tensor(v) for k, v in camera_arrays().items()})
    rng = np.random.default_rng(8)
    coords = torch.as_tensor(np.stack([rng.uniform(0, H, 50), rng.uniform(0, W, 50)], -1).astype(np.float32))
    bundle = cams.generate_rays(torch.zeros(50, dtype=torch.long), coords)
    assert model.config.eval_num_rays_per_chunk == 16
    got = model.render_ray_bundle_chunked(bundle)
    with torch.no_grad():
        want = {k: v for k, v in model.forward(bundle, train=False).items() if v.dim() == 2}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.startswith("expected_depth"):
            inside = (w > w.min()) & (w < w.max())
            np.testing.assert_allclose(got[k][inside].numpy(), w[inside].numpy(), atol=RENDER_TOL, rtol=RENDER_TOL)
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=RENDER_TOL, rtol=RENDER_TOL, err_msg=k)
    per_sample = model.render_ray_bundle_chunked(bundle, include_per_sample=True)
    assert per_sample["density"].shape == (50, model.config.num_nerf_samples_per_ray, 1)
