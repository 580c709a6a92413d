"""Ray generation for every camera type, the port against the JAX package,
on the CPU.

Each case builds the same cameras (random rotations and positions,
per-camera intrinsics) in both packages and generates rays for the same
random (camera, pixel) pairs: origins, directions, pixel_area and
directions_norm must agree to 1e-5 absolute and relative (f32 arithmetic
in both, the same formulas up to reassociation), fisheye624 to 1e-4 (two
Newton solves of five iterations each, whose f32 rounding the iterations
carry on). Distortion "on" gives every camera OpenCV coefficients (and
fisheye624 its twelve Fisheye624 parameters); "off" gives none (fisheye624:
twelve zeros, its plain equidistant-tan model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.cameras import camera_utils as jutils
from nerfstudio_thermal_tpu.cameras import cameras as jcams

from nerfstudio_thermal_torch.cameras import camera_utils as tutils
from nerfstudio_thermal_torch.cameras import cameras as tcams

torch.set_num_threads(1)

TOL = 1e-5
TOL_F624 = 1e-4
TYPES = [t.name for t in tcams.CameraType]
N_RAYS = 64


def _cameras(rng, types, distortion: bool):
    n = len(types)
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w[i, :, :3] = q * np.sign(np.linalg.det(q))
        c2w[i, :, 3] = rng.uniform(-1, 1, 3)
    width, height = rng.integers(24, 40, n), rng.integers(20, 32, n)
    fisheye624 = tcams.CameraType.FISHEYE624.value in types
    arrays = dict(
        camera_to_worlds=c2w,
        fx=(width * rng.uniform(0.5, 1.2, n)).astype(np.float32),
        fy=(height * rng.uniform(0.5, 1.2, n)).astype(np.float32),
        cx=(width / 2 + rng.uniform(-2, 2, n)).astype(np.float32),
        cy=(height / 2 + rng.uniform(-2, 2, n)).astype(np.float32),
        width=width.astype(np.int32), height=height.astype(np.int32),
        camera_type=np.asarray(types, np.int32),
    )
    if distortion:
        dist = rng.uniform(-0.02, 0.02, (n, 12 if fisheye624 else 6)).astype(np.float32)
        dist[:, 3] = 0.0  # k4 of the OpenCV model
        dist[:, 10:] *= 0.1  # fisheye624's tangential and thin-prism terms
        arrays["distortion_params"] = dist
    elif fisheye624:
        arrays["distortion_params"] = np.zeros((n, 12), np.float32)
    return arrays


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("distortion", [True, False], ids=["distorted", "undistorted"])
@pytest.mark.parametrize("kind", TYPES + ["MIXED"])
def test_generate_rays_matches_jax(kind, distortion):
    rng = np.random.default_rng(2 * (TYPES + ["MIXED"]).index(kind) + distortion)
    if kind == "MIXED":
        types = [t.value for t in tcams.CameraType]
    else:
        types = [tcams.CameraType[kind].value] * 3
    arrays = _cameras(rng, types, distortion)
    idx = rng.integers(0, len(types), N_RAYS).astype(np.int32)
    coords = np.stack([rng.uniform(0, arrays["height"][idx]), rng.uniform(0, arrays["width"][idx])], -1)
    coords = coords.astype(np.float32)
    jc = jcams.Cameras(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tc = tcams.Cameras(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    assert tc.present_types == set(types)
    want = jax.jit(jc.generate_rays)(jnp.asarray(idx), jnp.asarray(coords))
    got = tc.generate_rays(torch.as_tensor(idx), torch.as_tensor(coords))
    tol = TOL_F624 if tcams.CameraType.FISHEYE624.value in types else TOL
    _close(got.origins, want.origins, tol)
    _close(got.directions, want.directions, tol)
    _close(got.pixel_area, want.pixel_area, tol)
    _close(got.metadata["directions_norm"], want.metadata["directions_norm"], tol)
    np.testing.assert_array_equal(got.camera_indices.numpy(), np.asarray(want.camera_indices))
    assert torch.isfinite(got.directions).all()


def test_fisheye624_unproject_matches_jax():
    """The Newton solves alone, with noticeable radial, tangential and
    thin-prism terms, at pixels within ~45 degrees of the axis (near 60
    degrees, at these coefficients, both packages' five iterations have not
    converged and land on different values)."""
    rng = np.random.default_rng(3)
    pix = rng.uniform(100, 300, (200, 2)).astype(np.float32)
    params = np.concatenate([
        np.array([180.0, 175.0, 200.0, 195.0], np.float32),
        rng.uniform(-0.05, 0.05, 6).astype(np.float32),
        rng.uniform(-0.005, 0.005, 6).astype(np.float32),
    ])[None].repeat(200, 0)
    want = jutils.fisheye624_unproject(jnp.asarray(pix), jnp.asarray(params))
    got = tutils.fisheye624_unproject(torch.as_tensor(pix), torch.as_tensor(params))
    _close(got, want, TOL_F624)


def test_rescale_output_resolution_matches_jax():
    rng = np.random.default_rng(9)
    arrays = _cameras(rng, [1, 2, 3], False)
    want = jcams.Cameras(**{k: jnp.asarray(v) for k, v in arrays.items()}).rescale_output_resolution(0.37)
    got = tcams.Cameras(**{k: torch.as_tensor(v) for k, v in arrays.items()}).rescale_output_resolution(0.37)
    for name in ("fx", "fy", "cx", "cy", "width", "height", "image_width", "image_height"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert got.present_types == {1, 2, 3}
