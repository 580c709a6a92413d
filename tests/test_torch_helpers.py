"""The JAX package's public helpers that the port mirrors with no other
caller on the training path, each held against its JAX function on seeded
numpy inputs (f32, rel 1e-6): PatchPixelSampler, pred_normal_loss,
render_uncertainty, searchsorted_batched, uniform_lin_disp_piecewise_sample,
get_normalized_directions, align_gt_with_pred_rgbt, poses.inverse and
poses.normalize; and register_method, which makes a method reachable
through the port's get_method_config and ns-train's list.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.cameras import rays as jrays
from nerfstudio_thermal_tpu.data.dataparsers.nerfstudio_dataparser import Nerfstudio as JaxNerfstudio
from nerfstudio_thermal_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JaxNSConfig
from nerfstudio_thermal_tpu.data.datasets import InputDataset as JaxDataset
from nerfstudio_thermal_tpu.data.pixel_samplers import PatchPixelSampler as JaxPatchSampler
from nerfstudio_thermal_tpu.data.pixel_samplers import PixelSamplerConfig as JaxSamplerConfig
from nerfstudio_thermal_tpu.fields.base_field import get_normalized_directions as jax_normalized_directions
from nerfstudio_thermal_tpu.model_components.losses import pred_normal_loss as jax_pred_normal_loss
from nerfstudio_thermal_tpu.model_components.ray_samplers import searchsorted_batched as jax_searchsorted
from nerfstudio_thermal_tpu.model_components.ray_samplers import uniform_lin_disp_piecewise_sample as jax_piecewise
from nerfstudio_thermal_tpu.model_components.renderers import render_uncertainty as jax_render_uncertainty
from nerfstudio_thermal_tpu.utils import poses as jposes
from nerfstudio_thermal_tpu.utils.rgbt_utils import align_gt_with_pred_rgbt as jax_align

from nerfstudio_thermal_torch.cameras import rays as trays
from nerfstudio_thermal_torch.configs import method_configs
from nerfstudio_thermal_torch.data.dataparsers.nerfstudio_dataparser import Nerfstudio, NerfstudioDataParserConfig
from nerfstudio_thermal_torch.data.datasets import InputDataset
from nerfstudio_thermal_torch.data.pixel_samplers import PatchPixelSampler, PixelSampler, PixelSamplerConfig
from nerfstudio_thermal_torch.fields.base_field import get_normalized_directions
from nerfstudio_thermal_torch.model_components.losses import pred_normal_loss
from nerfstudio_thermal_torch.model_components.ray_samplers import (
    searchsorted_batched,
    uniform_lin_disp_piecewise_sample,
)
from nerfstudio_thermal_torch.model_components.renderers import render_uncertainty
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils import poses
from nerfstudio_thermal_torch.utils.rgbt_utils import align_gt_with_pred_rgbt
from tests.fixtures import make_synthetic_rgbt_dataset

TOL = 1e-6


def f32(rng, *shape, low=-1.0, high=1.0):
    return rng.uniform(low, high, shape).astype(np.float32)


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_patch_pixel_sampler_matches_jax(tmp_path):
    scene = make_synthetic_rgbt_dataset(tmp_path / "scene", num_pairs=2)
    jds = JaxDataset(JaxNerfstudio(JaxNSConfig(data=scene)).get_dataparser_outputs("train"))
    ds = InputDataset(Nerfstudio(NerfstudioDataParserConfig(data=scene)).get_dataparser_outputs("train"))
    assert issubclass(PatchPixelSampler, PixelSampler)
    got = PatchPixelSampler(PixelSamplerConfig(num_rays_per_batch=32, patch_size=2), ds, seed=3)
    want = JaxPatchSampler(JaxSamplerConfig(num_rays_per_batch=32, patch_size=2), jds, seed=3)
    for step in (0, 1):
        g, w = got.sample(step=step), want.sample(step=step)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_pred_normal_loss_and_render_uncertainty_match_jax():
    rng = np.random.default_rng(0)
    w, n, p = f32(rng, 5, 7, 1, low=0.0), f32(rng, 5, 7, 3), f32(rng, 5, 7, 3)
    close(pred_normal_loss(torch.tensor(w), torch.tensor(n), torch.tensor(p)), jax_pred_normal_loss(w, n, p))
    betas = f32(rng, 5, 7, 1, low=0.0)
    close(render_uncertainty(torch.tensor(betas), torch.tensor(w)), jax_render_uncertainty(betas, w))


@pytest.mark.parametrize("side", ["right", "left"])
def test_searchsorted_batched_matches_jax(side):
    rng = np.random.default_rng(1)
    a = np.sort(f32(rng, 4, 9), axis=-1)
    v = np.concatenate([f32(rng, 4, 6), a[:, 2:5]], axis=-1)  # ties with entries of a
    got = searchsorted_batched(torch.tensor(a), torch.tensor(v), side=side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_searchsorted(jnp.asarray(a), jnp.asarray(v), side)))


def _bundles(rng, r=6):
    o, d = f32(rng, r, 3), f32(rng, r, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    area, idx = f32(rng, r, 1, low=1e-4, high=1e-3), np.zeros((r, 1), np.int32)
    nears, fars = f32(rng, r, 1, low=0.05, high=0.5), f32(rng, r, 1, low=2.0, high=50.0)
    jb = jrays.RayBundle(*(jnp.asarray(x) for x in (o, d, area, idx, nears, fars)))
    tb = trays.RayBundle(*(torch.tensor(x) for x in (o, d, area, idx, nears, fars)))
    return jb, tb


def test_uniform_lin_disp_piecewise_sample_matches_jax():
    jb, tb = _bundles(np.random.default_rng(2))
    want = jax_piecewise(jb, 11, train=False)
    got = uniform_lin_disp_piecewise_sample(tb, 11, train=False)
    assert got.spacing_kind == want.spacing_kind == "piecewise"
    for k in ("starts", "ends", "spacing_starts", "spacing_ends"):
        close(getattr(got, k), getattr(want, k))


def test_normalized_directions_and_rgbt_alignment_match_jax():
    rng = np.random.default_rng(3)
    d = f32(rng, 8, 3)
    close(get_normalized_directions(torch.tensor(d)), jax_normalized_directions(d))
    gt, pred = f32(rng, 8, 4, low=0.0), f32(rng, 8, 4, low=0.0)
    is_thermal = (rng.uniform(size=8) < 0.5).astype(np.float32)
    close(align_gt_with_pred_rgbt(torch.tensor(gt), torch.tensor(pred), torch.tensor(is_thermal)),
          jax_align(gt, pred, is_thermal))


def test_pose_inverse_and_normalize_match_jax():
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(5, 3, 3)))
    pose = np.concatenate([q, rng.normal(size=(5, 3, 1)) * 3.0], axis=-1).astype(np.float32)
    close(poses.inverse(torch.tensor(pose)), jposes.inverse(jnp.asarray(pose)))
    close(poses.normalize(torch.tensor(pose)), jposes.normalize(jnp.asarray(pose)))
    # inverse composes to the identity pose
    eye = poses.multiply(torch.tensor(pose), poses.inverse(torch.tensor(pose)))
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3, 4), eye.shape), atol=1e-5)


def test_register_method_reaches_get_method_config(monkeypatch, capsys):
    monkeypatch.setattr(method_configs, "_PLUGINS", dict(method_configs._PLUGINS))
    base = method_configs.get_method_config("nerfacto")
    config = dataclasses.replace(base, method_name="my-nerfacto", description="a registered method")
    method_configs.register_method(config)
    got = method_configs.get_method_config("my-nerfacto")
    assert got is not config and got == config  # a copy per call, as for a plugin's
    assert method_configs.method_names()["my-nerfacto"] == "a registered method"
    assert ns_train.main(["--help"], device="cpu") == 0
    assert "my-nerfacto" in capsys.readouterr().out
    with pytest.raises(KeyError):
        method_configs.get_method_config("unregistered-method")
