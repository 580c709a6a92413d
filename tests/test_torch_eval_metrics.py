"""The port's eval-image metrics, colormaps and PNG writer against the JAX
package, on the CPU.

Tolerances:
- PSNR: 1e-4 absolute (dB); the same f32 mean in another order.
- SSIM: 1e-5 absolute; the same f32 separable blur (conv2d here,
  jnp.convolve there) summed in another order, differences of ~1e-6.
- LPIPS: 1e-5 relative; the same f32 VGG16 (conv2d against XLA's conv),
  and the seeded weights are equal bitwise.
- Colormaps: 1e-6 absolute; the same table lookups (the port's turbo and
  viridis tables against matplotlib's, through the JAX package).
- PNG: exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.utils import colormaps as jax_colormaps
from nerfstudio_thermal_tpu.utils import lpips as jax_lpips
from nerfstudio_thermal_tpu.utils.math import psnr as jax_psnr
from nerfstudio_thermal_tpu.utils.math import ssim as jax_ssim

from nerfstudio_thermal_torch.data.datasets import decode_png
from nerfstudio_thermal_torch.utils import colormaps, lpips
from nerfstudio_thermal_torch.utils.math import psnr, ssim
from nerfstudio_thermal_torch.utils.writer import Writer

torch.set_num_threads(1)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(16, 20, 3), (13, 17, 1), (11, 11, 3), (24, 31, 2)])
def test_psnr_and_ssim_match_jax(shape):
    a, b = _pair(shape, sum(shape))
    mask = (np.random.default_rng(1).random(shape[:2] + (1,)) > 0.3).astype(np.float32)
    got = float(psnr(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(got, float(jax_psnr(jnp.asarray(a), jnp.asarray(b))), atol=1e-4)
    got = float(psnr(torch.tensor(a), torch.tensor(b), mask=torch.tensor(mask)))
    want = float(jax_psnr(jnp.asarray(a), jnp.asarray(b), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    got = float(ssim(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(got, float(jax_ssim(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    assert float(ssim(torch.tensor(a), torch.tensor(a))) == pytest.approx(1.0, abs=1e-5)


def test_seeded_lpips_weights_equal_jax():
    jax_convs, jax_lins = jax_lpips._seeded_weights()
    convs, lins = lpips.seeded_weights()
    net = lpips.LPIPS(convs, lins)
    assert len(net.convs) == len(jax_convs) == 13
    for (jk, jb), conv in zip(jax_convs, net.convs):
        np.testing.assert_array_equal(conv.weight.detach().numpy(), np.transpose(np.asarray(jk), (3, 2, 0, 1)))
        np.testing.assert_array_equal(conv.bias.detach().numpy(), np.asarray(jb))
    for k, jl in enumerate(jax_lins):
        np.testing.assert_array_equal(getattr(net, f"lin{k}").flatten().numpy(), np.asarray(jl))


@pytest.mark.parametrize("seed", [0, 1])
def test_lpips_matches_jax(seed, monkeypatch):
    monkeypatch.delenv("NS_LPIPS", raising=False)
    a, b = _pair((32, 48, 3), seed)
    want = jax_lpips.lpips(jnp.asarray(a), jnp.asarray(b))
    got = lpips.lpips(torch.tensor(a), torch.tensor(b))
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert lpips.lpips(torch.tensor(a), torch.tensor(a)) == pytest.approx(0.0, abs=1e-7)


def test_lpips_names_and_provenance_follow_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("NS_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))  # no ~/.nerfstudio weights
    for value in (None, "0", "off"):
        if value is None:
            monkeypatch.delenv("NS_LPIPS", raising=False)
        else:
            monkeypatch.setenv("NS_LPIPS", value)
        assert lpips.lpips_available() == jax_lpips.lpips_available() == (value is None)
        assert lpips.lpips_provenance() == jax_lpips.lpips_provenance()
        assert lpips.lpips_metric_name("rgb") == jax_lpips.lpips_metric_name("rgb")
    monkeypatch.delenv("NS_LPIPS")
    assert lpips.lpips_provenance() == "untrained-seeded(vgg16-he, seed 0, uniform heads)"
    assert lpips.lpips_metric_name("thermal") == "lpips_untrained_thermal"
    monkeypatch.setenv("NS_LPIPS", "0")
    assert lpips.lpips(torch.zeros(16, 16, 3), torch.zeros(16, 16, 3)) is None


def test_lpips_reads_weights_from_ns_lpips_weights(monkeypatch, tmp_path):
    """An npz in the JAX package's layout (HWIO kernels) is found through
    NS_LPIPS_WEIGHTS, names the trained metric, and gives the seeded value
    when it holds the seeded weights."""
    convs, lins = lpips.seeded_weights()
    path = tmp_path / "w.npz"
    np.savez(path, **{f"conv{i}_kernel": k for i, (k, _) in enumerate(convs)},
             **{f"conv{i}_bias": b for i, (_, b) in enumerate(convs)},
             **{f"lin{k}_weight": w for k, w in enumerate(lins)})
    a, b = _pair((32, 48, 3), 3)
    monkeypatch.delenv("NS_LPIPS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("NS_LPIPS_WEIGHTS", raising=False)
    untrained = lpips.lpips(torch.tensor(a), torch.tensor(b))
    monkeypatch.setenv("NS_LPIPS_WEIGHTS", str(path))
    assert lpips.lpips_provenance() == f"weights:{path}"
    assert lpips.lpips_metric_name("rgb") == "lpips_rgb"
    assert lpips.lpips(torch.tensor(a), torch.tensor(b)) == untrained


@pytest.mark.parametrize("case", ["depth", "depth_acc", "near_far", "normalize", "invert", "viridis", "gray", "bool",
                                  "rgb"])
def test_colormaps_match_jax(case):
    rng = np.random.default_rng(7)
    depth = (rng.random((9, 11, 1)) * 4 + 1).astype(np.float32)
    acc = rng.random((9, 11, 1)).astype(np.float32)
    image = rng.random((9, 11, 1)).astype(np.float32)
    if case.startswith("depth") or case == "near_far":
        kwargs = {"accumulation": acc} if case == "depth_acc" else {}
        if case == "near_far":
            kwargs = {"near_plane": 1.5, "far_plane": 4.0}
        got = colormaps.apply_depth_colormap(depth, **kwargs)
        want = jax_colormaps.apply_depth_colormap(depth, **kwargs)
    else:
        options = {
            "normalize": dict(normalize=True), "invert": dict(invert=True, colormap_min=0.2, colormap_max=0.9),
            "viridis": dict(colormap="viridis"), "gray": dict(colormap="gray"),
        }.get(case, {})
        img = {"bool": image > 0.5, "rgb": rng.random((9, 11, 3)).astype(np.float32)}.get(case, image * 3 - 1)
        got = colormaps.apply_colormap(img, colormaps.ColormapOptions(**options))
        want = jax_colormaps.apply_colormap(img, jax_colormaps.ColormapOptions(**options))
    assert got.shape == want.shape == (9, 11, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_colormap_tables_are_matplotlibs():
    """The port's tables equal matplotlib's (through the JAX package), magma
    among them; "pca", which neither package carries, raises and lists the
    names the port carries."""
    ramp = np.linspace(0, 1, 256, dtype=np.float32)[:, None]
    for name in ("turbo", "viridis", "default", "magma"):
        np.testing.assert_array_equal(colormaps.apply_float_colormap(ramp, name),
                                      jax_colormaps.apply_float_colormap(ramp, name))
    with pytest.raises(NotImplementedError, match="magma, inferno, plasma, cividis"):
        colormaps.apply_float_colormap(ramp, "pca")


@pytest.mark.parametrize("shape,dtype", [((7, 9), np.float32), ((7, 9, 1), np.float32), ((7, 9, 3), np.float32),
                                         ((5, 6, 3), np.uint8)])
def test_write_image_reads_back(tmp_path, shape, dtype):
    rng = np.random.default_rng(0)
    img = rng.random(shape).astype(np.float32) * 1.2 - 0.1
    if dtype == np.uint8:
        img = (rng.random(shape) * 255).astype(np.uint8)
    writer = Writer(tmp_path)
    writer.write_image("eval/img", img, 12)
    writer.close()
    path = tmp_path / "images" / "eval_img" / "step-000000012.png"
    want = img if dtype == np.uint8 else (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    want = np.broadcast_to(want.reshape(*shape[:2], -1), (*shape[:2], 3))
    np.testing.assert_array_equal(decode_png(path), want)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
