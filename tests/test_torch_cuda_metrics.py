"""The eval-image metrics on the card against the CPU, on the same images.

These tests need a CUDA device; without one every test skips with a
reason. The module imports torch only (no JAX), so it runs on a machine
with a card and no JAX installation:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_metrics.py

PSNR, SSIM and LPIPS (the seeded untrained VGG16) agree within 1e-5
relative: the same f32 arithmetic in another order, with TF32 off
(`pin_precision`), so a TF32 convolution or a layout fault in the VGG
would show.
"""

import numpy as np
import pytest
import torch

from nerfstudio_thermal_torch.utils import lpips as lp
from nerfstudio_thermal_torch.utils.math import psnr, ssim
from nerfstudio_thermal_torch.utils.precision import pin_precision

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_precision()
    return torch.device("cuda")


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return torch.tensor(a), torch.tensor(b)


@pytest.mark.parametrize("shape", [(240, 320, 3), (256, 320, 1), (37, 53, 3)])
def test_metrics_on_the_card_match_the_cpu(cuda, shape, monkeypatch):
    monkeypatch.delenv("NS_LPIPS", raising=False)
    a, b = _images(shape, shape[0])
    for name, fn in (("psnr", psnr), ("ssim", ssim)):
        want = float(fn(a, b))
        got = float(fn(a.to(cuda), b.to(cuda)))
        assert got == pytest.approx(want, rel=1e-5), name
    if shape[-1] == 1:
        a, b = a.repeat(1, 1, 3), b.repeat(1, 1, 3)
    want = lp.lpips(a, b)
    got = lp.lpips(a.to(cuda), b.to(cuda))
    assert got == pytest.approx(want, rel=1e-5)
