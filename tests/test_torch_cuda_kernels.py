"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; without them every test skips
with a reason. The module imports torch only (no JAX), so it runs on a
machine with a card and no JAX installation:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances as in tests/test_torch_fused_mlp.py: f32 1e-4 (same exact
products and sums in another order), bf16 2e-2 (one flipped bf16 rounding
moves later layers by about one bf16 step).
"""

import numpy as np
import pytest
import torch

from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(gen, dims, skips, enc_dim, device):
    ws, bs, prev = [], [], enc_dim
    for i, dout in enumerate(dims):
        din = prev + (enc_dim if (i in skips and i != 0) else 0)
        ws.append((torch.randn(din, dout, generator=gen) / din**0.5).to(device))
        bs.append((torch.randn(dout, generator=gen) * 0.1).to(device))
        prev = dout
    return ws, bs


CASES = [
    # (in_dim, layer widths incl. output, skips, freq_encoding, out_act, dtype, n)
    (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None, torch.bfloat16, 65536),
    (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None, torch.float32, 8192),
    (3, (128,) * 3 + (3,), (), (6, 0.0, 5.0, True), "sigmoid", torch.bfloat16, 10000),
    (32, (128,) * 3 + (16,), (2,), None, None, torch.bfloat16, 4099),
    (3, (256,) * 7 + (16,), (), (10, 0.0, 9.0, True), None, torch.bfloat16, 12345),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(cuda, case):
    in_dim, dims, skips, enc, out_act, dtype, n = CASES[case]
    gen = torch.Generator().manual_seed(case)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), cuda)
    x = torch.rand(n, in_dim, generator=gen).to(cuda)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(x, ws, bs, "relu", out_act, skips, enc, dtype)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    want = fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, enc, dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), atol=tol, rtol=tol
    )
