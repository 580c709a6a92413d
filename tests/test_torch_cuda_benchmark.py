"""ns-benchmark on the card against the same run on the CPU.

These tests need a CUDA device; without one every test skips with a
reason. The module imports no JAX, so it runs on a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_benchmark.py

The tiny nerfacto of tests/torch_benchmark_scene.py trains 2 iterations on
one 2-frame 32 x 32 Blender scene through `benchmarking.main` with
`device="cuda"` and with `device="cpu"`. Both return 0 with a finite mean
PSNR, and the card's is the CPU's within PSNR_TOL dB: the rays each step
draws come from each device's own generator, so the two runs train on
other pixels, and two steps move the PSNR of the random-weight model by
less than that. The card run launches the hash forward (row 8) and the
table gradient (rows 7/9), and not the position gradient (row 10: the
camera optimizer is off, so no position asks for a gradient).
"""

import json
import math

import pytest
import torch

from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th
from nerfstudio_thermal_torch.scripts import benchmarking
from tests.torch_benchmark_scene import patched_method_config, write_blender_scene

pytestmark = pytest.mark.cuda

PSNR_TOL = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(tmp_path, device: str) -> dict:
    out = tmp_path / device
    with patched_method_config():
        rc = benchmarking.main(["--method", "nerfacto", "--data-dir", str(tmp_path / "blender"), "--scenes", "lego",
                                "--output-dir", str(out), "--", "--max-num-iterations", "2"], device=device)
    assert rc == 0
    (path,) = out.glob("*/benchmark.json")
    return json.loads(path.read_text())


def test_benchmark_on_the_card_matches_the_cpu(cuda, tmp_path):
    write_blender_scene(tmp_path / "blender" / "lego")
    cpu = _run(tmp_path, "cpu")
    for fn in (th.hash_encode_fwd, th.hash_encode_bwd_table, th.hash_encode_bwd_pos):
        fn.launches = 0
    card = _run(tmp_path, "cuda")
    launches = (th.hash_encode_fwd.launches, th.hash_encode_bwd_table.launches, th.hash_encode_bwd_pos.launches)
    assert launches[0] > 0 and launches[1] > 0 and launches[2] == 0, launches
    assert math.isfinite(card["mean_psnr"]) and math.isfinite(cpu["mean_psnr"])
    assert abs(card["mean_psnr"] - cpu["mean_psnr"]) < PSNR_TOL, (card["mean_psnr"], cpu["mean_psnr"])
    assert set(card["scenes"]["lego"]) == set(cpu["scenes"]["lego"])
