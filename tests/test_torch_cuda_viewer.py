"""The viewer's render path on the card against the CPU.

These tests need a CUDA device; without one every test skips with a
reason. The module imports no JAX (and no Pillow or websockets), so it
runs on a machine with a card and none of them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_viewer.py

- `make_model_render_fn` of a full-width thermal-nerfacto model (f32
  compute; hash tables scaled so the density is not flat) on the card
  against the same function of the CPU copy: rgb and rgb_thermal within
  1e-4, the colormapped depth within one step of the turbo table; the card
  render launches the hash forward (row 8), the CPU render nothing.
- One websocket round trip with the port's client against a viewer that
  renders on the card: the frame is `to_jpeg` of a direct render of the
  same camera on the card, byte for byte, and decodes to its size.
"""

import asyncio
import copy
import json

import numpy as np
import pytest
import torch

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, resolve_model_class
from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_bytes
from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th
from nerfstudio_thermal_torch.utils.colormaps import apply_float_colormap
from nerfstudio_thermal_torch.utils.precision import pin_precision
from nerfstudio_thermal_torch.viewer import websocket as ws
from nerfstudio_thermal_torch.viewer.server import (
    ViewerServer,
    free_port_pair,
    make_model_render_fn,
    probe_output_names,
    to_jpeg,
)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

TOL = 1e-4
TURBO_STEP = float(np.abs(np.diff(apply_float_colormap(np.linspace(0, 1, 256)[:, None], "turbo"), axis=0)).max())
W, H = 64, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_precision()
    return torch.device("cuda")


def c2w_at(eye):
    eye = np.asarray(eye, np.float32)
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, up, -forward], -1)
    c2w[:3, 3] = eye
    return c2w[:3]


@pytest.fixture
def models(cuda):
    config = get_method_config("thermal-nerfacto").model
    config.compute_dtype = "float32"
    config.eval_num_rays_per_chunk = 1024
    aabb = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    cpu = resolve_model_class(config)(config, aabb, num_train_data=2, metadata={}, device="cpu", seed=0)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "hash_table" in name:
                p.mul_(300.0)
    return cpu, copy.deepcopy(cpu).to(cuda)


def test_render_fn_on_the_card_matches_the_cpu(models):
    cpu, card = models
    c2w = c2w_at([1.6, 0.9, 0.5])
    for output, kwargs in (("rgb", {}), ("rgb_thermal", {"crop": [[-0.6] * 3, [0.6] * 3]}),
                           ("depth", {"colormap": {"name": "turbo"}})):
        want = make_model_render_fn(cpu)(c2w, W, H, output, fov=50.0, **kwargs)
        th.hash_encode_fwd.launches = 0
        got = make_model_render_fn(card)(c2w, W, H, output, fov=50.0, **kwargs)
        assert th.hash_encode_fwd.launches > 0, output
        assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
        tol = TURBO_STEP + 1e-6 if output == "depth" else TOL
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=output)


def test_websocket_round_trip_on_the_card(models):
    _, card = models
    render = make_model_render_fn(card)
    server = ViewerServer(render, probe_output_names(card), port=free_port_pair())
    server.start()
    c2w = c2w_at([1.2, -1.4, 0.6])

    async def drive():
        client = await ws.connect(f"ws://127.0.0.1:{server.port + 1}/")
        hello = json.loads(await asyncio.wait_for(client.recv(), 60))
        await client.send(json.dumps({"type": "camera", "c2w": c2w.tolist(), "width": 256, "aspect": 16 / 9}))
        stats = json.loads(await asyncio.wait_for(client.recv(), 60))
        jpeg = await asyncio.wait_for(client.recv(), 60)
        await client.close()
        return hello, stats, jpeg

    try:
        hello, stats, jpeg = asyncio.run(asyncio.wait_for(drive(), 120))
    finally:
        server.stop()
    assert hello["names"][0] == "rgb" and "rgb_thermal" in hello["names"]
    assert (stats["width"], stats["height"], stats["final"]) == (256, 144, True)
    assert jpeg == to_jpeg(render(c2w, 256, 144, "rgb"))
    assert decode_jpeg_bytes(jpeg).shape == (144, 256, 3)
