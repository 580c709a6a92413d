"""The port's viewer (viewer/server.py, scripts/viewer.py, the trainer's
viewer hooks) against the JAX package's, on the CPU.

Both packages set up the same tiny thermal-nerfacto run as
tests/test_torch_eval.py (`tiny_hash`, f32, the 32 x 40 / 32 x 36
synthetic scene, half the pairs held out for eval); the port's model gets
the JAX trainer's parameters through `load_jax_params`. Held:
- `probe_output_names`: the same names, in the same order;
- `make_model_render_fn`'s images for one camera: rgb, rgb_thermal under a
  crop box, and depth through the depth colormap; as the ns-render test
  holds frames (tests/test_torch_render_script.py), within one 8-bit level,
  and a colormapped depth within one step of the turbo table;
- `save_camera_path`'s JSON for the same keyframes: equal;
- `_render_split`'s composites of a stub render: equal;
- ns-viewer end to end (`scripts/viewer.serve` on a saved run): the
  outputs greeting, a frame equal to `to_jpeg` of a direct render, and a
  point cloud export;
- the trainer's pause / step / resume under `--vis viewer`: the step count
  stops while paused, one step is granted, a ladder renders while paused
  (the buckets cut to 32 and 64 px wide on the CPU),
  and training ends after resume with finite train_stats losses; ns-train
  with `--vis viewer` trains and stops its viewer.
"""

import asyncio
import json
import threading

import jax
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.viewer import server as jax_server

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import save_config
from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_bytes
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.scripts import viewer as ns_viewer
from nerfstudio_thermal_torch.utils.jax_params import load_jax_params
from nerfstudio_thermal_torch.viewer import server
from nerfstudio_thermal_torch.viewer import websocket as ws
from nerfstudio_thermal_torch.viewer.server import free_port_pair
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_eval import RGB_HW, T_HW, TINY_FLAGS, TURBO_STEP, _method, jax_trainer_setup
from tests.test_torch_viewer_protocol import TIMEOUT

torch.set_num_threads(1)

METHOD = "thermal-nerfacto"
LEVEL = 1  # 8-bit levels
DEPTH_LEVELS = int(np.ceil(TURBO_STEP * 255)) + 1
W, H = 24, 16
CROP = [[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]]
SMALL_BUCKETS = (32, 64)  # the ladder at CPU sizes (the card runs the real one)


def _look_at(eye):
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, up, -forward], -1)
    c2w[:3, 3] = eye
    return c2w[:3]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4, rgb_hw=RGB_HW, t_hw=T_HW)


@pytest.fixture(scope="module")
def pair(scene, tmp_path_factory):
    """(JAX trainer, the port's trainer holding its parameters)."""
    root = tmp_path_factory.mktemp("viewer")
    jax_trainer = jax_trainer_setup(_method(jax_method_config, METHOD, scene), root / "jax")
    method = _method(get_method_config, METHOD, scene)
    trainer = setup_trainer(method, base_dir=root / "port", device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, jax_trainer.host_params()))
    trainer.setup()
    save_config(method, root / "port" / "config.yml")
    trainer.save_checkpoint(0)
    return jax_trainer, trainer


def _u8(img):
    return (np.clip(np.asarray(img, np.float32), 0, 1) * 255).astype(np.uint8)


def test_probe_output_names_match_jax(pair):
    jax_trainer, trainer = pair
    want = jax_server.probe_output_names(jax_trainer.model, jax_trainer.host_params(),
                                         jax_trainer.datamanager.eval_cameras)
    got = server.probe_output_names(trainer.model, trainer.datamanager.eval_cameras)
    assert got == want and got[0] == "rgb" and "rgb_thermal" in got and "depth" in got
    # no cameras: the synthetic 16 x 16 camera
    assert server.probe_output_names(trainer.model) == jax_server.probe_output_names(
        jax_trainer.model, jax_trainer.host_params())


@pytest.mark.parametrize("output, kwargs", [
    ("rgb", {}),
    ("rgb_thermal", {"crop": CROP}),
    ("depth", {"colormap": {"name": "turbo"}}),
])
def test_render_fn_matches_jax(pair, output, kwargs):
    jax_trainer, trainer = pair
    params = jax_trainer.host_params()
    c2w = _look_at(np.array([1.6, 0.8, 0.5], np.float32))
    want = jax_server.make_model_render_fn(jax_trainer.model, lambda: params)(c2w, W, H, output, fov=55.0, **kwargs)
    got = server.make_model_render_fn(trainer.model)(c2w, W, H, output, fov=55.0, **kwargs)
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape == (H, W, 3)
    limit = DEPTH_LEVELS if output == "depth" else LEVEL
    assert np.abs(_u8(got).astype(int) - _u8(want).astype(int)).max() <= limit
    if output != "depth":  # the values behind the 8-bit frames
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_render_fn_runs_under_inference_mode_in_a_worker_thread(pair):
    """Grad mode is thread-local: a worker thread starts with grad enabled,
    and the render turns it off itself."""
    _, trainer = pair
    render = server.make_model_render_fn(trainer.model)
    seen = {}
    inner = trainer.model.render_camera_device

    def spy(*args, **kwargs):
        seen["inference"] = torch.is_inference_mode_enabled()
        return inner(*args, **kwargs)

    trainer.model.render_camera_device = spy
    try:
        t = threading.Thread(target=lambda: seen.setdefault("img", render(_look_at(np.array([2.0, 0, 0.3])), 16, 8,
                                                                           "accumulation")))
        t.start()
        t.join()
    finally:
        del trainer.model.render_camera_device
    assert seen["inference"] and seen["img"].shape == (8, 16, 3)


def test_save_camera_path_matches_jax(tmp_path):
    keyframes = [_look_at(np.array([2.0 * np.cos(a), 2.0 * np.sin(a), 0.3 + 0.1 * a], np.float32)).tolist()
                 for a in (0.0, 0.7, 1.5, 2.2)]
    msg = {"type": "save_path", "keyframes": keyframes, "fovs": [50.0, 55.0, 60.0, 45.0], "durations": [1.0, 2.0, 0.5],
           "fps": 12.0, "seconds": 3.0, "loop": False, "tension": 0.2, "width": 640, "height": 360}
    out = {}
    for name, module in (("jax", jax_server), ("port", server)):
        srv = module.ViewerServer(lambda *a, **k: None, ["rgb"], save_dir=tmp_path / name)
        out[name] = json.loads(srv.save_camera_path(dict(msg)).read_text())
    assert out["port"] == out["jax"]
    assert len(out["port"]["camera_path"]) == 42  # the durations (3.5 s) at 12 fps
    loop = dict(msg, loop=True, durations=[])
    assert (json.loads(server.ViewerServer(None, [], save_dir=tmp_path / "pl").save_camera_path(loop).read_text())
            == json.loads(jax_server.ViewerServer(None, [], save_dir=tmp_path / "jl").save_camera_path(loop)
                          .read_text()))


@pytest.mark.parametrize("split, frac", [(None, 0.5), ("depth", 0.3), ("rgb_thermal", 0.0), ("depth", 1.0)])
def test_render_split_composites_match_jax(split, frac):
    def stub(c2w, width, height, output, crop=None, fov=60.0, **kw):
        rng = np.random.default_rng(len(output))
        return rng.uniform(0, 1, (height, width, 1 if output == "depth" else 3)).astype(np.float32)

    c2w = np.eye(4, dtype=np.float32)[:3]
    got = server.ViewerServer(stub, [])._render_split(c2w, 40, 24, "rgb", None, 60.0, split, frac)
    want = jax_server.ViewerServer(stub, [])._render_split(c2w, 40, 24, "rgb", None, 60.0, split, frac)
    np.testing.assert_array_equal(got, want)


async def _recv_json(client, kind):
    while True:
        msg = await asyncio.wait_for(client.recv(), TIMEOUT)
        if isinstance(msg, str) and json.loads(msg)["type"] == kind:
            return json.loads(msg)


def test_ns_viewer_serves_a_saved_run(pair, monkeypatch):
    _, trainer = pair
    monkeypatch.setattr(server, "RESOLUTION_BUCKETS", SMALL_BUCKETS)
    config = trainer.base_dir / "config.yml"
    viewer = ns_viewer.serve(config, free_port_pair(), device="cpu")
    c2w = _look_at(np.array([1.8, -0.6, 0.4], np.float32))

    async def drive():
        client = await ws.connect(f"ws://127.0.0.1:{viewer.port + 1}/")
        hello = await _recv_json(client, "outputs")
        await client.send(json.dumps({"type": "camera", "c2w": c2w.tolist(), "width": 32, "aspect": 2.0,
                                      "output": "rgb_thermal"}))
        stats = await _recv_json(client, "stats")
        jpeg = await asyncio.wait_for(client.recv(), TIMEOUT)
        await client.send(json.dumps({"type": "export", "kind": "pointcloud"}))
        exported = await _recv_json(client, "exported")
        await client.close()
        return hello, stats, jpeg, exported

    try:
        hello, stats, jpeg, exported = asyncio.run(asyncio.wait_for(drive(), 300))
    finally:
        viewer.stop()
    assert hello["names"] == server.probe_output_names(trainer.model, trainer.datamanager.eval_cameras)
    assert (stats["width"], stats["height"], stats["final"]) == (32, 16, True)
    direct = server.make_model_render_fn(trainer.model)(c2w, 32, 16, "rgb_thermal")
    assert jpeg == server.to_jpeg(direct)
    assert decode_jpeg_bytes(jpeg).shape == (16, 32, 3)
    assert "error" not in exported and exported["path"].endswith(".ply")
    assert ns_viewer.main(["--help"]) == 0 and ns_viewer.main([]) == 2


def test_ns_viewer_defaults_to_cuda(pair, monkeypatch):
    _, trainer = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ns_viewer.main(["--load-config", str(trainer.base_dir / "config.yml"), "--port", str(free_port_pair())])


def test_trainer_pause_step_resume(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(server, "RESOLUTION_BUCKETS", SMALL_BUCKETS)
    method = _method(get_method_config, METHOD, scene)
    method.trainer.max_num_iterations = 12
    method.trainer.steps_per_log = 1
    method.trainer.steps_per_eval_batch = 0
    method.trainer.steps_per_eval_image = 0
    method.trainer.steps_per_eval_all_images = 0
    method.trainer.steps_per_save = 1000
    method.trainer.vis = "viewer"
    method.trainer.viewer_port = free_port_pair()
    trainer = setup_trainer(method, base_dir=tmp_path, device="cpu")
    trainer.setup()
    trainer._pause_event.set()  # paused before the first step, as a client would pause
    runner = threading.Thread(target=trainer.train)
    runner.start()

    async def wait_step(n):
        for _ in range(400):
            if trainer.state.step == n:
                return
            await asyncio.sleep(0.025)
        raise AssertionError(f"step {trainer.state.step}, expected {n}")

    async def drive():
        client = await ws.connect(f"ws://127.0.0.1:{method.trainer.viewer_port + 1}/")
        await _recv_json(client, "outputs")
        await client.send(json.dumps({"type": "train_control", "action": "status"}))
        assert (await _recv_json(client, "train_state"))["paused"] is True
        await asyncio.sleep(0.3)
        assert trainer.state.step == 0  # paused: no step ran
        await client.send(json.dumps({"type": "train_control", "action": "step"}))
        await _recv_json(client, "train_state")
        await wait_step(1)
        await asyncio.sleep(0.3)
        assert trainer.state.step == 1  # one step granted, then paused again
        stats = await _recv_json(client, "train_stats")
        assert stats["step"] == 0 and np.isfinite(stats["loss"])
        c2w = _look_at(np.array([1.5, 1.0, 0.5], np.float32))
        await client.send(json.dumps({"type": "camera", "c2w": c2w.tolist(), "width": 64, "aspect": 16 / 9}))
        frames = []
        while not frames or not frames[-1]["final"]:
            frames.append(await _recv_json(client, "stats"))
            jpeg = await asyncio.wait_for(client.recv(), TIMEOUT)
            assert decode_jpeg_bytes(jpeg).shape == (frames[-1]["height"], frames[-1]["width"], 3)
        assert [f["width"] for f in frames] == list(SMALL_BUCKETS) and trainer.state.step == 1
        await client.send(json.dumps({"type": "train_control", "action": "resume"}))
        assert (await _recv_json(client, "train_state"))["paused"] is False
        losses = []
        while len(losses) < 5:
            losses.append((await _recv_json(client, "train_stats"))["loss"])
        await client.close()
        return losses

    try:
        losses = asyncio.run(asyncio.wait_for(drive(), 300))
        runner.join(300)
        assert not runner.is_alive()
    finally:
        trainer._pause_event.clear()
        trainer._step_once.set()
        runner.join(60)
        trainer.stop_viewer()
    assert trainer.state.step == 12 and all(np.isfinite(losses))
    records = [json.loads(line) for line in (tmp_path / "events.jsonl").read_text().splitlines()]
    train_losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(train_losses) == 12 and np.all(np.isfinite(train_losses))


def test_ns_train_with_the_viewer(scene, tmp_path):
    port = free_port_pair()
    args = ["thermal-nerfacto-tpu", "--data", str(scene), "--max-num-iterations", "3", "--output-dir", str(tmp_path),
            "--vis", "viewer", "--viewer-port", str(port), *TINY_FLAGS]
    assert ns_train.main(args, device="cpu") == 0
    # the viewer stopped with training: its ports are free again
    free = server.ViewerServer(lambda *a, **k: None, ["rgb"], port=port)
    free.start()
    free.stop()
